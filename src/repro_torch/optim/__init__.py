"""AdamW with f32 moments and the BinaryConnect deploy quantization — the
port of ``repro.optim`` for the paper's training step."""
