"""TT algebra, rank adaptation, QAT edges and the TT linear layer — the
port of ``repro.core`` for the paper's training step."""
