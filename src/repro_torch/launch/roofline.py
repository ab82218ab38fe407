"""Model FLOPs and the card's peaks — ``repro/launch/roofline.py``'s
``model_flops_estimate`` (6·N·D a train step, 2·N·D a prefill, 2·N·B a
decode step), beside the NVIDIA H100 80GB HBM3 (SXM) figures that bound
the port's kernels: 989 TFLOP/s dense bf16 on the tensor cores, 67
TFLOP/s FP32 on the CUDA cores and 3.35 TB/s of HBM3. The reference's
HLO cost and collective parsing and its TPU constants are not carried
over.
"""
from __future__ import annotations

PEAK_FLOPS_BF16 = 989e12        # dense bf16 tensor-core FLOP/s
PEAK_FLOPS_FP32 = 67e12         # FP32 CUDA-core FLOP/s
HBM_BW = 3.35e12                # bytes/s


def model_flops_estimate(cfg, shape, n_params_active: float,
                         step_kind: str) -> float:
    """6·N·D for train, 2·N·D for prefill, 2·N·B for one decode token
    (``shape``: ``global_batch`` and ``seq_len``, a ``ShapeConfig``)."""
    if step_kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_params_active * tokens
    if step_kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_params_active * tokens
    return 2.0 * n_params_active * shape.global_batch   # one decode step

