"""Plain PyTorch version of the gaussian_sse kernel: the masked residual
sum of squares ||X - (Z*active) A||^2 (port of
``repro/kernels/gaussian_sse/ref.py``). bfloat16 inputs are computed in
float32; float64 inputs stay float64."""
from __future__ import annotations

import torch

Tensor = torch.Tensor


def gaussian_sse_ref(X: Tensor, Z: Tensor, A: Tensor, active: Tensor) -> Tensor:
    f = torch.promote_types(X.dtype, torch.float32)
    Zf = Z.to(f) * active.to(f)[None, :]
    R = X.to(f) - Zf @ A.to(f)
    return torch.sum(R * R)
