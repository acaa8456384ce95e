"""Plain PyTorch version of the feature_stats kernel: the master sync's
sufficient statistics (port of ``repro/kernels/feature_stats/ref.py``).
Float64 inputs stay float64."""
from __future__ import annotations

import torch

Tensor = torch.Tensor


def feature_stats_ref(X: Tensor, Z: Tensor) -> tuple[Tensor, Tensor, Tensor]:
    """Returns (ZtZ (K,K), ZtX (K,D), m (K,))."""
    f = torch.promote_types(X.dtype, torch.float32)
    Zf = Z.to(f)
    return Zf.T @ Zf, Zf.T @ X.to(f), torch.sum(Zf, dim=0)
