"""Argument checks shared by the kernel wrappers."""
from __future__ import annotations

import torch


def on_cpu(name: str, *tensors: torch.Tensor) -> bool:
    """True for CPU tensors (plain version); False for CUDA tensors on
    one device (kernel). Raises for anything else."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"{name}: tensors on several devices {devs}")
    dev = devs.pop()
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    return False


def expect(name: str, dtypes: tuple[torch.dtype, ...],
           **tensors: tuple[torch.Tensor, tuple[int, ...]]) -> None:
    """Check dtype, shape and contiguity of each ``arg=(tensor, shape)``."""
    for arg, (t, shape) in tensors.items():
        if t.dtype not in dtypes:
            raise TypeError(f"{name}: {arg} has dtype {t.dtype}, expected "
                            f"one of {dtypes}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: {arg} has shape {tuple(t.shape)}, "
                             f"expected {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} is not contiguous")


def stream(t: torch.Tensor) -> int:
    """The current stream of ``t``'s device, as the C launchers take it."""
    return torch.cuda.current_stream(t.device).cuda_stream
