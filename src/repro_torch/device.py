"""Device resolution and numerics settings for the port's entry points.

The counterpart of ``repro/kernels/_backend.py``: the reference picks
Pallas-compiled or interpret mode from the process' platform; here the
caller names the device. ``cuda`` is the default, and without a visible
GPU the entry points raise instead of carrying on on the CPU. The CPU
(``device="cpu"``) is an explicit choice, and it runs every kernel's
plain PyTorch version.
"""
from __future__ import annotations

import torch


def resolve(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on (default ``cuda``).

    Raises when CUDA is asked for and no GPU is visible; never falls
    back to the CPU. Turns TF32 off: its rounding moves flip decisions,
    so the sampler runs full-float32 products everywhere.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and none is "
                "visible to this process; pass device='cpu' (CLI: --device "
                "cpu) to run the plain PyTorch path on the CPU instead"
            )
    elif dev.type != "cpu":
        raise ValueError(f"device={dev} is neither cuda nor cpu")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev
