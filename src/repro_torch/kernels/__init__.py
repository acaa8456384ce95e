"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version (``ref.py``) and its wrapper (``ops.py``).

A wrapper dispatches on the device of its tensors: a CPU tensor takes the
plain version, a CUDA tensor launches the kernel (built at first use by
``_build``) or raises. There is no fallback from one to the other.
"""
from ._build import launch_counts, reset_launch_counts

__all__ = ["launch_counts", "reset_launch_counts"]
