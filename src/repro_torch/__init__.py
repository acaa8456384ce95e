"""PyTorch port of the hybrid parallel IBP sampler, for one NVIDIA H100.

The counterpart of ``repro/``: the same layout and names, plain
functions on tensors, explicit devices and ``torch.Generator``s. The
four Pallas kernels of the reference are hand-written CUDA kernels
here (``kernels/csrc``), built at first use. The LM substrate's
attention families (``configs``, ``models``, ``launch/serve.py``) are
plain PyTorch ``nn.Module``s, as the reference's are plain jnp. Nothing
in this package imports JAX or the reference package.
"""
