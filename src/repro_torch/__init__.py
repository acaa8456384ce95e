"""PyTorch port of the hybrid parallel IBP sampler, for one NVIDIA H100.

The counterpart of ``repro/``: the same layout and names, plain
functions on tensors, explicit devices and ``torch.Generator``s. The
four Pallas kernels of the reference are hand-written CUDA kernels
here (``kernels/csrc``), built at first use. The LM substrate
(``configs``, ``models``, ``optim``, ``launch/serve.py``,
``launch/train.py``) is plain PyTorch, as the reference's is plain jnp.
Nothing in this package imports JAX or the reference package.
"""
