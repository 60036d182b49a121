"""PyTorch/CUDA port of the CacheFlow reproduction (``repro``).

Same module layout as the JAX package, which stays the reference; the port
imports ``torch`` and numpy, never ``jax`` nor anything of ``repro``.  Its
entry points run on CUDA unless the caller asks for ``device="cpu"``, and
its hot kernels are hand-written CUDA C++ for Hopper (``csrc/``).
"""
