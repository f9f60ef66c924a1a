"""``repro_torch`` — the ASYMP engine on PyTorch and CUDA.

Mirrors the JAX package ``repro`` module for module (``repro_torch.core.engine``
is the counterpart of ``repro.core.engine``, and so on) and never imports
it, nor ``jax``.  Entry points run on the CUDA card unless the caller
passes ``device="cpu"``; on the CPU every kernel wrapper takes its plain
PyTorch version.
"""
