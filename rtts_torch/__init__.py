"""rtts_torch: the PyTorch + CUDA port of rtts for NVIDIA Hopper.

Mirrors the layout of the JAX package ``rtts`` (each module has its
counterpart under the same path) and imports no JAX.  Two framework-free modules
of ``rtts`` are shared, and reached only through ``rtts_torch.config`` and
``rtts_torch.text``.
"""
