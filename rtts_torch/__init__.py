"""rtts_torch: the PyTorch + CUDA port of rtts for NVIDIA Hopper.

Mirrors the layout of the JAX package ``rtts`` (each module has its
counterpart under the same path) and imports neither JAX nor anything of
``rtts``: what it needs of the JAX package's framework-free modules
(configuration, text frontend, data pipeline, metric logger) it keeps as its
own copies.
"""
