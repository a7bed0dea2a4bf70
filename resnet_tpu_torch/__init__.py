"""PyTorch/CUDA port of ``resnet_tpu`` for one NVIDIA H100.

Mirrors the JAX package's layout (``config``, ``ops``, ``models``,
``train``, ``utils``) and imports nothing of it. Its hand-written CUDA
kernels live in ``csrc/`` and are built at first use by ``_build``.
"""
