"""The benchmark of the PyTorch/CUDA port (``resnet_tpu_torch``): cells
named in ``BENCHMARK.json``, each a process of ``python -m gpubench``
(``run.py``). Nothing here imports JAX or the JAX package."""
