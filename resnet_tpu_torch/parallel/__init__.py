"""Data parallelism: one process per device, joined by
``torch.distributed`` (``dist.py``), and the replica layout of a global
batch (``mesh.py``)."""
