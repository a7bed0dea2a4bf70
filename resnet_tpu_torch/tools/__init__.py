"""The port's tools (the probes and the launcher), run as ``python -m
resnet_tpu_torch.tools.<name>``."""
