"""The port's probe tools, run as ``python -m resnet_tpu_torch.tools.<name>``."""
