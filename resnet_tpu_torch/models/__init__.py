from resnet_tpu_torch.models.registry import get_model, model_spec  # noqa: F401
from resnet_tpu_torch.models.resnet import ResNet  # noqa: F401
