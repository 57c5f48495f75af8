"""Model zoo of the port; importing it registers the ported models."""

from bayestpu_torch.nn.zoo import lenet, resnet, vgg  # noqa: F401
from bayestpu_torch.nn.zoo.registry import available_models, get_model

__all__ = ["available_models", "get_model"]
