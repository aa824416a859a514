"""The paper's own client architectures (``repro/configs/resnet.py``):
ResNet-18 / ResNet-34 at full width, and the CPU-scale reduced variants."""
from repro_torch.configs import ARCHS
from repro_torch.models.resnet import (
    resnet18,
    resnet34,
    resnet_tiny,
    resnet_tiny34,
)

ARCHS.register("resnet18-imagenet")(
    {"full": lambda: resnet18(1000, num_aux_heads=4),
     "reduced": lambda: resnet_tiny(20, num_aux_heads=4)})

ARCHS.register("resnet34-imagenet")(
    {"full": lambda: resnet34(1000, num_aux_heads=4),
     "reduced": lambda: resnet_tiny34(20, num_aux_heads=4)})
