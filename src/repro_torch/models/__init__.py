from repro_torch.models.config import (
    LayerSpec,
    MambaConfig,
    ModelConfig,
    Stage,
)
from repro_torch.models.resnet import (
    ResNetConfig,
    apply_resnet,
    init_resnet,
    resnet18,
    resnet34,
    resnet_tiny,
    resnet_tiny34,
)
from repro_torch.models.zoo import ModelBundle, build_bundle

__all__ = [
    "LayerSpec",
    "MambaConfig",
    "ModelBundle",
    "ModelConfig",
    "ResNetConfig",
    "apply_resnet",
    "build_bundle",
    "init_resnet",
    "resnet18",
    "resnet34",
    "resnet_tiny",
    "resnet_tiny34",
    "Stage",
]
