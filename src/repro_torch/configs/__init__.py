from repro_torch.configs.resnet import ARCHS

__all__ = ["ARCHS"]
