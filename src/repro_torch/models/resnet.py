"""ResNet family — the paper's client models (ResNet-18/34), in PyTorch.

Port of ``repro/models/resnet.py``: GroupNorm instead of BatchNorm, the
same parameter tree, and the same MHD interface

    apply_resnet(params, cfg, images) -> {"embedding": (B, E),
                                          "logits": (B, C),
                                          "aux_logits": (m, B, C) | None}

Parameters are a flat dict keyed by the reference's "/"-joined paths
(`repro_torch.checkpoint.io`), with conv kernels in OIHW. Images are NHWC
at this public function, as in JAX; the network runs NCHW inside.

Three places where PyTorch's defaults differ from JAX's and the port
reproduces JAX:
  * ``padding="SAME"`` pads ``total // 2`` before and the rest after, so a
    stride-2 3×3 conv on an even size pads 0 before and 1 after —
    ``F.conv2d(padding=1)`` would pad 1 on both sides;
  * the ``stem_stride=2`` max-pool is SAME with −inf padding;
  * a stride-2 block without a projection subsamples with ``[::2, ::2]``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import resolve_device

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    name: str = "resnet18"
    stage_sizes: Tuple[int, ...] = (2, 2, 2, 2)  # resnet18; resnet34=(3,4,6,3)
    width: int = 64
    num_classes: int = 1000
    num_aux_heads: int = 0
    groups: int = 8  # GroupNorm groups
    stem_stride: int = 1  # 1 for small images, 2 (+pool) for 224px
    source: str = "He et al., CVPR 2016 [14 in paper]"

    @property
    def embed_dim(self) -> int:
        return self.width * 8


def resnet18(num_classes: int, num_aux_heads: int = 0, width: int = 64):
    return ResNetConfig(name="resnet18", stage_sizes=(2, 2, 2, 2), width=width,
                        num_classes=num_classes, num_aux_heads=num_aux_heads)


def resnet34(num_classes: int, num_aux_heads: int = 0, width: int = 64):
    return ResNetConfig(name="resnet34", stage_sizes=(3, 4, 6, 3), width=width,
                        num_classes=num_classes, num_aux_heads=num_aux_heads)


def resnet_tiny(num_classes: int, num_aux_heads: int = 0, width: int = 8,
                stages: Tuple[int, ...] = (1, 1, 1, 1),
                name: str = "resnet_tiny"):
    """CPU-scale stand-in preserving the ResNet block structure."""
    return ResNetConfig(name=name, stage_sizes=stages, width=width,
                        num_classes=num_classes, num_aux_heads=num_aux_heads,
                        groups=4)


def resnet_tiny34(num_classes: int, num_aux_heads: int = 0, width: int = 8):
    """Deeper tiny variant: plays ResNet-34's role against resnet_tiny."""
    return resnet_tiny(num_classes, num_aux_heads, width,
                       stages=(2, 2, 2, 2), name="resnet_tiny34")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

# the leaves that are convolution kernels: OIHW here, HWIO in the JAX
# package (`checkpoint.io` converts exactly these)
CONV_KERNELS = ("stem", "conv1", "conv2", "proj")


def is_conv_kernel(key: str, ndim: int) -> bool:
    """Whether the leaf at path ``key`` of a ResNet tree, or of an
    optimizer state over one, is a 4-D convolution kernel."""
    return ndim == 4 and key.rsplit("/", 1)[-1] in CONV_KERNELS


def _normal(gen: torch.Generator, shape, std: float) -> Tensor:
    return torch.randn(shape, generator=gen, dtype=torch.float32) * std


def _conv_init(gen, kh, kw, cin, cout) -> Tensor:
    return _normal(gen, (cout, cin, kh, kw), math.sqrt(2.0 / (kh * kw * cin)))


def init_resnet(gen: torch.Generator, cfg: ResNetConfig,
                in_channels: int = 3, dtype: torch.dtype = torch.float32,
                device: Optional[torch.device] = None) -> Dict[str, Tensor]:
    """Fresh parameters drawn from ``gen`` (a CPU generator, so the draw is
    the same whatever the device), as the flat path-keyed dict on
    ``device`` (``None`` → ``cuda``, as every entry point of the port)."""
    device = resolve_device(device)
    p: Dict[str, Tensor] = {
        "stem": _conv_init(gen, 3, 3, in_channels, cfg.width)}

    def gn(prefix, c):
        p[f"{prefix}/scale"] = torch.ones(c)
        p[f"{prefix}/bias"] = torch.zeros(c)

    gn("stem_gn", cfg.width)
    cin = cfg.width
    for si, n_blocks in enumerate(cfg.stage_sizes):
        cout = cfg.width * (2 ** si)
        for bi in range(n_blocks):
            b = f"s{si}b{bi}"
            p[f"{b}/conv1"] = _conv_init(gen, 3, 3, cin, cout)
            gn(f"{b}/gn1", cout)
            p[f"{b}/conv2"] = _conv_init(gen, 3, 3, cout, cout)
            gn(f"{b}/gn2", cout)
            if cin != cout:
                p[f"{b}/proj"] = _conv_init(gen, 1, 1, cin, cout)
                gn(f"{b}/gn_proj", cout)
            cin = cout
    emb = cfg.embed_dim
    p["head"] = _normal(gen, (emb, cfg.num_classes), 1 / math.sqrt(emb))
    p["head_b"] = torch.zeros(cfg.num_classes)
    if cfg.num_aux_heads:
        p["aux_heads"] = _normal(
            gen, (cfg.num_aux_heads, emb, cfg.num_classes),
            1 / math.sqrt(emb))
        p["aux_heads_b"] = torch.zeros(cfg.num_aux_heads, cfg.num_classes)
    return {k: p[k].to(device=device, dtype=dtype) for k in sorted(p)}


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA's SAME padding along one axis: (before, after)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv(x: Tensor, w: Tensor, stride: int = 1) -> Tensor:
    kh, kw = w.shape[2], w.shape[3]
    (t, b), (l, r) = (_same_pads(x.shape[2], kh, stride),
                      _same_pads(x.shape[3], kw, stride))
    if t == b and l == r:
        return F.conv2d(x, w, stride=stride, padding=(t, l))
    return F.conv2d(F.pad(x, (l, r, t, b)), w, stride=stride)


def _gn(p: Dict[str, Tensor], prefix: str, x: Tensor, groups: int,
        eps: float = 1e-5) -> Tensor:
    """GroupNorm as the reference's ``_gn``: the group count drops until it
    divides C, biased variance, f32 statistics."""
    C = x.shape[1]
    g = min(groups, C)
    while C % g:
        g -= 1
    y = F.group_norm(x.float(), g, p[f"{prefix}/scale"].float(),
                     p[f"{prefix}/bias"].float(), eps)
    return y.to(x.dtype)


def _block(p, b: str, x: Tensor, groups: int, stride: int) -> Tensor:
    y = _conv(x, p[f"{b}/conv1"], stride)
    y = F.relu(_gn(p, f"{b}/gn1", y, groups))
    y = _conv(y, p[f"{b}/conv2"], 1)
    y = _gn(p, f"{b}/gn2", y, groups)
    if f"{b}/proj" in p:
        x = _gn(p, f"{b}/gn_proj", _conv(x, p[f"{b}/proj"], stride), groups)
    elif stride != 1:
        x = x[:, :, ::stride, ::stride]
    return F.relu(x + y)


def apply_resnet(params: Dict[str, Tensor], cfg: ResNetConfig,
                 images: Tensor) -> Dict[str, Any]:
    """``images`` (B, H, W, C) NHWC, as the reference takes them."""
    x = images.permute(0, 3, 1, 2)
    x = _conv(x, params["stem"], cfg.stem_stride)
    x = F.relu(_gn(params, "stem_gn", x, cfg.groups))
    if cfg.stem_stride == 2:
        (t, b), (l, r) = _same_pads(x.shape[2], 3, 2), _same_pads(
            x.shape[3], 3, 2)
        x = F.max_pool2d(F.pad(x, (l, r, t, b), value=-math.inf), 3, 2)
    for si, n_blocks in enumerate(cfg.stage_sizes):
        for bi in range(n_blocks):
            stride = 2 if (si > 0 and bi == 0) else 1
            x = _block(params, f"s{si}b{bi}", x, cfg.groups, stride)
    embedding = x.mean(dim=(2, 3))  # (B, E) — ξ_i(x) for Eq. (2)
    logits = embedding @ params["head"] + params["head_b"]
    aux_logits = None
    if cfg.num_aux_heads:
        aux_logits = (torch.einsum("be,mec->mbc", embedding,
                                   params["aux_heads"])
                      + params["aux_heads_b"][:, None, :])
    return {"embedding": embedding, "logits": logits,
            "aux_logits": aux_logits}
