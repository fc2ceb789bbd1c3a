"""OpenAI CLIP ModifiedResNet visual tower (RN50 family) in PyTorch.

Counterpart of hirest_tpu/models/clip_resnet.py. The reference vendors this
tower twice (EVA_clip/model.py:95-163 and
clip4caption/feature_extractor/modules/module_clip.py:155-222); it is the
visual encoder behind the `RN50` / `RN101` / `RN50x4` CLIP variants, which
the vendored `clip.load` surface accepts beside ViT-B/32.

- The input is NHWC, as the JAX tower takes it; the tower computes in
  PyTorch's NCHW.
- BatchNorm is inference-only (a frozen retrieval backbone): `_FrozenBatchNorm`
  keeps the reference's `bn*` weight, bias and running statistics and
  applies them as `F.batch_norm` in eval mode. The JAX converter folds them
  into one affine at load time (:182-191); the two differ in rounding only.
- Anti-aliased bottlenecks and stem: every conv stride 1 but the stem's
  first, `AvgPool2d` (floor windows) after conv2 where the stride is 2, and
  on the downsample branch before its 1x1 conv.
- AttentionPool2d queries only the mean token, as the JAX module's einsum
  does (:101-130): the reference's full self-attention keeps only row 0,
  which attends the same keys. It runs as plain PyTorch: the JAX module
  computes it outside any Pallas kernel.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn


@dataclass(frozen=True)
class ClipResNetConfig:
    """RN50 defaults (stem width 64; attnpool output 1024)."""

    layers: tuple = (3, 4, 6, 3)
    output_dim: int = 1024
    heads: int = 32
    image_size: int = 224
    width: int = 64
    bn_eps: float = 1e-5

    @property
    def embed_dim(self) -> int:  # the last stage's channels
        return self.width * 32


RN50 = ClipResNetConfig()
RN101 = ClipResNetConfig(layers=(3, 4, 23, 3), output_dim=512)
RN50x4 = ClipResNetConfig(layers=(4, 6, 10, 6), output_dim=640, heads=40,
                          image_size=288, width=80)


class _FrozenBatchNorm(nn.Module):
    """Inference BatchNorm2d under the reference's parameter and buffer
    names (`num_batches_tracked`, which eval mode never reads, is left
    out)."""

    def __init__(self, channels: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, False, 0.0, self.eps)


def _conv(cin: int, cout: int, k: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2, bias=False)


class Bottleneck(nn.Module):
    """Anti-aliased bottleneck (EVA_clip/model.py:10-53)."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int, eps: float):
        super().__init__()
        out = planes * self.expansion
        self.stride = stride
        self.conv1 = _conv(inplanes, planes, 1)
        self.bn1 = _FrozenBatchNorm(planes, eps)
        self.conv2 = _conv(planes, planes, 3)
        self.bn2 = _FrozenBatchNorm(planes, eps)
        self.conv3 = _conv(planes, out, 1)
        self.bn3 = _FrozenBatchNorm(out, eps)
        self.downsample = None
        if stride > 1 or inplanes != out:
            # the reference's Sequential("-1": AvgPool2d, "0": conv, "1": bn)
            self.downsample = nn.ModuleDict({"0": _conv(inplanes, out, 1),
                                             "1": _FrozenBatchNorm(out, eps)})

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.relu(self.bn2(self.conv2(h)))
        if self.stride > 1:
            h = F.avg_pool2d(h, self.stride)
        h = self.bn3(self.conv3(h))
        identity = x
        if self.downsample is not None:
            if self.stride > 1:
                identity = F.avg_pool2d(identity, self.stride)
            identity = self.downsample["1"](self.downsample["0"](identity))
        return F.relu(h + identity)


class AttentionPool2d(nn.Module):
    """QKV attention pool: [B, C, H, W] -> [B, output_dim], the mean token
    as the only query (EVA_clip/model.py:56-93, row 0 of its output)."""

    def __init__(self, spacial: int, channels: int, heads: int,
                 output_dim: int):
        super().__init__()
        self.heads = heads
        self.positional_embedding = nn.Parameter(
            torch.zeros(spacial * spacial + 1, channels))
        self.k_proj = nn.Linear(channels, channels)
        self.q_proj = nn.Linear(channels, channels)
        self.v_proj = nn.Linear(channels, channels)
        self.c_proj = nn.Linear(channels, output_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c = x.shape[:2]
        toks = x.flatten(2).transpose(1, 2)  # [B, HW, C], row-major
        toks = torch.cat([toks.mean(1, keepdim=True), toks], 1)
        toks = toks + self.positional_embedding.to(toks.dtype)
        hd = c // self.heads
        q = self.q_proj(toks[:, :1]).reshape(b, 1, self.heads, hd) * hd ** -0.5
        k = self.k_proj(toks).reshape(b, -1, self.heads, hd)
        v = self.v_proj(toks).reshape(b, -1, self.heads, hd)
        att = torch.einsum("bqhd,bkhd->bhqk", q, k)
        att = torch.softmax(att.float(), -1).to(v.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", att, v).reshape(b, c)
        return self.c_proj(out)


class ClipResNetTower(nn.Module):
    """ModifiedResNet image encoder: [B, S, S, 3] (NHWC) -> [B, output_dim]
    f32, in the working dtype of its parameters."""

    def __init__(self, cfg: ClipResNetConfig = RN50):
        super().__init__()
        self.cfg = cfg
        w2, eps = cfg.width // 2, cfg.bn_eps
        # 3-conv stem, the first at stride 2, then avgpool(2) for a maxpool
        self.conv1 = _conv(3, w2, 3, stride=2)
        self.bn1 = _FrozenBatchNorm(w2, eps)
        self.conv2 = _conv(w2, w2, 3)
        self.bn2 = _FrozenBatchNorm(w2, eps)
        self.conv3 = _conv(w2, cfg.width, 3)
        self.bn3 = _FrozenBatchNorm(cfg.width, eps)
        inplanes = cfg.width
        for stage, (mul, blocks) in enumerate(zip((1, 2, 4, 8), cfg.layers)):
            planes = cfg.width * mul
            layer = nn.ModuleList()
            for i in range(blocks):
                stride = 2 if stage > 0 and i == 0 else 1
                layer.append(Bottleneck(inplanes, planes, stride, eps))
                inplanes = planes * Bottleneck.expansion
            setattr(self, f"layer{stage + 1}", layer)
        self.attnpool = AttentionPool2d(cfg.image_size // 32, cfg.embed_dim,
                                        cfg.heads, cfg.output_dim)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        if not images.shape[1] == images.shape[2] == cfg.image_size:
            raise ValueError(f"expected {cfg.image_size}px input, got "
                             f"{tuple(images.shape)}")
        x = images.to(self.conv1.weight.dtype).permute(0, 3, 1, 2)
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        x = F.relu(self.bn3(self.conv3(x)))
        x = F.avg_pool2d(x, 2)
        for stage in range(4):
            for blk in getattr(self, f"layer{stage + 1}"):
                x = blk(x)
        return self.attnpool(x).float()
