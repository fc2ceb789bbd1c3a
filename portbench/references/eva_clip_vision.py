"""The plain reference: EVA-CLIP-g/14's vision tower in float32 PyTorch.

It follows the published model (EVA, arXiv:2211.07636; the EVA_CLIP_g_14
vision config): CLIP pixel normalisation, a 14 x 14 convolution as the
patch embedding, a class token and learned positions, pre-norm blocks
(LayerNorm, qkv with q and v biases only, softmax attention, out
projection, LayerNorm, fc1, exact-erf GELU, fc2, residuals), the final
LayerNorm and the head on the class token; each frame's feature is then
divided by its L2 norm, as a feature file stores it.

With `qmax` set, each of the four projections of every block runs as the
int8 configuration states it, with codes of `qmax` levels a side (127:
int8, 7: int4): the weight quantized per output channel, the activation
per row (the attention's output per row across all heads), scale
max(max|y| / qmax, 1e-8), codes round-half-even(y / scale) clipped to
+-qmax, the integer product exact (float64 holds every partial sum), then
f32(acc) * row scale * channel scale + bias in f32. fc1's GELU output is
requantized per (row, `requant_chunk` hidden units), and fc2 sums the
chunks' dequantized products. Everything else stays in float32.

This file imports torch and nothing of the program. TF32 is switched off,
so every float32 product is a float32 product.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def _quant(y: torch.Tensor, qmax: int):
    """Codes (as float64, exact) and f32 scales of f32 y along its last
    axis."""
    amax = y.abs().amax(-1, keepdim=True)
    s = (amax / qmax).clamp_min(1e-8)
    return torch.round(y / s).clamp(-qmax, qmax).double(), s


def normalise(frames_u8: torch.Tensor) -> torch.Tensor:
    """uint8 frames [B, H, W, 3] -> CLIP's normalised f32 pixels, as the
    published preprocessing makes them."""
    mean = torch.tensor(CLIP_MEAN, device=frames_u8.device)
    std = torch.tensor(CLIP_STD, device=frames_u8.device)
    return (frames_u8.float().div(255.0) - mean) / std


class Reference:
    """The reference forward on seeded weights (a state dict with the EVA
    reference's key names, without the `visual.` prefix), taken to f32."""

    def __init__(self, sd: dict, cfg: dict, qmax: Optional[int] = None,
                 rows_per_block: int = 8192):
        self.sd = {k: v.float() for k, v in sd.items()}
        self.cfg, self.qmax = cfg, qmax
        self.heads = cfg["width"] // cfg["head_width"]
        self.rows_per_block = rows_per_block
        self.chunk = int(cfg.get("requant_chunk", 0))

    def _linear(self, x: torch.Tensor, key: str, bias) -> torch.Tensor:
        """x [M, K] f32 -> x W^T + bias, in float32 or, with qmax, as the
        int8 configuration's projection."""
        w = self.sd[key]
        if self.qmax is None:
            return x @ w.t() + bias
        w_q, w_s = _quant(w, self.qmax)
        out = torch.empty(x.shape[0], w.shape[0], device=x.device)
        for r in range(0, x.shape[0], self.rows_per_block):
            x_q, x_s = _quant(x[r:r + self.rows_per_block], self.qmax)
            acc = (x_q @ w_q.t()).float()
            out[r:r + self.rows_per_block] = acc * x_s * w_s.t() + bias
        return out

    def _mlp(self, h: torch.Tensor, p: str) -> torch.Tensor:
        """fc2(GELU(fc1(h))) + fc2's bias; under qmax fc1's output is
        requantized per (row, requant_chunk hidden units) and fc2 sums the
        chunks' dequantized products."""
        b2 = self.sd[f"{p}.mlp.fc2.bias"]
        y = F.gelu(self._linear(h, f"{p}.mlp.fc1.weight",
                                self.sd[f"{p}.mlp.fc1.bias"]))
        if self.qmax is None:
            return self._linear(y, f"{p}.mlp.fc2.weight", b2)
        w2_q, w2_s = _quant(self.sd[f"{p}.mlp.fc2.weight"], self.qmax)
        nc = min(self.chunk or y.shape[1], y.shape[1])
        out = torch.empty(h.shape[0], w2_q.shape[0], device=h.device)
        for r in range(0, h.shape[0], self.rows_per_block):
            yr = y[r:r + self.rows_per_block]
            acc = b2.expand(yr.shape[0], -1).clone()
            for j in range(0, yr.shape[1], nc):
                q, s = _quant(yr[:, j:j + nc], self.qmax)
                acc += (q @ w2_q[:, j:j + nc].t()).float() * s * w2_s.t()
            out[r:r + self.rows_per_block] = acc
        return out

    def _attention(self, qkv: torch.Tensor, frames: int) -> torch.Tensor:
        n = qkv.shape[0] // frames
        d = self.cfg["head_width"]
        q, k, v = qkv.view(frames, n, 3, self.heads, d).permute(2, 0, 3, 1, 4)
        att = torch.softmax((q @ k.transpose(-1, -2)) * d ** -0.5, -1) @ v
        return att.transpose(1, 2).reshape(frames * n, self.heads * d)

    def features(self, frames_u8: torch.Tensor) -> torch.Tensor:
        """frames [B, H, W, 3] uint8 on the reference's device -> [B,
        embed_dim] f32 features, each of unit L2 norm."""
        return self.features_of_pixels(normalise(frames_u8))

    @torch.no_grad()
    def features_of_pixels(self, x: torch.Tensor) -> torch.Tensor:
        """Normalised pixels [B, H, W, 3] f32 -> [B, embed_dim] f32
        features, each of unit L2 norm."""
        matmul_tf32 = torch.backends.cuda.matmul.allow_tf32
        cudnn_tf32 = torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            return self._features(x.float().permute(0, 3, 1, 2))
        finally:
            torch.backends.cuda.matmul.allow_tf32 = matmul_tf32
            torch.backends.cudnn.allow_tf32 = cudnn_tf32

    def _features(self, x: torch.Tensor) -> torch.Tensor:
        sd, cfg = self.sd, self.cfg
        eps = cfg["norm_eps"]
        x = F.conv2d(x, sd["patch_embed.proj.weight"],
                     sd["patch_embed.proj.bias"],
                     stride=cfg["patch_size"])
        b, w = x.shape[0], x.shape[1]
        x = x.flatten(2).transpose(1, 2)
        x = torch.cat([sd["cls_token"].expand(b, 1, w), x], 1)
        x = (x + sd["pos_embed"]).reshape(-1, w)
        for i in range(cfg["layers"]):
            p = f"blocks.{i}"
            h = F.layer_norm(x, (w,), sd[f"{p}.norm1.weight"],
                             sd[f"{p}.norm1.bias"], eps)
            qb, vb = sd[f"{p}.attn.q_bias"], sd[f"{p}.attn.v_bias"]
            qkv = self._linear(h, f"{p}.attn.qkv.weight",
                               torch.cat([qb, torch.zeros_like(qb), vb]))
            att = self._attention(qkv, b)
            x = x + self._linear(att, f"{p}.attn.proj.weight",
                                 sd[f"{p}.attn.proj.bias"])
            h = F.layer_norm(x, (w,), sd[f"{p}.norm2.weight"],
                             sd[f"{p}.norm2.bias"], eps)
            x = x + self._mlp(h, p)
        x = F.layer_norm(x.view(b, -1, w)[:, 0], (w,), sd["norm.weight"],
                         sd["norm.bias"], eps)
        f = x @ sd["head.weight"].t() + sd["head.bias"]
        return f / f.norm(dim=-1, keepdim=True)


def feature_gaps(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """The distance between two unit feature vectors, row by row."""
    return (got.double() - want.double()).norm(dim=-1)
