"""The scanned forward of the EVA vision tower and its kernel flags.

Counterpart of hirest_tpu/models/eva_scan.py. The JAX module stacks the
blocks under `lax.scan` to keep XLA's compile to one block; PyTorch runs
eagerly, so here the "scanned" forward is `EvaVisionTower` itself, staged
once on the device in the working dtype (`stage_scanned_params`). The
function names are kept so each piece can be found beside its counterpart.

`build_scanned_vision_apply` takes the JAX function's flags that choose
what is computed, with its defaults: `dtype`, `fast_gelu`, `uint8_input`,
`int8`, `fused_quant`, `fused_mlp`, `attn_v2`, `attn_v3` and `fused_ln`.
Each block runs the JAX block's dispatch (eva_scan.py:296-430):

- bf16: the attention v1 (K8) by default, v2 (K9) or v3 (K1); `fused_ln`
  runs the two block LayerNorms through `ln_bf16` (K10). The biases, the
  GELU and the residuals follow the products in E1 and E2
  (ops/epilogue.py), the work XLA fused into the dots.
- `int8` alone ("int8 dyn"): LayerNorm, then `dyn_quant_rows` (K5
  without an activation on the card) and int8 products at every
  projection, the attention's bf16 output quantized the same way, fc1's
  GELU through E1.
- Every int8 product is one G1 launch (ops/quant.py::int8_mm,
  csrc/int8_gemm.cu): the int8 x int8 -> int32 product and, in its
  epilogue, the dequantization, the bias and, after the out and fc2
  products, the residual sum.
- `int8` + `fused_quant`: `ln_quant` (K2), the attention's int8 epilogue
  (K3, K9 or K8), the int8 fc1, `act_quant` (K5) and the int8 fc2; with
  `fused_mlp` the MLP is one kernel (K4). int8 + fused_quant + attn_v3 +
  fused_mlp is the production int8 configuration, which
  `make_eva_encoder(int8=True)` and the model factory build.

v1 changes the numbers: K8 adds the q/v biases in the working dtype and
normalises p in f32 before rounding it, where v2 and v3 fold the biases
into the qkv projection and round the unnormalised exp2 probabilities.
v2 changes none against v3: its TPU kernel computes v3's function head
by head. As in the JAX forward, v2 and v3 need head rows that are
multiples of 128 wide; other widths take the v1 path on split heads (K6).

Not carried, as they change no number: `flat2d`, `pad_tokens`,
`xla_fences`, `attn_hg`, `attn_rows` and `remat` (rows are independent,
and pad keys are masked to exactly zero weight), so the trunk runs its 257
tokens unpadded. `use_pallas=False` is not carried either: it would put a
plain version on a main path (a CPU tensor takes the plain versions, a
CUDA tensor the kernels). Nor is `fused_attention_flat`, which only
reshapes the flat trunk for the attention kernels.
"""

from __future__ import annotations

from typing import Callable, Mapping, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from hirest_tpu_torch.config import EvaVisionConfig
from hirest_tpu_torch.models.convert import (eva_vision_state_dict,
                                             load_into, patch_conv,
                                             patch_kernel)
from hirest_tpu_torch.models.eva_clip import (CLIP_MEAN, CLIP_STD, Block,
                                              BlockOptions, EvaVisionTower,
                                              scanned_attention)
from hirest_tpu_torch.ops.epilogue import bias_act
from hirest_tpu_torch.ops.quant import (act_quant, dyn_quant_rows,
                                        fused_mlp_int8, int8_mm, ln_quant,
                                        quantize_weight)
from hirest_tpu_torch.utils.device import resolve_device
from hirest_tpu_torch.utils.profiling import span


def fold_uint8_frontend(patch_w: torch.Tensor, patch_b: torch.Tensor):
    """Fold CLIP pixel normalization ((x/255 - mean) / std, a per-channel
    affine) into the patch-embed projection, so the forward consumes raw
    uint8 frames: x_norm @ W + b == u8 @ (W * a[:, None]) + (bvec @ W + b)
    with a_c = 1/(255*std_c), bvec_c = -mean_c/std_c. Exact in f32.
    patch_w is the matmul kernel [p*p*3, width] (channel-minor rows)."""
    w = torch.as_tensor(patch_w, dtype=torch.float32)
    b = torch.as_tensor(patch_b, dtype=torch.float32)
    reps = w.shape[0] // 3
    a = torch.from_numpy(np.tile(1.0 / (255.0 * CLIP_STD), reps)).to(w.device)
    bvec = torch.from_numpy(np.tile(-CLIP_MEAN / CLIP_STD, reps)).to(w.device)
    return w * a[:, None], b + bvec @ w


def _ln(x: torch.Tensor, weight, bias, eps: float) -> torch.Tensor:
    """eva_scan._ln: LayerNorm of x in f32, cast back to x's dtype."""
    return F.layer_norm(x.float(), x.shape[-1:], weight, bias,
                        eps).to(x.dtype)


class Int8Block(nn.Module):
    """The int8 block of the JAX forward (eva_scan.block with int8), made
    from a float `Block`; `forward` runs the configuration its
    `BlockOptions` name (fused_quant, fused_mlp, attention version).

    The four projections become per-output-channel int8 codes and f32
    scales, quantized from the block's float weights as they are (callers
    pass weights not yet cast to the working dtype). Every bias and norm
    parameter is rounded to `dtype` and kept as f32, which is what the JAX
    forward feeds its kernels. All of it lives in buffers, codes int8 and
    the rest f32; `forward` takes and returns x [B, S, C] in `dtype`."""

    def __init__(self, blk: Block, dtype: torch.dtype):
        super().__init__()
        attn, mlp = blk.attn, blk.mlp
        self.heads, self.scale = attn.heads, attn.scale
        self.eps = blk.norm1.eps

        def vec(t):
            return t.detach().to(dtype).float()

        bias3 = torch.cat([attn.q_bias, torch.zeros_like(attn.q_bias),
                           attn.v_bias])
        for name, t in (("norm1_w", blk.norm1.weight),
                        ("norm1_b", blk.norm1.bias), ("qkv_b", bias3),
                        ("out_b", attn.proj.bias),
                        ("norm2_w", blk.norm2.weight),
                        ("norm2_b", blk.norm2.bias),
                        ("fc1_b", mlp.fc1.bias), ("fc2_b", mlp.fc2.bias)):
            self.register_buffer(name, vec(t))
        for name, lin in (("qkv", attn.qkv), ("out", attn.proj),
                          ("fc1", mlp.fc1), ("fc2", mlp.fc2)):
            q, s = quantize_weight(lin.weight.detach())
            self.register_buffer(f"{name}_wq", q)
            self.register_buffer(f"{name}_ws", s)

    def forward(self, x: torch.Tensor, opts: BlockOptions) -> torch.Tensor:
        b, s, c = x.shape
        dt = x.dtype
        x = x.reshape(b * s, c)
        fq = opts.fused_quant
        gact = "gelu_poly" if opts.fast_gelu else "gelu"

        def norm_codes(x, w, bias):
            # LayerNorm -> row codes: one kernel (K2), or "int8 dyn"'s
            # LayerNorm in the working dtype and dyn_quant_rows
            if fq:
                return ln_quant(x, w, bias, self.eps)
            return dyn_quant_rows(_ln(x, w, bias, self.eps))

        hd = self.qkv_b.shape[0] // 3
        # v2 and v3 fold the q/v biases into the projection (eva_scan._bias3)
        qkv_b = self.qkv_b if opts.attn in ("v2", "v3") else None
        qkv = int8_mm(*norm_codes(x, self.norm1_w, self.norm1_b),
                      self.qkv_wq, self.qkv_ws, qkv_b, dt)
        att = scanned_attention(qkv.view(b, s, -1), self.qkv_b[:hd],
                                self.qkv_b[2 * hd:], self.scale, self.heads,
                                opts.attn, quant_out=fq)
        a_q, a_s = att if fq else dyn_quant_rows(att)
        x = int8_mm(a_q.view(b * s, -1), a_s.view(b * s, 1), self.out_wq,
                    self.out_ws, self.out_b, dt, residual=x)
        h_q, h_s = norm_codes(x, self.norm2_w, self.norm2_b)
        if opts.fused_mlp:
            x = fused_mlp_int8(h_q, h_s, self.fc1_wq, self.fc1_ws, self.fc1_b,
                               self.fc2_wq, self.fc2_ws, self.fc2_b, x,
                               act=gact)
            return x.view(b, s, c)
        h = int8_mm(h_q, h_s, self.fc1_wq, self.fc1_ws, self.fc1_b, dt)
        if fq:
            h_q, h_s = act_quant(h, act=gact)
        else:  # the GELU through E1, without a bias (int8_mm added it)
            h_q, h_s = dyn_quant_rows(bias_act(h, act=gact))
        x = int8_mm(h_q, h_s, self.fc2_wq, self.fc2_ws, self.fc2_b, dt,
                    residual=x)
        return x.view(b, s, c)


def _meta(int8: bool, dtype: torch.dtype, uint8_input: bool,
          device: torch.device) -> dict:
    return {"int8": int8, "dtype": str(dtype), "uint8_input": uint8_input,
            "device": str(device)}


def stage_scanned_params(params: Union[Mapping, nn.Module],
                         cfg: EvaVisionConfig = EvaVisionConfig(), *,
                         int8: bool = False,
                         dtype: torch.dtype = torch.bfloat16,
                         uint8_input: bool = False, device=None):
    """Stage the tower on `device` once -> (tower, meta). The same staged
    pair serves every kernel configuration of its precision (the attention
    versions, fused_quant, fused_mlp and fused_ln differ only in what runs,
    not in the weights), so one bf16 and one int8 tower serve them all.

    params: an EVA vision state dict (reference names, `visual.`-prefixed
    or bare; tensors or numpy arrays) or an `EvaVisionTower`; it is not
    modified. With heads padded to 128 (models/eva_pad.py, `cfg` from
    pad_vision_head_params) the heads come from `cfg.num_heads` and the
    attention runs at head width 128. Every parameter is cast to `dtype`
    except the final LayerNorm's, which stays f32 as in the JAX forward.
    uint8_input: the tower takes raw uint8 0..255 frames; pixel
    normalization is folded into the patch embed (fold_uint8_frontend).
    int8: every block is an `Int8Block`, its codes quantized on `device`
    from the float weights before anything is cast to `dtype`.

    meta records int8, dtype, uint8_input and the device, so that
    build_scanned_vision_apply refuses a staged pair built with other
    flags: a uint8_input mismatch would silently apply folded patch
    weights to normalised frames, or the reverse."""
    device = resolve_device(device)
    sd = dict(params.state_dict() if isinstance(params, nn.Module)
              else eva_vision_state_dict(params))
    if uint8_input:
        w, b = fold_uint8_frontend(
            patch_kernel(sd["patch_embed.proj.weight"].float().cpu()),
            sd["patch_embed.proj.bias"].float().cpu())
        sd["patch_embed.proj.weight"] = patch_conv(w)
        sd["patch_embed.proj.bias"] = b
    with torch.device("meta"):
        tower = EvaVisionTower(cfg)
    load_into(tower, sd, "EVA vision")
    if int8:
        blocks = nn.ModuleList(Int8Block(blk.to(device), dtype)
                               for blk in tower.blocks)
        tower.blocks = nn.ModuleList()  # .to(dtype) must not cast the scales
    tower = tower.to(device=device, dtype=dtype).eval()
    tower.norm.float()
    if int8:
        tower.blocks = blocks.eval()
    return tower, _meta(int8, dtype, uint8_input, device)


def build_scanned_vision_apply(params: Union[Mapping, nn.Module, None],
                               cfg: EvaVisionConfig = EvaVisionConfig(), *,
                               dtype: torch.dtype = torch.bfloat16,
                               fast_gelu: bool = True,
                               uint8_input: bool = False, int8: bool = False,
                               fused_quant: bool = False,
                               fused_mlp: bool = False,
                               attn_v2: bool = False, attn_v3: bool = False,
                               fused_ln: bool = False,
                               staged: Optional[tuple] = None,
                               device=None) -> Callable:
    """Return `apply(images [B, H, W, 3] NHWC) -> [B, embed_dim] f32` on the
    tower that `stage_scanned_params(params, cfg, int8=..., dtype=...,
    uint8_input=..., device=...)` stages, or on `staged`, such a pair
    staged before with the same flags (else ValueError; `params` is then
    not read).

    The flags and defaults are the JAX function's: with none set the bf16
    forward runs the v1 attention (K8), and int8 alone the "int8 dyn"
    path. fused_quant takes effect with int8 (K2, K5 and the attention's
    int8 epilogue), fused_mlp with fused_quant (K4), fused_ln without int8
    (K10); attn_v3 (K1/K3) wins over attn_v2 (K9), and both need head rows
    that are multiples of 128 wide. fast_gelu selects gelu_bf16_poly over
    exact GELU.

    Each call is two spans (utils/profiling.py): `eva.copy_in` (attr
    `bytes`), the frames' copy to the device, which waits behind the
    kernels already queued where the host memory is pageable; and
    `eva.forward`, enqueueing the forward."""
    device = resolve_device(device)
    if staged is None:
        staged = stage_scanned_params(params, cfg, int8=int8, dtype=dtype,
                                      uint8_input=uint8_input, device=device)
    if not isinstance(staged, tuple) or len(staged) != 2:
        raise ValueError("staged must be the (tower, meta) pair that "
                         "stage_scanned_params returns: without its meta "
                         "the staging flags cannot be checked")
    tower, meta = staged
    want = _meta(int8, dtype, uint8_input, device)
    if meta != want:
        raise ValueError(f"staged params were staged with {meta} but the "
                         f"forward is being built with {want}: restage with "
                         f"matching flags (a uint8_input mismatch would "
                         f"silently corrupt embeddings)")
    tcfg = tower.cfg
    packed = (tcfg.num_heads * tcfg.head_width) % 128 == 0
    fq = fused_quant and int8
    opts = BlockOptions(
        fast_gelu=fast_gelu,
        attn=("v3" if attn_v3 and packed else "v2" if attn_v2 and packed
              else "v1" if packed else "split"),
        fused_ln=fused_ln and not int8, fused_quant=fq,
        fused_mlp=fused_mlp and fq)

    @torch.inference_mode()
    def apply(images) -> torch.Tensor:
        with span("eva.copy_in") as s:
            x = torch.as_tensor(images)
            if s is not None:
                s.attrs["bytes"] = x.nbytes
            x = x.to(device)
        with span("eva.forward"):
            return tower(x, opts)

    return apply
