"""Fused-qkv attention for the EVA vision trunk.

Counterpart of hirest_tpu/ops/attention.py::fused_attention_qkv3 (v3), with
its pad-key mask (n_real) and its int8 epilogue (quant_out).
`fused_attention_qkv3` launches the hand-written CUDA kernel
`csrc/attention_qkv3.cu` on a CUDA tensor: K1 for bf16 output, K3 for int8
codes and row scales. It takes the plain PyTorch version
`fused_attention_qkv3_ref` only for a tensor on the CPU.
"""

from __future__ import annotations

import ctypes

import torch

from hirest_tpu_torch.ops import build
from hirest_tpu_torch.ops.quant import dyn_quant_rows

LOG2E = 1.4426950408889634
KERNEL_HEAD_WIDTH = 88  # head width the CUDA kernel is instantiated for


def _split(qkv_biased: torch.Tensor, num_heads: int):
    b, s, three_hd = qkv_biased.shape
    if three_hd % (3 * num_heads):
        raise ValueError(f"last dim {three_hd} is not 3 * {num_heads} heads "
                         f"* head width")
    return b, s, three_hd // 3, three_hd // (3 * num_heads)


def fused_attention_qkv3_ref(qkv_biased: torch.Tensor, scale: float,
                             num_heads: int, *, quant_out: bool = False,
                             n_real: int = 0):
    """Plain PyTorch version: [B, S, 3*H*d] (q/v biases pre-added) ->
    [B, S, H*d] in the input dtype, with the reference's softmax: unscaled
    f32 scores, keys >= n_real (when n_real > 0) set to -1e30 before the
    row max, exp2((s - rowmax) * scale * log2e) rounded to the input dtype,
    f32 row sums of the rounded p, f32 PV, normalised at the end.

    quant_out: return (int8 codes [B, S, H*d], f32 scales [B, S, 1]) of
    the f32 output, one scale over all heads of a row, instead."""
    b, s, hd, d = _split(qkv_biased, num_heads)
    q, k, v = qkv_biased.view(b, s, 3, num_heads, d).permute(2, 0, 3, 1, 4)
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
    if n_real:
        scores[..., n_real:] = -1e30
    m = scores.amax(-1, keepdim=True)
    p = torch.exp2((scores - m) * (scale * LOG2E)).to(qkv_biased.dtype)
    den = p.float().sum(-1, keepdim=True)
    o = torch.matmul(p.float(), v.float()) / den  # [B, H, S, d]
    o = o.transpose(1, 2).reshape(b, s, hd)
    if quant_out:
        return dyn_quant_rows(o)
    return o.to(qkv_biased.dtype)


def _kernel_lib() -> ctypes.CDLL:
    lib = build.load("attention_qkv3")
    ints = [ctypes.c_int] * 5  # B, S, H, D, n_keys
    lib.hirest_attention_qkv3_bf16.argtypes = (
        [ctypes.c_void_p] * 2 + ints + [ctypes.c_float, ctypes.c_void_p])
    lib.hirest_attention_qkv3_quant.argtypes = (
        [ctypes.c_void_p] * 5 + ints + [ctypes.c_float, ctypes.c_void_p])
    lib.hirest_attention_qkv3_bf16.restype = ctypes.c_int
    lib.hirest_attention_qkv3_quant.restype = ctypes.c_int
    return lib


def fused_attention_qkv3(qkv_biased: torch.Tensor, scale: float,
                         num_heads: int, *, quant_out: bool = False,
                         n_real: int = 0):
    """Batched-heads attention over [B, S, 3*H*d] fused qkv with the q/v
    biases pre-added -> [B, S, H*d], or with quant_out the int8 codes and
    f32 row scales [B, S, 1] of the f32 output. Keys >= n_real are masked
    when n_real > 0.

    A CPU tensor takes the plain version. A CUDA tensor must be contiguous
    bf16 with head width 88 and launches the kernel on the current stream;
    anything else raises. `fused_attention_qkv3.launches` counts bf16-out
    launches (K1), `fused_attention_qkv3.quant_launches` int8-out ones (K3)."""
    if qkv_biased.device.type == "cpu":
        return fused_attention_qkv3_ref(qkv_biased, scale, num_heads,
                                        quant_out=quant_out, n_real=n_real)
    if qkv_biased.device.type != "cuda":
        raise ValueError(f"no attention kernel for device "
                         f"{qkv_biased.device}")
    if qkv_biased.dim() != 3:
        raise ValueError(f"expected [B, S, 3*H*d], got "
                         f"{tuple(qkv_biased.shape)}")
    b, s, hd, d = _split(qkv_biased, num_heads)
    if qkv_biased.dtype != torch.bfloat16:
        raise TypeError(f"the CUDA kernel takes bfloat16, got "
                        f"{qkv_biased.dtype}")
    if d != KERNEL_HEAD_WIDTH:
        raise ValueError(f"the CUDA kernel is built for head width "
                         f"{KERNEL_HEAD_WIDTH}, got {d}")
    if not qkv_biased.is_contiguous() or qkv_biased.data_ptr() % 16:
        raise ValueError("qkv must be contiguous and 16-byte aligned")
    if n_real < 0:
        raise ValueError(f"n_real must be >= 0, got {n_real}")
    n_keys = min(n_real, s) if n_real else s
    dev = qkv_biased.device
    lib = _kernel_lib()
    c = scale * LOG2E
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        if quant_out:
            ws = torch.empty((b, s, hd), dtype=torch.float32, device=dev)
            rowmax = torch.empty((b, s), dtype=torch.int32, device=dev)
            q = torch.empty((b, s, hd), dtype=torch.int8, device=dev)
            sc = torch.empty((b, s, 1), dtype=torch.float32, device=dev)
            err = lib.hirest_attention_qkv3_quant(
                qkv_biased.data_ptr(), ws.data_ptr(), rowmax.data_ptr(),
                q.data_ptr(), sc.data_ptr(), b, s, num_heads, d, n_keys, c,
                stream)
        else:
            out = torch.empty((b, s, hd), dtype=qkv_biased.dtype, device=dev)
            err = lib.hirest_attention_qkv3_bf16(
                qkv_biased.data_ptr(), out.data_ptr(), b, s, num_heads, d,
                n_keys, c, stream)
    build.check(lib, err, "attention_qkv3 launch")
    if quant_out:
        fused_attention_qkv3.quant_launches += 1
        return q, sc
    fused_attention_qkv3.launches += 1
    return out


fused_attention_qkv3.launches = 0
fused_attention_qkv3.quant_launches = 0
