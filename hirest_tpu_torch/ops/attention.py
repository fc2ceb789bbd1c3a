"""Fused-qkv attention for the EVA vision trunk.

Counterpart of hirest_tpu/ops/attention.py::fused_attention_qkv3 (v3, bf16
out, no pad mask). `fused_attention_qkv3` launches the hand-written CUDA
kernel `csrc/attention_qkv3.cu` on a CUDA tensor and takes the plain PyTorch
version `fused_attention_qkv3_ref` only for a tensor on the CPU. The int8
epilogue and the pad-key mask of the JAX function (quant_out, n_real) belong
to the int8 path and are not ported here.
"""

from __future__ import annotations

import ctypes

import torch

from hirest_tpu_torch.ops import build

LOG2E = 1.4426950408889634
KERNEL_HEAD_WIDTH = 88  # head width the CUDA kernel is instantiated for


def _split(qkv_biased: torch.Tensor, num_heads: int):
    b, s, three_hd = qkv_biased.shape
    if three_hd % (3 * num_heads):
        raise ValueError(f"last dim {three_hd} is not 3 * {num_heads} heads "
                         f"* head width")
    return b, s, three_hd // 3, three_hd // (3 * num_heads)


def fused_attention_qkv3_ref(qkv_biased: torch.Tensor, scale: float,
                             num_heads: int) -> torch.Tensor:
    """Plain PyTorch version: [B, S, 3*H*d] (q/v biases pre-added) ->
    [B, S, H*d] in the input dtype, with the reference's softmax: unscaled
    f32 scores, exp2((s - rowmax) * scale * log2e) rounded to the input
    dtype, f32 row sums of the rounded p, f32 PV, normalised at the end."""
    b, s, hd, d = _split(qkv_biased, num_heads)
    q, k, v = qkv_biased.view(b, s, 3, num_heads, d).permute(2, 0, 3, 1, 4)
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
    m = scores.amax(-1, keepdim=True)
    p = torch.exp2((scores - m) * (scale * LOG2E)).to(qkv_biased.dtype)
    den = p.float().sum(-1, keepdim=True)
    o = torch.matmul(p.float(), v.float()) / den  # [B, H, S, d]
    return o.to(qkv_biased.dtype).transpose(1, 2).reshape(b, s, hd)


def _kernel_lib() -> ctypes.CDLL:
    lib = build.load("attention_qkv3")
    fn = lib.hirest_attention_qkv3_bf16
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def fused_attention_qkv3(qkv_biased: torch.Tensor, scale: float,
                         num_heads: int) -> torch.Tensor:
    """Batched-heads attention over [B, S, 3*H*d] fused qkv with the q/v
    biases pre-added -> [B, S, H*d].

    A CPU tensor takes the plain version. A CUDA tensor must be contiguous
    bf16 with head width 88 and launches the kernel on the current stream;
    anything else raises. `fused_attention_qkv3.launches` counts launches."""
    if qkv_biased.device.type == "cpu":
        return fused_attention_qkv3_ref(qkv_biased, scale, num_heads)
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
    out = torch.empty((b, s, hd), dtype=qkv_biased.dtype,
                      device=qkv_biased.device)
    lib = _kernel_lib()
    with torch.cuda.device(qkv_biased.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.hirest_attention_qkv3_bf16(
            qkv_biased.data_ptr(), out.data_ptr(), b, s, num_heads, d,
            scale * LOG2E, stream)
    build.check(lib, err, "attention_qkv3 launch")
    fused_attention_qkv3.launches += 1
    return out


fused_attention_qkv3.launches = 0
