"""Int8 pieces of the EVA vision trunk.

Counterpart of hirest_tpu/ops/quant.py (ln_quant, fused_mlp_int8) and of the
int8 helpers of hirest_tpu/models/eva_scan.py (_quantize_stacked,
_dyn_quant_rows, _int8_mm). Weights keep nn.Linear's [out, in] layout, so
both operands of every int8 product are contiguous along the reduced axis.

Two kernels live here, each a hand-written CUDA kernel with a plain PyTorch
version beside it: `ln_quant` (K2, csrc/ln_quant.cu) and `fused_mlp_int8`
(K4, csrc/fused_mlp_int8.cu). A CPU tensor takes the plain version; a CUDA
tensor launches the kernel or raises. The qkv and out projections
(`int8_mm`) are int8 x int8 -> int32 products that the JAX package leaves
to XLA; here they go to `torch._int_mm` with the dequantization in eager
PyTorch.

Every quantization is the reference's: scale max(max|y| / 127, 1e-8),
codes round-half-even(y / scale) clipped to +-127, products accumulated in
int32.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from hirest_tpu_torch.models.layers import gelu_bf16_poly
from hirest_tpu_torch.ops import build

N_CHUNK = 1024  # hidden units per requant scale in the fused MLP
ACTS = {"gelu_poly": 0, "gelu": 1}  # activation name -> kernel selector
KERNEL_WIDTH = 1408  # trunk width the fused-MLP kernel is built for
LN_MAX_WIDTH = 2048  # widest row the ln_quant kernel holds in registers


def _scale_and_codes(y: torch.Tensor, dim: int = -1):
    """The reference's symmetric int8 quantization of f32 y along dim. Both
    divisions are true divisions: PyTorch's CUDA kernels turn a division
    by a Python number into a multiplication by its reciprocal, so 127 is
    passed as a tensor."""
    amax = y.abs().amax(dim, keepdim=True)
    s = (amax / amax.new_tensor(127.0)).clamp_min(1e-8)
    return torch.round(y / s).clamp(-127, 127).to(torch.int8), s


def quantize_weight(w: torch.Tensor):
    """[..., out, in] float weight -> ([..., out, in] int8 codes,
    [..., out] f32 scales), one scale per output channel (and per layer
    for a stacked [L, out, in] weight). Counterpart of `quantize_weight`
    and `eva_scan._quantize_stacked`, in nn.Linear's layout."""
    q, s = _scale_and_codes(w.float(), -1)
    return q, s.squeeze(-1)


def dyn_quant_rows(x: torch.Tensor):
    """[..., n] float -> (int8 codes, [..., 1] f32 row scales)."""
    return _scale_and_codes(x.float())


def int8_mm(x_q, x_s, w_q, w_s, bias, out_dtype) -> torch.Tensor:
    """x_q [M, in] int8 with row scales x_s [M, 1], w_q [out, in] int8 with
    channel scales w_s [out] -> (f32(x_q w_q^T) * x_s) * w_s + bias, cast
    to out_dtype (eva_scan._int8_mm). The product is exact in int32."""
    out = torch._int_mm(x_q, w_q.t()).float()
    out.mul_(x_s).mul_(w_s)
    if bias is not None:
        out.add_(bias.float())
    return out.to(out_dtype)


# --- K2: LayerNorm + per-row int8 quantization ---------------------------


def ln_quant_ref(x, weight, bias, eps: float):
    """Plain version of K2: f32 two-pass LayerNorm of x [M, C], kept in f32
    into the row quantization -> (q int8 [M, C], s f32 [M, 1])."""
    x32 = x.float()
    xc = x32 - x32.mean(-1, keepdim=True)
    var = (xc * xc).mean(-1, keepdim=True)
    y = xc * torch.rsqrt(var + eps) * weight.float() + bias.float()
    return _scale_and_codes(y)


def _ln_quant_fn():
    fn = build.load("ln_quant").hirest_ln_quant
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int,
                                           ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def ln_quant(x, weight, bias, eps: float):
    """LayerNorm + per-row int8 quantization of x [M, C] -> (q int8 [M, C],
    s f32 [M, 1]); weight and bias [C] are applied in f32.

    A CPU tensor takes the plain version. A CUDA tensor must be a
    contiguous bf16 [M, C] with C a multiple of 4 up to 2048, and launches
    the kernel; anything else raises. `ln_quant.launches` counts launches."""
    if x.device.type == "cpu":
        return ln_quant_ref(x, weight, bias, eps)
    _require_cuda(x)
    if x.dim() != 2 or x.dtype != torch.bfloat16 or not x.is_contiguous():
        raise TypeError(f"ln_quant's kernel takes contiguous bf16 [M, C], "
                        f"got {x.dtype} {tuple(x.shape)}")
    m, c = x.shape
    if c % 4 or c > LN_MAX_WIDTH:
        raise ValueError(f"ln_quant's kernel takes C % 4 == 0 and C <= "
                         f"{LN_MAX_WIDTH}, got {c}")
    g, b = _f32_vector(weight, c, x.device), _f32_vector(bias, c, x.device)
    q = torch.empty((m, c), dtype=torch.int8, device=x.device)
    s = torch.empty((m, 1), dtype=torch.float32, device=x.device)
    fn = _ln_quant_fn()
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), g.data_ptr(), b.data_ptr(), q.data_ptr(),
                 s.data_ptr(), m, c, eps,
                 torch.cuda.current_stream().cuda_stream)
    build.check(build.load("ln_quant"), err, "ln_quant launch")
    ln_quant.launches += 1
    return q, s


ln_quant.launches = 0


# --- K4: fc1 -> act -> per-(row, chunk) requant -> fc2 -> + residual ------


def _act(name: str):
    if name not in ACTS:
        raise ValueError(f"act must be one of {sorted(ACTS)}, got {name!r}")
    return gelu_bf16_poly if name == "gelu_poly" else (
        lambda y: F.gelu(y, approximate="none"))


def _chunk(f: int, n_chunk: int) -> int:
    nc = min(n_chunk, f)
    if f % nc:
        raise ValueError(f"mlp_hidden {f} is not a multiple of the "
                         f"{nc}-unit requant chunk")
    return nc


def fused_mlp_int8_ref(h_q, h_s, w1_q, w1_s, b1, w2_q, w2_s, b2, x_res, *,
                       act: str = "gelu_poly", n_chunk: int = N_CHUNK):
    """Plain version of K4 (hirest_tpu/ops/quant.py::_fused_mlp_kernel).

    h_q [M, C] int8, h_s [M, 1] f32; w1_q [F, C] int8, w1_s/b1 [F];
    w2_q [C, F] int8, w2_s/b2 [C]; x_res [M, C]. For each n_chunk-wide
    slice of the F hidden units: y = act((f32(h_q w1^T) * h_s) * s1 + b1)
    in f32, requantized per (row, chunk), and part = f32(q2 w2^T) * sc;
    acc = (x + b2) + part * s2 on the first chunk, acc += part * s2 after.
    Returns acc cast once to x_res's dtype."""
    act_fn = _act(act)
    f = w1_q.shape[0]
    nc = _chunk(f, n_chunk)
    acc = None
    for j in range(0, f, nc):
        y = torch._int_mm(h_q, w1_q[j:j + nc].t()).float()
        y.mul_(h_s).mul_(w1_s[j:j + nc].float()).add_(b1[j:j + nc].float())
        q2, sc = _scale_and_codes(act_fn(y))
        part = torch._int_mm(q2, w2_q[:, j:j + nc].t()).float().mul_(sc)
        part.mul_(w2_s.float())
        if acc is None:
            acc = (x_res.float() + b2.float()).add_(part)
        else:
            acc.add_(part)
    return acc.to(x_res.dtype)


def _fused_mlp_fn():
    fn = build.load("fused_mlp_int8").hirest_fused_mlp_int8
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int, ctypes.c_int,
                                            ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def fused_mlp_int8(h_q, h_s, w1_q, w1_s, b1, w2_q, w2_s, b2, x_res, *,
                   act: str = "gelu_poly"):
    """x_res + fc2(requant(act(fc1(h)))) for the int8 trunk, with 1024-unit
    requant chunks; arguments as in fused_mlp_int8_ref.

    A CPU tensor takes the plain version. A CUDA call launches the kernel,
    which is built for the EVA-g trunk: C = 1408, F a multiple of the
    1024-unit chunk, contiguous int8 codes, f32 scales and biases, bf16
    x_res; anything else raises. `fused_mlp_int8.launches` counts
    launches."""
    if h_q.device.type == "cpu":
        return fused_mlp_int8_ref(h_q, h_s, w1_q, w1_s, b1, w2_q, w2_s, b2,
                                  x_res, act=act)
    _require_cuda(h_q)
    _act(act)
    m, c = h_q.shape
    f = w1_q.shape[0]
    nc = _chunk(f, N_CHUNK)
    if c != KERNEL_WIDTH or nc != N_CHUNK:
        raise ValueError(f"fused_mlp_int8's kernel is built for C = "
                         f"{KERNEL_WIDTH} and {N_CHUNK}-unit chunks, got "
                         f"C = {c}, chunk {nc}")
    shapes = {"h_q": (h_q, (m, c), torch.int8),
              "h_s": (h_s, (m, 1), torch.float32),
              "w1_q": (w1_q, (f, c), torch.int8),
              "w2_q": (w2_q, (c, f), torch.int8),
              "x_res": (x_res, (m, c), torch.bfloat16)}
    for name, (t, shape, dtype) in shapes.items():
        if (tuple(t.shape) != shape or t.dtype != dtype
                or not t.is_contiguous() or t.device != h_q.device):
            raise TypeError(f"fused_mlp_int8's kernel takes {name} as "
                            f"contiguous {dtype} {shape} on {h_q.device}, "
                            f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    dev = h_q.device
    s1, bb1 = _f32_vector(w1_s, f, dev), _f32_vector(b1, f, dev)
    s2, bb2 = _f32_vector(w2_s, c, dev), _f32_vector(b2, c, dev)
    out = torch.empty_like(x_res)
    # f32 running sum of the fc2 partials between chunks; rows are owned
    # by one block each, so it needs no atomics
    ws = torch.empty((m, c) if f > nc else (1,), dtype=torch.float32,
                     device=dev)
    fn = _fused_mlp_fn()
    with torch.cuda.device(dev):
        err = fn(h_q.data_ptr(), h_s.data_ptr(), w1_q.data_ptr(),
                 s1.data_ptr(), bb1.data_ptr(), w2_q.data_ptr(),
                 s2.data_ptr(), bb2.data_ptr(), x_res.data_ptr(),
                 ws.data_ptr(), out.data_ptr(), m, f, ACTS[act],
                 torch.cuda.current_stream().cuda_stream)
    build.check(build.load("fused_mlp_int8"), err, "fused_mlp_int8 launch")
    fused_mlp_int8.launches += 1
    return out


fused_mlp_int8.launches = 0


def _require_cuda(t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"no kernel for device {t.device}")


def _f32_vector(v: torch.Tensor, n: int, device) -> torch.Tensor:
    """v as a contiguous f32 [n] on device (a no-op for the int8 tower's
    own buffers, which are kept that way)."""
    if v.numel() != n:
        raise ValueError(f"expected {n} values, got {tuple(v.shape)}")
    return v.reshape(n).to(device=device, dtype=torch.float32).contiguous()
