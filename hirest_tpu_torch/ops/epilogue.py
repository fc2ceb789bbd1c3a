"""The scanned EVA block's projection epilogues: E1 (bias + activation) and
E2 (bias + residual).

They replace no Pallas kernel. On the TPU, XLA fused each into the dot it
follows (hirest_tpu/models/eva_scan.py:253-264): the qkv bias of the v2/v3
attention (:309-310), proj's bias and residual (:347), fc1's bias and
GELU (:350), fc2's bias and residual (:351), and the int8 dyn path's GELU
on int8_mm's output (:342). Here the four products stay `F.linear` on
cuBLAS, and what follows each is one hand-written CUDA kernel
(csrc/epilogue.cu) with a plain PyTorch version beside it:

- `bias_act` (E1): y <- act(y + b), in place on y [..., C]; b [C] or None;
  act "gelu_poly" (`gelu_bf16_poly`), "gelu" (exact erf) or "none".
- `bias_residual` (E2): y <- x + (y + b), in place on the fresh product y
  [..., C], residual x like y, b [C].

The plain versions are the block's code as it stood: the bias added in y's
dtype (`eva_clip.linear`, so in bf16 the sum is rounded before the GELU or
the residual reads it), then the activation or the residual sum. A CPU
tensor takes the plain version. A CUDA tensor must be contiguous, 16-byte
aligned bf16 with C a multiple of 8, or f32 with C a multiple of 4, C at
most 8192, with b and x of y's dtype, contiguous and aligned
(`epilogue_shape`), and launches the kernel; anything else raises. Each
wrapper's `.launches` counts bf16 launches, `.launches_f32` f32 ones.
Callers use the returned tensor: y is overwritten (the plain versions add
the bias into it in place, as `linear` did).
"""

from __future__ import annotations

import ctypes
import math

import torch

from hirest_tpu_torch.models.layers import gelu, gelu_bf16_poly
from hirest_tpu_torch.ops import build
from hirest_tpu_torch.ops.quant import _count

ACTS = {"gelu_poly": 0, "gelu": 1, "none": 2}  # act name -> kernel selector
# dtype -> what C must be a multiple of: 16-byte vectors of y, x and b
EPILOGUE_FORMS = {torch.bfloat16: 8, torch.float32: 4}
MAX_WIDTH = 8192  # widest row: the kernels hold the bias row in shared memory


def _act_fn(act: str):
    if act not in ACTS:
        raise ValueError(f"act must be one of {sorted(ACTS)}, got {act!r}")
    return {"gelu_poly": gelu_bf16_poly, "gelu": gelu,
            "none": lambda y: y}[act]


def bias_act_ref(y, bias=None, *, act: str = "gelu_poly"):
    """Plain version of E1: bias added into y in y's dtype (eva_clip.linear),
    then act in f32 (gelu_bf16_poly; exact GELU as F.gelu computes it) and
    the result in y's dtype."""
    fn = _act_fn(act)
    return fn(y if bias is None else y.add_(bias))


def bias_residual_ref(y, bias, x):
    """Plain version of E2: bias added into y in y's dtype, then x + y (the
    block's `x + linear(...)`)."""
    return x + y.add_(bias)


def epilogue_shape(dtype, shape, contiguous: bool = True,
                   aligned: bool = True) -> tuple:
    """(M, C): the rows a tensor [..., C] of `dtype` and `shape` makes for
    E1 and E2, or raises: TypeError unless dtype is bf16 or f32
    (EPILOGUE_FORMS) and the tensor is at least 2-d, contiguous and 16-byte
    aligned; ValueError unless C is a multiple of the form's vector, at most
    MAX_WIDTH, and the tensor holds fewer than 2^31 values. Needs no GPU:
    the CUDA wrappers check y, x and the bias through it."""
    if (dtype not in EPILOGUE_FORMS or len(shape) < 2 or not contiguous
            or not aligned):
        raise TypeError(
            f"the epilogue kernels take contiguous, 16-byte aligned "
            f"torch.bfloat16 or torch.float32 [..., C], got {dtype} "
            f"{tuple(shape)}, contiguous={contiguous}, aligned={aligned}")
    multiple = EPILOGUE_FORMS[dtype]
    m, c = math.prod(shape[:-1]), shape[-1]
    if c % multiple or c > MAX_WIDTH or m * c >= 2 ** 31:
        raise ValueError(f"the epilogue kernels' {dtype} form takes C % "
                         f"{multiple} == 0, C <= {MAX_WIDTH} and fewer than "
                         f"2^31 values, got {tuple(shape)}")
    return m, c


def _layout(t: torch.Tensor) -> tuple:
    return t.is_contiguous(), t.data_ptr() % 16 == 0


def _rows(y: torch.Tensor) -> tuple:
    if y.device.type != "cuda":
        raise ValueError(f"no kernel for device {y.device}")
    return epilogue_shape(y.dtype, y.shape, *_layout(y))


def _operand(t: torch.Tensor, y: torch.Tensor, shape: tuple, name: str):
    """t must be a contiguous, 16-byte aligned tensor of y's dtype and
    device holding `shape`'s values in that layout."""
    if (t.dtype != y.dtype or t.device != y.device
            or t.numel() != math.prod(shape) or t.shape[-1] != shape[-1]
            or not all(_layout(t))):
        raise TypeError(f"the epilogue kernels take {name} as a contiguous, "
                        f"16-byte aligned {y.dtype} {shape} on {y.device}, "
                        f"got {t.dtype} {tuple(t.shape)} on {t.device}, "
                        f"contiguous and aligned {_layout(t)}")
    return t.data_ptr()


def _fn(entry: str, n_pointers: int, n_ints: int):
    fn = getattr(build.load("epilogue"), entry)
    fn.argtypes = [ctypes.c_void_p] * n_pointers + [ctypes.c_int] * n_ints + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def bias_act(y: torch.Tensor, bias=None, *, act: str = "gelu_poly"):
    """E1: act(y + bias) written into y, which is returned; bias [C] or
    None. With neither a bias nor an activation there is nothing to compute
    and y is returned as it is, with no launch."""
    if y.device.type == "cpu":
        return bias_act_ref(y, bias, act=act)
    _act_fn(act)
    m, c = _rows(y)
    if bias is None and act == "none":
        return y
    b = None if bias is None else _operand(bias, y, (c,), "the bias")
    f32 = y.dtype == torch.float32
    fn = _fn("hirest_bias_act_f32" if f32 else "hirest_bias_act", 2, 3)
    with torch.cuda.device(y.device):
        err = fn(y.data_ptr(), b, m, c, ACTS[act],
                 torch.cuda.current_stream().cuda_stream)
    build.check(build.load("epilogue"), err,
                f"bias_act{' f32' if f32 else ''} launch")
    _count(bias_act, f32)
    return y


def bias_residual(y: torch.Tensor, bias: torch.Tensor, x: torch.Tensor):
    """E2: x + (y + bias) written into y, which is returned; bias [C], x
    shaped like y."""
    if y.device.type == "cpu":
        return bias_residual_ref(y, bias, x)
    m, c = _rows(y)
    b = _operand(bias, y, (c,), "the bias")
    if tuple(x.shape) != tuple(y.shape):
        raise TypeError(f"the residual {tuple(x.shape)} is not shaped like "
                        f"y {tuple(y.shape)}")
    xp = _operand(x, y, (m, c), "the residual")
    f32 = y.dtype == torch.float32
    fn = _fn("hirest_bias_residual_f32" if f32 else "hirest_bias_residual",
             3, 2)
    with torch.cuda.device(y.device):
        err = fn(y.data_ptr(), xp, b, m, c,
                 torch.cuda.current_stream().cuda_stream)
    build.check(build.load("epilogue"), err,
                f"bias_residual{' f32' if f32 else ''} launch")
    _count(bias_residual, f32)
    return y


bias_act.launches = 0
bias_act.launches_f32 = 0
bias_residual.launches = 0
bias_residual.launches_f32 = 0
