"""Int8 pieces of the EVA vision trunk, and its bf16 LayerNorm kernel.

Counterpart of hirest_tpu/ops/quant.py (ln_quant, act_quant, ln_bf16,
fused_mlp_int8, int8_matmul, QuantDense) and of the int8 helpers of
hirest_tpu/models/eva_scan.py (_quantize_stacked, _dyn_quant_rows,
_int8_mm). Weights keep nn.Linear's
[out, in] layout, so both operands of every int8 product are contiguous
along the reduced axis.

Seven kernels live here, each a hand-written CUDA kernel with a plain
PyTorch version beside it: `ln_quant` (K2) and `ln_bf16` (K10), both in
csrc/ln_quant.cu, `act_quant` (K5, csrc/act_quant.cu), `fused_mlp_int8`
(K4, two kernels in csrc/fused_mlp_int8.cu), and three the JAX package
leaves to XLA: `int8_mm` (G1, csrc/int8_gemm.cu), an int8 projection
whole, the int8 x int8 -> int32 product on wgmma with its dequantization,
bias and residual sum in its epilogue; and, in csrc/int8_epilogue.cu,
`int8_epilogue` (E3), that dequantization alone on an int32 accumulator,
and `row_quant` (E4), the dynamic per-row quantizer of `int8_matmul`,
whose rows a bulk copy takes run K5's ring body instead (csrc/act_quant.cu,
`row_quant_route`). A
CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises. Each takes bf16 or f32 input, as the JAX kernels compute in the
dtype they are given: the row kernels (K2, K5, K10) have an f32 form of
their own for f32 rows, K4 one for an f32 residual, G1 and E3 one for f32
out and E4 one for f32 rows; `row_kernel_shape`, `int8_gemm_shape`,
`int8_epilogue_shape` and `row_quant_shape` state which tensors they
take, without a GPU. The block's projections (`int8_mm`) launch G1, whose
epilogue is E3's arithmetic (csrc/int8_dequant.cuh), so E3 runs on no path
of the port. `dyn_quant_rows`, the scanned block's quantizer
(eva_scan._dyn_quant_rows), runs K5's form without an activation, the
same function bit for bit. `int8_matmul` and `QuantDense` (the unrolled
int8 tower's dense layers, models/eva_quant.py) quantize the activations
per row with E4 straight into the operand G1 takes, zero-padded along K,
then run G1.

Every quantization is the reference's: scale max(max|y| / 127, 1e-8),
codes round-half-even(y / scale) clipped to +-127, products accumulated in
int32.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from hirest_tpu_torch.models.layers import gelu_bf16_poly
from hirest_tpu_torch.ops import build

N_CHUNK = 1024  # hidden units per requant scale in the fused MLP
ACTS = {"gelu_poly": 0, "gelu": 1}  # activation name -> kernel selector
QUANT_ACTS = {**ACTS, "none": 2}  # act_quant also quantizes without one
KERNEL_WIDTH = 1408  # trunk width the fused-MLP kernel is built for
# row kernel -> input dtype -> (what C must be a multiple of, widest C):
# bf16 rows come in by 16-byte bulk copies (act_quant's threads take 16
# values at a time), f32 rows by 16-byte loads
ROW_KERNELS = {
    "ln_quant": {torch.bfloat16: (8, 2048), torch.float32: (4, 2048)},
    "ln_bf16": {torch.bfloat16: (8, 2048), torch.float32: (4, 2048)},
    "act_quant": {torch.bfloat16: (16, 8192), torch.float32: (4, 8192)},
}


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
    and `eva_scan._quantize_stacked`, in nn.Linear's layout, the codes
    contiguous whatever w's strides (G1 reads their rows by TMA)."""
    q, s = _scale_and_codes(w.float(), -1)
    return q.contiguous(), s.squeeze(-1)


def dyn_quant_rows_ref(x: torch.Tensor):
    """Plain version of `dyn_quant_rows` (and of E4's quantization): [...,
    n] float -> (int8 codes, [..., 1] f32 row scales), quantized from f32
    with true divisions."""
    return _scale_and_codes(x.float())


# --- E3 and E4: the int8 products' epilogue and the dynamic row quantizer --


def int8_epilogue_ref(acc, x_s, w_s, bias, out_dtype, residual=None):
    """Plain version of E3: acc [M, N] int32 -> (f32(acc) * x_s) * w_s +
    bias in f32 (x_s [M, 1], w_s [N], bias [N] or None), cast to out_dtype
    (eva_scan._int8_mm's epilogue); with a residual [M, N] of out_dtype,
    residual + that, summed in out_dtype (`x + _int8_mm(...)`)."""
    out = acc.float()
    out.mul_(x_s).mul_(w_s)
    if bias is not None:
        out.add_(bias.float())
    out = out.to(out_dtype)
    return out if residual is None else residual + out


# dtype -> bytes a vector of 4 values takes: what E3's out and residual and
# E4's rows must be aligned to
VEC4_BYTES = {torch.bfloat16: 8, torch.float32: 16}
INT8_EPI_WIDTH = 8192  # widest row of E3 (w_s and the bias in shared
                       # memory) and of E4 (a row in a group's registers)


def int8_epilogue_shape(out_dtype, shape, contiguous: bool = True,
                        aligned: bool = True) -> tuple:
    """(M, N): what E3 makes of an int32 accumulator `shape` [M, N] with
    out_dtype, or raises: TypeError unless out_dtype is bf16 or f32
    (VEC4_BYTES) and the accumulator is 2-d, contiguous and 16-byte
    aligned; ValueError unless N is a multiple of 4 and at most
    INT8_EPI_WIDTH, M >= 1 and M * N < 2^31. Needs no GPU: `int8_epilogue`
    checks its operands through it."""
    if (out_dtype not in VEC4_BYTES or len(shape) != 2 or not contiguous
            or not aligned):
        raise TypeError(
            f"E3 takes a contiguous, 16-byte aligned int32 [M, N] into "
            f"torch.bfloat16 or torch.float32, got {out_dtype} "
            f"{tuple(shape)}, contiguous={contiguous}, aligned={aligned}")
    m, n = shape
    if m < 1 or n % 4 or n > INT8_EPI_WIDTH or m * n >= 2 ** 31:
        raise ValueError(f"E3 takes N % 4 == 0, N <= {INT8_EPI_WIDTH}, "
                         f"M >= 1 and fewer than 2^31 values, got "
                         f"{tuple(shape)}")
    return m, n


def row_quant_shape(dtype, shape, row_stride: int, aligned: bool = True,
                    ldq=None, rows=None) -> tuple:
    """(M, C): the rows [M, C] of `dtype` that E4 quantizes, rows
    `row_stride` values apart, into codes ldq >= C wide (default C) for
    `rows` >= M rows (default M), or raises: TypeError unless dtype is bf16
    or f32 (VEC4_BYTES), the rows are 2-d and each starts on a vector
    (aligned, row_stride % 4 == 0); ValueError unless C % 4 == 0, C <=
    INT8_EPI_WIDTH, ldq % 4 == 0 and M >= 1. A tensor [..., C] comes as its
    `reshape(-1, C)` with the last stride 1. Needs no GPU: `row_quant`
    checks its input through it, and `row_quant_route` then says which of
    E4's two kernels takes the rows."""
    if (dtype not in VEC4_BYTES or len(shape) != 2 or not aligned
            or row_stride % 4 or row_stride < shape[-1]):
        raise TypeError(
            f"E4 takes torch.bfloat16 or torch.float32 rows [M, C], each "
            f"starting on a {VEC4_BYTES.get(dtype, 16)}-byte vector, with "
            f"unit last stride, got {dtype} {tuple(shape)}, row stride "
            f"{row_stride}, aligned={aligned}")
    m, c = shape
    ldq = c if ldq is None else ldq
    rows = m if rows is None else rows
    if (m < 1 or c % 4 or c > INT8_EPI_WIDTH or ldq % 4 or ldq < c
            or rows < m or rows * ldq >= 2 ** 31):
        raise ValueError(f"E4 takes C % 4 == 0, C <= {INT8_EPI_WIDTH}, "
                         f"codes ldq >= C wide with ldq % 4 == 0 and M >= 1, "
                         f"got {tuple(shape)} into [{rows}, {ldq}]")
    return m, c


# E4's bulk-copy ring (K5's body, csrc/act_quant.cu) takes bf16 rows each
# starting 16-byte aligned, C a multiple of its 16-value unit, and codes
# rows a multiple of 16 bytes apart (its 16-byte stores)
E4_RING_MULTIPLE = 16


def row_quant_route(dtype, shape, row_stride: int, aligned16: bool = True,
                    ldq=None) -> str:
    """Which of E4's kernels takes rows that `row_quant_shape` takes:
    "ring" (K5's bulk-copy ring body without an activation, act_quant.cu)
    for bf16 rows whose every start is 16-byte aligned (aligned16: the
    first; row_stride % 8 == 0) with C and the codes' width ldq (default
    C) multiples of E4_RING_MULTIPLE; else "rows" (row_quant_kernel,
    int8_epilogue.cu): the unrolled tower's 588-wide patch rows, f32 rows.
    Needs no GPU."""
    c = shape[-1]
    ldq = c if ldq is None else ldq
    ring = (dtype == torch.bfloat16 and aligned16 and row_stride % 8 == 0
            and c % E4_RING_MULTIPLE == 0 and ldq % E4_RING_MULTIPLE == 0)
    return "ring" if ring else "rows"


def _epi_fn(entry: str, n_pointers: int):
    fn = getattr(build.load("int8_epilogue"), entry)
    fn.argtypes = [ctypes.c_void_p] * n_pointers + [ctypes.c_int] * 2 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def int8_epilogue(acc, x_s, w_s, bias, out_dtype, residual=None):
    """E3: acc [M, N] int32 -> (f32(acc) * x_s) * w_s + bias in f32, cast to
    out_dtype, or residual + that in out_dtype; x_s [M, 1] (or any tensor
    of M row scales), w_s and bias [N] (bias may be None), residual [M, N]
    of out_dtype or None.

    A CPU tensor takes the plain version. A CUDA call takes acc as
    `int8_epilogue_shape` says and the residual contiguous and 16-byte
    aligned, and launches the kernel (bf16 or f32 out); anything else
    raises. `int8_epilogue.launches` counts bf16-out launches,
    `.launches_f32` f32 ones."""
    if acc.device.type == "cpu":
        return int8_epilogue_ref(acc, x_s, w_s, bias, out_dtype, residual)
    _require_cuda(acc)
    if acc.dtype != torch.int32:
        raise TypeError(f"E3 takes an int32 accumulator, got {acc.dtype}")
    m, n = int8_epilogue_shape(out_dtype, acc.shape, acc.is_contiguous(),
                               acc.data_ptr() % 16 == 0)
    dev = acc.device
    xs = _f32_vector(x_s, m, dev)
    ws = _f32_vector(w_s, n, dev)
    b = None if bias is None else _f32_vector(bias, n, dev)
    out = torch.empty((m, n), dtype=out_dtype, device=dev)
    if residual is not None:
        _check_operands("int8_epilogue", dev,
                        residual=(residual, (m, n), out_dtype))
    f32 = out_dtype == torch.float32
    fn = _epi_fn("hirest_dequant_f32" if f32 else "hirest_dequant", 6)
    with torch.cuda.device(dev):
        err = fn(acc.data_ptr(), xs.data_ptr(), ws.data_ptr(),
                 None if b is None else b.data_ptr(),
                 None if residual is None else residual.data_ptr(),
                 out.data_ptr(), m, n,
                 torch.cuda.current_stream().cuda_stream)
    build.check(build.load("int8_epilogue"), err,
                f"int8_epilogue{' f32' if f32 else ''} launch")
    _count(int8_epilogue, f32)
    return out


def row_quant_ref(x2: torch.Tensor, rows=None, ldq=None):
    """Plain version of E4: the rows x2 [M, C] quantized as
    `dyn_quant_rows_ref`, the codes zero-padded to [rows, ldq] and the
    scales to [rows, 1] (F.pad; rows default M, ldq default C)."""
    q, s = dyn_quant_rows_ref(x2)
    m, c = q.shape
    rows = m if rows is None else rows
    ldq = c if ldq is None else ldq
    if rows != m or ldq != c:
        q = F.pad(q, (0, ldq - c, 0, rows - m))
        s = F.pad(s, (0, 0, 0, rows - m))
    return q, s


@functools.cache
def _row_quant_fn(lib: str, entry: str):
    """E4's C entry `entry` of csrc/<lib>.cu, its argument types set once:
    x, q, s, M, rows, C, ldx (64-bit), ldq, the stream."""
    fn = getattr(build.load(lib), entry)
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def row_quant(x2: torch.Tensor, rows=None, ldq=None):
    """E4: the rows x2 [M, C] (a 2-d view with unit last stride, rows any
    distance apart) -> (codes [rows, ldq] int8, scales [rows, 1] f32), each
    row quantized as `dyn_quant_rows`, zero past C and past M: the operand
    G1 takes, zero-padded along K (rows default M, ldq default C).

    A CPU tensor takes the plain version. A CUDA tensor must be bf16 or f32
    rows as `row_quant_shape` says, and launches the kernel
    `row_quant_route` names; anything else raises. `row_quant.launches`
    counts launches on the ring (bf16), `.rows_launches` bf16 launches of
    row_quant_kernel, `.launches_f32` its launches on f32 rows."""
    if x2.device.type == "cpu":
        return row_quant_ref(x2, rows, ldq)
    _require_cuda(x2)
    if x2.dim() != 2:
        raise TypeError(f"E4 takes rows [M, C], got {tuple(x2.shape)}")
    m, c = x2.shape
    rows = m if rows is None else rows
    ldq = c if ldq is None else ldq
    ldx = x2.stride(0) if m > 1 else c
    row_quant_shape(x2.dtype, x2.shape, ldx, x2.stride(-1) == 1
                    and x2.data_ptr() % VEC4_BYTES.get(x2.dtype, 16) == 0,
                    ldq, rows)
    ring = row_quant_route(x2.dtype, x2.shape, ldx, x2.data_ptr() % 16 == 0,
                           ldq) == "ring"
    q = torch.empty((rows, ldq), dtype=torch.int8, device=x2.device)
    s = torch.empty((rows, 1), dtype=torch.float32, device=x2.device)
    f32 = x2.dtype == torch.float32
    lib, entry = (("act_quant", "hirest_row_quant_ring") if ring else
                  ("int8_epilogue", "hirest_row_quant_f32" if f32
                   else "hirest_row_quant"))
    fn = _row_quant_fn(lib, entry)
    with torch.cuda.device(x2.device):
        err = fn(x2.data_ptr(), q.data_ptr(), s.data_ptr(), m, rows, c, ldx,
                 ldq, torch.cuda.current_stream().cuda_stream)
    build.check(build.load(lib), err, f"row_quant {entry} launch")
    if ring:
        row_quant.launches += 1
    elif f32:
        row_quant.launches_f32 += 1
    else:
        row_quant.rows_launches += 1
    return q, s


row_quant.launches = 0
row_quant.rows_launches = 0
row_quant.launches_f32 = 0
int8_epilogue.launches = 0
int8_epilogue.launches_f32 = 0


def dyn_quant_rows(x: torch.Tensor):
    """[..., C] float -> (int8 codes like x, [..., 1] f32 row scales), as
    eva_scan._dyn_quant_rows.

    A CPU tensor takes the plain version (`dyn_quant_rows_ref`). A CUDA
    tensor launches K5's form without an activation (`act_quant(x,
    act="none")`: the same function, whose codes and scales chip_smoke.py
    holds bit for bit against the plain version at the scanned block's
    widths), so it takes what K5 takes (`row_kernel_shape`) and raises on
    anything else; its launches count on `act_quant`."""
    if x.device.type == "cpu":
        return dyn_quant_rows_ref(x)
    return act_quant(x, act="none")


# --- G1: the int8 projections, product and epilogue in one kernel --------

INT8_GEMM_OUT = (torch.bfloat16, torch.float32)  # G1's output dtypes
INT8_GEMM_K_MULTIPLE = 16  # TMA reads rows 16-byte aligned
INT8_GEMM_N_MULTIPLE = 8  # the epilogue stores 8 bf16 values at a time
# torch._int_mm on a CUDA tensor takes M > 16 rows: the plain version pads
_INT_MM_MIN_ROWS = 17


def int8_mm_ref(x_q, x_s, w_q, w_s, bias, out_dtype, residual=None):
    """Plain version of G1: the exact int32 product x_q w_q^T
    (`torch._int_mm`), then E3's plain version (`int8_epilogue_ref`). On a
    CUDA tensor x_q's rows are zero-padded to the 17 `torch._int_mm`
    takes there and the product cut back."""
    m = x_q.shape[0]
    x2 = x_q
    if x_q.device.type == "cuda" and m < _INT_MM_MIN_ROWS:
        x2 = F.pad(x_q, (0, 0, 0, _INT_MM_MIN_ROWS - m))
    acc = torch._int_mm(x2.contiguous(), w_q.t())[:m]
    return int8_epilogue_ref(acc, x_s, w_s, bias, out_dtype, residual)


def int8_gemm_shape(out_dtype, x_shape, w_shape, x_stride=None,
                    w_stride=None, aligned: bool = True) -> tuple:
    """(M, N, K): what G1 makes of x_q `x_shape` [M, K] times w_q `w_shape`
    [N, K]^T into out_dtype, each int8 operand with the strides given
    (default contiguous), or raises: TypeError unless out_dtype is bf16 or
    f32 (INT8_GEMM_OUT), both operands are 2-d with unit last stride and
    rows a multiple of 16 bytes and at least K apart, and both start
    16-byte aligned; ValueError (checked before the strides) unless they
    share K, K is a multiple of INT8_GEMM_K_MULTIPLE, N of
    INT8_GEMM_N_MULTIPLE, and M, N >= 1. A single row (M == 1) may have
    any row stride. Needs no GPU: `int8_mm` checks its operands through
    it."""
    def row_stride(shape, stride):
        if stride is None:
            return shape[-1], 1
        if len(stride) != 2:
            return -1, -1
        return (shape[-1] if shape[0] == 1 else stride[0]), stride[1]

    if (out_dtype not in INT8_GEMM_OUT or len(x_shape) != 2
            or len(w_shape) != 2 or not aligned):
        raise TypeError(
            f"G1 takes int8 x_q [M, K] and w_q [N, K], 16-byte aligned, into "
            f"torch.bfloat16 or torch.float32, got {out_dtype} "
            f"{tuple(x_shape)} x {tuple(w_shape)}, aligned={aligned}")
    (m, k), (n, kw) = x_shape, w_shape
    if (k != kw or k < 1 or k % INT8_GEMM_K_MULTIPLE or m < 1 or n < 1
            or n % INT8_GEMM_N_MULTIPLE):
        raise ValueError(f"G1 takes K % {INT8_GEMM_K_MULTIPLE} == 0 shared "
                         f"by both operands, N % {INT8_GEMM_N_MULTIPLE} == 0 "
                         f"and M >= 1, got {tuple(x_shape)} x "
                         f"{tuple(w_shape)}")
    for name, shape, stride in (("x_q", x_shape, x_stride),
                                ("w_q", w_shape, w_stride)):
        ld, unit = row_stride(shape, stride)
        if unit != 1 or ld % 16 or ld < k:
            raise TypeError(f"G1 reads {name} by TMA: unit last stride and "
                            f"rows a multiple of 16 bytes and at least K "
                            f"apart, got strides {stride} for "
                            f"{tuple(shape)}")
    return m, n, k


# G1's variants (csrc/int8_gemm.cu), by number -> what each is
INT8_GEMM_VARIANTS = {
    0: "clusters of two 128 x 256 tiles sharing w_q's, one block an SM",
    1: "split K: 128 x 128 tiles, a cluster of blocks along K",
    2: "f32 only: 128-wide tiles, two blocks an SM, the epilogue in series",
}
INT8_GEMM_PAIR, INT8_GEMM_SPLIT, INT8_GEMM_SERIAL = range(3)
INT8_GEMM_F32_ONLY = (INT8_GEMM_SERIAL,)  # variants without a bf16 form
INT8_GEMM_MAX_SPLITS = 8  # blocks of a split-K cluster (the portable most)
INT8_GEMM_SMS = 132  # an H100 SXM's SMs: the wave split K fills
INT8_GEMM_BM, INT8_GEMM_BK = 128, 128  # a tile's rows, a K tile's bytes


class Int8GemmConfig(NamedTuple):
    """What G1 launches for a product: `variant` (INT8_GEMM_VARIANTS),
    `splits` (the split-K variant's blocks a tile along K, else 1) and
    `cluster` (the blocks of a thread-block cluster: 2 along M where two
    blocks share w_q's tile, `splits` along K, else 1)."""
    variant: int
    splits: int
    cluster: int


def int8_gemm_config(m: int, n: int, k: int, f32: bool = False,
                     residual: bool = False) -> Int8GemmConfig:
    """The variant G1 launches for x_q [m, k] times w_q [n, k]^T into f32
    (else bf16), with or without a residual: what measured fastest on an
    H100 at EVA-g's shapes (chip_smoke.py --time-int8-gemm, PERF.md).
    Where at least two blocks a 128 x 128 tile still fit one wave of the
    card's SMs, K is split across a cluster of that many (at most 8, at
    most one a 128-byte K tile): the head's 128 class-token rows, a row or
    a frame. Otherwise f32 with a residual takes 128-wide tiles two blocks
    an SM, whose epilogues overlap each other's products; every other
    product clusters of two 128 x 256 tiles that share w_q's."""
    tiles = -(-m // INT8_GEMM_BM) * -(-n // 128)
    splits = min(INT8_GEMM_MAX_SPLITS, -(-k // INT8_GEMM_BK),
                 INT8_GEMM_SMS // tiles)
    if splits >= 2:
        return Int8GemmConfig(INT8_GEMM_SPLIT, splits, splits)
    if f32 and residual:
        return Int8GemmConfig(INT8_GEMM_SERIAL, 1, 1)
    return Int8GemmConfig(INT8_GEMM_PAIR, 1, 2)


def int8_gemm_split_ranges(k: int, splits: int) -> list:
    """The [k0, k1) column ranges of K the split-K variant's blocks sum, in
    cluster rank order: K's 128-byte tiles dealt out as evenly as the
    kernel deals them (rank r takes tiles r T / s to (r + 1) T / s)."""
    k_tiles = -(-k // INT8_GEMM_BK)
    if not 1 <= splits <= min(INT8_GEMM_MAX_SPLITS, k_tiles):
        raise ValueError(f"split K takes 1 to {INT8_GEMM_MAX_SPLITS} blocks "
                         f"and at most one a K tile ({k_tiles}), got "
                         f"{splits}")
    return [(r * k_tiles // splits * INT8_GEMM_BK,
             min((r + 1) * k_tiles // splits * INT8_GEMM_BK, k))
            for r in range(splits)]


def _gemm_fn():
    fn = build.load("int8_gemm").hirest_int8_gemm
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_longlong] + [
        ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def int8_gemm_info() -> dict:
    """Each G1 variant's dynamic shared memory a block, ring stages,
    blocks a cluster and blocks the card holds at once (0 for the split-K
    variant, which is not persistent), by (variant, output dtype name)."""
    lib = build.load("int8_gemm")
    fn = lib.hirest_int8_gemm_info
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = {}
    for v in INT8_GEMM_VARIANTS:
        for name in ("bfloat16", "float32"):
            if name == "bfloat16" and v in INT8_GEMM_F32_ONLY:
                continue
            info = (ctypes.c_int * 4)()
            build.check(lib, fn(v, int(name == "float32"), info),
                        f"int8_gemm info, variant {v}")
            out[v, name] = dict(zip(("smem", "stages", "cluster",
                                     "resident"), info))
    return out


def _int8_gemm_launch(x_q, x_s, w_q, w_s, bias, out_dtype, residual=None,
                      config=None):
    """G1 on CUDA tensors, as int8_mm_ref, in `config` (an Int8GemmConfig,
    or a variant number: the split-K variant then takes
    int8_gemm_config's splits, or 2 where that is not split) or
    int8_gemm_config's; checks its operands, counts nothing."""
    _require_cuda(x_q)
    if x_q.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise TypeError(f"G1 takes int8 operands, got {x_q.dtype} and "
                        f"{w_q.dtype}")
    if w_q.device != x_q.device:
        raise ValueError(f"w_q on {w_q.device}, x_q on {x_q.device}")
    m, n, k = int8_gemm_shape(out_dtype, x_q.shape, w_q.shape, x_q.stride(),
                              w_q.stride(), x_q.data_ptr() % 16 == 0
                              and w_q.data_ptr() % 16 == 0)
    dev = x_q.device
    xs = _f32_vector(x_s, m, dev)
    ws = _f32_vector(w_s, n, dev)
    b = None if bias is None else _f32_vector(bias, n, dev)
    if residual is not None:
        _check_operands("int8_mm", dev,
                        residual=(residual, (m, n), out_dtype))
    out = torch.empty((m, n), dtype=out_dtype, device=dev)
    f32 = out_dtype == torch.float32
    chosen = int8_gemm_config(m, n, k, f32, residual is not None)
    if config is None:
        config = chosen
    elif isinstance(config, int):
        splits = (chosen.splits if chosen.variant == INT8_GEMM_SPLIT
                  else min(2, -(-k // INT8_GEMM_BK)))
        config = Int8GemmConfig(config, splits, 1)
    if config.variant in INT8_GEMM_F32_ONLY and not f32:
        raise TypeError(f"G1's variant {config.variant} has no bf16 form")
    ldx = x_q.stride(0) if m > 1 else k
    with torch.cuda.device(dev):
        err = _gemm_fn()(
            x_q.data_ptr(), ldx, xs.data_ptr(), w_q.data_ptr(),
            w_q.stride(0), ws.data_ptr(), None if b is None else b.data_ptr(),
            None if residual is None else residual.data_ptr(),
            out.data_ptr(), m, n, k, int(f32), config.variant,
            config.splits, torch.cuda.current_stream().cuda_stream)
    build.check(build.load("int8_gemm"), err,
                f"int8_mm{' f32' if f32 else ''} launch")
    return out


def int8_mm(x_q, x_s, w_q, w_s, bias, out_dtype, residual=None):
    """x_q [M, in] int8 with row scales x_s [M, 1], w_q [out, in] int8 with
    channel scales w_s [out] -> (f32(x_q w_q^T) * x_s) * w_s + bias, cast
    to out_dtype (eva_scan._int8_mm), or residual + that in out_dtype.

    A CPU tensor takes the plain version (`int8_mm_ref`). A CUDA call
    takes the operands as `int8_gemm_shape` says and the residual
    contiguous and 16-byte aligned, and launches G1: the exact int32
    product on wgmma and E3's arithmetic in its epilogue, bf16 or f32 out;
    anything else raises. `int8_mm.launches` counts bf16-out launches,
    `.launches_f32` f32 ones."""
    if x_q.device.type == "cpu":
        return int8_mm_ref(x_q, x_s, w_q, w_s, bias, out_dtype, residual)
    out = _int8_gemm_launch(x_q, x_s, w_q, w_s, bias, out_dtype, residual)
    _count(int8_mm, out_dtype == torch.float32)
    return out


int8_mm.launches = 0
int8_mm.launches_f32 = 0


def int8_matmul(x: torch.Tensor, w_q: torch.Tensor, w_s: torch.Tensor,
                bias=None, out_dtype=torch.bfloat16) -> torch.Tensor:
    """x [..., in] float -> [..., out] (hirest_tpu/ops/quant.py::
    int8_matmul): x quantized per row from f32 by E4 (`row_quant`), then
    the int8 x int8 -> int32 product and its epilogue (acc * x_s * w_s +
    bias in f32, then the cast) in G1 (`int8_mm`). w_q [out, in'] with
    in' >= in: the weight's input axis may be zero-padded (QuantDense pads
    it to a multiple of INT8_GEMM_K_MULTIPLE); E4 writes x's codes that
    wide, with zeros past x's. Zero codes add nothing to an int32 sum, so
    the padding changes no number. A CPU tensor takes both plain versions;
    on CUDA a shape either kernel does not take raises."""
    shape = x.shape
    x_q, x_s = row_quant(x.reshape(-1, shape[-1]), ldq=w_q.shape[1])
    out = int8_mm(x_q, x_s, w_q, w_s, bias, out_dtype)
    return out.view(*shape[:-1], w_q.shape[0])


class QuantDense:
    """An int8 stand-in for a float Linear (hirest_tpu/ops/quant.py::
    QuantDense), callable on activations: the weight [out, in] quantized
    per output channel once, its input axis zero-padded to a multiple of
    INT8_GEMM_K_MULTIPLE (exact: see int8_matmul), the bias kept in
    f32."""

    def __init__(self, weight: torch.Tensor, bias=None,
                 out_dtype=torch.bfloat16):
        w_q, self.w_s = quantize_weight(weight)
        pad = -w_q.shape[1] % INT8_GEMM_K_MULTIPLE
        self.w_q = F.pad(w_q, (0, pad)) if pad else w_q
        self.bias = None if bias is None else bias.float()
        self.out_dtype = out_dtype

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return int8_matmul(x, self.w_q, self.w_s, self.bias, self.out_dtype)


# --- K2 and K10: LayerNorm, quantized per row or written back -------------


def _ln_f32(x, weight, bias, eps: float):
    """eva_scan._ln's arithmetic, kept in f32: two-pass mean and variance of
    x [..., C], then (x - mean) * rsqrt(var + eps) * weight + bias."""
    x32 = x.float()
    xc = x32 - x32.mean(-1, keepdim=True)
    var = (xc * xc).mean(-1, keepdim=True)
    return xc * torch.rsqrt(var + eps) * weight.float() + bias.float()


def ln_quant_ref(x, weight, bias, eps: float):
    """Plain version of K2: f32 two-pass LayerNorm of x [..., C], kept in
    f32 into the row quantization -> (q int8 like x, s f32 [..., 1])."""
    return _scale_and_codes(_ln_f32(x, weight, bias, eps))


def ln_bf16_ref(x, weight, bias, eps: float):
    """Plain version of K10: the f32 two-pass LayerNorm of x [..., C] cast
    to x's dtype, eva_scan._ln exactly."""
    return _ln_f32(x, weight, bias, eps).to(x.dtype)


def _ln_fn(entry: str, n_outputs: int):
    fn = getattr(build.load("ln_quant"), entry)
    fn.argtypes = [ctypes.c_void_p] * (3 + n_outputs) + [
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def row_kernel_shape(what: str, dtype, shape, contiguous: bool = True,
                     aligned: bool = True) -> tuple:
    """(M, C): the rows a tensor [..., C] of `dtype` and `shape` makes for
    the row kernel `what` ("ln_quant", "ln_bf16" or "act_quant"), or raises:
    TypeError unless the kernel has a form for dtype (ROW_KERNELS) and the
    tensor is at least 2-d, contiguous and 16-byte aligned; ValueError
    unless C is a multiple of the form's and at most its widest. Needs no
    GPU: the CUDA wrappers check their input through it."""
    forms = ROW_KERNELS[what]
    if (dtype not in forms or len(shape) < 2 or not contiguous
            or not aligned):
        raise TypeError(
            f"{what}'s kernels take contiguous, 16-byte aligned "
            f"{' or '.join(str(d) for d in forms)} [..., C], got {dtype} "
            f"{tuple(shape)}, contiguous={contiguous}, aligned={aligned}")
    multiple, widest = forms[dtype]
    c = shape[-1]
    if c % multiple or c > widest:
        raise ValueError(f"{what}'s {dtype} kernel takes C % {multiple} == 0 "
                         f"and C <= {widest}, got {c}")
    return math.prod(shape[:-1]), c


def _rows(x, what: str) -> torch.Tensor:
    """x [..., C] on CUDA as the [M, C] rows its row kernel takes
    (row_kernel_shape)."""
    _require_cuda(x)
    return x.view(*row_kernel_shape(what, x.dtype, x.shape, x.is_contiguous(),
                                    x.data_ptr() % 16 == 0))


def _count(fn, f32: bool) -> None:
    """One launch more on fn's count of its dtype's form."""
    attr = "launches_f32" if f32 else "launches"
    setattr(fn, attr, getattr(fn, attr) + 1)


def ln_quant(x, weight, bias, eps: float):
    """LayerNorm + per-row int8 quantization of x [..., C] -> (q int8 like
    x, s f32 [..., 1]); weight and bias [C] are applied in f32.

    A CPU tensor takes the plain version. A CUDA tensor must be contiguous,
    16-byte aligned bf16 with C a multiple of 8 up to 2048, and launches
    the kernel, or f32 with C a multiple of 4 up to 2048, which launches
    its f32 form (a warp a row, the same arithmetic); anything else raises.
    `ln_quant.launches` counts bf16 launches, `.launches_f32` f32 ones."""
    if x.device.type == "cpu":
        return ln_quant_ref(x, weight, bias, eps)
    rows = _rows(x, "ln_quant")
    m, c = rows.shape
    f32 = x.dtype == torch.float32
    g, b = _f32_vector(weight, c, x.device), _f32_vector(bias, c, x.device)
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    s = torch.empty((*x.shape[:-1], 1), dtype=torch.float32, device=x.device)
    fn = _ln_fn("hirest_ln_quant_f32" if f32 else "hirest_ln_quant", 2)
    with torch.cuda.device(x.device):
        err = fn(rows.data_ptr(), g.data_ptr(), b.data_ptr(), q.data_ptr(),
                 s.data_ptr(), m, c, eps,
                 torch.cuda.current_stream().cuda_stream)
    build.check(build.load("ln_quant"), err,
                f"ln_quant{' f32' if f32 else ''} launch")
    _count(ln_quant, f32)
    return q, s


def ln_bf16(x, weight, bias, eps: float):
    """LayerNorm of x [..., C] in f32, written back in x's dtype (the
    trunk's `fused_ln`); weight and bias [C] are applied in f32.

    A CPU tensor takes the plain version. A CUDA tensor must be contiguous,
    16-byte aligned bf16 with C a multiple of 8 up to 2048, and launches
    the kernel, or f32 with C a multiple of 4 up to 2048, which launches
    its f32 form (a warp a row, the same arithmetic, f32 out); anything
    else raises. `ln_bf16.launches` counts bf16 launches, `.launches_f32`
    f32 ones."""
    if x.device.type == "cpu":
        return ln_bf16_ref(x, weight, bias, eps)
    rows = _rows(x, "ln_bf16")
    m, c = rows.shape
    f32 = x.dtype == torch.float32
    g, b = _f32_vector(weight, c, x.device), _f32_vector(bias, c, x.device)
    y = torch.empty_like(x)
    fn = _ln_fn("hirest_ln_f32" if f32 else "hirest_ln_bf16", 1)
    with torch.cuda.device(x.device):
        err = fn(rows.data_ptr(), g.data_ptr(), b.data_ptr(), y.data_ptr(),
                 m, c, eps, torch.cuda.current_stream().cuda_stream)
    build.check(build.load("ln_quant"), err,
                f"ln_bf16{' f32' if f32 else ''} launch")
    _count(ln_bf16, f32)
    return y


ln_quant.launches = 0
ln_quant.launches_f32 = 0
ln_bf16.launches = 0
ln_bf16.launches_f32 = 0


# --- K5: optional activation + per-row int8 quantization -----------------


def act_quant_ref(x, *, act: str = "none"):
    """Plain version of K5: act ("gelu_poly", "gelu" or "none") of x
    [..., C] in f32, then per-row int8 -> (codes shaped like x, f32 scales
    [..., 1])."""
    return _scale_and_codes(_act(act, QUANT_ACTS)(x.float()))


def _act_quant_fn(entry: str):
    fn = getattr(build.load("act_quant"), entry)
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def act_quant(x, *, act: str = "none"):
    """Optional GELU and per-row int8 quantization of x [..., C] ->
    (q int8 like x, s f32 [..., 1]), q * s ~= act(x); act is "gelu_poly"
    (gelu_bf16_poly), "gelu" (exact erf) or "none".

    A CPU tensor takes the plain version. A CUDA tensor must be contiguous,
    16-byte aligned bf16 with C a multiple of 16 up to 8192, and launches
    the kernel, or f32 with C a multiple of 4 up to 8192, which launches
    its f32 form (a warp or warpgroup a row, IEEE divisions); anything else
    raises. `act_quant.launches` counts bf16 launches, `.launches_f32` f32
    ones."""
    if x.device.type == "cpu":
        return act_quant_ref(x, act=act)
    _act(act, QUANT_ACTS)
    m, c = _rows(x, "act_quant").shape
    f32 = x.dtype == torch.float32
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    s = torch.empty((*x.shape[:-1], 1), dtype=torch.float32, device=x.device)
    fn = _act_quant_fn("hirest_act_quant_f32" if f32 else "hirest_act_quant")
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), q.data_ptr(), s.data_ptr(), m, c,
                 QUANT_ACTS[act], torch.cuda.current_stream().cuda_stream)
    build.check(build.load("act_quant"), err,
                f"act_quant{' f32' if f32 else ''} launch")
    _count(act_quant, f32)
    return q, s


act_quant.launches = 0
act_quant.launches_f32 = 0


# --- K4: fc1 -> act -> per-(row, chunk) requant -> fc2 -> + residual ------


def _act(name: str, acts=ACTS):
    if name not in acts:
        raise ValueError(f"act must be one of {sorted(acts)}, got {name!r}")
    if name == "none":
        return lambda y: y
    return gelu_bf16_poly if name == "gelu_poly" else (
        lambda y: F.gelu(y, approximate="none"))


def _chunk(f: int, n_chunk: int) -> int:
    nc = min(n_chunk, f)
    if f % nc:
        raise ValueError(f"mlp_hidden {f} is not a multiple of the "
                         f"{nc}-unit requant chunk")
    return nc


def mlp_int8_hidden_ref(h_q, h_s, w1_q, w1_s, b1, *, act: str = "gelu_poly",
                        n_chunk: int = N_CHUNK):
    """Plain version of K4's first kernel: the hidden units' int8 codes.

    h_q [M, C] int8, h_s [M, 1] f32; w1_q [F, C] int8, w1_s/b1 [F]. For
    each n_chunk-wide slice of the F hidden units, y = act((f32(h_q w1^T)
    * h_s) * s1 + b1) in f32, requantized per (row, chunk). Returns
    (codes [M, F] int8, scales [M, F / n_chunk] f32). On a CUDA tensor
    h_q's rows are zero-padded to the 17 `torch._int_mm` takes there and
    the products cut back."""
    act_fn = _act(act)
    f = w1_q.shape[0]
    nc = _chunk(f, n_chunk)
    m = h_q.shape[0]
    if h_q.device.type == "cuda" and m < _INT_MM_MIN_ROWS:
        h_q = F.pad(h_q, (0, 0, 0, _INT_MM_MIN_ROWS - m))
    codes, scales = [], []
    for j in range(0, f, nc):
        y = torch._int_mm(h_q, w1_q[j:j + nc].t())[:m].float()
        y.mul_(h_s).mul_(w1_s[j:j + nc].float()).add_(b1[j:j + nc].float())
        q2, sc = _scale_and_codes(act_fn(y))
        codes.append(q2)
        scales.append(sc)
    return torch.cat(codes, 1), torch.cat(scales, 1)


def mlp_int8_out_ref(codes, scales, w2_q, w2_s, b2, x_res):
    """Plain version of K4's second kernel: fc2 over the hidden codes.

    codes [M, F] int8 and scales [M, F / nc] f32 from mlp_int8_hidden_ref;
    w2_q [C, F] int8, w2_s/b2 [C]; x_res [M, C]. With part_j = (f32(q2_j
    w2_j^T) * sc_j) * s2 for each nc-wide chunk j: acc = (x + b2) + part_0
    on the first chunk, acc += part_j after. Returns acc cast once to
    x_res's dtype."""
    nc = codes.shape[1] // scales.shape[1]
    acc = None
    for c, j in enumerate(range(0, codes.shape[1], nc)):
        part = torch._int_mm(codes[:, j:j + nc].contiguous(),
                             w2_q[:, j:j + nc].t()).float()
        part.mul_(scales[:, c:c + 1]).mul_(w2_s.float())
        if acc is None:
            acc = (x_res.float() + b2.float()).add_(part)
        else:
            acc.add_(part)
    return acc.to(x_res.dtype)


def fused_mlp_int8_ref(h_q, h_s, w1_q, w1_s, b1, w2_q, w2_s, b2, x_res, *,
                       act: str = "gelu_poly", n_chunk: int = N_CHUNK):
    """Plain version of K4 (hirest_tpu/ops/quant.py::_fused_mlp_kernel):
    mlp_int8_out_ref over mlp_int8_hidden_ref, arguments as theirs.

    For each n_chunk-wide slice of the F hidden units: y = act((f32(h_q
    w1^T) * h_s) * s1 + b1) in f32, requantized per (row, chunk), and part
    = f32(q2 w2^T) * sc; acc = (x + b2) + part * s2 on the first chunk,
    acc += part * s2 after. Returns acc cast once to x_res's dtype."""
    codes, scales = mlp_int8_hidden_ref(h_q, h_s, w1_q, w1_s, b1, act=act,
                                        n_chunk=n_chunk)
    return mlp_int8_out_ref(codes, scales, w2_q, w2_s, b2, x_res)


def _mlp_fn(entry: str, n_pointers: int, n_ints: int):
    fn = getattr(build.load("fused_mlp_int8"), entry)
    fn.argtypes = [ctypes.c_void_p] * n_pointers + [ctypes.c_int] * n_ints + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_operands(what: str, device, **operands) -> None:
    """Each operand (tensor, shape, dtype) must be a contiguous tensor of
    that shape and dtype on device, 16-byte aligned (TMA reads it)."""
    for name, (t, shape, dtype) in operands.items():
        if (tuple(t.shape) != shape or t.dtype != dtype
                or not t.is_contiguous() or t.device != device
                or t.data_ptr() % 16):
            raise TypeError(f"{what}'s kernel takes {name} as contiguous, "
                            f"16-byte aligned {dtype} {shape} on {device}, "
                            f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def _mlp_hidden_launch(h_q, h_s, w1_q, w1_s, b1, act: str):
    """K4's first kernel on CUDA tensors -> (codes [M, F] int8, scales
    [M, F / 1024] f32), as mlp_int8_hidden_ref; checks its operands."""
    _require_cuda(h_q)
    _act(act)
    m, c = h_q.shape
    f = w1_q.shape[0]
    nc = _chunk(f, N_CHUNK)
    if c != KERNEL_WIDTH or nc != N_CHUNK:
        raise ValueError(f"fused_mlp_int8's kernel is built for C = "
                         f"{KERNEL_WIDTH} and {N_CHUNK}-unit chunks, got "
                         f"C = {c}, chunk {nc}")
    dev = h_q.device
    _check_operands("fused_mlp_int8", dev,
                    h_q=(h_q, (m, c), torch.int8),
                    h_s=(h_s, (m, 1), torch.float32),
                    w1_q=(w1_q, (f, c), torch.int8))
    s1, bb1 = _f32_vector(w1_s, f, dev), _f32_vector(b1, f, dev)
    codes = torch.empty((m, f), dtype=torch.int8, device=dev)
    scales = torch.empty((m, f // nc), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _mlp_fn("hirest_mlp_int8_hidden", 7, 3)(
            h_q.data_ptr(), h_s.data_ptr(), w1_q.data_ptr(), s1.data_ptr(),
            bb1.data_ptr(), codes.data_ptr(), scales.data_ptr(), m, f,
            ACTS[act], torch.cuda.current_stream().cuda_stream)
    build.check(build.load("fused_mlp_int8"), err, "mlp_int8_hidden launch")
    return codes, scales


def _mlp_out_launch(codes, scales, w2_q, w2_s, b2, x_res):
    """K4's second kernel on CUDA tensors -> out [M, C] in x_res's dtype
    (bf16, or f32: the f32 int8 factory's), as mlp_int8_out_ref; checks
    its operands."""
    _require_cuda(codes)
    m, f = codes.shape
    c = KERNEL_WIDTH
    dev = codes.device
    _check_operands("fused_mlp_int8", dev,
                    codes=(codes, (m, f), torch.int8),
                    scales=(scales, (m, f // N_CHUNK), torch.float32),
                    w2_q=(w2_q, (c, f), torch.int8),
                    x_res=(x_res, (m, c), _residual_dtype(x_res)))
    s2, bb2 = _f32_vector(w2_s, c, dev), _f32_vector(b2, c, dev)
    out = torch.empty_like(x_res)
    entry = ("hirest_mlp_int8_out_f32" if x_res.dtype == torch.float32
             else "hirest_mlp_int8_out")
    with torch.cuda.device(dev):
        err = _mlp_fn(entry, 7, 2)(
            codes.data_ptr(), scales.data_ptr(), w2_q.data_ptr(),
            s2.data_ptr(), bb2.data_ptr(), x_res.data_ptr(), out.data_ptr(),
            m, f, torch.cuda.current_stream().cuda_stream)
    build.check(build.load("fused_mlp_int8"), err, "mlp_int8_out launch")
    return out


def fused_mlp_int8(h_q, h_s, w1_q, w1_s, b1, w2_q, w2_s, b2, x_res, *,
                   act: str = "gelu_poly"):
    """x_res + fc2(requant(act(fc1(h)))) for the int8 trunk, with 1024-unit
    requant chunks; arguments as in fused_mlp_int8_ref.

    A CPU tensor takes the plain version. A CUDA call launches K4's two
    kernels, which are built for the EVA-g trunk: C = 1408, F a multiple
    of the 1024-unit chunk, contiguous 16-byte aligned int8 codes, f32
    scales and biases, bf16 or f32 x_res (the second kernel reads and
    writes it in its dtype); anything else raises. The first writes the
    hidden units' int8 codes and per-chunk scales, the second folds fc2
    over them. `fused_mlp_int8.launches` counts calls with bf16 x_res,
    `.launches_f32` with f32 x_res, each of which launches both."""
    if h_q.device.type == "cpu":
        return fused_mlp_int8_ref(h_q, h_s, w1_q, w1_s, b1, w2_q, w2_s, b2,
                                  x_res, act=act)
    _require_cuda(h_q)
    m, c = h_q.shape
    _check_operands("fused_mlp_int8", h_q.device,
                    w2_q=(w2_q, (c, w1_q.shape[0]), torch.int8),
                    x_res=(x_res, (m, c), _residual_dtype(x_res)))
    codes, scales = _mlp_hidden_launch(h_q, h_s, w1_q, w1_s, b1, act)
    out = _mlp_out_launch(codes, scales, w2_q, w2_s, b2, x_res)
    if x_res.dtype == torch.float32:
        fused_mlp_int8.launches_f32 += 1
    else:
        fused_mlp_int8.launches += 1
    return out


def _residual_dtype(x_res) -> torch.dtype:
    """The dtype K4 takes x_res in: its own where it is f32, else bf16."""
    return torch.float32 if x_res.dtype == torch.float32 else torch.bfloat16


fused_mlp_int8.launches = 0
fused_mlp_int8.launches_f32 = 0


def mlp_int8_smem_bytes() -> dict:
    """Dynamic shared memory a block of each of K4's kernels asks for."""
    fn = build.load("fused_mlp_int8").hirest_mlp_int8_smem_bytes
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_int
    return {"mlp_hidden": fn(0), "mlp_out": fn(1)}


def _require_cuda(t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"no kernel for device {t.device}")


def _f32_vector(v: torch.Tensor, n: int, device) -> torch.Tensor:
    """v as a contiguous f32 [n] on device (a no-op for the int8 tower's
    own buffers, which are kept that way)."""
    if v.numel() != n:
        raise ValueError(f"expected {n} values, got {tuple(v.shape)}")
    return v.reshape(n).to(device=device, dtype=torch.float32).contiguous()
