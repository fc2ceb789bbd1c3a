"""Attention kernels of the EVA vision towers.

Counterparts of hirest_tpu/ops/attention.py:

- `fused_attention_qkv3` (v3), with its pad-key mask (n_real) and its int8
  epilogue (quant_out): the production scanned trunk. It launches the CUDA
  kernel `csrc/attention_qkv3.cu` on a CUDA tensor (K and V through a TMA
  ring, QK^T and PV on wgmma): K1 for bf16 output, K3 for int8 codes and
  row scales. At 16 heads K3 quantizes inside the kernel, the heads of a
  row on the blocks of one thread-block cluster (`qkv3_route`); at other
  head counts it takes the two-step epilogue (an f32 workspace, then a
  second kernel).
- `fused_attention_qkv2` (v2, K9): the same function, which the TPU kernel
  computes one head at a time. That loop is TPU scheduling, so it launches
  the same CUDA kernel, under its own launch counts.
- `fused_attention_qkv` (v1, K8): the scanned trunk's default, on the fused
  qkv projection with the q/v biases added in the kernel, bf16 out or int8
  (quant_out).
- `fused_attention` (`_pallas_attention`, K6) over split heads
  [B, H, S, D] and `fused_attention_packed` (`_pallas_attention_packed`,
  K7) over packed [B, S, H*D]: the unrolled tower, at the native and the
  padded head width.

K6, K7 and K8 launch the v1 form of the same kernel: q, k and v as
[B, H, S, D] views of any strides the TMA maps take (`_tma_view` copies
any other), so the head views cost no copy; K and V through the same TMA
ring, any number of keys; K6/K7's key mask, and K8's biases (q's added to
its fragments, v's to each landed V tile) and int8 epilogue (at 16 heads
the cluster epilogue, as K3's), each an instantiation of its own
(`v1_route`). Each wrapper takes its plain PyTorch version (`*_ref`)
only for a tensor on the CPU. Their softmaxes differ, as the TPU kernels'
do: v2 and v3 round the unnormalised exp2 probabilities to the input dtype
and divide after PV; K6, K7 and K8 scale the f32 scores, normalise p in
f32 and then round it.

Those kernels take bf16. A float32 CUDA tensor (the JAX kernels compute in
the dtype they are given, and the CLIP towers and the f32 EVA factory hand
them f32) goes to `csrc/attention_f32.cu`, one f32 body for every bf16-out
form (K1/K9 on views of the pre-biased qkv, n_real as the number of keys;
K6/K7 with the key mask; K8 with the biases), counted apart in each
wrapper's `launches_f32`. It takes its products on the tensor cores in
3xTF32 (each f32 operand split into two tf32 halves, three wgmma products
into one f32 sum) on tiles loaded by TMA, and its softmax in f32. In f32
the two softmax forms differ only in the order of roundings. The int8-out
forms (K3, K8 and K9 with quant_out) take the same body with the int8
epilogue of the bf16 kernels (an f32 workspace, each row's max |y| by
atomicMax, then the codes and row scales), counted in
`quant_launches_f32`.
"""

from __future__ import annotations

import ctypes

import torch

from hirest_tpu_torch.models.layers import merge_heads, split_heads
from hirest_tpu_torch.ops import build
from hirest_tpu_torch.ops.quant import dyn_quant_rows_ref

LOG2E = 1.4426950408889634
QKV3_HEAD_WIDTHS = (88, 128)  # head widths attention_qkv3.cu is built for
QKV3_CLUSTER_HEADS = 16  # the head count of K3's cluster epilogue
QKV3_TWO_STEP = ("-DHIREST_QKV3_TWO_STEP=1",)  # the two-step-only build
# head widths of the v1 form (K6, K7, K8) and of attention_f32.cu
SPLIT_HEAD_WIDTHS = (64, 88, 128)


def qkv3_route(num_heads: int, quant_out: bool) -> str:
    """Which of attention_qkv3.cu's epilogues a call with num_heads heads
    takes: "bf16" (K1, bf16 out); with quant_out "cluster" (K3's int8
    epilogue inside the kernel, the heads of a row on the blocks of one
    thread-block cluster) at QKV3_CLUSTER_HEADS heads, else "two_step"
    (an f32 workspace, each row's max by atomicMax, a second kernel)."""
    if not quant_out:
        return "bf16"
    return "cluster" if num_heads == QKV3_CLUSTER_HEADS else "two_step"


def v1_route(num_heads: int, *, masked: bool = False, biased: bool = False,
             quant_out: bool = False) -> str:
    """Which instantiation of attention_qkv3.cu's v1 form a bf16 call
    takes: K6/K7 "v1", or with a key mask "v1 masked"; K8 (the q/v biases)
    "v1 biased", and with quant_out "v1 biased cluster" at
    QKV3_CLUSTER_HEADS heads, else "v1 biased two_step" (`qkv3_route`'s
    epilogues). Raises ValueError for what no instantiation takes: a key
    mask with the biases (K8 takes none), int8 out without them (K6 and
    K7 write bf16)."""
    if masked and biased:
        raise ValueError("the v1 form takes a key mask or the q/v biases, "
                         "not both")
    if quant_out and not biased:
        raise ValueError("int8 out is K8's form: it takes the q/v biases")
    if biased:
        return "v1 biased" + (f" {qkv3_route(num_heads, True)}"
                              if quant_out else "")
    return "v1 masked" if masked else "v1"


def qkv3_shape(dtype, shape, num_heads: int, quant_out: bool,
               contiguous: bool = True, aligned: bool = True) -> str:
    """The epilogue (`qkv3_route`) that attention_qkv3.cu runs for bias-
    complete qkv `shape` [B, S, 3*H*d] of dtype with num_heads heads, or
    raises: ValueError unless qkv is 3-d with a last dim 3 * num_heads * d,
    d in QKV3_HEAD_WIDTHS, contiguous and 16-byte aligned; TypeError unless
    bf16. Needs no GPU: the CUDA wrappers check their input through it."""
    if len(shape) != 3:
        raise ValueError(f"expected [B, S, 3*H*d], got {tuple(shape)}")
    d = _split(shape, num_heads)[3]
    if dtype != torch.bfloat16:
        raise TypeError(f"the CUDA kernel takes bfloat16, got {dtype}")
    if d not in QKV3_HEAD_WIDTHS:
        raise ValueError(f"the CUDA kernel is built for head widths "
                         f"{QKV3_HEAD_WIDTHS}, got {d}")
    if not contiguous or not aligned:
        raise ValueError("qkv must be contiguous and 16-byte aligned")
    return qkv3_route(num_heads, quant_out)


def _split(shape, num_heads: int):
    b, s, three_hd = shape
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
    b, s, hd, d = _split(qkv_biased.shape, num_heads)
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
        return dyn_quant_rows_ref(o)
    return o.to(qkv_biased.dtype)


def _on_cuda(x: torch.Tensor) -> bool:
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"no attention kernel for device {x.device}")
    return True


def _kernel_lib(defines: tuple[str, ...] = ()) -> ctypes.CDLL:
    lib = build.load("attention_qkv3", defines)
    ints = [ctypes.c_int] * 5  # B, S, H, D, n_keys
    lib.hirest_attention_qkv3_bf16.argtypes = (
        [ctypes.c_void_p] * 2 + ints + [ctypes.c_float, ctypes.c_void_p])
    lib.hirest_attention_qkv3_quant.argtypes = (
        [ctypes.c_void_p] * 5 + ints + [ctypes.c_float, ctypes.c_int,
                                        ctypes.c_void_p])
    heads = [ctypes.c_int] * 5  # B, H, Sq, Sk, D
    strides = [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float]
    lib.hirest_attention_v1.argtypes = (
        [ctypes.c_void_p] * 7 + heads + strides + [ctypes.c_void_p])
    lib.hirest_attention_v1_quant.argtypes = (
        [ctypes.c_void_p] * 9 + heads + strides + [ctypes.c_int,
                                                   ctypes.c_void_p])
    lib.hirest_attention_qkv3_cluster_info.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    for fn in (lib.hirest_attention_qkv3_bf16,
               lib.hirest_attention_qkv3_quant, lib.hirest_attention_v1,
               lib.hirest_attention_v1_quant,
               lib.hirest_attention_qkv3_cluster_info):
        fn.restype = ctypes.c_int
    return lib


def qkv3_cluster_info(d: int, v1: bool = False) -> dict:
    """The int8 cluster epilogue on this card at head width d, of K3 or
    (v1) of K8's form: the clusters of 16 and of 8 blocks it holds at once
    (cudaOccupancyMaxActiveClusters), and the heads a block the launch
    takes (1: clusters of 16, 2: clusters of 8)."""
    lib = _kernel_lib()
    info = (ctypes.c_int * 3)()
    build.check(lib, lib.hirest_attention_qkv3_cluster_info(d, int(v1),
                                                            info),
                "attention_qkv3 cluster info")
    return {"clusters_of_16": info[0], "clusters_of_8": info[1],
            "heads_per_block": info[2]}


def _count_f32(wrapper, quant_out: bool) -> None:
    if quant_out:
        wrapper.quant_launches_f32 += 1
    else:
        wrapper.launches_f32 += 1


def _launch_qkv3(qkv_biased: torch.Tensor, scale: float, num_heads: int,
                 quant_out: bool, n_real: int, two_step: bool = False,
                 heads_per_block: int = 0):
    """Launch attention_qkv3.cu on bias-complete [B, S, 3*H*d] qkv, int8
    out by the epilogue `qkv3_shape` names: the cluster epilogue (no
    scratch; heads_per_block 1 or 2 forces a variant, 0 takes the card's
    rule), or the two-step one with its workspace. two_step: the library
    built with -DHIREST_QKV3_TWO_STEP=1, whose every int8 call is two-step
    (chip_smoke.py's yardstick of the cluster epilogue)."""
    route = qkv3_shape(qkv_biased.dtype, qkv_biased.shape, num_heads,
                       quant_out, qkv_biased.is_contiguous(),
                       qkv_biased.data_ptr() % 16 == 0)
    if n_real < 0:
        raise ValueError(f"n_real must be >= 0, got {n_real}")
    if two_step and route == "cluster":
        route = "two_step"
    if heads_per_block and route != "cluster":
        raise ValueError(f"heads_per_block={heads_per_block} asks for the "
                         f"cluster epilogue, which this call does not take")
    b, s, hd, d = _split(qkv_biased.shape, num_heads)
    n_keys = min(n_real, s) if n_real else s
    dev = qkv_biased.device
    lib = _kernel_lib(QKV3_TWO_STEP if two_step else ())
    c = scale * LOG2E
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        if quant_out:
            ws = rowmax = None
            if route == "two_step":
                ws = torch.empty((b, s, hd), dtype=torch.float32, device=dev)
                rowmax = torch.empty((b, s), dtype=torch.int32, device=dev)
            q = torch.empty((b, s, hd), dtype=torch.int8, device=dev)
            sc = torch.empty((b, s, 1), dtype=torch.float32, device=dev)
            err = lib.hirest_attention_qkv3_quant(
                qkv_biased.data_ptr(), None if ws is None else ws.data_ptr(),
                None if rowmax is None else rowmax.data_ptr(), q.data_ptr(),
                sc.data_ptr(), b, s, num_heads, d, n_keys, c,
                heads_per_block, stream)
            out = (q, sc)
        else:
            out = torch.empty((b, s, hd), dtype=qkv_biased.dtype, device=dev)
            err = lib.hirest_attention_qkv3_bf16(
                qkv_biased.data_ptr(), out.data_ptr(), b, s, num_heads, d,
                n_keys, c, stream)
    build.check(lib, err, "attention_qkv3 launch")
    return out


def fused_attention_qkv3(qkv_biased: torch.Tensor, scale: float,
                         num_heads: int, *, quant_out: bool = False,
                         n_real: int = 0):
    """Batched-heads attention over [B, S, 3*H*d] fused qkv with the q/v
    biases pre-added -> [B, S, H*d], or with quant_out the int8 codes and
    f32 row scales [B, S, 1] of the f32 output. Keys >= n_real are masked
    when n_real > 0.

    A CPU tensor takes the plain version. A CUDA tensor must be contiguous
    bf16 with head width 88 or 128 (padded heads) and launches the kernel
    on the current stream, or f32 (head width 64, 88 or 128), which
    launches the f32 body; anything else raises.
    `fused_attention_qkv3.launches` counts bf16-out launches (K1),
    `.quant_launches` int8-out ones (K3), `.launches_f32` and
    `.quant_launches_f32` their f32 ones."""
    if not _on_cuda(qkv_biased):
        return fused_attention_qkv3_ref(qkv_biased, scale, num_heads,
                                        quant_out=quant_out, n_real=n_real)
    if qkv_biased.dtype == torch.float32:
        out = _launch_qkv_f32(qkv_biased, scale, num_heads, n_real, quant_out)
        _count_f32(fused_attention_qkv3, quant_out)
        return out
    out = _launch_qkv3(qkv_biased, scale, num_heads, quant_out, n_real)
    if quant_out:
        fused_attention_qkv3.quant_launches += 1
    else:
        fused_attention_qkv3.launches += 1
    return out


fused_attention_qkv3.launches = 0
fused_attention_qkv3.quant_launches = 0
fused_attention_qkv3.launches_f32 = 0
fused_attention_qkv3.quant_launches_f32 = 0


# --- K9: v2, the same function head by head on the TPU --------------------

# K9's TPU kernel computes K1/K3's function, so their plain version is its
fused_attention_qkv2_ref = fused_attention_qkv3_ref


def fused_attention_qkv2(qkv_biased: torch.Tensor, scale: float,
                         num_heads: int, *, quant_out: bool = False,
                         n_real: int = 0):
    """The v2 attention (K9): `fused_attention_qkv3`'s arguments, function
    and conditions. Its TPU kernel walks the heads one at a time where v3
    batches them; that is TPU scheduling, and attention_qkv3.cu already
    walks (batch row, query tile, head) items, so a CUDA tensor launches
    that kernel. `rows_per_cell` (grid cells per launch on the TPU) is not
    carried. A CPU tensor takes the plain version; an f32 CUDA tensor the
    f32 body. `fused_attention_qkv2.launches` counts bf16-out launches,
    `.quant_launches` int8-out ones, `.launches_f32` and
    `.quant_launches_f32` their f32 ones."""
    if not _on_cuda(qkv_biased):
        return fused_attention_qkv2_ref(qkv_biased, scale, num_heads,
                                        quant_out=quant_out, n_real=n_real)
    if qkv_biased.dtype == torch.float32:
        out = _launch_qkv_f32(qkv_biased, scale, num_heads, n_real, quant_out)
        _count_f32(fused_attention_qkv2, quant_out)
        return out
    out = _launch_qkv3(qkv_biased, scale, num_heads, quant_out, n_real)
    if quant_out:
        fused_attention_qkv2.quant_launches += 1
    else:
        fused_attention_qkv2.launches += 1
    return out


fused_attention_qkv2.launches = 0
fused_attention_qkv2.quant_launches = 0
fused_attention_qkv2.launches_f32 = 0
fused_attention_qkv2.quant_launches_f32 = 0


# --- K6 and K7: softmax attention over split or packed heads ---------------


def _softmax_attention_f32(q, k, v, scale: float, key_mask=None):
    """K6's arithmetic up to the f32 PV product: q [B, H, Sq, D], k/v
    [B, H, Sk, D] -> [B, H, Sq, D] f32."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if key_mask is not None:
        valid = (key_mask > 0).to(s.device)[:, None, None, :]
        s = torch.where(valid, s, torch.full_like(s, -1e30))
    e = torch.exp(s - s.amax(-1, keepdim=True))
    p = (e / e.sum(-1, keepdim=True)).to(q.dtype)
    return torch.matmul(p.float(), v.float())


def fused_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: float, key_mask=None) -> torch.Tensor:
    """Plain PyTorch version of `fused_attention`: q [B, H, Sq, D], k/v
    [B, H, Sk, D] -> [B, H, Sq, D] in q's dtype, as the Pallas bodies
    compute it: f32 scores q k^T multiplied by scale, keys whose mask is 0
    set to -1e30, exp(s - rowmax) / rowsum in f32, p rounded to the input
    dtype, f32 PV, the output rounded to the input dtype."""
    return _softmax_attention_f32(q, k, v, scale, key_mask).to(q.dtype)


def fused_attention_packed_ref(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, scale: float, num_heads: int,
                               key_mask=None) -> torch.Tensor:
    """Plain version of `fused_attention_packed`: q [B, Sq, H*D], k/v
    [B, Sk, H*D] -> [B, Sq, H*D], per head as `fused_attention_ref`."""
    q, k, v = (split_heads(t, num_heads) for t in (q, k, v))
    return merge_heads(fused_attention_ref(q, k, v, scale, key_mask))


def _check_heads(q, k, v, key_mask, dtype=torch.bfloat16):
    """Check [B, H, S, D] views of q, k and v for the v1 form (bf16) or
    attention_f32.cu (f32): one attention, one dtype and device, a head
    width the kernels are built for -> ((B, H, Sq, Sk, D), the int32 key
    mask on q's device or None). Layouts are `_tma_view`'s."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if k.shape != (b, h, sk, d) or v.shape != k.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} do not make one attention")
    for t in (q, k, v):
        if t.device != q.device or t.dtype != dtype:
            raise TypeError(f"the CUDA kernel takes {dtype} q, k and v on "
                            f"one device, got {t.dtype} on {t.device}")
    if d not in SPLIT_HEAD_WIDTHS:
        raise ValueError(f"the CUDA kernel is built for head widths "
                         f"{SPLIT_HEAD_WIDTHS}, got {d}")
    mask = None
    if key_mask is not None:
        if tuple(key_mask.shape) != (b, sk):
            raise ValueError(f"key_mask must be [B, Sk] = {(b, sk)}, got "
                             f"{tuple(key_mask.shape)}")
        mask = key_mask.to(device=q.device, dtype=torch.int32).contiguous()
    return (b, h, sq, sk, d), mask


def _bias_arg(bias, n: int, device):
    """A q/v bias as the kernel takes it: contiguous bf16 [n] on device,
    16-byte aligned (rounded to bf16 here, as the reference casts it)."""
    if bias.numel() != n:
        raise ValueError(f"expected a bias of {n} values, got "
                         f"{tuple(bias.shape)}")
    t = bias.reshape(n).to(device=device, dtype=torch.bfloat16).contiguous()
    if t.data_ptr() % 16:
        raise ValueError("a bias must be 16-byte aligned")
    return t


def _ptr(t):
    return None if t is None else t.data_ptr()


def _f32_lib(defines: tuple[str, ...] = ()) -> ctypes.CDLL:
    """attention_f32.cu's library; `defines` ("-DHIREST_F32_TRACE=1")
    selects the traced build chip_smoke.py --time-f32 reads."""
    lib = build.load("attention_f32", defines)
    ints = [ctypes.c_int] * 5  # B, H, Sq, Sk, D
    lib.hirest_attention_f32.argtypes = (
        [ctypes.c_void_p] * 7 + ints
        + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float,
           ctypes.c_void_p])
    lib.hirest_attention_f32.restype = ctypes.c_int
    lib.hirest_attention_f32_quant.argtypes = (
        [ctypes.c_void_p] * 10 + ints
        + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float,
           ctypes.c_void_p])
    lib.hirest_attention_f32_quant.restype = ctypes.c_int
    return lib


def _tma_view(t: torch.Tensor) -> torch.Tensor:
    """t where the TMA maps of attention_qkv3.cu's v1 form (bf16) and of
    attention_f32.cu (f32) take it as it is (16-byte aligned, a unit last
    stride, batch, head and row strides positive multiples of 16 bytes),
    else a copy with the contiguous layout's strides."""
    if (t.data_ptr() % 16 or t.stride(-1) != 1
            or any(st <= 0 or st * t.element_size() % 16
                   for st in t.stride()[:3])):
        return torch.empty_like(
            t, memory_format=torch.contiguous_format).copy_(t)
    return t


def _launch_f32(q, k, v, key_mask, out, scale: float, q_bias=None,
                v_bias=None):
    """Launch attention_f32.cu on f32 [B, H, S, D] views (any strides,
    taken through `_tma_view`) into the
    f32 [B, H, Sq, D] view `out`, with the key mask [B, Sk] and the biases
    [H*D] (each or None). With out=None, the int8-out form instead ->
    (int8 codes [B, Sq, H*D], f32 row scales [B, Sq, 1])."""
    (b, h, sq, sk, d), mask = _check_heads(q, k, v, key_mask, torch.float32)
    q, k, v = (_tma_view(t) for t in (q, k, v))
    if out is not None and (out.dtype != torch.float32
                            or out.stride(-1) != 1):
        raise ValueError("out must be an f32 view with a unit last stride")
    qb, vb = (None if t is None else
              t.reshape(-1).to(device=q.device, dtype=torch.float32)
              .contiguous() for t in (q_bias, v_bias))
    for t in (qb, vb):
        if t is not None and t.numel() != h * d:
            raise ValueError(f"expected a bias of {h * d} values, got "
                             f"{t.numel()}")
    views = (q, k, v) if out is None else (q, k, v, out)
    strides = (ctypes.c_longlong * 12)(
        *(st for t in views for st in t.stride()[:3]))
    lib = _f32_lib()
    dev = q.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        if out is None:
            ws = torch.empty((b, sq, h * d), dtype=torch.float32, device=dev)
            rowmax = torch.empty((b, sq), dtype=torch.int32, device=dev)
            codes = torch.empty((b, sq, h * d), dtype=torch.int8, device=dev)
            scales = torch.empty((b, sq, 1), dtype=torch.float32, device=dev)
            err = lib.hirest_attention_f32_quant(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(mask),
                _ptr(qb), _ptr(vb), ws.data_ptr(), rowmax.data_ptr(),
                codes.data_ptr(), scales.data_ptr(), b, h, sq, sk, d, strides,
                scale, stream)
            result = codes, scales
        else:
            err = lib.hirest_attention_f32(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(mask),
                _ptr(qb), _ptr(vb), out.data_ptr(), b, h, sq, sk, d, strides,
                scale, stream)
            result = None
    build.check(lib, err, "attention_f32 launch")
    return result


def _launch_qkv_f32(qkv_biased: torch.Tensor, scale: float, num_heads: int,
                    n_real: int, quant_out: bool = False):
    """K1/K9's function on f32 [B, S, 3*H*d] pre-biased qkv through the f32
    body: the q, k and v thirds as head views, the keys cut to the first
    n_real (when n_real > 0; the reference's -1e30 scores of the others
    give them exactly 0 weight) -> [B, S, H*d] f32, or with quant_out
    (K3/K9 int8) its int8 codes and f32 row scales [B, S, 1]."""
    if qkv_biased.dim() != 3:
        raise ValueError(f"expected [B, S, 3*H*d], got "
                         f"{tuple(qkv_biased.shape)}")
    b, s, hd, _ = _split(qkv_biased.shape, num_heads)
    if n_real < 0:
        raise ValueError(f"n_real must be >= 0, got {n_real}")
    n_keys = min(n_real, s) if n_real else s
    q, k, v = (split_heads(t, num_heads) for t in qkv_biased.chunk(3, -1))
    k, v = k[:, :, :n_keys], v[:, :, :n_keys]
    if quant_out:
        return _launch_f32(q, k, v, None, None, scale)
    out = torch.empty((b, s, hd), dtype=torch.float32,
                      device=qkv_biased.device)
    _launch_f32(q, k, v, None, split_heads(out, num_heads), scale)
    return out


def v1_plan(q, k, v, key_mask=None, biased: bool = False,
            quant_out: bool = False) -> dict:
    """What attention_qkv3.cu's v1 form launches for bf16 [B, H, S, D]
    views q, k and v, without launching: the route (`v1_route`), the
    views as its TMA maps take them (each q, k or v itself, or the copy
    `_tma_view` makes), their (batch, head, row) strides, the shape
    (B, H, Sq, Sk, D) and the int32 key mask. Raises as `_check_heads`
    and `v1_route` do. Needs no GPU."""
    shape, mask = _check_heads(q, k, v, key_mask)
    route = v1_route(shape[1], masked=mask is not None, biased=biased,
                     quant_out=quant_out)
    views = tuple(_tma_view(t) for t in (q, k, v))
    return {"route": route, "views": views, "shape": shape, "mask": mask,
            "strides": tuple(st for t in views for st in t.stride()[:3])}


def _launch_v1(q, k, v, key_mask, out, scale: float, q_bias=None,
               v_bias=None, two_step: bool = False, heads_per_block: int = 0):
    """Launch attention_qkv3.cu's v1 form (`v1_plan`) on bf16 [B, H, S, D]
    views into `out`, a contiguous bf16 [B, Sq, H*D] tensor, with the key
    mask [B, Sk] (K6/K7) or the biases (K8: bf16 [H*D] each, `_bias_arg`).
    With out=None, K8's int8 epilogue instead -> (int8 codes [B, Sq, H*D],
    f32 row scales [B, Sq, 1]); two_step and heads_per_block as
    `_launch_qkv3`'s (chip_smoke.py's yardstick and variants)."""
    quant = out is None
    plan = v1_plan(q, k, v, key_mask, q_bias is not None, quant)
    route = plan["route"]
    b, h, sq, sk, d = plan["shape"]
    if two_step and route.endswith("cluster"):
        route = "v1 biased two_step"
    if heads_per_block and not route.endswith("cluster"):
        raise ValueError(f"heads_per_block={heads_per_block} asks for the "
                         f"cluster epilogue, which this call does not take")
    if not quant and (out.dtype != torch.bfloat16 or not out.is_contiguous()
                      or tuple(out.shape) != (b, sq, h * d)):
        raise ValueError(f"out must be a contiguous bf16 [B, Sq, H*D] = "
                         f"{(b, sq, h * d)}, got {tuple(out.shape)}")
    q, k, v = plan["views"]
    strides = (ctypes.c_longlong * 9)(*plan["strides"])
    lib = _kernel_lib(QKV3_TWO_STEP if two_step else ())
    dev = q.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        if quant:
            ws = rowmax = None
            if route.endswith("two_step"):
                ws = torch.empty((b, sq, h * d), dtype=torch.float32,
                                 device=dev)
                rowmax = torch.empty((b, sq), dtype=torch.int32, device=dev)
            codes = torch.empty((b, sq, h * d), dtype=torch.int8, device=dev)
            scales = torch.empty((b, sq, 1), dtype=torch.float32, device=dev)
            err = lib.hirest_attention_v1_quant(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), q_bias.data_ptr(),
                v_bias.data_ptr(), _ptr(ws), _ptr(rowmax), codes.data_ptr(),
                scales.data_ptr(), b, h, sq, sk, d, strides, scale,
                heads_per_block, stream)
            result = codes, scales
        else:
            err = lib.hirest_attention_v1(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(plan["mask"]),
                _ptr(q_bias), _ptr(v_bias), out.data_ptr(), b, h, sq, sk, d,
                strides, scale, stream)
            result = out
    build.check(lib, err, "attention v1 launch")
    return result


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float, key_mask=None) -> torch.Tensor:
    """Softmax attention over split heads: q [B, H, Sq, D], k/v
    [B, H, Sk, D], key_mask [B, Sk] or None (nonzero marks a valid key)
    -> [B, H, Sq, D] in q's dtype (K6).

    A CPU tensor takes the plain version. A CUDA tensor launches the kernel
    (K and V streamed through shared memory, so any Sk): bf16 views of
    head width 64, 88 or 128 (a layout the TMA maps cannot take is copied
    first, `_tma_view`), or f32 views, which take the f32 body; anything
    else raises. The output lies in [B, Sq, H, D] memory, so merging the
    heads back is a view.
    `fused_attention.launches` counts bf16 launches, `.launches_f32` f32
    ones."""
    if not _on_cuda(q):
        return fused_attention_ref(q, k, v, scale, key_mask)
    if q.dim() != 4:
        raise ValueError(f"expected [B, H, Sq, D], got {tuple(q.shape)}")
    b, h, sq, d = q.shape
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    if q.dtype == torch.float32:
        _launch_f32(q, k, v, key_mask, out.transpose(1, 2), scale)
        fused_attention.launches_f32 += 1
        return out.transpose(1, 2)
    _launch_v1(q, k, v, key_mask, out.view(b, sq, h * d), scale)
    fused_attention.launches += 1
    return out.transpose(1, 2)


def fused_attention_packed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           scale: float, num_heads: int,
                           key_mask=None) -> torch.Tensor:
    """Softmax attention over packed heads: q [B, Sq, H*D], k/v
    [B, Sk, H*D] -> [B, Sq, H*D] (K7), the function of `fused_attention`
    with the heads left in place. A CPU tensor takes the plain version; a
    CUDA tensor launches the kernel under `fused_attention`'s conditions.
    `fused_attention_packed.launches` counts bf16 launches, `.launches_f32`
    f32 ones."""
    if not _on_cuda(q):
        return fused_attention_packed_ref(q, k, v, scale, num_heads,
                                          key_mask)
    if q.dim() != 3 or q.shape[-1] % num_heads:
        raise ValueError(f"expected [B, Sq, {num_heads} heads * D], got "
                         f"{tuple(q.shape)}")
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    q, k, v = (split_heads(t, num_heads) for t in (q, k, v))
    if q.dtype == torch.float32:
        _launch_f32(q, k, v, key_mask, split_heads(out, num_heads), scale)
        fused_attention_packed.launches_f32 += 1
        return out
    _launch_v1(q, k, v, key_mask, out, scale)
    fused_attention_packed.launches += 1
    return out


fused_attention.launches = 0
fused_attention.launches_f32 = 0
fused_attention_packed.launches = 0
fused_attention_packed.launches_f32 = 0


# --- K8: v1, fused qkv with the q/v biases added in the kernel ------------


def fused_attention_qkv_ref(qkv: torch.Tensor, q_bias: torch.Tensor,
                            v_bias: torch.Tensor, scale: float,
                            num_heads: int, *, quant_out: bool = False):
    """Plain version of `fused_attention_qkv`: qkv [B, S, 3*H*d] (thirds
    q | k | v, no bias), q_bias and v_bias [H*d] cast to qkv's dtype and
    added in that dtype, then K6's softmax attention per head -> [B, S, H*d]
    in qkv's dtype, or with quant_out the int8 codes and f32 row scales
    [B, S, 1] of the f32 output (one scale over all heads of a row)."""
    _split(qkv.shape, num_heads)
    q, k, v = qkv.chunk(3, -1)
    q = q + q_bias.to(qkv.dtype)
    v = v + v_bias.to(qkv.dtype)
    o = merge_heads(_softmax_attention_f32(
        *(split_heads(t, num_heads) for t in (q, k, v)), scale))
    if quant_out:
        return dyn_quant_rows_ref(o)
    return o.to(qkv.dtype)


def fused_attention_qkv(qkv: torch.Tensor, q_bias: torch.Tensor,
                        v_bias: torch.Tensor, scale: float, num_heads: int, *,
                        quant_out: bool = False):
    """The v1 attention (K8), the scanned trunk's default: self-attention
    straight off the fused qkv projection, qkv [B, S, 3*H*d] without bias,
    q_bias and v_bias [H*d] -> [B, S, H*d], or with quant_out the int8
    codes and f32 row scales [B, S, 1] of the f32 output.

    A CPU tensor takes the plain version. A CUDA tensor in bf16 (head
    width 64, 88 or 128, any S) launches the kernel's v1 form on the q, k
    and v thirds as views (copied first where the TMA maps cannot take
    them, `_tma_view`), the biases added in bf16 to q's fragments and to
    each V tile as it lands in shared memory, the int8 epilogue at 16
    heads in the kernel (`v1_route`); in f32 the f32 body on the same
    views with the biases added in f32; anything else raises.
    `fused_attention_qkv.launches` counts bf16-out launches,
    `.quant_launches` int8-out ones, `.launches_f32` and
    `.quant_launches_f32` their f32 ones."""
    if not _on_cuda(qkv):
        return fused_attention_qkv_ref(qkv, q_bias, v_bias, scale, num_heads,
                                       quant_out=quant_out)
    if qkv.dim() != 3:
        raise ValueError(f"expected [B, S, 3*H*d], got {tuple(qkv.shape)}")
    b, s, hd, d = _split(qkv.shape, num_heads)
    if qkv.dtype == torch.float32:
        q, k, v = (split_heads(t, num_heads) for t in qkv.chunk(3, -1))
        out = None if quant_out else torch.empty(
            (b, s, hd), dtype=qkv.dtype, device=qkv.device)
        codes = _launch_f32(q, k, v, None, None if out is None
                            else split_heads(out, num_heads), scale, q_bias,
                            v_bias)
        _count_f32(fused_attention_qkv, quant_out)
        return codes if quant_out else out
    if qkv.dtype != torch.bfloat16:
        raise TypeError(f"the CUDA kernel takes bfloat16 or float32 qkv, got "
                        f"{qkv.dtype}")
    q, k, v = (split_heads(t, num_heads) for t in qkv.chunk(3, -1))
    qb, vb = (_bias_arg(t, hd, qkv.device) for t in (q_bias, v_bias))
    if quant_out:
        out = _launch_v1(q, k, v, None, None, scale, qb, vb)
        fused_attention_qkv.quant_launches += 1
        return out
    out = torch.empty((b, s, hd), dtype=qkv.dtype, device=qkv.device)
    _launch_v1(q, k, v, None, out, scale, qb, vb)
    fused_attention_qkv.launches += 1
    return out


fused_attention_qkv.launches = 0
fused_attention_qkv.quant_launches = 0
fused_attention_qkv.launches_f32 = 0
fused_attention_qkv.quant_launches_f32 = 0
