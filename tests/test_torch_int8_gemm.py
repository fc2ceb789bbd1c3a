"""G1 (the int8 projections whole: `ops/quant.py::int8_mm`, the int8 x int8
-> int32 product with E3's dequant, bias and residual in its epilogue,
hirest_tpu_torch/ops/csrc/int8_gemm.cu) against the JAX package.

On the CPU `int8_mm` takes its plain version, `int8_mm_ref` (the exact
`torch._int_mm` product, then `int8_epilogue_ref`), so these tests hold the
plain version against JAX's `_int8_mm` (with the residual sum that follows
it in the block) and `int8_matmul` against JAX's `int8_matmul`, at EVA-g's
widths on a few rows; hold the plain version bit for bit against the
chain it replaces; hold G1's shape rule (`int8_gemm_shape`) and its
variant rule (`int8_gemm_config`: variant, split, cluster) to every call
that the scanned int8 forwards (each int8 ladder configuration, at head
widths 88 and 128) and the unrolled int8 tower make, at EVA-g's widths,
and the shape rule to what it refuses; emulate the split-K variant's
int32 partials over its K ranges at the head's shape, bit for bit with
the plain version; and check that CPU calls count no launch and that a
device without the kernel raises. chip_smoke.py holds every G1 variant
bit for bit against the plain version on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import PACKED, configs, eva_state_dict, images

import hirest_tpu.ops.quant as jax_quant
import hirest_tpu_torch.models.eva_quant as eva_quant
import hirest_tpu_torch.models.eva_scan as eva_scan
import hirest_tpu_torch.ops.quant as quant
from hirest_tpu.models.eva_scan import _int8_mm as jax_int8_mm
from hirest_tpu_torch.models.eva_pad import pad_vision_head_params
from hirest_tpu_torch.ops.quant import (QuantDense, int8_epilogue,
                                        int8_epilogue_ref, int8_gemm_shape,
                                        int8_matmul, int8_mm, int8_mm_ref)

C, F, QKV, EMBED = 1408, 6144, 4224, 1024  # EVA-g's widths
PADDED_C, PADDED_QKV = 2048, 6144  # heads padded from 88 to 128
PATCH = 14 * 14 * 3  # the unrolled tower's patch rows, 588 (K' = 592)
DTYPES = {"bf16": (torch.bfloat16, jnp.bfloat16),
          "f32": (torch.float32, jnp.float32)}
ROWS = (1, 5, 257)  # a row, a few, a frame


def _rng(seed):
    return np.random.default_rng(seed)


def _operands(seed, m, n, k):
    """An int8 product's operands: codes, row and channel scales, a bias,
    a residual."""
    rng = _rng(seed)
    x_q = rng.integers(-127, 128, (m, k), dtype=np.int8)
    x_s = rng.uniform(0.01, 0.05, (m, 1)).astype(np.float32)
    w_q = rng.integers(-127, 128, (n, k), dtype=np.int8)  # [out, in]
    w_s = rng.uniform(1e-4, 1e-3, n).astype(np.float32)
    bias = rng.normal(size=n).astype(np.float32)
    res = (2 * rng.normal(size=(m, n))).astype(np.float32)
    return x_q, x_s, w_q, w_s, bias, res


def _bits(t: torch.Tensor) -> np.ndarray:
    ints = {torch.bfloat16: torch.int16, torch.float32: torch.int32}
    return t.view(ints[t.dtype]).numpy()


# the products G1 takes over: (N, K, with a bias, with the residual)
FORMS = {"qkv v1": (QKV, C, False, False), "qkv v3": (QKV, C, True, False),
         "qkv padded": (PADDED_QKV, C, True, False),
         "out": (C, C, True, True), "out padded": (C, PADDED_C, True, True),
         "fc1": (F, C, True, False), "fc2": (C, F, True, True),
         "head": (EMBED, C, True, False)}
JAX_CASES = [(form, dt, m) for form in FORMS for dt in DTYPES for m in ROWS]


def _hold_to_jax(got: np.ndarray, want: np.ndarray, dt: str) -> None:
    """The bar of tests/test_torch_int8_epilogue.py for E3 against JAX: in
    f32 within an f32 rounding (rtol = atol = 1e-6); in bf16, where an f32
    rounding that lands on a bf16 boundary may round the other way, within
    one bf16 ulp of each value and equal on 99.9 %."""
    assert got.shape == want.shape
    if dt == "f32":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    else:
        assert np.mean(got == want) >= 0.999
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30)))
                      - 7)
        assert np.all(np.abs(got - want) <= ulp)


@pytest.mark.parametrize("form,dt,m", JAX_CASES,
                         ids=[f"{f}-{d}-{m}" for f, d, m in JAX_CASES])
def test_plain_matches_jax_int8_mm(form, dt, m):
    """int8_mm_ref against JAX's `_int8_mm` and, for out and fc2,
    `x + _int8_mm(...)` in the same dtype, at EVA-g's widths."""
    n, k, with_bias, with_res = FORMS[form]
    tdt, jdt = DTYPES[dt]
    x_q, x_s, w_q, w_s, bias, res = _operands(m * 7 + n + k, m, n, k)
    b = bias if with_bias else None
    want = jax_int8_mm(jnp.asarray(x_q), jnp.asarray(x_s),
                       jnp.asarray(w_q.T.copy()), jnp.asarray(w_s),
                       None if b is None else jnp.asarray(b), jdt)
    r = None
    if with_res:
        r = torch.from_numpy(res).to(tdt)
        want = jnp.asarray(res, jdt) + want
    got = int8_mm_ref(torch.from_numpy(x_q), torch.from_numpy(x_s),
                      torch.from_numpy(w_q), torch.from_numpy(w_s),
                      None if b is None else torch.from_numpy(b), tdt, r)
    assert got.dtype == tdt and got.shape == (m, n)
    _hold_to_jax(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                 dt)


CHAIN_CASES = [(form, dt) for form in FORMS for dt in DTYPES]


@pytest.mark.parametrize("form,dt", CHAIN_CASES,
                         ids=[f"{f}-{d}" for f, d in CHAIN_CASES])
def test_plain_is_the_old_chain_bit_for_bit(form, dt):
    """int8_mm_ref, and int8_mm on CPU tensors, against the chain the port
    ran before G1 (`torch._int_mm`, then E3's plain version), bit for bit,
    on 37 rows."""
    n, k, with_bias, with_res = FORMS[form]
    tdt = DTYPES[dt][0]
    x_q, x_s, w_q, w_s, bias, res = (torch.from_numpy(a) for a in
                                     _operands(11, 37, n, k))
    b = bias if with_bias else None
    r = res.to(tdt) if with_res else None
    want = int8_epilogue_ref(torch._int_mm(x_q, w_q.t()), x_s, w_s, b, tdt,
                             r)
    for got in (int8_mm_ref(x_q, x_s, w_q, w_s, b, tdt, r),
                int8_mm(x_q, x_s, w_q, w_s, b, tdt, residual=r)):
        assert got.dtype == tdt and got.shape == (37, n)
        np.testing.assert_array_equal(_bits(got), _bits(want))


MATMUL = {"patch": (PATCH, C), "head": (C, EMBED), "qkv": (C, QKV)}
MATMUL_CASES = [(what, dt, m) for what in MATMUL for dt in DTYPES
                for m in ROWS]


@pytest.mark.parametrize("what,dt,m", MATMUL_CASES,
                         ids=[f"{w}-{d}-{m}" for w, d, m in MATMUL_CASES])
def test_int8_matmul_matches_jax(what, dt, m):
    """`int8_matmul` (QuantDense's call: E4 into K' = 592-wide codes for
    the patch rows, then G1's plain version) against JAX's `int8_matmul`
    on the same rows in the same dtype, at E3's bars; the weight's K is
    padded to G1's multiple of 16, which changes no number."""
    k, n = MATMUL[what]
    tdt, jdt = DTYPES[dt]
    rng = _rng(20 + m)
    w = rng.normal(size=(n, k)).astype(np.float32) * 0.02
    x = (rng.normal(size=(m, k)) * 2).astype(np.float32)
    bias = rng.normal(size=n).astype(np.float32)
    dense = QuantDense(torch.from_numpy(w), torch.from_numpy(bias), tdt)
    jw_q, jw_s = jax_quant.quantize_weight(w.T)
    want = jax_quant.int8_matmul(jnp.asarray(x, jdt), jw_q, jw_s,
                                 jnp.asarray(bias), jdt)
    got = dense(torch.from_numpy(x).to(tdt))
    assert dense.w_q.shape[1] % quant.INT8_GEMM_K_MULTIPLE == 0
    assert got.dtype == tdt and got.shape == (m, n)
    _hold_to_jax(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                 dt)


# --- G1's shape rule --------------------------------------------------------

# EVA-g's products at B = 128 (M = 128 x 257), and the head at B = 2:
# (x_q shape, w_q shape)
EVA_G = [((32896, C), (QKV, C)), ((32896, C), (PADDED_QKV, C)),
         ((32896, C), (C, C)), ((32896, PADDED_C), (C, PADDED_C)),
         ((32896, C), (F, C)), ((32896, F), (C, F)),
         ((32768, 592), (C, 592)), ((128, C), (EMBED, C)),
         ((2, C), (EMBED, C)), ((1, C), (QKV, C))]


@pytest.mark.parametrize("dt", DTYPES)
def test_shape_rule_takes_eva_g_shapes(dt):
    tdt = DTYPES[dt][0]
    for x_shape, w_shape in EVA_G:
        assert int8_gemm_shape(tdt, x_shape, w_shape) == (
            x_shape[0], w_shape[0], x_shape[1])
    # a single row may have any row stride; rows 16-byte multiples apart
    assert int8_gemm_shape(tdt, (1, C), (QKV, C), (7, 1)) == (1, QKV, C)
    assert int8_gemm_shape(tdt, (4, C), (QKV, C), (257 * C, 1)) == (
        4, QKV, C)


@pytest.mark.parametrize("dt", DTYPES)
def test_config_picks_a_variant_for_every_eva_g_product(dt):
    """int8_gemm_config names a (variant, splits, cluster) for every product
    of the towers, with and without a residual: one of the variants it
    picks from, in a form the output dtype has; split K only where its
    blocks (2 to 8 a 128 x 128 tile, at most one a 128-byte K tile) fit
    one wave of the card's SMs; the 128-wide two-blocks-an-SM tiles only
    for f32 with a residual; otherwise clusters of two 128 x 256 tiles."""
    f32 = dt == "f32"
    for (m, k), (n, _) in EVA_G:
        for residual in (False, True):
            got = quant.int8_gemm_config(m, n, k, f32, residual)
            assert got.variant in quant.INT8_GEMM_VARIANTS
            assert f32 or got.variant not in quant.INT8_GEMM_F32_ONLY
            if got.variant == quant.INT8_GEMM_SPLIT:
                assert 2 <= got.splits == got.cluster <= min(
                    quant.INT8_GEMM_MAX_SPLITS, -(-k // 128))
                assert (-(-m // 128) * -(-n // 128) * got.splits
                        <= quant.INT8_GEMM_SMS)
            elif got.variant == quant.INT8_GEMM_SERIAL:
                assert f32 and residual and (got.splits, got.cluster) == (
                    1, 1)
            else:
                assert (got.splits, got.cluster) == (1, 2)
    for (m, k), (n, _) in EVA_G[:8]:  # the towers' products at B = 128
        for residual in (False, True):
            assert quant.int8_gemm_config(m, n, k, f32, residual) == (
                (quant.INT8_GEMM_SPLIT, 8, 8) if m == 128 else
                (quant.INT8_GEMM_SERIAL, 1, 1) if f32 and residual else
                (quant.INT8_GEMM_PAIR, 1, 2))


SPLIT_CASES = [(dt, splits) for dt in DTYPES
               for splits in range(2, quant.INT8_GEMM_MAX_SPLITS + 1)]


@pytest.mark.parametrize("dt,splits", SPLIT_CASES,
                         ids=[f"{d}-{s}" for d, s in SPLIT_CASES])
def test_split_k_sums_are_the_product_bit_for_bit(dt, splits):
    """The split-K variant's arithmetic at EVA-g's head (128 class-token
    rows x 1408 into 1024, with its bias): int32 partials over each
    block's K range (int8_gemm_split_ranges), added in int32, then the
    dequant once (int8_epilogue_ref), equal to int8_mm_ref bit for bit;
    the ranges cover K once, in 128-byte tiles."""
    tdt = DTYPES[dt][0]
    k, n = C, EMBED
    x_q, x_s, w_q, w_s, bias, _ = (torch.from_numpy(a) for a in
                                   _operands(90 + splits, 128, n, k))
    ranges = quant.int8_gemm_split_ranges(k, splits)
    assert [r[0] for r in ranges[1:]] == [r[1] for r in ranges[:-1]]
    assert ranges[0][0] == 0 and ranges[-1][1] == k
    assert all(k0 % 128 == 0 and k1 > k0 for k0, k1 in ranges)
    acc = torch.zeros((128, n), dtype=torch.int32)
    for k0, k1 in ranges:
        acc += torch._int_mm(x_q[:, k0:k1].contiguous(),
                             w_q[:, k0:k1].contiguous().t())
    got = int8_epilogue_ref(acc, x_s, w_s, bias, tdt)
    want = int8_mm_ref(x_q, x_s, w_q, w_s, bias, tdt)
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_split_ranges_refuse_what_the_kernel_does_not_take():
    for splits in (0, quant.INT8_GEMM_MAX_SPLITS + 1):
        with pytest.raises(ValueError):
            quant.int8_gemm_split_ranges(C, splits)
    with pytest.raises(ValueError):  # more blocks than K tiles
        quant.int8_gemm_split_ranges(256, 3)


def test_weight_codes_are_contiguous_whatever_the_weight_strides():
    """quantize_weight hands G1 row-major codes even for a transposed
    weight (the padded heads' out projection is one), the same codes and
    scales as for its contiguous copy."""
    w = torch.from_numpy(_rng(14).normal(size=(256, 128))
                         .astype(np.float32)).t()
    q, s = quant.quantize_weight(w)
    qc, sc = quant.quantize_weight(w.contiguous())
    assert not w.is_contiguous() and q.is_contiguous()
    assert torch.equal(q, qc) and torch.equal(s, sc)
    assert int8_gemm_shape(torch.bfloat16, (4, 256), q.shape, None,
                           q.stride()) == (4, 128, 256)


REFUSED = {
    "f16 out": (TypeError, (torch.float16, (4, C), (QKV, C))),
    "int32 out": (TypeError, (torch.int32, (4, C), (QKV, C))),
    "3-d x_q": (TypeError, (torch.bfloat16, (2, 4, C), (QKV, C))),
    "transposed x_q": (TypeError, (torch.bfloat16, (4, C), (QKV, C),
                                   (1, 4))),
    "transposed w_q": (TypeError, (torch.bfloat16, (4, C), (QKV, C), None,
                                   (1, QKV))),
    "rows not 16 bytes apart": (TypeError, (torch.bfloat16, (4, C),
                                            (QKV, C), (C + 8, 1))),
    "rows closer than K": (TypeError, (torch.bfloat16, (4, C), (QKV, C),
                                       (C - 16, 1))),
    "unaligned": (TypeError, (torch.bfloat16, (4, C), (QKV, C), None, None,
                              False)),
    "K % 16 != 0": (ValueError, (torch.bfloat16, (4, PATCH), (C, PATCH))),
    "K differs": (ValueError, (torch.bfloat16, (4, 592), (C, PATCH + 16))),
    "N % 8 != 0": (ValueError, (torch.bfloat16, (4, C), (1404, C))),
    "no rows": (ValueError, (torch.float32, (0, C), (QKV, C))),
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_shape_rule_refuses_what_g1_does_not_take(case):
    error, args = REFUSED[case]
    with pytest.raises(error):
        int8_gemm_shape(*args)


def _record(monkeypatch, module, attr, record):
    fn = getattr(module, attr)

    def recorded(*args, **kwargs):
        record(*args, **kwargs)
        return fn(*args, **kwargs)

    monkeypatch.setattr(module, attr, recorded)


def _hold(calls, widths, dtype, x_q, x_s, w_q, w_s, bias, out_dtype,
          residual=None):
    """One int8_mm call held to G1's rule as it would come at EVA-g's
    widths: the same dtype, rows, row strides (scaled alike), alignment
    and residual."""
    (m, k), n = x_q.shape, w_q.shape[0]
    big_k, big_n = widths[k], widths[n]
    assert x_q.dtype == w_q.dtype == torch.int8 and out_dtype == dtype
    assert x_s.numel() == m and w_s.numel() == n
    assert bias is None or bias.numel() == n
    assert residual is None or (residual.dtype == dtype
                                and tuple(residual.shape) == (m, n)
                                and residual.is_contiguous())
    x_stride, w_stride = x_q.stride(), w_q.stride()
    if x_stride[1] == 1:  # rows: their stride scaled as K is
        x_stride = (x_stride[0] // k * big_k if m > 1 else big_k, 1)
    if w_stride[1] == 1:
        w_stride = (w_stride[0] // k * big_k, 1)
    calls.append(int8_gemm_shape(
        out_dtype, (m, big_k), (big_n, big_k), x_stride, w_stride,
        x_q.data_ptr() % 16 == 0 and w_q.data_ptr() % 16 == 0))
    for rows in (m, 128 * 257):  # the recorded rows, and EVA-g's at B = 128
        assert quant.int8_gemm_config(
            rows, big_n, big_k, dtype == torch.float32,
            residual is not None).variant in quant.INT8_GEMM_VARIANTS


INT8_LADDER = {"int8": dict(int8=True),
               "int8+fq": dict(int8=True, fused_quant=True),
               "int8+fq+v2": dict(int8=True, fused_quant=True, attn_v2=True),
               "int8+fq+v3": dict(int8=True, fused_quant=True, attn_v3=True),
               "int8+fq+v3+fm": dict(int8=True, fused_quant=True,
                                     attn_v3=True, fused_mlp=True)}
PER_BLOCK = {"int8+fq+v3+fm": 2}  # int8_mm calls a block; 4 elsewhere
# the small config's heads (4 x 32) as EVA-g's 88, or padded as 88 -> 128
# is: to 64, so no two widths of the small config coincide
HEADS = {"88": None, "128": 64}
SCANNED_CASES = [(tag, hd, dt) for tag in INT8_LADDER for hd in HEADS
                 for dt in DTYPES]


@pytest.mark.parametrize("tag,hd,dt", SCANNED_CASES,
                         ids=[f"{t}-d{h}-{d}" for t, h, d in SCANNED_CASES])
def test_shape_rule_takes_every_scanned_int8_call(monkeypatch, tag, hd, dt):
    """Every int8_mm call of each int8 configuration of the scanned
    forward, at head width 88 and padded to 128, in bf16 and f32, recorded
    on the CPU and taken by G1's rule as it would come at EVA-g's widths;
    4 calls a block (2 with the fused MLP)."""
    tdt = DTYPES[dt][0]
    cfg = configs(PACKED)[1]
    sd = eva_state_dict(PACKED, seed=62)
    widths = {cfg.width: C, cfg.mlp_hidden: F, 3 * cfg.width: QKV}
    if HEADS[hd] is not None:
        sd, cfg = pad_vision_head_params(sd, cfg, HEADS[hd])
        att = cfg.num_heads * cfg.head_width
        widths = {cfg.width: C, cfg.mlp_hidden: F, att: PADDED_C,
                  3 * att: PADDED_QKV}
    assert len(widths) == (3 if HEADS[hd] is None else 4)  # none coincide
    calls = []
    _record(monkeypatch, eva_scan, "int8_mm",
            lambda *a, **kw: _hold(calls, widths, tdt, *a, **kw))
    out = eva_scan.build_scanned_vision_apply(
        sd, cfg, device="cpu", dtype=tdt, **INT8_LADDER[tag])(
            images(PACKED, 2, seed=62))
    assert torch.isfinite(out).all()
    assert len(calls) == PER_BLOCK.get(tag, 4) * PACKED["layers"]
    m = 2 * (PACKED["image_size"] // PACKED["patch_size"]) ** 2 + 2
    assert {c[0] for c in calls} == {m}


@pytest.mark.parametrize("quant_attention", [True, False],
                         ids=["quant_attention", "bf16_qkv_out"])
@pytest.mark.parametrize("dt", DTYPES)
def test_shape_rule_takes_every_unrolled_int8_call(monkeypatch, dt,
                                                   quant_attention):
    """Every int8_mm call of the unrolled int8 tower (QuantDense: the patch
    embedding on 592-wide codes, the trunk's products, the head on the B
    class-token rows), recorded on the CPU and taken by G1's rule at
    EVA-g's widths."""
    tdt = DTYPES[dt][0]
    cfg = configs(PACKED)[1]
    widths = {cfg.width: C, cfg.mlp_hidden: F, 3 * cfg.width: QKV,
              cfg.embed_dim: EMBED, 592: 592}
    calls = []
    _record(monkeypatch, quant, "int8_mm",
            lambda *a, **kw: _hold(calls, widths, tdt, *a, **kw))
    out = eva_quant.build_int8_vision_apply(
        eva_state_dict(PACKED, seed=63), cfg,
        quant_attention=quant_attention, dtype=tdt, device="cpu")(
            images(PACKED, 2, seed=63))
    assert torch.isfinite(out).all()
    per_layer = 4 if quant_attention else 2
    assert len(calls) == per_layer * PACKED["layers"] + 2
    assert (8, C, 592) in calls and (2, EMBED, C) in calls  # patch, head


# --- CPU calls, and devices without the kernel ------------------------------


def _counts():
    return [getattr(fn, attr) for fn in (int8_mm, int8_epilogue)
            for attr in ("launches", "launches_f32")]


def test_cpu_calls_take_the_plain_version_without_counting():
    x_q, x_s, w_q, w_s, bias, res = (torch.from_numpy(a) for a in
                                     _operands(12, 20, 64, 32))
    before = _counts()
    for dtype in (torch.bfloat16, torch.float32):
        r = res.to(dtype)
        for b, rr in ((None, None), (bias, None), (bias, r)):
            assert torch.equal(int8_mm(x_q, x_s, w_q, w_s, b, dtype, rr),
                               int8_mm_ref(x_q, x_s, w_q, w_s, b, dtype, rr))
        x = (torch.from_numpy(_rng(13).normal(size=(3, 32)))
             .to(dtype))
        want = int8_mm_ref(*quant.row_quant_ref(x), w_q, w_s, bias, dtype)
        assert torch.equal(int8_matmul(x, w_q, w_s, bias, dtype), want)
    assert _counts() == before


def test_cuda_wrapper_raises_on_a_device_without_the_kernel():
    """No silent fallback: operands neither on the CPU nor on CUDA raise
    instead of taking the plain version."""
    x_q = torch.empty((4, C), dtype=torch.int8, device="meta")
    x_s = torch.empty((4, 1), device="meta")
    w_q = torch.empty((QKV, C), dtype=torch.int8, device="meta")
    w_s = torch.empty(QKV, device="meta")
    x = torch.empty((4, C), dtype=torch.bfloat16, device="meta")
    for call in (lambda: int8_mm(x_q, x_s, w_q, w_s, None, torch.bfloat16),
                 lambda: quant._int8_gemm_launch(x_q, x_s, w_q, w_s, None,
                                                 torch.float32),
                 lambda: int8_matmul(x, w_q, w_s)):
        with pytest.raises(ValueError, match="no kernel"):
            call()
