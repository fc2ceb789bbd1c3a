"""E3 (the int8 products' dequant epilogue, `ops/quant.py::int8_epilogue`)
and E4 (the unrolled int8 tower's dynamic per-row quantizer, `row_quant`),
both in hirest_tpu_torch/ops/csrc/int8_epilogue.cu, and the scanned
block's quantizer `dyn_quant_rows` (K5's form without an activation on
the card), against the JAX package.

On the CPU the wrappers take their plain versions, so these tests hold the
plain versions against JAX's `_int8_mm` (with the residual sum that follows
it in the block), `_dyn_quant_rows` and the quantization inside
hirest_tpu/ops/quant.py::int8_matmul; hold E3's plain version bit for bit
against the eager chain `int8_mm` ran before it had a kernel; and hold the
CUDA wrappers' shape rules (`int8_epilogue_shape`, `row_quant_shape`, and
`row_kernel_shape` for K5) to every call that the scanned int8 forwards
and the unrolled int8 tower make, at EVA-g's widths. chip_smoke.py holds
the kernels bit for bit against the plain versions on the card. The same
records hold the routes: K3's and K9's int8 calls (`qkv3_shape`: the
cluster epilogue at EVA-g's 16 heads) and E4's (`row_quant_route`: the
bulk-copy ring, or row_quant_kernel for the patch rows and f32 rows).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import PACKED, configs, eva_state_dict, images

import hirest_tpu.ops.quant as jax_quant
import hirest_tpu_torch.models.eva_clip as eva_clip
import hirest_tpu_torch.models.eva_quant as eva_quant
import hirest_tpu_torch.models.eva_scan as eva_scan
import hirest_tpu_torch.ops.quant as quant
from hirest_tpu.models.eva_scan import _dyn_quant_rows as jax_dyn_quant_rows
from hirest_tpu.models.eva_scan import _int8_mm as jax_int8_mm
from hirest_tpu_torch.ops.attention import QKV3_CLUSTER_HEADS, qkv3_shape
from hirest_tpu_torch.ops.quant import (act_quant,
                                        dyn_quant_rows, dyn_quant_rows_ref,
                                        int8_epilogue, int8_epilogue_ref,
                                        int8_epilogue_shape, int8_matmul,
                                        int8_mm, quantize_weight, row_quant,
                                        row_quant_ref, row_quant_route,
                                        row_quant_shape, row_kernel_shape)

C, F, QKV, EMBED = 1408, 6144, 4224, 1024  # EVA-g's widths
PATCH = 14 * 14 * 3  # the unrolled tower's patch rows, 588 (K' = 592)
DTYPES = {"bf16": (torch.bfloat16, jnp.bfloat16),
          "f32": (torch.float32, jnp.float32)}
PAD_ROWS = 17  # rows E4 zero-pads its operand to, past the rows it quantizes


def _rng(seed):
    return np.random.default_rng(seed)


def _acc_inputs(seed, m, n, k=C):
    """An int8 product's operands: codes, row and channel scales, a bias."""
    rng = _rng(seed)
    x_q = rng.integers(-127, 128, (m, k), dtype=np.int8)
    x_s = rng.uniform(0.01, 0.05, (m, 1)).astype(np.float32)
    w_q = rng.integers(-127, 128, (n, k), dtype=np.int8)  # [out, in]
    w_s = rng.uniform(1e-4, 1e-3, n).astype(np.float32)
    bias = rng.normal(size=n).astype(np.float32)
    res = (2 * rng.normal(size=(m, n))).astype(np.float32)
    return x_q, x_s, w_q, w_s, bias, res


def _old_int8_mm(x_q, x_s, w_q, w_s, bias, out_dtype):
    """`int8_mm` as the port ran it before E3: the eager chain."""
    out = torch._int_mm(x_q, w_q.t()).float()
    out.mul_(x_s).mul_(w_s)
    if bias is not None:
        out.add_(bias.float())
    return out.to(out_dtype)


def _bits(t: torch.Tensor) -> np.ndarray:
    ints = {torch.bfloat16: torch.int16, torch.float32: torch.int32}
    return t.view(ints[t.dtype]).numpy() if t.dtype in ints else t.numpy()


# (product, with a bias, with the residual): qkv without its bias (v1) and
# with it (v2/v3), out and fc2 with bias and residual, fc1 with its bias
E3_FORMS = {"qkv v1": (QKV, False, False), "qkv v3": (QKV, True, False),
            "out": (C, True, True), "fc1": (F, True, False),
            "fc2": (C, True, True)}
E3_CASES = [(form, dt) for form in E3_FORMS for dt in DTYPES]


@pytest.mark.parametrize("form,dt", E3_CASES,
                         ids=[f"{f}-{d}" for f, d in E3_CASES])
def test_e3_plain_is_the_old_chain_bit_for_bit(form, dt):
    """int8_mm (the product and E3's plain version on the CPU) against the
    eager chain it replaces, and its residual form against `x + chain`,
    bit for bit, at EVA-g's widths on a few rows."""
    n, with_bias, with_res = E3_FORMS[form]
    tdt = DTYPES[dt][0]
    x_q, x_s, w_q, w_s, bias, res = (torch.from_numpy(a) for a in
                                     _acc_inputs(1, 37, n))
    b = bias if with_bias else None
    r = res.to(tdt) if with_res else None
    got = int8_mm(x_q, x_s, w_q, w_s, b, tdt, residual=r)
    want = _old_int8_mm(x_q, x_s, w_q, w_s, b, tdt)
    if with_res:
        want = r + want
    assert got.dtype == tdt and got.shape == (37, n)
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("form,dt", E3_CASES,
                         ids=[f"{f}-{d}" for f, d in E3_CASES])
def test_e3_plain_matches_jax(form, dt):
    """E3's plain version against JAX's `_int8_mm` and, for out and fc2,
    `x + _int8_mm(...)` in the same dtype. The int32 product is exact in
    both; the f32 epilogue agrees to an f32 rounding (rtol = atol = 1e-6,
    test_torch_quant.py's bar for int8_mm). In bf16 the f32 values are
    rounded once (and the residual sum once more), so an f32 rounding that
    lands on a bf16 boundary may round the other way: within one bf16 ulp
    of each value, and equal on 99.9 %."""
    n, with_bias, with_res = E3_FORMS[form]
    tdt, jdt = DTYPES[dt]
    x_q, x_s, w_q, w_s, bias, res = _acc_inputs(2, 300, n)
    b = bias if with_bias else None
    want = jax_int8_mm(jnp.asarray(x_q), jnp.asarray(x_s),
                       jnp.asarray(w_q.T.copy()), jnp.asarray(w_s),
                       None if b is None else jnp.asarray(b), jdt)
    r = None
    if with_res:
        r = torch.from_numpy(res).to(tdt)
        want = jnp.asarray(res, jdt) + want
    acc = torch._int_mm(torch.from_numpy(x_q), torch.from_numpy(w_q).t())
    got = int8_epilogue(acc, torch.from_numpy(x_s), torch.from_numpy(w_s),
                        None if b is None else torch.from_numpy(b), tdt, r)
    want = np.asarray(want.astype(jnp.float32))
    got = got.float().numpy()
    assert got.shape == want.shape == (300, n)
    if dt == "f32":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    else:
        assert np.mean(got == want) >= 0.999
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30)))
                      - 7)
        assert np.all(np.abs(got - want) <= ulp)


def _rows_with_edges(seed, m, c):
    """Rows [m, c] f32 at ~3, row 0 zero (the 1e-8 scale floor), row 1 with
    max |x| = 127, so its scale is 1 and its quotients land on exact halves
    (round half to even), row 2 the same negated."""
    x = (3 * _rng(seed).normal(size=(m, c))).astype(np.float32)
    x[0] = 0.0
    x[1] = np.resize(np.float32([127.0, 2.5, -3.5, 0.5, -0.5, 1.5, 126.5]),
                     c)
    x[2] = -x[1]
    return x


E4_CASES = [(c, dt) for c in (PATCH, C, F) for dt in DTYPES]


@pytest.mark.parametrize("c,dt", E4_CASES,
                         ids=[f"{c}-{d}" for c, d in E4_CASES])
def test_row_quantizers_are_bit_equal_to_jax_dyn_quant_rows(c, dt):
    """`dyn_quant_rows` and E4's plain version (`row_quant`, also padded to
    a [17, K'] operand) against JAX's `_dyn_quant_rows` on the
    same rows in the same dtype, codes and scales bit for bit, ties and
    the zero row included; the padding is zeros."""
    tdt, jdt = DTYPES[dt]
    x = _rows_with_edges(3, 12, c)
    xt = torch.from_numpy(x).to(tdt)
    jq, js = (np.asarray(a) for a in jax_dyn_quant_rows(jnp.asarray(x, jdt)))
    q, s = dyn_quant_rows(xt)
    assert q.dtype == torch.int8 and s.shape == (12, 1)
    np.testing.assert_array_equal(q.numpy(), jq)
    np.testing.assert_array_equal(s.numpy(), js)
    assert s[0, 0] == np.float32(1e-8) and not q[0].any()
    assert s[1, 0] == 1.0 and q[1, :7].tolist() == [127, 2, -4, 0, 0, 2, 126]
    assert torch.equal(q[2], -q[1])
    ldq = c + (-c % 8)
    pq, ps = row_quant(xt, PAD_ROWS, ldq)
    assert pq.shape == (PAD_ROWS, ldq) and ps.shape == (17, 1)
    np.testing.assert_array_equal(pq[:12, :c].numpy(), jq)
    np.testing.assert_array_equal(ps[:12].numpy(), js)
    assert not pq[12:].any() and not pq[:, c:].any() and not ps[12:].any()
    assert all(torch.equal(a, b) for a, b in
               zip(row_quant_ref(xt, PAD_ROWS, ldq), (pq, ps)))


def _jax_int8_matmul_quantization(monkeypatch, x):
    """The codes and row scales inside JAX's `int8_matmul` on x: its
    product is replaced by one that records the codes and returns ones, so
    with unit channel scales and no bias its output is the row scales."""
    seen = {}

    def ones_product(x_q, w_q, dims, **kwargs):
        seen["codes"] = np.asarray(x_q)
        return jnp.ones((x_q.shape[0], w_q.shape[1]), jnp.int32)

    monkeypatch.setattr(jax.lax, "dot_general", ones_product)
    k = x.shape[-1]
    out = jax_quant.int8_matmul(x, jnp.zeros((k, 8), jnp.int8),
                                jnp.ones(8, jnp.float32),
                                out_dtype=jnp.float32)
    return seen["codes"], np.asarray(out)[:, :1]


@pytest.mark.parametrize("c,dt", E4_CASES,
                         ids=[f"{c}-{d}" for c, d in E4_CASES])
def test_e4_plain_is_bit_equal_to_jax_int8_matmul_quantization(
        monkeypatch, c, dt):
    """E4's plain version against the quantization inside JAX's
    `hirest_tpu/ops/quant.py::int8_matmul` (the unrolled int8 tower's),
    codes and scales bit for bit."""
    tdt, jdt = DTYPES[dt]
    x = _rows_with_edges(4, 21, c)
    jq, js = _jax_int8_matmul_quantization(monkeypatch, jnp.asarray(x, jdt))
    q, s = row_quant(torch.from_numpy(x).to(tdt))
    np.testing.assert_array_equal(q.numpy(), jq)
    np.testing.assert_array_equal(s.numpy(), js)


@pytest.mark.parametrize("k,n", [(PATCH, C), (C, EMBED), (C, QKV)],
                         ids=["patch", "head", "qkv"])
def test_int8_matmul_matches_jax(k, n):
    """`int8_matmul` (QuantDense's call: E4, then the padded product and
    its epilogue, G1's plain version) on 5 rows against JAX's
    `int8_matmul` in f32: within an f32 rounding; the codes it pads to
    K' = 592 add nothing."""
    rng = _rng(5)
    w = rng.normal(size=(n, k)).astype(np.float32) * 0.02
    x = (rng.normal(size=(5, k)) * 2).astype(np.float32)
    bias = rng.normal(size=n).astype(np.float32)
    dense = quant.QuantDense(torch.from_numpy(w), torch.from_numpy(bias),
                             torch.float32)
    jw_q, jw_s = jax_quant.quantize_weight(w.T)
    want = np.asarray(jax_quant.int8_matmul(
        jnp.asarray(x), jw_q, jw_s, jnp.asarray(bias), jnp.float32))
    got = dense(torch.from_numpy(x))
    assert dense.w_q.shape[1] % 8 == 0 and got.shape == (5, n)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


# --- the CUDA wrappers' shape rules, at EVA-g's widths ---------------------

# EVA-g's shapes at B = 128 (M = 128 x 257): every E3 (the accumulator,
# the out dtype) and E4 (rows, row stride, codes' width, rows written) call
EVA_G_E3 = [(32896, QKV), (32896, C), (32896, F), (128, EMBED), (128, C)]
EVA_G_E4 = [((32896, C), C, C, 32896), ((32896, F), F, F, 32896),
            ((32768, PATCH), PATCH, 592, 32768), ((128, C), 257 * C, C, 128),
            ((2, C), 257 * C, C, 2)]


@pytest.mark.parametrize("dt", DTYPES)
def test_shape_rules_take_eva_g_shapes(dt):
    tdt = DTYPES[dt][0]
    for shape in EVA_G_E3:
        assert int8_epilogue_shape(tdt, shape) == shape
    for shape, stride, ldq, rows in EVA_G_E4:
        assert row_quant_shape(tdt, shape, stride, True, ldq, rows) == shape


def test_shape_rules_refuse_what_the_kernels_do_not_take():
    bf16 = torch.bfloat16
    for call in (lambda: int8_epilogue_shape(torch.float16, (4, C)),
                 lambda: int8_epilogue_shape(bf16, (2, 4, C)),
                 lambda: int8_epilogue_shape(bf16, (4, C), False),
                 lambda: int8_epilogue_shape(bf16, (4, C), True, False),
                 lambda: row_quant_shape(torch.float16, (4, C), C),
                 lambda: row_quant_shape(bf16, (4, C), C + 2),
                 lambda: row_quant_shape(bf16, (4, C), C, False)):
        with pytest.raises(TypeError):
            call()
    for call in (lambda: int8_epilogue_shape(bf16, (4, 1406)),
                 lambda: int8_epilogue_shape(bf16, (4, 8196)),
                 lambda: int8_epilogue_shape(bf16, (2 ** 20, 4096)),
                 lambda: row_quant_shape(bf16, (4, 590), 592),
                 lambda: row_quant_shape(bf16, (4, 8196), 8196),
                 lambda: row_quant_shape(bf16, (4, PATCH), PATCH, True, 590),
                 lambda: row_quant_shape(bf16, (4, C), C, True, C, 3)):
        with pytest.raises(ValueError):
            call()


# E4's route for each EVA_G_E4 call in bf16: the trunk's rows, the MLP's,
# the patch rows (1,176 bytes apart: no bulk copy), the head's class-token
# rows at B = 128 and 2
EVA_G_E4_ROUTES = ["ring", "ring", "rows", "ring", "ring"]


@pytest.mark.parametrize("dt", DTYPES)
def test_e4_route_takes_eva_g_rows(dt):
    tdt = DTYPES[dt][0]
    for (shape, stride, ldq, _), want in zip(EVA_G_E4, EVA_G_E4_ROUTES):
        assert row_quant_route(tdt, shape, stride, True, ldq) == (
            want if dt == "bf16" else "rows")


# rows row_quant_shape takes that the ring does not: (shape, row stride,
# first row 16-byte aligned, codes' width)
E4_OFF_RING = {"first row 8-byte aligned": ((4, C), C, False, C),
               "rows 8 bytes short of 16 apart": ((4, C), C + 4, True, C),
               "C % 16 != 0": ((4, 1400), 1400, True, 1408),
               "codes 8 bytes short of 16 apart": ((4, C), C, True, C + 8)}


@pytest.mark.parametrize("case", E4_OFF_RING)
def test_e4_route_keeps_what_a_bulk_copy_cannot_take_off_the_ring(case):
    shape, stride, aligned16, ldq = E4_OFF_RING[case]
    bf16 = torch.bfloat16
    assert row_quant_shape(bf16, shape, stride, True, ldq) == shape
    assert row_quant_route(bf16, shape, stride, aligned16, ldq) == "rows"


def _eva_g(cfg) -> dict:
    """The small config's widths -> EVA-g's: trunk, MLP, qkv, head out,
    patch rows."""
    p = cfg.patch_size
    widths = {cfg.width: C, cfg.mlp_hidden: F, 3 * cfg.width: QKV,
              cfg.embed_dim: EMBED, p * p * 3: PATCH}
    assert len(widths) == 5  # no two widths of the small config coincide
    return widths


def _record(monkeypatch, module, attr, record):
    fn = getattr(module, attr)

    def recorded(*args, **kwargs):
        record(*args, **kwargs)
        return fn(*args, **kwargs)

    monkeypatch.setattr(module, attr, recorded)


def _hold_e3(calls, widths, acc_shape, out_dtype, residual, dtype):
    m, n = acc_shape
    assert out_dtype == dtype
    assert residual is None or (residual.dtype == dtype
                                and tuple(residual.shape) == (m, n)
                                and residual.is_contiguous())
    calls.append(int8_epilogue_shape(out_dtype, (m, widths[n])))


def _hold_e4(calls, widths, x2, rows, ldq, dtype, routes=None):
    """E4's call on the rows x2 [M, c] at EVA-g's c, with their row stride
    and the codes' width scaled alike; its kernel (`row_quant_route`) into
    routes."""
    m, c = x2.shape
    big = widths[c]
    stride = x2.stride(0) // c * big if m > 1 else big
    ldq = big if ldq is None else big + (ldq - c)
    assert x2.dtype == dtype and x2.stride(-1) == 1
    calls.append(row_quant_shape(x2.dtype, (m, big), stride,
                                 x2.data_ptr() % 16 == 0, ldq, rows))
    if routes is not None:
        routes.append((big, row_quant_route(x2.dtype, (m, big), stride,
                                            x2.data_ptr() % 16 == 0, ldq)))


def _hold_k3(calls, qkv, heads, quant_out, dtype, width):
    """A K3 or K9 call of the scanned block at EVA-g's qkv width and heads
    (the small config's heads of `width` / heads each): its epilogue by
    `qkv3_shape`, or "f32 body" where qkv is f32 (the wrappers send f32 to
    attention_f32.cu before attention_qkv3.cu's rule)."""
    b, s, three_hd = qkv.shape
    assert qkv.dtype == dtype and three_hd == 3 * width
    if not quant_out:
        return
    shape = (b, s, 3 * QKV3_CLUSTER_HEADS * 88)
    if dtype == torch.float32:
        with pytest.raises(TypeError):
            qkv3_shape(dtype, shape, QKV3_CLUSTER_HEADS, True)
        calls.append("f32 body")
        return
    calls.append(qkv3_shape(dtype, shape, QKV3_CLUSTER_HEADS, True,
                            qkv.is_contiguous(), qkv.data_ptr() % 16 == 0))


def _hold_k5(calls, widths, x, dtype):
    """dyn_quant_rows' call: K5's rule (act_quant, act none) at EVA-g's
    width."""
    assert x.dtype == dtype
    calls.append(row_kernel_shape("act_quant", x.dtype,
                                  (*x.shape[:-1], widths[x.shape[-1]]),
                                  x.is_contiguous(),
                                  x.data_ptr() % 16 == 0))


INT8_LADDER = {"int8": dict(int8=True),
               "int8+fq": dict(int8=True, fused_quant=True),
               "int8+fq+v2": dict(int8=True, fused_quant=True, attn_v2=True),
               "int8+fq+v3": dict(int8=True, fused_quant=True, attn_v3=True),
               "int8+fq+v3+fm": dict(int8=True, fused_quant=True,
                                     attn_v3=True, fused_mlp=True)}
# int8 products, dyn_quant_rows (K5 none) calls and K3 / K9 int8 calls a
# block makes in each
PER_BLOCK = {"int8": (4, 4, 0), "int8+fq": (4, 0, 0),
             "int8+fq+v2": (4, 0, 1), "int8+fq+v3": (4, 0, 1),
             "int8+fq+v3+fm": (2, 0, 1)}
RULE_CASES = [(name, dt) for name in INT8_LADDER for dt in DTYPES]


@pytest.mark.parametrize("name,dt", RULE_CASES,
                         ids=[f"{n}-{d}" for n, d in RULE_CASES])
def test_shape_rules_take_every_scanned_int8_call(monkeypatch, name, dt):
    """Every int8 product's epilogue (each `int8_mm` call, whose [M, N]
    accumulator E3 would dequantize) and every row quantization
    (`dyn_quant_rows`, K5 without an activation on the card) of each int8
    configuration of the scanned forward, in bf16 and f32, recorded on the
    CPU and held to the CUDA wrappers' rules as it would come at EVA-g's
    widths: the same dtype, leading dims, contiguity and alignment, each
    width EVA-g's. Every int8-out attention call of v2 and v3 (K9, K3) too:
    at EVA-g's 16 heads its bf16 calls take the cluster epilogue, its f32
    ones the f32 body. (tests/test_torch_int8_gemm.py holds the same calls
    to G1's rule.)"""
    tdt = DTYPES[dt][0]
    cfg = configs(PACKED)[1]
    widths = _eva_g(cfg)
    e3, k5, k3 = [], [], []
    for attr in ("fused_attention_qkv3", "fused_attention_qkv2"):
        _record(monkeypatch, eva_clip, attr,
                lambda qkv, scale, heads, quant_out=False, n_real=0:
                _hold_k3(k3, qkv, heads, quant_out, tdt, cfg.width))
    _record(monkeypatch, eva_scan, "int8_mm",
            lambda x_q, x_s, w_q, w_s, bias, out_dtype, residual=None:
            _hold_e3(e3, widths, (x_q.shape[0], w_q.shape[0]), out_dtype,
                     residual, tdt))
    _record(monkeypatch, eva_scan, "dyn_quant_rows",
            lambda x: _hold_k5(k5, widths, x, tdt))
    sd, im = eva_state_dict(PACKED, seed=60), images(PACKED, 2, seed=60)
    out = eva_scan.build_scanned_vision_apply(
        sd, configs(PACKED)[1], device="cpu", dtype=tdt,
        **INT8_LADDER[name])(im)
    assert torch.isfinite(out).all()
    n3, n5, nq = PER_BLOCK[name]
    assert (len(e3), len(k5), len(k3)) == (n3 * PACKED["layers"],
                                           n5 * PACKED["layers"],
                                           nq * PACKED["layers"])
    assert set(k3) <= {"cluster" if dt == "bf16" else "f32 body"}


@pytest.mark.parametrize("quant_attention", [True, False],
                         ids=["quant_attention", "bf16_qkv_out"])
@pytest.mark.parametrize("dt", DTYPES)
def test_shape_rules_take_every_unrolled_int8_call(monkeypatch, dt,
                                                   quant_attention):
    """Every E4 call and every product's epilogue (each `int8_mm` call,
    whose [M, N] accumulator E3 would dequantize) of the unrolled int8
    tower (QuantDense: the patch rows, 588 wide into 592-wide codes; the
    trunk's products; the head on the class tokens, rows 257 x C apart),
    recorded on the CPU and held to the CUDA wrappers' rules at EVA-g's
    widths. In bf16 every E4 call but the patch rows' takes the bulk-copy
    ring (the trunk's 1408 and 6144 and the head's strided rows); the patch
    rows and every f32 call take row_quant_kernel."""
    tdt = DTYPES[dt][0]
    widths = _eva_g(configs(PACKED)[1])
    e3, e4, routes = [], [], []
    _record(monkeypatch, quant, "int8_mm",
            lambda x_q, x_s, w_q, w_s, bias, out_dtype, residual=None:
            _hold_e3(e3, widths, (x_q.shape[0], w_q.shape[0]), out_dtype,
                     residual, tdt))
    _record(monkeypatch, quant, "row_quant",
            lambda x2, rows=None, ldq=None:
            _hold_e4(e4, widths, x2, rows, ldq, tdt, routes))
    sd, im = eva_state_dict(PACKED, seed=61), images(PACKED, 2, seed=61)
    out = eva_quant.build_int8_vision_apply(
        sd, configs(PACKED)[1], quant_attention=quant_attention, dtype=tdt,
        device="cpu")(im)
    assert torch.isfinite(out).all()
    per_layer = 4 if quant_attention else 2
    assert len(e3) == len(e4) == per_layer * PACKED["layers"] + 2
    assert (2, C) in e4 and (8, PATCH) in e4  # the head's, the patches'
    rows = [w for w, route in routes if route == "rows"]
    assert rows == ([PATCH] if dt == "bf16" else [w for w, _ in routes])


# --- CPU calls, and devices without kernels --------------------------------


def _counts():
    return [getattr(fn, attr) for fn in (int8_epilogue, row_quant,
                                         act_quant)
            for attr in ("launches", "launches_f32")]


def test_cpu_calls_take_plain_versions_without_counting():
    x_q, x_s, w_q, w_s, bias, res = (torch.from_numpy(a) for a in
                                     _acc_inputs(6, 20, 64, k=32))
    before = _counts()
    acc = torch._int_mm(x_q, w_q.t())
    wq, ws = quantize_weight(torch.from_numpy(_rng(7).normal(
        size=(8, 64)).astype(np.float32)))
    for dtype in (torch.bfloat16, torch.float32):
        r = res.to(dtype)
        assert torch.equal(int8_epilogue(acc, x_s, w_s, bias, dtype, r),
                           int8_epilogue_ref(acc, x_s, w_s, bias, dtype, r))
        for got, want in ((dyn_quant_rows(r), dyn_quant_rows_ref(r)),
                          (row_quant(r, 24, 68), row_quant_ref(r, 24, 68))):
            assert all(torch.equal(a, b) for a, b in zip(got, want))
        q, s = row_quant_ref(r[:5], PAD_ROWS)
        want = int8_epilogue_ref(torch._int_mm(q, wq.t()), s, ws, None,
                                 dtype)[:5]
        assert torch.equal(int8_matmul(r[:5], wq, ws, out_dtype=dtype),
                           want)
    assert _counts() == before


def test_wrappers_raise_on_a_device_without_kernels():
    """No silent fallback: a tensor neither on the CPU nor on CUDA raises
    instead of taking the plain version."""
    acc = torch.empty((4, C), dtype=torch.int32, device="meta")
    x_s = torch.empty((4, 1), device="meta")
    w_s = torch.empty(C, device="meta")
    x = torch.empty((4, C), dtype=torch.bfloat16, device="meta")
    w_q = torch.empty((C, C), dtype=torch.int8, device="meta")
    for call in (lambda: int8_epilogue(acc, x_s, w_s, None, torch.bfloat16),
                 lambda: row_quant(x), lambda: dyn_quant_rows(x),
                 lambda: int8_matmul(x, w_q, w_s)):
        with pytest.raises(ValueError, match="no kernel"):
            call()
