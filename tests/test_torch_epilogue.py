"""The scanned block's projection epilogues (hirest_tpu_torch/ops/epilogue.py:
E1 `bias_act`, E2 `bias_residual`) on the CPU.

The plain versions against the JAX package's own expressions for the same
work (hirest_tpu/models/eva_scan.py:310, :342, :347, :350-351), which XLA
fused into the dots on the TPU, at EVA-g's widths; the input check the
CUDA wrappers run (`epilogue_shape`) against every call the bf16 and f32
blocks make; which epilogue each block calls. The kernels themselves run
only on the card: chip_smoke.py holds them against these plain versions.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import (PACKED, TINY, TINY224, configs, eva_state_dict,
                             images)

import hirest_tpu_torch.models.eva_clip as eva_clip
import hirest_tpu_torch.models.eva_scan as eva_scan
from hirest_tpu.models.layers import gelu as jax_gelu
from hirest_tpu.models.layers import gelu_bf16_poly as jax_gelu_poly
from hirest_tpu_torch.extraction.features import make_eva_encoder
from hirest_tpu_torch.models.eva_clip import BlockOptions, layer_norm, linear
from hirest_tpu_torch.models.eva_pad import pad_vision_head_params
from hirest_tpu_torch.models.eva_scan import (build_scanned_vision_apply,
                                              stage_scanned_params)
from hirest_tpu_torch.models.layers import gelu, gelu_bf16_poly
from hirest_tpu_torch.ops.epilogue import (bias_act, bias_act_ref,
                                           bias_residual, bias_residual_ref,
                                           epilogue_shape)

DTYPES = {"bf16": (torch.bfloat16, jnp.bfloat16),
          "f32": (torch.float32, jnp.float32)}
EVA_G_WIDTHS = (1408, 4224, 6144)  # proj/fc2 out, qkv (16 x 88 x 3), fc1
ROWS = 6
# a value that ties when added to 1 or 1 + ulp in each dtype: half an ulp of 1
HALF_ULP = {"bf16": 2.0 ** -8, "f32": 2.0 ** -24}
GELU_CLAMP = 4.1 * 2 ** 0.5  # |x| past which gelu_bf16_poly's erf saturates


def _inputs(dtype: str, c: int, seed: int):
    """y [ROWS, c], b [c], x [ROWS, c] as f32 arrays exact in `dtype`:
    normal values at 3 (a share past the GELU clamp), exact zeros, values
    at +-6 and +-9 (past the clamp), and columns where y + b and x + (y +
    b) tie between two values of the dtype (1 or 1 + ulp plus half an
    ulp, either sign)."""
    torch_dt = DTYPES[dtype][0]
    rng = np.random.default_rng(seed)
    y = rng.standard_normal((ROWS, c)) * 3
    b = rng.standard_normal(c) * 0.5
    x = rng.standard_normal((ROWS, c)) * 2
    y[0, :96] = 0.0  # zero products; zero sums where b is zero too
    b[64:96] = 0.0
    y[1, :16] = [6.0, -6.0, 9.0, -9.0] * 4
    half, one_up = HALF_ULP[dtype], 1.0 + 2 * HALF_ULP[dtype]
    ties = np.array([1.0, one_up, -1.0, -one_up] * 8)
    y[2:, 96:128] = ties
    b[96:128] = np.sign(ties) * half
    # x + t ties where t is the rounded tie sum and x = half an ulp more
    x[2:, 128:160] = np.array([half, -half] * 16)
    y[2:, 128:160] = 1.0
    b[128:160] = 0.0

    def exact(a):
        return torch.from_numpy(a.astype(np.float32)).to(
            torch_dt).float().numpy()

    return exact(y), exact(b), exact(x)


def _pair(a, dtype: str):
    """a as a tensor and a JAX array of its own (the plain versions write
    into their y)."""
    torch_dt, jax_dt = DTYPES[dtype]
    return torch.tensor(a).to(torch_dt), jnp.array(a, jax_dt)


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(t.astype(jnp.float32))


@pytest.mark.parametrize("c", EVA_G_WIDTHS)
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("what", ["gelu_poly", "none", "residual"])
def test_plain_versions_equal_jax_expressions(what, dtype, c):
    """E1 with gelu_poly is `gelu_bf16_poly(y + b)` (eva_scan.py:350), E1
    with none is `qkv + _bias3` (:310), E2 is `x + (y + b)` (:347, :351):
    bit for bit, each step rounded where JAX rounds it."""
    y, b, x = _inputs(dtype, c, seed=c)
    (ty, jy), (tb, jb), (tx, jx) = (_pair(a, dtype) for a in (y, b, x))
    if what == "residual":
        got, want = bias_residual_ref(ty, tb, tx), jx + (jy + jb)
    elif what == "none":
        got, want = bias_act_ref(ty, tb, act="none"), jy + jb
    else:
        got = bias_act_ref(ty, tb, act="gelu_poly")
        want = jax_gelu_poly(jy + jb)
    assert got.dtype == DTYPES[dtype][0] and got.shape == (ROWS, c)
    assert np.array_equal(_np(got), _np(want))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_inputs_reach_the_clamp_zeros_and_ties(dtype):
    """The inputs above hold what they claim: sums past the GELU clamp,
    exact zeros, and bias sums that tie and round to even."""
    y, b, x = _inputs(dtype, 1408, seed=1408)
    t = bias_act_ref(*(_pair(a, dtype)[0] for a in (y, b)), act="none")
    t = t.float().numpy()
    assert (np.abs(t) > GELU_CLAMP).mean() > 0.01 and (t == 0).any()
    # 1 + half an ulp rounds down to 1, (1 + ulp) + half an ulp up to
    # 1 + 2 ulps: the even neighbour either way
    tie_y = y[2:, 96:128]
    want = np.where(np.abs(tie_y) == 1.0, 1.0, 1.0 + 4 * HALF_ULP[dtype])
    assert np.array_equal(np.abs(t[2:, 96:128]), want)


@pytest.mark.parametrize("c", EVA_G_WIDTHS)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plain_exact_gelu_within_one_ulp_of_jax(dtype, c):
    """E1 with the exact GELU against `jax.nn.gelu(y + b)` (the JAX
    package's `gelu`, fast_gelu=False): F.gelu and jax.nn.gelu compute erf
    differently and JAX rounds each bf16 step, so within one bf16 ulp of
    the largest value (f32: 1e-6 of it); the bias sum bit for bit."""
    y, b, _ = _inputs(dtype, c, seed=c + 1)
    (ty, jy), (tb, jb) = _pair(y, dtype), _pair(b, dtype)
    got, want = _np(bias_act_ref(ty, tb, act="gelu")), _np(jax_gelu(jy + jb))
    top = np.abs(want).max()
    tol = (2.0 ** (np.floor(np.log2(top)) - 7) if dtype == "bf16"
           else 1e-6 * top)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def test_plain_versions_are_the_blocks_former_code():
    """The plain versions compute what the block computed before the
    epilogues: `linear` (the product, then the bias in its dtype), then
    gelu_bf16_poly, gelu or nothing; `x + linear(...)`. Bit for bit in bf16
    and f32; without a bias E1 is the activation alone."""
    g = torch.Generator().manual_seed(0)
    for dtype in (torch.bfloat16, torch.float32):
        h = torch.randn(7, 64, generator=g).to(dtype)
        w = (torch.randn(96, 64, generator=g) * 0.2).to(dtype)
        b = torch.randn(96, generator=g).to(dtype)
        x = torch.randn(7, 96, generator=g).to(dtype)
        for act, fn in (("gelu_poly", gelu_bf16_poly), ("gelu", gelu),
                        ("none", lambda v: v)):
            want = fn(linear(h, w, b))
            assert torch.equal(bias_act_ref(h @ w.t(), b, act=act), want)
            assert torch.equal(bias_act(h @ w.t(), b, act=act), want)
            assert torch.equal(bias_act(h @ w.t(), act=act), fn(h @ w.t()))
        want = x + linear(h, w, b)
        assert torch.equal(bias_residual_ref(h @ w.t(), b, x), want)
        assert torch.equal(bias_residual(h @ w.t(), b, x), want)


def test_wrappers_take_the_plain_version_only_on_the_cpu():
    """A CPU tensor takes the plain version and counts no launch; a tensor
    on another device than the CPU or a card raises (no fallback), as does
    an unknown activation."""
    before = (bias_act.launches, bias_act.launches_f32,
              bias_residual.launches, bias_residual.launches_f32)
    y = torch.ones(2, 8)
    bias_act(y.clone(), torch.ones(8))
    bias_residual(y.clone(), torch.ones(8), y)
    assert before == (bias_act.launches, bias_act.launches_f32,
                      bias_residual.launches, bias_residual.launches_f32)
    meta = torch.empty(2, 8, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        bias_act(meta, torch.empty(8, device="meta"))
    with pytest.raises(ValueError, match="no kernel"):
        bias_residual(meta, torch.empty(8, device="meta"), meta)
    with pytest.raises(ValueError, match="act must be"):
        bias_act(y.clone(), act="relu")


# --- which epilogue each block calls, and the shapes it hands them ---------

# case -> (spec, flags, (E1 calls by activation, E2 calls) a block)
EPILOGUES = {
    "bf16 v1": (PACKED, {}, ({"gelu_poly": 1}, 2)),
    "bf16 v2": (PACKED, dict(attn_v2=True), ({"none": 1, "gelu_poly": 1}, 2)),
    "bf16 v3+lnk": (PACKED, dict(attn_v3=True, fused_ln=True),
                    ({"none": 1, "gelu_poly": 1}, 2)),
    "bf16 v3 erf": (PACKED, dict(attn_v3=True, fast_gelu=False),
                    ({"none": 1, "gelu": 1}, 2)),
    "split v3": (TINY, dict(attn_v3=True), ({"gelu_poly": 1}, 2)),
    "int8 dyn": (PACKED, dict(int8=True), ({"gelu_poly": 1}, 0)),
    "int8 dyn erf": (PACKED, dict(int8=True, fast_gelu=False),
                     ({"gelu": 1}, 0)),
    "int8 fq v3": (PACKED, dict(int8=True, fused_quant=True, attn_v3=True),
                   ({}, 0)),
    "int8 fq v3 fm": (PACKED, dict(int8=True, fused_quant=True, attn_v3=True,
                                   fused_mlp=True), ({}, 0)),
}


def _record(monkeypatch, calls: list):
    """Record every epilogue call the blocks make: (name, act, y's dtype,
    shape, contiguous, aligned, and each other operand's dtype, shape and
    layout)."""

    def layout(t):
        return (t.dtype, tuple(t.shape), t.is_contiguous(),
                t.data_ptr() % 16 == 0)

    def wrap(module, name):
        fn = getattr(module, name)

        def recorded(y, *args, **kwargs):
            act = kwargs.get("act", "gelu_poly") if name == "bias_act" else ""
            others = tuple(layout(a) for a in args if a is not None)
            calls.append((name, act, *layout(y), others))
            return fn(y, *args, **kwargs)

        monkeypatch.setattr(module, name, recorded)

    wrap(eva_clip, "bias_act")
    wrap(eva_clip, "bias_residual")
    wrap(eva_scan, "bias_act")


def _tally(calls) -> tuple:
    e1 = {}
    for name, act, *_ in calls:
        if name == "bias_act":
            e1[act] = e1.get(act, 0) + 1
    return e1, sum(name == "bias_residual" for name, *_ in calls)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", list(EPILOGUES))
def test_each_block_calls_its_epilogues(monkeypatch, case, dtype):
    """Per block: E1 twice with v2/v3 (qkv bias, fc1) and once with v1 or
    split heads (fc1), E2 twice (proj, fc2); int8 dyn E1 once (its GELU),
    the fused int8 paths none. In f32 and bf16."""
    spec, flags, (e1, e2) = EPILOGUES[case]
    calls = []
    _record(monkeypatch, calls)
    build_scanned_vision_apply(eva_state_dict(spec, seed=60), configs(spec)[1],
                               device="cpu", dtype=DTYPES[dtype][0],
                               **flags)(images(spec, 1, seed=60))
    layers = spec["layers"]
    assert _tally(calls) == ({k: v * layers for k, v in e1.items()},
                             e2 * layers)
    assert {c[2] for c in calls} <= {DTYPES[dtype][0]}


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_production_encoder_epilogues(monkeypatch, tmp_path, int8):
    """make_eva_encoder: the bf16 production forward (v3) calls E1 and E2
    twice a layer each, 80 of each over EVA-g's 40 layers beside its 40 K1;
    the int8 one (K2, K3, K4) none."""
    cfg = configs(TINY224)[1]
    enc, _ = make_eva_encoder(str(tmp_path), int8=int8, device="cpu",
                              cfg=cfg, dtype_name="float32")
    calls = []
    _record(monkeypatch, calls)
    enc(images(TINY224, 1))
    want = ({}, 0) if int8 else ({"none": cfg.layers,
                                  "gelu_poly": cfg.layers}, 2 * cfg.layers)
    assert _tally(calls) == want


def _eva_g_calls(calls, spec, padded: bool):
    """Each recorded call as it comes at EVA-g's widths: the trunk's width
    1408, the MLP's 6144, the qkv projection's 3 x 16 x 88 = 4224, or with
    padded heads 3 x 16 x 128 = 6144."""
    width, hidden = spec["width"], int(spec["width"] * spec["mlp_ratio"])
    heads = width // spec["head_width"]
    qkv = 3 * heads * (128 if padded else spec["head_width"])
    to_g = {width: 1408, hidden: 6144, qkv: 6144 if padded else 4224}

    def g(shape):
        return (*shape[:-1], to_g[shape[-1]])

    for name, act, dtype, shape, contiguous, aligned, others in calls:
        yield (dtype, g(shape), contiguous, aligned,
               [(d, g(s), c, a) for d, s, c, a in others])


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("padded", [False, True], ids=["unpadded", "padded"])
def test_epilogue_shape_takes_every_block_call(monkeypatch, dtype, padded):
    """The CUDA wrappers' input check takes every epilogue call the blocks
    make (bf16 v1, v2, v3 with K10, int8 dyn; the factory's padded-heads
    v3) as it would come at EVA-g's widths: y, the bias of y's dtype and
    C values, the residual shaped like y, all contiguous and aligned."""
    torch_dt = DTYPES[dtype][0]
    spec = PACKED
    sd, cfg = eva_state_dict(spec, seed=61), configs(spec)[1]
    if padded:
        sd, cfg = pad_vision_head_params(sd, cfg)
    calls = []
    _record(monkeypatch, calls)
    runs = ([dict(attn_v3=True)] if padded else
            [{}, dict(attn_v2=True), dict(attn_v3=True, fused_ln=True),
             dict(int8=True)])
    for flags in runs:
        build_scanned_vision_apply(sd, cfg, device="cpu", dtype=torch_dt,
                                   **flags)(images(spec, 2, seed=61))
    assert calls
    widths = set()
    for dt, shape, contiguous, aligned, others in _eva_g_calls(
            calls, spec, padded):
        m, c = epilogue_shape(dt, shape, contiguous, aligned)
        widths.add(c)
        for odt, oshape, ocontiguous, oaligned in others:
            assert odt == dt and oshape in ((c,), shape)
            epilogue_shape(odt, (1, *oshape) if len(oshape) == 1 else oshape,
                           ocontiguous, oaligned)
    assert widths == ({1408, 6144} if padded else {1408, 4224, 6144})


@pytest.mark.parametrize("dtype,shape,contiguous,aligned,error", [
    (torch.float16, (257, 1408), True, True, TypeError),
    (torch.bfloat16, (257, 1408), False, True, TypeError),
    (torch.bfloat16, (257, 1408), True, False, TypeError),
    (torch.float32, (1408,), True, True, TypeError),
    (torch.bfloat16, (257, 1404), True, True, ValueError),
    (torch.bfloat16, (257, 1409), True, True, ValueError),
    (torch.float32, (257, 1406), True, True, ValueError),
    (torch.bfloat16, (257, 8200), True, True, ValueError),
    (torch.bfloat16, (2 ** 20, 4096), True, True, ValueError),
], ids=["f16", "non-contiguous", "unaligned", "1-d", "bf16 C%8", "odd C",
        "f32 C%4", "too wide", "2^31 values"])
def test_epilogue_shape_refuses(dtype, shape, contiguous, aligned, error):
    """What the kernels do not take raises: f16, a non-contiguous or
    unaligned tensor, a 1-d one, C off the form's vector (bf16 8, f32 4),
    C above 8192, 2^31 values or more."""
    with pytest.raises(error):
        epilogue_shape(dtype, shape, contiguous, aligned)


def test_epilogue_shape_edges():
    """The forms' own edges are taken: f32 at C % 4 where bf16 refuses it,
    the widest row, one row, and 3-d trunks as rows."""
    assert epilogue_shape(torch.float32, (257, 1404)) == (257, 1404)
    assert epilogue_shape(torch.bfloat16, (1, 8192)) == (1, 8192)
    assert epilogue_shape(torch.bfloat16, (128, 257, 6144)) == (32896, 6144)


@pytest.mark.parametrize("flags", [{}, dict(attn_v2=True),
                                   dict(attn_v3=True, fused_ln=True),
                                   dict(attn_v3=True, fast_gelu=False)],
                         ids=["v1", "v2", "v3+lnk", "v3 erf"])
def test_bf16_block_unchanged_by_the_epilogues(flags):
    """One bf16 block at PACKED's widths through the epilogues against the
    same block written as before them (`linear` with its bias, the GELU,
    `x + ...`, with the block's own attention): bit for bit."""
    from hirest_tpu_torch.models.eva_clip import (fused_layer_norm,
                                                  scanned_attention)

    spec = dict(PACKED, layers=1)
    sd, im = eva_state_dict(spec, seed=62), images(spec, 2, seed=62)
    tower, _ = stage_scanned_params(sd, configs(spec)[1],
                                    dtype=torch.bfloat16, device="cpu")
    blk = tower.blocks[0]
    attn, mlp = blk.attn, blk.mlp
    opts = BlockOptions(
        fast_gelu=flags.get("fast_gelu", True), fused_ln=flags.get(
            "fused_ln", False),
        attn="v3" if flags.get("attn_v3") else "v2" if flags.get(
            "attn_v2") else "v1")
    ln = fused_layer_norm if opts.fused_ln else layer_norm
    act = gelu_bf16_poly if opts.fast_gelu else gelu
    with torch.inference_mode():
        x = tower.embed(torch.as_tensor(im))
        got = blk(x, opts)
        bias = (torch.cat([attn.q_bias, torch.zeros_like(attn.q_bias),
                           attn.v_bias]) if opts.attn in ("v2", "v3")
                else None)
        qkv = linear(ln(x, blk.norm1), attn.qkv.weight, bias)
        want = x + linear(scanned_attention(qkv, attn.q_bias, attn.v_bias,
                                            attn.scale, attn.heads,
                                            opts.attn),
                          attn.proj.weight, attn.proj.bias)
        h = act(linear(ln(want, blk.norm2), mlp.fc1.weight, mlp.fc1.bias))
        want = want + linear(h, mlp.fc2.weight, mlp.fc2.bias)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want)
