"""The kernel flag configurations of the scanned forward
(hirest_tpu_torch/models/eva_scan.py::build_scanned_vision_apply) against
the JAX package's: the forward of each configuration, which wrapper each
block calls, and the staged-parameter guard.

The configurations are the JAX bench ladder's (bench.py:817-823) with the
TPU layout flags dropped. JAX runs its Pallas kernels in interpret mode;
the port's wrappers take their plain versions on CPU tensors.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import (PACKED, TEXT_TINY, TINY, TINY224, configs,
                             eva_state_dict, images, jax_params,
                             text_configs)

import hirest_tpu.models.eva_scan as jax_eva_scan
import hirest_tpu.ops.quant as jax_quant
import hirest_tpu_torch.models.eva_clip as eva_clip
import hirest_tpu_torch.models.eva_scan as eva_scan
from hirest_tpu.models.eva_scan import \
    build_scanned_vision_apply as jax_build
from hirest_tpu_torch.extraction.features import make_eva_encoder
from hirest_tpu_torch.models.eva_scan import (build_scanned_vision_apply,
                                              stage_scanned_params)

# configuration -> flags, as chip_smoke.py's ladder phase names them
LADDER = {
    "bf16": {},
    "bf16+v2": dict(attn_v2=True),
    "bf16+v3+lnk": dict(attn_v3=True, fused_ln=True),
    "int8": dict(int8=True),
    "int8+fq": dict(int8=True, fused_quant=True),
    "int8+fq+v2": dict(int8=True, fused_quant=True, attn_v2=True),
    "int8+fq+v3": dict(int8=True, fused_quant=True, attn_v3=True),
    "int8+v3": dict(int8=True, attn_v3=True),
}


def _jax(sd, spec, im, dtype=jnp.float32, **flags):
    return np.asarray(jax_build(jax_params(sd, spec), configs(spec)[0],
                                use_pallas=True, interpret=True,
                                dtype=dtype, **flags)(jnp.asarray(im)),
                      np.float32)


def _port(sd, spec, im, dtype=torch.float32, **flags):
    return build_scanned_vision_apply(sd, configs(spec)[1], device="cpu",
                                      dtype=dtype, **flags)(im).numpy()


# both GELUs where the configuration computes one outside a kernel or in
# K5: the fused-quant MLP without the fused kernel, and int8 dyn
GELUS = [(name, fast) for name in LADDER
         for fast in ((True, False) if name.startswith("int8") else (True,))]


@pytest.mark.parametrize("name,fast_gelu", GELUS,
                         ids=[f"{n}-{'poly' if f else 'erf'}"
                              for n, f in GELUS])
def test_configuration_matches_jax(name, fast_gelu):
    """Each configuration in f32 at PACKED (128 wide, so v2 and v3 take
    their kernels) against the JAX forward with the same flags: 2e-4 for
    the float ones (the JAX package's Pallas-vs-XLA bar,
    test_eva_scan.py:93), 2e-3 for int8 (its fused-quant bar,
    test_eva_scan.py:111): a code that lands on the other side of a
    rounding boundary moves an output by more than f32 rounding does."""
    flags = LADDER[name]
    sd, im = eva_state_dict(PACKED, seed=50), images(PACKED, 3, seed=50)
    want = _jax(sd, PACKED, im, fast_gelu=fast_gelu, **flags)
    got = _port(sd, PACKED, im, fast_gelu=fast_gelu, **flags)
    assert got.shape == (3, PACKED["embed_dim"]) and np.isfinite(got).all()
    tol = 2e-3 if flags.get("int8") else 2e-4
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def test_v1_and_v3_differ_and_v2_is_v3():
    """v1 is another function than v3 (in bf16, where p's rounding shows),
    while v2 computes v3's exactly."""
    sd, im = eva_state_dict(PACKED, seed=51), images(PACKED, 3, seed=51)
    run = {name: build_scanned_vision_apply(
        sd, configs(PACKED)[1], device="cpu", **flags)(im)
        for name, flags in (("v1", {}), ("v2", dict(attn_v2=True)),
                            ("v3", dict(attn_v3=True)))}
    assert torch.equal(run["v2"], run["v3"])
    assert not torch.equal(run["v1"], run["v3"])


# the configurations that run K8 (v1): bf16 and int8 dyn
K8_CONFIGS = ["bf16", "int8"]


@pytest.mark.parametrize("name", K8_CONFIGS)
def test_bf16_configuration_matches_jax_bf16(name):
    """The configurations that run K8 in bf16 at PACKED against the JAX
    forward in bf16 (its K8, `_attn_kernel_qkvfused`, in interpret mode),
    element by element: within 4 bf16 ulps of the output's largest
    magnitude, a bar per element where the f32 test above and the bf16
    cosine bar (test_torch_eva.py) say nothing of bf16 rounding. Not bit
    for bit: XLA's jit keeps some bf16 sums in f32 where an f32 op reads
    them (the fc1 bias add under gelu_bf16_poly's cast), which no eager
    order reproduces, so a few roundings land one ulp apart, and the next
    layers carry them. Against JAX's eager operations the block is bit for
    bit (test_bf16_block_and_head_match_jax_eager_ops)."""
    flags = LADDER[name]
    sd, im = eva_state_dict(PACKED, seed=54), images(PACKED, 3, seed=54)
    want = _jax(sd, PACKED, im, dtype=jnp.bfloat16, **flags)
    got = _port(sd, PACKED, im, dtype=torch.bfloat16, **flags)
    assert got.shape == (3, PACKED["embed_dim"]) and np.isfinite(got).all()
    top = np.abs(want).max()
    ulp = 2.0 ** (np.floor(np.log2(top)) - 7)
    np.testing.assert_allclose(got, want, rtol=0, atol=4 * ulp)


def test_bf16_block_and_head_match_jax_eager_ops():
    """The scanned bf16 forward (v1, K8, gelu_bf16_poly) cut to one block
    at PACKED's widths, its block and its head bit for bit against the JAX
    package's eager operations on the same bf16 operands: _ln, `@` and `+`
    (each projection's product rounded to bf16, then its bias added in
    bf16: eva_scan.py:310, :347, :350-351, :451), the K8 Pallas kernel in
    interpret mode and gelu_bf16_poly."""
    from hirest_tpu.models.eva_scan import _ln as jax_ln
    from hirest_tpu.models.layers import gelu_bf16_poly as jax_gelu
    from hirest_tpu.ops.attention import fused_attention_qkv as jax_qkv1
    from hirest_tpu_torch.models.eva_clip import BlockOptions

    spec = dict(PACKED, layers=1)
    sd, im = eva_state_dict(spec, seed=56), images(spec, 3, seed=56)
    tower, _ = stage_scanned_params(sd, configs(spec)[1],
                                    dtype=torch.bfloat16, device="cpu")
    blk = tower.blocks[0]
    attn, mlp = blk.attn, blk.mlp

    def to_jax(t):
        return jnp.asarray(t.detach().float().numpy(), jnp.bfloat16)

    def ln(x, norm):
        return jax_ln(x, to_jax(norm.weight), to_jax(norm.bias), norm.eps)

    def dense(h, layer):
        return h @ to_jax(layer.weight).T + to_jax(layer.bias)

    with torch.inference_mode():
        x = tower.embed(torch.as_tensor(im))
        got_x = blk(x, BlockOptions())
        got = tower(torch.as_tensor(im))
    xj = to_jax(x)
    qkv = ln(xj, blk.norm1) @ to_jax(attn.qkv.weight).T
    att = jax_qkv1(qkv, to_jax(attn.q_bias), to_jax(attn.v_bias),
                   attn.scale, attn.heads, interpret=True)
    xj = xj + dense(att, attn.proj)
    xj = xj + dense(jax_gelu(dense(ln(xj, blk.norm2), mlp.fc1)), mlp.fc2)
    want = dense(ln(xj, tower.norm)[:, 0], tower.head).astype(jnp.float32)
    assert np.array_equal(got_x.float().numpy(),
                          np.asarray(xj.astype(jnp.float32)))
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("step", ["k8_attention", "int8_dyn_gelu"])
def test_k8_path_steps_match_jax_bf16(step):
    """K8's own steps inside a bf16 block at PACKED, on that block's own
    bf16 operands, against JAX's: the v1 attention with its q/v bias adds
    and softmax (the plain version against the Pallas kernel in interpret
    mode) and gelu_bf16_poly on a bf16 fc1 output (what "int8 dyn" applies,
    eva_scan.py:342-344, outside jit). Equal bit for bit on 99.9 % of the
    outputs and within one bf16 ulp of the largest magnitude elsewhere (a p
    at a bf16 boundary may round the other way under another summation
    order of its row sum)."""
    from hirest_tpu.models.eva_scan import _ln as jax_ln
    from hirest_tpu.models.layers import gelu_bf16_poly as jax_gelu
    from hirest_tpu.ops.attention import fused_attention_qkv as jax_qkv1
    from hirest_tpu_torch.models.eva_clip import layer_norm
    from hirest_tpu_torch.models.layers import gelu_bf16_poly
    from hirest_tpu_torch.ops.attention import fused_attention_qkv

    sd, im = eva_state_dict(PACKED, seed=55), images(PACKED, 3, seed=55)
    tower, _ = stage_scanned_params(sd, configs(PACKED)[1],
                                    dtype=torch.bfloat16, device="cpu")
    blk = tower.blocks[0]

    def to_jax(t):
        return jnp.asarray(t.float().numpy(), jnp.bfloat16)

    with torch.inference_mode():
        x = tower.embed(torch.as_tensor(im))
        if step == "k8_attention":
            attn = blk.attn
            qkv = layer_norm(x, blk.norm1) @ attn.qkv.weight.t()
            got = fused_attention_qkv(qkv, attn.q_bias, attn.v_bias,
                                      attn.scale, attn.heads)
            want = jax_qkv1(to_jax(qkv), to_jax(attn.q_bias),
                            to_jax(attn.v_bias), attn.scale, attn.heads,
                            interpret=True)
        else:
            h = layer_norm(x, blk.norm2) @ blk.mlp.fc1.weight.t()
            got = gelu_bf16_poly(h)
            want = jax_gelu(to_jax(h))
            assert np.array_equal(
                np.asarray(jax_ln(to_jax(x), to_jax(blk.norm2.weight),
                                  to_jax(blk.norm2.bias), 1e-6)
                           .astype(jnp.float32)),
                layer_norm(x, blk.norm2).float().numpy())
    got = got.float().numpy()
    want = np.asarray(want.astype(jnp.float32))
    assert got.shape == want.shape
    assert np.mean(got == want) >= 0.999
    top = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2.0 ** (np.floor(np.log2(top)) - 7))


# --- which wrapper each block calls ----------------------------------------

# (spec, flags) -> the wrappers one block calls, and how often: JAX's
# dispatch (eva_scan.py:296-430). ":quant" marks an int8 epilogue,
# act_quant carries its activation; int8_mm is an int8 product and its
# epilogue (E3): 4 a block, 2 where fused_mlp_int8 takes fc1 and fc2.
DISPATCH = {
    "bf16": (PACKED, {}, {"fused_attention_qkv": 1}),
    "bf16+v2": (PACKED, dict(attn_v2=True), {"fused_attention_qkv2": 1}),
    "bf16+v3+lnk": (PACKED, dict(attn_v3=True, fused_ln=True),
                    {"fused_attention_qkv3": 1, "ln_bf16": 2}),
    "bf16+v2+v3": (PACKED, dict(attn_v2=True, attn_v3=True),
                   {"fused_attention_qkv3": 1}),
    "int8": (PACKED, dict(int8=True),
             {"fused_attention_qkv": 1, "dyn_quant_rows": 4, "int8_mm": 4}),
    "int8+lnk+fm": (PACKED, dict(int8=True, fused_ln=True, fused_mlp=True),
                    {"fused_attention_qkv": 1, "dyn_quant_rows": 4,
                     "int8_mm": 4}),
    "int8+v3": (PACKED, dict(int8=True, attn_v3=True),
                {"fused_attention_qkv3": 1, "dyn_quant_rows": 4,
                 "int8_mm": 4}),
    "int8+fq": (PACKED, dict(int8=True, fused_quant=True),
                {"ln_quant": 2, "fused_attention_qkv:quant": 1,
                 "act_quant:gelu_poly": 1, "int8_mm": 4}),
    "int8+fq+v2": (PACKED, dict(int8=True, fused_quant=True, attn_v2=True),
                   {"ln_quant": 2, "fused_attention_qkv2:quant": 1,
                    "act_quant:gelu_poly": 1, "int8_mm": 4}),
    "int8+fq+v3": (PACKED, dict(int8=True, fused_quant=True, attn_v3=True),
                   {"ln_quant": 2, "fused_attention_qkv3:quant": 1,
                    "act_quant:gelu_poly": 1, "int8_mm": 4}),
    "int8+fq+v3+erf": (PACKED, dict(int8=True, fused_quant=True,
                                    attn_v3=True, fast_gelu=False),
                       {"ln_quant": 2, "fused_attention_qkv3:quant": 1,
                        "act_quant:gelu": 1, "int8_mm": 4}),
    "int8+fq+v3+fm": (PACKED, dict(int8=True, fused_quant=True, attn_v3=True,
                                   fused_mlp=True),
                      {"ln_quant": 2, "fused_attention_qkv3:quant": 1,
                       "fused_mlp_int8": 1, "int8_mm": 2}),
    # head rows 64 wide: v2 and v3 fall back to v1 on split heads (K6)
    "unpacked+v3": (TINY, dict(attn_v3=True), {"fused_attention": 1}),
    "unpacked+int8+fq+v3": (TINY, dict(int8=True, fused_quant=True,
                                       attn_v3=True),
                            {"ln_quant": 2, "fused_attention": 1,
                             "act_quant:none": 1, "act_quant:gelu_poly": 1,
                             "int8_mm": 4}),
}

PORT_WRAPPERS = {eva_clip: ("fused_attention", "fused_attention_qkv",
                            "fused_attention_qkv2", "fused_attention_qkv3",
                            "act_quant", "ln_bf16"),
                 eva_scan: ("act_quant", "dyn_quant_rows", "fused_mlp_int8",
                            "int8_mm", "ln_quant")}
# JAX's names, module by module, and the port's name for each
JAX_WRAPPERS = {jax_eva_scan: {"fused_attention": "fused_attention",
                               "fused_attention_qkv": "fused_attention_qkv",
                               "fused_attention_qkv2": "fused_attention_qkv2",
                               "fused_attention_qkv3": "fused_attention_qkv3",
                               "_dyn_quant_rows": "dyn_quant_rows",
                               "_int8_mm": "int8_mm"},
                jax_quant: {n: n for n in ("act_quant", "ln_quant", "ln_bf16",
                                           "fused_mlp_int8")}}


ROW_WRAPPERS = ("act_quant", "ln_bf16", "ln_quant")  # the row kernels'


def _record(monkeypatch, module, attr, name, calls, rows=None):
    """Count the calls of module.attr under `name` in calls. A call made
    from inside another call of the same wrapper (JAX's quant wrappers
    take a [B, S, C] input by calling themselves on its [B*S, C] view)
    is not counted again. Where `rows` is a list, a call of a row kernel's
    wrapper also appends (key, its input's dtype name, shape, contiguous,
    16-byte aligned) to it (a JAX array: contiguous and aligned)."""
    fn = getattr(module, attr)
    inside = []

    def recorded(*args, **kwargs):
        if inside:
            return fn(*args, **kwargs)
        key = name
        if name == "act_quant":
            key += ":" + kwargs.get("act", "none")
        elif kwargs.get("quant_out"):
            key += ":quant"
        calls[key] = calls.get(key, 0) + 1
        if rows is not None and name in ROW_WRAPPERS:
            x = args[0]
            if isinstance(x, torch.Tensor):
                rows.append((key, str(x.dtype).removeprefix("torch."),
                             tuple(x.shape), x.is_contiguous(),
                             x.data_ptr() % 16 == 0))
            else:
                rows.append((key, str(x.dtype), tuple(x.shape), True, True))
        inside.append(key)
        try:
            return fn(*args, **kwargs)
        finally:
            inside.pop()

    monkeypatch.setattr(module, attr, recorded)


def _dispatch(monkeypatch, case, jax_dtype, port_dtype):
    """One forward of `case` through each package with every wrapper
    recorded -> (JAX's calls, the port's, JAX's row-kernel calls, the
    port's)."""
    spec, flags, _ = DISPATCH[case]
    sd, im = eva_state_dict(spec, seed=52), images(spec, 1, seed=52)
    jax_calls, jax_rows = {}, []
    for module, names in JAX_WRAPPERS.items():
        for attr, name in names.items():
            _record(monkeypatch, module, attr, name, jax_calls, jax_rows)
    port_rows = []
    port_calls = _record_port(monkeypatch, port_rows)
    _jax(sd, spec, im, dtype=jax_dtype, **flags)
    _port(sd, spec, im, dtype=port_dtype, **flags)
    return jax_calls, port_calls, jax_rows, port_rows


# EVA-g's widths: the trunk's, and its MLP's
EVA_G_WIDTHS = {"width": 1408, "mlp_hidden": 6144}


def _row_kernels_hold(case, jax_rows, port_rows, dtype: str) -> None:
    """Every row-kernel call hands the port's wrapper the dtype it hands
    JAX's (dtype, the forward's), and the CUDA wrappers' input check
    (quant.row_kernel_shape) takes each of the port's calls as it would
    come at EVA-g's widths: the same dtype, leading dims, contiguity and
    alignment, C the EVA-g width of the one the small config has."""
    from hirest_tpu_torch.ops.quant import row_kernel_shape

    cfg = configs(DISPATCH[case][0])[1]
    eva_g = {getattr(cfg, k): c for k, c in EVA_G_WIDTHS.items()}
    assert ({(key, dt) for key, dt, *_ in jax_rows}
            == {(key, dt) for key, dt, *_ in port_rows})
    assert {dt for _, dt, *_ in port_rows} <= {dtype}
    for key, dt, shape, contiguous, aligned in port_rows:
        row_kernel_shape(key.split(":")[0], getattr(torch, dt),
                         (*shape[:-1], eva_g[shape[-1]]), contiguous, aligned)


@pytest.mark.parametrize("case", list(DISPATCH))
def test_each_block_calls_the_wrappers_jax_calls(monkeypatch, case):
    """The wrappers each block of the port calls against the JAX block's
    (its scan body is traced once, so JAX's count is one block's), and
    both against the table. With the defaults the bf16 forward reaches v1
    (K8), not v3 (K1). In f32, the row kernels' wrappers get JAX's input
    dtype, and their CUDA input check takes every such call at EVA-g's
    widths (_row_kernels_hold)."""
    jax_calls, port_calls, jax_rows, port_rows = _dispatch(
        monkeypatch, case, jnp.float32, torch.float32)
    spec, _, per_block = DISPATCH[case]
    layers = spec["layers"]
    assert jax_calls == per_block
    assert port_calls == {k: v * layers for k, v in per_block.items()}
    _row_kernels_hold(case, jax_rows, port_rows, "float32")


# the cases whose blocks call a row kernel's wrapper
ROW_CASES = [case for case, (_, _, per_block) in DISPATCH.items()
             if any(k.split(":")[0] in ROW_WRAPPERS for k in per_block)]


@pytest.mark.parametrize("case", ROW_CASES)
def test_each_block_hands_the_row_kernels_jax_dtypes_in_bf16(monkeypatch,
                                                             case):
    """As above, the forward in bf16 in both packages: the same calls, the
    row kernels' wrappers get JAX's input dtype (bf16), and their CUDA
    input check takes every such call at EVA-g's widths."""
    jax_calls, port_calls, jax_rows, port_rows = _dispatch(
        monkeypatch, case, jnp.bfloat16, torch.bfloat16)
    spec, _, per_block = DISPATCH[case]
    assert jax_calls == per_block
    assert port_calls == {k: v * spec["layers"] for k, v in per_block.items()}
    assert port_rows
    _row_kernels_hold(case, jax_rows, port_rows, "bfloat16")


def _record_port(monkeypatch, rows=None):
    calls = {}
    for module, names in PORT_WRAPPERS.items():
        for name in names:
            _record(monkeypatch, module, name, name, calls, rows)
    return calls


# the production configurations the JAX entry points build
# (extraction/features.py:176-183, models/eva_clip.py:255-262)
PRODUCTION = {False: {"fused_attention_qkv3": 1},
              True: {"ln_quant": 2, "fused_attention_qkv3:quant": 1,
                     "fused_mlp_int8": 1, "int8_mm": 2}}


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_encoder_builds_the_production_configuration(monkeypatch, tmp_path,
                                                     int8):
    """make_eva_encoder passes attn_v3 and, with int8, fused_quant and
    fused_mlp, as the JAX encoder does: its blocks call K1, or K2, K3 and
    K4, and not the JAX function's defaults."""
    cfg = configs(TINY224)[1]
    enc, pre = make_eva_encoder(str(tmp_path), int8=int8, device="cpu",
                                cfg=cfg, dtype_name="float32")
    calls = _record_port(monkeypatch)
    enc(images(TINY224, 1))
    assert calls == {k: v * cfg.layers for k, v in PRODUCTION[int8].items()}


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_factory_builds_the_production_configuration(monkeypatch, int8):
    """build_eva_model_and_transforms(scan=True) passes the same flags."""
    cfg = configs(TINY224)[1]
    model, _ = eva_clip.build_eva_model_and_transforms(
        text_config=text_configs(TEXT_TINY)[1], vision_config=cfg, scan=True,
        int8=int8, dtype=torch.float32, device="cpu")
    calls = _record_port(monkeypatch)
    model.encode_image(images(TINY224, 1))
    assert calls == {k: v * cfg.layers for k, v in PRODUCTION[int8].items()}


# --- staged parameters -------------------------------------------------------


def test_staged_flag_mismatch_rejected():
    """A staged tower reused with other int8, dtype or uint8_input flags
    fails loudly (a uint8_input mismatch would otherwise silently corrupt
    embeddings); matching flags use it; a staged tower without its meta is
    refused (test_eva_scan.py:262-285)."""
    sd, cfg = eva_state_dict(TINY), configs(TINY)[1]
    staged = stage_scanned_params(sd, cfg, dtype=torch.float32,
                                  uint8_input=True, device="cpu")
    for other in (dict(), dict(uint8_input=True, int8=True),
                  dict(uint8_input=True, dtype=torch.bfloat16)):
        kw = {"dtype": torch.float32, **other}
        with pytest.raises(ValueError, match="uint8_input"):
            build_scanned_vision_apply(sd, cfg, device="cpu", staged=staged,
                                       **kw)
    apply = build_scanned_vision_apply(None, cfg, dtype=torch.float32,
                                       uint8_input=True, device="cpu",
                                       staged=staged)
    u8 = np.zeros((1, 28, 28, 3), np.uint8)
    assert torch.isfinite(apply(u8)).all()
    with pytest.raises(ValueError, match="meta"):
        build_scanned_vision_apply(None, cfg, dtype=torch.float32,
                                   uint8_input=True, device="cpu",
                                   staged=staged[:1])


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_one_staged_tower_serves_every_configuration(int8):
    """One staged tower of a precision gives each configuration of that
    precision exactly what a build that stages its own gives."""
    sd, im = eva_state_dict(PACKED, seed=53), images(PACKED, 2, seed=53)
    cfg = configs(PACKED)[1]
    staged = stage_scanned_params(sd, cfg, int8=int8, device="cpu")
    for flags in LADDER.values():
        if bool(flags.get("int8")) != int8:
            continue
        shared = build_scanned_vision_apply(None, cfg, device="cpu",
                                            staged=staged, **flags)(im)
        own = build_scanned_vision_apply(sd, cfg, device="cpu", **flags)(im)
        assert torch.equal(shared, own), flags
