"""The port's bench entry point (hirest_tpu_torch/bench.py) against the JAX
package's root bench.py: the useful FLOP a frame, the ladder's
configurations, tags and remaps, the flags each configuration hands the
scanned forward's build function, the production forwards through
build_eva_apply, the CPU smoke, and the fail-fast line and its record.

JAX runs its Pallas kernels in interpret mode; the port's wrappers take
their plain versions on CPU tensors.
"""

import json
import os
import sys
import tempfile
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import (PACKED, SERVE_JOINT, TEXT_TINY, configs,
                             eva_state_dict, images, jax_params,
                             joint_configs, text_configs)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import bench as jax_bench  # noqa: E402
import hirest_tpu.models.eva_scan as jax_eva_scan  # noqa: E402
import hirest_tpu_torch.bench as port_bench  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
TAGS = ["int8+fq+v3+fm", "int8+fq+v3", "bf16+v3", "int8", "bf16", "bf16+v2",
        "bf16+v3+lnk", "int8+fq+v2"]
# the isolation test's EVA config, and a decoder long enough for 48 words
TINY_EVA = dict(image_size=28, layers=2, width=128, head_width=32,
                mlp_ratio=4.0, patch_size=14, embed_dim=32)
LATENCY_JOINT = dict(SERVE_JOINT, decoder=dict(SERVE_JOINT["decoder"],
                                               max_target_embeddings=64))
# what build_eva_apply hands the build function in JAX alone: TPU layouts, the
# Pallas switch, interpret mode; and in the port alone: the device
LAYOUT = {"use_pallas", "attn_hg", "attn_rows", "flat2d", "pad_tokens",
          "interpret"}

# bench.py:754-768, (int8, fq, kernel version, flat2d, fused_ln,
# pad_tokens, fused_mlp)
JAX_LADDER = [
    (True, True, 2, True, False, True, True),
    (True, True, 2, True, False, True, False),
    (True, True, 2, True, False, False, False),
    (False, False, 2, False, False, False, False),
    (False, False, 2, True, False, True, False),
    (True, False, 0, False, False, False, False),
    (False, False, 0, False, False, False, False),
    (False, False, 2, False, False, True, False),
    (False, False, 1, False, False, False, False),
    (False, False, 0, True, False, False, False),
    (False, False, 2, True, True, False, False),
    (False, False, 2, True, False, False, False),
    (True, True, 1, False, False, False, False),
]


def jax_ladder(argv: list) -> list:
    """bench.py:742-789 on its 7-tuples (its --int8 and --bf16 entries,
    its remaps), layout flags kept."""
    if "--int8" in argv:
        ladder = [JAX_LADDER[0]]
    elif "--bf16" in argv:
        ladder = [JAX_LADDER[3]]
    else:
        ladder = list(JAX_LADDER)
    if ("--fused-quant" in argv or "--attn-v2" in argv
            or "--attn-v3" in argv):
        fq_f = "--fused-quant" in argv
        kv_f = 2 if "--attn-v3" in argv else (1 if "--attn-v2" in argv
                                              else 0)
        ladder = [(i8, fq_f and i8, kv_f, fl, ln, tp, fm)
                  for (i8, _, _, fl, ln, tp, fm) in ladder]
    if "--fused-ln" in argv:
        ladder = [(i8, fq, kv, fl, not i8, tp, fm)
                  for (i8, fq, kv, fl, _, tp, fm) in ladder]
    if "--fused-mlp" in argv:
        ladder = [(i8, fq, kv, fl, ln, tp, fq)
                  for (i8, fq, kv, fl, ln, tp, _) in ladder]
    return list(dict.fromkeys(ladder))


def port_ladder(argv: list) -> list:
    return port_bench.build_ladder(port_bench._parser().parse_args(argv))


def test_useful_flops_match_jax():
    """The logical EVA-g/14's matmul FLOP a frame, exactly JAX's, and the
    ceilings at the H100's dense bf16 peak."""
    tf = port_bench.eva_useful_tflops_per_frame()
    assert tf == jax_bench.eva_useful_tflops_per_frame()
    assert round(tf, 6) == 0.534063
    phys = port_bench._physics_context(989.4)
    assert phys == {"useful_tflops_per_frame": 0.5341,
                    "peak_basis_bf16_tflops": 989.4,
                    "bf16_ceiling_fps": round(989.4 / tf, 1),
                    "int8_ceiling_fps": round(2 * 989.4 / tf, 1)}
    assert 1852 < phys["bf16_ceiling_fps"] < 1853


@pytest.mark.parametrize("argv,tags", [
    ([], TAGS),
    (["--int8"], ["int8+fq+v3+fm"]),
    (["--bf16"], ["bf16+v3"]),
    (["--bf16", "--padded-heads"], ["bf16+v3+pad"]),
    (["--unrolled"], ["int8+unrolled", "bf16+unrolled"]),
    (["--unrolled", "--int8"], ["int8+unrolled"]),
    (["--unrolled", "--bf16", "--padded-heads"], ["bf16+pad+unrolled"]),
], ids=["ladder", "int8", "bf16", "bf16-padded", "unrolled",
        "unrolled-int8", "unrolled-bf16-padded"])
def test_ladder_tags_and_order(argv, tags):
    """The eight configurations in bench.py's order, the production ones
    alone under --int8 and --bf16; the unrolled towers consume int8
    alone."""
    args = port_bench._parser().parse_args(argv)
    got = [port_bench.config_tag(c, args.padded_heads, not args.unrolled)
           for c in port_bench.build_ladder(args)]
    assert got == tags


@pytest.mark.parametrize("argv", [
    [], ["--fused-quant"], ["--attn-v2"], ["--attn-v3"],
    ["--fused-quant", "--attn-v2"], ["--fused-ln"], ["--fused-mlp"],
    ["--fused-quant", "--attn-v3", "--fused-mlp"], ["--int8", "--attn-v2"],
    ["--bf16", "--fused-ln"], ["--int8", "--fused-ln", "--fused-mlp"]],
    ids=lambda a: "+".join(x.strip("-") for x in a) or "none")
def test_flag_remaps_match_jax(argv):
    """Each remap gives JAX's ladder less its layout flags, each entry
    reduced to what the forward consumes, duplicates merged, in order."""
    want = list(dict.fromkeys(
        port_bench.consumed(port_bench.LadderConfig(i8, fq, kv, ln, fm))
        for i8, fq, kv, _fl, ln, _tp, fm in jax_ladder(argv)))
    assert port_ladder(argv) == want


class Recorded(Exception):
    pass


def _recorder(calls: list):
    def record(params, cfg, **kwargs):
        calls.append(kwargs)
        raise Recorded
    return record


def _without(kwargs: dict, names) -> dict:
    return {k: v for k, v in kwargs.items() if k not in names}


def _same_flags(jax_kw: dict, port_kw: dict) -> None:
    assert port_kw.pop("device") == "cpu"
    jax_dtype, port_dtype = jax_kw.pop("dtype"), port_kw.pop("dtype")
    assert (jax_dtype == jnp.bfloat16) == (port_dtype == torch.bfloat16)
    assert _without(jax_kw, LAYOUT) == port_kw


@pytest.mark.parametrize("index", range(len(TAGS)), ids=TAGS)
def test_ladder_build_flags_match_jax(monkeypatch, index):
    """The keyword flags each ladder configuration hands
    build_scanned_vision_apply, recorded by a stub, equal those JAX's
    build_eva_apply hands its build function for the same configuration (as
    bench.py:834-842 calls it), less the layout flags."""
    c = port_bench.LADDER[index]
    calls = []
    monkeypatch.setattr(jax_eva_scan, "build_scanned_vision_apply",
                        _recorder(calls))
    monkeypatch.setattr(port_bench, "build_scanned_vision_apply",
                        _recorder(calls))
    with pytest.raises(Recorded):
        jax_bench.build_eva_apply(
            {}, None, use_pallas=True, int8=c.int8, scan=True,
            fused_quant=c.fused_quant, attn_v2=c.attn == 1,
            attn_v3=c.attn == 2, attn_hg=8, attn_rows=1, pad_tokens=False,
            fused_mlp=c.fused_mlp and c.fused_quant, flat2d=False,
            fused_ln=c.fused_ln, staged=None, interpret=False)
    with pytest.raises(Recorded):
        port_bench.build_eva_apply({}, None, scan=True, staged=None,
                                   device="cpu",
                                   **port_bench.ladder_kwargs(c))
    _same_flags(*calls)


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_e2e_build_flags_match_jax(monkeypatch, int8):
    """--e2e builds the production forward with the uint8 front end, as
    bench.py:284-287 does, less its layout flags."""
    calls = []
    monkeypatch.setattr(jax_eva_scan, "build_scanned_vision_apply",
                        _recorder(calls))
    monkeypatch.setattr(port_bench, "build_scanned_vision_apply",
                        _recorder(calls))
    with pytest.raises(Recorded):
        jax_bench.bench_e2e_extraction({}, None, int8=int8)
    with pytest.raises(Recorded):
        port_bench.bench_e2e_extraction({}, None, int8=int8, device="cpu")
    _same_flags(*calls)


@pytest.mark.parametrize("tag", ["bf16+v3", "int8+fq+v3+fm"])
def test_production_configs_match_jax(tag):
    """bf16+v3 and int8+fq+v3+fm through the port's build_eva_apply against
    JAX's build_eva_apply(..., interpret=True) on the same converted
    weights, in f32 at PACKED (128 wide: v3 takes its kernel), at
    test_torch_ladder.py's bars: 2e-4 float, 2e-3 int8."""
    c = port_bench.LADDER[TAGS.index(tag)]
    sd, im = eva_state_dict(PACKED, seed=60), images(PACKED, 3, seed=60)
    jax_cfg, port_cfg = configs(PACKED)
    want = np.asarray(jax_bench.build_eva_apply(
        jax_params(sd, PACKED), jax_cfg, int8=c.int8, dtype_name="float32",
        fused_quant=c.fused_quant, attn_v3=True,
        fused_mlp=c.fused_mlp, interpret=True)(jnp.asarray(im)), np.float32)
    got = port_bench.build_eva_apply(
        sd, port_cfg, dtype_name="float32", device="cpu",
        **port_bench.ladder_kwargs(c))(im).numpy()
    assert got.shape == (3, PACKED["embed_dim"]) and np.isfinite(got).all()
    tol = 2e-3 if c.int8 else 2e-4
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def _last_json(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


def test_cpu_smoke(monkeypatch, tmp_path, capsys):
    """--cpu-smoke at a tiny config: every ladder configuration and the
    three secondary modes run on the CPU and say "ok"; the last line is
    well formed, with no time in it; no record is written."""
    record = tmp_path / "record.json"
    monkeypatch.setattr(port_bench, "LAST_RESULT_PATH", str(record))
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    rc = port_bench.main(
        ["--cpu-smoke"], vision_cfg=configs(TINY_EVA)[1],
        text_cfg=text_configs(TEXT_TINY)[1],
        joint_cfg=joint_configs(LATENCY_JOINT)[1])
    line = _last_json(capsys.readouterr().out)
    assert rc == 0
    assert line["smoke"] == {k: "ok" for k in TAGS + ["latency", "vr",
                                                       "e2e"]}
    assert line["metric"] == "eva_clip_frames_per_sec_per_chip"
    assert line["unit"] == "frames/sec"
    assert line["value"] == 0.0 and line["mfu"] == 0.0
    assert line["config"] == {"batch": 2, "device": "cpu"}
    assert line["peak_basis_bf16_tflops"] == 989.4
    assert {"useful_tflops_per_frame", "bf16_ceiling_fps",
            "int8_ceiling_fps"} <= set(line)
    assert not record.exists()


@pytest.mark.parametrize("flag", ["--no-pallas", "--flat2d", "--tok-pad",
                                  "--hg=16", "--rows=2", "--no-cache"])
def test_refused_flags(monkeypatch, tmp_path, capsys, flag):
    """A flag the port does not carry exits non-zero with a line saying
    why, before any work."""
    monkeypatch.setattr(port_bench, "LAST_RESULT_PATH",
                        str(tmp_path / "record.json"))
    with pytest.raises(SystemExit) as e:
        port_bench.main(["--bf16", flag])
    assert e.value.code == 2
    line = _last_json(capsys.readouterr().out)
    assert line["value"] == 0.0
    assert line["error"].startswith(f"{flag.split('=')[0]} is refused: ")


@pytest.mark.parametrize("argv,metric", [
    (["--bf16"], "eva_clip_frames_per_sec_per_chip"),
    (["--latency"], "step_caption_p50_latency"),
    (["--e2e", "--int8"], "e2e_extraction_frames_per_sec")],
    ids=["bf16", "latency", "e2e"])
def test_fail_fast_attaches_port_record(monkeypatch, tmp_path, capsys, argv,
                                        metric):
    """With no CUDA device the line has value 0 and the error, attaches
    the port's record (never in the value's place) and leaves the JAX
    package's BENCH_LAST_GOOD.json as it was."""
    jax_record = REPO / "BENCH_LAST_GOOD.json"
    before = jax_record.read_bytes()
    record = tmp_path / "record.json"
    stored = {metric: {"metric": metric, "value": 123.0}}
    record.write_text(json.dumps(stored))
    monkeypatch.setattr(port_bench, "LAST_RESULT_PATH", str(record))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        port_bench.main(argv)
    assert e.value.code == 1
    line = _last_json(capsys.readouterr().out)
    assert line["metric"] == metric and line["value"] == 0.0
    assert "no CUDA device" in line["error"]
    assert line["last_measured"] == stored[metric]
    assert line["last_measured_all"] == stored
    assert ("bf16_ceiling_fps" in line) == (metric == port_bench.FPS_METRIC)
    assert json.loads(record.read_text()) == stored
    assert jax_record.read_bytes() == before


def test_unknown_card_fails_fast(monkeypatch, tmp_path, capsys):
    """A card the peak table does not name gets the fail-fast line: its
    mfu would have no basis."""
    monkeypatch.setattr(port_bench, "LAST_RESULT_PATH",
                        str(tmp_path / "record.json"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *a: "NVIDIA H100 PCIe")
    with pytest.raises(SystemExit) as e:
        port_bench.main(["--bf16"])
    assert e.value.code == 1
    line = _last_json(capsys.readouterr().out)
    assert line["value"] == 0.0
    assert "'NVIDIA H100 PCIe' is not in the peak table" in line["error"]


def test_records(monkeypatch, tmp_path):
    """A configuration's numbers go under "experiments" at once; the
    headline only when a production run beats the stored one."""
    record = tmp_path / "record.json"
    monkeypatch.setattr(port_bench, "LAST_RESULT_PATH", str(record))
    metric = port_bench.FPS_METRIC

    def headline(value):
        return {"metric": metric, "value": value, "unit": "frames/sec"}

    port_bench._record_config_result("bf16+v3", 128, 700.0, 0.378,
                                     headline(700.0))
    port_bench._record_config_result("int8", 128, 180.0, 0.097,
                                     headline(180.0))
    port_bench._record_config_result("bf16", 128, 900.0, 0.486, None)
    data = json.loads(record.read_text())
    assert data[metric]["value"] == 700.0
    assert set(data["experiments"]) == {"bf16+v3@b128", "int8@b128",
                                        "bf16@b128"}
    assert data["experiments"]["bf16@b128"]["fps"] == 900.0
    port_bench._record_last_good({"metric": "step_caption_p50_latency",
                                  "value": 12.5, "unit": "ms"})
    data = json.loads(record.read_text())
    assert data["step_caption_p50_latency"]["value"] == 12.5
    assert data[metric]["value"] == 700.0


@pytest.mark.parametrize("argv,tags", [
    (["--bf16"], ["bf16+v3"]),
    (["--int8", "--experiment"], ["int8+fq+v3+fm"]),
    (["--unrolled"], ["int8+unrolled", "bf16+unrolled"])],
    ids=["bf16", "int8-experiment", "unrolled"])
def test_ladder_line_and_record(monkeypatch, tmp_path, capsys, argv, tags):
    """The ladder's control flow at a tiny config, its device stubbed to
    the CPU (the bench itself never times the CPU): the card line, then
    the last line with the best configuration, its mfu against the peak,
    the physics context; each configuration recorded under "experiments",
    the headline only without --experiment."""
    record = tmp_path / "record.json"
    monkeypatch.setattr(port_bench, "LAST_RESULT_PATH", str(record))
    monkeypatch.setattr(port_bench, "_require_device",
                        lambda metric: (torch.device("cpu"), 989.4e12))
    cfg = configs(TINY_EVA)[1]
    rc = port_bench.main(argv + ["--batch=2"], vision_cfg=cfg)
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0 and len(out) == 2
    line = json.loads(out[-1])
    tf = port_bench.eva_useful_tflops_per_frame(cfg)
    assert line["metric"] == port_bench.FPS_METRIC and line["value"] > 0
    assert line["config"]["config"] in tags
    assert line["config"]["batch"] == 2
    assert line["mfu"] == round(line["value"] * tf * 1e12 / 989.4e12, 4)
    assert line["peak_basis_bf16_tflops"] == 989.4
    data = json.loads(record.read_text())
    assert set(data["experiments"]) == {f"{t}@b2" for t in tags}
    assert (port_bench.FPS_METRIC in data) == ("--experiment" not in argv)


def test_failed_configuration_exits_1(monkeypatch, tmp_path, capsys):
    """A configuration that fails to build is reported in the last line's
    "failed" and the run exits 1; nothing becomes the headline."""
    monkeypatch.setattr(port_bench, "LAST_RESULT_PATH",
                        str(tmp_path / "record.json"))
    monkeypatch.setattr(port_bench, "_require_device",
                        lambda metric: (torch.device("cpu"), 989.4e12))

    def broken(*args, **kwargs):
        raise RuntimeError("no kernel")

    monkeypatch.setattr(port_bench, "stage_scanned_params", broken)
    rc = port_bench.main(["--int8", "--batch=2"],
                         vision_cfg=configs(TINY_EVA)[1])
    line = _last_json(capsys.readouterr().out)
    assert rc == 1
    assert line["value"] == 0.0
    assert line["failed"] == {
        "int8+fq+v3+fm": "build: RuntimeError: no kernel"}
    assert not (tmp_path / "record.json").exists()
