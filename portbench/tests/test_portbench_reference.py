"""The plain reference against the port's CPU path, its independence from
the program, and the control: at a size the CPU holds, the program passes
and the control, in the program's place, fails."""

import subprocess
import sys

import pytest
import torch

from portbench import run
from portbench.references.eva_clip_vision import (Reference, feature_gaps,
                                                  normalise)
from portbench.systems import eva_extract
from portbench.tests.tiny import SEED, TINY, tiny_cell

CFG = dict(TINY, patch_size=14, norm_eps=1e-6, requant_chunk=1024)
F32_GAP = 1e-5  # two f32 computations of one function, in another order
# in int8, another order of f32 operations can move a value across a code's
# rounding boundary: a frame with such a flip lies up to ~1e-3 away
CODE_FLIP_GAP = 1e-2


@pytest.mark.parametrize("qmax,flags", [
    (None, dict(attn_v3=True, uint8_input=True)),
    (127, dict(int8=True, fused_quant=True, fused_mlp=True, attn_v3=True,
               uint8_input=True))], ids=["float", "int8"])
def test_reference_is_the_ports_f32_function(qmax, flags):
    """The port's forward computed in f32 on the CPU (exact GELU: the
    reference's) agrees with the reference within f32 rounding, in the
    float configuration and in the int8 one."""
    from hirest_tpu_torch.config import EvaVisionConfig
    from hirest_tpu_torch.models.eva_scan import build_scanned_vision_apply

    sd = eva_extract.make_weights(CFG, SEED, "cpu")
    frames = eva_extract.frame_pool({"frame_pool": 12}, CFG, SEED)
    want = Reference(sd, CFG, qmax).features(torch.from_numpy(frames))
    vcfg = EvaVisionConfig(**{k: CFG[k] for k in eva_extract.EVA_FIELDS})
    got = build_scanned_vision_apply(sd, vcfg, dtype=torch.float32,
                                     device="cpu", fast_gelu=False,
                                     **flags)(frames)
    got = got / got.norm(dim=-1, keepdim=True)
    gaps = feature_gaps(got, want)
    if qmax is None:
        assert gaps.max().item() < F32_GAP
    else:
        assert (gaps < F32_GAP).float().mean().item() >= 0.75
        assert gaps.max().item() < CODE_FLIP_GAP


def test_reference_imports_nothing_of_the_program():
    code = ("import sys\n"
            "for m in ('hirest_tpu_torch', 'hirest_tpu', 'jax'):\n"
            "    sys.modules[m] = None\n"
            "import portbench.references.eva_clip_vision\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in\n"
            "      ('hirest_tpu_torch', 'hirest_tpu', 'jax')\n"
            "      and sys.modules[m] is not None))\n")
    out = subprocess.run([sys.executable, "-c", code], check=True,
                         capture_output=True, text=True,
                         cwd=str(run.registry.ROOT)).stdout
    assert out.strip() == "[]"


# the tiny cells' per-frame tolerances and limits, set from their readings
# on the CPU at SEED and seeds 3-6 (16 frames each): the program's widest
# per-frame gap int8 0.021-0.031, the control (int4) 0.19-0.40 a frame;
# bf16 0.009-0.013, the control (the port's int8 path) 0.010-0.026
TINY_CHECK = {"eva-clip-g14-int8.corpus": (0.04, 0.5),
              "eva-clip-g14-bf16.corpus": (0.012, 0.02)}


@pytest.mark.parametrize("name", sorted(TINY_CHECK))
@pytest.mark.parametrize("seed", [SEED, 3])
def test_program_passes_and_control_fails(name, seed):
    """The program passes; the control in its place (int8: the reference
    at int4; bf16: the port's own int8 path) goes through the same run and
    the same comparison and fails."""
    cell = tiny_cell(name, *TINY_CHECK[name])
    out = run.run_cell(cell, seed, 0.3, False, "cpu")
    assert out["correct"], out["checks"]
    reading = run.run_cell(cell, seed, 0.3, False, "cpu", control=True)
    assert reading["correct"] is False, reading["checks"]
    assert reading["checks"]["excess_gap"]["value"] > TINY_CHECK[name][1]


def test_the_float_front_end_feeds_the_reference_the_same_pixels():
    sd = eva_extract.make_weights(CFG, SEED, "cpu")
    frames = torch.from_numpy(eva_extract.frame_pool({"frame_pool": 3}, CFG,
                                                     SEED))
    pixels = torch.from_numpy(eva_extract.program_pool(
        frames.numpy(), dict(CFG, flags={})))
    assert pixels.dtype == torch.float32
    ref = Reference(sd, CFG)
    assert torch.equal(ref.features(frames), ref.features_of_pixels(pixels))
    assert torch.equal(pixels, normalise(frames))
