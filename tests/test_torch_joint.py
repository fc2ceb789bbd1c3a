"""The port's joint model against the JAX package's, on the CPU: the same
seeded reference-format weights (carried across with
`moment_model_from_jax`) and the same numpy inputs through the flax
`MomentModel` / `CaptionDecoder` and their torch counterparts.

Tolerances: f32 outputs within 1e-5 of the JAX output's largest magnitude,
bf16 within 2**-7 of it; decisions (argmax bounds, segment boundaries,
beam ids) equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hirest_tpu.infer.beam import beam_search as jax_beam_search
from hirest_tpu.infer.beam import beam_search_cached as jax_beam_cached
from hirest_tpu.infer.segmentation import \
    iterative_segmentation as jax_iterative_segmentation
from hirest_tpu.infer.segmentation import \
    iterative_segmentation_scan as jax_segmentation_scan
from hirest_tpu.infer.segmentation import \
    postprocess_boundaries as jax_postprocess
from hirest_tpu.models.caption import CaptionDecoder as JaxCaptionDecoder
from hirest_tpu.models.convert import init_moment_model_from_clip4caption
from hirest_tpu.models.joint import MomentModel as JaxMomentModel
from hirest_tpu_torch.infer.beam import beam_search, beam_search_cached
from hirest_tpu_torch.infer.segmentation import (iterative_segmentation,
                                                 iterative_segmentation_scan,
                                                 postprocess_boundaries)
from hirest_tpu_torch.models.convert import (init_from_clip4caption,
                                             load_moment_state_dict,
                                             moment_model_from_jax)
from hirest_tpu_torch.models.joint import MomentModel

from torch_port_util import (ASR_JOINT, DECODE_JOINT, SERVE_JOINT,
                             jax_joint_params, joint_configs,
                             joint_state_dict)

F32_TOL = 1e-5
BF16_TOL = 2.0 ** -7
DTYPES = {"f32": (jnp.float32, torch.float32, F32_TOL),
          "bf16": (jnp.bfloat16, torch.bfloat16, BF16_TOL)}
B, T = 2, 12


def _models(spec, dtype="f32", seed=0):
    """(flax module, its params, port module) on one seeded state dict."""
    jax_cfg, cfg = joint_configs(spec)
    jdt, tdt, _ = DTYPES[dtype]
    params = jax_joint_params(joint_state_dict(spec, seed), spec)
    model = MomentModel(cfg, dtype=tdt)
    model.load_state_dict(moment_model_from_jax(params))
    return JaxMomentModel(jax_cfg, dtype=jdt), params, model.eval()


def _inputs(spec, seed=1):
    rng = np.random.default_rng(seed)
    video = rng.normal(size=(B, T, 1024)).astype(np.float32)
    text = rng.normal(size=(B, 1024)).astype(np.float32)
    video_mask = np.ones((B, T), np.int32)
    video_mask[1, 9:] = 0
    moment_mask = np.zeros((B, T), np.int32)
    moment_mask[0, 2:10] = 1
    moment_mask[1, 1:7] = 1
    boundary = np.zeros((B, T), np.int32)
    boundary[0, [2, 5]] = 1
    boundary[1, 1] = 1
    asr = (rng.normal(size=(B, T, spec["asr_dim"])).astype(np.float32)
           if spec.get("asr_dim", -1) > 0 else None)
    return dict(video=video, text=text, video_mask=video_mask,
                moment_mask=moment_mask, boundary=boundary, asr=asr)


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


def _close(got, want, tol):
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    bar = tol * np.abs(want).max()
    assert np.abs(got - want).max() <= bar, (np.abs(got - want).max(), bar)


CASES = [(SERVE_JOINT, "f32"), (ASR_JOINT, "f32"), (SERVE_JOINT, "bf16")]
IDS = ["serve-f32", "asr-f32", "serve-bf16"]


def test_joint_convert_round_trip_is_exact():
    for spec in (SERVE_JOINT, ASR_JOINT):
        sd = joint_state_dict(spec, seed=3)
        back = moment_model_from_jax(jax_joint_params(sd, spec))
        assert sorted(back) == sorted(sd)
        for k in sd:
            np.testing.assert_array_equal(back[k].numpy(), sd[k], err_msg=k)


def test_reference_checkpoint_loads_directly():
    """A reference `.pth` state dict, wrapped by DDP (`module.`), with the
    frozen tower's `clip_model.*` keys and a 512-row visual position table,
    loads as the JAX converter reads it: positions enlarged, tail zero."""
    spec = SERVE_JOINT
    sd = joint_state_dict(spec, seed=4)
    key = "clip4cap_model.visual.embeddings.position_embeddings.weight"
    sd[key] = sd[key][:512]
    ckpt = {f"module.{k}": torch.from_numpy(v) for k, v in sd.items()}
    ckpt["module.clip_model.visual.proj"] = torch.zeros(3)
    model = load_moment_state_dict(MomentModel(joint_configs(spec)[1]), ckpt)
    want = moment_model_from_jax(jax_joint_params(
        {k: v for k, v in sd.items()}, spec))
    got = model.state_dict()
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(),
                                      err_msg=k)
    assert not got[key][512:].any()


@pytest.mark.parametrize("spec,dtype", CASES, ids=IDS)
def test_moment_retrieval_matches_jax(spec, dtype):
    jm, params, model = _models(spec, dtype)
    x = _inputs(spec)
    want = jm.apply(params, _j(x["video"]), _j(x["text"]),
                    _j(x["video_mask"]), _j(x["moment_mask"]), _j(x["asr"]))
    with torch.no_grad():
        got = model.moment_retrieval(_t(x["video"]), _t(x["text"]),
                                     _t(x["video_mask"]),
                                     _t(x["moment_mask"]), _t(x["asr"]))
    for k in ("start_logits", "end_logits"):
        _close(got[k], want[k], DTYPES[dtype][2])
        masked = np.where(x["video_mask"] > 0, np.asarray(want[k]), -1e10)
        np.testing.assert_array_equal(
            torch.where(_t(x["video_mask"]) > 0, got[k], -1e10)
            .argmax(1).numpy(), masked.argmax(1))


@pytest.mark.parametrize("spec,dtype", CASES, ids=IDS)
def test_moment_segmentation_matches_jax(spec, dtype):
    jm, params, model = _models(spec, dtype)
    x = _inputs(spec)
    want = jm.apply(params, _j(x["video"]), _j(x["text"]),
                    _j(x["video_mask"]), _j(x["moment_mask"]), _j(x["asr"]),
                    _j(x["boundary"]),
                    method=JaxMomentModel.moment_segmentation)
    with torch.no_grad():
        got = model.moment_segmentation(
            _t(x["video"]), _t(x["text"]), _t(x["video_mask"]),
            _t(x["moment_mask"]), _t(x["asr"]), _t(x["boundary"]))
    _close(got, want, DTYPES[dtype][2])


@pytest.mark.parametrize("spec,dtype", CASES, ids=IDS)
def test_caption_encode_and_logits_match_jax(spec, dtype):
    """caption_encode, then the teacher-forced decoder with an answer mask
    over token ids that include ids past the 40-token vocabulary (JAX's
    gather clamps them to its last row)."""
    jm, params, model = _models(spec, dtype)
    x = _inputs(spec)
    ids = np.random.default_rng(5).integers(0, 40, size=(B, 8))
    ids[:, 0] = 101
    ids[0, 3] = 102
    answer = np.ones((B, 8), np.int32)
    answer[1, 5:] = 0
    vis = jm.apply(params, _j(x["video"]), _j(x["text"]), _j(x["asr"]),
                   method=JaxMomentModel.caption_encode)
    want = jm.apply(params, vis, jnp.asarray(ids, jnp.int32), _j(answer),
                    method=JaxMomentModel.caption_logits)
    with torch.no_grad():
        got_vis = model.caption_encode(_t(x["video"]), _t(x["text"]),
                                       _t(x["asr"]))
        got = model.caption_logits(got_vis, torch.from_numpy(ids),
                                   _t(answer))
    tol = DTYPES[dtype][2]
    _close(got_vis, vis, tol)
    _close(got, want, tol)


def _decoders(dtype="f32"):
    """The DECODE_JOINT decoder (tests/test_cached_decode.py's) in both
    packages, and encoder outputs [B, 5, 16]."""
    jax_cfg, cfg = joint_configs(DECODE_JOINT)
    jdt, tdt, _ = DTYPES[dtype]
    params = jax_joint_params(joint_state_dict(DECODE_JOINT, seed=7),
                              DECODE_JOINT)
    model = MomentModel(cfg, dtype=tdt)
    model.load_state_dict(moment_model_from_jax(params))
    enc = np.random.default_rng(0).normal(size=(B, 5, 16)).astype(np.float32)
    dec = JaxCaptionDecoder(jax_cfg.decoder, dtype=jdt)
    return (dec, {"params": params["params"]["decoder"]},
            model.decoder.eval(), enc)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_decode_step_matches_jax_at_every_position(dtype):
    dec, params, port, enc = _decoders(dtype)
    ids = np.random.default_rng(6).integers(0, 40, size=(B, 7))
    ids[:, 0] = 101  # past the vocabulary: clamped
    jdt = DTYPES[dtype][0]
    enc_j = jnp.asarray(enc, jdt)
    cross = dec.apply(params, enc_j, method=JaxCaptionDecoder.cross_kv)
    cache = dec.apply(params, B, 7, method=JaxCaptionDecoder.init_cache)
    enc_t = torch.from_numpy(enc).to(DTYPES[dtype][1])
    with torch.no_grad():
        full = port(torch.from_numpy(ids), enc_t)
        pcross, pcache = port.cross_kv(enc_t), port.init_cache(B, 7)
        for t in range(7):
            want, cache = dec.apply(params, jnp.asarray(ids[:, t]), t, cross,
                                    cache,
                                    method=JaxCaptionDecoder.decode_step)
            got, pcache = port.decode_step(torch.from_numpy(ids[:, t]), t,
                                           pcross, pcache)
            _close(got, want, DTYPES[dtype][2])
            if dtype == "f32":
                _close(got, full[:, t], F32_TOL)


def _jax_beams(dec, params, enc, beam, max_words, bos, eos):
    enc_rpt = jnp.repeat(jnp.asarray(enc), beam, axis=0)

    def logits_fn(ids, t):
        return dec.apply(params, ids[:, :max_words], enc_rpt)[:, t]

    full = jax.jit(lambda: jax_beam_search(logits_fn, B, beam, max_words,
                                           bos, eos))()
    cross = dec.apply(params, enc_rpt, method=JaxCaptionDecoder.cross_kv)
    cache = dec.apply(params, B * beam, max_words + 1,
                      method=JaxCaptionDecoder.init_cache)

    def step_fn(last, t, cache):
        return dec.apply(params, last, t, cross, cache,
                         method=JaxCaptionDecoder.decode_step)

    def gather_fn(cache, src):
        return jax.tree_util.tree_map(lambda x: x[src], cache)

    cached = jax.jit(lambda: jax_beam_cached(step_fn, gather_fn, cache, B,
                                             beam, max_words, bos, eos))()
    return [tuple(np.asarray(a) for a in r) for r in (full, cached)]


def _port_beams(port, enc, beam, max_words, bos, eos):
    enc_rpt = torch.from_numpy(enc).repeat_interleave(beam, 0)
    cpu = torch.device("cpu")

    def logits_fn(ids, t):
        return port(ids[:, :max_words], enc_rpt)[:, t]

    cross = port.cross_kv(enc_rpt)

    def step_fn(last, t, cache):
        return port.decode_step(last, t, cross, cache)

    def gather_fn(cache, src):
        return tuple((k[src], v[src]) for k, v in cache)

    with torch.no_grad():
        full = beam_search(logits_fn, B, beam, max_words, bos, eos,
                           device=cpu)
        cached = beam_search_cached(step_fn, gather_fn,
                                    port.init_cache(B * beam, max_words + 1),
                                    B, beam, max_words, bos, eos, device=cpu)
    return [tuple(a.numpy() for a in r) for r in (full, cached)]


@pytest.mark.parametrize("bos,eos", [(2, 3), (101, 102)],
                         ids=["in-vocab", "clamped-bos"])
def test_beam_searches_match_jax(bos, eos):
    """Both beams of the port give the JAX beams' ids (and scores within
    f32 rounding); the cached beam gives the full re-decode beam's ids."""
    dec, params, port, enc = _decoders()
    beam, max_words = 3, 8
    want = _jax_beams(dec, params, enc, beam, max_words, bos, eos)
    got = _port_beams(port, enc, beam, max_words, bos, eos)
    for (g_ids, g_sc), (w_ids, w_sc) in zip(got, want):
        np.testing.assert_array_equal(g_ids, w_ids)
        np.testing.assert_allclose(g_sc, w_sc, rtol=1e-5)
    np.testing.assert_array_equal(got[0][0], got[1][0])


def test_beam_freezes_at_eos_like_jax():
    """An instance whose top beam emits EOS is frozen: a logits function
    that forbids EOS for two steps and favours it from the third freezes
    every row there, in both packages alike."""
    v, beam, max_words, eos = 11, 3, 6, 4
    rng = np.random.default_rng(9)
    base = rng.normal(size=(max_words, B * beam, v)).astype(np.float32)
    base[:2, :, eos] -= 8.0
    base[2:, :, eos] += 8.0
    want = jax.jit(lambda: jax_beam_search(
        lambda ids, t: jnp.asarray(base)[t] + ids[:, :1] * 0.0, B, beam,
        max_words, 1, eos))()
    got = beam_search(lambda ids, t: torch.from_numpy(base[t]), B, beam,
                      max_words, 1, eos, device=torch.device("cpu"))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=1e-6)
    assert (got[0].numpy()[:, 2] == eos).all()
    assert (got[0].numpy()[:, 3:] == 0).all()


def test_topk_slot_order_matches_jax():
    """torch.topk(sorted=True) orders the beam's candidates as
    jax.lax.top_k does, the -1e18 seeded slots included."""
    rng = np.random.default_rng(10)
    x = rng.normal(size=(4, 3 * 40)).astype(np.float32)
    x[:, 40:] = -1e18 + x[:, 40:]
    for k in (1, 3, 5):
        gv, gi = torch.from_numpy(x).topk(k, dim=1, sorted=True)
        wv, wi = jax.lax.top_k(jnp.asarray(x), k)
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


def _score_fns(spec):
    """The trainer's segmentation score function (masked softmax over the
    segment logits) in both packages, on one batch."""
    jm, params, model = _models(spec)
    x = _inputs(spec)

    def jax_score(mm, pbm):
        logits = jm.apply(params, _j(x["video"]), _j(x["text"]),
                          _j(x["video_mask"]), jnp.asarray(mm), _j(x["asr"]),
                          jnp.asarray(pbm),
                          method=JaxMomentModel.moment_segmentation)
        masked = jnp.where(jnp.asarray(mm) > 0, logits,
                           -jnp.finfo(jnp.float32).max)
        return jax.nn.softmax(masked, axis=1)

    def port_score(mm, pbm):
        mm, pbm = torch.as_tensor(mm), torch.as_tensor(pbm)
        with torch.no_grad():
            logits = model.moment_segmentation(
                _t(x["video"]), _t(x["text"]), _t(x["video_mask"]), mm,
                _t(x["asr"]), pbm)
        masked = torch.where(mm > 0, logits, -torch.finfo(torch.float32).max)
        return torch.softmax(masked, dim=1)

    return jax_score, port_score


@pytest.mark.parametrize("spec", [SERVE_JOINT, ASR_JOINT], ids=["serve", "asr"])
def test_segmentation_matches_jax(spec):
    """Both variants (host loop, and the device loop with one fetch) give
    the JAX package's boundaries; the model's segment scores drive them."""
    jax_score, port_score = _score_fns(spec)
    bounds = np.array([[1, 10], [0, 8]], np.int32)
    want = jax_iterative_segmentation(
        lambda mm, pbm: np.asarray(jax_score(mm, pbm)), bounds, T, 0.5, 6)
    got = iterative_segmentation(
        lambda mm, pbm: port_score(mm, pbm).numpy(), bounds, T, 0.5, 6)
    assert got == want
    # a row without a found boundary keeps only its start
    assert any(len(b) > 1 for b in want), want
    want_scan = jax_segmentation_scan(jax_score, bounds, T, 0.5, 6)
    got_scan = iterative_segmentation_scan(port_score, bounds, T, 0.5, 6,
                                           device=torch.device("cpu"))
    assert got_scan == want_scan


@pytest.mark.parametrize("seed", range(4))
def test_segmentation_loops_match_jax_on_synthetic_scores(seed):
    """Peaked synthetic score tables (a fixed table, the masks ignored),
    with ties, a zero row and peaks at the edges."""
    rng = np.random.default_rng(seed)
    n, b = 24, 3
    table = np.exp(3.0 * rng.normal(size=(b, n))).astype(np.float32)
    table[0, 5] = table[0, 7] = table.max() * 2  # a tie at the peak
    table[1] = 0.0
    table[2, -1] = table[2].max() * 3
    table /= np.maximum(table.sum(1, keepdims=True), 1e-30)

    def fn(mm, pbm):
        return table * np.asarray(mm)

    bounds = np.array([[0, 20], [3, 23], [2, 23]], np.int32)
    assert (iterative_segmentation(fn, bounds, n, 0.5, 5)
            == jax_iterative_segmentation(fn, bounds, n, 0.5, 5))
    got = iterative_segmentation_scan(
        lambda mm, pbm: torch.from_numpy(fn(mm.numpy(), None)), bounds, n,
        0.5, 5, device=torch.device("cpu"))
    want = jax_segmentation_scan(lambda mm, pbm: jnp.asarray(table) * mm,
                                 bounds, n, 0.5, 5)
    assert got == want


def test_postprocess_boundaries_matches_jax():
    rng = np.random.default_rng(11)
    for _ in range(20):
        starts = rng.integers(0, 10, size=3).tolist()
        lasts = [s + int(rng.integers(1, 40)) for s in starts]
        pairs = [[sorted(rng.integers(0, 60, size=2).tolist())
                  for _ in range(int(rng.integers(0, 6)))] for _ in starts]
        assert (postprocess_boundaries(pairs, starts, lasts)
                == jax_postprocess(pairs, starts, lasts))


def test_init_from_clip4caption_matches_jax():
    """The pretrained CLIP4Caption overlay (`visual.*`, `decoder.*`, a
    512-row position table) gives the JAX initializer's encoder and
    decoder."""
    spec = SERVE_JOINT
    jax_cfg, cfg = joint_configs(spec)
    sd = joint_state_dict(spec, seed=12)
    base = joint_state_dict(spec, seed=13)
    bin_sd = {}
    for part, name in (("visual", "visual"), ("decoder", "decoder")):
        prefix = f"clip4cap_model.{part}."
        bin_sd.update({f"{name}.{k[len(prefix):]}": v
                       for k, v in sd.items() if k.startswith(prefix)})
    key = "visual.embeddings.position_embeddings.weight"
    bin_sd[key] = bin_sd[key][:512]
    params = jax_joint_params(base, spec)
    want = moment_model_from_jax({"params": init_moment_model_from_clip4caption(
        dict(params["params"]), bin_sd, jax_cfg)})
    model = MomentModel(cfg)
    model.load_state_dict(moment_model_from_jax(params))
    got = init_from_clip4caption(model, {k: torch.from_numpy(v)
                                         for k, v in bin_sd.items()})
    got = got.state_dict()
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(),
                                      err_msg=k)
