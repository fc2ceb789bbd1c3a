"""The port's extraction entry point (hirest_tpu_torch.extraction.features)
against the JAX package's, on a synthetic frame directory of small JPEGs
and one seeded tiny EVA state dict in both."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import TINY224, configs, eva_state_dict, jax_params

from hirest_tpu.extraction.features import \
    extract_video_features as jax_extract
from hirest_tpu.models.eva_clip import EvaVisionTower as FlaxEvaVisionTower
from hirest_tpu.models.eva_clip import preprocess_image as jax_preprocess
from hirest_tpu.models.eva_scan import \
    build_scanned_vision_apply as jax_build
from hirest_tpu_torch.extraction.features import (extract_video_features,
                                                  finish_video_features,
                                                  make_eva_encoder)

FRAMES = {"v1": 7, "v2": 3}


def _write_frames(root):
    from PIL import Image

    rng = np.random.default_rng(0)
    for vid, n in FRAMES.items():
        d = root / vid
        d.mkdir(parents=True)
        for i in range(n):
            Image.fromarray(rng.integers(0, 256, (48, 64, 3), dtype=np.uint8)
                            ).save(d / f"frame_{i:05d}.jpg")


@pytest.fixture(scope="module")
def frames_and_ckpt(tmp_path_factory):
    root = tmp_path_factory.mktemp("extract")
    _write_frames(root / "frames")
    sd = eva_state_dict(TINY224, seed=5)
    (root / "pre").mkdir()
    torch.save({f"visual.{k}": torch.from_numpy(v) for k, v in sd.items()},
               root / "pre" / "eva_clip_psz14.pt")
    return root, sd


def test_features_match_jax_truncate_and_resume(frames_and_ckpt):
    """The port (f32 on the CPU, weights loaded from the checkpoint) writes
    the JAX package's feature files (v3 Pallas forward in interpret mode)
    at 2e-4, the forward's own bar; truncates to the duration; and skips
    videos already done on a second run."""
    root, sd = frames_and_ckpt
    jcfg, tcfg = configs(TINY224)
    jax_apply = jax_build(jax_params(sd, TINY224), jcfg, use_pallas=True,
                          attn_v3=True, interpret=True, dtype=jnp.float32)
    durations = {"v1": 5.2}
    assert jax_extract(str(root / "frames"), str(root / "jax"),
                       lambda im: jax_apply(jnp.asarray(im)), jax_preprocess,
                       batch_size=4, durations=durations) == 2

    enc, pre = make_eva_encoder(str(root / "pre"), dtype_name="float32",
                                device="cpu", cfg=tcfg)
    out = root / "port"
    assert extract_video_features(str(root / "frames"), str(out), enc, pre,
                                  batch_size=4, durations=durations) == 2
    for vid in FRAMES:
        got, want = np.load(out / f"{vid}.npy"), np.load(
            root / "jax" / f"{vid}.npy")
        assert got.shape == want.shape and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    assert np.load(out / "v1.npy").shape == (5, TINY224["embed_dim"])
    assert np.load(out / "v2.npy").shape == (3, TINY224["embed_dim"])
    assert extract_video_features(str(root / "frames"), str(out), enc, pre,
                                  batch_size=4) == 0


def test_uint8_frontend_writes_the_same_features(frames_and_ckpt):
    """Raw uint8 frames with the normalisation folded into the patch embed
    give the float path's features at 2e-4."""
    root, _ = frames_and_ckpt
    tcfg = configs(TINY224)[1]
    feats = {}
    for u8 in (False, True):
        enc, pre = make_eva_encoder(str(root / "pre"), dtype_name="float32",
                                    uint8_frontend=u8, device="cpu", cfg=tcfg)
        out = root / f"u8_{u8}"
        extract_video_features(str(root / "frames"), str(out), enc, pre,
                               batch_size=8, video_ids=["v1"])
        feats[u8] = np.load(out / "v1.npy")
    assert pre(np.zeros((30, 40, 3), np.uint8)).dtype == np.uint8
    np.testing.assert_allclose(feats[True], feats[False], rtol=2e-4,
                               atol=2e-4)


def test_finish_video_features():
    embs = [torch.tensor([[3.0, 4.0], [0.0, 2.0]]), np.array([[1.0, 0.0]])]
    got = finish_video_features(embs, duration=1.6)
    np.testing.assert_allclose(got, [[0.6, 0.8], [0.0, 1.0]])
    assert finish_video_features(embs, normalize=False).shape == (3, 2)


def test_int8_encoder_writes_jax_int8_features(frames_and_ckpt):
    """make_eva_encoder(int8=True) on the CPU writes unit-norm features of
    the right shape, within 2e-3 of the JAX int8 production forward's
    (fq+v3+flat+tp+fm, Pallas in interpret mode)."""
    root, sd = frames_and_ckpt
    jcfg, tcfg = configs(TINY224)
    jax_apply = jax_build(jax_params(sd, TINY224), jcfg, int8=True,
                          fused_quant=True, attn_v3=True, flat2d=True,
                          pad_tokens=True, fused_mlp=True, use_pallas=True,
                          interpret=True, dtype=jnp.float32)
    durations = {"v1": 6.4}
    jax_extract(str(root / "frames"), str(root / "jax8"),
                lambda im: jax_apply(jnp.asarray(im)), jax_preprocess,
                batch_size=4, durations=durations)
    enc, pre = make_eva_encoder(str(root / "pre"), dtype_name="float32",
                                int8=True, device="cpu", cfg=tcfg)
    out = root / "port8"
    assert extract_video_features(str(root / "frames"), str(out), enc, pre,
                                  batch_size=4, durations=durations) == 2
    for vid, n in (("v1", 6), ("v2", FRAMES["v2"])):
        got = np.load(out / f"{vid}.npy")
        assert got.shape == (n, TINY224["embed_dim"])
        assert got.dtype == np.float32 and np.isfinite(got).all()
        np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1,
                                   rtol=1e-5)
        np.testing.assert_allclose(got, np.load(root / "jax8" / f"{vid}.npy"),
                                   rtol=2e-3, atol=2e-3)


def test_unrolled_encoder_writes_flax_tower_features(frames_and_ckpt):
    """make_eva_encoder(scan=False) on the CPU writes the features of the
    JAX package's unrolled flax tower (use_pallas=True, K6 in interpret
    mode) at 2e-4; int8 is ignored on that path, as in the JAX encoder."""
    root, sd = frames_and_ckpt
    jcfg, tcfg = configs(TINY224)
    tower = FlaxEvaVisionTower(jcfg, use_pallas=True, interpret=True)
    params = jax_params(sd, TINY224)
    jax_extract(str(root / "frames"), str(root / "jax_unrolled"),
                lambda im: tower.apply(params, jnp.asarray(im)),
                jax_preprocess, batch_size=4)
    enc, pre = make_eva_encoder(str(root / "pre"), dtype_name="float32",
                                scan=False, int8=True, device="cpu",
                                cfg=tcfg)
    out = root / "port_unrolled"
    assert extract_video_features(str(root / "frames"), str(out), enc, pre,
                                  batch_size=4) == 2
    for vid in FRAMES:
        np.testing.assert_allclose(
            np.load(out / f"{vid}.npy"),
            np.load(root / "jax_unrolled" / f"{vid}.npy"), rtol=2e-4,
            atol=2e-4)


@pytest.mark.parametrize("scan", [True, False], ids=["scanned", "unrolled"])
def test_padded_heads_encoder_writes_the_same_features(frames_and_ckpt,
                                                       scan):
    """padded_heads=True (heads 32 -> 128 here) is an identity: the same
    features as the unpadded encoder at 2e-5, f32."""
    root, _ = frames_and_ckpt
    tcfg = configs(TINY224)[1]
    feats = {}
    for padded in (False, True):
        enc, pre = make_eva_encoder(str(root / "pre"), dtype_name="float32",
                                    padded_heads=padded, scan=scan,
                                    device="cpu", cfg=tcfg)
        out = root / f"padded_{padded}_{scan}"
        extract_video_features(str(root / "frames"), str(out), enc, pre,
                               batch_size=8, video_ids=["v1"])
        feats[padded] = np.load(out / "v1.npy")
    np.testing.assert_allclose(feats[True], feats[False], rtol=2e-5,
                               atol=2e-5)
