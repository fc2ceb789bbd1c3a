"""The inputs a seed makes: the same seed gives the same weights, frames,
videos and sample; every seed sends the same set of lengths."""

import itertools
import math

import numpy as np
import pytest
import torch

from portbench import inputs, registry
from portbench.systems import eva_extract
from portbench.systems.eva_extract import Video
from portbench.systems.eva_extract_check import sample
from portbench.tests.tiny import SEED, TINY, tiny_cell

SEEDS = [0, 7, SEED, 2 ** 40 + 3, -5]


def _plan(traffic, seed, k):
    return list(itertools.islice(inputs.videos(traffic, seed), k))


@pytest.mark.parametrize("seed", SEEDS)
def test_same_seed_same_inputs(seed):
    cell = tiny_cell("eva-clip-g14-int8.corpus")
    cfg, traffic = cell.config, cell.traffic
    a, b = (eva_extract.make_weights(cfg, seed, "cpu") for _ in range(2))
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert np.array_equal(eva_extract.frame_pool(traffic, cfg, seed),
                          eva_extract.frame_pool(traffic, cfg, seed))
    assert _plan(traffic, seed, 40) == _plan(traffic, seed, 40)
    videos = [Video(n, 0.0, o) for n, o, _ in _plan(traffic, seed, 9)]
    assert (sample(videos, 16, seed)
            == sample(videos, 16, seed))


def test_seeds_differ():
    cfg = dict(TINY, patch_size=14)
    w = [eva_extract.make_weights(cfg, s, "cpu")["head.weight"] for s in (1, 2)]
    assert not torch.equal(*w)
    traffic = registry.cell("eva-clip-g14-int8.corpus",
                            registry.benchmark()).traffic
    assert _plan(traffic, 1, 16) != _plan(traffic, 2, 16)


@pytest.mark.parametrize("mix", ["corpus", "clips"])
def test_every_seed_sends_the_same_set_of_lengths(mix):
    traffic = registry.cell(f"eva-clip-g14-int8.{mix}",
                            registry.benchmark()).traffic
    k = traffic["length_s"]["strata"]
    want = sorted(inputs.video_lengths(traffic))
    for seed in SEEDS:
        plan = _plan(traffic, seed, 3 * k)
        for i in range(0, 3 * k, k):
            assert sorted(s for _, _, s in plan[i:i + k]) == want


def test_corpus_and_clips_as_the_mixes_state():
    b = registry.benchmark()
    corpus = inputs.video_lengths(registry.cell("eva-clip-g14-int8.corpus",
                                                b).traffic)
    batches = [math.ceil(n / 128) for n in corpus]
    assert np.mean(corpus) == pytest.approx(390, abs=1)
    assert np.mean(batches) == 3.5
    assert sum(corpus) / (128 * sum(batches)) == pytest.approx(0.87, abs=0.01)
    clips = inputs.video_lengths(registry.cell("eva-clip-g14-int8.clips",
                                               b).traffic)
    assert max(clips) <= 128 and np.mean(clips) / 128 == pytest.approx(
        0.25, abs=0.01)


def test_quantiles_give_the_set_of_lengths():
    assert inputs.video_lengths({"length_s": {"quantiles": [4.4, 30,
                                                            97.6]}}) == [
        4, 30, 98]
    assert inputs.video_lengths({"length_s": {"low": 0, "high": 40,
                                              "strata": 4}}) == [
        5, 15, 25, 35]


def test_batches_are_the_videos_frames_zero_padded():
    pool = np.arange(5 * 2 * 2 * 3, dtype=np.uint8).reshape(5, 2, 2, 3) + 1
    got = list(eva_extract.video_batches(pool, 3, 7, 4))
    assert [k for _, k in got] == [4, 3]
    want = pool[eva_extract.frame_indices(3, 7, 5)]
    assert np.array_equal(np.concatenate([got[0][0], got[1][0][:3]]), want)
    assert not got[1][0][3].any()


def test_sample_holds_last_frames_and_stays_in_range():
    videos = [Video(n, 0.0, 0) for n in (5, 130, 1, 64)]
    picks = sample(videos, 6, 3)
    assert all(0 <= j < videos[i].n for i, j in picks)
    assert sum(j == videos[i].n - 1 for i, j in picks[:3]) == 3
