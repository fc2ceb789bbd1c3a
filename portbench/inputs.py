"""What a run's traffic is, made from `--seed`: the seed streams every
input draws from, and the one general generator of requests that reads a
mix's file (traffic/<mix>.json).

The same seed gives the same inputs. Each kind of input draws from a
stream of its own (`stream`), so a change to how one is drawn moves no
other.
"""

from __future__ import annotations

import numpy as np


def stream(seed: int, name: str) -> int:
    """A 63-bit seed for the stream `name` of a run's seed (any integer)."""
    tag = int.from_bytes(name.encode(), "little")
    seq = np.random.SeedSequence([seed % 2 ** 64, tag])
    return int(seq.generate_state(1, np.uint64)[0]) >> 1


def video_lengths(traffic: dict) -> list:
    """The mix's set of request lengths in seconds, each at the middle of
    one of `k` strata of equal probability: `length_s.quantiles`, the
    lengths at those quantiles of a stated distribution, as given; or
    `length_s.low`, `.high` and `.strata`, those of the uniform
    distribution over [low, high]. Every seed sends this same set, in its
    own order."""
    spec = traffic["length_s"]
    if "quantiles" in spec:
        return [round(q) for q in spec["quantiles"]]
    low, high, k = spec["low"], spec["high"], spec["strata"]
    return [round(low + (high - low) * (i + 0.5) / k) for i in range(k)]


def videos(traffic: dict, seed: int):
    """Endless (frames, pool offset, seconds) of requests: the set of
    lengths, shuffled by the seed, over and over, at the mix's frame rate;
    each reads the mix's pool of `frame_pool` inputs from an offset the seed
    draws."""
    rng = np.random.default_rng(stream(seed, "videos"))
    lengths = video_lengths(traffic)
    fps = traffic["fps"]
    while True:
        for i in rng.permutation(len(lengths)):
            yield (lengths[i] * fps,
                   int(rng.integers(0, traffic["frame_pool"])), lengths[i])
