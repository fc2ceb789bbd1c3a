"""Bucketed batch assembly.

An own copy of hirest_tpu/data/batching.py. The reference pads each batch
to the batch max length (hirest_dataset.py:409-531); here every batch is
padded to the smallest configured frame bucket >= the batch max, as the
JAX package does, so both packages see the same padded shapes. Padding frames carry video_mask = 0 and are
excluded by the model's mask arithmetic (heads mask padded logits, the
temporal embedding zeroes padded positions).

`collate` returns plain numpy; the training/inference step converts to
device arrays (and shards them over the mesh) downstream.
"""

from __future__ import annotations

from typing import Iterator, Optional, Sequence

import numpy as np

from hirest_tpu_torch.data.features import FeatureStore

DEFAULT_BUCKETS = (64, 128, 256, 512, 1024, 2048)


def pick_bucket(n: int, buckets: Sequence[int]) -> int:
    for b in sorted(buckets):
        if n <= b:
            return b
    raise ValueError(f"sequence length {n} exceeds largest bucket {max(buckets)}")


def _pad_to(arr: np.ndarray, length: int) -> np.ndarray:
    if arr.shape[0] == length:
        return arr
    pad = [(0, length - arr.shape[0])] + [(0, 0)] * (arr.ndim - 1)
    return np.pad(arr, pad)


def collate(
    examples: list[dict],
    store: Optional[FeatureStore] = None,
    buckets: Sequence[int] = DEFAULT_BUCKETS,
    pad_batch_to: Optional[int] = None,
) -> dict:
    """Assemble a task-homogeneous batch dict of numpy arrays.

    Loads features on demand (when `store` is given), pads the time axis to
    a bucket, and carries the reference collate's metadata fields
    (video_fnames, prompts, tasks, video_duration, raw-text targets).
    `pad_batch_to` optionally pads the batch axis (with repeated first
    example + batch_mask) so the leading dim also stays static.
    """
    task = examples[0]["task"]
    assert all(e["task"] == task for e in examples), "mixed-task batch"

    feats = None
    asr = None
    if store is not None and store.video_feature_dir is not None:
        feats = []
        asr = [] if store.has_asr else None
        for e in examples:
            v = store.visual(e["fname"], e["n_model_frames"])
            feats.append(v)
            if asr is not None:
                n_raw = store.visual(e["fname"], -1).shape[0]
                asr.append(store.asr(e["fname"], n_raw, e["n_model_frames"]))

    max_len = max(e["n_frames"] for e in examples)
    if feats is not None:
        max_len = max(max_len, max(f.shape[0] for f in feats))
    bucket = pick_bucket(max_len, buckets)

    batch: dict = {
        "tasks": [e["task"] for e in examples],
        "prompts": [e["prompt"] for e in examples],
        "video_fnames": [e["fname"] for e in examples],
        "video_duration": [e["video_duration"] for e in examples],
        "n_frames": np.array([e["n_frames"] for e in examples], dtype=np.int32),
    }

    def stack_mask(key):
        return np.stack([_pad_to(np.asarray(e[key], dtype=np.int32), bucket)
                         for e in examples])

    batch["video_mask"] = stack_mask("video_mask")
    batch["moment_mask"] = stack_mask("moment_mask")
    if "prev_boundary_mask" in examples[0]:
        batch["prev_boundary_mask"] = stack_mask("prev_boundary_mask")

    row_len = None
    if feats is not None:
        from hirest_tpu_torch import native

        batch["vis_feats"] = native.pack_batch(feats, bucket)
        # actual feature length can differ from the n_frames metadata in
        # BOTH directions; every frame-indexed array must agree on the
        # effective length n or train/predict masks diverge (predict masks
        # logits with video_mask, the losses mask with moment_mask)
        row_len = np.array([min(f.shape[0], bucket) for f in feats])
        for i, f in enumerate(feats):
            n = row_len[i]
            if n != batch["video_mask"][i].sum():
                vm = np.zeros(bucket, dtype=np.int32)
                vm[:n] = 1
                batch["video_mask"][i] = vm
            if batch["moment_mask"][i, n:].any():
                batch["moment_mask"][i, n:] = 0
                if not batch["moment_mask"][i].any():
                    # degenerate: the annotated moment lies entirely past
                    # the real features — keep one valid frame so masked
                    # losses stay finite
                    batch["moment_mask"][i, n - 1] = 1
        if asr is not None:
            batch["asr_feats"] = native.pack_batch(asr, bucket)

    for key in ("moment_retrieval_start_target", "moment_retrieval_end_target",
                "moment_segmentation_target"):
        if key in examples[0]:
            t = np.array([e[key] for e in examples], dtype=np.int32)
            if row_len is not None:
                # bin targets must stay inside the real feature range —
                # video_mask makes bins >= n unreachable at predict time
                t = np.minimum(t, (row_len - 1).astype(np.int32))
            batch[key] = t

    if "moment_bound_frames" in examples[0]:
        batch["moment_bound_frames"] = np.array(
            [e["moment_bound_frames"] for e in examples], dtype=np.int32)
    if "all_bound_frames" in examples[0]:
        batch["all_bound_frames"] = [e["all_bound_frames"] for e in examples]
    if "target_text_raw" in examples[0]:
        batch["target_text_raw"] = [e["target_text_raw"] for e in examples]
    for key in ("input_caption_ids", "output_caption_ids", "decoder_mask"):
        if key in examples[0]:
            batch[key] = np.stack([np.asarray(e[key], dtype=np.int32) for e in examples])

    if pad_batch_to is not None and len(examples) < pad_batch_to:
        n = len(examples)
        batch["batch_mask"] = np.array([1] * n + [0] * (pad_batch_to - n), dtype=np.int32)
        for k, v in list(batch.items()):
            if isinstance(v, np.ndarray) and v.ndim >= 1 and v.shape[0] == n:
                reps = np.concatenate([v, np.repeat(v[:1], pad_batch_to - n, axis=0)])
                batch[k] = reps
    elif pad_batch_to is not None:
        batch["batch_mask"] = np.ones(len(examples), dtype=np.int32)

    return batch


class TaskBatcher:
    """Deterministic epoch-shuffled batch iterator for one task's examples,
    with optional host sharding (the DistributedSampler replacement:
    per-host `rank::num_hosts` striding over an epoch-seeded permutation)."""

    def __init__(self, examples: list[dict], batch_size: int,
                 store: Optional[FeatureStore] = None,
                 buckets: Sequence[int] = DEFAULT_BUCKETS,
                 shuffle: bool = False, seed: int = 0,
                 num_hosts: int = 1, host_id: int = 0,
                 drop_last: bool = False,
                 pad_batch: bool = False,
                 pad_hosts: bool = False):
        self.examples = examples
        self.batch_size = batch_size
        self.store = store
        self.buckets = buckets
        self.shuffle = shuffle
        self.seed = seed
        self.num_hosts = num_hosts
        self.host_id = host_id
        self.drop_last = drop_last
        self.pad_hosts = pad_hosts
        self.pad_batch = pad_batch
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _indices(self) -> np.ndarray:
        idx = np.arange(len(self.examples))
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            rng.shuffle(idx)
        if self.pad_hosts and self.num_hosts > 1 and len(idx):
            # DistributedSampler parity (reference run.py:853 via torch,
            # hirest_dataset.py:604-606): pad by wrapping so every host
            # sees the SAME index count — unequal counts give hosts
            # different batch counts and different multitask schedules,
            # desyncing collective train/eval steps across the mesh.
            # Off for independent offline inference sharding (no
            # collectives there; the JSON merge must not see duplicates).
            total = -(-len(idx) // self.num_hosts) * self.num_hosts
            idx = np.concatenate([idx, idx[: total - len(idx)]])
        return idx[self.host_id:: self.num_hosts]

    def __len__(self) -> int:
        n = len(self._indices())
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[dict]:
        idx = self._indices()
        for i in range(0, len(idx), self.batch_size):
            chunk = idx[i: i + self.batch_size]
            if self.drop_last and len(chunk) < self.batch_size:
                break
            yield collate([self.examples[j] for j in chunk], self.store,
                          self.buckets,
                          pad_batch_to=self.batch_size if self.pad_batch else None)
