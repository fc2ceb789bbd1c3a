"""Multitask batch scheduling.

An own copy of hirest_tpu/data/multitask.py (the port imports nothing of the
JAX package).

Parity with the reference `MultitaskLoader` (hirest_dataset.py:636-693):
round-robin (one schedule slot per batch of each task) or balanced
sampling, with `random.Random(epoch).shuffle` of the task schedule and
pop-from-the-end consumption — the exact same task order per epoch given
the same task batch counts.
"""

from __future__ import annotations

import random
from typing import Iterator

from hirest_tpu_torch.data.batching import TaskBatcher


class MultitaskSchedule:
    def __init__(self, batchers: dict[str, TaskBatcher], shuffle: bool = True,
                 sampling: str = "roundrobin", n_batches: int | None = None):
        self.batchers = batchers
        self.shuffle = shuffle
        self.sampling = sampling
        self.n_batches = n_batches
        self.epoch_tasks: list[str] = []
        self.set_epoch(0)

    @property
    def task2len(self) -> dict[str, int]:
        return {task: len(b) for task, b in self.batchers.items()}

    def set_epoch(self, epoch: int) -> None:
        for b in self.batchers.values():
            b.set_epoch(epoch)

        if self.sampling == "roundrobin":
            epoch_tasks = []
            for task, b in self.batchers.items():
                epoch_tasks.extend([task] * len(b))
        elif self.sampling == "balanced":
            n = self.n_batches
            if n is None:
                n = sum(self.task2len.values()) // len(self.batchers)
            epoch_tasks = []
            for task in self.batchers:
                epoch_tasks.extend([task] * n)
        else:
            raise ValueError(self.sampling)

        if self.shuffle:
            random.Random(epoch).shuffle(epoch_tasks)
        self.epoch_tasks = epoch_tasks

    def __len__(self) -> int:
        return len(self.epoch_tasks)

    def __iter__(self) -> Iterator[dict]:
        iters = {task: iter(b) for task, b in self.batchers.items()}
        schedule = list(self.epoch_tasks)
        while schedule:
            task = schedule.pop()  # pop from the end, like the reference
            try:
                yield next(iters[task])
            except StopIteration:
                # reference parity (hirest_dataset.py:685-691): the epoch
                # ENDS at the first exhausted task. Swallowing it would
                # over-represent the larger tasks and make len(self)
                # overstate the steps that actually run — which sizes the
                # LR schedule (trainer.setup_optimizer(len(schedule))).
                # Unreachable in roundrobin mode (slots == batch counts);
                # it bites in balanced mode with uneven task sizes.
                return
