"""Runtime meters (reference train.py:117-136 AverageMeter)."""

from __future__ import annotations

import time


class AverageMeter:
    """Tracks current value, running average, sum and count."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)


class StopWatch:
    """Batch/data timing split like the reference's batch_time/data_time
    meters (reference train.py:559, 635-643)."""

    def __init__(self):
        self.batch_time = AverageMeter()
        self.data_time = AverageMeter()
        self._t = time.perf_counter()

    def mark_data(self):
        now = time.perf_counter()
        self.data_time.update(now - self._t)
        return now

    def mark_batch(self):
        now = time.perf_counter()
        self.batch_time.update(now - self._t)
        self._t = now
        return now
