"""Running-metric meters (reference: src/util.py:199-234)."""

from __future__ import annotations


class AverageMeter:
    """Tracks current value, sum, count and mean."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count


class CompareMeter:
    """Tracks win-rate and mean difference of score1 vs score0."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = (0.0, 0.0)
        self.cnt = 0
        self.win_cnt = 0
        self.diff_sum = 0.0
        self.diff_avg = 0.0

    def update(self, score1: float, score0: float):
        self.val = (score1, score0)
        self.cnt += 1
        self.win_cnt += int(score1 > score0)
        self.diff_sum += score1 - score0
        self.diff_avg = self.diff_sum / self.cnt
