"""Faults planted in the program under test, for the tests and for
``control.py``: each breaks the timed path where it produces its result,
so the cell's comparison must come out not correct. Each takes ``setattr``
(``monkeypatch.setattr`` in a test, a recording one in ``control.py``).
The faults a cell can have are listed in ``faults/<cell>.py``; these are
the ones several cells share."""

from __future__ import annotations

import torch


def eval_answer_altered(setattr):
    """One episode's loss altered where the evaluation produces it."""
    from few_shot_seg_cwt_tpu_torch.episodic.engine import EpisodicEngine

    orig = EpisodicEngine.eval_metrics_batch

    def altered(self, *a, **k):
        out = orig(self, *a, **k)
        out["loss"] = out["loss"].clone()
        out["loss"][0] += 0.05
        return out

    setattr(EpisodicEngine, "eval_metrics_batch", altered)


def eval_half_batch(setattr):
    """Half the batch evaluated, its outputs standing for the other half."""
    from few_shot_seg_cwt_tpu_torch.episodic.engine import EpisodicEngine

    orig = EpisodicEngine.eval_metrics_batch

    def half(self, episodes, *a, w0=None, **k):
        e = len(episodes["q_img"])
        out = orig(self, {key: v[: e // 2] for key, v in episodes.items()}, *a,
                   w0=w0[: e // 2], **k)
        return {key: torch.cat([v, v])[:e] for key, v in out.items()}

    setattr(EpisodicEngine, "eval_metrics_batch", half)


def serve_answer_altered(setattr):
    """A quarter of each served mask's rows flipped."""
    from few_shot_seg_cwt_tpu_torch.episodic.engine import EpisodicEngine

    orig = EpisodicEngine.serve_batch

    def altered(self, *a, **k):
        mask = orig(self, *a, **k).clone()
        rows = mask.shape[1] // 4
        mask[:, :rows] = 1 - mask[:, :rows]
        return mask

    setattr(EpisodicEngine, "serve_batch", altered)


def train_state_unchanged(setattr):
    """The optimizer's step leaves the parameters and its state as they are."""
    setattr(torch.optim.SGD, "step", lambda self, closure=None: None)


def train_update_skipped_once_warm(setattr):
    """Every optimizer step after the first few leaves the parameters as
    they are: a fault the set-up's steps cannot see, only the window's."""
    orig = torch.optim.SGD.step
    calls = [0]

    def step(self, closure=None):
        calls[0] += 1
        return orig(self, closure) if calls[0] <= 4 else None

    setattr(torch.optim.SGD, "step", step)


def train_half_batch(setattr):
    """Each step's gradient from the first half of its episodes, their mean."""
    from few_shot_seg_cwt_tpu_torch.episodic.heads import HeadEngine

    orig = HeadEngine.backward_batch

    def half(self, episodes, generator=None, w0=None, deterministic=False):
        e = len(episodes["q_img"])
        return orig(self, {k: v[: e // 2] for k, v in episodes.items()}, generator,
                    None if w0 is None else w0[: e // 2], deterministic)

    setattr(HeadEngine, "backward_batch", half)


def ddp_exchange_left_out(setattr):
    """No gradient crosses between the cards: each rank steps on its own."""
    from few_shot_seg_cwt_tpu_torch.episodic import heads

    setattr(heads, "all_reduce_grads", lambda params: 0)
