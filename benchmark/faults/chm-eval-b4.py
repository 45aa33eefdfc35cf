"""The faults of chm-eval-b4: an answer altered, half the batch left out,
CHM6d's links between different scale pairs left out, and the mutual
nearest-neighbour filter skipped."""

import torch


def head_eval_answer_altered(setattr):
    """One episode's loss altered where the head's evaluation produces it."""
    from few_shot_seg_cwt_tpu_torch.episodic.heads import HeadEngine

    orig = HeadEngine.eval_metrics_batch

    def altered(self, *a, **k):
        out = orig(self, *a, **k)
        out["loss"] = out["loss"].clone()
        out["loss"][0] += 0.05
        return out

    setattr(HeadEngine, "eval_metrics_batch", altered)


def head_eval_half_batch(setattr):
    """Half the batch evaluated, its outputs standing for the other half."""
    from few_shot_seg_cwt_tpu_torch.episodic.heads import HeadEngine

    orig = HeadEngine.eval_metrics_batch

    def half(self, episodes, *a, w0=None, **k):
        e = len(episodes["q_img"])
        out = orig(self, {key: v[: e // 2] for key, v in episodes.items()}, *a,
                   w0=w0[: e // 2], **k)
        return {key: torch.cat([v, v])[:e] for key, v in out.items()}

    setattr(HeadEngine, "eval_metrics_batch", half)


def chm6d_scale_links_left_out(setattr):
    """CHM6d's kernel keeps only the blocks from each scale pair to itself:
    the 40 links between different scale pairs are left out."""
    from few_shot_seg_cwt_tpu_torch.models.chm import CHM6d

    orig = CHM6d.channel_kernel

    def diagonal(self, nsp_side):
        k = orig(self, nsp_side)
        nsp = k.shape[-1]
        return k * torch.eye(nsp, dtype=k.dtype, device=k.device)

    setattr(CHM6d, "channel_kernel", diagonal)


def chm_mutual_filter_skipped(setattr):
    """The CHM head reads out its softplus volume without the mutual
    nearest-neighbour filter."""
    from few_shot_seg_cwt_tpu_torch.models import chm

    setattr(chm, "mutual_nn_filter", lambda corr: corr)


FAULTS = [head_eval_answer_altered, head_eval_half_batch, chm6d_scale_links_left_out,
          chm_mutual_filter_skipped]
