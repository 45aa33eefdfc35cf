"""Episode-stream replay: evaluate on a recorded episode composition.

The port's own copy of ``few_shot_seg_cwt_tpu.data.replay``. A parity bar in
mIoU points is adjudicated over 1000 sampled episodes whose sampling noise is
of the same order as the bar itself. To separate framework delta from
sampling delta, a recorder walks the reference's seeded sampler (reference:
src/test.py:44-51 seeding; src/dataset/dataset.py:207-261 sampling) and logs
each episode's composition; this module replays such a log verbatim through
the port's evaluation, so every framework scores the same episode stream.

Log format (JSON lines, one episode each):

    {"q": ["JPEGImages/x.jpg", "SegmentationClassAug/x.png"],
     "cls": 7,
     "s": [["JPEGImages/y.jpg", "SegmentationClassAug/y.png"], ...]}

Paths are relative to ``data_root`` (absolute paths pass through untouched);
``cls`` is the RAW dataset class id chosen for the episode (the reference's
``class_chosen``), not the fold-local rank.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from . import transforms as T
from .classes import resolve_val_classes
from .episodic import _read_pair, binarize, pad_support_static


def load_episode_log(path: str) -> List[Dict]:
    episodes = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                episodes.append(json.loads(line))
    if not episodes:
        raise ValueError(f"empty episode log {path}")
    return episodes


class ReplayEpisodicDataset:
    """Episodes built from a recorded log instead of the random sampler.

    Yields the same dict schema as ``EpisodicDataset`` (q_img/q_label/s_img/
    s_label/cls/n_shot) through the same val pipeline, so every consumer
    (EpisodeLoader, validate_transformer) works unchanged.
    """

    def __init__(self, cfg, log_path: str,
                 transform: Optional[T.Compose] = None):
        self.cfg = cfg
        self.episodes = load_episode_log(log_path)
        self.data_root = cfg.data_root
        self.max_shot = cfg.shot
        self.class_list = resolve_val_classes(cfg)
        self.transform = transform or T.build_val_pipeline(cfg)
        for i, ep in enumerate(self.episodes):
            if len(ep["s"]) > self.max_shot:
                raise ValueError(
                    f"episode {i} has {len(ep['s'])} supports > shot={self.max_shot};"
                    " set --opts shot accordingly")

    def __len__(self) -> int:
        return len(self.episodes)

    def _abs(self, rel: str) -> str:
        return rel if os.path.isabs(rel) else os.path.join(self.data_root, rel)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        ep = self.episodes[index]
        class_chosen = int(ep["cls"])

        image, label = _read_pair(self._abs(ep["q"][0]), self._abs(ep["q"][1]))
        label = binarize(label, class_chosen)
        q_img, q_label = self.transform(image, label)

        s_imgs, s_labels = [], []
        for sp, lp in ep["s"]:
            s_img, s_lab_raw = _read_pair(self._abs(sp), self._abs(lp))
            # reference orders the support writes 255-last (dataset.py:275-279)
            # vs the query's 255-first — identical outcome, shared helper
            s_lab = binarize(s_lab_raw, class_chosen)
            img_t, lab_t = self.transform(s_img, s_lab)
            s_imgs.append(img_t[None])
            s_labels.append(lab_t[None])

        s_img_arr = np.concatenate(s_imgs, 0).astype(np.float32)
        s_lab_arr = np.concatenate(s_labels, 0).astype(np.int32)
        shot = s_img_arr.shape[0]
        # static-shape pad, same rule as the sampler
        s_img_arr, s_lab_arr = pad_support_static(s_img_arr, s_lab_arr,
                                                  self.max_shot)

        subcls = self.class_list.index(class_chosen) + 1
        return {
            "q_img": q_img.astype(np.float32),
            "q_label": q_label.astype(np.int32),
            "s_img": s_img_arr,
            "s_label": s_lab_arr,
            "cls": np.int32(subcls),
            "n_shot": np.int32(shot),
        }
