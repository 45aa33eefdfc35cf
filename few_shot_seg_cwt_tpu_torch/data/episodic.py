"""Episode sampling: (support set, query) pairs as pure-numpy records.

The port's own copy of ``few_shot_seg_cwt_tpu.data.episodic``, reproducing
the reference episodic dataset (reference: src/dataset/dataset.py:180-403)
with the same draws from Python's ``random`` and numpy's global generator
in the same order, so the same seeds give the JAX package's episodes:

* query image: pick a random present class from the allowed fold, binarize
  the label (chosen class -> 1, 255 preserved);
* support: ``shot`` distinct images containing the class, excluding the query
  (rejection sampling identical to src:251-261);
* ``random_shot`` draws shot ~ U[1, max_shot]; static shapes are kept by
  padding support to ``max_shot`` with all-255 labels (exact no-ops in the
  inner loop);
* meta-augmentation (``meta_aug``>1): fg-ratio-adaptive extra support views
  (FitCrop / ColorJitter / RandScale, which need OpenCV), aug_type in
  {0,1,2,3,10} (src:330-403).

``StandardDataset`` gives stage-1 pretraining's multi-class records.
Images and masks decode through ``data.imread`` (PNG without OpenCV).
Returned episodes are dicts of numpy arrays in NHWC; batching and the copy to
the card live in ``data.loader``.
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import imread
from . import transforms as T
from .classes import resolve_train_classes, resolve_val_classes
from .listing import make_dataset


def _read_pair(image_path: str, label_path: str) -> Tuple[np.ndarray, np.ndarray]:
    image = imread.read(image_path).astype(np.float32)
    label = imread.read(label_path, gray=True)
    if image.shape[:2] != label.shape[:2]:
        raise RuntimeError(f"image/label shape mismatch: {image_path} {label_path}")
    return image, label


def binarize(label: np.ndarray, target_class: int) -> np.ndarray:
    out = np.zeros_like(label)
    out[label == 255] = 255
    out[label == target_class] = 1
    return out


def pad_support_static(s_img_arr: np.ndarray, s_lab_arr: np.ndarray,
                       max_total: int) -> Tuple[np.ndarray, np.ndarray]:
    """Pad support stacks to a static shot count: zero images, all-255 labels
    (padded shots are invisible to the loss/weights and masked by the heads)."""
    total = s_img_arr.shape[0]
    if total < max_total:
        pad_n = max_total - total
        s_img_arr = np.concatenate(
            [s_img_arr, np.zeros((pad_n, *s_img_arr.shape[1:]), np.float32)], 0
        )
        s_lab_arr = np.concatenate(
            [s_lab_arr, np.full((pad_n, *s_lab_arr.shape[1:]), 255, np.int32)], 0
        )
    return s_img_arr, s_lab_arr


class EpisodicDataset:
    """Index-addressable episode sampler (one episode per query image index)."""

    def __init__(self, cfg, train: bool, transform: Optional[T.Compose] = None):
        self.cfg = cfg
        self.train = train
        self.shot = cfg.shot
        self.max_shot = cfg.shot
        self.random_shot = cfg.random_shot
        self.image_size = cfg.image_size
        self.meta_aug = cfg.get("meta_aug", 0)
        self.aug_th = cfg.get("aug_th", [0.15, 0.30])
        self.aug_type = cfg.get("aug_type", 0)
        self.padding = (
            [v * 255 for v in cfg.mean] if cfg.get("padding") == "avg" else None
        )

        self.class_list = (
            resolve_train_classes(cfg) if train else resolve_val_classes(cfg)
        )
        list_file = cfg.train_list if train else cfg.val_list
        self.data_list, self.class_files = make_dataset(
            cfg.data_root, list_file, self.class_list,
            num_workers=cfg.workers, cache_dir=cfg.get("scan_cache", ".scan_cache"),
        )
        self.transform = transform or (
            T.build_aug_pipeline(cfg, cfg.augmentations) if train
            else T.build_val_pipeline(cfg)
        )
        # finishing stages for meta-aug views, built explicitly (positional
        # slicing breaks when the resize+normalize tail is fused natively):
        # _resize_norm = the pipeline's resize flavour + normalization;
        # _norm_only   = normalization alone (view already at full canvas).
        if "resize_np" in cfg.augmentations:
            self._resize_norm = [T.ResizeSquare((cfg.image_size, cfg.image_size)),
                                 T.ToNormalized(cfg.mean, cfg.std)]
        else:
            self._resize_norm = [T.FusedResizeNormalize(
                cfg.image_size, cfg.mean, cfg.std, padding=self.padding)]
        self._norm_only = [T.ToNormalized(cfg.mean, cfg.std)]

    def __len__(self) -> int:
        return len(self.data_list)

    # ------------------------------------------------------------------ #

    def sample(self, index: int) -> Dict[str, np.ndarray]:
        image_path, label_path = self.data_list[index]
        image, label = _read_pair(image_path, label_path)

        present = [
            c for c in np.unique(label).tolist()
            if c not in (0, 255) and c in self.class_list
        ]
        if not present:
            raise RuntimeError(f"no valid class in {label_path}")
        class_chosen = int(np.random.choice(present))
        label = binarize(label, class_chosen)

        files = self.class_files[class_chosen]
        num_file = len(files)

        shot = random.randint(1, self.shot) if self.random_shot else self.shot

        sup_paths: List[Tuple[str, str]] = []
        chosen_idx: List[int] = []
        for _ in range(shot):
            idx = random.randint(1, num_file) - 1
            sup = (image_path, label_path)
            attempts = 0
            while (sup == (image_path, label_path)) or idx in chosen_idx:
                # the reference's rejection loop (dataset.py:254-258) spins
                # FOREVER when the class has < shot+1 distinct images; fail
                # loudly instead of hanging the loader thread
                attempts += 1
                if attempts > 20 * num_file + 20:
                    raise RuntimeError(
                        f"class {class_chosen}: cannot draw {shot} distinct "
                        f"support images (only {num_file} candidates, query "
                        f"excluded) — reduce shot or check the list files"
                    )
                idx = random.randint(1, num_file) - 1
                sup = files[idx]
            chosen_idx.append(idx)
            sup_paths.append(sup)

        s_imgs: List[np.ndarray] = []
        s_labels: List[np.ndarray] = []
        for sp, lp in sup_paths:
            s_img, s_lab_raw = _read_pair(sp, lp)
            s_lab = np.zeros_like(s_lab_raw)
            s_lab[s_lab_raw == class_chosen] = 1
            s_lab[s_lab_raw == 255] = 255
            if self.meta_aug > 1:
                ts_img, ts_lab = self._support_with_aug(s_img, s_lab)
            else:
                img_t, lab_t = self.transform(s_img, s_lab)
                ts_img, ts_lab = img_t[None], lab_t[None]
            s_imgs.append(ts_img)
            s_labels.append(ts_lab)

        q_img, q_label = self.transform(image, label)

        s_img_arr = np.concatenate(s_imgs, axis=0).astype(np.float32)
        s_lab_arr = np.concatenate(s_labels, axis=0).astype(np.int32)

        # static-shape padding for random_shot / meta_aug variability
        max_total = self.max_shot * (1 + max(self.meta_aug - 1, 0)) \
            if self.meta_aug > 1 else self.max_shot
        s_img_arr, s_lab_arr = pad_support_static(s_img_arr, s_lab_arr, max_total)

        # the class id reported is the fold-local rank + 1 (reference :265)
        subcls = self.class_list.index(class_chosen) + 1
        return {
            "q_img": q_img.astype(np.float32),
            "q_label": q_label.astype(np.int32),
            "s_img": s_img_arr,
            "s_label": s_lab_arr,
            "cls": np.int32(subcls),
            "n_shot": np.int32(shot),
        }

    __getitem__ = sample

    # ------------------------------------------------------------------ #
    # meta-augmentation of support views (reference src:330-403)
    # ------------------------------------------------------------------ #

    def _support_with_aug(self, s_img, s_lab):
        """Exactly ``meta_aug`` views per shot: [org, aug_1, ..].

        The reference concatenates a VARIABLE number of views per shot
        (aug_type 1/3 can emit 2 extras, aug_type 10 sometimes none,
        dataset.py:310-314) and then slices with ``tensor_slice``, which
        reshapes to (n//2, 2) and silently misaligns whenever a shot did not
        yield exactly [org, aug] (util.py:20-29) — only the shipped
        aug_type 0 config is coherent. Here every shot contributes exactly
        ``meta_aug`` rows: extras beyond meta_aug-1 are dropped, and a
        missing aug view is an org duplicate (no augmentation available ->
        use the original), so the heads' strict [org_i, aug_i, ...]
        interleave and the static batch shape both always hold.
        """
        img_t, lab_t = self.transform(s_img, s_lab)
        freq = np.bincount(s_lab.flatten(), minlength=2)
        fg_ratio = freq[1] / max(freq.sum(), 1)
        fn = {0: self._aug0, 1: self._aug1, 2: self._aug2,
              3: self._aug3, 10: self._aug10}[self.aug_type]
        extra = fn(fg_ratio, s_img, s_lab)
        views_i = [img_t[None]]
        views_l = [lab_t[None]]
        if extra is not None:
            e_imgs, e_labs = extra
            views_i += list(e_imgs)
            views_l += list(e_labs)
        views_i = views_i[: self.meta_aug]
        views_l = views_l[: self.meta_aug]
        while len(views_i) < self.meta_aug:
            views_i.append(views_i[0].copy())
            views_l.append(views_l[0].copy())
        return np.concatenate(views_i, axis=0), np.concatenate(views_l, axis=0)

    def _tail(self, n: int) -> List:
        """Finishing stages for augmented views: n=2 -> resize+normalize,
        n=1 -> normalize only (mirrors the reference's segtransform[-3:] /
        [-2:] slices without depending on pipeline internals)."""
        return self._resize_norm if n == 2 else self._norm_only

    def _apply(self, stages, img, lab):
        out_i, out_l = T.Compose(stages)(img, lab)
        return out_i[None], out_l[None]

    def _aug0(self, fg_ratio, img, lab):
        if fg_ratio <= self.aug_th[0]:
            k = 2 if fg_ratio <= 0.03 else 3
            i, l = self._apply([T.FitCrop(k=k)] + self._tail(2), img, lab)
        elif fg_ratio < self.aug_th[1]:
            i, l = self._apply([T.ColorJitter("b")] + self._tail(2), img, lab)
        else:
            scale = self.image_size / max(lab.shape) * 0.8
            i, l = self._apply(
                [T.RandScale((scale, scale + 0.1), fixed_size=self.image_size,
                             padding=self.padding)] + self._tail(1), img, lab)
        return [i], [l]

    def _aug10(self, fg_ratio, img, lab):
        if fg_ratio <= self.aug_th[0]:
            k = 2 if fg_ratio <= 0.03 else 3
            i, l = self._apply([T.FitCrop(k=k)] + self._tail(2), img, lab)
        elif fg_ratio >= self.aug_th[1]:
            scale = self.image_size / max(lab.shape) * 0.7
            i, l = self._apply(
                [T.RandScale((scale, scale + 0.1), fixed_size=self.image_size,
                             padding=self.padding)] + self._tail(1), img, lab)
        else:
            return None
        return [i], [l]

    def _aug1(self, fg_ratio, img, lab):
        scale = self.image_size / max(lab.shape)
        rs = lambda s: T.RandScale((s, s + 0.1), fixed_size=self.image_size,
                                   padding=self.padding)
        if fg_ratio <= self.aug_th[0]:
            a = self._apply([T.FitCrop(k=2)] + self._tail(2), img, lab)
            b = self._apply([T.FitCrop(k=3)] + self._tail(2), img, lab)
        elif fg_ratio < self.aug_th[1]:
            a = self._apply([T.FitCrop(k=3)] + self._tail(2), img, lab)
            b = self._apply([rs(scale * 0.85)] + self._tail(1), img, lab)
        else:
            a = self._apply([rs(scale * 0.85)] + self._tail(1), img, lab)
            b = self._apply([rs(scale * 0.85)] + self._tail(1), img, lab)
        return [a[0], b[0]], [a[1], b[1]]

    def _aug2(self, fg_ratio, img, lab):
        if fg_ratio <= 0.15:
            k = 2 if fg_ratio <= 0.05 else 3
            i, l = self._apply([T.FitCrop(k=k)] + self._tail(2), img, lab)
        else:
            i, l = self._apply(
                [T.RandomHorizontalFlip(p=1.0)] + self._tail(2), img, lab)
        return [i], [l]

    def _aug3(self, fg_ratio, img, lab):
        if fg_ratio <= self.aug_th[0]:
            k = 2 if fg_ratio <= 0.03 else 3
            crop_out = T.FitCrop(k=k, multi=True)(img, lab)
            a = self._apply(self._tail(2), crop_out[0], crop_out[1])
            if len(crop_out) == 4:
                b = self._apply(self._tail(2), crop_out[2], crop_out[3])
                return [a[0], b[0]], [a[1], b[1]]
            return [a[0]], [a[1]]
        if fg_ratio < self.aug_th[1]:
            i, l = self._apply([T.ColorJitter("b")] + self._tail(2), img, lab)
        else:
            scale = self.image_size / max(lab.shape) * 0.7
            i, l = self._apply(
                [T.RandScale((scale, scale + 0.1), fixed_size=self.image_size,
                             padding=self.padding)] + self._tail(1), img, lab)
        return [i], [l]


class StandardDataset:
    """Multi-class segmentation records ``{"img", "label"}`` for stage-1
    pretraining: the train (or val) list scanned for the fold's train
    classes, labels remapped to fold-local contiguous ids (0 stays
    background); any other class, and 255, becomes 255. Train records go
    through the config's augmentations, val records through resize +
    normalize."""

    def __init__(self, cfg, train: bool = True, transform: Optional[T.Compose] = None):
        self.cfg = cfg
        self.class_list = resolve_train_classes(cfg)
        list_file = cfg.train_list if train else cfg.val_list
        self.data_list, _ = make_dataset(
            cfg.data_root, list_file, self.class_list,
            num_workers=cfg.workers, cache_dir=cfg.get("scan_cache", ".scan_cache"),
        )
        self.transform = transform or (
            T.build_aug_pipeline(cfg, cfg.augmentations) if train
            else T.build_val_pipeline(cfg)
        )

    def __len__(self) -> int:
        return len(self.data_list)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        image_path, label_path = self.data_list[index]
        image, label = _read_pair(image_path, label_path)
        new_label = np.zeros_like(label)
        for c in np.unique(label).tolist():
            if c in (0, 255):
                continue
            new_label[label == c] = (self.class_list.index(c) + 1
                                     if c in self.class_list else 255)
        new_label[label == 255] = 255
        img, lab = self.transform(image, new_label)
        return {"img": img.astype(np.float32), "label": lab.astype(np.int32)}
