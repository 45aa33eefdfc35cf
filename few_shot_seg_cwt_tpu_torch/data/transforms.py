"""CPU-side image/mask transforms of the episode loader (numpy, the host
C++ core, and cv2/PIL where nothing else will do).

The port's own copy of ``few_shot_seg_cwt_tpu.data.transforms`` (reference:
src/dataset/transform.py), with the pixel-level conventions that matter for
mIoU parity:

* ``ResizeKeepAspect``: aspect-preserving resize where the *long* side becomes
  the target and both sides are floored to a multiple of 8, then zero- (or
  mean-) padded bottom/right to a square; label padding is 255
  (src/dataset/transform.py:110-167);
* label resizes are nearest, image resizes bilinear (cv2 half-pixel grid);
* ``FitCrop`` crops around the largest connected component of the mask
  (src:312-368) — connected components via cv2;
* ColorJitter brightness/saturation/contrast variants (src:435-478).

The ``resize`` + normalize tail runs fused in the host C++ core
(``data.native``) as ``FusedResizeNormalize``, bit for bit the JAX
package's. ``resize_np`` is what the JAX package runs: cv2's
``ResizeSquare``, then ``ToNormalized``, so its episodes are the JAX
package's bits too. Flips are numpy. So the default pipelines (flips,
``resize``) need neither OpenCV nor Pillow; ``resize_np`` and the other
transforms import them when called and raise ``ImportError`` naming the
transform without them.

Outputs are float32 HWC images scaled to [0,1] then mean/std normalized, and
int32 labels. Random decisions draw from Python's ``random`` module (numpy's
global generator for ColorJitter 's'), in the JAX package's order.
"""

from __future__ import annotations

import math
import random
from typing import List, Optional, Sequence, Tuple

import numpy as np

from . import native

Pair = Tuple[np.ndarray, np.ndarray]


def _cv2(transform: str):
    """OpenCV, imported when ``transform``, a transform that needs it,
    first runs."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError(f"{transform} needs OpenCV (cv2), which does not import "
                          f"here ({e}); the default pipelines (flips, resize) run "
                          "without it") from e
    return cv2


class Compose:
    def __init__(self, segtransform: Sequence):
        self.segtransform = list(segtransform)

    def __call__(self, image, label=None):
        if label is None:
            for t in self.segtransform:
                image = t(image, None)
            return image
        for t in self.segtransform:
            image, label = t(image, label)
        return image, label


class ToNormalized:
    """/255, then (x - mean) / std; label -> int32. Replaces ToTensor+Normalize."""

    def __init__(self, mean: Sequence[float], std: Optional[Sequence[float]] = None):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32) if std is not None else None

    def __call__(self, image, label):
        img = np.asarray(image, np.float32) / 255.0
        img = img - self.mean
        if self.std is not None:
            img = img / self.std
        if label is None:
            return img
        return img, np.asarray(label, np.int32)


def _mult8_floor(v: int) -> int:
    return (v // 8) * 8 if v % 8 != 0 else v


class ResizeKeepAspect:
    """Long side -> size, both floored to x8, padded bottom/right to square."""

    def __init__(self, size: int, padding: Optional[Sequence[float]] = None):
        self.size = size
        self.padding = padding  # image pad value per channel (None = zeros)

    def __call__(self, image, label):
        cv2 = _cv2("ResizeKeepAspect")
        size = self.size

        def new_hw(h: int, w: int) -> Tuple[int, int]:
            if h >= w:
                nh, nw = size, int(w * size / h)
            else:
                nh, nw = int(h * size / w), size
            return _mult8_floor(nh), _mult8_floor(nw)

        nh, nw = new_hw(image.shape[0], image.shape[1])
        img = cv2.resize(
            np.asarray(image, np.float32), dsize=(nw, nh), interpolation=cv2.INTER_LINEAR
        )
        canvas = np.zeros((size, size, 3), np.float32)
        if self.padding is not None:
            canvas[:] = np.asarray(self.padding, np.float32)
        canvas[:nh, :nw, :] = img
        if label is None:
            # (the reference returns (image, nh, nw) here, but that path is
            # dead there and breaks Compose; return the canvas alone)
            return canvas
        nh2, nw2 = new_hw(label.shape[0], label.shape[1])
        lbl = cv2.resize(
            np.asarray(label, np.float32), dsize=(nw2, nh2), interpolation=cv2.INTER_NEAREST
        )
        lbl_canvas = np.full((size, size), 255.0, np.float32)
        lbl_canvas[:nh2, :nw2] = lbl
        return canvas, lbl_canvas


class ResizeSquare:
    """Plain square resize (reference Resize_np, src:169-185)."""

    def __init__(self, size):
        self.size = (size, size) if isinstance(size, int) else tuple(size)

    def __call__(self, image, label):
        cv2 = _cv2("ResizeSquare")
        img = cv2.resize(np.asarray(image, np.float32), dsize=self.size,
                         interpolation=cv2.INTER_LINEAR)
        lbl = cv2.resize(np.asarray(label, np.float32), dsize=self.size,
                         interpolation=cv2.INTER_NEAREST)
        return img, lbl


class RandScale:
    """Random scale in [lo, hi]; optional fixed-size canvas with padding."""

    def __init__(self, scale, aspect_ratio=None, fixed_size: Optional[int] = None,
                 padding: Optional[Sequence[float]] = None):
        assert len(scale) == 2 and 0 < scale[0] < scale[1]
        self.scale = scale
        self.aspect_ratio = aspect_ratio
        self.fixed_size = fixed_size
        self.padding = padding

    def __call__(self, image, label):
        cv2 = _cv2("RandScale")
        s = self.scale[0] + (self.scale[1] - self.scale[0]) * random.random()
        ar = 1.0
        if self.aspect_ratio is not None:
            ar = self.aspect_ratio[0] + (
                self.aspect_ratio[1] - self.aspect_ratio[0]
            ) * random.random()
            ar = math.sqrt(ar)
        fx, fy = s * ar, s / ar
        image = cv2.resize(np.asarray(image, np.float32), None, fx=fx, fy=fy,
                           interpolation=cv2.INTER_LINEAR)
        label = cv2.resize(np.asarray(label, np.float32), None, fx=fx, fy=fy,
                           interpolation=cv2.INTER_NEAREST)
        if self.fixed_size:
            # clamp the paste: the reference avoids overflow only because its
            # meta-aug paths hardcode 473 (get_aug_data*, dataset.py:338);
            # generalizing fixed_size to image_size (e.g. 321) means a scaled
            # long side can exceed the canvas — crop instead of crashing.
            # CENTER the crop window (not top-left) so foreground is never
            # systematically lost from the bottom/right; centering draws no
            # RNG, keeping the stream aligned with the reference's draws
            nh, nw = min(image.shape[0], self.fixed_size), min(image.shape[1], self.fixed_size)
            oh = (image.shape[0] - nh) // 2
            ow = (image.shape[1] - nw) // 2
            canvas = np.zeros((self.fixed_size, self.fixed_size, 3), np.float32)
            if self.padding is not None:
                canvas[:] = np.asarray(self.padding, np.float32)
            canvas[:nh, :nw] = image[oh:oh + nh, ow:ow + nw]
            image = canvas
            lbl_canvas = np.full((self.fixed_size, self.fixed_size), 255.0, np.float32)
            lbl_canvas[:nh, :nw] = label[oh:oh + nh, ow:ow + nw]
            label = lbl_canvas
        return image, label


class Crop:
    """Random or center crop with constant-border padding when too small."""

    def __init__(self, size, crop_type: str = "center",
                 padding: Optional[Sequence[float]] = None, ignore_label: int = 255):
        self.crop_h, self.crop_w = (size, size) if isinstance(size, int) else size
        assert crop_type in ("rand", "center")
        self.crop_type = crop_type
        self.padding = padding
        self.ignore_label = ignore_label

    def __call__(self, image, label):
        cv2 = _cv2("Crop")
        h, w = image.shape[:2]
        pad_h = max(self.crop_h - h, 0)
        pad_w = max(self.crop_w - w, 0)
        if pad_h > 0 or pad_w > 0:
            assert self.padding is not None, "Crop needs padding values"
            top, left = pad_h // 2, pad_w // 2
            image = cv2.copyMakeBorder(image, top, pad_h - top, left, pad_w - left,
                                       cv2.BORDER_CONSTANT, value=list(self.padding))
            label = cv2.copyMakeBorder(label, top, pad_h - top, left, pad_w - left,
                                       cv2.BORDER_CONSTANT, value=self.ignore_label)
        h, w = image.shape[:2]
        if self.crop_type == "rand":
            off_h = random.randint(0, h - self.crop_h)
            off_w = random.randint(0, w - self.crop_w)
        else:
            off_h = (h - self.crop_h) // 2
            off_w = (w - self.crop_w) // 2
        image = image[off_h:off_h + self.crop_h, off_w:off_w + self.crop_w]
        label = label[off_h:off_h + self.crop_h, off_w:off_w + self.crop_w]
        return image, label


class FitCrop:
    """Object-aware crop around the largest connected foreground component."""

    def __init__(self, k: int = 2, multi: bool = False):
        self.k = k
        self.multi = multi

    def _coords(self, labels, obj_idx, h, w):
        ys, xs = np.where(labels == obj_idx)
        min_h, max_h = ys.min(), ys.max()
        min_w, max_w = xs.min(), xs.max()
        h0, h1 = min_h // self.k, h - (h - max_h) // self.k
        w0, w1 = min_w // self.k, w - (w - max_w) // self.k
        ratio = (h1 - h0) / max(w1 - w0, 1)
        if ratio <= 0.7:     # too flat: extend height to a border
            if h0 <= h - h1:
                h0 = 0
            else:
                h1 = h
        elif ratio >= 1.5:   # too narrow: extend width to a border
            if w0 <= w - w1:
                w0 = 0
            else:
                w1 = w
        return int(h0), int(h1), int(w0), int(w1)

    def __call__(self, image, label):
        cv2 = _cv2("FitCrop")
        h, w = image.shape[:2]
        binary = np.asarray(label).copy()
        binary[binary == 255] = 0
        _, comps = cv2.connectedComponents(binary.astype(np.uint8))
        freq = np.bincount(comps.flatten())
        freq[0] = 0
        obj = int(np.argmax(freq))
        cnt = freq[obj]
        h0, h1, w0, w1 = self._coords(comps, obj, h, w)
        out_img = image[h0:h1, w0:w1]
        out_lbl = label[h0:h1, w0:w1]
        if self.multi and len(freq) >= 3:
            freq[obj] = 0
            obj2 = int(np.argmax(freq))
            if freq[obj2] / max(cnt, 1) >= 0.3:
                h0, h1, w0, w1 = self._coords(comps, obj2, h, w)
                return out_img, out_lbl, image[h0:h1, w0:w1], label[h0:h1, w0:w1]
        return out_img, out_lbl


class RandRotate:
    def __init__(self, rotate, padding: Sequence[float], ignore_label: int = 255, p: float = 0.5):
        assert len(rotate) == 2 and rotate[0] < rotate[1]
        self.rotate = rotate
        self.padding = list(padding)
        self.ignore_label = ignore_label
        self.p = p

    def __call__(self, image, label):
        cv2 = _cv2("RandRotate")
        if random.random() < self.p:
            angle = self.rotate[0] + (self.rotate[1] - self.rotate[0]) * random.random()
            h, w = label.shape
            m = cv2.getRotationMatrix2D((w / 2, h / 2), angle, 1)
            image = cv2.warpAffine(image, m, (w, h), flags=cv2.INTER_LINEAR,
                                   borderMode=cv2.BORDER_CONSTANT, borderValue=self.padding)
            label = cv2.warpAffine(label, m, (w, h), flags=cv2.INTER_NEAREST,
                                   borderMode=cv2.BORDER_CONSTANT,
                                   borderValue=self.ignore_label)
        return image, label


class RandomHorizontalFlip:
    def __init__(self, p: float = 0.5):
        self.p = p

    def __call__(self, image, label):
        # numpy copies, the bits of cv2.flip(x, 1)
        if random.random() < self.p:
            image = np.ascontiguousarray(image[:, ::-1])
            label = np.ascontiguousarray(label[:, ::-1])
        return image, label


class RandomVerticalFlip:
    def __init__(self, p: float = 0.5):
        self.p = p

    def __call__(self, image, label):
        if random.random() < self.p:
            image = np.ascontiguousarray(image[::-1])
            label = np.ascontiguousarray(label[::-1])
        return image, label


class RandomGaussianBlur:
    def __init__(self, radius: int = 5):
        self.radius = radius

    def __call__(self, image, label):
        cv2 = _cv2("RandomGaussianBlur")
        if random.random() < 0.5:
            image = cv2.GaussianBlur(image, (self.radius, self.radius), 0)
        return image, label


class ColorJitter:
    """HSV-space jitter: 'b' brightness shift, 's' saturation, 'c' contrast."""

    def __init__(self, cj_type: str = "b"):
        self.cj_type = cj_type

    def __call__(self, img, label):
        cv2 = _cv2("ColorJitter")
        img = np.asarray(img, np.float32)
        if self.cj_type == "b":
            hsv = cv2.cvtColor(img.astype(np.uint8), cv2.COLOR_BGR2HSV)
            h, s, v = cv2.split(hsv)
            value = 35 if np.mean(v) <= 125 else -35
            v = v.astype(np.int32) + value
            v = np.clip(v, 0, 255).astype(np.uint8)
            img = cv2.cvtColor(cv2.merge((h, s, v)), cv2.COLOR_HSV2BGR).astype(np.float32)
        elif self.cj_type == "s":
            value = float(np.random.choice([0.5, 0.75, 1.25, 1.5]))
            hsv = cv2.cvtColor(img.astype(np.uint8), cv2.COLOR_BGR2HSV)
            h, s, v = cv2.split(hsv)
            s = np.clip(s.astype(np.float32) * value, 0, 255).astype(np.uint8)
            img = cv2.cvtColor(cv2.merge((h, s, v)), cv2.COLOR_HSV2BGR).astype(np.float32)
        elif self.cj_type == "c":
            brightness = 10
            contrast = random.randint(40, 100)
            img = np.clip(img * (contrast / 127 + 1) - contrast + brightness, 0, 255)
        return img, label


def build_aug_pipeline(cfg, names: Sequence[str]) -> Compose:
    """Pipeline factory for the config's ``augmentations`` list
    (reference: src/dataset/dataset.py:22-42)."""
    padding = [v * 255 for v in cfg.mean] if cfg.get("padding") == "avg" else None
    # crop/rotate borders are ZERO-padded and only resize honors the 'avg'
    # mean padding — reference-exact (dataset.py:25-35 passes
    # padding=[0 for x in args.mean] to RandRotate and Crop)
    registry = {
        "randscale": RandScale([cfg.scale_min, cfg.scale_max]),
        "randrotate": RandRotate([cfg.rot_min, cfg.rot_max],
                                 padding=[0.0] * 3, ignore_label=255),
        "hor_flip": RandomHorizontalFlip(),
        "vert_flip": RandomVerticalFlip(),
        "crop": Crop([cfg.image_size, cfg.image_size], crop_type="rand",
                     padding=[0.0] * 3, ignore_label=255),
        "resize": ResizeKeepAspect(cfg.image_size, padding=padding),
        "resize_np": ResizeSquare((cfg.image_size, cfg.image_size)),
    }
    ts = [registry[name] for name in names]
    ts.append(ToNormalized(cfg.mean, cfg.std))
    # the [resize -> normalize] tail runs fused in the host C++ core
    if len(ts) >= 2 and isinstance(ts[-2], ResizeKeepAspect):
        ts[-2:] = [FusedResizeNormalize(cfg.image_size, cfg.mean, cfg.std, padding=padding)]
    return Compose(ts)


def build_val_pipeline(cfg) -> Compose:
    """Validation pipeline: resize + normalize only (reference: dataset.py:78-84);
    ``resize`` fused in the host C++ core, ``resize_np`` through cv2."""
    if "resize_np" in cfg.augmentations:
        return Compose([ResizeSquare((cfg.image_size, cfg.image_size)),
                        ToNormalized(cfg.mean, cfg.std)])
    padding = [v * 255 for v in cfg.mean] if cfg.get("padding") == "avg" else None
    return Compose([FusedResizeNormalize(cfg.image_size, cfg.mean, cfg.std,
                                         padding=padding)])


class RGB2BGR:
    """Channel-order flip (for Caffe-initialized backbones)."""

    def __call__(self, image, label):
        return np.ascontiguousarray(np.asarray(image)[..., ::-1]), label


BGR2RGB = RGB2BGR  # symmetric operation


class _PILEnhance:
    """Shared wrapper for PIL-style enhancement transforms."""

    _PARAMETER_MAX = 10

    def __init__(self, v: float, max_v: float, bias: float = 0.0):
        self.v = float(v) * max_v / self._PARAMETER_MAX + bias

    def _enhance(self, image):  # pragma: no cover - overridden
        raise NotImplementedError

    def __call__(self, image, label):
        from PIL import Image

        img = Image.fromarray(np.uint8(np.clip(image, 0, 255))).convert("RGB")
        out = np.asarray(self._enhance(img), np.float32)
        return out, label


class Contrast(_PILEnhance):
    def __init__(self, v: float = 0.9, max_v: float = 0.05, bias: float = 0.0):
        super().__init__(v, max_v, bias)

    def _enhance(self, img):
        from PIL import ImageEnhance

        return ImageEnhance.Contrast(img).enhance(self.v)


class Brightness(_PILEnhance):
    def __init__(self, v: float = 1.8, max_v: float = 0.1, bias: float = 0.0):
        super().__init__(v, max_v, bias)

    def _enhance(self, img):
        from PIL import ImageEnhance

        return ImageEnhance.Brightness(img).enhance(self.v)


class Sharpness(_PILEnhance):
    def __init__(self, v: float = 0.9, max_v: float = 0.05, bias: float = 0.0):
        super().__init__(v, max_v, bias)

    def _enhance(self, img):
        from PIL import ImageEnhance

        return ImageEnhance.Sharpness(img).enhance(self.v)


class AutoContrast:
    def __call__(self, image, label):
        from PIL import Image, ImageOps

        img = Image.fromarray(np.uint8(np.clip(image, 0, 255))).convert("RGB")
        return np.asarray(ImageOps.autocontrast(img), np.float32), label


class FusedResizeNormalize:
    """``ResizeKeepAspect`` + ``ToNormalized`` in one pass of the host C++
    core (``data.native``); the JAX package's native path, bit for bit."""

    def __init__(self, size: int, mean, std, padding=None):
        self.size = size
        self.mean = list(mean)
        self.std = list(std)
        self.padding = list(padding) if padding is not None else None

    def _new_hw(self, h: int, w: int):
        size = self.size
        if h >= w:
            nh, nw = size, int(w * size / h)
        else:
            nh, nw = int(h * size / w), size
        return _mult8_floor(nh), _mult8_floor(nw)

    def __call__(self, image, label):
        img = np.asarray(image, np.float32)
        nh, nw = self._new_hw(img.shape[0], img.shape[1])
        out_img = native.resize_pad_normalize(img, self.size, nh, nw, self.mean,
                                              self.std, self.padding)
        if label is None:
            return out_img
        lab = np.asarray(label)
        nh2, nw2 = self._new_hw(lab.shape[0], lab.shape[1])
        return out_img, native.resize_pad_label(lab.astype(np.uint8), self.size, nh2, nw2)
