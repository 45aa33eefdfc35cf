"""The port's data layer against the JAX package's, on small trees that the
tests write themselves with cv2 (JPEG and PNG images of 65-100 px, gray PNG
masks, cv2's adaptive PNG filters) at image_size 33-65.

Each piece gets the same inputs and the same ``random`` / ``np.random``
seeds on both sides. Tolerances: everything is equal bit for bit (class
splits, PNG decoding against ``cv2.imread``, the fused resize + normalize of
the host C++ core against the JAX package's native library, every
``build_aug_pipeline`` transform, the ``resize_np`` tail (cv2's
``ResizeSquare`` + ``ToNormalized`` on both sides) in the train and val
pipelines and the ``meta_aug`` views, the scan, the episodes and the
loader's batches).
"""

import ast
import json
import os
import random
import struct
import subprocess
import sys
import zlib
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from few_shot_seg_cwt_tpu.config import default_cfg as jax_default_cfg
from few_shot_seg_cwt_tpu.data import classes as jax_classes
from few_shot_seg_cwt_tpu.data import episodic as jax_episodic
from few_shot_seg_cwt_tpu.data import listing as jax_listing
from few_shot_seg_cwt_tpu.data import loader as jax_loader
from few_shot_seg_cwt_tpu.data import native as jax_native
from few_shot_seg_cwt_tpu.data import replay as jax_replay
from few_shot_seg_cwt_tpu.data import transforms as jax_T
from few_shot_seg_cwt_tpu_torch.config import default_cfg
from few_shot_seg_cwt_tpu_torch.data import classes, episodic, imread, listing, native, replay
from few_shot_seg_cwt_tpu_torch.data import loader as port_loader
from few_shot_seg_cwt_tpu_torch.data import transforms as T

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
MEAN = [0.485, 0.456, 0.406]
STD = [0.229, 0.224, 0.225]
# (H, W) of the tree's images: odd widths, both orientations, 65-100 px
SIZES = [(100, 65), (65, 100), (99, 87), (100, 100), (98, 71), (71, 99), (100, 93)]
N_IMAGES = 14
OBJ = 46  # an object's side: 46 x 46 = 2116 px >= MIN_PIXELS (2048)


def write_tree(root: Path) -> None:
    """A PASCAL-layout tree: even images JPEG, odd images PNG; each mask holds
    a split-0 val class (1 or 2) at the top left and a train class (6 or 7)
    at the bottom right, each ringed by 255. Lists: ``all.txt`` (every
    image), ``png.txt`` (PNG images), ``small.txt`` (one image whose class-3
    object is below MIN_PIXELS)."""
    rng = np.random.default_rng(0)
    (root / "JPEGImages").mkdir(parents=True)
    (root / "SegmentationClassAug").mkdir()
    lines, png_lines = [], []
    for i in range(N_IMAGES):
        h, w = SIZES[i % len(SIZES)]
        lab = np.zeros((h, w), np.uint8)
        lab[1:3 + OBJ, 1:3 + OBJ] = 255
        lab[2:2 + OBJ, 2:2 + OBJ] = 1 + i % 2
        lab[h - OBJ - 3:h - 1, w - OBJ - 3:w - 1] = 255
        lab[h - OBJ - 2:h - 2, w - OBJ - 2:w - 2] = 6 + (i // 2) % 2
        img = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
        img[lab == 1 + i % 2] //= 3
        ext = "jpg" if i % 2 == 0 else "png"
        cv2.imwrite(str(root / "JPEGImages" / f"{i:03d}.{ext}"), img)
        cv2.imwrite(str(root / "SegmentationClassAug" / f"{i:03d}.png"), lab)
        line = f"JPEGImages/{i:03d}.{ext} SegmentationClassAug/{i:03d}.png\n"
        lines.append(line)
        if ext == "png":
            png_lines.append(line)
    (root / "all.txt").write_text("".join(lines))
    (root / "png.txt").write_text("".join(png_lines))
    lab = np.zeros((80, 80), np.uint8)
    lab[10:50, 10:50] = 3  # 1600 px < 2048
    cv2.imwrite(str(root / "JPEGImages" / "small.png"), np.zeros((80, 80, 3), np.uint8))
    cv2.imwrite(str(root / "SegmentationClassAug" / "small.png"), lab)
    (root / "small.txt").write_text("JPEGImages/small.png SegmentationClassAug/small.png\n")


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("voc")
    write_tree(root)
    return root


def tree_cfgs(root, image_size=33, opts=()):
    """(JAX cfg, port cfg) on the tree, split 0, no scan cache, workers 0."""
    out = []
    for cfg in (jax_default_cfg(), default_cfg()):
        cfg.data_root = str(root)
        cfg.train_list = cfg.val_list = str(root / "all.txt")
        cfg.image_size = image_size
        cfg.workers = 0
        cfg.scan_cache = None
        cfg.train_split = 0
        for k, v in opts:
            cfg[k] = v
        out.append(cfg)
    return out


def _assert_episodes_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# --------------------------------------------------------------------------- #
# classes
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("use_split_coco", [False, True])
def test_splits_and_filters_equal_jax(use_split_coco):
    got = classes.get_split_classes(use_split_coco)
    ref = jax_classes.get_split_classes(use_split_coco)
    assert json.dumps(got, sort_keys=True) == json.dumps(ref, sort_keys=True)
    assert classes.CLASS_NAMES == jax_classes.CLASS_NAMES
    assert classes.NAME_TO_ID == jax_classes.NAME_TO_ID
    for train_name in ("pascal", "coco"):
        for test_name in ("pascal", "coco"):
            for train_split in range(4):
                for test_split in (-1, 0, 1, 2, 3):
                    args = (train_name, train_split, test_name, test_split)
                    assert (classes.filter_classes(*args, got)
                            == jax_classes.filter_classes(*args, ref)), args
    for train_name, test_name, test_split in (("pascal", "default", "default"),
                                              ("coco", "pascal", -1),
                                              ("pascal", "coco", -1)):
        for fold in range(4):
            jcfg, tcfg = jax_default_cfg(), default_cfg()
            for cfg in (jcfg, tcfg):
                cfg.update(use_split_coco=use_split_coco, train_name=train_name,
                           train_split=fold, test_name=test_name, test_split=test_split)
            assert classes.resolve_val_classes(tcfg) == jax_classes.resolve_val_classes(jcfg)
            assert (classes.resolve_train_classes(tcfg)
                    == jax_classes.resolve_train_classes(jcfg))


# --------------------------------------------------------------------------- #
# PNG decoding
# --------------------------------------------------------------------------- #

def _cv2_read(path, gray=False):
    out = cv2.imread(str(path), cv2.IMREAD_GRAYSCALE if gray else cv2.IMREAD_COLOR)
    return out if gray else cv2.cvtColor(out, cv2.COLOR_BGR2RGB)


@pytest.mark.parametrize("width", [67, 71, 100])
def test_png_decoder_equals_cv2_imread(tmp_path, width):
    rng = np.random.default_rng(width)
    h = 53
    gray = (rng.integers(0, 256, (h, width)) // 5 * 5).astype(np.uint8)
    rgb = rng.integers(0, 256, (h, width, 3)).astype(np.uint8)
    rgb[: h // 2] = rgb[: h // 2] // 32 * 32  # smooth rows: other adaptive filters
    rgba = rng.integers(0, 256, (h, width, 4)).astype(np.uint8)
    files = {"gray": gray, "rgb": rgb, "rgba": rgba}
    for name, arr in files.items():
        cv2.imwrite(str(tmp_path / f"{name}.png"), arr)
    # palette images from Pillow: 1, 2, 4 and 8 bits a pixel
    for n in (2, 4, 16, 200):
        p = Image.fromarray(rng.integers(0, n, (h, width)).astype(np.uint8), "P")
        p.putpalette([int(v) for v in rng.integers(0, 256, 3 * n)])
        p.save(tmp_path / f"palette{n}.png")
        files[f"palette{n}"] = None
    Image.fromarray(rgb).convert("P", palette=Image.ADAPTIVE).save(tmp_path / "adaptive.png")
    files["adaptive"] = None
    for name in files:
        path = tmp_path / f"{name}.png"
        got = imread.read(str(path))
        assert got.dtype == np.uint8 and got.shape == (h, width, 3), name
        np.testing.assert_array_equal(got, _cv2_read(path), err_msg=name)
    got = imread.read(str(tmp_path / "gray.png"), gray=True)
    np.testing.assert_array_equal(got, _cv2_read(tmp_path / "gray.png", gray=True))


def test_png_decoder_refuses_what_it_does_not_decode(tmp_path):
    """A colour mask is refused (OpenCV would weigh the channels into gray),
    and a missing file raises naming it; every other form goes to cv2
    (``test_png_forms_cv2_reads_equal_cv2_imread``)."""
    rng = np.random.default_rng(1)
    cv2.imwrite(str(tmp_path / "rgb.png"), rng.integers(0, 256, (9, 11, 3)).astype(np.uint8))
    path = str(tmp_path / "rgb.png")
    with pytest.raises(ValueError, match="mask must be an 8-bit gray") as err:
        imread.read(path, gray=True)
    assert path in str(err.value)
    with pytest.raises(RuntimeError, match="cannot read"):
        imread.read(str(tmp_path / "missing.png"))


# Adam7's passes: (x0, y0, dx, dy)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
          (0, 1, 1, 2))


def _png(arr: np.ndarray, ctype: int, depth: int, interlace: bool = False,
         palette=None) -> bytes:
    """A PNG file of ``arr`` ((H, W) or (H, W, C) samples), written here from
    the specification: every row unfiltered (type 0), 16-bit samples
    big-endian, sub-byte samples packed from the most significant bit, and
    with ``interlace`` the seven Adam7 passes."""
    arr = arr if arr.ndim == 3 else arr[:, :, None]
    h, w, _ = arr.shape

    def rows(img):
        out = b""
        for row in img:
            if depth == 16:
                data = row.astype(">u2").tobytes()
            elif depth == 8:
                data = row.astype(np.uint8).tobytes()
            else:
                bits = np.unpackbits(row.astype(np.uint8).reshape(-1, 1), axis=1)[:, 8 - depth:]
                data = np.packbits(bits.reshape(-1)).tobytes()
            out += b"\x00" + data
        return out

    if interlace:
        raw = b"".join(rows(arr[y0::dy, x0::dx]) for x0, y0, dx, dy in _ADAM7
                       if arr[y0::dy, x0::dx].size)
    else:
        raw = rows(arr)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    out = imread.PNG_MAGIC + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0,
                                                        int(interlace)))
    if palette is not None:
        out += chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    return out + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b"")


def _png_forms(rng, h, w):
    """{name: (file bytes, also a mask)}: the forms the port sends to cv2."""
    g16 = rng.integers(0, 65536, (h, w))
    g8 = rng.integers(0, 256, (h, w))
    rgb = rng.integers(0, 256, (h, w, 3))
    pal = rng.integers(0, 256, (16, 3))
    return {
        "gray16": (_png(g16, 0, 16), True),
        "rgb16": (_png(rng.integers(0, 65536, (h, w, 3)), 2, 16), False),
        "rgba16": (_png(rng.integers(0, 65536, (h, w, 4)), 6, 16), False),
        "graya8": (_png(rng.integers(0, 256, (h, w, 2)), 4, 8), True),
        "graya16": (_png(rng.integers(0, 65536, (h, w, 2)), 4, 16), True),
        "gray4": (_png(rng.integers(0, 16, (h, w)), 0, 4), True),
        "gray8_interlaced": (_png(g8, 0, 8, interlace=True), True),
        "gray16_interlaced": (_png(g16, 0, 16, interlace=True), True),
        "rgb8_interlaced": (_png(rgb, 2, 8, interlace=True), False),
        "graya8_interlaced": (_png(rng.integers(0, 256, (h, w, 2)), 4, 8, interlace=True), True),
        "palette4_interlaced": (_png(rng.integers(0, 16, (h, w)), 3, 4, interlace=True,
                                     palette=pal), False),
    }


@pytest.mark.parametrize("h,w", [(13, 11), (53, 67)])
def test_png_forms_cv2_reads_equal_cv2_imread(tmp_path, h, w):
    """Interlaced, 16-bit, gray+alpha and sub-8-bit gray PNGs decode equal
    to ``cv2.imread`` bit for bit, as images and (gray forms) as masks. The
    files are written here from the specification (cv2 writes none
    interlaced); cv2 reading them as they were written anchors the writer."""
    rng = np.random.default_rng(h * w)
    for name, (data, mask) in _png_forms(rng, h, w).items():
        path = tmp_path / f"{name}.png"
        path.write_bytes(data)
        want = _cv2_read(path)
        assert want is not None and want.shape == (h, w, 3), name
        got = imread.read(str(path))
        assert got.dtype == np.uint8, name
        np.testing.assert_array_equal(got, want, err_msg=name)
        if mask:
            np.testing.assert_array_equal(imread.read(str(path), gray=True),
                                          _cv2_read(path, gray=True), err_msg=name)
    # the writer against the native decoder: an 8-bit gray file it writes
    # un-interlaced reads back as the samples themselves
    g8 = rng.integers(0, 256, (h, w)).astype(np.uint8)
    (tmp_path / "g8.png").write_bytes(_png(g8, 0, 8))
    np.testing.assert_array_equal(imread.read(str(tmp_path / "g8.png"), gray=True), g8)
    interlaced = cv2.imread(str(tmp_path / "gray8_interlaced.png"), cv2.IMREAD_GRAYSCALE)
    assert interlaced.shape == (h, w)


def test_png_forms_without_cv2_name_the_file(tmp_path, monkeypatch):
    """Without cv2 a form that needs it raises an ImportError naming the
    file and its form, as a JPEG does."""
    rng = np.random.default_rng(3)
    path = tmp_path / "deep.png"
    path.write_bytes(_png(rng.integers(0, 65536, (9, 11)), 0, 16))
    monkeypatch.setitem(sys.modules, "cv2", None)
    for gray in (False, True):
        with pytest.raises(ImportError, match="16-bit PNG of colour type 0") as err:
            imread.read(str(path), gray=gray)
        assert str(path) in str(err.value) and "cv2" in str(err.value)


def test_unfilter_undoes_every_filter_type():
    """Rows filtered with each of None/Sub/Up/Average/Paeth (encoded here in
    numpy from the PNG spec) come back as the raw bytes, at 1, 3 and 4 bytes a
    pixel; an unknown filter type raises."""
    rng = np.random.default_rng(3)
    for bpp in (1, 3, 4):
        raw = rng.integers(0, 256, (10, 7 * bpp)).astype(np.int64)
        stream = bytearray()
        for y in range(raw.shape[0]):
            cur = raw[y]
            up = raw[y - 1] if y else np.zeros_like(cur)
            left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
            upleft = np.concatenate([np.zeros(bpp, np.int64), up[:-bpp]])
            p = left + up - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
            paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
            pred = [0, left, up, (left + up) // 2, paeth][y % 5]
            stream += bytes([y % 5]) + bytes(((cur - pred) % 256).astype(np.uint8))
        out = native.png_unfilter(bytes(stream), raw.shape[0], raw.shape[1], bpp)
        np.testing.assert_array_equal(out, raw.astype(np.uint8))
    with pytest.raises(ValueError, match="filter type in row 0"):
        native.png_unfilter(bytes([7, 1, 2]), 1, 2, 1)


def test_a_failed_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "fss_native.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_LIB", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.load_library()


# --------------------------------------------------------------------------- #
# the host C++ core and the transforms
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("shape,size,pad", [((100, 65), 65, False), ((71, 99), 33, True),
                                            ((500, 375), 473, False), ((97, 97), 41, True)])
def test_fused_resize_normalize_is_the_jax_bits(shape, size, pad):
    assert jax_native.available()
    rng = np.random.default_rng(size)
    img = rng.uniform(0, 255, (*shape, 3)).astype(np.float32)
    lab = rng.integers(0, 3, shape).astype(np.uint8)
    lab[:3] = 255
    padding = [v * 255 for v in MEAN] if pad else None
    got = T.FusedResizeNormalize(size, MEAN, STD, padding=padding)(img, lab)
    ref = jax_T.FusedResizeNormalize(size, MEAN, STD, padding=padding)(img, lab)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype
        np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("shape,size", [((100, 65), 65), ((71, 99), 33), ((500, 333), 473)])
def test_resize_np_tail_is_the_jax_bits(shape, size):
    """The ``resize_np`` val pipeline (cv2 ``ResizeSquare`` + ``ToNormalized``)
    gives the JAX package's images and labels bit for bit."""
    rng = np.random.default_rng(size)
    img = rng.uniform(0, 255, (*shape, 3)).astype(np.float32)
    lab = rng.integers(0, 3, shape).astype(np.uint8)
    lab[:, :2] = 255
    jcfg, tcfg = jax_default_cfg(), default_cfg()
    for cfg in (jcfg, tcfg):
        cfg.image_size, cfg.augmentations = size, ["hor_flip", "resize_np"]
    got_img, got_lab = T.build_val_pipeline(tcfg)(img, lab)
    ref_img, ref_lab = jax_T.build_val_pipeline(jcfg)(img, lab)
    assert got_img.shape == ref_img.shape == (size, size, 3)
    assert got_img.dtype == ref_img.dtype and got_lab.dtype == ref_lab.dtype == np.int32
    np.testing.assert_array_equal(got_img, ref_img)
    np.testing.assert_array_equal(got_lab, ref_lab)


def test_resize_np_without_cv2_names_the_transform(monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)
    img = np.zeros((40, 50, 3), np.float32)
    with pytest.raises(ImportError, match="ResizeSquare needs OpenCV"):
        T.ResizeSquare(33)(img, np.zeros((40, 50), np.uint8))


REGISTRY = ["randscale", "randrotate", "hor_flip", "vert_flip", "crop", "resize", "resize_np"]


@pytest.mark.parametrize("name", REGISTRY)
def test_every_registry_transform_equals_jax(tree, name):
    jcfg, tcfg = tree_cfgs(tree, image_size=65, opts=[("padding", "avg")])
    rng = np.random.default_rng(7)
    img = rng.uniform(0, 255, (71, 99, 3)).astype(np.float32)
    lab = rng.integers(0, 2, (71, 99)).astype(np.uint8)
    lab[:4] = 255
    names = [name, "resize"] if name in ("randscale", "randrotate") else [name]
    got_t = T.build_aug_pipeline(tcfg, names)
    ref_t = jax_T.build_aug_pipeline(jcfg, names)
    for seed in range(4):
        random.seed(seed)
        got = got_t(img.copy(), lab.copy())
        random.seed(seed)
        ref = ref_t(img.copy(), lab.copy())
        np.testing.assert_array_equal(got[0], ref[0])
        np.testing.assert_array_equal(np.asarray(got[1], np.int32), np.asarray(ref[1], np.int32))
    val = T.build_val_pipeline(tcfg)(img.copy(), lab.copy())
    val_ref = jax_T.build_val_pipeline(jcfg)(img.copy(), lab.copy())
    for g, r in zip(val, val_ref):
        np.testing.assert_array_equal(g, r)


def test_port_imports_cv2_and_pil_only_inside_functions():
    """No module of the port or chip_smoke.py imports cv2 or PIL at import
    time; the transforms that need them import them when they run."""
    bad = []
    for path in sorted((REPO / "few_shot_seg_cwt_tpu_torch").rglob("*.py")) + [
            REPO / "chip_smoke.py"]:
        tree_ = ast.parse(path.read_text())
        for node in tree_.body:
            for sub in ast.walk(node) if isinstance(node, (ast.If, ast.Try, ast.With)) else [node]:
                names = ([a.name for a in sub.names] if isinstance(sub, ast.Import) else
                         [sub.module or ""] if isinstance(sub, ast.ImportFrom) else [])
                bad += [f"{path.name}: {n}" for n in names if n.split(".")[0] in ("cv2", "PIL")]
    assert not bad, bad


# --------------------------------------------------------------------------- #
# listing, datasets, replay
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("workers", [0, 3])
def test_make_dataset_equals_jax(tree, tmp_path, workers):
    for lst, class_list in (("all.txt", [1, 2, 3, 4, 5]), ("all.txt", list(range(6, 21))),
                            ("small.txt", [3])):
        got = listing.make_dataset(str(tree), str(tree / lst), class_list,
                                   num_workers=workers, cache_dir=None)
        ref = jax_listing.make_dataset(str(tree), str(tree / lst), class_list,
                                       cache_dir=None)
        assert got == ref
        assert bool(got[0]) == (lst == "all.txt")
    # the scan cache is the port's own: a JAX pickle under the same directory
    # is never read, and a second scan reads the port's
    cache = str(tmp_path / "cache")
    jax_listing.make_dataset(str(tree), str(tree / "all.txt"), [1, 2], cache_dir=cache)
    first = listing.make_dataset(str(tree), str(tree / "all.txt"), [1, 2], cache_dir=cache)
    assert len(os.listdir(cache)) == 2
    assert listing.make_dataset(str(tree), str(tree / "all.txt"), [1, 2],
                                cache_dir=cache) == first


def _sample_both(jcfg, tcfg, train, indices, seed=5):
    random.seed(seed)
    np.random.seed(seed)
    jds = jax_episodic.EpisodicDataset(jcfg, train=train)
    ref = [jds[i] for i in indices]
    random.seed(seed)
    np.random.seed(seed)
    tds = episodic.EpisodicDataset(tcfg, train=train)
    got = [tds[i] for i in indices]
    assert len(tds) == len(jds)
    return got, ref


@pytest.mark.parametrize("train,opts", [
    (False, ()),
    (True, ()),
    (True, (("shot", 5), ("random_shot", True))),
    (False, (("shot", 5),)),
    (True, (("augmentations", ["hor_flip", "resize_np"]), ("image_size", 41))),
    (False, (("augmentations", ["hor_flip", "resize_np"]), ("image_size", 41))),
])
def test_episodic_dataset_equals_jax(tree, train, opts):
    jcfg, tcfg = tree_cfgs(tree, opts=opts)
    got, ref = _sample_both(jcfg, tcfg, train, list(range(N_IMAGES)) * 2)
    for g, r in zip(got, ref):
        _assert_episodes_equal(g, r)
    if tcfg.random_shot:
        assert len({int(g["n_shot"]) for g in got}) > 1


def test_meta_aug_support_views_equal_jax(tree):
    jcfg, tcfg = tree_cfgs(tree, image_size=41, opts=[("meta_aug", 2), ("aug_type", 0),
                                                      ("aug_th", [0.3, 0.6])])
    got, ref = _sample_both(jcfg, tcfg, True, list(range(N_IMAGES)))
    for g, r in zip(got, ref):
        assert g["s_img"].shape == (2, 41, 41, 3)
        _assert_episodes_equal(g, r)


def test_meta_aug_support_views_equal_jax_under_resize_np(tree):
    jcfg, tcfg = tree_cfgs(tree, image_size=41, opts=[
        ("meta_aug", 2), ("aug_type", 0), ("aug_th", [0.3, 0.6]),
        ("augmentations", ["hor_flip", "resize_np"])])
    got, ref = _sample_both(jcfg, tcfg, True, list(range(N_IMAGES)))
    for g, r in zip(got, ref):
        assert g["s_img"].shape == (2, 41, 41, 3)
        _assert_episodes_equal(g, r)


def _write_log(tree, path, n, shot=1):
    rng = np.random.default_rng(11)
    lines = []
    for _ in range(n):
        i = int(rng.integers(0, N_IMAGES))
        cls = 1 + i % 2
        same = [j for j in range(N_IMAGES) if j % 2 == i % 2 and j != i]
        sup = rng.choice(same, size=int(rng.integers(1, shot + 1)), replace=False)
        pair = lambda j: [f"JPEGImages/{j:03d}.{'jpg' if j % 2 == 0 else 'png'}",  # noqa: E731
                          f"SegmentationClassAug/{j:03d}.png"]
        lines.append(json.dumps({"q": pair(i), "cls": cls, "s": [pair(int(j)) for j in sup]}))
    path.write_text("\n".join(lines) + "\n")
    return path


def test_replay_dataset_equals_jax(tree, tmp_path):
    log = _write_log(tree, tmp_path / "episodes.jsonl", 6, shot=3)
    jcfg, tcfg = tree_cfgs(tree, opts=[("shot", 3)])
    got = replay.ReplayEpisodicDataset(tcfg, str(log))
    ref = jax_replay.ReplayEpisodicDataset(jcfg, str(log))
    assert len(got) == len(ref) == 6
    for i in range(6):
        _assert_episodes_equal(got[i], ref[i])
    assert replay.load_episode_log(str(log)) == jax_replay.load_episode_log(str(log))
    (tmp_path / "empty.jsonl").write_text("\n")
    with pytest.raises(ValueError, match="empty episode log"):
        replay.load_episode_log(str(tmp_path / "empty.jsonl"))
    tcfg.shot = 1
    with pytest.raises(ValueError, match="supports > shot=1"):
        replay.ReplayEpisodicDataset(tcfg, str(log))


# --------------------------------------------------------------------------- #
# the loader
# --------------------------------------------------------------------------- #

class _Indexed:
    """Records that name their index (and an array of its shape)."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"i": np.int32(i), "x": np.full((3, 2), i, np.float32)}


@pytest.mark.parametrize("n,batch,shuffle,drop_last,world", [
    (10, 3, True, True, 1), (10, 3, False, False, 1), (11, 2, True, True, 3),
    (7, 4, False, False, 2), (9, 3, True, False, 2)])
def test_loader_index_streams_and_batches_equal_jax(n, batch, shuffle, drop_last, world):
    for rank in range(world):
        for workers in (0, 2):
            kw = dict(batch_size=batch, shuffle=shuffle, num_workers=workers, seed=3,
                      drop_last=drop_last, rank=rank, world=world)
            got_l = port_loader.EpisodeLoader(_Indexed(n), device="cpu", **kw)
            ref_l = jax_loader.EpisodeLoader(_Indexed(n), **kw)
            assert len(got_l) == len(ref_l)
            for epoch in (0, 1, 5):
                got_l.set_epoch(epoch)
                ref_l.set_epoch(epoch)
                got, ref = list(got_l), list(ref_l)
                assert len(got) == len(ref)
                for g, r in zip(got, ref):
                    assert all(torch.is_tensor(v) for v in g.values())
                    for k in r:
                        np.testing.assert_array_equal(g[k].numpy(), r[k])


def test_loader_infinite_and_errors():
    loader = port_loader.EpisodeLoader(_Indexed(5), batch_size=2, shuffle=False,
                                       num_workers=2, device="cpu")
    stream = port_loader.infinite(loader)
    seen = [next(stream)["i"].tolist() for _ in range(4)]
    assert seen == [[0, 1], [2, 3], [0, 1], [2, 3]]
    with pytest.raises(RuntimeError, match="yields no batches"):
        next(port_loader.infinite(port_loader.EpisodeLoader(
            _Indexed(1), batch_size=2, device="cpu")))

    class _Broken(_Indexed):
        def __getitem__(self, i):
            if i == 3:
                raise KeyError("episode 3")
            return super().__getitem__(i)

    with pytest.raises(KeyError, match="episode 3"):
        list(port_loader.EpisodeLoader(_Broken(6), batch_size=2, shuffle=False,
                                       num_workers=2, device="cpu"))
    with pytest.raises(ValueError, match="rank 2 outside world 2"):
        port_loader.EpisodeLoader(_Indexed(4), batch_size=2, device="cpu", rank=2, world=2)


def test_loader_refuses_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_loader.EpisodeLoader(_Indexed(4), batch_size=2, device="cuda")


def test_abandoned_iterator_stops_its_producer():
    import threading

    before = threading.active_count()
    loader = port_loader.EpisodeLoader(_Indexed(400), batch_size=2, num_workers=2,
                                       prefetch=1, device="cpu")
    it = iter(loader)
    next(it)
    it.close()
    for _ in range(100):
        if threading.active_count() <= before:
            break
        import time

        time.sleep(0.05)
    assert threading.active_count() <= before


# --------------------------------------------------------------------------- #
# without OpenCV and Pillow
# --------------------------------------------------------------------------- #

_BLOCKED = r"""
import json, sys
sys.modules["cv2"] = None
sys.modules["PIL"] = None
import torch
torch.set_num_threads(1)
from few_shot_seg_cwt_tpu_torch.config import default_cfg
from few_shot_seg_cwt_tpu_torch.data import imread
from few_shot_seg_cwt_tpu_torch.train.common import episodic_loaders
root = sys.argv[1]
cfg = default_cfg()
cfg.data_root, cfg.train_list, cfg.val_list = root, root + "/png.txt", root + "/png.txt"
cfg.image_size, cfg.workers, cfg.scan_cache, cfg.episode_batch = 33, 2, None, 2
train, val = episodic_loaders(cfg, device="cpu")
batch = next(iter(val))
tbatch = next(iter(train))
try:
    imread.read(root + "/JPEGImages/000.jpg")
    jpeg = "decoded"
except ImportError as e:
    jpeg = str(e)
print(json.dumps({"shape": list(batch["q_img"].shape), "train": list(tbatch["s_img"].shape),
                  "jpeg": jpeg, "cv2": sys.modules["cv2"] is None,
                  "pil": sys.modules["PIL"] is None}))
"""


def test_png_tree_loads_without_cv2_and_pillow(tree):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", _BLOCKED, str(tree)], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["shape"] == [2, 33, 33, 3]
    assert out["train"] == [2, 1, 33, 33, 3]
    assert "000.jpg" in out["jpeg"] and "cv2" in out["jpeg"]
    assert out["cv2"] and out["pil"]
