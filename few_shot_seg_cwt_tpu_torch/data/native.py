"""ctypes bridge to the port's host C++ core (``csrc/fss_native.cpp``).

The fused resize + pad + normalize of an image, the fused nearest resize +
pad of a label, and the PNG row unfilter that ``data.imread`` uses. The
library is built at first use with g++ (the JAX package's flags, so the
resize output is the same bits) into ``build/torch_kernels/`` beside the
CUDA kernels, under a name keyed by the source and the flags. There is no
fallback: a failed build or load raises, since the data path needs it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from ..ops.cuda_build import BUILD_DIR, CSRC

SOURCE = CSRC / "fss_native.cpp"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_LIB: Optional[ctypes.CDLL] = None
_LOCK = threading.Lock()


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"fss_native_{digest.hexdigest()[:12]}.so"


def build() -> Path:
    """Compile the library unless it exists; a concurrent build by another
    process never exposes half a file (atomic rename)."""
    out = library_path()
    if out.exists():
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the port's data path needs its host "
                           f"C++ core, built from {SOURCE}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([gxx, *GXX_FLAGS, "-o", tmp, str(SOURCE)],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed for {SOURCE}:\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def load_library() -> ctypes.CDLL:
    """The loaded library (built first if needed); raises if it cannot be."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            f32p = ctypes.POINTER(ctypes.c_float)
            u8p = ctypes.POINTER(ctypes.c_uint8)
            i32p = ctypes.POINTER(ctypes.c_int32)
            i64 = ctypes.c_int64
            lib.resize_pad_normalize_f32.argtypes = [
                f32p, i64, i64, f32p, i64, i64, i64, f32p, f32p, f32p]
            lib.resize_pad_normalize_f32.restype = None
            lib.resize_pad_label_i32.argtypes = [
                u8p, i64, i64, i32p, i64, i64, i64, ctypes.c_int32]
            lib.resize_pad_label_i32.restype = None
            lib.png_unfilter.argtypes = [u8p, i64, i64, i64, u8p]
            lib.png_unfilter.restype = i64
            _LIB = lib
    return _LIB


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def resize_pad_normalize(image: np.ndarray, size: int, nh: int, nw: int,
                         mean: Sequence[float], std: Sequence[float],
                         pad_value: Optional[Sequence[float]] = None) -> np.ndarray:
    """(H, W, 3) float32 0..255 -> (size, size, 3): bilinear resize to
    (nh, nw), pad bottom/right with ``pad_value`` (zeros if None), /255 and
    (x - mean) / std, in one pass."""
    if image.ndim != 3 or image.shape[2] != 3:
        raise ValueError(f"expected an (H, W, 3) image, got {image.shape}")
    if not (0 < nh <= size and 0 < nw <= size):
        raise ValueError(f"resize to ({nh}, {nw}) does not fit a {size} canvas")
    lib = load_library()
    img = np.ascontiguousarray(image, np.float32)
    out = np.empty((size, size, 3), np.float32)
    mean_a = np.asarray(mean, np.float32)
    std_a = np.asarray(std, np.float32)
    pad_a = np.asarray(pad_value, np.float32) if pad_value is not None else None
    lib.resize_pad_normalize_f32(
        _ptr(img, ctypes.c_float), img.shape[0], img.shape[1],
        _ptr(out, ctypes.c_float), size, nh, nw,
        _ptr(mean_a, ctypes.c_float), _ptr(std_a, ctypes.c_float),
        _ptr(pad_a, ctypes.c_float) if pad_a is not None else None)
    return out


def resize_pad_label(label: np.ndarray, size: int, nh: int, nw: int,
                     target_class: int = -1) -> np.ndarray:
    """(H, W) uint8 -> (size, size) int32: nearest resize to (nh, nw), pad
    with 255 (+ binarize on ``target_class`` >= 0)."""
    if label.ndim != 2:
        raise ValueError(f"expected an (H, W) label, got {label.shape}")
    if not (0 < nh <= size and 0 < nw <= size):
        raise ValueError(f"resize to ({nh}, {nw}) does not fit a {size} canvas")
    lib = load_library()
    lab = np.ascontiguousarray(label, np.uint8)
    out = np.empty((size, size), np.int32)
    lib.resize_pad_label_i32(_ptr(lab, ctypes.c_uint8), lab.shape[0], lab.shape[1],
                             _ptr(out, ctypes.c_int32), size, nh, nw, target_class)
    return out


def png_unfilter(filtered: bytes, height: int, row_bytes: int, bpp: int) -> np.ndarray:
    """The raw (height, row_bytes) bytes of a non-interlaced PNG image from
    its inflated IDAT stream (a filter byte before each row)."""
    need = height * (row_bytes + 1)
    if len(filtered) < need:
        raise ValueError(f"PNG data holds {len(filtered)} bytes, {need} needed")
    lib = load_library()
    src = np.frombuffer(filtered, np.uint8, count=need)
    out = np.empty((height, row_bytes), np.uint8)
    rc = lib.png_unfilter(_ptr(src, ctypes.c_uint8), height, row_bytes, bpp,
                          _ptr(out, ctypes.c_uint8))
    if rc != 0:
        raise ValueError(f"unknown PNG filter type in row {-rc - 1}")
    return out
