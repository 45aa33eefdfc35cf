"""Image and mask decoding for the episode loader, without OpenCV for PNG.

The port's stand-in for the ``cv2.imread`` calls of the JAX package's data
layer. PNG files are decoded here: chunks parsed in Python, the IDAT stream
inflated with the standard library's ``zlib``, and the row filters undone
by the host C++ core (``data.native.png_unfilter``), so decode threads run
without the interpreter lock for most of a file. The output equals
``cv2.imread`` bit for bit on what is accepted:

* images (``read(path)``): 8-bit gray, RGB and RGBA, and palette images of
  1, 2, 4 or 8 bits, as (H, W, 3) uint8 RGB. Gray is replicated, alpha and
  palette transparency are dropped (``IMREAD_COLOR`` then BGR -> RGB);
* masks (``read(path, gray=True)``): 8-bit gray only, as (H, W) uint8
  (``IMREAD_GRAYSCALE``).

Anything else raises a ``ValueError`` naming the file: 16-bit samples,
interlaced files, gray below 8 bits, gray+alpha, and a mask that is not
gray (OpenCV would convert colour to gray with its own weights; the
benchmark's masks are gray). Other formats (JPEG) go through ``cv2`` when it
imports, and raise ``ImportError`` naming the file when it does not.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from . import native

PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
# channels by colour type: 0 gray, 2 RGB, 3 palette, 6 RGBA (4, gray+alpha, is refused)
_CHANNELS = {0: 1, 2: 3, 3: 1, 6: 4}


def read(path: str, gray: bool = False) -> np.ndarray:
    """(H, W, 3) RGB uint8, or (H, W) uint8 with ``gray``; raises if the file
    is missing or cannot be decoded."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError as e:
        raise RuntimeError(f"cannot read {'label' if gray else 'image'} {path}: {e}") from e
    if data.startswith(PNG_MAGIC):
        return decode_png(data, path, gray)
    return _read_with_cv2(path, gray)


def _read_with_cv2(path: str, gray: bool) -> np.ndarray:
    try:
        import cv2
    except ImportError as e:
        raise ImportError(
            f"{path}: not a PNG file; decoding it (JPEG) needs OpenCV (cv2), "
            f"which does not import here ({e})") from e
    out = cv2.imread(path, cv2.IMREAD_GRAYSCALE if gray else cv2.IMREAD_COLOR)
    if out is None:
        raise RuntimeError(f"cannot decode {path}")
    return out if gray else cv2.cvtColor(out, cv2.COLOR_BGR2RGB)


def _chunks(data: bytes, path: str):
    pos = len(PNG_MAGIC)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length:
            raise ValueError(f"{path}: truncated PNG chunk {kind!r}")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError(f"{path}: PNG file ends without IEND")


def decode_png(data: bytes, path: str, gray: bool = False) -> np.ndarray:
    header, palette, idat = None, None, []
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None or not idat:
        raise ValueError(f"{path}: PNG file without IHDR or IDAT")
    width, height, depth, ctype, _, _, interlace = header
    if interlace:
        raise ValueError(f"{path}: interlaced PNG is not supported")
    if ctype not in _CHANNELS:
        raise ValueError(f"{path}: PNG colour type {ctype} is not supported")
    if depth != 8 and not (ctype == 3 and depth in (1, 2, 4)):
        raise ValueError(f"{path}: {depth}-bit PNG (colour type {ctype}) is not supported")
    if gray and ctype != 0:
        raise ValueError(f"{path}: a mask must be an 8-bit gray PNG, not colour type {ctype}")
    if ctype == 3 and palette is None:
        raise ValueError(f"{path}: palette PNG without PLTE")

    channels = _CHANNELS[ctype]
    row_bytes = (width * channels * depth + 7) // 8
    raw = native.png_unfilter(zlib.decompress(b"".join(idat)), height, row_bytes,
                              max(1, channels * depth // 8))
    if ctype == 0:
        return raw if gray else np.repeat(raw[:, :, None], 3, axis=2)
    if ctype in (2, 6):
        return np.ascontiguousarray(raw.reshape(height, width, channels)[:, :, :3])
    # palette: unpack sub-byte indices (most significant bits first)
    if depth < 8:
        shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
        raw = ((raw[:, :, None] >> shifts) & ((1 << depth) - 1)).reshape(height, -1)
    index = raw[:, :width]
    if int(index.max()) >= len(palette):
        raise ValueError(f"{path}: palette index {int(index.max())} beyond its "
                         f"{len(palette)} entries")
    return palette[index]

