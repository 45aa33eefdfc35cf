"""K=2 closed-form inner loop: CUDA kernel wrappers and their plain version.

``adapt_binary`` is the port of the TPU kernel ``adapt_binary_pallas`` (K1)
and ``adapt_binary_tiled`` the port of ``adapt_binary_pallas_tiled`` (K2),
both in ``few_shot_seg_cwt_tpu/ops/pallas_inner_loop.py``. Their kernels are
``csrc/inner_loop.cu`` (CUDA C++ for sm_90a; K2 is K1's body carrying
``tile`` episodes per CTA), built with ``nvcc`` into a shared library with a
plain C interface at first use and loaded with ``ctypes``.
``adapt_binary_reference`` is the function both compute, as a torch loop
(the XLA scan of ``episodic/inner_loop.py:_adapt_binary``), batched over the
episode axis.

Dispatch is by the tensors' device only: CPU tensors go to the plain
version; CUDA tensors go to the kernel, or the call raises. There is no
fallback from the card to the plain version.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Sequence

import torch

from . import cuda_build
from .resize import interp_matrix_align_corners

_SOURCE = cuda_build.CSRC / "inner_loop.cu"
# shared memory one block may use on Hopper (bytes)
MAX_SMEM_BYTES = 232_448
# episodes per CTA that the tiled kernel is instantiated for
TILES = (2, 3, 4)
# kernel constants (csrc/inner_loop.cu): H-rows per block, gB thread groups
# and the columns of each
_ROWS, _GROUPS, _GROUP_W = 16, 8, 64

# Kernel launches by name; a wrapper adds one where it launches its kernel
# and nowhere else, so a run can show that its path went through the kernel.
LAUNCHES: Dict[str, int] = {"adapt_binary": 0, "adapt_binary_tiled": 0}

# loaded libraries by their extra nvcc defines
_libs: Dict[tuple, ctypes.CDLL] = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def build_spec(defines: Sequence[str] = ()) -> cuda_build.Spec:
    """The kernel's library for ``cuda_build.build``; ``defines`` are extra
    nvcc flags such as ``-DFSS_PHASE_CLOCKS``."""
    return (_SOURCE, "libfss_inner_loop", tuple(defines))


def load_library(defines: Sequence[str] = ()) -> ctypes.CDLL:
    """Build (if needed) and load the kernel library once per process."""
    key = tuple(defines)
    if key not in _libs:
        lib = ctypes.CDLL(str(cuda_build.build([build_spec(key)])[0]))
        lib.fss_adapt_binary.argtypes = (
            [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
            + [ctypes.c_float, ctypes.c_void_p])
        lib.fss_adapt_binary.restype = ctypes.c_int
        lib.fss_adapt_binary_tiled.argtypes = (
            [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        lib.fss_adapt_binary_tiled.restype = ctypes.c_int
        lib.fss_adapt_binary_smem_bytes.argtypes = [ctypes.c_int] * 4
        lib.fss_adapt_binary_smem_bytes.restype = ctypes.c_size_t
        lib.fss_adapt_binary_tiled_smem_bytes.argtypes = [ctypes.c_int] * 5
        lib.fss_adapt_binary_tiled_smem_bytes.restype = ctypes.c_size_t
        lib.fss_error_string.argtypes = [ctypes.c_int]
        lib.fss_error_string.restype = ctypes.c_char_p
        _libs[key] = lib
    return _libs[key]


def smem_bytes(h: int, w: int, c: int, big_w: int, tile: int = 1) -> int:
    """Shared memory of one CTA carrying ``tile`` episodes, in bytes: the
    kernel's own layout (``make_layout`` in csrc/inner_loop.cu, which the
    library's ``fss_adapt_binary_tiled_smem_bytes`` reports on the card),
    computed here so that the dispatch can be decided without the library.
    Per episode u, acc (C each), d, G (h*w each), the row block's g (W*16)
    and gB (16*w); shared by the tile the block's A rows (h*16) and the gB
    partial sums (8*16*64). Segments are padded to 4 floats."""
    def r4(n):
        return (n + 3) & ~3
    per_episode = 2 * r4(c) + 2 * r4(h * w) + r4(big_w * _ROWS) + r4(_ROWS * w)
    return 4 * (tile * per_episode + r4(h * _ROWS) + _GROUPS * _ROWS * _GROUP_W)


def interp_matrices(big_h: int, big_w: int, h: int, w: int, device,
                    dtype=torch.float32) -> tuple:
    """The align-corners matrices A (H, h) and B (W, w): their fp32 values,
    as ``dtype`` tensors."""
    a = torch.as_tensor(interp_matrix_align_corners(big_h, h), device=device)
    b = torch.as_tensor(interp_matrix_align_corners(big_w, w), device=device)
    return a.to(dtype), b.to(dtype)


def adapt_binary_reference(f_s: torch.Tensor, pw: torch.Tensor,
                           pwy: torch.Tensor, u0: torch.Tensor,
                           num_steps: int, lr: float) -> torch.Tensor:
    """Plain torch version of the kernel: (E, C) accumulators.

    f_s (E, shot, h, w, C); pw, pwy (E, shot, H, W); u0 (E, C). Runs in
    the inputs' dtype (float64 gives a higher-precision witness).
    """
    e, shot, h, w, c = f_s.shape
    big_h, big_w = pw.shape[-2:]
    a, b = interp_matrices(big_h, big_w, h, w, f_s.device, f_s.dtype)
    flat = f_s.reshape(e, shot * h * w, c)
    acc = torch.zeros_like(u0)
    scale = 2.0 * lr
    for _ in range(num_steps):
        u = u0 - scale * acc
        d60 = torch.bmm(flat, u.unsqueeze(-1)).reshape(e, shot, h, w)
        d473 = a @ d60 @ b.T                                  # A d B^T
        g = pw * torch.sigmoid(d473) - pwy                    # pw (sigma - y)
        g60 = a.T @ g @ b                                     # A^T g B
        acc = acc + torch.bmm(g60.reshape(e, 1, shot * h * w), flat)[:, 0]
    return acc


def _check(name: str, t: torch.Tensor, shape: tuple) -> None:
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: float32 expected, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: shape {tuple(t.shape)} != {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _check_inputs(f_s: torch.Tensor, pw: torch.Tensor, pwy: torch.Tensor,
                  u0: torch.Tensor) -> torch.device:
    """Layout, type and device checks shared by both wrappers; returns the
    inputs' one device."""
    if f_s.ndim != 5:
        raise ValueError(f"f_s: (E, shot, h, w, C) expected, got {tuple(f_s.shape)}")
    e, shot, h, w, c = f_s.shape
    if pw.ndim != 4:
        raise ValueError(f"pw: (E, shot, H, W) expected, got {tuple(pw.shape)}")
    big_h, big_w = pw.shape[-2:]
    _check("f_s", f_s, (e, shot, h, w, c))
    _check("pw", pw, (e, shot, big_h, big_w))
    _check("pwy", pwy, (e, shot, big_h, big_w))
    _check("u0", u0, (e, c))
    devices = {t.device for t in (f_s, pw, pwy, u0)}
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: {sorted(map(str, devices))}")
    device = f_s.device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"adapt_binary: unsupported device {device}")
    return device


def adapt_binary(f_s: torch.Tensor, pw: torch.Tensor, pwy: torch.Tensor,
                 u0: torch.Tensor, num_steps: int, lr: float) -> torch.Tensor:
    """Closed-form K=2 inner loop for E episodes (K1); returns acc (E, C).

    f_s (E, shot, h, w, C); pw, pwy (E, shot, H, W) normalised pixel weights
    and pw * y; u0 (E, C) = W1 - W0 of the initial classifier. All fp32 and
    contiguous. The caller forms [W0 + lr*acc, W1 - lr*acc].
    """
    if _check_inputs(f_s, pw, pwy, u0).type == "cpu":
        return adapt_binary_reference(f_s, pw, pwy, u0, num_steps, lr)
    if num_steps < 0 or f_s.shape[1] < 1:
        raise ValueError(f"num_steps {num_steps} / shot {f_s.shape[1]}")
    return launch(load_library(), f_s, pw, pwy, u0, num_steps, lr)


def adapt_binary_tiled(f_s: torch.Tensor, pw: torch.Tensor, pwy: torch.Tensor,
                       u0: torch.Tensor, num_steps: int, lr: float,
                       tile: int) -> torch.Tensor:
    """The same function for E 1-shot episodes, ``tile`` episodes per CTA
    (K2, the port of ``adapt_binary_pallas_tiled``); returns acc (E, C).

    Takes what ``adapt_binary`` takes, with shot 1 and E % tile == 0 (the
    TPU kernel's own condition). On the card ``tile`` is one of ``TILES``
    and its shared memory must fit a block (``smem_bytes``); the call raises
    otherwise.
    """
    device = _check_inputs(f_s, pw, pwy, u0)
    e, shot = f_s.shape[:2]
    if shot != 1 or tile < 1 or e % tile != 0:
        raise ValueError(f"adapt_binary_tiled: shot 1 and E % tile == 0 needed, "
                         f"got shot {shot}, E {e}, tile {tile}")
    if device.type == "cpu":
        return adapt_binary_reference(f_s, pw, pwy, u0, num_steps, lr)
    if num_steps < 0 or tile not in TILES:
        raise ValueError(f"adapt_binary_tiled: num_steps {num_steps}, tile {tile} "
                         f"(the kernel takes {TILES})")
    return launch(load_library(), f_s, pw, pwy, u0, num_steps, lr, tile)


def launch(lib: ctypes.CDLL, f_s: torch.Tensor, pw: torch.Tensor,
           pwy: torch.Tensor, u0: torch.Tensor, num_steps: int,
           lr: float, tile: int = 1) -> torch.Tensor:
    """Launch the kernel of ``lib`` on CUDA tensors that ``adapt_binary`` or
    ``adapt_binary_tiled`` has checked: K1 for ``tile`` 1, else K2 with
    ``tile`` episodes per CTA; returns acc (E, C)."""
    e, shot, h, w, c = f_s.shape
    big_h, big_w = pw.shape[-2:]
    device = f_s.device
    name = "adapt_binary" if tile == 1 else "adapt_binary_tiled"
    smem = (lib.fss_adapt_binary_smem_bytes(h, w, c, big_w) if tile == 1
            else lib.fss_adapt_binary_tiled_smem_bytes(h, w, c, big_w, tile))
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"{name}: {smem} B of shared memory needed for h={h} w={w} "
                         f"C={c} W={big_w} tile={tile}; a block has {MAX_SMEM_BYTES}")
    a, b = interp_matrices(big_h, big_w, h, w, device)
    bt = b.T.contiguous()
    pws = (pw - 2.0 * pwy).contiguous()       # pw where y=0, -pw where y=1
    scratch = torch.empty((e, h, big_w), dtype=torch.float32, device=device)
    acc = torch.empty((e, c), dtype=torch.float32, device=device)
    args = (f_s.data_ptr(), pws.data_ptr(), u0.data_ptr(), a.data_ptr(),
            b.data_ptr(), bt.data_ptr(), scratch.data_ptr(), acc.data_ptr(),
            e, shot, h, w, c, big_h, big_w, int(num_steps), float(lr))
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        if tile == 1:
            err = lib.fss_adapt_binary(*args, stream)
        else:
            err = lib.fss_adapt_binary_tiled(*args, int(tile), stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           f"{lib.fss_error_string(err).decode()} ({err})")
    LAUNCHES[name] += 1
    return acc
