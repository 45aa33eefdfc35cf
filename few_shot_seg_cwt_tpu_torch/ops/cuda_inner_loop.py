"""K=2 closed-form inner loop: CUDA kernel wrapper and its plain version.

``adapt_binary`` is the port of the TPU kernel ``adapt_binary_pallas``
(``few_shot_seg_cwt_tpu/ops/pallas_inner_loop.py``). Its kernel is
``csrc/inner_loop.cu`` (CUDA C++ for sm_90a), built with ``nvcc`` into a
shared library with a plain C interface at first use and loaded with
``ctypes``. ``adapt_binary_reference`` is the same function as a torch loop
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

# Kernel launches by name; a wrapper adds one where it launches its kernel
# and nowhere else, so a run can show that its path went through the kernel.
LAUNCHES: Dict[str, int] = {"adapt_binary": 0}

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
        lib.fss_adapt_binary_smem_bytes.argtypes = [ctypes.c_int] * 4
        lib.fss_adapt_binary_smem_bytes.restype = ctypes.c_size_t
        lib.fss_error_string.argtypes = [ctypes.c_int]
        lib.fss_error_string.restype = ctypes.c_char_p
        _libs[key] = lib
    return _libs[key]


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


def adapt_binary(f_s: torch.Tensor, pw: torch.Tensor, pwy: torch.Tensor,
                 u0: torch.Tensor, num_steps: int, lr: float) -> torch.Tensor:
    """Closed-form K=2 inner loop for E episodes; returns acc (E, C).

    f_s (E, shot, h, w, C); pw, pwy (E, shot, H, W) normalised pixel weights
    and pw * y; u0 (E, C) = W1 - W0 of the initial classifier. All fp32 and
    contiguous. The caller forms [W0 + lr*acc, W1 - lr*acc].
    """
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
    if device.type == "cpu":
        return adapt_binary_reference(f_s, pw, pwy, u0, num_steps, lr)
    if device.type != "cuda":
        raise ValueError(f"adapt_binary: unsupported device {device}")
    if num_steps < 0 or shot < 1:
        raise ValueError(f"num_steps {num_steps} / shot {shot}")
    return launch(load_library(), f_s, pw, pwy, u0, num_steps, lr)


def launch(lib: ctypes.CDLL, f_s: torch.Tensor, pw: torch.Tensor,
           pwy: torch.Tensor, u0: torch.Tensor, num_steps: int,
           lr: float) -> torch.Tensor:
    """Launch the kernel of ``lib`` on CUDA tensors that ``adapt_binary`` has
    checked; returns acc (E, C)."""
    e, shot, h, w, c = f_s.shape
    big_h, big_w = pw.shape[-2:]
    device = f_s.device
    smem = lib.fss_adapt_binary_smem_bytes(h, w, c, big_w)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"adapt_binary: {smem} B of shared memory needed for "
                         f"h={h} w={w} C={c} W={big_w}; a block has {MAX_SMEM_BYTES}")
    a, b = interp_matrices(big_h, big_w, h, w, device)
    bt = b.T.contiguous()
    pws = (pw - 2.0 * pwy).contiguous()       # pw where y=0, -pw where y=1
    scratch = torch.empty((e, h, big_w), dtype=torch.float32, device=device)
    acc = torch.empty((e, c), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.fss_adapt_binary(
            f_s.data_ptr(), pws.data_ptr(), u0.data_ptr(), a.data_ptr(),
            b.data_ptr(), bt.data_ptr(), scratch.data_ptr(), acc.data_ptr(),
            e, shot, h, w, c, big_h, big_w, int(num_steps), float(lr), stream)
    if err != 0:
        raise RuntimeError(f"adapt_binary kernel launch failed: "
                           f"{lib.fss_error_string(err).decode()} ({err})")
    LAUNCHES["adapt_binary"] += 1
    return acc
