"""K=2 closed-form inner loop: CUDA kernel wrappers and their plain version.

``adapt_binary`` is the port of the TPU kernel ``adapt_binary_pallas`` (K1)
and ``adapt_binary_tiled`` the port of ``adapt_binary_pallas_tiled`` (K2),
both in ``few_shot_seg_cwt_tpu/ops/pallas_inner_loop.py``. Their kernels are
``csrc/inner_loop.cu`` (CUDA C++ for sm_90a; one body that spreads each
group of ``tile`` episodes over many CTAs of a persistent cooperative grid),
built with ``nvcc`` into a shared library with a plain C interface at first
use and loaded with ``ctypes``. The partition (``inner_loop_plan.work_plan``)
is decided here from the card's SM count and the kernel's occupancy.
``adapt_binary_reference`` is the function both compute, as a torch loop
(the XLA scan of ``episodic/inner_loop.py:_adapt_binary``), batched over the
episode axis.

Both kernels are PyTorch operators, ``fss::adapt_binary`` and
``fss::adapt_binary_tiled`` (``torch.library.custom_op``): the CUDA
implementation launches the kernel on the current stream and counts the
launch, the CPU implementation is the plain version, and a fake
implementation gives the (E, C) result's shape, so ``torch.export`` and
``FakeTensor`` tracing see one opaque node. The work plan, the shared-memory
sizing and the tap table are host work inside the CUDA implementation. The
operators have no gradient: the inner loop's result enters the transformer
detached, as in the JAX package.

Dispatch is by the tensors' device only: CPU tensors go to the plain
version; CUDA tensors go to the kernel, or the call raises. There is no
fallback from the card to the plain version.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence

import torch

from . import cuda_build
from .inner_loop_plan import (MAX_CHANNELS, MAX_SMEM_BYTES, Plan, packed_taps,
                              smem_bytes, work_plan)
from .resize import interp_matrix_align_corners

_SOURCE = cuda_build.CSRC / "inner_loop.cu"
# episodes per CTA that the tiled kernel is instantiated for
TILES = (2, 3, 4)

# Kernel launches by name; a wrapper adds one where it launches its kernel
# and nowhere else, so a run can show that its path went through the kernel.
LAUNCHES: Dict[str, int] = {"adapt_binary": 0, "adapt_binary_tiled": 0}
# The plan of each kernel's last launch, set where LAUNCHES counts it.
LAST_PLAN: Dict[str, Optional[Plan]] = {"adapt_binary": None, "adapt_binary_tiled": None}

# loaded libraries by their extra nvcc defines
_libs: Dict[tuple, ctypes.CDLL] = {}
# tap tables on the card by (H, W, h, w, device)
_taps: Dict[tuple, torch.Tensor] = {}
# SM counts by device
_sms: Dict[str, int] = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
        LAST_PLAN[k] = None


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
            [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [ctypes.c_float]
            + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        lib.fss_adapt_binary.restype = ctypes.c_int
        lib.fss_adapt_binary_smem_bytes.argtypes = [ctypes.c_int] * 9
        lib.fss_adapt_binary_smem_bytes.restype = ctypes.c_size_t
        lib.fss_sm_count.argtypes = [ctypes.POINTER(ctypes.c_int)]
        lib.fss_sm_count.restype = ctypes.c_int
        lib.fss_blocks_per_sm.argtypes = [ctypes.c_int, ctypes.c_size_t,
                                          ctypes.POINTER(ctypes.c_int)]
        lib.fss_blocks_per_sm.restype = ctypes.c_int
        lib.fss_error_string.argtypes = [ctypes.c_int]
        lib.fss_error_string.restype = ctypes.c_char_p
        _libs[key] = lib
    return _libs[key]


def _cuda_call(lib: ctypes.CDLL, name: str, *args) -> None:
    err = getattr(lib, name)(*args)
    if err != 0:
        raise RuntimeError(f"{name} failed: {lib.fss_error_string(err).decode()} ({err})")


def card_plan(lib: ctypes.CDLL, shape: tuple, big_h: int, big_w: int, tile: int,
              device) -> Plan:
    """The work plan on ``device`` for features of ``shape`` (E, shot, h, w,
    C): its SM count and the kernel's occupancy, from the library."""
    e, shot, h, w, c = shape
    device = torch.device(device)
    with torch.cuda.device(device):
        if str(device) not in _sms:
            n = ctypes.c_int(0)
            _cuda_call(lib, "fss_sm_count", ctypes.byref(n))
            _sms[str(device)] = n.value

        def occupancy(smem):
            n = ctypes.c_int(0)
            _cuda_call(lib, "fss_blocks_per_sm", tile, smem, ctypes.byref(n))
            return n.value

        return work_plan(e, shot, h, w, c, big_h, big_w, tile, _sms[str(device)], occupancy)


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
                  u0: torch.Tensor) -> None:
    """Layout, type and device checks shared by both wrappers."""
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
    if f_s.device.type not in ("cpu", "cuda"):
        raise ValueError(f"adapt_binary: unsupported device {f_s.device}")


def adapt_binary(f_s: torch.Tensor, pw: torch.Tensor, pwy: torch.Tensor,
                 u0: torch.Tensor, num_steps: int, lr: float) -> torch.Tensor:
    """Closed-form K=2 inner loop for E episodes (K1); returns acc (E, C).

    f_s (E, shot, h, w, C); pw, pwy (E, shot, H, W) normalised pixel weights
    and pw * y; u0 (E, C) = W1 - W0 of the initial classifier. All fp32 and
    contiguous. The caller forms [W0 + lr*acc, W1 - lr*acc].
    """
    _check_inputs(f_s, pw, pwy, u0)
    return torch.ops.fss.adapt_binary(f_s, pw, pwy, u0, int(num_steps), float(lr))


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
    _check_inputs(f_s, pw, pwy, u0)
    e, shot = f_s.shape[:2]
    if shot != 1 or tile < 1 or e % tile != 0:
        raise ValueError(f"adapt_binary_tiled: shot 1 and E % tile == 0 needed, "
                         f"got shot {shot}, E {e}, tile {tile}")
    return torch.ops.fss.adapt_binary_tiled(f_s, pw, pwy, u0, int(num_steps), float(lr),
                                            int(tile))


# --------------------------------------------------------------------------- #
# the operators
# --------------------------------------------------------------------------- #


@torch.library.custom_op("fss::adapt_binary", mutates_args=(), device_types="cpu")
def _adapt_binary_op(f_s: torch.Tensor, pw: torch.Tensor, pwy: torch.Tensor,
                     u0: torch.Tensor, num_steps: int, lr: float) -> torch.Tensor:
    """K1 as an operator; this is its CPU implementation, the plain version."""
    return adapt_binary_reference(f_s, pw, pwy, u0, num_steps, lr)


@_adapt_binary_op.register_kernel("cuda")
def _adapt_binary_cuda(f_s, pw, pwy, u0, num_steps, lr):
    if num_steps < 0 or f_s.shape[1] < 1:
        raise ValueError(f"num_steps {num_steps} / shot {f_s.shape[1]}")
    return launch(load_library(), f_s, pw, pwy, u0, num_steps, lr)


@_adapt_binary_op.register_fake
def _adapt_binary_fake(f_s, pw, pwy, u0, num_steps, lr):
    return u0.new_empty(u0.shape)


@torch.library.custom_op("fss::adapt_binary_tiled", mutates_args=(), device_types="cpu")
def _adapt_binary_tiled_op(f_s: torch.Tensor, pw: torch.Tensor, pwy: torch.Tensor,
                           u0: torch.Tensor, num_steps: int, lr: float,
                           tile: int) -> torch.Tensor:
    """K2 as an operator; this is its CPU implementation, the plain version."""
    return adapt_binary_reference(f_s, pw, pwy, u0, num_steps, lr)


@_adapt_binary_tiled_op.register_kernel("cuda")
def _adapt_binary_tiled_cuda(f_s, pw, pwy, u0, num_steps, lr, tile):
    if num_steps < 0 or tile not in TILES:
        raise ValueError(f"adapt_binary_tiled: num_steps {num_steps}, tile {tile} "
                         f"(the kernel takes {TILES})")
    return launch(load_library(), f_s, pw, pwy, u0, num_steps, lr, tile)


@_adapt_binary_tiled_op.register_fake
def _adapt_binary_tiled_fake(f_s, pw, pwy, u0, num_steps, lr, tile):
    return u0.new_empty(u0.shape)


def _taps_on(big_h: int, big_w: int, h: int, w: int, device) -> torch.Tensor:
    key = (big_h, big_w, h, w, str(device))
    if key not in _taps:
        _taps[key] = torch.as_tensor(packed_taps(big_h, big_w, h, w), device=device)
    return _taps[key]


def launch(lib: ctypes.CDLL, f_s: torch.Tensor, pw: torch.Tensor,
           pwy: torch.Tensor, u0: torch.Tensor, num_steps: int,
           lr: float, tile: int = 1, plan: Optional[Plan] = None) -> torch.Tensor:
    """Launch the kernel of ``lib`` on CUDA tensors that ``adapt_binary`` or
    ``adapt_binary_tiled`` has checked: K1 for ``tile`` 1, else K2 with
    ``tile`` episodes per CTA; returns acc (E, C). ``plan`` defaults to the
    card's (``card_plan``); a plan whose grid the card cannot hold at once
    makes the launch fail, and the call raise."""
    e, shot, h, w, c = f_s.shape
    big_h, big_w = pw.shape[-2:]
    device = f_s.device
    name = "adapt_binary" if tile == 1 else "adapt_binary_tiled"
    if c % 4 or c > MAX_CHANNELS:
        raise ValueError(f"{name}: C = {c}; the kernel takes a multiple of 4 up to "
                         f"{MAX_CHANNELS}")
    if plan is None:
        plan = card_plan(lib, tuple(f_s.shape), big_h, big_w, tile, device)
    pws = (pw - 2.0 * pwy).contiguous()       # pw where y=0, -pw where y=1
    taps = _taps_on(big_h, big_w, h, w, device)
    d_halo = torch.empty((e * shot, h, w), dtype=torch.float32, device=device)
    at_g_halo = torch.empty((e * shot, h, big_w), dtype=torch.float32, device=device)
    parts = torch.empty((e, h, c), dtype=torch.float32, device=device)
    counters = torch.zeros(plan.groups_in_flight, dtype=torch.int32, device=device)
    acc = torch.empty((e, c), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.fss_adapt_binary(
            f_s.data_ptr(), pws.data_ptr(), u0.data_ptr(), taps.data_ptr(),
            d_halo.data_ptr(), at_g_halo.data_ptr(), parts.data_ptr(), counters.data_ptr(),
            acc.data_ptr(), e, shot, h, w, c, big_h, big_w, int(num_steps), float(lr),
            int(tile), plan.ctas_per_group, plan.groups_in_flight, plan.rows, plan.pin,
            stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           f"{lib.fss_error_string(err).decode()} ({err}); plan "
                           f"{plan.summary()}")
    LAUNCHES[name] += 1
    LAST_PLAN[name] = plan
    return acc
