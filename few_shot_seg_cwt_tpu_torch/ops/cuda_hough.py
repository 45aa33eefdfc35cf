"""The CHM head's direct 4D convolution (Hough matching): CUDA kernel and
plain version.

It replaces no TPU kernel: the JAX package computes CHM6d and CHM4d
(``models/chm.py``) as XLA convolutions through ``models/conv4d.py``,
outside any Pallas kernel. On the card ``conv4d``'s route ``q`` ran them as
cuDNN conv2d over folded query taps, far from their bound; ``hough4d``
(``csrc/hough4d.cuh``, CUDA C++ for sm_90a, built with nvcc at first use and
bound with ctypes) computes

    y[b, i, j, k, l, co] = sum_{a, b', c, d, ci} K[a, b', c, d, ci, co]
                           x[b, i+a-2, j+b'-2, k+c-2, l+d-2, ci]  (+ bias)

over the taps inside the volume (zero padding 2), with fp32 FMAs on the
CUDA cores, for a 5^4 kernel at (Ci, Co) = (1, 1) (CHM4d) and (9, 9)
(CHM6d). It reads x (B, h, w, hs, ws, Ci) in the layout it arrives in (the
support plane contiguous; CHM6d's channel-major view as it is) and returns
(B, h, w, hs, ws, Co) as a permuted view of a channel-major (B, Co, h, w,
hs, ws) buffer, the layout CHM6d permutes back into at no cost.

``fss::hough4d`` is a PyTorch operator (``torch.library.custom_op``): a CUDA
implementation that launches the kernel on the current stream and counts
the launch under ``hough4d``, a CPU implementation that is the plain
version (``hough4d_reference``: a support-plane ``F.conv2d`` for each
query tap), and a fake implementation with the output's shape and strides,
so ``torch.export`` of the CHM head on the card sees one opaque node. It
has no gradient: ``conv4d`` takes it only where autograd records nothing
(``hough4d_takes``), and CHM training keeps route ``q``'s cuDNN path.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..utils import tracing
from . import cuda_build

_SOURCE = cuda_build.CSRC / "hough4d.cu"
KSZ = 5                            # the kernel's side on every axis
LINK = 28                          # floats of a staged (ci, co) link: 25 taps, flag, 2 zeros
INSTANCES = ((1, 1), (9, 9))       # (Ci, Co) the kernel is built for: CHM4d, CHM6d
MAX_THREADS = 256                  # most threads a CTA runs (csrc/hough4d.cuh)
MAX_SMEM_BYTES = 232_448           # shared memory one Hopper block may use

_lib: Optional[ctypes.CDLL] = None


def hough4d_reference(x: torch.Tensor, kernel: torch.Tensor,
                      bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version: for each of the 25 query taps (a, b'), ``F.conv2d``
    over the support planes of x shifted by the tap (zero padded) with
    K[a, b'], summed; then the bias. x (B, h, w, hs, ws, Ci), kernel (5, 5,
    5, 5, Ci, Co), bias None, () or (Co,); runs in the dtype of x and
    returns the kernel's layout."""
    b, h, w, hs, ws, ci = x.shape
    co, r = kernel.shape[-1], KSZ // 2
    planes = F.pad(x, (0, 0, 0, 0, 0, 0, r, r, r, r)).permute(0, 1, 2, 5, 3, 4)
    out = None
    for a in range(KSZ):
        for bq in range(KSZ):
            t = planes[:, a:a + h, bq:bq + w].reshape(b * h * w, ci, hs, ws)
            o = F.conv2d(t, kernel[a, bq].to(x.dtype).permute(3, 2, 0, 1), padding=r)
            out = o if out is None else out + o
    out = out.reshape(b, h, w, co, hs, ws).permute(0, 3, 1, 2, 4, 5)
    if bias is not None:
        out = out + bias.to(out.dtype).reshape(1, -1, 1, 1, 1, 1)
    return out.contiguous().permute(0, 2, 3, 4, 5, 1)


def hough4d_takes(x: torch.Tensor, kernel: torch.Tensor,
                  bias: Optional[torch.Tensor] = None) -> bool:
    """``conv4d``'s gate for the kernel: a CUDA fp32 volume and kernel, a 5^4
    kernel at an instantiated (Ci, Co), and autograd recording nothing
    (grad mode off, or no operand requiring grad)."""
    if not (x.is_cuda and x.dtype == torch.float32 and kernel.dtype == torch.float32):
        return False
    if x.ndim != 6 or tuple(kernel.shape[:4]) != (KSZ,) * 4 \
            or tuple(kernel.shape[4:]) not in INSTANCES or x.shape[-1] != kernel.shape[4]:
        return False
    return not (torch.is_grad_enabled()
                and any(t is not None and t.requires_grad for t in (x, kernel, bias)))


def taps_inside(side: int, k: int = KSZ) -> int:
    """(output, tap) pairs along one axis of length ``side`` whose input
    lies inside it, for an odd kernel ``k`` with zero padding k // 2."""
    r = k // 2
    return sum(min(side - 1, o + r) - max(0, o - r) + 1 for o in range(side))


def hough4d_work(x_shape: Sequence[int], co: int, links: int) -> Tuple[int, int]:
    """(flops, bytes) of one call on a volume of ``x_shape`` (B, h, w, hs,
    ws, Ci) with ``links`` non-zero (ci, co) links: 2 FLOP for each tap
    inside the volume; each input element read once, each output written
    once."""
    b, h, w, hs, ws, ci = x_shape
    taps = taps_inside(h) * taps_inside(w) * taps_inside(hs) * taps_inside(ws)
    return 2 * b * links * taps, 4 * b * (ci + co) * h * w * hs * ws


def link_weights(kernel: torch.Tensor) -> torch.Tensor:
    """(5, 5, 5, 5, Ci, Co) -> the kernel's (25, Ci, Co, 28): each query
    tap's (ci, co) links, their 25 support taps row-major, a flag that is 1
    where any of them is not zero (the kernel skips the others), 2 zeros.
    Made on the kernel's device: no host read."""
    ci, co = kernel.shape[4:]
    k = kernel.reshape(KSZ * KSZ, KSZ * KSZ, ci, co).permute(0, 2, 3, 1)
    flag = (k != 0).any(dim=-1, keepdim=True).to(k.dtype)
    return torch.cat([k, flag, k.new_zeros(k.shape[:-1] + (LINK - KSZ * KSZ - 1,))],
                     dim=-1).contiguous()


# --------------------------------------------------------------------------- #
# kernel library
# --------------------------------------------------------------------------- #


def build_spec() -> cuda_build.Spec:
    """The kernel's library for ``cuda_build.build``."""
    return (_SOURCE, "libfss_hough4d", ())


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library once per process."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(cuda_build.build([build_spec()])[0]))
        i, p, q = ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong
        lib.fss_hough4d.argtypes = [p] * 4 + [i] * 7 + [q] * 4 + [i, p]
        lib.fss_hough4d.restype = i
        lib.fss_hough4d_plan.argtypes = [i] * 4 + [p]
        lib.fss_hough4d_plan.restype = i
        lib.fss_hough4d_error_string.argtypes = [i]
        lib.fss_hough4d_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def plan(lib: ctypes.CDLL, ci: int, co: int, hs: int, ws: int) -> Dict:
    """The launch of (ci, co) at a (hs, ws) support plane: threads a CTA,
    support rows a CTA, CTAs a query position, shared bytes a CTA."""
    out = (ctypes.c_longlong * 4)()
    if lib.fss_hough4d_plan(ci, co, hs, ws, ctypes.addressof(out)) != 0:
        raise ValueError(f"hough4d takes (Ci, Co) in {INSTANCES}, got ({ci}, {co})")
    return {"threads": out[0], "band": out[1], "bands": out[2], "smem": out[3]}


def launch(lib: ctypes.CDLL, x: torch.Tensor, kernel: torch.Tensor,
           bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Check CUDA tensors for the kernel of ``lib`` and launch it; ``hough4d``
    is the counted entry point."""
    if x.ndim != 6 or x.dtype != torch.float32 or x.device.type != "cuda":
        raise ValueError(f"x: a float32 CUDA (B, h, w, hs, ws, Ci) volume expected, got "
                         f"{x.dtype} {tuple(x.shape)} on {x.device}")
    b, h, w, hs, ws, ci = x.shape
    co = kernel.shape[-1]
    if tuple(kernel.shape) != (KSZ,) * 4 + (ci, co) or kernel.dtype != torch.float32 \
            or (ci, co) not in INSTANCES:
        raise ValueError(f"kernel: float32 (5, 5, 5, 5, Ci, Co) with (Ci, Co) in {INSTANCES} "
                         f"and Ci = {ci} expected, got {kernel.dtype} {tuple(kernel.shape)}")
    if bias is not None and (bias.numel() not in (1, co) or bias.dtype != torch.float32):
        raise ValueError(f"bias: float32 with 1 or {co} values expected, got {bias.dtype} "
                         f"{tuple(bias.shape)}")
    if {t.device for t in (x, kernel, bias) if t is not None} != {x.device}:
        raise ValueError("hough4d: inputs on several devices")
    p = plan(lib, ci, co, hs, ws)
    if p["threads"] > MAX_THREADS or p["smem"] > MAX_SMEM_BYTES:
        raise ValueError(f"hough4d: a CTA of {p['threads']} threads and {p['smem']} B at "
                         f"ws = {ws}; at most {MAX_THREADS} and {MAX_SMEM_BYTES}")
    y = torch.empty((b, co, h, w, hs, ws), dtype=torch.float32, device=x.device)
    if y.numel() == 0:
        return y.permute(0, 2, 3, 4, 5, 1)
    if not x[0, 0, 0, :, :, 0].is_contiguous():
        # the kernel stages whole support rows: bring the plane together
        x = x.permute(0, 5, 1, 2, 3, 4).contiguous().permute(0, 2, 3, 4, 5, 1)
    wt = link_weights(kernel)
    bias_v = None if bias is None else bias.reshape(-1).contiguous()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.fss_hough4d(x.data_ptr(), wt.data_ptr(),
                              None if bias_v is None else bias_v.data_ptr(), y.data_ptr(),
                              b, h, w, hs, ws, ci, co, x.stride(0), x.stride(1), x.stride(2),
                              x.stride(5), 0 if bias_v is None or bias_v.numel() == 1 else 1,
                              stream)
    if err != 0:
        raise RuntimeError(f"hough4d kernel launch failed: "
                           f"{lib.fss_hough4d_error_string(err).decode()} ({err})")
    return y.permute(0, 2, 3, 4, 5, 1)


def hough4d(x: torch.Tensor, kernel: torch.Tensor,
            bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The 4D convolution of a 5^4 kernel (5, 5, 5, 5, Ci, Co) over x (B, h,
    w, hs, ws, Ci), zero padding 2, plus ``bias`` (None, () or (Co,)):
    (B, h, w, hs, ws, Co). The kernel on CUDA tensors, the plain version on
    CPU tensors; no gradient."""
    return torch.ops.fss.hough4d(x, kernel, bias)


@torch.library.custom_op("fss::hough4d", mutates_args=(), device_types="cpu")
def _hough4d_op(x: torch.Tensor, kernel: torch.Tensor,
                bias: Optional[torch.Tensor]) -> torch.Tensor:
    """``hough4d`` as an operator; this is its CPU implementation, the plain
    version."""
    return hough4d_reference(x, kernel, bias)


@_hough4d_op.register_kernel("cuda")
def _hough4d_cuda(x, kernel, bias):
    y = launch(load_library(), x, kernel, bias)
    tracing.count("hough4d")
    return y


@_hough4d_op.register_fake
def _hough4d_fake(x, kernel, bias):
    b, h, w, hs, ws, _ = x.shape
    return x.new_empty((b, kernel.shape[-1], h, w, hs, ws)).permute(0, 2, 3, 4, 5, 1)
