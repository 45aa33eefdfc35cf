"""Centre-pivot 4D convolution on flat volumes: CUDA kernels and plain version.

Counterpart of both TPU formulations of the NeighConsensus pivot pair,
``few_shot_seg_cwt_tpu/ops/pallas_pivot.py`` (VPU form) and
``ops/pallas_pivot_mxu.py`` (MXU form), which compute one function under one
contract: on a channels-major volume x (B, Ci, Q, S), Q = hq*wq query and
S = hs*ws support positions,

    y = conv3x3 over the query plane (wa) + conv3x3 over the support plane (wb)
        + bias [+ ReLU],

with wa, wb (3, 3, Ci, Co) and zero padding. Two hand-written kernels
(``csrc/pivot.cu``, CUDA C++ for sm_90a, built with nvcc at first use and
bound with ctypes) take the place of the four Pallas kernels: ``pivot_fwd``
(K3a and K4a; fp32 on the CUDA cores from a staged query window, a
persistent grid, ``csrc/pivot_fwd.cuh``) and ``pivot_dw`` (K3b and K4b, the
weight and bias gradient, on the tensor cores in 3xTF32 form).

Both are PyTorch operators, ``fss::pivot_fwd`` and ``fss::pivot_dw``
(``torch.library.custom_op``): a CUDA implementation that launches the
kernel on the current stream and counts the launch, a CPU implementation
that is the plain version, and a fake implementation that gives the
output shapes, so ``torch.export`` and ``FakeTensor`` tracing see one
opaque node. ``fss::pivot_fwd`` has its gradient registered
(``register_autograd``, the JAX ``custom_vjp``): dx is ``pivot_fwd`` of the
ReLU-masked cotangent with spatially flipped, (ci, co)-transposed weights,
and (dwa, dwb, db) come from ``pivot_dw``. Around the fp32 kernels the
operator does what the JAX wrappers do around the Pallas calls
(``pallas_pivot_mxu.py:243,266-268,276-277,334-335``): bf16 x, weights
and cotangent go to fp32 before a kernel, y comes out in the promoted
dtype of x and the weights, and dx, dW, db in their inputs' dtypes, so a
bf16 volume (``use_amp``) runs the same kernels and stays bf16 while
autograd holds it. ``pivot_fwd`` is the differentiable entry.

Dispatch is by device only: CPU tensors run the plain versions
(``pivot_conv_flat_reference``, ``pivot_dw_reference``: ``F.conv2d`` and its
weight gradient over reshaped views); CUDA tensors launch the kernels or the
call raises. There is no fallback from the card to the plain version.
``pivot_takes`` is the shape gate: the consensus sends a block here only
where it passes.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..utils import tracing
from . import cuda_build

_SOURCE = cuda_build.CSRC / "pivot.cu"
MAX_SMEM_BYTES = 232_448          # shared memory one Hopper block may use

# kernel libraries by extra nvcc flags (() for the main path's build)
_libs: Dict[tuple, ctypes.CDLL] = {}

Dims = Tuple[int, int, int, int]


# --------------------------------------------------------------------------- #
# shape gate
# --------------------------------------------------------------------------- #


def pivot_takes(kernel_size, stride, padding) -> bool:
    """Do the kernels take a centre-pivot block of this shape? 3^4 kernels,
    stride 1, padding 1."""
    return (tuple(kernel_size) == (3, 3, 3, 3) and tuple(stride) == (1, 1, 1, 1)
            and tuple(padding) == (1, 1, 1, 1))


# --------------------------------------------------------------------------- #
# plain versions
# --------------------------------------------------------------------------- #


def _oihw(w: torch.Tensor) -> torch.Tensor:
    return w.permute(3, 2, 0, 1)                 # (3, 3, Ci, Co) -> (Co, Ci, 3, 3)


def _query_view(t: torch.Tensor, dims: Dims) -> torch.Tensor:
    """(B, C, Q, S) -> (B*S, C, hq, wq): the query plane as a conv batch."""
    hq, wq, _, _ = dims
    b, c, _, s = t.shape
    return t.permute(0, 3, 1, 2).reshape(b * s, c, hq, wq)


def _support_view(t: torch.Tensor, dims: Dims) -> torch.Tensor:
    """(B, C, Q, S) -> (B*Q, C, hs, ws): the support plane as a conv batch."""
    _, _, hs, ws = dims
    b, c, q, _ = t.shape
    return t.permute(0, 2, 1, 3).reshape(b * q, c, hs, ws)


def pivot_conv_flat_reference(x: torch.Tensor, wa: torch.Tensor, wb: torch.Tensor,
                              bias: torch.Tensor, dims: Dims,
                              relu: bool = False) -> torch.Tensor:
    """Plain version: two ``F.conv2d`` over reshaped views; runs in the
    inputs' dtype and is differentiable by autograd."""
    b, _, q, s = x.shape
    co = wa.shape[-1]
    yq = F.conv2d(_query_view(x, dims), _oihw(wa), padding=1)
    yq = yq.reshape(b, s, co, q).permute(0, 2, 3, 1)
    ys = F.conv2d(_support_view(x, dims), _oihw(wb), padding=1)
    ys = ys.reshape(b, q, co, s).permute(0, 2, 1, 3)
    y = yq + ys + bias.reshape(1, co, 1, 1)
    return torch.relu(y) if relu else y


def pivot_dw_reference(x: torch.Tensor, g: torch.Tensor, dims: Dims
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the weight gradient: (dwa, dwb, db) for cotangent g
    (B, Co, Q, S), as conv2d weight gradients over the same views."""
    ci, co = x.shape[1], g.shape[1]
    wshape = (co, ci, 3, 3)
    dwa = torch.nn.grad.conv2d_weight(_query_view(x, dims), wshape,
                                      _query_view(g, dims), padding=1)
    dwb = torch.nn.grad.conv2d_weight(_support_view(x, dims), wshape,
                                      _support_view(g, dims), padding=1)
    return dwa.permute(2, 3, 1, 0), dwb.permute(2, 3, 1, 0), g.sum(dim=(0, 2, 3))


# --------------------------------------------------------------------------- #
# kernel library
# --------------------------------------------------------------------------- #


def build_spec(defines: Sequence[str] = ()) -> cuda_build.Spec:
    """The kernels' library for ``cuda_build.build``; ``defines`` are extra
    nvcc flags such as ``-DFSS_PHASE_CLOCKS``."""
    return (_SOURCE, "libfss_pivot", tuple(defines))


def load_library(defines: Sequence[str] = ()) -> ctypes.CDLL:
    """Build (if needed) and load the kernel library once per process."""
    key = tuple(defines)
    if key not in _libs:
        lib = ctypes.CDLL(str(cuda_build.build([build_spec(key)])[0]))
        i, p = ctypes.c_int, ctypes.c_void_p
        lib.fss_pivot_fwd.argtypes = [p] * 4 + [i] * 8 + [p]
        lib.fss_pivot_fwd.restype = i
        lib.fss_pivot_dw.argtypes = [p] * 4 + [i] * 8 + [p]
        lib.fss_pivot_dw.restype = i
        lib.fss_pivot_dw_blocks.argtypes = [i] * 7
        lib.fss_pivot_dw_blocks.restype = i
        lib.fss_pivot_fwd_smem_bytes.argtypes = [i] * 4
        lib.fss_pivot_fwd_smem_bytes.restype = ctypes.c_size_t
        lib.fss_pivot_fwd_plan.argtypes = [i] * 7 + [p]
        lib.fss_pivot_fwd_plan.restype = i
        lib.fss_pivot_dw_smem_bytes.argtypes = [i] * 3
        lib.fss_pivot_dw_smem_bytes.restype = ctypes.c_size_t
        lib.fss_pivot_max_co.argtypes = []
        lib.fss_pivot_max_co.restype = i
        lib.fss_pivot_dw_max_ci.argtypes = []
        lib.fss_pivot_dw_max_ci.restype = i
        lib.fss_pivot_error_string.argtypes = [i]
        lib.fss_pivot_error_string.restype = ctypes.c_char_p
        _libs[key] = lib
    return _libs[key]


def _check_volume(name: str, t: torch.Tensor, dims: Dims) -> None:
    hq, wq, hs, ws = dims
    if t.ndim != 4 or t.shape[2] != hq * wq or t.shape[3] != hs * ws:
        raise ValueError(f"{name}: (B, C, {hq * wq}, {hs * ws}) expected for dims "
                         f"{dims}, got {tuple(t.shape)}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: float32 expected, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if t.device.type != "cuda":
        raise ValueError(f"{name}: CUDA tensor expected, got {t.device}")


def _raise_on(lib: ctypes.CDLL, name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           f"{lib.fss_pivot_error_string(err).decode()} ({err})")


def flatten_weights(wa: torch.Tensor, wb: torch.Tensor) -> torch.Tensor:
    """(3, 3, Ci, Co) query and support kernels -> the kernel's (Ci, 18, Co):
    taps 0-8 query plane, 9-17 support plane, row-major within each 3x3."""
    ci, co = wa.shape[2], wa.shape[3]
    taps = torch.cat([wa.reshape(9, ci, co), wb.reshape(9, ci, co)], dim=0)
    return taps.permute(1, 0, 2).contiguous()


def pivot_fwd(x: torch.Tensor, wa: torch.Tensor, wb: torch.Tensor,
              bias: torch.Tensor, dims: Sequence[int], relu: bool = False) -> torch.Tensor:
    """Centre-pivot conv pair on a flat volume, differentiable.

    x (B, Ci, Q, S) with Q = hq*wq, S = hs*ws (dims = (hq, wq, hs, ws));
    wa/wb (3, 3, Ci, Co) query-/support-plane kernels; bias (Co,). Returns
    y (B, Co, Q, S): the forward kernel on CUDA tensors (any batch; Ci while
    one support row of its staged window fits a block's shared memory), the
    plain version on CPU tensors; bf16 / fp16 operands run in fp32 and y
    comes back in their promoted type."""
    return torch.ops.fss.pivot_fwd(x.contiguous(), wa, wb, bias, [int(d) for d in dims],
                                   bool(relu))


def launch_fwd(lib: ctypes.CDLL, x: torch.Tensor, wa: torch.Tensor, wb: torch.Tensor,
               bias: torch.Tensor, dims: Dims, relu: bool = False) -> torch.Tensor:
    """Check CUDA tensors for the forward kernel of ``lib`` and launch it;
    ``pivot_fwd`` is the counted entry point."""
    _check_volume("x", x, dims)
    b, ci = x.shape[:2]
    co = wa.shape[-1]
    for name, w in (("wa", wa), ("wb", wb)):
        if tuple(w.shape) != (3, 3, ci, co) or w.dtype != torch.float32:
            raise ValueError(f"{name}: float32 (3, 3, {ci}, {co}) expected, got "
                             f"{w.dtype} {tuple(w.shape)}")
    if tuple(bias.shape) != (co,) or bias.dtype != torch.float32:
        raise ValueError(f"bias: float32 ({co},) expected, got {bias.dtype} "
                         f"{tuple(bias.shape)}")
    if {t.device for t in (x, wa, wb, bias)} != {x.device}:
        raise ValueError("pivot_fwd: inputs on several devices")
    if not 1 <= co <= lib.fss_pivot_max_co():
        raise ValueError(f"pivot kernels take 1..{lib.fss_pivot_max_co()} output "
                         f"channels, got {co}")
    smem = lib.fss_pivot_fwd_smem_bytes(ci, co, dims[2], dims[3])
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"pivot_fwd: {smem} B of shared memory for Ci={ci} Co={co} "
                         f"ws={dims[3]}; a block has {MAX_SMEM_BYTES}")
    w = flatten_weights(wa, wb)
    bias = bias.contiguous()
    y = torch.empty((b, co) + tuple(x.shape[2:]), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.fss_pivot_fwd(x.data_ptr(), w.data_ptr(), bias.data_ptr(),
                                y.data_ptr(), b, ci, co, *dims, int(bool(relu)), stream)
    _raise_on(lib, "pivot_fwd", err)
    return y


def pivot_dw(x: torch.Tensor, g: torch.Tensor, dims: Dims
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dwa, dwb, db) of the pivot pair for input x (B, Ci, Q, S) and
    cotangent g (B, Co, Q, S), summed over the batch: the two-pass kernel on
    CUDA tensors (a persistent grid of tensor-core CTAs, then their partials
    summed in order), the plain version on CPU tensors."""
    return tuple(torch.ops.fss.pivot_dw(x, g, [int(d) for d in dims]))


def launch_dw(lib: ctypes.CDLL, x: torch.Tensor, g: torch.Tensor, dims: Dims
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Check CUDA tensors for the weight-gradient kernel of ``lib`` and
    launch it; ``pivot_dw`` is the counted entry point."""
    _check_volume("x", x, dims)
    _check_volume("g", g, dims)
    if g.shape[0] != x.shape[0] or g.device != x.device:
        raise ValueError(f"g {tuple(g.shape)} on {g.device} does not match "
                         f"x {tuple(x.shape)} on {x.device}")
    b, ci = x.shape[:2]
    co = g.shape[1]
    if not 1 <= co <= lib.fss_pivot_max_co() or not 1 <= ci <= lib.fss_pivot_dw_max_ci():
        raise ValueError(f"pivot_dw takes 1..{lib.fss_pivot_dw_max_ci()} input and "
                         f"1..{lib.fss_pivot_max_co()} output channels, got {ci}, {co}")
    smem = lib.fss_pivot_dw_smem_bytes(ci, co, dims[3])
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"pivot_dw: {smem} B of shared memory for Ci={ci} Co={co} "
                         f"ws={dims[3]}; a block has {MAX_SMEM_BYTES}")
    n_out = 18 * ci * co + co
    with torch.cuda.device(x.device):
        blocks = lib.fss_pivot_dw_blocks(b, ci, co, *dims)
        if blocks < 1:
            raise RuntimeError(f"pivot_dw: the card holds no CTA of {smem} B")
        partial = torch.empty((blocks, n_out), dtype=torch.float32, device=x.device)
        out = torch.empty((n_out,), dtype=torch.float32, device=x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.fss_pivot_dw(x.data_ptr(), g.data_ptr(), partial.data_ptr(),
                               out.data_ptr(), b, ci, co, *dims, blocks, stream)
    _raise_on(lib, "pivot_dw", err)
    taps = out[:18 * ci * co].reshape(2, 3, 3, ci, co)
    return taps[0], taps[1], out[18 * ci * co:]


# --------------------------------------------------------------------------- #
# the operators
# --------------------------------------------------------------------------- #


def _wide(t: torch.Tensor) -> torch.Tensor:
    """bf16 and fp16 go to fp32, the kernels' type; other types as they are."""
    return t.float() if t.dtype in (torch.bfloat16, torch.float16) else t


@torch.library.custom_op("fss::pivot_fwd", mutates_args=(), device_types="cpu")
def _pivot_fwd_op(x: torch.Tensor, wa: torch.Tensor, wb: torch.Tensor, bias: torch.Tensor,
                  dims: List[int], relu: bool) -> torch.Tensor:
    """``pivot_fwd`` as an operator; this is its CPU implementation, the
    plain version. bf16 / fp16 operands run in fp32 and y comes back in the
    promoted type of x and the weights, as on the card."""
    y = pivot_conv_flat_reference(_wide(x), _wide(wa), _wide(wb), _wide(bias), tuple(dims),
                                  relu)
    return y.to(torch.promote_types(x.dtype, wa.dtype)).contiguous()


@_pivot_fwd_op.register_kernel("cuda")
def _pivot_fwd_cuda(x, wa, wb, bias, dims, relu):
    y = launch_fwd(load_library(), _wide(x), _wide(wa), _wide(wb), _wide(bias), tuple(dims),
                   relu)
    tracing.count("pivot_fwd")
    return y.to(torch.promote_types(x.dtype, wa.dtype))


@_pivot_fwd_op.register_fake
def _pivot_fwd_fake(x, wa, wb, bias, dims, relu):
    return x.new_empty((x.shape[0], wa.shape[-1]) + tuple(x.shape[2:]),
                       dtype=torch.promote_types(x.dtype, wa.dtype))


@torch.library.custom_op("fss::pivot_dw", mutates_args=(), device_types="cpu")
def _pivot_dw_op(x: torch.Tensor, g: torch.Tensor, dims: List[int]
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``pivot_dw`` as an operator; this is its CPU implementation, the
    plain version."""
    return tuple(t.contiguous() for t in pivot_dw_reference(x, g, tuple(dims)))


@_pivot_dw_op.register_kernel("cuda")
def _pivot_dw_cuda(x, g, dims):
    out = launch_dw(load_library(), x, g, tuple(dims))
    tracing.count("pivot_dw")
    return tuple(t.clone() for t in out)    # views of one buffer -> own tensors


@_pivot_dw_op.register_fake
def _pivot_dw_fake(x, g, dims):
    ci, co = x.shape[1], g.shape[1]
    return (x.new_empty((3, 3, ci, co)), x.new_empty((3, 3, ci, co)), x.new_empty((co,)))


def flip_t(w: torch.Tensor) -> torch.Tensor:
    """Spatially flipped, (ci, co)-transposed kernel: the conv whose forward
    is the pivot pair's gradient with respect to x."""
    return w.flip(0, 1).transpose(2, 3)


def _pivot_fwd_setup(ctx, inputs, output):
    # the operands in their own types (a bf16 volume stays bf16 while saved)
    x, wa, wb, bias, dims, relu = inputs
    ctx.dims, ctx.relu, ctx.bias_dtype = dims, relu, bias.dtype
    ctx.save_for_backward(x, wa, wb, output if relu else None)


def _pivot_fwd_backward(ctx, dy):
    # on autograd's thread: the consensus span of the backward's pivot work
    with tracing.span("consensus"):
        x, wa, wb, y = ctx.saved_tensors
        g = _wide(dy * (y > 0).to(dy.dtype) if ctx.relu else dy).contiguous()
        dx = dwa = dwb = db = None
        if ctx.needs_input_grad[0]:
            zeros = torch.zeros((x.shape[1],), dtype=g.dtype, device=g.device)
            dx = torch.ops.fss.pivot_fwd(g, flip_t(_wide(wa)), flip_t(_wide(wb)), zeros,
                                         ctx.dims, False).to(x.dtype)
        if any(ctx.needs_input_grad[1:4]):
            dwa, dwb, db = torch.ops.fss.pivot_dw(_wide(x).contiguous(), g, ctx.dims)
            dwa, dwb, db = dwa.to(wa.dtype), dwb.to(wb.dtype), db.to(ctx.bias_dtype)
        return dx, dwa, dwb, db, None, None


_pivot_fwd_op.register_autograd(_pivot_fwd_backward, setup_context=_pivot_fwd_setup)
