"""The CHM head's Hough kernel (``hough4d``, ``csrc/hough4d.cuh``): its plain
version against ``conv4d``'s route ``q``, the kernel itself on the CPU
through ``csrc/cuda_emulation.h``, the operator, and ``conv4d``'s dispatch.

* Plain version: at both instances, 1 -> 1 on 12^4 and 9 -> 9 with CHM6d's
  block-sparse kernel on 6^4 (the padding edges included), within 1e-5 of
  the scale of route ``q`` (cuDNN's folded-tap conv2d here on the CPU).
* Emulation: g++ compiles the kernel's header with
  ``csrc/hough4d_emulated.cpp``; each CTA's threads run as std::threads,
  ``__syncthreads`` as a std::barrier, a cp.async as a plain copy. Its
  output must equal the per-output fmaf chain the kernel keeps (query taps,
  channels, support taps; links flagged zero skipped) up to the sign of
  zero, and lie within 1e-5 of the plain version's scale, at odd and
  banded shapes, with 4- and 8-byte copies. It cannot see races between
  the card's asynchronous copies, nor its timing. Skips only where g++ is
  missing.
* Dispatch: the gate is a shape and grad-mode test on the operands. On the
  CPU it is checked on fake CUDA tensors (``FakeTensorMode``), where the
  operator's fake implementation runs; the launch counter moves only on
  the card (the ``cuda`` tests at the end, which also hold the kernel
  against route ``q`` at the 473 px shapes).

Card tests: ``python -m pytest tests/test_torch_hough4d.py -q -m cuda
--noconftest`` on a machine with an H100 and nvcc.
"""

import ctypes
import importlib
import shutil
import subprocess

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from few_shot_seg_cwt_tpu_torch import ops
from few_shot_seg_cwt_tpu_torch.models.chm import CHM6d
from few_shot_seg_cwt_tpu_torch.models.conv4d import Conv4d, _conv4d_q, conv4d
from few_shot_seg_cwt_tpu_torch.ops import cuda_build, cuda_hough
from few_shot_seg_cwt_tpu_torch.utils import tracing

_SOURCE = cuda_build.CSRC / "hough4d_emulated.cpp"
conv4d_mod = importlib.import_module("few_shot_seg_cwt_tpu_torch.models.conv4d")


def _chm6d_kernel(seed=0):
    """CHM6d's (5, 5, 5, 5, 9, 9) kernel: 49 of its 81 scale links live."""
    gen = torch.Generator().manual_seed(seed)
    m = CHM6d(generator=gen)
    with torch.no_grad():
        for i in range(4):
            p = getattr(m, f"param_{i}")
            p.copy_(torch.randn(p.shape, generator=gen))
    with torch.no_grad():
        return m.channel_kernel((3, 3))


def _volume(shape, ci, channel_major, seed):
    """(B, h, w, hs, ws, Ci) uniform volume; ``channel_major`` gives CHM6d's
    view of a (B, Ci, h, w, hs, ws) buffer."""
    gen = torch.Generator().manual_seed(seed)
    if channel_major:
        return torch.rand((shape[0], ci) + tuple(shape[1:]), generator=gen).permute(
            0, 2, 3, 4, 5, 1)
    return torch.rand(tuple(shape) + (ci,), generator=gen)


def _kernel(ci, co, seed):
    if (ci, co) == (9, 9):
        return _chm6d_kernel(seed)
    gen = torch.Generator().manual_seed(seed)
    return 0.05 * torch.randn((5, 5, 5, 5, ci, co), generator=gen)


@pytest.mark.parametrize("ci,shape,bias", [
    (1, (1, 12, 12, 12, 12), 0.3),
    (1, (2, 5, 7, 9, 6), None),
    (9, (1, 6, 6, 6, 6), -0.2),
    (9, (2, 4, 3, 5, 7), "vector"),
])
def test_plain_version_matches_route_q(ci, shape, bias):
    """The plain version (a support-plane conv2d a query tap) against route
    ``q`` (k0 conv2d over folded query-column taps) plus the bias."""
    x = _volume(shape, ci, ci == 9, 1)
    k = _kernel(ci, ci, 2)
    bv = (torch.linspace(-1, 1, ci) if bias == "vector"
          else None if bias is None else torch.tensor(bias))
    want = _conv4d_q(x, k)
    if bv is not None:
        want = want + bv
    got = cuda_hough.hough4d_reference(x, k, bv)
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    assert got.permute(0, 5, 1, 2, 3, 4).is_contiguous()      # the kernel's layout


def test_link_weights_flag_chm6d_links():
    """The staged links of CHM6d's kernel: the 25 taps as given, a flag on
    the 49 live (ci, co) scale links of every query tap, zeros after."""
    k = _chm6d_kernel()
    wt = cuda_hough.link_weights(k)
    assert tuple(wt.shape) == (25, 9, 9, 28) and wt.is_contiguous()
    assert torch.equal(wt[..., :25], k.reshape(25, 25, 9, 9).permute(0, 2, 3, 1))
    flags = wt[..., 25]
    assert set(flags.unique().tolist()) == {0.0, 1.0}
    assert (flags.sum(dim=(1, 2)) == 49).all()
    assert not wt[..., 26:].any()


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernel's emulation")
    out = tmp_path_factory.mktemp("hough4d_emu") / "libfss_hough4d_emu.so"
    subprocess.run([gxx, "-std=c++20", "-O1", "-pthread", "-ffp-contract=off", "-shared",
                    "-fPIC", "-o", str(out), str(_SOURCE)], check=True, timeout=300)
    lib = ctypes.CDLL(str(out))
    p, i, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.fss_hough4d_emulated.argtypes = [p] * 4 + [i] * 7 + [q] * 4 + [i]
    lib.fss_hough4d_emulated.restype = i
    lib.fss_hough4d_chain.argtypes = [p] * 4 + [i] * 7 + [q] * 4 + [i]
    lib.fss_hough4d_chain.restype = None
    lib.fss_hough4d_emulated_plan.argtypes = [i] * 4 + [p]
    lib.fss_hough4d_emulated_plan.restype = i
    return lib


def _emu_plan(lib, ci, co, hs, ws):
    out = (ctypes.c_longlong * 4)()
    assert lib.fss_hough4d_emulated_plan(ci, co, hs, ws, ctypes.addressof(out)) == 0
    return {"threads": out[0], "band": out[1], "bands": out[2], "smem": out[3]}


def _run(lib, fn, x, wt, bias, co):
    """The emulated kernel or the chain on x (any strides, the support plane
    contiguous): y (B, co, h, w, hs, ws) channel-major."""
    b, h, w, hs, ws, ci = x.shape
    y = torch.full((b, co, h, w, hs, ws), float("nan"))
    bias_v = None if bias is None else bias.reshape(-1).contiguous()
    args = [x.data_ptr(), wt.data_ptr(), None if bias_v is None else bias_v.data_ptr(),
            y.data_ptr(), b, h, w, hs, ws, ci, co, x.stride(0), x.stride(1), x.stride(2),
            x.stride(5), 0 if bias_v is None or bias_v.numel() == 1 else 1]
    if fn == "kernel":
        assert lib.fss_hough4d_emulated(*args) == 0
    else:
        lib.fss_hough4d_chain(*args)
    return y


@pytest.mark.parametrize("ci,shape,bias,layout", [
    (1, (1, 12, 12, 12, 12), 0.3, "plain"),     # CHM4d's instance, one band, 16-byte copies
    (1, (2, 5, 7, 9, 11), None, "plain"),       # odd ws: 4-byte copies
    (1, (1, 1, 2, 70, 132), -0.5, "plain"),     # 33 tiles a row: 2 bands of 56 rows
    (9, (1, 6, 6, 6, 6), -0.2, "plain"),        # CHM6d's instance and kernel, 8-byte copies
    (9, (2, 4, 3, 7, 5), "vector", "sliced"),   # a query slice of a wider buffer, odd ws
    (9, (1, 2, 1, 30, 130), 0.1, "plain"),      # 33 tiles a row: 3 bands of 14, 14, 2 rows
])
def test_emulated_kernel_gives_the_chain_and_the_plain_values(emu, ci, shape, bias, layout):
    if layout == "sliced":
        b, h, w, hs, ws = shape
        x = _volume((b, h, w + 1, hs, ws), ci, True, 3)[:, :, 1:]
    else:
        x = _volume(shape, ci, ci == 9, 3)
    assert x[0, 0, 0, :, :, 0].is_contiguous()
    k = _kernel(ci, ci, 4)
    bv = (torch.linspace(-1, 1, ci) if bias == "vector"
          else None if bias is None else torch.tensor(bias))
    wt = cuda_hough.link_weights(k)
    y = _run(emu, "kernel", x, wt, bv, ci)
    chain = _run(emu, "chain", x, wt, bv, ci)
    assert not torch.isnan(y).any()
    assert torch.equal(y, chain)              # -0.0 == 0.0: equal up to the sign of zero
    plain = cuda_hough.hough4d_reference(x, k, bv).permute(0, 5, 1, 2, 3, 4)
    assert float((y - plain).abs().max()) <= 1e-5 * float(plain.abs().max())


def test_plan_at_the_chm_shapes(emu):
    """At 473 px each call is one band of the whole support plane: CHM4d
    8 x 15 threads of 8 x 4 positions (the last tile row past the plane),
    CHM6d 15 x 8 of 2 x 4 (the last tile column half past it); both fit two
    CTAs an SM. Bands split a plane that 256 threads do not cover."""
    p4 = _emu_plan(emu, 1, 1, 60, 60)
    assert (p4["threads"], p4["band"], p4["bands"]) == (120, 64, 1)
    p6 = _emu_plan(emu, 9, 9, 30, 30)
    assert (p6["threads"], p6["band"], p6["bands"]) == (120, 30, 1)
    assert 2 * max(p4["smem"], p6["smem"]) <= 228 * 1024
    p = _emu_plan(emu, 9, 9, 30, 130)
    assert (p["threads"], p["band"], p["bands"]) == (231, 14, 3)
    p = _emu_plan(emu, 1, 1, 70, 132)
    assert (p["threads"], p["band"], p["bands"]) == (231, 56, 2)
    out = (ctypes.c_longlong * 4)()
    assert emu.fss_hough4d_emulated_plan(2, 2, 6, 6, ctypes.addressof(out)) == -1


@pytest.mark.parametrize("bias", [None, 0.5])
def test_operator_passes_opcheck_on_cpu(bias):
    g = torch.Generator().manual_seed(5)
    x = torch.rand((1, 4, 3, 5, 6, 1), generator=g)
    k = torch.randn((5, 5, 5, 5, 1, 1), generator=g)
    torch.library.opcheck(torch.ops.fss.hough4d,
                          (x, k, None if bias is None else torch.tensor(bias)))


# --------------------------------------------------------------------------- #
# conv4d's dispatch
# --------------------------------------------------------------------------- #


@pytest.fixture
def route_q(monkeypatch):
    taken = []
    real = conv4d_mod.hough4d
    monkeypatch.setattr(conv4d_mod, "hough4d", lambda *a: taken.append(a) or real(*a))
    return taken


@pytest.mark.parametrize("ci,side", [(1, 8), (9, 4)])
@pytest.mark.parametrize("grad", ["off", "no_operand", "x", "kernel", "bias"])
def test_gate_takes_cuda_fp32_calls_autograd_does_not_record(route_q, ci, side, grad):
    """On fake CUDA tensors: the kernel's operator is taken at the two CHM
    instances unless an operand requires grad with grad mode on (there the
    gate alone is asked: autograd cannot run fake CUDA tensors on a build
    without CUDA); a taken call has the kernel's shape and channel-major
    strides, and conv4d_q counts it."""
    with FakeTensorMode():
        x = torch.empty((1, side, side, side, side, ci), device="cuda")
        k = torch.empty((5, 5, 5, 5, ci, ci), device="cuda")
        bias = torch.empty((), device="cuda")
        if grad not in ("off", "no_operand"):
            {"x": x, "kernel": k, "bias": bias}[grad].requires_grad_(True)
            assert not cuda_hough.hough4d_takes(x, k, bias)
            with torch.no_grad():
                assert cuda_hough.hough4d_takes(x, k, bias)
            return
        tracing.reset()
        if grad == "off":
            with torch.no_grad():
                y = conv4d(x, k.requires_grad_(True), bias)
        else:
            y = conv4d(x, k, bias)
    assert tracing.counts()["conv4d_q"] == 1
    assert ops.launch_counts("hough4d") == {"hough4d": 0}   # counted at the launch, on the card
    assert len(route_q) == 1
    assert tuple(y.shape) == (1,) + (side,) * 4 + (ci,)
    assert y.permute(0, 5, 1, 2, 3, 4).is_contiguous()


@pytest.mark.parametrize("case", ["matchnet_cv4", "fp64", "co_2", "kernel_3", "ci_mismatch"])
def test_gate_refuses_other_shapes_and_types(case):
    """MatchNet's ``conv4d cv4`` (3^4, 10 channels), fp64, another (Ci, Co),
    another kernel size and a volume whose channels are not the kernel's
    keep their route, on fake CUDA tensors with autograd off."""
    ci, co, ks, dt, xc = {"matchnet_cv4": (10, 10, 3, torch.float32, 10),
                          "fp64": (9, 9, 5, torch.float64, 9),
                          "co_2": (1, 2, 5, torch.float32, 1),
                          "kernel_3": (1, 1, 3, torch.float32, 1),
                          "ci_mismatch": (1, 1, 5, torch.float32, 9)}[case]
    with FakeTensorMode(), torch.no_grad():
        x = torch.empty((1, 6, 6, 6, 6, xc), device="cuda", dtype=dt)
        k = torch.empty((ks,) * 4 + (ci, co), device="cuda", dtype=dt)
        assert not cuda_hough.hough4d_takes(x, k)


def test_cpu_calls_keep_route_q(route_q):
    """CPU tensors never reach the kernel: conv4d_q counts, nothing launches."""
    x, k = torch.rand((1, 6, 6, 6, 6, 1)), 0.01 * torch.randn((5, 5, 5, 5, 1, 1))
    tracing.reset()
    with torch.no_grad():
        y = conv4d(x, k)
    assert not route_q and not cuda_hough.hough4d_takes(x, k)
    assert tracing.counts()["conv4d_q"] == 1
    assert ops.launch_counts("hough4d") == {"hough4d": 0}
    assert torch.equal(y, _conv4d_q(x, k))


def test_chm_layers_on_the_cpu_launch_nothing_and_count_route_q():
    """CHM6d and CHM4d in evaluation on CPU tensors: two conv4d_q calls, no
    kernel launch, the bias in conv4d's sum as before."""
    from few_shot_seg_cwt_tpu_torch.models.chm import CHM4d

    gen = torch.Generator().manual_seed(8)
    m6, m4 = CHM6d(generator=gen), CHM4d(generator=gen)
    corr = torch.rand((1, 3, 3, 4, 4, 4, 4), generator=gen)
    vol = torch.rand((1, 8, 8, 8, 8, 1), generator=gen)
    tracing.reset()
    with torch.no_grad():
        y6, y4 = m6(corr), m4(vol)
        want6 = _conv4d_q(corr.reshape(1, 9, 4, 4, 4, 4).permute(0, 2, 3, 4, 5, 1),
                          m6.channel_kernel((3, 3))) + m6.bias
        want4 = _conv4d_q(vol, m4.kernel()) + m4.bias
    assert tracing.counts()["conv4d_q"] == 2
    assert ops.launch_counts("hough4d") == {"hough4d": 0}
    assert torch.equal(y6, want6.permute(0, 5, 1, 2, 3, 4).reshape(y6.shape))
    assert torch.equal(y4, want4)


# --------------------------------------------------------------------------- #
# on the card
# --------------------------------------------------------------------------- #


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (the kernel has no CPU mode)")
    from few_shot_seg_cwt_tpu_torch.train.common import fp32_parity

    fp32_parity()
    return torch.device("cuda")


# CHM's two Hough convs at 473 px: (volume, Ci, channel-major)
CHM_SHAPES = {"chm4d": ((1, 60, 60, 60, 60), 1, False), "chm6d": ((1, 30, 30, 30, 30), 9, True)}


@pytest.mark.cuda
@pytest.mark.parametrize("conv", sorted(CHM_SHAPES))
def test_kernel_against_route_q_at_chm_shapes(device, conv):
    """The kernel at the 473 px shapes against route ``q`` in fp64 on the
    same inputs (cuDNN, TF32 off), and route ``q`` in fp32 beside it: the
    kernel within 1e-5 of the scale; two launches give the same bits;
    ``conv4d`` launches it once (readings printed: ``pytest -rP``)."""
    shape, ci, cm = CHM_SHAPES[conv]
    x = _volume(shape, ci, cm, 5).to(device)
    k = _kernel(ci, ci, 6).to(device)
    bias = torch.tensor(0.25, device=device)
    want = _conv4d_q(x.double(), k.double()) + bias.double()
    q32 = _conv4d_q(x, k) + bias
    tracing.reset()
    y = cuda_hough.hough4d(x, k, bias)
    y2 = cuda_hough.hough4d(x, k, bias)
    torch.cuda.synchronize()
    assert ops.launch_counts("hough4d") == {"hough4d": 2}
    scale = float(want.abs().max())
    rel = float((y.double() - want).abs().max()) / scale
    rel_q = float((q32.double() - want).abs().max()) / scale
    print(f"{conv}: hough4d max|y - y64| / max|y64| {rel:.3e}; route q fp32 {rel_q:.3e}")
    assert rel <= 1e-5, rel
    assert torch.equal(y, y2)
    with torch.no_grad():
        y3 = conv4d(x, k, bias)
    torch.cuda.synchronize()
    assert ops.launch_counts("hough4d") == {"hough4d": 3}
    assert torch.equal(y3, y)


@pytest.mark.cuda
def test_dispatch_counts_on_the_card(device, monkeypatch):
    """hough4d launches for CUDA fp32 no-grad calls at the two CHM instances:
    not under grad, not on the CPU, not for MatchNet's Conv4d (3^4, 10
    channels); the JAX package's ``FSS_CONV4D_IM2COL=gemm`` changes
    nothing; conv4d_q counts every call."""
    x1 = _volume((1, 8, 8, 8, 8), 1, False, 7).to(device)
    x9 = _volume((1, 4, 4, 4, 4), 9, True, 7).to(device)
    k1, k9 = _kernel(1, 1, 8).to(device), _kernel(9, 9, 8).to(device)
    tracing.reset()
    with torch.no_grad():
        conv4d(x1, k1)
        conv4d(x9, k9)
    conv4d(x1, k1)                                     # no operand requires grad
    conv4d(x1, k1.clone().requires_grad_(True)).sum().backward()
    conv4d(x1.cpu(), k1.cpu())
    with torch.no_grad():
        Conv4d(10, 10).to(device)(torch.rand((1, 5, 5, 5, 5, 10), device=device))
        monkeypatch.setenv("FSS_CONV4D_IM2COL", "gemm")
        conv4d(x1, k1)
    torch.cuda.synchronize()
    assert tracing.counts()["conv4d_q"] == 7 and tracing.counts()["conv4d_gemm"] == 0
    assert ops.launch_counts("hough4d") == {"hough4d": 4}


@pytest.mark.cuda
def test_kernel_on_odd_and_strided_volumes_on_the_card(device):
    """Odd sides (4-byte copies), a channels-last volume (the wrapper gathers
    its support planes), a vector bias and planes wide enough for bands
    against the plain version within 1e-5 of the scale."""
    lib = cuda_hough.load_library()
    for ci, shape, cm in ((1, (2, 5, 7, 9, 11), False), (9, (1, 3, 5, 7, 6), False),
                          (9, (2, 6, 6, 6, 6), True), (1, (1, 3, 2, 70, 132), False),
                          (9, (1, 2, 3, 30, 130), True)):
        x = _volume(shape, ci, cm, 9).to(device)
        k = _kernel(ci, ci, 10).to(device)
        bias = torch.linspace(-1, 1, ci, device=device)
        got = cuda_hough.launch(lib, x, k, bias)
        want = cuda_hough.hough4d_reference(x, k, bias)
        torch.cuda.synchronize()
        assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max()), shape


@pytest.mark.cuda
def test_operator_passes_opcheck_on_the_card(device):
    g = torch.Generator().manual_seed(11)
    x = torch.rand((1, 4, 3, 5, 6, 9), generator=g).to(device)
    k = _kernel(9, 9, 12).to(device)
    tracing.reset()
    torch.library.opcheck(torch.ops.fss.hough4d, (x, k, torch.tensor(0.1, device=device)))
    assert ops.launch_counts("hough4d")["hough4d"] >= 1
