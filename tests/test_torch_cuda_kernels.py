"""The CUDA kernels against their plain versions, on the card: the
inner-loop kernels (K1, and K2 with several episodes per CTA) and the
centre-pivot conv pair (pivot_fwd, pivot_dw).

Marked ``cuda``: each test skips when no CUDA device is present (decided in
the fixture, not at import). Run them on a machine with an H100 and nvcc:

    python -m pytest tests/test_torch_cuda_kernels.py -q -m cuda

Tolerances: K1 and K2, max|acc_kernel - acc_plain| <= 1e-4 * max|acc_plain|
(fp32; the kernel sums the channel and pixel contractions in another order
than cuBLAS, and 200 steps compound it); K2 against K1 the same (per
episode they do the same arithmetic in the same order). Pivot pair: forward within
1e-5 * max|y_plain|; gradients held against an fp64 run, at most 4x as far
from it as the plain fp32 version plus 2e-6 of the scale (the weight
gradients sum up to 13 M terms, where fp32 order matters).
"""

import numpy as np
import pytest
import torch

from few_shot_seg_cwt_tpu_torch.episodic.inner_loop import (adapt_binary_batch,
                                                            binary_pixel_weights)
from few_shot_seg_cwt_tpu_torch.ops import cuda_inner_loop

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(device, e, shot, h, big, c, seed=0):
    rng = np.random.default_rng(seed)
    f_s = torch.tensor(np.abs(rng.standard_normal((e, shot, h, h, c))).astype(np.float32),
                       device=device)
    label = torch.tensor(rng.integers(0, 2, size=(e, shot, big, big)), device=device)
    label[:, 0, :3] = 255
    pw, pwy = binary_pixel_weights(label)
    u0 = torch.tensor((rng.uniform(-2, 2, (e, c)) / np.sqrt(c)).astype(np.float32),
                      device=device)
    return f_s, pw, pwy, u0


@pytest.mark.parametrize("e,shot,h,big,c,steps", [
    (2, 1, 6, 25, 16, 5),        # small
    (3, 2, 7, 41, 40, 7),        # multi-shot, ragged sizes
    (1, 5, 60, 473, 512, 3),     # 5-shot at full width
    (8, 1, 60, 473, 512, 200),   # the main path
])
def test_kernel_matches_plain(device, e, shot, h, big, c, steps):
    f_s, pw, pwy, u0 = _inputs(device, e, shot, h, big, c)
    before = cuda_inner_loop.LAUNCHES["adapt_binary"]
    acc_k = cuda_inner_loop.adapt_binary(f_s, pw, pwy, u0, steps, 0.1)
    torch.cuda.synchronize()
    assert cuda_inner_loop.LAUNCHES["adapt_binary"] == before + 1
    acc_p = cuda_inner_loop.adapt_binary_reference(f_s, pw, pwy, u0, steps, 0.1)
    err = float((acc_k - acc_p).abs().max())
    assert err <= 1e-4 * float(acc_p.abs().max()), err


@pytest.mark.parametrize("e,h,big,c,steps,tile", [
    (4, 6, 25, 16, 5, 2),        # small
    (6, 7, 41, 40, 7, 3),        # ragged sizes, tile 3
    (8, 6, 25, 16, 5, 4),        # tile 4 where it fits
    (8, 60, 473, 512, 200, 2),   # the train step's batch at tile 2
])
def test_tiled_kernel_matches_plain_and_k1(device, e, h, big, c, steps, tile):
    f_s, pw, pwy, u0 = _inputs(device, e, 1, h, big, c, seed=tile)
    before = dict(cuda_inner_loop.LAUNCHES)
    acc_t = cuda_inner_loop.adapt_binary_tiled(f_s, pw, pwy, u0, steps, 0.1, tile)
    torch.cuda.synchronize()
    assert cuda_inner_loop.LAUNCHES["adapt_binary_tiled"] == before["adapt_binary_tiled"] + 1
    assert cuda_inner_loop.LAUNCHES["adapt_binary"] == before["adapt_binary"]
    acc_p = cuda_inner_loop.adapt_binary_reference(f_s, pw, pwy, u0, steps, 0.1)
    acc_1 = cuda_inner_loop.adapt_binary(f_s, pw, pwy, u0, steps, 0.1)
    scale = float(acc_p.abs().max())
    assert float((acc_t - acc_p).abs().max()) <= 1e-4 * scale
    assert float((acc_t - acc_1).abs().max()) <= 1e-4 * scale


def test_tiled_smem_query_matches_the_dispatch_formula(device):
    """The library's shared-memory query and ``smem_bytes`` (which decides the
    tile without the library) agree; tile 4 does not fit at 473 px and the
    wrapper refuses it."""
    lib = cuda_inner_loop.load_library()
    for h, w, c, big_w in ((6, 6, 16, 25), (7, 9, 40, 41), (60, 60, 512, 473)):
        assert lib.fss_adapt_binary_smem_bytes(h, w, c, big_w) == \
            cuda_inner_loop.smem_bytes(h, w, c, big_w)
        for tile in cuda_inner_loop.TILES:
            assert lib.fss_adapt_binary_tiled_smem_bytes(h, w, c, big_w, tile) == \
                cuda_inner_loop.smem_bytes(h, w, c, big_w, tile)
    f_s, pw, pwy, u0 = _inputs(device, 4, 1, 60, 473, 512)
    with pytest.raises(ValueError, match="shared memory"):
        cuda_inner_loop.adapt_binary_tiled(f_s, pw, pwy, u0, 1, 0.1, 4)


def test_batched_dispatch_under_inner_tile_2_launches_k2(device, monkeypatch):
    monkeypatch.setenv("FSS_INNER_TILE", "2")
    f_s, _, _, _ = _inputs(device, 4, 1, 6, 25, 16)
    label = torch.randint(0, 2, (4, 1, 25, 25), device=device)
    w0 = torch.randn(4, 2, 16, device=device) * 0.1
    before = dict(cuda_inner_loop.LAUNCHES)
    w = adapt_binary_batch(f_s, label, w0, 10, 0.1)
    torch.cuda.synchronize()
    assert cuda_inner_loop.LAUNCHES["adapt_binary_tiled"] == before["adapt_binary_tiled"] + 1
    assert cuda_inner_loop.LAUNCHES["adapt_binary"] == before["adapt_binary"]
    w_cpu = adapt_binary_batch(f_s.cpu(), label.cpu(), w0.cpu(), 10, 0.1)
    torch.testing.assert_close(w.cpu(), w_cpu, rtol=1e-4, atol=1e-6)


def test_batched_dispatch_on_cuda_goes_through_the_kernel(device):
    f_s, pw, _, _ = _inputs(device, 2, 1, 6, 25, 16)
    label = torch.randint(0, 2, (2, 1, 25, 25), device=device)
    w0 = torch.randn(2, 2, 16, device=device) * 0.1
    before = cuda_inner_loop.LAUNCHES["adapt_binary"]
    w = adapt_binary_batch(f_s, label, w0, 10, 0.1)
    assert cuda_inner_loop.LAUNCHES["adapt_binary"] == before + 1
    w_cpu = adapt_binary_batch(f_s.cpu(), label.cpu(), w0.cpu(), 10, 0.1)
    torch.testing.assert_close(w.cpu(), w_cpu, rtol=1e-4, atol=1e-6)


def test_kernel_rejects_mixed_devices(device):
    f_s, pw, pwy, u0 = _inputs(device, 1, 1, 6, 25, 16)
    with pytest.raises(ValueError):
        cuda_inner_loop.adapt_binary(f_s, pw.cpu(), pwy, u0, 2, 0.1)


def test_phase_clock_build_matches_and_counts(device):
    """The instrumented build gives the same acc bit for bit and non-zero
    cycles in every phase."""
    import ctypes

    from few_shot_seg_cwt_tpu_torch.tools.profile_inner_loop import PHASE_DEFINES, PHASES

    f_s, pw, pwy, u0 = _inputs(device, 2, 1, 6, 25, 16)
    lib = cuda_inner_loop.load_library(PHASE_DEFINES)
    lib.fss_phase_cycles.argtypes = [np.ctypeslib.ndpointer(np.uint64)]
    lib.fss_phase_cycles.restype = ctypes.c_int
    cycles = np.zeros(len(PHASES), dtype=np.uint64)
    assert lib.fss_phase_cycles(cycles) == 0
    acc_clock = cuda_inner_loop.launch(lib, f_s, pw, pwy, u0, 5, 0.1)
    acc = cuda_inner_loop.adapt_binary(f_s, pw, pwy, u0, 5, 0.1)
    torch.cuda.synchronize()
    assert torch.equal(acc, acc_clock)
    assert lib.fss_phase_cycles(cycles) == 0
    assert (cycles > 0).all(), cycles


# --------------------------------------------------------------------------- #
# centre-pivot conv kernels (pivot_fwd, pivot_dw)
# --------------------------------------------------------------------------- #


def _pivot_inputs(device, b, ci, co, dims, seed=0):
    rng = np.random.default_rng(seed)
    hq, wq, hs, ws = dims
    x = rng.standard_normal((b, ci, hq * wq, hs * ws)).astype(np.float32)
    w = (rng.standard_normal((2, 3, 3, ci, co)) / np.sqrt(18 * ci)).astype(np.float32)
    bias = rng.standard_normal((co,)).astype(np.float32)
    t = rng.standard_normal((b, co, hq * wq, hs * ws)).astype(np.float32)
    return [torch.tensor(a, device=device) for a in (x, w[0], w[1], bias, t)]


def _pivot_grads(fn, x, wa, wb, bias, t, dims, relu, dtype=torch.float32):
    leaves = [a.to(dtype).clone().requires_grad_(True) for a in (x, wa, wb, bias)]
    y = fn(*leaves, dims, relu=relu)
    (y * t.to(dtype)).sum().backward()
    return y.detach(), [a.grad for a in leaves]


@pytest.mark.parametrize("b,ci,co,dims", [
    (2, 3, 4, (5, 6, 4, 7)),        # small, every plane edge distinct
    (1, 10, 1, (9, 11, 13, 7)),     # Co = 1, ragged support tiles
    (1, 2, 10, (60, 60, 60, 60)),   # main-path blocks at 473 px
    (1, 10, 10, (60, 60, 60, 60)),
    (1, 10, 1, (60, 60, 60, 60)),
])
@pytest.mark.parametrize("relu", [True, False])
def test_pivot_kernels_match_plain(device, b, ci, co, dims, relu):
    """Forward within 1e-5 * max|y| of the plain version. With the ReLU off,
    dx and (dwa, dwb, db) no farther from an fp64 run than 4x the plain fp32
    version's distance plus 2e-6 of the scale (dx sums at most 180 products
    in one fp32 chain, good to ~1e-6 relative; cuDNN's tree sums can be
    closer).
    With it on, the few outputs within rounding of 0 are masked differently
    in fp32 and fp64 and move a gradient by a whole |t|: the gradients are
    then held against the plain fp32 ones with the same mask."""
    from few_shot_seg_cwt_tpu_torch.ops import cuda_pivot

    torch.backends.cudnn.allow_tf32 = False
    x, wa, wb, bias, t = _pivot_inputs(device, b, ci, co, dims)
    before = dict(cuda_pivot.LAUNCHES)
    y_k, g_k = _pivot_grads(cuda_pivot.pivot_conv_flat, x, wa, wb, bias, t, dims, relu)
    torch.cuda.synchronize()
    assert cuda_pivot.LAUNCHES["pivot_fwd"] == before["pivot_fwd"] + 2   # y and dx
    assert cuda_pivot.LAUNCHES["pivot_dw"] == before["pivot_dw"] + 1
    ref = cuda_pivot.pivot_conv_flat_reference
    y_p, g_p = _pivot_grads(ref, x, wa, wb, bias, t, dims, relu)
    assert float((y_k - y_p).abs().max()) <= 1e-5 * float(y_p.abs().max())
    if relu:
        # the plain version's gradient under the kernel's own mask
        mask_t = t * (y_k > 0)
        _, g_m = _pivot_grads(ref, x, wa, wb, bias, mask_t, dims, False)
        for name, k, p in zip(("dx", "dwa", "dwb", "db"), g_k, g_m):
            assert float((k - p).abs().max()) <= 1e-4 * float(p.abs().max()), name
        return
    _, g_64 = _pivot_grads(ref, x, wa, wb, bias, t, dims, False, torch.float64)
    for name, k, p, w in zip(("dx", "dwa", "dwb", "db"), g_k, g_p, g_64):
        err_k = float((k.double() - w).abs().max())
        err_p = float((p.double() - w).abs().max())
        assert err_k <= 4 * err_p + 2e-6 * float(w.abs().max()), (name, err_k, err_p)


def test_pivot_wrappers_refuse_what_the_kernels_do_not_take(device):
    from few_shot_seg_cwt_tpu_torch.ops import cuda_pivot

    dims = (5, 6, 4, 7)
    x, wa, wb, bias, t = _pivot_inputs(device, 1, 3, 4, dims)
    with pytest.raises(TypeError):
        cuda_pivot.pivot_fwd(x.double(), wa, wb, bias, dims)
    with pytest.raises(ValueError):
        cuda_pivot.pivot_fwd(x.transpose(2, 3).contiguous().transpose(2, 3), wa, wb, bias,
                             dims)                                       # not contiguous
    with pytest.raises(ValueError):
        cuda_pivot.pivot_fwd(x, wa, wb, bias, (5, 6, 4, 8))              # wrong planes
    with pytest.raises(ValueError):
        cuda_pivot.pivot_fwd(x, wa.cpu(), wb, bias, dims)                # mixed devices
    w11 = torch.zeros((3, 3, 3, 11), device=device)
    with pytest.raises(ValueError):
        cuda_pivot.pivot_fwd(x, w11, w11, torch.zeros(11, device=device), dims)
    with pytest.raises(ValueError):
        cuda_pivot.pivot_dw(x, t[:, :, :, :-1].contiguous(), dims)


def test_flat_route_on_cuda_launches_the_pivot_kernels(device, monkeypatch):
    """NeighConsensus on the flat route: 6 forward launches per symmetric
    3-block stack, and its backward runs pivot_dw for every block."""
    from few_shot_seg_cwt_tpu_torch.models.matching import NeighConsensus
    from few_shot_seg_cwt_tpu_torch.ops import cuda_pivot

    monkeypatch.setenv("FSS_PIVOT_MXU", "1")
    dims = (7, 8, 6, 9)
    net = NeighConsensus(in_channel=2, block_remat=False).to(device)
    x = torch.randn((1, 2, 56, 54), device=device)
    before = dict(cuda_pivot.LAUNCHES)
    net(x, flat_dims=dims).sum().backward()
    torch.cuda.synchronize()
    # dx of every block but each stack's first (its input needs no grad)
    assert cuda_pivot.LAUNCHES["pivot_fwd"] - before["pivot_fwd"] == 6 + 4
    assert cuda_pivot.LAUNCHES["pivot_dw"] - before["pivot_dw"] == 6
