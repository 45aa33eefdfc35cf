"""The CUDA kernels against their plain versions, on the card: the
inner-loop kernels (K1, and K2 with several episodes per CTA) and the
centre-pivot conv pair (pivot_fwd, pivot_dw).

Marked ``cuda``: each test skips when no CUDA device is present (decided in
the fixture, not at import). Run them on a machine with an H100 and nvcc:

    python -m pytest tests/test_torch_cuda_kernels.py -q -m cuda

Tolerances: K1 and K2, max|acc_kernel - acc_plain| <= 1e-4 * max|acc_plain|
(fp32; the kernel sums the channel and pixel contractions in another order
than cuBLAS, and 200 steps compound it). K2 against K1, K1 at E against K1
at 1, and two launches: equal bits (each element has one formula and every
sum a fixed order whatever the partition). Pivot pair: forward within
1e-5 * max|y_plain|; gradients held against an fp64 run, at most 4x as far
from it as the plain fp32 version plus 2e-6 of the scale (the weight
gradients sum up to 13 M terms, where fp32 order matters; pivot_dw does
its products on the tensor cores in 3xTF32 form). pivot_dw and pivot_fwd:
two launches give equal bits, and the shapes their tiling and staging can
get wrong are held too.
"""

import itertools

import numpy as np
import pytest
import torch

from few_shot_seg_cwt_tpu_torch.episodic.inner_loop import (adapt_binary_batch,
                                                            binary_pixel_weights)
from few_shot_seg_cwt_tpu_torch.ops import cuda_inner_loop, launch_counts
from few_shot_seg_cwt_tpu_torch.utils import tracing

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


def _k1_against_plain(f_s, pw, pwy, u0, steps):
    before = tracing.counts()["adapt_binary"]
    acc_k = cuda_inner_loop.adapt_binary(f_s, pw, pwy, u0, steps, 0.1)
    torch.cuda.synchronize()
    assert tracing.counts()["adapt_binary"] == before + 1
    acc_p = cuda_inner_loop.adapt_binary_reference(f_s, pw, pwy, u0, steps, 0.1)
    err = float((acc_k - acc_p).abs().max())
    assert err <= 1e-4 * float(acc_p.abs().max()), err
    return acc_k


@pytest.mark.parametrize("e,shot,h,big,c,steps", [
    (2, 1, 6, 25, 16, 5),        # small
    (3, 2, 7, 41, 40, 7),        # multi-shot, ragged sizes
    (2, 1, 5, 33, 16, 30),       # 33 px from 5x5 features (exact samples: one tap)
    (2, 2, 53, 417, 512, 20),    # 417 px from 53x53
] + [(e, shot, 60, 473, 512, 200 if (e, shot) == (8, 1) else 20)
     for e in (1, 2, 3, 4, 8) for shot in (1, 2, 5)])
def test_kernel_matches_plain(device, e, shot, h, big, c, steps):
    _k1_against_plain(*_inputs(device, e, shot, h, big, c), steps)


def test_padded_shots_leave_k1_unchanged(device):
    """5-shot episodes whose last three shots are all 255 give the 2-shot
    result (their pixel weights are 0)."""
    f_s, _, _, u0 = _inputs(device, 2, 5, 60, 473, 512, seed=5)
    rng = np.random.default_rng(6)
    label = torch.tensor(rng.integers(0, 2, size=(2, 5, 473, 473)), device=device)
    label[:, 2:] = 255
    pw, pwy = binary_pixel_weights(label)
    acc5 = _k1_against_plain(f_s, pw, pwy, u0, 20)
    pw2, pwy2 = binary_pixel_weights(label[:, :2].contiguous())
    acc2 = cuda_inner_loop.adapt_binary(f_s[:, :2].contiguous(), pw2, pwy2, u0, 20, 0.1)
    assert float((acc5 - acc2).abs().max()) <= 1e-4 * float(acc2.abs().max())


def test_k1_gives_the_same_bits_every_launch_and_for_every_batch(device):
    """Two launches give equal bits, and an episode's acc does not depend on
    the batch it runs in (E = 8 spreads each over 16 CTAs, E = 1 over 60)."""
    f_s, pw, pwy, u0 = _inputs(device, 8, 1, 60, 473, 512, seed=11)
    a = cuda_inner_loop.adapt_binary(f_s, pw, pwy, u0, 200, 0.1)
    b = cuda_inner_loop.adapt_binary(f_s, pw, pwy, u0, 200, 0.1)
    one = cuda_inner_loop.adapt_binary(f_s[2:3].contiguous(), pw[2:3].contiguous(),
                                       pwy[2:3].contiguous(), u0[2:3].contiguous(), 200, 0.1)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    assert torch.equal(a[2:3], one)


def test_k1_spreads_an_episode_over_many_ctas(device):
    lib = cuda_inner_loop.load_library()
    for e, per in ((1, 60), (2, 60), (4, 33), (8, 16)):
        plan = cuda_inner_loop.card_plan(lib, (e, 1, 60, 60, 512), 473, 473, 1, device)
        assert plan.blocks_per_sm >= 1
        assert plan.ctas_per_group == min(60, plan.sms // e)
        assert plan.ctas_per_group > 1
        if plan.sms == 132:
            assert plan.ctas_per_group == per


@pytest.mark.parametrize("e,h,big,c,steps,tile", [
    (4, 6, 25, 16, 5, 2),        # small
    (6, 7, 41, 40, 7, 3),        # ragged sizes, tile 3
    (8, 6, 25, 16, 5, 4),        # tile 4, small
    (8, 60, 473, 512, 200, 2),   # the train step's batch at tile 2
    (6, 60, 473, 512, 20, 3),    # tile 3 at 473 px
    (8, 60, 473, 512, 200, 4),   # tile 4 at 473 px (it fits the block now)
])
def test_tiled_kernel_matches_plain_and_k1(device, e, h, big, c, steps, tile):
    f_s, pw, pwy, u0 = _inputs(device, e, 1, h, big, c, seed=tile)
    before = tracing.counts()
    acc_t = cuda_inner_loop.adapt_binary_tiled(f_s, pw, pwy, u0, steps, 0.1, tile)
    torch.cuda.synchronize()
    assert tracing.counts()["adapt_binary_tiled"] == before["adapt_binary_tiled"] + 1
    assert tracing.counts()["adapt_binary"] == before["adapt_binary"]
    acc_p = cuda_inner_loop.adapt_binary_reference(f_s, pw, pwy, u0, steps, 0.1)
    acc_1 = cuda_inner_loop.adapt_binary(f_s, pw, pwy, u0, steps, 0.1)
    scale = float(acc_p.abs().max())
    assert float((acc_t - acc_p).abs().max()) <= 1e-4 * scale
    assert torch.equal(acc_t, acc_1)


def test_tiled_smem_query_matches_the_dispatch_formula(device):
    """The library's shared-memory query and ``smem_bytes`` (which decides the
    tile and the plan without the library) agree, for the layouts the plans
    use and others (a slice pinned whole among them); every tile's plan fits
    at 473 px."""
    lib = cuda_inner_loop.load_library()
    for h, w, c, big_h, big_w in ((6, 6, 16, 25, 25), (7, 9, 40, 41, 37), (60, 60, 512, 473, 473),
                                  (53, 53, 512, 417, 417)):
        for tile in (1, *cuda_inner_loop.TILES):
            for shot, rows, pin in ((1, 1, 0), (1, 4, 87), (5 if tile == 1 else 1, 2, 3),
                                    (1, 2, 2 * w)):
                assert lib.fss_adapt_binary_smem_bytes(h, w, c, big_h, big_w, shot, tile, rows,
                                                       pin) == \
                    cuda_inner_loop.smem_bytes(h, w, c, big_w, tile, big_h=big_h, shot=shot,
                                               rows=rows, pin=pin)
    for tile in (1, *cuda_inner_loop.TILES):
        e = 12
        plan = cuda_inner_loop.card_plan(lib, (e, 1, 60, 60, 512), 473, 473, tile, device)
        assert plan.smem <= cuda_inner_loop.MAX_SMEM_BYTES
        assert plan.grid <= plan.sms * plan.blocks_per_sm


def test_a_grid_the_card_cannot_hold_raises(device):
    """A plan whose grid exceeds what the card holds at once is refused by
    the cooperative launch, and the wrapper raises; no other body runs."""
    from few_shot_seg_cwt_tpu_torch.ops.inner_loop_plan import work_plan

    lib = cuda_inner_loop.load_library()
    f_s, pw, pwy, u0 = _inputs(device, 8, 1, 60, 473, 512)
    plan = cuda_inner_loop.card_plan(lib, tuple(f_s.shape), 473, 473, 1, device)
    big = work_plan(8, 1, 60, 60, 512, 473, 473, 1, 8 * plan.sms * plan.blocks_per_sm)
    assert big.grid > plan.sms * plan.blocks_per_sm
    before = tracing.counts()
    with pytest.raises(RuntimeError, match="launch failed"):
        cuda_inner_loop.launch(lib, f_s, pw, pwy, u0, 2, 0.1, 1, big)
    assert tracing.counts() == before
    with pytest.raises(ValueError, match="multiple of 4"):
        cuda_inner_loop.adapt_binary(f_s[..., :6].contiguous(), pw, pwy,
                                     u0[:, :6].contiguous(), 2, 0.1)


def test_batched_dispatch_under_inner_tile_2_launches_k2(device, monkeypatch):
    monkeypatch.setenv("FSS_INNER_TILE", "2")
    f_s, _, _, _ = _inputs(device, 4, 1, 6, 25, 16)
    label = torch.randint(0, 2, (4, 1, 25, 25), device=device)
    w0 = torch.randn(4, 2, 16, device=device) * 0.1
    before = tracing.counts()
    w = adapt_binary_batch(f_s, label, w0, 10, 0.1)
    torch.cuda.synchronize()
    assert tracing.counts()["adapt_binary_tiled"] == before["adapt_binary_tiled"] + 1
    assert tracing.counts()["adapt_binary"] == before["adapt_binary"]
    w_cpu = adapt_binary_batch(f_s.cpu(), label.cpu(), w0.cpu(), 10, 0.1)
    torch.testing.assert_close(w.cpu(), w_cpu, rtol=1e-4, atol=1e-6)


def test_batched_dispatch_on_cuda_goes_through_the_kernel(device):
    f_s, pw, _, _ = _inputs(device, 2, 1, 6, 25, 16)
    label = torch.randint(0, 2, (2, 1, 25, 25), device=device)
    w0 = torch.randn(2, 2, 16, device=device) * 0.1
    before = tracing.counts()["adapt_binary"]
    w = adapt_binary_batch(f_s, label, w0, 10, 0.1)
    assert tracing.counts()["adapt_binary"] == before + 1
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
    assert (cycles > 0).all(), cycles   # the barrier waits included


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
    # shapes pivot_dw's tiling (2 support rows a step, K padded to 8) can get wrong
    (1, 3, 4, (4, 5, 5, 60)),       # ws = 60, odd hs
    (1, 3, 4, (3, 4, 3, 10)),       # ws not a multiple of 8, odd hs
    (1, 3, 4, (5, 6, 1, 9)),        # hs = 1
    (1, 3, 4, (5, 1, 4, 7)),        # wq = 1
    (1, 3, 4, (1, 6, 4, 7)),        # hq = 1
    (1, 1, 4, (5, 6, 4, 7)),        # Ci = 1
    (2, 2, 3, (4, 3, 5, 13)),       # B = 2, odd everything
    # shapes pivot_fwd's staging and persistent grid can get wrong
    (2, 10, 10, (60, 60, 60, 60)),  # a batch wider than one at full size
    (3, 3, 4, (4, 5, 6, 13)),       # ws % 4 != 0 (rows copied by the threads), B > 1
    (1, 1, 10, (5, 7, 6, 11)),      # Ci = 1, Co = 10, ragged
    (2, 1, 10, (9, 11, 13, 7)),     # Ci = 1 -> 10 (the match head's first block), B = 2
    (1, 1, 10, (16, 16, 16, 16)),   # Ci = 1 -> 10, whole 8-wide support tiles
    # shapes pivot_dw's pipeline can get wrong (its ring of column slots and
    # g slots, filled by a producer warp, split and read by other warps)
    (1, 3, 4, (20, 30, 20, 8)),     # ~14 steps a CTA: not a multiple of the ring's depth
    (2, 3, 4, (12, 16, 10, 12)),    # B = 2: CTAs' runs cross from one episode to the next
    (1, 10, 10, (7, 60, 9, 60)),    # 473 px's 10->10 layout: runs restart at qj = 0
    (1, 10, 1, (30, 17, 11, 20)),   # the rest split mid-run; ws a multiple of 4, not 8
    (2, 2, 10, (9, 13, 21, 6)),     # ragged ws: the producer's lanes copy, no TMA
] + [(1, 2, co, (3, 4, 3, 9)) for co in range(1, 11)])   # every Co
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
    before = tracing.counts()
    y_k, g_k = _pivot_grads(cuda_pivot.pivot_fwd, x, wa, wb, bias, t, dims, relu)
    torch.cuda.synchronize()
    assert tracing.counts()["pivot_fwd"] == before["pivot_fwd"] + 2   # y and dx
    assert tracing.counts()["pivot_dw"] == before["pivot_dw"] + 1
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


@pytest.mark.parametrize("b,ci,co,dims", [
    (1, 10, 10, (60, 60, 60, 60)),  # 473 px 10->10
    (1, 2, 10, (60, 60, 60, 60)),   # 8 support rows a step
    (2, 10, 1, (60, 60, 60, 60)),   # B = 2, five column slots
    (1, 3, 4, (5, 6, 4, 7)),        # the producer's lanes copy
])
def test_pivot_dw_gives_the_same_bits_every_launch(device, b, ci, co, dims):
    """No atomics: a fixed grid, fixed work per CTA and fixed summation
    orders give equal bits from launch to launch."""
    from few_shot_seg_cwt_tpu_torch.ops import cuda_pivot

    x, _, _, _, t = _pivot_inputs(device, b, ci, co, dims, seed=3)
    first = cuda_pivot.pivot_dw(x, t, dims)
    second = cuda_pivot.pivot_dw(x, t, dims)
    torch.cuda.synchronize()
    for one, two in zip(first, second):
        assert torch.equal(one, two)


@pytest.mark.parametrize("ci", [1, 2, 10, 42])
@pytest.mark.parametrize("co", range(1, 11))
def test_pivot_dw_matches_plain_at_every_ci_and_co(device, ci, co):
    """pivot_dw alone (the forward's dx takes at most 10 output channels, so
    Ci = 42 has no place in the pair's test) against an fp64 run, under the
    pair's gradient limit: 4x the plain fp32 version's distance plus 2e-6
    of the scale. Every layout the plan gives these widths at ws = 8."""
    from few_shot_seg_cwt_tpu_torch.ops import cuda_pivot

    torch.backends.cudnn.allow_tf32 = False
    dims = (6, 7, 5, 8)
    x, _, _, _, t = _pivot_inputs(device, 1, ci, co, dims, seed=ci * 10 + co)
    before = tracing.counts()["pivot_dw"]
    got = cuda_pivot.pivot_dw(x, t, dims)
    torch.cuda.synchronize()
    assert tracing.counts()["pivot_dw"] == before + 1
    plain = cuda_pivot.pivot_dw_reference(x, t, dims)
    wide = cuda_pivot.pivot_dw_reference(x.double(), t.double(), dims)
    for name, k, p, w in zip(("dwa", "dwb", "db"), got, plain, wide):
        err_k = float((k.double() - w).abs().max())
        err_p = float((p.double() - w).abs().max())
        assert err_k <= 4 * err_p + 2e-6 * float(w.abs().max()), (name, err_k, err_p)


def test_pivot_fwd_gives_the_same_bits_every_launch(device):
    """No atomics, a fixed grid and one fmaf chain per output: two launches
    give equal bits, at 10->10 (P = 2) and 1->10 (one channel)."""
    from few_shot_seg_cwt_tpu_torch.ops import cuda_pivot

    dims = (60, 60, 60, 60)
    for ci, co in ((10, 10), (1, 10)):
        x, wa, wb, bias, _ = _pivot_inputs(device, 1, ci, co, dims, seed=5)
        first = cuda_pivot.pivot_fwd(x, wa, wb, bias, dims, True)
        second = cuda_pivot.pivot_fwd(x, wa, wb, bias, dims, True)
        torch.cuda.synchronize()
        assert torch.equal(first, second)


def test_pivot_dw_smem_query_agrees_with_the_wrappers_refusal(device):
    """The library's shared-memory query decides: a shape over a block's
    shared memory is refused before launch, one under it runs. The query
    fills a block with as deep a layout as fits, so it is over only where
    one support row a step does not fit; Ci over the library's limit is
    refused too."""
    from few_shot_seg_cwt_tpu_torch.ops import cuda_pivot

    lib = cuda_pivot.load_library()
    seen = set()
    for ci, co, ws in ((10, 10, 60), (10, 10, 200), (10, 10, 230), (2, 10, 500),
                       (10, 1, 1000), (21, 1, 60)):
        dims = (1, 1, 1, ws)
        smem = lib.fss_pivot_dw_smem_bytes(ci, co, ws)
        x, _, _, _, t = _pivot_inputs(device, 1, ci, co, dims)
        over = smem > cuda_pivot.MAX_SMEM_BYTES
        seen.add(over)
        before = tracing.counts()["pivot_dw"]
        if over:
            with pytest.raises(ValueError, match="shared memory"):
                cuda_pivot.pivot_dw(x, t, dims)
            assert tracing.counts()["pivot_dw"] == before
        else:
            got = cuda_pivot.pivot_dw(x, t, dims)
            want = cuda_pivot.pivot_dw_reference(x, t, dims)
            for a, b in zip(got, want):
                assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max()) + 1e-6
            assert tracing.counts()["pivot_dw"] == before + 1
    assert seen == {True, False}
    assert (lib.fss_pivot_dw_smem_bytes(10, 10, 60) <= cuda_pivot.MAX_SMEM_BYTES
            < lib.fss_pivot_dw_smem_bytes(10, 1, 1000))
    ci = lib.fss_pivot_dw_max_ci() + 1
    x, _, _, _, t = _pivot_inputs(device, 1, ci, 1, (1, 1, 1, 8))
    with pytest.raises(ValueError, match="input"):
        cuda_pivot.pivot_dw(x, t, (1, 1, 1, 8))


def test_pivot_wrappers_refuse_what_the_kernels_do_not_take(device):
    from few_shot_seg_cwt_tpu_torch.ops import cuda_pivot

    dims = (5, 6, 4, 7)
    x, wa, wb, bias, t = _pivot_inputs(device, 1, 3, 4, dims)
    with pytest.raises(TypeError):
        cuda_pivot.pivot_fwd(x.double(), wa, wb, bias, dims)
    # a strided x is made contiguous before the operator, not refused
    strided = x.transpose(2, 3).contiguous().transpose(2, 3)
    assert torch.equal(cuda_pivot.pivot_fwd(strided, wa, wb, bias, dims),
                       cuda_pivot.pivot_fwd(x, wa, wb, bias, dims))
    with pytest.raises(ValueError):
        cuda_pivot.pivot_fwd(x, wa, wb, bias, (5, 6, 4, 8))              # wrong planes
    with pytest.raises(ValueError):
        cuda_pivot.pivot_fwd(x, wa.cpu(), wb, bias, dims)                # mixed devices
    w11 = torch.zeros((3, 3, 3, 11), device=device)
    with pytest.raises(ValueError):
        cuda_pivot.pivot_fwd(x, w11, w11, torch.zeros(11, device=device), dims)
    with pytest.raises(ValueError):
        cuda_pivot.pivot_dw(x, t[:, :, :, :-1].contiguous(), dims)
    # the forward's staging: one support row of Ci = 46 channels at ws = 60
    # is over a block's shared memory; Ci = 45 fits and runs
    lib = cuda_pivot.load_library()
    for ci, over in ((46, True), (45, False)):
        small = (1, 2, 1, 60)
        assert (lib.fss_pivot_fwd_smem_bytes(ci, 4, 1, 60) > cuda_pivot.MAX_SMEM_BYTES) == over
        x, wa, wb, bias, _ = _pivot_inputs(device, 1, ci, 4, small)
        before = tracing.counts()["pivot_fwd"]
        if over:
            with pytest.raises(ValueError, match="shared memory"):
                cuda_pivot.pivot_fwd(x, wa, wb, bias, small)
            assert tracing.counts()["pivot_fwd"] == before
        else:
            y = cuda_pivot.pivot_fwd(x, wa, wb, bias, small)
            want = cuda_pivot.pivot_conv_flat_reference(x, wa, wb, bias, small)
            assert float((y - want).abs().max()) <= 1e-5 * float(want.abs().max())
            assert tracing.counts()["pivot_fwd"] == before + 1


def test_flat_route_on_cuda_launches_the_pivot_kernels(device):
    """NeighConsensus on the flat route: 6 forward launches per symmetric
    3-block stack, and its backward runs pivot_dw for every block."""
    from few_shot_seg_cwt_tpu_torch.models.matching import NeighConsensus

    dims = (7, 8, 6, 9)
    net = NeighConsensus(in_channel=2, block_remat=False).to(device)
    x = torch.randn((1, 2, 56, 54), device=device)
    before = tracing.counts()
    net(x, flat_dims=dims).sum().backward()
    torch.cuda.synchronize()
    # dx of every block but each stack's first (its input needs no grad)
    assert tracing.counts()["pivot_fwd"] - before["pivot_fwd"] == 6 + 4
    assert tracing.counts()["pivot_dw"] - before["pivot_dw"] == 6


def test_match_consensus_at_ci_1_on_the_flat_route(device):
    """The match head's stack (1 -> 10 -> 10 -> 1, symmetric) on the flat
    route against the rank-4 layout's cuDNN plane convs on the card:
    forward within 1e-5 of the scale, weight gradients within 1e-3 of each
    tensor's largest entry; pivot_dw runs at Ci = 1 for each stack's first
    block."""
    from few_shot_seg_cwt_tpu_torch.models.matching import NeighConsensus

    torch.backends.cudnn.allow_tf32 = False
    dims = (9, 10, 8, 11)
    torch.manual_seed(0)
    net = NeighConsensus(in_channel=1, block_remat=False).to(device)
    with torch.no_grad():
        for blk in list(net.conv)[::2]:
            blk.conv1.bias.uniform_(0.0, 0.2)
    x = torch.rand((2, 1, 90, 88), device=device)
    outs, grads = [], []
    for flat in (True, False):
        net.zero_grad()
        before = tracing.counts()
        y = (net(x, flat_dims=dims) if flat
             else net.bqsc(x.permute(0, 2, 3, 1), dims).permute(0, 3, 1, 2))
        (y * y).sum().backward()
        torch.cuda.synchronize()
        launched = tracing.counts()["pivot_dw"] - before["pivot_dw"]
        assert launched == (6 if flat else 0)
        outs.append(y.detach())
        grads.append({k: p.grad.clone() for k, p in net.named_parameters()})
    assert float(outs[1].abs().max()) > 0
    assert float((outs[0] - outs[1]).abs().max()) <= 1e-5 * float(outs[1].abs().max())
    for k, g in grads[1].items():
        assert float((grads[0][k] - g).abs().max()) <= 1e-3 * float(g.abs().max()), k


def _conv4d_taps(x, kernel, bias):
    """The 4D conv as a sum over its taps of the zero-padded volume shifted
    by the tap, times the tap's (Ci, Co) matrix (odd kernels)."""
    b, h, w, hs, ws, _ = x.shape
    k0, k1, k2, k3 = kernel.shape[:4]
    xp = torch.nn.functional.pad(x, (0, 0, k3 // 2, k3 // 2, k2 // 2, k2 // 2,
                                     k1 // 2, k1 // 2, k0 // 2, k0 // 2))
    out = bias
    for i, j, m, n in itertools.product(range(k0), range(k1), range(k2), range(k3)):
        out = out + xp[:, i:i + h, j:j + w, m:m + hs, n:n + ws] @ kernel[i, j, m, n]
    return out


def test_conv4d_on_the_card(device):
    """The true 4D conv (route q: cuDNN calls) against its sum over the taps
    on the CPU in fp64: forward and gradients within 1e-5 of the scale."""
    from few_shot_seg_cwt_tpu_torch.models.conv4d import Conv4d

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.manual_seed(1)
    conv = Conv4d(3, 4)
    x = torch.randn(2, 5, 6, 4, 7, 3)
    xr = x.double().requires_grad_(True)
    wr = conv.weight.detach().double().requires_grad_(True)
    y_ref = _conv4d_taps(xr, wr.permute(0, 3, 4, 5, 2, 1), conv.bias.detach().double())
    y_ref.sum().backward()
    want = [y_ref.detach(), xr.grad, wr.grad]
    dev = conv.to(device)
    xd = x.to(device).requires_grad_(True)
    y = dev(xd)
    y.sum().backward()
    for got, w in zip((y.detach(), xd.grad, dev.weight.grad), want):
        assert float((got.double().cpu() - w).abs().max()) <= 1e-5 * float(w.abs().max())


# CHM's two true 4D convs at 473 px: (volume, kernel) shapes
CHM_CONVS = {"chm6d": ((1, 30, 30, 30, 30, 9), (5, 5, 5, 5, 9, 9)),
             "chm4d": ((1, 60, 60, 60, 60, 1), (5, 5, 5, 5, 1, 1))}
_CHM_FP64 = {}


def _chm_conv_fp64(conv, device):
    """The inputs of one CHM conv (uniform volume, N(0, 0.02) kernel, N(0, 1)
    upstream gradient) and conv4d's output and gradients on them in fp64,
    on the card; computed once a session."""
    from few_shot_seg_cwt_tpu_torch.models.conv4d import conv4d

    if conv not in _CHM_FP64:
        g = torch.Generator().manual_seed(5)
        xs, ks = CHM_CONVS[conv]
        x = torch.rand(xs, generator=g, dtype=torch.float64).to(device).requires_grad_(True)
        k = (0.02 * torch.randn(ks, generator=g, dtype=torch.float64)).to(device)
        k.requires_grad_(True)
        gy = torch.randn(xs[:5] + ks[-1:], generator=g, dtype=torch.float64).to(device)
        y = conv4d(x, k)
        y.backward(gy)
        _CHM_FP64[conv] = ((x.detach(), k.detach(), gy), (y.detach(), x.grad, k.grad))
    return _CHM_FP64[conv]


@pytest.mark.parametrize("conv", sorted(CHM_CONVS))
def test_conv4d_at_chm_shapes_against_fp64(device, conv):
    """The true 4D conv in fp32 under autograd (route q's cuDNN calls) at
    the CHM head's 473 px shapes against itself in fp64 on the same inputs:
    output, input gradient and kernel gradient within 1e-4 of the scale
    (the readings are printed: ``pytest -rP``)."""
    from few_shot_seg_cwt_tpu_torch.models.conv4d import conv4d
    from few_shot_seg_cwt_tpu_torch.train.common import fp32_parity

    fp32_parity()
    (x64, k64, gy64), want = _chm_conv_fp64(conv, device)
    x = x64.float().requires_grad_(True)
    k = k64.float().requires_grad_(True)
    y = conv4d(x, k)
    y.backward(gy64.float())
    rel = {name: float((got.double() - w).abs().max() / w.abs().max())
           for name, got, w in zip(("y", "dx", "dk"), (y.detach(), x.grad, k.grad), want)}
    print(f"{conv}: max|v - v64| / max|v64| {rel}")
    assert max(rel.values()) <= 1e-4, rel


@pytest.mark.parametrize("head", ["chm", "detr"])
def test_chm_and_detr_eval_on_the_card_match_the_cpu_port(device, head):
    """The CHM head (41 px: CHM needs an even feature side) and the DeTr head
    (33 px) on the card against the same engine's weights on the CPU:
    predictions within 1e-2 (atol 2e-3 of the logit scale) with >= 99.5%
    argmax agreement; K1 runs the inner loop, and DeTr's consensus runs
    pivot_fwd (3 blocks x 2 directions an episode)."""
    import copy

    from few_shot_seg_cwt_tpu_torch.config import load_cfg, merge_cfg_from_list
    from few_shot_seg_cwt_tpu_torch.data.synthetic import make_episode_batch
    from few_shot_seg_cwt_tpu_torch.episodic.heads import HeadEngine
    from few_shot_seg_cwt_tpu_torch.models.matching import live_consensus
    from few_shot_seg_cwt_tpu_torch.train.common import fp32_parity

    fp32_parity()
    if head == "chm":
        size, cfg = 41, merge_cfg_from_list(load_cfg("configs/pascal_match.yaml"),
                                            ["crm_type", "chm"])
    else:
        size, cfg = 33, load_cfg("configs/pascal_trans.yaml")
    cfg = merge_cfg_from_list(cfg, ["image_size", str(size), "adapt_iter", "5"])
    cpu = HeadEngine(cfg, head, device="cpu")
    live_consensus(cpu.head)
    card = HeadEngine(cfg, head, backbone=copy.deepcopy(cpu.backbone),
                      head=copy.deepcopy(cpu.head), device="cuda")
    ep = make_episode_batch(12, 2, size=size)
    w0 = cpu.init_weights(2, torch.Generator().manual_seed(3))
    want = cpu.predict_batch(ep, w0=w0)
    tracing.reset()
    got = card.predict_batch(ep, w0=w0.to(device))
    torch.cuda.synchronize()
    assert tracing.counts()["adapt_binary"] == 1
    assert tracing.counts()["pivot_fwd"] == (12 if head == "detr" else 0)
    for key in ("pred1", "pred"):
        g, w = got[key].cpu(), want[key]
        torch.testing.assert_close(g, w, rtol=1e-2, atol=2e-3 * float(w.abs().max()))
        assert float((g.argmax(-1) == w.argmax(-1)).float().mean()) >= 0.995, key


def test_bf16_volume_runs_the_fp32_kernels_between_casts(device):
    """``use_amp``'s flat route: a bf16 volume and bf16 weights go to fp32,
    through the same kernels (counted), and back: y and the gradients equal
    the kernels' fp32 results on the upcast inputs, cast to bf16. The
    ``fss::pivot_fwd`` operator itself casts around the kernel, so a bf16
    call launches it too, and nothing reaches a plain version."""
    from few_shot_seg_cwt_tpu_torch.ops import cuda_pivot

    dims = (5, 6, 4, 7)
    x, wa, wb, bias, t = (a.bfloat16() for a in _pivot_inputs(device, 2, 3, 4, dims))
    before = tracing.counts()
    y_op = cuda_pivot.pivot_fwd(x, wa, wb, bias, dims, relu=True)
    assert tracing.counts()["pivot_fwd"] - before["pivot_fwd"] == 1
    before = tracing.counts()
    leaves = [a.clone().requires_grad_(True) for a in (x, wa, wb, bias)]
    y = cuda_pivot.pivot_fwd(*leaves, dims, relu=True)
    (y.float() * t.float()).sum().backward()
    torch.cuda.synchronize()
    assert tracing.counts()["pivot_fwd"] - before["pivot_fwd"] == 2      # y and dx
    assert tracing.counts()["pivot_dw"] - before["pivot_dw"] == 1
    f32 = [a.float() for a in (x, wa, wb, bias)]
    y32 = cuda_pivot.pivot_fwd(f32[0], *f32[1:], dims, relu=True)
    assert y.dtype == torch.bfloat16 and torch.equal(y, y32.bfloat16())
    assert torch.equal(y_op, y)
    # the backward's cotangent: the bf16 one, masked by the bf16 y's ReLU
    g = (t * (y > 0).to(t.dtype)).float().contiguous()
    zeros = torch.zeros((x.shape[1],), device=device)
    want = [cuda_pivot.pivot_fwd(g, cuda_pivot.flip_t(f32[1]), cuda_pivot.flip_t(f32[2]), zeros,
                                 dims)] + list(cuda_pivot.pivot_dw(f32[0], g, dims))
    for name, got, w in zip(("dx", "dwa", "dwb", "db"), leaves, want):
        assert got.grad.dtype == torch.bfloat16, name
        assert torch.equal(got.grad, w.bfloat16()), name


# --------------------------------------------------------------------------- #
# the kernels as torch.library operators, and a saved serve program
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("op", ["adapt_binary", "adapt_binary_tiled", "pivot_fwd", "pivot_dw"])
def test_operator_passes_opcheck_on_the_card(device, op):
    """``torch.library.opcheck`` on CUDA tensors (schema, fake against the
    real CUDA implementation, autograd registration, AOT dispatch); the
    CUDA implementations launch the kernels (counted)."""
    rng = np.random.default_rng(5)
    tracing.reset()
    if op.startswith("adapt"):
        f_s, pw, pwy, u0 = _inputs(device, 2, 1, 6, 41, 32)
        args = (f_s, pw, pwy, u0, 3, 0.1) + ((2,) if op.endswith("tiled") else ())
    else:
        dims = [5, 6, 4, 5]
        x = torch.tensor(rng.standard_normal((2, 3, 30, 20)).astype(np.float32), device=device)
        if op == "pivot_fwd":
            w = [torch.tensor(rng.standard_normal(s).astype(np.float32), device=device)
                 .requires_grad_(True) for s in ((3, 3, 3, 4), (3, 3, 3, 4), (4,))]
            args = (x.requires_grad_(True), *w, dims, True)
        else:
            g = torch.tensor(rng.standard_normal((2, 4, 30, 20)).astype(np.float32),
                             device=device)
            args = (x, g, dims)
    torch.library.opcheck(getattr(torch.ops.fss, op), args)
    launches = launch_counts()
    assert launches[op] >= 1, launches


def test_saved_serve_program_launches_the_kernels(device, tmp_path):
    """The MMN serve program at 65 px, exported on the
    card, saved and loaded: the loaded program launches K1 and pivot_fwd
    and its masks equal eager ``serve_batch``'s."""
    from few_shot_seg_cwt_tpu_torch.config import load_cfg, merge_cfg_from_list
    from few_shot_seg_cwt_tpu_torch.data.synthetic import make_episode_batch
    from few_shot_seg_cwt_tpu_torch.episodic.heads import HeadEngine
    from few_shot_seg_cwt_tpu_torch.tools.export_serve import build_head_serve_export

    torch.backends.cudnn.allow_tf32 = False
    cfg = merge_cfg_from_list(load_cfg("configs/pascal_mmn.yaml"),
                              ["image_size", "65", "adapt_iter", "5"])
    engine = HeadEngine(cfg, "mmn", device="cuda")
    ep = make_episode_batch(3, 2, size=65)
    w0 = engine.init_weights(2, torch.Generator().manual_seed(0))
    torch.export.save(build_head_serve_export(cfg, "mmn", engine, 2), str(tmp_path / "m.pt2"))
    program = torch.export.load(str(tmp_path / "m.pt2")).module()
    tracing.reset()
    with torch.no_grad():
        masks = program(*(torch.as_tensor(ep[k]).to(device) for k in ("s_img", "s_label",
                                                                         "q_img")), w0)
    torch.cuda.synchronize()
    assert tracing.counts()["adapt_binary"] == 1
    assert tracing.counts()["pivot_fwd"] == 12       # 3 blocks x 2 directions x 2
    assert torch.equal(masks, engine.serve_batch(ep, w0=w0))


def test_dryrun_two_ranks_over_gloo_on_the_card(device, tmp_path):
    """``parallel/dryrun.py --world 2 --backend gloo --device cuda`` at 33 px:
    every check holds (the steps against one process, parameters equal on
    both ranks, the gathers, SyncBN), and each rank launches K1, K2,
    pivot_fwd and pivot_dw in its steps."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    proc = subprocess.run(
        [sys.executable, "-m", "few_shot_seg_cwt_tpu_torch.parallel.dryrun", "--world", "2",
         "--backend", "gloo", "--device", "cuda", "--size", "33", "--adapt-iter", "5",
         "--out", str(tmp_path)],
        cwd=Path(__file__).resolve().parents[1], capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    rows = [json.loads(line) for line in proc.stdout.splitlines() if line.startswith("{")]
    assert rows and all(r["ok"] for r in rows)
    launches = {(r["check"], r.get("tile"), r.get("head")): r["launches"] for r in rows
                if "launches" in r}
    for key, kernel in ((("cwt_step", 1, None), "adapt_binary"),
                        (("cwt_step", 2, None), "adapt_binary_tiled"),
                        (("mmn_step", None, "fp32_head"), "pivot_fwd"),
                        (("mmn_step", None, "fp32_head"), "pivot_dw")):
        assert all(rank[kernel] > 0 for rank in launches[key]), (key, kernel, launches[key])


def _fuse_stack(device, dtype, seed=9):
    """The fuse head's ``_Conv4dStack`` (1 -> 16 at support stride 2, 16 -> 1),
    seeded, biases 0.05 so that neither ReLU is dead."""
    from few_shot_seg_cwt_tpu_torch.models.conv4d import init_conv_parameters
    from few_shot_seg_cwt_tpu_torch.models.fusion import _conv4d_stack

    stack = _conv4d_stack()
    init_conv_parameters(stack, torch.Generator().manual_seed(seed))
    with torch.no_grad():
        for name, p in stack.named_parameters():
            if name.endswith("bias"):
                p.fill_(0.05)
    return stack.to(device=device, dtype=dtype)


def test_fuse_stack_6d_route_against_fp64(device):
    """The fuse head's conv stack on its 6D route at the 473 px shape, (1, 60,
    60, 60, 60, 1) -> (1, 60, 60, 30, 30, 1), in fp32 against the same route
    in fp64: output, input gradient and each parameter's gradient within
    1e-4 of its scale (the readings are printed: ``pytest -rP``). The fp32
    run takes the fp64 run's ReLU masks: a pre-activation within rounding
    of 0 is masked differently in the two, and such a flip moved the input
    gradient by 0.1 of its scale in one run at this shape."""
    from few_shot_seg_cwt_tpu_torch.train.common import fp32_parity

    fp32_parity()
    g = torch.Generator().manual_seed(10)
    x64 = torch.rand((1, 60, 60, 60, 60, 1), generator=g, dtype=torch.float64).to(device)
    gy64 = torch.randn((1, 60, 60, 30, 30, 1), generator=g, dtype=torch.float64).to(device)
    got, masks = {}, None
    for dtype in (torch.float64, torch.float32):
        stack = _fuse_stack(device, dtype)
        x = x64.to(dtype).clone().requires_grad_(True)
        y0 = stack[0](x)
        m0 = (y0 > 0) if masks is None else masks[0]
        y = stack[2](y0 * m0)
        m1 = (y > 0) if masks is None else masks[1]
        masks = (m0, m1)
        y = y * m1
        y.backward(gy64.to(dtype))
        got[dtype] = {"y": y.detach(), "dx": x.grad,
                      **{k: p.grad for k, p in stack.named_parameters()}}
    rel = {k: float((got[torch.float32][k].double() - w).abs().max() / w.abs().max())
           for k, w in got[torch.float64].items()}
    print(f"fuse stack 6D fp32 vs fp64, max|v - v64| / max|v64|: {rel}")
    assert max(rel.values()) <= 1e-4, rel


def test_fuse_c1_6d_route_against_rank4(device):
    """The stack's second block (16 -> 1, stride 1) at its 473 px input (1,
    60, 60, 30, 30, 16): the 6D route the head runs against the rank-4
    route, output, input and parameter gradients within 1e-4 of the
    scale."""
    from few_shot_seg_cwt_tpu_torch.train.common import fp32_parity

    fp32_parity()
    c1 = _fuse_stack(device, torch.float32)[2]
    g = torch.Generator().manual_seed(11)
    x = torch.rand((1, 60, 60, 30, 30, 16), generator=g).to(device)
    gy = torch.randn((1, 60, 60, 30, 30, 1), generator=g).to(device)
    got = []
    for bqsc in (False, True):
        c1.zero_grad(set_to_none=True)
        xi = (x.reshape(1, 3600, 900, 16) if bqsc else x).clone().requires_grad_(True)
        y = (c1(xi, flat_dims=(60, 60, 30, 30), bqsc=True) if bqsc else c1(xi))
        y.backward(gy.reshape(y.shape))
        got.append({"y": y.detach().reshape(gy.shape), "dx": xi.grad.reshape(x.shape),
                    **{k: p.grad.clone() for k, p in c1.named_parameters()}})
    rel = {k: float((got[0][k] - w).abs().max() / w.abs().max()) for k, w in got[1].items()}
    print(f"fuse c1 6D vs rank-4, max|v - v_r4| / max|v_r4|: {rel}")
    assert max(rel.values()) <= 1e-4, rel


@pytest.mark.parametrize("ci,co,planes,side", [(10, 10, 3600, 60), (1, 10, 3600, 60),
                                                (10, 1, 3600, 60), (16, 16, 64, 30)])
def test_qconv2d_dot_against_the_dequantized_conv(device, ci, co, planes, side):
    """``FSS_NCONS_INT8=dot``'s plane conv (int8 operands on the card,
    im2col x ``torch._int_mm``, int32 sums) at the MMN rank-4 route's plane
    shapes against cuDNN's fp32 conv of the same dequantized operands (the
    fake quantization at dot's scales): within 1e-5 of max|y|; its
    gradients equal the plain conv's at the dequantized point (the STE)
    within 1e-4 of their scale; one int8 GEMM a call."""
    import torch.nn.functional as F

    from few_shot_seg_cwt_tpu_torch.ops import quant
    from few_shot_seg_cwt_tpu_torch.train.common import fp32_parity

    fp32_parity()
    g = torch.Generator(device=device).manual_seed(ci * co)
    x = torch.relu(torch.randn((planes, ci, side, side), generator=g, device=device))
    k = torch.randn((co, ci, 3, 3), generator=g, device=device) * 0.2
    xq, sx = quant.quantize_tensor(x)
    kq, sk = quant.quantize_per_co(k)
    assert xq.dtype == kq.dtype == torch.int8 and xq.is_cuda
    x_deq = (xq.float() * sx).requires_grad_(True)
    k_deq = (kq.float() * sk.reshape(-1, 1, 1, 1)).requires_grad_(True)
    want = F.conv2d(x_deq, k_deq, padding=1)
    before = quant.INT_MM_CALLS
    xi, ki = x.clone().requires_grad_(True), k.clone().requires_grad_(True)
    got = quant.qconv2d(xi, ki, (1, 1))
    torch.cuda.synchronize()
    assert quant.INT_MM_CALLS == before + 1
    err = float((got - want).abs().max() / want.abs().max())
    gy = torch.randn(got.shape, generator=g, device=device)
    got.backward(gy)
    want.backward(gy)
    gerr = [float((a - b).abs().max() / b.abs().max())
            for a, b in ((xi.grad, x_deq.grad), (ki.grad, k_deq.grad))]
    print(f"qconv2d dot {ci}->{co} on {planes} planes of {side}x{side}: forward {err:.3e}, "
          f"dx {gerr[0]:.3e}, dk {gerr[1]:.3e}")
    assert err <= 1e-5 and max(gerr) <= 1e-4, (err, gerr)


def test_cca_flat_route_step_against_6d(device, monkeypatch):
    """A CCA train step (configs/pascal_cca.yaml at 33 px, 5 K-way inner
    steps, live consensus) on the flat route (the pivot pair launched)
    against the 6D route's cuDNN plane convs (the pivot gate refused) on
    the same episodes and inits: head gradients within 1e-3 of each
    tensor's largest entry, K1 never launched (the CCA loop is K-way), the
    predictions' argmax >= 99.5% equal."""
    from few_shot_seg_cwt_tpu_torch.config import load_cfg, merge_cfg_from_list
    from few_shot_seg_cwt_tpu_torch.data.synthetic import make_episode_batch
    from few_shot_seg_cwt_tpu_torch.episodic.cca import CCAEngine
    from few_shot_seg_cwt_tpu_torch.models import matching
    from few_shot_seg_cwt_tpu_torch.models.matching import live_consensus
    from few_shot_seg_cwt_tpu_torch.train.common import fp32_parity

    fp32_parity()
    monkeypatch.delenv("FSS_NCONS_INT8", raising=False)
    cfg = merge_cfg_from_list(load_cfg("configs/pascal_cca.yaml"),
                              ["image_size", "33", "adapt_iter", "5"])
    engine = CCAEngine(cfg, device="cuda")
    with torch.no_grad():
        live_consensus(engine.head, 0.05)
        bn = engine.backbone.bottleneck[1]
        bn.weight.mul_(0.01)      # features of norm ~10: the 16-way softmax is not one-hot
        bn.bias.mul_(0.01)
    ep = make_episode_batch(14, 2, size=33)
    ep["cls"] = np.asarray([3, 9], np.int32)
    rows = engine.new_rows(2, torch.Generator().manual_seed(2))
    w0 = engine.base_weight().expand(2, 16, 512).clone()
    w0[torch.arange(2), torch.as_tensor(ep["cls"]).long()] = rows
    got = {}
    for route in ("flat", "6d"):
        if route == "6d":
            monkeypatch.setattr(matching, "pivot_takes", lambda *a: False)
        tracing.reset()
        m = engine.backward_batch(ep, w0=w0, deterministic=True)
        torch.cuda.synchronize()
        assert torch.isfinite(m["loss_mean"])
        assert tracing.counts()["adapt_binary"] == 0
        assert (tracing.counts()["pivot_fwd"] > 0) == (route == "flat")
        assert (tracing.counts()["pivot_dw"] > 0) == (route == "flat")
        got[route] = ({k: p.grad.clone() for k, p in engine.head.named_parameters()},
                      engine.predict_batch(ep, w0=w0))
    rel = {k: float((got["flat"][0][k] - g).abs().max() / g.abs().max())
           for k, g in got["6d"][0].items() if float(g.abs().max()) > 0}
    print(f"CCA step flat vs 6D, max|g_flat - g_6d| / max|g_6d|: {rel}")
    assert rel and max(rel.values()) <= 1e-3, rel
    for key in ("pred", "pred1"):
        agree = (got["flat"][1][key].argmax(-1) == got["6d"][1][key].argmax(-1)).float().mean()
        assert float(agree) >= 0.995, (key, float(agree))
