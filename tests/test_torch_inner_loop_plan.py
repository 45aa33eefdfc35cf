"""The inner-loop kernels' work plan and two-tap tables (CPU).

``csrc/inner_loop.cu`` reads A and B only through two-tap tables and spreads
each group of ``tile`` episodes over P CTAs, each owning whole feature rows
(``ops/inner_loop_plan.py``). These tests hold, without a card:

* the tables against ``interp_matrix_align_corners`` (the port's and the
  JAX package's), exactly;
* the plan: every feature row and every output row belongs to exactly one
  slice, the halo rows a slice reads are the ones its neighbour hands over,
  and the layout fits a block wherever ``pick_tile`` admits the tile;
* ``adapt_binary_partitioned`` (below), a plain version that follows the
  kernel's partition (slices, halos, fixed-order reduction of the row
  partials), against ``adapt_binary_reference`` and the JAX closed form
  (XLA scan) at 33 px, with the inner loop's tolerances (rtol 1e-4, atol
  1e-6). It checks the partition's arithmetic (which rows, which halos),
  not the kernel: an error in ``csrc/inner_loop.cu`` shows only in the
  card tests (``tests/test_torch_cuda_kernels.py``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from few_shot_seg_cwt_tpu.episodic.inner_loop import adapt_classifier as jax_adapt
from few_shot_seg_cwt_tpu.ops.resize import interp_matrix_align_corners as jax_interp
from few_shot_seg_cwt_tpu_torch.episodic.inner_loop import binary_pixel_weights, pick_tile
from few_shot_seg_cwt_tpu_torch.ops import cuda_inner_loop
from few_shot_seg_cwt_tpu_torch.ops.inner_loop_plan import (MAX_SMEM_BYTES, Plan,
                                                           packed_taps, smem_bytes,
                                                           tap_table, work_plan)
from few_shot_seg_cwt_tpu_torch.ops.resize import interp_matrix_align_corners

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-6
SIZES = {473: 60, 33: 5}          # output px -> feature rows


@pytest.mark.parametrize("out_size,in_size", [(473, 60), (33, 5), (417, 53), (9, 1), (1, 7)])
def test_tap_table_rebuilds_the_interpolation_matrix_exactly(out_size, in_size):
    t = tap_table(out_size, in_size)
    m = interp_matrix_align_corners(out_size, in_size)
    np.testing.assert_array_equal(t.dense(), m)
    np.testing.assert_array_equal(t.dense(), np.asarray(jax_interp(out_size, in_size)))
    # per input index: the contiguous output rows with a non-zero weight on it
    for k in range(in_size):
        rows = np.flatnonzero(m[:, k])
        if len(rows):
            assert (t.begin[k], t.end[k]) == (rows[0], rows[-1] + 1)
        else:
            assert t.begin[k] == t.end[k] == t.first[k]
        assert t.begin[k] <= t.first[k]
    # first[k]: the output rows whose lower tap is k are [first[k], first[k+1])
    for k in range(in_size):
        np.testing.assert_array_equal(np.flatnonzero(t.lo == k),
                                      np.arange(t.first[k], t.first[k + 1]))
    assert t.first[0] == 0 and t.first[-1] == out_size


def test_packed_taps_hold_both_axes_in_the_kernel_order():
    """lo, w0, w1, first, begin, end of the rows (H from h), then of the
    columns (W from w); weights as their fp32 bits."""
    big_h, big_w, h, w = 33, 41, 5, 7
    buf = packed_taps(big_h, big_w, h, w)
    assert buf.dtype == np.int32
    off = 0
    for out_size, in_size in ((big_h, h), (big_w, w)):
        t = tap_table(out_size, in_size)
        for a in (t.lo, t.w0.view(np.int32), t.w1.view(np.int32), t.first, t.begin, t.end):
            np.testing.assert_array_equal(buf[off:off + len(a)], a)
            off += len(a)
    assert off == len(buf)


def _check_plan(plan, sms):
    h, big_h = plan.h, plan.big_h
    t = tap_table(big_h, h)
    p = plan.ctas_per_group
    assert 1 <= p <= h and plan.grid == plan.groups_in_flight * p <= sms
    assert plan.groups_in_flight <= plan.groups
    slices = [plan.slice_rows(j) for j in range(p)]
    assert slices[0][0] == 0 and slices[-1][1] == h
    assert all(a[1] == b[0] for a, b in zip(slices, slices[1:]))
    assert max(r1 - r0 for r0, r1 in slices) == plan.rows
    assert min(r1 - r0 for r0, r1 in slices) >= 1
    outs = [plan.out_rows(j) for j in range(p)]
    covered = np.zeros(big_h, int)
    for (r0, r1), (i0, i1) in zip(slices, outs):
        covered[i0:i1] += 1
        assert np.all((t.lo[i0:i1] >= r0) & (t.lo[i0:i1] < r1))
    np.testing.assert_array_equal(covered, 1)          # every output row exactly once
    for j in range(p):
        ib, i0 = plan.halo_rows(j)
        i1 = plan.out_rows(j)[1]
        if ib < i0:                                   # summed by slice j - 1
            r0 = plan.slice_rows(j)[0]
            assert j > 0 and int(t.begin[r0]) == ib
            pi0, pi1 = plan.out_rows(j - 1)
            assert pi0 <= ib and i0 == pi1
            assert np.all(t.lo[ib:i0] == r0 - 1) and np.all(t.w1[ib:i0] != 0)
        # the rows with a tap on the slice's rows are its own or its halo
        for k in range(*plan.slice_rows(j)):
            assert ib <= t.begin[k] and t.end[k] <= i1
    assert 0 <= plan.pin <= plan.rows * plan.w
    assert plan.smem == smem_bytes(plan.h, plan.w, plan.c, plan.big_w, plan.tile,
                                   big_h=big_h, shot=plan.shot, rows=plan.rows, pin=plan.pin)
    assert plan.smem <= MAX_SMEM_BYTES


@pytest.mark.parametrize("px", [473, 33])
@pytest.mark.parametrize("e", [1, 2, 3, 4, 8])
def test_work_plan_covers_every_pixel_and_output_row_once(monkeypatch, px, e):
    """Slices of whole feature rows cover the h rows, their output rows the
    H rows, each exactly once, for every tile that divides E, on the H100's
    132 SMs and on a small card where groups run in waves; the layout fits
    a block wherever pick_tile admits the tile."""
    h, c = SIZES[px], 512
    for tile in (1, 2, 3, 4):
        if e % tile:
            continue
        for sms in (132, 16):
            plan = work_plan(e, 1, h, h, c, px, px, tile, sms)
            _check_plan(plan, sms)
            if px == 473 and sms == 132 and tile == 1:
                assert plan.ctas_per_group == min(h, 132 // e)
                assert plan.ctas_per_group > 1       # an episode spans many SMs
        if tile > 1:
            monkeypatch.setenv("FSS_INNER_TILE", str(tile))
            if pick_tile(e, 1, h, h, c, px) == tile:
                assert smem_bytes(h, h, c, px, tile) <= MAX_SMEM_BYTES
                assert work_plan(e, 1, h, h, c, px, px, tile, 132).smem <= MAX_SMEM_BYTES


def test_work_plan_pins_what_fits_and_refuses_what_cannot():
    """At E <= 2 each CTA of the H100 holds its whole slice of f; at E = 8
    it pins 91 of its 240 pixels; a layout over the block, or one the card
    holds no CTA of, raises."""
    for e in (1, 2):
        plan = work_plan(e, 1, 60, 60, 512, 473, 473, 1, 132)
        assert plan.rows == 1 and plan.pin == 60
        assert plan.smem == smem_bytes(60, 60, 512, 473, rows=1, pin=60)
    plan = work_plan(8, 1, 60, 60, 512, 473, 473, 1, 132)
    assert plan.ctas_per_group == 16 and plan.rows == 4 and plan.pin == 91
    assert plan.smem + 4 * 512 > MAX_SMEM_BYTES      # one more pixel would not fit
    with pytest.raises(ValueError, match="shared memory"):
        work_plan(1, 64, 60, 60, 512, 473, 473, 1, 132)
    with pytest.raises(ValueError):
        work_plan(3, 1, 60, 60, 512, 473, 473, 2, 132)
    with pytest.raises(ValueError, match="holds no CTA"):
        work_plan(8, 1, 60, 60, 512, 473, 473, 1, 132, lambda smem: 0)


def adapt_binary_partitioned(f_s: torch.Tensor, pw: torch.Tensor, pwy: torch.Tensor,
                             u0: torch.Tensor, num_steps: int, lr: float,
                             plan: Plan) -> torch.Tensor:
    """The inner loop as the kernel partitions it, in plain torch; (E, C).

    Per group of ``plan.tile`` episodes and step: each slice computes d for
    its rows; reads the next slice's first d row; computes T = d B^T with
    the column taps, D with the row taps and g for its output rows, and
    A^T g as two row sums per feature row k (its output rows' lower taps on
    k, and upper taps on k), handing the next slice the upper-tap sum on
    its first row; computes G = (A^T g) B for its rows; and the per-row
    partial sums of G f. acc then grows by the rows' partials summed in the
    kernel's fixed order: four interleaved sequential sums (rows k = 0, 4,
    8, ...; 1, 5, ...), added pairwise.
    """
    e, shot, h, w, c = f_s.shape
    big_h, big_w = pw.shape[-2:]
    rt, ct = tap_table(big_h, h), tap_table(big_w, w)
    dt, dev = f_s.dtype, f_s.device

    def t(a):
        return torch.as_tensor(np.array(a), device=dev)

    clo, chi = t(ct.lo).long(), t(ct.lo + (ct.w1 != 0)).long()
    cw0, cw1 = t(ct.w0).to(dt), t(ct.w1).to(dt)
    rlo, rw0, rw1 = t(rt.lo).long(), t(rt.w0).to(dt), t(rt.w1).to(dt)
    b_dense = t(ct.dense()).to(dt)
    pws = pw - 2.0 * pwy
    tile, n_slices = plan.tile, plan.ctas_per_group
    acc_out = torch.zeros_like(u0)
    for grp in range(e // tile):
        eps = slice(grp * tile, (grp + 1) * tile)
        f, p, acc = f_s[eps], pws[eps], torch.zeros_like(u0[eps])
        for _ in range(num_steps):
            u = u0[eps] - 2.0 * lr * acc
            d = [torch.einsum("tsxyc,tc->tsxy", f[:, :, r0:r1], u)
                 for r0, r1 in map(plan.slice_rows, range(n_slices))]
            sums, halo = [], [None] * (n_slices + 1)
            for j in range(n_slices):
                r0, r1 = plan.slice_rows(j)
                i0, i1 = plan.out_rows(j)
                dj = torch.cat([d[j], d[j + 1][:, :, :1]], dim=2) if r1 < h else d[j]
                tj = cw0 * dj[..., clo] + cw1 * dj[..., chi]                # (t, s, nT, W)
                lo = rlo[i0:i1] - r0
                hi = lo + (rw1[i0:i1] != 0).long()
                w0, w1 = rw0[i0:i1, None], rw1[i0:i1, None]
                dd = w0 * tj[:, :, lo] + w1 * tj[:, :, hi]                  # (t, s, nout, W)
                pv = p[:, :, i0:i1]
                g = pv * torch.sigmoid(torch.where(pv < 0, -dd, dd))        # the kernel's form
                s_up = torch.zeros((tile, shot, r1 - r0, big_w), dtype=dt, device=dev)
                s_lo = torch.zeros((tile, shot, r1 - r0 + 1, big_w), dtype=dt, device=dev)
                s_up.index_add_(2, lo, w0 * g)
                s_lo.index_add_(2, lo + 1, w1 * g)
                sums.append((s_up, s_lo))
                halo[j + 1] = s_lo[:, :, -1]
            parts = torch.zeros((tile, h, c), dtype=dt, device=dev)
            for j in range(n_slices):
                r0, r1 = plan.slice_rows(j)
                s_up, s_lo = sums[j]
                if j > 0:
                    s_lo[:, :, 0] = halo[j]
                g_rows = (s_lo[:, :, :-1] + s_up) @ b_dense                 # (t, s, nr, w)
                parts[:, r0:r1] = torch.einsum("tsky,tskyc->tkc", g_rows, f[:, :, r0:r1])
            quarters = []
            for q in range(4):
                s = torch.zeros_like(acc)
                for k in range(q, h, 4):
                    s = s + parts[:, k]
                quarters.append(s)
            acc = acc + ((quarters[0] + quarters[1]) + (quarters[2] + quarters[3]))
        acc_out[eps] = acc
    return acc_out


def _inputs(rng, e, shot, h=5, big=33, c=16, pad_shots=0):
    f_s = rng.standard_normal((e, shot, h, h, c)).astype(np.float32)
    label = rng.integers(0, 2, size=(e, shot, big, big))
    label[:, 0, :3] = 255
    if pad_shots:
        label[:, shot - pad_shots:] = 255
    w0 = rng.uniform(-0.25, 0.25, size=(e, 2, c)).astype(np.float32)
    return f_s, label, w0


@pytest.mark.parametrize("e,shot,tile,sms,pad", [
    (3, 1, 1, 132, 0),       # one row a CTA
    (4, 1, 1, 7, 0),         # uneven slices, waves of groups
    (4, 1, 2, 5, 0),         # K2's partition at tile 2
    (4, 1, 4, 132, 0),       # tile 4
    (2, 2, 1, 3, 0),         # 2-shot, two rows and halos
    (2, 5, 1, 4, 3),         # 5-shot with all-255 padded shots
])
def test_partitioned_plain_version_matches_reference_and_jax(e, shot, tile, sms, pad):
    """The kernel's partition in plain torch equals the batched plain
    version and the JAX closed form of each episode at 33 px."""
    rng = np.random.default_rng(100 + 10 * e + shot + tile + sms)
    f_np, label_np, w0_np = _inputs(rng, e, shot, pad_shots=pad)
    f_s = torch.from_numpy(f_np)
    pw, pwy = binary_pixel_weights(torch.from_numpy(label_np))
    u0 = torch.from_numpy(w0_np[:, 1] - w0_np[:, 0])
    plan = work_plan(e, shot, 5, 5, 16, 33, 33, tile, sms)
    got = adapt_binary_partitioned(f_s, pw, pwy, u0, 25, 0.1, plan)
    ref = cuda_inner_loop.adapt_binary_reference(f_s, pw, pwy, u0, 25, 0.1)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=RTOL, atol=ATOL)
    for i in range(e):
        w_jax = np.asarray(jax_adapt(jnp.asarray(f_np[i]), jnp.asarray(label_np[i]),
                                     jnp.asarray(w0_np[i]), num_steps=25, lr=0.1))
        w_got = np.stack([w0_np[i, 0] + 0.1 * got[i].numpy(),
                          w0_np[i, 1] - 0.1 * got[i].numpy()])
        np.testing.assert_allclose(w_got, w_jax, rtol=RTOL, atol=ATOL)


def test_every_slice_boundary_at_33_px_has_a_halo():
    """At 33 px from 5 rows, one row a slice, every slice's first row has
    output rows of the previous slice with a non-zero upper tap on it, so
    the comparisons above go through every halo the kernel exchanges."""
    plan = work_plan(1, 1, 5, 5, 16, 33, 33, 1, 132)
    t = tap_table(33, 5)
    assert plan.ctas_per_group == 5
    for j in range(1, 5):
        ib, i0 = plan.halo_rows(j)
        assert ib < i0 and np.all(t.w1[ib:i0] > 0)
