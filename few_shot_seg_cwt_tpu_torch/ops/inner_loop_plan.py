"""Work plan of the inner-loop kernels K1/K2 (``csrc/inner_loop.cu``).

The kernels spread each group of ``tile`` episodes over ``P`` CTAs of a
persistent cooperative grid. CTA ``j`` of a group owns the feature rows
``[j*h//P, (j+1)*h//P)`` (a *slice*) of every episode and shot in it (a
*chain* is one episode's shot), and the 473-px output rows whose lower
interpolation tap lies in its slice. What it needs from its neighbours is
one row of d = f.u (the next slice's first row) and one row of A^T g: the
previous slice's sum over its output rows whose upper tap lands on this
slice's first row. These are the *halos*.

This module holds, in plain Python, everything about that partition that
does not need the card:

* ``tap_table``: the two-tap form of ``resize.interp_matrix_align_corners``
  (per output index a lower input index and two fp32 weights; per input
  index the contiguous output range with a non-zero weight on it), and
  ``packed_taps``, the int32 buffer the kernel copies into shared memory;
* ``smem_bytes``: the per-CTA shared-memory layout (``make_layout`` in the
  kernel; the library's ``fss_adapt_binary_smem_bytes`` must agree);
* ``work_plan``: CTAs per group, groups in flight, rows per slice and the
  pixels of f each CTA pins in shared memory, for a card with ``sms`` SMs.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, NamedTuple, Tuple

import numpy as np

from .resize import interp_matrix_align_corners

# shared memory one block may use on Hopper (bytes)
MAX_SMEM_BYTES = 232_448
# the most channels the kernel takes (csrc/inner_loop.cu: four float4 of u a lane)
MAX_CHANNELS = 512


class TapTable(NamedTuple):
    """Two-tap form of an (out, in) align-corners matrix M.

    lo[i], w0[i], w1[i]: M[i, lo] = w0 and, where w1 != 0, M[i, lo + 1] = w1
    (fp32, M's own values); every other entry of row i is 0.
    first[k] (in + 1 entries): the first i with lo[i] >= k.
    begin[k], end[k]: the output rows with M[i, k] != 0 are [begin, end)
    (begin = end = first[k] where there are none).
    """
    lo: np.ndarray
    w0: np.ndarray
    w1: np.ndarray
    first: np.ndarray
    begin: np.ndarray
    end: np.ndarray

    def dense(self) -> np.ndarray:
        """The (out, in) matrix the table stands for, fp32."""
        out, n_in = len(self.lo), len(self.begin)
        m = np.zeros((out, n_in), dtype=np.float32)
        rows = np.arange(out)
        m[rows, self.lo] = self.w0
        two = self.w1 != 0
        m[rows[two], self.lo[two] + 1] = self.w1[two]
        return m


@functools.lru_cache(maxsize=None)
def tap_table(out_size: int, in_size: int) -> TapTable:
    """The two-tap table of ``interp_matrix_align_corners(out_size, in_size)``."""
    m = interp_matrix_align_corners(out_size, in_size)
    lo = np.empty(out_size, np.int32)
    w0 = np.empty(out_size, np.float32)
    w1 = np.zeros(out_size, np.float32)
    for i in range(out_size):
        nz = np.flatnonzero(m[i])
        if len(nz) not in (1, 2) or (len(nz) == 2 and nz[1] != nz[0] + 1):
            raise ValueError(f"row {i} of the ({out_size}, {in_size}) matrix is not two-tap")
        lo[i], w0[i] = nz[0], m[i, nz[0]]
        if len(nz) == 2:
            w1[i] = m[i, nz[1]]
    first = np.searchsorted(lo, np.arange(in_size + 1), side="left").astype(np.int32)
    begin, end = first[:-1].copy(), first[:-1].copy()
    for k in range(in_size):
        nz = np.flatnonzero(m[:, k])
        if len(nz):
            if np.any(np.diff(nz) != 1):
                raise ValueError(f"column {k} of the ({out_size}, {in_size}) matrix has a gap")
            begin[k], end[k] = nz[0], nz[-1] + 1
    for a in (lo, w0, w1, first, begin, end):
        a.setflags(write=False)
    return TapTable(lo, w0, w1, first, begin, end)


def _axis_words(out_size: int, in_size: int) -> int:
    return 3 * out_size + 3 * in_size + 1


def packed_taps(big_h: int, big_w: int, h: int, w: int) -> np.ndarray:
    """The rows' table (H from h) then the columns' (W from w), each as
    lo, w0, w1, first, begin, end; the weights as their fp32 bits. int32."""
    parts = []
    for out_size, in_size in ((big_h, h), (big_w, w)):
        t = tap_table(out_size, in_size)
        parts += [t.lo, t.w0.view(np.int32), t.w1.view(np.int32), t.first, t.begin, t.end]
    return np.concatenate(parts).astype(np.int32)


def _r4(n: int) -> int:
    return (n + 3) & ~3


def smem_bytes(h: int, w: int, c: int, big_w: int, tile: int = 1, *, big_h: int = None,
               shot: int = 1, rows: int = 1, pin: int = 0) -> int:
    """Shared memory of one CTA, in bytes (``make_layout`` in the kernel).

    The tap tables; per episode u and acc (C
    each); per chain (``tile * shot`` of them) d and T for ``rows`` + 1
    feature rows (own rows and the halo row), the two row sums of A^T g
    (rows x W for the output rows' lower taps, rows + 1 for their upper
    taps, the halo row first) and G for ``rows``; and ``pin`` pixels of f
    per chain. Segments are padded to 4 floats. With ``rows`` 1 and ``pin``
    0 it is the least any plan needs: ``pick_tile`` admits a tile by it.
    """
    big_h = big_w if big_h is None else big_h
    tables = _r4(_axis_words(big_h, h) + _axis_words(big_w, w))
    per_episode = 2 * _r4(c)
    per_chain = (_r4((rows + 1) * w) + 2 * _r4((rows + 1) * big_w)
                 + _r4(rows * big_w) + _r4(rows * w))
    floats = (tables + tile * per_episode
              + tile * shot * (per_chain + pin * c))
    return 4 * floats


@dataclasses.dataclass(frozen=True)
class Plan:
    """How one launch spreads E episodes over the card."""
    e: int
    shot: int
    h: int
    w: int
    c: int
    big_h: int
    big_w: int
    tile: int
    ctas_per_group: int      # P: slices of each group of ``tile`` episodes
    groups_in_flight: int    # groups resident at once; more run in waves
    rows: int                # most feature rows in a slice
    pin: int                 # pixels of f per chain in shared memory
    smem: int                # bytes of shared memory per CTA
    blocks_per_sm: int       # the occupancy query at ``smem``
    sms: int

    @property
    def grid(self) -> int:
        return self.groups_in_flight * self.ctas_per_group

    @property
    def groups(self) -> int:
        return self.e // self.tile

    def slice_rows(self, j: int) -> Tuple[int, int]:
        """Feature rows [r0, r1) of slice j."""
        p = self.ctas_per_group
        return j * self.h // p, (j + 1) * self.h // p

    def out_rows(self, j: int) -> Tuple[int, int]:
        """Output rows [i0, i1) slice j computes D, g and gB for."""
        r0, r1 = self.slice_rows(j)
        first = tap_table(self.big_h, self.h).first
        return int(first[r0]), int(first[r1])

    def halo_rows(self, j: int) -> Tuple[int, int]:
        """Output rows [ib, i0): slice j - 1's rows with a tap on slice j's
        first row, whose A^T g sum slice j reads."""
        r0, _ = self.slice_rows(j)
        return int(tap_table(self.big_h, self.h).begin[r0]), self.out_rows(j)[0]

    def summary(self) -> dict:
        return {"grid": self.grid, "ctas_per_episode_group": self.ctas_per_group,
                "tile": self.tile, "groups_in_flight": self.groups_in_flight,
                "rows_per_slice": self.rows, "pinned_pixels_per_chain": self.pin,
                "smem_bytes": self.smem, "blocks_per_sm": self.blocks_per_sm,
                "sms": self.sms}


def work_plan(e: int, shot: int, h: int, w: int, c: int, big_h: int, big_w: int,
              tile: int, sms: int,
              occupancy: Callable[[int], int] = lambda smem: 1) -> Plan:
    """The kernel's partition for a card of ``sms`` SMs, one CTA an SM (512
    threads at 128 registers fill an SM's register file); ``occupancy(smem)``
    is the blocks of the kernel an SM holds at ``smem`` bytes (the card's
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), and a plan it puts
    at 0 is refused.

    P, the CTAs of each group, is the SMs shared among the groups, at most h
    (whole rows), and at least the smallest P whose slices' fixed layout
    fits a block. Each CTA then pins as many of its slice's pixels as the
    rest of the block holds, and streams the others. Groups beyond what is
    resident at once run in waves on the same CTAs. Raises ValueError where
    no partition fits.
    """
    if e < 1 or e % tile or shot < 1 or tile < 1:
        raise ValueError(f"work_plan: E {e}, shot {shot}, tile {tile}")
    groups, chains = e // tile, tile * shot

    def fixed(rows):
        return smem_bytes(h, w, c, big_w, tile, big_h=big_h, shot=shot, rows=rows)

    p_fit = next((p for p in range(1, h + 1) if fixed(-(-h // p)) <= MAX_SMEM_BYTES), None)
    if p_fit is None:
        raise ValueError(f"adapt_binary: {fixed(1)} B of shared memory needed for h={h} "
                         f"w={w} C={c} H={big_h} W={big_w} shot={shot} tile={tile} even "
                         f"at one row a CTA; a block has {MAX_SMEM_BYTES}")
    p = min(h, max(p_fit, sms // groups))
    if p > sms:
        raise ValueError(f"adapt_binary: {p} CTAs per group needed, the card holds {sms}")
    rows = -(-h // p)
    pin = min(rows * w, (MAX_SMEM_BYTES - fixed(rows)) // (4 * chains * c))
    smem = smem_bytes(h, w, c, big_w, tile, big_h=big_h, shot=shot, rows=rows, pin=pin)
    blocks = occupancy(smem)
    if blocks < 1:
        raise ValueError(f"adapt_binary: the card holds no CTA of {smem} B")
    return Plan(e, shot, h, w, c, big_h, big_w, tile, p, min(groups, sms // p), rows, pin,
                smem, blocks, sms)
