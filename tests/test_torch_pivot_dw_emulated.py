"""The weight-gradient pivot kernel's pipeline, checked on the CPU.

``csrc/pivot_dw.cuh`` (the kernel the card runs) is compiled with g++
through ``csrc/cuda_emulation.h``: each CTA's 416 threads run as
std::threads, ``__syncthreads``, ``__syncwarp`` and the MMA warps' named
barrier are std::barriers, a TMA bulk copy is a plain copy, each mbarrier
counts arrivals and bytes (a wrong byte count, a stage never released or a
wait that never ends aborts), and ``mma.sync`` exchanges the PTX ISA's
fragments between a warp's lanes. So the roles' agreement on the ring
(which slot holds which column, when a slot is free), the staging table,
the TF32 split at the fragment loads and the fragment indexing are all
exercised. At tiny ragged shapes, on a few CTAs, the result must lie as
close to an fp64 run as the card's limit allows (4x the plain fp32
version's distance plus 2e-6 of the scale) and be the same bits run after
run. The emulation cannot see races between the card's asynchronous copies
and its threads, nor its timing. Skips only where g++ is missing.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from few_shot_seg_cwt_tpu_torch.ops import cuda_build
from few_shot_seg_cwt_tpu_torch.ops.cuda_pivot import MAX_SMEM_BYTES, pivot_dw_reference

torch.set_num_threads(1)

_SOURCE = cuda_build.CSRC / "pivot_dw_emulated.cpp"


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernel's emulation")
    out = tmp_path_factory.mktemp("pivot_dw_emu") / "libfss_pivot_dw_emu.so"
    subprocess.run([gxx, "-std=c++20", "-O1", "-pthread", "-ffp-contract=off", "-shared",
                    "-fPIC", "-o", str(out), str(_SOURCE)], check=True, timeout=300)
    lib = ctypes.CDLL(str(out))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fss_pivot_dw_emulated.argtypes = [p] * 3 + [i] * 9
    lib.fss_pivot_dw_emulated.restype = i
    lib.fss_pivot_dw_emulated_plan.argtypes = [i] * 3 + [p]
    lib.fss_pivot_dw_emulated_plan.restype = ctypes.c_longlong
    return lib


def _plan(lib, ci, co, ws):
    out = (ctypes.c_int * 4)()
    smem = lib.fss_pivot_dw_emulated_plan(ci, co, ws, ctypes.addressof(out))
    return {"rows": out[0], "column_slots": out[1], "g_slots": out[2], "threads": out[3],
            "smem": smem}


def _run(lib, b, ci, co, dims, blocks, bulk, seed=11):
    rng = np.random.default_rng(seed)
    hq, wq, hs, ws = dims
    x = rng.standard_normal((b, ci, hq * wq, hs * ws)).astype(np.float32)
    g = rng.standard_normal((b, co, hq * wq, hs * ws)).astype(np.float32)
    out = np.full(18 * ci * co + co, np.nan, dtype=np.float32)
    assert lib.fss_pivot_dw_emulated(x.ctypes.data, g.ctypes.data, out.ctypes.data, b, ci, co,
                                     *dims, blocks, int(bulk)) == 0
    return torch.from_numpy(x), torch.from_numpy(g), out


def _flat(dwa, dwb, db):
    return torch.cat([dwa.reshape(-1), dwb.reshape(-1), db])


@pytest.mark.parametrize("b,ci,co,dims,blocks,bulk", [
    (2, 3, 4, (5, 6, 4, 7), 3, False),    # ws % 4 != 0: the producer's lanes copy; B = 2
    (2, 3, 4, (5, 6, 4, 8), 3, True),     # bulk copies; runs cross b
    (1, 10, 1, (9, 11, 13, 8), 5, True),  # Co = 1; 13 rows: a partial second tile
    (1, 1, 10, (5, 6, 4, 7), 2, False),   # Ci = 1 -> 10
    (1, 3, 4, (5, 1, 4, 8), 3, True),     # wq = 1: every step starts a run
    (1, 3, 4, (1, 6, 4, 8), 3, True),     # hq = 1: no query row above or below
    (1, 3, 4, (5, 6, 1, 8), 3, True),     # hs = 1
    (2, 2, 3, (4, 3, 5, 13), 5, False),   # odd everything
    (1, 42, 2, (3, 3, 2, 4), 2, True),    # Ci = 42: 48 m-tiles, one k-split
    (3, 3, 4, (4, 5, 6, 12), 11, True),   # the rest split mid-run over 11 CTAs; ws % 8 != 0
    (1, 10, 10, (2, 5, 7, 60), 3, True),  # 473 px's 10 -> 10 layout: 6 rows a step, 4 slots
    (1, 10, 1, (2, 5, 9, 60), 3, True),   # 473 px's 10 -> 1 layout: 7 rows a step, 4 slots
    (2, 3, 9, (4, 3, 5, 7), 5, False),    # Co = 9, ragged; B = 2
])
def test_emulated_pivot_dw_is_within_the_card_limit_of_fp64(lib, b, ci, co, dims, blocks,
                                                             bulk):
    x, g, out = _run(lib, b, ci, co, dims, blocks, bulk)
    got = torch.from_numpy(out).double()
    wide = _flat(*pivot_dw_reference(x.double(), g.double(), dims))
    plain = _flat(*pivot_dw_reference(x, g, dims)).double()
    err, err_p = float((got - wide).abs().max()), float((plain - wide).abs().max())
    assert err <= 4 * err_p + 2e-6 * float(wide.abs().max()), (err, err_p)
    # and it keeps fp32's accuracy: a TF32 product alone would be ~1e-3 off
    assert err <= 1e-5 * float(wide.abs().max()), err


def test_emulated_pivot_dw_gives_the_same_bits_every_run(lib):
    """The partition, the ring and the sums' order are fixed: two runs on
    the same CTAs give the same bits, with either staging."""
    dims = (4, 5, 6, 12)
    for bulk in (True, False):
        first = _run(lib, 2, 3, 4, dims, 7, bulk)[2]
        second = _run(lib, 2, 3, 4, dims, 7, bulk)[2]
        assert np.array_equal(first, second)


def test_plan_deepens_steps_where_shared_memory_allows(lib):
    """At 473 px (ws = 60) the plan takes the most support rows a step that
    fit a block with 4 column slots (6 at 10->10, 7 at 10->1, the cap of 8
    at Ci = 1 and 2), then as many slots as fit; every Ci <= 10 the MMN and
    match heads run fits a block; the g ring is the column ring less 2."""
    for (ci, co), (rows, slots) in {(10, 10): (6, 4), (10, 1): (7, 4), (2, 10): (8, 6),
                                    (1, 10): (8, 6)}.items():
        plan = _plan(lib, ci, co, 60)
        assert (plan["rows"], plan["column_slots"]) == (rows, slots), (ci, co, plan)
        assert plan["smem"] <= MAX_SMEM_BYTES
        assert plan["g_slots"] == plan["column_slots"] - 2
        assert plan["threads"] == 416
    assert all(_plan(lib, ci, co, 60)["smem"] <= MAX_SMEM_BYTES
               for ci in range(1, 11) for co in range(1, 11))
