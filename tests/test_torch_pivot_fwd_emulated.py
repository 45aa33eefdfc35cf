"""The forward pivot kernel's indexing, checked on the CPU.

``csrc/pivot_fwd.cuh`` (the kernel the card runs) is compiled with g++
through ``csrc/cuda_emulation.h``: each CTA's threads run as std::threads,
``__syncthreads`` is a std::barrier, a TMA bulk copy a plain copy, and each
mbarrier counts arrivals and bytes (a wrong byte count aborts). At tiny
ragged shapes, on a few CTAs (so that the persistent grid's round-robin
units and the even split of the rest both occur), its output must equal
the per-output fmaf chain it keeps (``fss_pivot_fwd_chain``, the order of
the previous forward kernel) up to the sign of zero, and lie within
1e-5 * max|y| of the plain version (``pivot_conv_flat_reference``, two
conv2d; another summation order). The emulation cannot see races between
the card's asynchronous copies, nor its timing. Skips only where g++ is
missing.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from few_shot_seg_cwt_tpu_torch.ops import cuda_build
from few_shot_seg_cwt_tpu_torch.ops.cuda_pivot import (MAX_SMEM_BYTES, flatten_weights,
                                                       pivot_conv_flat_reference)

torch.set_num_threads(1)

_SOURCE = cuda_build.CSRC / "pivot_fwd_emulated.cpp"


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernel's emulation")
    out = tmp_path_factory.mktemp("pivot_fwd_emu") / "libfss_pivot_fwd_emu.so"
    subprocess.run([gxx, "-std=c++20", "-O1", "-pthread", "-ffp-contract=off", "-shared",
                    "-fPIC", "-o", str(out), str(_SOURCE)], check=True, timeout=300)
    lib = ctypes.CDLL(str(out))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fss_pivot_fwd_emulated.argtypes = [p] * 4 + [i] * 9
    lib.fss_pivot_fwd_emulated.restype = i
    lib.fss_pivot_fwd_chain.argtypes = [p] * 4 + [i] * 8
    lib.fss_pivot_fwd_chain.restype = None
    lib.fss_pivot_fwd_emulated_plan.argtypes = [i] * 4 + [p]
    lib.fss_pivot_fwd_emulated_plan.restype = ctypes.c_longlong
    return lib


def _plan(lib, ci, co, hs, ws):
    out = (ctypes.c_int * 3)()
    smem = lib.fss_pivot_fwd_emulated_plan(ci, co, hs, ws, ctypes.addressof(out))
    return {"positions": out[0], "rows": out[1], "threads": out[2], "smem": smem}


@pytest.mark.parametrize("b,ci,co,dims,blocks,relu", [
    (2, 3, 4, (5, 6, 4, 7), 3, True),      # every plane edge distinct; rest split mid-row
    (2, 10, 1, (2, 3, 13, 60), 9, False),  # rows cut by shared memory: 2 tiles; bulk copies;
                                           # 9 CTAs, 8 units: runs cross qi, tile and b
    (1, 2, 10, (3, 3, 23, 60), 4, True),   # Co = 10, 256 threads, a partial last tile
    (2, 1, 10, (3, 4, 5, 13), 2, False),   # Ci = 1, B = 2, rows copied by the threads
])
def test_emulated_kernel_gives_the_chain_and_the_plain_values(lib, b, ci, co, dims, blocks,
                                                              relu):
    rng = np.random.default_rng(7)
    hq, wq, hs, ws = dims
    x = rng.standard_normal((b, ci, hq * wq, hs * ws)).astype(np.float32)
    wa, wb = (rng.standard_normal((2, 3, 3, ci, co)) / np.sqrt(18 * ci)).astype(np.float32)
    bias = rng.standard_normal(co).astype(np.float32)
    w = flatten_weights(torch.tensor(wa), torch.tensor(wb)).numpy()
    y = np.full((b, co, hq * wq, hs * ws), np.nan, dtype=np.float32)
    chain = y.copy()
    args = (x.ctypes.data, w.ctypes.data, bias.ctypes.data)
    assert lib.fss_pivot_fwd_emulated(*args, y.ctypes.data, b, ci, co, *dims, int(relu),
                                      blocks) == 0
    lib.fss_pivot_fwd_chain(*args, chain.ctypes.data, b, ci, co, *dims, int(relu))
    assert np.array_equal(y, chain)            # -0.0 == 0.0: equal up to the sign of zero
    plain = pivot_conv_flat_reference(torch.tensor(x), torch.tensor(wa), torch.tensor(wb),
                                      torch.tensor(bias), dims, relu).numpy()
    assert np.abs(y - plain).max() <= 1e-5 * np.abs(plain).max()


def test_layout_fits_the_main_path_and_refuses_what_a_block_cannot_hold(lib):
    """At 473 px every call of the MMN path fits a block, with the rows a
    tile, positions a thread and CTA size the design gives; Ci = 46 at
    ws = 60 does not fit even one support row (the wrapper refuses it)."""
    want = {(2, 10): (2, 8, 256), (10, 10): (2, 7, 224), (10, 1): (4, 7, 128),
            (10, 2): (4, 7, 128), (1, 10): (2, 8, 256)}
    for (ci, co), (p, rows, threads) in want.items():
        plan = _plan(lib, ci, co, 60, 60)
        assert plan["smem"] <= MAX_SMEM_BYTES
        assert (plan["positions"], plan["rows"], plan["threads"]) == (p, rows, threads)
    assert _plan(lib, 45, 4, 1, 60)["smem"] <= MAX_SMEM_BYTES < _plan(lib, 46, 4, 1, 60)["smem"]
    assert _plan(lib, 3, 4, 2, 7)["rows"] == 2     # at most hs rows a tile
