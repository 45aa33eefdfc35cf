"""The CUDA inner-loop kernel against its plain version, on the card.

Marked ``cuda``: each test skips when no CUDA device is present (decided in
the fixture, not at import). Run them on a machine with an H100 and nvcc:

    python -m pytest tests/test_torch_cuda_kernels.py -q -m cuda

Tolerance: max|acc_kernel - acc_plain| <= 1e-4 * max|acc_plain| (fp32; the
kernel sums the channel and pixel contractions in another order than
cuBLAS, and 200 steps compound it).
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
