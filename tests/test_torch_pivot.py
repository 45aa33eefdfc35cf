"""The port's centre-pivot conv pair (``ops/cuda_pivot.py``) against both
Pallas formulations of the JAX package, on the CPU.

On CPU tensors ``pivot_conv_flat`` runs its plain version (two ``F.conv2d``
over reshaped views) inside the same ``torch.autograd.Function`` whose
backward the card runs with the kernels: dx is the forward with flipped,
transposed weights, (dwa, dwb, db) the weight-gradient function. Both are
held against ``pallas_pivot.pivot_conv_flat`` (VPU form) and
``pallas_pivot_mxu.pivot_conv_flat_mxu`` (MXU form) in interpret mode, as
``tests/test_pallas_pivot.py`` runs them, at the non-square
DIMS (5, 6, 4, 7), Ci 3, Co 4, B 2. Tolerances (fp32, sums in another
order): forward rtol 1e-5 with atol 1e-5 for entries near zero; gradients
rtol 1e-4, atol 1e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from few_shot_seg_cwt_tpu.ops.pallas_pivot import pivot_conv_flat as jax_pivot_vpu
from few_shot_seg_cwt_tpu.ops.pallas_pivot_mxu import pivot_conv_flat_mxu as jax_pivot_mxu
from few_shot_seg_cwt_tpu_torch.ops import cuda_pivot

torch.set_num_threads(1)

DIMS = (5, 6, 4, 7)
CI, CO, B = 3, 4, 2
JAX_FORMS = {"vpu": jax_pivot_vpu, "mxu": jax_pivot_mxu}


@pytest.fixture(scope="module")
def inputs():
    """x, wa, wb, bias and a cotangent t, from a numpy seed."""
    rng = np.random.default_rng(7)
    hq, wq, hs, ws = DIMS
    x = rng.standard_normal((B, CI, hq * wq, hs * ws)).astype(np.float32)
    wa = rng.standard_normal((3, 3, CI, CO)).astype(np.float32)
    wb = rng.standard_normal((3, 3, CI, CO)).astype(np.float32)
    bias = rng.standard_normal((CO,)).astype(np.float32)
    t = rng.standard_normal((B, CO, hq * wq, hs * ws)).astype(np.float32)
    return x, wa, wb, bias, t


@pytest.fixture(scope="module")
def jax_results(inputs):
    """Forward (relu off/on) and the custom-VJP grads of sum(y * t) with relu,
    for each Pallas formulation in interpret mode."""
    x, wa, wb, bias, t = (jnp.asarray(a) for a in inputs)
    out = {}
    for name, fn in JAX_FORMS.items():
        for relu in (False, True):
            out[name, relu] = np.asarray(fn(x, wa, wb, bias, dims=DIMS, relu=relu,
                                            interpret=True))

        def loss(*args, fn=fn):
            return jnp.sum(fn(*args, dims=DIMS, relu=True, interpret=True) * t)

        out[name, "grads"] = [np.asarray(g) for g in
                              jax.grad(loss, argnums=(0, 1, 2, 3))(x, wa, wb, bias)]
    return out


def _torch(inputs, grad=False):
    return [torch.tensor(a, requires_grad=grad) for a in inputs[:4]]


@pytest.mark.parametrize("form", sorted(JAX_FORMS))
@pytest.mark.parametrize("relu", [False, True])
def test_plain_forward_matches_jax_kernels(inputs, jax_results, form, relu):
    x, wa, wb, bias = _torch(inputs)
    y = cuda_pivot.pivot_conv_flat(x, wa, wb, bias, DIMS, relu=relu)
    assert y.shape == (B, CO, DIMS[0] * DIMS[1], DIMS[2] * DIMS[3])
    np.testing.assert_allclose(y.numpy(), jax_results[form, relu], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("form", sorted(JAX_FORMS))
@pytest.mark.parametrize("route", ["function", "plain_autograd"])
def test_grads_match_jax_custom_vjp(inputs, jax_results, form, route):
    """``function``: the autograd.Function the card runs (its backward
    formula, with the plain versions inside on CPU tensors);
    ``plain_autograd``: autograd through the plain version, which
    ``chip_smoke.py`` holds the kernels against."""
    x, wa, wb, bias = _torch(inputs, grad=True)
    fn = (cuda_pivot.pivot_conv_flat if route == "function"
          else cuda_pivot.pivot_conv_flat_reference)
    y = fn(x, wa, wb, bias, DIMS, relu=True)
    (y * torch.from_numpy(inputs[4])).sum().backward()
    for name, got, want in zip(("dx", "dwa", "dwb", "db"), (x, wa, wb, bias),
                               jax_results[form, "grads"]):
        np.testing.assert_allclose(got.grad.numpy(), want, rtol=1e-4, atol=1e-5,
                                   err_msg=name)


def test_cpu_tensors_never_reach_the_kernel_library(inputs, monkeypatch):
    """On CPU tensors the wrappers run the plain versions and count nothing;
    the library is never built or loaded."""

    def refuse():
        raise AssertionError("kernel library loaded for CPU tensors")

    monkeypatch.setattr(cuda_pivot, "load_library", refuse)
    before = dict(cuda_pivot.LAUNCHES)
    x, wa, wb, bias = _torch(inputs, grad=True)
    cuda_pivot.pivot_conv_flat(x, wa, wb, bias, DIMS, relu=True).sum().backward()
    assert x.grad is not None and wa.grad is not None
    assert cuda_pivot.LAUNCHES == before


def test_weight_gradient_plain_version_equals_autograd(inputs):
    """``pivot_dw_reference`` (the kernel's plain twin) is autograd's weight
    gradient of the plain forward, in float64."""
    x, wa, wb, bias = (torch.tensor(a, dtype=torch.float64, requires_grad=True)
                       for a in inputs[:4])
    g = torch.tensor(inputs[4], dtype=torch.float64)
    (cuda_pivot.pivot_conv_flat_reference(x, wa, wb, bias, DIMS) * g).sum().backward()
    dwa, dwb, db = cuda_pivot.pivot_dw_reference(x.detach(), g, DIMS)
    for got, want in ((dwa, wa.grad), (dwb, wb.grad), (db, bias.grad)):
        torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


def test_flatten_weights_layout():
    """The kernel's weight layout: (ci, tap, co), taps 0-8 query plane and
    9-17 support plane, row-major within each 3x3."""
    wa = torch.arange(3 * 3 * 2 * 4, dtype=torch.float32).reshape(3, 3, 2, 4)
    wb = -wa - 1
    w = cuda_pivot.flatten_weights(wa, wb)
    assert w.shape == (2, 18, 4) and w.is_contiguous()
    for ci in range(2):
        for t in range(9):
            assert torch.equal(w[ci, t], wa[t // 3, t % 3, ci])
            assert torch.equal(w[ci, 9 + t], wb[t // 3, t % 3, ci])


def test_route_switches(monkeypatch):
    for var in ("FSS_PIVOT_MXU", "FSS_PIVOT_PALLAS", "FSS_DISABLE_PALLAS"):
        monkeypatch.delenv(var, raising=False)
    assert cuda_pivot.pivot_impl() is None
    assert not cuda_pivot.pivot_pallas_active((3, 3, 3))
    monkeypatch.setenv("FSS_PIVOT_MXU", "1")
    assert cuda_pivot.pivot_impl() == "mxu"
    assert cuda_pivot.pivot_pallas_active((3, 3, 3))
    assert not cuda_pivot.pivot_pallas_active((3, 5, 3))  # 5^4 blocks: no kernel
    monkeypatch.setenv("FSS_PIVOT_PALLAS", "1")
    assert cuda_pivot.pivot_impl() == "vpu"
    monkeypatch.setenv("FSS_DISABLE_PALLAS", "1")
    assert cuda_pivot.pivot_impl() is None
    assert not cuda_pivot.pivot_kernel_available((3,) * 4, (1,) * 4, (1,) * 4)


def test_kernel_source_and_build():
    """The pivot kernels build with nvcc for sm_90a into a hashed library in
    the gitignored build directory; the source exports the C entry points
    the wrapper binds, and the weight gradient uses no atomics (its result is
    the same from run to run)."""
    from few_shot_seg_cwt_tpu_torch.ops import cuda_build

    src = cuda_build.CSRC.joinpath("pivot.cu").read_text()
    for sym in ("fss_pivot_fwd(", "fss_pivot_dw(", "fss_pivot_dw_blocks(",
                "fss_pivot_fwd_smem_bytes(", "fss_pivot_dw_smem_bytes(",
                "fss_pivot_max_co(", "fss_pivot_error_string("):
        assert sym in src, sym
    assert "atomicAdd" not in src and "atomicCAS" not in src
    path = cuda_build.library_path(*cuda_pivot.build_spec())
    assert path.parent == cuda_build.BUILD_DIR and path.suffix == ".so"
