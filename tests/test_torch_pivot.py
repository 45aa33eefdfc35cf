"""The port's centre-pivot conv pair (``ops/cuda_pivot.py``) against both
Pallas formulations of the JAX package, on the CPU.

On CPU tensors ``pivot_fwd`` runs its plain version (two ``F.conv2d``
over reshaped views) inside the same ``fss::pivot_fwd`` operator whose
gradient the card runs with the kernels: dx is the forward with flipped,
transposed weights, (dwa, dwb, db) the weight-gradient function. Both are
held against ``pallas_pivot.pivot_conv_flat`` (VPU form) and
``pallas_pivot_mxu.pivot_conv_flat_mxu`` (MXU form) in interpret mode, as
``tests/test_pallas_pivot.py`` runs them, at the non-square
DIMS (5, 6, 4, 7), Ci 3, Co 4, B 2. Tolerances (fp32, sums in another
order): forward rtol 1e-5 with atol 1e-5 for entries near zero; gradients
rtol 1e-4, atol 1e-5.

The card's weight-gradient kernel does its products on the tensor cores in
3xTF32 form; ``emulate_3xtf32_dw`` below repeats that arithmetic (operands
rounded as ``cvt.rna.tf32.f32`` rounds, three products, a step's tile of
positions summed in fp32, the tiles' partials in double) to check the
numerical design on the CPU. It does not run or check the kernel.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from few_shot_seg_cwt_tpu.ops.pallas_pivot import pivot_conv_flat as jax_pivot_vpu
from few_shot_seg_cwt_tpu.ops.pallas_pivot_mxu import pivot_conv_flat_mxu as jax_pivot_mxu
from few_shot_seg_cwt_tpu_torch.ops import cuda_pivot

torch.set_num_threads(1)

DIMS = (5, 6, 4, 7)
CI, CO, B = 3, 4, 2
DW_ROWS = 2   # support rows in one step of the card's pivot_dw (csrc/pivot.cu)
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
    y = cuda_pivot.pivot_fwd(x, wa, wb, bias, DIMS, relu=relu)
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
    fn = (cuda_pivot.pivot_fwd if route == "function"
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
    cuda_pivot.pivot_fwd(x, wa, wb, bias, DIMS, relu=True).sum().backward()
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
                "fss_pivot_fwd_smem_bytes(", "fss_pivot_dw_smem_bytes(", "fss_pivot_fwd_plan(",
                "fss_pivot_max_co(", "fss_pivot_dw_max_ci(", "fss_pivot_error_string("):
        assert sym in src, sym
    # the forward's body is a header of its own, which the build hash covers
    assert '#include "pivot_fwd.cuh"' in src
    fwd = cuda_build.CSRC.joinpath("pivot_fwd.cuh").read_text()
    for text in (src, fwd):
        assert "atomicAdd" not in text and "atomicCAS" not in text
    # the weight gradient runs on the tensor cores, split in 3xTF32 form
    assert "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32" in src
    assert "cvt.rna.tf32.f32" in src
    assert "wgmma.mma_async" not in src                                 # no wgmma
    # the forward stages its query window by TMA bulk copies on mbarriers
    assert "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes" in src
    path = cuda_build.library_path(*cuda_pivot.build_spec())
    assert path.parent == cuda_build.BUILD_DIR and path.suffix == ".so"


def test_library_path_covers_the_headers_beside_a_source(tmp_path):
    """A kernel source includes ``.cuh`` headers from its directory (pivot.cu
    includes pivot_fwd.cuh): editing one must change the library's name, so
    a stale build is never loaded."""
    from few_shot_seg_cwt_tpu_torch.ops import cuda_build

    src = tmp_path / "k.cu"
    src.write_text('#include "k_body.cuh"\n')
    header = tmp_path / "k_body.cuh"
    header.write_text("// one body\n")
    first = cuda_build.library_path(src, "libk")
    assert cuda_build.library_path(src, "libk") == first
    header.write_text("// another body\n")
    assert cuda_build.library_path(src, "libk") != first


# --------------------------------------------------------------------------- #
# the card kernel's 3xTF32 arithmetic, emulated
# --------------------------------------------------------------------------- #


def tf32_round(a: torch.Tensor) -> torch.Tensor:
    """fp32 -> TF32 as ``cvt.rna.tf32.f32`` rounds (to nearest, ties away
    from zero), on the int32 view: add 0x1000, clear the low 13 bits."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split_tf32(a: torch.Tensor):
    big = tf32_round(a)
    return big, tf32_round(a - big)


def emulate_3xtf32_dw(x: torch.Tensor, g: torch.Tensor, dims):
    """(dwa, dwb, db) as the card kernel forms them: A (the 18*Ci shifted
    copies of x, then a row of ones for db) and g split into TF32 big and
    small parts; big.big + big.small + small.big summed in fp32 over each
    step's tile (one (b, q) and DW_ROWS whole support rows); the tiles'
    partials summed in double."""
    hq, wq, hs, ws = dims
    b, ci = x.shape[:2]
    co = g.shape[1]
    v = x.reshape(b, ci, hq, wq, hs, ws)
    vq = F.pad(v, (0, 0, 0, 0, 1, 1, 1, 1))     # zero border of the query plane
    vs = F.pad(v, (1, 1, 1, 1))                 # and of the support plane
    rows = [vq[:, :, dh:dh + hq, dw:dw + wq] for dh in range(3) for dw in range(3)]
    rows += [vs[..., du:du + hs, dv:dv + ws] for du in range(3) for dv in range(3)]
    a = torch.stack(rows, 0).permute(0, 2, 1, 3, 4, 5, 6).reshape(18 * ci, b, hq * wq, hs, ws)
    a = torch.cat([a, torch.ones_like(a[:1])], 0)            # the db row
    gt = g.reshape(b, co, hq * wq, hs, ws).permute(1, 0, 2, 3, 4)
    tiles = -(-hs // DW_ROWS)
    pad = (0, 0, 0, tiles * DW_ROWS - hs)
    a = F.pad(a, pad).reshape(a.shape[0], b, hq * wq, tiles, DW_ROWS * ws)
    gt = F.pad(gt, pad).reshape(co, b, hq * wq, tiles, DW_ROWS * ws)
    (ab, as_), (gb, gs) = split_tf32(a), split_tf32(gt)
    per_tile = sum(torch.einsum("mbqtp,nbqtp->mnbqt", l, r)
                   for l, r in ((as_, gb), (ab, gs), (ab, gb)))
    out = per_tile.double().sum(dim=(2, 3, 4)).float()       # (18*Ci + 1, Co)
    taps = out[:18 * ci].reshape(2, 3, 3, ci, co)
    return taps[0], taps[1], out[18 * ci]


def test_tf32_rounding_is_round_to_nearest_ties_away():
    one = 1.0 + 2.0 ** -10                      # the first TF32 step above 1
    a = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -11 - 2.0 ** -23,
                      -(1.0 + 2.0 ** -11), 3.0e-3, 0.0], dtype=torch.float32)
    got = tf32_round(a)
    assert got[:4].tolist() == [1.0, one, 1.0, -one]
    assert (got.view(torch.int32) & 0x1FFF).eq(0).all()
    big, small = split_tf32(a)
    assert float((a - big - small).abs().max()) <= 2.0 ** -21 * float(a.abs().max())


def test_3xtf32_dw_is_within_the_chip_limit_of_fp64(inputs):
    """The card's accuracy limit on the pivot gradients (``chip_smoke.py``,
    the card tests): at most 4x as far from fp64 as the plain fp32 version,
    plus 2e-6 of the largest entry."""
    x, g = torch.from_numpy(inputs[0]), torch.from_numpy(inputs[4])
    emu = emulate_3xtf32_dw(x, g, DIMS)
    plain = cuda_pivot.pivot_dw_reference(x, g, DIMS)
    wide = cuda_pivot.pivot_dw_reference(x.double(), g.double(), DIMS)
    for name, e, p, w in zip(("dwa", "dwb", "db"), emu, plain, wide):
        err_e = float((e.double() - w).abs().max())
        err_p = float((p.double() - w).abs().max())
        assert err_e <= 4 * err_p + 2e-6 * float(w.abs().max()), (name, err_e, err_p)
        # and it keeps fp32's accuracy: a TF32 product alone would be ~1e-3 off
        assert err_e <= 1e-5 * float(w.abs().max()), (name, err_e)


@pytest.mark.parametrize("form", sorted(JAX_FORMS))
def test_3xtf32_dw_matches_jax_kernels(inputs, jax_results, form):
    """Against the JAX custom-VJP weight gradients of sum(relu(y) * t): the
    cotangent the kernel sees is t masked by the ReLU."""
    x, wa, wb, bias = _torch(inputs)
    y = cuda_pivot.pivot_conv_flat_reference(x, wa, wb, bias, DIMS)
    g = torch.from_numpy(inputs[4]) * (y > 0)
    emu = emulate_3xtf32_dw(x, g, DIMS)
    for name, got, want in zip(("dwa", "dwb", "db"), emu, jax_results[form, "grads"][1:]):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5, err_msg=name)
