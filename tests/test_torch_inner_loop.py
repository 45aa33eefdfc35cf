"""PyTorch port vs the JAX package: the episodic inner loop (CPU).

On the CPU the port's ``adapt_binary`` runs its plain version; here it is
held against the JAX closed form (the XLA scan of ``_adapt_binary``) and
against the Pallas kernel itself in interpret mode, run as
``tests/test_inner_loop.py`` runs it. Tolerances are the JAX suite's for the
inner loop: rtol 1e-4, atol 1e-6 (fp32 sums in another order over the
steps).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from few_shot_seg_cwt_tpu.episodic.inner_loop import adapt_classifier as jax_adapt
from few_shot_seg_cwt_tpu.episodic.inner_loop import support_loss as jax_support_loss
from few_shot_seg_cwt_tpu.ops.losses import class_balance_weights as jax_cbw
from few_shot_seg_cwt_tpu.ops.pallas_inner_loop import adapt_binary_pallas
from few_shot_seg_cwt_tpu_torch.episodic.inner_loop import (
    adapt_binary_batch,
    adapt_classifier,
    adapt_classifier_batch,
    binary_pixel_weights,
    support_loss,
)
from few_shot_seg_cwt_tpu_torch.ops import cuda_build, cuda_inner_loop
from few_shot_seg_cwt_tpu_torch.ops.losses import class_balance_weights

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-6


def _episode(rng, shot=2, h=6, big=25, c=16, k=2):
    f_s = rng.standard_normal((shot, h, h, c)).astype(np.float32)
    s_label = rng.integers(0, k, size=(shot, big, big)).astype(np.int32)
    s_label[0, :3, :] = 255
    w0 = rng.uniform(-0.25, 0.25, size=(k, c)).astype(np.float32)
    return f_s, s_label, w0


@pytest.mark.parametrize("shot", [1, 2])
def test_plain_adapt_binary_matches_jax_scan(shot):
    """The batched plain closed form equals the JAX closed form (XLA scan)
    of each episode."""
    rng = np.random.default_rng(10 + shot)
    eps = [_episode(rng, shot=shot) for _ in range(3)]
    got = adapt_binary_batch(
        torch.from_numpy(np.stack([e[0] for e in eps])),
        torch.from_numpy(np.stack([e[1] for e in eps])),
        torch.from_numpy(np.stack([e[2] for e in eps])), num_steps=30, lr=0.1)
    for i, (f_s, s_label, w0) in enumerate(eps):
        ref = jax_adapt(jnp.asarray(f_s), jnp.asarray(s_label), jnp.asarray(w0),
                        num_steps=30, lr=0.1)
        np.testing.assert_allclose(got[i].numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


def test_plain_adapt_binary_matches_pallas_kernel_interpret():
    """The port's adapt_binary (plain on the CPU) equals the TPU kernel it
    replaces, run in Pallas interpret mode, accumulator for accumulator."""
    rng = np.random.default_rng(20)
    f_s, s_label, w0 = _episode(rng, shot=2)
    cw = np.asarray(jax_cbw(jnp.asarray(s_label)))
    valid = s_label != 255
    y = (s_label == 1).astype(np.float32)
    pw = (np.where(s_label == 1, cw[1], cw[0]) * valid).astype(np.float32)
    pw = (pw / pw.sum()).astype(np.float32)
    u0 = (w0[1] - w0[0]).astype(np.float32)
    ref = adapt_binary_pallas(jnp.asarray(f_s), jnp.asarray(pw), jnp.asarray(pw * y),
                              jnp.asarray(u0), num_steps=30, lr=0.1, interpret=True)
    got = cuda_inner_loop.adapt_binary(
        torch.from_numpy(f_s[None]), torch.from_numpy(pw[None]),
        torch.from_numpy((pw * y)[None]), torch.from_numpy(u0[None]), 30, 0.1)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)
    # the port's pixel weights are the ones the JAX dispatcher forms
    pw_t, pwy_t = binary_pixel_weights(torch.from_numpy(s_label[None]))
    np.testing.assert_allclose(pw_t[0].numpy(), pw, rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(pwy_t[0].numpy(), pw * y, rtol=1e-6, atol=1e-9)


def test_closed_form_matches_generic_autograd_loop():
    rng = np.random.default_rng(30)
    f_s, s_label, w0 = _episode(rng)
    args = (torch.from_numpy(f_s), torch.from_numpy(s_label), torch.from_numpy(w0))
    fast = adapt_classifier(*args, num_steps=40, lr=0.1, fast_binary=True)
    generic = adapt_classifier(*args, num_steps=40, lr=0.1, fast_binary=False)
    np.testing.assert_allclose(fast.numpy(), generic.numpy(), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("use_mask", [False, True])
def test_generic_loop_matches_jax(use_mask):
    """K=3 (and a row-masked K=3) generic autograd loop vs the JAX scan."""
    rng = np.random.default_rng(40)
    f_s, s_label, w0 = _episode(rng, k=3)
    mask = np.asarray([True, False, True]) if use_mask else None
    if use_mask:
        s_label = np.where(s_label == 1, 2, s_label).astype(np.int32)
    ref = jax_adapt(jnp.asarray(f_s), jnp.asarray(s_label), jnp.asarray(w0),
                    num_steps=20, lr=0.1,
                    row_mask=None if mask is None else jnp.asarray(mask))
    got = adapt_classifier(torch.from_numpy(f_s), torch.from_numpy(s_label),
                           torch.from_numpy(w0), num_steps=20, lr=0.1,
                           row_mask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)
    batched = adapt_classifier_batch(torch.from_numpy(f_s[None]), torch.from_numpy(s_label[None]),
                                     torch.from_numpy(w0[None]), 20, 0.1)
    if mask is None:
        np.testing.assert_allclose(batched[0].numpy(), got.numpy(), rtol=1e-6, atol=1e-7)


def test_support_loss_matches_jax():
    rng = np.random.default_rng(50)
    f_s, s_label, w0 = _episode(rng)
    cw = np.array(jax_cbw(jnp.asarray(s_label)))
    ref = jax_support_loss(jnp.asarray(w0), jnp.asarray(f_s), jnp.asarray(s_label),
                           jnp.asarray(cw))
    got = support_loss(torch.from_numpy(w0), torch.from_numpy(f_s),
                       torch.from_numpy(s_label), torch.from_numpy(cw))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5)
    np.testing.assert_allclose(class_balance_weights(torch.from_numpy(s_label)).numpy(),
                               cw, rtol=1e-6)


def test_padded_shots_are_no_ops():
    """All-255 padding shots change neither the closed form nor the generic
    loop."""
    rng = np.random.default_rng(60)
    f_s, s_label, w0 = _episode(rng, shot=1)
    pad_f = np.concatenate([f_s, rng.standard_normal(f_s.shape).astype(np.float32)])
    pad_l = np.concatenate([s_label, np.full_like(s_label, 255)])
    for fast in (True, False):
        plain = adapt_classifier(torch.from_numpy(f_s), torch.from_numpy(s_label),
                                 torch.from_numpy(w0), num_steps=10, lr=0.1, fast_binary=fast)
        padded = adapt_classifier(torch.from_numpy(pad_f), torch.from_numpy(pad_l),
                                  torch.from_numpy(w0), num_steps=10, lr=0.1, fast_binary=fast)
        np.testing.assert_allclose(padded.numpy(), plain.numpy(), rtol=1e-6, atol=1e-7)


def test_adapt_binary_checks_its_inputs_and_counts_no_cpu_launch():
    rng = np.random.default_rng(70)
    f = torch.from_numpy(rng.standard_normal((2, 1, 4, 4, 8)).astype(np.float32))
    pw = torch.full((2, 1, 9, 9), 1.0 / 81)
    pwy = torch.zeros((2, 1, 9, 9))
    u0 = torch.zeros((2, 8))
    before = cuda_inner_loop.LAUNCHES["adapt_binary"]
    assert cuda_inner_loop.adapt_binary(f, pw, pwy, u0, 3, 0.1).shape == (2, 8)
    assert cuda_inner_loop.LAUNCHES["adapt_binary"] == before  # plain path: no launch
    with pytest.raises(TypeError):
        cuda_inner_loop.adapt_binary(f.double(), pw, pwy, u0, 3, 0.1)
    with pytest.raises(ValueError):
        cuda_inner_loop.adapt_binary(f, pw, pwy, torch.zeros((2, 7)), 3, 0.1)
    with pytest.raises(ValueError):
        cuda_inner_loop.adapt_binary(f, pw.transpose(-1, -2), pwy, u0, 3, 0.1)
    with pytest.raises(ValueError):
        cuda_inner_loop.adapt_binary(f[0], pw, pwy, u0, 3, 0.1)


def test_kernel_source_and_build_command():
    """The kernel's build is nvcc for sm_90a into a hashed library name under
    the gitignored build directory; the source exports the C entry points the
    wrapper binds."""
    src = cuda_inner_loop._SOURCE.read_text()
    for sym in ("fss_adapt_binary(", "fss_adapt_binary_smem_bytes(", "fss_error_string("):
        assert sym in src
    assert "arch=compute_90a,code=sm_90a" in cuda_build.NVCC_FLAGS
    path = cuda_build.library_path(*cuda_inner_loop.build_spec())
    assert path.parent == cuda_build.BUILD_DIR and path.suffix == ".so"
    assert cuda_build.BUILD_DIR.relative_to(cuda_inner_loop._SOURCE.parents[2]).parts[0] == "build"


def test_plain_version_runs_in_float64():
    """The plain version runs in its inputs' dtype (float64 is the
    higher-precision witness ``chip_smoke.py`` holds both fp32 loops against)
    and agrees with the fp32 run at the inner loop's tolerance."""
    rng = np.random.default_rng(31)
    f_s, s_label, w0 = _episode(rng, shot=2)
    pw, pwy = binary_pixel_weights(torch.from_numpy(s_label[None]).long())
    f = torch.from_numpy(f_s[None])
    u0 = torch.from_numpy(w0[1:] - w0[:1])
    acc32 = cuda_inner_loop.adapt_binary_reference(f, pw, pwy, u0, 20, 0.1)
    acc64 = cuda_inner_loop.adapt_binary_reference(
        f.double(), pw.double(), pwy.double(), u0.double(), 20, 0.1)
    assert acc64.dtype == torch.float64
    np.testing.assert_allclose(acc32.numpy(), acc64.numpy(), rtol=RTOL, atol=ATOL)


def test_phase_clock_build_is_a_separate_library():
    """``-DFSS_PHASE_CLOCKS`` builds another library (own hashed name) whose
    source exports the per-phase cycle counters; the default build has none."""
    defines = ("-DFSS_PHASE_CLOCKS",)
    assert (cuda_build.library_path(*cuda_inner_loop.build_spec(defines))
            != cuda_build.library_path(*cuda_inner_loop.build_spec()))
    src = cuda_inner_loop._SOURCE.read_text()
    assert "fss_phase_cycles(" in src
    assert src.index("#ifdef FSS_PHASE_CLOCKS") < src.index("int fss_phase_cycles(")


def test_profile_phase_work_is_the_dense_product_count():
    """The profile tool's per-phase FMAs add up to the dense step count:
    d and acc (hwC each), T (h W w), D (H W h), gB (H W w), G (H h w)."""
    from few_shot_seg_cwt_tpu_torch.tools.profile_inner_loop import phase_work

    h, w, c, big_h, big_w = 5, 6, 16, 32, 48       # H a multiple of the row block
    fma = sum(p["fma"] for p in phase_work(h, w, c, big_h, big_w))
    assert fma == (2 * h * w * c + h * big_w * w + big_h * big_w * h
                   + big_h * big_w * w + big_h * h * w)
