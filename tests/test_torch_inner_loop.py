"""PyTorch port vs the JAX package: the episodic inner loop (CPU).

On the CPU the port's ``adapt_binary`` and ``adapt_binary_tiled`` run their
plain version; here they are held against the JAX closed form (the XLA scan
of ``_adapt_binary``) and against the Pallas kernels themselves (K1 and the
episode-tiled K2) in interpret mode, run as ``tests/test_inner_loop.py``
runs them. Tolerances are the JAX suite's for the inner loop: rtol 1e-4,
atol 1e-6 (fp32 sums in another order over the steps). The tile dispatch
(``pick_tile``) is held against the JAX ``_pick_tile``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from few_shot_seg_cwt_tpu.episodic.inner_loop import adapt_classifier as jax_adapt
from few_shot_seg_cwt_tpu.episodic.inner_loop import support_loss as jax_support_loss
from few_shot_seg_cwt_tpu.ops.losses import class_balance_weights as jax_cbw
from few_shot_seg_cwt_tpu.ops.pallas_inner_loop import (_pick_tile, _vmem_need_tiled,
                                                       adapt_binary_pallas,
                                                       adapt_binary_pallas_tiled)
from few_shot_seg_cwt_tpu_torch.episodic import inner_loop as port_inner_loop
from few_shot_seg_cwt_tpu_torch.episodic.inner_loop import (
    adapt_binary_batch,
    adapt_classifier,
    adapt_classifier_batch,
    binary_pixel_weights,
    pick_tile,
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


# --------------------------------------------------------------------------- #
# K2: the episode-tiled kernel and its dispatch
# --------------------------------------------------------------------------- #


def _tiled_episodes():
    """Four 1-shot episodes that differ in label layout and u0 (the shapes
    of tests/test_inner_loop.py's tiled-kernel test), so that a swap of two
    episodes inside a tile changes the result."""
    rng = np.random.default_rng(80)
    eps = []
    for i in range(4):
        f_s, s_label, _ = _episode(np.random.default_rng(50 + i), shot=1)
        s_label[0, : 2 + 3 * i, :] = 255
        cw = np.asarray(jax_cbw(jnp.asarray(s_label)))
        y = (s_label == 1).astype(np.float32)
        pw = (np.where(s_label == 1, cw[1], cw[0]) * (s_label != 255)).astype(np.float32)
        pw = (pw / pw.sum()).astype(np.float32)
        u0 = rng.standard_normal(16).astype(np.float32)
        eps.append((f_s, pw, (pw * y).astype(np.float32), u0))
    return [np.stack([e[k] for e in eps]) for k in range(4)]


def test_plain_adapt_binary_tiled_matches_pallas_tiled_kernel_interpret():
    """The port's adapt_binary_tiled (plain on the CPU) equals the TPU kernel
    it replaces, ``adapt_binary_pallas_tiled`` at tile 2 in interpret mode,
    episode for episode; the episodes' results all differ."""
    f_s, pw, pwy, u0 = _tiled_episodes()
    ref = np.asarray(adapt_binary_pallas_tiled(
        jnp.asarray(f_s), jnp.asarray(pw), jnp.asarray(pwy), jnp.asarray(u0),
        num_steps=25, lr=0.1, tile=2, interpret=True))
    before = dict(cuda_inner_loop.LAUNCHES)
    got = cuda_inner_loop.adapt_binary_tiled(
        *(torch.from_numpy(a) for a in (f_s, pw, pwy, u0)), 25, 0.1, 2).numpy()
    assert cuda_inner_loop.LAUNCHES == before  # plain path: no launch
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    for i in range(4):
        for j in range(i):
            assert np.abs(ref[i] - ref[j]).max() > 100 * ATOL, (i, j)


def test_adapt_binary_tiled_refuses_what_k2_does_not_take():
    f_s, pw, pwy, u0 = (torch.from_numpy(a) for a in _tiled_episodes())
    with pytest.raises(ValueError, match="E % tile"):
        cuda_inner_loop.adapt_binary_tiled(f_s[:3], pw[:3], pwy[:3], u0[:3], 2, 0.1, 2)
    two_shot = f_s.reshape(2, 2, *f_s.shape[2:])
    with pytest.raises(ValueError, match="shot 1"):
        cuda_inner_loop.adapt_binary_tiled(two_shot, pw.reshape(2, 2, 25, 25),
                                           pwy.reshape(2, 2, 25, 25), u0[:2], 2, 0.1, 2)
    with pytest.raises(TypeError):
        cuda_inner_loop.adapt_binary_tiled(f_s.double(), pw, pwy, u0, 2, 0.1, 2)


@pytest.mark.parametrize("want", ["1", "2", "3", "4"])
def test_pick_tile_matches_jax_where_both_budgets_admit_the_tile(monkeypatch, want):
    """At small shapes every tile fits both Hopper's 232,448 B block and the
    TPU's 127 MiB of VMEM, and the port picks what the JAX package picks."""
    monkeypatch.setenv("FSS_INNER_TILE", want)
    for e in (1, 2, 3, 4, 6, 8, 12):
        for shot in (1, 2):
            got = pick_tile(e, shot, 6, 6, 16, 25)
            assert got == _pick_tile(e, shot, 6, 6, 16, 25, 25), (want, e, shot)


def test_pick_tile_at_473_px_fits_two_where_the_tpu_fits_four(monkeypatch):
    """At 473 px (60x60x512 features) tile 4 needs 304,640 B of shared
    memory, over a block's 232,448 B, where the TPU's VMEM holds it; the port
    falls back to tile 2, as the JAX rule does when 4 does not fit."""
    shape = (1, 60, 60, 512, 473)
    assert cuda_inner_loop.smem_bytes(60, 60, 512, 473, 1) == 103_616
    assert cuda_inner_loop.smem_bytes(60, 60, 512, 473, 2) == 170_624
    assert cuda_inner_loop.smem_bytes(60, 60, 512, 473, 4) == 304_640
    assert _vmem_need_tiled(4, 60, 60, 512, 473, 473) < 127 * 1024 * 1024
    for want, port, jax_tile in (("2", 2, 2), ("4", 2, 4)):
        monkeypatch.setenv("FSS_INNER_TILE", want)
        assert pick_tile(8, *shape) == port
        assert _pick_tile(8, 1, 60, 60, 512, 473, 473) == jax_tile
    monkeypatch.delenv("FSS_INNER_TILE")
    assert pick_tile(8, *shape) == 1


@pytest.mark.parametrize("want,tiled_calls", [("1", 0), ("2", 1)])
def test_batched_dispatch_takes_k2_only_when_the_tile_is_above_one(monkeypatch, want,
                                                                   tiled_calls):
    """adapt_binary_batch calls adapt_binary_tiled with the picked tile under
    FSS_INNER_TILE=2 (K1 otherwise, and always for a batch of one), and both
    give the same weights."""
    monkeypatch.setenv("FSS_INNER_TILE", want)
    calls = []
    real = port_inner_loop.adapt_binary_tiled
    monkeypatch.setattr(port_inner_loop, "adapt_binary_tiled",
                        lambda *a: calls.append(a[-1]) or real(*a))
    rng = np.random.default_rng(90)
    eps = [_episode(rng, shot=1) for _ in range(4)]
    args = [torch.from_numpy(np.stack([e[k] for e in eps])) for k in range(3)]
    got = adapt_binary_batch(*args, num_steps=10, lr=0.1)
    assert calls == [2] * tiled_calls
    one = adapt_binary_batch(*(a[:1] for a in args), num_steps=10, lr=0.1)
    assert calls == [2] * tiled_calls
    monkeypatch.setenv("FSS_INNER_TILE", "1")
    ref = adapt_binary_batch(*args, num_steps=10, lr=0.1)
    torch.testing.assert_close(got, ref, rtol=0, atol=0)
    torch.testing.assert_close(one[0], ref[0], rtol=RTOL, atol=ATOL)
