"""PyTorch port vs the JAX package: resize/pool, losses, metrics, synthetic
episodes and config (CPU, small shapes).

Tolerance: float results agree within 1e-6 of the reference's scale
(rtol 1e-6, atol 1e-6 * max|ref|): the same fp32 formulas summed in another
order. Integer results (I/U areas, episodes, matrices) must be identical.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from few_shot_seg_cwt_tpu.config import default_cfg as jax_default_cfg
from few_shot_seg_cwt_tpu.config import load_cfg as jax_load_cfg
from few_shot_seg_cwt_tpu.config import merge_cfg_from_list as jax_merge
from few_shot_seg_cwt_tpu.data import synthetic as jsyn
from few_shot_seg_cwt_tpu.ops import losses as jl
from few_shot_seg_cwt_tpu.ops import metrics as jm
from few_shot_seg_cwt_tpu.ops import resize as jr
from few_shot_seg_cwt_tpu_torch.config import default_cfg, load_cfg, merge_cfg_from_list
from few_shot_seg_cwt_tpu_torch.data import synthetic as tsyn
from few_shot_seg_cwt_tpu_torch.ops import losses as tl
from few_shot_seg_cwt_tpu_torch.ops import metrics as tm
from few_shot_seg_cwt_tpu_torch.ops import resize as tr

torch.set_num_threads(1)


def _close(got, ref, rtol=1e-6):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    scale = max(float(np.abs(ref).max()), 1e-30)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * scale)


@pytest.mark.parametrize("out_size,in_size", [(33, 5), (473, 60), (1, 4), (7, 1), (6, 6)])
def test_resize_matrices_identical(out_size, in_size):
    np.testing.assert_array_equal(tr.interp_matrix_align_corners(out_size, in_size),
                                  jr.interp_matrix_align_corners(out_size, in_size))
    np.testing.assert_array_equal(tr.adaptive_pool_matrix(out_size, in_size),
                                  jr.adaptive_pool_matrix(out_size, in_size))


@pytest.mark.parametrize("shape,out_hw", [
    ((2, 5, 5, 3), (33, 33)),
    ((5, 7, 2), (9, 13)),
    ((6, 4), (11, 3)),
    ((1, 60, 60, 1), (60, 60)),
])
def test_upsample_bilinear_ac_matches_jax(shape, out_hw):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    if len(shape) == 2:  # (H, W) takes the matrices directly
        ref = jr._sep_apply(jnp.asarray(x), jr.interp_matrix_align_corners(out_hw[0], shape[0]),
                            jr.interp_matrix_align_corners(out_hw[1], shape[1]))
        got = tr._sep_apply(torch.from_numpy(x), tr.interp_matrix_align_corners(out_hw[0], shape[0]),
                            tr.interp_matrix_align_corners(out_hw[1], shape[1]))
    else:
        ref = jr.upsample_bilinear_ac(jnp.asarray(x), out_hw)
        got = tr.upsample_bilinear_ac(torch.from_numpy(x), out_hw)
    _close(got.numpy(), ref)


@pytest.mark.parametrize("bins", [1, 2, 3, 6])
def test_adaptive_avg_pool_matches_jax_and_torch(bins):
    x = np.random.default_rng(1).standard_normal((2, 7, 9, 4)).astype(np.float32)
    ref = jr.adaptive_avg_pool(jnp.asarray(x), (bins, bins))
    got = tr.adaptive_avg_pool(torch.from_numpy(x), (bins, bins))
    _close(got.numpy(), ref)
    # and nn.AdaptiveAvgPool2d, whose semantics both claim
    native = torch.nn.functional.adaptive_avg_pool2d(
        torch.from_numpy(x).permute(0, 3, 1, 2), bins).permute(0, 2, 3, 1)
    _close(got.numpy(), native.numpy())


@pytest.mark.parametrize("shape,out_hw", [((9, 7), (33, 20)), ((2, 9, 7, 3), (4, 5))])
def test_resize_nearest_matches_jax(shape, out_hw):
    x = np.random.default_rng(2).integers(0, 255, size=shape).astype(np.int32)
    ref = jr.resize_nearest(jnp.asarray(x), out_hw)
    got = tr.resize_nearest(torch.from_numpy(x), out_hw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("k", [2, 5])
def test_weighted_cross_entropy_matches_jax(k):
    rng = np.random.default_rng(3)
    logits = (rng.standard_normal((2, 13, 11, k)) * 3).astype(np.float32)
    target = rng.choice(list(range(k)) + [255], size=(2, 13, 11)).astype(np.int32)
    cw = rng.uniform(0.5, 3.0, k).astype(np.float32)
    ref = jl.weighted_cross_entropy(jnp.asarray(logits), jnp.asarray(target), jnp.asarray(cw))
    got = tl.weighted_cross_entropy(torch.from_numpy(logits), torch.from_numpy(target),
                                    torch.from_numpy(cw))
    _close(got.numpy(), ref)


def test_binary_ce_from_diff_matches_jax():
    rng = np.random.default_rng(4)
    diff = (rng.standard_normal((37, 41)) * 4).astype(np.float32)
    target = rng.choice([0, 1, 255], size=(37, 41), p=[0.45, 0.45, 0.1]).astype(np.int32)
    cw = np.asarray([1.0, 2.7], np.float32)
    ref = jl.binary_weighted_ce_from_diff(jnp.asarray(diff), jnp.asarray(target), jnp.asarray(cw))
    got = tl.binary_weighted_ce_from_diff(torch.from_numpy(diff), torch.from_numpy(target),
                                          torch.from_numpy(cw))
    _close(got.numpy(), ref)


@pytest.mark.parametrize("tp", [1.0, 0.5])
def test_class_balance_weights_matches_jax(tp):
    label = np.random.default_rng(5).choice([0, 1, 255], size=(2, 17, 19),
                                            p=[0.6, 0.3, 0.1]).astype(np.int32)
    ref = jl.class_balance_weights(jnp.asarray(label), tp=tp)
    got = tl.class_balance_weights(torch.from_numpy(label), tp=tp)
    _close(got.numpy(), ref)


@pytest.mark.parametrize("k", [2, 5])
def test_intersection_and_union_matches_jax_exactly(k):
    rng = np.random.default_rng(6)
    preds = rng.integers(0, k, size=(33, 33)).astype(np.int32)
    target = rng.choice(list(range(k)) + [255], size=(33, 33)).astype(np.int32)
    ref = jm.intersection_and_union(jnp.asarray(preds), jnp.asarray(target), k)
    got = tm.intersection_and_union(torch.from_numpy(preds), torch.from_numpy(target), k)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    # a leading batch axis gives each item's areas
    batched = tm.intersection_and_union(torch.from_numpy(np.stack([preds, preds])),
                                        torch.from_numpy(np.stack([target, target])), k)
    for g, r in zip(batched, ref):
        np.testing.assert_array_equal(g.numpy(), np.stack([np.asarray(r)] * 2))


def test_synthetic_episodes_match_jax_copy_bit_for_bit():
    for size, shot in [(33, 1), (41, 3)]:
        got = tsyn.make_episode_batch(5, 3, size=size, shot=shot)
        ref = jsyn.make_episode_batch(5, 3, size=size, shot=shot)
        assert got.keys() == ref.keys()
        for k in ref:
            assert got[k].dtype == ref[k].dtype, k
            np.testing.assert_array_equal(got[k], ref[k])
    cfg_t, cfg_j = default_cfg(), jax_default_cfg()
    cfg_t.image_size = cfg_j.image_size = 33
    ds_t = tsyn.SyntheticEpisodicDataset(cfg_t, length=8, seed=2)
    ds_j = jsyn.SyntheticEpisodicDataset(cfg_j, length=8, seed=2)
    for i in (0, 7):
        for k, v in ds_j[i].items():
            np.testing.assert_array_equal(ds_t[i][k], v)


def test_sequential_batches_follow_the_jax_loader_order():
    from few_shot_seg_cwt_tpu.data.loader import EpisodeLoader, infinite

    cfg_t, cfg_j = default_cfg(), jax_default_cfg()
    cfg_t.image_size = cfg_j.image_size = 17
    ds_t = tsyn.SyntheticEpisodicDataset(cfg_t, length=7, seed=3)
    ds_j = jsyn.SyntheticEpisodicDataset(cfg_j, length=7, seed=3)
    ours = iter(tsyn.SequentialBatches(ds_t, 3))
    theirs = infinite(EpisodeLoader(ds_j, batch_size=3, shuffle=False, num_workers=0))
    for _ in range(5):  # wraps around after 2 batches, dropping the tail
        a, b = next(ours), next(theirs)
        np.testing.assert_array_equal(a["cls"], b["cls"])
        np.testing.assert_array_equal(a["q_label"], b["q_label"])


def test_config_copy_matches_jax_config():
    assert dict(default_cfg()) == dict(jax_default_cfg())
    opts = ["shot", "5", "cls_lr", "0.1", "synthetic_data", "True", "bins", "[1, 2]"]
    for name in ("pascal.yaml", "coco.yaml", "synthetic_smoke.yaml"):
        got = merge_cfg_from_list(load_cfg(f"configs/{name}"), opts)
        ref = jax_merge(jax_load_cfg(f"configs/{name}"), opts)
        assert dict(got) == dict(ref), name
    with pytest.raises(AssertionError):
        merge_cfg_from_list(default_cfg(), ["no_such_key", "1"])
