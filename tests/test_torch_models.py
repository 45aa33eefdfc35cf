"""PyTorch port vs the JAX package: the CWT transformer and the ResNet
bottleneck block (CPU, small widths), with weights carried by
``utils/convert.py``.

JAX inits are perturbed with seeded numpy noise (BN mean/var/scale/bias,
LayerNorm scale/bias) before converting, so a swapped field cannot pass.
Tolerances: CWT 1e-5 (deterministic fp32, three small matmuls and a
softmax); one bottleneck block rtol 1e-4, atol 1e-5 (fp32 convolutions
summed in another order).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from few_shot_seg_cwt_tpu.models.cwt import MultiHeadAttentionOne as JaxCWT
from few_shot_seg_cwt_tpu.models.resnet import Bottleneck as JaxBottleneck
from few_shot_seg_cwt_tpu.utils.ckpt import import_cwt
from few_shot_seg_cwt_tpu_torch.models.cwt import MultiHeadAttentionOne, build_cwt
from few_shot_seg_cwt_tpu_torch.models.resnet import Bottleneck
from few_shot_seg_cwt_tpu_torch.utils.convert import cwt_state_dict_from_flax

torch.set_num_threads(1)


def _np_tree(tree):
    return jax.tree.map(lambda x: np.array(x, dtype=np.float32), tree)


def _perturb_norms(tree, rng):
    """Seeded noise on every normalisation leaf (any dict holding 'scale',
    and every batch-stat mean/var) of a numpy variables tree, in place."""
    for key, node in tree.items():
        if not isinstance(node, dict):
            continue
        if "scale" in node:
            node["scale"] = node["scale"] * rng.uniform(0.5, 1.5, node["scale"].shape).astype(np.float32)
            node["bias"] = node["bias"] + rng.normal(0, 0.1, node["bias"].shape).astype(np.float32)
        if "mean" in node:
            node["mean"] = node["mean"] + rng.normal(0, 0.1, node["mean"].shape).astype(np.float32)
            node["var"] = node["var"] * rng.uniform(0.5, 1.5, node["var"].shape).astype(np.float32)
        _perturb_norms(node, rng)
    return tree


@pytest.mark.parametrize("n_head,d", [(1, 16), (2, 16), (1, 512)])
def test_cwt_matches_jax(n_head, d):
    rng = np.random.default_rng(n_head * 100 + d)
    q = rng.standard_normal((3, 2, d)).astype(np.float32)
    k = rng.standard_normal((3, 5, 5, d)).astype(np.float32)
    k /= np.linalg.norm(k, axis=-1, keepdims=True)
    jmod = JaxCWT(n_head=n_head, d_model=d, d_k=d, d_v=d, dropout=0.5)
    variables = _np_tree(jmod.init(jax.random.PRNGKey(0), jnp.asarray(q),
                                   jnp.asarray(k), jnp.asarray(k)))
    _perturb_norms(variables["params"], rng)
    ref = jmod.apply(variables, jnp.asarray(q), jnp.asarray(k), jnp.asarray(k),
                     deterministic=True)

    port = MultiHeadAttentionOne(n_head, d, d, d, dropout=0.5).eval()
    port.load_state_dict(cwt_state_dict_from_flax(variables))
    with torch.no_grad():
        got = port(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(k))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)

    # the state_dict carries the reference's names: the JAX importer reads it back
    back = import_cwt(port.state_dict())
    for path, leaf in jax.tree_util.tree_leaves_with_path(variables["params"]):
        node = back["params"]
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(np.asarray(node), leaf)


def test_cwt_dropout_is_off_in_eval_and_on_in_train():
    cfg = type("C", (dict,), {"__getattr__": dict.__getitem__})(
        bottleneck_dim=16, heads=1, manual_seed=0)
    port = build_cwt(cfg)
    q, k = torch.randn(2, 2, 16), torch.randn(2, 9, 16)
    port.eval()
    with torch.no_grad():
        assert torch.equal(port(q, k, k), port(q, k, k))
        port.train()
        gen = torch.Generator().manual_seed(0)
        assert not torch.equal(port(q, k, k, generator=gen), port(q, k, k, generator=gen))
        # the masks come from the generator passed in, not torch's global one
        a = port(q, k, k, generator=torch.Generator().manual_seed(1))
        torch.manual_seed(123)
        assert torch.equal(a, port(q, k, k, generator=torch.Generator().manual_seed(1)))
        with pytest.raises(ValueError, match="Generator"):
            port(q, k, k)


@pytest.mark.parametrize("stride,dilation", [(1, 1), (2, 1), (1, 2)])
def test_bottleneck_block_matches_jax(stride, dilation):
    rng = np.random.default_rng(7 + stride + 10 * dilation)
    x = rng.standard_normal((2, 9, 9, 32)).astype(np.float32)
    jmod = JaxBottleneck(planes=8, stride=stride, dilation=dilation, has_downsample=True)
    variables = _np_tree(jmod.init(jax.random.PRNGKey(1), jnp.asarray(x)))
    _perturb_norms(variables, rng)
    ref = jmod.apply(variables, jnp.asarray(x), train=False)

    p, s = variables["params"], variables["batch_stats"]
    sd = {}
    for name in ("conv1", "conv2", "conv3"):
        sd[f"{name}.weight"] = torch.from_numpy(p[name]["kernel"].transpose(3, 2, 0, 1).copy())
    sd["downsample.0.weight"] = torch.from_numpy(
        p["downsample_conv"]["kernel"].transpose(3, 2, 0, 1).copy())
    for name, tname in (("bn1", "bn1"), ("bn2", "bn2"), ("bn3", "bn3"),
                        ("downsample_bn", "downsample.1")):
        sd[f"{tname}.weight"] = torch.from_numpy(p[name]["scale"])
        sd[f"{tname}.bias"] = torch.from_numpy(p[name]["bias"])
        sd[f"{tname}.running_mean"] = torch.from_numpy(s[name]["mean"])
        sd[f"{tname}.running_var"] = torch.from_numpy(s[name]["var"])
    port = Bottleneck(32, 8, stride, dilation, has_downsample=True).eval()
    port.load_state_dict(sd, strict=False)
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5)
