"""The port's VGG-16bn trunk, cosine and weight-norm classifiers, its
flax-style BatchNorm and ResNet-101 against the JAX package (CPU, 33 px).

Weights: the JAX package's own init with every BN field (scale, bias,
running mean and variance) perturbed by seeded numpy noise and, for the
classifiers, noise on the weight-norm magnitudes, biases and scale; carried
to the port by ``utils/convert.py`` and read back by the JAX importer
``import_pspnet`` unchanged. Tolerances: features and logits rtol 1e-3,
atol 1e-4 of the largest entry (fp32 convolutions summed in another order,
as ``tests/test_torch_engine.py`` holds the ResNet-50 features); the BN in
eval mode bit for bit against ``nn.BatchNorm2d``; its train-mode output and
running statistics against flax's within 1e-5 relative.
"""

import numpy as np
import pytest
import torch
import torch.nn as nn

import jax
import jax.numpy as jnp

from few_shot_seg_cwt_tpu.config import default_cfg as jax_default_cfg
from few_shot_seg_cwt_tpu.models.pspnet import build_pspnet as jax_build_pspnet
from few_shot_seg_cwt_tpu.models.resnet import batch_norm as jax_batch_norm
from few_shot_seg_cwt_tpu.utils.ckpt import import_pspnet
from few_shot_seg_cwt_tpu_torch.config import default_cfg
from few_shot_seg_cwt_tpu_torch.models.pspnet import build_pspnet, effective_classifier_weight
from few_shot_seg_cwt_tpu_torch.models.resnet import BatchNorm2d
from few_shot_seg_cwt_tpu_torch.utils.convert import pspnet_state_dict_from_flax

torch.set_num_threads(1)

SIZE = 33


def _perturb(tree, rng):
    """Seeded noise on every BN leaf and on the classifier's magnitudes,
    bias and scale of a numpy variables tree, in place."""
    for key, node in tree.items():
        if not isinstance(node, dict):
            continue
        if "scale" in node:
            node["scale"] = node["scale"] * rng.uniform(0.5, 1.5, node["scale"].shape).astype(np.float32)
            node["bias"] = node["bias"] + rng.normal(0, 0.1, node["bias"].shape).astype(np.float32)
        if "mean" in node:
            node["mean"] = node["mean"] + rng.normal(0, 0.1, node["mean"].shape).astype(np.float32)
            node["var"] = node["var"] * rng.uniform(0.5, 1.5, node["var"].shape).astype(np.float32)
        if key == "classifier":
            for leaf, scale in (("weight_g", 0.3), ("bias", 0.5), ("scale_factor", 0.5)):
                if leaf in node:
                    node[leaf] = (node[leaf] + rng.normal(0, scale, np.shape(node[leaf]))
                                  ).astype(np.float32)
        _perturb(node, rng)
    return tree


def _pair(**over):
    """(JAX model, perturbed numpy variables, port model in eval mode on
    the same weights)."""
    jcfg, tcfg = jax_default_cfg(), default_cfg()
    for cfg in (jcfg, tcfg):
        cfg.image_size, cfg.num_classes_tr = SIZE, 5
        for k, v in over.items():
            cfg[k] = v
    jmodel = jax_build_pspnet(jcfg)
    variables = jax.jit(lambda r, x: jmodel.init({"params": r}, x, train=False))(
        jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)))
    variables = _perturb(jax.tree.map(lambda x: np.array(x, np.float32), variables),
                         np.random.default_rng(7))
    port = build_pspnet(tcfg)
    port.load_state_dict(pspnet_state_dict_from_flax(variables, dist=tcfg.dist))
    return jmodel, variables, port.eval()


def _close(got, ref, rtol=1e-3, atol_frac=1e-4):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=rtol,
                               atol=atol_frac * float(np.abs(ref).max()))


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def _assert_round_trip(variables, port, arch):
    """The JAX importer reads the port's state_dict back to the variables."""
    back = import_pspnet(port.state_dict(), arch=arch)
    for coll in ("params", "batch_stats"):
        want, got = _flat(variables[coll]), _flat(back[coll])
        assert sorted(got) == sorted(want), coll
        for path, w in want.items():
            np.testing.assert_array_equal(got[path].reshape(w.shape), w, err_msg=str(path))


def _images(n=2, seed=4):
    return np.random.default_rng(seed).standard_normal((n, SIZE, SIZE, 3)).astype(np.float32)


@pytest.mark.parametrize("arch,dist,cls_type", [
    ("vgg", "dot", "oooo"),
    ("vgg", "cos", "oooo"),
    ("vgg", "cos", "rnbt"),
    ("resnet", "cosN", "ooo"),
    ("resnet", "dot", "rooo"),
])
def test_pspnet_forward_matches_jax(arch, dist, cls_type):
    """Features (trunk + PPM + bottleneck) and the zoomed logits of
    ``forward`` (JAX ``__call__``) for each trunk and classifier form."""
    jmodel, variables, port = _pair(arch=arch, dist=dist, cls_type=cls_type)
    x = _images()
    feat = jax.jit(lambda v, i: jmodel.apply(v, i, train=False,
                                             method=jmodel.extract_features))(
        variables, jnp.asarray(x))[0]
    logits = jax.jit(lambda v, i: jmodel.apply(v, i, train=False))(variables, jnp.asarray(x))
    with torch.no_grad():
        got_feat = port.extract_features(torch.from_numpy(x))
        got_logits = port(torch.from_numpy(x))
    h = 3 if arch == "vgg" else 5                     # stride 16 (ceil pools) / 8
    assert got_feat.shape == (2, h, h, 512)
    assert got_logits.shape == (2, SIZE, SIZE, 5)
    _close(got_feat.numpy(), feat)
    _close(got_logits.numpy(), logits)
    _assert_round_trip(variables, port, arch)
    # the weight the classifier applies, g v / ||v|| under weight norm
    w = np.asarray(variables["params"]["classifier"]["weight"])          # (C, K)
    if "weight_g" in variables["params"]["classifier"]:
        w = w * variables["params"]["classifier"]["weight_g"] / np.linalg.norm(w, axis=0)
    _close(effective_classifier_weight(port).detach().numpy(), w.T, rtol=1e-5, atol_frac=1e-6)


def test_vgg_block_taps_match_jax():
    """With ``rmid`` the VGG trunk returns each stage's output (stages 1-4)."""
    jmodel, variables, port = _pair(arch="vgg", rmid="l34")
    x = _images(1, seed=5)
    _, feats = jax.jit(lambda v, i: jmodel.apply(v, i, train=False,
                                                 method=jmodel.extract_features))(
        variables, jnp.asarray(x))
    with torch.no_grad():
        _, got = port.extract_features(torch.from_numpy(x))
    assert sorted(got) == sorted(feats) == [1, 2, 3, 4]
    for k in got:
        assert len(got[k]) == len(feats[k]) == 1
        _close(got[k][0].numpy(), feats[k][0])


def test_resnet101_features_match_jax():
    jmodel, variables, port = _pair(layers=101)
    x = _images(1, seed=6)
    ref = jax.jit(lambda v, i: jmodel.apply(v, i, train=False,
                                            method=jmodel.extract_features))(
        variables, jnp.asarray(x))[0]
    with torch.no_grad():
        got = port.extract_features(torch.from_numpy(x))
    assert len(port.layer3) == 23
    _close(got.numpy(), ref)
    _assert_round_trip(variables, port, "resnet")


def test_batchnorm_eval_is_torch_batchnorm_bit_for_bit():
    rng = np.random.default_rng(1)
    fields = {"weight": rng.uniform(0.5, 1.5, 6), "bias": rng.normal(0, 0.1, 6),
              "running_mean": rng.normal(0, 0.1, 6), "running_var": rng.uniform(0.5, 1.5, 6)}
    ours, ref = BatchNorm2d(6), nn.BatchNorm2d(6)
    for m in (ours, ref):
        m.load_state_dict({k: torch.tensor(v, dtype=torch.float32) for k, v in fields.items()},
                          strict=False)
    x = torch.from_numpy(rng.standard_normal((3, 6, 7, 5)).astype(np.float32))
    assert torch.equal(ours.eval()(x), ref.eval()(x))


@pytest.mark.parametrize("shape", [(4, 3, 1, 1), (2, 5, 3, 4)])
def test_batchnorm_train_updates_running_stats_as_flax(shape):
    """Two train-mode calls: the same output as flax's BatchNorm and the
    biased-variance running update (torch's own would fold in n/(n-1);
    n = 4 in the 1x1 case, as in the PPM's bin-1 branch)."""
    rng = np.random.default_rng(3)
    xs = [rng.standard_normal(shape).astype(np.float32) * 2 + 1 for _ in range(2)]
    c = shape[1]
    port = BatchNorm2d(c).train()
    jbn = jax_batch_norm(train=True)
    nhwc = [jnp.asarray(x.transpose(0, 2, 3, 1)) for x in xs]
    variables = jbn.init(jax.random.PRNGKey(0), nhwc[0])
    for x, xj in zip(xs, nhwc):
        ref, mutated = jbn.apply(variables, xj, mutable=["batch_stats"])
        variables = {"params": variables["params"], **mutated}
        got = port(torch.from_numpy(x))
        _close(got.detach().numpy().transpose(0, 2, 3, 1), ref, rtol=1e-5, atol_frac=1e-6)
    stats = variables["batch_stats"]
    np.testing.assert_allclose(port.running_mean.numpy(), stats["mean"], rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(port.running_var.numpy(), stats["var"], rtol=1e-5, atol=1e-7)
    torch_bn = nn.BatchNorm2d(c).train()
    for x in xs:
        torch_bn(torch.from_numpy(x))
    assert not np.allclose(torch_bn.running_var.numpy(), stats["var"], rtol=1e-3)
