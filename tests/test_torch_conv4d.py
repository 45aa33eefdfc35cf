"""The port's 4D convolutions and 6D correlation primitives against the JAX
package, on the CPU: the true ``Conv4d`` (its one route, ``q``) against
each of the JAX package's ``FSS_CONV4D_IM2COL`` routes (forward and
gradients, with and without the role swap), the 6D channels-last
``CenterPivotConv4d`` with strides, the flat layout's 6D fallback, the 6D
``mutual_matching`` and ``mutual_nn_filter``, ``spatial_descriptor`` and
``MSBlock``.

Inputs come from numpy seeds; weights are the JAX modules' own init with
seeded noise on every leaf, carried to the port by ``utils/convert.py``.
The JAX ``Conv4d`` differentiates through its custom VJP (``q``, ``qp`` and
``loop``) or autodiff (``gemm``); the port differentiates its forward with
autograd. Tolerances: rtol 1e-5 (atol 1e-5 of the output scale) for
forwards, rtol 1e-3 (atol 1e-3 of each gradient's largest entry) for
gradients.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from few_shot_seg_cwt_tpu.models.conv4d import CenterPivotConv4d as JaxPivot
from few_shot_seg_cwt_tpu.models.conv4d import Conv4d as JaxConv4d
from few_shot_seg_cwt_tpu.models.matching import spatial_descriptor as jax_descriptor
from few_shot_seg_cwt_tpu.models.msm import MSBlock as JaxMSBlock
from few_shot_seg_cwt_tpu.ops import corr as jax_corr
from few_shot_seg_cwt_tpu_torch.models.conv4d import (CenterPivotConv4d, Conv4d,
                                                      conv4d_im2col_mode)
from few_shot_seg_cwt_tpu_torch.models.matching import spatial_descriptor
from few_shot_seg_cwt_tpu_torch.models.msm import MSBlock
from few_shot_seg_cwt_tpu_torch.utils import tracing
from few_shot_seg_cwt_tpu_torch.ops.corr import mutual_matching, mutual_nn_filter
from few_shot_seg_cwt_tpu_torch.utils.convert import (matchnet_state_dict_from_flax,
                                                      msblock_state_dict_from_flax)

torch.set_num_threads(1)

DIMS = (4, 5, 3, 6)      # hq, wq, hs, ws all distinct: catches plane mix-ups
CI, CO, B = 2, 3, 2
ROUTES = ("q", "qp", "gemm", "loop")


def _noisy(tree, rng, scale=0.1):
    return jax.tree.map(lambda a: np.asarray(a, np.float32)
                        + rng.normal(0, scale, np.shape(a)).astype(np.float32), tree)


def _close(got, want, rtol, atol_frac):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=atol_frac * float(np.abs(want).max()))


@pytest.fixture(scope="module")
def volume():
    rng = np.random.default_rng(31)
    return rng.standard_normal((B,) + DIMS + (CI,)).astype(np.float32), rng


# --------------------------------------------------------------------------- #
# the true Conv4d
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def conv4d_pair(volume):
    x, rng = volume
    mod = JaxConv4d(out_channels=CO)
    params = _noisy(mod.init(jax.random.PRNGKey(3), jnp.asarray(x))["params"], rng)
    sd = matchnet_state_dict_from_flax({"ncons": {"conv4d_0": params}})
    port = Conv4d(CI, CO)
    port.load_state_dict({k[len("NeighConsensus.conv.0."):]: v for k, v in sd.items()})
    t = rng.standard_normal((B,) + DIMS + (CO,)).astype(np.float32)
    return mod, params, port, t


@pytest.mark.parametrize("swap_roles", [False, True])
@pytest.mark.parametrize("route", ROUTES)
def test_conv4d_route_matches_jax(volume, conv4d_pair, route, swap_roles, monkeypatch):
    """The port's forward, and autograd's gradients of it, against the JAX
    module on each of its routes (the switch is the JAX package's; the
    port reads none). The reference weight layout (k0, O, I, k1, k2, k3) is
    what the port stores: a wrong permutation fails the forward."""
    monkeypatch.setenv("FSS_CONV4D_IM2COL", route)
    x, _ = volume
    mod, params, port, t = conv4d_pair

    def loss(xx, pp):
        return jnp.sum(mod.apply({"params": pp}, xx, swap_roles=swap_roles) * t)

    jparams = jax.tree.map(jnp.asarray, params)
    want = mod.apply({"params": jparams}, jnp.asarray(x), swap_roles=swap_roles)
    gx, gp = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jparams)
    port.zero_grad()
    xt = torch.from_numpy(x).requires_grad_(True)
    got = port(xt, swap_roles)
    _close(got.detach().numpy(), want, 1e-5, 1e-5)
    (got * torch.from_numpy(t)).sum().backward()
    _close(xt.grad.numpy(), gx, 1e-3, 1e-3)
    _close(port.weight.grad.numpy(),
           np.asarray(gp["kernel"]).transpose(0, 5, 4, 1, 2, 3), 1e-3, 1e-3)
    _close(port.bias.grad.numpy(), gp["bias"], 1e-3, 1e-3)
    unswapped = mod.apply({"params": jparams}, jnp.asarray(x), swap_roles=not swap_roles)
    assert not np.allclose(np.asarray(unswapped), np.asarray(want), atol=1e-2)


@pytest.mark.parametrize("value,mode", [(None, "q"), ("", "q"), ("q", "q"), ("1", "qp"),
                                        ("qp", "qp"), ("0", "loop"), ("loop", "loop"),
                                        ("gemm", "gemm")])
def test_conv4d_route_selector(volume, conv4d_pair, value, mode, monkeypatch):
    """Whatever the JAX package's switch says (``mode`` is the JAX route it
    names), the port's conv4d runs route ``q``: it counts ``conv4d_q``, and
    ``conv4d_im2col_mode()``, which the benchmark reads, says ``q``."""
    if value is None:
        monkeypatch.delenv("FSS_CONV4D_IM2COL", raising=False)
    else:
        monkeypatch.setenv("FSS_CONV4D_IM2COL", value)
    assert conv4d_im2col_mode() == "q"
    before = tracing.counts()
    with torch.no_grad():
        conv4d_pair[2](torch.from_numpy(volume[0]))
    after = tracing.counts()
    assert after["conv4d_q"] == before["conv4d_q"] + 1
    assert all(after[f"conv4d_{r}"] == before[f"conv4d_{r}"] for r in ("qp", "gemm", "loop"))


def test_conv4d_bad_route_and_even_kernel_raise(volume, monkeypatch):
    """An even kernel raises. A route value the JAX package refuses is inert
    here: the port reads no route switch."""
    monkeypatch.setenv("FSS_CONV4D_IM2COL", "2")
    assert conv4d_im2col_mode() == "q"
    with pytest.raises(ValueError, match="odd kernels"):
        Conv4d(CI, CO, (2, 3, 3, 3))(torch.from_numpy(volume[0]))


# --------------------------------------------------------------------------- #
# CenterPivotConv4d: the 6D route and the flat route's fallback
# --------------------------------------------------------------------------- #


def _pivot_pair(stride, rng, kernel=3):
    params = {name: {"kernel": rng.standard_normal((kernel, kernel, CI, CO)).astype(np.float32),
                     "bias": rng.standard_normal((CO,)).astype(np.float32)}
              for name in ("conv_query", "conv_support")}
    pad = (kernel // 2,) * 4
    jmod = JaxPivot(out_channels=CO, kernel_size=(kernel,) * 4, stride=stride, padding=pad)
    port = CenterPivotConv4d(CI, CO, (kernel,) * 4, stride, pad)
    sd = matchnet_state_dict_from_flax({"ncons": {"conv4d_0": params}})
    port.load_state_dict({k[len("NeighConsensus.conv.0."):]: v for k, v in sd.items()})
    return jmod, {"params": params}, port


@pytest.mark.parametrize("swap_roles", [False, True])
@pytest.mark.parametrize("stride", [(1, 1, 1, 1), (1, 1, 2, 2)])
def test_center_pivot_6d_matches_jax(volume, stride, swap_roles):
    """The channels-last 6D route with strides: unswapped, the support grid
    is pruned; swapped, the query grid (FuseNet's stride (1, 1, 2, 2))."""
    x, _ = volume
    rng = np.random.default_rng(32)
    jmod, params, port = _pivot_pair(stride, rng)
    want = jmod.apply(params, jnp.asarray(x), swap_roles=swap_roles, fuse_relu=True)
    xt = torch.from_numpy(x).requires_grad_(True)
    got = port(xt, swap_roles, True)
    assert tuple(got.shape) == want.shape
    _close(got.detach().numpy(), want, 1e-5, 1e-5)
    t = rng.standard_normal(want.shape).astype(np.float32)
    gx = jax.grad(lambda xx: jnp.sum(jmod.apply(params, xx, swap_roles=swap_roles,
                                                fuse_relu=True) * t))(jnp.asarray(x))
    (got * torch.from_numpy(t)).sum().backward()
    _close(xt.grad.numpy(), gx, 1e-3, 1e-3)


@pytest.mark.parametrize("case", ["kernel5"])
def test_flat_route_falls_back_to_the_6d_math(volume, case, monkeypatch):
    """A flat volume the pivot kernels do not take (a 5^4 kernel) runs the
    6D math around one layout conversion, as JAX ``_flat`` does, and
    launches no kernel."""
    monkeypatch.setenv("FSS_PIVOT_MXU", "1")    # JAX's flat route, for its _flat
    x, _ = volume
    jmod, params, port = _pivot_pair((1, 1, 1, 1), np.random.default_rng(33), kernel=5)
    hq, wq, hs, ws = DIMS
    flat = np.ascontiguousarray(x.transpose(0, 5, 1, 2, 3, 4).reshape(B, CI, hq * wq, hs * ws))
    for swap in (False, True):
        want = jmod.apply(params, jnp.asarray(flat), swap_roles=swap, fuse_relu=True,
                          flat_dims=DIMS)
        before = tracing.counts()
        with torch.no_grad():
            got = port(torch.from_numpy(flat), swap, True, DIMS)
        assert tracing.counts() == before
        _close(got.numpy(), want, 1e-5, 1e-5)


# --------------------------------------------------------------------------- #
# 6D correlation primitives, spatial descriptor, MSBlock
# --------------------------------------------------------------------------- #


def test_mutual_matching_6d_matches_jax(volume):
    x, _ = volume
    want = jax_corr.mutual_matching(jnp.asarray(x))
    got = mutual_matching(torch.from_numpy(x))
    _close(got.numpy(), want, 1e-5, 1e-6)


def test_mutual_nn_filter_matches_jax():
    """eps is added only where a max is exactly 0: a row and a column of
    zeros (max 0) give zeros, not NaN; elsewhere the max is used as is."""
    rng = np.random.default_rng(34)
    c = np.abs(rng.standard_normal((2, 7, 7))).astype(np.float32)
    c[0, 3, :] = 0.0
    c[1, :, 5] = 0.0
    want = np.asarray(jax_corr.mutual_nn_filter(jnp.asarray(c)))
    got = mutual_nn_filter(torch.from_numpy(c)).numpy()
    assert np.isfinite(got).all()
    assert (got[0, 3] == 0).all() and (got[1, :, 5] == 0).all()
    _close(got, want, 1e-6, 1e-7)


@pytest.mark.parametrize("ksz", [3, 5])
def test_spatial_descriptor_matches_jax(ksz):
    x = np.random.default_rng(35).standard_normal((2, 4, 6, 8)).astype(np.float32)
    want = jax_descriptor(jnp.asarray(x), ksz)
    got = spatial_descriptor(torch.from_numpy(x), ksz)
    assert tuple(got.shape) == (2, 4, 6, ksz * ksz)
    _close(got.numpy(), want, 1e-5, 1e-6)


def test_msblock_matches_jax():
    rng = np.random.default_rng(36)
    x = rng.standard_normal((2, 9, 7, 6)).astype(np.float32)
    mod = JaxMSBlock(c_out=5, rate=2)
    params = _noisy(mod.init(jax.random.PRNGKey(4), jnp.asarray(x))["params"], rng)
    want = mod.apply({"params": params}, jnp.asarray(x))
    port = MSBlock(6, c_out=5, rate=2)
    port.load_state_dict(msblock_state_dict_from_flax(params))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    _close(got.numpy(), want, 1e-5, 1e-5)
    fresh = MSBlock(6, generator=torch.Generator().manual_seed(0))
    assert abs(float(fresh.conv1.weight.detach().std()) - 0.01) < 2e-3
    assert float(fresh.conv1.bias.abs().max()) == 0.0
