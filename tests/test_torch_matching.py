"""The port's MMN building blocks against the JAX package, on the CPU:
``CenterPivotConv4d`` (rank-4 and flat routes, with and without the role
swap), the symmetric ``NeighConsensus``, ``WeightAverage``, ``MMN`` and the
``utils/convert.py`` <-> ``utils/ckpt.py:import_mmn`` round trip, and the
MMN forward's one path under each of the JAX package's route switches.

Inputs come from numpy seeds; weights are the JAX package's own init with
seeded noise on every leaf (the inits leave biases at zero, which would hide
a bias that lands in the wrong place), carried to the port by
``mmn_state_dict_from_flax``. The flat layout runs the pivot pair's plain
version on CPU tensors; the ``route`` cases set the JAX package's flat
switch (``FSS_PIVOT_MXU=1``) or leave its rank-4 default, which the port
does not read. Tolerances: rtol 1e-5 (atol 1e-5) for the blocks and the
consensus, rtol 1e-4 (atol 1e-4 of the output scale) for MMN.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from few_shot_seg_cwt_tpu.models.conv4d import CenterPivotConv4d as JaxPivot
from few_shot_seg_cwt_tpu.models.matching import NeighConsensus as JaxNeighConsensus
from few_shot_seg_cwt_tpu.models.mmn import MMN as JaxMMN
from few_shot_seg_cwt_tpu.models.msm import WeightAverage as JaxWeightAverage
from few_shot_seg_cwt_tpu.utils.ckpt import import_mmn
from torch.utils._python_dispatch import TorchDispatchMode

from few_shot_seg_cwt_tpu_torch.models.conv4d import CenterPivotConv4d, init_conv_parameters
from few_shot_seg_cwt_tpu_torch.models.matching import MatchNet, live_consensus
from few_shot_seg_cwt_tpu_torch.models.mmn import MMN
from few_shot_seg_cwt_tpu_torch.models.msm import WeightAverage
from few_shot_seg_cwt_tpu_torch.utils import tracing
from few_shot_seg_cwt_tpu_torch.utils.convert import mmn_state_dict_from_flax

torch.set_num_threads(1)

DIMS = (5, 6, 4, 7)      # hq, wq, hs, ws all distinct: catches plane mix-ups
CI, CO, B = 3, 4, 2
FLAT_SWITCHES = ("FSS_PIVOT_MXU", "FSS_PIVOT_PALLAS", "FSS_DISABLE_PALLAS", "FSS_NCONS_R4")


@pytest.fixture
def route(request, monkeypatch):
    """"flat" sets the JAX package's flat switch, "r4" leaves its rank-4
    default; the port reads neither, and the block tests call each of its
    layouts directly."""
    for var in FLAT_SWITCHES:
        monkeypatch.delenv(var, raising=False)
    if request.param == "flat":
        monkeypatch.setenv("FSS_PIVOT_MXU", "1")
    return request.param


def _noisy(tree, rng, scale=0.1):
    return jax.tree.map(lambda a: np.asarray(a, np.float32)
                        + rng.normal(0, scale, np.shape(a)).astype(np.float32), tree)


def _oihw(kernel):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(kernel).transpose(3, 2, 0, 1)))


def _to_flat(y6):
    b, hq, wq, hs, ws, c = y6.shape
    return np.asarray(y6).transpose(0, 5, 1, 2, 3, 4).reshape(b, c, hq * wq, hs * ws)


def _to_bqsc(y6):
    b, hq, wq, hs, ws, c = y6.shape
    return np.asarray(y6).reshape(b, hq * wq, hs * ws, c)


# --------------------------------------------------------------------------- #
# CenterPivotConv4d
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def pivot_block():
    rng = np.random.default_rng(11)
    x6 = rng.standard_normal((B,) + DIMS + (CI,)).astype(np.float32)
    params = {"params": {
        name: {"kernel": rng.standard_normal((3, 3, CI, CO)).astype(np.float32),
               "bias": rng.standard_normal((CO,)).astype(np.float32)}
        for name in ("conv_query", "conv_support")}}
    port = CenterPivotConv4d(CI, CO)
    with torch.no_grad():
        for conv, name in ((port.conv1, "conv_query"), (port.conv2, "conv_support")):
            conv.weight.copy_(_oihw(params["params"][name]["kernel"]))
            conv.bias.copy_(torch.from_numpy(params["params"][name]["bias"]))
    return x6, params, port


@pytest.mark.parametrize("route", ["flat", "r4"], indirect=True)
@pytest.mark.parametrize("swap_roles", [False, True])
def test_center_pivot_conv4d_matches_jax(pivot_block, route, swap_roles):
    """Both routes against the JAX module's 6D math. With ``swap_roles`` the
    query kernel convolves the support plane; exchanging wa and wb (or the
    two biases' planes) would fail here, since every dim differs."""
    x6, params, port = pivot_block
    want6 = JaxPivot(out_channels=CO).apply(params, jnp.asarray(x6),
                                            swap_roles=swap_roles, fuse_relu=True)
    with torch.no_grad():
        if route == "flat":
            got = port(torch.from_numpy(_to_flat(x6)), swap_roles, True, DIMS)
            want = _to_flat(want6)
        else:
            got = port(torch.from_numpy(_to_bqsc(x6)), swap_roles, True, DIMS, bqsc=True)
            want = _to_bqsc(want6)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    unswapped = JaxPivot(out_channels=CO).apply(params, jnp.asarray(x6),
                                                swap_roles=not swap_roles, fuse_relu=True)
    assert not np.allclose(np.asarray(unswapped), np.asarray(want6), atol=1e-2)


# --------------------------------------------------------------------------- #
# NeighConsensus and WeightAverage
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def consensus():
    """JAX NeighConsensus (3 blocks 2->10->10->1) with noisy params, the port's
    MatchNet holding the same weights, a 2-channel volume and the JAX
    symmetric rank-4 output."""
    rng = np.random.default_rng(12)
    hq, wq, hs, ws = DIMS
    x6 = rng.standard_normal((1,) + DIMS + (2,)).astype(np.float32)
    mod = JaxNeighConsensus(kernel_sizes=(3, 3, 3), channels=(10, 10, 1),
                            symmetric_mode=True, block_remat=False)
    params = _noisy(mod.init(jax.random.PRNGKey(0), jnp.asarray(x6))["params"], rng)
    xr = x6.reshape(1, hq * wq, hs * ws, 2)
    want = np.asarray(mod.apply({"params": params}, jnp.asarray(xr), DIMS,
                                method=JaxNeighConsensus.bqsc))
    sd = mmn_state_dict_from_flax({"corr_net": {"ncons": params}})
    port = MatchNet(in_channel=2, block_remat=False)
    port.load_state_dict({k[len("corr_net."):]: v for k, v in sd.items()})
    return xr, want, port


@pytest.mark.parametrize("route", ["flat", "r4"], indirect=True)
def test_neigh_consensus_symmetric_matches_jax_bqsc(consensus, route):
    """Symmetric stack = unswapped stack + role-swapped stack, no transposes,
    against the JAX rank-4 route."""
    xr, want, port = consensus
    before = tracing.counts()
    with torch.no_grad():
        if route == "flat":
            x = torch.from_numpy(np.ascontiguousarray(xr.transpose(0, 3, 1, 2)))
            got = port.NeighConsensus(x, flat_dims=DIMS).permute(0, 2, 3, 1)
        else:
            got = port.NeighConsensus.bqsc(torch.from_numpy(xr), DIMS)
    assert tracing.counts() == before            # CPU tensors: plain versions
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("route", ["flat", "r4"], indirect=True)
def test_neigh_consensus_grads_do_not_depend_on_remat(consensus, route):
    """Per-block recompute (torch.utils.checkpoint) changes no gradient."""
    xr, _, port = consensus
    x = torch.from_numpy(np.ascontiguousarray(xr.transpose(0, 3, 1, 2)))
    grads = []
    for remat in (False, True):
        port.NeighConsensus.block_remat = remat
        port.zero_grad()
        if route == "flat":
            y = port.NeighConsensus(x, flat_dims=DIMS)
        else:
            y = port.NeighConsensus.bqsc(torch.from_numpy(xr), DIMS)
        y.square().sum().backward()
        grads.append([p.grad.clone() for p in port.parameters()])
    port.NeighConsensus.block_remat = False
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_weight_average_matches_jax():
    rng = np.random.default_rng(13)
    x = rng.standard_normal((2, 5, 6, 16)).astype(np.float32)
    mod = JaxWeightAverage()
    params = _noisy(mod.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"], rng)
    want = np.asarray(mod.apply({"params": params}, jnp.asarray(x)))
    port = WeightAverage(16)
    with torch.no_grad():
        for name, leaf in params.items():
            getattr(port, name).weight.copy_(_oihw(leaf["kernel"]))
            getattr(port, name).bias.copy_(torch.from_numpy(leaf["bias"]))
        got = port(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------------------- #
# MMN
# --------------------------------------------------------------------------- #

# (name, MMN options); channels of stages 1-4 are cut to keep the test small
MMN_CASES = {
    "pascal_mmn": dict(bids=(3, 4), all_lr="l", agg="cat", wa=True, red_dim=0,
                       nbottlenecks=(3, 4, 6, 3)),
    "red_sum_all4": dict(bids=(3, 4), all_lr="4", agg="sum", wa=True, red_dim=8,
                         nbottlenecks=(1, 1, 2, 2)),
}
FEAT_CH = (8, 12, 16, 24)
H = W = 5


def _mmn_inputs(case, rng):
    opts = MMN_CASES[case]

    def feats(n):
        return {bid: [rng.standard_normal((n, H, W, FEAT_CH[bid - 1])).astype(np.float32)
                      for _ in range(opts["nbottlenecks"][bid - 1])]
                for bid in opts["bids"]}

    return (feats(1), feats(1), rng.standard_normal((1, H, W, 32)).astype(np.float32),
            rng.standard_normal((1, H, W, 32)).astype(np.float32))


@pytest.fixture(scope="module", params=sorted(MMN_CASES))
def mmn_pair(request):
    """(case, inputs, JAX (fq, att_fq), noisy flax params, port MMN)."""
    case = request.param
    rng = np.random.default_rng(14)
    inputs = _mmn_inputs(case, rng)
    opts = MMN_CASES[case]
    jmod = JaxMMN(temp=20.0, att_wt=0.2, block_remat=False, **opts)
    jin = jax.tree.map(jnp.asarray, inputs)
    params = _noisy(jax.jit(jmod.init)(jax.random.PRNGKey(2), *jin)["params"], rng)
    want = jax.jit(jmod.apply)({"params": params}, *jin)
    port = MMN(temp=20.0, att_wt=0.2, feature_channels=FEAT_CH, block_remat=False, **opts)
    port.load_state_dict(mmn_state_dict_from_flax(params))
    return case, inputs, [np.asarray(w) for w in want], params, port


@pytest.mark.parametrize("route", ["flat", "r4"], indirect=True)
def test_mmn_matches_jax(mmn_pair, route):
    _, inputs, want, _, port = mmn_pair
    fq_feats, fs_feats, f_q, f_s = jax.tree.map(torch.from_numpy, inputs)
    with torch.no_grad():
        got = port(fq_feats, fs_feats, f_q, f_s)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-4 * np.abs(w).max())


def test_import_mmn_round_trip(mmn_pair):
    """import_mmn(port.state_dict()) gives back the flax tree leaf for leaf."""
    case, _, _, params, port = mmn_pair
    back = import_mmn(port.state_dict())["params"]
    want = jax.tree_util.tree_leaves_with_path(params)
    got = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in got] == [p for p, _ in want], case
    for (_, g), (path, w) in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), w, err_msg=str(path))


# the JAX package's route switch settings: its rank-4 default, the MXU and
# VPU flat routes, the 6D route, and the flat route turned off
JAX_SWITCHES = {"none": {}, "mxu": {"FSS_PIVOT_MXU": "1"}, "pallas": {"FSS_PIVOT_PALLAS": "1"},
                "ncons_r4_0": {"FSS_NCONS_R4": "0"},
                "disabled": {"FSS_PIVOT_MXU": "1", "FSS_DISABLE_PALLAS": "1"}}


class _OpCalls(TorchDispatchMode):
    """Counts the ``fss::`` operators dispatched inside it."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if str(func).startswith("fss."):
            self.calls.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("setting", sorted(JAX_SWITCHES))
def test_mmn_runs_one_path_whatever_the_jax_switches(setting, monkeypatch):
    """The port reads none of the JAX package's route switches: under each
    setting the MMN forward is the same bits as with none set, and each of
    the symmetric consensus's 2 x 3 blocks runs ``fss::pivot_fwd`` (its
    plain version on the CPU)."""
    for var in FLAT_SWITCHES:
        monkeypatch.delenv(var, raising=False)
    port = MMN(temp=20.0, att_wt=0.2, feature_channels=FEAT_CH, block_remat=False,
               **MMN_CASES["pascal_mmn"])
    init_conv_parameters(port, torch.Generator().manual_seed(15))
    live_consensus(port)
    inputs = jax.tree.map(torch.from_numpy, _mmn_inputs("pascal_mmn", np.random.default_rng(15)))
    with torch.no_grad():
        want = port(*inputs)
        for var, value in JAX_SWITCHES[setting].items():
            monkeypatch.setenv(var, value)
        with _OpCalls() as ops:
            got = port(*inputs)
    assert ops.calls == ["fss.pivot_fwd.default"] * 6
    for g, w in zip(got, want):
        assert torch.equal(g, w)
