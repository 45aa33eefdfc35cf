"""The port's int8 consensus (``ops/quant.py``, ``FSS_NCONS_INT8``) against
the JAX package's, on the CPU.

* ``quantize_tensor`` / ``quantize_per_co``: the same int8 values and
  scales as JAX (the port's kernels are OIHW, JAX's HWIO).
* ``qconv2d``: the forward within 1e-6 of the output scale of JAX's (both
  integer sums are exact; the rescale rounds alike); the gradients of a
  loss through it within 1e-5 of JAX's, and equal to the STE reference
  (the plain conv's gradient at the dequantized point); ``fake_quant``'s
  gradient the identity.
* MatchNet on the rank-4 route under ``fake`` and ``dot`` against JAX's
  (3 consensus blocks, so a rounding that lands on the other side of a
  quantization level in one block would move the next: held by the mean
  relative difference, 1e-5; measured 1.9e-7 under ``fake``, 0 under
  ``dot``); ``dot`` against ``fake`` statistically, as JAX's test holds
  it; trainable (finite gradients); under either mode the port's result
  does not depend on the JAX package's flat or 6D route switch, bit for
  bit (a centre-pivot stack under the flag runs the rank-4 route, the one
  JAX quantizes).
* ``tools/ab_int8``: the JAX tool's keys on a 33 px run, the flag back as
  it was.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from few_shot_seg_cwt_tpu.models.matching import MatchNet as JaxMatchNet
from few_shot_seg_cwt_tpu.ops import quant as jq
from few_shot_seg_cwt_tpu_torch.models.matching import MatchNet, live_consensus
from few_shot_seg_cwt_tpu_torch.ops import quant
from few_shot_seg_cwt_tpu_torch.tools import ab_int8
from few_shot_seg_cwt_tpu_torch.utils.convert import matchnet_state_dict_from_flax

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
ROUTE_SWITCHES = ("FSS_PIVOT_MXU", "FSS_PIVOT_PALLAS", "FSS_DISABLE_PALLAS", "FSS_NCONS_R4",
                  "FSS_NCONS_INT8")


@pytest.fixture(autouse=True)
def clean_routes(monkeypatch):
    for var in ROUTE_SWITCHES:
        monkeypatch.delenv(var, raising=False)


def _hwio_to_oihw(k):
    return np.ascontiguousarray(np.asarray(k).transpose(3, 2, 0, 1))


def test_mode_switch(monkeypatch):
    assert quant.ncons_int8_mode() == ""
    for v, want in (("0", ""), ("off", ""), ("fake", "fake"), ("dot", "dot")):
        monkeypatch.setenv("FSS_NCONS_INT8", v)
        assert quant.ncons_int8_mode() == want
    monkeypatch.setenv("FSS_NCONS_INT8", "int4")
    with pytest.raises(ValueError, match="'fake' or 'dot'"):
        quant.ncons_int8_mode()


@pytest.mark.parametrize("seed", [0, 1])
def test_quantizers_equal_jax(seed):
    r = np.random.default_rng(seed)
    x = r.normal(0, 1.0, (2, 7, 9, 5)).astype(np.float32)
    x[0, 0, 0, 0] = -2.5 * float(np.abs(x).max())              # the negative extreme
    jqx, jsx = jq.quantize_tensor(jnp.asarray(x))
    qx, sx = quant.quantize_tensor(torch.from_numpy(x))
    assert qx.dtype == torch.int8
    np.testing.assert_array_equal(qx.numpy(), np.asarray(jqx))
    assert float(sx) == float(jsx)
    k = r.normal(0, 0.2, (3, 3, 5, 7)).astype(np.float32)
    k[..., 3] *= 1e-3                                            # a small output channel
    jqk, jsk = jq.quantize_per_co(jnp.asarray(k))
    qk, sk = quant.quantize_per_co(torch.from_numpy(_hwio_to_oihw(k)))
    np.testing.assert_array_equal(qk.numpy(), _hwio_to_oihw(np.asarray(jqk)))
    np.testing.assert_array_equal(sk.numpy(), np.asarray(jsk))
    z, s0 = quant.quantize_tensor(torch.zeros(4))
    assert not z.any() and float(s0) == np.float32(1e-12) / np.float32(127.0)


@pytest.mark.parametrize("shape,ci,co", [((2, 9, 9), 5, 7), ((6, 5, 5), 10, 10), ((3, 4, 6), 1, 16)])
def test_qconv2d_forward_matches_jax(shape, ci, co):
    r = np.random.default_rng(ci * co)
    n, h, w = shape
    x = r.normal(0, 1.0, (n, h, w, ci)).astype(np.float32)
    k = r.normal(0, 0.2, (3, 3, ci, co)).astype(np.float32)
    want = np.asarray(jq.qconv2d(jnp.asarray(x), jnp.asarray(k), (1, 1), "NHWC", jnp.float32))
    got = quant.qconv2d(torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))),
                        torch.from_numpy(_hwio_to_oihw(k)), (1, 1))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), want, rtol=0,
                               atol=1e-6 * float(np.abs(want).max()))


def test_int8_conv_is_the_exact_integer_conv():
    """The im2col + ``_int_mm`` sum equals a float64 conv of the int8 values
    (exact there too), padding and all, at odd sizes."""
    g = torch.Generator().manual_seed(3)
    xq = torch.randint(-127, 128, (3, 6, 5, 7), generator=g).to(torch.int8)
    kq = torch.randint(-127, 128, (9, 6, 3, 3), generator=g).to(torch.int8)
    got = quant.int8_conv2d(xq, kq, (1, 1))
    assert got.dtype == torch.int32 and got.shape == (3, 9, 5, 7)
    want = torch.nn.functional.conv2d(xq.double(), kq.double(), padding=1)
    assert torch.equal(got.double(), want)


def test_qconv2d_gradients_match_jax_and_are_the_ste():
    r = np.random.default_rng(2)
    x = r.normal(0, 1.0, (1, 8, 8, 3)).astype(np.float32)
    k = r.normal(0, 0.3, (3, 3, 3, 6)).astype(np.float32)

    def jloss(x_, k_):
        return jnp.sum(jnp.sin(jq.qconv2d(x_, k_, (1, 1), "NHWC", jnp.float32)))

    jgx, jgk = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(k))
    tx = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))).requires_grad_(True)
    tk = torch.from_numpy(_hwio_to_oihw(k)).requires_grad_(True)
    torch.sin(quant.qconv2d(tx, tk, (1, 1))).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy().transpose(0, 2, 3, 1), np.asarray(jgx),
                               rtol=0, atol=1e-5 * float(np.abs(jgx).max()))
    np.testing.assert_allclose(tk.grad.numpy(), _hwio_to_oihw(jgk), rtol=0,
                               atol=1e-5 * float(np.abs(jgk).max()))
    # the STE: the plain conv's gradient at the dequantized operands
    qx, sx = quant.quantize_tensor(tx.detach())
    qk, sk = quant.quantize_per_co(tk.detach())
    dx = (qx.float() * sx).requires_grad_(True)
    dk = (qk.float() * sk.reshape(-1, 1, 1, 1)).requires_grad_(True)
    y = torch.nn.functional.conv2d(dx, dk, padding=1)
    torch.sin(y).sum().backward()
    torch.testing.assert_close(tx.grad, dx.grad, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(tk.grad, dk.grad, rtol=1e-5, atol=1e-6)


def test_fake_quant_is_the_dequantized_value_with_an_identity_gradient():
    x = np.random.default_rng(4).normal(0, 1, (5, 5)).astype(np.float32)
    t = torch.from_numpy(x).requires_grad_(True)
    out = quant.fake_quant(t)
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(jq.fake_quant(jnp.asarray(x))))
    (out * 3.0).sum().backward()
    np.testing.assert_array_equal(t.grad.numpy(), np.full_like(x, 3.0))
    assert quant.fake_quant(torch.from_numpy(x).bfloat16()).dtype == torch.bfloat16


H = 8


@pytest.fixture(scope="module")
def matchnets():
    """A 2-channel MatchNet (three consensus blocks, symmetric) in JAX and
    in the port on the same weights: the JAX init with seeded noise on every
    leaf (its zero biases would leave the consensus dead), and the volume."""
    net = JaxMatchNet(temp=3.0, cv_type="red", in_channel=2, block_remat=False)
    r = np.random.default_rng(5)
    corr = r.normal(0, 0.5, (1, 2, H * H, H * H)).astype(np.float32)
    variables = net.init(jax.random.PRNGKey(0), jnp.asarray(corr), (H,) * 4,
                         method=net.run_match_model_flat)
    variables = jax.tree.map(lambda a: np.asarray(a, np.float32)
                             + r.normal(0, 0.05, np.shape(a)).astype(np.float32), variables)
    port = MatchNet(temp=3.0, cv_type="red", in_channel=2, block_remat=False)
    port.load_state_dict(matchnet_state_dict_from_flax(variables))
    return net, variables, port, corr


def _jax_run(matchnets):
    net, variables, _, corr = matchnets
    return np.asarray(net.apply(variables, jnp.asarray(corr), (H,) * 4,
                                method=net.run_match_model_flat))


def _port_run(matchnets, grad=False):
    _, _, port, corr = matchnets
    with torch.set_grad_enabled(grad):
        return port.run_match_model_flat(torch.from_numpy(corr), (H,) * 4)


@pytest.mark.parametrize("mode", ["fake", "dot"])
def test_matchnet_rank4_int8_modes_match_jax(matchnets, mode, monkeypatch):
    base = _port_run(matchnets).numpy()
    np.testing.assert_allclose(base, _jax_run(matchnets), rtol=1e-5, atol=1e-5)
    monkeypatch.setenv("FSS_NCONS_INT8", "fake")
    fake = _port_run(matchnets).numpy()
    monkeypatch.setenv("FSS_NCONS_INT8", mode)
    want = _jax_run(matchnets)
    got = _port_run(matchnets).numpy()
    scale = np.abs(want).mean()
    rel = np.abs(got - want).mean() / scale
    print(f"{mode}: port vs JAX mean relative {rel:.3e}, max {np.abs(got - want).max() / scale:.3e}")
    assert rel < 1e-5, rel
    assert not np.allclose(got, base, rtol=1e-5, atol=1e-5)     # the quantization acts
    assert np.abs(got - base).mean() / np.abs(base).mean() < 0.2
    assert np.abs(got - fake).mean() / np.abs(fake).mean() < 0.05
    out = _port_run(matchnets, grad=True)
    _, _, port, _ = matchnets
    port.zero_grad(set_to_none=True)
    out.square().mean().backward()
    grads = [p.grad for p in port.parameters() if p.grad is not None]
    assert grads and all(torch.isfinite(g).all() for g in grads)
    assert any(float(g.abs().max()) > 0 for g in grads)


@pytest.mark.parametrize("route", ["flat", "6d"])
@pytest.mark.parametrize("mode", ["fake", "dot"])
def test_int8_result_ignores_the_route_switches(matchnets, route, mode, monkeypatch):
    """The port reads no route switch: under ``mode`` its result with the
    JAX package's flat (``FSS_PIVOT_MXU=1``) or 6D (``FSS_NCONS_R4=0``)
    switch set is the quantized result without it, bit for bit."""
    base = _port_run(matchnets)
    monkeypatch.setenv("FSS_NCONS_INT8", mode)
    want = _port_run(matchnets)
    monkeypatch.setenv("FSS_PIVOT_MXU" if route == "flat" else "FSS_NCONS_R4",
                       "1" if route == "flat" else "0")
    got = _port_run(matchnets)
    assert torch.equal(got, want)
    assert not torch.allclose(got, base, rtol=1e-5, atol=1e-5)   # the quantization acts


def test_ab_int8_prints_the_jax_keys(monkeypatch, capsys):
    """33 px, adapt_iter as the default config's; a live consensus (its
    biases set), so the quantization reaches the masks; the flag back as
    it was after the run."""
    from few_shot_seg_cwt_tpu_torch.episodic.heads import build_head
    from few_shot_seg_cwt_tpu_torch.models.pspnet import build_pspnet

    args = ab_int8.parse(["--mode", "dot", "--episodes", "4", "--batch", "2",
                          "--image-size", "33", "--device", "cpu"])
    cfg = ab_int8.config(args)
    head = build_head(cfg, "mmn")
    with torch.no_grad():
        live_consensus(head, 0.05)
    monkeypatch.setenv("FSS_NCONS_INT8", "fake")
    out = ab_int8.main(["--mode", "dot", "--episodes", "4", "--batch", "2", "--image-size",
                        "33", "--device", "cpu"], backbone=build_pspnet(cfg),
                       head=head)
    assert os.environ["FSS_NCONS_INT8"] == "fake"
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    keys = {"mode", "head", "episodes", "image_size", "use_amp", "miou_base", "miou_int8",
            "delta_pts", "argmax_flip_rate"}
    assert keys <= set(printed) and printed == out
    assert out["mode"] == "dot" and out["episodes"] == 4 and 0.0 <= out["argmax_flip_rate"] < 0.5
    assert abs(out["delta_pts"] - 100 * (out["miou_int8"] - out["miou_base"])) < 1e-9


def test_ab_int8_command_line_runs_on_the_cpu():
    proc = subprocess.run([sys.executable, "-m", "few_shot_seg_cwt_tpu_torch.tools.ab_int8",
                           "--mode", "fake", "--episodes", "2", "--batch", "2",
                           "--image-size", "33", "--device", "cpu"],
                          cwd=REPO, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["mode"] == "fake" and out["image_size"] == 33
