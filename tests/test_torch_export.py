"""The hand-written kernels as ``torch.library`` operators and the port's
serve artifacts (``tools/export_serve.py``), on the CPU at 33 px with
``adapt_iter`` 5.

* Each ``fss::`` operator passes ``torch.library.opcheck`` (schema, fake
  implementation, autograd registration, AOT dispatch) on CPU tensors.
* The CWT, ``mmn`` and ``match`` serve programs, exported, saved as
  ``.pt2`` and loaded again, give masks equal to the port's eager
  ``serve_batch`` on the same inputs (the same ATen ops in the same order:
  equality is exact).
* The loaded CWT artifact's masks are >= 99.5% equal to the JAX package's
  ``build_serve_export`` artifact on the same weights (JAX's init with
  every BN and LayerNorm field perturbed, carried over by
  ``utils/convert.py``), the same episodes and the same classifier inits:
  JAX draws them inside its program from ``PRNGKey(i)``, the port takes
  them as ``w0``, made here from the same keys. 99.5% is the bar of
  ``tests/test_torch_engine.py`` for the eager programs.
* The heads not ported and ``--mesh`` raise, naming their ROADMAP items;
  the CLI writes a ``.pt2``, which ``tools/serve_loaded.py`` runs in a
  process that imports no model code.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from few_shot_seg_cwt_tpu.config import default_cfg as jax_default_cfg
from few_shot_seg_cwt_tpu.episodic.engine import EpisodicEngine as JaxEngine
from few_shot_seg_cwt_tpu.models.pspnet import init_classifier_weights
from few_shot_seg_cwt_tpu.tools.export_serve import build_serve_export as jax_build_serve_export
from few_shot_seg_cwt_tpu_torch.config import default_cfg, load_cfg, merge_cfg_from_list
from few_shot_seg_cwt_tpu_torch.data.synthetic import make_episode_batch
from few_shot_seg_cwt_tpu_torch.episodic.engine import EpisodicEngine
from few_shot_seg_cwt_tpu_torch.episodic.heads import HeadEngine
from few_shot_seg_cwt_tpu_torch.models.cwt import build_cwt
from few_shot_seg_cwt_tpu_torch.models.pspnet import build_pspnet
from few_shot_seg_cwt_tpu_torch.ops import cuda_inner_loop, cuda_pivot
from few_shot_seg_cwt_tpu_torch.tools import export_serve
from few_shot_seg_cwt_tpu_torch.utils.convert import (cwt_state_dict_from_flax,
                                                      pspnet_state_dict_from_flax)

torch.set_num_threads(1)

SIZE, FEAT, E = 33, 5, 2
OPTS = ["image_size", str(SIZE), "adapt_iter", "5"]
ROUTE_SWITCHES = ("FSS_PIVOT_MXU", "FSS_PIVOT_PALLAS", "FSS_DISABLE_PALLAS", "FSS_NCONS_R4",
                  "FSS_INNER_TILE")


@pytest.fixture(autouse=True)
def _routes(monkeypatch):
    for var in ROUTE_SWITCHES:
        monkeypatch.delenv(var, raising=False)


def _pivot_inputs(rng, b=2, ci=3, co=4, dims=(5, 6, 4, 5)):
    q, s = dims[0] * dims[1], dims[2] * dims[3]

    def t(*shape):
        return torch.tensor(rng.standard_normal(shape).astype(np.float32))

    return t(b, ci, q, s), t(3, 3, ci, co), t(3, 3, ci, co), t(co), t(b, co, q, s), list(dims)


def _loop_inputs(rng, e=2, shot=1, h=4, w=4, c=16, big=9):
    f = torch.tensor(rng.standard_normal((e, shot, h, w, c)).astype(np.float32))
    pw = torch.tensor(rng.uniform(0, 1, (e, shot, big, big)).astype(np.float32))
    pw = (pw / pw.sum(dim=(1, 2, 3), keepdim=True)).contiguous()
    pwy = (pw * torch.tensor(rng.integers(0, 2, pw.shape).astype(np.float32))).contiguous()
    u0 = torch.tensor(rng.uniform(-0.05, 0.05, (e, c)).astype(np.float32))
    return f, pw, pwy, u0


@pytest.mark.parametrize("op", ["adapt_binary", "adapt_binary_tiled", "pivot_fwd", "pivot_dw"])
def test_operator_passes_opcheck(op):
    rng = np.random.default_rng(3)
    if op.startswith("adapt"):
        args = _loop_inputs(rng) + (3, 0.1) + ((2,) if op.endswith("tiled") else ())
    elif op == "pivot_fwd":
        x, wa, wb, bias, _, dims = _pivot_inputs(rng)
        args = tuple(a.requires_grad_(True) for a in (x, wa, wb, bias)) + (dims, True)
    else:
        x, _, _, _, g, dims = _pivot_inputs(rng)
        args = (x, g, dims)
    torch.library.opcheck(getattr(torch.ops.fss, op), args)


def test_operators_run_the_plain_versions_on_cpu_uncounted():
    rng = np.random.default_rng(4)
    cuda_inner_loop.reset_launches()
    cuda_pivot.reset_launches()
    f, pw, pwy, u0 = _loop_inputs(rng)
    torch.testing.assert_close(torch.ops.fss.adapt_binary(f, pw, pwy, u0, 4, 0.1),
                               cuda_inner_loop.adapt_binary_reference(f, pw, pwy, u0, 4, 0.1),
                               rtol=0, atol=0)
    x, wa, wb, bias, g, dims = _pivot_inputs(rng)
    torch.testing.assert_close(torch.ops.fss.pivot_fwd(x, wa, wb, bias, dims, True),
                               cuda_pivot.pivot_conv_flat_reference(x, wa, wb, bias, dims, True),
                               rtol=0, atol=0)
    assert {**cuda_inner_loop.LAUNCHES, **cuda_pivot.LAUNCHES} == dict.fromkeys(
        ("adapt_binary", "adapt_binary_tiled", "pivot_fwd", "pivot_dw"), 0)


def _inputs(cfg, e=E, seed=5, k=2):
    ep = make_episode_batch(seed, e, size=SIZE)
    ep["s_label"][0, 0, :4] = 255
    w0 = torch.tensor(np.random.default_rng(seed).uniform(
        -1 / np.sqrt(512), 1 / np.sqrt(512), (e, k, 512)).astype(np.float32))
    return ep, w0


def _roundtrip(exported, tmp_path, ep, w0):
    path = tmp_path / "serve.pt2"
    torch.export.save(exported, str(path))
    program = torch.export.load(str(path)).module()
    with torch.no_grad():
        return program(torch.as_tensor(ep["s_img"]), torch.as_tensor(ep["s_label"]).int(),
                       torch.as_tensor(ep["q_img"]), w0)


@pytest.mark.parametrize("program,flat", [("cwt", False), ("mmn", True), ("match", True)])
def test_saved_program_equals_eager_serve_batch(program, flat, tmp_path, monkeypatch):
    if flat:
        monkeypatch.setenv("FSS_PIVOT_MXU", "1")
    if program == "cwt":
        cfg = merge_cfg_from_list(load_cfg("configs/pascal.yaml"), OPTS)
        engine = EpisodicEngine(cfg, device="cpu")
        exported = export_serve.build_serve_export(cfg, engine, E)
    else:
        # the bf16 backbone of use_amp is slow on the CPU; the card runs it
        cfg = merge_cfg_from_list(load_cfg(f"configs/pascal_{program}.yaml"),
                                  OPTS + ["use_amp", "False"])
        engine = HeadEngine(cfg, program, device="cpu")
        exported = export_serve.build_head_serve_export(cfg, program, engine, E)
    ops = {str(n.target) for n in exported.graph.nodes if str(n.target).startswith("fss.")}
    assert ops == ({"fss.adapt_binary.default", "fss.pivot_fwd.default"} if flat
                   else {"fss.adapt_binary.default"})
    ep, w0 = _inputs(cfg)
    got = _roundtrip(exported, tmp_path, ep, w0)
    want = engine.serve_batch(ep, w0=w0)
    assert got.dtype == torch.int32 and tuple(got.shape) == (E, SIZE, SIZE)
    assert torch.equal(got, want)


def _perturb_norms(tree, rng):
    for node in tree.values():
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


def test_cwt_artifact_matches_the_jax_artifact(tmp_path):
    jcfg = jax_default_cfg()
    jcfg.image_size, jcfg.adapt_iter, jcfg.cls_lr = SIZE, 5, 0.1
    jeng = JaxEngine(jcfg)
    rng = np.random.default_rng(2021)
    vars_b = jax.jit(lambda r, x: jeng.backbone.init({"params": r}, x, train=False))(
        jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)))
    vars_b = _perturb_norms(jax.tree.map(lambda x: np.array(x, np.float32), vars_b), rng)
    f = jnp.zeros((1, FEAT, FEAT, 512))
    vars_t = jax.jit(lambda r: jeng.cwt.init(r, jnp.zeros((1, 2, 512)), f, f))(
        jax.random.PRNGKey(1))
    vars_t = _perturb_norms(jax.tree.map(lambda x: np.array(x, np.float32), vars_t), rng)

    cfg = default_cfg()
    cfg.image_size, cfg.adapt_iter, cfg.cls_lr = SIZE, 5, 0.1
    backbone, cwt = build_pspnet(cfg), build_cwt(cfg)
    backbone.load_state_dict(pspnet_state_dict_from_flax(vars_b))
    cwt.load_state_dict(cwt_state_dict_from_flax(vars_t))
    engine = EpisodicEngine(cfg, backbone=backbone, cwt=cwt, device="cpu")

    ep, _ = _inputs(cfg, seed=8)
    batch = {k: ep[k] for k in ("s_img", "s_label", "q_img")}
    batch["s_label"] = batch["s_label"].astype(np.int32)
    keys = [jax.random.PRNGKey(i) for i in range(E)]
    jax_masks = np.asarray(jax.export.deserialize(
        jax_build_serve_export(jcfg, vars_b, vars_t, E).serialize()).call(
            batch, np.stack([np.asarray(k) for k in keys])))
    w0 = torch.tensor(np.stack([np.asarray(init_classifier_weights(k, 2, 512)) for k in keys]))
    got = _roundtrip(export_serve.build_serve_export(cfg, engine, E), tmp_path, ep, w0).numpy()
    assert got.shape == jax_masks.shape == (E, SIZE, SIZE)
    assert (got == jax_masks).mean() >= 0.995


@pytest.mark.parametrize("what,item", [("chm", 8), ("detr", 9), ("fuse", 10), ("mesh", 13)])
def test_unported_heads_and_the_mesh_raise(what, item, tmp_path):
    argv = ["--config", "configs/pascal.yaml", "--out", str(tmp_path / "x.pt2"),
            "--device", "cpu", "--opts", *OPTS]
    argv[4:4] = ["--mesh", "2"] if what == "mesh" else ["--head", what]
    with pytest.raises(NotImplementedError, match=f"item {item}"):
        export_serve.main(argv)
    assert not (tmp_path / "x.pt2").exists()


def test_head_serving_refuses_label_dependent_settings():
    cfg = merge_cfg_from_list(load_cfg("configs/pascal_match.yaml"), OPTS + ["ignore", "True"])
    with pytest.raises(ValueError, match="ignore False"):
        export_serve.check_servable(cfg, "match")
    with pytest.raises(ValueError, match="no label-free serving form"):
        export_serve.check_servable(cfg, "att")


@pytest.fixture(scope="module")
def cli_artifact(tmp_path_factory):
    """The CLI's CWT artifact at batch 2 on the CPU: (path, its summary)."""
    out = tmp_path_factory.mktemp("cli") / "cli.pt2"
    info = export_serve.main(["--config", "configs/pascal.yaml", "--out", str(out),
                              "--batch", "2", "--device", "cpu", "--opts", *OPTS])
    return out, info


def test_cli_writes_a_pt2(cli_artifact):
    out, info = cli_artifact
    assert info["bytes"] == out.stat().st_size > 0
    assert info["operators"] == ["fss.adapt_binary.default"]
    assert (info["head"], info["batch"], info["platforms"]) == ("cwt", 2, ["cpu"])
    program = torch.export.load(str(out)).module()
    ep, w0 = _inputs(load_cfg("configs/pascal.yaml"))
    with torch.no_grad():
        masks = program(torch.as_tensor(ep["s_img"]), torch.as_tensor(ep["s_label"]).int(),
                        torch.as_tensor(ep["q_img"]), w0)
    assert tuple(masks.shape) == (2, SIZE, SIZE) and set(masks.unique().tolist()) <= {0, 1}


def test_serve_loaded_runs_the_artifact_with_torch_and_ops_only(cli_artifact, tmp_path):
    """``tools/serve_loaded.py`` in a fresh process on a saved CWT artifact:
    it imports the port's ``ops`` and no model code, runs with TF32 off, and
    its masks equal the same artifact's loaded here; on the CPU the
    operators run their plain versions, so no launch is counted."""
    import json
    import subprocess
    import sys

    art = cli_artifact[0]
    ep, w0 = _inputs(load_cfg("configs/pascal.yaml"))
    inputs = {"s_img": torch.as_tensor(ep["s_img"]),
              "s_label": torch.as_tensor(ep["s_label"]).int(),
              "q_img": torch.as_tensor(ep["q_img"]), "w0": w0}
    torch.save(inputs, tmp_path / "inputs.pt")
    proc = subprocess.run(
        [sys.executable, "-c",
         "import sys, torch; from few_shot_seg_cwt_tpu_torch.tools import serve_loaded; "
         "serve_loaded.main(sys.argv[1:]); "
         "print(torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)",
         str(art), str(tmp_path / "inputs.pt"), str(tmp_path / "out.pt"), "--device", "cpu",
         "--reps", "1"], capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    *_, line, flags = proc.stdout.strip().splitlines()
    result = json.loads(line)
    assert flags == "False False"
    assert not any(m.split(".")[1] in ("models", "episodic", "train", "eval", "data")
                   for m in result["port_modules"]), result["port_modules"]
    assert "few_shot_seg_cwt_tpu_torch.ops" in result["port_modules"]
    assert set(result["launches"].values()) == {0}
    assert result["episodes_per_s"] > 0
    with torch.no_grad():
        want = torch.export.load(str(art)).module()(*inputs.values())
    assert torch.equal(torch.load(tmp_path / "out.pt", weights_only=True), want)
