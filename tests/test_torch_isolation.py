"""The PyTorch port stands alone: it imports neither JAX (nor flax, optax,
orbax) nor anything of the JAX package, and its chip script refuses to run
without a card.

The runtime check is a subprocess because this test process has imported
JAX already (tests/conftest.py).
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "few_shot_seg_cwt_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "few_shot_seg_cwt_tpu"}


def _port_sources():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_no_port_file_imports_jax_or_the_jax_package():
    bad = []
    for path in _port_sources():
        for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{path.relative_to(REPO)}: {n}" for n in names
                    if n.split(".")[0] in FORBIDDEN]
    assert not bad, bad
    # the port's subpackages mirror the JAX package's layout
    for sub in ("config", "data", "ops", "models", "episodic", "eval", "train", "utils",
                "parallel"):
        assert (PORT / sub / "__init__.py").exists(), sub
        assert (REPO / "few_shot_seg_cwt_tpu" / sub / "__init__.py").exists(), sub


_DRIVE = r"""
import json, sys
import torch
torch.set_num_threads(1)
from few_shot_seg_cwt_tpu_torch.config import default_cfg
from few_shot_seg_cwt_tpu_torch.data.synthetic import make_episode_batch
from few_shot_seg_cwt_tpu_torch.episodic.engine import EpisodicEngine
cfg = default_cfg()
cfg.image_size, cfg.adapt_iter, cfg.cls_lr = 33, 2, 0.1
engine = EpisodicEngine(cfg, device="cpu")
masks = engine.serve_batch(make_episode_batch(1, 2, size=33), torch.Generator().manual_seed(0))
# the MMN head on the pivot kernels' plain version
from few_shot_seg_cwt_tpu_torch.config import load_cfg, merge_cfg_from_list
from few_shot_seg_cwt_tpu_torch.episodic.heads import HeadEngine
mcfg = merge_cfg_from_list(load_cfg("configs/pascal_mmn.yaml"),
                           ["image_size", "33", "adapt_iter", "2", "use_amp", "False"])
heads = HeadEngine(mcfg, "mmn", device="cpu")
mmn_masks = heads.serve_batch(make_episode_batch(1, 2, size=33), torch.Generator().manual_seed(0))
assert tuple(mmn_masks.shape) == (2, 33, 33)
import few_shot_seg_cwt_tpu_torch.train.train_head  # noqa: F401
import few_shot_seg_cwt_tpu_torch.train.train_cwt  # noqa: F401
import importlib
for name in ("tools.export_serve", "tools.serve_loaded", "tools.preflight",
             "tools.record_episodes", "tools.parity_drill", "tools.bench_loader",
             "tools.bench_head_parts", "utils.logging", "utils.tb", "utils.print_log",
             "utils.visualize", "utils.extra_metrics", "utils.convert_ckpt",
             "parallel.mesh", "parallel.dryrun", "train.train_ddp", "train.pretrain",
             "train.train_trans", "train.train_match", "models.chm", "models.deform",
             "models.detr", "ops.geometry"):
    importlib.import_module("few_shot_seg_cwt_tpu_torch." + name)
forbidden = sorted(m for m in sys.modules
                   if m.split(".")[0] in {"jax", "jaxlib", "flax", "optax", "orbax"}
                   or m == "few_shot_seg_cwt_tpu" or m.startswith("few_shot_seg_cwt_tpu."))
print(json.dumps({"shape": list(masks.shape), "forbidden": forbidden}))
"""


def test_port_runs_without_importing_jax():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", _DRIVE], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["shape"] == [2, 33, 33]
    assert out["forbidden"] == []


def test_chip_smoke_fails_without_a_card(tmp_path):
    """On a machine without CUDA the script exits non-zero and prints no
    result line; alone in a directory it cannot import the port either."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")], cwd=REPO,
                          env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((REPO / "chip_smoke.py").read_text())
    proc = subprocess.run([sys.executable, str(lone)], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
