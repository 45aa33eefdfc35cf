"""Flat-namespace experiment configuration.

Behavioural parity with the reference config system (reference:
src/util.py:315-438): two-level YAML files are flattened into a single
attribute-accessible namespace, and CLI overrides are given as
``--opts key value key value ...`` where values go through
``ast.literal_eval`` and are type-coerced against the existing entry;
unknown keys are rejected.

This is the PyTorch port's own copy of ``few_shot_seg_cwt_tpu.config``: the
same defaults table and the same YAML/``--opts`` rules, so one YAML file and
one command line configure both packages identically. Keys that only the JAX
package reads (mesh, remat, Pallas routes) are kept so that shared configs
still parse; the port ignores them.
"""

from __future__ import annotations

import argparse
import copy
import os
from ast import literal_eval
from typing import Any, Dict, List, Optional

import yaml


class Cfg(dict):
    """dict with attribute access; flat (no nesting) by construction."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name) from None

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def clone(self) -> "Cfg":
        return Cfg(copy.deepcopy(dict(self)))

    def __str__(self) -> str:
        return "\n".join(f"{k}: {v}" for k, v in sorted(self.items()))


# ---------------------------------------------------------------------------
# Defaults: every knob the framework understands, with the values the
# reference ships in config_files/pascal.yaml (its most common base config).
# YAML files and --opts override these.
# ---------------------------------------------------------------------------

_DEFAULTS: Dict[str, Any] = {
    # ---- data ----
    "train_name": "pascal",
    "test_name": "default",
    "train_split": 0,
    "test_split": "default",
    "train_list": "lists/pascal/train.txt",
    "val_list": "lists/pascal/val.txt",
    "data_root": "../dataset/VOCdevkit/VOC2012",
    "num_classes_tr": 2,
    "num_classes_val": 5,
    "use_split_coco": False,
    "workers": 2,
    "image_size": 473,
    "padding_label": 255,
    "mean": [0.485, 0.456, 0.406],
    "std": [0.229, 0.224, 0.225],
    "scale_min": 0.5,
    "scale_max": 2.0,
    "rot_min": -10,
    "rot_max": 10,
    "augmentations": ["hor_flip", "vert_flip", "resize"],
    "padding": None,           # 'avg' pads images with the dataset mean
    "meta_aug": 0,             # >1 enables support meta-augmentation
    "aug_th": [0.15, 0.30],
    "aug_type": 0,
    "synthetic_data": False,   # generate random episodes (tests / benches)
    # ---- training ----
    "ckpt_path": "checkpoints/",
    "batch_size": 1,
    "epochs": 50,
    "log_freq": 50,
    "debug": False,
    "save_models": True,
    "lr": 0.0025,
    "cls_lr": 0.0025,
    "trans_lr": 0.0025,
    "scale_lr": 1.0,
    "mixup": False,
    "smoothing": True,
    "lr_stepsize": 30,
    "momentum": 0.9,
    "gamma": 0.1,
    "nesterov": True,
    "weight_decay": 0.0001,
    "main_optim": "SGD",
    "scheduler": "cosine",
    "milestones": [40, 70],
    "iter_per_epoch": 6000,
    "adapt_iter": 200,
    "inner_loss_type": "wt_ce",
    "loss_shot": "avg",        # k-shot loss aggregation: 'avg' | 'sum'
    "shot_tile": 1,            # k-shot MMN: shots a chunk of the per-shot
                               # map (memory x tile); must divide shot,
                               # else one shot at a time
    "shot_native": False,      # k-shot MMN: all shots through one head
                               # apply (no per-shot map or recompute);
                               # costs shot x the volume activations
    "shot_hoist_query": True,  # k-shot MMN: the shot-invariant query-side
                               # rd/WeightAverage prep runs ONCE outside the
                               # per-shot map. Exact in deterministic mode;
                               # in training the query branch shares one
                               # dropout draw across shots (the reference
                               # redraws per shot)
    "shot_remat": True,        # checkpoint each chunk of the per-shot map
                               # (activations bounded to one chunk; one
                               # recomputed forward per chunk in the bwd)
    "use_amp": False,          # reference AMP flag: bf16 backbone, and bf16
                               # head compute in the head train step
    "tp": 1.0,                 # Adapt_SegLoss weight exponent
    # ---- model ----
    "arch": "resnet",
    "pretrained": False,
    "bins": [1, 2, 3, 6],
    "dropout": 0.1,
    "m_scale": False,
    "layers": 50,
    "bottleneck_dim": 512,
    "backbone_dim": 2048,
    "heads": 1,
    "resume_weights": "./pretrained_models/",
    "model_dir": "model_ckpt",
    "dist": "dot",             # classifier distance: 'dot' | 'cos' | 'cosN'
    "cls_type": "oooo",
    "inherit_base": False,
    "rmid": None,              # return intermediate layers: e.g. 'l34', 'nr'
    "all_lr": "l",             # which layers contribute every block
    "temp": 20.0,              # attention temperature for matching heads
    "att_wt": 0.5,             # attention blend weight (MMN/DeTr)
    "conv4d": "red",           # 4D conv flavour: 'red' (center pivot) | 'cv4'
    "trans_type": "cross_att", # train_att variant selector
    "sf_att": False,           # DeTr self-attention branch
    "cr_att": True,            # DeTr cross-attention branch
    "red_dim": False,
    "wa": False,
    "agg": "cat",
    "crm_type": "nc",          # train_match head: 'nc' | 'chm'
    "ktype": "psi",            # CHM kernel sharing type
    "att_type": 2,             # train_aug support stream: 0 org, 1 aug, 3 adaptive
    "exp_name": "exp",
    "head": "mmn",             # train_head head selector
    "reduce_dim": 512,         # DeTr feature reduction
    "loss_type": "wt_ce",      # head trainer query loss (SegLoss dispatcher)
    "aux": False,              # aux loss weight (False = off)
    "sce": False,              # MatchNet spatial context encoder
    "cyc": False,              # MatchNet cycle-consistency mask
    "ignore": False,           # match head: ig_mask re-readout (src/train_match.py:320)
    "wt_file": 0,              # 1 -> resume from best1.pth (src/train_aug.py:60)
    "load_bg": False,          # cca1: seed BG row from base classifier (src/train_cca1.py:150)
    "drop": False,             # DeTr adjust-feature dropout
    "matchnet_ckpt": None,     # frozen MatchNet for train_fuse
    "ln": None,                # CrossAttention layer norms
    "fv": None,                # CrossAttention value projection
    "fc": None,                # CrossAttention output projection
    "att_temp": None,          # CrossAttention temperature override
    "trans_vn": False,         # value normalization in attention variants
    "ld_mode": "l",            # LinearDiag mode for AttentionBlock
    "scale_att": "sc",         # learnable attention scale flag
    "att_drop": 0.0,           # WeightAverage attention dropout
    "proj_drop": 0.0,          # WeightAverage projection dropout
    # ---- evaluation ----
    "shot": 1,
    "random_shot": False,
    "episodic": True,
    "episodic_val": True,
    "norm_feat": True,
    "batch_size_val": 100,    # reference CLI compat; the device batching knob
                              # here is episode_batch (vmap width per program)
    "manual_seed": 2021,
    "ckpt_used": "best",
    "test_num": 1000,
    "FB_param_noise": 0,
    "n_runs": 1,
    "save_oracle": False,
    "replay": None,            # episode-log path: replay a recorded stream (parity runs)
    # ---- distributed / TPU ----
    "gpus": [0],               # kept for CLI compat; ignored on TPU
    "distributed": False,
    "port": 0,
    "mesh_shape": None,        # e.g. [8] or [4, 2]; None = all local devices
    "multi_host": False,       # jax.distributed.initialize() before mesh build
    "mesh_axes": ["data"],
    "episode_batch": 8,        # episodes vmapped per device step (eval)
    "compute_dtype": "float32",  # 'float32' | 'bfloat16'
    "bf16_stages": None,       # mixed policy: 'all' or e.g. 'stem,layer1,layer2'
    "remat_head": None,        # recompute head activations in backward
                               # (JAX package knob; the port's MMN head
                               # bounds its volumes by the per-block and
                               # per-shot checkpoints instead)
    "remat_blocks": None,      # per-block remat inside NeighConsensus.
                               # None = route default (models/matching.py
                               # block_remat_default): off on the rank-4
                               # consensus route, on for the flat route
    "eval_episode_tile": 1,    # head/CCA eval + serving: episodes vmapped
                               # per lax.map step (1 = fully sequential, the
                               # rank-4-route-safe default at 473px; rank-5
                               # layouts pad catastrophically there)
    "eval_split_prologue": False,  # head eval: one vmapped backbone+inner
                               # loop pass for the whole batch, lax.map only
                               # the consensus forward (exact; costs E x
                               # staged stage-features in HBM)
    "head_grad_accum": True,   # head train step: accumulate per-episode grads
                               # sequentially (exact; bounds HBM by 1 episode)

    "profile_dir": None,       # torch.profiler trace of validate_transformer (Chrome JSON)
    "resume_ckpt": None,       # orbax ckpt: full train_state (exact resume) or weights
    "auto_resume": False,      # pick up this run's own train_state.ckpt if present
    "stop_after_epochs": None, # preemption drill: exit after N epochs this run
    "param_dtype": "float32",
}


def default_cfg() -> Cfg:
    return Cfg(copy.deepcopy(_DEFAULTS))


def _flatten_yaml(tree: Dict[str, Any]) -> Dict[str, Any]:
    """Flatten {SECTION: {key: val}} into {key: val}; plain keys pass through."""
    flat: Dict[str, Any] = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            for k, v in val.items():
                flat[k] = v
        else:
            flat[key] = val
    return flat


def load_cfg(file: str, with_defaults: bool = True) -> Cfg:
    """Load a YAML config (sections flattened) on top of the defaults table."""
    assert os.path.isfile(file) and file.endswith(".yaml"), (
        f"{file} is not a yaml file"
    )
    with open(file, "r") as f:
        tree = yaml.safe_load(f) or {}
    flat = _flatten_yaml(tree)
    cfg = default_cfg() if with_defaults else Cfg()
    cfg.update(flat)
    return cfg


# Reference-compatible alias (reference: src/util.py:410).
def load_cfg_from_cfg_file(file: str) -> Cfg:
    return load_cfg(file)


def _decode_value(v: Any) -> Any:
    if not isinstance(v, str):
        return v
    try:
        return literal_eval(v)
    except (ValueError, SyntaxError):
        return v


def _coerce(replacement: Any, original: Any, full_key: str) -> Any:
    """Type-check an override against the current entry (reference: src/util.py:377)."""
    if original is None or type(replacement) is type(original):
        return replacement
    # union-typed knobs (reference yaml uses e.g. `aux: False` or `aux: 0.5`)
    if isinstance(original, bool) and isinstance(replacement, str):
        # literal_eval only accepts Python spellings; map shell-style
        # true/false instead of storing a truthy string (the reference raises
        # here, util.py:377-407 — accepting 'false' as ON would be a trap)
        low = replacement.strip().lower()
        if low in ("true", "1", "yes"):
            return True
        if low in ("false", "0", "no"):
            return False
        raise ValueError(
            f"boolean key {full_key} got non-boolean string {replacement!r}"
        )
    if isinstance(original, bool) and isinstance(replacement, (bool, int, float)):
        return replacement
    casts = [(tuple, list), (list, tuple), (int, float)]
    for from_type, to_type in casts:
        if isinstance(replacement, from_type) and isinstance(original, to_type):
            return to_type(replacement)
    raise ValueError(
        f"Type mismatch ({type(original)} vs. {type(replacement)}) with values "
        f"({original} vs. {replacement}) for config key: {full_key}"
    )


def merge_cfg_from_list(cfg: Cfg, opts: List[str]) -> Cfg:
    """Apply ``--opts key value key value ...`` overrides; unknown keys raise."""
    new_cfg = cfg.clone()
    assert len(opts) % 2 == 0, opts
    for full_key, raw in zip(opts[0::2], opts[1::2]):
        subkey = full_key.split(".")[-1]
        assert subkey in cfg, f"Non-existent key: {full_key}"
        value = _coerce(_decode_value(raw), cfg[subkey], full_key)
        new_cfg[subkey] = value
    return new_cfg


def parse_args(description: str = "few_shot_seg_cwt_tpu_torch",
               argv: Optional[List[str]] = None) -> Cfg:
    """CLI entry shared by all trainers: --config file.yaml --opts k v ..."""
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("--config", type=str, required=True, help="config file")
    parser.add_argument("--opts", default=None, nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)
    cfg = load_cfg(args.config)
    if args.opts:
        cfg = merge_cfg_from_list(cfg, args.opts)
    return cfg
