"""Ahead-of-time export of the serve program as a self-contained artifact.

Counterpart of ``few_shot_seg_cwt_tpu.tools.export_serve``. ``torch.export``
captures the whole episodic predictor (frozen backbone, the ``adapt_iter``
inner loop as the ``fss::adapt_binary`` operator, the CWT weight transform,
the align-corners upsample, the argmax) closed over the weights, and
``torch.export.save`` writes it with the weights inside as a ``.pt2`` file.
A serving host needs no model code and no checkpoint, only ``torch`` and
the port's ``ops`` package, which registers the hand-written kernels as
operators and builds each at its first launch::

    import torch
    import few_shot_seg_cwt_tpu_torch.ops  # noqa: F401  (the fss:: operators)
    program = torch.export.load("cwt_serve.pt2").module()
    with torch.no_grad():
        masks = program(s_img, s_label, q_img, w0)   # (E, H, W) int32

with ``s_img`` (E, shot, H, W, 3) float32 normalised images, ``s_label``
(E, shot, H, W) int32 {0, 1, 255} support masks, ``q_img`` (E, H, W, 3)
float32, all on the device the program was exported on
(``tools/serve_loaded.py`` is that host's side, with launch counts).

One input differs from the JAX artifact's. JAX takes ``rngs`` and draws the
classifier init inside the program; a ``torch.Generator`` cannot be an
input of an exported program, so this artifact takes the init ``w0``
itself, (E, K, 512) float32 (K = 2), which the caller draws with the
engine's ``init_weights(E, generator)`` (``episodic.engine.init_weights``).

``--head {mmn|match}`` exports an extension head's label-free predictor
instead (frozen backbone -> inner loop -> the head's refined query feature
-> blended prediction -> argmax; ``HeadEngine.serve_batch``); ``match``
needs ``ignore False``, as in JAX. ``--head-ckpt`` is a head checkpoint of
``train_head`` (``best.pt``, ``final.pt`` or a full ``train_state.pt``),
random init without it. The ``chm``, ``detr`` and ``fuse`` heads are not
ported (ROADMAP queue 1 items 8, 9 and 10) and raise
``NotImplementedError``, as does ``--mesh``: an exported program runs on
one device, and the port's scale-out (item 13, ``parallel/``) serves over
several cards by one serving process a card, each loading the artifact.

The program is traced at a fixed batch, as JAX's is, on the device the
export runs on (``cuda`` unless ``--device cpu``): exported on the card it
launches the kernels, exported on the CPU it runs their plain versions.
The route switches are read when the program is traced and are fixed in
the artifact, as JAX's "trace-time env vars" are: ``FSS_PIVOT_MXU`` /
``FSS_PIVOT_PALLAS`` (the consensus's flat route on ``pivot_fwd``, else the
rank-4 cuDNN route), ``FSS_INNER_TILE`` (K2 for the batch), and the
config's stage dtype policy (``use_amp``: a bf16 backbone, fp32 head).

Weights resolve exactly as in ``train.test`` (``resume_weights`` ``.pth``
file or stage-1 directory schema, ``ckpt_used`` transformer checkpoint,
the seeded random init for plumbing runs).

CLI::

    python -m few_shot_seg_cwt_tpu_torch.tools.export_serve \\
        --config configs/pascal.yaml --out cwt_serve.pt2 \\
        [--batch 8] [--head mmn --head-ckpt best.pt] [--device cuda] \\
        [--opts resume_weights best.pth ckpt_used best ...]
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Dict, Optional

import torch
from torch import nn

# heads that HeadEngine serves here, and the ROADMAP item of those it cannot
SERVABLE_HEADS = ("mmn", "match")
_UNPORTED_HEADS = {"chm": 8, "detr": 9, "fuse": 10}


class ServeProgram(nn.Module):
    """An engine's ``serve_batch`` as a module of (s_img, s_label, q_img, w0)
    -> (E, H, W) int32 masks; the backbone and the transformer or head are
    its submodules, so the export carries their weights."""

    def __init__(self, engine):
        super().__init__()
        self.backbone = engine.backbone
        self.head = engine.cwt if hasattr(engine, "cwt") else engine.head
        self._engine = engine

    def forward(self, s_img, s_label, q_img, w0):
        return self._engine.serve_batch({"s_img": s_img, "s_label": s_label,
                                         "q_img": q_img}, w0=w0)


def example_inputs(cfg, batch: int, device, num_classes: int) -> tuple:
    """Zero inputs of the serve program's shapes (the trace reads no value)."""
    size, shot = int(cfg.image_size), int(cfg.shot)
    dim = int(cfg.bottleneck_dim)
    return (torch.zeros((batch, shot, size, size, 3), device=device),
            torch.zeros((batch, shot, size, size), dtype=torch.int32, device=device),
            torch.zeros((batch, size, size, 3), device=device),
            torch.zeros((batch, num_classes, dim), device=device))


def _single_device(mesh) -> None:
    if mesh:
        raise NotImplementedError("--mesh: an exported program runs on one device; the "
                                  "port's scale-out (ROADMAP queue 1 item 13) serves over "
                                  "several cards by one serving process a card, each "
                                  "loading this artifact")


def _export(engine, cfg, batch: int, mesh) -> torch.export.ExportedProgram:
    _single_device(mesh)
    program = ServeProgram(engine).eval()
    inputs = example_inputs(cfg, batch, engine.device, engine.num_classes)
    # traced without autograd, so the engine's no_grad regions add no
    # grad-mode nodes to the graph
    with torch.no_grad():
        return torch.export.export(program, inputs, strict=False)


def build_serve_export(cfg, engine, batch: int, mesh=None) -> torch.export.ExportedProgram:
    """The CWT serve program of ``engine`` (an ``EpisodicEngine`` with its
    weights) traced at ``batch`` episodes."""
    return _export(engine, cfg, batch, mesh)


def check_servable(cfg, head_type: str) -> None:
    """Raise unless ``head_type`` has a label-free serve program here."""
    if head_type in _UNPORTED_HEADS:
        raise NotImplementedError(f"head {head_type!r} is not ported (ROADMAP queue 1 "
                                  f"item {_UNPORTED_HEADS[head_type]})")
    if head_type not in SERVABLE_HEADS:
        raise ValueError(f"head {head_type!r} has no label-free serving form")
    if head_type == "match" and cfg.get("ignore", False):
        raise ValueError("match-head serving requires `ignore False`: the eval-time "
                         "ig-mask re-readout consumes the query label")


def build_head_serve_export(cfg, head_type: str, engine, batch: int,
                            mesh=None) -> torch.export.ExportedProgram:
    """An extension head's label-free predictor (``HeadEngine.serve_batch``
    of ``engine``, with its weights) traced at ``batch`` episodes."""
    check_servable(cfg, head_type)
    return _export(engine, cfg, batch, mesh)


def load_head_engine(cfg, head_type: str, head_ckpt: Optional[str], device):
    """A ``HeadEngine`` with the backbone per the ``train.test`` rules and
    the head's weights from ``head_ckpt`` (random init without it)."""
    from ..episodic.heads import HeadEngine
    from ..models.pspnet import build_pspnet
    from ..train.test import load_eval_backbone
    from ..utils.ckpt import load_ckpt

    check_servable(cfg, head_type)
    backbone = build_pspnet(cfg)
    load_eval_backbone(cfg, backbone)
    engine = HeadEngine(cfg, head_type, backbone=backbone, device=device)
    if head_ckpt:
        state = load_ckpt(str(head_ckpt))
        engine.head.load_state_dict(state["model"] if "optimizer" in state else state)
        print(f"=> loaded head weights '{head_ckpt}'")
    return engine


def export_to_file(cfg, out_path: str, batch: int, mesh_devices: int = 0,
                   head: Optional[str] = None, head_ckpt: Optional[str] = None,
                   device="cuda") -> Dict:
    """Load the weights per the ``train.test`` rules, export, and write the
    ``.pt2``; returns what was written."""
    from ..episodic.engine import EpisodicEngine
    from ..train.common import fp32_parity
    from ..train.test import load_eval_weights

    fp32_parity()
    _single_device(mesh_devices)
    t0 = time.perf_counter()
    if head:
        engine = load_head_engine(cfg, head, head_ckpt, device)
        exported = build_head_serve_export(cfg, head, engine, batch)
    else:
        engine = EpisodicEngine(cfg, device=device)
        load_eval_weights(cfg, engine)
        exported = build_serve_export(cfg, engine, batch)
    export_s = time.perf_counter() - t0
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    torch.export.save(exported, out_path)
    ops = sorted({str(n.target) for n in exported.graph.nodes
                  if str(n.target).startswith("fss.")})
    return {
        "path": os.path.abspath(out_path),
        "bytes": os.path.getsize(out_path),
        "platforms": [engine.device.type],
        "batch": batch,
        "shot": int(cfg.shot),
        "image_size": int(cfg.image_size),
        "devices": 1,
        "head": head or "cwt",
        "operators": ops,
        "export_s": export_s,
    }


def main(argv=None) -> Dict:
    from ..config import load_cfg, merge_cfg_from_list

    p = argparse.ArgumentParser(description="Export the serve program")
    p.add_argument("--config", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--batch", type=int, default=8,
                   help="episodes per serving call (fixed in the artifact)")
    p.add_argument("--mesh", type=int, default=0,
                   help="raises: an artifact runs on one device (serve over several "
                        "cards by one process a card); 0 = single-device artifact")
    p.add_argument("--head", default=None,
                   help="export this extension head's predictor instead of the CWT "
                        "one (mmn|match; chm|detr|fuse are not ported)")
    p.add_argument("--head-ckpt", default=None,
                   help="train_head's best.pt / final.pt / train_state.pt; random "
                        "init if omitted")
    p.add_argument("--device", default="cuda",
                   help="device the program is traced for (cuda, or cpu)")
    p.add_argument("--opts", nargs=argparse.REMAINDER, default=[])
    args = p.parse_args(argv)

    if args.head_ckpt and not args.head:
        p.error("--head-ckpt requires --head (otherwise the CWT predictor "
                "would be exported and the head checkpoint silently ignored)")
    cfg = load_cfg(args.config)
    if args.opts:
        cfg = merge_cfg_from_list(cfg, args.opts)
    info = export_to_file(cfg, args.out, args.batch, mesh_devices=args.mesh,
                          head=args.head, head_ckpt=args.head_ckpt, device=args.device)
    print(info)
    return info


if __name__ == "__main__":
    main()
