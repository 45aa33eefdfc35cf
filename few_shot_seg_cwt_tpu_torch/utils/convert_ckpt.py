"""Checkpoint conversion CLI (reference: convert_pth.py:1-17, generalized).

The port's counterpart of ``few_shot_seg_cwt_tpu.utils.convert_ckpt``.
Modes:

* strip-module: rewrite a torch .pth removing the DDP 'module.' prefix
  (the reference tool's only job), as the JAX package does;
* to-port: read a reference PSPNet or CWT-transformer .pth and write the
  port's checkpoint format (``utils.ckpt.save_ckpt``: the module's
  ``state_dict``), which the trainers (``resume_ckpt``) and ``train.test``
  (``resume_weights``, ``ckpt_used``) load. The JAX package's ``to-flax``
  writes its orbax format instead. The file is loaded into the port's
  module with ``strict=True`` first, so a file that does not fit the
  module fails here and not in a trainer. The module is built from the
  port's default config with ``--opts`` over it; a PSPNet's depth (the
  number of ``layer3`` blocks) and classifier width come from the file.

CLI:
  python -m few_shot_seg_cwt_tpu_torch.utils.convert_ckpt strip-module in.pth out.pth
  python -m few_shot_seg_cwt_tpu_torch.utils.convert_ckpt to-port pspnet in.pth out.pth [--arch vgg]
  python -m few_shot_seg_cwt_tpu_torch.utils.convert_ckpt to-port cwt in.pth out.pth
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional

import torch

from .ckpt import save_ckpt
from .convert import load_torch_checkpoint, strip_module_prefix

# ResNet depth by the number of layer3 blocks
_DEPTH_BY_LAYER3 = {6: 50, 23: 101, 36: 152}


def port_module(kind: str, sd: Dict[str, torch.Tensor], cfg) -> torch.nn.Module:
    """The port's module (``pspnet`` of ``cfg.arch``, or ``cwt``) for a
    reference state_dict ``sd``, built from ``cfg`` with the PSPNet's depth
    and classifier width taken from ``sd``, with ``sd`` loaded into it
    strictly."""
    cfg = cfg.clone()
    if kind == "cwt":
        from ..models.cwt import build_cwt

        model = build_cwt(cfg)
    else:
        from ..models.pspnet import build_pspnet

        cfg.compute_dtype, cfg.use_amp, cfg.bf16_stages = "float32", False, None
        if cfg.get("arch", "resnet") == "resnet":
            blocks = {k.split(".")[1] for k in sd if k.startswith("layer3.")}
            cfg.layers = _DEPTH_BY_LAYER3[len(blocks)]
        if "classifier.weight" in sd:
            cfg.num_classes_tr = int(sd["classifier.weight"].shape[0])
        model = build_pspnet(cfg)
    model.load_state_dict(sd, strict=True)
    return model


def main(argv=None) -> Optional[Dict[str, torch.Tensor]]:
    parser = argparse.ArgumentParser(description="checkpoint converter")
    sub = parser.add_subparsers(dest="mode", required=True)

    p1 = sub.add_parser("strip-module")
    p1.add_argument("src")
    p1.add_argument("dst")

    p2 = sub.add_parser("to-port")
    p2.add_argument("kind", choices=["pspnet", "cwt"])
    p2.add_argument("src")
    p2.add_argument("dst")
    p2.add_argument("--arch", default="resnet", choices=["resnet", "vgg"])
    p2.add_argument("--opts", nargs=argparse.REMAINDER, default=[])

    args = parser.parse_args(argv)
    if args.mode == "strip-module":
        sd = strip_module_prefix(load_torch_checkpoint(args.src))
        torch.save({"state_dict": sd}, args.dst)
        print(f"wrote {args.dst}")
        return sd

    from ..config import default_cfg, merge_cfg_from_list

    cfg = merge_cfg_from_list(default_cfg(), args.opts) if args.opts else default_cfg()
    cfg.arch = args.arch
    state = port_module(args.kind, load_torch_checkpoint(args.src), cfg).state_dict()
    save_ckpt(args.dst, state)
    print(f"wrote {args.dst}")
    return state


if __name__ == "__main__":
    main()
