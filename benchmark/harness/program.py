"""The program under test as the harness builds it: its configuration from
a configuration file, TF32 off, and the seeded weights loaded into it.

The configuration file's ``env`` (the route) is set by ``run.py`` before
the program is imported; its ``keys`` are set on the program's default
configuration. Everything here that reads the program imports it inside a
function, so the reference and the harness's other modules stay free of it.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..reference import pspnet as ref_pspnet
from . import episodes
from .weights import make_state


def tf32_off() -> None:
    """The configurations state fp32: no TF32 in cuBLAS or cuDNN, for the
    program and the reference alike."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def port_cfg(config: Dict, shrink: Optional[Tuple[int, int]] = None):
    """The program's configuration: its defaults with the file's keys set.
    ``shrink`` (image size, inner steps) is for the CPU tests alone; a
    configuration file that states ``cpu_image_size``, the smallest image
    its model takes, gives that size in place of the shrink's."""
    from few_shot_seg_cwt_tpu_torch.config import default_cfg

    cfg = default_cfg()
    for key, value in config["keys"].items():
        setattr(cfg, key, value)
    if shrink is not None:
        cfg.image_size, cfg.adapt_iter = config.get("cpu_image_size", shrink[0]), shrink[1]
    return cfg


def backbone_state(cfg, gen: torch.Generator, device, calib_episodes: int = 4
                   ) -> Dict[str, torch.Tensor]:
    """Seeded PSPNet weights with BN statistics calibrated, by the
    reference's forward, on the support and query images of
    ``calib_episodes`` seeded episodes: a random init's unit running
    variances blow the features up to norms in the thousands through the
    residual stages, where the 200-step inner loop is chaotic; calibrated
    statistics give a trained network's scale."""
    sd = make_state(ref_pspnet.schema(cfg.layers, cfg.bottleneck_dim, cfg.num_classes_tr,
                                      weight_norm_classifier=str(cfg.cls_type).startswith("r")),
                    gen, device)
    calib = episodes.episodes(gen, calib_episodes, cfg.image_size, device)
    images = torch.cat([calib["s_img"][:, 0], calib["q_img"]])
    ref_pspnet.features(sd, images, cfg.layers, calibrate=True)
    return sd


def pspnet(cfg, sd: Dict[str, torch.Tensor], device):
    """The program's PSPNet with ``sd`` loaded (every name must match)."""
    from few_shot_seg_cwt_tpu_torch.models.pspnet import build_pspnet

    model = build_pspnet(cfg).to(device)
    model.load_state_dict(sd, strict=True)
    return model


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
