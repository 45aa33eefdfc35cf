"""Carry weights from the JAX package's flax variables to the port.

The JAX package imports reference ``.pth`` state_dicts with
``few_shot_seg_cwt_tpu.utils.ckpt.import_pspnet`` / ``import_cwt`` /
``import_mmn``. These
functions are their inverse: they take flax variables as nested dicts of
numpy arrays and return a torch ``state_dict`` under the reference repo's
parameter names, which are the port's module names. So flax variables load
into the port with ``load_state_dict``, and so does a reference ``.pth``.

* conv kernels HWIO -> OIHW; Dense kernels (in, out) -> Linear (out, in);
* BN ``scale``/``bias`` (params) and ``mean``/``var`` (batch_stats) ->
  ``weight``/``bias``/``running_mean``/``running_var``, plus
  ``num_batches_tracked``;
* the classifier (C, K) -> a (K, C, 1, 1) 1x1 conv (``classifier.weight``,
  or ``weight_v`` beside ``weight_g`` (K, 1, 1, 1) under weight norm; the
  cosine classifier's under ``classifier.cls.*``, with
  ``classifier.scale_factor``);
* the VGG trunk's ``stage<s>_conv<b>`` / ``stage<s>_bn<b>`` -> the
  reference's Sequential slices ``layer<s>.<3b>`` / ``layer<s>.<3b+1>``.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch

_STEM = {"conv1": "0", "bn1": "1", "conv2": "3", "bn2": "4", "conv3": "6", "bn3": "7"}


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True))


def _conv(kernel) -> torch.Tensor:
    return _t(np.asarray(kernel).transpose(3, 2, 0, 1))  # HWIO -> OIHW


def _bn(sd: Dict[str, torch.Tensor], prefix: str, params: Mapping,
        stats: Mapping) -> None:
    sd[prefix + ".weight"] = _t(params["scale"])
    sd[prefix + ".bias"] = _t(params["bias"])
    sd[prefix + ".running_mean"] = _t(stats["mean"])
    sd[prefix + ".running_var"] = _t(stats["var"])
    sd[prefix + ".num_batches_tracked"] = torch.tensor(0, dtype=torch.long)


def pspnet_state_dict_from_flax(variables: Mapping[str, Any],
                                dist: str = "dot") -> Dict[str, torch.Tensor]:
    """flax PSPNet variables (ResNet or VGG trunk) -> torch state_dict;
    ``dist`` names the classifier (``dot``, or ``cos`` / ``cosN`` for the
    cosine classifier), which the variables alone do not tell apart."""
    params, stats = variables["params"], variables.get("batch_stats", {})
    sd: Dict[str, torch.Tensor] = {}
    trunk, trunk_stats = params["trunk"], stats.get("trunk", {})
    for name, p in trunk.items():
        m = re.match(r"stage([0-4])_(conv|bn)(\d+)$", name)
        if not m:
            continue
        idx = 3 * int(m.group(3)) + (m.group(2) == "bn")
        prefix = f"layer{m.group(1)}.{idx}"
        if m.group(2) == "conv":
            sd[prefix + ".weight"] = _conv(p["kernel"])
            sd[prefix + ".bias"] = _t(p["bias"])
        else:
            _bn(sd, prefix, p, trunk_stats[name])
    for name, idx in _STEM.items():     # the ResNet's deep stem
        if name not in trunk:
            continue
        if name.startswith("conv"):
            sd[f"layer0.{idx}.weight"] = _conv(trunk[name]["kernel"])
        else:
            _bn(sd, f"layer0.{idx}", trunk[name], trunk_stats[name])
    for block, p in trunk.items():
        m = re.match(r"layer([1-4])_(\d+)$", block)
        if not m:
            continue
        prefix = f"layer{m.group(1)}.{m.group(2)}"
        s = trunk_stats[block]
        for sub, leaf in p.items():
            if sub.startswith("conv"):
                sd[f"{prefix}.{sub}.weight"] = _conv(leaf["kernel"])
            elif sub.startswith("bn"):
                _bn(sd, f"{prefix}.{sub}", leaf, s[sub])
            elif sub == "downsample_conv":
                sd[f"{prefix}.downsample.0.weight"] = _conv(leaf["kernel"])
            elif sub == "downsample_bn":
                _bn(sd, f"{prefix}.downsample.1", leaf, s[sub])
    for key, leaf in params["ppm"].items():
        m = re.match(r"bin(\d+)_(conv|bn)$", key)
        i, kind = m.group(1), m.group(2)
        if kind == "conv":
            sd[f"ppm.features.{i}.1.weight"] = _conv(leaf["kernel"])
        else:
            _bn(sd, f"ppm.features.{i}.2", leaf, stats["ppm"][key])
    sd["bottleneck.0.weight"] = _conv(params["bottleneck_conv"]["kernel"])
    _bn(sd, "bottleneck.1", params["bottleneck_bn"], stats["bottleneck_bn"])
    cls = params["classifier"]
    prefix = "classifier.cls." if dist in ("cos", "cosN") else "classifier."
    w = _t(np.asarray(cls["weight"]).T[:, :, None, None])   # (C, K) -> (K, C, 1, 1)
    if "weight_g" in cls:
        sd[prefix + "weight_v"] = w
        sd[prefix + "weight_g"] = _t(np.asarray(cls["weight_g"]).reshape(-1, 1, 1, 1))
    else:
        sd[prefix + "weight"] = w
    if "bias" in cls:
        sd[prefix + "bias"] = _t(cls["bias"])
    if "scale_factor" in cls:
        sd["classifier.scale_factor"] = _t(cls["scale_factor"])
    if "gamma" in params:
        sd["gamma"] = _t(params["gamma"])
    return sd


def cwt_state_dict_from_flax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """flax MultiHeadAttentionOne variables -> torch state_dict."""
    p = variables["params"]
    return {
        "w_qkvs.weight": _t(np.asarray(p["w_qkvs"]["kernel"]).T),
        "fc.weight": _t(np.asarray(p["fc"]["kernel"]).T),
        "fc.bias": _t(p["fc"]["bias"]),
        "layer_norm.weight": _t(p["layer_norm"]["scale"]),
        "layer_norm.bias": _t(p["layer_norm"]["bias"]),
    }


def mmn_state_dict_from_flax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """flax MMN variables (or their ``params`` tree) -> torch state_dict.

    Reference names, as ``utils/ckpt.py:import_mmn`` reads them: the
    consensus pivot pair ``conv4d_{i}/conv_query|conv_support`` becomes
    ``corr_net.NeighConsensus.conv.{2i}.conv1|conv2`` (the Sequential
    interleaves ReLUs), ``wa_{bid}/conv_*`` stays ``wa_{bid}.conv_*`` and
    ``rd_{bid}`` becomes ``rd_{bid}.0``.
    """
    params = variables.get("params", variables)
    sd: Dict[str, torch.Tensor] = {}
    for block, pair in params["corr_net"]["ncons"].items():
        i = int(re.fullmatch(r"conv4d_(\d+)", block).group(1))
        for flax_name, ref_name in (("conv_query", "conv1"), ("conv_support", "conv2")):
            prefix = f"corr_net.NeighConsensus.conv.{2 * i}.{ref_name}"
            sd[prefix + ".weight"] = _conv(pair[flax_name]["kernel"])
            if "bias" in pair[flax_name]:
                sd[prefix + ".bias"] = _t(pair[flax_name]["bias"])
    for name, node in params.items():
        if name.startswith("wa_"):
            for conv_name, leaf in node.items():
                sd[f"{name}.{conv_name}.weight"] = _conv(leaf["kernel"])
                sd[f"{name}.{conv_name}.bias"] = _t(leaf["bias"])
        elif name.startswith("rd_"):
            sd[f"{name}.0.weight"] = _conv(node["kernel"])
    return sd


def strip_module_prefix(state_dict: Mapping[str, Any]) -> Dict[str, Any]:
    """Remove the DDP 'module.' prefix of reference checkpoints."""
    return {re.sub(r"^module\.", "", k): v for k, v in state_dict.items()}


def load_torch_checkpoint(path: str) -> Dict[str, Any]:
    """A reference ``.pth``'s state_dict (unwraps {'state_dict': ...}).

    Loads tensors only (``weights_only=True``): a checkpoint is data.
    """
    blob = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(blob, dict) and "state_dict" in blob:
        blob = blob["state_dict"]
    return strip_module_prefix(blob)
