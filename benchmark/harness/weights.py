"""Seeded weights, made on the device in a few large calls, and their
calibration with the reference.

A schema (the reference's) lists every entry of a ``state_dict`` with its
distribution and scale. All normal entries are carved from one normal draw,
all uniform ones from one uniform draw, in schema order, so a seed gives
the same weights on every device of a kind. The program and the reference
receive the same ``state_dict``.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from ..reference.pspnet import Entry


def make_state(schema: List[Entry], gen: torch.Generator, device) -> Dict[str, torch.Tensor]:
    sizes = {kind: sum(math.prod(s) for _, s, d, _ in schema if d == kind)
             for kind in ("normal", "uniform")}
    pools = {"normal": torch.randn(sizes["normal"], generator=gen, device=device),
             "uniform": torch.rand(sizes["uniform"], generator=gen, device=device) * 2 - 1}
    offsets = {"normal": 0, "uniform": 0}
    out = {}
    for name, shape, dist, scale in schema:
        if dist in pools:
            n = math.prod(shape)
            start = offsets[dist]
            out[name] = (pools[dist][start:start + n] * scale).reshape(shape)
            offsets[dist] = start + n
        elif dist == "const":
            out[name] = torch.full(shape, float(scale), device=device)
        elif dist == "count":
            out[name] = torch.zeros(shape, dtype=torch.int64, device=device)
        else:
            raise ValueError(f"{name}: unknown distribution {dist!r}")
    return out


def clone_state(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().clone() for k, v in sd.items()}
