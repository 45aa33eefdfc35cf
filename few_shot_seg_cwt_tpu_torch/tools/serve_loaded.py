"""Run a saved serve artifact (``tools/export_serve.py``) as a serving host
does: with ``torch`` and the port's ``ops`` package alone, no model code.

    python -m few_shot_seg_cwt_tpu_torch.tools.serve_loaded ARTIFACT.pt2 \\
        INPUTS.pt OUT.pt [--reps 5]

``INPUTS.pt`` holds ``{"s_img", "s_label", "q_img", "w0"}`` at the
artifact's batch (``torch.save``); the inputs go to the artifact's device
(``--device``, ``cuda`` by default). TF32 is off for matmuls and cuDNN,
as in every entry point of the port (the reference is fp32; the artifact
does not carry the flags). The masks of the first call go to ``OUT.pt``; the last line of the output is one JSON
object with the artifact's load seconds, the hand-written kernels'
launches in that first call, the episodes per second of ``--reps`` timed
calls after it, and the port modules that this process imported (``ops``
only: the check that the artifact carries the whole program).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from .. import ops
from ..ops import cuda_inner_loop, cuda_pivot


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("artifact")
    ap.add_argument("inputs")
    ap.add_argument("out")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    device = torch.device(a.device)
    t0 = time.perf_counter()
    program = torch.export.load(a.artifact).module()
    load_s = time.perf_counter() - t0
    raw = torch.load(a.inputs, map_location="cpu", weights_only=True)
    args = [raw[k].to(device) for k in ("s_img", "s_label", "q_img", "w0")]
    cuda_inner_loop.reset_launches()
    cuda_pivot.reset_launches()
    with torch.no_grad():
        masks = program(*args)
        _sync(device)
        launches = {**cuda_inner_loop.LAUNCHES, **cuda_pivot.LAUNCHES}
        t0 = time.perf_counter()
        for _ in range(a.reps):
            program(*args)
        _sync(device)
        seconds = time.perf_counter() - t0
    torch.save(masks.cpu(), a.out)
    prefix = ops.__name__.rsplit(".", 1)[0] + "."
    result = {
        "load_s": load_s,
        "launches": launches,
        "episodes_per_s": a.reps * args[0].shape[0] / seconds if a.reps else None,
        "port_modules": sorted(m for m in sys.modules if m.startswith(prefix)),
    }
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
