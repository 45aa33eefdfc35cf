"""Run a saved serve artifact (``tools/export_serve.py``) as a serving host
does: with ``torch`` and the port's ``ops`` package alone (and the launch
counters it imports, ``utils.tracing``), no model code.

    python -m few_shot_seg_cwt_tpu_torch.tools.serve_loaded ARTIFACT.pt2 \\
        INPUTS.pt OUT.pt [ARTIFACT2.pt2 INPUTS2.pt OUT2.pt ...] [--reps 5]

``INPUTS.pt`` holds ``{"s_img", "s_label", "q_img", "w0"}`` at the
artifact's batch (``torch.save``); the inputs go to the artifact's device
(``--device``, ``cuda`` by default). TF32 is off for matmuls and cuDNN,
as in every entry point of the port (the reference is fp32; the artifact
does not carry the flags). The masks of the first call go to ``OUT.pt``.
For each artifact, in order, the output has one line, a JSON object with
the artifact's load seconds, the hand-written kernels' launches in that
first call, the episodes per second of ``--reps`` timed calls after it,
and the port modules that this process has imported (``ops`` and
``utils`` only: the check that the artifact carries the whole program).
Several artifacts in one process share its start-up.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from .. import ops
from ..utils import tracing


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("runs", nargs="+", metavar="ARTIFACT INPUTS OUT",
                    help="an artifact, its inputs and the masks' file; repeated")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    if len(a.runs) % 3:
        ap.error("the positional arguments come in threes: ARTIFACT INPUTS OUT")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return [serve_one(*a.runs[i:i + 3], a.reps, torch.device(a.device))
            for i in range(0, len(a.runs), 3)]


def serve_one(artifact: str, inputs: str, out: str, reps: int, device: torch.device) -> dict:
    """Load one artifact, serve its inputs, time ``reps`` calls; print and
    return its JSON line."""
    t0 = time.perf_counter()
    program = torch.export.load(artifact).module()
    load_s = time.perf_counter() - t0
    raw = torch.load(inputs, map_location="cpu", weights_only=True)
    args = [raw[k].to(device) for k in ("s_img", "s_label", "q_img", "w0")]
    tracing.reset()
    with torch.no_grad():
        masks = program(*args)
        _sync(device)
        launches = ops.launch_counts()
        t0 = time.perf_counter()
        for _ in range(reps):
            program(*args)
        _sync(device)
        seconds = time.perf_counter() - t0
    torch.save(masks.cpu(), out)
    prefix = ops.__name__.rsplit(".", 1)[0] + "."
    result = {
        "load_s": load_s,
        "launches": launches,
        "episodes_per_s": reps * args[0].shape[0] / seconds if reps else None,
        "port_modules": sorted(m for m in sys.modules if m.startswith(prefix)),
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
