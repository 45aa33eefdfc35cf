"""The run's last line and the checks around it."""

from __future__ import annotations

import json
import sys
from typing import Dict, Iterable, List

# top-level module names a run may not hold once its window has closed: the
# JAX stack and the JAX package the program was ported from
FORBIDDEN = ("jax", "jaxlib", "flax", "few_shot_seg_cwt_tpu")


def forbidden_modules(modules: Iterable[str] = None) -> List[str]:
    """Loaded modules whose top-level name (before the first dot) is
    forbidden, compared whole: ``few_shot_seg_cwt_tpu_torch`` is not
    ``few_shot_seg_cwt_tpu``."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".")[0] in FORBIDDEN})


def judged(readings: Dict[str, float], limits: Dict[str, float]) -> Dict[str, Dict]:
    """Each reading beside its limit; a reading without a limit, or a limit
    without a reading, is a fault of the harness and raises."""
    if set(readings) != set(limits):
        raise RuntimeError(f"readings {sorted(readings)} and limits {sorted(limits)} differ")
    return {k: {"value": float(readings[k]), "limit": float(limits[k])} for k in readings}


def is_correct(checks: Dict[str, Dict]) -> bool:
    """Every reading finite and at most its limit."""
    return all(c["value"] == c["value"] and c["value"] <= c["limit"] for c in checks.values())


def print_checks(checks: Dict[str, Dict]) -> None:
    for k, c in checks.items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)


def result_line(result: Dict) -> str:
    """One JSON object; ``checks`` comes last."""
    ordered = {k: v for k, v in result.items() if k != "checks"}
    ordered["checks"] = result["checks"]
    return json.dumps(ordered)
