"""Build the port's CUDA kernels with nvcc into shared libraries.

Each kernel source in ``csrc/`` has a plain C interface and is compiled on
the machine with the card, at first use, into ``build/torch_kernels/``
(gitignored), then loaded with ``ctypes``. A library's file name carries a
hash of its source and flags, so a changed source is never served by a
stale build. ``build`` starts one nvcc per missing library, all at once.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Sequence, Tuple

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

# (source, library stem, extra nvcc flags such as -DFSS_PHASE_CLOCKS)
Spec = Tuple[Path, str, Tuple[str, ...]]


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(fallback):
        return fallback
    raise RuntimeError("nvcc not found: the port's kernels are built on the "
                       "machine with the card, from few_shot_seg_cwt_tpu_torch/csrc")


def library_path(source: Path, stem: str, defines: Sequence[str] = ()) -> Path:
    flags = " ".join((*NVCC_FLAGS, *defines))
    digest = hashlib.sha256(source.read_bytes() + flags.encode())
    return BUILD_DIR / f"{stem}_{digest.hexdigest()[:12]}.so"


def build_command(source: Path, out: Path, defines: Sequence[str] = ()) -> list:
    return [nvcc(), *NVCC_FLAGS, *defines, "-o", str(out), str(source)]


def build(specs: Sequence[Spec]) -> list:
    """Compile every library of ``specs`` that is missing, one nvcc each,
    all started together; returns the libraries' paths in order."""
    outs = [library_path(src, stem, defines) for src, stem, defines in specs]
    jobs = []
    try:
        for (src, _, defines), out in zip(specs, outs):
            if out.exists():
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            proc = subprocess.Popen(build_command(src, Path(tmp), defines),
                                    stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                    text=True)
            jobs.append((src, tmp, out, proc))
        for src, tmp, out, proc in jobs:
            _, err = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {src}:\n{err}")
            os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    finally:
        for _, tmp, _, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.remove(tmp)
    return outs
