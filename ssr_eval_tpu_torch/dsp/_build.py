"""Build the package's CUDA sources at first use and load them with ctypes.

Each ``csrc/*.cu`` is compiled by its own ``nvcc`` (all started together)
into a shared library with a plain C interface, for ``sm_90a`` (Hopper):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o <build dir>/<name>-<hash>.so csrc/<name>.cu

The output lands in ``_paths.build_dir()`` (the package's ``_build/`` in a
checkout, the user cache in a read-only install) keyed by a hash of the
source and the flags, so an unchanged source is built once per build
directory; ``-Xptxas -v`` (registers, shared memory, spills) goes to a
``.log`` beside each library.  The sources are ``csrc/*.cu`` only:
``csrc/ssrio.cpp`` is the host IO library, built by ``io/build_native.py``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

from ssr_eval_tpu_torch._paths import PKG, build_dir

CSRC = PKG / "csrc"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): cannot build the CUDA kernels")


def _target(src: Path, out_dir: Path) -> Path:
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return out_dir / f"{src.stem}-{h}.so"


def build_all() -> dict[str, Path]:
    """Compile every csrc/*.cu not built yet, one nvcc each, in parallel.
    -> {source stem: library path}.  Raises with nvcc's output on failure."""
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    srcs = sorted(CSRC.glob("*.cu"))
    jobs = []
    for src in srcs:
        out = _target(src, out_dir)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((src, out, tmp, proc))
    failed = []
    for src, out, tmp, proc in jobs:
        log, _ = proc.communicate()
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{src.name}:\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent process never loads a partial file
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return {src.stem: _target(src, out_dir) for src in srcs}


def library(name: str) -> ctypes.CDLL:
    """The loaded library built from csrc/<name>.cu (builds on first use)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            paths = build_all()
            if name not in paths:
                raise RuntimeError(f"no CUDA source csrc/{name}.cu")
            lib = _libs[name] = ctypes.CDLL(str(paths[name]))
        return lib
