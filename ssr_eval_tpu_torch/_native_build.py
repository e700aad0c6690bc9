"""Build the package's native sources at first use: one compiler call a
source, into a shared library that its user loads with ctypes.

A CUDA source (``csrc/*.cu``, the kernels, bound in ``dsp/stft_kernel.py``)
goes to ``nvcc`` for ``sm_90a`` (Hopper):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o <build dir>/<stem>-<hash>.so csrc/<stem>.cu

and ``-Xptxas -v`` (registers, shared memory, spills) goes to a ``.log``
beside the library.  A C++ source (``csrc/ssrio.cpp``, a copy of the
repository's ``native/ssrio.cpp``, bound in ``io/flac_native.py``) goes to
``g++`` with the flags of ``native/Makefile``:

    g++ -O3 -fPIC -Wall -std=c++17 -pthread -shared \
        -o <build dir>/ssrio-<hash>.so csrc/ssrio.cpp

``make -C native`` is never run: its target lies inside the JAX package.

The library lands in ``_paths.build_dir()`` (the package's ``_build/`` in a
checkout, the user cache in a read-only install) keyed by a hash of the
source and the flags, so an unchanged source is built once per build
directory.  Processes that build one library at once (test workers, ranks,
several users of one cache) serialise on a file lock per library,
``<stem>.lock`` in the build directory, so the compiler runs once; two
libraries build at the same time.  Each build goes to a temporary name
first, then ``os.replace``, so no process loads a partial file, and a
failed build leaves nothing behind.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

from ssr_eval_tpu_torch._paths import PKG, build_dir

CSRC = PKG / "csrc"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
CXX_FLAGS = ("-O3", "-fPIC", "-Wall", "-std=c++17", "-pthread", "-shared")


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): cannot build the CUDA kernels")


def _cxx() -> str:
    cxx = shutil.which("g++")
    if not cxx:
        raise RuntimeError("g++ not found on PATH: cannot build the native IO library")
    return cxx


def build(src: Path) -> Path:
    """Compile `src` (a ``.cu`` or ``.cpp`` file) unless already built ->
    the library path.  Raises RuntimeError with the compiler's output on
    failure."""
    cuda = src.suffix == ".cu"
    flags = NVCC_FLAGS if cuda else CXX_FLAGS
    if not src.exists():
        raise RuntimeError(f"{src} not found: a native source is missing from the package")
    h = hashlib.sha256(src.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
    out = build_dir() / f"{src.stem}-{h}.so"
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out.parent / f"{src.stem}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # another process may be building it
        if out.exists():
            return out
        tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
        cmd = [_nvcc() if cuda else _cxx(), *flags, "-o", str(tmp), str(src)]
        try:
            r = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            if cuda:
                out.with_suffix(".log").write_text(r.stdout)
            if r.returncode != 0:
                raise RuntimeError(f"{' '.join(cmd)} failed:\n{r.stdout}")
            os.replace(tmp, out)
        finally:
            tmp.unlink(missing_ok=True)
    return out
