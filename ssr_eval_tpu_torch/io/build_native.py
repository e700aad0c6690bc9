"""Build the port's native IO library (``csrc/ssrio.cpp``, a copy of the
repository's ``native/ssrio.cpp`` that ships in the port's wheel) at first
use (``io/flac_native.py`` loads it with ctypes).

    python -m ssr_eval_tpu_torch.io.build_native     # build now, print the path

One g++ call with the flags of ``native/Makefile``:

    g++ -O3 -fPIC -Wall -std=c++17 -pthread -shared \
        -o <build dir>/ssrio-<hash>.so ssr_eval_tpu_torch/csrc/ssrio.cpp

The library lands in ``_paths.build_dir()`` (the package's ``_build/`` in a
checkout, the user cache in a read-only install) keyed by a hash of the
source and the flags, so an unchanged source is built once per build
directory.  ``make -C native`` is never run: its target lies inside the JAX
package.  Concurrent processes (test workers, or several users of one cache)
serialise on a file lock in the build directory, and each build goes to a
temporary name first, then ``os.replace``, so no process loads a partial
file.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

from ssr_eval_tpu_torch._paths import PKG, build_dir

SOURCE = PKG / "csrc" / "ssrio.cpp"
CXX_FLAGS = ("-O3", "-fPIC", "-Wall", "-std=c++17", "-pthread", "-shared")


def _cxx() -> str:
    cxx = shutil.which("g++")
    if not cxx:
        raise RuntimeError(f"g++ not found on PATH: cannot build {SOURCE}")
    return cxx


def _target() -> Path:
    """The library path for the current source and flags."""
    if not SOURCE.exists():
        raise RuntimeError(f"{SOURCE} not found: the port's native IO source is missing from its package")
    h = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return build_dir() / f"ssrio-{h}.so"


def build() -> Path:
    """Compile csrc/ssrio.cpp unless already built -> the library path.
    Raises RuntimeError with the compiler's output on failure."""
    out = _target()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out.parent / "ssrio.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # another process may be building it
        if out.exists():
            return out
        tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
        cmd = [_cxx(), *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
        r = subprocess.run(cmd, capture_output=True, text=True)
        if r.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"{' '.join(cmd)} failed:\n{r.stdout}{r.stderr}")
        os.replace(tmp, out)
    return out


if __name__ == "__main__":
    print(build())
