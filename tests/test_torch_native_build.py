"""The port's one native builder (ssr_eval_tpu_torch/_native_build.py) on
the CPU, for its CUDA source and its C++ source alike, with stand-in
compilers (this machine has no nvcc): a script named nvcc and one named g++
that count their runs, write their -o file and fail when told to.

- a library lands in build_dir() under <stem>-<sha256(source + flags)[:16]>.so
  (a CUDA library with its ptxas .log beside it), and a second build runs no
  compiler;
- a changed source or changed flags build a new name;
- two processes that build one library at once run the compiler once and
  get the same path (the file lock per library);
- a failed compile raises with the compiler's output and leaves neither a
  library nor a temporary file, and the next build succeeds.
"""

import hashlib
import os
import subprocess
import sys
from pathlib import Path

import pytest

from ssr_eval_tpu_torch import _native_build, _paths

ROOT = Path(__file__).resolve().parents[1]
SOURCES = ["stft_magnitude.cu", "ssrio.cpp"]

# A stand-in for nvcc and g++: counts its runs in "count" beside it, writes
# its -o file, waits a second when a file "slow" lies beside it, and fails
# with a message when a file "fail" does.
FAKE = """#!/bin/sh
d=$(dirname "$0")
echo "$(basename "$0")" >> "$d/count"
out=
while [ $# -gt 0 ]; do [ "$1" = -o ] && out=$2; shift; done
: > "$out"
[ -e "$d/slow" ] && sleep 1
if [ -e "$d/fail" ]; then echo "stand-in compiler error"; exit 1; fi
echo "ptxas info    : Used 1 registers"
"""

# Builds argv[3] with argv[1] as the package directory once the other
# process has started too (each touches a file in argv[2], then waits for
# both): prints the library's path.
CHILD = """
import os, sys, time
from pathlib import Path
from ssr_eval_tpu_torch import _native_build, _paths
_paths.PKG = Path(sys.argv[1])
ready = Path(sys.argv[2])
(ready / str(os.getpid())).touch()
deadline = time.monotonic() + 120
while len(os.listdir(ready)) < 2 and time.monotonic() < deadline:
    time.sleep(0.01)
print(_native_build.build(_native_build.CSRC / sys.argv[3]))
"""


def fake_compilers(d: Path) -> Path:
    """The stand-in nvcc and g++ in `d` -> d."""
    d.mkdir(parents=True, exist_ok=True)
    for name in ("nvcc", "g++"):
        (d / name).write_text(FAKE)
        (d / name).chmod(0o755)
    return d


def compiler_runs(d: Path) -> int:
    count = d / "count"
    return len(count.read_text().splitlines()) if count.exists() else 0


@pytest.fixture
def fake(tmp_path, monkeypatch):
    """The stand-ins first on PATH and a package directory of its own ->
    (the stand-ins' directory, build_dir())."""
    bin_dir = fake_compilers(tmp_path / "bin")
    monkeypatch.setenv("PATH", f"{bin_dir}{os.pathsep}{os.environ['PATH']}")
    pkg = tmp_path / "pkg"
    pkg.mkdir()
    monkeypatch.setattr(_paths, "PKG", pkg)
    return bin_dir, pkg / "_build"


def _flags(src):
    return _native_build.NVCC_FLAGS if src.endswith(".cu") else _native_build.CXX_FLAGS


@pytest.mark.parametrize("src", SOURCES)
def test_a_library_lands_under_its_hash_name_and_builds_once(src, fake):
    bin_dir, out_dir = fake
    path = _native_build.CSRC / src
    lib = _native_build.build(path)
    h = hashlib.sha256(path.read_bytes() + " ".join(_flags(src)).encode()).hexdigest()[:16]
    stem = path.stem
    assert lib == out_dir / f"{stem}-{h}.so" and lib.exists()
    assert _native_build.build(path) == lib
    assert compiler_runs(bin_dir) == 1
    logs = [f"{stem}-{h}.log"] if src.endswith(".cu") else []
    assert sorted(os.listdir(out_dir)) == sorted([lib.name, f"{stem}.lock", *logs])
    if logs:
        assert "Used 1 registers" in (out_dir / logs[0]).read_text()


@pytest.mark.parametrize("change", ["source", "flags"])
@pytest.mark.parametrize("src", SOURCES)
def test_a_changed_source_or_changed_flags_build_a_new_name(src, change, fake, tmp_path, monkeypatch):
    bin_dir, out_dir = fake
    path = _native_build.CSRC / src
    first = _native_build.build(path)
    if change == "source":
        changed = tmp_path / "src" / src
        changed.parent.mkdir()
        changed.write_bytes(path.read_bytes() + b"\n// changed\n")
        second = _native_build.build(changed)
    else:
        name = "NVCC_FLAGS" if src.endswith(".cu") else "CXX_FLAGS"
        monkeypatch.setattr(_native_build, name, (*getattr(_native_build, name), "-DCHANGED"))
        second = _native_build.build(path)
    assert second != first and second.parent == first.parent == out_dir
    assert second.name.startswith(f"{path.stem}-") and first.exists() and second.exists()
    assert compiler_runs(bin_dir) == 2


@pytest.mark.parametrize("src", SOURCES)
def test_two_processes_building_one_library_run_the_compiler_once(src, fake, tmp_path):
    bin_dir, out_dir = fake
    (bin_dir / "slow").touch()
    ready = tmp_path / "ready"
    ready.mkdir()
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    procs = [
        subprocess.Popen([sys.executable, "-c", CHILD, str(_paths.PKG), str(ready), src], env=env,
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for _ in range(2)
    ]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    paths = {Path(out.strip().splitlines()[-1]) for out, _ in outs}
    assert len(paths) == 1 and paths.pop().parent == out_dir
    assert compiler_runs(bin_dir) == 1


@pytest.mark.parametrize("src", SOURCES)
def test_a_failed_build_raises_with_the_output_and_leaves_no_library(src, fake):
    bin_dir, out_dir = fake
    (bin_dir / "fail").touch()
    path = _native_build.CSRC / src
    with pytest.raises(RuntimeError, match="stand-in compiler error"):
        _native_build.build(path)
    assert not [f for f in os.listdir(out_dir) if f.endswith(".so")]  # neither the library nor its temp file
    (bin_dir / "fail").unlink()
    assert _native_build.build(path).exists()
    assert compiler_runs(bin_dir) == 2
