"""Install the port the way a user does: build its wheel from a copy of
``ssr_eval_tpu_torch/`` with pip, install the wheel into a target directory,
and make that directory read-only.

Used by tests/test_torch_packaging.py (on the CPU) and by chip_smoke.py's
``install`` phase (on the card).  pip runs offline throughout: no index, no
build isolation (the interpreter's own setuptools builds the wheel), no
dependencies, no cache, no version check.
"""

from __future__ import annotations

import shutil
import stat
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "ssr_eval_tpu_torch"
PIP_OFFLINE = ("--no-deps", "--no-index", "--no-cache-dir", "--disable-pip-version-check")


def _pip(*args: str) -> None:
    r = subprocess.run([sys.executable, "-m", "pip", *args], capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        raise RuntimeError(f"pip {' '.join(args)} failed:\n{r.stdout}{r.stderr}")


def copy_package(work) -> Path:
    """Copy the package into work/src, without an earlier in-tree build's
    build/ and *.egg-info (_build/ and __pycache__/ are copied: the wheel must
    leave them out) -> the copy."""
    src = Path(work) / "src"
    shutil.copytree(PKG, src, ignore=shutil.ignore_patterns("build", "*.egg-info"))
    return src


def build_wheel(src, dist) -> Path:
    """pip wheel the package directory `src` into `dist` -> the wheel."""
    _pip("wheel", *PIP_OFFLINE, "--no-build-isolation", "-w", str(dist), str(src))
    (wheel,) = Path(dist).glob("ssr_eval_tpu_torch-*.whl")
    return wheel


def _chmod_tree(target: Path, writable: bool) -> None:
    bits = stat.S_IWUSR | stat.S_IWGRP | stat.S_IWOTH
    for p in [target, *target.rglob("*")]:
        mode = p.stat().st_mode
        p.chmod(mode | stat.S_IWUSR if writable else mode & ~bits)


def install_read_only(wheel, target) -> Path:
    """pip install the wheel into `target` (--target), then take every write
    bit off the tree -> target."""
    target = Path(target)
    _pip("install", *PIP_OFFLINE, "--target", str(target), str(wheel))
    _chmod_tree(target, writable=False)
    return target


def make_writable(target) -> None:
    """Give the owner back write permission, so the tree can be removed."""
    _chmod_tree(Path(target), writable=True)
