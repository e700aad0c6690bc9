"""The port as a distribution of its own: its wheel (built from
ssr_eval_tpu_torch/pyproject.toml) carries every source it builds and
requires no JAX, the root distribution leaves it out, and an install in a
read-only directory, run from outside the checkout, builds its native FLAC
library into the user cache and gives the checkout's results exactly."""

import email
import json
import os
import subprocess
import sys
import tomllib
import zipfile
from pathlib import Path

import pytest
import setuptools

import ssr_eval_tpu_torch
from ssr_eval_tpu_torch import _native_build, _paths
from tests.port_install import build_wheel, copy_package, install_read_only, make_writable
from tests.test_torch_native_build import fake_compilers

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "ssr_eval_tpu_torch"
CACHE = Path("ssr_eval_tpu_torch") / ssr_eval_tpu_torch.__version__

# Run in a subprocess from a scratch cwd: the smoke run of the README on the
# synthetic VCTK set, with the helper recorded so its engine's decoders can be
# read, and what the process saw written to argv[1] as JSON.
CHILD = r"""
import importlib.util, json, os, sys
import ssr_eval_tpu_torch
from ssr_eval_tpu_torch.harness import helper as H
from ssr_eval_tpu_torch.harness.fixtures import ensure_synthetic_vctk
from ssr_eval_tpu_torch.io import audio, flac_native

helpers = []
evaluate = H.SSR_Eval_Helper.evaluate


def recording(self, *a, **k):
    helpers.append(self)
    return evaluate(self, *a, **k)


H.SSR_Eval_Helper.evaluate = recording
codec = audio.flac_codec()
root = ensure_synthetic_vctk(os.path.abspath("vctk_test"))
res = ssr_eval_tpu_torch.test(test_data_root=root, auto_download=False, device="cpu")
with open(sys.argv[1], "w") as f:
    json.dump({
        "file": ssr_eval_tpu_torch.__file__,
        "codec": codec,
        "library": flac_native._lib()._name if codec == "native" else None,
        "decoders": sorted(helpers[0].engine.stats.decoders),
        "averaged": res["averaged"],
        "sys_path": sys.path,
        "jax_modules": sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "ssr_eval_tpu")),
        "sees_the_jax_package": importlib.util.find_spec("ssr_eval_tpu") is not None,
    }, f)
"""


def _packages(top: Path):
    """Every directory under `top` with an __init__.py, as a dotted name."""
    return sorted(
        ".".join((top.name, *d.relative_to(top).parts))
        for d in [top, *top.rglob("*")]
        if d.is_dir() and (d / "__init__.py").exists() and not {"build", "_build"} & set(d.relative_to(top).parts)
    )


def _project():
    with open(PKG / "pyproject.toml", "rb") as f:
        return tomllib.load(f)


def _files(d: Path):
    return sorted(str(p.relative_to(d)) for p in d.rglob("*"))


@pytest.fixture(scope="module")
def wheel(tmp_path_factory):
    """The port's wheel, built from a copy that also holds a stale build
    output and bytecode (which the wheel must not carry)."""
    work = tmp_path_factory.mktemp("wheel")
    src = copy_package(work)
    for stale in (src / "_build" / "stale.so", src / "__pycache__" / "stale.pyc", src / "csrc" / "__pycache__" / "x.pyc"):
        stale.parent.mkdir(exist_ok=True)
        stale.write_bytes(b"\0")
    return build_wheel(src, work / "dist")


@pytest.fixture(scope="module")
def installed(wheel, tmp_path_factory):
    """The wheel installed read-only, and the smoke run from it and from the
    checkout, each in a subprocess with its own cwd and HOME."""
    work = tmp_path_factory.mktemp("installed")
    target = install_read_only(wheel, work / "site")
    before = _files(target)
    runs = {}
    try:
        for name, path in (("install", target), ("checkout", ROOT)):
            cwd, home = work / f"cwd_{name}", work / f"home_{name}"
            cwd.mkdir()
            home.mkdir()
            env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "XDG_CACHE_HOME")}
            env.update(PYTHONPATH=str(path), HOME=str(home))
            out = work / f"{name}.json"
            proc = subprocess.Popen([sys.executable, "-c", CHILD, str(out)], cwd=cwd, env=env,
                                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            runs[name] = (proc, out, home)
        got = {}
        for name, (proc, out, home) in runs.items():
            log, _ = proc.communicate(timeout=300)
            assert proc.returncode == 0, f"{name} run failed:\n{log[-4000:]}"
            with open(out) as f:
                got[name] = dict(json.load(f), home=home)
        after = _files(target)
    finally:
        make_writable(target)
    return {"target": target, "before": before, "after": after, **got}


def test_wheel_carries_every_module_and_both_sources_and_no_build_output(wheel):
    with zipfile.ZipFile(wheel) as z:
        names = z.namelist()
    shipped = sorted(n for n in names if not n.split("/")[0].endswith(".dist-info"))
    modules = sorted(
        f"ssr_eval_tpu_torch/{p.relative_to(PKG).as_posix()}"
        for p in PKG.rglob("*.py")
        if not {"_build", "build", "__pycache__"} & set(p.relative_to(PKG).parts)
    )
    want = sorted(modules + ["ssr_eval_tpu_torch/csrc/ssrio.cpp", "ssr_eval_tpu_torch/csrc/stft_magnitude.cu"])
    assert shipped == want
    assert not any("/_build/" in n or "__pycache__" in n or n.endswith("pyproject.toml") for n in names)
    assert len(modules) > 60


def test_wheel_metadata_names_the_port_and_requires_no_jax(wheel):
    with zipfile.ZipFile(wheel) as z:
        (meta_name,) = [n for n in z.namelist() if n.endswith(".dist-info/METADATA")]
        meta = email.message_from_bytes(z.read(meta_name))
    assert meta["Name"] == "ssr_eval_tpu_torch"
    assert meta["Version"] == ssr_eval_tpu_torch.__version__ == _project()["project"]["version"]
    assert sorted(meta.get_all("Requires-Dist")) == ["numpy", "scipy", "torch"]
    assert wheel.name == f"ssr_eval_tpu_torch-{ssr_eval_tpu_torch.__version__}-py3-none-any.whl"


def test_requirements_are_the_third_party_modules_the_port_imports():
    """Every top-level module the port imports is its own, the standard
    library's, or one of its three requirements."""
    import ast

    third = set()
    for p in PKG.rglob("*.py"):
        if {"_build", "build"} & set(p.relative_to(PKG).parts):
            continue
        for node in ast.walk(ast.parse(p.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            third |= {n.split(".")[0] for n in names} - set(sys.stdlib_module_names) - {"ssr_eval_tpu_torch"}
    assert third == set(_project()["project"]["dependencies"]) == {"torch", "numpy", "scipy"}


def test_packages_list_is_every_package_directory():
    setup = _project()["tool"]["setuptools"]
    assert sorted(setup["packages"]) == _packages(PKG)
    assert setup["package-dir"] == {"ssr_eval_tpu_torch": "."}
    assert sorted(setup["package-data"]["ssr_eval_tpu_torch"]) == ["csrc/*.cpp", "csrc/*.cu"]


def test_native_source_is_a_byte_identical_copy():
    assert (PKG / "csrc" / "ssrio.cpp").read_bytes() == (ROOT / "native" / "ssrio.cpp").read_bytes()


def test_root_distribution_leaves_the_port_out():
    with open(ROOT / "pyproject.toml", "rb") as f:
        find = tomllib.load(f)["tool"]["setuptools"]["packages"]["find"]
    found = setuptools.find_packages(str(ROOT), include=find["include"])
    assert "ssr_eval" in found and "ssr_eval_tpu" in found and "ssr_eval_tpu.dsp" in found
    assert not [p for p in found if p.startswith("ssr_eval_tpu_torch")]
    assert sorted(p for p in found if p != "ssr_eval") == _packages(ROOT / "ssr_eval_tpu")


@pytest.mark.parametrize("case", ["writable", "read_only", "read_only_xdg"])
def test_build_dir_follows_the_package_directorys_write_permission(case, tmp_path, monkeypatch):
    pkg = tmp_path / "pkg"
    pkg.mkdir()
    monkeypatch.setattr(_paths, "PKG", pkg)
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    monkeypatch.delenv("XDG_CACHE_HOME", raising=False)
    want = pkg / "_build"
    if case != "writable":
        pkg.chmod(0o555)
        want = tmp_path / "home" / ".cache" / CACHE
    if case == "read_only_xdg":
        monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "xdg"))
        want = tmp_path / "xdg" / CACHE
    try:
        assert _paths.build_dir() == want
        assert os.listdir(pkg) == [] and not (tmp_path / "home").exists()  # decides, creates nothing
    finally:
        pkg.chmod(0o755)


@pytest.mark.parametrize("src", ["stft_magnitude.cu", "ssrio.cpp"])
def test_cuda_build_of_a_read_only_package_goes_to_the_cache(src, tmp_path, monkeypatch):
    """build() writes the CUDA library and its ptxas log, and the C++
    library, into build_dir(); stand-in compilers (this machine has no
    nvcc) write the -o file."""
    bin_dir = fake_compilers(tmp_path / "bin")
    monkeypatch.setenv("PATH", f"{bin_dir}{os.pathsep}{os.environ['PATH']}")
    pkg = tmp_path / "pkg"
    pkg.mkdir(mode=0o555)
    monkeypatch.setattr(_paths, "PKG", pkg)
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    try:
        lib = _native_build.build(PKG / "csrc" / src)
    finally:
        pkg.chmod(0o755)
    assert sorted(p.name for p in (PKG / "csrc").iterdir() if p.is_file()) == ["ssrio.cpp", "stft_magnitude.cu"]
    assert lib.parent == tmp_path / "cache" / CACHE and lib.exists() and lib.name.startswith(Path(src).stem + "-")
    if src.endswith(".cu"):
        assert "Used 1 registers" in lib.with_suffix(".log").read_text()
    assert os.listdir(pkg) == []


def test_installed_port_imports_from_the_install_and_not_the_checkout(installed):
    run = installed["install"]
    target = installed["target"]
    assert Path(run["file"]).resolve() == (target / "ssr_eval_tpu_torch" / "__init__.py").resolve()
    assert not [p for p in run["sys_path"] if p and Path(p).resolve() == ROOT]
    assert not run["sees_the_jax_package"]
    assert installed["checkout"]["file"] == str(PKG / "__init__.py")


def test_installed_port_builds_and_decodes_flac_natively_from_the_user_cache(installed):
    run = installed["install"]
    assert run["codec"] == "native"
    lib = Path(run["library"])
    assert lib.parent == run["home"] / ".cache" / CACHE and lib.name.startswith("ssrio-")
    assert run["decoders"] == ["native_batch"]
    # the same source and flags give the same hash as the checkout's build
    assert lib.name == Path(installed["checkout"]["library"]).name


def test_installed_port_gives_the_checkouts_results_exactly(installed):
    averaged = installed["install"]["averaged"]
    assert list(averaged) == ["proc_fft_24000_44100"]
    assert averaged == installed["checkout"]["averaged"]


def test_installed_port_imports_no_jax_and_writes_nothing_into_the_install(installed):
    assert installed["install"]["jax_modules"] == []
    assert installed["after"] == installed["before"]
    assert "ssr_eval_tpu_torch/csrc/ssrio.cpp" in installed["before"]
    assert not [f for f in installed["before"] if "_build" in Path(f).parts]
