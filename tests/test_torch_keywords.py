"""Keyword parity of the port's SSR_Eval_Helper and EvalEngine with the JAX
package's: a script written for the JAX package runs unchanged against the
port with mesh=None or the port's own mesh (`parallel.data_mesh()`),
evaluate(multihost=...) and profile_dir=...; a mesh of another kind (a JAX
Mesh) raises TypeError naming data_mesh, and in a process group of 2 ranks
evaluate shards the files and writes the JSON on rank 0 alone.

The sweeps run on the CPU on the synthetic VCTK set (one speaker, two
files, the identity testee); the variants must give the default call's
"averaged" block exactly and one results JSON each.
"""

import glob
import inspect
import json
import os

import pytest
import torch

from ssr_eval_tpu.harness import engine as j_engine
from ssr_eval_tpu.harness import helper as j_helper
from ssr_eval_tpu_torch.degrade.plan import expand_settings
from ssr_eval_tpu_torch.harness import engine, helper
from ssr_eval_tpu_torch.harness.fixtures import ensure_synthetic_vctk, speechlike
from ssr_eval_tpu_torch.harness.resume import process_journal_path
from ssr_eval_tpu_torch.harness.testee import BatchedTestee
from ssr_eval_tpu_torch.io.audio import write_wav
from ssr_eval_tpu_torch.parallel import DataMesh, data_mesh

# The JAX engine's XLA program-shape knobs: the port runs eagerly and has
# no counterpart (ROADMAP.md 1.17).
XLA_KNOBS = {"infer_fold_max", "mega_batches", "wire_codec", "spec_unroll", "spec_flat", "spec_single"}


@pytest.mark.parametrize(
    "jax_fn,port_fn",
    [
        (j_helper.SSR_Eval_Helper.__init__, helper.SSR_Eval_Helper.__init__),
        (j_helper.SSR_Eval_Helper.evaluate, helper.SSR_Eval_Helper.evaluate),
        (j_engine.EvalEngine.__init__, engine.EvalEngine.__init__),
    ],
    ids=["helper", "evaluate", "engine"],
)
def test_port_takes_every_jax_keyword(jax_fn, port_fn):
    want = inspect.signature(jax_fn).parameters
    got = inspect.signature(port_fn).parameters
    missing = {k for k in want if k not in got} - XLA_KNOBS
    assert not missing, missing
    for k, p in want.items():
        if k in got:
            assert got[k].kind != inspect.Parameter.POSITIONAL_ONLY, k
            assert got[k].default == p.default, (k, got[k].default, p.default)
    assert not XLA_KNOBS & set(got)
    if port_fn is engine.EvalEngine.__init__:
        assert XLA_KNOBS <= set(want)  # the exclusions name real JAX keywords


@pytest.fixture(scope="module")
def vctk(tmp_path_factory):
    return ensure_synthetic_vctk(str(tmp_path_factory.mktemp("kw") / "vctk_test"), files_per_speaker=2)


def _helper(root, **kw):
    return helper.SSR_Eval_Helper(
        BatchedTestee(), 44100, 44100, test_name="kw", test_data_root=root,
        setting_fft={"cutoff_freq": [4000]}, auto_download=False, batch_size=2, device="cpu", **kw,
    )


@pytest.mark.parametrize(
    "ctor,call",
    [({"mesh": None}, {}), ({"mesh": "data_mesh"}, {}), ({}, {"multihost": "auto"}), ({}, {"multihost": True}),
     ({}, {"multihost": False})],
    ids=["mesh-none", "mesh-data", "multihost-auto", "multihost-true", "multihost-false"],
)
def test_single_process_keywords_give_the_default_result(vctk, tmp_path, monkeypatch, ctor, call):
    monkeypatch.chdir(tmp_path)
    if ctor.get("mesh") == "data_mesh":  # a 1-rank mesh: no process group
        ctor = {"mesh": data_mesh("cpu")}
    default = _helper(vctk).evaluate(limit_test_speaker=1, verbose=False)
    assert len(glob.glob("results/*.json")) == 1
    got = _helper(vctk, **ctor).evaluate(limit_test_speaker=1, verbose=False, **call)
    assert got["averaged"] == default["averaged"]
    assert got["averaged"] and len(glob.glob("results/*.json")) == 2
    # one process: the journal keeps its base path
    assert glob.glob("results/*.jsonl") == [os.path.join("results", "kw.partial.jsonl")]
    assert process_journal_path("results/kw.partial.jsonl", 0, 1) == "results/kw.partial.jsonl"


@pytest.mark.parametrize("where", ["helper", "engine"])
def test_a_mesh_raises_naming_the_roadmap_item(vctk, where):
    """A mesh that is not the port's DataMesh (a JAX Mesh, anything else)
    raises TypeError naming data_mesh; the port's mesh runs on its device,
    which a device of another type contradicts."""
    from ssr_eval_tpu.parallel.mesh import data_mesh as jax_data_mesh

    for mesh in (jax_data_mesh(), object()):
        with pytest.raises(TypeError, match="data_mesh"):
            if where == "helper":
                _helper(vctk, mesh=mesh)
            else:
                engine.EvalEngine([], 44100, 44100, 44100, BatchedTestee(), mesh=mesh, device="cpu")
    mesh = data_mesh("cpu")
    if where == "helper":
        assert _helper(vctk, mesh=mesh).engine.device == torch.device("cpu")
    else:
        eng = engine.EvalEngine([], 44100, 44100, 44100, BatchedTestee(), mesh=mesh)
        assert eng.device == torch.device("cpu") and eng.mesh is mesh
    card = DataMesh({"data": 1}, 0, torch.device("cuda", 0))
    with pytest.raises(ValueError, match="contradicts"):
        engine.EvalEngine([], 44100, 44100, 44100, BatchedTestee(), mesh=card, device="cpu")


@pytest.mark.parametrize("multihost", ["auto", True])
def test_several_processes_raise_before_scoring(vctk, tmp_path, monkeypatch, multihost):
    """Rank 1 of a process group of 2 (monkeypatched): evaluate scores only
    its round-robin shard into its own journal, gathers rank 0's shard, and
    returns the whole result without writing a JSON (rank 0 writes it).
    False keeps the JAX package's meaning: every rank runs the whole sweep."""
    monkeypatch.chdir(tmp_path)
    default = _helper(vctk).evaluate(verbose=False)
    files = sorted(glob.glob(os.path.join(vctk, "*", "*.flac")))
    per_file = {p: default[p.split(os.sep)[-2]][os.path.basename(p)] for p in files}
    h = _helper(vctk)
    scored = []
    evaluate_files = h.engine.evaluate_files
    monkeypatch.setattr(h.engine, "evaluate_files", lambda paths: (scored.extend(paths), evaluate_files(paths))[1])

    def all_gather_object(out, obj):  # rank 0 scored the other shard
        out[:] = [{p: per_file[p] for p in files[0::2]}, obj]

    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda group=None: 2)
    monkeypatch.setattr(torch.distributed, "get_rank", lambda group=None: 1)
    monkeypatch.setattr(torch.distributed, "all_gather_object", all_gather_object)
    os.remove(glob.glob("results/*.json")[0])
    got = h.evaluate(verbose=False, multihost=multihost)
    assert scored == files[1::2]
    assert got == default
    assert not glob.glob("results/*.json")
    with open("results/kw.partial.p1.jsonl") as f:  # rank 1's own journal
        assert {json.loads(line)["path"] for line in f} == set(files[1::2])
    with pytest.raises(ValueError, match="multihost"):
        h.evaluate(verbose=False, multihost="yes")


@pytest.mark.parametrize("how", ["argument", "environment"])
def test_profile_dir_writes_a_trace(tmp_path, monkeypatch, how):
    path = str(tmp_path / "u.wav")
    write_wav(path, speechlike(0.3, 44100, seed=5), 44100)
    trace_dir = tmp_path / "trace"
    specs = expand_settings(setting_fft={"cutoff_freq": [8000]}, sr=44100)
    kw = {"profile_dir": str(trace_dir)}
    if how == "environment":
        monkeypatch.setenv("SSR_EVAL_TPU_PROFILE", str(trace_dir))
        kw = {}
    eng = engine.EvalEngine(specs, 44100, 44100, 44100, BatchedTestee(), batch_size=1, device="cpu", **kw)
    res = eng.evaluate_files([path])
    assert set(res[path]) == {specs[0].key}
    traces = glob.glob(str(trace_dir / "*.json"))
    assert len(traces) == 1
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("stft" in str(e.get("name", "")) or "fft" in str(e.get("name", "")) for e in events)
