"""The port's data parallelism (ssr_eval_tpu_torch.parallel, the helper's
multihost sweep, the trainer's mesh) on the CPU with gloo.

Two real 2-process runs (subprocesses running this file's `__main__`
block, `python -m tests.test_torch_parallel ...`):
- the sweep: helper.evaluate(multihost=True) with mesh=data_mesh("cpu"):
  both ranks return the same merged result, equal to a one-process run
  within __graft_entry__.py's `metric_tol` (LSD, log-SiSpec 1e-3; SiSpec,
  SSIM 1e-4); only rank 0 writes the JSON; the .p0/.p1 journals merge
  through load_partial; a resumed run after a lost journal record scores
  only the lost file, once;
- a data-parallel step of the small UNet generator on a global batch of 4
  rows: loss, every gradient leaf, the updated parameters and the
  BatchNorm running statistics within DP_TOL of the one-process step on
  the same 4 rows (scales in `_dp_violations`); with the BatchNorms' all-reduce switched off the same
  check fails (each rank normalises by its own 2 rows' statistics).
Every subprocess gets communicate(timeout=240) and init_process_group a
60 s timeout.
"""

import json
import os
import socket
import subprocess
import sys
from datetime import timedelta

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
METRIC_TOL = {"lsd": 1e-3, "log_sispec": 1e-3, "sispec": 1e-4, "ssim": 1e-4}  # __graft_entry__.py:132
DP_TOL = 1e-5  # of the one-process step's max (`_dp_violations`)
SPEAKERS = ("p360", "s5")
SR = 16000
SMALL_UNET = dict(widths=(8, 16), blocks_per_group=2)
GLOBAL_BATCH, T_FRAMES = 4, 20


# ----------------------------------------------------------------------
# Subprocess side
# ----------------------------------------------------------------------


def _sweep_helper(root, name, **kw):
    from ssr_eval_tpu_torch.harness.helper import SSR_Eval_Helper
    from ssr_eval_tpu_torch.harness.testee import BatchedTestee

    return SSR_Eval_Helper(
        BatchedTestee(), input_sr=SR, output_sr=SR, evaluation_sr=SR, test_name=name,
        test_data_root=root, setting_fft={"cutoff_freq": [4000]}, auto_download=False,
        batch_size=2, device="cpu", **kw,
    )


def _rank_sweep(rank, root, workdir, out_json):
    """Full sweep, then a lost journal record on rank 1 and a resumed run."""
    from ssr_eval_tpu_torch.parallel import data_mesh

    os.chdir(workdir)
    helper = _sweep_helper(root, "mh2p", mesh=data_mesh("cpu"))
    scored = []
    evaluate_files = helper.engine.evaluate_files
    helper.engine.evaluate_files = lambda paths: (scored.append(list(paths)), evaluate_files(paths))[1]
    first = helper.evaluate(multihost=True, verbose=False)
    lost = None
    if rank == 1:  # a crash lost this rank's last file from its journal
        path = os.path.join("results", "mh2p.partial.p1.jsonl")
        with open(path) as f:
            lines = f.readlines()
        lost = json.loads(lines[-1])["path"]
        with open(path, "w") as f:
            f.writelines(ln for ln in lines if json.loads(ln)["path"] != lost)
    resumed = helper.evaluate(multihost=True, resume=True, verbose=False)
    with open(out_json, "w") as f:
        json.dump({"first": first, "resumed": resumed, "scored": scored, "lost": lost}, f)


def small_unet_trainer(mesh=None):
    """NVSRTrainer with the small UNet generator, seeded weights."""
    from ssr_eval_tpu_torch.models import nvsr
    from ssr_eval_tpu_torch.models.train import NVSRTrainer
    from ssr_eval_tpu_torch.models.unet import UNetRes

    tr = NVSRTrainer(model_name="dnn", mesh=mesh, device=None if mesh is not None else "cpu")
    with torch.device("meta"):
        gen = nvsr.Generator("unet")
    gen.analysis_module = UNetRes(channels=1, **SMALL_UNET)
    tr.model.generator = gen
    return tr, tr.init_state(seed=5)


def global_batch():
    rng = np.random.default_rng(21)
    lr = np.abs(rng.standard_normal((GLOBAL_BATCH, T_FRAMES, 128))).astype(np.float32) + np.float32(1e-3)
    hr = lr + np.float32(0.1) * np.abs(rng.standard_normal(lr.shape)).astype(np.float32)
    return torch.from_numpy(lr), torch.from_numpy(hr)


def step_record(tr, state):
    """One step on the global batch -> {name: array}: the loss, every
    gradient, every parameter after the update, every BatchNorm buffer."""
    state, loss = tr.step(state, *global_batch())
    gen = state["model"]
    out = {"loss": loss.numpy().reshape(1)}
    for k, p in gen.named_parameters():
        out[f"grad/{k}"] = p.grad.numpy()
        out[f"param/{k}"] = p.detach().numpy()
    for k, b in gen.named_buffers():
        if "running" in k:
            out[f"stats/{k}"] = b.numpy()
    return out


def _rank_train(rank, out_npz):
    """The DP step with the BatchNorms synchronised, then without."""
    from ssr_eval_tpu_torch.models.train import make_mesh
    from ssr_eval_tpu_torch.models.unet import FlaxBatchNorm

    synced = step_record(*small_unet_trainer(make_mesh(2, device="cpu")))
    tr, state = small_unet_trainer(make_mesh(device="cpu"))
    for m in state["model"].modules():
        if isinstance(m, FlaxBatchNorm):
            m.sync_stats = False
    local = step_record(tr, state)
    np.savez(out_npz, **{f"synced/{k}": v for k, v in synced.items()}, **{f"local/{k}": v for k, v in local.items()})


def main(mode, address, world, rank, *args):
    from ssr_eval_tpu_torch.parallel.multihost import init_distributed

    rank = int(rank)
    torch.set_num_threads(2)
    init_distributed(address, int(world), rank, device="cpu", timeout=timedelta(seconds=60))
    try:
        {"sweep": _rank_sweep, "train": _rank_train}[mode](rank, *args)
    finally:
        torch.distributed.destroy_process_group()
    print(f"[rank {rank}] ok", flush=True)


# ----------------------------------------------------------------------
# Test side
# ----------------------------------------------------------------------


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_two(mode, per_rank_args):
    address = f"localhost:{_free_port()}"
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="2")
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "tests.test_torch_parallel", mode, address, "2", str(r), *map(str, args)],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
        for r, args in enumerate(per_rank_args)
    ]
    try:
        logs = [p.communicate(timeout=240)[0].decode() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-4000:]}"


def test_pad_batch_for_mesh_and_shard_paths():
    from ssr_eval_tpu.parallel.multihost import shard_paths as jax_shard_paths
    from ssr_eval_tpu_torch.parallel import DataMesh, pad_batch_for_mesh
    from ssr_eval_tpu_torch.parallel.multihost import shard_paths

    mesh = DataMesh({"data": 8}, 0, torch.device("cpu"))
    assert [pad_batch_for_mesh(n, mesh) for n in (5, 8, 9)] == [8, 8, 16]
    assert pad_batch_for_mesh(5, None) == 5
    paths = [f"f{i}" for i in range(7)]
    for world in (1, 2, 3):
        shards = [shard_paths(paths, r, world) for r in range(world)]
        assert shards == [jax_shard_paths(paths, r, world) for r in range(world)]
        assert sorted(p for s in shards for p in s) == sorted(paths)
    assert shard_paths(paths) == paths  # no process group: one rank


def test_gather_and_mesh_in_one_process():
    from ssr_eval_tpu_torch.parallel import data_mesh
    from ssr_eval_tpu_torch.parallel.multihost import gather_results_to_coordinator, is_coordinator

    local = {"a/b.flac": {"proc_fft_8000_44100": {"lsd": 1.25}}}
    assert gather_results_to_coordinator(local) == local
    assert is_coordinator()
    mesh = data_mesh("cpu")
    assert (mesh.shape, mesh.rank, mesh.device) == ({"data": 1}, 0, torch.device("cpu"))


@pytest.fixture(scope="module")
def flac_set(tmp_path_factory):
    from ssr_eval_tpu_torch.harness.fixtures import speechlike
    from ssr_eval_tpu_torch.io.audio import write_flac

    root = tmp_path_factory.mktemp("mp") / "vctk"
    for si, spk in enumerate(SPEAKERS):
        (root / spk).mkdir(parents=True)
        for i in range(2):
            x = speechlike(0.8 + 0.2 * i, SR, seed=300 + 10 * si + i)
            write_flac(str(root / spk / f"{spk}_{i:03d}_mic1.flac"), x[:, None], SR)
    return str(root)


def test_two_process_sweep(flac_set, tmp_path):
    from ssr_eval_tpu_torch.harness.resume import load_partial

    outs = [tmp_path / f"out{r}.json" for r in range(2)]
    for r in range(2):
        (tmp_path / f"w{r}").mkdir()
    _run_two("sweep", [(flac_set, tmp_path / f"w{r}", outs[r]) for r in range(2)])
    r0, r1 = (json.loads(o.read_text()) for o in outs)
    assert r0["first"] == r1["first"] == r0["resumed"] == r1["resumed"]
    assert list(r0["first"]) == [*SPEAKERS, "each_speaker", "averaged"]

    # the first run: round-robin shards, disjoint and complete
    files = sorted(os.path.join(flac_set, s, f) for s in SPEAKERS for f in os.listdir(os.path.join(flac_set, s)))
    assert r0["scored"][0] == files[0::2] and r1["scored"][0] == files[1::2]
    # the resumed run saw both journals: only the file rank 1's journal lost
    # was scored again, once (the 1-file list's shard is rank 0's)
    assert r1["lost"] in files[1::2]
    assert r0["scored"][1:] == [[r1["lost"]]] and r1["scored"][1:] == []

    # rank 0 alone wrote the JSON; one journal per rank
    res0, res1 = (sorted(os.listdir(tmp_path / f"w{r}" / "results")) for r in range(2))
    assert sum(f.endswith("-mh2p.json") for f in res0) == 2 and not any(f.endswith(".json") for f in res1)
    assert "mh2p.partial.p0.jsonl" in res0 and res1 == ["mh2p.partial.p1.jsonl"]
    os.replace(tmp_path / "w1" / "results" / "mh2p.partial.p1.jsonl", tmp_path / "w0" / "results" / "mh2p.partial.p1.jsonl")
    merged = load_partial(str(tmp_path / "w0" / "results" / "mh2p.partial.jsonl"))
    assert sorted(merged) == files and all("proc_fft_8000_16000" in v for v in merged.values())

    # equal to one process
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        single = _sweep_helper(flac_set, "mh1p").evaluate(verbose=False, multihost=False)
    finally:
        os.chdir(cwd)
    worst = {m: 0.0 for m in METRIC_TOL}
    for spk in SPEAKERS:
        assert r0["first"][spk].keys() == single[spk].keys()
        for f, keys in single[spk].items():
            for key, ms in keys.items():
                for m, v in ms.items():
                    worst[m] = max(worst[m], abs(r0["first"][spk][f][key][m] - v))
    assert all(worst[m] <= METRIC_TOL[m] for m in METRIC_TOL), worst


def _dp_violations(got, want, lr):
    """Leaves of `got` outside DP_TOL of the one-process record `want`:
    -> {leaf: error over its scale}.  Scales: the loss and each BatchNorm
    running statistic, their own max; gradients and parameters, the
    model's largest.  A leaf's own max would not do: the UNet's 1-channel
    input BatchNorm and the biases a BatchNorm removes are sums that cancel,
    which float32 rounds differently when the sum is split over two ranks
    (up to ~4e-5 of their own max), and AdamW's first step divides each
    gradient element by |g| + 1e-8, which turns that rounding into
    parameter changes of ~1e-5 of a leaf's max at elements with |g| ~ 3e-8.
    Parameters whose one-process gradient is rounding noise (a true
    gradient of 0) move by a random fraction of lr on both sides: they are
    held within 2 lr."""
    return {k: gap for k, (gap, tol) in _dp_gaps(got, want, lr).items() if not gap <= tol}


def _dp_gaps(got, want, lr):
    """{leaf: (max |got - want| over its scale, its tolerance)} with
    `_dp_violations`' scales and tolerances."""
    gmax = max(np.abs(w).max() for k, w in want.items() if k.startswith("grad/"))
    pmax = max(np.abs(w).max() for k, w in want.items() if k.startswith("param/"))
    gaps = {}
    for k, w in want.items():
        d = float(np.abs(got[k] - w).max())
        scale, tol = float(np.abs(w).max()), DP_TOL
        if k.startswith("grad/"):
            scale = gmax
        elif k.startswith("param/"):
            scale = pmax
            if np.abs(want["grad/" + k[6:]]).max() < 1e-6 * gmax:
                scale, tol = 2 * lr, 1.0
        gaps[k] = (d / scale, tol)
    return gaps


def test_two_process_dp_step_equals_one_process_step(tmp_path):
    outs = [tmp_path / f"rank{r}.npz" for r in range(2)]
    _run_two("train", [(o,) for o in outs])
    tr, state = small_unet_trainer()
    want = step_record(tr, state)
    z0, z1 = (np.load(o) for o in outs)
    for k in want:  # the ranks agree bit for bit
        assert np.array_equal(z0[f"synced/{k}"], z1[f"synced/{k}"]), k
    synced = {k: z0[f"synced/{k}"] for k in want}
    bad = _dp_violations(synced, want, tr.learning_rate)
    assert not bad, bad
    # the trap: per-rank BatchNorm statistics do not give the global step
    local = _dp_violations({k: z0[f"local/{k}"] for k in want}, want, tr.learning_rate)
    assert any(k.startswith("grad/") for k in local) and any(k.startswith("stats/") for k in local), local
    assert max(local.values()) > 100 * DP_TOL, local


if __name__ == "__main__":
    main(*sys.argv[1:])
