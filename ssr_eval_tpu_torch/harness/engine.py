"""Batched evaluation engine on one device.

Dataflow per (native_sr, length-bucket) batch of utterances:

    host decode (thread pool)                        [B files]
      └─ device (torch, queued asynchronously on the card):
           resample native->input_sr and native->evaluation_sr
           target |STFT| + its SSIM box moments      (once per utterance)
           for each family (specs grouped by `family_key`):
             spec-independent degradation work       (once per utterance,
                                                      e.g. the fft STFT)
             then each spec's degradation
           for each spec: testee.infer_batch
           for each spec: resample output->evaluation_sr -> metrics
      └─ host: collate per-file metric dicts (reference-compatible keys)

The fused chain of a device testee runs in those three phases, `_pre`
(input resamples, target, degradations), `_infer` (the testee) and `_post`
(output resamples, metrics, the [S, 4, B] stack).  Each spec's work is
independent of the others', so the order changes no result.

On a CUDA card, with a device testee scoring on the device and nothing
that reads a batch's device buffers after the next batch (no saved audio,
no `host_float64` metrics, no mp3 specs), `_pre` and `_post` are CUDA
graphs, captured once per batch key (native rate, rows, bucket, sample type;
the post phase also per testee output shape) right after that key's first
batch has run eagerly, and replayed for every later batch: the host batch
is copied into the graphs' static inputs, `_pre` is replayed, the testee
runs eagerly on its outputs, its outputs are copied into `_post`'s inputs
and `_post` is replayed.  Every such batch's metrics leave through a
stream-ordered copy into a pinned host slot, and the drain waits on that
batch's event alone.  Everywhere else every batch runs eagerly.

mp3 specs round-trip through the host codec: one job per utterance goes to
a codec thread pool when its batch is dispatched, and the results are
collected at drain time (`codec_wait`), so codec work overlaps decode and
device work.  A device testee then scores each mp3 spec's batch in one
infer -> resample -> metrics chain.

Host testees (`BasicTestee.infer`) are bridged: the degraded batch goes
to host numpy, each utterance is inferred there, and the outputs come back
for batched scoring.

metrics_backend="host_float64" recomputes the fused path's metrics in
float64 NumPy (`metrics.host_reference`) over the device-produced estimate
and ground-truth waveforms, as the JAX engine does; mp3 and host-testee
scores stay on the device.

Keywords follow the JAX package's engine: `mesh` is None or a `DataMesh`
(`ssr_eval_tpu_torch.parallel.data_mesh()`), whose device the engine runs
on: one process drives one card, so the data axis spans processes and the
helper shards files over it; and `profile_dir` (or
SSR_EVAL_TPU_PROFILE) writes a torch.profiler trace of each
`evaluate_files` call.  The JAX engine's XLA program-shape knobs
(`infer_fold_max`, `mega_batches`, `wire_codec`, `spec_unroll`,
`spec_flat`, `spec_single`) have no counterpart: the port runs eagerly
or replays CUDA graphs.  As the JAX engine does, it records each distinct
batch program's key, argument shapes and call count (`_cost_args`,
`_cost_calls`), which `utils.flops.engine_program_costs` reads.

A batch holds exactly its real rows: a bucket's remainder goes out with
fewer rows than `batch_size`, and everything downstream takes the row count
from the batch's shape.  The one exception is measured: on the card a short
batch's testee call runs filled to `batch_size` with copies of its first row
where, at that shape's first call, the filled call took less time than the
call over its rows (`_infer_rows`).  Every per-utterance computation is
independent of the other rows of its batch, so a file scores the same alone
or inside any batch.

`stats` (`utils.profiling.StageTimers`) times each layer as a span: per
batch "decode" (the wait for the next batch; "decode.native" each native
decoder call inside it), "dispatch" ("dispatch.prep": the host->device copy,
and on a batch that runs eagerly both input resamples; "dispatch.target":
the target |STFT| and its SSIM moments; per family and per spec
"dispatch.degrade"; per spec "dispatch.testee" and "dispatch.score": the
output resample and the metrics; "dispatch.replay": each graph replay, the
second with the copy of the testee's outputs into its inputs) and "drain";
"host_infer" and "codec_wait" where those paths run (a host testee's
degradation and the mp3 testee call are timed after the dispatch stage).
"dispatch.target", "dispatch.degrade" and "dispatch.score" open only on a
batch that runs eagerly or captures.  Counters "samples_real" and
"samples_slots" give the native-rate samples of the rows and of every slot
of each packed batch (rows x bucket), so their ratio is the share of the
batch's work that is not length padding; "rows_dispatched" counts the rows,
so over the batches it says how far short batches fall below `batch_size`,
and "testee_rows_filled" the copies a filled testee call adds;
"dispatch_graphed" and "dispatch_eager" count the
batches that replayed and those that ran eagerly, "graph_captures" the
graphs captured.  A testee that defines `bind_stats(stats)` is handed
`stats` when the engine is built, and opens its own spans and counters
there (NVSRTestee: "dispatch.testee.<layer>"); counts it takes on the
device (`stats.add_device`) are settled at the end of every
`evaluate_files`.
"""

from __future__ import annotations

import gc
import os
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple

import numpy as np
import torch

from ssr_eval_tpu_torch.degrade.apply import (
    build_family_apply,
    build_family_pre,
    family_key,
    spec_params,
)
from ssr_eval_tpu_torch.device import held_constants
from ssr_eval_tpu_torch.dsp.resample import (
    apply_resample,
    resample_poly_plan,
    windowed_sinc_plan,
)
from ssr_eval_tpu_torch.dsp.spectral import n_frames_for_length, stft_magnitude
from ssr_eval_tpu_torch.dsp.stft_kernel import stft_magnitude_kernel
from ssr_eval_tpu_torch.harness.testee import state_from_numpy
from ssr_eval_tpu_torch.io.audio import decode_audio, decode_audio_i16, native_flac, write_wav
from ssr_eval_tpu_torch.metrics.kernels import (
    metric_stft_config,
    spectral_metrics,
    spectral_metrics_with_target,
    ssim_target_moments,
)
from ssr_eval_tpu_torch.parallel.mesh import as_data_mesh, mesh_device
from ssr_eval_tpu_torch.utils.bucket import bucket_length
from ssr_eval_tpu_torch.utils.flops import abstract_args
from ssr_eval_tpu_torch.utils.profiling import StageTimers, device_trace

METRIC_KEYS = ("lsd", "log_sispec", "sispec", "ssim")

# Batches whose device results (or codec jobs) may stay queued before the
# oldest is collected: the host decodes and enqueues batch k+1 while the
# card still computes batch k.
MAX_PENDING = 2


class _Graph(NamedTuple):
    """A captured phase: the graph, the outputs each replay writes, the
    |STFT| kernel launches inside it, and the device constants its capture
    read (held here, so no cache eviction frees memory the graph reads)."""

    graph: torch.cuda.CUDAGraph
    out: object
    launches: int
    constants: list

    def replay(self):
        self.graph.replay()
        stft_magnitude_kernel.launches += self.launches  # counts kernel executions
        return self.out


class _Captured(NamedTuple):
    """One batch key's graphs: the static inputs (the batch's samples and
    lengths), the pre phase, and per testee output signature the post
    phase with its static inputs."""

    x: torch.Tensor
    n: torch.Tensor
    pre: _Graph
    post: dict


def _filled(x, n, rows):
    """x [r, L] and n [r] with copies of their first row up to `rows` rows."""
    pad = rows - x.shape[0]
    return torch.cat([x, x[:1].expand(pad, -1)]), torch.cat([n, n[:1].expand(pad)])


def _signature(outs):
    return tuple((tuple(y.shape), y.dtype, tuple(ny.shape), ny.dtype) for y, ny in outs)


def _env_flag(name: str, default: str) -> bool:
    """"0", "false" and "" mean off (the JAX package's env-flag rule)."""
    return os.environ.get(name, default) not in ("0", "false", "")


class EvalEngine:
    # Off: every batch runs eagerly (tests hold the graphs against it).
    _use_graphs = True

    def __init__(
        self,
        specs,
        input_sr,
        output_sr,
        evaluation_sr,
        testee,
        batch_size=4,
        *,
        mesh=None,
        device=None,
        save_processed_result=False,
        test_name="test",
        io_workers=8,
        profile_dir=None,
        journal=None,
        input_res_type="polyphase",
        metrics_backend="device",
    ):
        self.mesh = as_data_mesh(mesh, "EvalEngine")
        self.device = mesh_device(self.mesh, device)
        self.specs = list(specs)
        # Device specs grouped by family key (first-appearance order); an
        # unknown family raises ValueError here.
        self.groups = {}
        for spec in self.specs:
            key = family_key(spec)
            if spec.family != "mp3":
                self.groups.setdefault(key, []).append(spec)
        self.device_specs = [s for g in self.groups.values() for s in g]  # `_degraded` order
        self.mp3_specs = [s for s in self.specs if s.family == "mp3"]
        self.input_sr = int(input_sr)
        self.output_sr = int(output_sr)
        self.evaluation_sr = int(evaluation_sr)
        self.testee = testee
        self.batch_size = int(batch_size)
        self.save_processed_result = save_processed_result
        self.test_name = test_name
        self.io_workers = io_workers
        self.profile_dir = profile_dir
        self.journal = journal
        if input_res_type not in ("polyphase", "kaiser_best"):
            raise ValueError(f"input_res_type must be 'polyphase' or 'kaiser_best', got {input_res_type!r}")
        self.input_res_type = input_res_type
        if metrics_backend not in ("device", "host_float64"):
            raise ValueError(f"metrics_backend must be 'device' or 'host_float64', got {metrics_backend!r}")
        self.metrics_backend = metrics_backend
        self.stats = StageTimers()
        if hasattr(testee, "bind_stats"):
            testee.bind_stats(self.stats)
        self.device_testee = hasattr(testee, "infer_batch")
        self._graphs = {}  # batch key -> _Captured
        self._graph_pool = None
        self._capture_stream = None
        self._host_ring = [None] * (MAX_PENDING + 1)  # pinned metric slots of graphed batches
        self._staging = [None] * (MAX_PENDING + 1)  # pinned input slots, one per result slot
        self._ring_at = 0
        self._weights = {}  # plan key -> device copy of its Wd
        self._fill = {}  # short batch shape -> whether its testee call runs filled (`_infer_rows`)
        self._state = (None, None)  # (testee's state, its device copy)
        # Each distinct batch program dispatched: key -> (fn, argument
        # shapes and dtypes), and key -> calls (utils.flops.engine_program_costs).
        self._cost_args = {}
        self._cost_calls = {}

    # ------------------------------------------------------------------
    # Device constants
    # ------------------------------------------------------------------

    def _plan(self, kind, sr_in, sr_out, max_len):
        """-> (ResamplePlan, its Wd on the device); 'kaiser_best' input
        plans use the windowed-sinc bank (librosa.load parity), all others
        the scipy resample_poly design."""
        key = (kind, sr_in, sr_out, max_len)
        if kind == "in" and self.input_res_type == "kaiser_best":
            plan = windowed_sinc_plan(sr_in, sr_out, max_len)
        else:
            plan = resample_poly_plan(sr_in, sr_out, max_len)
        W = self._weights.get(key)
        if W is None:
            W = self._weights[key] = torch.from_numpy(plan.Wd).to(self.device)
        return plan, W

    def _testee_state(self):
        """The testee's state on the engine's device (copied once per
        distinct source state)."""
        src = self.testee.device_state()
        if self._state[0] is not src:
            self._state = (src, state_from_numpy(src, self.device))
        return self._state[1]

    # ------------------------------------------------------------------
    # Device pipeline
    # ------------------------------------------------------------------

    def _prep(self, x_nat, len_nat, native_sr, lnat):
        """int16 or float32 samples at the native rate -> x_in, n_in (input
        rate), gt, n_gt (evaluation rate)."""
        if x_nat.dtype == torch.int16:
            x_nat = x_nat.to(torch.float32) / 32768.0
        in_plan, Wi = self._plan("in", native_sr, self.input_sr, lnat)
        gt_plan, Wg = self._plan("gt", native_sr, self.evaluation_sr, lnat)
        x_in, n_in = apply_resample(x_nat, len_nat, in_plan, int(in_plan.out_length(lnat)), Wi)
        gt, n_gt = apply_resample(x_nat, len_nat, gt_plan, int(gt_plan.out_length(lnat)), Wg)
        return x_in, n_in, gt, n_gt

    def _resample_out(self, y, ny):
        out_plan, Wo = self._plan("out", self.output_sr, self.evaluation_sr, y.shape[1])
        return apply_resample(y, ny, out_plan, int(out_plan.out_length(y.shape[1])), Wo)

    def _degraded(self, x_in, n_in):
        """-> (spec, degraded batch) for every device spec, in
        `device_specs` order; each family's spec-independent work runs once."""
        lin = x_in.shape[1]
        for fkey, gspecs in self.groups.items():
            with self.stats.stage("dispatch.degrade"):
                ctx = build_family_pre(fkey, lin)(x_in, n_in)
                deg_apply = build_family_apply(fkey, lin)
            for spec in gspecs:
                with self.stats.stage("dispatch.degrade"):
                    d = deg_apply(ctx, x_in, n_in, spec_params(spec, lin, self.device))
                yield spec, d

    def _pre(self, x_in, n_in, gt, n_gt):
        """The fused chain's first phase: the target |STFT| and its SSIM
        moments once per utterance, then every device spec's degradation.
        Device testees preserve lengths (the reference itself asserts
        |delta len| < 100), so the truncate-to-min length is shared across
        specs.  -> {"n_in", "min_len", "tgt_sp", "moments", "degraded"
        (one batch per device spec, in `device_specs` order)}."""
        with self.stats.stage("dispatch.target"):
            ratio_plan = resample_poly_plan(self.output_sr, self.evaluation_sr, 1024)
            cfg = metric_stft_config(self.evaluation_sr)
            mf = cfg.max_frames(gt.shape[1])
            min_len = torch.minimum(ratio_plan.out_length(n_in), n_gt)
            tgt_sp = stft_magnitude(gt, min_len, cfg, mf)
            nf = n_frames_for_length(cfg, min_len)
            m2 = (torch.arange(mf, device=gt.device)[None, :] < nf[:, None]).to(tgt_sp.dtype)
            moments = ssim_target_moments(tgt_sp * m2[:, :, None])
        degraded = [d for _, d in self._degraded(x_in, n_in)]
        return {"n_in": n_in, "min_len": min_len, "tgt_sp": tgt_sp, "moments": moments, "degraded": degraded}

    def _infer(self, pre):
        """The testee over each degraded batch -> [(y, ny)] per spec."""
        state = self._testee_state()
        outs = []
        for d in pre["degraded"]:
            with self.stats.stage("dispatch.testee"):
                outs.append(self._infer_rows(d, pre["n_in"], state))
        return outs

    def _infer_rows(self, x, n, state):
        """One testee call over a batch's rows -> (y, ny) with as many rows.

        On the card a short batch's call runs at its own rows or, where that
        was measured slower, filled to `batch_size` with copies of its first
        row and cut back after: a library may choose a far slower algorithm
        for some row counts (on an H100, cuDNN's heuristics take an FFT
        convolution of 33,024 launches for one NVSR UNet layer at 5 and 7
        rows, 4-5x the time of 8 rows).  Each shape is measured once, at its
        first call."""
        rows = x.shape[0]
        if rows >= self.batch_size or self.device.type != "cuda":
            return self.testee.infer_batch(x, n, state)
        key = (tuple(x.shape), x.dtype)
        if key not in self._fill:
            out = self.testee.infer_batch(x, n, state)
            self._fill[key] = self._fill_is_cheaper(x, n, state)
            return out
        if not self._fill[key]:
            return self.testee.infer_batch(x, n, state)
        self.stats.add("testee_rows_filled", self.batch_size - rows)
        y, ny = self.testee.infer_batch(*_filled(x, n, self.batch_size), state)
        return y[:rows], ny[:rows]

    def _fill_is_cheaper(self, x, n, state):
        """Whether the testee's call over x's rows filled to `batch_size`
        takes less time on the card than over x's rows alone: one timed call
        of each, after a first filled call (the library's own set-up for
        that shape).  Off the count of |STFT| launches, as a capture's are."""
        launches = stft_magnitude_kernel.launches
        xf, nf = _filled(x, n, self.batch_size)
        self.testee.infer_batch(xf, nf, state)

        def ms(a, b):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.current_stream(self.device).synchronize()  # both calls start on an idle card
            start.record()
            self.testee.infer_batch(a, b, state)
            end.record()
            end.synchronize()
            return start.elapsed_time(end)

        cheaper = ms(xf, nf) < ms(x, n)
        stft_magnitude_kernel.launches = launches
        return cheaper

    def _post(self, pre, outs):
        """The fused chain's last phase: each spec's output resample and
        metrics -> (metrics [S, 4, B] in `device_specs` order, [(ye, ne)]
        per spec or None)."""
        cfg = metric_stft_config(self.evaluation_sr)
        mf = pre["tgt_sp"].shape[1]
        want_audio = self.save_processed_result or self.metrics_backend == "host_float64"
        rows, audio = [], []
        for y, ny in outs:
            with self.stats.stage("dispatch.score"):
                ye, ne = self._resample_out(y, ny)
                m = spectral_metrics_with_target(ye, pre["min_len"], pre["tgt_sp"], cfg, mf, pre["moments"])
                rows.append(torch.stack([m[k] for k in METRIC_KEYS]))
            if want_audio:
                audio.append((ye, ne))
        return torch.stack(rows), (audio if want_audio else None)

    def _fused_batch(self, x_in, n_in, gt, n_gt):
        """The sweep chain for a device testee over every device spec:
        `_pre`, `_infer`, `_post`.  -> (metrics [S, 4, B], [(ye, ne)] per
        spec or None)."""
        pre = self._pre(x_in, n_in, gt, n_gt)
        return self._post(pre, self._infer(pre))

    # ------------------------------------------------------------------
    # CUDA graphs of the fused chain
    # ------------------------------------------------------------------

    def _graphs_engage(self):
        """Whether this engine's batches go through CUDA graphs: a device
        testee scoring on the card, and nothing that reads a batch's device
        buffers after the next batch replays over them."""
        return (
            self._use_graphs
            and self.device.type == "cuda"
            and self.device_testee
            and bool(self.device_specs)
            and not self.mp3_specs
            and self.metrics_backend == "device"
            and not self.save_processed_result
        )

    def _capture(self, fn):
        """Capture fn() as a CUDA graph in the engine's pool -> _Graph.

        fn runs once first on the capture stream, so per-stream lazy state
        (cuBLAS workspaces) exists before the capture; the |STFT| launches
        of that run and of the capture are taken back off the count, which
        counts kernel executions.  The cuFFT plans the graph runs stay in
        torch's plan cache (4096 plans; the sweep uses a few dozen).  The
        cyclic garbage collector stays off during the capture: a collection
        there can free another engine's graph, whose destruction is an
        operation a capture forbids and which ends it."""
        if self._capture_stream is None:
            self._capture_stream = torch.cuda.Stream(self.device)
            self._graph_pool = torch.cuda.graph_pool_handle()
        stream, launches = self._capture_stream, stft_magnitude_kernel.launches
        with held_constants() as constants:
            stream.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(stream):
                fn()
            torch.cuda.current_stream(self.device).wait_stream(stream)
            graph = torch.cuda.CUDAGraph()
            before = stft_magnitude_kernel.launches
            collecting = gc.isenabled()
            gc.disable()
            try:
                with torch.cuda.graph(graph, pool=self._graph_pool, stream=stream):
                    out = fn()
            finally:
                if collecting:
                    gc.enable()
        captured = stft_magnitude_kernel.launches - before
        stft_magnitude_kernel.launches = launches
        self.stats.add("graph_captures", 1)
        return _Graph(graph, out, captured, constants)

    def _capture_post(self, cap, outs):
        """Capture the post phase over the pre graph's outputs and static
        copies of the testee outputs `outs` (the pre graph's outputs hold a
        batch's data)."""
        statics = [(y.clone(), ny.clone()) for y, ny in outs]
        pre = cap.pre.out[1]
        cap.post[_signature(outs)] = (statics, self._capture(lambda: self._post(pre, statics)[0]))

    def _dispatch_graphed(self, sr, b, xb, lens):
        """One batch through its key's graphs; the key's first batch, or the
        first with a new testee output signature, runs eagerly and then
        captures.  -> (`_fused_batch`'s arguments, metrics [S, 4, B] on the
        device, whether both phases replayed)."""
        key = (sr, xb.shape[0], b, xb.dtype.str)
        cap = self._graphs.get(key)
        with self.stats.stage("dispatch.prep"):
            if cap is None:
                x, n = torch.from_numpy(xb).to(self.device), torch.from_numpy(lens).to(self.device)
                args = self._prep(x, n, sr, b)
            else:
                hn, hx = self._staged(lens, xb)
                cap.n.copy_(hn, non_blocking=True)
                cap.x.copy_(hx, non_blocking=True)
        if cap is None:
            pre = self._pre(*args)
            outs = self._infer(pre)
            mstack, _ = self._post(pre, outs)

            def pre_phase():
                a = self._prep(x, n, sr, b)
                return a, self._pre(*a)

            cap = self._graphs[key] = _Captured(x, n, self._capture(pre_phase), {})
            cap.pre.graph.replay()  # fills the pre graph's outputs for the post capture; counts no batch
            self._capture_post(cap, outs)
            return args, mstack, False
        with self.stats.stage("dispatch.replay"):
            args, pre = cap.pre.replay()
        outs = self._infer(pre)
        post = cap.post.get(_signature(outs))
        if post is None:
            mstack, _ = self._post(pre, outs)
            self._capture_post(cap, outs)
            return args, mstack, False
        statics, graph = post
        with self.stats.stage("dispatch.replay"):
            for (ys, nys), (y, ny) in zip(statics, outs):
                ys.copy_(y)
                nys.copy_(ny)
            mstack = graph.replay()
        return args, mstack, True

    def _staged(self, *arrays):
        """Host arrays -> copies in this batch's pinned staging slot (views
        of one buffer, grown as needed).  The slot goes with the batch's
        result slot: batch k's comes round at batch k + MAX_PENDING + 1,
        after batch k's drain waited on an event that follows its copies
        to the card."""
        src = [torch.from_numpy(a) for a in arrays]
        need = sum(t.nbytes for t in src)
        slot = self._staging[self._ring_at]
        if slot is None or slot.numel() < need:
            slot = self._staging[self._ring_at] = torch.empty(need, dtype=torch.uint8, pin_memory=True)
        out, at = [], 0
        for t in src:  # widest dtype first keeps every view aligned
            out.append(slot[at : at + t.nbytes].view(t.dtype).view(t.shape).copy_(t))
            at += t.nbytes
        return out

    def _copy_out(self, mstack):
        """Copy a batch's metrics into the next pinned host slot (a view of
        one buffer, grown as needed: batches differ in rows), in stream
        order -> (slot, event recorded after the copy).  The ring has
        MAX_PENDING + 1 slots, so a slot comes round again only after the
        batch that held it was drained."""
        buf = self._host_ring[self._ring_at]
        if buf is None or buf.numel() < mstack.nbytes:
            buf = self._host_ring[self._ring_at] = torch.empty(mstack.nbytes, dtype=torch.uint8, pin_memory=True)
        slot = buf[: mstack.nbytes].view(mstack.dtype).view(mstack.shape)
        self._ring_at = (self._ring_at + 1) % len(self._host_ring)
        slot.copy_(mstack, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(self.device))
        return slot, done

    def _record_cost(self, key, fn, args):
        """Remember a dispatched program's argument shapes (no buffer
        references) and count its calls."""
        if key not in self._cost_args:
            self._cost_args[key] = (fn, abstract_args(args))
        self._cost_calls[key] = self._cost_calls.get(key, 0) + 1

    def _score_batch(self, y, ny, gt, n_gt):
        """Resample a testee's output batch to the evaluation rate and score
        it against the ground truth -> (metrics [4, B] numpy, (ye, ne))."""
        ye, ne = self._resample_out(y, ny)
        cfg = metric_stft_config(self.evaluation_sr)
        mf = cfg.max_frames(min(ye.shape[1], gt.shape[1]))
        m = spectral_metrics(ye, ne, gt, n_gt, cfg, mf)
        return torch.stack([m[k] for k in METRIC_KEYS]).cpu().numpy(), (ye, ne)

    def _host_infer_and_score(self, results, paths, idxs, spec, d_h, n_in_h, gt, n_gt):
        """Bridge a host testee: per-utterance infer, then batched scoring."""
        outs, extras = [], []
        with self.stats.stage("host_infer"):
            for j in range(d_h.shape[0]):
                ret = self.testee.infer(d_h[j, : n_in_h[j]])
                y, add = ret if isinstance(ret, tuple) else (ret, {})
                outs.append(np.asarray(y, dtype=np.float32))
                extras.append(add)
        lout = bucket_length(max(len(y) for y in outs))
        yb = np.zeros((len(outs), lout), np.float32)
        ny = np.zeros(len(outs), np.int64)
        for j, y in enumerate(outs):
            yb[j, : len(y)] = y
            ny[j] = len(y)
        marr, audio = self._score_batch(
            torch.from_numpy(yb).to(self.device), torch.from_numpy(ny).to(self.device), gt, n_gt
        )
        self._collate(results, paths, idxs, spec, marr, audio, extras)

    def _mp3_submit(self, ex, paths, idxs, spec, x_in_h, n_in_h):
        """Queue one codec round trip per utterance on the codec pool;
        -> futures.  LAME releases the GIL (the CLI backends run in
        subprocesses), so codec work proceeds while the main thread decodes
        and dispatches later batches."""
        from ssr_eval_tpu_torch.degrade.codec import mp3_degrade

        def one(j):
            p = paths[idxs[j]]
            stem = os.path.splitext(os.path.basename(p))[0]
            cache = os.path.join(os.path.dirname(p), f"{stem}_{spec.key}.flac")
            x = x_in_h[j, : n_in_h[j]]
            return mp3_degrade(p, x, spec.sr, spec.kbps, cache_path=cache, device=self.device)

        return [ex.submit(one, j) for j in range(x_in_h.shape[0])]

    def _mp3_collect(self, results, paths, job):
        """Drain side: wait for a batch's codec futures, then score."""
        idxs, spec, futs, x_shape, n_in_h, gt, n_gt = job
        with self.stats.stage("codec_wait"):
            outs = [f.result() for f in futs]
        d_h = np.zeros(x_shape, np.float32)
        for j, d in enumerate(outs):
            d_h[j, : len(d)] = d
        if not self.device_testee:
            self._host_infer_and_score(results, paths, idxs, spec, d_h, n_in_h, gt, n_gt)
            return
        # A device testee scores the whole codec-degraded batch in one
        # infer -> resample -> metrics chain.
        d = torch.from_numpy(d_h).to(self.device)
        nd = torch.from_numpy(n_in_h).to(self.device)
        with self.stats.stage("dispatch.testee"):
            y, ny = self._infer_rows(d, nd, self._testee_state())
        marr, audio = self._score_batch(y, ny, gt, n_gt)
        self._collate(results, paths, idxs, spec, marr, audio)

    def _host64_metrics(self, ye_h, ne_h, gt_h, ng_h):
        """Float64 NumPy metrics over device-produced estimate and
        ground-truth waveforms (PARITY.md deviation 4) -> [4, B]."""
        from ssr_eval_tpu_torch.metrics.host_reference import evaluate_f64

        vals = np.zeros((len(METRIC_KEYS), ye_h.shape[0]), np.float64)
        for j in range(ye_h.shape[0]):
            m = evaluate_f64(ye_h[j, : ne_h[j]], gt_h[j, : ng_h[j]], self.evaluation_sr)
            vals[:, j] = [m[k] for k in METRIC_KEYS]
        return vals

    # ------------------------------------------------------------------
    # Host-side orchestration
    # ------------------------------------------------------------------

    @staticmethod
    def _mono_row(x):
        """Channel-mix to mono: int16 stays int16 when already mono;
        multi-channel mixes in float32."""
        if x.dtype == np.int16:
            if x.ndim == 1:
                return x
            return (x.astype(np.float32) / 32768.0).mean(axis=1).astype(np.float32)
        if x.ndim > 1:
            x = x.mean(axis=1)
        return x.astype(np.float32)

    @classmethod
    def _decode_one(cls, p):
        """-> (mono audio, native_sr); int16 for 16-bit PCM sources, float32
        otherwise."""
        r = decode_audio_i16(p)
        if r is not None:
            x, sr = r
            return cls._mono_row(x), int(sr)
        x, sr = decode_audio(p)
        return cls._mono_row(x), int(sr)

    def _pack_batch(self, sr, b, rows):
        """-> ((sr, bucket), file indices, samples [rows, bucket], lengths):
        the batch holds exactly its rows, however few."""
        n = len(rows)
        self.stats.add("samples_real", sum(len(x) for _, x in rows))
        self.stats.add("samples_slots", n * b)
        self.stats.add("rows_dispatched", n)
        idxs = [i for i, _ in rows]
        lens = np.zeros(n, np.int64)
        if all(x.dtype == np.int16 for _, x in rows):
            # int16 host->device copy (half the bytes); rescaled on device.
            xb = np.zeros((n, b), np.int16)
            for j, (_, x) in enumerate(rows):
                xb[j, : len(x)] = x
                lens[j] = len(x)
            return (sr, b), idxs, xb, lens
        xb = np.zeros((n, b), np.float32)
        for j, (_, x) in enumerate(rows):
            xf = x.astype(np.float32) / 32768.0 if x.dtype == np.int16 else x
            xb[j, : len(xf)] = xf
            lens[j] = len(xf)
        # Mixed/float sources: ship int16 only when exactly representable.
        q = np.round(xb * 32768.0)
        if np.all(np.abs(q) <= 32767) and np.array_equal(q / 32768.0, xb):
            xb = q.astype(np.int16)
        return (sr, b), idxs, xb, lens

    def _accumulate_batches(self, items):
        """(idx, mono_audio, native_sr) iterable -> packed batches.  Full
        (sr, bucket) batches flush as soon as they complete, remainders at
        the end."""
        groups = {}
        for idx, x, sr in items:
            b = bucket_length(len(x))
            rows = groups.setdefault((sr, b), [])
            rows.append((idx, x))
            if len(rows) == self.batch_size:
                groups[(sr, b)] = []
                yield self._pack_batch(sr, b, rows)
        for (sr, b), rows in groups.items():
            if rows:
                yield self._pack_batch(sr, b, rows)

    def _stream_batches(self, paths):
        """Decode and yield batches as files complete (in path order), so
        host decode overlaps device work.

        A set whose every file is FLAC or RIFF/WAVE (content sniff) takes
        the native batch decoder: one C++ call per chunk of files across the
        library's worker threads, no per-file Python.  Otherwise, or with
        SSR_EVAL_TPU_NATIVE_BATCH=0 (the JAX package's switch), a thread
        pool decodes file by file.  `stats.decoders` records which ran."""
        if _env_flag("SSR_EVAL_TPU_NATIVE_BATCH", "1"):
            native = self._native_stream_batches(paths)
            if native is not None:
                self.stats.decoders.add("native_batch")
                yield from native
                return
        self.stats.decoders.add("python_pool")

        def pool_items():
            with ThreadPoolExecutor(max_workers=self.io_workers) as ex:
                for i, (x, sr) in enumerate(ex.map(self._decode_one, paths)):
                    yield i, x, sr

        yield from self._accumulate_batches(pool_items())

    @staticmethod
    def _sniff_magic(p):
        try:
            with open(p, "rb") as f:
                return f.read(4)
        except OSError:
            return b""

    def _native_stream_batches(self, paths):
        """Batches through the native batch decoder, or None when the
        library is unavailable or a file is not a container it decodes
        (sniffed by content, not extension: a misnamed file keeps the
        per-file path, which raises naming it)."""
        if not paths:
            return None
        flac_native = native_flac()
        if flac_native is None or not flac_native.HAS_BATCH:
            return None
        magics = {b"fLaC", b"RIFF"} if flac_native.HAS_WAV_BATCH else {b"fLaC"}
        if not all(self._sniff_magic(p) in magics for p in paths):
            return None

        def native_items():
            chunk_size = max(self.batch_size * 4, 32)
            for start in range(0, len(paths), chunk_size):
                chunk = [str(p) for p in paths[start : start + chunk_size]]
                with self.stats.stage("decode.native"):
                    decoded = flac_native.decode_batch(chunk, self.io_workers)
                for idx, (x, sr) in enumerate(decoded, start=start):
                    yield idx, self._mono_row(x), int(sr)

        return self._accumulate_batches(native_items())

    def evaluate_files(self, paths):
        """-> {path: {spec_key: {metric: float, ...}}} in spec order."""
        results = {p: {} for p in paths}
        codec_ex = ThreadPoolExecutor(max_workers=self.io_workers) if self.mp3_specs else None
        try:
            with device_trace(self.profile_dir):
                self._evaluate_stream(paths, results, codec_ex)
        except BaseException:
            # Cancel queued codec jobs; in-flight ones finish and are dropped.
            if codec_ex is not None:
                codec_ex.shutdown(wait=False, cancel_futures=True)
            raise
        if codec_ex is not None:
            codec_ex.shutdown(wait=True)
        self.stats.add_utterances(len(paths))
        # Each file's keys in spec order (families finish out of order).
        order = [s.key for s in self.specs]
        for p in results:
            results[p] = {k: results[p][k] for k in order if k in results[p]}
        return results

    def _evaluate_stream(self, paths, results, codec_ex):
        pending, mp3_pending = [], []
        stream = self._stream_batches(paths)
        while True:
            with self.stats.stage("decode"):
                item = next(stream, None)
            if item is None:
                self.stats.counts["decode"] -= 1  # a count a batch; the stream's end is none
                break
            self._process_batch(item, results, paths, pending, mp3_pending, codec_ex)
        with self.stats.stage("drain"):
            while pending:
                self._drain_one(results, paths, pending.pop(0))
        for job in mp3_pending:
            self._mp3_collect(results, paths, job)
        self.stats.settle()

    def _process_batch(self, item, results, paths, pending, mp3_pending, codec_ex):
        (sr, b), idxs, xb, lens = item
        if not self.specs:
            return
        graphs = self._graphs_engage()
        with self.stats.stage("dispatch"):
            if graphs:
                with torch.cuda.device(self.device):
                    args, mstack, graphed = self._dispatch_graphed(sr, b, xb, lens)
                    pending.append((idxs, self._copy_out(mstack), None, None))
            else:
                graphed = False
                with self.stats.stage("dispatch.prep"):
                    x = torch.from_numpy(xb).to(self.device)
                    n = torch.from_numpy(lens).to(self.device)
                    args = self._prep(x, n, sr, b)
            self.stats.add("dispatch_graphed" if graphed else "dispatch_eager", 1)
            x_in, n_in, gt, n_gt = args
            if self.mp3_specs or not self.device_testee:
                # Host copies for the codec jobs and the host testee; taken
                # before the fused chain is queued, so the wait is short.
                x_in_h = x_in.cpu().numpy()
                n_in_h = n_in.cpu().numpy()
            for spec in self.mp3_specs:
                futs = self._mp3_submit(codec_ex, paths, idxs, spec, x_in_h, n_in_h)
                mp3_pending.append((idxs, spec, futs, x_in_h.shape, n_in_h, gt, n_gt))
            if self.device_testee and self.device_specs:
                self._record_cost(("fused", tuple(self.groups), sr, len(idxs), b), self._fused_batch, args)
                if not graphs:
                    mstack, audio = self._fused_batch(*args)
                    gt_pair = (gt, n_gt) if self.metrics_backend == "host_float64" else None
                    pending.append((idxs, (mstack, None), audio, gt_pair))
        if not self.device_testee:
            for spec, d in self._degraded(x_in, n_in):
                self._host_infer_and_score(results, paths, idxs, spec, d.cpu().numpy(), n_in_h, gt, n_gt)
        with self.stats.stage("drain"):
            while len(pending) > MAX_PENDING:
                self._drain_one(results, paths, pending.pop(0))
        while len(mp3_pending) > MAX_PENDING:
            self._mp3_collect(results, paths, mp3_pending.pop(0))

    def _drain_one(self, results, paths, item):
        """Bring one batch's metrics to the host and collate them: a graphed
        engine's batch waits on its own copy's event, any other brings its
        metrics over."""
        idxs, (mstack, done), audio, gt_pair = item
        if done is not None:
            done.synchronize()
            marr = mstack.numpy()  # [S, 4, B], its pinned slot
        else:
            marr = mstack.cpu().numpy()
        if gt_pair is not None:
            gt_h, ng_h = gt_pair[0].cpu().numpy(), gt_pair[1].cpu().numpy()
        for si, spec in enumerate(self.device_specs):
            m = marr[si]
            if gt_pair is not None:
                ye_h, ne_h = audio[si][0].cpu().numpy(), audio[si][1].cpu().numpy()
                m = self._host64_metrics(ye_h, ne_h, gt_h, ng_h)
            self._collate(results, paths, idxs, spec, m, audio[si] if audio is not None else None)

    def _collate(self, results, paths, idxs, spec, marr, audio, extras=None):
        """marr: [4, B] metrics in METRIC_KEYS order; audio: (ye, ne) at the
        evaluation rate, written when save_processed_result is set."""
        save = self.save_processed_result and audio is not None
        if save:
            ye_h = audio[0].cpu().numpy()
            ne_h = audio[1].cpu().numpy()
        for j, idx in enumerate(idxs):
            p = paths[idx]
            entry = {k: float(marr[ki, j]) for ki, k in enumerate(METRIC_KEYS)}
            if extras:
                entry.update(extras[j])
            results[p][spec.key] = entry
            if self.journal is not None:
                self.journal.record(p, spec.key, entry)
            if save:
                # Naming parity: file + key + "_processed_" + test_name + ".wav"
                # (reference eval.py:137).
                fname = p + spec.key + "_processed_" + self.test_name + ".wav"
                write_wav(fname, ye_h[j, : ne_h[j]], self.evaluation_sr)
