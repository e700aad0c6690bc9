"""Batched evaluation engine on one device, run eagerly.

Dataflow per (native_sr, length-bucket) batch of utterances:

    host decode (thread pool)                        [B files]
      └─ device (torch, queued asynchronously on the card):
           resample native->input_sr and native->evaluation_sr
           target |STFT| + its SSIM box moments      (once per utterance)
           for each family (specs grouped by `family_key`):
             spec-independent degradation work       (once per utterance,
                                                      e.g. the fft STFT)
             for each spec: degrade -> testee.infer_batch
                            -> resample output->evaluation_sr -> metrics
      └─ host: collate per-file metric dicts (reference-compatible keys)

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
`spec_flat`, `spec_single`) have no counterpart: the port runs eagerly.
As the JAX engine does, it records each distinct batch program's key,
argument shapes and call count (`_cost_args`, `_cost_calls`), which
`utils.flops.engine_program_costs` reads.

Batches are padded to a fixed size with copies of their first row; padding
rows are dropped at collation.  Every per-utterance computation is
independent of the other rows of its batch, so a file scores the same alone
or inside any batch.
"""

from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ssr_eval_tpu_torch.degrade.apply import (
    build_family_apply,
    build_family_pre,
    family_key,
    spec_params,
)
from ssr_eval_tpu_torch.dsp.resample import (
    apply_resample,
    resample_poly_plan,
    windowed_sinc_plan,
)
from ssr_eval_tpu_torch.dsp.spectral import n_frames_for_length, stft_magnitude
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


def _env_flag(name: str, default: str) -> bool:
    """"0", "false" and "" mean off (the JAX package's env-flag rule)."""
    return os.environ.get(name, default) not in ("0", "false", "")


class EvalEngine:
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
        self.device_testee = hasattr(testee, "infer_batch")
        self._weights = {}  # plan key -> device copy of its Wd
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
        """-> x_in, n_in (input rate), gt, n_gt (evaluation rate)."""
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
            ctx = build_family_pre(fkey, lin)(x_in, n_in)
            deg_apply = build_family_apply(fkey, lin)
            for spec in gspecs:
                yield spec, deg_apply(ctx, x_in, n_in, spec_params(spec, lin, self.device))

    def _fused_batch(self, x_in, n_in, gt, n_gt):
        """The sweep chain for a device testee over every device spec.  The
        target |STFT| and its SSIM moments run once per utterance;
        degrade -> infer -> score runs per spec.  Device testees preserve
        lengths (the reference itself asserts |delta len| < 100), so the
        truncate-to-min length is shared across specs.
        -> (metrics [S, 4, B] in `device_specs` order, [(ye, ne)] per spec
        or None)."""
        ratio_plan = resample_poly_plan(self.output_sr, self.evaluation_sr, 1024)
        cfg = metric_stft_config(self.evaluation_sr)
        mf = cfg.max_frames(gt.shape[1])
        min_len = torch.minimum(ratio_plan.out_length(n_in), n_gt)
        tgt_sp = stft_magnitude(gt, min_len, cfg, mf)
        nf = n_frames_for_length(cfg, min_len)
        m2 = (torch.arange(mf, device=gt.device)[None, :] < nf[:, None]).to(tgt_sp.dtype)
        moments = ssim_target_moments(tgt_sp * m2[:, :, None])

        want_audio = self.save_processed_result or self.metrics_backend == "host_float64"
        state = self._testee_state()
        rows, audio = [], []
        for _, d in self._degraded(x_in, n_in):
            y, ny = self.testee.infer_batch(d, n_in, state)
            ye, ne = self._resample_out(y, ny)
            m = spectral_metrics_with_target(ye, min_len, tgt_sp, cfg, mf, moments)
            rows.append(torch.stack([m[k] for k in METRIC_KEYS]))
            if want_audio:
                audio.append((ye, ne))
        return torch.stack(rows), (audio if want_audio else None)

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

    def _host_infer_and_score(self, results, paths, idxs, spec, d_h, n_in_h, gt, n_gt, n_real):
        """Bridge a host testee: per-utterance infer, then batched scoring."""
        outs, extras = [], []
        with self.stats.stage("host_infer"):
            for j in range(n_real):
                ret = self.testee.infer(d_h[j, : n_in_h[j]])
                y, add = ret if isinstance(ret, tuple) else (ret, {})
                outs.append(np.asarray(y, dtype=np.float32))
                extras.append(add)
        lout = bucket_length(max(len(y) for y in outs))
        yb = np.zeros((d_h.shape[0], lout), np.float32)
        ny = np.zeros(d_h.shape[0], np.int64)
        for j, y in enumerate(outs):
            yb[j, : len(y)] = y
            ny[j] = len(y)
        yb[n_real:] = yb[0]
        ny[n_real:] = ny[0]
        marr, audio = self._score_batch(
            torch.from_numpy(yb).to(self.device), torch.from_numpy(ny).to(self.device), gt, n_gt
        )
        self._collate(results, paths, idxs, spec, marr, audio, n_real, extras)

    def _mp3_submit(self, ex, paths, idxs, spec, x_in_h, n_in_h, n_real):
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

        return [ex.submit(one, j) for j in range(n_real)]

    def _mp3_collect(self, results, paths, job):
        """Drain side: wait for a batch's codec futures, then score."""
        idxs, spec, futs, x_shape, n_in_h, gt, n_gt, n_real = job
        with self.stats.stage("codec_wait"):
            outs = [f.result() for f in futs]
        d_h = np.zeros(x_shape, np.float32)
        for j, d in enumerate(outs):
            d_h[j, : len(d)] = d
        d_h[n_real:] = d_h[0]
        if not self.device_testee:
            self._host_infer_and_score(results, paths, idxs, spec, d_h, n_in_h, gt, n_gt, n_real)
            return
        # A device testee scores the whole codec-degraded batch in one
        # infer -> resample -> metrics chain.
        d = torch.from_numpy(d_h).to(self.device)
        nd = torch.from_numpy(n_in_h).to(self.device)
        y, ny = self.testee.infer_batch(d, nd, self._testee_state())
        marr, audio = self._score_batch(y, ny, gt, n_gt)
        self._collate(results, paths, idxs, spec, marr, audio, n_real)

    def _host64_metrics(self, ye_h, ne_h, gt_h, ng_h, n_real):
        """Float64 NumPy metrics over device-produced estimate and
        ground-truth waveforms (PARITY.md deviation 4) -> [4, B]."""
        from ssr_eval_tpu_torch.metrics.host_reference import evaluate_f64

        vals = np.zeros((len(METRIC_KEYS), ye_h.shape[0]), np.float64)
        for j in range(n_real):
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
        chunk = list(rows)
        n_real = len(chunk)
        while len(chunk) < self.batch_size:
            chunk.append(chunk[0])  # pad rows, dropped at collation
        lens = np.zeros(self.batch_size, np.int64)
        if all(c[1].dtype == np.int16 for c in chunk):
            # int16 host->device copy (half the bytes); rescaled on device.
            xb = np.zeros((self.batch_size, b), np.int16)
            for j, (_, x) in enumerate(chunk):
                xb[j, : len(x)] = x
                lens[j] = len(x)
            return (sr, b), [c[0] for c in chunk[:n_real]], xb, lens
        xb = np.zeros((self.batch_size, b), np.float32)
        for j, (_, x) in enumerate(chunk):
            xf = x.astype(np.float32) / 32768.0 if x.dtype == np.int16 else x
            xb[j, : len(xf)] = xf
            lens[j] = len(xf)
        # Mixed/float sources: ship int16 only when exactly representable.
        q = np.round(xb * 32768.0)
        if np.all(np.abs(q) <= 32767) and np.array_equal(q / 32768.0, xb):
            xb = q.astype(np.int16)
        return (sr, b), [c[0] for c in chunk[:n_real]], xb, lens

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
            t = time.perf_counter()
            item = next(stream, None)
            self.stats.seconds["decode"] += time.perf_counter() - t
            if item is None:
                break
            self.stats.counts["decode"] += 1
            self._process_batch(item, results, paths, pending, mp3_pending, codec_ex)
        with self.stats.stage("drain"):
            while pending:
                self._drain_one(results, paths, pending.pop(0))
        for job in mp3_pending:
            self._mp3_collect(results, paths, job)

    def _process_batch(self, item, results, paths, pending, mp3_pending, codec_ex):
        (sr, b), idxs, xb, lens = item
        n_real = len(idxs)
        if not self.specs:
            return
        with self.stats.stage("dispatch"):
            x = torch.from_numpy(xb).to(self.device)
            if x.dtype == torch.int16:
                x = x.to(torch.float32) / 32768.0
            n = torch.from_numpy(lens).to(self.device)
            x_in, n_in, gt, n_gt = self._prep(x, n, sr, b)
            if self.mp3_specs or not self.device_testee:
                # Host copies for the codec jobs and the host testee; taken
                # before the fused chain is queued, so the wait is short.
                x_in_h = x_in.cpu().numpy()
                n_in_h = n_in.cpu().numpy()
            for spec in self.mp3_specs:
                futs = self._mp3_submit(codec_ex, paths, idxs, spec, x_in_h, n_in_h, n_real)
                mp3_pending.append((idxs, spec, futs, x_in_h.shape, n_in_h, gt, n_gt, n_real))
            if self.device_testee and self.device_specs:
                self._record_cost(("fused", tuple(self.groups), sr, b), self._fused_batch, (x_in, n_in, gt, n_gt))
                mstack, audio = self._fused_batch(x_in, n_in, gt, n_gt)
                gt_pair = (gt, n_gt) if self.metrics_backend == "host_float64" else None
                pending.append((idxs, mstack, audio, n_real, gt_pair))
        if not self.device_testee:
            for spec, d in self._degraded(x_in, n_in):
                self._host_infer_and_score(results, paths, idxs, spec, d.cpu().numpy(), n_in_h, gt, n_gt, n_real)
        with self.stats.stage("drain"):
            while len(pending) > MAX_PENDING:
                self._drain_one(results, paths, pending.pop(0))
        while len(mp3_pending) > MAX_PENDING:
            self._mp3_collect(results, paths, mp3_pending.pop(0))

    def _drain_one(self, results, paths, item):
        """Bring one batch's metrics to the host and collate them."""
        idxs, mstack, audio, n_real, gt_pair = item
        marr = mstack.cpu().numpy()  # [S, 4, B]
        if gt_pair is not None:
            gt_h, ng_h = gt_pair[0].cpu().numpy(), gt_pair[1].cpu().numpy()
        for si, spec in enumerate(self.device_specs):
            m = marr[si]
            if gt_pair is not None:
                ye_h, ne_h = audio[si][0].cpu().numpy(), audio[si][1].cpu().numpy()
                m = self._host64_metrics(ye_h, ne_h, gt_h, ng_h, n_real)
            self._collate(results, paths, idxs, spec, m, audio[si] if audio is not None else None, n_real)

    def _collate(self, results, paths, idxs, spec, marr, audio, n_real, extras=None):
        """marr: [4, B] metrics in METRIC_KEYS order; audio: (ye, ne) at the
        evaluation rate, written when save_processed_result is set."""
        save = self.save_processed_result and audio is not None
        if save:
            ye_h = audio[0].cpu().numpy()
            ne_h = audio[1].cpu().numpy()
        for j in range(n_real):
            p = paths[idxs[j]]
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
