"""`SSR_Eval_Helper` — the reference-compatible orchestrator (reference
eval.py:63-421) on the batched torch engine.

Constructor signature, evaluate()/evaluate_single()/preprocess(), the
aggregation structure ("each_speaker"/"averaged" blocks) and the
results-JSON naming follow the reference; the execution underneath is
`ssr_eval_tpu_torch.harness.engine.EvalEngine`, one device per process.

Extras (keyword-only, defaulted so reference call sites work unchanged):
the JAX package's helper keywords, `mesh` (None, or a `DataMesh` from
`ssr_eval_tpu_torch.parallel.data_mesh()`: see `evaluate`), `batch_size`, `auto_download`,
`input_res_type`, `metrics_backend` ("device", or "host_float64" for the
float64 host recomputation) and `evaluate(multihost=...)`, plus `device`
(None = the CUDA card; "cpu" runs the plain PyTorch path).  Every
degradation family runs: fft, the four IIR designs, subsampling and mp3
(the last needs libmp3lame, sox or ffmpeg, and raises
`CodecUnavailableError` without one).
"""

from __future__ import annotations

import os
from datetime import datetime

import numpy as np
import torch

from ssr_eval_tpu_torch.degrade.plan import expand_settings
from ssr_eval_tpu_torch.harness.engine import EvalEngine
from ssr_eval_tpu_torch.harness.resume import ResultJournal, load_partial, process_journal_path
from ssr_eval_tpu_torch.metrics.audio_metrics import AudioMetrics
from ssr_eval_tpu_torch.parallel.mesh import group_rank_and_size
from ssr_eval_tpu_torch.parallel.multihost import gather_results_to_coordinator, shard_paths
from ssr_eval_tpu_torch.utils.common import dict_mean, write_json

VCTK_URL = "https://zenodo.org/record/6370601/files/vctk_test_48k.tar?download=1"


class SSR_Eval_Helper:
    def __init__(
        self,
        testee,
        input_sr,
        output_sr,
        evaluation_sr=44100,
        test_name="test",
        test_data_root="./datasets/vctk_test",
        setting_lowpass_filtering=None,
        setting_subsampling=None,
        setting_fft=None,
        setting_mp3_compression=None,
        save_processed_result=False,
        *,
        mesh=None,
        device=None,
        batch_size=4,
        auto_download=True,
        input_res_type="polyphase",
        metrics_backend="device",
    ):
        assert (
            evaluation_sr <= 48000
        ), "Our evaluation set only support up to 48 kHz target sampling rate"
        self.testee = testee
        self.test_name = test_name
        self.test_data_root = test_data_root
        self.save_processed_result = save_processed_result

        self.setting_lowpass_filtering = self._cutoff2sr(setting_lowpass_filtering)
        self.setting_fft = self._cutoff2sr(setting_fft)
        self.setting_subsampling = self._cutoff2sr(setting_subsampling)
        self.setting_mp3_compression = setting_mp3_compression

        self.model_input_sr = input_sr
        self.model_output_sr = output_sr
        self.evaluationset_sr = evaluation_sr

        self.specs = expand_settings(
            setting_lowpass_filtering=self.setting_lowpass_filtering,
            setting_subsampling=self.setting_subsampling,
            setting_fft=self.setting_fft,
            setting_mp3_compression=self.setting_mp3_compression,
            sr=self.model_input_sr,
        )
        # The engine resolves the device and rejects unknown families
        # before anything touches the dataset directory.
        self.engine = EvalEngine(
            self.specs,
            input_sr=self.model_input_sr,
            output_sr=self.model_output_sr,
            evaluation_sr=self.evaluationset_sr,
            testee=testee,
            batch_size=batch_size,
            mesh=mesh,
            device=device,
            save_processed_result=save_processed_result,
            test_name=test_name,
            input_res_type=input_res_type,
            metrics_backend=metrics_backend,
        )
        self.device = self.engine.device
        self.audio_metrics = AudioMetrics(self.evaluationset_sr, device=self.device)
        self.unexpected_symbol_test_folder = "_.*#()_+=!@$%^&~"
        os.makedirs(test_data_root, exist_ok=True)
        if "s5" not in os.listdir(test_data_root) and auto_download:
            raise RuntimeError(
                f"The VCTK test set is not under {test_data_root}. This package "
                f"does not download it: fetch {VCTK_URL}, extract the speakers "
                f"(p360..s5) under {test_data_root}, or use "
                "ssr_eval_tpu_torch.harness.fixtures.ensure_synthetic_vctk() for "
                "an offline synthetic set."
            )

    def _cutoff2sr(self, dic):
        """Double every cutoff (cutoff -> nominal low sampling rate,
        reference eval.py:121-126).  Non-mutating, unlike the reference."""
        if dic is None:
            return None
        out = dict(dic)
        out["cutoff_freq"] = [x * 2 for x in dic["cutoff_freq"]]
        return out

    # ------------------------------------------------------------------
    # Reference API
    # ------------------------------------------------------------------

    def evaluate_single(self, file):
        """Per-file evaluation (reference eval.py:128-156)."""
        return self.engine.evaluate_files([file])[file]

    def get_test_file_list(self, path):
        """Files eligible for scoring in a speaker directory: .wav/.flac
        only, minus macOS metadata and minus anything a previous sweep
        wrote (every produced artifact carries "proc" in its name —
        reference eval.py:158-169)."""

        def eligible(name):
            return (
                (name.endswith(".wav") or name.endswith(".flac"))
                and "DS_Store" not in name
                and "proc" not in name
            )

        return [f for f in os.listdir(path) if eligible(f)]

    def evaluate(self, limit_test_nums=-1, limit_test_speaker=-1, resume=False, verbose=True, multihost="auto"):
        """Run the sweep.  Reference-compatible signature plus:

        resume: skip files whose every spec key already exists in the
            incremental journal `results/<test_name>.partial.jsonl`
            (written as batches complete).
        verbose: per-speaker progress + a throughput summary.
        multihost: the JAX package's keyword.  "auto" means a
            torch.distributed process group of more than one rank; True
            forces the multi-process path, False disables it.

        One process drives one card, so the port's `mesh` (a `DataMesh`:
        a "data" axis over the process group's ranks) and `multihost=True`
        run the same path: the file list is sharded round-robin over the
        ranks (`parallel.multihost.shard_paths`), each rank scores its
        shard into its own journal (`results/<test_name>.partial.p<rank>.jsonl`
        in a group of several; the base path in a group of one), the
        per-file metrics are gathered to every rank, every rank returns the
        merged result in speaker and file order, and rank 0 alone writes
        the results JSON.  With `resume` every rank's journal is gathered
        before the files left to score are chosen, so the ranks agree on
        them.  multihost=False in a group keeps the JAX meaning: every rank
        runs the whole sweep and writes its JSON.  (The JAX package also
        shards one batch over several devices of a process; a
        one-card-per-process layout has no counterpart of that.)

        The call is the span "job" of `engine.stats`, and the engine's pass
        over the files inside it "job.evaluate_files".
        """
        with self.engine.stats.stage("job"):
            return self._evaluate(limit_test_nums, limit_test_speaker, resume, verbose, multihost)

    def _evaluate(self, limit_test_nums, limit_test_speaker, resume, verbose, multihost):
        if multihost not in ("auto", True, False):
            raise ValueError(f"multihost must be 'auto', True or False, got {multihost!r}")
        rank, world = group_rank_and_size()
        use_multihost = multihost if multihost != "auto" else world > 1
        final_result = {}
        result_cache = {}
        averaged_result = {}
        os.makedirs("results", exist_ok=True)
        journal_path = os.path.join("results", f"{self.test_name}.partial.jsonl")

        speaker_files = {}
        for speaker in sorted(os.listdir(self.test_data_root)):
            if not os.path.isdir(os.path.join(self.test_data_root, speaker)):
                continue
            if "p" not in speaker and "s" not in speaker:
                continue
            if limit_test_speaker > 0 and len(speaker_files) >= limit_test_speaker:
                break
            files = sorted(
                self.get_test_file_list(os.path.join(self.test_data_root, speaker))
            )
            assert len(files) != 0, os.path.join(self.test_data_root, speaker)
            if limit_test_nums > 0:
                files = files[:limit_test_nums]
            speaker_files[speaker] = [
                os.path.join(self.test_data_root, speaker, f) for f in files
            ]

        # One engine pass over every selected file.
        all_paths = [p for fs in speaker_files.values() for p in fs]
        expected_keys = {s.key for s in self.specs}
        partial = load_partial(journal_path) if resume else {}
        if resume and use_multihost:
            # journals may sit on per-host filesystems: every rank must
            # choose the same files left to score, or some go unscored
            partial = gather_results_to_coordinator(partial)
        done = {
            p
            for p in all_paths
            if expected_keys and expected_keys.issubset(partial.get(p, {}).keys())
        }
        todo = [p for p in all_paths if p not in done]
        if verbose:
            for speaker in speaker_files:
                print("Speaker:", speaker)
            if done:
                print(f"[resume] {len(done)}/{len(all_paths)} files already scored")

        my_todo = shard_paths(todo) if use_multihost else todo
        # one journal per rank: concurrent appends to one file interleave
        self.engine.journal = ResultJournal(
            process_journal_path(journal_path, rank, world) if use_multihost else journal_path
        )
        try:
            with self.engine.stats.stage("job.evaluate_files"):
                per_file = self.engine.evaluate_files(my_todo) if my_todo else {}
        finally:
            self.engine.journal.close()
            self.engine.journal = None
        if use_multihost:
            per_file = gather_results_to_coordinator(per_file)
        for p in done:
            per_file[p] = {k: partial[p][k] for k in [s.key for s in self.specs]}

        for speaker, paths in speaker_files.items():
            final_result[speaker] = {os.path.basename(p): per_file[p] for p in paths}
        if verbose:
            print("[stats]", self.engine.stats.summary())

        # Per-speaker means, then a macro average across speakers (the
        # reference's dict_mean reduction, eval.py:200-216).  Quirk kept:
        # the distortion-key list is re-read from each speaker's FIRST
        # file, and the macro average runs over the LAST speaker's list.
        distortion_type = []
        for speaker, files in final_result.items():
            first = next(iter(files.values()), {})
            distortion_type = list(first.keys())
            result_cache[speaker] = {
                d: dict_mean([m[d] for m in files.values()]) for d in distortion_type
            }
        for d in distortion_type:
            averaged_result[d] = dict_mean(
                [result_cache[speaker][d] for speaker in final_result]
            )
        final_result["each_speaker"] = result_cache
        final_result["averaged"] = averaged_result
        now = datetime.now()
        # Artifact naming parity: "<date>-<time>-<test_name>.json"
        # (reference eval.py:219-226).
        save_path = f"{now.date()}-{now.time()}-{self.test_name}.json"
        if not use_multihost or rank == 0:
            write_json(final_result, os.path.join("results", save_path))
        return final_result

    def preprocess(self, file, sr):
        """Degrade one file at `sr`; -> {key: np.ndarray} (eval.py:229-270)."""
        from ssr_eval_tpu_torch.degrade.apply import (
            build_family_degrader,
            family_key,
            spec_params,
        )
        from ssr_eval_tpu_torch.degrade.codec import mp3_degrade
        from ssr_eval_tpu_torch.io.audio import load
        from ssr_eval_tpu_torch.utils.bucket import bucket_length

        specs = self.specs
        if sr != self.model_input_sr:
            # Key names embed the sr argument (reference eval.py:305,340,...).
            specs = expand_settings(
                setting_lowpass_filtering=self.setting_lowpass_filtering,
                setting_subsampling=self.setting_subsampling,
                setting_fft=self.setting_fft,
                setting_mp3_compression=self.setting_mp3_compression,
                sr=sr,
            )
        x, _ = load(file, sr=sr)
        L = len(x)
        lmax = bucket_length(L)
        buf = np.zeros((1, lmax), np.float32)
        buf[0, :L] = x
        xb = torch.from_numpy(buf).to(self.device)
        n = torch.tensor([L], device=self.device)
        out = {}
        for spec in specs:
            if spec.family == "mp3":
                cache = self.cache_file_name(spec.key, file)
                out[spec.key] = mp3_degrade(file, x, sr, spec.kbps, cache_path=cache, device=self.device)
            else:
                fn = build_family_degrader(family_key(spec), lmax)
                out[spec.key] = fn(xb, n, spec_params(spec, lmax, self.device))[0, :L].cpu().numpy()
        return out

    # ------------------------------------------------------------------
    # Per-family degradation sweeps — public API parity (reference
    # eval.py:302-421).  `preprocess` and the engine run the batched path;
    # these single-utterance methods stay callable directly, with the
    # reference's key naming, cutoff == sr decrement and shape asserts.
    # ------------------------------------------------------------------

    def _iir_sweep(self, tag, ftype, x, sr):
        from ssr_eval_tpu_torch.degrade.lowpass import lowpass

        ret_dict = {}
        for low_rate in self.setting_lowpass_filtering["cutoff_freq"]:
            for order in self.setting_lowpass_filtering["filter_order"]:
                if low_rate == sr:
                    low_rate -= 1
                key = f"proc_{tag}_{low_rate}_{order}_{sr}"
                ret_dict[key] = lowpass(x, low_rate // 2, sr, order=order, _type=ftype, device=self.device)
        for k in ret_dict:
            assert ret_dict[k].shape == x.shape, str((ret_dict[k].shape, x.shape))
        return ret_dict

    def lowpass_butterworth(self, file, x, sr):
        return self._iir_sweep("bw", "butter", x, sr)

    def lowpass_chebyshev(self, file, x, sr):
        return self._iir_sweep("ch", "cheby1", x, sr)

    def lowpass_ellip(self, file, x, sr):
        return self._iir_sweep("el", "ellip", x, sr)

    def lowpass_bessel(self, file, x, sr):
        return self._iir_sweep("bessel", "bessel", x, sr)

    def _single_sweep(self, setting, tag, _type, x, sr):
        from ssr_eval_tpu_torch.degrade.lowpass import lowpass

        ret_dict = {}
        for low_rate in setting["cutoff_freq"]:
            if low_rate == sr:
                low_rate -= 1
            key = f"proc_{tag}_{low_rate}_{sr}"
            ret_dict[key] = lowpass(x, low_rate // 2, sr, order=1, _type=_type, device=self.device)
        return ret_dict

    def lowpass_stft_hard(self, file, x, sr):
        return self._single_sweep(self.setting_fft, "fft", "stft_hard", x, sr)

    def lowpass_subsampling(self, file, x, sr):
        return self._single_sweep(self.setting_subsampling, "subsampling", "subsampling", x, sr)

    def mp3_encoding(self, file, x, sr):
        """Codec round-trip sweep (reference eval.py:302-325): encode at
        each kbps, realign by cross-correlation, cache the aligned flac
        next to the source (the reference writes it at :321)."""
        from ssr_eval_tpu_torch.degrade.codec import mp3_degrade

        ret_dict = {}
        for low_kbps in self.setting_mp3_compression["low_kbps"]:
            key = f"proc_mp3_{low_kbps}_{sr}"
            target_file = self.cache_file_name(key, file)
            ret_dict[key] = mp3_degrade(file, x, sr, low_kbps, cache_path=target_file, device=self.device)
        return ret_dict

    # Length helpers kept for API parity (reference eval.py:272-300).
    def shift(self, x, shift):
        ret = np.zeros_like(x)
        if shift >= 0:
            ret[:-shift] = x[shift:]
        elif shift < 0:
            ret[-shift:] = x[:-(-shift)]
        return ret

    def unify_length(self, x, target):
        from ssr_eval_tpu_torch.degrade.codec import unify_length

        return unify_length(x, target)

    def pad(self, x, y):
        """Zero-pad the shorter of two 1-D arrays to the longer's length
        (reference eval.py:280-290; dead code there, kept for parity)."""
        if x.shape[0] == y.shape[0]:
            return x, y
        if x.shape[0] > y.shape[0]:
            cache_y = np.zeros_like(x)
            cache_y[: y.shape[0]] = y
            return x, cache_y
        cache_x = np.zeros_like(y)
        cache_x[: x.shape[0]] = x
        return cache_x, y

    def cache_file_name(self, key, file, suffix=".flac"):
        return os.path.join(
            os.path.dirname(file),
            os.path.splitext(os.path.basename(file))[0] + "_" + key + suffix,
        )
