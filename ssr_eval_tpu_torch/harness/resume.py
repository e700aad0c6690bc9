"""Incremental results + sweep resume.

The engine appends one JSONL record per (file, spec) as soon as a batch's
metrics land on the host:

    {"path": ..., "key": "proc_fft_24000_44100", "metrics": {...}}

`load_partial` reads such a journal back; `SSR_Eval_Helper.evaluate(...)`
with `resume=True` skips files whose every spec key is already recorded
and merges the journal into the final results dict, so a crashed sweep
continues where it stopped (the reference writes its JSON once, at the
very end, eval.py:219-226).
"""

from __future__ import annotations

import json
import os


class ResultJournal:
    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._fh = open(path, "a")

    def record(self, file_path: str, key: str, metrics: dict):
        self._fh.write(json.dumps({"path": file_path, "key": key, "metrics": metrics}) + "\n")
        self._fh.flush()

    def close(self):
        self._fh.close()


def process_journal_path(base_path: str, process_index: int, process_count: int) -> str:
    """Per-process journal path for multi-process runs (a single process
    keeps the base path so existing journals stay resumable)."""
    if process_count <= 1:
        return base_path
    root, ext = os.path.splitext(base_path)
    return f"{root}.p{process_index}{ext}"


def _journal_files(path: str):
    """The base journal and every per-process sibling (`<root>.p<i><ext>`)."""
    import glob

    root, ext = os.path.splitext(path)
    # strip a .p<i> suffix so every process resolves the same family
    base, tail = os.path.splitext(root)
    if tail.startswith(".p") and tail[2:].isdigit():
        root = base
    candidates = [root + ext] + sorted(glob.glob(f"{glob.escape(root)}.p*{ext}"))
    return [p for p in candidates if os.path.exists(p)]


def load_partial(path: str) -> dict:
    """-> {file_path: {key: metrics}} merged from the journal at `path` and
    the per-process journals beside it (a torn final line from a crash is
    skipped)."""
    out = {}
    for fp in _journal_files(path):
        with open(fp) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue
                out.setdefault(rec["path"], {})[rec["key"]] = rec["metrics"]
    return out
