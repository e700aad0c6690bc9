"""Where the port writes what it builds at run time.

`build_dir()` is the one place that decides: the package's own ``_build/``
when the package directory is writable (a checkout, or an install the user
may write to), else the user cache
``${XDG_CACHE_HOME:-~/.cache}/ssr_eval_tpu_torch/<version>/`` (an install in
a read-only site-packages).  It creates nothing; the builder (`_native_build.py`)
makes the directory when it first writes there.
"""

from __future__ import annotations

import os
import stat
import tempfile
from pathlib import Path

PKG = Path(__file__).resolve().parent


def _writable(d: Path) -> bool:
    """True when this process may create files in `d`: its mode grants this
    user the write bit (honoured even by root, who could override it) and a
    file can be made there (a read-only mount refuses one)."""
    st = d.stat()
    if st.st_uid == os.geteuid():
        bit = stat.S_IWUSR
    elif st.st_gid == os.getegid() or st.st_gid in os.getgroups():
        bit = stat.S_IWGRP
    else:
        bit = stat.S_IWOTH
    if not st.st_mode & bit:
        return False
    try:
        with tempfile.TemporaryFile(dir=d):
            return True
    except OSError:
        return False


def build_dir() -> Path:
    """PKG/_build when the package directory is writable, else the user
    cache directory for this version of the port."""
    if _writable(PKG):
        return PKG / "_build"
    from ssr_eval_tpu_torch import __version__

    cache = os.environ.get("XDG_CACHE_HOME", "")
    if not os.path.isabs(cache):  # unset, empty or relative: the XDG default
        cache = os.path.join(os.path.expanduser("~"), ".cache")
    return Path(cache) / "ssr_eval_tpu_torch" / __version__
