"""Building a host C++ source of the port into a shared library with g++.

Used by the map-graph engine (``slammap/native.py``) and the PNG reader
(``io/png.py``). A library is built at first use into the port's git-ignored
``_build/`` directory, into a temporary file renamed into place, so that
concurrent first uses (pytest workers, threads) never load a half-written
file. A failed build raises with the compiler's output: nothing falls back
to a plain version.
"""
from __future__ import annotations

import os
import subprocess
import threading

CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-shared")


def build_shared_library(source: str, lib_path: str, force: bool = False) -> str:
    """Compile ``source`` into ``lib_path``; -> ``lib_path``. Rebuilds when the
    source is newer than the library, or with ``force``."""
    if not os.path.exists(source):
        raise RuntimeError(f"C++ source not found: {source}")
    if not force and os.path.exists(lib_path) and \
            os.path.getmtime(lib_path) >= os.path.getmtime(source):
        return lib_path
    os.makedirs(os.path.dirname(lib_path), exist_ok=True)
    tmp_path = f"{lib_path}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = ["g++", *CXX_FLAGS, "-o", tmp_path, source]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"cannot run the C++ compiler {cmd[0]!r}: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"building {source} failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp_path, lib_path)   # atomic: a reader sees the old or the new file
    return lib_path
