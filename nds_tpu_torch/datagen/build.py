"""Self-building native generator: the port of nds_tpu/datagen/build.py.

The generator's C++ sources under native/ are the port's own copies of
the reference's (tests/test_torch_datagen.py holds them byte-identical).
`ensure_built` compiles them with g++ on first use into the git-ignored
_build/ directory beside this file; no binary is committed.
"""

from __future__ import annotations

import os
import subprocess

NATIVE_DIR = os.path.join(os.path.dirname(__file__), "native")
BUILD_DIR = os.path.join(os.path.dirname(__file__), "_build")
BINARY = os.path.join(BUILD_DIR, "ndsgen")
_SOURCES = ["ndsgen.cpp"]
_HEADERS = ["ndsgen.hpp", "vocab.hpp", "rowcounts.hpp", "dims.hpp", "facts.hpp", "refresh.hpp"]


def _stale() -> bool:
    if not os.path.exists(BINARY):
        return True
    bin_mtime = os.path.getmtime(BINARY)
    for f in _SOURCES + _HEADERS:
        if os.path.getmtime(os.path.join(NATIVE_DIR, f)) > bin_mtime:
            return True
    return False


def ensure_built() -> str:
    """Compile ndsgen if missing or out of date; returns the binary path.

    Compiles to a process-unique temp path and os.replace()s it in, so
    concurrent builders can't truncate a binary another process is executing.
    """
    if _stale():
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{BINARY}.build.{os.getpid()}"
        cmd = ["g++", "-O2", "-std=c++17", "-o", tmp] + [
            os.path.join(NATIVE_DIR, s) for s in _SOURCES
        ]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"ndsgen build failed:\n{proc.stderr}")
        os.replace(tmp, BINARY)
    return BINARY
