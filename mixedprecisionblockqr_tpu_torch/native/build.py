"""Build the native Euroc parser:
``python -m mixedprecisionblockqr_tpu_torch.native.build [--force]``."""

from __future__ import annotations

import os
import subprocess
import sys
from typing import Optional

HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(HERE), "_build", "native")
SRC = os.path.join(HERE, "euroc_parser.cpp")
SO = os.path.join(BUILD_DIR, "libeuroc_parser.so")


def build(force: bool = False) -> Optional[str]:
    """Compile the parser library with ``$CXX`` (default ``g++``) unless an
    up-to-date one exists; returns its path, or None when it does not
    build.  The library is written under a temporary name and renamed, so
    concurrent builders never load a half-written file."""
    if (not force and os.path.exists(SO)
            and os.path.getmtime(SO) >= os.path.getmtime(SRC)):
        return SO
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{SO}.{os.getpid()}.tmp"
    cmd = [os.environ.get("CXX", "g++"), "-O2", "-fPIC", "-shared",
           "-std=c++17", "-Wall", "-o", tmp, SRC]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
    except (subprocess.CalledProcessError, FileNotFoundError) as e:
        print(f"native build failed: {e}", file=sys.stderr)
        return None
    os.replace(tmp, SO)
    return SO


if __name__ == "__main__":
    path = build(force="--force" in sys.argv)
    print(path or "FAILED")
    sys.exit(0 if path else 1)
