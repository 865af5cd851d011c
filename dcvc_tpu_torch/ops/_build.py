"""Builds the package's native sources into shared libraries at first use.

Outputs go to ``dcvc_tpu_torch/_build/`` (listed in ``.gitignore``), named by
a hash of the source and the command, so an edited source rebuilds and a
stale library is never loaded. Parallel builders (pytest workers) each write
a private temporary file and move it into place atomically.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin)")


def build_shared(src: Path, name: str, compiler: list[str]) -> tuple[Path, str]:
    """Compile ``src`` with ``compiler + [-o out, src]`` unless a library
    built from the same source and command exists. Returns (library path,
    compiler output; empty when the library was already built)."""
    src = Path(src)
    key = hashlib.sha256(src.read_bytes() + " ".join(compiler).encode())
    out = BUILD_DIR / f"{name}_{key.hexdigest()[:16]}.so"
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        res = subprocess.run([*compiler, "-o", tmp, str(src)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"building {src.name} failed:\n{res.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out, res.stdout + res.stderr
