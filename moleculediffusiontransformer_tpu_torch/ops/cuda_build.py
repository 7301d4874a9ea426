"""Build the hand-written CUDA kernels in ``csrc/`` into shared libraries.

Each library is compiled with ``nvcc`` for Hopper (``sm_90a``) into
``_build/`` beside this package, on first use, never at import.  The file
name carries a hash of the sources and flags, so an edited source builds a
new library and a stale one is never loaded.  The libraries have a plain C
interface and are loaded with ``ctypes``; they link only the CUDA runtime.
Processes that build the same library at once (the ranks of a
``torchrun`` on a fresh tree) take turns on a file lock beside it: one
compiles, the others find the library when their turn comes.
"""
from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Callable, Dict, Iterator, List, Tuple

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_LOADED: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found on PATH or at /usr/local/cuda/bin; "
                       "the CUDA kernels cannot be built")


def library_path(source: str) -> Path:
    """Where the library built from ``csrc/<source>`` lives: named by the
    hash of every file in ``csrc/`` (a header may be shared) and the
    flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC_DIR.iterdir()):
        if path.suffix in (".cu", ".cuh", ".h"):
            digest.update(path.name.encode())
            digest.update(path.read_bytes())
    return BUILD_DIR / f"lib{Path(source).stem}_{digest.hexdigest()[:16]}.so"


@contextlib.contextmanager
def _locked(out: Path) -> Iterator[None]:
    """Hold the lock of the library ``out`` (released when the process
    ends, however it ends)."""
    with open(out.with_suffix(".lock"), "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def build(source: str) -> Tuple[Path, float]:
    """Compile ``csrc/<source>`` unless its library exists; returns the
    library path and the seconds spent compiling (0.0 when it existed).
    Raises RuntimeError with nvcc's output when the build fails."""
    return build_once(library_path(source), lambda out: [
        nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o", str(out),
        str(CSRC_DIR / source)], source)


def build_once(out: Path, command: Callable[[Path], List[str]],
               what: str) -> Tuple[Path, float]:
    """Build the shared library ``out`` unless it exists, with the compiler
    command line ``command(path)`` that writes ``path``: under the
    library's lock, into a temporary file renamed when complete, so that
    processes building it at once take turns and a reader never sees half
    a file.  Returns ``out`` and the seconds spent compiling (0.0 when it
    existed); raises RuntimeError with the compiler's output, naming
    ``what`` was built, when the build fails.  The port's host library
    (``data/native``) builds through it too."""
    if out.exists():
        return out, 0.0
    out.parent.mkdir(parents=True, exist_ok=True)
    with _locked(out):
        if out.exists():            # built by another process meanwhile
            return out, 0.0
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
            tmp_out = Path(tmp) / out.name
            cmd = command(tmp_out)
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"{Path(cmd[0]).name} failed ({proc.returncode}) "
                    f"building {what}:\n{' '.join(cmd)}\n{proc.stdout}\n"
                    f"{proc.stderr}")
            os.replace(tmp_out, out)   # atomic
        return out, time.perf_counter() - t0


def load(source: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<source>``, building it first
    if needed."""
    lib = _LOADED.get(source)
    if lib is None:
        path, _ = build(source)
        lib = _LOADED[source] = ctypes.CDLL(str(path))
    return lib
