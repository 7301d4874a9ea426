"""The host data path's native code (the port's own copy of the JAX
package's `data/native/`): char-level tokenization, padding and the signed
one-hot (``tokenizer.cpp``) and a multithreaded plain-CSV reader
(``csv_loader.cpp``), over a plain C interface loaded with ``ctypes``.

The library is built with g++ at first use, never at import, into
``_build/`` beside the package, named by the hash of its sources and flags
(an edited source builds anew), through ``ops.cuda_build.build_once``:
processes building it at once take turns.  A failed build or load raises
with the compiler's output: there is no quiet fallback.  The entry points
return None exactly where the JAX package's do, so that the Python path
decides: a vocabulary that is not single-byte (``tokenize_pad``,
``tokenize_one_hot``); a quoted CSV, a missing column or a malformed row
(``load_csv``: the Python path owns the user-facing errors).  ``CALLS``
counts, by entry point, the calls that the library answered.
"""
from __future__ import annotations

import ctypes
import hashlib
import shutil
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ...ops.cuda_build import build_once

SOURCE_DIR = Path(__file__).resolve().parent
SOURCES = ("tokenizer.cpp", "csv_loader.cpp")
BUILD_DIR = SOURCE_DIR.parents[1] / "_build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

CALLS = {"tokenize_pad": 0, "tokenize_one_hot": 0, "load_csv": 0}

_LIB: Optional[ctypes.CDLL] = None
_I64 = ctypes.c_int64
_I64P = ctypes.POINTER(ctypes.c_int64)


def library_path() -> Path:
    """Where the library built from ``SOURCES`` in ``SOURCE_DIR`` lives."""
    digest = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    for name in SOURCES:
        digest.update(name.encode())
        digest.update((SOURCE_DIR / name).read_bytes())
    return BUILD_DIR / f"libmdt_native_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless it exists; returns its path.  Raises
    RuntimeError with g++'s output when the build fails."""
    def command(out: Path) -> List[str]:
        gxx = shutil.which("g++")
        if gxx is None:
            raise RuntimeError("g++ not found on PATH: the native data path "
                               "cannot be built")
        return [gxx, *GXX_FLAGS, *[str(SOURCE_DIR / n) for n in SOURCES],
                "-o", str(out)]
    return build_once(library_path(), command, "the native data path")[0]


def _library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        u8p, i32p = (ctypes.POINTER(ctypes.c_uint8),
                     ctypes.POINTER(ctypes.c_int32))
        f32p = ctypes.POINTER(ctypes.c_float)
        lib.tokenize_pad.argtypes = [ctypes.c_char_p, _I64P, _I64, u8p, _I64,
                                     i32p]
        lib.tokenize_one_hot.argtypes = [ctypes.c_char_p, _I64P, _I64, u8p,
                                         _I64, _I64, i32p, f32p]
        lib.csv_count_rows.argtypes = [ctypes.c_char_p, _I64]
        lib.csv_count_rows.restype = _I64
        lib.csv_parse_rows.argtypes = [ctypes.c_char_p, _I64, _I64, _I64,
                                       _I64P, _I64, _I64P, f32p]
        lib.csv_parse_rows.restype = _I64
        _LIB = lib
    return _LIB


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _single_byte(word_index: Dict[str, int]) -> bool:
    return all(len(ch.encode("utf-8")) == 1 and idx < 256
               for ch, idx in word_index.items())


def _char_map(word_index: Dict[str, int]) -> np.ndarray:
    cmap = np.zeros(256, np.uint8)
    for ch, idx in word_index.items():
        b = ch.encode("utf-8")
        if len(b) == 1 and 0 < idx < 256:
            cmap[b[0]] = idx
    return cmap


def _pack(texts: Sequence[str]) -> Tuple[bytes, np.ndarray]:
    data = "".join(texts).encode("utf-8")
    lengths = np.fromiter((len(t.encode("utf-8")) for t in texts),
                          np.int64, count=len(texts))
    offsets = np.zeros(len(texts) + 1, np.int64)
    np.cumsum(lengths, out=offsets[1:])
    return data, offsets


def tokenize_pad(texts: Sequence[str], word_index: Dict[str, int],
                 max_length: int) -> Optional[np.ndarray]:
    """texts -> (n, max_length) int32 ids, post-padded and post-truncated
    with 0, unknown characters dropped (``pad_sequences`` of
    ``texts_to_sequences``); None for a vocabulary that is not
    single-byte."""
    if not _single_byte(word_index):
        return None
    lib = _library()
    data, offsets = _pack(texts)
    out = np.empty((len(texts), max_length), np.int32)
    lib.tokenize_pad(data, _ptr(offsets, ctypes.c_int64), len(texts),
                     _ptr(_char_map(word_index), ctypes.c_uint8), max_length,
                     _ptr(out, ctypes.c_int32))
    CALLS["tokenize_pad"] += 1
    return out


def tokenize_one_hot(texts: Sequence[str], word_index: Dict[str, int],
                     max_length: int,
                     num_classes: int) -> Optional[np.ndarray]:
    """texts -> (n, max_length, num_classes) float32 one-hot of the padded
    ids with 0 -> -1 (``one_hot_signed``), in one pass; None for a
    vocabulary that is not single-byte."""
    if not _single_byte(word_index):
        return None
    lib = _library()
    data, offsets = _pack(texts)
    n = len(texts)
    ids = np.empty((n, max_length), np.int32)
    out = np.empty((n, max_length, num_classes), np.float32)
    lib.tokenize_one_hot(data, _ptr(offsets, ctypes.c_int64), n,
                         _ptr(_char_map(word_index), ctypes.c_uint8),
                         max_length, num_classes, _ptr(ids, ctypes.c_int32),
                         _ptr(out, ctypes.c_float))
    CALLS["tokenize_one_hot"] += 1
    return out


def load_csv(csv_path: str, property_names: Sequence[str],
             smiles_column: str = "smiles", max_rows: Optional[int] = None
             ) -> Optional[Tuple[List[str], np.ndarray]]:
    """A plain CSV -> (SMILES list, (n, len(property_names)) float32), the
    floats parsed as doubles and narrowed as Python's ``float`` and numpy
    narrow them; None where the Python ``csv`` path must decide: a quoted
    CSV, no header line, a missing property or SMILES column, a malformed
    row."""
    with open(csv_path, "rb") as f:
        data = f.read()
    if b'"' in data:
        return None
    nl = data.find(b"\n")
    if nl < 0:
        return None
    try:
        header = data[:nl].decode("utf-8").rstrip("\r").split(",")
    except UnicodeDecodeError:
        return None
    col_index = {name: i for i, name in enumerate(header)}
    if any(name not in col_index for name in property_names):
        return None
    smi_col = next((col_index[c] for c in (smiles_column, "smiles", "SMILES",
                                           "canonical_smiles")
                    if c in col_index), None)
    if smi_col is None:
        return None
    lib = _library()
    n = int(lib.csv_count_rows(data, len(data)))
    if max_rows is not None:
        n = min(n, max_rows)
    prop_cols = np.asarray([col_index[c] for c in property_names], np.int64)
    spans = np.empty((n, 2), np.int64)
    props = np.empty((n, len(property_names)), np.float32)
    rc = int(lib.csv_parse_rows(data, len(data), n, smi_col,
                                _ptr(prop_cols, ctypes.c_int64),
                                len(property_names),
                                _ptr(spans, ctypes.c_int64),
                                _ptr(props, ctypes.c_float)))
    if rc != 0:
        return None
    CALLS["load_csv"] += 1
    return [data[b:e].decode("utf-8") for b, e in spans.tolist()], props
