"""QM9 data preparation (the port's own copy of the JAX package's
`data/qm9.py`, numpy only).

Mirrors the reference notebooks' preparation (SURVEY.md §2.8): 12 property
columns scaled with MinMax(-1, 1); SMILES char-tokenized (keras-ordered);
padded post/post; the inverse-diffusion input one-hot with 0 -> -1.
``synthetic_qm9`` is a deterministic stand-in with the QM9 schema, made from
a seed, for tests and the card's smoke run.

``load_qm9`` reads the reference CSV (a download: the tests write their
own).  As in the JAX package, a plain CSV goes through the native reader
(``data/native``, the port's copy of that package's C++, built with g++ at
first use) and ``prepare_qm9`` tokenizes and one-hots through the native
tokenizer; a quoted CSV, a missing column, a malformed row and a vocabulary
that is not single-byte stay on the Python and numpy paths, which give the
same values and own the user-facing errors.  ``batch_iterator`` is the
host-side batch stream of the training loops.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from .preprocess import MinMaxScaler, train_test_split_indices
from .tokenizer import (CharTokenizer, add_start_end_char, one_hot_signed,
                        pad_sequences)

PROPERTY_NAMES: Tuple[str, ...] = (
    "mu", "alpha", "homo", "lumo", "gap", "r2",
    "zpve", "cv", "u0", "u298", "h298", "g298",
)
NUM_PROPERTIES = len(PROPERTY_NAMES)


# the canonical QM9 release: 133,885 molecules (reference README.md:30's
# Dropbox blob is this set + the 12 property columns above)
QM9_EXPECTED_ROWS = 133_885
# sha256 of known-good qm9_.csv blobs.  EMPTY until the blob has been seen
# once: the reference distributes it via a Dropbox link (README.md:30)
# that is absent from this snapshot, so no ground-truth hash exists yet.
# The day it appears, `verify_qm9_csv` prints the computed hash — pin it
# here and every later run is checksum-verified.
QM9_KNOWN_SHA256: Tuple[str, ...] = ()


def verify_qm9_csv(csv_path: str,
                   expected_sha256: Optional[str] = None) -> dict:
    """Structural + checksum verification of a candidate ``qm9_.csv``.

    Always enforced (raises ``ValueError``): the header must contain a
    SMILES column and all 12 property columns.  Recorded but only warned
    about (the synthetic stand-in and row-limited slices are legitimate):
    row count != the canonical 133,885; sha256 not among the known-good
    hashes.  Pass ``expected_sha256`` (or pin ``QM9_KNOWN_SHA256``) to
    make the checksum mismatch fatal.

    Returns ``{"sha256", "rows", "header_ok", "row_count_ok",
    "checksum_ok"}``, so that a quality table can name the exact blob.
    """
    import csv
    import hashlib

    h = hashlib.sha256()
    with open(csv_path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    sha256 = h.hexdigest()

    with open(csv_path, newline="") as f:
        reader = csv.reader(f)
        header = next(reader, [])
        rows = sum(1 for _ in reader)

    missing = [c for c in PROPERTY_NAMES if c not in header]
    has_smiles = any(c in header
                     for c in ("smiles", "SMILES", "canonical_smiles"))
    if missing or not has_smiles:
        raise ValueError(
            f"{csv_path} is not a QM9 CSV: missing property columns "
            f"{missing}" + ("" if has_smiles else " and a SMILES column"))

    known = QM9_KNOWN_SHA256 + ((expected_sha256,) if expected_sha256 else ())
    checksum_ok = sha256 in known if known else None
    if expected_sha256 and sha256 != expected_sha256:
        raise ValueError(
            f"{csv_path} sha256 {sha256} != expected {expected_sha256}")
    report = {"sha256": sha256, "rows": rows, "header_ok": True,
              "row_count_ok": rows == QM9_EXPECTED_ROWS,
              "checksum_ok": checksum_ok}
    if not report["row_count_ok"]:
        print(f"WARNING: {csv_path} has {rows} rows "
              f"(canonical QM9: {QM9_EXPECTED_ROWS}) — partial or stand-in "
              "dataset; quality numbers are not BASELINE.md-comparable")
    if checksum_ok is None:
        print(f"NOTE: no known-good QM9 hash pinned yet; this blob's "
              f"sha256 is {sha256} — pin it in "
              "data/qm9.py::QM9_KNOWN_SHA256 once validated")
    return report


def load_qm9(csv_path: str, smiles_column: str = "smiles",
             max_rows: Optional[int] = None) -> Tuple[List[str], np.ndarray]:
    """Load (smiles, properties[n, 12]) from the reference CSV.

    A plain (unquoted) CSV goes through the multithreaded native reader
    (``native/csv_loader.cpp``); anything it cannot commit to byte-exactly
    (quoting, missing columns, malformed rows) takes this Python csv path,
    which owns the user-facing errors."""
    from . import native
    loaded = native.load_csv(csv_path, PROPERTY_NAMES,
                             smiles_column=smiles_column, max_rows=max_rows)
    if loaded is not None:
        return loaded
    import csv

    smiles: List[str] = []
    rows: List[List[float]] = []
    with open(csv_path, newline="") as f:
        reader = csv.DictReader(f)
        cols = [c for c in PROPERTY_NAMES if c in (reader.fieldnames or [])]
        if len(cols) != NUM_PROPERTIES:
            raise ValueError(
                f"CSV at {csv_path} missing property columns; found {cols}")
        smi_col = smiles_column if smiles_column in reader.fieldnames else None
        if smi_col is None:
            for cand in ("smiles", "SMILES", "canonical_smiles"):
                if cand in reader.fieldnames:
                    smi_col = cand
                    break
        if smi_col is None:
            raise ValueError(f"No SMILES column in {csv_path}")
        for i, row in enumerate(reader):
            if max_rows is not None and i >= max_rows:
                break
            smiles.append(row[smi_col])
            rows.append([float(row[c]) for c in PROPERTY_NAMES])
    return smiles, np.asarray(rows, dtype=np.float32)


_SYNTH_ATOMS = ["C", "N", "O", "F"]
_SYNTH_DECOR = ["", "1", "(", ")", "=", "#"]


def _synth_properties(smiles: List[str],
                      rng: np.random.RandomState) -> np.ndarray:
    """12 correlated pseudo-properties: deterministic functions of the
    string composition + small noise (shared by both synthetic modes)."""
    n = len(smiles)
    feats = np.zeros((n, NUM_PROPERTIES), dtype=np.float32)
    for i, s in enumerate(smiles):
        counts = np.array([s.count(a) for a in _SYNTH_ATOMS], dtype=np.float32)
        base = np.concatenate([counts, [len(s), s.count("="), s.count("1"),
                                        counts.sum()]])
        proj = np.outer(np.arange(1, NUM_PROPERTIES + 1),
                        np.arange(1, len(base) + 1)) % 7 - 3
        feats[i] = proj @ base
    feats += rng.randn(n, NUM_PROPERTIES).astype(np.float32) * 0.1
    return feats


_SYNTH_CAPACITY = {"C": 4, "N": 3, "O": 2, "F": 1}


def _random_valid_molecule(rng: np.random.RandomState,
                           max_atoms: int) -> str:
    """One chemically valid QM9-style molecule: random spanning tree over
    C/N/O/F with valence bookkeeping, occasional double/triple bonds, and
    an optional single ring — emitted as SMILES by DFS."""
    k = rng.randint(2, max_atoms + 1)
    elems: List[str] = []
    rem: List[int] = []                    # remaining valence per atom
    children: List[List[Tuple[int, int]]] = []   # parent -> [(child, order)]
    parent = [-1] * k
    for i in range(k):
        if i == 0:
            e = _SYNTH_ATOMS[rng.randint(3)]           # not F: needs a child
            elems.append(e)
            rem.append(_SYNTH_CAPACITY[e])
            children.append([])
            continue
        cands = [j for j in range(i) if rem[j] >= 1]
        if not cands:
            break
        p = cands[rng.randint(len(cands))]
        e = _SYNTH_ATOMS[rng.randint(4)]
        order = 1
        cap = _SYNTH_CAPACITY[e]
        if cap >= 2 and rem[p] >= 2 and rng.rand() < 0.25:
            order = 2
            if cap >= 3 and rem[p] >= 3 and rng.rand() < 0.2:
                order = 3
        elems.append(e)
        rem.append(cap - order)
        children.append([])
        parent[i] = p
        children[p].append((i, order))
        rem[p] -= order
    k = len(elems)
    # optional ring: two non-adjacent atoms with spare valence, tree
    # distance >= 2 (ring size >= 3)
    ring: Optional[Tuple[int, int]] = None
    if k >= 3 and rng.rand() < 0.5:
        def depth_path(i):
            path = []
            while i >= 0:
                path.append(i)
                i = parent[i]
            return path
        spare = [i for i in range(k) if rem[i] >= 1]
        rng.shuffle(spare)
        for a in spare:
            pa = depth_path(a)
            for b in spare:
                if b <= a or parent[b] == a or parent[a] == b:
                    continue
                pb = depth_path(b)
                common = next(x for x in pa if x in pb)
                dist = pa.index(common) + pb.index(common)
                if dist >= 2:
                    ring = (a, b)
                    break
            if ring:
                break
    _BOND = {1: "", 2: "=", 3: "#"}

    def emit(i: int) -> str:
        s = elems[i]
        if ring and i in ring:
            s += "1"
        kids = children[i]
        parts = []
        for idx, (c, order) in enumerate(kids):
            sub = _BOND[order] + emit(c)
            parts.append(sub if idx == len(kids) - 1 else f"({sub})")
        return s + "".join(parts)

    return emit(0)


def synthetic_qm9(n: int = 2048, seed: int = 0, max_atoms: int = 9,
                  chemically_valid: bool = False
                  ) -> Tuple[List[str], np.ndarray]:
    """Deterministic QM9-schema stand-in: short strings over the QM9
    character set + 12 correlated pseudo-properties.

    Default mode is organic-ish but NOT chemically valid in general —
    kept byte-stable for pipeline tests and throughput benchmarks.
    ``chemically_valid=True`` generates valence-correct molecules
    (every string passes ``design.valence.valence_smiles_valid``), so
    validity/novelty metrics carry meaning without the real CSV —
    `tools/reproduce_baseline.py` uses this mode."""
    rng = np.random.RandomState(seed)
    smiles: List[str] = []
    if chemically_valid:
        for _ in range(n):
            smiles.append(_random_valid_molecule(rng, max_atoms))
        return smiles, _synth_properties(smiles, rng)
    for _ in range(n):
        length = rng.randint(3, max_atoms + 1)
        parts = []
        open_ring = False
        for j in range(length):
            parts.append(_SYNTH_ATOMS[rng.randint(len(_SYNTH_ATOMS))])
            r = rng.randint(6)
            if r == 1 and not open_ring and j < length - 2:
                parts.append("1")
                open_ring = True
            elif r == 2 and open_ring:
                parts.append("1")
                open_ring = False
            elif r == 3 and j < length - 1:
                parts.append("=")
        if open_ring:
            parts.append("1")
        smiles.append("".join(parts))
    return smiles, _synth_properties(smiles, rng)


@dataclass
class QM9Data:
    """Fully prepared dataset for one model family."""
    tokenizer: CharTokenizer
    scaler: MinMaxScaler
    X_train: np.ndarray     # tokenized (or one-hot) SMILES
    X_test: np.ndarray
    y_train: np.ndarray     # scaled properties (n, 12)
    y_test: np.ndarray
    smiles: List[str]       # full corpus (novelty reference set)
    x_norm_factor: float = 1.0

    @property
    def vocab_size(self) -> int:
        return self.tokenizer.num_tokens


def prepare_qm9(smiles: Sequence[str], properties: np.ndarray, *,
                mode: str = "inverse_diffusion",
                max_length: Optional[int] = None,
                test_size: float = 0.1,
                random_state: int = 235,
                start_char: str = "@", end_char: str = "$") -> QM9Data:
    """Replicates the notebook preparation for each of the four model flows.

    mode:
      * "forward_diffusion":   X = token ids / max_id, max_length 64
                               (Forward_Diffusion.ipynb cells 40-41)
      * "inverse_diffusion":   X = one-hot(0 -> -1) of ids, (n, 32, vocab)
                               (Inverse_Diffusion.ipynb cells 44-47)
      * "transformer":         X = token ids with @/$ delimiters, max_length 64
                               (Inverse_Transformer.ipynb cells 27-31)
    """
    properties = np.asarray(properties, dtype=np.float32)
    scaler = MinMaxScaler((-1.0, 1.0))
    y_scaled = scaler.fit_transform(properties).astype(np.float32)

    texts = list(smiles)
    if mode == "transformer":
        texts = add_start_end_char(texts, start_char, end_char)

    tokenizer = CharTokenizer().fit_on_texts(texts)

    from . import native

    def padded_ids(length: int) -> np.ndarray:
        out = native.tokenize_pad(texts, tokenizer.word_index, length)
        if out is None:    # a vocabulary that is not single-byte: numpy
            out = pad_sequences(tokenizer.texts_to_sequences(texts), length)
        return out

    if mode == "forward_diffusion":
        max_length = 64 if max_length is None else max_length
        x_norm = float(tokenizer.vocab_size)
        X = padded_ids(max_length).astype(np.float32) / x_norm
    elif mode == "inverse_diffusion":
        max_length = 32 if max_length is None else max_length
        X = native.tokenize_one_hot(texts, tokenizer.word_index, max_length,
                                    tokenizer.num_tokens)
        if X is None:
            X = one_hot_signed(padded_ids(max_length), tokenizer.num_tokens)
        x_norm = 1.0
    elif mode == "transformer":
        max_length = 64 if max_length is None else max_length
        X = padded_ids(max_length).astype(np.int32)
        x_norm = 1.0
    else:
        raise ValueError(f"Unknown mode: {mode}")

    train_idx, test_idx = train_test_split_indices(len(X), test_size,
                                                   random_state)
    return QM9Data(
        tokenizer=tokenizer, scaler=scaler,
        X_train=X[train_idx], X_test=X[test_idx],
        y_train=y_scaled[train_idx], y_test=y_scaled[test_idx],
        smiles=list(smiles), x_norm_factor=x_norm,
    )


def is_novel(all_smiles: Sequence[str], smi: str) -> bool:
    """Membership-novelty test (reference `generative.py:1063-1067`)."""
    return smi not in all_smiles


def batch_iterator(X: np.ndarray, y: np.ndarray, batch_size: int, *,
                   rng: Optional[np.random.RandomState] = None,
                   shuffle: bool = True,
                   drop_remainder: bool = True) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Host-side batch stream.  With ``drop_remainder`` every batch has
    the same shape, so every step of an epoch splits into the same
    micro-batches."""
    n = len(X)
    idx = np.arange(n)
    if shuffle:
        (rng or np.random.RandomState(0)).shuffle(idx)
    stop = (n // batch_size) * batch_size if drop_remainder else n
    for start in range(0, stop, batch_size):
        sel = idx[start:start + batch_size]
        yield X[sel], y[sel]
