"""The port's own copy of the native host data path (``data/native``: the
C++ tokenizer and CSV reader, built with g++ into ``_build/``) against the
port's numpy paths and the JAX package's native results, exactly, and its
routing in the port's ``load_qm9`` and ``prepare_qm9`` (the JAX package's
``tests/test_native.py``, without its timing checks).  A build that fails
raises, naming the compiler's error."""
import shutil

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from moleculediffusiontransformer_tpu.data import native as jnative
from moleculediffusiontransformer_tpu_torch.data import native
from moleculediffusiontransformer_tpu_torch.data import qm9
from moleculediffusiontransformer_tpu_torch.data.tokenizer import (
    CharTokenizer, one_hot_signed, pad_sequences)


@pytest.fixture(scope="module")
def corpus():
    smiles, _ = qm9.synthetic_qm9(n=512, seed=3)
    return smiles, CharTokenizer().fit_on_texts(smiles)


def _numpy_ids(tok, texts, length):
    return pad_sequences(tok.texts_to_sequences(texts), length)


def test_native_builds_into_the_package_build_dir():
    path = native.build()
    assert path.exists() and path.parent == native.BUILD_DIR
    assert path == native.library_path()
    assert native.BUILD_DIR.name == "_build"
    assert native.BUILD_DIR.parent.name == \
        "moleculediffusiontransformer_tpu_torch"


def test_tokenize_pad_matches_numpy_and_jax(corpus):
    smiles, tok = corpus
    before = native.CALLS["tokenize_pad"]
    got = native.tokenize_pad(smiles, tok.word_index, 24)
    assert native.CALLS["tokenize_pad"] == before + 1
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, _numpy_ids(tok, smiles, 24))
    np.testing.assert_array_equal(
        got, jnative.tokenize_pad(smiles, tok.word_index, 24))


def test_tokenize_one_hot_matches_numpy_and_jax(corpus):
    smiles, tok = corpus
    got = native.tokenize_one_hot(smiles, tok.word_index, 16, tok.num_tokens)
    want = one_hot_signed(_numpy_ids(tok, smiles, 16), tok.num_tokens)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jnative.tokenize_one_hot(
        smiles, tok.word_index, 16, tok.num_tokens))


def test_unknown_chars_dropped(corpus):
    _, tok = corpus
    texts = ["C@@C", "", "CéN中O", "?" * 30]
    got = native.tokenize_pad(texts, tok.word_index, 6)
    np.testing.assert_array_equal(got, _numpy_ids(tok, texts, 6))
    np.testing.assert_array_equal(
        got, jnative.tokenize_pad(texts, tok.word_index, 6))


def test_multi_byte_vocabulary_stays_on_numpy(monkeypatch):
    """A vocabulary that is not single-byte is the numpy path's: the native
    calls return None, ``prepare_qm9`` calls nothing in the library and
    gives the numpy path's values."""
    tok = CharTokenizer().fit_on_texts(["CéC", "CO"])
    assert native.tokenize_pad(["CO"], tok.word_index, 4) is None
    assert native.tokenize_one_hot(["CO"], tok.word_index, 4, 5) is None
    smiles, props = ["CéC", "CO", "CCé", "OCO"] * 4, np.ones((16, 12))
    for mode in ("forward_diffusion", "inverse_diffusion"):
        before = dict(native.CALLS)
        got = qm9.prepare_qm9(smiles, props, mode=mode, max_length=4)
        assert native.CALLS == before
        with monkeypatch.context() as m:
            m.setattr(native, "tokenize_pad", lambda *a, **k: None)
            m.setattr(native, "tokenize_one_hot", lambda *a, **k: None)
            want = qm9.prepare_qm9(smiles, props, mode=mode, max_length=4)
        np.testing.assert_array_equal(got.X_train, want.X_train)
        np.testing.assert_array_equal(got.X_test, want.X_test)


@settings(max_examples=100, deadline=None)
@given(st.lists(st.text(alphabet=st.characters(min_codepoint=1,
                                               max_codepoint=0x2FFF),
                        max_size=40), min_size=1, max_size=8),
       st.integers(min_value=1, max_value=48))
def test_native_fuzz_matches_numpy(texts, max_length):
    """Arbitrary strings (unknown ASCII, multi-byte UTF-8, empty, longer
    than max_length) give the numpy path's ids and one-hot exactly."""
    smiles, _ = qm9.synthetic_qm9(n=64, seed=3)
    tok = CharTokenizer().fit_on_texts(smiles)
    want = _numpy_ids(tok, texts, max_length)
    np.testing.assert_array_equal(
        native.tokenize_pad(texts, tok.word_index, max_length), want)
    np.testing.assert_array_equal(
        native.tokenize_one_hot(texts, tok.word_index, max_length,
                                tok.num_tokens),
        one_hot_signed(want, tok.num_tokens))


def test_seeded_fuzz_matches_numpy_and_jax():
    """A seeded numpy fuzz over ASCII, the vocabulary and multi-byte
    characters: the port's native results equal numpy's and the JAX
    package's native results."""
    rng = np.random.default_rng(11)
    smiles, _ = qm9.synthetic_qm9(n=64, seed=4)
    tok = CharTokenizer().fit_on_texts(smiles)
    alphabet = list("CNOF()=#[]@+-123456789cno?!. ") + ["é", "中"]
    texts = ["".join(rng.choice(alphabet, size=rng.integers(0, 60)))
             for _ in range(300)]
    for length in (1, 7, 32, 64):
        got = native.tokenize_pad(texts, tok.word_index, length)
        np.testing.assert_array_equal(got, _numpy_ids(tok, texts, length))
        np.testing.assert_array_equal(
            got, jnative.tokenize_pad(texts, tok.word_index, length))
        hot = native.tokenize_one_hot(texts, tok.word_index, length,
                                      tok.num_tokens)
        np.testing.assert_array_equal(hot, one_hot_signed(got,
                                                          tok.num_tokens))
        np.testing.assert_array_equal(hot, jnative.tokenize_one_hot(
            texts, tok.word_index, length, tok.num_tokens))


@pytest.mark.parametrize("mode", ["forward_diffusion", "inverse_diffusion",
                                  "transformer"])
def test_prepare_qm9_routes_through_native(mode, monkeypatch):
    """``prepare_qm9`` tokenizes through the native library, as the JAX
    package's does, and equals the numpy path exactly."""
    smiles, props = qm9.synthetic_qm9(300, seed=5)
    before = dict(native.CALLS)
    got = qm9.prepare_qm9(smiles, props, mode=mode)
    called = {k: native.CALLS[k] - before[k] for k in before}
    want_call = ("tokenize_one_hot" if mode == "inverse_diffusion"
                 else "tokenize_pad")
    assert called[want_call] == 1 and sum(called.values()) == 1
    with monkeypatch.context() as m:
        m.setattr(native, "tokenize_pad", lambda *a, **k: None)
        m.setattr(native, "tokenize_one_hot", lambda *a, **k: None)
        want = qm9.prepare_qm9(smiles, props, mode=mode)
    for name in ("X_train", "X_test", "y_train", "y_test"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def _write_csv(path, text):
    with open(path, "w", newline="") as f:
        f.write(text)
    return str(path)


def _python_load_qm9(monkeypatch, path, **kw):
    """The Python csv path of the port's ``load_qm9`` (native declined)."""
    with monkeypatch.context() as m:
        m.setattr(native, "load_csv", lambda *a, **k: None)
        return qm9.load_qm9(path, **kw)


def test_csv_loader_matches_python(tmp_path, monkeypatch):
    """The native CSV parse equals csv.DictReader + Python float() bit for
    bit across number formats, CRLF endings, shuffled columns and an extra
    column; ``load_qm9`` takes the native path; ``max_rows`` agrees."""
    rng = np.random.RandomState(0)
    cols = list(qm9.PROPERTY_NAMES)
    rng.shuffle(cols)
    header = cols[:5] + ["extra", "smiles"] + cols[5:]
    fmts = ["{:.17g}", "{:.3e}", "{:.0f}", "{:g}", " {:.9g}"]
    lines = [",".join(header)]
    for i in range(200):
        vals = {c: fmts[(i + j) % len(fmts)].format(
            rng.randn() * 10 ** (j % 5 - 2)) for j, c in enumerate(cols)}
        vals["extra"] = str(i)
        vals["smiles"] = "C" * (1 + i % 9) + ("O" if i % 2 else "N")
        lines.append(",".join(vals[c] for c in header))
    path = _write_csv(tmp_path / "q.csv", "\r\n".join(lines) + "\r\n")

    ref_smiles, ref_props = _python_load_qm9(monkeypatch, path)
    got = native.load_csv(path, qm9.PROPERTY_NAMES)
    assert got is not None, "the native loader declined a plain CSV"
    assert got[0] == ref_smiles
    assert got[1].dtype == np.float32
    np.testing.assert_array_equal(got[1], ref_props)
    jgot = jnative.load_csv(path, qm9.PROPERTY_NAMES)
    assert jgot[0] == got[0]
    np.testing.assert_array_equal(jgot[1], got[1])

    before = native.CALLS["load_csv"]
    smiles2, props2 = qm9.load_qm9(path)
    assert native.CALLS["load_csv"] == before + 1
    assert smiles2 == ref_smiles
    np.testing.assert_array_equal(props2, ref_props)
    for rows in (0, 1, 5, 199, 200, 500):
        got_n = qm9.load_qm9(path, max_rows=rows)
        want_n = _python_load_qm9(monkeypatch, path, max_rows=rows)
        assert got_n[0] == want_n[0] == ref_smiles[:rows]
        np.testing.assert_array_equal(got_n[1].reshape(-1, 12),
                                      want_n[1].reshape(-1, 12))


def test_csv_loader_on_synthetic_qm9(tmp_path, monkeypatch):
    """``load_qm9`` on a written ``synthetic_qm9`` CSV equals the Python
    path exactly, ``max_rows`` included."""
    smiles, props = qm9.synthetic_qm9(2000, seed=6, chemically_valid=True)
    head = "smiles," + ",".join(qm9.PROPERTY_NAMES)
    rows = [s + "," + ",".join(repr(float(v)) for v in p)
            for s, p in zip(smiles, props)]
    path = _write_csv(tmp_path / "synth.csv", head + "\n" + "\n".join(rows))
    for max_rows in (None, 777):
        before = native.CALLS["load_csv"]
        got = qm9.load_qm9(path, max_rows=max_rows)
        assert native.CALLS["load_csv"] == before + 1
        want = _python_load_qm9(monkeypatch, path, max_rows=max_rows)
        assert got[0] == want[0]
        np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[1], props[:777])


def test_csv_loader_declines_quoted_missing_and_malformed(tmp_path,
                                                          monkeypatch):
    """Quoting, a missing column and a malformed float are the Python csv
    path's: the native loader declines, and ``load_qm9`` gives the Python
    path's result or raises its error."""
    head = "smiles," + ",".join(qm9.PROPERTY_NAMES)
    row = ",".join(["1.5"] * 12)
    quoted = _write_csv(tmp_path / "quoted.csv", f'{head}\n"CCO",{row}\n')
    assert native.load_csv(quoted, qm9.PROPERTY_NAMES) is None
    smiles, props = qm9.load_qm9(quoted)
    assert smiles == ["CCO"] and props.shape == (1, 12)

    bad = _write_csv(tmp_path / "bad.csv",
                     f"{head}\nCCO,{row}\nCCN,oops," + row[4:] + "\n")
    assert native.load_csv(bad, qm9.PROPERTY_NAMES) is None
    with pytest.raises(ValueError):
        _python_load_qm9(monkeypatch, bad)
    with pytest.raises(ValueError, match="oops"):
        qm9.load_qm9(bad)

    missing = _write_csv(tmp_path / "m.csv", "smiles,alpha\nCCO,1.0\n")
    assert native.load_csv(missing, qm9.PROPERTY_NAMES) is None
    with pytest.raises(ValueError, match="missing property columns"):
        qm9.load_qm9(missing)

    no_smiles = _write_csv(tmp_path / "s.csv",
                           ",".join(qm9.PROPERTY_NAMES) + "\n" + row + "\n")
    assert native.load_csv(no_smiles, qm9.PROPERTY_NAMES) is None
    with pytest.raises(ValueError, match="No SMILES column"):
        qm9.load_qm9(no_smiles)


def test_broken_build_raises_with_the_compiler_error(tmp_path, monkeypatch):
    """A source that does not compile (a temp copy of the sources, one of
    them broken) makes the first call raise with g++'s error, not return
    None."""
    src = tmp_path / "src"
    src.mkdir()
    for name in native.SOURCES:
        shutil.copy(native.SOURCE_DIR / name, src / name)
    with open(src / "tokenizer.cpp", "a") as f:
        f.write("\nint broken_here( { return 0; }\n")
    monkeypatch.setattr(native, "SOURCE_DIR", src)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_LIB", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as err:
        native.tokenize_pad(["CO"], {"C": 1, "O": 2}, 4)
    assert "tokenizer.cpp" in str(err.value) and "error" in str(err.value)
    assert not list((tmp_path / "_build").glob("*.so"))
