"""The port's own copies of the JAX package's neutral modules
(``data/tokenizer.py``, ``data/preprocess.py``, ``data/qm9.py`` with
``load_qm9``, ``verify_qm9_csv`` and ``batch_iterator``,
``design/valence.py``, ``core/config.py``, ``core/utils.py``'s
``count_parameters``) against the originals: the same inputs, made from a
seed, give equal results -- exactly, with no tolerance."""
import dataclasses

import numpy as np
import pytest

from moleculediffusiontransformer_tpu.core import config as jcfg
from moleculediffusiontransformer_tpu.data import preprocess as jpre
from moleculediffusiontransformer_tpu.data import qm9 as jqm9
from moleculediffusiontransformer_tpu.data import tokenizer as jtok
from moleculediffusiontransformer_tpu.design.valence import \
    valence_smiles_valid as jax_valid
from moleculediffusiontransformer_tpu_torch.core import config as tcfg
from moleculediffusiontransformer_tpu_torch.data import preprocess as tpre
from moleculediffusiontransformer_tpu_torch.data import qm9 as tqm9
from moleculediffusiontransformer_tpu_torch.data import tokenizer as ttok
from moleculediffusiontransformer_tpu_torch.design.valence import \
    valence_smiles_valid as port_valid

from rdkit_corpus import RDKIT_INVALID, RDKIT_VALID


def test_tokenizer_and_helpers_match():
    smiles, _ = jqm9.synthetic_qm9(256, seed=3, chemically_valid=True)
    texts = jtok.add_start_end_char(smiles)
    assert ttok.add_start_end_char(smiles) == texts
    jt, tt = jtok.CharTokenizer().fit_on_texts(texts), \
        ttok.CharTokenizer().fit_on_texts(texts)
    assert tt.word_index == jt.word_index and tt.num_tokens == jt.num_tokens
    seqs = tt.texts_to_sequences(texts + ["C?Z"])
    assert seqs == jt.texts_to_sequences(texts + ["C?Z"])
    for padding in ("post", "pre"):
        for truncating in ("post", "pre"):
            got = ttok.pad_sequences(seqs, 12, padding, truncating)
            want = jtok.pad_sequences(seqs, 12, padding, truncating)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    ids = ttok.pad_sequences(seqs, 24)
    assert tt.decode(ids) == jt.decode(ids)
    assert tt.sequences_to_texts(ids) == jt.sequences_to_texts(ids)
    np.testing.assert_array_equal(ttok.one_hot_signed(ids, tt.num_tokens),
                                  jtok.one_hot_signed(ids, jt.num_tokens))
    for s in ("@CC$O$", "CC$", "@CC", "CC"):
        assert ttok.remove_start_end_token(s) == jtok.remove_start_end_token(s)
        assert (ttok.remove_start_end_token_first(s)
                == jtok.remove_start_end_token_first(s))
    back = ttok.CharTokenizer.from_state_dict(jt.state_dict())
    assert back.word_index == jt.word_index


def test_scaler_and_metrics_match():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((64, 12)) * rng.uniform(0.1, 50, 12)
    x[:, 3] = 2.5                                  # a constant column
    js, ts = jpre.MinMaxScaler((-1.0, 1.0)), tpre.MinMaxScaler((-1.0, 1.0))
    np.testing.assert_array_equal(ts.fit_transform(x), js.fit_transform(x))
    y = rng.uniform(-1, 1, (9, 12))
    np.testing.assert_array_equal(ts.inverse_transform(y),
                                  js.inverse_transform(y))
    assert ts.state_dict() == js.state_dict()
    a, b = rng.standard_normal(40), rng.standard_normal(40)
    assert tpre.r2_score(a, b) == jpre.r2_score(a, b)
    assert tpre.r2_score(np.ones(4), np.ones(4)) == 1.0
    assert tpre.mean_absolute_error(a, b) == jpre.mean_absolute_error(a, b)
    for got, want in zip(tpre.train_test_split_indices(101, 0.1, 235),
                         jpre.train_test_split_indices(101, 0.1, 235)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("valid", [False, True])
def test_synthetic_qm9_matches(valid):
    got = tqm9.synthetic_qm9(300, seed=5, chemically_valid=valid)
    want = jqm9.synthetic_qm9(300, seed=5, chemically_valid=valid)
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])
    assert tqm9.PROPERTY_NAMES == jqm9.PROPERTY_NAMES


@pytest.mark.parametrize("mode", ["inverse_diffusion", "forward_diffusion",
                                  "transformer"])
def test_prepare_qm9_matches(mode):
    smiles, props = jqm9.synthetic_qm9(200, seed=6, chemically_valid=True)
    got = tqm9.prepare_qm9(smiles, props, mode=mode)
    want = jqm9.prepare_qm9(smiles, props, mode=mode)
    assert got.tokenizer.word_index == want.tokenizer.word_index
    assert got.vocab_size == want.vocab_size
    assert got.x_norm_factor == want.x_norm_factor
    assert got.smiles == want.smiles
    for name in ("X_train", "X_test", "y_train", "y_test"):
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert got.scaler.state_dict() == want.scaler.state_dict()


def test_is_novel_matches():
    smiles, _ = jqm9.synthetic_qm9(64, seed=7)
    for s in smiles[:8] + ["CCO", "N#N", ""]:
        assert tqm9.is_novel(smiles, s) == jqm9.is_novel(smiles, s)


def test_valence_checker_matches_on_corpus_and_synthetic():
    """The port's checker gives the JAX one's verdict on every string of
    the annotated corpus and on 2,048 synthetic SMILES (both verdicts
    occur)."""
    corpus = list(RDKIT_VALID) + list(RDKIT_INVALID)
    synthetic, _ = jqm9.synthetic_qm9(2048, seed=8)
    verdicts = []
    for s in corpus + synthetic:
        v = port_valid(s)
        assert v == jax_valid(s), s
        verdicts.append(v)
    assert all(verdicts[:len(RDKIT_VALID)])
    assert not any(verdicts[len(RDKIT_VALID):len(corpus)])
    assert 0 < sum(verdicts[len(corpus):]) < len(synthetic)


CONFIGS = ("UNet1dConfig", "DiffusionConfig", "SamplingConfig",
           "QMDiffusionConfig", "TrainConfig", "TransformerConfig",
           "EncoderConfig")
PRESETS = ("forward_diffusion_qm9", "inverse_diffusion_qm9",
           "inverse_transformer_qm9", "forward_transformer_qm9")


@pytest.mark.parametrize("name", CONFIGS)
def test_config_classes_match_field_by_field(name):
    got, want = getattr(tcfg, name), getattr(jcfg, name)
    fields = [(f.name, f.type, f.default, f.default_factory)
              for f in dataclasses.fields(got)]
    assert fields == [(f.name, f.type, f.default, f.default_factory)
                      if f.default_factory is dataclasses.MISSING else
                      (f.name, f.type, f.default,
                       getattr(tcfg, f.default_factory.__name__))
                      for f in dataclasses.fields(want)]
    assert got.__dataclass_params__.frozen == want.__dataclass_params__.frozen
    assert [n for n in vars(got) if not n.startswith("__")] == \
        [n for n in vars(want) if not n.startswith("__")]


@pytest.mark.parametrize("name", PRESETS)
def test_config_presets_match(name):
    def as_dict(c):
        return {k: (as_dict(v) if dataclasses.is_dataclass(v) else v)
                for k, v in dataclasses.asdict(c).items()}

    args = [(), (10,)] if name == "inverse_diffusion_qm9" else [()]
    for a in args:
        got, want = getattr(tcfg, name)(*a), getattr(jcfg, name)(*a)
        assert type(got).__name__ == type(want).__name__
        assert as_dict(got) == as_dict(want)
        if hasattr(want, "conditioning_features"):
            assert got.conditioning_features == want.conditioning_features
        if hasattr(want, "num_layers"):
            assert got.num_layers == want.num_layers


def _write_csv(path, smiles, props, header=None, quote=False):
    header = header or ["smiles", *tqm9.PROPERTY_NAMES]
    with open(path, "w") as f:
        f.write(",".join(header) + "\n")
        for s, row in zip(smiles, props):
            s = f'"{s}"' if quote else s
            f.write(",".join([s, *(repr(float(v)) for v in row)]) + "\n")


@pytest.mark.parametrize("quote", [False, True])
def test_load_and_verify_qm9_csv_match(tmp_path, capsys, quote):
    smiles, props = jqm9.synthetic_qm9(50, seed=9, chemically_valid=True)
    path = str(tmp_path / "qm9_.csv")
    _write_csv(path, smiles, props, quote=quote)
    for max_rows in (None, 17):
        got = tqm9.load_qm9(path, max_rows=max_rows)
        want = jqm9.load_qm9(path, max_rows=max_rows)
        assert got[0] == want[0]
        assert got[1].dtype == want[1].dtype
        np.testing.assert_array_equal(got[1], want[1])
    assert tqm9.verify_qm9_csv(path) == jqm9.verify_qm9_csv(path)
    capsys.readouterr()
    bad = str(tmp_path / "bad.csv")
    _write_csv(bad, smiles, props[:, :11],
               header=["smiles", *tqm9.PROPERTY_NAMES[:11]])
    for module in (tqm9, jqm9):
        with pytest.raises(ValueError):
            module.load_qm9(bad)
        with pytest.raises(ValueError):
            module.verify_qm9_csv(bad)
        with pytest.raises(ValueError):
            module.verify_qm9_csv(path, expected_sha256="0" * 64)
    assert tqm9.QM9_EXPECTED_ROWS == jqm9.QM9_EXPECTED_ROWS
    assert tqm9.QM9_KNOWN_SHA256 == jqm9.QM9_KNOWN_SHA256


@pytest.mark.parametrize("shuffle, drop", [(True, True), (True, False),
                                           (False, True)])
def test_batch_iterator_matches(shuffle, drop):
    X = np.arange(23 * 3, dtype=np.float32).reshape(23, 3)
    y = np.arange(23, dtype=np.float32)
    got = list(tqm9.batch_iterator(X, y, 5, rng=np.random.RandomState(4),
                                   shuffle=shuffle, drop_remainder=drop))
    want = list(jqm9.batch_iterator(X, y, 5, rng=np.random.RandomState(4),
                                    shuffle=shuffle, drop_remainder=drop))
    assert len(got) == len(want) == (4 if drop else 5)
    for (a, b), (c, d) in zip(got, want):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)


def test_count_parameters_matches(capsys):
    import jax
    import jax.numpy as jnp
    import torch

    from moleculediffusiontransformer_tpu.core.utils import \
        count_parameters as jax_count
    from moleculediffusiontransformer_tpu.train import recipes as jrecipes
    from moleculediffusiontransformer_tpu_torch.core.utils import \
        count_parameters
    from moleculediffusiontransformer_tpu_torch.train import recipes

    jm = jrecipes.build_model("forward_transformer", 20, "tiny")
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64), jnp.int32))["params"]
    port = recipes.build_model("forward_transformer", 20, "tiny",
                               device="cpu")
    assert count_parameters(port) == jax_count(shapes)
    assert capsys.readouterr().out.count("Total parameters") == 2
    assert count_parameters(list(port.parameters()), verbose=False) == \
        sum(p.numel() for p in port.parameters())
    with torch.device("meta"):
        big = recipes.build_model("inverse_diffusion", 22, device="meta")
    assert count_parameters(big, verbose=False) == 90_965_554
