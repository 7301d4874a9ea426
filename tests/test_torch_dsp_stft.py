"""The port's sinc resampling (``nn/dsp.py``) and STFT codec
(``nn/stft.py``) against the JAX package's, on the CPU in float32, on the
same numpy-seeded inputs.

Bands: every output within 2e-5.  The STFT's phase is compared only where
the magnitude is above 1e-3 (the angle of a near-zero bin is noise), as the
shortest way round the circle.  The round trip ``decode(encode(x))`` gives
back x within 1e-5, JAX's own band."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moleculediffusiontransformer_tpu.core.utils import \
    closest_power_2 as jclosest
from moleculediffusiontransformer_tpu.nn import dsp as jdsp
from moleculediffusiontransformer_tpu.nn import stft as jstft
from moleculediffusiontransformer_tpu_torch.core.utils import closest_power_2
from moleculediffusiontransformer_tpu_torch.nn import dsp, stft

TOL = 2e-5


def _wave(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("x", [1, 3, 5, 6, 24, 100.0, 2 ** 12 * 1.4,
                               511 * 256.0])
def test_closest_power_2(x):
    assert closest_power_2(x) == jclosest(x)


@pytest.mark.parametrize("factors", [(2, 1), (1, 3), (4, 1), (1, 2), (3, 2),
                                     (1, 1)])
def test_resample_matches_jax(factors):
    fi, fo = factors
    x = _wave((2, 40, 3), seed=fi * 10 + fo)
    want = np.asarray(jax.jit(lambda a: jdsp.resample(a, fi, fo))(
        jnp.asarray(x)))
    got = dsp.resample(torch.from_numpy(x), fi, fo)
    assert tuple(got.shape) == want.shape == (2, int(fo * 40 / fi), 3)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)
    kernels, width = dsp._sinc_kernels(fi, fo)
    jkernels, jwidth = jdsp._sinc_kernels(fi, fo)
    assert width == jwidth
    np.testing.assert_array_equal(np.transpose(kernels, (2, 1, 0)), jkernels)


@pytest.mark.parametrize("factor", [2, 4])
def test_down_and_upsample_match_jax(factor):
    x = _wave((2, 64, 2), seed=factor)
    for port, ref in ((dsp.downsample, jdsp.downsample),
                      (dsp.upsample, jdsp.upsample)):
        want = np.asarray(ref(jnp.asarray(x), factor))
        got = port(torch.from_numpy(x), factor).numpy()
        np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def _phase_err(got, want, magnitude):
    d = np.abs(got - want) % (2 * np.pi)
    d = np.minimum(d, 2 * np.pi - d)
    return d[magnitude > 1e-3].max()


# (n_fft, hop, window_length, wave length)
STFT_CASES = [(31, 8, None, 64), (16, 4, 12, 48), (15, 4, None, 100)]


@pytest.mark.parametrize("case", STFT_CASES)
def test_stft_encode_and_decode_match_jax(case):
    n_fft, hop, win, length = case
    x = _wave((2, length, 2), seed=n_fft)
    j = jstft.STFT(num_fft=n_fft, hop_length=hop, window_length=win)
    t = stft.STFT(num_fft=n_fft, hop_length=hop, window_length=win)
    np.testing.assert_array_equal(t.window.numpy(), np.asarray(j.window))
    ja, jb = (np.asarray(v) for v in jax.jit(j.encode)(jnp.asarray(x)))
    ta, tb = (v.numpy() for v in t.encode(torch.from_numpy(x)))
    frames = 1 + (length + 2 * (n_fft // 2) - n_fft) // hop
    assert ta.shape == ja.shape == (2, 2, n_fft // 2 + 1, frames)
    np.testing.assert_allclose(ta, ja, atol=TOL, rtol=0)
    assert _phase_err(tb, jb, ja) <= TOL
    # decode the same (magnitude, phase) in both
    want = np.asarray(jax.jit(j.decode)(jnp.asarray(ja), jnp.asarray(jb)))
    got = t.decode(torch.tensor(ja), torch.tensor(jb)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


@pytest.mark.parametrize("case", STFT_CASES[:2])
def test_stft_complex_and_1d_codec_match_jax(case):
    n_fft, hop, win, length = case
    x = _wave((2, length, 3), seed=n_fft + 1)
    for use_complex in (True, False):
        j = jstft.STFT(num_fft=n_fft, hop_length=hop, window_length=win,
                       length=length, use_complex=use_complex)
        t = stft.STFT(num_fft=n_fft, hop_length=hop, window_length=win,
                      length=length, use_complex=use_complex)
        jpair = np.asarray(jax.jit(j.encode1d)(jnp.asarray(x)))
        tpair = t.encode1d(torch.from_numpy(x)).numpy()
        assert tpair.shape == jpair.shape
        cf = jpair.shape[-1] // 2
        if use_complex:
            np.testing.assert_allclose(tpair, jpair, atol=TOL, rtol=0)
        else:
            np.testing.assert_allclose(tpair[..., :cf], jpair[..., :cf],
                                       atol=TOL, rtol=0)
            assert _phase_err(tpair[..., cf:], jpair[..., cf:],
                              jpair[..., :cf]) <= TOL
        halves = t.encode1d(torch.from_numpy(x), stacked=False)
        np.testing.assert_array_equal(torch.cat(halves, -1).numpy(), tpair)
        want = np.asarray(jax.jit(j.decode1d)(jnp.asarray(jpair)))
        got = t.decode1d(torch.tensor(jpair)).numpy()
        np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


@pytest.mark.parametrize("use_complex", [False, True])
def test_stft_round_trip(use_complex):
    x = _wave((2, 64, 2), seed=7)
    t = stft.STFT(num_fft=31, hop_length=8, length=64,
                  use_complex=use_complex)
    a, b = t.encode(torch.from_numpy(x))
    np.testing.assert_allclose(t.decode(a, b).numpy(), x, atol=1e-5,
                               rtol=0)
    rec = t.decode1d(t.encode1d(torch.from_numpy(x)))
    np.testing.assert_allclose(rec.numpy(), x, atol=1e-5, rtol=0)
    # no length given: the power of two nearest T * hop
    free = stft.STFT(num_fft=31, hop_length=8, use_complex=use_complex)
    assert free.decode(a, b).shape == (2, closest_power_2(9 * 8), 2)
