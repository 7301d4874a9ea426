"""The port's audio assemblies (``models/audio.py``: the upsampler, the
diffusion autoencoder, the vocoder, the upphaser and the chunked AR model,
their samplers and presets) and ``nn/autoencoder.py`` against the JAX
package, on the CPU in float32, at the tiny widths of
``examples/audio_diffusion.py``.  JAX's params load into the port with
``strict=True``; inputs are numpy-seeded; every draw a JAX loss or sampler
takes from its key (the factor index, the random phase, the chunk index and
its dropout, the sigmas, the noise) is computed from that key and handed to
the port.

Bands: each ``denoise_*``, each loss and each 4-step sampler within 1e-4
(the JAX suite's UNet band); the autoencoder's outputs within 1e-4."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moleculediffusiontransformer_tpu.diffusion import \
    UniformDistribution as JUniform
from moleculediffusiontransformer_tpu.models import audio as jaudio
from moleculediffusiontransformer_tpu.nn import autoencoder as jae
from moleculediffusiontransformer_tpu.nn.stft import STFT as JSTFT
from moleculediffusiontransformer_tpu_torch.models import audio
from moleculediffusiontransformer_tpu_torch.nn import autoencoder as tae
from moleculediffusiontransformer_tpu_torch.nn.jax_import import \
    state_dict_from_jax_params

# the tiny configuration of examples/audio_diffusion.py
TINY = dict(channels=16, patch_size=2, multipliers=(1, 2), factors=(2,),
            num_blocks=(1,), attentions=(0, 1), attention_heads=2,
            attention_features=8, attention_multiplier=2,
            diffusion_type="v", resnet_groups=4)
TOL = 1e-4
STEPS = 4


def _np(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _params(jmodel, *args, seed=0, **kwargs):
    """Random params of ``jmodel``'s shapes (traced, not run: an eager flax
    init compiles every op on the CPU): a kernel N(0, 1 / fan-in), a norm's
    scale 1 + N(0, 0.01), any other vector N(0, 0.01), an embedding
    N(0, 1)."""
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(jmodel.init, key, *args, **kwargs)["params"]
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = path[-1].key
        x = rng.standard_normal(s.shape).astype(np.float32)
        if len(s.shape) >= 2 and name != "embedding":
            return x / np.sqrt(np.prod(s.shape[:-1]))
        if len(s.shape) == 1:
            return (1.0 if name == "scale" else 0.0) + 0.1 * x
        return x

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _apply(jmodel, method=None, **kw):
    """``jmodel.apply({"params": p}, *args)`` jitted (one XLA compile, where
    an eager first call compiles each op)."""
    return jax.jit(lambda p, *args: jmodel.apply({"params": p}, *args,
                                                 method=method, **kw))


def _load(jparams, tcls, **kw):
    model = audio.build_model1d("cpu", None, tcls, **{**TINY, **kw})
    model.load_state_dict(state_dict_from_jax_params(jparams), strict=True)
    return model.eval()


def _loss_draws(key, shape):
    """The sigmas and the noise that ``loss_from_key`` draws from ``key``."""
    ks, kn = jax.random.split(key)
    return (torch.tensor(np.asarray(JUniform()(ks, shape[0]))),
            torch.tensor(np.asarray(jax.random.normal(kn, shape))))


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)


def _t(a):
    return torch.tensor(np.asarray(a))


# ------------------------------------------------------------ autoencoder

AE = dict(in_channels=3, channels=8, multipliers=(1, 2, 2), factors=(2, 2),
          num_blocks=(1, 2), patch_size=2, resnet_groups=4)


def test_encoder_and_decoder_match_jax():
    x = _np(1, (2, 32, 3))
    enc = jae.Encoder1d(out_channels=5, **AE)
    jp = _params(enc, jnp.asarray(x))
    tenc = tae.Encoder1d(out_channels=5, **AE)
    tenc.load_state_dict(state_dict_from_jax_params(jp), strict=True)
    want, info = _apply(enc, with_info=True)(jp, jnp.asarray(x))
    got, tinfo = tenc(torch.from_numpy(x), with_info=True)
    _close(got, want)
    assert len(tinfo["xs"]) == len(info["xs"]) == 5
    assert tenc.downsample_factor == 8 and tenc.encoded_channels == 5
    z = _np(2, (2, 4, 5))
    dkw = dict(AE, in_channels=5, out_channels=3,
               multipliers=(2, 2, 1), factors=(2, 2), num_blocks=(2, 1))
    dec = jae.Decoder1d(**dkw)
    dp = _params(dec, jnp.asarray(z))
    tdec = tae.Decoder1d(**dkw)
    tdec.load_state_dict(state_dict_from_jax_params(dp), strict=True)
    _close(tdec(torch.from_numpy(z)), _apply(dec)(dp, jnp.asarray(z)))


def test_autoencoder_matches_jax():
    x = _np(3, (2, 32, 3))
    kw = dict(AE, bottleneck_channels=6)
    jm = jae.AutoEncoder1d(bottlenecks=(jae.TanhBottleneck(),), **kw)
    jp = _params(jm, jnp.asarray(x))
    tm = tae.AutoEncoder1d(bottlenecks=(tae.TanhBottleneck(),), **kw)
    tm.load_state_dict(state_dict_from_jax_params(jp), strict=True)
    want, info = _apply(jm, with_info=True)(jp, jnp.asarray(x))
    got, tinfo = tm(torch.from_numpy(x), with_info=True)
    _close(got, want)
    _close(tinfo["latent"], info["latent"])
    assert tinfo["latent"].abs().max() <= 1            # the tanh bottleneck
    assert set(tinfo) == set(info)
    _close(tm.encode(torch.from_numpy(x)),
           _apply(jm, jae.AutoEncoder1d.encode)(jp, jnp.asarray(x)))
    z = np.array(info["latent"])
    _close(tm.decode(torch.from_numpy(z)),
           _apply(jm, jae.AutoEncoder1d.decode)(jp, jnp.asarray(z)))


# -------------------------------------------------------------- upsampler

UPSAMPLER = dict(in_channels=1, factor=(2, 4), factor_features=8,
                 context_features=8, context_channels=(1,))


def test_upsampler_matches_jax():
    x = _np(4, (3, 64, 1))
    key = jax.random.PRNGKey(4)
    jm = jaudio.DiffusionUpsampler1d(
        diffusion_sigma_distribution=JUniform(), **TINY, **UPSAMPLER)
    jp = _params(jm, jnp.asarray(x), key)
    tm = _load(jp, audio.DiffusionUpsampler1d, **UPSAMPLER)
    # the loss, with JAX's factor index, sigmas and noise
    k_aug, k_loss = jax.random.split(key)
    idx = jax.random.randint(k_aug, (3,), 0, 2)
    sigmas, noise = _loss_draws(k_loss, x.shape)
    want = _apply(jm)(jp, jnp.asarray(x), key)
    got = tm(torch.from_numpy(x), factor_index=_t(idx), sigmas=sigmas,
             noise=noise)
    assert abs(got.item() - float(want)) <= TOL
    # the re-upsampled condition and one denoise evaluation
    chan, jidx = _apply(jm, jaudio.DiffusionUpsampler1d.random_reupsample)(
        jp, jnp.asarray(x), k_aug)
    tchan, tidx = tm.random_reupsample(torch.from_numpy(x), index=_t(idx))
    _close(tchan, chan, 2e-5)
    feats = tm._factor_features(tidx)
    want = _apply(jm, jaudio.DiffusionUpsampler1d.denoise_upsample)(
        jp, jnp.asarray(x), jnp.asarray(sigmas), chan,
        jnp.asarray(feats.numpy()))
    _close(tm.denoise_upsample(torch.from_numpy(x), sigmas, tchan, feats),
           want)
    # sample_upsampler with JAX's noise, at the second factor
    under = x[:, ::4]
    k_noise, _ = jax.random.split(key)
    jnoise = jax.random.normal(k_noise, (3, 64, 1))
    want = jaudio.sample_upsampler(jm, {"params": jp}, jnp.asarray(under),
                                   key, factor=4, num_steps=STEPS)
    got = audio.sample_upsampler(tm, torch.from_numpy(under), factor=4,
                                 noise=_t(jnoise), num_steps=STEPS)
    _close(got, want)


# ------------------------------------------------------------ autoencoder

AE1D = dict(in_channels=1, encoder_channels=8, encoder_patch_size=2,
            encoder_multipliers=(1, 2), encoder_factors=(2,),
            encoder_num_blocks=(1,), encoder_out_channels=8,
            encoder_inject_depth=1, context_channels=(0, 8))


def test_diffusion_ae_matches_jax():
    x = _np(5, (2, 64, 1))
    key = jax.random.PRNGKey(5)
    jm = jaudio.DiffusionAE1d(diffusion_sigma_distribution=JUniform(),
                              **TINY, **AE1D)
    jp = _params(jm, jnp.asarray(x), key)
    tm = _load(jp, audio.DiffusionAE1d, **AE1D)
    sigmas, noise = _loss_draws(key, x.shape)
    want = _apply(jm)(jp, jnp.asarray(x), key)
    got = tm(torch.from_numpy(x), sigmas=sigmas, noise=noise)
    assert abs(got.item() - float(want)) <= TOL
    latent = _apply(jm, jaudio.DiffusionAE1d.encode)(jp, jnp.asarray(x))
    _close(tm.encode(torch.from_numpy(x)), latent)
    want = _apply(jm, jaudio.DiffusionAE1d.denoise_latent)(
        jp, jnp.asarray(x), jnp.asarray(sigmas), latent)
    _close(tm.denoise_latent(torch.from_numpy(x), sigmas, _t(latent)), want)
    # decode_ae: 16 latent steps x 4 -> 64 samples, on JAX's noise
    k_noise, _ = jax.random.split(key)
    jnoise = jax.random.normal(k_noise, (2, 64, 1))
    want = jaudio.decode_ae(jm, {"params": jp}, latent, key,
                            downsample_factor=4, num_steps=STEPS)
    got = audio.decode_ae(tm, _t(latent), downsample_factor=4,
                          noise=_t(jnoise), num_steps=STEPS)
    _close(got, want)


# ---------------------------------------------------------------- vocoder

def _vocoder_inputs(wave):
    """JAX's STFT of ``wave`` at n_fft 31, hop 8: (b, 1, 16, 16)."""
    mag, phase = JSTFT(num_fft=31, hop_length=8).encode(jnp.asarray(wave))
    return np.asarray(mag), np.asarray(phase)


VOCODER = dict(in_channels=16, context_channels=(16,), stft_num_fft=31,
               stft_hop_length=8)


def test_vocoder_matches_jax():
    wave = _np(6, (2, 121, 1))                  # 16 frames
    mag, phase = _vocoder_inputs(wave)
    key = jax.random.PRNGKey(6)
    jm = jaudio.DiffusionVocoder1d(diffusion_sigma_distribution=JUniform(),
                                   **TINY, **VOCODER)
    jp = _params(jm, jnp.asarray(mag), jnp.asarray(phase), key)
    tm = _load(jp, audio.DiffusionVocoder1d, **VOCODER)
    sigmas, noise = _loss_draws(key, (2, 16, 16))
    want = _apply(jm)(jp, jnp.asarray(mag), jnp.asarray(phase), key)
    got = tm(torch.tensor(mag), torch.tensor(phase), sigmas=sigmas,
             noise=noise)
    assert abs(got.item() - float(want)) <= TOL
    want = _apply(jm, jaudio.DiffusionVocoder1d.loss_from_wave)(
        jp, jnp.asarray(wave), key)
    got = tm.loss_from_wave(torch.from_numpy(wave), sigmas=sigmas,
                            noise=noise)
    assert abs(got.item() - float(want)) <= TOL
    flat = np.transpose(mag.reshape(2, 16, 16), (0, 2, 1))
    xn = _np(7, (2, 16, 16))
    want = _apply(jm, jaudio.DiffusionVocoder1d.denoise_vocoder)(
        jp, jnp.asarray(xn), jnp.asarray(sigmas), jnp.asarray(flat))
    _close(tm.denoise_vocoder(torch.from_numpy(xn), sigmas,
                              torch.tensor(flat)), want)
    k_noise, _ = jax.random.split(key)
    jnoise = jax.random.normal(k_noise, (2, 16, 16))
    want = jaudio.sample_vocoder(jm, {"params": jp}, jnp.asarray(mag), key,
                                 num_steps=STEPS)
    got = audio.sample_vocoder(tm, torch.tensor(mag), noise=_t(jnoise),
                               num_steps=STEPS)
    assert tuple(got.shape) == (2, 128, 1)
    _close(got, want)


# --------------------------------------------------------------- upphaser

UPPHASER = dict(in_channels=1, factor=(1,), stft_num_fft=15,
                stft_hop_length=4, context_channels=(1,))


def test_upphaser_matches_jax():
    x = _np(8, (2, 64, 1))
    key = jax.random.PRNGKey(8)
    jm = jaudio.DiffusionUpphaser1d(diffusion_sigma_distribution=JUniform(),
                                    **TINY, **UPPHASER)
    jp = _params(jm, jnp.asarray(x), key)
    tm = _load(jp, audio.DiffusionUpphaser1d, **UPPHASER)
    k_phase, k_aug, k_loss = jax.random.split(key, 3)
    phase = (jax.random.uniform(k_phase, (2, 1, 8, 16)) - 0.5) * 2 * np.pi
    idx = jax.random.randint(k_aug, (2,), 0, 1)
    sigmas, noise = _loss_draws(k_loss, x.shape)
    rephased = _apply(jm, jaudio.DiffusionUpphaser1d.random_rephase)(
        jp, jnp.asarray(x), k_phase)
    _close(tm.random_rephase(torch.from_numpy(x), phase=_t(phase)),
           rephased, 2e-5)
    want = _apply(jm)(jp, jnp.asarray(x), key)
    got = tm(torch.from_numpy(x), phase=_t(phase), factor_index=_t(idx),
             sigmas=sigmas, noise=noise)
    assert abs(got.item() - float(want)) <= TOL
    k_noise, _ = jax.random.split(key)
    jnoise = jax.random.normal(k_noise, x.shape)
    want = jaudio.sample_upsampler(jm, {"params": jp}, jnp.asarray(x), key,
                                   factor=1, num_steps=STEPS)
    got = audio.sample_upsampler(tm, torch.from_numpy(x), factor=1,
                                 noise=_t(jnoise), num_steps=STEPS)
    _close(got, want)


# --------------------------------------------------------------------- AR

@pytest.mark.parametrize("upsample_factor", [0, 2])
def test_ar_matches_jax(upsample_factor):
    c, cl = 2, 16
    kw = dict(in_channels=c, chunk_length=cl, dropout=0.5,
              upsample_factor=upsample_factor,
              context_channels=(c * (2 if upsample_factor else 1),))
    x = _np(9, (4, 4 * cl, c))
    key = jax.random.PRNGKey(9 + upsample_factor)
    jm = jaudio.DiffusionAR1d(diffusion_sigma_distribution=JUniform(),
                              **TINY, **kw)
    jp = _params(jm, jnp.asarray(x), key)
    tm = _load(jp, audio.DiffusionAR1d, **kw)
    k_idx, k_drop, k_loss = jax.random.split(key, 3)
    index = jax.random.randint(k_idx, (), 0, 3)
    dropped = jax.random.bernoulli(k_drop, 0.5, (4, 1, 1))
    sigmas, noise = _loss_draws(k_loss, (4, cl, c))
    want = _apply(jm)(jp, jnp.asarray(x), key)
    got = tm(torch.from_numpy(x), chunk_index=int(index),
             dropped=_t(dropped).reshape(4), sigmas=sigmas, noise=noise)
    assert abs(got.item() - float(want)) <= TOL
    chan = _np(10, (4, cl, kw["context_channels"][0]))
    want = _apply(jm, jaudio.DiffusionAR1d.denoise_chunk)(
        jp, jnp.asarray(x[:, :cl]), jnp.asarray(sigmas), jnp.asarray(chan))
    _close(tm.denoise_chunk(torch.from_numpy(x[:, :cl]), sigmas,
                            torch.from_numpy(chan)), want)
    # sample_ar: 2 chunks (from undersampled audio: 2 after upsampling),
    # 4 v-steps each
    start = _np(11, (4, cl, c))
    if upsample_factor:
        src = x[:, :cl]
        _, k = jax.random.split(key)
        draws = dict(noise=_t(jax.random.normal(k, (4, 2 * cl, c))))
    else:
        src, draws = _np(12, (4, 2 * cl, c)), {}
    want = jaudio.sample_ar(jm, {"params": jp}, jnp.asarray(src), key,
                            start=jnp.asarray(start), num_steps=STEPS)
    got = audio.sample_ar(tm, torch.from_numpy(src),
                          start=torch.from_numpy(start), num_steps=STEPS,
                          **draws)
    assert tuple(got.shape) == (4, 2 * cl, c)
    _close(got, want)


def test_ar_draws_on_its_own():
    """Without handed-in draws the loss takes its chunk index, dropout,
    sigmas and noise from the generator: the same generator state gives
    the same loss."""
    kw = dict(in_channels=1, chunk_length=16, context_channels=(1,))
    tm = audio.build_model1d("cpu", torch.Generator().manual_seed(0),
                             audio.DiffusionAR1d, **TINY, **kw)
    x = torch.randn(2, 64, 1, generator=torch.Generator().manual_seed(1))
    losses = [tm(x, torch.Generator().manual_seed(2)).item()
              for _ in range(2)]
    assert losses[0] == losses[1] and np.isfinite(losses[0])


# ---------------------------------------------------------------- presets

@functools.lru_cache(maxsize=None)
def _jax_shapes(name):
    """The state_dict shapes of the JAX preset ``name`` at one row of the
    shortest length the waveform UNet divides (the upphaser's and the AR
    model's parameters are the upsampler's)."""
    if name == "AudioDiffusionVocoder":
        spec = jnp.zeros((1, 1, 512, 64))
        jmodel, args = jaudio.AudioDiffusionVocoder(in_channels=1), (spec,
                                                                     spec)
    else:
        jmodel = getattr(jaudio, name)(in_channels=1)
        args = (jnp.zeros((1, PRESET_LENGTH, 1)),)
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(jmodel.init, {"params": key}, *args,
                            key)["params"]
    return {k: tuple(v.shape) for k, v in state_dict_from_jax_params(
        jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                               shapes)).items()}


PRESET_LENGTH = 16 * 4 * 4 * 4 * 2 * 2 * 2


@pytest.mark.parametrize("name", ["AudioDiffusionUpsampler",
                                  "AudioDiffusionAE",
                                  "AudioDiffusionVocoder",
                                  "AudioDiffusionUpphaser", "DiffusionAR1d"])
def test_presets_are_jaxs(name):
    """Each preset (and the AR model at the waveform widths) has the JAX
    package's parameters, by key and shape, and defaults to the card."""
    if name == "DiffusionAR1d":
        kw = dict(audio.get_default_model_kwargs(), in_channels=1,
                  chunk_length=8192, context_channels=(1,))

        def build(**more):
            return audio.build_model1d(cls=audio.DiffusionAR1d, **kw, **more)
    else:
        def build(**more):
            return getattr(audio, name)(in_channels=1, **more)
    with torch.device("meta"):
        port = build(device="meta")
    jax_name = {"AudioDiffusionUpphaser": "AudioDiffusionUpsampler",
                "DiffusionAR1d": "AudioDiffusionUpsampler"}.get(name, name)
    assert {k: tuple(v.shape) for k, v in port.state_dict().items()} == \
        _jax_shapes(jax_name)
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            build()


def test_t5_embedder_is_lazy():
    """Constructing ``T5Embedder`` imports nothing and loads no weights (a
    download): ``transformers`` is imported on the first call only; the
    embedding's device is the card unless the caller names another."""
    import subprocess
    import sys
    code = ("import sys\n"
            "from moleculediffusiontransformer_tpu_torch.nn.text import "
            "T5Embedder\n"
            "e = T5Embedder('t5-base', max_length=8, device='cpu')\n"
            "assert e._transformer is None and e._tokenizer is None\n"
            "assert str(T5Embedder().device) == 'cuda'\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('transformers', 'jax', 'flax')))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"
