"""Audio-lineage tour on the PyTorch port (the counterpart of
``examples/audio_diffusion.py``): Model1d v-diffusion, the diffusion
upsampler, the diffusion autoencoder, the vocoder, the upphaser, chunked AR
diffusion and the classifier-free-guided model (reference `model.py:1-392`).

Each demo builds its model with seeded weights, takes the diffusion loss and
its grads (all finite), then runs the matching sampler for 4 steps and
prints the shapes.  Tiny configurations by default; ``--full`` takes the
reference presets on 2**15-sample waveforms.  At those presets every
attention layer is at most 32 tokens long (the upsampler, autoencoder,
upphaser and conditional UNets attend at 16 to 4 tokens, the vocoder's at 8
to 2, the AR model's 8,192-sample chunk at 8 to 1), so it runs through the
Transformer1d stack kernel; the streaming-attention kernels take over only
where both lengths reach 512 (``nn.attention.sdpa``), which these presets
never do.  Two ``--full`` settings of the JAX example cannot run on its own
UNets and are changed here: the AR chunk is 8,192 samples (patch 16 x
4*4*4*2*2*2, the least length the UNet divides), not 1,024; the
autoencoder decodes at the encoder's own downsampling factor, 8,192, not
512 (which asks for 2,048 samples, again not a multiple of 8,192).

Runs on the card unless ``--device cpu``:

    python examples/audio_diffusion_torch.py [--full] [--only upsampler]
        [--device cpu]
"""
from __future__ import annotations

import argparse
import math
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch

from moleculediffusiontransformer_tpu_torch.models import audio
from moleculediffusiontransformer_tpu_torch.nn.stft import STFT

TINY = dict(channels=16, patch_size=2, multipliers=(1, 2), factors=(2,),
            num_blocks=(1,), attentions=(0, 1), attention_heads=2,
            attention_features=8, attention_multiplier=2,
            diffusion_type="v", resnet_groups=4)
FULL_LENGTH = 2 ** 15
# the least length the waveform preset's UNet divides: its AR chunk, and
# the autoencoder preset encoder's downsampling factor
PRESET_DIVISOR = 16 * 4 * 4 * 4 * 2 * 2 * 2
STEPS = 4


def banner(name: str) -> None:
    print(f"\n=== {name} " + "=" * max(0, 60 - len(name)))


def check_loss_and_grad(model, loss) -> None:
    loss.backward()
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    assert math.isfinite(loss.item()), "loss is not finite"
    assert all(torch.isfinite(g).all() for g in grads), "NaN grad"
    print(f"loss = {loss.item():.4f}  (grads finite over {len(grads)} "
          f"tensors)")
    model.zero_grad(set_to_none=True)


def _generator(device, seed=0):
    return torch.Generator(device=device).manual_seed(seed)


# ---- the models: ``build_<name>(full, device=None)`` -> (model, length) ---

def build_model(full, device=None):
    if full:
        return audio.AudioDiffusionModel(
            in_channels=2, device=device,
            generator=torch.Generator().manual_seed(0)), FULL_LENGTH
    return audio.build_model1d(device, torch.Generator().manual_seed(0),
                               in_channels=2, **TINY), 256


def build_upsampler(full, device=None):
    gen = torch.Generator().manual_seed(1)
    if full:
        return audio.AudioDiffusionUpsampler(
            in_channels=1, factor=(2,), device=device,
            generator=gen), FULL_LENGTH
    return audio.build_model1d(device, gen, audio.DiffusionUpsampler1d,
                               in_channels=1, factor=(2,),
                               context_channels=(1,), **TINY), 256


def build_autoencoder(full, device=None):
    gen = torch.Generator().manual_seed(2)
    if full:
        return audio.AudioDiffusionAE(in_channels=1, device=device,
                                      generator=gen), FULL_LENGTH
    return audio.build_model1d(
        device, gen, audio.DiffusionAE1d, in_channels=1, encoder_channels=8,
        encoder_patch_size=2, encoder_multipliers=(1, 2),
        encoder_factors=(2,), encoder_num_blocks=(1,),
        encoder_out_channels=8, encoder_inject_depth=1,
        context_channels=(0, 8), **TINY), 256


def build_vocoder(full, device=None):
    gen = torch.Generator().manual_seed(3)
    if full:
        return audio.AudioDiffusionVocoder(in_channels=1, device=device,
                                           generator=gen), FULL_LENGTH
    freq = 31 // 2 + 1
    return audio.build_model1d(
        device, gen, audio.DiffusionVocoder1d, in_channels=freq,
        context_channels=(freq,), stft_num_fft=31, stft_hop_length=8,
        **TINY), 512


def build_ar(full, device=None):
    gen = torch.Generator().manual_seed(4)
    chunk = PRESET_DIVISOR if full else 64
    kw = audio.get_default_model_kwargs() if full else TINY
    return audio.build_model1d(device, gen, audio.DiffusionAR1d,
                               in_channels=1, chunk_length=chunk,
                               upsample_factor=0, context_channels=(1,),
                               **kw), 4 * chunk


def build_upphaser(full, device=None):
    gen = torch.Generator().manual_seed(5)
    if full:
        return audio.AudioDiffusionUpphaser(in_channels=1, device=device,
                                            generator=gen), FULL_LENGTH
    return audio.build_model1d(device, gen, audio.DiffusionUpphaser1d,
                               in_channels=1, factor=(1,), stft_num_fft=15,
                               stft_hop_length=4, context_channels=(1,),
                               **TINY), 256


def build_conditional(full, device=None):
    gen = torch.Generator().manual_seed(6)
    if full:
        return audio.AudioDiffusionConditional(
            768, 64, in_channels=2, device=device,
            generator=gen), FULL_LENGTH
    return audio.build_model1d(device, gen, in_channels=2, unet_type="cfg",
                               context_embedding_features=16,
                               context_embedding_max_length=8, **TINY), 256


BUILDERS = dict(model=build_model, upsampler=build_upsampler,
                autoencoder=build_autoencoder, vocoder=build_vocoder,
                ar=build_ar, upphaser=build_upphaser,
                conditional=build_conditional)


# ---- the demos ----------------------------------------------------------

def demo_model(full, device):
    banner("AudioDiffusionModel (Model1d, v-diffusion)")
    model, length = build_model(full, device)
    gen = _generator(device)
    x = torch.randn(2, length, 2, generator=gen, device=device)
    check_loss_and_grad(model, model(x, gen))
    out = audio.sample_model1d(model.eval(), torch.randn_like(x),
                               num_steps=STEPS)
    print("sampled:", tuple(out.shape))


def demo_upsampler(full, device):
    banner("AudioDiffusionUpsampler (2x super-resolution)")
    model, length = build_upsampler(full, device)
    gen = _generator(device)
    x = torch.randn(2, length, 1, generator=gen, device=device)
    check_loss_and_grad(model, model(x, gen))
    out = audio.sample_upsampler(model.eval(), x[:, ::2], gen,
                                 num_steps=STEPS)
    print("upsampled:", tuple(x[:, ::2].shape), "->", tuple(out.shape))


def demo_autoencoder(full, device):
    banner("AudioDiffusionAE (diffusion autoencoder)")
    model, length = build_autoencoder(full, device)
    gen = _generator(device)
    x = torch.randn(2, length, 1, generator=gen, device=device)
    check_loss_and_grad(model, model(x, gen))
    model.eval()
    with torch.no_grad():
        latent = model.encode(x)
    out = audio.decode_ae(
        model, latent, gen,
        downsample_factor=model.encoder.downsample_factor, num_steps=STEPS)
    print("latent:", tuple(latent.shape), "-> decoded:", tuple(out.shape))


def demo_vocoder(full, device):
    banner("AudioDiffusionVocoder (mag -> phase -> wave)")
    model, length = build_vocoder(full, device)
    gen = _generator(device)
    wave = torch.randn(2, length, 1, generator=gen, device=device)
    stft = STFT(num_fft=model.stft.num_fft, hop_length=model.stft.hop_length)
    magnitude, phase = stft.encode(wave)                 # (b, C, F, T)
    t_pad = (-magnitude.shape[-1]) % 4 if not full else 0
    magnitude = torch.nn.functional.pad(magnitude, (0, t_pad))
    phase = torch.nn.functional.pad(phase, (0, t_pad))
    check_loss_and_grad(model, model(magnitude, phase, gen))
    out = audio.sample_vocoder(model.eval(), magnitude, gen, num_steps=STEPS)
    print("magnitude:", tuple(magnitude.shape), "-> wave:", tuple(out.shape))


def demo_ar(full, device):
    banner("DiffusionAR1d (chunked AR diffusion)")
    model, length = build_ar(full, device)
    gen = _generator(device)
    x = torch.randn(2, length, 1, generator=gen, device=device)
    check_loss_and_grad(model, model(x, gen))
    out = audio.sample_ar(model.eval(), torch.randn_like(x), gen,
                          num_steps=STEPS)
    print("AR sampled:", tuple(out.shape),
          f"(4 chunks of {model.chunk_length})")


def demo_upphaser(full, device):
    banner("AudioDiffusionUpphaser (rephase augmentation)")
    model, length = build_upphaser(full, device)
    gen = _generator(device)
    x = torch.randn(2, length, 1, generator=gen, device=device)
    check_loss_and_grad(model, model(x, gen))
    out = audio.sample_upsampler(model.eval(), x, gen, factor=1,
                                 num_steps=STEPS)
    print("rephased:", tuple(out.shape))


def demo_conditional(full, device):
    banner("AudioDiffusionConditional (CFG)")
    model, length = build_conditional(full, device)
    gen = _generator(device)
    feats = 768 if full else 16
    ctx_len = 64 if full else 8
    x = torch.randn(2, length, 2, generator=gen, device=device)
    emb = torch.randn(2, ctx_len, feats, generator=gen, device=device)
    check_loss_and_grad(model, model(x, gen, embedding=emb,
                                     embedding_mask_proba=0.1))
    out = audio.sample_model1d(model.eval(), torch.randn_like(x),
                               num_steps=STEPS, embedding=emb,
                               embedding_scale=5.0)
    print("sampled (cond_scale 5.0):", tuple(out.shape))


DEMOS = [demo_model, demo_upsampler, demo_autoencoder, demo_vocoder,
         demo_ar, demo_upphaser, demo_conditional]


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="reference preset sizes (2**15-sample waveforms)")
    ap.add_argument("--only", default=None,
                    help="substring filter on demo names")
    ap.add_argument("--device", default="cuda",
                    help="where the models run (default: the card)")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = torch.device(args.device)
    for demo in DEMOS:
        if args.only and args.only not in demo.__name__:
            continue
        demo(args.full, device)
    print("\naudio lineage: losses differentiate, samplers run.")


if __name__ == "__main__":
    main()
