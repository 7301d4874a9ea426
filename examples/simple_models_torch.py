"""Simple examples of basic models on the PyTorch port (the counterpart of
``examples/simple_models.py``; reference `Simple examples of basic
models.ipynb`).

The notebook's contract per model: construct with toy shapes, compute a
loss, check it differentiates (``loss.backward()``: loss and grads finite),
then sample or generate and print the output shape.  This script runs that
tour over the seven families of the JAX example -- the notebook's three
(QMDiffusion, MoleculeTransformer, MoleculeTransformerSequence) plus the
encoder, the GPT, ``Model1d`` and the graph analog -- at the JAX demos'
shapes, each model with seeded weights.

``--full`` takes the notebook's sizes (channels 64, dim 128, depth 6).  Its
QMDiffusion is the bench geometry (channels 64, max_length 64, pred_dim 16,
the 91M preset's blocks): its Transformer1d stacks run at L 16 and 4
(the ``pre_transformer`` after the first downsample), and its 64-step
sample goes through the stack kernel on the card.  Runs on the card unless
``--device cpu``:

    python examples/simple_models_torch.py [--full] [--only gpt]
        [--device cpu]
"""
from __future__ import annotations

import argparse
import math
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

SAMPLE_SEED = 3          # the QMDiffusion sample's draws


def banner(name: str) -> None:
    print(f"\n=== {name} " + "=" * max(0, 60 - len(name)))


def check_loss_and_grad(model, loss) -> float:
    """The notebook's ``loss.backward()`` check: loss finite, grads
    finite."""
    loss.backward()
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    assert math.isfinite(loss.item()), "loss is not finite"
    assert all(torch.isfinite(g).all() for g in grads), "NaN grad"
    print(f"loss = {loss.item():.4f}  (grads finite over {len(grads)} "
          f"tensors)")
    model.zero_grad(set_to_none=True)
    return loss.item()


def _seeded(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def _draws(device, seed: int = 0) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def demo_qm_diffusion(full: bool, device) -> dict:
    """Notebook cell 3: conditional CFG diffusion, loss + 64-step sample."""
    from moleculediffusiontransformer_tpu_torch.models import (QMDiffusion,
                                                               sample)
    from moleculediffusiontransformer_tpu_torch.nn.primitives import \
        init_parameters
    banner("QMDiffusion (cfg UNet diffusion)")
    if full:          # the bench geometry
        kw = dict(max_length=64, pred_dim=16, channels=64,
                  context_embedding_max_length=12, text_embed_dim=64,
                  embed_dim_position=64)
        steps = 64
    else:
        kw = dict(max_length=16, pred_dim=16, channels=16,
                  context_embedding_max_length=12, text_embed_dim=16,
                  embed_dim_position=8, multipliers=(1, 2), factors=(2,),
                  num_blocks=(1,), attentions=(1,), attention_heads=2,
                  attention_features=8, pre_transformer=1, patch_size=1)
        steps = 8
    model = QMDiffusion(**kw)
    init_parameters(model, _seeded(0))
    model = model.to(device)
    gen = _draws(device)
    sequences = torch.randn(4, 12, generator=gen, device=device)
    ids = torch.randint(0, 16, (4, kw["max_length"]), generator=gen,
                        device=device)
    output = F.one_hot(ids, 16).float() * 2 - 1
    loss = check_loss_and_grad(model, model(sequences, output, gen))
    _sync(device)
    t0 = time.perf_counter()
    out = sample(model.eval(), sequences, _draws(device, SAMPLE_SEED),
                 num_steps=steps, cond_scale=1.0)
    _sync(device)
    seconds = time.perf_counter() - t0
    print("sampled:", tuple(out.shape), "(b, max_length, pred_dim) in "
          f"{seconds:.2f} s")
    return dict(model=model, loss=loss, out=out, sequences=sequences,
                num_steps=steps, sample_seconds=seconds)


def demo_continuous_transformer(full: bool, device) -> dict:
    """Notebook cell 6: continuous vector AR decoder, MSE loss +
    vector-feedback generate."""
    from moleculediffusiontransformer_tpu_torch.models import (
        MoleculeTransformer, generate_vectors)
    banner("MoleculeTransformer (continuous AR decoder)")
    dim, depth = (128, 6) if full else (32, 2)
    model = MoleculeTransformer(dim=dim, depth=depth, logits_dim=32,
                                dim_head=16, heads=8, text_embed_dim=32,
                                max_text_len=12, pos_fourier_graph_dim=32,
                                device=device, generator=_seeded(1))
    gen = _draws(device, 1)
    sequences = torch.randn(4, 12, generator=gen, device=device)
    vectors = torch.randn(4, 24, 32, generator=gen, device=device)
    loss = check_loss_and_grad(model, model(
        sequences, vectors, return_loss=True, generator=gen))
    with torch.no_grad():
        out = generate_vectors(model.eval(), sequences,
                               tokens_to_generate=16)
    print("generated:", tuple(out.shape), "(b, tokens, logits_dim)")
    return dict(model=model, loss=loss, out=out)


def demo_sequence_transformer(full: bool, device) -> dict:
    """Notebook cell 8: token-ID AR decoder, CE loss + KV-cached
    generate from an explicit start token."""
    from moleculediffusiontransformer_tpu_torch.models import (
        MoleculeTransformerSequence, generate_sequence)
    banner("MoleculeTransformerSequence (token AR decoder)")
    dim, depth = (128, 6) if full else (32, 2)
    model = MoleculeTransformerSequence(
        dim=dim, depth=depth, logits_dim=32, dim_head=16, heads=8,
        text_embed_dim=32, max_text_len=12, device=device,
        generator=_seeded(2))
    gen = _draws(device, 2)
    sequences = torch.randn(4, 12, generator=gen, device=device)
    ids = torch.randint(0, 32, (4, 23), generator=gen, device=device)
    loss = check_loss_and_grad(model, model(
        sequences, ids, return_loss=True, generator=gen))
    start = torch.randint(0, 32, (4, 1), generator=gen, device=device)
    with torch.no_grad():
        out = generate_sequence(model.eval(), sequences, start, gen,
                                tokens_to_generate=16)
    print("generated ids:", tuple(out.shape), "(b, 1 + tokens)")
    return dict(model=model, loss=loss, out=out)


def demo_encoder(full: bool, device) -> dict:
    """Forward property-regression encoder: (b, L) ids -> (b, 1, 12)."""
    from moleculediffusiontransformer_tpu_torch.models import (
        MoleculeTransformerSequenceEncoder)
    banner("MoleculeTransformerSequenceEncoder (property regression)")
    dim, depth = (256, 6) if full else (32, 2)
    model = MoleculeTransformerSequenceEncoder(
        dim=dim, depth=depth, heads=4, logits_dim=1, logits_dim_length=12,
        max_length=16, max_tokens=24, embed_dim=16, device=device,
        generator=_seeded(3))
    gen = _draws(device, 3)
    ids = torch.randint(0, 24, (4, 16), generator=gen, device=device)
    targets = torch.randn(4, 1, 12, generator=gen, device=device)
    loss = check_loss_and_grad(model, (model(ids) - targets).square().mean())
    with torch.no_grad():
        out = model(ids)
    print("predictions:", tuple(out.shape), "(b, 1, 12)")
    return dict(model=model, loss=loss, out=out)


def demo_gpt(full: bool, device) -> dict:
    """Unconditional GPT: CE loss + KV-cached gumbel generation."""
    from moleculediffusiontransformer_tpu_torch.models import (
        MoleculeTransformerGPT, generate_gpt)
    banner("MoleculeTransformerGPT (unconditional)")
    dim, depth = (128, 6) if full else (32, 2)
    model = MoleculeTransformerGPT(dim=dim, depth=depth, logits_dim=32,
                                   max_tokens=32, dim_head=16, heads=4,
                                   embed_dim=16, device=device,
                                   generator=_seeded(4))
    gen = _draws(device, 4)
    ids = torch.randint(0, 32, (4, 23), generator=gen, device=device)
    loss = check_loss_and_grad(model, model(ids, return_loss=True))
    with torch.no_grad():
        out = generate_gpt(model.eval(), ids[:, :4], gen,
                           tokens_to_generate=12)
    print("generated ids:", tuple(out.shape))
    return dict(model=model, loss=loss, out=out)


def demo_audio_model1d(full: bool, device) -> dict:
    """Audio-lineage Model1d: v-diffusion loss + VSampler sampling."""
    from moleculediffusiontransformer_tpu_torch.diffusion.distributions \
        import UniformDistribution
    from moleculediffusiontransformer_tpu_torch.models import (
        build_model1d, sample_model1d)
    banner("Model1d (audio-lineage v-diffusion)")
    length = 4096 if full else 64
    model = build_model1d(
        device, _seeded(5), in_channels=2, diffusion_type="v",
        diffusion_sigma_distribution=UniformDistribution(),
        channels=32 if full else 16, multipliers=(1, 2), factors=(2,),
        num_blocks=(1,), attentions=(0,), patch_size=2, attention_heads=2,
        attention_features=8, attention_multiplier=2)
    gen = _draws(device, 5)
    x = torch.randn(2, length, 2, generator=gen, device=device)
    loss = check_loss_and_grad(model, model(x, gen))
    out = sample_model1d(model.eval(), torch.randn_like(x), gen, num_steps=4,
                         sampler="v", schedule="linear", clamp=True)
    print("sampled:", tuple(out.shape), "(b, length, channels)")
    return dict(model=model, loss=loss, out=out)


def demo_graph_analog(full: bool, device) -> dict:
    """Graph-analog diffusion over packed per-node xyz(+neighbors)."""
    from moleculediffusiontransformer_tpu_torch.models import (
        AnalogDiffusionSparse, build_graph_model)
    banner("AnalogDiffusionSparse (graph analog)")
    model = build_graph_model(
        AnalogDiffusionSparse, device, _seeded(6), max_length=16,
        channels=32 if full else 16, pred_dim=3, text_embed_dim=16,
        embed_dim_position=8, context_embedding_max_length=12,
        multipliers=(1, 2), factors=(2,), num_blocks=(1,), attentions=(1,),
        attention_heads=2, attention_features=8, patch_size=1,
        max_neighbors=4)
    gen = _draws(device, 6)
    seq = torch.linspace(-1, 1, 2 * 12, device=device).reshape(2, 12)
    packed = torch.randn(2, 10, 4 + 16, generator=gen, device=device)
    loss = check_loss_and_grad(model, model(seq, packed, gen))
    print("ok")
    return dict(model=model, loss=loss, out=None)


DEMOS = [demo_qm_diffusion, demo_continuous_transformer,
         demo_sequence_transformer, demo_encoder, demo_gpt,
         demo_audio_model1d, demo_graph_analog]


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--full", action="store_true",
                    help="notebook-scale configs (slower)")
    ap.add_argument("--only", default=None,
                    help="substring filter on demo names")
    ap.add_argument("--device", default="cuda",
                    help="where the models run: cuda (the default) or cpu")
    return ap


def main(argv=None) -> dict:
    """Run the tour; returns each demo's record (its model, loss and
    output) by the demo's name."""
    args = build_parser().parse_args(argv)
    from moleculediffusiontransformer_tpu_torch.cli import _device
    device = _device(args)
    records = {}
    for demo in DEMOS:
        if args.only and args.only not in demo.__name__:
            continue
        records[demo.__name__] = demo(args.full, device)
    print("\nall model families constructed, differentiated, and sampled.")
    return records


if __name__ == "__main__":
    main()
