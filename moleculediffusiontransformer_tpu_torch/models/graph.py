"""Graph-analog diffusion models (port of `models/graph.py`; reference
`graphmodel.py:225-598`): conditional diffusion over packed per-node tensors,
channels-last (b, L, 4 + neighbour rows): column 0 the node number (unused),
columns 1:4 the xyz coordinates, then the neighbour features (Sparse:
``max_neighbors`` columns; Full: a ``max_length`` adjacency block).

Both are ``QMDiffusionBase`` (a CFG UNet under the K-diffusion objective,
conditioned on (b, n) scalars): they train through
``train.trainer.make_diffusion_train_step``, the packed tensor as the
target, and sample through ``models.qm_diffusion.sample`` at
(b, max_length, pred_dim).

Recorded deviation, the JAX package's: the reference's
``AnalogDiffusionSparse.forward`` reads a free global ``max_neighbors``
(`graphmodel.py:320`), so every reference Sparse forward raises NameError
unless the caller injects it; here it is an explicit field.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from ..nn.primitives import init_parameters, seeded_build
from .qm_diffusion import QMDiffusionBase


def _pad_length(x: torch.Tensor, max_length: int) -> torch.Tensor:
    """Zero-pad or truncate the length axis of (b, L, C) to
    ``max_length`` (reference `graphmodel.py:220-223`)."""
    if x.shape[1] >= max_length:
        return x[:, :max_length]
    return F.pad(x, (0, 0, 0, max_length - x.shape[1]))


class AnalogDiffusionSparse(QMDiffusionBase):
    """Sparse-neighbour variant (reference `graphmodel.py:225-389`): patch
    8, num_blocks (2, 2), attentions (1, 1); the diffusion target is the
    xyz, padded to ``max_length``, and with ``predict_neighbors`` the
    ``max_neighbors`` neighbour columns too, so ``pred_dim`` is 3 (+
    ``max_neighbors``)."""

    def __init__(self, *, patch_size: int = 8,
                 num_blocks: Sequence[int] = (2, 2),
                 attentions: Sequence[int] = (1, 1), pre_transformer: int = 0,
                 predict_neighbors: bool = False, max_neighbors: int = 12,
                 **kwargs):
        super().__init__(patch_size=patch_size, num_blocks=num_blocks,
                         attentions=attentions,
                         pre_transformer=pre_transformer, **kwargs)
        self.predict_neighbors = predict_neighbors
        self.max_neighbors = max_neighbors

    def pack_target(self, output: torch.Tensor) -> torch.Tensor:
        """(b, L, 4 + neighbours) packed input -> the diffusion target."""
        xyz = _pad_length(output[..., 1:4], self.max_length)
        if not self.predict_neighbors:
            return xyz
        neigh = _pad_length(output[..., 4:4 + self.max_neighbors],
                            self.max_length)
        return torch.cat([xyz, neigh], dim=-1)

    def diffusion_target(self, output: torch.Tensor) -> torch.Tensor:
        return self.pack_target(output)

    def forward(self, sequences: torch.Tensor, output: torch.Tensor,
                generator: Optional[torch.Generator] = None, *,
                sigmas: Optional[torch.Tensor] = None,
                noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Training loss of the packed ``output``; the noise (handed in or
        drawn) is shaped like the target, not the packed input."""
        return super().forward(sequences, self.pack_target(output),
                               generator, sigmas=sigmas, noise=noise)


class AnalogDiffusionFull(AnalogDiffusionSparse):
    """Full-adjacency variant (reference `graphmodel.py:391-598`): the CFG
    branch's patch 4 and num_blocks (3, 3); the neighbour block spans
    ``max_length`` columns, so ``pred_dim`` is 3 + ``max_length``.  Unlike
    Sparse, the length axis is not padded (reference
    `graphmodel.py:497-513`): the caller supplies inputs the UNet
    divides."""

    def __init__(self, *, patch_size: int = 4,
                 num_blocks: Sequence[int] = (3, 3),
                 predict_neighbors: bool = True, **kwargs):
        super().__init__(patch_size=patch_size, num_blocks=num_blocks,
                         predict_neighbors=predict_neighbors, **kwargs)

    def pack_target(self, output: torch.Tensor) -> torch.Tensor:
        xyz = output[..., 1:4]
        if not self.predict_neighbors:
            return xyz
        return torch.cat([xyz, output[..., 4:4 + self.max_length]], dim=-1)


def build_graph_model(cls: type, device=None,
                      generator: Optional[torch.Generator] = None,
                      **kwargs) -> AnalogDiffusionSparse:
    """``cls(**kwargs)`` (``AnalogDiffusionSparse`` or ``...Full``) on
    ``device`` -- the card ("cuda") unless the caller names another -- its
    parameters drawn from ``generator`` (a CPU generator; torch's global RNG
    when None)."""
    with seeded_build(generator):
        model = cls(**kwargs)
    if generator is not None:
        init_parameters(model, generator)
    return model.to("cuda" if device is None else device)
