"""Host-side plotting and molecule-drawing utilities (port of
`design/plots.py`; reference `generative.py:554-561,627-634,932-1019,
1740-1769`).  All optional: matplotlib (and seaborn for the joint plot) are
imported on call, RDKit renders molecules where it is installed, and
without it validity falls back to ``inverse_design.smiles_is_valid``.
Inputs may be numpy arrays, lists or tensors (read on the host).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from .inverse_design import HAS_RDKIT, smiles_is_valid


def _host(values) -> np.ndarray:
    """numpy of a sequence, an array or a tensor (on any device)."""
    if hasattr(values, "detach"):
        values = values.detach().float().cpu().numpy()
    return np.asarray(values)


def _pyplot():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def plot_loss_curve(losses: Sequence[float], path: Optional[str] = None,
                    label: str = "loss"):
    """Loss-vs-step curve (reference `generative.py:554-561`); written to
    ``path`` (returned) or returned as the figure."""
    plt = _pyplot()
    fig, ax = plt.subplots()
    ax.plot(_host(losses), label=label)
    ax.set_xlabel("step")
    ax.set_ylabel(label)
    ax.legend()
    if path:
        fig.savefig(path, dpi=120)
        plt.close(fig)
        return path
    return fig


def joint_plot(ground_truth, predictions, path: Optional[str] = None):
    """Predicted-vs-ground-truth seaborn joint plot (reference
    `generative.py:627-634`)."""
    plt = _pyplot()
    import seaborn as sns
    g = sns.jointplot(x=_host(ground_truth).ravel(),
                      y=_host(predictions).ravel(), kind="scatter")
    g.set_axis_labels("ground truth", "prediction")
    if path:
        g.figure.savefig(path, dpi=120)
        plt.close(g.figure)
        return path
    return g


def plot_results_as_barchart(target, predicted,
                             property_names: Sequence[str],
                             path: Optional[str] = None):
    """Predicted-vs-target property bars (reference
    `plot_results_as_barchart`, `generative.py:1740-1769`)."""
    plt = _pyplot()
    target = _host(target).ravel()
    predicted = _host(predicted).ravel()
    n = len(property_names)
    x = np.arange(n)
    fig, ax = plt.subplots(figsize=(max(6, n * 0.8), 4))
    ax.bar(x - 0.2, target[:n], width=0.4, label="target")
    ax.bar(x + 0.2, predicted[:n], width=0.4, label="predicted")
    ax.set_xticks(x)
    ax.set_xticklabels(property_names, rotation=45, ha="right")
    ax.legend()
    fig.tight_layout()
    if path:
        fig.savefig(path, dpi=120)
        plt.close(fig)
        return path
    return fig


def draw_and_save(smiles: str, path: Optional[str] = None) -> bool:
    """Render a molecule and return its validity (reference
    `draw_and_save`, `generative.py:947-994`: validity = RDKit parses it).
    Without RDKit only the validity is produced, no image."""
    if not HAS_RDKIT:
        return smiles_is_valid(smiles)
    from rdkit import Chem
    from rdkit.Chem import Draw
    mol = Chem.MolFromSmiles(smiles)
    if mol is None:
        return False
    if path:
        Draw.MolToFile(mol, path, size=(400, 400))
    return True


def draw_and_save_set(smiles_list: Sequence[str], prefix: str) -> List[bool]:
    """Render a set (reference `generative.py:996-1019`)."""
    return [draw_and_save(s, f"{prefix}_{i}.png" if HAS_RDKIT else None)
            for i, s in enumerate(smiles_list)]


def view_difference(smiles_a: str, smiles_b: str,
                    path: Optional[str] = None):
    """Highlight the atoms outside the maximum common substructure of two
    molecules (reference `view_difference`, `generative.py:932-945`).
    Requires RDKit."""
    if not HAS_RDKIT:
        raise ImportError("view_difference requires RDKit")
    from rdkit import Chem
    from rdkit.Chem import Draw, rdFMCS
    mol_a, mol_b = Chem.MolFromSmiles(smiles_a), Chem.MolFromSmiles(smiles_b)
    mcs = rdFMCS.FindMCS([mol_a, mol_b])
    pattern = Chem.MolFromSmarts(mcs.smartsString)
    hl_a = [i for i in range(mol_a.GetNumAtoms())
            if i not in mol_a.GetSubstructMatch(pattern)]
    hl_b = [i for i in range(mol_b.GetNumAtoms())
            if i not in mol_b.GetSubstructMatch(pattern)]
    img = Draw.MolsToGridImage([mol_a, mol_b],
                               highlightAtomLists=[hl_a, hl_b])
    if path:
        with open(path, "wb") as f:
            f.write(img.data if hasattr(img, "data") else img)
    return img
