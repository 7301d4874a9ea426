"""The port's notebooks (``notebooks/*_torch.ipynb``, written by
``tools/make_notebooks_torch.py``) and phase 35 of ``chip_smoke.py`` on the
CPU.

The tool reproduces the committed notebooks byte for byte; no code cell
imports JAX, Flax or the JAX package; each example notebook's ``ARGV``
parses with its example's parser (the card by default); the Quickstart's
code cells run in order with its one ``DEVICE`` line set to the CPU.  Phase
35 runs at tiny sizes on the CPU, where the plain versions stand in for the
kernels and count the calls the kernels would count on the card, so its
launch checks hold for real."""
import ast
import importlib
import importlib.util
import json
import os
import sys

import pytest
import torch

from moleculediffusiontransformer_tpu_torch.design import export as dx
from moleculediffusiontransformer_tpu_torch.ops import \
    transformer_fusion as tf
from moleculediffusiontransformer_tpu_torch.train import recipes

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NOTEBOOKS = os.path.join(ROOT, "notebooks")
sys.path.insert(0, os.path.join(ROOT, "examples"))
sys.path.insert(0, os.path.join(ROOT, "tools"))

import make_notebooks_torch  # noqa: E402

EXAMPLE_NOTEBOOKS = {title: module
                     for module, title, _ in make_notebooks_torch.EXAMPLES}
NAMES = sorted([*EXAMPLE_NOTEBOOKS, "Quickstart"])


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _code_cells(name):
    with open(os.path.join(NOTEBOOKS, name + "_torch.ipynb")) as f:
        cells = json.load(f)["cells"]
    return ["".join(c["source"]) for c in cells if c["cell_type"] == "code"]


def test_tool_reproduces_the_committed_notebooks(tmp_path):
    paths = make_notebooks_torch.main(["--out", str(tmp_path)])
    assert sorted(os.path.basename(p) for p in paths) == [
        n + "_torch.ipynb" for n in NAMES]
    for path in paths:
        with open(path, "rb") as a, open(os.path.join(
                NOTEBOOKS, os.path.basename(path)), "rb") as b:
            assert a.read() == b.read(), path


@pytest.mark.parametrize("name", NAMES)
def test_notebook_code_imports_no_jax(name):
    """No code cell imports jax, flax or the JAX package (by any import
    statement); the example notebooks import their port example."""
    imported = set()
    for src in _code_cells(name):
        for node in ast.walk(ast.parse(src)):
            if isinstance(node, ast.Import):
                imported.update(a.name for a in node.names)
            elif isinstance(node, ast.ImportFrom):
                imported.add(node.module)
    tops = {m.split(".")[0] for m in imported}
    assert not tops & {"jax", "jaxlib", "flax", "optax",
                       "moleculediffusiontransformer_tpu"}, imported
    if name in EXAMPLE_NOTEBOOKS:
        assert EXAMPLE_NOTEBOOKS[name] in imported


@pytest.mark.parametrize("name", sorted(EXAMPLE_NOTEBOOKS))
def test_example_notebook_argv_parses_with_its_example(name):
    """The smoke cell's ``ARGV`` (its ``DEVICE`` the card) is a valid
    command line of the example it drives."""
    module = EXAMPLE_NOTEBOOKS[name]
    cell = next(src for src in _code_cells(name) if "ARGV" in src)
    values = {}
    for node in ast.parse(cell).body:
        if isinstance(node, ast.Assign):
            target = node.targets[0].id
            if target == "DEVICE":
                values[target] = ast.literal_eval(node.value)
            elif target == "ARGV":
                values[target] = [
                    values["DEVICE"] if isinstance(e, ast.Name)
                    else ast.literal_eval(e) for e in node.value.elts]
    assert values["DEVICE"] == "cuda"
    args = importlib.import_module(module).build_parser().parse_args(
        values["ARGV"])
    assert args.device == "cuda"
    if module not in make_notebooks_torch.TOURS:
        assert args.tiny and args.epochs == 2


def test_quickstart_runs_on_the_cpu():
    """The Quickstart's code cells in order, its one ``DEVICE`` line (in
    its first code cell) set to the CPU: 20 train steps, the loss down, a
    64-step sample of 8 decoded and evaluated."""
    cells = _code_cells("Quickstart")
    card = "DEVICE = torch.device('cuda')"
    assert sum(src.count(card) for src in cells) == 1 and card in cells[0]
    ns = {}
    for i, src in enumerate(cells):
        exec(compile(src.replace(card, "DEVICE = torch.device('cpu')"),
                     f"Quickstart cell {i}", "exec"), ns)
    assert ns["state"].step == 20 and ns["loss"].item() < 81.0
    assert ns["out"].shape == (8, 16, ns["data"].vocab_size)
    report = ns["evaluate_generated"](ns["generated"], ns["data"].smiles)
    assert report["num_samples"] == 8


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def _count_plain_calls(monkeypatch):
    """Make each plain version count its call on the counter of the kernel
    it stands in for, as the kernel's wrapper counts a launch on the
    card."""
    reference = tf.transformer1d_reference

    def counted(*args, **kw):
        name = ("STASH_LAUNCHES" if kw.get("with_stash") else
                "UNIFORM_LAUNCHES" if kw.get("uniform_ctx") else "LAUNCHES")
        setattr(tf, name, getattr(tf, name) + 1)
        return reference(*args, **kw)

    monkeypatch.setattr(tf, "transformer1d_reference", counted)
    for fn, name in (("bwd_conv_out", "CONV_OUT_BWD_LAUNCHES"),
                     ("bwd_layer", "LAYER_BWD_LAUNCHES"),
                     ("bwd_conv_in_gn", "CONV_IN_GN_BWD_LAUNCHES")):
        def wrap(*args, _fn=getattr(tf, fn), _name=name, **kw):
            setattr(tf, _name, getattr(tf, _name) + 1)
            return _fn(*args, **kw)
        monkeypatch.setattr(tf, fn, wrap)


def test_chip_smoke_runs_the_examples_phase(tmp_path, monkeypatch):
    """Phase 35 on the CPU with the examples at ``--tiny`` and the tour at
    its tiny sizes, a tiny sampler standing in for phase 30's: every
    example, the bench-geometry checks (on the tour's QMDiffusion), the
    serving example and the Quickstart run, and the launch counts the phase
    works out beforehand equal the plain calls counted."""
    smoke = _smoke()
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    _count_plain_calls(monkeypatch)
    smoke.EXAMPLES_TINY, smoke.EXAMPLES_FULL = True, False
    smoke.EXAMPLES_ROWS, smoke.EXAMPLES_BATCH = 96, 32
    dev = torch.device("cpu")
    model = recipes.build_model("inverse_diffusion", 10, "tiny", device=dev,
                                dtype=torch.bfloat16).eval()
    path = str(tmp_path / "sampler.pt2")
    dx.save_artifact(dx.export_sampler(model, batch=4, num_steps=3,
                                       cond_scale=2.0, device=dev), path)
    launched = smoke.examples_and_notebooks(dev, path, str(tmp_path))
    assert set(launched) == set(smoke.counts())
    # the inverse and forward examples (5 and 3 tiny stacks, 3 passes of
    # 2 steps and the preflight) and the tour's QMDiffusion and graph
    # analog (1 pass each) at least
    assert launched["STASH_LAUNCHES"] >= 5 * 3 + 3 * 3 + 2
    assert not [p for p in os.listdir(tmp_path) if p.startswith("examples_")]
