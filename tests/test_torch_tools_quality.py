"""The port's quality tools on the CPU (``tools/quality_convergence_torch.py``,
``tools/eval_converged_torch.py``) and phase 34 of ``chip_smoke.py``.

Tiny presets, a few hundred synthetic rows, chunks of one epoch,
``--device cpu``: the batch plan against the port's ``PRODUCTION_BATCHES``,
the curve records and the summary against the JAX tool's records in
``quality_r5/``, a kill between a checkpoint and its curve line, the
``best.pt`` selection under the step checkpoints' pruning, and the
notebook-protocol evaluation against ``recipes.eval_task``."""
import importlib.util
import json
import os
import sys

import pytest
import torch

from moleculediffusiontransformer_tpu_torch.core.checkpoint import (
    all_checkpoint_steps, load_checkpoint)
from moleculediffusiontransformer_tpu_torch.data.qm9 import (prepare_qm9,
                                                             synthetic_qm9)
from moleculediffusiontransformer_tpu_torch.train import recipes

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))

import eval_converged_torch as ec  # noqa: E402
import quality_convergence_torch as qc  # noqa: E402

ROWS = 256


@pytest.fixture(autouse=True)
def one_thread():
    """Tiny models: torch's thread pool costs more than it gives, and
    under the suite's six workers its threads starve each other (a
    one-epoch tiny training took minutes with every core's threads)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _argv(out, tasks, epochs, *extra):
    return ["--device", "cpu", "--preset", "tiny", "--rows", str(ROWS),
            "--tasks", tasks, "--chunk-epochs", "1",
            "--max-epochs", str(epochs), "--timesteps", "3",
            "--num-generate", "2", "--num-rescore", "2", "--out", str(out),
            *extra]


def _curve(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def _run(argv, capsys=None):
    summary = qc.main(argv)
    printed = capsys.readouterr().out if capsys is not None else ""
    return summary, printed


def test_production_plan_covers_every_task():
    assert set(recipes.PRODUCTION_BATCHES) == set(recipes.TASKS)
    for task, (batch, accum) in recipes.PRODUCTION_BATCHES.items():
        assert batch % accum == 0, (task, batch, accum)
        # the reference's batches, on one card
        assert batch == (1024 if "diffusion" in task else 256), task


def test_quality_convergence_plan_in_sync():
    """The tool asserts its plan equals ``PRODUCTION_BATCHES`` at import;
    importing it is the test, and its metric keys are the JAX tool's."""
    assert {k: v[1:] for k, v in qc.TASK_PLAN.items()} \
        == recipes.PRODUCTION_BATCHES
    assert set(qc.TASK_PLAN) == set(recipes.TASKS)
    assert {k: v[0] for k, v in qc.TASK_PLAN.items()} == {
        "forward_diffusion": "r2", "inverse_diffusion": "validity_fraction",
        "inverse_transformer": "validity_fraction",
        "forward_transformer": "r2"}


def test_curve_records_and_merged_summary(tmp_path):
    """Each record has the JAX tool's keys (``quality_r5/<task>.jsonl``)
    and ``best_epoch``; a second run of another task keeps the first's
    entry in ``summary.json``, whose keys are the JAX tool's too; a run
    of another corpus is refused."""
    qc.main(_argv(tmp_path, "forward_transformer", 2))
    qc.main(_argv(tmp_path, "inverse_transformer", 1))
    with open(os.path.join(ROOT, "quality_r5", "summary.json")) as f:
        jax_summary = json.load(f)
    with open(tmp_path / "summary.json") as f:
        summary = json.load(f)
    assert set(jax_summary) <= set(summary)
    assert set(summary["tasks"]) == {"forward_transformer",
                                     "inverse_transformer"}
    jax_entry = next(iter(jax_summary["tasks"].values()))
    for task, entry in summary["tasks"].items():
        assert set(jax_entry) | {"best_epoch", "best_checkpoint"} \
            == set(entry), task
        jax_record = _curve(os.path.join(ROOT, "quality_r5",
                                         f"{task}.jsonl"))[0]
        for rec in _curve(tmp_path / f"{task}.jsonl"):
            assert set(rec) == set(jax_record) | {"best_epoch"}, rec
    assert [r["epoch"] for r in _curve(
        tmp_path / "forward_transformer.jsonl")] == [1, 2]
    with pytest.raises(ValueError, match="rows"):
        qc.main(_argv(tmp_path, "forward_transformer", 3)[:-2]
                + ["--rows", "300", "--out", str(tmp_path)])


def test_kill_between_checkpoint_and_curve_resumes_from_the_checkpoint(
        tmp_path, capsys):
    """A run killed after its checkpoint and before its curve line: the
    resumed run evaluates that checkpoint (its record's ``train_s`` null),
    labels the next chunk from ``TrainState.epoch`` and seeds it from the
    checkpoint's epochs -- the JAX tool's rule (labels and seed from the
    curve) would relabel it epoch 1 and reseed it 0.  Its curve and
    checkpoint equal an uninterrupted run's."""
    straight, killed = tmp_path / "straight", tmp_path / "killed"
    _run(_argv(straight, "inverse_diffusion", 2), capsys)
    _run(_argv(killed, "inverse_diffusion", 1), capsys)
    curve_path = killed / "inverse_diffusion.jsonl"
    dropped = _curve(curve_path)
    assert [r["epoch"] for r in dropped] == [1]
    curve_path.write_text("")
    _, printed = _run(_argv(killed, "inverse_diffusion", 2), capsys)
    assert "training epochs 2...2" in printed and "seed 1)" in printed
    assert "training epochs 1...1" not in printed
    got = _curve(curve_path)
    want = _curve(straight / "inverse_diffusion.jsonl")
    assert [r["epoch"] for r in got] == [1, 2]
    assert got[0]["train_s"] is None and want[0]["train_s"] is not None
    drop = ("train_s", "eval_s")
    for a, b in zip(got, want):
        assert {k: v for k, v in a.items() if k not in drop} == {
            k: v for k, v in b.items() if k not in drop}
    a, b = (load_checkpoint(d / "ckpts" / "inverse_diffusion" / "step_2.pt")
            for d in (straight, killed))
    assert (a["step"], a["epoch"]) == (b["step"], b["epoch"]) == (2, 2)
    for k, v in a["model"].items():
        assert torch.equal(v, b["model"][k]), k


def test_best_checkpoint_is_the_best_metric_and_survives_pruning(
        tmp_path, monkeypatch):
    """With a held-out metric that falls every epoch, ``best.pt`` stays the
    epoch-1 checkpoint (its weights those evaluated at epoch 1) after the
    step checkpoints of epochs 1 and 2 are pruned to the three newest."""
    evaluated = {}

    def falling(task, model, data, generator=None, **kw):
        epoch = len(evaluated) + 1
        evaluated[epoch] = {k: v.clone() for k, v in
                            model.state_dict().items()}
        return {"r2": 1.0 / epoch, "mae": float(epoch)}

    monkeypatch.setattr(recipes, "eval_task", falling)
    qc.main(_argv(tmp_path, "forward_transformer", 5))
    ckpts = tmp_path / "ckpts" / "forward_transformer"
    assert len(all_checkpoint_steps(str(ckpts))) == 3
    curve = _curve(tmp_path / "forward_transformer.jsonl")
    assert [r["best_epoch"] for r in curve] == [1] * 5
    best = load_checkpoint(str(ckpts / "best.pt"))
    assert best["epoch"] == 1
    for k, v in evaluated[1].items():
        assert torch.equal(best["model"][k], v), k
    assert any(not torch.equal(best["model"][k], v)
               for k, v in evaluated[5].items())


def test_eval_converged_equals_eval_task(tmp_path, monkeypatch):
    """The notebook-protocol evaluation of ``best.pt`` and of the latest
    checkpoint equals ``recipes.eval_task`` on the same checkpoint with the
    same generator; the report merges across runs; ``--serve`` serves the
    inverse diffusion ``best.pt`` through an exported sampler after
    ``reload_checkpoint``, equal to live on the same draws."""
    qc.main(_argv(tmp_path, "inverse_diffusion,forward_transformer", 2))
    plan = [("inverse_diffusion", dict(timesteps=3, num_generate=3), "n3"),
            ("forward_transformer", {}, "n256")]
    monkeypatch.setattr(ec, "PLAN", plan)
    monkeypatch.setattr(ec, "SERVE_STEPS", 3)
    monkeypatch.setattr(ec, "SERVE_ROWS", 3)
    out = tmp_path / "nb.json"
    base = ["--device", "cpu", "--preset", "tiny", "--rows", str(ROWS),
            "--ckpts", str(tmp_path / "ckpts"), "--out", str(out)]
    ec.main(base + ["--tasks", "forward_transformer"])
    report = ec.main(base + ["--tasks", "inverse_diffusion", "--serve"])
    assert set(report["checkpoints"]) == {"inverse_diffusion",
                                          "forward_transformer"}
    smiles, props = synthetic_qm9(n=ROWS, seed=0, chemically_valid=True)
    for task, kw, tag in plan:
        data = prepare_qm9(smiles, props, mode=recipes.data_mode(task))
        for which, suffix in (("checkpoints", ""),
                              ("latest_checkpoints", "_latest")):
            model = recipes.build_model(task, data.vocab_size, "tiny",
                                        device="cpu").eval()
            recipes.load_params(report[which][task], task, model)
            want = recipes.eval_task(task, model, data,
                                     qc.eval_generator(0, "cpu"), **kw)
            assert report["metrics"][f"{task}_{tag}{suffix}"] == \
                qc.scalars(want), (task, which)
    assert report["epochs"]["inverse_diffusion"]["latest"] == 2
    served = report["served"]
    assert served["same_molecules"] and served["max_abs_err"] <= 1e-5
    assert served["served"]["validity_fraction"] == \
        served["live"]["validity_fraction"]
    assert served["checkpoint"] == report["checkpoints"]["inverse_diffusion"]
    # no best.pt: refused, not the latest checkpoint under best's name
    os.remove(tmp_path / "ckpts" / "forward_transformer" / "best.pt")
    with pytest.raises(FileNotFoundError, match="no best.pt"):
        ec.main(base + ["--tasks", "forward_transformer"])


def test_tools_refuse_a_missing_card():
    """Without ``--device cpu`` the tools ask for the card and fail where
    there is none, never falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(SystemExit, match="no CUDA device"):
        qc.main(["--rows", "64", "--out", "/nonexistent"])
    with pytest.raises(SystemExit, match="no CUDA device"):
        ec.main(["--rows", "64"])


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_chip_smoke_runs_the_quality_phase(tmp_path, monkeypatch):
    """Phase 34 on the CPU at the tiny preset: its arguments parse as the
    tool's, the forward transformer and the 91M's first run, the kill and
    the resume (labels, seeds, merged summary, ``best.pt``), and the best
    checkpoint served by a sampler artifact after ``reload_checkpoint``,
    against live on the same draws (the plain versions count no launch,
    so the launch checks are replaced)."""
    from moleculediffusiontransformer_tpu_torch import design
    from moleculediffusiontransformer_tpu_torch.design import export as dx
    smoke = _smoke()
    dev = torch.device("cpu")
    argv = smoke.quality_argv(dev, "q", "inverse_diffusion", 2)
    args = qc.build_parser().parse_args(argv)
    assert (args.rows, args.preset, args.chunk_epochs, args.max_epochs,
            args.num_generate, args.device) == (2048, "notebook", 1, 2, 8,
                                                "cpu")
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(smoke, "check_launches", lambda *a, **k: None)
    smoke.QUALITY_PRESET, smoke.QUALITY_ROWS = "tiny", ROWS
    smoke.NUM_STEPS, smoke.QUALITY_GENERATE = 3, 2
    smoke.SERVE_BATCH, smoke.SERVE_PRESET = 4, "tiny"
    smoke.ROOT = str(tmp_path)
    os.makedirs(tmp_path / "moleculediffusiontransformer_tpu_torch" / "_build")
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    model = recipes.build_model("inverse_diffusion", 10, "tiny", device=dev,
                                dtype=torch.bfloat16).eval()
    path = str(tmp_path / "sampler.pt2")
    dx.save_artifact(dx.export_sampler(model, batch=4, num_steps=3,
                                       cond_scale=2.0, device=dev), path)
    sampler = design.ArtifactServer(path, device=dev)
    sampler.launches = {k: 0 for k in smoke.SERVED_COUNTS}
    launches = smoke.quality_tools(dev, sampler)
    assert set(launches) == set(smoke.counts())
    assert sampler.restored_from.endswith("best.pt")


def test_trace_events_read_the_profilers_events():
    """Phase 30's traced replays read the profiler's kineto events as they
    come (``chip_smoke.trace_events``): on the CPU the same events, names
    and times as ``prof.events()`` builds from them, and the same request
    window; ``hold_trace_reading`` (run on the card on the encoder's
    replay) passes on equal device spans and refuses a span missing from
    the kineto reading."""
    from types import SimpleNamespace

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    smoke = _smoke()
    x = torch.randn(64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("served_request"):
            for _ in range(3):
                x = torch.tanh(x @ x)
    got = list(smoke.trace_events(prof))
    want = list(smoke.function_events(prof))
    assert sorted(got) == sorted(want)
    assert not any(on_card for _, on_card, _, _ in got)
    assert smoke.device_spans(got) == smoke.device_spans(want)
    smoke.hold_trace_reading("cpu", prof, got)

    # device spans as the card's trace has them: kernels, a copy, the
    # range's own mark on the device timeline
    events = [("served_request", False, 0.0, 100.0),
              ("served_request", True, 5.0, 90.0),
              ("gemm_tc_kernel", True, 10.0, 30.0),
              ("Memcpy HtoD (Pageable -> Device)", True, 31.0, 33.0),
              ("group_norm_kernel", True, 40.0, 60.0)]
    fake = SimpleNamespace(events=lambda: [SimpleNamespace(
        name=n, time_range=SimpleNamespace(start=a, end=b),
        device_type=DeviceType.CUDA if on else DeviceType.CPU)
        for n, on, a, b in events])
    window, spans = smoke.device_spans(events)
    assert window == (0.0, 100.0) and len(spans) == 3
    smoke.hold_trace_reading("card", fake, events)
    with pytest.raises(AssertionError, match="Memcpy"):
        smoke.hold_trace_reading("card", fake, events[:3] + events[4:])
