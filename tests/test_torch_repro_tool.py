"""The port's baseline, checkpoint-import, export and serving-bench tools on
the CPU (``tools/reproduce_baseline_torch.py``,
``tools/import_torch_checkpoint_torch.py``,
``tools/export_serving_artifact_torch.py``,
``tools/bench_serving_torch.py``), at tiny presets with ``--device cpu``."""
import hashlib
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moleculediffusiontransformer_tpu.core.config import \
    forward_transformer_qm9
from moleculediffusiontransformer_tpu.data.qm9 import \
    verify_qm9_csv as jax_verify_qm9_csv
from moleculediffusiontransformer_tpu.train import recipes as jax_recipes
from moleculediffusiontransformer_tpu_torch.data.qm9 import (PROPERTY_NAMES,
                                                             synthetic_qm9)
from moleculediffusiontransformer_tpu_torch.design import export as dx
from moleculediffusiontransformer_tpu_torch.nn.jax_import import \
    state_dict_from_jax_params
from moleculediffusiontransformer_tpu_torch.train import recipes

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))

import bench_serving_torch  # noqa: E402
import export_serving_artifact_torch as export_tool  # noqa: E402
import import_torch_checkpoint_torch as import_tool  # noqa: E402
import reproduce_baseline_torch as repro  # noqa: E402

METRICS = ("forward_diffusion_r2", "inverse_diffusion_validity",
           "inverse_diffusion_novelty", "inverse_transformer_validity",
           "inverse_transformer_novelty", "forward_transformer_r2")
SMALL = ["--device", "cpu", "--train-epochs", "1", "--train-batch", "32",
         "--timesteps", "4", "--num-rescore", "2", "--num-generate", "2"]

@pytest.fixture(autouse=True)
def one_thread():
    """Tiny models: torch's thread pool costs more than it gives, and
    under the suite's six workers its threads starve each other (a
    one-epoch tiny training took minutes with every core's threads)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)



def _write_qm9_like_csv(path, n=8):
    smiles, props = synthetic_qm9(n, seed=3)
    with open(path, "w") as f:
        f.write("smiles," + ",".join(PROPERTY_NAMES) + "\n")
        for s, row in zip(smiles, props):
            f.write(s + "," + ",".join(f"{v:.6f}" for v in row) + "\n")


def test_train_epochs_mode(tmp_path):
    """The no-checkpoint fallback trains all four models in-process (tiny
    preset, 40 rows: one step of 32 each) and reports every BASELINE.md
    metric key, finite."""
    out = tmp_path / "repro.json"
    results = repro.main(["--rows", "40", "--out", str(out), *SMALL])
    assert json.loads(out.read_text()) == json.loads(json.dumps(
        results, default=float))
    assert results["training"]["epochs"] == 1
    assert results["training"]["preset"] == "tiny"
    for name in repro.MODELS:
        assert "trained in-process" in results["checkpoints"][name], name
    for metric in METRICS:
        assert np.isfinite(results["metrics"][metric]), metric


def test_csv_run_records_the_verification(tmp_path):
    """``--csv`` stamps the report with ``verify_qm9_csv``'s record: the
    expectations of the JAX package's own test (``test_repro_tool.py``)
    and the JAX package's record of the same file, key for key."""
    csv_path = str(tmp_path / "qm9_.csv")
    _write_qm9_like_csv(csv_path, n=64)
    out = tmp_path / "repro.json"
    results = repro.main(["--csv", csv_path, "--out", str(out), *SMALL])
    v = results["dataset_verification"]
    assert v["header_ok"] and v["rows"] == 64 and len(v["sha256"]) == 64
    assert v["row_count_ok"] is False and v["checksum_ok"] is None
    assert v["sha256"] == hashlib.sha256(
        open(csv_path, "rb").read()).hexdigest()
    assert v == jax_verify_qm9_csv(csv_path)
    assert results["dataset"] == os.path.abspath(csv_path)
    with pytest.raises(ValueError, match="sha256"):
        repro.main(["--csv", csv_path, "--expect-sha256", "0" * 64,
                    "--out", str(out), *SMALL])


def test_checkpoint_dir_reads_reference_state_dicts(tmp_path):
    """A ``{task}.pt`` state dict in ``--checkpoint-dir`` is read by
    ``recipes.load_params`` at the notebook preset (here the forward
    transformer's; the other three train at the tiny preset)."""
    from moleculediffusiontransformer_tpu_torch.data.qm9 import prepare_qm9
    vocab = prepare_qm9(*synthetic_qm9(96, seed=0, chemically_valid=True),
                        mode="transformer").vocab_size
    data_model = recipes.build_model("forward_transformer", vocab,
                                     "notebook", device="cpu", seed=5)
    ckpts = tmp_path / "ckpts"
    ckpts.mkdir()
    torch.save(data_model.state_dict(), ckpts / "forward_transformer.pt")
    results = repro.main(["--rows", "96", "--checkpoint-dir", str(ckpts),
                          "--out", str(tmp_path / "r.json"), *SMALL])
    assert results["checkpoints"]["forward_transformer"] == str(
        ckpts / "forward_transformer.pt")


def test_import_torch_checkpoint_matches_jax(tmp_path):
    """A state dict made from JAX params (``nn/jax_import.py``) becomes a
    port checkpoint whose model, loaded ``strict=True``, gives the JAX
    model's output on the same ids within 1e-4."""
    vocab = forward_transformer_qm9().max_tokens
    jm = jax_recipes.build_model("forward_transformer", vocab, "tiny")
    rng = np.random.default_rng(0)
    ids = rng.integers(1, vocab, (4, 64))
    ids[1, 30:] = 0
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.asarray(ids))["params"]
    params = jax.tree_util.tree_map(
        lambda s: (0.2 * rng.standard_normal(s.shape)).astype(np.float32),
        shapes)
    src = tmp_path / "reference.pt"
    torch.save(state_dict_from_jax_params(params), src)
    out = tmp_path / "port.pt"
    import_tool.main([str(src), str(out), "--model", "forward_transformer",
                      "--vocab", str(vocab), "--preset", "tiny",
                      "--device", "cpu"])
    model = recipes.build_model("forward_transformer", vocab, "tiny",
                                device="cpu").eval()
    recipes.load_params(str(out), "forward_transformer", model)
    want = np.asarray(jax.jit(jm.apply)({"params": params},
                                        jnp.asarray(ids)))
    with torch.no_grad():
        got = model(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("task,kind", [
    ("inverse_diffusion", "sampler"), ("inverse_transformer", "generator"),
    ("forward_transformer", "encoder")])
def test_export_serving_artifact(tmp_path, task, kind):
    """The three kinds export on the CPU; ``--fused`` (both kernel switches
    on) and ``--mesh-devices`` take the diffusion sampler only, and
    ``--platforms`` is refused by name."""
    path = str(tmp_path / "a.pt2")
    out = export_tool.main([path, "--model", task, "--preset", "tiny",
                            "--device", "cpu", "--batch", "2", "--steps",
                            "2", "--tokens", "3"])
    program, header = dx.load_bundle(path)
    assert (out["kind"], header["kind"], header["device"], header["task"]) \
        == (kind, kind, "cpu", task)
    assert header["inputs"][0]["shape"][0] == 2
    with pytest.raises(SystemExit):
        export_tool.main([path, "--model", task, "--preset", "tiny",
                          "--device", "cpu", "--platforms", "tpu,cpu"])
    if kind != "sampler":
        with pytest.raises(SystemExit):
            export_tool.main([path, "--model", task, "--device", "cpu",
                              "--fused"])


def test_export_fused_sampler_runs_the_switches(tmp_path):
    """``--fused`` exports the resnet-run kernel's operator into the
    program and leaves both switches as they were; ``--mesh-devices 2``
    outside a group of two is refused with how to run it."""
    from moleculediffusiontransformer_tpu_torch.ops import resnet_fusion as rf
    from moleculediffusiontransformer_tpu_torch.ops import \
        transformer_fusion as tf
    path = str(tmp_path / "f.pt2")
    before = (rf.resnet_fusion_enabled(), tf._SHAREDKV)
    export_tool.main([path, "--preset", "tiny", "--device", "cpu",
                      "--batch", "2", "--steps", "2", "--fused"])
    assert (rf.resnet_fusion_enabled(), tf._SHAREDKV) == before
    program, header = dx.load_bundle(path)
    ops = {str(n.target) for n in program.graph.nodes
           if n.op == "call_function"}
    assert "mdt_torch.resnet_run.default" in ops and header["fused"]
    with pytest.raises(SystemExit, match="torchrun --nproc-per-node 2"):
        export_tool.main([path, "--preset", "tiny", "--device", "cpu",
                          "--batch", "2", "--mesh-devices", "2"])


def test_kernel_switches_set_both_and_put_them_back():
    """``ops.kernel_switches``, which the export's ``--fused`` and the
    serving bench use: both switches on (or off) inside the block, and as
    they were after it, also when the block raises."""
    from moleculediffusiontransformer_tpu_torch.ops import (kernel_switches,
                                                            resnet_fusion)
    from moleculediffusiontransformer_tpu_torch.ops import \
        transformer_fusion as tf
    before = (resnet_fusion.resnet_fusion_enabled(), tf._SHAREDKV)
    for on in (True, False):
        with pytest.raises(RuntimeError):
            with kernel_switches(on):
                assert resnet_fusion.resnet_fusion_enabled() is on
                assert tf._sharedkv_opt_in() is on
                raise RuntimeError
        assert (resnet_fusion.resnet_fusion_enabled(), tf._SHAREDKV) \
            == before


def test_bench_serving_smoke(capsys):
    """``--smoke --device cpu`` prints one JSON line a measurement of the
    five tiers (switches off), each naming the device."""
    bench_serving_torch.main(["--smoke", "--device", "cpu"])
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()
             if line.startswith("{")]
    metrics = {r["metric"] for r in lines}
    for name in ("serving_inprocess_generate",
                 "serving_inprocess_device_only",
                 "serving_artifact_server_eager",
                 "serving_http_sample_fullbatch",
                 "serving_http_sample_latency_1client",
                 "serving_http_sample_latency_8clients",
                 "serving_http_predict_dynbatch_off",
                 "serving_http_predict_dynbatch_on"):
        assert name in metrics, name
    assert all(r["device"] == "cpu" and np.isfinite(r["value"])
               for r in lines)
