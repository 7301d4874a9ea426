"""The port's command line (``python -m moleculediffusiontransformer_tpu_torch``,
in-process) on the CPU: ``train`` then ``eval``, ``sample``, ``inpaint`` or
``predict`` from its checkpoint, for each task at ``--preset tiny --device
cpu``, with a resume; a JAX-made checkpoint crossing through the JAX CLI's
``export-torch`` gives the JAX ``predict``'s numbers through the port's
within 1e-4; without ``--device cpu`` on a host with no card every
subcommand fails instead of running on the CPU."""
import json

import jax
import numpy as np
import pytest
import torch

from moleculediffusiontransformer_tpu import cli as jax_cli
from moleculediffusiontransformer_tpu.core.checkpoint import \
    save_checkpoint as jax_save_checkpoint
from moleculediffusiontransformer_tpu.train import recipes as jax_recipes
from moleculediffusiontransformer_tpu_torch import cli
from moleculediffusiontransformer_tpu_torch.core.checkpoint import \
    latest_checkpoint
from moleculediffusiontransformer_tpu_torch.train import recipes

ROWS = "96"
TINY = ["--preset", "tiny", "--device", "cpu", "--rows", ROWS]


def run(capsys, argv):
    payload = cli.main(argv)
    out = json.loads(capsys.readouterr().out)
    assert out == json.loads(json.dumps(payload, default=float))
    return out


def _train(capsys, task, directory, *extra):
    return run(capsys, ["train", "--task", task, *TINY, "--epochs", "1",
                        "--batch-size", "32", "--num-eval", "2",
                        "--timesteps", "4", "--print-loss-every", "1",
                        "--checkpoint-dir", directory, *extra])


@pytest.mark.parametrize("task", recipes.TASKS)
def test_train_then_use_the_checkpoint(tmp_path, capsys, task):
    directory = str(tmp_path / task)
    out = _train(capsys, task, directory)
    steps = (int(ROWS) * 9 // 10) // 32
    assert (out["task"], out["preset"], out["step"]) == (task, "tiny", steps)
    assert len(out["losses"]) == steps and np.isfinite(out["losses"]).all()
    ckpt = latest_checkpoint(directory)
    assert ckpt.endswith(f"step_{steps}.pt")
    use = ["--task", task, *TINY, "--checkpoint", ckpt]

    out = run(capsys, ["eval", *use, "--num-eval", "2", "--timesteps", "4"])
    assert out["checkpoint"] == ckpt
    assert ("r2" in out) == task.startswith("forward")
    assert ("validity_fraction" in out) == task.startswith("inverse")
    if task == "inverse_diffusion":
        out = run(capsys, ["sample", *use, "--num", "2", "--timesteps", "4"])
        assert len(out["smiles"]) == 2
        out = run(capsys, ["inpaint", "CCO", "--fixed", "0", "1", *TINY,
                           "--checkpoint", ckpt, "--num", "2",
                           "--timesteps", "4"])
        assert out["draft"] == "CCO" and len(out["smiles"]) == 2
        assert all(s.startswith("CC") for s in out["smiles"])
        # resume: one more epoch from the checkpoint
        out = _train(capsys, task, directory, "--resume")
        assert out["step"] == 2 * steps
    elif task == "inverse_transformer":
        out = run(capsys, ["sample", *use, "--num", "2", "--tokens", "8"])
        assert len(out["smiles"]) == 2
        out = run(capsys, ["sample", *use, "--tokens", "8", "--properties",
                           ",".join(["1.0"] * 12)])
        assert len(out["smiles"]) == 1
    else:
        smiles = ["CCO", "C1CC1"]
        trained = run(capsys, ["predict", *use, "--timesteps", "4", *smiles])
        fresh = run(capsys, ["predict", "--task", task, *TINY,
                             "--timesteps", "4", *smiles])
        assert set(trained["predictions"]) == set(smiles)
        assert len(trained["predictions"]["CCO"]) == 12
        assert trained["predictions"] != fresh["predictions"]


@pytest.mark.parametrize("suffix", [".npz", ".pt"])
def test_jax_checkpoint_crosses_through_export_torch(tmp_path, capsys,
                                                     suffix):
    """A forward-transformer checkpoint made by the JAX package, converted
    by its ``export-torch``, predicts through the port's CLI what the JAX
    CLI's ``predict`` predicts from the msgpack file."""
    task = "forward_transformer"
    data = jax_cli._dataset(jax_cli.build_parser().parse_args(
        ["predict", "--task", task, "--rows", ROWS, "C"]), "transformer")
    model = jax_recipes.build_model(task, data.vocab_size, "tiny")
    args, kwargs = jax_recipes.init_example(task, model)
    params = jax.jit(model.init)(jax.random.PRNGKey(7), *args,
                                 **kwargs)["params"]
    msgpack = str(tmp_path / "encoder.msgpack")
    jax_save_checkpoint(msgpack, {"params": params})
    exported = str(tmp_path / f"encoder{suffix}")
    jax_cli.main(["export-torch", "--checkpoint", msgpack, "--out",
                  exported])
    smiles = ["CCO", "C1CC1", "CC(=O)N"]
    capsys.readouterr()
    jax_cli.main(["predict", "--task", task, "--preset", "tiny", "--rows",
                  ROWS, "--checkpoint", msgpack, *smiles])
    want = json.loads(capsys.readouterr().out)["predictions"]
    got = run(capsys, ["predict", "--task", task, *TINY, "--checkpoint",
                       exported, *smiles])["predictions"]
    for s in smiles:
        np.testing.assert_allclose(got[s], want[s], rtol=1e-4, atol=1e-4,
                                   err_msg=s)
    with pytest.raises(ValueError, match="export-torch"):
        recipes.load_params(msgpack, task, recipes.build_model(
            task, data.vocab_size, "tiny", device="cpu"))


@pytest.mark.parametrize("argv", [
    ["train", "--task", "inverse_diffusion", "--preset", "tiny"],
    ["eval", "--task", "forward_transformer", "--preset", "tiny"],
    ["sample", "--task", "inverse_transformer", "--preset", "tiny"],
    ["inpaint", "CCO", "--fixed", "0", "--preset", "tiny"],
    ["predict", "--task", "forward_diffusion", "--preset", "tiny", "CCO"]])
def test_without_a_card_the_default_device_fails(argv, capsys):
    """The default device is the card: on a host without one a subcommand
    exits with an error instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device runs")
    with pytest.raises(SystemExit) as exc:
        cli.main(argv + ["--rows", ROWS])
    assert "--device cpu" in str(exc.value.code)
    assert capsys.readouterr().out == ""


def test_info_builds_nothing(capsys):
    out = run(capsys, ["info"])
    for key in ("version", "backend", "devices", "device_count",
                "fusion_default", "flash_attention", "torch", "cuda",
                "nvidia_smi", "resnet_fusion", "sharedkv"):
        assert key in out
    assert set(out["kernels_built"]) == {
        "transformer1d_fwd.cu", "transformer1d_bwd.cu", "resnet_fwd.cu",
        "flash_attention.cu", "flash_attention_bwd.cu", "attention.cu"}
    assert out["resnet_fusion"] is False and out["sharedkv"] is False
