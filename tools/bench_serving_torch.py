"""Serving-stack performance of the PyTorch/CUDA port on the card (the
port's counterpart of ``tools/bench_serving.py``).

Measures the deployment tiers against the in-process path on the SAME
model, batch and steps (the 91M inverse_diffusion notebook preset in
bfloat16, batch 512, 64-step CFG at 2.0), with both kernel switches (K8,
the shared-KV null half) off and then on where the JAX tool loops over its
``fused`` export:

  1. in-process ``design.generate_from_conditioning`` (sample + decode +
     validity/novelty), and its device-only slice (the sample alone);
  2. ``ArtifactServer`` on the exported sampler, on its CUDA-graph tier
     (and eager), the same decode on the host;
  3. the HTTP daemon's ``/sample`` at full batch;
  4. ``/sample`` latency at 16 rows with 1 and 8 concurrent clients
     (each request pays the whole fixed-batch program);
  5. ``/predict`` on the forward transformer's encoder artifact with 32
     concurrent one-row clients, micro-batching off and on (25 ms).

One flushed JSON line a measurement, each naming the card (``nvidia-smi``'s
name and power limit).  It is a tool, not the port's benchmark: it writes
nothing.  ``--smoke`` runs tiny models at batch 8, 4 steps, switches off
only (a plumbing check; its numbers mean nothing); on the CPU pass
``--device cpu``, where the server runs its eager tier.

  python tools/bench_serving_torch.py
  python tools/bench_serving_torch.py --smoke --device cpu
"""
import argparse
import json
import os
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from urllib import request as urlrequest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

COND_SCALE = 2.0
REPS = 5                 # timed calls a measurement (1 under --smoke)
_CARD = {"device": None}


def emit(metric: str, value: float, unit: str, **extra) -> None:
    print(json.dumps({"metric": metric, "value": round(value, 3),
                      "unit": unit, "device": _CARD["device"], **extra}),
          flush=True)


def post(url: str, payload: dict, timeout: float = 600.0) -> dict:
    req = urlrequest.Request(
        url, json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urlrequest.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def pctl(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(round(q * (len(xs) - 1))))]


def serve_http(server, window_ms: float = 0.0):
    """The daemon on a free localhost port, serving on a thread: (httpd,
    base URL)."""
    from moleculediffusiontransformer_tpu_torch.design.http_serve import \
        make_httpd
    httpd = make_httpd(server, port=0, quiet=True, batch_window_ms=window_ms)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


def timed(fn, sync, reps: int) -> float:
    """Mean seconds of ``fn(i)`` over ``reps`` calls after a warm-up."""
    fn(0)
    sync()
    t0 = time.perf_counter()
    for i in range(reps):
        fn(1 + i)
    sync()
    return (time.perf_counter() - t0) / reps


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--smoke", action="store_true",
                   help="tiny models, batch 8, 4 steps (plumbing only)")
    p.add_argument("--device", default="cuda",
                   help="where to serve: cuda (the default) or cpu")
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    with tempfile.TemporaryDirectory(prefix="bench_serving_") as tmp:
        bench(args, tmp)


def bench(args, tmp: str) -> None:
    """The five tiers, one JSON line a measurement; files under ``tmp``."""
    import torch

    from moleculediffusiontransformer_tpu_torch.cli import _device
    from moleculediffusiontransformer_tpu_torch.core.checkpoint import (
        checkpoint_state, save_checkpoint)
    from moleculediffusiontransformer_tpu_torch.data.qm9 import (
        prepare_qm9, synthetic_qm9)
    from moleculediffusiontransformer_tpu_torch.design import (
        ArtifactServer, decode_one_hot, evaluate_generated,
        generate_from_conditioning)
    from moleculediffusiontransformer_tpu_torch.design import export as dx
    from moleculediffusiontransformer_tpu_torch.models.qm_diffusion import \
        sample
    from moleculediffusiontransformer_tpu_torch.ops import kernel_switches
    from moleculediffusiontransformer_tpu_torch.train import recipes
    from quality_convergence_torch import card_name

    device = _device(args)
    _CARD["device"] = card_name(device)
    preset = "tiny" if args.smoke else "notebook"
    batch, steps, small = (8, 4, 2) if args.smoke else (512, 64, 16)
    # latency requests with 1 client and with 8; /predict clients, requests
    n_lat1, n_lat8, n_clients, n_reqs = ((2, 4, 4, 8) if args.smoke
                                         else (8, 32, 32, 128))
    reps = 1 if args.smoke else REPS

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    smiles, props = synthetic_qm9(512, seed=3, chemically_valid=True)
    data = prepare_qm9(smiles, props, mode="inverse_diffusion")
    model = recipes.build_model("inverse_diffusion", data.vocab_size, preset,
                                dtype=torch.bfloat16, device=device).eval()
    ckpt = save_checkpoint(os.path.join(tmp, "inverse.pt"),
                           checkpoint_state(model))
    rng = np.random.RandomState(0)
    # physical-unit property rows (generate_from_conditioning scales them)
    lo, hi = data.scaler.data_min_, data.scaler.data_max_
    props_phys = (lo + rng.rand(batch, 12) * (hi - lo)).astype(np.float32)
    props_scaled = np.asarray(data.scaler.transform(props_phys), np.float32)
    y_scaled = torch.as_tensor(props_scaled, device=device)
    server = None
    # the smoke run exports once, switches off (as the JAX tool's
    # smoke skips its fused export)
    for on in (False,) if args.smoke else (False, True):
        with kernel_switches(on):
            sfx = "_switches_on" if on else ""

            # ---- 1. in-process baseline ----------------------------------
            def inproc(seed):
                return generate_from_conditioning(
                    model, props_phys, data.tokenizer,
                    torch.Generator(device=device).manual_seed(seed),
                    scaler=data.scaler, training_smiles=data.smiles,
                    cond_scale=COND_SCALE, timesteps=steps)

            dt_inproc = timed(inproc, sync, reps)
            emit("serving_inprocess_generate" + sfx, batch / dt_inproc,
                 "molecules/s", switches=on)

            def dev_only(seed):
                sample(model, y_scaled,
                       torch.Generator(device=device).manual_seed(seed),
                       num_steps=steps, cond_scale=COND_SCALE).cpu()

            dt_dev = timed(dev_only, sync, reps)
            emit("serving_inprocess_device_only" + sfx, batch / dt_dev,
                 "molecules/s", switches=on,
                 host_decode_ms=round((dt_inproc - dt_dev) * 1e3, 1))

            # ---- 2. ArtifactServer ---------------------------------------
            path = os.path.join(tmp, f"sampler_{int(on)}.pt2")
            dx.save_artifact(dx.export_sampler(
                model, batch=batch, num_steps=steps, cond_scale=COND_SCALE,
                device=device), path, tokenizer=data.tokenizer,
                scaler=data.scaler, training_smiles=data.smiles)
            server = ArtifactServer(path, ckpt, device=device)
            for eager in ((False, True) if server.tier == "graph"
                          else (True,)):
                def prog_only(seed):
                    return server.call(props_scaled, seed=seed, eager=eager)

                def art_call(seed):
                    out = prog_only(seed)
                    return evaluate_generated(
                        decode_one_hot(out, data.tokenizer), data.smiles)

                dt_prog = timed(lambda s: prog_only(s).cpu(), sync, reps)
                dt_art = timed(art_call, sync, reps)
                tier = "eager" if eager else "graph"
                emit(f"serving_artifact_server_{tier}{sfx}", batch / dt_art,
                     "molecules/s", switches=on,
                     overhead_vs_inprocess=round(dt_art / dt_inproc - 1, 4),
                     program_only_mol_s=round(batch / dt_prog, 1),
                     program_overhead_vs_device=round(
                         dt_prog / dt_dev - 1, 4),
                     startup=server.startup)

    # ---- 3/4. HTTP daemon on the switches-on server ----------------------
    httpd, base = serve_http(server)
    body_full = {"properties": props_phys.tolist(), "seed": 1}
    dt_http = timed(lambda s: post(base + "/sample",
                                   dict(body_full, seed=2 + s)), sync, reps)
    emit("serving_http_sample_fullbatch", batch / dt_http, "molecules/s",
         overhead_vs_inprocess=round(dt_http / dt_inproc - 1, 4),
         tier=server.tier)

    body_small = {"properties": body_full["properties"][:small], "seed": 5}

    def timed_req(seed):
        t0 = time.perf_counter()
        post(base + "/sample", dict(body_small, seed=seed))
        return (time.perf_counter() - t0) * 1000.0

    lat1 = [timed_req(10 + i) for i in range(n_lat1)]
    emit("serving_http_sample_latency_1client", pctl(lat1, 0.5), "ms_p50",
         p99_ms=round(pctl(lat1, 0.99), 1), rows_per_request=small)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(8) as ex:
        lat8 = list(ex.map(timed_req, range(100, 100 + n_lat8)))
    wall8 = time.perf_counter() - t0
    emit("serving_http_sample_latency_8clients", pctl(lat8, 0.5), "ms_p50",
         p99_ms=round(pctl(lat8, 0.99), 1), rows_per_request=small,
         aggregate_requests_per_s=round(len(lat8) / wall8, 2))
    httpd.shutdown()
    httpd.server_close()

    # ---- 5. /predict micro-batching A/B ----------------------------------
    tdata = prepare_qm9(smiles, props, mode="transformer")
    enc = recipes.build_model("forward_transformer", tdata.vocab_size,
                              preset, dtype=torch.bfloat16,
                              device=device).eval()
    enc_path = os.path.join(tmp, "encoder.pt2")
    dx.save_artifact(dx.export_encoder(enc, batch=batch, device=device),
                     enc_path, tokenizer=tdata.tokenizer,
                     scaler=tdata.scaler)
    enc_ckpt = save_checkpoint(os.path.join(tmp, "encoder.pt"),
                               checkpoint_state(enc))
    smi = [s for s in tdata.smiles if s][:1] or ["CCO"]
    for window_ms in (0.0, 25.0):
        srv = ArtifactServer(enc_path, enc_ckpt, device=device)
        httpd, base = serve_http(srv, window_ms)
        url = base + "/predict"
        post(url, {"smiles": smi})  # warm-up

        def one(_):
            t0 = time.perf_counter()
            post(url, {"smiles": smi})
            return time.perf_counter() - t0

        t0 = time.perf_counter()
        with ThreadPoolExecutor(n_clients) as ex:
            lats = list(ex.map(one, range(n_reqs)))
        wall = time.perf_counter() - t0
        emit("serving_http_predict_dynbatch_" +
             ("on" if window_ms else "off"), n_reqs / wall, "requests/s",
             p50_ms=round(pctl(lats, 0.5) * 1000, 1),
             p99_ms=round(pctl(lats, 0.99) * 1000, 1),
             window_ms=window_ms, concurrent_clients=n_clients,
             tier=srv.tier)
        httpd.shutdown()
        httpd.server_close()


if __name__ == "__main__":
    main()
