"""The port's HTTP front end (``design/http_serve.py``) on the CPU: the cases
of the JAX package's ``tests/test_http_serve.py`` over tiny artifacts of the
port (a sampler, an inpainter, an AR generator and an encoder exported
here): health and specs, each route's answer equal to the direct
``ArtifactServer`` call with the same seed, client error codes, reload and
metrics, a bundled artifact served with nothing else, a fuzz of bodies, the
body-size limit, concurrent requests, the listen backlog, and /predict's
micro-batching (coalesced, exact, overflow split into rounds, an oversized
submit failing alone).  No JAX here: the HTTP layer adds no numerics."""
import http.client
import json
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from moleculediffusiontransformer_tpu_torch.core.checkpoint import (
    checkpoint_state, save_checkpoint)
from moleculediffusiontransformer_tpu_torch.data.qm9 import (prepare_qm9,
                                                             synthetic_qm9)
from moleculediffusiontransformer_tpu_torch.data.tokenizer import (
    add_start_end_char, one_hot_signed, pad_sequences,
    remove_start_end_token_first)
from moleculediffusiontransformer_tpu_torch.design import (ArtifactServer,
                                                           make_httpd)
from moleculediffusiontransformer_tpu_torch.design import export as dx
from moleculediffusiontransformer_tpu_torch.design.http_serve import \
    _MicroBatcher
from moleculediffusiontransformer_tpu_torch.design.inverse_design import \
    decode_one_hot
from moleculediffusiontransformer_tpu_torch.models import qm_diffusion as tqm
from moleculediffusiontransformer_tpu_torch.models import transformers as tt
from moleculediffusiontransformer_tpu_torch.nn.primitives import \
    init_parameters

QM = dict(max_length=16, channels=16, text_embed_dim=16, embed_dim_position=8,
          context_embedding_max_length=12, multipliers=(1, 2), factors=(2,),
          num_blocks=(1,), attentions=(1,), attention_heads=2,
          attention_features=8, pre_transformer=1, patch_size=1)


def _checkpoint(model, path):
    return save_checkpoint(str(path), checkpoint_state(model))


def _serve(server, data=None, **kw):
    args = () if data is None else (data.tokenizer, data.scaler, data.smiles)
    httpd = make_httpd(server, *args, port=0, quiet=True, **kw)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


def _stop(httpd):
    httpd.shutdown()
    httpd.server_close()


def _get(url):
    try:
        with urllib.request.urlopen(url) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _post(url, payload):
    body = (payload if isinstance(payload, bytes)
            else json.dumps(payload).encode())
    req = urllib.request.Request(url, body,
                                 {"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """The sampler daemon (batch 4, 4 steps), and the other artifacts."""
    tmp = tmp_path_factory.mktemp("http")
    smiles, props = synthetic_qm9(64, seed=3, chemically_valid=True)
    data = prepare_qm9(smiles, props, mode="inverse_diffusion",
                       max_length=16)
    tdata = prepare_qm9(smiles, props, mode="transformer", max_length=16)
    model = tqm.QMDiffusion(**QM, pred_dim=data.vocab_size)
    init_parameters(model, torch.Generator().manual_seed(0))
    model.eval()
    ck = _checkpoint(model, tmp / "ck.pt")
    art = dx.export_sampler(model, batch=4, num_steps=4, cond_scale=2.0,
                            device="cpu")
    path = str(tmp / "s.pt2")
    dx.save_artifact(art, path)
    server = ArtifactServer(path, ck, device="cpu")
    httpd, base = _serve(server, data)
    yield dict(base=base, server=server, data=data, tdata=tdata, tmp=tmp,
               model=model, ck=ck, art=art)
    _stop(httpd)


@pytest.fixture(scope="module")
def encoder(served):
    """A batch-4 encoder artifact at the transformer vocabulary."""
    tdata, tmp = served["tdata"], served["tmp"]
    model = tt.MoleculeTransformerSequenceEncoder(
        dim=32, depth=2, heads=4, ff_mult=2, logits_dim=1,
        logits_dim_length=12, max_length=16, max_tokens=tdata.vocab_size + 2,
        embed_dim=8, device="cpu",
        generator=torch.Generator().manual_seed(1)).eval()
    path = str(tmp / "e.pt2")
    dx.save_artifact(dx.export_encoder(model, batch=4, max_length=16,
                                       device="cpu"), path)
    return path, _checkpoint(model, tmp / "eck.pt")


def test_healthz_and_specs(served):
    base = served["base"]
    status, health = _get(base + "/healthz")
    assert status == 200
    assert health["status"] == "ok"
    assert (health["kind"], health["batch"]) == ("sampler", 4)
    assert health["restored_from"].endswith("ck.pt")
    # on the CPU the eager tier answers; no capture was tried
    assert (health["tier"], health["exec_error"]) == ("eager", None)
    status, specs = _get(base + "/specs")
    assert status == 200 and specs["kind"] == "sampler"
    assert specs["inputs"] == [{"shape": [4, 12], "dtype": "float32"}]


def test_sample_matches_direct_server_call(served):
    """Physical-unit property rows through HTTP decode to the molecules the
    server produces for the same scaled inputs and seed."""
    base, server, data = served["base"], served["server"], served["data"]
    physical = data.scaler.inverse_transform(
        np.asarray(data.y_test[:2], np.float32))
    status, out = _post(base + "/sample", {
        "properties": [[float(v) for v in row] for row in physical],
        "seed": 7})
    assert status == 200 and len(out["smiles"]) == 2
    assert 0.0 <= out["validity_fraction"] <= 1.0
    assert 0.0 <= out["novelty_fraction"] <= 1.0
    rescaled = np.asarray(data.scaler.transform(
        physical.astype(np.float32)), np.float32)
    direct = server.call_padded(rescaled[:, :12], seed=7)
    assert out["smiles"] == decode_one_hot(direct, data.tokenizer)


def test_inpaint_route_keeps_fixed_positions(served):
    data, tmp = served["data"], served["tmp"]
    path = str(tmp / "ip.pt2")
    dx.save_artifact(dx.export_inpainter(served["model"], batch=2,
                                         num_steps=4, cond_scale=2.0,
                                         device="cpu"), path)
    server = ArtifactServer(path, served["ck"], device="cpu")
    assert server.kind == "inpainter"
    httpd, base = _serve(server, data)
    try:
        draft, fixed = data.smiles[0], [0, 1]
        physical = data.scaler.inverse_transform(
            np.asarray(data.y_test[:2], np.float32))
        status, out = _post(base + "/inpaint", {
            "properties": [[float(v) for v in r] for r in physical],
            "draft": draft, "fixed": fixed, "seed": 3})
        assert status == 200 and len(out["smiles"]) == 2
        rescaled = np.asarray(data.scaler.transform(
            physical.astype(np.float32)), np.float32)
        ids = pad_sequences(data.tokenizer.texts_to_sequences([draft]), 16)
        source = np.repeat(one_hot_signed(ids, data.vocab_size), 2,
                           axis=0).astype(np.float32)
        mask = np.zeros((2, 16, data.vocab_size), bool)
        mask[:, fixed, :] = True
        direct = server.call_padded(rescaled[:, :12], source, mask, seed=3)
        assert out["smiles"] == decode_one_hot(direct, data.tokenizer)
        for s in out["smiles"]:
            assert s[:2] == draft[:2]   # frozen positions survive
        assert _post(base + "/sample",
                     {"properties": [[0.0] * 12]})[0] == 409
        assert _post(base + "/inpaint", {
            "properties": [[0.0] * 12], "draft": draft,
            "fixed": [99]})[0] == 400
    finally:
        _stop(httpd)


def test_generate_route_matches_direct_call(served):
    tdata, tmp = served["tdata"], served["tmp"]
    model = tt.MoleculeTransformerSequence(
        dim=32, depth=2, logits_dim=tdata.vocab_size, dim_head=8, heads=4,
        text_embed_dim=16, max_text_len=12, device="cpu",
        generator=torch.Generator().manual_seed(2)).eval()
    path = str(tmp / "g.pt2")
    dx.save_artifact(dx.export_generator(model, batch=2, start_len=1,
                                         tokens_to_generate=6,
                                         cond_scale=1.5, device="cpu"), path)
    server = ArtifactServer(path, _checkpoint(model, tmp / "gck.pt"),
                            device="cpu")
    assert server.kind == "generator"
    httpd, base = _serve(server, tdata)
    try:
        physical = tdata.scaler.inverse_transform(
            np.asarray(tdata.y_test[:2], np.float32))
        status, out = _post(base + "/generate", {
            "properties": [[float(v) for v in r] for r in physical],
            "seed": 11})
        assert status == 200 and len(out["smiles"]) == 2
        rescaled = np.asarray(tdata.scaler.transform(
            physical.astype(np.float32)), np.float32)
        start = np.full((2, 1), tdata.tokenizer.word_index.get("@", 1),
                        np.int64)
        ids = server.call_padded(rescaled[:, :12], start, seed=11)
        assert out["smiles"] == [remove_start_end_token_first(t)
                                 for t in tdata.tokenizer.decode(ids)]
    finally:
        _stop(httpd)


def test_predict_route_matches_direct_call(served, encoder):
    tdata = served["tdata"]
    server = ArtifactServer(*encoder, device="cpu")
    assert server.kind == "encoder"
    httpd, base = _serve(server, tdata)
    try:
        smiles = [tdata.smiles[0], tdata.smiles[1]]
        status, out = _post(base + "/predict", {"smiles": smiles})
        assert status == 200
        got = np.asarray(out["properties"], np.float32)
        assert got.shape == (2, 12)
        ids = pad_sequences(tdata.tokenizer.texts_to_sequences(
            add_start_end_char(smiles)), 16)
        logits = server.call_padded(np.asarray(ids, np.int64))
        expect = tdata.scaler.inverse_transform(
            logits.reshape(2, -1)[:, :12])
        np.testing.assert_allclose(got, np.asarray(expect, np.float32),
                                   rtol=1e-5, atol=1e-5)
        assert _post(base + "/predict", {"smiles": "CCO"})[0] == 400
        assert _post(base + "/predict", {"smiles": ["C"] * 5})[0] == 400
    finally:
        _stop(httpd)


def test_http_error_codes(served):
    base = served["base"]
    assert _get(base + "/nope")[0] == 404
    assert _post(base + "/nope", {})[0] == 404
    assert _post(base + "/sample", b"{not json")[0] == 400
    assert _post(base + "/sample", {})[0] == 400
    assert _post(base + "/sample", {"properties": [1, 2]})[0] == 400
    status, err = _post(base + "/sample", {"properties": [[0.0] * 12] * 5})
    assert status == 400 and "exceed" in err["error"]
    status, err = _post(base + "/sample", {"properties": [[0.0] * 3]})
    assert status == 400 and "12 properties" in err["error"]
    assert _post(base + "/sample",
                 {"properties": [[0.0] * 12, [0.0]]})[0] == 400
    assert _post(base + "/sample", {"properties": [["x"] * 12]})[0] == 400
    assert _post(base + "/sample", {"properties": [[0.0] * 12],
                                    "seed": "7"})[0] == 400
    assert _post(base + "/generate", {"properties": [[0.0] * 12]})[0] == 409
    assert _post(base + "/sample", b"[1,2,3]")[0] == 400


def test_reload_and_metrics(served):
    """POST /reload hot-swaps the weights (the answer changes and equals
    the direct call with the new ones); GET /metrics counts requests,
    latencies and errors."""
    base, server, data, tmp = (served["base"], served["server"],
                               served["data"], served["tmp"])
    n_sample0 = _get(base + "/metrics")[1]["routes"].get(
        "/sample", {"count": 0})["count"]
    halved = tqm.QMDiffusion(**QM, pred_dim=data.vocab_size)
    halved.load_state_dict({k: v * 0.5 for k, v in
                            served["model"].state_dict().items()})
    ck2 = _checkpoint(halved, tmp / "ck2.pt")
    physical = data.scaler.inverse_transform(
        np.asarray(data.y_test[:1], np.float32))
    body = {"properties": [[float(v) for v in physical[0]]], "seed": 2}
    rescaled = np.asarray(data.scaler.transform(physical), np.float32)
    before = server.call_padded(rescaled[:, :12], seed=2)
    try:
        status, rep = _post(base + "/reload", {"checkpoint": ck2})
        assert status == 200 and rep["restored_from"] == ck2
        assert _get(base + "/healthz")[1]["restored_from"] == ck2
        status, out = _post(base + "/sample", body)
        assert status == 200
        direct = server.call_padded(rescaled[:, :12], seed=2)
        assert not np.array_equal(direct, before)
        assert out["smiles"] == decode_one_hot(direct, data.tokenizer)
        after = _get(base + "/metrics")[1]
        assert after["routes"]["/sample"]["count"] == n_sample0 + 1
        assert after["routes"]["/reload"]["count"] >= 1
        assert after["routes"]["/sample"]["mean_ms"] > 0
        status, err = _post(base + "/reload",
                            {"checkpoint": str(tmp / "nope.pt")})
        assert status == 400 and "no checkpoint" in err["error"]
        assert _post(base + "/reload", {})[0] == 400
        assert _get(base + "/metrics")[1]["errors"] >= after["errors"] + 2
    finally:
        _post(base + "/reload", {"checkpoint": served["ck"]})


def test_bundled_artifact_serves_without_dataset(served):
    """An artifact bundled with its tokenizer, scaler and novelty corpus
    serves through ``make_httpd(server)`` alone, equal to the daemon given
    them."""
    data, tmp = served["data"], served["tmp"]
    path = str(tmp / "bundled.pt2")
    dx.save_artifact(served["art"], path, tokenizer=data.tokenizer,
                     scaler=data.scaler, training_smiles=data.smiles)
    server = ArtifactServer(path, served["ck"], device="cpu")
    httpd, base = _serve(server)
    try:
        physical = data.scaler.inverse_transform(
            np.asarray(data.y_test[:2], np.float32))
        body = {"properties": [[float(v) for v in r] for r in physical],
                "seed": 9}
        status, out = _post(base + "/sample", body)
        assert status == 200 and len(out["smiles"]) == 2
        assert out == _post(served["base"] + "/sample", body)[1]
        assert 0.0 <= out["novelty_fraction"] <= 1.0
    finally:
        _stop(httpd)


def test_http_fuzz_never_crashes(served):
    """Arbitrary JSON bodies against every POST route give a JSON answer
    with a sane status, and the daemon serves afterwards."""
    base = served["base"]
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings, strategies as st

    json_scalars = (st.none() | st.booleans() | st.integers(-9, 9)
                    | st.floats(allow_nan=False, allow_infinity=False,
                                width=32)
                    | st.text(max_size=8))
    bodies = st.recursive(
        json_scalars,
        lambda children: (st.lists(children, max_size=4)
                          | st.dictionaries(
                              st.sampled_from(["properties", "seed",
                                               "draft", "fixed", "smiles",
                                               "checkpoint", "junk"]),
                              children, max_size=4)),
        max_leaves=10)

    @settings(max_examples=40, deadline=None)
    @given(st.sampled_from(["/sample", "/generate", "/predict", "/inpaint",
                            "/reload"]), bodies)
    def check(route, body):
        status, payload = _post(base + route, body)
        assert status in (200, 400, 404, 409, 500), (route, body, status)
        assert isinstance(payload, dict)
        if status != 200:
            assert "error" in payload

    check()
    assert _get(base + "/healthz")[0] == 200


def test_oversized_body_rejected_before_buffering(served):
    host, port = served["base"].replace("http://", "").split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=10)
    try:
        conn.putrequest("POST", "/sample")
        conn.putheader("Content-Length", str(100 * 1024 * 1024))
        conn.putheader("Content-Type", "application/json")
        conn.endheaders()          # never send the body
        resp = conn.getresponse()
        assert resp.status == 413
        assert "64 MiB" in json.loads(resp.read())["error"]
    finally:
        conn.close()
    assert _get(served["base"] + "/healthz")[0] == 200


def test_concurrent_requests_serialize_on_device(served):
    base, data = served["base"], served["data"]
    physical = data.scaler.inverse_transform(
        np.asarray(data.y_test[:1], np.float32))
    row = [[float(v) for v in physical[0]]]
    with ThreadPoolExecutor(max_workers=4) as ex:
        results = list(ex.map(
            lambda seed: _post(base + "/sample", {"properties": row,
                                                  "seed": seed}),
            [5, 5, 6, 6]))
    assert all(status == 200 for status, _ in results)
    smiles = [out["smiles"] for _, out in results]
    assert smiles[0] == smiles[1] and smiles[2] == smiles[3]


def test_listen_backlog_survives_synchronized_bursts():
    class _Fake:
        kind = "sampler"
        batch = 4
        tokenizer = scaler = None
        training_smiles = ()
        specs = ()
        restored_from = None

    httpd = make_httpd(_Fake(), port=0, quiet=True)
    try:
        assert httpd.request_queue_size >= 64
    finally:
        httpd.server_close()


def _batched_daemon(served, encoder, window_ms):
    server = ArtifactServer(*encoder, device="cpu")
    return server, *_serve(server, served["tdata"],
                           batch_window_ms=window_ms)


def test_predict_dynamic_batching_coalesces_and_is_exact(served, encoder):
    """Concurrent one-molecule /predict requests ride one device call, and
    each answer equals its own uncoalesced answer bit for bit."""
    tdata = served["tdata"]
    _, httpd, base = _batched_daemon(served, encoder, 1500.0)
    try:
        mols = [tdata.smiles[i] for i in range(3)]
        solo = {}
        for m in mols:
            status, out = _post(base + "/predict", {"smiles": [m]})
            assert status == 200
            solo[m] = out["properties"]
        calls0 = _get(base + "/metrics")[1]["predict_batching"][
            "device_calls"]
        with ThreadPoolExecutor(max_workers=3) as ex:
            results = list(ex.map(
                lambda m: _post(base + "/predict", {"smiles": [m]}), mols))
        assert all(status == 200 for status, _ in results)
        for m, (_, out) in zip(mols, results):
            assert out["properties"] == solo[m]
        pb = _get(base + "/metrics")[1]["predict_batching"]
        assert pb["device_calls"] - calls0 < 3, pb
        assert pb["requests"] >= 6
    finally:
        _stop(httpd)


def test_predict_dynamic_batching_overflow_splits_rounds(served, encoder):
    """Two concurrent 3-row requests against a batch-4 artifact: two exact
    rounds, the second dispatched without a fresh window."""
    tdata = served["tdata"]
    _, httpd, base = _batched_daemon(served, encoder, 800.0)
    try:
        groups = [[tdata.smiles[i] for i in range(3)],
                  [tdata.smiles[i] for i in range(3, 6)]]
        solo = [_post(base + "/predict", {"smiles": g})[1]["properties"]
                for g in groups]
        calls0 = _get(base + "/metrics")[1]["predict_batching"][
            "device_calls"]
        t0 = time.monotonic()
        with ThreadPoolExecutor(max_workers=2) as ex:
            results = list(ex.map(
                lambda g: _post(base + "/predict", {"smiles": g}), groups))
        elapsed = time.monotonic() - t0
        assert all(status == 200 for status, _ in results)
        for g, (_, out), expect in zip(groups, results, solo):
            assert out["properties"] == expect
        calls = _get(base + "/metrics")[1]["predict_batching"]["device_calls"]
        assert calls - calls0 == 2
        assert elapsed < 3 * 0.8 + 2.0, elapsed
    finally:
        _stop(httpd)


def test_microbatcher_oversized_submit_fails_cleanly():
    def fn(rows):
        if len(rows) > 4:
            raise ValueError(f"too many rows: {len(rows)}")
        return rows * 2

    mb = _MicroBatcher(fn, max_rows=4, window_s=0.05)
    try:
        with pytest.raises(ValueError, match="too many rows: 6"):
            mb.submit(np.ones((6, 3), np.float32))
        out = mb.submit(np.ones((2, 3), np.float32))
        np.testing.assert_array_equal(out, np.full((2, 3), 2.0))
    finally:
        mb.close()
