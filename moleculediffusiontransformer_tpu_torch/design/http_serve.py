"""Zero-dependency HTTP front end over ``ArtifactServer`` (port of
`design/http_serve.py`, its stdlib parts kept as the port's own copy).

A stdlib ``http.server`` daemon that turns one exported artifact + checkpoint
+ tokenizer vocabulary into a JSON inference service -- the deployment
analog of the reference's notebook-resident sampling loops
(`generative.py:1662-1738` / `:1775-1860` / `:1864-1913`), with no model
code and no framework server dependency.

Routes (JSON in/out; property vectors in PHYSICAL units when a scaler
is configured):

  GET  /healthz    {"status": "ok", kind, batch, restored_from, tier,
                   exec_error}: ``tier`` is ``"graph"`` (the captured CUDA
                   graph) or ``"eager"``
  GET  /specs      the artifact's input shapes/dtypes
  POST /sample     sampler artifacts:   {"properties": [[...]], "seed"}
                   -> {"smiles", "validity_fraction", "novelty_fraction"}
  POST /generate   generator artifacts: same request -> same response
  POST /predict    encoder artifacts:   {"smiles": ["CCO", ...]}
                   -> {"properties": [[...12 floats...], ...]}
  POST /inpaint    inpainter artifacts: {"properties", "draft": "CCO",
                   "fixed": [0, 2], "seed"} -- RePaint constrained design:
                   keep the draft's characters at the fixed positions,
                   regenerate the rest (reference `generative.py:1574-1660`)
  GET  /metrics    request/error counters + per-route latency (ms)
  POST /reload     {"checkpoint": path} -- hot-swap the weights from a new
                   checkpoint without exporting again (the program takes
                   them as call arguments)

A request's ``seed`` seeds the ``torch.Generator`` the server draws the
request's noise from.  Run it via ``python -m
moleculediffusiontransformer_tpu_torch serve art.pt2 --http 8000`` or
programmatically:

    httpd = make_httpd(server, tokenizer, scaler, smiles, port=8000)
    httpd.serve_forever()
"""
from __future__ import annotations

import json
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Sequence

import numpy as np

from .serve import ArtifactServer


class ServingError(ValueError):
    """Client error -> HTTP 400/409."""

    def __init__(self, message: str, status: int = 400):
        super().__init__(message)
        self.status = status


class _Metrics:
    """Per-route request/error counters and latency aggregates."""

    def __init__(self):
        import threading
        self._lock = threading.Lock()
        self._routes: dict = {}
        self.errors = 0

    def record(self, route: str, seconds: float, ok: bool) -> None:
        with self._lock:
            r = self._routes.setdefault(
                route, {"count": 0, "total_ms": 0.0, "last_ms": 0.0})
            r["count"] += 1
            r["total_ms"] += seconds * 1e3
            r["last_ms"] = round(seconds * 1e3, 3)
            if not ok:
                self.errors += 1

    def snapshot(self) -> dict:
        with self._lock:
            routes = {
                route: {"count": r["count"], "last_ms": r["last_ms"],
                        "mean_ms": round(r["total_ms"] / r["count"], 3)}
                for route, r in self._routes.items()}
            return {"routes": routes, "errors": self.errors}


class _MicroBatcher:
    """Dynamic batching for EXACT row-independent routes (/predict).

    The encoder artifact draws nothing and computes each row
    independently, so coalescing concurrent requests into one padded
    device call returns bit-identical per-request results while turning
    k single-row device calls into one (the fixed-batch program runs at
    the same cost for 1 row as for ``max_rows``).  Sampler/generator/
    inpainter requests draw the whole batch's noise from ONE seed, so
    coalescing would change their draws; they stay per-request.

    One daemon worker: the first queued request opens a window of
    ``window_s``; everything that arrives before it closes (or until
    ``max_rows`` rows are pending) rides the same device call.
    """

    def __init__(self, fn, max_rows: int, window_s: float):
        import threading
        self._fn = fn                      # stacked rows -> stacked outputs
        self.max_rows = max_rows
        self.window_s = window_s
        self._cv = threading.Condition()
        self._queue: list = []
        self._stop = False
        self.device_calls = 0
        self.rows_served = 0
        self.requests = 0
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="mdtx-microbatch")
        self._thread.start()

    def submit(self, rows: np.ndarray) -> np.ndarray:
        """Block until this request's rows come back from a device call."""
        import threading
        import time
        item = {"rows": rows, "out": None, "err": None,
                "t": time.monotonic(), "ev": threading.Event()}
        with self._cv:
            self._queue.append(item)
            self.requests += 1
            self._cv.notify_all()
        item["ev"].wait()
        if item["err"] is not None:
            raise item["err"]
        return item["out"]

    def close(self) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        self._thread.join(timeout=5)

    def _loop(self) -> None:
        import time
        while True:
            with self._cv:
                while not self._queue and not self._stop:
                    self._cv.wait()
                if self._stop:
                    for it in self._queue:   # fail pending, don't hang them
                        it["err"] = RuntimeError("server shutting down")
                        it["ev"].set()
                    return
            while True:   # window anchored at the HEAD request's arrival —
                with self._cv:  # a request left over from an overflow round
                    # has already waited its window and dispatches at once
                    deadline = self._queue[0]["t"] + self.window_s
                    rows = sum(len(i["rows"]) for i in self._queue)
                    remaining = deadline - time.monotonic()
                    if rows >= self.max_rows or remaining <= 0:
                        batch: list = []
                        total = 0
                        while self._queue and (
                                not batch  # head ALWAYS dispatches, even
                                # oversized: its device call fails cleanly
                                # for that one request instead of the
                                # collection loop spinning forever
                                or total + len(self._queue[0]["rows"])
                                <= self.max_rows):
                            it = self._queue.pop(0)
                            total += len(it["rows"])
                            batch.append(it)
                        break
                    self._cv.wait(timeout=remaining)
            try:
                outs = self._fn(np.concatenate([i["rows"] for i in batch]))
                self.device_calls += 1
                self.rows_served += total
                off = 0
                for it in batch:
                    n = len(it["rows"])
                    it["out"] = outs[off:off + n]
                    off += n
            except Exception as e:          # noqa: BLE001 — relay to waiters
                for it in batch:
                    it["err"] = e
            finally:
                for it in batch:
                    it["ev"].set()

    def snapshot(self) -> dict:
        return {"requests": self.requests,
                "device_calls": self.device_calls,
                "rows_served": self.rows_served}


class _Endpoints:
    """Request -> array -> device -> JSON glue, one method per route."""

    def __init__(self, server: ArtifactServer, tokenizer=None, scaler=None,
                 training_smiles: Sequence[str] = (), *,
                 device_lock=None, batch_window_ms: float = 0.0):
        import threading
        self.server = server
        self.tokenizer = tokenizer
        self.scaler = scaler
        self.training_smiles = list(training_smiles)
        self.metrics = _Metrics()
        self.device_lock = device_lock or threading.Lock()
        self.batcher: Optional[_MicroBatcher] = None
        if batch_window_ms > 0 and server.kind == "encoder":
            def run(ids: np.ndarray) -> np.ndarray:
                with self.device_lock:
                    return self.server.call_padded(ids)
            self.batcher = _MicroBatcher(run, server.batch,
                                         batch_window_ms / 1e3)

    def healthz(self) -> dict:
        return {"status": "ok", "kind": self.server.kind,
                "batch": self.server.batch,
                "restored_from": self.server.restored_from
                or "placeholder params",
                # which serving tier answers: the captured CUDA graph or
                # the program run call by call
                "tier": self.server.tier,
                "exec_error": self.server.exec_error}

    def specs(self) -> dict:
        return {"kind": self.server.kind,
                "inputs": [{"shape": list(s.shape), "dtype": s.dtype}
                           for s in self.server.specs]}

    def _props(self, body: dict) -> np.ndarray:
        rows = body.get("properties")
        if not isinstance(rows, list) or not rows:
            raise ServingError("'properties' must be a non-empty list of "
                               "property rows")
        n_cond = self.server.specs[0].shape[1]
        try:
            props = np.asarray(rows, np.float32)
        except (ValueError, TypeError):
            raise ServingError("'properties' rows must be rectangular "
                               "lists of numbers")
        if props.ndim != 2:
            raise ServingError("'properties' must be 2-D (rows x features)")
        if props.shape[0] > self.server.batch:
            raise ServingError(f"{props.shape[0]} rows exceed the "
                               f"artifact batch {self.server.batch}")
        if self.scaler is not None:
            want = len(self.scaler.data_min_)
            if props.shape[1] != want:
                raise ServingError(f"need {want} properties per row "
                                   f"(physical units), got {props.shape[1]}")
            props = np.asarray(self.scaler.transform(props), np.float32)
        if props.shape[1] < n_cond:
            raise ServingError(f"need {n_cond} properties per row, "
                               f"got {props.shape[1]}")
        return props[:, :n_cond]

    @staticmethod
    def _seed(body: dict) -> int:
        seed = body.get("seed", 0)
        if isinstance(seed, bool) or not isinstance(seed, int):
            raise ServingError("'seed' must be an integer")
        return seed

    def _require(self, kind: str) -> None:
        if self.server.kind != kind:
            raise ServingError(f"this endpoint serves {kind} artifacts; "
                               f"loaded artifact is a {self.server.kind}",
                               status=409)
        if self.tokenizer is None:
            raise ServingError("server started without a tokenizer "
                               "vocabulary", status=500)

    def sample(self, body: dict) -> dict:
        self._require("sampler")
        from .inverse_design import decode_one_hot, evaluate_generated
        props = self._props(body)
        with self.device_lock:
            out = self.server.call_padded(props, seed=self._seed(body))
        smiles = decode_one_hot(out, self.tokenizer)
        rep = evaluate_generated(smiles, self.training_smiles)
        return {"smiles": smiles,
                "validity_fraction": rep["validity_fraction"],
                "novelty_fraction": rep["novelty_fraction"]}

    def generate(self, body: dict) -> dict:
        self._require("generator")
        from ..data.tokenizer import remove_start_end_token_first
        from .inverse_design import evaluate_generated
        props = self._props(body)
        start_id = self.tokenizer.word_index.get(
            body.get("start_char", "@"), 1)
        start = np.full((props.shape[0], self.server.specs[1].shape[1]),
                        start_id, np.int64)
        with self.device_lock:
            ids = self.server.call_padded(props, start,
                                          seed=self._seed(body))
        smiles = [remove_start_end_token_first(t)
                  for t in self.tokenizer.decode(ids)]
        rep = evaluate_generated(smiles, self.training_smiles)
        return {"smiles": smiles,
                "validity_fraction": rep["validity_fraction"],
                "novelty_fraction": rep["novelty_fraction"]}

    def reload(self, body: dict) -> dict:
        import os
        path = body.get("checkpoint")
        if not isinstance(path, str) or not path:
            raise ServingError("'checkpoint' must be a path string")
        if not os.path.exists(path):
            raise ServingError(f"no checkpoint at {path}")
        with self.device_lock:
            self.server.reload_checkpoint(path)
        return {"status": "reloaded", "restored_from": path}

    def inpaint(self, body: dict) -> dict:
        self._require("inpainter")
        from ..data.tokenizer import one_hot_signed, pad_sequences
        from .inverse_design import decode_one_hot, evaluate_generated
        props = self._props(body)
        draft = body.get("draft")
        if not isinstance(draft, str) or not draft:
            raise ServingError("'draft' must be a SMILES string")
        fixed = body.get("fixed", [])
        if (not isinstance(fixed, list)
                or not all(isinstance(i, int) for i in fixed)):
            raise ServingError("'fixed' must be a list of 0-based "
                               "character positions to keep")
        n = props.shape[0]
        length, pred_dim = self.server.specs[1].shape[1:]
        if fixed and not all(0 <= i < length for i in fixed):
            raise ServingError(f"'fixed' positions must be in [0, {length})")
        ids = pad_sequences(self.tokenizer.texts_to_sequences([draft]),
                            length)
        source = np.repeat(one_hot_signed(ids, pred_dim), n,
                           axis=0).astype(np.float32)
        mask = np.zeros((n, length, pred_dim), bool)
        if fixed:
            mask[:, fixed, :] = True
        with self.device_lock:
            out = self.server.call_padded(props, source, mask,
                                          seed=self._seed(body))
        smiles = decode_one_hot(out, self.tokenizer)
        rep = evaluate_generated(smiles, self.training_smiles)
        return {"smiles": smiles,
                "validity_fraction": rep["validity_fraction"],
                "novelty_fraction": rep["novelty_fraction"]}

    def predict(self, body: dict) -> dict:
        self._require("encoder")
        from ..data.tokenizer import add_start_end_char, pad_sequences
        smiles = body.get("smiles")
        if not isinstance(smiles, list) or not smiles:
            raise ServingError("'smiles' must be a non-empty list")
        if len(smiles) > self.server.batch:
            raise ServingError(f"{len(smiles)} molecules exceed the "
                               f"artifact batch {self.server.batch}")
        max_length = self.server.specs[0].shape[1]
        texts = add_start_end_char([str(s) for s in smiles])
        ids = pad_sequences(self.tokenizer.texts_to_sequences(texts),
                            max_length)
        ids = np.asarray(ids, np.int64)
        if self.batcher is not None and len(smiles) < self.server.batch:
            logits = self.batcher.submit(ids)
        else:
            with self.device_lock:
                logits = self.server.call_padded(ids)
        flat = np.asarray(logits).reshape(len(smiles), -1)
        if self.scaler is not None:
            want = len(self.scaler.data_min_)
            if flat.shape[1] < want:
                raise ServingError(
                    f"artifact outputs {flat.shape[1]} values per row; "
                    f"the scaler expects {want}", status=500)
            props = self.scaler.inverse_transform(flat[:, :want])
        else:
            props = flat
        return {"properties": [[float(v) for v in row] for row in props]}


def make_httpd(server: ArtifactServer, tokenizer=None, scaler=None,
               training_smiles: Sequence[str] = (), *,
               host: str = "127.0.0.1", port: int = 8000,
               quiet: bool = False,
               batch_window_ms: float = 0.0) -> ThreadingHTTPServer:
    """Build (but don't start) the HTTP server; ``port=0`` auto-assigns
    (read it back from ``httpd.server_address[1]``).

    Requests are accepted concurrently but device calls serialize behind
    one lock: a single program, and on the graph tier a single set of
    captured buffers, shares one device.

    ``batch_window_ms > 0`` enables dynamic batching on ``/predict``
    (encoder artifacts): concurrent requests arriving within the window
    coalesce into ONE padded device call — exact, because the encoder
    program draws nothing and is row-independent — multiplying concurrent
    throughput by up to the artifact batch.  Randomized routes
    (sample/generate/inpaint) keep per-request calls: each request's
    seed owns the whole batch's noise draw.

    ``tokenizer``/``scaler``/``training_smiles`` default to whatever the
    artifact bundle embeds (``export.save_artifact``), so a bundled
    artifact serves with ``make_httpd(server)`` alone."""
    if tokenizer is None:
        tokenizer = getattr(server, "tokenizer", None)
    if scaler is None:
        scaler = getattr(server, "scaler", None)
    if not training_smiles:
        training_smiles = getattr(server, "training_smiles", ()) or ()
    ep = _Endpoints(server, tokenizer, scaler, training_smiles,
                    batch_window_ms=batch_window_ms)

    class Handler(BaseHTTPRequestHandler):
        def _send(self, status: int, payload: dict) -> None:
            blob = json.dumps(payload).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(blob)))
            self.end_headers()
            self.wfile.write(blob)

        def log_message(self, fmt, *fargs):  # noqa: N802
            if not quiet:
                BaseHTTPRequestHandler.log_message(self, fmt, *fargs)

        def do_GET(self):  # noqa: N802
            if self.path == "/healthz":
                self._send(200, ep.healthz())
            elif self.path == "/specs":
                self._send(200, ep.specs())
            elif self.path == "/metrics":
                snap = ep.metrics.snapshot()
                if ep.batcher is not None:
                    snap["predict_batching"] = ep.batcher.snapshot()
                self._send(200, snap)
            else:
                self._send(404, {"error": f"no route {self.path}"})

        def do_POST(self):  # noqa: N802
            import time
            route = {"/sample": ep.sample, "/generate": ep.generate,
                     "/predict": ep.predict, "/inpaint": ep.inpaint,
                     "/reload": ep.reload}.get(self.path)
            if route is None:
                self._send(404, {"error": f"no route {self.path}"})
                return
            t0, ok = time.perf_counter(), False
            try:
                n = int(self.headers.get("Content-Length", 0))
                if n > 64 * 1024 * 1024:   # refuse before buffering
                    self._send(413, {"error": f"request body {n} bytes "
                                     "exceeds the 64 MiB limit"})
                    return
                body = json.loads(self.rfile.read(n) or b"{}")
                if not isinstance(body, dict):
                    raise ServingError("request body must be a JSON object")
                # endpoints take the device lock themselves around their
                # device sections (batched /predict must queue WITHOUT
                # holding it, or it would deadlock its own worker)
                payload = route(body)
                ok = True
                self._send(200, payload)
            except ServingError as e:
                self._send(e.status, {"error": str(e)})
            except json.JSONDecodeError as e:
                self._send(400, {"error": f"bad JSON: {e}"})
            except Exception as e:  # pragma: no cover - defensive 500
                self._send(500, {"error": f"{type(e).__name__}: {e}"})
            finally:
                ep.metrics.record(self.path, time.perf_counter() - t0, ok)

    class Server(ThreadingHTTPServer):
        # http.server's default listen backlog is 5.  Dynamic batching
        # SYNCHRONIZES clients — one coalesced device call releases every
        # waiter at once, so all of them reconnect in the same instant —
        # and a burst beyond the backlog overflows the kernel accept
        # queue: the dropped half-open connections answer the client's
        # request bytes with RST (observed as ConnectionResetError under
        # 32 synchronized /predict clients of the JAX package's
        # tools/bench_serving.py).
        request_queue_size = 128

    return Server((host, port), Handler)
