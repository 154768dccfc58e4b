"""Minimal inference server over exported serving artifacts.

``python -m ast_tpu.cli.serve -d <serving_dir> [--port 8000] [-w 0.6]``

Serves the artifacts written by ``cli/export_model.py`` — no model
code, config, or checkpoint loading: the directory's ``manifest.json``
+ ``vocab.json`` + ``.jaxexp`` blobs are the whole deployment unit
(the reference's only decode path is the research CLI over a corpus
pickle tree, reference: beam.py:45-147).

Endpoints (JSON over HTTP, stdlib server):

- ``GET /manifest`` — the manifest, plus ``server.default_w``.
- ``GET /healthz`` — liveness: uptime, the device replicas serving
  decode calls, artifact count.
- ``GET /stats`` — serving counters: request/error totals, device
  calls, batch-slot occupancy, request latency p50/p90/p99 over a
  sliding window.
- ``POST /decode`` — body ``{"features": [[...], ...]}`` (one
  utterance, ``(T, 13)`` CMVN'd MFCCs) or ``{"audio": [...]}``
  (raw 8 kHz samples; framed to MFCC + per-utterance CMVN on the
  server).  Optional ``"mode": "greedy"|"beam"`` (default: greedy if
  exported, else beam), ``"w"`` (beam length-norm weight, default the
  CLI's ``-w``) and ``"nbest": n`` (beam mode: also return the top-n
  reranked hypotheses).  Response: ``{"text", "ids", "mode", "frames",
  "artifact"}`` plus beam-mode ``score`` (length-normalized) and
  ``nbest`` (``[{"text", "ids", "score"}]``) when requested, plus
  ``truncated_to_frames`` when the input exceeds every exported shape
  (only that prefix was decoded).
- ``POST /decode`` with ``Content-Type: application/octet-stream`` —
  the binary fast path: the body is one ``.npy`` blob (a 2-D ``(T,
  n_ceps)`` feature matrix, or a 1-D raw-audio vector), options ride
  the query string (``?mode=beam&w=0.6&nbest=5``).  JSON float lists
  cost ~100x the bytes and dominate request time on a small host;
  production clients should send npy.
- ``POST /decode_batch`` — bulk decode: ``{"batch": [item, ...]}``
  where each item is a ``/decode`` body; top-level ``mode``/``w``/
  ``nbest`` apply to all.  Rows are grouped by artifact and dispatched
  in static-batch chunks, so one client fills whole device batches
  without concurrency or the micro-batch window.  Per-row errors
  isolate (``{"error": ...}`` in that slot).  Binary variant: a 3-D
  ``(B, T, n_ceps)`` ``.npy`` stack.  Response ``{"results": [...]}``
  in input order.

By default one request is one decode over the artifact's full static
batch (the remaining rows are padding).  ``--batch-window-ms W`` turns
on cross-request micro-batching: concurrent requests routed to the same
artifact are collected for up to W ms (or until its static batch is
full, whichever comes first) and decoded in ONE artifact call — under
load a batch-128 artifact then serves up to 128 utterances per device
dispatch instead of one.

``--replicas N`` serves decode calls from the first N local JAX
devices as a replica pool (0 = every visible device): each call is
dispatched to whichever device is free, so on a multi-chip host the
server's decode throughput scales with chips.  Artifacts compile once
per device on first use; with micro-batching on, up to N batches are
in flight at once.

``--warmup`` compiles every artifact on every replica device in a
background thread at startup (a flagship artifact's first call pays
its device compile, which would otherwise land on the first unlucky
request per artifact per device).  ``GET /healthz``
reports ``ready: false`` and the warm progress until it finishes, so a
load balancer can hold traffic during the compile window.

On SIGTERM the server drains: it stops accepting connections, finishes
in-flight requests, dispatches anything still queued in the
micro-batch window, then exits 0 (submissions that arrive mid-drain
get 503).  The serving mirror of the trainer's graceful-preemption
handling.
"""

import argparse
import collections
import json
import os
import queue
import signal
import socket
import subprocess
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import jax
import numpy as np

from ast_tpu import serving
from ast_tpu.data.detok import ids_to_text
from ast_tpu.ops.beam import rerank_hypothesis


def _detok(ids, vocab, dec_key):
    return ids_to_text(ids, lambda i: vocab[str(i)], dec_key)


class _Stats:
    """Serving counters for ``GET /stats`` (lock-protected)."""

    def __init__(self, window=2048):
        self._lock = threading.Lock()
        self.started = time.time()
        self.requests = 0
        self.errors = 0
        self.device_calls = 0
        self.rows = 0                    # utterances decoded
        self.slots = 0                   # static-batch capacity used
        self._lat = collections.deque(maxlen=window)

    def record_request(self, seconds, error=False):
        with self._lock:
            self.requests += 1
            if error:
                self.errors += 1
            else:
                self._lat.append(seconds)

    def record_call(self, rows, batch):
        with self._lock:
            self.device_calls += 1
            self.rows += rows
            self.slots += batch

    def snapshot(self):
        with self._lock:
            lat = sorted(self._lat)
            out = {
                "uptime_s": round(time.time() - self.started, 3),
                "requests": self.requests,
                "errors": self.errors,
                "device_calls": self.device_calls,
                "rows_decoded": self.rows,
                # fraction of dispatched static-batch rows that carried
                # real utterances (1.0 = perfectly packed batches)
                "batch_occupancy": (round(self.rows / self.slots, 4)
                                    if self.slots else None),
            }
        if lat:
            pick = lambda q: round(lat[min(len(lat) - 1,
                                           int(q * len(lat)))], 4)
            out["latency_s"] = {"p50": pick(0.50), "p90": pick(0.90),
                                "p99": pick(0.99), "n": len(lat)}
        return out


class ServerDraining(RuntimeError):
    """Request rejected because the server is shutting down (503)."""


class _Pending:
    """One utterance waiting inside the micro-batcher."""

    __slots__ = ("x", "event", "out", "error", "t")

    def __init__(self, x):
        self.x = x
        self.event = threading.Event()
        self.out = None
        self.error = None
        self.t = time.monotonic()       # arrival: bounds the wait window


class _MicroBatcher:
    """Collects concurrent same-artifact requests into one device call.

    A dispatcher thread waits up to ``window_s`` after the first pending
    request for an artifact (dispatching immediately once its static
    batch is full), then hands the whole group to ``call_rows`` — the
    artifact executes once for up to ``batch`` utterances instead of
    once per request.  Exceptions propagate to every affected waiter.
    With ``workers > 1`` (one per device replica) that many groups can
    be in flight at once."""

    def __init__(self, call_rows, window_s, workers=1):
        self._call_rows = call_rows
        self.window_s = window_s
        self._cond = threading.Condition()
        self._pending = {}              # file -> (entry, [_Pending, ...])
        self._closed = False
        self._threads = [threading.Thread(target=self._run, daemon=True)
                         for _ in range(max(1, workers))]
        for t in self._threads:
            t.start()

    def submit(self, entry, x):
        req = _Pending(x)
        with self._cond:
            if self._closed:
                raise ServerDraining("server is shutting down")
            self._pending.setdefault(entry["file"], (entry, []))[1] \
                .append(req)
            self._cond.notify_all()
        req.event.wait()
        if req.error is not None:
            raise req.error
        return req.out

    def close(self, timeout=120.0):
        """Reject new submissions, dispatch everything already queued,
        and join the dispatcher threads.  The timeout must cover a
        worst-case device call (a cold flagship compile included) or the
        drain guarantee is hollow."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        deadline = time.monotonic() + timeout
        for t in self._threads:
            t.join(timeout=max(0.0, deadline - time.monotonic()))

    def _fullest(self):
        return max(self._pending.items(), key=lambda kv: len(kv[1][1]))

    def _run(self):
        while True:
            with self._cond:
                while not self._pending and not self._closed:
                    self._cond.wait()
                if self._closed and not self._pending:
                    return
                while not self._closed and self._pending:
                    _, (entry, reqs) = self._fullest()
                    if len(reqs) >= entry["batch"]:
                        break
                    # the OLDEST pending request (each group's list is
                    # FIFO) sets the deadline, so no request waits more
                    # than ~window_s past arrival — leftovers from an
                    # overflowed dispatch keep their original arrival
                    # time instead of restarting the window
                    oldest = min(v[1][0].t for v in self._pending.values())
                    left = oldest + self.window_s - time.monotonic()
                    if left <= 0:
                        break
                    self._cond.wait(timeout=left)
                if not self._pending:
                    # another worker drained the queue while we waited
                    continue
                # dispatch a full group if one exists, else the group
                # holding the oldest (deadline-expired) request
                fname, (entry, reqs) = self._fullest()
                if len(reqs) < entry["batch"]:
                    fname, (entry, reqs) = min(
                        self._pending.items(),
                        key=lambda kv: kv[1][1][0].t)
                take = reqs[: entry["batch"]]
                del reqs[: len(take)]
                if not reqs:
                    del self._pending[fname]
            try:
                outs = self._call_rows(entry, [r.x for r in take])
                for r, o in zip(take, outs):
                    r.out = o
            except Exception as e:       # surface to every waiter
                for r in take:
                    r.error = e
            for r in take:
                r.event.set()


class ArtifactServer:
    """Loads a serving dir; decodes single utterances."""

    def __init__(self, serving_dir, default_w=0.6, batch_window_ms=0.0,
                 replicas=1, warmup=False, inflight=2):
        self.dir = serving_dir
        self.default_w = default_w
        with open(os.path.join(serving_dir, "manifest.json")) as f:
            self.manifest = json.load(f)
        if "vocab" not in self.manifest:
            # write_manifest's i2w is optional, but serving needs it to
            # detokenize — fail with the cause, not a KeyError
            raise ValueError(
                f"{serving_dir}/manifest.json has no 'vocab' entry — "
                "re-export with export_model (or pass i2w to "
                "write_manifest); the server cannot detokenize without "
                "it")
        with open(os.path.join(serving_dir, self.manifest["vocab"])) as f:
            self.vocab = json.load(f)
        self.entries = {"greedy": [], "beam": []}
        self.artifacts = {}
        self.feat_dim = {}              # file -> expected n_ceps
        for e in self.manifest["entries"]:
            self.entries[e["kind"]].append(e)
            art = serving.load_artifact(
                os.path.join(serving_dir, e["file"]))
            self.artifacts[e["file"]] = art
            self.feat_dim[e["file"]] = int(art.exported.in_avals[0].shape[2])
        for v in self.entries.values():         # smallest fitting shape first
            v.sort(key=lambda e: (e["frames"], e["batch"]))
        self._mfcc = None
        self.stats = _Stats()
        # replica pool: each device call checks a device out of the
        # queue and commits its input there (an Exported call follows
        # the committed placement).  The queue holds ``inflight`` tokens
        # per device (a counting semaphore): a caller checks a token
        # out, holds it through block_until_ready, and returns it —
        # bounding each chip to ``inflight`` queued batches (no
        # unbounded HBM growth under a request flood) while still
        # overlapping one batch's host->device transfer with the
        # previous batch's compute.
        local = jax.local_devices()
        n = len(local) if replicas <= 0 else min(replicas, len(local))
        self.devices = local[: max(1, n)]
        self.inflight = max(1, int(inflight))
        self._free = queue.Queue()
        for _ in range(self.inflight):
            for d in self.devices:
                self._free.put(d)
        self.batcher = (_MicroBatcher(self._call_rows,
                                      batch_window_ms / 1000.0,
                                      workers=(len(self.devices)
                                               * self.inflight))
                        if batch_window_ms > 0 else None)
        # --warmup: compile every artifact on every replica before
        # traffic; /healthz gates on `ready` until done
        self._warm_lock = threading.Lock()
        self.warm_total = (len(self.artifacts) * len(self.devices)
                           if warmup else 0)
        self.warm_done = 0
        self.warm_error = None
        if warmup:
            threading.Thread(target=self._warmup, daemon=True).start()

    def _warmup(self):
        for fname, art in self.artifacts.items():
            aval = art.exported.in_avals[0]
            X = np.zeros(aval.shape, aval.dtype)
            for dev in self.devices:
                try:
                    jax.block_until_ready(art.call(jax.device_put(X, dev)))
                except Exception as e:     # surface via /healthz; the
                    with self._warm_lock:  # request path re-raises it
                        if self.warm_error is None:
                            self.warm_error = f"{fname}: {e}"
                with self._warm_lock:
                    self.warm_done += 1

    @property
    def ready(self):
        # a warmup failure means some artifact fails every decode —
        # stay not-ready so a load balancer gating on `ready` keeps
        # holding traffic instead of routing to a broken server
        with self._warm_lock:
            return (self.warm_done >= self.warm_total
                    and self.warm_error is None)

    def _features(self, body):
        if "features" in body:
            x = np.asarray(body["features"], np.float32)
            if x.ndim != 2:
                raise ValueError("features must be a (T, n_ceps) matrix")
            return x
        if "audio" in body:
            from ast_tpu.ops.fbank import (MfccExtractor, apply_cmvn,
                                           compute_cmvn_stats, num_frames)
            if self._mfcc is None:
                self._mfcc = MfccExtractor()
            audio = np.asarray(body["audio"], np.float32).reshape(-1)
            # pad to 1-second buckets so XLA compiles a handful of MFCC
            # shapes, not one program per distinct request length (each
            # first-seen length would stall its request for a compile
            # and grow the jit cache without bound); slice back to the
            # true frame count (same scheme as prep_data mfcc)
            bucket = self._mfcc.cfg.sample_rate
            true_frames = num_frames(self._mfcc.cfg, len(audio))
            padded = max(1, int(-(-len(audio) // bucket))) * bucket
            audio = np.pad(audio, (0, padded - len(audio)))
            feats = np.asarray(self._mfcc(audio),
                               np.float32)[:true_frames]
            if true_frames == 0:
                raise ValueError("audio shorter than one MFCC frame")
            return np.asarray(apply_cmvn(feats,
                                         compute_cmvn_stats([feats])),
                              np.float32)
        raise ValueError("body must carry 'features' or 'audio'")

    def _call_rows(self, entry, xs):
        """Decode utterances ``xs`` (each ``(t, F)``) as rows of one
        static-batch artifact call; returns per-row output tuples."""
        T, B = entry["frames"], entry["batch"]
        # width comes from the ARTIFACT, not the first queued request:
        # a malformed request must not poison requests co-batched with
        # it (each row is validated in decode() before submit)
        X = np.zeros((B, T, self.feat_dim[entry["file"]]), np.float32)
        for i, x in enumerate(xs):
            X[i, : min(T, x.shape[0])] = x[:T]
        dev = self._free.get()              # block until a replica frees
        try:
            # block until the COMPUTATION finishes before releasing the
            # replica: jit dispatch is async, so returning the device at
            # dispatch time would let unbounded batches queue on one
            # chip (no backpressure) and falsify the one-call-per-chip
            # pool contract
            out = jax.block_until_ready(
                self.artifacts[entry["file"]].call(jax.device_put(X, dev)))
        finally:
            self._free.put(dev)
        self.stats.record_call(len(xs), B)
        # split batch-major outputs per row; scalars (e.g. the greedy
        # artifact's n_steps) ride along unchanged
        out = [np.asarray(o) for o in out]
        return [tuple(o[i] if o.ndim and o.shape[0] == B else o
                      for o in out)
                for i in range(len(xs))]

    def _pick_entry(self, mode, x):
        """Select the smallest fitting artifact for one utterance and
        validate its feature width (BEFORE any batching, so a bad width
        fails only its own request)."""
        options = self.entries.get(mode)
        if not options:
            raise ValueError(f"no {mode!r} artifact exported")
        entry = next((e for e in options if e["frames"] >= x.shape[0]),
                     options[-1])
        want = self.feat_dim[entry["file"]]
        if x.shape[1] != want:
            raise ValueError(
                f"features must be (T, {want}); got (T, {x.shape[1]})")
        return entry

    def decode(self, body):
        x = self._features(body)
        mode = body.get("mode") or (
            "greedy" if self.entries["greedy"] else "beam")
        entry = self._pick_entry(mode, x)
        if self.batcher is not None:
            row = self.batcher.submit(entry, x)
        else:
            row = self._call_rows(entry, [x])[0]
        return self._row_response(row, mode, entry, body, x.shape[0])

    def _row_response(self, row, mode, entry, body, n_frames):
        """Build the per-utterance response dict from one artifact
        output row (shared by /decode and /decode_batch)."""
        T = entry["frames"]
        syms = self.manifest.get("symbols", {"GO": 1, "EOS": 2})
        go_id, eos_id = int(syms["GO"]), int(syms["EOS"])
        if mode == "greedy":
            raw = row[0]
            # cut at the utterance's own first EOS: the artifact's
            # static-batch zero-padding rows keep the decode loop alive
            # past it, and post-EOS argmax is babble conditioned beyond
            # the sentence (corpus decode keeps those tokens for
            # reference parity; a served transcript must not).
            eos = np.nonzero(raw == eos_id)[0]
            ids = [int(i) for i in (raw[: eos[0]] if eos.size else raw)]
        else:
            hyps, scores, lengths = row
            entries = [(hyps[n, : int(lengths[n])].tolist(),
                        float(scores[n]))
                       for n in range(hyps.shape[0])]
            w = float(body.get("w", self.default_w))
            reranked = rerank_hypothesis(entries, w)

            # beam hyps carry the GO prefix and (when finished) the EOS
            # terminator; strip both so 'ids' means the same thing in
            # every mode — the words of the transcript
            def _strip(h):
                h = [int(i) for i in h]
                if h and h[0] == go_id:
                    h = h[1:]
                if h and h[-1] == eos_id:
                    h = h[:-1]
                return h

            ids = _strip(reranked[0][0])
        resp = {"text": _detok(ids, self.vocab, self.manifest["dec_key"]),
                "ids": ids, "mode": mode, "frames": int(n_frames),
                "artifact": entry["file"]}
        if mode == "beam":
            # length-normalized score of the winning hypothesis, plus
            # the reranked n-best list on request ("nbest": n) — the
            # standard ASR serving shape for downstream rescoring
            resp["score"] = float(reranked[0][1])
            nbest = int(body.get("nbest", 1))
            if nbest > 1:
                # the winner's strip/detok already happened for the
                # top-level fields — reuse it (detok is host hot path)
                out = [{"ids": ids, "text": resp["text"],
                        "score": resp["score"]}]
                for hyp, s, _len in reranked[1:nbest]:
                    h = _strip(hyp)
                    out.append({"ids": h,
                                "text": _detok(h, self.vocab,
                                               self.manifest["dec_key"]),
                                "score": float(s)})
                resp["nbest"] = out
        if n_frames > T:
            # no exported shape fits: only the first T frames decoded
            resp["truncated_to_frames"] = T
        return resp

    def decode_batch(self, body):
        """Bulk decode: ``{"batch": [item, ...]}`` where each item is a
        ``/decode`` body (``features`` or ``audio``); top-level
        ``mode``/``w``/``nbest`` apply to every item.  Rows are grouped
        by their selected artifact and dispatched in static-batch-sized
        chunks, so ONE client fills whole device batches without
        needing concurrency or the micro-batch window.  Per-row errors
        isolate: a malformed item yields ``{"error": ...}`` in its slot
        while the rest decode.  Returns ``{"results": [...]}`` in input
        order."""
        if self.batcher is not None and self.batcher._closed:
            raise ServerDraining("server is shutting down")
        items = body.get("batch")
        if not isinstance(items, list) or not items:
            raise ValueError("body must carry a non-empty 'batch' list")
        mode = body.get("mode") or (
            "greedy" if self.entries["greedy"] else "beam")
        opts = {k: body[k] for k in ("w", "nbest") if k in body}
        results = [None] * len(items)
        groups = {}                      # entry file -> (entry, [i, ...])
        xs = {}
        for i, item in enumerate(items):
            try:
                x = self._features(item)
                entry = self._pick_entry(mode, x)
            except (ValueError, KeyError, TypeError) as e:
                results[i] = {"error": str(e)}
                continue
            xs[i] = x
            groups.setdefault(entry["file"], (entry, []))[1].append(i)
        for entry, idxs in groups.values():
            B = entry["batch"]
            for c in range(0, len(idxs), B):
                chunk = idxs[c: c + B]
                rows = self._call_rows(entry, [xs[i] for i in chunk])
                for i, row in zip(chunk, rows):
                    results[i] = self._row_response(
                        row, mode, entry, opts, xs[i].shape[0])
        return {"results": results}


class _Server(ThreadingHTTPServer):
    # socketserver's default listen backlog (5) resets connections under
    # a burst of concurrent clients — exactly the load micro-batching is
    # for.  Large enough to absorb a full static batch of simultaneous
    # connects.
    request_queue_size = 128
    # NON-daemon handler threads: ThreadingMixIn only tracks (and
    # server_close() only joins) non-daemon threads, and the SIGTERM
    # drain guarantee — in-flight requests finish and write their
    # responses before exit — depends on that join.  The backstop for a
    # hung device call is the cluster scheduler's SIGKILL, same as the
    # trainer's preemption contract.
    daemon_threads = False
    # --workers pre-fork: every worker process binds the SAME port with
    # SO_REUSEPORT and the kernel load-balances connections across them
    # — N independent GILs for the host-side work (JSON, feature
    # assembly, detok), which bounds single-process serving
    reuse_port = False

    def server_bind(self):
        if self.reuse_port:
            self.socket.setsockopt(socket.SOL_SOCKET,
                                   socket.SO_REUSEPORT, 1)
        super().server_bind()


def make_server(serving_dir, port=0, host="127.0.0.1", default_w=0.6,
                batch_window_ms=0.0, replicas=1, warmup=False,
                inflight=2, reuse_port=False):
    """Build (ThreadingHTTPServer, ArtifactServer); caller runs
    ``serve_forever`` (the CLI) or a thread (tests)."""
    state = ArtifactServer(serving_dir, default_w=default_w,
                           batch_window_ms=batch_window_ms,
                           replicas=replicas, warmup=warmup,
                           inflight=inflight)

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):              # quiet by default
            pass

        def _reply(self, code, obj):
            blob = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(blob)))
            self.end_headers()
            self.wfile.write(blob)

        def do_GET(self):
            if self.path == "/manifest":
                self._reply(200, dict(state.manifest,
                                      server={"default_w": state.default_w}))
            elif self.path == "/healthz":
                out = {
                    "ok": state.warm_error is None,
                    "ready": state.ready,
                    "uptime_s": round(time.time() - state.stats.started, 3),
                    "replicas": [str(d) for d in state.devices],
                    "artifacts": len(state.artifacts),
                    "batching": state.batcher is not None,
                }
                if state.warm_total:
                    out["warmup"] = {"done": state.warm_done,
                                     "total": state.warm_total}
                    if state.warm_error:
                        out["warmup"]["error"] = state.warm_error
                self._reply(200, out)
            elif self.path == "/stats":
                self._reply(200, state.stats.snapshot())
            else:
                self._reply(404, {"error": "GET /manifest|/healthz|/stats "
                                           "or POST /decode"})

        def do_POST(self):
            from urllib.parse import parse_qs, urlparse
            url = urlparse(self.path)
            if url.path not in ("/decode", "/decode_batch"):
                self._reply(404, {"error": "POST /decode|/decode_batch"})
                return
            bulk = url.path == "/decode_batch"
            t0 = time.monotonic()
            try:
                n = int(self.headers.get("Content-Length", 0))
                raw = self.rfile.read(n)
                ctype = self.headers.get("Content-Type", "")
                if ctype.startswith("application/octet-stream"):
                    # binary fast path: the body is one .npy blob — a
                    # (T, n_ceps) f32 matrix = features, a 1-D vector =
                    # raw audio samples; for /decode_batch a (B, T,
                    # n_ceps) stack = B feature matrices.  JSON float
                    # lists cost ~100x the bytes and dominate a small
                    # host's request time; options ride the query string
                    # (?mode=beam&w=0.6&nbest=5).
                    import io
                    arr = np.load(io.BytesIO(raw), allow_pickle=False)
                    want_nd = (3,) if bulk else (1, 2)
                    if arr.ndim not in want_nd:
                        raise ValueError(
                            "binary body must be a (B, T, n_ceps) "
                            "feature stack" if bulk else
                            "binary body must be a (T, n_ceps) feature "
                            f"matrix or a 1-D audio vector (got shape "
                            f"{arr.shape})")
                    arr = arr.astype(np.float32)
                    q = {k: v[-1] for k, v in
                         parse_qs(url.query).items()}
                    if bulk:
                        body = {"batch": [{"features": a} for a in arr]}
                    else:
                        body = {"features" if arr.ndim == 2 else "audio":
                                arr}
                    if "mode" in q:
                        body["mode"] = q["mode"]
                    if "w" in q:
                        body["w"] = float(q["w"])
                    if "nbest" in q:
                        body["nbest"] = int(q["nbest"])
                else:
                    body = json.loads(raw or b"{}")
                out = (state.decode_batch(body) if bulk
                       else state.decode(body))
            except (ValueError, KeyError, TypeError) as e:
                state.stats.record_request(time.monotonic() - t0,
                                           error=True)
                self._reply(400, {"error": str(e)})
                return
            except ServerDraining as e:     # retryable: shutting down
                state.stats.record_request(time.monotonic() - t0,
                                           error=True)
                self._reply(503, {"error": str(e)})
                return
            except RuntimeError as e:
                # device-side failures (XlaRuntimeError subclasses
                # RuntimeError) are server faults, not retryable drains
                state.stats.record_request(time.monotonic() - t0,
                                           error=True)
                self._reply(500, {"error": str(e)})
                return
            state.stats.record_request(time.monotonic() - t0)
            self._reply(200, out)

    cls = _Server if not reuse_port else type(
        "_ReusePortServer", (_Server,), {"reuse_port": True})
    return cls((host, port), Handler), state


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Serve exported decode artifacts over HTTP")
    parser.add_argument("-d", "--serving_dir", required=True,
                        help="directory written by cli/export_model.py")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("-w", "--W", type=float, default=0.6,
                        help="default beam length-norm weight "
                             "(per-request 'w' overrides)")
    parser.add_argument("--batch-window-ms", type=float, default=0.0,
                        help="micro-batch concurrent requests: wait up "
                             "to this long to fill an artifact's static "
                             "batch before dispatching (0 = off)")
    parser.add_argument("--replicas", type=int, default=1,
                        help="serve decode calls from this many local "
                             "devices as a replica pool (0 = all "
                             "visible devices; default 1)")
    parser.add_argument("--warmup", action="store_true",
                        help="compile every artifact on every replica "
                             "at startup in the background; /healthz "
                             "reports ready=false until done")
    parser.add_argument("--inflight-per-replica", type=int, default=2,
                        dest="inflight",
                        help="max batches queued per device (bounded "
                             "backpressure; 2 overlaps transfer with "
                             "compute, 1 = strict one-call-per-chip)")
    parser.add_argument("--workers", type=int, default=1,
                        help="pre-fork this many server PROCESSES all "
                             "bound to --port via SO_REUSEPORT (the "
                             "kernel load-balances connections): one "
                             "GIL per worker for the host-side "
                             "JSON/feature/detok work.  Each worker "
                             "opens its own device client, and a JAX "
                             "process reserves most of a GPU's memory, "
                             "so N > 1 is refused unless "
                             "JAX_PLATFORMS=cpu (CPU artifacts); spread "
                             "one process over several GPUs with "
                             "--replicas instead.  Requires an explicit "
                             "--port.")
    parser.add_argument("--_reuseport_child", action="store_true",
                        help=argparse.SUPPRESS)
    args = parser.parse_args(argv)

    if args.workers > 1:
        # decided before JAX opens any device: the second process on a
        # GPU would fail for want of memory
        if os.environ.get("JAX_PLATFORMS", "").strip().lower() != "cpu":
            parser.error("--workers > 1 starts one process per worker, "
                         "and only one process can use a GPU; set "
                         "JAX_PLATFORMS=cpu to serve CPU artifacts with "
                         "several workers, or serve one process over "
                         "several devices with --replicas")
        if args.port == 0:
            parser.error("--workers requires an explicit --port "
                         "(every worker binds the same one)")
        # parent becomes worker 0 (itself bound with SO_REUSEPORT) and
        # spawns workers 1..N-1 as re-execed child processes; SIGTERM
        # fans out so every worker drains in-flight requests
        child_argv = [a for a in (argv if argv is not None
                                  else sys.argv[1:])]
        for flag in ("--workers",):
            while flag in child_argv:
                i = child_argv.index(flag)
                del child_argv[i:i + 2]
        children = [
            subprocess.Popen(
                [sys.executable, "-m", "ast_tpu.cli.serve",
                 *child_argv, "--_reuseport_child"])
            for _ in range(args.workers - 1)]

        def _fan_out(signum, frame):
            for c in children:
                c.send_signal(signal.SIGTERM)
        signal.signal(signal.SIGTERM, _fan_out)
        # fall through: the parent serves too (handler below re-binds
        # SIGTERM to ALSO drain its own server)
        _worker_children = children
    else:
        _worker_children = []

    from ast_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()

    httpd, state = make_server(args.serving_dir, args.port, args.host,
                               default_w=args.W,
                               batch_window_ms=args.batch_window_ms,
                               replicas=args.replicas,
                               warmup=args.warmup,
                               inflight=args.inflight,
                               reuse_port=(args.workers > 1
                                           or args._reuseport_child))
    kinds = {k: len(v) for k, v in state.entries.items() if v}
    batching = (f", micro-batch window {args.batch_window_ms:g} ms"
                if state.batcher else "")
    pool = (f", {len(state.devices)} device replicas"
            if len(state.devices) > 1 else "")
    warm = (f", warming {state.warm_total} artifact-replicas"
            if state.warm_total else "")
    print(f"serving {kinds} artifacts from {args.serving_dir} "
          f"on http://{args.host}:{httpd.server_address[1]}"
          f"{batching}{pool}{warm}", flush=True)

    # graceful drain on SIGTERM (rolling restarts, cluster preemption —
    # the serving mirror of the trainer's preempt handling): stop
    # accepting connections, finish in-flight requests (server_close
    # joins handler threads), dispatch anything queued in the
    # micro-batcher, then exit 0.  New submissions during the drain get
    # 503.  shutdown() must run off the main thread: the signal handler
    # interrupts serve_forever itself.
    def _term(signum, frame):
        print("SIGTERM: draining in-flight requests and shutting down",
              flush=True)
        for c in _worker_children:       # fan out to pre-fork workers
            c.send_signal(signal.SIGTERM)
        threading.Thread(target=httpd.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, _term)
    try:
        httpd.serve_forever()
    finally:
        # order matters: draining the batcher unblocks handler threads
        # waiting on their _Pending events, THEN server_close joins the
        # (non-daemon) handler threads so every accepted request has
        # written its response before the process exits
        if state.batcher is not None:
            state.batcher.close()        # dispatches remaining groups
        httpd.server_close()             # joins in-flight handlers
        for c in _worker_children:       # every worker drains before exit
            c.wait()


if __name__ == "__main__":
    main()
