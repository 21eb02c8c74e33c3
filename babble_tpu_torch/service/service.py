"""GET /Stats -> JSON of the node's live counters, with permissive CORS
— reference service/service.go:17-65 — plus GET /debug/profile, the
live-profiling counterpart of the reference's pprof mount
(reference cmd/babble/main.go:12) re-targeted at the device: it
captures a torch.profiler trace of the running node for N seconds.

GET /debug/phases serves the overlap-aware per-phase timers as
structured numbers: for each phase the last/total/calls triple from
Core.phase_ns, plus the engine's pipeline diagnostics (host-blocking
pull share vs the device compute that overlapped gossip ingest) — the
attribution view for "what bounds this node's consensus rate".

GET /metrics serves the process-global telemetry registry in
Prometheus text exposition format (counters, breaker-state gauges,
submit->commit / gossip-RTT / fsync latency histograms), and GET
/debug/trace serves the node's span ring as Chrome trace-event JSON
that loads directly in Perfetto — see docs/observability.md."""

from __future__ import annotations

import base64
import hmac
import json
import os
import tempfile
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from .ingress import TX_BATCH_MAGIC, decode_tx_batch

# /submit defaults to no authentication (localhost-binding is the
# documented guard; --submit_token adds a bearer token), so at least
# bound what one request can make the node buffer. The cap is enforced
# while READING, not just against Content-Length — a chunked or
# lying-length client cannot make the handler buffer past it.
_MAX_SUBMIT_BYTES = 1 << 20
# A /submit/batch body may carry many transactions; each tx stays
# under _MAX_SUBMIT_BYTES, the frame under this.
_MAX_BATCH_BYTES = 8 << 20


class Service:
    def __init__(self, bind_addr: str, node):
        host, port_s = bind_addr.rsplit(":", 1)
        self.node = node
        self._profile_lock = threading.Lock()
        self._profile_dir = None
        service = self

        class Handler(BaseHTTPRequestHandler):
            # One serialization + CORS path for every endpoint — the
            # per-endpoint hand-rolled header blocks kept drifting
            # (the /Stats handler sent three CORS headers, the rest
            # one, 404s none and an empty body that scrapers read as
            # "server up, metric gone").
            def _send(self, code, body, content_type, extra=None):
                self.send_response(code)
                self.send_header("Content-Type", content_type)
                self.send_header("Access-Control-Allow-Origin", "*")
                self.send_header(
                    "Access-Control-Allow-Methods",
                    "POST, GET, OPTIONS, PUT, DELETE")
                self.send_header(
                    "Access-Control-Allow-Headers",
                    "Accept, Content-Type, Content-Length, "
                    "Accept-Encoding, X-CSRF-Token, Authorization, "
                    "X-Babble-Client")
                for k, v in (extra or {}).items():
                    self.send_header(k, str(v))
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _json(self, code, obj, extra=None):
                self._send(code, json.dumps(obj).encode(),
                           "application/json", extra=extra)

            def _not_found(self):
                # A JSON body, not an empty 404: scrapers and probes
                # must fail loudly on a wrong path, not parse "".
                self._json(404, {"error": "unknown path",
                                 "path": urlparse(self.path).path})

            def do_GET(self):  # noqa: N802 - stdlib API
                url = urlparse(self.path)
                if url.path.rstrip("/") in ("/Stats", "/stats", ""):
                    self._json(200, service.node.get_stats())
                elif url.path.rstrip("/") == "/metrics":
                    # Prometheus text exposition (docs/observability
                    # .md): the node's own registry (gossip, consensus,
                    # breaker, latency histograms) merged with the
                    # process-global one (store fsyncs, chaos-transport
                    # faults). Point-in-time gauges (breaker states,
                    # backlog, WAL size) are refreshed here;
                    # counters/histograms are live.
                    from ..telemetry import get_registry, render_merged

                    node = service.node
                    node._refresh_telemetry_gauges()
                    body = render_merged(
                        get_registry(), node.registry).encode()
                    self._send(
                        200, body,
                        "text/plain; version=0.0.4; charset=utf-8")
                elif url.path.rstrip("/") == "/debug/trace":
                    # The span ring as Chrome trace-event JSON — loads
                    # directly in Perfetto (ui.perfetto.dev) for a real
                    # timeline of how syncs, consensus passes, commits
                    # and fast-forwards interleaved.
                    #
                    # ?epoch=cluster rebases the timestamps onto the
                    # shared cluster epoch (telemetry/clock.py), so N
                    # nodes' dumps land on ONE timeline; the raw dump
                    # embeds the clock block instead, and tracemerge
                    # applies it. ?since=<cursor> returns only entries
                    # completed after the cursor (the dump's
                    # babble.next_since), so a long-poll scraper stops
                    # re-downloading the full 4096-span ring per
                    # request.
                    node = service.node
                    q = parse_qs(url.query)
                    try:
                        since = int(q.get("since", ["0"])[0])
                    except ValueError:
                        self._json(400, {"error": "bad since cursor"})
                        return
                    epoch = q.get("epoch", ["mono"])[0]
                    rebase = None
                    meta = {"node": node.id, "epoch": epoch,
                            "clock": node.clock.describe()}
                    if epoch == "cluster":
                        rebase = node.clock.cluster_epoch_ns
                    self._json(200, node.trace.to_chrome_trace(
                        pid=node.id, rebase=rebase, since_seq=since,
                        meta=meta))
                elif url.path.rstrip("/") == "/debug/phases":
                    core = service.node.core
                    phases = {
                        ph: {"last_ns": ent[0], "total_ns": ent[1],
                             "calls": ent[2]}
                        for ph, ent in list(core.phase_ns.items())
                    }
                    out = {"phases": phases}
                    dstats = getattr(core.hg.store, "durability_stats",
                                     None)
                    if dstats is not None:
                        # Durable-path attribution (docs/robustness.md
                        # "Crash recovery"): commit/fsync counters, the
                        # delivered-block and consensus anchors, and
                        # the live WAL size.
                        out["store"] = dstats()
                    engine = getattr(core.hg, "engine", None)
                    if engine is not None:
                        # Host-blocking vs overlapped device time of the
                        # async pipeline (see ops/incremental.py):
                        # c_pull is what the host actually waited at
                        # delta-fetch; overlap is device compute that
                        # ran while the host ingested gossip.
                        out["engine"] = {
                            "backlog": engine.backlog(),
                            "inflight": engine.inflight,
                            "redo_count": engine.redo_count,
                            "last_overlap_ns": engine.last_overlap_ns,
                            "last_pass_phase_ns": dict(engine.phase_ns),
                            "windows": getattr(engine, "_dbg_windows",
                                               None),
                            "c_pull_bytes": getattr(
                                engine, "c_pull_bytes", 0),
                            "cost_report": getattr(
                                engine, "cost_report", None),
                        }
                    self._json(200, out)
                elif url.path.rstrip("/") == "/debug/gossip":
                    # Gossip efficiency observatory (docs/
                    # observability.md "Gossip efficiency"): per-peer
                    # redundancy ratio, new-events-per-sync, bytes per
                    # new event, RTT quantiles, propagation latency,
                    # and the known-map bookkeeping wall — the page
                    # that says how much of the gossip wire actually
                    # buys new events.
                    self._json(200, service.node.get_gossip_stats())
                elif url.path.rstrip("/") == "/debug/peers":
                    # Fault-tolerance view (docs/robustness.md): per-
                    # peer circuit-breaker states plus the engine
                    # degradation counters — the first place to look
                    # when a net is slow or a node stopped committing.
                    # Augmented with the consensus-progress columns
                    # from the gossip health piggyback (each peer's
                    # last known round and how far behind it trails)
                    # and the efficiency columns from the gossip
                    # observatory (redundancy ratio, bytes per new
                    # event) — one endpoint, the whole peer-health
                    # story.
                    node = service.node
                    core = node.core
                    peers = node.get_peer_stats()
                    for addr, prog in node.get_peer_progress().items():
                        peers.setdefault(addr, {}).update(prog)
                    for addr, eff in node.gossip_peer_efficiency() \
                            .items():
                        peers.setdefault(addr, {}).update(eff)
                    # Epidemic broadcast tree membership
                    # (docs/gossip.md): is this peer an eager tree
                    # edge or on the lazy IHAVE plane?
                    for addr, role in node.plumtree_peer_roles() \
                            .items():
                        peers.setdefault(addr, {})["plumtree_edge"] = \
                            role
                    lcr = core.get_last_consensus_round_index()
                    self._json(200, {
                        "engine_state": core.engine_state,
                        "engine_failovers": core.engine_failovers,
                        "last_consensus_round": (
                            -1 if lcr is None else lcr),
                        "round_lag": node.round_lag(),
                        "peers": peers,
                    })
                elif url.path.rstrip("/") == "/debug/capacity":
                    # Capacity observatory (docs/observability.md
                    # "Capacity"): per-subsystem retained bytes,
                    # durable file sizes, cache efficiency, process
                    # RSS/GC, device HBM carries, and the windowed
                    # growth slopes with the ranked top-growers table
                    # and time-to-budget projection. {"enabled":
                    # false} under --no_capacity.
                    self._json(200, service.node.get_capacity_stats())
                elif url.path.rstrip("/") == "/debug/consensus":
                    # Consensus health plane (docs/observability.md
                    # "Consensus health"): chain state + divergence
                    # reports (fork point per peer), round/fame
                    # progress, the stall watchdog's live diagnosis,
                    # and the persisted equivocation evidence.
                    self._json(200, service.node.get_consensus_health())
                elif url.path.rstrip("/") == "/debug/hashgraph":
                    # DAG inspector: a bounded window of the event DAG
                    # (parent edges + round/witness/fame/received
                    # annotations) as JSON. Render it to Graphviz DOT
                    # with `python -m babble_tpu_torch.telemetry.dagdump`.
                    q = parse_qs(url.query)
                    try:
                        from_round = q.get("from", [None])[0]
                        from_round = (int(from_round)
                                      if from_round is not None else None)
                        max_rounds = int(q.get("rounds", ["8"])[0])
                        max_events = int(q.get("limit", ["4096"])[0])
                    except ValueError:
                        self._json(400, {"error": "bad query parameter"})
                        return
                    self._json(200, service.node.core.dag_window(
                        from_round=from_round,
                        max_rounds=max(1, max_rounds),
                        max_events=max(1, min(max_events, 65536))))
                elif url.path.rstrip("/") == "/debug/flame":
                    # In-process flame profile (docs/observability.md
                    # "Saturation"): folded-stack text loadable in
                    # speedscope or flamegraph.pl. With the standing
                    # sampler on (--profile_hz > 0) this renders the
                    # last N seconds of its ring instantly; otherwise
                    # it burst-samples inline for N seconds (this
                    # handler thread sleeps, the node is untouched).
                    from ..telemetry import profiler as _profiler

                    try:
                        q = parse_qs(url.query)
                        secs = float(q.get("seconds", ["1"])[0])
                        secs = min(max(secs, 0.1), 30.0)
                    except ValueError:
                        self._json(400, {"error": "bad seconds"})
                        return
                    sampler = _profiler.active()
                    if sampler is not None:
                        text = sampler.folded(secs)
                    else:
                        text = _profiler.burst_folded(secs)
                    self._send(200, text.encode(),
                               "text/plain; charset=utf-8")
                elif url.path.rstrip("/") == "/debug/profile":
                    # Like the reference's pprof mount, this is an
                    # operator tool: bind service_addr to localhost in
                    # production (docs/usage.md). Each capture reuses
                    # ONE per-service directory (previous trace is
                    # replaced), so repeated calls cannot fill /tmp.
                    #
                    # ?cost=1 skips the profiler and returns per-pass
                    # cost attribution instead: the device engine counts
                    # the operations and bytes of its fused consensus
                    # epilogue from the next pass's shapes (also
                    # exported as babble_engine_pass_flops/
                    # _bytes gauges). 202 while the capture is pending
                    # on an idle node — poll again.
                    try:
                        q = parse_qs(url.query)
                        secs = float(q.get("seconds", ["5"])[0])
                        secs = min(max(secs, 0.1), 30.0)
                    except ValueError:
                        self._json(400, {"error": "bad seconds"})
                        return
                    if q.get("cost", ["0"])[0] not in ("0", ""):
                        report = service.node.core.engine_cost_report(
                            wait_s=secs)
                        if report is None:
                            self._json(400, {
                                "error": "cost attribution needs the "
                                         "device engine (--engine torch)"})
                        elif not report:
                            self._json(202, {"pending": True})
                        else:
                            self._json(200, {"cost": report})
                        return
                    if not service._profile_lock.acquire(blocking=False):
                        self._json(409, {"error": "profile in progress"})
                        return
                    try:
                        import shutil

                        from torch.profiler import ProfilerActivity, profile

                        if service._profile_dir is None:
                            service._profile_dir = tempfile.mkdtemp(
                                prefix="babble-profile-")
                        else:
                            shutil.rmtree(service._profile_dir,
                                          ignore_errors=True)
                            os.makedirs(service._profile_dir,
                                        exist_ok=True)
                        # CPU ops, and the card's kernels when the
                        # node's engine runs on a CUDA device.
                        activities = [ProfilerActivity.CPU]
                        engine = getattr(service.node.core.hg, "engine",
                                         None)
                        if engine is not None and \
                                engine.device.type == "cuda":
                            activities.append(ProfilerActivity.CUDA)
                        with profile(activities=activities) as prof:
                            time.sleep(secs)
                        prof.export_chrome_trace(os.path.join(
                            service._profile_dir, "trace.json"))
                        self._json(200, {"trace_dir": service._profile_dir,
                                         "seconds": secs})
                    except Exception as exc:  # noqa: BLE001
                        self._json(500, {"error": str(exc)})
                    finally:
                        service._profile_lock.release()
                elif url.path.rstrip("/") == "/subscribe":
                    self._handle_subscribe(url)
                elif url.path.rstrip("/") == "/debug/ingress":
                    # Admission-plane table (docs/ingress.md):
                    # admitted/shed/quota counters, the CoDel
                    # controller's live state and delay estimate, the
                    # intake queue snapshot, and the most-recently-
                    # seen clients' token buckets.
                    ingress = getattr(service.node, "ingress", None)
                    if ingress is None:
                        self._json(200, {"admission": False})
                    else:
                        out = {"admission": True}
                        out.update(ingress.debug_table())
                        self._json(200, out)
                else:
                    self._not_found()

            def _handle_subscribe(self, url):
                # Commit-subscription stream (docs/ingress.md):
                # ?tx=<sha256 hex of the raw tx bytes — the digest
                # /submit* returns>. Long-poll by default (200 with
                # the commit record, 204 on timeout); SSE with
                # Accept: text/event-stream or ?sse=1 (heartbeat
                # comments while waiting, one `commit` event, close).
                ingress = getattr(service.node, "ingress", None)
                if ingress is None:
                    self._json(503, {"error": "admission plane disabled "
                                     "(--no_admission)"})
                    return
                q = parse_qs(url.query)
                digest = q.get("tx", [""])[0].strip().lower()
                if len(digest) != 64 or any(
                        c not in "0123456789abcdef" for c in digest):
                    self._json(400, {"error": "tx must be the 64-char "
                                     "sha256 hex digest of the raw "
                                     "transaction bytes"})
                    return
                try:
                    timeout = float(q.get("timeout", ["30"])[0])
                except ValueError:
                    self._json(400, {"error": "bad timeout"})
                    return
                timeout = min(max(timeout, 0.0), 120.0)
                sse = (q.get("sse", ["0"])[0] not in ("0", "")
                       or "text/event-stream"
                       in (self.headers.get("Accept") or ""))
                try:
                    waiter = ingress.lookup_or_register(digest)
                except Exception as exc:  # noqa: BLE001
                    self._json(500, {"error": str(exc)})
                    return
                if waiter is None:
                    # Registry full: shed, never park an unbounded
                    # number of handler threads.
                    ingress.shed_subscriber()
                    self._json(429, {"error": "subscriber registry "
                                     "full", "retry_after": 1},
                               extra={"Retry-After": 1})
                    return
                if not sse:
                    try:
                        if waiter.event.wait(timeout):
                            self._json(200, dict(waiter.result,
                                                 tx=digest))
                        else:
                            self._send(204, b"", "application/json")
                    finally:
                        ingress.subscriptions.unregister(digest, waiter)
                    return
                # SSE: headers first, heartbeat comments while
                # waiting, one `commit` (or `timeout`) event, close.
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                self.send_header("Access-Control-Allow-Origin", "*")
                self.end_headers()
                deadline = time.monotonic() + timeout
                try:
                    while True:
                        left = deadline - time.monotonic()
                        if waiter.event.wait(min(max(left, 0.0), 5.0)):
                            payload = json.dumps(
                                dict(waiter.result, tx=digest))
                            self.wfile.write(
                                f"event: commit\ndata: {payload}\n\n"
                                .encode())
                            self.wfile.flush()
                            return
                        if left <= 0:
                            self.wfile.write(
                                b"event: timeout\ndata: {}\n\n")
                            self.wfile.flush()
                            return
                        self.wfile.write(b": ping\n\n")
                        self.wfile.flush()
                except (BrokenPipeError, ConnectionResetError):
                    pass  # client went away mid-stream
                finally:
                    self.close_connection = True
                    ingress.subscriptions.unregister(digest, waiter)

            # -- intake plumbing (docs/ingress.md) -------------------

            def _client_id(self):
                # Per-client quota key: explicit client id header,
                # falling back to the remote address.
                cid = (self.headers.get("X-Babble-Client") or "").strip()
                return cid or self.client_address[0]

            def _auth_ok(self, cap):
                """Bearer-token gate for /submit* (Config.submit_token;
                constant-time compare). Drains the body (bounded)
                before a 401 so the client never dies on a broken
                pipe mid-send."""
                token = getattr(service.node.conf, "submit_token", "")
                if not token:
                    return True
                header = (self.headers.get("Authorization") or "").strip()
                if hmac.compare_digest(header, "Bearer " + token):
                    return True
                self._drain_body(cap)
                self._json(401, {"error": "unauthorized"},
                           extra={"WWW-Authenticate": "Bearer"})
                return False

            def _drain_body(self, cap):
                """Discard up to ~cap bytes of request body in bounded
                chunks (the PR 4-review EPIPE lesson: responding with
                the body unread breaks the client's pipe mid-send;
                memory must stay capped either way). Past the bound
                the connection is closed instead."""
                try:
                    length = int(self.headers.get("Content-Length", 0))
                except ValueError:
                    length = 0
                remaining = min(length, cap)
                while remaining > 0:
                    chunk = self.rfile.read(min(remaining, 65536))
                    if not chunk:
                        break
                    remaining -= len(chunk)
                if length > cap:
                    self.close_connection = True

            def _read_body(self, cap, what="transaction"):
                """Read the request body with the cap enforced WHILE
                reading — Content-Length is a claim, not a contract:
                chunked bodies are decoded with a running cap, and a
                plain body is read in bounded chunks up to min(length,
                cap). Returns the bytes, or None after answering the
                error itself."""
                te = (self.headers.get("Transfer-Encoding") or "").lower()
                if "chunked" in te:
                    return self._read_chunked(cap, what)
                cl = self.headers.get("Content-Length")
                if cl is None:
                    self._json(411, {"error": "length required"})
                    return None
                try:
                    length = int(cl)
                except ValueError:
                    self._json(400, {"error": "bad Content-Length"})
                    return None
                if length < 0:
                    self._json(400, {"error": "bad Content-Length"})
                    return None
                if length > cap:
                    self._drain_body(cap)
                    self._json(413, {"error": f"{what} too large "
                                     f"(max {cap} bytes)"})
                    return None
                chunks = []
                remaining = length
                while remaining > 0:
                    chunk = self.rfile.read(min(remaining, 65536))
                    if not chunk:
                        break
                    chunks.append(chunk)
                    remaining -= len(chunk)
                return b"".join(chunks)

            def _read_chunked(self, cap, what):
                """Decode a chunked body with a running size cap: a
                client whose chunks sum past the cap gets the 413 at
                the moment of overflow and the connection closed (the
                remainder cannot be skipped without unbounded reads)."""
                total = []
                size_sum = 0
                while True:
                    line = self.rfile.readline(34)
                    if not line:
                        self._json(400, {"error": "truncated chunked body"})
                        self.close_connection = True
                        return None
                    try:
                        size = int(line.strip().split(b";")[0], 16)
                    except ValueError:
                        self._json(400, {"error": "bad chunk header"})
                        self.close_connection = True
                        return None
                    if size == 0:
                        # Consume the trailer section up to the blank
                        # line terminating the body.
                        while True:
                            t = self.rfile.readline(1024)
                            if not t or t in (b"\r\n", b"\n"):
                                break
                        break
                    size_sum += size
                    if size_sum > cap:
                        self.close_connection = True
                        self._json(413, {"error": f"{what} too large "
                                         f"(max {cap} bytes)"})
                        return None
                    remaining = size
                    while remaining > 0:
                        chunk = self.rfile.read(min(remaining, 65536))
                        if not chunk:
                            self._json(400, {"error":
                                             "truncated chunked body"})
                            self.close_connection = True
                            return None
                        total.append(chunk)
                        remaining -= len(chunk)
                    self.rfile.readline(8)  # trailing CRLF
                return b"".join(total)

            def _shed_response(self, res):
                """429 for a fully-rejected request: Retry-After from
                the controller's delay estimate (shed) or the token
                bucket's refill time (quota)."""
                reason = ("quota" if res["quota_rejected"]
                          and not res["shed"] else "overload")
                self._json(429, {
                    "error": "rejected by admission control",
                    "reason": reason,
                    "shed": res["shed"],
                    "quota_rejected": res["quota_rejected"],
                    "retry_after": res["retry_after"],
                }, extra={"Retry-After": res["retry_after"]})

            def _handle_submit(self):
                # Transaction intake without a socket app client: the
                # body is one raw transaction. Used by the crash
                # harness (whose nodes run --journal) and handy for
                # curl-driven demos; like /debug/*, bind service_addr
                # to localhost in production.
                try:
                    if not self._auth_ok(_MAX_SUBMIT_BYTES):
                        return
                    tx = self._read_body(_MAX_SUBMIT_BYTES)
                    if tx is None:
                        return
                    if not tx:
                        self._json(400, {"error": "empty transaction"})
                        return
                    ingress = getattr(service.node, "ingress", None)
                    if ingress is None:
                        # --no_admission: today's bare intake path,
                        # byte-for-byte.
                        service.node.submit_tx(tx)
                        self._json(200, {"submitted": len(tx)})
                        return
                    res = ingress.submit(self._client_id(), [tx])
                    if res["accepted"]:
                        self._json(200, {"submitted": len(tx),
                                         "digest": res["digests"][0]})
                    else:
                        self._shed_response(res)
                except Exception as exc:  # noqa: BLE001
                    self._json(500, {"error": str(exc)})

            def _handle_submit_batch(self):
                # Batched intake: a length-prefixed binary frame
                # (ingress.encode_tx_batch, magic BBB1 following the
                # columnar framing conventions) or a JSON array of
                # base64 transactions. Per-tx statuses come back
                # aligned with the request order.
                try:
                    if not self._auth_ok(_MAX_BATCH_BYTES):
                        return
                    body = self._read_body(_MAX_BATCH_BYTES, what="batch")
                    if body is None:
                        return
                    if not body:
                        self._json(400, {"error": "empty batch"})
                        return
                    try:
                        if body[:4] == TX_BATCH_MAGIC:
                            txs = decode_tx_batch(body, _MAX_SUBMIT_BYTES)
                        else:
                            doc = json.loads(body)
                            if isinstance(doc, dict):
                                doc = doc.get("txs")
                            if not isinstance(doc, list) or not doc:
                                raise ValueError(
                                    "body must be a JSON array of "
                                    "base64 transactions or a BBB1 "
                                    "binary frame")
                            txs = [base64.b64decode(t) for t in doc]
                            for tx in txs:
                                if not tx:
                                    raise ValueError(
                                        "empty transaction in batch")
                                if len(tx) > _MAX_SUBMIT_BYTES:
                                    raise ValueError(
                                        "transaction exceeds "
                                        f"{_MAX_SUBMIT_BYTES} bytes")
                    except Exception as exc:  # noqa: BLE001
                        self._json(400, {"error": f"bad batch: {exc}"})
                        return
                    res = service.node.submit_batch(
                        txs, client=self._client_id())
                    if res["accepted"] == 0 and len(txs) > 0 \
                            and getattr(service.node, "ingress", None) \
                            is not None:
                        self._shed_response(res)
                        return
                    extra = ({"Retry-After": res["retry_after"]}
                             if res["retry_after"] else None)
                    self._json(200, {
                        "submitted": res["accepted"],
                        "shed": res["shed"],
                        "quota_rejected": res["quota_rejected"],
                        "digests": res["digests"],
                        "statuses": res["statuses"],
                        "retry_after": res["retry_after"],
                    }, extra=extra)
                except Exception as exc:  # noqa: BLE001
                    self._json(500, {"error": str(exc)})

            def do_POST(self):  # noqa: N802 - stdlib API
                path = urlparse(self.path).path.rstrip("/")
                if path == "/submit":
                    self._handle_submit()
                elif path == "/submit/batch":
                    self._handle_submit_batch()
                else:
                    self._not_found()

            def do_OPTIONS(self):  # noqa: N802 - CORS preflight
                self.send_response(200)
                self.send_header("Access-Control-Allow-Origin", "*")
                self.send_header(
                    "Access-Control-Allow-Methods", "POST, GET, OPTIONS, PUT, DELETE"
                )
                self.end_headers()

            def log_message(self, fmt, *args):  # silence per-request noise
                pass

        self._server = ThreadingHTTPServer((host, int(port_s)), Handler)
        self.addr = f"{host}:{self._server.server_address[1]}"
        self._thread: threading.Thread | None = None

    def serve(self) -> None:
        """Blocking serve — reference Service.Serve."""
        self._server.serve_forever(poll_interval=0.1)

    def serve_async(self) -> None:
        self._thread = threading.Thread(target=self.serve, daemon=True,
                                        name="babble-service")
        self._thread.start()

    def close(self) -> None:
        self._server.shutdown()
        self._server.server_close()
