"""Open loop over a whole `Node` at `cli.py run`'s defaults, over the
in-process transport, with an `InmemAppProxy` whose deliveries the
benchmark timestamps. The benchmark plays the other n - 1 peers:

- events fall due on the stream's Poisson schedule, in its topological
  order; every `push_interval_s` one peer (the node's tree parent)
  eager-pushes what fell due since its last push (at most `sync_limit`
  events, a plumtree EagerSyncRequest), one push in flight, as an
  eager edge keeps it; a refused push is offered again;
- the node's own RPCs are answered from the same schedule: a pull
  (SyncRequest) or a graft gets the events due that it lacks, at most
  `sync_limit`, in stream order; its digests and prunes are
  acknowledged, and a peer its eager pushes reach acknowledges the push
  and PRUNEs the edge, as a plumtree peer does with an edge that only
  brings what it has (the peers already hold every event the node
  relays, and the node's own events are no parent of theirs).

The run warms up for `warm_s` at the cell's rate, measures for
`seconds`, then keeps the stream going until every transaction due in
the window is committed (at most `drain_s`). A transaction's wait runs
from its event's due time to the CommitBlock that holds it.
"""

from __future__ import annotations

import gc
import math
import queue
import sys
import threading
import time

import numpy as np

import compare
import devtrace
import reference
import stream


def log(msg: str) -> None:
    print(f"[node_loop] {msg}", file=sys.stderr, flush=True)


def cli_config(node: dict, device: str):
    """The Config `cli.py run` builds for these arguments."""
    from babble_tpu_torch.cli import build_parser
    from babble_tpu_torch.node.config import Config

    argv = ["run", "--no_client", "--engine", node["engine"],
            "--engine_device", device, "--cache_size", str(node["cache_size"]),
            "--sync_limit", str(node["sync_limit"])]
    if node["device_verify"]:
        argv.append("--device_verify")
    args = build_parser().parse_args(argv)
    conf = Config(
        heartbeat_timeout=args.heartbeat / 1000.0,
        tcp_timeout=args.tcp_timeout / 1000.0,
        cache_size=args.cache_size,
        sync_limit=args.sync_limit,
        store_type=args.store,
        engine=args.engine,
        engine_mesh=args.engine_mesh,
        consensus_interval=(
            args.consensus_interval / 1000.0
            if args.consensus_interval is not None
            else (0.25 if args.engine == "torch" else 0.0)),
        pipeline_depth=args.pipeline_depth,
        verify_workers=args.verify_workers,
        runtime=args.runtime,
        device_verify=args.device_verify,
        engine_prewarm=not args.no_prewarm,
        breaker_threshold=0 if args.no_breaker else args.breaker_threshold,
        breaker_base_backoff=args.breaker_backoff / 1000.0,
        sync_retries=args.sync_retries,
        engine_failover_threshold=(
            0 if args.no_failover else args.engine_failover_threshold),
        trace_ring=args.trace_ring,
        trace_sample=args.trace_sample,
        profile_hz=args.profile_hz,
        divergence_sentinel=not args.no_sentinel,
        gossip_observatory=not args.no_gossip_observatory,
        capacity=not args.no_capacity,
        stall_timeout=args.stall_timeout / 1000.0,
        wire_format=args.wire_format,
        max_msg_bytes=args.max_msg_bytes << 20,
        compile_cache_dir=args.compile_cache_dir,
        plumtree=not args.no_plumtree,
        eager_fanout=args.eager_fanout,
        ihave_interval=args.ihave_interval / 1000.0,
        graft_timeout=args.graft_timeout / 1000.0,
        anti_entropy_interval=args.anti_entropy_interval / 1000.0,
        admission=not args.no_admission,
        intake_queue=args.intake_queue,
        ingress_target_delay=args.ingress_target_ms / 1000.0,
        quota_rate=args.quota_rate,
        quota_burst=args.quota_burst,
        submit_token=args.submit_token,
        journal_sync=args.journal_sync,
    )
    conf.engine_opts = {"device": args.engine_device}
    return conf


class _Inbox:
    """A peer's end of the in-process transport: what the node sends it
    lands, tagged with its id, in the one queue the peers' thread
    serves."""

    def __init__(self, shared: "queue.Queue", pid: int):
        self._consumer = self
        self._shared, self._pid = shared, pid

    def put(self, rpc, timeout=None):
        self._shared.put((self._pid, rpc), timeout=timeout)


class Peers:
    """The other n - 1 participants: one inbox for every peer address of
    the node, served by one thread; the pusher; and a thread that sends
    the peers' PRUNEs."""

    def __init__(self, st, node_trans, addrs, ids, limit, t0):
        from babble_tpu_torch.net.inmem_transport import InmemTransport

        self.st, self.limit, self.t0 = st, limit, t0
        self.trans = InmemTransport("peers", timeout=node_trans._timeout)
        self.inbox: "queue.Queue" = queue.Queue()
        for a, pid in zip(addrs, ids):
            node_trans.connect(a, _Inbox(self.inbox, pid))
        self.trans.connect(node_trans.local_addr(), node_trans)
        self.node_addr = node_trans.local_addr()
        self.parent = ids[0]
        self.prunes: "queue.Queue" = queue.Queue()
        self.due = st.due_s
        self.pushed = 0  # events the node has taken from the pusher
        self.stop = threading.Event()
        self.errors = []
        self.pulls = 0
        self.relays = 0  # eager pushes the node made to the peers
        self.push_fail = 0

    def due_count(self, now=None) -> int:
        now = time.perf_counter() if now is None else now
        return int(np.searchsorted(self.due, now - self.t0, side="right"))

    def _events(self, ids):
        from babble_tpu_torch.net.columnar import ColumnarEvents

        return ColumnarEvents.decode(self.st.frame_ids(ids))

    def _diff(self, known):
        st = self.st
        p = self.due_count()
        have = np.full(st.n, -1, np.int64)
        for c, i in known.items():
            have[int(c)] = i
        missing = np.nonzero(st.index[:p] > have[st.creator[:p]])[0][:self.limit]
        last = np.full(st.n, -1, np.int64)
        np.maximum.at(last, st.creator[:p], st.index[:p])
        return self._events(missing), {c: int(v) for c, v in enumerate(last)}

    def serve(self):
        from babble_tpu_torch.net import transport as T

        while not self.stop.is_set():
            try:
                pid, rpc = self.inbox.get(timeout=0.05)
            except queue.Empty:
                continue
            cmd = rpc.command
            try:
                if isinstance(cmd, T.SyncRequest):
                    self.pulls += 1
                    events, known = self._diff(cmd.known)
                    resp = T.SyncResponse(pid, events=events, known=known)
                elif isinstance(cmd, T.GraftRequest):
                    events, _ = self._diff(cmd.known)
                    resp = T.GraftResponse(pid, events=events)
                elif isinstance(cmd, T.EagerSyncRequest):
                    self.relays += 1
                    resp = T.EagerSyncResponse(pid, True)
                    self.prunes.put(pid)
                elif isinstance(cmd, T.IHaveRequest):
                    resp = T.IHaveResponse(pid, True)
                elif isinstance(cmd, T.PruneRequest):
                    resp = T.PruneResponse(pid, True)
                else:
                    rpc.respond(None, T.TransportError("unexpected command"))
                    continue
                rpc.respond(resp, None)
            except Exception as exc:  # noqa: BLE001 - recorded, run fails
                self.errors.append(f"{type(exc).__name__}: {exc}")
                rpc.respond(None, T.TransportError(str(exc)))

    def prune(self):
        """PRUNE each edge the node eager-pushes on, once a push."""
        from babble_tpu_torch.net import transport as T

        while not self.stop.is_set():
            try:
                pid = self.prunes.get(timeout=0.05)
            except queue.Empty:
                continue
            try:
                self.trans.prune(self.node_addr, T.PruneRequest(pid))
            except T.TransportError:
                pass  # the node is busy or stopping: its next push asks again

    def push(self, interval):
        from babble_tpu_torch.net import transport as T

        tick = self.t0
        while not self.stop.is_set():
            tick += interval
            wait = tick - time.perf_counter()
            if wait > 0:
                self.stop.wait(wait)
            elif wait < -interval:
                tick = time.perf_counter()  # behind: push at once
            hi = min(self.due_count(), self.pushed + self.limit)
            if hi <= self.pushed:
                continue
            req = T.EagerSyncRequest(self.parent, self._events(
                np.arange(self.pushed, hi)), plum=True)
            try:
                resp = self.trans.eager_sync(self.node_addr, req)
            except T.TransportError:
                self.push_fail += 1
                continue
            if resp.success:
                self.pushed = hi
            else:
                self.push_fail += 1


def run(cfg, traffic, seed, seconds, trace, device, t_start):
    import torch

    from babble_tpu_torch import crypto
    from babble_tpu_torch.hashgraph import InmemStore
    from babble_tpu_torch.net.columnar import ColumnarEvents
    from babble_tpu_torch.net.inmem_transport import InmemTransport
    from babble_tpu_torch.net.peer import Peer
    from babble_tpu_torch.node import core as core_mod
    from babble_tpu_torch.node.core import Core
    from babble_tpu_torch.node.node import Node
    from babble_tpu_torch.proxy.inmem_app_proxy import InmemAppProxy
    from babble_tpu_torch.telemetry import Registry

    node_cfg = cfg["node"]
    cuda = device == "cuda"
    rate = float(traffic["rate_events_per_s"])
    warm_s, drain_s = float(traffic["warm_s"]), float(traffic["drain_s"])
    t0 = time.perf_counter()
    total = int(math.ceil(rate * (warm_s + seconds + drain_s)))
    st = stream.generate(cfg, total, seed, rate=rate,
                         topology_seed=traffic.get("topology_seed"))
    log(f"stream: {st.e} events at {rate:g}/s in {time.perf_counter() - t0:.2f} s")
    gc.collect()
    gc.freeze()
    index = {h: i for i, h in enumerate(st.hexes)}

    conf = cli_config(node_cfg, device)
    key = crypto.key_from_seed(st.node_key - 1)
    pubs_hex = sorted(st.participants, key=st.participants.get)
    addrs = [f"peer{i}" for i in range(st.n)]
    addrs[st.silent] = "node"
    peers = [Peer(net_addr=a, pub_key_hex=h) for a, h in zip(addrs, pubs_hex)]
    store = InmemStore(st.participants, conf.cache_size)
    trans = InmemTransport("node", timeout=conf.tcp_timeout)
    commits = []  # (perf_counter, round received, txs)

    class Proxy(InmemAppProxy):
        def commit_block(self, block):
            commits.append((time.perf_counter(), block.round_received,
                            list(block.transactions or [])))

    # Set-up: a scratch Core of the same width takes a few syncs of the
    # stream, so the process's first passes and verifies (the kernel
    # libraries, the library handles, every kernel's first load) are paid
    # before the stream starts; the node under test starts fresh.
    t0 = time.perf_counter()
    scratch = Core(st.silent, key, st.participants,
                   InmemStore(st.participants, conf.cache_size), engine=conf.engine,
                   engine_opts=dict(conf.engine_opts), device_verify=conf.device_verify,
                   registry=Registry())
    scratch.init()
    warm_n = min(int(traffic["scratch_events"]), st.e)
    for lo in range(0, warm_n, int(node_cfg["sync_limit"])):
        scratch.sync(ColumnarEvents.decode(
            st.frame(lo, min(lo + int(node_cfg["sync_limit"]), warm_n))))
        scratch.run_consensus()
    scratch.hg.close()
    del scratch
    gc.collect()
    log(f"scratch warm-up: {time.perf_counter() - t0:.2f} s")
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    node = Node(conf, st.silent, key, peers, store, trans, Proxy())
    core = node.core
    walls = []  # (dispatch perf_counter, pass wall s)
    dispatch, collect = core.dispatch_consensus, core.collect_consensus
    inflight = {}

    def dispatch_timed(*a, **kw):
        t = time.perf_counter()
        pp = dispatch(*a, **kw)
        if pp is not None:
            inflight[id(pp)] = t
        return pp

    def collect_timed(pp, *a, **kw):
        out = collect(pp, *a, **kw)
        t = inflight.pop(id(pp), None)
        if t is not None:
            walls.append((t, time.perf_counter() - t))
        return out

    core.dispatch_consensus, core.collect_consensus = dispatch_timed, collect_timed
    spans = devtrace.HostSpans()
    if trace:
        verify_events = core_mod.verify_events
        core_mod.verify_events = spans.wrap("verify", verify_events)
        core.sync = spans.wrap("sync", core.sync)
        core.dispatch_consensus = spans.wrap("dispatch", core.dispatch_consensus)
        core.collect_consensus = spans.wrap("collect", core.collect_consensus)
    node.init()

    prof = devtrace.DeviceTrace(cuda) if trace else None
    if prof is not None:
        prof.start()  # its own start-up stays out of the window
    ids = [i for i in range(st.n) if i != st.silent]
    t_stream = time.perf_counter() + 0.5
    fab = Peers(st, trans, [addrs[i] for i in ids], ids, int(node_cfg["sync_limit"]),
                t_stream)
    threads = [threading.Thread(target=fab.serve, name="bench-peers", daemon=True),
               threading.Thread(target=fab.prune, name="bench-prunes", daemon=True),
               threading.Thread(target=fab.push, args=(float(traffic["push_interval_s"]),),
                                name="bench-pusher", daemon=True)]
    for t in threads:
        t.start()
    node_thread = node.run_async()

    def phases():
        return {k: list(v) for k, v in core.phase_ns.items()}

    def snapshot():
        return {"due": fab.due_count(), "pushed": fab.pushed,
                "ordered": core.get_consensus_events_count(),
                "inserted": core.hg.engine.e}

    t_w0 = t_stream + warm_s
    time.sleep(max(t_w0 - time.perf_counter(), 0))
    setup_s = time.perf_counter() - t_start
    if prof is not None:
        prof.t0_ns = time.time_ns()
        spans.on = True
    ph0, snap0, n_walls0 = phases(), snapshot(), len(walls)
    t_w1 = t_w0 + seconds
    trace_s = min(float(traffic.get("trace_s", seconds)), seconds)
    if prof is not None:
        time.sleep(max(t_w0 + trace_s - time.perf_counter(), 0))
        spans.on = False
        prof.stop()
    time.sleep(max(t_w1 - time.perf_counter(), 0))
    ph1, snap1 = phases(), snapshot()
    # the peak so far over the events the engine holds at the window's end
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    window_walls = [w for t, w in walls[n_walls0:] if t < t_w1]
    window_passes = sum(1 for t, _ in walls[n_walls0:] if t < t_w1)

    # Transactions due in the window: wait for each (the stream goes on).
    due_lo = int(np.searchsorted(st.due_s, t_w0 - t_stream, side="left"))
    due_hi = int(np.searchsorted(st.due_s, t_w1 - t_stream, side="left"))
    want = {tx for i in range(due_lo, due_hi) for tx in st.txs[i]}
    committed = {}
    deadline = t_w1 + drain_s
    k = 0
    while True:
        while k < len(commits):
            t, _, txs = commits[k]
            for tx in txs:
                committed.setdefault(tx, t)
            k += 1
        if want.issubset(committed.keys()) or time.perf_counter() > deadline:
            break
        time.sleep(0.05)
    t_end = time.perf_counter()
    fab.stop.set()
    for t in threads:
        t.join(timeout=10)
    # The node's outputs, read under its core lock while it still runs.
    with node.core_lock:
        cap = compare.capture(core, st.hexes, [reference.block_bytes(r, txs)
                                               for _, r, txs in list(commits)])
    node.shutdown()
    node_thread.join(timeout=10)
    core.hg.close()
    while k < len(commits):
        t, _, txs = commits[k]
        for tx in txs:
            committed.setdefault(tx, t)
        k += 1

    def event_of(tx: bytes) -> int:
        return int(tx.split(b" ")[1][1:])

    waits, missing = [], 0
    for tx in want:
        t = committed.get(tx)
        if t is None:
            missing += 1
            t = t_end
        waits.append(t - (t_stream + st.due_s[event_of(tx)]))
    log(f"window: {len(want)} txs due, {missing} uncommitted after a drain of "
        f"{t_end - t_w1:.2f} s; snapshots {snap0} "
        f"-> {snap1}; {window_passes} passes; pushes failed {fab.push_fail}, "
        f"pulls {fab.pulls}, node's pushes {fab.relays}; peer errors {fab.errors[:1]}")

    phase_sum = {k: [v[1] - ph0.get(k, [0, 0, 0])[1], v[2] - ph0.get(k, [0, 0, 0])[2]]
                 for k, v in ph1.items()}
    rec = {"window_s": seconds, "setup_s": setup_s, "commit_waits_s": waits,
           "job_bytes": [(peak, snap1["inserted"], snap1["inserted"])],
           "phase_ns": phase_sum,
           "events_synced": snap1["inserted"] - snap0["inserted"],
           "events_verified": snap1["inserted"] - snap0["inserted"],
           "pass_walls_s": window_walls, "window_passes": window_passes,
           "snapshots": [snap0, snap1], "memory_peak_bytes": peak,
           "attempted": len(want), "failed": missing,
           "device_kind": torch.cuda.get_device_name(0) if cuda else device}
    if trace:
        rec["trace"] = devtrace.summarize(prof, spans.spans)
        core_mod.verify_events = verify_events

    held, rounds, first = cap["held"], cap["rounds"], cap["first"]
    fed = int(np.nonzero(held)[0].max()) + 1 if held.any() else 0
    del node, core, store
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ref = reference.consensus(st, device=device)
    passed = int(np.nonzero(rounds >= 0)[0].max()) + 1 if (rounds >= 0).any() else 0
    ref_trim = ref
    if first:
        # the store keeps the newest consensus events only: compare from there
        ref_trim = reference.Result(ref.rounds, ref.rr, ref.cts_ns, ref.order[first:],
                                    ref.blocks, ref.block_rr)
    # No floor from a second reference here: every transaction due in
    # the window must have been committed (window_txs_uncommitted).
    diff = compare.compare(cap, ref_trim, st.hexes, index, fed, 0, blocks_prefix=True)
    log(f"reference: {len(ref.order)} of {st.e} ordered; the node ordered "
        f"{first + len(cap['order'])} with {passed} events passed ({fed} taken); "
        f"{time.perf_counter() - t0:.2f} s")
    rec["checks"] = [(k, diff[k], 0) for k in compare.NUMBERS]
    rec["checks"].append(("window_txs_uncommitted", missing, 0))
    rec["checks"].append(("peer_errors", len(fab.errors), 0))
    rec["ok"] = True
    return rec
