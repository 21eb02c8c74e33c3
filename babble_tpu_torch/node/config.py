"""Node runtime configuration — reference node/config.go:12-61.

Durations are seconds (floats) rather than Go time.Duration."""

from __future__ import annotations

import logging
from dataclasses import dataclass, field


def _default_logger() -> logging.Logger:
    return logging.getLogger("babble_tpu_torch")


@dataclass
class Config:
    heartbeat_timeout: float = 1.0
    tcp_timeout: float = 1.0
    cache_size: int = 500
    sync_limit: int = 100
    store_type: str = "inmem"  # "inmem" | "file"
    store_path: str = ""
    # Durable-store fsync policy (FileStore, docs/robustness.md "Crash
    # recovery"): "always" fsyncs the WAL on every commit (survives
    # power loss), "batch" (default) fsyncs at WAL checkpoints —
    # commits stay atomic under kill -9 either way — and "off" skips
    # fsyncs entirely (fastest; atomic under process death, not power
    # loss).
    store_sync: str = "batch"  # "always" | "batch" | "off"
    # Gossip sync payload encoding (docs/ingest.md "Wire layout"):
    # "columnar" packs a sync batch as contiguous per-field columns
    # (binary frames on TCP, negotiated per peer with transparent
    # legacy fallback); "gojson" pins the reference's per-event
    # Go-JSON dicts. Either side of a mixed cluster accepts both, so
    # the knob only controls what THIS node sends/serves.
    wire_format: str = "columnar"
    # Cap on any single gossip RPC message (one JSON line or one binary
    # columnar frame, either direction): a misbehaving peer hits a
    # clear TransportError instead of growing an unbounded buffer.
    max_msg_bytes: int = 32 << 20
    # -- epidemic broadcast tree (docs/gossip.md) ----------------------
    # Plumtree-style two-tier dissemination: fresh events (own
    # self-events and first-seen inserts) are eager-pushed immediately
    # along a per-node set of eager peers forming a lazily-repaired
    # spanning tree; the remaining (lazy) peers receive compact IHAVE
    # digests and pull gaps via GRAFT (which promotes the edge back to
    # eager), while duplicate eager deliveries answer with PRUNE
    # (demoting the redundant edge). The periodic pull loop stays on as
    # a low-frequency anti-entropy backstop. False restores the
    # reference's pull-only random gossip byte-for-byte (--no_plumtree
    # kill switch): no tree state, no IHAVE/GRAFT/PRUNE RPCs, the
    # heartbeat loop pulls every tick.
    plumtree: bool = True
    # Eager fan-out: how many peers this node pushes fresh events to.
    # 0 = auto (~log2(n), capped at 4 — enough for an O(log n)-depth
    # tree whose union is connected w.h.p. while keeping the pre-prune
    # redundancy bounded).
    eager_fanout: int = 0
    # Min seconds between eager pushes to ONE peer: the coalescing
    # window that batches cascade relays instead of sending one RPC
    # per event. 0 = auto (heartbeat_timeout capped at 25 ms, so a
    # production 1 s heartbeat still propagates in ~25 ms hops).
    eager_push_interval: float = 0.0
    # Per-peer in-flight window for eager pushes: at most this many
    # outstanding push RPCs per peer; beyond it fresh events buffer
    # (bounded) and a consistently-full peer is shed to lazy instead
    # of queueing behind it.
    plumtree_inflight: int = 2
    # Seconds between IHAVE digest announcements to lazy peers
    # (digests coalesce across the interval; chunked under
    # max_msg_bytes).
    ihave_interval: float = 0.25
    # Seconds a digest-announced event may stay missing before the
    # node GRAFTs it from an announcer (promoting that edge to eager).
    # The timer is what lets the eager path deliver first — a GRAFT
    # only fires for genuine tree holes.
    graft_timeout: float = 0.35
    # Seconds between anti-entropy pull rounds while plumtree is on
    # (the known-map SyncRequest loop of the reference, demoted to a
    # low-cadence backstop that catches anything the tree and the
    # IHAVE plane both lost). Known-map pulls are exact diffs — the
    # legacy redundancy came from the round-trailing PUSH leg, which
    # plumtree removes — so a sub-second backstop stays cheap while
    # bounding worst-case delivery latency when the eager plane sheds
    # under load.
    anti_entropy_interval: float = 0.25
    # Consensus engine: "torch" (the port's batched device pipeline,
    # TorchHashgraph on CUDA, behind the same seam; the default, so a
    # node of the port runs on the card unless asked otherwise) or
    # "host" (incremental reference-semantics Python).
    engine: str = "torch"
    # Devices for the torch engine's resident state: 0/1 = single
    # device; d > 1 splits the engine's O(E·n) carries into d shards
    # under one controller (ops/mesh.py), shard p on cuda:(p mod the
    # card count), so DAG capacity scales with local cards.
    engine_mesh: int = 0
    # Minimum seconds between consensus passes. 0 = reference behavior
    # (RunConsensus after every sync, node/node.go:467-487). With the
    # device engine each pass costs a device round trip and holds the
    # core lock, so batching several syncs per pass keeps gossip at
    # wire speed while consensus drains the backlog in device-sized
    # batches — ordering is unaffected (consensus is deterministic in
    # the DAG, not in when it runs), only commit latency trades off.
    consensus_interval: float = 0.0
    # Ingest flow control for the batched engine: when the engine's
    # unprocessed-event backlog exceeds this, syncs/pushes/self-events
    # wait (lock-free sleep) for the consensus worker to drain. Without
    # it gossip can outrun consensus — the undecided window then grows
    # past the LRU store's working set (evicting events FindOrder still
    # needs) and the device round/fame windows balloon into recompiles.
    # The reference needs no such bound because its gossip is fully
    # serialized with RunConsensus (node/node.go:467-487).
    engine_backlog_limit: int = 1024
    # Worker pool for batched sync-ingest signature verification
    # (docs/ingest.md): Core.sync materializes a whole sync batch, then
    # ECDSA-checks it on a process-global pool with the core lock
    # RELEASED, so gossip serving continues while a batch grinds.
    # < 0 = auto (one worker per core, capped at 8); 0/1 = verify
    # inline on the syncing thread (still outside the lock).
    verify_workers: int = -1
    # Execution runtime for the heavy ingest planes (docs/runtime.md):
    # "threads" (default) keeps signature verification on the
    # process-global thread pool; "procs" moves verification — and the
    # large-frame columnar decode — to spawned worker PROCESSES fed
    # over multiprocessing.shared_memory, so the planes run off-GIL
    # and can use a second core. Verdict/failure-position semantics
    # are identical between the two (tests/test_runtime.py pins it);
    # worker telemetry is scraped over a pipe and merged into /metrics
    # with a process label. Falls back to "threads" silently where
    # process spawn or /dev/shm is unavailable.
    runtime: str = "threads"
    # Device-side signature verification (docs/ingest.md "Crypto
    # plane"): route each sync batch's ECDSA checks to the ops/p256.py
    # CUDA kernel (csrc/p256.cu) instead of the host verify pool, on
    # the engine's device (engine_opts["device"]), which the consensus
    # engine already owns. Verdicts are parity-pinned bit-for-bit
    # against the host backends. Off by default (the flag doubles as
    # the kill switch); a kernel failure raises, with no host fallback.
    device_verify: bool = False
    # Consensus pipeline depth for the device engine (requires
    # consensus_interval > 0). 0 = synchronous: each worker wake runs
    # dispatch + collect back to back (the host blocks on the device
    # round trip). 1 = overlapped (default): the worker dispatches a
    # pass and returns; the commit delta is collected on the NEXT wake,
    # so the device computes pass k while gossip stages the appends of
    # pass k+1 (double-buffered in the engine) — the device round trip
    # leaves the hot path entirely. Depths > 1 are reserved: pass k+1's
    # window inputs read pass k's committed result carries, so only one
    # pass can be in flight per engine.
    pipeline_depth: int = 1
    # Compilation cache directory of the reference's XLA engine. The
    # torch engine has no compile cache (its kernel library builds into
    # build/kernels/), so the port reads this field nowhere.
    compile_cache_dir: str = ""
    # Compile the device engine's cold-start kernel ladder at node
    # construction (IncrementalEngine.prewarm) instead of stalling the
    # first live syncs on it. Skipped automatically when the scratch
    # sibling engine would transiently exceed the prewarm memory
    # budget (very large n).
    engine_prewarm: bool = True
    # -- fault tolerance (docs/robustness.md) --------------------------
    # Per-peer circuit breaker (HealthTrackingPeerSelector): a peer
    # failing breaker_threshold consecutive syncs is suspended for a
    # jittered exponential backoff (base..max seconds, doubling per
    # trip), then probed once before reinstatement. threshold <= 0
    # disables health tracking (reference RandomPeerSelector behavior:
    # a dead peer is re-selected forever, burning a gossip slot on a
    # full transport timeout each time).
    breaker_threshold: int = 3
    breaker_base_backoff: float = 0.5
    breaker_max_backoff: float = 30.0
    breaker_jitter: float = 0.2
    # Bounded retry for the gossip pull path. Pulls are idempotent
    # (event inserts are hash-deduped, Core.sync skips duplicates), so
    # a transient transport failure is retried up to sync_retries times
    # with jittered exponential backoff before the round is abandoned
    # and the failure reported to the breaker. 0 = fail fast.
    sync_retries: int = 1
    sync_retry_backoff: float = 0.05
    # Engine failover watchdog: after this many CONSECUTIVE device-pass
    # failures (dispatch or collect raising) the node rebuilds consensus
    # state on the host engine from the store and keeps babbling —
    # byte-identical order is preserved (both engines agree), only
    # throughput degrades. Surfaced in get_stats() as
    # engine_state/engine_failovers. <= 0 disables failover: a failing
    # device engine then logs every interval and commits nothing. The
    # port's default is 0, so a kernel fault on the card stops consensus
    # instead of moving it to the CPU; failover is opt-in.
    engine_failover_threshold: int = 0
    # -- telemetry (docs/observability.md) -----------------------------
    # Capacity of the span ring buffer behind /debug/trace: the last N
    # sync / consensus-pass / commit / fast-forward / failover spans,
    # exported as Perfetto-loadable Chrome trace JSON. One deque append
    # per span — cheap enough to leave on; 0 disables recording.
    trace_ring: int = 4096
    # End-to-end transaction tracing sample rate in [0, 1]: a sampled
    # transaction gets a trace id at submit intake; the id rides the
    # wire event across gossip hops and every touchpoint (submit,
    # gossip send/recv, consensus pass, CommitBlock) drops a Chrome
    # flow event into the span ring, so a tracemerge'd Perfetto view
    # shows exactly where that tx's commit latency went. 0 (default)
    # disables sampling entirely — stamping and flow emission are
    # no-ops and the wire form is byte-identical to the untraced one.
    # TRACE_SAMPLE_DEFAULT is the documented rate for "turn it on":
    # roughly one traced tx per thousand, measured within the 5%
    # overhead bar (docs/observability.md).
    trace_sample: float = 0.0
    # -- consensus health (docs/observability.md "Consensus health") ---
    # Divergence sentinel: a rolling chained hash over the committed
    # block stream, piggybacked on gossip sync RPCs (sidecar field,
    # legacy wire form unchanged) and compared against peers' claims —
    # a mismatch at a common index fires babble_divergence_total, a
    # structured-log alarm, and a /debug/consensus report naming the
    # fork point. One sha256 per committed block + one dict compare
    # per gossip round; measured within the 5% bar
    # (bench.py --health-overhead). False disables the chain, the
    # piggyback, and the comparison entirely.
    divergence_sentinel: bool = True
    # Gossip efficiency observatory (docs/observability.md "Gossip
    # efficiency"): per-sync redundancy classification (offered vs
    # new vs duplicate vs stale-window events, exported per peer and
    # leg), the known-map bookkeeping phase timer, the creation-stamp
    # wire sidecar on self-events, and the propagation-latency
    # histogram. One classification pass + a couple of counter incs
    # per sync and one clock stamp per self-event — measured within
    # the 5% bar (bench.py --gossip-overhead). False disables all of
    # it: no counters, no stamps (wire forms byte-identical to the
    # pre-observatory encoding), no propagation histogram samples.
    gossip_observatory: bool = True
    # -- capacity observatory (docs/observability.md "Capacity") ------
    # Per-subsystem retained-byte accounting, state-growth slopes and
    # the /debug/capacity surface. All sizers are scrape-time lazy
    # (Gauge.set_fn) — nothing runs unless something scrapes — and the
    # few hot-path carries are plain int increments, measured within
    # the 5% bar (bench.py --capacity-overhead). False unregisters the
    # whole family: no babble_mem_bytes / babble_growth_* series, no
    # growth model, and /debug/capacity answers {"enabled": false}.
    capacity: bool = True
    # -- saturation observatory (docs/observability.md "Saturation") ---
    # In-process sampling profiler rate (Hz). 0 (default) = fully off:
    # no sampler thread, no ring, a strict no-op on the hot path.
    # > 0 starts one process-global stack sampler over
    # sys._current_frames() whose ring serves GET /debug/flame as
    # folded-stack text; the documented "on" rate is 99 Hz, measured
    # within the 5% bar (bench.py --profile-overhead).
    profile_hz: float = 0.0
    # Capacity of the commit channel (decided blocks waiting for
    # CommitBlock; reference node/node.go's commitCh buffer of 400).
    # Full = the consensus thread blocks, the backpressure that keeps
    # a slow app proxy from ballooning memory.
    commit_queue: int = 400
    # Capacity of the serialized work queue feeding the background
    # worker (rpc/tx/block forwarding). Full = the forwarders block,
    # propagating backpressure to the transport consumer queues
    # instead of growing an unbounded backlog.
    work_queue: int = 4096
    # -- ingress (docs/ingress.md) -------------------------------------
    # The admission plane in front of transaction intake: per-client
    # token-bucket quotas, a CoDel-style adaptive load shedder driven
    # by the live queue sojourn gauges, the bounded instrumented
    # intake queue, and the /subscribe commit-notification registry.
    # False (--no_admission kill switch) restores the bare pre-ingress
    # intake byte-for-byte: /submit feeds submit_ch directly, no
    # quotas, no shedding, no subscriptions.
    admission: bool = True
    # Capacity of the bounded intake queue between the HTTP tier and
    # the work queue (exported as babble_queue_*{queue="intake"}).
    # Full = the shed counter ticks (reason intake_full), never an
    # unbounded buffer.
    intake_queue: int = 8192
    # CoDel target sojourn (seconds): standing pipeline delay (oldest
    # entry across intake/work/commit_ch) above this for a full
    # interval starts shedding with 429 + Retry-After; delay back
    # under target stops it. Not a fixed depth cap — burst absorption
    # is free, only *standing* delay sheds.
    ingress_target_delay: float = 0.2
    # CoDel control interval (seconds): how long delay must stand
    # above target before the first shed, and the base of the
    # interval/sqrt(n) shed ramp.
    ingress_interval: float = 0.5
    # Per-client submission quota (transactions/second, token bucket
    # keyed by the X-Babble-Client header falling back to the remote
    # address). 0 = unlimited (no quota plane).
    quota_rate: float = 0.0
    # Token-bucket burst capacity. 0 = auto (2s of quota_rate,
    # floor 64).
    quota_burst: float = 0.0
    # Optional bearer token for POST /submit*: when set, requests
    # must carry "Authorization: Bearer <token>" (constant-time
    # compare; 401 JSON on mismatch). Empty = open intake (the
    # documented localhost-binding guard).
    submit_token: str = ""
    # Max concurrent parked /subscribe waiters; beyond it the
    # endpoint sheds (reason "subscribers") instead of accumulating
    # blocked handler threads.
    subscribe_cap: int = 256
    # FileAppProxy journal fsync policy (--journal): "always" fsyncs
    # every committed block; "batch" (default) fsyncs when the commit
    # burst drains — one fsync per intake batch, same policy family
    # as store_sync. Both are torn-tail-safe under kill -9 (the
    # journal write+flush lands in the page cache); "always" adds
    # power-loss durability per block.
    journal_sync: str = "batch"  # "always" | "batch"
    # Stall watchdog: when payload events are pending but no consensus
    # round has decided for this many seconds, emit a diagnosis (which
    # round is stuck, which witnesses are undecided, which creators
    # went silent) to the log and /debug/consensus, clearing when a
    # round decides. 0 disables the watchdog thread.
    stall_timeout: float = 30.0
    logger: logging.Logger = field(default_factory=_default_logger)


# The documented "on" rate for --trace_sample (see Config.trace_sample).
TRACE_SAMPLE_DEFAULT = 0.001


def test_config(heartbeat: float = 0.005, cache_size: int = 10000) -> Config:
    """Fast-heartbeat inmem config for tests — reference
    node/config.go:56-61."""
    return Config(
        heartbeat_timeout=heartbeat,
        tcp_timeout=0.5,
        cache_size=cache_size,
        sync_limit=1000,
        store_type="inmem",
    )
