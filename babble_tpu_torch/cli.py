"""The babble CLI: keygen | run | version.

Reference cmd/babble/main.go:27-290 — same 13 flags, same datadir
conventions (priv_key.pem + peers.json), same startup sequence: load
key, load peers, assign participant ids by sorted-pubkey order, build
store/transport/proxy/node/service, run.

Usage: python -m babble_tpu_torch.cli run --datadir /path --node_addr ...
"""

from __future__ import annotations

import argparse
import logging
import os
import signal
import sys

from . import __version__, crypto
from .crypto.pem import PemKey, generate_pem_key
from .hashgraph import FileStore, InmemStore
from .net import JSONPeers, TCPTransport, sort_peers_by_pub_key
from .node import Config, Node
from .proxy import FileAppProxy, InmemAppProxy, SocketAppProxy
from .service import Service

DEFAULT_NODE_ADDR = "127.0.0.1:1337"
DEFAULT_PROXY_ADDR = "127.0.0.1:1338"
DEFAULT_CLIENT_ADDR = "127.0.0.1:1339"
DEFAULT_SERVICE_ADDR = "127.0.0.1:8000"


def default_datadir() -> str:
    # reference cmd/babble/main.go defaultDataDir(): ~/.babble
    return os.path.join(os.path.expanduser("~"), ".babble_tpu")


def cmd_keygen(args) -> int:
    pem_dump = generate_pem_key()
    print(f"PublicKey: {pem_dump.public_key}")
    if args.datadir:
        os.makedirs(args.datadir, exist_ok=True)
        path = os.path.join(args.datadir, "priv_key.pem")
        with open(path, "w") as f:
            f.write(pem_dump.private_key)
        print(f"written to {path}")
    else:
        sys.stdout.write(pem_dump.private_key)
    return 0


def cmd_version(_args) -> int:
    print(__version__)
    return 0


def cmd_run(args) -> int:
    logging.basicConfig(
        level=getattr(logging, args.log_level.upper(), logging.INFO),
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
    )
    logger = logging.getLogger("babble_tpu_torch")
    json_fmt = None
    if args.log_format == "json":
        # Structured logs (docs/observability.md): one JSON object per
        # line with node-id and span-id fields, so multi-node harness
        # logs merge into one machine-sortable stream. The node id is
        # backfilled below once the key identifies us.
        from .telemetry import use_json_logging

        json_fmt = use_json_logging(logging.getLogger())

    datadir = args.datadir
    key = PemKey(datadir).read_key()
    peers = sort_peers_by_pub_key(JSONPeers(datadir).peers())
    pmap = {p.pub_key_hex: i for i, p in enumerate(peers)}

    my_pub = "0x" + crypto.pub_key_bytes(key).hex().upper()
    if my_pub not in pmap:
        print(f"error: public key {my_pub[:20]}… not found in peers.json",
              file=sys.stderr)
        return 1
    node_id = pmap[my_pub]
    if json_fmt is not None:
        json_fmt.node_id = node_id

    conf = Config(
        heartbeat_timeout=args.heartbeat / 1000.0,
        tcp_timeout=args.tcp_timeout / 1000.0,
        cache_size=args.cache_size,
        sync_limit=args.sync_limit,
        store_type=args.store,
        store_path=args.store_path or os.path.join(datadir, "store.db"),
        store_sync=args.store_sync,
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
        logger=logger,
    )
    # The torch engine's device: CUDA unless --engine_device names
    # another; with no CUDA device Core raises, and run exits below.
    conf.engine_opts = {"device": args.engine_device}

    needs_bootstrap = False
    if conf.store_type == "file":
        if os.path.exists(conf.store_path):
            # --bootstrap is the explicit Go-reference spelling; an
            # existing database implies it either way (the create path
            # refuses populated files).
            store = FileStore.load(
                conf.cache_size, conf.store_path, sync=conf.store_sync)
            needs_bootstrap = True
        else:
            store = FileStore(
                pmap, conf.cache_size, conf.store_path, sync=conf.store_sync)
    else:
        if args.bootstrap:
            print("error: --bootstrap requires --store file",
                  file=sys.stderr)
            return 1
        store = InmemStore(pmap, conf.cache_size)

    trans = TCPTransport(
        args.node_addr, max_pool=args.max_pool, timeout=conf.tcp_timeout,
        wire_format=conf.wire_format, max_msg_bytes=conf.max_msg_bytes,
    )

    if args.journal:
        proxy = FileAppProxy(args.journal, sync=args.journal_sync)
    elif args.no_client:
        proxy = InmemAppProxy()
    else:
        proxy = SocketAppProxy(
            args.client_addr, args.proxy_addr, timeout=conf.tcp_timeout
        )

    try:
        node = Node(conf, node_id, key, peers, store, trans, proxy)
    except (ValueError, RuntimeError) as exc:
        # No engine to run on (--engine tpu, or no CUDA device without
        # --engine_device cpu): refuse, never carry on on the CPU.
        print(f"error: {exc}", file=sys.stderr)
        trans.close()
        store.close()
        close = getattr(proxy, "close", None)
        if close is not None:
            close()
        return 1
    node.init(bootstrap=needs_bootstrap)

    service = Service(args.service_addr, node)
    service.serve_async()
    logger.info(
        "node %d on %s (service %s, store %s, sync %s)",
        node_id, trans.local_addr(), service.addr, conf.store_type,
        conf.store_sync,
    )

    # Graceful shutdown on SIGTERM/SIGINT: the handler only requests
    # the state change — run() observes it and returns, and the
    # finally below does the real teardown (drain the in-flight
    # consensus pass, deliver queued blocks, flush/commit the store,
    # close it). Doing the teardown inside the signal frame would race
    # the main loop; before this handler a SIGTERM simply killed the
    # process and could drop a staged batch on the floor.
    def request_shutdown(signum, _frame):
        logger.info("signal %d: shutting down", signum)
        from .node.state import NodeState

        node.state.set_state(NodeState.SHUTDOWN)
        node._shutdown.set()

    signal.signal(signal.SIGTERM, request_shutdown)
    signal.signal(signal.SIGINT, request_shutdown)

    try:
        node.run(gossip=True)
    except KeyboardInterrupt:
        pass
    finally:
        node.shutdown()
        service.close()
        close = getattr(proxy, "close", None)
        if close is not None:
            close()
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="babble_tpu_torch", description=__doc__)
    sub = p.add_subparsers(dest="command", required=True)

    kg = sub.add_parser("keygen", help="create new key pair")
    kg.add_argument("--datadir", default="", help="write priv_key.pem here")
    kg.set_defaults(fn=cmd_keygen)

    rn = sub.add_parser("run", help="run a babble node")
    rn.add_argument("--datadir", default=default_datadir(),
                    help="directory with priv_key.pem and peers.json")
    rn.add_argument("--node_addr", default=DEFAULT_NODE_ADDR,
                    help="IP:Port to bind the gossip transport")
    rn.add_argument("--no_client", action="store_true",
                    help="run without an app client (inmem proxy)")
    rn.add_argument("--proxy_addr", default=DEFAULT_PROXY_ADDR,
                    help="IP:Port to bind the app proxy server")
    rn.add_argument("--client_addr", default=DEFAULT_CLIENT_ADDR,
                    help="IP:Port of the app client")
    rn.add_argument("--service_addr", default=DEFAULT_SERVICE_ADDR,
                    help="IP:Port to bind the HTTP service")
    rn.add_argument("--log_level", default="info",
                    help="debug, info, warn, error")
    rn.add_argument("--log_format", default="text",
                    choices=["text", "json"],
                    help="text = human-readable lines; json = one "
                         "structured JSON object per line with node-id "
                         "and span-id fields (machine-mergeable across "
                         "a multi-node harness)")
    rn.add_argument("--trace_ring", type=int, default=4096,
                    help="span ring capacity behind /debug/trace "
                         "(last N sync/consensus/commit spans as "
                         "Perfetto-loadable Chrome trace JSON; 0 "
                         "disables)")
    rn.add_argument("--trace_sample", type=float, default=0.0,
                    help="end-to-end transaction tracing sample rate "
                         "in [0,1]: sampled txs carry a trace id "
                         "across gossip hops and drop Chrome flow "
                         "events (submit -> gossip legs -> consensus "
                         "pass -> CommitBlock) into /debug/trace; "
                         "merge nodes with python -m "
                         "babble_tpu_torch.telemetry.tracemerge. 0 disables "
                         "(no per-tx overhead); 0.001 is the "
                         "documented 'on' rate")
    rn.add_argument("--profile_hz", type=float, default=0.0,
                    help="in-process sampling profiler rate (Hz) "
                         "behind GET /debug/flame (folded-stack text "
                         "for speedscope/flamegraph.pl). 0 disables "
                         "the sampler entirely (the endpoint then "
                         "burst-samples on demand); 99 is the "
                         "documented 'on' rate, measured within the "
                         "5%% bar (bench.py --profile-overhead)")
    rn.add_argument("--no_sentinel", action="store_true",
                    help="disable the divergence sentinel (the rolling "
                         "committed-block chain hash piggybacked on "
                         "gossip and compared against peers — "
                         "docs/observability.md 'Consensus health')")
    rn.add_argument("--no_gossip_observatory", action="store_true",
                    help="disable the gossip efficiency observatory "
                         "(per-sync redundancy accounting, the "
                         "creation-stamp wire sidecar, and the "
                         "propagation-latency histogram — "
                         "docs/observability.md 'Gossip efficiency')")
    rn.add_argument("--no_capacity", action="store_true",
                    help="disable the capacity observatory "
                         "(per-subsystem retained-byte gauges, "
                         "state-growth slopes and /debug/capacity — "
                         "docs/observability.md 'Capacity')")
    rn.add_argument("--stall_timeout", type=int, default=30000,
                    help="milliseconds without a decided round (while "
                         "payload events are pending) before the stall "
                         "watchdog emits a diagnosis naming the stuck "
                         "round, its undecided witnesses, and the "
                         "silent creators; 0 disables")
    rn.add_argument("--heartbeat", type=int, default=1000,
                    help="heartbeat timer in milliseconds")
    rn.add_argument("--max_pool", type=int, default=2,
                    help="max number of pooled connections")
    rn.add_argument("--tcp_timeout", type=int, default=1000,
                    help="TCP timeout in milliseconds")
    rn.add_argument("--cache_size", type=int, default=500,
                    help="number of items in LRU caches")
    rn.add_argument("--sync_limit", type=int, default=1000,
                    help="max number of events per sync")
    rn.add_argument("--store", default="inmem", choices=["inmem", "file"],
                    help="store backend")
    rn.add_argument("--store_path", default="",
                    help="path of the file store database")
    rn.add_argument("--store_sync", default="batch",
                    choices=["always", "batch", "off"],
                    help="file store fsync policy: always = fsync every "
                         "commit (power-loss safe), batch = fsync at WAL "
                         "checkpoints (kill-safe, the default), off = no "
                         "fsyncs (fastest, still atomic under process "
                         "death)")
    rn.add_argument("--bootstrap", action="store_true",
                    help="recover from an existing file store database "
                         "(replay the event log, resume consensus "
                         "exactly-once); implied when --store_path "
                         "already exists")
    rn.add_argument("--journal", default="",
                    help="run with a journal app proxy: committed "
                         "blocks append to this fsynced JSONL file "
                         "with exactly-once restart dedupe (crash "
                         "harness / audit mode; overrides --no_client "
                         "and the socket client)")
    rn.add_argument("--engine", default="torch",
                    help="consensus engine: torch = the device engine "
                         "(TorchHashgraph on the incremental engine), "
                         "host = the reference-semantics host driver")
    rn.add_argument("--engine_device", default="cuda",
                    help="device of the torch engine (cuda, or cpu to "
                         "run its plain PyTorch versions on the host); "
                         "without a CUDA device run exits unless cpu "
                         "is named")
    rn.add_argument("--engine_mesh", type=int, default=0,
                    help="devices for the tpu engine's resident state "
                         "(0/1 = single device; d > 1 shards the "
                         "O(E*n) carries over a d-device mesh so DAG "
                         "capacity scales with local chips)")
    rn.add_argument("--consensus_interval", type=int, default=None,
                    help="min milliseconds between consensus passes "
                         "(0 = after every sync, the reference cadence; "
                         "default 0 for --engine host, 250 for torch — "
                         "the FLOOR of an adaptive cadence that tracks "
                         "~3x the measured device-pass wall)")
    rn.add_argument("--pipeline_depth", type=int, default=1,
                    help="consensus pipeline depth for the tpu engine "
                         "(1 = overlapped: a pass is dispatched and its "
                         "commit delta collected on the next worker "
                         "wake, so device compute overlaps gossip "
                         "ingest; 0 = synchronous dispatch+collect)")
    rn.add_argument("--verify_workers", type=int, default=-1,
                    help="signature-verify worker pool size for sync "
                         "ingest (batches are ECDSA-checked outside "
                         "the core lock; -1 = one worker per core, "
                         "capped at 8; 0/1 = inline serial)")
    rn.add_argument("--runtime", choices=["threads", "procs"],
                    default="threads",
                    help="execution runtime for the heavy ingest "
                         "planes (docs/runtime.md): threads = the "
                         "in-process pool; procs = spawned worker "
                         "processes fed over shared memory, so "
                         "verification and large-frame decode run "
                         "off-GIL and can use additional cores")
    rn.add_argument("--device_verify", action="store_true",
                    help="verify sync-batch ECDSA signatures on the "
                         "device (the ops/p256.py CUDA kernel, on "
                         "--engine_device) instead of the host pool; "
                         "verdicts are bit-identical to the host "
                         "backends; no fallback: a kernel failure "
                         "fails the sync")
    rn.add_argument("--no_prewarm", action="store_true",
                    help="skip compiling the engine's cold-start kernel "
                         "ladder at boot (tpu engine)")
    rn.add_argument("--wire_format", default="columnar",
                    choices=["columnar", "gojson"],
                    help="gossip sync payload encoding: columnar = "
                         "packed per-field binary columns, negotiated "
                         "per peer with transparent fallback; gojson = "
                         "the reference's per-event JSON dicts (both "
                         "forms are always accepted inbound)")
    rn.add_argument("--no_plumtree", action="store_true",
                    help="disable the epidemic broadcast tree "
                         "(docs/gossip.md) and restore the reference's "
                         "pull-only random gossip: no eager push, no "
                         "IHAVE/GRAFT/PRUNE, the heartbeat loop pulls "
                         "every tick")
    rn.add_argument("--eager_fanout", type=int, default=0,
                    help="eager push fan-out (tree degree); 0 = auto "
                         "(~log2(n), capped at 4)")
    rn.add_argument("--ihave_interval", type=int, default=250,
                    help="milliseconds between coalesced IHAVE digest "
                         "announcements to lazy peers")
    rn.add_argument("--graft_timeout", type=int, default=350,
                    help="milliseconds a digest-announced event may "
                         "stay missing before GRAFTing it from an "
                         "announcer (promoting that edge to eager)")
    rn.add_argument("--anti_entropy_interval", type=int, default=1000,
                    help="milliseconds between anti-entropy pull "
                         "rounds while plumtree is on (the known-map "
                         "SyncRequest backstop)")
    rn.add_argument("--max_msg_bytes", type=int, default=32,
                    help="cap on a single gossip RPC message in MiB "
                         "(JSON line or binary frame, either "
                         "direction); oversized messages fail with a "
                         "clear TransportError")
    rn.add_argument("--compile_cache_dir", default="",
                    help="persistent XLA compilation cache directory "
                         "for the tpu engine (restart-surviving kernel "
                         "compiles; default ~/.cache/babble_tpu/jax or "
                         "$JAX_COMPILATION_CACHE_DIR)")
    # -- ingress (docs/ingress.md) --------------------------------------
    rn.add_argument("--no_admission", action="store_true",
                    help="disable the ingress admission plane "
                         "(per-client quotas, CoDel load shedding, "
                         "the bounded intake queue, and /subscribe) "
                         "and restore the bare pre-ingress intake "
                         "path byte-for-byte")
    rn.add_argument("--intake_queue", type=int, default=8192,
                    help="capacity of the bounded intake queue "
                         "between the HTTP tier and the consensus "
                         "work queue (babble_queue_*{queue=intake})")
    rn.add_argument("--ingress_target_ms", type=int, default=200,
                    help="CoDel target sojourn in milliseconds: "
                         "standing pipeline delay above this for a "
                         "full control interval sheds new submissions "
                         "with 429 + Retry-After until delay recovers")
    rn.add_argument("--quota_rate", type=float, default=0.0,
                    help="per-client submission quota in tx/s (token "
                         "bucket keyed by the X-Babble-Client header, "
                         "falling back to the remote address); 0 = "
                         "unlimited")
    rn.add_argument("--quota_burst", type=float, default=0.0,
                    help="token-bucket burst capacity; 0 = auto "
                         "(2s of --quota_rate, floor 64)")
    rn.add_argument("--submit_token", default="",
                    help="bearer token required on POST /submit* "
                         "(constant-time compare, 401 JSON on "
                         "mismatch); empty = open intake behind the "
                         "documented localhost binding")
    rn.add_argument("--journal_sync", default="batch",
                    choices=["always", "batch"],
                    help="journal app proxy fsync policy: always = "
                         "fsync every committed block; batch = one "
                         "fsync per drained commit burst (kill-safe "
                         "either way, same family as --store_sync)")
    # -- fault tolerance (docs/robustness.md) ---------------------------
    rn.add_argument("--breaker_threshold", type=int, default=3,
                    help="consecutive sync failures before a peer's "
                         "circuit breaker trips and the peer is "
                         "suspended with exponential backoff")
    rn.add_argument("--breaker_backoff", type=int, default=500,
                    help="base suspension in milliseconds (doubles per "
                         "trip, jittered, capped at 30s)")
    rn.add_argument("--no_breaker", action="store_true",
                    help="disable peer health tracking (reference "
                         "behavior: dead peers are re-selected forever)")
    rn.add_argument("--sync_retries", type=int, default=1,
                    help="bounded retries for the idempotent gossip "
                         "pull before the round is abandoned")
    rn.add_argument("--engine_failover_threshold", type=int, default=0,
                    help="consecutive device-pass failures before the "
                         "node rebuilds consensus on the host engine "
                         "and keeps babbling (torch engine; 0 = "
                         "never)")
    rn.add_argument("--no_failover", action="store_true",
                    help="disable the device->host engine failover "
                         "watchdog")
    rn.set_defaults(fn=cmd_run)

    vs = sub.add_parser("version", help="print version")
    vs.set_defaults(fn=cmd_version)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
