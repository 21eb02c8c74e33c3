#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (babble_tpu_torch) on one GPU and check it.

    python3 chip_smoke.py
    python3 chip_smoke.py sustained_profile node node node   # some phases

With phase names, it builds the kernels and runs those phases in the
order given, one JSON line each, and prints neither the kernels line
nor the final "ok" line.

Phases (any failure exits nonzero and the final `{"ok": true, ...}`
line is not printed):

1. device   — the card's name, and its name and power limit as
              nvidia-smi reports them;
2. build    — compile the CUDA kernel libraries from the repository's
              sources (one nvcc per source, sm_90a, all started
              together) and print the build times and ptxas reports;
3. kernel   — both entry points of the strongly-see kernel against
              their plain PyTorch versions on the card, exact integer
              equality: strongly_see_counts at (M, W, n) = (5,7,4),
              (64,64,64), (130,200,100) and (1024,1024,1024) with 20%
              INT32_MAX lanes; strongly_see_gathered in both modes at
              the main path's shapes (GATHERED_SHAPES: fame's batch,
              the frontier probe, a north-star level with mixed witness
              rows, a ragged case, the simulator's levels and fame over
              stacked per-view tables); kernel and plain times and
              bounds;
4. p256     — the P-256 ladder of device ECDSA verify: the team
              kernel's own chain bound from its SASS; the kernel
              (csrc/p256.cu) against its plain PyTorch version on the
              card, exactly, at B = 8 (tests/test_crypto.py's corpus and
              the d = 1 degeneracies) and B = 1, 37 and 64 (the signed
              stream's first signatures); verify_batch's parts (prelude,
              upload, kernel, download, epilogue) at B = 8 and 64;
              verify_batch's verdicts against the host backend's
              crypto.verify_batch at B = 1, 8, 64, 512, 4,096 and 32,768
              (signed_gossip(64, 32,768, 3) with every 97th s corrupted);
              per size the kernel's time (CUDA events), verify_batch's
              wall, the host backend's wall and the kernel's bounds;
5. small    — a small DAG through both engines on the card and on the
              CPU (plain versions): all six outputs identical;
6. headline — synthetic_dag(64, 50_000, seed=1) through run_pipeline
              with both engines: outputs identical between engines,
              47,659 decided events, a sha256 over the six outputs
              equal to the digest of the JAX reference package on the
              same DAG, and the gathered kernel launched as each site
              should (fame once, one probe launch per frontier probe
              and one skip correction per round, or compute_rounds once
              per level); median of 3 timed runs (pipeline + host
              order);
7. main_path — the default engine's headline run with every launch
              count set to 0 just before and read just after, by mode
              and by site;
8. profile  — one headline run of the main path under torch.profiler:
              the card's busy share of the wall time, device time by
              kernel;
9. northstar — synthetic_dag(1024, 100_000, seed=2) once with the
              default engine: time, decided count (44,770), launches
              by site;
10. sim     — the batched view simulator (ops/sim.py) at BASELINE.json's
              configurations (SIM_CONFIGS): 2, 64 peers, uniform, 10k
              events, every peer's view (V = 64); 4, power-law, 64 peers
              x 4 snapshots (V = 256); 3, 1024 peers with 341 silent,
              131,024 events, two temporal views. Each through
              consensus_views_factored (config 2 also consensus_views):
              the six [V, ...] outputs' digest equal to the JAX
              package's (GOLDEN_SIM), check_view_consistency, B1 TALLY
              launches equal to the DAG levels and MATRIX launches to
              the fame chunks whatever V is; generation, stage seconds,
              decided events per view, peak memory; config 3 also
              tests/test_at_scale.py's assertions; a GossipSim view on
              the card equal to the port's host Hashgraph;
11. sustained — the live node's incremental engine (IncrementalEngine,
              n = 64, capacity 65,536, block 512, k_capacity 1,024) fed
              synthetic_dag(64, 50_000, seed=3) in batches of 4,096
              with pipelined append / collect / dispatch, as bench.py's
              sustained stage drives it: events/s total and steady,
              phase shares, launches by site, host reads and redos per
              pass; its final state equal to the one-shot run_pipeline
              on the card and to the JAX reference package's digest
              (GOLDEN_SUSTAINED_*);
12. sustained_profile — the same engine with run() per batch: phase
              shares of passes 3-6 with synchronised timers; pass 7
              under torch.cuda.set_sync_debug_mode("warn"), which must
              flag exactly one host read per frontier round; pass 8 (a
              steady pass) under torch.profiler: the card's busy share,
              device time by kernel, host waits;
13. northstar_incremental — the engine at n = 1024 (capacity 131,072,
              block 512, k_capacity 512), run() per batch of 4,096 over
              the north-star DAG: time, peak memory, launches by site,
              44,770 decided and the state equal to the one-shot run;
14. hashgraph — signed events through the port's host surface:
              signed_gossip (n = 64, 32,768 events, deterministic
              RFC 6979 signatures, port modules only) fed to a
              TorchHashgraph (the sustained engine settings) by
              insert_wire_batch in batches of 4,096 with the node's
              pipelined collect / dispatch, blocks taken by the commit
              callback: the input and output digests against the JAX
              reference package's TpuHashgraph (GOLDEN_HASHGRAPH_*), the
              same order as the port's one-shot run_consensus_batch on
              the card, launches by site, insert / Store-mirror / pass
              seconds, and a frame reset replayed on a fresh graph equal
              to the host Hashgraph's replay;
15. node    — the node seam: (a) tests/test_failover.py's Core script
              (600 scripted syncs, seed 13, consensus every 5) with one
              Core(engine="torch", device_verify=True) on the card among
              three host Cores (its syncs verified by the P-256 kernel,
              launched at least once), held against a host-engine twin Core fed the same events at
              the same cadence (consensus events, block bytes, head/seq,
              rounds, round-received); (b) bench.py's node stage on the
              port: a live 4-node net of Nodes on InmemTransport and
              InmemAppProxy, every node on the torch engine on the card,
              a transaction every 2 ms, warm-up, one 15 s window with a
              3 s torch.profiler slice: committed consensus events/s,
              commit latency, pass walls, engine phases, device bytes,
              the card's busy share; gates on prefix agreement, block
              bytes across nodes and against one node's events replayed
              into a host Hashgraph, every committed block delivered or
              still queued at shutdown, no fast-forward, no failover and
              no failed pass; the engine's cost report
              (Core.engine_cost_report, /debug/profile?cost=1) with the
              JAX engine's key set;
16. cli     — the port's CLI, one node per process: 4 processes of
              `python -m babble_tpu_torch.cli run --engine torch` on the
              card (TCP gossip on localhost, --store file, heartbeat
              10 ms, consensus interval 250 ms), one DummyClient each, a
              transaction every 2 ms; warm-up, one 15 s window with a 2 s
              /debug/profile capture of node 0, which runs
              --device_verify (its torch.profiler trace gives the
              strongly-see and P-256 kernels' launches in a CLI process;
              /debug/phases its verify share beside a host-verify
              node's), SIGTERM, a restart of all four on their
              databases (bootstrap), 5 more transactions: boot seconds,
              committed consensus events/s and commit latency from each
              node's /Stats and /metrics, each process's median pass
              wall and peak device memory; gates on the clients' logs,
              exit codes, rounds after the restart, no failover and no
              failed pass in any process's stderr;
17. sharded — the memory-sharded pipeline (ops/sharded.py) as rank
              processes on torch.distributed (parallel.spawn_ranks): 4
              gloo ranks sharing the card run BASELINE config 5
              (synthetic_dag(4096, 16,384, seed=21), every event in round
              0) and then the headline, one spawn; one NCCL rank the
              north star; then entry.dryrun_multichip(8) on 8 gloo
              ranks (replica-parallel agreement, the sharded pipeline
              against the single-device oracle, the a-major layout of a
              2 x 4 ("dcn", "ici") mesh; then, in this process, its part
              (c), phase mesh's (a)). Config 5 equals the port's
              single-device run_pipeline on the card and the JAX
              package's digest (GOLDEN_SHARDED_C5), and each rank's
              chain-sharded coordinates and event-sharded first
              descendants equal (by digest) its shards of the
              single-device tables on the card, which every output of
              that all-round-0 DAG would not show; the headline
              GOLDEN_OUTPUT with
              47,659 decided, the north star the single-device run with
              44,770 decided. Each rank resets B1's launch counts before
              each run and reads them after: TALLY once per DAG level at
              the rounds site and MATRIX once per chunk of voting rounds
              at the fame site, in every rank of every run. Per run: the
              slowest rank's seconds, ranks, backend, the collectives a
              rank made, and by rank the host seconds in them, the bytes
              gloo copied through host memory and peak device memory;
18. mesh    — the live node's engine with its O(E·n) tables split into
              shards under one controller (IncrementalEngine(mesh=...),
              ops/mesh.py), the shards sharing the card: (a) part (c) of
              dryrun_multichip(8), 8 shards equal to the single-device
              engine (phase sharded's call); (b) the north-star DAG
              through 4 shards and through the single-device engine,
              run() per batch of 4,096: every RunDelta equal word for
              word, 44,770 decided, each shard of _la, _chain_la and
              _ranks a quarter of the table, the frontier probe launched
              once per chain shard; seconds, host reads, launches by site
              and torch calls per pass, shard bytes and peak memory of
              both; (c) node (a)'s Core script with engine_mesh=4, its
              blocks byte for byte those of a single-device torch Core
              and of a host Core fed its events.

Each path that launches a kernel (the one-shot main path, sim,
sustained, northstar_incremental, hashgraph, both parts of node, every
rank of every sharded run, both engines of mesh (b), mesh (c)) runs
with every launch count set to 0 just before it and read just after,
and fails when the kernel was not launched at each of its sites. Lines before the last: a {"kernels": [...]} line (launches on
the engine's path and on each path, max error, times and bound), a
{"results": ...} line, and the nvidia-smi line. The last line is
{"ok": true, "device": {...}}.

Exits nonzero without a result when no CUDA device is available, and
when run outside the repository (the port is not importable there).
"""

from __future__ import annotations

import contextlib
import functools
import gc
import hashlib
import json
import logging
import os
import platform
import queue
import re
import statistics
import subprocess
import sys
import threading
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# Golden digests of the JAX reference package (babble_tpu, run_pipeline,
# both engines agree) on synthetic_dag(64, 50_000, seed=1), computed on
# the CPU with `digest` below. INPUT covers the DAG arrays and s_rank,
# OUTPUT the six pipeline outputs; a mismatch in INPUT means the DAG
# generator differs, in OUTPUT alone that the pipeline does.
GOLDEN_INPUT = "f7dfc621276b26d93676d524f724a8ef2aa9e63fb9647e2e6c763d010a6d36a0"
GOLDEN_OUTPUT = "3f2191acd555ba55642448106e70046bcd742e0ae60e24a8854455b7ab044ec4"
HEADLINE = (64, 50_000, 1)
HEADLINE_DECIDED = 47_659
NORTHSTAR = (1024, 100_000, 2)
NORTHSTAR_DECIDED = 44_770
# The JAX reference package's IncrementalEngine driven by the sustained
# loop (phase_sustained) on synthetic_dag(64, 50_000, seed=3), on the
# CPU. INPUT is dag_digest of the DAG, OUTPUT the digest of the final
# engine state (engine_state); the JAX package's one-shot run_pipeline
# gives the same state on that DAG.
GOLDEN_SUSTAINED_INPUT = "cf72c67e8f934420b8c4c573d9f504a2aab7a0fb8b62eb56b57d882ecb5b00b9"
GOLDEN_SUSTAINED_OUTPUT = "7ab267e5879b54e80675a08a12d074bf8000d8d2f79d1a530641c2d41cc41b48"
SUSTAINED = (64, 50_000, 3)
SUSTAINED_DECIDED = 47_935
SUSTAINED_ENGINE = dict(capacity=65536, block=512, k_capacity=1024)
NORTHSTAR_ENGINE = dict(capacity=131072, block=512, k_capacity=512)
# The hashgraph phase: signed events (signed_gossip: n = 64, 32,768
# events, topology seed 3, keys from seeds 3000 + i, one transaction per
# event, a 1 ms clock from 1.7e18 ns, RFC 6979 signatures) through
# TorchHashgraph. The goldens are the JAX reference package's
# TpuHashgraph on the CPU, fed the same events (carried across by their
# Go-JSON bytes) in the same batches with the same pipelined loop
# (drive_graph); the JAX package's one-shot run_consensus_batch gives the
# same order. INPUT is hashgraph_input_digest of the events, OUTPUT
# hashgraph_output_digest of the consensus order, the committed blocks
# and last_consensus_round.
HASHGRAPH = (64, 32_768, 3)
HASHGRAPH_KEY_SEED = 3000
HASHGRAPH_CLOCK_NS = 1_700_000_000_000_000_000
HASHGRAPH_ENGINE = SUSTAINED_ENGINE
HASHGRAPH_CACHE = 100_000
GOLDEN_HASHGRAPH_INPUT = "631cacf9048e1b3a795046327e6c71317d5eed43a5d4282b5696aefcc39d95fb"
GOLDEN_HASHGRAPH_OUTPUT = "e7c7462f18d4a493a7c1360dba12f1646806c78fd8e2f3a7afe6d64d1138c569"
HASHGRAPH_DECIDED = 30_996
# Phase sim: BASELINE.json's batched-simulator configurations at their
# stated sizes (sim_views builds each one's DAG and view masks). The
# goldens are digest() of the JAX reference package's
# consensus_views_factored on the same inputs, computed on the CPU:
#   python3 -c "import sys; sys.path[:0] = ['.', 'tests']; \
#     import test_torch_sim as t; print(t.jax_sim_digest('config2'))"
# (likewise config4 and config3; config3 takes ~20 minutes and ~5 GB).
SIM_CONFIGS = {
    # 64 peers, uniform peer selection, 10k events: every peer's final view
    "config2": dict(n=64, steps=9_936, seed=1),
    # power-law gossip topology: 64 peers x 4 temporal snapshots
    "config4": dict(n=64, steps=9_936, selector="powerlaw", alpha=1.2, seed=5,
                    snapshots=[2_484, 4_968, 7_452, 9_936]),
    # 1024 peers, f = 341 silent-byzantine: the network after 100,000
    # events and at the end (tests/test_at_scale.py)
    "config3": dict(n=1024, steps=130_000, silent_last=341, seed=9, prefix=100_000),
}
GOLDEN_SIM = {
    "config2": "1a9e488b0f80122a6c8cc1f97bc3d130c864fc6eaa12eb75d7a96c420bafd65d",
    "config4": "d62425356906100f3d17816f576d743b59f47c588701f05c206cb611349f6694",
    "config3": "ef8583af465cac1ea0b30eee6aa690a7e860c12bc25680a06413693c2b7766ad",
}
SIM_GOSSIP = (5, 11, 120)  # GossipSim(n, seed).run(steps): tests/test_sim.py
# Phase sharded: BASELINE config 5 (tests/test_at_scale.py:91-92), 4,096
# peers, through the memory-sharded pipeline on SHARDED_RANKS gloo ranks
# sharing the card. The goldens are dag_digest and digest() of the JAX
# reference package's run_pipeline(dag, engine="wavefront") on the same
# DAG, computed on the CPU (~20 minutes, 8 cores):
#   python3 -c "import sys; sys.path[:0] = ['.']; import numpy as np, \
#     chip_smoke as c; from babble_tpu.ops.dag import synthetic_dag; \
#     from babble_tpu.ops.pipeline import run_pipeline; \
#     d, s = synthetic_dag(4096, 16384, seed=21); \
#     print(c.dag_digest(d, s), c.digest([np.asarray(x) for x in \
#     run_pipeline(d, engine='wavefront')]))"
# Every event of that DAG is in round 0: nothing is decided.
SHARDED_C5 = (4096, 16_384, 21)
SHARDED_C5_DECIDED = 0
GOLDEN_SHARDED_C5_INPUT = "b9ebcd4ade323ef684dbf6647508639f27dd0ee4ab12a64cf2a9c06b20d3fbfa"
GOLDEN_SHARDED_C5 = "b7154b636510e41c6622aa4e7545df1c7d5299e4a33f8003093095c393f13c5a"
SHARDED_RANKS = 4
DRYRUN_RANKS = 8
# Phase mesh: the north-star engine's shards (on the one card).
MESH_SHARDS = 4
SHARDED_TIMEOUT_S = 600.0
# The node phase: tests/test_failover.py's Core script (syncs, seed,
# consensus every k syncs), then bench.py's node stage for the device
# engine (bench.py build_host_testnet / node_testnet_events_per_sec).
NODE_N = 4
NODE_KEY_SEED = 9000
NODE_SCRIPT = (600, 13, 5)
NODE_CACHE = 100_000
NODE_HEARTBEAT = 0.01
NODE_INTERVAL = 0.25
NODE_TX_EVERY_S = 0.002
NODE_WARM_EVENTS = 1500
NODE_WARM_S = 30.0
NODE_WINDOW_S = 15.0
NODE_PROFILE_S = 3.0
# Phase cli: the reference's 4-node demo (docs/usage.rst:31-34) as
# processes of the port's CLI, at phase node (b)'s cadence.
CLI_N = 4
CLI_HEARTBEAT_MS = 10
CLI_INTERVAL_MS = 250
CLI_TX_EVERY_S = 0.002
CLI_WARM_ROUND = 5
CLI_WARM_S = 30.0
CLI_WINDOW_S = 15.0
CLI_PROFILE_S = 2.0
CLI_BOOT_S = 180.0
CLI_STOP_S = 30.0
CLI_MORE_TXS = 5
CLI_MORE_S = 60.0
# The CLI nodes that run --device_verify (node 0 is also the profiled one).
CLI_DEVICE_VERIFY = (0,)
# The port's log line for a failed consensus pass (node/node.py), which
# FailedPassRecords counts in-process and phase cli counts in each CLI
# process's stderr.
FAILED_PASS = "consensus pass failed"
# The p256 phase: verdicts at these batch sizes, the largest the
# signatures of signed_gossip(*P256_SIGNED) with every P256_CORRUPT_EVERY-th
# s corrupted; the kernel against its plain version at P256_PLAIN sizes
# (8: the corpus and the degeneracies; the others: the signed stream's
# first B, 37 a ragged warp); verify_batch's parts at P256_PARTS sizes.
P256_SIZES = (1, 8, 64, 512, 4096, 32_768)
P256_SIGNED = (64, 32_768, 3)
P256_CORRUPT_EVERY = 97
P256_PLAIN = (1, 8, 37, 64)
P256_PARTS = (8, 64)
P256_PARTS_RUNS = 5
ENGINE_BATCH = 4096
PROFILED_BATCH = 8  # the steady pass sustained_profile traces
KERNEL_SHAPES = [(5, 7, 4), (64, 64, 64), (130, 200, 100), (1024, 1024, 1024)]
# The gathered entry at the main path's shapes: (name, M rows, W witness
# slots, n, R witness rows, how rows name witness rows).
# - fame_batch: decide_fame at the headline, r_small - 1 = 127 voting
#   rounds x 64 witnesses, every 64-row tile naming one round;
# - frontier_probe: one probe of the frontier's k2 search at the
#   headline, 256 positions of each of the 64 chains (frontier.probe_ways);
# - skip_correction: the frontier's skip correction at the headline;
# - northstar_level: compute_rounds on a 1024-wide level at n = 1024,
#   rows naming two adjacent parent rounds at random, as a level's do;
# - ragged: nothing a multiple of the tile, five witness rows mixed;
# - engine_fame_window / northstar_engine_fame: the incremental engine's
#   fame launch over a 16-round window (15 voting rounds) at n = 64 and
#   n = 1024, against the window's compact witness-row table;
# - northstar_engine_probe: the engine's frontier probe at n = 1024;
# - node_fame_window / node_frontier_probe: the live node's engine at
#   n = 4 (phase node), the main path's shapes; its probe tests 1,024
#   positions of each chain (a chain of ~1,000 events, phase node's).
# - sim_config3_level / sim_config2_level: compute_rounds with a view
#   axis (phase sim), one DAG level of every view in one launch against
#   V stacked working tables of r + 1 rows each (r = 758 and 560), rows
#   view-major, each naming one of two adjacent parent rounds of its own
#   view's table: config 3's 2 x 1,024 rows at n = 1,024, config 2's
#   64 x 64 at n = 64;
# - sim_config2_fame: decide_fame's launch over 64 views' tables at the
#   tight bucket (r = 32: 31 voting rounds x 64 witnesses a view).
# - sharded_c5_level / sharded_c5_fame: the sharded pipeline (phase
#   sharded) at config 5 on 4 ranks: a rank's rounds TALLY over a
#   4,096-wide level against its 1,024 witness chains (parent round 0,
#   19 round rows), and its fame MATRIX, 7 voting rounds x 1,024 voters
#   against the 4,096 witnesses of the round before;
# - sharded_headline_level / sharded_headline_fame: the same at the
#   headline on 4 ranks: 16 witness chains a rank over 2,711 round rows,
#   and 127 voting rounds x 16 voters against 64 witnesses.
# - mesh_northstar_shard_probe: the mesh engine's frontier probe on one
#   of MESH_SHARDS chain shards at n = 1024 (phase mesh): its 256 chains'
#   rows against the 1,024 witness rows; its skip correction and fame
#   launch at northstar_engine_probe's and _fame's shapes.
NODE_PROBE_WAYS = 1024
GATHERED_SHAPES = [
    ("node_fame_window", 15 * 4, 4, 4, 15, "tiles"),
    ("node_frontier_probe", 4 * NODE_PROBE_WAYS, 4, 4, 1, "one"),
    ("fame_batch", 127 * 64, 64, 64, 127, "tiles"),
    ("frontier_probe", 64 * 256, 64, 64, 1, "one"),
    ("skip_correction", 64, 64, 64, 1, "one"),
    ("northstar_level", 1024, 1024, 1024, 7, "two"),
    ("ragged", 130, 200, 100, 5, "mixed"),
    ("engine_fame_window", 15 * 64, 64, 64, 15, "tiles"),
    ("northstar_engine_fame", 15 * 1024, 1024, 1024, 15, "tiles"),
    ("northstar_engine_probe", 1024, 1024, 1024, 1, "one"),
    ("sim_config3_level", 2 * 1024, 1024, 1024, 2 * 759, ("views", 2, "two")),
    ("sim_config2_level", 64 * 64, 64, 64, 64 * 561, ("views", 64, "two")),
    ("sim_config2_fame", 64 * 31 * 64, 64, 64, 64 * 32, ("views", 64, "tiles")),
    ("sharded_c5_level", 4096, 1024, 4096, 19, "one"),
    ("sharded_c5_fame", 7 * 1024, 4096, 4096, 7, "tiles"),
    ("sharded_headline_level", 64, 16, 64, 2711, "two"),
    ("sharded_headline_fame", 127 * 16, 64, 64, 127, "tiles"),
    ("mesh_northstar_shard_probe", 1024 // 4, 1024, 1024, 1, "one"),
]
# (timed calls, warm-up calls) of the plain version where the default
# would take minutes: it gathers [rows, W, n] in chunks of 2^28.
PLAIN_ITERS = {"sharded_c5_level": (3, 1), "sharded_c5_fame": (1, 1)}
# The pipeline functions that call strongly_see_gathered, by site.
SITES = {"decide_fame": "fame", "sees_sm": "frontier_probe",
         "step": "skip_correction", "compute_rounds": "compute_rounds"}
ENGINE_SITES = ("fame", "frontier_probe", "skip_correction")

# The least time the H100 SXM needs for the compare-count. Operations:
# one compare and one add per (x, w, i), two int32 operations, at 64
# int32 lanes per SM per clock (half the 128 fp32 lanes behind the
# 67 TFLOP/s fp32 peak) x 132 SMs x 1.98 GHz. Bytes: both inputs read
# once, the output written once, at 3.35 TB/s.
SM_CLOCK_HZ = 1.98e9
INT32_OPS_PER_S = 132 * 64 * SM_CLOCK_HZ
HBM_BYTES_PER_S = 3.35e12
INT32_MAX = 2**31 - 1


def digest(arrays) -> str:
    """sha256 over each array's shape and its values as int64."""
    h = hashlib.sha256()
    for a in arrays:
        a = np.ascontiguousarray(np.asarray(a).astype(np.int64))
        h.update(np.asarray(a.shape, np.int64).tobytes())
        h.update(a.tobytes())
    return h.hexdigest()


def dag_digest(dag, s_rank) -> str:
    return digest([dag.self_parent, dag.other_parent, dag.creator, dag.index,
                   dag.coin, dag.ts_rank, dag.levels, dag.chain, dag.chain_len,
                   dag.chain_rank, dag.root_round, s_rank])


def sim_views(name, simulate_views):
    """(dag, masks [V, E] bool, s_rank) of SIM_CONFIGS[name], built by
    `simulate_views` (the port's, or the JAX package's for the goldens:
    both are numpy and give the same arrays)."""
    cfg = dict(SIM_CONFIGS[name])
    n, silent_last, prefix = cfg.pop("n"), cfg.pop("silent_last", 0), cfg.pop("prefix", None)
    silent = np.zeros(n, bool)
    silent[n - silent_last:] = True
    dag, masks, s_rank = simulate_views(n, silent=silent, **cfg)
    if prefix is not None:
        masks = np.zeros((2, dag.e), bool)
        masks[0, :prefix] = True
        masks[1] = True
    return dag, masks, s_rank


def sim_gossip_check(sim, device="cuda") -> dict:
    """tests/test_sim.py's masked-view parity on the port: the
    best-informed peer's view of a GossipSim through consensus_views on
    `device`, against the port's host Hashgraph fed exactly that
    sub-DAG in insertion order (each event carried by its Go-JSON
    bytes): the same consensus order and, for every event of the view,
    the same round."""
    from babble_tpu_torch.hashgraph import Hashgraph, InmemStore
    from babble_tpu_torch.hashgraph.event import event_from_json_obj
    from babble_tpu_torch.ops.sim import consensus_views, view_order

    dag, masks = sim.dag(), sim.view_masks()
    v = int(masks.sum(1).argmax())
    mask = masks[v]
    h = Hashgraph(sim.participants, InmemStore(sim.participants, 10_000))
    for i, ev in enumerate(sim.events):
        if mask[i]:
            h.insert_event(event_from_json_obj(json.loads(ev.marshal())), True)
    h.run_consensus()
    out = consensus_views(dag, mask[None, :], device=device)
    rounds, rr, cts = (o[0].cpu().numpy() for o in (out[0], out[4], out[5]))
    order = [dag.hexes[i] for i in view_order(dag, rr, cts)]
    rounds_equal = all(int(rounds[i]) == h.round(ev.hex())
                       for i, ev in enumerate(sim.events) if mask[i])
    return {"view": v, "events": int(mask.sum()), "decided": len(order),
            "equal": order == h.consensus_events() and rounds_equal}


def ss_bound_ms(m: int, w: int, n: int):
    ops_s = 2.0 * m * w * n / INT32_OPS_PER_S
    bytes_s = 4.0 * (m * n + w * n + m * w) / HBM_BYTES_PER_S
    return max(ops_s, bytes_s) * 1e3, ("operations" if ops_s >= bytes_s else "bytes")


def gathered_bound_ms(x_tab, xs, f_tab, w_tab, wrow, mode):
    """Least time for one gathered call on these inputs: 2 int32
    operations per (row, valid witness, lane), against the distinct x
    and witness rows read once, the index arrays and the output."""
    import torch

    n, m, w = x_tab.shape[1], xs.shape[0], w_tab.shape[1]
    ids = w_tab[wrow.long()]
    valid = ids >= 0
    ops_s = 2.0 * int(valid.sum()) * n / INT32_OPS_PER_S
    rows = torch.unique(xs).numel() + torch.unique(ids[valid]).numel()
    index_bytes = 4 * (2 * m + torch.unique(wrow).numel() * w)
    out_bytes = m * w if mode == "matrix" else 4 * m
    bytes_s = (4.0 * n * rows + index_bytes + out_bytes) / HBM_BYTES_PER_S
    return max(ops_s, bytes_s) * 1e3, ("operations" if ops_s >= bytes_s else "bytes")


def gathered_inputs(m, w, n, r, wrow_kind, seed=3):
    """numpy operands of strongly_see_gathered: tables of 2M+1 rows,
    x values shifted per row so the counts spread across sm = 2n/3+1,
    20% INT32_MAX fd lanes and 20% empty (-1) witness slots."""
    rng = np.random.default_rng(seed)
    ex = ef = 2 * m + 1
    x_tab = (rng.integers(0, 100, (ex, n)) + rng.integers(-50, 100, (ex, 1))).astype(np.int32)
    f_tab = rng.integers(0, 100, (ef, n)).astype(np.int32)
    f_tab[rng.random((ef, n)) < 0.2] = INT32_MAX
    w_tab = rng.integers(0, ef, (r, w)).astype(np.int32)
    w_tab[rng.random((r, w)) < 0.2] = -1
    xs = rng.integers(0, ex, m).astype(np.int32)
    if isinstance(wrow_kind, tuple):
        # ("views", V, kind): V stacked tables of r / V rows, rows
        # view-major, each view's rows naming rows of its own table below
        # its last (compute_rounds' dump row; fame's last round votes on
        # nothing): "two" adjacent rows at random, or in "tiles" by row
        _, v, kind = wrow_kind
        rv, mv = r // v, m // v
        own = (rv - 3 + rng.integers(0, 2, (v, mv)) if kind == "two"
               else np.tile(np.repeat(np.arange(rv - 1), mv // (rv - 1)), (v, 1)))
        wrow = (np.arange(v)[:, None] * rv + own).reshape(-1).astype(np.int32)
    else:
        wrow = {"tiles": np.repeat(np.arange(r), m // r),
                "one": np.zeros(m),
                "two": r - 2 + rng.integers(0, 2, m),
                "mixed": rng.integers(0, r, m)}[wrow_kind].astype(np.int32)
    return x_tab, xs, f_tab, w_tab, wrow, 2 * n // 3 + 1


def reset_launches():
    from babble_tpu_torch.ops import hopper_kernels as hk
    from babble_tpu_torch.ops import p256

    hk.strongly_see_counts.launches = 0
    for mode in hk.strongly_see_gathered.launches:
        hk.strongly_see_gathered.launches[mode] = 0
    p256.dual_window.launches = 0


def p256_launches() -> int:
    from babble_tpu_torch.ops import p256

    return p256.dual_window.launches


def read_launches() -> dict:
    from babble_tpu_torch.ops import hopper_kernels as hk

    return {"counts": hk.strongly_see_counts.launches, **hk.strongly_see_gathered.launches}


@contextlib.contextmanager
def launches_by_site():
    """Attribute each launch of the gathered wrapper to the pipeline
    function that asked for it (SITES), through a spy around the
    wrapper; the wrapper's own counts go on as before. The spy holds a
    lock around each call, so engines on several threads (the node
    phase's four) neither lose a count nor take another's."""
    from babble_tpu_torch.ops import hopper_kernels as hk

    real = hk.strongly_see_gathered
    sites = {}
    lock = threading.Lock()

    def spy(*args):
        caller = sys._getframe(1).f_code.co_name
        site = SITES.get(caller, caller)
        with lock:
            before = sum(real.launches.values())
            out = real(*args)
            sites[site] = sites.get(site, 0) + sum(real.launches.values()) - before
        return out

    spy.launches = real.launches
    hk.strongly_see_gathered = spy
    try:
        yield sites
    finally:
        hk.strongly_see_gathered = real


def check_sites(dag, engine, launches, sites, r_small) -> None:
    """The launches a run must make: none of the counts entry; fame one
    matrix launch per chunk of voting rounds (one at these sizes); the
    closure engine one probe launch per step of the frontier's k2
    search (search_steps over the chain table's K positions) and one
    skip correction per swept round; the wavefront one compute_rounds
    launch per DAG level."""
    from babble_tpu_torch.ops.frontier import probe_ways, search_steps
    from babble_tpu_torch.ops.kernels import chunk_width

    n = dag.n
    fame = -(-(r_small - 1) // chunk_width(r_small - 1, n * n))
    k = dag.chain.shape[1]
    probes = search_steps(k, max(1, min(probe_ways(n), k)))
    if engine == "wavefront":
        tally = {"compute_rounds": dag.levels.shape[0]}
    else:
        rounds = sites.get("skip_correction", 0)
        tally = {"frontier_probe": probes * rounds, "skip_correction": rounds}
        if rounds == 0 or rounds % 64:
            raise AssertionError(f"{engine}: {rounds} frontier rounds, not chunks of 64")
    want_sites = {"fame": fame, **tally}
    want = {"counts": 0, "matrix": fame, "tally": sum(tally.values())}
    if sites != want_sites or launches != want:
        raise AssertionError(f"{engine}: launches {launches} by site {sites}, "
                             f"expected {want} by site {want_sites}")


def cuda_ms(fn, iters: int, warm: int = 3) -> float:
    """Mean device time of fn() over `iters` back-to-back calls."""
    import torch

    for _ in range(warm):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host(out):
    return [o.cpu().numpy() for o in out]


def host_name() -> str:
    """The host's CPU model (lscpu's "Model name", else /proc/cpuinfo's
    "model name", else the machine type) and the cores this process may
    use: the pipeline's eager loops are bound by the host's launch cost,
    so its times move with the host as much as with the card."""
    model = ""
    try:
        out = subprocess.run(["lscpu"], capture_output=True, text=True, timeout=30).stdout
        model = next((line.split(":", 1)[1].strip() for line in out.splitlines()
                      if line.startswith("Model name")), "")
    except (OSError, subprocess.SubprocessError):
        pass
    if not model:
        try:
            with open("/proc/cpuinfo") as f:
                model = next((line.split(":", 1)[1].strip() for line in f
                              if line.startswith("model name")), "")
        except OSError:
            pass
    return f"{model or platform.machine()}, {len(os.sched_getaffinity(0))} cores"


def phase_build(rec):
    from babble_tpu_torch.ops import hopper_kernels

    t0 = time.perf_counter()
    infos = hopper_kernels.build()
    rec["build"] = {"seconds": time.perf_counter() - t0, "libraries": {
        name: {"library": str(info["path"]), "nvcc_seconds": info["seconds"],
               "ptxas": info["log"]} for name, info in infos.items()}}
    print(f"build: {rec['build']['seconds']:.2f} s")
    for name, info in infos.items():
        regs = re.findall(r"Used (\d+) registers", info["log"])
        spills = re.findall(r"(\d+) bytes spill stores", info["log"])
        print(f"build {name}: nvcc {info['seconds']:.2f} s -> {info['path']}; "
              f"registers {regs}, spill stores {spills} bytes")
        print(info["log"])


def phase_kernel(rec, device="cuda"):
    """Both entry points vs their plain versions, exact equality:
    strongly_see_counts at KERNEL_SHAPES, strongly_see_gathered in both
    modes at GATHERED_SHAPES."""
    import torch

    from babble_tpu_torch.ops.hopper_kernels import (
        strongly_see_counts, strongly_see_counts_ref, strongly_see_gathered,
        strongly_see_gathered_ref)

    rows = []
    for m, w, n in KERNEL_SHAPES:
        rng = np.random.default_rng(3)
        la = rng.integers(-1, 50, (m, n)).astype(np.int32)
        fd = rng.integers(0, 50, (w, n)).astype(np.int32)
        fd[rng.random((w, n)) < 0.2] = INT32_MAX  # unreached
        la_t = torch.from_numpy(la).to(device)
        fd_t = torch.from_numpy(fd).to(device)
        got = strongly_see_counts(la_t, fd_t)
        want = strongly_see_counts_ref(la_t, fd_t)
        torch.cuda.synchronize()
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        iters = 20 if n >= 1024 else 200
        ms = cuda_ms(lambda: strongly_see_counts(la_t, fd_t), iters)
        plain_ms = cuda_ms(lambda: strongly_see_counts_ref(la_t, fd_t), iters)
        bound, by = ss_bound_ms(m, w, n)
        rows.append({"shape": [m, w, n], "max_abs_err": err, "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by})
        print(f"kernel {m}x{w}x{n}: max_abs_err={err} kernel {ms:.4f} ms "
              f"plain {plain_ms:.4f} ms bound {bound:.5f} ms ({by})")
        if err != 0:
            raise AssertionError(f"kernel != plain version at {(m, w, n)}")
    rec["kernel_shapes"] = rows

    rows = []
    for name, m, w, n, r, kind in GATHERED_SHAPES:
        *tabs, sm = gathered_inputs(m, w, n, r, kind)
        args = [torch.from_numpy(a).to(device) for a in tabs]
        for mode in ("matrix", "tally"):
            got = strongly_see_gathered(*args, sm, mode)
            want = strongly_see_gathered_ref(*args, sm, mode)
            torch.cuda.synchronize()
            err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
            iters = 20 if n >= 1024 else 200
            ms = cuda_ms(lambda: strongly_see_gathered(*args, sm, mode), iters)
            plain_iters, plain_warm = PLAIN_ITERS.get(name, (iters, 3))
            plain_ms = cuda_ms(lambda: strongly_see_gathered_ref(*args, sm, mode),
                               plain_iters, plain_warm)
            bound, by = gathered_bound_ms(*args, mode)
            hits = float(want.float().mean() / (1 if mode == "matrix" else w))
            rows.append({"name": name, "mode": mode, "shape": [m, w, n, r],
                         "wrow": kind, "max_abs_err": err, "ms": ms,
                         "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
                         "hit_share": hits})
            print(f"gathered {name} {mode} M={m} W={w} n={n} R={r} ({kind}): "
                  f"max_abs_err={err} kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
                  f"bound {bound:.5f} ms ({by}) hits {hits:.3f}")
            if err != 0:
                raise AssertionError(f"gathered kernel != plain version at {name} {mode}")
    rec["gathered_shapes"] = rows


def p256_corpus():
    """tests/test_crypto.py's verify corpus with the port's crypto and
    the deterministic signer: valid signatures from repeated creators, a
    corrupted s, a high-s encoding, r >= N and r = 0 range rejections, a
    malformed creator point (verdict None). Returns (pubs, digests,
    sigs, expected)."""
    from babble_tpu_torch import crypto
    from babble_tpu_torch.crypto import _fallback as fb

    keys = [fb.key_from_seed(s) for s in (11, 12, 13)]
    pubs_b = [fb.pub_key_bytes(k) for k in keys]
    pubs, digests, sigs, expected = [], [], [], []
    for i in range(6):
        d = crypto.sha256(b"batch-%d" % i)
        r, s = fb.sign(keys[i % 3], d)
        ok = True
        if i == 2:
            s = (s + 1) % fb.N or 1
            ok = False
        if i == 4:
            s = fb.N - s
        pubs.append(pubs_b[i % 3])
        digests.append(d)
        sigs.append((r, s))
        expected.append(ok)
    d = crypto.sha256(b"range")
    r, s = fb.sign(keys[0], d)
    pubs += [pubs_b[0], pubs_b[0]]
    digests += [d, d]
    sigs += [(fb.N + 5, s), (0, s)]
    expected += [False, False]
    pubs.append(b"\x04" + b"\x00" * 64)
    digests.append(d)
    sigs.append((r, s))
    expected.append(None)
    return pubs, digests, sigs, expected


def p256_degeneracies():
    """d = 1 (Q = G): r = (N - z) mod N lands the Shamir sum on the point
    at infinity, r = z mod N forces u1 == u2 through the add's doubling."""
    from babble_tpu_torch import crypto
    from babble_tpu_torch.crypto import _fallback as fb

    k1 = fb.key_from_seed(0)
    pub = fb.pub_key_bytes(k1)
    d = crypto.sha256(b"degenerate")
    z = int.from_bytes(d, "big") % fb.N
    return [pub, pub], [d, d], [((fb.N - z) % fb.N or 1, 1), (z or 1, 1)]


def p256_lanes(pubs, digests, sigs):
    """(n1, n2, qwin) numpy ladder inputs of in-range signatures, made
    by the port's host prelude (ops/p256.py)."""
    from babble_tpu_torch.crypto import _fallback as fb
    from babble_tpu_torch.ops import p256

    ws = fb._batch_inv_n([s for _, s in sigs])
    u1 = [int.from_bytes(d, "big") % p256.N * w % p256.N for d, w in zip(digests, ws)]
    u2 = [r * w % p256.N for (r, _), w in zip(sigs, ws)]
    return (p256._nibbles_of(u1), p256._nibbles_of(u2),
            np.stack([p256._q_window_limbs(pub) for pub in pubs]))


def p256_bound_ms(n1, n2, qwin):
    """Least time for the ladder on these inputs. Operations: per lane
    256 doublings of 8 field products and 12 per mixed add, one add per
    nonzero digit but the first (it meets the identity and multiplies
    nothing); a field product is 64 32x32->64-bit multiplies, each 2
    int32 operations (low and high word) at INT32_OPS_PER_S; the
    reduction's adds are not counted. Bytes: the inputs and the base
    table read once, X, Y and Z written once."""
    b = n1.shape[0]
    adds = int((n1 != 0).sum() + (n2 != 0).sum()) - b
    ops_s = (b * 256 * 8 + adds * 12) * 64 * 2 / INT32_OPS_PER_S
    bytes_s = (n1.nbytes + n2.nbytes + qwin.nbytes + 16 * 2 * 16 * 4
               + 3 * b * 16 * 4) / HBM_BYTES_PER_S
    return max(ops_s, bytes_s) * 1e3, ("operations" if ops_s >= bytes_s else "bytes")


def p256_lane_ms(n1, n2):
    """The serial chain of the slowest lane: its int32 operations (as in
    p256_bound_ms) at one per clock (1.98 GHz), the least time one
    thread needs, however many SMs the batch leaves idle."""
    adds = (n1 != 0).sum(1) + (n2 != 0).sum(1) - 1
    return float((256 * 8 + adds.max() * 12) * 64 * 2 / SM_CLOCK_HZ * 1e3)


def p256_team_chain(sass: str) -> dict:
    """The team kernel's own chain bound, from its SASS (cuobjdump
    -sass of the built library): the instructions one lane issues for
    one signature, at one a clock (SM_CLOCK_HZ). The ladder's step loop
    (6 steps a nibble, 64 nibbles) holds two regions behind its two
    longest forward branches: the mixed add (skipped on steps 0-3, run
    on steps 4 and 5 whatever the digit: 128 a signature) and the
    doubling (256); inside both, a short forward branch over a region
    with a VOTE skips a reduction's rare fix-up, which is not counted,
    nor are the prologue and the stores."""
    part = next(f for f in sass.split("Function : ")[1:]
                if "p256_dual_window_kernel" in f.splitlines()[0])
    ins = [(int(m.group(1), 16), m.group(2)) for m in
           re.finditer(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", part)]

    def count(lo, hi):  # instructions at addresses in [lo, hi)
        return sum(1 for a, _ in ins if lo <= a < hi)

    branches = [(a, int(m.group(1), 16)) for a, text in ins
                for m in [re.search(r"\bBRA (?:\S+, )?0x([0-9a-f]+)", text)] if m]
    back = [(a, t) for a, t in branches if t < a]
    step = max(back, key=lambda b: b[1])  # the innermost loop: the latest head
    nibble = min((b for b in back if b[1] < step[1] and b[0] > step[0]),
                 key=lambda b: step[1] - b[1])
    inside = [(a, t) for a, t in branches if step[1] <= a < t <= step[0] + 16]
    regions = sorted(sorted(inside, key=lambda b: b[0] - b[1])[:2])  # add, doubling

    def region(a, t):
        n = count(a + 1, t)
        for fa, ft in inside:
            if a < fa and ft <= t and (fa, ft) not in regions and any(
                    "VOTE" in text for x, text in ins if fa < x < ft):
                n -= count(fa + 1, ft)
        return n

    add, dbl = (region(a, t) for a, t in regions)
    step_n = count(step[1], step[0] + 1) - sum(count(a + 1, t) for a, t in regions)
    nibble_n = count(nibble[1], nibble[0] + 1) - count(step[1], step[0] + 1)
    total = 128 * add + 256 * dbl + 384 * step_n + 64 * nibble_n
    return {"add": add, "double": dbl, "step": step_n, "nibble": nibble_n,
            "kernel_static": len(ins), "per_signature": total,
            "ms": total / SM_CLOCK_HZ * 1e3}


def p256_signed_batch():
    """(pubs, digests, sigs) of signed_gossip(*P256_SIGNED)'s events,
    every P256_CORRUPT_EVERY-th s corrupted."""
    from babble_tpu_torch.crypto import _fallback as fb

    events, _, signer = signed_gossip(*P256_SIGNED)
    pubs = [ev.body.creator for ev in events]
    digests = [ev.body.hash() for ev in events]
    sigs = [(int(ev.r), int(ev.s) if (i + 1) % P256_CORRUPT_EVERY
             else (int(ev.s) + 1) % fb.N or 1) for i, ev in enumerate(events)]
    return pubs, digests, sigs, signer


def phase_p256(rec, device="cuda"):
    """The P-256 ladder (p256.dual_window, csrc/p256.cu): against its
    plain version on the card at P256_PLAIN sizes, exact; verify_batch's
    verdicts against the host backend at P256_SIZES, with times."""
    import torch

    from babble_tpu_torch import crypto
    from babble_tpu_torch.ops import p256

    res = rec["p256"] = {"host_backend": crypto.BACKEND}
    t_gen = time.perf_counter()
    s_pubs, s_digests, s_sigs, signer = p256_signed_batch()
    res["signed"] = {"events": len(s_pubs), "signer": signer,
                     "seconds": time.perf_counter() - t_gen}

    # The team kernel's own chain bound, from the compiled source.
    chain = None
    if device == "cuda":
        from babble_tpu_torch.ops import hopper_kernels

        lib = hopper_kernels.build(hopper_kernels.SOURCES[1])["path"]
        cuobjdump = os.path.join(os.path.dirname(hopper_kernels._nvcc()), "cuobjdump")
        chain = res["team_chain"] = p256_team_chain(subprocess.run(
            [cuobjdump, "-sass", str(lib)], capture_output=True, text=True, check=True).stdout)
        print(f"p256 team chain: {chain['per_signature']} instructions a lane per signature "
              f"(add {chain['add']}, doubling {chain['double']}, step {chain['step']}, "
              f"nibble {chain['nibble']}; {chain['kernel_static']} in the kernel) = "
              f"{chain['ms']:.4f} ms at one a clock")

    # The kernel against its plain version: the corpus's in-range lanes
    # and the degeneracies (8 lanes), then the signed stream's first B.
    pubs, digests, sigs, expected = p256_corpus()
    live = [i for i, v in enumerate(expected) if v is not None and 1 <= sigs[i][0] < p256.N]
    dp, dd, ds = p256_degeneracies()
    plain_batches = {b: p256_lanes(s_pubs[:b], s_digests[:b], s_sigs[:b])
                     for b in P256_PLAIN if b != 8}
    plain_batches[8] = p256_lanes([pubs[i] for i in live] + dp, [digests[i] for i in live] + dd,
                                  [sigs[i] for i in live] + ds)
    rows = []
    for b in P256_PLAIN:
        arrs = plain_batches[b]
        args = [torch.from_numpy(a).to(device) for a in arrs]
        got = p256.dual_window(*args)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = p256.dual_window_ref(*args)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = max(int((g.long() - w.long()).abs().max()) for g, w in zip(got, want))
        ms = cuda_ms(lambda: p256.dual_window(*args), 10)
        bound, by = p256_bound_ms(*arrs)
        lane_ms = p256_lane_ms(*arrs[:2])
        rows.append({"b": b, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound, "bound_by": by, "lane_chain_ms": lane_ms,
                     "team_chain_ms": chain and chain["ms"]})
        print(f"p256 kernel vs plain B={b}: max_abs_err={err} kernel {ms:.3f} ms plain "
              f"{plain_ms:.1f} ms (wall, synchronised) bound {bound:.5f} ms ({by}), "
              f"one lane's chain {lane_ms:.4f} ms, the team's chain "
              f"{chain and round(chain['ms'], 4)} ms")
        if err != 0:
            raise AssertionError(f"p256 kernel != plain version at B={b}")
    res["kernel_vs_plain"] = rows

    # verify_batch's parts (the stream synchronised between them), the
    # median of P256_PARTS_RUNS calls a size.
    parts = {}
    for b in P256_PARTS:
        runs = []
        for _ in range(P256_PARTS_RUNS):
            runs.append({})
            p256.verify_batch(s_pubs[:b], s_digests[:b], s_sigs[:b], device=device,
                              parts=runs[-1], sync_parts=True)
        parts[b] = {k: statistics.median(r[k] for r in runs) * 1e3 for k in p256.PARTS}
        print(f"p256 verify_batch parts B={b} (ms, median of {P256_PARTS_RUNS}): "
              + ", ".join(f"{k} {v:.4f}" for k, v in parts[b].items()))
    res["verify_parts_ms"] = parts

    # Verdicts against the host backend, with times per size.
    corpus_dev = p256.verify_batch(pubs, digests, sigs, device=device)
    degenerate = (p256.verify_batch(dp, dd, ds, device=device), crypto.verify_batch(dp, dd, ds))
    res["corpus_equal"] = corpus_dev == expected == crypto.verify_batch(pubs, digests, sigs)
    res["degeneracies_equal"] = degenerate[0] == degenerate[1]
    print(f"p256 corpus verdicts {corpus_dev} (expected {expected}); degeneracies "
          f"{degenerate[0]} (host {degenerate[1]})")
    if not (res["corpus_equal"] and res["degeneracies_equal"]):
        raise AssertionError("p256 verdicts differ from the host backend on the corpus")
    sizes = []
    for b in P256_SIZES:
        batch = (s_pubs[:b], s_digests[:b], s_sigs[:b])
        torch.cuda.synchronize()
        launches0 = p256_launches()
        t0 = time.perf_counter()
        dev_v = p256.verify_batch(*batch, device=device)
        verify_s = time.perf_counter() - t0
        launches = p256_launches() - launches0
        t0 = time.perf_counter()
        host_v = crypto.verify_batch(*batch)
        host_s = time.perf_counter() - t0
        arrs = p256_lanes(*batch)
        args = [torch.from_numpy(a).to(device) for a in arrs]
        ms = cuda_ms(lambda: p256.dual_window(*args), 3 if b >= 4096 else 10)
        bound, by = p256_bound_ms(*arrs)
        row = {"b": b, "equal": dev_v == host_v, "rejected": host_v.count(False),
               "launches": launches,
               "kernel_ms": ms, "kernel_us_per_event": ms * 1e3 / b,
               "verify_ms": verify_s * 1e3, "verify_us_per_event": verify_s * 1e6 / b,
               "host_ms": host_s * 1e3, "host_us_per_event": host_s * 1e6 / b,
               "bound_ms": bound, "bound_by": by, "lane_chain_ms": p256_lane_ms(*arrs[:2]),
               "team_chain_ms": chain and chain["ms"]}
        sizes.append(row)
        print(f"p256 B={b}: verdicts equal {row['equal']} ({row['rejected']} rejected), "
              f"{launches} launch(es); "
              f"kernel {ms:.3f} ms ({row['kernel_us_per_event']:.3f} us/event), "
              f"verify_batch {row['verify_ms']:.2f} ms ({row['verify_us_per_event']:.2f} "
              f"us/event), host {crypto.BACKEND} {row['host_ms']:.2f} ms "
              f"({row['host_us_per_event']:.2f} us/event), bound {bound:.5f} ms ({by}), "
              f"one lane's chain {row['lane_chain_ms']:.4f} ms, the team's chain "
              f"{row['team_chain_ms'] and round(row['team_chain_ms'], 4)} ms")
        if not row["equal"] or row["rejected"] != b // P256_CORRUPT_EVERY or launches != 1:
            raise AssertionError(f"p256 at B={b}: {row}")
    res["sizes"] = sizes


def phase_small(rec, device="cuda"):
    """A small DAG: both engines on the card equal the CPU run."""
    from babble_tpu_torch.ops.dag import synthetic_dag
    from babble_tpu_torch.ops.pipeline import run_pipeline

    dag, _ = synthetic_dag(8, 400, seed=7)
    ref = host(run_pipeline(dag, engine="wavefront", device="cpu"))
    for engine in ("closure", "wavefront"):
        got = host(run_pipeline(dag, engine=engine, device=device))
        for name, a, b in zip(OUTPUT_NAMES, got, ref):
            if a.shape != b.shape or not (a == b).all():
                raise AssertionError(f"small DAG, {engine}: {name} differs from CPU")
    rec["small"] = {"n": 8, "e": 400, "seed": 7, "equal_to_cpu": True}
    print("small: n=8 e=400 both engines on the card == CPU")


OUTPUT_NAMES = ("rounds", "witness", "wt", "famous", "rr", "cts")


def _timed_run(dag, s_rank, engine, device):
    """One pipeline run plus the host finish, synchronised; returns
    (seconds, outputs on the host, order)."""
    import torch

    from babble_tpu_torch.ops.engine import consensus_order
    from babble_tpu_torch.ops.pipeline import run_pipeline

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run_pipeline(dag, engine=engine, device=device)
    order = consensus_order(out[4], out[5], s_rank)
    outs = host(out)
    return time.perf_counter() - t0, outs, order


def _r_small(dag, rounds) -> int:
    from babble_tpu_torch.ops.pipeline import _round_bucket

    max_round = int(rounds.max())
    return _round_bucket(max_round, max(dag.max_rounds, max_round + 1))


def stage_times(dag, engine, device, valid_mask=None):
    """Per-stage seconds of one run, each stage synchronised: where the
    pipeline's time goes (the device idles between launches, so these
    are launch-bound wall times). `valid_mask` (wavefront: [V, E+1] on
    the device) times the view simulator's factored pipeline."""
    import torch

    from babble_tpu_torch.ops import closure, frontier, kernels, pipeline

    dev = torch.device(device)
    times = {}
    n, sm, e = dag.n, dag.super_majority, dag.e

    def tick(name, t0):
        torch.cuda.synchronize()
        times[name] = time.perf_counter() - t0
        return time.perf_counter()

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    t = pipeline._to_device(dag, dev)
    t0 = tick("to_device", t0)
    if engine == "wavefront":
        la = kernels.compute_last_ancestors(
            t["self_parent"], t["other_parent"], t["creator"], t["index"],
            t["levels"], n=n)
        t0 = tick("last_ancestors", t0)
        fd = kernels.compute_first_descendants(
            la, t["creator"], t["index"], t["chain"], t["chain_len"], n=n)
        t0 = tick("first_descendants", t0)
        rounds, _, wt = kernels.compute_rounds(
            t["self_parent"], t["other_parent"], t["creator"], t["index"], la,
            fd, t["levels"], t["root_round"], valid_mask, n=n, sm=sm, r=dag.max_rounds)
        r_small = pipeline.tight_round_bucket(rounds, dag.max_rounds)
        wt = wt[..., :r_small, :].contiguous()
        t0 = tick("rounds", t0)
    else:
        la, rbase = closure.coordinates(dag, block=512, device=dev)
        t0 = tick("closure_coordinates", t0)
        fd = kernels.compute_first_descendants(
            la, t["creator"], t["index"], t["chain"], t["chain_len"], n=n)
        t0 = tick("first_descendants", t0)
        wt_abs, fr_rel, rho_min = frontier.compute_frontier(
            la, rbase, fd, t["chain"], t["chain_len"], dag.root_round, n=n, sm=sm)
        rounds, _ = frontier.rounds_from_frontier(
            fr_rel, t["creator"][:e], t["index"][:e], t["self_parent"][:e],
            rho_min, n=n)
        max_round = wt_abs.shape[0] - 1
        r_small = pipeline._round_bucket(max_round, max(dag.max_rounds, max_round + 1))
        wt = torch.full((r_small, n), -1, dtype=torch.int32, device=dev)
        wt[: min(r_small, wt_abs.shape[0])] = wt_abs[:r_small]
        t0 = tick("frontier_rounds", t0)
    famous = kernels.decide_fame(wt, la, fd, t["index"], t["coin"], n=n, sm=sm,
                                 r=r_small)
    t0 = tick("fame", t0)
    kernels.decide_round_received(rounds, wt, famous, la, fd, t["creator"],
                                  t["index"], t["chain_rank"], valid_mask, n=n, r=r_small)
    tick("round_received", t0)
    return times


def phase_headline(rec, device="cuda"):
    from babble_tpu_torch.ops.dag import synthetic_dag

    n, e, seed = HEADLINE
    dag, s_rank = synthetic_dag(n, e, seed=seed)
    in_digest = dag_digest(dag, s_rank)
    print(f"headline: n={n} e={e} seed={seed} levels={dag.levels.shape} "
          f"input digest {'ok' if in_digest == GOLDEN_INPUT else 'MISMATCH'}")
    if in_digest != GOLDEN_INPUT:
        raise AssertionError(f"headline input digest {in_digest} != {GOLDEN_INPUT}")
    res = {"n": n, "e": e, "seed": seed, "engines": {}}
    outs = {}
    for engine in ("closure", "wavefront"):
        # warm-up (allocator, library), counted by mode and by site
        reset_launches()
        with launches_by_site() as sites:
            _timed_run(dag, s_rank, engine, device)
        launches = read_launches()
        times = []
        for _ in range(3):
            sec, out, order = _timed_run(dag, s_rank, engine, device)
            times.append(sec)
        decided = int((out[4] >= 0).sum())
        med = statistics.median(times)
        out_digest = digest(out)
        res["engines"][engine] = {
            "launches": launches, "launches_by_site": sites,
            "decided": decided, "max_round": int(out[0].max()),
            "seconds": times, "median_s": med, "events_per_s": decided / med,
            "output_digest": out_digest,
            "stages_s": stage_times(dag, engine, device)}
        outs[engine] = out
        print(f"headline[{engine}]: decided={decided} max_round={int(out[0].max())} "
              f"launches={launches} by site {sites} median {med * 1e3:.1f} ms "
              f"-> {decided / med:,.0f} events/s; runs "
              f"{[round(t * 1e3, 1) for t in times]} ms; digest "
              f"{'ok' if out_digest == GOLDEN_OUTPUT else 'MISMATCH'}")
        print(f"headline[{engine}] stages (s): "
              + json.dumps({k: round(v, 4) for k, v in
                            res["engines"][engine]["stages_s"].items()}))
        if decided != HEADLINE_DECIDED:
            raise AssertionError(f"{engine}: {decided} decided != {HEADLINE_DECIDED}")
        if out_digest != GOLDEN_OUTPUT:
            raise AssertionError(f"{engine}: output digest {out_digest} != golden")
        check_sites(dag, engine, launches, sites, _r_small(dag, out[0]))
    for name, a, b in zip(OUTPUT_NAMES, outs["closure"], outs["wavefront"]):
        if a.shape != b.shape or not (a == b).all():
            raise AssertionError(f"headline engines differ in {name}")
    rec["headline"] = res


def phase_main_path_counts(rec, device="cuda"):
    """The main path as a user calls it — run_pipeline with the default
    engine, then the host order — with every launch count set to 0
    just before and read just after, by mode and by site."""
    import torch

    from babble_tpu_torch.ops.dag import synthetic_dag
    from babble_tpu_torch.ops.pipeline import _default_engine

    n, e, seed = HEADLINE
    dag, s_rank = synthetic_dag(n, e, seed=seed)
    reset_launches()
    with launches_by_site() as sites:
        _, out, order = _timed_run(dag, s_rank, "auto", device)
    launches = read_launches()
    if launches["matrix"] == 0 or launches["tally"] == 0:
        raise AssertionError(f"main path launches {launches}: a kernel was never launched")
    engine = _default_engine(n, torch.device(device))
    check_sites(dag, engine, launches, sites, _r_small(dag, out[0]))
    rec["main_path_launches"] = {"engine": engine, "by_mode": launches,
                                 "by_site": sites, "decided": int(len(order))}
    print(f"main path (engine=auto -> {engine}): launches by mode {launches}, "
          f"by site {sites}")


def phase_profile(rec, device="cuda"):
    """One headline run of the main path under torch.profiler: the
    share of the wall time the card is busy (union of kernel
    intervals), device time by kernel, and B1's device time per launch.
    Where the profiler records no device activity, the numbers are
    written as not measured."""
    from torch.profiler import ProfilerActivity, profile

    from babble_tpu_torch.ops.dag import synthetic_dag

    n, e, seed = HEADLINE
    dag, s_rank = synthetic_dag(n, e, seed=seed)
    _timed_run(dag, s_rank, "auto", device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall_s, _, _ = _timed_run(dag, s_rank, "auto", device)
    rec["profile"] = p = {"engine": "auto", **profile_summary(prof, wall_s)}
    if "device_busy_s" not in p:
        print("profile: the profiler recorded no device activity: not measured")
        return
    print(f"profile (headline, engine=auto, profiled run {wall_s:.3f} s): "
          f"{p['kernel_launches']} kernels, device busy {p['device_busy_s']:.3f} s "
          f"= {p['device_busy_share']:.1%} of wall; strongly_see {p['strongly_see']}")
    for row in p["top_kernels_us"]:
        print(f"  {row['us'] / 1e3:9.2f} ms  x{row['count']:6d}  {row['name']}")


def union_us(spans) -> float:
    """The length of the union of (start, end) intervals."""
    busy, cur_s, cur_e = 0.0, None, None
    for s, t in sorted(spans):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, t
        else:
            cur_e = max(cur_e, t)
    return busy + (cur_e - cur_s if cur_e is not None else 0.0)


def profile_summary(prof, wall_s) -> dict:
    """The card's busy time (union of kernel intervals) and share of
    `wall_s`, device time by kernel, and B1's device time per launch,
    from a torch.profiler run; "not measured" where the profiler
    recorded no device activity."""
    from torch.autograd import DeviceType

    events = prof.events()
    kern = [ev for ev in events if ev.device_type == DeviceType.CUDA]
    # Host waits on the card, as the CUDA runtime calls that make them.
    syncs = {}
    for ev in events:
        if ev.device_type != DeviceType.CUDA and "Synchronize" in ev.name:
            syncs[ev.name] = syncs.get(ev.name, 0) + 1
    if not kern:
        return {"wall_s": wall_s, "device_busy_share": "not measured",
                "sync_calls": syncs}
    busy_us = union_us((ev.time_range.start, ev.time_range.end) for ev in kern)
    by_name = {}
    for ev in kern:
        tot, cnt = by_name.get(ev.name, (0.0, 0))
        by_name[ev.name] = (tot + ev.time_range.end - ev.time_range.start, cnt + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    ss = {k: {"us_per_launch": v[0] / v[1], "count": v[1]}
          for k, v in by_name.items() if "strongly_see_kernel" in k}
    return {
        "wall_s": wall_s, "device_busy_s": busy_us * 1e-6,
        "device_busy_share": busy_us * 1e-6 / wall_s, "kernel_launches": len(kern),
        "strongly_see": ss, "sync_calls": syncs,
        "top_kernels_us": [{"name": k[:120], "us": v[0], "count": v[1]} for k, v in top]}


def phase_northstar(rec, device="cuda"):
    import torch

    from babble_tpu_torch.ops.dag import synthetic_dag

    n, e, seed = NORTHSTAR
    t0 = time.perf_counter()
    dag, s_rank = synthetic_dag(n, e, seed=seed)
    gen_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with launches_by_site() as sites:
        sec, out, order = _timed_run(dag, s_rank, "auto", device)
    launches = read_launches()
    decided = int((out[4] >= 0).sum())
    rounds, rr, cts = out[0], out[4], out[5]
    max_round = int(rounds.max())
    if rounds.shape != (e,) or rr.shape != (e,) or cts.shape != (e,):
        raise AssertionError("northstar output shapes")
    if decided != NORTHSTAR_DECIDED or rr.max() > max_round:
        raise AssertionError(f"northstar: decided={decided} != {NORTHSTAR_DECIDED}")
    check_sites(dag, "wavefront", launches, sites, _r_small(dag, rounds))
    rec["_northstar_out"] = out  # held against northstar_incremental
    rec["northstar"] = {
        "n": n, "e": e, "seed": seed, "engine": "wavefront", "dag_gen_s": gen_s,
        "levels": list(dag.levels.shape), "seconds": sec, "decided": decided,
        "events_per_s": decided / sec, "max_round": max_round, "launches": launches,
        "launches_by_site": sites,
        "peak_mem_bytes": torch.cuda.max_memory_allocated(),
        "stages_s": stage_times(dag, "wavefront", device)}
    print(f"northstar: n={n} e={e} levels={dag.levels.shape} {sec:.2f} s -> "
          f"{decided} decided ({decided / sec:,.0f} events/s), max_round={max_round}, "
          f"launches={launches} by site {sites}, "
          f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print("northstar stages (s): " + json.dumps(
        {k: round(v, 4) for k, v in rec["northstar"]["stages_s"].items()}))


def sim_fame_chunks(dag, v_n, r) -> int:
    """decide_fame's MATRIX launches for v_n views at round bound r."""
    from babble_tpu_torch.ops.kernels import chunk_width

    return -(-(r - 1) // chunk_width(r - 1, v_n * dag.n * dag.n))


def sim_run(dag, masks, s_rank, fn, device):
    """One simulator entry point `fn(dag, masks, device=device)` on the
    card with the launch counts and the peak memory reset just
    before: (outputs on the host, the views' orders, record). The record
    holds the launches by mode and by site, the decided events per view
    and the peak device memory."""
    import torch

    from babble_tpu_torch.ops.sim import check_view_consistency

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with launches_by_site() as sites:
        t0 = time.perf_counter()
        out = fn(dag, masks, device=device)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    outs = host(out)
    orders = check_view_consistency(dag, outs[4], outs[5], s_ints=s_rank)
    decided = [len(o) for o in orders]
    return outs, orders, {
        "entry": fn.__name__, "seconds": seconds,
        "launches": launches, "launches_by_site": sites,
        "decided_min": min(decided), "decided_max": max(decided),
        "max_round": int(outs[0].max()), "peak_mem_bytes": peak,
        "output_digest": digest(outs)}


def check_sim_launches(name, dag, v_n, res, r) -> None:
    """The rounds stage launches TALLY once per DAG level and fame MATRIX
    once per chunk of voting rounds, for all V views together."""
    want_sites = {"compute_rounds": dag.levels.shape[0], "fame": sim_fame_chunks(dag, v_n, r)}
    want = {"counts": 0, "matrix": want_sites["fame"], "tally": want_sites["compute_rounds"]}
    if res["launches"] != want or res["launches_by_site"] != want_sites:
        raise AssertionError(f"sim {name} {res['entry']}: launches {res['launches']} by "
                             f"site {res['launches_by_site']}, expected {want} by site "
                             f"{want_sites}")


def phase_sim(rec, device="cuda"):
    """The batched view simulator (ops/sim.py) at BASELINE.json's
    configurations 2, 4 and 3 (SIM_CONFIGS): consensus_views_factored
    over every view, its digest against the JAX package's
    (GOLDEN_SIM), check_view_consistency, launches independent of V;
    config 2 also through consensus_views (the fused form at the static
    bound), equal to the same golden; config 3 also
    tests/test_at_scale.py's assertions. Then a GossipSim view on the
    card against the port's host Hashgraph (sim_gossip_check)."""
    import torch

    from babble_tpu_torch.ops.sim import (GossipSim, consensus_views,
                                          consensus_views_factored, simulate_views)

    res = rec["sim"] = {}
    for name in ("config2", "config4", "config3"):
        t0 = time.perf_counter()
        dag, masks, s_rank = sim_views(name, simulate_views)
        gen_s = time.perf_counter() - t0
        v_n = masks.shape[0]
        cfg = {"n": dag.n, "e": dag.e, "views": v_n, "levels": list(dag.levels.shape),
               "k": int(dag.chain.shape[1]), "max_rounds": dag.max_rounds,
               "generation_s": gen_s, "runs": {}}
        res[name] = cfg
        fns = [consensus_views_factored] + ([consensus_views] if name == "config2" else [])
        for fn in fns:
            outs, orders, run = sim_run(dag, masks, s_rank, fn, device)
            cfg["runs"][fn.__name__] = run
            r = dag.max_rounds if fn is consensus_views else _r_small(dag, outs[0])
            print(f"sim {name} {fn.__name__}: n={dag.n} e={dag.e} V={v_n} "
                  f"levels={dag.levels.shape} generation {gen_s:.2f} s, run "
                  f"{run['seconds']:.3f} s, decided per view "
                  f"{run['decided_min']}..{run['decided_max']}, max_round {run['max_round']}, peak "
                  f"{run['peak_mem_bytes'] / 2**30:.2f} GiB, launches {run['launches']} "
                  f"by site {run['launches_by_site']}, digest "
                  f"{'ok' if run['output_digest'] == GOLDEN_SIM[name] else 'MISMATCH'}")
            if run["output_digest"] != GOLDEN_SIM[name]:
                raise AssertionError(f"sim {name} {fn.__name__}: digest "
                                     f"{run['output_digest']} != {GOLDEN_SIM[name]}")
            check_sim_launches(name, dag, v_n, run, r)
        # the factored form again, each stage synchronised
        padded = torch.from_numpy(np.pad(masks, ((0, 0), (0, 1)))).to(device)
        cfg["stages_s"] = stage_times(dag, "wavefront", device, padded)
        print(f"sim {name} stages (s): "
              + json.dumps({k: round(v, 4) for k, v in cfg["stages_s"].items()}))
        if name == "config3":  # tests/test_at_scale.py's assertions
            decided = [len(o) for o in orders]
            n, silent_last = dag.n, SIM_CONFIGS[name]["silent_last"]
            body = dag.creator[n:dag.e]
            if int(outs[0][1].max()) < 4 or min(decided) <= 10_000 or decided[1] <= decided[0]:
                raise AssertionError(f"sim config3: max round {int(outs[0][1].max())}, "
                                     f"decided {decided}")
            if (body >= n - silent_last).any():
                raise AssertionError("sim config3: a silent peer created an event")
            cfg["decided"] = decided
    n, seed, steps = SIM_GOSSIP
    t0 = time.perf_counter()
    sim = GossipSim(n, seed=seed)
    sim.run(steps)
    check = sim_gossip_check(sim, device=device)
    check["seconds"] = time.perf_counter() - t0
    res["gossip_sim"] = check
    print(f"sim GossipSim({n}, seed={seed}).run({steps}): view {check['view']} "
          f"({check['events']} events, {check['decided']} decided) on the card == the host "
          f"Hashgraph: {check['equal']} ({check['seconds']:.2f} s)")
    if not check["equal"]:
        raise AssertionError("sim: the GossipSim view differs from the host Hashgraph")
    # hand the simulator's cached blocks (config 3 peaks near 10 GiB) back
    # to the card, so the phases after it start as they did without it
    torch.cuda.empty_cache()


def engine_state(eng, e):
    """The engine's final state, as GOLDEN_SUSTAINED_OUTPUT digests it."""
    return [eng.rounds[:e], eng.witness[:e], eng.witness_table(), eng.famous,
            eng.rr[:e], eng.cts_ns[:e]]


def engine_vs_one_shot(eng, out, e) -> list:
    """Names of the one-shot outputs (rounds, witness, wt, famous, rr,
    cts on the host) the engine's state disagrees with. The DAG's
    timestamps are its event ids, so a consensus-timestamp rank is the
    engine's ns, and rank -1 (Go's zero time) its CTS_SENTINEL."""
    from babble_tpu_torch.ops.incremental import CTS_SENTINEL

    rounds, wit, wt, famous, rr, cts = out
    wt_abs = eng.witness_table()
    rt = wt_abs.shape[0]
    dec = rr >= 0
    checks = {
        "rounds": (eng.rounds[:e] == rounds).all(),
        "witness": (eng.witness[:e] == wit).all(),
        "wt": (wt_abs == wt[:rt]).all() and (wt[rt:] == -1).all(),
        "famous": eng.famous.shape[0] == rt and (eng.famous == famous[:rt]).all(),
        "rr": (eng.rr[:e] == rr).all(),
        "cts": (eng.cts_ns[:e][dec]
                == np.where(cts < 0, CTS_SENTINEL, cts.astype(np.int64))[dec]).all(),
    }
    return [k for k, ok in checks.items() if not ok]


def engine_batches(dag, e, bs=ENGINE_BATCH):
    """The append_batch arguments of each batch, timestamps = event ids
    (as bench.py feeds the engine)."""
    for k in range(0, e, bs):
        hi = min(k + bs, e)
        yield (dag.self_parent[k:hi], dag.other_parent[k:hi], dag.creator[k:hi],
               dag.index[k:hi], dag.coin[k:hi], np.arange(k, hi))


def check_engine_sites(name, launches, sites) -> None:
    """An engine path launches the gathered kernel from the frontier
    probe, the skip correction and fame, and nothing else."""
    if set(sites) != set(ENGINE_SITES) or min(sites.values()) == 0:
        raise AssertionError(f"{name}: launches by site {sites}, expected {ENGINE_SITES}")
    if launches["counts"] != 0 or launches["matrix"] != sites["fame"] or \
            launches["tally"] != sites["frontier_probe"] + sites["skip_correction"]:
        raise AssertionError(f"{name}: launches {launches} by site {sites}")


def phase_sustained(rec, device="cuda"):
    """bench.py's sustained stage on the port: pipelined append /
    collect / dispatch in batches of 4,096, with the per-batch
    host-blocking wall, phase totals from the fourth pass on, launches
    by site, and the host reads and redos of every pass; then the final
    state against the JAX golden digest and the one-shot pipeline."""
    import torch

    from babble_tpu_torch.ops.dag import synthetic_dag
    from babble_tpu_torch.ops.incremental import IncrementalEngine
    from babble_tpu_torch.ops.pipeline import run_pipeline

    n, e_sus, seed = SUSTAINED
    dag, s_rank = synthetic_dag(n, e_sus, seed=seed)
    in_digest = dag_digest(dag, s_rank)
    if in_digest != GOLDEN_SUSTAINED_INPUT:
        raise AssertionError(f"sustained input digest {in_digest} != golden")
    eng = IncrementalEngine(n, device=device, **SUSTAINED_ENGINE)
    phase_tot, passes = {}, []
    overlap_ns = 0
    prof_from = 3  # the first passes pay the allocator's first allocations

    def harvest(b_i):
        nonlocal overlap_ns
        passes.append({"host_syncs": eng.host_syncs, "redo_count": eng.redo_count,
                       "windows": dict(eng._dbg_windows), "pull_bytes": eng.c_pull_bytes})
        if b_i >= prof_from:
            for ph, ns in eng.phase_ns.items():
                phase_tot[ph] = phase_tot.get(ph, 0) + ns
            overlap_ns += eng.last_overlap_ns

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with launches_by_site() as sites:
        t0 = time.perf_counter()
        per_batch = []
        pending = None
        b_i = 0
        for batch in engine_batches(dag, e_sus):
            tb = time.perf_counter()
            eng.append_batch(*batch)
            if pending is not None:
                eng.collect(pending)
                harvest(b_i)
            pending = eng.dispatch()
            per_batch.append(time.perf_counter() - tb)
            b_i += 1
        if pending is not None:
            eng.collect(pending)
            harvest(b_i)
        pending = eng.dispatch()  # appends staged during the last pass
        if pending is not None:
            eng.collect(pending)
            harvest(b_i + 1)
        total = time.perf_counter() - t0
    launches = read_launches()
    eng.close()
    if e_sus % ENGINE_BATCH:
        per_batch = per_batch[:-1]
    half = per_batch[len(per_batch) // 2:]
    steady = statistics.median(half)
    decided = int((eng.rr[:e_sus] >= 0).sum())
    top = {ph: ns for ph, ns in phase_tot.items() if ph not in ("c_pull_wait", "c_pull_xfer")}
    # frontier / rounds / fame_rr split c_dispatch, as wait / xfer split c_pull
    share_keys = ("coords", "fd_fold", "stage", "c_dispatch", "c_stage_wait", "c_pull",
                  "consensus", "apply")
    denom = sum(top.get(k, 0) for k in share_keys) or 1
    out_digest = digest(engine_state(eng, e_sus))
    res = {
        "n": n, "e": e_sus, "seed": seed, "batch": ENGINE_BATCH, "engine": SUSTAINED_ENGINE,
        "total_s": total, "events_per_s": e_sus / total,
        "steady_batch_s": steady, "steady_events_per_s": ENGINE_BATCH / steady,
        "per_batch_s": per_batch, "decided": decided, "redo_count": eng.redo_count,
        "passes": len(passes), "per_pass": passes,
        "host_syncs_per_pass": [p["host_syncs"] for p in passes],
        "phase_ms": {k: v / 1e6 for k, v in phase_tot.items()},
        "phase_share": {k: top.get(k, 0) / denom for k in share_keys},
        "part_share": {k: phase_tot.get(k, 0) / denom
                       for k in ("frontier", "rounds", "fame_rr", "c_pull_wait", "c_pull_xfer")},
        "overlap_ms": overlap_ns / 1e6, "launches": launches, "launches_by_site": sites,
        "launches_per_pass": {k: v / len(passes) for k, v in sites.items()},
        "peak_mem_bytes": torch.cuda.max_memory_allocated(), "output_digest": out_digest}
    rec["sustained"] = res
    print(f"sustained: n={n} e={e_sus} batch={ENGINE_BATCH}: {total:.2f} s "
          f"({e_sus / total:,.0f} events/s), steady {ENGINE_BATCH / steady:,.0f} events/s "
          f"(median {steady * 1e3:.1f} ms of the second half, spread "
          f"{min(half) * 1e3:.1f}-{max(half) * 1e3:.1f} ms), {decided} decided, "
          f"{len(passes)} passes, redo_count {eng.redo_count}, host reads per pass "
          f"{res['host_syncs_per_pass']}")
    print(f"sustained launches {launches} by site {sites}; per pass "
          + json.dumps({k: round(v, 1) for k, v in res["launches_per_pass"].items()}))
    print("sustained phase shares: " + json.dumps(
        {k: round(v, 4) for k, v in {**res["phase_share"], **res["part_share"]}.items()}))
    print(f"sustained peak device memory {res['peak_mem_bytes'] / 2**30:.2f} GiB; "
          f"state digest {'ok' if out_digest == GOLDEN_SUSTAINED_OUTPUT else 'MISMATCH'}")
    if launches["matrix"] == 0 or launches["tally"] == 0:
        raise AssertionError(f"sustained launches {launches}: a kernel was never launched")
    check_engine_sites("sustained", launches, sites)
    if decided != SUSTAINED_DECIDED:
        raise AssertionError(f"sustained: {decided} decided != {SUSTAINED_DECIDED}")
    if out_digest != GOLDEN_SUSTAINED_OUTPUT:
        raise AssertionError(f"sustained: state digest {out_digest} != golden")
    one_shot = host(run_pipeline(dag, device=device))
    bad = engine_vs_one_shot(eng, one_shot, e_sus)
    res["equal_to_one_shot"] = not bad
    print(f"sustained state == one-shot run_pipeline on the card: {not bad}")
    if bad:
        raise AssertionError(f"sustained: engine differs from the one-shot run in {bad}")


def signed_gossip(n, e, seed, key_seed=HASHGRAPH_KEY_SEED):
    """Random-gossip stream of signed events (the shape the node
    runtime produces), built with the port's modules only: the first n
    events one per creator, then a random creator syncs from a random
    other peer. Signatures are RFC 6979 (deterministic), so the stream
    is the same on every machine: through libcrypto when it loads
    (_openssl), else in pure Python (_fallback); both give the same bits.
    Returns (events, participants, signer name)."""
    from babble_tpu_torch.crypto import _fallback, _openssl
    from babble_tpu_torch.gojson import BigInt, Timestamp
    from babble_tpu_torch.hashgraph import Event

    keys = [_fallback.key_from_seed(key_seed + i) for i in range(n)]
    pubs = [_fallback.pub_key_bytes(k) for k in keys]
    participants = {"0x" + p.hex().upper(): i for i, p in enumerate(pubs)}
    if _openssl.available():
        signer = "_openssl.sign (libcrypto, RFC 6979)"

        def sign(key, digest):
            return _openssl.sign(key.d, digest)
    else:
        signer, sign = "_fallback.sign (pure Python, RFC 6979)", _fallback.sign
    rng = np.random.default_rng(seed)
    creators = np.concatenate([np.arange(n), rng.integers(0, n, size=e - n)])
    others = rng.integers(1, n, size=e)
    heads, seqs, events = [""] * n, [-1] * n, []
    clock = HASHGRAPH_CLOCK_NS
    for i in range(e):
        c = int(creators[i])
        op = heads[(c + int(others[i])) % n] if i >= n else ""
        clock += 1_000_000
        seqs[c] += 1
        ev = Event.new([b"tx%d" % i], [heads[c], op], pubs[c], seqs[c],
                       timestamp=Timestamp(clock))
        r, s = sign(keys[c], ev.body.hash())
        # As Event.sign sets them: R/S, the memos they invalidate, and
        # the verdict of an event signed with its creator's own key.
        ev.r, ev.s = BigInt(r), BigInt(s)
        ev.invalidate(body=False)
        ev._sig_ok = True
        heads[c] = ev.hex()
        events.append(ev)
    return events, participants, signer


def hashgraph_input_digest(events) -> str:
    return hashlib.sha256("\n".join(ev.hex() for ev in events).encode()).hexdigest()


def hashgraph_output_digest(order, blocks, last_consensus_round) -> str:
    """sha256 over the consensus order's hexes, then each committed
    block's Go-JSON bytes, then last_consensus_round."""
    h = hashlib.sha256()
    for x in order:
        h.update(x.encode() + b"\n")
    for b in blocks:
        h.update(b.marshal())
    h.update(str(last_consensus_round).encode())
    return h.hexdigest()


def drive_graph(hg, events, batch=ENGINE_BATCH, on_pass=None):
    """The node's pipelined consensus loop over a device graph: insert
    batch k+1 through insert_wire_batch while pass k is in flight, then
    collect it and dispatch the next; at the end drain until dispatch
    returns None. Returns the seconds of each insert_wire_batch and the
    wall of each loop step (insert + collect + dispatch). `on_pass` is
    called after each collect."""
    insert_s, step_s = [], []
    pending = None

    def collect(pp):
        hg.collect_consensus(pp)
        if on_pass is not None:
            on_pass()

    for lo in range(0, len(events), batch):
        t0 = time.perf_counter()
        hg.insert_wire_batch(events[lo:lo + batch])
        insert_s.append(time.perf_counter() - t0)
        if pending is not None:
            collect(pending)
        pending = hg.dispatch_consensus()
        step_s.append(time.perf_counter() - t0)
    if pending is not None:
        collect(pending)
    while (pending := hg.dispatch_consensus()) is not None:
        collect(pending)
    return insert_s, step_s


def phase_hashgraph(rec, device="cuda"):
    """Signed events through the port's TorchHashgraph on the card,
    driven as the node drives it (drive_graph): input and output digests
    against the JAX reference package's (GOLDEN_HASHGRAPH_*), the same
    order as the port's one-shot run_consensus_batch on the card, B1
    launches by site, and a frame reset replayed on a fresh graph."""
    import torch

    from babble_tpu_torch.crypto import BACKEND
    from babble_tpu_torch.hashgraph import Event, Hashgraph, InmemStore, TorchHashgraph
    from babble_tpu_torch.ops.engine import run_consensus_batch

    n, e, seed = HASHGRAPH
    t0 = time.perf_counter()
    events, participants, signer = signed_gossip(n, e, seed)
    build_s = time.perf_counter() - t0
    in_digest = hashgraph_input_digest(events)
    # ECDSA verify on this host, for a sample of fresh copies (the
    # events above carry their signer's verdict, as Event.sign leaves it).
    sample = [Event(ev.body, r=ev.r, s=ev.s) for ev in events[:2048]]
    t0 = time.perf_counter()
    if not all(ev.verify() for ev in sample):
        raise AssertionError("hashgraph: a signature does not verify")
    verify_ms = (time.perf_counter() - t0) / len(sample) * 1e3
    print(f"hashgraph: crypto backend {BACKEND}, signer {signer}; built and signed "
          f"{e} events in {build_s:.2f} s; verify {verify_ms:.3f} ms per event; "
          f"input digest {'ok' if in_digest == GOLDEN_HASHGRAPH_INPUT else 'MISMATCH'}")
    if in_digest != GOLDEN_HASHGRAPH_INPUT:
        raise AssertionError(f"hashgraph input digest {in_digest} != golden")

    blocks = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem_at_start = torch.cuda.memory_allocated()
    hg = TorchHashgraph(participants, InmemStore(participants, HASHGRAPH_CACHE),
                        blocks.append, device=device, **HASHGRAPH_ENGINE)
    apply_s, syncs, phase_tot = [], [], {}
    real_apply = hg._apply_delta_atomically

    def timed_apply(delta):
        t = time.perf_counter()
        real_apply(delta)
        apply_s.append(time.perf_counter() - t)

    hg._apply_delta_atomically = timed_apply
    def on_pass():
        syncs.append(hg.engine.host_syncs)
        for ph, ns in hg.engine.phase_ns.items():
            phase_tot[ph] = phase_tot.get(ph, 0) + ns

    reset_launches()
    with launches_by_site() as sites:
        t0 = time.perf_counter()
        insert_s, step_s = drive_graph(hg, events, on_pass=on_pass)
        total = time.perf_counter() - t0
    launches = read_launches()
    hg.close()
    order = hg.consensus_events()
    decided = len(order)
    out_digest = hashgraph_output_digest(order, blocks, hg.last_consensus_round)
    res = {
        "n": n, "e": e, "seed": seed, "batch": ENGINE_BATCH, "engine": HASHGRAPH_ENGINE,
        "crypto_backend": BACKEND, "signer": signer, "build_sign_s": build_s,
        "verify_ms_per_event": verify_ms, "total_s": total,
        "consensus_events_per_s": decided / total, "events_per_s": e / total,
        "insert_s": insert_s, "step_s": step_s, "apply_s": apply_s,
        "insert_total_s": sum(insert_s), "apply_total_s": sum(apply_s),
        "passes": len(apply_s), "host_syncs_per_pass": syncs,
        "engine_phase_ms": {k: v / 1e6 for k, v in phase_tot.items()},
        "redo_count": hg.engine.redo_count, "decided": decided, "blocks": len(blocks),
        "last_consensus_round": hg.last_consensus_round,
        "launches": launches, "launches_by_site": sites,
        "peak_mem_bytes": torch.cuda.max_memory_allocated(),
        "mem_at_start_bytes": mem_at_start,
        "input_digest": in_digest, "output_digest": out_digest}
    rec["hashgraph"] = res
    print(f"hashgraph: n={n} e={e} batch={ENGINE_BATCH}: {total:.2f} s from the first "
          f"insert to the drained last pass ({decided / total:,.0f} consensus events/s), "
          f"{decided} decided, {len(blocks)} blocks, last consensus round "
          f"{hg.last_consensus_round}, {len(apply_s)} passes, redo_count "
          f"{hg.engine.redo_count}, host reads per pass {syncs}")
    print("hashgraph insert_wire_batch s per batch: "
          + json.dumps([round(x, 4) for x in insert_s]))
    print("hashgraph loop step s (insert + collect + dispatch): "
          + json.dumps([round(x, 4) for x in step_s]))
    print("hashgraph store mirror + blocks s per pass: "
          + json.dumps([round(x, 4) for x in apply_s]))
    print("hashgraph engine phases (ms, unsynchronised): " + json.dumps(
        {k: round(v, 1) for k, v in res["engine_phase_ms"].items()}))
    print(f"hashgraph launches {launches} by site {sites}; peak device memory "
          f"{res['peak_mem_bytes'] / 2**30:.2f} GiB ({mem_at_start / 2**30:.2f} GiB "
          f"held before the graph was made); output digest "
          f"{'ok' if out_digest == GOLDEN_HASHGRAPH_OUTPUT else 'MISMATCH'}")
    check_engine_sites("hashgraph", launches, sites)
    if decided != HASHGRAPH_DECIDED:
        raise AssertionError(f"hashgraph: {decided} decided != {HASHGRAPH_DECIDED}")
    if out_digest != GOLDEN_HASHGRAPH_OUTPUT:
        raise AssertionError(f"hashgraph output digest {out_digest} != golden")

    t0 = time.perf_counter()
    batch = run_consensus_batch(events, participants, device=device)
    res["one_shot_s"] = time.perf_counter() - t0
    res["equal_to_one_shot"] = batch.consensus_order == order
    print(f"hashgraph: one-shot run_consensus_batch on the card {res['one_shot_s']:.2f} s, "
          f"{len(batch.consensus_order)} decided, same order: {res['equal_to_one_shot']}")
    if not res["equal_to_one_shot"]:
        raise AssertionError("hashgraph: the one-shot order differs from TorchHashgraph's")

    # Frame reset: a fresh graph reset to the frame's roots and fed its
    # events decides as the port's host Hashgraph (the reference
    # semantics, held against the JAX package by the CPU tests) does
    # after the same reset. The replay re-decides the last consensus
    # round's successors, which may reach past what the original run
    # decided: the reference does the same.
    t0 = time.perf_counter()
    frame = hg.get_frame()
    replay = {}
    for kind in ("device", "host"):
        g = (TorchHashgraph(participants, InmemStore(participants, HASHGRAPH_CACHE),
                            device=device, **HASHGRAPH_ENGINE) if kind == "device"
             else Hashgraph(participants, InmemStore(participants, HASHGRAPH_CACHE)))
        g.reset(frame.roots)
        for ev in frame.events:
            g.insert_event(Event(ev.body, r=ev.r, s=ev.s), False)
        g.run_consensus()
        if kind == "device":
            g.close()
        replay[kind] = (g.consensus_events(), g.last_consensus_round,
                        [(g.round(ev.hex()), g.round_received(ev.hex())) for ev in frame.events])
    decided_before = set(order)
    res["frame"] = {"events": len(frame.events), "decided": len(replay["device"][0]),
                    "already_decided": sum(x in decided_before for x in replay["device"][0]),
                    "last_consensus_round": replay["device"][1],
                    "seconds": time.perf_counter() - t0,
                    "equal_to_host": replay["device"] == replay["host"]}
    print(f"hashgraph frame reset: {len(frame.events)} frame events replayed, "
          f"{res['frame']['decided']} decided ({res['frame']['already_decided']} of them "
          f"decided by the original run), last consensus round {replay['device'][1]}; "
          f"equal to the host Hashgraph's replay: {res['frame']['equal_to_host']}")
    if not res["frame"]["equal_to_host"]:
        raise AssertionError("hashgraph: the frame replay differs from the host graph's")


def node_keys(n):
    """The node phase's keys (seeds NODE_KEY_SEED + i) and public keys,
    in canonical (sorted public key) order."""
    from babble_tpu_torch import crypto

    keyed = sorted(((k, "0x" + crypto.pub_key_bytes(k).hex().upper())
                    for k in (crypto.key_from_seed(NODE_KEY_SEED + i) for i in range(n))),
                   key=lambda kp: kp[1])
    return [k for k, _ in keyed], [p for _, p in keyed]


def stored_events(store, participants):
    """Every event of a store, in its graph's insertion order."""
    evs = [store.get_event(h) for pk in participants for h in store.participant_events(pk, -1)]
    return sorted(evs, key=lambda e: e.topological_index)


def committed_blocks(hg, last=None) -> dict:
    """{round received: block bytes} of the blocks a graph committed, up
    to `last` (default: its last consensus round)."""
    from babble_tpu_torch.common import StoreError

    last = hg.last_consensus_round if last is None else last
    out = {}
    for rr in range((last if last is not None else -1) + 1):
        try:
            out[rr] = hg.store.get_block(rr).marshal()
        except StoreError:
            continue
    return out


def prefix_equal(a, b) -> bool:
    m = min(len(a), len(b))
    return a[:m] == b[:m]


def node_core_script(device, engine_mesh=0):
    """tests/test_failover.py's make_cores + gossip_script on the port:
    one Core(engine="torch", device_verify=True) on the card with the
    default presize among three host Cores, NODE_SCRIPT's scripted syncs;
    every sync into it verifies on the P-256 kernel (no host fallback
    exists to take a sync). Its events are then
    fed to a host-engine twin Core (same key, same events, a pass where
    the torch core ran one), which must agree in consensus events, block
    bytes, head/seq, rounds and round-received. With engine_mesh > 1
    the torch core's engine is split into that many shards
    (Config.engine_mesh), and a second twin, the single-device torch
    Core fed the same way, must commit the same block bytes."""
    import random

    from babble_tpu_torch.hashgraph import Event, InmemStore
    from babble_tpu_torch.node import Core
    from babble_tpu_torch.node.ingest import active_backend

    steps, seed, every = NODE_SCRIPT
    keys, pubs = node_keys(NODE_N)
    participants = {pk: i for i, pk in enumerate(pubs)}
    commits = []
    cores = [Core(i, keys[i], participants, InmemStore(participants, NODE_CACHE),
                  commit_callback=commits.append if i == 0 else None,
                  engine="torch" if i == 0 else "host",
                  engine_mesh=engine_mesh if i == 0 else 0,
                  engine_opts={"device": device} if i == 0 else None,
                  device_verify=(i == 0))
             for i in range(NODE_N)]
    dev = cores[0]
    for c in cores:
        c.init()
    rng = random.Random(seed)
    marks = []

    def run(i):
        if i == 0:
            marks.append(dev.hg.topological_index)
        cores[i].run_consensus()

    reset_launches()
    with launches_by_site() as sites:
        t0 = time.perf_counter()
        for step in range(steps):
            a, b = rng.sample(range(NODE_N), 2)
            diff = cores[b].diff(cores[a].known())
            if rng.random() < 0.5:
                cores[a].add_transactions([f"tx {step}".encode()])
            cores[a].sync(cores[b].to_wire(diff))
            if step % every == 0:
                run(a)
        for i in range(NODE_N):
            run(i)
        script_s = time.perf_counter() - t0
    launches = read_launches()
    verify_launches = p256_launches()
    verify_phase = dev.phase_ns.get("verify_device-p256", [0, 0, 0])
    shards = len(dev.hg.engine.shards("_la"))
    dev.hg.close()

    events = stored_events(dev.hg.store, participants)

    def replay(engine):
        """A twin Core on `engine` fed the torch core's events, a pass
        where it ran one; returns it and its commits."""
        twin_commits = []
        twin = Core(0, keys[0], participants, InmemStore(participants, NODE_CACHE),
                    commit_callback=twin_commits.append, engine=engine,
                    engine_opts={"device": device} if engine == "torch" else None)
        k = 0
        for m in marks + [len(events)]:
            for ev in events[k:m]:
                twin.insert_event(Event(ev.body, r=ev.r, s=ev.s), True)
            k = max(k, m)
            twin.run_consensus()
        if engine == "torch":
            twin.hg.close()
        return twin, twin_commits

    twin, twin_commits = replay("host")
    order = dev.get_consensus_events()
    checks = {
        "consensus_events": twin.get_consensus_events() == order,
        "blocks": [b.marshal() for b in twin_commits] == [b.marshal() for b in commits],
        "head_seq": (twin.head, twin.seq) == (dev.head, dev.seq),
        "last_consensus_round": (twin.get_last_consensus_round_index()
                                 == dev.get_last_consensus_round_index()),
        "rounds": all((dev.hg.round(ev.hex()), dev.hg.round_received(ev.hex()))
                      == (twin.hg.round(ev.hex()), twin.hg.round_received(ev.hex()))
                      for ev in events),
        "host_cores_prefix": all(prefix_equal(order, c.get_consensus_events())
                                 for c in cores[1:]),
        "p256_launched": verify_launches > 0,
        # no sync verified by the host backend; the Core's verify_*
        # counters (prelude, window tables, signatures) are not backends
        "verify_on_device": (verify_phase[2] > 0
                             and "verify_" + active_backend(False) not in dev.phase_ns),
        "shards": shards == max(engine_mesh, 1),
    }
    if engine_mesh > 1:
        single, single_commits = replay("torch")
        checks["blocks_single_device"] = (
            [b.marshal() for b in single_commits] == [b.marshal() for b in commits])
        checks["consensus_events_single_device"] = single.get_consensus_events() == order
    res = {"steps": steps, "seed": seed, "consensus_every": every, "shards": shards,
           "engine": {k: getattr(dev.hg.engine, a) for k, a in
                      (("capacity", "cap"), ("block", "block"), ("k_capacity", "kcap"))},
           "events": len(events), "decided": len(order), "blocks": len(commits),
           "passes": len(marks), "last_consensus_round": dev.get_last_consensus_round_index(),
           "script_s": script_s, "launches": launches, "launches_by_site": sites,
           "p256_launches": verify_launches,
           "verify_device_p256": {"calls": verify_phase[2], "total_ms": verify_phase[1] / 1e6},
           "checks": checks}
    print(f"node core script: {steps} syncs (seed {seed}, consensus every {every}), torch "
          f"core on {device} in {shards} shard(s) with {res['engine']}: {len(events)} "
          f"events, {len(order)} "
          f"decided, {len(commits)} blocks, last consensus round "
          f"{res['last_consensus_round']}, {len(marks)} passes, {script_s:.2f} s; "
          f"launches {launches} by site {sites}; P-256 launches {verify_launches}, "
          f"verify_device-p256 {verify_phase[2]} calls {verify_phase[1] / 1e6:.1f} ms; "
          f"against the twins: {checks}")
    bad = [name for name, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"node core script: the torch core differs in {bad}")
    if not commits:
        raise AssertionError("node core script: no block committed")
    check_engine_sites("node core script", launches, sites)
    return res


@functools.lru_cache(maxsize=None)
def _recording_proxy_class():
    from babble_tpu_torch.proxy import InmemAppProxy

    class RecordingProxy(InmemAppProxy):
        """Also keeps each delivered block's round and bytes."""

        def __init__(self):
            super().__init__()
            self.blocks = []

        def commit_block(self, block):
            with self._lock:
                self.blocks.append((block.round_received, block.marshal()))
            super().commit_block(block)

    return RecordingProxy


def recording_proxy():
    """An InmemAppProxy that also keeps each delivered block's round and
    bytes in `.blocks`, in delivery order."""
    return _recording_proxy_class()()


# Blocks a stopped node may have committed and neither delivered nor
# still queued: the one its commit forwarder held when shutdown was set
# (ROADMAP §C).
DELIVERY_ALLOWANCE = 1


def queued_blocks(node) -> dict:
    """{round received: block bytes} of the blocks a stopped node still
    holds for delivery (its work queue and commit_ch): what its
    consensus worker committed after shutdown() drained them. Empties
    both queues; call once every routine of the node has ended."""
    out = {}
    for q in (node._work, node.commit_ch):
        while True:
            try:
                item = q.get_nowait()
            except queue.Empty:
                break
            if q is node._work:
                tag, item = item
                if tag != "block":
                    continue
            out[item.round_received] = item.marshal()
    return out


def delivery_check(node, own: dict):
    """A stopped node's app delivery against what it committed. `own` is
    {round: block bytes} of its store's blocks (committed_blocks).
    Delivered blocks come in round order and equal the committed ones;
    every committed block with transactions was delivered or is still
    queued (queued_blocks), all but DELIVERY_ALLOWANCE of them, and the
    queued ones all come after the delivered ones. A block without
    transactions is stored but never handed to the app (both graphs
    call the commit callback only for a block with transactions): the
    rounds a node decides after the last transaction was submitted have
    such blocks. Returns (ok, counts)."""
    store = node.core.hg.store
    own = {rr: blk for rr, blk in own.items() if store.get_block(rr).transactions}
    delivered = node.proxy.blocks
    rounds = [rr for rr, _ in delivered]
    held = queued_blocks(node)
    lost = sorted(own.keys() - set(rounds) - held.keys())
    ok = (rounds == sorted(set(rounds))
          and all(own.get(rr) == blk for rr, blk in delivered)
          and all(own.get(rr) == blk for rr, blk in held.items())
          and (not held or not rounds or min(held) > max(rounds))
          and len(lost) <= DELIVERY_ALLOWANCE)
    return ok, {"delivered": len(rounds), "queued": len(held), "lost": lost}


def build_node_net(device):
    """bench.py's build_host_testnet for the device engine on the port:
    NODE_N Nodes on InmemTransport (connect_all), each with an
    InmemStore(participants, NODE_CACHE), a recording InmemAppProxy and
    test_config(heartbeat=NODE_HEARTBEAT, cache_size=NODE_CACHE), on
    engine="torch" with the default presize, engine_prewarm on and
    consensus_interval NODE_INTERVAL as the floor of the adaptive
    cadence (pipeline_depth 1)."""
    from babble_tpu_torch.hashgraph import InmemStore
    from babble_tpu_torch.net import InmemTransport, Peer
    from babble_tpu_torch.net.inmem_transport import connect_all
    from babble_tpu_torch.node import Node
    from babble_tpu_torch.node.config import test_config

    keys, pubs = node_keys(NODE_N)
    peers = [Peer(f"addr{i}", pub) for i, pub in enumerate(pubs)]
    participants = {p.pub_key_hex: i for i, p in enumerate(peers)}
    transports = [InmemTransport(p.net_addr, timeout=2.0) for p in peers]
    connect_all(transports)
    nodes = []
    for i, key in enumerate(keys):
        conf = test_config(heartbeat=NODE_HEARTBEAT, cache_size=NODE_CACHE)
        conf.engine = "torch"
        conf.engine_opts = {"device": device}
        conf.engine_prewarm = True
        conf.consensus_interval = NODE_INTERVAL
        conf.pipeline_depth = 1
        node = Node(conf, i, key, peers, InmemStore(participants, NODE_CACHE),
                    transports[i], recording_proxy())
        node.init()
        nodes.append(node)
    return nodes, participants


COST_KEYS = {"flops", "bytes_accessed", "output_bytes", "temp_bytes"}
COST_SHAPES = {"n", "sm", "rcap", "bp", "rw", "iw", "cb", "tw"}


def cost_report_ok(report) -> bool:
    """An engine cost report has the JAX engine's key set, positive
    counts, and the node's width."""
    return (isinstance(report, dict) and set(report) == {"consensus_fused", "shapes"}
            and set(report["consensus_fused"]) == COST_KEYS
            and all(v > 0 for v in report["consensus_fused"].values())
            and set(report["shapes"]) == COST_SHAPES and report["shapes"]["n"] == NODE_N)


class FailedPassRecords(logging.Handler):
    """Counts the port's "consensus pass failed" log records."""

    def __init__(self):
        super().__init__()
        self.count = 0

    def emit(self, record):
        if record.getMessage().startswith(FAILED_PASS):
            self.count += 1


def phase_node(rec, device="cuda"):
    """(a) node_core_script; (b) a live NODE_N-node net on the card
    (build_node_net), bench.py's node stage: a transaction every
    NODE_TX_EVERY_S round robin, warm-up until every node committed
    NODE_WARM_EVENTS consensus events or NODE_WARM_S, then one
    NODE_WINDOW_S window (a NODE_PROFILE_S torch.profiler slice in its
    middle). Gates: round >= 5 everywhere; no node fast-forwarded (a
    fast-forwarded node's blocks can differ from its peers' for rounds
    past its frame, and it can deliver again blocks it had delivered:
    reference behaviours, ROADMAP §C); consensus events and
    transactions agree on the common prefix; committed blocks equal
    byte for byte on every round two nodes both hold; every node's
    routines ended, and delivery_check holds on each; no transaction
    committed twice or never submitted; the node that decided the
    most, its events replayed into a fresh host Hashgraph and into a
    lone TorchHashgraph, gives its blocks byte for byte; every node
    still on the device engine with no failover and no failed pass;
    B1 launched at all three engine sites."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from babble_tpu_torch.hashgraph import Event, Hashgraph, InmemStore, TorchHashgraph

    res = rec["node"] = {"core_script": node_core_script(device)}
    rec["node_core_script"] = res["core_script"]

    failed = FailedPassRecords()
    logger = logging.getLogger("babble_tpu_torch")
    logger.addHandler(failed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t_build = time.perf_counter()
    nodes, participants = build_node_net(device)
    build_s = time.perf_counter() - t_build
    submitted = []
    stop = threading.Event()

    def bombard():
        i = 0
        while not stop.is_set():
            tx = b"bench tx %d" % i
            nodes[i % NODE_N].submit_tx(tx)
            submitted.append(tx)
            i += 1
            time.sleep(NODE_TX_EVERY_S)

    def committed():
        return min(len(nd.core.get_consensus_events()) for nd in nodes)

    # One process, dozens of Python threads: bench.py's node stage
    # raises the interpreter's switch interval to 0.1 s, and so does
    # this phase; restored below.
    old_switch = sys.getswitchinterval()
    sys.setswitchinterval(0.1)
    bomber = threading.Thread(target=bombard, daemon=True, name="node-phase-bombard")
    reset_launches()
    try:
        with launches_by_site() as sites:
            for nd in nodes:
                nd.run_async(gossip=True)
            bomber.start()
            t0 = time.monotonic()
            while time.monotonic() - t0 < NODE_WARM_S and committed() < NODE_WARM_EVENTS:
                time.sleep(0.25)
            warm_s = time.monotonic() - t0
            lat0 = [nd._m_commit_latency.snapshot() for nd in nodes]
            pass0 = [nd.core._m_pass.snapshot() for nd in nodes]
            c0, w0 = committed(), time.monotonic()
            time.sleep((NODE_WINDOW_S - NODE_PROFILE_S) / 2)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                p0 = time.monotonic()
                time.sleep(NODE_PROFILE_S)
                prof_wall = time.monotonic() - p0
            # /debug/profile?cost=1's source: arms the engine's one-shot
            # cost capture and waits for the next pass to record it.
            cost = nodes[0].core.engine_cost_report(wait_s=5.0)
            time.sleep(max(0.0, w0 + NODE_WINDOW_S - time.monotonic()))
            c1, w1 = committed(), time.monotonic()
            lat = pas = None
            for nd, l0, q0 in zip(nodes, lat0, pass0):
                dl, dq = nd._m_commit_latency.snapshot() - l0, nd.core._m_pass.snapshot() - q0
                lat = dl if lat is None else lat.merge(dl)
                pas = dq if pas is None else pas.merge(dq)
            stop.set()
            bomber.join(timeout=10)
            for nd in nodes:
                nd.shutdown()
            # shutdown() joins its threads for 2 s at most; the
            # consensus worker drains its pass in flight before it ends.
            for nd in nodes:
                nd.state.wait_routines(timeout=60.0)
    finally:
        stop.set()
        sys.setswitchinterval(old_switch)
        logger.removeHandler(failed)
        for nd in nodes:
            nd.shutdown()
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    running = [sum(t.is_alive() for t in list(nd.state._threads)) for nd in nodes]

    states = [(nd.core.engine_state, nd.core.engine_failovers) for nd in nodes]
    engine_bytes = [nd.core.hg.engine.device_memory_stats().get("device_bytes")
                    if hasattr(nd.core.hg, "engine") else None for nd in nodes]
    for nd in nodes:
        close = getattr(nd.core.hg, "close", None)
        if close is not None:
            close()
    orders = [nd.core.get_consensus_events() for nd in nodes]
    txs = [nd.core.get_consensus_transactions() for nd in nodes]
    blocks = [committed_blocks(nd.core.hg) for nd in nodes]
    sent = set(submitted)
    fast_forwards = [nd.fast_forwards for nd in nodes]
    ref = max(range(NODE_N), key=lambda k: len(orders[k]))
    delivery = [delivery_check(nd, b) for nd, b in zip(nodes, blocks)]
    phases = {}
    for nd in nodes:
        for ph, ent in nd.core.phase_ns.items():
            if ph.startswith("engine_"):
                phases[ph] = phases.get(ph, 0) + ent[1] / 1e6

    # The reference node's events through a fresh host Hashgraph.
    t_rep = time.perf_counter()
    events = stored_events(nodes[ref].core.hg.store, participants)
    host = Hashgraph(participants, InmemStore(participants, NODE_CACHE))
    for ev in events:
        host.insert_event(Event(ev.body, r=ev.r, s=ev.s), True)
    host.run_consensus()
    replay_blocks = committed_blocks(host, nodes[ref].core.get_last_consensus_round_index())
    replay_s = time.perf_counter() - t_rep
    # The same events through one TorchHashgraph on the card with no
    # other thread running, in as many pipelined batches as that node had
    # passes: the pass wall without the net's contention.
    alone = TorchHashgraph(participants, InmemStore(participants, NODE_CACHE), device=device)
    passes_ref = nodes[ref].core.phase_ns.get("consensus_collect", [0, 0, 0])[2]
    batch = -(-len(events) // max(1, passes_ref))
    _, alone_steps = drive_graph(alone, [Event(ev.body, r=ev.r, s=ev.s) for ev in events],
                                 batch=batch)
    alone.close()
    alone_blocks = committed_blocks(alone, nodes[ref].core.get_last_consensus_round_index())

    checks = {
        "round_5": all((nd.core.get_last_consensus_round_index() or 0) >= 5 for nd in nodes),
        "no_fast_forward": not any(fast_forwards),
        "consensus_events": all(prefix_equal(orders[ref], o) for o in orders),
        "transactions": all(prefix_equal(txs[ref], t) for t in txs),
        # Committed blocks agree on every round two nodes both hold.
        "blocks": bool(blocks[ref]) and all(
            b[rr] == blocks[ref][rr] for b in blocks for rr in b.keys() & blocks[ref].keys()),
        "stopped": not any(running),
        "delivered": all(ok for ok, _ in delivery),
        "no_duplicate_tx": all(len(t) == len(set(t)) for t in
                               (nd.proxy.committed_transactions() for nd in nodes)),
        "all_submitted": all(set(nd.proxy.committed_transactions()) <= sent for nd in nodes),
        "host_replay": replay_blocks == blocks[ref]
                       and prefix_equal(host.consensus_events(), orders[ref]),
        "device_replay": alone_blocks == blocks[ref],
        "device_engine": all(st == ("device", 0) for st in states),
        "no_failed_pass": failed.count == 0,
        "cost_report": cost_report_ok(cost),
    }
    rate = (c1 - c0) / (w1 - w0)
    prof_sum = profile_summary(prof, prof_wall)
    res.update({
        "n": NODE_N, "heartbeat": NODE_HEARTBEAT, "consensus_interval": NODE_INTERVAL,
        "tx_every_s": NODE_TX_EVERY_S, "build_s": build_s, "warm_s": warm_s,
        "window_s": w1 - w0, "committed_events_per_s": rate,
        "commit_latency_p50_ms": lat.quantile(0.5) * 1e3 if lat.count else None,
        "commit_latency_p99_ms": lat.quantile(0.99) * 1e3 if lat.count else None,
        "commit_latency_samples": lat.count,
        "passes_per_node": [nd.core.phase_ns.get("consensus_collect", [0, 0, 0])[2]
                            for nd in nodes],
        "window_passes": pas.count,
        "pass_wall_p50_ms": pas.quantile(0.5) * 1e3 if pas.count else None,
        # Committed events per pass (the slowest node's growth over the
        # mean passes per node), and the median pass wall per event.
        "window_events_per_pass": (c1 - c0) * NODE_N / pas.count if pas.count else None,
        "pass_ms_per_event": (pas.quantile(0.5) * 1e3 * pas.count / ((c1 - c0) * NODE_N)
                              if pas.count and c1 > c0 else None),
        "engine_phase_ms": phases, "launches": launches, "launches_by_site": sites,
        "engine_device_bytes": engine_bytes, "peak_mem_bytes": peak, "cost_report": cost,
        "profile": prof_sum, "submitted": len(submitted),
        "decided": [len(o) for o in orders], "blocks": [len(b) for b in blocks],
        "delivery": [c for _, c in delivery], "routines_running": running,
        "last_consensus_round": [nd.core.get_last_consensus_round_index() for nd in nodes],
        "engine_state": states, "failed_pass_records": failed.count,
        "fast_forwards": fast_forwards, "reference_node": ref,
        "replay": {"events": len(events), "blocks": len(replay_blocks), "seconds": replay_s},
        "alone": {"batch": batch, "passes": len(alone_steps), "step_s": alone_steps,
                  "ms_per_event": [x * 1e3 / batch for x in alone_steps]},
        "checks": checks, "nvidia_smi": rec.get("nvidia_smi"), "host": rec.get("host")})
    print(f"node net: {NODE_N} nodes on {device} ({rec.get('nvidia_smi')}; host "
          f"{rec.get('host')}), built in {build_s:.2f} s, warm-up {warm_s:.1f} s, window "
          f"{w1 - w0:.1f} s: {rate:,.1f} committed consensus events/s (min over nodes); "
          f"commit latency p50 {res['commit_latency_p50_ms']} ms, p99 "
          f"{res['commit_latency_p99_ms']} ms ({lat.count} samples); passes per node "
          f"{res['passes_per_node']}, median pass wall {res['pass_wall_p50_ms']} ms "
          f"({pas.count} passes in the window, {res['window_events_per_pass']} events per "
          f"pass, {res['pass_ms_per_event']} ms per event)")
    print("node net engine phases (ms, all nodes, unsynchronised): " + json.dumps(
        {k: round(v, 1) for k, v in phases.items()}))
    print(f"node net: node 0's engine cost report {json.dumps(cost)}")
    print(f"node net launches {launches} by site {sites}; engine device_bytes "
          f"{engine_bytes}; peak device memory {peak / 2**20:.1f} MiB; card busy "
          f"{prof_sum.get('device_busy_share')} of a {prof_wall:.1f} s profiled slice")
    print(f"node net: decided {res['decided']}, blocks {res['blocks']} (delivered, "
          f"queued at shutdown, lost: {res['delivery']}), last consensus "
          f"round {res['last_consensus_round']}, engine state {states}, failed-pass records "
          f"{failed.count}, fast-forwards {fast_forwards}; node {ref} replayed into a host "
          f"Hashgraph ({len(events)} events, "
          f"{replay_s:.2f} s): {len(replay_blocks)} blocks; checks {checks}")
    print(f"node net: node {ref}'s events through one TorchHashgraph alone on {device}, "
          f"{len(alone_steps)} pipelined batches of {batch}: step wall (insert + collect + "
          f"dispatch) s " + json.dumps([round(x, 4) for x in alone_steps]) + ", ms per event "
          + json.dumps([round(x * 1e3 / batch, 4) for x in alone_steps]))
    bad = [name for name, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"node net: failed checks {bad}")
    check_engine_sites("node net", launches, sites)


# -- phase cli: the port's CLI, one node per process ------------------

def free_ports(k):
    """k distinct localhost ports, each free when probed, drawn at random
    below the kernel's ephemeral range: a port in that range can be
    handed to an outgoing connection (a peer's gossip, a client's call)
    between the probe and the node's bind, or after a node releases it
    for a restart."""
    import random
    import socket

    low = 32768
    try:
        with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
            low = int(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        pass
    rng, ports = random.Random(), []
    while len(ports) < k:
        port = rng.randrange(10000, low)
        if port in ports:
            continue
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", port))
            except OSError:
                continue
        ports.append(port)
    return ports


def cli_env():
    """The CLI processes' environment: the repository on the path, one
    intra-op thread each (four engines share the host's cores)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = env["MKL_NUM_THREADS"] = "1"
    return env


def http_get(addr, path, timeout=30.0) -> bytes:
    import urllib.request

    with urllib.request.urlopen(f"http://{addr}{path}", timeout=timeout) as r:
        return r.read()


def last_round(stats) -> int:
    lcr = stats["last_consensus_round"]
    return -1 if lcr == "nil" else int(lcr)


class RoundLogState:
    """A DummyClient's chat state keyed by round received: a block
    delivered again (a restart re-emits the blocks above the store's
    delivered anchor) must carry the same transactions."""

    def __init__(self):
        self.rounds = {}
        self.redelivered = 0
        self.conflicts = 0
        self.lock = threading.Lock()

    def commit_block(self, block) -> None:
        txs = [tx.decode(errors="replace") for tx in block.transactions or []]
        with self.lock:
            prev = self.rounds.get(block.round_received)
            if prev is not None:
                self.redelivered += 1
                self.conflicts += prev != txs
                return
            self.rounds[block.round_received] = txs

    def log(self):
        """(transactions in round order, the rounds held)."""
        with self.lock:
            rounds = sorted(self.rounds)
            txs = [tx for r in rounds for tx in self.rounds[r]]
        return txs, rounds

    def get_committed_transactions(self):
        return self.log()[0]


def cli_logs_agree(clients) -> bool:
    """The clients' committed transaction logs agree: every round two
    clients both received carries the same transactions, so their logs
    are equal up to the rounds a client never received (counted by
    cli_lost_rounds)."""
    with contextlib.ExitStack() as stack:
        for c in clients:
            stack.enter_context(c.state.lock)
        by_round = [dict(c.state.rounds) for c in clients]
    return all(a[r] == b[r] for a in by_round for b in by_round for r in a.keys() & b.keys())


def cli_lost_rounds(clients) -> list:
    """Per client, the rounds some client received a block for, below
    its own last received round, that it never received."""
    union = set().union(*(c.state.rounds.keys() for c in clients))
    out = []
    for c in clients:
        mine = c.state.rounds.keys()
        top = max(mine, default=-1)
        out.append(sorted(r for r in union if r < top and r not in mine))
    return out


def cli_delivered(lost, restart_rounds) -> bool:
    """Each node lost at most DELIVERY_ALLOWANCE blocks at each of its
    two stops (the reference's shutdown races, ROADMAP §C): the rounds
    up to its round after the restart, and those after it."""
    return all(sum(r <= top for r in x) <= DELIVERY_ALLOWANCE
               and sum(r > top for r in x) <= DELIVERY_ALLOWANCE
               for x, top in zip(lost, restart_rounds))


class CliNet:
    """CLI_N processes of `python -m babble_tpu_torch.cli run` on
    localhost (TCP gossip, --store file, socket app proxies), one
    DummyClient per node in this process."""

    def __init__(self, workdir, device):
        self.workdir, self.device = workdir, device
        ports = free_ports(4 * CLI_N)
        self.ports = [ports[4 * i:4 * i + 4] for i in range(CLI_N)]
        self.datadirs = [os.path.join(workdir, f"node{i}") for i in range(CLI_N)]
        keygens = [subprocess.Popen(
            [sys.executable, "-m", "babble_tpu_torch.cli", "keygen", "--datadir", d],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=cli_env(), cwd=ROOT)
            for d in self.datadirs]
        pubs = []
        for p in keygens:
            out, err = p.communicate(timeout=120)
            if p.returncode != 0:
                raise RuntimeError(f"cli keygen failed: {err[-2000:]}")
            pubs.append(out.split("PublicKey: ")[1].split()[0])
        peers = [{"NetAddr": f"127.0.0.1:{self.ports[i][0]}", "PubKeyHex": pubs[i]}
                 for i in range(CLI_N)]
        for d in self.datadirs:
            with open(os.path.join(d, "peers.json"), "w") as f:
                json.dump(peers, f)
        self.service = [f"127.0.0.1:{p[3]}" for p in self.ports]
        self.procs, self.stderr = [], []
        self.clients = []

    def start(self, tag):
        """Start every node; returns each one's seconds from the start
        to its service answering /Stats (boot: torch import, the CUDA
        context, the engine's prewarm and, on a restart, the store's
        bootstrap)."""
        self.procs, t0 = [], []
        for i, (node, proxy, client, service) in enumerate(self.ports):
            log = open(os.path.join(self.workdir, f"node{i}.{tag}.stderr"), "w+")
            self.stderr.append(log)
            t0.append(time.monotonic())
            self.procs.append(subprocess.Popen(
                [sys.executable, "-m", "babble_tpu_torch.cli", "run",
                 "--datadir", self.datadirs[i], "--engine", "torch",
                 "--engine_device", self.device, "--store", "file",
                 "--heartbeat", str(CLI_HEARTBEAT_MS),
                 "--consensus_interval", str(CLI_INTERVAL_MS),
                 "--node_addr", f"127.0.0.1:{node}", "--proxy_addr", f"127.0.0.1:{proxy}",
                 "--client_addr", f"127.0.0.1:{client}",
                 "--service_addr", f"127.0.0.1:{service}", "--log_level", "warning",
                 *(["--device_verify"] if i in CLI_DEVICE_VERIFY else [])],
                stdout=subprocess.DEVNULL, stderr=log, env=cli_env(), cwd=ROOT))
        if not self.clients:
            from babble_tpu_torch.dummy import DummyClient

            for _, proxy, client, _ in self.ports:
                c = DummyClient(f"127.0.0.1:{proxy}", f"127.0.0.1:{client}")
                c.state = RoundLogState()
                self.clients.append(c)
        boot = [None] * CLI_N
        deadline = time.monotonic() + CLI_BOOT_S
        while None in boot:
            for i, p in enumerate(self.procs):
                if boot[i] is not None:
                    continue
                if p.poll() is not None:
                    raise RuntimeError(f"cli node {i} exited {p.returncode} while booting: "
                                       + self.tail(i))
                try:
                    http_get(self.service[i], "/Stats", timeout=2.0)
                    boot[i] = time.monotonic() - t0[i]
                except OSError:
                    pass
            if time.monotonic() > deadline:
                raise RuntimeError(f"cli nodes not up after {CLI_BOOT_S} s: {boot}")
            time.sleep(0.1)
        return boot

    def tail(self, i):
        log = self.stderr[-CLI_N + i]
        log.flush()
        log.seek(0)
        return log.read()[-3000:]

    def stats(self):
        return [json.loads(http_get(a, "/Stats")) for a in self.service]

    def metrics(self, name):
        """Each node's `name` histogram from its /metrics, parsed with
        the port's promtext."""
        from babble_tpu_torch.telemetry import promtext

        out = []
        for a in self.service:
            samples, _ = promtext.parse(http_get(a, "/metrics").decode())
            out.append(promtext.histogram_snapshot(samples, name))
        return out

    def stop(self):
        """SIGTERM every node; (exit codes, seconds to exit), None for a
        node still running after CLI_STOP_S (then killed)."""
        import signal

        t0 = time.monotonic()
        for p in self.procs:
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        rcs, secs = [], []
        for p in self.procs:
            try:
                p.wait(timeout=max(0.1, t0 + CLI_STOP_S - time.monotonic()))
                rcs.append(p.returncode)
                secs.append(time.monotonic() - t0)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
                rcs.append(None)
                secs.append(None)
        return rcs, secs

    def count_lines(self, text) -> int:
        """Lines holding `text` in every node's stderr, both runs."""
        n = 0
        for log in self.stderr:
            log.flush()
            log.seek(0)
            n += sum(text in line for line in log)
        return n

    def print_tails(self, rcs, lines=12):
        """Print the last lines of the current run's stderr of every node
        whose exit code in `rcs` is not 0: what it said last."""
        for log, rc in zip(self.stderr[-CLI_N:], rcs):
            if rc == 0:
                continue
            log.flush()
            log.seek(0)
            for line in log.readlines()[-lines:]:
                print(f"cli net stderr tail ({os.path.basename(log.name)}, exit {rc}): "
                      f"{line.rstrip()[:300]}")

    def error_lines(self, limit=8) -> list:
        out = []
        for log in self.stderr:
            log.flush()
            log.seek(0)
            out += [f"{os.path.basename(log.name)}: {line.strip()[:300]}"
                    for line in log if "ERROR" in line or "Traceback" in line][:limit]
        return out

    def close(self):
        for c in self.clients:
            c.close()
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in self.stderr:
            log.close()


def verify_phase_share(phases) -> dict:
    """A node's verify_<backend> phase from its /debug/phases: the
    backend, its calls and its total time as a share of the sync
    phase's (verify runs inside sync)."""
    ph = phases.get("phases", {})
    name = next((k for k in ph if k.startswith("verify_")), None)
    ent = ph.get(name, {})
    sync_ns = ph.get("sync", {}).get("total_ns", 0)
    return {"backend": name[len("verify_"):] if name else None, "calls": ent.get("calls", 0),
            "total_ms": ent.get("total_ns", 0) / 1e6,
            "share_of_sync": ent.get("total_ns", 0) / sync_ns if sync_ns else None}


def profile_trace_summary(path, seconds) -> dict:
    """Kernel launches in a /debug/profile Chrome trace: all kernels,
    the strongly-see and P-256 kernels' launches and device time per
    launch, and the card's busy share (union of kernel intervals) of the
    capture."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    kern = [e for e in events if e.get("cat") == "kernel"]
    ss = [e for e in kern if "strongly_see_kernel" in e.get("name", "")]
    pv = [e for e in kern if "p256_dual_window_kernel" in e.get("name", "")]
    busy_us = union_us((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))) for e in kern)
    return {"seconds": seconds, "kernel_launches": len(kern),
            "strongly_see_launches": len(ss),
            "strongly_see_us_per_launch": (sum(float(e.get("dur", 0)) for e in ss) / len(ss)
                                           if ss else None),
            "p256_launches": len(pv),
            "p256_us_per_launch": (sum(float(e.get("dur", 0)) for e in pv) / len(pv)
                                   if pv else None),
            "device_busy_share": busy_us * 1e-6 / seconds if kern else "not measured",
            "trace_bytes": os.path.getsize(path)}


def phase_cli(rec, device="cuda"):
    """The port's CLI on the card: CLI_N processes of `python -m
    babble_tpu_torch.cli run --engine torch` (TCP gossip on localhost,
    --store file, heartbeat CLI_HEARTBEAT_MS, consensus interval
    CLI_INTERVAL_MS, the rest of Config's defaults: failover off) with
    one DummyClient each in this process, a transaction every
    CLI_TX_EVERY_S round robin. Warm-up until every node's /Stats says
    round >= CLI_WARM_ROUND (cap CLI_WARM_S), one CLI_WINDOW_S window
    (a CLI_PROFILE_S /debug/profile capture of node 0 in its middle),
    SIGTERM to all (each must exit 0 within CLI_STOP_S), a restart of
    all on their database files (bootstrap), and on until CLI_MORE_TXS
    more transactions commit. Gates: the clients' logs agree before the
    stop and, after the restart, before the final stop (cli_logs_agree);
    each client lacks at most DELIVERY_ALLOWANCE rounds at each of its
    node's two stops (the reference's shutdown races, ROADMAP §C), and a
    block delivered again carries the same transactions; every node
    on the device engine with no failover; no failed pass in any
    process's stderr; after the restart every node's round is at least
    its round before the stop; the capture holds strongly-see launches
    and, node 0 running --device_verify (CLI_DEVICE_VERIFY), P-256
    launches; /debug/phases shows each node's syncs verified on the
    backend it asked for."""
    import tempfile

    from babble_tpu_torch.proxy.jsonrpc import JSONRPCError

    t_phase = time.monotonic()
    workdir = tempfile.mkdtemp(prefix="babble-cli-")
    net = CliNet(workdir, device)
    res = rec["cli"] = {"n": CLI_N, "heartbeat_ms": CLI_HEARTBEAT_MS,
                        "consensus_interval_ms": CLI_INTERVAL_MS, "tx_every_s": CLI_TX_EVERY_S,
                        "workdir": workdir}
    submitted = []
    stop = threading.Event()

    def bombard():
        i = 0
        while not stop.is_set():
            tx = b"cli tx %d" % i
            try:
                net.clients[i % CLI_N].submit_tx(tx)
                submitted.append(tx)
            except (OSError, JSONRPCError):
                pass  # a node restarting
            i += 1
            time.sleep(CLI_TX_EVERY_S)

    def committed_txs():
        return min(len(c.state.log()[0]) for c in net.clients)

    bomber = threading.Thread(target=bombard, daemon=True, name="cli-phase-bombard")
    try:
        res["boot_s"] = net.start("run1")
        bomber.start()
        t0 = time.monotonic()
        while time.monotonic() - t0 < CLI_WARM_S and min(
                last_round(s) for s in net.stats()) < CLI_WARM_ROUND:
            time.sleep(0.25)
        res["warm_s"] = time.monotonic() - t0

        s0, w0 = net.stats(), time.monotonic()
        lat0 = net.metrics("babble_commit_latency_seconds")
        pass0 = net.metrics("babble_engine_pass_seconds")
        time.sleep((CLI_WINDOW_S - CLI_PROFILE_S) / 2)
        # The capture answers after it has written its trace, which can
        # outlast the window: ask for it on a thread of its own.
        prof = {}
        profiler = threading.Thread(target=lambda: prof.update(json.loads(http_get(
            net.service[0], f"/debug/profile?seconds={CLI_PROFILE_S}", timeout=300))),
            daemon=True, name="cli-phase-profile")
        profiler.start()
        time.sleep(max(0.0, w0 + CLI_WINDOW_S - time.monotonic()))
        s1, w1 = net.stats(), time.monotonic()
        lat1 = net.metrics("babble_commit_latency_seconds")
        pass1 = net.metrics("babble_engine_pass_seconds")
        capacity = [json.loads(http_get(a, "/debug/capacity")).get("engine", {})
                    for a in net.service]
        verify_share = [verify_phase_share(json.loads(http_get(a, "/debug/phases")))
                        for a in net.service]
        profiler.join(timeout=300)
        res["profile"] = profile_trace_summary(os.path.join(prof["trace_dir"], "trace.json"),
                                               prof["seconds"])

        rates = [(int(b["consensus_events"]) - int(a["consensus_events"])) / (w1 - w0)
                 for a, b in zip(s0, s1)]
        lat = None
        for a, b in zip(lat0, lat1):
            lat = (b - a) if lat is None else lat.merge(b - a)
        passes = [b - a for a, b in zip(pass0, pass1)]
        states_run1 = [(s["engine_state"], s["engine_failovers"]) for s in s1]
        logs_before = cli_logs_agree(net.clients)

        before = [last_round(s) for s in net.stats()]
        txs_before = committed_txs()
        stop_rcs, stop_s = net.stop()
        net.print_tails(stop_rcs)

        res["restart_boot_s"] = net.start("run2")
        after_boot = [last_round(s) for s in net.stats()]
        t_more = time.monotonic()
        while (time.monotonic() - t_more < CLI_MORE_S
               and committed_txs() < txs_before + CLI_MORE_TXS):
            time.sleep(0.25)
        more_s = time.monotonic() - t_more
        s2 = net.stats()
        stop.set()
        bomber.join(timeout=10)
        logs_after = cli_logs_agree(net.clients)
        final_rcs, final_s = net.stop()
        net.print_tails(final_rcs)
        failed = net.count_lines(FAILED_PASS)
        commit_failed = net.count_lines("commit failed")
        divergence = net.count_lines("CONSENSUS DIVERGENCE")
        errors = net.error_lines()
        lost = cli_lost_rounds(net.clients)
        checks = {
            "round_5": all(last_round(s) >= CLI_WARM_ROUND for s in s1),
            "device_engine": all(st == ("device", "0") for st in states_run1)
                             and all((s["engine_state"], s["engine_failovers"]) == ("device", "0")
                                     for s in s2),
            "no_failed_pass": failed == 0,
            "stopped_0": stop_rcs == [0] * CLI_N,
            "logs_before": logs_before,
            "rounds_after_restart": all(a >= b for a, b in zip(after_boot, before)),
            "more_txs": committed_txs() >= txs_before + CLI_MORE_TXS,
            "logs_after": logs_after,
            "redelivered_same": all(c.state.conflicts == 0 for c in net.clients),
            "delivered": cli_delivered(lost, after_boot),
            "profile_strongly_see": res["profile"]["strongly_see_launches"] > 0,
            "profile_p256": res["profile"]["p256_launches"] > 0,
            "verify_on_device": all((v["backend"] == "device-p256") == (i in CLI_DEVICE_VERIFY)
                                    and v["calls"] > 0 for i, v in enumerate(verify_share)),
            "final_stop_0": final_rcs == [0] * CLI_N,
        }
    except BaseException:
        # Show what the node processes said before the phase fails.
        for i, p in enumerate(net.procs):
            print(f"cli net: node {i} exit code {p.poll()}; its stderr ends:\n"
                  + net.tail(i), flush=True)
        raise
    finally:
        stop.set()
        net.close()
    res.update({
        "window_s": w1 - w0, "committed_events_per_s": min(rates),
        "committed_events_per_s_by_node": rates,
        "commit_latency_p50_ms": lat.quantile(0.5) * 1e3 if lat.count else None,
        "commit_latency_p99_ms": lat.quantile(0.99) * 1e3 if lat.count else None,
        "commit_latency_samples": lat.count,
        "pass_wall_p50_ms_by_node": [p.quantile(0.5) * 1e3 if p.count else None for p in passes],
        "window_passes_by_node": [p.count for p in passes],
        # Committed events per pass, and the median pass wall per event.
        "events_per_pass_by_node": [r * (w1 - w0) / p.count if p.count else None
                                    for r, p in zip(rates, passes)],
        "pass_ms_per_event_by_node": [p.quantile(0.5) * 1e3 * p.count / (r * (w1 - w0))
                                      if p.count and r else None
                                      for r, p in zip(rates, passes)],
        "peak_device_bytes_by_node": [c.get("hbm_peak_bytes") for c in capacity],
        "verify_share_by_node": verify_share,
        "engine_device_bytes_by_node": [c.get("device_bytes") for c in capacity],
        "last_consensus_round": {"window_end": [last_round(s) for s in s1],
                                 "before_stop": before, "after_restart": after_boot,
                                 "end": [last_round(s) for s in s2]},
        "stop_s": stop_s, "stop_rcs": stop_rcs, "final_stop_s": final_s,
        "final_stop_rcs": final_rcs, "failed_pass_lines": failed,
        "commit_failed_lines": commit_failed, "divergence_lines": divergence,
        "error_lines": errors,
        "committed_txs": {"before_stop": txs_before, "end": committed_txs()},
        "more_txs_s": more_s, "submitted": len(submitted),
        "redelivered_rounds": [c.state.redelivered for c in net.clients],
        "lost_rounds": lost, "checks": checks,
        "phase_s": time.monotonic() - t_phase,
        "nvidia_smi": rec.get("nvidia_smi"), "host": rec.get("host")})
    print(f"cli net: {CLI_N} processes of babble_tpu_torch.cli run on {device} "
          f"({rec.get('nvidia_smi')}; host {rec.get('host')}): boot s {res['boot_s']}, "
          f"restart boot s {res['restart_boot_s']}, warm-up {res['warm_s']:.1f} s, window "
          f"{res['window_s']:.1f} s: {res['committed_events_per_s']:,.1f} committed consensus "
          f"events/s (min over nodes; by node {[round(r, 1) for r in rates]}); commit latency "
          f"p50 {res['commit_latency_p50_ms']} ms, p99 {res['commit_latency_p99_ms']} ms "
          f"({lat.count} samples)")
    print(f"cli net: median pass wall by process {res['pass_wall_p50_ms_by_node']} ms "
          f"({res['window_passes_by_node']} passes in the window, "
          f"{[round(x, 1) if x else x for x in res['events_per_pass_by_node']]} events "
          f"per pass, {[round(x, 4) if x else x for x in res['pass_ms_per_event_by_node']]}"
          f" ms per event; phase node (b), one "
          f"process: 4.25-20 s; one TorchHashgraph alone: 0.08-0.48 s); peak device memory "
          f"by process {res['peak_device_bytes_by_node']} bytes; profile of node 0: "
          f"{res['profile']}")
    print(f"cli net: verify phase by node (backend, calls, share of the sync phase) "
          + json.dumps(verify_share))
    print(f"cli net: rounds {res['last_consensus_round']}, stop exit codes {stop_rcs} in "
          f"{stop_s} s, final {final_rcs} in {final_s} s, failed-pass lines "
          f"{failed}, commit-failed lines {commit_failed}, divergence-sentinel lines "
          f"{divergence}, committed txs "
          f"{res['committed_txs']}, redelivered "
          f"rounds {res['redelivered_rounds']}, lost rounds {lost}; phase "
          f"{res['phase_s']:.1f} s; checks {checks}")
    for line in errors:
        print(f"cli net stderr: {line}")
    bad = [name for name, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"cli net: failed checks {bad}")


def sync_warnings(fn) -> int:
    """Run fn() under torch.cuda.set_sync_debug_mode("warn") and count
    the synchronizing torch operations it flags, on every thread."""
    import warnings

    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sum("synchronizing CUDA operation" in str(w.message) for w in caught)


def phase_sustained_profile(rec, device="cuda"):
    """The sustained engine fed batch by batch with run(): passes 3-6
    with synchronised phase timers (each phase's share including its
    device work); pass 7 under the sync debug mode, which must flag
    exactly the engine's own host reads but the pulls (one flag read
    per frontier round, one stop check per fame step past the first);
    pass PROFILED_BATCH, a steady pass, under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from babble_tpu_torch.ops.dag import synthetic_dag
    from babble_tpu_torch.ops.incremental import IncrementalEngine

    n, e_sus, seed = SUSTAINED
    dag, _ = synthetic_dag(n, e_sus, seed=seed)
    eng = IncrementalEngine(n, device=device, **SUSTAINED_ENGINE)
    timed = range(3, PROFILED_BATCH - 1)
    phase_tot = {}
    flagged = expected = None
    timers = os.environ.pop("BABBLE_ENGINE_TIMERS", None)  # untimed unless set here
    try:
        for b_i, batch in enumerate(engine_batches(dag, e_sus)):
            eng.append_batch(*batch)
            if b_i in timed:
                os.environ["BABBLE_ENGINE_TIMERS"] = "1"
                try:
                    eng.run()
                finally:
                    os.environ.pop("BABBLE_ENGINE_TIMERS")
                for ph, ns in eng.phase_ns.items():
                    phase_tot[ph] = phase_tot.get(ph, 0) + ns
            elif b_i == PROFILED_BATCH - 1:
                redo0 = eng.redo_count
                flagged = sync_warnings(eng.run)
                expected = eng.host_syncs - (1 + eng.redo_count - redo0)
            elif b_i < PROFILED_BATCH:
                eng.run()
            else:
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    eng.run()
                    torch.cuda.synchronize()
                    wall_s = time.perf_counter() - t0
                break
    finally:
        eng.close()
        if timers is not None:
            os.environ["BABBLE_ENGINE_TIMERS"] = timers
    parts = ("coords", "fd_fold", "frontier", "rounds", "fame_rr", "stage", "c_pull",
             "consensus", "apply")
    denom = sum(phase_tot.get(k, 0) for k in parts) or 1
    p = {"batch": PROFILED_BATCH, "host_syncs": eng.host_syncs,
         "windows": dict(eng._dbg_windows),
         "synced_passes": [timed.start, timed.stop - 1],
         "synced_phase_ms": {k: v / 1e6 for k, v in phase_tot.items()},
         "synced_phase_share": {k: phase_tot.get(k, 0) / denom for k in parts},
         "sync_debug_flagged": flagged, "engine_reads": expected,
         "profiled_pass_phase_ms": {k: v / 1e6 for k, v in eng.phase_ns.items()},
         **profile_summary(prof, wall_s)}
    rec["sustained_profile"] = p
    print(f"sustained synced phase shares (passes {timed.start}-{timed.stop - 1}): "
          + json.dumps({k: round(v, 4) for k, v in p["synced_phase_share"].items()}))
    print(f"sustained pass {PROFILED_BATCH - 1} under the sync debug mode: {flagged} "
          f"synchronizing operations flagged, {expected} engine reads (frontier flags "
          f"and fame stop checks)")
    if flagged != expected:
        raise AssertionError(f"sync debug mode flagged {flagged} host reads, the engine "
                             f"counts {expected} frontier flag and fame stop reads")
    if "device_busy_s" not in p:
        print("sustained profile: the profiler recorded no device activity: not measured")
        return
    print(f"sustained profile (run() of batch {PROFILED_BATCH}, {wall_s * 1e3:.1f} ms, "
          f"{eng.host_syncs} host reads, windows {p['windows']}): "
          f"{p['kernel_launches']} kernels, device busy {p['device_busy_s'] * 1e3:.2f} ms "
          f"= {p['device_busy_share']:.1%} of wall; strongly_see {p['strongly_see']}; "
          f"host waits {p['sync_calls']}")
    for row in p["top_kernels_us"]:
        print(f"  {row['us'] / 1e3:9.3f} ms  x{row['count']:6d}  {row['name']}")


def phase_northstar_incremental(rec, device="cuda"):
    """bench.py's north-star incremental stage on the port: run() per
    batch of 4,096 over synthetic_dag(1024, 100_000, seed=2)."""
    import torch

    from babble_tpu_torch.ops.dag import synthetic_dag
    from babble_tpu_torch.ops.incremental import IncrementalEngine
    from babble_tpu_torch.ops.pipeline import run_pipeline

    n, e, seed = NORTHSTAR
    dag, _ = synthetic_dag(n, e, seed=seed)
    one_shot = rec.get("_northstar_out") or host(run_pipeline(dag, device=device))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    eng = IncrementalEngine(n, device=device, **NORTHSTAR_ENGINE)
    per_b, syncs = [], []
    phase_tot = {}
    reset_launches()
    with launches_by_site() as sites:
        t0 = time.perf_counter()
        for batch in engine_batches(dag, e):
            eng.append_batch(*batch)
            tb = time.perf_counter()
            eng.run()
            per_b.append(time.perf_counter() - tb)
            syncs.append(eng.host_syncs)
            for ph, ns in eng.phase_ns.items():
                phase_tot[ph] = phase_tot.get(ph, 0) + ns
        total = time.perf_counter() - t0
    launches = read_launches()
    eng.close()
    half = per_b[len(per_b) // 2:]
    steady = statistics.median(half)
    decided = int((eng.rr[:e] >= 0).sum())
    res = {
        "n": n, "e": e, "seed": seed, "batch": ENGINE_BATCH, "engine": NORTHSTAR_ENGINE,
        "total_s": total, "events_per_s": e / total, "steady_batch_s": steady,
        "steady_events_per_s": ENGINE_BATCH / steady, "per_batch_s": per_b,
        "decided": decided, "redo_count": eng.redo_count, "host_syncs_per_pass": syncs,
        "phase_ms": {k: v / 1e6 for k, v in phase_tot.items()},
        "launches": launches, "launches_by_site": sites,
        "peak_mem_bytes": torch.cuda.max_memory_allocated(),
        "memory_stats": eng.device_memory_stats()}
    rec["northstar_incremental"] = res
    print(f"northstar incremental: n={n} e={e} batch={ENGINE_BATCH}: {total:.2f} s "
          f"({e / total:,.0f} events/s), steady {ENGINE_BATCH / steady:,.0f} events/s, "
          f"{decided} decided, redo_count {eng.redo_count}, host reads per pass {syncs}, "
          f"peak {res['peak_mem_bytes'] / 2**30:.2f} GiB, launches {launches} by site {sites}")
    print("northstar incremental phases (ms): " + json.dumps(
        {k: round(v, 1) for k, v in res["phase_ms"].items()}))
    check_engine_sites("northstar_incremental", launches, sites)
    if decided != NORTHSTAR_DECIDED:
        raise AssertionError(f"northstar incremental: {decided} != {NORTHSTAR_DECIDED}")
    bad = engine_vs_one_shot(eng, one_shot, e)
    res["equal_to_one_shot"] = not bad
    print(f"northstar incremental state == one-shot run_pipeline on the card: {not bad}")
    if bad:
        raise AssertionError(f"northstar incremental differs from the one-shot run in {bad}")


def sharded_fame_chunks(dag, d, r_small) -> int:
    """The sharded fame's MATRIX launches a rank: one per chunk of
    voting rounds (ops/sharded.py fame), none without a voting round."""
    from babble_tpu_torch.ops.kernels import chunk_width

    if r_small < 2:
        return 0
    n_loc = dag.n // d
    return -(-(r_small - 1) // chunk_width(r_small - 1, n_loc * dag.n))


def check_sharded_sites(name, dag, records, r_small) -> None:
    """Every rank launched B1 TALLY once per DAG level at the rounds
    site, and MATRIX once per chunk of voting rounds at the fame site,
    and nothing else."""
    levels = dag.levels.shape[0]
    fame = sharded_fame_chunks(dag, records[0]["size"], r_small)
    want_sites = {"rounds": {"calls": levels, "launches": levels}}
    if fame:
        want_sites["fame"] = {"calls": fame, "launches": fame}
    want = {"matrix": fame, "tally": levels}
    for r in records:
        if r["sites"] != want_sites or r["launches"] != want:
            raise AssertionError(
                f"sharded {name} rank {r['rank']}: launches {r['launches']} by site "
                f"{r['sites']}, expected {want} by site {want_sites}")


def sharded_run_record(name, dag, records, backend, spawn_s) -> dict:
    """One sharded run's line: the slowest rank's synchronised seconds,
    the ranks and backend, the collectives a rank made, and by rank the
    host seconds in them, the bytes through host memory, peak device
    memory and launches by site."""
    out = records[0]["outputs"]
    return {"name": name, "n": dag.n, "e": dag.e, "levels": list(dag.levels.shape),
            "ranks": len(records), "backend": backend, "spawn_s": spawn_s,
            "seconds": max(r["seconds"] for r in records),
            "seconds_by_rank": [r["seconds"] for r in records],
            "host_bytes_by_rank": [r["host_bytes"] for r in records],
            "collectives": records[0]["collectives"],
            "collective_s_by_rank": [r["collective_s"] for r in records],
            "peak_mem_bytes_by_rank": [r["peak_mem_bytes"] for r in records],
            "sites_by_rank": [r["sites"] for r in records],
            "decided": int((out[4] >= 0).sum()), "max_round": int(out[0].max()),
            "output_digest": digest(out)}


def print_sharded_run(res) -> None:
    print(f"sharded {res['name']}: n={res['n']} e={res['e']} levels={res['levels']} "
          f"{res['ranks']} ranks ({res['backend']}) {res['seconds']:.2f} s "
          f"(by rank {[round(t, 2) for t in res['seconds_by_rank']]}), decided "
          f"{res['decided']}, max round {res['max_round']}; {res['collectives']} collectives, "
          f"{[round(t, 2) for t in res['collective_s_by_rank']]} s in them by rank; "
          f"through host memory "
          f"{[round(b / 2**20, 1) for b in res['host_bytes_by_rank']]} MiB, peak "
          f"{[b and round(b / 2**30, 2) for b in res['peak_mem_bytes_by_rank']]} GiB by rank; "
          f"launches by site {res['sites_by_rank'][0]} in every rank")


def phase_sharded(rec, device="cuda"):
    """The memory-sharded pipeline (ops/sharded.py) as rank processes on
    the card: SHARDED_RANKS gloo ranks (one spawn) run BASELINE config 5
    (SHARDED_C5) and then the headline; one NCCL rank the north star;
    then entry.dryrun_multichip(DRYRUN_RANKS) (gloo: 8 ranks, one GPU).
    Each equals the port's single-device run_pipeline on the card,
    config 5 also the JAX package's digest (GOLDEN_SHARDED_C5) and the
    headline GOLDEN_OUTPUT; config 5's ranks hold their shards of the
    single-device coordinates and first descendants (every event is in
    round 0 there, so its six outputs would hide a wrong table); every
    rank of every run launched B1 as check_sharded_sites says."""
    import torch

    from babble_tpu_torch.entry import dryrun_multichip
    from babble_tpu_torch.ops import kernels
    from babble_tpu_torch.ops.dag import synthetic_dag
    from babble_tpu_torch.ops.pipeline import run_pipeline
    from babble_tpu_torch.ops.sharded import (dag_arrays, oracle_equal, run_sharded,
                                              single_device_table_digests)
    from babble_tpu_torch.parallel import spawn_ranks

    torch.cuda.empty_cache()  # the ranks share the card with this process
    c5, c5_s = synthetic_dag(*SHARDED_C5[:2], seed=SHARDED_C5[2])
    if dag_digest(c5, c5_s) != GOLDEN_SHARDED_C5_INPUT:
        raise AssertionError("config 5 input digest differs from the JAX package's")
    head, _ = synthetic_dag(*HEADLINE[:2], seed=HEADLINE[2])
    ns, _ = synthetic_dag(*NORTHSTAR[:2], seed=NORTHSTAR[2])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    c5_ref = host(run_pipeline(c5, device=device))
    torch.cuda.synchronize()
    c5_single_s = time.perf_counter() - t0
    t = {f: torch.from_numpy(np.ascontiguousarray(getattr(c5, f))).to(device)
         for f in ("self_parent", "other_parent", "creator", "index", "levels", "chain",
                   "chain_len")}
    la = kernels.compute_last_ancestors(t["self_parent"], t["other_parent"], t["creator"],
                                        t["index"], t["levels"], n=c5.n)
    fd = kernels.compute_first_descendants(la, t["creator"], t["index"], t["chain"],
                                           t["chain_len"], n=c5.n)
    c5_tables = single_device_table_digests(la, fd, t["chain"], SHARDED_RANKS)
    del t, la, fd
    torch.cuda.empty_cache()
    ns_ref = rec.get("_northstar_out") or host(run_pipeline(ns, device=device))
    res = {"single_device_c5_s": c5_single_s, "runs": {}}
    checks = []
    for backend, ranks, dags in (("gloo", SHARDED_RANKS, (("config5", c5), ("headline", head))),
                                 ("nccl", 1, (("northstar", ns),))):
        t0 = time.perf_counter()
        runs = [{"dag": dag_arrays(dag), "tables": name == "config5"} for name, dag in dags]
        out = spawn_ranks(ranks, run_sharded, runs, device, backend=backend, device=device,
                          timeout_s=SHARDED_TIMEOUT_S)
        spawn_s = time.perf_counter() - t0
        for i, (name, dag) in enumerate(dags):
            records = [r[i] for r in out]
            run = sharded_run_record(name, dag, records, backend, spawn_s)
            res["runs"][name] = run
            print_sharded_run(run)
            checks.append((name, dag, records, run))
    rec["sharded"] = res  # recorded before the gates, so a failure shows it
    for name, dag, records, run in checks:
        got = records[0]["outputs"]
        want = {"config5": c5_ref, "headline": None, "northstar": ns_ref}[name]
        if want is not None and oracle_equal(got, want) is not None:
            raise AssertionError(f"sharded {name}: {oracle_equal(got, want)} differs from "
                                 "the single-device run on the card")
        golden = {"config5": GOLDEN_SHARDED_C5, "headline": GOLDEN_OUTPUT}.get(name)
        if golden is not None and run["output_digest"] != golden:
            raise AssertionError(f"sharded {name}: digest {run['output_digest']} != JAX golden")
        decided = {"config5": SHARDED_C5_DECIDED, "headline": HEADLINE_DECIDED,
                   "northstar": NORTHSTAR_DECIDED}[name]
        if run["decided"] != decided:
            raise AssertionError(f"sharded {name}: {run['decided']} decided != {decided}")
        check_sharded_sites(name, dag, records, _r_small(dag, got[0]))
    c5_records = next(records for name, _, records, _ in checks if name == "config5")
    bad = [r["rank"] for r in c5_records if r["tables"] != c5_tables[r["index"]]]
    if bad:
        raise AssertionError(f"sharded config5: ranks {bad} hold coordinates or first "
                             "descendants that differ from their shards of the single-device "
                             "tables")
    print("sharded: config 5 == single device and JAX golden, and every rank's coordinate "
          "and first-descendant shards == the single-device tables'; headline == "
          "GOLDEN_OUTPUT; north star == single device")
    dry = dryrun_multichip(DRYRUN_RANKS, device=device, timeout_s=SHARDED_TIMEOUT_S)
    res["dryrun"] = dry
    dag2, _ = synthetic_dag(dry["n"], dry["e"], seed=1)
    run = dry["run"]
    records = [{"rank": i, "size": DRYRUN_RANKS, "sites": s, "launches": m}
               for i, (s, m) in enumerate(zip(run["sites"], run["launches"]))]
    check_sharded_sites("dryrun", dag2, records, _r_small(dag2, np.array([dry["max_round"]])))
    print(f"sharded dryrun_multichip({DRYRUN_RANKS}) ({dry['backend']}): spawn "
          f"{dry['spawn_s']:.2f} s, run {run['seconds']:.2f} s, {run['collectives']} "
          f"collectives a rank, rank 0's seconds in them {run['collective_s'][0]:.2f}")


def close_and_join(eng) -> None:
    """Close an engine and wait for its staging worker to exit, so that
    nothing holds its device tables once the caller drops it."""
    worker = eng._stage_thread
    eng.close()
    if worker is not None:
        worker.join(timeout=60.0)


def mesh_engine_run(dag, e, shards, device, count_calls=False) -> dict:
    """The north-star DAG through one engine (NORTHSTAR_ENGINE), run()
    per batch, in `shards` shards placed as Core places an engine_mesh
    (the cards round robin; 1: the unsharded engine): its RunDeltas, the seconds, host reads, redos and B1
    launches by site of every pass, peak device memory, the bytes of
    each shard of the sharded carries, and the final host mirrors; the
    engine's device tables are freed before it returns, so the next
    run's peak is its own. With count_calls, only each pass's torch
    calls on the staging worker (TorchFunctionMode costs every call, so
    those runs are not timed)."""
    import dataclasses

    import torch
    from torch.overrides import TorchFunctionMode

    from babble_tpu_torch.ops.incremental import IncrementalEngine
    from babble_tpu_torch.ops.mesh import engine_mesh_devices

    class Calls(TorchFunctionMode):
        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_function__(self, func, types, args=(), kwargs=None):
            if getattr(func, "__name__", "") != "__get__":  # not an attribute read
                self.n += 1
            return func(*args, **(kwargs or {}))

    n = dag.n
    gc.collect()  # an earlier run's engine, if its worker still held it
    mesh = engine_mesh_devices(shards, n, device)  # the cards round robin
    cards = list(dict.fromkeys(mesh or [torch.device(device)]))
    base = []
    for card in cards:
        torch.cuda.synchronize(card)
        torch.cuda.reset_peak_memory_stats(card)
        base.append(torch.cuda.memory_allocated(card))
    eng = IncrementalEngine(n, mesh=mesh, device=None if mesh else device,
                            **NORTHSTAR_ENGINE)
    calls = []
    if count_calls:
        stage = eng._stage_pass

        def counted(pp):  # the mode is per thread: count on the staging worker
            with Calls() as c:
                stage(pp)
            calls.append(c.n)

        eng._stage_pass = counted
        for batch in engine_batches(dag, e):
            eng.append_batch(*batch)
            eng.run()
        close_and_join(eng)
        return {"torch_calls_per_pass": calls}
    deltas, per_b, syncs, redos, site_passes = [], [], [], [], []
    reset_launches()
    with launches_by_site() as sites:
        t0 = time.perf_counter()
        for batch in engine_batches(dag, e):
            eng.append_batch(*batch)
            before, r0 = dict(sites), eng.redo_count
            tb = time.perf_counter()
            deltas.append(dataclasses.asdict(eng.run()))
            per_b.append(time.perf_counter() - tb)
            syncs.append(eng.host_syncs)
            redos.append(eng.redo_count - r0)
            site_passes.append({k: v - before.get(k, 0) for k, v in sites.items()})
        total = time.perf_counter() - t0
    close_and_join(eng)
    peak = [torch.cuda.max_memory_allocated(card) for card in cards]
    shard_bytes = {name: [t.numel() * t.element_size() for t in eng.shards(name)]
                   for name in ("_la", "_chain_la", "_ranks")}
    state = {name: getattr(eng, name) for name in
             ("rounds", "witness", "rr", "cts_ns", "famous", "undecided_rounds")}
    decided = int((eng.rr[:e] >= 0).sum())
    del eng
    return {"shards": shards, "devices": [str(d) for d in mesh or [device]],
            "total_s": total, "per_batch_s": per_b,
            "host_syncs_per_pass": syncs, "redos_per_pass": redos,
            "launches": read_launches(), "launches_by_site": dict(sites),
            "launches_by_site_per_pass": site_passes,
            "peak_mem_bytes": sum(peak), "base_mem_bytes": sum(base),
            "peak_mem_bytes_by_card": peak, "shard_bytes": shard_bytes,
            "decided": decided, "_deltas": deltas, "_state": state}


def phase_mesh(rec, device="cuda"):
    """The mesh-resident incremental engine (IncrementalEngine(mesh=...),
    ops/mesh.py) on the card, its shards sharing it: (a)
    entry.dryrun_multichip(DRYRUN_RANKS)'s part (c), an 8-shard engine
    equal to the single-device one (from phase sharded's call when it
    ran, else a call of its own); (b) the north-star DAG through
    IncrementalEngine(1024, mesh=...) with MESH_SHARDS shards on the
    cards round robin (Core's engine_mesh placement: all on one card
    where there is one) and through the
    single-device engine, run() per batch of 4,096: every RunDelta equal
    word for word, the final mirrors too, 44,770 decided, each shard of
    _la, _chain_la and _ranks 1/MESH_SHARDS of the single engine's
    table, the frontier probe launched MESH_SHARDS times as often (once
    a chain shard) and the skip correction and fame as often; seconds,
    host reads, redos, launches by site and torch calls per pass, peak
    memory of both; (c) node_core_script with engine_mesh=MESH_SHARDS:
    the same blocks, byte for byte, as the single-device torch Core and
    the host Core fed its events."""
    import torch

    from babble_tpu_torch.entry import dryrun_multichip
    from babble_tpu_torch.ops.dag import synthetic_dag

    res = rec["mesh"] = {}
    dry = (rec.get("sharded") or {}).get("dryrun")
    if dry is None:
        dry = dryrun_multichip(DRYRUN_RANKS, device=device, timeout_s=SHARDED_TIMEOUT_S)
        dry["called_by"] = "mesh"
    part_c = dry["engine_mesh"]
    res["dryrun_engine_mesh"] = part_c
    print(f"mesh (a): dryrun_multichip({DRYRUN_RANKS}) part (c): {part_c['shards']} shards "
          f"== single-device engine, n = {part_c['n']}, {part_c['decided']} decided, "
          f"la shard elements {part_c['la_shard_elems']}, seconds {part_c['seconds']}")
    if part_c["shards"] != DRYRUN_RANKS:
        raise AssertionError(f"mesh (a): part (c) ran {part_c['shards']} shards")

    n, e, seed = NORTHSTAR
    dag, _ = synthetic_dag(n, e, seed=seed)
    runs = {}
    for shards in (1, MESH_SHARDS):
        torch.cuda.empty_cache()
        run = mesh_engine_run(dag, e, shards, device)
        run.update(mesh_engine_run(dag, e, shards, device, count_calls=True))
        runs[shards] = run
    single, mesh = runs[1], runs[MESH_SHARDS]
    res["northstar"] = {str(k): {kk: v for kk, v in r.items() if not kk.startswith("_")}
                        for k, r in runs.items()}
    for shards, r in runs.items():
        print(f"mesh (b): north star, {shards} shard(s) on {r['devices']}: "
              f"{r['total_s']:.2f} s, "
              f"{r['decided']} decided, peak {r['peak_mem_bytes'] / 2**30:.2f} GiB (from "
              f"{r['base_mem_bytes'] / 2**30:.2f} GiB before), shard "
              f"bytes {r['shard_bytes']}, launches {r['launches']} by site "
              f"{r['launches_by_site']}, host reads per pass {r['host_syncs_per_pass']}, "
              f"redos {sum(r['redos_per_pass'])}, torch calls per pass "
              f"{r['torch_calls_per_pass']}")
    bad = [k for k, (a, b) in enumerate(zip(mesh["_deltas"], single["_deltas"])) if a != b]
    if bad or len(mesh["_deltas"]) != len(single["_deltas"]):
        raise AssertionError(f"mesh (b): RunDeltas of passes {bad} differ from the "
                             "single-device engine's")
    a, b = mesh["_state"], single["_state"]
    bad = [name for name in ("rounds", "witness", "rr", "cts_ns", "famous")
           if not np.array_equal(a[name], b[name])]
    if a["undecided_rounds"] != b["undecided_rounds"]:
        bad.append("undecided_rounds")
    if bad:
        raise AssertionError(f"mesh (b): final {bad} differ from the single-device engine's")
    if mesh["decided"] != NORTHSTAR_DECIDED:
        raise AssertionError(f"mesh (b): {mesh['decided']} decided != {NORTHSTAR_DECIDED}")
    for name, sizes in mesh["shard_bytes"].items():
        whole = single["shard_bytes"][name][0]
        if len(sizes) != MESH_SHARDS or any(MESH_SHARDS * sz != whole for sz in sizes):
            raise AssertionError(f"mesh (b): {name} shards {sizes} are not 1/{MESH_SHARDS} "
                                 f"of {whole}")
    for name, r in (("mesh single", single), ("mesh sharded", mesh)):
        check_engine_sites(name, r["launches"], r["launches_by_site"])
    for k, (sp, ss) in enumerate(zip(mesh["launches_by_site_per_pass"],
                                     single["launches_by_site_per_pass"])):
        want = dict(ss, frontier_probe=MESH_SHARDS * ss.get("frontier_probe", 0))
        if {s: v for s, v in sp.items() if v} != {s: v for s, v in want.items() if v}:
            raise AssertionError(f"mesh (b): pass {k} launched {sp}, expected {want}")
    print(f"mesh (b): every RunDelta of {len(single['_deltas'])} passes equal, "
          f"{mesh['decided']} decided, probe launches {MESH_SHARDS}x the single engine's")

    res["core_script"] = node_core_script(device, engine_mesh=MESH_SHARDS)
    print(f"mesh (c): the {MESH_SHARDS}-shard torch Core commits the single-device Core's "
          f"{res['core_script']['blocks']} blocks byte for byte")


def kernels_line(rec) -> dict:
    """One entry per entry point of the strongly-see kernel, timed at
    the shape the main path launches most (for the gathered entry the
    live node's frontier probe, TALLY at n = 4; the counts entry, on no
    path, at 64^3); `by_shape` holds every shape.
    `launches` are those of the main path's run, the live 4-node net of
    phase node (b); `launches_by_path` gives every path's. The CLI
    path's kernel runs in its node processes, where this process's
    counts cannot see it: its launches are those a torch.profiler
    capture of one node process recorded (phase cli). The P-256 ladder's
    entry is timed at B = 64 (a large sync batch) and counts its
    launches on phase node (a), the device-verify Core's script; its
    yardstick is the host backend it replaces (`host_ms`): no PyTorch
    call computes an EC scalar multiplication."""
    main_path = rec.get("main_path_launches", {})
    engine_path = rec.get("node") or {}
    by_mode = engine_path.get("launches", {})
    by_path = {"one_shot_headline": {"by_mode": main_path.get("by_mode"),
                                     "by_site": main_path.get("by_site")}}
    for name in ("sustained", "northstar_incremental", "hashgraph", "node_core_script",
                 "node"):
        r = rec.get(name) or {}
        by_path[name] = {"by_mode": r.get("launches"), "by_site": r.get("launches_by_site")}
    for name, cfg in (rec.get("sim") or {}).items():
        for entry, run in (cfg.get("runs") or {}).items():
            by_path[f"sim_{name}_{entry}"] = {"by_mode": run["launches"],
                                              "by_site": run["launches_by_site"]}
    sharded = rec.get("sharded") or {}
    for name, run in (sharded.get("runs") or {}).items():
        by_path[f"sharded_{name}"] = {"ranks": run["ranks"], "backend": run["backend"],
                                      "by_site_per_rank": run["sites_by_rank"]}
    if sharded.get("dryrun"):
        by_path["sharded_dryrun"] = {"ranks": sharded["dryrun"]["ranks"],
                                     "backend": sharded["dryrun"]["backend"],
                                     "by_site_per_rank": sharded["dryrun"]["run"]["sites"]}
    mesh = rec.get("mesh") or {}
    for shards, run in (mesh.get("northstar") or {}).items():
        by_path[f"mesh_northstar_{shards}_shards"] = {
            "by_mode": run["launches"], "by_site": run["launches_by_site"],
            "by_site_per_pass": run["launches_by_site_per_pass"]}
    if mesh.get("core_script"):
        by_path["mesh_core_script"] = {"by_mode": mesh["core_script"]["launches"],
                                       "by_site": mesh["core_script"]["launches_by_site"]}
    cli_profile = (rec.get("cli") or {}).get("profile") or {}
    by_path["cli"] = {"profiled_launches": cli_profile.get("strongly_see_launches"),
                      "profile_s": cli_profile.get("seconds"),
                      "of": "node 0 of the CLI testnet, /debug/profile (torch.profiler)"}
    counts = {tuple(r["shape"]): r for r in rec.get("kernel_shapes", [])}
    gathered = rec.get("gathered_shapes", [])
    entries = []
    for name, rows, main, launches, extra in (
            ("strongly_see_counts", list(counts.values()), counts.get((64, 64, 64), {}),
             by_mode.get("counts", 0), {"shape": [64, 64, 64]}),
            ("strongly_see_gathered", gathered,
             next((r for r in gathered if r["name"] == "node_frontier_probe"
                   and r["mode"] == "tally"), {}),
             by_mode.get("matrix", 0) + by_mode.get("tally", 0),
             {"shape": f"node_frontier_probe tally [{4 * NODE_PROBE_WAYS}, 4, 4, 1]",
              "launches_on": "node (the live 4-node net on the torch engine)",
              "launches_by_mode": {k: by_mode.get(k, 0) for k in ("matrix", "tally")},
              "launches_by_site": engine_path.get("launches_by_site", {}),
              "launches_by_path": by_path,
              "cli_profile_launches": cli_profile.get("strongly_see_launches"),
              "northstar_launches_by_site":
                  (rec.get("northstar") or {}).get("launches_by_site", {})})):
        err = max((r["max_abs_err"] for r in rows), default=None)
        entries.append({
            "name": name, "route": "cuda",
            "source": "babble_tpu_torch/csrc/strongly_see.cu",
            "replaces": "babble_tpu/ops/pallas_kernels.py:62",
            "launches": launches, "max_abs_err": err, "max_abs_diff": err,
            "ms": main.get("ms"), "plain_ms": main.get("plain_ms"),
            "bound_ms": main.get("bound_ms"), "bound_by": main.get("bound_by"),
            "library_ms": None, **extra, "by_shape": rows})
    p = rec.get("p256") or {}
    main = next((r for r in p.get("sizes", []) if r["b"] == 64), {})
    plain = next((r for r in p.get("kernel_vs_plain", []) if r["b"] == 64), {})
    core_script = rec.get("node_core_script") or {}
    entries.append({
        "name": "p256_dual_window", "route": "cuda",
        "source": "babble_tpu_torch/csrc/p256.cu",
        "replaces": "babble_tpu/ops/p256.py:136",
        "launches": core_script.get("p256_launches", 0),
        "max_abs_err": max((r["max_abs_err"] for r in p.get("kernel_vs_plain", [])),
                           default=None),
        "ms": main.get("kernel_ms"), "plain_ms": plain.get("plain_ms"),
        "bound_ms": main.get("bound_ms"), "bound_by": main.get("bound_by"),
        "lane_chain_ms": main.get("lane_chain_ms"), "team_chain_ms": main.get("team_chain_ms"),
        "library_ms": None, "host_ms": main.get("host_ms"),
        "host_backend": p.get("host_backend"), "shape": "B = 64 signatures",
        "launches_on": "node_core_script (phase node (a), Core(device_verify=True))",
        "launches_by_path": {"node_core_script": core_script.get("p256_launches"),
                             "cli": {"profiled_launches": cli_profile.get("p256_launches"),
                                     "of": "node 0 of the CLI testnet (--device_verify), "
                                           "/debug/profile (torch.profiler)"}},
        "kernel_vs_plain": p.get("kernel_vs_plain"), "by_size": p.get("sizes")})
    return {"kernels": entries}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        import babble_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: the port is not importable here: {exc}", file=sys.stderr)
        return 2

    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    smi_line = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else ""
    host = host_name()
    print(f"device: {kind}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"count {torch.cuda.device_count()}; host: {host}")
    rec = {"device": kind, "nvidia_smi": smi_line, "host": host,
           "torch": torch.__version__, "cuda": torch.version.cuda, "failed": []}

    phases = [("build", phase_build), ("kernel", phase_kernel), ("p256", phase_p256),
              ("small", phase_small), ("headline", phase_headline),
              ("main_path", phase_main_path_counts), ("profile", phase_profile),
              ("northstar", phase_northstar), ("sim", phase_sim),
              ("sustained", phase_sustained),
              ("sustained_profile", phase_sustained_profile),
              ("northstar_incremental", phase_northstar_incremental),
              ("hashgraph", phase_hashgraph), ("node", phase_node), ("cli", phase_cli),
              ("sharded", phase_sharded), ("mesh", phase_mesh)]
    chosen = sys.argv[1:]
    if chosen:
        # A bring-up aid: build, then the named phases in the order given
        # (a phase may repeat), one JSON line of each run's record. The
        # kernels line and the final "ok" line belong to the whole run.
        known = dict(phases)
        unknown = sorted(set(chosen) - set(known))
        if unknown:
            print(f"chip_smoke: unknown phases {unknown}; known: {list(known)}",
                  file=sys.stderr)
            return 2
        phases = [("build", phase_build)] + [(name, known[name]) for name in chosen]
    t_all = time.perf_counter()
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            fn(rec)
        except Exception:  # noqa: BLE001 - every phase is reported, then the run fails
            traceback.print_exc()
            rec["failed"].append(name)
            print(f"phase {name}: FAILED", flush=True)
            if name == "build":
                break
        rec.setdefault("phase_s", {})[name] = time.perf_counter() - t0
        if chosen:
            print(json.dumps({"phase": name, "seconds": rec["phase_s"][name],
                              "failed": name in rec["failed"], "record": rec.get(name)},
                             default=str))
        sys.stdout.flush()
    rec["total_s"] = time.perf_counter() - t_all
    if chosen:
        print(smi_line)
        return 1 if rec["failed"] else 0

    if not smi_line:
        rec["failed"].append("nvidia-smi")
    print(json.dumps(kernels_line(rec)))
    print(json.dumps({"results": {k: rec.get(k) for k in
                                  ("host", "build", "p256", "headline",
                                   "main_path_launches",
                                   "profile", "northstar", "sim", "sustained",
                                   "sustained_profile", "northstar_incremental",
                                   "hashgraph", "node", "cli", "sharded", "mesh", "phase_s",
                                   "total_s")}},
                     default=str))
    print(smi_line)
    if rec["failed"]:
        print(f"chip_smoke: failed phases: {rec['failed']}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
