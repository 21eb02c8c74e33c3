"""Merge N nodes' `/debug/trace` dumps into ONE Perfetto timeline.

Each babble node exports its span ring as Chrome trace-event JSON with
its own pid row — but on its own clock. This tool folds any number of
dumps (files or live `http://host:port/debug/trace` URLs) into a
single loadable document:

- one pid per node (colliding pids are remapped, metadata rewritten);
- every dump's timestamps rebased onto the shared cluster epoch using
  the clock block the node embeds (`babble.clock`: wall offset +
  cluster adjustment from the gossip offset handshake,
  telemetry/clock.py) — unless the dump was already exported with
  `?epoch=cluster`, which is detected and left alone;
- flow events (`ph` s/t/f) pass through untouched: they are matched by
  id, so after the rebase Perfetto draws one arrow chain per sampled
  transaction ACROSS the node rows — submit on one pid, gossip hops
  and commit on others.

Usage:

    python -m babble_tpu_torch.telemetry.tracemerge \
        -o merged.json node0.json http://127.0.0.1:8001/debug/trace

    # CI smoke: merge + structural validation (s/f pairing, cross-pid
    # flows) in one shot
    python -m babble_tpu_torch.telemetry.tracemerge --check \
        --require-cross-pid-flow -o merged.json node*.json
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional, Tuple

__all__ = ["merge", "validate", "load_dump", "main"]


def load_dump(src: str, timeout: float = 10.0) -> dict:
    """Load one dump from a file path or an http(s) URL."""
    if src.startswith("http://") or src.startswith("https://"):
        import urllib.request

        with urllib.request.urlopen(src, timeout=timeout) as r:
            return json.loads(r.read())
    with open(src, "rb") as f:
        return json.load(f)


def _dump_pid(doc: dict) -> Optional[int]:
    babble = doc.get("babble") or {}
    if isinstance(babble.get("pid"), int):
        return babble["pid"]
    for ev in doc.get("traceEvents", []):
        if "pid" in ev:
            return ev["pid"]
    return None


def _rebase_shift_us(doc: dict) -> float:
    """Microseconds to ADD to this dump's timestamps to land on the
    cluster epoch. 0 when the dump is already epoch-rebased or carries
    no clock block (merging such dumps still works, but their rows are
    only aligned if their sources shared a clock)."""
    babble = doc.get("babble") or {}
    if babble.get("epoch") == "cluster":
        return 0.0
    clock = babble.get("clock")
    if not clock:
        return 0.0
    shift_ns = (clock.get("wall_offset_ns", 0)
                + clock.get("cluster_adjust_ns", 0))
    return shift_ns / 1000.0


def merge(docs: List[dict]) -> dict:
    """Merge dumps into one Chrome trace document (see module doc)."""
    used_pids: Dict[int, int] = {}
    next_free = 0
    events: List[dict] = []
    for doc in docs:
        pid = _dump_pid(doc)
        if pid is None or pid in used_pids:
            while next_free in used_pids:
                next_free += 1
            new_pid = next_free
        else:
            new_pid = pid
        used_pids[new_pid] = 1
        shift = _rebase_shift_us(doc)
        for ev in doc.get("traceEvents", []):
            ev = dict(ev)
            ev["pid"] = new_pid
            if shift and "ts" in ev:
                ev["ts"] = ev["ts"] + shift
            events.append(ev)
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "babble": {"merged_from": len(docs), "epoch": "cluster"},
    }


def validate(doc: dict,
             require_cross_pid_flow: bool = False) -> List[str]:
    """Structural checks on a (merged) trace document; returns a list
    of problems, empty when the document is sound. The promtext-style
    checker for traces: CI merges a testnet's dumps and fails the job
    on any finding instead of eyeballing a Perfetto screenshot."""
    problems: List[str] = []
    events = doc.get("traceEvents")
    if not isinstance(events, list) or not events:
        return ["no traceEvents"]
    pids = set()
    named_pids = set()
    flows: Dict[object, List[Tuple[str, int, float]]] = {}
    for i, ev in enumerate(events):
        ph = ev.get("ph")
        if ph is None or "pid" not in ev:
            problems.append(f"event {i}: missing ph/pid")
            continue
        pids.add(ev["pid"])
        if ph == "M":
            if ev.get("name") == "process_name":
                named_pids.add(ev["pid"])
            continue
        if "ts" not in ev:
            problems.append(f"event {i}: {ph!r} without ts")
            continue
        if ph == "X":
            if ev.get("dur", -1) < 0:
                problems.append(f"event {i}: X with negative/missing dur")
        elif ph in ("s", "t", "f"):
            if "id" not in ev:
                problems.append(f"event {i}: flow {ph!r} without id")
                continue
            flows.setdefault(ev["id"], []).append(
                (ph, ev["pid"], ev["ts"]))
    unnamed = pids - named_pids
    if unnamed:
        problems.append(f"pids without process_name metadata: "
                        f"{sorted(unnamed)}")
    cross_pid_complete = 0
    for fid, chain in flows.items():
        phases = [p for p, _, _ in chain]
        if phases.count("s") != 1:
            problems.append(
                f"flow {fid}: {phases.count('s')} start events")
            continue
        if phases.count("f") > 1:
            problems.append(f"flow {fid}: multiple finish events")
            continue
        if "f" in phases and len({p for _, p, _ in chain}) >= 2:
            cross_pid_complete += 1
    if require_cross_pid_flow and cross_pid_complete == 0:
        problems.append(
            "no complete flow (s..f) spanning >= 2 node pids — sampled "
            "transactions did not trace across the cluster")
    return problems


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m babble_tpu_torch.telemetry.tracemerge",
        description="Merge N /debug/trace dumps into one Perfetto "
                    "timeline on the shared cluster epoch.")
    ap.add_argument("inputs", nargs="+", metavar="FILE_OR_URL",
                    help="trace dumps: JSON files or live "
                         "http://host:port/debug/trace URLs")
    ap.add_argument("-o", "--out", default="-",
                    help="output path (default stdout)")
    ap.add_argument("--check", action="store_true",
                    help="validate the merged document; non-zero exit "
                         "on any structural problem")
    ap.add_argument("--require-cross-pid-flow", action="store_true",
                    help="with --check: fail unless at least one "
                         "complete flow chain spans >= 2 node pids")
    args = ap.parse_args(argv)

    docs = []
    for src in args.inputs:
        try:
            docs.append(load_dump(src))
        except Exception as exc:  # noqa: BLE001 - CLI surface
            print(f"tracemerge: cannot load {src}: {exc}",
                  file=sys.stderr)
            return 1
    merged = merge(docs)
    body = json.dumps(merged)
    if args.out == "-":
        sys.stdout.write(body + "\n")
    else:
        with open(args.out, "w") as f:
            f.write(body)
    n_flow = sum(1 for e in merged["traceEvents"]
                 if e.get("ph") in ("s", "t", "f"))
    print(f"tracemerge: {len(docs)} dumps, "
          f"{len(merged['traceEvents'])} events, {n_flow} flow events",
          file=sys.stderr)
    if args.check:
        problems = validate(
            merged, require_cross_pid_flow=args.require_cross_pid_flow)
        if problems:
            for p in problems:
                print(f"tracemerge: FAIL: {p}", file=sys.stderr)
            return 1
        print("tracemerge: check ok", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
