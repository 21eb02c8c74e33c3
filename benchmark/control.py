"""The control of the check that decides `correct`: the plain reference
put in the node's place with one guarantee of the configuration broken
(the BFT supermajority 2n/3 + 1 lowered to a simple majority n/2 + 1),
judged by the same comparison as the node. Its numbers are the upper
readings the limits are set below.

    python3 benchmark/control.py --workload <name> --seed <n> [--seed <n> ...]

prints one JSON line a seed with the comparison's numbers. It runs the
reference twice at the cell's sizes on the card (or `--device cpu`).
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

import compare  # noqa: E402
import reference  # noqa: E402
import stream  # noqa: E402


def capture_of(res, st, p: int) -> dict:
    """A result of the reference as a node's capture of the first p events."""
    rounds = np.full(st.e, -1, np.int64)
    rr = np.full(st.e, -1, np.int64)
    rounds[:p], rr[:p] = res.rounds, res.rr
    return {"order": [st.hexes[i] for i in res.order],
            "held": np.arange(st.e) < p, "rounds": rounds, "rr": rr,
            "cts": {st.hexes[i]: res.cts_ns[i] for i in res.order},
            "blocks": list(res.blocks)}


def readings(cfg: dict, traffic: dict, seed: int, device: str, seconds: float) -> dict:
    """The comparison's numbers for the control on the stream of a run of
    this cell with `seed`: the stream the node takes (a closed loop's
    `events`, an open loop's events due by the window's end) at a
    simple majority, against the reference over the whole stream."""
    if "events" in traffic:
        total = int(traffic["events"]) + int(traffic["tail_events"])
        st = stream.generate(cfg, total, seed, topology_seed=traffic.get("topology_seed"))
        p = int(traffic["events"])
    else:
        rate = float(traffic["rate_events_per_s"])
        total = int(math.ceil(rate * (float(traffic["warm_s"]) + seconds
                                      + float(traffic["drain_s"]))))
        st = stream.generate(cfg, total, seed, rate=rate,
                             topology_seed=traffic.get("topology_seed"))
        p = int(np.searchsorted(st.due_s, float(traffic["warm_s"]) + seconds))
    index = {h: i for i, h in enumerate(st.hexes)}
    ref = reference.consensus(st, device=device)
    floor = len(reference.consensus(stream.prefix(st, p), device=device).order)
    ctl = reference.consensus(stream.prefix(st, p), device=device, sm=st.n // 2 + 1)
    out = compare.compare(capture_of(ctl, st, p), ref, st.hexes, index, p, floor)
    out["seed"] = seed
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, action="append", required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    cell = next(w for w in bench["workloads"] if w["name"] == args.workload)
    cfg = json.loads((HERE / "configs" / f"{cell['config']}.json").read_text())
    traffic = json.loads((HERE / "traffic" / f"{cell['traffic']}.json").read_text())
    for seed in args.seed:
        t0 = time.perf_counter()
        out = readings(cfg, traffic, seed, args.device, float(bench["run_seconds"]))
        out["seconds"] = time.perf_counter() - t0
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
