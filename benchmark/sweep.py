"""The knee of an open-loop cell: run it at each of a few rates and
report whether the node's backlog grew over the window.

    python3 benchmark/sweep.py --workload peers64.gossip --seconds 20 \\
        --rate 1000 --rate 2000 ... [--seed n]

Each rate runs `--repeat` times, each in a process of its own, as the
cell's runs do. One JSON line a run: the end-to-end metrics, whether
the run was correct, the events due, taken by the node (pushed),
inserted and ordered at the window's start and end, and the growth over
the window of the push lag (due - pushed) and of the order lag
(inserted - ordered). The knee is the highest rate at which every run
is correct and neither lag grows by more than `--slack` seconds' worth
of events; the cell's rate is four fifths of it (recorded in its
traffic file).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]

import run  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--rate", type=float, action="append", required=True)
    p.add_argument("--seed", type=int, default=2**33 + 17)
    p.add_argument("--slack", type=float, default=0.5)
    p.add_argument("--repeat", type=int, default=1)
    p.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if not args.child:
        for rate in args.rate:
            for k in range(args.repeat):
                subprocess.run([sys.executable, __file__, "--child", "--workload",
                                args.workload, "--seconds", str(args.seconds),
                                "--rate", str(rate), "--seed", str(args.seed + k),
                                "--slack", str(args.slack)], check=False)
        return 0
    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    cell = run.find_cell(bench, args.workload)
    cfg = json.loads((HERE / "configs" / f"{cell['config']}.json").read_text())
    base = json.loads((HERE / "traffic" / f"{cell['traffic']}.json").read_text())
    for rate in args.rate:
        traffic = dict(base, rate_events_per_s=rate)
        rec = {}
        out = run.run_cell(bench, cell, args.seed, args.seconds, False, "cuda",
                           time.perf_counter(), cfg=cfg, traffic=traffic, record=rec)
        s0, s1 = rec["snapshots"]
        push_growth = (s1["due"] - s1["pushed"]) - (s0["due"] - s0["pushed"])
        order_growth = (s1["inserted"] - s1["ordered"]) - (s0["inserted"] - s0["ordered"])
        print(json.dumps({
            "rate": rate, "correct": out["correct"],
            "metrics": {k: v["value"] for k, v in out["metrics"].items()},
            "start": s0, "end": s1, "push_lag_growth": push_growth,
            "order_lag_growth": order_growth,
            "grew": max(push_growth, order_growth) > args.slack * rate,
            "passes": rec["window_passes"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
