"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell (BENCHMARK.json `workloads`) names a configuration, found as
benchmark/configs/<config>.json, and a traffic mix, found as
benchmark/traffic/<traffic>.json; the mix's "driver" names the loop that
serves it (benchmark/<driver>.py). Each metric is read from the run's
record by benchmark/metrics/<metric>.py. A cell, configuration, mix or
metric is added by adding files and entries.

The run makes its inputs from --seed, warms up (set-up), measures for
--seconds, checks the outputs against the plain reference
(reference.py) and prints, as the last line of standard output, one
JSON object: correct, attempted, failed, metrics (the cell's end-to-end
metrics, or with --trace 1 its per-layer metrics), device, with
--trace 1 breakdown, and last `checks`, each compared number beside its
limit (also the last lines of standard error). It exits non-zero
without a result when no CUDA device is there, and when a module of JAX
or of the JAX package is loaded once the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "babble_tpu"})


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def find_cell(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise SystemExit(f"error: no workload {name!r} in BENCHMARK.json")


def metrics_of(bench: dict, cell: dict, kind: str) -> list:
    """The cell's metrics of `kind`: those listing it, or listing none."""
    return [m for m in bench[kind]
            if "workloads" not in m or cell["name"] in m["workloads"]]


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def run_cell(bench: dict, cell: dict, seed: int, seconds: float, trace: bool,
             device: str, t_start: float, cfg: dict = None,
             traffic: dict = None, record: dict = None) -> dict:
    """Everything of a run but the look for a chip: the driver's run,
    the metrics read from its record, the checks. `cfg` and `traffic`
    replace the cell's files (the tests and the knee sweep run others);
    `record`, a dict, receives the driver's whole record."""
    if str(HERE) not in sys.path:
        sys.path.insert(0, str(HERE))
    if cfg is None:
        cfg = json.loads((HERE / "configs" / f"{cell['config']}.json").read_text())
    if traffic is None:
        traffic = json.loads((HERE / "traffic" / f"{cell['traffic']}.json").read_text())
    driver = load_module(HERE / f"{traffic['driver']}.py", traffic["driver"])
    rec = driver.run(cfg=cfg, traffic=traffic, seed=seed, seconds=seconds,
                     trace=trace, device=device, t_start=t_start)
    if record is not None:
        record.update(rec)
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in metrics_of(bench, cell, kind):
        reader = load_module(HERE / "metrics" / f"{m['name']}.py",
                             "metric_" + m["name"].replace(".", "_"))
        value = reader.read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": rec["device_kind"], "count": int(cell["chips"]),
           "memory_peak_bytes": int(rec["memory_peak_bytes"])}
    out = {"correct": bool(rec["ok"]) and all(
               v <= lim for _, v, lim in rec["checks"]),
           "attempted": int(rec["attempted"]), "failed": int(rec["failed"]),
           "metrics": metrics, "device": dev}
    if trace and rec.get("trace"):
        dev["busy_s"] = rec["trace"]["busy_s"]
        dev["window_s"] = rec["trace"]["window_s"]
        out["breakdown"] = {"device_ops": rec["trace"]["device_ops"],
                            "idle_gaps": rec["trace"]["idle_gaps"]}
    out["checks"] = {name: {"value": v, "limit": lim}
                     for name, v, lim in rec["checks"]}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = find_cell(bench, args.workload)
    # Every build and kernel cache of the run stays inside the checkout.
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(ROOT / "build" / sub)
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"error: {cell['name']} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = run_cell(bench, cell, args.seed, args.seconds, bool(args.trace),
                   "cuda", T_START)
    found = forbidden_modules()
    if found:
        print("error: modules of JAX or the JAX package were loaded: "
              + ", ".join(found), file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
