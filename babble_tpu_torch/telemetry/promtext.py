"""Prometheus text-exposition parser + scrape checker.

The consumer side of registry.render(): tests and bench parse a
/metrics scrape back into families instead of regex-poking the text,
and CI can pipe a scrape through the module CLI to fail loudly on a
malformed exposition or a missing core series:

    curl -s http://127.0.0.1:8000/metrics | \
        python -m babble_tpu_torch.telemetry.promtext \
            --require babble_commit_latency_seconds \
            --require babble_breaker_state
"""

from __future__ import annotations

import re
import sys
from typing import Dict, Iterable, List, Optional, Tuple

from .registry import HistogramSnapshot

Sample = Tuple[Dict[str, str], float]

_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>.*)\})?"
    r"\s+(?P<value>[^\s]+)(?:\s+(?P<ts>-?\d+))?$")
_LABEL_RE = re.compile(
    r'(?P<k>[a-zA-Z_][a-zA-Z0-9_]*)="(?P<v>(?:\\.|[^"\\])*)"')


def _unescape(v: str) -> str:
    return v.replace(r"\"", '"').replace(r"\n", "\n").replace("\\\\", "\\")


def parse(text: str) -> Tuple[Dict[str, List[Sample]], Dict[str, str]]:
    """Parse an exposition into (samples, types).

    samples: sample name -> [(labels, value)] — histogram series appear
    under their full `_bucket`/`_sum`/`_count` sample names.
    types: family name -> declared TYPE.

    Raises ValueError on any line that is neither a comment, blank,
    nor a well-formed sample — a scraper must fail loudly, not skip."""
    samples: Dict[str, List[Sample]] = {}
    types: Dict[str, str] = {}
    for lineno, line in enumerate(text.splitlines(), 1):
        line = line.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) >= 4 and parts[1] == "TYPE":
                types[parts[2]] = parts[3]
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ValueError(f"line {lineno}: malformed sample {line!r}")
        labels: Dict[str, str] = {}
        raw = m.group("labels")
        if raw:
            consumed = 0
            for lm in _LABEL_RE.finditer(raw):
                labels[lm.group("k")] = _unescape(lm.group("v"))
                consumed = lm.end()
            # Everything past the last match must be separators, else
            # the label block was malformed (e.g. an unquoted value).
            if not labels or raw[consumed:].strip(", \t"):
                raise ValueError(
                    f"line {lineno}: malformed labels {raw!r}")
        try:
            value = float(m.group("value").replace("+Inf", "inf")
                          .replace("-Inf", "-inf"))
        except ValueError as exc:
            raise ValueError(
                f"line {lineno}: bad value {m.group('value')!r}") from exc
        samples.setdefault(m.group("name"), []).append((labels, value))
    return samples, types


def histogram_snapshot(
        samples: Dict[str, List[Sample]], name: str,
        match: Optional[Dict[str, str]] = None) -> HistogramSnapshot:
    """Rebuild a merged HistogramSnapshot from parsed `_bucket`/`_sum`/
    `_count` series whose labels contain `match` — so scrape-side
    checks can compute p50/p99 with the same bucket math as the
    in-process registry."""
    match = match or {}

    def keep(labels: Dict[str, str]) -> bool:
        return all(labels.get(k) == v for k, v in match.items())

    # Cumulative bucket counts, grouped per child label set.
    children: Dict[Tuple[Tuple[str, str], ...],
                   List[Tuple[float, float]]] = {}
    for labels, value in samples.get(f"{name}_bucket", []):
        if not keep(labels):
            continue
        le = labels["le"]
        bound = float("inf") if le == "+Inf" else float(le)
        key = tuple(sorted((k, v) for k, v in labels.items() if k != "le"))
        children.setdefault(key, []).append((bound, value))
    if not children:
        raise ValueError(f"no {name}_bucket series matching {match}")

    total_sum = sum(v for labels, v in samples.get(f"{name}_sum", [])
                    if keep(labels))
    snap: Optional[HistogramSnapshot] = None
    for series in children.values():
        series.sort()
        bounds = tuple(b for b, _ in series if b != float("inf"))
        cum = [c for _, c in series]
        counts, prev = [], 0.0
        for c in cum:
            counts.append(int(c - prev))
            prev = c
        child = HistogramSnapshot(bounds, tuple(counts), 0.0, int(cum[-1]))
        snap = child if snap is None else snap.merge(child)
    return HistogramSnapshot(snap.buckets, snap.counts, total_sum,
                             snap.count)


_REQUIRE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>.*)\})?$")


def parse_require(spec: str) -> Tuple[str, Dict[str, str]]:
    """Parse a --require spec: a bare family name, or
    `NAME{label="value",...}` — the Prometheus selector spelling, so
    CI can assert per-peer / per-creator series, not just families.
    Raises ValueError on a malformed spec (a silently-ignored matcher
    would pass a check it never ran)."""
    m = _REQUIRE_RE.match(spec.strip())
    if m is None:
        raise ValueError(f"malformed require spec {spec!r}")
    want: Dict[str, str] = {}
    raw = m.group("labels")
    if raw is not None:
        consumed = 0
        for lm in _LABEL_RE.finditer(raw):
            want[lm.group("k")] = _unescape(lm.group("v"))
            consumed = lm.end()
        if raw[consumed:].strip(", \t") or (raw.strip() and not want):
            raise ValueError(f"malformed label matchers in {spec!r}")
    return m.group("name"), want


def check_series(samples: Dict[str, List[Sample]],
                 required: Iterable[str]) -> List[str]:
    """Return the required specs with NO matching samples in the
    scrape. A spec is a family name, optionally with label matchers
    (`NAME{label="value"}`); every matcher must be a subset of some
    sample's labels. Histograms count as present when their `_count`
    series matches."""
    missing = []
    for spec in required:
        name, want = parse_require(spec)
        rows = list(samples.get(name, ()))
        rows += samples.get(f"{name}_count", ())
        if not any(all(labels.get(k) == v for k, v in want.items())
                   for labels, _v in rows):
            missing.append(spec)
    return missing


def family_series_counts(
        samples: Dict[str, List[Sample]]) -> Dict[str, int]:
    """Series per family from a parsed scrape — histogram `_bucket`/
    `_sum`/`_count` sample names fold back onto their family name, and
    bucket rows count once per child (the `le` label is stripped), so
    the number measures label-set cardinality, not bucket resolution."""
    hist_stems = {n[:-len("_bucket")] for n in samples
                  if n.endswith("_bucket")}
    out: Dict[str, int] = {}
    for name, rows in samples.items():
        fam = name
        for suffix in ("_bucket", "_sum", "_count"):
            stem = name[:-len(suffix)]
            if name.endswith(suffix) and stem in hist_stems:
                fam = stem
                break
        keys = {tuple(sorted((k, v) for k, v in labels.items()
                             if k != "le"))
                for labels, _v in rows}
        cur = out.get(fam)
        out[fam] = max(cur, len(keys)) if cur is not None else len(keys)
    return out


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m babble_tpu_torch.telemetry.promtext",
        description="Validate a Prometheus text scrape from stdin.")
    ap.add_argument("--require", action="append", default=[],
                    metavar="NAME[{label=\"value\"}]",
                    help="fail unless this metric family has samples; "
                         "label matchers select specific series, e.g. "
                         "babble_forks_total{creator=\"0x04AB\"} "
                         "(repeatable)")
    ap.add_argument("--max-series", type=int, default=0, metavar="N",
                    help="fail when any single family exposes more "
                         "than N series (label-set cardinality lint; "
                         "0 = unchecked)")
    args = ap.parse_args(argv)
    text = sys.stdin.read()
    try:
        samples, types = parse(text)
    except ValueError as exc:
        print(f"promtext: parse error: {exc}", file=sys.stderr)
        return 1
    try:
        missing = check_series(samples, args.require)
    except ValueError as exc:
        print(f"promtext: {exc}", file=sys.stderr)
        return 1
    if missing:
        print(f"promtext: missing required series: {missing}",
              file=sys.stderr)
        return 1
    if args.max_series > 0:
        fat = {fam: n
               for fam, n in family_series_counts(samples).items()
               if n > args.max_series}
        if fat:
            worst = sorted(fat.items(), key=lambda kv: -kv[1])
            print(f"promtext: cardinality over --max-series="
                  f"{args.max_series}: {worst}", file=sys.stderr)
            return 1
    print(f"promtext: ok ({len(samples)} sample families, "
          f"{len(types)} typed)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
