"""Render a node's `/debug/hashgraph` DAG window as Graphviz DOT.

The hashgraph's whole argument is geometric — rounds, witnesses, fame,
strongly-seeing paths — and a JSON event list is the wrong instrument
for "why did round 7 never decide". This tool turns the bounded DAG
window the service exports (docs/observability.md "Consensus health")
into a picture:

    python -m babble_tpu_torch.telemetry.dagdump \
        http://127.0.0.1:8000/debug/hashgraph?from=5 -o dag.dot
    dot -Tsvg dag.dot -o dag.svg     # or paste into an online viewer

Layout: one column per creator (creator ids become Graphviz clusters),
bottom-up like every hashgraph diagram. Encoding:

- solid edge: self-parent; dashed edge: other-parent;
- doubled border (peripheries=2): witness;
- green fill: famous witness; red border: fame decided NOT famous;
- grey fill: event committed (round_received set);
- label: creator#index, round r / received rr, tx count.

Input is a file path or a live URL (same convention as tracemerge).
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional

__all__ = ["render_dot", "load_window", "main"]


def load_window(src: str, timeout: float = 10.0) -> dict:
    """Load one /debug/hashgraph document from a file path or URL."""
    if src.startswith("http://") or src.startswith("https://"):
        import urllib.request

        with urllib.request.urlopen(src, timeout=timeout) as r:
            return json.loads(r.read())
    with open(src, "rb") as f:
        return json.load(f)


def _node_id(h: str) -> str:
    # DOT identifiers: quote-free, stable, short enough to read in
    # the source. Hash prefixes are unique within any realistic
    # window (and collisions would only merge two drawn nodes).
    return "e" + h[2:14].lower()


def _attrs(ev: Dict) -> str:
    label = (f"{ev['creator_id']}#{ev['index']}"
             f"\\nr{ev['round'] if ev['round'] is not None else '?'}")
    if ev.get("round_received") is not None:
        label += f" rr{ev['round_received']}"
    if ev.get("txs"):
        label += f"\\n{ev['txs']} tx"
    attrs = [f'label="{label}"']
    style = []
    if ev.get("round_received") is not None:
        style.append("filled")
        attrs.append('fillcolor="grey88"')
    if ev.get("witness"):
        attrs.append("peripheries=2")
        if ev.get("famous") is True:
            if "filled" not in style:
                style.append("filled")
            attrs = [a for a in attrs if not a.startswith("fillcolor")]
            attrs.append('fillcolor="palegreen"')
        elif ev.get("famous") is False:
            attrs.append('color="red3"')
    if style:
        attrs.append(f'style="{",".join(style)}"')
    return ", ".join(attrs)


def render_dot(window: Dict, title: str = "hashgraph") -> str:
    """One DOT digraph from a /debug/hashgraph window: clustered by
    creator, edges bottom-up (rankdir=BT), annotations as colors."""
    events: List[Dict] = window.get("events", [])
    known = {ev["hash"] for ev in events}
    by_creator: Dict[int, List[Dict]] = {}
    for ev in events:
        by_creator.setdefault(ev["creator_id"], []).append(ev)

    out: List[str] = []
    out.append(f'digraph "{title}" {{')
    out.append("  rankdir=BT;")
    out.append('  node [shape=box, fontsize=9, fontname="monospace"];')
    out.append("  edge [arrowsize=0.6];")
    meta = (f"rounds {window.get('from_round')}..{window.get('to_round')}"
            f" / last consensus {window.get('last_consensus_round')}")
    out.append(f'  label="{title}: {meta}"; labelloc=t; fontsize=11;')
    for cid in sorted(by_creator):
        out.append(f"  subgraph cluster_{cid} {{")
        out.append(f'    label="creator {cid}"; color="grey70";'
                   " fontsize=10;")
        for ev in sorted(by_creator[cid], key=lambda e: e["index"]):
            out.append(f"    {_node_id(ev['hash'])} [{_attrs(ev)}];")
        out.append("  }")
    for ev in events:
        me = _node_id(ev["hash"])
        sp, op = ev.get("self_parent", ""), ev.get("other_parent", "")
        if sp in known:
            out.append(f"  {me} -> {_node_id(sp)};")
        if op and op in known:
            out.append(f"  {me} -> {_node_id(op)} [style=dashed];")
    out.append("}")
    return "\n".join(out) + "\n"


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m babble_tpu_torch.telemetry.dagdump",
        description="Render a /debug/hashgraph DAG window to Graphviz "
                    "DOT.")
    ap.add_argument("source",
                    help="a saved window JSON file, or a live "
                         "http://host:port/debug/hashgraph URL")
    ap.add_argument("-o", "--output", default="-",
                    help="output .dot path (default: stdout)")
    ap.add_argument("--from", dest="from_round", type=int, default=None,
                    help="window start round (appended to a URL source "
                         "as ?from=)")
    ap.add_argument("--title", default="hashgraph")
    args = ap.parse_args(argv)

    src = args.source
    if args.from_round is not None and src.startswith("http"):
        sep = "&" if "?" in src else "?"
        src = f"{src}{sep}from={args.from_round}"
    try:
        window = load_window(src)
    except Exception as exc:  # noqa: BLE001 - CLI boundary
        print(f"dagdump: cannot load {src}: {exc}", file=sys.stderr)
        return 1
    if "events" not in window:
        print("dagdump: source is not a /debug/hashgraph window "
              "(no 'events' key)", file=sys.stderr)
        return 1
    dot = render_dot(window, title=args.title)
    if args.output == "-":
        sys.stdout.write(dot)
    else:
        with open(args.output, "w") as f:
            f.write(dot)
        print(f"dagdump: {len(window['events'])} events -> "
              f"{args.output}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
