"""Copy drift: the port's copies of the JAX package's jax-free modules
(babble_tpu_torch/<path> of babble_tpu/<path>) stay identical to their
source as text, apart from import statements and the listed lines.

The port may not import the reference package, so it keeps copies
(common/, gojson.py, crypto/, the hashgraph models, stores and host
graph, telemetry/, net/, proxy/, service/, node/, dummy.py, cli.py).
A fix made in one copy and not the other fails here. Every other difference is listed in
ALLOWED as a range of reference lines, each with its reason."""

from __future__ import annotations

import ast
import difflib
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "babble_tpu_torch"
REF = ROOT / "babble_tpu"

# Port files that share a path with the reference but are the port's
# own code, not copies.
OWN = {"__init__.py", "devices.py"}

# Reference line ranges (1-based, inclusive) that a copy may replace.
ALLOWED = {
    # The package's name in the backend note.
    "crypto/_fallback.py": [(16, 16)],
    # The port's docstring; TorchHashgraph.
    "hashgraph/__init__.py": [(1, 1), (34, 34)],
    # Names the port's device engine in place of the TPU one.
    "hashgraph/graph.py": [(6, 6)],
    # The port's logger name; the engine, device_verify and compile
    # cache comments say what the port does; the torch engine is the
    # default and failover to the host engine is opt-in (threshold 0).
    "node/config.py": [(12, 12), (87, 94), (131, 136), (149, 153), (180, 188)],
    # The engine seam (engine="torch", the default), device_verify on
    # the engine's device (resolved at construction, passed to each
    # verify), the port's logger name.
    "node/core.py": [(35, 35), (53, 118), (121, 128), (241, 241), (500, 500),
                     (504, 504)],
    # A fault the reference has (ROADMAP §C, C6): a routine was
    # registered before it was started, and wait_routines, joining it
    # meanwhile, raised; the port starts it first.
    "node/state.py": [(48, 52)],
    # Device verify on the port's CUDA kernel, on a named device, with
    # no host fallback.
    "node/ingest.py": [(17, 18), (91, 105), (197, 197), (204, 218)],
    # The port's package name in usage, prog and help strings and its
    # logger name; no XLA compile cache (the kernels build at first use
    # into build/kernels/); the torch engine is the default, with the
    # 250 ms interval floor; --engine_device (default cuda) and the exit
    # when Core refuses the engine or finds no device; --device_verify's
    # help names the port's kernel; failover off by default (threshold 0);
    # the program exits without finalizing the interpreter (daemon threads
    # in torch's C++ code abort a finalizing process); --engine_mesh's help
    # names the torch engine's shards.
    "cli.py": [(8, 8), (62, 62), (72, 81), (110, 110), (144, 145), (179, 179),
               (221, 221), (261, 261), (326, 328), (330, 333), (337, 337), (361, 364),
               (454, 454), (457, 457), (474, 474)],
    # The port's package name in the usage line.
    "dummy.py": [(7, 7)],
    # /debug/profile captures with torch.profiler (docstring, capture);
    # the port's dagdump; ?cost=1 counts the pass's cost from its
    # shapes (no XLA cost model) and names the port's device engine.
    "service/service.py": [(5, 5), (240, 240), (287, 290), (306, 306), (328, 330)],
    # A fault the reference has (ROADMAP §C, C4): a /Stats, /metrics or
    # /debug/capacity scrape sized the store's caches while other
    # threads wrote them and could raise; the port snapshots the sample.
    "telemetry/capacity.py": [(171, 171)],
    # The port's package name in the usage strings.
    "telemetry/dagdump.py": [(9, 9), (116, 116)],
    "telemetry/promtext.py": [(9, 9), (195, 195)],
    "telemetry/tracemerge.py": [(21, 21), (26, 26), (165, 165)],
}


def _copies():
    out = []
    for p in sorted(PORT.rglob("*.py")):
        rel = p.relative_to(PORT).as_posix()
        if rel in OWN or rel.startswith("ops/") or not (REF / rel).exists():
            continue
        out.append(rel)
    return out


COPIES = _copies()


def _import_lines(text):
    lines = set()
    for node in ast.walk(ast.parse(text)):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            lines.update(range(node.lineno, node.end_lineno + 1))
    return lines


def test_the_node_slice_is_copied():
    for rel in ("node/node.py", "node/core.py", "net/inmem_transport.py",
                "net/columnar.py", "proxy/inmem_app_proxy.py", "service/ingress.py",
                "telemetry/registry.py", "hashgraph/graph.py"):
        assert rel in COPIES, rel
    assert set(ALLOWED) <= set(COPIES)


def test_the_rest_of_the_node_seam_is_copied():
    for rel in ("telemetry/promtext.py", "telemetry/dagdump.py",
                "telemetry/tracemerge.py", "hashgraph/file_store.py",
                "net/tcp_transport.py", "net/faulty_transport.py",
                "proxy/jsonrpc.py", "proxy/socket_app_proxy.py",
                "proxy/socket_babble_proxy.py", "proxy/file_app_proxy.py",
                "service/service.py", "dummy.py", "cli.py", "hashgraph/__init__.py",
                "net/__init__.py", "proxy/__init__.py", "service/__init__.py"):
        assert rel in COPIES, rel
    assert set(ALLOWED) <= set(COPIES)


@pytest.mark.parametrize("rel", COPIES)
def test_copy_matches_reference(rel):
    ref_text = (REF / rel).read_text()
    port_text = (PORT / rel).read_text()
    a, b = ref_text.splitlines(), port_text.splitlines()
    ia, ib = _import_lines(ref_text), _import_lines(port_text)
    allowed = ALLOWED.get(rel, [])
    bad = []
    matcher = difflib.SequenceMatcher(None, a, b, autojunk=False)
    for tag, i1, i2, j1, j2 in matcher.get_opcodes():
        if tag == "equal":
            continue
        if all(k + 1 in ia for k in range(i1, i2)) and all(k + 1 in ib for k in range(j1, j2)):
            continue  # import statements only
        lo, hi = i1 + 1, max(i2, i1 + 1)
        if not any(s <= lo and hi <= e for s, e in allowed):
            bad.append(f"reference lines {i1 + 1}-{i2} vs port lines {j1 + 1}-{j2}:\n"
                       + "\n".join(difflib.unified_diff(a[i1:i2], b[j1:j2], lineterm="")))
    assert not bad, f"{rel} drifted from babble_tpu/{rel}:\n" + "\n\n".join(bad)
