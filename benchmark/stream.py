"""The benchmark's event stream: a gossip network's signed events, made
from a seed, and their wire frames.

A stream is the events that n - 1 peers create while gossiping with
each other; the node under test is the n-th participant and is silent
in it (it counts in n and in the supermajority, and creates no event).
A configuration may declare `silent_validators` f more: validators that
count in n and in the supermajority, hold keys and are participants,
but create no event and are never an other-parent (missing or crashed
peers), so n - 1 - f creators remain. Each step one active creator
records a sync from another active peer:
its new event's self-parent is its own last event and its other-parent
the peer's last event, the pattern of the node runtime. Every event
carries `txs_per_event` short text transactions, each unique, and a
claimed timestamp: a fixed epoch plus the event's due time.

Encodings, as the system's wire and hashes define them:
- the body's Go-JSON encoding (fields Transactions, Parents, Creator,
  Timestamp, Index; byte slices in base64, time in RFC 3339 with
  nanoseconds, a trailing newline) is hashed with SHA-256 and signed
  (RFC 6979, `signer.py`);
- the event's hash is SHA-256 of {"Body":..., "R":..., "S":...} and
  names it as "0x" and 64 upper-case hex digits;
- a batch travels as one columnar frame (magic "BBC1", then int32
  columns creator id, index, self-parent index, other-parent creator
  and index, int64 timestamps, r||s, tx counts and lengths, the tx
  blob), the layout the gossip transport ships.
"""

from __future__ import annotations

import base64
import datetime
import hashlib
import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from signer import N, Signer

EPOCH_NS = 1_767_225_600 * 1_000_000_000  # 2026-01-01T00:00:00Z
_GO_EPOCH = datetime.datetime(1970, 1, 1)
MAGIC = b"BBC1"


def rfc3339nano(ns: int) -> str:
    sec, nanos = divmod(ns, 1_000_000_000)
    dt = _GO_EPOCH + datetime.timedelta(seconds=sec)
    base = (f"{dt.year:04d}-{dt.month:02d}-{dt.day:02d}"
            f"T{dt.hour:02d}:{dt.minute:02d}:{dt.second:02d}")
    if nanos:
        base += "." + f"{nanos:09d}".rstrip("0")
    return base + "Z"


def key_scalar(seed: int, i: int) -> int:
    """Participant i's private scalar, from the seed."""
    h = hashlib.sha256(b"babble benchmark key %d %d" % (seed, i)).digest()
    return int.from_bytes(h, "big") % (N - 1) + 1


@dataclass
class Stream:
    n: int
    silent: int  # participant id of the node under test
    node_key: int  # its private scalar
    participants: Dict[str, int]  # "0x" + hex(pub) upper -> id
    pubs: List[bytes]  # by id
    creator: np.ndarray  # [E] int32
    index: np.ndarray  # [E] int32
    self_parent: np.ndarray  # [E] int32 event id, -1 none
    other_parent: np.ndarray  # [E] int32 event id, -1 none
    ts_ns: np.ndarray  # [E] int64 claimed timestamps
    due_s: np.ndarray  # [E] float64 seconds after the stream's start
    txs: List[List[bytes]]
    r: List[int] = field(default_factory=list)
    s: List[int] = field(default_factory=list)
    hexes: List[str] = field(default_factory=list)
    sigs: bytes = b""  # r||s, 64 bytes an event
    tx_blob: bytes = b""
    tx_off: Optional[np.ndarray] = None  # [E+1] byte offset of each event's txs
    tx_lens: Optional[np.ndarray] = None  # [T] int32

    @property
    def e(self) -> int:
        return len(self.creator)

    def frame(self, lo: int, hi: int) -> bytes:
        """The columnar wire frame of events [lo, hi) of the stream."""
        cnt = hi - lo
        cr = self.creator[lo:hi]
        sp, op = self.self_parent[lo:hi], self.other_parent[lo:hi]
        op_ok = op >= 0
        op_safe = np.where(op_ok, op, 0)
        cols = [cr, self.index[lo:hi],
                np.where(sp >= 0, self.index[lo:hi] - 1, -1),
                np.where(op_ok, self.creator[op_safe], -1),
                np.where(op_ok, self.index[op_safe], -1)]
        t0, t1 = self._tx_first[lo], self._tx_first[hi]
        blob = self.tx_blob[self.tx_off[lo]:self.tx_off[hi]]
        head = MAGIC + struct.pack("<IBIQ", cnt, 0, int(t1 - t0), len(blob))
        parts = [head] + [np.ascontiguousarray(c, "<i4").tobytes() for c in cols]
        parts.append(np.ascontiguousarray(self.ts_ns[lo:hi], "<i8").tobytes())
        parts.append(self.sigs[64 * lo:64 * hi])
        parts.append(np.ascontiguousarray(self._tx_count[lo:hi], "<i4").tobytes())
        parts.append(np.ascontiguousarray(self.tx_lens[t0:t1], "<i4").tobytes())
        parts.append(blob)
        return b"".join(parts)

    def frame_ids(self, ids) -> bytes:
        """The columnar wire frame of the events `ids`, in that order."""
        ids = np.asarray(ids, np.int64)
        if len(ids) and ids[-1] - ids[0] + 1 == len(ids) and np.all(np.diff(ids) == 1):
            return self.frame(int(ids[0]), int(ids[-1]) + 1)
        cr = self.creator[ids]
        sp, op = self.self_parent[ids], self.other_parent[ids]
        op_ok = op >= 0
        op_safe = np.where(op_ok, op, 0)
        cols = [cr, self.index[ids],
                np.where(sp >= 0, self.index[ids] - 1, -1),
                np.where(op_ok, self.creator[op_safe], -1),
                np.where(op_ok, self.index[op_safe], -1)]
        lens = [self.tx_lens[self._tx_first[i]:self._tx_first[i + 1]] for i in ids]
        blob = b"".join(self.tx_blob[self.tx_off[i]:self.tx_off[i + 1]] for i in ids)
        t = int(sum(len(x) for x in lens))
        head = MAGIC + struct.pack("<IBIQ", len(ids), 0, t, len(blob))
        parts = [head] + [np.ascontiguousarray(c, "<i4").tobytes() for c in cols]
        parts.append(np.ascontiguousarray(self.ts_ns[ids], "<i8").tobytes())
        parts.append(b"".join(self.sigs[64 * i:64 * i + 64] for i in ids))
        parts.append(np.ascontiguousarray(self._tx_count[ids], "<i4").tobytes())
        parts.append(np.ascontiguousarray(
            np.concatenate(lens) if lens else np.zeros(0, np.int32), "<i4").tobytes())
        parts.append(blob)
        return b"".join(parts)


def prefix(st: Stream, p: int):
    """The first p events of the stream, as the reference reads them."""
    return Stream(n=st.n, silent=st.silent, node_key=st.node_key,
                  participants=st.participants, pubs=st.pubs,
                  creator=st.creator[:p], index=st.index[:p],
                  self_parent=st.self_parent[:p], other_parent=st.other_parent[:p],
                  ts_ns=st.ts_ns[:p], due_s=st.due_s[:p], txs=st.txs[:p],
                  r=st.r[:p], s=st.s[:p], hexes=st.hexes[:p])


def _gaps(e: int, rate: float, rng) -> np.ndarray:
    """Poisson inter-arrival gaps at `rate` a second: the same set of e
    exponential quantiles for every seed, in an order drawn from it."""
    q = (np.arange(e) + 0.5) / e
    return rng.permutation(-np.log1p(-q) / rate)


def _others(creators, active, selector, alpha, rng):
    """Each event's other-parent creator among the active peers but its
    own creator: uniform, or by a power law over a seeded ranking."""
    a = len(active)
    if selector == "uniform":
        off = rng.integers(1, a, size=len(creators))
    elif selector == "powerlaw":
        w = 1.0 / np.arange(1, a) ** alpha
        off = 1 + rng.choice(a - 1, size=len(creators), p=w / w.sum())
    else:
        raise ValueError(f"unknown peer selector {selector!r}")
    pos = np.searchsorted(active, creators)
    return active[(pos + off) % a]


def generate(cfg: dict, events: int, seed: int, rate: Optional[float] = None,
             topology_seed: Optional[int] = None) -> Stream:
    """The signed stream of `events` events of configuration `cfg`
    (n, selector, alpha, txs_per_event, silent_validators). The silent
    validators are the last f key indices, n - f ... n - 1, so choosing
    them draws nothing from either generator: with f = 0 the stream is
    the one without the key. Keys, payloads, signatures and
    the order of the arrival gaps come from `seed`; who syncs with whom
    comes from `topology_seed` (default `seed`), so a mix that fixes it
    gives every seed the same gossip graph, its participants relabelled
    by their keys. `rate` (events a second) sets Poisson due times;
    without it events fall due 1 ms apart."""
    n = int(cfg["n"])
    live = n - 1 - int(cfg.get("silent_validators", 0))  # creators
    if not 2 <= live <= n - 1:
        raise ValueError(f"need 2 to {n - 1} creators, not {live}")
    rng = np.random.default_rng([seed, 0xB0B])
    topo = np.random.default_rng(
        [seed if topology_seed is None else topology_seed, 0x70B0])
    signer = Signer()
    scalars = [key_scalar(seed, i) for i in range(n)]
    pub_by_key = [signer.pub_bytes(d) for d in scalars]
    order = sorted(range(n), key=lambda i: "0x" + pub_by_key[i].hex().upper())
    pubs = [pub_by_key[i] for i in order]
    keys = [scalars[i] for i in order]
    participants = {"0x" + p.hex().upper(): pid for pid, p in enumerate(pubs)}
    silent = order.index(0)  # key 0 is the node under test
    pid_of_key = np.argsort(order)  # key index -> participant id
    if events < live:
        raise ValueError("need one event per active peer at least")

    # the graph over key indices 1..live, then relabelled to participant ids
    keys_active = np.arange(1, live + 1, dtype=np.int64)
    creators = np.concatenate(
        [keys_active, topo.choice(keys_active, size=events - live)])
    others = _others(creators, keys_active, cfg.get("selector", "uniform"),
                     float(cfg.get("alpha", 1.0)), topo)
    creators, others = pid_of_key[creators], pid_of_key[others]
    if rate:
        due = np.cumsum(_gaps(events, float(rate), rng))
    else:
        due = np.arange(events, dtype=np.float64) * 1e-3
    ts_ns = EPOCH_NS + np.round(due * 1e9).astype(np.int64)
    # distinct claimed timestamps in stream order
    ts_ns = ts_ns + np.arange(events, dtype=np.int64)

    creator = creators.astype(np.int32)
    index = np.zeros(events, np.int32)
    sp = np.full(events, -1, np.int32)
    op = np.full(events, -1, np.int32)
    heads = np.full(n, -1, np.int64)
    seqs = np.full(n, -1, np.int64)
    level = np.zeros(events, np.int64)
    for i in range(events):
        c = int(creator[i])
        sp[i] = heads[c]
        if i >= live:
            op[i] = heads[int(others[i])]
        seqs[c] += 1
        index[i] = seqs[c]
        heads[c] = i
        lv = 0
        if sp[i] >= 0:
            lv = level[sp[i]] + 1
        if op[i] >= 0:
            lv = max(lv, level[op[i]] + 1)
        level[i] = lv

    k_tx = int(cfg.get("txs_per_event", 5))
    txs = [[b"s%d e%d t%d" % (seed, i, k) for k in range(k_tx)]
           for i in range(events)]
    st = Stream(n=n, silent=silent, node_key=keys[silent],
                participants=participants, pubs=pubs, creator=creator,
                index=index, self_parent=sp, other_parent=op, ts_ns=ts_ns,
                due_s=due, txs=txs)
    _sign(st, keys, signer, level)
    _pack(st)
    return st


def body_string(st: Stream, i: int) -> str:
    """The Go-JSON encoding of event i's body, without the newline."""
    txs = st.txs[i]
    txpart = ('["' + '","'.join(base64.b64encode(t).decode("ascii") for t in txs)
              + '"]') if txs else "[]"
    sp, op = int(st.self_parent[i]), int(st.other_parent[i])
    return ('{"Transactions":' + txpart
            + ',"Parents":["' + (st.hexes[sp] if sp >= 0 else "")
            + '","' + (st.hexes[op] if op >= 0 else "")
            + '"],"Creator":"' + base64.b64encode(st.pubs[st.creator[i]]).decode("ascii")
            + '","Timestamp":"' + rfc3339nano(int(st.ts_ns[i]))
            + '","Index":' + str(int(st.index[i])) + "}")


def _sign(st: Stream, keys, signer: Signer, level) -> None:
    """Sign level by level: an event's body names its parents' hashes,
    and those name their signatures. (Threads do not help: the Python
    around each libcrypto call holds the interpreter lock.)"""
    e = st.e
    st.r, st.s, st.hexes = [0] * e, [0] * e, [""] * e
    by_level = np.argsort(level, kind="stable")
    bounds = np.searchsorted(level[by_level], np.arange(level.max() + 2))
    sha = hashlib.sha256
    for lv in range(len(bounds) - 1):
        ids = by_level[bounds[lv]:bounds[lv + 1]].tolist()
        bodies = [body_string(st, i) for i in ids]
        digests = [sha((b + "\n").encode()).digest() for b in bodies]
        sigs = signer.sign_batch([keys[st.creator[i]] for i in ids], digests)
        for i, body, (r, s) in zip(ids, bodies, sigs):
            st.r[i], st.s[i] = r, s
            ev = '{"Body":' + body + ',"R":' + str(r) + ',"S":' + str(s) + "}\n"
            st.hexes[i] = "0x" + sha(ev.encode()).hexdigest().upper()


def _pack(st: Stream) -> None:
    st.sigs = b"".join(r.to_bytes(32, "big") + s.to_bytes(32, "big")
                       for r, s in zip(st.r, st.s))
    counts = np.array([len(t) for t in st.txs], np.int32)
    flat = [t for ts in st.txs for t in ts]
    st.tx_lens = np.array([len(t) for t in flat], np.int32)
    st.tx_blob = b"".join(flat)
    st._tx_count = counts
    st._tx_first = np.concatenate(([0], np.cumsum(counts))).astype(np.int64)
    tx_end = np.concatenate(([0], np.cumsum(st.tx_lens))).astype(np.int64)
    st.tx_off = tx_end[st._tx_first]
