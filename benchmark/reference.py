"""The plain reference: hashgraph consensus over the generated stream, in
plain PyTorch, with no kernel, cache or engine of the system under test.

It follows the hashgraph consensus as the system documents it (Babble's
hashgraph.go: DivideRounds, DecideFame, DecideRoundReceived,
MedianTimestamp, the ConsensusSorter and block assembly), computed the
depth-sequential way: last ancestors and rounds one DAG level at a time,
first descendants from each creator's chain, fame by virtual voting
swept by depth, round received and the median timestamps over chunks of
events. The strongly-see count is a broadcast compare-sum.

`supermajority` is the BFT threshold 2n/3 + 1; the control passes a
simple majority instead (a broken guarantee, for the check that the
comparison can fail).
"""

from __future__ import annotations

import base64
from dataclasses import dataclass
from typing import Dict, List

import numpy as np
import torch

I32 = torch.int32
INT32_MAX = 2**31 - 1
FAME_UNDEFINED, FAME_TRUE, FAME_FALSE = 0, 1, 2
ZERO_TIME_NS = -62135596800 * 1_000_000_000  # Go's zero time


def supermajority(n: int) -> int:
    return 2 * n // 3 + 1


def _chunk(w: int, row_elems: int, budget: int) -> int:
    return max(min(budget // max(row_elems, 1), w), 1)


def _starts(total: int, width: int):
    """Chunk starts, the last clamped so every chunk is whole."""
    return [max(min(g * width, total - width), 0)
            for g in range(-(-total // width))]


def _budget(dev) -> int:
    return (1 << 26) if dev.type == "cpu" else (1 << 28)


def see_counts(x_tab, xs, f_tab, w_tab, wrow, sm, dev):
    """[M, W] bool: x_tab[xs[m]] strongly sees witness w_tab[wrow[m], w],
    i.e. #{i : x_tab[xs[m], i] >= f_tab[w, i]} >= sm, for valid slots."""
    m, w = xs.shape[0], w_tab.shape[1]
    out = torch.zeros((m, w), dtype=torch.bool, device=dev)
    if m == 0 or w == 0:
        return out
    mc = _chunk(m, w * x_tab.shape[1], _budget(dev))
    for m0 in _starts(m, mc):
        ids = w_tab[wrow[m0:m0 + mc]]
        valid = ids >= 0
        f = f_tab[torch.where(valid, ids, 0)]
        x = x_tab[xs[m0:m0 + mc]]
        out[m0:m0 + mc] = ((x[:, None, :] >= f).sum(-1, dtype=I32) >= sm) & valid
    return out


@dataclass
class Dag:
    n: int
    e: int
    self_parent: np.ndarray  # [E+1] int32, sentinel row E
    other_parent: np.ndarray
    creator: np.ndarray
    index: np.ndarray
    coin: np.ndarray  # [E+1] int8
    ts_rank: np.ndarray  # [E+1] int32
    ts_values: np.ndarray  # [U] int64
    levels: np.ndarray  # [L, W] int32, -1 pad
    chain: np.ndarray  # [n, K]
    chain_len: np.ndarray  # [n]
    chain_rank: np.ndarray  # [n, K]


def middle_bit(ehex: str) -> bool:
    data = bytes.fromhex(ehex[2:])
    return not (len(data) > 0 and data[len(data) // 2] == 0)


def build_dag(n, creator, index, self_parent, other_parent, ts_ns, hexes) -> Dag:
    e = len(creator)

    def pad(a, dtype):
        out = np.zeros(e + 1, dtype)
        out[:e] = a
        return out

    sp, op = pad(self_parent, np.int32), pad(other_parent, np.int32)
    sp[e] = op[e] = -1
    cr, ix = pad(creator, np.int32), pad(index, np.int32)
    coin = pad(np.array([1 if middle_bit(h) else 0 for h in hexes], np.int8), np.int8)
    ts_values, ranks = np.unique(np.asarray(ts_ns, np.int64), return_inverse=True)
    ts_rank = pad(ranks.astype(np.int32), np.int32)

    level = np.zeros(e, np.int64)
    for i in range(e):
        lv = -1
        if sp[i] >= 0:
            lv = level[sp[i]]
        if op[i] >= 0:
            lv = max(lv, level[op[i]])
        level[i] = lv + 1
    n_levels = int(level.max()) + 1 if e else 1
    by_level = np.argsort(level, kind="stable")
    bounds = np.searchsorted(level[by_level], np.arange(n_levels + 1))
    width = int(np.diff(bounds).max()) if e else 1
    levels = np.full((n_levels, width), -1, np.int32)
    for lv in range(n_levels):
        ids = by_level[bounds[lv]:bounds[lv + 1]]
        levels[lv, :len(ids)] = ids

    k_max = int(ix[:e].max()) + 1 if e else 1
    chain = np.full((n, k_max), -1, np.int32)
    chain[cr[:e], ix[:e]] = np.arange(e, dtype=np.int32)
    chain_len = (chain >= 0).sum(1).astype(np.int32)
    chain_rank = np.full((n, k_max), -1, np.int32)
    ok = chain >= 0
    chain_rank[ok] = ts_rank[chain[ok]]
    return Dag(n, e, sp, op, cr, ix, coin, ts_rank, ts_values, levels, chain,
               chain_len, chain_rank)


def last_ancestors(t, n, dev):
    """la[x, c]: index of x's latest ancestor by creator c (-1 none)."""
    sp, op, cr, ix, levels = (t[k] for k in ("sp", "op", "cr", "ix", "levels"))
    e = sp.shape[0] - 1
    la = torch.full((e + 1, n), -1, dtype=I32, device=dev)
    lanes = torch.arange(levels.shape[1], device=dev)
    for lv in range(levels.shape[0]):
        row = levels[lv]
        valid = row >= 0
        ids = torch.where(valid, row, e)
        s, o = sp[ids], op[ids]
        rows = torch.maximum(
            torch.where((s >= 0)[:, None], la[torch.where(s >= 0, s, e)], -1),
            torch.where((o >= 0)[:, None], la[torch.where(o >= 0, o, e)], -1))
        rows[lanes, cr[ids]] = ix[ids]
        la[ids] = torch.where(valid[:, None], rows, -1)
    return la[:e]


def first_descendants(la, t, n, dev):
    """fd[x, c]: index of the earliest event by creator c descending
    from x (INT32_MAX none). Along c's chain la[., creator(x)] never
    decreases, so fd is the count of chain positions still below
    index(x)."""
    chain, chain_len, cr, ix = t["chain"], t["chain_len"], t["cr"], t["ix"]
    e, k = la.shape[0], chain.shape[1]
    ok = chain >= 0
    chain_la = torch.where(ok[:, :, None], la[torch.where(ok, chain, 0)], INT32_MAX)
    fd = torch.empty((e, n), dtype=I32, device=dev)
    ec = _chunk(e, n * k, _budget(dev) // 4)
    for x0 in _starts(e, ec):
        sl = slice(x0, x0 + ec)
        # [n(c), K, chunk]: chain c's position p does not yet see x
        col = chain_la[:, :, cr[sl]]  # [n, K, chunk]
        below = (col < ix[sl][None, None, :]).sum(1, dtype=I32)  # [n, chunk]
        fd[sl] = torch.where(below < chain_len[:, None], below, INT32_MAX).T
    return fd


def rounds_and_witnesses(la, fd, t, n, sm, r, dev):
    """Rounds, witness flags and the witness table [r, n] (-1 empty)."""
    sp, op, cr, levels = t["sp"], t["op"], t["cr"], t["levels"]
    e = la.shape[0]
    la_p = torch.cat([la, torch.full((1, n), -1, dtype=I32, device=dev)], 0)
    rounds = torch.full((e + 1,), -1, dtype=I32, device=dev)
    wit = torch.zeros(e + 1, dtype=torch.bool, device=dev)
    wt = torch.full((r + 1, n), -1, dtype=I32, device=dev)
    for lv in range(levels.shape[0]):
        row = levels[lv]
        valid = row >= 0
        ids = torch.where(valid, row, e)
        s, o, c = sp[ids], op[ids], cr[ids]
        rs = torch.where(s >= 0, rounds[torch.where(s >= 0, s, e)], -1)
        ro = torch.where(o >= 0, rounds[torch.where(o >= 0, o, e)], -1)
        # a missing parent is the base root, of round -1
        use_o = rs < ro
        pr = torch.where(use_o, ro, rs)
        pr_root = torch.where(use_o, o < 0, s < 0)
        seen = see_counts(la_p, ids, fd, wt, torch.clamp(pr, 0, r - 1), sm, dev)
        r_new = pr + (pr_root | (seen.sum(1, dtype=I32) >= sm)).to(I32)
        w_new = ((s < 0) & (o < 0)) | (r_new > rs)
        rounds[ids] = torch.where(valid, r_new, -1)
        wit[ids] = valid & w_new
        upd = valid & w_new
        wt[torch.where(upd, torch.clamp(r_new, 0, r - 1), r), c] = torch.where(upd, ids, -1)
    return rounds[:e], wit[:e], wt[:r]


def decide_fame(wt, la, fd, t, n, sm, dev):
    """Virtual voting: famous[r, n] (0 undecided, 1 famous, 2 not)."""
    r = wt.shape[0]
    famous = torch.zeros((r, n), dtype=I32, device=dev)
    if r < 2:
        return famous
    ix, coin = t["ix"], t["coin"]
    valid = wt >= 0
    safe = torch.where(valid, wt, 0)
    idx_x = torch.where(valid, ix[safe], -1)
    # ss[q][y, x]: round q+1's witness y strongly sees round q's x
    ss = torch.stack([
        see_counts(la, safe[j], fd, wt,
                   torch.full((n,), j - 1, dtype=I32, device=dev), sm, dev)
        for j in range(1, r)])
    rx = torch.arange(r, device=dev)
    coin_w = coin[safe].to(torch.bool)
    vote = None
    for d in range(1, r):
        jr = torch.clamp(rx + d, max=r - 1)
        active = (valid[jr] & (rx + d < r)[:, None])[:, :, None] & valid[:, None, :]
        if d == 1:
            vote = (la[safe[jr]] >= idx_x[:, None, :]) & active
            continue
        ssd = ss[jr - 1]
        yays = torch.bmm(ssd.to(torch.float32), vote.to(torch.float32)).to(I32)
        nays = ssd.sum(-1, dtype=I32)[:, :, None] - yays
        v = yays >= nays
        strong = torch.maximum(yays, nays) >= sm
        if d % n:
            now = active & strong
            famous = torch.where(
                now.any(1) & (famous == FAME_UNDEFINED) & valid,
                torch.where((now & v).any(1), FAME_TRUE, FAME_FALSE).to(I32), famous)
            vote = v & active
        else:  # coin round
            vote = torch.where(strong, v, coin_w[jr][:, :, None]) & active
        if not bool(((rx + d + 1 < r)[:, None] & valid & (famous == FAME_UNDEFINED)).any()):
            break
    return famous


def round_received(rounds, wt, famous, la, fd, t, n, dev):
    """Round received (-1 undecided) and the consensus timestamp rank
    (-1 is Go's zero time) of every event."""
    r = wt.shape[0]
    cr, ix, chain_rank = t["cr"], t["ix"], t["chain_rank"]
    e = rounds.shape[0]
    k = chain_rank.shape[1]
    valid = wt >= 0
    safe = torch.where(valid, wt, 0)
    undec = ((famous == FAME_UNDEFINED) & valid).any(1)
    rows = torch.arange(r, device=dev)
    first_undec = int(torch.where(undec, rows, r).min())
    fmask = (famous == FAME_TRUE) & valid
    fcnt = fmask.sum(1, dtype=I32)
    idx_w = torch.where(valid, ix[safe], -1)
    cre, ixe = cr[:e], ix[:e]
    ec = _chunk(e, n, _budget(dev))
    starts = _starts(e, ec)
    rr = torch.full((e,), -1, dtype=I32, device=dev)
    for i in range(min(r, first_undec)):
        la_w = la[safe[i]]
        for x0 in starts:
            sl = slice(x0, x0 + ec)
            s_cnt = ((la_w[:, cre[sl]] >= ixe[sl]) & fmask[i, :, None]).sum(0, dtype=I32)
            ok = (s_cnt > fcnt[i] // 2) & (i > rounds[sl]) & (rr[sl] < 0)
            rr[sl] = torch.where(ok, i, rr[sl])
    cts = torch.empty(e, dtype=I32, device=dev)
    cols = torch.arange(n, device=dev)[None, :]
    for x0 in starts:
        sl = slice(x0, x0 + ec)
        rr_g = rr[sl]
        rs = torch.clamp(rr_g, 0, r - 1)
        w_sel = safe[rs]
        s_mask = (la[w_sel, cre[sl][:, None]] >= ixe[sl][:, None]) & fmask[rs]
        s_cnt = s_mask.sum(1, dtype=I32)
        fd_g = fd[sl]
        tsv = torch.where(fd_g <= idx_w[rs], chain_rank[cols, torch.clamp(fd_g, 0, k - 1)], -1)
        srt = torch.sort(torch.where(s_mask, tsv, INT32_MAX), dim=1).values
        med = torch.gather(srt, 1, (s_cnt // 2).to(torch.int64)[:, None])[:, 0]
        cts[sl] = torch.where(rr_g >= 0, med, -1)
    return rr, cts


@dataclass
class Result:
    rounds: np.ndarray  # [E]
    rr: np.ndarray  # [E], -1 undecided
    cts_ns: List[int]  # [E] consensus timestamp ns (Go's zero time below int64)
    order: np.ndarray  # event ids in consensus order
    blocks: List[bytes]  # Go-JSON of each block, in order
    block_rr: List[int]


def block_bytes(rr: int, txs) -> bytes:
    """The Go-JSON encoding of a block {RoundReceived, Transactions}."""
    if txs is None:
        part = "null"
    else:
        part = "[" + ",".join('"' + base64.b64encode(t).decode("ascii") + '"'
                              for t in txs) + "]"
    return ('{"RoundReceived":' + str(rr) + ',"Transactions":' + part + "}\n").encode()


def consensus(stream, device="cpu", sm=None) -> Result:
    """The consensus of every event of `stream` (stream.Stream), on
    `device`, at the threshold `sm` (default the supermajority)."""
    dev = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    n = stream.n
    sm = supermajority(n) if sm is None else sm
    dag = build_dag(n, stream.creator, stream.index, stream.self_parent,
                    stream.other_parent, stream.ts_ns, stream.hexes)
    t = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in (
        ("sp", dag.self_parent), ("op", dag.other_parent), ("cr", dag.creator),
        ("ix", dag.index), ("coin", dag.coin), ("levels", dag.levels),
        ("chain", dag.chain), ("chain_len", dag.chain_len),
        ("chain_rank", dag.chain_rank))}
    with torch.no_grad():
        la = last_ancestors(t, n, dev)
        fd = first_descendants(la, t, n, dev)
        r_bound = dag.levels.shape[0] + 2
        rounds, _, wt = rounds_and_witnesses(la, fd, t, n, sm, r_bound, dev)
        max_round = int(rounds.max()) if rounds.numel() else 0
        r = min(r_bound, max_round + 2)
        wt = wt[:r].contiguous()
        famous = decide_fame(wt, la, fd, t, n, sm, dev)
        rr, cts = round_received(rounds, wt, famous, la, fd, t, n, dev)
    rounds, rr, cts = (x.cpu().numpy() for x in (rounds, rr, cts))
    cts_ns = [int(dag.ts_values[c]) if c >= 0 else ZERO_TIME_NS for c in cts.tolist()]
    s_vals = [int(s) for s in stream.s]
    s_rank = {s: i for i, s in enumerate(sorted(set(s_vals)))}
    s_key = np.array([s_rank[s] for s in s_vals], np.int64)
    ids = np.nonzero(rr >= 0)[0]
    order = ids[np.lexsort((s_key[ids], cts[ids], rr[ids]))]
    blocks, block_rr = [], []
    by_rr: Dict[int, list] = {}
    for i in order:
        by_rr.setdefault(int(rr[i]), []).extend(stream.txs[int(i)])
    for rnd, txs in by_rr.items():
        blocks.append(block_bytes(rnd, txs))
        block_rr.append(rnd)
    return Result(rounds, rr, cts_ns, order, blocks, block_rr)
