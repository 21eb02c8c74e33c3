"""Round assignment as a frontier sweep — sequential in the number of
consensus rounds, not DAG depth (counterpart of
babble_tpu/ops/frontier.py).

Replaces kernels.compute_rounds' per-level wavefront (2,709 sequential
levels at n=64/e=50k) with one step per round (~72 at the same size):
round numbers are determined by witness frontiers.

Theory (mirrors reference hashgraph.go:211-339, DivideRounds 616-646):
round(x) = max over ancestors-incl-self y of local(y), where
local(y) = root_round[creator(y)]+1 when y has a missing parent, and
local(y) = q+1 when y strongly sees >= sm witnesses of round q. Because
lastAncestors are monotone along descent, strongly-seeing is inherited
by descendants:

  round(x) >= rho  <=>  rbase(x) >= rho  OR  x strongly sees >= sm
                        witnesses of round rho-1

with rbase the ancestor-max of the root contribution (ops/closure.py).
Along each creator chain both conditions are monotone in chain
position, so the first position with round >= rho is a compare-and-count
for rbase and a vectorized binary search for strongly-see. A skip
correction then removes candidates whose round exceeds rho: a candidate
is round rho iff it neither carries rbase >= rho+1 nor strongly sees
>= sm of the candidate row itself.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from . import hopper_kernels
from .kernels import INT32_MAX, witness_rows
from .mesh import count_below, take_chains

I32 = torch.int32

# The JAX package's working-set bound for the per-round [chains,
# witnesses, coords] compare cube and its chain-chunk schedule. The
# port's probe builds no cube (one gathered launch, whose plain version
# chunks rows under the same bound); the schedule is kept so that it
# stays checked against the JAX package's.
_CUBE_ELEMS = 1 << 26
# The k2 search probes up to _PROBE_WAYS_MAX positions of every chain
# in one TALLY launch while a launch's compares (rows x witnesses x
# coordinates, n^3 per position) stay within _CUBE_ELEMS.
_PROBE_WAYS_MAX = 4095


def _chain_chunks(n: int) -> int:
    cc = max(min(_CUBE_ELEMS // max(n * n, 1), n), 1)
    while n % cc:
        cc -= 1
    return n // cc


def probe_ways(n: int) -> int:
    """Positions of each chain that one k2 probe launch may test: 4,095
    at n <= 16, 256 at n = 64, down to 1 (a bisection) where n^3
    compares per position reach _CUBE_ELEMS (n >= 512)."""
    return max(1, min(_PROBE_WAYS_MAX, _CUBE_ELEMS // max(n ** 3, 1)))


def search_steps(width: int, ways: int) -> int:
    """Probe launches that settle a search over `width` positions when
    each tests `ways` of them: a probe leaves at most floor(w /
    (ways+1)) of w, so one settles any width up to `ways`."""
    steps = 0
    while width > 0:
        width //= ways + 1
        steps += 1
    return steps


def first_true(probe, hi, steps: int, ways: int):
    """Per chain c, the first position p < hi[c] where `probe` holds,
    or hi[c] where it holds nowhere, for a predicate monotone along
    each chain. probe(pos) takes int64 [chains, ways] positions, each
    below its chain's hi, and returns bool [chains, ways]. Each of the
    `steps` probes tests `ways` positions spread evenly over the open
    interval and keeps the gap holding the answer; search_steps(max
    hi, ways) probes settle every chain. Returns int64 [chains]."""
    dev = hi.device
    frac = torch.arange(1, ways + 1, dtype=torch.int64, device=dev)[None, :]
    lo = torch.zeros((hi.shape[0], 1), dtype=torch.int64, device=dev)
    hi = hi.to(torch.int64)[:, None]  # the answer lies in [lo, hi]
    for s in range(steps):
        pos = lo + (hi - lo) * frac // (ways + 1)  # in [lo, hi)
        open_ = pos < hi  # an empty interval (lo == hi) probes nothing
        ok = probe(pos) & open_
        if s + 1 < steps:  # the last probe settles hi; lo is not read
            lo = torch.where(open_ & ~ok, pos + 1, lo).amax(1, keepdim=True)
        hi = torch.where(ok, pos, hi).amin(1, keepdim=True)
    return hi[:, 0]


def build_chain_tables(la, rbase, chain, *, n):
    """chain_la[c, k, i] = la[chain[c, k], i] (INT32_MAX beyond the
    chain, so searches land past real entries); chain_rbase[c, k]
    likewise. chain: [n, K] event ids, -1 pad."""
    valid = chain >= 0
    safe = torch.where(valid, chain, 0)
    chain_la = torch.where(valid[:, :, None], la[safe], INT32_MAX)
    chain_rbase = torch.where(valid, rbase[safe], INT32_MAX)
    return chain_la, chain_rbase


def make_round_step(chain_la, chain_rbase, chain_len, la, fd, rbase, chain,
                    *, n, sm, k_bound=None):
    """One frontier round: step(rho, wt_prev, fr_prev) ->
    (wt_row, fr_unclamped, fr_clamped, any_candidate).

    k2 is a vectorized search: because per-witness strongly-see
    indicators are monotone along a chain, "sm-th smallest over w of
    the per-w first position" equals "first position whose event
    strongly sees >= sm witnesses", the one answer any exact search
    finds. Each probe step tests probe_ways(n) positions per chain,
    evenly spread over its open interval, in one gathered TALLY launch
    (hopper_kernels.strongly_see_gathered) and keeps the gap holding
    the first true one (first_true): search_steps(k_bound, ways)
    launches, one for chains of up to 4,095 positions at n <= 16 and
    two for up to 65,536 at n = 64, where a bisection takes 13 and 17.
    `k_bound` is a host bound on every chain_len (default: the table's
    K). Every launch and torch call is one more release and re-take of
    the interpreter lock, which a busy node pays dearly for (ROADMAP
    C1). The skip correction is one more launch. `fd` is dense [E, n]
    or a row view (kernels.witness_rows): a view's rows are gathered
    once per round, for the skip correction (the candidates'), and the
    next round's probe reuses them.

    The incremental engine's mesh (ops/mesh.py) gives the chain tables
    (chain_la, chain_rbase, chain) as lists of chain shards and la as a
    mesh.ColumnShards: then each probe is one TALLY launch per chain
    shard, on the shard's own chain_la rows against the replicated
    witness rows, the tallies concatenated in chain order, and the
    skip correction's launch reads its candidates' whole-width la
    rows."""
    dev = la.device
    shards = chain_la if isinstance(chain_la, (list, tuple)) else None
    k_cap = (shards[0] if shards else chain_la).shape[1]
    width = k_cap if k_bound is None else min(int(k_bound), k_cap)
    ways = max(1, min(probe_ways(n), width))
    steps = search_steps(width, ways)
    lanes = torch.arange(n, device=dev)
    if shards is None:
        chain_rows = chain_la.view(n * k_cap, n)  # row c*K + k = chain_la[c, k]
        chain_row0 = (torch.arange(n, dtype=torch.int64, device=dev) * k_cap)[:, None]
    else:
        # per shard: its chain_la rows, its chains' first row ids and
        # one witness row a lane
        w = shards[0].shape[0]
        probes = [(part.view(w * k_cap, n),
                   (torch.arange(w, dtype=torch.int64, device=part.device) * k_cap)[:, None],
                   torch.zeros((w * ways,), dtype=I32, device=part.device))
                  for part in shards]
        x_skip = lanes.to(I32)  # the skip correction's rows, gathered in order
    wrow_probe = torch.zeros((n * ways,), dtype=I32, device=dev)  # one witness row
    wrow0 = wrow_probe[:n]
    # A row view's witness rows of the last round's candidates: the next
    # round's witnesses are some of them (wt_row), so its probe reuses
    # the gathered rows and only masks the slots that were skipped.
    last = {}

    def step(rho, wt_prev, fr_prev):
        # k1: first chain position whose propagated root contribution
        # reaches rho = #{k : chain_rbase[c, k] < rho} (pads are
        # INT32_MAX and never count).
        if shards is None:
            k1 = (chain_rbase < rho).sum(1, dtype=I32)
        else:
            k1 = count_below(chain_rbase, rho, dev)

        # k2: first position strongly seeing >= sm of wt_prev.
        if last.get("wt_row") is wt_prev:
            f_tab = last["f_tab"]
            wt_tab = torch.where(wt_prev[None] >= 0, last["cand_tab"], -1)
        else:
            f_tab, wt_tab = witness_rows(fd, wt_prev[None])  # [1, n] row, -1 none
        if shards is not None:  # the witness rows on each shard's device
            f_w = [(f_tab.to(rows.device), wt_tab.to(rows.device)) for rows, _, _ in probes]

        def sees_sm(pos):
            """ok[c, j] = chain_la[c, pos[c, j]] strongly sees >= sm
            valid witnesses. A position past the chain's end reads an
            INT32_MAX row, which would strongly see any witness;
            first_true probes below hi <= chain_len only."""
            if shards is None:
                xs = (chain_row0 + torch.clamp(pos, 0, k_cap - 1)).to(I32).view(-1)
                tally = hopper_kernels.strongly_see_gathered(
                    chain_rows, xs, f_tab, wt_tab, wrow_probe, sm, "tally")
            else:
                tallies = []
                for p, ((rows, row0, wrow), (f_p, w_p)) in enumerate(zip(probes, f_w)):
                    pos_p = torch.clamp(pos[p * w:(p + 1) * w].to(rows.device), 0, k_cap - 1)
                    xs = (row0 + pos_p).to(I32).view(-1)
                    tallies.append(hopper_kernels.strongly_see_gathered(
                        rows, xs, f_p, w_p, wrow, sm, "tally").to(dev))
                tally = torch.cat(tallies)
            return tally.view(n, ways) >= sm

        # search in [0, chain_len]; chain_len means no position
        hi = first_true(sees_sm, chain_len, steps, ways).to(I32)
        k2 = torch.where(hi < chain_len, hi, INT32_MAX)

        fr = torch.maximum(torch.minimum(k1, k2), fr_prev)
        cand_valid = fr < chain_len
        fr_c = torch.where(cand_valid, fr, k_cap)
        fr_k = torch.clamp(fr, 0, k_cap - 1)
        cand = torch.where(
            cand_valid,
            chain[lanes, fr_k] if shards is None else take_chains(chain, fr_k), -1)

        # Skip correction: candidate's true round exceeds rho? The
        # invalid candidates (-1) are masked as witnesses; as rows their
        # tally is dropped by wt_row's cand_valid.
        safe = torch.where(cand_valid, cand, 0)
        f_tab, cand_tab = witness_rows(fd, cand[None])
        if shards is None:
            x_tab, xs = la, safe
        else:
            x_tab, xs = la[safe], x_skip
        tally = hopper_kernels.strongly_see_gathered(
            x_tab, xs, f_tab, cand_tab, wrow0, sm, "tally")
        rb_c = torch.where(cand_valid, rbase[safe], -1)
        skip = (rb_c >= rho + 1) | (tally >= sm)
        wt_row = torch.where(cand_valid & ~skip, cand, -1)
        if not isinstance(fd, torch.Tensor):
            last.update(wt_row=wt_row, f_tab=f_tab, cand_tab=cand_tab)
        return wt_row, fr, fr_c, cand_valid.any()

    return step


def frontier_chunk(chain_la, chain_rbase, chain_len, la, fd, rbase, chain,
                   wt_prev, fr_prev, rho0, *, n, sm, rc):
    """Advance the witness frontier by `rc` rounds starting at rho0,
    with no host synchronisation inside.

    wt_prev: [n] witness event ids of round rho0-1 (-1 none);
    fr_prev: [n] first chain position with round >= rho0-1.
    Returns (wt_out[rc, n], fr_out[rc, n], active[rc], wt_last, fr_last).
    """
    dev = la.device
    step = make_round_step(chain_la, chain_rbase, chain_len, la, fd, rbase,
                           chain, n=n, sm=sm)
    wt_out = torch.full((rc, n), -1, dtype=I32, device=dev)
    fr_out = torch.full((rc, n), chain_la.shape[1], dtype=I32, device=dev)
    act_out = torch.zeros((rc,), dtype=torch.bool, device=dev)
    for t in range(rc):
        wt_row, fr, fr_c, any_cand = step(rho0 + t, wt_prev, fr_prev)
        wt_out[t] = wt_row
        fr_out[t] = fr_c
        act_out[t] = any_cand
        wt_prev, fr_prev = wt_row, fr
    return wt_out, fr_out, act_out, wt_prev, fr_prev


def frontier_sweep_impl(chain_la, chain_rbase, chain_len, la, fd, rbase,
                        chain, wt_tab, fr_tab, wt_prev, fr_prev, t0,
                        rho_min, *, n, sm, rcap, k_bound=None):
    """Run rounds rho_min+t for t in [t0, rcap) until no chain has a
    candidate, writing rows t of the [rcap, n] tables in place (rows
    below t0 are the frozen warm-start prefix). Returns (wt_tab, fr_tab,
    t_end); t_end == rcap with activity still pending means the caller
    must re-run with a larger bucket.

    The JAX package runs this as a device while-loop; here the host
    reads each round's any-candidate flag, one synchronisation per
    round swept (t_end - t0 of them). t0 and rho_min are host ints.
    `fd` is dense or a row view and `k_bound` a host bound on the chain
    lengths (see make_round_step)."""
    step = make_round_step(chain_la, chain_rbase, chain_len, la, fd, rbase,
                           chain, n=n, sm=sm, k_bound=k_bound)
    t = t0
    while t < rcap:
        wt_row, fr, fr_c, any_cand = step(rho_min + t, wt_prev, fr_prev)
        wt_tab[t] = wt_row
        fr_tab[t] = fr_c
        wt_prev, fr_prev = wt_row, fr
        t += 1
        if not bool(any_cand):
            break
    return wt_tab, fr_tab, t


# The JAX package's jitted name for the same sweep; eager here.
frontier_sweep = frontier_sweep_impl


def rounds_from_frontier(frontier, creator, index, self_parent, rho_min, *, n):
    """Per-event rounds + witness flags from the frontier table.

    round(chain[c, k]) = rho_min - 1 + #{rows with frontier[., c] <= k};
    witness(x) = sits-on-root or round > round(self-parent)
    (reference hashgraph.go:265-282). creator/index/self_parent: [E]."""
    rows = (frontier[:, creator] <= index[None, :]).sum(0, dtype=I32)  # [E]
    rounds = rho_min - 1 + rows
    sp_safe = torch.where(self_parent >= 0, self_parent, 0)
    wit = (self_parent < 0) | (rounds > rounds[sp_safe])
    return rounds, wit


def compute_frontier(la, rbase, fd, chain, chain_len, root_round,
                     *, n: int, sm: int, rc: int = 64, view_chain_len=None,
                     ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Host loop: sweep rounds in chunks of rc until the frontier
    passes every chain's end (one host read per chunk). root_round is
    host numpy. `view_chain_len` [n] restricts to an ancestry-closed
    prefix view (per-peer simulation): coordinates from the full DAG
    stay exact for any closed view, so only the chain lengths change.
    Returns (wt[R, n] absolute-round-indexed, frontier[R', n],
    rho_min), the tables on la's device."""
    dev = la.device
    chain_len_eff = chain_len if view_chain_len is None else torch.as_tensor(
        view_chain_len, dtype=I32).to(dev)
    chain_la, chain_rbase = build_chain_tables(la, rbase, chain, n=n)
    rho_min = int(np.min(root_round)) + 1

    wt_prev = torch.full((n,), -1, dtype=I32, device=dev)
    fr_prev = torch.zeros((n,), dtype=I32, device=dev)
    wt_rows, fr_rows = [], []
    rho0 = rho_min
    while True:
        wt_o, fr_o, act, wt_prev, fr_prev = frontier_chunk(
            chain_la, chain_rbase, chain_len_eff, la, fd, rbase, chain,
            wt_prev, fr_prev, rho0, n=n, sm=sm, rc=rc)
        wt_rows.append(wt_o)
        fr_rows.append(fr_o)
        if not bool(act[-1]):
            break
        rho0 += rc
    wt_rel = torch.cat(wt_rows, 0)
    fr_rel = torch.cat(fr_rows, 0)
    active = (fr_rel < chain_len_eff[None, :]).any(1).cpu().numpy()
    # highest round with any event = last active row
    n_rounds = int(np.nonzero(active)[0][-1]) + 1 if active.any() else 0
    wt_rel = wt_rel[:n_rounds]
    fr_rel = fr_rel[:n_rounds]

    # Absolute-round-indexed witness table (rows 0..rho_min-1 empty),
    # the contract of fame / round-received.
    r_abs = rho_min + n_rounds
    wt = torch.full((max(r_abs, 1), n), -1, dtype=I32, device=dev)
    if n_rounds:
        wt[rho_min:r_abs] = wt_rel
    return wt, fr_rel, rho_min
