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

I32 = torch.int32

# The JAX package's working-set bound for the per-round [chains,
# witnesses, coords] compare cube and its chain-chunk schedule. The
# port's probe builds no cube (one gathered launch, whose plain version
# chunks rows under the same bound); the schedule is kept so that it
# stays checked against the JAX package's.
_CUBE_ELEMS = 1 << 26


def _chain_chunks(n: int) -> int:
    cc = max(min(_CUBE_ELEMS // max(n * n, 1), n), 1)
    while n % cc:
        cc -= 1
    return n // cc


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
                    *, n, sm):
    """One frontier round: step(rho, wt_prev, fr_prev) ->
    (wt_row, fr_unclamped, fr_clamped, any_candidate).

    k2 is a vectorized binary search: because per-witness strongly-see
    indicators are monotone along a chain, "sm-th smallest over w of
    the per-w first position" equals "first position whose event
    strongly sees >= sm witnesses" — so ceil(log2 K)+1 probe steps,
    each one gathered TALLY launch (hopper_kernels.strongly_see_gathered)
    over the n chains' probe rows; the skip correction is one more.
    `fd` is dense [E, n] or a row view (kernels.witness_rows): a view's
    rows are gathered once per round for the probes (wt_prev's n rows)
    and once for the skip correction (the candidates')."""
    dev = la.device
    k_cap = chain_la.shape[1]
    probes = max(int(np.ceil(np.log2(max(k_cap, 2)))), 1) + 1
    lanes = torch.arange(n, device=dev)
    chain_rows = chain_la.view(n * k_cap, n)  # row c*K + k = chain_la[c, k]
    chain_row0 = torch.arange(n, dtype=I32, device=dev) * k_cap
    wrow0 = torch.zeros((n,), dtype=I32, device=dev)  # one witness row

    def step(rho, wt_prev, fr_prev):
        # k1: first chain position whose propagated root contribution
        # reaches rho = #{k : chain_rbase[c, k] < rho} (pads are
        # INT32_MAX and never count).
        k1 = (chain_rbase < rho).sum(1, dtype=I32)

        # k2: first position strongly seeing >= sm of wt_prev.
        f_tab, wt_tab = witness_rows(fd, wt_prev[None])  # [1, n] row, -1 none

        def sees_sm(mid):
            """ok[c] = chain_la[c, mid[c]] strongly sees >= sm valid
            witnesses. A position past the chain's end reads an
            INT32_MAX row, which would strongly see any witness; the
            callers' guard mid < hi <= chain_len drops those rows."""
            xs = chain_row0 + torch.clamp(mid, 0, k_cap - 1)
            tally = hopper_kernels.strongly_see_gathered(
                chain_rows, xs, f_tab, wt_tab, wrow0, sm, "tally")
            return tally >= sm

        # search in [0, chain_len]; hi == chain_len means no position
        lo = torch.zeros((n,), dtype=I32, device=dev)
        hi = chain_len
        for _ in range(probes):
            mid = (lo + hi) // 2
            ok = sees_sm(mid) & (mid < hi)
            hi = torch.where(ok, mid, hi)
            lo = torch.where(ok | (lo >= hi), lo, mid + 1)
        k2 = torch.where(hi < chain_len, hi, INT32_MAX)

        fr = torch.maximum(torch.minimum(k1, k2), fr_prev)
        cand_valid = fr < chain_len
        fr_c = torch.where(cand_valid, fr, k_cap)
        cand = torch.where(
            cand_valid, chain[lanes, torch.clamp(fr, 0, k_cap - 1)], -1)

        # Skip correction: candidate's true round exceeds rho? The
        # invalid candidates (-1) are masked as witnesses; as rows their
        # tally is dropped by wt_row's cand_valid.
        safe = torch.where(cand_valid, cand, 0)
        f_tab, cand_tab = witness_rows(fd, cand[None])
        tally = hopper_kernels.strongly_see_gathered(
            la, safe, f_tab, cand_tab, wrow0, sm, "tally")
        rb_c = torch.where(cand_valid, rbase[safe], -1)
        skip = (rb_c >= rho + 1) | (tally >= sm)
        wt_row = torch.where(cand_valid & ~skip, cand, -1)
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
                        rho_min, *, n, sm, rcap):
    """Run rounds rho_min+t for t in [t0, rcap) until no chain has a
    candidate, writing rows t of the [rcap, n] tables in place (rows
    below t0 are the frozen warm-start prefix). Returns (wt_tab, fr_tab,
    t_end); t_end == rcap with activity still pending means the caller
    must re-run with a larger bucket.

    The JAX package runs this as a device while-loop; here the host
    reads each round's any-candidate flag, one synchronisation per
    round swept (t_end - t0 of them). t0 and rho_min are host ints.
    `fd` is dense or a row view (see make_round_step)."""
    step = make_round_step(chain_la, chain_rbase, chain_len, la, fd, rbase,
                           chain, n=n, sm=sm)
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
                     *, n: int, sm: int, rc: int = 64,
                     ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Host loop: sweep rounds in chunks of rc until the frontier
    passes every chain's end (one host read per chunk). root_round is
    host numpy. Returns (wt[R, n] absolute-round-indexed,
    frontier[R', n], rho_min), the tables on la's device."""
    dev = la.device
    chain_la, chain_rbase = build_chain_tables(la, rbase, chain, n=n)
    rho_min = int(np.min(root_round)) + 1

    wt_prev = torch.full((n,), -1, dtype=I32, device=dev)
    fr_prev = torch.zeros((n,), dtype=I32, device=dev)
    wt_rows, fr_rows = [], []
    rho0 = rho_min
    while True:
        wt_o, fr_o, act, wt_prev, fr_prev = frontier_chunk(
            chain_la, chain_rbase, chain_len, la, fd, rbase, chain,
            wt_prev, fr_prev, rho0, n=n, sm=sm, rc=rc)
        wt_rows.append(wt_o)
        fr_rows.append(fr_o)
        if not bool(act[-1]):
            break
        rho0 += rc
    wt_rel = torch.cat(wt_rows, 0)
    fr_rel = torch.cat(fr_rows, 0)
    active = (fr_rel < chain_len[None, :]).any(1).cpu().numpy()
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
