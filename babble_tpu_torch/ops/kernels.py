"""The consensus kernels in PyTorch (counterpart of babble_tpu/ops/kernels.py).

All kernels are functions over int32/int8 SoA tensors on one device
(see dag.DagTensors). Shapes: E = events (+1 sentinel pad row where
noted), N = participants, R = static round bound, L x W = wavefront
levels, K = longest creator chain.

Semantics mirror reference hashgraph/hashgraph.go exactly (anchors on
each kernel), and every result is bit-identical to the JAX package's.
The reference's `fori_loop`s become Python loops that never read a
device value on the host, so a CUDA run enqueues each loop without a
synchronisation. `lax.dynamic_slice` clamps an out-of-range start;
torch slicing truncates, so the chunk loops clamp their starts
explicitly. Every index guard (`where`/`clamp`) of the reference stays,
because torch raises on an out-of-range index where JAX clamps.
"""

from __future__ import annotations

import torch

INT32_MAX = 2**31 - 1
# Device stand-in for Go's zero time (reference hashgraph.go:860-868);
# smaller than every real timestamp rank (>= 0).
ZERO_TS_RANK = -1

FAME_UNDEFINED = 0
FAME_TRUE = 1
FAME_FALSE = 2

I32 = torch.int32


def compute_last_ancestors(self_parent, other_parent, creator, index, levels,
                           *, n):
    """last_anc[x, i] = index of x's latest ancestor created by i, -1 if
    none — the coordinate init of reference hashgraph.go:448-499
    (elementwise max of parent rows, own slot = own index), swept one
    DAG depth level at a time.

    Per-event inputs are [E+1] with a sentinel pad row at id E; returns
    la[E, n]. Pad lanes all write the all -1 row into the sentinel, so
    the duplicate indices of the row scatter agree on the value."""
    e = self_parent.shape[0] - 1
    dev = self_parent.device
    la = torch.full((e + 1, n), -1, dtype=I32, device=dev)
    valid_all = levels >= 0
    sids_all = torch.where(valid_all, levels, e)  # pad lanes hit the sentinel
    sp_all = self_parent[sids_all]
    op_all = other_parent[sids_all]
    cr_all = creator[sids_all]
    idx_all = index[sids_all]
    lanes = torch.arange(levels.shape[1], device=dev)
    for l in range(levels.shape[0]):
        valid, sids, sp, op = valid_all[l], sids_all[l], sp_all[l], op_all[l]
        sp_rows = torch.where((sp >= 0)[:, None], la[torch.where(sp >= 0, sp, e)], -1)
        op_rows = torch.where((op >= 0)[:, None], la[torch.where(op >= 0, op, e)], -1)
        rows = torch.maximum(sp_rows, op_rows)
        rows[lanes, cr_all[l]] = idx_all[l]
        la[sids] = torch.where(valid[:, None], rows, -1)
    return la[:e]


def chunk_width(w: int, row_elems: int, budget: int = 1 << 26) -> int:
    """Width of a processing chunk such that chunk*row_elems stays
    under `budget` elements. Callers iterate ceil(w/wc) chunks with
    CLAMPED starts (the final chunk re-reads/rewrites a few overlapping
    rows, which is idempotent) — no divisibility demanded, so a prime
    width cannot collapse the chunk to 1."""
    return max(min(budget // max(row_elems, 1), w), 1)


def _clamped(g: int, width: int, total: int) -> int:
    """Start of chunk g as `lax.dynamic_slice` places it: clamped so
    the chunk [start, start + width) stays inside [0, total)."""
    return max(min(g * width, total - width), 0)


def _bcast_budget(device: torch.device) -> int:
    """Chunk budget for broadcast-COMPARE intermediates: the CPU
    materializes them in host memory (tight budget), the card has room
    for fatter chunks (loose budget, fewer sequential launches). Only
    for broadcasts — gather-bounded chunks keep the default tight
    budget."""
    return (1 << 26) if device.type == "cpu" else (1 << 28)


def strongly_see_counts_chunked(la_rows, fd_p):
    """ss_cnt[y, x] = #{k : la_rows[y, k] >= fd_p[x, k]} — the pairwise
    strongly-see tally as one broadcast compare-sum, chunked over the
    voter axis so the [Y, X, n] broadcast stays bounded. int32 result.
    This is the plain version of the CUDA kernel
    (hopper_kernels.strongly_see_counts)."""
    y_n, n = la_rows.shape
    x_n = fd_p.shape[0]
    acc = torch.zeros((y_n, x_n), dtype=I32, device=la_rows.device)
    if y_n == 0:
        return acc
    yc = chunk_width(y_n, x_n * n, _bcast_budget(la_rows.device))
    for g in range(-(-y_n // yc)):
        y0 = _clamped(g, yc, y_n)
        la_g = la_rows[y0:y0 + yc]
        acc[y0:y0 + yc] = (la_g[:, None, :] >= fd_p[None, :, :]).sum(-1, dtype=I32)
    return acc


def strongly_see_gathered_ref(x_tab, xs, f_tab, w_tab, wrow, sm, mode):
    """c[m, w] = #{i : x_tab[xs[m], i] >= f_tab[w_tab[wrow[m], w], i]}
    over the witness slots with w_tab[wrow[m], w] >= 0, thresholded at
    sm: mode "matrix" gives uint8 [M, W] = (c >= sm) & witness valid,
    mode "tally" int32 [M] = #{valid w : c >= sm}. One gather and
    broadcast compare-sum, chunked over the rows so the [M, W, n]
    intermediates stay bounded. This is the plain version of the CUDA
    kernel (hopper_kernels.strongly_see_gathered)."""
    m, w = xs.shape[0], w_tab.shape[1]
    dev = x_tab.device
    if mode == "matrix":
        out = torch.zeros((m, w), dtype=torch.uint8, device=dev)
    else:
        out = torch.zeros((m,), dtype=I32, device=dev)
    if m == 0 or w == 0:
        return out
    mc = chunk_width(m, w * x_tab.shape[1], _bcast_budget(dev))
    for g in range(-(-m // mc)):
        m0 = _clamped(g, mc, m)
        ids = w_tab[wrow[m0:m0 + mc]]  # [mc, W] witness ids
        valid = ids >= 0
        f = f_tab[torch.where(valid, ids, 0)]  # [mc, W, n]
        x = x_tab[xs[m0:m0 + mc]]  # [mc, n]
        hit = ((x[:, None, :] >= f).sum(-1, dtype=I32) >= sm) & valid
        out[m0:m0 + mc] = hit if mode == "matrix" else hit.sum(-1, dtype=I32)
    return out


def witness_rows(fd, wt):
    """(f_tab, w_tab) for strongly_see_gathered's witness side, from the
    first descendants `fd` and a table `wt` of witness ids (-1 none).

    A dense fd [E, n] is the table itself and wt names its rows. A row
    view (any object with fd[ids] -> [*ids.shape, n] rows, such as the
    incremental engine's view of its rank cube) never materializes
    [E, n]: the rows of the witnesses in wt are gathered once into a
    compact table and wt is renumbered to it, -1 kept. The kernel
    computes the same counts from either form."""
    if isinstance(fd, torch.Tensor):
        return fd, wt
    valid = wt >= 0
    f_tab = fd[torch.where(valid, wt, 0).reshape(-1)].contiguous()
    slots = torch.arange(wt.numel(), dtype=I32, device=wt.device).view(wt.shape)
    return f_tab, torch.where(valid, slots, -1)


def first_descendant_cube(la, chain, chain_len, *, n):
    """pos2k[c, i, t] = first position k on creator c's chain whose
    event descends from chain i's position t (INT32_MAX when no such
    position) — the closed form of the reference's first-descendant
    chain walk (hashgraph.go:490-530): within chain c,
    last_anc[chain[c, k], i] is monotone nondecreasing in k, so the
    answer is the count ranks[c, i, t] = #{k : chain_la[c, k, i] < t},
    chunked over targets to bound the [n, K, n, tc] compare cube."""
    k = chain.shape[1]
    chain_valid = chain >= 0
    # [n, K, n]; pad slots are INT32_MAX so they never count.
    chain_la = torch.where(
        chain_valid[:, :, None], la[torch.where(chain_valid, chain, 0)], INT32_MAX)
    tc = min(max((1 << 27) // max(n * n * k, 1), 1), k)
    nchunks = (k + tc - 1) // tc
    ranks = torch.zeros((n, n, nchunks * tc), dtype=I32, device=la.device)
    for g in range(nchunks):
        t0 = g * tc
        ts = torch.arange(t0, t0 + tc, dtype=I32, device=la.device)
        ranks[:, :, t0:t0 + tc] = (
            chain_la[:, :, :, None] < ts[None, None, None, :]).sum(1, dtype=I32)
    ranks = ranks[:, :, :k]
    return torch.where(ranks < chain_len[:, None, None], ranks, INT32_MAX)


def fd_from_cube(cube, creator, index, *, n):
    """fd[a, c] from the pos2k cube: event a = chain[creator_a,
    index_a], so fd[a, c] = cube[c, creator_a, index_a] — a gather.
    Pad rows (index < 0) stay at INT32_MAX."""
    e = creator.shape[0] - 1
    k = cube.shape[2]
    ca = creator[:e]
    ia = torch.clamp(index[:e], 0, k - 1)
    fd = cube[:, ca, ia].T.contiguous()  # [E, n]
    return torch.where((index[:e] >= 0)[:, None], fd, INT32_MAX)


def compute_first_descendants(la, creator, index, chain, chain_len, *, n):
    """first_desc[a, c] = index of the earliest event by creator c that
    descends from a, INT32_MAX if none — reference
    hashgraph.go:490-530. la: [E, n]; creator/index: [E+1] padded;
    chain: [n, K]; returns fd[E, n]."""
    cube = first_descendant_cube(la, chain, chain_len, n=n)
    return fd_from_cube(cube, creator, index, n=n)


def compute_rounds(self_parent, other_parent, creator, index, la, fd, levels,
                   root_round, valid_mask=None, *, n, sm, r):
    """Round numbers, witness flags, and the witness table — reference
    DivideRounds / Round / RoundInc / Witness (hashgraph.go:211-339,
    616-646), swept per DAG level.

    stronglySee(x, w) (hashgraph.go:179-198) is evaluated only against
    the <= n candidate witnesses of x's parent round (each creator
    contributes at most one witness per round): one gathered TALLY
    launch per level (hopper_kernels.strongly_see_gathered), each row
    reading its parent round's row of the working witness table.

    `valid_mask` [E+1] bool restricts consensus to an ancestry-closed
    subgraph (a simulated peer's view, ops/sim.py): coordinates from the
    full DAG stay exact for any closed view, so the witness-table write
    is the only place the mask enters; rounds and witness flags are
    still computed for every event. A [V, E+1] mask runs V views at
    once, with results [V, E], [V, E] and [V, r, n]: the views' working
    tables are stacked into one [V*(r+1), n] table and each level is
    still one launch, its rows view-major (row v*W + lane reads table
    row v*(r+1) + parent round), so a 64-row tile names as few distinct
    witness rows as a single view's.

    Returns (rounds[E], witness[E] bool, wt[r, n] event ids, -1 empty).
    Row r of each working table is the scatter dump: every lane that
    does not write a witness writes -1 there, so the duplicate indices
    agree on the value."""
    # imported here: hopper_kernels imports this module's plain versions
    from .hopper_kernels import strongly_see_gathered

    e = la.shape[0]
    dev = la.device
    views = valid_mask is not None and valid_mask.dim() == 2
    masks = None if valid_mask is None else valid_mask.reshape(-1, e + 1)  # [V, E+1]
    v_n = 1 if masks is None else masks.shape[0]
    la_p = torch.cat([la, torch.full((1, n), -1, dtype=I32, device=dev)], 0)
    rounds = torch.full((v_n, e + 1), -1, dtype=I32, device=dev)
    wit = torch.zeros((v_n, e + 1), dtype=torch.bool, device=dev)
    wt = torch.full((v_n, r + 1, n), -1, dtype=I32, device=dev)
    w_tab = wt.view(v_n * (r + 1), n)
    view = torch.arange(v_n, dtype=I32, device=dev)[:, None]  # [V, 1]
    valid_all = levels >= 0
    sids_all = torch.where(valid_all, levels, e)
    sp_all = self_parent[sids_all]
    op_all = other_parent[sids_all]
    cr_all = creator[sids_all]
    xs_all = sids_all.repeat(1, v_n)  # [L, V*W]: each level's ids once per view

    for l in range(levels.shape[0]):
        valid, sids = valid_all[l], sids_all[l]
        sp, op, cr = sp_all[l], op_all[l], cr_all[l]
        rnd_sp_raw = torch.where(sp >= 0, rounds[:, torch.where(sp >= 0, sp, e)], -1)
        # parentRound with Root fallback (hashgraph.go:211-262): a
        # missing parent means the base Root (X = Y = ""), whose round
        # comes from root_round.
        sp_round = torch.where(sp >= 0, rnd_sp_raw, root_round[cr])
        op_round = torch.where(
            op >= 0, rounds[:, torch.where(op >= 0, op, e)], root_round[cr])
        use_op = sp_round < op_round
        pr = torch.where(use_op, op_round, sp_round)  # [V, W]
        pr_root = torch.where(use_op, op < 0, sp < 0)
        # roundInc: count parent-round witnesses strongly seen.
        wrow = view * (r + 1) + torch.clamp(pr, 0, r - 1)
        ss_cnt = strongly_see_gathered(
            la_p, xs_all[l], fd, w_tab, wrow.view(-1), sm, "tally").view(v_n, -1)
        inc = pr_root | (ss_cnt >= sm)
        r_new = pr + inc.to(I32)
        # witness: sits on the Root, or exceeds the self-parent's round
        # (hashgraph.go:265-282).
        w_new = ((sp < 0) & (op < 0)) | (r_new > rnd_sp_raw)
        rounds[:, sids] = torch.where(valid, r_new, -1)
        wit[:, sids] = valid & w_new
        upd = valid & w_new
        if masks is not None:
            upd = upd & masks[:, sids]
        r_idx = torch.where(upd, torch.clamp(r_new, 0, r - 1), r)
        wt[view, r_idx, cr] = torch.where(upd, sids, -1)
    out = rounds[:, :e], wit[:, :e], wt[:, :r]
    return out if views else tuple(x[0] for x in out)


def decide_fame(wt, la, fd, index, coin, *, n, sm, r, reads=None):
    """Virtual voting — reference DecideFame (hashgraph.go:649-730).

    Round-j witnesses vote on every earlier witness slot (rx, cx).
    First-round votes are plain `see` (ancestry); later rounds take the
    majority over the round-(j-1) witnesses they strongly see, deciding
    fame on a >= 2n/3+1 tally in normal rounds and flipping the
    precomputed middle-bit coin in coin rounds (diff % n == 0,
    hashgraph.go:695-709,1039-1048). Decisions are consistent across
    deciders, so the sweep decides without the reference's early-break
    bookkeeping; votes on already-decided slots are computed but gated
    out of the fame table.

    A slot's votes depend on the rounds at and above its own only, so
    the sweep runs by depth d = j - rx with every slot row at once: step
    d is the votes of round rx+d on row rx, one batched [r, n, n]
    product. It stops when no undecided slot has a round left to vote
    in, one host read per step from d = 2 (appended to `reads` when a
    list is given): a node's window decides its rounds within a few
    steps, where a sweep by round takes r - 1 steps of ~30 torch calls,
    each a release and re-take of the interpreter lock (ROADMAP C1).

    The strongly-see matrices of all voting rounds — round j's
    witnesses against round j-1's — depend on the witness table alone,
    never on the votes, so gathered MATRIX launches
    (hopper_kernels.strongly_see_gathered) give them all first; past
    2^26 bytes of output they come in chunks of rounds. `fd` is dense
    or a row view (witness_rows): the launch reads the window's witness
    rows either way.

    A witness table with a leading view axis, wt [V, r, n] (ops/sim.py),
    gives famous [V, r, n]: the V*r slot rows of all views sweep
    together, each voting within its own view, one launch per chunk of
    voting rounds covers every view, and the sweep stops when no view
    has an undecided slot with a round left.

    Returns famous[r, n] trilean (0 undefined / 1 true / 2 false)."""
    # imported here: hopper_kernels imports this module's plain versions
    from .hopper_kernels import strongly_see_gathered

    dev = la.device
    wt_shape = wt.shape
    v_n = wt.shape[0] if wt.dim() == 3 else 1
    rows_n = v_n * r  # slot rows: round rx of view v is row v*r + rx
    famous = torch.zeros((rows_n, n), dtype=I32, device=dev)
    if r < 2:
        return famous.view(wt_shape)
    wt = wt.reshape(rows_n, n)
    wt_valid = wt >= 0
    wt_safe = torch.where(wt_valid, wt, 0)
    idx_x = torch.where(wt_valid, index[wt_safe], -1)  # [V*r, n]
    per_launch = chunk_width(r - 1, v_n * n * n)  # voting rounds per launch
    f_tab, w_tab = witness_rows(fd, wt)
    view = torch.arange(v_n, dtype=I32, device=dev)[:, None]  # [V, 1]
    # ss[v, q][y, x]: view v's round q+1 witness y strongly sees its
    # round q witness x (empty slots: y reads row 0 and is gated by
    # y_valid below; x is masked by the kernel); one launch per chunk of
    # voting rounds for every view, rows view-major
    blocks = []
    for j in range(1, r, per_launch):
        hi = min(j + per_launch, r)
        xs = wt_safe.view(v_n, r, n)[:, j:hi].reshape(-1)
        wrow = (view * r + torch.arange(j - 1, hi - 1, dtype=I32, device=dev)).view(
            -1).repeat_interleave(n)
        blocks.append(strongly_see_gathered(la, xs, f_tab, w_tab, wrow, sm, "matrix").view(
            torch.bool).view(v_n, hi - j, n, n))
    ss = (blocks[0] if len(blocks) == 1 else torch.cat(blocks, 1)).view(-1, n, n)

    slot = torch.arange(rows_n, device=dev)
    rx = slot % r  # each slot row's round
    last = slot - rx + (r - 1)  # the slot row of its view's last round
    ss_off = slot // r + 1  # ss row of round j of view v: v*(r-1) + j-1
    coin_w = coin[wt_safe].to(torch.bool)  # [V*r, n]
    for d in range(1, r):
        # row rx's voters: round rx+d's witnesses y of the same view
        jr = torch.clamp(slot + d, max=last)
        y_valid = wt_valid[jr] & (rx + d < r)[:, None]  # [V*r, n(y)]
        active = y_valid[:, :, None] & wt_valid[:, None, :]  # [V*r, n(y), n(cx)]
        if d == 1:
            vote = (la[wt_safe[jr]] >= idx_x[:, None, :]) & active
        else:
            ssd = ss[jr - ss_off]  # [V*r, n(y), n(z)]
            # 0/1 float32 product: tallies are <= n < 2^24, exact in
            # fp32 with TF32 off (devices.py).
            yays = torch.bmm(ssd.to(torch.float32), vote.to(torch.float32)).to(I32)
            nays = ssd.sum(-1, dtype=I32)[:, :, None] - yays
            v = yays >= nays
            strong = torch.maximum(yays, nays) >= sm
            if d % n:  # a normal round decides on a strong tally
                decide_now = active & strong
                dec_any = decide_now.any(1)
                dec_val = (decide_now & v).any(1)
                famous = torch.where(
                    dec_any & (famous == FAME_UNDEFINED) & wt_valid,
                    torch.where(dec_val, FAME_TRUE, FAME_FALSE).to(I32),
                    famous,
                )
                vote = v & active
            else:  # a coin round flips the coin where the tally is weak
                vote = torch.where(strong, v, coin_w[jr][:, :, None]) & active
            # another step only while an undecided slot has a round left
            left = (rx + d + 1 < r)[:, None] & wt_valid & (famous == FAME_UNDEFINED)
            if reads is not None:
                reads.append(1)
            if not bool(left.any()):
                break
    return famous.view(wt_shape)


def decide_round_received(rounds, wt, famous, la, fd, creator, index,
                          chain_rank, valid_mask=None, *, n, r):
    """Round-received + median consensus timestamps — reference
    DecideRoundReceived / MedianTimestamp / OldestSelfAncestorToSee
    (hashgraph.go:753-799,860-868,141-167).

    For each event x and candidate round i (fully decided, with every
    earlier round decided too), x is received at the first i where a
    strict majority of i's famous witnesses see it. Its consensus
    timestamp is the median over those witnesses of the timestamp of
    x's first descendant on each witness's own chain (Go substitutes
    the zero time when that descendant doesn't reach the witness;
    rank -1 plays that role).

    `valid_mask` [E+1] bool (a view, see compute_rounds) leaves the
    events outside the view unreceived. Leading view axes on rounds
    [V, E], wt and famous [V, r, n] and valid_mask [V, E+1] run V views
    at once, with results [V, E]. Both phases go over the events in
    chunks, so their [V, n, chunk] and [V, chunk, n] tensors stay under
    the broadcast budget.

    Returns (round_received[E] int32, -1 undecided;
             cts_rank[E] int32 timestamp rank, -1 = zero time)."""
    views = wt.dim() == 3
    if not views:
        rounds, wt, famous = rounds[None], wt[None], famous[None]
        if valid_mask is not None:
            valid_mask = valid_mask[None]
    dev = la.device
    v_n, e = rounds.shape
    k = chain_rank.shape[1]
    wt_valid = wt >= 0
    wt_safe = torch.where(wt_valid, wt, 0)
    has_undec = ((famous == FAME_UNDEFINED) & wt_valid).any(2)  # [V, r]
    rows = torch.arange(r, dtype=I32, device=dev)
    min_undec = torch.where(has_undec, rows, r).min(1).values  # [V]
    fmask = (famous == FAME_TRUE) & wt_valid  # [V, r, n]
    fcnt = fmask.sum(2, dtype=I32)
    idx_w = torch.where(wt_valid, index[wt_safe], -1)  # [V, r, n]
    creator_e = creator[:e]
    index_e = index[:e]
    view = torch.arange(v_n, device=dev)[:, None]  # [V, 1]
    ec = chunk_width(e, v_n * n, _bcast_budget(dev))
    chunks = [slice(x0, x0 + ec) for x0 in
              (_clamped(g, ec, e) for g in range(-(-e // ec)))]

    # Phase 1: first qualifying round per event. The final chunk may
    # overlap the one before it; an event received at i keeps i.
    rr = torch.full((v_n, e), -1, dtype=I32, device=dev)
    for i in range(r):
        eligible = (~has_undec[:, i] & (min_undec > i))[:, None]  # [V, 1]
        la_w = la[wt_safe[:, i]]  # [V, n(w), n]
        need = (fcnt[:, i] // 2)[:, None]
        for sl in chunks:
            see_wx = la_w[:, :, creator_e[sl]] >= index_e[sl]  # [V, n(w), chunk]
            s_cnt = (see_wx & fmask[:, i, :, None]).sum(1, dtype=I32)
            ok = eligible & (s_cnt > need) & (i > rounds[:, sl]) & (rr[:, sl] < 0)
            if valid_mask is not None:
                ok = ok & valid_mask[:, sl]
            rr[:, sl] = torch.where(ok, i, rr[:, sl])

    # Phase 2: medians against each event's own receiving round.
    cts = torch.empty((v_n, e), dtype=I32, device=dev)
    cols = torch.arange(n, device=dev)[None, :]
    for sl in chunks:
        rr_g = rr[:, sl]
        rr_safe = torch.clamp(rr_g, 0, r - 1)
        w_sel = wt_safe[view, rr_safe]  # [V, chunk, n] witnesses of the receiving round
        fm_sel = fmask[view, rr_safe]
        idxw_sel = idx_w[view, rr_safe]
        see_sel = la[w_sel, creator_e[sl][None, :, None]] >= index_e[sl][None, :, None]
        s_mask = see_sel & fm_sel
        s_cnt = s_mask.sum(2, dtype=I32)
        fd_g = fd[sl]
        valid_t = fd_g <= idxw_sel  # the first descendant reaches the witness
        ts_fd = chain_rank[cols, torch.clamp(fd_g, 0, k - 1)]  # [chunk, n]
        tsv = torch.where(valid_t, ts_fd, ZERO_TS_RANK)
        tvals = torch.where(s_mask, tsv, INT32_MAX)
        sorted_t = torch.sort(tvals, dim=2).values
        med = torch.gather(sorted_t, 2, (s_cnt // 2).to(torch.int64)[..., None])[..., 0]
        cts[:, sl] = torch.where(rr_g >= 0, med, ZERO_TS_RANK)
    return (rr, cts) if views else (rr[0], cts[0])
