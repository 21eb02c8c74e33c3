"""The port's device ECDSA verify (babble_tpu_torch/ops/p256.py) against
the JAX package's ladder (babble_tpu/ops/p256.py) and the host
backends, on the CPU. Tolerance: exact equality (field elements,
Jacobian limbs and verdicts are integers).

- the plain field operations against Python big ints, on values that
  reach every candidate of the final reduction;
- `dual_window_ref`'s (X, Y, Z) against the JAX kernel's, limb for
  limb, on one 8-lane batch of tests/test_crypto.py's corpus and the
  d = 1 degeneracies of tests/test_p256.py (one JAX compile, ~20 s:
  keep every JAX batch at 8);
- `verify_batch(..., device="cpu")` against the pure fallback's
  verdicts on the whole corpus, the degeneracies and a one-lane batch,
  and its `parts` timing;
- the projective verdict (`_verdict`: X == r Z^2, or (r + N) Z^2, mod
  P) against the affine one (x = X Z^-2 mod P, x mod N == r) on
  synthetic points, x in [N, P) and Z = 0 included;
- the kernel source's constant tables (csrc/p256.cu) against P, the
  Solinas rows of the plain version and 5P, and chip_smoke's count of
  the kernel's instructions a signature on a listing of its shape;
- the wrapper on a CUDA tensor with no GPU raises and never takes the
  plain version; on a CPU tensor it takes the plain version without a
  launch.

The corpus (chip_smoke.p256_corpus: tests/test_crypto.py's, rebuilt
with the port's crypto) is signed with the deterministic signer
(`_fallback.sign`), so both packages see the same signatures. The CUDA
kernel itself is held against `dual_window_ref` on the card by
chip_smoke.py."""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from babble_tpu.ops import p256 as jp256
from babble_tpu_torch import crypto
from babble_tpu_torch.crypto import _fallback as fb
from babble_tpu_torch.ops import p256
from chip_smoke import p256_corpus as corpus
from chip_smoke import p256_degeneracies as degeneracies
from chip_smoke import p256_lanes as ladder_inputs

# The tensors are tiny: one intra-op thread keeps these tests from
# competing for cores with the timing-sensitive live-net tests.
torch.set_num_threads(1)

P, N = p256.P, p256.N
CPU = torch.device("cpu")


def words(x):
    return torch.tensor([[(x >> (32 * i)) & 0xFFFFFFFF for i in range(8)]],
                        dtype=torch.int64)


def value(row):
    return sum(int(v) << (32 * i) for i, v in enumerate(row.tolist()))


# Powers of two and their neighbours below P and above 2^256 - P: the
# products reach every candidate of the reduction (W + P, W, W - P).
EDGES = ([0, 1, 2, 3, P - 1, P - 2, P - 3] + [1 << k for k in range(0, 256, 8)]
         + [P - (1 << k) for k in range(0, 224, 8)]
         + [(1 << 256) - 1 - P + (1 << k) for k in range(0, 200, 16)])


def field_values():
    rng = np.random.default_rng(7)
    rand = [int.from_bytes(rng.bytes(32), "big") % P for _ in range(24)]
    return EDGES + rand


def test_field_ops_match_big_ints(monkeypatch):
    """Every plain field operation on EDGES and random values equals the
    big-int result mod P, fully reduced; the products take each of the
    reduction's three candidates."""
    c = p256._consts(CPU)
    vals = field_values()
    a = torch.cat([words(x) for x in vals])
    picked = set()
    real = p256._canon

    def spy(cands):
        _, top = p256._sweep(cands)
        if cands.shape[0] == 3:
            picked.update(((top >= 0).sum(0) - 1).tolist())
        return real(cands)

    monkeypatch.setattr(p256, "_canon", spy)
    for y in vals:
        b = words(y).expand_as(a).contiguous()
        got = {name: fn() for name, fn in (
            ("mul", lambda: p256._fmul(a, b, c)), ("add", lambda: p256._fadd(a, b, c)),
            ("sub", lambda: p256._fsub(a, b, c)))}
        for i, x in enumerate(vals):
            want = {"mul": x * y % P, "add": (x + y) % P, "sub": (x - y) % P}
            for name, t in got.items():
                assert value(t[i]) == want[name], (name, x, y)
    assert picked == {0, 1, 2}
    for k in range(1, 9):
        got = p256._fsmall(a, k, c)
        assert [value(r) for r in got] == [x * k % P for x in vals], k
    assert p256._is_zero(a).tolist() == [x == 0 for x in vals]


def test_limb_and_nibble_helpers():
    rng = np.random.default_rng(5)
    xs = [0, 1, P - 1, N - 1] + [int.from_bytes(rng.bytes(32), "big") for _ in range(8)]
    limbs = np.stack([p256._to_limbs(x) for x in xs])
    assert p256._from_limbs(limbs) == xs
    assert p256._from_limbs(p256._limbs(p256._words(torch.from_numpy(limbs))).numpy()) == xs
    nib = p256._nibbles_of(xs)
    assert nib.shape == (len(xs), 64) and nib.dtype == np.int32
    for x, row in zip(xs, nib):
        assert (row == jp256._nibbles_of(x)).all()


def test_dual_window_ref_matches_jax_kernel():
    """One 8-lane batch: the corpus's six in-range lanes and the two
    degeneracies. The port's prelude equals the JAX package's, and the
    plain ladder's (X, Y, Z) equal the JAX kernel's limb for limb."""
    pubs, digests, sigs, _ = corpus()
    dp, dd, ds = degeneracies()
    lanes = [i for i in range(len(pubs)) if 1 <= sigs[i][0] < N and pubs[i][1:] != bytes(64)]
    assert len(lanes) == 6
    n1, n2, qw = ladder_inputs([pubs[i] for i in lanes] + dp,
                               [digests[i] for i in lanes] + dd,
                               [sigs[i] for i in lanes] + ds)
    for pub, q in zip([pubs[i] for i in lanes] + dp, qw):
        assert (q == jp256._q_window_limbs(pub)).all()
    assert (p256._G_WIN_LIMBS == jp256._G_WIN_LIMBS).all()
    want = [np.asarray(x) for x in jp256._get_kernel()(n1, n2, qw)]
    got = p256.dual_window_ref(*(torch.from_numpy(a) for a in (n1, n2, qw)))
    for name, g, w in zip("XYZ", got, want):
        assert g.dtype == torch.int32 and g.shape == (8, 16), name
        assert (g.numpy() == w).all(), name
    # The infinity lane ends with Z = 0; every other lane is a point.
    z = p256._from_limbs(got[2].numpy())
    assert z[6] == 0 and all(z[:6]) and z[7] != 0


def test_verify_batch_matches_host_backends():
    """The whole corpus in one batch, the degeneracies, and one-lane
    batches: verdicts equal the pure fallback's and the active host
    backend's, None for the malformed creator."""
    pubs, digests, sigs, expected = corpus()
    assert fb.verify_batch(pubs, digests, sigs) == expected
    assert crypto.verify_batch(pubs, digests, sigs) == expected
    assert p256.verify_batch(pubs, digests, sigs, device="cpu") == expected
    dp, dd, ds = degeneracies()
    want = fb.verify_batch(dp, dd, ds)
    assert want[0] is False
    assert p256.verify_batch(dp, dd, ds, device="cpu") == want
    key = fb.key_from_seed(77)
    pub = fb.pub_key_bytes(key)
    d = crypto.sha256(b"lane")
    r, s = fb.sign(key, d)
    assert p256.verify_batch([pub], [d], [(r, s)], device="cpu") == [True]
    assert p256.verify_batch([pub], [d], [(r, s + 1)], device="cpu") == [False]


def test_verify_batch_parts():
    """`parts` takes the wall seconds of each part of the call and leaves
    the verdicts as they are; with no live lane nothing is timed."""
    pubs, digests, sigs, expected = corpus()
    parts = {}
    assert p256.verify_batch(pubs, digests, sigs, device="cpu", parts=parts) == expected
    assert list(parts) == ["prelude", "upload", "kernel", "download", "epilogue"]
    assert all(v >= 0 for v in parts.values())
    none = {}
    p256.verify_batch(pubs[6:9], digests[6:9], sigs[6:9], device="cpu", parts=none)
    assert none == {}


def test_verify_batch_without_live_lanes():
    """Nothing reaches the ladder when no lane passes the checks."""
    pubs, digests, sigs, expected = corpus()
    tail = slice(6, 9)
    assert p256.verify_batch(pubs[tail], digests[tail], sigs[tail],
                             device="cpu") == expected[tail]
    assert p256.verify_batch([], [], [], device="cpu") == []
    assert p256.available()


def test_verify_batch_needs_a_device(monkeypatch):
    """Like every entry point: CUDA unless the caller names the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pubs, digests, sigs, _ = corpus()
    with pytest.raises(RuntimeError, match="CUDA"):
        p256.verify_batch(pubs, digests, sigs)


class _OnCuda:
    """A CPU tensor that says it lies on a CUDA device."""

    def __init__(self, t):
        self._t = t
        self.dtype, self.shape = t.dtype, t.shape
        self.device = torch.device("cuda", 0)

    def dim(self):
        return self._t.dim()

    def is_contiguous(self):
        return self._t.is_contiguous()


def _small_inputs():
    pubs, digests, sigs, _ = corpus()
    return [torch.from_numpy(a) for a in ladder_inputs(pubs[:2], digests[:2], sigs[:2])]


def test_wrapper_on_cuda_tensor_never_takes_plain_version(monkeypatch):
    calls = []
    monkeypatch.setattr(p256, "dual_window_ref", lambda *a: calls.append(a))
    before = p256.dual_window.launches
    with pytest.raises(Exception):
        p256.dual_window(*(_OnCuda(t) for t in _small_inputs()))
    assert calls == [] and p256.dual_window.launches == before


def test_wrapper_on_cpu_tensor_takes_plain_version():
    args = _small_inputs()
    before = p256.dual_window.launches
    got = p256.dual_window(*args)
    want = p256.dual_window_ref(*args)
    assert p256.dual_window.launches == before
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def _bad(name):
    n1, n2, qw = _small_inputs()
    wide = torch.cat([n1, n1], 1)
    return {
        "int64": ((n1.long(), n2, qw), TypeError),
        "nibble_axis": ((n1[:, :32].contiguous(), n2, qw), ValueError),
        "lanes_differ": ((n1, n2[:1].contiguous(), qw), ValueError),
        "qwin_shape": ((n1, n2, qw[:, :8].contiguous()), ValueError),
        "non_contiguous": ((wide[:, ::2], n2, qw), ValueError),
        "other_device": ((n1.to("meta"), n2.to("meta"), qw.to("meta")), ValueError),
    }[name]


@pytest.mark.parametrize("case", ["int64", "nibble_axis", "lanes_differ", "qwin_shape",
                                  "non_contiguous", "other_device"])
def test_wrapper_rejects(case):
    args, exc = _bad(case)
    before = p256.dual_window.launches
    with pytest.raises(exc):
        p256.dual_window(*args)
    assert p256.dual_window.launches == before


def _affine_verdict(X, Z, r):
    return Z != 0 and X * pow(Z, -2, P) % P % N == r


def _verdict_cases(case):
    """(X, Z, r) triples of one kind, X = x Z^2 for the affine x."""
    rng = np.random.default_rng(11)

    def below(hi):
        return 1 + int.from_bytes(rng.bytes(40), "big") % (hi - 1)

    def point(x, z):
        return x * z * z % P, z

    out = []
    if case == "x_below_n":
        for x in [below(N) for _ in range(6)] + [1, N - 1, P - N - 1, P - N]:
            X, Z = point(x, below(P))
            out += [(X, Z, x), (X, Z, x - 1 or 2), (X, Z, (x + 1) % N or 1)]
    elif case == "x_at_least_n":  # r = x - N: no real signature reaches it
        for x in [N + below(P - N) for _ in range(6)] + [N, N + 1, P - 1]:
            X, Z = point(x, below(P))
            out += [(X, Z, x - N), (X, Z, x - N + 1), (X, Z, (x - N - 1) % N or 2)]
    elif case == "z_zero":
        out = [(X, 0, r) for X in (0, 1, below(P)) for r in (1, below(N), N - 1)]
    elif case == "z_one":
        for x in [below(P) for _ in range(6)] + [N, P - 1, 1]:
            out += [(x, 1, x % N or 1), (x, 1, (x + 1) % N or 1)]
    else:  # random points and r
        for _ in range(12):
            X, Z = below(P), below(P)
            x = X * pow(Z, -2, P) % P
            out += [(X, Z, x % N or 1), (X, Z, below(N))]
    return out


@pytest.mark.parametrize("case", ["x_below_n", "x_at_least_n", "z_zero", "z_one", "random"])
def test_projective_verdict_matches_affine(case):
    """verify_batch's epilogue (no inversion) gives the affine verdict on
    every triple; each kind but Z = 0 has both outcomes."""
    cases = _verdict_cases(case)
    got = [p256._verdict(X, Z, r) for X, Z, r in cases]
    assert got == [_affine_verdict(X, Z, r) for X, Z, r in cases]
    assert (True in got) == (case != "z_zero") and False in got


def test_kernel_constant_tables():
    """The kernel's tables: P, F = 2^256 - P, the Solinas rows (columns
    8-15 of the plain version's _SOLINAS) and 5P with every word in
    [2^34, 2^34 + 2^32), which keeps each row non-negative."""
    src = (Path(p256.__file__).resolve().parent.parent / "csrc" / "p256.cu").read_text()

    def table(name):
        body = re.search(r"__constant__ \w+ " + name + r"\[[^=]*=\s*\{(.*?)\};", src,
                         re.S).group(1)
        return [int(v, 0) for v in re.findall(r"-?0x[0-9A-Fa-f]+|-?\d+", body.replace("ull", "")
                                                                          .replace("u", ""))]

    def value(words):
        return sum(w << (32 * i) for i, w in enumerate(words))

    assert value(table("kP")) == P
    assert value(table("kF")) == (1 << 256) - P
    rows = np.array(table("kSolinas")).reshape(8, 8)
    assert (rows == p256._SOLINAS[:, 8:]).all() and (p256._SOLINAS[:, :8] == np.eye(8)).all()
    five = table("kFiveP")
    assert value(five) == 5 * P
    assert all(1 << 34 <= w < (1 << 34) + (1 << 32) for w in five)
    # A product's columns are below 2^32 + 16 when the rows are formed.
    assert all(w + int(rows[j][rows[j] < 0].sum()) * ((1 << 32) + 15) >= 0
               for j, w in enumerate(five))


FAKE_SASS = """
        code for sm_90a
                Function : _ZN12_GLOBAL__N_123p256_dual_window_kernelEPKiS1_S1_S1_PiS2_S2_i
        .headerflags    @"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   MOV R1, c[0x0][0x28] ;                 /* 0x0000 */
        /*0010*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;          /* 0x0000 */
        /*0020*/                   IADD3 R2, R2, 0x1, RZ ;                /* 0x0000 */
        /*0030*/                   IADD3 R3, R3, 0x1, RZ ;                /* 0x0000 */
        /*0040*/              @!P0 BRA 0x90 ;                             /* 0x0000 */
        /*0050*/                   IMAD R4, R4, R4, RZ ;                  /* 0x0000 */
        /*0060*/              @!P1 BRA 0x80 ;                             /* 0x0000 */
        /*0070*/                   VOTE.ANY R5, PT, P2 ;                  /* 0x0000 */
        /*0080*/                   IMAD R4, R4, R4, RZ ;                  /* 0x0000 */
        /*0090*/                   VOTE.ANY R6, PT, P3 ;                  /* 0x0000 */
        /*00a0*/              @!P0 BRA 0xd0 ;                             /* 0x0000 */
        /*00b0*/                   IMAD R7, R7, R7, RZ ;                  /* 0x0000 */
        /*00c0*/                   IMAD R7, R7, R7, RZ ;                  /* 0x0000 */
        /*00d0*/               @P0 BRA 0x30 ;                             /* 0x0000 */
        /*00e0*/               @P1 BRA 0x20 ;                             /* 0x0000 */
        /*00f0*/                   EXIT ;                                 /* 0x0000 */
"""


def test_team_chain_from_sass():
    """chip_smoke's chain bound of the team kernel on a listing of the
    kernel's shape: the add (3 instructions, its VOTE fix-up not
    counted) 128 times, the doubling (2) 256 times, the step loop's own
    5 instructions 384 times and the nibble loop's 2 64 times."""
    from chip_smoke import SM_CLOCK_HZ, p256_team_chain

    got = p256_team_chain("other kernels\n        Function : _Z5otherv\n" + FAKE_SASS)
    want = 128 * 3 + 256 * 2 + 384 * 5 + 64 * 2
    assert {k: got[k] for k in ("add", "double", "step", "nibble", "per_signature")} == {
        "add": 3, "double": 2, "step": 5, "nibble": 2, "per_signature": want}
    assert got["kernel_static"] == 16 and got["ms"] == want / SM_CLOCK_HZ * 1e3
