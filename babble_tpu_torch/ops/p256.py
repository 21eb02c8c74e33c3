"""Batched P-256 ECDSA verify on the card (counterpart of
babble_tpu/ops/p256.py).

The Shamir-trick double multiplication u1*G + u2*Q, the scalar-mult
core of every ECDSA verify, runs as one launch over the whole sync
batch behind `Config.device_verify` (off by default): the hand-written
CUDA kernel csrc/p256.cu on a CUDA device, its plain PyTorch version
`dual_window_ref` on the CPU.

Split of labour (the JAX package's, verdicts pinned against the host
backends by tests/test_torch_p256.py):

- host: range checks, per-creator 4-bit window tables (shared with the
  pure fallback's `_q_window` LRU), w = s^-1 via ONE Montgomery batched
  inversion, u1/u2 nibble decomposition, and the verdict `x mod N == r`
  on the Jacobian point in big ints, without an inversion (`_verdict`);
- device: the 64-nibble dual-window ladder (4 doublings and at most 2
  mixed additions per nibble), a team of 8 lanes per signature.

One call of `verify_batch` makes one host-to-device copy (the digits
and the window tables, packed into one pinned staging tensor that the
kernel reads in place), one launch and one device-to-host copy (X and
Z).

`dual_window(n1, n2, qwin)` has the layout of the JAX package's jitted
ladder: n1/n2 int32 [B, 64] MSB-first nibbles, qwin int32 [B, 16, 2,
16] (entry i is i*Q affine as 16 limbs of 16 bits), and returns
(X, Y, Z), each int32 [B, 16] limbs fully reduced to [0, P). The point
formulas are the JAX package's (dbl-2001-b, branchless; the mixed add
with crypto/_fallback.py's degeneracies: identity accumulator ->
(x2, y2, 1), H = 0 with equal Y -> doubling, H = 0 with opposite Y ->
(0, 1, 0); nibble 0 keeps the accumulator; the ladder starts from
(0, 1, 0)), so the Jacobian representative equals the JAX kernel's limb
for limb, not only the verdict.

The XLA kernel's batch-size ladder {8, 64, 512} and its lane padding
bounded recompiles; the CUDA kernel has none, so a batch is one launch
at its own size.
"""

from __future__ import annotations

import contextlib
import functools
import threading
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..crypto import _fallback as _fb
from ..devices import resolve_device
from . import hopper_kernels

P = _fb.P
N = _fb.N

_LIMBS = 16
_LIMB_BITS = 16
_MASK = (1 << _LIMB_BITS) - 1
_NIBBLES = 64

# NIST P-256 Solinas reduction (FIPS 186-4 D.2.3): the 512-bit product
# as 32-bit words A0..A15, result words r0..r7 as signed combinations
# T + 2*S1 + 2*S2 + S3 + S4 - D1 - D2 - D3 - D4. _SOLINAS[j][i] is the
# coefficient of A_i in r_j.
_SOLINAS = np.zeros((8, 16), dtype=np.int32)
for _j in range(8):
    _SOLINAS[_j][_j] += 1                      # T
for _j, _i in enumerate((11, 12, 13, 14, 15), start=3):
    _SOLINAS[_j][_i] += 2                      # 2*S1
for _j, _i in enumerate((12, 13, 14, 15), start=3):
    _SOLINAS[_j][_i] += 2                      # 2*S2
for _j, _i in ((0, 8), (1, 9), (2, 10), (6, 14), (7, 15)):
    _SOLINAS[_j][_i] += 1                      # S3
for _j, _i in ((0, 9), (1, 10), (2, 11), (3, 13), (4, 14), (5, 15),
               (6, 13), (7, 8)):
    _SOLINAS[_j][_i] += 1                      # S4
for _j, _i in ((0, 11), (1, 12), (2, 13), (6, 8), (7, 10)):
    _SOLINAS[_j][_i] -= 1                      # D1
for _j, _i in ((0, 12), (1, 13), (2, 14), (3, 15), (6, 9), (7, 11)):
    _SOLINAS[_j][_i] -= 1                      # D2
for _j, _i in ((0, 13), (1, 14), (2, 15), (3, 8), (4, 9), (5, 10),
               (7, 12)):
    _SOLINAS[_j][_i] -= 1                      # D3
for _j, _i in ((0, 14), (1, 15), (3, 9), (4, 10), (5, 11), (7, 13)):
    _SOLINAS[_j][_i] -= 1                      # D4


def _to_limbs(x: int) -> np.ndarray:
    return np.array([(x >> (_LIMB_BITS * i)) & _MASK
                     for i in range(_LIMBS)], dtype=np.int32)


def _from_limbs(limbs: np.ndarray) -> List[int]:
    """The integers of a [B, 16] array of 16-bit limbs."""
    raw = np.ascontiguousarray(np.asarray(limbs), dtype="<u2")
    return [int.from_bytes(row.tobytes(), "little") for row in raw]


def _nibbles_of(values: Sequence[int]) -> np.ndarray:
    """[len(values), 64] MSB-first 4-bit digits, matching
    _fallback._dual_window's shift order (252 down to 0)."""
    raw = np.frombuffer(b"".join(v.to_bytes(32, "big") for v in values),
                        dtype=np.uint8).reshape(len(values), 32)
    return np.stack([raw >> 4, raw & 0xF], axis=2).reshape(
        len(values), _NIBBLES).astype(np.int32)


@functools.lru_cache(maxsize=256)
def _q_window_limbs(pub: bytes) -> np.ndarray:
    """Per-creator window table as a (16, 2, 16) limb array: entry i is
    i*Q affine (x, y); entry 0 is a never-addressed placeholder (nibble
    0 keeps the accumulator). Cached per creator alongside _fallback's
    own big-int window LRU."""
    pt = _fb.pub_key_from_bytes(pub)  # raises ValueError off-curve
    win = _fb._q_window(pt.x, pt.y)
    arr = np.zeros((16, 2, _LIMBS), dtype=np.int32)
    for i in range(1, 16):
        arr[i, 0] = _to_limbs(win[i][0])
        arr[i, 1] = _to_limbs(win[i][1])
    return arr


_G_WIN_LIMBS = np.zeros((16, 2, _LIMBS), dtype=np.int32)
for _i in range(1, 16):
    _G_WIN_LIMBS[_i, 0] = _to_limbs(_fb._G_WIN[_i][0])
    _G_WIN_LIMBS[_i, 1] = _to_limbs(_fb._G_WIN[_i][1])


# -- the plain version ------------------------------------------------------
#
# Field elements are int64 [..., 8] tensors of 32-bit words, every one
# fully reduced to [0, P) between operations, as the JAX kernel keeps
# its 16-bit limbs: so every intermediate, and the outputs, equal the
# JAX kernel's. A product is formed on 16-bit halves (int64 column sums
# below 2^36), the Solinas combination is taken on the unswept 32-bit
# column pairs (|acc| < 2^57), and every reduction ends by picking, of
# a few candidates W + kP, the one in [0, P) (`_canon`): one carry
# sweep over 8 words per step instead of the JAX kernel's chain of
# sweeps and compares over 16 limbs.

_M32 = 0xFFFFFFFF
_P_WORDS = [(P >> (32 * i)) & _M32 for i in range(8)]


@functools.lru_cache(maxsize=None)
def _consts(device: torch.device) -> dict:
    def t(x):
        return torch.tensor(x, dtype=torch.int64, device=device)

    p = t(_P_WORDS)
    return {
        "p": p,
        "solinas": t(_SOLINAS.tolist()),
        # 2^256 == 2^224 - 2^192 - 2^96 + 1 (mod P), by 32-bit word.
        "fold": t([1, 0, 0, -1, 0, 0, -1, 1]),
        "pm": torch.stack([p, torch.zeros_like(p), -p])[:, None],  # +P, 0, -P
        "multiples": torch.arange(8, device=device, dtype=torch.int64)[:, None, None] * p,
        "g": _words(torch.from_numpy(_G_WIN_LIMBS).to(device)),
    }


def _words(limbs: torch.Tensor) -> torch.Tensor:
    """[..., 16] 16-bit limbs -> [..., 8] int64 32-bit words."""
    x = limbs.to(torch.int64)
    return x[..., 0::2] | (x[..., 1::2] << 16)


def _limbs(words: torch.Tensor) -> torch.Tensor:
    """[..., 8] 32-bit words -> [..., 16] int32 16-bit limbs."""
    return torch.stack((words & _MASK, words >> 16), -1).flatten(-2).to(torch.int32)


def _sweep(w: torch.Tensor):
    """Signed carry sweep over the last axis: words into [0, 2^32), the
    excess out as the carry (arithmetic shift: floor division)."""
    out, carry = [], None
    for v in w.unbind(-1):
        if carry is not None:
            v = v + carry
        carry = v >> 32
        out.append(v & _M32)
    return torch.stack(out, -1), carry


def _canon(cands: torch.Tensor) -> torch.Tensor:
    """cands [K, ..., 8]: K representatives of one residue in decreasing
    order of value, exactly one of them in [0, P): that one, which is
    the smallest nonnegative."""
    words, top = _sweep(cands)
    k = (top >= 0).sum(0) - 1
    return torch.gather(words, 0, k[None, ..., None].expand_as(words[:1]))[0]


def _fmul(a: torch.Tensor, b: torch.Tensor, c: dict) -> torch.Tensor:
    x = torch.stack((a & _MASK, a >> 16), -1).flatten(-2)
    y = torch.stack((b & _MASK, b >> 16), -1).flatten(-2)
    prod = x[..., :, None] * y[..., None, :]  # [..., 16, 16], < 2^32
    # Column sums cols[k] = sum over i + j = k: row i shifted right by i.
    skew = F.pad(prod, (0, 16)).flatten(-2)[..., :16 * 31].unflatten(-1, (16, 31))
    cols = F.pad(skew.sum(-2), (0, 1))  # [..., 32], < 2^36
    words = cols[..., 0::2] + (cols[..., 1::2] << 16)  # A_0..A_15, < 2^53
    acc = (words[..., None, :] * c["solinas"]).sum(-1)  # [..., 8]
    swept, top = _sweep(acc)  # |top| < 2^25
    folded = swept + top[..., None] * c["fold"]  # in (-2^250, 2^256 + 2^250)
    return _canon(folded + c["pm"].view(3, *([1] * (folded.dim() - 1)), 8))


def _fsmall(a: torch.Tensor, k: int, c: dict) -> torch.Tensor:
    """k*a mod P for 1 <= k <= 8 (k = 2 is the field add a + a)."""
    v = a * k  # in [0, kP)
    m = c["multiples"][:k].view(k, *([1] * (a.dim() - 1)), 8)
    return _canon(v - m)


def _fsub(a: torch.Tensor, b: torch.Tensor, c: dict) -> torch.Tensor:
    d = a - b  # in (-P, P)
    return _canon(torch.stack((d + c["p"], d)))


def _fadd(a: torch.Tensor, b: torch.Tensor, c: dict) -> torch.Tensor:
    s = a + b  # in [0, 2P)
    return _canon(torch.stack((s, s - c["p"])))


def _is_zero(a: torch.Tensor) -> torch.Tensor:
    return (a == 0).all(-1)


def _jac_double(X, Y, Z, c):
    """dbl-2001-b, branchless: Y = 0 (and the identity) gives Z3 = 0 by
    the formulas themselves. Independent products share one call."""
    delta, gamma = _fmul(torch.stack((Z, Y)), torch.stack((Z, Y)), c)
    beta, t, yz = _fmul(torch.stack((X, _fsub(X, delta, c), Y)),
                        torch.stack((gamma, _fadd(X, delta, c), Z)), c)
    alpha = _fsmall(t, 3, c)
    beta4 = _fsmall(beta, 4, c)
    alpha2, gamma2 = _fmul(torch.stack((alpha, gamma)), torch.stack((alpha, gamma)), c)
    X3 = _fsub(alpha2, _fsmall(beta4, 2, c), c)
    Z3 = _fsmall(yz, 2, c)  # (Y + Z)^2 - gamma - delta
    Y3 = _fsub(_fmul(alpha, _fsub(beta4, X3, c), c), _fsmall(gamma2, 8, c), c)
    return X3, Y3, Z3


def _jac_add_affine(X1, Y1, Z1, x2, y2, c):
    """Mixed add with _fallback._jac_add_affine's degeneracies as
    selects: identity accumulator -> (x2, y2, 1); H = 0 with equal Y ->
    the doubling (computed only when some lane needs it); H = 0 with
    opposite Y -> (0, 1, 0)."""
    z1z1 = _fmul(Z1, Z1, c)
    u2, y2z1 = _fmul(torch.stack((x2, y2)), torch.stack((z1z1, Z1)), c)
    s2 = _fmul(y2z1, z1z1, c)
    H = _fsub(u2, X1, c)
    r2 = _fsmall(_fsub(s2, Y1, c), 2, c)
    H2 = _fsmall(H, 2, c)
    I, z1h = _fmul(torch.stack((H2, Z1)), torch.stack((H2, H)), c)
    J, V = _fmul(torch.stack((H, X1)), torch.stack((I, I)), c)
    r2r2, y1j = _fmul(torch.stack((r2, Y1)), torch.stack((r2, J)), c)
    X3 = _fsub(_fsub(r2r2, J, c), _fsmall(V, 2, c), c)
    Y3 = _fsub(_fmul(r2, _fsub(V, X3, c), c), _fsmall(y1j, 2, c), c)
    Z3 = _fsmall(z1h, 2, c)  # (Z1 + H)^2 - Z1Z1 - H^2

    zero = torch.zeros_like(X1)
    one = zero.clone()
    one[..., 0] = 1
    h_zero = _is_zero(H)[..., None]
    y_eq = _is_zero(r2)[..., None]
    inf_in = _is_zero(Z1)[..., None]
    if bool((h_zero & y_eq & ~inf_in).any()):
        dX, dY, dZ = _jac_double(X1, Y1, Z1, c)
    else:
        dX = dY = dZ = zero
    X = torch.where(h_zero, torch.where(y_eq, dX, zero), X3)
    Y = torch.where(h_zero, torch.where(y_eq, dY, one), Y3)
    Z = torch.where(h_zero, torch.where(y_eq, dZ, zero), Z3)
    return (torch.where(inf_in, x2, X), torch.where(inf_in, y2, Y),
            torch.where(inf_in, one, Z))


def dual_window_ref(n1: torch.Tensor, n2: torch.Tensor,
                    qwin: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of the ladder, on any device: the JAX
    kernel's dual_window_one with the vmap written out as the batch
    axis. Same contract as `dual_window`."""
    c = _consts(n1.device)
    b = n1.shape[0]
    q = _words(qwin)  # [B, 16, 2, 8]
    lanes = torch.arange(b, device=n1.device)
    zero = torch.zeros((b, 8), dtype=torch.int64, device=n1.device)
    one = zero.clone()
    one[:, 0] = 1
    X, Y, Z = zero, one, zero
    for i in range(_NIBBLES):
        for _ in range(4):
            X, Y, Z = _jac_double(X, Y, Z, c)
        d1, d2 = n1[:, i].long(), n2[:, i].long()
        for d, x2, y2 in ((d1, c["g"][d1, 0], c["g"][d1, 1]),
                          (d2, q[lanes, d2, 0], q[lanes, d2, 1])):
            aX, aY, aZ = _jac_add_affine(X, Y, Z, x2, y2, c)
            keep = (d == 0)[:, None]
            X, Y, Z = (torch.where(keep, X, aX), torch.where(keep, Y, aY),
                       torch.where(keep, Z, aZ))
    return _limbs(X), _limbs(Y), _limbs(Z)


# -- the kernel's wrapper ---------------------------------------------------

_g_tables: dict = {}
_streams: dict = {}
_dev_lock = threading.Lock()


def _check(name: str, t: torch.Tensor, shape: tuple) -> None:
    if t.dtype != torch.int32:
        raise TypeError(f"{name} must be int32, got {t.dtype}")
    if t.dim() != len(shape) or any(s is not None and s != d for s, d in zip(shape, t.shape)):
        raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _dual_window_xzy(n1: torch.Tensor, n2: torch.Tensor, qwin: torch.Tensor) -> torch.Tensor:
    """`dual_window`'s work with its outputs as one int32 [3, B, 16]
    tensor in the order X, Z, Y, so that X and Z are one piece to copy
    back."""
    _check("n1", n1, (None, _NIBBLES))
    b = n1.shape[0]
    _check("n2", n2, (b, _NIBBLES))
    _check("qwin", qwin, (b, 16, 2, _LIMBS))
    dev = n1.device
    if n2.device != dev or qwin.device != dev:
        raise ValueError("operands on more than one device")
    if dev.type == "cpu":
        X, Y, Z = dual_window_ref(n1, n2, qwin)
        return torch.stack((X, Z, Y))
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    out = torch.empty((3, b, _LIMBS), dtype=torch.int32, device=dev)
    if b == 0:
        return out
    with _dev_lock:
        g = _g_tables.get(dev)
        if g is None:
            g = _g_tables[dev] = torch.from_numpy(_G_WIN_LIMBS).to(dev)
    hopper_kernels.launch_p256_dual_window(n1, n2, qwin, g, out[0], out[2], out[1], b)
    hopper_kernels.count_launch(dual_window)
    return out


def dual_window(n1: torch.Tensor, n2: torch.Tensor,
                qwin: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """u1*G + u2*Q for each lane as Jacobian (X, Y, Z), each int32
    [B, 16] 16-bit limbs in [0, P). n1, n2: int32 [B, 64] MSB-first
    nibbles of u1 and u2; qwin: int32 [B, 16, 2, 16], the lane's Q
    window table. All contiguous and on one device. CUDA tensors go to
    the hand-written kernel (one launch on the current stream, counted
    in `dual_window.launches`); CPU tensors go to `dual_window_ref`."""
    out = _dual_window_xzy(n1, n2, qwin)
    return out[0], out[2], out[1]


dual_window.launches = 0


def _verify_stream(dev: torch.device):
    """The stream verify_batch runs on, one per device: its reads of X
    and Z wait for the verify alone, never for a consensus pass the
    engine has in flight on its own stream."""
    with _dev_lock:
        s = _streams.get(dev)
        if s is None:
            s = _streams[dev] = torch.cuda.Stream(dev)
        return s


def available() -> bool:
    """True wherever torch imports: the CPU runs the plain version."""
    return True


def _verdict(X: int, Z: int, r: int) -> bool:
    """`x mod N == r` for the affine x = X / Z^2 of a Jacobian point, with
    no inversion: x lies in [0, P) and N < P < 2N, so x mod N == r exactly
    when x == r or, where r + N < P, x == r + N; and x == v exactly when
    X == v Z^2 (mod P). Z = 0 is the identity point: reject."""
    if Z == 0:
        return False
    z2 = Z * Z % P
    return X == r * z2 % P or (r + N < P and X == (r + N) * z2 % P)


def verify_batch(pubs: Sequence[bytes], digests: Sequence[bytes],
                 sigs: Sequence[Tuple[int, int]], device=None,
                 parts: Optional[dict] = None) -> List[Optional[bool]]:
    """Batched ECDSA verify on `device` (CUDA unless the caller names
    another) with the host backends' exact verdict contract: True/False
    per signature, None for a malformed creator point. Equal to
    `crypto.verify_batch` on every input, because both sides compute the
    same u1*G + u2*Q over the same window tables; only where the ladder
    runs differs.

    `parts`, if a dict, is filled with the wall seconds of "prelude",
    "upload", "kernel", "download" and "epilogue"; only then is the
    stream synchronised after the upload and after the kernel."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    n = len(pubs)
    verdicts: List[Optional[bool]] = [False] * n
    qwins = [None] * n
    live: List[int] = []
    cache: dict = {}
    for i, pub in enumerate(pubs):
        if pub not in cache:
            try:
                cache[pub] = _q_window_limbs(pub)
            except ValueError:
                cache[pub] = None
        arr = cache[pub]
        if arr is None:
            verdicts[i] = None
            continue
        r, s = sigs[i]
        if not (1 <= r < N and 1 <= s < N):
            continue
        qwins[i] = arr
        live.append(i)
    if not live:
        return verdicts

    # Host prelude: one Montgomery batched inversion for every w, then
    # the nibble decomposition of u1 = z*w and u2 = r*w, written with the
    # window tables into one staging tensor (pinned for a CUDA device):
    # n1 [b, 64], n2 [b, 64], qwin [b, 16, 2, 16].
    ws = _fb._batch_inv_n([sigs[i][1] for i in live])
    u1 = [int.from_bytes(digests[i], "big") % N * w % N for i, w in zip(live, ws)]
    u2 = [sigs[i][0] * w % N for i, w in zip(live, ws)]
    b = len(live)
    cuda = dev.type == "cuda"
    stage = torch.empty(b * (2 * _NIBBLES + 16 * 2 * _LIMBS), dtype=torch.int32,
                        pin_memory=cuda)
    view = stage.numpy()
    view[:b * _NIBBLES] = _nibbles_of(u1).ravel()
    view[b * _NIBBLES:2 * b * _NIBBLES] = _nibbles_of(u2).ravel()
    np.stack([qwins[i] for i in live], out=view[2 * b * _NIBBLES:].reshape(b, 16, 2, _LIMBS))
    stream = _verify_stream(dev) if cuda else None
    marks = [("prelude", time.perf_counter())]

    def mark(name):
        if parts is not None:
            if cuda:
                stream.synchronize()
            marks.append((name, time.perf_counter()))

    with torch.cuda.stream(stream) if cuda else contextlib.nullcontext():
        dstage = stage.to(dev, non_blocking=True)
        mark("upload")
        out = _dual_window_xzy(dstage[:b * _NIBBLES].view(b, _NIBBLES),
                               dstage[b * _NIBBLES:2 * b * _NIBBLES].view(b, _NIBBLES),
                               dstage[2 * b * _NIBBLES:].view(b, 16, 2, _LIMBS))
        mark("kernel")
        xz = torch.empty((2, b, _LIMBS), dtype=torch.int32, pin_memory=cuda)
        xz.copy_(out[:2], non_blocking=True)
        if cuda:
            stream.synchronize()
    marks.append(("download", time.perf_counter()))
    # Host epilogue: the verdict on the Jacobian point (Z = 0, the
    # identity point, rejects).
    for i, x, z in zip(live, _from_limbs(xz[0].numpy()), _from_limbs(xz[1].numpy())):
        verdicts[i] = _verdict(x, z, sigs[i][0])
    marks.append(("epilogue", time.perf_counter()))
    if parts is not None:
        prev = t0
        for name, t in marks:
            parts[name] = t - prev
            prev = t
    return verdicts
