"""ctypes binding to the SYSTEM libcrypto for ECDSA P-256 hot paths.

The optional `cryptography` package is the preferred OpenSSL backend,
but many deployment images (including the CI runners this repo targets)
ship libcrypto.so for Python's own ssl module while the wheel is
absent. The pure-Python fallback is then the only signer/verifier —
at ~3 ms per operation it IS the gossip ingest wall (BENCH_SMOKE:
verify = 0.70 of the sync wall on a 1-core runner), two orders of
magnitude over what the hardware can do.

This module lifts exactly the two scalar-multiplication-bound
primitives onto libcrypto via ctypes, keeping the pure-Python key
objects (`_fallback.PrivateKey` / `PublicKey`) as the key
representation so PEM, serialization, and every caller stay unchanged:

- `verify(pub_bytes, digest, r, s)` — full ECDSA_do_verify on an
  EC_KEY deserialized once per public key (bounded cache; a gossip
  network sees the same n creator keys on millions of events).
- `sign(d, digest)` — RFC 6979 nonce derivation and the (r, s)
  arithmetic stay in Python (cheap big-int ops, and signatures remain
  BIT-IDENTICAL to the fallback's), only the k*G base multiplication
  goes to libcrypto.

No state is shared across calls except read-only EC_KEY/EC_GROUP
objects, which OpenSSL treats as const in these code paths, so the
verify worker pool can call in concurrently (ctypes releases the GIL
around foreign calls — on multicore runners verification genuinely
parallelizes, same as the `cryptography` backend).

`BABBLE_PURE_CRYPTO=1` disables the binding (CI's no-optional-deps job
uses it so the pure-Python code path keeps carrying a full suite run).
"""

from __future__ import annotations

import ctypes
import ctypes.util
import functools
import hashlib
import os
from typing import Optional, Tuple

# P-256 group order (same constant as _fallback.N).
N = 0xFFFFFFFF00000000FFFFFFFFFFFFFFFFBCE6FAADA7179E84F3B9CAC2FC632551
_NID_P256 = 415  # NID_X9_62_prime256v1

_lib = None


def _load():
    """Resolve libcrypto and declare the handful of prototypes used.
    Every pointer-returning symbol gets an explicit c_void_p restype —
    the ctypes default (c_int) truncates 64-bit pointers."""
    if os.environ.get("BABBLE_PURE_CRYPTO"):
        return None
    name = ctypes.util.find_library("crypto")
    candidates = [name] if name else []
    candidates += ["libcrypto.so.3", "libcrypto.so.1.1", "libcrypto.so"]
    lib = None
    for cand in candidates:
        if not cand:
            continue
        try:
            lib = ctypes.CDLL(cand)
            break
        except OSError:
            continue
    if lib is None:
        return None
    try:
        proto = {
            "EC_KEY_new_by_curve_name": (ctypes.c_void_p, [ctypes.c_int]),
            "EC_KEY_free": (None, [ctypes.c_void_p]),
            "EC_KEY_get0_group": (ctypes.c_void_p, [ctypes.c_void_p]),
            "EC_KEY_set_public_key": (
                ctypes.c_int, [ctypes.c_void_p, ctypes.c_void_p]),
            "EC_KEY_precompute_mult": (
                ctypes.c_int, [ctypes.c_void_p, ctypes.c_void_p]),
            "EC_POINT_new": (ctypes.c_void_p, [ctypes.c_void_p]),
            "EC_POINT_free": (None, [ctypes.c_void_p]),
            "EC_POINT_oct2point": (
                ctypes.c_int,
                [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_char_p,
                 ctypes.c_size_t, ctypes.c_void_p]),
            "EC_POINT_mul": (
                ctypes.c_int,
                [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                 ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]),
            "EC_POINT_get_affine_coordinates": (
                ctypes.c_int,
                [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                 ctypes.c_void_p, ctypes.c_void_p]),
            "ECDSA_SIG_new": (ctypes.c_void_p, []),
            "ECDSA_SIG_free": (None, [ctypes.c_void_p]),
            "ECDSA_SIG_set0": (
                ctypes.c_int,
                [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]),
            "ECDSA_do_verify": (
                ctypes.c_int,
                [ctypes.c_char_p, ctypes.c_int, ctypes.c_void_p,
                 ctypes.c_void_p]),
            "BN_bin2bn": (
                ctypes.c_void_p,
                [ctypes.c_char_p, ctypes.c_int, ctypes.c_void_p]),
            "BN_free": (None, [ctypes.c_void_p]),
            "BN_new": (ctypes.c_void_p, []),
            "BN_bn2binpad": (
                ctypes.c_int,
                [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]),
            "BN_CTX_new": (ctypes.c_void_p, []),
            "BN_CTX_free": (None, [ctypes.c_void_p]),
        }
        for sym, (res, args) in proto.items():
            fn = getattr(lib, sym)
            fn.restype = res
            fn.argtypes = args
    except AttributeError:
        # Pre-1.1.0 libcrypto (missing ECDSA_SIG_set0 /
        # EC_POINT_get_affine_coordinates): not worth a compat shim.
        return None
    return lib


class _ECKey:
    """Owned EC_KEY pointer; freed when the cache evicts it."""

    __slots__ = ("ptr",)

    def __init__(self, ptr):
        self.ptr = ptr

    def __del__(self):  # pragma: no cover - interpreter-shutdown guard
        try:
            if self.ptr and _lib is not None:
                _lib.EC_KEY_free(self.ptr)
        except Exception:  # noqa: BLE001
            pass


def available() -> bool:
    global _lib
    if _lib is None:
        _lib = _load() or False
    return bool(_lib)


@functools.lru_cache(maxsize=4096)
def _ec_key(pub: bytes) -> _ECKey:
    """EC_KEY for a 65-byte uncompressed X9.62 point. oct2point
    validates on-curve (OpenSSL >= 1.1.0), so a malformed point raises
    here — the same error surface as `pub_key_from_bytes`."""
    key = _lib.EC_KEY_new_by_curve_name(_NID_P256)
    if not key:
        raise MemoryError("EC_KEY_new_by_curve_name failed")
    holder = _ECKey(key)
    group = _lib.EC_KEY_get0_group(key)
    pt = _lib.EC_POINT_new(group)
    if not pt:
        raise MemoryError("EC_POINT_new failed")
    try:
        if not _lib.EC_POINT_oct2point(group, pt, pub, len(pub), None):
            raise ValueError("point not on curve")
        if not _lib.EC_KEY_set_public_key(key, pt):
            raise ValueError("EC_KEY_set_public_key failed")
        # Generator multiples table: ~20% off every ECDSA_do_verify on
        # builds without the dedicated nistz256 path. Paid once per
        # creator key, amortized over millions of events.
        _lib.EC_KEY_precompute_mult(key, None)
    finally:
        _lib.EC_POINT_free(pt)
    return holder


def verify(pub: bytes, digest: bytes, r: int, s: int) -> bool:
    if not (1 <= r < N and 1 <= s < N):
        return False
    try:
        holder = _ec_key(pub)
    except ValueError:
        return False
    sig = _lib.ECDSA_SIG_new()
    if not sig:
        raise MemoryError("ECDSA_SIG_new failed")
    rb = r.to_bytes(32, "big")
    sb = s.to_bytes(32, "big")
    bn_r = _lib.BN_bin2bn(rb, 32, None)
    bn_s = _lib.BN_bin2bn(sb, 32, None)
    if not bn_r or not bn_s or not _lib.ECDSA_SIG_set0(sig, bn_r, bn_s):
        _lib.ECDSA_SIG_free(sig)
        raise MemoryError("ECDSA_SIG assembly failed")
    try:
        # set0 transferred BIGNUM ownership to sig.
        return _lib.ECDSA_do_verify(digest, len(digest), sig,
                                    holder.ptr) == 1
    finally:
        _lib.ECDSA_SIG_free(sig)


def verify_batch(pubs, digests, sigs):
    """Batched verify (docs/ingest.md "Crypto plane"): one EC_KEY
    lookup per distinct creator for the whole batch — grouping shares
    the deserialized key and its generator precompute table across the
    group instead of paying the LRU probe per event — then
    ECDSA_do_verify per signature (libcrypto has no multi-signature
    entry point; the win here is key-table reuse and one ctypes
    call per event instead of three). Verdicts are True/False, or None
    where the creator point is malformed (the case serial `verify`
    maps to False via `_ec_key` raising — batch callers need it
    distinct to re-raise at the serial position)."""
    n = len(pubs)
    verdicts: list = [False] * n
    by_pub: dict = {}
    for i, pub in enumerate(pubs):
        by_pub.setdefault(pub, []).append(i)
    for pub, idxs in by_pub.items():
        try:
            holder = _ec_key(pub)
        except ValueError:
            for i in idxs:
                verdicts[i] = None
            continue
        for i in idxs:
            r, s = sigs[i]
            if not (1 <= r < N and 1 <= s < N):
                continue
            sig = _lib.ECDSA_SIG_new()
            if not sig:
                raise MemoryError("ECDSA_SIG_new failed")
            bn_r = _lib.BN_bin2bn(r.to_bytes(32, "big"), 32, None)
            bn_s = _lib.BN_bin2bn(s.to_bytes(32, "big"), 32, None)
            if not bn_r or not bn_s or not _lib.ECDSA_SIG_set0(
                    sig, bn_r, bn_s):
                _lib.ECDSA_SIG_free(sig)
                raise MemoryError("ECDSA_SIG assembly failed")
            try:
                digest = digests[i]
                verdicts[i] = _lib.ECDSA_do_verify(
                    digest, len(digest), sig, holder.ptr) == 1
            finally:
                _lib.ECDSA_SIG_free(sig)
    return verdicts


def base_point_x(k: int) -> Optional[int]:
    """x-coordinate of k*G on P-256 (None at infinity) — the one
    expensive step of signing."""
    k %= N
    if not k:
        return None
    tmpl = _ec_key(_G_BYTES)  # any P-256 key: we only need its group
    group = _lib.EC_KEY_get0_group(tmpl.ptr)
    ctx = _lib.BN_CTX_new()
    bn_k = _lib.BN_bin2bn(k.to_bytes(32, "big"), 32, None)
    pt = _lib.EC_POINT_new(group)
    bx = _lib.BN_new()
    try:
        if not (ctx and bn_k and pt and bx):
            raise MemoryError("OpenSSL allocation failed")
        if not _lib.EC_POINT_mul(group, pt, bn_k, None, None, ctx):
            return None
        if not _lib.EC_POINT_get_affine_coordinates(group, pt, bx, None,
                                                    ctx):
            return None
        out = ctypes.create_string_buffer(32)
        if _lib.BN_bn2binpad(bx, out, 32) != 32:
            raise ValueError("BN_bn2binpad failed")
        return int.from_bytes(out.raw, "big")
    finally:
        if bx:
            _lib.BN_free(bx)
        if pt:
            _lib.EC_POINT_free(pt)
        if bn_k:
            _lib.BN_free(bn_k)
        if ctx:
            _lib.BN_CTX_free(ctx)


# Uncompressed G, used only to borrow a P-256 EC_GROUP for signing.
_G_BYTES = (
    b"\x04"
    + (0x6B17D1F2E12C4247F8BCE6E563A440F277037D812DEB33A0F4A13945D898C296
       ).to_bytes(32, "big")
    + (0x4FE342E2FE1A7F9B8EE7EB4A7C0F9E162BCE33576B315ECECBB6406837BF51F5
       ).to_bytes(32, "big")
)


def sign(d: int, digest: bytes) -> Tuple[int, int]:
    """RFC 6979 deterministic ECDSA — bit-identical to
    `_fallback.sign` (same nonce derivation, same arithmetic), with the
    k*G multiplication done by libcrypto."""
    from ._fallback import _rfc6979_k

    z = int.from_bytes(digest, "big") % N
    while True:
        k = _rfc6979_k(d, digest)
        x = base_point_x(k)
        if x is None:
            continue
        r = x % N
        if not r:
            continue
        s = pow(k, -1, N) * (z + r * d) % N
        if s:
            return r, s
        # Unreachable for P-256 in practice; spec-conformance retry.
        digest = hashlib.sha256(digest).digest()
