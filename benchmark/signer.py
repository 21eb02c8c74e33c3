"""RFC 6979 ECDSA P-256 over SHA-256, with the k*G multiplication in the
system's libcrypto through ctypes.

The nonce derivation and the (r, s) arithmetic follow RFC 6979 section
3.2 and the ECDSA definition; the signatures are bit-identical to any
other RFC 6979 signer of the same key and digest. A signer keeps one
BN_CTX, point and set of bignums: use it from one thread.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import hashlib
import hmac
from typing import List, Tuple

N = 0xFFFFFFFF00000000FFFFFFFFFFFFFFFFBCE6FAADA7179E84F3B9CAC2FC632551
_NID_P256 = 415  # NID_X9_62_prime256v1

_PROTO = {
    "EC_GROUP_new_by_curve_name": (ctypes.c_void_p, [ctypes.c_int]),
    "EC_POINT_new": (ctypes.c_void_p, [ctypes.c_void_p]),
    "EC_POINT_mul": (ctypes.c_int, [ctypes.c_void_p] * 6),
    "EC_POINT_get_affine_coordinates": (ctypes.c_int, [ctypes.c_void_p] * 5),
    "BN_bin2bn": (ctypes.c_void_p, [ctypes.c_char_p, ctypes.c_int, ctypes.c_void_p]),
    "BN_new": (ctypes.c_void_p, []),
    "BN_bn2binpad": (ctypes.c_int, [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]),
    "BN_CTX_new": (ctypes.c_void_p, []),
}


def _load():
    name = ctypes.util.find_library("crypto")
    for cand in [name, "libcrypto.so.3", "libcrypto.so.1.1", "libcrypto.so"]:
        if not cand:
            continue
        try:
            lib = ctypes.CDLL(cand)
        except OSError:
            continue
        for sym, (res, args) in _PROTO.items():
            fn = getattr(lib, sym)
            fn.restype, fn.argtypes = res, args
        return lib
    raise RuntimeError("libcrypto not found")


class Signer:
    """k*G on P-256 through libcrypto, with scratch objects kept for the
    life of the signer."""

    def __init__(self):
        lib = self._lib = _load()
        self._group = lib.EC_GROUP_new_by_curve_name(_NID_P256)
        if not self._group:
            raise RuntimeError("EC_GROUP_new_by_curve_name failed")
        self._s = (lib.BN_CTX_new(), lib.EC_POINT_new(self._group),
                   lib.BN_new(), lib.BN_new(), lib.BN_new(),
                   ctypes.create_string_buffer(32))
        if not all(self._s[:5]):
            raise MemoryError("libcrypto allocation failed")

    def base_mult(self, k: int, want_y: bool = False):
        """The affine x of k*G (and y with `want_y`), for 1 <= k < N."""
        lib = self._lib
        ctx, pt, bk, bx, by, buf = self._s
        if not lib.BN_bin2bn(k.to_bytes(32, "big"), 32, bk):
            raise MemoryError("BN_bin2bn failed")
        if not lib.EC_POINT_mul(self._group, pt, bk, None, None, ctx):
            raise RuntimeError("EC_POINT_mul failed")
        if not lib.EC_POINT_get_affine_coordinates(
                self._group, pt, bx, by if want_y else None, ctx):
            raise RuntimeError("EC_POINT_get_affine_coordinates failed")
        lib.BN_bn2binpad(bx, buf, 32)
        x = int.from_bytes(buf.raw, "big")
        if not want_y:
            return x
        lib.BN_bn2binpad(by, buf, 32)
        return x, int.from_bytes(buf.raw, "big")

    def pub_bytes(self, d: int) -> bytes:
        """Uncompressed X9.62 public key of the scalar d (65 bytes)."""
        x, y = self.base_mult(d, want_y=True)
        return b"\x04" + x.to_bytes(32, "big") + y.to_bytes(32, "big")

    def sign_batch(self, keys: List[int], digests: List[bytes]) -> List[Tuple[int, int]]:
        """sign(d, digest) for each pair, with one modular inversion for
        the whole batch (Montgomery's trick)."""
        ks = [rfc6979_k(d, h) for d, h in zip(keys, digests)]
        rs = [self.base_mult(k) % N for k in ks]
        if not all(rs):  # unreachable for P-256 in practice
            return [self.sign(d, h) for d, h in zip(keys, digests)]
        prefix, acc = [], 1
        for k in ks:
            prefix.append(acc)
            acc = acc * k % N
        inv = pow(acc, -1, N)
        out = [None] * len(ks)
        for i in range(len(ks) - 1, -1, -1):
            k_inv = inv * prefix[i] % N
            inv = inv * ks[i] % N
            d = keys[i]
            s = k_inv * (int.from_bytes(digests[i], "big") % N + rs[i] * d) % N
            out[i] = (rs[i], s) if s else self.sign(d, digests[i])
        return out

    def sign(self, d: int, digest: bytes) -> Tuple[int, int]:
        z = int.from_bytes(digest, "big") % N
        while True:
            k = rfc6979_k(d, digest)
            r = self.base_mult(k) % N
            if r:
                s = pow(k, -1, N) * (z + r * d) % N
                if s:
                    return r, s
            digest = hashlib.sha256(digest).digest()


def rfc6979_k(d: int, digest: bytes) -> int:
    """Deterministic nonce (RFC 6979 section 3.2) for SHA-256 / P-256."""
    z = int.from_bytes(digest, "big") % N
    bx = d.to_bytes(32, "big") + z.to_bytes(32, "big")
    mac = hmac.digest
    v = b"\x01" * 32
    k = mac(b"\x00" * 32, v + b"\x00" + bx, "sha256")
    v = mac(k, v, "sha256")
    k = mac(k, v + b"\x01" + bx, "sha256")
    v = mac(k, v, "sha256")
    while True:
        v = mac(k, v, "sha256")
        cand = int.from_bytes(v, "big")
        if 1 <= cand < N:
            return cand
        k = mac(k, v + b"\x00", "sha256")
        v = mac(k, v, "sha256")
