"""ECDSA P-256 + SHA-256, matching the reference crypto layer.

Reference: crypto/utils.go:11-44 — SHA-256 digests; ECDSA over NIST
P-256 with signatures as the (R, S) big-int pair; public keys serialized
as uncompressed X9.62 points (0x04||X||Y, 65 bytes — Go
elliptic.Marshal).

Backend selection, fastest available first — same wire formats,
signatures interchangeable, and the import never fails on a missing
optional dependency (`BACKEND` reports which one is active):

1. "openssl"        — the `cryptography` package when installed.
2. "openssl-ctypes" — no `cryptography`, but the SYSTEM libcrypto is
   loadable (it ships with CPython's ssl module almost everywhere):
   sign/verify route through `_openssl.py`'s ctypes binding while key
   objects stay the pure-Python ones, so PEM and serialization are
   untouched. ~60x faster than the fallback — the difference between
   ECDSA being the gossip ingest wall and being noise (docs/ingest.md).
3. "pure-python"    — `_fallback.py`, always works.
   `BABBLE_PURE_CRYPTO=1` forces this (CI's no-optional-deps job).
"""

from __future__ import annotations

import functools
import hashlib
from typing import Tuple

try:
    from cryptography.hazmat.primitives import hashes
    from cryptography.hazmat.primitives.asymmetric import ec
    from cryptography.hazmat.primitives.asymmetric.utils import (
        Prehashed,
        decode_dss_signature,
        encode_dss_signature,
    )
    from cryptography.hazmat.primitives.serialization import (
        Encoding,
        PublicFormat,
    )

    BACKEND = "openssl"
except ImportError:  # pure-Python fallback, no optional deps
    from . import _fallback as _fb

    BACKEND = "pure-python"

# P-256 group order: private scalars are in [1, N-1].
_P256_ORDER = 0xFFFFFFFF00000000FFFFFFFFFFFFFFFFBCE6FAADA7179E84F3B9CAC2FC632551


def sha256(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()


if BACKEND == "openssl":
    _CURVE = ec.SECP256R1()
    _PREHASHED = ec.ECDSA(Prehashed(hashes.SHA256()))

    def generate_key() -> ec.EllipticCurvePrivateKey:
        return ec.generate_private_key(_CURVE)

    def key_from_seed(seed: int) -> ec.EllipticCurvePrivateKey:
        """Deterministic key for tests/simulations (not in the
        reference, which always draws from crypto/rand)."""
        scalar = (seed % (_P256_ORDER - 1)) + 1
        return ec.derive_private_key(scalar, _CURVE)

    def pub_key_bytes(key: ec.EllipticCurvePrivateKey) -> bytes:
        """Uncompressed point, 65 bytes — same as Go elliptic.Marshal."""
        return key.public_key().public_bytes(
            Encoding.X962, PublicFormat.UncompressedPoint)

    def pub_key_from_bytes(pub: bytes) -> ec.EllipticCurvePublicKey:
        return ec.EllipticCurvePublicKey.from_encoded_point(_CURVE, pub)

    def sign(key: ec.EllipticCurvePrivateKey, digest: bytes) -> Tuple[int, int]:
        """Sign a precomputed digest; returns (R, S) — reference
        crypto/utils.go:38."""
        der = key.sign(digest, _PREHASHED)
        return decode_dss_signature(der)

    def verify(pub: ec.EllipticCurvePublicKey, digest: bytes,
               r: int, s: int) -> bool:
        try:
            pub.verify(encode_dss_signature(r, s), digest, _PREHASHED)
            return True
        except Exception:
            return False

    def verify_batch(pubs, digests, sigs):
        """Batched verify (docs/ingest.md "Crypto plane"): pubs are
        65-byte X9.62 encodings; verdicts are True/False, or None for a
        malformed creator point. Grouping by creator shares the parsed
        EllipticCurvePublicKey (and OpenSSL's per-key precompute)
        across the group — the wheel exposes no multi-signature verify,
        so per-signature calls remain."""
        n = len(pubs)
        verdicts: list = [False] * n
        by_pub: dict = {}
        for i, pub in enumerate(pubs):
            by_pub.setdefault(pub, []).append(i)
        for pub, idxs in by_pub.items():
            try:
                key = pub_key_from_bytes(pub)
            except Exception:
                for i in idxs:
                    verdicts[i] = None
                continue
            for i in idxs:
                verdicts[i] = verify(key, digests[i], *sigs[i])
        return verdicts

else:
    generate_key = _fb.generate_key
    key_from_seed = _fb.key_from_seed
    pub_key_bytes = _fb.pub_key_bytes
    pub_key_from_bytes = _fb.pub_key_from_bytes

    from . import _openssl as _ossl

    if _ossl.available():
        BACKEND = "openssl-ctypes"

        def sign(key: "_fb.PrivateKey", digest: bytes) -> Tuple[int, int]:
            return _ossl.sign(key.d, digest)

        def verify(pub: "_fb.PublicKey", digest: bytes,
                   r: int, s: int) -> bool:
            return _ossl.verify(pub.to_bytes(), digest, r, s)

        verify_batch = _ossl.verify_batch

    else:
        sign = _fb.sign
        verify = _fb.verify
        verify_batch = _fb.verify_batch


@functools.lru_cache(maxsize=1024)
def pub_key_from_bytes_cached(pub: bytes):
    """Keyed LRU over `pub_key_from_bytes`: a gossip network sees the
    same n creator keys on every one of millions of events, so parsing
    (and, on the pure-Python backend, window-table precompute) is paid
    once per creator, not once per event. Public-key objects are
    immutable on both backends, so sharing across threads is safe.
    Invalid encodings raise and are NOT cached (lru_cache does not
    memoize exceptions) — same error surface as the uncached call."""
    return pub_key_from_bytes(pub)
