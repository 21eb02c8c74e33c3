"""PEM persistence of node keys.

Reference: crypto/pem_key.go:14-99 — `priv_key.pem` holding a SEC1
"EC PRIVATE KEY" block; `GeneratePemKey` returns the public key as
"0x"-prefixed uppercase hex of the uncompressed point plus the PEM text.

Works on either crypto backend (see keys.BACKEND): OpenSSL-backed keys
serialize through `cryptography`, the pure-Python fallback emits the
same RFC 5915 DER itself — the PEM files are interchangeable.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

from .keys import BACKEND, generate_key, pub_key_bytes

if BACKEND == "openssl":
    from cryptography.hazmat.primitives.asymmetric import ec
    from cryptography.hazmat.primitives.serialization import (
        Encoding,
        NoEncryption,
        PrivateFormat,
        load_pem_private_key,
    )
else:
    from . import _fallback as _fb

PEM_KEY_PATH = "priv_key.pem"


def _key_to_pem(key) -> bytes:
    if BACKEND == "openssl":
        # TraditionalOpenSSL for EC == SEC1 "EC PRIVATE KEY", same as Go
        # x509.MarshalECPrivateKey.
        return key.private_bytes(
            Encoding.PEM, PrivateFormat.TraditionalOpenSSL, NoEncryption())
    return _fb.key_to_pem(key)


def _key_from_pem(data: bytes):
    if BACKEND == "openssl":
        return load_pem_private_key(data, password=None)
    return _fb.key_from_pem(data)


class PemKey:
    def __init__(self, base: str):
        self.path = os.path.join(base, PEM_KEY_PATH)

    def read_key(self):
        with open(self.path, "rb") as f:
            data = f.read()
        return _key_from_pem(data)

    def write_key(self, key) -> None:
        with open(self.path, "wb") as f:
            f.write(_key_to_pem(key))


@dataclass
class PemDump:
    public_key: str
    private_key: str


def generate_pem_key() -> PemDump:
    key = generate_key()
    pub = "0x" + pub_key_bytes(key).hex().upper()
    return PemDump(public_key=pub, private_key=_key_to_pem(key).decode("ascii"))
