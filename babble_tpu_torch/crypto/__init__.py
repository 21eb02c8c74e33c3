from .keys import (
    BACKEND,
    generate_key,
    key_from_seed,
    pub_key_bytes,
    pub_key_from_bytes,
    pub_key_from_bytes_cached,
    sign,
    verify,
    verify_batch,
    sha256,
)
from .pem import PemKey, generate_pem_key, PemDump

__all__ = [
    "BACKEND",
    "generate_key",
    "key_from_seed",
    "pub_key_bytes",
    "pub_key_from_bytes",
    "pub_key_from_bytes_cached",
    "sign",
    "verify",
    "verify_batch",
    "sha256",
    "PemKey",
    "generate_pem_key",
    "PemDump",
]
