"""Go `encoding/json`-compatible marshaling.

Event hashes in the reference are SHA-256 over Go's JSON encoding of the
event body / event struct (reference hashgraph/event.go:30-54,155-180), and
those hash bytes feed consensus-visible decisions: the coin-flip middle bit
(reference hashgraph/hashgraph.go:1039-1048) and the famous-witness XOR PRN
(reference hashgraph/roundInfo.go:100-110). Byte-identical marshaling is
therefore required for order parity, so this module reproduces the exact
byte output of Go's json.Encoder for the subset of shapes babble uses:

- structs   -> fields in declaration order (model with GoStruct field lists)
- []byte    -> std base64 string; nil slice -> null
- [][]byte  -> array of base64 strings; nil -> null
- string    -> Go JSON string escaping incl. HTML escaping (<,>,& -> \\u00XX)
- int/bool  -> literals; big.Int -> arbitrary-precision number literal
- time.Time -> RFC3339Nano string (trailing fractional zeros trimmed, "Z")
- maps      -> keys sorted lexicographically by their string form
- json.Encoder.Encode appends a trailing newline -> marshal(...) does too.
"""

from __future__ import annotations

import base64
import datetime
import re
from typing import Any, List, Sequence, Tuple

_ESCAPES = {
    '"': '\\"',
    "\\": "\\\\",
    "\n": "\\n",
    "\r": "\\r",
    "\t": "\\t",
    "<": "\\u003c",
    ">": "\\u003e",
    "&": "\\u0026",
}

_GO_EPOCH = datetime.datetime(1970, 1, 1)


_NEEDS_ESCAPE = re.compile(r'[\x00-\x1f"\\<>&]')


def _escape_string(s: str) -> str:
    # Fast path: hashes, hex ids, and base64 payloads — the bulk of
    # what event marshaling escapes — never contain escapable chars,
    # and the per-char loop below dominated the host insert profile
    # (4.3s of a 13s 16-node gossip run).
    if _NEEDS_ESCAPE.search(s) is None:
        return '"' + s + '"'
    out = []
    for ch in s:
        esc = _ESCAPES.get(ch)
        if esc is not None:
            out.append(esc)
        elif ord(ch) < 0x20:
            out.append("\\u%04x" % ord(ch))
        else:
            # Go writes valid non-ASCII UTF-8 through unescaped.
            out.append(ch)
    return '"' + "".join(out) + '"'


class BigInt(int):
    """Marker for values that marshal as arbitrary-precision JSON numbers
    (Go math/big.Int)."""


class Timestamp:
    """A Go time.Time with nanosecond resolution, always UTC.

    Stored as integer nanoseconds since the Unix epoch (may be far
    negative: Go's zero time is year 1). Comparison mirrors
    time.Time.Before/After on wall-clock time.
    """

    __slots__ = ("ns",)

    def __init__(self, ns: int):
        self.ns = int(ns)

    @classmethod
    def now(cls) -> "Timestamp":
        now = datetime.datetime.now(datetime.timezone.utc)
        # Compute from integer components to avoid float rounding.
        sec = int(now.replace(microsecond=0).timestamp())
        return cls(sec * 1_000_000_000 + now.microsecond * 1000)

    def rfc3339nano(self) -> str:
        sec, nanos = divmod(self.ns, 1_000_000_000)
        dt = _GO_EPOCH + datetime.timedelta(seconds=sec)
        base = (
            f"{dt.year:04d}-{dt.month:02d}-{dt.day:02d}"
            f"T{dt.hour:02d}:{dt.minute:02d}:{dt.second:02d}"
        )
        if nanos:
            frac = f"{nanos:09d}".rstrip("0")
            base += "." + frac
        return base + "Z"

    @classmethod
    def parse(cls, s: str) -> "Timestamp":
        if s.endswith("Z"):
            body, offset_ns = s[:-1], 0
        else:
            # ±HH:MM offset
            sign = 1 if s[-6] == "+" else -1
            hh, mm = int(s[-5:-3]), int(s[-2:])
            offset_ns = sign * (hh * 3600 + mm * 60) * 1_000_000_000
            body = s[:-6]
        if "." in body:
            main, frac = body.split(".")
            nanos = int(frac.ljust(9, "0")[:9])
        else:
            main, nanos = body, 0
        dt = datetime.datetime.strptime(main, "%Y-%m-%dT%H:%M:%S")
        sec = int((dt - _GO_EPOCH).total_seconds())
        return cls(sec * 1_000_000_000 + nanos - offset_ns)

    def __eq__(self, other) -> bool:
        return isinstance(other, Timestamp) and self.ns == other.ns

    def __lt__(self, other: "Timestamp") -> bool:
        return self.ns < other.ns

    def __le__(self, other: "Timestamp") -> bool:
        return self.ns <= other.ns

    def __hash__(self) -> int:
        return hash(self.ns)

    def __repr__(self) -> str:
        return f"Timestamp({self.rfc3339nano()})"


ZERO_TIME = Timestamp(-62135596800 * 1_000_000_000)  # Go zero time: 0001-01-01T00:00:00Z


class GoStruct:
    """Base for Go-struct-like records: marshal exported fields in
    declaration order. Subclasses define `go_fields` as a sequence of
    (json_name, attr_name) pairs."""

    go_fields: Sequence[Tuple[str, str]] = ()

    @classmethod
    def _field_plan(cls):
        # Escaped field-name prefixes are per-class constants.
        plan = cls.__dict__.get("_go_field_plan")
        if plan is None:
            plan = [(_escape_string(name) + ":", attr)
                    for name, attr in cls.go_fields]
            cls._go_field_plan = plan
        return plan

    def marshal_value(self) -> str:
        parts = [
            pre + _marshal_value(getattr(self, attr))
            for pre, attr in self._field_plan()
        ]
        return "{" + ",".join(parts) + "}"


def _marshal_value(v: Any) -> str:
    if v is None:
        return "null"
    if isinstance(v, GoStruct):
        return v.marshal_value()
    if isinstance(v, Timestamp):
        return '"' + v.rfc3339nano() + '"'
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):  # includes BigInt
        return str(v)
    if isinstance(v, (bytes, bytearray)):
        return _escape_string(base64.b64encode(bytes(v)).decode("ascii"))
    if isinstance(v, str):
        return _escape_string(v)
    if isinstance(v, (list, tuple)):
        return "[" + ",".join(_marshal_value(x) for x in v) + "]"
    if isinstance(v, dict):
        keys = [(str(k), k) for k in v]
        keys.sort(key=lambda p: p[0])
        return "{" + ",".join(
            f"{_escape_string(sk)}:{_marshal_value(v[k])}" for sk, k in keys
        ) + "}"
    raise TypeError(f"cannot Go-marshal {type(v)!r}")


def marshal(v: Any) -> bytes:
    """Equivalent of json.NewEncoder(&b).Encode(v): value + '\\n'."""
    return (_marshal_value(v) + "\n").encode("utf-8")


def b64decode_opt(v: Any):
    if v is None:
        return None
    return base64.b64decode(v)


def decode_byte_slices(v: Any) -> List[bytes] | None:
    if v is None:
        return None
    return [base64.b64decode(x) for x in v]
