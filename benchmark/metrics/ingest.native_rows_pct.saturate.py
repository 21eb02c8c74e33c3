"""Share of the rows read from the wire that the native columnar reader
built (%): the Core's from_wire_native calls (rows the native call
encoded and hashed) over its from_wire_rows calls (every row
read_wire_batch materialized). 0 where the reader's library did not
load; left out where the program counts no from_wire_rows."""


def read(rec):
    ph = rec.get("phase_ns") or {}
    rows = ph.get("from_wire_rows")
    if not rows or not rows[1]:
        return None
    return 100.0 * ph.get("from_wire_native", [0, 0])[1] / rows[1]
