"""The least time a kernel launch could take on one NVIDIA H100 SXM, from
the launch's shapes, and the published peaks it is taken against.

Peaks (NVIDIA's H100 SXM data sheet, at the 700 W limit): 67 TFLOP/s
in float32 outside the tensor cores, that is 132 SMs x 128 fp32 lanes x
1.98 GHz x 2; an int32 operation issues on half those lanes, so
132 x 64 x 1.98e9 int32 operations a second; 3.35 TB/s of HBM.

A launch's bound is the larger of its operations over the int32 rate
and its bytes over the HBM rate. The operations are those the
algorithm needs for these inputs. The bytes counted are only those
every implementation must move whatever it caches (the index arrays
read once, the output written once); the tables' rows are left out, so
the bound is never above the true least time and a share of it never
passes 100 % unless the time misses part of the work.
"""

from __future__ import annotations

SM_CLOCK_HZ = 1.98e9
INT32_OPS_PER_S = 132 * 64 * SM_CLOCK_HZ
HBM_BYTES_PER_S = 3.35e12


def strongly_see_bound_s(valid_pairs: int, n: int, m: int, mode: str) -> float:
    """B1 (csrc/strongly_see.cu): c[m, w] = #{i : x[m, i] >= f[w, i]}
    over the valid witness slots of each row, thresholded. Two int32
    operations (a compare and an add) per (row, valid witness, lane);
    the row and witness-row index arrays (int32 [M] each) read once, the
    output (uint8 [M, W] for "matrix", int32 [M] for "tally") written
    once."""
    ops_s = 2.0 * valid_pairs * n / INT32_OPS_PER_S
    out_bytes = valid_pairs if mode == "matrix" else 4 * m
    bytes_s = (8.0 * m + out_bytes) / HBM_BYTES_PER_S
    return max(ops_s, bytes_s)


def p256_bound_s(lanes: int, nonzero_digits: int) -> float:
    """B9 (csrc/p256.cu): u1*G + u2*Q by the 64-nibble dual-window
    ladder. Per lane 256 doublings of 8 field products, and 12 products
    per mixed add, one add per nonzero digit but the first (it meets the
    identity); a field product is 64 32x32->64-bit multiplies, two int32
    operations each; the reduction's adds are not counted. Bytes: the
    digits (2 x 64 int32) and the lane's window table (16 x 2 x 16
    int32) read once, X, Y and Z (3 x 16 int32) written once."""
    adds = max(nonzero_digits - lanes, 0)
    ops_s = (lanes * 256 * 8 + adds * 12) * 64 * 2 / INT32_OPS_PER_S
    bytes_s = lanes * 4.0 * (2 * 64 + 16 * 2 * 16 + 3 * 16) / HBM_BYTES_PER_S
    return max(ops_s, bytes_s)
