// The P-256 dual-window ladder of device ECDSA verify on Hopper (sm_90a).
//
//   (X, Y, Z)[b] = u1[b] * G + u2[b] * Q[b]     (Jacobian, fully reduced)
//
// for every lane b of a batch: n1/n2 int32 [B, 64] are the MSB-first
// 4-bit digits of u1 and u2, qwin int32 [B, 16, 2, 16] the lane's window
// table (entry i = i*Q affine, 16 limbs of 16 bits), gwin int32
// [16, 2, 16] the base point's. X, Y and Z come out as int32 [B, 16]
// limbs of 16 bits in [0, P).
//
// Replaces the jitted ladder of babble_tpu/ops/p256.py::_build_kernel
// (jax.jit(jax.vmap(dual_window_one))), XLA and not Pallas in the JAX
// package. The host prelude (range checks, s^-1, the digits) and
// epilogue (affine x, the verdict) stay on the host, as there.
//
// Exactness is the contract: the Jacobian representative equals the
// JAX kernel's limb for limb, so the point formulas are the same up to
// algebraic identity of each coordinate: dbl-2001-b, branchless (the
// identity (0, 1, 0) doubles to (0, P - 8, 0) there, and here too), and
// the mixed add with crypto/_fallback.py::_jac_add_affine's degeneracy
// semantics: an identity accumulator gives (x2, y2, 1); H = 0 with equal
// Y doubles; H = 0 with opposite Y gives (0, 1, 0); nibble 0 keeps the
// accumulator; the ladder starts from (0, 1, 0). (Z1 + H)^2 - Z1Z1 - H^2
// is computed as 2 Z1 H and (Y + Z)^2 - gamma - delta as 2 Y Z: the same
// field elements. The JAX kernel computes the degenerate doubling on
// every add for its select; here it runs only when H = 0.
//
// What bounds it: operations. Per signature 256 doublings (8 field
// products each) and up to 128 mixed adds (12 each), about 3,600 field
// products of 8x8 32-bit words = 64 32x32->64 multiplies (mul.wide.u32
// pairs: IMAD.WIDE/IMAD.HI) plus the Solinas reduction's adds, against
// at most 256 B of nibbles, 2 KB of Q table and 192 B of output read or
// written. At sync-batch sizes (tens to hundreds of signatures) one
// thread per signature fills a few SMs: the time is then one thread's
// serial chain of dependent field operations, not the card's rate.
//
// Design, right and simple first:
// - one thread runs one signature's whole ladder, the accumulator and
//   every temporary in registers (8 x 32-bit words per field element);
// - a product is the 8x8 schoolbook with 64-bit accumulation into 16
//   words, reduced by the NIST Solinas word formulas (FIPS 186-4 D.2.3)
//   in signed 64-bit accumulators, a carry sweep, a fold of the top
//   carry (2^256 = 2^224 - 2^192 - 2^96 + 1 mod P) and a second sweep
//   (top now -1, 0 or 1), one conditional +-P and a final conditional -P:
//   every field element leaves each operation in [0, P);
// - the base point's table lives in shared memory, loaded once per
//   block (lanes index it by different digits, which __constant__
//   memory would serialise); each lane reads its Q entries from global
//   memory as it needs them.
//
// Plain C entry point for ctypes: launches on the caller's stream,
// allocates nothing and returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;
constexpr int kWords = 8;
constexpr int kNibbles = 64;

__constant__ uint32_t kP[kWords] = {0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0u,
                                    0u,          0u,          1u,          0xFFFFFFFFu};

struct Fe {
  uint32_t w[kWords];
};

__device__ __forceinline__ bool fe_is_zero(const Fe& a) {
  uint32_t o = 0;
#pragma unroll
  for (int i = 0; i < kWords; ++i) o |= a.w[i];
  return o == 0;
}

__device__ __forceinline__ void fe_set_small(Fe& r, uint32_t v) {
  r.w[0] = v;
#pragma unroll
  for (int i = 1; i < kWords; ++i) r.w[i] = 0;
}

// w -= P in place when take; the borrow out is dropped (the caller knows
// the result lies in [0, 2^256)).
__device__ __forceinline__ void sub_p_if(uint32_t w[kWords], bool take) {
  int64_t br = 0;
  uint32_t d[kWords];
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    const int64_t v = (int64_t)w[i] - kP[i] + br;
    d[i] = (uint32_t)v;
    br = v >> 32;
  }
#pragma unroll
  for (int i = 0; i < kWords; ++i) w[i] = take ? d[i] : w[i];
}

// w += P in place when take; the carry out is dropped.
__device__ __forceinline__ void add_p_if(uint32_t w[kWords], bool take) {
  const uint32_t mask = take ? 0xFFFFFFFFu : 0u;
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    c += (uint64_t)w[i] + (kP[i] & mask);
    w[i] = (uint32_t)c;
    c >>= 32;
  }
}

// w >= P, for w in [0, 2^256).
__device__ __forceinline__ bool ge_p(const uint32_t w[kWords]) {
  int64_t br = 0;
#pragma unroll
  for (int i = 0; i < kWords; ++i) br = ((int64_t)w[i] - kP[i] + br) >> 32;
  return br == 0;
}

// r = a + b mod P.
__device__ __forceinline__ void fe_add(Fe& r, const Fe& a, const Fe& b) {
  uint32_t s[kWords];
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    c += (uint64_t)a.w[i] + b.w[i];
    s[i] = (uint32_t)c;
    c >>= 32;
  }
  // s + c 2^256 < 2P: subtract P when it carried out or s >= P.
  sub_p_if(s, c != 0 || ge_p(s));
#pragma unroll
  for (int i = 0; i < kWords; ++i) r.w[i] = s[i];
}

// r = a - b mod P.
__device__ __forceinline__ void fe_sub(Fe& r, const Fe& a, const Fe& b) {
  uint32_t d[kWords];
  int64_t br = 0;
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    const int64_t v = (int64_t)a.w[i] - b.w[i] + br;
    d[i] = (uint32_t)v;
    br = v >> 32;
  }
  add_p_if(d, br != 0);
#pragma unroll
  for (int i = 0; i < kWords; ++i) r.w[i] = d[i];
}

// r = t mod P for a 512-bit t (16 words).
__device__ __forceinline__ void fe_reduce(Fe& r, const uint32_t t[16]) {
  int64_t a[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) a[i] = t[i];
  int64_t acc[kWords];
  acc[0] = a[0] + a[8] + a[9] - a[11] - a[12] - a[13] - a[14];
  acc[1] = a[1] + a[9] + a[10] - a[12] - a[13] - a[14] - a[15];
  acc[2] = a[2] + a[10] + a[11] - a[13] - a[14] - a[15];
  acc[3] = a[3] - a[8] - a[9] + 2 * a[11] + 2 * a[12] + a[13] - a[15];
  acc[4] = a[4] - a[9] - a[10] + 2 * a[12] + 2 * a[13] + a[14];
  acc[5] = a[5] - a[10] - a[11] + 2 * a[13] + 2 * a[14] + a[15];
  acc[6] = a[6] - a[8] - a[9] + a[13] + 3 * a[14] + 2 * a[15];
  acc[7] = a[7] + a[8] - a[10] - a[11] - a[12] - a[13] + 3 * a[15];
  // The value is T + 2 S1 + 2 S2 + S3 + S4 - D1 - D2 - D3 - D4 with every
  // term in [0, 2^256): in (-4, 7) 2^256, so the top carry is in [-4, 6].
  uint32_t w[kWords];
  int64_t c = 0;
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    const int64_t v = acc[i] + c;
    w[i] = (uint32_t)v;
    c = v >> 32;  // arithmetic shift: floor division
  }
  // Fold c 2^256 = c (2^224 - 2^192 - 2^96 + 1): the value lies in
  // (-4 2^224, 2^256 + 6 2^224), so the new top carry is -1, 0 or 1.
  int64_t f[kWords] = {(int64_t)w[0] + c, w[1], w[2], (int64_t)w[3] - c,
                       w[4], w[5], (int64_t)w[6] - c, (int64_t)w[7] + c};
  int64_t c2 = 0;
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    const int64_t v = f[i] + c2;
    w[i] = (uint32_t)v;
    c2 = v >> 32;
  }
  // Negative: + P lands in (0, P). Past 2^256: - P lands below P. Else in
  // [0, 2^256): one conditional - P.
  add_p_if(w, c2 < 0);
  sub_p_if(w, c2 > 0);
  sub_p_if(w, c2 == 0 && ge_p(w));
#pragma unroll
  for (int i = 0; i < kWords; ++i) r.w[i] = w[i];
}

// r = a b mod P.
__device__ __forceinline__ void fe_mul(Fe& r, const Fe& a, const Fe& b) {
  uint32_t t[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) t[i] = 0;
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < kWords; ++j) {
      c += (uint64_t)a.w[i] * b.w[j] + t[i + j];  // < 2^64
      t[i + j] = (uint32_t)c;
      c >>= 32;
    }
    t[i + kWords] = (uint32_t)c;
  }
  fe_reduce(r, t);
}

__device__ __forceinline__ void fe_sqr(Fe& r, const Fe& a) { fe_mul(r, a, a); }

// dbl-2001-b, branchless: Y = 0 and the identity give Z3 = 0 by the
// formulas themselves, as in the JAX kernel.
__device__ __forceinline__ void jac_double(Fe& X, Fe& Y, Fe& Z) {
  Fe delta, gamma, beta, t, u, alpha, b4, x3;
  fe_sqr(delta, Z);
  fe_sqr(gamma, Y);
  fe_mul(beta, X, gamma);
  fe_sub(t, X, delta);
  fe_add(u, X, delta);
  fe_mul(t, t, u);
  fe_add(alpha, t, t);
  fe_add(alpha, alpha, t);          // 3 t
  fe_add(b4, beta, beta);
  fe_add(b4, b4, b4);               // 4 beta
  fe_sqr(x3, alpha);
  fe_add(u, b4, b4);                // 8 beta
  fe_sub(x3, x3, u);
  fe_mul(u, Y, Z);
  fe_add(Z, u, u);                  // (Y + Z)^2 - gamma - delta = 2 Y Z
  fe_sqr(u, gamma);
  fe_add(u, u, u);
  fe_add(u, u, u);
  fe_add(u, u, u);                  // 8 gamma^2
  fe_sub(t, b4, x3);
  fe_mul(t, alpha, t);
  fe_sub(Y, t, u);
  X = x3;
}

// Mixed add (Z2 = 1) with _fallback._jac_add_affine's degeneracies.
__device__ __forceinline__ void jac_add_affine(Fe& X, Fe& Y, Fe& Z, const Fe& x2,
                                               const Fe& y2) {
  if (fe_is_zero(Z)) {  // identity accumulator
    X = x2;
    Y = y2;
    fe_set_small(Z, 1);
    return;
  }
  Fe z1z1, u2, s2, h, r2, i, j, v, t;
  fe_sqr(z1z1, Z);
  fe_mul(u2, x2, z1z1);
  fe_mul(s2, y2, Z);
  fe_mul(s2, s2, z1z1);
  fe_sub(h, u2, X);
  fe_sub(r2, s2, Y);
  if (fe_is_zero(h)) {
    if (fe_is_zero(r2)) {  // the same point: double it
      jac_double(X, Y, Z);
    } else {               // opposite points: the identity
      fe_set_small(X, 0);
      fe_set_small(Y, 1);
      fe_set_small(Z, 0);
    }
    return;
  }
  fe_add(r2, r2, r2);               // r = 2 (S2 - Y1)
  fe_add(t, h, h);
  fe_sqr(i, t);                     // I = (2H)^2
  fe_mul(j, h, i);                  // J = H I
  fe_mul(v, X, i);                  // V = X1 I
  fe_mul(Z, Z, h);
  fe_add(Z, Z, Z);                  // (Z1 + H)^2 - Z1Z1 - H^2 = 2 Z1 H
  fe_sqr(t, r2);
  fe_sub(t, t, j);
  fe_add(u2, v, v);
  fe_sub(t, t, u2);                 // X3 = r^2 - J - 2V
  fe_mul(s2, Y, j);
  fe_add(s2, s2, s2);               // 2 Y1 J
  fe_sub(v, v, t);
  fe_mul(v, r2, v);
  fe_sub(Y, v, s2);                 // Y3 = r (V - X3) - 2 Y1 J
  X = t;
}

__device__ __forceinline__ Fe load_entry(const int32_t* limbs) {
  Fe r;
#pragma unroll
  for (int k = 0; k < kWords; ++k)
    r.w[k] = ((uint32_t)limbs[2 * k] & 0xFFFFu) | ((uint32_t)limbs[2 * k + 1] << 16);
  return r;
}

__device__ __forceinline__ void store_fe(int32_t* out, const Fe& a) {
#pragma unroll
  for (int k = 0; k < kWords; ++k) {
    out[2 * k] = (int32_t)(a.w[k] & 0xFFFFu);
    out[2 * k + 1] = (int32_t)(a.w[k] >> 16);
  }
}

__global__ void __launch_bounds__(kThreads)
p256_dual_window_kernel(const int32_t* __restrict__ n1, const int32_t* __restrict__ n2,
                        const int32_t* __restrict__ qwin, const int32_t* __restrict__ gwin,
                        int32_t* __restrict__ X_out, int32_t* __restrict__ Y_out,
                        int32_t* __restrict__ Z_out, int b) {
  __shared__ uint32_t g_tab[16 * 2 * kWords];
  for (int k = threadIdx.x; k < 16 * 2 * kWords; k += blockDim.x)
    g_tab[k] = ((uint32_t)gwin[2 * k] & 0xFFFFu) | ((uint32_t)gwin[2 * k + 1] << 16);
  __syncthreads();
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= b) return;

  const int32_t* d1 = n1 + (size_t)lane * kNibbles;
  const int32_t* d2 = n2 + (size_t)lane * kNibbles;
  const int32_t* q = qwin + (size_t)lane * (16 * 2 * 16);
  Fe X, Y, Z;
  fe_set_small(X, 0);
  fe_set_small(Y, 1);
  fe_set_small(Z, 0);
#pragma unroll 1
  for (int i = 0; i < kNibbles; ++i) {
#pragma unroll 1
    for (int k = 0; k < 4; ++k) jac_double(X, Y, Z);
    const int g = d1[i] & 0xF;
    if (g != 0) {
      Fe x2, y2;
#pragma unroll
      for (int k = 0; k < kWords; ++k) {
        x2.w[k] = g_tab[(g * 2) * kWords + k];
        y2.w[k] = g_tab[(g * 2 + 1) * kWords + k];
      }
      jac_add_affine(X, Y, Z, x2, y2);
    }
    const int h = d2[i] & 0xF;
    if (h != 0) {
      const Fe x2 = load_entry(q + (h * 2) * 16);
      const Fe y2 = load_entry(q + (h * 2 + 1) * 16);
      jac_add_affine(X, Y, Z, x2, y2);
    }
  }
  store_fe(X_out + (size_t)lane * 16, X);
  store_fe(Y_out + (size_t)lane * 16, Y);
  store_fe(Z_out + (size_t)lane * 16, Z);
}

}  // namespace

extern "C" int babble_p256_dual_window(const int32_t* n1, const int32_t* n2,
                                       const int32_t* qwin, const int32_t* gwin,
                                       int32_t* X, int32_t* Y, int32_t* Z, int b,
                                       void* stream) {
  if (b <= 0) return 0;
  const int blocks = (b + kThreads - 1) / kThreads;
  p256_dual_window_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      n1, n2, qwin, gwin, X, Y, Z, b);
  return (int)cudaGetLastError();
}
