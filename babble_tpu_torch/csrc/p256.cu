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
// epilogue (the verdict) stay on the host, as there.
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
// field elements. Every field element leaves each operation in [0, P),
// so any correct field arithmetic gives the same words.
//
// What bounds it. Per signature 256 doublings (8 field products each)
// and 128 mixed adds (12 each): ~3,600 products of 256-bit numbers,
// against at most 2.5 KB read and 192 B written. A sync batch is tens
// of signatures, far too few lanes for the card's rate: the time is one
// signature's chain of dependent field operations. One thread per
// signature (the first version of this file) ran each product as one
// lane's serial chain of dependent word operations.
//
// Design: a team of 8 lanes per signature, 4 signatures a warp.
// - Lane k holds 32-bit word k of every field element: the accumulator
//   X, Y, Z and every temporary. The base point's table lives in shared
//   memory, loaded once per block; lane k reads word k of the entry its
//   digit names, so a team's 8 reads are neighbouring words; each team
//   reads its Q entries from global memory the same way.
// - Carries never ripple lane by lane. Where each lane's word carries at
//   most one bit out, one ballot of the carries (generate) and one of the
//   all-ones words (propagate) give every lane its carry in by one 9-bit
//   add, as a carry-lookahead adder does: in = ((G << 1) + Pr) ^ Pr, the
//   team's carry out is bit 8. a - b is a + ~b + 1; a sum or difference
//   is settled that way, then its conditional -P (+F dropping 2^256) or
//   +P the same way (fe_addsub).
// - A product: in step j lane k takes a word (k - j) mod 8 and b word j
//   by shuffles (all 15 independent of one another) and adds the 64-bit
//   product into its own column, k or k + 8: no partial sum moves
//   between steps. One rotation by a lane brings each column its high
//   halves and one more its carries (< 16), leaving every column below
//   2^32 + 16: a word, and a carry bit that one ballot per half shares.
// - Solinas (FIPS 186-4 D.2.3): lane j forms its row j of the word sums
//   from the 8 upper columns (broadcast), with the coefficients plus one
//   (unsigned, 32 x 32 -> 64 multiply-adds) less the plain sum, the
//   carry bits by popcounts, plus 5P written with every word in [2^34,
//   2^34 + 2^32), so every row is non-negative and below 2^36 before the
//   split; each lane also forms row 7, so the top estimate q = row7 >> 32
//   needs no shuffle. fe_reduce subtracts q P as q 2^256 - q F (F = 2^256
//   - P, all words >= 0), moves every lane's excess one lane up (one
//   shuffle) and settles by the lookahead; the correction left (+ F when
//   the value still reached 2^256, - P when it is >= P) is rare and runs
//   only in a warp that needs it. Small multiples (3t, 4 beta, 8 beta,
//   8 gamma) go through the same fe_reduce.
// - Every shuffle and ballot is a whole-warp one (the team's lanes picked
//   by the shuffle width and the ballot's byte), and the warp's teams
//   never diverge: the ladder is branch-free (a zero digit, the identity
//   accumulator and H = 0 are selects on the team's ballots), but for
//   an add that meets the accumulator's own point, which the whole warp
//   then doubles by one warp vote, and the rare fix-up above. A team past
//   the batch runs the last signature's ladder and stores nothing. (With
//   per-team masks and per-team branches, a first version of this design
//   ran the four teams of a warp one after another on the H100.)
// - Independent field operations go together (fe_mul<N> and the like
//   interleave their steps): shuffles and ballots keep their program
//   order, so two products overlap only where the source interleaves
//   them.
// - What bounds it now: one warp per SM scheduler issues each lane's
//   instructions one after another, about 260 a product on the 16-lane
//   integer pipes (two cycles a warp instruction), with shuffle and
//   ballot results ~30 cycles away; see PERF.md for the measured times.
// - Launch shape: B / 4 warps. One warp a block while that fills at most
//   4 warps an SM (one per scheduler), so a small batch spreads over as
//   many SMs as it has warps; above that ceil(warps / (4 SMs)) warps a
//   block, at most 8 (256 threads).
//
// Plain C entry point for ctypes: launches on the caller's stream,
// allocates nothing and returns the CUDA error of the launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTeam = 8;                        // lanes per signature
constexpr int kTeamsPerWarp = 32 / kTeam;
constexpr int kWarpsPerSmSpread = 4;            // one warp per scheduler
constexpr int kMaxWarpsPerBlock = 8;
constexpr int kNibbles = 64;
constexpr uint32_t kWarp = 0xFFFFFFFFu;

// Word k of P and of F = 2^256 - P = 2^224 - 2^192 - 2^96 + 1.
__constant__ uint32_t kP[kTeam] = {0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0u,
                                   0u,          0u,          1u,          0xFFFFFFFFu};
__constant__ uint32_t kF[kTeam] = {1u, 0u, 0u, 0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu,
                                   0xFFFFFFFEu, 0u};
// kSolinas[j][i]: the coefficient of the product's word 8 + i in result
// word j (word j itself has coefficient 1): T + 2 S1 + 2 S2 + S3 + S4 -
// D1 - D2 - D3 - D4 (ops/p256.py's _SOLINAS, columns 8-15).
__constant__ int kSolinas[kTeam][kTeam] = {
    { 1,  1,  0, -1, -1, -1, -1,  0},
    { 0,  1,  1,  0, -1, -1, -1, -1},
    { 0,  0,  1,  1,  0, -1, -1, -1},
    {-1, -1,  0,  2,  2,  1,  0, -1},
    { 0, -1, -1,  0,  2,  2,  1,  0},
    { 0,  0, -1, -1,  0,  2,  2,  1},
    {-1, -1,  0,  0,  0,  1,  3,  2},
    { 1,  0, -1, -1, -1, -1,  0,  3},
};
// 5 P with word k in [2^34, 2^34 + 2^32): sum_k kFiveP[k] 2^(32 k) = 5 P.
// A product's columns are below 2^32 + 16 when the Solinas rows are
// formed, and each row loses at most 4 such columns to its negative
// terms (3 in rows 3 and 6, whose word is exactly 2^34), so adding word
// k keeps row k non-negative.
__constant__ uint64_t kFiveP[kTeam] = {0x4FFFFFFFBull, 0x4FFFFFFFBull, 0x4FFFFFFFBull,
                                       0x400000000ull, 0x4FFFFFFFCull, 0x4FFFFFFFBull,
                                       0x400000000ull, 0x4FFFFFFF7ull};

// One lane of a team: its word index, its team's byte of a ballot, and
// its words of the constants (read once, at the kernel's start).
struct Team {
  int k;            // lane in the team: word k of every field element
  uint32_t byte;    // __byte_perm selector of the team's byte of a ballot
  uint32_t p, f;    // word k of P and of F
  uint64_t five;    // word k of 5P
  uint32_t row;     // kSolinas[k][i] + 1 (in [0, 4]) as 8 nibbles
  uint32_t bit[3];  // bit b of those: the mask of the i that have it
  uint32_t bit7[3]; // the same for row 7
};

__device__ __forceinline__ Team make_team() {
  Team t;
  t.k = threadIdx.x & (kTeam - 1);
  t.byte = 0x4440u | (threadIdx.x & 31) / kTeam;
  t.p = kP[t.k];
  t.f = kF[t.k];
  t.five = kFiveP[t.k];
  t.row = 0;
#pragma unroll
  for (int b = 0; b < 3; ++b) t.bit[b] = t.bit7[b] = 0;
#pragma unroll
  for (int i = 0; i < kTeam; ++i) {
    const uint32_t c = kSolinas[t.k][i] + 1, c7 = kSolinas[kTeam - 1][i] + 1;
    t.row |= c << (4 * i);
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      t.bit[b] |= (c >> b & 1) << i;
      t.bit7[b] |= (c7 >> b & 1) << i;
    }
  }
  return t;
}

// -- team primitives: the only cross-lane operations ---------------------

// Whole-warp operations: the team's lanes are picked by the width (8) of
// the shuffles and by the byte of the ballot. The ladder never lets the
// warp's lanes diverge (see the kernel), so all 32 are always there.
__device__ __forceinline__ uint32_t shfl(const Team&, uint32_t v, int src) {
  return __shfl_sync(kWarp, v, src, kTeam);
}

__device__ __forceinline__ uint32_t shfl_up1(const Team&, uint32_t v) {
  return __shfl_up_sync(kWarp, v, 1, kTeam);
}

// The team's 8 predicate bits, lane 0 in bit 0.
__device__ __forceinline__ uint32_t ballot(const Team& t, bool p) {
  return __byte_perm(__ballot_sync(kWarp, p), 0, t.byte);
}

// -- field arithmetic: lane k holds word k --------------------------------
//
// Every operation takes N independent field elements (N = 1 to 4) and
// runs them step by step together: shuffles and ballots keep their
// program order on the card, so independent operations overlap only
// where the source interleaves their steps.

template <int N>
struct Fe {
  uint32_t w[N];
};

// The N values w + c 2^32 (plus cin at word 0), c in {0, 1} and
// w != 2^32 - 1 where c = 1 (true of any a + b), settled: every lane's
// carry in comes from one ballot of the carries (generate) and one of
// the all-ones words (propagate). `out`: the carry out of 2^256.
template <int N>
__device__ __forceinline__ Fe<N> settle(const Team& t, Fe<N> w, const bool (&c)[N],
                                        const bool (&cin)[N], bool (&out)[N]) {
  uint32_t g[N], pr[N];
#pragma unroll
  for (int n = 0; n < N; ++n) g[n] = ballot(t, c[n]);
#pragma unroll
  for (int n = 0; n < N; ++n) pr[n] = ballot(t, w.w[n] == 0xFFFFFFFFu);
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const uint32_t s = ((g[n] << 1) | (uint32_t)cin[n]) + pr[n];
    out[n] = (s >> kTeam) & 1;
    w.w[n] += ((s ^ pr[n]) >> t.k) & 1;
  }
  return w;
}

// a + b + cin as 256-bit words, and the carry out.
template <int N>
__device__ __forceinline__ Fe<N> add_words(const Team& t, const Fe<N>& a, const Fe<N>& b,
                                           const bool (&cin)[N], bool (&out)[N]) {
  Fe<N> w;
  bool c[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const uint64_t s = (uint64_t)a.w[n] + b.w[n];
    w.w[n] = (uint32_t)s;
    c[n] = (s >> 32) != 0;
  }
  return settle(t, w, c, cin, out);
}

__device__ __forceinline__ bool fe_is_zero(const Team& t, uint32_t a) {
  return ballot(t, a != 0) == 0;
}

// a - b mod P where sub[n], else a + b mod P (a, b in [0, P)); a - b is
// taken as a + ~b + 1 - 2^256.
template <int N>
__device__ __forceinline__ Fe<N> fe_addsub(const Team& t, const Fe<N>& a, const Fe<N>& b,
                                           const bool (&sub)[N]) {
  Fe<N> nb, fix, r;
  bool carry[N], carry2[N], none[N] = {};
#pragma unroll
  for (int n = 0; n < N; ++n) nb.w[n] = sub[n] ? ~b.w[n] : b.w[n];
  const Fe<N> w = add_words(t, a, nb, sub, carry);
  // A sum that carried out of 2^256 or is >= P (then w + F carries out)
  // takes w + F mod 2^256 = w - P; a difference that did not carry out
  // (a < b) takes w + P mod 2^256.
#pragma unroll
  for (int n = 0; n < N; ++n) fix.w[n] = sub[n] ? (carry[n] ? 0u : t.p) : t.f;
  const Fe<N> w2 = add_words(t, w, fix, none, carry2);
#pragma unroll
  for (int n = 0; n < N; ++n) r.w[n] = (sub[n] || carry[n] || carry2[n]) ? w2.w[n] : w.w[n];
  return r;
}

// The values sum_k r_k 2^(32 k) mod P, for lane words 0 <= r_k < 2^36;
// r7 is lane 7's word, which every lane passes.
template <int N>
__device__ __forceinline__ Fe<N> fe_reduce(const Team& t, uint64_t (&r)[N],
                                           const uint64_t (&r7)[N]) {
  // Subtract q P = q 2^256 - q F, q = floor(r7 / 2^32) < 2^4: lane 7
  // drops to r7 mod 2^32, the others stay below 2^37.
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const uint64_t q = r7[n] >> 32;
    r[n] += q * t.f;
    if (t.k == kTeam - 1) r[n] -= q << 32;
  }
  // Every lane's excess one lane up; lane 7 has none.
  uint32_t in[N];
#pragma unroll
  for (int n = 0; n < N; ++n) in[n] = shfl_up1(t, (uint32_t)(r[n] >> 32));
  Fe<N> w, f;
  bool c[N], top[N], carry[N], none[N] = {};
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const uint64_t x = (uint64_t)(uint32_t)r[n] + (t.k ? in[n] : 0u);
    w.w[n] = (uint32_t)x;
    c[n] = (x >> 32) != 0;
    f.w[n] = t.f;
  }
  w = settle(t, w, c, none, top);
  // The value is w + top 2^256 < 2^256 + 2^230. With top, w < 2^230 and
  // w + F < P; else w < 2^256 < 2P and w >= P exactly when w + F carries
  // out: both take w + F mod 2^256. Both are rare (w >= P needs word 7 =
  // 2^32 - 1), so the warp runs the fix only when one of its teams may
  // need it.
  bool maybe = false;
#pragma unroll
  for (int n = 0; n < N; ++n) maybe |= top[n] || (t.k == kTeam - 1 && w.w[n] == 0xFFFFFFFFu);
  if (__any_sync(kWarp, maybe)) {
    const Fe<N> w2 = add_words(t, w, f, none, carry);
#pragma unroll
    for (int n = 0; n < N; ++n) w.w[n] = (top[n] || carry[n]) ? w2.w[n] : w.w[n];
  }
  return w;
}

// a b mod P.
template <int N>
__device__ __forceinline__ Fe<N> fe_mul(const Team& t, const Fe<N>& a, const Fe<N>& b) {
  // Step j: lane k multiplies a word (k - j) mod 8 by b word j, which
  // lands on column k when k >= j and on column k + 8 otherwise. Low
  // halves stay on their column, high halves belong to the next one.
  uint64_t llo[N], lhi[N], ulo[N], uhi[N];  // each below 8 (2^32 - 1)
#pragma unroll
  for (int n = 0; n < N; ++n) llo[n] = lhi[n] = ulo[n] = uhi[n] = 0;
#pragma unroll
  for (int j = 0; j < kTeam; ++j) {
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const uint32_t x = j == 0 ? a.w[n] : shfl(t, a.w[n], (t.k - j) & (kTeam - 1));
      const uint64_t p = (uint64_t)x * shfl(t, b.w[n], j);
      if (t.k >= j) {
        llo[n] += (uint32_t)p;
        lhi[n] += p >> 32;
      } else {
        ulo[n] += (uint32_t)p;
        uhi[n] += p >> 32;
      }
    }
  }
  // Column sums: lane k takes lane k - 1's high halves; lane 0 takes
  // lane 7's low-column high half on column 8 (lane 7's upper one is
  // column 16: no product reaches it).
  const int from = (t.k + kTeam - 1) & (kTeam - 1);
  uint32_t rl[N], ru[N], rtop[N], c[N];
  uint64_t x[N], y[N];
#pragma unroll
  for (int n = 0; n < N; ++n) rl[n] = shfl(t, (uint32_t)lhi[n], from);
#pragma unroll
  for (int n = 0; n < N; ++n) ru[n] = shfl(t, (uint32_t)uhi[n], from);
#pragma unroll
  for (int n = 0; n < N; ++n)
    rtop[n] = shfl(t, (uint32_t)(lhi[n] >> 32) | (uint32_t)(uhi[n] >> 32) << 16, from);
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const uint64_t in_l = rl[n] | (uint64_t)(rtop[n] & 0xFFFFu) << 32;
    const uint64_t in_u = ru[n] | (uint64_t)(rtop[n] >> 16) << 32;
    x[n] = llo[n] + (t.k ? in_l : 0);     // column k, < 2^36
    y[n] = ulo[n] + (t.k ? in_u : in_l);  // column k + 8, < 2^36
  }
  // Each column's excess (< 16) to the next: column 7's to lane 0's
  // column 8; column 15 has none (the product is below 2^512).
#pragma unroll
  for (int n = 0; n < N; ++n)
    c[n] = shfl(t, (uint32_t)(x[n] >> 32) | (uint32_t)(y[n] >> 32) << 16, from);
#pragma unroll
  for (int n = 0; n < N; ++n) {
    x[n] = (uint64_t)(uint32_t)x[n] + (t.k ? (c[n] & 0xFFFFu) : 0u);
    y[n] = (uint64_t)(uint32_t)y[n] + (t.k ? (c[n] >> 16) : (c[n] & 0xFFFFu));
  }
  // Every column is now below 2^32 + 16: a word and a carry bit, which
  // one ballot per half gives every lane (gx for columns 0-7, gy for 8-15).
  // Solinas, row k and row 7, on these columns: the word sums take the
  // coefficients plus one (unsigned, in [0, 4]) and lose the plain sum;
  // the carry bits add 2^32 (sum_i c_i bit_i) by popcounts.
  uint32_t gx[N], gy[N], x7[N];
#pragma unroll
  for (int n = 0; n < N; ++n) gx[n] = ballot(t, (x[n] >> 32) != 0);
#pragma unroll
  for (int n = 0; n < N; ++n) gy[n] = ballot(t, (y[n] >> 32) != 0);
#pragma unroll
  for (int n = 0; n < N; ++n) x7[n] = shfl(t, (uint32_t)x[n], kTeam - 1);
  uint64_t acc[N], acc7[N], sum[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    acc[n] = t.five + x[n];
    acc7[n] = kFiveP[kTeam - 1] + x7[n] + ((uint64_t)(gx[n] >> (kTeam - 1)) << 32);
    sum[n] = 0;
  }
#pragma unroll
  for (int i = 0; i < kTeam; ++i) {
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const uint32_t h = shfl(t, (uint32_t)y[n], i);
      acc[n] += (uint64_t)((t.row >> (4 * i)) & 0xFu) * h;
      acc7[n] += (uint64_t)(uint32_t)(kSolinas[kTeam - 1][i] + 1) * h;
      sum[n] += h;
    }
  }
  uint64_t r[N], r7[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const int e = __popc(gy[n] & t.bit[0]) + 2 * __popc(gy[n] & t.bit[1]) +
                  4 * __popc(gy[n] & t.bit[2]) - __popc(gy[n]);
    const int e7 = __popc(gy[n] & t.bit7[0]) + 2 * __popc(gy[n] & t.bit7[1]) +
                   4 * __popc(gy[n] & t.bit7[2]) - __popc(gy[n]);
    // Each row is >= 0 (kFiveP), so the wrapping unsigned sum is exact.
    r[n] = acc[n] - sum[n] + ((uint64_t)(int64_t)e << 32);
    r7[n] = acc7[n] - sum[n] + ((uint64_t)(int64_t)e7 << 32);
  }
  return fe_reduce(t, r, r7);
}

// m a mod P for small m (at most 8).
template <int N>
__device__ __forceinline__ Fe<N> fe_mul_small(const Team& t, const Fe<N>& a,
                                              const uint32_t (&m)[N]) {
  uint64_t r[N], r7[N];
#pragma unroll
  for (int n = 0; n < N; ++n) r[n] = (uint64_t)a.w[n] * m[n];
#pragma unroll
  for (int n = 0; n < N; ++n) r7[n] = (uint64_t)shfl(t, a.w[n], kTeam - 1) * m[n];
  return fe_reduce(t, r, r7);
}

__device__ __forceinline__ uint32_t fe_sub(const Team& t, uint32_t a, uint32_t b) {
  return fe_addsub<1>(t, {{a}}, {{b}}, {true}).w[0];
}

__device__ __forceinline__ uint32_t fe_mul(const Team& t, uint32_t a, uint32_t b) {
  return fe_mul<1>(t, {{a}}, {{b}}).w[0];
}

// dbl-2001-b, branchless: Y = 0 and the identity give Z3 = 0 by the
// formulas themselves, as in the JAX kernel. Independent operations go
// together: 4 products and 3 add/sub steps on the chain, of 8 and 8.
__device__ __forceinline__ void jac_double(const Team& t, uint32_t& X, uint32_t& Y,
                                           uint32_t& Z) {
  const Fe<2> dg = fe_mul<2>(t, {{Z, Y}}, {{Z, Y}});  // delta = Z^2, gamma = Y^2
  const uint32_t delta = dg.w[0], gamma = dg.w[1];
  const Fe<2> pm = fe_addsub<2>(t, {{X, X}}, {{delta, delta}}, {false, true});
  // beta = X gamma, t = (X - delta)(X + delta), Y Z
  const Fe<3> m = fe_mul<3>(t, {{X, pm.w[1], Y}}, {{gamma, pm.w[0], Z}});
  // alpha = 3t, 4 beta, 8 beta, 8 gamma
  const Fe<4> sm = fe_mul_small<4>(t, {{m.w[1], m.w[0], m.w[0], gamma}}, {3, 4, 8, 8});
  const uint32_t alpha = sm.w[0];
  const Fe<2> sq = fe_mul<2>(t, {{alpha, sm.w[3]}}, {{alpha, gamma}});  // alpha^2, 8 gamma^2
  // X3 = alpha^2 - 8 beta; Z3 = (Y + Z)^2 - gamma - delta = 2 Y Z
  const Fe<2> xz = fe_addsub<2>(t, {{sq.w[0], m.w[2]}}, {{sm.w[2], m.w[2]}}, {true, false});
  const uint32_t x3 = xz.w[0];
  Y = fe_sub(t, fe_mul(t, alpha, fe_sub(t, sm.w[1], x3)), sq.w[1]);  // alpha (4 beta - X3) - 8 gamma^2
  X = x3;
  Z = xz.w[1];
}

// Mixed add (Z2 = 1) with _fallback._jac_add_affine's degeneracies,
// taken only when `take` (a nonzero digit). Branch-free: every team of a
// warp runs the same instructions whatever its digit and degeneracies,
// and the result is selected by the team's ballots. Returns true when
// the sum is the accumulator's doubling (H = 0 with equal Y), which the
// caller then runs: X, Y, Z are left as they were. Independent
// operations go together: 6 products and 5 add/sub steps on the chain,
// of 12 and 11.
__device__ __forceinline__ bool jac_add_affine(const Team& t, uint32_t& X, uint32_t& Y,
                                               uint32_t& Z, uint32_t x2, uint32_t y2,
                                               bool take) {
  const bool inf = fe_is_zero(t, Z);  // identity accumulator: (x2, y2, 1)
  const Fe<2> zz = fe_mul<2>(t, {{Z, y2}}, {{Z, Z}});                 // Z1Z1, y2 Z1
  const Fe<2> us = fe_mul<2>(t, {{x2, zz.w[1]}}, {{zz.w[0], zz.w[0]}});  // U2, S2
  const Fe<2> hs = fe_addsub<2>(t, us, {{X, Y}}, {true, true});       // H = U2 - X1, S2 - Y1
  const uint32_t h = hs.w[0];
  // H = 0: the same point (S2 = Y1) doubles, opposite points give (0, 1, 0).
  const bool h0 = fe_is_zero(t, h), r0 = fe_is_zero(t, hs.w[1]);
  const Fe<2> d = fe_addsub<2>(t, hs, hs, {false, false});            // 2H, r = 2 (S2 - Y1)
  const uint32_t r = d.w[1];
  // I = (2H)^2, Z1 H, r^2, Y1 H
  const Fe<4> p = fe_mul<4>(t, {{d.w[0], Z, r, Y}}, {{d.w[0], h, r, h}});
  // J = H I, V = X1 I, Y1 J = Y1 H I
  const Fe<3> q = fe_mul<3>(t, {{h, X, p.w[3]}}, {{p.w[0], p.w[0], p.w[0]}});
  // r^2 - J, 2V, Z3 = (Z1 + H)^2 - Z1Z1 - H^2 = 2 Z1 H, 2 Y1 J
  const Fe<4> e = fe_addsub<4>(t, {{p.w[2], q.w[1], p.w[1], q.w[2]}},
                               {{q.w[0], q.w[1], p.w[1], q.w[2]}}, {true, false, false, false});
  const uint32_t x3 = fe_sub(t, e.w[0], e.w[1]);                     // X3 = r^2 - J - 2V
  const uint32_t y3 = fe_sub(t, fe_mul(t, r, fe_sub(t, q.w[1], x3)), e.w[3]);  // r (V - X3) - 2 Y1 J
  const bool one = t.k == 0, dbl = !inf && h0 && r0;
  if (take && !dbl) {
    X = inf ? x2 : (h0 ? 0u : x3);
    Y = inf ? y2 : (h0 ? (uint32_t)one : y3);
    Z = inf ? (uint32_t)one : (h0 ? 0u : e.w[2]);
  }
  return take && dbl;
}

// Word k of a 16-limb entry: limbs 2k (low) and 2k + 1 (high).
__device__ __forceinline__ uint32_t load_word(const int32_t* limbs, int k) {
  return ((uint32_t)limbs[2 * k] & 0xFFFFu) | ((uint32_t)limbs[2 * k + 1] << 16);
}

__device__ __forceinline__ void store_word(int32_t* limbs, int k, uint32_t w) {
  limbs[2 * k] = (int32_t)(w & 0xFFFFu);
  limbs[2 * k + 1] = (int32_t)(w >> 16);
}

__global__ void __launch_bounds__(32 * kMaxWarpsPerBlock, 1)
p256_dual_window_kernel(const int32_t* __restrict__ n1, const int32_t* __restrict__ n2,
                        const int32_t* __restrict__ qwin, const int32_t* __restrict__ gwin,
                        int32_t* __restrict__ X_out, int32_t* __restrict__ Y_out,
                        int32_t* __restrict__ Z_out, int b) {
  __shared__ uint32_t g_tab[16 * 2 * kTeam];
  for (int i = threadIdx.x; i < 16 * 2 * kTeam; i += blockDim.x)
    g_tab[i] = load_word(gwin, i);
  __syncthreads();
  // A team past the batch runs the last signature's ladder with the
  // others and stores nothing: every lane of the warp stays to the end.
  const int team = (blockIdx.x * blockDim.x + threadIdx.x) / kTeam;
  const int sig = team < b ? team : b - 1;
  const Team t = make_team();

  const int32_t* d1 = n1 + (size_t)sig * kNibbles;
  const int32_t* d2 = n2 + (size_t)sig * kNibbles;
  const int32_t* q = qwin + (size_t)sig * (16 * 2 * 16);
  uint32_t X = 0, Y = t.k == 0, Z = 0;
#pragma unroll 1
  for (int i = 0; i < kNibbles; ++i) {
    const int g = d1[i] & 0xF, h = d2[i] & 0xF;
    const uint32_t gx = g_tab[(g * 2) * kTeam + t.k], gy = g_tab[(g * 2 + 1) * kTeam + t.k];
    const uint32_t qx = load_word(q + (h * 2) * 16, t.k);
    const uint32_t qy = load_word(q + (h * 2 + 1) * 16, t.k);
    // Steps 0-3 double; 4 adds the G entry, 5 the Q entry. An add that
    // meets the accumulator's own point doubles instead: the whole warp
    // doubles when one of its teams must, and the others keep their sum.
#pragma unroll 1
    for (int s = 0; s < 6; ++s) {
      bool dbl = s < 4;
      if (!dbl)
        dbl = jac_add_affine(t, X, Y, Z, s == 4 ? gx : qx, s == 4 ? gy : qy,
                             (s == 4 ? g : h) != 0);
      if (__any_sync(kWarp, dbl)) {
        uint32_t dX = X, dY = Y, dZ = Z;
        jac_double(t, dX, dY, dZ);
        if (dbl) X = dX, Y = dY, Z = dZ;
      }
    }
  }
  if (team >= b) return;
  store_word(X_out + (size_t)sig * 16, t.k, X);
  store_word(Y_out + (size_t)sig * 16, t.k, Y);
  store_word(Z_out + (size_t)sig * 16, t.k, Z);
}

}  // namespace

extern "C" int babble_p256_dual_window(const int32_t* n1, const int32_t* n2,
                                       const int32_t* qwin, const int32_t* gwin,
                                       int32_t* X, int32_t* Y, int32_t* Z, int b,
                                       void* stream) {
  if (b <= 0) return 0;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  // One warp a block while the batch's warps fill at most one scheduler
  // of every SM; above that ceil(warps / (4 SMs)) warps a block, at most 8.
  const int warps = (b + kTeamsPerWarp - 1) / kTeamsPerWarp;
  const int spread = kWarpsPerSmSpread * sms;
  int per_block = (warps + spread - 1) / spread;
  if (per_block > kMaxWarpsPerBlock) per_block = kMaxWarpsPerBlock;
  const int blocks = (warps + per_block - 1) / per_block;
  p256_dual_window_kernel<<<blocks, 32 * per_block, 0, (cudaStream_t)stream>>>(
      n1, n2, qwin, gwin, X, Y, Z, b);
  return (int)cudaGetLastError();
}
