// RWKV-6 wkv linear attention over a whole sequence, for every (batch, head),
// in chunks, with the products on the tensor cores.
//
// Replaces repro/kernels/wkv6/kernel.py:wkv6_pallas (the Pallas TPU kernel
// _wkv_kernel).  Same function: for each (b, h), from an initial state S
// (hs x hs, f32),
//     o_t = r_t . (S + diag(u) k_t (x) v_t)
//     S  <- diag(exp(w_t)) S + k_t (x) v_t
// returning o (B, T, H, hs) and the final S (B, H, hs, hs).  The Pallas
// kernel's contract is the zero initial state; this kernel takes a state
// pointer, so it is right for any state, and zero gives that contract.
// Inputs r, k, v, w (log decay, <= 0) are f32 in the JAX layout
// (B, T, H, hs), 16-byte aligned, u is (H, hs); hs in {16, 32, 64}; any
// T >= 0.
//
// Bound: at B=8, T=512, H=32, hs=64 the function moves 176,168,960 bytes
// (r, k, v, w and o at 33.5 MB each, u, the initial and the final state),
// 52.59 us at 3.35 TB/s, against 2.68 G operations for the recurrence (5
// per state element and token), 40.07 us at the CUDA cores' 67 TFLOP/s:
// bytes bind it.  The chunked form's products are 2.68 GFLOP too (per
// chunk of 32 and (b, h), 327,680 multiply-adds: P1 and P4 131,072 each,
// P3 49,152, P2 16,384), 16.3 us in three TF32 passes at 495 TFLOP/s:
// still less than the bytes take.  What holds this form back is neither: on an H100
// 80GB HBM3 at 700 W it took 129.9 us a launch (chip_smoke.py phase b
// reads it; PERF.md keeps the readings), and its phases add up rather than
// overlap.  Cut out one at a time (python -m repro_torch.kernels.wkv6.
// phase_times), they took: the products P1, P3 and P4 45.6 us, the
// diagonal blocks 18.5, the scan 14.1, P2 14.0, the operand split 12.8;
// the computation alone 120.2 us, the loads alone 52.8.  Each phase is a
// few hundred dependent instructions per thread between block barriers,
// with 8 warps on an SM.
//
// The chunked form (the Pallas kernel's, and the reference's
// models/layers/rwkv6.py:wkv_chunked).  Per chunk of C = 32 tokens, with
// L_t the inclusive sum of w over the chunk up to t and Lp_t = L_{t-1}
// (Lp_0 = 0; the exclusive sum, so that Lp_{t+1} is L_t to the bit):
//     o_t  = (r_t . exp(Lp_t)) S                       inter-chunk, P1
//          + sum_{s<t} A_ts v_s + (r_t . u . k_t) v_t   intra-chunk, P3
//     A_ts = sum_i r_t[i] k_s[i] exp(Lp_t[i] - L_s[i])
//     S   <- diag(exp(L_end)) S + (k . exp(L_end - L))^T v           P4
// w <= 0 makes L non-increasing along the chunk, also in f32 (rounding is
// monotone, and each part's offset is the earlier part's last L to the
// bit), so each of these exponents is <= 0.  The reference forms
// Lprev = L - w instead, which loses the low bits of w where |L| is large
// (ROADMAP.md, F5).
//
// No overflow.  The Pallas kernel forms A through a (C, C, hs) tensor of
// pairwise decays, 1 MB in VMEM, which no SM holds.  A product on the
// tensor cores needs A_ts = sum_i q_t[i] k'_s[i] with factors of t and of s
// alone, and exp(Lp_t) exp(-L_s) overflows f32: w reaches -20 per token, so
// |L| reaches hundreds within a chunk.  So the chunk is cut into two
// sub-chunks of 16.  For t in the second and s in the first, the factors
// take the reference point L_ref = L_15, the L of the token before the
// second sub-chunk:
//     A_ts = sum_i (r_t exp(Lp_t - L_ref))[i] (k_s exp(L_ref - L_s))[i]
// Lp_t <= L_ref <= L_s, so both factors are <= 1 and nothing overflows;
// where a factor underflows, the exact product is smaller still.  This
// 16 x 16 block (P2) goes through the tensor cores.  The two diagonal
// 16 x 16 blocks stay exact on the CUDA cores, token by token: for t > s,
// exp(Lp_t - L_s) = prod_{s<m<t} exp(w_m), so k_s is scaled by one
// exp(w_m) <= 1 a step as t walks up, and the only exponentials are the
// C x hs exp(w) of the chunk (the pairwise form needs 120 x hs per
// sub-chunk).  The u bonus sits on A's diagonal, so P3 adds it with the
// rest.  A padded tail (t >= T) is zero-filled on load: w = 0 is a decay
// of 1, and r = k = v = 0 adds nothing, so the state passes it unchanged;
// o is written only for t < T.
//
// Tensor cores, f32-exact: P1-P4 are mma.sync.m16n8k8 in TF32, three
// passes each, with every f32 operand split into a big and a small TF32
// part (flash_attention.cu's scheme, held against f64 there).  The tensor
// cores accumulate by truncation: the big x big terms run KCH k-steps in
// fresh registers before an f32 add; the two small-term passes, ~2^-11 of
// the big ones, share one accumulator over a whole product.
//
// Design: one block of four warps per (b, h) walks the chunks in order;
// the state stays in shared memory in f32.  B * H = 256 blocks at the
// serving shape; shared memory (113,152 bytes at hs = 64) lets two blocks
// share an SM, so all of them run in one wave on 132 SMs.  Chunk n + 1's
// r, k, v and w arrive by 16-byte cp.async into a two-stage ring while
// chunk n is computed.  Per chunk, between five block barriers:
//   1. L down each column and exp(w) (thread = column x part; the parts'
//      offsets pass along by shuffles);
//   2. A's diagonal blocks (a group of 8 lanes per two keys, 15 steps,
//      one butterfly of shuffles for the 16 sums) and P2 (each warp one key
//      tile and half the columns, its factors formed as its fragments are
//      loaded; the two halves added onto 0 in shared memory);
//   3. P1's and P4's A operands, r exp(Lp) and k exp(L_end - L), split
//      into TF32 parts once: big parts in place of r and k, small parts
//      beside them;
//   4. o = P1 + P3 (warp w: row tile w % 2, every other column tile), then
//      P4 (warp w: the state's row tile w, every column).
// Padded row strides (hs + 4 where rows are read as A fragments, hs + 8
// where columns are read as B fragments or k^T as an A fragment) keep the
// fragment reads conflict-free.  C = 32 (not 64) halves the ring to fit
// two blocks per SM, and makes P2 one block of 16 x 16.  Tried and slower
// on the card: eight warps per block (spills at 128 registers), chunks of
// 16 with three blocks per SM (spills at 168 registers), P2's factors
// computed in the scan (a longer scan), P2 on two warps, and the two
// blocks of an SM started half a chunk apart.
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int C = 32;           // tokens per chunk
constexpr int SUB = 16;         // tokens per sub-chunk
constexpr int NW = 4;           // warps per block
constexpr int NT = 32 * NW;
constexpr int KCH = 2;          // k-steps of a big x big run in fresh registers
constexpr int AST = C + 4;      // row stride of the scores A

template <int HS>
struct Layout {
  static constexpr int RST = HS + 4;     // r, w / L
  static constexpr int KST = HS + 8;     // k, v, exp(w), S
  static constexpr int k_off = C * RST;
  static constexpr int v_off = k_off + C * KST;
  static constexpr int w_off = v_off + C * KST;
  static constexpr int stage = w_off + C * RST;   // floats of one chunk
  static constexpr int e = 2 * stage;             // exp(w), C x hs
  static constexpr int rsm = e + C * KST;         // P1's A, small parts
  static constexpr int s = rsm + C * RST;         // the state, hs x hs
  static constexpr int a = s + HS * KST;          // the scores, C x C
  static constexpr int ehat = a + C * AST;        // exp(L_end)
  static constexpr int u = ehat + HS;
  static constexpr int floats = u + HS;
  static constexpr size_t bytes = sizeof(float) * floats;
};

__device__ __forceinline__ uint32_t bits(float x) { return __float_as_uint(x); }

// x = big + small, each exact in TF32 (flash_attention.cu's split): big is
// x with the 13 low mantissa bits cleared, small = x - big rounded to the
// nearest TF32 value
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = __float_as_uint(x) & 0xffffe000u;
  small = (__float_as_uint(x - __uint_as_float(big)) + 0x1000u) & 0xffffe000u;
}

// d += a b for a 16 x 8 TF32 A fragment and an 8 x 8 B fragment
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A fragment of one k-step: element (m, k) of the 16 x 8 tile at p is
// p[m * MS + k * KS]; the raw bits (the tile holds TF32 parts already)
template <int MS, int KS>
__device__ __forceinline__ void frag_a(const float* p, int g, int tq,
                                       uint32_t (&f)[4]) {
  f[0] = bits(p[g * MS + tq * KS]);
  f[1] = bits(p[(g + 8) * MS + tq * KS]);
  f[2] = bits(p[g * MS + (tq + 4) * KS]);
  f[3] = bits(p[(g + 8) * MS + (tq + 4) * KS]);
}

// the same from an f32 tile, split into big and small parts
template <int MS, int KS>
__device__ __forceinline__ void frag_a_split(const float* p, int g, int tq,
                                             uint32_t (&ab)[4],
                                             uint32_t (&as)[4]) {
  split(p[g * MS + tq * KS], ab[0], as[0]);
  split(p[(g + 8) * MS + tq * KS], ab[1], as[1]);
  split(p[g * MS + (tq + 4) * KS], ab[2], as[2]);
  split(p[(g + 8) * MS + (tq + 4) * KS], ab[3], as[3]);
}

// d_small += a_small b_big + a_big b_small; d_big += a_big b_big.  The
// small terms are ~2^-11 of the big ones, so one accumulator holds them
// over a whole product; the big terms run KCH k-steps in fresh registers
// before an f32 add (the tensor cores accumulate by truncation)
__device__ __forceinline__ void mma3(float (&d_small)[4], float (&d_big)[4],
                                     const uint32_t (&ab)[4],
                                     const uint32_t (&as)[4], uint32_t bb0,
                                     uint32_t bb1, uint32_t bs0,
                                     uint32_t bs1) {
  mma(d_small, as, bb0, bb1);
  mma(d_small, ab, bs0, bs1);
  mma(d_big, ab, bb0, bb1);
}

// 16 bytes from global to shared memory, zero-filled where !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(s), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// A lane's N columns of a row (N in {2, 4, 8}) from p, the row plus the
// lane's first column: 2 consecutive, or 4 consecutive every 32, so that
// the 8 lanes of a group read 64 or 128 contiguous bytes a load, free of
// bank conflicts
template <int N>
__device__ __forceinline__ void ldn(float (&x)[N], const float* p) {
  if constexpr (N == 2) {
    const float2 y = *reinterpret_cast<const float2*>(p);
    x[0] = y.x;
    x[1] = y.y;
  } else {
#pragma unroll
    for (int c = 0; c < N; c += 4) {
      const float4 y = ld4(p + 8 * c);
      x[c] = y.x;
      x[c + 1] = y.y;
      x[c + 2] = y.z;
      x[c + 3] = y.w;
    }
  }
}

template <int HS>
__global__ void __launch_bounds__(NT, 2) wkv6_kernel(
    const float* __restrict__ r, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ w,
    const float* __restrict__ u, const float* __restrict__ s0,
    float* __restrict__ o, float* __restrict__ s_out, int T, int H) {
  using Ly = Layout<HS>;
  constexpr int RST = Ly::RST, KST = Ly::KST;
  constexpr int CPR = HS / 4;           // 16-byte pieces per row
  constexpr int PARTS = NT / HS;        // the scan's parts per column
  constexpr int TPP = C / PARTS;        // and tokens per part
  constexpr int NTASK = C * CPR / NT;   // float4 pieces per thread and array
  constexpr int NC = HS / 8;            // columns per lane of a diagonal pair
  constexpr int NJT = HS / 8;           // column tiles of 8
  constexpr int NJO = NJT / 2;          // of o per warp
  constexpr int JG = NJT < 4 ? NJT : 4;     // of S per pass of P4
  constexpr int NMT = HS / 16;          // row tiles of the state
  // NT = 2 sub-chunks x 8 key pairs x 8 lanes for the diagonal blocks
  static_assert(C * CPR % NT == 0 && NT % CPR == 0 && NT % HS == 0 &&
                NW == 4 && NT == 2 * 8 * 8 && NMT <= NW,
                "even split of work");
  extern __shared__ __align__(16) float smem[];
  float* E = smem + Ly::e;
  float* Rsm = smem + Ly::rsm;
  float* Ss = smem + Ly::s;
  float* As = smem + Ly::a;
  float* ehat = smem + Ly::ehat;
  float* us = smem + Ly::u;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;   // fragment row group, column

  const int bh = blockIdx.x;                 // b * H + h
  const int b = bh / H, h = bh - (bh / H) * H;
  const size_t step = (size_t)H * HS;        // from one token to the next
  const size_t base = ((size_t)b * T * H + h) * HS;
  const int n_chunks = (T + C - 1) / C;
  // this thread's float4 pieces of a chunk: rows t0 + m NT / CPR, column c4
  const int t0 = tid / CPR, c4 = (tid % CPR) * 4;
  constexpr int TSTEP = NT / CPR;

  auto load_chunk = [&](int n, int stage) {
    float* dst = smem + stage * Ly::stage;
#pragma unroll
    for (int m = 0; m < NTASK; ++m) {
      const int t = t0 + m * TSTEP, tg = n * C + t;
      const bool ok = tg < T;
      const size_t at = base + (size_t)(ok ? tg : 0) * step + c4;
      cp_async16(dst + t * RST + c4, r + at, ok);
      cp_async16(dst + Ly::k_off + t * KST + c4, k + at, ok);
      cp_async16(dst + Ly::v_off + t * KST + c4, v + at, ok);
      cp_async16(dst + Ly::w_off + t * RST + c4, w + at, ok);
    }
    cp_async_commit();
  };
  if (n_chunks > 0) load_chunk(0, 0);

  const float* s0p = s0 + (size_t)bh * HS * HS;
  for (int i = tid; i < HS * HS; i += NT)
    Ss[(i / HS) * KST + i % HS] = s0p[i];
  for (int i = tid; i < HS; i += NT) us[i] = u[h * HS + i];
  // A's entries above the diagonal stay 0: no chunk writes them
  for (int i = tid; i < C * AST; i += NT) As[i] = 0.f;

  // this thread's share of A's diagonal blocks: sub-chunk da, the key
  // tokens dsp and 15 - dsp (15 queries after them in all), columns
  // (ldn's NC columns from dc) of a group of 8 lanes
  const int dgrp = tid >> 3, da = dgrp & 1, dsp = dgrp >> 1;
  const int dc = (tid & 7) * (NC < 4 ? NC : 4);
  const unsigned dmask = 0xffu << (lane & 24);

  for (int n = 0; n < n_chunks; ++n) {
    const int st = n & 1;
    cp_async_wait_all();   // this thread's copies of chunk n have landed
    __syncthreads();       // and everyone's; chunk n - 1 is done with
    if (n + 1 < n_chunks)  // stage st ^ 1, A and the other scratch
      load_chunk(n + 1, st ^ 1);
    float* R = smem + st * Ly::stage;
    float* K = R + Ly::k_off;
    const float* V = R + Ly::v_off;
    float* Lc = R + Ly::w_off;    // w, then L in its place

    // 1. L: inclusive sums of w down each column, in PARTS parts of TPP
    // tokens on neighbouring lanes; each part's offset is the previous
    // part's last L, passed along by shuffles; exp(w) beside it.  A's
    // off-diagonal block is cleared for P2's two partial sums.
    {
      const int part = tid % PARTS, i = tid / PARTS;
      float loc[TPP];
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < TPP; ++j) {
        const int t = part * TPP + j;
        const float x = Lc[t * RST + i];
        E[t * KST + i] = __expf(x);
        acc += x;
        loc[j] = acc;
      }
      float off = 0.f, last = acc;
#pragma unroll
      for (int q = 1; q < PARTS; ++q) {
        const float prev = __shfl_up_sync(0xffffffffu, last, 1, PARTS);
        if (part == q) {
          off = prev;
          last = acc + off;
        }
      }
#pragma unroll
      for (int j = 0; j < TPP; ++j)
        Lc[(part * TPP + j) * RST + i] = loc[j] + off;
      for (int q = tid; q < SUB * SUB; q += NT)
        As[(SUB + q / SUB) * AST + q % SUB] = 0.f;
    }
    __syncthreads();

    // 2. exp(L_end); A's diagonal blocks; P2, A's off-diagonal block
    for (int i = tid; i < HS; i += NT) ehat[i] = __expf(Lc[(C - 1) * RST + i]);
    // the diagonal blocks: A_ts = sum_i r_t[i] k_s[i] prod_{s<m<t} exp(w_m)
    // for t > s, walking t up from s + 1 with k_s scaled by one exp(w) a
    // step (every factor <= 1), and the u bonus at t = s.  This thread
    // takes 15 steps: key s1 for 15 - dsp queries, then key s2 for dsp;
    // the 8 lanes of its group sum their parts of the 15 dot products and
    // s1's bonus in one butterfly, which leaves lane l two of them, 2 l
    // and 2 l + 1.
    {
      const int s1 = da * SUB + dsp, s2 = da * SUB + SUB - 1 - dsp;
      const int n1 = SUB - 1 - dsp;
      float kd[NC], x[NC], e[NC], uu[NC], acc[16];
      float bonus2 = 0.f;
      ldn(uu, us + dc);
      ldn(kd, K + s2 * KST + dc);
      ldn(x, R + s2 * RST + dc);
#pragma unroll
      for (int c = 0; c < NC; ++c) bonus2 += x[c] * uu[c] * kd[c];
      ldn(kd, K + s1 * KST + dc);
      ldn(x, R + s1 * RST + dc);
      acc[15] = 0.f;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[15] += x[c] * uu[c] * kd[c];
#pragma unroll
      for (int j = 0; j < SUB - 1; ++j) {
        if (j == n1) ldn(kd, K + s2 * KST + dc);
        const int t = j < n1 ? s1 + 1 + j : da * SUB + j + 1;
        ldn(x, R + t * RST + dc);
        ldn(e, E + t * KST + dc);
        float a0 = 0.f, a1 = 0.f;
#pragma unroll
        for (int c = 0; c < NC; c += 2) {
          a0 += x[c] * kd[c];
          a1 += x[c + 1] * kd[c + 1];
          kd[c] *= e[c];
          kd[c + 1] *= e[c + 1];
        }
        acc[j] = a0 + a1;
      }
      const int isl = tid & 7;
      float v8[8], v4[4], v2[2];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const bool up = isl & 4;
        v8[i] = (up ? acc[i + 8] : acc[i]) +
                __shfl_xor_sync(dmask, up ? acc[i] : acc[i + 8], 4);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool up = isl & 2;
        v4[i] = (up ? v8[i + 4] : v8[i]) +
                __shfl_xor_sync(dmask, up ? v8[i] : v8[i + 4], 2);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const bool up = isl & 1;
        v2[i] = (up ? v4[i + 2] : v4[i]) +
                __shfl_xor_sync(dmask, up ? v4[i] : v4[i + 2], 1);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int j = 2 * isl + i;
        const int s = j < n1 || j == SUB - 1 ? s1 : s2;
        const int t = j == SUB - 1 ? s1 : j < n1 ? s1 + 1 + j
                                                 : da * SUB + j + 1;
        As[t * AST + s] = v2[i];
      }
      bonus2 += __shfl_xor_sync(dmask, bonus2, 1);
      bonus2 += __shfl_xor_sync(dmask, bonus2, 2);
      bonus2 += __shfl_xor_sync(dmask, bonus2, 4);
      if (isl == 0) As[s2 * AST + s2] = bonus2;
    }
    // P2: A[16 + t][s] = sum_i (r . exp(Lp - L_ref))_{16+t}[i]
    // (k . exp(L_ref - L))_s[i], L_ref = L_15, both factors formed as the
    // fragments are loaded; warp w takes key tile w % 2 and half w / 2 of
    // the columns, and adds its part to A (two parts onto 0: the sum does
    // not depend on their order)
    {
      const int nt = warp & 1, k_lo = (warp >> 1) * (HS / 2);
      const float* lref = Lc + (SUB - 1) * RST;
      float sm[4] = {0.f, 0.f, 0.f, 0.f}, acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int k0 = k_lo; k0 < k_lo + HS / 2; k0 += 8) {
        uint32_t ab[4], as[4], bb0, bs0, bb1, bs1;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = SUB + g + 8 * (e & 1), col = k0 + tq + 4 * (e >> 1);
          split(R[t * RST + col] *
                    __expf(Lc[(t - 1) * RST + col] - lref[col]),
                ab[e], as[e]);
        }
        const int s = nt * 8 + g;
        split(K[s * KST + k0 + tq] *
                  __expf(lref[k0 + tq] - Lc[s * RST + k0 + tq]),
              bb0, bs0);
        split(K[s * KST + k0 + tq + 4] *
                  __expf(lref[k0 + tq + 4] - Lc[s * RST + k0 + tq + 4]),
              bb1, bs1);
        float bg[4] = {0.f, 0.f, 0.f, 0.f};
        mma3(sm, bg, ab, as, bb0, bb1, bs0, bs1);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[e] += bg[e];
      }
      float* ap = As + SUB * AST + nt * 8 + 2 * tq;
      atomicAdd(ap + g * AST, acc[0] + sm[0]);
      atomicAdd(ap + g * AST + 1, acc[1] + sm[1]);
      atomicAdd(ap + (g + 8) * AST, acc[2] + sm[2]);
      atomicAdd(ap + (g + 8) * AST + 1, acc[3] + sm[3]);
    }
    __syncthreads();

    // 3. P1's A = r . exp(Lp) and P4's A = k . exp(L_end - L), split into
    // TF32 parts once: the big parts in place of r and k, the small parts
    // in Rsm and in place of exp(w)
#pragma unroll
    for (int m = 0; m < NTASK; ++m) {
      const int t = t0 + m * TSTEP, c = c4;
      const float4 lend = ld4(Lc + (C - 1) * RST + c);
      const float4 l = ld4(Lc + t * RST + c);
      const float4 lp = t ? ld4(Lc + (t - 1) * RST + c)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
      const float4 x = ld4(R + t * RST + c);
      const float4 y = ld4(K + t * KST + c);
      uint4 big, small;
      split(x.x * __expf(lp.x), big.x, small.x);
      split(x.y * __expf(lp.y), big.y, small.y);
      split(x.z * __expf(lp.z), big.z, small.z);
      split(x.w * __expf(lp.w), big.w, small.w);
      *reinterpret_cast<uint4*>(R + t * RST + c) = big;
      *reinterpret_cast<uint4*>(Rsm + t * RST + c) = small;
      split(y.x * __expf(lend.x - l.x), big.x, small.x);
      split(y.y * __expf(lend.y - l.y), big.y, small.y);
      split(y.z * __expf(lend.z - l.z), big.z, small.z);
      split(y.w * __expf(lend.w - l.w), big.w, small.w);
      *reinterpret_cast<uint4*>(K + t * KST + c) = big;
      *reinterpret_cast<uint4*>(E + t * KST + c) = small;
    }
    __syncthreads();

    // 4. o = P1 + P3: warp w takes row tile w % 2 of the chunk and the
    // column tiles jt = w / 2 + 2 x; then, after a barrier, P4: warp w
    // takes the state's row tile w and every column.  Each A fragment is
    // read by two warps in P1 and by one in P4.
    {
      const int mt = warp & 1;
      const float* Rs = Rsm;             // P1's A, small parts
      float oc[NJO][4], sm[NJO][4];
#pragma unroll
      for (int x = 0; x < NJO; ++x)
#pragma unroll
        for (int e = 0; e < 4; ++e) oc[x][e] = sm[x][e] = 0.f;
      // P1: (r . exp(Lp)) S
#pragma unroll
      for (int kc = 0; kc < HS; kc += 8 * KCH) {
        float bg[NJO][4];
#pragma unroll
        for (int x = 0; x < NJO; ++x)
#pragma unroll
          for (int e = 0; e < 4; ++e) bg[x][e] = 0.f;
#pragma unroll
        for (int c = 0; c < KCH; ++c) {
          const int k0 = kc + 8 * c;
          uint32_t ab[4], as[4];
          frag_a<RST, 1>(R + mt * 16 * RST + k0, g, tq, ab);
          frag_a<RST, 1>(Rs + mt * 16 * RST + k0, g, tq, as);
#pragma unroll
          for (int x = 0; x < NJO; ++x) {
            const int jt = (warp >> 1) + 2 * x;
            const float* sp = Ss + (k0 + tq) * KST + jt * 8 + g;
            uint32_t bb0, bs0, bb1, bs1;
            split(sp[0], bb0, bs0);
            split(sp[4 * KST], bb1, bs1);
            mma3(sm[x], bg[x], ab, as, bb0, bb1, bs0, bs1);
          }
        }
#pragma unroll
        for (int x = 0; x < NJO; ++x)
#pragma unroll
          for (int e = 0; e < 4; ++e) oc[x][e] += bg[x][e];
      }
      // P3: A v over the keys s < 16 (mt + 1): A is 0 beyond
#pragma unroll
      for (int kc = 0; kc < C; kc += 8 * KCH) {
        if (kc >= SUB * (mt + 1)) break;
        float bg[NJO][4];
#pragma unroll
        for (int x = 0; x < NJO; ++x)
#pragma unroll
          for (int e = 0; e < 4; ++e) bg[x][e] = 0.f;
#pragma unroll
        for (int c = 0; c < KCH; ++c) {
          const int k0 = kc + 8 * c;
          uint32_t ab[4], as[4];
          frag_a_split<AST, 1>(As + mt * 16 * AST + k0, g, tq, ab, as);
#pragma unroll
          for (int x = 0; x < NJO; ++x) {
            const int jt = (warp >> 1) + 2 * x;
            const float* vp = V + (k0 + tq) * KST + jt * 8 + g;
            uint32_t bb0, bs0, bb1, bs1;
            split(vp[0], bb0, bs0);
            split(vp[4 * KST], bb1, bs1);
            mma3(sm[x], bg[x], ab, as, bb0, bb1, bs0, bs1);
          }
        }
#pragma unroll
        for (int x = 0; x < NJO; ++x)
#pragma unroll
          for (int e = 0; e < 4; ++e) oc[x][e] += bg[x][e];
      }
      const int t0 = n * C + mt * 16 + g, t1 = t0 + 8;
#pragma unroll
      for (int x = 0; x < NJO; ++x) {
        const size_t col = base + ((warp >> 1) + 2 * x) * 8 + 2 * tq;
        if (t0 < T)
          *reinterpret_cast<float2*>(o + col + (size_t)t0 * step) =
              make_float2(oc[x][0] + sm[x][0], oc[x][1] + sm[x][1]);
        if (t1 < T)
          *reinterpret_cast<float2*>(o + col + (size_t)t1 * step) =
              make_float2(oc[x][2] + sm[x][2], oc[x][3] + sm[x][3]);
      }
    }
    __syncthreads();   // every read of S is done
    // P4: S[rows of tile w, :] <- exp(L_end) . S + (k . exp(L_end - L))^T v,
    // JG column tiles at a time
    if (warp < NMT) {
      const float* Ks = E;               // P4's A, small parts
      const int i0 = warp * 16 + g, i1 = i0 + 8;
      const float e0 = ehat[i0], e1 = ehat[i1];
#pragma unroll
      for (int j0 = 0; j0 < NJT; j0 += JG) {
        float sc[JG][4], sm[JG][4];
#pragma unroll
        for (int x = 0; x < JG; ++x) {
          const float* sp = Ss + (j0 + x) * 8 + 2 * tq;
          sc[x][0] = e0 * sp[i0 * KST];
          sc[x][1] = e0 * sp[i0 * KST + 1];
          sc[x][2] = e1 * sp[i1 * KST];
          sc[x][3] = e1 * sp[i1 * KST + 1];
#pragma unroll
          for (int e = 0; e < 4; ++e) sm[x][e] = 0.f;
        }
#pragma unroll
        for (int kc = 0; kc < C; kc += 8 * KCH) {
          float bg[JG][4];
#pragma unroll
          for (int x = 0; x < JG; ++x)
#pragma unroll
            for (int e = 0; e < 4; ++e) bg[x][e] = 0.f;
#pragma unroll
          for (int c = 0; c < KCH; ++c) {
            const int k0 = kc + 8 * c;
            uint32_t ab[4], as[4];
            frag_a<1, KST>(K + k0 * KST + warp * 16, g, tq, ab);
            frag_a<1, KST>(Ks + k0 * KST + warp * 16, g, tq, as);
#pragma unroll
            for (int x = 0; x < JG; ++x) {
              const float* vp = V + (k0 + tq) * KST + (j0 + x) * 8 + g;
              uint32_t bb0, bs0, bb1, bs1;
              split(vp[0], bb0, bs0);
              split(vp[4 * KST], bb1, bs1);
              mma3(sm[x], bg[x], ab, as, bb0, bb1, bs0, bs1);
            }
          }
#pragma unroll
          for (int x = 0; x < JG; ++x)
#pragma unroll
            for (int e = 0; e < 4; ++e) sc[x][e] += bg[x][e];
        }
#pragma unroll
        for (int x = 0; x < JG; ++x) {
          float* sp = Ss + (j0 + x) * 8 + 2 * tq;
          sp[i0 * KST] = sc[x][0] + sm[x][0];
          sp[i0 * KST + 1] = sc[x][1] + sm[x][1];
          sp[i1 * KST] = sc[x][2] + sm[x][2];
          sp[i1 * KST + 1] = sc[x][3] + sm[x][3];
        }
      }
    }
  }

  __syncthreads();
  float* sp = s_out + (size_t)bh * HS * HS;
  for (int i = tid; i < HS * HS; i += NT) sp[i] = Ss[(i / HS) * KST + i % HS];
}

template <int HS>
int launch(int n_blocks, cudaStream_t stream, const float* r,
           const float* k, const float* v, const float* w, const float* u,
           const float* s0, float* o, float* s_out, int T, int H) {
  const size_t smem = Layout<HS>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      wkv6_kernel<HS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  wkv6_kernel<HS><<<n_blocks, NT, smem, stream>>>(r, k, v, w, u, s0, o,
                                                  s_out, T, H);
  return (int)cudaGetLastError();
}

}  // namespace

// The dynamic shared memory of one block at head size hs, in bytes (0 for
// a head size without a kernel).
extern "C" int wkv6_smem_bytes(int hs) {
  switch (hs) {
    case 16: return (int)Layout<16>::bytes;
    case 32: return (int)Layout<32>::bytes;
    case 64: return (int)Layout<64>::bytes;
    default: return 0;
  }
}

// Returns cudaGetLastError() after the launch (0 when it was accepted), or
// cudaErrorInvalidValue for a head size without a kernel.  Every pointer
// is 16-byte aligned (the wrapper's fresh or contiguous f32 tensors).
extern "C" int wkv6_launch(const void* r, const void* k, const void* v,
                           const void* w, const void* u, const void* s0,
                           void* o, void* s_out, int B, int T, int H, int hs,
                           void* stream) {
  const int n = B * H;
  cudaStream_t st = (cudaStream_t)stream;
  const float *fr = (const float*)r, *fk = (const float*)k,
              *fv = (const float*)v, *fw = (const float*)w,
              *fu = (const float*)u, *fs0 = (const float*)s0;
  float *fo = (float*)o, *fs = (float*)s_out;
  switch (hs) {
    case 16: return launch<16>(n, st, fr, fk, fv, fw, fu, fs0, fo, fs, T, H);
    case 32: return launch<32>(n, st, fr, fk, fv, fw, fu, fs0, fo, fs, T, H);
    case 64: return launch<64>(n, st, fr, fk, fv, fw, fu, fs0, fo, fs, T, H);
    default: return (int)cudaErrorInvalidValue;
  }
}
