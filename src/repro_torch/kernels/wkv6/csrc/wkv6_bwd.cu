// The gradient of RWKV-6's wkv recurrence, for every (batch, head), in
// chunks, with the products on the tensor cores: the backward kernel of
// wkv6.cu.
//
// The TPU package has no backward kernel: the reference trains through its
// plain jnp form (repro/models/layers/rwkv6.py:wkv_chunked, under
// jax.grad).  This kernel is the port's own, so that training on the card
// runs through wkv6.cu forward and this file backward.  For each (b, h),
// from the initial state S_0 (hs x hs, f32) and the forward recurrence
//     o_t = r_t . (S_{t-1} + diag(u) k_t (x) v_t)
//     S_t = diag(exp(w_t)) S_{t-1} + k_t (x) v_t
// it takes do (B, T, H, hs) and the adjoint of the final state (or none:
// zero) and returns, with G_t the adjoint of S_t and W_t = exp(w_t), the
// stepwise identities (kernel.py:wkv6_backward_plain runs them)
//     dr_t = S_{t-1} do_t + u . k_t (do_t . v_t)
//     dk_t = G_t v_t     + r_t . u (do_t . v_t)
//     dv_t = G_t^T k_t   + (r_t . u . k_t) do_t
//     dw_t = W_t . rowsum(G_t . S_{t-1})
//     du   = sum_{b,t} r_t . k_t (do_t . v_t)     (per (b, h) here)
//     G_{t-1} = diag(W_t) G_t + r_t (x) do_t
// du is written as per-(b, h) partials that the wrapper sums over b in a
// fixed order: there are no atomics, so the gradients are the same bits
// from run to run.
//
// The chunked form.  Per chunk of C = 32 tokens (local t), S_c the state
// before it and G the adjoint after it, with the products of decays
//     cf_t = prod_{q<t} W_q = exp(Lp_t)      cb_t = prod_{q>t} W_q
//     E_ts = prod_{s<q<t} W_q (s < t)        cend = prod_q W_q
// unrolling the identities above inside the chunk gives
//     S_{t-1} = cf_t . S_c + sum_{s<t} E_ts . k_s (x) v_s
//     G_t     = cb_t . G   + sum_{s>t} E_st . r_s (x) do_s
// and so, with D_ts = do_t . v_s and the forward's scores A_ts = sum_i
// r_t k_s E_ts (A_tt = r_t . u . k_t),
//     dr_t = cf_t . (S_c do_t) + sum_{s<t} E_ts . k_s D_ts + u . k_t D_tt
//     dk_s = cb_s . (G v_s)    + sum_{t>s} E_ts . r_t D_ts + r_s . u D_ss
//     dv_s = (k_s . cb_s)^T G  + sum_{t>=s} A_ts do_t
//     G   <- cend . G + sum_t (r_t . cf_t) (x) do_t
// and dw_m = W_m rowsum(G_m . S_{m-1}) expands, each term a single product
// of decays (W_m cb_m cf_m = cend, W_m cb_m E_ms = cb_s, W_m E_tm cf_m =
// cf_t, W_m E_tm E_ms = E_ts), into
//     dw_m = cend . rowsum(G . S_c) + sum_{s<m} k_s . cb_s . (G v_s)
//          + sum_{t>m} r_t . cf_t . (S_c do_t)
//          + sum_{s<m<t} r_t . k_s . E_ts D_ts
// The cumulative-sum form of dw (sum_{t>m} r . dr - sum_{s>=m} k . dk
// + ...) cancels: under a log decay of -20 its terms are 1 where dw is
// 1e-9.  These terms do not: every one is a part of the stepwise sum, so
// this dw is as exact as the stepwise one (kernel.py:
// wkv6_backward_chunked_plain repeats every formula of this file in torch,
// and tests/test_torch_wkv6_bwd_chunked.py holds it in f32 within 1e-5 of
// the f64 stepwise gradient under that decay).
//
// No overflow, and no rounding of long sums.  The chunk is two sub-chunks
// of 16 around the reference point L_ref = L_15 (wkv6.cu's).  Every decay
// is a product of the W's it spans, formed inside a sub-chunk: cf, cb and
// the reference factors rf (prod_{s<q<=15} W_q = exp(L_ref - L_s) on the
// first sub-chunk, prod_{16<=q<t} W_q = exp(Lp_t - L_ref) on the second)
// as running products, and the sub-chunk totals multiplied in (the
// exclusive Lp of F5, without its exponent: a difference of two sums of
// w loses their low bits where |L| is in the hundreds, and dw's terms are
// all of dw's size under strong decay).  Pairs s < t of different
// sub-chunks factor through L_ref, so the off-diagonal 16 x 16 block of D
// and of A are products on the tensor cores: sum_s D_ts (k_s rf_s) scaled
// by rf_t, and its twin for dk.  Pairs in one sub-chunk (the diagonal
// blocks) are exact on the CUDA cores: A's as in wkv6.cu, and the per-
// column sums of dr, dk and dw, for each column i in one thread that
// walks the sub-chunk's 120 pairs with E_ts built up a factor at a time.
// The sums over s < m and t > m run inside each sub-chunk; across the
// sub-chunks they take the inter-chunk terms only (the off-diagonal
// block's pairs are counted in its own products).  A padded tail (t >= T)
// is zero-filled on load: w = 0 is a decay of 1 and r = k = v = do = 0
// adds nothing.
//
// Tensor cores, f32-exact: every product is mma.sync.m16n8k8 in TF32,
// three passes, each f32 operand split into a big and a small TF32 part
// (wkv6.cu's scheme, the factors formed as the fragments are read).
//
// Design: one block of eight warps per (b, h).  Pass 1 walks the chunks
// forward and writes the state before each to a scratch buffer (B H
// ceil(T / 32) hs^2 f32: 67 MB at the shape below, 4x less than a state
// every 8 steps), by the forward's product S <- cend . S + (k . cb)^T v.
// Pass 2 walks the chunks backward with G in shared memory; the chunk's r,
// k, v, w, do and S_c arrive by 16-byte cp.async into a two-stage ring
// while the chunk after it (in the walk) is computed.  Warps 0-3 do the
// CUDA-core work, warps 4-7 most products, side by side, between three
// block barriers per chunk:
//   1. warps 0-3: the decay products, rowsum(G . S_c), then D's three
//      lower blocks; warps 4-7: S_c do^T and G v^T;
//   2. warps 0-3: A's diagonal blocks, then the per-column walk of the
//      diagonal blocks; warps 4-7: A's off-diagonal block, the off-
//      diagonal parts of dr and dk, (k . cb) G;
//   3. warps 0-3: dr, dk and dw of the chunk, written; warps 4-7: A^T do,
//      dv written; then all eight: G stepped back by the chunk.
// Row strides of hs + 4 keep the fragment reads that run along a row
// conflict-free.  Shared memory at hs = 64: 202,752 bytes, one block per
// SM; B H = 256 blocks at the shape below, 1.94 waves.
//
// What holds it back (NVIDIA H100 80GB HBM3 at 700 W, PERF.md): the
// phases add up rather than overlap, so the SM's issue and shared-memory
// pipes, not latency, bound it: each cut out (python -m
// repro_torch.kernels.wkv6.phase_times --backward) saves its own share,
// and moving work between the halves (D's blocks, the G step) left the
// time as it was.  The products' operand splits and loads (about five
// instructions per mma), the walk and the chunk's finish, and the loads
// take most of it; pass 1 little.
//
// Bound: at B=8, T=512, H=32, hs=64 the function reads r, k, v, w, do and
// writes dr, dk, dv, dw (33.5 MB each; with u, du and the initial state
// 306 MB: 91 us at 3.35 TB/s) and does 12 operations per state element
// and token (the state recomputed, the adjoint, the sums of dr, dk, dv
// and dw), 6.44 G operations: 39 us in three TF32 passes on the tensor
// cores.  Bytes bind the function; this form also writes and reads the
// 67 MB of chunk-start states.  chip_smoke.py phase k reads its time and
// profile; PERF.md keeps them.
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int C = 32;           // tokens per chunk
constexpr int SUB = 16;         // tokens per sub-chunk
constexpr int NW = 8;           // warps per block: 0-3 CUDA cores, 4-7 products
constexpr int NT = 32 * NW;
constexpr int NH = NT / 2;      // threads of each half
constexpr int KCH = 2;          // k-steps of a big x big run in fresh registers
constexpr int DST = C + 4;      // row stride of D and A

template <int HS>
struct Layout {
  static constexpr int ST = HS + 4;          // row stride of hs-wide rows
  // one stage of the ring: r, k, v, w (W in its place), do, and S_c
  static constexpr int r_off = 0;
  static constexpr int k_off = C * ST;
  static constexpr int v_off = 2 * C * ST;
  static constexpr int w_off = 3 * C * ST;
  static constexpr int o_off = 4 * C * ST;
  static constexpr int s_off = 5 * C * ST;
  static constexpr int stage = 5 * C * ST + HS * ST;
  static constexpr int g = 2 * stage;        // G (pass 2), the state (pass 1)
  static constexpr int cf = g + HS * ST;     // C x ST: cf, cb, rf
  static constexpr int cb = cf + C * ST;
  static constexpr int rf = cb + C * ST;
  static constexpr int pr = rf + C * ST;     // C x ST: do S_c^T, v G^T
  static constexpr int pk = pr + C * ST;
  static constexpr int xr = pk + C * ST;     // SUB x ST: the off-diagonal
  static constexpr int xk = xr + SUB * ST;   // block's parts of dr and dk
  static constexpr int d = xk + SUB * ST;    // C x DST: D, A
  static constexpr int a = d + C * DST;
  static constexpr int u = a + C * DST;      // hs: u, cend
  static constexpr int cend = u + HS;
  static constexpr int ex = cend + HS;       // 6 x hs: the two halves'
  static constexpr int floats = ex + 6 * HS; // exchanges
  static constexpr size_t bytes = sizeof(float) * floats;
};

// x = big + small, each exact in TF32 (wkv6.cu's split)
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

// acc + sm += A B over k in [k0, k1) (a multiple of 16 long) for one 16-row
// tile and NJ tiles of 8 columns: A(m, k) and B(x, k, n) give the f32
// elements (m, n inside the tile), split as they are read.  The small terms
// share sm over the whole product; the big terms run KCH k-steps in fresh
// registers before an f32 add to acc (the tensor cores truncate)
template <int NJ, class FA, class FB>
__device__ __forceinline__ void gemm(float (&acc)[NJ][4], float (&sm)[NJ][4],
                                     int k0, int k1, int g, int tq, FA A,
                                     FB B) {
  for (int kc = k0; kc < k1; kc += 8 * KCH) {
    float bg[NJ][4];
#pragma unroll
    for (int x = 0; x < NJ; ++x)
#pragma unroll
      for (int e = 0; e < 4; ++e) bg[x][e] = 0.f;
#pragma unroll
    for (int c = 0; c < KCH; ++c) {
      const int k = kc + 8 * c;
      uint32_t ab[4], as[4];
      split(A(g, k + tq), ab[0], as[0]);
      split(A(g + 8, k + tq), ab[1], as[1]);
      split(A(g, k + tq + 4), ab[2], as[2]);
      split(A(g + 8, k + tq + 4), ab[3], as[3]);
#pragma unroll
      for (int x = 0; x < NJ; ++x) {
        uint32_t bb0, bs0, bb1, bs1;
        split(B(x, k + tq, g), bb0, bs0);
        split(B(x, k + tq + 4, g), bb1, bs1);
        mma(sm[x], as, bb0, bb1);
        mma(sm[x], ab, bs0, bs1);
        mma(bg[x], ab, bb0, bb1);
      }
    }
#pragma unroll
    for (int x = 0; x < NJ; ++x)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[x][e] += bg[x][e];
  }
}

template <int NJ>
__device__ __forceinline__ void zero(float (&a)[NJ][4]) {
#pragma unroll
  for (int x = 0; x < NJ; ++x)
#pragma unroll
    for (int e = 0; e < 4; ++e) a[x][e] = 0.f;
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
// a barrier of the 128 threads of one half (id 1: warps 0-3, 2: 4-7)
__device__ __forceinline__ void half_sync(int id) {
  asm volatile("bar.sync %0, %1;" :: "r"(id), "r"(NH) : "memory");
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// A lane's N columns of a row (wkv6.cu's ldn): 2 consecutive, or 4
// consecutive every 32
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

// The chunk's decay products, by thread ct < 2 hs of warps 0-3: sub-chunk
// cs = ct / hs, column ci.  W = exp(w) replaces w; each sub-chunk's
// exclusive running products forward and backward; the sub-chunks'
// totals exchanged; then cf, cb, rf and cend as the note defines them
template <int HS>
__device__ __forceinline__ void decays(float* smem, float* Wst, int ct) {
  using Ly = Layout<HS>;
  constexpr int ST = Ly::ST;
  float* cf = smem + Ly::cf;
  float* cb = smem + Ly::cb;
  float* rf = smem + Ly::rf;
  float* prod = smem + Ly::ex;            // [2][HS]
  const bool on = ct < 2 * HS;
  const int cs = ct / HS, ci = ct % HS, base = cs * SUB;
  float Wv[SUB], fwd[SUB], bwd[SUB];
  float p = 1.f;
  if (on) {
#pragma unroll
    for (int t = 0; t < SUB; ++t) {
      float* at = Wst + (base + t) * ST + ci;
      Wv[t] = expf(*at);
      *at = Wv[t];
      fwd[t] = p;
      p *= Wv[t];
    }
    float q = 1.f;
#pragma unroll
    for (int t = SUB - 1; t >= 0; --t) {
      bwd[t] = q;
      q *= Wv[t];
    }
    prod[cs * HS + ci] = p;
  }
  half_sync(1);
  if (on) {
    const float other = prod[(1 - cs) * HS + ci];
    if (cs == 0) {
#pragma unroll
      for (int t = 0; t < SUB; ++t) {
        cf[t * ST + ci] = fwd[t];
        rf[t * ST + ci] = bwd[t];
        cb[t * ST + ci] = bwd[t] * other;
      }
      smem[Ly::cend + ci] = p * other;
    } else {
#pragma unroll
      for (int t = 0; t < SUB; ++t) {
        cf[(SUB + t) * ST + ci] = other * fwd[t];
        rf[(SUB + t) * ST + ci] = fwd[t];
        cb[(SUB + t) * ST + ci] = bwd[t];
      }
    }
  }
}

// M <- cend . M + sum_t (X_t . F_t) (x) Y_t for the rows i0 .. i0 + 15 and
// the columns j0 .. j0 + 8 NJ of the hs x hs matrix M (stride ST): pass 1's
// state step (X = k, F = cb, Y = v) and pass 2's adjoint step (X = r, F =
// cf, Y = do)
template <int HS, int NJ>
__device__ __forceinline__ void step_back(float* M, const float* X,
                                          const float* F, const float* Y,
                                          const float* cend, int i0, int j0,
                                          int g, int tq) {
  constexpr int ST = HS + 4;
  float acc[NJ][4], sm[NJ][4];
  zero(sm);
  const float e0 = cend[i0 + g], e1 = cend[i0 + g + 8];
#pragma unroll
  for (int x = 0; x < NJ; ++x) {
    const float* mp = M + j0 + x * 8 + 2 * tq;
    acc[x][0] = e0 * mp[(i0 + g) * ST];
    acc[x][1] = e0 * mp[(i0 + g) * ST + 1];
    acc[x][2] = e1 * mp[(i0 + g + 8) * ST];
    acc[x][3] = e1 * mp[(i0 + g + 8) * ST + 1];
  }
  gemm<NJ>(acc, sm, 0, C, g, tq,
           [&](int m, int k) {
             return X[k * ST + i0 + m] * F[k * ST + i0 + m];
           },
           [&](int x, int k, int n) { return Y[k * ST + j0 + x * 8 + n]; });
#pragma unroll
  for (int x = 0; x < NJ; ++x) {
    float* mp = M + j0 + x * 8 + 2 * tq;
    mp[(i0 + g) * ST] = acc[x][0] + sm[x][0];
    mp[(i0 + g) * ST + 1] = acc[x][1] + sm[x][1];
    mp[(i0 + g + 8) * ST] = acc[x][2] + sm[x][2];
    mp[(i0 + g + 8) * ST + 1] = acc[x][3] + sm[x][3];
  }
}

template <int HS>
__global__ void __launch_bounds__(NT, 1) wkv6_bwd_kernel(
    const float* __restrict__ r, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ w,
    const float* __restrict__ u, const float* __restrict__ s0,
    const float* __restrict__ dout, const float* __restrict__ dstate,
    float* __restrict__ dr, float* __restrict__ dk, float* __restrict__ dv,
    float* __restrict__ dw, float* __restrict__ du_part,
    float* __restrict__ scratch, int T, int H) {
  using Ly = Layout<HS>;
  constexpr int ST = Ly::ST;
  constexpr int CPR = HS / 4;           // 16-byte pieces per row
  constexpr int NJT = HS / 8;           // column tiles of 8
  constexpr int NJH = NJT / 2 > 0 ? NJT / 2 : 1;   // of half the columns
  constexpr int NMT = HS / 16;          // row tiles of an hs x hs matrix
  constexpr int NC = HS / 8;            // columns per lane, A's diagonal
  static_assert(NJT % 2 == 0 && NH == 2 * 8 * 8, "even split of work");
  extern __shared__ __align__(16) float smem[];
  float* Gs = smem + Ly::g;
  float* CF = smem + Ly::cf;
  float* CB = smem + Ly::cb;
  float* RF = smem + Ly::rf;
  float* PR = smem + Ly::pr;
  float* PK = smem + Ly::pk;
  float* XR = smem + Ly::xr;
  float* XK = smem + Ly::xk;
  float* Ds = smem + Ly::d;
  float* As = smem + Ly::a;
  float* us = smem + Ly::u;
  float* cend = smem + Ly::cend;
  float* ex = smem + Ly::ex;            // [6][HS]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;   // fragment row group, column
  const bool cuda_half = warp < 4;
  const int wt = warp & 3;                  // warp within its half
  const int ct = tid & (NH - 1);            // thread within its half

  const int bh = blockIdx.x;                 // b * H + h
  const int b = bh / H, h = bh - (bh / H) * H;
  const size_t step = (size_t)H * HS;        // from one token to the next
  const size_t base = ((size_t)b * T * H + h) * HS;
  const int nc = (T + C - 1) / C;
  float* scr = scratch + (size_t)bh * nc * HS * HS;

  // chunk n's rows of the (B, T, H, hs) inputs into a stage of the ring
  auto load = [&](int n, int stage, bool pass2) {
    float* dst = smem + stage * Ly::stage;
    for (int x = tid; x < C * CPR; x += NT) {
      const int t = x / CPR, c4 = (x % CPR) * 4, tg = n * C + t;
      const bool ok = tg < T;
      const size_t at = base + (size_t)(ok ? tg : 0) * step + c4;
      cp_async16(dst + Ly::k_off + t * ST + c4, k + at, ok);
      cp_async16(dst + Ly::v_off + t * ST + c4, v + at, ok);
      cp_async16(dst + Ly::w_off + t * ST + c4, w + at, ok);
      if (pass2) {
        cp_async16(dst + Ly::r_off + t * ST + c4, r + at, ok);
        cp_async16(dst + Ly::o_off + t * ST + c4, dout + at, ok);
      }
    }
    if (pass2) {
      const float* sp = scr + (size_t)n * HS * HS;
      for (int x = tid; x < HS * CPR; x += NT) {
        const int i = x / CPR, c4 = (x % CPR) * 4;
        cp_async16(dst + Ly::s_off + i * ST + c4, sp + i * HS + c4, true);
      }
    }
    cp_async_commit();
  };

  for (int i = tid; i < HS; i += NT) us[i] = u[h * HS + i];
  // A's entries above the diagonal stay 0: no chunk writes them
  for (int i = tid; i < C * DST; i += NT) As[i] = 0.f;
  const float* s0p = s0 + (size_t)bh * HS * HS;
  for (int i = tid; i < HS * HS; i += NT) Gs[(i / HS) * ST + i % HS] = s0p[i];

  // pass 1: the state before every chunk, to the scratch buffer
  if (nc > 0) load(0, 0, false);
  for (int n = 0; n < nc; ++n) {
    const int st = n & 1;
    cp_async_wait_all();
    __syncthreads();     // chunk n has landed; the last step is done
    if (n + 1 < nc) load(n + 1, st ^ 1, false);
    float* Sg = scr + (size_t)n * HS * HS;
    for (int x = tid; x < HS * CPR; x += NT) {
      const int i = x / CPR, c4 = (x % CPR) * 4;
      *reinterpret_cast<float4*>(Sg + i * HS + c4) = ld4(Gs + i * ST + c4);
    }
    float* stg = smem + st * Ly::stage;
    if (cuda_half) decays<HS>(smem, stg + Ly::w_off, ct);
    __syncthreads();
    for (int q = warp; q < 2 * NMT; q += NW)
      step_back<HS, NJH>(Gs, stg + Ly::k_off, CB, stg + Ly::v_off, cend,
                         (q >> 1) * 16, (q & 1) * (HS / 2), g, tq);
  }
  __syncthreads();       // every read of the state is done

  // pass 2: the adjoint, chunk by chunk backward
  if (dstate != nullptr) {
    const float* gp = dstate + (size_t)bh * HS * HS;
    for (int i = tid; i < HS * HS; i += NT)
      Gs[(i / HS) * ST + i % HS] = gp[i];
  } else {
    for (int i = tid; i < HS * HS; i += NT) Gs[(i / HS) * ST + i % HS] = 0.f;
  }
  // thread ct < 2 hs of warps 0-3 owns sub-chunk cs, column ci
  const bool own = cuda_half && ct < 2 * HS;
  const int cs = ct / HS, ci = ct % HS, cbase = cs * SUB;
  float du_acc = 0.f;
  if (nc > 0) load(nc - 1, 0, true);
  for (int n = nc - 1; n >= 0; --n) {
    const int st = (nc - 1 - n) & 1;
    cp_async_wait_all();
    __syncthreads();     // chunk n has landed; G is stepped past chunk n + 1
    if (n > 0) load(n - 1, st ^ 1, true);
    float* stg = smem + st * Ly::stage;
    const float* R = stg + Ly::r_off;
    const float* K = stg + Ly::k_off;
    const float* V = stg + Ly::v_off;
    float* Wst = stg + Ly::w_off;
    const float* O = stg + Ly::o_off;
    const float* Sc = stg + Ly::s_off;

    // 1. warps 0-3: decays and rowsum(G . S_c), the first in two halves of
    // the columns j (each thread its own rotation: conflict-free), then D's
    // blocks (0,0), (1,0), (1,1); warps 4-7: S_c do^T and v G^T
    if (cuda_half) {
      decays<HS>(smem, Wst, ct);
      if (own) {
        float a = 0.f;
        const float* gr = Gs + ci * ST + cs * (HS / 2);
        const float* sr = Sc + ci * ST + cs * (HS / 2);
#pragma unroll 8
        for (int jj = 0; jj < HS / 2; ++jj) {
          const int j = (jj + ci) & (HS / 2 - 1);
          a += gr[j] * sr[j];
        }
        ex[(2 + cs) * HS + ci] = a;
      }
      if (wt < 3) {
        const int tb = wt == 0 ? 0 : 1, sb = wt == 2 ? 1 : 0;
        float acc[2][4], sm[2][4];
        zero(acc);
        zero(sm);
        gemm<2>(acc, sm, 0, HS, g, tq,
                [&](int m, int kk) { return O[(tb * SUB + m) * ST + kk]; },
                [&](int x, int kk, int nn) {
                  return V[(sb * SUB + x * 8 + nn) * ST + kk];
                });
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          float* dp = Ds + (tb * SUB + g) * DST + sb * SUB + x * 8 + 2 * tq;
          dp[0] = acc[x][0] + sm[x][0];
          dp[1] = acc[x][1] + sm[x][1];
          dp[8 * DST] = acc[x][2] + sm[x][2];
          dp[8 * DST + 1] = acc[x][3] + sm[x][3];
        }
      }
    } else {
      const int mt = wt & 1, j0 = (wt >> 1) * (HS / 2);
#pragma unroll
      for (int which = 0; which < 2; ++which) {
        // which 0: do S_c^T (rows t), 1: v G^T (rows s); columns i
        const float* Am = which ? V : O;
        const float* Bm = which ? Gs : Sc;
        float* out = which ? PK : PR;
        float acc[NJH][4], sm[NJH][4];
        zero(acc);
        zero(sm);
        gemm<NJH>(acc, sm, 0, HS, g, tq,
                  [&](int m, int kk) { return Am[(mt * 16 + m) * ST + kk]; },
                  [&](int x, int kk, int nn) {
                    return Bm[(j0 + x * 8 + nn) * ST + kk];
                  });
#pragma unroll
        for (int x = 0; x < NJH; ++x) {
          float* op = out + (mt * 16 + g) * ST + j0 + x * 8 + 2 * tq;
          op[0] = acc[x][0] + sm[x][0];
          op[1] = acc[x][1] + sm[x][1];
          op[8 * ST] = acc[x][2] + sm[x][2];
          op[8 * ST + 1] = acc[x][3] + sm[x][3];
        }
      }
    }
    __syncthreads();

    // 2. warps 0-3: A's diagonal blocks (wkv6.cu's), then the walk of the
    // diagonal blocks' pairs; warps 4-7: A's off-diagonal block, the off-
    // diagonal parts of dr and dk, and (k . cb) G into registers
    float drD[SUB], dkD[SUB], X[SUB];
    float dvb[NJH][4], dvs[NJH][4];
    const int mt = wt & 1, j0 = (wt >> 1) * (HS / 2);
    if (cuda_half) {
      // A_ts = sum_i r_t[i] k_s[i] prod_{s<m<t} W_m for t > s inside a
      // sub-chunk, and the u bonus at t = s: the thread takes key s1 for
      // 15 - dsp queries, then key s2 for dsp; its 8 lanes sum their
      // columns' parts in one butterfly (wkv6.cu's phase 2)
      const int dgrp = ct >> 3, da = dgrp & 1, dsp = dgrp >> 1;
      const int dc = (ct & 7) * (NC < 4 ? NC : 4);
      const unsigned dmask = 0xffu << (lane & 24);
      {
        const int s1 = da * SUB + dsp, s2 = da * SUB + SUB - 1 - dsp;
        const int n1 = SUB - 1 - dsp;
        float kd[NC], x[NC], e[NC], uu[NC], acc[16];
        float bonus2 = 0.f;
        ldn(uu, us + dc);
        ldn(kd, K + s2 * ST + dc);
        ldn(x, R + s2 * ST + dc);
#pragma unroll
        for (int c = 0; c < NC; ++c) bonus2 += x[c] * uu[c] * kd[c];
        ldn(kd, K + s1 * ST + dc);
        ldn(x, R + s1 * ST + dc);
        acc[15] = 0.f;
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[15] += x[c] * uu[c] * kd[c];
#pragma unroll
        for (int j = 0; j < SUB - 1; ++j) {
          if (j == n1) ldn(kd, K + s2 * ST + dc);
          const int t = j < n1 ? s1 + 1 + j : da * SUB + j + 1;
          ldn(x, R + t * ST + dc);
          ldn(e, Wst + t * ST + dc);
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
        const int isl = ct & 7;
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
          As[t * DST + s] = v2[i];
        }
        bonus2 += __shfl_xor_sync(dmask, bonus2, 1);
        bonus2 += __shfl_xor_sync(dmask, bonus2, 2);
        bonus2 += __shfl_xor_sync(dmask, bonus2, 4);
        if (isl == 0) As[s2 * DST + s2] = bonus2;
      }
      // the walk: for key s and query t > s of the thread's sub-chunk,
      // E_ts = prod_{s<q<t} W_q a factor at a time; dr_t += E k_s D_ts,
      // dk_s += E r_t D_ts, and the pair's dw term r_t k_s E D_ts into X_m
      // for every s < m < t (a running sum over t from the top down)
#pragma unroll
      for (int t = 0; t < SUB; ++t) drD[t] = dkD[t] = X[t] = 0.f;
      if (own) {
        float rv[SUB], kv[SUB], Wv[SUB];
#pragma unroll
        for (int t = 0; t < SUB; ++t) {
          rv[t] = R[(cbase + t) * ST + ci];
          kv[t] = K[(cbase + t) * ST + ci];
          Wv[t] = Wst[(cbase + t) * ST + ci];
        }
        const float* Dp = Ds + cbase * DST + cbase;
#pragma unroll
        for (int s = 0; s < SUB - 1; ++s) {
          float ed[SUB];       // E_ts D_ts for t > s
          float e = 1.f;
#pragma unroll
          for (int t = s + 1; t < SUB; ++t) {
            ed[t] = e * Dp[t * DST + s];
            e *= Wv[t];
          }
          float run = 0.f;
#pragma unroll
          for (int t = SUB - 1; t > s; --t) {
            drD[t] += kv[s] * ed[t];
            dkD[s] += rv[t] * ed[t];
            if (t < SUB - 1) X[t] += run;
            run += rv[t] * kv[s] * ed[t];
          }
        }
      }
    } else {
      // A's off-diagonal block: A[16 + t][s] = sum_i (r rf)_{16+t}[i]
      // (k rf)_s[i] (warp 4), and the off-diagonal block's parts: xr[t] =
      // rf_t . sum_s D_ts (k rf)_s (t in the second sub-chunk) and xk[s] =
      // rf_s . sum_t D_ts (r rf)_t (s in the first), two column tiles a
      // unit (warps 5-7)
      constexpr int NX = NJT / 2;          // units of xr, and of xk
      for (int q = wt ? wt - 1 : 2 * NX; q <= 2 * NX; q += wt ? 3 : 1) {
        if (wt && q == 2 * NX) break;
        float acc[2][4], sm[2][4];
        zero(acc);
        zero(sm);
        if (q == 2 * NX) {
          gemm<2>(acc, sm, 0, HS, g, tq,
                  [&](int m, int kk) {
                    return R[(SUB + m) * ST + kk] * RF[(SUB + m) * ST + kk];
                  },
                  [&](int x, int kk, int nn) {
                    const int s = x * 8 + nn;
                    return K[s * ST + kk] * RF[s * ST + kk];
                  });
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            float* ap = As + (SUB + g) * DST + x * 8 + 2 * tq;
            ap[0] = acc[x][0] + sm[x][0];
            ap[1] = acc[x][1] + sm[x][1];
            ap[8 * DST] = acc[x][2] + sm[x][2];
            ap[8 * DST + 1] = acc[x][3] + sm[x][3];
          }
          continue;
        }
        const bool is_k = q >= NX;
        const int i0 = (q % NX) * 16;
        if (!is_k)
          gemm<2>(acc, sm, 0, SUB, g, tq,
                  [&](int m, int kk) { return Ds[(SUB + m) * DST + kk]; },
                  [&](int x, int kk, int nn) {
                    const int i = i0 + x * 8 + nn;
                    return K[kk * ST + i] * RF[kk * ST + i];
                  });
        else
          gemm<2>(acc, sm, 0, SUB, g, tq,
                  [&](int m, int kk) { return Ds[(SUB + kk) * DST + m]; },
                  [&](int x, int kk, int nn) {
                    const int i = i0 + x * 8 + nn;
                    return R[(SUB + kk) * ST + i] * RF[(SUB + kk) * ST + i];
                  });
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          float* xp = (is_k ? XK : XR) + g * ST + i0 + x * 8 + 2 * tq;
          const float* fp =
              RF + ((is_k ? 0 : SUB) + g) * ST + i0 + x * 8 + 2 * tq;
          xp[0] = fp[0] * (acc[x][0] + sm[x][0]);
          xp[1] = fp[1] * (acc[x][1] + sm[x][1]);
          xp[8 * ST] = fp[8 * ST] * (acc[x][2] + sm[x][2]);
          xp[8 * ST + 1] = fp[8 * ST + 1] * (acc[x][3] + sm[x][3]);
        }
      }
      // dv's inter part (k . cb) G, held for step 3
      zero(dvb);
      zero(dvs);
      gemm<NJH>(dvb, dvs, 0, HS, g, tq,
                [&](int m, int kk) {
                  return K[(mt * 16 + m) * ST + kk] *
                         CB[(mt * 16 + m) * ST + kk];
                },
                [&](int x, int kk, int nn) {
                  return Gs[kk * ST + j0 + x * 8 + nn];
                });
    }
    __syncthreads();

    // 3. warps 0-3: dr, dk, dw of the chunk; warps 4-7: dv; then all: G
    if (cuda_half) {
      float P[SUB], Q[SUB], tot = 0.f;
      if (own) {
        const float ui = us[ci];
#pragma unroll
        for (int t = 0; t < SUB; ++t) {
          const int row = cbase + t;
          const float rt = R[row * ST + ci], kt = K[row * ST + ci];
          const float dtt = Ds[row * DST + row];
          const float dri = CF[row * ST + ci] * PR[row * ST + ci];
          const float dki = CB[row * ST + ci] * PK[row * ST + ci];
          const float drx = cs ? XR[t * ST + ci] : 0.f;
          const float dkx = cs ? 0.f : XK[t * ST + ci];
          // drD and dkD become the whole of dr and dk
          drD[t] += dri + drx + ui * kt * dtt;
          dkD[t] += dki + dkx + rt * ui * dtt;
          du_acc += rt * kt * dtt;
          P[t] = kt * (dki + dkx);
          Q[t] = rt * (dri + drx);
          tot += cs ? rt * dri : kt * dki;
        }
        ex[(4 + cs) * HS + ci] = tot;
      }
      half_sync(1);
      if (own) {
        const float other = ex[(5 - cs) * HS + ci];
        const float a = cend[ci] * (ex[2 * HS + ci] + ex[3 * HS + ci]);
        // before m: the sub-chunk's own P (the first sub-chunk's k . dkI
        // total ahead of the second's); after m: its own Q (the second's
        // r . drI total after the first's)
        float pre = cs ? other : 0.f;
#pragma unroll
        for (int t = 0; t < SUB; ++t) {
          const float p = P[t];
          P[t] = pre;
          pre += p;
        }
        float suf = cs ? 0.f : other;
#pragma unroll
        for (int t = SUB - 1; t >= 0; --t) {
          const int tg = n * C + cbase + t;
          const float dwt = a + P[t] + suf + X[t];
          suf += Q[t];
          if (tg < T) {
            const size_t at = base + (size_t)tg * step + ci;
            dr[at] = drD[t];
            dk[at] = dkD[t];
            dw[at] = dwt;
          }
        }
      }
    } else {
      // dv = (k . cb) G + A^T do: A^T's rows s of tile mt see t >= 16 mt
      gemm<NJH>(dvb, dvs, mt * 16, C, g, tq,
                [&](int m, int kk) { return As[kk * DST + mt * 16 + m]; },
                [&](int x, int kk, int nn) {
                  return O[kk * ST + j0 + x * 8 + nn];
                });
      const int t0 = n * C + mt * 16 + g, t1 = t0 + 8;
#pragma unroll
      for (int x = 0; x < NJH; ++x) {
        const size_t col = base + j0 + x * 8 + 2 * tq;
        if (t0 < T)
          *reinterpret_cast<float2*>(dv + col + (size_t)t0 * step) =
              make_float2(dvb[x][0] + dvs[x][0], dvb[x][1] + dvs[x][1]);
        if (t1 < T)
          *reinterpret_cast<float2*>(dv + col + (size_t)t1 * step) =
              make_float2(dvb[x][2] + dvs[x][2], dvb[x][3] + dvs[x][3]);
      }
    }
    // G <- cend . G + (r . cf)^T do, a unit a warp: nothing reads G in this
    // step
    for (int q = warp; q < 2 * NMT; q += NW)
      step_back<HS, NJH>(Gs, R, CF, O, cend, (q >> 1) * 16,
                         (q & 1) * (HS / 2), g, tq);
  }
  // du: the two sub-chunks' partials of each column, in a fixed order
  if (own) ex[cs * HS + ci] = du_acc;
  __syncthreads();
  if (own && cs == 0) du_part[(size_t)bh * HS + ci] = du_acc + ex[HS + ci];
}

template <int HS>
int launch(int n, cudaStream_t st, const float* r, const float* k,
           const float* v, const float* w, const float* u, const float* s0,
           const float* dout, const float* dstate, float* dr, float* dk,
           float* dv, float* dw, float* du_part, float* scratch, int T,
           int H) {
  const size_t smem = Layout<HS>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      wkv6_bwd_kernel<HS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  wkv6_bwd_kernel<HS><<<n, NT, smem, st>>>(r, k, v, w, u, s0, dout, dstate,
                                           dr, dk, dv, dw, du_part, scratch,
                                           T, H);
  return (int)cudaGetLastError();
}

}  // namespace

// Floats of the scratch buffer that wkv6_bwd_launch needs for (B, T, H,
// hs): the state before every chunk of 32 tokens of each (b, h).
extern "C" long long wkv6_bwd_scratch_floats(int B, int T, int H, int hs) {
  return (long long)B * H * ((T + C - 1) / C) * hs * hs;
}

// Returns cudaGetLastError() after the launch (0 when it was accepted), or
// cudaErrorInvalidValue for a head size without a kernel.  Inputs are f32
// and contiguous in the forward's layouts, 16-byte aligned; dstate may be
// null (a zero adjoint of the final state); du_part is (B, H, hs), summed
// over B by the caller; scratch holds wkv6_bwd_scratch_floats floats.
extern "C" int wkv6_bwd_launch(const void* r, const void* k, const void* v,
                               const void* w, const void* u, const void* s0,
                               const void* dout, const void* dstate,
                               void* dr, void* dk, void* dv, void* dw,
                               void* du_part, void* scratch, int B, int T,
                               int H, int hs, void* stream) {
  const int n = B * H;
  cudaStream_t st = (cudaStream_t)stream;
  const float *fr = (const float*)r, *fk = (const float*)k,
              *fv = (const float*)v, *fw = (const float*)w,
              *fu = (const float*)u, *fs0 = (const float*)s0,
              *fo = (const float*)dout, *fds = (const float*)dstate;
  float *gr = (float*)dr, *gk = (float*)dk, *gv = (float*)dv,
        *gw = (float*)dw, *gu = (float*)du_part, *sc = (float*)scratch;
  switch (hs) {
    case 16:
      return launch<16>(n, st, fr, fk, fv, fw, fu, fs0, fo, fds, gr, gk, gv,
                        gw, gu, sc, T, H);
    case 32:
      return launch<32>(n, st, fr, fk, fv, fw, fu, fs0, fo, fds, gr, gk, gv,
                        gw, gu, sc, T, H);
    case 64:
      return launch<64>(n, st, fr, fk, fv, fw, fu, fs0, fo, fds, gr, gk, gv,
                        gw, gu, sc, T, H);
    default: return (int)cudaErrorInvalidValue;
  }
}
