// The gradient of attention with a softmax, for grouped-query attention,
// on the tensor cores: the backward kernels of flash_attention.cu, in f32
// and in bf16.
//
// The TPU package has no backward kernel: the reference trains through its
// plain jnp attention (repro/models/layers/attention.py:chunked_attention,
// under jax.grad).  These kernels are the port's own, so that training on
// the card runs through flash_attention.cu forward and this file backward.
// Same function as flash_attention.cu: q (B, Sq, H, hd), k and v (B, Sk,
// KV, hd), query head h reading KV head h / (H / KV), scale hd^-0.5, the
// causal mask right-aligned (query i sees keys j <= i + Sk - Sq).  Given
// o, do (B, Sq, H, hd) and the rows' log-sum-exp lse (B, H, Sq) that the
// forward wrote, with P = exp(s * scale - lse) (0 where masked):
//     D  = rowsum(do . o)                           flash_bwd_dq, first
//     dQ = scale dS K,  dS = P . (dP - D), dP = do V^T   flash_bwd_dq
//     dV = P^T do,  dK = scale dS^T Q               flash_bwd_dkdv
// FlashAttention-2's split (Dao, 2023): dK and dV of a key block sum over
// every query head of its KV group and every query tile inside one block,
// and dQ of a query block over every key tile inside another, so no sum
// crosses blocks and there are no atomics: the gradients are the same bits
// from run to run.  The price is that S and dP are computed in both
// kernels: seven products where the function needs five.  Both kernels
// are templates on the element type (f32 or bf16: q, k, v, o, do in, dq,
// dk, dv out); lse and D are f32 in both.  Causal needs Sq <= Sk (the
// wrapper refuses more, ROADMAP F4); non-causal takes any Sq and Sk.
//
// Bound: at B = 8, Sq = Sk = 512, 32 query heads over 8 KV heads, hd = 128,
// causal, the five products (the scores, dP, dV, dK, dQ) over the 131,328
// (query, key) pairs on or below the diagonal of each (b, h) are 2 hd
// operations each, 43.0 G operations.  f32: 261 us in three TF32 passes on
// the tensor cores (642 us on the CUDA cores) against 336 MB, 100 us, of
// bytes (q, k, v, o, do, lse read once, dq, dk, dv written once):
// operations bind it.  bf16: 43.5 us in one pass at 989 TFLOP/s against
// 168,296,448 B (the lse f32), 50.2 us: bytes bind it (NVIDIA H100 SXM,
// 700 W).  chip_smoke.py phase k reads both forms' times and profiles;
// PERF.md keeps them.
//
// Both forms: one block of four warps per (64 query rows, h, b) for
// flash_bwd_dq, the tiles with the most keys first.  It computes D for its
// rows from o and do (so no launch of its own reads them again) and writes
// it for the other kernel.  Each warp owns 16 rows; K/V tiles of 16 keys
// stream through a two-stage cp.async ring up to the diagonal; per tile S
// = Q K^T and dP = do V^T (each 16 x 16), dS in registers, then dQ += dS K
// into the warp's 16 x hd C fragments.  flash_bwd_dkdv: one block of eight
// warps per (64-key block, KV head, b), the key blocks with the most query
// tiles first.  K and V of the block stay in shared memory while query
// tiles of 16 rows of each query head of the group, from the diagonal on,
// stream through the ring (Q, do, lse, D).  Warps w and w + 4 share 16
// keys: warp w computes S^T = K Q^T, P^T, and dV += P^T do; warp w + 4
// computes dP^T = V do^T, reads P^T (f32) from warp w through a per-pair
// tile in shared memory, forms dS^T and dK += dS^T Q.  Each holds one
// 16 x hd accumulator (64 registers at hd 128).  Tiles arrive zero-filled
// past the edges, and ragged tiles are masked.
//
// f32, f32-exact on the tensor cores: every product is mma.sync.m16n8k8 in
// TF32, three passes over operands split into big and small TF32 parts,
// CHUNK k-steps summed in fresh registers before an f32 add
// (flash_attention.cu's scheme and its split()).  Row strides of hd + 4
// keep the fragment reads that run along a row conflict-free (those that
// run down a column, B of dV, dK and dQ, meet two-way conflicts); a
// per-warp tile in shared memory turns C fragments of P and dS into A
// fragments.  Shared memory at hd 128: flash_bwd_dq 107,008 bytes,
// flash_bwd_dkdv 111,872: two blocks per SM each.
//
// bf16, designed for the bf16 tensor cores: every product is
// mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32, one pass, f32 sums.  S,
// dP, the log-sum-exp and D stay f32; P and dS are rounded to bf16 where
// they enter dV = P^T do, dQ = dS K and dK = dS^T Q (FlashAttention-2's
// rounding, and the reference's at attention.py's p.astype(v.dtype)); dq,
// dk and dv sum in f32 registers and are written once, in bf16.  The C
// fragment of a 16 x 16 m16n8 tile is the A fragment of m16k16, so P and
// dS pass from one product to the next in registers (dS^T's P^T still
// crosses the warp pair in f32).  Operands stay bf16 in shared memory,
// rows hd + 8 apart: the 32-bit fragment reads along a row and the
// ldmatrix.trans reads of B down a column (K in dS K, Q, do) are
// conflict-free.  Shared memory at hd 128: flash_bwd_dq 52,736 bytes,
// flash_bwd_dkdv 57,600, half the f32 form's.  Blocks per SM at hd 128
// (ptxas, chip_smoke.py phase k): flash_bwd_dq three, by its 152
// registers a thread (shared memory would take four), flash_bwd_dkdv
// two, by its 128 (the launch bound's limit).
//
// What holds the f32 form back (NVIDIA H100 80GB HBM3 at 700 W, PERF.md):
// each kernel runs its mma.sync at about a quarter of the TF32 peak.
// Every fragment element is a shared-memory load and, for the split, three
// integer or float operations, about six instructions per mma, and the
// 16-wide tiles (S and dP are 16 x 16 per warp) share a split A fragment
// between two column tiles only.  wgmma, whose operands come from shared
// memory, and TMA loads are the later form of both.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int KB = 64;         // keys per block of flash_bwd_dkdv, 16 a pair
constexpr int QT = 16;         // query rows per tile there
constexpr int NWK = 8;         // its warps: four pairs
constexpr int QB = 64;         // query rows per block of flash_bwd_dq
constexpr int KT = 16;         // keys per tile there
constexpr int NWQ = 4;         // its warps
constexpr int CHUNK = 2;       // k-steps of 8 summed in fresh registers
constexpr int TST = 16 + 4;    // row stride of a warp's 16 x 16 P / dS tile
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_GRID_YZ = 65535;

template <int HD>
struct DqTiles {
  static constexpr int ST = HD + 4;
  static constexpr int q = 0;                    // QB x ST: Q, then do
  static constexpr int o = QB * ST;
  static constexpr int ring = 2 * QB * ST;       // 2 x (K, V): KT x ST each
  static constexpr int stage = 2 * KT * ST;
  static constexpr int s = ring + 2 * stage;     // NWQ x 16 x TST: dS
  static constexpr int l = s + NWQ * 16 * TST;   // QB: lse, then D
  static constexpr int d = l + QB;
  static constexpr size_t bytes = sizeof(float) * (d + QB);
};

template <int HD>
struct DkdvTiles {
  static constexpr int ST = HD + 4;
  static constexpr int k = 0;                    // KB x ST: K, then V
  static constexpr int v = KB * ST;
  static constexpr int ring = 2 * KB * ST;       // 2 x (Q, do, lse, D)
  static constexpr int q_off = 0;
  static constexpr int o_off = QT * ST;
  static constexpr int l_off = 2 * QT * ST;
  static constexpr int d_off = l_off + QT;
  static constexpr int stage = d_off + QT;
  static constexpr int p = ring + 2 * stage;     // 4 x 16 x TST: P^T
  static constexpr int s = p + 4 * 16 * TST;     // 4 x 16 x TST: dS^T
  static constexpr size_t bytes = sizeof(float) * (s + 4 * 16 * TST);
};

// x = big + small, each exact in TF32 (flash_attention.cu's split)
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

// acc += A B over k in [k0, k1) (a multiple of 8 CH long) for one 16-row
// tile and NJ tiles of 8 columns, in three TF32 passes: A(m, k) and
// B(x, k, n) give the f32 elements (m, n inside the tile).  A's fragments
// of a chunk are split once; each column tile sums the chunk in fresh
// registers, small terms first, before an f32 add (flash_attention.cu's
// order)
template <int NJ, int CH = CHUNK, class FA, class FB>
__device__ __forceinline__ void gemm(float (&acc)[NJ][4], int k0, int k1,
                                     int g, int tq, FA A, FB B) {
  for (int kc = k0; kc < k1; kc += 8 * CH) {
    uint32_t ab[CH][4], as[CH][4];
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const int k = kc + 8 * c + tq;
      split(A(g, k), ab[c][0], as[c][0]);
      split(A(g + 8, k), ab[c][1], as[c][1]);
      split(A(g, k + 4), ab[c][2], as[c][2]);
      split(A(g + 8, k + 4), ab[c][3], as[c][3]);
    }
#pragma unroll
    for (int x = 0; x < NJ; ++x) {
      float t[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        const int k = kc + 8 * c + tq;
        uint32_t bb0, bs0, bb1, bs1;
        split(B(x, k, g), bb0, bs0);
        split(B(x, k + 4, g), bb1, bs1);
        mma(t, as[c], bb0, bb1);
        mma(t, ab[c], bs0, bs1);
        mma(t, ab[c], bb0, bb1);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[x][e] += t[e];
    }
  }
}

template <int NJ>
__device__ __forceinline__ void zero(float (&a)[NJ][4]) {
#pragma unroll
  for (int x = 0; x < NJ; ++x)
#pragma unroll
    for (int e = 0; e < 4; ++e) a[x][e] = 0.f;
}

// 16 (or 4) bytes from global to shared memory, zero-filled where !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(s), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
               :: "r"(s), "l"(src), "r"(valid ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}

// ---- the f32 form: three TF32 passes -----------------------------------

template <int HD>
__device__ __forceinline__ void dq_f32(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ o,
    const float* __restrict__ dout, const float* __restrict__ lse,
    float* __restrict__ D, float* __restrict__ dq, int Sq, int Sk, int H,
    int KV, int causal, float scale, float* smem) {
  using L = DqTiles<HD>;
  constexpr int ST = L::ST, NT = 32 * NWQ, CPR = HD / 4, NO = HD / 8;
  float* Qs = smem + L::q;
  float* Os = smem + L::o;          // do
  float* Ls = smem + L::l;
  float* Dsm = smem + L::d;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  float* Sw = smem + L::s + warp * 16 * TST;

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * QB;   // longest tiles first
  const int kvh = h / (H / KV), off = Sk - Sq;
  const size_t qstep = (size_t)H * HD, kstep = (size_t)KV * HD;
  const float* qb = q + ((size_t)b * Sq * H + h) * HD;
  const float* ob = o + ((size_t)b * Sq * H + h) * HD;
  const float* gb = dout + ((size_t)b * Sq * H + h) * HD;
  const float* kb = k + ((size_t)b * Sk * KV + kvh) * HD;
  const float* vb = v + ((size_t)b * Sk * KV + kvh) * HD;
  const int q_end = min(q0 + QB, Sq);
  const int k_end = causal ? min(Sk, q_end + off) : Sk;
  const int n_tiles = (k_end + KT - 1) / KT;

  auto load_kv = [&](int tile, int stage) {
    float* Kd = smem + L::ring + stage * L::stage;
    float* Vd = Kd + KT * ST;
    const int k0 = tile * KT;
    for (int i = tid; i < KT * CPR; i += NT) {
      const int r = i / CPR, c = (i % CPR) * 4;
      const bool ok = k0 + r < Sk;
      const size_t at = (size_t)(ok ? k0 + r : 0) * kstep + c;
      cp_async16(Kd + r * ST + c, kb + at, ok);
      cp_async16(Vd + r * ST + c, vb + at, ok);
    }
    cp_async_commit();
  };
  if (n_tiles > 0) load_kv(0, 0);
  for (int i = tid; i < QB * CPR; i += NT) {
    const int r = i / CPR, c = (i % CPR) * 4;
    const bool ok = q0 + r < Sq;
    const size_t at = (size_t)(ok ? q0 + r : 0) * qstep + c;
    cp_async16(Qs + r * ST + c, qb + at, ok);
    cp_async16(Os + r * ST + c, gb + at, ok);
  }
  cp_async_commit();
  // D = rowsum(do . o) of the block's rows, by warp; lse beside it
  const int r0 = warp * 16;
  for (int rr = 0; rr < 16; ++rr) {
    const int row = q0 + r0 + rr;
    float s = 0.f;
    if (row < Sq) {
      for (int c = lane * 4; c < HD; c += 128) {
        const float4 a = *reinterpret_cast<const float4*>(
            ob + (size_t)row * qstep + c);
        const float4 e = *reinterpret_cast<const float4*>(
            gb + (size_t)row * qstep + c);
        s += a.x * e.x + a.y * e.y + a.z * e.z + a.w * e.w;
      }
    }
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) s += __shfl_xor_sync(FULL, s, m);
    if (lane == 0) {
      const size_t at = ((size_t)b * H + h) * Sq + row;
      Dsm[r0 + rr] = s;
      Ls[r0 + rr] = row < Sq ? lse[at] : 0.f;
      if (row < Sq) D[at] = s;
    }
  }

  float acc[NO][4];
  zero(acc);
  const int qpos0 = q0 + r0 + g + off, qpos1 = qpos0 + 8;
  const bool in0 = q0 + r0 + g < Sq, in1 = q0 + r0 + g + 8 < Sq;
  const float* Qw = Qs + r0 * ST;
  const float* Ow = Os + r0 * ST;
  for (int j = 0; j < n_tiles; ++j) {
    const int st = j & 1;
    cp_async_wait_all();
    __syncthreads();     // tile j (and Q, do, lse, D) are in; tile j - 1 done
    if (j + 1 < n_tiles) load_kv(j + 1, st ^ 1);
    const float* Kt = smem + L::ring + st * L::stage;
    const float* Vt = Kt + KT * ST;
    const int k0 = j * KT;
    float s[2][4], dp[2][4];
    zero(s);
    zero(dp);
    gemm<2>(s, 0, HD, g, tq, [&](int m, int c) { return Qw[m * ST + c]; },
            [&](int x, int c, int n) { return Kt[(x * 8 + n) * ST + c]; });
    gemm<2>(dp, 0, HD, g, tq, [&](int m, int c) { return Ow[m * ST + c]; },
            [&](int x, int c, int n) { return Vt[(x * 8 + n) * ST + c]; });
    // dS = P . (dP - D), P = exp(s scale - lse), 0 where masked; C
    // fragment: [x][0..1] row g, keys x * 8 + 2 tq + {0, 1}; [x][2..3] row
    // g + 8
    const float l0 = Ls[r0 + g], l1 = Ls[r0 + g + 8];
    const float d0 = Dsm[r0 + g], d1 = Dsm[r0 + g + 8];
#pragma unroll
    for (int x = 0; x < 2; ++x)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kpos = k0 + x * 8 + 2 * tq + e;
        const bool ok = kpos < Sk;
        const float p0 = ok && in0 && (!causal || kpos <= qpos0)
                             ? expf(s[x][e] * scale - l0) : 0.f;
        const float p1 = ok && in1 && (!causal || kpos <= qpos1)
                             ? expf(s[x][2 + e] * scale - l1) : 0.f;
        Sw[g * TST + x * 8 + 2 * tq + e] = p0 * (dp[x][e] - d0);
        Sw[(g + 8) * TST + x * 8 + 2 * tq + e] = p1 * (dp[x][2 + e] - d1);
      }
    __syncwarp();
    // dQ += dS K: the warp's 16 rows x hd
    gemm<NO>(acc, 0, KT, g, tq, [&](int m, int c) { return Sw[m * TST + c]; },
             [&](int x, int c, int n) { return Kt[c * ST + x * 8 + n]; });
    __syncwarp();        // the warp's dS tile is read before it is refilled
  }

  float* qd = dq + ((size_t)b * Sq * H + h) * HD;
  const int row0 = q0 + r0 + g, row1 = row0 + 8;
#pragma unroll
  for (int x = 0; x < NO; ++x) {
    const int col = x * 8 + 2 * tq;
    if (row0 < Sq)
      store2(qd + (size_t)row0 * qstep + col, acc[x][0] * scale,
             acc[x][1] * scale);
    if (row1 < Sq)
      store2(qd + (size_t)row1 * qstep + col, acc[x][2] * scale,
             acc[x][3] * scale);
  }
}

template <int HD>
__device__ __forceinline__ void dkdv_f32(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ D,
    float* __restrict__ dk, float* __restrict__ dv, int Sq, int Sk, int H,
    int KV, int causal, float scale, float* smem) {
  using L = DkdvTiles<HD>;
  constexpr int ST = L::ST, NT = 32 * NWK, CPR = HD / 4, NO = HD / 8;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int pair = warp & 3;
  const bool score_warp = warp < 4;     // S^T, P^T, dV; else dP^T, dS^T, dK
  float* Pt = smem + L::p + pair * 16 * TST;
  float* St = smem + L::s + pair * 16 * TST;

  const int kvh = blockIdx.x, b = blockIdx.y;
  const int k0 = blockIdx.z * KB;      // causal: the first blocks see most
  const int group = H / KV, off = Sk - Sq;
  const size_t qstep = (size_t)H * HD, kstep = (size_t)KV * HD;
  const float* kb = k + ((size_t)b * Sk * KV + kvh) * HD;
  const float* vb = v + ((size_t)b * Sk * KV + kvh) * HD;
  // queries that see a key of this block: all, or from the diagonal on
  const int i_first = causal ? max(0, k0 - off) / QT * QT : 0;
  const int n_qt = (Sq - i_first + QT - 1) / QT;
  const int n_tiles = group * n_qt;

  // tile x: query head kvh * group + x / n_qt, rows i0 .. i0 + 15
  auto load_q = [&](int x, int stage) {
    float* dst = smem + L::ring + stage * L::stage;
    const int h = kvh * group + x / n_qt;
    const int i0 = i_first + (x % n_qt) * QT;
    const float* qb = q + ((size_t)b * Sq * H + h) * HD;
    const float* gb = dout + ((size_t)b * Sq * H + h) * HD;
    for (int i = tid; i < QT * CPR; i += NT) {
      const int r = i / CPR, c = (i % CPR) * 4;
      const bool ok = i0 + r < Sq;
      const size_t at = (size_t)(ok ? i0 + r : 0) * qstep + c;
      cp_async16(dst + L::q_off + r * ST + c, qb + at, ok);
      cp_async16(dst + L::o_off + r * ST + c, gb + at, ok);
    }
    if (tid < 2 * QT) {
      const int r = tid % QT;
      const bool ok = i0 + r < Sq;
      const size_t at = ((size_t)b * H + h) * Sq + (ok ? i0 + r : 0);
      if (tid < QT)
        cp_async4(dst + L::l_off + r, lse + at, ok);
      else
        cp_async4(dst + L::d_off + r, D + at, ok);
    }
    cp_async_commit();
  };
  for (int i = tid; i < KB * CPR; i += NT) {
    const int r = i / CPR, c = (i % CPR) * 4;
    const bool ok = k0 + r < Sk;
    const size_t at = (size_t)(ok ? k0 + r : 0) * kstep + c;
    cp_async16(smem + L::k + r * ST + c, kb + at, ok);
    cp_async16(smem + L::v + r * ST + c, vb + at, ok);
  }
  if (n_tiles > 0)
    load_q(0, 0);
  else
    cp_async_commit();

  float acc[NO][4];          // dV (score warps) or dK (the others)
  zero(acc);
  const float* Kw = smem + (score_warp ? L::k : L::v) + pair * 16 * ST;
  const int key0 = k0 + pair * 16 + g, key1 = key0 + 8;
  for (int x = 0; x < n_tiles; ++x) {
    const int st = x & 1;
    cp_async_wait_all();
    __syncthreads();     // tile x (and K, V) are in; tile x - 1 is done
    if (x + 1 < n_tiles) load_q(x + 1, st ^ 1);
    const float* stg = smem + L::ring + st * L::stage;
    const float* Qt = stg + L::q_off;
    const float* Ot = stg + L::o_off;
    const int i0 = i_first + (x % n_qt) * QT;
    // S^T = K Q^T (score warps) or dP^T = V do^T: 16 keys x 16 queries;
    // C fragment: [y][0..1] key g, queries y * 8 + 2 tq + {0, 1}; [y][2..3]
    // key g + 8
    float sc[2][4];
    zero(sc);
    const float* Bt = score_warp ? Qt : Ot;
    gemm<2>(sc, 0, HD, g, tq, [&](int m, int c) { return Kw[m * ST + c]; },
            [&](int y, int c, int n) { return Bt[(y * 8 + n) * ST + c]; });
    if (score_warp) {
#pragma unroll
      for (int y = 0; y < 2; ++y)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int ql = y * 8 + 2 * tq + e, i = i0 + ql;
          const float lq = stg[L::l_off + ql];
          const bool ok = i < Sq;
          const bool ok0 = ok && key0 < Sk && (!causal || key0 <= i + off);
          const bool ok1 = ok && key1 < Sk && (!causal || key1 <= i + off);
          Pt[g * TST + ql] = ok0 ? expf(sc[y][e] * scale - lq) : 0.f;
          Pt[(g + 8) * TST + ql] =
              ok1 ? expf(sc[y][2 + e] * scale - lq) : 0.f;
        }
    }
    __syncthreads();     // every P^T tile is stored
    const float* At = Pt;
    if (!score_warp) {
      // dS^T = P^T . (dP^T - D), read in this warp's own fragment layout
#pragma unroll
      for (int y = 0; y < 2; ++y)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int ql = y * 8 + 2 * tq + e;
          const float dq_ = stg[L::d_off + ql];
          St[g * TST + ql] = Pt[g * TST + ql] * (sc[y][e] - dq_);
          St[(g + 8) * TST + ql] =
              Pt[(g + 8) * TST + ql] * (sc[y][2 + e] - dq_);
        }
      __syncwarp();
      At = St;
    }
    // dV += P^T do (score warps), dK += dS^T Q (the others), a k-step at a
    // time: beside the 16 x hd accumulator, two k-steps of A fragments
    // spilled at hd 128 (two blocks per SM give 128 registers a thread)
    const float* Bm = score_warp ? Ot : Qt;
    gemm<NO, 1>(acc, 0, QT, g, tq,
                [&](int m, int c) { return At[m * TST + c]; },
                [&](int y, int c, int n) { return Bm[c * ST + y * 8 + n]; });
  }

  float* out = (score_warp ? dv : dk) + ((size_t)b * Sk * KV + kvh) * HD;
  const float f = score_warp ? 1.f : scale;
#pragma unroll
  for (int y = 0; y < NO; ++y) {
    const int col = y * 8 + 2 * tq;
    if (key0 < Sk)
      store2(out + (size_t)key0 * kstep + col, acc[y][0] * f,
             acc[y][1] * f);
    if (key1 < Sk)
      store2(out + (size_t)key1 * kstep + col, acc[y][2] * f,
             acc[y][3] * f);
  }
}

// ---- the bf16 form: mma.sync.m16n8k16 on bf16 operands, one pass -------
//
// Operands stay bf16 in shared memory (row stride hd + 8: the 32-bit
// fragment reads and the ldmatrix rows are conflict-free); S, dP, the
// log-sum-exp and D are f32; P and dS are rounded to bf16 where they
// become A fragments.  The m16n8 C fragment of a 16 x 16 tile (two n-tiles)
// is the m16k16 A fragment of the same tile, so P and dS go from the
// accumulator's registers to the next product's without a shared tile.
using bf16 = __nv_bfloat16;
constexpr int BST_PAD = 8;     // bf16 row padding

template <int HD>
struct DqTilesBf16 {           // byte offsets
  static constexpr int ST = HD + BST_PAD;
  static constexpr size_t q = 0;                        // QB x ST: Q
  static constexpr size_t o = q + sizeof(bf16) * QB * ST;   // do
  static constexpr size_t ring = o + sizeof(bf16) * QB * ST;
  static constexpr size_t stage = sizeof(bf16) * 2 * KT * ST;   // K, V
  static constexpr size_t l = ring + 2 * stage;         // QB f32: lse
  static constexpr size_t d = l + sizeof(float) * QB;   // QB f32: D
  static constexpr size_t bytes = d + sizeof(float) * QB;
};

template <int HD>
struct DkdvTilesBf16 {         // byte offsets
  static constexpr int ST = HD + BST_PAD;
  static constexpr size_t k = 0;                        // KB x ST: K
  static constexpr size_t v = sizeof(bf16) * KB * ST;   // V
  static constexpr size_t ring = 2 * v;                 // 2 x (Q, do, lse, D)
  static constexpr size_t q_off = 0;
  static constexpr size_t o_off = sizeof(bf16) * QT * ST;
  static constexpr size_t l_off = 2 * o_off;
  static constexpr size_t d_off = l_off + sizeof(float) * QT;
  static constexpr size_t stage = d_off + sizeof(float) * QT;
  static constexpr size_t p = ring + 2 * stage;         // 4 x 16 x TST f32
  static constexpr size_t bytes = p + sizeof(float) * 4 * 16 * TST;
};

// d += a b for a 16 x 16 bf16 A fragment and a 16 x 8 B fragment, f32 sums
__device__ __forceinline__ void mma16(float (&d)[4], const uint32_t (&a)[4],
                                      uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two neighbouring bf16 of shared memory, the lower index in the low half
__device__ __forceinline__ uint32_t ld2(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// two f32 rounded to bf16 and packed, x in the low half
__device__ __forceinline__ uint32_t pack2(float x, float y) {
  const __nv_bfloat162 t = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&t);
}

// the A fragment of the 16 x 16 tile of X (row stride ST) at column kk
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const bf16* X,
                                       int ST, int kk, int g, int tq) {
  const bf16* p = X + g * ST + kk + 2 * tq;
  a[0] = ld2(p);
  a[1] = ld2(p + 8 * ST);
  a[2] = ld2(p + 8);
  a[3] = ld2(p + 8 * ST + 8);
}

// the A fragment of a 16 x 16 tile from its C fragments (two n-tiles of
// 8), rounded to bf16
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4],
                                       const float (&c)[2][4]) {
  a[0] = pack2(c[0][0], c[0][1]);
  a[1] = pack2(c[0][2], c[0][3]);
  a[2] = pack2(c[1][0], c[1][1]);
  a[3] = pack2(c[1][2], c[1][3]);
}

// B fragments of two n-tiles of 8 columns from a 16-row tile stored row
// by row (k along the rows: K in dS K, Q in dS^T Q, do in P^T do), by
// ldmatrix with transpose: r[0], r[1] the first n-tile's, r[2], r[3] the
// second's.  p: the lane's row, lane & 15, at column n0 + 8 (lane >> 4)
__device__ __forceinline__ void frag_b_t(uint32_t (&r)[4], const bf16* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
               "{%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s) : "memory");
}

// acc (16 x HD) += A B for a 16 x 16 A fragment a and B the 16 x HD tile X
// (row stride ST) read by frag_b_t
template <int HD>
__device__ __forceinline__ void gemm_t(float (&acc)[HD / 8][4],
                                       const uint32_t (&a)[4], const bf16* X,
                                       int ST, int lane) {
  const bf16* p = X + (lane & 15) * ST + (lane >> 4) * 8;
#pragma unroll
  for (int n = 0; n < HD / 16; ++n) {
    uint32_t b[4];
    frag_b_t(b, p + 16 * n);
    mma16(acc[2 * n], a, b[0], b[1]);
    mma16(acc[2 * n + 1], a, b[2], b[3]);
  }
}

// c (16 x 16) += A B^T over k in [0, HD): A the 16 rows of X, B the 16 rows
// of Y (k along both rows, row stride ST)
template <int HD>
__device__ __forceinline__ void gemm_nt(float (&c)[2][4], const bf16* X,
                                        const bf16* Y, int ST, int g,
                                        int tq) {
#pragma unroll
  for (int kk = 0; kk < HD; kk += 16) {
    uint32_t a[4];
    frag_a(a, X, ST, kk, g, tq);
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const bf16* y = Y + (x * 8 + g) * ST + kk + 2 * tq;
      mma16(c[x], a, ld2(y), ld2(y + 8));
    }
  }
}

__device__ __forceinline__ void store2(bf16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

template <int HD>
__device__ __forceinline__ void dq_bf16(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ o,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    float* __restrict__ D, bf16* __restrict__ dq, int Sq, int Sk, int H,
    int KV, int causal, float scale, unsigned char* smem) {
  using L = DqTilesBf16<HD>;
  constexpr int ST = L::ST, NT = 32 * NWQ, CPR = HD / 8, NO = HD / 8;
  bf16* Qs = reinterpret_cast<bf16*>(smem + L::q);
  bf16* Os = reinterpret_cast<bf16*>(smem + L::o);      // do
  float* Ls = reinterpret_cast<float*>(smem + L::l);
  float* Dsm = reinterpret_cast<float*>(smem + L::d);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * QB;   // longest tiles first
  const int kvh = h / (H / KV), off = Sk - Sq;
  const size_t qstep = (size_t)H * HD, kstep = (size_t)KV * HD;
  const bf16* qb = q + ((size_t)b * Sq * H + h) * HD;
  const bf16* ob = o + ((size_t)b * Sq * H + h) * HD;
  const bf16* gb = dout + ((size_t)b * Sq * H + h) * HD;
  const bf16* kb = k + ((size_t)b * Sk * KV + kvh) * HD;
  const bf16* vb = v + ((size_t)b * Sk * KV + kvh) * HD;
  const int q_end = min(q0 + QB, Sq);
  const int k_end = causal ? min(Sk, q_end + off) : Sk;
  const int n_tiles = (k_end + KT - 1) / KT;

  auto load_kv = [&](int tile, int stage) {
    bf16* Kd = reinterpret_cast<bf16*>(smem + L::ring + stage * L::stage);
    bf16* Vd = Kd + KT * ST;
    const int k0 = tile * KT;
    for (int i = tid; i < KT * CPR; i += NT) {
      const int r = i / CPR, c = (i % CPR) * 8;
      const bool ok = k0 + r < Sk;
      const size_t at = (size_t)(ok ? k0 + r : 0) * kstep + c;
      cp_async16(Kd + r * ST + c, kb + at, ok);
      cp_async16(Vd + r * ST + c, vb + at, ok);
    }
    cp_async_commit();
  };
  if (n_tiles > 0) load_kv(0, 0);
  for (int i = tid; i < QB * CPR; i += NT) {
    const int r = i / CPR, c = (i % CPR) * 8;
    const bool ok = q0 + r < Sq;
    const size_t at = (size_t)(ok ? q0 + r : 0) * qstep + c;
    cp_async16(Qs + r * ST + c, qb + at, ok);
    cp_async16(Os + r * ST + c, gb + at, ok);
  }
  cp_async_commit();
  // D = rowsum(do . o) of the block's rows in f32, by warp; lse beside it
  const int r0 = warp * 16;
  for (int rr = 0; rr < 16; ++rr) {
    const int row = q0 + r0 + rr;
    float s = 0.f;
    if (row < Sq) {
      for (int c = lane * 8; c < HD; c += 256) {
        const uint4 a = *reinterpret_cast<const uint4*>(
            ob + (size_t)row * qstep + c);
        const uint4 e = *reinterpret_cast<const uint4*>(
            gb + (size_t)row * qstep + c);
        const bf16* ae = reinterpret_cast<const bf16*>(&a);
        const bf16* ee = reinterpret_cast<const bf16*>(&e);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          s += __bfloat162float(ae[j]) * __bfloat162float(ee[j]);
      }
    }
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) s += __shfl_xor_sync(FULL, s, m);
    if (lane == 0) {
      const size_t at = ((size_t)b * H + h) * Sq + row;
      Dsm[r0 + rr] = s;
      Ls[r0 + rr] = row < Sq ? lse[at] : 0.f;
      if (row < Sq) D[at] = s;
    }
  }

  float acc[NO][4];
  zero(acc);
  const int qpos0 = q0 + r0 + g + off, qpos1 = qpos0 + 8;
  const bool in0 = q0 + r0 + g < Sq, in1 = q0 + r0 + g + 8 < Sq;
  const bf16* Qw = Qs + r0 * ST;
  const bf16* Ow = Os + r0 * ST;
  for (int j = 0; j < n_tiles; ++j) {
    const int st = j & 1;
    cp_async_wait_all();
    __syncthreads();     // tile j (and Q, do, lse, D) are in; tile j - 1 done
    if (j + 1 < n_tiles) load_kv(j + 1, st ^ 1);
    const bf16* Kt =
        reinterpret_cast<const bf16*>(smem + L::ring + st * L::stage);
    const bf16* Vt = Kt + KT * ST;
    const int k0 = j * KT;
    // S = Q K^T and dP = do V^T, 16 x 16 each, f32
    float s[2][4], dp[2][4];
    zero(s);
    zero(dp);
    gemm_nt<HD>(s, Qw, Kt, ST, g, tq);
    gemm_nt<HD>(dp, Ow, Vt, ST, g, tq);
    // dS = P . (dP - D) in f32, P = exp(s scale - lse), 0 where masked
    const float l0 = Ls[r0 + g], l1 = Ls[r0 + g + 8];
    const float d0 = Dsm[r0 + g], d1 = Dsm[r0 + g + 8];
#pragma unroll
    for (int x = 0; x < 2; ++x)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kpos = k0 + x * 8 + 2 * tq + e;
        const bool ok = kpos < Sk;
        const float p0 = ok && in0 && (!causal || kpos <= qpos0)
                             ? expf(s[x][e] * scale - l0) : 0.f;
        const float p1 = ok && in1 && (!causal || kpos <= qpos1)
                             ? expf(s[x][2 + e] * scale - l1) : 0.f;
        s[x][e] = p0 * (dp[x][e] - d0);
        s[x][2 + e] = p1 * (dp[x][2 + e] - d1);
      }
    // dQ += dS K: dS rounded to bf16 in the A fragment
    uint32_t a[4];
    c_to_a(a, s);
    gemm_t<HD>(acc, a, Kt, ST, lane);
  }

  bf16* qd = dq + ((size_t)b * Sq * H + h) * HD;
  const int row0 = q0 + r0 + g, row1 = row0 + 8;
#pragma unroll
  for (int x = 0; x < NO; ++x) {
    const int col = x * 8 + 2 * tq;
    if (row0 < Sq)
      store2(qd + (size_t)row0 * qstep + col, acc[x][0] * scale,
             acc[x][1] * scale);
    if (row1 < Sq)
      store2(qd + (size_t)row1 * qstep + col, acc[x][2] * scale,
             acc[x][3] * scale);
  }
}

template <int HD>
__device__ __forceinline__ void dkdv_bf16(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ D,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int Sq, int Sk, int H,
    int KV, int causal, float scale, unsigned char* smem) {
  using L = DkdvTilesBf16<HD>;
  constexpr int ST = L::ST, NT = 32 * NWK, CPR = HD / 8, NO = HD / 8;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int pair = warp & 3;
  const bool score_warp = warp < 4;     // S^T, P^T, dV; else dP^T, dS^T, dK
  float* Pt = reinterpret_cast<float*>(smem + L::p) + pair * 16 * TST;

  const int kvh = blockIdx.x, b = blockIdx.y;
  const int k0 = blockIdx.z * KB;      // causal: the first blocks see most
  const int group = H / KV, off = Sk - Sq;
  const size_t qstep = (size_t)H * HD, kstep = (size_t)KV * HD;
  const bf16* kb = k + ((size_t)b * Sk * KV + kvh) * HD;
  const bf16* vb = v + ((size_t)b * Sk * KV + kvh) * HD;
  // queries that see a key of this block: all, or from the diagonal on
  const int i_first = causal ? max(0, k0 - off) / QT * QT : 0;
  const int n_qt = (Sq - i_first + QT - 1) / QT;
  const int n_tiles = group * n_qt;

  // tile x: query head kvh * group + x / n_qt, rows i0 .. i0 + 15
  auto load_q = [&](int x, int stage) {
    unsigned char* dst = smem + L::ring + stage * L::stage;
    bf16* Qd = reinterpret_cast<bf16*>(dst + L::q_off);
    bf16* Od = reinterpret_cast<bf16*>(dst + L::o_off);
    const int h = kvh * group + x / n_qt;
    const int i0 = i_first + (x % n_qt) * QT;
    const bf16* qb = q + ((size_t)b * Sq * H + h) * HD;
    const bf16* gb = dout + ((size_t)b * Sq * H + h) * HD;
    for (int i = tid; i < QT * CPR; i += NT) {
      const int r = i / CPR, c = (i % CPR) * 8;
      const bool ok = i0 + r < Sq;
      const size_t at = (size_t)(ok ? i0 + r : 0) * qstep + c;
      cp_async16(Qd + r * ST + c, qb + at, ok);
      cp_async16(Od + r * ST + c, gb + at, ok);
    }
    if (tid < 2 * QT) {
      const int r = tid % QT;
      const bool ok = i0 + r < Sq;
      const size_t at = ((size_t)b * H + h) * Sq + (ok ? i0 + r : 0);
      if (tid < QT)
        cp_async4(reinterpret_cast<float*>(dst + L::l_off) + r, lse + at,
                  ok);
      else
        cp_async4(reinterpret_cast<float*>(dst + L::d_off) + r, D + at, ok);
    }
    cp_async_commit();
  };
  bf16* Ks = reinterpret_cast<bf16*>(smem + L::k);
  bf16* Vs = reinterpret_cast<bf16*>(smem + L::v);
  for (int i = tid; i < KB * CPR; i += NT) {
    const int r = i / CPR, c = (i % CPR) * 8;
    const bool ok = k0 + r < Sk;
    const size_t at = (size_t)(ok ? k0 + r : 0) * kstep + c;
    cp_async16(Ks + r * ST + c, kb + at, ok);
    cp_async16(Vs + r * ST + c, vb + at, ok);
  }
  if (n_tiles > 0)
    load_q(0, 0);
  else
    cp_async_commit();

  float acc[NO][4];          // dV (score warps) or dK (the others)
  zero(acc);
  const bf16* Kw = (score_warp ? Ks : Vs) + pair * 16 * ST;
  const int key0 = k0 + pair * 16 + g, key1 = key0 + 8;
  for (int x = 0; x < n_tiles; ++x) {
    const int st = x & 1;
    cp_async_wait_all();
    __syncthreads();     // tile x (and K, V) are in; tile x - 1 is done
    if (x + 1 < n_tiles) load_q(x + 1, st ^ 1);
    const unsigned char* stg = smem + L::ring + st * L::stage;
    const bf16* Qt = reinterpret_cast<const bf16*>(stg + L::q_off);
    const bf16* Ot = reinterpret_cast<const bf16*>(stg + L::o_off);
    const float* Lt = reinterpret_cast<const float*>(stg + L::l_off);
    const float* Dt = reinterpret_cast<const float*>(stg + L::d_off);
    const int i0 = i_first + (x % n_qt) * QT;
    // S^T = K Q^T (score warps) or dP^T = V do^T: 16 keys x 16 queries,
    // f32; C fragment: [y][0..1] key g, queries y * 8 + 2 tq + {0, 1};
    // [y][2..3] key g + 8
    float sc[2][4];
    zero(sc);
    gemm_nt<HD>(sc, Kw, score_warp ? Qt : Ot, ST, g, tq);
    if (score_warp) {
      // P^T in f32, to the pair's tile for dS^T and in place for dV
#pragma unroll
      for (int y = 0; y < 2; ++y)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int ql = y * 8 + 2 * tq + e, i = i0 + ql;
          const float lq = Lt[ql];
          const bool ok = i < Sq;
          const bool ok0 = ok && key0 < Sk && (!causal || key0 <= i + off);
          const bool ok1 = ok && key1 < Sk && (!causal || key1 <= i + off);
          sc[y][e] = ok0 ? expf(sc[y][e] * scale - lq) : 0.f;
          sc[y][2 + e] = ok1 ? expf(sc[y][2 + e] * scale - lq) : 0.f;
          Pt[g * TST + ql] = sc[y][e];
          Pt[(g + 8) * TST + ql] = sc[y][2 + e];
        }
    }
    __syncthreads();     // every P^T tile is stored
    if (!score_warp) {
      // dS^T = P^T . (dP^T - D) in f32, P^T read in the same C layout
#pragma unroll
      for (int y = 0; y < 2; ++y)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int ql = y * 8 + 2 * tq + e;
          const float dq_ = Dt[ql];
          sc[y][e] = Pt[g * TST + ql] * (sc[y][e] - dq_);
          sc[y][2 + e] = Pt[(g + 8) * TST + ql] * (sc[y][2 + e] - dq_);
        }
    }
    // dV += P^T do (score warps), dK += dS^T Q (the others): P^T or dS^T
    // rounded to bf16 in the A fragment
    uint32_t a[4];
    c_to_a(a, sc);
    gemm_t<HD>(acc, a, score_warp ? Ot : Qt, ST, lane);
  }

  bf16* out = (score_warp ? dv : dk) + ((size_t)b * Sk * KV + kvh) * HD;
  const float f = score_warp ? 1.f : scale;
#pragma unroll
  for (int y = 0; y < NO; ++y) {
    const int col = y * 8 + 2 * tq;
    if (key0 < Sk)
      store2(out + (size_t)key0 * kstep + col, acc[y][0] * f,
             acc[y][1] * f);
    if (key1 < Sk)
      store2(out + (size_t)key1 * kstep + col, acc[y][2] * f,
             acc[y][3] * f);
  }
}

// ---- the kernels, on f32 or bf16 tensors --------------------------------

template <typename T, int HD>
__global__ void __launch_bounds__(32 * NWQ, 2) flash_bwd_dq(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ o,
    const T* __restrict__ dout, const float* __restrict__ lse,
    float* __restrict__ D, T* __restrict__ dq, int Sq, int Sk, int H,
    int KV, int causal, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  if constexpr (sizeof(T) == sizeof(float))
    dq_f32<HD>(q, k, v, o, dout, lse, D, dq, Sq, Sk, H, KV, causal, scale,
               reinterpret_cast<float*>(smem));
  else
    dq_bf16<HD>(q, k, v, o, dout, lse, D, dq, Sq, Sk, H, KV, causal, scale,
                smem);
}

template <typename T, int HD>
__global__ void __launch_bounds__(32 * NWK, 2) flash_bwd_dkdv(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ D,
    T* __restrict__ dk, T* __restrict__ dv, int Sq, int Sk, int H, int KV,
    int causal, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  if constexpr (sizeof(T) == sizeof(float))
    dkdv_f32<HD>(q, k, v, dout, lse, D, dk, dv, Sq, Sk, H, KV, causal,
                 scale, reinterpret_cast<float*>(smem));
  else
    dkdv_bf16<HD>(q, k, v, dout, lse, D, dk, dv, Sq, Sk, H, KV, causal,
                  scale, smem);
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* D, void* dq, void* dk,
           void* dv, int B, int Sq, int Sk, int H, int KV, int causal,
           float scale, cudaStream_t st) {
  const int n_kb = (Sk + KB - 1) / KB, n_qb = (Sq + QB - 1) / QB;
  if (B > MAX_GRID_YZ || n_kb > MAX_GRID_YZ || n_qb > MAX_GRID_YZ)
    return (int)cudaErrorInvalidValue;
  constexpr bool F32 = sizeof(T) == sizeof(float);
  const size_t s1 = F32 ? DqTiles<HD>::bytes : DqTilesBf16<HD>::bytes;
  const size_t s2 = F32 ? DkdvTiles<HD>::bytes : DkdvTilesBf16<HD>::bytes;
  const T *tq = (const T*)q, *tk = (const T*)k, *tv = (const T*)v,
          *to = (const T*)o, *td = (const T*)dout;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)s1);
  if (err != cudaSuccess) return (int)err;
  // first: it writes D, which flash_bwd_dkdv reads
  flash_bwd_dq<T, HD><<<dim3(H, B, n_qb), 32 * NWQ, s1, st>>>(
      tq, tk, tv, to, td, lse, D, (T*)dq, Sq, Sk, H, KV, causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(flash_bwd_dkdv<T, HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)s2);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dkdv<T, HD><<<dim3(KV, B, n_kb), 32 * NWK, s2, st>>>(
      tq, tk, tv, td, lse, D, (T*)dk, (T*)dv, Sq, Sk, H, KV, causal, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* o,
             const void* dout, const float* lse, float* D, void* dq,
             void* dk, void* dv, int B, int Sq, int Sk, int H, int KV,
             int hd, int causal, float scale, cudaStream_t st) {
  switch (hd) {
    case 16:
      return launch<T, 16>(q, k, v, o, dout, lse, D, dq, dk, dv, B, Sq, Sk,
                           H, KV, causal, scale, st);
    case 32:
      return launch<T, 32>(q, k, v, o, dout, lse, D, dq, dk, dv, B, Sq, Sk,
                           H, KV, causal, scale, st);
    case 64:
      return launch<T, 64>(q, k, v, o, dout, lse, D, dq, dk, dv, B, Sq, Sk,
                           H, KV, causal, scale, st);
    case 128:
      return launch<T, 128>(q, k, v, o, dout, lse, D, dq, dk, dv, B, Sq, Sk,
                            H, KV, causal, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// The gradient of flash_attention_launch's attention: D (B, H, Sq) is f32
// scratch, dq, dk, dv are written whole in the inputs' dtype.  bf16: 0 for
// f32 q, k, v, o, do, dq, dk and dv, 1 for bf16; lse and D are f32 either
// way.  Returns cudaGetLastError() after the two launches (0 when both were
// accepted), or cudaErrorInvalidValue for a head size without a kernel or
// a grid above its limits.  Every pointer is contiguous in the forward's
// layouts and 16-byte aligned; scale is hd^-0.5 rounded to f32.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* D, void* dq, void* dk, void* dv,
    int B, int Sq, int Sk, int H, int KV, int hd, int causal, int bf16,
    float scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const float* fl = (const float*)lse;
  float* fD = (float*)D;
  if (bf16)
    return dispatch<__nv_bfloat16>(q, k, v, o, dout, fl, fD, dq, dk, dv, B,
                                   Sq, Sk, H, KV, hd, causal, scale, st);
  return dispatch<float>(q, k, v, o, dout, fl, fD, dq, dk, dv, B, Sq, Sk, H,
                         KV, hd, causal, scale, st);
}
