// Forward attention with an online softmax, for grouped-query attention,
// on the tensor cores.
//
// Replaces repro/kernels/flash_attention/kernel.py:flash_attention (the
// Pallas TPU kernel _flash_kernel).  Same function: for each batch row b
// and query head h, o = softmax(q k^T * hd^-0.5) v over the keys of KV head
// h / (H / KV), with the scores, the running max m, the running sum l and
// the accumulator in f32; a causal mask is right-aligned (query i sits at
// key position Sk - Sq + i) and sets masked scores to -1e30; the result is
// acc / max(l, 1e-30) in q's dtype.  Inputs are f32 or bf16 in the JAX
// layout: q (B, Sq, H, hd), k and v (B, Sk, KV, hd), read as they are, so
// the caller never materialises the repeated KV heads.  Any Sq <= Sk (the
// wrapper refuses Sq > Sk), hd in {16, 32, 64, 128}; ragged tile edges are
// masked here, where the Pallas kernel asserts that S divides into blocks.
//
// Bound: at the serving prefill's shape, B = 8, Sq = Sk = 512, 32 query
// heads over 8 KV heads, hd = 128, causal, the function needs 17.2 G
// operations (4 hd for each of the 131,328 (query, key) pairs on or below
// the diagonal, per (b, h)) and moves 168 MB (50 us at 3.35 TB/s).  On the
// CUDA cores at 67 TFLOP/s that is 257 us; this form runs them on the TF32
// tensor cores (495 TFLOP/s) three times over, 104 us: operations bound
// it.  What holds this form back on the card is instruction issue: with
// two warps per scheduler, every operand split, shared-memory load and
// dependent mma stalls (chip_smoke.py phase f gives its time).
//
// Tensor cores, f32-exact: both products are mma.sync.m16n8k8 in TF32 with
// f32 accumulation.  TF32 keeps 10 mantissa bits, too few for f32's 2e-5
// at hd 128, so each f32 operand x is split as big (x with its 13 low
// mantissa bits cleared) and small = x - big rounded to the nearest TF32
// value, and a product takes three passes, small terms first: a_small
// b_big + a_big b_small + a_big b_big (the small-small term is below f32's
// rounding).  The split is two integer operations and a subtraction, where
// cvt.rna.tf32 twice costs some eight instructions.  Passes per dtype:
//   f32:  Q K^T 3 passes, P V 3 passes;
//   bf16: Q K^T 1 pass (a bf16 value is exact in TF32), P V 2 passes (P
//         stays f32, as in the Pallas kernel, and carries a small part; V
//         is exact).
// The tensor cores accumulate without rounding to nearest, and over the
// 48 passes of a 128-long dot product that bias put a first build, which
// summed every pass into one running accumulator, above the 5e-6 from f64
// this kernel is held to (a probe not kept in the repo); so each product
// sums CHUNK k-steps in fresh registers and adds them to its running sum
// with an f32 add, which keeps the kernel nearer to f64 than the f32
// CUDA-core form (chip_smoke.py phase f reads the distance).
//
// Design (second form): one block of four warps per (64-row query tile, h,
// b); the tiles with the most keys are scheduled first (the tile index is
// the grid's slowest axis, counted down).  Each warp owns 16 query rows and
// keeps its 16 x hd accumulator in registers in the m16n8 C-fragment
// layout; the row max and row sum come from shuffles within the 4 lanes
// that share a row.  P goes to a per-warp tile in shared memory (padded
// against bank conflicts) and is read back as A fragments: the C-fragment
// layout is not the TF32 A-fragment layout.  K and V tiles of 32 keys
// arrive by 16-byte cp.async.cg into a two-stage ring, zero-filled past Sk:
// tile j + 1 loads while tile j is multiplied, and cp.async.wait_group with
// a block barrier gates each tile.  Rows of K and V lie KV hd elements
// apart, 16-byte aligned since hd is a multiple of 4 (f32) or 8 (bf16).
// Padded row strides (hd + 4 for Q and f32 K, hd + 8 for V and bf16 K, 36
// for P) make every fragment read conflict-free.  Shared memory at hd 128
// in f32: Q 33 KB (as f32 for both dtypes), two stages of K and V 67 KB,
// P 9 KB: two blocks per SM.  Whole key tiles above the diagonal are
// skipped, as the Pallas kernel skips k-blocks.  Tried and slower on the
// card: 64-key tiles with one block per SM, 16-key tiles with three, and
// eight warps per block sharing K/V fragments split once per tile (255
// registers, spilled).  wgmma with TMA loads and warp specialisation, and
// one block per GQA group (K/V loaded once for its H / KV query heads),
// are later forms.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;          // query rows per block, 16 per warp
constexpr int BK = 32;          // keys per tile
constexpr int NW = 4;           // warps per block
constexpr int MIN_BLOCKS = 2;   // blocks per SM the tiles are sized for
constexpr int CHUNK = 2;        // k-steps of 8 summed in fresh registers
constexpr int NT = 32 * NW;
constexpr int PST = BK + 4;     // padded row stride of a warp's P tile
constexpr int MAX_GRID_YZ = 65535;
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

template <typename T, int HD>
struct Tiles {
  // padded row strides: conflict-free fragment reads in shared memory
  static constexpr int QST = HD + 4;                          // f32
  static constexpr int KST = HD + (sizeof(T) == 4 ? 4 : 8);   // T
  static constexpr int VST = HD + 8;                          // T
  static constexpr size_t q = sizeof(float) * BQ * QST;
  static constexpr size_t k = sizeof(T) * BK * KST;
  static constexpr size_t v = sizeof(T) * BK * VST;
  static constexpr size_t p = sizeof(float) * NW * 16 * PST;
  static constexpr size_t bytes = q + 2 * (k + v) + p;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// x = big + small, each exact in TF32, to about 22 significant bits: big
// is x with the 13 low mantissa bits cleared (rounded toward zero), small
// = x - big is exact in f32 and is rounded to the nearest TF32 value, ties
// away from zero (cvt.rna's rounding, without its NaN and infinity cases,
// which attention's finite operands never reach), by adding half a TF32
// unit to its bits and clearing the 13 low bits
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
__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;" ::: "memory");
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT, MIN_BLOCKS) flash_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
    int Sq, int Sk, int H, int KV, int causal, float scale) {
  using L = Tiles<T, HD>;
  constexpr bool F32 = sizeof(T) == 4;
  constexpr int EPC = 16 / sizeof(T);   // elements per 16-byte copy
  constexpr int CPR = HD / EPC;         // copies per row
  constexpr int NS = BK / 8;            // n-tiles of a warp's scores
  constexpr int NO = HD / 8;            // n-tiles of a warp's accumulator
  static_assert(HD % (8 * CHUNK) == 0 && BK % (8 * CHUNK) == 0,
                "a chunk of k-steps divides hd and the key tile");
  extern __shared__ __align__(16) unsigned char smem[];
  // Q, then two stages of K and V, then the warps' P tiles
  float* Qs = reinterpret_cast<float*>(smem);
  unsigned char* ring = smem + L::q;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;   // fragment row group, column
  float* Ps = reinterpret_cast<float*>(smem + L::q + 2 * (L::k + L::v)) +
              warp * 16 * PST;

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;   // longest tiles first
  const int kvh = h / (H / KV);
  const int off = Sk - Sq;
  const size_t qstep = (size_t)H * HD;  // from one position to the next
  const size_t kstep = (size_t)KV * HD;
  const T* qb = q + ((size_t)b * Sq * H + h) * HD;
  const T* kb = k + ((size_t)b * Sk * KV + kvh) * HD;
  const T* vb = v + ((size_t)b * Sk * KV + kvh) * HD;

  // keys that the tile's valid rows can see: all, or up to the diagonal
  const int q_end = min(q0 + BQ, Sq);
  const int k_end = causal ? q_end + off : Sk;
  const int n_tiles = (k_end + BK - 1) / BK;

  auto load_kv = [&](int tile, int stage) {
    const int k0 = tile * BK;
    for (int i = tid; i < BK * CPR; i += NT) {
      const int r = i / CPR, c = (i % CPR) * EPC;
      const bool ok = k0 + r < Sk;
      const size_t at = (size_t)(ok ? k0 + r : 0) * kstep + c;
      T* Kd = reinterpret_cast<T*>(ring + stage * (L::k + L::v));
      T* Vd = reinterpret_cast<T*>(ring + stage * (L::k + L::v) + L::k);
      cp_async16(Kd + r * L::KST + c, kb + at, ok);
      cp_async16(Vd + r * L::VST + c, vb + at, ok);
    }
    cp_async_commit();
  };
  load_kv(0, 0);

  // the query tile, as f32, while the first K/V tile is in flight
  for (int i = tid; i < BQ * CPR; i += NT) {
    const int r = i / CPR, c = (i % CPR) * EPC;
    float* dst = Qs + r * L::QST + c;
    if (q0 + r < Sq) {
      const uint4 raw = *reinterpret_cast<const uint4*>(
          qb + (size_t)(q0 + r) * qstep + c);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < EPC; ++j) dst[j] = to_f32(e[j]);
    } else {
#pragma unroll
      for (int j = 0; j < EPC; ++j) dst[j] = 0.f;
    }
  }

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  // rows g and g + 8 of the warp's 16
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;
  const int r0 = warp * 16;
  const int qpos0 = q0 + r0 + g + off, qpos1 = qpos0 + 8;
  const float* Qw = Qs + r0 * L::QST;

  for (int j = 0; j < n_tiles; ++j) {
    const int st = j & 1;
    if (j + 1 < n_tiles)
      load_kv(j + 1, st ^ 1);
    else
      cp_async_commit();   // an empty group keeps the count uniform
    cp_async_wait_1();     // this thread's copies of tile j have landed
    __syncthreads();       // and everyone's (and Q is stored)
    const T* Kt = reinterpret_cast<const T*>(ring + st * (L::k + L::v));
    const T* Vt = reinterpret_cast<const T*>(ring + st * (L::k + L::v) +
                                             L::k);
    const int k0 = j * BK;

    // S = Q K^T: the warp's 16 rows x BK keys
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    for (int kc = 0; kc < HD; kc += 8 * CHUNK) {
      uint32_t ab[CHUNK][4], as[CHUNK][4];
#pragma unroll
      for (int c = 0; c < CHUNK; ++c) {
        const float* qr = Qw + kc + 8 * c + tq;
        const float af[4] = {qr[g * L::QST], qr[(g + 8) * L::QST],
                             qr[g * L::QST + 4], qr[(g + 8) * L::QST + 4]};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if constexpr (F32)
            split(af[i], ab[c][i], as[c][i]);
          else
            ab[c][i] = __float_as_uint(af[i]);
        }
      }
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        float t[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int c = 0; c < CHUNK; ++c) {
          const T* kr = Kt + (n * 8 + g) * L::KST + kc + 8 * c + tq;
          const float b0 = to_f32(kr[0]), b1 = to_f32(kr[4]);
          if constexpr (F32) {
            uint32_t bb0, bs0, bb1, bs1;
            split(b0, bb0, bs0);
            split(b1, bb1, bs1);
            mma(t, as[c], bb0, bb1);
            mma(t, ab[c], bs0, bs1);
            mma(t, ab[c], bb0, bb1);
          } else {
            mma(t, ab[c], __float_as_uint(b0), __float_as_uint(b1));
          }
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] += t[e];
      }
    }

    // online softmax of rows g and g + 8; C fragment: s[n][0..1] is row g,
    // keys n * 8 + 2 tq + {0, 1}; s[n][2..3] the same keys of row g + 8
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kpos = k0 + n * 8 + 2 * tq + e;
        const bool in = kpos < Sk;
        s[n][e] = in && (!causal || kpos <= qpos0) ? s[n][e] * scale
                                                   : NEG_INF;
        s[n][2 + e] = in && (!causal || kpos <= qpos1) ? s[n][2 + e] * scale
                                                       : NEG_INF;
        mx0 = fmaxf(mx0, s[n][e]);
        mx1 = fmaxf(mx1, s[n][2 + e]);
      }
#pragma unroll
    for (int w = 1; w < 4; w <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(FULL, mx0, w));
      mx1 = fmaxf(mx1, __shfl_xor_sync(FULL, mx1, w));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float c0 = expf(m0 - mn0), c1 = expf(m1 - mn1);
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[n][e] = expf(s[n][e] - mn0);
        s[n][2 + e] = expf(s[n][2 + e] - mn1);
        sum0 += s[n][e];
        sum1 += s[n][2 + e];
      }
#pragma unroll
    for (int w = 1; w < 4; w <<= 1) {
      sum0 += __shfl_xor_sync(FULL, sum0, w);
      sum1 += __shfl_xor_sync(FULL, sum1, w);
    }
    l0 = l0 * c0 + sum0;
    l1 = l1 * c1 + sum1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      acc[n][0] *= c0;
      acc[n][1] *= c0;
      acc[n][2] *= c1;
      acc[n][3] *= c1;
    }
    // P to the warp's tile, to be read back as A fragments
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      store2(Ps + g * PST + n * 8 + 2 * tq, s[n][0], s[n][1]);
      store2(Ps + (g + 8) * PST + n * 8 + 2 * tq, s[n][2], s[n][3]);
    }
    __syncwarp();

    // acc += P V: the warp's 16 rows x hd
    for (int kc = 0; kc < BK; kc += 8 * CHUNK) {
      uint32_t ab[CHUNK][4], as[CHUNK][4];
#pragma unroll
      for (int c = 0; c < CHUNK; ++c) {
        const float* pr = Ps + kc + 8 * c + tq;
        const float af[4] = {pr[g * PST], pr[(g + 8) * PST],
                             pr[g * PST + 4], pr[(g + 8) * PST + 4]};
#pragma unroll
        for (int i = 0; i < 4; ++i) split(af[i], ab[c][i], as[c][i]);
      }
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        float t[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int c = 0; c < CHUNK; ++c) {
          const T* vr = Vt + (kc + 8 * c + tq) * L::VST + n * 8 + g;
          const float b0 = to_f32(vr[0]), b1 = to_f32(vr[4 * L::VST]);
          if constexpr (F32) {
            uint32_t bb0, bs0, bb1, bs1;
            split(b0, bb0, bs0);
            split(b1, bb1, bs1);
            mma(t, as[c], bb0, bb1);
            mma(t, ab[c], bs0, bs1);
            mma(t, ab[c], bb0, bb1);
          } else {
            const uint32_t bb0 = __float_as_uint(b0);
            const uint32_t bb1 = __float_as_uint(b1);
            mma(t, as[c], bb0, bb1);
            mma(t, ab[c], bb0, bb1);
          }
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] += t[e];
      }
    }
    // every warp is done with this stage (and its P) before it is refilled
    __syncthreads();
  }

  T* ob = o + ((size_t)b * Sq * H + h) * HD;
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  const int row0 = q0 + r0 + g, row1 = row0 + 8;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int col = n * 8 + 2 * tq;
    if (row0 < Sq)
      store2(ob + (size_t)row0 * qstep + col, acc[n][0] / d0, acc[n][1] / d0);
    if (row1 < Sq)
      store2(ob + (size_t)row1 * qstep + col, acc[n][2] / d1, acc[n][3] / d1);
  }
  // the rows' log-sum-exp of the scaled scores, for the backward
  if (lse != nullptr && tq == 0) {
    float* lb = lse + ((size_t)b * H + h) * Sq;
    if (row0 < Sq) lb[row0] = m0 + logf(l0);
    if (row1 < Sq) lb[row1] = m1 + logf(l1);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int Sq, int Sk, int H, int KV, int causal, float scale,
           cudaStream_t stream) {
  const int n_q = (Sq + BQ - 1) / BQ;
  if (B > MAX_GRID_YZ || n_q > MAX_GRID_YZ) return (int)cudaErrorInvalidValue;
  const size_t smem = Tiles<T, HD>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(H, B, n_q);
  flash_kernel<T, HD><<<grid, NT, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, lse, Sq, Sk, H, KV,
      causal, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o,
             float* lse, int B, int Sq, int Sk, int H, int KV, int hd,
             int causal, float scale, cudaStream_t st) {
  switch (hd) {
    case 16:
      return launch<T, 16>(q, k, v, o, lse, B, Sq, Sk, H, KV, causal, scale,
                           st);
    case 32:
      return launch<T, 32>(q, k, v, o, lse, B, Sq, Sk, H, KV, causal, scale,
                           st);
    case 64:
      return launch<T, 64>(q, k, v, o, lse, B, Sq, Sk, H, KV, causal, scale,
                           st);
    case 128:
      return launch<T, 128>(q, k, v, o, lse, B, Sq, Sk, H, KV, causal,
                            scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 when it was accepted), or
// cudaErrorInvalidValue for a head size without a kernel or a grid above
// its limits.  bf16: 0 for f32 inputs and output, 1 for bf16.  scale:
// hd^-0.5 rounded to f32, as the reference rounds it.  q, k, v and o are
// 16-byte aligned.  lse, when not null, receives the rows' log-sum-exp of
// the scaled scores, f32 (B, H, Sq): the backward (flash_attention_bwd.cu)
// reads P = exp(s * scale - lse) from it.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, void* lse,
                                      int B, int Sq, int Sk, int H, int KV,
                                      int hd, int causal, int bf16,
                                      float scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  float* fl = (float*)lse;
  if (bf16)
    return dispatch<__nv_bfloat16>(q, k, v, o, fl, B, Sq, Sk, H, KV, hd,
                                   causal, scale, st);
  return dispatch<float>(q, k, v, o, fl, B, Sq, Sk, H, KV, hd, causal, scale,
                         st);
}
