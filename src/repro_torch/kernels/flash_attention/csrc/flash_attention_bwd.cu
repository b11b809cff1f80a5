// The gradient of attention with a softmax, for grouped-query attention:
// the backward kernels of flash_attention.cu.
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
//     D  = rowsum(do . o)                           flash_bwd_dot
//     dV = P^T do,  dS = P . (do V^T - D),  dK = scale dS^T Q
//                                                   flash_bwd_dkdv
//     dQ = scale dS K                               flash_bwd_dq
// FlashAttention-2's split (Dao, 2023): dK and dV of a key block sum over
// every query head of its KV group and every query block inside one
// block, and dQ of a query block over every key block inside another, so
// no sum crosses blocks and there are no atomics: the gradients are the
// same bits from run to run.  f32 in, f32 out (the wrapper refuses bf16).
//
// Bound: at B = 8, Sq = Sk = 512, 32 query heads over 8 KV heads, hd = 128,
// causal, the five products (the scores, dP, dV, dK, dQ) over the 131,328
// (query, key) pairs on or below the diagonal of each (b, h) are 2 hd
// operations each, 43.0 G operations: 642 us at the CUDA cores' 67
// TFLOP/s, where this first form runs them (plain FMA), 261 us in three
// TF32 passes on the tensor cores.  The bytes (q, k, v, o, do, lse read
// once, dq, dk, dv written once) are 336 MB, 100 us: operations bind it.
// chip_smoke.py phase k reads its time (PERF.md keeps it).
//
// Design (a first form, right before fast): scores and their gradients
// are recomputed from Q, K, V, do and lse in shared memory, in f32 FMA.
//   flash_bwd_dkdv: one block of 256 threads per (64-key block, KV head,
//   b); K and V of the block stay in shared memory while it walks the
//   group's query heads and, from the diagonal on, their query tiles of 16
//   rows.  Per tile, thread t computes P and dS for key t % 64 and rows
//   t / 64 + 4 m, then accumulates key t % 64's dK and dV over the tile's
//   16 rows in the columns t / 64 + 4 e, in registers.
//   flash_bwd_dq: one block of 256 threads per (64-row query block, h, b)
//   walks the key tiles of 32 up to the diagonal: thread t computes dS for
//   row t % 64 and keys t / 64 + 4 m, then accumulates row t % 64's dQ
//   over the tile's keys in the columns t / 64 + 4 e.
// Row strides of hd + 1 keep every shared-memory read of a warp on
// distinct banks or one broadcast.  wgmma on the tensor cores (3xTF32, as
// the forward) is the later form.
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;        // threads per block of both main kernels
constexpr int KB = 64;         // keys per block of flash_bwd_dkdv
constexpr int QT = 16;         // query rows per tile there
constexpr int QB = 64;         // query rows per block of flash_bwd_dq
constexpr int KT = 32;         // keys per tile there
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_GRID_YZ = 65535;

// D = rowsum(do . o), one warp per (b, i, h) row, D laid out (B, H, Sq)
__global__ void flash_bwd_dot(const float* __restrict__ o,
                              const float* __restrict__ dout,
                              float* __restrict__ D, long long rows, int Sq,
                              int H, int hd) {
  const long long row = (long long)blockIdx.x * (NT / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const float* a = o + row * hd;
  const float* c = dout + row * hd;
  float s = 0.f;
  for (int x = lane; x < hd; x += 32) s += a[x] * c[x];
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) s += __shfl_xor_sync(FULL, s, m);
  if (lane == 0) {
    const int h = (int)(row % H);
    const long long bi = row / H;
    const int i = (int)(bi % Sq), b = (int)(bi / Sq);
    D[((size_t)b * H + h) * Sq + i] = s;
  }
}

template <int HD>
struct DkdvTiles {
  static constexpr int ST = HD + 1;     // row stride of K, V, Q, do
  static constexpr int PST = KB + 1;    // row stride of P and dS
  static constexpr size_t floats =
      2 * KB * ST + 2 * QT * ST + 2 * QT * PST + 2 * QT;
  static constexpr size_t bytes = floats * sizeof(float);
};

template <int HD>
__global__ void __launch_bounds__(NT) flash_bwd_dkdv(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ D,
    float* __restrict__ dk, float* __restrict__ dv, int Sq, int Sk, int H,
    int KV, int causal, float scale) {
  using L = DkdvTiles<HD>;
  constexpr int ST = L::ST, PST = L::PST, NE = HD / 4;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = Ks + KB * ST;
  float* Qs = Vs + KB * ST;
  float* Os = Qs + QT * ST;            // do
  float* Ps = Os + QT * ST;
  float* Ss = Ps + QT * PST;           // dS
  float* Ls = Ss + QT * PST;           // lse of the tile's rows
  float* Ds = Ls + QT;

  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * KB, kvh = blockIdx.y, b = blockIdx.z;
  const int group = H / KV, off = Sk - Sq;
  const size_t qstep = (size_t)H * HD, kstep = (size_t)KV * HD;

  for (int x = tid; x < KB * HD; x += NT) {
    const int r = x / HD, c = x % HD;
    const bool ok = k0 + r < Sk;
    const size_t a = ((size_t)b * Sk + k0 + r) * kstep + kvh * HD + c;
    Ks[r * ST + c] = ok ? k[a] : 0.f;
    Vs[r * ST + c] = ok ? v[a] : 0.f;
  }

  const int jl = tid % KB, part = tid / KB;   // own key; column offset
  const int j = k0 + jl;
  float ak[NE], av[NE];
#pragma unroll
  for (int e = 0; e < NE; ++e) ak[e] = av[e] = 0.f;

  // queries that see a key of this block: all, or from the diagonal on
  const int i_first = causal ? max(0, k0 - off) / QT * QT : 0;
  for (int g = 0; g < group; ++g) {
    const int h = kvh * group + g;
    const float* lb = lse + ((size_t)b * H + h) * Sq;
    const float* db = D + ((size_t)b * H + h) * Sq;
    for (int i0 = i_first; i0 < Sq; i0 += QT) {
      __syncthreads();   // the previous tile's Q, do, P, dS are read
      for (int x = tid; x < QT * HD; x += NT) {
        const int r = x / HD, c = x % HD;
        const bool ok = i0 + r < Sq;
        const size_t a = ((size_t)b * Sq + i0 + r) * qstep + h * HD + c;
        Qs[r * ST + c] = ok ? q[a] : 0.f;
        Os[r * ST + c] = ok ? dout[a] : 0.f;
      }
      if (tid < QT) {
        const bool ok = i0 + tid < Sq;
        Ls[tid] = ok ? lb[i0 + tid] : 0.f;
        Ds[tid] = ok ? db[i0 + tid] : 0.f;
      }
      __syncthreads();
      // P and dS of key jl and rows part + 4 m
      float s[QT / 4], dp[QT / 4];
#pragma unroll
      for (int m = 0; m < QT / 4; ++m) s[m] = dp[m] = 0.f;
      for (int c = 0; c < HD; ++c) {
        const float kc = Ks[jl * ST + c], vc = Vs[jl * ST + c];
#pragma unroll
        for (int m = 0; m < QT / 4; ++m) {
          const int il = part + 4 * m;
          s[m] += Qs[il * ST + c] * kc;
          dp[m] += Os[il * ST + c] * vc;
        }
      }
#pragma unroll
      for (int m = 0; m < QT / 4; ++m) {
        const int il = part + 4 * m, i = i0 + il;
        const bool in = i < Sq && j < Sk && (!causal || j <= i + off);
        const float p = in ? expf(s[m] * scale - Ls[il]) : 0.f;
        Ps[il * PST + jl] = p;
        Ss[il * PST + jl] = p * (dp[m] - Ds[il]);
      }
      __syncthreads();
      // key jl's dK and dV over the tile's rows, columns part + 4 e
      for (int il = 0; il < QT; ++il) {
        const float p = Ps[il * PST + jl], ds = Ss[il * PST + jl];
#pragma unroll
        for (int e = 0; e < NE; ++e) {
          const int c = part + 4 * e;
          av[e] += p * Os[il * ST + c];
          ak[e] += ds * Qs[il * ST + c];
        }
      }
    }
  }
  if (j < Sk) {
    const size_t a = ((size_t)b * Sk + j) * kstep + kvh * HD;
#pragma unroll
    for (int e = 0; e < NE; ++e) {
      const int c = part + 4 * e;
      dk[a + c] = ak[e] * scale;
      dv[a + c] = av[e];
    }
  }
}

template <int HD>
struct DqTiles {
  static constexpr int ST = HD + 1;
  static constexpr int SST = KT + 1;
  static constexpr size_t floats =
      2 * QB * ST + 2 * KT * ST + QB * SST + 2 * QB;
  static constexpr size_t bytes = floats * sizeof(float);
};

template <int HD>
__global__ void __launch_bounds__(NT) flash_bwd_dq(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ D,
    float* __restrict__ dq, int Sq, int Sk, int H, int KV, int causal,
    float scale) {
  using L = DqTiles<HD>;
  constexpr int ST = L::ST, SST = L::SST, NE = HD / 4;
  constexpr int PER = QB * KT / NT;          // scores per thread
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Os = Qs + QB * ST;                  // do
  float* Ks = Os + QB * ST;
  float* Vs = Ks + KT * ST;
  float* Ss = Vs + KT * ST;                  // dS
  float* Ls = Ss + QB * SST;
  float* Ds = Ls + QB;

  const int tid = threadIdx.x;
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * QB;   // longest first
  const int kvh = h / (H / KV), off = Sk - Sq;
  const size_t qstep = (size_t)H * HD, kstep = (size_t)KV * HD;

  for (int x = tid; x < QB * HD; x += NT) {
    const int r = x / HD, c = x % HD;
    const bool ok = q0 + r < Sq;
    const size_t a = ((size_t)b * Sq + q0 + r) * qstep + h * HD + c;
    Qs[r * ST + c] = ok ? q[a] : 0.f;
    Os[r * ST + c] = ok ? dout[a] : 0.f;
  }
  if (tid < QB) {
    const bool ok = q0 + tid < Sq;
    const size_t a = ((size_t)b * H + h) * Sq + q0 + tid;
    Ls[tid] = ok ? lse[a] : 0.f;
    Ds[tid] = ok ? D[a] : 0.f;
  }

  const int il = tid % QB, part = tid / QB;   // own row; column offset
  const int i = q0 + il;
  float aq[NE];
#pragma unroll
  for (int e = 0; e < NE; ++e) aq[e] = 0.f;

  const int q_end = min(q0 + QB, Sq);
  const int k_end = causal ? min(Sk, q_end + off) : Sk;
  for (int kt0 = 0; kt0 < k_end; kt0 += KT) {
    __syncthreads();   // the previous tile's K and dS are read (and Q is in)
    for (int x = tid; x < KT * HD; x += NT) {
      const int r = x / HD, c = x % HD;
      const bool ok = kt0 + r < Sk;
      const size_t a = ((size_t)b * Sk + kt0 + r) * kstep + kvh * HD + c;
      Ks[r * ST + c] = ok ? k[a] : 0.f;
      Vs[r * ST + c] = ok ? v[a] : 0.f;
    }
    __syncthreads();
    // dS of row il and keys part + 4 m
    float s[PER], dp[PER];
#pragma unroll
    for (int m = 0; m < PER; ++m) s[m] = dp[m] = 0.f;
    for (int c = 0; c < HD; ++c) {
      const float qc = Qs[il * ST + c], oc = Os[il * ST + c];
#pragma unroll
      for (int m = 0; m < PER; ++m) {
        const int jl = part + 4 * m;
        s[m] += qc * Ks[jl * ST + c];
        dp[m] += oc * Vs[jl * ST + c];
      }
    }
#pragma unroll
    for (int m = 0; m < PER; ++m) {
      const int jl = part + 4 * m, j = kt0 + jl;
      const bool in = i < Sq && j < Sk && (!causal || j <= i + off);
      const float p = in ? expf(s[m] * scale - Ls[il]) : 0.f;
      Ss[il * SST + jl] = p * (dp[m] - Ds[il]);
    }
    __syncthreads();
    // row il's dQ over the tile's keys, columns part + 4 e
    for (int jl = 0; jl < KT; ++jl) {
      const float ds = Ss[il * SST + jl];
#pragma unroll
      for (int e = 0; e < NE; ++e) aq[e] += ds * Ks[jl * ST + part + 4 * e];
    }
  }
  if (i < Sq) {
    const size_t a = ((size_t)b * Sq + i) * qstep + h * HD;
#pragma unroll
    for (int e = 0; e < NE; ++e) dq[a + part + 4 * e] = aq[e] * scale;
  }
}

template <int HD>
int launch(const float* q, const float* k, const float* v, const float* o,
           const float* dout, const float* lse, float* D, float* dq,
           float* dk, float* dv, int B, int Sq, int Sk, int H, int KV,
           int causal, float scale, cudaStream_t st) {
  const int n_kb = (Sk + KB - 1) / KB, n_qb = (Sq + QB - 1) / QB;
  if (B > MAX_GRID_YZ || KV > MAX_GRID_YZ || n_qb > MAX_GRID_YZ)
    return (int)cudaErrorInvalidValue;
  const long long rows = (long long)B * Sq * H;
  flash_bwd_dot<<<(unsigned)((rows + NT / 32 - 1) / (NT / 32)), NT, 0, st>>>(
      o, dout, D, rows, Sq, H, HD);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t s1 = DkdvTiles<HD>::bytes, s2 = DqTiles<HD>::bytes;
  err = cudaFuncSetAttribute(flash_bwd_dkdv<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)s1);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dkdv<HD><<<dim3(n_kb, KV, B), NT, s1, st>>>(
      q, k, v, dout, lse, D, dk, dv, Sq, Sk, H, KV, causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(flash_bwd_dq<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)s2);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dq<HD><<<dim3(H, B, n_qb), NT, s2, st>>>(
      q, k, v, dout, lse, D, dq, Sq, Sk, H, KV, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// The gradient of flash_attention_launch's f32 attention: D (B, H, Sq) is
// scratch, dq, dk, dv are written whole.  Returns cudaGetLastError() after
// the three launches (0 when all were accepted), or cudaErrorInvalidValue
// for a head size without a kernel or a grid above its limits.  Every
// pointer is f32 and contiguous in the forward's layouts; scale is
// hd^-0.5 rounded to f32.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* D, void* dq, void* dk, void* dv,
    int B, int Sq, int Sk, int H, int KV, int hd, int causal, float scale,
    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const float *fq = (const float*)q, *fk = (const float*)k,
              *fv = (const float*)v, *fo = (const float*)o,
              *fd = (const float*)dout, *fl = (const float*)lse;
  float *gD = (float*)D, *gq = (float*)dq, *gk = (float*)dk,
        *gv = (float*)dv;
  switch (hd) {
    case 16:
      return launch<16>(fq, fk, fv, fo, fd, fl, gD, gq, gk, gv, B, Sq, Sk, H,
                        KV, causal, scale, st);
    case 32:
      return launch<32>(fq, fk, fv, fo, fd, fl, gD, gq, gk, gv, B, Sq, Sk, H,
                        KV, causal, scale, st);
    case 64:
      return launch<64>(fq, fk, fv, fo, fd, fl, gD, gq, gk, gv, B, Sq, Sk, H,
                        KV, causal, scale, st);
    case 128:
      return launch<128>(fq, fk, fv, fo, fd, fl, gD, gq, gk, gv, B, Sq, Sk,
                         H, KV, causal, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
