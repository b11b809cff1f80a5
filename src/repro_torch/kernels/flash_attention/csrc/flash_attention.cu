// Forward attention with an online softmax, for grouped-query attention.
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
// Design (first form): one block of 256 threads per (64-row query tile, h,
// b), the query tile in shared memory; a loop over 64-key tiles up to the
// causal limit (whole tiles above the diagonal are skipped, as the Pallas
// kernel skips k-blocks) takes the place of the TPU's sequential k-block
// grid axis.  Each tile: K is staged transposed in shared memory, the
// threads, a 16 x 16 grid, each compute a 4 x 4 block of scores (rows
// 4 ty .. 4 ty + 3, keys tx + 16 j) with f32 FMAs; the row max and sum are
// reduced over the 16 threads of a row by warp shuffles, so m and l live in
// registers, replicated; P goes to shared memory, V replaces K there, and
// each thread adds P V into its 4 rows x hd / 16 columns of the accumulator
// in registers.  No tensor cores: TF32 would change the f32 results.
//
// Bound: at the serving prefill's shape, B = 8, Sq = Sk = 512, 32 query
// heads over 8 KV heads, hd = 128, causal, the function needs 17.2 GFLOP
// (4 hd operations for each of the 131,328 (query, key) pairs on or below
// the diagonal, per (b, h)), 257 us at the 67 TFLOP/s f32 rate of the CUDA
// cores, and moves 168 MB (q and o 67 MB each, k and v 17 MB each), 50 us
// at 3.35 TB/s: operations bound it.  This form feeds each FMA from shared
// memory (8 loads for 16 FMAs in the score loop), stalls on its global
// loads at every tile, and holds two blocks per SM at hd = 128 (83 KB of
// shared memory each): it reaches a fraction of the f32 rate.  wgmma on
// the tensor cores, with TMA loads in a ring of tiles, is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per tile
constexpr int NT = 256;       // threads per block, a 16 x 16 grid
constexpr int TR = BQ / 16;   // rows per thread
constexpr int TC = BK / 16;   // keys per thread in the score tile
constexpr int KST = BK + 1;   // padded row stride of the K^T and P tiles
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <int HD>
struct Tiles {
  static constexpr int QST = HD + 1;                 // padded Q row stride
  static constexpr int KV = HD * KST > BK * HD ? HD * KST : BK * HD;
  static constexpr size_t bytes = sizeof(float) * (BQ * QST + KV + BQ * KST);
};

template <typename T, int HD>
__global__ void __launch_bounds__(NT, 2) flash_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ o, int Sq, int Sk, int H,
    int KV, int causal, float scale) {
  constexpr int QST = Tiles<HD>::QST;
  constexpr int TD = HD / 16;           // accumulator columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                     // [BQ][QST]
  float* KVs = Qs + BQ * QST;           // K^T [HD][KST], then V [BK][HD]
  float* Ps = KVs + Tiles<HD>::KV;      // [BQ][KST]

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;   // longest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int off = Sk - Sq;
  const size_t qstep = (size_t)H * HD;  // from one position to the next
  const size_t kstep = (size_t)KV * HD;
  const T* qb = q + ((size_t)b * Sq * H + h) * HD;
  const T* kb = k + ((size_t)b * Sk * KV + kvh) * HD;
  const T* vb = v + ((size_t)b * Sk * KV + kvh) * HD;

  for (int i = tid; i < BQ * HD; i += NT) {
    const int r = i / HD, d = i % HD;
    Qs[r * QST + d] =
        q0 + r < Sq ? to_f32(qb[(size_t)(q0 + r) * qstep + d]) : 0.f;
  }

  float m[TR], l[TR], acc[TR][TD];
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < TD; ++j) acc[i][j] = 0.f;
  }

  // keys that the tile's valid rows can see: all, or up to the diagonal
  const int q_end = min(q0 + BQ, Sq);
  const int k_end = causal ? q_end + off : Sk;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    // the last tile's reads of K/V and P are done (and Q is stored)
    __syncthreads();
    for (int i = tid; i < BK * HD; i += NT) {
      const int c = i / HD, d = i % HD;
      KVs[d * KST + c] =
          k0 + c < Sk ? to_f32(kb[(size_t)(k0 + c) * kstep + d]) : 0.f;
    }
    __syncthreads();

    float s[TR][TC];
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = 0; j < TC; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qv[TR], kv[TC];
#pragma unroll
      for (int i = 0; i < TR; ++i) qv[i] = Qs[(ty * TR + i) * QST + d];
#pragma unroll
      for (int j = 0; j < TC; ++j) kv[j] = KVs[d * KST + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int j = 0; j < TC; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // online softmax of each row; its 16 threads hold the same m and l
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const int qpos = q0 + ty * TR + i + off;
      float row_max = NEG_INF;
#pragma unroll
      for (int j = 0; j < TC; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const bool keep = kpos < Sk && (!causal || kpos <= qpos);
        s[i][j] = keep ? s[i][j] * scale : NEG_INF;
        row_max = fmaxf(row_max, s[i][j]);
      }
#pragma unroll
      for (int w = 8; w > 0; w >>= 1)
        row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, w));
      const float m_new = fmaxf(m[i], row_max);
      const float corr = expf(m[i] - m_new);
      float row_sum = 0.f;
#pragma unroll
      for (int j = 0; j < TC; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[(ty * TR + i) * KST + tx + 16 * j] = p;
        row_sum += p;
      }
#pragma unroll
      for (int w = 8; w > 0; w >>= 1)
        row_sum += __shfl_xor_sync(0xffffffffu, row_sum, w);
      l[i] = l[i] * corr + row_sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < TD; ++j) acc[i][j] *= corr;
    }
    __syncthreads();   // K^T read, P written

    for (int i = tid; i < BK * HD; i += NT) {
      const int c = i / HD, d = i % HD;
      KVs[c * HD + d] =
          k0 + c < Sk ? to_f32(vb[(size_t)(k0 + c) * kstep + d]) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[TR], vv[TD];
#pragma unroll
      for (int i = 0; i < TR; ++i) pv[i] = Ps[(ty * TR + i) * KST + c];
#pragma unroll
      for (int j = 0; j < TD; ++j) vv[j] = KVs[c * HD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int j = 0; j < TD; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

  T* ob = o + ((size_t)b * Sq * H + h) * HD;
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int r = q0 + ty * TR + i;
    if (r >= Sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < TD; ++j)
      store(&ob[(size_t)r * qstep + tx + 16 * j], acc[i][j] * inv);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Sk, int H, int KV, int causal, float scale,
           cudaStream_t stream) {
  const size_t smem = Tiles<HD>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_kernel<T, HD><<<grid, NT, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, Sq, Sk, H, KV, causal,
      scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int B,
             int Sq, int Sk, int H, int KV, int hd, int causal, float scale,
             cudaStream_t st) {
  switch (hd) {
    case 16:
      return launch<T, 16>(q, k, v, o, B, Sq, Sk, H, KV, causal, scale, st);
    case 32:
      return launch<T, 32>(q, k, v, o, B, Sq, Sk, H, KV, causal, scale, st);
    case 64:
      return launch<T, 64>(q, k, v, o, B, Sq, Sk, H, KV, causal, scale, st);
    case 128:
      return launch<T, 128>(q, k, v, o, B, Sq, Sk, H, KV, causal, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 when it was accepted), or
// cudaErrorInvalidValue for a head size without a kernel.  bf16: 0 for f32
// inputs and output, 1 for bf16.  scale: hd^-0.5 rounded to f32, as the
// reference rounds it.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int Sq,
                                      int Sk, int H, int KV, int hd,
                                      int causal, int bf16, float scale,
                                      void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16)
    return dispatch<__nv_bfloat16>(q, k, v, o, B, Sq, Sk, H, KV, hd, causal,
                                   scale, st);
  return dispatch<float>(q, k, v, o, B, Sq, Sk, H, KV, hd, causal, scale,
                         st);
}
