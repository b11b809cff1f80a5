// RWKV-6 wkv linear attention over a whole sequence, for every (batch, head).
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
// (B, T, H, hs), u is (H, hs).  All exponents are <= 0, so f32 is safe.
//
// Design: the Pallas kernel walks chunks of 64 tokens in order and keeps a
// (C, C, hs) decay tensor of 1 MB in VMEM, which no SM's 227 KB holds.  This
// first form runs the plain recurrence instead: one block per (b, h), hs
// threads, thread j keeps column S[:, j] in registers; each step stages
// r_t, k_t and exp(w_t) in shared memory (double-buffered, one barrier per
// step) while every thread prefetches the next token's inputs into
// registers; a loop over t inside the block takes the place of the TPU's
// sequential chunk axis.  Templated on hs in {16, 32, 64}.
//
// Bound: at B=8, T=512, H=32, hs=64 the function moves about 176 MB (r, k,
// v, w and o at 33.5 MB each, the initial and final state at 4.2 MB each),
// about 53 us at 3.35 TB/s, against about 2.7 GFLOP (5 operations per
// state element and token), about 40 us at 67 TFLOP/s f32: bytes bound
// it.  This form is bound by neither: each block runs 512 dependent steps
// of a few hundred cycles each, and only B*H = 256 blocks of 2 warps are in
// flight, so step latency sets its time.  A chunked form on the tensor
// cores, with many tokens per step, is work for a later change.
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

template <int HS>
__global__ void __launch_bounds__(HS) wkv6_kernel(
    const float* __restrict__ r, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ w,
    const float* __restrict__ u, const float* __restrict__ s0,
    float* __restrict__ o, float* __restrict__ s_out, int T, int H) {
  __shared__ float sr[2][HS], sk[2][HS], sew[2][HS], su[HS];
  const int bh = blockIdx.x;                 // b * H + h
  const int b = bh / H, h = bh - (bh / H) * H;
  const int j = threadIdx.x;

  float S[HS];                               // column j of the state
  const float* s0p = s0 + (size_t)bh * HS * HS + j;
#pragma unroll
  for (int i = 0; i < HS; ++i) S[i] = s0p[(size_t)i * HS];
  su[j] = u[h * HS + j];

  const size_t step = (size_t)H * HS;        // from one token to the next
  size_t off = ((size_t)b * T * H + h) * HS + j;
  float nr = 0.f, nk = 0.f, nw = 0.f, nv = 0.f;
  if (T > 0) { nr = r[off]; nk = k[off]; nw = w[off]; nv = v[off]; }
  for (int t = 0; t < T; ++t, off += step) {
    const int buf = t & 1;
    sr[buf][j] = nr;
    sk[buf][j] = nk;
    sew[buf][j] = expf(nw);
    const float vj = nv;
    if (t + 1 < T) {
      nr = r[off + step]; nk = k[off + step];
      nw = w[off + step]; nv = v[off + step];
    }
    // one barrier per step: a thread that reaches step t + 2 and rewrites
    // this buffer has passed step t + 1's barrier, which every thread
    // reaches only after its reads of step t
    __syncthreads();
    float acc0 = 0.f, acc1 = 0.f;
#pragma unroll
    for (int i = 0; i < HS; i += 2) {
      const float kv0 = sk[buf][i] * vj;
      const float kv1 = sk[buf][i + 1] * vj;
      acc0 += sr[buf][i] * (S[i] + su[i] * kv0);
      acc1 += sr[buf][i + 1] * (S[i + 1] + su[i + 1] * kv1);
      S[i] = sew[buf][i] * S[i] + kv0;
      S[i + 1] = sew[buf][i + 1] * S[i + 1] + kv1;
    }
    o[off] = acc0 + acc1;
  }
  float* sp = s_out + (size_t)bh * HS * HS + j;
#pragma unroll
  for (int i = 0; i < HS; ++i) sp[(size_t)i * HS] = S[i];
}

template <int HS>
void launch(int n_blocks, cudaStream_t stream, const float* r,
            const float* k, const float* v, const float* w, const float* u,
            const float* s0, float* o, float* s_out, int T, int H) {
  wkv6_kernel<HS><<<n_blocks, HS, 0, stream>>>(r, k, v, w, u, s0, o, s_out,
                                               T, H);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 when it was accepted), or
// cudaErrorInvalidValue for a head size without a kernel.
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
    case 16: launch<16>(n, st, fr, fk, fv, fw, fu, fs0, fo, fs, T, H); break;
    case 32: launch<32>(n, st, fr, fk, fv, fw, fu, fs0, fo, fs, T, H); break;
    case 64: launch<64>(n, st, fr, fk, fv, fw, fu, fs0, fo, fs, T, H); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
