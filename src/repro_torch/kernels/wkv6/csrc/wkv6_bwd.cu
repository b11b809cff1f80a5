// The gradient of RWKV-6's wkv recurrence, for every (batch, head): the
// backward kernel of wkv6.cu.
//
// The TPU package has no backward kernel: the reference trains through its
// plain jnp form (repro/models/layers/rwkv6.py:wkv_chunked, under
// jax.grad).  This kernel is the port's own, so that training on the card
// runs through wkv6.cu forward and this file backward.  For each (b, h),
// from the initial state S_0 (hs x hs, f32) and the forward recurrence
//     o_t = r_t . (S_{t-1} + diag(u) k_t (x) v_t)
//     S_t = diag(exp(w_t)) S_{t-1} + k_t (x) v_t
// it takes do (B, T, H, hs) and the adjoint of the final state (or none:
// zero) and returns, with G_t the adjoint of S_t and W = exp(w_t),
//     dr_t = S_{t-1} do_t + u . k_t (do_t . v_t)
//     dk_t = G_t v_t     + r_t . u (do_t . v_t)
//     dv_t = G_t^T k_t   + (r_t . u . k_t) do_t
//     dw_t = W . rowsum(G_t . S_{t-1})
//     du   = sum_{b,t} r_t . k_t (do_t . v_t)     (per (b, h) here)
//     G_{t-1} = diag(W) G_t + r_t (x) do_t
// This is the step-by-step recurrence, not the chunked form: no factor
// exp(L_t - L_s) is formed, so the chunked form's Lprev rounding (ROADMAP.md,
// F5) does not arise.  du is written as per-(b, h) partials that the
// wrapper sums over b in a fixed order: there are no atomics, so the
// gradients are the same bits from run to run.
//
// Bound: at B=8, T=512, H=32, hs=64 the function reads r, k, v, w, do and
// writes dr, dk, dv, dw (33.5 MB each; with u, du and the initial state
// 306 MB: 91 us at 3.35 TB/s) and does 12 operations per state element
// and token (the state recomputed, the adjoint, the sums of dr, dk, dv
// and dw), 6.44 G operations: 96 us at the CUDA cores' 67 TFLOP/s, where
// this form runs them, 39 us in three TF32 passes on the tensor cores.
// Bytes bind the function; this form runs at about 10x that bound
// (chip_smoke.py phase k reads its time, PERF.md keeps it): every step
// of the block's 512 is a few dependent operations between the row
// shuffles, and one block per SM (232 registers a thread) hides little.
//
// Design (a first form, right before fast): one block of 4 hs threads per
// (b, h).  Thread t owns row i = t / 4 of the state and the columns
// j = t % 4 + 4 e, e < hs / 4, in registers.  Pass 1 walks the sequence
// forward and writes the state before every sub-chunk of TC = 8 steps to
// a scratch buffer (B H ceil(T / 8) hs^2 f32, 256 MB at the shape above,
// allocated by the wrapper).  Pass 2 walks the sub-chunks backward: it
// reads the sub-chunk's state back, recomputes the TC states before each of
// its steps into registers (TC x hs / 4 of them a thread), and runs the
// adjoint recurrence over them backward.  The row sums (dr, dk, dw) come
// from shuffles among the 4 lanes of a row; the column sums of dv go
// through shared memory, TC steps at a time, between two block barriers
// per sub-chunk.  A later form can carry G in chunks on the tensor cores,
// as wkv6.cu carries S.
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int TC = 8;                   // steps per sub-chunk
constexpr unsigned FULL = 0xffffffffu;

template <int HS>
struct Shape {
  static constexpr int NT = 4 * HS;     // threads per block
  static constexpr int E = HS / 4;      // state columns per thread
  static constexpr int RST = HS + 4;    // row stride of the column sums
  // dynamic shared memory: r, k, v, exp(w), do, dr, dk, dw of a sub-chunk,
  // the two per-step dot products, u, and the TC x hs x RST partials of dv
  static constexpr size_t floats = 8 * TC * HS + 2 * TC + HS +
                                   (size_t)TC * HS * RST;
  static constexpr size_t bytes = floats * sizeof(float);
};

template <int HS>
__global__ void __launch_bounds__(4 * HS, 1) wkv6_bwd_kernel(
    const float* __restrict__ r, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ w,
    const float* __restrict__ u, const float* __restrict__ s0,
    const float* __restrict__ dout, const float* __restrict__ dstate,
    float* __restrict__ dr, float* __restrict__ dk, float* __restrict__ dv,
    float* __restrict__ dw, float* __restrict__ du_part,
    float* __restrict__ ckpt, int T, int H) {
  using Sh = Shape<HS>;
  constexpr int NT = Sh::NT, E = Sh::E, RST = Sh::RST;
  constexpr int NW = NT / 32;
  extern __shared__ __align__(16) float smem[];
  float* rS = smem;                  // [TC][HS] each
  float* kS = rS + TC * HS;
  float* vS = kS + TC * HS;
  float* wS = vS + TC * HS;          // exp(w)
  float* oS = wS + TC * HS;          // do
  float* drS = oS + TC * HS;
  float* dkS = drS + TC * HS;
  float* dwS = dkS + TC * HS;
  float* dov = dwS + TC * HS;        // [TC]: do_t . v_t
  float* rku = dov + TC;             // [TC]: r_t . u . k_t
  float* uS = rku + TC;              // [HS]
  float* red = uS + HS;              // [TC][HS][RST]: G_t[i][j] k_t[i]

  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const int i = tid >> 2, q = tid & 3;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int n_sub = (T + TC - 1) / TC;
  // element (b, t, h, c) of a (B, T, H, HS) input
  auto at = [&](int t, int c) {
    return ((size_t)(b * T + t) * H + h) * HS + c;
  };
  // checkpoint element e of this thread, sub-chunk sc: coalesced over tid
  auto ck = [&](int sc, int e) {
    return (((size_t)bh * n_sub + sc) * E + e) * NT + tid;
  };
  // the sub-chunk's inputs into shared memory, zero past T (a decay of 1)
  auto load = [&](int t0, bool all) {
    for (int x = tid; x < TC * HS; x += NT) {
      const int tt = x / HS, c = x % HS, t = t0 + tt;
      const bool ok = t < T;
      const size_t a = ok ? at(t, c) : 0;
      kS[x] = ok ? k[a] : 0.f;
      vS[x] = ok ? v[a] : 0.f;
      wS[x] = ok ? expf(w[a]) : 1.f;
      if (all) {
        rS[x] = ok ? r[a] : 0.f;
        oS[x] = ok ? dout[a] : 0.f;
      }
    }
  };

  if (tid < HS) uS[tid] = u[h * HS + tid];
  float S[E];
  const float* s0b = s0 + (size_t)bh * HS * HS + (size_t)i * HS;
#pragma unroll
  for (int e = 0; e < E; ++e) S[e] = s0b[q + 4 * e];

  // pass 1: the state before every sub-chunk
  for (int sc = 0; sc < n_sub; ++sc) {
#pragma unroll
    for (int e = 0; e < E; ++e) ckpt[ck(sc, e)] = S[e];
    load(sc * TC, false);
    __syncthreads();
#pragma unroll
    for (int tt = 0; tt < TC; ++tt) {
      const float wi = wS[tt * HS + i], ki = kS[tt * HS + i];
#pragma unroll
      for (int e = 0; e < E; ++e)
        S[e] = wi * S[e] + ki * vS[tt * HS + q + 4 * e];
    }
    __syncthreads();
  }

  // pass 2: the adjoint, sub-chunk by sub-chunk backward
  float G[E];
  if (dstate != nullptr) {
    const float* gb = dstate + (size_t)bh * HS * HS + (size_t)i * HS;
#pragma unroll
    for (int e = 0; e < E; ++e) G[e] = gb[q + 4 * e];
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e) G[e] = 0.f;
  }
  float du_acc = 0.f;
  for (int sc = n_sub - 1; sc >= 0; --sc) {
    const int t0 = sc * TC;
    load(t0, true);
    __syncthreads();
    // the two dot products of every step, one warp a step
    for (int tt = wid; tt < TC; tt += NW) {
      float a = 0.f, c = 0.f;
      for (int x = lane; x < HS; x += 32) {
        a += oS[tt * HS + x] * vS[tt * HS + x];
        c += rS[tt * HS + x] * uS[x] * kS[tt * HS + x];
      }
#pragma unroll
      for (int m = 16; m > 0; m >>= 1) {
        a += __shfl_xor_sync(FULL, a, m);
        c += __shfl_xor_sync(FULL, c, m);
      }
      if (lane == 0) {
        dov[tt] = a;
        rku[tt] = c;
      }
    }
    // the states before each step of the sub-chunk
    float hist[TC][E];
#pragma unroll
    for (int e = 0; e < E; ++e) S[e] = ckpt[ck(sc, e)];
#pragma unroll
    for (int tt = 0; tt < TC; ++tt) {
      const float wi = wS[tt * HS + i], ki = kS[tt * HS + i];
#pragma unroll
      for (int e = 0; e < E; ++e) {
        hist[tt][e] = S[e];
        S[e] = wi * S[e] + ki * vS[tt * HS + q + 4 * e];
      }
    }
    __syncthreads();   // dov and rku are stored
#pragma unroll
    for (int tt = TC - 1; tt >= 0; --tt) {
      if (t0 + tt >= T) continue;   // the padded tail: G passes unchanged
      const int o = tt * HS;
      const float ri = rS[o + i], ki = kS[o + i], wi = wS[o + i];
      const float ui = uS[i], dv_t = dov[tt];
      float a_dr = 0.f, a_dk = 0.f, a_dw = 0.f;
      float* red_t = red + ((size_t)tt * HS + i) * RST;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int j = q + 4 * e;
        const float doj = oS[o + j], vj = vS[o + j];
        a_dr += doj * hist[tt][e];
        a_dk += G[e] * vj;
        a_dw += G[e] * hist[tt][e];
        red_t[j] = G[e] * ki;
        G[e] = wi * G[e] + ri * doj;
      }
#pragma unroll
      for (int m = 1; m < 4; m <<= 1) {
        a_dr += __shfl_xor_sync(FULL, a_dr, m);
        a_dk += __shfl_xor_sync(FULL, a_dk, m);
        a_dw += __shfl_xor_sync(FULL, a_dw, m);
      }
      if (q == 0) {
        drS[o + i] = a_dr + ui * ki * dv_t;
        dkS[o + i] = a_dk + ri * ui * dv_t;
        dwS[o + i] = wi * a_dw;
        du_acc += ri * ki * dv_t;
      }
    }
    __syncthreads();   // the partials of dv and the row sums are stored
    // column sums of dv, and every output of the sub-chunk, coalesced
    for (int x = tid; x < TC * HS; x += NT) {
      const int tt = x / HS, c = x % HS, t = t0 + tt;
      if (t >= T) continue;
      const float* col = red + (size_t)tt * HS * RST + c;
      float s = 0.f;
      for (int row = 0; row < HS; ++row) s += col[row * RST];
      const size_t a = at(t, c);
      dv[a] = s + rku[tt] * oS[x];
      dr[a] = drS[x];
      dk[a] = dkS[x];
      dw[a] = dwS[x];
    }
    __syncthreads();   // shared memory is free for the next sub-chunk
  }
  if (q == 0) du_part[(size_t)bh * HS + i] = du_acc;
}

template <int HS>
int launch(int n, cudaStream_t st, const float* r, const float* k,
           const float* v, const float* w, const float* u, const float* s0,
           const float* dout, const float* dstate, float* dr, float* dk,
           float* dv, float* dw, float* du_part, float* ckpt, int T, int H) {
  const size_t smem = Shape<HS>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      wkv6_bwd_kernel<HS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  wkv6_bwd_kernel<HS><<<n, Shape<HS>::NT, smem, st>>>(
      r, k, v, w, u, s0, dout, dstate, dr, dk, dv, dw, du_part, ckpt, T, H);
  return (int)cudaGetLastError();
}

}  // namespace

// Floats of the scratch buffer that wkv6_bwd_launch needs for (B, T, H,
// hs): the state before every sub-chunk of each (b, h).
extern "C" long long wkv6_bwd_scratch_floats(int B, int T, int H, int hs) {
  return (long long)B * H * ((T + TC - 1) / TC) * hs * hs;
}

// Returns cudaGetLastError() after the launch (0 when it was accepted), or
// cudaErrorInvalidValue for a head size without a kernel.  Inputs are f32
// and contiguous in the forward's layouts; dstate may be null (a zero
// adjoint of the final state); du_part is (B, H, hs), summed over B by the
// caller.
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
        *gw = (float*)dw, *gu = (float*)du_part, *ck = (float*)scratch;
  switch (hs) {
    case 16:
      return launch<16>(n, st, fr, fk, fv, fw, fu, fs0, fo, fds, gr, gk, gv,
                        gw, gu, ck, T, H);
    case 32:
      return launch<32>(n, st, fr, fk, fv, fw, fu, fs0, fo, fds, gr, gk, gv,
                        gw, gu, ck, T, H);
    case 64:
      return launch<64>(n, st, fr, fk, fv, fw, fu, fs0, fo, fds, gr, gk, gv,
                        gw, gu, ck, T, H);
    default: return (int)cudaErrorInvalidValue;
  }
}
