// Warp issue selection for every (SM, sub-core) of the simulated GPU, for
// one simulated cycle.
//
// Replaces repro/kernels/sm_issue/kernel.py:issue_select_pallas (the Pallas
// TPU kernel _issue_kernel), widened to the full selection contract of
// repro/sim/smcore.py:_issue_subcore: wait_bar blocking, the LRR selector,
// the instr_base fetch offset and a true kernel length n_instr <= len(ops).
// With wait_bar all false, GTO, instr_base = 0 and n_instr = len(ops),
// sel_open is exactly the Pallas kernel's output.
//
// Two winners per (SM, sub-core):
//   sel_open   - candidates: active, pc < n_instr, not blocked on memory or
//                a barrier, scoreboard-ready at t, dispatch port free at t
//   sel_closed - the same with LDG/STG excluded
// The only coupling between the sub-cores of one SM inside a cycle is the
// MSHR free-row gate on LDG/STG; the caller takes sel_open while the SM
// still has a free row when that sub-core issues, else sel_closed.
// Winner: GTO key (last-issued warp -1, else the warp id) or LRR key
// ((w - last - 1) mod W); the least key wins, ties to the lowest warp id;
// -1 when no warp can issue.
//
// Design: one block per SM, one warp of 32 threads per sub-core; lane j
// holds warp slots sc + SC*j, sc + SC*(j+32), ...  The argmin is a warp
// shuffle reduction over a packed (key, j) 64-bit value.  The scalars
// (t, n_instr, instr_base, sched) are read from device memory so the host
// never waits for the device between cycles.
//
// Bound: each launch reads the warp state once (15 bytes per warp slot,
// about 58 KB at 80 SMs x 48 warps) and writes 2 x SM x SC ints, some
// 0.02 us at 3.35 TB/s; the launch itself (a few us) bounds it.  It runs
// once per simulated cycle, Delta = 16 times per quantum.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNUnits = 5;
constexpr int kLDG = 4;
constexpr int kSTG = 5;
constexpr unsigned long long kNone = ~0ull;

// repro/sim/config.py:UNIT_OF_CLASS
__constant__ int kUnitOfClass[7] = {0, 1, 2, 3, 4, 4, 1};

__device__ __forceinline__ unsigned long long warp_min(unsigned long long v) {
  for (int off = 16; off > 0; off >>= 1) {
    unsigned long long o = __shfl_xor_sync(0xffffffffu, v, off);
    v = o < v ? o : v;
  }
  return v;
}

__global__ void sm_issue_kernel(
    const int32_t* __restrict__ pc, const uint8_t* __restrict__ active,
    const int32_t* __restrict__ ready_at, const int32_t* __restrict__ pending,
    const uint8_t* __restrict__ wait_mem, const uint8_t* __restrict__ wait_bar,
    const int32_t* __restrict__ last_issued,
    const int32_t* __restrict__ unit_free, const int32_t* __restrict__ ops,
    const int32_t* __restrict__ n_instr_p,
    const int32_t* __restrict__ instr_base_p,
    const int32_t* __restrict__ sched_p, const int32_t* __restrict__ t_p,
    int32_t* __restrict__ sel_open, int32_t* __restrict__ sel_closed,
    int n_warps, int n_subcores) {
  const int sm = blockIdx.x;
  const int sc = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int t = *t_p;
  const int n_instr = *n_instr_p;
  const int base = *instr_base_p;
  const bool gto = *sched_p == 0;
  const int per_sc = n_warps / n_subcores;
  const int last = last_issued[sm * n_subcores + sc];
  const int32_t* uf = unit_free + (sm * n_subcores + sc) * kNUnits;

  unsigned long long best_open = kNone, best_closed = kNone;
  // pc >= 0 always, so an empty kernel (n_instr = 0) has no candidate
  for (int j = n_instr > 0 ? lane : per_sc; j < per_sc; j += 32) {
    const int w = sc + n_subcores * j;
    const int i = sm * n_warps + w;
    const int p = pc[i];
    const bool blocked = (wait_mem[i] && pending[i] > 0) || wait_bar[i];
    if (!active[i] || p >= n_instr || blocked || ready_at[i] > t) continue;
    const int op = ops[base + min(max(p, 0), n_instr - 1)];
    if (uf[kUnitOfClass[op]] > t) continue;
    int key;
    if (gto) {
      key = w == last ? -1 : w;
    } else {
      key = (w - last - 1) % n_warps;
      if (key < 0) key += n_warps;
    }
    const unsigned long long packed =
        ((unsigned long long)(unsigned)(key + 1) << 32) | (unsigned)j;
    best_open = packed < best_open ? packed : best_open;
    if (op != kLDG && op != kSTG)
      best_closed = packed < best_closed ? packed : best_closed;
  }
  best_open = warp_min(best_open);
  best_closed = warp_min(best_closed);
  if (lane == 0) {
    const int o = sm * n_subcores + sc;
    sel_open[o] = best_open == kNone
        ? -1 : sc + n_subcores * (int)(best_open & 0xffffffffu);
    sel_closed[o] = best_closed == kNone
        ? -1 : sc + n_subcores * (int)(best_closed & 0xffffffffu);
  }
}

}  // namespace

extern "C" int sm_issue_launch(
    const void* pc, const void* active, const void* ready_at,
    const void* pending, const void* wait_mem, const void* wait_bar,
    const void* last_issued, const void* unit_free, const void* ops,
    const void* n_instr, const void* instr_base, const void* sched,
    const void* t, void* sel_open, void* sel_closed, int n_sm, int n_warps,
    int n_subcores, void* stream) {
  sm_issue_kernel<<<n_sm, 32 * n_subcores, 0, (cudaStream_t)stream>>>(
      (const int32_t*)pc, (const uint8_t*)active, (const int32_t*)ready_at,
      (const int32_t*)pending, (const uint8_t*)wait_mem,
      (const uint8_t*)wait_bar, (const int32_t*)last_issued,
      (const int32_t*)unit_free, (const int32_t*)ops,
      (const int32_t*)n_instr, (const int32_t*)instr_base,
      (const int32_t*)sched, (const int32_t*)t, (int32_t*)sel_open,
      (int32_t*)sel_closed, n_warps, n_subcores);
  return (int)cudaGetLastError();
}
