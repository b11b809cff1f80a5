// One quantum (Delta cycles) of the simulator's SM phase, for every SM, in
// one launch.
//
// Replaces, as the SM phase of the port's main path, the per-cycle use of
// repro/kernels/sm_issue/kernel.py:issue_select_pallas (the Pallas TPU
// kernel _issue_kernel) and the ~70 small tensor operations around each of
// its launches: it computes exactly repro/sim/smcore.py:sm_quantum_single,
// Delta iterations of sm_cycle_single, for every SM it is given.  Per
// cycle, in the reference's order:
//   1. _deliver: resolved MSHR rows (stage 3, t <= now) are freed and the
//      loads among them count down their warp's pending loads;
//   2. _release_barriers: a warp at a CTA barrier resumes once every active
//      warp of its CTA has arrived or finished (always computed: with no
//      warp at a barrier it changes nothing);
//   3. _issue_subcore for each sub-core in order: candidates are active,
//      pc < n_instr, not blocked on memory or a barrier, scoreboard-ready,
//      dispatch port free, and for LDG/STG a free MSHR row *now*, after the
//      lower sub-cores' allocations this cycle; the GTO or LRR key's least
//      value wins, ties to the lowest slot; then gen_address, the L1 probe
//      (first matching way, else the first least-recently-used way, F3),
//      the address-set insert (4 linear probes of the uint32 multiplicative
//      hash; uint32_t wraparound is F2's arithmetic), MSHR allocation in
//      the first free row (F3), scoreboard, port, last-issued warp, stats;
//   4. cycles_issue and warp_cycles.
//
// Lanes: the launch runs L independent simulations at once (a sweep's
// configs, a grid's (workload, config) pairs; repro_torch/core/sweep.py):
// one block per (lane, SM), L x n_sm blocks, the state leaves laid out
// (L, n_sm, ...) so that block b owns the b-th SM slice of every leaf.
// Each block reads its lane's trace arrays, trace scalars, instr_base,
// latency tables, timing scalars and t0 at that lane's offset; a lane
// stride of 0 shares one of them among all lanes (a sweep's trace).
//
// Design: one block per simulated SM, one warp of 32 threads per sub-core.
// The SM's whole state (warps, dispatch ports, last-issued slots, L1 tags
// and LRU times, address set, its MSHR rows, its 7 counters; ~18 KB at the
// RTX 3080 Ti config) is loaded into shared memory once, stays there for
// the Delta cycles, and is written once to fresh output tensors: inputs are
// never modified.  Trace arrays are read through the read-only path, and
// every scalar (t0, n_instr, the latency tables, the scheduler) from device
// memory, so the host reads nothing during the SM phase.  Warp selection is
// a shuffle reduction over a packed (key + 1, slot) value in the sub-core's
// warp; the winner's L1 probe, address-set probes and free-row search run
// on the same warp as ballots over ways, probes and rows, and its thread 0
// writes the results; sub-core after sub-core, with a block barrier
// between them, since the L1, the address set and the MSHR rows are shared
// by the sub-cores of an SM.  The barrier step runs only in cycles where a
// warp waits at a barrier, and the free rows are counted by the whole
// block.
//
// Bound: the state is read and written once per quantum (~37 KB per SM at
// the RTX 3080 Ti config, 2.9 MB for 80 SMs, under 1 us at 3.35 TB/s); the
// work is a chain of dependent shared-memory steps per SM and cycle (the
// sub-cores in turn), on 80 of the card's 132 SMs: latency bounds it, far
// above the byte bound.  What bounded the eager SM phase was the host:
// some 70 launches and one device-to-host read per simulated cycle.  This
// kernel is one launch per quantum, with no host read.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNLeaves = 26;
constexpr int kNAux = 13;
constexpr int kNUnits = 5;
constexpr int kNClasses = 7;
constexpr int kLDG = 4;
constexpr int kSTG = 5;
constexpr int kBAR = 6;
constexpr int kStream = 1;
constexpr int kStrided = 2;
constexpr unsigned long long kNone = ~0ull;
constexpr unsigned FULL = 0xffffffffu;

// repro/sim/config.py:UNIT_OF_CLASS
__constant__ int kUnitOfClass[kNClasses] = {0, 1, 2, 3, 4, 4, 1};

// indices of the state's leaves, in the wrapper's order (kernel.py:LEAVES);
// their sizes come from the wrapper (kernel.py:leaf_counts)
enum Leaf {
  PC, ACTIVE, READY_AT, PENDING, WAIT_MEM, WAIT_BAR, CTA, WIC,
  LAST_ISSUED, UNIT_FREE, L1_TAG, L1_LRU, ADDRSET, ADDRSET_OVER,
  R_STAGE, R_ADDR, R_T, R_WARP, R_IS_STORE,
  S_ISSUED, S_ISSUED_MEM, S_L1_HIT, S_L1_MISS, S_CYCLES_ISSUE, S_STALL,
  S_WARP_CYCLES
};

struct Args {
  const void* in[kNLeaves];
  void* out[kNLeaves];
  int count[kNLeaves];    // elements per SM
  int off[kNLeaves];      // offset in shared memory, in int32 words
  int is_bool[kNLeaves];  // 1-byte bool leaf
  const int32_t* ops;
  const uint8_t* dep;
  const int32_t* addr_mode;
  const int32_t* addr_param;
  const int32_t* n_instr;
  const int32_t* warps_per_cta;
  const int32_t* instr_base;  // null: 0
  const int32_t* lat;
  const int32_t* disp;
  const int32_t* sched;
  const int32_t* l1_hit_lat;
  const int32_t* icnt_lat;
  const int32_t* t0;
  long long lane_stride[kNAux];  // elements between lanes, in aux order
  int n_warps, n_subcores, l1_sets, l1_ways, addrset_cap, mshr, mem_blocks,
      quantum;
  int n_sm;               // SMs per lane
  int scratch;            // offset of W words of scratch
};

__device__ __forceinline__ int floor_mod(int a, int m) {
  const int r = a % m;
  return r < 0 ? r + m : r;
}

// repro/sim/trace.py:gen_address in int32 / uint32 arithmetic that wraps
__device__ __forceinline__ int gen_address(int mode, int param, int gwarp,
                                           int pc, int mem_blocks) {
  const uint32_t p = (uint32_t)param, g = (uint32_t)gwarp, c = (uint32_t)pc;
  if (mode == kStream)
    return floor_mod((int)(p * 4096u + g * 8u + (uint32_t)floor_mod(pc, 8)),
                     mem_blocks);
  if (mode == kStrided)
    return floor_mod((int)(p * 4096u + g * 257u + c * 31u), mem_blocks);
  const uint32_t h = g * 2654435761u + (c * 40503u + p * 97u);
  return (int)(h % (uint32_t)mem_blocks);
}

__device__ __forceinline__ unsigned long long warp_min(unsigned long long v) {
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long x = __shfl_xor_sync(FULL, v, o);
    v = x < v ? x : v;
  }
  return v;
}

__global__ void __launch_bounds__(1024) sm_quantum_kernel(const Args a) {
  extern __shared__ int32_t sh[];
  __shared__ int s_lat[kNClasses], s_disp[kNClasses];
  __shared__ int s_free, s_issued_any, s_n_active;
  // block = one SM of one lane; its slice of every leaf is the block's
  const int sm = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const long long lane = blockIdx.x / a.n_sm;
  const int W = a.n_warps, SC = a.n_subcores, M = a.mshr;
  const int32_t* ops = a.ops + lane * a.lane_stride[0];
  const uint8_t* dep = a.dep + lane * a.lane_stride[1];
  const int32_t* addr_mode = a.addr_mode + lane * a.lane_stride[2];
  const int32_t* addr_param = a.addr_param + lane * a.lane_stride[3];

  for (int f = 0; f < kNLeaves; ++f) {
    const int n = a.count[f];
    int32_t* dst = sh + a.off[f];
    if (a.is_bool[f]) {
      const uint8_t* src = (const uint8_t*)a.in[f] + (size_t)sm * n;
      for (int i = tid; i < n; i += nt) dst[i] = src[i] != 0;
    } else {
      const int32_t* src = (const int32_t*)a.in[f] + (size_t)sm * n;
      for (int i = tid; i < n; i += nt) dst[i] = src[i];
    }
  }
  if (tid < kNClasses) {
    s_lat[tid] = __ldg(a.lat + lane * a.lane_stride[7] + tid);
    s_disp[tid] = __ldg(a.disp + lane * a.lane_stride[8] + tid);
  }
  if (tid == 0) s_n_active = 0;
  int32_t* pc = sh + a.off[PC];
  int32_t* active = sh + a.off[ACTIVE];
  int32_t* ready_at = sh + a.off[READY_AT];
  int32_t* pending = sh + a.off[PENDING];
  int32_t* wait_mem = sh + a.off[WAIT_MEM];
  int32_t* wait_bar = sh + a.off[WAIT_BAR];
  int32_t* cta = sh + a.off[CTA];
  int32_t* wic = sh + a.off[WIC];
  int32_t* last_issued = sh + a.off[LAST_ISSUED];
  int32_t* unit_free = sh + a.off[UNIT_FREE];
  int32_t* l1_tag = sh + a.off[L1_TAG];
  int32_t* l1_lru = sh + a.off[L1_LRU];
  int32_t* aset = sh + a.off[ADDRSET];
  int32_t* r_stage = sh + a.off[R_STAGE];
  int32_t* r_addr = sh + a.off[R_ADDR];
  int32_t* r_t = sh + a.off[R_T];
  int32_t* r_warp = sh + a.off[R_WARP];
  int32_t* r_store = sh + a.off[R_IS_STORE];
  int32_t* rel = sh + a.scratch;

  const int n_instr = __ldg(a.n_instr + lane * a.lane_stride[4]);
  const int wpc = __ldg(a.warps_per_cta + lane * a.lane_stride[5]);
  const int base =
      a.instr_base ? __ldg(a.instr_base + lane * a.lane_stride[6]) : 0;
  const bool gto = __ldg(a.sched + lane * a.lane_stride[9]) == 0;
  const int l1_hit_lat = __ldg(a.l1_hit_lat + lane * a.lane_stride[10]);
  const int icnt_lat = __ldg(a.icnt_lat + lane * a.lane_stride[11]);
  const int t0 = __ldg(a.t0 + lane * a.lane_stride[12]);
  const int warp_id = tid >> 5, thr = tid & 31;   // thread of the warp
  __syncthreads();
  {
    // the SM phase never changes `active`: warp_cycles grows by a constant
    int c = 0;
    for (int w = tid; w < W; w += nt) c += active[w];
    if (c) atomicAdd(&s_n_active, c);
  }

  for (int cyc = 0; cyc < a.quantum; ++cyc) {
    const int t = t0 + cyc;
    // 1. deliver resolved responses
    for (int r = tid; r < M; r += nt) {
      if (r_stage[r] == 3 && r_t[r] <= t) {
        r_stage[r] = 0;
        const int w = r_warp[r];
        if (!r_store[r] && 0 <= w && w < W) atomicSub(&pending[w], 1);
      }
    }
    __syncthreads();
    // 2. CTA barriers, where a warp waits at one: every decision reads the
    // state before any release
    int at_bar = 0;
    for (int w = tid; w < W; w += nt) at_bar |= wait_bar[w];
    if (__syncthreads_or(at_bar)) {
      for (int w = tid; w < W; w += nt) rel[w] = wait_bar[w];
      __syncthreads();
      // every (waiting warp, warp slot) pair at once: an active warp of the
      // same CTA that neither waits nor has finished holds the warp back
      for (int i = tid; i < W * W; i += nt) {
        const int w = i / W, j = i - w * W;
        if (wait_bar[w] && active[j] && cta[j] == cta[w] && !wait_bar[j] &&
            pc[j] < n_instr)
          rel[w] = 0;
      }
      __syncthreads();
      for (int w = tid; w < W; w += nt)
        if (rel[w]) {
          wait_bar[w] = 0;
          ready_at[w] = t;
        }
    }
    // the MSHR rows free now
    int n_free = 0;
    for (int r0 = 0; r0 < M; r0 += nt)
      n_free += __syncthreads_count(r0 + tid < M && r_stage[r0 + tid] == 0);
    if (tid == 0) {
      s_free = n_free;
      s_issued_any = 0;
    }
    __syncthreads();
    // 3. the sub-cores in order
    for (int sc = 0; sc < SC; ++sc) {
      if (warp_id == sc) {
        const int per_sc = W / SC;
        const bool has_free = s_free > 0;
        const int last = last_issued[sc];
        const int32_t* uf = unit_free + sc * kNUnits;
        unsigned long long best = kNone;
        bool exists = false;
        for (int j = thr; j < per_sc; j += 32) {
          const int w = sc + SC * j;
          const int p = pc[w];
          if (!active[w] || p >= n_instr) continue;
          exists = true;
          if ((wait_mem[w] && pending[w] > 0) || wait_bar[w] ||
              ready_at[w] > t)
            continue;
          const int op = __ldg(ops + base + min(max(p, 0), n_instr - 1));
          if (uf[kUnitOfClass[op]] > t) continue;
          if ((op == kLDG || op == kSTG) && !has_free) continue;
          const int key = gto ? (w == last ? -1 : w)
                              : floor_mod(w - last - 1, W);
          const unsigned long long packed =
              ((unsigned long long)(unsigned)(key + 1) << 32) | (unsigned)j;
          best = packed < best ? packed : best;
        }
        best = warp_min(best);
        exists = __any_sync(FULL, exists);
        // the winner's issue, on the whole warp: every thread holds the
        // same winner; threads probe in parallel, thread 0 writes
        if (best == kNone) {
          if (exists && thr == 0) sh[a.off[S_STALL]] += 1;
        } else {
          const int w = sc + SC * (int)(best & 0xffffffffu);
          const int spc = min(max(pc[w], 0), n_instr - 1);
          const int op = __ldg(ops + base + spc);
          const bool mem = op == kLDG || op == kSTG;
          bool hit = false, miss = false;
          if (mem) {
            const int gwarp =
                (int)((uint32_t)cta[w] * (uint32_t)wpc + (uint32_t)wic[w]);
            const int addr = gen_address(__ldg(addr_mode + base + spc),
                                         __ldg(addr_param + base + spc),
                                         gwarp, spc, a.mem_blocks);
            // L1 probe: the first matching way, else the first way of
            // least LRU time
            const int set = floor_mod(addr, a.l1_sets);
            int32_t* tag = l1_tag + set * a.l1_ways;
            int32_t* lru = l1_lru + set * a.l1_ways;
            int way = -1;
            unsigned long long victim = kNone;
            for (int k0 = 0; k0 < a.l1_ways && way < 0; k0 += 32) {
              const int k = k0 + thr;
              const unsigned match =
                  __ballot_sync(FULL, k < a.l1_ways && tag[k] == addr);
              if (match) way = k0 + __ffs(match) - 1;
              const unsigned long long key = k < a.l1_ways
                  ? ((unsigned long long)((uint32_t)lru[k] ^ 0x80000000u)
                     << 32) | (unsigned)k
                  : kNone;
              victim = min(victim, warp_min(key));
            }
            hit = way >= 0;
            if (!hit) way = (int)(victim & 0xffffffffu);
            // the unique-address set: the first of 4 linear probes that
            // holds addr or is empty
            const int cap = a.addrset_cap;
            const int h =
                (int)(((uint32_t)addr * 2654435761u) % (uint32_t)cap);
            const int cur = thr < 4 ? aset[(h + thr) % cap] : 0;
            const unsigned ok =
                __ballot_sync(FULL, thr < 4 && (cur == addr || cur == -1));
            // MSHR allocation on a miss: the first free row (one exists:
            // has_free held, and only this warp allocates)
            int row = -1;
            if (!hit)
              for (int r0 = 0; r0 < M && row < 0; r0 += 32) {
                const unsigned f = __ballot_sync(
                    FULL, r0 + thr < M && r_stage[r0 + thr] == 0);
                if (f) row = r0 + __ffs(f) - 1;
              }
            if (thr == 0) {
              tag[way] = addr;
              lru[way] = t;
              if (ok)
                aset[(h + __ffs(ok) - 1) % cap] = addr;
              else
                sh[a.off[ADDRSET_OVER]] += 1;
              if (!hit) {
                miss = true;
                r_stage[row] = 1;
                r_addr[row] = addr;
                r_t[row] = t + icnt_lat;
                r_warp[row] = w;
                r_store[row] = op == kSTG;
                s_free -= 1;
              }
            }
          }
          if (thr == 0) {
            const int lat =
                op == kLDG ? (hit ? l1_hit_lat : 1) : s_lat[op];
            const bool dep_next =
                spc + 1 < n_instr && __ldg(dep + base + spc + 1);
            pc[w] = spc + 1;
            ready_at[w] = t + (dep_next ? max(lat, 1) : 1);
            wait_mem[w] = dep_next && miss;
            if (op == kBAR) wait_bar[w] = 1;
            if (miss && op == kLDG) pending[w] += 1;
            unit_free[sc * kNUnits + kUnitOfClass[op]] = t + s_disp[op];
            last_issued[sc] = w;
            sh[a.off[S_ISSUED]] += 1;
            sh[a.off[S_ISSUED_MEM]] += mem;
            sh[a.off[S_L1_HIT]] += hit;
            sh[a.off[S_L1_MISS]] += miss;
            s_issued_any = 1;
          }
        }
      }
      __syncthreads();
    }
    // 4. per-cycle counters
    if (tid == 0) {
      sh[a.off[S_CYCLES_ISSUE]] += s_issued_any;
      sh[a.off[S_WARP_CYCLES]] += s_n_active;
    }
  }
  __syncthreads();
  for (int f = 0; f < kNLeaves; ++f) {
    const int n = a.count[f];
    const int32_t* src = sh + a.off[f];
    if (a.is_bool[f]) {
      uint8_t* dst = (uint8_t*)a.out[f] + (size_t)sm * n;
      for (int i = tid; i < n; i += nt) dst[i] = (uint8_t)src[i];
    } else {
      int32_t* dst = (int32_t*)a.out[f] + (size_t)sm * n;
      for (int i = tid; i < n; i += nt) dst[i] = src[i];
    }
  }
}

}  // namespace

// in: the 26 state leaves of all lanes and SMs, contiguous (L, n_sm, ...),
// in kernel.py:LEAVES order (int32, or 1-byte bool where is_bool),
// count[f] elements per SM (kernel.py:leaf_counts); out: 26 tensors of the
// same shapes.  aux: ops, dep, addr_mode, addr_param, n_instr,
// warps_per_cta, instr_base (null: 0), lat, disp, sched, l1_hit_lat,
// icnt_lat, t0, each of lane l at aux[i] + l * lane_stride[i] elements.
// dims: warps per SM, sub-cores, L1 sets, L1 ways, address-set capacity,
// MSHR rows per SM, memory blocks, Delta.  Returns cudaGetLastError()
// after the launch (0 when it was accepted), or cudaErrorInvalidValue for
// sizes it cannot take.
extern "C" int sm_quantum_launch(const void* const* in, void* const* out,
                                 const int* count, const int* is_bool,
                                 const void* const* aux,
                                 const long long* lane_stride,
                                 const int* dims, int n_lanes, int n_sm,
                                 void* stream) {
  Args a;
  a.n_warps = dims[0];
  a.n_subcores = dims[1];
  a.l1_sets = dims[2];
  a.l1_ways = dims[3];
  a.addrset_cap = dims[4];
  a.mshr = dims[5];
  a.mem_blocks = dims[6];
  a.quantum = dims[7];
  const int W = a.n_warps, SC = a.n_subcores;
  if (SC < 1 || SC > 32 || W < 1 || W % SC || a.l1_sets < 1 ||
      a.l1_ways < 1 || a.addrset_cap < 1 || a.mshr < 0 || a.mem_blocks < 1 ||
      n_sm < 1 || n_lanes < 1 || (long long)n_lanes * n_sm > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  int words = 0;
  for (int f = 0; f < kNLeaves; ++f) {
    if (count[f] < 0) return (int)cudaErrorInvalidValue;
    a.in[f] = in[f];
    a.out[f] = out[f];
    a.count[f] = count[f];
    a.off[f] = words;
    a.is_bool[f] = is_bool[f];
    words += count[f];
  }
  a.scratch = words;
  words += W;
  a.ops = (const int32_t*)aux[0];
  a.dep = (const uint8_t*)aux[1];
  a.addr_mode = (const int32_t*)aux[2];
  a.addr_param = (const int32_t*)aux[3];
  a.n_instr = (const int32_t*)aux[4];
  a.warps_per_cta = (const int32_t*)aux[5];
  a.instr_base = (const int32_t*)aux[6];
  a.lat = (const int32_t*)aux[7];
  a.disp = (const int32_t*)aux[8];
  a.sched = (const int32_t*)aux[9];
  a.l1_hit_lat = (const int32_t*)aux[10];
  a.icnt_lat = (const int32_t*)aux[11];
  a.t0 = (const int32_t*)aux[12];
  for (int i = 0; i < kNAux; ++i) {
    if (lane_stride[i] < 0) return (int)cudaErrorInvalidValue;
    a.lane_stride[i] = lane_stride[i];
  }
  a.n_sm = n_sm;
  const size_t smem = sizeof(int32_t) * (size_t)words;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        sm_quantum_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  sm_quantum_kernel<<<n_lanes * n_sm, 32 * SC, smem, (cudaStream_t)stream>>>(
      a);
  return (int)cudaGetLastError();
}
