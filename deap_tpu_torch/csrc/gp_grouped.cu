// K9 gp_grouped_dispatch: opcode-major GP evaluation.
//
// Replaces deap_tpu/ops/kernels.py::gp_grouped_dispatch (the Pallas
// fused gather-dispatch-scatter of gp/interpreter.py mode='grouped').
// The plain version is deap_tpu_torch/ops/kernels.py::
// gp_grouped_dispatch_plain, the JAX package's chunk loop.
//
// For every instruction row r of the schedule, with branch
// b = chunk_ops[r / chunk] and device op ops.code[b]:
//     buf[n_args + r, p] = op(x_0, ..., x_{ar-1}) for every point p,
//     x_j = src_isc[r, j] ? src_const[r, j] : buf[src_idx[r, j], p].
// The constant REPLACES the gathered value (a select, so a NaN or inf in
// a gathered row never leaks through the constant path), and operand
// slots past the op's arity are not read. The ops are the closed table
// of deap_tpu_torch/gp/pset.py::DEVICE_OPS, with IEEE division and
// cosf/sinf: this file must not be built with --use_fast_math.
//
// Bound on the H100: bytes. Each non-constant operand row read once,
// each instruction row (pad rows too) written once, the schedule arrays
// read once, at 3.35 TB/s; a few flops per element.
//
// Ordering. The TPU kernel runs its chunks as grid steps, in order, so a
// chunk may read the rows of any earlier chunk; CUDA blocks run in no
// order. The schedule sorts instructions by (depth desc, opcode) and a
// child is strictly deeper than its parent, so each depth level is a
// contiguous run of chunks that reads only argument rows and rows of
// earlier levels (the pad chunks read argument row 0 and join the last
// level). One launch carries that order itself:
// - The schedule is cut into work items: a run of rows of one chunk x a
//   tile of points, numbered in schedule order (chunk, row run, tile).
//   Each launch takes the item shape (rows, tile) and the chunk where each
//   level starts by value, and a block decodes an item from its ticket;
//   ops/kernels.py::k9_work_items decodes every ticket the same way, the
//   table the CPU tests check. Items are small (8 rows x 256 points at P
//   256) so a level of one chunk still spreads over many SMs.
// - A block takes its next item from a ticket counter (atomicAdd), in
//   order, not from blockIdx, and only once it has finished the last one.
//   Before an item of level l > 0 reads a buffer row, one thread spins
//   (acquire loads) until level l - 1's finished count reaches its item
//   count; level l - 1's items waited on level l - 2 the same way, so
//   every earlier level is done. After its stores the block passes a
//   barrier, and one thread adds one to its level's count with release
//   semantics. Each level's count has a line of its own, so its pollers
//   and finishers contend with no other level's.
// - It cannot deadlock, whatever the grid: an item waits only on items of
//   lower tickets, which blocks that already run hold, and those wait on
//   nothing later.
// - Rows other SMs wrote during the launch are read with __ldcg (L2, not
//   the SM's L1 or the read-only path), through a pointer that is not
//   const __restrict__.
// - The counters live in a workspace that starts at 0: the block that
//   takes the last ticket resets the ticket, and the item that finishes
//   the last level resets the levels' counts. Launches that share a
//   workspace must not overlap (the wrapper keeps one per stream).
// The work an element repeated for every point is hoisted: an item's op
// is decoded once (the switch is uniform), and its rows' operand
// descriptors are loaded into shared memory before the wait, so after it
// only operand rows are read; at the start the grid asks L2 for the whole
// schedule, so those dependent loads do not go to device memory. A warp
// takes one row's points, one float4 a lane a pass where P % 4 == 0, and
// no 64-bit division is done per element. Registers are capped so five
// blocks fit an SM: more items in flight at once (six spill).
// On an H100 (700 W), after an L2 flush, it takes ~19.3 us on the GP
// loop's gen-0 schedule (2 levels; ~27.7 as a launch per level) and
// ~54.6 us on an evolved one (11 levels; ~74), where a torch copy of
// the value buffer takes ~15.0 and ~20.0 us. Its phase clock
// (-DDTT_K9_PHASES, port_profile.py --kernel-times) puts most of an
// evolved item's time in the wait: each level adds a chain of the count's
// release, the poller's acquire and the operand loads.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;      // an item's rows, one a warp at a time
constexpr int kThreads = 32 * kWarps;
constexpr int kMinBlocks = 5;  // a register cap: five blocks an SM
constexpr int MAX_BRANCHES = 16;
constexpr int kMaxItemRows = 128;  // ops/kernels.py::K9_MAX_ITEM_ROWS
constexpr int kMaxLevels = 512;    // ops/kernels.py::K9_MAX_LEVELS
constexpr int kSlots = 3;          // operands of the widest device op
constexpr int kConst = -1;         // descriptor: the row's constant
constexpr int kBadRow = -2;        // descriptor: an index out of range
constexpr int kSleepNs = 32;       // the wait's poll interval

// The phase clock, built only with -DDTT_K9_PHASES: thread 0 of each
// block adds the SM clocks of each phase of its items, 0 the item's
// decode, level, op and descriptors' loads, 1 the wait and the barrier
// after it, 2 the work up to the barrier after the stores, 3 the count
// and the next ticket; 4 counts the spin's polls.
constexpr int kPhases = 5;
#ifdef DTT_K9_PHASES
__device__ unsigned long long k9_phase_clocks[kPhases];
#define K9_MARK(phase)                                     \
  if (tid == 0) {                                          \
    const long long now = clock64();                       \
    clocks[phase] += static_cast<unsigned long long>(now - mark); \
    mark = now;                                            \
  }
#else
#define K9_MARK(phase)
#endif

// The workspace: the ticket in line 0, level l's finished count in line
// 1 + l (a line each, so a level's pollers and finishers share no line
// with another level's).
constexpr int kLine = 32;  // ints of a 128-byte line

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p)
               : "memory");
  return v;
}

// Asks L2 for bytes [0, bytes) of `base`, a line (128 B) each for threads
// t, t + nthreads, ... (no register waits on it).
__device__ __forceinline__ void prefetch_l2(const void* base, size_t bytes,
                                            size_t t, size_t nthreads) {
  const char* p = static_cast<const char*>(base);
  for (size_t off = t * 128; off < bytes; off += nthreads * 128)
    asm volatile("prefetch.global.L2 [%0];" ::"l"(p + off));
}

// Adds one with release semantics (the block's stores, ordered before by
// a barrier, are visible before the count); returns the count before.
__device__ __forceinline__ int add_release(int* p) {
  int v;
  asm volatile("atom.release.gpu.global.add.s32 %0, [%1], 1;" : "=r"(v)
               : "l"(p) : "memory");
  return v;
}

// The device op of each branch, passed by value with the launch (kernel
// parameters sit in constant memory), so no table is uploaded per call.
// It is read only at constant indices (code_of): indexing it with a
// variable would copy it to every thread's local memory.
struct BranchOps {
  int code[MAX_BRANCHES];
};

__device__ __forceinline__ int code_of(const BranchOps& ops, int b) {
  int code = -1;  // a bad branch
#pragma unroll
  for (int i = 0; i < MAX_BRANCHES; ++i) code = (i == b) ? ops.code[i] : code;
  return code;
}

// The chunk where each level starts, then the chunk count, passed by
// value with the launch (a __grid_constant__ parameter: read in place,
// not copied).
struct LevelStarts {
  int chunk[kMaxLevels + 1];
};

__device__ __forceinline__ int op_arity(int code) {
  switch (code) {
    case 0: case 5: case 6: case 7: case 10: case 15: return 1;
    case 1: case 2: case 3: case 4: case 8: case 9: case 11: case 13:
    case 14: return 2;
    case 12: return 3;
    default: return 0;
  }
}

__device__ __forceinline__ float apply_op(int code, float a, float b,
                                          float c) {
  switch (code) {
    case 0: return a;                             // identity
    case 1: return a + b;                         // add
    case 2: return a - b;                         // sub
    case 3: return a * b;                         // mul
    case 4: return b == 0.0f ? 1.0f : a / b;      // protectedDiv
    case 5: return -a;                            // neg
    case 6: return cosf(a);                       // cos
    case 7: return sinf(a);                       // sin
    case 8: return a * b;                         // and
    case 9: {                                     // or: min(a + b, 1),
      const float s = a + b;                      // NaN propagates
      return s > 1.0f ? 1.0f : s;
    }
    case 10: return 1.0f - a;                     // not
    case 11: return fabsf(a - b);                 // xor
    case 12: return a > 0.5f ? b : c;             // if_then_else
    case 13: return a < b ? 1.0f : 0.0f;          // lt (NaN: 0)
    case 14: return a == b ? 1.0f : 0.0f;         // eq (NaN: 0)
    // lf, the logistic: expf (not __expf) and an IEEE division, each
    // rounded as PyTorch's CUDA exp, add and reciprocal round them
    case 15: return 1.0f / (1.0f + expf(-a));
    default: return __int_as_float(0x7fc00000);   // a bad branch: NaN
  }
}

__device__ __forceinline__ float nan_f() { return __int_as_float(0x7fc00000); }

// Operand value of descriptor (idx, c) at float4 q of a row.
__device__ __forceinline__ float4 operand4(const float* buf, int idx, float c,
                                           int P, int q) {
  if (idx >= 0)
    return __ldcg(reinterpret_cast<const float4*>(
                      buf + static_cast<size_t>(idx) * P) + q);
  // the schedule keeps every index in range; a bad one gives NaN instead
  // of a read out of bounds
  const float v = idx == kConst ? c : nan_f();
  return make_float4(v, v, v, v);
}

__device__ __forceinline__ float operand1(const float* buf, int idx, float c,
                                          int P, int p) {
  if (idx >= 0) return __ldcg(buf + static_cast<size_t>(idx) * P + p);
  return idx == kConst ? c : nan_f();
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
gp_items_kernel(float* buf, const int* __restrict__ chunk_ops,
                const __grid_constant__ BranchOps ops,
                const int* __restrict__ src_idx,
                const float* __restrict__ src_const,
                const uint8_t* __restrict__ src_isc,
                const __grid_constant__ LevelStarts levels, int nlevels,
                int* counters, int n_args, int nrows, int P, int item_rows,
                int tile, int ntiles, int per_chunk, int n_items, int max_ar,
                int chunk) {
  __shared__ int s_idx[kMaxItemRows * kSlots];
  __shared__ float s_const[kMaxItemRows * kSlots];
  __shared__ int s_ticket;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool vec4 = P % 4 == 0 && tile % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(buf) % 16 == 0;
  // the items: per_chunk of each chunk, its row runs each in ntiles
  // point tiles (ops/kernels.py::k9_work_items); these come with the
  // launch, so they hold no register
  // thread 0: the level of its current item (tickets rise, so it only
  // moves on), and the level of the block's last finished item and its
  // level's count before it
  int level = 0, done_level = -1, done = -1;
#ifdef DTT_K9_PHASES
  unsigned long long clocks[kPhases] = {};
  long long mark = clock64();
#endif
  {
    // the whole grid asks L2 for the schedule's arrays at once, so an
    // item's dependent loads of its op and descriptors find them there
    const size_t t = static_cast<size_t>(blockIdx.x) * kThreads + tid;
    const size_t nt = static_cast<size_t>(gridDim.x) * kThreads;
    const size_t slots = static_cast<size_t>(nrows - n_args) * max_ar;
    prefetch_l2(chunk_ops, sizeof(int) * (n_items / per_chunk), t, nt);
    prefetch_l2(src_isc, slots, t, nt);
    prefetch_l2(src_idx, sizeof(int) * slots, t, nt);
    prefetch_l2(src_const, sizeof(float) * slots, t, nt);
  }
  if (tid == 0) s_ticket = atomicAdd(&counters[0], 1);
  int ticket;
  for (;;) {
    __syncthreads();  // s_ticket is set; the last item's descriptors read
    ticket = s_ticket;
    if (ticket >= n_items) break;
    const int c = ticket / per_chunk, in_chunk = ticket - c * per_chunk;
    const int run = in_chunk / ntiles;
    const int row0 = c * chunk + run * item_rows;
    const int rows = min(item_rows, chunk - run * item_rows);
    const int code = code_of(ops, chunk_ops[c]);
    const int ar = min(op_arity(code), max_ar);
    // thread 0: the item's level, and the count the level before must
    // reach (its loads go out with the descriptors')
    int want = 0;
    if (tid == 0) {
      while (c >= levels.chunk[level + 1]) ++level;
      if (level > 0)
        want = (levels.chunk[level] - levels.chunk[level - 1]) * per_chunk;
    }
    // the rows' operand descriptors, before the wait (the schedule is
    // read-only); the three loads of a slot issue together
    for (int k = tid; k < rows; k += kThreads) {
      const size_t s = static_cast<size_t>(row0 + k) * max_ar;
#pragma unroll
      for (int j = 0; j < kSlots; ++j) {
        int idx = kConst;
        float cst = 0.0f;
        if (j < ar) {
          const bool isc = src_isc[s + j];
          const int row = src_idx[s + j];
          cst = src_const[s + j];
          if (!isc) idx = row >= 0 && row < nrows ? row : kBadRow;
        }
        s_idx[k * kSlots + j] = idx;
        s_const[k * kSlots + j] = cst;
      }
    }
    K9_MARK(0);
    if (want > 0) {
      // every item of the level before is done (it waited on the one
      // before it, and so on)
      const int* count = counters + kLine * level;
      while (load_acquire(count) < want) {
#ifdef DTT_K9_PHASES
        ++clocks[4];
#endif
        __nanosleep(kSleepNs);
      }
    }
    __syncthreads();  // the descriptors are in place; the wait is over
    K9_MARK(1);
    const int p0 = (in_chunk - run * ntiles) * tile, p1 = min(p0 + tile, P);
    for (int k = warp; k < rows; k += kWarps) {
      int idx[kSlots];
      float cst[kSlots];
#pragma unroll
      for (int j = 0; j < kSlots; ++j) {
        idx[j] = s_idx[k * kSlots + j];
        cst[j] = s_const[k * kSlots + j];
      }
      float* dst = buf + static_cast<size_t>(n_args + row0 + k) * P;
      if (vec4) {
        for (int q = (p0 >> 2) + lane; q < (p1 >> 2); q += 32) {
          float4 x[kSlots];
#pragma unroll
          for (int j = 0; j < kSlots; ++j)
            x[j] = j < ar ? operand4(buf, idx[j], cst[j], P, q)
                          : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          float4 y;
          y.x = apply_op(code, x[0].x, x[1].x, x[2].x);
          y.y = apply_op(code, x[0].y, x[1].y, x[2].y);
          y.z = apply_op(code, x[0].z, x[1].z, x[2].z);
          y.w = apply_op(code, x[0].w, x[1].w, x[2].w);
          reinterpret_cast<float4*>(dst)[q] = y;
        }
      } else {
        for (int p = p0 + lane; p < p1; p += 32) {
          float x[kSlots];
#pragma unroll
          for (int j = 0; j < kSlots; ++j)
            x[j] = j < ar ? operand1(buf, idx[j], cst[j], P, p) : 0.0f;
          dst[p] = apply_op(code, x[0], x[1], x[2]);
        }
      }
    }
    __syncthreads();  // every store of the item is issued
    K9_MARK(2);
    if (tid == 0) {
      // the next ticket and this item's count go out together; the
      // count's return is read only after the loop
      const int next = atomicAdd(&counters[0], 1);
      done = add_release(counters + kLine * (1 + level));
      done_level = level;
      s_ticket = next;
    }
    K9_MARK(3);
  }
  if (tid == 0) {
#ifdef DTT_K9_PHASES
    for (int k = 0; k < kPhases; ++k) atomicAdd(&k9_phase_clocks[k], clocks[k]);
#endif
    // the item that finished the last level finished last: it leaves
    // every count at 0 for the next launch
    if (done_level == nlevels - 1 &&
        done == n_items - levels.chunk[nlevels - 1] * per_chunk - 1)
      for (int l = 0; l < nlevels; ++l) counters[kLine * (1 + l)] = 0;
    // each block takes exactly one ticket past the items; the last resets
    if (ticket == n_items + static_cast<int>(gridDim.x) - 1)
      atomicExch(&counters[0], 0);
  }
}

}  // namespace

// level_starts[nlevels + 1] are host ints, the chunk where each level
// starts, then the chunk count (nlevels <= kMaxLevels); an item is
// item_rows rows of one chunk (at most kMaxItemRows) x tile points;
// counters int32[kLine (1 + nlevels)] a zeroed workspace that no other
// launch uses meanwhile; branch_ops[0..nbranches) host ints, the device
// op of each branch. One launch on `stream`.
extern "C" int gp_grouped_dispatch(void* buf, const void* chunk_ops,
                                   const int* branch_ops, const void* src_idx,
                                   const void* src_const, const void* src_isc,
                                   const int* level_starts, int nlevels,
                                   void* counters, int n_args, int nrows,
                                   int P, int item_rows, int tile, int max_ar,
                                   int chunk, int nbranches, void* stream) {
  if (P < 1 || tile < 1 || item_rows < 1 || item_rows > kMaxItemRows ||
      chunk < 1 || max_ar < 1 || nlevels < 1 || nlevels > kMaxLevels ||
      nbranches < 1 || nbranches > MAX_BRANCHES)
    return static_cast<int>(cudaErrorInvalidValue);
  BranchOps ops;
  for (int b = 0; b < MAX_BRANCHES; ++b)
    ops.code[b] = b < nbranches ? branch_ops[b] : -1;
  LevelStarts levels;
  for (int l = 0; l <= kMaxLevels; ++l)
    levels.chunk[l] = l <= nlevels ? level_starts[l] : level_starts[nlevels];
  const int ntiles = (P + tile - 1) / tile;
  const int per_chunk = (chunk + item_rows - 1) / item_rows * ntiles;
  const long long n_items =
      static_cast<long long>(level_starts[nlevels]) * per_chunk;
  if (n_items < 1 || n_items > (1LL << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, gp_items_kernel, kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  // the blocks the card holds at once (more would only queue for tickets)
  const long long resident =
      static_cast<long long>(sms) * (per_sm > 1 ? per_sm : 1);
  const int grid = static_cast<int>(n_items < resident ? n_items : resident);
  gp_items_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(buf), static_cast<const int*>(chunk_ops), ops,
      static_cast<const int*>(src_idx), static_cast<const float*>(src_const),
      static_cast<const uint8_t*>(src_isc), levels, nlevels,
      static_cast<int*>(counters), n_args, nrows, P, item_rows, tile, ntiles,
      per_chunk, static_cast<int>(n_items), max_ar, chunk);
  return static_cast<int>(cudaGetLastError());
}

#ifdef DTT_K9_PHASES
// The phase clocks' totals since the last reset: out[kPhases]; reset != 0
// clears them after the read.
extern "C" int gp_grouped_phases(unsigned long long* out, int reset) {
  cudaError_t err = cudaMemcpyFromSymbol(out, k9_phase_clocks,
                                         sizeof(k9_phase_clocks));
  if (err == cudaSuccess && reset) {
    const unsigned long long zero[kPhases] = {};
    err = cudaMemcpyToSymbol(k9_phase_clocks, zero, sizeof(zero));
  }
  return static_cast<int>(err);
}
#endif
