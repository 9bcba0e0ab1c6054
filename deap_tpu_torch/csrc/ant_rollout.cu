// J2 ant_rollout: the Koza artificial ant, one thread per ant.
//
// Replaces no Pallas kernel: the JAX package evaluates the ant with XLA,
// a lax.while_loop under vmap (deap_tpu/gp/ant.py::make_ant_evaluator),
// which on the card would be a few dozen tiny launches a step for up to
// max_moves * max_len + max_len steps. This kernel runs the whole rollout
// of every ant in one launch. The plain version is
// deap_tpu_torch/gp/ant.py::ant_rollout_plain, the JAX body step for
// step on a batch.
//
// Semantics, as the JAX body (ant.py:147-216): a program-counter stack of
// L + 3 entries (L the genome width; a push past it is dropped and a read
// clamped, as XLA's scatter and gather do); on an empty stack the routine
// restarts at the root; prog3 pushes its third, second, first child,
// prog2 its second and first, if_food_ahead the child the sensor picks;
// an action spends a move while moves < max_moves; moving onto food eats
// it and clears the cell; the loop runs while moves < max_moves and
// steps < max_steps. Child k + 1 starts where child k's subtree ends.
//
// The walk without a stack. Each thread first computes its tree's subtree
// ends from the right over the whole width (ends[i], 1 where a subtree
// does not close, as the JAX evaluator's subtree_end has them; like the
// JAX evaluator, no walk reads the length). Where the root's subtree
// closes and holds only the set's ids, the stack walk is a program
// counter moving from one if_food_ahead or action to the next: a prog's
// next node is its first child, the next slot; an if goes to its first
// child with food ahead, else to its second; after an action the walk
// goes on at the next slot, where the start of an if's second child
// (that if took its first) jumps to the if's end, again and again, and
// the root's end restarts at the root. Each run of prog nodes on the way
// is folded into the target with its count of steps, so one iteration
// handles one if or one action; the fold is added with a clip at
// max_steps (a prog step spends no move, so only max_steps cuts a run).
// The thread builds that table once (chip_smoke.py::ant_walk_table is the
// Python build of it) and walks it with its state in registers. Any other
// tree (a root that never closes, ids outside the set) takes the stack
// walk, with its stack and ends in the same shared memory. Integer
// arithmetic only, so both walks equal the plain version bit for bit, and
// the native simulator on trees whose length is the root's end.
//
// Shared memory, a warp a block: each thread's L + 3 slots of 8 bytes
// (slot s of thread t at s * 32 + t) and its copy of the trail, a bitmask
// of one word of 32 cells a row piece (word w of thread t at w * 32 + t).
// A slot holds the table entry of its node; while the table is built, its
// four 16-bit halves hold the ends pass's stack (h0), the first slot from
// there on that is not a prog (h1), the end (h2) and, at an if's second
// child, that if's end (h3); the stack walk keeps its int32 stack in the
// slots' low words and the ends in h2. Nothing is in local memory.
//
// Bound on the H100: one ant's walk is a chain of dependent shared-memory
// loads (its entry, the trail word ahead), so a launch lasts as long as
// its longest ant's chain; the card's rate counts only across ants.

#include "common.cuh"

namespace {

constexpr int kThreads = 32;     // a warp a block: 128 blocks at pop 4096
constexpr int kMaxLen = 256;     // gp/ant.py::J2_MAX_LEN
constexpr int kMaxWords = 128;   // gp/ant.py::J2_MAX_WORDS
constexpr int kIfFoodAhead = 0, kProg2 = 1, kProg3 = 2;
constexpr int kConstId = 3;      // ant_pset: 3 operators, no arguments
constexpr int kIds = 6;          // the set's ids: 3 operators, 3 actions
constexpr int kMoveForward = 0, kTurnLeft = 1, kTurnRight = 2;

__device__ __forceinline__ int arity_of(int node) {
  return node == kProg3 ? 3 : (node < kConstId ? 2 : 0);
}

__device__ __forceinline__ int wrap(int v, int n) {
  return v < 0 ? v + n : (v >= n ? v - n : v);
}

// direction d: 0 north (row + 1), 1 east (col + 1), 2 south, 3 west
__device__ __forceinline__ int d_row(int d) { return (d == 0) - (d == 2); }
__device__ __forceinline__ int d_col(int d) { return (d == 1) - (d == 3); }

// One thread's slots in the block's shared memory.
struct Slots {
  uint2* base;
  int tid;
  __device__ uint2& entry(int s) const { return base[s * kThreads + tid]; }
  // 16-bit half k of slot s
  __device__ unsigned short& half(int s, int k) const {
    return reinterpret_cast<unsigned short*>(&entry(s))[k];
  }
  // the low 32-bit word of slot s: the stack walk's stack entry s
  __device__ int& low(int s) const {
    return reinterpret_cast<int*>(&entry(s))[0];
  }
};

// A landing slot p with its prog run folded in: the first slot from p on
// that is not a prog (h1) and the prog steps skipped.
__device__ __forceinline__ unsigned fold(const Slots& sl, int p) {
  const unsigned first = sl.half(p, 1);
  return first | (first - p) << 8;
}

// The ends pass, right to left over the whole width: h2 the end of every
// slot's subtree, 1 where it does not close (the JAX evaluator's
// subtree_end), h1 the first non-prog slot from there on, h3 cleared and
// then, at each if's second child, the if's end. Returns the root's end
// where the root's subtree closes and holds only the set's ids (the slots
// the counter walk covers), else 0.
__device__ __forceinline__ int ends_pass(const Slots& sl,
                                         const int* row_nodes, int L) {
  int tsp = 0, first = L, bad = L;  // bad: the first id outside the set
  for (int i = L - 1; i >= 0; --i) {
    const int node = row_nodes[i];
    if (node < 0 || node >= kIds) bad = i;
    const int a = arity_of(node);
    int e = i + 1;
    if (a > 0) {
      if (tsp >= a) {
        const int c2 = sl.half(tsp - 1, 0);  // the first child's end
        e = sl.half(tsp - a, 0);  // 1 where the last child does not close
        tsp -= a;
        if (node == kIfFoodAhead) sl.half(c2, 3) = e;
      } else {  // a child is missing: the subtree never closes
        e = 1;
        tsp = 0;
      }
    }
    sl.half(tsp++, 0) = e;
    sl.half(i, 2) = e;
    sl.half(i, 3) = 0;  // an if to the left may mark it later
    first = (node == kProg2 || node == kProg3) ? first : i;
    sl.half(i, 1) = first;
  }
  const int n = sl.half(0, 2);
  const bool closed = n > 1 || arity_of(row_nodes[0]) == 0;
  return closed && bad >= n ? n : 0;
}

// The table of a complete root of len slots; returns the root's pair.
// Right to left, each slot's pair after the slot before it ends (h0):
// the tree's end restarts at the root, an if's second child jumps; then
// left to right each if or action's entry (x the food or action pair
// with the kind above it, y the no-food pair), reading only slots to its
// right, which still hold their halves.
__device__ __forceinline__ unsigned build_table(const Slots& sl,
                                                const int* row_nodes, int len,
                                                int* table_out) {
  const unsigned start = fold(sl, 0);
  sl.half(len, 0) = start;
  for (int p = len - 1; p >= 1; --p) {
    const int jump = sl.half(p, 3);
    sl.half(p, 0) = jump ? sl.half(jump, 0) : fold(sl, p);
  }
  for (int s = 0; s < len; ++s) {
    const int node = row_nodes[s];
    uint2 e = make_uint2(0u, 0u);
    if (node == kIfFoodAhead) {
      e = make_uint2(fold(sl, s + 1), fold(sl, sl.half(s + 1, 2)));
    } else if (node >= kConstId) {
      const unsigned next = sl.half(s + 1, 0);
      e = make_uint2(next | (node - kConstId + 1) << 16, next);
    }
    if (node == kIfFoodAhead || node >= kConstId) sl.entry(s) = e;
    if (table_out != nullptr) {
      table_out[2 * s] = static_cast<int>(e.x);
      table_out[2 * s + 1] = static_cast<int>(e.y);
    }
  }
  return start;
}

struct Walk {
  int row, col, d, moves, eaten;
  unsigned steps;
  int iters;
};

// The counter walk: one if or action an iteration, no branch but the
// loop's and the store of an eaten cell.
__device__ __forceinline__ void counter_walk(const Slots& sl,
                                             unsigned* grid_words, int tid,
                                             int R, int C, int wpr,
                                             int max_moves, int max_steps,
                                             unsigned pair, Walk& w) {
  const unsigned bound = static_cast<unsigned>(max_steps);
  while (w.moves < max_moves) {
    w.steps += pair >> 8;
    if (w.steps >= bound) {  // max_steps falls inside the prog run
      w.steps = bound;
      break;
    }
    const uint2 e = sl.entry(pair & 0xFF);
    const int ar = wrap(w.row + d_row(w.d), R);
    const int ac = wrap(w.col + d_col(w.d), C);
    unsigned* word = &grid_words[(ar * wpr + (ac >> 5)) * kThreads + tid];
    const unsigned bits = *word, bit = 1u << (ac & 31);
    const bool food = (bits & bit) != 0u;
    const unsigned kind = e.x >> 16;  // 0 if, 1 move, 2 left, 3 right
    pair = (food ? e.x : e.y) & 0xFFFFu;
    w.moves += kind != 0u;
    w.d = (w.d + ((0x1300u >> (4u * kind)) & 3u)) & 3;
    const bool fwd = kind == 1u;
    w.row = fwd ? ar : w.row;
    w.col = fwd ? ac : w.col;
    if (fwd && food) {
      *word = bits & ~bit;
      ++w.eaten;
    }
    ++w.steps;
    ++w.iters;
  }
}

// The stack walk, the JAX body as it is: any tree, a step an iteration.
__device__ __forceinline__ void stack_walk(const Slots& sl,
                                           const int* row_nodes,
                                           unsigned* grid_words, int tid,
                                           int L, int R, int C, int wpr,
                                           int max_moves, int max_steps,
                                           Walk& w) {
  const int W = L + 3;
  const unsigned bound = static_cast<unsigned>(max_steps);
  int sp = 0;
  while (w.moves < max_moves && w.steps < bound) {
    if (sp == 0) {  // the routine is done: restart at the root
      sl.low(0) = 0;
      sp = 1;
    }
    const int node_idx = sl.low(min(sp - 1, W - 1));
    const int node = row_nodes[min(max(node_idx, 0), L - 1)];
    --sp;
    if (node < kConstId) {
      const int c1 = node_idx + 1;
      const int c2 = sl.half(min(c1, L - 1), 2);
      if (node == kIfFoodAhead) {
        const int ar = wrap(w.row + d_row(w.d), R);
        const int ac = wrap(w.col + d_col(w.d), C);
        const bool food =
            (grid_words[(ar * wpr + (ac >> 5)) * kThreads + tid] >>
             (ac & 31)) & 1u;
        if (sp < W) sl.low(sp) = food ? c1 : c2;
        ++sp;
      } else {
        if (node == kProg3) {
          if (sp < W) sl.low(sp) = sl.half(min(c2, L - 1), 2);
          ++sp;
        }
        if (sp < W) sl.low(sp) = c2;
        ++sp;
        if (sp < W) sl.low(sp) = c1;
        ++sp;
      }
    } else {  // an action; the loop's condition leaves a move to spend
      ++w.moves;
      const int action = node - kConstId;
      if (action == kTurnLeft) {
        w.d = (w.d + 3) & 3;
      } else if (action == kTurnRight) {
        w.d = (w.d + 1) & 3;
      } else if (action == kMoveForward) {
        w.row = wrap(w.row + d_row(w.d), R);
        w.col = wrap(w.col + d_col(w.d), C);
        unsigned& word =
            grid_words[(w.row * wpr + (w.col >> 5)) * kThreads + tid];
        const unsigned bit = 1u << (w.col & 31);
        if (word & bit) {
          ++w.eaten;
          word &= ~bit;
        }
      }
    }
    ++w.steps;
    ++w.iters;
  }
}

__global__ void __launch_bounds__(kThreads)
ant_rollout_kernel(const int* __restrict__ nodes,
                   const unsigned* __restrict__ trail, int pop, int L, int R,
                   int C, int wpr, int max_moves, int max_steps, int r0,
                   int c0, int dir0, int* __restrict__ eaten_out,
                   int* __restrict__ steps_out, int* __restrict__ iters_out,
                   int* __restrict__ table_out) {
  extern __shared__ uint2 smem[];
  const int tid = threadIdx.x;
  const int ant = blockIdx.x * kThreads + tid;
  const Slots sl{smem, tid};
  unsigned* grid_words = reinterpret_cast<unsigned*>(smem + (L + 3) * kThreads);
  const int words = R * wpr;
  for (int w = 0; w < words; ++w) grid_words[w * kThreads + tid] = trail[w];
  if (ant >= pop) return;
  const int* row_nodes = nodes + static_cast<size_t>(ant) * L;
  int* table = table_out == nullptr
                   ? nullptr
                   : table_out + static_cast<size_t>(ant) * (L + 1) * 2;
  Walk w{r0, c0, dir0, 0, 0, 0u, 0};
#ifndef DTT_J2_STACK_ONLY
  const int len = ends_pass(sl, row_nodes, L);
#else  // a yardstick (port_profile.py --j2-variants): every ant on the stack
  const int len = ends_pass(sl, row_nodes, L) * 0;
#endif
  if (len > 0) {
    const unsigned start = build_table(sl, row_nodes, len, table);
    if (table != nullptr) {
      for (int s = len; s < L; ++s) table[2 * s] = table[2 * s + 1] = 0;
      table[2 * L] = static_cast<int>(start);
      table[2 * L + 1] = 1;
    }
    counter_walk(sl, grid_words, tid, R, C, wpr, max_moves, max_steps,
                 start, w);
  } else {
    if (table != nullptr)
      for (int s = 0; s <= L; ++s) table[2 * s] = table[2 * s + 1] = 0;
    stack_walk(sl, row_nodes, grid_words, tid, L, R, C, wpr, max_moves,
               max_steps, w);
  }
  eaten_out[ant] = w.eaten;
  if (steps_out != nullptr) steps_out[ant] = static_cast<int>(w.steps);
  if (iters_out != nullptr) iters_out[ant] = w.iters;
}

}  // namespace

// nodes int32[pop, L], trail uint32[R, wpr] (cell
// (r, c) is bit c % 32 of word r * wpr + c / 32), eaten int32[pop] out;
// steps int32[pop], iterations int32[pop] (the walk's loop trips) and
// table int32[pop, L + 1, 2] (gp/ant.py::ant_rollout_traced's layout) out
// or null. One launch on `stream`.
extern "C" int ant_rollout(const void* nodes, const void* trail, int pop,
                           int L, int R, int C,
                           int max_moves, int max_steps, int r0, int c0,
                           int dir0, void* eaten, void* steps, void* iters,
                           void* table, void* stream) {
  const int wpr = (C + 31) / 32;
  if (pop < 1 || L < 1 || L > kMaxLen || R < 1 || C < 1 ||
      R * wpr > kMaxWords || r0 < 0 || r0 >= R || c0 < 0 || c0 >= C ||
      dir0 < 0 || dir0 > 3 || max_moves < 0 || max_steps < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (pop + kThreads - 1) / kThreads;
  const size_t shared = (sizeof(uint2) * (L + 3) +
                         sizeof(unsigned) * R * wpr) * kThreads;
  cudaError_t err = cudaFuncSetAttribute(
      ant_rollout_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(shared));
  if (err != cudaSuccess) return static_cast<int>(err);
  ant_rollout_kernel<<<blocks, kThreads, shared,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(nodes), static_cast<const unsigned*>(trail), pop, L, R, C, wpr, max_moves,
      max_steps, r0, c0, dir0, static_cast<int*>(eaten),
      static_cast<int*>(steps), static_cast<int*>(iters),
      static_cast<int*>(table));
  return static_cast<int>(cudaGetLastError());
}
