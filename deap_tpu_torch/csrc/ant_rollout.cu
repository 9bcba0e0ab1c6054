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
// steps < max_steps. Child k + 1 starts where child k's subtree ends: each
// thread first computes every live slot's subtree end from the right
// with a stack (ends[i], the JAX body's subtree_end of slot i, for the
// slots a valid prefix tree reads). Integer arithmetic only, so the
// result equals the plain version and the native simulator bit for bit.
//
// Bound on the H100: operations. A step is a chain of dependent integer
// operations and local-memory loads of one ant; each ant's chain is
// serial, so an ant's rollout is latency-bound and the card's rate counts
// only across ants. The trail is a bitmask, one word of 32 cells a row
// piece, each ant with its private copy in shared memory (word w of
// thread t at w * kThreads + t: threads reading the same word hit
// different banks).

#include "common.cuh"

namespace {

constexpr int kThreads = 32;     // a warp a block: 128 blocks at pop 4096
constexpr int kMaxLen = 256;     // gp/ant.py::J2_MAX_LEN
constexpr int kMaxWords = 128;   // gp/ant.py::J2_MAX_WORDS
constexpr int kStack = kMaxLen + 3;
constexpr int kIfFoodAhead = 0, kProg2 = 1, kProg3 = 2;
constexpr int kConstId = 3;      // ant_pset: 3 operators, no arguments
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

__global__ void __launch_bounds__(kThreads)
ant_rollout_kernel(const int* __restrict__ nodes,
                   const int* __restrict__ lengths,
                   const unsigned* __restrict__ trail, int pop, int L, int R,
                   int C, int wpr, int max_moves, int max_steps, int r0,
                   int c0, int dir0, int* __restrict__ eaten_out,
                   int* __restrict__ steps_out) {
  extern __shared__ unsigned grid_words[];
  const int tid = threadIdx.x;
  const int ant = blockIdx.x * kThreads + tid;
  const int words = R * wpr;
  for (int w = 0; w < words; ++w) grid_words[w * kThreads + tid] = trail[w];
  if (ant >= pop) return;
  const int* row_nodes = nodes + static_cast<size_t>(ant) * L;
  const int len = min(max(lengths[ant], 0), L);
  const int W = L + 3;
  int ends[kMaxLen];
  int stack[kStack];
  // every live slot's subtree end, right to left: a terminal ends at
  // i + 1, an operator where its last child ends (the stack holds the
  // ends of the subtrees to the right, the first child's on top)
  {
    int tsp = 0;
    for (int i = len - 1; i >= 0; --i) {
      const int a = arity_of(row_nodes[i]);
      int e = i + 1;
      for (int k = 0; k < a && tsp > 0; ++k) e = stack[--tsp];
      stack[tsp++] = e;
      ends[i] = e;
    }
    for (int i = len; i < L; ++i) ends[i] = i + 1;
  }
  int sp = 0, row = r0, col = c0, d = dir0, moves = 0, eaten = 0, steps = 0;
  while (moves < max_moves && steps < max_steps) {
    if (sp == 0) {  // the routine is done: restart at the root
      stack[0] = 0;
      sp = 1;
    }
    const int node_idx = stack[min(sp - 1, W - 1)];
    const int node = row_nodes[min(max(node_idx, 0), L - 1)];
    --sp;
    if (node < kConstId) {
      const int c1 = node_idx + 1;
      const int c2 = ends[min(c1, L - 1)];
      if (node == kIfFoodAhead) {
        const int ar = wrap(row + d_row(d), R), ac = wrap(col + d_col(d), C);
        const bool food =
            (grid_words[(ar * wpr + (ac >> 5)) * kThreads + tid] >>
             (ac & 31)) & 1u;
        if (sp < W) stack[sp] = food ? c1 : c2;
        ++sp;
      } else {
        if (node == kProg3) {
          if (sp < W) stack[sp] = ends[min(c2, L - 1)];
          ++sp;
        }
        if (sp < W) stack[sp] = c2;
        ++sp;
        if (sp < W) stack[sp] = c1;
        ++sp;
      }
    } else {  // an action; the loop's condition leaves a move to spend
      ++moves;
      const int action = node - kConstId;
      if (action == kTurnLeft) {
        d = (d + 3) & 3;
      } else if (action == kTurnRight) {
        d = (d + 1) & 3;
      } else if (action == kMoveForward) {
        row = wrap(row + d_row(d), R);
        col = wrap(col + d_col(d), C);
        unsigned& word =
            grid_words[(row * wpr + (col >> 5)) * kThreads + tid];
        const unsigned bit = 1u << (col & 31);
        if (word & bit) {
          ++eaten;
          word &= ~bit;
        }
      }
    }
    ++steps;
  }
  eaten_out[ant] = eaten;
  if (steps_out != nullptr) steps_out[ant] = steps;
}

}  // namespace

// nodes int32[pop, L], lengths int32[pop], trail uint32[R, wpr] (cell
// (r, c) is bit c % 32 of word r * wpr + c / 32), eaten int32[pop] out,
// steps int32[pop] out or null. One launch on `stream`.
extern "C" int ant_rollout(const void* nodes, const void* lengths,
                           const void* trail, int pop, int L, int R, int C,
                           int max_moves, int max_steps, int r0, int c0,
                           int dir0, void* eaten, void* steps, void* stream) {
  const int wpr = (C + 31) / 32;
  if (pop < 1 || L < 1 || L > kMaxLen || R < 1 || C < 1 ||
      R * wpr > kMaxWords || r0 < 0 || r0 >= R || c0 < 0 || c0 >= C ||
      dir0 < 0 || dir0 > 3)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (pop + kThreads - 1) / kThreads;
  const size_t shared = sizeof(unsigned) * R * wpr * kThreads;
  ant_rollout_kernel<<<blocks, kThreads, shared,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(nodes), static_cast<const int*>(lengths),
      static_cast<const unsigned*>(trail), pop, L, R, C, wpr, max_moves,
      max_steps, r0, c0, dir0, static_cast<int*>(eaten),
      static_cast<int*>(steps));
  return static_cast<int>(cudaGetLastError());
}
