// Native artificial-ant simulator over prefix-encoded GP action trees.
//
// The port's copy of deap_tpu/native/src/ant.cpp: the host evaluator of
// the ant (the reference's AntSimulatorFast pattern), which a caller
// picks explicitly (deap_tpu_torch/native/ant_binding.py); the card's
// evaluator is J2 (deap_tpu_torch/csrc/ant_rollout.cu), which it checks.
//
// Exposed C ABI (ctypes-loaded by deap_tpu_torch/native/ant_binding.py):
//   dtt_ant_eval(nodes, lengths, pop, max_len, trail, rows, cols,
//                max_moves, start_row, start_col, start_dir, out_eaten)
//
// Node encoding matches deap_tpu_torch.gp.ant.ant_pset(): ops 0/1/2 =
// if_food_ahead/prog2/prog3, terminals const_id+0/1/2 =
// move_forward/turn_left/turn_right (const_id == 3 for this set).

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int IF_FOOD_AHEAD = 0;
constexpr int PROG2 = 1;
constexpr int PROG3 = 2;
constexpr int CONST_ID = 3;  // ant_pset: 3 ops, 0 args
constexpr int MOVE_FORWARD = 0;
constexpr int TURN_LEFT = 1;
constexpr int TURN_RIGHT = 2;

const int DIR_ROW[4] = {1, 0, -1, 0};   // north/east/south/west
const int DIR_COL[4] = {0, 1, 0, -1};

struct Sim {
    const int32_t* nodes;
    int len;
    std::vector<uint8_t> grid;   // row-major food map (mutated)
    int rows, cols;
    int row, col, dir;
    int moves, max_moves, eaten;

    int arity(int32_t node) const {
        if (node == PROG3) return 3;
        if (node < CONST_ID) return 2;
        return 0;
    }

    // exclusive end of the subtree at i (searchSubtree arity walk)
    int skip(int i) const {
        int pending = 1;
        while (pending > 0 && i < len) {
            pending += arity(nodes[i]) - 1;
            ++i;
        }
        return i;
    }

    bool food_ahead() const {
        int r = (row + DIR_ROW[dir] + rows) % rows;
        int c = (col + DIR_COL[dir] + cols) % cols;
        return grid[r * cols + c] != 0;
    }

    void action(int a) {
        if (moves >= max_moves) return;
        ++moves;
        if (a == TURN_LEFT) {
            dir = (dir + 3) % 4;
        } else if (a == TURN_RIGHT) {
            dir = (dir + 1) % 4;
        } else {  // MOVE_FORWARD
            row = (row + DIR_ROW[dir] + rows) % rows;
            col = (col + DIR_COL[dir] + cols) % cols;
            uint8_t& cell = grid[row * cols + col];
            if (cell) {
                ++eaten;
                cell = 0;
            }
        }
    }

    // execute the subtree at i; returns its exclusive end
    int exec(int i) {
        int32_t node = nodes[i];
        switch (node) {
            case IF_FOOD_AHEAD: {
                int c1 = i + 1;
                int c2 = skip(c1);
                int end = skip(c2);
                if (food_ahead()) exec(c1); else exec(c2);
                return end;
            }
            case PROG2: {
                int c2 = exec(i + 1);
                return exec(c2);
            }
            case PROG3: {
                int c2 = exec(i + 1);
                int c3 = exec(c2);
                return exec(c3);
            }
            default:
                action(node - CONST_ID);
                return i + 1;
        }
    }

    int run() {
        while (moves < max_moves) exec(0);
        return eaten;
    }
};

}  // namespace

extern "C" void dtt_ant_eval(
    const int32_t* nodes, const int32_t* lengths, int pop, int max_len,
    const uint8_t* trail, int rows, int cols, int max_moves,
    int start_row, int start_col, int start_dir, int32_t* out_eaten) {
    for (int p = 0; p < pop; ++p) {
        Sim sim;
        sim.nodes = nodes + static_cast<int64_t>(p) * max_len;
        sim.len = lengths[p];
        sim.grid.assign(trail, trail + rows * cols);
        sim.rows = rows;
        sim.cols = cols;
        sim.row = start_row;
        sim.col = start_col;
        sim.dir = start_dir;
        sim.moves = 0;
        sim.max_moves = max_moves;
        sim.eaten = 0;
        out_eaten[p] = sim.run();
    }
}
