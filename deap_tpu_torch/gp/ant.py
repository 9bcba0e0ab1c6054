"""The Koza artificial ant: batched rollouts on a toroidal grid.

Port of :mod:`deap_tpu.gp.ant`. A GP action tree over ``if_food_ahead``/
``prog2``/``prog3`` with ``move_forward``/``turn_left``/``turn_right``
terminals runs repeatedly on a toroidal grid until ``max_moves`` moves
are spent; its fitness is the food eaten (89 pieces on the Santa Fe
trail).

An action tree runs for its side effects: the rollout walks the prefix
array with a program-counter stack — ``prog`` nodes push all their
children, ``if_food_ahead`` only the branch the food sensor picks,
terminals act. :func:`ant_rollout` is that loop for a whole population:
J2 (``csrc/ant_rollout.cu``, one thread an ant, one launch) on the
card, its plain version :func:`ant_rollout_plain` (the JAX body, step
for step on the batch) on the CPU. J2 walks a complete tree without the
stack, through a successor table. The host simulator is
:mod:`deap_tpu_torch.native.ant_binding`, which a caller picks.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from deap_tpu_torch import _build
from deap_tpu_torch.gp.pset import PrimitiveSet
from deap_tpu_torch.gp.tree import subtree_ends_all

# The Santa Fe trail (Koza 1992): 32×32 torus, 89 food cells, start at
# the S corner facing east (row 25's stray space read as an empty cell).
SANTA_FE_TRAIL = """\
S###............................
...#............................
...#.....................###....
...#....................#....#..
...#....................#....#..
...####.#####........##.........
............#................#..
............#.......#...........
............#.......#........#..
............#.......#...........
....................#...........
............#................#..
............#...................
............#.......#.....###...
............#.......#..#........
.................#..............
................................
............#...........#.......
............#...#..........#....
............#...#...............
............#...#...............
............#...#.........#.....
............#..........#........
............#...................
...##..#####....#...............
.#..............#...............
.#..............#...............
.#......#######.................
.#.....#........................
.......#........................
..####..........................
................................"""

# op ids by registration order in ant_pset()
IF_FOOD_AHEAD, PROG2, PROG3 = 0, 1, 2
MOVE_FORWARD, TURN_LEFT, TURN_RIGHT = 0, 1, 2   # terminal action codes

# direction vectors indexed north/east/south/west
_DIR_ROW = (1, 0, -1, 0)
_DIR_COL = (0, 1, 0, -1)

#: J2's limits: genome width (``kMaxLen``) and trail words, 32 cells a
#: word a row piece (``kMaxWords`` in csrc/ant_rollout.cu)
J2_MAX_LEN = 256
J2_MAX_WORDS = 128


def _walk_ends_all(nodes: torch.Tensor) -> torch.Tensor:
    """The subtree ends of every tree as J2's right-to-left pass makes
    them, ``int64[n, L]`` (``nodes`` int64 ids of :func:`ant_pset`): the
    JAX evaluator's rule (``deap_tpu/gp/tree.py::subtree_end`` at every
    slot), the first slot ``j >= i`` where the arity walk from ``i``
    closes, plus 1, over the whole width, and 1 where it never closes;
    the length plays no part."""
    n, L = nodes.shape
    arity = ant_pset().arity_table(nodes.device)
    ends = subtree_ends_all(nodes, torch.full((n,), L, dtype=torch.int64,
                                              device=nodes.device), arity)
    cs = (arity[nodes] - 1).cumsum(1)
    prev = torch.cat([torch.zeros((n, 1), dtype=cs.dtype,
                                  device=nodes.device), cs[:, :-1]], 1)
    closed = cs.gather(1, ends - 1) <= prev - 1
    return torch.where(closed, ends, 1)


def ant_pset() -> PrimitiveSet:
    """The ant vocabulary: if_food_ahead(2), prog2(2), prog3(3);
    terminals move_forward / turn_left / turn_right. The primitive fns
    are placeholders: ant trees run through :func:`ant_rollout`, never the
    data-flow interpreter."""
    ps = PrimitiveSet("ANT", 0)
    dummy2 = lambda a, b: a
    dummy3 = lambda a, b, c: a
    ps.add_primitive(dummy2, 2, "if_food_ahead")
    ps.add_primitive(dummy2, 2, "prog2")
    ps.add_primitive(dummy3, 3, "prog3")
    ps.add_terminal(float(MOVE_FORWARD), "move_forward")
    ps.add_terminal(float(TURN_LEFT), "turn_left")
    ps.add_terminal(float(TURN_RIGHT), "turn_right")
    return ps


def parse_trail(text: str = SANTA_FE_TRAIL,
                ) -> Tuple[np.ndarray, Tuple[int, int]]:
    """Trail text → (bool food grid [R, C], start (row, col)). ``#`` is
    food, ``S`` the start cell (empty), anything else empty."""
    lines = text.splitlines()
    rows, cols = len(lines), max(len(l) for l in lines)
    grid = np.zeros((rows, cols), bool)
    start = (0, 0)
    for i, line in enumerate(lines):
        for j, ch in enumerate(line):
            if ch == "#":
                grid[i, j] = True
            elif ch == "S":
                start = (i, j)
    return grid, start


def _put(stack, pos, val, cond):
    """``stack[t, pos[t]] = val[t]`` where ``cond`` and the slot exists
    (a push past the stack is dropped, as XLA's scatter drops it)."""
    W = stack.shape[1]
    cond = cond & (pos < W)
    idx = pos.clamp(0, W - 1)[:, None]
    cur = stack.gather(1, idx)
    return stack.scatter(1, idx, torch.where(cond[:, None], val[:, None],
                                             cur))


def ant_rollout_plain(nodes: torch.Tensor, length: torch.Tensor,
                      trail: torch.Tensor, start: Tuple[int, int],
                      max_moves: int, max_steps: int, start_dir: int = 1
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`ant_rollout`: the JAX body, one step
    of every ant at a time, the finished ants' states kept, on the JAX
    evaluator's subtree ends (:func:`_walk_ends_all`; ``length``
    unread).
    Returns ``(eaten int32[pop], steps int32[pop])``."""
    n, L = nodes.shape
    dev = nodes.device
    R, C = trail.shape
    nodes = nodes.to(torch.int64)
    ends = _walk_ends_all(nodes)
    dir_row = torch.tensor(_DIR_ROW, device=dev)
    dir_col = torch.tensor(_DIR_COL, device=dev)
    ants = torch.arange(n, device=dev)
    stack = torch.zeros((n, L + 3), dtype=torch.int64, device=dev)
    grid = trail.to(device=dev, dtype=torch.bool).expand(n, R, C).clone()
    z = lambda v: torch.full((n,), v, dtype=torch.int64, device=dev)
    sp, row, col, d = z(0), z(start[0]), z(start[1]), z(start_dir)
    moves, eaten, steps = z(0), z(0), z(0)
    t = 0
    while True:
        active = (moves < max_moves) & (steps < max_steps)
        # a read to the host every 16 steps: a finished ant's step is a
        # no-op, so the extra steps change nothing
        if t % 16 == 0 and not bool(active.any()):
            break
        t += 1
        restart = active & (sp == 0)
        stack[:, 0] = torch.where(restart, 0, stack[:, 0])
        sp1 = torch.where(restart, 1, sp)
        node_idx = stack.gather(1, (sp1 - 1).clamp(0, L + 2)[:, None])[:, 0]
        node = nodes.gather(1, node_idx.clamp(0, L - 1)[:, None])[:, 0]
        sp1 = sp1 - 1
        is_op = node < 3
        action = torch.where(is_op, -1, node - 3)
        c1 = node_idx + 1
        c2 = ends.gather(1, c1.clamp_max(L - 1)[:, None])[:, 0]
        c3 = ends.gather(1, c2.clamp_max(L - 1)[:, None])[:, 0]
        food = grid[ants, (row + dir_row[d]) % R, (col + dir_col[d]) % C]
        chosen = torch.where(food, c1, c2)
        push_if = active & is_op & (node == IF_FOOD_AHEAD)
        push23 = active & is_op & (node != IF_FOOD_AHEAD)
        push3 = active & is_op & (node == PROG3)
        stack = _put(stack, sp1, c3, push3)
        sp3 = sp1 + push3
        stack = _put(stack, sp3, c2, push23)
        sp2 = sp3 + push23
        stack = _put(stack, sp2, torch.where(push23, c1, chosen),
                     push23 | push_if)
        sp1 = sp2 + (push23 | push_if)
        can = active & ~is_op & (moves < max_moves)
        d = torch.where(can & (action == TURN_LEFT), (d - 1) % 4,
                        torch.where(can & (action == TURN_RIGHT),
                                    (d + 1) % 4, d))
        fwd = can & (action == MOVE_FORWARD)
        row = torch.where(fwd, (row + dir_row[d]) % R, row)
        col = torch.where(fwd, (col + dir_col[d]) % C, col)
        ate = fwd & grid[ants, row, col]
        grid[ants, row, col] &= ~ate
        eaten = eaten + ate
        moves = moves + can
        sp = torch.where(active, sp1, sp)
        steps = steps + active
    return eaten.to(torch.int32), steps.to(torch.int32)


def pack_trail(trail: torch.Tensor) -> torch.Tensor:
    """A bool trail ``[R, C]`` as J2's bitmask, ``int32[R, ceil(C/32)]``:
    cell ``(r, c)`` is bit ``c % 32`` of word ``(r, c // 32)``."""
    R, C = trail.shape
    wpr = -(-C // 32)
    cells = torch.zeros((R, wpr * 32), dtype=torch.int64, device=trail.device)
    cells[:, :C] = trail
    words = (cells.view(R, wpr, 32)
             << torch.arange(32, device=trail.device)).sum(-1)
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(
        torch.int32)


def _check_card_args(nodes, length, trail, max_moves, max_steps):
    """J2's ``ValueError``s for a call on the card."""
    if nodes.device.type != "cuda":
        raise ValueError(f"no kernel for device {nodes.device}")
    pop, L = nodes.shape
    R, C = trail.shape
    if nodes.dtype != torch.int32 or length.dtype != torch.int32 or \
            trail.dtype != torch.bool:
        raise ValueError("nodes and length must be int32, trail bool")
    if length.shape != (pop,) or length.device != nodes.device or \
            trail.device != nodes.device:
        raise ValueError("length must be [pop] and every tensor on one card")
    if L > J2_MAX_LEN or R * -(-C // 32) > J2_MAX_WORDS:
        raise ValueError(f"J2 takes genomes up to width {J2_MAX_LEN} and "
                         f"trails up to {J2_MAX_WORDS} words, got width {L} "
                         f"and a {R}x{C} trail")
    if not (0 <= max_steps < 2 ** 31 and 0 <= max_moves < 2 ** 31):
        raise ValueError("max_moves and max_steps must fit an int32")


def _launch(nodes, trail, start, max_moves, max_steps, start_dir, words,
            iterations=None, table=None):
    """One launch of J2 on checked arguments: ``(eaten, steps)``, and the
    walk's iterations and table where their outputs are given."""
    pop, L = nodes.shape
    R, C = trail.shape
    eaten = torch.empty(pop, dtype=torch.int32, device=nodes.device)
    steps = torch.empty(pop, dtype=torch.int32, device=nodes.device)
    if pop == 0:
        return eaten, steps
    if words is None:
        words = pack_trail(trail)
    elif (words.dtype != torch.int32 or words.device != nodes.device
          or words.shape != (R, -(-C // 32))):
        raise ValueError("words must be pack_trail(trail) on the card")
    nodes = nodes.contiguous()
    stream = torch.cuda.current_stream(nodes.device).cuda_stream
    PT, I = _build.PTR, _build.INT
    fn = _build.function("ant_rollout", "ant_rollout",
                         [PT, PT] + [I] * 9 + [PT] * 5)
    err = fn(nodes.data_ptr(), words.data_ptr(), pop, L,
             R, C, max_moves, max_steps, int(start[0]), int(start[1]),
             start_dir, eaten.data_ptr(), steps.data_ptr(),
             None if iterations is None else iterations.data_ptr(),
             None if table is None else table.data_ptr(), stream)
    ant_rollout.launches += 1
    _build.check("ant_rollout", err, "ant_rollout")
    return eaten, steps


def ant_rollout(nodes: torch.Tensor, length: torch.Tensor,
                trail: torch.Tensor, start: Tuple[int, int], max_moves: int,
                max_steps: int, start_dir: int = 1,
                words: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Food eaten by each ant tree (J2): ``(eaten int32[pop], steps
    int32[pop])``, the steps each rollout ran.

    On the card one launch runs every rollout, one thread an ant: a
    complete tree walks its successor table, one
    ``if_food_ahead`` or action an iteration, any other tree the stack; on
    a CPU tensor :func:`ant_rollout_plain` runs. Both are integer
    arithmetic and agree bit for bit. The wrapper's ``launches`` counts
    the launches.

    :param nodes: ``int32[pop, L]`` prefix trees of :func:`ant_pset`,
        ``L <= J2_MAX_LEN`` on the card.
    :param length: ``int32[pop]``, which no walk reads: as the JAX
        evaluator's, the rollout walks the root's subtree over the whole
        width (the native simulator's subtree searches stop at the length,
        so it agrees only on trees whose length is the root's end).
    :param trail: ``bool[R, C]`` food map on the nodes' device.
    :param start: ``(row, col)`` start cell; ``start_dir`` 0-3 (north,
        east, south, west).
    :param words: ``pack_trail(trail)``, when the caller keeps it (the
        wrapper packs the trail otherwise, a few small launches).
    """
    if nodes.device.type == "cpu":
        return ant_rollout_plain(nodes, length, trail, start, max_moves,
                                 max_steps, start_dir)
    _check_card_args(nodes, length, trail, max_moves, max_steps)
    return _launch(nodes, trail, start, max_moves, max_steps, start_dir,
                   words)


ant_rollout.launches = 0


def ant_rollout_traced(nodes: torch.Tensor, length: torch.Tensor,
                       trail: torch.Tensor, start: Tuple[int, int],
                       max_moves: int, max_steps: int, start_dir: int = 1,
                       words: Optional[torch.Tensor] = None):
    """:func:`ant_rollout` with what its walk did, on the card only:
    ``(eaten, steps, iterations, table)`` from J2's one launch (counted
    in ``ant_rollout.launches``). ``iterations int32[pop]`` are the walk's
    loop trips (one an ``if`` or action, or one a step on the stack);
    ``table int32[pop, L + 1, 2]`` is each tree's successor table. Entry
    ``s`` of an ``if_food_ahead`` or action slot of a complete tree holds
    ``x = target | fold << 8 | kind << 16`` (kind 0 ``if_food_ahead``,
    1-3 the actions) and ``y = target | fold << 8``: an ``if`` goes to
    ``x``'s pair with food ahead and to ``y``'s without, an action to
    ``x``'s pair, equal to ``y``'s. A target is the first slot that is
    not a ``prog``, its fold the ``prog`` slots skipped on the way. Row
    ``L`` holds the root's pair and 1; every other entry is 0, and all
    of a tree that J2 walks on the stack."""
    _check_card_args(nodes, length, trail, max_moves, max_steps)
    pop, L = nodes.shape
    iterations = torch.empty(pop, dtype=torch.int32, device=nodes.device)
    table = torch.empty((pop, L + 1, 2), dtype=torch.int32,
                        device=nodes.device)
    eaten, steps = _launch(nodes, trail, start, max_moves, max_steps,
                           start_dir, words, iterations, table)
    return eaten, steps, iterations, table


def make_ant_evaluator(pset: PrimitiveSet, max_len: int,
                       trail: np.ndarray, start: Tuple[int, int],
                       max_moves: int = 600,
                       start_dir: int = 1) -> Callable:
    """Build ``evaluate(genomes) -> f32[pop]``, the food each tree eats.
    Unlike the JAX package's one-genome function (vmapped there), it takes
    a population (``nodes [pop, L]``, ``length [pop]``): torch has no
    ``vmap`` here, and :func:`ant_rollout` runs the batch in one launch on
    the card (its plain version on a CPU tensor). Actions spend a move
    while ``moves < max_moves``; eaten cells are cleared; the routine
    restarts from the root whenever it completes; at most ``max_moves ·
    max_len + max_len`` nodes run."""
    if (pset.n_ops, pset.n_args, pset.n_consts) != (3, 0, 3):
        raise ValueError("the ant evaluator runs trees of ant_pset()")
    max_steps = max_moves * max_len + max_len
    trails = {}

    def evaluate(genomes) -> torch.Tensor:
        nodes = genomes["nodes"]
        dev = nodes.device
        if dev not in trails:
            grid = torch.as_tensor(np.asarray(trail, bool), device=dev)
            trails[dev] = grid, pack_trail(grid)
        grid, words = trails[dev]
        eaten, _ = ant_rollout(nodes.to(torch.int32),
                               genomes["length"].to(torch.int32), grid,
                               start, max_moves, max_steps, start_dir,
                               words)
        return eaten.to(torch.float32)

    return evaluate
