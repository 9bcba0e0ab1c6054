"""Batched GP evaluation over prefix arrays.

Port of :mod:`deap_tpu.gp.interpreter`. Three modes give bit-identical
predictions ``f32[n, points]`` for a population of trees:

- ``'scan'`` (:func:`run_data_pass`): slots right to left, each slot of
  every tree at once, the primitives of the live vocabulary evaluated on
  the slot's operand rows and the node id selecting the row. Children sit
  at higher slots than their parent in prefix order, so one pass suffices.
- ``'sweep'`` (:func:`run_sweep_pass`): every slot re-evaluated in
  parallel ``max height + 1`` times.
- ``'grouped'``: opcode-major. The host compiles the (deduplicated)
  population into a schedule (:func:`build_grouped_schedule`): every live
  operator slot becomes one instruction, sorted by ``(depth desc,
  opcode)`` and padded so every ``chunk``-row block applies ONE primitive.
  The schedule is evaluated by :func:`deap_tpu_torch.ops.kernels.
  gp_grouped_dispatch` (K9): the CUDA kernel on the card, one launch per
  evaluation that carries the depth levels' order itself; its plain chunk
  loop on the CPU.

The scan and sweep modes are the bitwise oracles the tests pin the
grouped mode to. ``specialize='auto'`` restricts the select chain to the
primitives the population uses (a monotone union over calls, as in the
JAX package; masking never changes a result), and ``dedup`` evaluates each
distinct live prefix once. Nothing is compiled, so unlike the JAX package
no size is rounded up to bound recompiles, except the grouped schedule's
chunk count, whose arrays the tests hold equal to the JAX package's.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from deap_tpu_torch.gp.pset import IDENTITY, PrimitiveSet
from deap_tpu_torch.gp.tree import prefix_depths, subtree_ends_all
from deap_tpu_torch import tuning
from deap_tpu_torch.ops import kernels
from deap_tpu_torch.telemetry import costs
from deap_tpu_torch.telemetry.journal import broadcast

#: instruction-block size of ``mode='grouped'``: every chunk is
#: single-opcode
DEFAULT_CHUNK = 128

MODES = ("scan", "sweep", "grouped")


def child_table(nodes: torch.Tensor, length: torch.Tensor,
                arity: torch.Tensor, max_ar: int) -> torch.Tensor:
    """Child-slot table ``int64[n, ML, max_ar]``: entry ``[t, slot, i]``
    is the slot of operand ``i`` of the node at ``slot`` of tree ``t``
    (garbage, never referenced, for terminals and padding): the first
    child is ``slot+1``, each next sibling starts where the previous
    child's subtree ends."""
    n, ML = nodes.shape
    ends = subtree_ends_all(nodes, length, arity)
    child = (torch.arange(ML, device=nodes.device) + 1).clamp_max(
        ML - 1).expand(n, ML)
    cols = []
    for _ in range(max_ar):
        cols.append(child)
        child = ends.gather(1, child).clamp_max(ML - 1)
    return torch.stack(cols, 2)


def _prim_rows(pset: PrimitiveSet,
               mask: Optional[Sequence[int]] = None) -> Callable:
    """``prim_rows(ops_in, node) -> [(node_id, row), ...]`` over the
    primitives of ``mask`` (live opcode ids; ``None``: the whole set);
    the slot's node ids ``node`` are not needed here."""
    ids = range(pset.n_ops) if mask is None else sorted(mask)
    prims = [(i, pset.primitives[i]) for i in ids]

    def prim_rows(ops_in, node=None):
        return [(i, p.fn(*ops_in[:p.arity])) for i, p in prims]

    return prim_rows


def _prepare(pset, max_len, genomes, X):
    nodes, consts, length = (genomes["nodes"], genomes["consts"],
                             genomes["length"])
    # only the first min(width, max_len) slots can hold real nodes
    ML = min(nodes.shape[1], max_len)
    arity = pset.arity_table(nodes.device)
    C = child_table(nodes[:, :ML], length, arity, max(pset.max_arity, 1))
    # the argument rows, [n_args, P] (or [n_args, n, P] for per-tree X)
    return (nodes[:, :ML], consts[:, :ML], length, C,
            X.movedim(-1, 0).to(torch.float32))


def run_data_pass(pset: PrimitiveSet, max_len: int, genomes, X,
                  prim_rows: Callable, max_active: Optional[int] = None
                  ) -> torch.Tensor:
    """Scan-mode evaluation of every tree: fill ``out[n, ML, P]`` slot by
    slot from the right, children before parents. ``max_active`` (>= every
    tree's length) bounds the pass to the live prefix. ``X`` is
    ``f32[P, n_args]``, or ``f32[n, P, n_args]`` to give each tree its own
    points (an ADF call's operands). ``prim_rows(ops_in, node)`` gets the
    slot's node ids too, so it may leave out a row no tree selects.
    Returns the roots' rows ``f32[n, P]``."""
    nodes, consts, length, C, argsT = _prepare(pset, max_len, genomes, X)
    n, ML = nodes.shape
    P = X.shape[-2]
    const_row = pset.n_ops + pset.n_args
    rows_of = torch.arange(n, device=nodes.device)
    out = torch.zeros((n, ML, P), dtype=torch.float32, device=nodes.device)
    T = ML if max_active is None else max_active
    for rt in range(T - 1, -1, -1):
        # padded slots act as inert constants
        node = torch.where(rt < length, nodes[:, rt], const_row)
        ops_in = [out[rows_of, C[:, rt, i]] for i in range(C.shape[2])]
        rows = prim_rows(ops_in, node) + [(pset.n_ops + j, a)
                                          for j, a in enumerate(argsT)]
        # every constant-family id shares the one constant row
        row = node.clamp_max(const_row)[:, None]
        res = consts[:, rt, None].expand(n, P)
        for nid, r in rows:
            res = torch.where(row == nid, r, res)
        out[:, rt] = res
    return out[:, 0]


def run_sweep_pass(pset: PrimitiveSet, max_len: int, genomes, X,
                   prim_rows: Callable, n_sweeps: int) -> torch.Tensor:
    """Sweep-mode evaluation: every slot of every tree re-evaluated in
    parallel ``n_sweeps`` times; after ``s`` sweeps every node of height
    ``< s`` holds its final value. Returns ``f32[n, P]``."""
    nodes, consts, length, C, argsT = _prepare(pset, max_len, genomes, X)
    n, ML = nodes.shape
    P = X.shape[0]
    const_row = pset.n_ops + pset.n_args
    live = torch.arange(ML, device=nodes.device) < length[:, None]
    row = torch.where(live, nodes, const_row).clamp_max(const_row)[:, :, None]
    const_plane = consts[:, :, None].expand(n, ML, P)
    out = torch.zeros((n, ML, P), dtype=torch.float32, device=nodes.device)
    for _ in range(n_sweeps):
        ops_in = [out.gather(1, C[:, :, i, None].expand(n, ML, P))
                  for i in range(C.shape[2])]
        rows = prim_rows(ops_in) + [(pset.n_ops + j, a)
                                    for j, a in enumerate(argsT)]
        res = const_plane
        for nid, r in rows:
            res = torch.where(row == nid, r, res)
        out = res
    return out[:, 0]


def make_interpreter(pset: PrimitiveSet, max_len: int) -> Callable:
    """``evaluate(genome, X) -> f32[points]`` for one tree (``nodes [L]``,
    ``consts [L]``, ``length`` scalar); ``X`` is ``f32[points, n_args]``."""
    prim_rows = _prim_rows(pset)

    def interpret(genome, X):
        batch = {k: torch.as_tensor(v).reshape(1, -1)
                 for k, v in genome.items()}
        batch["length"] = batch["length"].reshape(1)
        return run_data_pass(pset, max_len, batch, X, prim_rows)[0]

    return interpret


# ---------------------------------------------------------- size lattices ----

def _round_size(n: int, floor: int = 8) -> int:
    """Round ``n`` up on the geometric lattice {pow2, 0.75·pow2}."""
    n = max(int(n), 1)
    if n <= floor:
        return floor
    p = 1 << (n - 1).bit_length()
    if (3 * p) // 4 >= n:
        return (3 * p) // 4
    return p


def _round_chunks(n: int) -> int:
    """Chunk-count lattice: powers of two, floor 8."""
    n = max(int(n), 1)
    return max(8, 1 << (n - 1).bit_length())


def compact_indices(mask: torch.Tensor, cap: int):
    """Prefix-sum compaction with ``np.resize`` pad semantics, on the
    tensor's device: the indices of the True rows packed into the front
    of a ``cap``-long buffer, the tail filled by cycling them (``out[k] =
    idx[k % count]``), all zeros when ``count == 0``.

    :returns: ``(idx int32[cap], count int32)``.
    """
    inc = mask.to(torch.int64).cumsum(0)
    count = (inc[-1] if mask.shape[0]
             else torch.zeros((), dtype=torch.int64, device=mask.device))
    k = torch.arange(cap, device=mask.device)
    packed = torch.searchsorted(inc, k + 1, side="left")
    cyc = k % count.clamp_min(1)
    out = torch.where(k < count, packed,
                      packed[cyc.clamp_max(max(cap - 1, 0))])
    return (torch.where(count > 0, out, 0).to(torch.int32),
            count.to(torch.int32))


# --------------------------------------------------- host schedule pieces ----

def _used_ops(n_ops: int, nodes: np.ndarray, length: np.ndarray
              ) -> Tuple[int, ...]:
    """The population's live opcode set, read from host arrays."""
    live = np.arange(nodes.shape[1])[None, :] < length[:, None]
    ids = nodes[live]
    return tuple(np.unique(ids[ids < n_ops]).tolist())


def _dedup_rows(nodes: np.ndarray, consts: np.ndarray, length: np.ndarray
                ) -> Tuple[np.ndarray, np.ndarray]:
    """(first_indices, inverse) over byte-identical live prefixes —
    padding slots are normalised out so two genomes equal on their live
    prefix dedup together even when their padding differs."""
    live = np.arange(nodes.shape[1])[None, :] < length[:, None]
    nn = np.where(live, nodes, -1).astype(np.int32)
    cc = np.where(live, consts, 0.0).astype(np.float32)
    blob = np.ascontiguousarray(np.concatenate([nn, cc.view(np.int32)], 1))
    seen: dict = {}
    inv = np.empty(len(blob), np.int64)
    first = []
    for i, row in enumerate(blob):
        b = row.tobytes()
        j = seen.get(b)
        if j is None:
            seen[b] = j = len(first)
            first.append(i)
        inv[i] = j
    return np.asarray(first, np.int64), inv


def _ends_np(nodes: np.ndarray, length: np.ndarray,
             arity: np.ndarray) -> np.ndarray:
    """:func:`deap_tpu_torch.gp.tree.subtree_ends_all` in numpy, for the
    host schedule builder."""
    pop, L = nodes.shape
    live = np.arange(L)[None, :] < length[:, None]
    deficit = np.where(live, arity[nodes] - 1, 0).astype(np.int64)
    cs = np.cumsum(deficit, axis=1)
    prev = np.concatenate(
        [np.zeros((pop, 1), cs.dtype), cs[:, :-1]], axis=1)
    NEG = -(2 ** 30)
    levels = [cs]
    k = 1
    while k < L:
        m = levels[-1]
        shifted = np.concatenate(
            [m[:, k:], np.full((pop, k), NEG, cs.dtype)], axis=1)
        levels.append(np.minimum(m, shifted))
        k *= 2
    target = prev - 1
    rows = np.arange(pop)[:, None]
    pos = np.broadcast_to(np.arange(L), (pop, L)).copy()
    for lev in reversed(range(len(levels))):
        step = 1 << lev
        block_min = np.where(
            pos < L, levels[lev][rows, np.minimum(pos, L - 1)], NEG)
        pos = np.where(block_min > target, pos + step, pos)
    return (np.minimum(pos, L - 1) + 1).astype(np.int32)


def _depths_np(ends: np.ndarray, length: np.ndarray) -> np.ndarray:
    """:func:`deap_tpu_torch.gp.tree.prefix_depths` in numpy, given the
    ends: ``depth[j] = j − #{live i : end_i ≤ j}``."""
    pop, L = ends.shape
    live = np.arange(L)[None, :] < length[:, None]
    rows = np.broadcast_to(np.arange(pop)[:, None], (pop, L))
    hist = np.zeros((pop, L + 1), np.int32)
    np.add.at(hist, (rows, np.clip(np.where(live, ends, L), 0, L)),
              live.astype(np.int32))
    closed_by = np.cumsum(hist, axis=1)[:, :-1]
    return (np.arange(L)[None, :] - closed_by).astype(np.int32)


def build_grouped_schedule(pset: PrimitiveSet, nodes: np.ndarray,
                           consts: np.ndarray, length: np.ndarray,
                           ends: np.ndarray, depths: np.ndarray,
                           mask: Sequence[int], chunk: int) -> dict:
    """Compile a population (host arrays) into an opcode-major schedule.

    Every live operator slot becomes one instruction; instructions are
    sorted by ``(depth desc, opcode)`` and each ``(depth, opcode)`` run is
    padded to a multiple of ``chunk`` so every chunk is single-opcode.
    Operands reference the value buffer: rows ``0..n_args-1`` hold the
    arguments, row ``n_args + position`` instruction ``position``'s
    result; constant operands are inlined. The chunk count is rounded up
    on :func:`_round_chunks`; pad chunks run branch 0 on argument row 0.

    The arrays are the JAX package's, bit for bit. ``level_starts`` is
    the port's own: the chunk where each depth level starts, then
    ``nchunks``. Children are strictly deeper than their parents, so a
    level reads only argument rows and rows of earlier levels (the pad
    chunks read row 0 and join the last level).
    """
    n_ops, n_args = pset.n_ops, pset.n_args
    max_ar = max(pset.max_arity, 1)
    const_id = pset.const_id
    pop, ML = nodes.shape
    branch_of = {op: b for b, op in enumerate(mask)}

    live = np.arange(ML)[None, :] < length[:, None]
    is_op = live & (nodes < n_ops)
    ti, si = np.nonzero(is_op)
    opc = nodes[ti, si]
    dep = depths[ti, si]
    order = np.lexsort((opc, -dep))
    ti, si, opc, dep = ti[order], si[order], opc[order], dep[order]
    ni = len(ti)

    if ni:
        grp = np.empty(ni, np.int64)
        grp[0] = 0
        grp[1:] = np.cumsum((dep[1:] != dep[:-1]) | (opc[1:] != opc[:-1]))
        counts = np.bincount(grp)
        padded = -(-counts // chunk) * chunk
        offs = np.concatenate([[0], np.cumsum(padded)])
        group_first = np.concatenate([[0], np.cumsum(counts)])
        within = np.arange(ni) - group_first[grp]
        posn = offs[grp] + within
        nchunks = int(offs[-1]) // chunk
        gdep = dep[group_first[:-1]]
        new_level = np.concatenate([[True], gdep[1:] != gdep[:-1]])
        level_starts = (offs[:-1][new_level] // chunk).tolist()
    else:
        posn = np.zeros(0, np.int64)
        nchunks = 0
        level_starts = [0]
    nchunks = _round_chunks(nchunks)
    level_starts = [int(s) for s in level_starts] + [nchunks]
    total = nchunks * chunk

    # value-row index per (tree, slot): op slots -> n_args + position,
    # argument slots -> their argument row; constants stay inline
    val_row = np.zeros((pop, ML), np.int32)
    val_row[ti, si] = n_args + posn
    arg_sites = live & (nodes >= n_ops) & (nodes < const_id)
    val_row[arg_sites] = nodes[arg_sites] - n_ops
    const_sites = live & (nodes >= const_id)

    chunk_ops = np.zeros(nchunks, np.int32)
    if ni:
        chunk_ops[posn // chunk] = np.vectorize(branch_of.get)(opc)

    src_idx = np.zeros((total, max_ar), np.int32)
    src_const = np.zeros((total, max_ar), np.float32)
    src_isc = np.zeros((total, max_ar), bool)
    if ni:
        # children: first child = slot+1, next siblings at subtree ends
        child = np.minimum(si + 1, ML - 1)
        for j in range(max_ar):
            cc = const_sites[ti, child]
            src_idx[posn, j] = val_row[ti, child]
            src_isc[posn, j] = cc
            src_const[posn, j] = np.where(cc, consts[ti, child], 0.0)
            child = np.minimum(ends[ti, child], ML - 1)

    root_live = length > 0
    root_idx = val_row[:, 0].astype(np.int32)
    root_isc = const_sites[:, 0] | ~root_live
    root_const = np.where(root_live, consts[:, 0], 0.0).astype(np.float32)
    return {
        "chunk_ops": chunk_ops, "src_idx": src_idx,
        "src_const": src_const, "src_isc": src_isc,
        "root_idx": root_idx, "root_const": root_const,
        "root_isc": root_isc, "n_instructions": ni, "nchunks": nchunks,
        "level_starts": level_starts,
    }


# --------------------------------------------------------- batch dispatch ----

class BatchInterpreter:
    """``interp(genomes, X) -> f32[n, points]`` over a population; see
    :func:`make_batch_interpreter`.

    ``interp.unique(genomes, X) -> (preds, inverse)`` skips the un-dedup
    expansion: ``preds`` has a row per distinct tree, ``inverse`` maps
    each tree to its row (``None`` when nothing was deduplicated).
    ``interp.levels_run`` counts the depth levels the grouped evaluator
    was given, summed over its calls (K9 launches once per call on the
    card and evaluates the levels in order inside the launch);
    ``interp.schedule(genomes)`` is the host half of the grouped mode.
    ``interp.grouped_dispatch`` is the grouped evaluator it calls,
    :func:`deap_tpu_torch.ops.kernels.gp_grouped_dispatch` unless a
    caller swaps in the plain version to compare the two.
    """

    def __init__(self, pset: PrimitiveSet, max_len: int, mode: str,
                 specialize: str, dedup: bool, points_tile: Optional[int],
                 chunk: int):
        self.pset, self.max_len, self.mode = pset, max_len, mode
        self.specialize, self.dedup = specialize, dedup
        self.points_tile, self.chunk = points_tile, chunk
        self.mask: Tuple[int, ...] = ()
        self.levels_run = 0
        self.grouped_dispatch = kernels.gp_grouped_dispatch
        self._journaled = None
        # the program observatory profiles evaluations under the gp_mode
        # knob's program label
        self.unique = costs.instrument(self._unique, "gp_interpreter")

    def _journal(self, extra: dict) -> None:
        """A ``gp_dispatch`` event to the open journals whenever the live
        mask or the dispatch's shape changes (as the JAX package's
        dispatcher journals; ``n_lanes`` 1: one population)."""
        tag = (self.mask,) + tuple(sorted(extra.items()))
        if self._journaled != tag:
            self._journaled = tag
            broadcast("gp_dispatch", mode=self.mode,
                      mask=[self.pset.primitives[i].name for i in self.mask],
                      mask_popcount=len(self.mask), n_lanes=1, **extra)

    def __call__(self, genomes, X) -> torch.Tensor:
        preds, inv = self.unique(genomes, X)
        return preds if inv is None else preds[inv]

    def _tiles(self, X):
        return X.split(self.points_tile) if self.points_tile else (X,)

    def _traced(self, genomes, X, mask) -> torch.Tensor:
        """Scan or sweep over the live prefix (grouped mode without
        specialisation takes the scan, as in the JAX package)."""
        prim_rows = _prim_rows(self.pset, mask)
        ML = min(genomes["nodes"].shape[1], self.max_len)
        T = int(genomes["length"].amax().clamp(1, ML)) if \
            genomes["length"].numel() else 1
        if self.mode == "sweep":
            arity = self.pset.arity_table(genomes["nodes"].device)
            d = prefix_depths(genomes["nodes"][:, :ML], genomes["length"],
                              arity)
            live = torch.arange(ML, device=d.device) < \
                genomes["length"][:, None]
            D = int(torch.where(live, d, 0).amax()) + 1 if live.numel() \
                else 1
            D = min(max(D, 1), T)
            run = lambda Xt: run_sweep_pass(self.pset, self.max_len,
                                            genomes, Xt, prim_rows, D)
        else:
            run = lambda Xt: run_data_pass(self.pset, self.max_len,
                                           genomes, Xt, prim_rows, T)
        return torch.cat([run(Xt) for Xt in self._tiles(X)], 1)

    @property
    def branches(self):
        """The grouped evaluator's branches: the primitives of the live
        mask, or the identity when only terminals are live."""
        return [self.pset.primitives[op] for op in self.mask] or [IDENTITY]

    def _read(self, genomes):
        """Read the genomes to the host, widen the live mask, dedup."""
        nodes = genomes["nodes"][:, :self.max_len].cpu().numpy()
        consts = genomes["consts"][:, :self.max_len].cpu().numpy()
        length = genomes["length"].cpu().numpy()
        used = _used_ops(self.pset.n_ops, nodes, length)
        self.mask = tuple(sorted(set(self.mask) | set(used)))
        first = inv = None
        if self.dedup:
            first, inv = _dedup_rows(nodes, consts, length)
        return nodes, consts, length, first, inv

    def schedule(self, genomes):
        """The host half of the grouped mode: ``(sched, inverse)``, the
        :func:`build_grouped_schedule` of the distinct trees (all trees
        without dedup, ``inverse`` then ``None``)."""
        with record_function("gp/host_schedule"):
            nodes, consts, length, first, inv = self._read(genomes)
            if first is not None:
                nodes, consts, length = (nodes[first], consts[first],
                                         length[first])
            arity = np.asarray(self.pset.arity_list() + [0], np.int32)
            ends = _ends_np(nodes, length, arity)
            depths = _depths_np(ends, length)
            sched = build_grouped_schedule(self.pset, nodes, consts, length,
                                           ends, depths, self.mask,
                                           self.chunk)
        return sched, inv

    def _grouped(self, sched: dict, X) -> torch.Tensor:
        n_args, dev = self.pset.n_args, X.device
        with record_function("gp/schedule_upload"):
            args = [torch.from_numpy(sched[k]).to(dev) for k in
                    ("chunk_ops", "src_idx", "src_const", "src_isc")]
            root_idx = torch.from_numpy(sched["root_idx"]).to(dev)
            root_isc = torch.from_numpy(sched["root_isc"]).to(dev)[:, None]
            root_const = torch.from_numpy(sched["root_const"]).to(dev)[
                :, None]
        nrows = n_args + sched["nchunks"] * self.chunk
        preds = []
        for Xt in self._tiles(X):
            buf = torch.zeros((nrows, Xt.shape[0]), dtype=torch.float32,
                              device=dev)
            buf[:n_args] = Xt.T
            with record_function("gp/grouped_dispatch"):
                self.grouped_dispatch(buf, *args, self.branches,
                                      chunk=self.chunk, n_args=n_args,
                                      levels=sched["level_starts"])
            self.levels_run += len(sched["level_starts"]) - 1
            preds.append(torch.where(root_isc, root_const, buf[root_idx]))
        return torch.cat(preds, 1)

    def _unique(self, genomes, X):
        X = X.to(torch.float32)
        if self.specialize == "none":
            return self._traced(genomes, X, None), None
        pop = genomes["length"].shape[0]
        if self.mode == "grouped":
            sched, inv = self.schedule(genomes)
            self._journal({"nchunks": sched["nchunks"],
                           "n_unique": len(sched["root_idx"])})
            preds = self._grouped(sched, X)
        else:
            with record_function("gp/host_read"):
                _, _, _, first, inv = self._read(genomes)
            self._journal({"n_unique": len(first) if first is not None
                           else pop})
            if first is not None:
                sel = torch.from_numpy(first).to(genomes["nodes"].device)
                genomes = {k: v[sel] for k, v in genomes.items()}
            preds = self._traced(genomes, X, self.mask)
        if inv is None:
            return preds, None
        return preds, torch.from_numpy(inv).to(preds.device)


def make_batch_interpreter(pset: PrimitiveSet, max_len: int,
                           mode: str = "scan",
                           specialize: str = "auto",
                           dedup: Optional[bool] = None,
                           points_tile: Optional[int] = None,
                           chunk: int = DEFAULT_CHUNK) -> BatchInterpreter:
    """Build ``interpret(genomes, X) -> f32[n, points]`` over a whole
    population (every mode and knob bit-identical).

    :param mode: ``'scan'``, ``'sweep'`` or ``'grouped'`` (module
        docstring). ``'auto'`` asks the dispatch tuner
        (:func:`deap_tpu_torch.tuning.resolve`:
        ``DEAP_TPU_TORCH_TUNE_GP_MODE`` → a cached probe winner →
        ``'scan'``); the probe itself runs where a training set is in
        hand, :func:`deap_tpu_torch.gp.loop.resolve_gp_mode`.
    :param specialize: ``'auto'`` — the live opcode subset (a monotone
        union over calls), the host reads the genomes every call;
        ``'none'`` — the whole vocabulary on the device, no host read (and
        ``'grouped'`` takes the scan, as in the JAX package).
    :param dedup: evaluate each distinct live prefix once; default on
        with ``specialize='auto'``.
    :param points_tile: evaluate the points in tiles of this many.
    :param chunk: the grouped schedule's instruction block.
    """
    if mode == "auto":
        mode = tuning.resolve(
            "gp_mode", bucket=(tuning.shape_bucket(max_len),),
            default="scan", candidates=dict.fromkeys(MODES), check=None,
            program="gp_interpreter")
    if mode not in MODES:
        raise ValueError(f"unknown interpreter mode {mode!r}")
    if specialize not in ("auto", "none"):
        raise ValueError(f"unknown specialize policy {specialize!r}")
    dedup = (specialize == "auto") if dedup is None else dedup
    return BatchInterpreter(pset, max_len, mode, specialize, dedup,
                            points_tile, chunk)


def make_population_evaluator(pset: PrimitiveSet, max_len: int,
                              loss: Callable, mode: str = "scan",
                              **dispatch_kwargs) -> Callable:
    """``evaluate(genomes, X, y) -> f32[n]``: interpret every tree on every
    point and reduce with the batched ``loss(preds [m, points], y) ->
    [m]`` (symbolic regression: ``lambda p, y: ((p - y) ** 2).mean(1)``).
    The loss runs on the distinct trees only; the scalars expand."""
    interp = make_batch_interpreter(pset, max_len, mode=mode,
                                    **dispatch_kwargs)

    def evaluate(genomes, X, y):
        preds, inv = interp.unique(genomes, X)
        vals = loss(preds, y)
        return vals if inv is None else vals[inv]

    evaluate.interpreter = interp
    return evaluate
