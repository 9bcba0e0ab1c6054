"""The GP batch interpreter and K9's plain version held against the JAX
package's.

- The grouped schedule (``build_grouped_schedule`` and its host helpers)
  is built from the same numpy arrays on both sides: every array equal.
- K9's plain version (``ops.kernels.gp_grouped_dispatch_plain``, the CPU
  path of the grouped evaluator) fills the whole value buffer — pad rows
  too — bit for bit like the JAX package's XLA chunk loop
  (``_grouped_eval_builder``) and its Pallas K9 run in interpret mode
  (``_grouped_eval_kernel_builder``), for ``math_set(trig=False)`` and
  ``bool_set``: every element is one IEEE operation or a select.
- ``cos``/``sin`` round differently in torch and in XLA: they are held
  alone, on bounded inputs, within ``TRIG_ULPS`` ulp.
- K9's work-item table (``ops.kernels.k9_work_items``, what the kernel
  reads to carry the levels' order in one launch) covers every row and
  point of the buffer once, in schedule order, and no item reads a row
  that an item at or past its wait count writes.
- The port's scan, sweep and grouped modes, with and without dedup,
  specialisation and point tiles, agree bit for bit with each other (trig
  included: one process, one ``cos``), and the scan mode with the JAX
  package's scan interpreter (``trig=False``).

Populations come from the JAX package's generator on numpy-seeded keys.
The two reference shims (``jax.core.trace_state_clean`` and
``pltpu.TPUCompilerParams``, both renamed by jax 0.9) are set in this test
process only.
"""

import functools

import jax
import jax._src.core
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from deap_tpu import gp as jgp
from deap_tpu.gp import interpreter as ji
from deap_tpu.gp import tree as jtree
from deap_tpu_torch import gp as tgp
from deap_tpu_torch.convert import gp_genomes_from_arrays
from deap_tpu_torch.device import make_generator
from deap_tpu_torch.gp import interpreter as ti
from deap_tpu_torch.ops import kernels as tk

#: cos/sin of |x| <= 64: torch's CPU and XLA's CPU results differ by at
#: most this many units in the last place
TRIG_ULPS = 2


@pytest.fixture(autouse=True)
def _reference_shims(monkeypatch):
    if not hasattr(jax.core, "trace_state_clean"):
        monkeypatch.setattr(jax.core, "trace_state_clean",
                            jax._src.core.trace_state_clean, raising=False)
    if not hasattr(pltpu, "TPUCompilerParams"):
        monkeypatch.setattr(pltpu, "TPUCompilerParams", pltpu.CompilerParams,
                            raising=False)


PSETS = {
    "math1": lambda m: m.math_set(1),
    "math1_notrig": lambda m: m.math_set(1, trig=False),
    "math2_notrig": lambda m: m.math_set(2, trig=False),
    "bool3": lambda m: m.bool_set(3),
}


def _psets(name):
    return PSETS[name](jgp), PSETS[name](tgp)


def _population(jps, seed, n, ml, min_d=0, max_d=5):
    """``n`` trees of the JAX package's generator, with a few repeated rows
    (dedup) and single terminals (roots that are constants or arguments)."""
    base = int(np.random.default_rng(seed).integers(0, 2 ** 31))
    keys = jax.random.split(jax.random.key(base), n)
    gen = jtree.make_generator(jps, ml, min_d, max_d, "half_and_half")
    pop = {k: np.array(v) for k, v in jax.vmap(gen)(keys).items()}
    rep = np.random.default_rng(seed + 1).integers(0, n, n // 8)
    tail = np.arange(n - n // 8, n)
    for k in pop:
        pop[k][tail] = pop[k][rep]
    return pop


def _X(name, P, seed):
    rng = np.random.default_rng(seed)
    n_args = PSETS[name](tgp).n_args
    X = rng.uniform(-2.0, 2.0, (P, n_args)).astype(np.float32)
    if name.startswith("bool"):
        X = (X > 0).astype(np.float32)
    return X


def _bitwise(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, (
        got.dtype, want.dtype, got.shape, want.shape)
    assert got.tobytes() == want.tobytes()


def _schedules(jps, tps, pop, chunk, dedup=True):
    """Both packages' grouped schedules of ``pop`` (deduped as the
    interpreter builds them)."""
    nodes, consts, length = pop["nodes"], pop["consts"], pop["length"]
    jf, jinv = ji._dedup_rows(nodes, consts, length)
    tf, tinv = ti._dedup_rows(nodes, consts, length)
    _bitwise(tf, jf)
    _bitwise(tinv, jinv)
    if dedup:
        nodes, consts, length = nodes[jf], consts[jf], length[jf]
    arity = np.asarray(jps.arity_table())
    _bitwise(np.asarray(tps.arity_list(), np.int32), arity)
    je, te = ji._ends_np(nodes, length, arity), ti._ends_np(nodes, length,
                                                           arity)
    _bitwise(te, je)
    jd, td = ji._depths_np(je, length), ti._depths_np(te, length)
    _bitwise(td, jd)
    mask = ji._used_ops(jps.n_ops, nodes, length)
    assert ti._used_ops(tps.n_ops, nodes, length) == mask
    js = ji.build_grouped_schedule(jps, nodes, consts, length, je, jd, mask,
                                   chunk)
    ts = ti.build_grouped_schedule(tps, nodes, consts, length, te, td, mask,
                                   chunk)
    return js, ts, mask


CASES = [("math1_notrig", 96, 48, 16, 8), ("math2_notrig", 64, 32, 7, 16),
         ("bool3", 80, 40, 9, 8), ("math1", 96, 48, 16, 8)]


@pytest.mark.parametrize("name,n,ml,P,chunk", CASES)
def test_grouped_schedule_equals_the_jax_schedule(name, n, ml, P, chunk):
    jps, tps = _psets(name)
    pop = _population(jps, n + ml, n, ml)
    js, ts, mask = _schedules(jps, tps, pop, chunk)
    for k, v in js.items():
        if isinstance(v, np.ndarray):
            _bitwise(ts[k], v)
        else:
            assert ts[k] == v, k
    # the port's level starts: each depth level is a run of whole chunks
    # whose real operands read argument rows and rows of earlier levels
    levels = ts["level_starts"]
    assert levels[0] == 0 and levels[-1] == ts["nchunks"]
    assert all(b > a for a, b in zip(levels, levels[1:]))
    arity = np.asarray([tps.primitives[op].arity for op in mask])
    row_ar = np.repeat(arity[ts["chunk_ops"]], chunk)
    for lo, hi in zip(levels, levels[1:]):
        rows = slice(lo * chunk, hi * chunk)
        real = ((np.arange(ts["src_idx"].shape[1])[None, :]
                 < row_ar[rows, None]) & ~ts["src_isc"][rows])
        assert (ts["src_idx"][rows][real] < tps.n_args + lo * chunk).all()


def _buffers(name, n, ml, P, chunk, seed):
    jps, tps = _psets(name)
    pop = _population(jps, seed, n, ml)
    js, ts, mask = _schedules(jps, tps, pop, chunk)
    X = _X(name, P, seed)
    args = [js[k] for k in ("chunk_ops", "src_idx", "src_const", "src_isc")]
    nrows = tps.n_args + ts["nchunks"] * chunk
    buf = torch.zeros((nrows, P))
    buf[:tps.n_args] = torch.from_numpy(X.T.copy())
    branches = [tps.primitives[op] for op in mask] or [ti.IDENTITY]
    got = tk.gp_grouped_dispatch(buf, *(torch.from_numpy(a) for a in args),
                                 branches, chunk=chunk, n_args=tps.n_args,
                                 levels=ts["level_starts"])
    return jps, mask, args, X, got


@pytest.mark.parametrize("name,n,ml,P,chunk", CASES[:3])
def test_k9_plain_equals_the_xla_chunk_loop_bitwise(name, n, ml, P, chunk):
    jps, mask, args, X, got = _buffers(name, n, ml, P, chunk, 3 * n + P)
    want = ji._grouped_eval_builder(jps, mask, chunk)(*args, jnp.asarray(X))
    _bitwise(got, want)


@pytest.mark.parametrize("name,n,ml,P,chunk", [
    ("math1_notrig", 24, 24, 8, 8), ("bool3", 20, 24, 5, 8)])
def test_k9_plain_equals_the_pallas_k9_in_interpret_mode(name, n, ml, P,
                                                         chunk):
    jps, mask, args, X, got = _buffers(name, n, ml, P, chunk, 7 * n + P)
    want = ji._grouped_eval_kernel_builder(jps, mask, chunk)(*args,
                                                              jnp.asarray(X))
    _bitwise(got, want)


def test_k9_plain_empty_mask_runs_the_identity():
    """Only terminals live: no instruction; the pad chunks run the
    identity branch (the JAX package's ``lambda ops: ops[0]``)."""
    name = "math1_notrig"
    jps, tps = _psets(name)
    pop = _population(jps, 5, 16, 8, 0, 0)
    js, ts, mask = _schedules(jps, tps, pop, 8)
    assert mask == () and js["n_instructions"] == 0
    assert ts["level_starts"] == [0, ts["nchunks"]]
    X = _X(name, 6, 5)
    args = [js[k] for k in ("chunk_ops", "src_idx", "src_const", "src_isc")]
    want = ji._grouped_eval_builder(jps, mask, 8)(*args, jnp.asarray(X))
    buf = torch.zeros((1 + ts["nchunks"] * 8, 6))
    buf[:1] = torch.from_numpy(X.T.copy())
    got = tk.gp_grouped_dispatch_plain(
        buf, *(torch.from_numpy(a) for a in args), [ti.IDENTITY], chunk=8,
        n_args=1)
    _bitwise(got, want)


def test_k9_constant_replaces_a_gathered_nan():
    """A constant operand is a select, not a blend: a NaN or inf in the
    row its index points at never reaches the result."""
    tps = tgp.math_set(1, trig=False)
    add = tps.primitives[0]
    chunk = 4
    buf = torch.zeros((1 + chunk, 3))
    buf[0] = torch.tensor([float("nan"), float("inf"), 1.0])
    src_idx = torch.zeros((chunk, 2), dtype=torch.int32)
    src_const = torch.full((chunk, 2), 2.0)
    src_isc = torch.tensor([[True, True], [True, False], [False, True],
                            [False, False]])
    out = tk.gp_grouped_dispatch(buf, torch.zeros(1, dtype=torch.int32),
                                 src_idx, src_const, src_isc, [add],
                                 chunk=chunk, n_args=1, levels=[0, 1])
    assert out[1].tolist() == [4.0, 4.0, 4.0]
    assert torch.isnan(out[2, 0]) and out[2, 1] == float("inf")
    assert torch.isnan(out[4, 0]) and out[4, 1:].tolist() == [
        float("inf"), 2.0]


@pytest.mark.parametrize("fn", ["cos", "sin"])
def test_trig_within_the_stated_ulp_bound(fn):
    x = np.random.default_rng(4).uniform(-64, 64, 100_000).astype(np.float32)
    got = getattr(torch, fn)(torch.from_numpy(x)).numpy()
    want = np.asarray(getattr(jnp, fn)(jnp.asarray(x)))
    ulp = np.spacing(np.maximum(np.abs(got), np.abs(want)).astype(np.float32))
    assert (np.abs(got - want) <= TRIG_ULPS * ulp).all()


def test_port_scan_equals_the_jax_scan_bitwise():
    name = "math2_notrig"
    jps, tps = _psets(name)
    pop = _population(jps, 12, 64, 32, 0, 6)
    X = _X(name, 19, 12)
    want = ji.make_batch_interpreter(jps, 32, mode="scan")(
        {k: jnp.asarray(v) for k, v in pop.items()}, jnp.asarray(X))
    got = tgp.make_batch_interpreter(tps, 32, mode="scan")(
        gp_genomes_from_arrays(pop, "cpu"), torch.from_numpy(X))
    _bitwise(got, want)


@pytest.mark.parametrize("name", ["math1", "math2_notrig", "bool3"])
def test_port_modes_agree_bitwise(name):
    jps, tps = _psets(name)
    ml = 40
    pop = gp_genomes_from_arrays(_population(jps, 21, 120, ml, 0, 6), "cpu")
    X = torch.from_numpy(_X(name, 23, 21))
    want = tgp.make_batch_interpreter(tps, ml, mode="scan",
                                      specialize="none")(pop, X)
    for kw in (dict(mode="scan"), dict(mode="scan", dedup=False),
               dict(mode="sweep"), dict(mode="sweep", specialize="none"),
               dict(mode="grouped"), dict(mode="grouped", dedup=False),
               dict(mode="grouped", chunk=16),
               dict(mode="grouped", points_tile=10),
               dict(mode="scan", points_tile=7)):
        got = tgp.make_batch_interpreter(tps, ml, **kw)(pop, X)
        _bitwise(got, want)
    # one tree at a time, as make_interpreter evaluates it
    one = tgp.make_interpreter(tps, ml)
    for r in (0, 7, 119):
        _bitwise(one({k: v[r] for k, v in pop.items()}, X), want[r])


def test_unique_and_population_evaluator():
    tps = tgp.math_set(1)
    ml = 24
    rows = ["add(ARG0, ARG0)", "mul(ARG0, 0.5)", "add(ARG0, ARG0)",
            "protectedDiv(ARG0, sub(ARG0, ARG0))", "ARG0", "0.25"]
    trees = [tgp.from_string(r, tps, ml, device="cpu") for r in rows]
    pop = {k: torch.cat([t[k] for t in trees]) for k in trees[0]}
    X = torch.linspace(-1.0, 1.0, 5)[:, None]
    interp = tgp.make_batch_interpreter(tps, ml, mode="grouped")
    preds, inv = interp.unique(pop, X)
    assert preds.shape == (5, 5) and inv.tolist() == [0, 1, 0, 2, 3, 4]
    x = X[:, 0]
    want = torch.stack([x + x, x * 0.5, x + x, torch.ones(5), x,
                        torch.full((5,), 0.25)])
    _bitwise(interp(pop, X), want)
    assert interp.levels_run >= 1
    y = x * x
    ev = tgp.make_population_evaluator(
        tps, ml, lambda p, t: ((p - t) ** 2).mean(1), mode="grouped")
    _bitwise(ev(pop, X, y), ((want - y) ** 2).mean(1))
    shown = [tgp.to_string({k: v[r] for k, v in pop.items()}, tps)
             for r in range(len(rows))]
    assert shown == ["(ARG0 + ARG0)", "(ARG0 * 0.5)", "(ARG0 + ARG0)",
                     "(ARG0 / (ARG0 - ARG0))", "ARG0", "0.25"]


def test_strings_round_trip_through_the_port():
    tps = tgp.math_set(2)
    tree = tgp.from_string("add(mul(ARG0, ARG1), cos(-0.5))", tps, 16,
                           device="cpu")
    assert tgp.to_string({k: v[0] for k, v in tree.items()}, tps) == (
        "((ARG0 * ARG1) + cos(-0.5))")
    with pytest.raises(TypeError, match="unknown symbol"):
        tgp.from_string("tanh(ARG0)", tps, 16, device="cpu")


def test_compact_indices_equals_the_jax_compaction():
    rng = np.random.default_rng(30)
    for n, p in ((1, 1.0), (37, 0.0), (37, 0.3), (200, 0.9)):
        mask = rng.random(n) < p
        for cap in (n, max(n // 2, 1)):
            jidx, jc = ji.compact_indices(jnp.asarray(mask), cap)
            tidx, tc = ti.compact_indices(torch.from_numpy(mask), cap)
            _bitwise(tidx, jidx)
            assert int(tc) == int(jc)


def test_auto_mode_and_unknown_modes_raise():
    tps = tgp.math_set(1)
    # 'auto' is the dispatch tuner's cache-only pick: 'scan' with no tuner
    assert tgp.make_batch_interpreter(tps, 16, mode="auto").mode == "scan"
    with pytest.raises(ValueError, match="mode"):
        tgp.make_batch_interpreter(tps, 16, mode="nope")
    with pytest.raises(ValueError, match="device op"):
        tps.add_primitive(torch.tanh, 1, "tanh", device_op="tanh")
    with pytest.raises(ValueError, match="operands"):
        tps.add_primitive(torch.tanh, 1, "tanh", device_op="add")


# ------------------------------------------------- K9's work items ----

@functools.lru_cache(maxsize=None)
def _item_schedule(case):
    """A grouped schedule (the port's), its chunk, argument count and
    branch arities: the ``CASES`` populations, and an evolved shape (deep
    trees of the port's generator: many levels, the deep ones of one or
    two chunks)."""
    if case == "evolved":
        tps = tgp.math_set(1)
        gen = make_generator(71, "cpu")
        pop = tgp.gen_half_and_half(tps, 64, 3, 9)(gen, 300)
        interp = tgp.make_batch_interpreter(tps, 64, mode="grouped",
                                            chunk=16)
        ts, _ = interp.schedule(pop)
        mask, chunk = interp.mask, 16
    else:
        name, n, ml, _, chunk = CASES[case]
        jps, tps = _psets(name)
        _, ts, mask = _schedules(jps, tps, _population(jps, n + ml, n, ml),
                                 chunk)
    arity = np.asarray([tps.primitives[op].arity for op in mask] or [1])
    return ts, chunk, tps.n_args, arity


@pytest.mark.parametrize("P", [1, 7, 33, 256])
@pytest.mark.parametrize("case", [*range(len(CASES)), "evolved"])
def test_k9_work_items_order_cover_and_wait(case, P):
    ts, chunk, n_args, arity = _item_schedule(case)
    levels = ts["level_starts"]
    if case == "evolved":
        assert len(levels) - 1 >= 8
    table, tile, level_first = tk.k9_work_items(levels, chunk, P)
    assert table.dtype == np.int32 and table.shape[1] == 4
    r0, r1, p0, level = (table[:, k].astype(np.int64) for k in range(4))
    # each item: rows of one chunk, at most K9_MAX_ITEM_ROWS; a point tile
    assert (r1 > r0).all() and (r1 - r0 <= tk.K9_MAX_ITEM_ROWS).all()
    assert (r0 // chunk == (r1 - 1) // chunk).all()
    assert 1 <= tile <= P and (p0 % tile == 0).all() and (p0 < P).all()
    # schedule order: rows, then points
    order = np.lexsort((p0, r0))
    assert (order == np.arange(len(table))).all()
    # every row x point of the buffer exactly once
    total = ts["nchunks"] * chunk
    cover = np.zeros((total, P), np.int64)
    for a, b, p in zip(r0, r1, p0):
        cover[a:b, p:p + tile] += 1
    assert (cover == 1).all()
    # each item's level; each level's wait count is the count of items of
    # earlier levels, the last entry the item count
    assert (level == np.searchsorted(levels, r0 // chunk, side="right")
            - 1).all()
    assert level_first.tolist() == [
        int((level < lv).sum()) for lv in range(len(levels))]
    wait = level_first[level]
    # every real operand row an item reads (within its primitive's arity,
    # not a constant) was written by an item numbered below its wait
    writer = np.full((total, P), -1, np.int64)
    for i, (a, b, p) in enumerate(zip(r0, r1, p0)):
        writer[a:b, p:p + tile] = i
    row_ar = np.repeat(arity[ts["chunk_ops"]], chunk)
    for i, (a, b, p) in enumerate(zip(r0, r1, p0)):
        idx = ts["src_idx"][a:b]
        real = ((np.arange(idx.shape[1]) < row_ar[a:b, None])
                & ~ts["src_isc"][a:b] & (idx >= n_args))
        src = idx[real] - n_args
        if src.size:
            assert writer[src, p:p + tile].max() < wait[i]
