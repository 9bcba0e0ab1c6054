"""The port's checkpoint container, its Checkpointer and the genealogy
helpers, against the JAX package's own tests and functions.

Mirrors ``tests/test_checkpoint_hardening.py`` and
``tests/test_checkpoint_history.py`` on
:mod:`deap_tpu_torch.support.checkpoint`: flipped bytes and truncation
are detected, ``restore_latest`` falls back to the newest valid file,
all-corrupt raises, rotation never deletes the last verified-good file,
``meta`` round-trips without the state, a newer format, another port
version and a file the JAX package wrote are refused by name (the last
without importing jax). Every state of the port round-trips bit for bit
(``Population`` with tensor and dict genomes, ``HallOfFame``, the Hansen,
(1+λ) and MO-CMA-ES states, the GP loop's state, CPU generators, and
every dtype from bool to bfloat16). ``lineage_step``, ``pair_parents``
and ``History`` equal the JAX functions' output bit for bit on the same
inputs, turned to numpy.

Tolerance: bitwise.
"""

import os
import pickle
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deap_tpu_torch import FitnessSpec, Toolbox, ops
from deap_tpu_torch.algorithms import evaluate_invalid, var_and
from deap_tpu_torch.core.population import gather, init_population
from deap_tpu_torch.device import make_generator
from deap_tpu_torch.resilience.faultinject import corrupt_file
from deap_tpu_torch.support import (
    CheckpointCorruptError,
    CheckpointFormatError,
    Checkpointer,
    History,
    allow_compat_restore,
    checkpoint_meta,
    lineage_init,
    lineage_step,
    pair_parents,
    restore_state,
    save_state,
    verify_checkpoint,
)
from deap_tpu_torch.support import checkpoint as cp
from deap_tpu_torch.support.hof import hof_init, hof_update
from deap_tpu_torch.telemetry import RunJournal, read_journal

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"


def _bits(t: torch.Tensor) -> bytes:
    return cp._raw_bytes(t.detach().cpu())


def _assert_tree_bitwise(a, b):
    la, sa = cp.tree_flatten(a)
    lb, sb = cp.tree_flatten(b)
    assert sa == sb
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert type(x) is type(y)
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and x.shape == y.shape
            assert x.device == y.device
            assert _bits(x) == _bits(y)
        elif isinstance(x, torch.Generator):
            assert torch.equal(x.get_state(), y.get_state())
        else:
            assert x == y


def _onemax_pop(seed=0, n=16, length=8):
    g = make_generator(seed, CPU)
    pop = init_population(g, n, ops.bernoulli_genome(length),
                          FitnessSpec((1.0,)), device=CPU)
    return evaluate_invalid(pop, lambda x: x.sum(-1).to(torch.float32))


# --------------------------------------------------- corruption paths ----

def test_crc_detects_flipped_bytes(tmp_path):
    path = str(tmp_path / "s.pkl")
    save_state(path, {"x": torch.arange(4096, dtype=torch.float32)})
    verify_checkpoint(path)
    corrupt_file(path, mode="flip")
    with pytest.raises(CheckpointCorruptError):
        restore_state(path, CPU)
    with pytest.raises(CheckpointCorruptError):
        verify_checkpoint(path)


def test_truncated_file_detected(tmp_path):
    path = str(tmp_path / "s.pkl")
    save_state(path, {"x": torch.arange(4096, dtype=torch.int32)})
    corrupt_file(path, mode="truncate", offset=-128)
    with pytest.raises(CheckpointCorruptError):
        restore_state(path, CPU)


def test_restore_falls_back_to_newest_valid_step(tmp_path):
    ckpt = Checkpointer(str(tmp_path / "c"), keep=4)
    for s in range(4):
        ckpt.save(s, {"s": torch.tensor(s)})
    corrupt_file(ckpt._path(3), mode="flip")
    corrupt_file(ckpt._path(2), mode="truncate", offset=-64)
    jpath = str(tmp_path / "j.jsonl")
    with RunJournal(jpath):
        state = ckpt.restore(device=CPU)
    assert int(state["s"]) == 1
    kinds = [r["kind"] for r in read_journal(jpath)]
    assert kinds == ["checkpoint_corrupt", "checkpoint_corrupt",
                     "checkpoint_fallback", "checkpoint_restore"]
    step, state2 = ckpt.restore_latest(device=CPU)
    assert step == 1 and int(state2["s"]) == 1
    with pytest.raises(CheckpointCorruptError):
        ckpt.restore(3, device=CPU)


def test_all_corrupt_raises(tmp_path):
    ckpt = Checkpointer(str(tmp_path / "c"), keep=3)
    ckpt.save(0, {"s": 0})
    corrupt_file(ckpt._path(0), mode="flip")
    with pytest.raises(CheckpointCorruptError):
        ckpt.restore(device=CPU)


def test_restore_latest_verifies_each_file_once(tmp_path, monkeypatch):
    ckpt = Checkpointer(str(tmp_path / "c"), keep=4)
    for s in range(3):
        ckpt.save(s, {"s": torch.tensor(s)}, meta={"tenant_id": "t1"})
    calls = []
    real = cp._verify_payload

    def counting(path, payload):
        calls.append(path)
        return real(path, payload)

    monkeypatch.setattr(cp, "_verify_payload", counting)
    step, state = ckpt.restore_latest(tenant_id="t1", device=CPU)
    assert step == 2 and int(state["s"]) == 2
    assert calls == [ckpt._path(2)]
    calls.clear()
    corrupt_file(ckpt._path(2), mode="flip")
    step, _ = ckpt.restore_latest(tenant_id="t1", device=CPU)
    assert step == 1
    assert calls in ([ckpt._path(2), ckpt._path(1)], [ckpt._path(1)])


def test_save_without_fsync_round_trips(tmp_path):
    ckpt = Checkpointer(str(tmp_path / "c"), keep=2, fsync=False)
    state = {"x": torch.arange(64, dtype=torch.float32),
             "generator": make_generator(5, CPU)}
    ckpt.save(0, state, meta={"tenant_id": "t1"})
    verify_checkpoint(ckpt._path(0))
    step, got = ckpt.restore_latest(tenant_id="t1", device=CPU)
    assert step == 0
    _assert_tree_bitwise(state, got)


def test_post_save_verify_does_not_reload_payload(tmp_path, monkeypatch):
    ckpt = Checkpointer(str(tmp_path / "c"), keep=2)
    loads = []
    real = cp._load_payload

    def counting(path):
        loads.append(path)
        return real(path)

    monkeypatch.setattr(cp, "_load_payload", counting)
    ckpt.save(0, {"s": torch.arange(16)})
    assert loads == []
    real_save = cp.save_state

    def torn_save(path, state, meta=None, **kw):
        crc = real_save(path, state, meta=meta, **kw)
        corrupt_file(path, mode="truncate", offset=-32)
        return crc

    monkeypatch.setattr(cp, "save_state", torn_save)
    ckpt.save(1, {"s": torch.arange(16)})
    monkeypatch.undo()
    assert 1 not in ckpt._verified


def test_rotation_never_deletes_last_verified_good(tmp_path, monkeypatch):
    ckpt = Checkpointer(str(tmp_path / "c"), keep=1)
    ckpt.save(0, {"s": 0})
    assert ckpt.steps() == [0]
    real_save = cp.save_state

    def broken_save(path, state, meta=None, **kw):
        crc = real_save(path, state, meta=meta, **kw)
        corrupt_file(path, mode="flip")
        return crc

    monkeypatch.setattr(cp, "save_state", broken_save)
    ckpt.save(1, {"s": 1})
    monkeypatch.undo()
    assert 0 in ckpt.steps()
    assert int(ckpt.restore(device=CPU)["s"]) == 0
    ckpt.save(2, {"s": 2})
    assert int(ckpt.restore(device=CPU)["s"]) == 2
    assert ckpt.steps() == [2]


def test_steps_empty_when_directory_removed(tmp_path):
    import shutil

    d = str(tmp_path / "gone")
    ckpt = Checkpointer(d, keep=2)
    ckpt.save(0, {"s": 0})
    shutil.rmtree(d)
    assert ckpt.steps() == []
    assert ckpt.latest_step() is None
    assert ckpt.restore_latest(device=CPU) is None
    with pytest.raises(FileNotFoundError, match="gone"):
        ckpt.restore(device=CPU)
    with pytest.raises(FileNotFoundError, match="step 0"):
        ckpt.restore(0, device=CPU)


def test_meta_roundtrip_without_state(tmp_path):
    path = str(tmp_path / "m.pkl")
    save_state(path, {"x": torch.zeros(8)},
               meta={"run_id": "abc123", "step": 7})
    meta = checkpoint_meta(path)
    assert meta["run_id"] == "abc123" and meta["step"] == 7
    assert meta["deap_tpu_torch_version"]
    assert meta["checkpoint_format"] == cp.FORMAT_VERSION
    ckpt = Checkpointer(str(tmp_path / "c"))
    ckpt.save(3, {"x": 1}, meta={"run_id": "zzz"})
    assert ckpt.meta()["run_id"] == "zzz"
    with pytest.raises(ValueError, match="tenant"):
        checkpoint_meta(path, tenant_id="t1")


def test_checkpoint_event_broadcast(tmp_path):
    jpath = str(tmp_path / "j.jsonl")
    with RunJournal(jpath):
        save_state(str(tmp_path / "s.pkl"), {"x": 1})
    rows = [r for r in read_journal(jpath) if r["kind"] == "checkpoint"]
    assert rows and rows[0]["bytes"] > 0


def test_fsync_every_journal_policy(tmp_path):
    jpath = str(tmp_path / "j.jsonl")
    j = RunJournal(jpath, fsync_every=2)
    j.header(init_backend=False)
    for i in range(5):
        j.event("tick", i=i)
    rows = read_journal(jpath)
    assert [r["i"] for r in rows if r["kind"] == "tick"] == list(range(5))
    assert rows[0]["env"]["torch"] == torch.__version__
    j.close()
    with open(jpath, "a") as fh:
        fh.write('{"t": 1.0, "kind": "tick", "i": 99')
    rows = read_journal(jpath)
    assert rows.tear_offset is not None
    assert [r["i"] for r in rows if r["kind"] == "tick"] == list(range(5))
    with pytest.raises(ValueError):
        read_journal(jpath, strict=True)
    # a restart over the same path keeps the old journal beside it
    with RunJournal(jpath) as j2:
        assert j2.rotated_from == jpath + ".1"
    from deap_tpu_torch.telemetry import journal_generations
    assert journal_generations(jpath) == [jpath + ".1", jpath]


# ------------------------------------ version stamps and foreign files ----

def test_newer_format_version_refused_by_name(tmp_path):
    path = str(tmp_path / "future.pkl")
    save_state(path, {"x": torch.arange(4)})
    with open(path, "rb") as f:
        payload = pickle.load(f)
    payload["format_version"] = cp.FORMAT_VERSION + 1
    with open(path, "wb") as f:
        pickle.dump(payload, f)
    with pytest.raises(CheckpointFormatError, match="newer"):
        restore_state(path, CPU)
    with pytest.raises(CheckpointCorruptError):
        restore_state(path, CPU)


def test_cross_version_restore_gated(tmp_path, monkeypatch):
    path = str(tmp_path / "old.pkl")
    monkeypatch.setenv("DEAP_TPU_TORCH_VERSION_OVERRIDE", "0.0.9+old")
    save_state(path, {"x": torch.arange(8)}, meta={"tenant_id": "t-1"})
    monkeypatch.setenv("DEAP_TPU_TORCH_VERSION_OVERRIDE", "0.1.1+new")
    with pytest.raises(CheckpointFormatError, match="0.0.9"):
        restore_state(path, CPU)
    assert checkpoint_meta(path)["deap_tpu_torch_version"] == "0.0.9+old"
    verify_checkpoint(path)
    jpath = str(tmp_path / "j.jsonl")
    with RunJournal(jpath):
        with allow_compat_restore():
            out = restore_state(path, CPU)
    assert torch.equal(out["x"], torch.arange(8))
    rows = [r for r in read_journal(jpath) if r["kind"] == "compat_restore"]
    assert rows and rows[0]["written_by"] == "0.0.9+old"
    assert rows[0]["running"] == "0.1.1+new"
    assert rows[0]["tenant_id"] == "t-1"
    with pytest.raises(CheckpointFormatError):
        restore_state(path, CPU)


def test_same_version_restore_needs_no_gate(tmp_path):
    path = str(tmp_path / "same.pkl")
    save_state(path, {"x": torch.arange(3)})
    assert torch.equal(restore_state(path, CPU)["x"], torch.arange(3))


def _jax_files(tmp_path):
    """A file in each of the JAX package's layouts: its current format,
    written by its own ``save_state``, and its first format (the tree
    structure pickled as a jax object)."""
    from deap_tpu import ops as jops
    from deap_tpu.core.fitness import FitnessSpec as JSpec
    from deap_tpu.core.population import init_population as jinit
    from deap_tpu.support.checkpoint import save_state as jax_save

    jpop = jinit(jax.random.key(0), 8, jops.bernoulli_genome(4),
                 JSpec((1.0,)))
    new = str(tmp_path / "jax_v3.pkl")
    jax_save(new, {"pop": jpop, "key": jax.random.key(1), "gen": 2})
    leaves, treedef = jax.tree_util.tree_flatten({"a": jnp.arange(5)})
    old = str(tmp_path / "jax_v1.pkl")
    with open(old, "wb") as f:
        pickle.dump({"leaves": [np.asarray(x) for x in leaves],
                     "treedef": treedef}, f)
    return new, old


def test_jax_written_files_refused_by_name(tmp_path):
    new, old = _jax_files(tmp_path)
    for path in (new, old):
        with pytest.raises(CheckpointFormatError, match="JAX package"):
            restore_state(path, CPU)
    ckpt = Checkpointer(str(tmp_path / "c"))
    os.replace(new, ckpt._path(5))
    with pytest.raises(CheckpointFormatError, match="JAX package"):
        ckpt.restore_latest(device=CPU)


def test_jax_written_files_refused_without_importing_jax(tmp_path):
    """The refusal needs no jax: a process that never imports it gets
    CheckpointFormatError for both layouts, never an ImportError."""
    new, old = _jax_files(tmp_path)
    script = textwrap.dedent(f"""
        import sys
        from deap_tpu_torch.support import (CheckpointFormatError,
                                            restore_state)
        for path in ({new!r}, {old!r}):
            try:
                restore_state(path, "cpu")
            except CheckpointFormatError as e:
                assert "JAX package" in str(e), e
            else:
                raise AssertionError("restored a JAX file")
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "deap_tpu"))
        print("LOADED", bad)
    """)
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout


def test_restore_goes_to_the_card_unless_asked(tmp_path, monkeypatch):
    path = str(tmp_path / "s.pkl")
    save_state(path, {"x": torch.arange(3)})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        restore_state(path)
    ckpt = Checkpointer(str(tmp_path / "c"))
    ckpt.save(0, {"x": torch.arange(2)})  # saving needs no card
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ckpt.restore_latest()


class _Box:
    def __init__(self, t):
        self.t = t


def test_tensor_inside_an_opaque_leaf_is_refused(tmp_path):
    with pytest.raises(TypeError, match="opaque"):
        save_state(str(tmp_path / "s.pkl"), {"box": _Box(torch.zeros(2))})


# ------------------------------------------------- bitwise round trips ----

DTYPES = (torch.bool, torch.int8, torch.int16, torch.int32, torch.int64,
          torch.uint8, torch.float16, torch.bfloat16, torch.float32)


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: str(d)[6:])
def test_roundtrip_every_dtype_bitwise(tmp_path, dtype):
    g = make_generator(3, CPU)
    raw = torch.randint(0, 256, (5, 7, 8), generator=g, dtype=torch.uint8)
    # random bit patterns of the dtype, NaNs and infinities included
    x = raw[..., 0] > 127 if dtype == torch.bool else raw.view(dtype)
    state = {"x": x, "t": x.transpose(0, 1), "scalar": x.reshape(-1)[0],
             "empty": x[:0], "n": 3, "f": 0.5, "s": "run", "none": None}
    path = str(tmp_path / "d.pkl")
    save_state(path, state)
    out = restore_state(path, CPU)
    _assert_tree_bitwise(state, out)
    # a transposed tensor keeps its strides (a product over it rounds
    # as over the original)
    assert out["t"].stride() == state["t"].stride() != out["x"].stride()


def _cma_states():
    from deap_tpu_torch.strategies import (Strategy, StrategyMultiObjective,
                                           StrategyOnePlusLambda)

    g = make_generator(0, CPU)
    s = Strategy(torch.full((8,), 0.5), 0.3, lambda_=10, device=CPU)
    st = s.initial_state()
    x = s.generate(g, st)
    hansen = s.update(st, x, (x * x).sum(-1))
    o = StrategyOnePlusLambda(torch.zeros(6), [1.0], 0.4, lambda_=8,
                              device=CPU)
    pop = torch.rand(8, 5, generator=g)
    m = StrategyMultiObjective(pop, torch.rand(8, 2, generator=g), 0.3,
                               mu=4, lambda_=4, device=CPU)
    return {"hansen": hansen, "one_plus_lambda": o.initial_state(),
            "mo_cma": m.initial_state()}


def _gp_state():
    from deap_tpu_torch import gp

    pset = gp.math_set(1)
    g = make_generator(4, CPU)
    X = torch.linspace(-1, 1, 16)[:, None]
    run = gp.make_symbreg_loop(pset, 32, X, X[:, 0] ** 2, device=CPU)
    state = run.init_state(gp.gen_half_and_half(pset, 32, 1, 3)(g, 24), 3)
    run.advance(g, state)
    return state


def _population_states():
    pop = _onemax_pop()
    g = make_generator(1, CPU)
    dict_pop = init_population(
        g, 10, lambda gen, n: {"x": torch.rand(n, 3, generator=gen),
                               "strategy": torch.rand(n, 3, generator=gen)},
        FitnessSpec((-1.0, 1.0)), device=CPU)
    hof = hof_update(hof_init(4, pop), pop)
    return {"array_pop": pop, "dict_pop": dict_pop, "hof": hof}


@pytest.mark.parametrize("family", ["population", "cma", "gp", "generator"])
def test_roundtrip_port_states_bitwise(tmp_path, family):
    if family == "population":
        state = _population_states()
    elif family == "cma":
        state = _cma_states()
    elif family == "gp":
        state = _gp_state()
    else:
        g = make_generator(9, CPU)
        torch.rand(17, generator=g)
        state = {"generator": g, "pair": (g, 3)}
    path = str(tmp_path / f"{family}.pkl")
    save_state(path, state)
    out = restore_state(path, CPU)
    _assert_tree_bitwise(state, out)
    if family == "population":
        assert out["array_pop"].spec == FitnessSpec((1.0,))
        assert type(out["hof"]).__name__ == "HallOfFame"
    if family == "generator":
        assert out["pair"][0] is not state["generator"]
        assert torch.equal(torch.rand(5, generator=out["generator"]),
                           torch.rand(5, generator=state["generator"]))


def test_resume_is_bit_exact(tmp_path):
    """Run 4 generations, checkpoint the population and the generator at
    generation 2, resume and match generations 3-4."""
    tb = Toolbox()
    tb.register("evaluate", lambda g: g.sum(-1).to(torch.float32))
    tb.register("mate", ops.cx_one_point)
    tb.register("mutate", ops.mut_flip_bit, indpb=0.1)
    tb.register("select", ops.sel_tournament, tournsize=2)

    def gen_step(g, pop):
        idx = tb.select(g, pop.wvalues, pop.size)
        off = var_and(g, gather(pop, idx), tb, 0.6, 0.3)
        return evaluate_invalid(off, tb.evaluate)

    ckpt = Checkpointer(str(tmp_path / "ckpts"), keep=2)
    pop = _onemax_pop(1)
    g = make_generator(2, CPU)
    straight = None
    for gen in range(4):
        pop = gen_step(g, pop)
        if gen == 1:
            ckpt.save(gen, {"pop": pop, "generator": g, "gen": gen})
        if gen == 3:
            straight = pop
    state = ckpt.restore(device=CPU)
    assert state["gen"] == 1
    pop2, g2 = state["pop"], state["generator"]
    for _ in range(2, 4):
        pop2 = gen_step(g2, pop2)
    _assert_tree_bitwise(straight, pop2)


def test_checkpointer_rotation(tmp_path):
    ckpt = Checkpointer(str(tmp_path / "c"), keep=2)
    for s in range(5):
        ckpt.save(s, {"s": s})
    assert ckpt.steps() == [3, 4]
    assert ckpt.latest_step() == 4
    assert ckpt.restore(device=CPU)["s"] == 4
    assert ckpt.restore(3, device=CPU)["s"] == 3


# ----------------------------------------------------- genealogy ----

def test_lineage_ids_and_history():
    lin = lineage_init(4, device=CPU)
    hist = History()
    hist.found(4)
    pidx = torch.tensor([[0, 1], [1, 0], [2, 2], [3, 3]])
    lin, parent_ids = lineage_step(lin, pidx)
    assert lin.ids.tolist() == [5, 6, 7, 8]
    assert lin.ids.dtype == torch.int32 and parent_ids.dtype == torch.int32
    hist.record(parent_ids)
    assert hist.genealogy_tree[5] == (1, 2)
    assert hist.genealogy_tree[7] == (3,)
    lin, parent_ids = lineage_step(lin, torch.zeros((4, 2), dtype=torch.int32))
    hist.record(parent_ids)
    assert hist.genealogy_tree[9] == (5,)
    gene = hist.get_genealogy(9)
    assert gene[9] == (5,) and gene[5] == (1, 2)
    assert 5 not in hist.get_genealogy(9, max_depth=1)


def test_genealogy_diamond_shared_ancestors():
    hist = History()
    hist.found(1)
    hist.record(np.asarray([[1], [1]]))
    hist.record(np.asarray([[2, 3]]))
    assert hist.get_genealogy(4) == {4: (2, 3), 2: (1,), 3: (1,)}
    assert hist.get_genealogy(4, max_depth=1) == {4: (2, 3)}


def test_pair_parents_matches_varand_pairing():
    p = pair_parents(torch.tensor([4, 2, 7, 1]), torch.tensor([True, False]))
    assert p.tolist() == [[4, 2], [2, 4], [7, 7], [1, 1]]


@pytest.mark.parametrize("n", [1, 2, 7, 32, 33])
def test_lineage_and_pairing_equal_the_jax_functions(n):
    """The same inputs through the JAX package's functions and the
    port's: ids, parent ids, pairings and the genealogy equal bit for
    bit, over three generations (odd n included: the unpaired last
    individual)."""
    from deap_tpu.support import history as jh

    rng = np.random.default_rng(n)
    jlin, tlin = jh.lineage_init(n), lineage_init(n, device=CPU)
    jhist, thist = jh.History(), History()
    jhist.found(n)
    thist.found(n)
    for _ in range(3):
        sel = rng.integers(0, n, n).astype(np.int32)
        cx = rng.random(n // 2) < 0.5
        jp = np.asarray(jh.pair_parents(jnp.asarray(sel), jnp.asarray(cx)))
        tp = pair_parents(torch.from_numpy(sel), torch.from_numpy(cx))
        assert tp.dtype == torch.int32
        np.testing.assert_array_equal(jp, tp.numpy())
        jlin, jids = jh.lineage_step(jlin, jnp.asarray(jp))
        tlin, tids = lineage_step(tlin, tp)
        np.testing.assert_array_equal(np.asarray(jids), tids.numpy())
        np.testing.assert_array_equal(np.asarray(jlin.ids), tlin.ids.numpy())
        assert int(jlin.next_id) == int(tlin.next_id)
        jhist.record(np.asarray(jids))
        thist.record(tids)
    assert jhist.genealogy_tree == thist.genealogy_tree
    for k in jhist.genealogy_history:
        np.testing.assert_array_equal(jhist.genealogy_history[k],
                                      thist.genealogy_history[k])
    last = int(tlin.next_id) - 1
    assert jhist.get_genealogy(last) == thist.get_genealogy(last)
    # one parent a child (a 1-D index vector)
    idx = rng.integers(0, n, n)
    _, j1 = jh.lineage_step(jlin, jnp.asarray(idx))
    _, t1 = lineage_step(tlin, torch.from_numpy(idx))
    np.testing.assert_array_equal(np.asarray(j1), t1.numpy())
