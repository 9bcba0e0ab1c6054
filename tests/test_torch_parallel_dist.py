"""The port's parallelism on several ranks, held on the CPU.

Groups of 2 and 4 ``gloo`` processes (one spawn of each size for the
module, the 4 first) run one battery and save what each case computed;
the tests below compare it with the same battery run here in one
process, with no process group. Every comparison is bit for bit unless
it says otherwise:

- ``ea_simple``, ``ea_mu_plus_lambda``, ``ea_mu_comma_lambda``,
  ``ea_generate_update`` (CMA-ES), the GP loop and ``nd_rank`` with
  ``plan=``, on populations whose rows split over the ranks and on one
  whose rows do not (there every rank runs them whole);
- the island step with ``plan=`` and with ``mesh=`` (each rank its block
  of demes, the blocks gathered here);
- ``mig_ring_collective`` (one deme a rank) against ``mig_ring`` over the
  demes stacked in rank order;
- the 2 x 2 ``("pop", "genome")`` evaluator: OneMax exact, ``mean`` and
  ``max`` within the JAX package's rtol 1e-5 and 1e-6;
- elastic resume: a ``ResilientRun`` island run and an ``ea_simple`` run
  killed at 4 ranks, resumed and killed again at 2, finished here in one
  process, equal to the uninterrupted run and journaling
  ``elastic_resume``;
- the format-3 file the 4 ranks wrote: one entry per distinct shard,
  an incomplete shard set refused, a corrupt newest file skipped for the
  one before it.

A child runs under its own ``gloo`` timeout and reports its exception;
the parent kills every child still running after ``CHILD_TIMEOUT_S``, so
a hung rank fails its tests and never hangs the suite. Run a group by
hand with ``python tests/test_torch_parallel_dist.py --child W RANK PORT
OUT`` in W processes.
"""

import json
import os
import pickle
import socket
import subprocess
import sys
import time
import traceback

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from deap_tpu_torch import algorithms, benchmarks, ops  # noqa: E402
from deap_tpu_torch import parallel  # noqa: E402
from deap_tpu_torch import gp as tgp  # noqa: E402
from deap_tpu_torch.core.fitness import FitnessSpec  # noqa: E402
from deap_tpu_torch.core.population import init_population  # noqa: E402
from deap_tpu_torch.core.toolbox import Toolbox  # noqa: E402
from deap_tpu_torch.device import make_generator  # noqa: E402
from deap_tpu_torch.mo import emo  # noqa: E402
from deap_tpu_torch.resilience import ResilientRun  # noqa: E402
from deap_tpu_torch.resilience.faultinject import (  # noqa: E402
    FaultPlan, InjectedCrash, KillAt)
from deap_tpu_torch.strategies import cma  # noqa: E402
from deap_tpu_torch.support import checkpoint as cp  # noqa: E402
from deap_tpu_torch.support.stats import fitness_stats  # noqa: E402
from deap_tpu_torch.telemetry import RunJournal  # noqa: E402

CPU = "cpu"
CHILD_TIMEOUT_S = 120
L, NGEN = 12, 4
ISL_I, ISL_S, ISL_FREQ, ISL_K, ISL_EPOCHS = 8, 6, 2, 2, 6
KILL_W4, KILL_W2 = 2, 4  # epochs (segments of 1) at which the runs die


def _toolbox():
    tb = Toolbox()
    tb.register("evaluate", lambda g: g.sum(-1).to(torch.float32))
    tb.register("mate", ops.cx_two_point)
    tb.register("mutate", ops.mut_flip_bit, indpb=0.1)
    tb.register("select", ops.sel_tournament, tournsize=3)
    return tb


def _pop(n, seed):
    return init_population(make_generator(seed, CPU), n,
                           ops.bernoulli_genome(L), FitnessSpec((1.0,)),
                           device=CPU)


def _np(tree):
    """Every tensor of ``tree`` as numpy (bool planes stay bool)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, torch.Generator):
        return tree.get_state().numpy()
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_np(v) for v in tree]
    if hasattr(tree, "genomes") and hasattr(tree, "fitness"):
        return {"genomes": _np(tree.genomes), "fitness": _np(tree.fitness),
                "valid": _np(tree.valid)}
    return tree


def _logbook(lb):
    return [{k: _np(v) for k, v in rec.items()} for rec in lb]


def _loop_result(pop, lb, hof, g):
    return {"pop": _np(pop), "logbook": _logbook(lb),
            "hof": None if hof is None else {"g": _np(hof.genomes),
                                             "f": _np(hof.fitness)},
            "generator": _np(g)}


# ------------------------------------------------------------ battery ----

def run_ea_simple(plan, n):
    g = make_generator(1, CPU)
    pop = _pop(n, 0)
    out = algorithms.ea_simple(g, pop, _toolbox(), 0.5, 0.2, NGEN,
                               stats=fitness_stats(), halloffame_size=3,
                               plan=plan, device=CPU)
    return _loop_result(*out, g)


def run_mu_lambda(plan, plus):
    g = make_generator(2, CPU)
    loop = (algorithms.ea_mu_plus_lambda if plus
            else algorithms.ea_mu_comma_lambda)
    out = loop(g, _pop(16, 3), _toolbox(), 16, 24, 0.5, 0.3, NGEN,
               stats=fitness_stats(), halloffame_size=2, plan=plan,
               device=CPU)
    return _loop_result(*out, g)


def run_cma(plan):
    strat = cma.Strategy(torch.linspace(-2.0, 3.0, 4), sigma=0.7,
                         lambda_=8, device=CPU)
    tb = Toolbox()
    tb.register("generate", strat.generate)
    tb.register("update", strat.update)
    tb.register("evaluate", benchmarks.sphere)
    g = make_generator(4, CPU)
    state, lb, hof = algorithms.ea_generate_update(
        g, strat.initial_state(), tb, NGEN, strat.spec,
        stats=fitness_stats(), halloffame_size=2, plan=plan, device=CPU)
    return {"state": {f: _np(getattr(state, f)) for f in
                      ("centroid", "sigma", "C", "pc", "ps")},
            "logbook": _logbook(lb), "hof": _np(hof.fitness),
            "generator": _np(g)}


def run_gp(plan):
    pset = tgp.math_set(1)
    X = torch.linspace(-1.0, 1.0, 16)[:, None]
    x = X[:, 0]
    run = tgp.make_symbreg_loop(pset, 24, X, x ** 4 + x ** 3 + x ** 2 + x,
                                cxpb=0.5, mutpb=0.2, device=CPU, plan=plan)
    g = make_generator(5, CPU)
    genomes = tgp.make_generator(pset, 24, 1, 2, "half_and_half")(g, 32)
    res = run(g, genomes, NGEN)
    return {"genomes": _np(res["genomes"]), "fitness": _np(res["fitness"]),
            "nevals": list(res["nevals"]), "best": res["best_fitness"],
            "generator": _np(g)}


def run_nd_rank(plan, n):
    g = make_generator(6, CPU)
    x = torch.rand((n, 3), generator=g)
    w = -benchmarks.dtlz2(x, 3)
    return {impl: _np(emo.nd_rank(w, impl=impl, plan=plan))
            for impl in ("matrix", "tiled", "dc")}


def _island_pops():
    return parallel.island_init(make_generator(7, CPU), ISL_I, ISL_S,
                                ops.bernoulli_genome(L), FitnessSpec((1.0,)),
                                device=CPU)


def run_island_plan(plan, epochs=3):
    step = parallel.make_island_step(_toolbox(), 0.5, 0.3, ISL_FREQ, ISL_K,
                                     plan=plan)
    g = make_generator(8, CPU)
    pops = _island_pops()
    for _ in range(epochs):
        pops = step(g, pops)
    return {"pops": _np(pops), "generator": _np(g)}


def run_island_mesh(epochs=3):
    mesh = parallel.population_mesh(axis_names=("island",), device=CPU)
    step = parallel.make_island_step(_toolbox(), 0.5, 0.3, ISL_FREQ, ISL_K,
                                     mesh=mesh)
    g = make_generator(8, CPU)
    pops = parallel.shard_population(_island_pops(), mesh, "island")
    for _ in range(epochs):
        pops = step(g, pops)
    return {"block": _np(pops), "index": mesh.axis_index("island"),
            "generator": _np(g)}


def ring_demes(W):
    """Stacked demes ``[W, 10]``, evaluated, for the collective ring."""
    pops = parallel.island_init(make_generator(9, CPU), W, 10,
                                ops.bernoulli_genome(L), FitnessSpec((1.0,)),
                                device=CPU)
    return pops.replace(fitness=pops.genomes.sum(-1, keepdim=True).to(
        torch.float32), valid=torch.ones_like(pops.valid))


def run_ring(W, rank):
    pops = ring_demes(W)
    mine = pops.replace(genomes=pops.genomes[rank], fitness=pops.fitness[rank],
                        valid=pops.valid[rank])
    out = parallel.mig_ring_collective(None, mine, 3, "island")
    return _np(out)


def genome_data():
    g = make_generator(10, CPU)
    return ((torch.rand((8, 16), generator=g) < 0.5).to(torch.float32),
            torch.randn((8, 16), generator=g))


def run_genome_2x2():
    mesh = parallel.genome_mesh(2, 2, device=CPU)
    bits, normal = genome_data()
    out = {"pop": mesh.axis_index("pop")}
    for name, data, fn, combine in (
            ("sum", bits, lambda a: a.sum(-1), "sum"),
            ("mean", normal, lambda a: a.mean(-1), "mean"),
            ("max", normal, lambda a: a.max(-1).values, "max")):
        ev = parallel.make_sharded_evaluator(fn, mesh, combine)
        out[name] = _np(ev(parallel.shard_genomes(data, mesh)))
    return out


def elastic_island(directory, plan, kill_at=None):
    """The island run in segments of one epoch, killed after the save
    at ``kill_at``; returns the demes and the generator's state."""
    step = parallel.make_island_step(_toolbox(), 0.5, 0.3, ISL_FREQ, ISL_K,
                                     plan=plan)
    faults = FaultPlan([KillAt(kill_at, "after_save")]) if kill_at else None
    with RunJournal(os.path.join(directory, f"journal_{plan.n_shards}"
                                 f"_{plan.rank}.jsonl")):
        res = ResilientRun(os.path.join(directory, "island"), segment_len=1,
                           keep=ISL_EPOCHS, fault_plan=faults, plan=plan)
        g = make_generator(8, CPU)
        try:
            pops = res.island_run(step, g, _island_pops(), ISL_EPOCHS,
                                  device=CPU)
        except InjectedCrash:
            return None
    return {"pops": _np(pops), "generator": _np(g)}


def elastic_ea_simple(directory, plan, kill_at=None):
    faults = FaultPlan([KillAt(kill_at, "after_save")]) if kill_at else None
    with RunJournal(os.path.join(directory, f"journal_ea_{plan.n_shards}"
                                 f"_{plan.rank}.jsonl")):
        res = ResilientRun(os.path.join(directory, "ea"), segment_len=1,
                           keep=ISL_EPOCHS, fault_plan=faults, plan=plan)
        g = make_generator(1, CPU)
        try:
            out = res.ea_simple(g, _pop(32, 0), _toolbox(), 0.5, 0.2,
                                ISL_EPOCHS, stats=fitness_stats(),
                                halloffame_size=3, device=CPU)
        except InjectedCrash:
            return None
    return _loop_result(*out, g)


def battery(W, rank, elastic_dir=None):
    """Every case, as this process computes it."""
    plan = parallel.ShardingPlan.for_population(device=CPU)
    iplan = parallel.ShardingPlan.for_islands(device=CPU)
    out = {"ea_simple_32": run_ea_simple(plan, 32),
           "ea_simple_18": run_ea_simple(plan, 18),
           "mu_plus": run_mu_lambda(plan, True),
           "mu_comma": run_mu_lambda(plan, False),
           "cma": run_cma(plan),
           "gp": run_gp(plan),
           "nd_32": run_nd_rank(plan, 32),
           "nd_18": run_nd_rank(plan, 18),
           "island_plan": run_island_plan(iplan),
           "island_mesh": run_island_mesh()}
    if W > 1:
        out["ring"] = run_ring(W, rank)
    if W == 4:
        out["genome_2x2"] = run_genome_2x2()
    if elastic_dir is not None:
        kill = KILL_W4 if W == 4 else KILL_W2
        out["elastic_island"] = elastic_island(elastic_dir, iplan, kill)
        out["elastic_ea"] = elastic_ea_simple(elastic_dir, plan, kill)
    return out


def child(argv):
    """``--child W RANK PORT OUT``: one rank of a gloo group."""
    W, rank, port, out = int(argv[0]), int(argv[1]), int(argv[2]), argv[3]
    try:
        parallel.initialize(f"127.0.0.1:{port}", W, rank, device=CPU,
                            timeout_s=CHILD_TIMEOUT_S - 20)
        got = battery(W, rank, os.path.join(out, "elastic"))
        with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(got, f)
        torch.distributed.barrier()
        torch.distributed.destroy_process_group()
        return 0
    except BaseException:
        with open(os.path.join(out, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        return 1


# ------------------------------------------------------------ harness ----

def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(W, out):
    """Run a group of W ranks into ``out``; ``{rank: results}`` or
    ``{rank: error text}``."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
              "LOCAL_RANK"):
        env.pop(k, None)
    logs = [open(os.path.join(out, f"rank{r}.log"), "wb") for r in range(W)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--child", str(W),
         str(r), str(port), out], cwd=ROOT, env=env,
        stdout=subprocess.DEVNULL, stderr=logs[r])
        for r in range(W)]
    deadline = time.monotonic() + CHILD_TIMEOUT_S
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    results = {}
    for r, p in enumerate(procs):
        path = os.path.join(out, f"rank{r}.pkl")
        if os.path.exists(path):
            with open(path, "rb") as f:
                results[r] = pickle.load(f)
        else:
            err = os.path.join(out, f"rank{r}.err")
            log = os.path.join(out, f"rank{r}.log")
            results[r] = (open(err).read() if os.path.exists(err)
                          else f"rank {r} gave no result (rc "
                               f"{p.returncode}):\n"
                               + open(log, errors="replace").read()[-3000:])
    return results


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """The 4-rank group, then the 2-rank group (sharing the elastic
    runs' checkpoint directory), then the reference in one process."""
    root = tmp_path_factory.mktemp("dist")
    got = {}
    for W in (4, 2):
        out = root / f"w{W}"
        out.mkdir()
        (out / "elastic").mkdir()
        if W == 2:  # the 2 ranks resume the 4 ranks' runs
            for name in ("island", "ea"):
                src = root / "w4" / "elastic" / name
                if src.exists():
                    os.rename(src, out / "elastic" / name)
        got[W] = spawn(W, str(out))
    return {"root": root, "ranks": got, "ref": battery(1, 0)}


def _ranks(groups, W):
    res = groups["ranks"][W]
    for r, v in res.items():
        if isinstance(v, str):
            pytest.fail(f"rank {r} of {W} failed:\n{v}")
    return res


def assert_same(got, want, path="result"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            assert_same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            assert_same(a, b, f"{path}[{i}]")
    elif isinstance(want, np.ndarray):
        got = np.asarray(got)
        assert got.shape == want.shape and got.dtype == want.dtype, path
        assert got.tobytes() == want.tobytes(), path
    else:
        assert got == want, path


CASES = ("ea_simple_32", "ea_simple_18", "mu_plus", "mu_comma", "cma", "gp",
         "nd_32", "nd_18", "island_plan")


@pytest.mark.parametrize("W", [2, 4])
@pytest.mark.parametrize("case", CASES)
def test_plan_equals_one_process(groups, W, case):
    """Every rank returns the whole result, equal to one process's."""
    for r, res in _ranks(groups, W).items():
        assert_same(res[case], groups["ref"][case], f"rank {r}: {case}")


@pytest.mark.parametrize("W", [2, 4])
def test_island_mesh_blocks_equal_one_process(groups, W):
    res = _ranks(groups, W)
    blocks = sorted((v["island_mesh"]["index"], v["island_mesh"]["block"])
                    for v in res.values())
    whole = {k: np.concatenate([b[k] for _, b in blocks])
             for k in ("genomes", "fitness", "valid")}
    assert_same(whole, groups["ref"]["island_mesh"]["block"])
    for v in res.values():
        assert_same(v["island_mesh"]["generator"],
                    groups["ref"]["island_mesh"]["generator"])


@pytest.mark.parametrize("W", [2, 4])
def test_mig_ring_collective_equals_mig_ring(groups, W):
    want = _np(parallel.mig_ring(None, ring_demes(W), 3))
    res = _ranks(groups, W)
    for r in range(W):
        assert_same(res[r]["ring"], {k: v[r] for k, v in want.items()},
                    f"rank {r}")


def test_genome_evaluator_2x2(groups):
    bits, normal = genome_data()
    res = _ranks(groups, 4)
    for v in res.values():
        rows = slice(4 * v["genome_2x2"]["pop"],
                     4 * (v["genome_2x2"]["pop"] + 1))
        np.testing.assert_array_equal(v["genome_2x2"]["sum"],
                                      bits.sum(-1)[rows].numpy())
        np.testing.assert_allclose(v["genome_2x2"]["mean"],
                                   normal.mean(-1)[rows].numpy(), rtol=1e-5)
        np.testing.assert_allclose(v["genome_2x2"]["max"],
                                   normal.max(-1).values[rows].numpy(),
                                   rtol=1e-6)


def _journal(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


@pytest.mark.parametrize("what", ["island", "ea"])
def test_elastic_resume_4_to_2_to_1(groups, what):
    """Killed at 4 ranks, resumed and killed at 2, finished here: the
    uninterrupted run's bits; the 2 ranks and the finish journal
    ``elastic_resume`` from the mesh the file was written on."""
    for W in (4, 2):
        for r, v in _ranks(groups, W).items():
            assert v[f"elastic_{what}"] is None, (W, r)  # killed
    d = str(groups["root"] / "w2" / "elastic")
    plan = parallel.ShardingPlan.for_population(device=CPU) if what == "ea" \
        else parallel.ShardingPlan.for_islands(device=CPU)
    run = elastic_island if what == "island" else elastic_ea_simple
    got = run(d, plan)
    fresh = str(groups["root"] / f"fresh_{what}")
    os.makedirs(fresh, exist_ok=True)
    want = run(fresh, plan)
    assert_same(got, want)
    name = "journal" if what == "island" else "journal_ea"
    for W, n_dev in ((2, 4), (1, 2)):
        rows = _journal(os.path.join(d, f"{name}_{W}_0.jsonl"))
        el = [e for e in rows if e["kind"] == "elastic_resume"]
        assert len(el) == 1 and el[0]["from_mesh"]["n_devices"] == n_dev
        assert el[0]["to_mesh"]["n_devices"] == W


def test_format3_layout_and_refusals(groups, tmp_path):
    """The 4 ranks' island file: its row-sharded leaves hold one entry per
    distinct shard; with a shard dropped the file is refused; a corrupt
    newest file falls back to the one before it."""
    _ranks(groups, 4)
    src = groups["root"] / "w2" / "elastic" / "island"
    ck = cp.Checkpointer(str(src))
    path = ck.path_for(KILL_W4)
    with open(path, "rb") as f:
        payload = pickle.load(f)
    assert payload["format_version"] == 3 and cp.FORMAT_VERSION == 3
    assert payload["meta"]["mesh"]["n_devices"] == 4
    sharded = [pickle.loads(b) for b in payload["leaves"]]
    sharded = [x for x in sharded if isinstance(x, dict)
               and "__sharded__" in x]
    assert sharded and all(len(x["shards"]) == 4 for x in sharded)
    assert all(len({tuple(b) for b, _ in x["shards"]}) == 4
               for x in sharded)
    # an incomplete shard set is refused
    i = next(j for j, b in enumerate(payload["leaves"])
             if b"__sharded__" in b)
    leaf = pickle.loads(payload["leaves"][i])
    leaf["shards"] = leaf["shards"][1:]
    blob = pickle.dumps(leaf)
    payload["leaves"][i] = blob
    payload["crcs"][i] = __import__("zlib").crc32(blob)
    bad = str(tmp_path / "ckpt_00000099.pkl")
    with open(bad, "wb") as f:
        pickle.dump(payload, f)
    with pytest.raises(cp.CheckpointCorruptError, match="incomplete"):
        cp.restore_state(bad, device=CPU)
    # a corrupt newest file: the restore falls back to the one before (the
    # files the 2 ranks wrote)
    d = tmp_path / "fallback"
    d.mkdir()
    steps = [KILL_W4 + 1, KILL_W2]
    for s in steps:
        with open(ck.path_for(s), "rb") as f:
            data = f.read()
        with open(d / os.path.basename(ck.path_for(s)), "wb") as f:
            f.write(data)
    newest = d / os.path.basename(ck.path_for(steps[-1]))
    newest.write_bytes(newest.read_bytes()[:100])
    step, _ = cp.Checkpointer(str(d)).restore_latest(device=CPU)
    assert step == steps[-2]


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        sys.exit(child(sys.argv[2:]))
