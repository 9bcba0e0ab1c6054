"""The port's population probes against the JAX package's, on the CPU.

The same population (genomes, weighted values, valid, selection and
parent indices), made with numpy from a seed, goes through each probe of
``deap_tpu.telemetry.probes`` (called eagerly, as the JAX package's own
probe tests call them) and of ``deap_tpu_torch.telemetry.probes``, each
on a fresh meter, and the rows are compared key by key. Stated bounds:

- integer metrics (unique rows, stagnation age, lineage depths,
  quarantine counts) and every metric computed by exact operations
  (maxima, medians, differences of them, counts over a pool below 2**24)
  are bitwise: ``FitnessProbe``, ``QuarantineProbe``, the lineage gauges
  and ``sel_loss_diversity``, ``div_unique_frac``, ``gp_clone_rate``
  (host and hashed) and ``gp_mean_size``;
- ``DiversityProbe``'s moments (``div_msd``, ``div_pdist_*``) are sums
  whose order differs between XLA and PyTorch: within
  ``DIV_RTOL`` (1e-5) of ``max|g|² · D``, the largest squared distance
  (observed below 6e-7 over 20 seeds, bitstrings and reals);
- ``sel_eff_parents`` and ``gp_opcode_entropy`` are float sums of up to
  the pool's terms: relative ``SUM_RTOL`` (1e-5);
- ``FrontProbe``'s ``hv_proxy`` against the JAX ``_hv_slab`` on the same
  points: relative ``HV_RTOL`` (1e-5), the other front metrics relative
  1e-5 of the objectives' range; ``exact_hypervolume`` bitwise (the same
  WFG on the same float64 points);
- histogram buckets bitwise, values on every edge and out of range.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deap_tpu import gp as jgp
from deap_tpu.core.fitness import FitnessSpec as JSpec
from deap_tpu.core.population import Population as JPop
from deap_tpu.telemetry import meter as jmeter
from deap_tpu.telemetry import probes as jp
from deap_tpu_torch import convert
from deap_tpu_torch import gp as tgp
from deap_tpu_torch.telemetry import meter as tmeter
from deap_tpu_torch.telemetry import probes as tp

DIV_RTOL = 1e-5
SUM_RTOL = 1e-5
HV_RTOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _trace_state_shim():
    """jax 0.9 moved ``trace_state_clean`` out of ``jax.core``, where the
    JAX package's ``PrimitiveSet.arity_table`` calls it; alias it in this
    test process only."""
    with pytest.MonkeyPatch.context() as mp:
        if not hasattr(jax.core, "trace_state_clean"):
            mp.setattr(jax.core, "trace_state_clean",
                       jax._src.core.trace_state_clean, raising=False)
        yield


def _pops(genomes, fitness, valid, weights):
    j = JPop(genomes=jax.tree_util.tree_map(jnp.asarray, genomes),
             fitness=jnp.asarray(fitness), valid=jnp.asarray(valid),
             spec=JSpec(weights))
    t = convert.population_from_arrays(genomes, fitness, valid, weights,
                                       device="cpu")
    return j, t


def _rows(jprobe, tprobe, jpop, tpop, gens=1, ctxs=None, **ctx):
    """Each generation's JAX and port rows, probes on fresh meters."""
    jm, tm = jmeter.Meter(), tmeter.Meter()
    jprobe.declare(jm)
    tprobe.declare(tm)
    js, ts = jm.init(), tm.init(device="cpu")
    out = []
    for g in range(gens):
        c = dict(ctx, **(ctxs[g] if ctxs else {}))
        jc = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
              for k, v in c.items()}
        tc = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
              for k, v in c.items()}
        js = jprobe(jm, js, pop=jpop, gen=g, **jc)
        ts = tprobe(tm, ts, pop=tpop, gen=g, **tc)
        out.append((jm.row(js), tm.row(ts)))
    return out


def _same(a, b):
    return a == b or (a != a and b != b)  # NaN == NaN here


def _population(seed, kind):
    rng = np.random.default_rng(seed)
    n, L = int(rng.integers(1, 600)), int(rng.integers(1, 110))
    if kind == "bits":
        g = rng.random((n, L)) < 0.5
    else:
        g = rng.normal(0, 3, (n, L)).astype(np.float32)
    if n > 4:
        g[: n // 3] = g[n - n // 3:]  # clones
    f = rng.normal(0, 10, (n, 1)).astype(np.float32)
    return rng, g, f, rng.random(n) < 0.8


# ---------------------------------------------------------- the registry --

def test_registry_and_metric_names_equal_the_jax_package():
    assert list(tp.PROBE_REGISTRY) == list(jp.PROBE_REGISTRY)
    for name, cls in jp.PROBE_REGISTRY.items():
        assert tp.PROBE_REGISTRY[name].metric_names == cls.metric_names
    assert tp.__all__ == jp.__all__
    assert tp.HealthMonitor.ALARM_KINDS == jp.HealthMonitor.ALARM_KINDS


# ------------------------------------------------------------- helpers --

@pytest.mark.parametrize("n,k", [(1, 1), (7, 3), (100, 256), (1000, 256),
                                 (100_003, 1024), (5, 0)])
def test_strided_rows_equal(n, k):
    assert tp._strided(n, k, "cpu").tolist() == \
        np.asarray(jp._strided(n, k)).tolist()


@pytest.mark.parametrize("seed", range(6))
def test_unique_count_equals_the_jax_count(seed):
    rng = np.random.default_rng(seed)
    n, d = int(rng.integers(1, 400)), int(rng.integers(1, 70))
    rows = rng.integers(-3, 3, (n, d)).astype(np.int32)
    rows[: n // 2] = rows[n - n // 2:]
    rows = np.concatenate([rows, rng.integers(
        -2**31, 2**31, (7, d), dtype=np.int64).astype(np.int32)])
    assert int(tp._unique_count(torch.from_numpy(rows))) == \
        int(jp._unique_count(jnp.asarray(rows)))


@pytest.mark.parametrize("seed", range(4))
def test_nanmedian_equals_jnp(seed):
    rng = np.random.default_rng(seed)
    for n in (1, 2, 5, 64, 101):
        x = rng.normal(size=n).astype(np.float32)
        x[rng.random(n) < 0.3] = np.nan
        for arr in (x, np.full(n, np.nan, np.float32)):
            got = float(tp._nanmedian(torch.from_numpy(arr)))
            want = float(jnp.nanmedian(jnp.asarray(arr)))
            assert _same(got, want), (got, want)


# ----------------------------------------------------------- diversity --

@pytest.mark.parametrize("kind", ["bits", "real"])
@pytest.mark.parametrize("seed", range(5))
@pytest.mark.parametrize("full_unique", [False, True])
def test_diversity_probe(kind, seed, full_unique):
    rng, g, f, v = _population(seed, kind)
    sample = int(rng.integers(1, 400))
    jpop, tpop = _pops(g, f, v, (1.0,))
    (a, b), = _rows(jp.DiversityProbe(sample, full_unique),
                    tp.DiversityProbe(sample, full_unique), jpop, tpop)
    assert list(a) == list(b)
    scale = max(1.0, float(np.abs(g.astype(np.float32)).max()) ** 2
                * g.shape[1])
    for k in ("div_msd", "div_pdist_mean", "div_pdist_std",
              "div_pdist_min"):
        assert abs(a[k] - b[k]) <= DIV_RTOL * scale, (k, a[k], b[k])
    assert a["div_unique_frac"] == b["div_unique_frac"]


# ------------------------------------------------------ tree diversity --

@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("host", [False, True])
def test_tree_diversity_probe(seed, host):
    pset_j, pset_t = jgp.math_set(1), tgp.math_set(1)
    n, ML = 40 + seed * 17, 24
    trees = jax.vmap(jgp.make_generator(pset_j, ML, 1, 3, "half_and_half"))(
        jax.random.split(jax.random.key(seed), n))
    genomes = {k: np.array(v) for k, v in trees.items()}
    genomes["nodes"][: n // 4] = genomes["nodes"][n - n // 4:]
    genomes["consts"][: n // 4] = genomes["consts"][n - n // 4:]
    genomes["length"][: n // 4] = genomes["length"][n - n // 4:]
    f = np.random.default_rng(seed).normal(size=(n, 1)).astype(np.float32)
    jpop, tpop = _pops(genomes, f, np.ones(n, bool), (1.0,))
    ctx = {}
    if host:
        from deap_tpu.gp.interpreter import _dedup_rows
        first, _ = _dedup_rows(genomes["nodes"], genomes["consts"],
                               genomes["length"])
        ctx["host_clone_rate"] = 1.0 - len(first) / n
    (a, b), = _rows(jp.TreeDiversityProbe(pset_j),
                    tp.TreeDiversityProbe(pset_t), jpop, tpop, **ctx)
    assert list(a) == list(b)
    assert a["gp_clone_rate"] == b["gp_clone_rate"]
    assert a["gp_mean_size"] == b["gp_mean_size"]
    assert abs(a["gp_opcode_entropy"] - b["gp_opcode_entropy"]) <= \
        SUM_RTOL * max(1.0, abs(a["gp_opcode_entropy"]))


# ------------------------------------------------------------ fitness --

@pytest.mark.parametrize("kind", ["bits", "real"])
@pytest.mark.parametrize("seed", range(5))
def test_fitness_probe_over_generations(kind, seed):
    rng, g, f, v = _population(seed, kind)
    f[rng.random(f.shape[0]) < 0.1] = np.nan
    sample = int(rng.integers(1, 2000))
    jpop, tpop = _pops(g, f, v, (1.0,))
    pairs = _rows(jp.FitnessProbe(0.5, sample), tp.FitnessProbe(0.5, sample),
                  jpop, tpop, gens=4)
    for a, b in pairs:
        assert list(a) == list(b)
        for k in a:
            assert _same(a[k], b[k]), (k, a[k], b[k])


# --------------------------------------------------------- quarantine --

def test_quarantine_probe():
    from deap_tpu_torch.resilience import QUARANTINE_PENALTY
    rng = np.random.default_rng(3)
    f = rng.normal(size=(50, 2)).astype(np.float32)
    f[rng.random(50) < 0.3, 1] = np.float32(QUARANTINE_PENALTY)
    v = rng.random(50) < 0.9
    jpop, tpop = _pops(rng.random((50, 4)) < 0.5, f, v, (1.0, -1.0))
    for a, b in _rows(jp.QuarantineProbe(), tp.QuarantineProbe(), jpop,
                      tpop, gens=3):
        assert a == b and a["quarantined"] > 0


# ---------------------------------------------------------- selection --

@pytest.mark.parametrize("every", [1, 3])
@pytest.mark.parametrize("seed", range(3))
def test_selection_probe_with_lineage(every, seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(2, 500))
    pool = n + int(rng.integers(0, 300))
    jpop, tpop = _pops(rng.random((n, 3)) < 0.5,
                       rng.normal(size=(n, 1)).astype(np.float32),
                       np.ones(n, bool), (1.0,))
    ctxs = []
    for _ in range(5):
        sel = rng.integers(0, pool, n).astype(np.int32)
        ctxs.append({"sel_idx": sel, "sel_pool": pool,
                     "parent_idx": rng.integers(0, n, n).astype(np.int32)})
    for a, b in _rows(jp.SelectionProbe(n=n, every=every),
                      tp.SelectionProbe(n=n, every=every), jpop, tpop,
                      gens=5, ctxs=ctxs):
        assert list(a) == list(b)
        for k in ("sel_loss_diversity", "lineage_depth_mean",
                  "lineage_depth_max"):
            assert a[k] == b[k], k
        assert abs(a["sel_eff_parents"] - b["sel_eff_parents"]) <= \
            SUM_RTOL * max(1.0, a["sel_eff_parents"])


# -------------------------------------------------------------- front --

@pytest.mark.parametrize("m", [1, 2, 3])
@pytest.mark.parametrize("seed", range(4))
def test_front_probe_and_hv_slab(m, seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 700))
    w = rng.random((n, m)).astype(np.float32)
    w[: n // 5] = w[n - n // 5:]  # duplicates
    w[rng.random(n) < 0.05] = -np.inf  # invalid rows
    ref = tuple(float(x) for x in -0.1 - rng.random(m))
    jpop, tpop = _pops(rng.random((n, 2)) < 0.5, w, np.ones(n, bool),
                       (1.0,) * m)
    (a, b), = _rows(jp.FrontProbe(ref, max_points=256),
                    tp.FrontProbe(ref, max_points=256), jpop, tpop)
    assert list(a) == list(b)
    assert a["front_frac"] == b["front_frac"]
    assert abs(a["hv_proxy"] - b["hv_proxy"]) <= HV_RTOL * abs(a["hv_proxy"])
    for k in ("front_spread", "front_spacing"):
        assert abs(a[k] - b[k]) <= 1e-5 * max(1.0, abs(a[k])), k
    P = np.maximum(w[:300], np.asarray(ref, np.float32)[None, :])
    want = float(jp._hv_slab(jnp.asarray(P), jnp.asarray(ref, jnp.float32)))
    got = float(tp._hv_slab(torch.from_numpy(P),
                            torch.tensor(ref, dtype=torch.float32)))
    assert abs(got - want) <= HV_RTOL * abs(want)
    assert tp.exact_hypervolume(w, ref) == jp.exact_hypervolume(w, ref)


def test_front_probe_exact_events_equal():
    from deap_tpu.telemetry.journal import RunJournal as JJournal
    from deap_tpu_torch.telemetry import RunJournal as TJournal
    import tempfile, os
    rng = np.random.default_rng(9)
    w = rng.random((200, 2)).astype(np.float32)
    jpop, tpop = _pops(rng.random((200, 2)) < 0.5, w, np.ones(200, bool),
                       (1.0, 1.0))
    with tempfile.TemporaryDirectory() as d:
        events = []
        for J, mod, pop, tag in ((JJournal, jp, jpop, "j"),
                                 (TJournal, tp, tpop, "t")):
            path = os.path.join(d, tag + ".jsonl")
            with J(path) as jr:
                m = (jmeter.Meter() if tag == "j" else tmeter.Meter())
                probe = mod.FrontProbe((-0.5, -0.5), exact_every=2)
                probe.declare(m)
                st = m.init() if tag == "j" else m.init(device="cpu")
                for gen in range(5):
                    st = probe(m, st, pop=pop, gen=gen, journal=jr)
                jax.effects_barrier()
            from deap_tpu_torch.telemetry import read_journal
            events.append([(r["gen"], r["value"], r["n_points"])
                           for r in read_journal(path)
                           if r["kind"] == "hv_exact"])
        assert sorted(events[0]) == events[1] and len(events[1]) == 3


# ------------------------------------------------------------ compose --

def test_compose_probes_equals_applying_each():
    rng, g, f, v = _population(2, "bits")
    jpop, tpop = _pops(g, f, v, (1.0,))
    n = f.shape[0]
    jc = jp.compose_probes(jp.DiversityProbe(), jp.FitnessProbe())
    tc = tp.compose_probes(tp.DiversityProbe(), tp.FitnessProbe())
    assert tc.metric_names == jc.metric_names
    (a, b), = _rows(jc, tc, jpop, tpop)
    assert list(a) == list(b) and a["fit_gap"] == b["fit_gap"]
    assert n > 0


# ------------------------------------------------------ health monitor --

def _row_stream(seed):
    rng = np.random.default_rng(seed)
    rows = []
    best = 0.0
    for gen in range(40):
        if rng.random() < 0.3:
            best += float(rng.random())
        row = {"gen": gen, "best": best, "div_msd": float(rng.random() * 2),
               "gp_clone_rate": float(rng.random()),
               "div_unique_frac": float(rng.random())}
        if rng.random() < 0.1:
            row["mean"] = float("nan")
        if rng.random() < 0.1:
            row["quarantined"] = int(rng.integers(1, 5))
        if seed % 2:
            row["stagnation_age"] = int(rng.integers(0, 6))
        rows.append(row)
    return rows


@pytest.mark.parametrize("seed", range(4))
def test_health_monitor_fires_what_the_jax_monitor_fires(seed):
    kw = dict(clone_rate_max=0.8, diversity_floor=0.3, premature_min_gen=30,
              stagnation_window=4, improvement_eps=0.1,
              early_stop=("zero_improvement",))
    mons = (jp.HealthMonitor(**kw), tp.HealthMonitor(**kw))
    for row in _row_stream(seed):
        assert mons[0].check_row(dict(row)) == mons[1].check_row(dict(row))
    assert mons[0].alarms == mons[1].alarms
    assert mons[0].stop_requested == mons[1].stop_requested
    for name in ("program_drift", "driver_stall", "canary"):
        assert getattr(mons[0], name)(gen=3, x=1) == \
            getattr(mons[1], name)(gen=3, x=1)


# --------------------------------------------------------- histograms --

@pytest.mark.parametrize("lo,hi,bins", [(0.1, 0.9, 7), (0.0, 100.0, 16),
                                        (-3.0, 7.0, 13), (0.0, 3.0, 10),
                                        (-1e-3, 2e-3, 3)])
def test_meter_histogram_buckets_bitwise(lo, hi, bins):
    rng = np.random.default_rng(bins)
    x = (rng.random(20000) * (hi - lo) * 1.4 + lo - 0.2 * (hi - lo)
         ).astype(np.float32)
    edges = (np.float32(lo) + np.arange(bins + 1, dtype=np.float32)
             * np.float32((hi - lo) / bins))
    x = np.concatenate([x, edges, np.nextafter(edges, np.float32(np.inf)),
                        np.nextafter(edges, np.float32(-np.inf)),
                        np.asarray([np.nan, np.inf, -np.inf, lo, hi],
                                   np.float32)]).astype(np.float32)
    mask = rng.random(x.shape[0]) < 0.7
    jm, tm = jmeter.Meter(), tmeter.Meter()
    for m in (jm, tm):
        m.histogram("h", lo, hi, bins)
        m.histogram("hm", lo, hi, bins)
    js, ts = jm.init(), tm.init(device="cpu")
    for _ in range(2):
        js = jm.observe(js, "h", jnp.asarray(x))
        js = jm.observe(js, "hm", jnp.asarray(x), mask=jnp.asarray(mask))
        ts = tm.observe(ts, "h", torch.from_numpy(x))
        ts = tm.observe(ts, "hm", torch.from_numpy(x),
                        mask=torch.from_numpy(mask))
    assert jm.row(js) == tm.row(ts)
    assert sum(tm.row(ts)["h"]) == 2 * x.shape[0]
