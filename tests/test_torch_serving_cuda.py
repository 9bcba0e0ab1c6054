"""The serving run axis through K1, J1 and K9 on the card.

These tests need a CUDA card and the CUDA toolkit; they skip without a
card. On a machine with one, from the repository's root (they import
``chip_smoke`` for the serving buckets' builders):

    python -m pytest tests/test_torch_serving_cuda.py -m cuda -q --noconftest

Tolerance: bitwise. Every lane of a batch equals its solo loop on the
card (populations, logbooks, halls of fame, strategy states: equal wire
digests). The OneMax, float32 Rastrigin (``ea_simple``, (μ, λ),
(μ + λ)) and island buckets launch K1 once a generation over every
lane's rows, the 'jacobi' CMA-ES bucket J1 once a generation over
``[R, d, d]`` (equal to J1 on each matrix alone and to its plain
version), the GP bucket K9 once an evaluation over every lane's trees
(equal to its plain dispatch).
"""

import pytest
import torch

import chip_smoke as cs
from deap_tpu_torch import Toolbox, algorithms, ops
from deap_tpu_torch.gp.loop import make_symbreg_loop
from deap_tpu_torch.ops import kernels, linalg, variation
from deap_tpu_torch.serving import (GpMultiRunEngine, IslandMultiRunEngine,
                                    MultiRunEngine, Scheduler)
from deap_tpu_torch.serving.wire import result_digest
from deap_tpu_torch.support.stats import fitness_stats

pytestmark = pytest.mark.cuda
R = 64


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _gen(dev, seed):
    return torch.Generator(device=dev).manual_seed(seed)


def test_onemax_lanes_one_k1_a_generation(card):
    tb = cs._onemax_toolbox(Toolbox, ops)
    gens, pops, ngens, hypers = cs.sv_onemax(card, R)
    eng = MultiRunEngine("ea_simple", tb, stats=fitness_stats(),
                         halloffame_size=2, device=card)
    cap = cs._Capture(kernels.fused_variation)
    algorithms.fused_variation = cap
    try:
        before = kernels.fused_variation.launches
        batch = eng.pack([eng.lane_init(g, p, n, h) for g, p, n, h in
                          zip(gens, pops, ngens, hypers)])
        batch, segs = cs.sv_run(eng, batch, 4)
        launched = kernels.fused_variation.launches - before
    finally:
        algorithms.fused_variation = kernels.fused_variation
    assert launched == max(ngens)
    (g, src, partner, cx_row, lo, hi, do_mut, mask, arg) = cap.args
    want = variation.apply_variation(g, src.long(), partner.long(), cx_row,
                                     lo, hi, do_mut, mask, arg,
                                     cap.kwargs["mut_kind"]).to(g.dtype)
    assert torch.equal(cap.out, want)
    for i in range(R):
        solo = algorithms.ea_simple(_gen(card, 10_000 + i), pops[i], tb,
                                    hypers[i]["cxpb"], hypers[i]["mutpb"],
                                    ngens[i], stats=fitness_stats(),
                                    halloffame_size=2, device=card)
        assert result_digest(solo) == result_digest(
            cs.sv_result(eng, batch, segs, i)), i


@pytest.mark.parametrize("family", ["ea_simple", "ea_mu_comma_lambda",
                                    "ea_mu_plus_lambda"])
def test_float_lanes_one_k1_a_generation(card, family):
    """Rastrigin on float32 genomes: K1's float plane once a generation
    over every lane's rows, each lane's float-valued evaluation in its
    own shape, every lane equal to its solo loop."""
    tb, gens, pops, ngens, hypers = cs.sv_real(card, R)
    kw = {} if family == "ea_simple" else {"mu": cs.SV_MU,
                                           "lambda_": cs.SV_LAMBDA}
    eng = MultiRunEngine(family, tb, stats=fitness_stats(),
                         halloffame_size=2, device=card, **kw)
    cap = cs._Capture(kernels.fused_variation)
    algorithms.fused_variation = cap
    try:
        before = kernels.fused_variation.launches
        batch = eng.pack([eng.lane_init(g, p, n, h) for g, p, n, h in
                          zip(gens, pops, ngens, hypers)])
        batch, segs = cs.sv_run(eng, batch, 4)
        launched = kernels.fused_variation.launches - before
    finally:
        algorithms.fused_variation = kernels.fused_variation
    assert launched == max(ngens)
    (g, src, partner, cx_row, lo, hi, do_mut, mask, arg) = cap.args
    assert g.dtype == torch.float32
    want = variation.apply_variation(g, src.long(), partner.long(), cx_row,
                                     lo, hi, do_mut, mask, arg,
                                     cap.kwargs["mut_kind"]).to(g.dtype)
    assert cs.bitwise_equal(cap.out, want)
    solo_fn = getattr(algorithms, family)
    args = () if family == "ea_simple" else (cs.SV_MU, cs.SV_LAMBDA)
    for i in range(R):
        solo = solo_fn(_gen(card, 80_000 + i), pops[i], tb, *args,
                       hypers[i]["cxpb"], hypers[i]["mutpb"], ngens[i],
                       stats=fitness_stats(), halloffame_size=2,
                       device=card)
        assert result_digest(solo) == result_digest(
            cs.sv_result(eng, batch, segs, i)), i


@pytest.mark.parametrize("impl", ["lapack", "jacobi"])
def test_cma_lanes_and_one_j1_a_generation(card, impl):
    strat, tb, states, ngens = cs.sv_cma(card, impl, R)
    eng = MultiRunEngine("ea_generate_update", tb, spec=strat.spec,
                         state_template=states[0], device=card)
    cap = cs._Capture(strat._eigh)
    strat._eigh = cap
    try:
        before = linalg.eigh_jacobi.launches
        batch = eng.pack([eng.lane_init(_gen(card, 60_000 + r), states[r],
                                        ngens[r]) for r in range(R)])
        batch, segs = cs.sv_run(eng, batch, 4)
        launched = linalg.eigh_jacobi.launches - before
    finally:
        strat._eigh = cap.fn
    assert launched == (max(ngens) if impl == "jacobi" else 0)
    if impl == "jacobi":
        C = cap.args[0]
        w, V = cap.out
        pw, pV = linalg.eigh_jacobi_plain(C)
        assert torch.equal(w, pw) and torch.equal(V, pV)
        for i in range(R):
            wi, Vi = linalg.eigh_jacobi(C[i].contiguous())
            assert torch.equal(wi, w[i]) and torch.equal(Vi, V[i]), i
    for i in range(R):
        solo = algorithms.ea_generate_update(_gen(card, 60_000 + i),
                                             states[i], tb, ngens[i],
                                             spec=strat.spec, device=card)
        assert result_digest(solo) == result_digest(
            cs.sv_result(eng, batch, segs, i)), i


def test_gp_lanes_one_k9_an_evaluation(card):
    spec, gens, founders, ngens, hypers = cs.sv_gp(card, 8)
    eng = GpMultiRunEngine(spec, device=card)
    batch = eng.pack([eng.lane_init(g, f, n, h) for g, f, n, h in
                      zip(gens, founders, ngens, hypers)])
    before = kernels.gp_grouped_dispatch.launches
    batch, segs = cs.sv_run(eng, batch, 5)
    assert kernels.gp_grouped_dispatch.launches - before == max(ngens)
    keys = ("genomes", "depths", "fitness", "best_genome", "nevals",
            "best_fitness")
    for i in range(8):
        solo = make_symbreg_loop(spec.pset, cs.SV_GP_ML, spec.X, spec.y,
                                 device=card, **hypers[i])
        want = solo(_gen(card, 30_000 + i), founders[i], ngens[i])
        got = cs.sv_result(eng, batch, segs, i)
        assert result_digest({k: want[k] for k in keys}) == result_digest(
            {k: got[k] for k in keys}), i


def test_island_lanes_one_k1_a_generation(card):
    tb, spec, gens, inits, ngens, hypers = cs.sv_island(card, 6)
    eng = IslandMultiRunEngine(tb, spec, device=card)
    batch = eng.pack([eng.lane_init(g, p, n, h) for g, p, n, h in
                      zip(gens, inits, ngens, hypers)])
    before = kernels.fused_variation.launches
    batch, segs = cs.sv_run(eng, batch, 3)
    assert kernels.fused_variation.launches - before == \
        max(ngens) * spec.freq
    for i in range(6):
        solo = cs.sv_island_solo(tb, spec, _gen(card, 50_000 + i), inits[i],
                                 ngens[i], hypers[i])
        assert result_digest(solo) == result_digest(
            cs.sv_result(eng, batch, segs, i)), i


def test_scheduler_mixed_buckets_equal_solo(card, tmp_path):
    jobs, solo = cs._sv_jobs(torch, card)
    with Scheduler(str(tmp_path), max_lanes=2, segment_len=2,
                   fair_quantum=1) as sched:
        for j in jobs:
            sched.submit(j)
        res = sched.run()
    for tid, want in solo.items():
        assert cs._sv_digest(res[tid]) == cs._sv_digest(want), tid
