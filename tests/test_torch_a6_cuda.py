"""The rest of the strategies, moving peaks, NSGA-III and dense SPEA2 on
the card.

These tests need a CUDA card and the CUDA toolkit; they skip without a
card. On a machine with one, from the repository's root:

    python -m pytest tests/test_torch_a6_cuda.py -m cuda -q --noconftest

Each step on CUDA tensors is held against the same step on CPU tensors of
the same draws (drawn on the CPU): bitwise where every operation rounds
alone on both (PSO, DE, PBIL, EMNA's samples, the swarms with the
``'nuvd'`` cloud, moving peaks' values and changes, dense SPEA2); within
``multiswarm.POW_ULPS`` where a cloud's radius goes through ``** (1/dim)``;
within ``eda.EMNA_RTOL`` and ``movingpeaks.SUM_RTOL`` where a sum runs in
another order. NSGA-III: the ranks and memory bitwise, the niching loop
on both forms of draws bitwise the CPU's on the card's plan, and K7
launched once a front peeled.
"""

import numpy as np
import pytest
import torch

from chip_smoke import nsga3_generation, two_peaks
from deap_tpu_torch import benchmarks, convert, mo
from deap_tpu_torch.benchmarks import movingpeaks as mp
from deap_tpu_torch.core.fitness import FitnessSpec
from deap_tpu_torch.device import make_generator
from deap_tpu_torch.mo import emo
from deap_tpu_torch.ops import kernels
from deap_tpu_torch.strategies import (EMNA, PBIL, PSO,
                                       DifferentialEvolution, MultiSwarmPSO,
                                       SpeciationPSO, eda, multiswarm)

pytestmark = pytest.mark.cuda
CPU = torch.device("cpu")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _same(a, b):
    a, b = a.cpu(), b.cpu()
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


def _sq(x):
    acc = x[..., 0] * x[..., 0]
    for c in range(1, x.shape[-1]):
        acc = acc + x[..., c] * x[..., c]
    return acc


def _draws_to(dr, dev):
    return type(dr)(*(getattr(dr, f).to(dev)
                      for f in dr.__dataclass_fields__))


def test_entry_points_default_to_the_card(card):
    assert PSO(_sq).device.type == "cuda"
    assert PBIL(8).initial_state().prob_vector.device.type == "cuda"
    assert EMNA([0.0] * 3, 1.0, 2, 4).initial_state().centroid.is_cuda
    assert MultiSwarmPSO(two_peaks, -1.0, 1.0).device.type == "cuda"
    assert SpeciationPSO(two_peaks, -1.0, 1.0, 1.0).device.type == "cuda"


@pytest.mark.parametrize("chi", [None, 0.729843788])
def test_pso_steps_equal_the_cpu(card, chi):
    gc = make_generator(1, "cpu")
    kw = dict(smin=0.001, smax=3.0) if chi is None else dict(chi=chi)
    p = {d: PSO(_sq, spec=FitnessSpec((-1.0,)), device=d, **kw)
         for d in (CPU, card)}
    s = p[CPU].init(gc, 1001, 9, -4.0, 4.0, -1.0, 1.0)
    st = {CPU: s, card: convert.swarm_state_from_arrays(
        **convert.swarm_state_to_arrays(s), device=card)}
    for _ in range(5):
        u1, u2 = p[CPU].move_draws(gc, st[CPU])
        for d in (CPU, card):
            st[d] = p[d].move(p[d].update_bests(st[d]), u1.to(d), u2.to(d))
    for k in convert.SWARM_FIELDS:
        assert _same(getattr(st[card], k), getattr(st[CPU], k)), k


def test_de_steps_equal_the_cpu(card):
    gc = make_generator(2, "cpu")
    de = DifferentialEvolution(_sq, F=0.5, CR=0.9)
    g0 = torch.rand((1001, 11), generator=gc) * 6 - 3
    pops = {CPU: convert.population_from_arrays(
        g0.numpy(), _sq(g0)[:, None].numpy(), np.ones(1001, bool), (-1.0,),
        device="cpu")}
    pops[card] = pops[CPU].to(card)
    for _ in range(5):
        draws = de.draws(gc, 1001, 11)
        for d in (CPU, card):
            pops[d] = de.step_from_draws(pops[d], *(t.to(d) for t in draws))
    assert _same(pops[card].genomes, pops[CPU].genomes)
    assert _same(pops[card].fitness, pops[CPU].fitness)


def test_pbil_and_emna_equal_the_cpu(card):
    gc = make_generator(3, "cpu")
    pb = {d: PBIL(ndim=64, lambda_=33, mut_prob=0.3, device=d)
          for d in (CPU, card)}
    st = {d: pb[d].initial_state(make_generator(0, d)) for d in (CPU, card)}
    for _ in range(5):
        u = torch.rand((33, 64), generator=gc)
        do_mut = torch.rand(64, generator=gc) < 0.3
        bits = (torch.rand(64, generator=gc) < 0.5).float()
        for d in (CPU, card):
            x = pb[d].sample(st[d], u.to(d))
            st[d] = pb[d].update_from_draws(st[d], x, x.sum(-1),
                                            do_mut.to(d), bits.to(d))
    assert _same(st[card].prob_vector, st[CPU].prob_vector)
    em = {d: EMNA([2.0] * 30, 3.0, 250, 1000, device=d) for d in (CPU, card)}
    es = {d: em[d].initial_state() for d in (CPU, card)}
    for _ in range(3):
        z = torch.randn((1000, 30), generator=gc)
        xs = {d: em[d].sample(es[d], z.to(d)) for d in (CPU, card)}
        assert _same(xs[card], xs[CPU])
        nxt = {d: em[d].update(es[d], xs[d], benchmarks.sphere(xs[d]))
               for d in (CPU, card)}
        c = nxt[CPU].centroid
        assert float((nxt[card].centroid.cpu() - c).abs().max()) \
            <= eda.EMNA_RTOL * float(c.abs().max())
        assert abs(float(nxt[card].sigma) - float(nxt[CPU].sigma)) \
            <= eda.EMNA_RTOL * float(nxt[CPU].sigma)
        es = {d: nxt[CPU] if d == CPU else convert.emna_state_from_arrays(
            **convert.emna_state_to_arrays(nxt[CPU]), device=card)
            for d in (CPU, card)}


def _swarm_pair(card, dist, shift):
    land = lambda x: two_peaks(x - shift["v"])  # noqa: E731
    ms = {d: MultiSwarmPSO(land, -6.0, 6.0, nexcess=2, dist=dist, device=d)
          for d in (CPU, card)}
    sp = {d: SpeciationPSO(land, -6.0, 6.0, rs=2.0, pmax_size=6, device=d)
          for d in (CPU, card)}
    return ms, sp


def test_swarm_steps_equal_the_cpu(card):
    """12 steps of both swarms through a change of the landscape,
    bitwise (the ``'nuvd'`` cloud: no ``pow``)."""
    gc = make_generator(4, "cpu")
    shift = {"v": 0.0}
    ms, sp = _swarm_pair(card, "nuvd", shift)
    s = ms[CPU].init(gc, nswarms=4, nparticles=6, dim=3, capacity=10)
    mst = {CPU: s, card: convert.multiswarm_state_from_arrays(
        **convert.multiswarm_state_to_arrays(s), device=card)}
    s = sp[CPU].init(gc, 90, 3)
    spt = {CPU: s, card: convert.speciation_state_from_arrays(
        **convert.speciation_state_to_arrays(s), device=card)}
    for step in range(12):
        shift["v"] = 0.5 if step >= 8 else 0.0
        dr, drs = ms[CPU].draws(gc, mst[CPU]), sp[CPU].draws(gc, spt[CPU])
        for d in (CPU, card):
            mst[d] = ms[d].step_from_draws(mst[d], _draws_to(dr, d))
            spt[d] = sp[d].step_from_draws(spt[d], _draws_to(drs, d))
        for k in convert.MULTISWARM_FIELDS:
            assert _same(getattr(mst[card], k), getattr(mst[CPU], k)), k
        for k in convert.SPECIATION_FIELDS:
            assert _same(getattr(spt[card], k), getattr(spt[CPU], k)), k
    x = torch.rand((200, 4), generator=gc) * 12 - 6
    f = two_peaks(x)
    for a, b in zip(multiswarm.species_seeds(x.to(card), f.to(card), 2.5),
                    multiswarm.species_seeds(x, f, 2.5)):
        assert _same(a, b)


@pytest.mark.parametrize("dist", ["gaussian", "uvd"])
def test_quantum_clouds_within_pow_ulps_of_the_cpu(card, dist):
    gc = make_generator(5, "cpu")
    pos, u = multiswarm._cloud_draws(gc, (64, 32, 5), dist)
    centre = torch.rand((64, 1, 5), generator=gc) * 10
    a = multiswarm._quantum_cloud(pos.to(card), u.to(card), centre.to(card),
                                  0.7, dist).cpu()
    b = multiswarm._quantum_cloud(pos, u, centre, 0.7, dist)
    off = (b - centre).abs()
    ulp = torch.from_numpy(np.spacing(off.numpy()))
    bound = multiswarm.POW_ULPS * ulp + torch.from_numpy(
        np.spacing(b.abs().numpy()))
    assert bool(((a - b).abs() <= bound).all())


def test_movingpeaks_equal_the_cpu(card):
    gc = make_generator(6, "cpu")
    for scenario, dim in (("SCENARIO_1", 2), ("SCENARIO_2", 5),
                          ("SCENARIO_3", 5)):
        cfg = mp.MovingPeaksConfig(dim=dim, **{**getattr(mp, scenario),
                                               "period": 500})
        st = mp.mp_init(gc, cfg)
        arrays = convert.movingpeaks_state_to_arrays(st)
        fields = ("position", "height", "width", "last_change")
        mps = {CPU: st, card: convert.movingpeaks_state_from_arrays(
            *(arrays[f] for f in fields), arrays["nevals"],
            arrays["current_error"], arrays["offline_error_sum"], seed=0,
            device=card)}
        for exact in (False, True):
            xs = torch.rand((777, dim), generator=gc) * 100
            d3 = mp.change_peaks_draws(gc, mps[CPU])
            vals = {}
            for d in (CPU, card):
                # the batch crosses the period: a change drawn from d3
                mp_draws = mp.change_peaks_draws
                mp.change_peaks_draws = lambda g, s, d=d: tuple(
                    t.to(d) for t in d3)
                try:
                    mps[d], vals[d] = mp.mp_evaluate(cfg, mps[d], xs.to(d),
                                                     exact=exact)
                finally:
                    mp.change_peaks_draws = mp_draws
            assert _same(vals[card], vals[CPU]), (scenario, exact)
            for k in fields:
                assert _same(getattr(mps[card], k), getattr(mps[CPU], k)), k
            assert mps[card].nevals == mps[CPU].nevals
            a = float(mps[card].offline_error_sum)
            b = float(mps[CPU].offline_error_sum)
            assert abs(a - b) <= mp.SUM_RTOL * abs(b)


def test_sel_spea2_equals_the_cpu(card):
    gc = make_generator(7, "cpu")
    f1 = torch.sort(torch.rand(400, generator=gc)).values
    fronts = [-torch.stack([f1, 1.0 - torch.sqrt(f1)], 1),
              -torch.rand((400, 3), generator=gc),
              torch.repeat_interleave(torch.stack(
                  [torch.linspace(0, 10, 100),
                   10 - torch.linspace(0, 10, 100)], 1), 2, 0)]
    for w, k in zip(fronts, (150, 150, 130)):
        got = mo.sel_spea2(None, w.to(card), k)
        assert _same(got, mo.sel_spea2(None, w, k))


def test_nsga3_on_the_card(card):
    """Ranks and memory bitwise the CPU's; the niching loop on the card's
    plan bitwise the CPU's, on the reference's draws and on
    ``nsga3_draws``'; every niche equal but where two reference
    directions tie within 1e-5."""
    gc = make_generator(8, "cpu")
    w = -benchmarks.dtlz2(torch.rand((4096, 12), generator=gc), 3)
    ref = mo.uniform_reference_points(3, 12)
    pc = emo.nsga3_plan(w, 2048, ref)
    pd = emo.nsga3_plan(w.to(card), 2048, ref.to(card))
    # the card peels until k rows are ranked (the rest keep rank n); the
    # CPU's exact engine ranks every row
    peeled = pd.ranks.cpu() < 4096
    assert _same(pd.ranks.cpu()[peeled], pc.ranks[peeled])
    assert pd.n_fill == pc.n_fill and int(peeled.sum()) >= 2048
    assert _same(pd.partial_idx, pc.partial_idx)
    for a, b in zip(pd.memory, pc.memory):
        assert _same(a, b)
    diff = pd.niches.cpu() != pc.niches
    if bool(diff.any()):
        fn = -w[pc.partial_idx][diff] - pc.memory.best_point
        top2 = torch.cdist(fn, ref).topk(2, largest=False).values
        assert bool(((top2[:, 1] - top2[:, 0]) <= 1e-5 * top2[:, 1]).all())
    on_host = emo.NSGA3Plan(*(t.cpu() if torch.is_tensor(t) else t
                              for t in pd[:7]), pd.memory)
    nu = torch.rand((pd.n_fill, ref.shape[0]), generator=gc)
    mu = torch.rand((pd.n_fill, pd.partial_idx.shape[0]), generator=gc)
    want = emo.nsga3_select(on_host, 2048, nu, mu)
    assert _same(emo.nsga3_select(pd, 2048, nu.to(card), mu.to(card)), want)
    u = emo.nsga3_draws(gc, on_host)
    assert _same(emo.nsga3_select_scaled(pd, 2048, u.to(card)),
                 emo.nsga3_select_scaled(on_host, 2048, u))


def test_nsga3_launches_k7_once_a_peel(card):
    """A generation at a union of 16,384 rows: the DCD sort and NSGA-III's
    rank each peel through K7, once a front."""
    g = make_generator(9, card)
    x = torch.rand((8192, 12), generator=g, device=card)
    w = -benchmarks.dtlz2(x, 3)
    ref = mo.uniform_reference_points(3, 12).to(card)
    inputs = []
    before = (kernels.dominated_weight_sums.launches,
              kernels.dominated_weight_maxes.launches)
    x2, w2 = nsga3_generation(g, x, w, ref, inputs)
    torch.cuda.synchronize()
    k7 = kernels.dominated_weight_sums.launches - before[0]
    k8 = kernels.dominated_weight_maxes.launches - before[1]
    assert inputs[1][1].shape == (16384, 3)
    peels = [mo.nd_rank(v, impl="tiled", return_peels=True,
                        cover_k=8192 if kind == "nsga3" else None)[1]
             for kind, v in inputs]
    assert k7 == sum(peels) and k8 == 0 and min(peels) > 0
    assert x2.shape == (8192, 12) and bool(torch.isfinite(w2).all())
