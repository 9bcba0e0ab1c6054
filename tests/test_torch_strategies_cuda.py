"""J1 (the Jacobi eigensolver) and the CMA-ES family on the card.

These tests need a CUDA card and the CUDA toolkit; they skip without a
card. On a machine with one, from the repository's root (the shapes and
inputs are ``chip_smoke.py``'s ``j1_shapes`` and ``j1_inputs``):

    python -m pytest tests/test_torch_strategies_cuda.py -m cuda -q --noconftest

Tolerances: J1 equals its plain version bitwise, signed zeros included.
A strategy's update on the card against the same update on the CPU, from
the same state and offspring: ``strategies.cma.state_errors`` for
CMA-ES, ``field_errors`` with ``ONE_PLUS_LAMBDA_EXACT`` and ``MO_EXACT``
for the (1+λ) and MO strategies (the card's products sum in another
order); the 2-D hypervolume contributions bitwise.
"""

import pytest
import torch

from chip_smoke import J1_BUCKETS, J1_DIMS, j1_inputs
from deap_tpu_torch import benchmarks, convert
from deap_tpu_torch.device import make_generator
from deap_tpu_torch.ops import linalg
from deap_tpu_torch.strategies import cma

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _same(a, b):
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


def _cma_C(dev, d=100, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    M = torch.randn((d, d), generator=g, device=dev) / d ** 0.5
    return M @ M.T + torch.eye(d, device=dev)


@pytest.mark.parametrize("d", J1_DIMS)
@pytest.mark.parametrize("batch", [1, 3])
def test_j1_equals_plain(card, d, batch):
    for name, C in j1_inputs(torch, card, d, batch, _cma_C(card)).items():
        before = linalg.eigh_jacobi.launches
        w, V = linalg.eigh_jacobi(C)
        wp, Vp = linalg.eigh_jacobi_plain(C)
        torch.cuda.synchronize()
        assert linalg.eigh_jacobi.launches == before + 1
        assert _same(w, wp) and _same(V, Vp), (d, batch, name)


@pytest.mark.parametrize("batch,d", J1_BUCKETS)
def test_j1_equals_plain_on_serving_buckets(card, batch, d):
    C = j1_inputs(torch, card, d, batch, _cma_C(card))["spd"]
    w, V = linalg.eigh_jacobi(C)
    wp, Vp = linalg.eigh_jacobi_plain(C)
    assert _same(w, wp) and _same(V, Vp)
    # and the shape of a leading batch is kept
    w4, V4 = linalg.eigh_jacobi(C.reshape(2, batch // 2, d, d))
    assert _same(w4.reshape(w.shape), w) and _same(V4.reshape(V.shape), V)


def test_j1_sweeps_and_refusals(card):
    C = _cma_C(card, 33)
    for sweeps in (0, 1, 3):
        w, V = linalg.eigh_jacobi(C, sweeps)
        wp, Vp = linalg.eigh_jacobi_plain(C, sweeps)
        assert _same(w, wp) and _same(V, Vp)
    with pytest.raises(TypeError, match="float32"):
        linalg.eigh_jacobi(C.double())
    with pytest.raises(ValueError, match="contiguous"):
        linalg.eigh_jacobi(C.T)
    with pytest.raises(ValueError, match="square"):
        linalg.eigh_jacobi(C[:, :5])
    w, V = linalg.eigh_jacobi(C[:1, :1].contiguous())
    assert float(w[0]) == float(C[0, 0]) and float(V[0, 0]) == 1.0
    w, V = linalg.eigh_jacobi(torch.empty((0, 4, 4), device=card))
    assert w.shape == (0, 4) and V.shape == (0, 4, 4)


@pytest.mark.parametrize("dim,lam", [(10, 20), (30, 64), (100, 4096)])
def test_jacobi_cma_update_card_equals_cpu(card, dim, lam):
    strat = cma.Strategy(torch.full((dim,), 5.0), sigma=0.5, lambda_=lam,
                         eigh_impl="jacobi", device=card)
    cpu = cma.Strategy(torch.full((dim,), 5.0), sigma=0.5, lambda_=lam,
                       eigh_impl="jacobi", device="cpu")
    g = make_generator(5, card)
    st = strat.initial_state()
    for _ in range(4):
        pop = strat.generate(g, st)
        st = strat.update(st, pop, benchmarks.sphere(pop))
    pop = strat.generate(g, st)
    values = benchmarks.sphere(pop)
    got = strat.update(st, pop, values)
    want = cpu.update(convert.cma_state_from_arrays(
        **convert.cma_state_to_arrays(st), device="cpu"), pop.cpu(),
        values.cpu())
    errs = cma.state_errors(convert.cma_state_from_arrays(
        **convert.cma_state_to_arrays(got), device="cpu"), want)
    assert errs["ok"], errs


def test_one_plus_lambda_update_card_equals_cpu(card):
    parent = torch.linspace(-1.0, 2.0, 7)
    args = (parent, benchmarks.sphere(parent[None]), 0.8)
    strat = cma.StrategyOnePlusLambda(*args, lambda_=6, device=card)
    cpu = cma.StrategyOnePlusLambda(*args, lambda_=6, device="cpu")
    g = make_generator(2, card)
    st = strat.initial_state()
    for _ in range(12):
        pop = strat.generate(g, st)
        values = benchmarks.sphere(pop)
        got = strat.update(st, pop, values)
        want = cpu.update(convert.one_plus_lambda_state_from_arrays(
            **convert.one_plus_lambda_state_to_arrays(st), device="cpu"),
            pop.cpu(), values.cpu())
        errs = cma.field_errors(convert.one_plus_lambda_state_from_arrays(
            **convert.one_plus_lambda_state_to_arrays(got), device="cpu"),
            want, exact=cma.ONE_PLUS_LAMBDA_EXACT)
        assert errs["ok"], errs
        st = got


@pytest.mark.parametrize("mu,lam,nobj", [(16, 16, 2), (6, 11, 2),
                                         (8, 8, 3)])
def test_mo_update_card_equals_cpu(card, mu, lam, nobj):
    g = make_generator(mu + lam, card)
    x0 = torch.rand((mu, 5), generator=g, device=card)

    def evaluate(x):
        x = x.clamp(0, 1)
        return benchmarks.zdt1(x) if nobj == 2 else benchmarks.dtlz2(x, nobj)

    kw = dict(sigma=0.1, mu=mu, lambda_=lam,
              spec=cma.FitnessSpec((-1.0,) * nobj))
    strat = cma.StrategyMultiObjective(x0, evaluate(x0), device=card, **kw)
    cpu = cma.StrategyMultiObjective(x0.cpu(), evaluate(x0).cpu(),
                                     device="cpu", **kw)
    st = strat.initial_state()
    for _ in range(6):
        genomes = strat.generate(g, st)
        values = evaluate(genomes["x"])
        got = strat.update(st, genomes, values)
        want = cpu.update(convert.mo_state_from_arrays(
            **convert.mo_state_to_arrays(st), device="cpu"),
            {k: v.cpu() for k, v in genomes.items()}, values.cpu())
        errs = cma.field_errors(convert.mo_state_from_arrays(
            **convert.mo_state_to_arrays(got), device="cpu"), want,
            exact=cma.MO_EXACT)
        assert errs["ok"], errs
        st = got


def test_hypervolume_contributions_2d_card_equals_cpu(card):
    g = torch.Generator(device=card).manual_seed(4)
    w = torch.rand((300, 2), generator=g, device=card) * 2 - 1
    mask = torch.rand(300, generator=g, device=card) < 0.8
    ref = torch.tensor([-1.5, -1.5], device=card)
    got = cma.hypervolume_contributions_2d(w, mask, ref)
    want = cma.hypervolume_contributions_2d(w.cpu(), mask.cpu(), ref.cpu())
    assert _same(got.cpu(), want)
