"""``var_or`` (crossover OR mutation OR reproduction) against the JAX
package, on the CPU.

- Injected draws: the JAX package's ``var_or_masks`` for one key, turned
  to numpy and handed to the port's ``var_or_apply`` (the plain apply and
  the kernel wrapper, which runs its plain version on CPU tensors), must
  give bit for bit the children, fitness and ``valid`` of the JAX
  ``var_or`` with ``fused=False`` (the unfused composition) and
  ``fused='xla'``, at λ 1, 20, 64 and 100 children of 40 parents, for
  bool genomes with flip-bit mutation and float32 genomes with Gaussian
  mutation (K1's ``add`` kind).
- K1's plain version on those masks equals the JAX Pallas
  ``fused_variation`` (interpret mode) bit for bit with λ above N.
- The port's own modes (``False``, ``'plain'``, ``'kernel'``, ``'auto'``)
  give the same children from one generator state; ``cxpb = mutpb = 0``
  copies parents with their valid fitness; a population of 1 cannot mate
  and ``cxpb + mutpb > 1`` is refused.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from deap_tpu import algorithms as jalg
from deap_tpu import ops as jops
from deap_tpu.core.fitness import FitnessSpec as JSpec
from deap_tpu.core.population import init_population as j_init_population
from deap_tpu.core.toolbox import Toolbox as JToolbox
from deap_tpu.ops import kernels as jk
from deap_tpu.ops import variation as jvar
from deap_tpu_torch import algorithms as talg
from deap_tpu_torch import convert, ops as tops
from deap_tpu_torch.core.fitness import FitnessSpec as TSpec
from deap_tpu_torch.core.population import init_population as t_init_population
from deap_tpu_torch.core.toolbox import Toolbox as TToolbox
from deap_tpu_torch.device import make_generator
from deap_tpu_torch.ops import kernels as tk
from deap_tpu_torch.ops import variation as tvar

N, L, CXPB, MUTPB = 40, 24, 0.5, 0.3


@pytest.fixture(autouse=True)
def _pallas_compiler_params(monkeypatch):
    """The JAX package's K1 wrapper names ``pltpu.TPUCompilerParams``,
    which jax 0.9 renamed ``CompilerParams``; alias it in this test
    process only (the JAX package itself is not edited)."""
    if not hasattr(pltpu, "TPUCompilerParams"):
        monkeypatch.setattr(pltpu, "TPUCompilerParams", pltpu.CompilerParams,
                            raising=False)


def T(a):
    return torch.from_numpy(np.array(a))


def assert_bitwise(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert got.tobytes() == want.tobytes()


def _toolboxes(kind):
    jtb, ttb = JToolbox(), TToolbox()
    jtb.register("mate", jops.cx_two_point)
    ttb.register("mate", tops.cx_two_point)
    if kind == "flip":
        jtb.register("mutate", jops.mut_flip_bit, indpb=0.2)
        ttb.register("mutate", tops.mut_flip_bit, indpb=0.2)
    else:
        jtb.register("mutate", jops.mut_gaussian, mu=0.0, sigma=0.5,
                     indpb=0.2)
        ttb.register("mutate", tops.mut_gaussian, mu=0.0, sigma=0.5,
                     indpb=0.2)
    return jtb, ttb


def _jax_population(kind, seed):
    """N parents, their fitness random and a third of them invalid, so
    the children's carried fitness and ``valid`` show."""
    init = (jops.bernoulli_genome(L) if kind == "flip"
            else jops.uniform_genome(L, -1.0, 1.0))
    pop = j_init_population(jax.random.key(seed), N, init, JSpec((1.0,)))
    rng = np.random.default_rng(seed)
    return pop.replace(
        fitness=jnp.asarray(rng.normal(size=(N, 1)).astype(np.float32)),
        valid=jnp.asarray(rng.random(N) > 0.3))


def _torch_population(pop):
    return convert.population_from_arrays(pop.genomes, pop.fitness,
                                          pop.valid, pop.spec.weights,
                                          device="cpu")


def _assert_same_population(got, want):
    got = convert.population_to_arrays(got)
    for name in ("genomes", "fitness", "valid"):
        assert_bitwise(got[name], getattr(want, name))


@pytest.mark.parametrize("kind", ["flip", "add"])
@pytest.mark.parametrize("lam", [1, 20, 64, 100])
def test_var_or_apply_on_jax_draws_is_bitwise(kind, lam):
    jtb, _ = _toolboxes(kind)
    pop = _jax_population(kind, lam)
    key = jax.random.key(1000 + lam)
    plan = jvar.resolve_plan(jtb)
    masks = jvar.var_or_masks(key, N, lam, L, CXPB, MUTPB, plan,
                              pop.genomes.dtype)
    unfused = jalg.var_or(key, pop, jtb, lam, CXPB, MUTPB, fused=False)
    xla = jalg.var_or(key, pop, jtb, lam, CXPB, MUTPB, fused="xla")
    _assert_same_population(_torch_population(unfused), xla)
    # the masks mate and mutate some children and copy others
    assert bool(np.asarray(masks[2]).any()) or lam < 20
    tpop = _torch_population(pop)
    tmasks = tuple(None if m is None else T(m) for m in masks)
    for mode in ("plain", "kernel"):
        got = talg.var_or_apply(tpop, tmasks, plan.mut_kind, mode)
        _assert_same_population(got, unfused)


@pytest.mark.parametrize("kind", ["flip", "add"])
def test_k1_plain_version_on_var_or_masks_equals_the_jax_kernel(kind):
    """λ 100 children read from N 40 rows, partners drawn apart from the
    source rows, crossover and mutation rows exclusive."""
    jtb, _ = _toolboxes(kind)
    pop = _jax_population(kind, 7)
    lam = 100
    plan = jvar.resolve_plan(jtb)
    base, partner, cx, lo, hi, mut, mask, arg = jvar.var_or_masks(
        jax.random.key(8), N, lam, L, CXPB, MUTPB, plan, pop.genomes.dtype)
    assert not bool(np.asarray(cx & mut).any())
    want = jk.fused_variation(pop.genomes, base, partner, cx, lo, hi, mut,
                              mask, arg, mut_kind=plan.mut_kind, block_i=16,
                              interpret=True)
    args = [T(a) for a in (pop.genomes, base, partner, cx, lo, hi, mut,
                           mask)] + [None if arg is None else T(arg)]
    assert_bitwise(tk.fused_variation(*args, mut_kind=plan.mut_kind), want)
    assert_bitwise(tvar.apply_variation(*args, plan.mut_kind), want)


def _torch_start(kind, n, seed=0):
    _, ttb = _toolboxes(kind)
    ttb.register("evaluate", lambda g: g.to(torch.float32).sum(-1))
    init = (tops.bernoulli_genome(L) if kind == "flip"
            else tops.uniform_genome(L, -1.0, 1.0))
    pop = t_init_population(make_generator(seed, "cpu"), n, init,
                            TSpec((1.0,)), device="cpu")
    return ttb, talg.evaluate_invalid(pop, ttb.evaluate)


@pytest.mark.parametrize("kind", ["flip", "add"])
@pytest.mark.parametrize("n, lam", [(2, 7), (40, 100), (33, 1)])
def test_var_or_modes_give_the_unfused_children(kind, n, lam):
    """The fused plane consumes the generator as the unfused composition
    does: every mode gives the same children, fitness and ``valid``."""
    tb, pop = _torch_start(kind, n)
    want = talg.var_or(make_generator(3, "cpu"), pop, tb, lam, CXPB, MUTPB,
                       fused=False)
    assert want.size == lam
    for fused in ("plain", "kernel", "auto"):
        got = talg.var_or(make_generator(3, "cpu"), pop, tb, lam, CXPB,
                          MUTPB, fused=fused)
        for name in ("genomes", "fitness", "valid"):
            assert torch.equal(getattr(got, name), getattr(want, name))


def test_var_or_without_crossover_or_mutation_copies_valid_parents():
    tb, pop = _torch_start("flip", 20)
    off = talg.var_or(make_generator(4, "cpu"), pop, tb, 50, 0.0, 0.0)
    assert bool(off.valid.all())
    # every child is a row of the parents, with that row's fitness
    same = (off.genomes[:, None, :] == pop.genomes[None, :, :]).all(-1)
    assert bool(same.any(1).all())
    assert torch.equal(off.fitness[:, 0],
                       off.genomes.to(torch.float32).sum(-1))


def test_var_or_refuses_what_the_reference_refuses():
    tb, pop = _torch_start("flip", 1)
    with pytest.raises(ValueError, match="cannot mate"):
        talg.var_or(make_generator(0, "cpu"), pop, tb, 5, 0.5, 0.2)
    with pytest.raises(ValueError, match="cannot mate"):
        talg.var_or(make_generator(0, "cpu"), pop, tb, 5, 0.5, 0.2,
                    fused=False)
    # a single parent still mutates and reproduces
    off = talg.var_or(make_generator(0, "cpu"), pop, tb, 5, 0.0, 0.5)
    assert off.size == 5
    tb, pop = _torch_start("flip", 10)
    for fused in ("auto", False):
        with pytest.raises(ValueError, match="smaller or equal to 1.0"):
            talg.var_or(make_generator(0, "cpu"), pop, tb, 5, 0.7, 0.4,
                        fused=fused)
    tb.register("select", tops.sel_best)
    for loop in (talg.ea_mu_plus_lambda, talg.ea_mu_comma_lambda):
        with pytest.raises(ValueError, match="smaller or equal to 1.0"):
            loop(make_generator(0, "cpu"), pop, tb, 10, 20, 0.6, 0.6, 1,
                 device="cpu")
    with pytest.raises(ValueError, match="lambda must be greater"):
        talg.ea_mu_comma_lambda(make_generator(0, "cpu"), pop, tb, 10, 5,
                                0.5, 0.2, 1, device="cpu")
