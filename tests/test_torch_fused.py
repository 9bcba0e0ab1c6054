"""K2 ``fused_variation_eval`` and K6 ``fused_variation_eval_real`` held
against the JAX package's on the CPU.

The port's wrappers (on CPU tensors: their plain versions) against
``deap_tpu``'s Pallas kernels in interpret mode with their bits-input
path, fed the very bits those kernels draw from their key (the slice that
covers the port's ``n`` rows and ``L`` columns; the TPU pads rows and
columns, and padding never feeds a real row).

- K2: children and fitness bitwise (selects, flips and integer sums).
- K6: genes that no mutation touched (crossed or untouched) bitwise —
  the port computes the γ line and the blend with the two fused
  multiply-adds XLA computes; mutated genes within 4 ulp of their step
  plus 1 of the gene (``log1p`` and ``cos`` differ in their last bits
  between XLA and PyTorch); fitness within relative 1e-5, the JAX
  package's own test tolerance.

Whole fused OneMax runs, where each package draws for itself, agree in
distribution with the JAX package's fused loop (``bench.py``'s
``make_run_fused`` step at a small size).
"""

from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

import chip_smoke
from deap_tpu import ops as jops
from deap_tpu.ops.kernels import fused_variation_eval as j_fused
from deap_tpu.ops.kernels_real import fused_variation_eval_real as j_real
from deap_tpu_torch import ops as tops
from deap_tpu_torch.device import make_generator
from deap_tpu_torch.ops import kernels as tk
from deap_tpu_torch.ops import kernels_real as tkr

BLOCK = 64


def T(a):
    return torch.from_numpy(np.array(a))


def assert_bitwise(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert got.tobytes() == want.tobytes()


def _round_up(x, m):
    return -(-x // m) * m


def _streams(key, n, cols, planes=1):
    """``run_fused_kernel``'s bits for ``n`` rows: pair, row, and gene
    bits cut to ``cols`` real columns in each of ``planes`` planes."""
    ni = _round_up(n, BLOCK)
    cp = _round_up(cols, 128)
    k1, k2, k3 = jax.random.split(key, 3)
    pair = jax.random.bits(k1, (ni, 4), jnp.uint32)[:n]
    row = jax.random.bits(k2, (ni, 1), jnp.uint32)[:n]
    gene = np.asarray(jax.random.bits(k3, (ni, planes * cp), jnp.uint32))[:n]
    gene = gene.reshape(n, planes, cp)[:, :, :cols].reshape(n, planes * cols)
    return T(pair), T(row), T(gene)


# ------------------------------------------------ K2 fused_variation_eval --

@pytest.mark.parametrize("n,L,dtype,probs", [
    (1, 100, np.bool_, (0.5, 0.2, 0.05)),
    (2, 33, np.float32, (1.0, 1.0, 0.5)),
    (63, 1, np.bool_, (0.5, 0.5, 0.5)),
    (65, 31, np.float32, (1.0, 1.0, 0.3)),
    (130, 100, np.bool_, (0.5, 0.2, 0.05)),
    (131, 70, np.float32, (0.5, 0.5, 0.1)),
    (77, 100, np.bool_, (0.0, 0.0, 0.0)),
])
def test_k2_generation_bitwise(n, L, dtype, probs):
    cxpb, mutpb, indpb = probs
    g = (np.random.default_rng(n + L).random((n, L)) < 0.5).astype(dtype)
    key = jax.random.key(n * 5 + L)
    want_c, want_f = j_fused(key, jnp.asarray(g), cxpb=cxpb, mutpb=mutpb,
                             indpb=indpb, prng="input", interpret=True,
                             block_i=BLOCK)
    got_c, got_f = tk.fused_variation_eval(
        T(g), *_streams(key, n, L), cxpb=cxpb, mutpb=mutpb, indpb=indpb)
    assert_bitwise(got_c, want_c)
    assert_bitwise(got_f, want_f)


def test_k2_wrapper_refuses_what_it_cannot_do():
    gen = make_generator(0, "cpu")
    g = torch.zeros((4, 8), dtype=torch.bool)
    bits = tk.fused_bits(gen, 4, 8)
    probs = dict(cxpb=0.5, mutpb=0.5, indpb=0.5)
    with pytest.raises(NotImplementedError, match="Philox"):
        tk.fused_variation_eval(g, *bits, **probs, prng="hw")
    with pytest.raises(TypeError, match="bool or float32"):
        tk.fused_variation_eval(g.to(torch.int32), *bits, **probs)
    with pytest.raises(ValueError, match="no kernel"):
        tk.fused_variation_eval(g.to("meta"), *bits, **probs)
    # 'auto' on the CPU is the bits-input path
    got = tk.fused_variation_eval(g, *bits, **probs, prng="auto")
    want = tk.fused_variation_eval(g, *bits, **probs)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_fused_bits_layout():
    pair, row, gene = tk.fused_bits(make_generator(1, "cpu"), 10, 30)
    assert (pair.dtype, row.dtype, gene.dtype) == (torch.uint32,) * 3
    assert (pair.shape, row.shape, gene.shape) == ((10, 4), (10, 1), (10, 30))


# ---------------------------------------------------- whole fused loops ----

SEEDS, N_LOOP, NGEN_LOOP = 12, 128, 10


def _jax_fused_run():
    """``bench.py``'s ``make_run_fused`` at a small size: tournament 3,
    the row gather, K2 (interpret mode, bits input)."""
    def gen_step(carry, key):
        genomes, fit = carry
        k_sel, k_var = jax.random.split(key)
        idx = jops.sel_tournament(k_sel, fit[:, None], N_LOOP, tournsize=3)
        children, newfit = j_fused(
            k_var, genomes[idx], cxpb=chip_smoke.CXPB, mutpb=chip_smoke.MUTPB,
            indpb=chip_smoke.INDPB, prng="input", block_i=128,
            interpret=True)
        return (children, newfit), None

    @jax.jit
    def run(key, genomes, fit):
        (_, f), _ = lax.scan(gen_step, (genomes, fit),
                             jax.random.split(key, NGEN_LOOP))
        return f

    return run


def test_fused_onemax_loop_agrees_with_jax_in_distribution():
    run = _jax_fused_run()
    jax_means, port_means = [], []
    for s in range(SEEDS):
        g = jax.random.bernoulli(jax.random.key(1000 + s), 0.5,
                                 (N_LOOP, 100))
        f = run(jax.random.key(s), g, g.sum(1).astype(jnp.float32))
        jax_means.append(float(f.mean()))
        gen = make_generator(s, "cpu")
        genomes = tops.bernoulli_genome(100)(gen, N_LOOP)
        fit = genomes.sum(1).to(torch.float32)
        for _ in range(NGEN_LOOP):
            genomes, fit = chip_smoke.fused_onemax_generation(gen, genomes,
                                                              fit)
        assert torch.equal(fit, genomes.sum(1).to(torch.float32))
        port_means.append(float(fit.mean()))
    jm, pm = np.array(jax_means), np.array(port_means)
    se = np.sqrt(jm.var(ddof=1) / SEEDS + pm.var(ddof=1) / SEEDS)
    assert abs(jm.mean() - pm.mean()) <= 3 * se, (jm.mean(), pm.mean(), se)
    assert pm.mean() > 60  # both climb from 50


# ------------------------------------------- K6 fused_variation_eval_real --

def _fma_exact(a, b, c):
    """The float32 nearest ``a·b + c`` (ties to even), by exact
    rationals."""
    exact = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    x = np.float32(float(exact))
    cands = [np.nextafter(x, np.float32(-np.inf)), x,
             np.nextafter(x, np.float32(np.inf))]
    dist = [abs(Fraction(float(v)) - exact) for v in cands]
    best = min(dist)
    ties = [v for v, d in zip(cands, dist) if d == best]
    if len(ties) > 1:
        ties = [v for v in ties if (np.array(v).view(np.int32) & 1) == 0]
    return ties[0]


def test_fma32_is_correctly_rounded():
    rng = np.random.default_rng(0)
    a = rng.normal(size=400).astype(np.float32)
    b = rng.normal(size=400).astype(np.float32)
    c = (-a * b).astype(np.float32)   # heavy cancellation
    c[::2] = rng.normal(size=200).astype(np.float32) * 1e-3
    c[1::4] = 0.0
    # halfway cases of a float32 sum: a·b exact, c half an ulp of it
    a[:20] = np.float32(1.0) + np.float32(2.0**-23) * np.arange(20)
    b[:20] = np.float32(1.0)
    c[:20] = np.float32(2.0**-24) * np.where(np.arange(20) % 2, 1, -1)
    c[20:30] = np.float32(2.0**-24 + 2.0**-60)
    got = tkr._fma32(T(a), T(b), T(c)).numpy()
    want = np.array([_fma_exact(x, y, z) for x, y, z in zip(a, b, c)],
                    dtype=np.float32)
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("n,L,probs,evaluate", [
    (96, 30, (0.5, 0.2, 0.1, 0.5, 0.0, 0.3), "rastrigin"),
    (131, 30, (0.7, 0.6, 0.4, 0.3, 0.1, 0.3), "rastrigin"),
    (65, 8, (1.0, 1.0, 0.5, 0.5, 2.0, 0.5), "sphere"),
    (2, 5, (1.0, 1.0, 1.0, 0.25, 0.0, 1.0), "sphere"),
    (1, 33, (1.0, 1.0, 0.5, 0.5, 0.0, 1.0), "rastrigin"),
    (77, 30, (0.0, 0.0, 0.1, 0.5, 0.0, 0.3), "rastrigin"),
    (1024, 30, (0.5, 1.0, 0.5, 0.5, 0.0, 0.3), "rastrigin"),
])
def test_k6_generation_against_jax(n, L, probs, evaluate):
    cxpb, mutpb, indpb, alpha, mu, sigma = probs
    rng = np.random.default_rng(n + L)
    g = rng.uniform(-5.12, 5.12, (n, L)).astype(np.float32)
    key = jax.random.key(n * 3 + L)
    kw = dict(cxpb=cxpb, mutpb=mutpb, indpb=indpb, alpha=alpha, mu=mu,
              sigma=sigma, evaluate=evaluate)
    want = j_real(key, jnp.asarray(g), **kw, prng="input", interpret=True,
                  block_i=BLOCK)
    bits = _streams(key, n, L, planes=tkr.PLANES)
    got = tkr.fused_variation_eval_real(T(g), *bits, **kw)
    errs = tkr.real_kernel_errors(
        got, (T(want[0]), T(want[1])), *bits, mutpb=mutpb, indpb=indpb,
        mu=mu, sigma=sigma)
    print(f"K6 n={n} L={L}: {errs}")  # the largest errors, shown with -s
    assert errs["ok"], errs
    if cxpb == 0.0 and mutpb == 0.0:
        assert_bitwise(got[0], g)


def test_k6_callable_evaluation_runs_after_the_variation():
    """A callable cannot be compiled into the kernel: the children are
    the built-in run's, and the callable scores them in PyTorch; the JAX
    package's tile callable agrees."""
    n, L = 95, 8
    g = np.random.default_rng(3).random((n, L)).astype(np.float32)
    key = jax.random.key(11)
    kw = dict(cxpb=1.0, mutpb=0.5, indpb=0.3)
    bits = _streams(key, n, L, planes=tkr.PLANES)
    children, fit = tkr.fused_variation_eval_real(
        T(g), *bits, **kw, evaluate=lambda c: -c.sum(1))
    ref_children, _ = tkr.fused_variation_eval_real(T(g), *bits, **kw,
                                                    evaluate="sphere")
    assert torch.equal(children, ref_children)
    assert torch.equal(fit, -children.sum(1))

    def neg_sum(child, valid_col):
        return -jnp.sum(jnp.where(valid_col, child, 0.0), axis=1,
                        keepdims=True)

    want_c, want_f = j_real(key, jnp.asarray(g), **kw, evaluate=neg_sum,
                            prng="input", interpret=True, block_i=BLOCK)
    np.testing.assert_allclose(fit.numpy(), np.asarray(want_f), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(children.numpy(), np.asarray(want_c),
                               rtol=1e-5, atol=1e-5)


def test_k6_wrapper_refuses_what_it_cannot_do():
    gen = make_generator(0, "cpu")
    g = torch.zeros((4, 6))
    bits = tkr.real_bits(gen, 4, 6)
    probs = dict(cxpb=0.5, mutpb=0.5, indpb=0.5)
    assert bits[2].shape == (4, 24)
    with pytest.raises(NotImplementedError, match="Philox"):
        tkr.fused_variation_eval_real(g, *bits, **probs, prng="hw")
    with pytest.raises(ValueError, match="built-ins"):
        tkr.fused_variation_eval_real(g, *bits, **probs, evaluate="ackley")
    with pytest.raises(TypeError, match="float32"):
        tkr.fused_variation_eval_real(g.double(), *bits, **probs)
    with pytest.raises(ValueError, match="no kernel"):
        tkr.fused_variation_eval_real(g.to("meta"), *bits, **probs)
