"""K6's ``prng='hw'`` path on the CPU: the Philox streams of
``ops.philox.hw_real_bits``, the wrapper's mode rule, and the fused
Rastrigin loop against the JAX package's.

- Layout: both rows of a pair take the even row's γ words, the gate words
  are K2's flip draws (``GENES``) at the same coordinates, u1 and u2 are
  words 0 and 1 of the ``REAL_NORMAL`` calls, and every draw depends on
  its coordinates alone (a row or gene prefix of a larger expansion is
  the smaller one). Bitwise.
- The CPU ``'hw'`` path is ``fused_variation_eval_real_plain`` on
  ``hw_real_bits``: bitwise.
- In distribution: ``bench_suite.py``'s fused Rastrigin loop with
  ``prng='hw'`` on the port against the JAX loop run as its tests run it
  (``prng='input'``, Pallas interpret mode: the JAX package's ``'hw'``
  body needs a TPU), the means over seeds of the final best and average
  fitness within 3 standard errors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from deap_tpu import ops as jops
from deap_tpu.ops.kernels_real import fused_variation_eval_real as j_real
from deap_tpu_torch.device import make_generator
from deap_tpu_torch.ops import kernels as tk
from deap_tpu_torch.ops import kernels_real as tkr
from deap_tpu_torch.ops import philox

KW = dict(cxpb=0.5, mutpb=0.2, indpb=0.1, alpha=0.5, sigma=0.3)


def _key(seed):
    return tk.philox_key(make_generator(seed, "cpu"))


def _words(bits):
    return philox._u32(bits)


def _genomes(seed, n, L):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.uniform(-5.12, 5.12, (n, L))
                            .astype(np.float32))


def _same(a, b):
    if a.dtype in (torch.float32, torch.uint32):
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.dtype == b.dtype and torch.equal(a, b)


# --------------------------------------------------------------- layout --

@pytest.mark.parametrize("n,L", [(1, 3), (2, 30), (7, 5), (100, 30),
                                 (33, 41)])
def test_hw_real_bits_layout(n, L):
    key = _key(n + L)
    pairbits, rowbits, genebits = philox.hw_real_bits(key, n, L)
    assert pairbits.shape == (n, 4) and rowbits.shape == (n, 1)
    assert genebits.shape == (n, tkr.PLANES * L)
    assert genebits.dtype == torch.uint32
    gamma, gate, u1, u2 = _words(genebits).reshape(n, tkr.PLANES, L).unbind(1)
    rows = torch.arange(n)
    cols = torch.arange(L)
    # both rows of a pair take the even row's gamma words
    assert torch.equal(gamma, gamma[rows & ~1])
    want = philox.draws(key, (rows & ~1)[:, None], cols // 4, 0,
                        philox.REAL_GAMMA)
    assert torch.equal(gamma, want.gather(2, (cols % 4).expand(n, L)[..., None])
                       [..., 0])
    # the gate words are K2's flip draws at the same coordinates
    assert torch.equal(gate, _words(philox.hw_fused_bits(key, n, L)[2]))
    # u1 and u2 are words 0 and 1 of the REAL_NORMAL call of each gene
    normal = philox.draws(key, rows[:, None], cols, 0, philox.REAL_NORMAL)
    assert torch.equal(u1, normal[..., 0]) and torch.equal(u2, normal[..., 1])
    # pair and row words are K2's
    fused = philox.hw_fused_bits(key, n, L)
    assert _same(pairbits, fused[0]) and _same(rowbits, fused[1])


def test_hw_real_draws_depend_only_on_their_coordinates():
    key = _key(5)
    big = [_words(b) for b in philox.hw_real_bits(key, 64, 37)]
    for n, L in ((1, 37), (63, 37), (64, 9), (17, 1)):
        small = [_words(b) for b in philox.hw_real_bits(key, n, L)]
        assert torch.equal(small[0], big[0][:n])
        assert torch.equal(small[1], big[1][:n])
        planes = big[2].reshape(64, tkr.PLANES, 37)[:n, :, :L]
        assert torch.equal(small[2], planes.reshape(n, -1))
    # another generation word or another key gives other draws
    for other in (philox.hw_real_bits(key, 64, 37, g=1),
                  philox.hw_real_bits(_key(6), 64, 37)):
        for a, b in zip(other, big):
            assert not torch.equal(_words(a), b)


def test_hw_real_streams_draw_at_their_rates():
    """The uniforms the planes give: the gate below indpb at its rate
    (within 4 standard errors), u1 and u2 and gamma uniform in [0, 1)."""
    n, L = 4000, 30
    _, _, genebits = philox.hw_real_bits(_key(9), n, L)
    u = tk._u01(_words(genebits)).reshape(n, tkr.PLANES, L)
    for plane in range(tkr.PLANES):
        vals = u[:, plane].double()
        count = vals.numel() if plane else vals[::2].numel()
        mean = float(vals.mean() if plane else vals[::2].mean())
        assert abs(mean - 0.5) <= 4 * (1 / 12 / count) ** 0.5, (plane, mean)
        assert float(vals.min()) >= 0 and float(vals.max()) < 1
    p = 0.1
    rate = float((u[:, 1] < p).double().mean())
    assert abs(rate - p) <= 4 * (p * (1 - p) / (n * L)) ** 0.5


# ------------------------------------------------- the CPU 'hw' path ----

@pytest.mark.parametrize("n,L,evaluate", [(1, 30, "rastrigin"),
                                          (2, 5, "sphere"),
                                          (101, 30, "rastrigin"),
                                          (64, 40, "sphere")])
def test_cpu_hw_path_is_the_plain_version_on_the_philox_streams(n, L,
                                                                 evaluate):
    g = _genomes(n, n, L)
    key = _key(n * L)
    kw = dict(cxpb=0.7, mutpb=0.6, indpb=0.3, alpha=0.3, mu=0.1, sigma=0.3,
              evaluate=evaluate)
    got = tkr.fused_variation_eval_real(g, prng="hw", key=key, **kw)
    want = tkr.fused_variation_eval_real_plain(
        g, *philox.hw_real_bits(key, n, L), **kw)
    assert _same(got[0], want[0]) and _same(got[1], want[1])
    # from a generator: the one draw is the key
    got = tkr.fused_variation_eval_real(g, prng="hw",
                                        generator=make_generator(3, "cpu"),
                                        **kw)
    want = tkr.fused_variation_eval_real_plain(
        g, *philox.hw_real_bits(_key(3), n, L), **kw)
    assert _same(got[0], want[0]) and _same(got[1], want[1])


def test_mode_rule():
    g = _genomes(0, 6, 8)
    gen = make_generator(0, "cpu")
    bits = tkr.real_bits(gen, 6, 8)
    want = tkr.fused_variation_eval_real_plain(g, *bits, **KW)
    # prng=None with bits is 'input'
    got = tkr.fused_variation_eval_real(g, *bits, **KW)
    assert _same(got[0], want[0]) and _same(got[1], want[1])
    # without bits the default is 'auto', which is 'input' on the CPU and
    # needs them
    with pytest.raises(tk.PrngError, match="must all be passed"):
        tkr.fused_variation_eval_real(g, generator=gen, **KW)
    got = tkr.fused_variation_eval_real(g, *bits, prng="auto", **KW)
    assert _same(got[0], want[0])
    # 'hw' with bits, or with neither a generator nor a key, raises
    with pytest.raises(tk.PrngError, match="takes none"):
        tkr.fused_variation_eval_real(g, *bits, prng="hw", key=_key(1), **KW)
    with pytest.raises(NotImplementedError, match="Philox"):
        tkr.fused_variation_eval_real(g, *bits, prng="hw", **KW)
    with pytest.raises(tk.PrngError, match="exactly one"):
        tkr.fused_variation_eval_real(g, prng="hw", **KW)
    with pytest.raises(tk.PrngError, match="exactly one"):
        tkr.fused_variation_eval_real(g, prng="hw", key=_key(1),
                                      generator=gen, **KW)
    with pytest.raises(ValueError, match="uint32"):
        tkr.fused_variation_eval_real(g, prng="hw", key=torch.zeros(2), **KW)
    with pytest.raises(tk.PrngError, match="must all be passed"):
        tkr.fused_variation_eval_real(g, *bits[:2], prng="input", **KW)
    with pytest.raises(ValueError, match="unknown prng"):
        tkr.fused_variation_eval_real(g, *bits, prng="philox", **KW)


def test_rastrigin_loop_hw_equals_its_plain_composition():
    """``chip_smoke``'s fused Rastrigin step with ``'hw'``: the tournament
    ranks, then one key, then K6-hw; the same as the plain version on the
    key's streams."""
    import chip_smoke
    n = 301
    start = _genomes(11, n, chip_smoke.RA_DIM)
    fit0 = tkr.eval_rastrigin(start)

    def plain_hw(genomes, prng, generator, **kw):
        key = tk.philox_key(generator)
        return tkr.fused_variation_eval_real_plain(
            genomes, *philox.hw_real_bits(key, *genomes.shape), **kw)

    runs = []
    for variation in (None, plain_hw):
        gen = make_generator(4, "cpu")
        g, f = start, fit0
        for _ in range(3):
            g, f = chip_smoke.rastrigin_fused_generation(gen, g, f, variation,
                                                         prng="hw")
        runs.append((g, f))
    assert _same(runs[0][0], runs[1][0]) and _same(runs[0][1], runs[1][1])


# ---------------------------------------- in distribution, against JAX --

SEEDS, POP, NGEN, DIM = 6, 512, 5, 30


def test_fused_rastrigin_hw_agrees_with_jax_in_distribution():
    def gen_step(carry, key):
        genomes, fit = carry
        k_sel, k_var = jax.random.split(key)
        idx = jops.sel_tournament_sorted(k_sel, -fit[:, None], POP,
                                         tournsize=3)
        children, newfit = j_real(k_var, genomes[idx], **KW,
                                  evaluate="rastrigin", prng="input",
                                  block_i=256, interpret=True)
        return (children, newfit), None

    @jax.jit
    def run(key, genomes, fit):
        return lax.scan(gen_step, (genomes, fit),
                        jax.random.split(key, NGEN))[0][1]

    import chip_smoke
    jfits, pfits = [], []
    for s in range(SEEDS):
        start = _genomes(900 + s, POP, DIM)
        fit0 = tkr.eval_rastrigin(start)
        jfits.append(np.asarray(run(jax.random.key(s),
                                    jnp.asarray(start.numpy()),
                                    jnp.asarray(fit0.numpy()))))
        gen = make_generator(s, "cpu")
        genomes, fit = start, fit0
        for _ in range(NGEN):
            genomes, fit = chip_smoke.rastrigin_fused_generation(
                gen, genomes, fit, prng="hw")
        assert torch.allclose(fit, tkr.eval_rastrigin(genomes),
                              rtol=tkr.FIT_RTOL)
        pfits.append(fit.numpy())
    for reduce in (np.min, np.mean):
        a = np.array([reduce(f) for f in jfits])
        b = np.array([reduce(f) for f in pfits])
        se = np.sqrt(a.var(ddof=1) / SEEDS + b.var(ddof=1) / SEEDS)
        assert abs(a.mean() - b.mean()) <= 3 * se, (reduce, a, b, se)
    start_mean = float(tkr.eval_rastrigin(_genomes(900, POP, DIM)).mean())
    assert np.mean([f.mean() for f in pfits]) < 0.9 * start_mean  # descends
