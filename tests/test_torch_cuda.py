"""The port's CUDA kernels against their plain versions, on the card.

These tests need a CUDA card and the CUDA toolkit; they skip without a
card. On a machine with one:

    python -m pytest tests/test_torch_cuda.py -m cuda -q --noconftest

(``--noconftest``: tests/conftest.py imports jax, which the port does not
need.)

Each kernel is held against its plain PyTorch version on the same CUDA
tensors, at small odd shapes — bitwise, and K6 at its stated tolerance
(``kernels_real.real_kernel_errors``); the wrappers' launch counters must
rise by one per call.
"""

import pytest
import torch

from deap_tpu_torch import FitnessSpec, Toolbox, algorithms, gp, mo, ops
from deap_tpu_torch.core.population import init_population
from deap_tpu_torch.device import make_generator
from deap_tpu_torch.ops import kernels, kernels_real, packed, variation

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _same(a, b):
    if a.dtype in (torch.float32, torch.uint32):
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("n,L", [(1, 17), (2, 33), (65, 100), (1001, 31)])
@pytest.mark.parametrize("dtype,kind", [(torch.bool, "flip"),
                                        (torch.float32, "flip"),
                                        (torch.float32, "add"),
                                        (torch.float32, "set"),
                                        (torch.bool, "set")])
def test_fused_variation_kernel_equals_plain(card, n, L, dtype, kind):
    gen = make_generator(n + L, card)
    g = (torch.rand((n, L), generator=gen, device=card) < 0.5).to(dtype)
    src = torch.randint(0, n, (n,), generator=gen, device=card,
                        dtype=torch.int32)
    partner = src[variation.pair_partner_positions(n, card).long()]
    cx_row, lo, hi, do_mut, mask, _ = variation.var_and_masks(
        gen, n, L, 0.7, 0.6, variation.VariationPlan(
            ops.cx_two_point.fused_segment_draw, "cx", "flip",
            ops.mut_flip_bit.fused_plan(0.3)[1], "mut"), dtype)
    arg = None if kind == "flip" else torch.randn((n, L), generator=gen,
                                                  device=card)
    before = kernels.fused_variation.launches
    args = (g, src, partner, cx_row, lo, hi, do_mut, mask, arg)
    got = kernels.fused_variation(*args, mut_kind=kind)
    want = variation.apply_variation(*args, kind).to(dtype)
    torch.cuda.synchronize()
    assert kernels.fused_variation.launches == before + 1
    assert _same(got, want)


@pytest.mark.parametrize("n,L", [(1, 100), (2, 33), (65, 32), (1001, 100)])
def test_packed_kernels_equal_plain(card, n, L):
    gen = make_generator(n, card)
    pk = packed.pack_genomes(torch.rand((n, L), generator=gen, device=card)
                             < 0.5)
    W = pk.shape[1]
    bits = packed.variation_bits(gen, n, W)
    probs = dict(cxpb=0.6, mutpb=0.5, indpb=0.1)
    got = packed.fused_variation_eval_packed(pk, L, *bits, **probs)
    want = packed.fused_variation_eval_packed_plain(pk, L, *bits, **probs)
    fit = packed.packed_fitness(pk)
    draws = packed.tournament_bits(gen, 3, n)
    sel = packed.sel_tournament_gather_packed(pk, fit, draws)
    sel_want = packed.sel_tournament_gather_packed_plain(pk, fit, draws)
    torch.cuda.synchronize()
    assert _same(got[0], want[0]) and _same(got[1], want[1])
    assert _same(sel, sel_want)


def test_kernel_wrappers_reject_what_the_kernels_do_not_take(card):
    g = torch.zeros((4, 8), dtype=torch.int32, device=card)
    z = torch.zeros(4, dtype=torch.int32, device=card)
    m = torch.zeros((4, 8), dtype=torch.bool, device=card)
    with pytest.raises(TypeError, match="bool or float32"):
        kernels.fused_variation(g, z, z, z.bool(), z, z, z.bool(), m)
    with pytest.raises(TypeError, match="int32"):
        kernels.fused_variation(g.bool(), z.long(), z, z.bool(), z, z,
                                z.bool(), m)
    with pytest.raises(TypeError, match="uint32"):
        packed.sel_tournament_gather_packed(
            g, torch.zeros(4, device=card),
            torch.zeros((3, 4), dtype=torch.int32, device=card))


def test_ea_simple_on_the_card_goes_through_the_kernel(card):
    tb = Toolbox()
    tb.register("evaluate", lambda g: g.sum(-1).to(torch.float32))
    tb.register("mate", ops.cx_two_point)
    tb.register("mutate", ops.mut_flip_bit, indpb=0.05)
    tb.register("select", ops.sel_tournament, tournsize=3)
    runs = []
    for fused in ("auto", False):
        gen = make_generator(0, card)
        pop = init_population(gen, 301, ops.bernoulli_genome(100),
                              FitnessSpec((1.0,)), device=card)
        before = kernels.fused_variation.launches
        runs.append(algorithms.ea_simple(gen, pop, tb, 0.5, 0.2, 4,
                                         fused=fused, device=card))
        if fused == "auto":
            assert kernels.fused_variation.launches == before + 4
    assert torch.equal(runs[0][0].genomes, runs[1][0].genomes)


def _fitness_on(card, seed, n, m):
    """Integer grid values (exact ties) with duplicated, -inf and NaN
    rows."""
    gen = make_generator(seed, card)
    w = torch.randint(0, 4, (n, m), generator=gen, device=card).float()
    if n > 4:
        rows = torch.randint(0, n, (2, n // 3), generator=gen, device=card)
        w[rows[0]] = w[rows[1]]
        w[: max(1, n // 20)] = -torch.inf
        w[n // 2: n // 2 + max(1, n // 30)] = torch.nan
    return w


@pytest.mark.parametrize("n", [1, 2, 257, 1001])
@pytest.mark.parametrize("m", [1, 3, 5, 9])
def test_dominance_kernels_equal_plain(card, n, m):
    w = _fitness_on(card, n + m, n, m)
    gen = make_generator(n, card)
    for weights in ((torch.rand(n, generator=gen, device=card) < 0.5),
                    torch.randint(-3, 4, (n,), generator=gen,
                                  device=card).float()):
        before = kernels.dominated_weight_sums.launches
        got = kernels.dominated_weight_sums(w, weights)
        want = kernels.dominated_weight_sums_plain(w, weights)
        torch.cuda.synchronize()
        assert kernels.dominated_weight_sums.launches == before + 1
        assert _same(got, want)
    weights = torch.randint(0, 6, (n,), generator=gen, device=card).float()
    for nq in (1, n + 3, 2 * n + 77):
        queries = _fitness_on(card, nq, nq, m)
        before = kernels.dominated_weight_maxes.launches
        got = kernels.dominated_weight_maxes(w, weights, queries)
        want = kernels.dominated_weight_maxes_plain(w, weights, queries)
        torch.cuda.synchronize()
        assert kernels.dominated_weight_maxes.launches == before + 1
        assert _same(got, want)


@pytest.mark.parametrize("n", [1, 2, 129, 1001, 50_000])
@pytest.mark.parametrize("m", [1, 3, 5, 9])
def test_dominance_sums_across_splits(card, n, m):
    """K7 at sizes that are not multiples of its rows per thread, its tile
    or its split of j, with NaN and -inf rows: bitwise for integer
    weights; for non-integer ones two launches give the same bits and
    stay within K7_RTOL of the plain version."""
    w = _fitness_on(card, 3 * n + m, n, m)
    gen = make_generator(n + 7, card)
    ints = torch.randint(-3, 4, (n,), generator=gen, device=card).float()
    assert _same(kernels.dominated_weight_sums(w, ints),
                 kernels.dominated_weight_sums_plain(w, ints))
    weights = torch.rand(n, generator=gen, device=card)
    before = kernels.dominated_weight_sums.launches
    got = kernels.dominated_weight_sums(w, weights)
    again = kernels.dominated_weight_sums(w, weights)
    want = kernels.dominated_weight_sums_plain(w, weights)
    torch.cuda.synchronize()
    assert kernels.dominated_weight_sums.launches == before + 2
    assert _same(got, again)
    rel = (got - want).abs() / want.abs().clamp_min(1.0)
    assert float(rel.max()) <= kernels.K7_RTOL


def test_dominance_kernels_on_a_wide_population(card):
    """Many tiles and, for K8, many blocks over the rows of w."""
    w = -torch.rand((20_000, 3), generator=make_generator(3, card),
                    device=card)
    ones = torch.ones(20_000, device=card)
    assert _same(kernels.dominated_weight_sums(w, ones),
                 kernels.dominated_weight_sums_plain(w, ones))
    queries = w[:512] * 0.999
    weights = torch.arange(20_000, device=card).float()
    assert _same(kernels.dominated_weight_maxes(w, weights, queries),
                 kernels.dominated_weight_maxes_plain(w, weights, queries))


def test_engines_agree_on_the_card(card):
    w = -torch.rand((3000, 3), generator=make_generator(4, card), device=card)
    want = mo.nd_rank(w, impl="matrix")
    for impl in ("tiled", "sweep", "dc"):
        assert torch.equal(mo.nd_rank(w, impl=impl), want), impl
    # an odd block: K8 at other prefix and query counts
    assert torch.equal(mo.nd_rank_prefix(w, block=97), want)
    w2 = w[:, :2].contiguous()
    assert torch.equal(mo.nd_rank(w2, impl="staircase"),
                       mo.nd_rank(w2, impl="tiled"))


# ----------------------------------------- the whole-generation kernels --

@pytest.mark.parametrize("n,L", [(1, 100), (2, 33), (65, 31), (1001, 100)])
@pytest.mark.parametrize("dtype", [torch.bool, torch.float32])
def test_fused_variation_eval_kernel_equals_plain(card, n, L, dtype):
    gen = make_generator(n + L, card)
    g = (torch.rand((n, L), generator=gen, device=card) < 0.5).to(dtype)
    bits = kernels.fused_bits(gen, n, L)
    probs = dict(cxpb=0.6, mutpb=0.5, indpb=0.1)
    before = kernels.fused_variation_eval.launches
    got = kernels.fused_variation_eval(g, *bits, **probs)
    want = kernels.fused_variation_eval_plain(g, *bits, **probs)
    torch.cuda.synchronize()
    assert kernels.fused_variation_eval.launches == before + 1
    assert _same(got[0], want[0]) and _same(got[1], want[1])


@pytest.mark.parametrize("L", [1, 4, 31, 33, 100])
@pytest.mark.parametrize("dtype", [torch.bool, torch.float32])
def test_fused_variation_eval_variants(card, L, dtype):
    """L % 4 == 0 on aligned tensors takes the vector variant, other
    lengths the scalar one; both equal the plain version."""
    n = 1001
    gen = make_generator(L, card)
    g = (torch.rand((n, L), generator=gen, device=card) < 0.5).to(dtype)
    bits = kernels.fused_bits(gen, n, L)
    probs = dict(cxpb=0.6, mutpb=0.5, indpb=0.1)
    before = (kernels.fused_variation_eval.launches,
              kernels.fused_variation_eval.vector_launches)
    got = kernels.fused_variation_eval(g, *bits, **probs)
    want = kernels.fused_variation_eval_plain(g, *bits, **probs)
    torch.cuda.synchronize()
    assert (kernels.fused_variation_eval.launches,
            kernels.fused_variation_eval.vector_launches) == (
        before[0] + 1, before[1] + (L % 4 == 0))
    assert _same(got[0], want[0]) and _same(got[1], want[1])


@pytest.mark.parametrize("dtype", [torch.bool, torch.float32])
def test_fused_variation_eval_misaligned_view_takes_scalar(card, dtype):
    n, L = 513, 100
    gen = make_generator(5, card)
    g = torch.empty(n * L + 1, dtype=dtype, device=card)[1:].view(n, L)
    g.copy_(torch.rand((n, L), generator=gen, device=card) < 0.5)
    bits = kernels.fused_bits(gen, n, L)
    probs = dict(cxpb=0.6, mutpb=0.5, indpb=0.1)
    before = kernels.fused_variation_eval.vector_launches
    got = kernels.fused_variation_eval(g, *bits, **probs)
    want = kernels.fused_variation_eval_plain(g, *bits, **probs)
    torch.cuda.synchronize()
    assert kernels.fused_variation_eval.vector_launches == before
    assert _same(got[0], want[0]) and _same(got[1], want[1])


@pytest.mark.parametrize("n,L,ngen,tournsize", [(1, 100, 3, 3),
                                                (2, 33, 1, 1),
                                                (257, 100, 4, 3),
                                                (1001, 70, 7, 2)])
def test_evolve_packed_kernel_equals_plain(card, n, L, ngen, tournsize):
    gen = make_generator(n + ngen, card)
    pk = packed.pack_genomes(torch.rand((n, L), generator=gen, device=card)
                             < 0.5)
    fit = packed.packed_fitness(pk)
    bits = packed.evolve_bits(gen, ngen, tournsize, n, pk.shape[1])
    probs = dict(cxpb=0.7, mutpb=0.5, indpb=0.1)
    before = packed.evolve_packed.launches
    got = packed.evolve_packed(pk, fit, L, *bits, **probs)
    want = packed.evolve_packed_plain(pk, fit, L, *bits, **probs)
    torch.cuda.synchronize()
    assert packed.evolve_packed.launches == before + 1
    assert _same(got[0], want[0]) and _same(got[1], want[1])


@pytest.mark.parametrize("n,L,evaluate", [(1, 30, "rastrigin"),
                                          (2, 5, "sphere"),
                                          (129, 30, "rastrigin"),
                                          (1001, 40, "sphere")])
def test_fused_variation_eval_real_kernel_within_tolerance(card, n, L,
                                                           evaluate):
    gen = make_generator(n + L, card)
    g = torch.rand((n, L), generator=gen, device=card) * 10.24 - 5.12
    bits = kernels_real.real_bits(gen, n, L)
    kw = dict(cxpb=0.7, mutpb=0.6, indpb=0.3, alpha=0.3, mu=0.1, sigma=0.3)
    before = kernels_real.fused_variation_eval_real.launches
    got = kernels_real.fused_variation_eval_real(g, *bits, **kw,
                                                 evaluate=evaluate)
    want = kernels_real.fused_variation_eval_real_plain(g, *bits, **kw,
                                                        evaluate=evaluate)
    torch.cuda.synchronize()
    assert kernels_real.fused_variation_eval_real.launches == before + 1
    errs = kernels_real.real_kernel_errors(got, want, *bits, mutpb=0.6,
                                           indpb=0.3, mu=0.1, sigma=0.3)
    assert errs["ok"], errs
    # a callable is applied after the kernel, which still launches
    children, fit = kernels_real.fused_variation_eval_real(
        g, *bits, **kw, evaluate=lambda c: c.sum(1))
    assert kernels_real.fused_variation_eval_real.launches == before + 2
    assert _same(children, got[0]) and _same(fit, children.sum(1))


def test_whole_generation_wrappers_refuse_hw_and_bad_input(card):
    g = torch.zeros((4, 8), dtype=torch.bool, device=card)
    gen = make_generator(0, card)
    bits = kernels.fused_bits(gen, 4, 8)
    probs = dict(cxpb=0.5, mutpb=0.5, indpb=0.5)
    for prng in ("hw", "auto"):
        with pytest.raises(NotImplementedError, match="Philox"):
            kernels.fused_variation_eval(g, *bits, **probs, prng=prng)
    with pytest.raises(TypeError, match="uint32"):
        kernels.fused_variation_eval(g, bits[0].view(torch.int32), *bits[1:],
                                     **probs)
    pk = torch.zeros((4, 1), dtype=torch.uint32, device=card)
    draws = packed.evolve_bits(gen, 2, 3, 4, 1)
    with pytest.raises(NotImplementedError, match="Philox"):
        packed.evolve_packed(pk, torch.zeros(4, device=card), 8, *draws,
                             **probs, prng="auto")
    with pytest.raises(ValueError, match="shape"):
        packed.evolve_packed(pk, torch.zeros(4, device=card), 8,
                             draws[0][:, :, :3], *draws[1:], **probs)


def test_var_and_with_gaussian_goes_through_the_add_kind(card):
    tb = Toolbox()
    tb.register("mate", ops.cx_two_point)
    tb.register("mutate", ops.mut_gaussian, mu=0.0, sigma=0.3, indpb=0.2)
    pop = init_population(make_generator(0, card), 301,
                          ops.uniform_genome(30, -5.12, 5.12),
                          FitnessSpec((-1.0,)), device=card)
    before = kernels.fused_variation.launches
    got = algorithms.var_and(make_generator(1, card), pop, tb, 0.5, 0.2)
    assert kernels.fused_variation.launches == before + 1
    want = algorithms.var_and(make_generator(1, card), pop, tb, 0.5, 0.2,
                              fused=False)
    assert _same(got.genomes, want.genomes)


# -------------------------------------------------- K9 gp_grouped_dispatch --

def _grouped_case(card, pset, n, width, P, chunk, seed, max_depth=4):
    """The grouped schedule of a generated population on the card, its
    argument rows and both evaluations of the whole buffer."""
    gen = make_generator(seed, card)
    pop = gp.gen_half_and_half(pset, width, 0, max_depth)(gen, n)
    interp = gp.make_batch_interpreter(pset, width, mode="grouped",
                                       chunk=chunk)
    sched, _ = interp.schedule(pop)
    X = torch.rand((P, pset.n_args), generator=gen, device=card) * 4 - 2
    if pset.name == "BOOL":
        X = (X > 0).float()
    nrows = pset.n_args + sched["nchunks"] * chunk
    buf = torch.zeros((nrows, P), device=card)
    buf[:pset.n_args] = X.T
    args = [torch.from_numpy(sched[k]).to(card) for k in
            ("chunk_ops", "src_idx", "src_const", "src_isc")]
    return _grouped_both(buf, args, interp.branches, chunk, pset.n_args,
                         sched["level_starts"])


def _grouped_both(buf, args, branches, chunk, n_args, levels):
    """K9 (one launch, its levels counted) and its plain version on
    copies of ``buf``; the kernel's instruction rows start as NaN, so a
    row read before its level wrote it shows in the result."""
    k9 = kernels.gp_grouped_dispatch
    before = (k9.launches, k9.levels)
    kbuf = buf.clone()
    kbuf[n_args:] = float("nan")
    got = k9(kbuf, *args, branches, chunk=chunk, n_args=n_args,
             levels=levels)
    want = kernels.gp_grouped_dispatch_plain(buf.clone(), *args, branches,
                                             chunk=chunk, n_args=n_args)
    torch.cuda.synchronize()
    assert (k9.launches, k9.levels) == (before[0] + 1,
                                        before[1] + len(levels) - 1)
    return got, want


def _schedule_case(card, pset, pop, width, P, chunk, seed):
    """K9 and its plain version on the grouped schedule of ``pop``."""
    gen = make_generator(seed, card)
    interp = gp.make_batch_interpreter(pset, width, mode="grouped",
                                       chunk=chunk)
    sched, _ = interp.schedule(pop)
    X = torch.rand((P, pset.n_args), generator=gen, device=card) * 4 - 2
    buf = torch.zeros((pset.n_args + sched["nchunks"] * chunk, P),
                      device=card)
    buf[:pset.n_args] = X.T
    args = [torch.from_numpy(sched[k]).to(card) for k in
            ("chunk_ops", "src_idx", "src_const", "src_isc")]
    return sched, _grouped_both(buf, args, interp.branches, chunk,
                                pset.n_args, sched["level_starts"])


@pytest.mark.parametrize("pset_name,n,width,P,chunk", [
    ("math1", 37, 24, 7, 128),
    ("math2", 200, 48, 33, 16),
    ("math1", 512, 64, 256, 128),
    ("math1", 100, 32, 1, 16),
    ("bool3", 64, 32, 8, 8),
    ("bool6", 301, 48, 65, 32),
])
def test_gp_grouped_kernel_equals_plain(card, pset_name, n, width, P, chunk):
    pset = (gp.math_set(int(pset_name[-1])) if pset_name.startswith("math")
            else gp.bool_set(int(pset_name[-1])))
    got, want = _grouped_case(card, pset, n, width, P, chunk, n + P)
    assert _same(got, want)


@pytest.mark.parametrize("P", [1, 7, 33, 256])
def test_gp_grouped_kernel_sixty_level_chain(card, P):
    """Chains of unary operators 60 deep beside shorter ones, width 64: 60
    levels of one chunk each, evaluated in order inside one launch."""
    pset = gp.math_set(1)
    names = ("neg", "cos", "sin")
    trees = []
    for depth in (60, 59, 45, 30, 3):
        s = "ARG0"
        for d in range(depth):
            s = f"{names[(d + depth) % 3]}({s})"
        trees.append(gp.from_string(s, pset, 64, device=card))
    pop = {k: torch.cat([t[k] for t in trees]) for k in trees[0]}
    sched, (got, want) = _schedule_case(card, pset, pop, 64, P, 128, P)
    assert len(sched["level_starts"]) - 1 == 60
    assert _same(got, want)


@pytest.mark.parametrize("P", [1, 7, 33, 256])
def test_gp_grouped_kernel_one_level_of_many_chunks(card, P):
    """Trees of depth 1 only: one level of many chunks."""
    pset = gp.math_set(2)
    gen = make_generator(31, card)
    pop = gp.gen_half_and_half(pset, 8, 1, 1)(gen, 4096)
    sched, (got, want) = _schedule_case(card, pset, pop, 8, P, 32, 2 * P)
    assert len(sched["level_starts"]) == 2 and sched["nchunks"] >= 32
    assert _same(got, want)


@pytest.mark.parametrize("P", [1, 7, 33, 256])
def test_gp_grouped_kernel_constant_beside_nan_and_inf(card, P):
    """An operand row holding NaN and inf beside constants: a constant
    replaces the row it points at, as in the plain version."""
    pset = gp.math_set(1, trig=False)
    add = pset.primitives[0]
    chunk = 4
    buf = torch.zeros((1 + 2 * chunk, P), device=card)
    buf[0] = torch.tensor([float("nan"), float("inf"), 1.0, -float("inf")]
                          * P, device=card)[:P]
    src_idx = torch.tensor([[0, 0], [0, 0], [0, 0], [0, 0],
                            [1, 1], [2, 0], [0, 3], [4, 4]],
                           dtype=torch.int32, device=card)
    src_const = torch.full((2 * chunk, 2), 2.0, device=card)
    src_const[1, 1] = float("inf")
    src_isc = torch.tensor([[True, True], [True, False], [False, True],
                            [False, False], [False, True], [True, False],
                            [False, True], [False, False]], device=card)
    chunk_ops = torch.zeros(2, dtype=torch.int32, device=card)
    got, want = _grouped_both(buf, (chunk_ops, src_idx, src_const, src_isc),
                              [add], chunk, 1, [0, 1, 2])
    assert _same(got, want)
    assert got[1].tolist() == [4.0] * P


@pytest.mark.parametrize("extra", [0, 1])
def test_gp_grouped_kernel_takes_its_level_cap_and_refuses_more(card, extra):
    """A chain of ``neg``, one row a chunk and one chunk a level: the
    kernel evaluates ``K9_MAX_LEVELS`` levels in one launch (their starts
    go with the launch, by value) and refuses one more."""
    neg = gp.math_set(1, trig=False).primitives[4]
    nlevels, P = kernels.K9_MAX_LEVELS + extra, 33
    buf = torch.zeros((1 + nlevels, P), device=card)
    buf[0] = torch.linspace(-2, 2, P, device=card)
    args = (torch.zeros(nlevels, dtype=torch.int32, device=card),
            torch.arange(nlevels, dtype=torch.int32, device=card)[:, None],
            torch.zeros((nlevels, 1), device=card),
            torch.zeros((nlevels, 1), dtype=torch.bool, device=card))
    levels = list(range(nlevels + 1))
    if extra:
        with pytest.raises(ValueError, match="depth levels"):
            kernels.gp_grouped_dispatch(buf, *args, [neg], chunk=1,
                                        n_args=1, levels=levels)
        return
    got, want = _grouped_both(buf, args, [neg], 1, 1, levels)
    assert _same(got, want)
    assert _same(got[-1], buf[0])  # an even number of negations


def test_gp_grouped_kernel_empty_mask_runs_the_identity(card):
    """Trees of one terminal: no instruction, the pad chunks run the
    identity branch in one launch."""
    got, want = _grouped_case(card, gp.math_set(1), 50, 16, 9, 8, 3,
                              max_depth=0)
    assert _same(got, want)


def test_gp_grouped_kernel_refuses_a_primitive_without_device_op(card):
    pset = gp.math_set(1)
    pset.add_primitive(torch.tanh, 1, "tanh")
    pop = gp.from_string("tanh(ARG0)", pset, 8, device=card)
    X = torch.linspace(-1, 1, 5, device=card)[:, None]
    with pytest.raises(ValueError, match="tanh.*mode='scan'"):
        gp.make_batch_interpreter(pset, 8, mode="grouped")(pop, X)
    want = torch.tanh(X[:, 0])
    assert _same(gp.make_batch_interpreter(pset, 8, mode="scan")(pop, X)[0],
                 want)


def test_symbreg_on_the_card_goes_through_k9(card):
    pset = gp.math_set(1)
    X = torch.linspace(-1, 1, 64, device=card)[:, None]
    y = X[:, 0] ** 2 + X[:, 0]
    runs = []
    for plain in (False, True):
        gen = make_generator(5, card)
        pop = gp.gen_half_and_half(pset, 48, 1, 2)(gen, 256)
        run = gp.make_symbreg_loop(pset, 48, X, y, device=card)
        if plain:
            run.interpreter.grouped_dispatch = (
                lambda *a, levels, **k: kernels.gp_grouped_dispatch_plain(
                    *a, **k))
        k9 = kernels.gp_grouped_dispatch
        before = (k9.launches, k9.levels)
        calls = []
        unique = run.interpreter.unique
        run.interpreter.unique = lambda *a: calls.append(1) or unique(*a)
        runs.append(run(gen, pop, 4))
        launched = (k9.launches - before[0], k9.levels - before[1])
        # one launch per evaluation (gen 0, then each generation with
        # something to evaluate), the levels counted beside
        assert len(calls) == 1 + sum(1 for ne in runs[-1]["nevals"][1:]
                                     if ne)
        assert launched == ((0, 0) if plain else
                            (len(calls), run.interpreter.levels_run))
    for k in ("nodes", "consts", "length"):
        assert _same(runs[0]["genomes"][k], runs[1]["genomes"][k])
    assert _same(runs[0]["fitness"], runs[1]["fitness"])


# ------------------------------------------------------------ CMA-ES ----

def test_cma_update_on_the_card_equals_it_on_the_cpu(card):
    """One update from the same state and offspring, at
    ``strategies.cma``'s stated tolerances (not bitwise: cuBLAS and the
    CPU sum the float32 products in other orders, and cuSOLVER and LAPACK
    iterate differently)."""
    from deap_tpu_torch import benchmarks, convert
    from deap_tpu_torch.strategies import cma
    assert torch.get_float32_matmul_precision() == "highest"
    strat = cma.Strategy(torch.full((30,), 5.0), sigma=0.5, lambda_=256,
                         device=card)
    gen = make_generator(3, card)
    state = strat.initial_state()
    for _ in range(5):
        pop = strat.generate(gen, state)
        state = strat.update(state, pop, benchmarks.sphere(pop))
    genomes = strat.generate(gen, state)
    values = benchmarks.sphere(genomes)
    got = strat.update(state, genomes, values)
    cpu = cma.Strategy(torch.full((30,), 5.0), sigma=0.5, lambda_=256,
                       device="cpu")
    want = cpu.update(convert.cma_state_from_arrays(
        **convert.cma_state_to_arrays(state), device="cpu"), genomes.cpu(),
        values.cpu())
    errs = cma.state_errors(convert.cma_state_from_arrays(
        **convert.cma_state_to_arrays(got), device="cpu"), want)
    assert errs["ok"], errs


def test_ea_generate_update_runs_on_the_card(card):
    from deap_tpu_torch import benchmarks
    from deap_tpu_torch.strategies import cma
    from deap_tpu_torch.support.stats import fitness_stats
    strat = cma.Strategy(torch.full((10,), 5.0), sigma=0.5, lambda_=20,
                         device=card)
    tb = Toolbox()
    tb.register("evaluate", benchmarks.sphere)
    tb.register("generate", strat.generate)
    tb.register("update", strat.update)
    state, logbook, hof = algorithms.ea_generate_update(
        make_generator(0, card), strat.initial_state(), tb, 100, strat.spec,
        stats=fitness_stats(), halloffame_size=1, device=card)
    mins = logbook.select("min")
    # from ~230 to 1e-7..3e-6 in 100 generations on the CPU over 8 seeds
    assert mins[-1] < 1e-4 and mins[0] > 100
    assert float(hof.fitness[0, 0]) == min(mins)
    assert state.C.device.type == "cuda"
    assert cma.reconstruction_error(state) <= cma.RECON_TOL
