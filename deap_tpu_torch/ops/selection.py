"""Selection — batched, index-returning.

Port of :mod:`deap_tpu.ops.selection`: the tournaments, random, best
and worst, the counting-sort rank path (:func:`counting_order_desc`,
:func:`sel_tournament_binned`), the fitness-proportionate pair
(:func:`sel_roulette`, :func:`sel_stochastic_universal_sampling`), the
double tournament and the lexicase family. Each random selection draws
in a ``*_draws`` function and picks in a draw-taking core, so a test can
hand it the JAX package's draws. Operators take weighted fitness ``w:
f32[n, nobj]`` and return ``int64[k]`` indices; callers materialise the
selection with :func:`deap_tpu_torch.core.population.gather`.
"""

from __future__ import annotations

from typing import Optional

import torch

from deap_tpu_torch.core.fitness import lex_gt, lex_sort_desc, lexsort
from deap_tpu_torch.ops.linalg import div_rn


def sel_random(generator: torch.Generator, w: torch.Tensor,
               k: int) -> torch.Tensor:
    """``k`` uniform draws with replacement."""
    return torch.randint(0, w.shape[0], (k,), generator=generator,
                         device=generator.device)


def sel_best(generator: torch.Generator, w: torch.Tensor,
             k: int) -> torch.Tensor:
    """The ``k`` lexicographically best rows, best first; ties keep
    ascending index."""
    del generator  # no draw
    return lex_sort_desc(w)[:k]


def sel_worst(generator: torch.Generator, w: torch.Tensor,
              k: int) -> torch.Tensor:
    """The ``k`` lexicographically worst rows, worst first; ties keep
    ascending index."""
    del generator  # no draw
    return lexsort([w[:, j] for j in range(w.shape[-1] - 1, -1, -1)])[:k]


def _tournament_winners(w: torch.Tensor,
                        aspirants: torch.Tensor) -> torch.Tensor:
    """Lexicographic-best aspirant per row; ties go to the earliest
    drawn, like Python's ``max``."""
    best = aspirants[..., 0]
    for j in range(1, aspirants.shape[-1]):
        cand = aspirants[..., j]
        best = torch.where(lex_gt(w[cand], w[best]), cand, best)
    return best


def tournament_aspirants(generator: torch.Generator, n: int, k: int,
                         tournsize: int) -> torch.Tensor:
    """The aspirant draw: ``int64[k, tournsize]`` uniform in ``[0, n)``."""
    return torch.randint(0, n, (k, tournsize), generator=generator,
                         device=generator.device)


def sel_tournament(generator: torch.Generator, w: torch.Tensor, k: int,
                   tournsize: int) -> torch.Tensor:
    """``k`` tournaments of ``tournsize`` uniform aspirants."""
    aspirants = tournament_aspirants(generator, w.shape[0], k, tournsize)
    return _tournament_winners(w, aspirants)


def sel_tournament_sorted(generator: torch.Generator, w: torch.Tensor,
                          k: int, tournsize: int) -> torch.Tensor:
    """Tournament selection via ranks: the winner of ``tournsize`` uniform
    draws is ``order[min(ranks)]`` with ``order`` the stable best-first
    sort. Same winner distribution as :func:`sel_tournament`; ties break
    by population index instead of draw order."""
    order = lex_sort_desc(w)
    ranks = torch.randint(0, w.shape[0], (tournsize, k), generator=generator,
                          device=generator.device)
    return order[ranks.amin(0)]


#: tile of the ``'mxu'`` prefix: a float32 ``tril(ones(T, T)) @ onehot``
#: counts at most ``T`` per tile, exact
_PREFIX_TILE = 128
#: ``counting_order_desc(mode='auto')``'s choice on the card: the faster
#: mode in ``chip_smoke.py``'s timing at pop 100k over 101 buckets on an
#: H100 (``'mxu'`` 300.54 us, ``'scan'`` 331.01; PERF.md)
AUTO_COUNTING_MODE = "mxu"


def counting_order_desc(values: torch.Tensor, low: int, high: int,
                        mode: str = "auto") -> torch.Tensor:
    """Best-first permutation of integer-valued fitnesses without a
    comparison sort: a counting sort over ``high - low + 1`` buckets,
    stable (ties keep ascending index), so it equals
    :func:`deap_tpu_torch.core.fitness.lex_sort_desc` of ``values[:,
    None]`` for integer values in ``[low, high]`` (values are rounded and
    clipped into the buckets, as in the JAX package).

    ``mode`` picks how the occurrence number of each row within its bucket
    is computed; every mode gives the same permutation:

    - ``'scan'``: a cumulative sum down the ``[n, B]`` one-hot;
    - ``'mxu'``: the JAX package's tiled prefix, rows in tiles of 128,
      each tile's inclusive prefix a float32 ``tril(ones) @ onehot``
      (``torch.matmul``, exact for counts up to 128), the tiles stitched
      by an exclusive sum of their totals (exact below 2^24 rows; larger
      inputs take ``'scan'``);
    - ``'auto'``: ``AUTO_COUNTING_MODE`` on the card, ``'scan'`` on the
      CPU.

    :returns: ``int64[n]`` row indices, best first.
    """
    n = values.shape[0]
    dev = values.device
    nbins = int(high) - int(low) + 1
    b = (torch.round(values).to(torch.int32) - low).clamp(0, nbins - 1)
    if mode == "auto":
        mode = AUTO_COUNTING_MODE if dev.type == "cuda" else "scan"
    if mode == "mxu" and n >= (1 << 24):
        mode = "scan"
    bins = torch.arange(nbins, dtype=torch.int32, device=dev)
    # the prefix sums run along the last, contiguous axis: bucket-major
    # [B, n] (a cumsum down the rows of [n, B] takes n serial steps on the
    # card)
    if mode == "scan":
        onehot = (bins[:, None] == b[None, :]).to(torch.int32)   # [B, n]
        within = torch.cumsum(onehot, 1, dtype=torch.int32).gather(
            0, b[None, :].long())[0] - 1
        counts = onehot.sum(1, dtype=torch.int32)
    elif mode == "mxu":
        T = _PREFIX_TILE
        G = -(-n // T)
        # padding rows take bucket nbins: all-zero one-hot rows, last, so
        # invisible to the counts and to every real prefix
        bp = torch.full((G * T,), nbins, dtype=torch.int32, device=dev)
        bp[:n] = b
        onehot = (bp[:, None] == bins).to(torch.float32).reshape(G, T, nbins)
        tril = torch.tril(torch.ones((T, T), dtype=torch.float32, device=dev))
        ptile = torch.matmul(tril, onehot)               # [G, T, B] inclusive
        tot_t = ptile[:, -1, :].T.contiguous()           # [B, G]
        base = (torch.cumsum(tot_t, 1) - tot_t).T        # exclusive over tiles
        incl = (ptile + base[:, None, :]).reshape(G * T, nbins)
        within = incl[:n].gather(1, b[:, None].long())[:, 0].to(
            torch.int32) - 1
        counts = tot_t.sum(1).to(torch.int32)
    else:
        raise ValueError(f"unknown counting_order_desc mode {mode!r}")
    # descending buckets: bucket k starts after all strictly better ones
    starts_desc = torch.flip(torch.cumsum(torch.flip(counts, (0,)), 0),
                             (0,)) - counts
    pos = (starts_desc[b.long()] + within).long()
    order = torch.empty(n, dtype=torch.int64, device=dev)
    order[pos] = torch.arange(n, dtype=torch.int64, device=dev)
    return order


def sel_tournament_binned(generator: torch.Generator, w: torch.Tensor,
                          k: int, tournsize: int, low: int,
                          high: int) -> torch.Tensor:
    """:func:`sel_tournament_sorted` for integer-valued single-objective
    fitness: the same winners for the same generator state (the ranks are
    drawn as it draws them, and the rank → index permutation is the same),
    with the comparison sort replaced by :func:`counting_order_desc`.

    :param w: ``[n, 1]`` weighted values, integers in ``[low, high]``;
        values outside the range, or not integers, raise (the counting
        sort would misrank them without a signal). The check reads three
        numbers back from the device, in one transfer.
    """
    if w.shape[0]:
        v = w[:, 0]
        mn, mx, off = torch.stack([v.min(), v.max(), (
            v - torch.round(v)).abs().max()]).tolist()  # one read-back
        if mn < low or mx > high:
            raise ValueError(
                f"sel_tournament_binned: fitness values span [{mn}, {mx}], "
                f"outside the declared integer range [{low}, {high}]")
        if not off <= 1e-6:
            raise ValueError(
                "sel_tournament_binned: fitness values are not "
                "integer-valued; the counting sort would misrank them")
    order = counting_order_desc(w[:, 0], low, high)
    ranks = torch.randint(0, w.shape[0], (tournsize, k), generator=generator,
                          device=generator.device)
    return order[ranks.amin(0)]


# ------------------------------------------- fitness-proportionate ----

def _validate_positive_mass(values: torch.Tensor, name: str) -> None:
    """The roulette family's contract: non-negative values with a
    positive total (one read-back of two numbers)."""
    if values.shape[0]:
        mn, total = torch.stack([values.min(), values.sum()]).tolist()
        if mn < 0 or not total > 0:
            raise ValueError(
                f"{name}: fitness-proportionate selection needs "
                f"non-negative values with positive total mass; got "
                f"min={mn}, sum={total}")


def _cumulative(w: torch.Tensor, values: Optional[torch.Tensor]):
    """The best-first order and the cumulative values along it."""
    if values is None:
        values = w[..., 0]
    order = lex_sort_desc(w)
    return order, torch.cumsum(values[order], 0)


def _roulette(w, u, values=None):
    """Roulette on given uniforms ``u [k]`` (see :func:`sel_roulette`)."""
    order, cs = _cumulative(w, values)
    # the first index whose cumulative value exceeds the spin
    pick = torch.searchsorted(cs, u * cs[-1], right=True)
    return order[torch.clamp(pick, 0, w.shape[0] - 1)]


def sel_roulette(generator: torch.Generator, w: torch.Tensor, k: int,
                 values: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fitness-proportionate selection on the first objective: the rows
    sorted best first, ``k`` spins over their cumulative values
    (``values`` default to ``w[:, 0]``, which must be non-negative with a
    positive total)."""
    _validate_positive_mass(w[..., 0] if values is None else values,
                            "sel_roulette")
    u = torch.rand(k, generator=generator, device=generator.device)
    return _roulette(w, u, values)


def _sus(w, k: int, u, values=None):
    """SUS on a given uniform ``u`` (0-d; see
    :func:`sel_stochastic_universal_sampling`)."""
    order, cs = _cumulative(w, values)
    distance = div_rn(cs[-1], float(k))
    points = u * distance + distance * torch.arange(
        k, device=w.device).to(cs.dtype)
    pick = torch.searchsorted(cs, points, right=False)
    return order[torch.clamp(pick, 0, w.shape[0] - 1)]


def sel_stochastic_universal_sampling(generator: torch.Generator,
                                      w: torch.Tensor, k: int,
                                      values: Optional[torch.Tensor] = None
                                      ) -> torch.Tensor:
    """Stochastic universal sampling (Baker 1987): ``k`` evenly spaced
    pointers from one random start over the best-first cumulative
    values."""
    _validate_positive_mass(w[..., 0] if values is None else values,
                            "sel_stochastic_universal_sampling")
    u = torch.rand((), generator=generator, device=generator.device)
    return _sus(w, k, u, values)


#: the roulette family against the JAX package's on its own uniforms: on
#: integer-valued fitness (exact sums) the picks are bitwise; on
#: fractional fitness torch's ``cumsum`` and XLA's add in other orders, so
#: a pick may move to a neighbour where a pointer lies within
#: ``ROULETTE_RTOL`` of the total from a cumulative boundary
#: (``tests/test_torch_ops_rest.py``)
ROULETTE_RTOL = 1e-5


# ------------------------------------------------- double tournament ----

def double_tournament_draws(generator: torch.Generator, n: int, k: int,
                            fitness_size: int, fitness_first: bool):
    """The draws of :func:`sel_double_tournament`: the aspirants
    (``[k, 2, fitness_size]`` fitness first, else ``[k, fitness_size,
    2]``), then the size round's uniforms (``[k]``, else ``[k,
    fitness_size]``)."""
    dev = generator.device
    shape = (k, 2, fitness_size) if fitness_first else (k, fitness_size, 2)
    aspirants = torch.randint(0, n, shape, generator=generator, device=dev)
    u = torch.rand(shape[:1] if fitness_first else shape[:2],
                   generator=generator, device=dev)
    return aspirants, u


def _double_tournament(w, lengths, aspirants, u, parsimony_size: float,
                       fitness_first: bool):
    """The double tournament on given draws."""
    base_prob = parsimony_size / 2.0

    def size_round(i1, i2):
        l1, l2 = lengths[i1], lengths[i2]
        first = torch.where(l1 > l2, i2, i1)
        second = torch.where(l1 > l2, i1, i2)
        p = torch.where(l1 == l2, 0.5, base_prob).to(u.dtype)
        return torch.where(u < p, first, second)

    if fitness_first:
        finalists = _tournament_winners(w, aspirants)      # [k, 2]
        return size_round(finalists[:, 0], finalists[:, 1])
    cands = size_round(aspirants[..., 0], aspirants[..., 1])  # [k, fs]
    return _tournament_winners(w, cands)


def sel_double_tournament(generator: torch.Generator, w: torch.Tensor,
                          lengths: torch.Tensor, k: int, fitness_size: int,
                          parsimony_size: float,
                          fitness_first: bool) -> torch.Tensor:
    """Luke and Panait's double tournament: a fitness tournament of
    ``fitness_size`` and a two-way size tournament on ``lengths``, in
    either order, the shorter winning the size round with probability
    ``parsimony_size / 2`` (0.5 on equal lengths)."""
    aspirants, u = double_tournament_draws(generator, w.shape[0], k,
                                           fitness_size, fitness_first)
    return _double_tournament(w, lengths, aspirants, u, parsimony_size,
                              fitness_first)


# ------------------------------------------------------------ lexicase ----

def lexicase_draws(generator: torch.Generator, k: int, ncases: int):
    """The draws of the lexicase family: a case order a pick (``[k,
    ncases]``, each a uniform permutation), then a uniform a pick for the
    final choice."""
    dev = generator.device
    orders = torch.argsort(torch.rand((k, ncases), generator=generator,
                                      device=dev), dim=1)
    u = torch.rand(k, generator=generator, device=dev)
    return orders, u


def _masked_median(vals, mask):
    """Median of ``vals [k, n]`` over ``mask`` a row, as the JAX
    package's: the sorted values with the rest at +inf, the mean of the
    two middle ones."""
    s = torch.sort(torch.where(mask, vals, torch.inf), dim=1).values
    m = mask.sum(1)
    n = vals.shape[1]
    lo = s.gather(1, torch.clamp_min((m - 1) // 2, 0)[:, None])[:, 0]
    hi = s.gather(1, torch.clamp(m // 2, 0, n - 1)[:, None])[:, 0]
    return 0.5 * (lo + hi)


def _lexicase(values, weights, orders, u, survive):
    """Lexicase picks on given draws: for each pick, the candidates that
    survive each case in its order, then ``jax.random.choice(p=...)``'s
    formula on the uniform: the first row whose cumulative share reaches
    ``total · (1 - u)``."""
    n = values.shape[0]
    k, ncases = orders.shape
    weights = torch.as_tensor(weights, dtype=values.dtype,
                              device=values.device)
    maximize = weights > 0
    mask = torch.ones((k, n), dtype=torch.bool, device=values.device)
    for c in range(ncases):
        case = orders[:, c]
        v = values[:, case].T                                # [k, n]
        mx = maximize[case]
        hi = torch.where(mask, v, -torch.inf).amax(1)
        lo = torch.where(mask, v, torch.inf).amin(1)
        best = torch.where(mx, hi, lo)
        mask = mask & survive(v, mask, best[:, None], mx[:, None])
    p = mask.to(values.dtype) / mask.sum(1, keepdim=True).to(values.dtype)
    cs = torch.cumsum(p, 1)
    r = cs[:, -1:] * (1 - u[:, None])
    return torch.searchsorted(cs, r)[:, 0]


def _survive_exact(v, mask, best, maximize):
    return v == best


def sel_lexicase(generator: torch.Generator, values: torch.Tensor, weights,
                 k: int) -> torch.Tensor:
    """Lexicase selection (Spector): per pick, the cases in a random
    order, each keeping the candidates that equal the best on it;
    ``values [n, ncases]``, ``weights [ncases]`` (positive: maximise)."""
    return _lexicase(values, weights,
                     *lexicase_draws(generator, k, values.shape[1]),
                     _survive_exact)


def _survive_epsilon(epsilon):
    def survive(v, mask, best, maximize):
        return torch.where(maximize, v >= best - epsilon,
                           v <= best + epsilon)
    return survive


def sel_epsilon_lexicase(generator: torch.Generator, values: torch.Tensor,
                         weights, k: int, epsilon: float) -> torch.Tensor:
    """ε-lexicase (La Cava et al. 2016): a candidate survives a case
    within ``epsilon`` of the best."""
    return _lexicase(values, weights,
                     *lexicase_draws(generator, k, values.shape[1]),
                     _survive_epsilon(epsilon))


def _survive_automatic(v, mask, best, maximize):
    med = _masked_median(v, mask)[:, None]
    mad = _masked_median((v - med).abs(), mask)[:, None]
    return torch.where(maximize, v >= best - mad, v <= best + mad)


def sel_automatic_epsilon_lexicase(generator: torch.Generator,
                                   values: torch.Tensor, weights,
                                   k: int) -> torch.Tensor:
    """Automatic ε-lexicase: ε is the median absolute deviation of the
    surviving candidates' values on the case."""
    return _lexicase(values, weights,
                     *lexicase_draws(generator, k, values.shape[1]),
                     _survive_automatic)
