"""Selection — batched, index-returning.

Port of the tournament, random, best and worst parts of
:mod:`deap_tpu.ops.selection`, with the counting-sort rank path
(:func:`counting_order_desc`, :func:`sel_tournament_binned`). Operators take weighted fitness ``w:
f32[n, nobj]`` and return ``int64[k]`` indices; callers materialise the
selection with :func:`deap_tpu_torch.core.population.gather`.
"""

from __future__ import annotations

import torch

from deap_tpu_torch.core.fitness import lex_gt, lex_sort_desc, lexsort


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
