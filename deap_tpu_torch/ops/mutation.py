"""Mutations on a batch of genomes.

Port of :mod:`deap_tpu.ops.mutation`: ``mut_flip_bit``,
``mut_gaussian``, ``mut_polynomial_bounded``, ``mut_uniform_int``,
``mut_shuffle_indexes``, ``mut_es_log_normal``, ``strategy_floor`` and
``mut_two_opt``: ``(generator, g[n, L], ...) -> g`` (the ES mutation
takes and returns the strategies too). ``genome_vmap`` has no
counterpart: the port's operators are batched and draw from one
generator.
A ``fused_plan(**params)`` tag returns ``(kind, draw)`` where
``draw(generator, n, L, dtype) -> (mask, arg)`` makes exactly the
operator's draws, so the fused variation plane computes the same
children: ``("flip", ...)`` for flip-bit, ``("add", ...)`` with the
Gaussian noise for ``mut_gaussian``, ``("set", ...)`` with the redrawn
values for ``mut_uniform_int``. The other mutations have no fused form. Each real-valued operator's draws are made by a ``*_draws``
function and applied by a draw-taking core.
"""

from __future__ import annotations

import torch


def _flip_mask(generator, n: int, L: int, indpb: float) -> torch.Tensor:
    u = torch.rand((n, L), generator=generator, device=generator.device)
    return u < indpb


def mut_flip_bit(generator, g: torch.Tensor, indpb: float) -> torch.Tensor:
    """Bit flip: logical-not of each gene with probability ``indpb``."""
    mask = _flip_mask(generator, g.shape[0], g.shape[-1], indpb)
    flipped = (~g.to(torch.bool)).to(g.dtype)
    return torch.where(mask, flipped, g)


def _flip_bit_fused(indpb):
    def draw(generator, n, L, dtype):
        del dtype  # flip needs no values, only the operator's mask bits
        return _flip_mask(generator, n, L, indpb), None
    return "flip", draw


mut_flip_bit.fused_plan = _flip_bit_fused


# --------------------------------------------------------- gaussian ----

def gaussian_draws(generator, shape, indpb: float):
    """The draws of :func:`mut_gaussian` per gene: the mutation mask
    (probability ``indpb``), then a standard normal."""
    dev = generator.device
    mask = torch.rand(shape, generator=generator, device=dev) < indpb
    z = torch.randn(shape, generator=generator, device=dev)
    return mask, z


def _gaussian(g, mu, sigma, mask, z):
    """Gaussian mutation on given draws (see :func:`mut_gaussian`)."""
    return torch.where(mask, g + (mu + sigma * z), g)


def mut_gaussian(generator, g: torch.Tensor, mu, sigma,
                 indpb: float) -> torch.Tensor:
    """Gaussian additive mutation: each gene gets ``+ N(mu, sigma)`` with
    probability ``indpb``."""
    return _gaussian(g, mu, sigma, *gaussian_draws(generator, g.shape, indpb))


def _gaussian_fused(mu, sigma, indpb):
    def draw(generator, n, L, dtype):
        del dtype  # the noise is float32, as K1's add kind takes it
        mask, z = gaussian_draws(generator, (n, L), indpb)
        return mask, mu + sigma * z
    return "add", draw


mut_gaussian.fused_plan = _gaussian_fused


# ------------------------------------------------------ uniform int ----

def uniform_int_draws(generator, shape, indpb: float):
    """The draws of :func:`mut_uniform_int` per gene: the mask
    (probability ``indpb``), then the uniform."""
    dev = generator.device
    mask = torch.rand(shape, generator=generator, device=dev) < indpb
    u = torch.rand(shape, generator=generator, device=dev)
    return mask, u


def _uniform_int_values(u, low, up, dtype):
    """``low + floor(u · (up - low + 1))`` with the JAX package's dtype
    steps: the bounds in the genome dtype, the product and the floor in
    float32, then the cast."""
    low_a = torch.as_tensor(low, dtype=dtype, device=u.device)
    up_a = torch.as_tensor(up, dtype=dtype, device=u.device)
    return (low_a + torch.floor(u * (up_a - low_a + 1))).to(dtype)


def _uniform_int(g, low, up, mask, u):
    """Uniform integer mutation on given draws (see :func:`mut_uniform_int`)."""
    return torch.where(mask, _uniform_int_values(u, low, up, g.dtype), g)


def mut_uniform_int(generator, g: torch.Tensor, low, up,
                    indpb: float) -> torch.Tensor:
    """Uniform integer mutation: each gene, with probability ``indpb``, is
    redrawn in ``[low, up]`` (inclusive; scalars or per-gene sequences)."""
    return _uniform_int(g, low, up, *uniform_int_draws(generator, g.shape,
                                                        indpb))


def _uniform_int_fused(low, up, indpb):
    def draw(generator, n, L, dtype):
        mask, u = uniform_int_draws(generator, (n, L), indpb)
        return mask, _uniform_int_values(u, low, up, dtype)
    return "set", draw


mut_uniform_int.fused_plan = _uniform_int_fused


# -------------------------------------------------- shuffle indexes ----

def shuffle_indexes_draws(generator, shape, indpb: float):
    """The draws of :func:`mut_shuffle_indexes` per slot: the swap mask
    (probability ``indpb``), then the partner ``U{0..L-2}`` (bumped past
    the slot by the core)."""
    dev = generator.device
    L = shape[-1]
    do = torch.rand(shape, generator=generator, device=dev) < indpb
    raw = torch.randint(0, max(L - 1, 1), shape, generator=generator,
                        device=dev)
    return do, raw


def _shuffle_indexes(g, do, raw):
    """Index shuffling on given draws: for each slot ``i`` in order where
    ``do[:, i]``, swap it with slot ``raw + (raw >= i)`` (a partner past
    the last slot, at L 1, is read clamped and never written, as XLA's
    gather and scatter treat it)."""
    g = g.clone()
    n, L = g.shape
    rows = torch.arange(n, device=g.device)
    for i in range(L):
        j = raw[:, i] + (raw[:, i] >= i).to(raw.dtype)
        inside = j < L
        jr = torch.clamp_max(j, L - 1)
        vi, vj = g[:, i].clone(), g[rows, jr]
        on = do[:, i]
        g[:, i] = torch.where(on, vj, vi)
        g[rows, jr] = torch.where(on & inside, vi, g[rows, jr])
    return g


def mut_shuffle_indexes(generator, g: torch.Tensor,
                        indpb: float) -> torch.Tensor:
    """Positional shuffle: slot by slot, each swaps with a uniform other
    slot with probability ``indpb``."""
    return _shuffle_indexes(g, *shuffle_indexes_draws(generator, g.shape,
                                                      indpb))


# ----------------------------------------------- polynomial bounded ----

def polynomial_bounded_draws(generator, shape, indpb: float):
    """The draws of :func:`mut_polynomial_bounded` per gene: the
    mutation mask (probability ``indpb``), then the uniform."""
    dev = generator.device
    mask = torch.rand(shape, generator=generator, device=dev) < indpb
    rand = torch.rand(shape, generator=generator, device=dev)
    return mask, rand


def _polynomial_bounded(g, eta, low, up, mask, rand):
    """Polynomial bounded mutation on given draws."""
    low = torch.as_tensor(low, dtype=g.dtype, device=g.device)
    up = torch.as_tensor(up, dtype=g.dtype, device=g.device)
    span = up - low
    delta_1 = (g - low) / span
    delta_2 = (up - g) / span
    mut_pow = 1.0 / (eta + 1.0)
    val_lo = 2.0 * rand + (1.0 - 2.0 * rand) * (1.0 - delta_1) ** (eta + 1.0)
    val_hi = (2.0 * (1.0 - rand)
              + 2.0 * (rand - 0.5) * (1.0 - delta_2) ** (eta + 1.0))
    delta_q = torch.where(rand < 0.5, val_lo ** mut_pow - 1.0,
                          1.0 - val_hi ** mut_pow)
    out = torch.minimum(torch.maximum(g + delta_q * span, low), up)
    return torch.where(mask, out, g)


def mut_polynomial_bounded(generator, g: torch.Tensor, eta, low, up,
                           indpb: float) -> torch.Tensor:
    """Deb's polynomial bounded mutation: each gene with probability
    ``indpb``, distribution index ``eta``, clipped to ``[low, up]``."""
    return _polynomial_bounded(
        g, eta, low, up, *polynomial_bounded_draws(generator, g.shape, indpb))


# ------------------------------------------------------ ES log-normal ----
#
# The port rounds each operation in float32, as the JAX package's
# ``mut_es_log_normal`` computes eagerly; inside a jitted ``lax.scan`` XLA
# may contract ``t0·n0 + t·n1`` and ``g + s·n2`` into fused multiply-adds,
# and torch's ``exp`` is not XLA's. On the same draws the port's strategy
# ``s'`` is within ``ES_ULPS`` units in the last place of the JAX one plus
# ``ES_ARG_ULPS`` of the exponent's magnitude ``|t0·n0| + |t·n1|`` (times
# ``s'``, the exponent's rounding carried through ``exp``), and its gene
# within one ulp of the gene plus one of the step ``s'·n2`` plus the
# strategy's bound times ``|n2|``. Measured on the CPU (one sweep of
# m 1000-4000 rows, L 1-100, c 0.5-5): at most 2 ulp plus no exponent
# term eagerly, 2 ulp plus 1.94 exponent ulps in the scan.
ES_ULPS, ES_ARG_ULPS = 4, 2

def es_log_normal_draws(generator, shape, indpb: float):
    """The draws of :func:`mut_es_log_normal` for ``shape = [m, L]``: one
    global normal ``n0`` a row (``[m]``), the gene mask (probability
    ``indpb``), then the normals ``n1`` and ``n2`` a gene."""
    dev = generator.device
    n0 = torch.randn(shape[0], generator=generator, device=dev)
    mask = torch.rand(shape, generator=generator, device=dev) < indpb
    n1 = torch.randn(shape, generator=generator, device=dev)
    n2 = torch.randn(shape, generator=generator, device=dev)
    return n0, mask, n1, n2


def _es_log_normal(g, strategy, c, n0, mask, n1, n2):
    """The ES log-normal mutation on given draws (see
    :func:`mut_es_log_normal`), every operation rounded in float32."""
    size = torch.tensor(float(g.shape[-1]), dtype=torch.float32,
                        device=g.device)
    t = c / torch.sqrt(2.0 * torch.sqrt(size))
    t0 = c / torch.sqrt(2.0 * size)
    new_s = strategy * torch.exp(t0 * n0[:, None] + t * n1)
    new_g = g + new_s * n2
    return torch.where(mask, new_g, g), torch.where(mask, new_s, strategy)


def mut_es_log_normal(generator, g: torch.Tensor, strategy: torch.Tensor, c,
                      indpb: float):
    """Self-adaptive ES mutation (Beyer and Schwefel 2002): per row one
    global normal ``n0`` scales the strategies (``t0 = c / sqrt(2 L)``);
    each gene, with probability ``indpb``, takes the strategy ``s ·
    exp(t0 n0 + t n1)`` (``t = c / sqrt(2 sqrt(L))``) and the value ``g +
    s' n2``. Returns ``(g, strategy)``."""
    return _es_log_normal(g, strategy, c,
                          *es_log_normal_draws(generator, g.shape, indpb))


def strategy_floor(minstrategy: float):
    """A decorator that floors the strategies a mutation returns at
    ``minstrategy`` (the reference's ``checkStrategy`` in its ES
    examples)."""
    def decorator(mut):
        def wrapper(*args, **kwargs):
            g, s = mut(*args, **kwargs)
            return g, torch.maximum(s, torch.full_like(s, minstrategy))
        return wrapper
    return decorator


# ------------------------------------------------------------ 2-opt ----

def mut_two_opt(generator, g: torch.Tensor, dist: torch.Tensor,
                steps=None) -> torch.Tensor:
    """Best-improvement 2-opt on permutation genomes ``g [n, L]`` over the
    symmetric distances ``dist [L, L]``: ``steps`` times (``L`` by
    default), every row takes its most improving reversal of
    ``g[i+1..j]`` (the first in row-major order of ``(i, j)``, ``i < j``)
    where one improves, else stays. Deterministic; ``generator`` is
    unused."""
    del generator
    n, L = g.shape
    steps = L if steps is None else int(steps)
    pos = torch.arange(L, device=g.device)
    upper = pos[:, None] < pos[None, :]
    rows = torch.arange(n, device=g.device)[:, None]
    perm = g.to(torch.int64)
    for _ in range(steps):
        nxt = torch.roll(perm, -1, dims=1)
        d_pp = dist[perm[:, :, None], perm[:, None, :]]
        d_nn = dist[nxt[:, :, None], nxt[:, None, :]]
        d_edge = dist[perm, nxt]
        delta = d_pp + d_nn - d_edge[:, :, None] - d_edge[:, None, :]
        delta = torch.where(upper, delta, torch.inf)
        flat = torch.argmin(delta.reshape(n, L * L), dim=1)
        i, j = flat // L, flat % L
        improving = delta.reshape(n, L * L)[rows[:, 0], flat] < 0
        inside = (pos > i[:, None]) & (pos <= j[:, None])
        newpos = torch.where(inside, i[:, None] + 1 + j[:, None] - pos, pos)
        perm = torch.where(improving[:, None], perm[rows, newpos], perm)
    return perm.to(g.dtype)
