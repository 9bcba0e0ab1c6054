"""Ring migration between demes.

Port of :mod:`deap_tpu.parallel.migration` (the reference's
``migRing``). Two layouts:

- :func:`mig_ring` — demes stacked in one population ``[n_demes, deme,
  ...]`` on one device: the emigrant block is rolled (or permuted by
  ``migarray``) over the deme axis.
- :func:`mig_ring_collective` — one deme a rank: the emigrant block
  rides a ``batch_isend_irecv`` ring over the mesh axis's process group
  (with one rank, the local roll).

``selection`` picks the k emigrants of each deme; ``replacement`` picks
which k rows of the destination are overwritten (default: the rows its
own emigrants came from). The selections take ``(generator, wvalues,
k)``; the default :func:`~deap_tpu_torch.ops.selection.sel_best` draws
nothing.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from deap_tpu_torch.core.population import Population, gather
from deap_tpu_torch.ops.selection import sel_best
from deap_tpu_torch.support.profiling import span

__all__ = ["mig_ring", "mig_ring_collective", "migRing"]


def _deme_wvalues(pops: Population) -> torch.Tensor:
    """Weighted values of stacked demes ``[n_demes, deme, nobj]``; invalid
    rows are -inf."""
    w = pops.fitness * pops.spec.warray(pops.device)
    return torch.where(pops.valid[..., None], w, -torch.inf)


def _deme_map(fn: Callable, pops: Population) -> Population:
    """``fn`` over every stacked leaf (genomes, fitness, valid, extras)."""
    from torch.utils import _pytree as pytree
    return pops.replace(genomes=pytree.tree_map(fn, pops.genomes),
                        fitness=fn(pops.fitness), valid=fn(pops.valid),
                        extras=pytree.tree_map(fn, pops.extras))


def _take_rows(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``a[d, idx[d]]`` for every deme ``d``: ``[n_demes, k, ...]``."""
    demes = torch.arange(a.shape[0], device=a.device)[:, None]
    return a[demes, idx]


def _put_rows(a: torch.Tensor, idx: torch.Tensor,
              rows: torch.Tensor) -> torch.Tensor:
    """``a`` with ``a[d, idx[d]] = rows[d]`` for every deme ``d``."""
    out = a.clone()
    demes = torch.arange(a.shape[0], device=a.device)[:, None]
    out[demes, idx] = rows
    return out


def _check_permutation(dests: Sequence[int], n: int, what: str) -> None:
    if sorted(dests) != list(range(n)):
        raise ValueError(
            f"migarray must be a permutation of {what} indices "
            f"0..{n - 1} (each exactly once, the reference's contract, "
            f"migration.py:29-30); got {list(dests)}")


def mig_ring(generator: torch.Generator, pops: Population, k: int,
             selection: Callable = sel_best,
             replacement: Optional[Callable] = None,
             migarray: Optional[Sequence[int]] = None) -> Population:
    """Ring migration over stacked demes ``[n_demes, deme_size, ...]``.

    Deme i's emigrants overwrite the replaced rows of deme
    ``migarray[i]`` (default ``i+1 mod n``, the serial ring). ``migarray``
    must be a permutation, so every deme sends and receives one block.
    The selections draw deme by deme: every deme's emigrants, then every
    deme's replaced rows."""
    n_demes = pops.valid.shape[0]
    if migarray is None:
        route = lambda r: torch.roll(r, shifts=1, dims=0)
    else:
        dests = [int(d) for d in migarray]
        _check_permutation(dests, n_demes, "deme")
        inv = torch.empty(n_demes, dtype=torch.long)
        inv[torch.tensor(dests)] = torch.arange(n_demes)
        inv = inv.to(pops.device)
        route = lambda r: r[inv]
    w = _deme_wvalues(pops)
    emi_idx = torch.stack([selection(generator, w[d], k)
                           for d in range(n_demes)])
    rep_idx = emi_idx if replacement is None else torch.stack(
        [replacement(generator, w[d], k) for d in range(n_demes)])
    return _deme_map(
        lambda a: _put_rows(a, rep_idx, route(_take_rows(a, emi_idx))), pops)


def _ring_of(mesh, axis_name: str):
    """``(group, size, index)`` of this rank's ring along ``axis_name``:
    the mesh axis's group, or with no mesh the default process group."""
    if mesh is not None:
        return (mesh.group(axis_name), mesh.axis_size(axis_name),
                mesh.axis_index(axis_name))
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return None, dist.get_world_size(), dist.get_rank()
    return None, 1, 0


def ring_permute(tree, dst: int, src: int, me: int, group):
    """Send every tensor leaf of ``tree`` to ring position ``dst`` and
    receive the same shapes from ``src`` (one ``batch_isend_irecv``; a
    bool plane travels as ``uint8``). Sending to itself moves nothing."""
    if dst == me and src == me:
        return tree
    import torch.distributed as dist
    from deap_tpu_torch.support.checkpoint import tree_flatten, tree_unflatten

    def peer(r):
        return r if group is None else dist.get_global_rank(group, r)

    leaves, structure = tree_flatten(tree)
    ops, out = [], []
    for a in leaves:
        if not isinstance(a, torch.Tensor):
            out.append(a)
            continue
        a = a.contiguous()
        wire = a.view(torch.uint8) if a.dtype == torch.bool else a
        buf = torch.empty_like(wire)
        ops.append(dist.P2POp(dist.isend, wire, peer(dst), group))
        ops.append(dist.P2POp(dist.irecv, buf, peer(src), group))
        out.append(buf.view(torch.bool) if a.dtype == torch.bool else buf)
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return tree_unflatten(structure, out)


def mig_ring_collective(generator: torch.Generator, pop: Population, k: int,
                        axis_name: str = "island",
                        selection: Callable = sel_best,
                        replacement: Optional[Callable] = None,
                        migarray: Optional[Sequence[int]] = None,
                        mesh=None) -> Population:
    """Ring migration across ranks, one deme a rank.

    ``pop`` is this rank's deme; its emigrants go to ring position
    ``i+1`` along ``axis_name`` of ``mesh`` (default: the whole process
    group), or to ``migarray[i]`` (a permutation). With one rank it is the
    local roll. Equals :func:`mig_ring` over the demes stacked in rank
    order for a selection that draws nothing (the default)."""
    w = pop.wvalues
    emi_idx = selection(generator, w, k)
    rep_idx = emi_idx if replacement is None else replacement(generator, w,
                                                              k)
    emigrants = gather(pop, emi_idx)
    group, n, me = _ring_of(mesh, axis_name)
    if migarray is None:
        dests = [(i + 1) % n for i in range(n)]
    else:
        dests = [int(d) for d in migarray]
        _check_permutation(dests, n, "slice")
    with span("migration/ppermute"):
        incoming = ring_permute(emigrants, dests[me], dests.index(me), me,
                                group)

    def put(a, r):
        out = a.clone()
        out[rep_idx] = r
        return out

    from torch.utils import _pytree as pytree
    return pop.replace(
        genomes=pytree.tree_map(put, pop.genomes, incoming.genomes),
        extras=pytree.tree_map(put, pop.extras, incoming.extras),
        fitness=put(pop.fitness, incoming.fitness),
        valid=put(pop.valid, incoming.valid))


# DEAP-style alias
migRing = mig_ring
