"""Genome-axis sharding — genomes too large for one device.

Port of :mod:`deap_tpu.parallel.genome_shard`. The feature axis of the
population is split over a ``"genome"`` mesh axis: each rank computes a
partial per-individual result on its slice of the genes and the partials
are reduced over the axis's process group, so no rank holds a whole
genome. With a ``"pop"`` axis beside it, a 2-D ``("pop", "genome")`` mesh
shards both axes.

The partial evaluation and the reduction each run in a named span
(``genome_shard/partial_eval``, ``genome_shard/<psum|pmean|pmax>``) so a
trace attributes cross-shard time to the collective.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from deap_tpu_torch.device import DeviceLike
from deap_tpu_torch.parallel.mesh import (Mesh, _block, _world,
                                          population_mesh)
from deap_tpu_torch.support.profiling import span

__all__ = ["genome_mesh", "make_sharded_evaluator", "shard_genomes"]


def genome_mesh(n_pop_shards: Optional[int] = None,
                n_genome_shards: Optional[int] = None,
                device: DeviceLike = None) -> Mesh:
    """A 2-D ``("pop", "genome")`` mesh over the process group (default:
    every rank on the genome axis)."""
    n_dev = _world()[0]
    if n_genome_shards is None:
        n_genome_shards = n_dev if n_pop_shards is None else (
            n_dev // n_pop_shards)
    if n_pop_shards is None:
        n_pop_shards = n_dev // n_genome_shards
    if n_pop_shards < 1 or n_genome_shards < 1 or (
            n_pop_shards * n_genome_shards > n_dev):
        raise ValueError(
            f"requested {n_pop_shards} pop x {n_genome_shards} genome "
            f"shards but only {n_dev} devices are available")
    return population_mesh(n_pop_shards * n_genome_shards,
                           axis_names=("pop", "genome"),
                           shape=(n_pop_shards, n_genome_shards),
                           device=device)


def _plan_mesh(mesh) -> Mesh:
    """A :class:`Mesh`, or a :class:`~deap_tpu_torch.parallel.
    ShardingPlan`'s mesh."""
    return mesh.mesh if hasattr(mesh, "mesh") else mesh


def shard_genomes(genomes: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's block of a ``[n, L]`` genome matrix: rows over
    ``"pop"``, genes over ``"genome"``, on the rank's device. ``mesh``
    may be a :class:`~deap_tpu_torch.parallel.ShardingPlan`."""
    mesh = _plan_mesh(mesh)
    r0, r1 = _block(genomes.shape[0], mesh.axis_size("pop"),
                    mesh.axis_index("pop"))
    c0, c1 = _block(genomes.shape[1], mesh.axis_size("genome"),
                    mesh.axis_index("genome"))
    with span("genome_shard/reshard"):
        return genomes[r0:r1, c0:c1].to(mesh.device)


#: collective span name per ``combine`` mode
_COMBINE_NAMES = {"sum": "psum", "mean": "pmean", "max": "pmax"}


def make_sharded_evaluator(partial_eval: Callable, mesh,
                           combine: str = "sum") -> Callable:
    """Build ``evaluate(block [n_local, L_local]) -> f32[n_local]``: runs
    ``partial_eval`` on this rank's block (:func:`shard_genomes`) and
    reduces the partials over the ``"genome"`` axis — all-reduce sum for
    ``"sum"``, the sum divided by the axis size for ``"mean"``, max for
    ``"max"``. Every rank of a ``"genome"`` line gets its rows' whole
    fitness. ``mesh`` may be a :class:`~deap_tpu_torch.parallel.
    ShardingPlan`."""
    if combine not in _COMBINE_NAMES:
        raise ValueError(combine)
    mesh = _plan_mesh(mesh)
    cname = _COMBINE_NAMES[combine]
    group = mesh.group("genome")
    parts = mesh.axis_size("genome")

    def evaluate(block: torch.Tensor) -> torch.Tensor:
        with span("genome_shard/partial_eval"):
            part = partial_eval(block)
        with span(f"genome_shard/{cname}"):
            if group is not None:
                import torch.distributed as dist
                part = part.contiguous()
                op = (dist.ReduceOp.MAX if combine == "max"
                      else dist.ReduceOp.SUM)
                dist.all_reduce(part, op=op, group=group)
            if combine == "mean":
                part = part / torch.full((), parts, dtype=part.dtype,
                                         device=part.device)
            return part

    return evaluate
