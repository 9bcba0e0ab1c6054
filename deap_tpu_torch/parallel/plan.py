"""ShardingPlan — the one sharding plan every loop consumes.

Port of :mod:`deap_tpu.parallel.plan`. The JAX plan places a carry on a
``jax.sharding.Mesh`` leaf by leaf and compiles one global program whose
collectives XLA inserts; sharding is layout, so the program computes the
same bits on any mesh size, and a checkpoint written on 8 devices
resumes on 4 or 1.

The port keeps that contract with one process per device
(:mod:`deap_tpu_torch.parallel.mesh`):

- The **leaf rule** is the JAX one, value-free: a leaf's leading axis is
  sharded over the plan axis when it divides the shard count; scalars,
  generators and odd sizes are replicated; with ``axis2``, leaves of
  rank 2 or more whose second dim divides the second axis shard over
  both.
- Every rank holds the **whole** carry. What reads the whole population
  (selection's weighted values, ``nd_rank``, statistics, the hall of
  fame, a strategy's update) runs on it identically on every rank, in
  the one-process order. The per-row work (variation, evaluation) runs
  on the rank's block of rows (:meth:`rows`) and is all-gathered back
  (:meth:`gather_rows`), the draws made in full on every rank and
  sliced, so nothing a loop computes depends on the rank count. A leaf
  whose rows do not divide the shard count runs whole on every rank, as
  the JAX rule replicates it. (The population is gathered once a
  generation either way, for selection; holding the gathered copy as
  the carry costs no second gather.)
- Every rank draws from a generator in the same state, and a loop
  returns the whole result on every rank.
- PyTorch has no buffer donation: :meth:`compile` accepts
  ``donate_argnums`` and changes nothing, and :meth:`place` with
  ``fresh`` copies so the caller's tensors survive either way.

Checkpoints written under a plan store each row-sharded leaf per shard
(format 3, :mod:`deap_tpu_torch.support.checkpoint`), stamped with
:meth:`describe`, and restore onto any plan through :meth:`place`.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import torch

from deap_tpu_torch.device import DeviceLike
from deap_tpu_torch.parallel.mesh import (Mesh, _world, population_mesh,
                                          sharding_mode)
from deap_tpu_torch.support.profiling import span

__all__ = ["ShardingPlan"]


def tree_map(fn: Callable, tree: Any) -> Any:
    """``fn`` over every leaf of ``tree`` (dicts, lists, tuples,
    namedtuples and dataclasses such as a Population are structure, as
    in the checkpoint's flattening)."""
    from deap_tpu_torch.support.checkpoint import tree_flatten, tree_unflatten
    leaves, structure = tree_flatten(tree)
    return tree_unflatten(structure, [fn(x) for x in leaves])


def _all_gather(x: torch.Tensor, parts: int, group) -> torch.Tensor:
    """Concatenate the ranks' blocks of ``x`` along dim 0, in rank order
    of ``group``; a bool plane travels as ``uint8``."""
    import torch.distributed as dist
    y = x.contiguous()
    wire = y.view(torch.uint8) if y.dtype == torch.bool else y
    out = [torch.empty_like(wire) for _ in range(parts)]
    dist.all_gather(out, wire, group=group)
    whole = torch.cat(out)
    return whole.view(torch.bool) if y.dtype == torch.bool else whole


class ShardingPlan:
    """One sharding plan: mesh, layout rule, placement and the compile
    seam.

    :param mesh: a :class:`~deap_tpu_torch.parallel.mesh.Mesh`; default a
        1-D mesh over the process group named ``axis``.
    :param axis: the mesh axis the leading data axis shards over —
        ``"pop"`` for population loops, ``"island"`` for stacked demes.
    :param axis2: an optional second data axis (the ``("run",
        "island")`` layout).
    :param donate: kept for the JAX signature; :meth:`place` copies by
        default while it is set.
    :param device: the device of the default mesh (the card unless
        ``device="cpu"``).

    Typical use::

        parallel.initialize()                 # under torchrun
        plan = ShardingPlan.for_population()  # every rank
        pop, logbook, hof = ea_simple(generator, pop, tb, .5, .2, 100,
                                      plan=plan)
    """

    def __init__(self, mesh: Optional[Mesh] = None, *, axis: str = "pop",
                 axis2: Optional[str] = None, donate: bool = True,
                 device: DeviceLike = None):
        if mesh is None:
            mesh = population_mesh(
                axis_names=(axis,) if axis2 is None else (axis, axis2),
                device=device)
        if axis not in mesh.axis_names:
            raise ValueError(f"plan axis {axis!r} not in mesh axes "
                             f"{mesh.axis_names}")
        if axis2 is not None and axis2 not in mesh.axis_names:
            raise ValueError(f"plan axis2 {axis2!r} not in mesh axes "
                             f"{mesh.axis_names}")
        self.mesh = mesh
        self.axis = axis
        self.axis2 = axis2
        self.donate = bool(donate)
        self.mode = sharding_mode()

    # ------------------------------------------------------ constructors ----

    @classmethod
    def for_population(cls, n_devices: Optional[int] = None,
                       device: DeviceLike = None,
                       **kwargs) -> "ShardingPlan":
        """1-D ``("pop",)`` plan over ``n_devices`` ranks (default: the
        process group)."""
        return cls(population_mesh(n_devices, axis_names=("pop",),
                                   device=device), axis="pop", **kwargs)

    @classmethod
    def for_islands(cls, n_devices: Optional[int] = None,
                    device: DeviceLike = None, **kwargs) -> "ShardingPlan":
        """1-D ``("island",)`` plan: stacked demes, a block a rank."""
        return cls(population_mesh(n_devices, axis_names=("island",),
                                   device=device), axis="island", **kwargs)

    @classmethod
    def for_island_runs(cls, n_runs: Optional[int] = None,
                        n_devices: Optional[int] = None,
                        device: DeviceLike = None,
                        **kwargs) -> "ShardingPlan":
        """2-D ``("run", "island")`` plan for the batched island engine:
        ``n_runs`` ranks on the run axis (must divide the device count;
        default all of them), the rest on the island axis."""
        total = _world()[0] if n_devices is None else int(n_devices)
        r = total if n_runs is None else int(n_runs)
        if r < 1 or total % r != 0:
            raise ValueError(f"n_runs={r} must divide the device "
                             f"count {total}")
        mesh = population_mesh(total, axis_names=("run", "island"),
                               shape=(r, total // r), device=device)
        return cls(mesh, axis="run", axis2="island", **kwargs)

    @property
    def n_shards(self) -> int:
        return self.mesh.axis_size(self.axis)

    @property
    def n_shards2(self) -> int:
        return (self.mesh.axis_size(self.axis2)
                if self.axis2 is not None else 1)

    @property
    def device(self) -> torch.device:
        """This rank's device."""
        return self.mesh.device

    @property
    def rank(self) -> int:
        """This process's index in the mesh (0 writes the checkpoints)."""
        return self.mesh.rank

    # ------------------------------------------------------ spec helpers ----

    def spec(self, *axes: Optional[str]) -> Tuple[Optional[str], ...]:
        """A layout over this plan's mesh axes, one entry a dim (the
        ``PartitionSpec`` of the JAX plan, as a tuple)."""
        return tuple(axes)

    @property
    def replicated(self) -> Tuple[Optional[str], ...]:
        return ()

    @property
    def row_sharding(self) -> Tuple[Optional[str], ...]:
        """Leading-axis sharding over the plan axis."""
        return (self.axis,)

    def leaf_sharding(self, leaf: Any) -> Tuple[Optional[str], ...]:
        """The plan's layout for one leaf: the leading axis sharded over
        the plan axis when it divides evenly, replicated otherwise
        (scalars, generators, odd sizes); with ``axis2``, leaves of rank
        2 or more whose second dim divides the second axis shard over
        both. Value-free, as the JAX rule."""
        shape = getattr(leaf, "shape", None)
        if (shape is None or isinstance(leaf, torch.Generator)
                or len(shape) == 0 or shape[0] == 0
                or shape[0] % self.n_shards != 0):
            return self.replicated
        if (self.axis2 is not None and len(shape) >= 2
                and shape[1] > 0 and shape[1] % self.n_shards2 == 0):
            return (self.axis, self.axis2)
        return self.row_sharding

    def tree_shardings(self, tree: Any) -> Any:
        """The layout of every leaf of ``tree``."""
        return tree_map(self.leaf_sharding, tree)

    # ------------------------------------------------------ row blocks ----

    def rows(self, n: int) -> Tuple[int, int]:
        """``(lo, hi)``: the rows of a leading axis of ``n`` this rank
        computes — its block when ``n`` divides the shard count, all of
        them otherwise (a replicated leaf's work runs whole)."""
        w = self.n_shards
        if w == 1 or n == 0 or n % w:
            return 0, n
        size = n // w
        i = self.mesh.axis_index(self.axis)
        return i * size, (i + 1) * size

    def is_split(self, n: int) -> bool:
        """Whether rows of a leading axis of ``n`` split over the ranks."""
        return self.rows(n) != (0, n)

    def shard_rows(self, tree: Any, n: int) -> Any:
        """``tree`` with every tensor leaf of leading size ``n`` cut to
        this rank's rows."""
        lo, hi = self.rows(n)
        if (lo, hi) == (0, n):
            return tree
        return tree_map(
            lambda a: a[lo:hi] if isinstance(a, torch.Tensor)
            and a.dim() > 0 and a.shape[0] == n else a, tree)

    def gather_rows(self, tree: Any, n: int) -> Any:
        """The inverse of :meth:`shard_rows`: every tensor leaf holding
        this rank's rows of a leading axis of ``n`` is all-gathered over
        the plan axis into the whole, identical on every rank."""
        lo, hi = self.rows(n)
        if (lo, hi) == (0, n):
            return tree
        group, parts = self.mesh.group(self.axis), self.n_shards
        with span("plan/gather"):
            return tree_map(
                lambda a: _all_gather(a, parts, group)
                if isinstance(a, torch.Tensor) and a.dim() > 0
                and a.shape[0] == hi - lo else a, tree)

    def map_rows(self, fn: Callable, tree: Any, n: int) -> Any:
        """``fn`` of this rank's rows of ``tree`` (leading size ``n``),
        gathered back: a row-wise function computed a block a rank."""
        return self.gather_rows(fn(self.shard_rows(tree, n)), n)

    # --------------------------------------------------------- placement ----

    def place(self, tree: Any, fresh: Optional[bool] = None) -> Any:
        """Commit ``tree`` to this plan: every tensor leaf on this rank's
        device, whole (the elastic-resume step: a restored state, written
        on any mesh, continues here). ``fresh`` (default: ``donate``)
        returns new tensors, so the caller's survive whatever the loop
        then does."""
        if fresh is None:
            fresh = self.donate
        dev = self.device

        def put(leaf):
            if not isinstance(leaf, torch.Tensor):
                return leaf
            with span("plan/reshard"):
                out = leaf.to(dev)
                return out.clone() if fresh and out is leaf else out

        return tree_map(put, tree)

    # a Population is just a state tree to the plan
    shard_population = place
    place_state = place

    def constrain(self, tree: Any) -> Any:
        """The in-step layout pin of the JAX plan. The port's carry is
        whole on every rank and the per-row work is split by
        :meth:`rows`, so the pin moves nothing: the tree comes back as it
        is."""
        with span("plan/constrain"):
            return tree

    # ------------------------------------------------------------ compile ----

    def compile(self, fn: Callable, *, donate_argnums: Tuple[int, ...] = (),
                static_argnums=(), static_argnames=None,
                label: str = "plan") -> Callable:
        """``fn`` under the program observatory's seam as
        ``plan/<label>``. The loops run eagerly, so nothing is compiled;
        ``donate_argnums`` and the static arguments are accepted for the
        JAX signature (PyTorch has no buffer donation)."""
        from deap_tpu_torch.telemetry import costs
        del donate_argnums, static_argnums, static_argnames
        return costs.instrument(fn, label=f"plan/{label}")

    # --------------------------------------------------------- metadata ----

    def describe(self) -> dict:
        """Mesh metadata stamped into checkpoint ``meta``: a restore
        tells from it when it is an elastic resume onto another mesh."""
        return {"axes": list(self.mesh.axis_names),
                "shape": [int(s) for s in self.mesh.shape],
                "axis": self.axis, "axis2": self.axis2,
                "n_devices": int(self.mesh.size)}

    def __repr__(self) -> str:
        shape = dict(zip(self.mesh.axis_names, self.mesh.shape))
        return (f"ShardingPlan(axis={self.axis!r}, mesh={shape}, "
                f"mode={self.mode!r}, donate={self.donate})")
