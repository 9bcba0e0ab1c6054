"""Geometric semantic GP operators.

Port of :mod:`deap_tpu.gp.semantic`, batched over trees. Offspring are
built syntactically as arithmetic combinations of the parents and fresh
random trees:

- mutation:  child = parent + ms · (lf(tr1) − lf(tr2))
- crossover: child1 = ind1·lf(tr) + (1 − lf(tr))·ind2 (and symmetrically)

with ``lf`` the logistic. The set must hold ``add``/``sub``/``mul``/
``lf`` (:func:`add_semantic_primitives`); with their device ops the
offspring evaluate through K9. On fixed-width prefix arrays the
construction is a segment concatenation; a tree whose composed program
would exceed ``max_len`` keeps its parent (widened to ``max_len``).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import torch

from deap_tpu_torch.gp.pset import PrimitiveSet
from deap_tpu_torch.gp.tree import Genome, tree_where
from deap_tpu_torch.ops.kernels import gp_logistic

#: the logistic, ``1 / (1 + e^{-x})``, rounded as K9's ``lf`` code
logistic = gp_logistic


def add_semantic_primitives(pset: PrimitiveSet) -> PrimitiveSet:
    """Ensure the add/sub/mul/lf vocabulary the semantic operators need,
    appending the missing ones (``lf`` with device op ``'lf'``), plus a
    fixed terminal 1.0 for the injected ``ms`` and 1.0 constants when the
    set has no fixed terminal.

    Call this BEFORE generating any genomes: appending primitives or
    terminals renumbers node ids."""
    names = {p.name for p in pset.primitives}
    if "add" not in names:
        pset.add_primitive(torch.add, 2, "add", "({0} + {1})", "add")
    if "sub" not in names:
        pset.add_primitive(torch.sub, 2, "sub", "({0} - {1})", "sub")
    if "mul" not in names:
        pset.add_primitive(torch.mul, 2, "mul", "({0} * {1})", "mul")
    if "lf" not in names:
        pset.add_primitive(logistic, 1, "lf", device_op="lf")
    if pset.n_consts == 0:
        # a literal slot of its own, not the ERC id, so that ephemeral
        # resampling never rewrites the injected constants
        pset.add_terminal(1.0, "1.0")
    return pset


def _prim_id(pset: PrimitiveSet, name: str) -> int:
    for i, p in enumerate(pset.primitives):
        if p.name == name:
            return i
    raise ValueError(
        f"a {name!r} function is required in order to perform semantic "
        "variation; call add_semantic_primitives(pset)")


def _literal_id(pset: PrimitiveSet) -> int:
    """The first fixed terminal's id, which hosts the inline literals
    (their values live in ``consts``)."""
    if pset.n_consts == 0:
        raise ValueError(
            "semantic operators need a fixed terminal to host literal "
            "constants; call add_semantic_primitives(pset) before "
            "generating genomes")
    return pset.const_id


def _concat(max_len: int, parts: List[Tuple]) -> Genome:
    """Concatenate ``(nodes [n, w], consts [n, w], length [n])`` segments,
    tree by tree, into prefix arrays of width ``max_len`` (0 past the
    total). ``length`` is the total, which may exceed ``max_len``."""
    n = parts[0][2].shape[0]
    dev = parts[0][2].device
    k = torch.arange(max_len, device=dev)
    nodes = torch.zeros((n, max_len), dtype=torch.int32, device=dev)
    consts = torch.zeros((n, max_len), dtype=torch.float32, device=dev)
    off = torch.zeros(n, dtype=torch.int64, device=dev)
    for n_src, c_src, ln in parts:
        src = (k - off[:, None]).clamp(0, n_src.shape[1] - 1)
        in_seg = (k >= off[:, None]) & (k < (off + ln)[:, None])
        nodes = torch.where(in_seg, n_src.gather(1, src), nodes)
        consts = torch.where(in_seg, c_src.gather(1, src), consts)
        off = off + ln
    return {"nodes": nodes, "consts": consts, "length": off}


def _scalar(n: int, device, node_id: int, value=0.0):
    """A one-node segment for every tree; ``value`` a float or ``f32[n]``."""
    vals = (value.to(torch.float32).reshape(n, 1)
            if isinstance(value, torch.Tensor) else
            torch.full((n, 1), value, dtype=torch.float32, device=device))
    return (torch.full((n, 1), node_id, dtype=torch.int32, device=device),
            vals, torch.ones(n, dtype=torch.int64, device=device))


def _seg(g: Genome):
    return g["nodes"], g["consts"], g["length"].to(torch.int64)


def _pad_to(g: Genome, max_len: int) -> Genome:
    """Widen a population's arrays to ``max_len`` slots (zeros)."""
    width = g["nodes"].shape[1]
    if width > max_len:
        raise ValueError(
            f"parent width {width} exceeds operator max_len {max_len}")
    pad = max_len - width
    return {"nodes": torch.nn.functional.pad(g["nodes"], (0, pad)),
            "consts": torch.nn.functional.pad(g["consts"], (0, pad)),
            "length": g["length"]}


def _keep_if_fits(new: Genome, old: Genome, max_len: int) -> Genome:
    new = dict(new, length=new["length"].to(torch.int32))
    return tree_where(new["length"] <= max_len, new, _pad_to(old, max_len))


def mut_semantic_core(pset: PrimitiveSet, max_len: int, g: Genome,
                      tr1: Genome, tr2: Genome, ms: torch.Tensor) -> Genome:
    """Semantic mutation on its draws: ``add(g, mul(ms, sub(lf(tr1),
    lf(tr2))))`` with the trees ``tr1``, ``tr2`` and steps ``ms f32[n]``
    given."""
    add_i, sub_i, mul_i, lf_i = (_prim_id(pset, s)
                                 for s in ("add", "sub", "mul", "lf"))
    lit = _literal_id(pset)
    n, dev = g["length"].shape[0], g["nodes"].device
    one = lambda node, value=0.0: _scalar(n, dev, node, value)
    new = _concat(max_len, [
        one(add_i), _seg(g), one(mul_i), one(lit, ms), one(sub_i),
        one(lf_i), _seg(tr1), one(lf_i), _seg(tr2)])
    return _keep_if_fits(new, g, max_len)


def make_mut_semantic(pset: PrimitiveSet, expr: Callable, max_len: int,
                      ms: Optional[float] = None) -> Callable:
    """Semantic mutation (mutSemantic), ``mut(generator, g)``: ``child =
    add(parent, mul(ms, sub(lf(tr1), lf(tr2))))`` with ``tr1``, ``tr2``
    fresh trees from ``expr(generator, n)`` and ``ms`` the mutation step,
    uniform in (0, 2) a tree when not fixed."""
    for name in ("add", "sub", "mul", "lf"):
        _prim_id(pset, name)
    _literal_id(pset)

    def mut(generator: torch.Generator, g: Genome) -> Genome:
        n, dev = g["length"].shape[0], generator.device
        tr1 = expr(generator, n)
        tr2 = expr(generator, n)
        ms_v = (torch.rand(n, generator=generator, device=dev) * 2.0
                if ms is None else torch.full((n,), float(ms), device=dev))
        return mut_semantic_core(pset, max_len, g, tr1, tr2, ms_v)

    return mut


def cx_semantic_core(pset: PrimitiveSet, max_len: int, g1: Genome,
                     g2: Genome, tr: Genome) -> Tuple[Genome, Genome]:
    """Semantic crossover on its draw, the one random tree ``tr`` a pair:
    ``add(mul(a, lf(tr)), mul(sub(1, lf(tr)), b))`` for (a, b) = (g1,
    g2) and (g2, g1)."""
    add_i, sub_i, mul_i, lf_i = (_prim_id(pset, s)
                                 for s in ("add", "sub", "mul", "lf"))
    lit = _literal_id(pset)
    n, dev = g1["length"].shape[0], g1["nodes"].device
    one = lambda node, value=0.0: _scalar(n, dev, node, value)

    def child(a: Genome, b: Genome) -> Genome:
        return _concat(max_len, [
            one(add_i), one(mul_i), _seg(a), one(lf_i), _seg(tr),
            one(mul_i), one(sub_i), one(lit, 1.0), one(lf_i), _seg(tr),
            _seg(b)])

    return (_keep_if_fits(child(g1, g2), g1, max_len),
            _keep_if_fits(child(g2, g1), g2, max_len))


def make_cx_semantic(pset: PrimitiveSet, expr: Callable,
                     max_len: int) -> Callable:
    """Semantic crossover (cxSemantic), ``cx(generator, g1, g2)``: one
    shared random tree ``tr`` a pair from ``expr(generator, n)``."""
    for name in ("add", "sub", "mul", "lf"):
        _prim_id(pset, name)
    _literal_id(pset)

    def cx(generator: torch.Generator, g1: Genome, g2: Genome):
        return cx_semantic_core(pset, max_len, g1, g2,
                                expr(generator, g1["length"].shape[0]))

    return cx
