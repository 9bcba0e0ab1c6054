"""Host-side tree display and parsing.

Port of :mod:`deap_tpu.gp.string`: ``to_string`` renders one prefix
tree as an expression, ``to_graph`` gives its nodes, edges and labels for
graph libraries, ``from_string`` parses ``name(arg, ...)`` prefix syntax
into a one-tree population. All walk host arrays.
"""

from __future__ import annotations

import re
from typing import Tuple

import numpy as np
import torch

from deap_tpu_torch.device import DeviceLike, resolve_device
from deap_tpu_torch.gp.pset import PrimitiveSet


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def to_string(genome, pset: PrimitiveSet) -> str:
    """Render one prefix tree (``nodes [L]``, ``consts [L]``, ``length``)
    as a readable expression."""
    nodes = _host(genome["nodes"]).reshape(-1)
    consts = _host(genome["consts"]).reshape(-1)
    length = int(_host(genome["length"]).reshape(-1)[0])

    def render(i: int) -> Tuple[str, int]:
        node = int(nodes[i])
        if node < pset.n_ops:
            prim = pset.primitives[node]
            args, j = [], i + 1
            for _ in range(prim.arity):
                s, j = render(j)
                args.append(s)
            return prim.format(*args), j
        return pset.node_name(node, consts[i]), i + 1

    if length == 0:
        return ""
    s, end = render(0)
    if end != length:
        raise ValueError(f"malformed prefix tree: used {end} of {length}")
    return s


def to_graph(genome, pset: PrimitiveSet):
    """``(nodes, edges, labels)`` of one prefix tree, for graph libraries
    (the reference's ``gp.graph``): node ids are prefix positions,
    ``edges`` the (parent, child) pairs, ``labels`` id → primitive or
    terminal name. Feed to ``networkx.Graph`` or pygraphviz as the
    reference documents."""
    nodes_arr = _host(genome["nodes"]).reshape(-1)
    consts = _host(genome["consts"]).reshape(-1)
    length = int(_host(genome["length"]).reshape(-1)[0])
    arity = pset.arity_list()
    labels = {i: pset.node_name(int(nodes_arr[i]), consts[i])
              for i in range(length)}
    edges = []
    # a stack of [parent, children still to come] along the prefix walk
    stack: list = []
    for i in range(length):
        if stack:
            edges.append((stack[-1][0], i))
            stack[-1][1] -= 1
            if stack[-1][1] == 0:
                stack.pop()
        a = arity[int(nodes_arr[i])]
        if a > 0:
            stack.append([i, a])
    return list(range(length)), edges, labels


def from_string(expr: str, pset: PrimitiveSet, max_len: int,
                device: DeviceLike = None):
    """Parse ``name(arg, ...)`` prefix syntax into a population of one
    tree (``nodes [1, max_len]``, ``consts [1, max_len]``, ``length
    [1]``). Tokens must name primitives, arguments or fixed terminals, or
    be numeric literals (stored as constants)."""
    dev = resolve_device(device)
    tokens = [t for t in re.split(r"[ \t\n\r\f\v(),]+", expr) if t]
    prim_by_name = {p.name: i for i, p in enumerate(pset.primitives)}
    arg_by_name = {n: pset.n_ops + i for i, n in enumerate(pset.arg_names)}
    const_by_name = {n: pset.const_id + i
                     for i, n in enumerate(pset.const_names)}

    nodes = np.full(max_len, pset.const_id, np.int32)
    consts = np.zeros(max_len, np.float32)
    if len(tokens) > max_len:
        raise ValueError(f"expression longer than max_len={max_len}")
    for t, tok in enumerate(tokens):
        if tok in prim_by_name:
            nodes[t] = prim_by_name[tok]
        elif tok in arg_by_name:
            nodes[t] = arg_by_name[tok]
        elif tok in const_by_name:
            nodes[t] = const_by_name[tok]
            consts[t] = pset.const_values[const_by_name[tok] - pset.const_id]
        else:
            try:
                value = float(tok)
            except ValueError:
                raise TypeError(
                    f"unknown symbol {tok!r} in expression") from None
            if pset.has_erc:
                nodes[t] = pset.erc_id
            else:
                # no ERC pool: a literal is representable only as the
                # value of a fixed terminal
                matches = [i for i, v in enumerate(pset.const_values)
                           if v == value]
                if not matches:
                    raise ValueError(
                        f"literal {tok!r} is not a fixed terminal of "
                        f"{pset.name!r} and the set has no ephemeral "
                        f"constant to hold it")
                nodes[t] = pset.const_id + matches[0]
            consts[t] = value
    return {"nodes": torch.from_numpy(nodes[None]).to(dev),
            "consts": torch.from_numpy(consts[None]).to(dev),
            "length": torch.tensor([len(tokens)], dtype=torch.int32,
                                   device=dev)}
