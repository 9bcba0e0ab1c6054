"""Wire codec — bit-exact JSON encoding for the service plane.

Port of :mod:`deap_tpu.serving.wire`. The front end
(:mod:`deap_tpu_torch.serving.service`) speaks JSON, and its correctness
bar is **bit identity**: a result fetched over the socket must equal, to
the last mantissa bit, the same job run in-process. JSON floats round-trip
through decimal text, so arrays never travel as number lists — every
array is ``{"__nd__": dtype, shape, base64(raw bytes)}`` (C order, as
stored), a lossless byte-level transport for any dtype.

Two layers:

- the **array layer** (:func:`pack`/:func:`unpack`) — stdlib and numpy
  only, over dicts/lists/tuples/scalars/arrays; all the client needs
  (``serving/client.py`` imports nothing heavier, so a submit box never
  loads torch);
- the **result layer** (:func:`pack_result`) — server-side: flattens a
  result (populations, logbooks, halls of fame, strategy states) with the
  port's own tree functions
  (:func:`deap_tpu_torch.support.checkpoint.tree_flatten`, imported
  lazily), each tensor to its host bytes, and emits ``{"treedef": str,
  "leaves": [...], "digest": sha1}``. The digest covers every leaf's
  dtype, shape and bytes plus the structure string, so "service result
  == in-process result" is one string compare. It is defined over the
  port's tree: a port digest is not a JAX digest.
"""

from __future__ import annotations

import base64
import hashlib
from typing import Any, Dict, List

import numpy as np

__all__ = ["pack", "unpack", "pack_result", "result_digest"]

_ND = "__nd__"
_TUPLE = "__tuple__"


def _pack_array(a: np.ndarray) -> Dict[str, Any]:
    a = np.ascontiguousarray(a)
    return {_ND: a.dtype.str, "shape": list(a.shape),
            "b64": base64.b64encode(a.tobytes()).decode("ascii")}


def _host_array(obj: Any) -> np.ndarray:
    """Anything array-like as a host ndarray (a tensor through its
    ``numpy()`` on the host)."""
    if hasattr(obj, "detach") and hasattr(obj, "cpu"):
        return obj.detach().cpu().numpy()
    return np.asarray(obj)


def pack(obj: Any) -> Any:
    """JSON-encodable transport form of ``obj``: arrays (numpy, numpy
    scalars, tensors) become byte-exact ``__nd__`` blocks, tuples are
    tagged so they survive the round trip, dict/list/str/int/bool/None
    pass through. Python floats pass as JSON numbers — put anything that
    must be bit-exact in an array."""
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if isinstance(obj, (np.ndarray, np.generic)):
        return _pack_array(np.asarray(obj))
    if isinstance(obj, dict):
        return {str(k): pack(v) for k, v in obj.items()}
    if isinstance(obj, tuple):
        return {_TUPLE: [pack(v) for v in obj]}
    if isinstance(obj, list):
        return [pack(v) for v in obj]
    return _pack_array(_host_array(obj))


def unpack(obj: Any) -> Any:
    """Inverse of :func:`pack` (numpy arrays out)."""
    if isinstance(obj, dict):
        if _ND in obj:
            raw = base64.b64decode(obj["b64"])
            return np.frombuffer(raw, dtype=np.dtype(obj[_ND])) \
                .reshape(obj["shape"]).copy()
        if _TUPLE in obj:
            return tuple(unpack(v) for v in obj[_TUPLE])
        return {k: unpack(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [unpack(v) for v in obj]
    return obj


def _leaf_array(leaf: Any) -> np.ndarray:
    """A leaf as a host ndarray; a generator travels as its state bytes
    (the checkpoint format's canonical form)."""
    if hasattr(leaf, "get_state") and hasattr(leaf, "manual_seed"):
        leaf = leaf.get_state()
    return _host_array(leaf)


def _canonicalize(result: Any) -> Any:
    """Replace what the tree functions would keep as opaque leaves with
    plain structure, so every leaf is an array: a
    :class:`~deap_tpu_torch.support.logbook.Logbook` becomes a COLUMNAR
    dict (one stacked array a field over the generation axis; a ragged
    logbook falls back to a tuple of per-row dicts), ``None`` an empty
    tuple."""
    from deap_tpu_torch.support.logbook import Logbook
    from deap_tpu_torch.support.checkpoint import tree_flatten, \
        tree_unflatten

    def fix_logbook(lb: Logbook) -> Any:
        rows = [{str(k): row[k] for k in sorted(row)} for row in lb]
        if rows:
            keys = list(rows[0])
            try:
                if all(list(r) == keys for r in rows):
                    return {"gens": len(rows),
                            "cols": {k: np.stack([_host_array(r[k])
                                                  for r in rows])
                                     for k in keys}}
            except (ValueError, TypeError):
                pass  # heterogeneous shapes: keep the row form
        return tuple(fix(r) for r in rows)

    def fix(x: Any) -> Any:
        if isinstance(x, Logbook):
            return fix_logbook(x)
        if x is None:
            return ()
        leaves, structure = tree_flatten(x)
        if structure is None:  # a leaf
            return x
        return tree_unflatten(structure, [fix(v) for v in leaves])

    return fix(result)


def pack_result(result: Any) -> Dict[str, Any]:
    """Server-side encoding of one tenant's solo-format result (or any
    tree): ``{"treedef", "leaves", "digest"}``. Decode the leaves with
    :func:`unpack`; compare results across transports with the digest."""
    from deap_tpu_torch.support.checkpoint import tree_flatten

    leaves, structure = tree_flatten(_canonicalize(result))
    arrays = [_leaf_array(leaf) for leaf in leaves]
    packed: List[Any] = [_pack_array(a) for a in arrays]
    treedef = repr(structure)
    return {"treedef": treedef, "leaves": packed,
            "digest": _digest(treedef, arrays)}


def _digest(treedef: str, arrays: List[np.ndarray]) -> str:
    h = hashlib.sha1(treedef.encode())
    for a in arrays:
        h.update(str(a.dtype.str).encode())
        h.update(str(a.shape).encode())
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def result_digest(result: Any) -> str:
    """The bit-identity fingerprint of a result tree — equal digests mean
    equal structure, dtypes, shapes and bytes."""
    return pack_result(result)["digest"]
