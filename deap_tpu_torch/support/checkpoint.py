"""Checkpoint / resume of full evolution state.

Port of :mod:`deap_tpu.support.checkpoint`. A checkpoint is one
crash-consistent file: the state is flattened down to each tensor
(dicts, lists, tuples, namedtuples and dataclasses such as
:class:`~deap_tpu_torch.core.population.Population`, the hall of fame
and the strategies' states are structure; everything else is a leaf),
every leaf is pickled to its own blob with a CRC32, the structure to a
CRC'd blob of its own, and the container carries a format version and a
``meta`` dict. The file is written to a temporary name, fsync'd, renamed
over the final name, and the directory fsync'd, so a power cut or a
SIGKILL never leaves a torn file under the final name.

Leaves:

- a tensor becomes host bytes plus its dtype's name and shape, so every
  dtype round-trips bit for bit (``bfloat16`` included, which numpy
  lacks) and no device tensor is ever pickled; on restore it goes to the
  run's device (the card unless the caller passes ``device="cpu"``);
- a ``torch.Generator`` becomes its ``get_state()`` bytes plus its device
  type, and restores as a generator on the run's device carrying that
  state (a CUDA generator's state is a seed and a Philox offset);
- any other value is pickled as it is, and a tensor hidden inside one
  raises.

The structure names each container's class as ``module:qualname``
strings, so reading it imports nothing; a file that the JAX package
wrote (its structure is a pickled jax object) is refused with
:class:`CheckpointFormatError` without importing jax. Files stamped by
another version of the port, or with a newer format, are refused by name
too (the compat gate opens the first). Per-shard (format 3) leaves are
ROADMAP A12.

:class:`Checkpointer` keeps a step-indexed directory: ``restore_latest``
falls back past corrupt files to the newest valid one (each journaled),
rotation never deletes the last verified-good file, and an ownership
stamp (``tenant_id``) filters the walk. :class:`AsyncCheckpointWriter`
double-buffers: the snapshot is an ordered copy taken when the write is
submitted (see its docstring), the pickle and fsync run on a thread.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import io
import os
import pickle
import re
import shutil
import threading
import time
import zlib
from typing import Any, Dict, List, Optional, Tuple

import torch

from deap_tpu_torch.device import DeviceLike, resolve_device
from deap_tpu_torch.telemetry.journal import broadcast

__all__ = ["AsyncCheckpointWriter", "CheckpointCorruptError",
           "CheckpointFormatError", "Checkpointer", "allow_compat_restore",
           "checkpoint_meta", "restore_seconds_total", "restore_state",
           "save_state", "set_compat_restore", "verify_checkpoint",
           "FORMAT_VERSION"]

#: cumulative wall seconds this process has spent restoring checkpoints
_RESTORE_SECONDS = [0.0]

_TENSOR = "__tensor__"
_GENERATOR = "__generator__"

#: the container layout :func:`save_state` writes: per-leaf blobs and
#: CRC32s, a CRC'd structure blob, ``meta``. Format 3 (per-shard leaves)
#: is ROADMAP A12.
FORMAT_VERSION = 2

#: module roots whose objects only the JAX package can rebuild
_JAX_ROOTS = ("jax", "jaxlib", "flax", "deap_tpu")


def restore_seconds_total() -> float:
    """Cumulative wall-clock seconds this process has spent inside
    :func:`restore_state` / :meth:`Checkpointer.restore_latest` (payload
    verification and materialisation)."""
    return _RESTORE_SECONDS[0]


class CheckpointCorruptError(RuntimeError):
    """A checkpoint file exists but cannot be trusted: unreadable
    pickle, CRC mismatch, or a payload that is not a checkpoint."""

    def __init__(self, path: str, detail: str):
        super().__init__(f"corrupt checkpoint {path}: {detail}")
        self.path = path
        self.detail = detail


class CheckpointFormatError(CheckpointCorruptError):
    """The checkpoint's bytes are intact but this code must not restore
    them: the file carries a newer format than this build understands,
    was written by another version of the port while the compat gate
    (:func:`allow_compat_restore`) is closed, or was written by the JAX
    package."""


#: process-wide compat gate: closed (default) → restoring a file stamped
#: by another ``deap_tpu_torch`` version raises CheckpointFormatError;
#: open → the restore proceeds and journals a ``compat_restore`` row
_COMPAT_ALLOW = [False]


def _code_version() -> str:
    """The running code's version stamp (``deap_tpu_torch.__version__``,
    overridable through ``DEAP_TPU_TORCH_VERSION_OVERRIDE`` to run two
    "versions" from one checkout)."""
    env = os.environ.get("DEAP_TPU_TORCH_VERSION_OVERRIDE")
    if env:
        return env
    from deap_tpu_torch import __version__
    return __version__


def set_compat_restore(allow: bool) -> bool:
    """Open/close the process-wide compat gate; returns the previous
    state."""
    prev = _COMPAT_ALLOW[0]
    _COMPAT_ALLOW[0] = bool(allow)
    return prev


@contextlib.contextmanager
def allow_compat_restore():
    """Scoped form of :func:`set_compat_restore`: restores made inside
    the ``with`` block may cross port versions (each journals
    ``compat_restore``); the gate snaps back on exit."""
    prev = set_compat_restore(True)
    try:
        yield
    finally:
        set_compat_restore(prev)


# ---------------------------------------------------------- structure ----

def _type_name(cls) -> str:
    return f"{cls.__module__}:{cls.__qualname__}"


def _is_jax_module(module: str) -> bool:
    return module.split(".")[0] in _JAX_ROOTS


def _resolve_type(name: str, path: str):
    module, qualname = name.split(":", 1)
    if _is_jax_module(module):
        raise CheckpointFormatError(
            path, f"holds a {name} of the JAX package; the port restores "
                  "only files that deap_tpu_torch wrote")
    obj = importlib.import_module(module)
    for part in qualname.split("."):
        obj = getattr(obj, part)
    return obj


def tree_flatten(tree: Any) -> Tuple[List[Any], Any]:
    """``(leaves, structure)``: dicts, lists, tuples, namedtuples and
    dataclass instances are structure, anything else a leaf. The
    structure holds only plain values and class names."""
    leaves: List[Any] = []

    def walk(x):
        if type(x) is dict:
            keys = list(x)
            return ("dict", keys, [walk(x[k]) for k in keys])
        if type(x) is list:
            return ("list", [walk(v) for v in x])
        if type(x) is tuple:
            return ("tuple", [walk(v) for v in x])
        if isinstance(x, tuple) and hasattr(type(x), "_fields"):
            return ("namedtuple", _type_name(type(x)), [walk(v) for v in x])
        if dataclasses.is_dataclass(x) and not isinstance(x, type):
            names = [f.name for f in dataclasses.fields(x)]
            return ("dataclass", _type_name(type(x)), names,
                    [walk(getattr(x, n)) for n in names])
        leaves.append(x)
        return None

    return leaves, walk(tree)


def tree_unflatten(structure: Any, leaves: List[Any],
                   path: str = "<state>") -> Any:
    """The inverse of :func:`tree_flatten`. A dataclass is rebuilt
    without calling its ``__init__``, field by field."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return next(it)
        kind = node[0]
        if kind == "dict":
            return {k: build(c) for k, c in zip(node[1], node[2])}
        if kind == "list":
            return [build(c) for c in node[1]]
        if kind == "tuple":
            return tuple(build(c) for c in node[1])
        if kind == "namedtuple":
            return _resolve_type(node[1], path)(*[build(c) for c in node[2]])
        if kind == "dataclass":
            cls = _resolve_type(node[1], path)
            obj = cls.__new__(cls)
            for name, child in zip(node[2], node[3]):
                object.__setattr__(obj, name, build(child))
            return obj
        raise CheckpointCorruptError(path, f"unknown structure node {kind!r}")

    return build(structure)


# -------------------------------------------------------------- leaves ----

class _GuardPickler(pickle.Pickler):
    """Refuses a tensor, storage or generator hidden inside an opaque
    leaf: those are leaves of their own, never pickled."""

    def persistent_id(self, obj):
        if isinstance(obj, (torch.Tensor, torch.Generator,
                            torch.UntypedStorage, torch.TypedStorage)):
            raise TypeError(
                f"a {type(obj).__name__} inside an opaque checkpoint leaf; "
                "put it in a dict, list, tuple or dataclass instead")
        return None


def _dumps(obj: Any) -> bytes:
    buf = io.BytesIO()
    _GuardPickler(buf, protocol=pickle.HIGHEST_PROTOCOL).dump(obj)
    return buf.getvalue()


class _Unpickler(pickle.Unpickler):
    """Refuses, by name, every object of the JAX package (a JAX file's
    structure, or the leaves of its first format), without importing
    jax."""

    def __init__(self, f, path: str):
        super().__init__(f)
        self.path = path

    def find_class(self, module, name):
        if _is_jax_module(module):
            raise CheckpointFormatError(
                self.path, f"written by the JAX package (it holds "
                           f"{module}.{name}); the port restores only "
                           "files that deap_tpu_torch wrote")
        return super().find_class(module, name)


def _loads(blob: bytes, path: str) -> Any:
    return _Unpickler(io.BytesIO(blob), path).load()


def _raw_bytes(host: torch.Tensor) -> bytes:
    flat = host.resolve_conj().resolve_neg().contiguous().reshape(-1)
    return flat.view(torch.uint8).numpy().tobytes()


def _memory_order(t: torch.Tensor) -> Optional[List[int]]:
    """The dims of a dense tensor that is not row-major (a transpose,
    ``torch.linalg.eigh``'s column-major vectors), outermost in memory
    first; ``None`` for a row-major tensor or a view that is not dense,
    which are stored row-major. A restored tensor gets its strides back,
    so a product over it takes the same path and rounds the same."""
    if t.dim() < 2 or t.is_contiguous():
        return None
    order = sorted(range(t.dim()), key=lambda d: -t.stride(d))
    return order if t.permute(order).is_contiguous() else None


def _tensor_blob(host: torch.Tensor) -> Dict[str, Any]:
    order = _memory_order(host)
    return {_TENSOR: str(host.dtype).replace("torch.", ""),
            "shape": tuple(host.shape), "order": order,
            "data": _raw_bytes(host if order is None
                               else host.permute(order))}


def _pack_leaf(leaf: Any) -> Any:
    if isinstance(leaf, torch.Tensor):
        if leaf.layout != torch.strided:
            raise TypeError(f"a {leaf.layout} tensor cannot be checkpointed")
        return _tensor_blob(leaf.detach().cpu())
    if isinstance(leaf, torch.Generator):
        return {_GENERATOR: leaf.device.type,
                "state": leaf.get_state().numpy().tobytes()}
    return leaf


def _unpack_leaf(leaf: Any, device: torch.device, path: str) -> Any:
    if isinstance(leaf, dict) and _TENSOR in leaf:
        dtype = getattr(torch, leaf[_TENSOR], None)
        if not isinstance(dtype, torch.dtype):
            raise CheckpointCorruptError(
                path, f"unknown dtype {leaf[_TENSOR]!r}")
        shape = tuple(leaf["shape"])
        data = leaf["data"]
        numel = 1
        for s in shape:
            numel *= s
        if len(data) != numel * dtype.itemsize:
            raise CheckpointCorruptError(
                path, f"a {dtype} leaf of shape {shape} has {len(data)} bytes")
        if not data:
            return torch.empty(shape, dtype=dtype, device=device)
        host = torch.frombuffer(bytearray(data), dtype=torch.uint8)
        order = leaf.get("order")
        if order is None:
            return host.view(dtype).reshape(shape).to(device)
        inverse = sorted(range(len(order)), key=order.__getitem__)
        host = host.view(dtype).reshape([shape[d] for d in order])
        return host.permute(inverse).to(device)
    if isinstance(leaf, dict) and _GENERATOR in leaf:
        kind = leaf[_GENERATOR]
        if kind == device.type:
            where = device
        elif kind == "cpu":
            where = torch.device("cpu")
        else:
            raise CheckpointFormatError(
                path, f"holds a {kind} generator, which cannot be restored "
                      f"onto {device}")
        g = torch.Generator(device=where)
        g.set_state(torch.frombuffer(bytearray(leaf["state"]),
                                     dtype=torch.uint8))
        return g
    return leaf


# ---------------------------------------------------------------- save ----

def _fsync_dir(path: str) -> None:
    """fsync the directory entry so the rename itself is durable.
    Best-effort: not every filesystem hands out directory fds."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    try:
        fd = os.open(d, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


class _Snapshot:
    """A state flattened and copied now, written later.

    Structure and every non-tensor leaf are pickled at once. A CPU
    tensor's bytes are copied at once. A CUDA tensor is copied into a
    pinned host buffer by a non-blocking copy queued on the current
    stream, behind the work that produced it and ahead of any later
    kernel that writes into it; an event recorded after the copies is
    what :meth:`blobs` waits for before it reads the buffers."""

    def __init__(self, state: Any):
        leaves, self.structure = tree_flatten(state)
        self._leaves: List[Any] = []
        self._event = None
        for leaf in leaves:
            if isinstance(leaf, torch.Tensor) and leaf.device.type == "cuda":
                host = torch.empty_like(leaf, device="cpu", pin_memory=True)
                host.copy_(leaf.detach(), non_blocking=True)
                self._leaves.append(host)
            else:
                self._leaves.append(_dumps(_pack_leaf(leaf)))
        if any(isinstance(x, torch.Tensor) for x in self._leaves):
            self._event = torch.cuda.Event()
            self._event.record()

    def blobs(self) -> List[bytes]:
        if self._event is not None:
            self._event.synchronize()
        return [_dumps(_tensor_blob(x)) if isinstance(x, torch.Tensor)
                else x for x in self._leaves]


def save_state(path: str, state: Any, meta: Optional[Dict[str, Any]] = None,
               fsync: bool = True) -> int:
    """Serialize a state tree to ``path``.

    Crash-consistent: the payload (per-leaf blobs + CRC32s + format
    version + optional ``meta`` dict) is written to a temp file, fsync'd,
    renamed over ``path``, and the directory entry fsync'd. ``meta``
    round-trips through :func:`checkpoint_meta` without restoring the
    state. ``fsync=False`` keeps the atomic rename but skips both
    fsyncs (a host power cut may then lose the newest file; a killed
    process does not).

    Returns the CRC32 of the exact container bytes written, which a
    read-back compares against."""
    if isinstance(state, _Snapshot):
        structure, blobs = state.structure, state.blobs()
    else:
        leaves, structure = tree_flatten(state)
        blobs = [_dumps(_pack_leaf(leaf)) for leaf in leaves]
    structure_blob = _dumps(structure)
    stamped = dict(meta or {})
    stamped.setdefault("deap_tpu_torch_version", _code_version())
    stamped.setdefault("checkpoint_format", FORMAT_VERSION)
    payload = {
        "format_version": FORMAT_VERSION,
        "structure": structure_blob,
        "structure_crc": zlib.crc32(structure_blob),
        "leaves": blobs,
        "crcs": [zlib.crc32(b) for b in blobs],
        "meta": stamped,
    }
    buf = pickle.dumps(payload, protocol=pickle.HIGHEST_PROTOCOL)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(buf)
        f.flush()
        if fsync:
            os.fsync(f.fileno())
    os.replace(tmp, path)
    if fsync:
        _fsync_dir(path)
    ids = {k: stamped[k] for k in ("tenant_id", "request_id")
           if stamped.get(k)}
    broadcast("checkpoint", path=path, bytes=len(buf), **ids)
    return zlib.crc32(buf)


# ------------------------------------------------------------- restore ----

def _load_payload(path: str) -> Any:
    try:
        with open(path, "rb") as f:
            return _Unpickler(f, path).load()
    except (FileNotFoundError, CheckpointCorruptError):
        raise
    except Exception as e:  # torn/garbage pickle, EOF, bad opcode ...
        raise CheckpointCorruptError(path, f"unreadable payload ({e!r})")


def _verify_payload(path: str, payload: Any) -> None:
    """Refuse foreign and future files by name, then CRC-check; raise on
    the first mismatch (the lowest-index bad leaf)."""
    if not isinstance(payload, dict):
        raise CheckpointCorruptError(path, "payload is not a dict")
    if "treedef" in payload and "structure" not in payload:
        meta = payload.get("meta")
        by = meta.get("deap_tpu_version") if isinstance(meta, dict) else None
        raise CheckpointFormatError(
            path, f"written by the JAX package (deap_tpu {by}, format "
                  f"{payload.get('format_version')}): its structure is a "
                  "pickled jax object; the port restores only files that "
                  "deap_tpu_torch wrote")
    version = payload.get("format_version")
    if version is None:
        raise CheckpointCorruptError(path, "not a checkpoint payload")
    if int(version) > FORMAT_VERSION:
        raise CheckpointFormatError(
            path, f"format_version {version} is newer than this build's "
                  f"{FORMAT_VERSION}; upgrade deap_tpu_torch to restore it")
    for k in ("structure", "structure_crc", "leaves", "crcs"):
        if k not in payload:
            raise CheckpointCorruptError(path, f"missing field {k!r}")
    if zlib.crc32(payload["structure"]) != payload["structure_crc"]:
        raise CheckpointCorruptError(path, "structure CRC mismatch")
    if len(payload["leaves"]) != len(payload["crcs"]):
        raise CheckpointCorruptError(path, "leaf/CRC count mismatch")
    for i, (blob, want) in enumerate(zip(payload["leaves"],
                                         payload["crcs"])):
        if zlib.crc32(blob) != want:
            raise CheckpointCorruptError(path, f"leaf {i} CRC mismatch")


def _meta_of(payload: Any) -> Dict[str, Any]:
    meta = payload.get("meta", {}) if isinstance(payload, dict) else {}
    return meta if isinstance(meta, dict) else {}


def verify_checkpoint(path: str) -> Dict[str, Any]:
    """Validate ``path`` without restoring the state: the container and
    every CRC. Returns the ``meta`` dict. Raises
    :class:`CheckpointCorruptError` (or ``FileNotFoundError``)."""
    payload = _load_payload(path)
    _verify_payload(path, payload)
    return _meta_of(payload)


def checkpoint_meta(path: str,
                    tenant_id: Optional[str] = None) -> Dict[str, Any]:
    """The ``meta`` dict stored by :func:`save_state`, CRCs verified on
    the way. ``tenant_id`` asserts ownership: a mismatch (including a
    file with no tenant stamp) raises ``ValueError``."""
    meta = verify_checkpoint(path)
    if tenant_id is not None and meta.get("tenant_id") != tenant_id:
        raise ValueError(
            f"checkpoint {path} belongs to tenant "
            f"{meta.get('tenant_id')!r}, not {tenant_id!r}")
    return meta


def _materialize(path: str, payload: Any, device: torch.device) -> Any:
    """Decode a verified payload into the state tree, leaves onto
    ``device``. The version gate lives here, the one place both
    :func:`restore_state` and :meth:`Checkpointer.restore_latest` pass;
    :func:`verify_checkpoint` and :func:`checkpoint_meta` stay exempt,
    so a foreign file's meta can always be read."""
    meta = _meta_of(payload)
    written_by = meta.get("deap_tpu_torch_version")
    if written_by and written_by != _code_version():
        if not _COMPAT_ALLOW[0]:
            raise CheckpointFormatError(
                path, f"written by deap_tpu_torch {written_by}, running "
                      f"{_code_version()}; cross-version restore needs the "
                      "explicit compat gate (allow_compat_restore() / "
                      "set_compat_restore(True))")
        broadcast("compat_restore", path=path, written_by=str(written_by),
                  running=_code_version(),
                  **{k: meta[k] for k in ("tenant_id", "request_id")
                     if meta.get(k)})

    try:
        structure = _loads(payload["structure"], path)
        leaves = [_unpack_leaf(_loads(blob, path), device, path)
                  for blob in payload["leaves"]]
        return tree_unflatten(structure, leaves, path)
    except CheckpointCorruptError:
        raise
    except Exception as e:  # CRC passed but decoding failed anyway
        raise CheckpointCorruptError(path, f"undecodable leaf ({e!r})")


def restore_state(path: str, device: DeviceLike = None) -> Any:
    """Load a state tree written by :func:`save_state`, its tensors and
    generators onto ``device`` (the card unless ``device="cpu"``).

    Verifies the format and every CRC first; raises
    :class:`CheckpointCorruptError` naming the failure rather than
    returning silently-wrong state."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    try:
        payload = _load_payload(path)
        _verify_payload(path, payload)
        return _materialize(path, payload, dev)
    finally:
        _RESTORE_SECONDS[0] += time.perf_counter() - t0


# -------------------------------------------------------- Checkpointer ----

class Checkpointer:
    """Step-indexed checkpoint directory with corruption-safe rotation::

        ckpt = Checkpointer(dir, keep=3)
        if ckpt.latest_step() is not None:
            state = ckpt.restore()          # generator state included
        ckpt.save(gen, state)               # inside the outer loop

    - :meth:`restore` with no explicit step walks steps newest-first and
      falls back past corrupt files to the newest valid one (each skip
      journaled as a ``checkpoint_corrupt`` event).
    - Rotation never deletes the newest checkpoint known to be valid: a
      save whose own read-back fails rotates nothing.
    - :meth:`steps`/:meth:`latest_step` return ``[]``/``None`` when the
      directory was removed under a live run; only :meth:`restore`
      raises.

    Restores place tensors on ``device`` (the card unless
    ``device="cpu"``), given to each restore call.
    """

    def __init__(self, directory: str, keep: int = 3, prefix: str = "ckpt",
                 fsync: bool = True):
        self.directory = directory
        self.keep = keep
        self.prefix = prefix
        self.fsync = fsync
        self._verified: set = set()   # steps whose file passed its CRC
        os.makedirs(directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"{self.prefix}_{step:08d}.pkl")

    def path_for(self, step: int) -> str:
        """The file a :meth:`save` of ``step`` lands at."""
        return self._path(step)

    def steps(self) -> List[int]:
        pat = re.compile(rf"{re.escape(self.prefix)}_(\d+)\.pkl$")
        try:
            names = os.listdir(self.directory)
        except (FileNotFoundError, NotADirectoryError):
            return []
        out = []
        for name in names:
            m = pat.match(name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: Any,
             meta: Optional[Dict[str, Any]] = None) -> str:
        path = self._path(step)
        os.makedirs(self.directory, exist_ok=True)
        want_crc = save_state(path, state, meta=meta, fsync=self.fsync)
        try:
            # read-back: the file's bytes must CRC-match the container
            # just serialized (any flipped or torn byte changes it)
            with open(path, "rb") as f:
                got_crc = zlib.crc32(f.read())
            if got_crc != want_crc:
                raise CheckpointCorruptError(
                    path, "post-save read-back CRC mismatch")
            self._verified.add(step)
        except (CheckpointCorruptError, FileNotFoundError, OSError):
            # the write went bad: keep every older file
            broadcast("checkpoint_corrupt", path=path,
                      phase="post_save_verify")
            return path
        if self.keep is not None:
            steps = self.steps()
            last_good = max((s for s in self._verified if s in steps),
                            default=None)
            for old in steps[: -self.keep]:
                if old == last_good:
                    continue  # never delete the last verified-good one
                os.remove(self._path(old))
        return path

    def restore(self, step: Optional[int] = None,
                device: DeviceLike = None) -> Any:
        """Restore a checkpoint. With ``step=None``: the newest valid one
        (corrupt files skipped, journaled); raises only when nothing
        valid remains. With an explicit ``step``: exactly that file,
        raising ``FileNotFoundError``/:class:`CheckpointCorruptError`."""
        if step is not None:
            path = self._path(step)
            if not os.path.exists(path):
                raise FileNotFoundError(
                    f"no checkpoint for step {step}: {path} is missing")
            state = restore_state(path, device)
            self._verified.add(step)
            return state
        got = self.restore_latest(device=device)
        if got is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        return got[1]

    def restore_latest(self, tenant_id: Optional[str] = None,
                       device: DeviceLike = None
                       ) -> Optional[Tuple[int, Any]]:
        """``(step, state)`` of the newest valid checkpoint, or ``None``
        when the directory holds none. Corrupt files are skipped
        newest-first, each journaled as ``checkpoint_corrupt``; if every
        file is corrupt, raises :class:`CheckpointCorruptError`.

        ``tenant_id`` filters the walk: files whose ``meta`` carries
        another ``tenant_id``, or none, are skipped (each journaled as
        ``checkpoint_tenant_mismatch``)."""
        steps = self.steps()
        if not steps:
            return None
        dev = resolve_device(device)
        last_error: Optional[CheckpointCorruptError] = None
        for s in reversed(steps):
            path = self._path(s)
            meta: Dict[str, Any] = {}
            t0 = time.perf_counter()
            try:
                # each file loaded and verified once a walk
                payload = _load_payload(path)
                _verify_payload(path, payload)
                meta = _meta_of(payload)
                if tenant_id is not None \
                        and meta.get("tenant_id") != tenant_id:
                    broadcast("checkpoint_tenant_mismatch", path=path,
                              expected=tenant_id,
                              found=meta.get("tenant_id"))
                    continue
                state = _materialize(path, payload, dev)
            except FileNotFoundError:
                continue  # rotated away between listdir and read
            except CheckpointCorruptError as e:
                last_error = e
                broadcast("checkpoint_corrupt", path=path, detail=e.detail,
                          fallback=True)
                continue
            finally:
                _RESTORE_SECONDS[0] += time.perf_counter() - t0
            self._verified.add(s)
            if s != steps[-1]:
                broadcast("checkpoint_fallback", path=path, step=s,
                          skipped=[x for x in steps if x > s])
            broadcast("checkpoint_restore", path=path, step=s,
                      **{k: meta[k] for k in ("tenant_id", "request_id")
                         if meta.get(k)})
            return s, state
        if tenant_id is not None and last_error is None:
            return None  # only foreign-tenant files present
        raise last_error if last_error is not None else FileNotFoundError(
            f"no checkpoints in {self.directory}")

    def meta(self, step: Optional[int] = None) -> Dict[str, Any]:
        """The ``meta`` dict of a checkpoint (default: the latest step),
        read without restoring the state."""
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(
                    f"no checkpoints in {self.directory}")
        return checkpoint_meta(self._path(step))

    def clear(self) -> None:
        shutil.rmtree(self.directory, ignore_errors=True)
        self._verified.clear()
        os.makedirs(self.directory, exist_ok=True)


class AsyncCheckpointWriter:
    """Double-buffered checkpoint writes: snapshot on the caller's
    thread, pickle + fsync on a background one.

    :meth:`submit` takes an ordered copy of the state at once (a
    tensor's next in-place write cannot reach the file: a CUDA tensor is
    copied to pinned host memory on the current stream, ahead of the
    next segment's kernels, and the worker waits for that copy before
    reading it; a CPU tensor and every other leaf are copied there and
    then), then a worker thread runs the ordinary crash-consistent
    :meth:`Checkpointer.save`. The caller dispatches the next segment at
    once; only the copy sits in its stream.

    At most one write is in flight: :meth:`submit` waits for the
    previous one first, and a worker's exception is re-raised on the
    caller's thread at the next :meth:`wait`/:meth:`submit`. The file
    format and its guarantees are those of a synchronous save.
    """

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._exc: Optional[BaseException] = None

    def submit(self, ckpt: Checkpointer, step: int, state: Any,
               meta: Optional[Dict[str, Any]] = None) -> str:
        """Queue ``ckpt.save(step, state, meta)``; returns the path the
        checkpoint will land at. Blocks only until the previous submit
        finished."""
        self.wait()
        snap = _Snapshot(state)

        def work():
            try:
                ckpt.save(step, snap, meta=meta)
            except BaseException as e:  # surfaced at the next wait()
                self._exc = e

        self._thread = threading.Thread(
            target=work, name="deap-tpu-torch-ckpt-writer", daemon=True)
        self._thread.start()
        return ckpt.path_for(step)

    @property
    def in_flight(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def wait(self) -> None:
        """Block until the in-flight write (if any) is durable; re-raise
        its exception on this thread."""
        t = self._thread
        if t is not None:
            t.join()
            self._thread = None
        if self._exc is not None:
            exc, self._exc = self._exc, None
            raise exc
