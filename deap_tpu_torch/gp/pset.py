"""Primitive sets — the GP instruction vocabulary as static tables.

Port of :mod:`deap_tpu.gp.pset`. Primitives are torch elementwise
functions. Each stock primitive also names its **device op**: one entry
of :data:`DEVICE_OPS`, the closed table of primitives that the grouped
evaluator's CUDA kernel (``csrc/gp_grouped.cu``) implements. A primitive
without one evaluates in the scan and sweep modes, and on the CPU, but
not through the kernel.

Node-id encoding for a set with ``n_ops`` operators, ``n_args`` inputs
and a constant pool (as in the JAX package):

- ``0 .. n_ops-1``       — operators (arity from ``arity_table``)
- ``n_ops .. n_ops+n_args-1`` — input arguments ARG0..ARGn
- ``n_ops+n_args .. +n_consts-1`` — fixed constant terminals
- ``n_ops+n_args+n_consts``        — the ephemeral constant (ERC)

Every constant-family node reads its value from the parallel ``consts``
array; the interpreters collapse all of them onto one constant row.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import torch

from deap_tpu_torch.ops.kernels import GP_DEVICE_OPS as DEVICE_OPS


@dataclasses.dataclass
class _Primitive:
    name: str
    fn: Optional[Callable]  # (a, b, c ...) elementwise torch function
    arity: int
    fmt: Optional[str] = None  # e.g. "({0} + {1})" for pretty printing
    device_op: Optional[str] = None  # key of DEVICE_OPS, or None
    adf: Optional[int] = None  # branch index when this is an ADF call

    def format(self, *args: str) -> str:
        if self.fmt:
            return self.fmt.format(*args)
        return f"{self.name}({', '.join(args)})"


#: the empty mask's branch (the JAX package's ``lambda a: a``)
IDENTITY = _Primitive("identity", lambda a: a, 1, device_op="identity")


class PrimitiveSet:
    """Untyped primitive set.

    :param name: set name.
    :param arity: number of input arguments.
    :param prefix: argument name prefix (``ARG0``, ``ARG1``, ...).
    """

    def __init__(self, name: str, arity: int, prefix: str = "ARG"):
        self.name = name
        self.n_args = arity
        self.arg_names = [f"{prefix}{i}" for i in range(arity)]
        self.primitives: List[_Primitive] = []
        self.const_values: List[float] = []     # fixed terminal pool
        self.const_names: List[str] = []
        self.erc_sampler: Optional[Callable] = None
        self.erc_name: Optional[str] = None
        self._tables: dict = {}

    # ------------------------------------------------------------ builder ----

    def add_primitive(self, fn: Callable, arity: int,
                      name: Optional[str] = None,
                      fmt: Optional[str] = None,
                      device_op: Optional[str] = None) -> None:
        """Register an operator. ``fn`` must be an elementwise torch
        function of ``arity`` tensors; ``device_op`` names the entry of
        :data:`DEVICE_OPS` that computes the same function in the grouped
        evaluator's kernel."""
        if arity < 1:
            raise ValueError("arity should be >= 1")
        if device_op is not None:
            if device_op not in DEVICE_OPS:
                raise ValueError(f"unknown device op {device_op!r}; the "
                                 f"kernel implements {sorted(DEVICE_OPS)}")
            if DEVICE_OPS[device_op][1] != arity:
                raise ValueError(f"device op {device_op!r} takes "
                                 f"{DEVICE_OPS[device_op][1]} operands, "
                                 f"not {arity}")
        self.primitives.append(
            _Primitive(name or fn.__name__, fn, arity, fmt, device_op))

    def add_adf(self, name: str, arity: int, branch: int) -> None:
        """Register an Automatically Defined Function call: the node
        evaluates branch ``branch`` of the same individual on its
        ``arity`` operand rows. Only the interpreters of
        :mod:`deap_tpu_torch.gp.adf` evaluate such nodes (it has no device
        op, so the grouped kernel refuses it)."""
        if arity < 1:
            raise ValueError("ADFs take at least one argument")
        self.primitives.append(_Primitive(name, None, arity, None, None,
                                          branch))

    @property
    def has_adf(self) -> bool:
        return any(p.adf is not None for p in self.primitives)

    def add_terminal(self, value: float, name: Optional[str] = None) -> None:
        """Register a constant terminal, sampled uniformly among fixed
        terminals."""
        self.const_values.append(float(value))
        self.const_names.append(name if name is not None else repr(value))

    def add_ephemeral_constant(self, name: str, sampler: Callable) -> None:
        """Register an ephemeral random constant: ``sampler(generator,
        shape) -> f32`` draws a fresh value for every ERC node."""
        if self.erc_sampler is not None:
            raise ValueError("one ephemeral constant pool per set")
        self.erc_sampler = sampler
        self.erc_name = name

    def rename_arguments(self, **kwargs: str) -> None:
        """Rename ARGi: ``pset.rename_arguments(ARG0='x')``."""
        for key, val in kwargs.items():
            if key.startswith("ARG"):
                self.arg_names[int(key[3:])] = val

    # ------------------------------------------------------------- tables ----

    @property
    def n_ops(self) -> int:
        return len(self.primitives)

    @property
    def n_consts(self) -> int:
        return len(self.const_values)

    @property
    def has_erc(self) -> bool:
        return self.erc_sampler is not None

    @property
    def const_id(self) -> int:
        """First constant-family node id; every id >= this reads the
        ``consts`` array."""
        return self.n_ops + self.n_args

    @property
    def erc_id(self) -> int:
        """Node id of the ephemeral constant (valid only if has_erc)."""
        return self.n_ops + self.n_args + self.n_consts

    @property
    def vocab(self) -> int:
        return self.n_ops + self.n_args + self.n_consts + (
            1 if self.has_erc else 0)

    @property
    def max_arity(self) -> int:
        return max((p.arity for p in self.primitives), default=0)

    @property
    def n_terminal_choices(self) -> int:
        """Distinct terminal draws: args + fixed consts + ERC."""
        return self.n_args + self.n_consts + (1 if self.has_erc else 0)

    @property
    def terminal_ratio(self) -> float:
        """terminals / (terminals + primitives)."""
        t = self.n_terminal_choices
        return t / (t + self.n_ops)

    def arity_list(self) -> List[int]:
        """Operator arities then zeros for terminals, as a list."""
        return ([p.arity for p in self.primitives]
                + [0] * (self.vocab - self.n_ops))

    def _layout(self) -> tuple:
        """What the set's static tables depend on."""
        return tuple(self.arity_list()), tuple(self.const_values)

    def table(self, what: str, device, build: Callable) -> torch.Tensor:
        """The static table ``what`` of the set on ``device``: ``build()``,
        a host tensor, copied there once per device and vocabulary state
        (a set extended later rebuilds), so that an operator on the card
        does not wait for a copy from the host."""
        key = (what, torch.device(device), self._layout())
        table = self._tables.get(key)
        if table is None:
            table = self._tables[key] = build().to(key[1])
        return table

    def arity_table(self, device="cpu") -> torch.Tensor:
        """``int64[vocab + 1]`` on ``device`` — operator arities then zeros
        for terminals, and a last 0 for id ``vocab``: the padding id
        ``const_id`` of a set with no constant terminal (the JAX package's
        gather clamps it onto a terminal)."""
        return self.table("arity", device, lambda: torch.tensor(
            self.arity_list() + [0], dtype=torch.int64))

    def terminal_of_choice(self, choice: torch.Tensor,
                           erc: torch.Tensor):
        """Terminal draw ``choice`` (uniform in ``[0, n_terminal_choices)``)
        and the ERC value drawn beside it → ``(node_id int32, value f32)``,
        as the JAX package's ``sample_terminal`` maps its two draws."""
        node = (self.n_ops + choice).to(torch.int32)
        if self.n_consts:
            pool = self.table("consts", choice.device, lambda: torch.tensor(
                self.const_values, dtype=torch.float32))
            fixed = pool[(choice - self.n_args).clamp(0, self.n_consts - 1)]
        else:
            fixed = torch.zeros(choice.shape, dtype=torch.float32,
                                device=choice.device)
        if self.has_erc:
            value = torch.where(choice == self.n_args + self.n_consts,
                                erc.to(torch.float32), fixed)
        else:
            value = fixed
        return node, value

    # ------------------------------------------------------------ display ----

    def node_name(self, node_id: int, const: float = 0.0) -> str:
        if node_id < self.n_ops:
            return self.primitives[node_id].name
        if node_id < self.const_id:
            return self.arg_names[node_id - self.n_ops]
        if node_id < self.erc_id:
            return self.const_names[node_id - self.const_id]
        return repr(round(float(const), 6))


# ------------------------------------------------------- stock primitives ----

def protected_div(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x/y with 1 where y == 0 (the reference's protectedDiv pattern)."""
    zero = b == 0.0
    return torch.where(zero, 1.0, a / torch.where(zero, 1.0, b))


def _uniform_sampler(low: float, high: float) -> Callable:
    def sample(generator: torch.Generator, shape) -> torch.Tensor:
        u = torch.rand(shape, generator=generator, device=generator.device)
        return u * (high - low) + low
    return sample


def math_set(n_args: int = 1, erc_low: float = -1.0, erc_high: float = 1.0,
             trig: bool = True, erc: bool = True,
             name: str = "MAIN") -> PrimitiveSet:
    """The canonical symbolic-regression vocabulary (add, sub, mul,
    protectedDiv, neg, cos, sin + a uniform ERC)."""
    ps = PrimitiveSet(name, n_args)
    ps.add_primitive(torch.add, 2, "add", "({0} + {1})", "add")
    ps.add_primitive(torch.sub, 2, "sub", "({0} - {1})", "sub")
    ps.add_primitive(torch.mul, 2, "mul", "({0} * {1})", "mul")
    ps.add_primitive(protected_div, 2, "protectedDiv", "({0} / {1})",
                     "protectedDiv")
    ps.add_primitive(torch.neg, 1, "neg", "(-{0})", "neg")
    if trig:
        ps.add_primitive(torch.cos, 1, "cos", device_op="cos")
        ps.add_primitive(torch.sin, 1, "sin", device_op="sin")
    if erc:
        ps.add_ephemeral_constant("rand101",
                                  _uniform_sampler(erc_low, erc_high))
    return ps


def bool_set(n_args: int, name: str = "BOOL") -> PrimitiveSet:
    """Boolean vocabulary over {0.0, 1.0} floats (the parity and
    multiplexer sets)."""
    ps = PrimitiveSet(name, n_args)
    ps.add_primitive(lambda a, b: a * b, 2, "and_", "({0} & {1})", "and")
    ps.add_primitive(lambda a, b: (a + b).clamp(max=1.0), 2, "or_",
                     "({0} | {1})", "or")
    ps.add_primitive(lambda a: 1.0 - a, 1, "not_", "(~{0})", "not")
    ps.add_primitive(lambda a, b: (a - b).abs(), 2, "xor_", "({0} ^ {1})",
                     "xor")
    ps.add_primitive(lambda c, a, b: torch.where(c > 0.5, a, b), 3,
                     "if_then_else", device_op="if_then_else")
    ps.add_terminal(0.0, "False")
    ps.add_terminal(1.0, "True")
    return ps
