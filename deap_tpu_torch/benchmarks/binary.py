"""Bit-genome benchmark functions and the genotype-decode decorator.

Port of :mod:`deap_tpu.benchmarks.binary`: ``bin2float``, the trap and
inverse trap, Chuang and Hsu's deceptive f1-f3 and Mitchell's royal
roads. Each takes a population of bit genomes ``[n, L]`` (bool or int)
and returns ``f32[n, 1]``.
"""

from __future__ import annotations

from functools import wraps

import torch

__all__ = ["bin2float", "trap", "inv_trap", "chuang_f1", "chuang_f2",
           "chuang_f3", "royal_road1", "royal_road2"]


def bin2float(min_, max_, nbits):
    """Decorator: decode each row of bits into ``L // nbits`` floats in
    ``[min_, max_]`` (most significant bit first) before calling the
    wrapped evaluation on ``f32[n, L // nbits]``."""
    def wrap(function):
        @wraps(function)
        def wrapped(individual, *args, **kwargs):
            bits = individual.to(torch.float32)
            nelem = bits.shape[1] // nbits
            chunks = bits[:, :nelem * nbits].reshape(-1, nelem, nbits)
            weights = 2.0 ** torch.arange(nbits - 1, -1, -1,
                                          dtype=torch.float32,
                                          device=bits.device)
            gene = chunks @ weights
            decoded = min_ + gene / (2.0 ** nbits - 1.0) * (max_ - min_)
            return function(decoded, *args, **kwargs)
        return wrapped
    return wrap


def _trap_window(u: torch.Tensor, k: int) -> torch.Tensor:
    """The trap of a window of ``k`` bits with ``u`` ones."""
    return torch.where(u == k, float(k), k - 1.0 - u)


def _inv_trap_window(u: torch.Tensor, k: int) -> torch.Tensor:
    """The inverse trap of a window of ``k`` bits with ``u`` ones."""
    return torch.where(u == 0, float(k), u - 1.0)


def _unitation(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32).sum(-1)


def trap(x: torch.Tensor) -> torch.Tensor:
    """The trap over the whole genome."""
    return _trap_window(_unitation(x), x.shape[1])[:, None]


def inv_trap(x: torch.Tensor) -> torch.Tensor:
    """The inverse trap over the whole genome."""
    return _inv_trap_window(_unitation(x), x.shape[1])[:, None]


def _windowed_unitation(x: torch.Tensor, width: int) -> torch.Tensor:
    n = (x.shape[1] // width) * width
    return _unitation(x[:, :n].reshape(x.shape[0], -1, width))


def chuang_f1(x: torch.Tensor) -> torch.Tensor:
    """Chuang and Hsu's f1 (40 + 1 bits): the last bit picks the trap or
    the inverse trap over ten 4-bit windows."""
    u = _windowed_unitation(x[:, :-1], 4)
    t = _trap_window(u, 4).sum(1)
    i = _inv_trap_window(u, 4).sum(1)
    return torch.where(x[:, -1] == 0, i, t)[:, None]


def chuang_f2(x: torch.Tensor) -> torch.Tensor:
    """Chuang and Hsu's f2 (40 + 2 bits): the last two bits pick the trap
    or the inverse trap for each 4-bit half of the 8-bit windows."""
    u = _windowed_unitation(x[:, :-2], 4)
    first, second = u[:, 0::2], u[:, 1::2]
    b0, b1 = x[:, -2], x[:, -1]
    f_first = torch.where(b0 == 0, _inv_trap_window(first, 4).sum(1),
                          _trap_window(first, 4).sum(1))
    f_second = torch.where(b1 == 0, _inv_trap_window(second, 4).sum(1),
                           _trap_window(second, 4).sum(1))
    return (f_first + f_second)[:, None]


def chuang_f3(x: torch.Tensor) -> torch.Tensor:
    """Chuang and Hsu's f3: f1's inverse traps on one branch; on the other
    the windows shifted by two, with a trap on the wrapped seam."""
    u0 = _windowed_unitation(x[:, :-1], 4)
    branch0 = _inv_trap_window(u0, 4).sum(1)
    u1 = _windowed_unitation(x[:, :-1][:, 2:], 4)
    seam = torch.cat([x[:, -2:], x[:, :2]], dim=1)
    branch1 = (_inv_trap_window(u1, 4).sum(1)
               + _trap_window(_unitation(seam), 4))
    return torch.where(x[:, -1] == 0, branch0, branch1)[:, None]


def royal_road1(x: torch.Tensor, order: int) -> torch.Tensor:
    """Mitchell's royal road R1: each whole block of ``order`` bits scores
    ``order`` when all ones."""
    u = _windowed_unitation(x, order)
    return (order * torch.floor(u / order).sum(1))[:, None]


def royal_road2(x: torch.Tensor, order: int) -> torch.Tensor:
    """Royal road R2: R1 summed at doubling orders below ``order²``."""
    total = torch.zeros(x.shape[0], dtype=torch.float32, device=x.device)
    norder = order
    while norder < order ** 2:
        total = total + royal_road1(x, norder)[:, 0]
        norder *= 2
    return total[:, None]
