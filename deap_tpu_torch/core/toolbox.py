"""Toolbox — the alias registry that is the framework's plugin boundary.

A copy of :mod:`deap_tpu.core.toolbox` (it uses only ``functools``), kept
here so the port never imports the JAX package. ``register(alias, fn,
*args, **kw)`` stores a partial application under ``toolbox.<alias>``
with the wrapped function's ``__name__``/``__doc__``; ``unregister``
removes it; ``decorate`` re-wraps the underlying function with
decorators while keeping the bound arguments.

In the port, registered operators take a ``torch.Generator`` and batched
tensors: ``mate(generator, g1[m, L], g2[m, L])``, ``mutate(generator,
g[n, L])``, ``select(generator, wvalues, k)``, ``evaluate(genomes)``.
"""

from __future__ import annotations

import functools
from typing import Any, Callable


class Toolbox:
    def __init__(self):
        # Defaults mirror the reference (base.py:48-50): clone and map.
        # In the tensor backend clone is a no-op (values are immutable);
        # the compat backend re-registers deepcopy.
        self.register("map", map)
        self.register("clone", lambda x: x)

    def register(self, alias: str, function: Callable, *args: Any, **kwargs: Any) -> None:
        """Bind ``function`` with default args under ``self.<alias>``.

        Later positional/keyword arguments at call time are appended /
        override, exactly like ``functools.partial`` (base.py:81-91).
        """
        pfunc = functools.partial(function, *args, **kwargs)
        pfunc.__name__ = getattr(function, "__name__", alias)
        pfunc.__doc__ = getattr(function, "__doc__", None)
        if hasattr(function, "__dict__") and not isinstance(function, type):
            pfunc.__dict__.update(function.__dict__.copy())
        setattr(self, alias, pfunc)

    def unregister(self, alias: str) -> None:
        """Remove an alias (base.py:93-98) — e.g. to strip unpicklable
        closures before shipping the toolbox to workers."""
        delattr(self, alias)

    def decorate(self, alias: str, *decorators: Callable) -> None:
        """Re-register ``alias`` with its function wrapped by ``decorators``
        (applied in order), preserving bound default arguments
        (base.py:100-122). Used for staticLimit, penalty wrappers,
        History tracking, benchmark transforms.
        """
        pfunc = getattr(self, alias)
        function, args, kwargs = pfunc.func, pfunc.args, pfunc.keywords
        for decorator in decorators:
            function = decorator(function)
        self.register(alias, function, *args, **kwargs)
