"""FunctionManager: named user/physics expressions evaluated on worksets.

The JAX package's manager (`mrhyde_tpu/functions/manager.py`) over the
torch evaluator of `parser.py`: expressions are parsed once at setup
and evaluated eagerly on tensors.
"""

from __future__ import annotations

from mrhyde_tpu_torch.functions.parser import Expr, parse_expression

__all__ = ["FunctionManager"]


class FunctionManager:
    """Registry of named expressions per evaluation location.

    Locations mirror the reference: "ip" (volume quadrature),
    "side ip" (face quadrature), "point".
    """

    def __init__(self):
        self._exprs: dict[tuple[str, str], Expr] = {}

    def add_function(self, name: str, expression, location: str = "ip"):
        self._exprs[(name, location)] = parse_expression(expression)

    def has(self, name: str, location: str = "ip") -> bool:
        return (name, location) in self._exprs

    def evaluate(self, name: str, wk, location: str = "ip"):
        """Evaluate a named function against a workset-like resolver.

        `wk` must provide .resolve(leaf_name) for non-function leaves.
        """
        return self._eval(name, wk, location, frozenset())

    def evaluate_expr(self, expression, wk, location: str = "ip"):
        """Evaluate an ad-hoc expression string (parsed and cached)."""
        expr = self._adhoc(expression, location)
        return expr.evaluate(lambda leaf: self._resolve(leaf, wk, location,
                                                        frozenset()))

    def terminal_leaves(self, name: str, location: str = "ip") -> set[str]:
        """The leaves a named function reads once every named function
        it refers to is expanded: what a workset has to resolve."""
        return self._terminal(self._lookup(name, location), location,
                              frozenset({name}))

    def _adhoc(self, expression, location):
        key = ("__adhoc__:" + str(expression), location)
        if key not in self._exprs:
            self._exprs[key] = parse_expression(expression)
        return self._exprs[key]

    def _lookup(self, name: str, location: str) -> Expr:
        expr = self._exprs.get((name, location))
        if expr is None:
            # fall back to another location's definition (the reference
            # registers e.g. "thermal diffusion" at both ip and side ip)
            for (n, _loc), e in self._exprs.items():
                if n == name:
                    expr = e
                    break
        if expr is None:
            raise KeyError(f"function {name!r} not defined")
        return expr

    def _is_function(self, leaf: str) -> bool:
        return any(n == leaf for (n, _l) in self._exprs)

    def _terminal(self, expr: Expr, location: str, stack: frozenset):
        out = set()
        for leaf in expr.leaves():
            if self._is_function(leaf):
                if leaf in stack:
                    raise ValueError(
                        f"cyclic function definition involving {leaf!r}")
                out |= self._terminal(self._lookup(leaf, location),
                                      location, stack | {leaf})
            else:
                out.add(leaf)
        return out

    def _eval(self, name: str, wk, location: str, stack: frozenset):
        if name in stack:
            raise ValueError(f"cyclic function definition involving {name!r}")
        expr = self._lookup(name, location)
        stack = stack | {name}
        return expr.evaluate(lambda leaf: self._resolve(leaf, wk, location,
                                                        stack))

    def _resolve(self, leaf: str, wk, location: str, stack: frozenset):
        if self._is_function(leaf):
            return self._eval(leaf, wk, location, stack)
        return wk.resolve(leaf)
