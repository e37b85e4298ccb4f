"""Expression parser for the user-facing function DSL, evaluated on torch.

The grammar is the JAX package's (`mrhyde_tpu/functions/parser.py`,
itself the reference interpreter's: operators + - * / ^, parentheses,
comparisons < >, function calls, leaves x, y, z, t, pi, numbers,
variable names, grad(u)[x], u_t, parameter and function names). The AST
is the same; only the evaluator differs: tensors go through torch ops,
and an expression that reads no array leaf stays a Python float, as
constant expressions stay Python scalars in JAX. The fused assembly
classifies Jacobian and residual rows by exactly that. The sparse dual
numbers of ops/sparse_dual.py go through their own rules (the JAX
package's sparse forward AD), so a module set's plain version
differentiates a coefficient that reads the state as JAX's kernel does.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass

import numpy as np
import torch

from mrhyde_tpu_torch.ops.sparse_dual import BINARY, UNARY, SDual, abs_, value

__all__ = ["parse_expression", "Expr"]

_TOKEN_RE = re.compile(r"""
    (?P<num>\d+\.?\d*(?:[eE][+-]?\d+)?|\.\d+(?:[eE][+-]?\d+)?)
  | (?P<grad>(?:grad|curl)\(\s*[A-Za-z_]\w*\s*\)\[\s*[xyz]\s*\])
  | (?P<divc>(?:div|curl)\(\s*[A-Za-z_]\w*\s*\))
  | (?P<comp>[A-Za-z_]\w*\[\s*[xyz]\s*\])
  | (?P<name>[A-Za-z_][\w\s]*?(?=\s*[-+*/^(),<>\[\]]|\s*$))
  | (?P<op>[-+*/^(),<>])
  | (?P<ws>\s+)
""", re.VERBOSE)


def _scalar(v):
    """A non-tensor operand as a numpy float64 (numpy's inf/nan rules
    match jnp's where Python's float raises)."""
    return np.float64(v)


def _unary(tfn, nfn, name=None):
    def op(v):
        if isinstance(v, SDual):
            return UNARY[name](v)
        if isinstance(v, torch.Tensor):
            return tfn(v)
        with np.errstate(all="ignore"):
            return float(nfn(_scalar(v)))
    return op


def _binary(tfn, nfn, name):
    def op(a, b):
        if isinstance(a, SDual) or isinstance(b, SDual):
            return BINARY[name](a, b)
        if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
            ref = a if isinstance(a, torch.Tensor) else b
            a = torch.as_tensor(a, dtype=ref.dtype, device=ref.device)
            b = torch.as_tensor(b, dtype=ref.dtype, device=ref.device)
            return tfn(a, b)
        with np.errstate(all="ignore"):
            return float(nfn(_scalar(a), _scalar(b)))
    return op


def _ereduce(tfn):
    """Element reduction over the quadrature axis, broadcast back to
    every qp (the JAX package's emax/emin/emean)."""
    def op(v):
        return tfn(v, dim=-1, keepdim=True).expand(v.shape)
    return op


_FUNCS = {name: _unary(getattr(torch, name), getattr(np, name), name)
          for name in ("sin", "cos", "tan", "exp", "log", "sqrt", "abs",
                       "sinh", "cosh", "tanh")}
# |x| with jnp.abs's tangent at 0 (sparse_dual.abs_)
_FUNCS["abs"] = _unary(abs_, np.abs, "abs")
_FUNCS.update({
    "emax": _ereduce(torch.amax), "emin": _ereduce(torch.amin),
    "emean": _ereduce(torch.mean),
})
_FUNCS2 = {
    "min": _binary(torch.minimum, np.minimum, "min"),
    "max": _binary(torch.maximum, np.maximum, "max"),
    "pow": _binary(torch.pow, np.power, "pow"),
    "atan2": _binary(torch.atan2, np.arctan2, "atan2"),
    # binary average (reference op 'mean': data = 0.5 data + 0.5 arg)
    "mean": lambda a, b: 0.5 * (a + b),
}


def _compare(a, b, less):
    """Reference lt/gt: 1.0 where the comparison holds, else 0.0 (no
    tangent, as jnp.where of two constants has none)."""
    a, b = value(a), value(b)
    if not isinstance(a, torch.Tensor) and not isinstance(b, torch.Tensor):
        return 1.0 if (a < b if less else a > b) else 0.0
    ref = a if isinstance(a, torch.Tensor) else b
    return (a < b if less else a > b).to(ref.dtype)


@dataclass
class Expr:
    """AST node: kind in {num, leaf, pindex, call, binop, neg}."""
    kind: str
    value: object = None
    args: tuple = ()

    def leaves(self) -> set[str]:
        out = set()
        if self.kind == "leaf":
            out.add(self.value)
        elif self.kind == "pindex":
            out.add(self.value[0])
        for a in self.args:
            out |= a.leaves()
        return out

    def evaluate(self, resolve):
        """Evaluate against `resolve(name) -> tensor/scalar`."""
        k = self.kind
        if k == "num":
            return self.value
        if k == "leaf":
            if self.value == "pi":
                return math.pi
            return resolve(self.value)
        if k == "pindex":
            name, idx = self.value
            v = resolve(name)
            if not isinstance(v, torch.Tensor) or v.dim() == 0:
                return v            # scalar param: name(0) == name
            return v[idx]
        if k == "neg":
            return -self.args[0].evaluate(resolve)
        if k == "call":
            fname = self.value
            vals = [a.evaluate(resolve) for a in self.args]
            if fname in _FUNCS:
                return _FUNCS[fname](vals[0])
            if fname in _FUNCS2:
                return _FUNCS2[fname](*vals)
            raise ValueError(f"unknown function {fname!r}")
        if k == "binop":
            a = self.args[0].evaluate(resolve)
            b = self.args[1].evaluate(resolve)
            op = self.value
            if op == "+":
                return a + b
            if op == "-":
                return a - b
            if op == "*":
                return a * b
            if op == "/":
                return a / b
            if op == "^":
                return a ** b
            if op in ("<", ">"):
                return _compare(a, b, op == "<")
            raise ValueError(f"unknown operator {op!r}")
        raise ValueError(f"bad node kind {k!r}")


def _tokenize(s: str) -> list[tuple[str, str]]:
    tokens = []
    pos = 0
    while pos < len(s):
        m = _TOKEN_RE.match(s, pos)
        if not m:
            raise ValueError(f"cannot tokenize {s!r} at position {pos}")
        pos = m.end()
        kind = m.lastgroup
        if kind == "ws":
            continue
        text = m.group().strip()
        if kind in ("grad", "divc", "comp"):
            text = re.sub(r"\s+", "", text)
            kind = "grad"      # all resolve as composite leaves
        tokens.append((kind, text))
    return tokens


class _Parser:
    def __init__(self, tokens):
        self.toks = tokens
        self.i = 0

    def peek(self):
        return self.toks[self.i] if self.i < len(self.toks) else (None, None)

    def pop(self):
        t = self.peek()
        self.i += 1
        return t

    def expect(self, text):
        k, t = self.pop()
        if t != text:
            raise ValueError(f"expected {text!r}, got {t!r}")

    def parse(self) -> Expr:
        e = self.comparison()
        if self.i != len(self.toks):
            raise ValueError(f"trailing tokens: {self.toks[self.i:]}")
        return e

    def comparison(self) -> Expr:
        e = self.addsub()
        while self.peek()[1] in ("<", ">"):
            op = self.pop()[1]
            e = Expr("binop", op, (e, self.addsub()))
        return e

    def addsub(self) -> Expr:
        e = self.muldiv()
        while self.peek()[1] in ("+", "-"):
            op = self.pop()[1]
            e = Expr("binop", op, (e, self.muldiv()))
        return e

    def muldiv(self) -> Expr:
        e = self.unary()
        while self.peek()[1] in ("*", "/"):
            op = self.pop()[1]
            e = Expr("binop", op, (e, self.unary()))
        return e

    def unary(self) -> Expr:
        if self.peek()[1] == "-":
            self.pop()
            return Expr("neg", None, (self.unary(),))
        if self.peek()[1] == "+":
            self.pop()
            return self.unary()
        return self.power()

    def power(self) -> Expr:
        e = self.atom()
        if self.peek()[1] == "^":
            self.pop()
            return Expr("binop", "^", (e, self.unary()))
        return e

    def atom(self) -> Expr:
        kind, text = self.pop()
        if kind == "num":
            return Expr("num", float(text))
        if kind == "grad":
            return Expr("leaf", text)
        if kind == "name":
            if self.peek()[1] == "(" and (text in _FUNCS or text in _FUNCS2):
                self.pop()
                args = [self.comparison()]
                while self.peek()[1] == ",":
                    self.pop()
                    args.append(self.comparison())
                self.expect(")")
                return Expr("call", text, tuple(args))
            if self.peek()[1] == "(":
                # parameter indexing: 'thermal_diff(0)' reads component
                # 0 of a (vector) parameter
                save = self.i
                self.pop()
                k2, t2 = self.pop()
                if k2 == "num" and self.peek()[1] == ")":
                    self.pop()
                    return Expr("pindex", (text, int(float(t2))), ())
                self.i = save
            return Expr("leaf", text)
        if text == "(":
            e = self.comparison()
            self.expect(")")
            return e
        raise ValueError(f"unexpected token {text!r}")


def parse_expression(s) -> Expr:
    """Parse a DSL string (or number) into an Expr AST.

    Unbalanced opening parentheses are auto-closed, as in the JAX
    package and the reference interpreter."""
    if isinstance(s, (int, float)):
        return Expr("num", float(s))
    s = str(s).strip()
    if not s:
        return Expr("num", 0.0)
    missing = s.count("(") - s.count(")")
    if missing > 0:
        s = s + ")" * missing
    return _Parser(_tokenize(s)).parse()
