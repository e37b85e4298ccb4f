"""Sparse forward-mode dual numbers for the fused assembly's weak forms.

The port's counterpart of the JAX package's `mrhyde_tpu/ops/
sparse_fwd.py`. JAX traces a qp density to a jaxpr and interprets it
with per-slot tangent dicts; here the density is plain Python arithmetic
run on `SDual` values, which carry the same dicts directly. A tangent
entry is missing where it is STRUCTURALLY zero, a Python float where it
is element-independent, or a tensor where it depends on element data,
and each rule below is the JVP rule of `sparse_fwd.py` for the same
primitive, in the same operand order. So a density run on (2,)-shaped
stand-ins classifies its Jacobian entries exactly as the JAX probe does
(`ops/fused_p1.py` `_probe`), and run on the real corner grids it is the
plain version of the fused NS kernel.

`sqrt_` and `where_` take SDuals, tensors or Python floats alike, so a
weak form written with them serves the general path (torch tensors
under vmap/jacfwd) and the fused path (SDuals) unchanged.

The function DSL's elementary functions (`UNARY`, `BINARY`: sin ... tanh,
min, max, pow, atan2) and `^` on SDuals follow `sparse_fwd.py`'s rules
too, its conventions at kinks included: abs takes sign(x) (0 at 0), max
and min take the first argument's tangent at a tie, and pow's exponent
tangent o log(x) enters only where the exponent carries one. So a
coefficient expression that reads the state differentiates here as it
does in the JAX kernel (functions/parser.py dispatches SDuals here).
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["SDual", "sparse_jacfwd", "sqrt_", "where_", "UNARY", "BINARY",
           "pow_", "value"]


def _add(x, y):
    if x is None:
        return y
    if y is None:
        return x
    return x + y


def _sub(x, y):
    if x is None:
        return -y
    if y is None:
        return x
    return x - y


def _tmap(fn, *tans):
    """Combine tangent dicts slot by slot; a slot missing from a dict
    enters fn as None."""
    keys = []
    for t in tans:
        keys += [k for k in t if k not in keys]
    out = {}
    for k in keys:
        r = fn(*[t.get(k) for t in tans])
        if r is not None:
            out[k] = r
    return out


def _parts(x):
    return (x.val, x.tan) if isinstance(x, SDual) else (x, {})


class SDual:
    """A primal value with a sparse dict of tangents {slot: coefficient}."""

    __slots__ = ("val", "tan")

    def __init__(self, val, tan):
        self.val = val
        self.tan = tan

    def __add__(self, other):
        (a, ta), (b, tb) = _parts(self), _parts(other)
        return SDual(a + b, _tmap(_add, ta, tb))

    def __radd__(self, other):
        (a, ta), (b, tb) = _parts(other), _parts(self)
        return SDual(a + b, _tmap(_add, ta, tb))

    def __sub__(self, other):
        (a, ta), (b, tb) = _parts(self), _parts(other)
        return SDual(a - b, _tmap(_sub, ta, tb))

    def __rsub__(self, other):
        (a, ta), (b, tb) = _parts(other), _parts(self)
        return SDual(a - b, _tmap(_sub, ta, tb))

    def __neg__(self):
        return SDual(-self.val, {k: -1.0 * t for k, t in self.tan.items()})

    @staticmethod
    def _mul(x, y):
        (a, ta), (b, tb) = _parts(x), _parts(y)
        return SDual(a * b, _tmap(
            lambda tx, ty: _add(None if tx is None else tx * b,
                                None if ty is None else a * ty), ta, tb))

    def __mul__(self, other):
        return SDual._mul(self, other)

    def __rmul__(self, other):
        return SDual._mul(other, self)

    @staticmethod
    def _div(x, y):
        (a, ta), (b, tb) = _parts(x), _parts(y)
        return SDual(a / b, _tmap(
            lambda tx, ty: _add(None if tx is None else tx / b,
                                None if ty is None else -a * ty / (b * b)),
            ta, tb))

    def __truediv__(self, other):
        return SDual._div(self, other)

    def __rtruediv__(self, other):
        return SDual._div(other, self)

    def __pow__(self, n):
        if not isinstance(n, int):
            return pow_(self, n)        # the DSL's ^ (JAX's pow)
        # integer powers (JAX's integer_pow: c = n x^(n-1))
        if n < 1:
            raise TypeError("SDual supports positive integer powers only")
        c = n * (self.val if n == 2 else self.val ** (n - 1))
        return SDual(self.val ** n, {k: c * t for k, t in self.tan.items()})

    def __rpow__(self, base):
        return pow_(base, self)

    def __gt__(self, other):
        return self.val > _parts(other)[0]

    def __lt__(self, other):
        return self.val < _parts(other)[0]


def sqrt_(x):
    """sqrt of an SDual (tangent 0.5/sqrt(x)), a tensor or a float."""
    if isinstance(x, SDual):
        s = torch.sqrt(x.val) if isinstance(x.val, torch.Tensor) \
            else math.sqrt(x.val)
        c = 0.5 / s
        return SDual(s, {k: c * t for k, t in x.tan.items()})
    if isinstance(x, torch.Tensor):
        return torch.sqrt(x)
    return math.sqrt(x)


def abs_(x):
    """|x| of a tensor or a float with jnp.abs's tangent under
    torch.func: +1 at x = 0, where torch.abs's is 0 (a state at rest sits
    on that kink: cns's eigenvalue u.n = 0); an SDual takes the sparse
    rule's sign(x), as `UNARY["abs"]`."""
    if isinstance(x, SDual):
        return UNARY["abs"](x)
    if isinstance(x, torch.Tensor):
        return torch.where(x >= 0, x, -x)
    return abs(x)


def value(x):
    """The primal value of an SDual, or x itself."""
    return x.val if isinstance(x, SDual) else x


def _call(tfn, nfn, *xs):
    """An elementary function on tensors (torch) or Python floats (numpy,
    whose inf/nan rules match jnp's where Python's float raises)."""
    ref = next((x for x in xs if isinstance(x, torch.Tensor)), None)
    if ref is not None:
        return tfn(*(torch.as_tensor(x, dtype=ref.dtype, device=ref.device)
                     for x in xs))
    with np.errstate(all="ignore"):
        return float(nfn(*(np.float64(x) for x in xs)))


def _fn(name):
    return lambda *xs: _call(*_VALUE[name], *xs)


_VALUE = {
    "sin": (torch.sin, np.sin), "cos": (torch.cos, np.cos),
    "tan": (torch.tan, np.tan), "exp": (torch.exp, np.exp),
    "log": (torch.log, np.log), "sqrt": (torch.sqrt, np.sqrt),
    "abs": (torch.abs, np.abs), "sinh": (torch.sinh, np.sinh),
    "cosh": (torch.cosh, np.cosh), "tanh": (torch.tanh, np.tanh),
    "sign": (torch.sign, np.sign), "pow": (torch.pow, np.power),
    "min": (torch.minimum, np.minimum), "max": (torch.maximum, np.maximum),
    "atan2": (torch.atan2, np.arctan2),
}
# name -> the derivative c(x, o) of o = name(x) (sparse_fwd.py's rules)
_DERIV = {
    "sin": lambda x, o: _fn("cos")(x),
    "cos": lambda x, o: -_fn("sin")(x),
    "tan": lambda x, o: 1.0 + o * o,
    "exp": lambda x, o: o,
    "log": lambda x, o: 1.0 / x,
    "sqrt": lambda x, o: 0.5 / _fn("sqrt")(x),
    "abs": lambda x, o: _fn("sign")(x),
    "sinh": lambda x, o: _fn("cosh")(x),
    "cosh": lambda x, o: _fn("sinh")(x),
    "tanh": lambda x, o: 1.0 - o * o,
}


def _unary(name):
    def op(x):
        o = _fn(name)(x.val)
        c = _DERIV[name](x.val, o)
        return SDual(o, {k: c * t for k, t in x.tan.items()})
    return op


UNARY = {name: _unary(name) for name in _DERIV}


def pow_(x, y):
    """x ** y (JAX's pow rule: y x^(y-1) on x's tangent, o log x on
    y's)."""
    (a, ta), (b, tb) = _parts(x), _parts(y)
    o = _fn("pow")(a, b)
    out = {}
    if ta:
        c = b * _fn("pow")(a, b - 1.0)
        out = {k: c * t for k, t in ta.items()}
    if tb:
        c = o * _fn("log")(a)
        oy = {k: c * t for k, t in tb.items()}
        out = _tmap(_add, out, oy) if out else oy
    return SDual(o, out)


def _select(pick, name):
    """max / min: the tangent of the picked argument, the other's
    densified to zeros (JAX's select of two tangents)."""
    def op(x, y):
        (a, ta), (b, tb) = _parts(x), _parts(y)
        o = _fn(name)(a, b)
        p = pick(a, b)

        def sel(tx, ty):
            zx = _dense(0.0 if tx is None else tx, o) \
                if isinstance(o, torch.Tensor) else (tx or 0.0)
            zy = _dense(0.0 if ty is None else ty, o) \
                if isinstance(o, torch.Tensor) else (ty or 0.0)
            if isinstance(p, torch.Tensor):
                return torch.where(p, zx, zy)
            return zx if p else zy
        return SDual(o, _tmap(sel, ta, tb))
    return op


def _atan2(x, y):
    (a, ta), (b, tb) = _parts(x), _parts(y)
    o = _fn("atan2")(a, b)
    r2 = a * a + b * b
    return SDual(o, _tmap(lambda tx, ty: _add(
        None if tx is None else b * tx / r2,
        None if ty is None else -a * ty / r2), ta, tb))


BINARY = {"pow": pow_, "atan2": _atan2,
          "max": _select(lambda a, b: _call(torch.ge, np.greater_equal,
                                            a, b), "max"),
          "min": _select(lambda a, b: _call(torch.le, np.less_equal, a, b),
                         "min")}


def _dense(v, like):
    if isinstance(v, torch.Tensor) and v.shape == like.shape:
        return v
    return torch.zeros_like(like) + v


def where_(cond, a, b):
    """Select a where cond holds, else b. On SDuals the tangents follow
    the selected branch (JAX's select_n rule: structural zeros densify
    to zeros), so a branch that is not taken contributes nothing, not
    even a NaN."""
    if not isinstance(a, SDual) and not isinstance(b, SDual):
        if isinstance(cond, torch.Tensor):
            return torch.where(cond, a, b)
        return a if cond else b
    (va, ta), (vb, tb) = _parts(a), _parts(b)
    if not isinstance(cond, torch.Tensor):
        return a if cond else b
    val = torch.where(cond, va, vb)
    return SDual(val, _tmap(
        lambda x, y: torch.where(cond, _dense(0.0 if x is None else x, val),
                                 _dense(0.0 if y is None else y, val)),
        ta, tb))


def sparse_jacfwd(f, z0):
    """(out0, D): the primal outputs of f(z0) and D[k][oi] = d out[oi] /
    d z0[k], None where structurally zero (the counterpart of
    `sparse_fwd.sparse_jacfwd`). f maps a list of SDuals to a list of
    outputs, each an SDual or a passive value."""
    outs = f([SDual(z, {k: 1.0}) for k, z in enumerate(z0)])
    D = [[None] * len(outs) for _ in z0]
    out0 = []
    for oi, o in enumerate(outs):
        v, t = _parts(o)
        out0.append(v)
        for k, tk in t.items():
            D[k][oi] = tk
    return out0, D
