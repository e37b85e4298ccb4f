"""Workset: the per-element view physics modules read from and write to.

The HGRAD subset of the JAX package's Workset
(`mrhyde_tpu/assembly/workset.py`). One Workset is built per element
inside `torch.func.vmap`, so every tensor here carries no element axis;
residual accumulation is functional (no in-place writes), as vmap and
jacfwd require.

Field-name resolution matches the reference's labels: "e",
"grad(e)[x]", "e_t", "x", "y", "z", "t", plus parameter and
user-function names via the FunctionManager. The stabilisation scalars
the flow modules read are `h` (element size), `deltat` (the stage's
time step) and `is_transient` (the deck is transient).
"""

from __future__ import annotations

import torch

__all__ = ["Workset"]

_AXES = {"x": 0, "y": 1, "z": 2}


class Workset:
    def __init__(self, *, dim, wts, ip, basis_vals, basis_grads, offsets,
                 var_keys, u_eval, u_dot=None, time=0.0, fm=None,
                 params=None, deltat=1.0, is_transient=False, normals=None,
                 side_name=None, bcs=None, extra_fields=None):
        self.dim = dim
        self.wts = wts                      # (Q,)
        self.ip = ip                        # (Q, dim)
        self._bv = basis_vals               # key -> (ndof, Q)
        self._bg = basis_grads              # key -> (ndof, Q, dim)
        self.offsets = offsets              # var -> (start, ndof)
        self._var_keys = var_keys           # var -> basis key
        self.u = u_eval                     # (ndof_total,)
        self.u_dot = u_dot                  # (ndof_total,) or None
        self.time = time
        self.fm = fm
        self.params = params or {}
        self.deltat = deltat
        self.is_transient = is_transient
        self.normals = normals              # (Q, dim) on side worksets
        self.side_name = side_name
        self.bcs = bcs or {}                # var -> condition type
        # per-element fields from mesh data files (name -> this
        # element's value), resolvable as expression leaves
        self.extra_fields = extra_fields or {}
        self._res = {}                      # var -> (ndof,) contribution
        self._sol_cache = {}

    # ---- field access (used by physics + expression leaves) ----

    def basis(self, var):
        return self._bv[self._var_keys[var]]

    def basis_grad(self, var):
        return self._bg[self._var_keys[var]]

    def _dofs(self, vec, var):
        st, nd = self.offsets[var]
        return vec[st:st + nd]

    def sol(self, var):
        """Solution at quadrature points, (Q,)."""
        key = ("sol", var)
        if key not in self._sol_cache:
            self._sol_cache[key] = self._dofs(self.u, var) @ self.basis(var)
        return self._sol_cache[key]

    def sol_dot(self, var):
        key = ("dot", var)
        if key not in self._sol_cache:
            if self.u_dot is None:
                self._sol_cache[key] = torch.zeros_like(self.sol(var))
            else:
                self._sol_cache[key] = (self._dofs(self.u_dot, var)
                                        @ self.basis(var))
        return self._sol_cache[key]

    def grad(self, var):
        """Solution gradient at quadrature points, (Q, dim)."""
        key = ("grad", var)
        if key not in self._sol_cache:
            self._sol_cache[key] = torch.einsum(
                "i,iqd->qd", self._dofs(self.u, var), self.basis_grad(var))
        return self._sol_cache[key]

    def f(self, name, location="ip"):
        """Evaluate a FunctionManager expression at this workset."""
        return self.fm.evaluate(name, self, location)

    def resolve(self, leaf: str):
        """Leaf resolution for the expression DSL."""
        if leaf in _AXES and _AXES[leaf] < self.dim:
            return self.ip[:, _AXES[leaf]]
        if leaf == "t":
            return self.time
        if leaf in self.offsets:
            return self.sol(leaf)
        if leaf.startswith("grad(") and leaf.endswith("]") \
                and leaf[5:leaf.index(")")] in self.offsets:
            var = leaf[5:leaf.index(")")]
            return self.grad(var)[:, _AXES[leaf[-2]]]
        if leaf.endswith("_t") and leaf[:-2] in self.offsets:
            return self.sol_dot(leaf[:-2])
        if leaf.startswith("n[") and self.normals is not None:
            return self.normals[:, _AXES[leaf[2]]]
        if leaf in ("nx", "ny", "nz") and self.normals is not None:
            return self.normals[:, _AXES[leaf[1]]]
        if leaf in self.params:
            return self.params[leaf]
        if leaf in self.extra_fields:
            return self.extra_fields[leaf]
        raise KeyError(f"cannot resolve expression leaf {leaf!r}")

    def qp(self, v):
        """Broadcast a scalar-or-(Q,) value to quadrature-point shape."""
        if isinstance(v, torch.Tensor):
            return torch.broadcast_to(v.to(self.u.dtype), self.wts.shape)
        return torch.full(self.wts.shape, float(v), dtype=self.u.dtype,
                          device=self.wts.device)

    @property
    def h(self):
        """Element size h = volume^(1/dim) (reference workset.cpp:2666
        getElementSize); one scalar per element."""
        return torch.sum(self.wts) ** (1.0 / self.dim)

    @property
    def side_h(self):
        """Side size = measure^(1/(dim-1)) (reference workset.cpp
        getSideElementSize); side worksets only."""
        if self.dim == 1:
            return 1.0
        return torch.sum(self.wts) ** (1.0 / (self.dim - 1))

    # ---- residual accumulation (used by physics) ----

    def _accumulate(self, var, contrib):
        prev = self._res.get(var)
        self._res[var] = contrib if prev is None else prev + contrib

    def add(self, var, contrib):
        """res_i += contrib_i over the variable's local dofs."""
        self._accumulate(var, contrib)

    def add_source(self, var, svals):
        """res_i += sum_q svals(q) * phi_i(q) * w(q)   (i.e. (s, v))."""
        self._accumulate(var, self.basis(var) @ (self.qp(svals) * self.wts))

    def add_flux(self, var, fvals):
        """res_i += sum_q f(q,:) . grad(phi_i)(q,:) * w(q)  ((F, grad v))."""
        self._accumulate(var, torch.einsum(
            "iqd,qd->i", self.basis_grad(var), fvals * self.wts[:, None]))

    def set_res(self, res):
        """Replaces the accumulated residual by a (ndof_total,) vector in
        offset order."""
        self._res = {var: res[st:st + nd]
                     for var, (st, nd) in self.offsets.items()}

    @property
    def res(self):
        """(ndof_total,) element residual, variables in offset order."""
        parts = []
        for var, (st, nd) in sorted(self.offsets.items(),
                                    key=lambda kv: kv[1][0]):
            r = self._res.get(var)
            parts.append(torch.zeros_like(self.u[st:st + nd])
                         if r is None else r)
        return torch.cat(parts)
