"""Workset: the per-element view physics modules read from and write to.

The port of the JAX package's Workset (`mrhyde_tpu/assembly/workset.py`).
One Workset is built per element inside `torch.func.vmap`, so every
tensor here carries no element axis; residual accumulation is functional
(no in-place writes), as vmap and jacfwd require.

Field-name resolution matches the reference's labels: "e",
"grad(e)[x]", "e_t", "x", "y", "z", "t", the vector leaves "E[x]",
"div(u)", "curl(E)" and "curl(E)[x]", plus parameter and user-function
names via the FunctionManager. The stabilisation scalars the flow
modules read are `h` (element size), `deltat` (the stage's time step)
and `is_transient` (the deck is transient).

Vector bases (HDIV, HCURL and their broken and Arbogast-Correa forms)
read the oriented element tables `basis_vec` / `basis_div` /
`basis_curl`; hybridized and DG modules read the per-side tables of a
volume workset: the face weights and normals, the scalar and vector
traces of the element's own basis on each side (`face_sol`,
`face_sol_vec`) and the HFACE trace dofs of each side (`trace`).
"""

from __future__ import annotations

import torch

__all__ = ["Workset"]

_AXES = {"x": 0, "y": 1, "z": 2}
_VECTOR_SPACES = ("HDIV", "HCURL", "HDIV-DG", "HDIV_AC", "HDIV_AC-DG")


class Workset:
    def __init__(self, *, dim, wts, ip, basis_vals, basis_grads, offsets,
                 var_keys, u_eval, u_dot=None, time=0.0, fm=None,
                 params=None, deltat=1.0, is_transient=False, normals=None,
                 side_name=None, bcs=None, extra_fields=None,
                 basis_vecs=None, basis_divs=None, basis_curls=None,
                 face_wts=None, face_normals=None, face_vecs=None,
                 face_scals=None, hface_vals=None):
        self.dim = dim
        self._bvec = basis_vecs or {}       # key -> (ndof, Q, dim)
        self._bdiv = basis_divs or {}       # key -> (ndof, Q)
        self._bcurl = basis_curls or {}     # key -> (ndof, Q[, 3])
        self.face_wts = face_wts            # (n_sides, Qf)
        self.face_normals = face_normals    # (n_sides, Qf, dim)
        self._fvec = face_vecs or {}        # key -> (n_sides, nd, Qf, dim)
        self._fscal = face_scals or {}      # key -> (n_sides, nd, Qf)
        self._hface = hface_vals or {}      # key -> (npe, Qf) trace basis
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

    def basis_vec(self, var):
        return self._bvec[self._var_keys[var]]

    def basis_div(self, var):
        return self._bdiv[self._var_keys[var]]

    def basis_curl(self, var):
        return self._bcurl[self._var_keys[var]]

    def is_vector_var(self, var):
        return self._var_keys[var][0] in _VECTOR_SPACES

    def _dofs(self, vec, var):
        st, nd = self.offsets[var]
        return vec[st:st + nd]

    def _at_qps(self, vec, var):
        """A variable's field from the dof vector vec at the quadrature
        points: (Q,), or (Q, dim) for a vector basis."""
        if self.is_vector_var(var):
            return torch.einsum("i,iqd->qd", self._dofs(vec, var),
                                self.basis_vec(var))
        return self._dofs(vec, var) @ self.basis(var)

    def sol(self, var):
        """Solution at quadrature points: (Q,), or (Q, dim) for
        HDIV/HCURL variables."""
        key = ("sol", var)
        if key not in self._sol_cache:
            self._sol_cache[key] = self._at_qps(self.u, var)
        return self._sol_cache[key]

    def div(self, var):
        """Divergence of an HDIV variable, (Q,)."""
        key = ("div", var)
        if key not in self._sol_cache:
            self._sol_cache[key] = self._dofs(self.u, var) \
                @ self.basis_div(var)
        return self._sol_cache[key]

    def curl(self, var):
        """Curl of an HCURL variable: (Q,) in 2D, (Q, 3) in 3D."""
        key = ("curl", var)
        if key not in self._sol_cache:
            bc = self.basis_curl(var)
            sub = "i,iq->q" if bc.dim() == 2 else "i,iqd->qd"
            self._sol_cache[key] = torch.einsum(
                sub, self._dofs(self.u, var), bc)
        return self._sol_cache[key]

    def sol_dot(self, var):
        key = ("dot", var)
        if key not in self._sol_cache:
            if self.u_dot is None:
                self._sol_cache[key] = torch.zeros_like(self.sol(var))
            else:
                self._sol_cache[key] = self._at_qps(self.u_dot, var)
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
        if leaf.endswith("]") and "[" in leaf \
                and leaf[:leaf.index("[")] in self.offsets:
            return self.sol(leaf[:leaf.index("[")])[:, _AXES[leaf[-2]]]
        if leaf.startswith("div(") and leaf.endswith(")"):
            return self.div(leaf[4:-1])
        if leaf.startswith("curl(") and leaf.endswith(")"):
            return self.curl(leaf[5:-1])
        if leaf.startswith("curl(") and leaf.endswith("]"):
            return self.curl(leaf[5:leaf.index(")")])[:, _AXES[leaf[-2]]]
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

    def add_vec_source(self, var, fvals):
        """res_i += sum_q f(q,:) . phi_i(q,:) * w(q) for vector bases."""
        self._accumulate(var, torch.einsum(
            "iqd,qd->i", self.basis_vec(var), fvals * self.wts[:, None]))

    def add_div_source(self, var, svals):
        """res_i += sum_q s(q) * div(phi_i)(q) * w(q) (HDIV)."""
        self._accumulate(var, self.basis_div(var)
                         @ (self.qp(svals) * self.wts))

    def add_curl_source(self, var, cvals):
        """res_i += sum_q c(q[,:]) * curl(phi_i)(q[,:]) * w(q) (HCURL)."""
        bc = self.basis_curl(var)
        if bc.dim() == 2:
            self._accumulate(var, bc @ (self.qp(cvals) * self.wts))
        else:
            self._accumulate(var, torch.einsum(
                "iqd,qd->i", bc, cvals * self.wts[:, None]))

    # ---- per-side access (hybridized and DG modules) ----

    def n_sides(self):
        return self.face_wts.shape[0]

    def _trace_layout(self, var):
        """(first local dof, trace table (npe, Qf) or None, dofs per
        side) of an HFACE variable; order-0 facet constants have no
        table."""
        st, _nd = self.offsets[var]
        tbl = self._hface.get(self._var_keys[var])
        if tbl is None or tbl.shape[0] == 1:
            return st, None, 1 if tbl is None else tbl.shape[0]
        return st, tbl, tbl.shape[0]

    def trace(self, var, side):
        """HFACE trace on a local side: (Qf,) values, or one 0-d value
        for an order-0 facet constant."""
        st, tbl, npe = self._trace_layout(var)
        if tbl is None:
            return self.u[st + side * npe]
        return self.u[st + side * npe:st + (side + 1) * npe] @ tbl

    def face_sol(self, var, side):
        """Scalar (HGRAD/HGRAD-DG/HVOL) solution at side quadrature
        points, (Qf,): the broken-state trace DG/HDG face terms read."""
        tbl = self._fscal[self._var_keys[var]][side]      # (nd, Qf)
        return self._dofs(self.u, var) @ tbl

    def add_face_source(self, var, side, svals):
        """res_i += sum_q s(q) phi_i(q) w_f(q) on one side, for a scalar
        variable (the DG/HDG numerical-flux face term)."""
        tbl = self._fscal[self._var_keys[var]][side]
        self._accumulate(var, tbl @ (svals * self.face_wts[side]))

    def face_sol_vec(self, var, side):
        """HDIV(-DG) solution at side quadrature points, (Qf, dim)."""
        fv = self._fvec[self._var_keys[var]][side]        # (nd, Qf, dim)
        return torch.einsum("i,iqd->qd", self._dofs(self.u, var), fv)

    def add_face_vec_source(self, var, side, fvals):
        """res_i += sum_q f(q,:) . phi_i(q,:) w_f(q) on one side."""
        fv = self._fvec[self._var_keys[var]][side]
        self._accumulate(var, torch.einsum(
            "iqd,qd->i", fv, fvals * self.face_wts[side][:, None]))

    def add_trace_source(self, var, side, svals):
        """res[trace dofs of side] += sum_q s(q) psi_k(q) w_f(q)."""
        st, tbl, npe = self._trace_layout(var)
        if tbl is None:
            contrib = torch.sum(svals * self.face_wts[side]).reshape(1)
        else:
            contrib = tbl @ (svals * self.face_wts[side])
        lo = side * npe
        nd = self.offsets[var][1]
        self._accumulate(var, torch.cat([
            contrib.new_zeros(lo), contrib,
            contrib.new_zeros(nd - lo - contrib.shape[0])]))

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
