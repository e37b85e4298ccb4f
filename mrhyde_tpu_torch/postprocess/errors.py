"""Verification error norms against manufactured ("True") solutions.

The port of the JAX package's `mrhyde_tpu/postprocess/errors.py`
(reference PostprocessManager::computeError):

- 'var':           L2 volume norm of (u_h - true) (none for an HFACE
                   trace, which has only its face norm)
- 'var[d]':        L2 norm of a vector variable, summed over the given
                   components
- 'grad(var)[d]':  combined L2 norm over the given gradient components
                   (the H1-seminorm of the error)
- 'div(var)':      L2 norm of the divergence of an HDIV variable
- 'curl(var)':     L2 norm of the 2D scalar curl of an HCURL variable;
  'curl(var)[d]':  in 3D summed over the given components
- 'var face':      L2-face norm accumulated over EVERY element side with
                   weight 0.5/facemeasure

The element coefficients are folded into each element's local frame
first (the orientation signs and mixing of HDIV / HCURL dofs).

A mesh of several element blocks reports each norm once per block, keyed
(kind, var) for block 0 and (f"{kind}@{b}", var) for block b (the
reference's per-block computeError; its gold files repeat the line per
block).
"""

from __future__ import annotations

import re

import numpy as np
import torch

from mrhyde_tpu_torch.assembly.assembler import PointContext

__all__ = ["ErrorCalculator"]

_GRAD_RE = re.compile(r"^grad\((\w+)\)\[([xyz])\]$")
_CURL_RE = re.compile(r"^curl\((\w+)\)\[([xyz])\]$")
_COMP_RE = re.compile(r"^(\w+)\[([xyz])\]$")
_AX = {"x": 0, "y": 1, "z": 2}


class ErrorCalculator:
    def __init__(self, disc, fm, true_solutions: dict, params=None,
                 device="cpu", dtype=torch.float64):
        self.disc = disc
        self.fm = fm
        self.params = params or {}
        self.device, self.dtype = device, dtype
        self.l2_exprs = {}
        self.grad_exprs = {}     # var -> {axis: expr}
        self.comp_exprs = {}     # vector var -> {axis: expr}
        self.face_exprs = {}
        self.div_exprs = {}
        self.curl_exprs = {}     # var -> {axis, or None (2D): expr}
        for key, expr in (true_solutions or {}).items():
            key = key.strip()
            m = _GRAD_RE.match(key)
            mcu = _CURL_RE.match(key)
            mc = _COMP_RE.match(key)
            if m:
                self.grad_exprs.setdefault(m.group(1), {})[
                    _AX[m.group(2)]] = expr
            elif mcu:
                # 3D HCURL: the true curl per component (reference
                # postprocessManager.cpp:424-447)
                self.curl_exprs.setdefault(mcu.group(1), {})[
                    _AX[mcu.group(2)]] = expr
            elif mc:
                self.comp_exprs.setdefault(mc.group(1), {})[
                    _AX[mc.group(2)]] = expr
            elif key.endswith(" face"):
                self.face_exprs[key[:-5].strip()] = expr
            elif key.startswith("div(") and key.endswith(")"):
                self.div_exprs[key[4:-1]] = expr
            elif key.startswith("curl(") and key.endswith(")"):
                self.curl_exprs.setdefault(key[5:-1], {})[None] = expr
            else:
                self.l2_exprs[key] = expr

    def _t(self, a):
        return torch.as_tensor(np.asarray(a), dtype=self.dtype,
                               device=self.device)

    def _true(self, expr, pts, time, shape):
        ctx = PointContext(self._t(pts), time, self.params)
        v = self.fm.evaluate_expr(expr, ctx)
        return torch.broadcast_to(
            torch.as_tensor(v, dtype=self.dtype, device=self.device), shape)

    def _emit(self, out, kind, var, e2_per_elem):
        """The norm of the error from its per-element squares: one entry,
        or one per element block of a multi-block mesh."""
        mesh = self.disc.mesh
        bids = getattr(mesh, "block_ids", None)
        if bids is None or len(getattr(mesh, "block_names", [])) <= 1:
            out[(kind, var)] = float(torch.sqrt(torch.sum(e2_per_elem)))
            return
        bids = torch.as_tensor(np.asarray(bids), device=e2_per_elem.device)
        for b in range(len(mesh.block_names)):
            mask = (bids == b).to(e2_per_elem.dtype)
            key = (kind, var) if b == 0 else (f"{kind}@{b}", var)
            out[key] = float(torch.sqrt(torch.sum(e2_per_elem * mask)))

    def _components(self, uh, comps, time, wts):
        """Per-element squares of a vector field's error (E, Q, dim)
        summed over the components the deck gives."""
        e2 = 0.0
        for ax, expr in comps.items():
            if ax is None:
                continue
            tru = self._true(expr, self.disc.ip, time, uh.shape[:2])
            e2 = e2 + torch.sum(wts * (uh[:, :, ax] - tru) ** 2, dim=1)
        return e2

    def _scalar(self, uh, expr, time, wts):
        """Per-element squares of a scalar field's error (E, Q)."""
        tru = self._true(expr, self.disc.ip, time, uh.shape)
        return torch.sum(wts * (uh - tru) ** 2, dim=1)

    def compute(self, u, time=0.0) -> dict:
        """{(kind, var): error} with kind in L2 / L2-grad / L2-div /
        L2-curl / L2-face."""
        disc = self.disc
        out = {}
        u_e = disc.dofmap.fold(
            u[torch.as_tensor(disc.lids, device=u.device)])   # (E, nd)
        wts = self._t(disc.wts)

        def coeffs(var):
            st, nd = disc.offsets[var]
            return u_e[:, st:st + nd]

        for var, comps in self.comp_exprs.items():
            if var not in disc.offsets:
                continue
            uh = torch.einsum("ei,eiqd->eqd", coeffs(var),
                              self._t(disc.vec_vals[disc.basis_keys[var]]))
            self._emit(out, "L2", var, self._components(uh, comps, time,
                                                        wts))

        for var, expr in self.l2_exprs.items():
            if var not in disc.offsets:
                continue
            key = disc.basis_keys[var]
            if key[0] == "HFACE":
                continue        # a trace has only its face norm
            if key not in disc.basis_vals and key in disc.vec_vals \
                    and disc.vec_vals[key].shape[-1] == 1:
                # 1D HDIV: a scalar-valued flux
                uh = torch.einsum("ei,eiq->eq", coeffs(var),
                                  self._t(disc.vec_vals[key][..., 0]))
            else:
                uh = coeffs(var) @ self._t(disc.basis_vals[key])  # (E, Q)
            self._emit(out, "L2", var, self._scalar(uh, expr, time, wts))

        for var, comps in self.grad_exprs.items():
            if var not in disc.offsets:
                continue
            duh = torch.einsum("ei,eiqd->eqd", coeffs(var), self._t(
                disc.basis_grads[disc.basis_keys[var]]))
            self._emit(out, "L2-grad", var, self._components(duh, comps,
                                                             time, wts))

        for var, expr in self.div_exprs.items():
            if var not in disc.offsets:
                continue
            uh = torch.einsum("ei,eiq->eq", coeffs(var),
                              self._t(disc.div_vals[disc.basis_keys[var]]))
            self._emit(out, "L2-div", var, self._scalar(uh, expr, time,
                                                        wts))

        for var, comps in self.curl_exprs.items():
            if var not in disc.offsets:
                continue
            cv = self._t(disc.curl_vals[disc.basis_keys[var]])
            if cv.dim() == 3:                   # 2D scalar curl
                uh = torch.einsum("ei,eiq->eq", coeffs(var), cv)
                expr = comps.get(None) or next(iter(comps.values()))
                e2 = self._scalar(uh, expr, time, wts)
            else:                               # 3D: per component
                uh = torch.einsum("ei,eiqd->eqd", coeffs(var), cv)
                e2 = self._components(uh, comps, time, wts)
            self._emit(out, "L2-curl", var, e2)

        for var, expr in self.face_exprs.items():
            if var not in disc.offsets:
                continue
            e2 = 0.0
            for s in range(disc.topo.n_side):
                phi_f = self._t(disc.face_basis_vals[s][
                    disc.basis_keys[var]])                    # (nd, Qf)
                fg = disc.faces[s]
                uh = coeffs(var) @ phi_f                      # (E, Qf)
                tru = self._true(expr, fg.ip, time, uh.shape)
                fw = self._t(fg.wts)                          # (E, Qf)
                fmeas = torch.sum(fw, dim=1, keepdim=True)
                e2 = e2 + torch.sum(0.5 / fmeas * (uh - tru) ** 2 * fw,
                                    dim=1)
            self._emit(out, "L2-face", var, e2)
        return out

    @staticmethod
    def format_report(history) -> str:
        """history: list of (time, {(kind, var): err}) — reference style."""
        lines = ["*********************************************************",
                 "***** Computing errors ******", ""]
        for time, errs in history:
            for (kind, var), val in errs.items():
                # per-block entries repeat the label
                kind = kind.split("@")[0]
                if kind.startswith("Subgrid-L2"):
                    idx = kind.split(":")[1] if ":" in kind else "0"
                    label = f"Subgrid {idx}: L2 norm of the error for {var}"
                else:
                    label = {
                        "L2": f"L2 norm of the error for {var}",
                        "L2-grad": f"L2 norm of the error for grad({var})",
                        "L2-div": f"L2 norm of the error for div({var})",
                        "L2-curl": f"L2 norm of the error for curl({var})",
                        "L2-face": f"L2-face norm of the error for {var}"
                    }[kind]
                lines.append(f"***** {label} = {val:.6g}  (time = {time:g})")
        return "\n".join(lines)
