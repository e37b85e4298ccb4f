"""Verification error norms against manufactured ("True") solutions.

The scalar-basis (HGRAD, HVOL) part of the JAX package's
`mrhyde_tpu/postprocess/errors.py` (reference
PostprocessManager::computeError):

- 'var':           L2 volume norm of (u_h - true)
- 'grad(var)[d]':  combined L2 norm over the given gradient components
                   (the H1-seminorm of the error)
- 'var face':      L2-face norm accumulated over EVERY element side with
                   weight 0.5/facemeasure

A mesh of several element blocks reports each norm once per block, keyed
(kind, var) for block 0 and (f"{kind}@{b}", var) for block b (the
reference's per-block computeError; its gold files repeat the line per
block).

Vector-basis norms (div, curl, components) are not ported yet
(ROADMAP A11) and raise.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from mrhyde_tpu_torch.assembly.assembler import PointContext

__all__ = ["ErrorCalculator"]

_GRAD_RE = re.compile(r"^grad\((\w+)\)\[([xyz])\]$")
_VECTOR_RE = re.compile(r"^(curl\(\w+\)\[[xyz]\]|\w+\[[xyz]\]|"
                        r"div\(.*\)|curl\(.*\))$")
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
        self.face_exprs = {}
        for key, expr in (true_solutions or {}).items():
            key = key.strip()
            m = _GRAD_RE.match(key)
            if m:
                self.grad_exprs.setdefault(m.group(1), {})[
                    _AX[m.group(2)]] = expr
            elif _VECTOR_RE.match(key):
                raise NotImplementedError(
                    f"true solution {key!r}: vector-basis error norms are "
                    "not ported to mrhyde_tpu_torch yet (ROADMAP A11)")
            elif key.endswith(" face"):
                self.face_exprs[key[:-5].strip()] = expr
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

    def compute(self, u, time=0.0) -> dict:
        """{(kind, var): error} with kind in L2 / L2-grad / L2-face."""
        disc = self.disc
        out = {}
        u_e = u[torch.as_tensor(disc.lids, device=u.device)]  # (E, nd)
        wts = self._t(disc.wts)

        for var, expr in self.l2_exprs.items():
            if var not in disc.offsets:
                continue
            st, nd = disc.offsets[var]
            phi = self._t(disc.basis_vals[disc.basis_keys[var]])
            uh = u_e[:, st:st + nd] @ phi                     # (E, Q)
            tru = self._true(expr, disc.ip, time, uh.shape)
            self._emit(out, "L2", var, torch.sum(wts * (uh - tru) ** 2, dim=1))

        for var, comps in self.grad_exprs.items():
            if var not in disc.offsets:
                continue
            st, nd = disc.offsets[var]
            dphi = self._t(disc.basis_grads[disc.basis_keys[var]])
            duh = torch.einsum("ei,eiqd->eqd", u_e[:, st:st + nd], dphi)
            e2 = 0.0
            for ax, expr in comps.items():
                tru = self._true(expr, disc.ip, time, duh.shape[:2])
                e2 = e2 + torch.sum(wts * (duh[:, :, ax] - tru) ** 2, dim=1)
            self._emit(out, "L2-grad", var, e2)

        for var, expr in self.face_exprs.items():
            if var not in disc.offsets:
                continue
            st, nd = disc.offsets[var]
            e2 = 0.0
            for s in range(disc.topo.n_side):
                phi_f = self._t(disc.face_basis_vals[s][
                    disc.basis_keys[var]])                    # (nd, Qf)
                fg = disc.faces[s]
                uh = u_e[:, st:st + nd] @ phi_f               # (E, Qf)
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
                label = {
                    "L2": f"L2 norm of the error for {var}",
                    "L2-grad": f"L2 norm of the error for grad({var})",
                    "L2-face": f"L2-face norm of the error for {var}"}[kind]
                lines.append(f"***** {label} = {val:.6g}  (time = {time:g})")
        return "\n".join(lines)
