"""Peaceman wells for the porous-media modules.

The port of the JAX package's `mrhyde_tpu/physics/wells.py` (reference
wells.hpp): the wells of the physics settings' 'Wells' sublist (name ->
type, or a sublist with type, location, radius, bottom hole pressure,
rate), each adding a source near its location: q = WI (p_bh - p) for a
production or injection well, with the Peaceman index WI = 2 pi k / (mu
ln(r_e / r_w)), r_e = 0.2 h; the rate itself for any other type. Each
well acts through a Gaussian of width h/2 about its location,
normalized over the element.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["Wells"]

_BHP = ("production", "injection")


class Wells:
    def __init__(self, phys_settings: dict | None):
        self.wells = []
        for name, sub in ((phys_settings or {}).get("Wells", {})
                          or {}).items():
            if isinstance(sub, str):
                sub = {"type": sub}
            self.wells.append({
                "name": name,
                "type": sub.get("type", "production"),
                "location": np.asarray(sub.get("location", [0.5, 0.5]),
                                       dtype=float),
                "radius": float(sub.get("radius", 0.05)),
                "bottom hole pressure": float(
                    sub.get("bottom hole pressure", 1.0)),
                "rate": float(sub.get("rate", 0.0)),
            })

    def __bool__(self):
        return bool(self.wells)

    def add_sources(self, svals, wk, pvar="p", perm=1.0, visc=1.0):
        """svals (Q,) plus every well's source at the quadrature points.
        A rate well reads no pressure (inc sat has none)."""
        if not self.wells:
            return svals
        p = wk.sol(pvar) if any(w["type"] in _BHP
                                for w in self.wells) else None
        h = wk.h
        for w in self.wells:
            loc = torch.as_tensor(w["location"][:wk.dim], dtype=wk.ip.dtype,
                                  device=wk.ip.device)
            d2 = ((wk.ip - loc[None, :]) ** 2).sum(dim=1)
            near = torch.exp(-d2 / (2.0 * (0.5 * h) ** 2))
            norm = near / (torch.sum(near * wk.wts) + 1e-300)
            ratio = 0.2 * h / w["radius"]
            WI = 2.0 * math.pi * perm / (visc * torch.log(torch.maximum(
                ratio, torch.full_like(ratio, 1.0 + 1e-6))))
            if w["type"] in _BHP:
                q = WI * (w["bottom hole pressure"] - p)
            else:
                q = torch.full_like(wk.wts, w["rate"])
            svals = svals + q * norm * torch.sum(wk.wts)
        return svals
