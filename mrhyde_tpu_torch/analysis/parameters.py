"""Parameters: the deck's `Parameters` sublist.

The port of the JAX package's `mrhyde_tpu/analysis/parameters.py`
(reference src/managers/parameterManager.cpp:154-204 setupParameters).
Each entry is a scalar or a vector parameter of usage inactive, active,
stochastic, discrete or discretized; its values come from `value`
(`initial_value`) or, for a vector, from a text file named by `source`.
A forward run reads every scalar and vector through `all_values()` as
expression leaves; discretized (field) parameters get their own DOF map
in the Problem (the assembler's field-parameter registry); the analyses
read `pvec`, `flatten`, `unflatten` and `bounds`.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["ParameterManager", "ParamSpec"]


@dataclass
class ParamSpec:
    name: str
    usage: str     # inactive | active | stochastic | discrete | discretized
    value: object              # float, or a numpy array (a vector)
    distribution: str = "uniform"
    mean: float = 0.0
    variance: float = 1.0
    min: float = 0.0
    max: float = 1.0
    basis: str = "HGRAD"       # discretized params: basis space
    order: int = 1             # discretized params: basis order
    dynamic: bool = False      # time-dependent (one field per step)


class ParameterManager:
    def __init__(self, cfg: dict | None):
        self.specs: dict[str, ParamSpec] = {}
        for name, sub in (cfg or {}).items():
            if not isinstance(sub, dict):
                self.specs[name] = ParamSpec(name, "inactive", float(sub))
                continue
            ptype = sub.get("type", "scalar")
            # discretized params name their basis through 'type' and
            # their start value through 'initial_value'
            val = sub.get("value", sub.get("initial_value", 0.0))
            if "source" in sub:
                # a vector's values from a text file (e.g. KL coefficients)
                val = np.loadtxt(str(sub["source"])).ravel().tolist()
            if ptype == "vector" and not isinstance(val, (list, tuple)):
                val = [val]
            value = (np.asarray(val, dtype=float)
                     if isinstance(val, (list, tuple)) else float(val))
            self.specs[name] = ParamSpec(
                name=name, usage=sub.get("usage", "inactive"), value=value,
                distribution=sub.get("distribution", "uniform"),
                mean=float(sub.get("mean", 0.0)),
                variance=float(sub.get("variance", 1.0)),
                min=float(sub.get("min", sub.get("lower_bound", 0.0))),
                max=float(sub.get("max", sub.get("upper_bound", 1.0))),
                basis=sub.get("basis",
                              ptype if ptype not in ("scalar", "vector")
                              else "HGRAD"),
                order=int(sub.get("order", 1)),
                dynamic=bool(sub.get("dynamic", False)))

    # -- views ----------------------------------------------------------

    def all_values(self, device="cpu", dtype=torch.float64) -> dict:
        """name -> value of every scalar and vector parameter (the
        expression leaves): a scalar as a Python float, a vector as a
        tensor on `device`. Discretized (field) parameters are left out."""
        return {n: s.value if np.ndim(s.value) == 0 else
                torch.as_tensor(s.value, dtype=dtype, device=device)
                for n, s in self.specs.items() if s.usage != "discretized"}

    def discretized_names(self) -> list[str]:
        return [n for n, s in self.specs.items()
                if s.usage == "discretized"]

    def active_names(self) -> list[str]:
        """Differentiable parameters: active scalars and vectors, and
        discretized fields."""
        return [n for n, s in self.specs.items()
                if s.usage in ("active", "discretized")]

    def stochastic_names(self) -> list[str]:
        return [n for n, s in self.specs.items() if s.usage == "stochastic"]

    def pvec(self, device="cpu", dtype=torch.float64) -> dict:
        """The active parameters as tensors (name -> 0-d or 1-d)."""
        return {n: torch.as_tensor(self.specs[n].value, dtype=dtype,
                                   device=device)
                for n in self.active_names()}

    def update(self, values: dict):
        for n, v in values.items():
            self.specs[n].value = v

    # -- flat vector interface (for optimizers) -------------------------

    def flatten(self, pvec: dict) -> torch.Tensor:
        parts = [torch.atleast_1d(torch.as_tensor(pvec[n])).reshape(-1)
                 for n in self.active_names()]
        return torch.cat(parts) if parts else torch.zeros(
            0, dtype=torch.float64)

    def unflatten(self, vec) -> dict:
        out = {}
        i = 0
        for n in self.active_names():
            v = np.atleast_1d(self.specs[n].value)
            k = v.size
            chunk = vec[i:i + k]
            if v.ndim > 1:
                # dynamic discretized fields: (n_steps, n_dof)
                out[n] = chunk.reshape(v.shape)
            else:
                out[n] = chunk if v.size > 1 else chunk[0]
            i += k
        return out

    def bounds(self):
        lo, hi = [], []
        for n in self.active_names():
            s = self.specs[n]
            k = np.atleast_1d(s.value).size
            lo += [s.min] * k
            hi += [s.max] * k
        return np.array(lo), np.array(hi)
