"""Crystal (cubic anisotropic) elasticity with per-grain rotations.

The port of the JAX package's `mrhyde_tpu/physics/crystal_elasticity.py`
(reference CrystalElasticity.cpp): the cubic stiffness tensor from (C11,
C12, C44), by default from E = 1, nu = 0.4, rotated per grain, C'_ijkl =
R_ia R_jb R_kc R_ld C_abcd. The rotated tensor of each element arrives
as the workset's extra field "crystal_C" (a mesh data file with 'have
mesh data rotations', problem.py); without it the unrotated tensor
applies. The boundary terms are linear elasticity's.
"""

from __future__ import annotations

import numpy as np
import torch

from mrhyde_tpu_torch.physics.linearelasticity import (LinearElasticity,
                                                       _strain)
from mrhyde_tpu_torch.physics.registry import register

__all__ = ["CrystalElasticity", "cubic_stiffness", "rotate_stiffness"]


def cubic_stiffness(c11, c12, c44, dim=3) -> np.ndarray:
    """C_ijkl in the reference's fill order (CrystalElasticity.cpp:88-147),
    its asymmetry included: the c55 block writes (0,2,0,0) instead of
    (0,2,2,0), and the c15 block later overwrites (0,2,0,0), so C(0,2,2,0)
    = 0 while its other minor-symmetric partners carry c55. The
    reference's golds need the quirk."""
    c13 = c23 = c12
    c22 = c33 = c11
    c55 = c66 = c44
    c15 = c25 = c35 = c46 = 0.0
    C = np.zeros((3, 3, 3, 3))
    C[0, 0, 0, 0] = c11
    C[1, 1, 1, 1] = c22
    C[2, 2, 2, 2] = c33
    C[0, 0, 1, 1] = C[1, 1, 0, 0] = c12
    C[0, 0, 2, 2] = C[2, 2, 0, 0] = c13
    C[1, 1, 2, 2] = C[2, 2, 1, 1] = c23
    C[0, 1, 0, 1] = C[1, 0, 1, 0] = c66
    C[0, 1, 1, 0] = C[1, 0, 0, 1] = c66
    C[2, 0, 2, 0] = C[0, 2, 0, 2] = c55
    C[2, 0, 0, 2] = c55
    C[0, 2, 0, 0] = c55          # the reference's, not (0,2,2,0)
    C[2, 1, 2, 1] = C[1, 2, 1, 2] = c44
    C[1, 2, 2, 1] = C[2, 1, 1, 2] = c44
    C[0, 0, 0, 2] = C[0, 0, 2, 0] = c15
    C[0, 2, 0, 0] = C[2, 0, 0, 0] = c15   # overwrites the c55 write
    C[1, 1, 0, 2] = C[1, 1, 2, 0] = c25
    C[0, 2, 1, 1] = C[2, 0, 1, 1] = c25
    C[2, 2, 0, 2] = C[2, 2, 2, 0] = c35
    C[0, 2, 2, 2] = C[2, 0, 2, 2] = c35
    C[1, 2, 0, 1] = C[1, 2, 1, 0] = c46
    C[2, 1, 0, 1] = C[2, 1, 1, 0] = c46
    C[0, 1, 1, 2] = C[1, 0, 1, 2] = c46
    C[0, 1, 2, 1] = C[1, 0, 2, 1] = c46
    return C[:dim, :dim, :dim, :dim]


def rotate_stiffness(C: np.ndarray, R: np.ndarray) -> np.ndarray:
    """C'_ijkl = R_ia R_jb R_kc R_ld C_abcd."""
    return np.einsum("ia,jb,kc,ld,abcd->ijkl", R, R, R, R, C)


@register("crystal elasticity")
class CrystalElasticity(LinearElasticity):
    name = "crystalelasticity"

    def __init__(self, settings=None, dim: int = 2):
        super().__init__(settings, dim)
        # the reference's defaults (CrystalElasticity.cpp:22-50): E = 1,
        # nu = 0.4 give lambda and mu, C11 = 2 mu + lambda, C12 = lambda,
        # C44 = 2 mu; the 'Crystal elastic parameters' sublist overrides
        s = dict(self.settings.get("Crystal elastic parameters", {})
                 or {})
        E = float(s.get("E", 1.0))
        nu = float(s.get("nu", 0.4))
        lam = (E * nu) / ((1.0 + nu) * (1.0 - 2.0 * nu))
        mu = E / (2.0 * (1.0 + nu))
        self.c11 = float(s.get("C11", 2.0 * mu + lam))
        self.c12 = float(s.get("C12", lam))
        self.c44 = float(s.get("C44", 2.0 * mu))
        self.C_ref = cubic_stiffness(self.c11, self.c12, self.c44, dim)

    def _stress(self, wk, loc="ip"):
        dim = self.dim
        eps = _strain(wk, dim)
        Cq = wk.extra_fields.get("crystal_C")
        C = (Cq.reshape((dim,) * 4) if Cq is not None
             else torch.as_tensor(self.C_ref, dtype=eps.dtype,
                                  device=eps.device))
        return torch.einsum("ijkl,qkl->qij", C, eps)
