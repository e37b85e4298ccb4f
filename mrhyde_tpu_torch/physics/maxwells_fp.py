"""Frequency-domain Maxwell via potentials (real/imag split).

The port of the JAX package's `mrhyde_tpu/physics/maxwells_fp.py`
(reference maxwells_fp.cpp): variables Arx, Aix, phir, phii [, Ary, Aiy]
[, Arz, Aiz], the HGRAD components of the complex vector potential A and
scalar potential phi. The complex weak form is computed directly and
split:

  K_Ad(v)  = (1/mu)[(curl A) . curl(v e_d) + (div A) dv/dx_d]
             - w^2 eps A_d v - i w eps (dphi/dx_d v + phi dv/dx_d)
             - J_d v
  K_phi(q) = eps grad(phi) . grad(q) - w^2 eps^2 mu phi q
             - i w eps (div A q + A . grad q) - rho_c q

with the row mapping of the reference (shared real/imag basis):
  real row += Re(K) - Im(K),   imag row += Re(K) + Im(K).
'test: 2' in 3D supplies the reference's manufactured coefficient and
source tables (maxwells_fp.cpp:820-965) as deck functions. No fused
kernel: the general path.
"""

from __future__ import annotations

import torch

from mrhyde_tpu_torch.physics.base import PhysicsModule
from mrhyde_tpu_torch.physics.registry import register

__all__ = ["MaxwellsFP"]

# the 'test: 2' manufactured solution's coefficient and source functions,
# transcribed from the reference's hardcoded tables: complex permeability
# mu = (2+i)/(x^2+1), permittivity eps = (x^2+1)(1+i),
# A = (1,-1,2) sin(pi x) sin(pi y) sin(pi z), phi the same scalar shape
_TEST2_FNS = {
    "sx": "sin(pi*x)", "sy": "sin(pi*y)", "sz": "sin(pi*z)",
    "cx": "cos(pi*x)", "cy": "cos(pi*y)", "cz": "cos(pi*z)",
    "sss": "sx*sy*sz",
    "mur": "2.0/(x*x+1.0)", "mui": "1.0/(x*x+1.0)",
    "epsr": "x*x+1.0", "epsi": "x*x+1.0",
    "omega": "1.0",
    "Jxr": "(9*pi*pi*sss)/5 - 4*x*sss + (9*x*x*pi*pi*sss)/5 - "
           "(6*x*pi*cx*sy*sz)/5 + (6*x*pi*cy*sx*sz)/5 - "
           "(12*x*pi*cz*sx*sy)/5",
    "Jyr": "0.0-(3*pi*sz*(3*pi*sx*sy - 2*x*cx*sy - 2*x*cy*sx + "
           "3*x*x*pi*sx*sy))/5",
    "Jzr": "(6*pi*sy*(3*pi*sx*sz - 2*x*cx*sz + x*cz*sx + "
           "3*x*x*pi*sx*sz))/5",
    "Jxi": "(3*pi*pi*sss)/5 - 2*x*x*sss - 2*sss + "
           "(3*x*x*pi*pi*sss)/5 - (2*x*pi*cx*sy*sz)/5 + "
           "(2*x*pi*cy*sx*sz)/5 - (4*x*pi*cz*sx*sy)/5",
    "Jyi": "(3*sz*((10*sx*sy)/3 - pi*pi*sx*sy + (10*x*x*sx*sy)/3 - "
           "x*x*pi*pi*sx*sy + (2*x*pi*cx*sy)/3 + (2*x*pi*cy*sx)/3))/5",
    "Jzi": "0.0-(6*sy*((10*sx*sz)/3 - pi*pi*sx*sz + (10*x*x*sx*sz)/3 - "
           "x*x*pi*pi*sx*sz + (2*x*pi*cx*sz)/3 - (x*pi*cz*sx)/3))/5",
    "rhor": "2*sss*(3*x*x - 2*x + 3)",
    "rhoi": "0.0-2*sy*sz*(sx - 3*pi*pi*sx + x*x*sx - 3*x*x*pi*pi*sx + "
            "2*x*pi*cx)",
}


@register("maxwells_freq_pot")
class MaxwellsFP(PhysicsModule):
    name = "maxwells_fp"

    def variables(self):
        out = []
        for c in "xyz"[:self.dim]:
            out += [(f"Ar{c}", "HGRAD", 1), (f"Ai{c}", "HGRAD", 1)]
        return out + [("phir", "HGRAD", 1), ("phii", "HGRAD", 1)]

    def define_functions(self, fm, fs):
        if int(self.settings.get("test", 0) or 0) == 2 and self.dim == 3:
            fs = {**_TEST2_FNS, **fs}
            for helper in ("sx", "sy", "sz", "cx", "cy", "cz", "sss"):
                if helper in fs:
                    fm.add_function(helper, fs[helper], "ip")
        for n, d in (("mur", 1.0), ("mui", 0.0), ("epsr", 1.0),
                     ("epsi", 0.0), ("omega", 1.0), ("rhor", 0.0),
                     ("rhoi", 0.0)):
            fm.add_function(n, self._f(fs, n, d), "ip")
        for c in "xyz":
            for p in ("r", "i"):
                fm.add_function(f"J{c}{p}",
                                self._f(fs, f"J{c}{p}", 0.0), "ip")

    @staticmethod
    def _add_complex(wk, var_r, var_i, source_vals, flux_vals):
        """Accumulates Re - Im into the real row and Re + Im into the
        imaginary row of complex (source, flux) pairs."""
        for var, sgn in ((var_r, -1.0), (var_i, +1.0)):
            wk.add_source(var, source_vals.real + sgn * source_vals.imag)
            wk.add_flux(var, flux_vals.real + sgn * flux_vals.imag)

    def volume_residual(self, wk):
        dim = self.dim
        comps = "xyz"[:dim]

        def cplx(re, im):
            return torch.complex(wk.qp(re), wk.qp(im))
        mu = cplx(wk.f("mur"), wk.f("mui"))
        eps = cplx(wk.f("epsr"), wk.f("epsi"))
        w = wk.qp(wk.f("omega"))
        rho_c = cplx(wk.f("rhor"), wk.f("rhoi"))
        A = [torch.complex(wk.sol(f"Ar{c}"), wk.sol(f"Ai{c}"))
             for c in comps]
        gA = [torch.complex(wk.grad(f"Ar{c}"), wk.grad(f"Ai{c}"))
              for c in comps]
        phi = torch.complex(wk.sol("phir"), wk.sol("phii"))
        gphi = torch.complex(wk.grad("phir"), wk.grad("phii"))
        divA = sum(gA[d][:, d] for d in range(dim))
        J = [cplx(wk.f(f"J{c}r"), wk.f(f"J{c}i")) for c in comps]
        zero = torch.zeros_like(divA)
        if dim == 3:
            curlA = [gA[2][:, 1] - gA[1][:, 2], gA[0][:, 2] - gA[2][:, 0],
                     gA[1][:, 0] - gA[0][:, 1]]
        elif dim == 2:
            cz = gA[1][:, 0] - gA[0][:, 1]      # the scalar z-curl
        invmu = 1.0 / mu
        iweps = 1j * w * eps
        for d, c in enumerate(comps):
            # the weak partner of grad(v e_d): curl-curl, e.g. in 3D
            # curl(v e_x) = (0, dv/dz, -dv/dy), and in 2D curl(v e_x) =
            # -dv/dy e_z
            if dim == 3:
                cols = [[zero, -curlA[2], curlA[1]],
                        [curlA[2], zero, -curlA[0]],
                        [-curlA[1], curlA[0], zero]][d]
                cols = [invmu * k for k in cols]
            elif dim == 2:
                cols = [[zero, -invmu * cz], [invmu * cz, zero]][d]
            else:
                cols = [zero]
            # the gauge term (1/mu) div A dv/dx_d, and the phi coupling
            # -i w eps phi dv/dx_d (the reference's rows take Re - Im and
            # Re + Im of -i w eps P, maxwells_fp.cpp:310-316)
            cols[d] = cols[d] + invmu * divA
            cols[d] = cols[d] + (-iweps) * phi
            src = -w * w * eps * A[d] - iweps * gphi[:, d] - J[d]
            self._add_complex(wk, f"Ar{c}", f"Ai{c}", src,
                              torch.stack(cols, dim=1))
        # the scalar potential equation (Lorenz gauge)
        flux_phi = eps[:, None] * gphi - iweps[:, None] * torch.stack(A,
                                                                     dim=1)
        src_phi = -w * w * eps * eps * mu * phi - iweps * divA - rho_c
        self._add_complex(wk, "phir", "phii", src_phi, flux_phi)
