"""Shared decks and helpers for the PyTorch port's parity tests
(tests/test_torch_*.py): one config dict goes through the JAX package
and through mrhyde_tpu_torch, inputs made from a seed with numpy."""

import numpy as np
import torch

S_TRUE = "sin(2*pi*x)*sin(2*pi*y)"
SOURCE = "8*(pi*pi)*sin(2*pi*x)*sin(2*pi*y)"
# the source of kappa = 1 + e^2 for the same true solution
SOURCE_NL = (f"8*(pi*pi)*{S_TRUE}*(1+({S_TRUE})^2) - 8*(pi*pi)*{S_TRUE}*"
             "((cos(2*pi*x)*sin(2*pi*y))^2+(sin(2*pi*x)*cos(2*pi*y))^2)")
# constant (every Jacobian row a scalar), coordinate-dependent (affine,
# 16 varying rows from the coord part), state-dependent (not affine)
KAPPAS = ("1.0", "1.0 + 0.5*x*y", "1.0 + e*e")
# (density, specific heat): the mass coefficient rho cp constant, and
# coordinate-dependent (16 varying coord Jacobian rows in a stage)
MASSES = (("1.0", "1.0"), ("2.0", "1.0 + 0.5*x"))
# the reference's 2D transient thermal deck: u = sin(2 pi t) S_TRUE
T_TRUE = f"sin(2*pi*t)*{S_TRUE}"
SOURCE_T = ("(8*(pi*pi)*sin(2*pi*t)+2*pi*cos(2*pi*t))"
            "*sin(2*pi*x)*sin(2*pi*y)")
# DIRK-2,2 stage 1 at dt = 0.05: alpha_u = A11/b1, alpha_t = 1/(dt b1)
DIRK22_STAGE1 = (0.5, 40.0)


def thermal_cfg(nx, ny=None, kappa="1.0", source=SOURCE, solver=None):
    return {
        "Mesh": {"dimension": 2, "element type": "quad", "NX": nx,
                 "NY": nx if ny is None else ny},
        "Functions": {"thermal source": source, "thermal diffusion": kappa},
        "Physics": {"modules": "thermal",
                    "Dirichlet conditions": {"e": {"all boundaries": 0.0}}},
        "Discretization": {"order": {"e": 1}, "quadrature": 2},
        "Solver": dict({"solver": "steady-state"}, **(solver or {})),
        "Postprocess": {"compute errors": True,
                        "True solutions": {"e": S_TRUE}},
    }


def transient_cfg(nx, ny=None, kappa="1.0", mass=("1.0", "1.0"),
                  source=SOURCE_T, ic="0.0", solver=None):
    """The transient deck: thermal_cfg with a density, a specific heat,
    an initial condition and a transient Solver sublist (BWE, 4 steps
    to t=0.2 unless `solver` says otherwise)."""
    cfg = thermal_cfg(nx, ny, kappa=kappa, source=source)
    cfg["Functions"].update({"density": mass[0], "specific heat": mass[1]})
    cfg["Physics"]["Initial conditions"] = {"e": ic}
    cfg["Solver"] = dict({"solver": "transient", "final time": 0.2,
                          "number of steps": 4}, **(solver or {}))
    cfg["Postprocess"]["True solutions"] = {"e": T_TRUE}
    return cfg


def stage_coeffs(pj, pt, alpha_u, alpha_t, seed, time=0.3, deltat=0.05):
    """(JAX, torch) TimeCoeffs of one stage with seeded beta_u, beta_t."""
    import jax.numpy as jnp
    from mrhyde_tpu.assembly.assembler import TimeCoeffs as JaxTC
    from mrhyde_tpu_torch.interop import time_coeffs_from_numpy
    bu = seeded(pj.n_dof, seed=seed)
    bt = seeded(pj.n_dof, seed=seed + 1, scale=5.0)
    tj = JaxTC(jnp.asarray(alpha_u), jnp.asarray(bu), jnp.asarray(alpha_t),
               jnp.asarray(bt), jnp.asarray(time), jnp.asarray(deltat))
    return tj, time_coeffs_from_numpy(alpha_u, bu, alpha_t, bt, time,
                                      deltat, pt)


def both_problems(cfg):
    """(JAX Problem, torch Problem on the CPU in f64) of one config."""
    from mrhyde_tpu.problem import Problem as JaxProblem
    from mrhyde_tpu_torch.problem import Problem as TorchProblem
    return (JaxProblem(cfg),
            TorchProblem(cfg, device="cpu", dtype=torch.float64))


def steady_coeffs(pj, pt):
    """Steady TimeCoeffs of both packages."""
    import jax.numpy as jnp
    from mrhyde_tpu.assembly.assembler import TimeCoeffs as JaxTC
    from mrhyde_tpu_torch.assembly.assembler import TimeCoeffs as TorchTC
    return (JaxTC.steady(pj.n_dof, dtype=jnp.float64),
            TorchTC.steady(pt.n_dof, dtype=torch.float64))


def seeded(n, seed=0, scale=0.3):
    return np.random.RandomState(seed).randn(n) * scale


def max_diff(a, b):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


# Navier-Stokes / Stokes: the reference's channel [0,5]x[0,1] driven by
# source ux = 1, Poiseuille ux = 0.5 y (1-y) (navierstokes/channel), and
# its 4x4 Stokes PSPG deck on the unit square (stokes/2D_verification_pspg)
FLOW_TRUE = {"ux": "0.5*y*(1.0-y)", "uy": "0.0", "pr": "0.0"}
# DIRK-2,2 stage 1 at dt = 0.01
NS_STAGE1 = (0.5, 200.0)


def channel_cfg(nx, ny, module="navier stokes", supg=False, visc=None,
                solver=None, box=(5.0, 1.0)):
    """The channel deck (PSPG; SUPG optional), at rest initially, with
    the given Solver keys (steady-state unless they say otherwise)."""
    cfg = {
        "Mesh": {"dimension": 2, "element type": "quad", "xmin": 0.0,
                 "xmax": box[0], "ymin": 0.0, "ymax": box[1], "NX": nx,
                 "NY": ny},
        "Physics": {"modules": module, "usePSPG": True, "useSUPG": supg,
                    "Dirichlet conditions": {
                        "scalar data": True,
                        "ux": {"bottom": 0.0, "top": 0.0},
                        "uy": {"bottom": 0.0, "top": 0.0}},
                    "Initial conditions": {"scalar data": True, "ux": 0.0,
                                           "uy": 0.0, "pr": 0.0}},
        "Discretization": {"order": {"ux": 1, "uy": 1, "pr": 1},
                           "quadrature": 2},
        "Solver": dict({"solver": "steady-state"}, **(solver or {})),
        "Postprocess": {"compute errors": True,
                        "True solutions": dict(FLOW_TRUE)},
        "Functions": {"source ux": "1.0"},
    }
    if visc is not None:
        cfg["Functions"]["viscosity"] = visc
    return cfg


def startup_cfg(nx, ny):
    """The channel started from rest: PSPG+SUPG, DIRK-2,2, 4 steps of
    0.01, nonlinear TOL 1e-8, the default linear solver."""
    return channel_cfg(nx, ny, supg=True, solver={
        "solver": "transient", "transient Butcher tableau": "DIRK-2,2",
        "final time": 0.04, "number of steps": 4, "nonlinear TOL": 1e-8})


def ns_elem_cfg(mesh, n, supg=False, visc=None, solver=None):
    """The channel deck on hex p1 (n = (nx, ny, nz) on [0,5]x[0,1]x[0,1],
    uz = 0 on the no-slip walls too) or on p2 quads (n = (nx, ny),
    quadrature 4): the decks of the element-tile kernel B1 for
    Navier-Stokes."""
    cfg = channel_cfg(n[0], n[1], supg=supg, visc=visc, solver=solver)
    if mesh == "hex":
        cfg["Mesh"].update({"dimension": 3, "element type": "hex",
                            "zmin": 0.0, "zmax": 1.0, "NZ": n[2]})
        cfg["Physics"]["Dirichlet conditions"]["uz"] = {"bottom": 0.0,
                                                        "top": 0.0}
        cfg["Physics"]["Initial conditions"]["uz"] = 0.0
        cfg["Discretization"]["order"]["uz"] = 1
        cfg["Postprocess"]["True solutions"]["uz"] = "0.0"
    else:
        cfg["Discretization"] = {"order": {"ux": 2, "uy": 2, "pr": 2},
                                 "quadrature": 4}
    return cfg


def ns_thermal_cfg(advect=False, supg=False, transient=False, beta=2.5,
                   t_amb=0.25, src="-1.0 + 0.5*x", kappa="1.0 + 0.1*e*e"):
    """NS + thermal on the 4 x 4 unit square (the JAX package's Boussinesq
    test deck, tests/test_flow.py:63-98, at 4 x 4, with beta = 1,
    T_ambient = 0, source uy -1 and thermal diffusion 1): by default beta
    2.5, T_ambient 0.25, source uy -1 + 0.5 x, thermal diffusion 1 + 0.1
    e^2; thermal advected by (ux, uy) when asked."""
    cfg = channel_cfg(4, 4, supg=supg, box=(1.0, 1.0))
    cfg["Physics"].update({"modules": "navier stokes,thermal", "beta": beta,
                           "T_ambient": t_amb, "include advection": advect})
    cfg["Physics"]["Dirichlet conditions"]["e"] = {"left": 1.0,
                                                   "right": 0.0}
    cfg["Discretization"]["order"]["e"] = 1
    cfg["Functions"].update({"source uy": src, "source ux": "0.0",
                             "thermal diffusion": kappa})
    if advect:
        cfg["Functions"].update({"advection x": "ux", "advection y": "uy"})
    if transient:
        cfg["Solver"] = {"solver": "transient", "final time": 0.04,
                         "number of steps": 4}
        cfg["Physics"]["Initial conditions"]["e"] = 0.0
    cfg["Postprocess"]["True solutions"]["e"] = "0.0"
    return cfg


def ns_cdr_cfg():
    """NS + cdr on the 4 x 4 channel, PSPG+SUPG, transient: cdr advected
    by (ux, uy), diffusion 0.01, reaction 0.5 c^2; source ux 1 + 0.1
    c^2."""
    cfg = channel_cfg(4, 4, supg=True, solver={
        "solver": "transient", "final time": 0.04, "number of steps": 4})
    cfg["Physics"]["modules"] = "navier stokes,cdr"
    cfg["Physics"]["Dirichlet conditions"]["c"] = {"left": 1.0}
    cfg["Physics"]["Initial conditions"]["c"] = 0.0
    cfg["Discretization"]["order"]["c"] = 1
    cfg["Functions"].update({"source ux": "1.0 + 0.1*c^2", "xvel": "ux",
                             "yvel": "uy", "diffusion": "0.01",
                             "reaction": "0.5*c*c"})
    cfg["Postprocess"]["True solutions"]["c"] = "0.0"
    return cfg


# 3D hex and 2D p2 thermal (the element-tile kernel B1): the reference's
# thermal/3D_verification, u = sin(2 pi x) sin(2 pi y) sin(2 pi z) on the
# unit cube; p2 quads with the 2D source at order 2, quadrature 4
S3_TRUE = "sin(2*pi*x)*sin(2*pi*y)*sin(2*pi*z)"
SOURCE3 = f"12*(pi*pi)*{S3_TRUE}"
# grad S3 squared, for the source of kappa = 1 + e^2
GRAD3_SQ = ("(cos(2*pi*x)*sin(2*pi*y)*sin(2*pi*z))^2"
            "+(sin(2*pi*x)*cos(2*pi*y)*sin(2*pi*z))^2"
            "+(sin(2*pi*x)*sin(2*pi*y)*cos(2*pi*z))^2")
SOURCE3_NL = (f"12*(pi*pi)*{S3_TRUE}*(1+({S3_TRUE})^2) - 8*(pi*pi)*"
              f"{S3_TRUE}*({GRAD3_SQ})")
# constant, coordinate-dependent (affine split, varying coord rows) and
# state-dependent (mode "full") conductivities in 3D
KAPPAS3 = ("1.0", "1.0 + 0.5*x*y*z", "1.0 + e*e")


def hex_cfg(nx, ny, nz, kappa="1.0", source=SOURCE3, solver=None):
    """thermal/3D_verification on an nx x ny x nz hex mesh."""
    cfg = thermal_cfg(nx, ny, kappa=kappa, source=source, solver=solver)
    cfg["Mesh"].update({"dimension": 3, "element type": "hex", "NZ": nz})
    cfg["Postprocess"]["True solutions"] = {"e": S3_TRUE}
    return cfg


def p2_cfg(nx, ny=None, kappa="1.0", source=SOURCE, solver=None):
    """The 2D deck with p2 variables, quadrature 4."""
    cfg = thermal_cfg(nx, ny, kappa=kappa, source=source, solver=solver)
    cfg["Discretization"] = {"order": {"e": 2}, "quadrature": 4}
    return cfg


def as_transient(cfg, mass=("1.0", "1.0")):
    """A steady deck made transient (density, specific heat, IC 0)."""
    cfg["Functions"].update({"density": mass[0], "specific heat": mass[1]})
    cfg["Physics"]["Initial conditions"] = {"e": "0.0"}
    cfg["Solver"] = {"solver": "transient", "final time": 0.2,
                     "number of steps": 4}
    return cfg


def _kind(row):
    if row is None:
        return "none"
    return "array" if np.ndim(row) >= 1 else "scalar"


STATS_KEYS = ("steady", "split", "n_res_rows", "n_jac_rows",
              "coord_res_rows", "coord_jac_rows", "node_scatter")


def check_fused_against_jax(pj, pt, tj, tt, u, tol):
    """The port's fused provider (through Assembler.res_and_jac) against
    the JAX package's FusedP1Assembly.res_jac in Pallas interpret mode at
    state u: residual, each Jacobian row's kind and value, `stats`, and
    BlockJacobian apply/diag against JAX's."""
    import jax.numpy as jnp
    from mrhyde_tpu.assembly.assembler import BlockJacobian as JaxBJ
    from mrhyde_tpu.ops.fused_p1 import FusedP1Assembly as JaxFused
    from mrhyde_tpu_torch.interop import state_from_numpy
    fk = JaxFused.build(pj.assembler)
    r_j, rows_j = fk.res_jac(jnp.asarray(u), tj, None, interpret=True)
    asm = pt.assembler
    r_t, J = asm.res_and_jac(state_from_numpy(u, pt), tt)
    ft = asm.fused_provider()
    assert ft is not None and J.vol is None
    assert max_diff(r_t, r_j) < tol
    assert len(J.vol_soa) == len(rows_j)
    for k, (rj, rt) in enumerate(zip(rows_j, J.vol_soa)):
        assert _kind(rt) == _kind(rj), f"row {k}"
        if rj is not None:
            assert max_diff(rt, rj) < tol, f"row {k}"
    for key in STATS_KEYS:
        assert ft.stats.get(key) == fk.stats.get(key), key
    Jj = JaxBJ(vol=None, vol_lids=pj.assembler.lids, bnd=[], bnd_lids=[],
               fixed=pj.assembler.fixed, inc=pj.assembler.inc,
               vol_soa=rows_j)
    v = seeded(pt.n_dof, seed=23, scale=1.0)
    assert max_diff(J.apply(state_from_numpy(v, pt)),
                    Jj.apply(jnp.asarray(v))) < tol
    assert max_diff(J.diag(), Jj.diag()) < tol
    return ft


def check_fused_against_general(pt, tt, u, tol):
    """Assembler.res_and_jac through the fused provider against the
    port's general path: residual, aos(), apply and diag."""
    import torch
    asm = pt.assembler
    r, J = asm.res_and_jac(u, tt)
    assert asm.fused_provider() is not None
    assert J.vol is None and J.vol_soa is not None
    Jg = asm.jacobian(u, tt)
    assert max_diff(r, asm.residual(u, tt)) < tol
    assert max_diff(J.aos(), Jg.vol) < tol
    v = torch.as_tensor(seeded(pt.n_dof, seed=23, scale=1.0))
    assert max_diff(J.apply(v), Jg.apply(v)) < tol
    assert max_diff(J.diag(), Jg.diag()) < tol


# convection-diffusion-reaction (cdr) and thermal with advection: u = S
# (2D) or S3 (hex) with b . grad u in the source; a constant velocity and
# the rotating field about the square's centre (x-dependent rows, a
# nonsymmetric Jacobian either way)
SX = "2*pi*cos(2*pi*x)*sin(2*pi*y)"
SY = "2*pi*sin(2*pi*x)*cos(2*pi*y)"
CDR_SOURCE = f"8*(pi*pi)*{S_TRUE} + 2.0*{SX} + 1.0*{SY}"
VELOCITIES = {"const": ("2.0", "1.0", "0.5"),
              "rot": ("-4.0*(y-0.5)", "4.0*(x-0.5)", "0.5 + 0.25*z")}
# the reference's cdr/2D_manufactured gold deck's reaction (nonlinear) and
# the default constant reaction 1.0 (affine split)
REACTIONS = ("1.0", "0.5*c*c")


def cdr_cfg(nx, ny=None, nz=None, vel="const", reaction="1.0",
            source=CDR_SOURCE, order=1, density="2.0", transient=False,
            solver=None):
    """A cdr deck on nx x ny p1 (order 1) or p2 (order 2, quadrature 4)
    quads, or an nx x ny x nz hex mesh; Dirichlet 0; density 2 (kappa =
    diffusion / (rho cp) = 0.5, and the c_t lane carries no rho cp
    weight); transient: IC 0, BWE, 4 steps to t = 0.2."""
    dim = 2 if nz is None else 3
    fs = {"source": source, "reaction": reaction, "density": density}
    fs.update(zip(("xvel", "yvel", "zvel"), VELOCITIES[vel][:dim]))
    cfg = {
        "Mesh": {"dimension": dim, "element type": "quad" if dim == 2
                 else "hex", "NX": nx, "NY": nx if ny is None else ny},
        "Functions": fs,
        "Physics": {"modules": "cdr",
                    "Dirichlet conditions": {"c": {"all boundaries": 0.0}}},
        "Discretization": {"order": {"c": order},
                           "quadrature": 4 if order == 2 else 2},
        "Solver": dict({"solver": "steady-state"}, **(solver or {})),
        "Postprocess": {"compute errors": True,
                        "True solutions": {"c": S_TRUE if dim == 2
                                           else S3_TRUE}},
    }
    if dim == 3:
        cfg["Mesh"]["NZ"] = nz
    if transient:
        cfg["Physics"]["Initial conditions"] = {"c": "0.0"}
        cfg["Solver"] = dict({"solver": "transient", "final time": 0.2,
                              "number of steps": 4}, **(solver or {}))
    return cfg


def advection_cfg(nx, ny=None, nz=None, vel="const", order=1,
                  transient=False):
    """Thermal with 'include advection' (advection x|y|z = the velocity),
    kappa = 1 + 0.5 x, density 2; as cdr_cfg otherwise."""
    dim = 2 if nz is None else 3
    cfg = thermal_cfg(nx, ny, kappa="1.0 + 0.5*x", source=CDR_SOURCE)
    if dim == 3:
        cfg["Mesh"].update({"dimension": 3, "element type": "hex", "NZ": nz})
        cfg["Postprocess"]["True solutions"] = {"e": S3_TRUE}
    if order == 2:
        cfg["Discretization"] = {"order": {"e": 2}, "quadrature": 4}
    cfg["Physics"]["include advection"] = True
    cfg["Functions"].update(zip(("advection x", "advection y",
                                 "advection z"), VELOCITIES[vel][:dim]))
    cfg["Functions"]["density"] = "2.0"
    if transient:
        cfg["Physics"]["Initial conditions"] = {"e": "0.0"}
        cfg["Solver"] = {"solver": "transient", "final time": 0.2,
                         "number of steps": 4}
    return cfg


def thermal_cdr_cfg(kappa, reaction="0.5*c*c", transient=False):
    """thermal + cdr on 4 x 4 p1 quads: cdr advected by (2, 1)."""
    cfg = thermal_cfg(4, kappa=kappa)
    cfg["Physics"]["modules"] = "thermal,cdr"
    cfg["Physics"]["Dirichlet conditions"]["c"] = {"all boundaries": 0.0}
    cfg["Discretization"]["order"]["c"] = 1
    cfg["Functions"].update({"source": "1.0 + x", "xvel": "2.0",
                             "yvel": "1.0", "reaction": reaction,
                             "density": "2.0"})
    if transient:
        cfg["Physics"]["Initial conditions"] = {"e": "0.0", "c": "0.0"}
        cfg["Solver"] = {"solver": "transient", "final time": 0.2,
                         "number of steps": 4}
    return cfg


def cdr_state_velocity_cfg():
    """cdr on 4 x 4 p1 quads, transient, with the velocity (c, y)."""
    cfg = cdr_cfg(4, reaction="0.5*c*c", transient=True)
    cfg["Functions"].update({"xvel": "c", "yvel": "y"})
    return cfg


# mesh -> ((nx, ny, nz), p order) of the provider checks
CDR_MESHES = {"p1": ((4, 4, None), 1), "hex": ((3, 2, 2), 1),
              "hex3": ((3, 3, 3), 1), "p2": ((4, 4, None), 2)}


def check_provider_case(physics, mesh, vel, reaction, stage, tol=1e-11):
    """check_fused_against_jax on a cdr (reaction given) or thermal
    advection (reaction None) deck of CDR_MESHES[mesh], steady or at a
    DIRK-2,2 stage-1 call; the split holds iff the reaction is linear."""
    (nx, ny, nz), order = CDR_MESHES[mesh]
    if physics == "thermal":
        cfg = advection_cfg(nx, ny, nz, vel, order, stage)
    else:
        cfg = cdr_cfg(nx, ny, nz, vel, reaction, order=order,
                      transient=stage)
    pj, pt = both_problems(cfg)
    tj, tt = (stage_coeffs(pj, pt, *DIRK22_STAGE1, seed=31) if stage
              else steady_coeffs(pj, pt))
    ft = check_fused_against_jax(pj, pt, tj, tt, seeded(pj.n_dof, seed=21),
                                 tol)
    assert ft.split == (reaction != "0.5*c*c")
    return ft


# module sets and state-reading coefficients on hex and p2 quads (the
# element-tile kernel B1 through the generated set_elem_full)

def ns_thermal_elem_cfg(mesh, n, supg=False, solver=None,
                        kappa="1.0 + 0.1*e*e", src="-1.0 + 0.5*x"):
    """NS + thermal with the Boussinesq term on the hex or p2 channel
    (ns_elem_cfg): beta 2.5, T_ambient 0.25, source uy `src`, thermal
    diffusion `kappa`, thermal advected by the flow (ux, uy[, uz]); e = 1
    on the bottom wall and 0 on the top one (true e = 1 - y)."""
    cfg = ns_elem_cfg(mesh, n, supg=supg, solver=solver)
    phys = cfg["Physics"]
    phys.update({"modules": "navier stokes,thermal", "beta": 2.5,
                 "T_ambient": 0.25, "include advection": True})
    phys["Dirichlet conditions"]["e"] = {"bottom": 1.0, "top": 0.0}
    phys["Initial conditions"]["e"] = 0.0
    cfg["Discretization"]["order"]["e"] = 2 if mesh == "p2" else 1
    cfg["Functions"].update({"source uy": src, "thermal diffusion": kappa,
                             "advection x": "ux", "advection y": "uy"})
    if mesh == "hex":
        cfg["Functions"]["advection z"] = "uz"
    cfg["Postprocess"]["True solutions"]["e"] = "1.0-y"
    return cfg


def ns_cdr_elem_cfg(mesh, n, supg=True, solver=None):
    """NS + cdr on the hex or p2 channel (ns_elem_cfg), transient unless
    `solver` says otherwise: c = 1 on the left, cdr advected by the flow,
    diffusion 0.01, reaction 0.5 c^2; source ux 1 + 0.1 c^2."""
    cfg = ns_elem_cfg(mesh, n, supg=supg, solver=solver or {
        "solver": "transient", "final time": 0.04, "number of steps": 4})
    phys = cfg["Physics"]
    phys["modules"] = "navier stokes,cdr"
    phys["Dirichlet conditions"]["c"] = {"left": 1.0}
    phys["Initial conditions"]["c"] = 0.0
    cfg["Discretization"]["order"]["c"] = 2 if mesh == "p2" else 1
    cfg["Functions"].update({"source ux": "1.0 + 0.1*c^2", "xvel": "ux",
                             "yvel": "uy", "diffusion": "0.01",
                             "reaction": "0.5*c*c"})
    if mesh == "hex":
        cfg["Functions"]["zvel"] = "uz"
    cfg["Postprocess"]["True solutions"]["c"] = "0.0"
    return cfg


def ns_thermal_cdr_elem_cfg(mesh, n, supg=True, solver=None):
    """NS + thermal + cdr on the hex or p2 channel (ns_thermal_elem_cfg):
    cdr advected by the flow, c = 1 on the left, source e c."""
    cfg = ns_thermal_elem_cfg(mesh, n, supg=supg, solver=solver)
    cfg["Physics"]["modules"] = "navier stokes,thermal,cdr"
    cfg["Physics"]["Dirichlet conditions"]["c"] = {"left": 1.0}
    cfg["Physics"]["Initial conditions"]["c"] = 0.0
    cfg["Discretization"]["order"]["c"] = 2 if mesh == "p2" else 1
    cfg["Functions"].update({"xvel": "ux", "yvel": "uy", "source": "e*c"})
    if mesh == "hex":
        cfg["Functions"]["zvel"] = "uz"
    cfg["Postprocess"]["True solutions"]["c"] = "0.0"
    return cfg


def thermal_cdr_p2_cfg(n, kappa="1.0 + e*c"):
    """thermal + cdr on n x n p2 quads (quadrature 4), steady: cdr
    advected by (2, 1), reaction 0.5 c^2, density 2."""
    cfg = thermal_cdr_cfg(kappa)
    cfg["Mesh"].update({"NX": n, "NY": n})
    cfg["Discretization"] = {"order": {"e": 2, "c": 2}, "quadrature": 4}
    return cfg


def cdr_state_velocity_hex_cfg(n):
    """cdr on an n^3 hex mesh, steady, with the velocity (c, 1, 0.5)."""
    cfg = cdr_cfg(n, n, n, reaction="0.5*c*c")
    cfg["Functions"].update({"xvel": "c", "yvel": "1.0", "zvel": "0.5"})
    return cfg


def check_fused_against_jax_general(pj, pt, tj, tt, u, alphas, tol):
    """The port's fused provider on hex or p2 against the JAX package's
    general path (residual, Jacobian blocks, apply, diag) and JAX's probe
    (each Jacobian row's kind, the constant rows' values, the counts of
    varying rows in `stats`): how the JAX package's own tests hold its
    element-tile kernel B1 where interpret mode is too slow. alphas: the
    stage's (alpha_u, alpha_t), or None for a steady call."""
    import jax.numpy as jnp
    from mrhyde_tpu.ops.fused_p1 import FusedP1Assembly as JaxFused
    from mrhyde_tpu_torch.interop import state_from_numpy
    asm = pt.assembler
    r, J = asm.res_and_jac(state_from_numpy(u, pt), tt)
    ft = asm.fused_provider()
    assert J.vol is None and J.vol_soa is not None
    aj = pj.assembler
    uj = jnp.asarray(u)
    Jj = aj.jacobian(uj, tj)
    assert max_diff(r, aj.residual(uj, tj)) < tol
    assert max_diff(J.aos(), Jj.vol) < tol
    v = seeded(pt.n_dof, seed=23, scale=1.0)
    assert max_diff(J.apply(state_from_numpy(v, pt)),
                    Jj.apply(jnp.asarray(v))) < tol
    assert max_diff(J.diag(), Jj.diag()) < tol
    fk = JaxFused.build(aj)
    steady = alphas is None
    au, at = alphas or (1.0, 0.0)
    res_p, jac_p = fk._probe(au, at, float(tt.time), float(tt.deltat), {},
                             steady, jnp.float64)
    assert [_kind(x) for x in J.vol_soa] == [_kind(x) for x in jac_p]
    for rt, rj in zip(J.vol_soa, jac_p):
        if _kind(rj) == "scalar":
            assert max_diff(rt, rj) < tol
    assert ft.stats["n_jac_rows"] == sum(_kind(x) == "array" for x in jac_p)
    assert ft.stats["n_res_rows"] == sum(_kind(x) == "array" for x in res_p)
    assert ft.stats["steady"] is steady
    assert ft.stats["split"] is False and ft.stats["node_scatter"] is False
    return ft


# mesh -> (nx, ny, nz) of the affine-set decks
AFFINE_MESHES = {"p1": (4, 4, None), "hex": (3, 2, 2), "p2": (3, 3, None)}


def thermal_cdr_affine_cfg(mesh="p1", transient=False, flux=True):
    """thermal + cdr whose coefficients read no state (an affine set:
    JAX's split path): thermal diffusion 1 + 0.5 x and source sin(pi x) y,
    cdr advected by (2, 1[, 0.5]) with reaction 1 and density 2, on
    AFFINE_MESHES[mesh]; each field 0 on the left, right and bottom (hex:
    front and back too) and, with `flux`, a Neumann flux 2 + y + t on e
    and a Flux condition x - 0.5 t on c at the top; transient: IC 0, BWE,
    4 steps to t = 0.2."""
    nx, ny, nz = AFFINE_MESHES[mesh]
    cfg = cdr_cfg(nx, ny, nz, reaction="1.0",
                  order=2 if mesh == "p2" else 1, transient=transient)
    walls = ["left", "right", "bottom"] + (["front", "back"] if nz else [])
    phys = cfg["Physics"]
    phys["modules"] = "thermal,cdr"
    phys["Dirichlet conditions"] = {"scalar data": True,
                                    "e": {s: 0.0 for s in walls},
                                    "c": {s: 0.0 for s in walls}}
    if flux:
        phys["Neumann conditions"] = {"e": {"top": "2.0 + y + t"}}
        phys["Flux conditions"] = {"c": {"top": "x - 0.5*t"}}
    if transient:
        phys["Initial conditions"] = {"e": "0.0", "c": "0.0"}
    cfg["Discretization"]["order"]["e"] = cfg["Discretization"]["order"]["c"]
    cfg["Functions"].update({"thermal diffusion": "1.0 + 0.5*x",
                             "thermal source": "sin(pi*x)*y"})
    cfg["Postprocess"]["True solutions"]["e"] = "0.0"
    return cfg


# the solver layer (tests/test_torch_precond.py, _multigrid.py, _amg.py)
def same_jacobians(cfg, seed=3, soa=False):
    """(JAX Problem, torch Problem, JAX J, torch J) holding the same
    numbers: the JAX package's general-path Jacobian at a seeded state
    (its boundary-group blocks included), handed to the port's
    BlockJacobian of the same deck. soa: both as SoA rows (the fused
    providers' layout), row 1 a structural zero and row 2 the constant
    0.25, the rest one value per element."""
    import dataclasses

    import jax.numpy as jnp
    from mrhyde_tpu_torch.interop import state_from_numpy
    pj, pt = both_problems(cfg)
    tj, tt = steady_coeffs(pj, pt)
    u = seeded(pj.n_dof, seed=seed)
    Jj = pj.assembler.jacobian(jnp.asarray(u), tj)
    Jt = pt.assembler.jacobian(state_from_numpy(u, pt), tt)
    assert len(Jj.bnd) == len(Jt.bnd)
    vol = np.asarray(Jj.vol)
    Jt = dataclasses.replace(
        Jt, vol=torch.tensor(vol),
        bnd=[torch.tensor(np.asarray(b)) for b in Jj.bnd])
    if soa:
        nd = vol.shape[1]
        rows = [vol[:, k // nd, k % nd] for k in range(nd * nd)]
        rows[1], rows[2] = None, np.float64(0.25)
        Jj = dataclasses.replace(Jj, vol=None, vol_soa=[
            None if r is None else jnp.asarray(r) for r in rows])
        Jt = dataclasses.replace(Jt, vol=None, vol_soa=[
            None if r is None else torch.as_tensor(r) for r in rows])
    return pj, pt, Jj, Jt


def rel_diff(a, b):
    """max |a - b| / max |b|."""
    b = np.asarray(b)
    return max_diff(a, b) / float(np.max(np.abs(b)))


# element blocks, periodic and Exodus meshes, elasticity
# (tests/test_torch_multiblock.py, _periodic.py, _exodus.py,
# _elasticity.py)
def multiblock_cfg(nx, blocks=(2, 2)):
    """The reference's thermal/2D_multiblock: nx x nx elements in each of
    the blocks (Xblocks x Yblocks) of the unit square, u = sin(pi x)
    sin(pi y); its gold is 0.000513878 per block at nx = 10
    (tests/test_thermal_family.py:130-157)."""
    return {
        "Mesh": {"dimension": 2, "element type": "quad", "NX": nx,
                 "NY": nx, "Xblocks": blocks[0], "Yblocks": blocks[1]},
        "Functions": {"thermal source": "2*(pi*pi)*sin(pi*x)*sin(pi*y)"},
        "Physics": {"modules": "thermal",
                    "Dirichlet conditions": {
                        "scalar data": True,
                        "e": {"top": 0.0, "bottom": 0.0, "left": 0.0,
                              "right": 0.0}},
                    "Initial conditions": {"scalar data": True, "e": 0.0}},
        "Discretization": {"order": {"e": 1}, "quadrature": 2},
        "Solver": {"solver": "steady-state", "use strong DBCs": True},
        "Postprocess": {"compute errors": True,
                        "True solutions": {"e": "sin(pi*x)*sin(pi*y)"}},
    }


def per_block_cfg(nx, neumann=False):
    """The JAX package's two-block deck (tests/test_per_block_physics.py):
    [0,2]x[0,1] split at x = 1, thermal on eblock-0_0 and cdr on
    eblock-1_0, nx x nx/2 elements; neumann: e's top Dirichlet replaced
    by the true solution's flux."""
    cfg = {
        "Mesh": {"dimension": 2, "element type": "quad",
                 "xmin": 0.0, "xmax": 2.0, "ymin": 0.0, "ymax": 1.0,
                 "NX": nx, "NY": nx // 2, "Xblocks": 2},
        "Physics": {
            "eblock-0_0": {
                "modules": "thermal",
                "Dirichlet conditions": {
                    "e": {"all boundaries": 0.0},
                    "c": {"all boundaries": 0.0}}},
            "eblock-1_0": {"modules": "cdr"},
        },
        "Functions": {
            "thermal source": "(5.0*pi*pi/4.0)*sin(pi*x/2)*sin(pi*y)"
                              "*(x<1.0)",
            "source": "(5.0*pi*pi/4.0)*cos(pi*(x-1.0)/2)*sin(pi*y)"
                      "*(x>1.0)",
            "diffusion": "1.0", "xvel": "0.0", "yvel": "0.0",
            "reaction": "0.0"},
        "Discretization": {"order": {"e": 1, "c": 1}, "quadrature": 2},
        "Solver": {"solver": "steady-state", "nonlinear TOL": 1e-10,
                   "max nonlinear iters": 3, "use direct solver": True},
        "Postprocess": {"compute errors": True,
                        "True solutions": {
                            "e": "sin(pi*x/2)*sin(pi*y)*(x<1.0)",
                            "c": "cos(pi*(x-1.0)/2)*sin(pi*y)*(x>1.0)"}},
    }
    if neumann:
        blk = cfg["Physics"]["eblock-0_0"]
        blk["Dirichlet conditions"]["e"] = {"left": 0.0, "right": 0.0,
                                            "bottom": 0.0}
        blk["Neumann conditions"] = {
            "e": {"top": "pi*sin(pi*x/2)*cos(pi*1.0)"}}
    return cfg


# the reference's le/2D_manufactured (tests/test_solid_sw_porous.py:11-45)
LE_FUNCTIONS = {
    "lambda": "1.0", "mu": "1.0", "A": "1.0", "B": "2.0",
    "dxxx": "(A*pi)*(A*pi)*sin(A*pi*x)*sin(A*pi*y)",
    "dxxy": "-1.0*(A*pi)*(A*pi)*cos(A*pi*x)*cos(A*pi*y)",
    "dxyy": "(A*pi)*(A*pi)*sin(A*pi*x)*sin(A*pi*y)",
    "dyxx": "(B*pi)*(B*pi)*sin(B*pi*x)*sin(B*pi*y)",
    "dyxy": "-1.0*(B*pi)*(B*pi)*cos(B*pi*x)*cos(B*pi*y)",
    "dyyy": "(B*pi)*(B*pi)*sin(B*pi*x)*sin(B*pi*y)",
    "source dx": "(lambda+2.0*mu)*dxxx + mu*(dxyy+dyxy) + lambda*dyxy",
    "source dy": "(lambda+2.0*mu)*dyyy + mu*(dyxx+dxxy) + lambda*dxxy",
}


def le_cfg(nx, solver=None):
    """le/2D_manufactured on nx x nx quads: dx = sin(pi x) sin(pi y), dy =
    sin(2 pi x) sin(2 pi y), both 0 on the boundary; its gold is L2(dx)
    0.000770252, L2(dy) 0.00121848 at nx = 40."""
    return {
        "Mesh": {"dimension": 2, "element type": "quad", "NX": nx,
                 "NY": nx},
        "Physics": {"modules": "linearelasticity",
                    "Dirichlet conditions": {
                        "scalar data": True,
                        "dx": {"all boundaries": 0.0},
                        "dy": {"all boundaries": 0.0}},
                    "Initial conditions": {"scalar data": True,
                                           "dx": 0.0, "dy": 0.0}},
        "Functions": dict(LE_FUNCTIONS),
        "Discretization": {"order": {"dx": 1, "dy": 1}, "quadrature": 2},
        "Solver": dict({"solver": "steady-state", "max nonlinear iters": 2},
                       **(solver or {})),
        "Postprocess": {"compute errors": True,
                        "True solutions": {
                            "dx": "sin(A*pi*x)*sin(A*pi*y)",
                            "dy": "sin(B*pi*x)*sin(B*pi*y)"}},
    }


def rotations(n, dim, seed):
    """n rotation matrices (n, 3, 3) from a numpy seed: in 3D the QR of
    Gaussian matrices, each made proper (det +1); in 2D rotations about
    z (uniform angles), whose 2x2 block the 2D decks read."""
    rng = np.random.RandomState(seed)
    if dim == 2:
        th = 2.0 * np.pi * rng.rand(n)
        q = np.zeros((n, 3, 3))
        q[:, 0, 0] = q[:, 1, 1] = np.cos(th)
        q[:, 1, 0], q[:, 0, 1] = np.sin(th), -np.sin(th)
        q[:, 2, 2] = 1.0
        return q
    q, r = np.linalg.qr(rng.randn(n, 3, 3))
    q = q * np.sign(np.diagonal(r, axis1=1, axis2=2))[:, None, :]
    q[np.linalg.det(q) < 0, :, 0] *= -1.0
    return q


def write_grain_files(directory, n_grains, dim, seed):
    """The mesh data files of a crystal deck in `directory`: grain
    centers (mesh_data_pts.dat, uniform in the unit square / cube) and
    one 3x3 rotation per grain (mesh_data.dat, 9 columns)."""
    import os
    rng = np.random.RandomState(seed)
    pts = np.zeros((n_grains, 3))
    pts[:, :dim] = rng.rand(n_grains, dim)
    np.savetxt(os.path.join(directory, "mesh_data_pts.dat"), pts)
    np.savetxt(os.path.join(directory, "mesh_data.dat"),
               rotations(n_grains, dim, seed + 1).reshape(n_grains, 9))


# the rest of A10's physics (tests/test_torch_physics_a10.py, _forms.py)
def a10_decks():
    """name -> deck of chip_smoke.py at a CPU size, one per module and
    option: Burgers plain / entropy viscosity / SUPG, VDNS PSPG / SUPG /
    GRADDIV steady and transient, msphasefield legacy on and off in 2D and
    3D, phasesolidification 3D, inc sat with and without wells, Helmholtz
    Neumann and Robin, cns Far-field and Slip, and the other modules."""
    import chip_smoke as cs
    return {
        "burgers_1d": lambda: cs.burgers_deck(20, dim=1),
        "burgers_plain": lambda: cs.burgers_deck(6, steps=2),
        "burgers_evisc": lambda: cs.burgers_deck(6, evisc=True, steps=2),
        "burgers_supg": lambda: cs.burgers_deck(6, supg=True, steps=2),
        "helmholtz_neumann": lambda: cs.helmholtz_deck(
            8, solver={"use direct solver": True}),
        "helmholtz_robin": lambda: cs.helmholtz_deck(
            8, robin=True, solver={"use direct solver": True}),
        "ks_1d_periodic": lambda: cs.ks_deck(10, steps=4),
        "ks_2d_periodic": lambda: cs.ks_deck(6, dim=2, steps=2),
        "shallowwater": lambda: cs.shallowwater_deck(8, steps=2),
        "msphasefield_2d_legacy": lambda: cs.phasesolidification_deck(
            6, 2, "msphasefield", legacy=True),
        "msphasefield_2d_consistent": lambda: cs.phasesolidification_deck(
            6, 2, "msphasefield"),
        "msphasefield_3d_legacy": lambda: cs.phasesolidification_deck(
            3, 3, "msphasefield", legacy=True),
        "msphasefield_3d_consistent": lambda: cs.phasesolidification_deck(
            3, 3, "msphasefield"),
        "msphasefield_3phi_consistent": lambda: cs.phasefield_deck(
            8, legacy=False),
        "phasesolidification_3d": lambda: cs.phasesolidification_deck(3),
        "vdns_pspg_steady": lambda: cs.vdns_deck(10, 4),
        "vdns_supg_steady": lambda: cs.vdns_deck(10, 4, pspg=True, supg=True),
        "vdns_graddiv_steady": lambda: cs.vdns_deck(10, 4, pspg=True,
                                                    graddiv=True),
        "vdns_all_transient": lambda: cs.vdns_deck(
            10, 4, True, True, True, steps=2,
            solver={"use direct solver": True}),
        "porous": lambda: cs.porous_deck(8),
        "porous_compressible": lambda: cs.porous_deck(8, True, steps=2),
        "shallowice": lambda: cs.shallowice_deck(8),
        "llamas": lambda: cs.llamas_deck(8),
        "physics_test": lambda: cs.physics_test_deck(8),
        "hartmann_1d": lambda: cs.hartmann_deck(20),
        "hartmann_2d": lambda: cs.hartmann_deck(8, ny=4),
        "inc_sat": lambda: cs.inc_sat_deck(8, 4, wells=False, steps=2),
        "inc_sat_wells": lambda: cs.inc_sat_deck(8, 4, wells=True, steps=2),
        "cns_slip": lambda: cs.cns_deck(6, steps=2),
        "cns_far_field": lambda: cs.cns_deck(6, bc="Far-field", steps=2),
        "cns_1d": lambda: cs.cns_deck(16, dim=1, steps=2),
    }


# norms that are 0 to round-off (T of the VDNS channel, w at t = 0) are
# held to this absolute bound instead of a relative one
NORM_FLOOR = 1e-13


def solve_both(cfg, rtol=1e-11):
    """Both packages' runs of cfg: solutions within rtol of each other
    (relative to max |u|), every norm at every recorded time within rtol
    (or NORM_FLOOR); returns (JAX result, port result, port Problem)."""
    import copy
    pj, pt = both_problems(copy.deepcopy(cfg))
    rj, rt = pj.run(), pt.run()
    uj = np.asarray(rj.u)
    assert np.max(np.abs(rt.u.numpy() - uj)) <= rtol * np.max(np.abs(uj))
    assert len(rt.error_history) == len(rj.error_history)
    for (tj, ej), (tt, et) in zip(rj.error_history, rt.error_history):
        assert abs(tt - tj) <= 1e-14
        assert set(et) == set(ej)
        for key, val in ej.items():
            assert abs(et[key] - val) <= max(rtol * abs(val), NORM_FLOOR), \
                (tj, key, et[key], val)
    return rj, rt, pt


def _on_mesh(cfg, cell, n, nz=None):
    """cfg on an n^dim mesh of another cell type."""
    dim = 2 if cell in ("quad", "tri") else 3
    cfg["Mesh"] = dict({"dimension": dim, "element type": cell, "NX": n,
                        "NY": n}, **({"NZ": nz or n} if dim == 3 else {}))
    return cfg


def _sides(cfg, var, value):
    """Dirichlet data `value` on every side for var (3D-safe)."""
    cfg["Physics"]["Dirichlet conditions"] = {var: {"all boundaries": value}}
    return cfg


def perm_data_files(directory, n_pts, seed):
    """Writes a permeability field sampled at n_pts x n_pts points
    (perm.dat, perm_xy.dat) from seed: 1 + 0.5 U(0, 1)."""
    import os
    rng = np.random.RandomState(seed)
    g = (np.arange(n_pts) + 0.5) / n_pts
    xy = np.stack(np.meshgrid(g, g, indexing="ij"), axis=-1).reshape(-1, 2)
    np.savetxt(os.path.join(directory, "perm_xy.dat"), xy)
    np.savetxt(os.path.join(directory, "perm.dat"),
               1.0 + 0.5 * rng.rand(xy.shape[0]))


def a11_decks(data_dir=None):
    """name -> deck of chip_smoke.py's A11 decks at a CPU size, one per
    module, option and cell type: mixed porous (quads, triangles, hex,
    tets; the KL log-permeability; mesh-data permeability when data_dir
    is given), its hybridized form (quads, hex with an order-1 trace),
    weak Galerkin (HDIV-DG and Arbogast-Correa), maxwell (2D HCURL / HVOL
    with conductivity, hex, tet Nedelec of order 2 through the mixing
    channel, the 'maxwell control' name), maxwells_fp (hex 'test: 2', 2D
    quads), hybridized shallow water (Far-field and Slip) and Euler's HDG
    form (max-EV and Roe-like stabilization, 2D and hex)."""
    import chip_smoke as cs

    def kl():
        c = cs.porous_mixed_deck(6)
        c["Physics"].update({"use KL expansion": True, "KL parameters": {
            "x-direction": {"N": 3, "eta": 0.3, "L": 1.0, "sigma": 0.5},
            "y-direction": {"N": 2, "eta": 0.2, "L": 1.0, "sigma": 0.5}}})
        c["Parameters"] = {"KLStochcoeffs": {
            "type": "vector", "value": [0.3, -0.2, 0.5, 0.1, -0.4],
            "usage": "inactive"}}
        return c

    def perm():
        perm_data_files(data_dir, 7, seed=3)
        c = cs.porous_mixed_deck(5)
        c["_deck_dir"] = data_dir
        c["Mesh"].update({"data file": "perm",
                          "data points file": "perm_xy"})
        c["Physics"]["use permeability data"] = True
        return c

    def wg_perm():
        perm_data_files(data_dir, 7, seed=4)
        c = cs.weak_galerkin_deck(4)
        c["_deck_dir"] = data_dir
        c["Mesh"].update({"data file": "perm",
                          "data points file": "perm_xy"})
        c["Physics"]["use permeability data"] = True
        return c

    def wg_ac():
        c = cs.weak_galerkin_deck(4)
        c["Physics"]["useAC"] = True
        return c

    def hybrid_hex():
        c = _sides(_on_mesh(cs.porous_mixed_deck(2, hybrid=True), "hex", 2),
                   "lambda", "1.0")
        c["Postprocess"]["True solutions"].update({"u[z]": "x",
                                                   "lambda face": "x*y"})
        return c

    def maxwell2d():
        return {
            "Mesh": {"dimension": 2, "element type": "quad", "NX": 4,
                     "NY": 3},
            "Physics": {"modules": "maxwell", "Initial conditions": {
                "E[x]": "sin(pi*y)", "E[y]": "x*y", "B": "cos(pi*x)"}},
            "Functions": {"current x": "0.1*x", "permittivity": "1.5",
                          "permeability": "1.2", "conductivity": "0.3",
                          "refractive index": "1.1"},
            "Discretization": {"order": {"E": 1, "B": 0}, "quadrature": 2},
            "Solver": {"solver": "transient", "final time": 0.02,
                       "number of steps": 2, "use direct solver": True,
                       "transient Butcher tableau": "DIRK-1,2",
                       "initial type": "L2-projection"},
            "Postprocess": {"compute errors": True, "True solutions": {
                "E[x]": "sin(pi*y)", "E[y]": "x*y", "B": "0.0",
                "curl(E)": "y"}}}

    def maxwell_tet2():
        c = _on_mesh(cs.maxwell_deck(1), "tet", 1)
        c["Discretization"] = {"order": {"E": 2, "B": 1}, "quadrature": 4}
        c["Functions"].update({"current y": "x*z", "conductivity": "0.5"})
        c["Postprocess"]["True solutions"]["curl(E)[y]"] = "x"
        return c

    def maxwell_control():
        c = cs.maxwell_deck(2)
        c["Physics"]["modules"] = "maxwell control"
        c["Functions"]["current z"] = "jz"
        c["Parameters"] = {"jz": {"type": "scalar", "value": 0.7,
                                  "usage": "active"}}
        return c

    def mfp2d():
        vs = ("Arx", "Aix", "Ary", "Aiy", "phir", "phii")
        return {
            "Mesh": {"dimension": 2, "element type": "quad", "NX": 5,
                     "NY": 4},
            "Physics": {"modules": "maxwells_freq_pot",
                        "Dirichlet conditions": {
                            v: {"all boundaries": "0.0"} for v in vs}},
            "Functions": {"mur": "2.0", "mui": "1.0", "epsr": "1.0+x",
                          "epsi": "0.5", "omega": "1.3", "Jxr": "x*y",
                          "Jyi": "1.0", "rhor": "y", "rhoi": "x"},
            "Discretization": {"order": {v: 1 for v in vs},
                               "quadrature": 2},
            "Solver": {"solver": "steady-state", "nonlinear TOL": 1e-12,
                       "use direct solver": True},
            "Postprocess": {"compute errors": True,
                            "True solutions": {v: "0.0" for v in vs}}}

    def swe_slip():
        c = cs.swe_hybridized_deck(4, steps=2)
        c["Physics"].pop("Far-field conditions")
        c["Physics"]["Slip conditions"] = {"H": {"all boundaries": "0"}}
        return c

    def euler_roe_angled():
        vx, vy = 0.5, 0.25
        c = cs.euler_hdg_deck(4, steps=2, stab="Roe-like stabilization")
        bump = "(1.0 + 0.1*exp(-50*((x-0.5)*(x-0.5)+(y-0.25)*(y-0.25))))"
        c["Physics"]["Initial conditions"] = {
            "rho": bump, "rhoux": f"{vx}*{bump}", "rhouy": f"{vy}*{bump}",
            "rhoE": f"2.5 + {0.5 * (vx * vx + vy * vy)}*{bump}"}
        far = {"rho": 1.0, "rhoux": vx, "rhouy": vy,
               "rhoE": 2.5 + 0.5 * (vx * vx + vy * vy)}
        c["Physics"]["Far-field conditions"] = {
            v: {"all boundaries": str(val)} for v, val in far.items()}
        c["Physics"].pop("Slip conditions")
        return c

    def euler_hex():
        c = cs.euler_hdg_deck(4, steps=1)
        c["Mesh"] = {"dimension": 3, "element type": "hex", "NX": 2,
                     "NY": 1, "NZ": 1, "xmax": 2.0, "ymax": 0.5,
                     "zmax": 0.5}
        ph = c["Physics"]
        ph["Initial conditions"]["rhouz"] = "0.0"
        ph["Far-field conditions"]["rhouz"] = {"left": "0.0",
                                               "right": "0.0"}
        ph["Slip conditions"] = {"rho": {s: "0" for s in (
            "top", "bottom", "front", "back")}}
        c["Postprocess"]["True solutions"]["rhouz"] = "0.0"
        return c

    decks = {
        "mixed_quad": lambda: cs.porous_mixed_deck(4),
        "mixed_tri": lambda: _on_mesh(cs.porous_mixed_deck(3), "tri", 3),
        "mixed_hex": lambda: _sides(_on_mesh(cs.porous_mixed_deck(2),
                                             "hex", 2), "p", "1.0 + x"),
        "mixed_tet": lambda: _sides(_on_mesh(cs.porous_mixed_deck(2),
                                             "tet", 1), "p", "x*y"),
        "mixed_kl": kl,
        "hybrid_quad": lambda: cs.porous_mixed_deck(4, hybrid=True),
        "hybrid_hex": hybrid_hex,
        "weak_galerkin": lambda: cs.weak_galerkin_deck(4),
        "weak_galerkin_ac": wg_ac,
        "maxwell_2d": maxwell2d,
        "maxwell_hex": lambda: cs.maxwell_deck(3),
        "maxwell_tet_order2": maxwell_tet2,
        "maxwell_control": maxwell_control,
        "maxwells_fp_hex": lambda: cs.maxwells_fp_deck(2),
        "maxwells_fp_2d": mfp2d,
        "swe_far_field": lambda: cs.swe_hybridized_deck(4, steps=2),
        "swe_slip": swe_slip,
        "euler_maxev": lambda: cs.euler_hdg_deck(8, steps=2),
        "euler_roe_angled": euler_roe_angled,
        "euler_hex": euler_hex,
    }
    if data_dir is not None:
        decks["mixed_perm_data"] = perm
        decks["weak_galerkin_perm_data"] = wg_perm
    return decks


# ----------------------------------------------------------------------
# ROADMAP A12: postprocess and analysis decks
# ----------------------------------------------------------------------

SENSOR_PTS = [[0.3, 0.3], [0.7, 0.45], [0.55, 0.8], [0.2, 0.65]]


def a12_objectives(times=(0.0,), field=True):
    """Every objective type the adjoint reads: an integrated response on
    4 virtual ranks, an integrated control, sensors with data at `times`,
    and with the field a volume regularization of its gradient and a
    boundary one of its values on the top side."""
    data = (0.05, 0.02, -0.03, 0.01)
    obj = {"resp": {"type": "integrated response", "response": "e*e",
                    "target": 0.002, "weight": 10.0},
           "ctrl": {"type": "integrated control", "function": "0.5*e"},
           "sens": {"type": "sensors", "response": "e", "weight": 2.0,
                    "sensor points": SENSOR_PTS,
                    "sensor times": list(times),
                    "sensor data": [[d * (1.0 + 0.1 * k)
                                     for k in range(len(times))]
                                    for d in data]}}
    if field:
        obj["resp"]["Regularization functions"] = {
            "r1": {"function": "1e-3*(grad(src_field)[x]*grad(src_field)[x]"
                               " + grad(src_field)[y]*grad(src_field)[y])",
                   "weight": 0.5},
            "r2": {"function": "src_field*src_field", "location": "boundary",
                   "boundary name": "top", "weight": 0.25}}
    return obj


def adjoint_cfg(n=5, transient=False, field=True, dynamic=False, steps=3):
    """Thermal with kappa = k0 + k1 e^2 + kv(1) x and source kv(0) sin(pi
    x) sin(pi y) (+ the field src_field): active scalars k0, k1, the
    active vector kv and the discretized HGRAD p1 field; the objectives
    of a12_objectives. Transient: DIRK-2,2 with `steps` steps of 0.05,
    the sensors at the objective's record times t + 0.75 dt."""
    src = "kv(0)*sin(pi*x)*sin(pi*y)" + (" + src_field" if field else "")
    cfg = thermal_cfg(n, kappa="k0 + k1*e*e + kv(1)*x", source=src)
    cfg["Physics"]["Initial conditions"] = {"e": "0.0"}
    cfg["Solver"] = {"solver": "steady-state", "max nonlinear iters": 10}
    times = (0.0,)
    if transient:
        cfg["Solver"].update({"solver": "transient",
                              "transient Butcher tableau": "DIRK-2,2",
                              "final time": 0.05 * steps,
                              "number of steps": steps})
        times = tuple(0.05 * k + 0.0375 for k in range(steps))
    cfg["Parameters"] = {
        "k0": {"type": "scalar", "value": 1.0, "usage": "active"},
        "k1": {"type": "scalar", "value": 0.5, "usage": "active"},
        "kv": {"type": "vector", "value": [1.0, 0.25], "usage": "active"}}
    if field:
        cfg["Parameters"]["src_field"] = {
            "type": "HGRAD", "usage": "discretized", "order": 1,
            "initial_value": 1.0, "dynamic": dynamic}
    cfg["Postprocess"] = {"compute errors": False,
                          "Objective functions": a12_objectives(times, field)}
    return cfg


def a12_pvec(pt, seed=0):
    """(JAX pvec, torch pvec) of the same seeded values: the deck's
    scalars and vectors perturbed, each field 1 + 0.3 U(0, 1) per DOF
    (per step and DOF when dynamic)."""
    import jax.numpy as jnp
    from mrhyde_tpu_torch.interop import field_from_numpy
    rng = np.random.RandomState(seed)
    pm = pt.param_manager
    pj, ptt = {}, {}
    for name in pm.active_names():
        v = np.asarray(pm.specs[name].value, dtype=float)
        if pm.specs[name].usage == "discretized":
            v = 1.0 + 0.3 * rng.rand(*v.shape)
            ptt[name] = field_from_numpy(v, pt, name)
        else:
            v = v * (1.0 + 0.1 * rng.rand(*v.shape))
            ptt[name] = torch.as_tensor(v, dtype=torch.float64)
        pj[name] = jnp.asarray(v)
    return pj, ptt


def rol_cfg(n=4, bounded=False, iters=4, fd_check=True):
    """The trust-region source inversion: 'Generate data' runs the
    source 2 S + 0.5 x (datagen = 1), then ROL fits a1 S + a2 x from
    (0.2, -1) against the stored state (discrete control). Unbounded,
    its table has boundary steps (flagCG 3) and secant steps; bounded
    (a1 <= 1.5 below the data's 2), the Kelley-Sachs model with a
    rejected step (tr_flag 3)."""
    return {
        "Mesh": {"dimension": 2, "element type": "quad", "NX": n, "NY": n},
        "Functions": {"thermal diffusion": "k0", "thermal source":
                      "datagen*(2.0*sin(pi*x)*sin(pi*y) + 0.5*x) "
                      "+ (1.0-datagen)*(a1*sin(pi*x)*sin(pi*y) + a2*x)"},
        "Physics": {"modules": "thermal",
                    "Dirichlet conditions": {"scalar data": True,
                                             "e": {"all boundaries": 0.0}},
                    "Initial conditions": {"scalar data": True, "e": 0.0}},
        "Discretization": {"order": {"e": 1}, "quadrature": 2},
        "Solver": {"solver": "steady-state", "max nonlinear iters": 4},
        "Parameters": {
            "k0": {"type": "scalar", "value": 1.0, "usage": "inactive"},
            "datagen": {"type": "scalar", "value": 0.0, "usage": "inactive"},
            "a1": {"type": "scalar", "value": 0.2, "usage": "active",
                   "min": 0.0, "max": 1.5},
            "a2": {"type": "scalar", "value": -1.0, "usage": "active",
                   "min": -0.5, "max": 3.0}},
        "Analysis": {"analysis type": "ROL", "ROL": {
            "General": {"Generate data": True,
                        "Do grad+hessvec check": fd_check,
                        "Write Final Parameters": True,
                        "Bound Optimization Variables": bounded,
                        "Secant": {"Maximum Storage": 5}},
            "Step": {"Trust Region": {"Initial Radius": 0.5}},
            "Status Test": {"Iteration Limit": iters,
                            "Gradient Tolerance": 1e-10,
                            "Step Tolerance": 1e-14}}},
        "Postprocess": {"Objective functions": {
            "misfit": {"type": "discrete control", "weight": 1e4}}},
    }


def uq_cfg(n=4, samples=6, analysis="UQ", user_file=None):
    """UQ (or DCI) of thermal with kappa ~ U(1, 2) and the source
    amplitude ~ N(1, 0.04); objective int e^2 (an integrated control)."""
    cfg = thermal_cfg(n, kappa="kappa", source=f"amp*{SOURCE}")
    cfg["Parameters"] = {
        "kappa": {"type": "scalar", "value": 1.0, "usage": "stochastic",
                  "distribution": "uniform", "min": 1.0, "max": 2.0},
        "amp": {"type": "scalar", "value": 1.0, "usage": "stochastic",
                "distribution": "Gaussian", "mean": 1.0, "variance": 0.04}}
    uq = {"samples": samples, "seed": 1234}
    if user_file is not None:
        uq.update({"use user defined": True, "source": str(user_file)})
    cfg["Analysis"] = {"analysis type": analysis, "UQ": uq,
                       "DCI": {"observed type": "Gaussian",
                               "observed mean": 0.15,
                               "observed variance": 0.0025}}
    cfg["Postprocess"] = {"Objective functions": {
        "energy": {"type": "integrated control", "response": "e*e"}}}
    return cfg


# ----------------------------------------------------------------------
# the multiscale subgrid method: decks at CPU sizes
# ----------------------------------------------------------------------

def porous_subgrid_cfg(kind="mixed", n=4, refine=1, data_dir=None):
    """An HFACE p0 macro pressure trace on n x n quads (0 on the
    boundary; the reference's porous/*_hybrid_multiscale layout) over a
    porous subgrid of 2^refine per side: kind "mixed" the mixed RT0 / p0
    form (the trace 'lambda' aliased to the fine 'p'), "wg" weak Galerkin
    on conforming HDIV u and t (the trace 'pbndry' aliased to 'pint').
    data_dir: the fine permeability from a mesh data file written there
    (the subgrid Mesh sublist's 'data file')."""
    from chip_smoke import DARCY_U, S_TRUE, SOURCE
    if kind == "mixed":
        macro = {"modules": "porous mixed hybridized",
                 "Active variables": {"lambda": "HFACE"}}
        trace, fine = "lambda", {"modules": "porous mixed"}
        orders = {"u": 1, "p": 0}
        trues = {"p": S_TRUE, "u[x]": DARCY_U[0], "u[y]": DARCY_U[1]}
    else:
        macro = {"modules": "porous weak Galerkin",
                 "Active variables": {"pbndry": "HFACE"}}
        trace = "pbndry"
        fine = {"modules": "porous weak Galerkin", "Active variables": {
            "pint": "HVOL", "u": "HDIV", "t": "HDIV"}}
        orders = {"pint": 0, "u": 1, "t": 1}
        trues = {"pint": S_TRUE, "t[x]": DARCY_U[0], "t[y]": DARCY_U[1]}
    macro["Dirichlet conditions"] = {trace: {"all boundaries": "0.0"}}
    cfg = {
        "Mesh": {"dimension": 2, "element type": "quad", "NX": n, "NY": n},
        "Physics": macro, "Functions": {"source": SOURCE},
        "Discretization": {"order": {trace: 0}, "quadrature": 2},
        "Solver": {"solver": "steady-state", "initial type": "none"},
        "Postprocess": {"compute errors": True,
                        "True solutions": {f"{trace} face": S_TRUE}},
        "Subgrid": {
            "Mesh": {"element type": "quad", "refinements": refine,
                     "dimension": 2},
            "Physics": fine, "Solver": {"solver": "steady-state"},
            "Functions": {"source": SOURCE},
            "Discretization": {"order": orders, "quadrature": 2},
            "Postprocess": {"True solutions": trues}}}
    if data_dir is not None:
        perm_data_files(data_dir, 9, seed=5)
        cfg["_deck_dir"] = data_dir
        cfg["Subgrid"]["Mesh"].update({"data file": "perm",
                                       "data points file": "perm_xy"})
        cfg["Subgrid"]["Physics"]["use permeability data"] = True
    return cfg


def elasticity_subgrid_cfg(n=3, refine=1):
    """Linear elasticity on both scales: the displacement (dx, dy) fixed
    on the macro boundary, a subgrid of 2^refine per side with a varying
    shear modulus and a body force, coupled through the Nitsche traction
    interface."""
    return {
        "Mesh": {"dimension": 2, "element type": "quad", "NX": n, "NY": n},
        "Physics": {"modules": "linearelasticity", "Dirichlet conditions": {
            "dx": {"all boundaries": "0.0"}, "dy": {"all boundaries": "0.0"}}},
        "Functions": {},
        "Discretization": {"order": {"dx": 1, "dy": 1}, "quadrature": 2},
        "Solver": {"solver": "steady-state"},
        "Postprocess": {"compute errors": True,
                        "True solutions": {"dx": "0.0", "dy": "0.0"}},
        "Subgrid": {
            "Mesh": {"element type": "quad", "refinements": refine,
                     "dimension": 2},
            "Physics": {"modules": "linearelasticity"},
            "Solver": {"solver": "steady-state"},
            "Functions": {"source dx": "1.0 + x", "source dy": "x*y",
                          "lambda": "2.0", "mu": "0.5 + 0.5*x"},
            "Discretization": {"order": {"dx": 1, "dy": 1}, "quadrature": 2},
            "Postprocess": {"True solutions": {"dx": "0.0",
                                               "dy": "0.01*x"}}}}
