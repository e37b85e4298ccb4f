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
