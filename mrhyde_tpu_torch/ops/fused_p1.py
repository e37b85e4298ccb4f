"""Fused assembly of the scalar advection-diffusion-reaction weak form
(thermal, with or without advection, and cdr) on uniform structured
meshes: the node-scatter kernels for 2D p1 quads, and the dispatch to
the element kernels for 3D hex and 2D p2 quads.

(The Navier-Stokes provider, on the same kernel B2 with three variables,
is ops/fused_ns.py; `FusedP1Assembly.build` hands NS decks to it. The
element kernels, the port of the JAX package's element-tile TPU kernel
B1, are ops/fused_elem.py; the provider below picks B2 for 2D p1 and B1
otherwise, as the JAX package's `use_node` does.)

The port of the JAX package's `FusedP1Assembly` (mrhyde_tpu/ops/
fused_p1.py) for the case its node-scatter TPU kernel (B2,
`run_node_call`) carries on the main path: 2D p1 quads, steady or a
stage of a transient solve. The TPU kernel traced any physics'
`qp_density` and differentiated it by sparse forward AD; here the weak
form that thermal and cdr share is written out,

    r_c = sum_q w [phi_c (m u_dot + b . grad u_eval + S_f)
                   + kappa grad phi_c . grad u_eval]

with u_eval = alpha_u u + beta_u and u_dot = alpha_t u + beta_t (steady:
alpha_u = 1, alpha_t = 0, no betas). Thermal: m = rho cp, S_f = -f, b the
'advection x|y|z' functions under 'include advection' (else none). Cdr:
m = 1, S_f = reaction - source, kappa = diffusion / (rho cp), b = (xvel,
yvel[, zvel]). The module names the functions behind kappa, S, m and b
(`fused_names`) and evaluates them (`qp_coefficients`, `qp_mass`,
`qp_velocity`). The two launched modes of B2 are hand-written CUDA
kernels (`csrc/fused_p1_thermal.cu`), each with an ADVECT variant:

- `thermal_node_state` (mode "state"): under the AFFINE split (no
  coefficient reads the state), the residual's state part sum_q w
  [phi_c (m alpha_t u_h + alpha_u b . grad u_h) + kappa alpha_u grad
  phi_c . grad u_h] (the mass lane only in a transient stage),
  node-scattered in the kernel. The state-independent coord part is
  computed once per stage and cached for its Newton solve: the residual
  at u = 0 (u_eval = beta_u, u_dot = beta_t) as the plain-torch source
  term plus the state kernel on the beta_u and beta_t grids, and the
  Jacobian alpha_u (K_kappa + A_b) + alpha_t M_m (state-independent too;
  A_b[c][c'] = sum_q w phi_c b . grad phi_c') in plain torch, as
  `_coord_eval` is plain XLA in JAX.
- `thermal_node_full` (mode "full"): otherwise, the residual and all 16
  SoA Jacobian rows from one pass over the u_eval grid, fed per-qp S
  (with its m u_dot term, without b), dS/de, kappa, dkappa/de and m
  tensors that a torch pre-pass evaluates (DSL value and its forward
  derivative in the variable), and the velocity.

The velocity is evaluated once per stage, a Python float per component
where it is constant, else an (E, Q) tensor: the kernels take b as data.
A velocity that reads the state, and a set of thermal and cdr modules,
take the module-set provider of ops/fused_set.py.

A steady call keeps its specialization, as the JAX package's
`_steady_check` does: no beta is read and there is no mass lane.

On 3D hex and p2 quads the same split and the same two modes run on the
element kernels (B1) instead, whose per-element rows the provider
scatters; the coord part is computed the same way.

Row classification follows from which leaves the coefficient
expressions read, not from a traced probe: a row is element-varying iff
its expression reads `x`/`y`/`z` (or the state), and the split holds iff no
coefficient reads the variable. For this weak form it reproduces the
JAX package's `_probe`/`_detect_affine` split, row indices and constant
values; an expression linear in the variable (a cdr reaction `2*c`) is
affine in JAX but takes the "full" path here, which computes the same
numbers.

Every wrapper runs its plain-torch version on CPU tensors (the CPU
tests exercise the same structure that runs on the card) and the CUDA
kernel on CUDA tensors; it counts its launches in LAUNCHES.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from mrhyde_tpu_torch.assembly.assembler import BlockJacobian
from mrhyde_tpu_torch.ops import fused_elem as fe
from mrhyde_tpu_torch.ops._launch import (LAUNCHES, check_qp, coeff_args,
                                          ptr, stage_args, stream,
                                          velocity_args)

__all__ = ["FusedP1Assembly", "QuadTables", "Stage", "LAUNCHES",
           "thermal_node_state", "thermal_node_full",
           "thermal_node_state_plain", "thermal_node_full_plain",
           "structured_geometry", "qp_coords", "steady_check"]

# local corners of the quad on (axis 0, axis 1), the assembler's order
CORNERS = ((0, 0), (1, 0), (1, 1), (0, 1))
QUAD_P1 = fe.Lattice(CORNERS, 1)
_COORD = {"x", "y", "z"}


class QuadTables:
    """The reference element's quadrature tables phi (nc, Q), grad (nc,
    Q, dim), wts (Q,): as Python floats for the plain versions (the JAX
    package's arithmetic on host scalars) and as device tensors for the
    kernels."""

    def __init__(self, phi, grad, wts, device, dtype):
        phi = np.asarray(phi, dtype=np.float64)
        grad = np.asarray(grad, dtype=np.float64)
        wts = np.asarray(wts, dtype=np.float64)
        if phi.ndim != 2 or grad.ndim != 3 or grad.shape[:2] != phi.shape \
                or wts.shape != phi.shape[1:]:
            raise ValueError("QuadTables wants phi (nc,Q), grad (nc,Q,dim), "
                             "wts (Q,)")
        self.nc, self.Q = phi.shape
        self.dim = int(grad.shape[2])
        self.phi, self.grad, self.wts = (phi.tolist(), grad.tolist(),
                                         wts.tolist())

        def dev(a):
            return torch.as_tensor(a, dtype=dtype, device=device).contiguous()
        self.t_phi, self.t_grad, self.t_wts = dev(phi), dev(grad), dev(wts)


def structured_geometry(asm):
    """(dims, origin, h_axes, q_off, QuadTables) of a uniform structured
    problem (2D or 3D): the element grid, the box origin and spacing,
    the quadrature points' offsets inside an element, and the reference
    tables of its first variable (all variables share them)."""
    s = asm._structured
    disc = asm.disc
    dims = tuple(int(d) for d in s["dims"])
    bounds = disc.mesh.box_info["bounds"]
    origin = [float(b[0]) for b in bounds]
    h_axes = [(float(b[1]) - float(b[0])) / int(b[2]) for b in bounds]
    q_off = np.asarray(disc.ip[0]) - np.asarray(origin)[None, :]
    key = disc.basis_keys[s["plan"][0][1]]
    tables = QuadTables(disc.basis_vals[key], disc.basis_grads[key][0],
                        disc.wts[0], asm.device, asm.dtype)
    return dims, origin, h_axes, q_off, tables


def qp_coords(dims, origin, h_axes, q_off, Q, dtype, device):
    """(x, y[, z]) at the quadrature points as (*dims, Q) tensors, from
    element indices as the JAX kernel synthesizes them."""
    dims = tuple(dims)
    out = []
    for a in range(len(dims)):
        shape = [1] * len(dims)
        shape[a] = dims[a]
        idx = torch.arange(dims[a], dtype=dtype, device=device) \
            .reshape(shape).expand(dims)
        out.append(torch.stack([origin[a] + idx * h_axes[a]
                                + float(q_off[q, a]) for q in range(Q)],
                               dim=-1))
    return out


def steady_check(tc):
    """The JAX package's _steady_check: TimeCoeffs equal to the steady
    ones (alpha_u = 1, alpha_t = 0, no betas) specialize to the steady
    kernels. Reads the betas on the host: callers cache it per stage."""
    return bool(tc.is_steady or (
        float(tc.alpha_t) == 0.0 and float(tc.alpha_u) == 1.0
        and not bool(tc.beta_u.any()) and not bool(tc.beta_t.any())))


class Stage(NamedTuple):
    """What a transient stage adds to the kernels: u_eval = alpha_u u +
    beta_u, u_dot = alpha_t u + beta_t, and the thermal mass coefficient
    m = rho cp (a Python float or an (E, Q) tensor; None for the NS
    kernel, whose density carries its own u_dot terms). Steady calls
    pass None."""
    alpha_u: float
    alpha_t: float
    mass: object


# ----------------------------------------------------------------------
# plain versions: the element rows of the quad's four corners
# (fused_elem's plain versions on the p1 lattice), summed to the node
# grid in the pad+sum order
# ----------------------------------------------------------------------

def thermal_node_state_plain(u_grid, kappa, tab, stage=None, vel=None):
    """Node residual of the state part scattered to the (N0+1, N1+1)
    node grid: sum_q w kappa grad phi_c . grad u_h (steady), or with a
    Stage sum_q w [m alpha_t u_h phi_c + kappa alpha_u grad phi_c .
    grad u_h]; with a velocity b, phi_c alpha_u b . grad u_h joins the
    sum. kappa, stage.mass, each velocity component: Python float or an
    (E, Q) tensor."""
    dims = (u_grid.shape[0] - 1, u_grid.shape[1] - 1)
    rows = fe.thermal_elem_state_plain(u_grid, kappa, tab, QUAD_P1, stage,
                                       vel)
    return fe.scatter_rows(rows, QUAD_P1, dims, u_grid)


def thermal_node_full_plain(u_grid, S, dS, K, dK, tab, stage=None,
                            vel=None):
    """(node residual (N0+1, N1+1), Jacobian rows (16, E)) of the full
    weak form at the u_eval grid `u_grid`, from the per-qp (E, Q)
    tensors S, dS/de, kappa, dkappa/de. With a Stage the columns carry
    alpha_u on the u_eval tangents and alpha_t m on the u_dot one; with
    a velocity S gains b . grad u_eval and column c' b . grad phi_c'."""
    dims = (u_grid.shape[0] - 1, u_grid.shape[1] - 1)
    rows, jac = fe.thermal_elem_full_plain(u_grid, S, dS, K, dK, tab,
                                           QUAD_P1, stage, vel)
    return fe.scatter_rows(rows, QUAD_P1, dims, u_grid), jac


# ----------------------------------------------------------------------
# kernel wrappers
# ----------------------------------------------------------------------

def _check_grid(u_grid, tab):
    if u_grid.device.type != "cuda":
        raise ValueError(f"thermal kernels take cpu or cuda tensors, not "
                         f"{u_grid.device}")
    if u_grid.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"thermal kernels take f32/f64, not {u_grid.dtype}")
    if (tab.nc, tab.dim) != (4, 2):
        raise ValueError(f"the node kernels take p1 quad tables, not "
                         f"nc = {tab.nc}, dim = {tab.dim}")
    if u_grid.dim() != 2 or min(u_grid.shape) < 2 \
            or not u_grid.is_contiguous():
        raise ValueError("u_grid must be a contiguous (N0+1, N1+1) grid "
                         "with N0, N1 >= 1")
    if max(u_grid.shape) > 2 ** 31 - 2:
        raise ValueError("node grid axis too long for int indexing")
    for t in (tab.t_phi, tab.t_grad, tab.t_wts):
        if t.device != u_grid.device or t.dtype != u_grid.dtype:
            raise ValueError("QuadTables live on another device/dtype "
                             "than u_grid")


def thermal_node_state(u_grid, kappa, tab, stage=None, vel=None):
    """The state-part node residual: CUDA kernel on a CUDA tensor, the
    plain version on a CPU tensor. kappa: Python float or (E, Q); stage:
    None (steady) or a Stage; vel: None or the velocity's two
    components."""
    if u_grid.device.type == "cpu":
        return thermal_node_state_plain(u_grid, kappa, tab, stage, vel)
    _check_grid(u_grid, tab)
    E = (u_grid.shape[0] - 1) * (u_grid.shape[1] - 1)
    kap = coeff_args(kappa, E, u_grid, tab, "kappa")
    st = stage_args(stage, E, u_grid, tab)
    va = velocity_args(vel, E, u_grid, tab)
    from mrhyde_tpu_torch.ops._build import load_library
    lib = load_library()
    fn = (lib.thermal_node_state_f64 if u_grid.dtype == torch.float64
          else lib.thermal_node_state_f32)
    out = torch.empty_like(u_grid)
    N0, N1 = u_grid.shape[0] - 1, u_grid.shape[1] - 1
    err = fn(ptr(u_grid), *kap, *st, *va, ptr(tab.t_phi), ptr(tab.t_grad),
             ptr(tab.t_wts), tab.Q, N0, N1, ptr(out), stream(u_grid))
    if err != 0:
        raise RuntimeError(f"thermal_node_state launch failed: CUDA error "
                           f"{err}")
    LAUNCHES["state"] += 1
    return out


def thermal_node_full(u_grid, S, dS, K, dK, tab, stage=None, vel=None):
    """(node residual, Jacobian rows (16, E)) of the full weak form at
    the u_eval grid: CUDA kernel on CUDA tensors, the plain version on
    CPU tensors. stage: None (steady) or a Stage; vel: None or the
    velocity's two components."""
    if u_grid.device.type == "cpu":
        return thermal_node_full_plain(u_grid, S, dS, K, dK, tab, stage,
                                       vel)
    _check_grid(u_grid, tab)
    E = (u_grid.shape[0] - 1) * (u_grid.shape[1] - 1)
    for name, t in (("S", S), ("dS", dS), ("K", K), ("dK", dK)):
        check_qp(t, E, u_grid, tab, name)
    st = stage_args(stage, E, u_grid, tab)
    va = velocity_args(vel, E, u_grid, tab)
    from mrhyde_tpu_torch.ops._build import load_library
    lib = load_library()
    fn = (lib.thermal_node_full_f64 if u_grid.dtype == torch.float64
          else lib.thermal_node_full_f32)
    N0, N1 = u_grid.shape[0] - 1, u_grid.shape[1] - 1
    out = torch.empty_like(u_grid)
    jac = torch.empty((16, N0 * N1), dtype=u_grid.dtype,
                      device=u_grid.device)
    err = fn(ptr(u_grid), ptr(S), ptr(dS), ptr(K), ptr(dK), *st, *va,
             ptr(tab.t_phi), ptr(tab.t_grad), ptr(tab.t_wts), tab.Q,
             N0, N1, ptr(out), ptr(jac), stream(u_grid))
    if err != 0:
        raise RuntimeError(f"thermal_node_full launch failed: CUDA error "
                           f"{err}")
    LAUNCHES["full"] += 1
    return out, jac


# ----------------------------------------------------------------------
# the provider
# ----------------------------------------------------------------------

class QpCtx:
    """Per-qp context for the coefficient expressions on (*dims, Q)
    tensors: the variable (`e`, `c`) resolves to u_eval at the qps and
    sol_dot to u_dot (0.0 in a steady call)."""

    def __init__(self, var, uq, coords, t, params, fm, udq=0.0):
        self.var = var
        self._u = uq
        self._ud = udq
        self.coords = coords
        self.t = t
        self.params = params
        self.fm = fm

    def sol_dot(self, v):
        return self._ud

    def f(self, name):
        return self.fm.evaluate(name, self)

    def resolve(self, leaf):
        if leaf == "x":
            return self.coords[0]
        if leaf == "y":
            return self.coords[1]
        if leaf == "z" and len(self.coords) > 2:
            return self.coords[2]
        if leaf == "t":
            return self.t
        if leaf in self.params:
            return self.params[leaf]
        if leaf == self.var:
            return self._u
        raise KeyError(f"fused assembly cannot resolve {leaf!r}")


class FusedP1Assembly:
    """Fused residual+Jacobian provider for qualifying problems: uniform
    structured 2D p1 quads (the node-scatter kernels, B2), 3D p1 hex and
    2D p2 quads (the element kernels of ops/fused_elem.py, B1); one
    scalar advection-diffusion-reaction module (thermal, with or without
    advection, or cdr), scalar params; steady calls and transient stages
    alike. `FusedP1Assembly.build(asm)` -> instance or None.

    `leaves` holds the terminal leaves of the module's coefficients
    (`fused_names`): kappa, the source S (without advection), the mass m
    and the velocity."""

    def __init__(self, asm, leaves):
        self.asm = asm
        s = asm._structured
        kind, self.var, self.start = s["plan"][0]
        (self.dims, self.origin, self.h_axes, self.q_off,
         self.tables) = structured_geometry(asm)
        self.dim = len(self.dims)
        # the JAX package's use_node: 2D p1 takes B2, the rest B1
        self.node = self.dim == 2 and kind == "p1"
        self.fine_idx = self.dof2fine = None
        if kind == "p1":
            self.lattice = fe.Lattice(tuple(tuple(c) for c in s["corners"]),
                                      1)
            self.grid_shape = tuple(d + 1 for d in self.dims)
        else:
            self.lattice = fe.basis_lattice(asm.disc.mesh.cell_type, 2)
            self._build_fine_maps()
        self.nc = len(self.lattice.offsets)
        self.fm = asm.fm
        self.module = asm.modules[0]
        kap, src, mass, vel = (leaves[k] for k in ("kappa", "source",
                                                   "mass", "velocity"))
        # affine split iff no coefficient reads the state (a velocity
        # that does is refused by `build`)
        self.split = self.var not in kap | src
        self._varying = {"kappa": bool(kap & _COORD),
                         "mass": bool(mass & _COORD),
                         "velocity": bool(vel & _COORD),
                         "coeffs": bool((kap | src | vel) & _COORD)}
        self.stats = self._stats(True)
        self._coords = None
        self._stage_cache = None

    def _build_fine_maps(self):
        """The variable's p2 fine lattice (2 N0 + 1, 2 N1 + 1)
        (`fused_elem.fine_lattice_maps`): fine_idx the global dof of each
        lattice point, dof2fine the lattice point of each dof."""
        fine, d2f = fe.fine_lattice_maps(self.asm.disc.lids, self.dims,
                                         self.lattice, [self.start])
        dev = self.asm.device
        self.grid_shape = fine.shape[1:]
        self.fine_idx = torch.as_tensor(fine[0], device=dev)
        self.dof2fine = torch.as_tensor(d2f[0], device=dev)

    def _stats(self, steady):
        """The JAX package's `stats` of a call: the split, and the rows
        each part writes per element (the coord rows once per stage)."""
        nc = self.nc
        if not self.split:
            return {"steady": steady, "split": False, "n_res_rows": nc,
                    "n_jac_rows": nc * nc, "node_scatter": self.node}
        v = self._varying
        if steady:
            res0 = nc if v["coeffs"] else 0
            jac0 = nc * nc if v["kappa"] or v["velocity"] else 0
        else:
            # the beta grids make the coord residual vary; the Jacobian
            # alpha_u (K_kappa + A_b) + alpha_t M_m varies with kappa, b
            # or m
            res0 = nc
            jac0 = nc * nc if v["kappa"] or v["mass"] or v["velocity"] \
                else 0
        return {"steady": steady, "split": True, "n_res_rows": nc,
                "n_jac_rows": 0, "coord_res_rows": res0,
                "coord_jac_rows": jac0, "node_scatter": self.node}

    @staticmethod
    def build(asm):
        """The fused provider of a qualifying problem: this provider for
        one thermal or cdr module, the Navier-Stokes one (ops/fused_ns.py)
        for an NS deck, and the module-set one (ops/fused_set.py) for a
        set of thermal and cdr modules or a velocity that reads the
        state; None where the problem takes the general path. A velocity
        that reads a gradient or a time derivative raises
        NotImplementedError."""
        from mrhyde_tpu_torch.physics.cdr import CDR
        from mrhyde_tpu_torch.physics.navierstokes import NavierStokes
        from mrhyde_tpu_torch.physics.thermal import Thermal
        if any(isinstance(m, NavierStokes) for m in asm.modules):
            from mrhyde_tpu_torch.ops.fused_ns import FusedNSAssembly
            return FusedNSAssembly.build(asm)
        from mrhyde_tpu_torch.ops.fused_set import FusedSetAssembly
        s = asm._structured
        cell = asm.disc.mesh.cell_type
        if s is None or (len(s["dims"]), cell) not in ((2, "quad"),
                                                      (3, "hex")):
            return None
        if not asm.uniform or not all(isinstance(m, (Thermal, CDR))
                                      for m in asm.modules):
            return None
        if len(asm.modules) != 1 or len(s["plan"]) != 1:
            # a set of thermal and cdr modules: the module-set kernels
            return FusedSetAssembly.build(asm)
        module = asm.modules[0]
        var = module.variables()[0][0]
        leaves = {k: set().union(*(asm.fm.terminal_leaves(n) for n in names))
                  for k, names in module.fused_names().items()}
        if any(lf.startswith("grad(") or lf.endswith("_t")
               for lf in leaves["velocity"]):
            raise NotImplementedError(
                f"an advection velocity that reads the state's gradient or "
                f"time derivative ({sorted(leaves['velocity'])}) is not "
                f"ported to mrhyde_tpu_torch yet (ROADMAP A10, CDR "
                f"remainder)")
        if var in leaves["velocity"]:
            return FusedSetAssembly.build(asm)
        for ls in leaves.values():
            # state derivatives (and z in 2D) are beyond the pointwise
            # context
            if any((lf == "z" and cell == "quad") or lf.startswith("grad(")
                   or lf.endswith("_t") for lf in ls):
                return None
        return FusedP1Assembly(asm, leaves)

    # ------------------------------------------------------------------

    def _grid(self, v):
        """The variable's grid in a dof vector: its node grid (p1) or its
        fine lattice (p2, a gather)."""
        if self.fine_idx is not None:
            return v[self.fine_idx]
        n = math.prod(self.grid_shape)
        return v[self.start:self.start + n].reshape(self.grid_shape)

    def _scatter(self, rows, like):
        """Per-element rows (nc entries, each (E,) or a scalar) summed to
        the variable's dofs, flat (the p2 fine lattice in dof order)."""
        grid = fe.scatter_rows(rows, self.lattice, self.dims, like)
        if self.fine_idx is None:
            return grid.reshape(-1)
        return grid.reshape(-1)[self.dof2fine]

    def _state_part(self, grid, kappa, stage, vel):
        """The residual of the split's state part on the variable's dofs
        (flat): B2 scatters in its kernel, B1's rows are scattered
        here."""
        if self.node:
            return thermal_node_state(grid, kappa, self.tables, stage,
                                      vel).reshape(-1)
        return self._scatter(fe.thermal_elem_state(
            grid, kappa, self.tables, self.lattice, stage, vel), grid)

    def _at_qps(self, grid):
        """u_h at the quadrature points of a grid, (*dims, Q)."""
        tab = self.tables
        uc = [v.reshape(self.dims)
              for v in fe.corner_values(grid, self.lattice)]
        return torch.stack([sum(tab.phi[c][q] * uc[c]
                                for c in range(self.nc))
                            for q in range(tab.Q)], dim=-1)

    def _qp_coords(self):
        """(x, y[, z]) at the quadrature points as (*dims, Q) tensors,
        from element indices as the JAX kernel synthesizes them."""
        if self._coords is None:
            self._coords = qp_coords(self.dims, self.origin, self.h_axes,
                                     self.q_off, self.tables.Q,
                                     self.asm.dtype, self.asm.device)
        return self._coords

    def _kernel_coeff(self, v):
        """A coefficient as the kernels take it: a Python float, or a
        contiguous (E, Q) tensor."""
        v = _scalar(v)
        if isinstance(v, torch.Tensor):
            return torch.broadcast_to(v, self.dims + (self.tables.Q,)) \
                .reshape(-1, self.tables.Q).contiguous()
        return v

    def _velocity(self, t, params):
        """The velocity as the kernels take it (`dim` Python floats or
        (E, Q) tensors), or None without advection."""
        vel = self.module.qp_velocity(QpCtx(
            self.var, 0.0, self._qp_coords(), t, params, self.fm))
        return None if vel is None else [self._kernel_coeff(b) for b in vel]

    def _stage(self, tc, params):
        """(steady, coord part or None, velocity) of a call, cached per
        stage. A stage is its TimeCoeffs' beta tensors (by identity and
        version, and held here, so their ids stay theirs), alphas, time,
        time step and params: the cache holds across one stage's Newton
        iterations, and two stages at the same time (Crank-Nicolson's
        stage 1 and the next step's stage 0, a retried step) never share
        it. A steady call reads no beta."""
        pkey = tuple(sorted((k, float(v)) for k, v in params.items()))
        if tc.is_steady:
            key, held = ("steady", float(tc.time), pkey), ()
        else:
            held = (tc.beta_u, tc.beta_t)
            key = (id(tc.beta_u), tc.beta_u._version, id(tc.beta_t),
                   tc.beta_t._version, float(tc.alpha_u),
                   float(tc.alpha_t), float(tc.time), float(tc.deltat),
                   pkey)
        if self._stage_cache is not None and self._stage_cache[0] == key:
            return self._stage_cache[2]
        steady = steady_check(tc)
        vel = self._velocity(tc.time, params)
        coord = self._coord_eval(tc, params, steady, vel) if self.split \
            else None
        self._stage_cache = (key, held, (steady, coord, vel))
        return steady, coord, vel

    def _coord_eval(self, tc, params, steady, vel):
        """The state-independent part of the affine split: (coord
        residual on the variable's dofs, nc*nc Jacobian rows, kappa and m
        for the state kernel). Steady: the residual at u = 0, sum_q w S0
        phi_c (plain torch; S0 = -f for thermal), and the Jacobian K_kappa
        + A_b, A_b[c][c'] = sum_q w phi_c b . grad phi_c'. A transient
        stage adds the residual of the beta grids, sum_q w [m beta_t,h
        phi_c + phi_c b . grad beta_u,h + kappa grad beta_u,h . grad
        phi_c], as two launches of the state kernel (on beta_u with alpha
        = (1, 0) and the velocity, on beta_t with alpha = (0, 1)), and its
        Jacobian is alpha_u (K_kappa + A_b) + alpha_t M_m."""
        tab, nc, dim = self.tables, self.nc, self.dim
        E = math.prod(self.dims)
        coords = self._qp_coords()
        like = coords[0]
        ctx = QpCtx(self.var, 0.0, coords, tc.time, params, self.fm)
        S0, kap = self.module.qp_coefficients(ctx)
        kap = _scalar(kap)
        rows = []
        for c in range(nc):
            acc = None
            for q in range(tab.Q):
                a = tab.wts[q] * (tab.phi[c][q] * _qslice(S0, q))
                acc = a if acc is None else acc + a
            rows.append(acc.reshape(E) if isinstance(acc, torch.Tensor)
                        and acc.dim() > 0 else acc)
        res0 = self._scatter(rows, like)
        kk = self._kernel_coeff(kap)
        mass = mk = None
        if not steady:
            mass = _scalar(self.module.qp_mass(ctx))
            mk = self._kernel_coeff(mass)
            res0 = (res0
                    + self._state_part(self._grid(tc.beta_u), kk,
                                       Stage(1.0, 0.0, mk), vel)
                    + self._state_part(self._grid(tc.beta_t), kk,
                                       Stage(0.0, 1.0, mk), None))
        # the velocity on the element grid, (*dims, Q) like kap
        bq = None if vel is None else [
            b.reshape(*self.dims, tab.Q) if isinstance(b, torch.Tensor)
            else b for b in vel]
        jac = []
        for c in range(nc):
            for cp in range(nc):
                acc = None
                for q in range(tab.Q):
                    kq = _qslice(kap, q)
                    gc, gp = tab.grad[c][q], tab.grad[cp][q]
                    # the JAX package's column tangents: alpha_t phi_c' on
                    # u_dot, alpha_u grad phi_c' on grad u_eval (steady:
                    # alpha_u = 1, no u_dot); ts the one of S
                    ts = None
                    if steady:
                        a = sum(gc[d] * (gp[d] * kq) for d in range(dim))
                        tg = gp
                    else:
                        au = tc.alpha_u
                        ts = (tc.alpha_t * tab.phi[cp][q]) * _qslice(mass, q)
                        a = sum(gc[d] * ((au * gp[d]) * kq)
                                for d in range(dim))
                        tg = [au * g for g in gp]
                    if bq is not None:
                        adv = sum(tg[d] * _qslice(bq[d], q)
                                  for d in range(dim))
                        ts = adv if ts is None else ts + adv
                    if ts is not None:
                        a = tab.phi[c][q] * ts + a
                    acc = tab.wts[q] * a if acc is None \
                        else acc + tab.wts[q] * a
                jac.append(acc.reshape(E) if isinstance(acc, torch.Tensor)
                           else acc)
        if not any(isinstance(j, torch.Tensor) for j in jac):
            # constant rows: one host-to-device copy, not nc*nc
            jac = list(torch.tensor(jac, dtype=like.dtype,
                                    device=like.device).unbind(0))
        return res0, jac, kk, mk

    def _qp_coefficients(self, ue_grid, ud_grid, tc, params):
        """Per-qp (E, Q) tensors S, dS/de, kappa, dkappa/de at the state,
        and m (None when steady): u_eval (and u_dot) at the qps by a
        plain gather, then the DSL value and its forward derivative in
        e."""
        tab = self.tables
        E = math.prod(self.dims)
        uq = self._at_qps(ue_grid)
        udq = 0.0 if ud_grid is None else self._at_qps(ud_grid)
        coords = self._qp_coords()
        shape = uq.shape

        def coeffs(uq_):
            ctx = QpCtx(self.var, uq_, coords, tc.time, params, self.fm,
                        udq)
            return tuple(torch.broadcast_to(
                torch.as_tensor(v, dtype=uq_.dtype, device=uq_.device),
                shape) for v in self.module.qp_coefficients(ctx))

        (S, K), (dS, dK) = torch.func.jvp(coeffs, (uq,),
                                          (torch.ones_like(uq),))
        mass = None
        if ud_grid is not None:
            mass = self._kernel_coeff(self.module.qp_mass(
                QpCtx(self.var, uq, coords, tc.time, params, self.fm, udq)))
        return [t.reshape(E, tab.Q).contiguous()
                for t in (S, dS, K, dK)], mass

    def res_jac(self, u, tc, pvec=None):
        """(residual (n_dof,), Jacobian rows: list of nc*nc entries, each
        None, a 0-d tensor or an (E,) tensor)."""
        asm = self.asm
        params = dict(asm.params)
        params.update(pvec or {})
        steady, coord, vel = self._stage(tc, params)
        self.stats = self._stats(steady)
        u_grid = self._grid(u)
        if self.split:
            res0, rows, kappa, mass = coord
            stage = None if steady else Stage(tc.alpha_u, tc.alpha_t, mass)
            node = res0 + self._state_part(u_grid, kappa, stage, vel)
        else:
            ue, ud = u_grid, None
            if not steady:
                ue = tc.alpha_u * u_grid + self._grid(tc.beta_u)
                ud = tc.alpha_t * u_grid + self._grid(tc.beta_t)
            (S, dS, K, dK), mass = self._qp_coefficients(ue, ud, tc, params)
            stage = None if steady else Stage(tc.alpha_u, tc.alpha_t, mass)
            if self.node:
                node, jac = thermal_node_full(ue, S, dS, K, dK, self.tables,
                                              stage, vel)
                node = node.reshape(-1)
            else:
                res, jac = fe.thermal_elem_full(ue, S, dS, K, dK,
                                                self.tables, self.lattice,
                                                stage, vel)
                node = self._scatter(res, ue)
            rows = list(jac.unbind(0))
        r = torch.zeros(asm.n_dof, dtype=u.dtype, device=u.device)
        r[self.start:self.start + node.numel()] = node
        return torch.where(asm.fixed, 0.0, r), rows

    def jacobian(self, u, tc, pvec=None):
        """(residual, BlockJacobian) with the kernel's SoA row layout."""
        r, rows = self.res_jac(u, tc, pvec)
        return r, BlockJacobian(vol=None, vol_lids=self.asm.lids,
                                fixed=self.asm.fixed, inc=self.asm.inc,
                                vol_soa=rows)


def _scalar(v):
    """A per-qp coefficient with its constants as Python floats."""
    if isinstance(v, torch.Tensor) and v.dim() > 0:
        return v
    return float(v)


def _qslice(v, q):
    """Quadrature point q of a (*dims, Q) tensor, or a scalar."""
    if isinstance(v, torch.Tensor) and v.dim() > 0:
        return v[..., q]
    return v
