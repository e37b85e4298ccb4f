"""Multiscale subgrid model: batched Dirichlet-to-Neumann fine solves.

The port of the JAX package's `mrhyde_tpu/multiscale/subgrid.py`
(reference: src/subgrid/subgridDtN2.cpp, subgridDtN_solver.cpp:136
solve, :1485 updateFlux; the macro hookup at assemblyManager.cpp:2391):

- every macro element owns a fine mesh refined from the macro cell
  ('refinements' in the subgrid deck);
- the fine problem couples to the macro trace lambda through Nitsche
  "interface" boundary terms (the physics modules' boundary_residual);
- the upscaled macro residual is the boundary integral of the modules'
  compute_flux against the macro basis (subgridDtN_solver.cpp:1589).

All fine solves of a chunk of macro elements run as one batched program
on the problem's device: `torch.func.vmap` over the macro elements, in
each a fixed-count fine Newton (exactly `max nonlinear iters` steps, as
the JAX package runs) whose dense fine Jacobian is assembled from the
element blocks of `torch.func.jacfwd` and solved by batched
`torch.linalg.solve`. The macro Jacobian is `torch.func.jacfwd` through
that same fixed-count Newton, times alpha_u: the JAX package's
derivative, not the implicit-function one. The chunk of macro elements
one batched call takes comes from the problem's size and the device's
free memory; chunking changes no number.

Two geometry regimes (reference: subgridTools.cpp): translation-uniform
quad / hex macro meshes build the fine tables once on a representative
macro element, each element adding its quadrature-point offset; any
other macro mesh (simplices, distorted cells, Exodus fine templates)
carries per-macro-element fine tables (multiscale/geometry.py).

`MultiscaleModels` holds several models over disjoint macro-element
subsets (usage voting per virtual rank and workset group, dynamic
re-votes with L2 state transfer, ML selection).
"""

from __future__ import annotations

import os

import numpy as np
import torch
from torch.utils._pytree import tree_map

from mrhyde_tpu_torch.assembly.assembler import _fold_W, build_incidence
from mrhyde_tpu_torch.runtime import free_bytes

__all__ = ["SubgridDtN", "MultiscaleModels"]

# bytes a batched fine solve holds per macro element, per entry of its
# dense fine Jacobian and per tangent: the Jacobian, its LU factors and
# the solve's and the element blocks' temporaries
_BYTES_PER_ENTRY = 6


def _res_and_jac(fn):
    """jacfwd of fn in its first argument returning (J, fn's value)."""
    def both(*args):
        r = fn(*args)
        return r, r
    return torch.func.jacfwd(both, argnums=0, has_aux=True)


class SubgridDtN:
    def __init__(self, problem, subgrid_cfg: dict, elems=None, label=0):
        from mrhyde_tpu_torch.assembly.assembler import Assembler
        from mrhyde_tpu_torch.assembly.discretization import Discretization
        from mrhyde_tpu_torch.fem.basis import get_basis
        from mrhyde_tpu_torch.fem.topology import cell_topology
        from mrhyde_tpu_torch.functions.manager import FunctionManager
        from mrhyde_tpu_torch.mesh.structured import Mesh, box_mesh
        from mrhyde_tpu_torch.physics.registry import import_physics

        self.problem = problem
        self.device, self.dtype = problem.device, problem.dtype
        cfg = subgrid_cfg.get("Subgrid", subgrid_cfg)
        self.cfg = cfg
        self.model = cfg.get("subgrid model", "DtN2")
        self.label = int(label)          # reported as "Subgrid {label}:"
        mesh_cfg = cfg.get("Mesh", {}) or {}
        n1 = 2 ** int(mesh_cfg.get("refinements", 1))
        macro_mesh = problem.mesh
        dim = macro_mesh.dim
        cell = macro_mesh.cell_type

        # the macro elements this model owns (multimodel decks assign
        # disjoint subsets by usage votes; default: all of them)
        n_macro = macro_mesh.conn.shape[0]
        self.elems = (np.arange(n_macro) if elems is None
                      else np.asarray(elems, dtype=int))
        self.owns_all = self.elems.size == n_macro
        sub_coords = macro_mesh.nodes[macro_mesh.conn][self.elems]
        cents = sub_coords.mean(axis=1)
        spans = sub_coords.max(axis=1) - sub_coords.min(axis=1)
        deck_dir = (problem.cfg or {}).get("_deck_dir", ".")
        is_exo = str(mesh_cfg.get("mesh type", "")).lower() == "exodus"
        # fast path: translation-uniform quad / hex subsets share ONE set
        # of fine tables; anything else batches per-macro geometry
        self.general = (cell not in ("quad", "hex") or is_exo
                        or not np.allclose(spans, spans[0], rtol=1e-12))
        self.offsets_np = cents - cents[0]
        self._side_map = None
        self._geo_np = None
        self._geo_cache = {}

        if self.general:
            from mrhyde_tpu_torch.multiscale.geometry import fine_template
            ref_fine, self._side_map = fine_template(mesh_cfg, cell, dim,
                                                     deck_dir)
            fine_mesh = ref_fine        # structure only (ref coords)
        else:
            # the representative fine mesh in macro reference coordinates
            box = dict(nx=n1, ny=n1, xmin=-1.0, xmax=1.0, ymin=-1.0,
                       ymax=1.0)
            if cell == "hex":
                box.update(nz=n1, zmin=-1.0, zmax=1.0)
            ref_fine = box_mesh(cell, **box)
            # mapped into the first macro element (translation-uniform)
            gvals = get_basis(cell, "HGRAD", 1).eval(ref_fine.nodes)
            fine_mesh = Mesh(dim=dim, cell_type=cell,
                             nodes=np.einsum("cd,cn->nd", sub_coords[0],
                                             gvals),
                             conn=ref_fine.conn,
                             sidesets=dict(ref_fine.sidesets))
        self.ref_fine = ref_fine

        # the fine physics from the subgrid deck; 'Active variables'
        # restricts the fine variables and may override their spaces
        # (reference porousWeakGalerkin.cpp:22-39)
        phys_cfg = cfg.get("Physics", {}) or {}
        self.fine_modules = import_physics(phys_cfg.get("modules", ""),
                                           phys_cfg, dim)
        disc_cfg = cfg.get("Discretization", {}) or {}
        orders = disc_cfg.get("order", {}) or {}
        active = phys_cfg.get("Active variables", {}) or {}
        variables = []
        for m in self.fine_modules:
            for (name, space, dflt) in m.variables():
                if active and name not in active:
                    continue
                space = active.get(name, space)
                order = int(orders.get(name, dflt))
                variables.append((name, space,
                                  order if space != "HVOL" else 0))
        self.fine_vars = [v[0] for v in variables]

        self.fm = FunctionManager()
        fs = cfg.get("Functions", {}) or {}
        for name, expr in fs.items():
            self.fm.add_function(name, expr, "ip")
            self.fm.add_function(name, expr, "side ip")
        for m in self.fine_modules:
            m.define_functions(self.fm, fs)

        qdeg = disc_cfg.get("quadrature")
        qdeg = None if qdeg is None else int(qdeg)
        self.fine_disc = Discretization(fine_mesh, variables, qdeg)
        self.fa = Assembler(self.fine_disc, self.fine_modules, self.fm,
                            problem.params, dtype=self.dtype,
                            device=self.device)
        # every fine boundary side couples to the macro trace
        self.fa.var_bcs = {v: {ss: "interface" for ss in fine_mesh.sidesets}
                           for v in self.fine_vars}
        self.n_fine_dof = self.fine_disc.n_dof
        self._build_incidence()

        # per-(macro, fine element) data from files, by the closest data
        # point to each fine element's PHYSICAL center (the subgrid decks
        # with 'data file' in their Mesh sublist)
        self._extra_np = None
        self._extra_bnd_np = None
        data_tag = str(mesh_cfg.get("data file", "none"))
        if data_tag != "none":
            self._import_data(mesh_cfg, data_tag, deck_dir, sub_coords,
                              ref_fine, cell, dim)
        sol_cfg = cfg.get("Solver", {}) or {}
        self.newton_iters = int(sol_cfg.get("max nonlinear iters", 2))
        # asynchronous stepping: the fine problem substeps through each
        # macro step with its own tableau
        self.sync = bool(sol_cfg.get("synchronous time stepping", True))
        self.sub_steps = int(sol_cfg.get("number of steps", 1))
        self.fine_tableau = sol_cfg.get("transient Butcher tableau", "BWE")

        # the macro basis at the fine interface quadrature points
        if self.general:
            from mrhyde_tpu_torch.multiscale.geometry import \
                build_batched_geo
            ref_disc = self.fine_disc       # already in macro ref coords
            self._geo_np = build_batched_geo(sub_coords, ref_fine, cell,
                                             variables, qdeg)
            smap = self._side_map
        else:
            ref_disc = Discretization(ref_fine, variables, qdeg)
            smap = ({"bottom": 0, "right": 1, "top": 2, "left": 3}
                    if cell == "quad" else
                    {"back": 0, "front": 1, "bottom": 2, "right": 3,
                     "top": 4, "left": 5})
        macro_nside = len(cell_topology(cell).sides)
        self._groups = []
        for gi, bg in enumerate(self.fine_disc.boundary_groups):
            rbg = ref_disc.boundary_groups[gi]
            assert rbg.sideset == bg.sideset \
                and np.array_equal(rbg.elems, bg.elems)
            self._groups.append(self._macro_basis(
                problem, rbg, smap[bg.sideset], macro_nside, cell, dim))

        # fine var -> macro var of the same name; the pressure-trace
        # macro variable may also be named p / lambda / pbndry / pint
        # (reference alias scans: porousMixed.cpp:525-541,
        # porousWeakGalerkin.cpp:583-590)
        offs = problem.disc.offsets
        self.var_map = {v: v for v in self.fine_vars if v in offs}
        alias = ("p", "pint", "lambda", "pbndry")
        un_macro = [mv for mv in offs
                    if mv in alias and mv not in self.var_map.values()]
        un_fine = [fv for fv in alias
                   if fv in self.fine_vars and fv not in self.var_map]
        if len(un_macro) == 1 and un_fine:
            self.var_map[un_fine[0]] = un_macro[0]
        # transient fine state (reference subgridDtN_solver.cpp:81-86;
        # solve() :280-330 copies the MACRO tableau and BDF weights into
        # the fine workset): fine_prev (E, hist, n_fine_dof)
        self.fine_prev = None
        # dynamic multimodel: (E,) 0/1 ownership mask (None = static)
        self.mask = None
        self._sub_cache = None
        # the process-group communicator the fine solves are spread over
        # (enable_device_sharding), or None: every macro element here
        self._comm = None

    # ------------------------------------------------------------------
    # set-up helpers
    # ------------------------------------------------------------------

    def _t(self, a, dtype=None):
        return torch.as_tensor(np.asarray(a), dtype=dtype or self.dtype,
                               device=self.device)

    def _build_incidence(self):
        """Gather-sum tables that assemble the fine residual (n_fine_dof)
        and the dense fine Jacobian (n_fine_dof^2) from the element and
        boundary-side blocks, in that order (deterministic, no atomics)."""
        nfd = self.n_fine_dof
        lids = [np.asarray(self.fine_disc.lids)] + [
            np.asarray(bg.lids) for bg in self.fine_disc.boundary_groups]
        self._res_inc = self._t(build_incidence(
            np.concatenate([lid.ravel() for lid in lids]), nfd), torch.int64)
        ids = np.concatenate([(lid[:, :, None] * nfd + lid[:, None, :])
                              .ravel() for lid in lids])
        self._jac_inc = self._t(build_incidence(ids, nfd * nfd), torch.int64)

    def _import_data(self, mesh_cfg, data_tag, deck_dir, sub_coords,
                     ref_fine, cell, dim):
        from mrhyde_tpu_torch.fem.basis import get_basis
        from mrhyde_tpu_torch.native import nearest_point
        pts_tag = str(mesh_cfg.get("data points file", "mesh_data_pts"))
        pts = np.loadtxt(os.path.join(deck_dir, pts_tag + ".dat"), ndmin=2)
        vals = np.loadtxt(os.path.join(deck_dir, data_tag + ".dat"),
                          ndmin=2)
        rc = ref_fine.nodes[ref_fine.conn].mean(axis=1)      # (Ef, dim)
        gv = get_basis(cell, "HGRAD", 1).eval(rc)            # (nv, Ef)
        fc = np.einsum("ecd,cf->efd", sub_coords, gv)        # (E, Ef, dim)
        nearest = nearest_point(pts[:, :dim], fc.reshape(-1, dim)).reshape(
            fc.shape[:2])
        if mesh_cfg.get("have mesh data rotations", False):
            from mrhyde_tpu_torch.physics.crystal_elasticity import \
                CrystalElasticity
            R = vals[nearest].reshape(nearest.shape + (3, 3))[
                ..., :dim, :dim]
            for m in self.fine_modules:
                if isinstance(m, CrystalElasticity):
                    Ce = np.einsum("efia,efjb,efkc,efld,abcd->efijkl",
                                   R, R, R, R, m.C_ref)
                    self._extra_np = {"crystal_C": Ce.reshape(
                        Ce.shape[0], Ce.shape[1], -1)}
        else:
            self._extra_np = {"mesh_data": vals[nearest, 0]}
        if self._extra_np is not None:
            # per-boundary-group slices (macro, group sides, ...)
            self._extra_bnd_np = [
                {k: v[:, bg.elems] for k, v in self._extra_np.items()}
                for bg in self.fine_disc.boundary_groups]

    def _macro_basis(self, problem, rbg, sidx, macro_nside, cell, dim):
        """{macro var: (ndm, B, Qf)} macro basis at one fine boundary
        group's quadrature points (macro reference coordinates)."""
        from mrhyde_tpu_torch.fem.basis import get_basis
        B, Qf = rbg.ip.shape[0], rbg.ip.shape[1]
        phi = {}
        for mv, key in problem.disc.basis_keys.items():
            if key[0] == "HFACE":
                if key[1] == 0:
                    # facet constants (any dim): the indicator of the
                    # macro side this group lies on
                    full = np.zeros((macro_nside, B, Qf))
                    full[sidx] = 1.0
                    phi[mv] = self._t(full)
                    continue
                if dim != 2 or cell != "quad":
                    raise NotImplementedError(
                        "HFACE order >= 1 multiscale traces only on quad "
                        "macro cells")
                from mrhyde_tpu_torch.fem.vector_basis import \
                    hface_side_vals
                # the side parameter follows the reference quad's local
                # edge direction (flips live in the dof numbering)
                pts = rbg.ip
                param = {0: pts[..., 0], 1: pts[..., 1], 2: -pts[..., 0],
                         3: -pts[..., 1]}[sidx]
                npe = key[1] + 1
                full = np.zeros((4 * npe, B, Qf))
                full[sidx * npe:(sidx + 1) * npe] = hface_side_vals(
                    key[1], param.ravel()).reshape(npe, B, Qf)
                phi[mv] = self._t(full)
                continue
            mb = get_basis(problem.mesh.cell_type, key[0], key[1])
            phi[mv] = self._t(mb.eval(rbg.ip.reshape(-1, dim)).reshape(
                mb.ndof, B, Qf))
        return phi

    # ------------------------------------------------------------------
    # transient fine state (synchronous with the macro integrator, which
    # threads the stage weights and the fine history through
    # pvec["__ms"])
    # ------------------------------------------------------------------

    def n_macro_elems(self):
        return self.offsets_np.shape[0]

    def init_history(self, hist: int, dtype, t0=0.0) -> None:
        """Zero fine history at the transient start, or the subgrid
        deck's initial conditions L2-projected (reference
        subgridDtN_solver setInitial)."""
        E = self.n_macro_elems()
        self.fine_prev = torch.zeros((E, max(hist, 1), self.n_fine_dof),
                                     dtype=dtype, device=self.device)
        ics = (self.cfg.get("Physics", {}) or {}).get(
            "Initial conditions", {}) or {}
        if ics:
            u0 = self._project_initial(ics, dtype)         # (E, nfd)
            self.fine_prev = u0[:, None, :].expand(
                self.fine_prev.shape).clone()

    def _fine_points(self, dtype):
        """(ips (E, Ef, Q, dim), wts (E or 1, Ef, Q)) of the fine volume
        quadrature in every macro element."""
        if self.general:
            return (self._t(self._geo_np["ip"], dtype),
                    self._t(self._geo_np["wts"], dtype))
        disc = self.fine_disc
        offs = self._t(self.offsets_np, dtype)
        return (self._t(disc.ip, dtype)[None] + offs[:, None, None, :],
                self._t(disc.wts, dtype)[None])

    def _project_initial(self, ics: dict, dtype):
        """L2 projection of the subgrid deck's initial-condition
        expressions onto the fine space, per macro element (reference:
        the subgrid solver's setInitial)."""
        from mrhyde_tpu_torch.assembly.assembler import PointContext
        disc = self.fine_disc
        E, nfd = self.n_macro_elems(), self.n_fine_dof
        lids = np.asarray(disc.lids)
        if self.general:
            Mb = np.asarray(self._geo_np["mass"])      # (E, Ef, ndt, ndt)
            M = np.zeros((E, nfd, nfd))
            np.add.at(M, (np.arange(E)[:, None, None, None],
                          lids[None, :, :, None], lids[None, :, None, :]),
                      Mb)
        else:
            M = np.zeros((nfd, nfd))
            np.add.at(M, (lids[:, :, None], lids[:, None, :]),
                      np.asarray(disc.mass_blocks()))
            M = M[None]
        ips, wts = self._fine_points(dtype)
        b = torch.zeros((E, nfd), dtype=dtype, device=self.device)
        ctx = PointContext(ips, 0.0, self.problem.params)
        for var, expr in ics.items():
            if var not in disc.offsets:
                continue
            st, nd = disc.offsets[var]
            phi = self._t(disc.basis_vals[disc.basis_keys[var]], dtype)
            vals = torch.broadcast_to(torch.as_tensor(
                self.fm.evaluate_expr(str(expr), ctx), dtype=dtype,
                device=self.device), ips.shape[:3])
            contrib = torch.einsum("iq,beq->bei", phi, vals * wts)
            lv = torch.as_tensor(lids[:, st:st + nd].ravel(),
                                 device=self.device)
            b = b.index_put((torch.arange(E, device=self.device)[:, None],
                             lv[None, :]), contrib.reshape(E, -1),
                            accumulate=True)
        M = self._t(M, dtype).expand(E, nfd, nfd)
        return torch.linalg.solve(M, b)

    def blank_stages(self, nstage: int, dtype):
        return torch.zeros((self.n_macro_elems(), nstage, self.n_fine_dof),
                           dtype=dtype, device=self.device)

    def commit_step(self, fine_stages, nstage: int) -> None:
        """Finish the fine step: stages combined as the macro update
        (u += z_s - u_prev0), the BDF history shifted."""
        self.fine_prev = _shift(self.fine_prev,
                                _combine(self.fine_prev, fine_stages, nstage))

    @staticmethod
    def _unpack_ms(pvec, E, nfd, dtype, device):
        ms = (pvec or {}).get("__ms")
        if ms is None:
            z1 = torch.zeros((E, 1, nfd), dtype=dtype, device=device)
            z0 = torch.zeros((1,), dtype=dtype, device=device)
            return z1, z1, z0, z0
        return ms["prev"], ms["stages"], ms["sw"], ms["bw"]

    @staticmethod
    def _strip_ms(pvec):
        if pvec and "__ms" in pvec:
            return {k: v for k, v in pvec.items() if k != "__ms"}
        return pvec

    # ------------------------------------------------------------------
    # the fine problem of one macro element (vmapped over the macro axis)
    # ------------------------------------------------------------------

    def _percell(self, dtype):
        """The per-macro-element geometry tree the fine solves vmap over:
        {"off": translation offsets} on the uniform path, the batched
        physical tables otherwise; the data-file fields beside."""
        key = str(dtype)
        if key in self._geo_cache:
            return self._geo_cache[key]

        def conv(a):
            return tree_map(lambda x: self._t(x, dtype), a)
        if not self.general:
            out = {"off": conv(self.offsets_np)}
        else:
            g = self._geo_np
            out = {"wts": conv(g["wts"]), "ip": conv(g["ip"]),
                   "bg": conv(g["bg"]),
                   "bnd": [{k: conv(b[k]) for k in ("wts", "ip", "normals",
                                                    "bg")}
                           for b in g["bnd"]]}
        if self._extra_np is not None:
            out["extra"] = conv(self._extra_np)
            out["extra_bnd"] = conv(self._extra_bnd_np)
        self._geo_cache[key] = out
        return out

    def _fine_parts(self, uf, bu_f, bt_f, geo, aux, coeffs, params, jac):
        """The residual of one macro element's fine problem (n_fine_dof,)
        at uf, and with jac its dense Jacobian (n_fine_dof, n_fine_dof):
        the element and side blocks of torch.func.jacfwd, assembled.
        coeffs: (alpha_u, alpha_t, time, deltat); u_eval = alpha_u uf +
        bu_f, u_dot = alpha_t uf + bt_f; aux: per boundary group {"aux
        <var>": (B, Qf)} macro traces."""
        fa = self.fa
        au, at, time, deltat = coeffs
        kw = dict(alpha_u=au, alpha_t=at, time=time, params=params,
                  deltat=deltat)
        u_e, bu_e, bt_e = uf[fa.lids], bu_f[fa.lids], bt_f[fa.lids]
        if fa.has_signs:
            u_e, bu_e, bt_e = (_fold_W(v, fa.signs, fa.mixp, fa.mixw)
                               for v in (u_e, bu_e, bt_e))

        def efn(u, bu, bt, wts, ip, bg, ex):
            return fa._elem_residual(u, bu, bt, wts, ip, bg, ex, **kw)
        ex = geo.get("extra")
        if "off" in geo:
            off = geo["off"]
            vargs = (fa.g_wts, fa.g_ip + off, fa.g_bg)
            vdims = (fa._geo_ax, 0, fa._geo_ax)
        else:
            vargs = (geo["wts"], geo["ip"], geo["bg"])
            vdims = (0, 0, 0)
        in_dims = (0, 0, 0) + vdims + (None if ex is None else 0,)
        res, blocks = [], []
        if jac:
            J_e, r_e = torch.func.vmap(_res_and_jac(efn), in_dims=in_dims)(
                u_e, bu_e, bt_e, *vargs, ex)
            if fa.has_signs:
                J_e = fa._fold_jac(J_e)
            blocks.append(J_e)
        else:
            r_e = torch.func.vmap(efn, in_dims=in_dims)(
                u_e, bu_e, bt_e, *vargs, ex)
        res.append(fa._fold_res(r_e))
        exb = geo.get("extra_bnd")
        for gi, (g, aux_g) in enumerate(zip(fa._bnd, aux)):
            u_b, bu_b, bt_b = uf[g["lids"]], bu_f[g["lids"]], bt_f[g["lids"]]
            if fa.has_signs:
                u_b, bu_b, bt_b = (v * g["signs"] for v in (u_b, bu_b, bt_b))
            if exb is not None:
                aux_g = {**aux_g, **exb[gi]}
            if "off" in geo:
                bargs = (g["wts"], g["ip"] + off, g["normals"], g["bg"])
            else:
                gb = geo["bnd"][gi]
                bargs = (gb["wts"], gb["ip"], gb["normals"], gb["bg"])

            def bfn(u, bu, bt, wts, ip, nrm, bg, ax, g=g):
                return fa._belem_residual(g, u, bu, bt, wts, ip, nrm, bg,
                                          None, ax, **kw)
            if jac:
                J_b, r_b = torch.func.vmap(_res_and_jac(bfn))(
                    u_b, bu_b, bt_b, *bargs, aux_g)
                if fa.has_signs:
                    s = g["signs"]
                    J_b = J_b * s[:, :, None] * s[:, None, :]
                blocks.append(J_b)
            else:
                r_b = torch.func.vmap(bfn)(u_b, bu_b, bt_b, *bargs, aux_g)
            res.append(r_b * g["signs"] if fa.has_signs else r_b)
        r = _gather_sum(res, self._res_inc)
        if not jac:
            return r, None
        nfd = self.n_fine_dof
        return r, _gather_sum(blocks, self._jac_inc).reshape(nfd, nfd)

    def _fine_residual(self, uf, bu_f, bt_f, geo, aux, coeffs, params):
        return self._fine_parts(uf, bu_f, bt_f, geo, aux, coeffs, params,
                                False)[0]

    def _newton(self, z, bu, bt, geo, aux, coeffs, params):
        """Exactly newton_iters fine Newton steps from z (the JAX
        package's fixed count: no convergence test, so the macro
        Jacobian differentiates the same steps)."""
        for _ in range(self.newton_iters):
            r, J = self._fine_parts(z, bu, bt, geo, aux, coeffs, params,
                                    True)
            z = z - torch.linalg.solve(J, r)
        return z

    def _elem_ms_residual(self, lam_e, geo, tc, params, prev_e, stages_e,
                          sw, bw):
        """The upscaled residual of one macro element (ndof_macro,) and
        its fine STAGE solution. lam_e: the EVALUATED macro trace
        coefficients (alpha_u z + beta_u); prev_e (Hf, nfd), stages_e (S,
        nfd): the fine history and stages; sw (S,): A(s,r)/b(r) (zero for
        r >= s); bw (Hf,): BDF history weights times timewt."""
        aux = self._make_aux(lam_e)
        # fine seeding vectors from the fine history (the macro stage
        # algebra of solvers/time_integration.py)
        bu_f = (1.0 - tc.alpha_u) * prev_e[0] + torch.einsum(
            "s,sn->n", sw, stages_e - prev_e[0][None])
        bt_f = torch.einsum("h,hn->n", bw, prev_e)
        coeffs = (tc.alpha_u, tc.alpha_t, tc.time, tc.deltat)
        uf = self._newton(prev_e[0], bu_f, bt_f, geo, aux, coeffs, params)
        # the flux at the fine stage's EVALUATED solution (reference
        # subgridDtN_solver.cpp:1485 updateFlux)
        res = self._flux_upscale(tc.alpha_u * uf + bu_f,
                                 tc.alpha_t * uf + bt_f, geo, aux, tc,
                                 params)
        return res, uf

    def _make_aux(self, lam_vec):
        """Per boundary group {"aux <var>": (B, Qf)} macro traces, keyed by
        the fine and the macro name."""
        aux = []
        for phi in self._groups:
            aux_g = {}
            for fv, mv in self.var_map.items():
                st, nd = self.problem.disc.offsets[mv]
                val = torch.einsum("m,mbq->bq", lam_vec[st:st + nd],
                                   phi[mv])
                aux_g[f"aux {fv}"] = val
                aux_g.setdefault(f"aux {mv}", val)
            aux.append(aux_g)
        return aux

    def _elem_ms_async(self, lam_e, lam_prev_e, geo, tc, params, prev_e,
                       t_prev):
        """Asynchronous subgrid: the fine problem substeps through the
        macro step with its own tableau, the macro trace Lagrange-
        interpolated in time (reference subgridDtN_solver.cpp:339-442,
        lagrangeInterpolate :564-620). lam_prev_e: (H, ndm) the macro
        trace at the previous step times; H = 1 interpolates linearly, H
        = 2 quadratically."""
        from mrhyde_tpu_torch.solvers.time_integration import (
            bdf_weights, butcher_tableau)
        A_f, b_f, c_f = butcher_tableau(self.fine_tableau)
        w_f = bdf_weights(1)            # fine substeps: BDF1 history
        nst = len(b_f)
        dt = tc.deltat
        sgdt = dt / self.sub_steps
        nprev = lam_prev_e.shape[0]

        def lam_at(t_s):
            if nprev == 1:
                return ((t_prev + dt - t_s) / dt * lam_prev_e[0]
                        + (t_s - t_prev) / dt * lam_e)
            tn, tn1, tn2 = t_prev + dt, t_prev, t_prev - dt
            a1 = ((t_s - tn2) * (tn - t_s)) / (dt * dt)
            a2 = -((tn - t_s) * (t_s - tn1)) / (2 * dt * dt)
            a0 = ((t_s - tn2) * (t_s - tn1)) / (2 * dt * dt)
            return a1 * lam_prev_e[0] + a2 * lam_prev_e[1] + a0 * lam_e

        cur = prev_e[0]
        u_dt = torch.zeros_like(cur)
        for n in range(self.sub_steps):
            start = cur
            stage_vals = []
            for s in range(nst):
                t_s = t_prev + n * sgdt + c_f[s] * sgdt
                aux = self._make_aux(lam_at(t_s))
                au = float(A_f[s, s] / b_f[s])
                timewt = 1.0 / (sgdt * b_f[s])
                at = float(w_f[0] * timewt)
                bu = (1.0 - au) * start
                for r in range(s):
                    bu = bu + float(A_f[s, r] / b_f[r]) * (stage_vals[r]
                                                           - start)
                bt = float(w_f[1] * timewt) * start
                z = self._newton(start, bu, bt, geo, aux,
                                 (au, at, float(t_s), sgdt), params)
                stage_vals.append(z)
                u_dt = at * z + bt
                cur = cur + z - start if nst > 1 else z
        # the flux at the end of the macro step, the trace the current
        # lambda
        res = self._flux_upscale(cur, u_dt, geo, self._make_aux(lam_e), tc,
                                 params)
        return res, cur

    def _flux_upscale(self, u_ev, u_dt, geo, aux, tc, params):
        """res_macro_i = sum over sides of int flux phi_macro_i
        (ndof_macro,)."""
        fa = self.fa
        offs = self.problem.disc.offsets
        parts = {mv: 0.0 for mv in offs}
        exb = geo.get("extra_bnd")
        for gi, (g, phi, aux_g) in enumerate(zip(fa._bnd, self._groups,
                                                 aux)):
            u_b, ud_b = u_ev[g["lids"]], u_dt[g["lids"]]
            if fa.has_signs:
                u_b, ud_b = u_b * g["signs"], ud_b * g["signs"]
            if exb is not None:
                aux_g = {**aux_g, **exb[gi]}
            if "off" in geo:
                gb = dict(wts=g["wts"], ip=g["ip"] + geo["off"],
                          normals=g["normals"], bg=g["bg"])
            else:
                gb = geo["bnd"][gi]

            def flux_fn(u, ud, w, ip, nrm, bg, ax, g=g):
                wk = fa._workset(w, ip, g["bv"], bg, u, ud, tc.time, params,
                                 tc.deltat, normals=nrm,
                                 side_name=g["sideset"], bcs={},
                                 extra_fields=ax)
                out = {}
                for m in self.fine_modules:
                    f = m.compute_flux(wk)
                    if f:
                        out.update(f)
                return out
            flux = torch.func.vmap(flux_fn)(u_b, ud_b, gb["wts"], gb["ip"],
                                            gb["normals"], gb["bg"], aux_g)
            for fv, mv in self.var_map.items():
                parts[mv] = parts[mv] + torch.einsum(
                    "mbq,bq->m", phi[mv], flux[fv] * gb["wts"])
        ref = u_ev.new_zeros(())
        return torch.cat([
            (parts[mv] if torch.is_tensor(parts[mv])
             else ref.expand(nd)).reshape(nd)
            for mv, (st, nd) in sorted(offs.items(),
                                       key=lambda kv: kv[1][0])])

    # ------------------------------------------------------------------
    # the macro contributions
    # ------------------------------------------------------------------

    def _sub_lids(self):
        lids = self.problem.assembler.lids
        if self.owns_all:
            return lids
        return lids[torch.as_tensor(self.elems, device=lids.device)]

    def _macro_traces(self, u_macro, tc):
        """(E, ndm) EVALUATED macro trace coefficients: the fine problem
        couples to u_eval = alpha_u z + beta_u, not to the stage unknown
        (reference subgridDtN_solver.cpp:305 fluxwt)."""
        return (tc.alpha_u * u_macro + tc.beta_u)[self._sub_lids()]

    def _is_async(self, pvec):
        ms = (pvec or {}).get("__ms")
        return ms is not None and "lam_prev" in ms

    def _elem_fn(self, u_macro, tc, pvec):
        """(fn, args): fn(lam_e, ...) -> (res_e, uf_e) of one macro
        element, and its arguments (each a tree with a leading macro
        axis)."""
        dtype = u_macro.dtype
        geo = self._percell(dtype)
        params = self.fa._params(self._strip_ms(pvec))
        lam = self._macro_traces(u_macro, tc)
        if self._is_async(pvec):
            ms = pvec["__ms"]
            lam_prev = ms["lam_prev"][:, self._sub_lids()].movedim(0, 1)
            t_prev = float(ms["t_prev"])

            def fn(lam_e, lam_pe, geo_e, prev_e):
                return self._elem_ms_async(lam_e, lam_pe, geo_e, tc, params,
                                           prev_e, t_prev)
            return fn, (lam, lam_prev, geo, ms["prev"])
        prev, stages, sw, bw = self._unpack_ms(
            pvec, self.n_macro_elems(), self.n_fine_dof, dtype, self.device)

        def fn(lam_e, geo_e, prev_e, stages_e):
            return self._elem_ms_residual(lam_e, geo_e, tc, params, prev_e,
                                          stages_e, sw, bw)
        return fn, (lam, geo, prev, stages)

    def _chunk(self, jac):
        """Macro elements per batched call: what a quarter of the free
        memory holds at the fine Jacobian's size (times the macro
        tangents for the macro Jacobian)."""
        nfd = self.n_fine_dof
        ndm = self.problem.disc.ndof_elem
        per = (nfd * nfd * (ndm + 1 if jac else 1) * _BYTES_PER_ENTRY
               * torch.finfo(self.dtype).bits // 8)
        E = self.n_macro_elems()
        return max(1, min(E, int(free_bytes(self.device) // 4 // per)))

    def enable_device_sharding(self, comm):
        """Spread the fine solves over the shards of `comm` (the
        reference's 'multiscale split comm' dedicates MPI ranks to subgrid
        solves, split_mpi_communicators.cpp:31-41, multiscaleManager.cpp:
        92-140; JAX `_constrain_macro` pins the macro batch axis to the
        device mesh): under a ProcessGroupComm each rank runs its chunk of
        macro elements and all-gathers the upscaled residuals, blocks and
        fine solutions. A no-op under StackedComm, whose one process holds
        every shard."""
        from mrhyde_tpu_torch.parallel.comm import StackedComm
        self._comm = None if isinstance(comm, StackedComm) else comm

    def _batched(self, u_macro, tc, pvec, mode):
        """mode "res": (E, ndm) upscaled residuals; "jac": (residuals,
        (E, ndm, ndm) d res / d lam_eval); "fine": (E, nfd) fine
        solutions; chunked over the macro elements (over this rank's
        chunk of them under enable_device_sharding, then gathered)."""
        fn, args = self._elem_fn(u_macro, tc, pvec)
        E = self.n_macro_elems()
        if self._comm is not None:
            # this rank's rows of the padded macro axis (the pad repeats
            # the last element; its rows are cut after the gather)
            per = -(-E // self._comm.n_shards)
            idx = torch.arange(self._comm.rank * per,
                               (self._comm.rank + 1) * per,
                               device=self.device).clamp(max=E - 1)
            args = [tree_map(lambda x: x[idx], a) for a in args]
            E = per
        k = 1 if mode == "fine" else 0
        batched = torch.func.vmap(lambda *a: fn(*a)[k])
        if mode == "jac":
            # jacfwd in one macro tangent d shared by every element: each
            # element's residual reads only its own lam_e + d, so the
            # Jacobian in d is the (E, ndm, ndm) element blocks. The
            # tangent level sits OUTSIDE the macro vmap: PyTorch's
            # linalg.solve (and lu_solve) give wrong tangents under
            # vmap(jacfwd(...)) when the matrix is batched by the vmap
            # (off by 1e5 on a 3 x 3 case, torch 2.13)
            def call(lam_c, *rest):
                def res_of(d):
                    r = batched(lam_c + d, *rest)
                    return r, r
                return torch.func.jacfwd(res_of, has_aux=True)(
                    lam_c.new_zeros(lam_c.shape[1]))
        else:
            call = batched
        C = self._chunk(mode == "jac")
        outs = []
        for lo in range(0, E, C):
            sl = slice(lo, min(lo + C, E))
            outs.append(call(*[tree_map(lambda x: x[sl], a) for a in args]))
        if mode == "jac":
            outs = (torch.cat([o[1] for o in outs]),
                    torch.cat([o[0] for o in outs]))
        else:
            outs = torch.cat(outs)
        if self._comm is None:
            return outs
        E = self.n_macro_elems()
        return tree_map(lambda x: self._comm.all_gather(x)[:E], outs)

    def _apply_mask(self, arr, pvec):
        """Per-element contributions scaled by the dynamic-model mask
        riding pvec['__ms']['mask'] (1 = this model owns the element)."""
        ms = (pvec or {}).get("__ms")
        m = None if ms is None else ms.get("mask")
        if m is None:
            return arr
        return arr * m.reshape((m.shape[0],) + (1,) * (arr.ndim - 1))

    def _scatter(self, res_e):
        """(E, ndm) element contributions summed onto the macro dofs."""
        asm = self.problem.assembler
        if self._sub_cache is None:
            from mrhyde_tpu_torch.assembly.assembler import BoundaryScatter
            lids = self._sub_lids()
            inc = asm.inc if self.owns_all else torch.as_tensor(
                build_incidence(lids.cpu().numpy(), asm.n_dof),
                device=self.device)
            self._sub_cache = (inc, BoundaryScatter(lids.cpu().numpy(),
                                                    self.device))
        flat = torch.cat([res_e.reshape(-1), res_e.new_zeros(1)])
        return flat[self._sub_cache[0]].sum(dim=1)

    def residual_contribution(self, u_macro, tc, pvec=None):
        """The summed upscaled residual over the macro elements
        (n_dof,)."""
        return self._scatter(self._apply_mask(
            self._batched(u_macro, tc, pvec, "res"), pvec))

    def jacobian_contribution(self, u_macro, tc, pvec=None):
        """(E, ndm, ndm) macro element blocks d(res)/d(u_stage): the
        residual reads z only through lam_eval = alpha_u z + beta_u, so
        d/dz = alpha_u d/d(lam_eval) (the reference's fluxwt seed)."""
        return self.residual_and_blocks(u_macro, tc, pvec)[1][0][0]

    def residual_and_blocks(self, u_macro, tc, pvec=None):
        """(residual contribution (n_dof,), [(blocks, lids, scatter)]) in
        one pass of the fine solves: the jacfwd that gives the blocks
        carries the residual as its primal value."""
        res_e, jac = self._batched(u_macro, tc, pvec, "jac")
        res = self._scatter(self._apply_mask(res_e, pvec))
        blocks = tc.alpha_u * self._apply_mask(jac, pvec)
        return res, [(blocks, self._sub_lids(), self._sub_cache[1])]

    def jacobian_blocks(self, u_macro, tc, pvec=None):
        """[(blocks, lids, scatter)] for the global BlockJacobian."""
        return self.residual_and_blocks(u_macro, tc, pvec)[1]

    def jacobian_block_elems(self):
        """The macro element of each jacobian_blocks row (static)."""
        if self.owns_all:
            return [np.arange(self.n_macro_elems())]
        return [np.asarray(self.elems)]

    # ---- integrator hooks (synchronous stage stepping) ---------------

    def stage_ms_entry(self, stages, s, A, b, w, timewt, dtype, t=None,
                       dt=None, u_prev=None):
        """The pvec['__ms'] value for macro stage s."""
        if not self.sync:
            # async: the fine substeps read the macro history for the
            # trace interpolation and the step's start time
            out = {"prev": self.fine_prev, "stages": stages,
                   "lam_prev": u_prev[:2], "t_prev": float(t)}
        else:
            nstage = len(b)
            sw = np.zeros(nstage)
            sw[:s] = A[s, :s] / b[:s]
            bw = np.zeros(self.fine_prev.shape[1])
            bw[:len(w) - 1] = w[1:] * timewt
            out = {"prev": self.fine_prev, "stages": stages,
                   "sw": self._t(sw, dtype), "bw": self._t(bw, dtype)}
        if self.mask is not None:
            out["mask"] = self._t(self.mask, dtype)
        return out

    def record_stage(self, stages, s, z, tc, pvec):
        stages = stages.clone()
        stages[:, s] = self.fine_solutions(z, tc, pvec)
        return stages

    def fine_solutions(self, u_macro, tc, pvec=None):
        """(E, n_fine_dof) fine STAGE solutions at a macro state (per
        accepted stage and for the errors)."""
        return self._batched(u_macro, tc, pvec, "fine")

    def compute_errors(self, u_macro, time=0.0, pvec=None) -> dict:
        """The fine union's L2 errors against the subgrid deck's True
        solutions, keys ("Subgrid-L2" or "Subgrid-L2:<label>", var)."""
        from mrhyde_tpu_torch.assembly.assembler import (PointContext,
                                                         TimeCoeffs)
        exprs = (self.cfg.get("Postprocess", {}) or {}).get(
            "True solutions", {}) or {}
        if not exprs:
            return {}
        dt = u_macro.dtype
        if self.fine_prev is not None:
            ufs = self.fine_prev[:, 0]     # transient: the committed step
        else:
            tc = TimeCoeffs.steady(self.problem.n_dof, time=time, dtype=dt,
                                   device=self.device)
            ufs = self.fine_solutions(u_macro, tc, pvec)
        disc = self.fine_disc
        ips, wts = self._fine_points(dt)
        u_all = ufs[:, torch.as_tensor(disc.lids, device=self.device)]
        if np.any(np.asarray(disc.dofmap.signs) != 1.0) \
                or disc.dofmap.mix_pair is not None:
            u_all = disc.dofmap.fold(u_all)
        ctx = PointContext(ips, time, self.problem.params)
        kind = "Subgrid-L2" if self.label == 0 \
            else f"Subgrid-L2:{self.label}"
        out = {}

        def finish(var, e2):
            if self.mask is not None:
                e2 = e2 * self._t(self.mask, e2.dtype)
            out[(kind, var)] = float(torch.sqrt(torch.sum(e2)))

        def true(expr, shape):
            return torch.broadcast_to(torch.as_tensor(
                self.fm.evaluate_expr(expr, ctx), dtype=dt,
                device=self.device), shape)

        # 'u[x]'-style component entries grouped per vector variable
        comp_exprs, scal_exprs = {}, {}
        for var, expr in exprs.items():
            if var.endswith("]") and "[" in var:
                comp_exprs.setdefault(var[:var.index("[")], {})[
                    {"x": 0, "y": 1, "z": 2}[var[-2]]] = expr
            else:
                scal_exprs[var] = expr
        for var, expr in scal_exprs.items():
            if var not in disc.offsets:
                continue
            key = disc.basis_keys[var]
            if key not in disc.basis_vals and key in disc.vec_vals:
                # a 1D vector space under a scalar true-solution name
                comp_exprs.setdefault(var, {})[0] = expr
                continue
            st, nd = disc.offsets[var]
            uh = torch.einsum("efi,iq->efq", u_all[:, :, st:st + nd],
                              self._t(disc.basis_vals[key], dt))
            finish(var, torch.sum(wts * (uh - true(expr, uh.shape)) ** 2,
                                  dim=(1, 2)))
        for var, comps in comp_exprs.items():
            if var not in disc.offsets:
                continue
            st, nd = disc.offsets[var]
            key = disc.basis_keys[var]
            if self.general:
                uh = torch.einsum("efi,efiqd->efqd", u_all[:, :, st:st + nd],
                                  self._t(self._geo_np["bg"]["vec"][key], dt))
            else:
                uh = torch.einsum("efi,fiqd->efqd", u_all[:, :, st:st + nd],
                                  self._t(disc.vec_vals[key], dt))
            e2 = 0.0
            for ax, expr in comps.items():
                e2 = e2 + torch.sum(
                    wts * (uh[..., ax] - true(expr, uh.shape[:3])) ** 2,
                    dim=(1, 2))
            finish(var, e2)
        return out


def _gather_sum(parts, inc):
    """The blocks in `parts`, flattened in order, summed through the
    incidence table inc (rows, fan-in) into (rows,)."""
    flat = torch.cat([p.reshape(-1) for p in parts]
                     + [parts[0].new_zeros(1)])
    return flat[inc].sum(dim=-1)


def _combine(fine_prev, fine_stages, nstage):
    """The fine step's new state from its stages (u += z_s - u_prev0)."""
    prev0 = fine_prev[:, 0]
    if nstage > 1:
        return prev0 + torch.sum(fine_stages[:, :nstage] - prev0[:, None],
                                 dim=1)
    return fine_stages[:, 0]


def _shift(fine_prev, new):
    """The BDF history shifted by one step, `new` in slot 0."""
    return torch.cat([new[:, None], fine_prev[:, :-1]], dim=1)


class MultiscaleModels:
    """Several subgrid models over disjoint macro-element subsets.

    Reference: MultiscaleManager (multiscaleManager.cpp:117-150, one
    model per Subgrid sublist with a 'usage' expression;
    assemblyManager.cpp:8071-8110 evaluates every model's usage at the
    volume qps and gives each group to the model with the most usage >= 1
    votes, ties to the LATER model). The interface of SubgridDtN;
    pvec["__ms"] becomes a tuple of per-model entries."""

    def __init__(self, problem, subgrid_cfg: dict):
        cfg = subgrid_cfg.get("Subgrid", subgrid_cfg)
        self.problem = problem
        model_cfgs = [(k, v) for k, v in cfg.items()
                      if isinstance(v, dict) and "Mesh" in v]
        if not model_cfgs:
            raise ValueError("Subgrid list has no model sublists")
        self.model_cfgs = model_cfgs
        self._vote_groups_cache = None
        self._strip_cache = None
        self.dynamic = not bool(cfg.get("static subgrids", True))
        if self.dynamic:
            # every model covers every element; per-step 0/1 masks pick
            # the winner (reference MultiscaleManager::update,
            # multiscaleManager.cpp:385-430, L2 transfer on switches)
            self.models = [SubgridDtN(problem, mcfg, label=j)
                           for j, (_n, mcfg) in enumerate(model_cfgs)]
            self._xfer = self._projection_maps()
        else:
            winner = self._vote(0.0)
            self.models = []
            for j, (_name, mcfg) in enumerate(model_cfgs):
                elems = np.nonzero(winner == j)[0]
                if elems.size:
                    self.models.append(SubgridDtN(
                        problem, mcfg, elems=elems, label=len(self.models)))
        self.fine_prev = None   # presence flag for the integrator

        # ML model selection ('subgrid model selection: ML',
        # multiscaleManager.cpp:54, :687-790): a softmax regression
        # trained in process from the usage-vote labels
        sol_cfg = problem.cfg.get("Solver", {}) or {}
        self.selection = str(sol_cfg.get("subgrid model selection",
                                         "user defined"))
        self.ml_train_steps = int(sol_cfg.get(
            "max subgrid ML training steps", 10))
        self._ml_X: list = []
        self._ml_y: list = []
        self._ml_W = None
        self._ml_steps = 0
        self._ml_times: set = set()
        self._prev_winner = None

    def _ml_features(self, time):
        """(G, nf) features, one row per VOTE GROUP (the mean element
        centroid, and the time): the decision unit the usage vote pools
        over (reference multiscaleManager.cpp:1004-1029)."""
        mesh = self.problem.mesh
        cents = mesh.nodes[mesh.conn].mean(axis=1)
        X = np.stack([cents[g].mean(axis=0) for g in self._vote_groups()])
        return np.concatenate([X, np.full((X.shape[0], 1), float(time))],
                              axis=1)

    def _ml_fit(self):
        """Softmax regression on the collected (features, winner) pairs:
        standardized features, 3,000 full-batch Adam steps from zero
        weights (lr 0.05), on the problem's device in f64. Nothing is
        drawn at random."""
        dev = self.problem.device
        Xn = np.concatenate(self._ml_X)
        self._ml_mu = Xn.mean(axis=0)
        self._ml_sig = Xn.std(axis=0) + 1e-12
        X = torch.as_tensor((Xn - self._ml_mu) / self._ml_sig,
                            dtype=torch.float64, device=dev)
        y = torch.as_tensor(np.concatenate(self._ml_y), device=dev)
        Xb = torch.cat([X, torch.ones((X.shape[0], 1), dtype=X.dtype,
                                      device=dev)], dim=1)
        rows = torch.arange(y.shape[0], device=dev)

        def loss(W):
            return -torch.mean(torch.log_softmax(Xb @ W, dim=1)[rows, y])
        gfn = torch.func.grad(loss)
        lr, b1, b2, eps = 0.05, 0.9, 0.999, 1e-8
        W = torch.zeros((Xb.shape[1], len(self.models)), dtype=X.dtype,
                        device=dev)
        m, v = torch.zeros_like(W), torch.zeros_like(W)
        for i in range(3000):
            g = gfn(W)
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * g * g
            mh = m / (1 - b1 ** (i + 1.0))
            vh = v / (1 - b2 ** (i + 1.0))
            W = W - lr * mh / (torch.sqrt(vh) + eps)
        self._ml_W = W.cpu().numpy()

    def _ml_predict(self, time):
        """(E,) winner ids: each group's prediction on its elements."""
        X = (self._ml_features(time) - self._ml_mu) / self._ml_sig
        Xb = np.concatenate([X, np.ones((X.shape[0], 1))], axis=1)
        gwin = np.argmax(Xb @ self._ml_W, axis=1)
        winner = np.zeros(self.problem.mesh.conn.shape[0], dtype=int)
        for g, grp in enumerate(self._vote_groups()):
            winner[grp] = gwin[g]
        return winner

    def _vote(self, time):
        """(E,) winner index from usage >= 1 votes at the macro volume
        qps, pooled per (virtual MPI-rank x-strip) x (workset group), ONE
        winner per group, the LAST model with the most votes
        (assemblyManager.cpp:8069-8110). The default model's usage '1.0'
        votes on every qp, so a later model wins a group only by
        unanimity over it. Groups: `Solver: workset size` (default 100)
        consecutive elements in (y-outer, x-inner) order within each of
        `multiscale vote ranks` (default 4) x-strips, the inline mesh's
        `mpiexec -n 4` split; with `assembly partitioning:
        subgrid-preserving` groups of one boundary-membership signature
        (assemblyManager.cpp:536-613), a reference quirk reproduced
        here."""
        from mrhyde_tpu_torch.assembly.assembler import PointContext
        problem = self.problem
        ips = torch.as_tensor(problem.disc.ip, dtype=torch.float64)
        votes = []
        for j, (_name, mcfg) in enumerate(self.model_cfgs):
            usage = str(mcfg.get("usage", "1.0" if j == 0 else "0.0"))
            vals = torch.broadcast_to(torch.as_tensor(
                problem.fm.evaluate_expr(
                    usage, PointContext(ips, time, problem.params)),
                dtype=torch.float64), ips.shape[:2])
            votes.append((vals >= 1.0).cpu().numpy().sum(axis=1))
        votes = np.stack(votes)                       # (M, E)
        winner = np.zeros(ips.shape[0], dtype=int)
        for grp in self._vote_groups():
            counts = votes[:, grp].sum(axis=1)
            w, best = 0, -1
            for j in range(counts.shape[0]):
                if counts[j] >= best:
                    best, w = counts[j], j
            winner[grp] = w
        return winner

    def _vote_groups(self):
        """The (virtual rank x workset group) element groups the vote
        pools over (see _vote); static, cached."""
        if self._vote_groups_cache is not None:
            return self._vote_groups_cache
        problem = self.problem
        mesh = problem.mesh
        sol = problem.cfg.get("Solver", {}) or {}
        E = mesh.conn.shape[0]
        strip = self._vote_strips()
        ws = int(sol.get("workset size", 100))
        cen = mesh.nodes[mesh.conn].mean(axis=1)
        cx = np.round(cen[:, 0], 12)
        cy = np.round(cen[:, 1], 12) if cen.shape[1] > 1 else np.zeros(E)
        onb = None
        if str(sol.get("assembly partitioning", "sequential")) \
                == "subgrid-preserving" and mesh.sidesets:
            onb = np.zeros((E, len(mesh.sidesets)), dtype=bool)
            for b, ss in enumerate(mesh.sidesets.values()):
                if ss.size:
                    onb[ss[:, 0], b] = True
        out = []
        for s in range(int(strip.max()) + 1):
            sel = np.where(strip == s)[0]
            order = sel[np.lexsort((cx[sel], cy[sel]))]   # x fastest
            if onb is None:
                out.extend(order[k:k + ws] for k in range(0, order.size, ws))
                continue
            # greedy same-signature groups in local order, up to ws each
            sig = onb[order]
            added = np.zeros(order.size, dtype=bool)
            for i in range(order.size):
                if added[i]:
                    continue
                grp = np.where(~added & (sig == sig[i]).all(axis=1))[0][:ws]
                added[grp] = True
                out.append(order[grp])
        self._vote_groups_cache = out
        return out

    def _vote_strips(self):
        """(E,) virtual-rank strip of each element: the columns (unique
        centroid x) split into `multiscale vote ranks` chunks, the extra
        columns on the first (the inline mesh's x decomposition)."""
        if self._strip_cache is not None:
            return self._strip_cache
        mesh = self.problem.mesh
        nr = int((self.problem.cfg.get("Solver", {}) or {}).get(
            "multiscale vote ranks", 4))
        cx = mesh.nodes[mesh.conn].mean(axis=1)[:, 0]
        cols = np.unique(np.round(cx, 16))
        if nr <= 1 or cols.size < nr:
            self._strip_cache = np.zeros(cx.shape[0], dtype=int)
            return self._strip_cache
        strip_of_col = np.zeros(cols.size, dtype=int)
        for s, ch in enumerate(np.array_split(np.arange(cols.size), nr)):
            strip_of_col[ch] = s
        self._strip_cache = strip_of_col[np.searchsorted(
            cols, np.round(cx, 16))]
        return self._strip_cache

    def _projection_maps(self):
        """xfer[k][j]: (nfd_k, nfd_j) L2 projection of model j's fine p1
        field onto model k's fine space, integrated with the finer
        template's nested-grid quadrature (exact for p1 x p1 products;
        the reference integrates with the target's rule,
        multiscaleManager.cpp:330-338, which the JAX package measured
        further from the gold)."""
        from mrhyde_tpu_torch.fem.quadrature import cell_quadrature

        def p1_eval(mesh, pts):
            # (npts, n_nodes) bilinear evaluation on a uniform [-1,1]^2
            n1 = int(round(np.sqrt(mesh.conn.shape[0])))
            h = 2.0 / n1
            out = np.zeros((pts.shape[0], mesh.nodes.shape[0]))
            ij = np.clip(((pts + 1.0) / h).astype(int), 0, n1 - 1)
            xi = (pts + 1.0 - ij * h) / h * 2.0 - 1.0
            sh = np.stack([(1 - xi[:, 0]) * (1 - xi[:, 1]),
                           (1 + xi[:, 0]) * (1 - xi[:, 1]),
                           (1 + xi[:, 0]) * (1 + xi[:, 1]),
                           (1 - xi[:, 0]) * (1 + xi[:, 1])], axis=1) / 4.0
            np.put_along_axis(out, mesh.conn[ij[:, 0] * n1 + ij[:, 1]], sh,
                              axis=1)
            return out

        qp, qw = cell_quadrature("quad", 2)
        maps = {}
        for k, mk in enumerate(self.models):
            maps[k] = {}
            for j, mj in enumerate(self.models):
                if j == k:
                    continue
                finer = (mk.ref_fine if mk.ref_fine.conn.shape[0]
                         >= mj.ref_fine.conn.shape[0] else mj.ref_fine)
                n1 = int(round(np.sqrt(finer.conn.shape[0])))
                h = 2.0 / n1
                cents = finer.nodes[finer.conn].mean(axis=1)
                pts = (cents[:, None, :] + qp[None] * h / 2.0).reshape(-1, 2)
                w = np.tile(qw * (h / 2.0) ** 2, cents.shape[0])
                Pk, Pj = p1_eval(mk.ref_fine, pts), p1_eval(mj.ref_fine, pts)
                maps[k][j] = np.linalg.solve(Pk.T @ (w[:, None] * Pk),
                                             Pk.T @ (w[:, None] * Pj))
        return maps

    def update_masks(self, time):
        """Re-vote the ownership at the step's start time and, at the
        elements whose winner changed, L2-project the old owner's last
        committed fine state onto the new owner's space (the reference's
        switch transfer, multiscaleManager.cpp:396-407; only the latest
        history slot transfers)."""
        if not self.dynamic:
            return
        if self.selection == "ML" and self._ml_W is not None:
            winner = self._ml_predict(time)
        else:
            winner = self._vote(time)
            if self.selection == "ML":
                # one training batch per DISTINCT vote time (the
                # init-history and first-step votes share t0)
                tkey = round(float(time), 12)
                if tkey not in self._ml_times:
                    self._ml_times.add(tkey)
                    self._ml_X.append(self._ml_features(time))
                    self._ml_y.append(np.asarray(
                        [winner[g[0]] for g in self._vote_groups()]))
                    self._ml_steps += 1
                if self._ml_steps >= max(self.ml_train_steps, 2):
                    self._ml_fit()
        winner = np.asarray(winner)
        prev = self._prev_winner
        if prev is not None and self.models[0].fine_prev is not None:
            for k, mk in enumerate(self.models):
                for j, mj in enumerate(self.models):
                    if j == k:
                        continue
                    elems = np.nonzero((prev == j) & (winner == k))[0]
                    if elems.size == 0:
                        continue
                    idx = torch.as_tensor(elems, device=mk.device)
                    src = mj.fine_prev[idx, 0]
                    fp = mk.fine_prev.clone()
                    fp[idx, 0] = src @ torch.as_tensor(
                        self._xfer[k][j].T, dtype=src.dtype,
                        device=src.device)
                    mk.fine_prev = fp
        self._prev_winner = winner
        for j, m in enumerate(self.models):
            m.mask = (winner == j).astype(float)

    def init_history(self, hist, dtype, t0=0.0):
        for m in self.models:
            m.init_history(hist, dtype)
        if self.dynamic:
            self.update_masks(t0)
        self.fine_prev = True

    def blank_stages(self, nstage, dtype):
        return tuple(m.blank_stages(nstage, dtype) for m in self.models)

    def stage_ms_entry(self, stages, s, A, b, w, timewt, dtype, t=None,
                       dt=None, u_prev=None):
        return tuple(m.stage_ms_entry(st, s, A, b, w, timewt, dtype, t=t,
                                      dt=dt, u_prev=u_prev)
                     for m, st in zip(self.models, stages))

    def record_stage(self, stages, s, z, tc, pvec):
        return tuple(m.record_stage(st, s, z, tc, self._sub_pvec(pvec, i))
                     for i, (m, st) in enumerate(zip(self.models, stages)))

    def commit_step(self, stages, nstage):
        if not self.dynamic:
            for m, st in zip(self.models, stages):
                m.commit_step(st, nstage)
            return
        news = [_combine(m.fine_prev, st, nstage)
                for m, st in zip(self.models, stages)]
        # only the OWNING model advances its history at an element;
        # non-owners stay stale until a switch projects into them
        # (updateActive, multiscaleManager.cpp:418-429)
        for mk, new in zip(self.models, news):
            own = torch.as_tensor(mk.mask, dtype=mk.fine_prev.dtype,
                                  device=mk.device)[:, None, None]
            mk.fine_prev = own * _shift(mk.fine_prev, new) \
                + (1.0 - own) * mk.fine_prev

    @staticmethod
    def _sub_pvec(pvec, i):
        if not pvec or "__ms" not in pvec:
            return pvec
        return {**pvec, "__ms": pvec["__ms"][i]}

    def enable_device_sharding(self, comm):
        for m in self.models:
            m.enable_device_sharding(comm)

    def residual_contribution(self, u_macro, tc, pvec=None):
        r = 0.0
        for i, m in enumerate(self.models):
            r = r + m.residual_contribution(u_macro, tc,
                                            self._sub_pvec(pvec, i))
        return r

    def residual_and_blocks(self, u_macro, tc, pvec=None):
        r, out = 0.0, []
        for i, m in enumerate(self.models):
            ri, bi = m.residual_and_blocks(u_macro, tc,
                                           self._sub_pvec(pvec, i))
            r = r + ri
            out.extend(bi)
        return r, out

    def jacobian_blocks(self, u_macro, tc, pvec=None):
        return self.residual_and_blocks(u_macro, tc, pvec)[1]

    def jacobian_block_elems(self):
        out = []
        for m in self.models:
            out.extend(m.jacobian_block_elems())
        return out

    def compute_errors(self, u_macro, time=0.0, pvec=None) -> dict:
        out = {}
        for i, m in enumerate(self.models):
            out.update(m.compute_errors(u_macro, time,
                                        self._sub_pvec(pvec, i)))
        return out
