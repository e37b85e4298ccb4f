"""Convection-diffusion-reaction (cdr) and thermal with advection in the
port against the JAX package: the general path (vmap'd residual,
vmap(jacfwd) Jacobian) in 2D and on hex; the fused provider on 2D p1
quads with its kernels' plain versions against JAX's
FusedP1Assembly.res_jac in Pallas interpret mode, which runs the TPU
kernel B2 on the CPU (B1 on hex and p2: test_torch_cdr_elem.py):
residual, the kind and value of every Jacobian row, `stats`, and the
BlockJacobian's apply and diag, steady and at a DIRK-2,2 stage,
with a constant and a rotating (x-dependent) velocity, the reaction 1.0
(affine split) and 0.5 c^2 (mode "full"), density 2 (cdr's c_t lane is
not weighted by rho cp); the provider inside res_and_jac against the
port's general path; the reference's cdr/2D_manufactured gold; a BWE
error history against JAX.

Every velocity here is nonzero, so every Jacobian is nonsymmetric: a
kernel that swapped row (test function) and column (trial function) of
the advection term fails the row and apply checks.

Tolerance 1e-11 absolute: the same f64 weak form summed in the same
quadrature and corner order, on O(1) entries."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrhyde_tpu_torch.interop import state_from_numpy
from mrhyde_tpu_torch.ops import fused_elem as fe
from mrhyde_tpu_torch.ops import fused_p1 as fp
from torch_port_utils import (CDR_MESHES, DIRK22_STAGE1, REACTIONS,
                              advection_cfg, both_problems, cdr_cfg,
                              check_fused_against_general,
                              check_provider_case, max_diff, seeded,
                              stage_coeffs, steady_coeffs)

torch.set_num_threads(1)

TOL = 1e-11

# ----------------------------------------------------------------------
# the general path
# ----------------------------------------------------------------------

@pytest.mark.parametrize("stage", [False, True], ids=["steady", "dirk22"])
@pytest.mark.parametrize("physics,nz", [("cdr", None), ("thermal", None),
                                        ("cdr", 2), ("thermal", 2)])
def test_general_path_matches_jax(physics, nz, stage):
    """Residual, Jacobian blocks and J v of the general path, with the
    rotating velocity (in 3D w = 0.5 + 0.25 z: an x-dependent velocity
    through the workset's qp broadcast) and reaction 0.5 c^2."""
    if physics == "thermal":
        cfg = advection_cfg(3, 2, nz, "rot", transient=stage)
    else:
        cfg = cdr_cfg(3, 2, nz, "rot", "0.5*c*c", transient=stage)
    pj, pt = both_problems(cfg)
    tj, tt = (stage_coeffs(pj, pt, *DIRK22_STAGE1, seed=31) if stage
              else steady_coeffs(pj, pt))
    u = seeded(pj.n_dof, seed=3)
    ut = state_from_numpy(u, pt)
    assert max_diff(pt.assembler.residual(ut, tt),
                    pj.assembler.residual(jnp.asarray(u), tj)) < TOL
    Jj = pj.assembler.jacobian(jnp.asarray(u), tj)
    Jt = pt.assembler.jacobian(ut, tt)
    assert max_diff(Jt.vol, Jj.vol) < TOL
    v = seeded(pj.n_dof, seed=4, scale=1.0)
    assert max_diff(Jt.apply(state_from_numpy(v, pt)),
                    Jj.apply(jnp.asarray(v))) < TOL
    # advection: nonsymmetric element blocks
    assert max_diff(Jt.vol, Jt.vol.transpose(1, 2)) > 1e-3


# ----------------------------------------------------------------------
# the fused provider against JAX's interpret-mode B2 / B1
# ----------------------------------------------------------------------

# (physics, velocity, reaction, stage) on p1 quads (B2): every cdr
# combination and two thermal ones (the B1 cases: test_torch_cdr_elem.py)
PROVIDER_CASES = [
    ("cdr", vel, reaction, stage)
    for vel in ("const", "rot") for reaction in REACTIONS
    for stage in (False, True)] + [
    ("thermal", "rot", None, False),
    ("thermal", "const", None, True),
]


@pytest.mark.parametrize(
    "physics,vel,reaction,stage", PROVIDER_CASES,
    ids=["-".join(str(x) for x in c) for c in PROVIDER_CASES])
def test_provider_matches_jax_node_kernel(physics, vel, reaction, stage):
    ft = check_provider_case(physics, "p1", vel, reaction, stage)
    assert ft.node and ft.nc == 4


@pytest.mark.parametrize("stage", [False, True], ids=["steady", "dirk22"])
@pytest.mark.parametrize("mesh", ["p1", "hex", "p2"])
def test_res_and_jac_engages_fused_and_matches_general(mesh, stage):
    """Through res_and_jac on the CPU: the steady call with the constant
    velocity and reaction 0.5 c^2 (mode "full"), the stage with the
    rotating one (the split, two state launches on the beta grids)."""
    from mrhyde_tpu_torch.assembly.assembler import TimeCoeffs
    from mrhyde_tpu_torch.interop import time_coeffs_from_numpy
    from mrhyde_tpu_torch.problem import Problem
    sizes = {"p1": (5, 4, None), "hex": (3, 4, 2), "p2": (3, 4, None)}[mesh]
    order = CDR_MESHES[mesh][1]
    cfg = (cdr_cfg(*sizes, "rot", "1.0", order=order, transient=True)
           if stage else cdr_cfg(*sizes, "const", "0.5*c*c", order=order))
    pt = Problem(cfg, device="cpu")
    n = pt.n_dof
    tt = (time_coeffs_from_numpy(DIRK22_STAGE1[0], seeded(n, seed=31),
                                 DIRK22_STAGE1[1],
                                 seeded(n, seed=32, scale=5.0), 0.3, 0.05, pt)
          if stage else TimeCoeffs.steady(n))
    check_fused_against_general(pt, tt, torch.as_tensor(seeded(n, seed=22)),
                                TOL)


# ----------------------------------------------------------------------
# decks end to end
# ----------------------------------------------------------------------

def _gold_cfg():
    """The reference's cdr/2D_manufactured (tests/test_cdr_burgers.py)."""
    cfg = cdr_cfg(40, vel="const", reaction="0.5*c*c", density="1.0",
                  source="(8*(pi*pi)+0.5*sin(2*pi*x)*sin(2*pi*y))"
                         "*sin(2*pi*x)*sin(2*pi*y)"
                         " + 2.0*2*pi*cos(2*pi*x)*sin(2*pi*y)"
                         " + 1.0*2*pi*sin(2*pi*x)*cos(2*pi*y)",
                  solver={"nonlinear TOL": 1e-7, "max nonlinear iters": 4})
    cfg["Physics"]["Initial conditions"] = {"c": "0.0"}
    return cfg


def test_cdr_gold_through_the_fused_provider():
    """cdr/2D_manufactured (40^2, v = (2, 1), reaction 0.5 c^2, direct):
    the reference's gold L2(c) = 0.00101714 with every assembly through
    the fused provider's mode "full"."""
    from mrhyde_tpu_torch.problem import Problem
    p = Problem(_gold_cfg(), device="cpu")
    fused = p.assembler.fused_provider()
    assert fused is not None and fused.node and not fused.split
    calls = []
    res_jac = fused.res_jac

    def counted(*a, **k):
        calls.append(1)
        return res_jac(*a, **k)
    fused.res_jac = counted
    res = p.run()
    assert res.errors[("L2", "c")] == pytest.approx(0.00101714, rel=2e-5)
    assert len(calls) >= 2


def test_cli_prints_the_cdr_gold(tmp_path):
    """The gold deck through the port's CLI on the CPU."""
    import os
    import subprocess
    import sys
    import yaml
    deck = tmp_path / "input.yaml"
    deck.write_text(yaml.safe_dump(_gold_cfg()))
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-m", "mrhyde_tpu_torch.driver",
                          str(deck), "--device", "cpu"], capture_output=True,
                         text=True, env=env, cwd=tmp_path, timeout=600)
    assert out.returncode == 0, out.stderr
    lines = [ln for ln in out.stdout.splitlines()
             if "L2 norm of the error for c" in ln]
    assert len(lines) == 1 and "0.00101714" in lines[0]


def test_bwe_error_history_matches_jax():
    """16^2, the rotating velocity, density 2, reaction 1.0, IC x (1-x) y,
    BWE, 4 steps to t = 0.2: L2(c) at every recorded time."""
    cfg = cdr_cfg(16, vel="rot", transient=True,
                  solver={"nonlinear TOL": 1e-12})
    cfg["Physics"]["Initial conditions"] = {"c": "x*(1-x)*y"}
    pj, pt = both_problems(cfg)
    assert pt.assembler.fused_provider() is not None
    ht = pt.run().error_history
    hj = pj.run().error_history
    assert len(ht) == len(hj) == 5
    for (t1, et), (t2, ej) in zip(ht, hj):
        assert t1 == pytest.approx(t2, abs=1e-14)
        assert abs(et[("L2", "c")] - ej[("L2", "c")]) < 1e-10


# ----------------------------------------------------------------------
# the module, the wrappers, the refusals
# ----------------------------------------------------------------------

def test_cdr_defaults_and_coefficients():
    """xvel, yvel, zvel and reaction default to 1.0; kappa = diffusion /
    (rho cp); the mass coefficient is 1 whatever rho cp."""
    from mrhyde_tpu_torch.problem import Problem
    cfg = cdr_cfg(4)
    for k in ("xvel", "yvel", "reaction"):
        del cfg["Functions"][k]
    cfg["Functions"]["specific heat"] = "4.0"
    ft = Problem(cfg, device="cpu").assembler.fused_provider()
    ctx = fp.QpCtx("c", 0.0, ft._qp_coords(), 0.0, {}, ft.fm)
    assert ft.module.qp_velocity(ctx) == [1.0, 1.0]
    assert ft.module.qp_mass(ctx) == 1.0
    S, kap = ft.module.qp_coefficients(ctx)
    assert kap == pytest.approx(1.0 / 8.0)
    src = ft.fm.evaluate("source", ctx)
    assert max_diff(S, 1.0 - src) < 1e-14


@pytest.mark.parametrize("velocity", ["c", "1.0 + c*c", "grad(c)[x]",
                                      "c_t"])
def test_velocity_reading_the_state_raises(velocity):
    """A velocity that reads the state's gradient or time derivative
    raises (A10, CDR remainder) on hex and on 2D p1 quads; one that reads
    the state itself takes the module-set provider on both
    (tests/test_torch_fused_set_scalar.py, _set_elem.py)."""
    from mrhyde_tpu_torch.ops.fused_set import FusedSetAssembly
    from mrhyde_tpu_torch.problem import Problem
    for cfg in (cdr_cfg(2, 2, 2), cdr_cfg(4)):
        cfg["Functions"]["xvel"] = velocity
        if "grad" in velocity or "_t" in velocity:
            with pytest.raises(NotImplementedError, match="CDR remainder"):
                Problem(cfg, device="cpu")
        else:
            assert isinstance(Problem(cfg, device="cpu").assembler
                              .fused_provider(), FusedSetAssembly)


def _tables(mesh):
    from mrhyde_tpu_torch.problem import Problem
    (nx, ny, nz), order = CDR_MESHES[mesh]
    f = Problem(cdr_cfg(2, 2, None if nz is None else 2, order=order),
                device="cpu").assembler.fused_provider()
    return f.tables, f.lattice


@pytest.mark.parametrize("mesh", ["p1", "hex", "p2"])
def test_wrappers_take_plain_versions_with_velocity_on_cpu(mesh):
    """Each wrapper with a velocity (scalar and (E, Q) components) is its
    plain version on CPU tensors and launches nothing; the velocity term
    is what it adds to the wrapper without one."""
    tab, lat = _tables(mesh)
    rng = np.random.RandomState(7)
    node = mesh == "p1"
    dims = (3, 2) if tab.dim == 2 else (3, 2, 4)
    grid = torch.as_tensor(rng.randn(*(lat.stride * n + 1 for n in dims)))
    E = int(np.prod(dims))
    qp = [torch.as_tensor(rng.randn(E, tab.Q)) for _ in range(6)]
    vel = [qp[5]] + [1.5] * (tab.dim - 1)
    before = dict(fp.LAUNCHES)
    for stage in (None, fp.Stage(0.5, 40.0, 2.0)):
        if node:
            state = fp.thermal_node_state(grid, qp[4], tab, stage, vel)
            assert torch.equal(state, fp.thermal_node_state_plain(
                grid, qp[4], tab, stage, vel))
            full = fp.thermal_node_full(grid, *qp[:4], tab, stage, vel)
            ref = fp.thermal_node_full_plain(grid, *qp[:4], tab, stage, vel)
            bare = fp.thermal_node_full_plain(grid, *qp[:4], tab, stage)
        else:
            state = fe.thermal_elem_state(grid, qp[4], tab, lat, stage, vel)
            assert torch.equal(state, fe.thermal_elem_state_plain(
                grid, qp[4], tab, lat, stage, vel))
            full = fe.thermal_elem_full(grid, *qp[:4], tab, lat, stage, vel)
            ref = fe.thermal_elem_full_plain(grid, *qp[:4], tab, lat, stage,
                                             vel)
            bare = fe.thermal_elem_full_plain(grid, *qp[:4], tab, lat, stage)
        assert all(torch.equal(a, b) for a, b in zip(full, ref))
        assert max_diff(full[1], bare[1]) > 1e-3
    assert fp.LAUNCHES == before


def test_advection_rows_are_the_element_integrals():
    """The hex state rows with a constant velocity b and kappa = 0 are
    A u_e with A[c][c'] = sum_q w phi_c b . grad phi_c', not its
    transpose."""
    tab, lat = _tables("hex")
    rng = np.random.RandomState(5)
    grid = torch.as_tensor(rng.randn(2, 2, 2))
    b = [2.0, -1.0, 0.5]
    rows = fe.thermal_elem_state_plain(grid, 0.0, tab, lat, vel=b)
    uc = torch.stack(fe.corner_values(grid, lat))[:, 0]
    phi = torch.as_tensor(np.asarray(tab.phi))
    bg = torch.as_tensor(np.asarray(tab.grad)) @ torch.as_tensor(
        b, dtype=torch.float64)
    A = torch.einsum("cq,pq,q->cp", phi, bg,
                     torch.as_tensor(np.asarray(tab.wts)))
    assert float((rows[:, 0] - A @ uc).abs().max()) < 1e-14
    assert float((rows[:, 0] - A.T @ uc).abs().max()) > 1e-3


def test_velocity_args_refuse_the_wrong_component_count():
    from mrhyde_tpu_torch.ops._launch import velocity_args
    tab, _lat = _tables("p1")
    assert velocity_args(None, 4, None, tab) == (0,) + (None, 0.0) * 3
    assert velocity_args([2.0, 1.0], 4, None, tab) == (
        1, None, 2.0, None, 1.0, None, 0.0)
    with pytest.raises(ValueError):
        velocity_args([1.0, 1.0, 1.0], 4, None, tab)


@pytest.mark.parametrize("physics", ["cdr", "thermal"])
def test_qp_density_matches_jax(physics):
    """The port's qp_density of cdr and of thermal with advection (the
    weak form the kernels hard-code, with the velocity) against the JAX
    module's on the same per-qp state, density 2 and an x-dependent
    velocity."""
    from mrhyde_tpu.functions.manager import FunctionManager as JaxFM
    from mrhyde_tpu.physics.cdr import CDR as JaxCDR
    from mrhyde_tpu.physics.thermal import Thermal as JaxThermal
    from mrhyde_tpu_torch.functions.manager import FunctionManager
    from mrhyde_tpu_torch.physics.cdr import CDR
    from mrhyde_tpu_torch.physics.thermal import Thermal
    var = "c" if physics == "cdr" else "e"

    class Ctx:
        def __init__(self, fm, x, u, g):
            self.fm, self.x, self.u, self.g = fm, x, u, g

        def f(self, name):
            return self.fm.evaluate(name, self)

        def sol_dot(self, v):
            return 0.5 * self.u

        def grad(self, v):
            return self.g

        def resolve(self, leaf):
            return {"x": self.x, var: self.u}[leaf]

    if physics == "cdr":
        mods = (JaxCDR, CDR)
        fs = {"diffusion": "1 + x*x", "source": "sin(x)", "density": "2.0",
              "reaction": "0.5*c*c", "xvel": "-4.0*x", "yvel": "1.5"}
    else:
        mods = (JaxThermal, Thermal)
        fs = {"thermal diffusion": "1 + e*e + x", "thermal source": "sin(x)",
              "density": "2.0", "advection x": "-4.0*x", "advection y": "1.5"}
    settings = {"include advection": True}
    rng = np.random.RandomState(43)
    x, u, g0, g1 = (rng.randn(7) for _ in range(4))
    out = {}
    for name, mod, fm, arr in (("jax", mods[0], JaxFM(), jnp.asarray),
                               ("torch", mods[1], FunctionManager(),
                                torch.as_tensor)):
        m = mod(settings, 2)
        m.define_functions(fm, fs)
        S, F = m.qp_density(Ctx(fm, arr(x), arr(u),
                                [arr(g0), arr(g1)]))[var]
        out[name] = [np.asarray(S)] + [np.asarray(f) for f in F]
    for a, b in zip(out["torch"], out["jax"]):
        assert max_diff(a, b) < 1e-14
