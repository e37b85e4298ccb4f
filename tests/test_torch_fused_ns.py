"""The port's fused Navier-Stokes provider (mrhyde_tpu_torch/ops/
fused_ns.py), with its kernel's plain version on the CPU, against the
JAX package's FusedP1Assembly.res_jac in Pallas interpret mode (which
runs the node-scatter TPU kernel B2, mode "full", nd = 12, on the CPU):
the residual, the kind of each of the 144 Jacobian rows (None /
element-independent scalar / (E,) array) and its value, and `stats`; a
steady PSPG call and a PSPG+SUPG transient stage. The other
configurations are held to the port's general path, which
test_torch_navierstokes.py holds to JAX's.

Tolerances: 1e-10 absolute against JAX's kernel (the same f64 weak form
and sparse forward AD, other summation orders, entries up to O(10));
1e-11 against the port's general path."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrhyde_tpu.ops.fused_p1 import FusedP1Assembly as JaxFused
from mrhyde_tpu_torch.interop import state_from_numpy, time_coeffs_from_numpy
from mrhyde_tpu_torch.ops import fused_ns as fn
from mrhyde_tpu_torch.ops import fused_p1 as fp
from mrhyde_tpu_torch.ops.sparse_dual import SDual, sparse_jacfwd, where_
from torch_port_utils import (NS_STAGE1, both_problems, channel_cfg,
                              max_diff, seeded, stage_coeffs, steady_coeffs)

torch.set_num_threads(1)


def _kind(row):
    if row is None:
        return "none"
    return "array" if np.ndim(row) >= 1 else "scalar"


def _stage_cfg(supg=True, visc=None):
    return channel_cfg(4, 4, supg=supg, visc=visc,
                       solver={"solver": "transient"})


# the momentum-pressure block: rows of ux, uy against columns of pr
PRESSURE_BLOCK = tuple(r * 12 + 8 + cp for r in range(8) for cp in range(4))


@pytest.mark.parametrize("case", ["pspg_steady", "supg_stage"])
def test_provider_matches_jax_node_kernel(case):
    if case == "pspg_steady":
        pj, pt = both_problems(channel_cfg(4, 4))
        tj, tt = steady_coeffs(pj, pt)
    else:
        pj, pt = both_problems(_stage_cfg())
        tj, tt = stage_coeffs(pj, pt, *NS_STAGE1, seed=31, deltat=0.01)
    u = seeded(pj.n_dof, seed=21)
    fk = JaxFused.build(pj.assembler)
    r_j, rows_j = fk.res_jac(jnp.asarray(u), tj, None, interpret=True)
    ft = pt.assembler.fused_provider()
    r_t, rows_t = ft.res_jac(state_from_numpy(u, pt), tt)
    assert max_diff(r_t, r_j) < 1e-10
    assert len(rows_t) == len(rows_j) == 144
    for k, (rj, rt) in enumerate(zip(rows_j, rows_t)):
        assert _kind(rt) == _kind(rj), f"row {k}"
        if rj is not None:
            assert max_diff(rt, rj) < 1e-10, f"row {k}"
    assert ft.stats == {key: fk.stats[key] for key in ft.stats}
    n_var = 112 if case == "pspg_steady" else 144
    assert ft.stats["n_jac_rows"] == n_var and ft.stats["n_res_rows"] == 12
    assert sum(_kind(r) == "scalar" for r in rows_t) == 144 - n_var


# (config, stage?) -> (varying rows, constant rows)
CLASSES = {
    "pspg_steady": (lambda: channel_cfg(4, 4), False, 112),
    "pspg_steady_visc_x": (lambda: channel_cfg(4, 4, visc="0.1 + 0.01*x"),
                           False, 112),
    "supg_steady": (lambda: channel_cfg(4, 4, supg=True), False, 144),
    "pspg_stage": (lambda: _stage_cfg(supg=False), True, 112),
    "supg_stage_visc_x": (lambda: _stage_cfg(visc="0.1 + 0.01*x"), True,
                          144),
}


@pytest.mark.parametrize("name", sorted(CLASSES))
def test_row_classification_and_general_path(name):
    """The probe's classes (PSPG: 112 varying rows and the 32 of the
    momentum-pressure block constant, whatever the viscosity; SUPG: all
    144 varying), and the provider's residual, Jacobian, apply and diag
    against the port's general path, also at Newton's line-search point."""
    from mrhyde_tpu_torch.assembly.assembler import TimeCoeffs
    from mrhyde_tpu_torch.problem import Problem
    build, stage, n_var = CLASSES[name]
    pt = Problem(build(), device="cpu")
    asm = pt.assembler
    if stage:
        n = pt.n_dof
        tt = time_coeffs_from_numpy(
            NS_STAGE1[0], seeded(n, seed=31), NS_STAGE1[1],
            seeded(n, seed=32, scale=5.0), 0.3, 0.01, pt)
    else:
        tt = TimeCoeffs.steady(pt.n_dof)
    ut = state_from_numpy(seeded(pt.n_dof, seed=22), pt)
    r, J = asm.res_and_jac(ut, tt)
    kinds = [_kind(x) for x in J.vol_soa]
    assert kinds.count("array") == n_var
    const = tuple(k for k, kd in enumerate(kinds) if kd == "scalar")
    assert const == (PRESSURE_BLOCK if n_var == 112 else ())
    assert max_diff(r, asm.residual(ut, tt)) < 1e-11
    Jg = asm.jacobian(ut, tt)
    assert max_diff(J.aos(), Jg.vol) < 1e-11
    v = state_from_numpy(seeded(pt.n_dof, seed=23, scale=1.0), pt)
    assert max_diff(J.apply(v), Jg.apply(v)) < 1e-11
    assert J._aos_cache is not None       # varying rows: the AoS product
    assert max_diff(J.diag(), Jg.diag()) < 1e-11
    w = ut + 0.5 * v
    assert max_diff(asm.res_and_jac(w, tt)[0], asm.residual(w, tt)) < 1e-11


@pytest.mark.parametrize("supg", [False, True])
def test_first_newton_step_from_rest_is_finite(supg):
    """At u = 0 tau takes its u2 branch: no derivative of sqrt at 0, so
    every row is finite and the pressure rows carry PSPG's tau."""
    from mrhyde_tpu_torch.assembly.assembler import TimeCoeffs
    from mrhyde_tpu_torch.problem import Problem
    pt = Problem(channel_cfg(6, 5, supg=supg), device="cpu")
    u0 = pt.initial_state()
    assert float(u0.abs().max()) == 0.0
    r, J = pt.assembler.res_and_jac(u0, TimeCoeffs.steady(pt.n_dof))
    rows = [x for x in J.vol_soa if x is not None]
    assert all(bool(torch.isfinite(x).all()) for x in rows)
    assert bool(torch.isfinite(r).all()) and float(r.abs().max()) > 0
    Jg = pt.assembler.jacobian(u0, TimeCoeffs.steady(pt.n_dof))
    assert max_diff(J.aos(), Jg.vol) < 1e-11
    assert float(J.aos()[:, 8:, 8:].abs().max()) > 0


def _kernel_inputs(N0, N1, transient):
    from mrhyde_tpu_torch.problem import Problem
    tab = Problem(channel_cfg(N0, N1), device="cpu").assembler \
        .fused_provider().tables
    rng = np.random.RandomState(7)
    ue = torch.as_tensor(rng.randn(3, N0 + 1, N1 + 1))
    ud = torch.as_tensor(rng.randn(3, N0 + 1, N1 + 1)) if transient else None
    visc = torch.as_tensor(0.1 + 0.01 * rng.rand(N0 * N1, tab.Q))
    form = fn.NSForm(True, transient, 0.4, 0.01, transient)
    stage = fp.Stage(*NS_STAGE1, None) if transient else None
    return ue, ud, (1.0, visc, 1.0, 0.0), tab, form, stage


@pytest.mark.parametrize("transient", [False, True])
def test_wrapper_takes_plain_version_on_cpu_tensors(transient):
    ue, ud, coeffs, tab, form, stage = _kernel_inputs(5, 3, transient)
    jac_idx = tuple(k for k in range(144)
                    if transient or k not in PRESSURE_BLOCK)
    before = dict(fp.LAUNCHES)
    out, jac = fn.ns_node_full(ue, ud, coeffs, tab, form, jac_idx, stage)
    ref, jref = fn.ns_node_full_plain(ue, ud, coeffs, tab, form, jac_idx,
                                      stage)
    assert torch.equal(out, ref) and torch.equal(jac, jref)
    assert out.shape == (3, 6, 4) and jac.shape == (len(jac_idx), 15)
    assert fp.LAUNCHES == before          # plain versions launch nothing
    # a row the probe would call constant must not come back varying
    with pytest.raises(AssertionError):
        fn.ns_node_full_plain(ue, ud, coeffs, tab, form, jac_idx[1:], stage)


def test_sparse_dual_matches_torch_jacfwd():
    """The sparse dual's tangents of the NS density equal torch.func's
    dense forward derivatives, structural zeros included, and where_
    follows the selected branch (tau at u = 0 is finite)."""
    from mrhyde_tpu_torch.physics.navierstokes import ns_density
    rng = np.random.RandomState(3)
    z0 = [torch.as_tensor(rng.randn(5)) for _ in range(12)]
    z0[0][2] = z0[1][2] = 0.0                    # |u| = 0 at one point
    visc = torch.as_tensor(0.1 + rng.rand(5))

    def f(z):
        out = ns_density(z[0:2], z[3:5], [z[6:8], z[8:10]], z[2], z[10:12],
                         1.3, visc, [1.0, -0.5], 0.2, 0.01, True, True,
                         True)
        return [out[v][0] for v in ("ux", "uy", "pr")] + \
            [x for v in ("ux", "uy", "pr") for x in out[v][1]]

    out0, D = sparse_jacfwd(f, z0)
    for k in range(12):
        def fk(x, k=k):
            return torch.stack([torch.broadcast_to(
                torch.as_tensor(o, dtype=torch.float64), (5,))
                for o in f(z0[:k] + [x] + z0[k + 1:])])
        ref = torch.func.jvp(fk, (z0[k],), (torch.ones(5, dtype=z0[k].dtype),))
        for oi in range(9):
            got = D[k][oi]
            want = ref[1][oi]
            assert torch.isfinite(want).all()
            if got is None:
                assert float(want.abs().max()) == 0.0
            else:
                assert max_diff(torch.broadcast_to(torch.as_tensor(
                    got, dtype=torch.float64), (5,)), want) < 1e-13
    s = where_(torch.tensor([False]), SDual(torch.tensor([0.0]), {0: 1.0}),
               2.0)
    assert float(s.tan[0]) == 0.0


@pytest.mark.parametrize("mesh", [
    {"element type": "quad", "order": 2},
    {"element type": "hex", "order": 1, "dimension": 3}])
def test_ns_decks_for_the_element_tile_kernel_raise(mesh):
    """3D hex and p2 quad NS decks run on the JAX package's element-tile
    kernel B1. They raised while it was not ported; now they build the
    provider's B1 path (`ns_elem_full`, not the node kernel), and no
    longer the general path either (test_torch_fused_ns_elem*.py hold it
    to JAX)."""
    from mrhyde_tpu_torch.problem import Problem
    cfg = channel_cfg(2, 2)
    order = mesh.pop("order")
    cfg["Mesh"].update(mesh, NZ=2)
    cfg["Discretization"]["order"] = {v: order for v in ("ux", "uy", "pr")}
    fused = Problem(cfg, device="cpu").assembler.fused_provider()
    assert isinstance(fused, fn.FusedNSAssembly) and not fused.node
    assert fused.nd == (27 if order == 2 else 32)
    assert fused.stats["node_scatter"] is False
