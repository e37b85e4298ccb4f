"""The port's general assembly path (vmap'd element residual,
vmap(jacfwd) Jacobian, BlockJacobian apply/diag/dense) against the JAX
package's general path on a 6x5 mesh, for a constant, a
coordinate-dependent and a state-dependent conductivity.

Tolerance 1e-11 absolute: both sides run the same f64 weak form; the
sums over quadrature points and incidence run in other orders (einsum
vs XLA), so agreement is to rounding of O(1e-15) per term times the
entry count."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrhyde_tpu_torch.interop import state_from_numpy
from torch_port_utils import (KAPPAS, both_problems, max_diff, seeded,
                              steady_coeffs, thermal_cfg)

torch.set_num_threads(1)

TOL = 1e-11


def _setup(kappa, cell="quad"):
    cfg = thermal_cfg(6, 5, kappa=kappa)
    cfg["Mesh"]["element type"] = cell
    pj, pt = both_problems(cfg)
    tj, tt = steady_coeffs(pj, pt)
    u = seeded(pj.n_dof, seed=3)
    return pj, pt, tj, tt, u


@pytest.mark.parametrize("kappa", KAPPAS)
def test_general_residual_matches_jax(kappa):
    pj, pt, tj, tt, u = _setup(kappa)
    ref = pj.assembler.residual(jnp.asarray(u), tj)
    out = pt.assembler.residual(state_from_numpy(u, pt), tt)
    assert max_diff(out, ref) < TOL


@pytest.mark.parametrize("kappa", KAPPAS)
def test_triangle_mesh_general_path_matches_jax(kappa):
    """Triangles: no structured index and per-element geometry (vmap
    over the geometry tables), the gather through lids and inc."""
    pj, pt, tj, tt, u = _setup(kappa, cell="tri")
    assert pt.assembler._structured is None
    assert pt.assembler.fused_provider() is None
    Jj = pj.assembler.jacobian(jnp.asarray(u), tj)
    Jt = pt.assembler.jacobian(state_from_numpy(u, pt), tt)
    assert max_diff(Jt.dense(), Jj.dense()) < TOL
    ref = pj.assembler.residual(jnp.asarray(u), tj)
    out = pt.assembler.residual(state_from_numpy(u, pt), tt)
    assert max_diff(out, ref) < TOL


@pytest.mark.parametrize("kappa", KAPPAS)
def test_general_jacobian_dense_matches_jax(kappa):
    pj, pt, tj, tt, u = _setup(kappa)
    Jj = pj.assembler.jacobian(jnp.asarray(u), tj)
    Jt = pt.assembler.jacobian(state_from_numpy(u, pt), tt)
    assert max_diff(Jt.vol, Jj.vol) < TOL
    assert max_diff(Jt.dense(), Jj.dense()) < TOL


@pytest.mark.parametrize("kappa", KAPPAS)
def test_block_jacobian_apply_and_diag_match_jax(kappa):
    pj, pt, tj, tt, u = _setup(kappa)
    Jj = pj.assembler.jacobian(jnp.asarray(u), tj)
    Jt = pt.assembler.jacobian(state_from_numpy(u, pt), tt)
    v = seeded(pj.n_dof, seed=4, scale=1.0)
    ref = Jj.apply(jnp.asarray(v))
    assert max_diff(Jt.apply(state_from_numpy(v, pt)), ref) < TOL
    av = pt.assembler.matfree_apply_fn(Jt)(state_from_numpy(v, pt))
    assert max_diff(av, ref) < TOL
    assert max_diff(Jt.diag(), Jj.diag()) < TOL


def test_soa_rows_apply_like_aos_blocks():
    """The SoA row layout (None / 0-d / (E,) rows) applies, diagonalizes
    and densifies exactly like the AoS blocks it came from."""
    from mrhyde_tpu_torch.assembly.assembler import BlockJacobian
    _pj, pt, _tj, tt, u = _setup("1.0 + e*e")
    Jt = pt.assembler.jacobian(state_from_numpy(u, pt), tt)
    nd = Jt.vol.shape[1]
    rows = [Jt.vol[:, k // nd, k % nd] for k in range(nd * nd)]
    rows[1] = None
    rows[2] = torch.tensor(0.25, dtype=torch.float64)
    aos = torch.stack([torch.zeros_like(rows[0]) if r is None
                       else torch.broadcast_to(r, rows[0].shape)
                       for r in rows], dim=1).reshape(-1, nd, nd)
    Ja = BlockJacobian(vol=aos, vol_lids=Jt.vol_lids, fixed=Jt.fixed,
                       inc=Jt.inc)
    Js = BlockJacobian(vol=None, vol_lids=Jt.vol_lids, fixed=Jt.fixed,
                       inc=Jt.inc, vol_soa=rows)
    v = torch.as_tensor(seeded(pt.n_dof, seed=5, scale=1.0))
    assert max_diff(Js.apply(v), Ja.apply(v)) < 1e-14
    assert max_diff(Js.diag(), Ja.diag()) < 1e-14
    assert max_diff(Js.dense(), Ja.dense()) < 1e-14
    assert np.array_equal(Js.aos().numpy(), aos.numpy())
