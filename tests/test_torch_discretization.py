"""The port's copied host modules number everything as the JAX package
does: lids, var_start, the strong-Dirichlet `fixed` dofs, the basis and
quadrature tables. Compared EXACTLY (the modules are identical numpy
code), which is what lets state cross between the packages index by
index."""

import numpy as np
import pytest
import torch

from torch_port_utils import both_problems, thermal_cfg

torch.set_num_threads(1)

MESHES = [(6, 5), (4, 4), (3, 7)]


@pytest.mark.parametrize("nx,ny", MESHES)
def test_dof_numbering_and_dirichlet_dofs_match(nx, ny):
    pj, pt = both_problems(thermal_cfg(nx, ny))
    assert pt.n_dof == pj.n_dof
    assert np.array_equal(pt.disc.lids, pj.disc.lids)
    assert np.array_equal(pt.disc.dofmap.var_start, pj.disc.dofmap.var_start)
    assert np.array_equal(pt.bcs.fixed_dofs, pj.bcs.fixed_dofs)
    assert np.array_equal(pt.assembler.fixed.numpy(),
                          np.asarray(pj.assembler.fixed))
    assert np.array_equal(pt.assembler.inc.numpy(),
                          np.asarray(pj.assembler.inc))
    assert pt.assembler._structured["dims"] == pj.assembler._structured["dims"]


@pytest.mark.parametrize("nx,ny", MESHES)
def test_basis_and_quadrature_tables_match(nx, ny):
    pj, pt = both_problems(thermal_cfg(nx, ny))
    dj, dt = pj.disc, pt.disc
    assert np.array_equal(dt.wts, dj.wts)
    assert np.array_equal(dt.ip, dj.ip)
    assert dt.basis_keys == dj.basis_keys
    for key in dj.basis_vals:
        assert np.array_equal(dt.basis_vals[key], dj.basis_vals[key])
        assert np.array_equal(dt.basis_grads[key], dj.basis_grads[key])
    assert pt.assembler.uniform == pj.assembler.uniform
    assert np.array_equal(pt.assembler.g_wts.numpy(),
                          np.asarray(pj.assembler.g_wts))


def test_dirichlet_values_match_with_expression_data():
    """Expression Dirichlet data goes through the boundary L2 projection
    in both packages (f64; 1e-13 for the small dense solve)."""
    cfg = thermal_cfg(5, 4)
    cfg["Physics"]["Dirichlet conditions"] = {
        "e": {"left": "1.0 + y*y", "right": 0.5, "top": "x", "bottom": 0.0}}
    pj, pt = both_problems(cfg)
    assert np.array_equal(pt.bcs.fixed_dofs, pj.bcs.fixed_dofs)
    ref = np.asarray(pj.initial_state())
    out = pt.initial_state().numpy()
    assert float(np.max(np.abs(out - ref))) < 1e-13
