"""The multiscale subgrid method's other fine physics in
mrhyde_tpu_torch against the JAX package on the CPU in f64: the porous
"interface" terms and fluxes (mixed RT0 / p0 under an HFACE macro trace
aliased lambda -> p, weak Galerkin on conforming HDIV aliased pbndry ->
pint, the mixed form with its permeability from a subgrid mesh data
file) and the linear elasticity traction interface. Decks from
tests/torch_port_utils.py."""

import jax
import pytest
import torch

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

from torch_port_utils import (elasticity_subgrid_cfg,  # noqa: E402
                              porous_subgrid_cfg, solve_both)

torch.set_num_threads(1)

DECKS = {
    "porous_mixed": lambda d: porous_subgrid_cfg("mixed"),
    "porous_weak_galerkin": lambda d: porous_subgrid_cfg("wg"),
    "porous_mixed_data_file": lambda d: porous_subgrid_cfg("mixed",
                                                           data_dir=d),
    "elasticity": lambda d: elasticity_subgrid_cfg(),
}


@pytest.mark.parametrize("name", DECKS)
def test_subgrid_physics_matches_jax(name, tmp_path):
    """Every norm (the macro trace's L2-face or L2 and each fine
    variable's Subgrid-L2) at 1e-10 and the macro solution."""
    _rj, rt, pt = solve_both(DECKS[name](str(tmp_path)), rtol=1e-10)
    ms = pt.multiscale
    assert any(k[0] == "Subgrid-L2" for k in rt.errors)
    if name.startswith("porous"):
        trace = "lambda" if "mixed" in name else "pbndry"
        assert list(ms.var_map.values()).count(trace) == 1
    if name == "porous_mixed_data_file":
        assert ms._extra_np["mesh_data"].shape == (16, 4)
