"""Convection-diffusion-reaction (cdr) and thermal with advection on 3D
hex (p1) and 2D p2 quads: the port's fused provider, through the plain
versions of its element kernels, against the JAX package's
FusedP1Assembly.res_jac in Pallas interpret mode, which runs the
element-tile TPU kernel B1 on the CPU: residual, the kind and value of
every Jacobian row, `stats`, and the BlockJacobian's apply and diag,
steady and at a DIRK-2,2 stage, with a constant and a rotating
(x-dependent) velocity, the reaction 1.0 (affine split) and 0.5 c^2
(mode "full"), density 2. Every velocity is nonzero, so every Jacobian
is nonsymmetric. (2D p1, B2: test_torch_cdr.py.)

Tolerance 1e-11 absolute: the same f64 weak form summed in the same
quadrature and corner order, on O(1) entries."""

import pytest
import torch

from torch_port_utils import check_provider_case

torch.set_num_threads(1)

# (physics, mesh, velocity, reaction, stage): each mesh in both modes,
# with both velocities, steady and at the stage; thermal advection on a
# 3x3x3 hex
ELEM_CASES = [
    ("cdr", "hex", "const", "1.0", True),
    ("cdr", "hex", "const", "0.5*c*c", False),
    ("cdr", "hex", "rot", "0.5*c*c", True),
    ("cdr", "p2", "const", "1.0", True),
    ("cdr", "p2", "const", "0.5*c*c", False),
    ("cdr", "p2", "rot", "1.0", False),
    ("thermal", "hex3", "rot", None, True),
]


@pytest.mark.parametrize(
    "physics,mesh,vel,reaction,stage", ELEM_CASES,
    ids=["-".join(str(x) for x in c) for c in ELEM_CASES])
def test_provider_matches_jax_element_kernel(physics, mesh, vel, reaction,
                                             stage):
    ft = check_provider_case(physics, mesh, vel, reaction, stage)
    assert not ft.node and ft.nc == (9 if mesh == "p2" else 8)
