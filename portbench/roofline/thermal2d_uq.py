"""The least work of one residual + Jacobian of `thermal2d_uq`.

The diffusion a and the source b are constants of a sample, so the
Jacobian is a times one stiffness matrix, the same for every state and
every element of the uniform grid: an implementation need not write it
per call. The least work of a call is then the residual's: the state
read once and the residual written once (16 bytes a node in float64),
and per element one product of the 4 x 4 element matrix with its corner
values (32 operations). Frozen from the counts with which the
repository's chip smoke script priced `thermal_node_state` (the port's
B2 "state" kernel) where its matrix is constant, so that a later change
to the program cannot move the yardstick.
"""


def work(deck, itemsize=8):
    """(bytes, operations) of one `Assembler.res_and_jac` call."""
    nx, ny = deck["Mesh"]["NX"], deck["Mesh"]["NY"]
    return itemsize * 2 * (nx + 1) * (ny + 1), 32 * nx * ny
