"""The least work of one residual + Jacobian of `ns_channel_p1`.

Frozen from the counts with which the repository's chip smoke script
priced `ns_node_full` (the port's B2 Navier-Stokes kernel), taken once
at these decks' settings and written here as numbers, so that a later
change to the program cannot move the yardstick: the operations of one
element's weak form over its 4 quadrature points (values, gradients, the
density and its sparse derivatives, the residual rows, the column
tangents and sums of each element-varying Jacobian row; the qp weights
folded into the tables), plus 3 (4 E - nodes) adds of the residual's
scatter to the nodes; bytes the three fields read once, the node
residual written once and each element-varying Jacobian row written once
per element.

  steady, PSPG, nu and the source scalars: 2752 operations and 112
  varying rows per element; the state read and the residual written
"""

OPS, ROWS = 2752, 112


def work(deck, itemsize=8):
    """(bytes, operations) of one steady `Assembler.res_and_jac` call."""
    nx, ny = deck["Mesh"]["NX"], deck["Mesh"]["NY"]
    nodes, elems = (nx + 1) * (ny + 1), nx * ny
    return (itemsize * (3 * nodes * 2 + ROWS * elems),
            elems * OPS + 3 * (4 * elems - nodes))
