"""The multiscale subgrid method: batched Dirichlet-to-Neumann fine
solves coupled to the macro problem (multiscale/subgrid.py)."""
