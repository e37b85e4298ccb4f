"""mrhyde_tpu_torch — the PyTorch/CUDA port of mrhyde_tpu.

The JAX package `mrhyde_tpu` is the reference; this package runs the
same decks through the same entry points (`Problem(cfg).run()`,
`python -m mrhyde_tpu_torch.driver deck.yaml`) on PyTorch tensors, with
the JAX package's two Pallas assembly kernels (node-scatter B2 and
element-tile B1) written by hand in CUDA C++ for Hopper (`ops/csrc/`).
It imports torch and numpy, never jax and never `mrhyde_tpu`; the
numpy-only host modules (mesh, fem, discretization, native) are copies,
so both packages number DOFs identically and state passes across index
by index (`interop.py`).

Ported: every physics module, mesh, basis and solver of the JAX package
on the fused kernels or the general path, steady and transient, and the
postprocessing and analyses (objectives, the Exodus writer, the adjoint
as a torch.autograd.Function, the ROL trust region, UQ / DCI,
discretized parameters, multi-set decks through `make_problem`), and
the multiscale subgrid method (`multiscale/`: the Subgrid sublist's
batched Dirichlet-to-Neumann fine solves, steady and transient, one model
or several), and distribution (`parallel/`: `Solver: shards` and the
CLI's `--shards` run the Newton solves DOF-sharded, or element-sharded
for a multiscale deck, over a shard communicator: every shard stacked on
one card, or one per torch.distributed rank).
"""

__version__ = "0.1.0"

from mrhyde_tpu_torch.runtime import resolve_device, resolve_dtype  # noqa: F401
