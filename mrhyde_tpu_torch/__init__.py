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

Ported so far: thermal (with or without advection), cdr and
Navier-Stokes (PSPG/SUPG) on 2D p1 quads, 3D hex and 2D p2 quads,
Stokes, and the ODE module, steady and transient; everything else
raises NotImplementedError naming its ROADMAP item.
"""

__version__ = "0.1.0"

from mrhyde_tpu_torch.runtime import resolve_device, resolve_dtype  # noqa: F401
