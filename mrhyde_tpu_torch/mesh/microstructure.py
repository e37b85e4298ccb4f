"""Microstructure (grain) generation for crystal problems.

A copy of the JAX package's numpy-only `mrhyde_tpu/mesh/microstructure.py`:
the same numpy RandomState draws, so both packages grow the same grains.

Reference: meshInterface.hpp:304 generateNewMicrostructure + the
'number of seeds' / 'fast and crude microstructure' mesh keys — Voronoi
grains from random seed points, assigning each element a grain id and a
random crystal rotation. UQ can regenerate grains per sample
(analysisManager.cpp:339-345 'regenerate grains').
"""

from __future__ import annotations

import numpy as np

__all__ = ["generate_microstructure"]


def generate_microstructure(mesh, n_seeds: int = 10, seed: int = 1234,
                            weights=None):
    """Voronoi grains over element centroids.

    Returns dict with 'grain_ids' (E,), 'seed_points' (n_seeds, dim),
    'angles' (n_seeds,) random rotations (z-rotations in 2D, Euler in
    3D as (n_seeds, 3)).
    """
    rng = np.random.RandomState(seed)
    dim = mesh.dim
    lo = mesh.nodes.min(axis=0)
    hi = mesh.nodes.max(axis=0)
    seeds = lo + (hi - lo) * rng.rand(n_seeds, dim)
    cents = mesh.nodes[mesh.conn].mean(axis=1)
    d2 = ((cents[:, None, :] - seeds[None, :, :]) ** 2)
    if weights is not None:
        d2 = d2 * np.asarray(weights)[None, None, :dim]
    grain_ids = np.argmin(d2.sum(axis=2), axis=1)
    if dim == 2:
        angles = rng.uniform(0.0, np.pi / 2, size=n_seeds)
    else:
        angles = rng.uniform(0.0, np.pi / 2, size=(n_seeds, 3))
    return {"grain_ids": grain_ids.astype(np.int32),
            "seed_points": seeds, "angles": angles}
