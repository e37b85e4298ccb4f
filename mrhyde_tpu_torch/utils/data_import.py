"""External field/sensor data import.

A copy of the JAX package's numpy-only `mrhyde_tpu/utils/data_import.py`.

Reference: src/tools/data.{hpp,cpp} (sensor files, point clouds,
per-element data) and the CompadreInterface nearest-neighbor/GMLS
interpolation (src/interfaces/CompadreInterface.hpp). The GMLS analog
here is moving-least-squares with a polynomial basis solved by batched
least squares — vectorized over evaluation points.
"""

from __future__ import annotations

import numpy as np

__all__ = ["load_sensor_file", "nearest_neighbor", "mls_interpolate"]


def load_sensor_file(points_file: str, data_file: str | None = None):
    """Sensor locations (P, dim) and optional data (P, T) from text files
    (reference sensor format: whitespace-separated columns)."""
    pts = np.atleast_2d(np.loadtxt(points_file))
    data = None
    if data_file:
        data = np.atleast_2d(np.loadtxt(data_file))
        if data.shape[0] != pts.shape[0]:
            data = data.T
    return pts, data


def nearest_neighbor(cloud: np.ndarray, queries: np.ndarray) -> np.ndarray:
    """Index of the nearest cloud point for each query (brute force,
    vectorized — the reference uses Compadre's KNN search)."""
    cloud = np.atleast_2d(cloud)
    queries = np.atleast_2d(queries)
    d2 = ((queries[:, None, :] - cloud[None, :, :]) ** 2).sum(axis=2)
    return np.argmin(d2, axis=1)


def mls_interpolate(cloud: np.ndarray, values: np.ndarray,
                    queries: np.ndarray, *, n_neighbors: int = 8,
                    order: int = 1, eps: float = 1e-12) -> np.ndarray:
    """Moving-least-squares interpolation (GMLS analog).

    Fits a degree-`order` polynomial to the n nearest neighbors of each
    query with inverse-distance weights and evaluates it at the query.
    """
    cloud = np.atleast_2d(cloud)
    queries = np.atleast_2d(queries)
    values = np.asarray(values, dtype=float)
    dim = cloud.shape[1]
    n_neighbors = min(n_neighbors, cloud.shape[0])

    d2 = ((queries[:, None, :] - cloud[None, :, :]) ** 2).sum(axis=2)
    idx = np.argsort(d2, axis=1)[:, :n_neighbors]       # (Q, k)
    nbr = cloud[idx]                                    # (Q, k, dim)
    val = values[idx]                                   # (Q, k)
    rel = nbr - queries[:, None, :]

    def basis(x):
        cols = [np.ones(x.shape[:-1])]
        if order >= 1:
            cols += [x[..., d] for d in range(dim)]
        if order >= 2:
            for a in range(dim):
                for b in range(a, dim):
                    cols.append(x[..., a] * x[..., b])
        return np.stack(cols, axis=-1)

    P = basis(rel)                                      # (Q, k, m)
    w = 1.0 / (np.sqrt((rel ** 2).sum(axis=2)) + eps)   # (Q, k)
    Pw = P * w[:, :, None]
    vw = val * w
    A = np.einsum("qki,qkj->qij", Pw, P)
    b = np.einsum("qki,qk->qi", Pw, val)
    coef = np.linalg.solve(
        A + eps * np.eye(A.shape[1])[None], b[..., None])[..., 0]
    return coef[:, 0]   # polynomial value at the query point (rel = 0)
