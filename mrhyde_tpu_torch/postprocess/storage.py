"""Solution storage: an in-memory time series of solution vectors.

The port of the JAX package's `mrhyde_tpu/postprocess/storage.py`
(reference src/tools/solutionStorage.hpp:19-110): every accepted step
is stored with its time and looked up within `time_tol`; it feeds the
discrete-control objectives of a data-generating run and the text
dumps of checkpoint / restart (analysisManager.cpp:892
writeSolutionToText, :831 restartSolve). Vectors are kept as detached
tensors on their own device; the text files are numpy's.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["SolutionStorage"]


class SolutionStorage:
    def __init__(self, max_storage: int = 100, time_tol: float = 1e-10):
        self.max_storage = max_storage
        self.time_tol = time_tol
        self.times: list[float] = []
        self.data: list = []

    def store(self, vec, time: float):
        self.times.append(float(time))
        self.data.append(vec.detach().clone()
                         if isinstance(vec, torch.Tensor)
                         else torch.as_tensor(np.asarray(vec)))
        if len(self.data) > self.max_storage:
            self.times.pop(0)
            self.data.pop(0)

    def extract(self, time: float):
        """The stored vector at `time` (within tolerance), or None."""
        for t, v in zip(self.times, self.data):
            if abs(t - time) < self.time_tol:
                return v
        return None

    def extract_index(self, index: int):
        return self.data[index]

    def __len__(self):
        return len(self.data)

    # ---- text checkpoints ----

    def write_text(self, prefix: str):
        np.savetxt(f"{prefix}_times.dat", np.asarray(self.times))
        np.savetxt(f"{prefix}_data.dat",
                   np.stack([v.cpu().numpy() for v in self.data])
                   if self.data else np.zeros((0, 0)))

    @classmethod
    def read_text(cls, prefix: str, **kw):
        self = cls(**kw)
        times = np.atleast_1d(np.loadtxt(f"{prefix}_times.dat"))
        data = np.atleast_2d(np.loadtxt(f"{prefix}_data.dat"))
        for t, v in zip(times, data):
            self.store(torch.as_tensor(v), t)
        return self
