"""UQ: Monte-Carlo sampling, moments, KDE, rejection sampling.

The port of the JAX package's `mrhyde_tpu/analysis/uq.py` (reference
UQManager: uqManager.cpp:53-140 generateSamples, :249 KDE, rejection
sampling hpp:147; the UQSolve loop, analysisManager.cpp:269-415).
Samples are drawn per distribution with numpy's RandomState from the
deck's seed, so both packages draw the same numbers, or read from a
user-defined sample file. The ensemble runs as a plain loop over
samples (`run`) or as one batched call over the sample axis
(`run_vmapped`, torch.func.vmap: the ensemble-parallel path).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["UQManager", "kde", "rejection_sampling"]


class UQManager:
    def __init__(self, param_manager, uq_cfg: dict | None = None):
        self.pm = param_manager
        cfg = uq_cfg or {}
        self.n_samples = int(cfg.get("samples", 100))
        self.seed = int(cfg.get("seed", 1234))
        # a user-supplied sample file (UQ 'use user defined' + 'source',
        # uqManager.cpp loadUserDefinedData): its columns map to the
        # stochastic parameters in declaration order
        self.user_file = (str(cfg["source"])
                          if cfg.get("use user defined") else None)

    def generate_samples(self, n=None, seed=None) -> dict:
        """name -> (n,) array of samples of each stochastic parameter
        ((n, k) for a vector of k components)."""
        if self.user_file is not None:
            # ndmin=2 keeps a one-column file of N samples as (N, 1)
            data = np.loadtxt(self.user_file, ndmin=2)
            self.n_samples = data.shape[0]
            cols = {}
            col = 0
            for name in self.pm.stochastic_names():
                size = np.atleast_1d(
                    np.asarray(self.pm.specs[name].value)).size
                block = data[:, col:col + size]
                cols[name] = block[:, 0] if size == 1 else block
                col += size
            return cols
        n = n or self.n_samples
        rng = np.random.RandomState(seed if seed is not None else self.seed)
        out = {}
        for name in self.pm.stochastic_names():
            s = self.pm.specs[name]
            # a vector parameter draws one value per component per sample
            shape = ((n,) + np.atleast_1d(np.asarray(s.value)).shape
                     if np.ndim(s.value) else (n,))
            if s.distribution.lower() == "uniform":
                out[name] = rng.uniform(s.min, s.max, size=shape)
            elif s.distribution.lower() == "gaussian":
                out[name] = rng.normal(s.mean, np.sqrt(s.variance),
                                       size=shape)
            else:
                raise ValueError(f"unknown distribution {s.distribution!r}")
        return out

    def generate_integer_samples(self, n=None, seed=None, lo=0, hi=100):
        n = n or self.n_samples
        rng = np.random.RandomState(seed if seed is not None else self.seed)
        return rng.randint(lo, hi, size=n)

    @staticmethod
    def moments(responses: np.ndarray):
        responses = np.asarray(responses)
        return {"mean": responses.mean(axis=0),
                "variance": responses.var(axis=0, ddof=1)
                if responses.shape[0] > 1 else 0.0 * responses.mean(axis=0)}

    def run(self, forward_fn, collect_fn=None, verbose=0):
        """The sequential Monte-Carlo loop (the reference's UQSolve).

        forward_fn(sample_dict) -> response (a scalar or an array)."""
        samples = self.generate_samples()
        responses = []
        for j in range(self.n_samples):
            r = forward_fn({k: v[j] for k, v in samples.items()})
            if collect_fn is not None:
                r = collect_fn(r)
            responses.append(np.asarray(r))
            if verbose:
                print(f"Finished evaluating sample number: {j + 1} "
                      f"out of {self.n_samples}")
        return samples, np.stack(responses)

    def run_vmapped(self, forward_fn, device=None, dtype=torch.float64):
        """The batched ensemble: forward_fn torch.func.vmap'd over the
        sample axis of the same seeded samples, as tensors on `device`
        (the card unless the caller asks for the CPU). forward_fn maps
        one sample's {name: 0-d (or (k,)) tensor} to its response, in
        torch operations vmap can batch. Returns (samples, responses)
        like `run`."""
        from mrhyde_tpu_torch.runtime import resolve_device
        dev = resolve_device(device)
        samples = self.generate_samples()
        batched = {k: torch.as_tensor(np.asarray(v), dtype=dtype,
                                      device=dev)
                   for k, v in samples.items()}
        out = torch.func.vmap(forward_fn)(batched)
        return samples, out.detach().cpu().numpy()


def kde(points: np.ndarray, data: np.ndarray) -> np.ndarray:
    """Gaussian kernel density estimate of `data` evaluated at `points`,
    Scott's-rule bandwidth per dimension (reference uqManager.cpp:249
    computeKDE)."""
    data = np.atleast_2d(np.asarray(data, dtype=float))
    if data.shape[0] == 1:
        data = data.T
    points = np.atleast_2d(np.asarray(points, dtype=float))
    if points.shape[0] == 1:
        points = points.T
    n, d = data.shape
    sig = data.std(axis=0, ddof=1)
    bw = sig * n ** (-1.0 / (d + 4))
    bw = np.where(bw <= 0, 1.0, bw)
    diff = (points[:, None, :] - data[None, :, :]) / bw[None, None, :]
    k = np.exp(-0.5 * np.sum(diff * diff, axis=2))
    norm = np.prod(bw) * (2 * np.pi) ** (d / 2)
    return k.sum(axis=1) / (n * norm)


def rejection_sampling(ratios: np.ndarray, seed: int = 1234) -> np.ndarray:
    """Accept / reject mask from density ratios (reference uqManager
    rejectionSampling): accept where ratio / max > u ~ U(0, 1)."""
    ratios = np.asarray(ratios, dtype=float)
    rng = np.random.RandomState(seed)
    u = rng.uniform(0.0, 1.0, size=ratios.shape[0])
    return (ratios / ratios.max()) > u
