"""1D Karhunen-Loeve expansion for exponential-covariance random fields.

The port's copy of the JAX package's `mrhyde_tpu/utils/klexpansion.py`
(reference src/tools/klexpansion.hpp:17-100): solves the transcendental
eigenvalue problem for cov(x,y) = sigma^2 exp(-|x-y|/L) on [0, domain]:
roots w_i of (L^2 w^2 - 1) sin(w d) = 2 L w cos(w d), eigenvalues
lambda_i = 2 sigma^2 L / (L^2 w_i^2 + 1), eigenfunctions
phi_i(x) = c (sin(w_i x) + L w_i cos(w_i x)).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["KLExpansion"]


class KLExpansion:
    def __init__(self, n_terms: int, domain_length: float = 1.0,
                 correlation_length: float = 1.0, sigma: float = 1.0):
        self.N = int(n_terms)
        self.d = float(domain_length)
        self.L = float(correlation_length)
        self.sigma = float(sigma)
        self.omega = self._find_roots()
        self.lam = (2.0 * self.sigma ** 2 * self.L
                    / (self.L ** 2 * self.omega ** 2 + 1.0))

    def _f(self, w):
        return ((self.L ** 2 * w ** 2 - 1.0) * np.sin(w * self.d)
                - 2.0 * self.L * w * np.cos(w * self.d))

    def _find_roots(self) -> np.ndarray:
        """Bisection on the sign changes of the characteristic function."""
        roots = []
        w = 1e-8
        step = np.pi / self.d / 50.0
        prev = self._f(w)
        while len(roots) < self.N:
            w2 = w + step
            cur = self._f(w2)
            if prev * cur < 0:
                a, b = w, w2
                for _ in range(80):
                    m = 0.5 * (a + b)
                    if self._f(a) * self._f(m) <= 0:
                        b = m
                    else:
                        a = m
                roots.append(0.5 * (a + b))
            w, prev = w2, cur
        return np.asarray(roots)

    def eigenvalue(self, i: int) -> float:
        return float(self.lam[i])

    def _scale(self, i):
        w = float(self.omega[i])
        return w, 1.0 / np.sqrt((self.L ** 2 * w ** 2 + 1.0) * self.d / 2.0
                                + self.L)

    def eigenfunction(self, i: int, x):
        """phi_i at x: numpy in, numpy out; a tensor in, a tensor out
        (traceable inside the element residual)."""
        w, c = self._scale(i)
        if isinstance(x, torch.Tensor):
            return c * (torch.sin(w * x) + self.L * w * torch.cos(w * x))
        x = np.asarray(x)
        return c * (np.sin(w * x) + self.L * w * np.cos(w * x))

    def field(self, x, coeffs) -> np.ndarray:
        """KL realization: sum_i sqrt(lambda_i) xi_i phi_i(x)."""
        coeffs = np.asarray(coeffs)
        out = np.zeros_like(np.asarray(x, dtype=float))
        for i in range(min(self.N, coeffs.shape[0])):
            out = out + np.sqrt(self.lam[i]) * coeffs[i] \
                * self.eigenfunction(i, x)
        return out
