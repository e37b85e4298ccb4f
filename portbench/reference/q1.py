"""Bilinear (Q1) finite elements on a uniform rectangle, in plain PyTorch.

The shared part of the benchmark's plain references: the structured mesh
of an `NX` x `NY` box, the 2 x 2 Gauss rule (a deck's `quadrature: 2`),
the four corner basis functions and their gradients at its points, and
the gather and scatter between node vectors and elements. Nodes are
numbered x-major (node (i, j) is i (NY + 1) + j) and each variable's
nodes form one block of the state, in the deck's variable order: the
layout of the state the program returns. Imports nothing but torch.
"""

from __future__ import annotations

import math

import torch

# the reference quad's corners, counter-clockwise
_CORNERS = ((-1.0, -1.0), (1.0, -1.0), (1.0, 1.0), (-1.0, 1.0))


class Grid:
    """An nx x ny box of equal rectangles on `device` in `dtype`."""

    def __init__(self, nx, ny, xmin, xmax, ymin, ymax, device,
                 dtype=torch.float64):
        self.nx, self.ny = int(nx), int(ny)
        self.device, self.dtype = device, dtype
        self.dx = (xmax - xmin) / nx
        self.dy = (ymax - ymin) / ny
        self.n_nodes = (nx + 1) * (ny + 1)
        self.n_elems = nx * ny
        kw = dict(device=device, dtype=dtype)
        xs = torch.linspace(xmin, xmax, nx + 1, **kw)
        ys = torch.linspace(ymin, ymax, ny + 1, **kw)
        X, Y = torch.meshgrid(xs, ys, indexing="ij")
        self.x, self.y = X.reshape(-1), Y.reshape(-1)
        i = torch.arange(nx, device=device).repeat_interleave(ny)
        j = torch.arange(ny, device=device).repeat(nx)
        n0 = i * (ny + 1) + j
        self.conn = torch.stack([n0, n0 + ny + 1, n0 + ny + 2, n0 + 1], 1)
        g = 1.0 / math.sqrt(3.0)
        pts = [(a, b) for a in (-g, g) for b in (-g, g)]
        # phi (Q, 4), grad (Q, 4, 2) in physical units, weights (Q,)
        self.phi = torch.tensor(
            [[(1 + a * ca) * (1 + b * cb) / 4 for ca, cb in _CORNERS]
             for a, b in pts], **kw)
        self.grad = torch.tensor(
            [[[ca * (1 + b * cb) / 4 * 2 / self.dx,
               cb * (1 + a * ca) / 4 * 2 / self.dy]
              for ca, cb in _CORNERS] for a, b in pts], **kw)
        self.wts = torch.full((4,), self.dx * self.dy / 4, **kw)
        # the element size h = area^(1/2)
        self.h = math.sqrt(self.dx * self.dy)
        x0 = self.x[self.conn[:, 0]]
        y0 = self.y[self.conn[:, 0]]
        self.xq = x0[:, None] + torch.tensor(
            [(a + 1) / 2 * self.dx for a, _ in pts], **kw)[None, :]
        self.yq = y0[:, None] + torch.tensor(
            [(b + 1) / 2 * self.dy for _, b in pts], **kw)[None, :]
        jj = torch.arange(self.n_nodes, device=device) % (ny + 1)
        ii = torch.arange(self.n_nodes, device=device) // (ny + 1)
        self.side = {"bottom": jj == 0, "top": jj == ny, "left": ii == 0,
                     "right": ii == nx}
        self.boundary = (self.side["bottom"] | self.side["top"]
                         | self.side["left"] | self.side["right"])

    def values(self, ue):
        """(E, Q) values at the qps of element corner values (E, 4)."""
        return ue @ self.phi.T

    def grads(self, ue):
        """(E, Q, 2) gradients at the qps of corner values (E, 4)."""
        return torch.einsum("ea,qad->eqd", ue, self.grad)

    def scatter(self, re):
        """Node vector of element rows (E, 4)."""
        out = torch.zeros(self.n_nodes, dtype=re.dtype, device=re.device)
        return out.index_add_(0, self.conn.reshape(-1), re.reshape(-1))
