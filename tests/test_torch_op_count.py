"""The operation counter behind chip_smoke.py's bounds of the
Navier-Stokes kernels (`_OpCount`, `ns_ops`): its rules on small
expressions, and the counts of the 2D p1 weak form, which do not depend
on the element's size."""

import math

import pytest
import torch

import chip_smoke as cs
from mrhyde_tpu_torch.ops import fused_ns as fn
from mrhyde_tpu_torch.ops.fused_p1 import Stage

torch.set_num_threads(1)


def _count(f):
    with cs._OpCount() as c:
        f()
    return c.ops


def test_rules():
    gen = torch.Generator().manual_seed(5)
    a, b = (torch.rand(2, generator=gen, dtype=torch.float64)
            for _ in range(2))
    # an FMA is two operations
    assert _count(lambda: a * b + a) == 2
    # multiplying by 1 or -1, adding or subtracting 0 and negating are free
    assert _count(lambda: (1.0 * a - 0.0) + (-a) * -1.0) == 1
    # an operation on tensors alone counts once however often it recurs
    assert _count(lambda: [torch.sqrt(b * b) for _ in range(3)]) == 2
    # float operands are never shared; arithmetic on floats alone is free
    assert _count(lambda: [0.5 * b for _ in range(3)]) == 3
    assert _count(lambda: 2.0 * 3.0) == 0


def _p1_ops(n0, n1, visc, stage):
    tab = cs.quad_tables(n0, n1, "cpu", torch.float64, 5.0, 1.0)[0]
    form = fn.NSForm(True, stage is not None, math.sqrt(sum(tab.wts)),
                     0.01 if stage else 1.0, stage is not None)
    cs._NS_OPS.clear()
    return cs.ns_ops(tab, 4, (1.0, visc, 1.0, 0.0), form, stage)


@pytest.mark.parametrize("n0,n1", [(4, 1), (7, 3)])
def test_p1_counts(n0, n1):
    stage = Stage(*cs.NS_STAGE1, None)
    assert _p1_ops(n0, n1, 1.0, None) == 2736
    assert _p1_ops(n0, n1, 1.0, stage) == 4952
    # a viscosity that reads x costs its products at every qp
    assert _p1_ops(n0, n1, torch.zeros(1, 4), None) > 2736
