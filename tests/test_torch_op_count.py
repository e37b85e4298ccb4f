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


def test_reaching_counts_what_the_results_need():
    gen = torch.Generator().manual_seed(5)
    a, b = (torch.rand(2, generator=gen, dtype=torch.float64)
            for _ in range(2))
    with cs._OpCount() as c:
        dead = torch.sin(a) * b
        live = a * b + a
        shared = live * live
    assert c.ops == 5
    assert c.reaching(live) == 2
    assert c.reaching([shared, None, 1.0], (live,)) == 3
    assert c.reaching(dead, shared) == 5


@pytest.mark.parametrize("stage", [False, True])
def test_lin_counts_no_coordinate_only_source(stage):
    """Mode "lin" (the state kernels' tangent-only pass) counts no
    operation of a source that reads only the coordinates: a density
    with sin(x) cos(y) counts as one without it, in mode "full" it
    costs its operations at every qp."""
    from mrhyde_tpu_torch.ops.fused_ns import accumulate_density
    tab = cs.quad_tables(4, 4, "cpu", torch.float64, 1.0, 1.0)[0]
    gen = torch.Generator().manual_seed(11)

    def standin():
        return torch.rand(2, generator=gen, dtype=torch.float64) + 0.5
    ue = [[standin() for _ in range(4)]]
    ud = [[standin() if stage else 0.0 for _ in range(4)]]
    xy = [[standin(), standin()] for _ in range(tab.Q)]

    def count(mode, source):
        def density(q, u, u_dot, g):
            s = 2.0 * u[0] * u[0] + u_dot[0]
            if source:
                s = s + torch.sin(xy[q][0]) * torch.cos(xy[q][1])
            return [s] + [(1.0 + 0.5 * xy[q][0]) * g[0][d]
                          for d in range(2)]
        with cs._OpCount() as c:
            results = accumulate_density(ue, ud, density, tab, 0.5,
                                         200.0 if stage else 0.0,
                                         not stage, mode)
        return c.reaching(*results)
    assert count("lin", True) == count("lin", False) > 0
    assert count("full", True) == count("full", False) + 4 * tab.Q


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
    # the pressure's u_dot, which no density reads, is not interpolated
    assert _p1_ops(n0, n1, 1.0, stage) == 4924
    # a viscosity that reads x costs its products at every qp
    assert _p1_ops(n0, n1, torch.zeros(1, 4), None) > 2736


@pytest.mark.parametrize("stage", [False, True])
def test_hex_counts_extrapolate_exactly_from_two_qps(stage, monkeypatch):
    """On hex p1 the counts extrapolate from one and two qps
    (`_ops_of_qps`): the basis takes no value 0 or 1 at a Gauss point
    (so no multiply is free at one qp and paid at another), and the
    extrapolation equals the whole count at 8 and 27 qps."""
    st = Stage(*cs.NS_STAGE1, None) if stage else None
    form = fn.NSForm(True, stage, 1.0, 0.01 if stage else 1.0, stage)
    whole_count = cs._ops_of_qps
    for quad in (2, 4):
        tab = cs.elem_tables("hex", (2, 2, 2), "cpu", torch.float64,
                             quadrature=quad)[0]
        counts = []
        for rule in (lambda ops, Q, _hex: ops(Q),
                     lambda ops, Q, _hex: ops(1) + (Q - 1) * (ops(2)
                                                             - ops(1))):
            monkeypatch.setattr(cs, "_ops_of_qps", rule)
            cs._NS_OPS.clear()
            counts.append(cs.ns_ops(tab, 8, (1.0, 1.0, 1.0, 0.0, 0.0), form,
                                    st))
        assert counts[0] == counts[1]
        monkeypatch.setattr(cs, "_ops_of_qps", whole_count)
        cs._NS_OPS.clear()
        assert cs.ns_ops(tab, 8, (1.0, 1.0, 1.0, 0.0, 0.0), form, st) \
            == counts[0]


def test_hex_set_counts_extrapolate_exactly_from_two_qps(monkeypatch):
    """The same of a module set's generated weak form (NS + cdr on hex
    at a PSPG+SUPG stage, set_ops) at 8 qps."""
    name = "ns+cdr pspg+supg dirk22 stage 1"
    tab = cs.elem_tables("hex", (4, 4, 4), "cpu", torch.float64,
                         cs.CHANNEL)[0]
    form, sc, _jac_idx, stage = cs.set_elem_case(name, 0.25)
    counts = []
    for rule in (lambda ops, Q, _hex: ops(Q),
                 lambda ops, Q, _hex: ops(1) + (Q - 1) * (ops(2) - ops(1))):
        monkeypatch.setattr(cs, "_ops_of_qps", rule)
        cs._SET_OPS.clear()
        counts.append(cs.set_ops(form, tab, sc, stage))
    assert counts[0] == counts[1] > 0


@pytest.mark.parametrize("name", ["thermal+cdr affine hex dirk22 stage 1",
                                  "thermal+cdr affine hex kappa=1+0.5x "
                                  "steady"])
def test_hex_state_counts_extrapolate_exactly_from_two_qps(name,
                                                           monkeypatch):
    """The same of an affine set's tangent-only pass (set_ops in mode
    "lin", set_elem_state's bound) at 8 qps."""
    tab = cs.elem_tables("hex", (2, 2, 2), "cpu", torch.float64,
                         (1.0, 1.0, 1.0))[0]
    form, sc, stage = cs.state_case(name, 0.5)
    counts = []
    for rule in (lambda ops, Q, _hex: ops(Q),
                 lambda ops, Q, _hex: ops(1) + (Q - 1) * (ops(2) - ops(1))):
        monkeypatch.setattr(cs, "_ops_of_qps", rule)
        cs._SET_OPS.clear()
        counts.append(cs.set_ops(form, tab, sc, stage, "lin"))
    assert counts[0] == counts[1] > 0
