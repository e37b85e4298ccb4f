"""The port's CUDA kernels on the card (marked `cuda`; they skip on a
machine without one, since a CUDA kernel has no CPU mode). This file
imports no jax, so the card's machine runs it without the JAX package:

    python -m pytest --noconftest -q -m cuda tests/test_torch_kernels_cuda.py

Tolerances: 1e-12 (f64) and 1e-5 (f32) relative to max |plain|; kernel
and plain version sum the same terms in the same order, differing only
by fused multiply-adds."""

import numpy as np
import pytest
import torch

from torch_port_utils import (DIRK22_STAGE1, KAPPAS, MASSES, NS_STAGE1,
                              SOURCE, SOURCE3, SOURCE3_NL, SOURCE_NL,
                              as_transient, channel_cfg, hex_cfg,
                              ns_elem_cfg, p2_cfg, seeded, thermal_cfg,
                              transient_cfg)

torch.set_num_threads(1)

RTOL = {torch.float64: 1e-12, torch.float32: 1e-5}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _close(got, ref, dtype):
    torch.cuda.synchronize()
    scale = float(ref.abs().max())
    return float((got - ref).abs().max()) <= RTOL[dtype] * scale


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("shape", [(37, 29), (64, 128)])
def test_kernels_match_plain(shape, dtype):
    from mrhyde_tpu_torch.ops import fused_p1 as fp
    from mrhyde_tpu_torch.problem import Problem
    dev = _card()
    t0 = Problem(thermal_cfg(*shape), device="cpu").assembler \
        .fused_provider().tables
    tab = fp.QuadTables(np.asarray(t0.phi), np.asarray(t0.grad),
                        np.asarray(t0.wts), dev, dtype)
    gen = torch.Generator(device=dev).manual_seed(5)
    N0, N1 = shape
    u = torch.rand((N0 + 1, N1 + 1), generator=gen, device=dev, dtype=dtype)
    qp = [torch.rand((N0 * N1, tab.Q), generator=gen, device=dev,
                     dtype=dtype) for _ in range(4)]
    before = dict(fp.LAUNCHES)
    assert _close(fp.thermal_node_state(u, 1.25, tab),
                  fp.thermal_node_state_plain(u, 1.25, tab), dtype)
    assert _close(fp.thermal_node_state(u, qp[2], tab),
                  fp.thermal_node_state_plain(u, qp[2], tab), dtype)
    out, jac = fp.thermal_node_full(u, *qp, tab)
    ref, jref = fp.thermal_node_full_plain(u, *qp, tab)
    assert _close(out, ref, dtype) and _close(jac, jref, dtype)
    assert fp.LAUNCHES["state"] == before["state"] + 2
    assert fp.LAUNCHES["full"] == before["full"] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("shape", [(37, 29), (64, 128)])
def test_transient_kernels_match_plain(shape, dtype):
    """The transient variants (a Stage: alpha_u, alpha_t and the mass
    coefficient, scalar or per qp) against their plain versions."""
    from mrhyde_tpu_torch.ops import fused_p1 as fp
    from mrhyde_tpu_torch.problem import Problem
    dev = _card()
    t0 = Problem(thermal_cfg(*shape), device="cpu").assembler \
        .fused_provider().tables
    tab = fp.QuadTables(np.asarray(t0.phi), np.asarray(t0.grad),
                        np.asarray(t0.wts), dev, dtype)
    gen = torch.Generator(device=dev).manual_seed(7)
    N0, N1 = shape
    u = torch.rand((N0 + 1, N1 + 1), generator=gen, device=dev, dtype=dtype)
    qp = [torch.rand((N0 * N1, tab.Q), generator=gen, device=dev,
                     dtype=dtype) for _ in range(5)]
    before = dict(fp.LAUNCHES)
    for stage in (fp.Stage(*DIRK22_STAGE1, 1.5), fp.Stage(0.0, 20.0, qp[4])):
        for kappa in (1.25, qp[2]):
            assert _close(fp.thermal_node_state(u, kappa, tab, stage),
                          fp.thermal_node_state_plain(u, kappa, tab, stage),
                          dtype)
        out, jac = fp.thermal_node_full(u, *qp[:4], tab, stage)
        ref, jref = fp.thermal_node_full_plain(u, *qp[:4], tab, stage)
        assert _close(out, ref, dtype) and _close(jac, jref, dtype)
    assert fp.LAUNCHES["state"] == before["state"] + 4
    assert fp.LAUNCHES["full"] == before["full"] + 2


@pytest.mark.cuda
@pytest.mark.parametrize("mass", MASSES, ids=["m1", "m2x"])
@pytest.mark.parametrize("kappa", KAPPAS)
def test_transient_provider_on_card_matches_cpu(kappa, mass):
    """One DIRK-2,2 stage-1 call of the provider on CUDA (kernels)
    against the same call on the CPU (plain versions), f64."""
    from mrhyde_tpu_torch.interop import (state_from_numpy, state_to_numpy,
                                          time_coeffs_from_numpy)
    from mrhyde_tpu_torch.problem import Problem
    dev = _card()
    cfg = transient_cfg(23, 17, kappa=kappa, mass=mass)
    if kappa == "1.0 + e*e":
        cfg["Functions"]["thermal source"] = SOURCE_NL
    out = {}
    for d in ("cpu", dev):
        p = Problem(cfg, device=d)
        n = p.n_dof
        tc = time_coeffs_from_numpy(
            DIRK22_STAGE1[0], seeded(n, seed=11), DIRK22_STAGE1[1],
            seeded(n, seed=12, scale=5.0), 0.3, 0.05, p)
        r, rows = p.assembler.fused_provider().res_jac(
            state_from_numpy(seeded(n, seed=9), p), tc)
        out[str(d)] = (state_to_numpy(r), [state_to_numpy(x) for x in rows])
    (rc, jc), (rg, jg) = out["cpu"], out[str(dev)]
    assert np.max(np.abs(rg - rc)) <= 1e-12 * max(1.0, np.max(np.abs(rc)))
    for a, b in zip(jg, jc):
        assert np.max(np.abs(a - b)) <= 1e-12 * max(1.0, np.max(np.abs(b)))


@pytest.mark.cuda
@pytest.mark.parametrize("kappa", KAPPAS)
def test_fused_provider_on_card_matches_cpu(kappa):
    """The provider on CUDA (kernels) against the same provider on the
    CPU (plain versions): residual and every Jacobian row, f64."""
    from mrhyde_tpu_torch.assembly.assembler import TimeCoeffs
    from mrhyde_tpu_torch.interop import state_from_numpy, state_to_numpy
    from mrhyde_tpu_torch.problem import Problem
    dev = _card()
    cfg = thermal_cfg(23, 17, kappa=kappa)
    if kappa == "1.0 + e*e":
        cfg["Functions"]["thermal source"] = SOURCE_NL
    out = {}
    for d in ("cpu", dev):
        p = Problem(cfg, device=d)
        u = state_from_numpy(seeded(p.n_dof, seed=9), p)
        r, rows = p.assembler.fused_provider().res_jac(
            u, TimeCoeffs.steady(p.n_dof, device=d))
        out[str(d)] = (state_to_numpy(r),
                       [None if x is None else state_to_numpy(x)
                        for x in rows])
    (rc, jc), (rg, jg) = out["cpu"], out[str(dev)]
    assert np.max(np.abs(rg - rc)) <= 1e-12 * max(1.0, np.max(np.abs(rc)))
    for a, b in zip(jg, jc):
        assert (a is None) == (b is None)
        if a is not None:
            assert np.max(np.abs(a - b)) <= 1e-12 * max(1.0,
                                                        np.max(np.abs(b)))


@pytest.mark.cuda
def test_wrapper_checks_inputs_on_card():
    from mrhyde_tpu_torch.ops import fused_p1 as fp
    from mrhyde_tpu_torch.problem import Problem
    dev = _card()
    t0 = Problem(thermal_cfg(4), device="cpu").assembler \
        .fused_provider().tables
    tab = fp.QuadTables(np.asarray(t0.phi), np.asarray(t0.grad),
                        np.asarray(t0.wts), dev, torch.float64)
    u = torch.zeros((5, 5), device=dev, dtype=torch.float64)
    with pytest.raises(ValueError):          # kappa of the wrong shape
        fp.thermal_node_state(u, torch.zeros((3, tab.Q), device=dev,
                                             dtype=torch.float64), tab)
    with pytest.raises(ValueError):          # tables in another dtype
        fp.thermal_node_state(u.float(), 1.0, tab)
    with pytest.raises(ValueError):          # not contiguous
        fp.thermal_node_state(torch.zeros((5, 10), device=dev,
                                          dtype=torch.float64)[:, ::2],
                              1.0, tab)


@pytest.mark.cuda
@pytest.mark.parametrize("transient", [False, True])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("shape", [(37, 29), (64, 16)])
def test_ns_kernel_matches_plain(shape, dtype, transient):
    """ns_node_full (steady PSPG with a per-qp viscosity; a PSPG+SUPG
    stage) against its plain version: residual and rows each within the
    tolerance of its own max |plain|."""
    from mrhyde_tpu_torch.ops import fused_ns as fn
    from mrhyde_tpu_torch.ops import fused_p1 as fp
    from mrhyde_tpu_torch.problem import Problem
    dev = _card()
    N0, N1 = shape
    t0 = Problem(channel_cfg(N0, N1), device="cpu").assembler \
        .fused_provider().tables
    tab = fp.QuadTables(np.asarray(t0.phi), np.asarray(t0.grad),
                        np.asarray(t0.wts), dev, dtype)
    gen = torch.Generator(device=dev).manual_seed(11)
    ue, ud = (torch.rand((3, N0 + 1, N1 + 1), generator=gen, device=dev,
                         dtype=dtype) - 0.5 for _ in range(2))
    visc = 0.1 + 0.01 * torch.rand((N0 * N1, tab.Q), generator=gen,
                                   device=dev, dtype=dtype)
    h = float(np.sqrt(np.sum(t0.wts)))
    form = fn.NSForm(True, transient, h, 0.01, transient)
    stage = fp.Stage(*NS_STAGE1, None) if transient else None
    block = {r * 12 + 8 + cp for r in range(8) for cp in range(4)}
    jac_idx = tuple(k for k in range(144) if transient or k not in block)
    args = (ue, 200.0 * ud if transient else None, (1.0, visc, 1.0, 0.0),
            tab, form, jac_idx, stage)
    before = fp.LAUNCHES["ns_full"]
    out, jac = fn.ns_node_full(*args)
    ref, jref = fn.ns_node_full_plain(*args)
    assert _close(out, ref, dtype) and _close(jac, jref, dtype)
    assert jac.shape == (len(jac_idx), N0 * N1)
    assert fp.LAUNCHES["ns_full"] == before + 1


def _node_tables(cfg, dev, dtype, quadrature=None):
    """The QuadTables of a 2D p1 deck's provider (at another quadrature
    where given), on the card."""
    from mrhyde_tpu_torch.ops import fused_p1 as fp
    from mrhyde_tpu_torch.problem import Problem
    if quadrature is not None:
        cfg["Discretization"]["quadrature"] = quadrature
    t0 = Problem(cfg, device="cpu").assembler.fused_provider().tables
    return fp.QuadTables(np.asarray(t0.phi), np.asarray(t0.grad),
                         np.asarray(t0.wts), dev, dtype), t0


# node grids at thermal_node_state's tile edges (15 x 31 nodes a tile):
# whole tiles, one node past them, and a single element
STATE_EDGES = [(14, 30), (29, 61), (15, 31), (30, 62), (1, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("quadrature", [2, 4])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("shape", STATE_EDGES)
def test_state_kernel_at_tile_edges_matches_plain(shape, dtype, quadrature):
    """thermal_node_state on grids whose node tiles are whole, one node
    past whole, or a single element, at Q = 4 (its compile-time instance)
    and Q = 9: steady with kappa scalar and per qp, a stage with a per-qp
    mass, and advection by a per-qp velocity at a stage, against its
    plain version."""
    from mrhyde_tpu_torch.ops import fused_p1 as fp
    dev = _card()
    tab, _ = _node_tables(thermal_cfg(*shape), dev, dtype, quadrature)
    assert tab.Q == {2: 4, 4: 9}[quadrature]
    gen = torch.Generator(device=dev).manual_seed(13)
    N0, N1 = shape
    u = torch.rand((N0 + 1, N1 + 1), generator=gen, device=dev,
                   dtype=dtype) - 0.5
    qp = [torch.rand((N0 * N1, tab.Q), generator=gen, device=dev,
                     dtype=dtype) + 0.5 for _ in range(4)]
    stage = fp.Stage(*DIRK22_STAGE1, qp[1])
    before = fp.LAUNCHES["state"]
    for args in ((1.25, tab), (qp[0], tab), (qp[0], tab, stage),
                 (0.5, tab, fp.Stage(*DIRK22_STAGE1, 1.0), qp[2:])):
        assert _close(fp.thermal_node_state(u, *args),
                      fp.thermal_node_state_plain(u, *args), dtype)
    assert fp.LAUNCHES["state"] == before + 4


@pytest.mark.cuda
@pytest.mark.parametrize("quadrature", [2, 4])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("shape", STATE_EDGES)
def test_full_kernel_at_tile_edges_matches_plain(shape, dtype, quadrature):
    """thermal_node_full (thermal_node_state's tile walk with a Jacobian
    role) on grids whose node tiles are whole, one node past whole, or a
    single element, at Q = 4 (its compile-time instance) and Q = 9:
    steady, a stage with a per-qp mass, the velocity (2, -1) and a per-qp
    one at a stage, against its plain version (the node residual and
    every Jacobian row)."""
    from mrhyde_tpu_torch.ops import fused_p1 as fp
    dev = _card()
    tab, _ = _node_tables(thermal_cfg(*shape), dev, dtype, quadrature)
    assert tab.Q == {2: 4, 4: 9}[quadrature]
    gen = torch.Generator(device=dev).manual_seed(17)
    N0, N1 = shape
    u = torch.rand((N0 + 1, N1 + 1), generator=gen, device=dev,
                   dtype=dtype) - 0.5
    qp = [torch.rand((N0 * N1, tab.Q), generator=gen, device=dev,
                     dtype=dtype) + 0.5 for _ in range(7)]
    before = fp.LAUNCHES["full"]
    for stage, vel in ((None, None),
                       (fp.Stage(*DIRK22_STAGE1, qp[4]), None),
                       (None, [2.0, -1.0]),
                       (fp.Stage(*DIRK22_STAGE1, 1.0), qp[5:])):
        args = (u, *qp[:4], tab, stage, vel)
        out, jac = fp.thermal_node_full(*args)
        ref, jref = fp.thermal_node_full_plain(*args)
        assert _close(out, ref, dtype) and _close(jac, jref, dtype)
        assert jac.shape == (16, N0 * N1)
    assert fp.LAUNCHES["full"] == before + 4


# node grids at ns_node_full's tile edges (8 x 16 nodes a tile)
NS_EDGES = [(7, 15), (8, 16), (15, 31), (16, 32), (1, 1)]


def _ns_case(shape, dev, dtype, transient, quadrature=None):
    """ns_node_full's arguments on the channel: steady PSPG with a
    per-qp viscosity, or a PSPG+SUPG stage."""
    from mrhyde_tpu_torch.ops import fused_ns as fn
    from mrhyde_tpu_torch.ops import fused_p1 as fp
    N0, N1 = shape
    tab, t0 = _node_tables(channel_cfg(N0, N1), dev, dtype, quadrature)
    gen = torch.Generator(device=dev).manual_seed(11)
    ue, ud = (torch.rand((3, N0 + 1, N1 + 1), generator=gen, device=dev,
                         dtype=dtype) - 0.5 for _ in range(2))
    visc = 0.1 + 0.01 * torch.rand((N0 * N1, tab.Q), generator=gen,
                                   device=dev, dtype=dtype)
    h = float(np.sqrt(np.sum(t0.wts)))
    form = fn.NSForm(True, transient, h, 0.01, transient)
    stage = fp.Stage(*NS_STAGE1, None) if transient else None
    block = {r * 12 + 8 + cp for r in range(8) for cp in range(4)}
    jac_idx = tuple(k for k in range(144) if transient or k not in block)
    return (ue, 200.0 * ud if transient else None, (1.0, visc, 1.0, 0.0),
            tab, form, jac_idx, stage)


@pytest.mark.cuda
@pytest.mark.parametrize("transient", [False, True])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("shape", NS_EDGES)
def test_ns_kernel_at_tile_edges_matches_plain(shape, dtype, transient):
    """ns_node_full on grids whose node tiles are whole, one node past
    whole (a tile row and column of nodes only) or a single element,
    against its plain version."""
    from mrhyde_tpu_torch.ops import fused_ns as fn
    from mrhyde_tpu_torch.ops import fused_p1 as fp
    args = _ns_case(shape, _card(), dtype, transient)
    before = fp.LAUNCHES["ns_full"]
    out, jac = fn.ns_node_full(*args)
    ref, jref = fn.ns_node_full_plain(*args)
    assert _close(out, ref, dtype) and _close(jac, jref, dtype)
    assert fp.LAUNCHES["ns_full"] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("transient", [False, True])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_ns_kernel_at_quadrature_8_matches_plain(dtype, transient):
    """ns_node_full at quadrature 8 (Q = 25: 25 x 25 halo densities per
    block) on a 37 x 29 grid against its plain version."""
    from mrhyde_tpu_torch.ops import fused_ns as fn
    args = _ns_case((37, 29), _card(), dtype, transient, 8)
    assert args[3].Q == 25
    out, jac = fn.ns_node_full(*args)
    ref, jref = fn.ns_node_full_plain(*args)
    assert _close(out, ref, dtype) and _close(jac, jref, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["pspg_steady_visc_x", "supg_stage"])
def test_ns_provider_on_card_matches_cpu(case):
    """The NS provider on CUDA (kernel) against the same call on the CPU
    (plain version): residual and every Jacobian row, f64."""
    from mrhyde_tpu_torch.assembly.assembler import TimeCoeffs
    from mrhyde_tpu_torch.interop import (state_from_numpy, state_to_numpy,
                                          time_coeffs_from_numpy)
    from mrhyde_tpu_torch.problem import Problem
    dev = _card()
    stage = case == "supg_stage"
    cfg = channel_cfg(23, 17, supg=stage,
                      visc=None if stage else "0.1 + 0.01*x",
                      solver={"solver": "transient"} if stage else None)
    out = {}
    for d in ("cpu", dev):
        p = Problem(cfg, device=d)
        n = p.n_dof
        tc = (time_coeffs_from_numpy(NS_STAGE1[0], seeded(n, seed=11),
                                     NS_STAGE1[1], seeded(n, seed=12), 0.3,
                                     0.01, p)
              if stage else TimeCoeffs.steady(n, device=d))
        r, rows = p.assembler.fused_provider().res_jac(
            state_from_numpy(seeded(n, seed=9), p), tc)
        out[str(d)] = (state_to_numpy(r),
                       [None if x is None else state_to_numpy(x)
                        for x in rows])
    (rc, jc), (rg, jg) = out["cpu"], out[str(dev)]
    assert np.max(np.abs(rg - rc)) <= 1e-12 * max(1.0, np.max(np.abs(rc)))
    for a, b in zip(jg, jc):
        assert (a is None) == (b is None)
        if a is not None:
            assert np.max(np.abs(a - b)) <= 1e-12 * max(1.0,
                                                        np.max(np.abs(b)))


# ----------------------------------------------------------------------
# the element kernels (B1): 3D hex p1 and 2D p2 quads
# ----------------------------------------------------------------------

def _elem_case(mesh, dev, dtype):
    """(tables on the card, lattice) of a hex or p2 deck."""
    from mrhyde_tpu_torch.ops import fused_p1 as fp
    from mrhyde_tpu_torch.problem import Problem
    cfg = hex_cfg(2, 2, 2) if mesh == "hex" else p2_cfg(2, 2)
    f = Problem(cfg, device="cpu").assembler.fused_provider()
    t0 = f.tables
    return (fp.QuadTables(np.asarray(t0.phi), np.asarray(t0.grad),
                          np.asarray(t0.wts), dev, dtype), f.lattice)


ELEM_SHAPES = {"hex": [(8, 8, 8), (7, 5, 3)], "p2": [(32, 16), (13, 7)]}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("mesh,shape", [(m, s) for m, ss in
                                        ELEM_SHAPES.items() for s in ss])
def test_elem_kernels_match_plain(mesh, shape, dtype):
    """thermal_elem_state and thermal_elem_full, steady and at a stage
    (scalar and per-qp kappa and m), against their plain versions."""
    from mrhyde_tpu_torch.ops import fused_elem as fe
    from mrhyde_tpu_torch.ops import fused_p1 as fp
    dev = _card()
    tab, lat = _elem_case(mesh, dev, dtype)
    p = lat.stride
    gen = torch.Generator(device=dev).manual_seed(13)
    grid = torch.rand(tuple(p * n + 1 for n in shape), generator=gen,
                      device=dev, dtype=dtype) - 0.5
    E = int(np.prod(shape))
    qp = [torch.rand((E, tab.Q), generator=gen, device=dev, dtype=dtype)
          for _ in range(5)]
    before = dict(fp.LAUNCHES)
    stages = (None, fp.Stage(*DIRK22_STAGE1, 1.5), fp.Stage(0.0, 20.0, qp[4]))
    for stage in stages:
        for kappa in (1.25, qp[2]):
            assert _close(fe.thermal_elem_state(grid, kappa, tab, lat, stage),
                          fe.thermal_elem_state_plain(grid, kappa, tab, lat,
                                                      stage), dtype)
        res, jac = fe.thermal_elem_full(grid, *qp[:4], tab, lat, stage)
        ref, jref = fe.thermal_elem_full_plain(grid, *qp[:4], tab, lat, stage)
        assert _close(res, ref, dtype) and _close(jac, jref, dtype)
        assert jac.shape == (tab.nc ** 2, E)
    assert fp.LAUNCHES["elem_state"] == before["elem_state"] + 6
    assert fp.LAUNCHES["elem_full"] == before["elem_full"] + 3


# element grids at thermal_elem_state's tile edges (64 elements a tile in
# f64, 256 in f32): whole tiles, one element past them, and a single
# element
ELEM_STATE_EDGES = {"hex": [(4, 4, 4), (1, 1, 65), (4, 8, 8), (257, 1, 1),
                            (1, 1, 1)],
                    "p2": [(8, 8), (5, 13), (16, 16), (1, 257), (1, 1)]}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("mesh,shape", [(m, s) for m, ss in
                                        ELEM_STATE_EDGES.items()
                                        for s in ss])
def test_elem_state_kernel_at_tile_edges_matches_plain(mesh, shape, dtype):
    """thermal_elem_state (the tile design's row role) on element grids
    whose tiles are whole, one element past whole, or a single element:
    steady with kappa scalar and per qp, the decks' stage (kappa and m
    scalar), a stage with both per qp, the velocity (2, -1[, 0.5]) and a
    per-qp one at a stage, against its plain version."""
    from mrhyde_tpu_torch.ops import fused_elem as fe
    from mrhyde_tpu_torch.ops import fused_p1 as fp
    dev = _card()
    tab, lat = _elem_case(mesh, dev, dtype)
    p = lat.stride
    gen = torch.Generator(device=dev).manual_seed(19)
    grid = torch.rand(tuple(p * n + 1 for n in shape), generator=gen,
                      device=dev, dtype=dtype) - 0.5
    E = int(np.prod(shape))
    qp = [torch.rand((E, tab.Q), generator=gen, device=dev, dtype=dtype)
          + 0.5 for _ in range(2 + tab.dim)]
    st1 = fp.Stage(*DIRK22_STAGE1, 1.0)
    before = fp.LAUNCHES["elem_state"]
    for kappa, stage, vel in ((1.25, None, None), (qp[0], None, None),
                              (1.0, st1, None),
                              (qp[0], fp.Stage(*DIRK22_STAGE1, qp[1]), None),
                              (1.0, None, [2.0, -1.0, 0.5][:tab.dim]),
                              (0.5, st1, qp[2:])):
        args = (grid, kappa, tab, lat, stage, vel)
        rows = fe.thermal_elem_state(*args)
        assert _close(rows, fe.thermal_elem_state_plain(*args), dtype)
        assert rows.shape == (tab.nc, E)
    assert fp.LAUNCHES["elem_state"] == before + 6


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("mesh,quadrature", [("hex", 6), ("hex", 8),
                                             ("p2", 8)])
def test_elem_full_kernel_at_high_quadrature_matches_plain(mesh, quadrature,
                                                           dtype):
    """thermal_elem_full where its weighted basis products pass one
    chunk of shared memory (hex Q = 64 in f64, Q = 125 in both) and at p2
    Q = 25, steady and at a stage with advection, against its plain
    version on a grid whose last tile is partial."""
    from mrhyde_tpu_torch.ops import fused_elem as fe
    from mrhyde_tpu_torch.ops import fused_p1 as fp
    from mrhyde_tpu_torch.problem import Problem
    dev = _card()
    cfg = hex_cfg(2, 2, 2) if mesh == "hex" else p2_cfg(2, 2)
    cfg["Discretization"]["quadrature"] = quadrature
    f = Problem(cfg, device="cpu").assembler.fused_provider()
    t0, lat = f.tables, f.lattice
    tab = fp.QuadTables(np.asarray(t0.phi), np.asarray(t0.grad),
                        np.asarray(t0.wts), dev, dtype)
    shape = (7, 5, 3) if mesh == "hex" else (13, 7)
    p = lat.stride
    gen = torch.Generator(device=dev).manual_seed(29)
    grid = torch.rand(tuple(p * n + 1 for n in shape), generator=gen,
                      device=dev, dtype=dtype) - 0.5
    E = int(np.prod(shape))
    qp = [torch.rand((E, tab.Q), generator=gen, device=dev, dtype=dtype)
          for _ in range(5)]
    vel = [qp[4]] + [0.5] * (tab.dim - 1)
    for stage, v in ((None, None), (fp.Stage(*DIRK22_STAGE1, 1.5), vel)):
        res, jac = fe.thermal_elem_full(grid, *qp[:4], tab, lat, stage, v)
        ref, jref = fe.thermal_elem_full_plain(grid, *qp[:4], tab, lat,
                                               stage, v)
        assert _close(res, ref, dtype) and _close(jac, jref, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("mesh", ["hex", "p2"])
def test_elem_full_kernel_infinite_derivative_as_plain(mesh):
    """An infinite dS at one qp reaches the Jacobian entries the plain
    version's reaches, as the same infinities and NaNs (a NaN where a
    basis function is 0 there), and no other entry."""
    from mrhyde_tpu_torch.ops import fused_elem as fe
    dev = _card()
    tab, lat = _elem_case(mesh, dev, torch.float64)
    shape = ELEM_SHAPES[mesh][1]
    p = lat.stride
    gen = torch.Generator(device=dev).manual_seed(31)
    grid = torch.rand(tuple(p * n + 1 for n in shape), generator=gen,
                      device=dev, dtype=torch.float64) - 0.5
    E = int(np.prod(shape))
    qp = [torch.rand((E, tab.Q), generator=gen, device=dev,
                     dtype=torch.float64) for _ in range(4)]
    qp[1][E // 2, tab.Q // 2] = float("inf")
    _res, jac = fe.thermal_elem_full(grid, *qp, tab, lat)
    _ref, jref = fe.thermal_elem_full_plain(grid, *qp, tab, lat)
    torch.cuda.synchronize()
    assert torch.equal(torch.isnan(jac), torch.isnan(jref))
    assert torch.equal(torch.isposinf(jac), torch.isposinf(jref))
    assert torch.equal(torch.isneginf(jac), torch.isneginf(jref))
    fin = torch.isfinite(jref)
    assert float((jac[fin] - jref[fin]).abs().max()) <= \
        RTOL[torch.float64] * float(jref[fin].abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("stage", [False, True])
@pytest.mark.parametrize("kappa", ["1.0", "1.0 + 0.5*x*y", "1.0 + e*e"])
@pytest.mark.parametrize("mesh", ["hex", "p2"])
def test_elem_provider_on_card_matches_cpu(mesh, kappa, stage):
    """The hex / p2 provider on CUDA (the element kernels) against the
    same call on the CPU (plain versions): residual and every Jacobian
    row, f64, steady and at a DIRK-2,2 stage-1 call."""
    from mrhyde_tpu_torch.assembly.assembler import TimeCoeffs
    from mrhyde_tpu_torch.interop import (state_from_numpy, state_to_numpy,
                                          time_coeffs_from_numpy)
    from mrhyde_tpu_torch.problem import Problem
    dev = _card()
    if mesh == "hex":
        cfg = hex_cfg(9, 7, 5, kappa=kappa.replace("x*y", "x*y*z"),
                      source=SOURCE3_NL if "e" in kappa else SOURCE3)
    else:
        cfg = p2_cfg(13, 9, kappa=kappa,
                     source=SOURCE_NL if "e" in kappa else SOURCE)
    if stage:
        cfg = as_transient(cfg, MASSES[1])
    out = {}
    for d in ("cpu", dev):
        p = Problem(cfg, device=d)
        n = p.n_dof
        tc = (time_coeffs_from_numpy(
            DIRK22_STAGE1[0], seeded(n, seed=11), DIRK22_STAGE1[1],
            seeded(n, seed=12, scale=5.0), 0.3, 0.05, p) if stage
            else TimeCoeffs.steady(n, device=d))
        f = p.assembler.fused_provider()
        assert f is not None and not f.node
        r, rows = f.res_jac(state_from_numpy(seeded(n, seed=9), p), tc)
        out[str(d)] = (state_to_numpy(r),
                       [None if x is None else state_to_numpy(x)
                        for x in rows])
    (rc, jc), (rg, jg) = out["cpu"], out[str(dev)]
    assert np.max(np.abs(rg - rc)) <= 1e-12 * max(1.0, np.max(np.abs(rc)))
    for a, b in zip(jg, jc):
        assert (a is None) == (b is None)
        if a is not None:
            assert np.max(np.abs(a - b)) <= 1e-12 * max(1.0,
                                                        np.max(np.abs(b)))


@pytest.mark.cuda
def test_elem_wrapper_checks_inputs_on_card():
    from mrhyde_tpu_torch.ops import fused_elem as fe
    dev = _card()
    tab, lat = _elem_case("hex", dev, torch.float64)
    grid = torch.zeros((5, 4, 3), device=dev, dtype=torch.float64)
    with pytest.raises(ValueError):          # kappa of the wrong shape
        fe.thermal_elem_state(grid, torch.zeros((3, tab.Q), device=dev,
                                                dtype=torch.float64),
                              tab, lat)
    with pytest.raises(ValueError):          # tables in another dtype
        fe.thermal_elem_state(grid.float(), 1.0, tab, lat)
    with pytest.raises(ValueError):          # not contiguous
        fe.thermal_elem_state(torch.zeros((5, 4, 6), device=dev,
                                          dtype=torch.float64)[:, :, ::2],
                              1.0, tab, lat)
    with pytest.raises(ValueError):          # a 2D grid for hex tables
        fe.thermal_elem_state(grid[0].contiguous(), 1.0, tab, lat)
    p2_tab, p2_lat = _elem_case("p2", dev, torch.float64)
    with pytest.raises(ValueError):          # p2 axes must be 2 N + 1
        fe.thermal_elem_state(torch.zeros((6, 5), device=dev,
                                          dtype=torch.float64),
                              1.0, p2_tab, p2_lat)


# ----------------------------------------------------------------------
# advection (cdr, thermal 'include advection'): the ADVECT instantiations
# ----------------------------------------------------------------------

ADVECT_SHAPES = {"p1": [(64, 128), (37, 29)], "hex": [(8, 8, 8), (7, 5, 3)],
                 "p2": [(32, 16), (13, 7)]}


@pytest.mark.cuda
@pytest.mark.parametrize("vel", ["scalar", "per_qp"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("mesh,shape", [(m, s) for m, ss in
                                        ADVECT_SHAPES.items() for s in ss])
def test_advect_kernels_match_plain(mesh, shape, dtype, vel):
    """The four kernels with a velocity (every component scalar, or every
    one an (E, Q) tensor), steady and at DIRK-2,2 stage-1 alphas, against
    their plain versions, at a divisible and a non-divisible size."""
    from mrhyde_tpu_torch.ops import fused_elem as fe
    from mrhyde_tpu_torch.ops import fused_p1 as fp
    dev = _card()
    if mesh == "p1":
        from mrhyde_tpu_torch.problem import Problem
        t0 = Problem(thermal_cfg(4), device="cpu").assembler \
            .fused_provider().tables
        tab, lat = fp.QuadTables(np.asarray(t0.phi), np.asarray(t0.grad),
                                 np.asarray(t0.wts), dev, dtype), fp.QUAD_P1
    else:
        tab, lat = _elem_case(mesh, dev, dtype)
    gen = torch.Generator(device=dev).manual_seed(17)
    grid = torch.rand(tuple(lat.stride * n + 1 for n in shape),
                      generator=gen, device=dev, dtype=dtype) - 0.5
    E = int(np.prod(shape))
    qp = [torch.rand((E, tab.Q), generator=gen, device=dev, dtype=dtype)
          - 0.5 for _ in range(5 + tab.dim)]
    b = ([2.0, -1.0, 0.5][:tab.dim] if vel == "scalar"
         else [4.0 * t for t in qp[5:]])
    before = dict(fp.LAUNCHES)
    for stage in (None, fp.Stage(*DIRK22_STAGE1, 1.5)):
        if mesh == "p1":
            pairs = [(fp.thermal_node_state(grid, qp[4], tab, stage, b),
                      fp.thermal_node_state_plain(grid, qp[4], tab, stage,
                                                  b)),
                     *zip(fp.thermal_node_full(grid, *qp[:4], tab, stage, b),
                          fp.thermal_node_full_plain(grid, *qp[:4], tab,
                                                     stage, b))]
        else:
            pairs = [(fe.thermal_elem_state(grid, qp[4], tab, lat, stage, b),
                      fe.thermal_elem_state_plain(grid, qp[4], tab, lat,
                                                  stage, b)),
                     *zip(fe.thermal_elem_full(grid, *qp[:4], tab, lat, stage,
                                               b),
                          fe.thermal_elem_full_plain(grid, *qp[:4], tab, lat,
                                                     stage, b))]
        for got, ref in pairs:
            assert _close(got, ref, dtype)
    state, full = ("state", "full") if mesh == "p1" else ("elem_state",
                                                         "elem_full")
    assert fp.LAUNCHES[state] == before[state] + 2
    assert fp.LAUNCHES[full] == before[full] + 2


@pytest.mark.cuda
@pytest.mark.parametrize("stage", [False, True])
@pytest.mark.parametrize("reaction", ["1.0", "0.5*c*c"])
@pytest.mark.parametrize("mesh", ["p1", "hex", "p2"])
def test_cdr_provider_on_card_matches_cpu(mesh, reaction, stage):
    """The cdr provider on CUDA (kernels with the rotating velocity)
    against the same call on the CPU (plain versions): residual and every
    Jacobian row, f64, steady and at a DIRK-2,2 stage-1 call."""
    from mrhyde_tpu_torch.assembly.assembler import TimeCoeffs
    from mrhyde_tpu_torch.interop import (state_from_numpy, state_to_numpy,
                                          time_coeffs_from_numpy)
    from mrhyde_tpu_torch.problem import Problem
    from torch_port_utils import cdr_cfg
    dev = _card()
    sizes = {"p1": (23, 17, None), "hex": (9, 7, 5), "p2": (13, 9, None)}
    cfg = cdr_cfg(*sizes[mesh], vel="rot", reaction=reaction,
                  order=2 if mesh == "p2" else 1, transient=stage)
    out = {}
    for d in ("cpu", dev):
        p = Problem(cfg, device=d)
        n = p.n_dof
        tc = (time_coeffs_from_numpy(
            DIRK22_STAGE1[0], seeded(n, seed=11), DIRK22_STAGE1[1],
            seeded(n, seed=12, scale=5.0), 0.3, 0.05, p) if stage
            else TimeCoeffs.steady(n, device=d))
        r, rows = p.assembler.fused_provider().res_jac(
            state_from_numpy(seeded(n, seed=9), p), tc)
        out[str(d)] = (state_to_numpy(r),
                       [None if x is None else state_to_numpy(x)
                        for x in rows])
    (rc, jc), (rg, jg) = out["cpu"], out[str(dev)]
    assert np.max(np.abs(rg - rc)) <= 1e-12 * max(1.0, np.max(np.abs(rc)))
    for a, b in zip(jg, jc):
        assert (a is None) == (b is None)
        if a is not None:
            assert np.max(np.abs(a - b)) <= 1e-12 * max(1.0,
                                                        np.max(np.abs(b)))


# ----------------------------------------------------------------------
# Navier-Stokes on the element kernel (B1): hex p1 (nd = 32), p2 (nd = 27)
# ----------------------------------------------------------------------

def _ns_elem_case(mesh, dev, dtype):
    """(tables on the card, lattice, nd) of a hex or p2 channel deck."""
    from mrhyde_tpu_torch.ops import fused_p1 as fp
    from mrhyde_tpu_torch.problem import Problem
    f = Problem(ns_elem_cfg(mesh, (2, 2, 2) if mesh == "hex" else (2, 2)),
                device="cpu").assembler.fused_provider()
    t0 = f.tables
    return (fp.QuadTables(np.asarray(t0.phi), np.asarray(t0.grad),
                          np.asarray(t0.wts), dev, dtype), f.lattice, f.nd)


@pytest.mark.cuda
@pytest.mark.parametrize("transient", [False, True])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("mesh,shape", [(m, s) for m, ss in
                                        ELEM_SHAPES.items() for s in ss])
def test_ns_elem_kernel_matches_plain(mesh, shape, dtype, transient):
    """ns_elem_full (steady PSPG with a per-qp viscosity; a PSPG+SUPG
    stage) against its plain version at a divisible and a non-divisible
    size: residual rows and Jacobian rows each within the tolerance of
    its own max |plain|."""
    from mrhyde_tpu_torch.ops import fused_ns as fn
    from mrhyde_tpu_torch.ops import fused_p1 as fp
    dev = _card()
    tab, lat, nd = _ns_elem_case(mesh, dev, dtype)
    gen = torch.Generator(device=dev).manual_seed(19)
    grid = (tab.dim + 1,) + tuple(lat.stride * n + 1 for n in shape)
    ue, ud = (torch.rand(grid, generator=gen, device=dev, dtype=dtype) - 0.5
              for _ in range(2))
    E = int(np.prod(shape))
    visc = 0.1 + 0.01 * torch.rand((E, tab.Q), generator=gen, device=dev,
                                   dtype=dtype)
    h = float(np.sum(tab.wts) ** (1.0 / tab.dim))
    form = fn.NSForm(True, transient, h, 0.01, transient)
    stage = fp.Stage(*NS_STAGE1, None) if transient else None
    nc = len(lat.offsets)
    block = {r * nd + nd - nc + cp for r in range(nd - nc)
             for cp in range(nc)}
    jac_idx = tuple(k for k in range(nd * nd) if transient or k not in block)
    src = (1.0,) + (0.0,) * (tab.dim - 1)
    args = (ue, 200.0 * ud if transient else None, (1.0, visc, *src), tab,
            lat, form, jac_idx, stage)
    before = fp.LAUNCHES["ns_elem_full"]
    res, jac = fn.ns_elem_full(*args)
    rref, jref = fn.ns_elem_full_plain(*args)
    assert _close(res, rref, dtype) and _close(jac, jref, dtype)
    assert res.shape == (nd, E) and jac.shape == (len(jac_idx), E)
    assert fp.LAUNCHES["ns_elem_full"] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["pspg_steady_visc_x", "supg_stage"])
@pytest.mark.parametrize("mesh", ["hex", "p2"])
def test_ns_elem_provider_on_card_matches_cpu(mesh, case):
    """The hex / p2 NS provider on CUDA (ns_elem_full) against the same
    call on the CPU (plain version): residual and every Jacobian row,
    f64."""
    from mrhyde_tpu_torch.assembly.assembler import TimeCoeffs
    from mrhyde_tpu_torch.interop import (state_from_numpy, state_to_numpy,
                                          time_coeffs_from_numpy)
    from mrhyde_tpu_torch.ops import fused_p1 as fp
    from mrhyde_tpu_torch.problem import Problem
    dev = _card()
    stage = case == "supg_stage"
    cfg = ns_elem_cfg(mesh, (9, 7, 5) if mesh == "hex" else (13, 9),
                      supg=stage, visc=None if stage else "0.1 + 0.01*x",
                      solver={"solver": "transient"} if stage else None)
    out = {}
    for d in ("cpu", dev):
        p = Problem(cfg, device=d)
        n = p.n_dof
        tc = (time_coeffs_from_numpy(NS_STAGE1[0], seeded(n, seed=11),
                                     NS_STAGE1[1], seeded(n, seed=12), 0.3,
                                     0.01, p)
              if stage else TimeCoeffs.steady(n, device=d))
        f = p.assembler.fused_provider()
        before = dict(fp.LAUNCHES)
        r, rows = f.res_jac(state_from_numpy(seeded(n, seed=9), p), tc)
        launched = {k: v - before[k] for k, v in fp.LAUNCHES.items()}
        assert launched == {k: int(d == dev and k == "ns_elem_full")
                            for k in launched}
        out[str(d)] = (state_to_numpy(r),
                       [None if x is None else state_to_numpy(x)
                        for x in rows])
    (rc, jc), (rg, jg) = out["cpu"], out[str(dev)]
    assert np.max(np.abs(rg - rc)) <= 1e-12 * max(1.0, np.max(np.abs(rc)))
    for a, b in zip(jg, jc):
        assert (a is None) == (b is None)
        if a is not None:
            assert np.max(np.abs(a - b)) <= 1e-12 * max(1.0,
                                                        np.max(np.abs(b)))


@pytest.mark.cuda
def test_ns_elem_wrapper_checks_inputs_on_card():
    from mrhyde_tpu_torch.ops import fused_ns as fn
    dev = _card()
    tab, lat, nd = _ns_elem_case("hex", dev, torch.float64)
    ue = torch.zeros((4, 4, 3, 3), device=dev, dtype=torch.float64)
    form = fn.NSForm(True, False, 1.0, 1.0, False)
    coeffs = (1.0, 1.0, 1.0, 0.0, 0.0)
    with pytest.raises(ValueError):          # three variables for hex
        fn.ns_elem_full(ue[:3].contiguous(), None, coeffs, tab, lat, form,
                        (0,))
    with pytest.raises(ValueError):          # four coefficients in 3D
        fn.ns_elem_full(ue, None, coeffs[:4], tab, lat, form, (0,))
    with pytest.raises(ValueError):          # a viscosity of the wrong shape
        fn.ns_elem_full(ue, None, (1.0, torch.zeros(
            (3, tab.Q), device=dev, dtype=torch.float64), 1.0, 0.0, 0.0),
            tab, lat, form, (0,))
    with pytest.raises(ValueError):          # a stage without u_dot grids
        from mrhyde_tpu_torch.ops.fused_p1 import Stage
        fn.ns_elem_full(ue, None, coeffs, tab, lat, form, (0,),
                        Stage(*NS_STAGE1, None))
    with pytest.raises(ValueError):          # tables in another dtype
        fn.ns_elem_full(ue.float(), None, coeffs, tab, lat, form, (0,))


# ----------------------------------------------------------------------
# the module-set kernel set_node_full (generated per deck)
# ----------------------------------------------------------------------

def _set_cfg(name, nx, ny):
    from torch_port_utils import (cdr_state_velocity_cfg, ns_cdr_cfg,
                                  ns_thermal_cfg, thermal_cdr_cfg)
    cfg = {"ns_thermal_pspg_steady": lambda: ns_thermal_cfg(),
           "ns_thermal_advected_supg_stage": lambda: ns_thermal_cfg(
               True, True, True),
           "ns_cdr_supg_stage": ns_cdr_cfg,
           "thermal_cdr_kappa_ec_steady": lambda: thermal_cdr_cfg(
               "1.0 + e*c"),
           "cdr_velocity_c_stage": cdr_state_velocity_cfg,
           "ns_visc_ux2_pspg_steady": lambda: channel_cfg(
               4, 4, visc="1.0 + ux*ux")}[name]()
    cfg["Mesh"].update(NX=nx, NY=ny)
    return cfg


SET_CASES = ["ns_thermal_pspg_steady", "ns_thermal_advected_supg_stage",
             "ns_cdr_supg_stage", "thermal_cdr_kappa_ec_steady",
             "cdr_velocity_c_stage", "ns_visc_ux2_pspg_steady"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("shape", [(37, 29), (64, 32)])
@pytest.mark.parametrize("name", SET_CASES)
def test_set_kernel_matches_plain(name, shape, dtype):
    """set_node_full (the deck's generated kernel) against its plain
    version on the same seeded grids on the card: node residual and
    rows, steady or at a DIRK-2,2 stage-1 call."""
    from mrhyde_tpu_torch.ops import fused_set as fs
    from mrhyde_tpu_torch.ops.fused_p1 import Stage
    from mrhyde_tpu_torch.problem import Problem
    dev = _card()
    p = Problem(_set_cfg(name, *shape), device=dev, dtype=dtype)
    f = p.assembler.fused_provider()
    assert isinstance(f, fs.FusedSetAssembly)
    stage = name.endswith("stage")
    au, at = (NS_STAGE1 if name.startswith("ns") else DIRK22_STAGE1) \
        if stage else (1.0, 0.0)
    sc = fs.SetScalars(0.0125, 0.01 if stage else 1.0, ())
    jac_idx = f._classify(sc, au, at, not stage)[0]
    g = torch.Generator(device=dev).manual_seed(77)
    grid = (f.nv, shape[0] + 1, shape[1] + 1)
    ue = torch.rand(grid, generator=g, device=dev, dtype=dtype) - 0.5
    ud = 20.0 * (torch.rand(grid, generator=g, device=dev, dtype=dtype)
                 - 0.5) if stage else None
    args = (f.form, ue, ud, sc, f.tables, (f.origin, f.h_axes, f.q_off),
            jac_idx, Stage(au, at, None) if stage else None)
    (r, j), (rp, jp) = fs.set_node_full(*args), fs.set_node_full_plain(*args)
    assert r.shape == rp.shape and j.shape == jp.shape
    assert _close(r, rp, dtype) and _close(j, jp, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["ns_thermal_advected_supg_stage",
                                  "ns_cdr_supg_stage",
                                  "thermal_cdr_kappa_ec_steady"])
def test_set_provider_on_card_matches_cpu(name):
    """The module-set provider on CUDA (one set_node_full launch) against
    the same call on the CPU (plain version): residual and every
    Jacobian row, f64."""
    from mrhyde_tpu_torch.assembly.assembler import TimeCoeffs
    from mrhyde_tpu_torch.interop import (state_from_numpy, state_to_numpy,
                                          time_coeffs_from_numpy)
    from mrhyde_tpu_torch.ops import fused_p1 as fp
    from mrhyde_tpu_torch.problem import Problem
    dev = _card()
    stage = name.endswith("stage")
    out = {}
    for d in ("cpu", dev):
        p = Problem(_set_cfg(name, 9, 7), device=d)
        n = p.n_dof
        tc = (time_coeffs_from_numpy(NS_STAGE1[0], seeded(n, seed=11),
                                     NS_STAGE1[1], seeded(n, seed=12), 0.3,
                                     0.01, p)
              if stage else TimeCoeffs.steady(n, device=d))
        f = p.assembler.fused_provider()
        before = dict(fp.LAUNCHES)
        r, rows = f.res_jac(state_from_numpy(seeded(n, seed=9), p), tc)
        launched = {k: v - before[k] for k, v in fp.LAUNCHES.items()}
        assert launched == {k: int(d == dev and k == "set_node_full")
                            for k in launched}
        out[str(d)] = (state_to_numpy(r),
                       [None if x is None else state_to_numpy(x)
                        for x in rows])
    (rc, jc), (rg, jg) = out["cpu"], out[str(dev)]
    assert np.max(np.abs(rg - rc)) <= 1e-12 * max(1.0, np.max(np.abs(rc)))
    for a, b in zip(jg, jc):
        assert (a is None) == (b is None)
        if a is not None:
            assert np.max(np.abs(a - b)) <= 1e-12 * max(1.0,
                                                        np.max(np.abs(b)))


@pytest.mark.cuda
def test_set_wrapper_checks_inputs_on_card():
    from mrhyde_tpu_torch.ops import fused_set as fs
    from mrhyde_tpu_torch.ops.fused_p1 import Stage
    from mrhyde_tpu_torch.problem import Problem
    dev = _card()
    f = Problem(_set_cfg("ns_cdr_supg_stage", 4, 4), device=dev) \
        .assembler.fused_provider()
    sc = fs.SetScalars(0.0, 0.01, ())
    geo = (f.origin, f.h_axes, f.q_off)
    ue = torch.zeros((4, 5, 5), device=dev, dtype=torch.float64)
    with pytest.raises(ValueError):          # three grids for four variables
        fs.set_node_full(f.form, ue[:3].contiguous(), None, sc, f.tables,
                         geo, (0,))
    with pytest.raises(ValueError):          # a stage without u_dot grids
        fs.set_node_full(f.form, ue, None, sc, f.tables, geo, (0,),
                         Stage(*NS_STAGE1, None))
    with pytest.raises(ValueError):          # tables in another dtype
        fs.set_node_full(f.form, ue.float(), None, sc, f.tables, geo, (0,))


# ----------------------------------------------------------------------
# the element-tile module-set kernel set_elem_full (generated per deck)
# ----------------------------------------------------------------------

def _set_elem_cfg(name, dims):
    """The phase 3g cases of chip_smoke.py, and NS + thermal + cdr on hex
    (nd = 48), on an element grid `dims`."""
    from torch_port_utils import (cdr_state_velocity_hex_cfg,
                                  ns_cdr_elem_cfg, ns_thermal_cdr_elem_cfg,
                                  ns_thermal_elem_cfg, thermal_cdr_p2_cfg)
    transient = {"solver": "transient"}
    cfg = {"ns_thermal_hex_pspg_steady": lambda: ns_thermal_elem_cfg(
               "hex", dims),
           "ns_cdr_hex_supg_stage": lambda: ns_cdr_elem_cfg("hex", dims),
           "ns_thermal_cdr_hex_supg_stage": lambda: ns_thermal_cdr_elem_cfg(
               "hex", dims, solver=transient),
           "ns_thermal_p2_supg_stage": lambda: ns_thermal_elem_cfg(
               "p2", dims, supg=True, solver=transient),
           "ns_visc_ux2_hex_pspg_steady": lambda: ns_elem_cfg(
               "hex", dims, visc="1.0 + 0.1*ux*ux"),
           "thermal_cdr_kappa_ec_p2_steady": lambda: thermal_cdr_p2_cfg(
               dims[0]),
           "cdr_velocity_c_hex_steady": lambda: cdr_state_velocity_hex_cfg(
               dims[0])}[name]()
    cfg["Mesh"].update(zip(("NX", "NY", "NZ"), dims))
    return cfg


SET_ELEM_SHAPES = {"hex": [(5, 3, 2), (9, 4, 3)], "p2": [(7, 3), (17, 5)]}
SET_ELEM_CASES = ["ns_thermal_hex_pspg_steady", "ns_cdr_hex_supg_stage",
                  "ns_thermal_cdr_hex_supg_stage",
                  "ns_thermal_p2_supg_stage", "ns_visc_ux2_hex_pspg_steady",
                  "thermal_cdr_kappa_ec_p2_steady",
                  "cdr_velocity_c_hex_steady"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("which", [0, 1])
@pytest.mark.parametrize("name", SET_ELEM_CASES)
def test_set_elem_kernel_matches_plain(name, which, dtype):
    """set_elem_full (the deck's generated kernel) against its plain
    version on the same seeded grids on the card: residual rows and
    Jacobian rows, steady or at a DIRK-2,2 stage-1 call, at small odd
    element grids (one and several blocks of 16 elements)."""
    from mrhyde_tpu_torch.ops import fused_set as fs
    from mrhyde_tpu_torch.ops._launch import LAUNCHES
    from mrhyde_tpu_torch.ops.fused_p1 import Stage
    from mrhyde_tpu_torch.problem import Problem
    dev = _card()
    dims = SET_ELEM_SHAPES["p2" if "_p2_" in name else "hex"][which]
    p = Problem(_set_elem_cfg(name, dims), device=dev, dtype=dtype)
    f = p.assembler.fused_provider()
    assert isinstance(f, fs.FusedSetAssembly) and not f.node
    stage = name.endswith("stage")
    au, at = NS_STAGE1 if stage else (1.0, 0.0)
    sc = fs.SetScalars(0.0125, 0.01 if stage else 1.0, ())
    jac_idx = f._classify(sc, au, at, not stage)[0]
    g = torch.Generator(device=dev).manual_seed(78)
    grid = (f.nv,) + tuple(f.grid_shape)
    ue = torch.rand(grid, generator=g, device=dev, dtype=dtype) - 0.5
    ud = 20.0 * (torch.rand(grid, generator=g, device=dev, dtype=dtype)
                 - 0.5) if stage else None
    args = (f.form, ue, ud, sc, f.tables, f.lattice,
            (f.origin, f.h_axes, f.q_off), jac_idx,
            Stage(au, at, None) if stage else None)
    before = LAUNCHES["set_elem_full"]
    (r, j), (rp, jp) = fs.set_elem_full(*args), fs.set_elem_full_plain(*args)
    assert LAUNCHES["set_elem_full"] == before + 1
    assert r.shape == rp.shape == (f.nd, int(np.prod(dims)))
    assert j.shape == jp.shape
    assert _close(r, rp, dtype) and _close(j, jp, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["ns_cdr_hex_supg_stage",
                                  "ns_thermal_p2_supg_stage",
                                  "thermal_cdr_kappa_ec_p2_steady"])
def test_set_elem_provider_on_card_matches_cpu(name):
    """The module-set provider on hex and p2 on CUDA (one set_elem_full
    launch, its rows scattered) against the same call on the CPU (plain
    version): residual and every Jacobian row, f64."""
    from mrhyde_tpu_torch.assembly.assembler import TimeCoeffs
    from mrhyde_tpu_torch.interop import (state_from_numpy, state_to_numpy,
                                          time_coeffs_from_numpy)
    from mrhyde_tpu_torch.ops import fused_p1 as fp
    from mrhyde_tpu_torch.problem import Problem
    dev = _card()
    stage = name.endswith("stage")
    dims = (7, 3) if "_p2_" in name else (5, 3, 2)
    out = {}
    for d in ("cpu", dev):
        p = Problem(_set_elem_cfg(name, dims), device=d)
        n = p.n_dof
        tc = (time_coeffs_from_numpy(NS_STAGE1[0], seeded(n, seed=11),
                                     NS_STAGE1[1], seeded(n, seed=12), 0.3,
                                     0.01, p)
              if stage else TimeCoeffs.steady(n, device=d))
        f = p.assembler.fused_provider()
        before = dict(fp.LAUNCHES)
        r, rows = f.res_jac(state_from_numpy(seeded(n, seed=9), p), tc)
        launched = {k: v - before[k] for k, v in fp.LAUNCHES.items()}
        assert launched == {k: int(d == dev and k == "set_elem_full")
                            for k in launched}
        out[str(d)] = (state_to_numpy(r),
                       [None if x is None else state_to_numpy(x)
                        for x in rows])
    (rc, jc), (rg, jg) = out["cpu"], out[str(dev)]
    assert np.max(np.abs(rg - rc)) <= 1e-12 * max(1.0, np.max(np.abs(rc)))
    for a, b in zip(jg, jc):
        assert (a is None) == (b is None)
        if a is not None:
            assert np.max(np.abs(a - b)) <= 1e-12 * max(1.0,
                                                        np.max(np.abs(b)))


@pytest.mark.cuda
def test_set_elem_wrapper_checks_inputs_on_card():
    from mrhyde_tpu_torch.ops import fused_set as fs
    from mrhyde_tpu_torch.ops.fused_p1 import Stage
    from mrhyde_tpu_torch.problem import Problem
    dev = _card()
    f = Problem(_set_elem_cfg("ns_cdr_hex_supg_stage", (4, 2, 2)),
                device=dev).assembler.fused_provider()
    sc = fs.SetScalars(0.0, 0.01, ())
    geo = (f.origin, f.h_axes, f.q_off)
    ue = torch.zeros((5, 5, 3, 3), device=dev, dtype=torch.float64)
    with pytest.raises(ValueError):          # four grids for five variables
        fs.set_elem_full(f.form, ue[:4].contiguous(), None, sc, f.tables,
                         f.lattice, geo, (0,))
    with pytest.raises(ValueError):          # a stage without u_dot grids
        fs.set_elem_full(f.form, ue, None, sc, f.tables, f.lattice, geo,
                         (0,), Stage(*NS_STAGE1, None))
    with pytest.raises(ValueError):          # tables in another dtype
        fs.set_elem_full(f.form, ue.float(), None, sc, f.tables, f.lattice,
                         geo, (0,))


# ----------------------------------------------------------------------
# mode "state" of affine module sets, and the kernels at any quadrature
# ----------------------------------------------------------------------

# the state kernels' grids beyond the odd ones (a partial last block):
# several of set_node_state's walk tiles (15 x 31 nodes) with a partial
# last one on each axis (2D p1 47 x 97: 4 x 4 tiles), several of
# set_elem_state's blocks of 128 elements with a partial last one (hex
# 19x11x9, p2 37x29), and a single element
STATE_GRIDS = {"p1": {"tiles": (47, 97, None), "one": (1, 1, None)},
               "hex": {"tiles": (19, 11, 9), "one": (1, 1, 1)},
               "p2": {"tiles": (37, 29, None), "one": (1, 1, None)}}


@pytest.mark.cuda
@pytest.mark.parametrize("grid", ["odd", "tiles", "one"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("stage", [False, True])
@pytest.mark.parametrize("mesh", ["p1", "hex", "p2"])
def test_state_kernel_matches_plain(mesh, stage, dtype, grid):
    """set_node_state (2D p1) and set_elem_state (hex, p2) of an affine
    thermal + cdr set (kappa = 1 + 0.5 x: the state part varies by
    element) against their plain versions on the card, steady and at a
    DIRK-2,2 stage, at odd grids (a partial last block), at grids of
    several tiles or blocks with a partial last one on each axis, and on
    a single element."""
    from mrhyde_tpu_torch.ops import fused_set as fs
    from mrhyde_tpu_torch.ops._launch import LAUNCHES
    from mrhyde_tpu_torch.ops.fused_p1 import Stage
    from mrhyde_tpu_torch.problem import Problem
    from torch_port_utils import AFFINE_MESHES, thermal_cdr_affine_cfg
    dev = _card()
    cfg = thermal_cdr_affine_cfg(mesh, stage)
    nx, ny, nz = AFFINE_MESHES[mesh]
    if grid == "odd":
        nx, ny, nz = 5 * nx + 2, 3 * ny + 1, nz and 3 * nz + 1
    else:
        nx, ny, nz = STATE_GRIDS[mesh][grid]
    cfg["Mesh"].update({"NX": nx, "NY": ny})
    if nz:
        cfg["Mesh"]["NZ"] = nz
    f = Problem(cfg, device=dev, dtype=dtype).assembler.fused_provider()
    assert f._detect_affine(not stage)
    g = torch.Generator(device=dev).manual_seed(91)
    u = torch.rand((f.nv,) + tuple(f.grid_shape), generator=g, device=dev,
                   dtype=dtype) - 0.5
    sc = fs.SetScalars(0.1, 0.05, ())
    geo = (f.origin, f.h_axes, f.q_off)
    st = Stage(*DIRK22_STAGE1, None) if stage else None
    if mesh == "p1":
        args = (f.form, u, sc, f.tables, geo, st)
        fn, plain, key = fs.set_node_state, fs.set_node_state_plain, \
            "set_node_state"
    else:
        args = (f.form, u, sc, f.tables, f.lattice, geo, st)
        fn, plain, key = fs.set_elem_state, fs.set_elem_state_plain, \
            "set_elem_state"
    before = LAUNCHES[key]
    out, ref = fn(*args), plain(*args)
    assert LAUNCHES[key] == before + 1
    assert out.shape == ref.shape and _close(out, ref, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("kernel", ["ns_elem_full", "set_elem_full",
                                    "set_node_full"])
def test_kernels_at_lifted_quadratures_match_plain(kernel, dtype):
    """ns_elem_full and set_elem_full on hex at quadrature 6 (Q = 64,
    fewer than 16 elements per block) and set_node_full on 2D p1 at
    quadrature 8 (Q = 25) against their plain versions on the card,
    through their providers' own grids."""
    from types import SimpleNamespace
    from mrhyde_tpu_torch.ops import fused_ns as fn
    from mrhyde_tpu_torch.ops import fused_set as fs
    from mrhyde_tpu_torch.problem import Problem
    from torch_port_utils import ns_thermal_elem_cfg
    dev = _card()
    if kernel == "ns_elem_full":
        cfg, quad = ns_elem_cfg("hex", (5, 3, 2)), 6
    elif kernel == "set_elem_full":
        cfg, quad = ns_thermal_elem_cfg("hex", (5, 3, 2)), 6
    else:
        cfg, quad = channel_cfg(9, 5, visc="1.0 + 0.1*ux*ux"), 8
    cfg["Discretization"]["quadrature"] = quad
    f = Problem(cfg, device=dev, dtype=dtype).assembler.fused_provider()
    assert f.tables.Q == (64 if quad == 6 else 25)
    g = torch.Generator(device=dev).manual_seed(17)
    grid = (f.nv,) + tuple(f.grid_shape)
    ue = torch.rand(grid, generator=g, device=dev, dtype=dtype) - 0.5
    geo = (f.origin, f.h_axes, f.q_off)
    if kernel == "ns_elem_full":
        coeffs = f._coefficients(0.0, dict(f.asm.params))
        form = f._form(SimpleNamespace(deltat=1.0))
        jac_idx = f._classify(coeffs, form, 1.0, 0.0, True)[0]
        args = (ue, None, coeffs, f.tables, f.lattice, form, jac_idx)
        out, ref = fn.ns_elem_full(*args), fn.ns_elem_full_plain(*args)
    else:
        sc = fs.SetScalars(0.0, 1.0, ())
        jac_idx = f._classify(sc, 1.0, 0.0, True)[0]
        if kernel == "set_elem_full":
            args = (f.form, ue, None, sc, f.tables, f.lattice, geo, jac_idx)
            out, ref = fs.set_elem_full(*args), fs.set_elem_full_plain(*args)
        else:
            args = (f.form, ue, None, sc, f.tables, geo, jac_idx)
            out, ref = fs.set_node_full(*args), fs.set_node_full_plain(*args)
    for o, r in zip(out, ref):
        assert o.shape == r.shape and _close(o, r, dtype)
