"""Distribution v2 in mrhyde_tpu_torch (`parallel/dof_sharding.py`)
against the JAX package's (`mrhyde_tpu/parallel/dof_sharding.py`) on the
CPU in f64: the owned/ghost partition's integer tables are JAX's, and
the sharded residual, Newton-CG step and GMRES step over 8 stacked
shards (StackedComm) equal JAX's programs over 8 virtual CPU devices
(tests/conftest.py) to 1e-10 relative. Inputs are made from a numpy
seed."""

import copy
import io
from contextlib import redirect_stdout

import jax
import numpy as np
import pytest
import torch

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import chip_smoke as cs  # noqa: E402
from torch_port_utils import (both_problems, channel_cfg, hex_cfg,  # noqa
                              p2_cfg, seeded, thermal_cfg)

torch.set_num_threads(1)

RTOL = 1e-10


def _mesh(n):
    from jax.sharding import Mesh
    return Mesh(np.array(jax.devices("cpu")[:n]), ("dp",))


def maxwell_cfg():
    """The JAX package's mixing-channel deck: tet HCURL E of order 2 (the
    2x2 face-pair mixing), HDIV B, one transient step."""
    return {
        "Mesh": {"dimension": 3, "element type": "tet",
                 "NX": 4, "NY": 2, "NZ": 2},
        "Physics": {"modules": "maxwell",
                    "Initial conditions": {
                        f"{v}[{c}]": "0.0"
                        for v in ("E", "B") for c in "xyz"}},
        "Functions": {"current x": "1.0", "permittivity": "1.0",
                      "permeability": "1.0"},
        "Discretization": {"order": {"E": 2, "B": 1}, "quadrature": 4},
        "Solver": {"solver": "transient", "final time": 0.01,
                   "number of steps": 1},
    }


def porous_mixed_cfg():
    """The JAX package's signed-space deck: RT0 u, p0 p."""
    return {
        "Mesh": {"dimension": 2, "element type": "quad",
                 "NX": 12, "NY": 12},
        "Physics": {"modules": "porous mixed",
                    "Dirichlet conditions": {
                        "p": {"all boundaries": "0.0"}}},
        "Functions": {"source": cs.SOURCE},
        "Solver": {"solver": "steady-state", "initial type": "none"},
        "Discretization": {"order": {"p": 0, "u": 1}, "quadrature": 2},
    }


def _sharded_pair(cfg, shards):
    """(JAX Problem, port Problem, JAX DofShardedStep, port
    DofShardedStep) of a deck at `shards` shards."""
    from mrhyde_tpu.parallel.dof_sharding import DofShardedStep as JaxStep
    from mrhyde_tpu_torch.parallel.comm import StackedComm
    from mrhyde_tpu_torch.parallel.dof_sharding import DofShardedStep
    pj, pt = both_problems(cfg)
    return (pj, pt, JaxStep(pj.assembler, _mesh(shards), cg_iters=30),
            DofShardedStep(pt.assembler, StackedComm(shards), cg_iters=30))


def _tc_pair(pj, pt, seed=None, alphas=(1.0, 0.0), time=0.3,
             deltat=0.05):
    """(JAX, port) TimeCoeffs: steady, or a stage with seeded betas."""
    import jax.numpy as jnp
    from mrhyde_tpu.assembly.assembler import TimeCoeffs as JaxTC
    from mrhyde_tpu_torch.assembly.assembler import TimeCoeffs
    from mrhyde_tpu_torch.interop import time_coeffs_from_numpy
    if seed is None:
        return (JaxTC.steady(pj.n_dof, dtype=jnp.float64),
                TimeCoeffs.steady(pt.n_dof, dtype=torch.float64))
    bu = seeded(pj.n_dof, seed=seed, scale=0.1)
    bt = seeded(pj.n_dof, seed=seed + 1, scale=0.1)
    tj = JaxTC(jnp.asarray(alphas[0]), jnp.asarray(bu),
               jnp.asarray(alphas[1]), jnp.asarray(bt), jnp.asarray(time),
               jnp.asarray(deltat))
    return tj, time_coeffs_from_numpy(alphas[0], bu, alphas[1], bt, time,
                                      deltat, pt)


def _both_sharded(sj, st, vec):
    """A global vector as (JAX's sharded array, the port's (S, nmax)
    tensor)."""
    mesh = sj.mesh
    return (sj.part.to_sharded(vec, mesh),
            torch.as_tensor(st.part.to_sharded(vec)))


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _active_boundary_cfg(n):
    cfg = cs.field_boundary_deck(n)
    del cfg["Parameters"]
    cfg["Physics"]["Neumann conditions"] = {
        "e": {"right": "2.0 + x*y", "top": "1.0 - y"}}
    return cfg


PARTITION_DECKS = {
    "thermal_16": (lambda: thermal_cfg(16), 8),
    "hex_4_s4": (lambda: hex_cfg(4, 4, 4), 4),
    "hex_4_s8": (lambda: hex_cfg(4, 4, 4), 8),
    "p2_8": (lambda: p2_cfg(8), 8),
    "ns_channel_16x8": (lambda: channel_cfg(16, 8), 8),
    "tet_hcurl_order2": (maxwell_cfg, 2),
    "active_boundary_16": (lambda: _active_boundary_cfg(16), 8),
}


@pytest.mark.parametrize("name", list(PARTITION_DECKS))
def test_partition_tables_equal_jax(name):
    """build_dof_partition's ownership, ghost lists and per-shard tables
    are the JAX package's, or both refuse the partition (a half-layer
    hex chunk reaches two shards away)."""
    from mrhyde_tpu.parallel.dof_sharding import \
        build_dof_partition as jax_build
    from mrhyde_tpu_torch.parallel.dof_sharding import build_dof_partition
    build, shards = PARTITION_DECKS[name]
    pj, pt = both_problems(build())
    try:
        want = jax_build(pj.assembler, shards)
    except ValueError as e:
        with pytest.raises(ValueError, match="non-neighbor shards"):
            build_dof_partition(pt.assembler, shards)
        assert "non-neighbor shards" in str(e)
        return
    got = build_dof_partition(pt.assembler, shards)
    for key in ("n_shards", "n_dof", "nmax", "gp_max", "gn_max", "emax"):
        assert getattr(got, key) == getattr(want, key), key
    for key in ("owner", "local_pos", "cuts"):
        np.testing.assert_array_equal(getattr(got, key), getattr(want, key))
    for key in ("owned", "gprev", "gnext"):
        for a, b in zip(getattr(got, key), getattr(want, key)):
            np.testing.assert_array_equal(a, b)
    assert set(got.arrays) == set(want.arrays)
    for key, val in want.arrays.items():
        if isinstance(val, dict):
            for k, v in val.items():
                np.testing.assert_array_equal(got.arrays[key][k], v)
        else:
            np.testing.assert_array_equal(got.arrays[key], val)
    if name == "tet_hcurl_order2":
        assert "mix" in got.arrays
    if name == "active_boundary_16":
        assert pt.assembler._active_bnd_groups()


def test_non_neighbor_partition_raises_and_the_deck_halves():
    """On the 4x4 multiscale macro mesh 8 shards reach two shards away:
    the partition raises, and a deck asking for 8 halves to 4 with the
    JAX package's line."""
    from mrhyde_tpu_torch.parallel.dof_sharding import build_dof_partition
    from mrhyde_tpu_torch.problem import Problem
    cfg = cs.ms_gold_deck(4)
    cfg["Solver"]["shards"] = 8
    p = Problem(cfg, device="cpu")
    with pytest.raises(ValueError, match="non-neighbor shards"):
        build_dof_partition(p.assembler, 8)
    out = io.StringIO()
    with redirect_stdout(out):
        fn = p._newton_fn()
    assert out.getvalue() == ("[mrhyde] mesh too small for the halo ring "
                              "at 8 shards; using 4\n")
    assert type(fn).__name__ == "ShardedNewton"
    assert fn.comm.n_shards == 4


@pytest.mark.parametrize("stage", [False, True], ids=["steady", "betas"])
def test_sharded_residual_matches_jax(stage):
    """The sharded residual at a seeded u (and seeded betas at a stage)
    equals JAX's sharded program's."""
    pj, pt, sj, st = _sharded_pair(thermal_cfg(32), 8)
    u = seeded(pj.n_dof, seed=3, scale=1.0)
    tj, tt = _tc_pair(pj, pt, seed=7 if stage else None,
                      alphas=(1.0, 20.0))
    uj, ut = _both_sharded(sj, st, u)
    bj, bt_ = _both_sharded(sj, st, np.asarray(tj.beta_u))
    cj, ct = _both_sharded(sj, st, np.asarray(tj.beta_t))
    r_j = sj.part.from_sharded(sj.residual_fn()(uj, bj, cj, tj))
    r_t = st.part.from_sharded(st.residual_fn()(ut, bt_, ct, tt).numpy())
    assert _rel(r_t, r_j) < RTOL
    # and the global residual of the port's unsharded assembler
    r_g = pt.assembler.residual(torch.as_tensor(u), tt).numpy()
    assert _rel(r_t, r_g) < RTOL


def test_newton_cg_step_matches_jax_and_replicated():
    """One Newton-CG step (30 iterations) at 32^2 equals JAX's
    DofShardedStep step and its replicated sharded_newton_cg_step."""
    from mrhyde_tpu.parallel.sharding import sharded_newton_cg_step
    import jax.numpy as jnp
    pj, pt, sj, st = _sharded_pair(thermal_cfg(32), 8)
    tj, tt = _tc_pair(pj, pt)
    u0 = np.zeros(pj.n_dof)
    uj, ut = _both_sharded(sj, st, u0)
    zj, zt = _both_sharded(sj, st, u0)
    u1j, rnj = sj.newton_cg_step_fn()(uj, zj, zj, tj)
    u1t, rnt = st.newton_cg_step_fn()(ut, zt, zt, tt)
    u1t = st.part.from_sharded(u1t.numpy())
    assert _rel(u1t, sj.part.from_sharded(u1j)) < RTOL
    assert abs(float(rnt) - float(rnj)) <= RTOL * float(rnj)
    rep, _ = sharded_newton_cg_step(pj.assembler, sj.mesh, cg_iters=30)
    u1r, rnr = rep(jnp.asarray(u0), tj, None)
    assert _rel(u1t, u1r) < RTOL
    assert abs(float(rnt) - float(rnr)) <= RTOL * float(rnr)


def test_gmres_du_step_on_the_ns_channel_matches_jax():
    """The sharded GMRES(20) x 2 Newton step on the 16x8 NS channel at a
    seeded state equals JAX's newton_du_fn."""
    pj, pt, sj, st = _sharded_pair(channel_cfg(16, 8), 8)
    tj, tt = _tc_pair(pj, pt)
    u = seeded(pj.n_dof, seed=11, scale=0.1)
    uj, ut = _both_sharded(sj, st, u)
    zj, zt = _both_sharded(sj, st, np.zeros(pj.n_dof))
    duj, rnj = sj.newton_du_fn((), method="gmres", gmres_m=20,
                               gmres_restarts=2)(uj, zj, zj, tj, {})
    dut, rnt = st.newton_du_fn((), method="gmres", gmres_m=20,
                               gmres_restarts=2)(ut, zt, zt, tt, {})
    assert _rel(st.part.from_sharded(dut.numpy()),
                sj.part.from_sharded(duj)) < RTOL
    assert abs(float(rnt) - float(rnj)) <= RTOL * float(rnj)


@pytest.mark.parametrize("kind", ["signed", "mixing"])
def test_oriented_residuals_match_jax(kind):
    """HDIV signs (porous mixed, 4 shards) and the tet HCURL mixing
    channel (maxwell, 2 shards, a stage) ride the owned/ghost gather: the
    sharded residual equals JAX's; the mixing deck's Newton-CG step too."""
    cfg, shards = ((porous_mixed_cfg(), 4) if kind == "signed"
                   else (maxwell_cfg(), 2))
    pj, pt, sj, st = _sharded_pair(cfg, shards)
    if kind == "mixing":
        assert pt.assembler.mixp is not None
        tj, tt = _tc_pair(pj, pt, seed=5, alphas=(1.0, 50.0), time=0.005,
                          deltat=0.01)
    else:
        tj, tt = _tc_pair(pj, pt)
    u = seeded(pj.n_dof, seed=13, scale=1.0)
    uj, ut = _both_sharded(sj, st, u)
    bj, bt_ = _both_sharded(sj, st, np.asarray(tj.beta_u))
    cj, ct = _both_sharded(sj, st, np.asarray(tj.beta_t))
    r_j = sj.part.from_sharded(sj.residual_fn()(uj, bj, cj, tj))
    r_t = st.part.from_sharded(st.residual_fn()(ut, bt_, ct, tt).numpy())
    assert _rel(r_t, r_j) < RTOL
    if kind == "mixing":
        u1j, _ = sj.newton_cg_step_fn()(uj, bj, cj, tj)
        u1t, _ = st.newton_cg_step_fn()(ut, bt_, ct, tt)
        assert _rel(st.part.from_sharded(u1t.numpy()),
                    sj.part.from_sharded(u1j)) < RTOL


def test_global_sharded_round_trip():
    """gather_global / scatter_global invert each other, and the owned
    slices are DofPartition.to_sharded's."""
    from mrhyde_tpu_torch.parallel.comm import StackedComm
    from mrhyde_tpu_torch.parallel.dof_sharding import DofShardedStep
    _pj, pt = both_problems(copy.deepcopy(hex_cfg(4, 4, 4)))
    st = DofShardedStep(pt.assembler, StackedComm(4))
    v = torch.as_tensor(seeded(pt.n_dof, seed=2))
    sh = st.gather_global(v)
    np.testing.assert_array_equal(
        np.where(st.part.arrays["valid"], sh.numpy(), 0.0),
        st.part.to_sharded(v.numpy()))
    np.testing.assert_array_equal(st.scatter_global(sh).numpy(), v.numpy())
