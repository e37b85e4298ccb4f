"""Distribution v1 ("replicated") in mrhyde_tpu_torch
(`parallel/sharding.py`, `parallel/comm.py`) against the JAX package's
`mrhyde_tpu/parallel/sharding.py` on the CPU in f64: the element-sharded
Newton steps over 8 stacked shards equal JAX's over 8 virtual CPU devices
(tests/conftest.py) to 1e-10 relative, padded element counts, oriented
dofs and a multiscale deck's sharded fine solves included; the
communicator's ring shifts and psum; and the ensemble half of the
parallel story, UQManager.run_vmapped, against JAX's and the sample
loop."""

import jax
import numpy as np
import pytest
import torch

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import chip_smoke as cs  # noqa: E402
from torch_port_utils import (both_problems, channel_cfg, seeded,  # noqa
                              thermal_cfg, uq_cfg)
from test_torch_dof_sharding import _mesh, _rel, _tc_pair, \
    porous_mixed_cfg  # noqa: E402

torch.set_num_threads(1)

RTOL = 1e-10


def test_stacked_comm_shifts_and_psum():
    """shift_next moves shard s's rows to s+1 with zeros into shard 0,
    shift_prev the other way; psum adds the per-shard rows; a
    ProcessGroupComm without an initialised process group raises, and so
    does a process group of the wrong size."""
    from mrhyde_tpu_torch.parallel.comm import ProcessGroupComm, StackedComm
    from mrhyde_tpu_torch.parallel.sharding import make_comm
    c = StackedComm(3)
    x = torch.arange(6.0).reshape(3, 2)
    np.testing.assert_array_equal(c.shift_next(x).numpy(),
                                  [[0, 0], [0, 1], [2, 3]])
    np.testing.assert_array_equal(c.shift_prev(x).numpy(),
                                  [[2, 3], [4, 5], [0, 0]])
    np.testing.assert_array_equal(c.psum(x).numpy(), [6, 9])
    assert make_comm(3).n_shards == 3
    with pytest.raises(RuntimeError, match="initialised"):
        ProcessGroupComm()
    with pytest.raises(RuntimeError, match="initialised"):
        make_comm(2, distributed=True)


def test_pad_elements():
    from mrhyde_tpu.parallel.sharding import pad_elements as jax_pad
    from mrhyde_tpu_torch.parallel.sharding import pad_elements
    for e, s in ((36, 8), (64, 8), (1, 4), (7, 7)):
        assert pad_elements(e, s) == jax_pad(e, s)


DECKS = {
    # 36 elements over 8 shards: 4 padding elements
    "thermal_6x6_padded": (lambda: thermal_cfg(6), None),
    "thermal_32": (lambda: thermal_cfg(32), None),
    "porous_mixed_signs": (porous_mixed_cfg, None),
    "thermal_stage": (lambda: thermal_cfg(8), 9),
}


@pytest.mark.parametrize("name", list(DECKS))
def test_replicated_newton_cg_step_matches_jax(name):
    """One element-sharded Newton-CG step (30 iterations) at 8 shards at a
    seeded state equals JAX's sharded_newton_cg_step at 8 devices."""
    import jax.numpy as jnp
    from mrhyde_tpu.parallel.sharding import \
        sharded_newton_cg_step as jax_step
    from mrhyde_tpu_torch.parallel.comm import StackedComm
    from mrhyde_tpu_torch.parallel.sharding import sharded_newton_cg_step
    build, seed = DECKS[name]
    pj, pt = both_problems(build())
    tj, tt = _tc_pair(pj, pt, seed=seed, alphas=(0.5, 40.0))
    u = seeded(pj.n_dof, seed=17, scale=0.5)
    step_j, _ = jax_step(pj.assembler, _mesh(8), cg_iters=30)
    u1j, rnj = step_j(jnp.asarray(u), tj, None)
    step_t, arrays = sharded_newton_cg_step(pt.assembler, StackedComm(8),
                                            cg_iters=30)
    assert arrays["Epad"] % 8 == 0
    u1t, rnt = step_t(torch.as_tensor(u), tt)
    assert _rel(u1t.numpy(), u1j) < RTOL
    assert abs(float(rnt) - float(rnj)) <= RTOL * float(rnj)


def test_replicated_du_step_gmres_and_res_norm_match_jax():
    """sharded_newton_du_step's GMRES(20) x 2 step and residual norm on
    the 16x8 NS channel equal JAX's."""
    import jax.numpy as jnp
    from mrhyde_tpu.parallel.sharding import \
        sharded_newton_du_step as jax_du
    from mrhyde_tpu_torch.parallel.comm import StackedComm
    from mrhyde_tpu_torch.parallel.sharding import sharded_newton_du_step
    pj, pt = both_problems(channel_cfg(16, 8))
    tj, tt = _tc_pair(pj, pt)
    u = seeded(pj.n_dof, seed=4, scale=0.1)
    du_j, rn_j = jax_du(pj.assembler, _mesh(8), method="gmres", gmres_m=20,
                        gmres_restarts=2)
    du_t, rn_t = sharded_newton_du_step(pt.assembler, StackedComm(8),
                                        method="gmres", gmres_m=20,
                                        gmres_restarts=2)
    dj, nj = du_j(jnp.asarray(u), tj, None)
    dt_, nt = du_t(torch.as_tensor(u), tt)
    assert _rel(dt_.numpy(), dj) < RTOL
    assert abs(float(nt) - float(nj)) <= RTOL * float(nj)
    assert abs(float(rn_t(torch.as_tensor(u), tt))
               - float(rn_j(jnp.asarray(u), tj, None))) <= RTOL * float(nj)


def test_multiscale_fine_solves_sharded():
    """The multiscale gold deck's element-sharded Newton-CG step, its fine
    DtN solves behind SubgridDtN.enable_device_sharding (a no-op for
    stacked shards), equals JAX's at 8 devices and the port's at 1
    shard; the residual norm is the assembler's."""
    import jax.numpy as jnp
    from mrhyde_tpu.parallel.sharding import \
        sharded_newton_cg_step as jax_step
    from mrhyde_tpu_torch.parallel.comm import StackedComm
    from mrhyde_tpu_torch.parallel.sharding import sharded_newton_cg_step
    pj, pt = both_problems(cs.ms_gold_deck(4))
    tj, tt = _tc_pair(pj, pt)
    u = seeded(pj.n_dof, seed=13, scale=0.1)
    step_j, _ = jax_step(pj.assembler, _mesh(8), cg_iters=30)
    u8j, rn8j = step_j(jnp.asarray(u), tj, None)
    outs = {}
    for s in (8, 1):
        step, _ = sharded_newton_cg_step(pt.assembler, StackedComm(s),
                                         cg_iters=30)
        outs[s] = step(torch.as_tensor(u), tt)
    assert pt.multiscale._comm is None
    r_ref = pt.assembler.residual(torch.as_tensor(u), tt)
    assert abs(float(outs[8][1]) - float(torch.linalg.norm(r_ref))) \
        <= 1e-12 * float(torch.linalg.norm(r_ref))
    assert _rel(outs[8][0].numpy(), u8j) < RTOL
    assert _rel(outs[8][0].numpy(), outs[1][0].numpy()) < RTOL
    assert abs(float(outs[8][1]) - float(rn8j)) <= RTOL * float(rn8j)


def _dense_pair(pj, pt):
    """The same dense system (A, b) of a small deck in both packages."""
    import jax.numpy as jnp
    from mrhyde_tpu.assembly.assembler import TimeCoeffs as JaxTC
    from mrhyde_tpu_torch.assembly.assembler import TimeCoeffs
    zj = jnp.zeros(pj.n_dof)
    rj, Jj = pj.assembler.res_and_jac(zj, JaxTC.steady(pj.n_dof,
                                                       dtype=zj.dtype))
    zt = torch.zeros(pt.n_dof, dtype=torch.float64)
    rt, Jt = pt.assembler.res_and_jac(zt, TimeCoeffs.steady(pt.n_dof))
    return (Jj.dense(), -rj), (Jt.dense(), -rt)


def test_run_vmapped_matches_jax_and_the_sample_loop():
    """UQManager.run_vmapped: the same seeded samples as JAX's, and each
    response (a dense solve of the 4x4 deck's system with kappa scaling
    its operator and amp its load) equals JAX's vmapped one and the
    port's sample loop `run` to 1e-12."""
    import jax.numpy as jnp
    from mrhyde_tpu.analysis.uq import UQManager as JaxUQ
    from mrhyde_tpu_torch.analysis.uq import UQManager
    cfg = uq_cfg(4, samples=7)
    pj, pt = both_problems(cfg)
    (Aj, bj), (At, bt) = _dense_pair(pj, pt)
    eye_j, eye_t = jnp.eye(Aj.shape[0]), torch.eye(At.shape[0],
                                                   dtype=At.dtype)

    def fwd_j(s):
        x = jnp.linalg.solve(s["kappa"] * Aj + 0.1 * eye_j, s["amp"] * bj)
        return jnp.sum(x * x)

    def fwd_t(s):
        x = torch.linalg.solve(s["kappa"] * At + 0.1 * eye_t,
                               s["amp"] * bt)
        return torch.sum(x * x)

    uq_cfg_ = cfg["Analysis"]["UQ"]
    sj, rj = JaxUQ(pj.param_manager, uq_cfg_).run_vmapped(fwd_j)
    uq = UQManager(pt.param_manager, uq_cfg_)
    st, rt = uq.run_vmapped(fwd_t, device="cpu")
    _sl, rl = uq.run(lambda s: fwd_t({k: torch.as_tensor(v)
                                      for k, v in s.items()}).item())
    assert set(st) == set(sj) == {"kappa", "amp"}
    for k in st:
        np.testing.assert_array_equal(st[k], np.asarray(sj[k]))
    assert rt.shape == (7,)
    np.testing.assert_allclose(rt, np.asarray(rj), rtol=1e-12)
    np.testing.assert_allclose(rt, rl, rtol=1e-12)
