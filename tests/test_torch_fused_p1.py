"""The port's fused node-scatter provider (mrhyde_tpu_torch/ops/
fused_p1.py), with its kernels' plain versions on the CPU, against the
JAX package's FusedP1Assembly.res_jac in Pallas interpret mode, which
runs the node-scatter TPU kernel B2 on the CPU: residual, the kind of
each Jacobian row (None / element-independent scalar / (E,) array) and
its value, and the row classification (`fk.stats`).

Tolerance 1e-11 absolute: the same f64 weak form summed in the same
corner and quadrature order, on O(1) entries."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrhyde_tpu.ops.fused_p1 import FusedP1Assembly as JaxFused
from mrhyde_tpu_torch.interop import state_from_numpy
from mrhyde_tpu_torch.ops import fused_p1 as fp
from torch_port_utils import (KAPPAS, SOURCE_NL, both_problems, max_diff,
                              seeded, steady_coeffs, thermal_cfg)

torch.set_num_threads(1)

TOL = 1e-11


def _kind(row):
    if row is None:
        return "none"
    return "array" if np.ndim(row) >= 1 else "scalar"


@pytest.mark.parametrize("nx,ny", [(4, 4), (6, 5)])
@pytest.mark.parametrize("kappa", KAPPAS)
def test_fused_provider_matches_jax_node_kernel(kappa, nx, ny):
    cfg = thermal_cfg(nx, ny, kappa=kappa)
    if kappa == "1.0 + e*e":
        cfg["Functions"]["thermal source"] = SOURCE_NL
    pj, pt = both_problems(cfg)
    tj, tt = steady_coeffs(pj, pt)
    u = seeded(pj.n_dof, seed=21)
    fk = JaxFused.build(pj.assembler)
    r_j, rows_j = fk.res_jac(jnp.asarray(u), tj, None, interpret=True)
    ft = pt.assembler.fused_provider()
    assert ft is not None
    r_t, rows_t = ft.res_jac(state_from_numpy(u, pt), tt)

    assert max_diff(r_t, r_j) < TOL
    assert len(rows_t) == len(rows_j) == 16
    for k, (rj, rt) in enumerate(zip(rows_j, rows_t)):
        assert _kind(rt) == _kind(rj), f"row {k}"
        if rj is not None:
            assert max_diff(rt, rj) < TOL, f"row {k}"
    for key in ("steady", "split", "n_res_rows", "n_jac_rows",
                "coord_res_rows", "coord_jac_rows", "node_scatter"):
        assert ft.stats.get(key) == fk.stats.get(key), key


@pytest.mark.parametrize("kappa", KAPPAS)
def test_res_and_jac_engages_fused_and_matches_general(kappa):
    """On the CPU res_and_jac goes through the fused provider (plain
    kernels) and agrees with the port's general path."""
    from mrhyde_tpu_torch.assembly.assembler import TimeCoeffs
    from mrhyde_tpu_torch.problem import Problem
    pt = Problem(thermal_cfg(6, 5, kappa=kappa), device="cpu")
    tt = TimeCoeffs.steady(pt.n_dof)
    u = torch.as_tensor(seeded(pt.n_dof, seed=22))
    r, J = pt.assembler.res_and_jac(u, tt)
    assert J.vol is None and J.vol_soa is not None
    Jg = pt.assembler.jacobian(u, tt)
    assert max_diff(r, pt.assembler.residual(u, tt)) < TOL
    assert max_diff(J.aos(), Jg.vol) < TOL
    v = torch.as_tensor(seeded(pt.n_dof, seed=23, scale=1.0))
    assert max_diff(J.apply(v), Jg.apply(v)) < TOL
    assert max_diff(J.diag(), Jg.diag()) < TOL


def _tables():
    from mrhyde_tpu_torch.problem import Problem
    pt = Problem(thermal_cfg(5, 3), device="cpu")
    return pt.assembler.fused_provider().tables


def test_wrappers_take_plain_versions_on_cpu_tensors():
    tab = _tables()
    rng = np.random.RandomState(31)
    u = torch.as_tensor(rng.randn(6, 4))
    E = 15
    qp = [torch.as_tensor(rng.randn(E, tab.Q)) for _ in range(4)]
    before = dict(fp.LAUNCHES)
    assert torch.equal(fp.thermal_node_state(u, 1.5, tab),
                       fp.thermal_node_state_plain(u, 1.5, tab))
    assert torch.equal(fp.thermal_node_state(u, qp[2], tab),
                       fp.thermal_node_state_plain(u, qp[2], tab))
    out, jac = fp.thermal_node_full(u, *qp, tab)
    ref, jref = fp.thermal_node_full_plain(u, *qp, tab)
    assert torch.equal(out, ref) and torch.equal(jac, jref)
    assert jac.shape == (16, E) and out.shape == u.shape
    assert fp.LAUNCHES == before          # plain versions launch nothing


def test_cuda_is_refused_without_a_card():
    """Asking for the card where there is none raises; nothing falls
    back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from mrhyde_tpu_torch.problem import Problem
    from mrhyde_tpu_torch.runtime import resolve_device
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    with pytest.raises(RuntimeError):
        Problem(thermal_cfg(4), device="cuda")
    tab = _tables()
    with pytest.raises(ValueError):
        fp.thermal_node_state(torch.zeros(5, 4, device="meta"), 1.0, tab)


def test_qp_density_matches_jax_thermal():
    """The port's thermal qp_density (the weak form the kernels hard-code)
    against the JAX module's on the same per-qp state."""
    from mrhyde_tpu.functions.manager import FunctionManager as JaxFM
    from mrhyde_tpu.physics.thermal import Thermal as JaxThermal
    from mrhyde_tpu_torch.functions.manager import FunctionManager
    from mrhyde_tpu_torch.physics.thermal import Thermal

    class Ctx:
        def __init__(self, fm, x, u, g):
            self.fm, self.x, self.u, self.g = fm, x, u, g

        def f(self, name):
            return self.fm.evaluate(name, self)

        def sol_dot(self, v):
            return 0.0

        def grad(self, v):
            return self.g

        def resolve(self, leaf):
            return {"x": self.x, "e": self.u}[leaf]

    fs = {"thermal diffusion": "1 + e*e + x", "thermal source": "sin(x)"}
    rng = np.random.RandomState(41)
    x, u, g0, g1 = (rng.randn(7) for _ in range(4))
    out = {}
    for name, mod, fm, arr in (("jax", JaxThermal, JaxFM(), jnp.asarray),
                               ("torch", Thermal, FunctionManager(),
                                torch.as_tensor)):
        m = mod({}, 2)
        m.define_functions(fm, fs)
        S, F = m.qp_density(Ctx(fm, arr(x), arr(u),
                                [arr(g0), arr(g1)]))["e"]
        out[name] = [np.asarray(S)] + [np.asarray(f) for f in F]
    for a, b in zip(out["torch"], out["jax"]):
        assert max_diff(a, b) < 1e-14
