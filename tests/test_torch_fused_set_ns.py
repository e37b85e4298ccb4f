"""The module-set provider (mrhyde_tpu_torch/ops/fused_set.py) on NS +
cdr (cdr advected by (ux, uy), source ux 1 + 0.1 c^2) and on NS whose
viscosity reads the state, against the JAX package's node-scatter kernel
B2 in Pallas interpret mode (1e-10, its `stats`) and the port's general
path (1e-11); and the provider's routing: decks that the specialized
kernels carry keep them, sets and state-reading coefficients on hex and
p2 quads reach the element-tile set kernel, and a coefficient without a
generated form leaves the deck to the general path."""

import jax
import numpy as np
import pytest
import torch

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

from torch_port_utils import (NS_STAGE1, both_problems,  # noqa: E402
                              cdr_cfg, channel_cfg,
                              check_fused_against_general,
                              check_fused_against_jax, ns_cdr_cfg,
                              ns_elem_cfg, ns_thermal_cfg,
                              ns_thermal_elem_cfg, seeded,
                              stage_coeffs, steady_coeffs, thermal_cfg,
                              thermal_cdr_affine_cfg)

torch.set_num_threads(1)

CASES = {
    "ns_cdr_supg_stage": (ns_cdr_cfg, True),
    "ns_visc_ux2_pspg_steady": (
        lambda: channel_cfg(4, 4, visc="1.0 + ux*ux"), False),
}


@pytest.mark.parametrize("name", list(CASES))
def test_provider_matches_jax_node_kernel(name):
    from mrhyde_tpu_torch.ops.fused_set import FusedSetAssembly
    build, stage = CASES[name]
    pj, pt = both_problems(build())
    assert isinstance(pt.assembler.fused_provider(), FusedSetAssembly)
    tj, tt = (stage_coeffs(pj, pt, *NS_STAGE1, seed=31, deltat=0.01)
              if stage else steady_coeffs(pj, pt))
    u = seeded(pt.n_dof, seed=5)
    ft = check_fused_against_jax(pj, pt, tj, tt, u, 1e-10)
    assert ft.stats["split"] is False and ft.stats["node_scatter"] is True
    check_fused_against_general(pt, tt, torch.as_tensor(u), 1e-11)


def _provider(cfg):
    from mrhyde_tpu_torch.problem import Problem
    return Problem(cfg, device="cpu", dtype=torch.float64) \
        .assembler.fused_provider()


@pytest.mark.parametrize("deck", ["thermal", "thermal_kappa_e", "cdr",
                                  "ns", "ns_transient", "ns_hex"])
def test_specialized_kernels_keep_their_decks(deck, monkeypatch):
    """A single thermal, cdr or NS module whose velocity and NS
    coefficients read no state still takes its own kernel (its wrapper
    runs, the module-set one never)."""
    from mrhyde_tpu_torch.assembly.assembler import TimeCoeffs
    from mrhyde_tpu_torch.ops import fused_elem, fused_ns, fused_p1, \
        fused_set
    cfgs = {"thermal": thermal_cfg(4), "cdr": cdr_cfg(4, reaction="0.5*c*c"),
            "thermal_kappa_e": thermal_cfg(4, kappa="1.0 + e*e"),
            "ns": channel_cfg(4, 2),
            "ns_transient": channel_cfg(4, 2, supg=True, solver={
                "solver": "transient", "final time": 0.04,
                "number of steps": 4}),
            "ns_hex": ns_elem_cfg("hex", (4, 2, 2))}
    calls = []
    for mod, name in ((fused_p1, "thermal_node_state"),
                      (fused_p1, "thermal_node_full"),
                      (fused_ns, "ns_node_full"),
                      (fused_ns, "ns_elem_full"),
                      (fused_elem, "thermal_elem_state"),
                      (fused_set, "set_node_full")):
        orig = getattr(mod, name)

        def spy(*a, _orig=orig, _name=name, **k):
            calls.append(_name)
            return _orig(*a, **k)
        monkeypatch.setattr(mod, name, spy)
    fused = _provider(cfgs[deck])
    assert isinstance(fused, (fused_p1.FusedP1Assembly,
                              fused_ns.FusedNSAssembly))
    n = fused.asm.n_dof
    fused.res_jac(torch.as_tensor(seeded(n, seed=2)),
                  TimeCoeffs.steady(n))
    want = {"thermal": "thermal_node_state", "cdr": "thermal_node_full",
            "thermal_kappa_e": "thermal_node_full", "ns": "ns_node_full",
            "ns_transient": "ns_node_full", "ns_hex": "ns_elem_full"}
    assert set(calls) == {want[deck]}


def test_sets_on_hex_and_p2(monkeypatch):
    """Sets with NS, NS coefficients that read the state, a thermal + cdr
    set and a velocity that reads the state, on hex and p2, reach the
    element-tile set kernels (one call per assembly, no other kernel):
    set_elem_full, and set_elem_state for the thermal + cdr set, whose
    coefficients read no state (an affine set: JAX's split path)."""
    from mrhyde_tpu_torch.assembly.assembler import TimeCoeffs
    from mrhyde_tpu_torch.ops import fused_elem, fused_ns, fused_p1, \
        fused_set
    ns_thermal = ns_elem_cfg("hex", (2, 2, 2))
    ns_thermal["Physics"]["modules"] = "navier stokes,thermal"
    tc_hex = cdr_cfg(2, 2, 2)
    tc_hex["Physics"]["modules"] = "thermal,cdr"
    vel_p2 = cdr_cfg(2, order=2)
    vel_p2["Functions"]["xvel"] = "c"
    decks = [ns_thermal, ns_elem_cfg("p2", (2, 2), visc="1.0 + ux*ux"),
             tc_hex, vel_p2]
    calls = []
    for mod, name in ((fused_p1, "thermal_node_full"),
                      (fused_ns, "ns_elem_full"),
                      (fused_elem, "thermal_elem_full"),
                      (fused_set, "set_node_full"),
                      (fused_set, "set_elem_full"),
                      (fused_set, "set_node_state"),
                      (fused_set, "set_elem_state")):
        orig = getattr(mod, name)

        def spy(*a, _orig=orig, _name=name, **k):
            calls.append(_name)
            return _orig(*a, **k)
        monkeypatch.setattr(mod, name, spy)
    for cfg in decks:
        fused = _provider(cfg)
        assert isinstance(fused, fused_set.FusedSetAssembly)
        assert not fused.node
        n = fused.asm.n_dof
        fused.res_jac(torch.as_tensor(seeded(n, seed=2)),
                      TimeCoeffs.steady(n))
    assert calls == ["set_elem_full", "set_elem_full", "set_elem_state",
                     "set_elem_full"]


@pytest.mark.parametrize("mesh", ["hex", "p2"])
def test_b1_decks_without_a_generated_form(mesh):
    """On hex and p2 as in 2D: a set whose coefficient has no C++ form
    (emax) takes the general path, and so do an NS coefficient that
    reads a gradient, or z in 2D, and a velocity that reads a gradient,
    as on the JAX package's default path."""
    dims = (2, 2, 2) if mesh == "hex" else (2, 2)
    cfg = ns_elem_cfg(mesh, dims)
    cfg["Physics"]["modules"] = "navier stokes,thermal"
    cfg["Functions"]["thermal source"] = "emax(x)"
    assert _provider(cfg) is None
    assert _provider(ns_elem_cfg(mesh, dims,
                                 visc="1.0 + grad(ux)[y]")) is None
    if mesh == "p2":
        assert _provider(ns_elem_cfg(mesh, dims, visc="1.0 + z*ux")) is None
    cfg = cdr_cfg(*dims) if mesh == "hex" else cdr_cfg(2, order=2)
    cfg["Functions"]["xvel"] = "grad(c)[x]"
    assert _provider(cfg) is None


@pytest.mark.parametrize("mesh,quad,n_qp,fused", [
    ("p1", 6, 16, True), ("p1", 8, 25, True), ("p1", 44, 529, True),
    ("hex", 4, 27, True), ("hex", 6, 64, True)])
def test_set_decks_past_the_kernels_qp_limit_take_the_general_path(
        mesh, quad, n_qp, fused):
    """The set kernels take any quadrature the card's shared memory
    holds: an NS + thermal deck past the 16 qps (2D p1) and 27 (hex) the
    kernels' layouts held before takes the set provider, as JAX's kernel
    runs it, at every count of qps (the kernels hold fewer elements per
    block: tests/test_torch_codegen.py), no longer the general path."""
    import numpy as np
    from mrhyde_tpu_torch.ops.fused_set import FusedSetAssembly
    from mrhyde_tpu_torch.problem import Problem
    cfg = (ns_thermal_cfg() if mesh == "p1"
           else ns_thermal_elem_cfg("hex", (2, 2, 2)))
    cfg["Discretization"]["quadrature"] = quad
    asm = Problem(cfg, device="cpu", dtype=torch.float64).assembler
    assert np.asarray(asm.disc.wts[0]).size == n_qp
    assert fused
    f = asm.fused_provider()
    assert isinstance(f, FusedSetAssembly) and f.tables.Q == n_qp


def test_affine_set_past_the_state_kernels_limit_raises():
    """Only an affine set launches set_node_state, so only an affine set
    is held to its layout, at its first state launch (an NS + thermal set
    at 529 qps builds, above, and never checks it): thermal + cdr with
    constant coefficients fits at 34 points per direction and is refused
    at 35, where set_node_full's layout, checked when the provider is
    built, still fits."""
    from mrhyde_tpu_torch.assembly.assembler import TimeCoeffs
    from mrhyde_tpu_torch.ops.fused_set import FusedSetAssembly
    from mrhyde_tpu_torch.problem import Problem

    def provider(cfg, quad=None):
        if quad is not None:
            cfg["Discretization"]["quadrature"] = quad
        f = Problem(cfg, device="cpu", dtype=torch.float64) \
            .assembler.fused_provider()
        assert isinstance(f, FusedSetAssembly)
        return f

    def assemble(f):
        f.jacobian(torch.zeros(f.asm.n_dof, dtype=torch.float64),
                   TimeCoeffs.steady(f.asm.n_dof))
    # the first assembly checks the layout of a split set alone
    f = provider(thermal_cdr_affine_cfg("p1", flux=False))
    assemble(f)
    assert f.stats["split"] and f._state_checked
    f = provider(ns_thermal_cfg())
    assemble(f)
    assert not f.stats["split"] and not f._state_checked
    provider(thermal_cdr_affine_cfg("p1", flux=False), 66) \
        ._check_state_layout()
    f = provider(thermal_cdr_affine_cfg("p1", flux=False), 68)
    assert f.tables.Q == 35 * 35 and f._detect_affine(True)
    with pytest.raises(ValueError,
                       match="set_node_state at 1225 .* shared memory"):
        f._check_state_layout()


REMAINDER_DECKS = {
    # an advection velocity that reads the state's gradient
    "cdr_xvel_grad_c_nx8": lambda: dict(
        cdr_cfg(8), Functions=dict(cdr_cfg(8)["Functions"],
                                   xvel="grad(c)[x]")),
    # an NS viscosity that reads a velocity gradient
    "ns_visc_grad_ux_10x4": lambda: channel_cfg(
        10, 4, visc="1 + 0.1*(grad(ux)[y])^2"),
}


@pytest.mark.parametrize("deck", ["emax", *REMAINDER_DECKS])
def test_coefficients_without_a_generated_form_take_the_general_path(deck):
    """An element reduction (emax) has no C++ form: the set takes the
    general path, as JAX's would on a deck its kernel cannot trace. A
    velocity or NS coefficient that reads a gradient takes the general
    path too, as the JAX package's default path does (its kernel raises
    KeyError there), and solves to JAX's numbers."""
    if deck == "emax":
        cfg = ns_thermal_cfg()
        cfg["Functions"]["thermal source"] = "emax(x)"
        assert _provider(cfg) is None
        return
    cfg = REMAINDER_DECKS[deck]()
    pj, pt = both_problems(cfg)
    assert pt.assembler.fused_provider() is None
    rj, rt = pj.run(), pt.run()
    uj = np.asarray(rj.u)
    assert np.max(np.abs(rt.u.numpy() - uj)) <= 1e-11 * np.max(np.abs(uj))
    for key, val in rj.errors.items():
        assert abs(rt.errors[key] - val) <= 1e-11 * abs(val), key


def test_time_and_parameters_are_kernel_arguments():
    """The generated source reads t from the kernel's arguments: the
    stages of a transient deck share one library."""
    cfg = ns_thermal_cfg(transient=True)
    cfg["Functions"]["thermal source"] = "sin(2*pi*t)*x*e"
    src = _provider(cfg).form.source
    assert "const T t = T(a.sc[0]);" in src
    assert "ad_sin((T(6.2831853071795862) * t))" in src
