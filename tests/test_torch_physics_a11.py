"""A11's physics in mrhyde_tpu_torch (mixed, hybridized and weak
Galerkin porous flow, maxwell and maxwell control, maxwells_fp,
hybridized shallow water, Euler's HDG form) against the JAX package on
the CPU in f64: each small deck's solution at every recorded time within
1e-11 (relative to max |u|; every norm within 1e-11 of JAX's, or 1e-13
absolute for a norm that is 0 to round-off), the reference's golds of
the decks chip_smoke.py holds on the card, every A11 deck name building
without a fused provider. tests/test_torch_physics_a11_forms.py holds
the residuals and Jacobians. The decks are chip_smoke.py's, at small
sizes (torch_port_utils.a11_decks)."""

import jax
import numpy as np
import pytest
import torch

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import chip_smoke as cs  # noqa: E402
from torch_port_utils import a11_decks, solve_both  # noqa: E402

torch.set_num_threads(1)

DECKS = a11_decks()
# the residual and Jacobian of Euler on hex are held in _forms.py: its
# JAX solve takes a minute of compiling here
SOLVED = sorted(set(DECKS) - {"euler_hex"}) + ["mixed_perm_data",
                                               "weak_galerkin_perm_data"]


@pytest.mark.parametrize("name", SOLVED)
def test_solution_matches_jax(name, tmp_path):
    build = DECKS.get(name) or a11_decks(str(tmp_path))[name]
    pt = solve_both(build())[2]
    assert pt.assembler.fused_provider() is None


GOLDS = {
    # porous/Mixed (tests/test_mixed_porous.py)
    "porous_mixed_gold_nx8": (lambda: cs.porous_mixed_deck(8), {0.0: {
        ("L2", "p"): (0.158697, 2e-5), ("L2", "u"): (1.02259, 2e-5),
        ("L2-div", "u"): (12.390539, 1e-4)}}),
    # its hybridized form (tests/test_hybridized.py:12-33)
    "porous_mixed_hybrid_gold_nx8": (
        lambda: cs.porous_mixed_deck(8, hybrid=True), {0.0: {
            ("L2", "p"): (0.158697, 2e-5), ("L2", "u"): (1.02259, 2e-5)}}),
    # porous/WeakGalerkin_2D (tests/test_hybridized.py:37-72)
    "porous_weak_galerkin_gold_nx10": (lambda: cs.weak_galerkin_deck(10), {
        0.0: {("L2", "pint"): (0.127469, 2e-5),
              ("L2-face", "pbndry"): (1.2962, 2e-5),
              ("L2", "u"): (0.814028, 2e-5),
              ("L2", "t"): (0.814028, 2e-5)}}),
    # maxwell/NonzeroIC (tests/test_maxwell.py:17-56)
    "maxwell_nonzero_ic_hex_nx8": (lambda: cs.maxwell_deck(8), {
        0.0: {("L2", "E"): (0.0692758, 2e-5), ("L2", "B"): (0.0976523, 2e-5)},
        0.01: {("L2", "E"): (0.0743729, 2e-5),
               ("L2", "B"): (0.101339, 2e-5)}}),
    # maxwell_fp/3D_verfication (tests/test_maxwell_fp_gold.py:44-77)
    "maxwells_fp_3d_gold_nx5": (lambda: cs.maxwells_fp_deck(5), {0.0: {
        ("L2", v): (g, 2e-5) for v, g in (
            ("Arx", 0.0115417), ("Aix", 0.013503), ("phir", 0.0108162),
            ("phii", 0.0124067), ("Ary", 0.0104865), ("Aiy", 0.0126923),
            ("Arz", 0.0209644), ("Aiz", 0.0253728))}}),
}


@pytest.mark.parametrize("name", sorted(GOLDS))
def test_reference_gold(name):
    """The reference's golds on the port alone (the decks chip_smoke.py's
    vector_decks phase holds on the card)."""
    from mrhyde_tpu_torch.problem import Problem
    build, times = GOLDS[name]
    res = Problem(build(), device="cpu").run()
    hist = {round(t, 10): e for t, e in res.error_history}
    for t, want in times.items():
        for key, (gold, rtol) in want.items():
            assert hist[t][key] == pytest.approx(gold, rel=rtol), (t, key)


A11_NAMES = {
    "maxwell": lambda: cs.maxwell_deck(2),
    "maxwell control": DECKS["maxwell_control"],
    "maxwells_freq_pot": lambda: cs.maxwells_fp_deck(2),
    "porous mixed": lambda: cs.porous_mixed_deck(2),
    "porous mixed hybridized": lambda: cs.porous_mixed_deck(2, hybrid=True),
    "porous weak Galerkin": lambda: cs.weak_galerkin_deck(2),
    "shallow water hybridized": lambda: cs.swe_hybridized_deck(2),
    "Euler": lambda: cs.euler_hdg_deck(4),
}


@pytest.mark.parametrize("name", sorted(A11_NAMES))
def test_a11_deck_names_build_without_a_fused_provider(name):
    """Every deck name the port refused as A11 builds through Problem
    on the CPU, and the fused providers' entry point (FusedP1Assembly
    .build, which hands NS decks and module sets on) takes none: the
    general path, as in the JAX package. A deck with signs, mixing, face
    terms or a face space is refused by each of the three providers
    itself; maxwells_fp and hybridized shallow water hold only HGRAD
    variables and no module of a kernel."""
    from mrhyde_tpu_torch.ops.fused_ns import FusedNSAssembly
    from mrhyde_tpu_torch.ops.fused_p1 import FusedP1Assembly
    from mrhyde_tpu_torch.ops.fused_set import FusedSetAssembly
    from mrhyde_tpu_torch.problem import Problem
    cfg = A11_NAMES[name]()
    assert cfg["Physics"]["modules"] == name
    asm = Problem(cfg, device="cpu").assembler
    assert asm.fused_provider() is None
    assert FusedP1Assembly.build(asm) is None
    hgrad_only = name in ("maxwells_freq_pot", "shallow water hybridized")
    assert asm.general_only != hgrad_only
    if asm.general_only:
        for provider in (FusedNSAssembly, FusedSetAssembly):
            assert provider.build(asm) is None


@pytest.mark.parametrize("mesh", ["quad", "hex"])
def test_fused_providers_refuse_oriented_and_face_decks(mesh):
    """A thermal deck that the providers take on structured quads or hex
    is refused once it holds a vector variable (its oriented dofs), an
    HFACE variable, or 'assemble face terms'."""
    from mrhyde_tpu_torch.ops.fused_p1 import FusedP1Assembly
    from mrhyde_tpu_torch.problem import Problem
    from torch_port_utils import hex_cfg, thermal_cfg
    base = thermal_cfg(4) if mesh == "quad" else hex_cfg(2, 2, 2)
    assert FusedP1Assembly.build(Problem(base, device="cpu")
                                 .assembler) is not None
    for key, val in (("Extra variables", {"w": "HDIV"}),
                     ("Extra variables", {"lam": "HFACE"}),
                     ("assemble face terms", True)):
        cfg = dict(base, Physics=dict(base["Physics"], **{key: val}))
        asm = Problem(cfg, device="cpu").assembler
        assert asm.general_only
        assert FusedP1Assembly.build(asm) is None


def test_euler_needs_a_stabilization():
    """The reference refuses Euler without a stabilization method
    (euler.cpp:63-65), as the JAX package does."""
    from mrhyde_tpu_torch.physics.euler import Euler
    with pytest.raises(ValueError, match="stabilization"):
        Euler({}, dim=2)


def test_swe_flux_jacobian_eig_matches_jax():
    """The SWE normal flux Jacobian and its eigenvalues (the reference's
    unit test) equal JAX's; the eigenvalues are the Jacobian's."""
    from mrhyde_tpu.physics.shallowwater_hybridized import \
        swe_flux_jacobian_eig as jax_eig
    from mrhyde_tpu_torch.physics.shallowwater_hybridized import \
        swe_flux_jacobian_eig
    H, hu, n = 2.0, np.array([1.0, -0.5]), np.array([0.6, 0.8])
    A, lam = swe_flux_jacobian_eig(H, hu, n, 9.8)
    Aj, lamj = jax_eig(H, hu, n, 9.8)
    np.testing.assert_allclose(A, Aj, rtol=1e-14, atol=1e-14)
    np.testing.assert_allclose(lam, lamj, rtol=1e-14)
    np.testing.assert_allclose(np.sort(lam),
                               np.sort(np.linalg.eigvals(A).real),
                               rtol=1e-12)
