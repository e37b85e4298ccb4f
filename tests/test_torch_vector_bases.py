"""The vector and trace bases of mrhyde_tpu_torch (ROADMAP A11) against
the JAX package on the CPU in f64: the orientation folds W g, W^T r and
W^T J W (HDIV / HCURL signs on quads, triangles and hex, the 2x2 mixing
channel of tet HCURL of order 2) at 1e-15; the workset's div, curl,
HFACE trace and per-side solutions; the L2 projection onto HDIV and
HCURL; the error norms of vector variables (components, div, the 2D and
the 3D curl) and the L2-face norm of a trace at 1e-12; and the dof
layouts that 'Active variables' and 'Extra variables' build. Inputs are
seeded with numpy and cross through interop.py."""

import copy

import jax
import numpy as np
import pytest
import torch

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import chip_smoke as cs  # noqa: E402
from torch_port_utils import both_problems, seeded  # noqa: E402

torch.set_num_threads(1)


def _maxwell(cell, n, order_e=1, nz=None):
    """A transient maxwell deck on n^dim cells with an L2-projected field
    whose every component varies (quad: HCURL E, HVOL B; hex and tet:
    HCURL E, HDIV B)."""
    dim = 2 if cell in ("quad", "tri") else 3
    comps = "xyz"[:dim]
    ics = {f"E[{c}]": f"sin(1.3*x + {i + 1}*y) + 0.2*x*y"
           for i, c in enumerate(comps)}
    if dim == 2:
        ics["B"] = "cos(pi*x)*y"
    else:
        ics.update({f"B[{c}]": f"x*y - {i}*z + 0.1"
                    for i, c in enumerate(comps)})
    mesh = {"dimension": dim, "element type": cell, "NX": n, "NY": n}
    if dim == 3:
        mesh["NZ"] = nz or n
    return {
        "Mesh": mesh,
        "Physics": {"modules": "maxwell", "Initial conditions": ics},
        "Functions": {"permittivity": "1.5", "conductivity": "0.2"},
        "Discretization": {"order": {"E": order_e, "B": 1},
                           "quadrature": 2 * order_e},
        "Solver": {"solver": "transient", "final time": 0.01,
                   "number of steps": 1, "use direct solver": True,
                   "transient Butcher tableau": "BWE",
                   "initial type": "L2-projection"},
        "Postprocess": {"compute errors": True,
                        "True solutions": dict(ics)},
    }


def _mixed(cell, n):
    cfg = cs.porous_mixed_deck(n)
    cfg["Mesh"]["element type"] = cell
    return cfg


# name -> deck with oriented dofs
ORIENTED = {
    "quad_hdiv": lambda: _mixed("quad", 3),
    "tri_hdiv": lambda: _mixed("tri", 3),
    "quad_hcurl": lambda: _maxwell("quad", 3),
    "hex_hcurl_hdiv": lambda: _maxwell("hex", 2),
    "tet_hcurl2_mixing": lambda: _maxwell("tet", 1, order_e=2),
}


def _arrays(asm):
    return [np.asarray(a) if a is not None else None
            for a in (asm.signs, asm.mixp, asm.mixw, asm.mixwT)]


@pytest.fixture(scope="module")
def oriented():
    return {name: both_problems(build()) for name, build in ORIENTED.items()}


@pytest.mark.parametrize("name", sorted(ORIENTED))
@pytest.mark.parametrize("fold", ["W", "WT", "jac_WT_W"])
def test_fold_matches_jax(oriented, name, fold):
    """The gather fold, the scatter fold and the Jacobian fold of seeded
    element arrays equal JAX's (within 1e-15 of the largest entry), with
    the same signs, pairs and weights; only tet HCURL of order 2 has a
    mixing channel, and every deck has a sign of -1."""
    import jax.numpy as jnp
    from mrhyde_tpu.assembly import assembler as ja
    from mrhyde_tpu_torch.assembly import assembler as ta
    pj, pt = oriented[name]
    aj, at = pj.assembler, pt.assembler
    assert at.has_signs and aj.has_signs
    assert (at.mixp is not None) == name.endswith("mixing")
    for a, b in zip(_arrays(at), _arrays(aj)):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)
    E, nd = at.lids.shape
    shape = (E, nd, nd) if fold == "jac_WT_W" else (E, nd)
    g = seeded(int(np.prod(shape)), seed=4).reshape(shape)
    mix = (aj.mixw if fold == "W" else aj.mixwT)
    want = np.asarray(getattr(ja, f"_fold_{fold}")(
        jnp.asarray(g), aj.signs, aj.mixp, mix))
    got = getattr(ta, f"_fold_{fold}")(
        torch.as_tensor(g), at.signs, at.mixp,
        at.mixw if fold == "W" else at.mixwT).numpy()
    assert np.max(np.abs(got - want)) <= 1e-15 * np.max(np.abs(want))
    assert np.max(np.abs(got - g)) > 0.1    # some dof changes frame


def test_dofmap_fold_of_tensors(oriented):
    """DofMap.fold of a tensor (the error norms' gather fold) equals its
    fold of the numpy array, per variable slice and whole."""
    pt = oriented["tet_hcurl2_mixing"][1]
    dm = pt.disc.dofmap
    g = seeded(dm.lids.size, seed=8).reshape(dm.lids.shape)
    np.testing.assert_array_equal(dm.fold(torch.as_tensor(g)).numpy(),
                                  dm.fold(g))
    st, nd = dm.offsets["E"]
    np.testing.assert_array_equal(
        dm.fold(torch.as_tensor(g[:, st:st + nd]), st, nd).numpy(),
        dm.fold(g[:, st:st + nd], st, nd))


def _worksets(pj, pt, e, seed):
    """Both packages' volume worksets of element e at a seeded state
    (its coefficients folded into the element's frame)."""
    import jax.numpy as jnp
    from mrhyde_tpu.assembly.assembler import TimeCoeffs as JaxTC
    from mrhyde_tpu_torch.assembly.assembler import TimeCoeffs
    aj, at = pj.assembler, pt.assembler
    u = seeded(pj.n_dof, seed=seed)
    uj, _, _ = aj._gathered(jnp.asarray(u), JaxTC.steady(pj.n_dof),
                            aj.lids)
    ut, _, _ = at._gathered(torch.as_tensor(u),
                            TimeCoeffs.steady(pt.n_dof))

    def elem(tree, ax, lib):
        if ax is None:
            return tree
        if isinstance(tree, dict):
            return {k: elem(v, ax, lib) for k, v in tree.items()}
        return tree[e]
    bgj = elem(aj.g_bg, aj._bg_ax, jnp)
    bgt = elem(at.g_bg, at._geo_ax, torch)
    wj = aj.g_wts if aj._wts_ax is None else aj.g_wts[e]
    wt = at.g_wts if at._geo_ax is None else at.g_wts[e]
    wkj = aj._make_workset(uj[e], None, wj, aj.g_ip[e], bgj, 0.0, None)
    wkt = at._workset(wt, at.g_ip[e], at.g_bv, bgt, ut[e], None, 0.0,
                      dict(at.params), 1.0)
    return wkj, wkt


def _faces(cell, module, trace_order=0):
    """A face-term deck: Euler's HDG deck at 8x2, or the hybridized
    mixed or weak Galerkin deck on a 3x2 (3x2x2) mesh, with the trace
    lambda of the given order."""
    if module == "Euler":
        return cs.euler_hdg_deck(8)
    dim = 2 if cell == "quad" else 3
    cfg = cs.porous_mixed_deck(3, hybrid=True) if module == "hybrid" \
        else cs.weak_galerkin_deck(3)
    cfg["Mesh"] = {"dimension": dim, "element type": cell, "NX": 3,
                   "NY": 2, "NZ": 2}
    if trace_order:
        cfg["Discretization"]["order"]["lambda"] = trace_order
    return cfg


# (deck, method, variable, per side)
WORKSET_CASES = {
    "div_quad": (lambda: _mixed("quad", 3), "div", "u", False),
    "div_tri": (lambda: _mixed("tri", 3), "div", "u", False),
    "sol_hdiv_quad": (lambda: _mixed("quad", 3), "sol", "u", False),
    "curl_2d": (lambda: _maxwell("quad", 3), "curl", "E", False),
    "curl_3d_hex": (lambda: _maxwell("hex", 2), "curl", "E", False),
    "curl_3d_tet_mixing": (lambda: _maxwell("tet", 1, order_e=2), "curl",
                           "E", False),
    "sol_hdiv_hex": (lambda: _maxwell("hex", 2), "sol", "B", False),
    "trace_order0_quad": (lambda: _faces("quad", "hybrid"), "trace",
                          "lambda", True),
    "trace_order1_quad": (lambda: _faces("quad", "Euler"), "trace",
                          "rho_hat", True),
    "trace_order1_hex": (lambda: _faces("hex", "hybrid", 1), "trace",
                         "lambda", True),
    "face_sol_hvol": (lambda: _faces("quad", "hybrid"), "face_sol", "p",
                      True),
    "face_sol_dg": (lambda: _faces("quad", "Euler"), "face_sol", "rhoE",
                    True),
    "face_sol_vec_hdiv_dg": (lambda: _faces("hex", "hybrid"),
                             "face_sol_vec", "u", True),
}


@pytest.mark.parametrize("case", sorted(WORKSET_CASES))
def test_workset_fields_match_jax(case):
    """div (HDIV), the 2D scalar and 3D vector curl (HCURL), an HDIV
    field, the HFACE trace on each side (order 0 and 1), and a scalar
    and a broken-HDIV field on each side, at two elements of a seeded
    state, within 1e-12 of JAX's."""
    build, method, var, per_side = WORKSET_CASES[case]
    pj, pt = both_problems(build())
    for e in (0, pt.mesh.n_elem - 1):
        wkj, wkt = _worksets(pj, pt, e, seed=e + 3)
        sides = range(wkt.n_sides()) if per_side else [None]
        for s in sides:
            args = (var,) if s is None else (var, s)
            want = np.broadcast_to(np.asarray(getattr(wkj, method)(*args)),
                                   np.shape(getattr(wkt, method)(*args)))
            got = getattr(wkt, method)(*args).numpy()
            assert got.shape == want.shape
            assert np.max(np.abs(got - want)) <= 1e-12 * max(
                np.max(np.abs(want)), 1.0), (e, s)


@pytest.mark.parametrize("name", ["quad_hcurl", "hex_hcurl_hdiv",
                                  "tet_hcurl2_mixing", "quad_hdiv"])
def test_l2_projection_onto_vector_spaces(oriented, name):
    """The L2-projection right-hand side of component expressions and
    the projected initial state (the mass solve through W^T M W) equal
    JAX's within 1e-12."""
    pj, pt = oriented[name]
    exprs = dict(pt.phys_cfg.get("Initial conditions", {}) or {}) or {
        "u[x]": "sin(x + 2*y)", "u[y]": "x*y - 0.3", "p": "x"}
    bj = np.asarray(pj.assembler.l2_rhs(exprs))
    bt = pt.assembler.l2_rhs(exprs).numpy()
    assert np.max(np.abs(bt - bj)) <= 1e-12 * np.max(np.abs(bj))
    if name == "quad_hdiv":
        return
    uj = np.asarray(pj.initial_state())
    ut = pt.initial_state().numpy()
    assert np.max(np.abs(ut - uj)) <= 1e-12 * np.max(np.abs(uj))


def test_projection_of_a_field_in_the_space_is_exact():
    """A linear E lies in tet Nedelec of order 2: its projection through
    the mixing channel reproduces it (L2 < 1e-10), as in JAX."""
    from mrhyde_tpu_torch.problem import Problem
    cfg = _maxwell("tet", 1, order_e=2)
    lin = {"E[x]": "0.2 + 0.5*y - 0.3*z", "E[y]": "0.1 - 0.4*x",
           "E[z]": "0.3 + 0.2*x - 0.1*y"}
    cfg["Physics"]["Initial conditions"] = dict(lin)
    cfg["Postprocess"]["True solutions"] = dict(lin)
    p = Problem(cfg, device="cpu")
    errs = p.error_calc.compute(p.initial_state(), 0.0)
    assert errs[("L2", "E")] < 1e-10


# name -> (deck, extra true solutions); each norm's key is held
NORM_CASES = {
    "vector_l2_and_div": (lambda: cs.porous_mixed_deck(4), {}),
    "hcurl_2d_curl": (lambda: _maxwell("quad", 3),
                      {"curl(E)": "x - y*y"}),
    "hcurl_3d_true_curl": (lambda: _maxwell("hex", 2),
                           {"curl(E)[x]": "y", "curl(E)[y]": "0.5",
                            "curl(E)[z]": "x*z"}),
    "tet_mixing_curl": (lambda: _maxwell("tet", 1, order_e=2),
                        {"curl(E)[z]": "x"}),
    "face_norm_and_vectors": (lambda: cs.weak_galerkin_deck(4), {}),
    "hybrid_face_norm": (lambda: _faces("hex", "hybrid", 1),
                         {"lambda face": "x + y*z"}),
}


@pytest.mark.parametrize("case", sorted(NORM_CASES))
def test_error_norms_match_jax(case):
    """Every error norm of a seeded state (vector L2 over components,
    L2-div, the 2D curl, the 3D curl per component, L2-face over every
    side with weight 0.5/face measure, and the scalar L2 beside them)
    within 1e-12 of JAX's, with the same keys and report lines."""
    from mrhyde_tpu.postprocess.errors import ErrorCalculator as JaxEC
    from mrhyde_tpu_torch.postprocess.errors import ErrorCalculator
    build, extra = NORM_CASES[case]
    cfg = build()
    cfg["Postprocess"]["True solutions"].update(extra)
    pj, pt = both_problems(cfg)
    u = seeded(pj.n_dof, seed=21)
    ej = pj.error_calc.compute(np.asarray(u), 0.3)
    et = pt.error_calc.compute(torch.as_tensor(u), 0.3)
    assert set(et) == set(ej) and ej
    for k, v in ej.items():
        assert abs(et[k] - v) <= 1e-12 * abs(v), k
    hist = [(0.3, et)]
    assert ErrorCalculator.format_report(hist) == JaxEC.format_report(hist)
    kinds = {k for k, _ in et}
    want = {"vector_l2_and_div": {"L2", "L2-div"},
            "hcurl_2d_curl": {"L2", "L2-curl"},
            "hcurl_3d_true_curl": {"L2", "L2-curl"},
            "tet_mixing_curl": {"L2", "L2-curl"},
            "face_norm_and_vectors": {"L2", "L2-face"},
            "hybrid_face_norm": {"L2", "L2-face"}}[case]
    assert kinds == want


def _layout(p):
    d = p.disc
    return (list(p.variables), dict(d.offsets), d.n_dof,
            np.asarray(d.lids), np.asarray(d.dofmap.signs),
            sorted(d.basis_keys.items()))


def _same_layout(cfg):
    pj, pt = both_problems(copy.deepcopy(cfg))
    lj, lt = _layout(pj), _layout(pt)
    assert lt[0] == lj[0] and lt[1] == lj[1] and lt[2] == lj[2]
    np.testing.assert_array_equal(lt[3], lj[3])
    np.testing.assert_array_equal(lt[4], lj[4])
    assert lt[5] == lj[5]
    return pt


def test_active_variables_restrict():
    """'Active variables' restricts the modules' variables: weak
    Galerkin without its trace pbndry, u and t conforming HDIV (the
    multiscale fine decks' form), the same layout as JAX's; the facet
    terms drop out and the deck solves as JAX's does."""
    from torch_port_utils import solve_both
    cfg = cs.weak_galerkin_deck(3)
    cfg["Physics"]["Active variables"] = {"pint": "HVOL", "u": "HDIV",
                                          "t": "HDIV"}
    cfg["Physics"].pop("Dirichlet conditions")
    cfg["Postprocess"]["True solutions"].pop("pbndry face")
    pt = _same_layout(cfg)
    assert [v[0] for v in pt.variables] == ["pint", "u", "t"]
    assert pt.disc.basis_keys["u"] == ("HDIV", 1)
    solve_both(cfg)


def test_active_variables_override_a_space():
    """An 'Active variables' space override: a broken p1 (HGRAD-DG)
    pressure beside the RT velocity, HVOL forced to order 0 whatever the
    deck's order, and an HFACE trace of order 0; layouts as JAX's."""
    cfg = cs.porous_mixed_deck(3)
    cfg["Physics"]["Active variables"] = {"p": "HGRAD-DG", "u": "HDIV"}
    cfg["Discretization"]["order"]["p"] = 1
    pt = _same_layout(cfg)
    assert pt.disc.basis_keys["p"] == ("HGRAD-DG", 1)
    cfg = cs.porous_mixed_deck(3, hybrid=True)
    cfg["Discretization"]["order"].update({"p": 2, "lambda": 0})
    pt = _same_layout(cfg)
    assert pt.disc.basis_keys["p"] == ("HVOL", 0)
    assert pt.disc.basis_keys["lambda"] == ("HFACE", 0)


def test_extra_variables():
    """'Extra variables' (name -> space) append variables with their
    orders from the order sublist's own 'Extra variables': an HFACE
    trace of order 1 and an HGRAD field beside thermal's e; the same
    layout as JAX's, and the residual of the extra variables is zero."""
    from torch_port_utils import thermal_cfg
    cfg = thermal_cfg(3)
    cfg["Physics"]["Extra variables"] = {"lam": "HFACE", "aux": "HGRAD"}
    cfg["Discretization"]["order"]["Extra variables"] = {"lam": 1}
    pt = _same_layout(cfg)
    assert pt.variables[-2:] == [("lam", "HFACE", 1), ("aux", "HGRAD", 1)]
    from mrhyde_tpu_torch.assembly.assembler import TimeCoeffs
    r = pt.assembler.residual(torch.as_tensor(seeded(pt.n_dof, seed=1)),
                              TimeCoeffs.steady(pt.n_dof)).numpy()
    dm = pt.disc.dofmap
    assert np.abs(r[dm.all_dofs("e")]).max() > 0.1
    for v in ("lam", "aux"):
        assert np.abs(r[dm.all_dofs(v)]).max() == 0.0
