"""Deck-level sharded execution in mrhyde_tpu_torch
(`parallel/deck_sharded.py`: `Solver: shards`, the CLI's --shards,
MRHYDE_SHARDS) on the CPU in f64: the decks of the JAX package's
tests/test_deck_sharded.py at 8 stacked shards (4 for the multiscale
deck's DOF scheme, whose 4x4 macro mesh holds no more) give the error
norms of the unsharded run, the JAX package's (whose own sharded runs
are `slow` and held to its unsharded ones) and the port's, to 1e-10
(1e-8 for the Navier-Stokes channel); the multiscale deck keeps its
golds under both schemes."""

import copy

import jax
import numpy as np
import pytest
import torch

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import chip_smoke as cs  # noqa: E402
from torch_port_utils import channel_cfg, thermal_cfg  # noqa: E402

torch.set_num_threads(1)


def _norms(result):
    out = {}
    for t, errs in result.error_history:
        for k, v in errs.items():
            out[(round(float(t), 10),) + k] = float(v)
    assert out, "deck produced no error norms"
    return out


def _with_shards(cfg, shards):
    cfg = copy.deepcopy(cfg)
    if shards:
        cfg.setdefault("Solver", {})["shards"] = shards
    return cfg


def _port(cfg, shards):
    from mrhyde_tpu_torch.problem import Problem
    p = Problem(_with_shards(cfg, shards), device="cpu")
    return p, p.run()


def _assert_norms(got, want, rtol):
    assert set(got) == set(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=rtol, abs=1e-14), \
            (k, got[k], want[k])


def _thermal():
    cfg = thermal_cfg(12)
    cfg["Solver"]["nonlinear TOL"] = 1e-12
    return cfg


def _transient():
    cfg = _thermal()
    cfg["Physics"]["Initial conditions"] = {"scalar data": True, "e": 0.0}
    cfg["Solver"] = {"solver": "transient",
                     "transient Butcher tableau": "DIRK-2,2",
                     "transient BDF order": 1, "final time": 0.05,
                     "number of steps": 3, "nonlinear TOL": 1e-12}
    cfg["Postprocess"]["True solutions"] = {
        "e": "(1.0-exp(-8.0*pi*pi*t))*sin(2*pi*x)*sin(2*pi*y)"}
    return cfg


def _ns():
    cfg = channel_cfg(16, 8, box=(2.0, 1.0),
                      solver={"nonlinear TOL": 1e-10})
    del cfg["Physics"]["Initial conditions"]
    cfg["Postprocess"]["True solutions"] = {"ux": "0.5*y*(1.0-y)",
                                            "uy": "0.0"}
    return cfg


def _per_block():
    """The JAX package's per-block physics deck (thermal on the left
    block, cdr on the right; tests/test_per_block_physics.py _cfg(16))."""
    from test_per_block_physics import _cfg
    return _cfg(16)


DECKS = {
    "thermal_12": (_thermal, 8, 1e-10),
    "thermal_dirk22_12": (_transient, 8, 1e-10),
    "ns_channel_16x8": (_ns, 8, 1e-8),
    "per_block_physics_16": (_per_block, 8, 1e-10),
}


@pytest.mark.parametrize("name", list(DECKS))
def test_sharded_deck_matches_unsharded_and_jax(name):
    """The deck's norms at every recorded time at 8 shards equal the
    port's unsharded run's and the JAX package's; the Newton solves ran
    through ShardedNewton, its Krylov counts the fixed ones."""
    from mrhyde_tpu.problem import Problem as JaxProblem
    build, shards, rtol = DECKS[name]
    p, res = _port(build(), shards)
    assert type(p._newton_fn()).__name__ == "ShardedNewton"
    assert res.counts["linear_iters"] > 0
    got = _norms(res)
    _assert_norms(got, _norms(_port(build(), 0)[1]), rtol)
    _assert_norms(got, _norms(JaxProblem(build()).run()), rtol)


def _field_cfg(boundary):
    cfg = _thermal()
    del cfg["Postprocess"]
    if not boundary:
        cfg["Functions"] = {"thermal source": "8*(pi*pi)*srcfield"}
        cfg["Parameters"] = {"srcfield": {
            "usage": "discretized", "basis": "HGRAD", "order": 1,
            "value": 1.0}}
        return cfg, "srcfield", (0.3, 1.7)
    cfg["Functions"] = {"thermal source": "1.0 + x*y"}
    cfg["Physics"]["Dirichlet conditions"] = {
        "scalar data": True, "e": {"left": 0.0, "bottom": 0.0}}
    cfg["Physics"]["Neumann conditions"] = {
        "e": {"right": "2.0*bflux", "top": "bflux*bflux - y"}}
    cfg["Parameters"] = {"bflux": {"usage": "discretized", "basis": "HGRAD",
                                   "order": 1, "value": 1.0}}
    return cfg, "bflux", (0.4, 1.6)


@pytest.mark.parametrize("boundary", [False, True],
                         ids=["volume", "boundary_group"])
def test_field_param_forward_sharded_matches(boundary):
    """A discretized field param in the forward solve at 8 shards, read at
    the volume qps or by an active boundary group's Neumann flux at side
    qps: the same solution vector as the unsharded run and the JAX
    package's, to 1e-10."""
    import jax.numpy as jnp
    from mrhyde_tpu.problem import Problem as JaxProblem
    from mrhyde_tpu_torch.problem import Problem
    cfg, name, (lo, hi) = _field_cfg(boundary)

    def solve(shards):
        p = Problem(_with_shards(cfg, shards), device="cpu")
        if boundary:
            assert p.assembler._active_bnd_groups()
        x = np.linspace(lo, hi, p.assembler.field_params[name]["n_dof"])
        return p.forward(pvec={name: torch.as_tensor(x)}).u.numpy(), x

    u8, x = solve(8)
    u0, _ = solve(0)
    uj = np.asarray(JaxProblem(copy.deepcopy(cfg)).forward(
        pvec={name: jnp.asarray(x)}).u)
    assert np.linalg.norm(u0) > 1e-3
    np.testing.assert_allclose(u8, u0, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(u8, uj, rtol=1e-10, atol=1e-12)


@pytest.fixture(scope="module")
def ms_unsharded():
    """(the port's unsharded norms, the JAX package's) of the multiscale
    gold deck (4x4 macro, DtN2 subgrids of refinements 2)."""
    from mrhyde_tpu.problem import Problem as JaxProblem
    return (_norms(_port(cs.ms_gold_deck(4), 0)[1]),
            _norms(JaxProblem(cs.ms_gold_deck(4)).run()))


@pytest.mark.parametrize("scheme,shards", [("dof", 4), ("replicated", 8)])
def test_multiscale_deck_sharded_matches_gold(ms_unsharded, scheme, shards):
    """The multiscale gold deck through both schemes: the DOF scheme at 4
    shards (macro DOFs sharded, the fine solves outside the sharded
    step) and the element-sharded one at 8 (`sharded scheme:
    replicated`): the unsharded norms to 1e-10, the JAX package's too,
    and the reference's golds L2-face 0.198706, Subgrid-L2 0.042848."""
    cfg = cs.ms_gold_deck(4)
    if scheme == "replicated":
        cfg["Solver"]["sharded scheme"] = "replicated"
    p, res = _port(cfg, shards)
    assert type(p._newton_fn()).__name__ == (
        "ShardedNewton" if scheme == "dof" else "ReplicatedShardedNewton")
    got = _norms(res)
    base, jax_norms = ms_unsharded
    _assert_norms(got, base, 1e-10)
    _assert_norms(got, jax_norms, 1e-10)
    assert got[(0.0, "L2-face", "e")] == pytest.approx(0.198706, rel=1e-3)
    assert got[(0.0, "Subgrid-L2", "e")] == pytest.approx(0.042848,
                                                         rel=1e-3)


def test_cli_shards_prints_the_unsharded_lines(tmp_path, capsys,
                                               monkeypatch):
    """`mrhyde_tpu_torch.driver deck.yaml --shards 4 --device cpu` prints
    the unsharded run's L2 lines, and so does MRHYDE_SHARDS=4 without the
    flag; a deck with shards asks for the card unless the CPU is asked
    for, and raises without one."""
    import yaml

    from mrhyde_tpu_torch.driver import main
    from mrhyde_tpu_torch.problem import Problem
    deck = tmp_path / "input.yaml"
    deck.write_text(yaml.safe_dump(_thermal()))

    def lines():
        return [ln for ln in capsys.readouterr().out.splitlines()
                if "norm of the error" in ln]
    assert main([str(deck), "--device", "cpu"]) == 0
    want = lines()
    assert want
    assert main([str(deck), "--shards", "4", "--device", "cpu"]) == 0
    assert lines() == want
    monkeypatch.setenv("MRHYDE_SHARDS", "4")
    p = Problem(_thermal(), device="cpu")
    assert p.shards == 4
    assert type(p._newton_fn()).__name__ == "ShardedNewton"
    assert main([str(deck), "--device", "cpu"]) == 0
    assert lines() == want
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            Problem(_with_shards(_thermal(), 4))


def test_pvec_and_counts_of_a_transient_sharded_deck():
    """The transient integrator takes the sharded drop-in (newton_fn):
    every stage's Newton solve counts the fixed Krylov iterations of the
    deck's `max linear iters`."""
    cfg = _transient()
    cfg["Solver"]["max linear iters"] = 50
    cfg["Solver"]["Belos solver"] = "CG"
    p, res = _port(cfg, 8)
    assert res.counts["stages"] == 6
    assert res.counts["linear_iters"] == 50 * res.counts["newton_iters"]
