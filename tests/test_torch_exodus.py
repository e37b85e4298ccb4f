"""Exodus II meshes in mrhyde_tpu_torch (`mesh/exodus.py`, deck key
`Mesh: source: Exodus`) against the JAX package on the CPU in f64: files
written by either package read back the same in both (blocks, sidesets,
nodesets, element variables); a hex thermal deck read from such a file
with point Dirichlet conditions on nodesets ('e_point_DBCs'); and the
CLI on a YAML deck naming its mesh file relative to the deck."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import yaml

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

from torch_port_utils import both_problems  # noqa: E402

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S3 = "sin(2*pi*x)*sin(2*pi*y)*sin(2*pi*z)"


def hex_mesh(n, blocks=1):
    """An n x n x n hex box (`blocks` element blocks along x, the
    elements grouped by block as an Exodus file holds them) with the
    nodes of its front (z = 0) and back (z = 1) faces as nodesets."""
    from mrhyde_tpu_torch.mesh.structured import box_mesh
    from mrhyde_tpu_torch.fem.topology import cell_topology
    mesh = box_mesh("hex", nx=n, ny=n, nz=n)
    sides = cell_topology("hex").sides
    for face in ("front", "back"):
        ss = mesh.sidesets[face]
        mesh.nodesets[f"{face}_nodes"] = np.unique(np.concatenate(
            [mesh.conn[e, list(sides[s])] for e, s in ss])).astype(np.int32)
    cents = mesh.nodes[mesh.conn].mean(axis=1)
    bids = np.minimum((cents[:, 0] * blocks).astype(int), blocks - 1)
    order = np.argsort(bids, kind="stable")
    pos = np.empty_like(order)
    pos[order] = np.arange(order.size)
    mesh.conn = mesh.conn[order]
    mesh.block_ids = bids[order].astype(np.int32)
    mesh.block_names = [f"eblock-{b}" for b in range(blocks)]
    mesh.sidesets = {k: np.stack([pos[v[:, 0]], v[:, 1]], axis=1)
                     .astype(np.int32) for k, v in mesh.sidesets.items()}
    return mesh


def _same_mesh(a, b):
    assert a.cell_type == b.cell_type and a.dim == b.dim
    assert np.array_equal(a.nodes, b.nodes)
    assert np.array_equal(a.conn, b.conn)
    assert np.array_equal(a.block_ids, b.block_ids)
    assert list(a.block_names) == list(b.block_names)
    assert list(a.sidesets) == list(b.sidesets)
    for k in a.sidesets:
        assert np.array_equal(a.sidesets[k], b.sidesets[k]), k
    assert list(a.nodesets) == list(b.nodesets)
    for k in a.nodesets:
        assert np.array_equal(a.nodesets[k], b.nodesets[k]), k


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("blocks", [1, 3])
def test_round_trip_across_the_packages(tmp_path, writer, blocks):
    """A file written by either package reads back the same through
    both readers. The port's writer keeps the blocks, sidesets and
    nodesets (a mesh whose elements are grouped by block comes back
    unchanged); the JAX package's writes one block, no sets."""
    from mrhyde_tpu.mesh.exodus import read_exodus as jax_read
    from mrhyde_tpu.mesh.exodus import write_exodus as jax_write
    from mrhyde_tpu_torch.mesh.exodus import read_exodus, write_exodus
    mesh = hex_mesh(3, blocks)
    rng = np.random.RandomState(blocks)
    k = rng.rand(2, mesh.n_elem)
    u = rng.rand(2, mesh.n_nodes)
    path = str(tmp_path / "mesh.exo")
    (write_exodus if writer == "port" else jax_write)(
        path, mesh, node_fields={"u": u}, cell_fields={"k": k},
        times=[0.0, 0.5])
    mt, it = read_exodus(path)
    mj, ij = jax_read(path)
    _same_mesh(mt, mj)
    assert it["n_steps"] == ij["n_steps"] == 2
    assert np.array_equal(it["elem_vars"]["k"], ij["elem_vars"]["k"])
    assert np.array_equal(it["elem_vars"]["k"], k[-1])
    if writer == "port":
        _same_mesh(mt, mesh)
    else:
        assert np.array_equal(mt.conn, mesh.conn)
        assert not mt.sidesets and not mt.nodesets


def exodus_deck(directory, n=4, point=True):
    """Thermal on an n^3 hex box read from `directory`/mesh.exo, true
    solution S3: Dirichlet 0 on the four x and y faces, and on the front
    and back faces through point Dirichlet conditions on their nodesets
    (point=True) or through the sidesets."""
    from mrhyde_tpu_torch.mesh.exodus import write_exodus
    write_exodus(os.path.join(directory, "mesh.exo"), hex_mesh(n))
    sides = ["left", "right", "bottom", "top"]
    if not point:
        sides += ["front", "back"]
    cfg = {
        "Mesh": {"dimension": 3, "element type": "hex", "source": "Exodus",
                 "mesh file": "mesh.exo"},
        "Functions": {"thermal source": f"12*(pi*pi)*{S3}"},
        "Physics": {"modules": "thermal",
                    "Dirichlet conditions": {
                        "scalar data": True,
                        "e": {s: 0.0 for s in sides}}},
        "Discretization": {"order": {"e": 1}, "quadrature": 2},
        "Solver": {"solver": "steady-state", "nonlinear TOL": 1e-10},
        "Postprocess": {"compute errors": True,
                        "True solutions": {"e": S3}},
        "_deck_dir": str(directory),
    }
    if point:
        cfg["Physics"]["e_point_DBCs"] = "front_nodes, back_nodes"
    return cfg


def test_point_dirichlet_on_nodesets_matches_jax(tmp_path):
    """e_point_DBCs on the front and back nodesets: the fixed dofs, the
    solution and L2(e) as JAX's to 1e-11, and the same solve as the deck
    that fixes those faces through their sidesets; the mesh from a file
    takes the general path in both packages."""
    pj, pt = both_problems(exodus_deck(tmp_path))
    assert np.array_equal(pt.bcs.fixed_dofs, pj.bcs.fixed_dofs)
    assert pt.assembler.fused_provider() is None
    rj, rt = pj.run(), pt.run()
    uj = np.asarray(rj.u)
    assert np.max(np.abs(rt.u.numpy() - uj)) <= 1e-11 * np.max(np.abs(uj))
    v = rj.errors[("L2", "e")]
    assert abs(rt.errors[("L2", "e")] - v) <= 1e-11 * v
    from mrhyde_tpu_torch.problem import Problem
    sides = Problem(exodus_deck(tmp_path, point=False), device="cpu")
    assert np.array_equal(sides.bcs.fixed_dofs, pt.bcs.fixed_dofs)
    assert abs(sides.run().errors[("L2", "e")] - v) <= 1e-11 * v


def test_cli_reads_the_mesh_file_relative_to_the_deck(tmp_path):
    """`python -m mrhyde_tpu_torch.driver deck.yaml --device cpu` from
    another directory finds `mesh file` beside the deck and prints the
    JAX CLI's L2 lines (`--cpu --fp64`)."""
    deckdir = tmp_path / "deck"
    deckdir.mkdir()
    cfg = exodus_deck(deckdir)
    del cfg["_deck_dir"]
    deck = deckdir / "input.yaml"
    deck.write_text(yaml.safe_dump(cfg))
    run = tmp_path / "run"
    run.mkdir()
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    env["OMP_NUM_THREADS"] = "1"

    def l2_lines(cmd):
        out = subprocess.run(cmd, capture_output=True, text=True, env=env,
                             cwd=run, timeout=600)
        assert out.returncode == 0, out.stderr
        return sorted(ln for ln in out.stdout.splitlines()
                      if "L2 norm of the error for" in ln)

    port = l2_lines([sys.executable, "-m", "mrhyde_tpu_torch.driver",
                     str(deck), "--device", "cpu"])
    ref = l2_lines([sys.executable, "-m", "mrhyde_tpu.driver", str(deck),
                    "--cpu", "--fp64"])
    assert len(port) == 1 and port == ref
