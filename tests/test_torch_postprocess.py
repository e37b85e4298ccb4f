"""Postprocessing in mrhyde_tpu_torch (`postprocess/objectives.py`,
`fields.py`, `quantities.py`, `storage.py`, `writer.py`,
`utils/data_import.py`, `mesh/microstructure.py`) against the JAX package
on the CPU in f64: every objective type at a seeded state (the 4
virtual-rank integrated response, integrated control, sensors, discrete
control, volume and boundary regularizations of a discretized field),
sensor responses, their files and DFT; point location on structured
and Exodus meshes with JAX's two refusals; sensors from files and from
Exodus element variables; integrated quantities; the Exodus and VTK
writers (write, then read back); the solution storage's text round trip;
the Voronoi grains."""

import copy

import jax
import numpy as np
import pytest
import torch

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

from torch_port_utils import (SENSOR_PTS, a12_objectives,  # noqa: E402
                              a12_pvec, adjoint_cfg, seeded, thermal_cfg)

torch.set_num_threads(1)


def _both(cfg):
    from mrhyde_tpu.problem import Problem as JP
    from mrhyde_tpu_torch.problem import Problem
    return JP(copy.deepcopy(cfg)), Problem(cfg, device="cpu")


@pytest.fixture(scope="module")
def problems():
    pj, pt = _both(adjoint_cfg(5))
    u = seeded(pt.n_dof, seed=4)
    pvj, pvt = a12_pvec(pt, seed=6)
    return pj, pt, u, pvj, pvt


@pytest.mark.parametrize("name", ["resp", "ctrl", "sens", "datagen", "all"])
def test_objectives_match_jax(problems, name):
    """Each objective type alone and all together, at t = 0, against
    the JAX package's ObjectiveManager.value to 1e-12."""
    import jax.numpy as jnp
    from mrhyde_tpu.postprocess.objectives import (ObjectiveManager as JOM,
                                                   ObjectiveSpec as JOS)
    from mrhyde_tpu_torch.postprocess.objectives import (ObjectiveManager,
                                                         ObjectiveSpec)
    pj, pt, u, pvj, pvt = problems
    objs = a12_objectives()
    if name == "datagen":
        objs = {"misfit": {"type": "discrete control", "weight": 3.0}}
    elif name != "all":
        objs = {name: objs[name]}
    mj = JOM(pj.disc, pj.fm, [JOS.from_config(k, v) for k, v in objs.items()],
             pj.params)
    mt = ObjectiveManager(pt.disc, pt.fm,
                          [ObjectiveSpec.from_config(k, v)
                           for k, v in objs.items()], pt.params)
    mj.field_params = pj.assembler.field_params
    mt.field_params = pt.assembler.field_params
    d = seeded(pt.n_dof, seed=9)
    mj.datagen[0.0], mt.datagen[0.0] = jnp.asarray(d), torch.as_tensor(d)
    vj = float(mj.value(jnp.asarray(u), 0.0, pvj))
    vt = float(mt.value(torch.as_tensor(u), 0.0, pvt))
    assert vj != 0.0 and abs(vt - vj) <= 1e-12 * abs(vj)
    # a time with no sensor data and no stored state adds nothing there
    if name in ("sens", "datagen"):
        assert float(mt.value(torch.as_tensor(u), 0.5, pvt)) == \
            float(mj.value(jnp.asarray(u), 0.5, pvj)) == 0.0


def test_sensor_responses_files_and_dft(problems, tmp_path):
    import jax.numpy as jnp
    pj, pt, u, pvj, pvt = problems
    mj, mt = pj.objective_manager, pt.objective_manager
    hj, ht = [], []
    for k, t in enumerate((0.0, 0.1, 0.2)):
        uk = u * (1.0 + 0.5 * k)
        hj.append((t, mj.sensor_responses(jnp.asarray(uk), t, pvj)))
        ht.append((t, mt.sensor_responses(torch.as_tensor(uk), t, pvt)))
    np.testing.assert_allclose(ht[-1][1]["sens"].numpy(),
                               np.asarray(hj[-1][1]["sens"]), rtol=1e-13,
                               atol=1e-15)
    np.testing.assert_allclose(mt.sensor_dft(ht, "sens"),
                               mj.sensor_dft(hj, "sens"), rtol=1e-12,
                               atol=1e-14)
    for spec in mt.specs + mj.specs:
        spec.save_sensor_data = True
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    mj.save_sensor_files(hj, str(tmp_path / "j"))
    mt.save_sensor_files(ht, str(tmp_path / "t"))
    np.testing.assert_allclose(np.loadtxt(tmp_path / "t" / "sensor.sens.dat"),
                               np.loadtxt(tmp_path / "j" / "sensor.sens.dat"),
                               rtol=1e-13, atol=1e-15)


def test_point_location_and_its_refusals(tmp_path):
    """Structured quads, triangles and hex by index arithmetic, an
    Exodus mesh by Newton inversion; JAX's raises: a structured tet mesh
    and a u_dot leaf in a volume response."""
    from mrhyde_tpu.mesh.structured import box_mesh as jbox
    from mrhyde_tpu.postprocess.fields import locate_points as jloc
    from mrhyde_tpu_torch.mesh.exodus import read_exodus, write_exodus
    from mrhyde_tpu_torch.mesh.structured import box_mesh
    from mrhyde_tpu_torch.postprocess.fields import (GlobalFieldContext,
                                                     locate_points)
    rng = np.random.RandomState(2)
    pts2, pts3 = rng.rand(9, 2), rng.rand(9, 3)
    for cell, pts in (("quad", pts2), ("tri", pts2), ("hex", pts3)):
        e1, r1 = locate_points(box_mesh(cell, nx=3, ny=4, nz=2), pts)
        e2, r2 = jloc(jbox(cell, nx=3, ny=4, nz=2), pts)
        np.testing.assert_array_equal(e1, e2)
        np.testing.assert_allclose(r1, r2, rtol=0, atol=1e-14)
    write_exodus(str(tmp_path / "m.exo"), box_mesh("quad", nx=4, ny=3))
    mesh, _ = read_exodus(str(tmp_path / "m.exo"))
    e1, r1 = locate_points(mesh, pts2)
    e2, r2 = jloc(mesh, pts2)
    np.testing.assert_array_equal(e1, e2)
    np.testing.assert_allclose(r1, r2, rtol=0, atol=1e-12)
    assert np.all(np.abs(r1) <= 1.0 + 1e-12)
    for loc, bm in ((locate_points, box_mesh), (jloc, jbox)):
        with pytest.raises(NotImplementedError, match="tet"):
            loc(bm("tet", nx=2, ny=2, nz=2), pts3)
    from mrhyde_tpu_torch.problem import Problem
    p = Problem(thermal_cfg(3), device="cpu")
    u = torch.zeros(p.n_dof)
    ctx = GlobalFieldContext(p.disc, u, u_dot=u)
    with pytest.raises(NotImplementedError, match="u_dot"):
        ctx.resolve("e_t")
    assert float(GlobalFieldContext(p.disc, u).resolve("e_t").abs().max()) \
        == 0.0


def test_sensors_from_files_and_from_exodus(tmp_path):
    """'sensor points file' / 'sensor data file' (row 0 the times) and
    'sensor points file: mesh' (Exodus element variables numSensors,
    sensor_<j>_Loc_*, and the data field) give JAX's objective."""
    import jax.numpy as jnp
    from mrhyde_tpu_torch.mesh.exodus import write_exodus
    from mrhyde_tpu_torch.mesh.structured import box_mesh
    rng = np.random.RandomState(8)
    np.savetxt(tmp_path / "pts.dat", np.asarray(SENSOR_PTS))
    np.savetxt(tmp_path / "data.dat",
               np.vstack([[0.0, 1.0], rng.rand(4, 2)]))
    cfg = thermal_cfg(4)
    cfg["Postprocess"]["Objective functions"] = {"s": {
        "type": "sensors", "response": "e",
        "sensor points file": str(tmp_path / "pts.dat"),
        "sensor data file": str(tmp_path / "data.dat")}}
    mesh = box_mesh("quad", nx=4, ny=4)
    cents = mesh.nodes[mesh.conn].mean(axis=1)
    ns = (np.arange(mesh.n_elem) % 5 == 0).astype(float)
    write_exodus(str(tmp_path / "s.exo"), mesh, cell_fields={
        "numSensors": ns[None], "sensor_1_Loc_x": cents[None, :, 0] + 0.01,
        "sensor_1_Loc_y": cents[None, :, 1] - 0.02,
        "obs": rng.rand(1, mesh.n_elem)})
    cfg2 = thermal_cfg(4)
    cfg2["Mesh"] = {"dimension": 2, "element type": "quad",
                    "source": "Exodus", "mesh file": "s.exo"}
    cfg2["_deck_dir"] = str(tmp_path)
    cfg2["Postprocess"]["Objective functions"] = {"s": {
        "type": "sensors", "response": "e", "sensor points file": "mesh",
        "sensor data file": "obs"}}
    for c in (cfg, cfg2):
        pj, pt = _both(c)
        u = seeded(pt.n_dof, seed=1)
        vj = float(pj.objective_manager.value(jnp.asarray(u), 0.0))
        vt = float(pt.objective_manager.value(torch.as_tensor(u), 0.0))
        assert vj > 0 and abs(vt - vj) <= 1e-12 * vj
    from mrhyde_tpu.utils.data_import import (load_sensor_file as jl,
                                              mls_interpolate as jm,
                                              nearest_neighbor as jn)
    from mrhyde_tpu_torch.utils.data_import import (load_sensor_file,
                                                    mls_interpolate,
                                                    nearest_neighbor)
    for a, b in zip(load_sensor_file(str(tmp_path / "pts.dat"),
                                     str(tmp_path / "data.dat")),
                    jl(str(tmp_path / "pts.dat"), str(tmp_path / "data.dat"))):
        np.testing.assert_array_equal(a, b)
    cloud, q = rng.rand(30, 2), rng.rand(7, 2)
    np.testing.assert_array_equal(nearest_neighbor(cloud, q),
                                  jn(cloud, q))
    vals = rng.rand(30)
    np.testing.assert_array_equal(mls_interpolate(cloud, vals, q, order=2),
                                  jm(cloud, vals, q, order=2))


def test_integrated_quantities_and_weighted_norm():
    """thermal's test quantities (volume and boundary totals, the heat
    flux through every side) and a deck's boundary integrand on one
    sideset."""
    import jax.numpy as jnp
    from mrhyde_tpu.postprocess.quantities import weighted_norm as jwn
    from mrhyde_tpu_torch.postprocess.quantities import weighted_norm
    cfg = thermal_cfg(5)
    cfg["Physics"]["test integrated quantities"] = True
    cfg["Postprocess"].update({
        "compute integrated quantities": True,
        "Integrated quantities": {"top flux": {
            "integrand": "x*grad(e)[y]*n[y]", "location": "boundary",
            "boundary name": "top"}}})
    pj, pt = _both(cfg)
    u = seeded(pt.n_dof, seed=3)
    qj = pj.integrated_quantities.compute(jnp.asarray(u))
    qt = pt.integrated_quantities.compute(torch.as_tensor(u))
    assert sorted(qt) == sorted(qj) and len(qt) == 4
    for k in qj:
        assert abs(qt[k] - qj[k]) <= 1e-12 * max(1.0, abs(qj[k])), k
    rt = pt.run()
    assert sorted(rt.integrated) == sorted(qj)
    assert abs(weighted_norm(torch.as_tensor(u)) - jwn(jnp.asarray(u))) \
        <= 1e-12 * jwn(jnp.asarray(u))


def test_writer_exodus_and_vtk_round_trip(tmp_path, monkeypatch):
    """'write solution' with an extra cell field on a transient deck:
    both packages' files read back (the port's reader) to the same nodal
    and cell series, and the VTK snapshots have the same lines."""
    from mrhyde_tpu_torch.mesh.exodus import read_exodus
    from scipy.io import netcdf_file
    monkeypatch.chdir(tmp_path)
    cfg = thermal_cfg(4)
    cfg["Physics"]["Initial conditions"] = {"e": "0.0"}
    cfg["Solver"] = {"solver": "transient", "final time": 0.1,
                     "number of steps": 2}
    cfg["Postprocess"].update({"write solution": True,
                               "Extra cell fields": {"ee": "e*e + x"}})
    files = {}
    for tag in ("jax", "torch"):
        c = copy.deepcopy(cfg)
        c["Postprocess"]["output file"] = f"out_{tag}"
        pj, pt = _both(c)
        p = pj if tag == "jax" else pt
        p.run()
        files[tag] = p.solution_writer.write_vtk()
        assert len(p.solution_storage) == 3
    mj, ij = read_exodus("out_jax.exo")
    mt, it = read_exodus("out_torch.exo")
    np.testing.assert_array_equal(mt.nodes, mj.nodes)
    assert it["elem_vars"].keys() == ij["elem_vars"].keys() == {"ee"}
    np.testing.assert_allclose(it["elem_vars"]["ee"], ij["elem_vars"]["ee"],
                               rtol=1e-12, atol=1e-14)
    fj, ft = netcdf_file("out_jax.exo", mmap=False), \
        netcdf_file("out_torch.exo", mmap=False)
    for var in ("time_whole", "vals_nod_var1"):
        np.testing.assert_allclose(ft.variables[var].data,
                                   fj.variables[var].data, rtol=1e-12,
                                   atol=1e-14)
    assert ft.variables["vals_nod_var1"].data.shape[0] == 3
    fj.close()
    ft.close()
    # the same lines, numbers to round-off (a nodal value near zero is
    # 1e-16 in one package and 4e-16 in the other)
    lt = open(files["torch"]).read().split("\n")
    lj = open(files["jax"]).read().split("\n")
    assert len(lt) == len(lj)
    for a, b in zip(lt, lj):
        try:
            np.testing.assert_allclose(np.array(a.split(), dtype=float),
                                       np.array(b.split(), dtype=float),
                                       rtol=1e-9, atol=1e-12)
        except ValueError:
            assert a == b


def test_storage_text_round_trip_and_grains(tmp_path):
    from mrhyde_tpu.mesh.microstructure import generate_microstructure as jg
    from mrhyde_tpu.postprocess.storage import SolutionStorage as JS
    from mrhyde_tpu_torch.mesh.microstructure import generate_microstructure
    from mrhyde_tpu_torch.mesh.structured import box_mesh
    from mrhyde_tpu_torch.postprocess.storage import SolutionStorage
    s, sj = SolutionStorage(max_storage=3), JS(max_storage=3)
    for k in range(5):
        v = seeded(7, seed=k)
        s.store(torch.as_tensor(v), 0.1 * k)
        sj.store(v, 0.1 * k)
    assert s.times == sj.times and len(s) == 3
    assert s.extract(0.2 + 1e-12) is not None and s.extract(0.1) is None
    s.write_text(str(tmp_path / "t"))
    sj.write_text(str(tmp_path / "j"))
    for part in ("times", "data"):
        assert (tmp_path / f"t_{part}.dat").read_text() == \
            (tmp_path / f"j_{part}.dat").read_text()
    back = SolutionStorage.read_text(str(tmp_path / "t"))
    np.testing.assert_array_equal(back.extract_index(2).numpy(),
                                  sj.extract_index(2))
    for dim in (2, 3):
        mesh = box_mesh("quad" if dim == 2 else "hex", nx=5, ny=4, nz=3)
        a, b = generate_microstructure(mesh, 6, seed=11), jg(mesh, 6,
                                                                seed=11)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
