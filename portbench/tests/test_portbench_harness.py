"""CPU tests of the benchmark harness: discovery by name, the result line,
the traffic generator, the frozen work counts and the modules a run loads.
The card's own run is `test_cells_on_the_card` (marked cuda)."""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from portbench import harness  # noqa: E402

BENCH = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
CELLS = [w["name"] for w in BENCH["workloads"]]
# decks small enough for the CPU (the thermal one on the direct solve the
# port takes under 4,000 DOFs; test_the_multigrid_path_is_correct runs its
# timed path)
SMALL = {
    "thermal2d_uq.uq_steady_mg": {"Mesh": {"NX": 24, "NY": 24}},
    "ns_channel_p1.repeat_steady_direct": {"Mesh": {"NX": 20, "NY": 4}},
}
CONTRACT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _python(code, cwd):
    env = dict(os.environ, PYTHONPATH=cwd)
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=600)


def test_every_entry_finds_its_files():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    for name in names:
        assert callable(harness.load_module("metrics", name).read), name
    for c in BENCH["configs"]:
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        assert callable(harness.load_module("reference", c["name"]).judge)
        assert callable(harness.load_module("roofline", c["name"]).work)
    for name in CELLS:
        cell = harness.Cell(name)
        reported = {n for n, _ in cell.metrics(False)}
        assert "setup_s" in reported and len(reported) >= 2
        assert cell.metrics(True)


def test_a_new_cell_and_metric_are_files_only(tmp_path):
    """A cell, its traffic and a per-layer metric added as new files in a
    copy of the benchmark run without an edit of any file it had."""
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("tests", ".cache",
                                                  "__pycache__"))
    os.symlink(os.path.join(ROOT, "mrhyde_tpu_torch"),
               tmp_path / "mrhyde_tpu_torch")
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({
        "name": "thermal2d_uq.dummy", "config": "thermal2d_uq",
        "traffic": "dummy", "chips": 1, "why": "a test's cell"})
    bench["per_layer"].append({
        "name": "dummy_requests", "unit": "requests", "better": "higher",
        "source": "program_counter", "layer": "deck / problem (problem.py)",
        "moves": "solve_s", "workloads": ["thermal2d_uq.dummy"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    (tmp_path / "portbench" / "traffic" / "dummy.json").write_text(
        json.dumps({"deck": {"Mesh": {"NX": 8, "NY": 8}},
                    "check": {"requests": 1,
                              "limits": {"rel_residual": 1e-7}}}))
    (tmp_path / "portbench" / "metrics" / "dummy_requests.py").write_text(
        "def read(run):\n    return len(run.requests)\n")
    out = _python(
        "import json\n"
        "from portbench import harness\n"
        "r, _ = harness.run_cell('thermal2d_uq.dummy', 5, 0.3, 1,"
        " device='cpu')\n"
        "print(json.dumps(r))\n", str(tmp_path))
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] is True
    assert r["metrics"]["dummy_requests"]["value"] == r["attempted"] >= 1


@pytest.mark.parametrize("trace", [0, 1])
def test_result_line_has_the_contract_keys(trace):
    r, checks = harness.run_cell("ns_channel_p1.repeat_steady_direct",
                                 2 ** 31 + 77, 0.3, trace, device="cpu",
                                 deck_over=SMALL[
                                     "ns_channel_p1.repeat_steady_direct"])
    keys = list(r)
    # the driver's keys, then the numbers compared under a key that
    # comes last ("breakdown" only where a device trace was read)
    assert keys[:5] == CONTRACT_KEYS and keys[-1] == "checks"
    assert set(keys) <= set(CONTRACT_KEYS) | {"breakdown", "checks"}
    assert set(r["device"]) >= {"platform", "kind", "count",
                                "memory_peak_bytes"}
    cell = harness.Cell("ns_channel_p1.repeat_steady_direct")
    names = {n for n, _ in cell.metrics(trace)}
    assert set(r["metrics"]) <= names
    for m in r["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert r["correct"] is True
    assert [c[0] for c in checks] == list(r["checks"])
    json.dumps(r)


def test_the_command_refuses_without_a_card(tmp_path):
    """No CUDA device here: an exit code other than 0 and no result; the
    same in a directory that holds only BENCHMARK.json and portbench."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    cmd = [sys.executable, "portbench/run.py", "--workload", CELLS[0],
           "--seed", "1", "--seconds", "1", "--trace", "0"]
    out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench")
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    out = subprocess.run(cmd, cwd=tmp_path, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_samples_come_from_the_seed():
    """Plain Monte Carlo from the deck's own distributions: a ~ U[1, 2],
    b ~ N(0, 1); the same seed and stream give the same samples."""
    deck = harness.Cell("thermal2d_uq.uq_steady_mg").deck
    seed = 2 ** 31 + 12345

    def take(s, stream, n):
        gen = harness.samples(deck, s, stream)
        return [next(gen) for _ in range(n)]
    a = take(seed, 1, 4000)
    assert a[:16] == take(seed, 1, 16)
    assert a[:16] != take(seed + 1, 1, 16) and a[:16] != take(seed, 0, 16)
    sa = torch.tensor([s["a"] for s in a], dtype=torch.float64)
    sb = torch.tensor([s["b"] for s in a], dtype=torch.float64)
    assert 1.0 <= float(sa.min()) and float(sa.max()) <= 2.0
    assert abs(float(sa.mean()) - 1.5) < 0.02
    assert abs(float(sb.mean())) < 0.06 and abs(float(sb.var()) - 1) < 0.08
    assert float(sb.min()) < -2 and float(sb.max()) > 2
    nothing = harness.samples(
        harness.Cell("ns_channel_p1.repeat_steady_direct").deck, seed, 1)
    assert next(nothing) == {}


def test_frozen_work_counts():
    th = harness.Cell("thermal2d_uq.uq_steady_mg")
    ns = harness.Cell("ns_channel_p1.repeat_steady_direct")
    roof = {c: harness.load_module("roofline", c)
            for c in ("thermal2d_uq", "ns_channel_p1")}
    assert roof["thermal2d_uq"].work(th.deck) == (16810000, 33554432)
    assert roof["ns_channel_p1"].work(ns.deck) == (4842544, 14135741)


def test_forbidden_names_compare_whole_top_level_names():
    assert "mrhyde_tpu_torch" not in harness.forbidden_modules()
    sys.modules["mrhyde_tpu.fake_for_test"] = sys
    try:
        assert harness.forbidden_modules() == ["mrhyde_tpu"]
    finally:
        del sys.modules["mrhyde_tpu.fake_for_test"]


def test_a_run_loads_no_jax_and_the_reference_none_of_the_port():
    run = _python(
        "import sys\n"
        "from portbench import harness\n"
        "harness.run_cell('ns_channel_p1.repeat_steady_direct', 3, 0.2, 1,"
        " device='cpu', deck_over={'Mesh': {'NX': 8, 'NY': 2}})\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n", ROOT)
    assert run.returncode == 0, run.stderr[-3000:]
    tops = set(eval(run.stdout.strip().splitlines()[-1]))
    assert not tops & {"jax", "jaxlib", "flax", "mrhyde_tpu"}
    assert "mrhyde_tpu_torch" in tops
    ref = _python(
        "import sys\n"
        "import portbench.reference.thermal2d_uq, "
        "portbench.reference.ns_channel_p1\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n", ROOT)
    assert ref.returncode == 0, ref.stderr[-3000:]
    tops = set(eval(ref.stdout.strip().splitlines()[-1]))
    assert not tops & {"jax", "jaxlib", "flax", "mrhyde_tpu",
                       "mrhyde_tpu_torch"}


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cells_on_the_card(cell):
    """Each cell through the command on the card, briefly, traced."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed",
         "2147483999", "--seconds", "5", "--trace", "1"], cwd=ROOT,
        capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] is True and r["device"]["busy_s"] > 0
