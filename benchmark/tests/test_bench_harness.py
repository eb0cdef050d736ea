"""The benchmark's harness on the CPU: discovery by name, the contract of
``BENCHMARK.json``, the roofline counts, the trace summary, the result
line, the refusal without a card, a tiny run of each cell through the
test-only entry (``harness.run_cell`` with ``device="cpu"``), the faults
each cell's check must catch, and the control. The tiny runs compute in
float64, so a sound run reads round-off and every fault reads far above
the cell's limits.

One test, marked ``cuda``, runs each cell for a few seconds on the card;
it skips without one. On the card machine, from the repository's root:
``python -m pytest benchmark/tests -m cuda -q``.
"""

import copy
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from benchmark import harness
from benchmark.roofline import k1, k2

ROOT = Path(__file__).resolve().parents[2]
BENCH = harness.load_benchmark()
CELLS = [c["name"] for c in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TINY = (16, 8, 8)


# -- discovery and the contract ---------------------------------------------

@pytest.mark.parametrize("name", CELLS)
def test_cells_are_found_by_name(name):
    cell = harness.find_cell(BENCH, name)
    assert cell.config["name"] == cell.entry["config"]
    harness.driver_module(cell.traffic["driver"])
    check = harness.check_module(cell.traffic["check"]["kind"])
    for hook in ("install", "begin", "after_unit", "collect", "compare",
                 "control"):
        assert callable(getattr(check, hook))
    assert cell.traffic["check"]["limits"]
    reported = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in reported, (name, m["name"])


def test_every_metric_has_a_reader():
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        if m["name"] == "setup_s":
            continue          # the harness's own clock
        assert callable(harness.reader_module(m["name"]).read), m["name"]


def test_benchmark_json_keeps_the_contract():
    b = BENCH
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["benchmark"] and b["command"][1].startswith(
        "benchmark/")
    assert 1 <= b["run_seconds"] <= 51
    n_max = 24
    assert (2 + 14 * n_max) * (b["run_seconds"] + 60) + n_max * 180 \
        + 1200 <= 43200
    names = set()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file() and c["file"].startswith(
            "benchmark/")
        assert json.loads((ROOT / c["file"]).read_text())["name"] == \
            c["name"]
        for k in c["reduced"]:
            assert k in json.loads((ROOT / c["file"]).read_text())
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert {"name", "unit", "better", "source", "layer", "moves"} <= \
            set(m) <= {"name", "unit", "better", "source", "layer", "moves",
                       "workloads"}
    for x in (b["configs"] + b["workloads"] + b["end_to_end"]
              + b["per_layer"]):
        assert NAME.match(x["name"]) and x["name"] not in names
        names.add(x["name"])
    assert len(json.dumps(b)) < 64 * 1024


def test_roofline_counts_at_full_size():
    # PERF.md's bounds: K1 130.5 MB and 1.57 GFLOP, K2 103.5 MB and
    # 0.435 GFLOP at 256x64x64
    assert round(k1.bytes_moved(256, 64, 64) / 1e6, 1) == 130.5
    assert round(k1.flops(256, 64, 64) / 1e9, 2) == 1.57
    assert round(k2.bytes_moved(256, 64, 64) / 1e6, 1) == 103.5
    assert round(k2.flops(256, 64, 64) / 1e9, 3) == 0.435


def test_trace_summary_takes_the_union_and_the_gaps():
    events = [("a", 0.0, 1.0), ("b", 0.5, 1.5), ("c", 3.0, 4.0),
              ("a", 4.0, 4.5), ("d", 6.0, 6.25)]
    s = harness.summarize_trace(events, 10.0, "solve")
    assert s["busy_s"] == pytest.approx(3.25)
    assert s["idle_pct"] == pytest.approx(67.5)
    assert s["by_name"]["a"] == (1.5, 2)
    assert s["gaps"][0] == ("solve: before c", 1.5)
    assert s["gaps"][1] == ("solve: before d", 1.5)
    b = harness.breakdown(s)
    assert b["device_ops"][0] == ["a", 1.5] and len(b["idle_gaps"]) == 2


def test_refused_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", CELLS[0],
         "--seed", "2147483659", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA card" in out.stderr


# -- tiny runs on the CPU ---------------------------------------------------

def tiny_cell(name):
    """The cell with its work cut for a CPU test: float64, fewer steps,
    cycles and iterations, no warm-up."""
    cell = harness.find_cell(BENCH, name)
    cell.config = copy.deepcopy(cell.config)
    cell.traffic = copy.deepcopy(cell.traffic)
    cell.config.update(precision="float64", nCycles=min(
        cell.config["nCycles"], 2 if cell.config["useANKSolver"] else 25))
    if "adjointMaxIter" in cell.config:
        cell.config.update(adjointMaxIter=10, adjointSubspaceSize=10)
    cell.traffic["warmup_units"] = 0
    return cell


def tiny_run(name, seed=2147483659):
    cell = tiny_cell(name)
    return harness.run_cell(cell, seed, 0.0, False, time.perf_counter(),
                            device="cpu", mesh_dims=TINY)


@pytest.mark.parametrize("name", CELLS)
def test_tiny_run_is_correct_and_reports_the_last_line(name):
    result, compared = tiny_run(name)
    assert list(result)[:5] == ["correct", "attempted", "failed",
                                "metrics", "device"]
    assert list(result)[-1] == "checks"
    assert result["correct"] and result["failed"] == 0
    assert result["attempted"] == 1
    cell = harness.find_cell(BENCH, name)
    assert set(result["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert set(result["device"]) >= {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    assert [c[0] for c in compared] == list(result["checks"])
    json.dumps(result)


def _unchanged_ank_step(monkeypatch):
    from adflow_torch.solvers import newton
    orig = newton.make_ank_step

    def make(fns, opts, segregated=False, approx=False):
        step = orig(fns, opts, segregated=segregated, approx=approx)
        return lambda w, cfl, pc: step(w, cfl, pc)._replace(w=w)
    monkeypatch.setattr(newton, "make_ank_step", make)


def _unchanged_rk_cycle(monkeypatch):
    from adflow_torch.solvers import steady
    orig = steady.rk_iteration

    def cycle(w_list, *args, **kw):
        return w_list, orig(w_list, *args, **kw)[1]
    monkeypatch.setattr(steady, "rk_iteration", cycle)


def _half_the_cells(monkeypatch):
    """Every residual with its second half of i-planes left out."""
    from adflow_torch.physics import residual
    orig = residual.block_residual

    def half(w, *args, **kw):
        r = orig(w, *args, **kw)
        return torch.cat([r[:r.shape[0] // 2],
                          torch.zeros_like(r[r.shape[0] // 2:])])
    for mod in ("adflow_torch.physics.residual",
                "adflow_torch.solvers.smoothers"):
        monkeypatch.setattr(sys.modules[mod], "block_residual", half)


def _sa_rows(monkeypatch, scale):
    """Every residual with its SA rows times ``scale``."""
    from adflow_torch.physics import residual
    orig = residual.block_residual

    def scaled(w, *args, **kw):
        r = orig(w, *args, **kw)
        return torch.cat([r[..., :5], scale * r[..., 5:]], dim=-1)
    for mod in ("adflow_torch.physics.residual",
                "adflow_torch.solvers.smoothers"):
        monkeypatch.setattr(sys.modules[mod], "block_residual", scaled)


def _sa_rows_left_out(monkeypatch):
    _sa_rows(monkeypatch, 0.0)


def _sa_rows_doubled(monkeypatch):
    _sa_rows(monkeypatch, 2.0)


def _altered_cl(monkeypatch):
    from adflow_torch.api.solver import ADFLOW
    orig = ADFLOW.evalFunctions

    def funcs(self, ap, out, *args, **kw):
        out = orig(self, ap, out, *args, **kw)
        out[f"{ap.name}_cl"] += 1e-2
        return out
    monkeypatch.setattr(ADFLOW, "evalFunctions", funcs)


def _adjoint_left_at_zero(monkeypatch):
    """The adjoint solve returns its starting psi, reporting its GMRES
    residual as before."""
    from adflow_torch.adjoint import api
    orig = api.solve_adjoint_system

    def solve(*args, **kw):
        sol = orig(*args, **kw)
        return sol._replace(x=torch.zeros_like(sol.x))
    monkeypatch.setattr(api, "solve_adjoint_system", solve)


def _altered_total(monkeypatch):
    from adflow_torch.api.solver import ADFLOW
    orig = ADFLOW.evalFunctionsSens

    def sens(self, ap, out, *args, **kw):
        out = orig(self, ap, out, *args, **kw)
        for v in out.values():
            v["alpha"] *= 1.1
        return out
    monkeypatch.setattr(ADFLOW, "evalFunctionsSens", sens)


FAULTS = [("m6_euler.ank", _unchanged_ank_step),
          ("m6_euler.ank", _half_the_cells),
          ("m6_euler.ank", _altered_cl),
          ("m6_rans_sa.rk", _unchanged_rk_cycle),
          ("m6_rans_sa.rk", _half_the_cells),
          ("m6_rans_sa.rk", _sa_rows_left_out),
          ("m6_rans_sa.rk", _sa_rows_doubled),
          ("m6_rans_sa.rk", _altered_cl),
          ("m6_euler.adjoint", _adjoint_left_at_zero),
          ("m6_euler.adjoint", _half_the_cells),
          ("m6_euler.adjoint", _altered_total)]


@pytest.mark.parametrize("name,fault", FAULTS,
                         ids=[f"{n}-{f.__name__[1:]}" for n, f in FAULTS])
def test_a_fault_in_the_timed_path_is_not_correct(monkeypatch, name, fault):
    fault(monkeypatch)
    result, compared = tiny_run(name, seed=31)
    assert not result["correct"], compared


@pytest.mark.parametrize("name", CELLS)
def test_the_bfloat16_control_is_not_correct(name):
    cell = tiny_cell(name)
    result, _ = harness.run_cell(cell, 7, 0.0, False, time.perf_counter(),
                                 device="cpu", mesh_dims=TINY,
                                 controls=("bfloat16",))
    limits = cell.traffic["check"]["limits"]
    readings = result["controls"]["bfloat16"]
    assert any(readings[k] > limits[k] for k in limits), readings


# -- the card ---------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_each_cell_runs_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the benchmark never runs on the CPU")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", name, "--seed",
         "2147483659", "--seconds", "3", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
