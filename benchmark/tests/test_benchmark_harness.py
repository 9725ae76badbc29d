"""The harness on the CPU: every piece found by name, a new cell found
without an edit, the JAX check by whole top-level names, the trace
reader, the yardstick, and the result line of a whole (tiny) run."""

from __future__ import annotations

import ast
import hashlib
import json
import subprocess
import sys
from types import SimpleNamespace

import pytest
import torch

from benchmark.harness import core, specs, trace, yardstick

from .conftest import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("cell", specs.names("workloads"))
def test_every_cell_loads_by_name(cell):
    w = specs.workload(cell)
    c = specs.config(w["config"])
    driver = specs.traffic(w["traffic"])
    assert hasattr(driver, "Cell")
    assert set(w["end_to_end"]) <= {*driver.UNITS, "setup_s"}
    assert {"model", "render", "train", "precision", "port"} <= set(c)
    assert w["limits"] and w["chips"] in (1, 4)


@pytest.mark.parametrize("name", specs.names("metrics"))
def test_every_metric_loads_by_name(name):
    m = specs.metric(name)
    assert m.UNIT and m.LAYER and m.MOVES
    assert callable(m.read)


def test_benchmark_json_matches_the_files():
    cells = {w["name"]: w for w in BENCH["workloads"]}
    assert set(cells) <= set(specs.names("workloads"))
    for name, entry in cells.items():
        w = specs.workload(name)
        assert (entry["config"], entry["traffic"], entry["chips"]) == \
            (w["config"], w["traffic"], w["chips"])
        units = {**specs.traffic(w["traffic"]).UNITS, "setup_s": "s"}
        for m in BENCH["end_to_end"]:
            reported = m["name"] in w["end_to_end"]
            assert reported == (name in m.get("workloads", cells))
            if reported:
                assert units[m["name"]] == m["unit"]
    for c in BENCH["configs"]:
        spec = specs.config(c["name"])
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        assert (c["source"], c["reduced"]) == (spec["source"],
                                               spec["reduced"])
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        mod = specs.metric(m["name"])
        assert (m["unit"], m["layer"], m["moves"]) == \
            (mod.UNIT, mod.LAYER, mod.MOVES)
        for cell in m.get("workloads", cells):
            assert m["moves"] in specs.workload(cell)["end_to_end"]
    assert {m["name"] for m in BENCH["per_layer"]} <= set(
        specs.names("metrics"))
    assert {m["moves"] for m in BENCH["per_layer"]} <= e2e


def _tree_hashes(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_a_new_cell_and_metric_are_files_only(tmp_path):
    """A cell, a configuration and a metric added as files in a copy are
    found by name, and no file that was there changes."""
    from .conftest import tiny_copy

    bench = tiny_copy(tmp_path)
    before = _tree_hashes(bench)
    w = json.loads((bench / "workloads" / "freq-train.json").read_text())
    w.update(name="freq-train-long-window", config="nerf-freq-hard-copy")
    (bench / "workloads" / "freq-train-long-window.json").write_text(
        json.dumps(w))
    c = json.loads((bench / "configs" / "nerf-freq-hard.json").read_text())
    c["name"] = "nerf-freq-hard-copy"
    (bench / "configs" / "nerf-freq-hard-copy.json").write_text(
        json.dumps(c))
    (bench / "metrics" / "steps_profiled.train.py").write_text(
        'UNIT = "1"\nLAYER = "device"\nMOVES = "train_rays_per_s"\n'
        '\n\n'
        'def read(r):\n    return float(r.count)\n')
    code = (
        "import sys; sys.path.insert(0, sys.argv[1])\n"
        "from benchmark.harness import specs\n"
        "w = specs.workload('freq-train-long-window')\n"
        "c = specs.config(w['config'])\n"
        "ms = specs.metrics_for(w['end_to_end'])\n"
        "print(specs.traffic(w['traffic']).__name__, c['name'],\n"
        "      sorted(m.NAME for m in ms))\n")
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                         capture_output=True, text=True, check=True,
                         cwd=tmp_path).stdout
    assert "nerf-freq-hard-copy" in out and "steps_profiled.train" in out
    after = _tree_hashes(bench)
    assert {k: v for k, v in after.items() if k in before} == before


def test_forbidden_modules_compare_whole_top_level_names():
    assert core.forbidden_modules([
        "nerf_replication_tpu_torch", "nerf_replication_tpu_torch.ops",
        "jaxtyping", "flaxen", "numpy", "optaxx"]) == []
    assert core.forbidden_modules([
        "jax.numpy", "jaxlib", "flax.linen", "optax",
        "nerf_replication_tpu.models", "torch"]) == [
        "flax", "jax", "jaxlib", "nerf_replication_tpu", "optax"]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(
    p.relative_to(ROOT) for p in (ROOT / "benchmark").rglob("*.py")),
    ids=str)
def test_no_source_imports_jax_and_the_reference_none_of_the_port(path):
    tops = {m.split(".")[0] for m in _imports(ROOT / path)}
    assert not tops & set(core.FORBIDDEN)
    if path.parts[1] == "reference":
        assert "nerf_replication_tpu_torch" not in tops
        assert not any(m.startswith("benchmark.")
                       and not m.startswith("benchmark.reference")
                       for m in _imports(ROOT / path))


def _event(name, kind, start, end):
    return SimpleNamespace(name=lambda: name, activity_type=lambda: kind,
                           start_ns=lambda: start, end_ns=lambda: end)


def test_trace_reader_unions_intervals_and_labels_gaps():
    events = [
        _event(trace.WINDOW, "user_annotation", 0, 1000),
        _event(trace.WINDOW, "gpu_user_annotation", 0, 1000),
        _event("aten::sort", "cpu_op", 100, 400),
        _event("cudaLaunchKernel", "cuda_runtime", 150, 160),
        _event("aten::add", "cpu_op", 600, 650),
        _event("k1", "kernel", 200, 300),
        _event("k2", "kernel", 250, 350),      # overlaps k1
        _event("k1", "kernel", 700, 800),
        _event("Memcpy DtoH", "gpu_memcpy", 900, 950),
    ]
    r = trace.read_events(events, trace.Reading("c", {}, {}))
    assert r.window_s == pytest.approx(1e-6)
    assert r.busy_s == pytest.approx(300e-9)   # 200-350, 700-800, 900-950
    assert r.device_s_by_name["k1"] == pytest.approx(200e-9)
    assert r.device_s(["k2"]) == pytest.approx(100e-9)
    assert r.device_s(["absent"]) is None
    assert r.device_s_except(["k1", "k2"]) == pytest.approx(50e-9)
    # gaps: 0-200 (mid 100: aten::sort), 350-700 (mid 525: no op),
    # 800-900 (mid 850: none), 950-1000 (none)
    assert r.idle_by_host_op["aten::sort"] == pytest.approx(200e-9)
    assert r.idle_by_host_op["no host op"] == pytest.approx(500e-9)
    b = r.breakdown()
    assert b["device_ops"][0][0] == "k1"
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10


def test_trace_reader_without_activity_types():
    """Older PyTorch events carry only their device: a device event named
    as a host op is that op's annotation mirrored on the card."""
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU

    def ev(name, device, start, end):
        return SimpleNamespace(name=lambda: name, device_type=lambda: device,
                               start_ns=lambda: start, end_ns=lambda: end)

    events = [ev(trace.WINDOW, cpu, 0, 100), ev(trace.WINDOW, cuda, 0, 100),
              ev("Optimizer.step", cpu, 10, 90),
              ev("Optimizer.step", cuda, 10, 90), ev("k", cuda, 20, 30)]
    r = trace.read_events(events, trace.Reading("c", {}, {}))
    assert set(r.device_s_by_name) == {"k"}
    assert r.busy_s == pytest.approx(10e-9)


def test_yardstick_counts_the_models_work():
    freq = specs.config("nerf-freq-hard")
    ngp = specs.config("ngp-brick-hard")
    assert yardstick.mlp_flops(freq["model"]) == 1_186_816
    assert yardstick.mlp_flops(ngp["model"]) == 38_208
    assert yardstick.frame_flops(freq["model"], freq["render"],
                                 640_000) == pytest.approx(194.45e12, 1e-3)
    assert yardstick.train_step_flops(
        freq["model"], freq["render"], 1024) == pytest.approx(0.9334e12,
                                                              1e-3)
    b = yardstick.bound(3.35e9, 989e12, "bf16")
    assert b["bound_ms"] == pytest.approx(1000.0)
    assert b["bound_by"] == "operations"


@pytest.mark.parametrize("config", ["nerf-freq-hard", "ngp-brick-hard"])
def test_weight_shapes_are_the_ports(config, in_root):
    from benchmark.harness import port
    from nerf_replication_tpu_torch.models import make_network

    c = specs.config(config)
    net = make_network(port.cfg(c, torch.device("cpu"), seed=0))
    assert {k: tuple(v.shape) for k, v in net.state_dict().items()} == \
        yardstick.weight_shapes(c["model"])


def test_a_run_without_the_card_prints_no_result(in_root, capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    args = SimpleNamespace(workload="freq-train", seed=1, seconds=1, trace=0)
    assert core.run(args, 0.0) != 0
    assert capsys.readouterr().out == ""


def test_the_result_line(run_tiny):
    rc, result, err = run_tiny("ngp-train-tiny", seed=2 ** 31 + 77)
    assert rc == 0
    assert list(result)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= \
        set(result)
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= \
        set(result["device"])
    assert set(result["metrics"]) == {"train_rays_per_s", "setup_s"}
    assert all(set(v) == {"value", "unit"}
               for v in result["metrics"].values())
    limits = specs.workload("ngp-train")["limits"]
    assert list(result["checks"]) == list(limits)
    assert err.strip().splitlines()[-1].startswith(
        f"check {list(limits)[-1]}")
    assert result["correct"] is True


def test_the_traced_result_line(run_tiny):
    rc, result, _ = run_tiny("freq-dense-frame-tiny", trace=1)
    assert rc == 0
    assert {"busy_s", "window_s"} <= set(result["device"])
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
