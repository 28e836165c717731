"""The benchmark's harness on the CPU: files found by name, the contract's
shape of ``BENCHMARK.json``, the work arithmetic against hand counts, the
trace reductions, and the run's refusals (no card; modules of JAX or the
JAX package)."""
import json
import os
import re
import statistics
import subprocess
import sys
from pathlib import Path

import pytest
import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path[:0] = [str(ROOT / "src"), str(HERE)]

from yardstick import cells, harness, readers, tiny, work  # noqa: E402
from yardstick.trace import Trace  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_cell_files_found_by_name(tmp_path):
    """A configuration, a mix, limits and a per-layer metric added as new
    files are found by name, the added path before this benchmark's."""
    r = tiny.root(tmp_path)
    bench = json.loads((r / "BENCHMARK.json").read_text())
    bench["per_layer"].append({
        "name": "added_metric.train", "unit": "ms", "better": "lower",
        "source": "program_span", "layer": "model",
        "moves": "train_tokens_per_s", "workloads": ["tiny-a.train"]})
    (r / "BENCHMARK.json").write_text(json.dumps(bench))
    (r / "added" / "metrics").mkdir()
    (r / "added" / "metrics" / "added_metric.train.py").write_text(
        "def read(run):\n    return 1.5\n")
    c = cells.cell(r, "tiny-a.train")
    assert c.config["model"]["d_model"] == 64
    assert c.mix["driver"] == "train" and c.mix["seq"] == 64
    assert set(c.limits) >= {"grad_leaf_gap", "parity_bytes_wrong"}
    assert cells.driver(c).run
    names = [m["name"] for m in c.per_layer]
    assert "added_metric.train" in names
    assert cells.reader(c, "added_metric.train").read(None) == 1.5
    assert "added_metric.train" not in [
        m["name"] for m in cells.cell(r, "tiny-l.train").per_layer]


def _bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_benchmark_json_keeps_the_contract():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["command"] == ["python3", "perfbench/run.py"]
    assert 1 <= b["run_seconds"] <= 51
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    names = [x["name"] for x in b["configs"] + b["workloads"]
             + b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for c in b["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith("perfbench/")
    four = 0
    for w in b["workloads"]:
        cell = cells.cell(ROOT, w["name"])
        four += w["chips"] == 4
        reported = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2
        assert cell.per_layer, w["name"]
        for m in cell.per_layer:
            assert m["moves"] in reported, (w["name"], m["name"])
            assert cells.reader(cell, m["name"]).read
        assert cell.limits and cells.driver(cell).run
    assert four <= max(1, len(b["workloads"]) // 4)


def test_work_matches_hand_counts():
    # 4 queries on 4 keys, causal: 1 + 2 + 3 + 4 pairs
    assert work.causal_pairs(4, 4) == 10
    nbytes, ops = work.flash_work(1, 4, 4, 2, 1, 8, True, 2)
    assert nbytes == (2 * 4 * 2 * 8 + 2 * 4 * 1 * 8) * 2
    assert ops == 4 * 2 * 8 * 10
    # RS(3,2) update of 10 items of 2 pages of 256 bytes
    assert work.matmul_work(1, 2, 2, 10, 256) == (10 * 512 + 10 * 256 + 2,
                                                  2 * 10 * 256)
    s = dict(layer_kind="A", d_model=8, d_ff=16, num_layers=2, num_heads=2,
             num_kv_heads=1, head_dim=4, padded_vocab=256)
    per = 3 * 8 * 16 + 8 * 8 + 2 * 8 * 4 + 8 * 8
    assert work.matmul_params(s) == 2 * per + 8 * 256
    attn = 2 * 2 * 1 * 2 * (4 + 4) * work.causal_pairs(3, 3)
    assert work.attention_flops(s, 1, 3) == attn
    assert work.train_step_flops(s, 1, 3) == \
        6 * (2 * per + 8 * 256) * 3 + 3 * attn
    t, by = work.bound(3.35e12, 0)
    assert by == "bytes" and abs(t - 1.0) < 1e-12


def _trace():
    kernels = [("gemm", 0.0, 10.0), ("flash_attention_wgmma_kernel", 10.0,
                                     20.0),
               ("matmul_batched_kernel<1>", 30.0, 40.0),
               ("elementwise", 35.0, 45.0)]
    ann = {"step": [(0.0, 45.0)], "optimizer": [(28.0, 46.0)]}
    host = [("outer", 0.0, 50.0), ("aten::copy_", 24.0, 26.0)]
    return Trace(kernels, ann, host, window_s=50e-6, iters=1)


def test_trace_reductions():
    t = _trace()
    assert abs(t.busy_s() - 35e-6) < 1e-15
    assert abs(t.span_s("optimizer") - 15e-6) < 1e-15
    assert t.span_s("absent") is None
    assert t.kernel_s("matmul_batched_kernel") == (1, 10e-6)
    bd = t.breakdown()
    assert bd["device_ops"][0][1] == 10e-6
    assert bd["idle_gaps"][0] == ["aten::copy_", 10e-6]
    run = type("Run", (), {})()
    run.trace, run.window = t, (2, 100e-6)
    run.work = {"kernel1_per_iter": (3.35e12 * 5e-6, 0),
                "flash_call": (0, 989e12 * 2e-6), "step_flops": 989e12}
    assert abs(readers.roofline_per_iter(
        run, readers.KERNEL1_CUDA, "kernel1_per_iter") - 50.0) < 1e-9
    assert abs(readers.roofline_per_launch(
        run, readers.FLASH_CUDA, "flash_call", work.BF16_FLOPS_PER_S)
        - 20.0) < 1e-9
    # busy 35 us an iteration of a window's 50 us an iteration
    assert abs(readers.idle_pct(run) - 30.0) < 1e-9
    assert abs(readers.flops_share_pct(run, "step_flops") - 2e6) < 1e-3
    assert abs(readers.busy_less(run, "optimizer") - 20e-3) < 1e-12
    run.trace = None
    assert readers.span_ms(run, "step") is None
    assert readers.idle_pct(run) is None


def test_trace_leaves_out_ranges_that_are_no_device_work():
    """The profiler's step ranges and other annotations on the device
    timeline are neither kernels nor busy time; a span's annotation is
    kept as its range."""
    from types import SimpleNamespace as NS
    from torch.autograd import DeviceType

    def ev(name, s, e, dev=DeviceType.CUDA, note=False):
        return NS(name=name, device_type=dev, is_user_annotation=note,
                  time_range=NS(start=s, end=e))

    prof = NS(events=lambda: [
        ev("ProfilerStep#2", 0.0, 100.0), ev("outer", 0.0, 100.0,
                                             note=True),
        ev("optimizer", 50.0, 90.0, note=True), ev("gemm", 10.0, 30.0),
        ev("adam", 60.0, 80.0), ev("aten::mm", 5.0, 9.0, DeviceType.CPU)])
    t = Trace.from_profile(prof, ("optimizer",), 1e-4, 1)
    assert [k[0] for k in t.kernels] == ["gemm", "adam"]
    assert abs(t.busy_s() - 40e-6) < 1e-15
    assert abs(t.span_s("optimizer") - 20e-6) < 1e-15
    assert t.host == [("aten::mm", 5.0, 9.0)]


def test_foreign_modules_compare_whole_top_level_names():
    got = harness.foreign_modules(["repro_torch", "repro_torch.models",
                                   "repro", "repro.core", "jaxlib.xla",
                                   "jax_like", "flax", "reproduce"])
    assert got == ["flax", "jaxlib.xla", "repro", "repro.core"]


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


def test_run_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the run would start")
    p = subprocess.run([sys.executable, str(HERE / "run.py"), "--workload",
                        "mistral-7b.recover", "--seed", "1", "--seconds",
                        "1", "--trace", "0"], capture_output=True, text=True,
                       env=_env(), timeout=120, cwd=ROOT)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "no CUDA card" in p.stderr


def test_a_run_loads_no_jax_and_no_jax_package(tmp_path):
    """A whole tiny run in a fresh process (every yardstick module, both
    drivers, every metric reader) leaves no module of JAX, Flax or the
    JAX package loaded."""
    r = tiny.root(tmp_path)
    code = f"""
import sys, time, torch
sys.path[:0] = [{str(ROOT / 'src')!r}, {str(HERE)!r}]
import pkgutil, importlib, yardstick
for m in pkgutil.iter_modules(yardstick.__path__):
    importlib.import_module('yardstick.' + m.name)
from yardstick import harness
from pathlib import Path
for w, tr in (('tiny-a.train', 1), ('tiny-a.recover', 1)):
    line = harness.run_workload(Path({str(r)!r}), w, 3, 0.2, tr,
                                torch.device('cpu'), time.perf_counter())
    assert line['correct'], line['checks']
print('FOREIGN', harness.foreign_modules())
"""
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=_env(), timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    assert p.stdout.strip().splitlines()[-1] == "FOREIGN []"


def test_median_rule_of_leaf_gap():
    from yardstick import checks
    ref = {"a": 1.0, "b": 2.0, "c": 1e-9}
    prog = {"a": 1.1, "b": 2.0, "c": 2e-9}
    gap, at = checks.leaf_gap(prog, ref)
    assert at == "a" and abs(gap - 0.1 / statistics.median([1, 2, 1e-9])) \
        < 1e-12
    assert checks.moving({"a": 1.0, "b": 2.0, "c": 1e-9}) == ["a", "b"]
    ok, judged = checks.judge({"x": 1.0, "y": None}, {"x": 1.0, "y": 0})
    assert not ok and judged["x"] == {"value": 1.0, "limit": 1.0}
