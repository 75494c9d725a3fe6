"""A configuration, a traffic kind with its loop, limits and layer file,
and a per-layer metric are added to a copy of the benchmark as new files
and new entries in BENCHMARK.json alone, no file of the copy edited: the
copy's file, reader and result-line tests pass, and its run of the new
cell gives the new cell's line."""

import json
import shutil
import subprocess
import sys

from bench_port import cell as C

TOY = {"name": "toy", "source": "a toy configuration of the extension test",
       "flags": {"chunk": "8"}, "scene": {"height": 4, "width": 8},
       "assumed": {"nothing": "no model runs"}, "reduced": []}

PROBE_KIND = '''"""The "probe" traffic kind: a canned run on the CPU, its traced
window one device event that the probe layer names."""

import types

from bench_port import trace

RATE = "train_rays_per_s"
CONTROL_NEEDS_CARD = False


def off_by_one(answer):
  return answer + 1.0


FAULTS = {"off_by_one": off_by_one}


def run(cell, fault=None):
  answer = 2.0 if fault is None else fault(2.0)
  out = {"units": 4, "rays_per_unit": 256, "wall_s": 2.0,
         "memory_peak_bytes": 2 ** 30, "setup_s": 1.5,
         "setup_parts": {"probe_s": 1.0}, "reference_s": 0.25,
         "answers": (answer, 2.0)}
  if cell.trace:
    kernel = types.SimpleNamespace(
        name="probe_kernel", device=True, cpu_parent=None, kernels=[],
        time_range=types.SimpleNamespace(start=0.0, end=5e5))
    out["trace"] = trace.reduce_events(
        [kernel], window_s=1.0, units=4, layers=trace.load_layers(),
        is_device=lambda e: e.device, is_host=lambda e: not e.device)
    out["work"] = {}
  return out


def numbers(out):
  prog, ref = out["answers"]
  return {"probe_gap": abs(prog - ref)}


def control(cell):
  return {"probe_gap": 0.5}
'''

PROBE_METRIC = '''"""Device ms a probe unit under the probe layer."""

from bench_port import readers


def read(reading, work):
  return readers.ms_per_unit(reading, "probe")


CANNED = {
    "reading": {"kernels": [("probe_kernel", 0.0, 1.0)],
                "layer_s": {"probe": 0.5}, "window_s": 2.0, "units": 4,
                "idle_by_host": []},
    "work": {},
    "value": 125.0}
'''

LINES = r'''
import argparse, json, sys
import torch
from bench_port import cell as C, check, run as R
bench = C.load_benchmark()
for trace, fault in ((0, None), (1, None), (0, "off_by_one")):
  args = argparse.Namespace(workload="toy.probe", seed=2 ** 33 + 9,
                            seconds=1.0, trace=trace)
  cell = R.make_cell(args, torch.device("cpu"), bench)
  out = R.drive(cell, fault=R.kind_module(cell).FAULTS.get(fault))
  correct, compared = check.verdict(R.numbers(cell, out),
                                    check.load_limits(cell.name))
  device = {"platform": "gpu", "kind": "none", "count": 1,
            "memory_peak_bytes": out["memory_peak_bytes"]}
  R.emit(R.result(cell, out, bench, compared, correct, device), compared)
'''


def _files(root):
  return {p.relative_to(root): p.read_bytes() for p in root.rglob("*")
          if p.is_file() and "__pycache__" not in p.parts}


def _add(root, rel, text):
  path = root / rel
  assert not path.exists(), rel
  path.parent.mkdir(parents=True, exist_ok=True)
  path.write_text(text)


def _copy_with_probe(root):
  shutil.copytree(C.BENCH, root / "bench_port",
                  ignore=shutil.ignore_patterns("__pycache__"))
  shutil.copy(C.ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
  before = _files(root)
  _add(root, "bench_port/configs/toy.json", json.dumps(TOY, indent=2))
  _add(root, "bench_port/traffic/probe.json",
       json.dumps({"kind": "probe", "why": "a canned run"}))
  _add(root, "bench_port/drivers/probe.py", PROBE_KIND)
  _add(root, "bench_port/limits/toy.probe.json", json.dumps(
      {"limits": {"probe_gap": {"limit": 0.1, "lower": 0.0, "upper": 0.5,
                                "upper_from": "the control"}}}))
  _add(root, "bench_port/layers/probe.json", json.dumps(
      {"layers": {"probe": {"spans": ["bench.probe"],
                            "kernels": ["probe_kernel"]}}}))
  _add(root, "bench_port/metrics/probe_ms.train.py", PROBE_METRIC)
  bench = json.loads((root / "BENCHMARK.json").read_text())
  bench["configs"].append({k: TOY[k] for k in ("name", "source")} | {
      "file": "bench_port/configs/toy.json", "reduced": [],
      "why": "a configuration that runs no model"})
  bench["workloads"].append({"name": "toy.probe", "config": "toy",
                             "traffic": "probe", "chips": 1,
                             "why": "a canned probe run on the CPU"})
  rate = [m for m in bench["end_to_end"] if m["name"] == "train_rays_per_s"]
  rate[0]["workloads"].append("toy.probe")
  bench["per_layer"].append({
      "name": "probe_ms.train", "unit": "ms", "better": "lower",
      "source": "device_trace", "layer": "probe", "moves": "train_rays_per_s",
      "workloads": ["toy.probe"]})
  (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=2))
  after = _files(root)
  edited = [p for p in before if p.name != "BENCHMARK.json"
            and after[p] != before[p]]
  assert not edited and set(before) <= set(after)


def _python(root, *args):
  return subprocess.run([sys.executable, *args], cwd=root,
                        capture_output=True, text=True, timeout=600)


def test_a_new_cell_needs_only_new_files(tmp_path):
  root = tmp_path / "copy"
  _copy_with_probe(root)
  tests = [f"bench_port/tests/{t}.py" for t in
           ("test_benchmark_json", "test_readers", "test_result_line")]
  proc = _python(root, "-m", "pytest", "-q", "-p", "no:cacheprovider",
                 "-rA", *tests)
  assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-2000:]
  for case in ("test_cell_files_found_by_name[toy.probe]",
               "test_reader_on_canned_trace[probe_ms.train]",
               "test_line_keys_and_metrics[True-toy.probe]"):
    assert f"::{case}" in proc.stdout, case
  proc = _python(root, "-c", LINES)
  assert proc.returncode == 0, proc.stderr[-4000:]
  untraced, traced, faulty = [json.loads(line) for line in
                              proc.stdout.splitlines() if line.startswith("{")]
  assert untraced["correct"] and traced["correct"]
  assert untraced["metrics"]["train_rays_per_s"]["value"] == 4 * 256 / 2.0
  assert set(untraced["metrics"]) == {"train_rays_per_s", "peak_mem_GiB",
                                      "setup_s"}
  assert traced["metrics"] == {"probe_ms.train": {"value": 125.0,
                                                  "unit": "ms"}}
  assert untraced["compared"] == {"probe_gap": {"value": 0.0, "limit": 0.1}}
  assert not faulty["correct"]
  assert faulty["compared"]["probe_gap"]["value"] == 1.0
