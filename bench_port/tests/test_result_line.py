"""The result line: its keys, the metrics of the cell's kind, and the
numbers compared last, beside their limits."""

import argparse
import io
import json

import pytest
import torch

from bench_port import cell as C
from bench_port import run as R
from bench_port import trace

BENCH = C.load_benchmark()


def _cell(name, traced):
  args = argparse.Namespace(workload=name, seed=2 ** 33 + 1, seconds=10.0,
                            trace=int(traced))
  return R.make_cell(args, torch.device("cpu"), BENCH)


def _canned_trace(name):
  """One traced window made of the canned readings of the cell's per-layer
  metrics, one after another on the clock, and the sum of their work."""
  kernels, layer_s, work, idle = [], {}, {}, []
  window_s, units = 0.0, 0
  for m in BENCH["per_layer"]:
    if not R._applies(m, name, BENCH):
      continue
    case = R.metric_module(m["name"]).CANNED
    r = case["reading"]
    kernels += [(k, s + window_s, e + window_s) for k, s, e in r["kernels"]]
    for key, v in r["layer_s"].items():
      layer_s[key] = layer_s.get(key, 0.0) + v
    for key, v in case["work"].items():
      work[key] = work.get(key, 0.0) + v
    idle += r["idle_by_host"]
    window_s += r["window_s"]
    units += r["units"]
  return trace.TraceReading(kernels=kernels, layer_s=layer_s,
                            window_s=window_s, units=units,
                            idle_by_host=idle[:10]), work


def _out(name, traced):
  out = {"units": 7, "rays_per_unit": 32768, "wall_s": 10.5,
         "memory_peak_bytes": 15 * 2 ** 30, "setup_s": 20.0,
         "setup_parts": {"scene_s": 1.0}, "reference_s": 4.0}
  if traced:
    out["trace"], out["work"] = _canned_trace(name)
  return out


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
@pytest.mark.parametrize("traced", [False, True])
def test_line_keys_and_metrics(name, traced):
  cell = _cell(name, traced)
  device = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
            "memory_peak_bytes": 15 * 2 ** 30}
  compared = {"loss_gap": {"value": 1e-6, "limit": 1e-4}}
  line = R.result(cell, _out(name, traced), BENCH, compared, True,
                  dict(device))
  stdout, stderr = io.StringIO(), io.StringIO()
  R.emit(line, compared, stdout, stderr)
  last = json.loads(stdout.getvalue().splitlines()[-1])
  assert {"correct", "attempted", "failed", "metrics", "device"} <= set(last)
  assert list(last)[-1] == "compared"
  assert last["compared"] == compared
  assert stderr.getvalue().splitlines()[-1] == "loss_gap 1e-06 limit 0.0001"
  want = set()
  section = "per_layer" if traced else "end_to_end"
  for m in BENCH[section]:
    cells = m.get("workloads")
    if cells is None and traced:
      e2e = {e["name"]: e for e in BENCH["end_to_end"]}[m["moves"]]
      cells = e2e.get("workloads")
    if cells is None or name in cells:
      want.add(m["name"])
  assert set(last["metrics"]) == want
  for v in last["metrics"].values():
    assert set(v) == {"value", "unit"} and v["value"] > 0
  if traced:
    assert last["device"]["busy_s"] > 0 and last["device"]["window_s"] > 0
    assert set(last["breakdown"]) == {"device_ops", "idle_gaps"}
    assert all(len(v) <= 10 for v in last["breakdown"].values())


def test_a_number_that_is_not_finite_is_null_and_fails():
  from bench_port import check
  ok, compared = check.verdict({"rgb_gap": float("nan")},
                               {"rgb_gap": {"limit": 1.0}})
  assert not ok
  stdout = io.StringIO()
  R.emit({"correct": ok}, compared, stdout, io.StringIO())
  assert json.loads(stdout.getvalue())["compared"]["rgb_gap"]["value"] is None


def test_the_limits_file_names_what_is_compared():
  from bench_port import check
  limits = {"rgb_gap": {"limit": 1e-3}, "rgb_mean_gap": {"limit": 1e-5}}
  ok, compared = check.verdict(
      {"rgb_gap": 1e-4, "rgb_mean_gap": 1e-6, "depth_gap": 9.0}, limits)
  assert ok and set(compared) == set(limits)
  ok, compared = check.verdict({"rgb_gap": 1e-4}, limits)
  assert not ok and compared["rgb_mean_gap"]["value"] != \
      compared["rgb_mean_gap"]["value"]


def test_render_numbers_take_the_widest_and_the_mean_ray_gap():
  from bench_port import check
  ref = [{"rgb": torch.zeros(4, 3), "distance": torch.ones(4, 1),
          "semantic": torch.zeros(4, 2)}]
  prog = [{"rgb": torch.zeros(4, 3), "distance": torch.ones(4, 1),
           "semantic": torch.zeros(4, 2)}]
  prog[0]["rgb"][1] = torch.tensor([0.0, 0.4, -0.2])
  prog[0]["distance"][2] = 1.5
  got = check.render_numbers(prog, ref, near=0.2)
  assert got["rgb_gap"] == pytest.approx(0.4)
  assert got["rgb_mean_gap"] == pytest.approx(0.1)
  assert got["depth_gap"] == pytest.approx(0.5)
  assert got["depth_mean_gap"] == pytest.approx(0.125)
  assert got["semantic_gap"] == 0 and got["semantic_mean_gap"] == 0
