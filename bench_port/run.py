"""The port's benchmark: one run of one cell.

  python3 -m bench_port.run --workload <cell> --seed <n> --seconds <s>
      --trace <0|1>

from the root of a checkout. The cell's entry in BENCHMARK.json names its
configuration file and its traffic mix (bench_port/traffic/<mix>.json,
whose "kind" picks the loop in bench_port/drivers/); its limits are in
bench_port/limits/<cell>.json and each per-layer metric's reader in
bench_port/metrics/<metric>.py. The kind's module gives its rate, its
comparison, its faults and its precision control (drivers/__init__.py).
The run builds its scene and weights on
the card from the seed, warms up, measures for --seconds (--trace 0: the
cell's end-to-end metrics) or profiles a few steps or chunks (--trace 1:
its per-layer metrics), checks what the timed path produced against the
plain reference (bench_port/reference/), and prints the result as one
JSON line, last on standard output; the numbers compared, each beside
its limit, are the last lines on standard error. Without a CUDA card, or
with fewer cards than the cell asks for, it exits non-zero and prints no
result. Kernel builds and caches stay inside the checkout (build/).
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from bench_port import cell as C  # noqa: E402

GIB = 2.0 ** 30


def _env() -> None:
  """Kernel caches at fixed paths inside the checkout."""
  build = C.ROOT / "build"
  os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
  os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")


def parse(argv):
  p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
  p.add_argument("--workload", required=True)
  p.add_argument("--seed", type=int, required=True)
  p.add_argument("--seconds", type=float, required=True)
  p.add_argument("--trace", type=int, choices=(0, 1), default=0)
  return p.parse_args(argv)


def make_cell(args, device, bench, overrides=None) -> C.Cell:
  w = C.workload(bench, args.workload)
  config = json.loads(C.config_file(bench, w["config"]).read_text())
  traffic = json.loads(C.traffic_file(w["traffic"]).read_text())
  traffic.update((overrides or {}).get("traffic", {}))
  return C.Cell(name=w["name"], config=config, traffic=traffic,
                seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                device=device, t_start=T_START, overrides=overrides)


def kind_module(cell: C.Cell):
  """The module of the cell's traffic kind, bench_port/drivers/<kind>.py."""
  return importlib.import_module(f"bench_port.drivers.{cell.traffic['kind']}")


def drive(cell: C.Cell, fault=None):
  """Run the loop of the cell's traffic kind; returns what it measured."""
  return kind_module(cell).run(cell, fault=fault)


def numbers(cell: C.Cell, out) -> dict:
  return kind_module(cell).numbers(out)


def metric_module(name: str):
  """The per-layer metric's reader, bench_port/metrics/<name>.py: its
  `read(reading, work)` and its canned case `CANNED`."""
  spec = importlib.util.spec_from_file_location(
      f"bench_port_metric_{name.replace('.', '_')}", C.metric_file(name))
  mod = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(mod)
  return mod


def read_metric(name: str, reading, work):
  return metric_module(name).read(reading, work)


def _applies(metric, cell_name: str, bench) -> bool:
  if "workloads" in metric:
    return cell_name in metric["workloads"]
  e2e = {m["name"]: m for m in bench["end_to_end"]}[metric["moves"]]
  return "workloads" not in e2e or cell_name in e2e["workloads"]


def result(cell: C.Cell, out, bench, compared, correct, device_info):
  """The result line's object (without its "compared" key)."""
  metrics = {}
  if cell.trace:
    reading, work = out["trace"], out["work"]
    for m in bench["per_layer"]:
      if _applies(m, cell.name, bench):
        v = read_metric(m["name"], reading, work)
        if v is not None:
          metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device_info.update(busy_s=reading.busy_s(), window_s=reading.window_s)
  else:
    values = {
        kind_module(cell).RATE:
            out["units"] * out["rays_per_unit"] / out["wall_s"],
        "peak_mem_GiB": out["memory_peak_bytes"] / GIB,
        "setup_s": out["setup_s"]}
    for m in bench["end_to_end"]:
      if "workloads" in m and cell.name not in m["workloads"]:
        continue
      metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
  line = {"correct": bool(correct), "attempted": out["units"], "failed": 0,
          "metrics": metrics, "device": device_info,
          "setup_parts": out["setup_parts"],
          "reference_s": out["reference_s"]}
  if cell.trace:
    line["breakdown"] = {"device_ops": out["trace"].device_ops(),
                         "idle_gaps": out["trace"].idle_by_host}
  return line


def main(argv=None) -> int:
  args = parse(argv)
  _env()
  import torch
  bench = C.load_benchmark()
  w = C.workload(bench, args.workload)
  if not torch.cuda.is_available() or torch.cuda.device_count() < w["chips"]:
    print(f"{w['name']} needs {w['chips']} CUDA card(s); this machine has "
          f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
          file=sys.stderr)
    return 2
  torch.cuda.reset_peak_memory_stats()
  build_s = _build()
  cell = make_cell(args, torch.device("cuda", 0), bench)
  out = drive(cell)
  out["setup_parts"]["build_s"] = build_s
  from bench_port import check
  correct, compared = check.verdict(numbers(cell, out),
                                    check.load_limits(cell.name))
  device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                 "count": w["chips"],
                 "memory_peak_bytes": out["memory_peak_bytes"]}
  emit(result(cell, out, bench, compared, correct, device_info), compared)
  return 0


def emit(line, compared, out=None, err=None) -> None:
  """Print each number compared beside its limit as the last lines on
  standard error, and the result as one JSON line, its "compared" key
  last, as the last line on standard output (a number that is not finite
  is written as null)."""
  out, err = out or sys.stdout, err or sys.stderr
  finite = lambda v: v if isinstance(v, (int, float)) and v == v and \
      abs(v) != float("inf") else None
  compared = {k: {"value": finite(c["value"]), "limit": c["limit"]}
              for k, c in compared.items()}
  err.flush()
  for name, c in compared.items():
    print(f"{name} {c['value']!r} limit {c['limit']!r}", file=err)
  err.flush()
  print(json.dumps({**line, "compared": compared}), file=out)
  out.flush()


def _build() -> float:
  """Build the port's kernels before anything runs (a no-op once built in
  this checkout); returns the seconds it took, kept apart in the result."""
  from snerf_tpu_torch.ops import _cuda
  t = time.perf_counter()
  _cuda.build_all()
  return time.perf_counter() - t


if __name__ == "__main__":
  sys.exit(main())
