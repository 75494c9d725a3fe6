"""Readings that the limits in bench_port/limits/ are set from: for each
seed, the numbers the check compares for a sound run of the program, for
the precision control (the plain reference computed one precision below
the configuration's, in the program's place) and, with --faults, for
each fault the cell's traffic kind lists (its module's FAULTS). No window
is timed. One JSON line a seed and kind on standard output:

  python3 -m bench_port.calibrate --workload <cell> --seeds 1 2 3
      [--control] [--faults]
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from bench_port import cell as C
from bench_port import run as R


def readings(cell: C.Cell, control: bool, with_faults: bool):
  kind = R.kind_module(cell)
  yield "sound", kind.numbers(kind.run(cell))
  if control:
    yield "control", kind.control(cell)
  if with_faults:
    for name, fault in kind.FAULTS.items():
      yield name, kind.numbers(kind.run(cell, fault=fault))


def main(argv=None) -> int:
  p = argparse.ArgumentParser()
  p.add_argument("--workload", required=True)
  p.add_argument("--seeds", type=int, nargs="+", required=True)
  p.add_argument("--control", action="store_true")
  p.add_argument("--faults", action="store_true")
  args = p.parse_args(argv)
  if not torch.cuda.is_available():
    print("calibrate needs a CUDA card", file=sys.stderr)
    return 2
  R._env()
  R._build()
  bench = C.load_benchmark()
  for seed in args.seeds:
    ns = argparse.Namespace(workload=args.workload, seed=seed, seconds=0.0,
                            trace=0)
    cell = R.make_cell(ns, torch.device("cuda", 0), bench)
    for kind, nums in readings(cell, args.control, args.faults):
      print(json.dumps({"workload": args.workload, "seed": seed,
                        "reading": kind, **nums}), flush=True)
      torch.cuda.empty_cache()
  return 0


if __name__ == "__main__":
  sys.exit(main())
