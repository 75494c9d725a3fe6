"""Readings that the limits in bench_port/limits/ are set from: for each
seed, the numbers the check compares for a sound run of the program, for
the precision control (the plain reference computed one precision below
the configuration's, in the program's place) and, with --faults, for
each planted fault (bench_port/faults.py). No window is timed. One JSON
line a seed and kind on standard output:

  python3 -m bench_port.calibrate --workload <cell> --seeds 1 2 3
      [--control] [--faults]
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from bench_port import cell as C
from bench_port import check, faults
from bench_port import run as R


def readings(cell: C.Cell, control: bool, with_faults: bool):
  out = R.drive(cell)
  kind = cell.traffic["kind"]
  sound = R.numbers(cell, out)
  if kind == "train":
    ref = out["answers"][1]
    sound["leaves_left_out"] = len(ref["change"]) - len(
        check.moved_leaves(ref))
  yield "sound", sound
  if control and kind == "train":
    from bench_port.drivers import train
    ref = out["answers"][1]
    del out
    lay_scene = _train_inputs(cell)
    ctrl = train.reference_readings(cell, *lay_scene,
                                    cell.traffic["check_steps"], control=True)
    yield "control", check.train_numbers(ctrl, ref)
  elif control:
    from bench_port.drivers import render
    from bench_port import scene as S
    _, ref, near = out["answers"]
    del out
    lay = S.layout(cell.scene_spec, cell.seed)
    chunk = int(cell.flags["chunk"])
    keys = sorted(render._samples(cell, cell.traffic["strip_rows"]
                                  * lay.hw[1] // chunk).items())
    keys = [(g, c) for g, cs in keys for c in cs]
    ctrl = render.reference_chunks(cell, lay, keys, chunk, control=True)
    yield "control", check.render_numbers(ctrl, ref, near)
  if with_faults:
    table = faults.TRAIN if kind == "train" else faults.RENDER
    for name, fault in table.items():
      yield name, R.numbers(cell, R.drive(cell, fault=fault))


def _train_inputs(cell):
  from bench_port import scene as S
  lay = S.layout(cell.scene_spec, cell.seed)
  scene = S.device_scene(cell.scene_spec, lay, cell.seed, cell.device)
  return scene, lay


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
