"""Runs of every cell at small sizes on the CPU (the kernels' plain
versions), with the timed path broken underneath: a sound run compares
equal to the reference, and each fault the cell can have, and the
training cells' precision control, come out not correct under the cell's
limits."""

import argparse

import pytest
import torch

from bench_port import cell as C
from bench_port import check, faults
from bench_port import run as R
from bench_port.tests import small

BENCH = C.load_benchmark()
CELLS = {w["name"]: w for w in BENCH["workloads"]}


def _cell(name, seed=2 ** 33 + 5):
  w = CELLS[name]
  args = argparse.Namespace(workload=name, seed=seed, seconds=0.0, trace=0)
  return R.make_cell(args, torch.device("cpu"), BENCH,
                     small.overrides(w["config"], w["traffic"]))


def _correct(name, fault=None):
  cell = _cell(name)
  numbers = R.numbers(cell, R.drive(cell, fault=fault))
  return check.verdict(numbers, check.load_limits(name))


@pytest.mark.parametrize("name", sorted(CELLS))
def test_sound_run_is_correct(name):
  ok, compared = _correct(name)
  assert ok, compared


FAULTS = [(n, f) for n in sorted(CELLS) for f in sorted(
    faults.TRAIN if CELLS[n]["traffic"] == "train" else faults.RENDER)]


@pytest.mark.parametrize("name,fault", FAULTS)
def test_fault_is_not_correct(name, fault):
  table = faults.TRAIN if CELLS[name]["traffic"] == "train" else faults.RENDER
  ok, compared = _correct(name, fault=table[fault])
  assert not ok, compared


@pytest.mark.parametrize("name", sorted(n for n, w in CELLS.items()
                                        if w["traffic"] == "train"))
def test_precision_control_is_not_correct(name):
  from bench_port import scene as S
  from bench_port.drivers import train
  cell = _cell(name)
  lay = S.layout(cell.scene_spec, cell.seed)
  scene = S.device_scene(cell.scene_spec, lay, cell.seed, cell.device)
  steps = cell.traffic["check_steps"]
  ref = train.reference_readings(cell, scene, lay, steps)
  ctrl = train.reference_readings(cell, scene, lay, steps, control=True)
  ok, compared = check.verdict(check.train_numbers(ctrl, ref),
                               check.load_limits(name))
  assert not ok, compared


@pytest.mark.card
@pytest.mark.parametrize("name", sorted(n for n, w in CELLS.items()
                                        if w["traffic"] == "render"))
def test_render_precision_control_is_not_correct(name, card):
  from bench_port import scene as S
  from bench_port.drivers import render
  cell = _cell(name)
  cell.device = card
  lay = S.layout(cell.scene_spec, cell.seed)
  chunk = int(cell.flags["chunk"])
  per_strip = cell.traffic["strip_rows"] * lay.hw[1] // chunk
  keys = [(g, c) for g, cs in sorted(render._samples(cell, per_strip).items())
          for c in cs]
  ref = render.reference_chunks(cell, lay, keys, chunk)
  ctrl = render.reference_chunks(cell, lay, keys, chunk, control=True)
  ok, compared = check.verdict(check.render_numbers(ctrl, ref, lay.near),
                               check.load_limits(name))
  assert not ok, compared
