"""Runs of every cell at small sizes on the CPU (the kernels' plain
versions), with the timed path broken underneath: a sound run compares
equal to the reference, and each fault the cell's traffic kind lists, and
its precision control, come out not correct under the cell's limits. A
cell's faults and control come from its kind's module; a control that
means something only on a card runs only there."""

import argparse

import pytest
import torch

from bench_port import cell as C
from bench_port import check
from bench_port import run as R
from bench_port.tests import small

BENCH = C.load_benchmark()
CELLS = {w["name"]: w for w in BENCH["workloads"]}


def _cell(name, seed=2 ** 33 + 5):
  w = CELLS[name]
  args = argparse.Namespace(workload=name, seed=seed, seconds=0.0, trace=0)
  return R.make_cell(args, torch.device("cpu"), BENCH,
                     small.overrides(w["config"], w["traffic"]))


KINDS = {name: R.kind_module(_cell(name)) for name in CELLS}


def _correct(name, fault=None):
  cell = _cell(name)
  numbers = R.numbers(cell, R.drive(cell, fault=fault))
  return check.verdict(numbers, check.load_limits(name))


@pytest.mark.parametrize("name", sorted(CELLS))
def test_sound_run_is_correct(name):
  ok, compared = _correct(name)
  assert ok, compared


FAULTS = [(n, f) for n in sorted(CELLS) for f in sorted(KINDS[n].FAULTS)]


@pytest.mark.parametrize("name,fault", FAULTS)
def test_fault_is_not_correct(name, fault):
  ok, compared = _correct(name, fault=KINDS[name].FAULTS[fault])
  assert not ok, compared


CONTROLS = [pytest.param(n, marks=pytest.mark.card)
            if KINDS[n].CONTROL_NEEDS_CARD else n for n in sorted(CELLS)]


@pytest.mark.parametrize("name", CONTROLS)
def test_precision_control_is_not_correct(name, request):
  cell = _cell(name)
  if KINDS[name].CONTROL_NEEDS_CARD:
    cell.device = request.getfixturevalue("card")
  ok, compared = check.verdict(KINDS[name].control(cell),
                               check.load_limits(name))
  assert not ok, compared
