"""The render kind's inputs: every run renders the traffic's one scene
(its rig and served weights), and the run's seed draws the views."""

import argparse
import json

import numpy as np
import pytest
import torch

from bench_port import cell as C
from bench_port import run as R
from bench_port import scene as S
from bench_port.drivers import render
from bench_port.tests import small

BENCH = C.load_benchmark()


def _cell(name, seed):
  w = {w["name"]: w for w in BENCH["workloads"]}[name]
  args = argparse.Namespace(workload=name, seed=seed, seconds=0.0, trace=0)
  return R.make_cell(args, torch.device("cpu"), BENCH,
                     small.overrides(w["config"], w["traffic"]))


CELLS = [w["name"] for w in BENCH["workloads"]
         if R.kind_module(_cell(w["name"], 1)) is render]


@pytest.mark.parametrize("name", CELLS)
def test_seeds_share_the_scene_and_draw_their_own_views(name):
  a, b = _cell(name, 2 ** 31 + 11), _cell(name, 7)
  assert render.scene_seed(a) == render.scene_seed(b)
  lay_a = S.layout(a.scene_spec, render.scene_seed(a))
  lay_b = S.layout(b.scene_spec, render.scene_seed(b))
  np.testing.assert_array_equal(lay_a.poses, lay_b.poses)
  served = []
  for cell in (a, b):
    zt, state = render._program(cell)
    with zt.eval_weights(state):
      served.append({n: p.detach().clone()
                     for n, p in state.model.named_parameters()})
  assert served[0].keys() == served[1].keys()
  for n in served[0]:
    assert torch.equal(served[0][n], served[1][n]), n
  views = [render.Frames(torch, c, lay_a, None).poses for c in (a, b)]
  assert not np.array_equal(views[0], views[1])


@pytest.mark.parametrize("small_sizes", [False, True])
def test_strips_cycle_over_every_frame_and_band_once(small_sizes):
  cell = _cell("zip_hash.render", 5)
  if not small_sizes:
    cell.overrides = None
    cell.traffic = json.loads(C.traffic_file("render").read_text())
  lay = S.layout(cell.scene_spec, render.scene_seed(cell))
  frames = render.Frames(torch, cell, lay, None)
  n, per = len(frames.poses), frames.per_frame
  cycle = [frames.where(g) for g in range(n * per)]
  assert sorted(cycle) == [(f, b) for f in range(n) for b in range(per)]
  assert [f for f, _ in cycle[:n]] == list(range(n))
  assert frames.where(n * per + 3) == cycle[3]
  # a window shorter than a frame sees bands from all over the image
  if not small_sizes:
    bands = [b for _, b in cycle[:7]]
    assert min(bands) < per // 4 and max(bands) >= 3 * per // 4
