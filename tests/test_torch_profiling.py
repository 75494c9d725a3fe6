"""The port's tracing (snerf_tpu_torch/utils/profiling.py): the spans a zip
train step, a mip train step and a render chunk record under
torch.profiler and how they nest, the no-op they are without a profiler,
and the counts of units and host syncs read from a finished trace. Torch
only (no JAX), so the file runs on the card too:

  python3 -m pytest --noconftest tests/test_torch_profiling.py -q

where the `card` case counts a real synchronizing CUDA operation.
"""

import contextlib
import os
import types

import numpy as np
import pytest
import torch

from snerf_tpu_torch.config import (load_config, model_config, train_config,
                                    zip_model_config, zip_train_config)
from snerf_tpu_torch.data import sampler, synthetic
from snerf_tpu_torch.models import mipnerf, mlp
from snerf_tpu_torch.train import trainer as mt
from snerf_tpu_torch.train import zip_trainer as zt
from snerf_tpu_torch.train.renderer import make_zip_eval_render_fn
from snerf_tpu_torch.utils import profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# configs/waymo_zipnerf_tpu (cp_hash: the CP encode, a fine hash level, K1
# trunks, EMA) at narrow widths and a small batch
NARROW = ["--zip_cp_num_levels", "2", "--zip_cp_level_dim", "4",
          "--zip_cp_base_resolution", "16", "--zip_cp_max_resolution", "32",
          "--zip_cp_hash_resolution", "64", "--zip_cp_hash_log2", "10",
          "--zip_ipe_density_width", "16", "--zip_density_hidden_width",
          "16", "--zip_ipe_max_deg", "4", "--zip_bottleneck_width", "32",
          "--zip_batch_size", "64", "--zip_num_prop_samples", "(4, 4)",
          "--zip_num_nerf_samples", "4", "--zip_patch_size", "4"]
MARKED = ("snerf.", "Optimizer.step#")
# each span and the innermost marked span around it
STEP_TREE = {
    ("snerf.train.step", None),
    ("snerf.train.draw", "snerf.train.step"),
    ("snerf.level.sample", "snerf.train.step"),
    ("snerf.level.mlp", "snerf.train.step"),
    ("snerf.encode.cp", "snerf.level.mlp"),
    ("snerf.encode.cp.plain", "snerf.encode.cp"),
    ("snerf.encode.hash", "snerf.level.mlp"),
    ("snerf.k1", "snerf.level.mlp"),
    ("snerf.mlp.dense", "snerf.level.mlp"),
    ("snerf.level.composite", "snerf.train.step"),
    ("snerf.train.losses", "snerf.train.step"),
    ("snerf.train.backward", "snerf.train.step"),
    ("snerf.train.clip", "snerf.train.step"),
    ("Optimizer.step#Adam.step", "snerf.train.step"),
    ("snerf.train.ema", "snerf.train.step"),
}
# configs/nuScenes_depth_6cams (the mip model: warp, depth confidence with
# its four modes, pose refinement) at narrow widths and a small batch
MIP_NARROW = ["--N_rgb", "32", "--N_samples", "8", "--N_fine", "8",
              "--hidden_layer", "16", "--proposal_hidden_layer", "16"]
# the mip step's spans: the pose table inside the draw, the confidence
# inside the losses, each level's encode beside its sampling; three Adams
# (the model's, the pose table's, the lambdas'), no EMA
MIP_STEP_TREE = {
    ("snerf.train.step", None),
    ("snerf.train.draw", "snerf.train.step"),
    ("snerf.train.pose", "snerf.train.draw"),
    ("snerf.level.sample", "snerf.train.step"),
    ("snerf.encode.ipe", "snerf.train.step"),
    ("snerf.level.mlp", "snerf.train.step"),
    ("snerf.k1", "snerf.level.mlp"),
    ("snerf.mlp.dense", "snerf.level.mlp"),
    ("snerf.level.composite", "snerf.train.step"),
    ("snerf.train.losses", "snerf.train.step"),
    ("snerf.train.conf", "snerf.train.losses"),
    ("snerf.train.backward", "snerf.train.step"),
    ("snerf.train.clip", "snerf.train.step"),
    ("Optimizer.step#Adam.step", "snerf.train.step"),
}
# the trunk checkpoint's recompute runs the trunk again in the backward:
# under the backward's span on the CPU, on autograd's own thread on the
# card
RECOMPUTE = {(name, parent) for name in ("snerf.k1", "snerf.mlp.dense")
             for parent in ("snerf.train.backward", None)}


@pytest.fixture(scope="module")
def tiny():
  """(state, step, generator, render_fn, rays) of a tiny cp_hash model."""
  torch.manual_seed(0)
  cfg = load_config(["--config", os.path.join(REPO, "configs",
                                              "waymo_zipnerf_tpu"), *NARROW])
  mcfg, tcfg = zip_model_config(cfg), zip_train_config(cfg)
  assert tcfg.ema_decay > 0 and mcfg.encoder_type == "cp_hash"
  scene = synthetic.make_synthetic_scene(num_images=4, H=16, W=20,
                                         datahold=4)
  scene.semantics = np.clip((scene.depths / scene.far * 4).astype(np.int32),
                            0, 4)
  dev = sampler.scene_to_device(scene, "cpu")
  state = zt.create_zip_train_state(0, mcfg, tcfg, device="cpu")
  step = zt.make_zip_train_step(state.model, tcfg, dev, scene.i_train,
                                scene.near, scene.far)
  gen = torch.Generator().manual_seed(1)
  rays, _ = sampler.sample_batch(dev, scene.i_train, 32, scene.near,
                                 scene.far, generator=gen)
  return state, step, gen, make_zip_eval_render_fn(state.model), rays


def _mip_state():
  """(state, step) of a tiny mip model, seeded, on a synthetic scene with
  depth and random confidence maps."""
  cfg = load_config(["--config", os.path.join(REPO, "configs",
                                              "nuScenes_depth_6cams"),
                     *MIP_NARROW])
  mcfg, tcfg = model_config(cfg), train_config(cfg)
  assert tcfg.depth_conf and tcfg.pose_refine and not mcfg.no_warp_sample
  scene = synthetic.make_synthetic_scene(num_images=6, H=12, W=16,
                                         datahold=3)
  dev = sampler.scene_to_device(scene, "cpu")
  maps = torch.randint(0, 256, (len(scene.i_train), len(tcfg.conf_modes),
                                12, 16), dtype=torch.uint8,
                       generator=torch.Generator().manual_seed(3))
  model, pose_model, state = mt.create_train_state(
      0, mcfg, tcfg, scene.num_images, device="cpu")
  step = mt.make_train_step(model, pose_model, tcfg, dev, scene.i_train,
                            scene.near, scene.far, conf_maps=maps)
  return state, step


@pytest.fixture(scope="module")
def tiny_mip():
  return _mip_state()


def _tree(events):
  """{(name, innermost marked span around it)} of the marked events."""
  out = set()
  for e in events:
    if not e.name.startswith(MARKED):
      continue
    p = e.cpu_parent
    while p is not None and not p.name.startswith(MARKED):
      p = p.cpu_parent
    out.add((e.name, None if p is None else p.name))
  return out


def _count(events, name):
  return sum(e.name == name for e in events)


def test_train_step_records_the_span_tree(tiny):
  state, step, gen, _, _ = tiny
  step(state, gen)
  with torch.profiler.profile() as prof:
    step(state, gen)
  events = prof.events()
  tree = _tree(events)
  assert STEP_TREE <= tree and tree - STEP_TREE <= RECOMPUTE, tree
  assert _count(events, "snerf.train.step") == 1
  for level_span in ("snerf.level.mlp", "snerf.level.composite"):
    assert _count(events, level_span) == 3
  # the nerf grid's 2 CP levels and each proposal grid's 3, all plain on
  # the CPU
  assert _count(events, "snerf.encode.cp.plain") == 8
  assert _count(events, "snerf.encode.cp.fused") == 0
  # the rays' warp and basis, then each level's sampling
  assert _count(events, "snerf.level.sample") == 4


def test_render_chunk_records_the_level_spans(tiny):
  _, _, _, render_fn, rays = tiny
  with torch.profiler.profile() as prof:
    render_fn(rays)
  events = prof.events()
  assert _tree(events) == {
      ("snerf.render.chunk", None),
      ("snerf.level.sample", "snerf.render.chunk"),
      ("snerf.level.mlp", "snerf.render.chunk"),
      ("snerf.encode.cp", "snerf.level.mlp"),
      ("snerf.encode.cp.plain", "snerf.encode.cp"),
      ("snerf.encode.hash", "snerf.level.mlp"),
      ("snerf.k1", "snerf.level.mlp"),
      ("snerf.mlp.dense", "snerf.level.mlp"),
      ("snerf.level.composite", "snerf.render.chunk")}
  assert _count(events, "snerf.render.chunk") == 1


def test_without_a_profiler_spans_are_one_shared_no_op(tiny, monkeypatch):
  state, step, gen, render_fn, rays = tiny
  made = []
  monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast",
                      lambda name: made.append(name))
  step(state, gen)
  render_fn(rays)
  assert made == []
  off = profiling.span("snerf.a")
  assert off is profiling.span("snerf.b")
  with off:
    pass


def test_counts_the_traced_units(tiny):
  state, step, gen, render_fn, rays = tiny
  with torch.profiler.profile() as prof:
    step(state, gen)
    step(state, gen)
    render_fn(rays)
  # on the CPU nothing synchronizes, and every CP level (2 + 3 + 3 a unit)
  # takes the plain path; each of the 3 MLPs runs its trunk as two K1 runs
  # and two library layers (the 16-wide entry and skip-cat layers), twice
  # a step (the checkpoint's recompute): (12 + 12 + 6) / 3 each
  assert profiling.counts(prof.events()) == {
      "units": 3, "host_syncs": 0, "host_syncs_by_site": {},
      "spans_per_unit": {"snerf.encode.cp.fused": 0.0,
                         "snerf.encode.cp.plain": 8.0, "snerf.k1": 10.0,
                         "snerf.k1.entry": 0.0, "snerf.mlp.dense": 10.0}}


def test_mip_step_records_the_span_tree(tiny_mip):
  state, step = tiny_mip
  gen = torch.Generator().manual_seed(1)
  step(state, gen)
  with torch.profiler.profile() as prof:
    step(state, gen)
  events = prof.events()
  assert _tree(events) == MIP_STEP_TREE
  # the draws and the ray batch; two levels; the proposal trunk's run, the
  # fine trunk's two around the skip and the bottleneck; the three Adams
  for name, n in (("snerf.train.step", 1), ("snerf.train.draw", 2),
                  ("snerf.train.pose", 1), ("snerf.train.conf", 1),
                  ("snerf.level.sample", 2), ("snerf.encode.ipe", 2),
                  ("snerf.level.mlp", 2), ("snerf.level.composite", 2),
                  ("snerf.k1", 4), ("Optimizer.step#Adam.step", 3)):
    assert _count(events, name) == n, name
  # 16 wide, no layer of another width opens a run: the trunks' first
  # layers, the skip-cat layer and the 3 cond layers stay on the library
  assert profiling.counts(events) == {
      "units": 1, "host_syncs": 0, "host_syncs_by_site": {},
      "spans_per_unit": {"snerf.encode.cp.fused": 0.0,
                         "snerf.encode.cp.plain": 0.0, "snerf.k1": 4.0,
                         "snerf.k1.entry": 0.0, "snerf.mlp.dense": 6.0}}


def test_mip_step_without_a_profiler_equals_an_unspanned_step(monkeypatch):
  """Off, the spans change nothing: two steps from the same seed, with the
  spans and with them replaced by no context at all, give bit-equal
  metrics and parameters."""
  runs = []
  for spanned in (True, False):
    if not spanned:
      for mod in (mt, mipnerf, mlp):
        monkeypatch.setattr(mod, "span", lambda name: contextlib.nullcontext())
    state, step = _mip_state()
    gen = torch.Generator().manual_seed(5)
    metrics = [step(state, gen) for _ in range(2)]
    params = [p.detach().clone() for m in (state.model, state.pose_model,
                                           state.conf_model)
              for p in m.parameters()]
    runs.append((metrics, params))
  (m1, p1), (m2, p2) = runs
  for a, b in zip(m1, m2):
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
  assert all(torch.equal(a, b) for a, b in zip(p1, p2))


def _ev(name, start, end, parent=None):
  return types.SimpleNamespace(
      name=name, cpu_parent=parent,
      time_range=types.SimpleNamespace(start=start, end=end))


def _synthetic_step():
  """A step (0-100 us) and a chunk (200-300) with runtime calls under the
  program's spans, under a backward node on autograd's thread, and
  outside any unit."""
  step = _ev("snerf.train.step", 0, 100)
  draw = _ev("snerf.train.draw", 1, 20, step)
  to = _ev("aten::to", 2, 10, draw)
  copy = _ev("aten::copy_", 3, 9, _ev("aten::_to_copy", 2, 10, to))
  item = _ev("aten::item", 12, 15, draw)
  node = _ev("autograd::engine::evaluate_function: _LevelEncodeBackward",
             40, 60)
  bwd_copy = _ev("aten::_to_copy", 41, 50, node)
  chunk = _ev("snerf.render.chunk", 200, 300)
  mlp = _ev("snerf.level.mlp", 210, 250, chunk)
  mul = _ev("aten::mul", 211, 212, mlp)
  return [
      step, draw, to, copy, item, node, bwd_copy, chunk, mlp, mul,
      _ev("cudaMemcpyAsync", 4, 5, copy),
      _ev("cudaStreamSynchronize", 5, 8, copy),
      _ev("cudaStreamSynchronize", 13, 14,
          _ev("aten::_local_scalar_dense", 12, 15, item)),
      _ev("cudaStreamSynchronize", 42, 45, bwd_copy),
      _ev("cudaLaunchKernel", 211, 212, mul),
      _ev("cudaFree", 220, 221, mlp),
      # before any unit, and between the two
      _ev("cudaDeviceSynchronize", -5, -1),
      _ev("cudaStreamSynchronize", 150, 160, _ev("aten::item", 149, 161))]


@pytest.mark.parametrize("units, want", [
    (profiling.UNITS, {
        "snerf.train.draw > aten::to": 1,
        "snerf.train.draw > aten::item": 1,
        "autograd::engine::evaluate_function: _LevelEncodeBackward"
        " > aten::_to_copy": 1,
        "snerf.level.mlp": 1}),
    (("snerf.render.chunk",), {"snerf.level.mlp": 1}),
    ((), {}),
])
def test_syncs_inside_units_counted_by_site(units, want):
  # the unit spans left out of the trace: their calls count nowhere
  events = [e for e in _synthetic_step()
            if e.name in units or e.name not in profiling.UNITS]
  got = profiling.counts(events)
  assert got["host_syncs_by_site"] == want
  assert got["host_syncs"] == sum(want.values())
  assert got["units"] == len(units)


@pytest.mark.card
def test_item_on_the_card_is_counted_at_its_op():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA card: a sync is a CUDA runtime call")
  x = torch.ones(4, device="cuda")
  acts = [torch.profiler.ProfilerActivity.CPU,
          torch.profiler.ProfilerActivity.CUDA]
  with torch.profiler.profile(activities=acts) as prof:
    with profiling.span("snerf.train.step"):
      with profiling.span("snerf.train.draw"):
        x.sum().item()
    torch.cuda.synchronize()
  got = profiling.counts(prof.events())
  assert got["units"] == 1
  assert got["host_syncs_by_site"] == {"snerf.train.draw > aten::item": 1}, \
      got
