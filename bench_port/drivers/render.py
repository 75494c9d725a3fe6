"""The "render" traffic kind: the S-NeRF++ simulation backgrounds as
`cli.render --render_mode random` renders them (`make_zip_eval_render_fn`
+ `render_image`, chunk `chunk` of the configuration, the EMA weights
where the configuration keeps them), closed loop, one job.

Every run renders one scene, the rig and the served weights drawn from
the traffic's `scene_seed`, as a trained scene is rendered again and
again: the work of a ray follows the field (where the proposal samples
fall, how many CP terms each sample's window keeps), so a scene drawn
from the run's seed would make the seed change the work. The run's seed
draws the views and the compared chunks. Frames are full 1280 x 1920
views at novel poses between neighbouring frames (the WAYMO_RENDER
generator, bench_port/scene.py). Each frame's rays come from
`rays_for_image`, and `render_image` renders a strip of `strip_rows`
rows at a time (a whole number of chunks). Consecutive strips come from
consecutive frames, their bands `band_stride` apart, so that a window
shorter than a frame still sees every view's share of every part of the
image: how fast a view renders follows the seed that drew it, and a
window of one view's top rows would follow it too. Every frame's every
band comes once in `frames` x (bands a frame) strips. `sample_chunks`
chunks, drawn from the seed among the first `sample_strips` strips of
the window, are kept and compared with the plain reference after the
window (strips the window did not reach are rendered after it, untimed).

A window's rate is `render_rays_per_s`; the fault is an altered answer;
the precision control is the reference with TF32 on, a setting of the
card (on the CPU it reads as the reference).
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from bench_port import check, faults
from bench_port import scene as S
from bench_port import weights
from bench_port.cell import Cell, Pacer, sync
from bench_port.drivers.train import _free, configs, new_state

RATE = "render_rays_per_s"
FAULTS = {"altered_answer": faults.altered_answer}
CONTROL_NEEDS_CARD = True


def _samples(cell: Cell, chunks_per_strip: int):
  tr = cell.traffic
  rng = np.random.RandomState(S.sub_seed(cell.seed, "render_sample", 32))
  flat = rng.choice(tr["sample_strips"] * chunks_per_strip,
                    tr["sample_chunks"], replace=False)
  out: Dict[int, List[int]] = {}
  for v in sorted(int(v) for v in flat):
    out.setdefault(v // chunks_per_strip, []).append(v % chunks_per_strip)
  return out


def scene_seed(cell: Cell) -> int:
  """The seed of the rendered scene: its rig and its served weights."""
  return int(cell.traffic["scene_seed"])


class Frames:
  """The window's strips in order: strip g is band (g // frames + f *
  band_stride) mod (bands a frame) of frame f = g mod frames, the cycle
  starting again when the window outlasts it. One frame's rays are held
  at a time. The cameras and the near and far bounds go to the device
  once: a copy from the host's memory would wait for the strips queued
  before it at every change of frame."""

  def __init__(self, torch, cell, lay, rays_for_image):
    self.lay = lay
    self.rays_for_image = rays_for_image
    tr = cell.traffic
    self.poses, self.Ks = S.render_poses(lay, tr["frames"], cell.seed)
    self.rows, self.stride = tr["strip_rows"], tr["band_stride"]
    self.per_frame = lay.hw[0] // self.rows
    on = lambda x: torch.as_tensor(x, dtype=torch.float32, device=cell.device)
    self._cams = (on(self.poses), on(self.Ks), on(lay.near), on(lay.far))
    self._frame, self._rays = None, None

  def where(self, g: int):
    """(frame, band) of strip g."""
    n = len(self.poses)
    f = g % n
    return f, (g // n + f * self.stride) % self.per_frame

  def strip(self, g: int):
    f, s = self.where(g)
    if f != self._frame:
      poses, Ks, near, far = self._cams
      self._rays = None
      self._rays = self.rays_for_image(poses[f], Ks[f], *self.lay.hw, near,
                                       far)
      self._frame = f
    r0 = s * self.rows
    return self._rays.map(lambda x: x[r0:r0 + self.rows])


def _program(cell: Cell):
  """(the trainer's module, a train state) with the scene's served
  weights: the EMA copy where the configuration keeps one (the live
  parameters then hold another draw), else the parameters."""
  zt, _, state = new_state(cell, reference=False, seed=scene_seed(cell))
  if state.ema is not None:
    weights.load(state.model, scene_seed(cell), stream="live")
  return zt, state


def numbers(out: Dict) -> Dict[str, float]:
  """The numbers the check compares (`check.render_numbers`)."""
  prog, ref, near = out["answers"]
  return check.render_numbers(prog, ref, near)


def control(cell: Cell) -> Dict[str, float]:
  """The precision control's numbers: the reference's sampled chunks
  computed with TF32 on, in the program's place, against the reference's."""
  lay = S.layout(cell.scene_spec, scene_seed(cell))
  chunk = int(cell.flags["chunk"])
  per_strip = cell.traffic["strip_rows"] * lay.hw[1] // chunk
  keys = [(g, c) for g, cs in sorted(_samples(cell, per_strip).items())
          for c in cs]
  ref = reference_chunks(cell, lay, keys, chunk)
  ctrl = reference_chunks(cell, lay, keys, chunk, control=True)
  return check.render_numbers(ctrl, ref, lay.near)


def run(cell: Cell, fault: Optional[Callable] = None) -> Dict:
  """One run: set-up (layout, model, one warm-up strip), the window or
  the traced window, the sampled chunks, then the reference. `fault`
  (tests and calibration only) wraps the program's render fn."""
  import torch
  from snerf_tpu_torch.data.raygen import rays_for_image
  from snerf_tpu_torch.train.renderer import (make_zip_eval_render_fn,
                                              render_image)
  from bench_port import trace
  from bench_port.counts import zip as counts

  tr = cell.traffic
  chunk = int(cell.flags["chunk"])
  parts = {}
  t = time.perf_counter()
  lay = S.layout(cell.scene_spec, scene_seed(cell))
  frames = Frames(torch, cell, lay, rays_for_image)
  per_strip = frames.rows * lay.hw[1] // chunk
  samples = _samples(cell, per_strip)
  zt, state = _program(cell)
  sync(torch, cell.device)
  parts["state_s"] = time.perf_counter() - t
  kept: Dict[tuple, Dict] = {}
  out: Dict = {"rays_per_unit": chunk}
  with zt.eval_weights(state):
    render_fn = make_zip_eval_render_fn(state.model)
    if fault is not None:
      render_fn = fault(render_fn)

    def strip(g: int, fn=render_fn):
      res = render_image(fn, frames.strip(g), chunk=chunk)
      for c in samples.get(g, ()):
        kept[(g, c)] = {k: v.reshape(-1, *v.shape[2:])[c * chunk:(c + 1) * chunk]
                        .clone() for k, v in res.items()}

    t = time.perf_counter()
    render_image(render_fn, frames.strip(0), chunk=chunk)   # warm-up
    sync(torch, cell.device)
    parts["warmup_s"] = time.perf_counter() - t
    out["setup_s"] = time.perf_counter() - cell.t_start
    out["setup_parts"] = parts
    pace = Pacer(torch, cell.device)
    if cell.trace:
      restore = trace.instrument(state.model)
      unit_fn = trace.unit(render_fn)

      def traced():
        for g in range(tr["trace_strips"]):
          strip(g, unit_fn)
          pace()
        return tr["trace_strips"] * per_strip

      out["trace"] = trace.profile(torch, traced, trace.load_layers())
      restore()
      done = tr["trace_strips"]
      # the rows the encode touches, from the next strip's first chunk:
      # held through the traced window, the positions would grow the
      # allocator inside it
      recorded = []
      restore = trace.instrument(state.model, recorded)
      render_fn(frames.strip(done).reshape(-1).map(lambda x: x[:chunk]))
      restore()
      units = out["trace"].units
      zcfg = configs(cell, reference=True)[0]
      out["work"] = {
          "products_s": units * counts.products_bound_s(zcfg, chunk, False),
          "k1_s": units * counts.k1_bound_s(zcfg, chunk, False),
          "hash_encode_s": units * counts.hash_encode_bound_s(
              counts.hash_calls(recorded), train=False)}
      del recorded
      out["units"] = units
    else:
      sync(torch, cell.device)
      t0 = time.perf_counter()
      done = 0
      while time.perf_counter() - t0 < cell.seconds:
        strip(done)
        pace()
        done += 1
      sync(torch, cell.device)
      out.update(units=done * per_strip, wall_s=time.perf_counter() - t0)
    out["memory_peak_bytes"] = (torch.cuda.max_memory_allocated()
                                if torch.device(cell.device).type == "cuda"
                                else 0)
    for g in sorted(samples):
      if g >= done:
        strip(g)
  prog = [kept[k] for k in sorted(kept)]
  del state, render_fn, frames
  _free(torch)
  t = time.perf_counter()
  ref = reference_chunks(cell, lay, sorted(kept), chunk)
  out["reference_s"] = time.perf_counter() - t
  out["answers"] = (prog, ref, lay.near)
  return out


def reference_chunks(cell: Cell, lay, keys, chunk: int,
                     control: bool = False) -> List[Dict]:
  """The plain reference's outputs of the chunks `keys` ((strip, chunk)),
  on the served weights; float32 products with TF32 off, or with
  `control` on (the precision control)."""
  import torch
  from bench_port.reference.data.raygen import rays_for_image
  from bench_port.reference.models.zipnerf import ZipNerfModel
  from bench_port.reference.train.renderer import make_zip_eval_render_fn
  zcfg = configs(cell, reference=True)[0]
  model = ZipNerfModel(zcfg, device=cell.device)
  weights.load(model, scene_seed(cell))
  render_fn = make_zip_eval_render_fn(model)
  frames = Frames(torch, cell, lay, rays_for_image)
  out = []
  with _tf32(torch, control):
    for g, c in keys:
      rays = frames.strip(g).reshape(-1).map(
          lambda x: x[c * chunk:(c + 1) * chunk])
      out.append(render_fn(rays))
  return out


@contextlib.contextmanager
def _tf32(torch, on: bool):
  prev = (torch.backends.cuda.matmul.allow_tf32,
          torch.backends.cudnn.allow_tf32)
  torch.backends.cuda.matmul.allow_tf32 = on
  torch.backends.cudnn.allow_tf32 = on
  try:
    yield
  finally:
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = prev
