"""The "render" traffic kind: the S-NeRF++ simulation backgrounds as
`cli.render --render_mode random` renders them (`make_zip_eval_render_fn`
+ `render_image`, chunk `chunk` of the configuration, the EMA weights
where the configuration keeps them), closed loop, one job.

Frames are full 1280 x 1920 views at novel poses between neighbouring
frames (the WAYMO_RENDER generator, bench_port/scene.py). Each frame's
rays come from `rays_for_image`, and `render_image` renders it a strip
of `strip_rows` rows at a time (a whole number of chunks), so the window
can close inside a frame. `sample_chunks` chunks, drawn from the seed
among the first `sample_strips` strips of the window, are kept and
compared with the plain reference after the window (strips the window
did not reach are rendered after it, untimed).
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from bench_port import scene as S
from bench_port import weights
from bench_port.cell import Cell, Pacer, sync
from bench_port.drivers.train import _free, configs, new_state


def _samples(cell: Cell, chunks_per_strip: int):
  tr = cell.traffic
  rng = np.random.RandomState(S.sub_seed(cell.seed, "render_sample", 32))
  flat = rng.choice(tr["sample_strips"] * chunks_per_strip,
                    tr["sample_chunks"], replace=False)
  out: Dict[int, List[int]] = {}
  for v in sorted(int(v) for v in flat):
    out.setdefault(v // chunks_per_strip, []).append(v % chunks_per_strip)
  return out


class Frames:
  """The window's strips in order: frame by frame, `strip_rows` rows at a
  time, the frames cycling when the window outlasts them."""

  def __init__(self, torch, cell, lay, rays_for_image):
    self.torch, self.cell, self.lay = torch, cell, lay
    self.rays_for_image = rays_for_image
    tr = cell.traffic
    self.poses, self.Ks = S.render_poses(lay, tr["frames"], cell.seed)
    self.rows = tr["strip_rows"]
    self.per_frame = lay.hw[0] // self.rows
    self._frame, self._rays = None, None

  def strip(self, g: int):
    f, s = divmod(g, self.per_frame)
    f %= len(self.poses)
    if f != self._frame:
      dev = self.cell.device
      self._rays = self.rays_for_image(
          self.torch.as_tensor(self.poses[f], device=dev),
          self.torch.as_tensor(self.Ks[f], device=dev), *self.lay.hw,
          self.lay.near, self.lay.far)
      self._frame = f
    r0 = s * self.rows
    return self._rays.map(lambda x: x[r0:r0 + self.rows])


def _program(cell: Cell):
  """(the trainer's module, a train state) with the served weights from
  the seed: the EMA copy where the configuration keeps one (the live
  parameters then hold another draw), else the parameters."""
  zt, _, state = new_state(cell, reference=False)
  if state.ema is not None:
    weights.load(state.model, cell.seed, stream="live")
  return zt, state


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
  lay = S.layout(cell.scene_spec, cell.seed)
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
  weights.load(model, cell.seed)
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
