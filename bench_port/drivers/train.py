"""The "train" traffic kind: the shipped zip train step
(`make_zip_train_step` on the state `create_zip_train_state` makes, the
step `cli.train` runs, on the shipped schedule) back to back in closed
loop, one job.

Set-up builds one train state from the seed's weights and hands it,
after its first `check_steps` steps (the warm-up, through the window's
own call and generator), to the window. Those steps are what the check
compares with the plain reference run on the same weights and draws:
each step's loss, each leaf's first gradient as Adam got it (its first
moment over 1 - beta1) and each leaf's change after the steps (the EMA
copy's too).

A window's rate is `train_rays_per_s`; the faults are a state left
unchanged and half the batch left out; the precision control is the
reference with the trunks' operands rounded through float8.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, Optional

import numpy as np

from bench_port import check, faults
from bench_port import scene as S
from bench_port import weights
from bench_port.cell import Cell, Pacer, flag_argv, sync

RATE = "train_rays_per_s"
FAULTS = {"unchanged_state": faults.unchanged_state,
          "half_batch": faults.half_batch}
CONTROL_NEEDS_CARD = False


def configs(cell: Cell, reference: bool):
  """(model config, train config) from the cell's flags, by the
  program's adapters or the reference's copies."""
  if reference:
    from bench_port.reference.config import zip_model_config, zip_train_config
    from bench_port.reference.flags import load_config
  else:
    from snerf_tpu_torch.config import (load_config, zip_model_config,
                                        zip_train_config)
  cfg = load_config(flag_argv(cell.flags))
  return zip_model_config(cfg), zip_train_config(cfg)


def new_state(cell: Cell, reference: bool, seed: Optional[int] = None):
  """(module of the trainer, train config, state) with the weights of
  `seed` (by default the run's):
  the state `create_zip_train_state` makes (the model, its Adam with the
  encoder tables in their own group, the EMA copy, no pose model, as
  cli.train builds it), put together from the same constructors without
  its seeded init, whose values the drawn weights replace (that init
  draws every table on the CPU: seconds of set-up that serve no step)."""
  import torch
  if reference:
    from bench_port.reference.models.zipnerf import ZipNerfModel
    from bench_port.reference.train import zip_trainer as zt
  else:
    from snerf_tpu_torch.models.zipnerf import ZipNerfModel
    from snerf_tpu_torch.train import zip_trainer as zt
  zcfg, tcfg = configs(cell, reference)
  model = ZipNerfModel(zcfg, device=cell.device)
  weights.load(model, cell.seed if seed is None else seed)
  state = zt.ZipTrainState(step=0, model=model,
                           optimizer=zt.make_zip_optimizer(model, tcfg))
  if tcfg.ema_decay > 0:
    state.ema = {n: p.detach().clone() for n, p in model.named_parameters()}
  return zt, tcfg, state


def build(cell: Cell, scene, lay, reference: bool):
  """(train config, state, step) on the seed's weights."""
  zt, tcfg, state = new_state(cell, reference)
  step = zt.make_zip_train_step(state.model, tcfg, scene,
                                np.arange(len(lay.poses)), lay.near, lay.far)
  return tcfg, state, step


def draws(cell: Cell):
  import torch
  return S.generator(torch.device(cell.device), cell.seed, "draws")


def readings(cell: Cell, tcfg, state, step, gen, n_steps: int) -> Dict:
  """Run n_steps steps; {"loss": [per step], "grad": {leaf: norm of the
  first gradient}, "change": {leaf: norm of its change}}."""
  import torch
  named = list(state.model.named_parameters())
  losses, grad = [], {}
  for t in range(n_steps):
    losses.append(step(state, gen)["loss"].detach().float())
    if t == 0:
      for name, p in named:
        m = state.optimizer.state.get(p, {}).get("exp_avg")
        grad[name] = (torch.zeros((), device=p.device) if m is None else
                      torch.linalg.vector_norm(m.float())
                      / (1.0 - tcfg.adam_beta1))
  change = {}
  p0 = weights.draw(((n, p.shape) for n, p in named), cell.seed,
                    named[0][1].device)
  with torch.no_grad():
    for name, p in named:
      change[name] = torch.linalg.vector_norm(p - p0[name])
      if state.ema is not None:
        change[f"ema.{name}"] = torch.linalg.vector_norm(
            state.ema[name] - p0[name])
  del p0
  as_floats = lambda d: dict(zip(d, torch.stack(list(d.values())).tolist()))
  return {"loss": torch.stack(losses).tolist(), "grad": as_floats(grad),
          "change": as_floats(change)}


def window(cell: Cell, state, step, gen, seconds: float) -> Dict:
  """Steps back to back until `seconds` have passed on the host clock;
  the window ends in a synchronize."""
  import torch
  pace = Pacer(torch, cell.device)
  sync(torch, cell.device)
  t0 = time.perf_counter()
  n = 0
  while time.perf_counter() - t0 < seconds:
    step(state, gen)
    pace()
    n += 1
  sync(torch, cell.device)
  return {"units": n, "wall_s": time.perf_counter() - t0}


def reference_readings(cell: Cell, scene, lay, n_steps: int,
                       control: bool = False) -> Dict:
  """The plain reference's readings on the same weights and draws; with
  `control`, computed with the trunks' operands rounded through float8."""
  from bench_port.reference.models.mlp import lower_precision
  tcfg, state, step = build(cell, scene, lay, reference=True)
  with lower_precision() if control else contextlib.nullcontext():
    return readings(cell, tcfg, state, step, draws(cell), n_steps)


def numbers(out: Dict) -> Dict[str, float]:
  """The numbers the check compares (`check.train_numbers`), and how many
  leaves `change_gap` leaves out (which no limit names)."""
  prog, ref = out["answers"]
  return {**check.train_numbers(prog, ref),
          "leaves_left_out": len(ref["change"]) - len(check.moved_leaves(ref))}


def control(cell: Cell) -> Dict[str, float]:
  """The precision control's numbers: the reference computed with the
  trunks' operands through float8, in the program's place, against the
  reference."""
  lay = S.layout(cell.scene_spec, cell.seed)
  scene = S.device_scene(cell.scene_spec, lay, cell.seed, cell.device)
  steps = cell.traffic["check_steps"]
  ref = reference_readings(cell, scene, lay, steps)
  ctrl = reference_readings(cell, scene, lay, steps, control=True)
  return check.train_numbers(ctrl, ref)


def run(cell: Cell, fault: Optional[Callable] = None) -> Dict:
  """One run: set-up (scene, state, the check steps), the window or the
  traced window, then the reference. `fault` (tests and calibration
  only) breaks the program's state or step: fault(state, step) -> step."""
  import torch
  from bench_port import trace
  from bench_port.counts import zip as counts

  tr = cell.traffic
  parts = {}
  t = time.perf_counter()
  lay = S.layout(cell.scene_spec, cell.seed)
  scene = S.device_scene(cell.scene_spec, lay, cell.seed, cell.device)
  sync(torch, cell.device)
  parts["scene_s"] = time.perf_counter() - t
  t = time.perf_counter()
  tcfg, state, step = build(cell, scene, lay, reference=False)
  if fault is not None:
    step = fault(state, step)
  sync(torch, cell.device)
  parts["state_s"] = time.perf_counter() - t
  t = time.perf_counter()
  gen = draws(cell)
  prog = readings(cell, tcfg, state, step, gen, tr["check_steps"])
  parts["check_steps_s"] = time.perf_counter() - t
  setup_s = time.perf_counter() - cell.t_start

  out: Dict = {"setup_s": setup_s, "setup_parts": parts,
               "rays_per_unit": tcfg.batch_size}
  if cell.trace:
    restore = trace.instrument(state.model)
    unit_step = trace.unit(step)

    def traced():
      pace = Pacer(torch, cell.device)
      for _ in range(tr["trace_steps"]):
        unit_step(state, gen)
        pace()
      return tr["trace_steps"]

    out["trace"] = trace.profile(torch, traced, trace.load_layers())
    restore()
    # the rows the encode touches, from one more step's positions: held
    # through the traced window they would grow the allocator inside it
    recorded = []
    restore = trace.instrument(state.model, recorded)
    step(state, gen)
    restore()
    zcfg = configs(cell, reference=True)[0]
    units = out["trace"].units
    out["work"] = {
        "products_s": units * counts.products_bound_s(
            zcfg, tcfg.batch_size, train=True),
        "k1_s": units * counts.k1_bound_s(zcfg, tcfg.batch_size, train=True),
        "hash_encode_s": units * counts.hash_encode_bound_s(
            counts.hash_calls(recorded), train=True)}
    del recorded
    out["units"] = units
  else:
    out.update(window(cell, state, step, gen, cell.seconds))
  out["memory_peak_bytes"] = (torch.cuda.max_memory_allocated()
                              if torch.device(cell.device).type == "cuda"
                              else 0)
  del state, step, gen
  _free(torch)
  t = time.perf_counter()
  ref = reference_readings(cell, scene, lay, tr["check_steps"])
  out["reference_s"] = time.perf_counter() - t
  out["answers"] = (prog, ref)
  return out


def _free(torch) -> None:
  import gc
  gc.collect()
  if torch.cuda.is_available():
    torch.cuda.empty_cache()
