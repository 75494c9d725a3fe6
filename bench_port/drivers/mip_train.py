"""The "mip_train" traffic kind: the shipped S-NeRF mip train step
(`make_train_step` on the state `create_train_state` makes, the step
`cli.train` runs, float32 with TF32 off) back to back in closed loop, one
job.

Set-up builds the nuScenes-layout scene (bench_port/nuscenes_scene.py),
precomputes its depth confidence maps through cli.train's own
`precompute_conf` (the scene's data from then on: the reference reads
the same uint8 maps), and builds one train state from the seed's
weights: the model, its Adam, the pose table with its Adam and the
confidence lambdas with theirs. Its first `check_steps` steps (the
warm-up, through the window's own call and generator) are what the check
compares with the plain reference run on the same weights, maps and
draws: each step's loss, each leaf's first gradient as Adam got it (its
first moment over 1 - beta1) and each leaf's change after the steps, the
pose table's (`pose.*`) and the lambdas' (`conf.*`) among them.

A window's rate is `train_rays_per_s`; the faults are a state left
unchanged, half the batch left out, the depth loss without its
confidence weights and the pose table never stepped; the precision
control is the reference with TF32 on for its float32 products.
"""

from __future__ import annotations

import contextlib
import statistics
import time
import types
from typing import Callable, Dict, Optional

from bench_port import check, faults
from bench_port import nuscenes_scene as NS
from bench_port import weights
from bench_port.cell import Cell, Pacer, flag_argv, sync
from bench_port.drivers.train import _free, draws, window

RATE = "train_rays_per_s"
CONTROL_NEEDS_CARD = True
POSE, CONF = "pose.", "conf."


def half_batch(state, step):
  """Half of the batch left out of the rgb and depth terms, the masked
  means taken over the rest (faults.half_batch's fault for the mip loss
  set, whose rgb mean has no mask and a channel axis)."""
  import torch
  from snerf_tpu_torch.train import losses
  orig = losses.masked_mean

  def half_mean(x, mask=None):
    keep = torch.arange(x.shape[0], device=x.device) < x.shape[0] // 2
    keep = keep.reshape(-1, *([1] * (x.dim() - 1)))
    return orig(x, keep if mask is None else mask & keep)

  def broken(st, gen):
    losses.masked_mean = half_mean
    try:
      return step(st, gen)
    finally:
      losses.masked_mean = orig
  return broken


def conf_unweighted(state, step):
  """The depth loss without the confidence weights (every ray at 1)."""
  from snerf_tpu_torch.train import losses
  orig = losses.depth_loss

  def unweighted(*args, conf_weight=None, **kwargs):
    return orig(*args, **kwargs)

  def broken(st, gen):
    losses.depth_loss = unweighted
    try:
      return step(st, gen)
    finally:
      losses.depth_loss = orig
  return broken


def pose_frozen(state, step):
  """The pose table's Adam never steps."""
  state.pose_optimizer.step = lambda *args, **kwargs: None
  return step


FAULTS = {"unchanged_state": faults.unchanged_state,
          "half_batch": half_batch,
          "conf_unweighted": conf_unweighted,
          "pose_frozen": pose_frozen}


def configs(cell: Cell, reference: bool):
  """(model config, train config) from the cell's flags, by the
  program's adapters or the reference's copies."""
  if reference:
    from bench_port.reference.flags import load_config
    from bench_port.reference.mip_config import model_config, train_config
  else:
    from snerf_tpu_torch.config import (load_config, model_config,
                                        train_config)
  cfg = load_config(flag_argv(cell.flags))
  return model_config(cfg), train_config(cfg)


def scene(cell: Cell):
  """(layout, the device scene, near, far, the confidence maps
  [n_train, n_modes, H, W] uint8), the maps precomputed as cli.train
  precomputes them; with the seconds of each part."""
  import torch
  from snerf_tpu_torch.cli import common
  from snerf_tpu_torch.cli.train import precompute_conf
  common.float32_numerics()
  parts = {}
  t = time.perf_counter()
  lay = NS.layout(cell.scene_spec, cell.seed)
  dev = NS.device_scene(cell.scene_spec, lay, cell.seed, cell.device)
  near, far = NS.near_far(dev["depths"])
  sync(torch, cell.device)
  parts["scene_s"] = time.perf_counter() - t
  t = time.perf_counter()
  host = types.SimpleNamespace(i_train=lay.i_train, cam_index=lay.cam_index,
                               flow=None)
  maps = precompute_conf(configs(cell, reference=False)[1], host, dev,
                         cell.device)
  sync(torch, cell.device)
  parts["conf_precompute_s"] = time.perf_counter() - t
  return (lay, dev, near, far, maps), parts


def build(cell: Cell, data, reference: bool):
  """(train config, state, step) on the run's weights: the state
  `create_train_state` makes (the model, its Adam at the schedule's first
  rate, the pose table and the confidence lambdas at zero with their
  Adams, no EMA), put together from the same constructors, the drawn
  weights in place of its glorot init."""
  if reference:
    from bench_port.reference.models.confidence import ConfidenceModel
    from bench_port.reference.models.mipnerf import MipNerfModel
    from bench_port.reference.models.posenet import LearnPose
    from bench_port.reference.train import trainer as tr
  else:
    from snerf_tpu_torch.models.confidence import ConfidenceModel
    from snerf_tpu_torch.models.mipnerf import MipNerfModel
    from snerf_tpu_torch.models.posenet import LearnPose
    from snerf_tpu_torch.train import trainer as tr
  lay, dev, near, far, maps = data
  mcfg, tcfg = configs(cell, reference)
  n = len(lay.poses)
  model = MipNerfModel(mcfg, device=cell.device)
  weights.load(model, cell.seed)
  state = tr.TrainState(step=0, model=model, optimizer=tr.adam(
      model.parameters(), tr.make_lr_schedule(tcfg)(0)))
  if tcfg.ema_decay > 0:
    state.ema = {k: p.detach().clone() for k, p in model.named_parameters()}
  if tcfg.pose_refine:
    state.pose_model = LearnPose(n, device=cell.device)
    state.pose_optimizer = tr.adam(state.pose_model.parameters(),
                                   tcfg.pose_lrate)
  if tcfg.depth_conf:
    state.conf_model = ConfidenceModel(tcfg.conf_modes, n, device=cell.device)
    state.conf_optimizer = tr.adam(state.conf_model.parameters(),
                                   tcfg.conf_lrate)
  step = tr.make_train_step(model, state.pose_model, tcfg, dev, lay.i_train,
                            near, far, conf_maps=maps)
  return tcfg, state, step


def _leaves(state):
  """[(name, parameter, its optimizer)] of the model, the pose table
  (`pose.*`) and the confidence lambdas (`conf.*`)."""
  out = [(k, p, state.optimizer) for k, p in state.model.named_parameters()]
  for prefix, module, opt in ((POSE, state.pose_model, state.pose_optimizer),
                              (CONF, state.conf_model, state.conf_optimizer)):
    if module is not None:
      out += [(prefix + k, p, opt) for k, p in module.named_parameters()]
  return out


def readings(cell: Cell, tcfg, state, step, gen, n_steps: int) -> Dict:
  """Run n_steps steps; {"loss": [per step], "grad": {leaf: norm of the
  first gradient}, "change": {leaf: norm of its change}, "grad_vectors":
  {leaf: the first gradient itself, on the host, but the pose table's}}."""
  import torch
  leaves = _leaves(state)
  losses, grad, vec = [], {}, {}
  for t in range(n_steps):
    losses.append(step(state, gen)["loss"].detach().float())
    if t == 0:
      for name, p, opt in leaves:
        m = opt.state.get(p, {}).get("exp_avg")
        g = (torch.zeros_like(p) if m is None
             else m.float() / (1.0 - opt.defaults["betas"][0]))
        grad[name] = torch.linalg.vector_norm(g)
        if not name.startswith(POSE):
          vec[name] = g.detach().to("cpu", copy=True)
  model_leaves = [(k, p) for k, p, _ in leaves
                  if not k.startswith((POSE, CONF))]
  p0 = weights.draw(((k, p.shape) for k, p in model_leaves), cell.seed,
                    model_leaves[0][1].device)
  change = {}
  with torch.no_grad():
    for name, p, _ in leaves:
      # the pose table and the lambdas start at zero
      change[name] = torch.linalg.vector_norm(p - p0[name] if name in p0
                                              else p)
  del p0
  as_floats = lambda d: dict(zip(d, torch.stack(list(d.values())).tolist()))
  return {"loss": torch.stack(losses).tolist(), "grad": as_floats(grad),
          "change": as_floats(change), "grad_vectors": vec}


@contextlib.contextmanager
def _tf32(on: bool):
  """TF32 for float32 matmuls and cuDNN convolutions set to `on` inside
  the block, restored after it."""
  import torch
  was = (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32)
  torch.backends.cuda.matmul.allow_tf32 = on
  torch.backends.cudnn.allow_tf32 = on
  try:
    yield
  finally:
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = was


def reference_readings(cell: Cell, data, n_steps: int,
                       control: bool = False) -> Dict:
  """The plain reference's readings on the same weights, maps and draws,
  its float32 products with TF32 off; with `control`, with TF32 on."""
  tcfg, state, step = build(cell, data, reference=True)
  with _tf32(control):
    return readings(cell, tcfg, state, step, draws(cell), n_steps)


def _change_gap(prog: Dict, ref: Dict, prefix: str) -> float:
  """The largest relative gap of a group's changes after the steps, each
  over the reference's change of that leaf."""
  return max((abs(prog["change"][k] - ref["change"][k])
              / max(ref["change"][k], 1e-30)
              for k in ref["change"] if k.startswith(prefix)), default=0.0)


def _without(readings: Dict, prefix: str) -> Dict:
  return {"loss": readings["loss"],
          **{part: {k: v for k, v in readings[part].items()
                    if not k.startswith(prefix)}
             for part in ("grad", "change")}}


def _grad_median_gap(prog: Dict, ref: Dict) -> float:
  """Over the leaves, the median of |g - g_ref| / max(|g_ref|, the median
  leaf's |g_ref|), each leaf's first gradient taken whole (in float64)."""
  import torch
  want = {k: v.double() for k, v in ref["grad_vectors"].items()}
  norms = {k: float(torch.linalg.vector_norm(v)) for k, v in want.items()}
  floor = statistics.median(norms.values())
  return statistics.median(
      float(torch.linalg.vector_norm(prog["grad_vectors"][k].double() - v))
      / max(norms[k], floor, 1e-30) for k, v in want.items())


def numbers(out: Dict) -> Dict[str, float]:
  """The numbers the check compares:

    loss_gap, grad_gap, change_gap   `check.train_numbers` over the
        model's leaves and the confidence lambdas: a fault in any leaf;
    grad_median_gap   the median leaf's gap of its whole first gradient:
        a precision lost in every leaf. One float32 forward of the
        proposal trunk against another moves the fine samples it draws,
        and the IPE's high frequencies carry that into every gradient, so
        the largest leaf's gap reads as far from the reference on a sound
        run as on one in TF32; the median leaf's does not;
    pose_gap, conf_gap   the gaps of the pose table's and the lambdas' own
        changes (which `change_gap` leaves out whenever their gradient is
        under a thousandth of the median leaf's);

  and how many leaves `change_gap` leaves out (which no limit names). The
  pose table's first gradient sums every ray's pull on its camera, terms
  that all but cancel: two sound float32 sums of it are 6e-4 to 1.2e-2
  apart, so it is read but not compared; its Adam step, whose first
  update is the learning rate times the gradient's sign, is held by
  `pose_gap`."""
  prog, ref = out["answers"]
  model_ref = _without(ref, POSE)
  return {**check.train_numbers(_without(prog, POSE), model_ref),
          "grad_median_gap": _grad_median_gap(prog, ref),
          "pose_gap": _change_gap(prog, ref, POSE),
          "conf_gap": _change_gap(prog, ref, CONF),
          "leaves_left_out": (len(model_ref["change"])
                              - len(check.moved_leaves(model_ref)))}


def control(cell: Cell) -> Dict[str, float]:
  """The precision control's numbers: the reference with TF32 on, in the
  program's place, against the reference."""
  data, _ = scene(cell)
  steps = cell.traffic["check_steps"]
  ref = reference_readings(cell, data, steps)
  ctrl = reference_readings(cell, data, steps, control=True)
  return numbers({"answers": (ctrl, ref)})


def run(cell: Cell, fault: Optional[Callable] = None) -> Dict:
  """One run: set-up (scene, confidence maps, state, the check steps), the
  window or the traced window, then the reference. `fault` (tests and
  calibration only) breaks the program's state or step:
  fault(state, step) -> step."""
  import torch
  from bench_port import trace
  from bench_port.counts import mip as counts

  tr = cell.traffic
  data, parts = scene(cell)
  t = time.perf_counter()
  tcfg, state, step = build(cell, data, reference=False)
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
               "rays_per_unit": tcfg.n_rgb}
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
    mcfg = configs(cell, reference=True)[0]
    units = out["trace"].units
    out["work"] = {
        "products_s": units * counts.products_bound_s(mcfg, tcfg.n_rgb),
        "k1_s": units * counts.k1_bound_s(mcfg, tcfg.n_rgb)}
    out["units"] = units
  else:
    out.update(window(cell, state, step, gen, cell.seconds))
  out["memory_peak_bytes"] = (torch.cuda.max_memory_allocated()
                              if torch.device(cell.device).type == "cuda"
                              else 0)
  del state, step, gen
  _free(torch)
  t = time.perf_counter()
  ref = reference_readings(cell, data, tr["check_steps"])
  out["reference_s"] = time.perf_counter() - t
  out["answers"] = (prog, ref)
  return out
