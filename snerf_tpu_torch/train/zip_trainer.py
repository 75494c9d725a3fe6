"""zip-nerf (S-NeRF++ background) training step (counterpart of
snerf_tpu/train/zip_trainer.py).

One step: refine the pose table (optional), sample a ray batch on the
device (random pixels, then the patch quarter), run the randomized zip
forward, sum the loss set (Charbonnier data, anti-aliased interlevel,
distortion, hash decay, inverse depth with depth completion on masked
pixels, semantic NLL, the two edge-aware patch smoothness terms),
backpropagate (through the fused hash encode's backward on the card),
scrub and clip the grads, and apply Adam to the model (log-lerp
schedule, the encoder tables in their own param groups) and SGD to the
poses inside their window, then the optional EMA. The JAX step is one jitted
function of a PRNG key; here the step runs eagerly and its random draws
come from a torch.Generator or are injected (`ZipStepDraws`).

Adam matches optax's `adam`: betas (0.9, 0.99), eps 1e-15 outside the
square root, bias correction at the incremented count, and the schedule
read at the count before the increment. optax forms the bias corrections
1 - beta^t in float32, torch in float64: 1 - 0.99 loses ~6e-6 of itself
in float32, so the first updates differ by up to ~3e-6 relative
(tests/test_torch_zip_trainer.py states it).

Not ported: the TPU throughput warning (`estimate_hash_rays_per_sec`,
`maybe_warn_hash_on_tpu`), the mesh sharding constraint, and the RefNeRF
orientation and predicted-normal losses, which need normals the ported
model does not predict (a multiplier > 0 raises).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import re
from typing import Dict, List, Optional, Tuple

import torch

from snerf_tpu_torch.data import sampler
from snerf_tpu_torch.models.hashgrid import hash_decay_loss
from snerf_tpu_torch.models.posenet import LearnPose
from snerf_tpu_torch.models.zipnerf import (ZipDraws, ZipNerfConfig,
                                            ZipNerfModel, make_zip_draws)
from snerf_tpu_torch.ops import math as smath
from snerf_tpu_torch.train import losses as L
from snerf_tpu_torch.utils.weights import zip_init_


@dataclasses.dataclass(frozen=True)
class ZipTrainConfig:
  """The zip-nerf schedule and loss set: the fields and defaults of the
  JAX ZipTrainConfig."""
  batch_size: int = 32768
  max_steps: int = 50_000
  lr_init: float = 0.01
  lr_final: float = 0.001
  lr_delay_steps: int = 5000
  lr_delay_mult: float = 1e-8
  adam_beta1: float = 0.9
  adam_beta2: float = 0.99
  adam_eps: float = 1e-15
  grad_max_norm: float = 0.001
  grad_max_val: float = 0.0
  data_loss_mult: float = 1.0
  charb_padding: float = 0.001
  anti_interlevel_loss_mult: float = 0.01
  pulse_width: Tuple[float, ...] = (0.03, 0.003)
  distortion_loss_mult: float = 0.005
  hash_decay_mult: float = 0.1
  depth_loss_mult: float = 0.0       # inverse-depth loss
  depth_complete: bool = False       # the Waymo masked-object depth term
  semantic_loss_mult: float = 0.04
  # patch_size > 1: a quarter of the batch is ps x ps patches, used only
  # by the smoothness losses
  patch_size: int = 1
  smoothness_loss_mult: float = 0.001
  semantic_smoothness_loss_mult: float = 0.001
  # RefNeRF regularisers: not ported, > 0 raises
  orientation_loss_mult: float = 0.0
  orientation_coarse_loss_mult: float = 0.0
  orientation_loss_target: str = "normals_pred"
  predicted_normal_loss_mult: float = 0.0
  predicted_normal_coarse_loss_mult: float = 0.0
  single_image: bool = False         # zip-nerf samples across all images
  randomized: bool = True
  # pose refinement with SGD inside the window (start, end) of steps
  pose_refine: bool = False
  pose_start_step: int = 1000
  pose_end_step: int = 10_000
  pose_lr: float = 1e-4
  # the encoder tables train at encoder_lr_mult x the schedule
  encoder_lr_mult: float = 1.0
  # > 0: CP level l's tables train at encoder_lr_mult x gamma^l, each
  # level its own Adam group; the hash arm keeps all its levels in one
  # table, which stays in the encoder group (as in JAX)
  encoder_level_lr_gamma: float = 0.0
  # norm clip of the encoder grads alone, before the global clip; 0 = off
  encoder_grad_max_norm: float = 0.0
  # EMA of the params (0 = off): d_t = min(d, (1+t)/(10+t))
  ema_decay: float = 0.0
  # pre-clip grad norms of the encoder and the rest in the metrics
  debug_grad_norms: bool = False


@dataclasses.dataclass
class ZipTrainState:
  """Step count, the model and its Adam (param groups "grid", "net" and
  the CP level groups, `make_zip_optimizer`),
  the pose model and its SGD when poses are refined, and the EMA copy of
  the model's parameters (by `named_parameters` name)."""
  step: int
  model: ZipNerfModel
  optimizer: torch.optim.Adam
  pose_model: Optional[LearnPose] = None
  pose_optimizer: Optional[torch.optim.SGD] = None
  ema: Optional[Dict[str, torch.Tensor]] = None


@dataclasses.dataclass
class ZipStepDraws:
  """The random draws of one step: the sampled pixels (img_idx, py, px,
  each [batch_size], the random pixels first, then the patch quarter) and
  the model's draws (None when the config is not randomized)."""
  img_idx: torch.Tensor
  py: torch.Tensor
  px: torch.Tensor
  model: Optional[ZipDraws] = None


@contextlib.contextmanager
def eval_weights(state):
  """The weights to render and evaluate with (the JAX `eval_params`): the
  EMA copy when maintained, swapped into the model for the duration of
  the block and swapped back after it. Any train state (a mip TrainState
  too)."""
  if state.ema is None:
    yield state.model
    return
  params = dict(state.model.named_parameters())

  def swap():
    with torch.no_grad():
      for name, e in state.ema.items():
        params[name].data, state.ema[name] = e, params[name].data

  swap()
  try:
    yield state.model
  finally:
    swap()


def make_zip_lr_schedule(cfg: ZipTrainConfig):
  """step -> the base learning rate (a float)."""
  decay = functools.partial(
      smath.learning_rate_decay, lr_init=cfg.lr_init, lr_final=cfg.lr_final,
      max_steps=cfg.max_steps, lr_delay_steps=cfg.lr_delay_steps,
      lr_delay_mult=cfg.lr_delay_mult)
  return lambda step: float(decay(step))


def _is_encoder(name: str) -> bool:
  """Whether a parameter trains in the encoder group, as the JAX labels
  go: the hash arm's tables (JAX subtree `grid`) and the CP tables
  (`cp_grid`). cp_hash's fine level `hash_fine` trains with the rest."""
  return name.endswith("encoder.embeddings") or ".cp_grid." in name


_CP_LEVEL = re.compile(r"\.cp_grid\.[vp](\d+)$")
_MAX_LEVEL_GROUP = 7   # JAX labels levels past 7 as level 7


def _group_of(name: str, cfg: ZipTrainConfig) -> str:
  """The Adam group of a parameter: "net", "grid", or with
  encoder_level_lr_gamma > 0 "grid{l}" for a CP level table."""
  if not _is_encoder(name):
    return "net"
  level = _CP_LEVEL.search(name)
  if cfg.encoder_level_lr_gamma > 0 and level is not None:
    return f"grid{min(int(level.group(1)), _MAX_LEVEL_GROUP)}"
  return "grid"


def _check_supported(cfg: ZipTrainConfig):
  if (cfg.orientation_loss_mult > 0 or cfg.orientation_coarse_loss_mult > 0
      or cfg.predicted_normal_loss_mult > 0
      or cfg.predicted_normal_coarse_loss_mult > 0):
    raise NotImplementedError("the orientation and predicted-normal losses "
                              "need predicted normals, not ported yet")


def _patch_split(cfg: ZipTrainConfig):
  """(n_pix, n_patches): the patch quarter of the batch, ps x ps patches
  appended after the random pixels."""
  ps = cfg.patch_size
  n_patches = (cfg.batch_size // 4) // (ps * ps) if ps > 1 else 0
  return cfg.batch_size - n_patches * ps * ps, n_patches


def make_zip_optimizer(model: ZipNerfModel,
                       cfg: ZipTrainConfig) -> torch.optim.Adam:
  """Adam over the model with optax's arithmetic: the encoder tables in
  the group "grid" at encoder_lr_mult x the schedule, the rest in "net";
  with encoder_level_lr_gamma > 0 each CP level l's tables in their own
  group "grid{l}" at encoder_lr_mult x gamma^l (JAX's `_make_tx`). The
  step sets each group's lr from its "lr_mult"."""
  groups: Dict[str, List[torch.nn.Parameter]] = {"grid": [], "net": []}
  for name, p in model.named_parameters():
    groups.setdefault(_group_of(name, cfg), []).append(p)
  gamma = cfg.encoder_level_lr_gamma

  def mult(group):
    if group == "net":
      return 1.0
    if group == "grid":
      return cfg.encoder_lr_mult
    return cfg.encoder_lr_mult * gamma ** int(group[4:])

  return torch.optim.Adam(
      [{"params": params, "name": group, "lr_mult": mult(group)}
       for group, params in groups.items()],
      lr=make_zip_lr_schedule(cfg)(0), betas=(cfg.adam_beta1, cfg.adam_beta2),
      eps=cfg.adam_eps)


def create_zip_train_state(seed: int, model_cfg: ZipNerfConfig,
                           cfg: ZipTrainConfig, num_images: int = 0,
                           device="cuda") -> ZipTrainState:
  """A seeded model (`zip_init_`), its Adam with the encoder tables in
  their own group, the EMA copy when ema_decay > 0, and the pose model
  (zero tables) with its SGD when pose_refine and num_images > 0."""
  _check_supported(cfg)
  model = zip_init_(ZipNerfModel(model_cfg, device=device), seed)
  state = ZipTrainState(step=0, model=model,
                        optimizer=make_zip_optimizer(model, cfg))
  if cfg.ema_decay > 0:
    state.ema = {n: p.detach().clone() for n, p in model.named_parameters()}
  if cfg.pose_refine and num_images > 0:
    state.pose_model = LearnPose(num_images, device=device)
    state.pose_optimizer = torch.optim.SGD(state.pose_model.parameters(),
                                           lr=cfg.pose_lr)
  return state


def draw_zip_step(model_cfg: ZipNerfConfig, cfg: ZipTrainConfig,
                  images: torch.Tensor, i_train,
                  generator: torch.Generator) -> ZipStepDraws:
  """The draws of one step from `generator`, on the images' device: the
  pixels as `sampler.draw_pixels` draws them, then the model's."""
  n_pix, n_patches = _patch_split(cfg)
  pixels = sampler.draw_pixels(images, i_train, n_pix, cfg.single_image,
                               n_patches, cfg.patch_size, generator)
  model_draws = None
  if cfg.randomized:
    model_draws = make_zip_draws(model_cfg, pixels[0].shape, generator)
  return ZipStepDraws(*pixels, model=model_draws)


def _in_window(step: int, cfg: ZipTrainConfig) -> bool:
  return cfg.pose_start_step < step < cfg.pose_end_step


def make_zip_train_step(model: ZipNerfModel, cfg: ZipTrainConfig,
                        device_scene: Dict[str, torch.Tensor], i_train,
                        near: float, far: float):
  """Build step(state, draws) -> metrics.

  `draws` is a torch.Generator on the scene's device, from which the step
  draws its pixels and the model's draws, or a ZipStepDraws. The metrics
  are detached scalar tensors: loss, loss_data, psnr and one per active
  loss.
  """
  _check_supported(cfg)
  mcfg = model.config
  init_poses = device_scene["poses"]
  cam_ids = torch.arange(init_poses.shape[0], device=init_poses.device)
  n_pix, n_patches = _patch_split(cfg)
  ps = cfg.patch_size
  # the hash-decay loss reads the hash arm's tables alone (JAX's
  # `_grid_specs`): not cp_hash's fine level
  specs = ([(m.encoder.embeddings, m.encoder.spec) for m in model.mlps()]
           if mcfg.encoder_type == "hash" else [])
  lr_at = make_zip_lr_schedule(cfg)
  pix_part = torch.arange(cfg.batch_size, device=init_poses.device) < n_pix

  def loss_fn(state: ZipTrainState, draws: ZipStepDraws, train_frac: float,
              depth_on: float):
    pose_table = init_poses
    if state.pose_model is not None:
      pose_table = state.pose_model(cam_ids, init_poses)
    rays, targets = sampler.sample_batch(
        device_scene, i_train, n_pix, near, far, use_pose_table=pose_table,
        img_idx=draws.img_idx, py=draws.py, px=draws.px)
    renderings, ray_history = model(
        rays, draws=draws.model if cfg.randomized else None,
        train_frac=train_frac)
    final = renderings[-1]

    # the data, depth and semantic losses leave out the object-masked
    # pixels and the patch quarter; the patches feed only the smoothness
    objmask = targets.get("skymask")     # True = masked (object / padding)
    mask_rgb = pix_part if objmask is None else (pix_part & ~objmask)
    data = L.charbonnier_loss(final["rgb"], targets["rgb"],
                              mask=mask_rgb[..., None],
                              padding=cfg.charb_padding)
    total = cfg.data_loss_mult * data
    metrics = {"loss_data": data,
               "psnr": smath.mse_to_psnr(L.masked_mean(
                   (final["rgb"] - targets["rgb"]) ** 2,
                   mask_rgb[..., None]))}

    if cfg.anti_interlevel_loss_mult > 0:
      c, w = ray_history[-1]["sdist"], ray_history[-1]["weights"]
      il = 0.0
      for i, rh in enumerate(ray_history[:-1]):
        il = il + L.interlevel_loss_anti(
            rh["sdist"], rh["weights"], c, w,
            blur_r=cfg.pulse_width[min(i, len(cfg.pulse_width) - 1)])
      il = il * cfg.anti_interlevel_loss_mult
      total = total + il
      metrics["loss_interlevel"] = il

    if cfg.distortion_loss_mult > 0:
      dist = L.distortion_loss(ray_history[-1]["sdist"],
                               ray_history[-1]["weights"],
                               weight=cfg.distortion_loss_mult)
      total = total + dist
      metrics["loss_distortion"] = dist

    if cfg.hash_decay_mult > 0 and specs:
      hd = sum(hash_decay_loss(table, spec, weight=1.0)
               for table, spec in specs) * cfg.hash_decay_mult
      total = total + hd
      metrics["loss_hash_decay"] = hd

    if cfg.depth_loss_mult > 0 and "depth" in targets:
      # inverse-depth L1 over unpatched, unmasked pixels with depth, off
      # inside the pose-refine window
      eps = 1e-5
      err = torch.abs(1.0 / (final["depth"] + eps)
                      - 1.0 / (targets["depth"] + eps))
      dl = L.masked_mean(err, (targets["depth"] > 0) & mask_rgb)
      total = total + cfg.depth_loss_mult * depth_on * dl
      metrics["loss_depth"] = dl
      if cfg.depth_complete and objmask is not None:
        # depth completion on masked objects, x depth_loss_mult x 0.2
        com_mask = (targets["depth"] > 0) & objmask & pix_part
        dcl = L.masked_mean(err, com_mask)
        total = total + cfg.depth_loss_mult * 0.2 * dcl
        metrics["loss_depth_complete"] = dcl

    if (cfg.semantic_loss_mult > 0 and "semantic" in targets
        and final.get("semantic") is not None):
      # NLL of the composited probabilities over mask_rgb; labels < 0 are
      # unlabelled
      probs = torch.clamp(final["semantic"], 1e-6, 1.0)
      lab = targets["semantic"].long()
      labeled = (lab >= 0) & mask_rgb
      nll = -torch.log(torch.gather(probs, -1,
                                    torch.clamp(lab, min=0)[..., None]))[..., 0]
      sl = cfg.semantic_loss_mult * L.masked_mean(nll, labeled)
      total = total + sl
      metrics["loss_semantic"] = sl

    if n_patches > 0:
      pshape = (n_patches, ps, ps)
      rgb_p = targets["rgb"][n_pix:].reshape(*pshape, 3)
      valid_p = None if objmask is None else (~objmask[n_pix:]).reshape(
          pshape)
      if cfg.smoothness_loss_mult > 0:
        sm = torch.nan_to_num(L.zip_smooth_loss(
            rgb_p, final["depth"][n_pix:].reshape(pshape), valid_p,
            weight=cfg.smoothness_loss_mult))
        total = total + sm
        metrics["loss_smooth"] = sm
      if (cfg.semantic_smoothness_loss_mult > 0
          and final.get("semantic") is not None):
        sem = final["semantic"]
        ssm = torch.nan_to_num(L.zip_semantic_smooth_loss(
            rgb_p, sem[n_pix:].reshape(*pshape, sem.shape[-1]), valid_p,
            weight=cfg.semantic_smoothness_loss_mult))
        total = total + ssm
        metrics["loss_semantic_smooth"] = ssm

    metrics["loss"] = total
    return total, metrics

  def step(state: ZipTrainState, draws) -> Dict[str, torch.Tensor]:
    if isinstance(draws, torch.Generator):
      draws = draw_zip_step(mcfg, cfg, device_scene["images"], i_train,
                            draws)
    pose_model = state.pose_model
    if cfg.pose_refine and pose_model is None:
      raise ValueError("pose_refine needs a state made with num_images > 0")
    named = list(model.named_parameters())
    pose_params = [] if pose_model is None else list(pose_model.parameters())
    for _, p in named:
      p.grad = None
    for p in pose_params:
      p.grad = None
    # train_frac as the JAX step forms it, in float32
    train_frac = float(torch.clamp(
        torch.tensor(state.step, dtype=torch.float32) / cfg.max_steps, 0, 1))
    depth_on = 0.0 if cfg.pose_refine and _in_window(state.step, cfg) \
        else 1.0
    total, metrics = loss_fn(state, draws, train_frac, depth_on)
    total.backward()

    # optax updates every leaf: a param autograd did not reach gets a
    # zero grad, not a skipped update
    for _, p in named:
      if p.grad is None:
        p.grad = torch.zeros_like(p)
    enc = [p.grad for n, p in named if _is_encoder(n)]
    net = [p.grad for n, p in named if not _is_encoder(n)]
    if cfg.debug_grad_norms:
      for label, gs in (("grid", enc), ("net", net)):
        metrics[f"gnorm_{label}"] = torch.sqrt(
            sum(torch.sum(torch.square(g)) for g in gs))
    if cfg.encoder_grad_max_norm > 0:
      with torch.no_grad():
        gn = torch.sqrt(sum(torch.sum(torch.square(g)) for g in enc))
        scale = torch.clamp(cfg.encoder_grad_max_norm / (gn + 1e-12),
                            max=1.0)
        for g in enc:
          g.mul_(scale)
    smath.clip_gradients(
        enc + net, max_val=cfg.grad_max_val if cfg.grad_max_val > 0 else None,
        max_norm=cfg.grad_max_norm if cfg.grad_max_norm > 0 else None)

    lr = lr_at(state.step)
    for group in state.optimizer.param_groups:
      group["lr"] = group["lr_mult"] * lr
    state.optimizer.step()
    state.step += 1
    if state.ema is not None:
      t = float(state.step)
      d = min(cfg.ema_decay, (1.0 + t) / (10.0 + t))
      with torch.no_grad():
        for name, p in named:
          state.ema[name].mul_(d).add_(p, alpha=1.0 - d)
    if pose_model is not None:
      # pose updates only inside the window, read at the new step
      gate = 1.0 if _in_window(state.step, cfg) else 0.0
      with torch.no_grad():
        for p in pose_params:
          if p.grad is None:
            p.grad = torch.zeros_like(p)
          torch.nan_to_num_(p.grad)
          p.grad.mul_(gate)
      state.pose_optimizer.step()
    return {k: v.detach() if torch.is_tensor(v) else torch.tensor(v)
            for k, v in metrics.items()}

  return step
