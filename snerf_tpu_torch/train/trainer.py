"""S-NeRF mip training step (counterpart of snerf_tpu/train/trainer.py).

One step: refine the pose table, sample a ray batch on the device, run
the randomized forward, sum the loss set (rgb, proposal, smoothness,
semantic, depth), backpropagate (through K1's backward kernels on the
card), clip if asked, and apply Adam to the model (log-lerp schedule)
and to the poses (constant lr), then the optional EMA. The JAX step is
one jitted function of a PRNG key; here the step runs eagerly and its
random draws come from a torch.Generator or are injected (`StepDraws`).

Adam matches optax's `adam`: betas (0.9, 0.999), eps 1e-8 outside the
square root, bias correction at the incremented count, and the schedule
read at the count before the increment (the lr of step 0 is
lrate * lrate_delay_mult).

Not ported: the depth confidence (`depth_conf`, raises), the classic
model's coarse rgb term, mesh sharding and the `lax.scan` multi-step loop
(a CUDA-graph loop is later work).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional

import torch

from snerf_tpu_torch.data import sampler
from snerf_tpu_torch.models.mipnerf import (MipDraws, MipNerfConfig,
                                            MipNerfModel, make_draws)
from snerf_tpu_torch.models.posenet import LearnPose
from snerf_tpu_torch.ops import math as smath
from snerf_tpu_torch.train import losses as L
from snerf_tpu_torch.utils.weights import glorot_init_


@dataclasses.dataclass(frozen=True)
class TrainConfig:
  """Training hyperparameters, the fields and defaults of the JAX
  TrainConfig."""
  n_rgb: int = 4096                 # rays per step (N_rgb)
  n_iters: int = 200_000
  lrate: float = 5e-4
  lrate_final: float = 5e-6
  lrate_delay_steps: int = 2500
  lrate_delay_mult: float = 0.01
  single_image: bool = True         # SingleImage sampler semantics
  white_bkgd: bool = False
  randomized: bool = True
  # losses
  depth_loss: bool = False
  depth_lambda: float = 0.1
  disparity_depth: bool = False
  coarse_depth_mult: float = 0.1
  smooth_loss: bool = False
  smooth_lambda: float = 1.0
  n_patch: int = 8
  patch_sz: int = 8
  proposal_loss: bool = True
  proposal_lambda: float = 1.0
  semantic: bool = False
  semantic_lambda: float = 0.04
  # pose refinement
  pose_refine: bool = False
  pose_lrate: float = 1e-3
  # depth confidence: not ported, True raises
  depth_conf: bool = False
  # grad hygiene
  grad_max_norm: float = 0.0
  grad_max_val: float = 0.0
  # EMA of the params for eval (0 = off): d_t = min(d, (1+t)/(10+t))
  ema_decay: float = 0.0


@dataclasses.dataclass
class TrainState:
  """Step count, models, their Adam optimizers and the optional EMA copy
  of the model's parameters (by `named_parameters` name)."""
  step: int
  model: MipNerfModel
  optimizer: torch.optim.Adam
  pose_model: Optional[LearnPose] = None
  pose_optimizer: Optional[torch.optim.Adam] = None
  ema: Optional[Dict[str, torch.Tensor]] = None


@dataclasses.dataclass
class StepDraws:
  """The random draws of one step: the sampled pixels (img_idx, py, px,
  each [n_rgb + n_patch * patch_sz**2]) and the model's draws (None when
  the config is not randomized)."""
  img_idx: torch.Tensor
  py: torch.Tensor
  px: torch.Tensor
  model: Optional[MipDraws] = None


def make_lr_schedule(cfg: TrainConfig):
  """step -> the model's learning rate (a float)."""
  decay = functools.partial(
      smath.learning_rate_decay, lr_init=cfg.lrate,
      lr_final=cfg.lrate_final, max_steps=cfg.n_iters,
      lr_delay_steps=cfg.lrate_delay_steps,
      lr_delay_mult=cfg.lrate_delay_mult)
  return lambda step: float(decay(step))


def adam(params, lr: float) -> torch.optim.Adam:
  """Adam with optax's defaults (the trainer sets the lr every step)."""
  return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)


def _check_supported(cfg: TrainConfig):
  if cfg.depth_conf:
    raise NotImplementedError("depth_conf (the depth confidence model) is "
                              "not ported yet")


def create_train_state(seed: int, model_cfg: MipNerfConfig,
                       cfg: TrainConfig, num_images: int, init_poses=None,
                       device="cuda"):
  """A seeded model (glorot init), the pose model when pose_refine (its
  tables start at zero; init_poses is not read, as in the JAX version)
  and their optimizers. Returns (model, pose_model, state)."""
  del init_poses
  _check_supported(cfg)
  model = glorot_init_(MipNerfModel(model_cfg, device=device), seed)
  state = TrainState(step=0, model=model,
                     optimizer=adam(model.parameters(),
                                     make_lr_schedule(cfg)(0)))
  if cfg.ema_decay > 0:
    state.ema = {n: p.detach().clone() for n, p in model.named_parameters()}
  pose_model = None
  if cfg.pose_refine:
    pose_model = LearnPose(num_images, device=device)
    state.pose_model = pose_model
    state.pose_optimizer = adam(pose_model.parameters(), cfg.pose_lrate)
  return model, pose_model, state


def draw_step(model_cfg: MipNerfConfig, cfg: TrainConfig,
              images: torch.Tensor, i_train,
              generator: torch.Generator) -> StepDraws:
  """The draws of one step from `generator`, on the images' device: the
  pixels as `sampler.draw_pixels` draws them, then the model's."""
  n_patches = cfg.n_patch if cfg.smooth_loss else 0
  pixels = sampler.draw_pixels(images, i_train, cfg.n_rgb, cfg.single_image,
                               n_patches, cfg.patch_sz, generator)
  model_draws = None
  if cfg.randomized:
    model_draws = make_draws(model_cfg, pixels[0].shape, generator)
  return StepDraws(*pixels, model=model_draws)


def make_train_step(model: MipNerfModel, pose_model: Optional[LearnPose],
                    cfg: TrainConfig, device_scene: Dict[str, torch.Tensor],
                    i_train, near: float, far: float):
  """Build step(state, generator=None, draws=None) -> metrics.

  Each step draws from `generator` (a torch.Generator on the scene's
  device) unless `draws` (a StepDraws) is given. The metrics are
  detached scalar tensors: loss, loss_rgb, psnr and one per active loss.
  """
  _check_supported(cfg)
  init_poses = device_scene["poses"]
  num_images = init_poses.shape[0]
  cam_ids = torch.arange(num_images, device=init_poses.device)
  i_train = torch.as_tensor(i_train, dtype=torch.long,
                            device=init_poses.device)
  n_patches = cfg.n_patch if cfg.smooth_loss else 0
  lr_at = make_lr_schedule(cfg)

  def loss_fn(draws: StepDraws):
    pose_table = init_poses
    if pose_model is not None:
      pose_table = pose_model(cam_ids, init_poses)
    rays, targets = sampler.sample_batch(
        device_scene, i_train, cfg.n_rgb, near, far,
        use_pose_table=pose_table, img_idx=draws.img_idx, py=draws.py,
        px=draws.px)
    coarse, fine = model(rays, white_bkgd=cfg.white_bkgd,
                         draws=draws.model)[:2]

    nr = cfg.n_rgb
    rgb_tgt = targets["rgb"][:nr]
    img_loss = L.rgb_loss(fine["rgb"][:nr], rgb_tgt)
    total = img_loss
    metrics = {"loss_rgb": img_loss, "psnr": smath.mse_to_psnr(img_loss)}

    if cfg.proposal_loss and coarse.get("s_vals") is not None:
      pl = L.proposal_loss(fine["s_vals"], fine["weights"],
                           coarse["s_vals"], coarse["weights"],
                           weight=cfg.proposal_lambda)
      total = total + pl
      metrics["loss_proposal"] = pl

    if cfg.smooth_loss:
      ps = cfg.patch_sz
      n_sm = n_patches * ps * ps
      dist_sm = fine["distance"][nr:nr + n_sm].reshape(n_patches, ps, ps)
      rgb_sm = targets["rgb"][nr:nr + n_sm].reshape(n_patches, ps, ps, 3)
      sky_sm = None
      if "skymask" in targets:
        sky_sm = targets["skymask"][nr:nr + n_sm].reshape(n_patches, ps, ps)
      sl = L.edge_aware_smooth_loss(rgb_sm, dist_sm, sky_sm,
                                    weight=cfg.smooth_lambda)
      total = total + sl
      metrics["loss_smooth"] = sl

    if cfg.semantic and "semantic" in targets:
      sem_loss = L.semantic_loss(fine["semantic"][:nr],
                                 targets["semantic"][:nr],
                                 weight=cfg.semantic_lambda)
      total = total + sem_loss
      metrics["loss_semantic"] = sem_loss

    if cfg.depth_loss and "depth" in targets:
      dl = L.depth_loss(fine["distance"][:nr], coarse["distance"][:nr],
                        targets["depth"][:nr], disparity=cfg.disparity_depth,
                        coarse_mult=cfg.coarse_depth_mult)
      total = total + dl * cfg.depth_lambda
      metrics["loss_depth"] = dl

    metrics["loss"] = total
    return total, metrics

  def step(state: TrainState, generator: Optional[torch.Generator] = None,
           draws: Optional[StepDraws] = None) -> Dict[str, torch.Tensor]:
    if draws is None:
      if generator is None:
        raise ValueError("step needs a generator or injected draws")
      draws = draw_step(model.config, cfg, device_scene["images"], i_train,
                        generator)
    params = list(model.parameters())
    pose_params = [] if pose_model is None else list(pose_model.parameters())
    for p in params + pose_params:
      p.grad = None
    total, metrics = loss_fn(draws)
    total.backward()

    if cfg.grad_max_val > 0 or cfg.grad_max_norm > 0:
      smath.clip_gradients(
          [p.grad for p in params if p.grad is not None],
          max_val=cfg.grad_max_val if cfg.grad_max_val > 0 else None,
          max_norm=cfg.grad_max_norm if cfg.grad_max_norm > 0 else None)

    for group in state.optimizer.param_groups:
      group["lr"] = lr_at(state.step)
    state.optimizer.step()
    state.step += 1
    if state.ema is not None:
      t = float(state.step)
      d = min(cfg.ema_decay, (1.0 + t) / (10.0 + t))
      with torch.no_grad():
        for name, p in model.named_parameters():
          state.ema[name].mul_(d).add_(p, alpha=1.0 - d)
    if pose_model is not None:
      state.pose_optimizer.step()
    return {k: v.detach() for k, v in metrics.items()}

  return step
