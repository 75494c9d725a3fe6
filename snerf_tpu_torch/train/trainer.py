"""S-NeRF mip training step (counterpart of snerf_tpu/train/trainer.py).

One step: refine the pose table, sample a ray batch on the device, run
the randomized forward, sum the loss set (rgb, proposal, smoothness,
semantic, depth), backpropagate (through K1's backward kernels on the
card), clip if asked, and apply Adam to the model (log-lerp schedule),
to the poses and to the confidence weights (constant lrs), then the
optional EMA. The JAX step is one jitted function of a PRNG key; here
the step runs eagerly and its random draws come from a torch.Generator
or are injected (`StepDraws`).

With `depth_conf` the depth loss is weighted per ray by the depth
confidence: the precomputed maps (`models/confidence.py`
`precompute_conf_maps`, uint8) at the ray's pixel, mixed by
sigmoid(lambda[mode, image]) of the state's `ConfidenceModel`, sky rays
at 1 when `use_skymask_conf`.

Adam matches optax's `adam`: betas (0.9, 0.999), eps 1e-8 outside the
square root, bias correction at the incremented count (in float64,
where optax forms it in float32: up to ~3e-5 relative on a first
update), and the schedule read at the count before the increment (the
lr of step 0 is lrate * lrate_delay_mult).

Not ported: the classic model's coarse rgb term, mesh sharding and the
`lax.scan` multi-step loop (a CUDA-graph loop is later work).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional

import torch

from snerf_tpu_torch.data import sampler
from snerf_tpu_torch.models.confidence import ConfidenceModel
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
  # depth confidence (reference --depth_conf; confidence.py:171-185)
  depth_conf: bool = False
  conf_num: int = 1
  conf_tau: float = 0.2
  conf_lrate: float = 1e-3
  conf_modes: tuple = ("rgb", "ssim", "depth")
  use_skymask_conf: bool = True
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
  conf_model: Optional[ConfidenceModel] = None
  conf_optimizer: Optional[torch.optim.Adam] = None


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


def create_train_state(seed: int, model_cfg: MipNerfConfig,
                       cfg: TrainConfig, num_images: int, init_poses=None,
                       device="cuda"):
  """A seeded model (glorot init), the pose model when pose_refine (its
  tables start at zero; init_poses is not read, as in the JAX version),
  the confidence model when depth_conf (its lambdas start at zero) and
  their optimizers. Returns (model, pose_model, state)."""
  del init_poses
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
  if cfg.depth_conf:
    state.conf_model = ConfidenceModel(cfg.conf_modes, num_images,
                                       device=device)
    state.conf_optimizer = adam(state.conf_model.parameters(),
                                cfg.conf_lrate)
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
                    i_train, near: float, far: float,
                    conf_maps: Optional[torch.Tensor] = None):
  """Build step(state, generator=None, draws=None) -> metrics.

  Each step draws from `generator` (a torch.Generator on the scene's
  device) unless `draws` (a StepDraws) is given. The metrics are
  detached scalar tensors: loss, loss_rgb, psnr and one per active loss.
  conf_maps: [n_train, n_modes, H, W] uint8 confidence maps (those of
  `precompute_conf_maps`) on the scene's device, read under depth_conf
  with the state's `conf_model`; without them the depth loss is
  unweighted.
  """
  init_poses = device_scene["poses"]
  num_images = init_poses.shape[0]
  cam_ids = torch.arange(num_images, device=init_poses.device)
  i_train = torch.as_tensor(i_train, dtype=torch.long,
                            device=init_poses.device)
  n_patches = cfg.n_patch if cfg.smooth_loss else 0
  lr_at = make_lr_schedule(cfg)
  i_train_pos = None
  if cfg.depth_conf and conf_maps is not None:
    want = (len(i_train), len(cfg.conf_modes))
    if (tuple(conf_maps.shape[:2]) != want
        or conf_maps.dtype != torch.uint8):
      raise ValueError(f"conf_maps {tuple(conf_maps.shape)} "
                       f"{conf_maps.dtype}: expected uint8 with "
                       f"[n_train, n_modes] = {list(want)} leading, modes "
                       f"{cfg.conf_modes}")
    # image id -> its position in i_train, the row of conf_maps
    i_train_pos = torch.zeros(num_images, dtype=torch.long,
                              device=init_poses.device)
    i_train_pos[i_train] = torch.arange(len(i_train),
                                        device=init_poses.device)

  def conf_weight(conf_model: ConfidenceModel, targets, draws: StepDraws):
    """The depth confidence of the step's n_rgb rays."""
    nr = cfg.n_rgb
    img_idx = draws.img_idx[:nr]
    # advanced indices around a slice: the ray axis comes first
    stack = conf_maps[i_train_pos[img_idx], :, draws.py[:nr],
                      draws.px[:nr]].float() / 255.0
    w = conf_model.combine(stack.T, img_idx)
    if cfg.use_skymask_conf and "skymask" in targets:
      # sky rays get confidence 1 (confidence.py:199-201)
      w = torch.where(targets["skymask"][:nr], torch.ones_like(w), w)
    return w

  def loss_fn(draws: StepDraws, conf_model: Optional[ConfidenceModel]):
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
      # depth 0 is masked out; sky pixels keep their clipped target
      weight = None
      if i_train_pos is not None and conf_model is not None:
        weight = conf_weight(conf_model, targets, draws)
      dl = L.depth_loss(fine["distance"][:nr], coarse["distance"][:nr],
                        targets["depth"][:nr], disparity=cfg.disparity_depth,
                        coarse_mult=cfg.coarse_depth_mult,
                        conf_weight=weight)
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
    others = [m for m in (pose_model, state.conf_model) if m is not None]
    for p in params + [p for m in others for p in m.parameters()]:
      p.grad = None
    total, metrics = loss_fn(draws, state.conf_model)
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
    if state.conf_model is not None:
      state.conf_optimizer.step()
    return {k: v.detach() for k, v in metrics.items()}

  return step
