"""The port's zip-nerf train step against snerf_tpu's make_zip_train_step.

Both start from the same numbers: the JAX `create_zip_train_state` makes
the params (hash tables scaled from +-1e-4 to +-1, so that the gathered
rows move the loss), which cross over through
`zip_train_state_from_flax`. JAX PRNG streams cannot be reproduced in
torch, so the JAX step's own draws are replayed from its key (the
k_sample / k_model split of zip_trainer.py loss_fn, the pixel draws of
sampler.sample_batch, the model's split(k_model, 2 levels) of zipnerf.py
`__call__`: jitter and background from keys[2 i], rotation and density
noise from keys[2 i + 1]) and injected into the port as a ZipStepDraws.
The JAX gradients come from the step's own `loss_fn`, taken from the
closure of the function `make_zip_train_step` jits.

Tolerances, float32 on the CPU on both sides: the loss and each metric
within 1e-5 relative (summation order, plus the resampling, which moves
continuously with a ~1e-7 change of a proposal weight); every gradient,
the hash tables' included, within 1e-4 of the largest entry of its tensor
(the scatter-add and the blends sum in another order than XLA); the
updates as `_assert_update_matches` says; a 3-step loss trajectory within
1e-4 relative. Adam: optax forms the bias corrections 1 - beta^t in
float32, torch in float64; with beta2 = 0.99, 1 - 0.99 is ~6e-6 off in
float32, so the updates agree to 1e-6 with optax's formula in float64 and
to 2e-5 with optax itself (test_adam_matches_optax).

The step with the pose window and the EMA, and the randomized forward
with density noise and a random background, are held against JAX in
tests/test_torch_zip_trainer_branches.py, on the helpers of this file.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from snerf_tpu.data import sampler as jsampler
from snerf_tpu.data import synthetic as jsynthetic
from snerf_tpu.models.zipnerf import ZipNerfConfig as JaxModelConfig
from snerf_tpu.models.zipnerf import ZipNerfModel as JaxModel
from snerf_tpu.train import zip_trainer as jtrainer
from snerf_tpu.utils.ref_import import map_zip_state_dict
from snerf_tpu_torch.data import sampler, synthetic
from snerf_tpu_torch.models.zipnerf import ZipDraws, ZipNerfConfig
from snerf_tpu_torch.train import zip_trainer as trainer
from snerf_tpu_torch.utils.weights import zip_train_state_from_flax

# the TINY_MODEL widths of tests/test_zip_trainer.py, with semantics
MODEL = dict(num_prop_samples=(8, 8), num_nerf_samples=8,
             prop_grid_resolutions=(64, 128), nerf_grid_resolution=256,
             grid_num_levels=4, grid_log2_hashmap_size=12,
             bottleneck_width=32, net_width_viewdirs=16, sample_n=3,
             raydist_fn="power_transformation", use_semantic=True,
             class_num=5)
# the waymo_zipnerf loss set at a tiny batch: patch quarter, depth
# completion on the masked corner, semantics; the encoder group at twice
# the lr with its own clip, and the grad-norm metrics
BASE = dict(batch_size=96, max_steps=100, lr_delay_steps=0,
            depth_loss_mult=0.01, depth_complete=True, patch_size=4,
            encoder_lr_mult=2.0, encoder_grad_max_norm=1e-4,
            debug_grad_norms=True)
# the pose window (open from step 0) and the EMA
POSE_EMA = dict(BASE, pose_refine=True, pose_start_step=0, pose_end_step=50,
                pose_lr=1e-3, ema_decay=0.9, encoder_lr_mult=1.0,
                encoder_grad_max_norm=0.0, debug_grad_norms=False)
H, W = 16, 16
TABLE_SCALE = 1e4


def _np(tree):
  return jax.tree_util.tree_map(np.asarray, tree)


def _scene(pkg):
  scene = pkg.make_synthetic_scene(num_images=6, H=H, W=W, datahold=6,
                                   n_render_samples=16)
  scene.semantics = np.clip((scene.depths / scene.far * 4).astype(np.int32),
                            0, 4)
  mask = np.zeros(scene.images.shape[:3], bool)
  mask[:, :4, :4] = True            # an object mask on a corner
  scene.skymask = mask
  return scene


def _level_samples(mcfg):
  return list(mcfg.num_prop_samples) + [mcfg.num_nerf_samples]


def _model_draws(k_model, mcfg, batch):
  """The JAX model's draws from k_model (zipnerf.py __call__)."""
  keys = jax.random.split(k_model, 2 * mcfg.num_levels)
  jitter, rotation, noise, bg = [], [], [], []
  for i, s in enumerate(_level_samples(mcfg)):
    jitter.append(jax.random.uniform(keys[2 * i], (batch, 1)))
    rotation.append(jax.random.uniform(keys[2 * i + 1],
                                       (batch, s, mcfg.sample_n)))
    noise.append(jax.random.normal(keys[2 * i + 1], (batch, s)))
    bg.append(jax.random.uniform(keys[2 * i], (batch, 3)))
  return jitter, rotation, noise, bg


def _to_zip_draws(jitter, rotation, noise, bg, mcfg):
  lo, hi = mcfg.bg_intensity_range
  t = lambda xs: [torch.tensor(np.asarray(x)) for x in xs]
  return ZipDraws(jitter=t(jitter), rotation=t(rotation),
                  noise=t(noise) if mcfg.density_noise > 0 else None,
                  bg=None if lo == hi else t(bg))


@functools.lru_cache(maxsize=None)
def _jax_draw_fn(tcfg, mcfg, i_train, near, far):
  """jit(key, scene -> the draws the JAX step makes from key)."""
  n_pix, n_patches = trainer._patch_split(tcfg)

  @jax.jit
  def draw(key, jdev):
    k_sample, k_model = jax.random.split(key)
    _, targets = jsampler.sample_batch(
        k_sample, jdev, jnp.asarray(i_train), n_pix, near, far,
        single_image=tcfg.single_image, n_patches=n_patches,
        patch_size=tcfg.patch_size)
    return ((targets["img_idx"], targets["py"], targets["px"]),
            _model_draws(k_model, mcfg, tcfg.batch_size))

  return draw


def _jax_draws(key, jtcfg, jmcfg, jdev, scene):
  draw = _jax_draw_fn(jtcfg, jmcfg, tuple(int(i) for i in scene.i_train),
                      scene.near, scene.far)
  (img_idx, py, px), model = _np(draw(key, jdev))
  return trainer.ZipStepDraws(
      img_idx=torch.tensor(img_idx), py=torch.tensor(py),
      px=torch.tensor(px), model=_to_zip_draws(*model, jmcfg))


@functools.lru_cache(maxsize=None)
def _setup(variant):
  train = {"base": BASE, "pose_ema": POSE_EMA}[variant]
  scene, jscene = _scene(synthetic), _scene(jsynthetic)
  jdev = jsampler.scene_to_device(jscene)
  tdev = sampler.scene_to_device(scene, "cpu")
  jtcfg = jtrainer.ZipTrainConfig(**train)
  jmcfg = JaxModelConfig(**MODEL)
  # init under jit: eager flax init compiles op by op
  jstate = jax.jit(lambda k: jtrainer.create_zip_train_state(
      k, jmcfg, jtcfg, num_images=scene.num_images)[1])(
          jax.random.PRNGKey(0))
  params = _np(jstate.params)
  for mlp in params.values():
    mlp["grid"]["table"] = mlp["grid"]["table"] * TABLE_SCALE
  jstate = jstate.replace(params=jax.tree_util.tree_map(jnp.asarray, params))
  if jstate.ema_params is not None:
    jstate = jstate.replace(ema_params=jax.tree_util.tree_map(jnp.copy,
                                                              jstate.params))
  jstep = jtrainer.make_zip_train_step(
      JaxModel(config=jmcfg), jmcfg, jtcfg, jdev, scene.i_train, scene.near,
      scene.far, donate=False)
  train_step = jstep.func.__wrapped__
  cells = dict(zip(train_step.__code__.co_freevars,
                   (c.cell_contents for c in train_step.__closure__)))
  loss_fn = cells["loss_fn"]
  jgrad = jax.jit(jax.value_and_grad(
      lambda p, pp, key, dev: loss_fn(dev, p, pp, key, 0.0, 1.0),
      argnums=(0, 1), has_aux=True))
  return scene, jdev, tdev, jstate, jstep, jgrad, jtcfg, jmcfg, train


def _port_state(jstate, scene, tdev, train):
  tcfg = trainer.ZipTrainConfig(**train)
  mcfg = ZipNerfConfig(**MODEL)
  state = trainer.create_zip_train_state(1, mcfg, tcfg, scene.num_images)
  zip_train_state_from_flax(
      state, _np(jstate.params),
      None if jstate.pose_params is None else _np(jstate.pose_params),
      None if jstate.ema_params is None else _np(jstate.ema_params))
  step = trainer.make_zip_train_step(state.model, tcfg, tdev, scene.i_train,
                                     scene.near, scene.far)
  return state, step, tcfg


def _flax_tree(named):
  return map_zip_state_dict({n: t.detach().numpy().copy() for n, t in named})


def _assert_metrics_close(got, want, rtol):
  assert set(got) == set(want)
  for k in want:
    np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=rtol,
                               err_msg=k)


def _assert_tree_close(got, want, what, frac):
  """Leafwise max|got - want| <= frac * max|want|."""
  flat_got = jax.tree_util.tree_leaves_with_path(got)
  flat_want = dict(jax.tree_util.tree_leaves_with_path(want))
  assert len(flat_got) == len(flat_want)
  for path, g in flat_got:
    w = np.asarray(flat_want[path])
    err = float(np.abs(np.asarray(g) - w).max())
    assert err <= frac * float(np.abs(w).max()), (
        what, jax.tree_util.keystr(path), err, float(np.abs(w).max()))


def _assert_update_matches(new, old, jnew, jold, grads, step_size, what):
  """The step's update (new - old) against JAX's, leaf by leaf.

  step_size(path) is the leaf's first-step Adam move: an entry moves by
  ~step_size * sign(-grad) (eps is 1e-15). Wherever |grad| > 1e-3 *
  max|grad| the update has the sign of -grad and of JAX's update and lies
  within step_size / 4 of JAX's (a missing or reversed step is off by
  step_size or 2 step_size); everywhere within 2 step_size (an entry with
  a grad at rounding level may flip).
  """
  new, old = (dict(jax.tree_util.tree_leaves_with_path(t)) for t in (new, old))
  jnew, jold = (dict(jax.tree_util.tree_leaves_with_path(t))
                for t in (jnew, jold))
  flat_grads = jax.tree_util.tree_leaves_with_path(grads)
  assert len(flat_grads) == len(new) == len(jnew)
  for path, g in flat_grads:
    where = (what, jax.tree_util.keystr(path))
    size = step_size(jax.tree_util.keystr(path))
    g = np.asarray(g)
    upd = np.asarray(new[path], np.float64) - np.asarray(old[path])
    jupd = np.asarray(jnew[path], np.float64) - np.asarray(jold[path])
    assert np.abs(upd - jupd).max() <= 2 * size, where
    if not np.abs(g).max() > 0:
      continue
    big = np.abs(g) > 1e-3 * np.abs(g).max()
    assert (np.sign(upd[big]) == -np.sign(g[big])).all(), where
    assert (np.sign(jupd[big]) == -np.sign(g[big])).all(), where
    assert np.abs(upd - jupd)[big].max() <= 0.25 * size, where


def check_one_step(variant):
  """Loss, metrics, every grad (tables included), the updates of the
  params (per param group), and in the pose_ema variant the pose grads,
  the pose update inside the window and the EMA update."""
  scene, jdev, tdev, jstate, jstep, jgrad, jtcfg, jmcfg, train = _setup(
      variant)
  state, step, tcfg = _port_state(jstate, scene, tdev, train)
  key = jax.random.PRNGKey(7)
  draws = _jax_draws(key, jtcfg, jmcfg, jdev, scene)

  (_, jmetrics), (jgrads, jpose_grads) = jgrad(jstate.params,
                                               jstate.pose_params, key, jdev)
  jnext, jstep_metrics = jstep(jstate, key)
  old = _flax_tree(state.model.named_parameters())
  old_ema = None if state.ema is None else _flax_tree(state.ema.items())
  old_pose = None if state.pose_model is None else {
      k: getattr(state.pose_model, k).detach().clone().numpy() for k in "rt"}

  metrics = step(state, draws)
  _assert_metrics_close(metrics, jstep_metrics, 1e-5)
  want_keys = {"loss", "loss_data", "psnr", "loss_interlevel",
               "loss_distortion", "loss_hash_decay", "loss_depth",
               "loss_depth_complete", "loss_semantic", "loss_smooth",
               "loss_semantic_smooth"}
  if train["debug_grad_norms"]:
    want_keys |= {"gnorm_grid", "gnorm_net"}
  assert set(metrics) == want_keys
  # the grads as they stood before the clipping, against JAX's loss_fn
  _assert_metrics_close({k: metrics[k] for k in jmetrics}, jmetrics, 1e-5)

  lr = tcfg.lr_init     # lr_delay_steps 0: the schedule starts at lr_init
  size = lambda path: lr * (tcfg.encoder_lr_mult if "grid" in path else 1.0)
  new = _flax_tree(state.model.named_parameters())
  _assert_update_matches(new, old, jnext.params, jstate.params, jgrads, size,
                         "params")
  assert state.step == int(jnext.step) == 1
  if variant == "pose_ema":
    pose = state.pose_model
    _assert_tree_close({k: getattr(pose, k).grad.numpy() for k in "rt"},
                       jpose_grads, "pose grad", frac=1e-4)
    img = set(draws.img_idx.tolist())
    assert float(pose.r.grad[sorted(img)].abs().max()) > 0
    # SGD inside the window: the update is -pose_lr x grad
    _assert_tree_close(
        {k: getattr(pose, k).detach().numpy() - old_pose[k] for k in "rt"},
        {k: np.asarray(jnext.pose_params[k]) - np.asarray(
            jstate.pose_params[k]) for k in "rt"}, "pose update", frac=1e-4)
    d = min(tcfg.ema_decay, 2.0 / 11.0)
    _assert_update_matches(
        _flax_tree(state.ema.items()), old_ema, jnext.ema_params,
        jstate.ema_params, jgrads, lambda p: (1.0 - d) * size(p), "ema")
  else:
    # the same grads, read before the step's clipping
    _assert_tree_close(_flax_tree((n, p.grad) for n, p in
                                  state.model.named_parameters()),
                       jtrainer_clip(jgrads, tcfg), "model grad", frac=1e-4)


def jtrainer_clip(grads, tcfg):
  """JAX's grads after the step's encoder and global clipping (what the
  port's p.grad holds after a step)."""
  from snerf_tpu.ops import math as jmath
  enc = jnp.sqrt(sum(jnp.sum(jnp.square(m["grid"]["table"]))
                     for m in grads.values()))
  s = jnp.minimum(1.0, tcfg.encoder_grad_max_norm / (enc + 1e-12))
  scaled = {k: dict(m, grid={"table": m["grid"]["table"] * s})
            for k, m in grads.items()}
  return jmath.clip_gradients(scaled, max_norm=tcfg.grad_max_norm)


def test_one_step_matches_jax():
  check_one_step("base")


def test_pre_clip_grads_match_jax():
  """Every gradient of the loss, the hash tables' included, within 1e-4
  of its tensor's max, before any clipping: the backward alone."""
  scene, jdev, tdev, jstate, _, jgrad, jtcfg, jmcfg, train = _setup("base")
  state, _, tcfg = _port_state(jstate, scene, tdev, train)
  key = jax.random.PRNGKey(11)
  draws = _jax_draws(key, jtcfg, jmcfg, jdev, scene)
  (jloss, _), (jgrads, _) = jgrad(jstate.params, jstate.pose_params, key,
                                  jdev)
  model = state.model
  rays, targets = sampler.sample_batch(tdev, scene.i_train, 0, scene.near,
                                       scene.far, img_idx=draws.img_idx,
                                       py=draws.py, px=draws.px)
  # the step's own loss function, without the optimizer
  step = trainer.make_zip_train_step(
      model, dataclasses.replace(tcfg, grad_max_norm=0.0,
                                 encoder_grad_max_norm=0.0,
                                 lr_init=1e-30, lr_final=1e-30),
      tdev, scene.i_train, scene.near, scene.far)
  metrics = step(state, draws)
  np.testing.assert_allclose(float(metrics["loss"]), float(jloss), rtol=1e-5)
  grads = _flax_tree((n, p.grad) for n, p in model.named_parameters())
  _assert_tree_close(grads, jgrads, "model grad", frac=1e-4)
  assert rays.origins.shape == (tcfg.batch_size, 3)
  assert targets["skymask"].any() and not targets["skymask"].all()


def test_three_step_trajectory_matches_jax():
  scene, jdev, tdev, jstate, jstep, _, jtcfg, jmcfg, train = _setup("base")
  state, step, _ = _port_state(jstate, scene, tdev, train)
  for i in range(3):
    key = jax.random.PRNGKey(100 + i)
    draws = _jax_draws(key, jtcfg, jmcfg, jdev, scene)
    jstate, jmetrics = jstep(jstate, key)
    metrics = step(state, draws)
    for k in ("loss", "loss_data", "loss_interlevel", "loss_semantic",
              "loss_hash_decay"):
      np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]),
                                 rtol=1e-4, err_msg=f"step {i} {k}")


def test_adam_matches_optax():
  """The trainer's Adam (betas (0.9, 0.99), eps 1e-15, two param groups
  with the encoder's lr multiplier) against optax's multi_transform on
  identical grads over three steps. Against optax's formula in float64:
  1e-6 of the update; against optax itself 2e-5, its float32 bias
  corrections. The params start at zero, so that they hold only the
  updates."""
  cfg = trainer.ZipTrainConfig(lr_delay_steps=2, max_steps=10,
                               encoder_lr_mult=3.0)
  jcfg = jtrainer.ZipTrainConfig(**dataclasses.asdict(cfg))
  rng = np.random.RandomState(0)
  grads = [{"grid": rng.normal(size=(6, 2)).astype(np.float32) * 10 ** -i,
            "net": rng.normal(size=(5, 3)).astype(np.float32) * 10 ** -i}
           for i in range(3)]
  params = {"m": {"grid": {"table": jnp.zeros((6, 2))},
                  "dense": {"kernel": jnp.zeros((5, 3))}}}
  tx = jtrainer._make_tx(jcfg)
  opt = tx.init(params)
  tgrid = torch.nn.Parameter(torch.zeros(6, 2))
  tnet = torch.nn.Parameter(torch.zeros(5, 3))
  lr_at = trainer.make_zip_lr_schedule(cfg)
  adam = torch.optim.Adam(
      [{"params": [tgrid], "lr_mult": cfg.encoder_lr_mult},
       {"params": [tnet], "lr_mult": 1.0}],
      lr=lr_at(0), betas=(cfg.adam_beta1, cfg.adam_beta2), eps=cfg.adam_eps)
  ref = {k: np.zeros_like(g) for k, g in grads[0].items()}
  mu = {k: np.zeros(g.shape) for k, g in grads[0].items()}
  nu = {k: np.zeros(g.shape) for k, g in grads[0].items()}
  jlr = jtrainer.make_zip_lr_schedule(jcfg)
  for i, g in enumerate(grads):
    jg = {"m": {"grid": {"table": jnp.asarray(g["grid"])},
                "dense": {"kernel": jnp.asarray(g["net"])}}}
    updates, opt = tx.update(jg, opt, params)
    params = optax.apply_updates(params, updates)
    tgrid.grad, tnet.grad = (torch.from_numpy(g[k]) for k in ("grid", "net"))
    for group in adam.param_groups:
      group["lr"] = group["lr_mult"] * lr_at(i)
    adam.step()
    for k, mult in (("grid", cfg.encoder_lr_mult), ("net", 1.0)):
      g64 = g[k].astype(np.float64)
      mu[k] = 0.9 * mu[k] + 0.1 * g64
      nu[k] = 0.99 * nu[k] + 0.01 * g64 ** 2
      m_hat, v_hat = mu[k] / (1 - 0.9 ** (i + 1)), nu[k] / (1 - 0.99 ** (i + 1))
      ref[k] = ref[k] - mult * float(jlr(i)) * m_hat / (np.sqrt(v_hat) + 1e-15)
    for k, got, want in (
        ("grid", tgrid, params["m"]["grid"]["table"]),
        ("net", tnet, params["m"]["dense"]["kernel"])):
      scale = float(np.abs(ref[k]).max())
      np.testing.assert_allclose(got.detach().numpy(), ref[k], rtol=0,
                                 atol=1e-6 * scale, err_msg=f"{k} {i} f64")
      np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                 rtol=0, atol=2e-5 * scale,
                                 err_msg=f"{k} {i} optax")


def test_patch_sampler_matches_jax():
  """sample_batch with single_image False and the patch quarter, on the
  JAX step's own pixel draws: the same rays and targets, and each patch
  a ps x ps square on the image of the random pixel it follows."""
  scene, jdev, tdev, _, _, _, jtcfg, jmcfg, _ = _setup("base")
  n_pix, n_patches = trainer._patch_split(jtcfg)
  ps = jtcfg.patch_size
  key = jax.random.PRNGKey(3)
  k_sample, _ = jax.random.split(key)
  jrays, jtargets = jsampler.sample_batch(
      k_sample, jdev, jnp.asarray(scene.i_train), n_pix, scene.near,
      scene.far, single_image=False, n_patches=n_patches, patch_size=ps)
  rays, targets = sampler.sample_batch(
      tdev, scene.i_train, n_pix, scene.near, scene.far,
      img_idx=torch.tensor(np.asarray(jtargets["img_idx"])),
      py=torch.tensor(np.asarray(jtargets["py"])),
      px=torch.tensor(np.asarray(jtargets["px"])))
  for k in ("origins", "directions", "viewdirs", "radii", "near", "far"):
    np.testing.assert_allclose(getattr(rays, k).numpy(),
                               np.asarray(getattr(jrays, k)), atol=1e-6,
                               err_msg=k)
  for k in ("rgb", "depth", "semantic", "skymask", "img_idx"):
    np.testing.assert_array_equal(targets[k].numpy(),
                                  np.asarray(jtargets[k]), err_msg=k)
  img = targets["img_idx"].numpy()
  py = targets["py"].numpy()[n_pix:].reshape(n_patches, ps, ps)
  px = targets["px"].numpy()[n_pix:].reshape(n_patches, ps, ps)
  np.testing.assert_array_equal(img[n_pix:].reshape(n_patches, -1),
                                np.repeat(img[:n_patches, None], ps * ps, 1))
  np.testing.assert_array_equal(py - py[:, :1, :1],
                                np.broadcast_to(np.arange(ps)[:, None],
                                                py.shape))
  np.testing.assert_array_equal(px - px[:, :1, :1],
                                np.broadcast_to(np.arange(ps)[None], px.shape))
  # and the port's own draws keep that layout
  gen = torch.Generator().manual_seed(0)
  draws = trainer.draw_zip_step(ZipNerfConfig(**MODEL),
                                trainer.ZipTrainConfig(**BASE),
                                tdev["images"], scene.i_train, gen)
  assert draws.img_idx.shape == (BASE["batch_size"],)
  np.testing.assert_array_equal(
      draws.img_idx[n_pix:].reshape(n_patches, -1).numpy(),
      np.repeat(draws.img_idx[:n_patches, None].numpy(), ps * ps, 1))


def test_unported_losses_raise():
  with pytest.raises(NotImplementedError):
    trainer.create_zip_train_state(
        0, ZipNerfConfig(**MODEL),
        trainer.ZipTrainConfig(orientation_loss_mult=0.1))
