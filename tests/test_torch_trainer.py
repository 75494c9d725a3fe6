"""The port's mip train step against snerf_tpu's make_train_step.

Both start from the same numbers: the JAX `create_train_state` makes the
params, which cross over through `train_state_from_flax`. JAX PRNG
streams cannot be reproduced in torch, so the JAX step's own draws are
replayed from its key (the key split of trainer.py loss_fn, the pixel
draws of sampler.sample_batch, the model's keys[0..2] of
mipnerf.py:126,180) and injected into the port as a StepDraws. The JAX
gradients come from the step's own `loss_fn`, taken from the closure of
the function `make_train_step` jits.

Tolerances, float32 on the CPU on both sides: the loss and each metric
within 1e-5 relative (summation order, ~1e-7, plus the resample bracket,
which can take a neighbouring bin for a ~1e-7 change of a coarse weight
but interpolates continuously); each gradient within 1e-4 of the largest
entry of its tensor (the backward sums over up to 5k rows in another
order than XLA); Adam as in test_adam_matches_optax; a 3-step loss
trajectory within 1e-4 relative.
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
from snerf_tpu.models.mipnerf import MipNerfConfig as JaxModelConfig
from snerf_tpu.models.mipnerf import MipNerfModel as JaxModel
from snerf_tpu.models.posenet import LearnPose
from snerf_tpu.train import trainer as jtrainer
from snerf_tpu.utils.ref_import import map_mip_state_dict
from snerf_tpu_torch.data import sampler, synthetic
from snerf_tpu_torch.models.mipnerf import MipDraws, MipNerfConfig
from snerf_tpu_torch.train import trainer
from snerf_tpu_torch.utils.weights import train_state_from_flax

MODEL = dict(num_samples=8, num_fine=8, hidden_layer=64,
             proposal_hidden_layer=32, ray_shape="cone",
             no_warp_sample=False, warp_fn=1, t_transform="log",
             max_deg_point=16, rgb_layer=3, density_noise=1.0)
# the nuScenes_depth_6cams loss set, narrowed, with the patch smoothness
# term on as well
TRAIN = dict(n_rgb=48, depth_loss=True, depth_lambda=0.2,
             disparity_depth=True, coarse_depth_mult=0.1, smooth_loss=True,
             smooth_lambda=0.02, n_patch=2, patch_sz=4, proposal_loss=True,
             pose_refine=True, ema_decay=0.9)
H, W = 16, 20


def _np(tree):
  return jax.tree_util.tree_map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _jax_draw_fn(tcfg, mcfg, i_train, near, far):
  """jit(key, scene -> the draws the JAX step makes from key)."""
  n_patches = tcfg.n_patch if tcfg.smooth_loss else 0
  batch = tcfg.n_rgb + n_patches * tcfg.patch_sz ** 2
  n_fine = mcfg.num_fine_intervals

  @jax.jit
  def draw(key, jdev):
    k_sample, k_model = jax.random.split(key)
    _, targets = jsampler.sample_batch(
        k_sample, jdev, jnp.asarray(i_train), tcfg.n_rgb, near, far,
        single_image=tcfg.single_image, n_patches=n_patches,
        patch_size=tcfg.patch_sz)
    keys = jax.random.split(k_model, 4)
    noise = [jax.random.normal(jax.random.fold_in(keys[2], lvl),
                               (batch, mcfg.num_samples if lvl == 0
                                else n_fine))
             for lvl in range(mcfg.num_levels)]
    return (targets["img_idx"], targets["py"], targets["px"],
            jax.random.uniform(keys[0], (batch, mcfg.num_samples + 1)),
            jax.random.uniform(keys[1], (batch, n_fine + 1)), noise)

  return draw


def _jax_draws(key, tcfg, mcfg, jdev, i_train, near, far):
  """The draws the JAX step makes from `key`, as a port StepDraws."""
  draw = _jax_draw_fn(tcfg, mcfg, tuple(int(i) for i in i_train), near, far)
  img_idx, py, px, strat, res, noise = _np(draw(key, jdev))
  return trainer.StepDraws(
      img_idx=torch.tensor(img_idx), py=torch.tensor(py),
      px=torch.tensor(px),
      model=MipDraws(stratified=torch.tensor(strat),
                     resample=torch.tensor(res),
                     noise=[torch.tensor(n) for n in noise]))


@pytest.fixture(scope="module")
def setup():
  scene = synthetic.make_synthetic_scene(num_images=6, H=H, W=W,
                                         n_render_samples=16)
  jscene = jsynthetic.make_synthetic_scene(num_images=6, H=H, W=W,
                                           n_render_samples=16)
  jdev = jsampler.scene_to_device(jscene)
  tdev = sampler.scene_to_device(scene, "cpu")
  jtcfg = jtrainer.TrainConfig(**TRAIN)
  jmcfg = JaxModelConfig(**MODEL)
  # init under jit: eager flax init and eager steps compile op by op
  jstate = jax.jit(lambda k: jtrainer.create_train_state(
      k, jmcfg, jtcfg, scene.num_images)[2])(jax.random.PRNGKey(0))
  jmodel, jpose = JaxModel(config=jmcfg), LearnPose(num_cams=scene.num_images)
  jstep = jtrainer.make_train_step(jmodel, jpose, jtcfg, jdev,
                                   scene.i_train, scene.near, scene.far,
                                   donate=False)
  # the step's own loss, from the closure of the function it jits
  train_step = jstep.func.__wrapped__
  cells = dict(zip(train_step.__code__.co_freevars,
                   (c.cell_contents for c in train_step.__closure__)))
  loss_fn = cells["loss_fn"]
  jgrad = jax.jit(jax.value_and_grad(
      lambda p, pp, key, dev: loss_fn(dev, None, p, pp, None, key),
      argnums=(0, 1), has_aux=True))
  return scene, jdev, tdev, jstate, jstep, functools.partial(
      jgrad, jstate.params, jstate.pose_params)


def _port_state(jstate, scene, tdev):
  tcfg = trainer.TrainConfig(**TRAIN)
  mcfg = MipNerfConfig(**MODEL)
  model, pose, state = trainer.create_train_state(1, mcfg, tcfg,
                                                  scene.num_images,
                                                  device="cpu")
  model_sd, pose_sd = train_state_from_flax(_np(jstate.params),
                                            _np(jstate.pose_params))
  model.load_state_dict(model_sd)
  pose.load_state_dict(pose_sd)
  state.ema = {n: p.detach().clone() for n, p in model.named_parameters()}
  step = trainer.make_train_step(model, pose, tcfg, tdev, scene.i_train,
                                 scene.near, scene.far)
  return model, pose, state, step, mcfg, tcfg


def _assert_metrics_close(got, want, rtol):
  assert set(got) == set(want)
  for k in want:
    np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=rtol,
                               err_msg=k)


def _assert_tree_close(got, want, what, frac=0.0, atol=0.0):
  """Leafwise max|got - want| <= frac * max|want| + atol."""
  flat_got = jax.tree_util.tree_leaves_with_path(got)
  flat_want = dict(jax.tree_util.tree_leaves_with_path(want))
  assert len(flat_got) == len(flat_want)
  for path, g in flat_got:
    w = np.asarray(flat_want[path])
    scale = float(np.abs(w).max())
    err = float(np.abs(np.asarray(g) - w).max())
    assert err <= frac * scale + atol, (what, jax.tree_util.keystr(path),
                                        err, scale)


def _assert_update_matches(got_new, got_old, want_new, want_old, grads,
                           step_size, what):
  """The step's update (new - old) against JAX's, leaf by leaf.

  A first Adam step moves an entry by ~step_size * sign(-grad) (less
  where |grad| is near eps), so: in every leaf with a gradient some entry
  moves by at least step_size / 2; wherever |grad| > 1e-3 * max|grad| the
  update has the sign of -grad and of JAX's update and lies within
  step_size / 4 of JAX's (a missing or reversed step is off by step_size
  or 2 step_size); everywhere within 2 step_size (an entry with |grad|
  ~ eps may flip).
  """
  new = dict(jax.tree_util.tree_leaves_with_path(got_new))
  old = dict(jax.tree_util.tree_leaves_with_path(got_old))
  jnew = dict(jax.tree_util.tree_leaves_with_path(want_new))
  jold = dict(jax.tree_util.tree_leaves_with_path(want_old))
  flat_grads = jax.tree_util.tree_leaves_with_path(grads)
  assert len(flat_grads) == len(new) == len(jnew)
  for path, g in flat_grads:
    where = (what, jax.tree_util.keystr(path))
    g = np.asarray(g)
    upd = np.asarray(new[path], np.float64) - np.asarray(old[path])
    jupd = np.asarray(jnew[path], np.float64) - np.asarray(jold[path])
    assert np.abs(upd - jupd).max() <= 2 * step_size, where
    if not np.abs(g).max() > 0:
      continue
    assert np.abs(upd).max() >= 0.5 * step_size, where
    big = np.abs(g) > 1e-3 * np.abs(g).max()
    assert (np.sign(upd[big]) == -np.sign(g[big])).all(), where
    assert (np.sign(jupd[big]) == -np.sign(g[big])).all(), where
    assert np.abs(upd - jupd)[big].max() <= 0.25 * step_size, where


def test_one_step_matches_jax(setup):
  """Loss, metrics, model and pose grads, and the updates of the params,
  the poses and the EMA."""
  scene, jdev, tdev, jstate, jstep, jgrad = setup
  model, pose, state, step, mcfg, tcfg = _port_state(jstate, scene, tdev)
  key = jax.random.PRNGKey(7)
  draws = _jax_draws(key, tcfg, mcfg, jdev, scene.i_train, scene.near,
                     scene.far)

  (_, jmetrics), (jgrads, jpose_grads) = jgrad(key, jdev)
  jnext, jstep_metrics = jstep(jstate, key)
  _assert_metrics_close(jmetrics, jstep_metrics, 1e-6)

  old = map_mip_state_dict({n: p.detach().clone() for n, p in
                            model.named_parameters()})
  old_pose = {k: getattr(pose, k).detach().clone().numpy() for k in "rt"}
  old_ema = map_mip_state_dict({n: t.clone() for n, t in state.ema.items()})
  metrics = step(state, draws=draws)
  _assert_metrics_close(metrics, jstep_metrics, 1e-5)
  assert set(metrics) == {"loss", "loss_rgb", "psnr", "loss_proposal",
                          "loss_smooth", "loss_depth"}

  grads = map_mip_state_dict({n: p.grad for n, p in
                              model.named_parameters()})
  _assert_tree_close(grads, jgrads, "model grad", frac=1e-4)
  _assert_tree_close({k: getattr(pose, k).grad.numpy() for k in "rt"},
                     jpose_grads, "pose grad", frac=1e-4)
  # the sampled image's pose gets a gradient, the others none
  img = int(draws.img_idx[0])
  assert float(pose.r.grad[img].abs().max()) > 0
  others = [i for i in range(scene.num_images) if i != img]
  assert float(pose.r.grad[others].abs().max()) == 0

  # the first step: model lr = lrate * lrate_delay_mult, poses at
  # pose_lrate; the EMA moves by (1 - d) of the update, d = min(decay,
  # 2 / 11) at t = 1
  lr = tcfg.lrate * tcfg.lrate_delay_mult
  new = map_mip_state_dict({n: p.detach() for n, p in
                            model.named_parameters()})
  _assert_update_matches(new, old, jnext.params, jstate.params, jgrads, lr,
                         "params")
  _assert_update_matches({k: getattr(pose, k).detach().numpy() for k in "rt"},
                         old_pose, jnext.pose_params, jstate.pose_params,
                         jpose_grads, tcfg.pose_lrate, "poses")
  d = min(tcfg.ema_decay, 2.0 / 11.0)
  _assert_update_matches(map_mip_state_dict(state.ema), old_ema,
                         jnext.ema_params, jstate.ema_params, jgrads,
                         (1.0 - d) * lr, "ema params")
  assert state.step == int(jnext.step) == 1


def test_three_step_trajectory_matches_jax(setup):
  scene, jdev, tdev, jstate, jstep, _ = setup
  _, _, state, step, mcfg, tcfg = _port_state(jstate, scene, tdev)
  for i in range(3):
    key = jax.random.PRNGKey(100 + i)
    draws = _jax_draws(key, tcfg, mcfg, jdev, scene.i_train, scene.near,
                       scene.far)
    jstate, jmetrics = jstep(jstate, key)
    metrics = step(state, draws=draws)
    for k in ("loss", "loss_rgb", "loss_depth", "loss_proposal"):
      np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]),
                                 rtol=1e-4, err_msg=f"step {i} {k}")


def test_adam_matches_optax():
  """torch.optim.Adam with the trainer's schedule against optax.adam on
  identical grads, three steps across the warm-up.

  Against optax's formula evaluated in float64 (same lr): 1e-6 of the
  update. Against optax itself: 5e-5, because optax forms the bias
  correction 1 - 0.999^t in float32, where the subtraction loses all but
  ~2^-24 / 1e-3 of it (6e-5 relative at t = 1, 3e-5 after the square
  root); torch forms it in float64. The params start at zero, so that
  they hold only the updates.
  """
  cfg = trainer.TrainConfig(lrate_delay_steps=2, n_iters=10)
  rng = np.random.RandomState(0)
  grads = [rng.normal(size=(5, 7)).astype(np.float32) * 10 ** -i
           for i in range(3)]
  tx = optax.adam(jtrainer.make_lr_schedule(jtrainer.TrainConfig(
      **dataclasses.asdict(cfg))))
  jp = jnp.zeros((5, 7), jnp.float32)
  opt = tx.init(jp)
  tp = torch.nn.Parameter(torch.zeros(5, 7))
  lr_at = trainer.make_lr_schedule(cfg)
  assert lr_at(0) == pytest.approx(cfg.lrate * cfg.lrate_delay_mult)
  adam = trainer.adam([tp], lr_at(0))
  ref, mu, nu = np.zeros((5, 7)), np.zeros((5, 7)), np.zeros((5, 7))
  for i, g in enumerate(grads):
    updates, opt = tx.update(jnp.asarray(g), opt, jp)
    jp = optax.apply_updates(jp, updates)
    tp.grad = torch.from_numpy(g)
    adam.param_groups[0]["lr"] = lr_at(i)
    adam.step()
    g64 = g.astype(np.float64)
    mu, nu = 0.9 * mu + 0.1 * g64, 0.999 * nu + 0.001 * g64 ** 2
    m_hat, v_hat = mu / (1 - 0.9 ** (i + 1)), nu / (1 - 0.999 ** (i + 1))
    ref = ref - float(jtrainer.make_lr_schedule(jtrainer.TrainConfig(
        **dataclasses.asdict(cfg)))(i)) * m_hat / (np.sqrt(v_hat) + 1e-8)
    got, scale = tp.detach().numpy(), float(np.abs(ref).max())
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6 * scale,
                               err_msg=f"step {i} vs float64")
    np.testing.assert_allclose(got, np.asarray(jp), rtol=0,
                               atol=5e-5 * scale, err_msg=f"step {i}")


def test_depth_conf_raises():
  from snerf_tpu.config import load_config
  from snerf_tpu_torch import config as tconfig
  cfg = load_config(["--config", "configs/nuScenes_depth_6cams"])
  assert cfg.depth_conf
  with pytest.raises(NotImplementedError):
    tconfig.train_config(cfg)
  with pytest.raises(NotImplementedError):
    trainer.create_train_state(0, MipNerfConfig(**MODEL),
                               trainer.TrainConfig(depth_conf=True), 6,
                               device="cpu")


def test_train_config_matches_jax_adapter():
  from snerf_tpu.config import load_config
  from snerf_tpu_torch import config as tconfig
  cfg = load_config(["--config", "configs/nuScenes_depth_6cams",
                     "--depth_conf", "False"])
  got = dataclasses.asdict(tconfig.train_config(cfg))
  want = dataclasses.asdict(cfg.train_config())
  for k, v in got.items():
    assert want[k] == v, k
  assert {k for k in want if k not in got} == {
      "conf_num", "conf_tau", "conf_lrate", "conf_modes",
      "use_skymask_conf"}
  assert tconfig.model_config(cfg).density_noise == cfg.density_noise
