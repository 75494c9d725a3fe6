"""The port's ipe and CP zip arms in training, against snerf_tpu on the
same weights and draws (the set-up of tests/test_torch_zip_arms.py): the
randomized forward with the fine level's dither, one cp_hash train step
with the EMA, encoder_lr_mult 4 and per-level lrs (gamma > 0), and the
quality families of bench_quality.

Tolerances, float32 on the CPU on both sides: the forward's ray history
and renderings within 1e-4 relative plus 1e-5 absolute (the resampling
moves continuously with a ~1e-7 change of a proposal weight); the train
step's loss and metrics within 1e-5 relative (the grad norms 1e-4), its
gradients within 1e-4 of their tensor's max, its updates as
`_assert_update_close` says.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snerf_tpu.data import sampler as jsampler
from snerf_tpu.data import synthetic as jsynthetic
from snerf_tpu.models.zipnerf import ZipNerfConfig as JaxConfig
from snerf_tpu.models.zipnerf import ZipNerfModel as JaxModel
from snerf_tpu.ops.rays import Rays as JaxRays
from snerf_tpu.train import zip_trainer as jtrainer
from snerf_tpu_torch.data import sampler, synthetic
from snerf_tpu_torch.models import zipnerf
from snerf_tpu_torch.models.zipnerf import ZipDraws, ZipNerfConfig
from snerf_tpu_torch.ops.rays import Rays
from snerf_tpu_torch.train import zip_trainer as trainer
from snerf_tpu_torch.utils.weights import (zip_state_dict_from_flax,
                                           zip_train_state_from_flax)
from tests.test_torch_zip_arms import (ARMS, BASE, _model_pair, _rays,
                                       _scale_fine)
from tests.test_torch_zip_trainer import _assert_metrics_close, _np, _scene


def _model_draws(k_model, mcfg, batch, n):
  """The JAX model's draws from k_model (zipnerf.py __call__), with the
  fine level's dither in [0, n) from fold_in(keys[2 i + 1], 7) of the
  nerf level."""
  keys = jax.random.split(k_model, 2 * mcfg.num_levels)
  levels = list(mcfg.num_prop_samples) + [mcfg.num_nerf_samples]
  out = dict(jitter=[], rotation=[], noise=[], bg=[])
  for i, s in enumerate(levels):
    out["jitter"].append(jax.random.uniform(keys[2 * i], (batch, 1)))
    out["rotation"].append(jax.random.uniform(keys[2 * i + 1],
                                              (batch, s, mcfg.sample_n)))
    out["noise"].append(jax.random.normal(keys[2 * i + 1], (batch, s)))
    out["bg"].append(jax.random.uniform(keys[2 * i], (batch, 3)))
  out["dither"] = jax.random.randint(jax.random.fold_in(keys[-1], 7),
                                     (batch, levels[-1]), 0, n)
  return out


def _to_draws(d, tcfg):
  t = lambda xs: [torch.tensor(np.asarray(x)) for x in xs]
  lo, hi = tcfg.bg_intensity_range
  return ZipDraws(
      jitter=t(d["jitter"]),
      rotation=None if tcfg.aniso_cast else t(d["rotation"]),
      noise=t(d["noise"]) if tcfg.density_noise > 0 else None,
      bg=None if lo == hi else t(d["bg"]),
      dither=(torch.tensor(np.asarray(d["dither"])).long()
              if zipnerf._dithers(tcfg) else None))


def test_randomized_forward_with_dither_matches_jax():
  """The cp_hash training forward with injected draws (the multisample
  rotations, the density noise, the fine level's dither) against JAX's
  with the key they come from, at train_frac 0.3."""
  jmodel, params, tmodel = _model_pair("cp_hash dither")
  r = _rays(24, seed=1)
  key = jax.random.PRNGKey(5)
  jr, jh = jax.jit(lambda p, rays, k: jmodel.apply(
      {"params": p}, JaxRays(**rays), rng=k, train_frac=0.3))(params, r, key)
  draws = _to_draws(jax.tree_util.tree_map(np.asarray, jax.jit(
      lambda k: _model_draws(k, jmodel.config, 24,
                             tmodel.config.fine_samples))(key)),
      tmodel.config)
  assert draws.dither is not None and draws.rotation is not None
  tr, th = tmodel(Rays(**{k: torch.from_numpy(v) for k, v in r.items()}),
                  draws=draws, train_frac=0.3)
  for lvl in range(3):
    for k in ("sdist", "weights", "density"):
      np.testing.assert_allclose(th[lvl][k].detach().numpy(),
                                 np.asarray(jh[lvl][k]), rtol=1e-4,
                                 atol=1e-5, err_msg=f"{lvl} {k}")
  for k in ("rgb", "depth", "acc", "semantic"):
    np.testing.assert_allclose(tr[-1][k].detach().numpy(),
                               np.asarray(jr[-1][k]), rtol=1e-4, atol=1e-5,
                               err_msg=k)


# --- one cp_hash train step ----------------------------------------------

STEP_MODEL = dict(BASE, **ARMS["cp_hash aniso center"])
STEP_TRAIN = dict(batch_size=96, max_steps=100, lr_delay_steps=0,
                  lr_init=2e-3, lr_final=2e-4, depth_loss_mult=0.01,
                  depth_complete=True, patch_size=4, encoder_lr_mult=4.0,
                  encoder_level_lr_gamma=0.5, ema_decay=0.9,
                  debug_grad_norms=True)


@functools.lru_cache(maxsize=None)
def _step_setup():
  scene, jscene = _scene(synthetic), _scene(jsynthetic)
  jdev = jsampler.scene_to_device(jscene)
  tdev = sampler.scene_to_device(scene, "cpu")
  jtcfg = jtrainer.ZipTrainConfig(**STEP_TRAIN)
  jmcfg = JaxConfig(**STEP_MODEL)
  jstate = jax.jit(lambda k: jtrainer.create_zip_train_state(
      k, jmcfg, jtcfg)[1])(jax.random.PRNGKey(0))
  params = jax.tree_util.tree_map(jnp.asarray, _scale_fine(_np(
      jstate.params)))
  jstate = jstate.replace(params=params,
                          ema_params=jax.tree_util.tree_map(jnp.copy, params))
  jstep = jtrainer.make_zip_train_step(
      JaxModel(config=jmcfg), jmcfg, jtcfg, jdev, scene.i_train, scene.near,
      scene.far, donate=False)
  train_step = jstep.func.__wrapped__
  cells = dict(zip(train_step.__code__.co_freevars,
                   (c.cell_contents for c in train_step.__closure__)))
  jgrad = jax.jit(jax.grad(
      lambda p, key, dev: cells["loss_fn"](dev, p, None, key, 0.0, 1.0)[0]))
  return scene, jdev, tdev, jstate, jstep, jgrad, jtcfg, jmcfg


def _step_draws(key, jtcfg, jmcfg, jdev, scene, tcfg):
  n_pix, n_patches = trainer._patch_split(jtcfg)

  @jax.jit
  def draw(key, dev):
    k_sample, k_model = jax.random.split(key)
    _, targets = jsampler.sample_batch(
        k_sample, dev, jnp.asarray(scene.i_train), n_pix, scene.near,
        scene.far, single_image=jtcfg.single_image, n_patches=n_patches,
        patch_size=jtcfg.patch_size)
    return ((targets["img_idx"], targets["py"], targets["px"]),
            _model_draws(k_model, jmcfg, jtcfg.batch_size,
                         tcfg.fine_samples))

  (img_idx, py, px), model = jax.tree_util.tree_map(np.asarray,
                                                    draw(key, jdev))
  return trainer.ZipStepDraws(
      img_idx=torch.tensor(img_idx), py=torch.tensor(py),
      px=torch.tensor(px), model=_to_draws(model, tcfg))


def _by_name(tree):
  return {k: v.numpy() for k, v in zip_state_dict_from_flax(_np(tree)).items()}


def _assert_update_close(new, old, jnew, jold, grads, step_size, what):
  """The first Adam step moves an entry by ~step_size * sign(-grad):
  wherever |grad| > 1e-3 max|grad| the update has that sign and lies
  within step_size / 4 of JAX's; everywhere within 2 step_size."""
  for name, g in grads.items():
    size = step_size(name)
    upd = new[name].astype(np.float64) - old[name]
    jupd = jnew[name].astype(np.float64) - jold[name]
    assert np.abs(upd - jupd).max() <= 2 * size, (what, name)
    if not np.abs(g).max() > 0:
      continue
    big = np.abs(g) > 1e-3 * np.abs(g).max()
    assert (np.sign(upd[big]) == -np.sign(g[big])).all(), (what, name)
    assert np.abs(upd - jupd)[big].max() <= 0.25 * size, (what, name)


def test_cp_hash_train_step_matches_jax():
  """One step of the cp_hash arm (the shipped TPU arm's encoder, at tiny
  widths) with the EMA, encoder_lr_mult 4 and gamma 0.5: the loss and
  metrics (the grid and net grad norms among them), every gradient, the
  updates at each group's lr (CP level l at 4 x 0.5^l, hash_fine in net
  at 1x) and the EMA update."""
  scene, jdev, tdev, jstate, jstep, jgrad, jtcfg, jmcfg = _step_setup()
  tcfg = trainer.ZipTrainConfig(**STEP_TRAIN)
  mcfg = ZipNerfConfig(**STEP_MODEL)
  state = trainer.create_zip_train_state(1, mcfg, tcfg, device="cpu")
  zip_train_state_from_flax(state, _np(jstate.params),
                            ema_params=_np(jstate.ema_params))
  groups = {g["name"]: g["lr_mult"] for g in state.optimizer.param_groups}
  assert groups == {"grid": 4.0, "net": 1.0, "grid0": 4.0, "grid1": 2.0}
  named = dict(state.model.named_parameters())
  net = next(g for g in state.optimizer.param_groups if g["name"] == "net")
  assert any(p is named["nerf_mlp.hash_fine.embeddings"]
             for p in net["params"])
  key = jax.random.PRNGKey(7)
  draws = _step_draws(key, jtcfg, jmcfg, jdev, scene, mcfg)
  assert draws.model.rotation is None and draws.model.dither is None
  jgrads = _by_name(jgrad(jstate.params, key, jdev))
  jnext, jmetrics = jstep(jstate, key)
  old = {k: p.detach().numpy().copy() for k, p in named.items()}
  old_ema = {k: v.numpy().copy() for k, v in state.ema.items()}
  step = trainer.make_zip_train_step(state.model, tcfg, tdev, scene.i_train,
                                     scene.near, scene.far)
  metrics = step(state, draws)
  assert set(metrics) == set(jmetrics)
  assert "loss_hash_decay" not in metrics
  norms = {"gnorm_grid", "gnorm_net"}
  _assert_metrics_close({k: v for k, v in metrics.items() if k not in norms},
                        {k: v for k, v in jmetrics.items() if k not in norms},
                        1e-5)
  _assert_metrics_close({k: metrics[k] for k in norms},
                        {k: jmetrics[k] for k in norms}, 1e-4)
  lr = tcfg.lr_init

  def size(name):
    if ".cp_grid.v" in name:
      return lr * 4.0 * 0.5 ** int(name.rsplit(".v", 1)[1])
    return lr

  new = {k: p.detach().numpy() for k, p in named.items()}
  _assert_update_close(new, old, _by_name(jnext.params),
                       _by_name(jstate.params), jgrads, size, "params")
  d = min(tcfg.ema_decay, 2.0 / 11.0)
  _assert_update_close({k: v.numpy() for k, v in state.ema.items()}, old_ema,
                       _by_name(jnext.ema_params), _by_name(jstate.ema_params),
                       jgrads, lambda n: (1.0 - d) * size(n), "ema")
  # the gradients themselves, before any clipping: a second port step
  # from the same weights with the clips off and a vanishing lr
  state2 = trainer.create_zip_train_state(1, mcfg, tcfg, device="cpu")
  zip_train_state_from_flax(state2, _np(jstate.params),
                            ema_params=_np(jstate.ema_params))
  step2 = trainer.make_zip_train_step(
      state2.model, dataclasses.replace(tcfg, grad_max_norm=0.0,
                                        lr_init=1e-30, lr_final=1e-30),
      tdev, scene.i_train, scene.near, scene.far)
  step2(state2, draws)
  for k, p in state2.model.named_parameters():
    err = float(np.abs(p.grad.numpy() - jgrads[k]).max())
    assert err <= 1e-4 * float(np.abs(jgrads[k]).max()), (k, err)


@pytest.mark.parametrize("family", ["zip_ipe", "zip_aniso", "zip_cp",
                                    "zip_cp_hash", "zip_cp_aniso",
                                    "zip_cp_aniso_center"])
def test_bench_quality_zip_families(family):
  """Each new quality family carries bench_quality.py's encoder, its
  overrides and its learning rates; the two measured on the card train a
  step and render on the CPU at narrow widths."""
  import bench_quality as jbench
  from snerf_tpu_torch import bench_quality
  spec = jbench.FAMILIES[family]
  scene = bench_quality.load_fixture()
  narrow = dict(num_prop_samples=(4, 4), num_nerf_samples=4,
                ipe_density_width=16, density_hidden_width=16,
                ipe_density_depth=3, cp_level_dim=4, cp_max_resolution=256,
                cp_hash_log2=10, bottleneck_width=16, net_width_viewdirs=16)
  model, state, _ = bench_quality.zip_setup(scene, 2, 64,
                                            torch.device("cpu"), 0, narrow,
                                            family)
  cfg = model.config
  assert cfg.encoder_type == spec["encoder"]
  for k, v in spec.get("overrides", {}).items():
    assert getattr(cfg, k) == narrow.get(k, v), k
  assert {g["name"]: g["lr_mult"] for g in state.optimizer.param_groups
          if g["params"]}.get("grid", 4.0) == 4.0
  assert state.optimizer.param_groups[0]["lr"] == pytest.approx(2e-3)
  if family in ("zip_aniso", "zip_cp_aniso_center"):
    r = bench_quality.run_family(family, scene, 1, 64, torch.device("cpu"),
                                 overrides=narrow)
    assert np.isfinite(r["psnr"]) and len(r["curve"]) == 1
