"""The port's ipe and CP zip encoder arms against snerf_tpu on the same
weights and draws: each arm's ZipMLP (forward and every parameter's
gradient), the trunk checkpoint, and the eval render of the whole
ZipNerfModel for the ipe-aniso and cp_hash-aniso-center arms. Training
is held in tests/test_torch_zip_arms_train.py.

Weights come from the JAX package's init, cp_hash's fine hash table
scaled from +-1e-4 up to +-1 so that its rows move the outputs, and
cross over through `zip_state_dict_from_flax`; every CP test sets
density_zero_init explicitly. Draws come from the JAX key and are
injected (the density noise from the MLP's key, the dither from
fold_in(key, 7)).

Tolerances, float32 on the CPU on both sides: MLP outputs within 1e-5
absolute, their parameter gradients within 1e-4 of each tensor's max
(the IPE's sines, the CP profile's exp and the matmuls round differently
in XLA and ATen, and the hash table's gradient sums in another order);
renders as tests/test_torch_zipnerf.py holds them (1e-4 absolute, depth
1e-4 relative).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snerf_tpu.models.zipnerf import ZipMLP as JaxMLP
from snerf_tpu.models.zipnerf import ZipNerfConfig as JaxConfig
from snerf_tpu.models.zipnerf import ZipNerfModel as JaxModel
from snerf_tpu.models.zipnerf import init_zipnerf
from snerf_tpu.ops.rays import Rays as JaxRays
from snerf_tpu.train import renderer as jrenderer
from snerf_tpu_torch.models import zipnerf
from snerf_tpu_torch.models.zipnerf import ZipMLP, ZipNerfConfig, ZipNerfModel
from snerf_tpu_torch.ops.rays import Rays
from snerf_tpu_torch.train import renderer
from snerf_tpu_torch.utils.weights import zip_state_dict_from_flax
from tests.test_torch_zip_trainer import _np

TABLE_SCALE = 1e4
# tiny widths: 2 CP levels, a 5-deep 32-wide trunk with a skip after
# layer 2 (two square runs), IPE to degree 6, one fine level of 2^12 rows
BASE = dict(num_prop_samples=(8, 8), num_nerf_samples=8,
            prop_grid_resolutions=(64, 128), nerf_grid_resolution=256,
            bottleneck_width=32, net_width_viewdirs=16, sample_n=3,
            use_semantic=True, class_num=5, ipe_max_deg=6,
            ipe_density_depth=5, ipe_density_width=32, ipe_skip_layer=2,
            density_hidden_width=32, cp_num_levels=2, cp_level_dim=4,
            cp_base_resolution=16, cp_max_resolution=64,
            cp_prop_num_levels=2, cp_prop_level_dim=2,
            cp_hash_resolution=128, cp_hash_log2=12, scene_scale=0.5,
            raydist_fn="power_transformation")
CP_HASH = dict(encoder_type="cp_hash", density_zero_init=True)
ARMS = {
    "ipe": dict(encoder_type="ipe", ipe_anneal_frac=0.5),
    "ipe aniso": dict(encoder_type="ipe", ipe_anisotropic=True,
                      ipe_anneal_frac=0.5),
    "cp": dict(encoder_type="cp", density_zero_init=True, cp_anneal_frac=0.5,
               cp_feature_norm="layernorm"),
    "cp_ipe": dict(encoder_type="cp_ipe", density_zero_init=False,
                   cp_feature_norm="center", cp_pair_dim=2,
                   cp_collapse_multisamples=False),
    "cp_hash collapsed": CP_HASH,
    "cp_hash aniso center": dict(CP_HASH, cp_anisotropic=True,
                                 cp_feature_center=True,
                                 cp_hash_use_spread=False),
    "cp_hash per_sample": dict(CP_HASH, cp_hash_per_sample=True,
                               cp_factor_bound=0.5),
    "cp_hash split": dict(CP_HASH, cp_hash_split=2),
    "cp_hash dither": dict(CP_HASH, cp_hash_dither=True, density_noise=0.5),
}


def _cfgs(arm, **extra):
  kw = dict(BASE, **ARMS[arm], **extra)
  return JaxConfig(**kw), ZipNerfConfig(**kw)


def _scale_fine(params):
  for mlp in params.values():
    if "hash_fine" in mlp:
      mlp["hash_fine"]["table"] = mlp["hash_fine"]["table"] * TABLE_SCALE
  return params


def _gaussians(cfg, rng, rows=(6, 8)):
  """means, stds of an MLP's input: multisamples [..., n, 3], [..., n],
  or the cylinder cast's [..., 3], [..., 3]."""
  if cfg.aniso_cast:
    means = rng.normal(size=(*rows, 3)) * 1.2
    stds = rng.uniform(1e-5, 4e-3, size=(*rows, 3))
  else:
    means = rng.normal(size=(*rows, cfg.sample_n, 3)) * 1.2
    stds = rng.uniform(0.003, 0.06, size=(*rows, cfg.sample_n))
  return means.astype(np.float32), stds.astype(np.float32)


def _mlp_pair(arm, disable_rgb):
  jcfg, tcfg = _cfgs(arm)
  res = 256 if not disable_rgb else 128
  jmlp = JaxMLP(cfg=jcfg, grid_resolution=res, grid_level_dim=4,
                disable_rgb=disable_rgb)
  rng = np.random.RandomState(0)
  means, stds = _gaussians(tcfg, rng)
  vd = rng.normal(size=(6, 3)).astype(np.float32)
  vd /= np.linalg.norm(vd, axis=-1, keepdims=True)
  viewdirs = None if disable_rgb else vd
  params = _np(jax.jit(lambda k: jmlp.init(
      k, means, stds, viewdirs=viewdirs, train_frac=0.3))(
          jax.random.PRNGKey(1))["params"])
  params = _scale_fine({"m": params})["m"]
  tmlp = ZipMLP(tcfg, res, 4, disable_rgb=disable_rgb, device="cpu")
  tmlp.load_state_dict({k[2:]: v for k, v in zip_state_dict_from_flax(
      {"m": params}).items()})
  return jmlp, params, tmlp, means, stds, viewdirs


def _outputs(out, disable_rgb):
  return ("density",) if disable_rgb else ("density", "rgb", "semantic")


def _loss(out, gs, keys):
  return sum((out[k] * g).sum() for k, g in zip(keys, gs))


@pytest.mark.parametrize("disable_rgb", [False, True],
                         ids=["nerf", "proposal"])
@pytest.mark.parametrize("arm", ARMS)
def test_zip_mlp_matches_jax(arm, disable_rgb):
  """The MLP's density, rgb and semantics at train_frac 0.3 with the
  JAX key's density noise and dither, and every parameter's gradient of
  a seeded projection of them."""
  jmlp, params, tmlp, means, stds, viewdirs = _mlp_pair(arm, disable_rgb)
  key = jax.random.PRNGKey(9)
  rng = np.random.RandomState(2)
  keys = _outputs(None, disable_rgb)
  shapes = {"density": means.shape[:2], "rgb": (*means.shape[:2], 3),
            "semantic": (*means.shape[:2], 5)}
  gs = [rng.normal(size=shapes[k]).astype(np.float32) for k in keys]

  def jloss(p):
    out = jmlp.apply({"params": p}, means, stds, viewdirs=viewdirs, rng=key,
                     train_frac=jnp.float32(0.3))
    return _loss(out, gs, keys), out

  (_, jout), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
  n = 1 if tmlp.config.aniso_cast else tmlp.config.sample_n
  noise = torch.tensor(np.asarray(jax.random.normal(key, means.shape[:2])))
  dither = None
  if zipnerf._dithers(tmlp.config) and not disable_rgb:
    dither = torch.tensor(np.asarray(jax.random.randint(
        jax.random.fold_in(key, 7), means.shape[:2], 0, n))).long()
  out = tmlp(torch.from_numpy(means), torch.from_numpy(stds),
             viewdirs=None if viewdirs is None else torch.from_numpy(viewdirs),
             noise=noise, train_frac=0.3, dither=dither)
  _loss(out, [torch.from_numpy(g) for g in gs], keys).backward()
  for k in keys:
    np.testing.assert_allclose(out[k].detach().numpy(), np.asarray(jout[k]),
                               rtol=0, atol=1e-5, err_msg=k)
  want = zip_state_dict_from_flax({"m": _np(jgrads)})
  got = {f"m.{k}": p.grad for k, p in tmlp.named_parameters()}
  assert set(got) == set(want)
  for k, w in want.items():
    err = float((got[k] - w).abs().max())
    assert err <= 1e-4 * float(w.abs().max()), (k, err)


def test_trunk_checkpoint_keeps_the_grads():
  """The trunk under the checkpoint (autograd keeps its input, recomputes
  the layers) gives the same gradients, bit for bit, as the trunk run
  straight, and keeps none of its layers' outputs."""
  _, _, tmlp, means, stds, viewdirs = _mlp_pair("cp_hash aniso center", False)
  args = (torch.from_numpy(means), torch.from_numpy(stds),
          torch.from_numpy(viewdirs))

  def grads(straight):
    tmlp.zero_grad()
    saved = []

    def pack(t):
      saved.append(tuple(t.shape))
      return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
      if straight:
        with pytest.MonkeyPatch.context() as mp:
          mp.setattr(zipnerf.checkpoint, "checkpoint",
                     lambda fn, *a, **kw: fn(*a))
          out = tmlp(*args)
      else:
        out = tmlp(*args)
    (out["rgb"].sum() + out["density"].sum()).backward()
    return {k: p.grad.clone() for k, p in tmlp.named_parameters()}, saved

  straight, saved_straight = grads(True)
  ckpt, saved_ckpt = grads(False)
  for k in straight:
    assert torch.equal(straight[k], ckpt[k]), k
  width = tmlp.config.ipe_density_width
  rows = means.shape[0] * means.shape[1]
  layer_outs = lambda saved: sum(s[-1] == width and np.prod(s) == rows * width
                                 for s in saved)
  assert layer_outs(saved_straight) >= tmlp.config.ipe_density_depth
  assert layer_outs(saved_ckpt) == 0


def test_double_centering_and_unported_arms_raise():
  with pytest.raises(ValueError, match="twice"):
    ZipNerfConfig(encoder_type="cp_hash", cp_feature_center=True,
                  cp_feature_norm="center")
  for enc in ("cp_tri", "mipcast"):
    with pytest.raises(NotImplementedError):
      ZipNerfConfig(encoder_type=enc)
  for enc in ("ipe", "cp", "cp_ipe", "cp_hash"):
    ZipNerfConfig(encoder_type=enc)


def _rays(n, seed=0):
  rng = np.random.RandomState(seed)
  d = rng.normal(size=(n, 3)).astype(np.float32)
  return dict(origins=(rng.normal(size=(n, 3)) * 0.3).astype(np.float32),
              directions=d,
              viewdirs=d / np.linalg.norm(d, axis=-1, keepdims=True),
              radii=np.full((n, 1), 0.003, np.float32),
              lossmult=np.ones((n, 1), np.float32),
              near=np.full((n, 1), 0.2, np.float32),
              far=np.full((n, 1), 8.0, np.float32),
              app=np.zeros((n, 1), np.int32))


@functools.lru_cache(maxsize=None)
def _model_pair(arm):
  jcfg, tcfg = _cfgs(arm)
  params = _scale_fine(_np(jax.jit(lambda k: init_zipnerf(k, jcfg)[1])(
      jax.random.PRNGKey(0))["params"]))
  tmodel = ZipNerfModel(tcfg, device="cpu")
  tmodel.load_state_dict(zip_state_dict_from_flax(params))
  return JaxModel(config=jcfg), params, tmodel


@pytest.mark.parametrize("arm", ["ipe aniso", "cp_hash aniso center"])
def test_eval_render_matches_jax(arm):
  """make_zip_eval_render_fn against make_zip_param_render_fn on the same
  weights, 40 rays, ragged chunks on the port's side."""
  jmodel, params, tmodel = _model_pair(arm)
  r = _rays(40)
  want = jrenderer.make_zip_param_render_fn(jmodel)(params, JaxRays(**r))
  got = renderer.render_rays_chunked(
      renderer.make_zip_eval_render_fn(tmodel),
      Rays(**{k: torch.from_numpy(v) for k, v in r.items()}), chunk=16)
  assert set(got) == set(want) == {"rgb", "distance", "acc", "semantic"}
  for k in ("rgb", "acc", "semantic"):
    np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0,
                               atol=1e-4, err_msg=k)
  np.testing.assert_allclose(got["distance"].numpy(),
                             np.asarray(want["distance"]), rtol=1e-4)
