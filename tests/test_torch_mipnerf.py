"""The port's mip model and render path against snerf_tpu, same weights.

Weights come from the JAX package's `init_model` and cross over through
`state_dict_from_flax`; rays are numpy-seeded. Tolerances: rgb and acc
within 1e-4 absolute, distance within 1e-4 relative. Both sides are
float32 on the CPU; the MLPs differ by summation order (~1e-6), which
the resample bracket can turn into a neighbouring-bin choice, but the
inverse-CDF interpolation is continuous, so the rendered values move by
the same order, not by a bin.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snerf_tpu.config import load_config
from snerf_tpu.data import raygen as jraygen
from snerf_tpu.data import synthetic as jsynthetic
from snerf_tpu.models import mlp as jmlp
from snerf_tpu.models.mipnerf import MipNerfConfig as JaxConfig
from snerf_tpu.models.mipnerf import MipNerfModel as JaxModel
from snerf_tpu.models.mipnerf import init_model
from snerf_tpu.ops.rays import Rays as JaxRays
from snerf_tpu.train import renderer as jrenderer
from snerf_tpu.utils.ref_import import map_mip_state_dict
from snerf_tpu_torch import config as tconfig
from snerf_tpu_torch.data import raygen, synthetic
from snerf_tpu_torch.models.mipnerf import MipNerfConfig, MipNerfModel
from snerf_tpu_torch.ops.rays import Rays
from snerf_tpu_torch.train import renderer
from snerf_tpu_torch.utils.weights import glorot_init_, state_dict_from_flax

SMALL = dict(num_samples=16, num_fine=16, hidden_layer=128,
             proposal_hidden_layer=128)
CONFIGS = {
    # the shipped nuScenes model, narrowed: cone, fn2 warp, log, deg 16
    "warp": dict(ray_shape="cone", no_warp_sample=False, warp_fn=1,
                 t_transform="log", max_deg_point=16, rgb_layer=3),
    "no_warp": dict(ray_shape="cylinder", no_warp_sample=True,
                    semantic=True, semantic_class_num=5),
}


def _np_params(variables):
  return jax.tree_util.tree_map(np.asarray, variables["params"])


def _init_jax(kw, seed):
  """init_model under jit (eager flax init takes ~10 s on the CPU)."""
  cfg = JaxConfig(**kw)
  variables = jax.jit(lambda k: init_model(k, cfg)[1])(
      jax.random.PRNGKey(seed))
  return JaxModel(config=cfg), variables


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def pair(request):
  kw = dict(SMALL, **CONFIGS[request.param])
  jmodel, variables = _init_jax(kw, 0)
  tmodel = MipNerfModel(MipNerfConfig(**kw), device="cpu")
  tmodel.load_state_dict(state_dict_from_flax(_np_params(variables)))
  return jmodel, variables, tmodel


def _rays_np(n, seed=0):
  rng = np.random.RandomState(seed)
  d = rng.normal(size=(n, 3)).astype(np.float32)
  return dict(
      origins=(rng.normal(size=(n, 3)) * 0.3).astype(np.float32),
      directions=d, viewdirs=d / np.linalg.norm(d, axis=-1, keepdims=True),
      radii=np.full((n, 1), 0.003, np.float32),
      lossmult=np.ones((n, 1), np.float32),
      near=np.full((n, 1), 0.5, np.float32),
      far=np.full((n, 1), 6.0, np.float32),
      app=np.zeros((n, 1), np.int32))


def _assert_render_close(got, want):
  for k in ("rgb", "acc", "semantic"):
    if want.get(k) is not None:
      np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]),
                                 atol=1e-4, rtol=0, err_msg=k)
  np.testing.assert_allclose(np.asarray(got["distance"]),
                             np.asarray(want["distance"]), rtol=1e-4,
                             atol=0)


def test_bridge_round_trip(pair):
  _, variables, tmodel = pair
  back = map_mip_state_dict(tmodel.state_dict())
  want = _np_params(variables)
  assert jax.tree_util.tree_structure(back) == \
      jax.tree_util.tree_structure(want)
  for a, b in zip(jax.tree_util.tree_leaves(back),
                  jax.tree_util.tree_leaves(want)):
    np.testing.assert_array_equal(a, b)


def test_nerf_mlp_and_proposal_parity(pair):
  _, variables, tmodel = pair
  params = variables["params"]
  rng = np.random.RandomState(1)
  x = rng.normal(size=(4, 6, 96)).astype(np.float32)
  cond = rng.normal(size=(4, 27)).astype(np.float32)
  c = tmodel.config
  jnerf = jmlp.NerfMLP(
      net_width=c.hidden_layer, condition_depth=c.rgb_layer,
      num_semantic_channels=c.semantic_class_num if c.semantic else 0)
  want = jax.jit(jnerf.apply)({"params": params["mlp"]}, x, cond)
  with torch.inference_mode():
    got = tmodel.mlp(torch.from_numpy(x), torch.from_numpy(cond))
  for g, w in zip(got, want):
    if w is None:
      assert g is None
      continue
    np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                               rtol=1e-5)
  jprop = jmlp.ProposalMLP(net_width=c.proposal_hidden_layer)
  want = jax.jit(jprop.apply)({"params": params["proposal"]}, x)
  with torch.inference_mode():
    got = tmodel.proposal(torch.from_numpy(x))
  np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                             rtol=1e-5)


def test_model_eval_forward_parity(pair):
  jmodel, variables, tmodel = pair
  r = _rays_np(48)
  want = jax.jit(lambda v, rays: jmodel.apply(v, rays, rng=None))(
      variables, JaxRays(**r))
  with torch.inference_mode():
    got = tmodel(Rays(**{k: torch.from_numpy(v) for k, v in r.items()}))
  assert len(got) == len(want) == 2
  assert got[0]["rgb"] is None
  # the warp branch draws num_fine - 1 fine intervals
  c = tmodel.config
  n_fine = c.num_fine - 1 if not c.no_warp_sample else c.num_samples
  assert got[1]["weights"].shape == (48, n_fine)
  for g, w in zip(got, want):
    _assert_render_close(g, w)
    np.testing.assert_allclose(g["weights"].numpy(), np.asarray(w["weights"]),
                               atol=1e-4)


def test_render_image_parity_on_synthetic_view():
  """The whole slice: synthetic scene -> rays_for_image ->
  make_eval_render_fn -> render_image, port against JAX, 8x8 view, with
  a ragged last chunk on the port's side."""
  kw = dict(SMALL, **CONFIGS["warp"])
  jmodel, variables = _init_jax(kw, 3)
  tmodel = MipNerfModel(MipNerfConfig(**kw), device="cpu")
  tmodel.load_state_dict(state_dict_from_flax(_np_params(variables)))

  scene = synthetic.make_synthetic_scene(num_images=2, H=8, W=8,
                                         n_render_samples=16)
  jscene = jsynthetic.make_synthetic_scene(num_images=2, H=8, W=8,
                                           n_render_samples=16)
  np.testing.assert_array_equal(scene.images, jscene.images)
  pose, K = scene.poses[1], scene.intrinsics[1]

  jrays = jraygen.rays_for_image(jnp.asarray(pose), jnp.asarray(K), 8, 8,
                                 scene.near, scene.far)
  want = jrenderer.render_image(
      jrenderer.make_eval_render_fn(jmodel, variables["params"]), jrays,
      chunk=64)
  trays = raygen.rays_for_image(torch.from_numpy(pose), torch.from_numpy(K),
                                8, 8, scene.near, scene.far)
  got = renderer.render_image(renderer.make_eval_render_fn(tmodel), trays,
                              chunk=24)
  assert got["rgb"].shape == (8, 8, 3) and got["distance"].shape == (8, 8, 1)
  _assert_render_close(got, want)


@pytest.mark.parametrize("render_factor", [0, 2])
def test_rays_for_image_parity(render_factor):
  rng = np.random.RandomState(4)
  c2w = np.concatenate([np.linalg.qr(rng.normal(size=(3, 3)))[0],
                        rng.normal(size=(3, 1))], 1).astype(np.float32)
  K = np.array([[50.0, 0, 20.5], [0, 52.0, 15.0], [0, 0, 1]], np.float32)
  want = jraygen.rays_for_image(jnp.asarray(c2w), jnp.asarray(K), 12, 16,
                                0.5, 30.0, render_factor=render_factor)
  got = raygen.rays_for_image(torch.from_numpy(c2w), torch.from_numpy(K),
                              12, 16, 0.5, 30.0,
                              render_factor=render_factor)
  for f in dataclasses.fields(got):
    np.testing.assert_allclose(getattr(got, f.name).numpy(),
                               np.asarray(getattr(want, f.name)),
                               atol=1e-6, rtol=1e-6, err_msg=f.name)


def test_model_config_matches_jax_adapter():
  cfg = load_config(["--config", "configs/nuScenes_depth_6cams"])
  got = dataclasses.asdict(tconfig.model_config(cfg))
  want = dataclasses.asdict(cfg.model_config())
  # float32 in both: no flag sets the mip model's compute dtype
  assert str(got.pop("compute_dtype")) == "torch.float32"
  assert want["compute_dtype"].__name__ == "float32"
  for k, v in got.items():
    assert want[k] == v, k
  assert (got["hidden_layer"], got["rgb_layer"], got["num_fine"]) == \
      (1024, 3, 128)


def test_glorot_init_is_seeded():
  cfg = MipNerfConfig(**SMALL)
  a = glorot_init_(MipNerfModel(cfg, device="cpu"), seed=5).state_dict()
  b = glorot_init_(MipNerfModel(cfg, device="cpu"), seed=5).state_dict()
  c = glorot_init_(MipNerfModel(cfg, device="cpu"), seed=6).state_dict()
  w = "mlp.layers.1.layers.0.weight"
  assert torch.equal(a[w], b[w]) and not torch.equal(a[w], c[w])
  assert float(a[w].abs().max()) <= np.sqrt(6.0 / 256) + 1e-7
  assert float(a["mlp.layers.1.layers.0.bias"].abs().max()) == 0.0
