"""The port's hash encoder, zip model and zip render path against
snerf_tpu, on the same weights and numpy-seeded inputs.

Weights come from the JAX package's `init_zipnerf`, with the hash tables
scaled from +-1e-4 up to +-1 so that the gathered rows move the render,
and cross over through `zip_state_dict_from_flax`. Tolerances: hash
indices are integers and must be equal. Encoded features agree to 1e-6
(float32 trilinear sums in another order). The rendered rgb, acc and
semantic agree to 1e-4 absolute and distance to 1e-4 relative: the
samplers' grids differ from jnp.linspace in the last ulp, and a proposal
level's density error moves the next level's intervals by as much times
the inverse-CDF slope, but continuously, never by a bin.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snerf_tpu.config import load_config
from snerf_tpu.data import raygen as jraygen
from snerf_tpu.models import hashgrid as jhashgrid
from snerf_tpu.models.zipnerf import ZipNerfConfig as JaxConfig
from snerf_tpu.models.zipnerf import ZipNerfModel as JaxModel
from snerf_tpu.models.zipnerf import init_zipnerf
from snerf_tpu.ops.rays import Rays as JaxRays
from snerf_tpu.train import renderer as jrenderer
from snerf_tpu.utils.ref_import import map_zip_state_dict
from snerf_tpu_torch import config as tconfig
from snerf_tpu_torch.data import raygen, synthetic
from snerf_tpu_torch.models import hashgrid
from snerf_tpu_torch.models.zipnerf import ZipNerfConfig, ZipNerfModel
from snerf_tpu_torch.ops.hash_ops import gather_rows_plain
from snerf_tpu_torch.ops.rays import Rays
from snerf_tpu_torch.train import renderer
from snerf_tpu_torch.utils.weights import zip_init_, zip_state_dict_from_flax

# 4 hash levels; log2 13 keeps level 0 (17^3 rows) dense, the rest hashed
SMALL = dict(num_prop_samples=(8, 8), num_nerf_samples=8,
             prop_grid_resolutions=(64, 128), nerf_grid_resolution=256,
             grid_num_levels=4, grid_log2_hashmap_size=13,
             bottleneck_width=32, net_width_viewdirs=16, sample_n=3,
             use_semantic=True, class_num=5)
TABLE_SCALE = 1e4   # +-1e-4 init -> +-1


def _np_params(variables):
  return jax.tree_util.tree_map(np.asarray, variables["params"])


@functools.lru_cache(maxsize=None)
def _pair():
  """(JAX model, its params with scaled tables, the port's model)."""
  jcfg = JaxConfig(**SMALL)
  variables = jax.jit(lambda k: init_zipnerf(k, jcfg)[1])(
      jax.random.PRNGKey(0))
  params = _np_params(variables)
  for mlp in params.values():
    mlp["grid"]["table"] = mlp["grid"]["table"] * TABLE_SCALE
  tmodel = ZipNerfModel(ZipNerfConfig(**SMALL), device="cpu")
  tmodel.load_state_dict(zip_state_dict_from_flax(params))
  return JaxModel(config=jcfg), params, tmodel


def _rays_np(n, seed=0):
  rng = np.random.RandomState(seed)
  d = rng.normal(size=(n, 3)).astype(np.float32)
  d[0] = [0.0, 0.0, 1.5]           # the alternate ray-basis branch
  return dict(
      origins=(rng.normal(size=(n, 3)) * 0.3).astype(np.float32),
      directions=d, viewdirs=d / np.linalg.norm(d, axis=-1, keepdims=True),
      radii=np.full((n, 1), 0.003, np.float32),
      lossmult=np.ones((n, 1), np.float32),
      near=np.full((n, 1), 0.2, np.float32),
      far=np.full((n, 1), 8.0, np.float32),
      app=np.zeros((n, 1), np.int32))


def _assert_render_close(got, want):
  for k in ("rgb", "acc", "semantic"):
    np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]),
                               atol=1e-4, rtol=0, err_msg=k)
  np.testing.assert_allclose(np.asarray(got["distance"]),
                             np.asarray(want["distance"]), rtol=1e-4,
                             atol=0)


# --- hash grid --------------------------------------------------------------


@pytest.mark.parametrize("lvl", [0, 1, 3])
def test_level_indices_equal_jax(lvl):
  """Dense (level 0) and hashed levels, corners outside the grid and
  negative ones included, which wrap in the uint32 hash."""
  spec = jhashgrid.make_grid_spec(4, 4, 8, 256, 12)
  res, size = spec.resolutions[lvl], spec.sizes[lvl]
  assert ((res + 1) ** 3 <= size) == (lvl == 0)
  rng = np.random.RandomState(lvl)
  c0 = rng.randint(-4, res + 3, (400, 3)).astype(np.int32)
  c0[:2] = [[-1, -2, -3], [2 ** 20, -(2 ** 20), 7]]
  want = jhashgrid._level_indices(
      jnp.asarray(c0)[:, None, :] + jhashgrid._CORNERS[None], res, size)
  got = hashgrid._level_indices(torch.from_numpy(c0).long(), res, size)
  np.testing.assert_array_equal(got.numpy(), np.asarray(want))

  x = rng.uniform(0, 1, (500, 3)).astype(np.float32)
  jidx, jw = jhashgrid._level_rows_weights(jnp.asarray(x), spec, lvl)
  idx, w = hashgrid._level_rows_weights(torch.from_numpy(x), spec, lvl)
  assert idx.dtype == torch.int32
  np.testing.assert_array_equal(idx.numpy() + spec.offsets[lvl],
                                np.asarray(jidx))
  np.testing.assert_allclose(w.numpy(), np.asarray(jw), atol=1e-6)


def test_hash_encode_matches_jax():
  spec = jhashgrid.make_grid_spec(4, 4, 8, 256, 12)
  tspec = hashgrid.make_grid_spec(4, 4, 8, 256, 12)
  assert dataclasses.astuple(tspec) == dataclasses.astuple(spec)
  rng = np.random.RandomState(0)
  table = rng.uniform(-1, 1, (spec.total_rows, 4)).astype(np.float32)
  # in [0, 1], and outside it (zero features)
  x = rng.uniform(-0.05, 1.05, (6, 40, 3)).astype(np.float32)
  want = jhashgrid.hash_encode(jnp.asarray(x), jnp.asarray(table), spec)
  got = hashgrid.hash_encode(torch.from_numpy(x), torch.from_numpy(table),
                             tspec)
  assert got.shape == (6, 40, 4, 4)
  np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
  oob = ((x < 0) | (x > 1)).any(-1)
  assert oob.any() and not got.numpy()[oob].any()


def test_hash_encoding_grid_sizes_and_layout():
  enc = hashgrid.HashEncoding(num_levels=4, level_dim=2, base_resolution=16,
                              desired_resolution=128, log2_hashmap_size=12,
                              device="cpu")
  spec = jhashgrid.make_grid_spec(4, 2, 16, 128, 12)
  assert tuple(enc.embeddings.shape) == (spec.total_rows, 2)
  assert float(enc.embeddings.detach().abs().max()) <= 1e-4
  grid_sizes = np.asarray(spec.resolutions, np.float32) + 1.0
  np.testing.assert_array_equal(enc.grid_sizes.numpy(), grid_sizes)
  assert "grid_sizes" not in enc.state_dict()


# --- weights ----------------------------------------------------------------


def test_bridge_round_trip():
  _, params, tmodel = _pair()
  back = map_zip_state_dict(tmodel.state_dict())
  assert jax.tree_util.tree_structure(back) == \
      jax.tree_util.tree_structure(params)
  for a, b in zip(jax.tree_util.tree_leaves(back),
                  jax.tree_util.tree_leaves(params)):
    np.testing.assert_array_equal(a, b)


def test_bridge_rejects_unported_parameters():
  _, params, _ = _pair()
  bad = dict(params, nerf_mlp=dict(params["nerf_mlp"],
                                   normals_head=params["nerf_mlp"]["rgb_out"]))
  with pytest.raises(ValueError):
    zip_state_dict_from_flax(bad)


@pytest.mark.parametrize("density_zero_init", [False, True])
def test_zip_init_is_seeded_lecun(density_zero_init):
  cfg = ZipNerfConfig(**dict(SMALL, density_zero_init=density_zero_init,
                             density_hidden_width=256))
  a = zip_init_(ZipNerfModel(cfg, device="cpu"), seed=5).state_dict()
  b = zip_init_(ZipNerfModel(cfg, device="cpu"), seed=5).state_dict()
  c = zip_init_(ZipNerfModel(cfg, device="cpu"), seed=6,
                table_scale=0.5).state_dict()
  w = "nerf_mlp.density_layer.2.weight"     # [bottleneck, 256]
  assert torch.equal(a[w], b[w]) and not torch.equal(a[w], c[w])
  # truncated at 2 std, variance 1 / fan_in after truncation
  std = float(a[w][1:].std())
  assert abs(std - np.sqrt(1 / 256)) < 0.05 * np.sqrt(1 / 256)
  limit = 2 * np.sqrt(1 / 256) / 0.87962566103423978
  assert float(a[w].abs().max()) <= limit + 1e-7
  assert float(a["nerf_mlp.density_layer.2.bias"].abs().max()) == 0.0
  assert bool((a[w][0] == 0).all()) == density_zero_init
  table = "prop_mlp_1.encoder.embeddings"
  assert float(a[table].abs().max()) <= 1e-4
  assert 0.45 < float(c[table].abs().max()) <= 0.5


# --- config -----------------------------------------------------------------


def test_zip_model_config_matches_jax_adapter():
  cfg = load_config(["--config", "configs/waymo_zipnerf"])
  got = dataclasses.asdict(tconfig.zip_model_config(cfg))
  want = dataclasses.asdict(cfg.zip_model_config())
  for k, v in got.items():
    assert want[k] == v, k
  assert (got["num_prop_samples"], got["num_nerf_samples"],
          got["grid_log2_hashmap_size"], got["use_semantic"],
          got["class_num"]) == ((64, 64), 32, 21, True, 19)


@pytest.mark.parametrize("flag", [
    ("--zip_encoder", "cp_hash"), ("--zip_encoder", "ipe"),
    ("--zip_glo_features", "4"), "disable_density_normals",
    "enable_pred_normals", "use_directional_enc", "use_reflections",
    "enable_pred_roughness"])
def test_unported_flags_raise(flag):
  if isinstance(flag, tuple):
    cfg = load_config(["--config", "configs/waymo_zipnerf", *flag])
    with pytest.raises(NotImplementedError):
      tconfig.zip_model_config(cfg)
  else:
    value = flag != "disable_density_normals"
    with pytest.raises(NotImplementedError):
      ZipNerfConfig(**{flag: value})


# --- the model and the render path ------------------------------------------


def test_model_eval_forward_parity():
  jmodel, params, tmodel = _pair()
  r = _rays_np(24)
  want, jhist = jax.jit(lambda p, rays: jmodel.apply(
      {"params": p}, rays, rng=None))(params, JaxRays(**r))
  with torch.inference_mode():
    got, hist = tmodel(Rays(**{k: torch.from_numpy(v) for k, v in r.items()}))
  assert len(got) == len(want) == 3
  for g, w in zip(hist, jhist):
    for k in ("sdist", "weights"):
      np.testing.assert_allclose(g[k].numpy(), np.asarray(w[k]), atol=1e-4,
                                 err_msg=k)
  for g, w in zip(got, want):
    for k in ("rgb", "acc"):
      np.testing.assert_allclose(g[k].numpy(), np.asarray(w[k]), atol=1e-4,
                                 err_msg=k)
    np.testing.assert_allclose(g["depth"].numpy(), np.asarray(w["depth"]),
                               rtol=1e-4)
  np.testing.assert_allclose(got[-1]["semantic"].numpy(),
                             np.asarray(want[-1]["semantic"]), atol=1e-4)
  # the tables matter: the same rays with zeroed tables render otherwise
  zeroed = ZipNerfModel(tmodel.config, device="cpu")
  zeroed.load_state_dict(tmodel.state_dict())
  with torch.no_grad():
    for mlp in zeroed.mlps():
      mlp.encoder.embeddings.zero_()
    flat = zeroed(Rays(**{k: torch.from_numpy(v) for k, v in r.items()}))[0]
  assert float((flat[-1]["rgb"] - got[-1]["rgb"]).abs().max()) > 1e-3


def test_render_image_parity_on_synthetic_view():
  """The whole slice: synthetic scene -> rays_for_image ->
  make_zip_eval_render_fn -> render_image, port against JAX, 8x8 view,
  with a ragged last chunk on the port's side."""
  jmodel, params, tmodel = _pair()
  scene = synthetic.make_synthetic_scene(num_images=2, H=8, W=8,
                                         n_render_samples=16)
  pose, K = scene.poses[1], scene.intrinsics[1]
  jrays = jraygen.rays_for_image(jnp.asarray(pose), jnp.asarray(K), 8, 8,
                                 scene.near, scene.far)
  want = jrenderer.render_image(
      functools.partial(jrenderer.make_zip_param_render_fn(jmodel), params),
      jrays, chunk=64)
  trays = raygen.rays_for_image(torch.from_numpy(pose), torch.from_numpy(K),
                                8, 8, scene.near, scene.far)
  got = renderer.render_image(renderer.make_zip_eval_render_fn(tmodel), trays,
                              chunk=24)
  assert got["rgb"].shape == (8, 8, 3) and got["distance"].shape == (8, 8, 1)
  assert got["semantic"].shape == (8, 8, 5)
  _assert_render_close(got, want)
  # a model whose gathers run the plain version renders the same bits
  plain = ZipNerfModel(tmodel.config, gather_fn=gather_rows_plain,
                       device="cpu")
  plain.load_state_dict(tmodel.state_dict())
  again = renderer.render_image(renderer.make_zip_eval_render_fn(plain),
                                trays, chunk=24)
  for k in got:
    assert torch.equal(got[k], again[k]), k
