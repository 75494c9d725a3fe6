"""cli.eval against the JAX package on the same weights.

JAX-initialised params (snerf_tpu's create_train_state /
create_zip_train_state; the zip tables scaled from +-1e-4 to +-1 so that
they move the render), carried over by utils/weights.py and saved as a
port checkpoint with the flags' snapshot, give cli.eval per-image PSNR
and SSIM within 1e-4 of the JAX package's render_image plus
MetricHarness on the same weights and held-out views of
configs/synthetic_tiny at narrow widths (float32 on the CPU on both
sides; the renders agree to ~1e-6, tests/test_torch_mipnerf.py and
test_torch_zipnerf.py).
"""

import dataclasses
import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from snerf_tpu.config import load_config as jax_load_config
from snerf_tpu.data import make_synthetic_scene as jax_synthetic_scene
from snerf_tpu.data.raygen import rays_for_image as jax_rays_for_image
from snerf_tpu.train import renderer as jrenderer
from snerf_tpu.train.trainer import create_train_state as jax_train_state
from snerf_tpu.train.zip_trainer import \
    create_zip_train_state as jax_zip_state
from snerf_tpu.utils.metrics import MetricHarness as JaxHarness
from snerf_tpu_torch.cli import common
from snerf_tpu_torch.cli import eval as cli_eval
from snerf_tpu_torch.flags import load_config, snapshot_config
from snerf_tpu_torch.train import checkpoints as ckpt_lib
from snerf_tpu_torch.utils.weights import (train_state_from_flax,
                                           zip_train_state_from_flax)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(REPO, "configs", "synthetic_tiny")
MIP_NARROW = ["--N_samples", "8", "--N_fine", "8", "--hidden_layer", "16",
              "--proposal_hidden_layer", "16"]
ZIP_NARROW = ["--model", "zipnerf", "--zip_num_prop_samples", "(4, 4)",
              "--zip_num_nerf_samples", "4", "--zip_sample_n", "2",
              "--zip_grid_num_levels", "3", "--zip_log2_hashmap_size", "10",
              "--zip_bottleneck_width", "16",
              "--zip_prop_grid_resolutions", "(32, 64)",
              "--zip_nerf_grid_resolution", "128",
              "--zip_compute_dtype", "float32"]
TOL = 1e-4


@pytest.fixture(autouse=True)
def _no_tensorboard(monkeypatch):
  """The logger is not used here; keep TensorFlow out of the process."""
  monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


def _jax_view_metrics(render_fn, jscene, chunk):
  out = []
  harness = JaxHarness()
  H, W = jscene.hw
  for ti in jscene.i_test:
    rays = jax_rays_for_image(jnp.asarray(jscene.poses[ti]),
                              jnp.asarray(jscene.intrinsics[ti]), H, W,
                              jscene.near, jscene.far)
    rgb = jrenderer.render_image(render_fn, rays, chunk=chunk)["rgb"]
    gt = jnp.asarray(jscene.images[ti].astype(np.float32) / 255.0)
    out.append(harness(jnp.asarray(rgb), gt))
  return out


def _np(tree):
  return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("family", ["mip", "zip"])
def test_eval_matches_jax_on_jax_weights(tmp_path, family):
  """cli.eval on a port checkpoint of JAX-initialised params against the
  JAX package's render_image + MetricHarness on the same params."""
  argv = ["--config", TINY, "--basedir", str(tmp_path),
          *(MIP_NARROW if family == "mip" else ZIP_NARROW)]
  cfg, jcfg = load_config(argv), jax_load_config(argv)
  jscene = jax_synthetic_scene(num_images=max(6, jcfg.cam_num), H=jcfg.H,
                               W=jcfg.W, datahold=jcfg.datahold)
  n = jscene.num_images
  _, state = common.build_model_state(cfg, n, "cpu")
  if family == "mip":
    model, _, jstate = jax_train_state(jax.random.PRNGKey(0),
                                       jcfg.model_config(),
                                       jcfg.train_config(), n)
    params = _np(jstate.params)
    train_state_from_flax(
        state, params, None if jstate.pose_params is None
        else _np(jstate.pose_params))
    render_fn = jrenderer.make_eval_render_fn(model, params,
                                              white_bkgd=jcfg.white_bkgd)
  else:
    mcfg = dataclasses.replace(jcfg.zip_model_config(),
                               compute_dtype=jnp.float32)
    model, jstate = jax_zip_state(jax.random.PRNGKey(0), mcfg,
                                  jcfg.zip_train_config())
    params = _np(jstate.params)
    for mlp in params.values():
      mlp["grid"]["table"] = mlp["grid"]["table"] * 1e4
    zip_train_state_from_flax(state, params)
    render_fn = functools.partial(jrenderer.make_zip_param_render_fn(model),
                                  params)
  snapshot_config(cfg)
  ckpt_lib.save_checkpoint(os.path.join(cfg.exp_dir(), "checkpoints"),
                           state, 1)
  got = cli_eval.main(["--config", TINY, "--basedir", str(tmp_path), "--device", "cpu"])
  want = _jax_view_metrics(render_fn, jscene, cfg.chunk)
  assert [r["img"] for r in got["per_image"]] == list(jscene.i_test)
  for g, w in zip(got["per_image"], want):
    assert abs(g["psnr"] - w["psnr"]) <= TOL, (g, w)
    assert abs(g["ssim"] - w["ssim"]) <= TOL, (g, w)


