"""The branches of the port's zip-nerf training that the shipped
waymo_zipnerf config leaves off, against snerf_tpu on the same numbers
and draws (the helpers and the set-up of tests/test_torch_zip_trainer.py):
one step with the pose window (SGD on the pose table) and the EMA, and
the randomized model forward with density noise and a random background.

Tolerances, float32 on the CPU on both sides: the step's loss and metrics
within 1e-5 relative, the pose grads and the pose update within 1e-4 of
their tensor's max, the param and EMA updates as
`_assert_update_matches` says; the forward's ray history and renderings
within 1e-4 relative plus 1e-5 absolute (the resampling moves
continuously with a ~1e-7 change of a proposal weight).
"""

import jax
import numpy as np
import pytest
import torch

from snerf_tpu.models.zipnerf import ZipNerfConfig as JaxModelConfig
from snerf_tpu.models.zipnerf import ZipNerfModel as JaxModel
from snerf_tpu.models.zipnerf import init_zipnerf
from snerf_tpu.ops.rays import Rays as JaxRays
from snerf_tpu_torch.models.zipnerf import ZipNerfConfig, ZipNerfModel
from snerf_tpu_torch.ops.rays import Rays
from snerf_tpu_torch.utils.weights import zip_state_dict_from_flax
from tests.test_torch_zip_trainer import (MODEL, TABLE_SCALE, _model_draws,
                                          _np, _to_zip_draws, check_one_step)


def test_pose_window_and_ema_step_matches_jax():
  """Loss, metrics and the param updates, plus the pose grads, the pose
  update inside the window and the EMA update."""
  check_one_step("pose_ema")


@pytest.mark.parametrize("noise_bg", [False, True])
def test_randomized_forward_matches_jax(noise_bg):
  """The randomized model forward with injected draws against JAX's with
  the key they were drawn from, at train_frac 0.3 (anneal < 1); with
  density noise and a random background range too."""
  extra = dict(density_noise=0.5, bg_intensity_range=(0.0, 1.0)) \
      if noise_bg else {}
  jmcfg = JaxModelConfig(**MODEL, **extra)
  tmcfg = ZipNerfConfig(**MODEL, **extra)
  params = _np(jax.jit(lambda k: init_zipnerf(k, jmcfg)[1])(
      jax.random.PRNGKey(3))["params"])
  for mlp in params.values():
    mlp["grid"]["table"] = mlp["grid"]["table"] * TABLE_SCALE
  tmodel = ZipNerfModel(tmcfg)
  tmodel.load_state_dict(zip_state_dict_from_flax(params))
  rng = np.random.RandomState(0)
  n = 24
  d = rng.normal(size=(n, 3)).astype(np.float32)
  rays = dict(origins=(rng.normal(size=(n, 3)) * 0.3).astype(np.float32),
              directions=d,
              viewdirs=d / np.linalg.norm(d, axis=-1, keepdims=True),
              radii=np.full((n, 1), 0.003, np.float32),
              lossmult=np.ones((n, 1), np.float32),
              near=np.full((n, 1), 0.2, np.float32),
              far=np.full((n, 1), 8.0, np.float32),
              app=np.zeros((n, 1), np.int32))
  key = jax.random.PRNGKey(5)
  jr, jh = jax.jit(lambda p, r, k: JaxModel(config=jmcfg).apply(
      {"params": p}, JaxRays(**r), rng=k, train_frac=0.3))(params, rays, key)
  draws = _to_zip_draws(*_np(jax.jit(
      lambda k: _model_draws(k, jmcfg, n))(key)), jmcfg)
  tr, th = tmodel(Rays(**{k: torch.from_numpy(v) for k, v in rays.items()}),
                  draws=draws, train_frac=0.3)
  for lvl in range(3):
    for k in ("sdist", "tdist", "weights", "density"):
      np.testing.assert_allclose(th[lvl][k].detach().numpy(),
                                 np.asarray(jh[lvl][k]), rtol=1e-4,
                                 atol=1e-5, err_msg=f"{lvl} {k}")
  for k in ("rgb", "depth", "acc", "semantic"):
    np.testing.assert_allclose(tr[-1][k].detach().numpy(),
                               np.asarray(jr[-1][k]), rtol=1e-4, atol=1e-5,
                               err_msg=k)
