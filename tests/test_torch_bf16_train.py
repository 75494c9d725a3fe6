"""One zip train step in bf16 against snerf_tpu's in bf16, with the JAX
step's own draws injected (`ZipStepDraws`): the hash arm
(configs/waymo_zipnerf's encoder at the tiny widths of
tests/test_torch_zip_trainer.py) and the cp_hash arm
(configs/waymo_zipnerf_tpu's: the cylinder cast, centred CP features,
one fine hash level, at the tiny widths of
tests/test_torch_zip_arms_train.py with a 128-wide trunk). Both models in
compute_dtype bfloat16 from the same float32 weights; the loss and the
gradients before any clipping, per parameter group.

As in tests/test_torch_bf16.py each tolerance sits between the sound
reading (the port in bf16) and a control (the port in float32), both
against JAX in bf16, relative L2 over the group's gradients. Readings,
hash / cp_hash, sound then control:
  loss (relative)              9.0e-6 / 1.5e-5,  2.4e-5 / 3.8e-5
  hash tables "grid"           1.1e-3,           5.9e-3
  CP levels "grid0", "grid1"   2.7e-3, 3.4e-3;   1.4e-2, 1.7e-2
  "net" weights                1.3e-3 / 1.4e-3,  1.0e-2 / 8.5e-3
  cp_hash's "hash_fine"        1.2e-2,           6.2e-2
The "net" biases read 1.2e-2 / 7.0e-3 and their control the same (1.3e-2
/ 7.3e-3): XLA sums each bf16 bias cotangent in its own way on the CPU
(tests/test_torch_bf16.py), where the port sums in float32 and rounds
once; they are bounded at 2e-2.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snerf_tpu.data import sampler as jsampler
from snerf_tpu.data import synthetic as jsynthetic
from snerf_tpu.models.zipnerf import ZipNerfConfig as JaxConfig
from snerf_tpu.models.zipnerf import ZipNerfModel as JaxModel
from snerf_tpu.train import zip_trainer as jtrainer
from snerf_tpu_torch.data import sampler, synthetic
from snerf_tpu_torch.models.zipnerf import ZipNerfConfig
from snerf_tpu_torch.train import zip_trainer as trainer
from snerf_tpu_torch.utils.weights import (zip_state_dict_from_flax,
                                           zip_train_state_from_flax)
from tests import test_torch_zip_arms_train as arms_train
from tests import test_torch_zip_trainer as zip_trainer
from tests.test_torch_zip_arms import _scale_fine

ARMS = {
    "hash": (dict(zip_trainer.MODEL),
             dict(zip_trainer.BASE, debug_grad_norms=False)),
    "cp_hash": (dict(arms_train.STEP_MODEL, ipe_density_width=128),
                dict(arms_train.STEP_TRAIN, debug_grad_norms=False)),
}
# the limits: each sound reading must sit at or below its limit and each
# control above it
LOSS_TOL = {"hash": 1.5e-5, "cp_hash": 2.5e-5}
GROUP_TOL = {"grid": 3e-3, "grid0": 7e-3, "grid1": 7e-3, "net": 4e-3,
             "hash_fine": 3e-2}
BIAS_BOUND = 2e-2


def rel(got, want):
  return float(np.linalg.norm(np.float64(got) - np.float64(want))
               / max(np.linalg.norm(np.float64(want)), 1e-30))


def _jax_side(arm):
  """The JAX bf16 state, its loss and pre-clip grads by port name, the
  step's draws and the scene."""
  mkw, train = ARMS[arm]
  scene, jscene = zip_trainer._scene(synthetic), zip_trainer._scene(
      jsynthetic)
  jdev = jsampler.scene_to_device(jscene)
  jtcfg = jtrainer.ZipTrainConfig(**train)
  jmcfg = JaxConfig(**mkw, compute_dtype=jnp.bfloat16)
  jstate = jax.jit(lambda k: jtrainer.create_zip_train_state(
      k, jmcfg, jtcfg, num_images=scene.num_images)[1])(
          jax.random.PRNGKey(0))
  params = zip_trainer._np(jstate.params)
  if arm == "hash":
    for mlp in params.values():
      mlp["grid"]["table"] = mlp["grid"]["table"] * zip_trainer.TABLE_SCALE
  else:
    params = _scale_fine(params)
  jstep = jtrainer.make_zip_train_step(
      JaxModel(config=jmcfg), jmcfg, jtcfg, jdev, scene.i_train, scene.near,
      scene.far, donate=False)
  fn = jstep.func.__wrapped__
  cells = dict(zip(fn.__code__.co_freevars,
                   (c.cell_contents for c in fn.__closure__)))
  jgrad = jax.jit(jax.value_and_grad(
      lambda p, key, dev: cells["loss_fn"](dev, p, None, key, 0.0, 1.0)[0]))
  key = jax.random.PRNGKey(7)
  if arm == "hash":
    draws = zip_trainer._jax_draws(key, jtcfg, jmcfg, jdev, scene)
  else:
    draws = arms_train._step_draws(key, jtcfg, jmcfg, jdev, scene,
                                   ZipNerfConfig(**mkw))
  jloss, jgrads = jgrad(jax.tree_util.tree_map(jnp.asarray, params), key,
                        jdev)
  jgrads = {k: np.asarray(v) for k, v in zip_state_dict_from_flax(
      zip_trainer._np(jgrads)).items()}
  return scene, params, draws, float(jloss), jgrads


def _port_step(arm, scene, params, draws, dtype):
  """The port's loss and pre-clip grads {group: (weights, biases)} of one
  step in `dtype` from the same weights and draws."""
  mkw, train = ARMS[arm]
  tcfg = trainer.ZipTrainConfig(**train)
  state = trainer.create_zip_train_state(
      1, ZipNerfConfig(**mkw, compute_dtype=dtype), tcfg, scene.num_images,
      device="cpu")
  zip_train_state_from_flax(state, params)
  step = trainer.make_zip_train_step(
      state.model, dataclasses.replace(
          tcfg, grad_max_norm=0.0, encoder_grad_max_norm=0.0, lr_init=1e-30,
          lr_final=1e-30),
      sampler.scene_to_device(scene, "cpu"), scene.i_train, scene.near,
      scene.far)
  metrics = step(state, draws)
  named = dict(state.model.named_parameters())
  groups = {}
  for group in state.optimizer.param_groups:
    ids = {id(p) for p in group["params"]}
    groups[group["name"]] = [k for k, p in named.items() if id(p) in ids]
  if "nerf_mlp.hash_fine.embeddings" in named:
    groups["hash_fine"] = ["nerf_mlp.hash_fine.embeddings"]
    groups["net"].remove("nerf_mlp.hash_fine.embeddings")
  return float(metrics["loss"]), {
      g: [[(named[k].grad.numpy(), k) for k in names if k.endswith("bias")
           == bias] for bias in (False, True)]
      for g, names in groups.items() if names}


@pytest.mark.parametrize("arm", ARMS)
def test_bf16_zip_step_matches_jax(arm):
  scene, params, draws, jloss, jgrads = _jax_side(arm)
  res = {dt: _port_step(arm, scene, params, draws, dt)
         for dt in (torch.bfloat16, torch.float32)}

  def errs(dt):
    loss, groups = res[dt]
    out = {"loss": abs(loss - jloss) / abs(jloss)}
    for g, (weights, biases) in groups.items():
      for part, key in ((weights, g), (biases, g + " biases")):
        if part:
          out[key] = rel(np.concatenate([t.ravel() for t, _ in part]),
                         np.concatenate([jgrads[k].ravel() for _, k in part]))
    return out

  sound, control = errs(torch.bfloat16), errs(torch.float32)
  want_groups = ({"grid", "net"} if arm == "hash"
                 else {"grid0", "grid1", "net", "hash_fine"})
  assert {k for k in sound if " " not in k and k != "loss"} == want_groups
  assert sound["loss"] <= LOSS_TOL[arm] < control["loss"]
  for g in want_groups:
    assert sound[g] <= GROUP_TOL[g] < control[g], (g, sound[g], control[g])
  assert sound["net biases"] <= BIAS_BOUND
