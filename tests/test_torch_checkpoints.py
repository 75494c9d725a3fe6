"""The port's checkpoints (snerf_tpu_torch/train/checkpoints.py): a mip
TrainState (also with the depth confidence on) and a ZipTrainState, each
with its pose model and EMA, trained two steps, saved, and restored into
a state made from another seed come back bit for bit (model params,
every Adam moment and step count, the step, the pose table and its
optimizer, the confidence lambdas and their optimizer, the EMA), and the
next step from either is bit-identical. Keep-k pruning, latest_step, the
pose stream and the flag mismatch error. CPU, tiny widths."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from snerf_tpu_torch.data.sampler import scene_to_device
from snerf_tpu_torch.data.synthetic import make_synthetic_scene
from snerf_tpu_torch.models.mipnerf import MipNerfConfig
from snerf_tpu_torch.models.zipnerf import ZipNerfConfig
from snerf_tpu_torch.train import checkpoints as C
from snerf_tpu_torch.train import trainer, zip_trainer

MIP = MipNerfConfig(num_samples=8, num_fine=8, hidden_layer=16,
                    proposal_hidden_layer=16, max_deg_point=8)
MIP_TRAIN = trainer.TrainConfig(n_rgb=32, depth_loss=True, pose_refine=True,
                                ema_decay=0.9, lrate_delay_steps=0)
ZIP = ZipNerfConfig(num_prop_samples=(8, 8), num_nerf_samples=8,
                    grid_num_levels=4, grid_log2_hashmap_size=10,
                    prop_grid_resolutions=(32, 64), nerf_grid_resolution=128,
                    bottleneck_width=16, net_width_viewdirs=16)
ZIP_TRAIN = zip_trainer.ZipTrainConfig(batch_size=32, lr_delay_steps=0,
                                       pose_refine=True, pose_start_step=0,
                                       ema_decay=0.9)


@pytest.fixture(scope="module")
def scene():
  return make_synthetic_scene(num_images=4, H=8, W=8, n_render_samples=8)


def _mip(scene, seed):
  model, pose, state = trainer.create_train_state(
      seed, MIP, MIP_TRAIN, scene.num_images, device="cpu")
  step = trainer.make_train_step(model, pose, MIP_TRAIN,
                                 scene_to_device(scene, "cpu"),
                                 scene.i_train, scene.near, scene.far)
  return state, step


def _mip_conf(scene, seed):
  """The mip state with the depth confidence on, on seeded uint8 maps."""
  cfg = dataclasses.replace(MIP_TRAIN, depth_conf=True,
                            conf_modes=("rgb", "depth"))
  model, pose, state = trainer.create_train_state(
      seed, MIP, cfg, scene.num_images, device="cpu")
  maps = torch.from_numpy(np.random.RandomState(4).randint(
      0, 256, (len(scene.i_train), 2, 8, 8)).astype(np.uint8))
  step = trainer.make_train_step(model, pose, cfg,
                                 scene_to_device(scene, "cpu"),
                                 scene.i_train, scene.near, scene.far,
                                 conf_maps=maps)
  return state, step


def _zip(scene, seed):
  state = zip_trainer.create_zip_train_state(seed, ZIP, ZIP_TRAIN,
                                             scene.num_images, device="cpu")
  step = zip_trainer.make_zip_train_step(
      state.model, ZIP_TRAIN, scene_to_device(scene, "cpu"), scene.i_train,
      scene.near, scene.far)
  return state, step


def _equal(a, b, path=""):
  """Nested payloads equal, tensors bit for bit; returns the first
  difference or None."""
  if isinstance(a, dict):
    if set(a) != set(b):
      return f"{path}: keys {set(a) ^ set(b)}"
    for k in a:
      d = _equal(a[k], b[k], f"{path}/{k}")
      if d:
        return d
    return None
  if isinstance(a, (list, tuple)):
    if len(a) != len(b):
      return f"{path}: length"
    for i, (x, y) in enumerate(zip(a, b)):
      d = _equal(x, y, f"{path}[{i}]")
      if d:
        return d
    return None
  if torch.is_tensor(a):
    same = (a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8)))
    return None if same else f"{path}: tensor"
  return None if a == b else f"{path}: {a!r} != {b!r}"


def _gen(seed):
  return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("family", ["mip", "zip", "mip_conf"])
def test_round_trip_bit_equal(tmp_path, scene, family):
  make = {"mip": _mip, "zip": _zip, "mip_conf": _mip_conf}[family]
  state, step = make(scene, 0)
  gen = _gen(1)
  for _ in range(2):
    step(state, gen)
  assert state.step == 2 and state.ema is not None
  assert state.pose_model is not None
  if family == "mip_conf":
    assert float(state.conf_model.lambdas.detach().abs().max()) > 0
    assert set(C.state_payload(state)) >= {"conf_model", "conf_optimizer"}
  ckpt = str(tmp_path / "ckpt")
  C.save_checkpoint(ckpt, state, state.step)
  assert C.latest_step(ckpt) == 2

  other, other_step = make(scene, 7)
  assert _equal(C.state_payload(other), C.state_payload(state)) is not None
  other, got = C.restore_checkpoint(ckpt, other)
  assert got == 2
  assert _equal(C.state_payload(other), C.state_payload(state)) is None
  # the next step from the restored state is the original's, bit for bit
  m1 = step(state, _gen(5))
  m2 = other_step(other, _gen(5))
  assert float(m1["loss"]) == float(m2["loss"])
  assert _equal(C.state_payload(other), C.state_payload(state)) is None


def test_keep_k_latest_and_specific_step(tmp_path, scene):
  state, step = _mip(scene, 0)
  ckpt = str(tmp_path / "ckpt")
  assert C.latest_step(ckpt) is None
  fresh, _ = _mip(scene, 3)
  assert C.restore_checkpoint(ckpt, fresh) == (fresh, None)
  gen = _gen(2)
  saved = {}
  for i in range(1, 6):
    step(state, gen)
    C.save_checkpoint(ckpt, state, i, keep=2)
    saved[i] = C.state_payload(state)
  assert C.latest_step(ckpt) == 5
  assert sorted(os.listdir(ckpt)) == ["000000004.pt", "000000005.pt"]
  fresh, got = C.restore_checkpoint(ckpt, fresh, step=4)
  assert got == 4 and fresh.step == 4
  assert _equal(C.state_payload(fresh), saved[4]) is None
  with pytest.raises(FileNotFoundError):
    C.restore_checkpoint(ckpt, fresh, step=2)


def test_pose_stream(tmp_path, scene):
  state, _ = _mip(scene, 0)
  with torch.no_grad():
    state.pose_model.r.copy_(torch.arange(12.0).reshape(4, 3))
  for i in (3, 6):
    C.save_pose_checkpoint(str(tmp_path), state.pose_model.state_dict(), i,
                           keep=3)
  pose, got = C.restore_pose_checkpoint(str(tmp_path))
  assert got == 6
  np.testing.assert_array_equal(pose["r"].numpy(),
                                np.arange(12.0).reshape(4, 3))
  assert C.restore_pose_checkpoint(str(tmp_path / "none")) == (None, None)


def test_flag_mismatch_raises(tmp_path, scene):
  state, _ = _mip(scene, 0)
  C.save_checkpoint(str(tmp_path), state, 1)
  model, pose, no_pose = trainer.create_train_state(
      0, MIP, trainer.TrainConfig(n_rgb=32), scene.num_images, device="cpu")
  with pytest.raises(ValueError, match="pose_model"):
    C.restore_checkpoint(str(tmp_path), no_pose)
  conf_state, _ = _mip_conf(scene, 0)
  with pytest.raises(ValueError, match="conf_model"):
    C.restore_checkpoint(str(tmp_path), conf_state)
