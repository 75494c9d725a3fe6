"""The port's S-NeRF mip model and train step against the benchmark's plain
reference (bench_port/reference/: models/mipnerf.py, models/nerf_mlp.py,
train/trainer.py, models/confidence.py, mip_config.py) on the CPU, at
configs/nuScenes_depth_6cams' flags with narrow widths: hidden 64, 16 + 15
samples a ray, 128 rays a step on 24 x 32 views with depth; the warp, the
depth confidence (four uint8 maps, the scene's data) and the pose
refinement on, as shipped.

Both sides get the same weights (bench_port/weights.py's draw), the same
confidence maps and the same injected draws. The port runs K1's plain CPU
path (`fused_mlp_plain` forward, `fused_mlp_bwd_plain` backward under
`FusedMLPFunction`); the reference a chain of `addmm` under autograd.
Torch only, no JAX.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from bench_port import weights
from bench_port.reference import mip_config as ref_config
from bench_port.reference.flags import load_config as ref_load_config
from bench_port.reference.models import mipnerf as ref_mip
from bench_port.reference.models.confidence import \
    ConfidenceModel as RefConfidence
from bench_port.reference.models.posenet import LearnPose as RefPose
from bench_port.reference.train import trainer as ref_tr
from snerf_tpu_torch import config as port_config
from snerf_tpu_torch.data import sampler, synthetic
from snerf_tpu_torch.models import mipnerf
from snerf_tpu_torch.models.confidence import ConfidenceModel
from snerf_tpu_torch.models.posenet import LearnPose
from snerf_tpu_torch.train import losses
from snerf_tpu_torch.train import trainer as tr

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = ["--config", os.path.join(REPO, "configs", "nuScenes_depth_6cams"),
        "--N_rgb", "128", "--N_samples", "16", "--N_fine", "16",
        "--hidden_layer", "64", "--proposal_hidden_layer", "64",
        "--lrate_delay", "0"]
STEPS = 3
SEED = 17
# The same float32 operations on both sides but the trunks' square runs:
# K1's plain path and the addmm chain may round each layer's sum in
# another order (~1e-7 relative a layer), carried through 8 layers, the
# compositing and the backward: outputs and losses within 1e-5 relative.
RTOL = 1e-5
# Gradients: the same rounding, summed over 128 rays x 31 samples into
# each weight; a leaf's gap is taken over the leaf's norm (elements near
# zero carry the sum's absolute rounding), within 1e-5 of it.
GRAD_TOL = 1e-5
# The change after 3 Adam steps: an element whose gradient is near 0
# (under Adam's eps, 1e-8) may step by up to the learning rate either
# way on a rounding, so the changes are compared as leaf norms, within
# 1e-4 of the leaf's change.
CHANGE_TOL = 1e-4


@pytest.fixture(scope="module")
def setup():
  """Both sides' configs, the device scene, the confidence maps and the
  injected draws of STEPS steps."""
  cfg, rcfg = port_config.load_config(ARGS), ref_load_config(ARGS)
  mcfg, tcfg = port_config.model_config(cfg), port_config.train_config(cfg)
  rm, rt = ref_config.model_config(rcfg), ref_config.train_config(rcfg)
  scene = synthetic.make_synthetic_scene(num_images=8, H=24, W=32,
                                         datahold=4)
  dev = sampler.scene_to_device(scene, "cpu")
  gen = torch.Generator().manual_seed(SEED)
  maps = torch.randint(0, 256, (len(scene.i_train), len(tcfg.conf_modes),
                                24, 32), generator=gen, dtype=torch.uint8)
  draws = [tr.draw_step(mcfg, tcfg, dev["images"], scene.i_train, gen)
           for _ in range(STEPS)]
  return dict(mcfg=mcfg, tcfg=tcfg, rm=rm, rt=rt, scene=scene, dev=dev,
              maps=maps, draws=draws)


def _state(s, reference: bool):
  """(state, step) of one side on the seed's drawn weights, the pose
  table and the lambdas at zero, as create_train_state makes them."""
  mod = ref_tr if reference else tr
  Model = ref_mip.MipNerfModel if reference else mipnerf.MipNerfModel
  Pose = RefPose if reference else LearnPose
  Conf = RefConfidence if reference else ConfidenceModel
  mcfg, tcfg = (s["rm"], s["rt"]) if reference else (s["mcfg"], s["tcfg"])
  n = s["scene"].num_images
  model = Model(mcfg, device="cpu")
  weights.load(model, SEED)
  state = mod.TrainState(step=0, model=model, optimizer=mod.adam(
      model.parameters(), mod.make_lr_schedule(tcfg)(0)))
  state.pose_model = Pose(n, device="cpu")
  state.pose_optimizer = mod.adam(state.pose_model.parameters(),
                                  tcfg.pose_lrate)
  state.conf_model = Conf(tcfg.conf_modes, n, device="cpu")
  state.conf_optimizer = mod.adam(state.conf_model.parameters(),
                                  tcfg.conf_lrate)
  step = mod.make_train_step(model, state.pose_model, tcfg, s["dev"],
                             s["scene"].i_train, s["scene"].near,
                             s["scene"].far, conf_maps=s["maps"])
  return state, step


def _ref_draws(d):
  """The port's StepDraws as the reference's classes."""
  return ref_tr.StepDraws(d.img_idx, d.py, d.px, model=ref_mip.MipDraws(
      d.model.stratified, d.model.resample, d.model.noise))


def _leaves(state):
  """{name: parameter} of the model, the pose table and the lambdas."""
  out = dict(state.model.named_parameters())
  out.update({f"pose.{k}": p for k, p in
              state.pose_model.named_parameters()})
  out.update({f"conf.{k}": p for k, p in
              state.conf_model.named_parameters()})
  return out


def _gap(a, b):
  """|a - b| over |b| (norms), 0 for two zeros."""
  den = float(torch.linalg.vector_norm(b))
  num = float(torch.linalg.vector_norm(a - b))
  return num / den if den > 0 else num


def test_configs_are_the_ports(setup):
  assert dataclasses.asdict(setup["mcfg"]) == dataclasses.asdict(setup["rm"])
  assert dataclasses.asdict(setup["tcfg"]) == dataclasses.asdict(setup["rt"])
  m, t = setup["mcfg"], setup["tcfg"]
  assert not m.no_warp_sample and m.num_fine_intervals == 15
  assert t.depth_conf and t.pose_refine and len(t.conf_modes) == 4


@pytest.mark.parametrize("randomized", [False, True])
def test_forward_matches_the_reference(setup, randomized):
  s = setup
  port = mipnerf.MipNerfModel(s["mcfg"], device="cpu")
  ref = ref_mip.MipNerfModel(s["rm"], device="cpu")
  weights.load(port, SEED)
  weights.load(ref, SEED)
  d = s["draws"][0]
  rays, _ = sampler.sample_batch(s["dev"], s["scene"].i_train,
                                 s["tcfg"].n_rgb, s["scene"].near,
                                 s["scene"].far, img_idx=d.img_idx,
                                 py=d.py, px=d.px)
  with torch.no_grad():
    got = port(rays, draws=d.model if randomized else None)
    want = ref(rays, draws=_ref_draws(d).model if randomized else None)
  assert len(got) == len(want) == 2
  for g, w in zip(got, want):
    for key in ("distance", "acc", "weights", "s_vals"):
      torch.testing.assert_close(g[key], w[key], rtol=RTOL, atol=RTOL)
  torch.testing.assert_close(got[1]["rgb"], want[1]["rgb"], rtol=RTOL,
                             atol=RTOL)


def _run(s, reference: bool, n_steps: int = STEPS):
  """(losses, {leaf: first gradient}, {leaf: value after the steps})."""
  state, step = _state(s, reference)
  leaves = _leaves(state)
  out, grads = [], {}
  for t in range(n_steps):
    d = s["draws"][t]
    out.append(float(step(state, draws=_ref_draws(d) if reference
                          else d)["loss"]))
    if t == 0:
      grads = {k: torch.zeros_like(p) if p.grad is None else p.grad.clone()
               for k, p in leaves.items()}
  return out, grads, {k: p.detach().clone() for k, p in leaves.items()}


@pytest.fixture(scope="module")
def steps(setup):
  return _run(setup, False), _run(setup, True)


def test_each_steps_loss_matches(steps):
  (got, _, _), (want, _, _) = steps
  assert len(got) == STEPS
  np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)


def test_every_leafs_gradient_matches(steps):
  (_, got, _), (_, want, _) = steps
  assert set(got) == set(want)
  assert {"pose.r", "pose.t", "conf.lambdas"} <= set(got)
  for k in want:
    # the step's image's pose row and lambdas, and every model leaf, move
    assert float(torch.linalg.vector_norm(want[k])) > 0, k
    assert _gap(got[k], want[k]) <= GRAD_TOL, k


def test_the_change_after_the_steps_matches(setup, steps):
  (_, _, got), (_, _, want) = steps
  shapes = [(k, p.shape) for k, p in want.items() if "." in k
            and not k.startswith(("pose.", "conf."))]
  start = weights.draw(shapes, SEED, "cpu")
  for k in want:
    p0 = start.get(k, torch.zeros_like(want[k]))
    assert float(torch.linalg.vector_norm(want[k] - p0)) > 0, k
    assert _gap(got[k] - p0, want[k] - p0) <= CHANGE_TOL, k


def test_dropping_the_confidence_weights_moves_the_loss(setup, steps,
                                                        monkeypatch):
  orig = losses.depth_loss
  monkeypatch.setattr(
      losses, "depth_loss",
      lambda *args, conf_weight=None, **kwargs: orig(*args, **kwargs))
  (got, _, _) = _run(setup, False, n_steps=1)
  want = steps[1][0][0]
  assert abs(got[0] - want) / abs(want) > 100 * RTOL
