"""The port (the mip and zip render paths and both train steps) runs
where JAX is absent and loads no module of snerf_tpu, and chip_smoke.py
refuses to run without a CUDA card (each in a fresh interpreter)."""

import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

RENDER_WITHOUT_JAX = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None      # any `import jax` now raises ImportError
sys.modules["flax"] = None
import torch
import snerf_tpu_torch
for m in pkgutil.walk_packages(snerf_tpu_torch.__path__, "snerf_tpu_torch."):
  importlib.import_module(m.name)
from snerf_tpu_torch.config import load_config, model_config
from snerf_tpu_torch.data.raygen import rays_for_image
from snerf_tpu_torch.data.synthetic import make_synthetic_scene
from snerf_tpu_torch.models.mipnerf import MipNerfModel
from snerf_tpu_torch.train.renderer import make_eval_render_fn, render_image
from snerf_tpu_torch.utils.weights import glorot_init_

cfg = load_config(["--config", "configs/nuScenes_depth_6cams",
                   "--hidden_layer", "128", "--proposal_hidden_layer", "128",
                   "--N_samples", "8", "--N_fine", "8"])
model = glorot_init_(MipNerfModel(model_config(cfg), device="cpu"), seed=0)
scene = make_synthetic_scene(num_images=2, H=4, W=4, n_render_samples=8)
rays = rays_for_image(torch.from_numpy(scene.poses[0]),
                      torch.from_numpy(scene.intrinsics[0]), 4, 4,
                      scene.near, scene.far)
out = render_image(make_eval_render_fn(model), rays, chunk=6)
assert out["rgb"].shape == (4, 4, 3), out["rgb"].shape
assert all(bool(torch.isfinite(v).all()) for v in out.values())
acc = out["acc"]
assert float(acc.min()) >= 0 and float(acc.max()) <= 1 + 1e-6
from snerf_tpu_torch.config import zip_model_config
from snerf_tpu_torch.models.zipnerf import ZipNerfModel
from snerf_tpu_torch.train.renderer import make_zip_eval_render_fn
from snerf_tpu_torch.utils.weights import zip_init_

zcfg = load_config(["--config", "configs/waymo_zipnerf",
                    "--zip_num_prop_samples", "(8, 8)",
                    "--zip_num_nerf_samples", "8",
                    "--zip_grid_num_levels", "4",
                    "--zip_log2_hashmap_size", "12",
                    "--zip_prop_grid_resolutions", "(64, 128)",
                    "--zip_nerf_grid_resolution", "256",
                    "--zip_bottleneck_width", "32"])
zmodel = zip_init_(ZipNerfModel(zip_model_config(zcfg), device="cpu"), seed=0,
                   table_scale=1.0)
zout = render_image(make_zip_eval_render_fn(zmodel), rays, chunk=6)
assert zout["rgb"].shape == (4, 4, 3), zout["rgb"].shape
assert zout["semantic"].shape == (4, 4, 19), zout["semantic"].shape
assert all(bool(torch.isfinite(v).all()) for v in zout.values())
print("ZIP RENDERED", tuple(zout["rgb"].shape))
import math
from snerf_tpu_torch.config import train_config
from snerf_tpu_torch.data.sampler import scene_to_device
from snerf_tpu_torch.train.trainer import create_train_state, make_train_step

tflags = load_config(["--config", "configs/nuScenes_depth_6cams",
                      "--depth_conf", "False", "--hidden_layer", "128",
                      "--proposal_hidden_layer", "128", "--N_samples", "8",
                      "--N_fine", "8", "--N_rgb", "16"])
tcfg = train_config(tflags)
tscene = make_synthetic_scene(num_images=3, H=8, W=8, n_render_samples=8)
tmodel, tpose, tstate = create_train_state(0, model_config(tflags), tcfg,
                                           tscene.num_images, device="cpu")
tstep = make_train_step(tmodel, tpose, tcfg, scene_to_device(tscene, "cpu"),
                        tscene.i_train, tscene.near, tscene.far)
gen = torch.Generator().manual_seed(0)
tlosses = [float(tstep(tstate, gen)["loss"]) for _ in range(2)]
assert all(math.isfinite(v) for v in tlosses), tlosses
assert tpose is not None and float(tpose.r.grad.abs().max()) > 0
print("TRAINED", tstate.step)
from snerf_tpu_torch.config import zip_train_config
from snerf_tpu_torch.train.zip_trainer import (create_zip_train_state,
                                               make_zip_train_step)

zflags = load_config(["--config", "configs/waymo_zipnerf",
                      "--zip_num_prop_samples", "(8, 8)",
                      "--zip_num_nerf_samples", "8",
                      "--zip_grid_num_levels", "4",
                      "--zip_log2_hashmap_size", "12",
                      "--zip_prop_grid_resolutions", "(64, 128)",
                      "--zip_nerf_grid_resolution", "256",
                      "--zip_bottleneck_width", "32", "--zip_batch_size", "32",
                      "--zip_patch_size", "2", "--zip_lr_delay", "0"])
zscene = make_synthetic_scene(num_images=3, H=8, W=8, n_render_samples=8)
zscene.semantics = (zscene.depths > zscene.depths.mean()).astype("int32")
zscene.skymask = zscene.depths > 1e9
zstate = create_zip_train_state(0, zip_model_config(zflags),
                                zip_train_config(zflags), zscene.num_images,
                                device="cpu")
zstep = make_zip_train_step(zstate.model, zip_train_config(zflags),
                            scene_to_device(zscene, "cpu"), zscene.i_train,
                            zscene.near, zscene.far)
zlosses = [float(zstep(zstate, gen)["loss"]) for _ in range(2)]
assert all(math.isfinite(v) for v in zlosses), zlosses
assert zstate.step == 2
print("ZIP TRAINED", zstate.step)
jax_side = sorted(k for k, v in sys.modules.items() if v is not None and (
    k.split(".")[0] in ("jax", "jaxlib", "flax", "snerf_tpu")))
assert jax_side == [], jax_side
print("RENDERED", tuple(out["rgb"].shape))
"""


def _run(args, cwd, **env):
  return subprocess.run(args, cwd=cwd, capture_output=True, text=True,
                        timeout=300, env=dict(os.environ, **env))


def test_port_imports_and_renders_with_jax_blocked():
  proc = _run([sys.executable, "-c", RENDER_WITHOUT_JAX], REPO,
              PYTHONPATH=REPO)
  assert proc.returncode == 0, proc.stderr[-3000:]
  assert "RENDERED (4, 4, 3)" in proc.stdout
  assert "ZIP RENDERED (4, 4, 3)" in proc.stdout
  assert "TRAINED 2" in proc.stdout
  assert "ZIP TRAINED 2" in proc.stdout


def test_chip_smoke_fails_without_cuda():
  proc = _run([sys.executable, "chip_smoke.py"], REPO,
              CUDA_VISIBLE_DEVICES="")
  assert proc.returncode != 0
  assert '"ok"' not in proc.stdout


def test_chip_smoke_fails_alone(tmp_path):
  shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
  proc = _run([sys.executable, "chip_smoke.py"], str(tmp_path),
              CUDA_VISIBLE_DEVICES="", PYTHONPATH="")
  assert proc.returncode != 0
  assert '"ok"' not in proc.stdout
