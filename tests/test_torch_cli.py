"""The port's entry points (snerf_tpu_torch/cli/) end to end on the CPU.

- cli.train -> cli.eval -> cli.render on configs/synthetic_tiny and on
  the realfocal fixture with configs/nuScenes_depth_6cams, at narrow
  widths, `--device cpu`: checkpoints, the resume, the snapshot, every
  output file of eval.py and render.py, a falling loss; the zip model
  likewise; the profile window.
- The shipped nuScenes_depth_6cams on the fixture with the depth
  confidence on (the vgg mode included), and eval with --lpips.
- configs/waymo_zipnerf on a tiny Waymo layout (dataset_type waymo):
  train (bf16 MLPs, as shipped: no --zip_compute_dtype), eval of the
  train views, and render --render_mode random, whose poses are the JAX
  package's for the same scene and seed; and configs/waymo_zipnerf_tpu
  (the cp_hash arm) at narrow widths, trained in bf16, eval and render
  reading the EMA weights. Both losses fall over 12 steps.
- What has no port yet raises, and without a card the entry points
  raise instead of running on the CPU.

tests/test_torch_cli_parity.py holds cli.eval against the JAX package on
the same weights.
"""

import contextlib
import json
import os
import sys

import numpy as np
import pytest
import torch

from snerf_tpu_torch.cli import common
from snerf_tpu_torch.cli import eval as cli_eval
from snerf_tpu_torch.cli import render as cli_render
from snerf_tpu_torch.cli import train as cli_train
from snerf_tpu_torch.data.png import read_png
from snerf_tpu_torch.flags import load_config
from snerf_tpu_torch.train import checkpoints as ckpt_lib

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(REPO, "configs", "synthetic_tiny")
FIXTURE = os.path.join(REPO, "tests", "fixtures", "nuscenes_realfocal")
MIP_NARROW = ["--N_samples", "8", "--N_fine", "8", "--hidden_layer", "16",
              "--proposal_hidden_layer", "16"]
ZIP_NARROW = ["--model", "zipnerf", "--zip_batch_size", "64",
              "--zip_num_prop_samples", "(4, 4)",
              "--zip_num_nerf_samples", "4", "--zip_sample_n", "2",
              "--zip_grid_num_levels", "3", "--zip_log2_hashmap_size", "10",
              "--zip_bottleneck_width", "16",
              "--zip_prop_grid_resolutions", "(32, 64)",
              "--zip_nerf_grid_resolution", "128", "--zip_lr_delay", "0"]
CPU = ["--device", "cpu"]


@pytest.fixture(autouse=True)
def _no_tensorboard(monkeypatch):
  """jsonl logging only: importing TensorBoard here pulls in TensorFlow
  (~20 s); the logger's TensorBoard branch is the JAX logger's."""
  monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


@pytest.fixture(autouse=True)
def _one_thread():
  """One intra-op thread: these runs are thousands of small ops, which
  several threads slow down on a machine whose cores other test
  processes share (a thread's barrier waits on descheduled siblings);
  under five busy processes the realfocal test took 70 s against 108
  s with every core's thread."""
  threads = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(threads)


def _log(exp):
  with open(os.path.join(exp, "train_log.jsonl")) as f:
    return [json.loads(line) for line in f]


def _tf32_on():
  torch.backends.cuda.matmul.allow_tf32 = True
  torch.backends.cudnn.allow_tf32 = True


def _tf32():
  return (torch.backends.cuda.matmul.allow_tf32,
          torch.backends.cudnn.allow_tf32)


def test_mip_train_resume_eval_render_synthetic(tmp_path):
  """Train, resume, eval and render; train and eval turn TF32 off (the
  card's products are then f32, as the JAX package's on the CPU)."""
  base = str(tmp_path)
  flags = ["--config", TINY, "--basedir", base, *MIP_NARROW,
           "--i_weights", "10", "--i_print", "10", "--i_testset", "10"]
  args = flags + CPU
  _tf32_on()
  state = cli_train.main(args + ["--N_iters", "20"])
  assert _tf32() == (False, False)
  exp = os.path.join(base, "synthetic_tiny")
  ckpt_dir = os.path.join(exp, "checkpoints")
  assert state.step == 20 and ckpt_lib.latest_step(ckpt_dir) == 20
  assert os.path.isfile(os.path.join(exp, "args.txt"))
  saved = ckpt_lib.state_payload(state)
  # the resume restores step 20 exactly and trains on to 30
  state = cli_train.main(args + ["--N_iters", "30"])
  assert state.step == 30
  fresh = common.build_model_state(load_config(flags), 12, "cpu")[1]
  fresh, got = ckpt_lib.restore_checkpoint(ckpt_dir, fresh, step=20)
  assert got == 20
  for k, v in ckpt_lib.state_payload(fresh)["model"].items():
    assert torch.equal(v, saved["model"][k]), k
  logged = _log(exp)
  losses = [e["loss"] for e in logged if "loss" in e]
  assert [e["step"] for e in logged if "loss" in e] == [10, 20, 30]
  assert losses[-1] < losses[0]
  assert len([e for e in logged if "test_psnr" in e]) == 3

  _tf32_on()
  summary = cli_eval.main(["--config", TINY, "--basedir", base, *CPU])
  assert _tf32() == (False, False)
  out = os.path.join(exp, "testset_000030")
  with open(os.path.join(out, "metrics.json")) as f:
    on_disk = json.load(f)
  assert set(on_disk) >= {"step", "mean_psnr", "mean_ssim",
                          "eval_rays_per_sec", "per_image",
                          "eval_rays_per_sec_warm"}
  assert on_disk["step"] == 30 == summary["step"]
  views = [r["img"] for r in summary["per_image"]]
  assert views == [0, 6]
  for v in views:
    assert read_png(os.path.join(out, f"{v:03d}.png")).shape == (24, 32, 3)
    assert np.load(os.path.join(out, f"{v:03d}_depth.npy")).shape == (24, 32)
  assert all(np.isfinite(r["psnr"]) and np.isfinite(r["ssim"])
             for r in summary["per_image"])

  rdir = cli_render.main(["--config", TINY, "--basedir", base, *CPU,
                          "--render_mode", "path", "--render_n", "2"])
  assert sorted(os.listdir(os.path.join(rdir, "rgb"))) == [
      "00000.png", "00001.png"]
  depth = read_png(os.path.join(rdir, "depth", "00001.png"))
  assert depth.dtype == np.uint16 and depth.shape == (24, 32)
  assert np.load(os.path.join(rdir, "render_poses.npy")).shape == (2, 3, 4)
  assert np.load(os.path.join(rdir, "intrinsic.npy")).shape == (2, 3, 3)
  rdir = cli_render.main(["--config", TINY, "--basedir", base, *CPU,
                          "--render_mode", "test", "--render_n", "1",
                          "--out_dir", str(tmp_path / "r")])
  assert os.listdir(os.path.join(rdir, "rgb")) == ["00000.png"]


def test_mip_realfocal_fixture_and_pose_refinement(tmp_path, capsys):
  """The shipped config with its depth confidence (rgb, ssim, depth, vgg)
  precomputed; eval with pose refinement and --lpips."""
  base = str(tmp_path)
  common_args = ["--config", os.path.join(REPO, "configs",
                                          "nuScenes_depth_6cams"),
                 "--datadir", FIXTURE, "--basedir", base, *CPU]
  state = cli_train.main(common_args + [
      *MIP_NARROW, "--N_rgb", "64", "--N_iters", "4", "--i_weights", "4",
      "--i_print", "2", "--datahold", "12", "--lrate_delay", "0"])
  # half_train: 22 of the 44 train views; 4 modes at 96 x 128
  assert "conf maps: (22, 4, 96, 128) torch.uint8" in capsys.readouterr().out
  assert state.conf_model.modes == ("rgb", "ssim", "depth", "vgg")
  assert float(state.conf_model.lambdas.detach().abs().max()) > 0
  exp = os.path.join(base, "scene_0916")
  assert ckpt_lib.restore_pose_checkpoint(exp)[1] == 4
  summary = cli_eval.main(common_args + ["--test_refine_iter", "2",
                                         "--lpips", "True"])
  # datahold 12 over 48 views; the snapshot supplied it and the widths
  assert [r["img"] for r in summary["per_image"]] == [0, 12, 24, 36]
  assert np.isfinite(summary["mean_psnr"])
  assert all(r["lpips"] > 0 for r in summary["per_image"])
  rdir = cli_render.main(common_args + ["--render_mode", "path",
                                        "--render_n", "1"])
  assert read_png(os.path.join(rdir, "rgb", "00000.png")).shape == (96, 128,
                                                                     3)


def test_zip_train_eval_render_and_profile(tmp_path):
  base = str(tmp_path)
  args = ["--config", TINY, "--basedir", base, *ZIP_NARROW, *CPU,
          "--i_weights", "3", "--i_print", "3", "--i_testset", "3",
          "--profile_steps", "2", "--profile_start", "2"]
  state = cli_train.main(args + ["--zip_max_steps", "6"])
  assert state.step == 6
  exp = os.path.join(base, "synthetic_tiny")
  assert len([e for e in _log(exp) if "test_psnr" in e]) == 2
  assert os.listdir(os.path.join(exp, "profile"))
  state = cli_train.main(args + ["--zip_max_steps", "8"])
  assert state.step == 8
  summary = cli_eval.main(["--config", TINY, "--basedir", base, *CPU])
  assert summary["step"] == 8 and np.isfinite(summary["mean_psnr"])
  rdir = cli_render.main(["--config", TINY, "--basedir", base, *CPU,
                          "--render_n", "1"])
  assert os.listdir(os.path.join(rdir, "depth")) == ["00000.png"]


def test_waymo_zip_train_eval_and_random_render(tmp_path):
  from snerf_tpu.data import waymo as jw
  from test_torch_waymo import write_layout
  data = write_layout(str(tmp_path / "waymo"), 19, 27)
  base = str(tmp_path / "exp")
  args = ["--config", os.path.join(REPO, "configs", "waymo_zipnerf"),
          "--datadir", data, "--basedir", base, *CPU]
  # the 19 semantic classes are read from the bottleneck: 32 wide
  state = cli_train.main(args + [*ZIP_NARROW, "--zip_max_steps", "12",
                                 "--i_print", "1", "--zip_patch_size", "4",
                                 "--zip_bottleneck_width", "32"])
  assert state.step == 12
  exp = os.path.join(base, "waymo_zip")
  losses = [e["loss"] for e in _log(exp) if "loss" in e]
  # bf16 MLPs, as shipped; each step draws new pixels, so the loss falls
  # on average
  assert len(losses) == 12 and np.mean(losses[-4:]) < np.mean(losses[:4])
  # a Waymo scene holds no test split: evaluate the train views
  summary = cli_eval.main(args + ["--eval_test", "False"])
  assert len(summary["per_image"]) == 8 and np.isfinite(
      summary["mean_psnr"])
  rdir = cli_render.main(args + ["--render_mode", "random", "--render_n",
                                 "2", "--render_seed", "3"])
  for sub, ext in (("rgb", "png"), ("depth", "png"), ("semantic", "npy")):
    assert sorted(os.listdir(os.path.join(rdir, sub))) == [
        f"00000.{ext}", f"00001.{ext}"]
  assert read_png(os.path.join(rdir, "rgb", "00001.png")).shape == (19, 27,
                                                                    3)
  depth = read_png(os.path.join(rdir, "depth", "00000.png"))
  assert depth.dtype == np.uint16 and depth.shape == (19, 27)
  assert np.load(os.path.join(rdir, "semantic", "00000.npy")).shape == (19,
                                                                        27)
  # the poses of render.py's random mode on the JAX loader's scene
  jscene = jw.load_waymo_scene(data)
  hw = np.array(jscene.hw)
  want = jw.generate_random_render_poses(
      jscene.poses, jscene.intrinsics[0], jscene.intrinsics[-1], hw, hw,
      jscene.scale, n_render=2, seed=3)
  raw = jw.render2raw(want.poses, jscene.pca_transform, jscene.scale,
                      np.eye(4))
  for name, arr in (("render_poses", want.poses), ("intrinsic",
                                                   want.intrinsics),
                    ("raw_target_poses", raw)):
    assert np.array_equal(np.load(os.path.join(rdir, f"{name}.npy")), arr)


# configs/waymo_zipnerf_tpu (cp_hash, the cylinder cast, an 8-deep trunk
# with a skip, EMA) at narrow widths
CP_NARROW = ["--zip_cp_num_levels", "2", "--zip_cp_level_dim", "4",
             "--zip_cp_base_resolution", "16", "--zip_cp_max_resolution",
             "32", "--zip_cp_hash_resolution", "64", "--zip_cp_hash_log2",
             "10", "--zip_ipe_density_width", "16",
             "--zip_density_hidden_width", "16", "--zip_ipe_max_deg", "4",
             "--zip_bottleneck_width", "32"]


def test_waymo_zip_tpu_train_eval_and_render_from_the_ema(tmp_path,
                                                          monkeypatch):
  """configs/waymo_zipnerf_tpu as shipped but for narrow widths (its
  scan_render = True does not raise): train with bf16 MLPs (the loss
  falls), then eval and render in float32, both from the EMA weights:
  with the swap stubbed out they give other numbers."""
  from test_torch_waymo import write_layout
  data = write_layout(str(tmp_path / "waymo"), 19, 27)
  base = str(tmp_path / "exp")
  args = ["--config", os.path.join(REPO, "configs", "waymo_zipnerf_tpu"),
          "--datadir", data, "--basedir", base, *CPU]
  state = cli_train.main(args + [*ZIP_NARROW, *CP_NARROW,
                                 "--zip_max_steps", "12", "--i_print", "1",
                                 "--zip_patch_size", "4"])
  assert state.step == 12 and state.ema is not None
  cfg = state.model.config
  assert (cfg.encoder_type, cfg.cp_anisotropic, cfg.cp_feature_center,
          cfg.ipe_density_depth, cfg.ipe_skip_layer) == ("cp_hash", True,
                                                         True, 8, 4)
  params = dict(state.model.named_parameters())
  assert any(not torch.equal(params[k], v) for k, v in state.ema.items())
  exp = os.path.join(base, "waymo_zip_tpu")
  losses = [e["loss"] for e in _log(exp) if "loss" in e]
  assert len(losses) == 12 and np.mean(losses[-4:]) < np.mean(losses[:4])
  summary = cli_eval.main(args + ["--eval_test", "False"])
  assert len(summary["per_image"]) == 8 and np.isfinite(
      summary["mean_psnr"])
  rdir = cli_render.main(args + ["--render_mode", "random", "--render_n",
                                 "2", "--render_seed", "3"])
  ema_rgb = read_png(os.path.join(rdir, "rgb", "00000.png"))
  assert ema_rgb.shape == (19, 27, 3)
  @contextlib.contextmanager
  def raw_weights(state):
    yield state.model

  for module in (cli_eval, cli_render):
    monkeypatch.setattr(module, "eval_weights", raw_weights)
  raw_summary = cli_eval.main(args + ["--eval_test", "False"])
  assert raw_summary["mean_psnr"] != summary["mean_psnr"]
  cli_render.main(args + ["--render_mode", "random", "--render_n", "2",
                          "--render_seed", "3"])
  assert not np.array_equal(
      read_png(os.path.join(rdir, "rgb", "00000.png")), ema_rgb)


def test_unported_paths_raise(tmp_path):
  base = ["--config", TINY, "--basedir", str(tmp_path), *MIP_NARROW]
  if not torch.cuda.is_available():
    for main in (cli_train.main, cli_eval.main, cli_render.main):
      with pytest.raises(RuntimeError, match="--device cpu"):
        main(base)
  for extra, match in ((["--unroll_steps", "2"], "Queue 1, item 1"),
                       (["--tp", "2"], "Queue 1, item 9"),
                       (["--dataset_type", "llff"], "data/llff.py"),
                       (["--model", "classic"], "classic"),
                       (["--encode_appearance", "True"], "encode_appearance")):
    with pytest.raises(NotImplementedError, match=match):
      cli_train.main(base + CPU + extra + ["--N_iters", "1"])
  # the zip model, which raised here until its bf16 trunks were ported,
  # trains in zip_compute_dtype, bf16 by default
  state = cli_train.main(["--config", TINY, "--basedir", str(tmp_path), *CPU,
                          *ZIP_NARROW, "--zip_max_steps", "1"])
  assert state.step == 1 and all(m.compute_dtype == torch.bfloat16
                                 for m in state.model.mlps())
  with pytest.raises(NotImplementedError, match="scan render"):
    cli_eval.main(base + CPU + ["--scan_render", "True"])
  with pytest.raises(ValueError, match="--render_mode"):
    cli_render.main(base + CPU + ["--render_mode", "orbit"])
