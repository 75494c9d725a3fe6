"""The port's flag parser (snerf_tpu_torch/flags.py) against
snerf_tpu/config.py: every file in configs/, a zipnerf .gin file and CLI
overrides (tuples, booleans, None, aliases, ignored legacy flags) give
equal `dataclasses.asdict`; the field lists and defaults are equal; and
the port's zip_train_config and zip_model_config against the JAX
adapters (the compute dtype by name: torch.bfloat16 for jnp.bfloat16).
Exact: both parse the same text with the same Python."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from snerf_tpu import config as jconfig
from snerf_tpu_torch import config as tconfig
from snerf_tpu_torch import flags

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(os.listdir(os.path.join(REPO, "configs")))
OVERRIDES = [
    [],
    ["--zip_num_prop_samples", "(8, 8)", "--zip_prop_grid_resolutions=(64,)",
     "--semantic", "--fn", "None", "--zip_density_zero_init", "true",
     "--N_rgb", "16", "--lrate", "1e-3", "--expname", "run_a"],
    ["--raw_noise_std", "0.5", "--patch_size", "4", "--no_batching", "False",
     "--netdepth", "8", "--i_weight", "7", "--zip_compute_dtype", "float32"],
]


def _dtype_name(dtype):
  """'float32' or 'bfloat16' of a torch or a jnp dtype."""
  return getattr(dtype, "__name__", str(dtype).split(".")[-1])


def _model_fields(cfg):
  """asdict of a ZipNerfConfig with its compute dtype by name."""
  d = dataclasses.asdict(cfg)
  d["compute_dtype"] = _dtype_name(d["compute_dtype"])
  return d


def _both(argv):
  return (dataclasses.asdict(flags.load_config(argv)),
          dataclasses.asdict(jconfig.load_config(argv)))


def test_fields_and_defaults_match():
  got = [(f.name, f.default) for f in dataclasses.fields(flags.Config)]
  want = [(f.name, f.default) for f in dataclasses.fields(jconfig.Config)]
  assert got == want


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("extra", range(len(OVERRIDES)))
def test_config_files_parse_equal(name, extra):
  got, want = _both(["--config", os.path.join(REPO, "configs", name)]
                    + OVERRIDES[extra])
  assert got == want


def test_gin_file_parses_equal(tmp_path):
  gin = tmp_path / "waymo.gin"
  gin.write_text("Config.batch_size = 4096  # comment\n"
                 "Config.near = 0.1\nModel.num_prop_samples = (32, 16)\n"
                 "Config.use_semantic = True\nNerfMLP.class_num = 7\n"
                 "Model.raydist_fn = @power_transformation\n")
  got, want = _both(["--config", str(gin)])
  assert got == want
  assert got["model"] == "zipnerf" and got["zip_batch_size"] == 4096


def test_unknown_key_raises_in_both():
  for load in (flags.load_config, jconfig.load_config):
    with pytest.raises(ValueError):
      load(["--no_such_flag", "1"])


@pytest.mark.parametrize("encoder", ["hash", "ipe"])
def test_zip_train_config_matches_jax_adapter(encoder):
  # the shipped config as it is: JAX trains bf16 zip MLPs, and so does
  # the port
  argv = ["--config", os.path.join(REPO, "configs", "waymo_zipnerf"),
          "--zip_encoder", encoder]
  got = dataclasses.asdict(tconfig.zip_train_config(flags.load_config(argv)))
  want = dataclasses.asdict(jconfig.load_config(argv).zip_train_config())
  assert got == want


@pytest.mark.parametrize("dtype", [None, "bfloat16", "bf16"])
def test_zip_train_config_raises_on_bf16(dtype):
  """The flags that make JAX train bf16 zip MLPs (the default among them),
  which raised until the bf16 trunks were ported, now build JAX's
  adapters: zip_train_config field for field, and zip_model_config with
  compute_dtype bfloat16 and every other field JAX's."""
  argv = ["--config", os.path.join(REPO, "configs", "waymo_zipnerf")]
  if dtype is not None:
    argv += ["--zip_compute_dtype", dtype]
  cfg, jcfg = flags.load_config(argv), jconfig.load_config(argv)
  assert cfg.zip_compute_dtype in ("bfloat16", "bf16")
  assert (dataclasses.asdict(tconfig.zip_train_config(cfg))
          == dataclasses.asdict(jcfg.zip_train_config()))
  got = tconfig.zip_model_config(cfg)
  assert got.compute_dtype == torch.bfloat16
  want = _model_fields(jcfg.zip_model_config())
  assert want["compute_dtype"] == "bfloat16"
  assert {k: want[k] for k in _model_fields(got)} == _model_fields(got)


@pytest.mark.parametrize("dtype", ["float32", "f32"])
def test_zip_train_config_float32_builds_as_before(dtype):
  """A float32 value builds the same ZipTrainConfig as the flags did
  before the dtype rule, field for field (the fields do not read the
  dtype); JAX's adapter picks float32 for any value but bf16 ones, and
  so does the port's model config."""
  base = ["--config", os.path.join(REPO, "configs", "waymo_zipnerf")]
  cfg = flags.load_config(base + ["--zip_compute_dtype", dtype])
  got = dataclasses.asdict(tconfig.zip_train_config(cfg))
  want = dataclasses.asdict(tconfig.zip_train_config(dataclasses.replace(
      flags.load_config(base), zip_compute_dtype="float32")))
  assert got == want
  assert got["batch_size"] == 32768 and got["lr_init"] == 0.01
  jcfg = jconfig.load_config(base + ["--zip_compute_dtype", dtype])
  assert jcfg.zip_model_config().compute_dtype.__name__ == "float32"
  assert tconfig.zip_model_config(cfg).compute_dtype == torch.float32


def test_zip_model_config_stays_f32_for_bf16_flags():
  """Under the bf16 default the model config is JAX's, field for field
  (bfloat16 included), and the eval render fn runs its MLPs in float32,
  as render.py and eval.py build their model: a bf16 model (narrow
  widths) renders exactly as its float32 twin on the same weights there,
  keeps its bf16 dtype after, and its own bf16 forward differs."""
  from snerf_tpu_torch.models.zipnerf import ZipNerfModel
  from snerf_tpu_torch.ops.rays import Rays
  from snerf_tpu_torch.train.renderer import make_zip_eval_render_fn
  from snerf_tpu_torch.utils.weights import zip_init_

  argv = ["--config", os.path.join(REPO, "configs", "waymo_zipnerf")]
  cfg = flags.load_config(argv)
  assert cfg.zip_compute_dtype == "bfloat16"
  got = _model_fields(tconfig.zip_model_config(cfg))
  want = _model_fields(jconfig.load_config(argv).zip_model_config())
  assert got["compute_dtype"] == "bfloat16"
  assert {k: want[k] for k in got} == got

  narrow = flags.load_config(argv + [
      "--zip_num_prop_samples", "(8, 8)", "--zip_num_nerf_samples", "8",
      "--zip_grid_num_levels", "4", "--zip_log2_hashmap_size", "10",
      "--zip_prop_grid_resolutions", "(32, 64)",
      "--zip_nerf_grid_resolution", "128", "--zip_bottleneck_width", "32"])
  zcfg = tconfig.zip_model_config(narrow)
  model = zip_init_(ZipNerfModel(zcfg, device="cpu"), seed=0,
                    table_scale=1.0)
  twin = ZipNerfModel(dataclasses.replace(zcfg, compute_dtype=torch.float32),
                      device="cpu")
  twin.load_state_dict(model.state_dict())
  rng = np.random.RandomState(0)
  d = rng.normal(size=(16, 3)).astype(np.float32)
  rays = Rays(origins=torch.from_numpy(rng.normal(size=(16, 3))
                                       .astype(np.float32) * 0.3),
              directions=torch.from_numpy(d),
              viewdirs=torch.from_numpy(d / np.linalg.norm(d, axis=-1,
                                                           keepdims=True)),
              radii=torch.full((16, 1), 0.003),
              lossmult=torch.ones(16, 1), near=torch.full((16, 1), 0.2),
              far=torch.full((16, 1), 8.0),
              app=torch.zeros(16, 1, dtype=torch.int32))
  out = make_zip_eval_render_fn(model)(rays)
  ref = make_zip_eval_render_fn(twin)(rays)
  for k in ("rgb", "distance", "acc", "semantic"):
    assert out[k].dtype == torch.float32, k
    assert torch.equal(out[k], ref[k]), k
  assert all(m.compute_dtype == torch.bfloat16 for m in model.mlps())
  with torch.inference_mode():
    bf16_rgb = model(rays)[0][-1]["rgb"]
  assert float((bf16_rgb.float() - ref["rgb"]).abs().max()) > 0


def test_waymo_zipnerf_tpu_adapters_match_jax():
  """configs/waymo_zipnerf_tpu (the cp_hash arm, float32): the port's
  zip_model_config and zip_train_config build the fields of JAX's
  Config methods, every zip_ipe_* and zip_cp_* flag carried; the JAX
  model fields the port leaves out are those of the unported GLO
  embedding and RefNeRF head."""
  argv = ["--config", os.path.join(REPO, "configs", "waymo_zipnerf_tpu"),
          "--zip_compute_dtype", "float32"]
  cfg, jcfg = flags.load_config(argv), jconfig.load_config(argv)
  got = _model_fields(tconfig.zip_model_config(cfg))
  want = _model_fields(jcfg.zip_model_config())
  assert set(want) - set(got) == {"num_glo_embeddings", "roughness_bias"}
  assert {k: want[k] for k in got} == got
  assert (got["encoder_type"], got["cp_level_dim"], got["cp_anisotropic"],
          got["cp_feature_center"], got["ipe_density_width"],
          got["density_zero_init"]) == ("cp_hash", 64, True, True, 512, True)
  assert (dataclasses.asdict(tconfig.zip_train_config(cfg))
          == dataclasses.asdict(jcfg.zip_train_config()))
