"""The port's flag parser (snerf_tpu_torch/flags.py) against
snerf_tpu/config.py: every file in configs/, a zipnerf .gin file and CLI
overrides (tuples, booleans, None, aliases, ignored legacy flags) give
equal `dataclasses.asdict`; the field lists and defaults are equal; and
the port's zip_train_config against the JAX adapter. Exact: both parse
the same text with the same Python."""

import dataclasses
import os

import pytest

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
  # JAX trains bf16 zip MLPs by default; the port trains f32 until B.2
  argv = ["--config", os.path.join(REPO, "configs", "waymo_zipnerf"),
          "--zip_encoder", encoder, "--zip_compute_dtype", "float32"]
  got = dataclasses.asdict(tconfig.zip_train_config(flags.load_config(argv)))
  want = dataclasses.asdict(jconfig.load_config(argv).zip_train_config())
  assert got == want


@pytest.mark.parametrize("dtype", [None, "bfloat16", "bf16"])
def test_zip_train_config_raises_on_bf16(dtype):
  """The flags that make JAX train bf16 zip MLPs (the default among them)
  raise in the port, naming B.2, instead of training f32 silently."""
  argv = ["--config", os.path.join(REPO, "configs", "waymo_zipnerf")]
  if dtype is not None:
    argv += ["--zip_compute_dtype", dtype]
  cfg = flags.load_config(argv)
  assert cfg.zip_compute_dtype in ("bfloat16", "bf16")
  with pytest.raises(NotImplementedError, match="B.2"):
    tconfig.zip_train_config(cfg)


@pytest.mark.parametrize("dtype", ["float32", "f32"])
def test_zip_train_config_float32_builds_as_before(dtype):
  """A float32 value builds the same ZipTrainConfig as the flags did
  before the dtype rule, field for field (the fields do not read the
  dtype); JAX's adapter picks float32 for any value but bf16 ones."""
  base = ["--config", os.path.join(REPO, "configs", "waymo_zipnerf")]
  cfg = flags.load_config(base + ["--zip_compute_dtype", dtype])
  got = dataclasses.asdict(tconfig.zip_train_config(cfg))
  want = dataclasses.asdict(tconfig.zip_train_config(dataclasses.replace(
      flags.load_config(base), zip_compute_dtype="float32")))
  assert got == want
  assert got["batch_size"] == 32768 and got["lr_init"] == 0.01
  jcfg = jconfig.load_config(base + ["--zip_compute_dtype", dtype])
  assert jcfg.zip_model_config().compute_dtype.__name__ == "float32"


def test_zip_model_config_stays_f32_for_bf16_flags():
  """The eval adapter keeps float32 under the bf16 default, as render.py
  and eval.py force it, and matches the JAX adapter's fields."""
  cfg = flags.load_config(["--config",
                           os.path.join(REPO, "configs", "waymo_zipnerf")])
  assert cfg.zip_compute_dtype == "bfloat16"
  got = dataclasses.asdict(tconfig.zip_model_config(cfg))
  want = dataclasses.asdict(jconfig.load_config(
      ["--config", os.path.join(REPO, "configs", "waymo_zipnerf")])
      .zip_model_config())
  assert all(want[k] == v for k, v in got.items())
  assert "compute_dtype" not in got


def test_waymo_zipnerf_tpu_adapters_match_jax():
  """configs/waymo_zipnerf_tpu (the cp_hash arm, float32): the port's
  zip_model_config and zip_train_config build the fields of JAX's
  Config methods, every zip_ipe_* and zip_cp_* flag carried; the JAX
  model fields the port leaves out are the compute dtype and those of
  the unported GLO embedding and RefNeRF head."""
  argv = ["--config", os.path.join(REPO, "configs", "waymo_zipnerf_tpu"),
          "--zip_compute_dtype", "float32"]
  cfg, jcfg = flags.load_config(argv), jconfig.load_config(argv)
  got = dataclasses.asdict(tconfig.zip_model_config(cfg))
  want = dataclasses.asdict(jcfg.zip_model_config())
  assert set(want) - set(got) == {"compute_dtype", "num_glo_embeddings",
                                  "roughness_bias"}
  assert {k: want[k] for k in got} == got
  assert (got["encoder_type"], got["cp_level_dim"], got["cp_anisotropic"],
          got["cp_feature_center"], got["ipe_density_width"],
          got["density_zero_init"]) == ("cp_hash", 64, True, True, 512, True)
  assert (dataclasses.asdict(tconfig.zip_train_config(cfg))
          == dataclasses.asdict(jcfg.zip_train_config()))
