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
  argv = ["--config", os.path.join(REPO, "configs", "waymo_zipnerf"),
          "--zip_encoder", encoder]
  got = dataclasses.asdict(tconfig.zip_train_config(flags.load_config(argv)))
  want = dataclasses.asdict(jconfig.load_config(argv).zip_train_config())
  assert got == want
