"""The port's VGG feature distance (snerf_tpu_torch/models/features.py)
against snerf_tpu.models.features on the same numpy inputs, on the CPU.

- The seeded pyramid's weights equal JAX's bit for bit (the same numpy
  draws, HWIO to OIHW), for two seeds.
- A torchvision-layout state_dict saved as .pth and as .npz (the
  contract of tests/test_vgg_weights.py) loads into both packages to the
  same weights.
- feature_fn within 1e-5 of max|JAX| at odd sizes, where the pools floor
  and the taps upsample by non-integer scales (37 -> 18 -> 9 -> 4 is
  9.25), float32 on both sides (the convolutions sum in another order).
- The tap upsampling alone (`F.interpolate`, bilinear, align_corners
  False) against `jax.image.resize(method="bilinear")` at nuScenes'
  900 x 1600 from the three pool levels 450 x 800, 225 x 400 and
  112 x 200 (scales 2, 4 and 8.04 x 8), within 1e-5 of max|JAX|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from snerf_tpu.models import features as jf
from snerf_tpu_torch.models import features as tf

TOL = 1e-5


@pytest.mark.parametrize("seed", [0, 5])
def test_seeded_weights_equal(seed):
  want = jf._init_params(seed=seed)
  got = tf.vgg_params(seed=seed)
  assert sorted(got) == sorted(want)
  for idx, (w, b) in want.items():
    gw, gb = got[idx]
    assert gw.dtype == np.float32 and gw.flags["C_CONTIGUOUS"]
    assert np.array_equal(gw, np.asarray(w).transpose(3, 2, 0, 1)), idx
    assert np.array_equal(gb, np.asarray(b)), idx


@pytest.mark.parametrize("fmt", ["pth", "npz"])
def test_weights_file_loads_as_in_jax(tmp_path, fmt):
  rng = np.random.RandomState(2)
  cin, sd = 3, {}
  for op in tf._OPS:
    if op[0] == "conv":
      _, idx, cout = op
      sd[f"features.{idx}.weight"] = rng.randn(cout, cin, 3, 3).astype(
          np.float32)
      sd[f"features.{idx}.bias"] = rng.randn(cout).astype(np.float32)
      cin = cout
  path = str(tmp_path / f"vgg.{fmt}")
  if fmt == "pth":
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
  else:
    np.savez(path, **sd)
  want = jf._init_params(weights_path=path)
  got = tf.vgg_params(weights_path=path)
  for idx, (w, b) in want.items():
    assert np.array_equal(got[idx][0], np.asarray(w).transpose(3, 2, 0, 1))
    assert np.array_equal(got[idx][1], np.asarray(b))
  a, b = (rng.rand(20, 27, 3).astype(np.float32) for _ in range(2))
  want = np.asarray(jf.make_feature_fn(path)(jnp.asarray(a), jnp.asarray(b)))
  got = tf.make_feature_fn(path, device="cpu")(torch.from_numpy(a),
                                                torch.from_numpy(b)).numpy()
  assert np.abs(got - want).max() <= TOL * np.abs(want).max()


@pytest.mark.parametrize("hw", [(37, 53), (16, 24), (45, 31)])
def test_feature_fn_matches_jax(hw):
  rng = np.random.RandomState(hw[0])
  a = rng.rand(*hw, 3).astype(np.float32)
  b = np.clip(a + 0.2 * rng.randn(*hw, 3), 0, 1).astype(np.float32)
  want = np.asarray(jf.make_feature_fn()(jnp.asarray(a), jnp.asarray(b)))
  fn = tf.make_feature_fn(device="cpu")
  got = fn(torch.from_numpy(a), torch.from_numpy(b)).numpy()
  assert got.shape == hw
  assert np.abs(got - want).max() <= TOL * np.abs(want).max()
  # the same image is at distance 0
  assert float(fn(torch.from_numpy(a), torch.from_numpy(a)).abs().max()) \
      <= 1e-6


@pytest.mark.parametrize("src", [(450, 800), (225, 400), (112, 200)])
def test_tap_upsampling_matches_jax_resize(src):
  e = np.random.RandomState(src[0]).rand(*src).astype(np.float32)
  want = np.asarray(jax.image.resize(jnp.asarray(e)[..., None],
                                     (900, 1600, 1), method="bilinear"))[..., 0]
  got = F.interpolate(torch.from_numpy(e)[None, None], size=(900, 1600),
                      mode="bilinear", align_corners=False)[0, 0].numpy()
  assert np.abs(got - want).max() <= TOL * np.abs(want).max()
