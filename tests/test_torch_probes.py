"""The gather probes P1 and P2 (snerf_tpu_torch/probes/gather.py): their
CPU paths, the plain versions, against the TPU kernel bodies of
scripts/probe_gather.py (`kernel_lane`, `kernel_sub`) and
scripts/probe_hash_ops.py (`kern`, nested in `main`; rebuilt here from its
code object with its table width bound), each run through
`pl.pallas_call(..., interpret=True)` on the CPU. A gather copies bits:
exact equality."""

import importlib.util
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from snerf_tpu_torch.probes import gather

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _script(name):
  spec = importlib.util.spec_from_file_location(
      name, os.path.join(REPO, "scripts", f"{name}.py"))
  mod = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(mod)
  return mod


def _pallas(kernel, out_shape, *args):
  vmem = pl.BlockSpec(memory_space=pltpu.VMEM)
  return np.asarray(pl.pallas_call(
      kernel, out_shape=jax.ShapeDtypeStruct(out_shape, jnp.float32),
      in_specs=[vmem] * len(args), out_specs=vmem, interpret=True)(*args))


def _kern(tb):
  """probe_hash_ops.py's `kern` with its closure variable TB = tb."""
  mod = _script("probe_hash_ops")
  code = next(c for c in mod.main.__code__.co_consts
              if isinstance(c, types.CodeType) and c.co_name == "kern")
  assert code.co_freevars == ("TB",)
  return types.FunctionType(code, vars(mod), "kern", None,
                            (types.CellType(tb),))


@pytest.mark.parametrize("axis,s,l", [(1, 8, 128), (1, 8, 512), (1, 16, 1024),
                                      (0, 8, 128), (0, 64, 128),
                                      (0, 1024, 128)])
def test_take_along_axis_matches_pallas_kernel(axis, s, l):
  probe = _script("probe_gather")
  kernel = probe.kernel_lane if axis == 1 else probe.kernel_sub
  rng = np.random.RandomState(s + l + axis)
  x = rng.normal(size=(s, l)).astype(np.float32)
  idx = rng.randint(0, x.shape[axis], (s, l)).astype(np.int32)
  want = _pallas(kernel, (s, l), x, idx)
  np.testing.assert_array_equal(want, np.take_along_axis(x, idx, axis))
  got = gather.take_along_axis(torch.from_numpy(x), torch.from_numpy(idx),
                               axis)
  np.testing.assert_array_equal(got.numpy(), want)
  np.testing.assert_array_equal(
      gather.take_along_axis_plain(torch.from_numpy(x), torch.from_numpy(idx),
                                   axis).numpy(), want)


@pytest.mark.parametrize("tb,nl", [(256, 128), (512, 384)])
def test_gather_select_matches_pallas_kernel(tb, nl):
  rng = np.random.RandomState(tb + nl)
  tab = rng.normal(size=(8, tb)).astype(np.float32)
  idx = rng.randint(0, tb, (8, nl)).astype(np.int32)
  idx[:, 0], idx[:, -1] = 0, tb - 1
  want = _pallas(_kern(tb), (8, nl), tab, idx)
  np.testing.assert_array_equal(want, np.take_along_axis(tab, idx, 1))
  got = gather.gather_select(torch.from_numpy(tab), torch.from_numpy(idx))
  np.testing.assert_array_equal(got.numpy(), want)


def test_probe_checks():
  x = torch.zeros(4, 8)
  i32 = torch.zeros(4, 8, dtype=torch.int32)
  with pytest.raises(ValueError):
    gather.take_along_axis(x, i32.long(), 1)
  with pytest.raises(ValueError):
    gather.take_along_axis(x, i32, 2)
  with pytest.raises(ValueError):
    gather.gather_select(x, torch.zeros(3, 5, dtype=torch.int32))
  # neither CPU nor CUDA: raises, never runs the plain version
  with pytest.raises(ValueError):
    gather.take_along_axis(x.to("meta"), i32.to("meta"), 1)
  with pytest.raises(ValueError):
    gather.gather_select(x.to("meta"), i32.to("meta"))


def test_probe_entry_point_needs_a_card(capsys):
  if torch.cuda.is_available():
    pytest.skip("a CUDA card is present; the survey runs in chip_smoke.py")
  assert gather.main([]) != 0
  assert "CUDA" in capsys.readouterr().err
