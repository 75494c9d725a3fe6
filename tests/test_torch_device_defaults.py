"""The port's entry points build on the CUDA card unless the caller asks
for the CPU: every public constructor and state factory, and each
sub-module its parent builds, defaults to device="cuda". Read from the
signatures, so the test does not depend on the machine."""

import inspect

import pytest

from snerf_tpu_torch.models.hashgrid import HashEncoding
from snerf_tpu_torch.models.mipnerf import MipNerfModel
from snerf_tpu_torch.models.mlp import DenseBlock, NerfMLP, ProposalMLP
from snerf_tpu_torch.models.posenet import LearnPose
from snerf_tpu_torch.models.zipnerf import ZipMLP, ZipNerfModel
from snerf_tpu_torch.train.trainer import create_train_state
from snerf_tpu_torch.train.zip_trainer import create_zip_train_state

ENTRY_POINTS = [MipNerfModel, ZipNerfModel, create_train_state,
                create_zip_train_state, LearnPose, HashEncoding, ZipMLP,
                NerfMLP, ProposalMLP, DenseBlock]


@pytest.mark.parametrize("fn", ENTRY_POINTS, ids=lambda f: f.__name__)
def test_entry_point_defaults_to_the_card(fn):
  param = inspect.signature(fn).parameters["device"]
  assert param.default == "cuda", (fn.__name__, param.default)
