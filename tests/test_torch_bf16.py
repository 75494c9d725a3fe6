"""The bf16 trunks on the CPU against snerf_tpu in bf16: K1's plain
forward and backward, the mip MLPs (bench.py's compute dtype) and each
ported ZipMLP arm, on the same numpy-seeded inputs and weights. The zip
train steps are held in tests/test_torch_bf16_train.py.

Each check reads two numbers and its tolerance sits between them:
  the sound reading  the port in bf16 against JAX in bf16;
  the control        the port in float32 against JAX in bf16, the size
                     of the bf16 effect, which the tolerance must catch.
Errors are relative L2 (|got - want| / |want| over a tensor, or over all
of a model's gradients): a ReLU decision that flips where the two
frameworks round a pre-activation near 0 differently moves a row of the
gradients below it, which a max-abs error would read as O(1).
The readings are this repository's on the CPU (stated per check); the
tests read both again and assert the order.
"""

import dataclasses

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snerf_tpu.models import mlp as jmlp
from snerf_tpu.models.mipnerf import MipNerfConfig as JaxMipConfig
from snerf_tpu.models.mipnerf import init_model
from snerf_tpu.models.zipnerf import ZipMLP as JaxZipMLP
from snerf_tpu.models.zipnerf import ZipNerfConfig as JaxZipConfig
from snerf_tpu.ops.pallas.fused_mlp import fused_mlp as jax_fused_mlp
from snerf_tpu_torch.models.mipnerf import MipNerfConfig, MipNerfModel
from snerf_tpu_torch.models.zipnerf import ZipMLP, ZipNerfConfig
from snerf_tpu_torch.ops.fused_mlp import (FusedMLPFunction,
                                           fused_mlp_bwd_plain,
                                           fused_mlp_plain)
from snerf_tpu_torch.utils.weights import (state_dict_from_flax,
                                           zip_state_dict_from_flax)
from tests.test_torch_zip_arms import ARMS, BASE, _gaussians, _scale_fine
from tests.test_torch_zip_trainer import _np

BF16, F32 = torch.bfloat16, torch.float32
N, D = 300, 128     # K1's D rule (a multiple of 128); N ragged


def rel(got, want):
  """|got - want| / |want|, L2 over the whole tensor, in float64."""
  got = np.asarray(torch.as_tensor(got).detach().double())
  want = np.asarray(want, np.float64)
  return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _k1_inputs(n_layers):
  rng = np.random.RandomState(n_layers)
  x = (rng.normal(size=(N, D)) * 0.5).astype(np.float32)
  limit = np.sqrt(6.0 / (2 * D))
  w = rng.uniform(-limit, limit, (n_layers, D, D)).astype(np.float32)
  b = rng.uniform(-0.1, 0.1, (n_layers, 1, D)).astype(np.float32)
  g = rng.normal(size=(N, D)).astype(np.float32)
  return x, w, b, g


def _flax_chain(x, w, b, g, last_relu):
  """flax's bf16 nn.Dense chain on float32 parameters (JAX's trunks) and
  jax.grad of sum(out * g): (out, its layers' outputs, dx, dW, db)."""
  n_layers = w.shape[0]

  class Chain(nn.Module):
    @nn.compact
    def __call__(self, h):
      outs = []
      for i in range(n_layers):
        h = nn.Dense(D, dtype=jnp.bfloat16, name=f"l{i}")(h)
        if i < n_layers - 1 or last_relu:
          h = nn.relu(h)
        outs.append(h)
      return outs

  params = {"params": {f"l{i}": {"kernel": w[i], "bias": b[i, 0]}
                       for i in range(n_layers)}}

  def loss(p, x):
    outs = Chain().apply(p, x)
    return jnp.sum(outs[-1].astype(jnp.float32) * g), outs

  (_, outs), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1),
                                           has_aux=True)(params, x)
  gp = gp["params"]
  dw = np.stack([np.asarray(gp[f"l{i}"]["kernel"]) for i in range(n_layers)])
  db = np.stack([np.asarray(gp[f"l{i}"]["bias"])[None]
                 for i in range(n_layers)])
  outs = [torch.tensor(np.asarray(o.astype(jnp.float32))) for o in outs]
  return outs, np.asarray(gx), dw, db


def test_k1_plain_against_flax_bf16_chain():
  """K1's plain versions against the chain JAX's bf16 models run.

  Forward: fused_mlp_plain rounds once a layer (the Pallas epilogue),
  flax twice (after the dot and after the bias): both outputs sit within
  one bf16 rounding of each other, reading 4.8e-3, and so does the
  float32 control's (5.2e-3), so the forward is held at 1e-2 here and
  tightly against the Pallas kernel below. Backward on the same layer
  outputs (so on the same ReLU decisions): dx and dW read 0 (bit-equal:
  dz rounded to bf16 between layers, the masks from the bf16 outputs, dW
  rounded once), the control (a float32 backward) 2.9e-3 and 2.3e-3:
  limit 1e-3. db reads 7.9e-3: XLA sums the bf16 bias cotangent its own
  way on the CPU, where the port sums in float32 and rounds once; the
  control reads the same (8.0e-3), so db is held at 1.5e-2 only."""
  x, w, b, g = _k1_inputs(3)
  outs, jdx, jdw, jdb = _flax_chain(*(jnp.asarray(a) for a in (x, w, b, g)),
                                    True)
  tx, tw, tb = (torch.tensor(a).bfloat16() for a in (x, w, b))
  for got in (fused_mlp_plain(tx, tw, tb),
              fused_mlp_plain(*(torch.tensor(a) for a in (x, w, b)))):
    assert rel(got.float(), outs[-1]) <= 1e-2, got.dtype
  saved = [o.bfloat16() for o in outs]
  sound = fused_mlp_bwd_plain(tx, tw, tb, saved,
                              torch.tensor(g).bfloat16(), True)
  control = fused_mlp_bwd_plain(
      tx.float(), tw.float(), tb.float(), [s.float() for s in saved],
      torch.tensor(g).bfloat16().float(), True)
  assert [t.dtype for t in sound] == [BF16] * 3
  for i, (name, want) in enumerate((("dx", jdx), ("dW", jdw))):
    assert rel(sound[i].float(), want) <= 1e-3 < rel(control[i], want), name
  assert rel(sound[2].float(), jdb) <= 1.5e-2


@pytest.mark.parametrize("n_layers,last_relu", [(3, True), (2, False)])
def test_k1_plain_against_pallas_interpret_bf16(n_layers, last_relu):
  """Autograd through fused_mlp's CPU path (FusedMLPFunction) on bf16
  leaves against the Pallas kernel in interpret mode on the same bf16
  inputs under its own custom VJP (jax.grad). The forward rounds as the
  kernel does: sound 3.9e-7 / 3.4e-6, control (float32 leaves) 2.8e-3 /
  2.3e-3, limit 1e-4. The Pallas VJP runs its backward in float32 (dh
  widened between layers) where the port rounds dz to bf16, so the
  grads are held looser, at 1e-2: sound dx, dW, db at most 3.2e-3, the
  control 5.3e-2 to 5.8e-2 with three ReLU layers; with two layers and
  no last ReLU the control reads 2.4e-3 to 2.6e-3, as close as the
  sound reading (the float32 backward is the Pallas VJP's), so there the
  grads are only bounded."""
  x, w, b, g = _k1_inputs(n_layers)
  jx, jw, jb = (jnp.asarray(a).astype(jnp.bfloat16) for a in (x, w, b))

  def loss(x, w, b):
    out = jax_fused_mlp(x, w, b, 128, last_relu, True)
    return jnp.sum(out.astype(jnp.float32) * g), out

  (_, jout), jgrads = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                         has_aux=True)(jx, jw, jb)
  jout = np.asarray(jout.astype(jnp.float32))
  jgrads = [np.asarray(t.astype(jnp.float32)) for t in jgrads]
  errs = {}
  for dt in (BF16, F32):
    leaves = [torch.tensor(np.asarray(a.astype(jnp.float32))).to(dt)
              .requires_grad_() for a in (jx, jw, jb)]
    out = FusedMLPFunction.apply(*leaves, last_relu)
    (out.float() * torch.tensor(g)).sum().backward()
    assert out.dtype == dt and all(t.grad.dtype == dt for t in leaves)
    errs[dt] = (rel(out.float(), jout),
                [rel(t.grad.float(), jg) for t, jg in zip(leaves, jgrads)])
  assert errs[BF16][0] <= 1e-4 < errs[F32][0]
  assert max(errs[BF16][1]) <= 1e-2
  if last_relu:
    assert min(errs[F32][1]) > 1e-2


MIP = dict(num_samples=16, num_fine=16, hidden_layer=128,
           proposal_hidden_layer=128, ray_shape="cone", no_warp_sample=False,
           warp_fn=1, t_transform="log", max_deg_point=16, rgb_layer=3,
           semantic=True, semantic_class_num=5)


def test_mip_mlps_bf16_match_jax():
  """bench.py's model in bf16: the NerfMLP (8 x 128 trunk, its K1 runs,
  3 condition layers, the semantic head) and the ProposalMLP on the same
  weights and features, forward and every parameter's gradient of a
  seeded projection of the outputs. Outputs (float32 heads): sound at
  most 2.5e-4, control at least 3.6e-3, limit 1e-3. All gradients
  together: sound 2.3e-3, control 6.9e-2, limit 1e-2; each tensor within
  3e-2 (sound at most 1.5e-2, a bias: XLA's bf16 bias sums), where the
  control's median tensor reads 8.2e-2."""
  rng = np.random.RandomState(0)
  x = rng.normal(size=(8, 16, 96)).astype(np.float32)
  cond = rng.normal(size=(8, 27)).astype(np.float32)
  gs = [rng.normal(size=s).astype(np.float32)
        for s in ((8, 16, 3), (8, 16, 1), (8, 16, 5), (8, 16, 1))]
  params = _np(jax.jit(lambda k: init_model(
      k, JaxMipConfig(**MIP, compute_dtype=jnp.bfloat16))[1])(
          jax.random.PRNGKey(0))["params"])
  jn = jmlp.NerfMLP(net_width=128, condition_depth=3,
                    num_semantic_channels=5, compute_dtype=jnp.bfloat16)
  jp = jmlp.ProposalMLP(net_width=128, compute_dtype=jnp.bfloat16)

  def loss(p):
    outs = (*jn.apply({"params": p["mlp"]}, x, cond),
            jp.apply({"params": p["proposal"]}, x))
    return sum(jnp.sum(o * g) for o, g in zip(outs, gs)), outs

  (_, jouts), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
  jgrads = state_dict_from_flax(_np(jgrads))
  res = {}
  for dt in (BF16, F32):
    model = MipNerfModel(MipNerfConfig(**MIP, compute_dtype=dt),
                         device="cpu")
    model.load_state_dict(state_dict_from_flax(params))
    outs = (*model.mlp(torch.tensor(x), torch.tensor(cond)),
            model.proposal(torch.tensor(x)))
    assert all(o.dtype == F32 for o in outs)
    sum((o * torch.tensor(g)).sum() for o, g in zip(outs, gs)).backward()
    named = dict(model.named_parameters())
    assert set(named) == set(jgrads)
    res[dt] = (max(rel(o, jo) for o, jo in zip(outs, jouts)),
               rel(torch.cat([named[k].grad.flatten() for k in sorted(named)]),
                   np.concatenate([np.ravel(jgrads[k]) for k in
                                   sorted(named)])),
               {k: rel(p.grad, jgrads[k]) for k, p in named.items()})
  assert res[BF16][0] <= 1e-3 < res[F32][0]
  assert res[BF16][1] <= 1e-2 < res[F32][1]
  assert max(res[BF16][2].values()) <= 3e-2
  assert np.median(list(res[F32][2].values())) > 3e-2


# the nerf ZipMLP of each arm at tiny widths, the ipe and CP trunks 128
# wide (K1's D rule) with the skip of tests/test_torch_zip_arms.py
ZIP_WIDTHS = dict(ipe_density_width=128, density_hidden_width=64,
                  grid_num_levels=4, grid_log2_hashmap_size=12,
                  bottleneck_width=32)
ZIP_ARMS = {"hash": dict(encoder_type="hash"),
            "ipe aniso": ARMS["ipe aniso"],
            "cp_hash aniso center": ARMS["cp_hash aniso center"]}
# relative L2 of all the MLP's gradients together: sound / control
# readings hash 3.6e-3 / 1.1e-2, ipe aniso 5.2e-3 / 4.9e-2, cp_hash
# aniso center 4.6e-3 / 7.0e-2
ZIP_GRAD_TOL = 7e-3


@pytest.mark.parametrize("arm", ZIP_ARMS)
def test_zip_mlp_bf16_matches_jax(arm):
  """The nerf MLP of each ported arm in bf16 (JAX's compute_dtype
  bfloat16) on the same weights (tables scaled to +-1), forward at
  train_frac 0.3 and every parameter's gradient of a seeded projection
  of density, rgb and semantics. rgb (the float32 head): sound at most
  6.8e-6, control at least 3.8e-4, limit 1e-4. density and semantic are
  bf16 in JAX (the softplus of a bf16 raw density, the softmax of bf16
  logits): both readings at most 3.0e-3, one bf16 rounding, so they are
  bounded at 5e-3 and checked bf16. The gradients: ZIP_GRAD_TOL."""
  kw = dict(BASE, **ZIP_ARMS[arm], **ZIP_WIDTHS)
  jmlp_ = JaxZipMLP(cfg=JaxZipConfig(**kw, compute_dtype=jnp.bfloat16),
                    grid_resolution=256, grid_level_dim=4)
  tcfg = ZipNerfConfig(**kw)
  rng = np.random.RandomState(0)
  means, stds = _gaussians(tcfg, rng)
  vd = rng.normal(size=(6, 3)).astype(np.float32)
  vd /= np.linalg.norm(vd, axis=-1, keepdims=True)
  params = _np(jax.jit(lambda k: jmlp_.init(
      k, means, stds, viewdirs=vd, train_frac=0.3))(
          jax.random.PRNGKey(1))["params"])
  if arm == "hash":
    params["grid"]["table"] = params["grid"]["table"] * 1e4
  params = _scale_fine({"m": params})["m"]
  keys = ("density", "rgb", "semantic")
  shapes = {"density": (6, 8), "rgb": (6, 8, 3), "semantic": (6, 8, 5)}
  gs = [rng.normal(size=shapes[k]).astype(np.float32) for k in keys]

  def loss(p):
    out = jmlp_.apply({"params": p}, means, stds, viewdirs=vd,
                      train_frac=jnp.float32(0.3))
    return sum(jnp.sum(out[k].astype(jnp.float32) * g)
               for k, g in zip(keys, gs)), out

  (_, jout), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
  assert jout["density"].dtype == jnp.bfloat16
  want = zip_state_dict_from_flax({"m": _np(jgrads)})
  res = {}
  for dt in (BF16, F32):
    tmlp = ZipMLP(dataclasses.replace(tcfg, compute_dtype=dt), 256, 4,
                  device="cpu")
    tmlp.load_state_dict({k[2:]: v for k, v in zip_state_dict_from_flax(
        {"m": params}).items()})
    out = tmlp(torch.from_numpy(means), torch.from_numpy(stds),
               viewdirs=torch.from_numpy(vd), train_frac=0.3)
    assert out["density"].dtype == dt and out["rgb"].dtype == F32
    sum((out[k].float() * torch.from_numpy(g)).sum()
        for k, g in zip(keys, gs)).backward()
    named = sorted(tmlp.named_parameters())
    res[dt] = ({k: rel(out[k].float(), np.asarray(jout[k], np.float32))
                for k in keys},
               rel(torch.cat([p.grad.flatten() for _, p in named]),
                   np.concatenate([np.ravel(want["m." + k])
                                   for k, _ in named])))
  assert res[BF16][0]["rgb"] <= 1e-4 < res[F32][0]["rgb"]
  assert max(res[BF16][0]["density"], res[BF16][0]["semantic"]) <= 5e-3
  assert res[BF16][1] <= ZIP_GRAD_TOL < res[F32][1]
