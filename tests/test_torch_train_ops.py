"""The mip trainer's ops in the port against snerf_tpu, same numpy inputs:
the learning-rate schedule, gradient clipping, the proposal-loss step
functions, the SO(3) helpers (values and grads), each mip loss (values
and grads) and the batch sampler (on the JAX sampler's own pixels).

Tolerances: float32 on both sides, 1e-6 relative for closed forms, 1e-5
where a sum or a matmul of a few hundred terms enters (summation order);
the grads of exp_so3 at r = 0 are exact polynomials and must agree to
1e-6 and be finite.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snerf_tpu.ops import lie as jlie
from snerf_tpu.ops import math as jmath
from snerf_tpu.ops import stepfun as jstepfun
from snerf_tpu.train import losses as jlosses
from snerf_tpu_torch.ops import lie, stepfun
from snerf_tpu_torch.ops import math as smath
from snerf_tpu_torch.train import losses

T = torch.from_numpy


def _close(got, want, rtol=1e-6, atol=1e-7, msg=""):
  np.testing.assert_allclose(np.asarray(got.detach() if hasattr(
      got, "detach") else got), np.asarray(want), rtol=rtol, atol=atol,
                             err_msg=msg)


@pytest.mark.parametrize("delay", [0, 2500])
def test_learning_rate_decay(delay):
  steps = np.array([0, 1, 100, 2499, 2500, 50_000, 200_000, 250_000])
  kw = dict(lr_init=5e-4, lr_final=5e-6, max_steps=200_000,
            lr_delay_steps=delay, lr_delay_mult=0.01)
  for s in steps:
    _close(smath.learning_rate_decay(int(s), **kw),
           jmath.learning_rate_decay(jnp.int32(s), **kw), msg=str(s))
  _close(smath.log_lerp(0.3, 2.0, 8.0), jmath.log_lerp(0.3, 2.0, 8.0))
  with pytest.raises(ValueError):
    smath.log_lerp(0.5, 0.0, 1.0)


@pytest.mark.parametrize("max_val,max_norm", [(None, None), (0.5, None),
                                              (None, 2.0), (0.5, 0.3)])
def test_clip_gradients_in_place(max_val, max_norm):
  rng = np.random.RandomState(0)
  gs = [rng.normal(size=(4, 5)).astype(np.float32),
        rng.normal(size=(7,)).astype(np.float32)]
  gs[0][0, 0], gs[0][1, 1], gs[1][2] = np.nan, np.inf, -np.inf
  want = jmath.clip_gradients([jnp.asarray(g) for g in gs], max_val,
                              max_norm)
  got = [T(g.copy()) for g in gs]
  assert smath.clip_gradients(got, max_val, max_norm) is None
  for g, w in zip(got, want):
    _close(g, w)
    assert torch.isfinite(g).all()


def _step_fns(seed, n_env=9, n=6, batch=5):
  rng = np.random.RandomState(seed)
  t_env = np.sort(rng.uniform(0, 1, (batch, n_env + 1)), -1)
  w_env = rng.uniform(0, 1, (batch, n_env))
  t = np.sort(rng.uniform(-0.1, 1.1, (batch, n + 1)), -1)
  t[0] = t_env[0, 0] + np.linspace(0, 1, n + 1) * 0.3  # shared edges
  w = rng.uniform(0, 0.5, (batch, n))
  return [a.astype(np.float32) for a in (t, w, t_env, w_env)]


@pytest.mark.parametrize("seed", [0, 1])
def test_inner_outer_query_lossfun_outer(seed):
  t, w, t_env, w_env = _step_fns(seed)
  want = jstepfun.inner_outer(jnp.asarray(t), jnp.asarray(t_env),
                              jnp.asarray(w_env))
  got = stepfun.inner_outer(T(t), T(t_env), T(w_env))
  for g, wa in zip(got, want):
    _close(g, wa, rtol=1e-6, atol=1e-6)
  _close(stepfun.query(T(t), T(t_env), T(w_env)),
         jstepfun.query(jnp.asarray(t), jnp.asarray(t_env),
                        jnp.asarray(w_env)))
  tw = T(w_env).requires_grad_()
  loss = stepfun.lossfun_outer(T(t), T(w), T(t_env), tw)
  loss.sum().backward()
  jloss, jgrad = jax.value_and_grad(lambda we: jstepfun.lossfun_outer(
      jnp.asarray(t), jnp.asarray(w), jnp.asarray(t_env), we).sum())(
          jnp.asarray(w_env))
  _close(loss.sum(), jloss, rtol=1e-5)
  _close(tw.grad, jgrad, rtol=1e-5, atol=1e-6)


def _rotvecs():
  rng = np.random.RandomState(3)
  r = rng.normal(size=(6, 3)).astype(np.float32)
  r[0] = 0.0              # the LearnPose init
  r[1] = [1e-7, 0, 0]     # inside the Taylor branch
  r[2] *= 1e-3
  return r


def test_skew_exp_log_so3_values():
  r = _rotvecs()
  _close(lie.skew(T(r)), jlie.skew(jnp.asarray(r)))
  R = lie.exp_so3(T(r))
  _close(R, jlie.exp_so3(jnp.asarray(r)), atol=1e-6)
  _close(lie.log_so3(R), jlie.log_so3(jnp.asarray(np.asarray(R))),
         rtol=1e-5, atol=1e-6)
  rng = np.random.RandomState(4)
  init = np.concatenate([np.asarray(jlie.exp_so3(jnp.asarray(
      rng.normal(size=(6, 3)).astype(np.float32)))),
                         rng.normal(size=(6, 3, 1))], -1).astype(np.float32)
  t = rng.normal(size=(6, 3)).astype(np.float32)
  _close(lie.make_c2w(T(r), T(t), T(init)),
         jlie.make_c2w(jnp.asarray(r), jnp.asarray(t), jnp.asarray(init)),
         atol=1e-6)
  _close(lie.make_c2w(T(r), T(t)),
         jlie.make_c2w(jnp.asarray(r), jnp.asarray(t)), atol=1e-6)


def test_exp_so3_and_make_c2w_grads_match_jax_at_zero_and_beyond():
  r = _rotvecs()
  rng = np.random.RandomState(5)
  init = rng.normal(size=(6, 3, 4)).astype(np.float32)
  wts = rng.normal(size=(6, 3, 4)).astype(np.float32)
  t = rng.normal(size=(6, 3)).astype(np.float32)

  def jf(r, t):
    return jnp.sum(jlie.make_c2w(r, t, jnp.asarray(init)) * wts)

  jgr, jgt = jax.grad(jf, argnums=(0, 1))(jnp.asarray(r), jnp.asarray(t))
  tr, tt = T(r).requires_grad_(), T(t).requires_grad_()
  (lie.make_c2w(tr, tt, T(init)) * T(wts)).sum().backward()
  assert torch.isfinite(tr.grad).all()
  _close(tr.grad, jgr, rtol=1e-5, atol=1e-6)
  _close(tt.grad, jgt, rtol=1e-6, atol=1e-6)
  # r = 0 exactly: the grad of exp_so3 is finite and equals JAX's
  z = torch.zeros(1, 3, requires_grad=True)
  (lie.exp_so3(z) * T(wts[:1, :, :3])).sum().backward()
  jz = jax.grad(lambda v: jnp.sum(jlie.exp_so3(v) * wts[:1, :, :3]))(
      jnp.zeros((1, 3)))
  assert torch.isfinite(z.grad).all()
  _close(z.grad, jz)


def _loss_inputs(seed=0, n=64):
  rng = np.random.RandomState(seed)
  f32 = lambda a: np.asarray(a, np.float32)
  return dict(
      pred=f32(rng.uniform(0, 1, (n, 3))), tgt=f32(rng.uniform(0, 1, (n, 3))),
      mask=rng.uniform(size=(n, 1)) > 0.3,
      logits=f32(rng.normal(size=(n, 5))),
      labels=rng.randint(-1, 5, size=(n,)).astype(np.int32),
      dist=f32(rng.uniform(0.5, 20, (n,))), dist_c=f32(rng.uniform(0.5, 20,
                                                                    (n,))),
      depth=f32(np.where(rng.uniform(size=n) > 0.2,
                         rng.uniform(1, 20, n), 0.0)),
      conf=f32(rng.uniform(0, 1, (n,))))


@pytest.mark.parametrize("masked", [False, True])
def test_rgb_and_semantic_loss(masked):
  d = _loss_inputs()
  mask = d["mask"] if masked else None
  tp = T(d["pred"]).requires_grad_()
  got = losses.rgb_loss(tp, T(d["tgt"]), None if mask is None else T(mask))
  got.backward()
  want, jg = jax.value_and_grad(lambda p: jlosses.rgb_loss(
      p, d["tgt"], mask))(jnp.asarray(d["pred"]))
  _close(got, want, rtol=1e-6)
  _close(tp.grad, jg, rtol=1e-5, atol=1e-9)
  sm = None if mask is None else mask[:, 0]
  tl = T(d["logits"]).requires_grad_()
  got = losses.semantic_loss(tl, T(d["labels"]),
                             None if sm is None else T(sm), weight=0.04)
  got.backward()
  want, jg = jax.value_and_grad(lambda lg: jlosses.semantic_loss(
      lg, jnp.asarray(d["labels"]), None if sm is None else jnp.asarray(sm),
      weight=0.04))(jnp.asarray(d["logits"]))
  _close(got, want, rtol=1e-5)
  _close(tl.grad, jg, rtol=1e-5, atol=1e-9)


@pytest.mark.parametrize("disparity", [False, True])
@pytest.mark.parametrize("conf", [False, True])
def test_depth_loss(disparity, conf):
  d = _loss_inputs(1)
  cw = d["conf"] if conf else None
  tp, tc = T(d["dist"]).requires_grad_(), T(d["dist_c"]).requires_grad_()
  got = losses.depth_loss(tp, tc, T(d["depth"]), disparity=disparity,
                          coarse_mult=0.1,
                          conf_weight=None if cw is None else T(cw))
  got.backward()
  want, (gp, gc) = jax.value_and_grad(
      lambda p, c: jlosses.depth_loss(p, c, jnp.asarray(d["depth"]),
                                      disparity=disparity, coarse_mult=0.1,
                                      conf_weight=cw), argnums=(0, 1))(
          jnp.asarray(d["dist"]), jnp.asarray(d["dist_c"]))
  _close(got, want, rtol=1e-5)
  _close(tp.grad, gp, rtol=1e-5, atol=1e-9)
  _close(tc.grad, gc, rtol=1e-5, atol=1e-9)


@pytest.mark.parametrize("sky", [False, True])
def test_edge_aware_smooth_loss(sky):
  rng = np.random.RandomState(2)
  rgb = rng.uniform(0, 1, (3, 4, 4, 3)).astype(np.float32)
  dist = rng.uniform(0.5, 10, (3, 4, 4)).astype(np.float32)
  skym = rng.uniform(size=(3, 4, 4)) > 0.5 if sky else None
  td = T(dist).requires_grad_()
  got = losses.edge_aware_smooth_loss(T(rgb), td,
                                      None if skym is None else T(skym),
                                      weight=0.02)
  got.backward()
  want, jg = jax.value_and_grad(lambda ds: jlosses.edge_aware_smooth_loss(
      jnp.asarray(rgb), ds, skym, weight=0.02))(jnp.asarray(dist))
  _close(got, want, rtol=1e-5)
  _close(td.grad, jg, rtol=1e-4, atol=1e-9)


def test_proposal_loss_grad_reaches_the_coarse_level_only():
  t, w, t_env, w_env = _step_fns(4)
  tw, tc = T(w).requires_grad_(), T(w_env).requires_grad_()
  got = losses.proposal_loss(T(t), tw, T(t_env), tc, weight=1.0)
  got.backward()
  want, (gf, gc) = jax.value_and_grad(
      lambda wf, wc: jlosses.proposal_loss(jnp.asarray(t), wf,
                                           jnp.asarray(t_env), wc),
      argnums=(0, 1))(jnp.asarray(w), jnp.asarray(w_env))
  _close(got, want, rtol=1e-5)
  assert tw.grad is None and float(np.abs(np.asarray(gf)).max()) == 0
  _close(tc.grad, gc, rtol=1e-5, atol=1e-7)


def test_masked_mean():
  x = np.arange(12, dtype=np.float32).reshape(3, 4)
  m = np.array([[True], [False], [True]])
  _close(losses.masked_mean(T(x), T(m)), jlosses.masked_mean(x, m))
  _close(losses.masked_mean(T(x), T(np.zeros_like(m))),
         jlosses.masked_mean(x, np.zeros_like(m)))
  _close(losses.masked_mean(T(x)), jlosses.masked_mean(x))


def _sampler_scenes():
  from snerf_tpu.data import synthetic as jsynthetic
  from snerf_tpu_torch.data import synthetic
  kw = dict(num_images=5, H=12, W=16, n_render_samples=8)
  return synthetic.make_synthetic_scene(**kw), \
      jsynthetic.make_synthetic_scene(**kw)


@pytest.mark.parametrize("single_image", [True, False])
def test_sample_batch_matches_jax_on_its_pixels(single_image):
  """The JAX sampler's pixels injected into the port's sample_batch, with
  a pose table: the same rays and targets."""
  import functools
  from snerf_tpu.data import sampler as jsampler
  from snerf_tpu_torch.data import sampler
  scene, jscene = _sampler_scenes()
  rng = np.random.RandomState(6)
  table = (scene.poses + rng.normal(size=scene.poses.shape) * 0.01).astype(
      np.float32)
  jfn = jax.jit(functools.partial(
      jsampler.sample_batch, batch_size=24, near=scene.near, far=scene.far,
      single_image=single_image, n_patches=2, patch_size=4))
  jrays, jt = jfn(jax.random.PRNGKey(3), jsampler.scene_to_device(jscene),
                  jnp.asarray(scene.i_train), use_pose_table=table)
  rays, tt = sampler.sample_batch(
      sampler.scene_to_device(scene, "cpu"), scene.i_train, 24, scene.near,
      scene.far, n_patches=2, patch_size=4, use_pose_table=T(table),
      img_idx=T(np.asarray(jt["img_idx"])), py=T(np.asarray(jt["py"])),
      px=T(np.asarray(jt["px"])))
  for name in ("origins", "directions", "viewdirs", "radii", "near", "far",
               "app"):
    _close(getattr(rays, name), getattr(jrays, name), atol=1e-6, msg=name)
  for k in ("rgb", "img_idx", "py", "px", "depth", "cam_index"):
    _close(tt[k], jt[k], msg=k)


def test_sample_batch_from_generator():
  """Drawn pixels: one train image (single_image), random pixels then
  4x4 patches, targets gathered from them, reproducible from the seed; a
  pose table's grad reaches only the sampled image's pose."""
  from snerf_tpu_torch.data import sampler
  scene, _ = _sampler_scenes()
  dev = sampler.scene_to_device(scene, "cpu")
  table = T(scene.poses.copy()).requires_grad_()
  rays, t = sampler.sample_batch(
      dev, scene.i_train, 24, scene.near, scene.far, n_patches=2,
      patch_size=4, use_pose_table=table,
      generator=torch.Generator().manual_seed(0))
  idx, py, px = t["img_idx"], t["py"], t["px"]
  assert idx.shape == py.shape == px.shape == (24 + 2 * 16,)
  assert len(set(idx.tolist())) == 1 and int(idx[0]) in scene.i_train
  want = scene.images[idx.numpy(), py.numpy(), px.numpy()] / 255.0
  _close(t["rgb"], want.astype(np.float32))
  patch_y = py[24:].reshape(2, 4, 4)
  assert (patch_y - patch_y[:, :1, :1] == torch.arange(4)[:, None]).all()
  again = sampler.draw_pixels(dev["images"], scene.i_train, 24, True, 2, 4,
                              torch.Generator().manual_seed(0))
  for a, b in zip(again, (idx, py, px)):
    assert torch.equal(a, b)
  rays.origins.sum().backward()
  hit = table.grad.abs().sum(dim=(1, 2)) > 0
  assert hit.tolist() == [i == int(idx[0]) for i in range(scene.num_images)]
