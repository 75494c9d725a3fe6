"""Checkpoint save/restore with resume-latest semantics (counterpart of
snerf_tpu/train/checkpoints.py, on torch.save).

One file a step, `<ckpt_dir>/<step:09d>.pt`, written to a temporary name
and renamed into place, so a reader never sees half a file; the newest
`keep` are kept. A file holds what restores a mip `TrainState` or a
`ZipTrainState` bit for bit: the model's state_dict, the optimizer's
(every group's Adam moments and step counts), the step, the pose model
and its optimizer, the confidence model (its lambdas) and its optimizer,
and the EMA copy. Files load with
`torch.load(weights_only=True)` onto the CPU, then into the state's own
tensors, so a checkpoint saved on one device restores on another. The
pose table also has its own stream under <exp_dir>/pose.

The JAX module's restore-to-host path (`_host_target`) has no
counterpart: restoring onto the card is one copy a tensor here.

Reference: s-nerf/train.py:264-280 (ckpt every i_weights with model +
optimizer states; pose net saved as a separate stream),
s-nerf/utils/model_utils.py:44-63 (resume the last ckpt),
s-nerfpp/zipnerf/internal/checkpoints.py:6-95 (step-suffixed files,
keep-k pruning).
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional, Tuple

import torch

_SUFFIX = ".pt"


def _steps(ckpt_dir: str):
  """The steps saved under ckpt_dir, ascending."""
  if not os.path.isdir(ckpt_dir):
    return []
  return sorted(int(f[:-len(_SUFFIX)]) for f in os.listdir(ckpt_dir)
                if f.endswith(_SUFFIX) and f[:-len(_SUFFIX)].isdigit())


def _path(ckpt_dir: str, step: int) -> str:
  return os.path.join(ckpt_dir, f"{step:09d}{_SUFFIX}")


def latest_step(ckpt_dir: str) -> Optional[int]:
  steps = _steps(ckpt_dir)
  return steps[-1] if steps else None


def _save(ckpt_dir: str, payload: Dict[str, Any], step: int, keep: int):
  os.makedirs(ckpt_dir, exist_ok=True)
  final = _path(ckpt_dir, step)
  tmp = final + ".tmp"
  torch.save(payload, tmp)
  os.replace(tmp, final)
  for old in _steps(ckpt_dir)[:-keep] if keep > 0 else []:
    os.remove(_path(ckpt_dir, old))


def _cpu(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
  """CPU copies (never views of the live tensors, also on the CPU)."""
  return {k: v.detach().to("cpu", copy=True) for k, v in sd.items()}


def _opt_cpu(optimizer) -> Dict[str, Any]:
  sd = optimizer.state_dict()
  return {"state": {i: _cpu(s) for i, s in sd["state"].items()},
          "param_groups": sd["param_groups"]}


# (module, its optimizer) pairs a state may hold besides the model; the
# zip state has no confidence model
_PARTS = (("pose_model", "pose_optimizer"), ("conf_model", "conf_optimizer"))


def state_payload(state) -> Dict[str, Any]:
  """A TrainState or ZipTrainState as a dict of CPU tensor copies and
  plain values."""
  payload = {"step": int(state.step), "model": _cpu(state.model.state_dict()),
             "optimizer": _opt_cpu(state.optimizer)}
  for part, opt in _PARTS:
    if getattr(state, part, None) is not None:
      payload[part] = _cpu(getattr(state, part).state_dict())
      payload[opt] = _opt_cpu(getattr(state, opt))
  if state.ema is not None:
    payload["ema"] = _cpu(state.ema)
  return payload


def save_checkpoint(ckpt_dir: str, state, step: int, keep: int = 3):
  """Save `state` under ckpt_dir as step `step`, keeping the newest
  `keep` steps."""
  _save(ckpt_dir, state_payload(state), step, keep)


def restore_checkpoint(ckpt_dir: str, state, step: Optional[int] = None
                       ) -> Tuple[Any, Optional[int]]:
  """Restore the given (or latest) step into `state` in place, onto the
  devices of the state's own tensors. Returns (state, step), or (state,
  None) when there is no checkpoint."""
  step = step if step is not None else latest_step(ckpt_dir)
  if step is None:
    return state, None
  payload = torch.load(_path(ckpt_dir, step), map_location="cpu",
                       weights_only=True)
  missing = [k for k in ("pose_model", "conf_model", "ema")
             if (getattr(state, k, None) is None) != (k not in payload)]
  if missing:
    raise ValueError(f"checkpoint and state disagree on {missing}: was the "
                     "checkpoint made with other flags?")
  state.model.load_state_dict(payload["model"])
  # Optimizer.load_state_dict casts the moments onto each param's device
  state.optimizer.load_state_dict(payload["optimizer"])
  for part, opt in _PARTS:
    if getattr(state, part, None) is not None:
      getattr(state, part).load_state_dict(payload[part])
      getattr(state, opt).load_state_dict(payload[opt])
  if state.ema is not None:
    with torch.no_grad():
      for k, v in payload["ema"].items():
        state.ema[k].copy_(v)
  state.step = int(payload["step"])
  return state, step


def save_pose_checkpoint(exp_dir: str, pose_state: Dict[str, torch.Tensor],
                         step: int, keep: int = 3):
  """Separate pose-table stream under <exp_dir>/pose (reference keeps
  the pose ckpt apart from the model: s-nerf/train.py:275-280), so pose
  refinements can be mixed across model checkpoints. pose_state: a
  LearnPose state_dict."""
  _save(os.path.join(exp_dir, "pose"), {"pose_params": _cpu(pose_state)},
        step, keep)


def restore_pose_checkpoint(exp_dir: str, step: Optional[int] = None):
  """(the LearnPose state_dict, step) of the given (or latest) step, or
  (None, None)."""
  pose_dir = os.path.join(exp_dir, "pose")
  step = step if step is not None else latest_step(pose_dir)
  if step is None:
    return None, None
  payload = torch.load(_path(pose_dir, step), map_location="cpu",
                       weights_only=True)
  return payload["pose_params"], step
