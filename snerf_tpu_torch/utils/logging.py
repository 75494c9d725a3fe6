"""Experiment logging: TensorBoard scalars/histograms/images with a jsonl
mirror (counterpart of snerf_tpu/utils/logging.py).

The jsonl file is always written; TensorBoard only where
`torch.utils.tensorboard` imports, as in the JAX class, which degrades
the same way.

Reference: s-nerf/train.py:225-241 (scalar losses + confidence-lambda and
pose-rotation histograms via SummaryWriter).
"""

from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np


class ExperimentLogger:
  """TensorBoard writer with jsonl mirroring; jsonl only when TensorBoard
  is unavailable."""

  def __init__(self, exp_dir: str):
    self.exp_dir = exp_dir
    os.makedirs(exp_dir, exist_ok=True)
    self.jsonl = os.path.join(exp_dir, "train_log.jsonl")
    self.tb = None
    try:
      from torch.utils.tensorboard import SummaryWriter
    except ImportError:
      return
    self.tb = SummaryWriter(os.path.join(exp_dir, "tb"))

  def scalars(self, step: int, values: Dict[str, float]):
    clean = {k: float(v) for k, v in values.items()}
    with open(self.jsonl, "a") as f:
      f.write(json.dumps({"step": step, **clean}) + "\n")
    if self.tb is not None:
      for k, v in clean.items():
        self.tb.add_scalar(k, v, step)

  def histogram(self, step: int, tag: str, values):
    if self.tb is not None:
      self.tb.add_histogram(tag, np.asarray(values), step)

  def image(self, step: int, tag: str, img):
    if self.tb is not None:
      img = np.asarray(img)
      if img.dtype != np.uint8:
        img = (np.clip(img, 0, 1) * 255).astype(np.uint8)
      self.tb.add_image(tag, img, step, dataformats="HWC")

  def close(self):
    if self.tb is not None:
      self.tb.flush()
      self.tb.close()
