"""Small sizes for the CPU tests, found by name: sizes/configs/<config>.json
cuts a configuration's flags and scene, sizes/traffic/<mix>.json a traffic
mix's parameters, so that a run takes seconds on the CPU. Only the tests
use them."""

import json
from pathlib import Path

SIZES = Path(__file__).resolve().parent / "sizes"


def overrides(config: str, traffic: str):
  cut = json.loads((SIZES / "configs" / f"{config}.json").read_text())
  return {"flags": cut["flags"], "scene": cut["scene"],
          "traffic": json.loads(
              (SIZES / "traffic" / f"{traffic}.json").read_text())}
