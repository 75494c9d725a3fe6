"""Held-out PSNR curves of the mip quality cell, cut down to run on a
CPU, from both packages under the same float32 numerics: the JAX
package's bench_quality.run_mip and the port's bench_quality.run_family
at width 128 (proposal 64), 32 + 32 samples, 512 rays a step and 400
steps on tests/fixtures/nuscenes_realfocal, read at steps 100, 200 and
400. Not a pytest module (minutes of CPU); run from the repository root:

  JAX_PLATFORMS=cpu python tests/quality_curve_cpu.py jax 0,1,2
  python tests/quality_curve_cpu.py port 0,1,2

Each prints one line: the package and [[seed, [psnr at 100, 200, 400]],
...].
"""

import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS, BATCH = 400, 512
OVERRIDES = dict(num_samples=32, num_fine=32, hidden_layer=128,
                 proposal_hidden_layer=64, max_deg_point=16)


def main(which, seeds):
  sys.path.insert(0, REPO)
  out = []
  if which == "jax":
    import bench_quality
    scene = bench_quality.load_fixture()
    for seed in seeds:
      r = bench_quality.run_mip(scene, STEPS, BATCH, overrides=OVERRIDES,
                                seed=seed)
      out.append((seed, [c["psnr"] for c in r["curve"]]))
  else:
    import torch
    from snerf_tpu_torch import bench_quality
    scene = bench_quality.load_fixture()
    for seed in seeds:
      r = bench_quality.run_family("mip", scene, STEPS, BATCH,
                                   torch.device("cpu"), seed=seed,
                                   overrides=OVERRIDES)
      out.append((seed, [c["psnr"] for c in r["curve"]]))
  print(which, json.dumps(out), flush=True)


if __name__ == "__main__":
  main(sys.argv[1], [int(s) for s in sys.argv[2].split(",")])
