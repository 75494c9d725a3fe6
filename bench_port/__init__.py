"""The benchmark of the PyTorch port (`snerf_tpu_torch`): `python3 -m
bench_port.run`, driven by BENCHMARK.json and the data files beside it."""
