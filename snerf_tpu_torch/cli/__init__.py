"""The port's entry points: `python -m snerf_tpu_torch.cli.train`,
`cli.eval` and `cli.render`, with the flags of train.py, eval.py and
render.py plus `--device` (default cuda)."""
