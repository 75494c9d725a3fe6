"""BENCHMARK.json parses, keeps to the contract's names, units and keys,
and every cell's configuration, traffic, kind module, limits and metric
files are found by name."""

import importlib
import json
import re

import pytest

from bench_port import cell as C

BENCH = C.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {"configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}


def _line(s):
  return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
      and "\t" not in s


def test_top_level_keys_and_size():
  assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
  assert len((C.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
  assert 1 <= BENCH["run_seconds"] <= 51
  assert isinstance(BENCH["run_seconds"], int)


def test_command_and_paths():
  cmd = BENCH["command"]
  assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
  assert cmd == ["python3", "-m", "bench_port.run"]
  assert 1 <= len(BENCH["paths"]) <= 16
  for p in BENCH["paths"]:
    assert PATH.match(p) and not p.startswith("/") and ".." not in p
    assert (C.ROOT / p).is_dir()


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries_keys_and_names(section):
  names = [e["name"] for e in BENCH[section]]
  assert len(names) == len(set(names))
  for e in BENCH[section]:
    extra = {"workloads"} if section in ("end_to_end", "per_layer") else set()
    assert KEYS[section] <= set(e) <= KEYS[section] | extra, e
    assert NAME.match(e["name"]), e["name"]
    if "unit" in e:
      assert UNIT.match(e["unit"]), e["unit"]
      assert e["better"] in ("lower", "higher")
    for key in ("why", "layer", "source"):
      if key in e:
        assert _line(e[key]), (e["name"], key)


def test_bounds():
  for m in BENCH["end_to_end"]:
    assert 0.01 <= m["bound"] <= 0.25, m
    assert m["source"] in ("host_clock", "device_trace")
  setup = [m for m in BENCH["end_to_end"] if m["name"] == "setup_s"]
  assert setup and setup[0]["bound"] == 0.25 and "workloads" not in setup[0]


def test_configs_found_by_name():
  for c in BENCH["configs"]:
    path = C.ROOT / c["file"]
    assert c["file"].startswith("bench_port/") and path.is_file()
    cfg = json.loads(path.read_text())
    assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
    assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
    assert cfg["flags"] and cfg["scene"] and cfg["assumed"]
  files = [c["file"] for c in BENCH["configs"]]
  assert len(files) == len(set(files))


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_files_found_by_name(w):
  names = {c["name"] for c in BENCH["configs"]}
  assert w["config"] in names and w["chips"] in (1, 4)
  assert NAME.match(w["traffic"]) and NAME.match(w["config"])
  traffic = json.loads(C.traffic_file(w["traffic"]).read_text())
  assert (C.BENCH / "drivers" / f"{traffic['kind']}.py").is_file()
  kind = importlib.import_module(f"bench_port.drivers.{traffic['kind']}")
  for attr in ("RATE", "FAULTS", "CONTROL_NEEDS_CARD", "run", "numbers",
               "control"):
    assert hasattr(kind, attr), (traffic["kind"], attr)
  rate = [m for m in BENCH["end_to_end"] if m["name"] == kind.RATE]
  assert rate and w["name"] in rate[0].get("workloads", [w["name"]])
  assert C.limits_file(w["name"]).is_file()
  C.config_file(BENCH, w["config"])


def test_pairs_unique_and_four_chip_share():
  pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
  assert len(pairs) == len(set(pairs))
  four = sum(w["chips"] == 4 for w in BENCH["workloads"])
  assert four <= max(1, len(pairs) // 4)


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_each_cell_reports_setup_another_metric_and_a_layer(w):
  e2e = [m["name"] for m in BENCH["end_to_end"]
         if "workloads" not in m or w["name"] in m["workloads"]]
  assert "setup_s" in e2e and len(e2e) >= 2
  layers = [m for m in BENCH["per_layer"]
            if w["name"] in m.get("workloads", [w["name"]])]
  assert layers
  for m in layers:
    assert m["moves"] in e2e


def test_per_layer_metrics_have_readers_and_known_cells():
  cells = {w["name"] for w in BENCH["workloads"]}
  e2e = {m["name"]: m for m in BENCH["end_to_end"]}
  layer_names = set()
  for m in BENCH["per_layer"]:
    assert C.metric_file(m["name"]).is_file(), m["name"]
    assert m["moves"] in e2e and m["moves"] != "setup_s"
    assert set(m["workloads"]) <= cells
    assert set(m["workloads"]) <= set(e2e[m["moves"]].get("workloads", cells))
    if "roofline" in m["name"] or "mfu" in m["name"]:
      assert m["unit"] == "%"
    layer_names.add(m["layer"])
  assert all(_line(n) for n in layer_names)
