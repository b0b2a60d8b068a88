"""BENCHMARK.json against the benchmark's contract, every cell's files
found by name, and a cell, configuration and metric added as files alone."""
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from bench import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) < 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51
    assert BENCH["paths"] == ["bench"]
    assert all(_line(w) for w in BENCH["command"])
    runs = 2 + 14 * 24
    assert (runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200
            <= 43200)


def test_names_units_and_keys():
    names = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["why"])
        assert all(NAME.match(k) for k in c["reduced"])
        assert (ROOT / c["file"]).is_file()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and _line(w["why"]) and w["chips"] == 1
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["name"] not in names
        names.add(m["name"])
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_resolve_by_name(cell):
    w = next(x for x in BENCH["workloads"] if x["name"] == cell)
    wl = harness.load_json("workloads", cell)
    assert (wl["config"], wl["traffic"], wl["chips"], wl["why"]) == (
        w["config"], w["traffic"], w["chips"], w["why"])
    conf = harness.load_json("configs", w["config"])
    entry = next(c for c in BENCH["configs"] if c["name"] == w["config"])
    assert conf["source"] == entry["source"]
    assert conf["reduced"] == entry["reduced"]
    harness.load_json("traffic", w["traffic"])
    reported = harness.metrics_of(BENCH, cell, True)
    assert reported
    for m in reported:
        assert callable(harness.metric_reader(m["name"]))
    e2e = {m["name"] for m in harness.metrics_of(BENCH, cell, False)}
    assert "setup_s" in e2e and len(e2e) >= 2
    for m in reported:
        assert m["moves"] in e2e


def test_new_cell_config_and_metric_found_without_code_edits(tmp_path):
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    conf = json.loads((ROOT / "bench/configs/gpt2-large.json").read_text())
    conf["name"] = "gpt2-large-copy"
    (tmp_path / "bench/configs/gpt2-large-copy.json").write_text(
        json.dumps(conf))
    wl = json.loads((ROOT / "bench/workloads/gpt2l-long.json").read_text())
    wl.update(name="new-cell", config="gpt2-large-copy", traffic="new-mix")
    (tmp_path / "bench/workloads/new-cell.json").write_text(json.dumps(wl))
    (tmp_path / "bench/traffic/new-mix.json").write_text(
        (ROOT / "bench/traffic/long-doc.json").read_text())
    (tmp_path / "bench/metrics/new_metric.py").write_text(
        "def read(run):\n    return 42.0\n")
    bench["workloads"].append({"name": "new-cell", "config": "gpt2-large-copy",
                               "traffic": "new-mix", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "new_metric", "unit": "%",
                               "better": "higher", "source": "device_trace",
                               "layer": "device", "moves": "tokens_per_s",
                               "workloads": ["new-cell"]})
    for m in bench["end_to_end"]:
        if "workloads" in m and "gpt2l-long" in m["workloads"]:
            m["workloads"].append("new-cell")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = (
        "import sys, json; sys.path.insert(0, sys.argv[1])\n"
        "from bench import harness, run\n"
        "ctx = run.context('new-cell', 7, 1, 1, None)\n"
        "names = [m['name'] for m in harness.metrics_of(harness.benchmark(),"
        " 'new-cell', True)]\n"
        "print(json.dumps([ctx.config['name'], ctx.mix['clients'], names,"
        " harness.metric_reader('new_metric')({})]))\n")
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                         capture_output=True, text=True, cwd=tmp_path,
                         check=True)
    conf_name, clients, names, value = json.loads(out.stdout)
    assert (conf_name, clients, value) == ("gpt2-large-copy", 32, 42.0)
    assert names == ["new_metric"]
