"""BENCHMARK.json against the benchmark's contract, and the harness's
discovery by name: every file is found from the names in the manifest, a
cell, a configuration or a metric is added with new files and entries
alone, and a run without a card (or without the program) exits non-zero
with no result."""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BENCH = os.path.join(ROOT, "rtbench")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
COMPARED = ("table", "headers")


def manifest() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def text_ok(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_keys_and_command():
    m = manifest()
    assert set(m) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert m["paths"] == ["rtbench"]
    for p in m["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
    assert 1 <= len(m["command"]) <= 32
    assert all(text_ok(w) for w in m["command"])
    assert m["command"][1].startswith("rtbench/")
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 65536


def test_run_seconds_fits_the_check():
    rs = manifest()["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a full check with 24 cells: 2 + 14 x 24 runs, each run_seconds + 60,
    # 2 x 90 s a cell to compile, 1200 s spare, within 43200 s
    assert (2 + 14 * 24) * (rs + 60) + 24 * 180 + 1200 <= 43200


def test_names_units_and_entries():
    m = manifest()
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in m[k]]
    assert all(NAME.match(n) for n in names), names
    metric_names = [x["name"] for x in m["end_to_end"] + m["per_layer"]]
    assert len(set(metric_names)) == len(metric_names)
    for kind in ("configs", "workloads"):
        assert len({x["name"] for x in m[kind]}) == len(m[kind])
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert text_ok(c["source"]) and text_ok(c["why"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and text_ok(w["why"])
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    pairs = [(w["config"], w["traffic"]) for w in m["workloads"]]
    assert len(set(pairs)) == len(pairs)
    assert sum(w["chips"] == 4 for w in m["workloads"]) <= max(
        1, len(m["workloads"]) // 4)
    for e in m["end_to_end"]:
        assert set(e) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert e["source"] in ("host_clock", "device_trace")
        assert 0.01 <= e["bound"] <= 0.25
    assert any(e["name"] == "setup_s" for e in m["end_to_end"])
    for p in m["per_layer"]:
        assert set(p) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert text_ok(p["layer"])
        assert p["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for x in m["end_to_end"] + m["per_layer"]:
        assert UNIT.match(x["unit"]) and x["better"] in ("lower", "higher")
        if "roofline" in x["name"] or "mfu" in x["name"]:
            assert x["unit"] == "%"


def test_every_file_is_found_by_name():
    from rtbench import harness

    m = manifest()
    for c in m["configs"]:
        assert c["file"] == f"rtbench/configs/{c['name']}.json"
        with open(os.path.join(ROOT, c["file"])) as f:
            cfile = json.load(f)
        assert cfile["name"] == c["name"] and cfile["source"] == c["source"]
        assert cfile["reduced"] == c["reduced"]
        assert all(k in cfile for k in c["reduced"])
    used = {w["config"] for w in m["workloads"]}
    assert used == {c["name"] for c in m["configs"]}
    for w in m["workloads"]:
        traffic = harness.load_json(BENCH, "traffic", w["traffic"] + ".json")
        assert os.path.exists(os.path.join(BENCH, "entries",
                                           traffic["entry"] + ".py"))
        limits = harness.load_json(BENCH, "limits", w["name"] + ".json")
        assert all(isinstance(limits[k], float) for k in COMPARED)
    for x in m["end_to_end"] + m["per_layer"]:
        assert hasattr(harness.load_module("metrics", x["name"]), "read")


def test_each_cell_reports_what_it_must():
    """Every cell reports setup_s, another end-to-end metric and a
    per-layer one; each per-layer metric's `moves` is reported in each
    cell it lists."""
    from rtbench import harness

    m = manifest()
    for w in m["workloads"]:
        e2e = {x["name"] for x in harness.metrics_of(m, w["name"], False)}
        per = harness.metrics_of(m, w["name"], True)
        assert "setup_s" in e2e and len(e2e) >= 2 and per
    e2e_by = {x["name"]: x for x in m["end_to_end"]}
    for p in m["per_layer"]:
        assert p["moves"] in e2e_by
        cells = p.get("workloads", [w["name"] for w in m["workloads"]])
        for cell in cells:
            assert cell in e2e_by[p["moves"]].get("workloads", [cell])


ADD = """
import json, sys
sys.path.insert(0, __COPY__)
sys.path.append(__ROOT__)
from rtbench import harness
assert harness.HERE.startswith(__COPY__)
m = harness.load_json(harness.ROOT, "BENCHMARK.json")
ctx = harness.context(m, "added.cell", 5, "cpu")
assert ctx.traffic["batch"] == 3 and ctx.cfg.nk == 48, ctx
assert harness.load_module("entries", ctx.traffic["entry"]).Entry
names = [x["name"] for x in harness.metrics_of(m, "added.cell", True)]
assert "added_metric" in names, names
assert harness.load_module("metrics", "added_metric").read({}) is None
print("found")
"""


def test_a_cell_is_added_without_an_edit(tmp_path):
    """A new configuration, traffic mix, cell and per-layer metric in a
    copy: new files and new manifest entries, no file edited."""
    copy = tmp_path / "checkout"
    shutil.copytree(BENCH, copy / "rtbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    m = manifest()
    with open(copy / "rtbench" / "configs" /
              "miratitan_trg_nk128.json") as f:
        cfg = json.load(f)
    cfg["name"] = "added_config"
    cfg["solver"]["nk"] = 48
    (copy / "rtbench" / "configs" / "added_config.json").write_text(
        json.dumps(cfg))
    (copy / "rtbench" / "traffic" / "added.json").write_text(json.dumps(
        dict(entry="solve", batch=3, lanes=3, check_lanes=1, trace_calls=1)))
    (copy / "rtbench" / "limits" / "added.cell.json").write_text(
        json.dumps({"table": 1e-6, "headers": 1e-9}))
    (copy / "rtbench" / "metrics" / "added_metric.py").write_text(
        "def read(rec):\n    return None\n")
    m["configs"].append(dict(name="added_config", source="a paper",
                             file="rtbench/configs/added_config.json",
                             reduced=[], why="a test"))
    m["workloads"].append(dict(name="added.cell", config="added_config",
                               traffic="added", chips=1, why="a test"))
    m["per_layer"].append(dict(name="added_metric", unit="%",
                               better="higher", source="device_trace",
                               layer="device", moves="setup_s"))
    (copy / "BENCHMARK.json").write_text(json.dumps(m))
    before = {p: p.read_bytes() for p in (copy / "rtbench").rglob("*.py")}
    out = subprocess.run(
        [sys.executable, "-c", ADD.replace("__COPY__", repr(str(copy)))
         .replace("__ROOT__", repr(ROOT))], capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0 and "found" in out.stdout, out.stderr[-2000:]
    assert all(p.read_bytes() == b for p, b in before.items())


def _run(cwd: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run(
        [sys.executable, "rtbench/run.py", "--workload", "trg128.solve.w512",
         "--seed", "3000000000", "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300, env=env)


def test_no_card_no_result():
    out = _run(ROOT)
    assert out.returncode != 0
    assert "correct" not in out.stdout
    assert "no CUDA card" in out.stderr


def test_without_the_program_no_result(tmp_path):
    """A directory with BENCHMARK.json and rtbench alone: non-zero."""
    shutil.copytree(BENCH, tmp_path / "rtbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    out = _run(str(tmp_path))
    assert out.returncode != 0 and "correct" not in out.stdout


@pytest.mark.parametrize("cell", [w["name"] for w in manifest()["workloads"]])
def test_cell_on_one_chip(cell):
    """No cell asks for four chips: the port's split has never run on
    several cards, and no cell measures what exists only across chips."""
    w = next(x for x in manifest()["workloads"] if x["name"] == cell)
    assert w["chips"] == 1
