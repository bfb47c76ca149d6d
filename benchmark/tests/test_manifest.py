"""BENCHMARK.json against the benchmark's contract, and the files each name
in it resolves to; a cell, a traffic mix and a per-layer metric added as
new files and entries, with no edit to a file that is there."""

import json
import os
import re
import shutil

import pytest

from benchmark import harness

ROOT = harness.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def manifest(root=ROOT):
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def test_keys_names_and_bounds():
    m = manifest()
    assert set(m) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert m["paths"] == ["benchmark"] and m["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= m["run_seconds"] <= 51 and isinstance(m["run_seconds"], int)
    names = [e["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for e in m[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for e in m["configs"]:
        assert set(e) == {"name", "source", "file", "reduced", "why"}
        assert e["file"].startswith("benchmark/") and os.path.isfile(os.path.join(ROOT, e["file"]))
    for e in m["workloads"]:
        assert set(e) == {"name", "config", "traffic", "chips", "why"}
        assert e["chips"] == 1 and len(e["why"]) <= 200
    for e in m["end_to_end"]:
        assert set(e) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= e["bound"] <= 0.25 and e["source"] in ("host_clock", "device_trace")
        assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
    assert {e["name"] for e in m["end_to_end"]} >= {"setup_s"}
    for e in m["per_layer"]:
        assert set(e) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert UNIT.match(e["unit"]) and e["moves"] in {x["name"] for x in m["end_to_end"]}
        if "roofline" in e["name"] or "mfu" in e["name"]:
            assert e["unit"] == "%"
    assert len(json.dumps(m)) < 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in manifest()["workloads"]])
def test_every_cell_resolves(cell):
    c = harness.load_cell(cell)
    assert "setup_s" in c.end_to_end and len(c.end_to_end) >= 2 and c.per_layer
    for metric in c.per_layer:
        assert callable(harness.load_reader(ROOT, metric))
    assert c.traffic["kind"] in harness.KINDS
    harness.port_config(c.config, c.traffic, 1)
    assert set(c.limits) >= ({"missing", "box_gap"} if c.traffic["kind"] == "detect"
                             else {"grad_gap", "change_median_gap"})
    # each per-layer metric that names this cell also reports what it moves here
    for e in manifest()["per_layer"]:
        if cell in e.get("workloads", []):
            assert e["moves"] in c.end_to_end


def test_a_cell_and_a_metric_are_added_as_files(tmp_path):
    """A new traffic mix, a new per-layer metric and a new cell: new files
    and new entries only."""
    root = str(tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    m = manifest()
    traffic = json.load(open(os.path.join(root, "benchmark", "traffic", "detect_b4096.json")))
    traffic["batch"] = 64
    json.dump(traffic, open(os.path.join(root, "benchmark", "traffic", "detect_b64.json"), "w"))
    with open(os.path.join(root, "benchmark", "metrics", "images_seen.detect.py"), "w") as f:
        f.write("def read(ctx):\n    return ctx.rates['attempted']\n")
    cell = "multibox_inception_v3.detect_b64"
    shutil.copy(os.path.join(root, "benchmark", "limits", "multibox_inception_v3.detect_b4096.json"),
                os.path.join(root, "benchmark", "limits", cell + ".json"))
    m["workloads"].append({"name": cell, "config": "multibox_inception_v3",
                           "traffic": "detect_b64", "chips": 1, "why": "batch 64"})
    m["per_layer"].append({"name": "images_seen.detect", "unit": "images", "better": "higher",
                           "source": "host_clock", "layer": "device",
                           "moves": "detect_images_per_s", "workloads": [cell]})
    for e in m["end_to_end"]:
        if "workloads" in e and "multibox_inception_v3.detect_b4096" in e["workloads"]:
            e["workloads"].append(cell)
    json.dump(m, open(os.path.join(root, "BENCHMARK.json"), "w"))
    before = {p: open(os.path.join(ROOT, "benchmark", p), "rb").read()
              for p in ("harness.py", "run.py", "inputs.py", "check.py")}
    c = harness.load_cell(cell, root)
    assert c.traffic["batch"] == 64 and "images_seen.detect" in c.per_layer
    assert "detect_images_per_s" in c.end_to_end

    class Ctx:
        rates = {"attempted": 128}

    assert harness.load_reader(root, "images_seen.detect")(Ctx()) == 128
    assert all(open(os.path.join(root, "benchmark", p), "rb").read() == b
               for p, b in before.items())
