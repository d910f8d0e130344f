"""The harness finds cells, configurations, traffic mixes, limits and
per-layer metrics by their names, so that a later change adds one as files
and entries; and ``BENCHMARK.json`` keeps to the benchmark's contract."""

import json
import math
import os
import re
import shutil

import pytest

from harness import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_every_cell_finds_its_files():
    bench = spec.load_benchmark()
    for w in bench["workloads"]:
        cell = spec.find_cell(w["name"])
        assert cell.config["benchmark"]["sensor"]["beams"] > 0
        assert cell.traffic["frames"] > cell.traffic["warmup_frames"]
        assert "probe" in cell.limits
        assert cell.readers and set(cell.readers) == set(cell.per_layer)
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s", "frames_per_s"}


def test_a_cell_added_from_new_files_alone(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(spec.BENCH_DIR, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = spec.load_benchmark()
    # a new configuration, traffic mix, limits and per-layer metric, as files
    (root / "benchmark" / "configs" / "ncd128_b.yaml").write_text(
        (root / "benchmark" / "configs" / "ncd128.yaml").read_text())
    traffic = json.loads((root / "benchmark" / "traffic" / "walk.json").read_text())
    traffic["motion"]["speed_m_s"] = 2.8
    (root / "benchmark" / "traffic" / "run.json").write_text(json.dumps(traffic))
    shutil.copy(root / "benchmark" / "limits" / "ncd128.json",
                root / "benchmark" / "limits" / "ncd128_b.json")
    (root / "benchmark" / "metrics" / "map_share.py").write_text(
        "def read(trace):\n    return 100.0 * trace.stage_device_ms.get('frame.map', 0.0)\n")
    bench["configs"].append(dict(bench["configs"][0], name="ncd128_b",
                                 file="benchmark/configs/ncd128_b.yaml"))
    bench["workloads"].append({"name": "ncd128_b.run", "config": "ncd128_b", "traffic": "run",
                               "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "map_share", "unit": "%", "better": "lower",
                               "source": "device_trace", "layer": "mapping",
                               "moves": "frames_per_s", "workloads": ["ncd128_b.run"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.find_cell("ncd128_b.run", str(root))
    assert cell.traffic["motion"]["speed_m_s"] == 2.8
    assert "map_share" in cell.readers and "filter_ms" not in cell.readers

    class T:
        stage_device_ms = {"frame.map": 0.5}

    assert cell.readers["map_share"](T()) == 50.0
    with pytest.raises(KeyError):
        spec.find_cell("nothing.here", str(root))


def test_benchmark_json_keeps_to_the_contract():
    bench = spec.load_benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["benchmark"] and bench["command"][1].startswith("benchmark/")
    assert 1 <= bench["run_seconds"] <= 51
    cells = bench["workloads"]
    n = len(cells)
    assert 1 <= n <= 24
    # a full check of 24 cells fits its time
    assert (2 + 14 * 24) * (bench["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    groups = [[c["name"] for c in bench["configs"]], [w["name"] for w in cells],
              [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]]
    for names in groups:
        assert len(names) == len(set(names))
        for nm in names:
            assert NAME.match(nm), nm
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert os.path.isfile(os.path.join(spec.ROOT, c["file"]))
        assert c["file"].startswith("benchmark/") and len(c["reduced"]) <= 16
    pairs = set()
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    assert sum(w["chips"] == 4 for w in cells) <= max(1, math.floor(0.25 * n))
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert UNIT.match(m["unit"]) and m["moves"] in e2e
        assert os.path.isfile(os.path.join(spec.BENCH_DIR, "metrics", m["name"] + ".py"))
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert len(json.dumps(bench)) <= 64 * 1024
