"""BENCHMARK.json against the benchmark's contract, and the registry finding files by name."""

from __future__ import annotations

import json
import re
import uuid

import pytest

from qbench import registry, run

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
PATH = re.compile(r"[A-Za-z0-9_./-]{1,200}")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


@pytest.fixture(scope="module")
def bench():
    return registry.benchmark()


def test_keys_and_sizes(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert (registry.ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(bench["command"]) <= 32 and all(_line(w) for w in bench["command"])
    assert 1 <= len(bench["paths"]) <= 16
    for path in bench["paths"]:
        assert PATH.fullmatch(path) and not path.startswith("/") and ".." not in path.split("/")
        assert (registry.ROOT / path).is_dir()
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (bench["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_configs(bench):
    assert 1 <= len(bench["configs"]) <= 24
    used = {w["config"] for w in bench["workloads"]}
    files = set()
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.fullmatch(c["name"]) and c["name"] in used
        assert _line(c["source"]) and _line(c["why"])
        assert any(c["file"].startswith(p + "/") for p in bench["paths"])
        assert c["file"] not in files
        files.add(c["file"])
        assert len(c["reduced"]) <= 16 and all(NAME.fullmatch(k) for k in c["reduced"])
        config = registry.config(bench, c["name"])
        assert config["reduced"] == c["reduced"]
        assert (registry.HERE / "gen" / f"{config['generator']}.py").is_file()
        assert (registry.HERE / "runners" / f"{config['runner']}.py").is_file()


def test_workloads(bench):
    cells = bench["workloads"]
    assert 1 <= len(cells) <= 24
    assert len({w["name"] for w in cells}) == len(cells)
    assert len({(w["config"], w["traffic"]) for w in cells}) == len(cells)
    assert sum(w["chips"] == 4 for w in cells) <= max(1, len(cells) // 4)
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.fullmatch(w["name"]) and NAME.fullmatch(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])
        mix = registry.traffic(w["traffic"])
        for kind in ("queries", "reference"):
            assert (registry.HERE / kind / f"{mix['query']}.py").is_file()


def test_metrics(bench):
    e2e, layers = bench["end_to_end"], bench["per_layer"]
    assert 1 <= len(e2e) <= 16 and 1 <= len(layers) <= 128
    names = [m["name"] for m in e2e + layers]
    assert len(set(names)) == len(names)
    cells = {w["name"] for w in bench["workloads"]}
    for m in e2e:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in {"host_clock", "device_trace"}
        assert 0.01 <= m["bound"] <= 0.25
    assert {m["name"]: m["bound"] for m in e2e}["setup_s"] == 0.25
    for m in layers:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert _line(m["layer"]) and m["moves"] in {x["name"] for x in e2e}
        assert m["source"] in SOURCES
    for m in e2e + layers:
        assert NAME.fullmatch(m["name"]) and UNIT.fullmatch(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
        assert (registry.HERE / "metrics" / f"{m['name']}.py").is_file()
    for cell in cells:
        reported = {m["name"] for m in registry.metrics(bench, cell, trace=False)}
        assert "setup_s" in reported and len(reported) >= 2
        assert registry.metrics(bench, cell, trace=True)


def test_registry_finds_new_files_by_name(tmp_path):
    """A new configuration, runner, mix or metric is new files and entries; no code changes."""
    tag = "zz" + uuid.uuid4().hex[:8]
    here = registry.HERE
    metric = here / "metrics" / f"{tag}.py"
    mix = here / "traffic" / f"{tag}.json"
    runner = here / "runners" / f"{tag}.py"
    try:
        metric.write_text("def read(run):\n    return 7.0\n")
        runner.write_text("def run_cell(bench, cell, config, *args, **kwargs):\n"
                          "    return {'ran': cell['name']}, []\n")
        mix.write_text(json.dumps({"query": "q3", "params": {"segment": {"range": [0, 0]}},
                                   "warmup_queries": 1, "profiled_queries": 1}))
        config = tmp_path / f"{tag}.json"
        config.write_text(json.dumps({"generator": "tpch", "runner": tag, "scale_factor": 1,
                                      "reduced": []}))
        bench = registry.benchmark()
        bench["configs"].append({"name": tag, "file": str(config)})
        bench["workloads"].append({"name": f"{tag}.cell", "config": tag, "traffic": tag,
                                   "chips": 4})
        bench["per_layer"].append({"name": tag, "moves": "setup_s", "workloads": [f"{tag}.cell"]})
        assert registry.config(bench, tag)["scale_factor"] == 1
        assert registry.traffic(tag)["query"] == "q3"
        assert registry.module("metrics", tag).read(None) == 7.0
        cell = registry.workload(bench, f"{tag}.cell")
        assert run.run_cell(bench, cell, 1, 1.0, False) == ({"ran": f"{tag}.cell"}, [])
        assert tag in [m["name"] for m in registry.metrics(bench, f"{tag}.cell", trace=True)]
        assert tag not in [m["name"] for m in registry.metrics(bench, "tpch_sf30.q3", trace=True)]
    finally:
        metric.unlink(missing_ok=True)
        mix.unlink(missing_ok=True)
        runner.unlink(missing_ok=True)
