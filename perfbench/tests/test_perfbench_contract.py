"""``BENCHMARK.json`` against the rules a benchmark file keeps, and every
name in it against the files the harness finds by that name."""

import json
import os
import re

import pytest

from perfbench.tests.conftest import REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def spec():
    path = os.path.join(REPO, "BENCHMARK.json")
    assert os.path.getsize(path) <= 64 * 1024
    with open(path) as f:
        return json.load(f)


def line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_command_and_paths(spec):
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(spec["command"]) <= 32 and all(line(w) for w in spec["command"])
    assert 1 <= len(spec["paths"]) <= 16
    for p in spec["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert os.path.isdir(os.path.join(REPO, p))
    assert isinstance(spec["run_seconds"], int) and 1 <= spec["run_seconds"] <= 51


def test_configs_cells_and_their_files(spec):
    paths = spec["paths"]
    configs = {c["name"]: c for c in spec["configs"]}
    assert 1 <= len(configs) == len(spec["configs"]) <= 24
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and line(c["source"]) and line(c["why"]) and len(c["reduced"]) <= 16
        assert any(c["file"].startswith(p + "/") for p in paths)
        with open(os.path.join(REPO, c["file"])) as f:
            assert json.load(f)["reduced"] == c["reduced"]
    assert len({c["file"] for c in spec["configs"]}) == len(configs)
    cells = spec["workloads"]
    assert 1 <= len(cells) <= 24
    assert len({w["name"] for w in cells}) == len(cells)
    assert len({(w["config"], w["traffic"]) for w in cells}) == len(cells)
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and line(w["why"])
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert os.path.exists(os.path.join(REPO, "perfbench", "traffic", f"{w['traffic']}.json"))
    assert {w["config"] for w in cells} == set(configs)
    assert sum(w["chips"] == 4 for w in cells) <= max(1, len(cells) // 4)


def test_metrics_names_units_and_readers(spec):
    e2e, per = spec["end_to_end"], spec["per_layer"]
    cells = {w["name"] for w in spec["workloads"]}
    names = [m["name"] for m in e2e + per]
    assert len(set(names)) == len(names)
    assert 1 <= len(e2e) <= 16 and 1 <= len(per) <= 128
    assert "setup_s" in {m["name"] for m in e2e}
    for m in e2e:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in per:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in SOURCES and line(m["layer"])
        assert m["moves"] in {e["name"] for e in e2e}
        assert set(m.get("workloads", cells)) <= cells
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for m in e2e + per:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert os.path.exists(os.path.join(REPO, "perfbench", "metrics", f"{m['name']}.py")), m["name"]
    for w in cells:  # every cell reports set-up, one other end-to-end metric and a per-layer one
        mine = [m for m in e2e + per if w in m.get("workloads", cells)]
        assert {"setup_s"} < {m["name"] for m in mine if m in e2e}
        assert any(m in per for m in mine)


def test_every_op_a_mix_names_has_its_module(spec):
    for w in spec["workloads"]:
        with open(os.path.join(REPO, "perfbench", "traffic", f"{w['traffic']}.json")) as f:
            traffic = json.load(f)
        for step in traffic["epoch"]:
            assert os.path.exists(os.path.join(REPO, "perfbench", "ops", f"{step['op']}.py"))


def test_each_configuration_names_what_the_harness_looks_up(spec):
    """A configuration's file names the port's filter class and state, its
    reference module and a span for every op its cells run, so that a new
    configuration is new files only."""
    for c in spec["configs"]:
        with open(os.path.join(REPO, c["file"])) as f:
            config = json.load(f)
        assert config["filter"] and config["state"]
        assert os.path.exists(os.path.join(REPO, "perfbench", "reference", f"{config['reference']}.py"))
        for w in spec["workloads"]:
            if w["config"] != c["name"]:
                continue
            with open(os.path.join(REPO, "perfbench", "traffic", f"{w['traffic']}.json")) as f:
                traffic = json.load(f)
            ops = {s["op"] for s in traffic["epoch"]} | ({"insert"} if traffic.get("fill") else set())
            assert ops <= set(config["spans"]), (c["name"], ops)


def test_the_general_code_knows_no_layout():
    """Nothing outside a configuration's own files tells one filter from
    another."""
    for name in ("harness.py", "judge.py", "target.py", "window.py", "gen.py", "trace.py", "run.py"):
        with open(os.path.join(REPO, "perfbench", name)) as f:
            text = f.read()
        for word in ("block_bits", "blocked", "flat", "words", "BitFilter"):
            assert word not in text, (name, word)
