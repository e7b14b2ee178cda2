"""BENCHMARK.json against the benchmark's contract, and every file it
names found by name."""
import json
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def man():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys(man):
    assert set(man) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert 1 <= man["run_seconds"] <= 51 and isinstance(man["run_seconds"],
                                                        int)
    assert 1 <= len(man["paths"]) <= 16
    for p in man["paths"]:
        assert re.match(r"^[A-Za-z0-9_.\-/]{1,200}$", p) and ".." not in p
        assert os.path.isdir(os.path.join(ROOT, p))
    assert len(man["command"]) <= 32
    for w in man["command"]:
        assert 1 <= len(w) <= 200 and not w.startswith("/")
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_names_and_units(man):
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in man[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append((group, e["name"]))
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
    for group in ("configs", "workloads"):
        got = [e["name"] for e in man[group]]
        assert len(got) == len(set(got))
    metrics = [e["name"] for e in man["end_to_end"] + man["per_layer"]]
    assert len(metrics) == len(set(metrics))


def test_entry_keys(man):
    for c in man["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        for k in ("source", "why"):
            assert 1 <= len(c[k]) <= 200 and "\n" not in c[k]
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for w in man["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for m in man["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in man["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert "\n" not in m["layer"] and "\t" not in m["layer"]
    assert "setup_s" in [m["name"] for m in man["end_to_end"]]


def test_moves_and_workloads_agree(man):
    """Every cell that reports a per-layer metric reports the end-to-end
    metric it moves, and every cell reports set-up, another end-to-end
    metric and a per-layer metric."""
    cells = {w["name"] for w in man["workloads"]}
    e2e = {m["name"]: m for m in man["end_to_end"]}

    def reports(m, cell):
        return "workloads" not in m or cell in m["workloads"]

    for m in man["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert reports(e2e[m["moves"]], cell), (m["name"], cell)
    for cell in cells:
        got = [n for n, m in e2e.items() if reports(m, cell)]
        assert "setup_s" in got and len(got) >= 2
        assert any(reports(m, cell) for m in man["per_layer"])


def test_files_found_by_name(man):
    paths = man["paths"]
    for c in man["configs"]:
        assert any(c["file"].startswith(p + "/") for p in paths)
        with open(os.path.join(ROOT, c["file"])) as f:
            doc = json.load(f)
        assert doc["name"] == c["name"] and doc["source"] == c["source"]
        assert doc["reduced"] == c["reduced"]
    used = {w["config"] for w in man["workloads"]}
    assert used == {c["name"] for c in man["configs"]}
    for w in man["workloads"]:
        with open(os.path.join(ROOT, "slambench", "traffic",
                               f"{w['traffic']}.json")) as f:
            tr = json.load(f)
        assert os.path.exists(os.path.join(
            ROOT, "slambench", "traffic", f"{tr['generator']}.py"))
    for m in man["end_to_end"] + man["per_layer"]:
        assert os.path.exists(os.path.join(ROOT, "slambench", "metrics",
                                           f"{m['name']}.py")), m["name"]


def test_four_chip_share(man):
    four = sum(1 for w in man["workloads"] if w["chips"] == 4)
    assert four <= max(1, len(man["workloads"]) // 4)
