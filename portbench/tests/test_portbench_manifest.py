"""The manifest (``BENCHMARK.json``) against the benchmark's contract:
names, units, keys, files found by name, the run-length budget."""

import json
import os
import re

import pytest

from portbench import run

ROOT = run.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


@pytest.fixture(scope="module")
def bench():
    return run.manifest()


def test_keys_and_sizes(bench):
    assert set(bench) == KEYS["top"]
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in bench[group]:
            extra = set(e) - KEYS[group]
            assert extra <= ({"workloads"} if group in ("end_to_end",
                                                        "per_layer")
                             else set()), (group, e["name"], extra)
            assert KEYS[group] <= set(e), (group, e["name"])
    assert 1 <= len(bench["configs"]) <= 24
    assert 1 <= len(bench["workloads"]) <= 24
    assert 1 <= len(bench["end_to_end"]) <= 16
    assert 1 <= len(bench["per_layer"]) <= 128


@pytest.mark.parametrize("group", ["configs", "workloads", "end_to_end",
                                   "per_layer"])
def test_names_unique_and_well_formed(bench, group):
    names = [e["name"] for e in bench[group]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n


def test_units_better_sources(bench):
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]), m["name"]
        assert m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in bench["end_to_end"])


def test_text_fields(bench):
    texts = [c["why"] for c in bench["configs"] + bench["workloads"]]
    texts += [c["source"] for c in bench["configs"]]
    texts += [m["layer"] for m in bench["per_layer"]] + bench["command"]
    for t in texts:
        assert 1 <= len(t) <= 200 and "\n" not in t and "\t" not in t, t
    for c in bench["configs"]:
        assert len(c["reduced"]) <= 16
        for k in c["reduced"]:
            assert NAME.match(k)
            assert not (k.endswith("_dim") or k.endswith("_rank")
                        or "width" in k or "hidden" in k), k


def test_paths_and_command(bench):
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert re.match(r"^[A-Za-z0-9_.\-/]{1,200}$", p)
        assert not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch")
    assert len(bench["command"]) <= 32
    for word in bench["command"]:
        assert not word.startswith("/") and ".." not in word


def test_cells_find_their_files(bench):
    configs = {c["name"]: c for c in bench["configs"]}
    pairs = set()
    for w in bench["workloads"]:
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        for path in (f"traffic/{w['traffic']}.json",
                     f"limits/{w['name']}.json"):
            assert os.path.isfile(os.path.join(ROOT, "portbench", path))
    for c in configs.values():
        assert c["file"].startswith("portbench/")
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert any(w["config"] == c["name"] for w in bench["workloads"])
    assert sum(w["chips"] == 4 for w in bench["workloads"]) \
        <= max(1, len(bench["workloads"]) // 4)


def test_every_cell_reports_enough(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for w in bench["workloads"]:
        mine = [m["name"] for m in run.metrics_of(bench, w["name"], False)]
        assert "setup_s" in mine and len(mine) >= 2, w["name"]
        layer = run.metrics_of(bench, w["name"], True)
        assert layer, w["name"]
        for m in layer:
            assert m["moves"] in mine, (w["name"], m["name"])
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        for w in m.get("workloads", []):
            assert any(x["name"] == w for x in bench["workloads"])


def test_layers_named_alike(bench):
    layers = {m["layer"] for m in bench["per_layer"]}
    assert all(len(x) <= 200 and "\n" not in x for x in layers)


def test_run_length_fits_a_full_check(bench):
    s = bench["run_seconds"]
    assert isinstance(s, int) and 1 <= s <= 51
    runs = 2 + 14 * 24
    assert runs * (s + 60) + 24 * 2 * 90 + 1200 <= 43200
