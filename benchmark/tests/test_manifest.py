"""``BENCHMARK.json`` against the contract, and every name it gives found
as a file."""

import json
import re

import pytest

from benchmark import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _manifest():
    return json.loads(harness.MANIFEST.read_text())


def _manifests():
    """``BENCHMARK.json`` as it stands, and with the held cells' entries,
    which have to meet the contract when they are added."""
    return [_manifest(), harness.load_manifest(held=True)]


@pytest.mark.parametrize("m", _manifests(), ids=["manifest", "held"])
def test_keys_and_names(m):
    assert set(m) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= m["run_seconds"] <= 51
    groups = ([c["name"] for c in m["configs"]],
              [w["name"] for w in m["workloads"]],
              [x["name"] for x in m["end_to_end"] + m["per_layer"]])
    for names in groups:
        assert len(names) == len(set(names))
        for n in names:
            assert NAME.match(n), n
    pairs = [(w["config"], w["traffic"]) for w in m["workloads"]]
    assert len(pairs) == len(set(pairs))
    for x in m["end_to_end"] + m["per_layer"]:
        assert UNIT.match(x["unit"]), x
        assert x["better"] in ("lower", "higher")
    for x in m["end_to_end"]:
        assert set(x) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= x["bound"] <= 0.25
        assert x["source"] in ("host_clock", "device_trace")
    assert any(x["name"] == "setup_s" for x in m["end_to_end"])


@pytest.mark.parametrize("m", _manifests(), ids=["manifest", "held"])
def test_every_name_is_a_file(m):
    for c in m["configs"]:
        assert (harness.ROOT / c["file"]).exists()
        assert c["file"].startswith("benchmark/")
    for w in m["workloads"]:
        assert (harness.HERE / "traffic" / f"{w['traffic']}.json").exists()
        assert (harness.HERE / "cells" / f"{w['name']}.json").exists()
        assert w["chips"] in (1, 4)
    for x in m["per_layer"]:
        assert (harness.HERE / "metrics" / f"{x['name']}.py").exists()


@pytest.mark.parametrize("m", _manifests(), ids=["manifest", "held"])
def test_each_cell_reports_what_the_contract_asks(m):
    e2e = {x["name"]: x for x in m["end_to_end"]}
    for w in m["workloads"]:
        mine = [n for n, x in e2e.items()
                if w["name"] in x.get("workloads", [w["name"]])]
        assert "setup_s" in mine and len(mine) >= 2, w["name"]
        layers = [x for x in m["per_layer"]
                  if w["name"] in x.get("workloads", [w["name"]])]
        assert layers, w["name"]
        for x in layers:
            assert x["moves"] in mine, (w["name"], x["name"])
