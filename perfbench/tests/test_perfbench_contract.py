"""BENCHMARK.json keeps to the benchmark's contract, and the harness finds a
new configuration, traffic mix, per-layer metric and cell by name alone."""

from __future__ import annotations

import json
import os
import re
import shutil

import pytest

from perfbench import harness, program
from perfbench.tests.tiny import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


def bench() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def one_line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_sizes():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= len(b["paths"]) <= 16 and all(PATH.match(p) for p in b["paths"])
    assert 1 <= len(b["command"]) <= 32 and all(one_line(w) for w in b["command"])
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    # the full check of 24 cells fits its 43200 s
    assert 2 + 14 * 24 * (b["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_names_units_and_keys():
    b = bench()
    names = []
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and one_line(c["source"]) and one_line(c["why"])
        assert c["file"].startswith("perfbench/") and os.path.exists(os.path.join(ROOT, c["file"]))
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    pairs = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert all(NAME.match(w[k]) for k in ("name", "config", "traffic"))
        assert w["config"] in names and w["chips"] in (1, 4) and one_line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    cells = {w["name"] for w in b["workloads"]}
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in SOURCES and m["moves"] in e2e and one_line(m["layer"])
        assert set(m.get("workloads", [])) <= cells
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                                                    "higher")
    all_names = names + list(cells) + [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(all_names) == len(set(all_names))


@pytest.mark.parametrize("name", ["parity_fused", "max_fused"])
def test_config_maps_through_the_cli(name):
    """A configuration file's argv gives, through ``cli.run``, the
    PipelineConfig the CLI builds, and its ``serving`` block says what that
    config serves."""
    import dataclasses

    from avcer_tpu_torch.cli import run as cli

    with open(os.path.join(ROOT, "perfbench", "configs", name + ".json")) as f:
        config = json.load(f)
    got = program.pipeline_config(config, "w")
    want = cli.config_from_args(cli.parse_args(config["argv"] + ["--weights_dir", "w"]))
    assert got == dataclasses.replace(want, **config["overrides"])
    assert program.serving_of(got) == config["serving"]
    assert not got.save_plot


def test_each_cell_loads_its_files():
    for w in bench()["workloads"]:
        cell = harness.load_cell(w["name"])
        assert cell.end_to_end and cell.per_layer and cell.limits
        for _, reader in cell.per_layer:
            assert reader.MOVES == "video_s_per_s" and callable(reader.read)


def test_new_files_are_found_by_name(tmp_path):
    """A new configuration, traffic mix, metric, limits and cell: new files
    and new entries, no edit to a file that is there."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "perfbench"), root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    b = bench()
    pb = root / "perfbench"
    (pb / "configs" / "new_config.json").write_text(
        (pb / "configs" / "parity_fused.json").read_text())
    mix = json.loads((pb / "traffic" / "long_clips.json").read_text())
    mix["clip_seconds"] = [8]
    (pb / "traffic" / "new_mix.json").write_text(json.dumps(mix))
    (pb / "metrics" / "new.metric.py").write_text(
        'LAYER = "device"\nUNIT = "%"\nMOVES = "video_s_per_s"\n\n\ndef read(obs):\n'
        '    return 42.0\n')
    (pb / "limits" / "new_config.new_mix.json").write_text(
        (pb / "limits" / "parity_fused.long_clips.json").read_text())
    b["configs"].append({"name": "new_config", "source": "https://example.org/x",
                         "file": "perfbench/configs/new_config.json", "reduced": [],
                         "why": "a test"})
    b["workloads"].append({"name": "new_config.new_mix", "config": "new_config",
                           "traffic": "new_mix", "chips": 1, "why": "a test"})
    b["per_layer"].append({"name": "new.metric", "unit": "%", "better": "higher",
                           "source": "device_trace", "layer": "device", "moves": "video_s_per_s",
                           "workloads": ["new_config.new_mix"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    cell = harness.load_cell("new_config.new_mix", str(root))
    assert cell.mix["clip_seconds"] == [8]
    assert cell.config["argv"][:2] == ["--serving_profile", "parity"]
    readers = {m["name"]: r for m, r in cell.per_layer}
    assert readers["new.metric"].read(None) == 42.0
    assert "new.metric" not in {m["name"] for m, _ in harness.load_cell(
        "parity_fused.long_clips", str(root)).per_layer}


@pytest.mark.parametrize("name", ["parity_fused", "max_fused"])
def test_a_configuration_is_the_clis_deployment(name):
    """A configuration holds the CLI's argv and what describes it, and no
    setting of its own for the host or the program (thread pools, caches):
    the benchmark serves the deployment the CLI builds."""
    with open(os.path.join(ROOT, "perfbench", "configs", name + ".json")) as f:
        config = json.load(f)
    assert set(config) <= {"name", "argv", "overrides", "serving", "control", "source",
                           "sources", "reduced", "assumed"}
    assert set(config["overrides"]) <= {"save_plot"}
    assert set(config["control"]) - {"why"} in ({"argv"}, {"reference_format"})
