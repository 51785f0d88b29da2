"""BENCHMARK.json keeps to the benchmark's contract, and the harness finds a
new configuration, traffic mix, per-layer metric and cell by name alone."""

from __future__ import annotations

import hashlib
import json
import os
import re
import shutil

import numpy as np
import pytest

from perfbench import harness, program, weights, work
from perfbench.reference import pipeline as P
from perfbench.reference.clip import Reference
from perfbench.tests import tiny
from perfbench.tests.tiny import ROOT
from perfbench.traffic import Traffic

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
    """Every reader moves the end-to-end metric its own entry names; every
    role of the pipeline has a family."""
    from perfbench.reference.clip import ROLES

    for w in bench()["workloads"]:
        cell = harness.load_cell(w["name"])
        assert cell.end_to_end and cell.per_layer and cell.limits
        for m, reader in cell.per_layer:
            assert reader.MOVES == m["moves"] and callable(reader.read)
        assert set(cell.families) == set(ROLES)


def digests(root) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_new_files_are_found_by_name(tmp_path):
    """A new configuration whose audio family is a new architecture (here
    the wav2vec2 family's file under a new name, at two layers), a new
    traffic mix, metric, limits and cell: new files and new entries, and no
    file that was there changes while the cell loads, its weights are made,
    the reference serves its audio and its work is counted."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "perfbench"), root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    b = bench()
    pb = root / "perfbench"
    before = digests(pb)  # BENCHMARK.json takes new entries
    config = json.loads((pb / "configs" / "parity_fused.json").read_text())
    config["models"]["audio"] = {"module": "new_audio", "shape": dict(
        config["models"]["audio"]["shape"], **dict(tiny.SMALL_AUDIO, num_layers=2))}
    (pb / "configs" / "new_config.json").write_text(json.dumps(config))
    (pb / "reference" / "families" / "new_audio.py").write_text(
        (pb / "reference" / "families" / "wav2vec2_expr_v3.py").read_text())
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

    audio = cell.families["audio"]
    assert audio.name == "new_audio" and audio.module.__file__ == str(
        pb / "reference" / "families" / "new_audio.py")
    seed = 2 ** 31 + 23
    serving = dict(cell.config["serving"], long_side=96)
    w = weights.make(seed, serving, Traffic(tiny.MIX, seed), "cpu", cell.families)
    layers = {k.split(".")[3] for k in w["audio"] if k.startswith("wav2vec2.encoder.layers.")}
    assert layers == {"0", "1"}
    clip = Traffic(tiny.MIX, seed).clip(0)
    windows, frames = Reference(w, serving, cell.families).audio(clip.wav, clip.fps,
                                                                 clip.frames.shape[0])
    assert windows.shape == (len(P.audio_windows(len(clip.wav))), 8)
    assert np.isfinite(windows).all() and frames.shape == (clip.frames.shape[0], 8)
    ops = work.clip_work(cell.config["serving"], (360, 640), 250, 25.0, 160000, cell.families)
    twelve = work.clip_work(cell.config["serving"], (360, 640), 250, 25.0, 160000,
                            harness.load_cell("parity_fused.long_clips", str(root)).families)
    assert 0 < ops["bf16"] < twelve["bf16"]
    after = digests(pb)
    assert {k: after[k] for k in before} == before


@pytest.mark.parametrize("name", ["parity_fused", "max_fused"])
def test_a_configuration_is_the_clis_deployment(name):
    """A configuration holds the CLI's argv and what describes it, and no
    setting of its own for the host or the program (thread pools, caches):
    the benchmark serves the deployment the CLI builds."""
    with open(os.path.join(ROOT, "perfbench", "configs", name + ".json")) as f:
        config = json.load(f)
    assert set(config) <= {"name", "argv", "overrides", "serving", "models", "control",
                           "source", "sources", "reduced", "assumed"}
    assert set(config["overrides"]) <= {"save_plot"}
    assert set(config["control"]) - {"why"} in ({"argv"}, {"reference_format"})
