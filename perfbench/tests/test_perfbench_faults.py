"""The check catches a broken timed path, and the control fails the limits.

The run's steps on the CPU (no look for a card) at a small size, the stages
in float32 so that a sound run reads rounding, with the program broken
underneath in the ways a serving cell can break: an answer altered where it
is produced, and half of a batch left out (the static CNN computes the
first half of each batch of crops; the second half's rows stay zero). Each
must turn ``correct`` false under the cell's own limits. An answer is
altered where the cell's compared numbers look: in both a crop's features,
a crop's probabilities, a window's LSTM logits and a window's audio logits;
in ``parity_fused`` also one frame's candidate boxes, in ``max_fused`` one
frame's candidate scores (each compares only the numbers its control parts
from the reference three times as far as the program, see PERF.md).
``max_fused.short_clips`` is not a cell of ``BENCHMARK.json`` (PERF.md,
Open questions); its configuration, traffic and limits stay, and are held
here. The cells have no training state and run on one chip, so neither a
step that leaves its state unchanged nor a missing exchange between chips
can happen in them.
"""

from __future__ import annotations

import contextlib

import pytest
import torch

from perfbench import control
from perfbench.tests import tiny

CELLS = [("parity_fused", "parity_fused.long_clips"), ("max_fused", "max_fused.short_clips")]


@contextlib.contextmanager
def patched(obj, attr, make):
    orig = getattr(obj, attr)
    setattr(obj, attr, make(orig))
    try:
        yield
    finally:
        setattr(obj, attr, orig)


def detection_altered(orig):
    def forward(self, model, frames):
        out = orig(self, model, frames).clone()
        out[0, :, 4] = 1.0 - out[0, :, 4]  # one frame's candidate scores
        return out
    return forward


def boxes_altered(orig):
    def forward(self, model, frames):
        out = orig(self, model, frames).clone()
        out[0, :, 0:4] += 8.0  # one frame's candidate boxes, shifted
        return out
    return forward


def dynamic_altered(orig):
    def run_dynamic(self, feats, plan):
        logits = orig(self, feats, plan).copy()
        logits[0] = -logits[0] * 10.0  # one window's LSTM logits
        return logits
    return run_dynamic


def features_altered(orig):
    def run_static(self, frames_dev, present_idx, boxes):
        probs, feats = orig(self, frames_dev, present_idx, boxes)
        feats = feats.copy()
        feats[0] = feats[0][::-1]  # one crop's features
        return probs, feats
    return run_static


def static_altered(orig):
    def run_static(self, frames_dev, present_idx, boxes):
        probs, feats = orig(self, frames_dev, present_idx, boxes)
        probs = probs.copy()
        probs[0] = probs[0][::-1]  # one crop's probabilities
        return probs, feats
    return run_static


def half_batch(orig):
    def static_batch(self, frames_dev, idx, boxes):
        n = idx.shape[0] // 2
        out = orig(self, frames_dev, idx[:n], boxes[:n])
        return torch.cat([out, torch.zeros_like(out[: idx.shape[0] - n])])
    return static_batch


def audio_altered(orig):
    def run_from_wav(self, wav, fps):
        logits, windows = orig(self, wav, fps)
        logits = logits.copy()
        logits[0] = -logits[0] * 10.0  # one window's logits
        return logits, windows
    return run_from_wav


def faults():
    from avcer_tpu_torch.pipeline import detect, visual
    from avcer_tpu_torch.pipeline.audio_stage import AudioStage

    return {
        "detection": (detect.DetectStage, "_forward_shard", detection_altered),
        "boxes": (detect.DetectStage, "_forward_shard", boxes_altered),
        "dynamic": (visual.VisualStage, "run_dynamic", dynamic_altered),
        "static": (visual.VisualStage, "run_static_from_frames", static_altered),
        "features": (visual.VisualStage, "run_static_from_frames", features_altered),
        "half_batch": (visual.VisualStage, "static_batch", half_batch),
        "audio": (AudioStage, "run_from_wav", audio_altered),
    }


def checked(name, workload, tmp, seed=2 ** 31 + 17):
    run = tiny.run(name, workload, seed, tmp)
    run.warm_up()
    run.window(0.5)
    return run.check()


@pytest.mark.parametrize("name,workload", CELLS)
def test_a_sound_run_is_correct(name, workload, tmp_path):
    numbers, correct = checked(name, workload, str(tmp_path))
    assert correct, numbers


@pytest.mark.parametrize("name,workload,fault", [
    ("parity_fused", "parity_fused.long_clips", "features"),
    ("parity_fused", "parity_fused.long_clips", "half_batch"),
    ("parity_fused", "parity_fused.long_clips", "boxes"),
    ("parity_fused", "parity_fused.long_clips", "static"),
    ("parity_fused", "parity_fused.long_clips", "dynamic"),
    ("parity_fused", "parity_fused.long_clips", "audio"),
    ("max_fused", "max_fused.short_clips", "features"),
    ("max_fused", "max_fused.short_clips", "half_batch"),
    ("max_fused", "max_fused.short_clips", "detection"),
    ("max_fused", "max_fused.short_clips", "static"),
    ("max_fused", "max_fused.short_clips", "dynamic"),
    ("max_fused", "max_fused.short_clips", "audio")])
def test_a_broken_path_is_not_correct(name, workload, fault, tmp_path):
    obj, attr, make = faults()[fault]
    with patched(obj, attr, make):
        numbers, correct = checked(name, workload, str(tmp_path))
    assert not correct, (fault, numbers)


@pytest.mark.parametrize("name,workload", CELLS)
def test_the_control_fails_the_limits(name, workload, tmp_path):
    """The configuration's control at the small size: the reference in fp8
    in place of the bfloat16 program, or in int4 in place of the int8
    program."""
    cell = tiny.cell(name, workload)
    numbers = control.readings(cell, 2 ** 31 + 19, torch.device("cpu"), cell.config["control"],
                               str(tmp_path),
                               tiny.wav2vec2_config(), tiny.small(False))
    from perfbench import check

    assert not check.verdict(numbers, cell.limits), numbers
