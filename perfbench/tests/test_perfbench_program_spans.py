"""The readers of the program's own spans and counters on a synthetic
observation and program record: their values, the cases where they read
nothing (no tracer in the program, nothing recorded), and the containment
check that places the program's spans on the profile's timeline."""

from __future__ import annotations

import sys
from types import SimpleNamespace

import pytest

from perfbench import harness
from perfbench.tests.tiny import ROOT

NEW = ("detect.upload_host_ms_per_vs", "detect.upload_gb_per_s",
       "detect.enqueue_host_ms_per_vs", "runner.fetch_host_ms_per_vs",
       "runner.save_host_ms_per_vs", "detect.idle_share", "setup.pipeline_s",
       "setup.first_use_s")
SERVING, PREFETCH = 1, 2
#: the program's clock at the first clip's start (ns), the profile's (s)
T0, ORIGIN = 1_700_000_000_000_000_000, 5.0


def reader(name: str):
    return harness.metric_reader(ROOT, name)


def ns(seconds: float) -> int:
    """A program stamp ``seconds`` after the first clip's start."""
    return T0 + round(seconds * 1e9)


def span(i: int, name: str, start: float, end: float, parent=None, thread=SERVING, clip=100):
    return SimpleNamespace(id=i, name=name, start=ns(start), end=ns(end), parent=parent,
                           thread=thread, clip=clip, seconds=end - start)


def record(shift: float = 0.0):
    """A profiled clip of 2 s (program id 100) and the process's set-up:
    the build, a kernel library loaded during it, and in the clip a fold with
    a pack inside and an occupancy query. ``shift`` moves the program's
    detect spans against the profile."""
    d = shift
    spans = [
        span(1, "setup.build_pipeline", -30.0, -20.0, clip=None),
        span(2, "setup.kernel_load", -25.0, -24.0, parent=1, clip=None),
        span(100, "clip", 0.0, 2.0),
        span(101, "detect.upload", 0.10 + d, 0.11 + d, parent=100),
        span(102, "detect.rebuild", 0.11 + d, 0.12 + d, parent=100),
        span(103, "detect.network", 0.12 + d, 0.30 + d, parent=100),
        span(104, "setup.fold", 0.13 + d, 0.15 + d, parent=103),
        span(105, "setup.pack", 0.14 + d, 0.15 + d, parent=104),
        span(106, "detect.decode", 0.30 + d, 0.35 + d, parent=100),
        span(107, "setup.occupancy", 0.31 + d, 0.32 + d, parent=106),
        span(108, "runner.fetch", 0.40, 0.60, parent=100),
        span(109, "visual.static", 1.0, 1.5, parent=100),
        span(110, "visual.fetch", 1.4, 1.5, parent=109),
        span(111, "runner.audio_wait", 1.6, 1.7, parent=100),
        span(112, "runner.save", 1.8, 1.9, parent=100),
        span(113, "runner.fetch", 0.7, 0.8, thread=PREFETCH, parent=None),
    ]
    clips = [SimpleNamespace(id=100, thread=SERVING, start=ns(0.0), end=ns(2.0),
                             counts={"detect.upload_bytes": 2_000_000_000})]
    return spans, clips


def observation(video_s: float = 4.0):
    """The profile of that clip as the benchmark reads it: its ``clip`` and
    ``detect.dispatch`` ranges, and the card busy from 0.2 s to 0.5 s of the
    clip and from 1.0 s to its end."""
    at = ORIGIN
    profile = SimpleNamespace(
        video_s=video_s, start=at, stop=at + 2.0, window_s=2.0,
        ranges=[(at, at + 2.0, "clip"), (at + 0.09, at + 0.36, "detect.dispatch")],
        device=[(at + 0.2, at + 0.5, "k", 7, 1), (at + 1.0, at + 2.0, "k", 7, 2)])
    return SimpleNamespace(profile=profile)


@pytest.fixture
def program(monkeypatch):
    from avcer_tpu_torch.utils import trace

    def use(spans, clips):
        monkeypatch.setattr(trace, "spans", lambda: list(spans))
        monkeypatch.setattr(trace, "clips", lambda: list(clips))

    use(*record())
    return use


def test_values_on_a_synthetic_record(program):
    obs = observation(video_s=4.0)
    got = {name: reader(name).read(obs) for name in NEW}
    assert got["detect.upload_host_ms_per_vs"] == pytest.approx(1e3 * 0.01 / 4)
    assert got["detect.upload_gb_per_s"] == pytest.approx(2.0 / 0.01)
    assert got["detect.enqueue_host_ms_per_vs"] == pytest.approx(1e3 * (0.18 + 0.05) / 4)
    # the prefetch thread's span is not the serving thread's wait
    assert got["runner.fetch_host_ms_per_vs"] == pytest.approx(1e3 * (0.2 + 0.1 + 0.1) / 4)
    assert got["runner.save_host_ms_per_vs"] == pytest.approx(1e3 * 0.1 / 4)
    # idle inside detect.*: from 0.10 s to 0.20 s of the clip (the upload, the
    # rebuild, the network's head); the card is busy from 0.2 s to 0.5 s
    assert got["detect.idle_share"] == pytest.approx(100 * 0.10 / 2.0)
    assert got["setup.pipeline_s"] == pytest.approx(10.0)
    # the fold (its pack inside it) and the occupancy query; the kernel
    # library loaded inside the build is the build's
    assert got["setup.first_use_s"] == pytest.approx(0.02 + 0.01)


@pytest.mark.parametrize("name", NEW)
def test_nothing_recorded_reads_nothing(name, program):
    program([], [])
    assert reader(name).read(observation()) is None


@pytest.mark.parametrize("name", NEW)
def test_a_program_without_the_tracer_reads_nothing(name, monkeypatch):
    import avcer_tpu_torch.utils

    monkeypatch.delattr(avcer_tpu_torch.utils, "trace", raising=False)
    monkeypatch.setitem(sys.modules, "avcer_tpu_torch.utils.trace", None)
    assert reader(name).read(observation()) is None


@pytest.mark.parametrize("name", [n for n in NEW if not n.startswith("setup.")])
def test_no_profile_reads_nothing(name, program):
    assert reader(name).read(SimpleNamespace(profile=None)) is None


@pytest.mark.parametrize("shift,reads", [(0.0, True), (-0.01 - 50e-6, True),
                                         (-0.01 - 200e-6, False), (0.5, False)])
def test_idle_share_needs_the_uploads_inside_the_dispatch_ranges(shift, reads, program):
    """The program's detect spans moved against the profile: an upload up
    to 100 us outside the benchmark's ``detect.dispatch`` range still reads,
    farther does not."""
    program(*record(shift))
    got = reader("detect.idle_share").read(observation())
    assert (got is not None) == reads


def test_idle_share_places_the_clip_centre_against_centre(program):
    """The program's clip span starts 150 us after the benchmark's range and
    ends 80 us before it (the calls between them), and an upload starts 20
    us into its dispatch range. Centre against centre places it 35 us early,
    inside the tolerance; start against start would place it 130 us before
    the range and read nothing."""
    spans, clips = record(shift=-0.01 + 20e-6)
    for c in [s for s in spans if s.name == "clip"] + clips:
        c.start, c.end = ns(150e-6), ns(2.0 - 80e-6)
    program(spans, clips)
    got = reader("detect.idle_share").read(observation())
    assert got == pytest.approx(100 * (0.2 - (0.09 + 20e-6 - 35e-6)) / 2.0)


def test_idle_share_takes_the_last_clips_recorded(program):
    """Clips the program recorded before the profiled ones (another profiler
    in the process) are left out: the last as many as the profile's
    ``clip`` ranges are aligned."""
    spans, clips = record()
    early = [SimpleNamespace(**{**vars(s), "clip": 50, "id": s.id + 1000,
                                "start": s.start - 10**11, "end": s.end - 10**11})
             for s in spans if s.clip == 100]
    program(early + spans, [SimpleNamespace(id=50, thread=SERVING, start=ns(-100.0),
                                            end=ns(-98.0), counts={})] + clips)
    assert reader("detect.idle_share").read(observation()) == pytest.approx(100 * 0.10 / 2.0)
