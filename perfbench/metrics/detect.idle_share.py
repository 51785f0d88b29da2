"""The share of the profiled clips' wall in which no device operation runs
while the serving thread is inside one of the program's ``detect.*`` spans
(the upload, the I420 rebuild, the int8 calibration watch, enqueuing the
network, decoding): the card idling on the detect stage's host work. The
device intervals are the profile's (``obs.profile.device``). One offset
places the program's spans (``time.time_ns``) on the profile's timeline:
the benchmark's first ``clip`` range against the program's first ``clip``
span, centre against centre. (The program's span starts after the range by
the benchmark's own call path, 113-154 us on a slow host, and ends before it
by a little less: start against start would place every span too early by
more than the check below allows.) Nothing is read unless every
``detect.upload`` so placed lies inside a ``detect.dispatch`` range of the
benchmark within 100 us."""

import bisect

LAYER = "detect"
UNIT = "%"
MOVES = "video_s_per_s"
TOLERANCE_S = 100e-6


def contained(span, ranges, starts) -> bool:
    """``span`` (start, end) inside one of the sorted ``ranges`` within the
    tolerance."""
    i = bisect.bisect_right(starts, span[0] + TOLERANCE_S) - 1
    return i >= 0 and span[1] <= ranges[i][1] + TOLERANCE_S


def read(obs):
    try:
        from avcer_tpu_torch.utils import trace
    except ImportError:  # a program without in-program spans
        return None
    p = obs.profile
    if p is None or p.window_s <= 0:
        return None
    harness_clips = [r for r in p.ranges if r[2] == "clip"]
    clips = sorted(trace.clips(), key=lambda c: c.start)[-len(harness_clips):]
    if not harness_clips or len(clips) < len(harness_clips):
        return None
    t0 = (clips[0].start + clips[0].end) // 2
    origin = (harness_clips[0][0] + harness_clips[0][1]) / 2
    serving = {c.id: c.thread for c in clips}
    detect = [(origin + (s.start - t0) * 1e-9, origin + (s.end - t0) * 1e-9, s.name)
              for s in trace.spans() if s.name.startswith("detect.") and s.clip in serving
              and s.thread == serving[s.clip]]
    dispatch = sorted((s, e) for s, e, name in p.ranges if name == "detect.dispatch")
    starts = [s for s, _ in dispatch]
    uploads = [d for d in detect if d[2] == "detect.upload"]
    if not uploads or not all(contained(u, dispatch, starts) for u in uploads):
        return None
    idle, _ = trace.idle_self([(s, e) for s, e, _ in detect],
                              [(s, e) for s, e, *_ in p.device], p.start, p.stop)
    return 100.0 * sum(idle) / p.window_s
