"""The share of the profiled clips' wall in which no kernel, copy or set ran
on any stream of the card: 1 - the union of the device intervals over the
stretch from the first profiled clip's start to the last one's end."""

LAYER = "device"
UNIT = "%"
MOVES = "video_s_per_s"


def read(obs):
    p = obs.profile
    if p is None or p.window_s <= 0:
        return None
    return 100.0 * (1.0 - p.busy_s / p.window_s)
