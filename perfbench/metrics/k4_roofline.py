"""K4 (``fused_ssh_heads``) at the detector's call sites: the sum over the
profiled clips' calls of each call's roofline bound (the FPN lateral and
merge, the five SSH convs and the three heads at RetinaFace's widths:
``work.ssh_work``) over the sum of the device time of the operations each
call launched."""

LAYER = "kernels"
UNIT = "%"
MOVES = "video_s_per_s"


def read(obs):
    p = obs.profile
    calls = [] if p is None else p.kernel_calls("k4")
    device = sum(t for _, t in calls)
    if not calls or device <= 0:
        return None
    return 100.0 * sum(b for b, _ in calls) / device
