"""K3 (``fused_chain``) at the models' call sites: the sum over the profiled
clips' calls of each call's roofline bound (the larger of its bytes over
3.35 TB/s and its operations over the peak of their type, counted from the
call's input shape, its blocks and ResNet50's widths: ``work.chain_work``)
over the sum of the device time of the operations each call launched."""

LAYER = "kernels"
UNIT = "%"
MOVES = "video_s_per_s"


def read(obs):
    p = obs.profile
    calls = [] if p is None else p.kernel_calls("k3")
    device = sum(t for _, t in calls)
    if not calls or device <= 0:
        return None
    return 100.0 * sum(b for b, _ in calls) / device
