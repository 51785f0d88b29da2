"""Readings for a cell's limits: the numbers the check compares, from sound
runs of the program on many seeds, and from the cell's control on a few.

    python3 perfbench/control.py --workload <cell> --seeds 11,12,... \
        --control-seeds 21,22,23 [--argv "..."] [--control '{...}'] [--out readings.jsonl]

Each seed makes its weights and clips, builds the configuration, warms up
as a run does, serves the traffic's ``check_clips`` clips (one of the
longest among them) and holds them against the reference, as a run holds
its window's sample. The control is the configuration's ``control``:

- ``argv``: the program's own lower-precision path (for a bfloat16
  configuration its int8 path), built with the same weights and served
  the same clips;
- ``reference_format``: the reference put in the program's place, computed
  in that format (``int4``, ``int8``, ``fp8_e4m3``) in the positions an int8
  serving configuration quantises (one scale a tensor for the activation,
  one an output channel for the weight, the product summed in float32);

and in both, the fusion step (float32 in the configuration) computed in
bfloat16.

``--argv`` serves the sound seeds with another argv of the CLI (a second
witness, such as the unfused path), against the same reference; ``--control``
replaces the configuration's control by another (a JSON object as above).
The benchmark's own runs never run this. It prints one JSON line per seed
and writes them all to ``--out``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from perfbench import check, harness, program, weights  # noqa: E402
from perfbench.reference import pipeline as P  # noqa: E402
from perfbench.reference.clip import Reference  # noqa: E402


#: the largest magnitude of each format the control computes in
FORMATS = {"int4": 7.0, "int8": 127.0, "fp8_e4m3": 448.0}


def to_format(x: torch.Tensor, fmt: str) -> torch.Tensor:
    """``x``, already scaled into the format's range, rounded to it."""
    if fmt == "fp8_e4m3":
        return x.clamp(-448.0, 448.0).to(torch.float8_e4m3fn).to(x.dtype)
    return torch.round(x).clamp(-FORMATS[fmt], FORMATS[fmt])


def fake_quant(fmt: str):
    """``models.Ctx.quant``: the input (one scale a tensor) and the weight
    (one scale an output channel) rounded to ``fmt`` at symmetric scales,
    the product summed in float32 and scaled back."""
    top = FORMATS[fmt]

    def run(op, x, w, b, kw):
        sx = x.abs().max().clamp_min(1e-10) / top
        sw = w.flatten(1).abs().amax(1).clamp_min(1e-10) / top
        xq = to_format(x / sx, fmt)
        wq = to_format(w / sw.view(-1, *[1] * (w.dim() - 1)), fmt)
        y = op(xq, wq, None, **kw)
        shape = (-1,) if op is torch.nn.functional.linear else (1, -1) + (1,) * (y.dim() - 2)
        y = y * (sx * sw).view(shape)
        return y if b is None else y + b.view(shape)

    return run


@dataclasses.dataclass
class _Compound:
    av: np.ndarray
    av_prob: np.ndarray


@dataclasses.dataclass
class _Result:
    stat_probs: np.ndarray
    dyn_logits: np.ndarray
    audio_window_logits: np.ndarray
    compound: _Compound


class Packer:
    """The reference's detections in the program's packed layout: the 64
    best candidates of each detected frame (boxes, score, keep, landmarks)."""

    def __init__(self):
        self.rows: list[np.ndarray] = []

    def __call__(self, frames, boxes, landms, scores, raw, anchors) -> None:
        idx = P.top_candidates(scores)
        pick = lambda t: torch.gather(t, 1, idx[..., None].expand(-1, -1, t.shape[-1]))  # noqa
        packed = torch.cat([pick(boxes), torch.gather(scores, 1, idx)[..., None],
                            torch.zeros_like(idx, dtype=boxes.dtype)[..., None], pick(landms)],
                           -1)
        self.rows.append(packed.cpu().numpy())


def reference_served(ref: Reference, clip, serving: dict):
    """What the reference in the program's place serves for a clip."""
    packer = Packer()
    out = ref.run(clip.frames, clip.boxes[::serving["det_stride"]], clip.wav, clip.fps,
                  on_detections=packer)
    rows = np.concatenate(packer.rows) if packer.rows else np.zeros((0, 64, 16), np.float32)
    per = serving["det_batch"] // serving["det_stride"]
    # batch layout: a batch holds det_batch frames, its rows every stride-th
    n_batches = -(-len(out["stat"]) // serving["det_batch"])
    packed = np.zeros((n_batches * per, 64, 16), np.float32)
    packed[:len(rows)] = rows
    res = _Result(out["stat"], out["dyn"], out["audio_windows"],
                  _Compound(out["av_prob"].argmax(1), out["av_prob"]))
    return program.Served(res, [packed], [(out["probs"], out["feats"])])


def bf16_fusion(result, clip) -> _Compound:
    """The fusion step one precision below the configuration's float32:
    the streams' probabilities, the weights and their products and sums in
    bfloat16."""
    def fuse(stat, dyn, audio):
        def b(a):
            return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)

        perm = list(P.VIDEO_TO_FUSION)
        preds = torch.stack([b(stat)[:, perm], torch.softmax(b(dyn)[:, perm], -1),
                             torch.softmax(b(audio)[:, :7], -1)])
        return (preds * b(P.AV_WEIGHTS)[:, None, :]).sum(0).float().numpy().astype(np.float64)

    _, av_prob = check.step_fusion(result, clip, fuse)
    return _Compound(av_prob.argmax(1), av_prob)


def check_clips(run: "harness.Run") -> list:
    """The clips a run's check would sample: ``check_clips`` of them, one of
    the longest of the cycle first."""
    n = run.cell.mix["check_clips"]
    longest = max(run.traffic.cycle)
    first = run.traffic.clip(0, seconds=longest)
    return [first] + [run.traffic.clip(k) for k in range(1, n)]


def readings(cell: "harness.Cell", seed: int, device, control, tmp: str,
             wav2vec2_config=None, config_replace=None, argv=None) -> dict:
    """The numbers of one seed: the program sound (``control`` None, served
    with ``argv`` where given) or the control ``control`` (a configuration's
    ``control`` object)."""
    config = cell.config
    if control is not None and "argv" in control:
        config = dict(config, argv=list(control["argv"]))
    elif control is None and argv is not None:
        config = dict(config, argv=list(argv))
    run = harness.Run(dataclasses.replace(cell, config=config), seed, device, tmp,
                      wav2vec2_config, config_replace)
    run.warm_up()
    clips = check_clips(run)
    # the reference follows the cell's configuration, whatever serves it
    serving = dict(cell.config["serving"]) if config_replace is None else \
        program.serving_of(config_replace(program.pipeline_config(cell.config, tmp)))
    if control is not None and "reference_format" in control:
        program.free(run.program)
        ref_w = weights.to_device(run.weights_host, device)
        # the format in every position an int8 configuration quantises
        low = Reference(ref_w, dict(serving, quant=True), cell.w2v,
                        quant=fake_quant(control["reference_format"]))
        served = [reference_served(low, c, serving) for c in clips]
    else:
        served = [run.program.serve(c, tmp) for c in clips]
        program.free(run.program)
    if control is not None:
        for s, c in zip(served, clips):
            s.result.compound = bf16_fusion(s.result, c)
    ref = Reference(weights.to_device(run.weights_host, device), serving, cell.w2v)
    per_clip = [check.compare(s, c, ref, serving) for s, c in zip(served, clips)]
    return check.worst(per_clip)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--argv", default="", help="serve the sound seeds with this argv")
    p.add_argument("--control", default="", help="a control object in place of the "
                   "configuration's")
    p.add_argument("--out", default="")
    a = p.parse_args(argv)
    cell = harness.load_cell(a.workload)
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    harness.set_caches(harness.ROOT)
    device = torch.device("cuda", 0)
    ctl = json.loads(a.control) if a.control else cell.config["control"]
    serve_argv = a.argv.split() if a.argv else None
    lines = []
    jobs = [(int(s), None) for s in a.seeds.split(",") if s] + [
        (int(s), ctl) for s in a.control_seeds.split(",") if s]
    for seed, control in jobs:
        tmp = tempfile.mkdtemp(prefix="perfbench_control_", dir=os.environ.get("TMPDIR"))
        t0 = time.perf_counter()
        try:
            numbers = readings(cell, seed, device, control, tmp, argv=serve_argv)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        line = {"workload": a.workload, "seed": seed, "control": control is not None,
                "served": control or serve_argv or cell.config["argv"],
                "seconds": time.perf_counter() - t0, "numbers": numbers,
                "card": torch.cuda.get_device_name(0)}
        print(json.dumps(line), flush=True)
        lines.append(line)
    if a.out:
        os.makedirs(os.path.dirname(a.out) or ".", exist_ok=True)
        with open(a.out, "w") as f:
            f.write("".join(json.dumps(x) + "\n" for x in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
