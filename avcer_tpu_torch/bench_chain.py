"""Times ``fused_chain`` (K3) at every call the r50 main paths make, in bf16
and in the int8 mode, on one NVIDIA GPU:

    python3 avcer_tpu_torch/bench_chain.py [--root DIR] [--label NAME] [--out FILE]

``--root`` takes ``avcer_tpu_torch`` from another checkout (an unpacked
parent commit), so that two versions of the kernel are timed by the same
script in one session; run them in turns (parent, change, change, parent).
Weights and inputs are random from a fixed seed at the models' widths; the
time of a call does not depend on their values. Each time is the median of
50 calls after 5 warm-ups, with CUDA events. Prints one JSON object (also
written to ``--out``): the card's name and power limit, and per call its
shape, kinds, the plan's work items, cluster size and grid, and what the
card reports it holds of that launch (clusters at once, blocks an SM),
where the version has them, and ms.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

#: (label, input shape, output channels, planes, kinds): detector batch 32
#: at 640 x 360 letterboxed to 640, emotion CNN batch 256 at 224
CALLS = [
    ("detector layer1", (32, 90, 160, 64), 256, 64, ("ds", "id", "id")),
    ("detector layer2", (32, 90, 160, 256), 512, 128, ("s2ds", "id", "id", "id")),
    ("detector layer3 entry", (32, 45, 80, 512), 1024, 256, ("s2ds", "id")),
    ("detector layer3 tail", (32, 23, 40, 1024), 1024, 256, ("id", "id", "id")),
    ("detector layer3 last", (32, 23, 40, 1024), 1024, 256, ("id",)),
    ("emotion layer1", (256, 55, 55, 64), 256, 64, ("ds", "id", "id")),
    ("emotion layer2", (256, 55, 55, 256), 512, 128, ("s2pre", "id", "id")),
    ("emotion layer2 last", (256, 28, 28, 512), 512, 128, ("id",)),
    ("emotion layer3", (256, 28, 28, 512), 1024, 256, ("s2pre", "id", "id")),
    ("emotion layer3 tail", (256, 14, 14, 1024), 1024, 256, ("id", "id", "id")),
    ("emotion layer4 tail", (256, 7, 7, 2048), 2048, 512, ("id",)),
]


KEYS = ("nwork", "cluster", "grid", "max_active_clusters", "blocks_per_sm")


def weights(torch, gen, cin: int, cout: int, planes: int, kinds, quant: bool):
    """Flat (w, inv, shift) per conv (int8: (wq, mult, shift)) and act_s."""
    dev = "cuda"
    folded, scales = [], []

    def conv(shape):
        ci, co = shape[-2], shape[-1]
        if quant:
            w = torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=torch.int8)
            mult = torch.rand((1, co), generator=gen, device=dev) * 2e-4
            scales.append(0.05)
        else:
            w = (torch.randn(shape, generator=gen, device=dev) / (ci * (9 if len(shape) == 4 else 1))
                 ** 0.5).bfloat16()
            mult = (torch.rand((1, co), generator=gen, device=dev) + 0.5).bfloat16()
        shift = torch.randn((1, co), generator=gen, device=dev) * 0.1
        folded.extend([w, mult, shift if quant else shift.bfloat16()])

    for kind in kinds:
        conv((cin, planes))
        conv((3, 3, planes, planes))
        conv((planes, cout))
        if kind != "id":
            conv((cin, cout))
        cin = cout
    act_s = torch.tensor(scales, device=dev) if quant else None
    return folded, act_s


def median_ms(torch, fn, runs: int = 50, warmup: int = 5) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return (times[runs // 2 - 1] + times[runs // 2]) / 2


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    help="checkout whose avcer_tpu_torch is timed (default: this one)")
    ap.add_argument("--label", default="", help="name of the version in the output")
    ap.add_argument("--out", default="", help="also write the JSON object here")
    ap.add_argument("--sweep", action="store_true",
                    help="also time every call at each cluster size C = 1 to 4, forced through "
                         "the wrapper's private launch path")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        print("bench_chain: needs an NVIDIA GPU (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    from avcer_tpu_torch.ops.cuda import fused_resnet_kernel as frk

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for label, shape, cout, planes, kinds in CALLS:
        x = torch.randn(shape, generator=gen, device="cuda").relu().bfloat16()
        for quant in (False, True):
            folded, act_s = weights(torch, gen, shape[-1], cout, planes, kinds, quant)

            def call():
                return frk.fused_chain(x, folded, kinds, act_s=act_s)

            out = call()
            if not bool(torch.isfinite(out.float()).all()):
                raise AssertionError(f"bench_chain: {label} gave non-finite values")
            row = {"call": label, "shape": list(shape), "kinds": list(kinds),
                   "mode": "int8" if quant else "bf16", "ms": median_ms(torch, call)}
            b, h, w, cin = shape
            plan = frk.chain_plan(b, h, w, cout, planes, kinds, 2, sms,
                                  q_cin=cin if quant else 0)
            row.update({k: plan[k] for k in ("nwork", "cluster", "grid") if k in plan})
            if hasattr(frk, "chain_occupancy"):  # what the card holds of this launch
                occ = frk.chain_occupancy(x.device, x.dtype, quant, plan["cluster"])
                row.update(max_active_clusters=occ["clusters"], blocks_per_sm=occ["blocks_per_sm"])
            rows.append(row)
            print(f"{args.label} {label} {row['mode']}: {row['ms']:.3f} ms "
                  f"({', '.join(f'{k} {row[k]}' for k in KEYS if k in row)})",
                  flush=True)
            if args.sweep:
                row["sweep"] = {}
                for c in range(1, frk.MAX_CLUSTER + 1):
                    forced = frk.chain_plan(b, h, w, cout, planes, kinds, 2, sms,
                                            q_cin=cin if quant else 0, cluster=c)
                    occ = frk.chain_occupancy(x.device, x.dtype, quant, c)
                    ms = median_ms(torch, lambda: frk._fused_chain_cuda(x, folded, kinds, act_s,
                                                                        cluster=c))
                    row["sweep"][c] = {"ms": ms, "grid": forced["grid"],
                                       "max_active_clusters": occ["clusters"]}
                    print(f"  C = {c}: {ms:.3f} ms (grid {forced['grid']}, the card holds "
                          f"{occ['clusters']} clusters)", flush=True)
    result = {"label": args.label, "root": os.path.abspath(args.root), "card": card,
              "calls": rows}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
