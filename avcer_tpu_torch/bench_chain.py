"""Times ``fused_chain`` (K3) at every call the r50 main paths make, in bf16
and in the int8 mode, or with ``--kernel ssh`` ``fused_ssh_heads`` (K4) at the
twelve calls of the main paths, with ``--kernel flat`` ``fused_chain_flat`` (K5)
beside ``fused_chain`` at the seven stride-1 chains of the main paths (bf16)
and the three small f32 cases of the JAX package's test of its flat kernel,
or with ``--kernel nms`` ``nms_mask`` (K1) at the main paths' detect batches,
on one NVIDIA GPU:

    python3 avcer_tpu_torch/bench_chain.py [--kernel chain|ssh|flat|nms] [--root DIR]
        [--label NAME] [--out FILE] [--sweep]

``--root`` takes ``avcer_tpu_torch`` from another checkout (an unpacked
parent commit), so that two versions of a kernel are timed by the same
script in one session; run them in turns (parent, change, change, parent).
Weights and inputs are random from a fixed seed at the models' widths; the
time of a call does not depend on their values. Each time is the median of
50 calls after 5 warm-ups, with CUDA events. Prints one JSON object (also
written to ``--out``): the card's name and power limit, and per call its
shape, the plan's work items, cluster size and grid, and what the card
reports it holds of that launch (clusters at once, blocks an SM), where the
version has them, and ms. Every call also carries the SHA-256 of its
outputs from the seeded inputs: two versions that compute alike give equal
hashes (K5's must equal K3's, ``same_as_chain``; K3's int8 sums are exact, so
its int8 hashes do not depend on the product that took them, nor do K4's).
K3's and K4's int8 calls hand the kernel its packed weights
(``pack_chain_q``, made before the timing, as the models make them once per
fold) where the version takes them. K1's calls also carry
``device_ms``, the kernel's own time in a ``torch.profiler`` trace of 50
calls, beside ``ms`` a call (host work of the wrapper included). ``--sweep``
also times every call at each cluster size C = 1 to 4, forced through the
wrapper's private launch path (K5's also at every band height of at most
32 rows).
"""

from __future__ import annotations

import argparse
import hashlib
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


#: (label, input shape, feature channels C, with the merge, leaky slope,
#: modes): the r50 detector's three scales in the fused order (scale 3 emits
#: its lateral, scale 2 its merged feature; scales 2 and 1 add ``up``) at its
#: detect batch of 32, bf16 and int8, and the mobilenet0.25 detector's at
#: C = 64 with leaky ReLU 0.1, int8, batch 128 at the 640 bucket and 64 at
#: the 448 bucket (the modes that ``parity --fused``, ``int8 --fused``,
#: ``fast --fused`` and ``max --fused`` / ``turbo --fused`` launch)
SSH_CALLS = [
    ("r50 scale 3", (32, 12, 20, 2048), 256, False, 0.0, ("bf16", "int8")),
    ("r50 scale 2", (32, 23, 40, 1024), 256, True, 0.0, ("bf16", "int8")),
    ("r50 scale 1", (32, 45, 80, 512), 256, True, 0.0, ("bf16", "int8")),
    ("mobilenet scale 3", (128, 12, 20, 256), 64, False, 0.1, ("int8",)),
    ("mobilenet scale 2", (128, 23, 40, 128), 64, True, 0.1, ("int8",)),
    ("mobilenet scale 1", (128, 45, 80, 64), 64, True, 0.1, ("int8",)),
    ("mobilenet 448 scale 3", (64, 8, 14, 256), 64, False, 0.1, ("int8",)),
    ("mobilenet 448 scale 2", (64, 16, 28, 128), 64, True, 0.1, ("int8",)),
    ("mobilenet 448 scale 1", (64, 32, 56, 64), 64, True, 0.1, ("int8",)),
]

#: the stride-1 chains of CALLS (K5's shapes) and the three cases of the JAX
#: package's test of its flat kernel, f32: (label, shape, cout, planes, kinds)
FLAT_CALLS = [c for c in CALLS if set(c[4]) <= {"ds", "id"}]
FLAT_F32 = [("jax test case 1", (2, 13, 17, 64), 64, 24, ("ds", "id", "id")),
            ("jax test case 2", (1, 37, 29, 128), 128, 24, ("id", "id")),
            ("jax test case 3", (1, 24, 16, 64), 64, 24, ("ds",))]
#: K1: (label, detect batch, candidates a frame)
NMS_CALLS = [("r50 detect batch", 32, 64), ("mobilenet detect batch", 128, 64),
             ("K = 1000", 2, 1000)]

KEYS = ("nwork", "cluster", "grid", "max_active_clusters", "blocks_per_sm", "th")


def weights(torch, gen, cin: int, cout: int, planes: int, kinds, quant: bool,
            dtype=None):
    """Flat (w, inv, shift) per conv (int8: (wq, mult, shift)) and act_s;
    exact weights in ``dtype`` (default bf16)."""
    dtype = dtype or torch.bfloat16
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
                 ** 0.5).to(dtype)
            mult = (torch.rand((1, co), generator=gen, device=dev) + 0.5).to(dtype)
        shift = torch.randn((1, co), generator=gen, device=dev) * 0.1
        folded.extend([w, mult, shift if quant else shift.to(dtype)])

    for kind in kinds:
        conv((cin, planes))
        conv((3, 3, planes, planes))
        conv((planes, cout))
        if kind != "id":
            conv((cin, cout))
        cin = cout
    act_s = torch.tensor(scales, device=dev) if quant else None
    return folded, act_s


def ssh_weights(torch, gen, ci: int, c: int, merge: bool, quant: bool):
    """Keyword arguments of one ``fused_ssh_heads`` call but ``x``, ``up``,
    ``leaky`` and ``emit_feature``: the lateral, the merge where present, the
    five SSH convs (int8: (wq, mult, shift) and act_s in that order) and the
    three heads (bf16)."""
    dev = "cuda"
    scales = []

    def conv(shape):
        co = shape[-1]
        fan_in = shape[-2] * (9 if len(shape) == 4 else 1)
        if quant:
            w = torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=torch.int8)
            mult = torch.rand((1, co), generator=gen, device=dev) * 2e-4
            scales.append(0.05)
        else:
            w = (torch.randn(shape, generator=gen, device=dev) / fan_in ** 0.5).bfloat16()
            mult = (torch.rand((1, co), generator=gen, device=dev) + 0.5).bfloat16()
        shift = torch.randn((1, co), generator=gen, device=dev) * 0.1
        return [w, mult, shift if quant else shift.bfloat16()]

    q = c // 4
    lat = conv((ci, c))
    mrg = conv((3, 3, c, c)) if merge else None
    convs = sum((conv(s) for s in ((3, 3, c, c // 2), (3, 3, c, q), (3, 3, q, q), (3, 3, q, q),
                                   (3, 3, q, q))), [])
    heads = []
    for n in (8, 4, 20):  # two anchors: box, class, landmarks
        heads += [(torch.randn((c, n), generator=gen, device=dev) / c ** 0.5).bfloat16(),
                  (torch.randn((n,), generator=gen, device=dev) * 0.1).bfloat16()]
    return dict(conv_folded=convs, head_folded=heads, fpn_lat=lat, fpn_merge=mrg,
                act_s=torch.tensor(scales, device=dev) if quant else None)


def digest(torch, outs) -> str:
    """SHA-256 of the outputs' bytes, in order."""
    h = hashlib.sha256()
    for o in outs:
        h.update(o.contiguous().view(-1).view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


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


def device_ms(torch, fn, path: str, runs: int = 50) -> float:
    """The kernels' own time a call: their durations in a ``torch.profiler``
    trace of ``runs`` calls (after 5 warm-ups), summed, over ``runs``."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    prof.export_chrome_trace(path)
    with open(path) as f:
        kernels = [e for e in json.load(f)["traceEvents"] if e.get("cat") == "kernel"]
    if not kernels:
        raise AssertionError("bench_chain: the profiler's trace holds no device kernel")
    return sum(float(e["dur"]) for e in kernels) / runs * 1e-3


def show(label: str, row: dict) -> None:
    print(f"{label} {row['call']} {row['mode']}: {row['ms']:.3f} ms "
          f"({', '.join(f'{k} {row[k]}' for k in KEYS if k in row)})"
          + (f" sha256 {row['sha256'][:16]}" if "sha256" in row else ""), flush=True)


def bench_chain(torch, args, sms: int, gen) -> list[dict]:
    from avcer_tpu_torch.ops.cuda import fused_resnet_kernel as frk

    rows = []
    for label, shape, cout, planes, kinds in CALLS:
        x = torch.randn(shape, generator=gen, device="cuda").relu().bfloat16()
        for quant in (False, True):
            folded, act_s = weights(torch, gen, shape[-1], cout, planes, kinds, quant)
            # a version with the packed int8 layout takes the copy a model keeps
            packed = ({"packed": frk.pack_chain_q(folded)}
                      if quant and hasattr(frk, "pack_chain_q") else {})

            def call():
                return frk.fused_chain(x, folded, kinds, act_s=act_s, **packed)

            out = call()
            if not bool(torch.isfinite(out.float()).all()):
                raise AssertionError(f"bench_chain: {label} gave non-finite values")
            row = {"call": label, "shape": list(shape), "kinds": list(kinds),
                   "mode": "int8" if quant else "bf16", "ms": median_ms(torch, call),
                   "sha256": digest(torch, [out])}
            b, h, w, cin = shape
            plan = frk.chain_plan(b, h, w, cout, planes, kinds, 2, sms,
                                  q_cin=cin if quant else 0)
            row.update({k: plan[k] for k in ("nwork", "cluster", "grid") if k in plan})
            if hasattr(frk, "chain_occupancy"):  # what the card holds of this launch
                occ = frk.chain_occupancy(x.device, x.dtype, quant, plan["cluster"])
                row.update(max_active_clusters=occ["clusters"], blocks_per_sm=occ["blocks_per_sm"])
            rows.append(row)
            show(args.label, row)
            if args.sweep:
                row["sweep"] = {}
                for c in range(1, frk.MAX_CLUSTER + 1):
                    forced = frk.chain_plan(b, h, w, cout, planes, kinds, 2, sms,
                                            q_cin=cin if quant else 0, cluster=c)
                    occ = frk.chain_occupancy(x.device, x.dtype, quant, c)
                    ms = median_ms(torch, lambda: frk._fused_chain_cuda(x, folded, kinds, act_s,
                                                                        cluster=c, **packed))
                    row["sweep"][c] = {"ms": ms, "grid": forced["grid"],
                                       "max_active_clusters": occ["clusters"]}
                    print(f"  C = {c}: {ms:.3f} ms (grid {forced['grid']}, the card holds "
                          f"{occ['clusters']} clusters)", flush=True)
    return rows


def bench_ssh(torch, args, sms: int, gen) -> list[dict]:
    import inspect

    from avcer_tpu_torch.ops.cuda import fused_resnet_kernel as frk
    from avcer_tpu_torch.ops.cuda import fused_ssh_kernel as fsk

    takes_packed = "packed" in inspect.signature(fsk.fused_ssh_heads).parameters
    rows = []
    for label, shape, c, merge, leaky, modes in SSH_CALLS:
        x = torch.randn(shape, generator=gen, device="cuda").relu().bfloat16()
        up = (torch.randn(shape[:3] + (c,), generator=gen, device="cuda").relu().bfloat16()
              if merge else None)
        emit = label.split()[-1] != "1"
        for mode in modes:
            quant = mode == "int8"
            kw = ssh_weights(torch, gen, shape[-1], c, merge, quant)
            kw.update(leaky=leaky, up=up, emit_feature=emit)
            if quant and takes_packed:  # the copy a model keeps
                kw["packed"] = frk.pack_chain_q(
                    kw["fpn_lat"] + (kw["fpn_merge"] or []) + kw["conv_folded"])

            def call(**force):
                if force:
                    return fsk._fused_ssh_cuda(x, **kw, **force)
                return fsk.fused_ssh_heads(x, **kw)

            outs = call()
            if not all(bool(torch.isfinite(o.float()).all()) for o in outs):
                raise AssertionError(f"bench_chain: {label} {mode} gave non-finite values")
            row = {"call": label, "shape": list(shape), "c": c, "mode": mode,
                   "ms": median_ms(torch, call), "sha256": digest(torch, outs)}
            if hasattr(fsk, "card_plan"):  # the plan from what the card holds
                plan = fsk.card_plan(x, c, merge, quant)
                occ = fsk.ssh_occupancy(x.device, x.dtype, quant, plan["cluster"])
                row["blocks_per_sm"] = occ["blocks_per_sm"]
            else:  # a version before the cluster plan: one block a work item
                b, h, w, ci = shape
                plan = fsk.ssh_plan(b, h, w, c, merge, 2, sms, q_ci=ci if quant else 0)
            row.update({k: plan[k] for k in ("nwork", "cluster", "grid", "max_active_clusters")
                        if k in plan})
            rows.append(row)
            show(args.label, row)
            if args.sweep and hasattr(fsk, "_fused_ssh_cuda"):
                row["sweep"] = {}
                for n in range(1, fsk.MAX_CLUSTER + 1):
                    forced = fsk.card_plan(x, c, merge, quant, cluster=n)
                    ms = median_ms(torch, lambda: call(cluster=n))
                    same = digest(torch, call(cluster=n)) == row["sha256"]
                    row["sweep"][n] = {"ms": ms, "grid": forced["grid"], "same": same,
                                       "max_active_clusters": forced["max_active_clusters"]}
                    print(f"  C = {n}: {ms:.3f} ms (grid {forced['grid']}, the card holds "
                          f"{forced['max_active_clusters']} clusters; outputs equal to the "
                          f"plan's: {same})", flush=True)
    return rows


def bench_flat(torch, args, sms: int, gen) -> list[dict]:
    from avcer_tpu_torch.ops.cuda import fused_resnet_kernel as frk

    rows = []
    for label, shape, cout, planes, kinds in FLAT_CALLS + FLAT_F32:
        dtype = torch.float32 if label.startswith("jax") else torch.bfloat16
        x = torch.randn(shape, generator=gen, device="cuda").relu().to(dtype)
        folded, _ = weights(torch, gen, shape[-1], cout, planes, kinds, False, dtype)

        def call(**force):
            if force:
                return frk._fused_chain_flat_cuda(x, folded, kinds, **force)
            return frk.fused_chain_flat(x, folded, kinds)

        out = call()
        if not bool(torch.isfinite(out.float()).all()):
            raise AssertionError(f"bench_chain: {label} gave non-finite values")
        sha = digest(torch, [out])
        row = {"call": label, "shape": list(shape), "kinds": list(kinds),
               "mode": "f32" if dtype == torch.float32 else "bf16", "ms": median_ms(torch, call),
               "sha256": sha,
               "same_as_chain": sha == digest(torch, [frk.fused_chain(x, folded, kinds)]),
               "chain_ms": median_ms(torch, lambda: frk.fused_chain(x, folded, kinds))}
        if hasattr(frk, "flat_card_plan"):  # the plan from what the card holds
            plan = frk.flat_card_plan(x, folded, kinds)
            row.update({k: plan[k] for k in KEYS if k in plan})
        rows.append(row)
        show(args.label, row)
        print(f"  fused_chain {row['chain_ms']:.3f} ms; equal to it: {row['same_as_chain']}",
              flush=True)
        if args.sweep and hasattr(frk, "flat_card_plan"):
            row["sweep"] = {}
            # every band height of at most 32 rows down to 4 x 264 bands a call
            for th in frk.band_heights(shape[1], 32):
                if shape[0] * -(-shape[1] // th) > 4 * 264:
                    continue
                for c in range(1, frk.MAX_CLUSTER + 1):
                    ms = median_ms(torch, lambda: call(cluster=c, th=th), runs=20, warmup=2)
                    same = digest(torch, [call(cluster=c, th=th)]) == sha
                    row["sweep"][f"th {th} C {c}"] = {"ms": ms, "same": same}
                    print(f"  th {th}, C = {c}: {ms:.3f} ms (outputs equal to the plan's: "
                          f"{same})", flush=True)
    return rows


def bench_nms(torch, args, sms: int, gen) -> list[dict]:
    import numpy as np
    from avcer_tpu_torch.ops.cuda import nms_kernel

    rows = []
    for label, b, k in NMS_CALLS:
        # boxes as chip_smoke.py's nms_case makes them (seeded numpy)
        rng = np.random.default_rng(k)
        cx, cy = (rng.uniform(0, 200, (b, k)).astype(np.float32) for _ in range(2))
        w, h = (rng.uniform(5, 80, (b, k)).astype(np.float32) for _ in range(2))
        boxes = torch.from_numpy(np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                                          axis=-1)).cuda()
        valid = torch.from_numpy(-np.sort(-rng.random((b, k)).astype(np.float32), axis=1)
                                 > 0.3).cuda()

        def call():
            return nms_kernel.nms_mask(boxes, valid, 0.4)

        keep = call()
        plain = nms_kernel.nms_mask_plain(boxes, valid, 0.4)
        row = {"call": label, "shape": [b, k, 4], "mode": "f32", "ms": median_ms(torch, call),
               "device_ms": device_ms(torch, call, os.path.join(
                   args.trace_dir, f"nms_{b}_{k}_{args.label or 'tree'}.json")),
               "sha256": digest(torch, [keep]), "same_as_plain": bool(torch.equal(keep, plain))}
        rows.append(row)
        show(args.label, row)
        print(f"  device time {row['device_ms']:.4f} ms; equal to plain: {row['same_as_plain']}",
              flush=True)
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", choices=("chain", "ssh", "flat", "nms"), default="chain",
                    help="chain: K3 fused_chain (default); ssh: K4 fused_ssh_heads; flat: K5 "
                         "fused_chain_flat beside K3; nms: K1 nms_mask")
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    help="checkout whose avcer_tpu_torch is timed (default: this one)")
    ap.add_argument("--label", default="", help="name of the version in the output")
    ap.add_argument("--out", default="", help="also write the JSON object here")
    ap.add_argument("--sweep", action="store_true",
                    help="also time every call at each cluster size C = 1 to 4 (with --kernel "
                         "flat at every band height too), forced through the wrapper's private "
                         "launch path")
    args = ap.parse_args()
    args.trace_dir = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                  "build", "bench_traces")
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        print("bench_chain: needs an NVIDIA GPU (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(0)
    bench = {"chain": bench_chain, "ssh": bench_ssh, "flat": bench_flat, "nms": bench_nms}
    rows = bench[args.kernel](torch, args, sms, gen)
    result = {"label": args.label, "kernel": args.kernel, "root": os.path.abspath(args.root),
              "card": card, "calls": rows}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
