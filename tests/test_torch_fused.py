"""The fused path of avcer_tpu_torch against the JAX package on the CPU: the
plain versions of the two fused kernels against the Pallas kernels in
interpret mode, the BatchNorm fold, the fused models against the unfused
port and against the JAX models under the same switches, the clip run with
the visual switches on, and the wrappers' dispatch rules.

Inputs and weights come from numpy generators and go to both sides."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from avcer_tpu.core.checkpoint import init_variables
from avcer_tpu.models.emotion_resnet import EmotionResNet50 as JaxEmotionResNet50
from avcer_tpu.models.retinaface import RetinaFace as JaxRetinaFace
from avcer_tpu.models.retinaface import TVBottleneckFolded, _ConvBNFolded
from avcer_tpu.ops.pallas.fused_resnet_kernel import fused_chain as jax_fused_chain
from avcer_tpu.ops.pallas.fused_ssh_kernel import fused_ssh_heads as jax_fused_ssh_heads

import avcer_tpu_torch.cli.run as cli
from avcer_tpu_torch.core import convert
from avcer_tpu_torch.models.emotion_resnet import EmotionResNet50
from avcer_tpu_torch.models.layers import fold_bn
from avcer_tpu_torch.models.retinaface import RetinaFace
from avcer_tpu_torch.ops.cuda import fused_resnet_kernel as frk
from avcer_tpu_torch.ops.cuda import fused_ssh_kernel as fsk

from test_torch_models import port, randomize_stats
from torch_fused_cases import chain_weights, ssh_weights, tensors

torch.set_num_threads(2)


# An "id" first block needs 128 input channels on the JAX side: its wrapper
# pads the input channels to the TPU's lane width and cannot pad an identity.
CHAINS = [(("ds", "id", "id"), 16, 8), (("id", "id"), 128, 32), (("s2ds", "id"), 32, 8),
          (("s2pre", "id", "id"), 32, 8), (("id",), 128, 32)]


@pytest.mark.parametrize("hw", [(24, 16), (23, 17)])
@pytest.mark.parametrize("blocks,cin,planes", CHAINS)
def test_fused_chain_plain_matches_jax(blocks, cin, planes, hw):
    rng = np.random.default_rng(11)
    x = rng.normal(size=(2, *hw, cin)).astype(np.float32)
    folded = chain_weights(rng, cin, planes, blocks)
    want = jax_fused_chain(jnp.asarray(x), tuple(jnp.asarray(a) for a in folded), blocks,
                           interpret=True, band=8)
    got = frk.fused_chain(torch.from_numpy(x), tensors(folded), blocks)
    assert tuple(got.shape) == want.shape
    # f32 on both sides: only the order of the f32 sums differs
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=1e-4)


def test_fused_chain_plain_matches_jax_bf16():
    """bf16 operands on both sides, the same rounding points: a sum that
    lands on a rounding boundary may fall to either side after another
    summation order, one bf16 ulp (2**-8 relative) per conv, and three
    blocks carry that through nine convs; measured 1 ulp at most."""
    blocks, cin, planes = ("ds", "id", "id"), 16, 8
    rng = np.random.default_rng(12)
    x = jnp.asarray(rng.normal(size=(2, 24, 16, cin)).astype(np.float32), jnp.bfloat16)
    folded = chain_weights(rng, cin, planes, blocks)
    want = jax_fused_chain(x, tuple(jnp.asarray(a, jnp.bfloat16) for a in folded), blocks,
                           interpret=True, band=8)
    got = frk.fused_chain(torch.from_numpy(np.array(x.astype(jnp.float32))).bfloat16(),
                          tensors(folded, torch.bfloat16), blocks)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               atol=2 ** -6, rtol=2 ** -6)


# name, ci, C, leaky, lateral, merge, up, emit_feature
SSH_CASES = [("ssh_heads", 32, 32, 0.0, False, False, False, False),
             ("lateral_emit", 48, 32, 0.0, True, False, False, True),
             ("lateral_up_merge_emit", 48, 32, 0.0, True, True, True, True),
             ("lateral_up_merge", 24, 32, 0.0, True, True, True, False),
             ("leaky_c64", 64, 64, 0.1, False, False, False, False),
             ("leaky_c64_fpn", 32, 64, 0.1, True, True, True, True)]


@pytest.mark.parametrize("name,ci,c,leaky,lat,merge,has_up,emit", SSH_CASES)
def test_fused_ssh_heads_plain_matches_jax(name, ci, c, leaky, lat, merge, has_up, emit):
    rng = np.random.default_rng(13)
    x = rng.normal(size=(2, 13, 11, ci)).astype(np.float32)
    up = rng.normal(size=(2, 13, 11, c)).astype(np.float32) if has_up else None
    convs, heads, fl, fm = ssh_weights(rng, ci, c, lat, merge)

    def j(arrays):
        return None if arrays is None else tuple(jnp.asarray(a) for a in arrays)

    want = jax_fused_ssh_heads(jnp.asarray(x), j(convs), j(heads), leaky=leaky, interpret=True,
                               band=8, fpn_lat=j(fl), fpn_merge=j(fm),
                               up=None if up is None else jnp.asarray(up), emit_feature=emit)
    got = fsk.fused_ssh_heads(
        torch.from_numpy(x), tensors(convs), tensors(heads), leaky,
        fpn_lat=tensors(fl), fpn_merge=tensors(fm),
        up=None if up is None else torch.from_numpy(up), emit_feature=emit)
    assert len(got) == len(want) == 3 + emit
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5, rtol=1e-4)


@pytest.fixture(scope="module")
def retinaface_weights():
    variables = randomize_stats(init_variables(
        JaxRetinaFace(backbone="resnet50"), (jnp.zeros((1, 64, 64, 3)),), seed=1), 1)
    x = (np.random.default_rng(0).normal(size=(1, 64, 48, 3)) * 20).astype(np.float32)
    base = port(RetinaFace(), convert.retinaface(variables))
    with torch.no_grad():
        unfused = base(torch.from_numpy(x))
    return variables, x, unfused


def test_fold_bn_matches_jax_folds(retinaface_weights):
    """``fold_bn`` on the converted state dict against TVBottleneckFolded and
    _ConvBNFolded on the same tree. Weights are equal; inv and shift agree to
    a few f32 ulps (5e-7 at values around 1): XLA's and torch's rsqrt differ
    in the last bit on a third of the inputs."""
    variables, _, _ = retinaface_weights
    model = port(RetinaFace(), convert.retinaface(variables))

    def sub(path):
        out = {}
        for kind, tree in variables.items():
            for part in path.split("/"):
                tree = tree.get(part, {})
            out[kind] = tree
        return out

    want = TVBottleneckFolded(64, downsample=True).apply(sub("body/layer1_0"), 64)
    got = model.body.layer1[0].folded(torch.float32)
    assert len(got) == 12
    for g, w in zip(got, [t for triple in want for t in triple]):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=5e-7, rtol=0)
    for path, conv_bn, k, cin in (("ssh2/conv5X5_1", model.ssh2.conv5X5_1, 3, 256),
                                  ("fpn/output3", model.fpn.output3, 1, 2048)):
        want = _ConvBNFolded(conv_bn[0].out_channels, kernel=k).apply(sub(path), cin)
        got = fold_bn(conv_bn[0].weight, conv_bn[1], torch.float32)
        for g, w in zip(got, want):
            assert tuple(g.shape) == w.shape
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=5e-7, rtol=0)


class CallCount:
    """Counts calls of a wrapper's plain version: the fused sections run."""

    def __init__(self, monkeypatch, module, name):
        self.n = 0
        inner = getattr(module, name)

        def counted(*args, **kwargs):
            self.n += 1
            return inner(*args, **kwargs)

        monkeypatch.setattr(module, name, counted)


# switches, fused_chain calls, fused_ssh_heads calls, (atol, rtol) against the
# unfused port: the bounds of test_fused_entries_match_xla for the body's
# switches and of test_fused_ssh_heads_match_xla for the heads'
RETINAFACE_SWITCHES = [
    (dict(fused_layer1=True), 1, 0, (2e-4, 1e-3)),
    (dict(fused_layer1=True, fused_tails=True), 4, 0, (2e-4, 1e-3)),
    (dict(fused_layer1=True, fused_tails=True, fused_entries=True), 5, 0, (2e-4, 1e-3)),
    (dict(fused_ssh=True), 0, 3, (2e-5, 1e-4)),
    (dict(fused_ssh=True, fused_fpn=True), 0, 3, (2e-5, 1e-4)),
]


@pytest.mark.parametrize("switches,n_chain,n_ssh,tol", RETINAFACE_SWITCHES)
def test_retinaface_fused_matches_unfused_and_jax(retinaface_weights, monkeypatch, switches,
                                                  n_chain, n_ssh, tol):
    variables, x, unfused = retinaface_weights
    chains = CallCount(monkeypatch, frk, "fused_chain_plain")
    sshs = CallCount(monkeypatch, fsk, "fused_ssh_heads_plain")
    model = port(RetinaFace(**switches), convert.retinaface(variables))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
        again = model(torch.from_numpy(x))  # the kept folds give the same result
    assert (chains.n, sshs.n) == (2 * n_chain, 2 * n_ssh)
    for g, a, u in zip(got, again, unfused):
        assert torch.equal(g, a)
        np.testing.assert_allclose(g.numpy(), u.numpy(), atol=tol[0], rtol=tol[1])
    want = JaxRetinaFace(backbone="resnet50", **switches).apply(variables, jnp.asarray(x))
    # the bounds of test_retinaface_matches_jax (conv sums in another order)
    for g, w, atol in zip(got, want, (1e-3, 1e-4, 1e-3)):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=atol, rtol=1e-2)


@pytest.mark.parametrize("switches,n_chain", [(dict(fused=True), 6),
                                              (dict(fused=True, fused_entries=True), 7)])
def test_emotion_resnet50_fused_matches_unfused_and_jax(monkeypatch, switches, n_chain):
    variables = randomize_stats(init_variables(
        JaxEmotionResNet50(num_classes=7), (jnp.zeros((1, 64, 64, 3)),), seed=2), 2)
    x = (np.random.default_rng(1).normal(size=(2, 64, 48, 3)) * 50).astype(np.float32)
    chains = CallCount(monkeypatch, frk, "fused_chain_plain")
    state = convert.emotion_resnet50(variables)
    with torch.no_grad():
        unfused = port(EmotionResNet50(7), state)(torch.from_numpy(x))
        got = port(EmotionResNet50(7, **switches), state)(torch.from_numpy(x))
    assert chains.n == n_chain
    want = JaxEmotionResNet50(num_classes=7, **switches).apply(variables, jnp.asarray(x))
    # the bounds of test_fused_emotion_cnn_matches_xla on inputs scaled by 50
    for g, u, w in zip(got, unfused, want):
        np.testing.assert_allclose(g.numpy(), u.numpy(), atol=2e-3, rtol=1e-3)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-3, rtol=1e-3)


def test_fold_cache_dropped_on_load():
    """Loading other weights after a fused forward must not serve the old
    folds."""
    rng = np.random.default_rng(3)
    model = EmotionResNet50(7, fused=True).eval()
    x = torch.from_numpy(rng.normal(size=(1, 64, 48, 3)).astype(np.float32))
    with torch.no_grad():
        first = model(x)[0]
        state = {k: v * 0.5 if k.endswith("conv1.weight") else v
                 for k, v in model.state_dict().items()}
        model.load_state_dict(state)
        second = model(x)[0]
        want = port(EmotionResNet50(7), state)(x)[0]
    assert not torch.allclose(first, second)
    torch.testing.assert_close(second, want, atol=1e-5, rtol=1e-5)


def test_wrappers_cpu_takes_plain_and_counts_no_launch():
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(size=(1, 6, 5, 16)).astype(np.float32))
    folded = tensors(chain_weights(rng, 16, 8, ("ds",)))
    before = frk.fused_chain.launches, fsk.fused_ssh_heads.launches
    out = frk.fused_layer1(x, tensors(chain_weights(rng, 16, 8, ("ds", "id", "id"))))
    assert tuple(out.shape) == (1, 6, 5, 32)
    torch.testing.assert_close(frk.fused_chain(x, folded, ("ds",), band=4),
                               frk.fused_chain_plain(x, folded, ("ds",)))
    convs, heads, _, _ = ssh_weights(rng, 16, 16, False, False)
    lo, co, ld = fsk.fused_ssh_heads(x, tensors(convs), tensors(heads))
    assert (lo.shape[-1], co.shape[-1], ld.shape[-1]) == (8, 4, 20)
    assert (frk.fused_chain.launches, fsk.fused_ssh_heads.launches) == before


def test_wrappers_raise_on_what_is_not_ported():
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(1, 6, 5, 16)).astype(np.float32))
    folded = tensors(chain_weights(rng, 16, 8, ("ds",)))
    # the int8 mode wants one activation scale per conv
    with pytest.raises(ValueError, match="one scale per conv"):
        frk.fused_chain(x, folded, ("ds",), act_s=torch.ones(3))
    convs, heads, fl, fm = ssh_weights(rng, 16, 16, True, True)
    with pytest.raises(ValueError, match="one scale per conv"):
        fsk.fused_ssh_heads(x, tensors(convs), tensors(heads), act_s=torch.ones(6))
    # the flat kernel takes stride-1 chains only
    with pytest.raises(ValueError, match="stride-1 chains only"):
        frk.fused_chain_flat(x, folded, ("s2ds",))
    with pytest.raises(ValueError, match="fpn_merge requires fpn_lat"):
        fsk.fused_ssh_heads(x, tensors(convs), tensors(heads), fpn_merge=tensors(fm))
    # a stride-2 entry is the first block and is followed by "id" blocks only
    for blocks in (("id", "s2ds"), ("ds", "s2pre"), ("s2ds", "ds"), ("s2pre", "id", "ds")):
        with pytest.raises(ValueError, match="stride-2 entry"):
            frk.fused_chain(x, folded, blocks)
    with pytest.raises(ValueError):
        frk.fused_chain(x, folded, ("ds", "id"))  # too few weights


def test_chain_plan_geometry():
    """The tiling the wrapper hands to the kernel: tile edges, halo, frames
    per work item and scratch at the detector's and the emotion CNN's
    shapes."""
    p = frk.chain_plan(32, 90, 160, 256, 64, ("ds", "id", "id"), 2, 132)
    assert (p["ho"], p["wo"], p["th"], p["tw"], p["halo"], p["g"]) == (90, 160, 23, 23, 3, 1)
    assert p["nwork"] == 32 * 4 * 7 and p["grid"] == 264
    assert p["scratch_bytes"] == 264 * 2 * 29 * 29 * (256 + 64 + 64)
    p = frk.chain_plan(32, 45, 80, 1024, 256, ("s2ds", "id"), 2, 132)
    assert (p["ho"], p["wo"], p["th"], p["tw"], p["halo"]) == (23, 40, 23, 20, 1)
    p = frk.chain_plan(256, 7, 7, 2048, 512, ("id",), 2, 132)
    assert (p["th"], p["tw"], p["halo"], p["g"], p["nwork"]) == (7, 7, 1, 3, 86)
    # five work items on a card of 264 resident blocks: clusters of four
    p = frk.chain_plan(5, 55, 55, 512, 128, ("s2pre", "id", "id"), 4, 132)
    assert (p["ho"], p["wo"], p["th"], p["g"], p["nwork"], p["grid"]) == (28, 28, 28, 1, 5, 20)
    s = fsk.ssh_plan(32, 12, 20, 256, False, 2, HELD["measured"])
    assert (s["th"], s["tw"], s["halo"], s["nwork"]) == (12, 20, 3, 32)
    s = fsk.ssh_plan(32, 45, 80, 256, True, 2, HELD["measured"])
    assert (s["th"], s["tw"], s["halo"], s["nwork"]) == (23, 20, 4, 32 * 2 * 4)


# (input shape, cout, planes, blocks, expected C): every fused_chain call of
# the main paths (detector batch 32, emotion CNN batch 256) on 132 SMs
MAIN_PATH_CHAINS = [
    ((32, 90, 160, 64), 256, 64, ("ds", "id", "id"), 1),  # detector layer1
    ((32, 90, 160, 256), 512, 128, ("s2ds", "id", "id", "id"), 1),  # detector layer2
    ((32, 45, 80, 512), 1024, 256, ("s2ds", "id"), 4),  # detector layer3 entry
    ((32, 23, 40, 1024), 1024, 256, ("id", "id", "id"), 4),  # detector layer3 tail
    ((32, 23, 40, 1024), 1024, 256, ("id",), 4),  # detector layer3 last
    ((256, 55, 55, 64), 256, 64, ("ds", "id", "id"), 1),  # emotion layer1
    ((256, 55, 55, 256), 512, 128, ("s2pre", "id", "id"), 1),  # emotion layer2
    ((256, 28, 28, 512), 512, 128, ("id",), 1),  # emotion layer2 last
    ((256, 28, 28, 512), 1024, 256, ("s2pre", "id", "id"), 1),  # emotion layer3
    ((256, 14, 14, 1024), 1024, 256, ("id", "id", "id"), 1),  # emotion layer3 tail
    ((256, 7, 7, 2048), 2048, 512, ("id",), 3),  # emotion layer4 tail (two calls)
]


@pytest.mark.parametrize("shape,cout,planes,blocks,want_c", MAIN_PATH_CHAINS)
@pytest.mark.parametrize("itemsize,quant", [(2, False), (2, True), (4, False)])
def test_chain_plan_clusters(shape, cout, planes, blocks, want_c, itemsize, quant):
    """The cluster size C = clamp(264 // nwork, 1, 4) at the main paths'
    shapes: 4 for the detector's layer3, 3 for the emotion CNN's layer4, 1
    where the work items fill the card; the grid is whole clusters and at
    most two blocks an SM; the scratch holds one slab per cluster, so a
    cluster plan needs no more memory than the same call at C = 1."""
    b, h, w, cin = shape
    sms = 132
    q_cin = cin if quant else 0
    p = frk.chain_plan(b, h, w, cout, planes, blocks, itemsize, sms, q_cin=q_cin)
    assert p["cluster"] == want_c
    assert p["grid"] % p["cluster"] == 0 and p["grid"] <= 2 * sms
    assert p["grid"] == min(p["nwork"], 2 * sms // want_c) * want_c
    s2ds = blocks[0] == "s2ds"
    rh, rw = p["th"] + 2 * p["halo"], p["tw"] + 2 * p["halo"]
    rh1, rw1 = (2 * rh + 1, 2 * rw + 1) if s2ds else (rh, rw)
    slab = p["g"] * (rh * rw * cout + rh1 * rw1 * planes + rh * rw * planes) * itemsize
    qslab = p["g"] * rh1 * rw1 * max(cin, cout, planes) if quant else 0
    assert p["scratch_bytes"] == (slab + qslab) * (p["grid"] // want_c)
    one = frk.chain_plan(b, h, w, cout, planes, blocks, itemsize, sms, q_cin=q_cin, cluster=1)
    assert one["cluster"] == 1 and p["scratch_bytes"] <= one["scratch_bytes"]
    # the tiling does not depend on C
    assert all(p[k] == one[k] for k in ("ho", "wo", "th", "tw", "halo", "g", "nwork"))


def test_chain_plan_forced_cluster():
    """A forced C (the card tests' private launch path) keeps the grid whole
    clusters within the card's resident blocks."""
    for c in (1, 2, 3, 4):
        p = frk.chain_plan(4, 12, 20, 256, 64, ("id", "id", "id"), 2, 132, cluster=c)
        assert p["cluster"] == c and p["grid"] == p["nwork"] * c and p["nwork"] == 4
    p = frk.chain_plan(32, 90, 160, 64, 64, ("ds", "id", "id"), 2, 132, cluster=2)
    assert (p["grid"], p["scratch_bytes"] % 132) == (264, 0)


# What the card holds of the K4 kernel, clusters of C blocks at once: two
# blocks an SM on 132 SMs, with the cluster counts K3 measured at 112 KB a
# block (62 of 4, 79 of 3), and a card that holds more of them
HELD = {"measured": {1: 264, 2: 132, 3: 79, 4: 62}, "roomier": {1: 264, 2: 132, 3: 88, 4: 66}}

# (input shape, C, with the merge, int8, expected (C, grid) for each HELD):
# the nine fused_ssh_heads calls of the main paths: the r50 detector's three
# scales at its detect batch of 32, bf16 and int8, and the mobilenet0.25
# detector's at C = 64, batch 128, int8
MAIN_PATH_SSH = [
    ((32, 12, 20, 2048), 256, False, False, {"measured": (4, 128), "roomier": (4, 128)}),
    ((32, 23, 40, 1024), 256, True, False, {"measured": (3, 192), "roomier": (4, 256)}),
    ((32, 45, 80, 512), 256, True, False, {"measured": (1, 256), "roomier": (1, 256)}),
    ((32, 12, 20, 2048), 256, False, True, {"measured": (4, 128), "roomier": (4, 128)}),
    ((32, 23, 40, 1024), 256, True, True, {"measured": (3, 192), "roomier": (4, 256)}),
    ((32, 45, 80, 512), 256, True, True, {"measured": (1, 256), "roomier": (1, 256)}),
    ((128, 12, 20, 256), 64, False, True, {"measured": (2, 256), "roomier": (2, 256)}),
    ((128, 23, 40, 128), 64, True, True, {"measured": (1, 256), "roomier": (1, 256)}),
    ((128, 45, 80, 64), 64, True, True, {"measured": (1, 264), "roomier": (1, 264)}),
]


@pytest.mark.parametrize("held", sorted(HELD))
@pytest.mark.parametrize("shape,c,merge,quant,want", MAIN_PATH_SSH)
def test_ssh_plan_clusters(shape, c, merge, quant, want, held):
    """K4's cluster size is the C of 1 to 4 with the fewest rounds of work
    items a block, ceil(nwork / held[C]) / C, ties to the smaller C: scale 1
    of the r50 detector keeps one block a work item, scales 2 and 3 fill the
    card with at least 128 blocks in one round. The grid is whole clusters,
    at most what the card holds; the scratch holds one slab per cluster."""
    b, h, w, ci = shape
    p = fsk.ssh_plan(b, h, w, c, merge, 2, HELD[held], q_ci=ci if quant else 0)
    assert (p["cluster"], p["grid"]) == want[held]
    clusters = p["grid"] // p["cluster"]
    assert clusters == min(p["nwork"], HELD[held][p["cluster"]])
    assert -(-p["nwork"] // clusters) == 1 or p["cluster"] == 1
    rh, rw = p["th"] + 2 * p["halo"], p["tw"] + 2 * p["halo"]
    slab = p["g"] * rh * rw * (c * (3 if merge else 2) + c // 2) * 2
    qslab = p["g"] * rh * rw * max(ci, c) if quant else 0
    assert p["scratch_bytes"] == (slab + qslab) * clusters
    one = fsk.ssh_plan(b, h, w, c, merge, 2, HELD[held], q_ci=ci if quant else 0, cluster=1)
    assert one["cluster"] == 1 and p["scratch_bytes"] <= one["scratch_bytes"]
    # the tiling does not depend on C
    assert all(p[k] == one[k] for k in ("th", "tw", "halo", "g", "nwork"))


@pytest.mark.parametrize("merge", [False, True])
def test_ssh_plan_depths(merge):
    """Each conv of K4 covers only what the next step reads: the band shapes
    of the TPU kernel (avcer_tpu/ops/pallas/fused_ssh_kernel.py ``_kernel``:
    with n = 4 (merge) or 3 halo rows, the input band th + 2n, the merge's
    th + 6, c5_1 th + 4, c7_2 th + 2, c3, c5 and c7 th), here in both
    directions."""
    p = fsk.ssh_plan(32, 45, 80, 256, merge, 2, HELD["measured"])
    th, tw, n = p["th"], p["tw"], p["halo"]
    assert n == (4 if merge else 3)
    bands = {"lateral": th + 2 * n, "merge": th + 6, "c5_1": th + 4, "c7_2": th + 2,
             "c3": th, "c5": th, "c7": th}
    if not merge:
        del bands["merge"]
    assert set(p["depths"]) == set(bands)
    for conv, rows in bands.items():
        d = p["depths"][conv]
        assert th + 2 * (n - d) == rows, conv
        assert p["rows"][conv] == p["g"] * rows * (tw + 2 * (n - d)), conv
    # the multiply-adds of a call of the r50 detector's scale 1: 283 G over
    # whole regions, 216 G trimmed
    macs = {"lateral": 512 * 256, "merge": 9 * 256 * 256, "c3": 9 * 256 * 128,
            "c5_1": 9 * 256 * 64, "c5": 9 * 64 * 64, "c7_2": 9 * 64 * 64, "c7": 9 * 64 * 64}
    if merge:
        trimmed = sum(p["rows"][k] * macs[k] for k in bands) * p["nwork"]
        whole = p["rows"]["lateral"] * sum(macs.values()) * p["nwork"]
        assert (round(whole / 1e9), round(trimmed / 1e9)) == (283, 216)


# The seven stride-1 chains of the main paths that K5 takes: (input shape,
# cout, planes, blocks, expected (th, C, grid) for each table of what the
# card holds: K3's measured 264 / 132 / 79 / 62 clusters, and a card that
# holds one block an SM)
FLAT_HELD = {"measured": HELD["measured"], "one block an SM": {1: 132, 2: 66, 3: 44, 4: 33}}
MAIN_PATH_FLAT = [
    ((32, 90, 160, 64), 256, 64, ("ds", "id", "id"),
     {"measured": (23, 2, 256), "one block an SM": (30, 4, 132)}),
    ((32, 23, 40, 1024), 1024, 256, ("id", "id", "id"),
     {"measured": (12, 3, 192), "one block an SM": (23, 4, 128)}),
    ((32, 23, 40, 1024), 1024, 256, ("id",),
     {"measured": (6, 2, 256), "one block an SM": (23, 4, 128)}),
    ((256, 55, 55, 64), 256, 64, ("ds", "id", "id"),
     {"measured": (28, 1, 264), "one block an SM": (28, 1, 132)}),
    ((256, 28, 28, 512), 512, 128, ("id",),
     {"measured": (28, 1, 256), "one block an SM": (28, 1, 132)}),
    ((256, 14, 14, 1024), 1024, 256, ("id", "id", "id"),
     {"measured": (14, 1, 256), "one block an SM": (14, 1, 132)}),
    ((256, 7, 7, 2048), 2048, 512, ("id",),
     {"measured": (7, 1, 256), "one block an SM": (7, 1, 132)}),
]


@pytest.mark.parametrize("held", sorted(FLAT_HELD))
@pytest.mark.parametrize("shape,cout,planes,blocks,want", MAIN_PATH_FLAT)
def test_flat_plan_clusters(shape, cout, planes, blocks, want, held):
    """K5's plan: the pitch is the frame's width and n halo columns a side,
    no TPU rounding; th and C together give the fewest rounds x pixel tiles
    a block (on the measured card the detector's layer3 in bands of 12 and 6
    rows and clusters of 3 and 2, layer1 in bands of 23 rows, taller than
    the 12 of a fixed 3072-pixel band, in clusters of 2: the fastest (th, C)
    of a sweep of all of them on the card); the grid is whole clusters, at
    most what the card holds; the scratch one slab per cluster."""
    b, h, w, _ = shape
    n = len(blocks)
    p = frk.flat_plan(b, h, w, n, cout, planes, 2, FLAT_HELD[held])
    assert (p["th"], p["cluster"], p["grid"]) == want[held]
    assert p["pitch"] == w + 2 * n and p["rows"] == p["th"] + 2 * n
    assert p["th"] in frk.band_heights(h, 32) and p["nb"] == -(-h // p["th"])
    assert p["nwork"] == b * p["nb"]
    clusters = p["grid"] // p["cluster"]
    assert clusters == min(p["nwork"], FLAT_HELD[held][p["cluster"]])
    slab = p["rows"] * p["pitch"] * (cout + 2 * planes) * 2
    assert p["scratch_bytes"] == slab * clusters
    # forcing the plan's own th and C gives the plan; another C keeps the bands
    forced = frk.flat_plan(b, h, w, n, cout, planes, 2, FLAT_HELD[held],
                           cluster=p["cluster"], th=p["th"])
    assert forced == p
    one = frk.flat_plan(b, h, w, n, cout, planes, 2, FLAT_HELD[held], cluster=1, th=p["th"])
    assert (one["cluster"], one["nwork"], one["th"]) == (1, p["nwork"], p["th"])


def test_flat_band_heights():
    """The heights the plan chooses from cut the frame into equal bands but
    the last, at most ``band`` rows each."""
    assert frk.band_heights(90, 32)[:6] == [30, 23, 18, 15, 13, 12]
    assert frk.band_heights(23, 32) == [23, 12, 8, 6, 5, 4, 3, 2, 1]
    for h in (7, 23, 55, 90):
        for th in frk.band_heights(h, 32):
            nb = -(-h // th)
            assert th <= 32 and (nb - 1) * th < h <= nb * th and -(-h // nb) == th


def test_cli_fused_sets_all_seven_switches():
    cfg = cli.config_from_args(cli.parse_args(["--fused"]))
    d, v = cfg.detector, cfg.visual
    assert all((d.fused_layer1, d.fused_tails, d.fused_entries, d.fused_ssh, d.fused_fpn,
                v.fused, v.fused_entries))
    cfg = cli.config_from_args(cli.parse_args([]))
    d, v = cfg.detector, cfg.visual
    assert not any((d.fused_layer1, d.fused_tails, d.fused_entries, d.fused_ssh, d.fused_fpn,
                    v.fused, v.fused_entries))
