"""The dynamic model of ElenaRyumina/AVCER: stacked LSTM layers of the
widths ``hidden`` over windows of ``input_size`` features, then fc to
``num_classes`` on the last step."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from perfbench.reference.models import Ctx, linear

PROGRAM_CLASS = "TemporalLSTM"


def example(shape: dict, device) -> torch.Tensor:
    return torch.zeros(1, 10, shape["input_size"], device=device)


def _lstm(ctx: Ctx, name: str, x: torch.Tensor, hidden: int) -> torch.Tensor:
    """One LSTM layer over [B, T, in], gates (i, f, g, o) as torch orders them."""
    w_ih = ctx.p(name + ".weight_ih_l0", (4 * hidden, x.shape[-1]), "kernel", x)
    w_hh = ctx.p(name + ".weight_hh_l0", (4 * hidden, hidden), "kernel", x)
    b_ih = ctx.p(name + ".bias_ih_l0", (4 * hidden,), "bias", x)
    b_hh = ctx.p(name + ".bias_hh_l0", (4 * hidden,), "bias", x)
    b, t = x.shape[0], x.shape[1]
    h = x.new_zeros(b, hidden)
    c = x.new_zeros(b, hidden)
    xs = F.linear(x, w_ih, b_ih)
    outs = []
    for step in range(t):
        i, f, g, o = (xs[:, step] + F.linear(h, w_hh, b_hh)).chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        outs.append(h)
    return torch.stack(outs, dim=1)


def forward(ctx: Ctx, x: torch.Tensor, shape: dict, quant: bool = False) -> torch.Tensor:
    """Feature windows [S, T, input_size] -> logits [S, num_classes] of the
    last step (never quantised)."""
    for i, hidden in enumerate(shape["hidden"]):
        x = _lstm(ctx, f"lstm{i + 1}", x, hidden)
    return linear(ctx, "fc", x[:, -1], shape["num_classes"])
