"""Learning-rate schedule and optimizer (avcer_tpu/train/schedules.py).

CosineAnnealingWarmRestarts stepped per batch at the fractional epoch
``step / iters_per_epoch``, as the JAX package's optax schedule. The
schedule is evaluated at the optimizer's update count, which is 0 before the
first update, as optax's ``count``:

    t_mult == 1:  T_cur = frac_epoch % T_0,  T_i = T_0
    t_mult > 1:   n = floor(log(frac / T_0 * (t_mult - 1) + 1) / log(t_mult)),
                  T_cur = frac - T_0 (t_mult^n - 1) / (t_mult - 1),  T_i = T_0 t_mult^n
    lr = eta_min + (base_lr - eta_min) (1 + cos(pi T_cur / T_i)) / 2

``make_optimizer`` gives ``torch.optim.Adam`` (``AdamW`` when
``weight_decay > 0``, decoupled as optax's ``adamw``; both at optax's betas
and eps) in a ``ScheduledOptimizer`` that sets every group's lr to
``schedule(count)`` before each step.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable

import torch

Schedule = Callable[[int], float]


def cosine_warm_restarts(base_lr: float, t0: int, iters_per_epoch: int, t_mult: int = 1,
                         eta_min: float = 0.0) -> Schedule:
    def schedule(step: int) -> float:
        frac_epoch = step / iters_per_epoch
        if t_mult == 1:
            t_cur = math.fmod(frac_epoch, t0)
            t_i = t0
        else:
            n = math.floor(math.log(frac_epoch / t0 * (t_mult - 1) + 1) / math.log(t_mult))
            start = t0 * (t_mult ** n - 1) / (t_mult - 1)
            t_i = t0 * t_mult ** n
            t_cur = frac_epoch - start
        return eta_min + (base_lr - eta_min) * (1 + math.cos(math.pi * t_cur / t_i)) / 2

    return schedule


class ScheduledOptimizer:
    """A torch optimizer whose lr follows ``schedule`` at the update count."""

    def __init__(self, optimizer: torch.optim.Optimizer, schedule: Schedule):
        self.optimizer = optimizer
        self.schedule = schedule
        self.count = 0

    def zero_grad(self) -> None:
        self.optimizer.zero_grad(set_to_none=True)

    def step(self) -> float:
        """One update at ``schedule(count)``; returns that lr."""
        lr = self.schedule(self.count)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        self.count += 1
        return lr

    def state_dict(self) -> dict:
        return {"optimizer": self.optimizer.state_dict(), "count": self.count}

    def load_state_dict(self, state: dict) -> None:
        self.optimizer.load_state_dict(state["optimizer"])
        self.count = int(state["count"])


def make_optimizer(params: Iterable[torch.nn.Parameter], lr: float, t0: int,
                   iters_per_epoch: int, t_mult: int = 1, eta_min: float = 0.0,
                   weight_decay: float = 0.0) -> ScheduledOptimizer:
    """Adam(lr) + warm-restart cosine (the reference's train_c_audio.py)."""
    sched = cosine_warm_restarts(lr, t0, iters_per_epoch, t_mult, eta_min)
    params = list(params)
    if weight_decay > 0:
        opt = torch.optim.AdamW(params, lr=sched(0), betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=weight_decay)
    else:
        opt = torch.optim.Adam(params, lr=sched(0), betas=(0.9, 0.999), eps=1e-8)
    return ScheduledOptimizer(opt, sched)
