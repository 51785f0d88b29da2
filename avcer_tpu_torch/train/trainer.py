"""Training harness (avcer_tpu/train/trainer.py) in PyTorch, with the same
public names.

- ``Trainer.init_state``: the model's starting weights (given, or the seeded
  init of ``models.layers.seeded_init_``), the trainable set of
  ``default_trainable`` (every parameter outside wav2vec2 and the last
  ``unfreeze_last_n`` encoder layers; the others get ``requires_grad=False``
  and stay out of the optimizer, as optax's ``set_to_zero`` partition leaves
  them), and the optimizer of ``train.schedules.make_optimizer``.
- ``train_step``: the model in ``training`` (dropout, batch statistics),
  mixup at ``mixup_alpha`` when ``augmentation`` is on, the loss of the
  config, backward, one scheduled Adam step, then ``layers.drop_caches``.
  Dropout masks and mixup draw from one ``torch.Generator`` on the device,
  seeded from ``(cfg.seed, step)`` at every step (the JAX package folds the
  step into its key), so a resumed run draws what an unbroken one would.
- Parameters stay f32 (master weights); ``dtype="bfloat16"`` computes under
  ``torch.autocast`` in bf16, as the JAX models keep f32 parameters and
  compute in ``dtype``. In the frozen encoder layers no gradient has to pass,
  so their attention runs the K2 kernel on the card
  (``models.wav2vec2.attention_route``).
- ``eval_step``, ``run_epoch`` (metrics, TensorBoard scalars through
  ``utils.tb``), ``fit`` (the epoch loop, the confusion SVG per epoch, the
  best export, a resumable ``latest`` checkpoint, ``stats.csv``),
  ``extract_features``, ``maybe_update_best``, ``save_checkpoint`` /
  ``restore_checkpoint`` (``torch.save`` of the model, the optimizer with its
  update count, the step and the epoch, in ``<log_dir>/ckpt/<tag>``, beside
  ``<tag>_aux.json`` with the best metric and the history),
  ``write_confusion_matrix`` (skipped with a warning where matplotlib is
  absent), ``write_stats_csv`` and ``write_provenance`` (``source.log``).
- The best export is the model's state dict under the reference's names,
  ``<log_root>/<family>.pth``, which ``core.checkpoint.load_torch_state_dict``
  and ``cli.extract_features --checkpoint`` load.

Refused by name: a mesh above 1 (``MeshConfig.data``, ``model`` or ``pipe``),
ROADMAP queue 1, parallelism (item 11).
"""

from __future__ import annotations

import inspect
import json
import logging
import os
import time
from dataclasses import dataclass
from typing import Any, Callable, Iterable, Optional

import numpy as np
import torch
import torch.nn as nn

from avcer_tpu_torch.core.config import TrainConfig
from avcer_tpu_torch.models import layers
from avcer_tpu_torch.train import losses as loss_lib
from avcer_tpu_torch.train import metrics as metrics_lib
from avcer_tpu_torch.train.schedules import ScheduledOptimizer, make_optimizer

log = logging.getLogger("avcer_tpu_torch")

PARALLELISM = "ROADMAP queue 1, parallelism (item 11)"
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass
class TrainState:
    """The model (its parameters and BatchNorm statistics), the optimizer
    (None for inference-only use) and the number of updates made."""

    model: nn.Module
    optimizer: Optional[ScheduledOptimizer]
    step: int = 0


def default_trainable(name: str, unfreeze_last_n: int, num_layers: int) -> bool:
    """The reference's fine-tuning policy on the port's parameter names: all
    of wav2vec2 is frozen but its last ``unfreeze_last_n`` encoder layers;
    everything outside wav2vec2 trains."""
    if "wav2vec2" not in name:
        return True
    return any(name.startswith(f"wav2vec2.encoder.layers.{i}.")
               for i in range(num_layers - unfreeze_last_n, num_layers))


def check_mesh(mesh) -> None:
    """The port trains on one device: a mesh above 1 is refused by name."""
    big = {k: getattr(mesh, k) for k in ("data", "model", "pipe") if getattr(mesh, k, 1) > 1}
    if big:
        raise NotImplementedError(f"mesh {big} is not ported ({PARALLELISM})")


class Trainer:
    def __init__(
        self,
        model: nn.Module,  # forward(x) -> logits; forward(x, return_features=True) -> (logits, f)
        cfg: TrainConfig,
        loss_fn: Optional[Callable] = None,
        class_weights: Optional[np.ndarray] = None,
        iters_per_epoch: int = 100,
        unfreeze_last_n: int = 4,
        wav2vec2_layers: int = 12,
        log_dir: Optional[str] = None,
        device: str | torch.device = "cuda",
        dtype: str = "float32",
    ):
        check_mesh(cfg.mesh)
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but torch.cuda.is_available() is False")
        self.model = model
        self.cfg = cfg
        self.dtype = _DTYPES[dtype]
        self.class_weights = (torch.as_tensor(class_weights, dtype=torch.float32,
                                              device=self.device)
                              if class_weights is not None else None)
        if loss_fn is not None:
            self.loss_fn = loss_fn
        elif cfg.loss == "soft_focal":
            self.loss_fn = lambda logits, labels: loss_lib.soft_focal_loss_onehot(
                logits, labels, cfg.num_classes)
        elif cfg.loss == "ccc":
            self.loss_fn = loss_lib.ccc_loss
        elif cfg.loss == "mse":
            self.loss_fn = loss_lib.mse_loss
        else:
            self.loss_fn = lambda logits, labels: loss_lib.weighted_cross_entropy(
                logits, labels, self.class_weights, cfg.label_smoothing)
        self.iters_per_epoch = iters_per_epoch
        self.unfreeze_last_n = unfreeze_last_n
        self.wav2vec2_layers = wav2vec2_layers
        self.log_dir = log_dir or os.path.join(cfg.log_root, "run")
        self.generator = torch.Generator(device=self.device)
        self.history: list[dict] = []
        self.best: dict[str, Any] = {"metric": -np.inf, "epoch": -1, "state": None}
        self._tb: dict[str, Any] = {}
        self._last_epoch_outputs = (np.zeros(0, np.int64), np.zeros(0, np.int64))

    def _writer(self, phase: str):
        if phase not in self._tb:
            from avcer_tpu_torch.utils.tb import SummaryWriter

            self._tb[phase] = SummaryWriter(os.path.join(self.log_dir, phase))
        return self._tb[phase]

    def _autocast(self):
        return torch.autocast(self.device.type, dtype=torch.bfloat16,
                              enabled=self.dtype == torch.bfloat16)

    def _tensor(self, a, dtype=None) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=dtype).to(self.device)

    # ------------------------------------------------------------------
    def trainable(self, name: str) -> bool:
        return default_trainable(name, self.unfreeze_last_n, self.wav2vec2_layers)

    def init_state(self, example_batch: Optional[np.ndarray] = None, seed: Optional[int] = None,
                   params: Optional[dict[str, torch.Tensor]] = None) -> TrainState:
        """``params``: the starting state dict (loaded strictly); else the
        seeded init from ``seed`` (default ``cfg.seed``). ``example_batch``
        is accepted for the JAX signature and not needed: torch modules know
        their shapes."""
        model = self.model
        if params is not None:
            model.load_state_dict(params, strict=True)
        else:
            layers.seeded_init_(model, torch.Generator().manual_seed(
                self.cfg.seed if seed is None else seed))
        model.to(self.device)
        for name, p in model.named_parameters():
            p.requires_grad_(self.trainable(name))
        layers.set_dropout(model, generator=self.generator)
        o = self.cfg.optim
        opt = make_optimizer((p for p in model.parameters() if p.requires_grad), o.lr, o.t0,
                             self.iters_per_epoch, o.t_mult, o.eta_min, o.weight_decay)
        return TrainState(model, opt, 0)

    # ------------------------------------------------------------------
    def train_step(self, state: TrainState, x, y) -> tuple[TrainState, float, np.ndarray]:
        """One update on the batch ``x`` (inputs), ``y`` (labels); returns
        (state, loss, logits as numpy)."""
        model = state.model
        model.train()
        self.generator.manual_seed(int(self.cfg.seed) * 1_000_003 + state.step)
        xt = self._tensor(x, torch.float32 if np.asarray(x).dtype.kind == "f" else None)
        yt = self._tensor(y)
        mixup_alpha = self.cfg.mixup_alpha if self.cfg.augmentation else 0.0
        state.optimizer.zero_grad()
        with self._autocast():
            if mixup_alpha > 0:
                mixed, perm, lam = loss_lib.mixup_batch(self.generator, xt, mixup_alpha)
                logits = model(mixed)
                loss = lam * self.loss_fn(logits, yt) + (1 - lam) * self.loss_fn(logits, yt[perm])
            else:
                logits = model(xt)
                loss = self.loss_fn(logits, yt)
        loss.backward()
        state.optimizer.step()
        layers.drop_caches(model)
        state.step += 1
        return state, float(loss.detach()), logits.detach().float().cpu().numpy()

    @torch.no_grad()
    def _logits(self, model: nn.Module, x, **kw):
        model.eval()
        xt = self._tensor(x, torch.float32 if np.asarray(x).dtype.kind == "f" else None)
        with self._autocast():
            return model(xt, **kw)

    def eval_step(self, state: TrainState, x, y=None):
        """Eval forward: logits (numpy), and with labels also the loss."""
        logits = self._logits(state.model, x)
        if y is None:
            return logits.float().cpu().numpy()
        loss = float(self.loss_fn(logits, self._tensor(y)))
        return logits.float().cpu().numpy(), loss

    # ------------------------------------------------------------------
    def run_epoch(self, state: TrainState, loader: Iterable, epoch: int,
                  train: bool) -> tuple[TrainState, dict]:
        regression = self.cfg.problem == "regression"
        all_true, all_pred, losses = [], [], []
        t0 = time.perf_counter()
        for x, y in loader:
            if train:
                state, loss, logits = self.train_step(state, x, y)
            else:
                logits, loss = self.eval_step(state, x, y)
            losses.append(loss)
            all_true.append(np.asarray(y))
            all_pred.append(logits if regression else logits.argmax(-1))
        true = np.concatenate(all_true) if all_true else np.zeros(0, np.int64)
        pred = np.concatenate(all_pred) if all_pred else np.zeros(0, np.int64)
        self._last_epoch_outputs = (true, pred)
        stats = {
            "epoch": epoch,
            "phase": "train" if train else "eval",
            "loss": float(np.mean(losses)) if losses else float("nan"),
            "seconds": time.perf_counter() - t0,
        }
        if regression and true.size:
            if true.ndim == 2 and true.shape[1] >= 2:
                cv, ca, mean_ccc = metrics_lib.va_score(true, pred)
                stats.update({"ccc_v": cv, "ccc_a": ca, "ccc": mean_ccc,
                              "uar": 0.0, "accuracy": 0.0, "f1": mean_ccc,
                              "precision": 0.0, "mean": mean_ccc})
            else:
                c = metrics_lib.ccc(true.ravel(), pred.ravel())
                stats.update({"ccc": c, "uar": 0.0, "accuracy": 0.0,
                              "f1": c, "precision": 0.0, "mean": c})
        else:
            u, a, f, p, m = (metrics_lib.reference_metrics(true, pred) if true.size
                             else (0,) * 5)
            stats.update({"uar": u, "accuracy": a, "f1": f, "precision": p, "mean": m})
        self.history.append(stats)
        w = self._writer(stats["phase"])
        for key in ("loss", "uar", "accuracy", "f1", "precision"):
            if np.isfinite(stats[key]):
                w.add_scalar(key, stats[key], epoch)
        w.flush()
        return state, stats

    def fit(self, state: TrainState, train_loader: Iterable,
            eval_loader: Optional[Iterable] = None, epochs: Optional[int] = None,
            resume: bool = False, best_family: Optional[str] = None,
            log_fn: Optional[Callable[[str], None]] = None) -> TrainState:
        """The epoch loop (the reference's NetTrainer.run): per epoch a train
        phase and, with ``eval_loader``, an eval phase; the confusion SVG of
        the selecting phase; the best export when the selection metric
        improves; the ``latest`` checkpoint and ``stats.csv``. ``resume``
        continues from the ``latest`` checkpoint of this log dir."""
        say = log_fn or (lambda msg: None)
        epochs = epochs if epochs is not None else self.cfg.epochs
        start_epoch = 0
        if resume:
            try:
                state, last_epoch = self.restore_checkpoint(state, "latest")
                start_epoch = last_epoch + 1
                say(f"resumed from epoch {last_epoch}")
                aux_path = os.path.join(self.log_dir, "ckpt", "latest_aux.json")
                if os.path.exists(aux_path):
                    with open(aux_path) as f:
                        aux = json.load(f)
                    self.best = {"metric": aux["best_metric"], "epoch": aux["best_epoch"],
                                 "state": None}
                    self.history = list(aux["history"])
            except FileNotFoundError:
                say("no checkpoint to resume from; starting fresh")
        family = best_family or f"best_{self.cfg.model}"
        for epoch in range(start_epoch, epochs):
            state, tr = self.run_epoch(state, train_loader, epoch, train=True)
            say(f"epoch {epoch} train: {tr}")
            if eval_loader is not None:
                state, sel_stats = self.run_epoch(state, eval_loader, epoch, train=False)
                say(f"epoch {epoch} eval: {sel_stats}")
                phase_name = "eval"
            else:
                # no dev set: no eval pass; selection on the train metrics
                sel_stats = tr
                phase_name = "train"
            if self.cfg.problem != "regression":
                true, pred = self._last_epoch_outputs
                self.write_confusion_matrix(true, pred, epoch, phase_name)
            if self.maybe_update_best(state, sel_stats, epoch):
                self.save_best(family)
                say(f"epoch {epoch}: new best "
                    f"{self.cfg.selection_metric}={self.best['metric']:.4f}")
            self.save_checkpoint(state, epoch, tag="latest")
            self.write_stats_csv()
        return state

    def extract_features(self, state: TrainState, loader: Iterable
                         ) -> tuple[np.ndarray, np.ndarray]:
        """(logits [N, C], pooled features [N, F]) over a loader."""
        logits_all, feats_all = [], []
        for x, _y in loader:
            logits, feats = self._logits(state.model, x, return_features=True)
            logits_all.append(logits.float().cpu().numpy())
            feats_all.append(feats.float().cpu().numpy())
        return np.concatenate(logits_all), np.concatenate(feats_all)

    def maybe_update_best(self, state: TrainState, stats: dict, epoch: int) -> bool:
        metric = stats.get(self.cfg.selection_metric, stats.get("f1", 0.0))
        if metric > self.best["metric"]:
            self.best = {"metric": metric, "epoch": epoch,
                         "state": {k: v.detach().cpu().clone()
                                   for k, v in state.model.state_dict().items()}}
            return True
        return False

    def save_best(self, family: str) -> str:
        """The best state dict as ``<log_root>/<family>.pth``."""
        os.makedirs(self.cfg.log_root, exist_ok=True)
        path = os.path.join(self.cfg.log_root, f"{family}.pth")
        torch.save(self.best["state"], path)
        return path

    # ------------------------------------------------------------------
    def _ckpt_path(self, tag: str) -> str:
        return os.path.abspath(os.path.join(self.log_dir, "ckpt", tag))

    def save_checkpoint(self, state: TrainState, epoch: int, tag: str = "latest") -> str:
        """{model, optimizer, step, epoch} and the ``<tag>_aux.json`` sidecar
        (best metric, best epoch, history) that ``fit(resume=True)`` reads."""
        path = self._ckpt_path(tag)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        torch.save({"model": state.model.state_dict(),
                    "optimizer": state.optimizer.state_dict() if state.optimizer else None,
                    "step": state.step, "epoch": epoch}, path)
        with open(path + "_aux.json", "w") as f:
            json.dump({"best_metric": float(self.best["metric"]),
                       "best_epoch": int(self.best["epoch"]), "history": self.history}, f)
        return path

    def restore_checkpoint(self, state: TrainState, tag: str = "latest"
                           ) -> tuple[TrainState, int]:
        """Into an initialised state (same model and trainable set). Raises
        ``FileNotFoundError`` when the checkpoint is absent."""
        path = self._ckpt_path(tag)
        if not os.path.isfile(path):
            raise FileNotFoundError(path)
        payload = torch.load(path, map_location=self.device, weights_only=True)
        state.model.load_state_dict(payload["model"], strict=True)
        layers.drop_caches(state.model)
        if state.optimizer is not None and payload["optimizer"] is not None:
            state.optimizer.load_state_dict(payload["optimizer"])
        state.step = int(payload["step"])
        return state, int(payload["epoch"])

    def write_confusion_matrix(self, true: np.ndarray, pred: np.ndarray, epoch: int,
                               phase: str) -> Optional[str]:
        """The epoch's confusion matrix as an SVG (matplotlib); where
        matplotlib is not installed, a warning and no file."""
        if true.size == 0:
            return None
        try:
            import matplotlib  # noqa: F401
        except ImportError:
            log.warning("matplotlib is not installed: the confusion matrix of %s epoch %d "
                        "is not written", phase, epoch)
            return None
        from avcer_tpu_torch.utils import viz

        n = self.cfg.num_classes
        cm = metrics_lib.confusion(true, pred, n)
        out_dir = os.path.join(self.log_dir, "confusion")
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, f"{phase}_epoch_{epoch:03d}.svg")
        viz.plot_conf_matrix(cm, [str(i) for i in range(n)], save_path=path,
                             title=f"{phase} epoch {epoch}")
        return path

    # ------------------------------------------------------------------
    def write_stats_csv(self) -> str:
        import pandas as pd

        os.makedirs(self.log_dir, exist_ok=True)
        path = os.path.join(self.log_dir, "stats.csv")
        pd.DataFrame(self.history).to_csv(path, index=False)
        return path

    def write_provenance(self) -> str:
        """The config and the source of the model's class, the losses and
        the trainer (``source.log``)."""
        os.makedirs(self.log_dir, exist_ok=True)
        path = os.path.join(self.log_dir, "source.log")
        with open(path, "w") as fh:
            fh.write(self.cfg.to_json())
            fh.write("\n\n")
            for obj in (type(self.model), loss_lib, type(self)):
                try:
                    fh.write(f"##### {getattr(obj, '__name__', obj)} #####\n")
                    fh.write(inspect.getsource(obj))
                    fh.write("\n")
                except (OSError, TypeError):
                    fh.write(repr(obj) + "\n")
        return path
