"""Trainer: the step / eval / checkpoint loop (port of
``articulatory_tpu/train/trainer.py::Trainer``).

- Each step moves the numpy batch to the device, reads both schedulers'
  ``lr`` and runs the train step; the schedulers then advance once per step,
  gated like the JAX trainer (the generator's while ``steps >
  generator_train_start_steps``, the discriminator's likewise), with
  ReduceLROnPlateau fed the previous step's loss.
- Metrics stay on the device between log intervals: ``log_interval_steps``
  averages and logs them, ``eval_interval_steps`` runs the dev set and keeps
  the best ``eval/mel_loss`` in ``best_mel_ckpt.pkl`` and
  ``best_mel_step.txt`` (step and loss, restored on resume),
  ``save_interval_steps`` writes ``checkpoint-<steps>steps.ckpt``, and
  ``train_max_steps`` ends the run with a last checkpoint.

Not ported yet: the profiler window, the SIGTERM preemption handler, the
tensorboard writer and the intermediate plots of the first eval batch.
"""

from __future__ import annotations

import logging
import os
import time
from collections import defaultdict

import numpy as np
import torch

from articulatory_tpu_torch.utils.checkpoint import save_checkpoint

# keys the train step consumes; the collater's aliases (audio/art/mel
# duplicate x/y) would otherwise be copied to the device every step
_STEP_BATCH_KEYS = ("x", "y", "ar", "ar2", "spk_id", "ph", "pitch",
                    "periodicity")


def to_device(batch: dict, device: torch.device) -> dict:
    """The step's keys of a collated numpy batch as tensors on ``device``."""
    def move(v):
        if isinstance(v, tuple):
            return tuple(move(a) for a in v)
        return torch.from_numpy(np.asarray(v)).to(device, non_blocking=True)

    return {k: move(v) for k, v in batch.items()
            if k in _STEP_BATCH_KEYS and v is not None}


class Trainer:
    def __init__(self, *, config: dict, state, train_step, eval_step,
                 schedulers: dict, data_loader: dict, outdir: str,
                 device: torch.device, epochs: int = 0):
        self.config = config
        self.state = state
        self.train_step = train_step
        self.eval_step = eval_step
        self.schedulers = schedulers
        self.data_loader = data_loader
        self.outdir = outdir
        self.device = device
        self.epochs = epochs
        self.finish_train = False
        self.total_train_loss: dict = defaultdict(float)
        self._train_count = 0
        self._pending_sched: dict = {}
        self._last_log_time = time.time()
        self.best_mel_loss = 1.0e6
        best_path = os.path.join(outdir, "best_mel_step.txt")
        if os.path.exists(best_path):
            fields = open(best_path).read().split()
            if len(fields) >= 2:
                self.best_mel_loss = float(fields[1])
        self._plateau = {k: type(v).__name__ == "ReduceLROnPlateau"
                         for k, v in schedulers.items()}

    @property
    def steps(self) -> int:
        return self.state.steps

    def run(self) -> None:
        try:
            while not self.finish_train:
                self._train_epoch()
        finally:
            self.save_checkpoint(os.path.join(
                self.outdir, f"checkpoint-{self.steps}steps.ckpt"))
            logging.info(f"Successfully saved checkpoint @ {self.steps} steps.")

    def _train_epoch(self) -> None:
        for batch in self.data_loader["train"]:
            self._train_step(batch)
            self._check_log_interval()
            self._check_eval_interval()
            self._check_save_interval()
            if self.finish_train:
                return
        self.epochs += 1
        self.data_loader["train"].set_epoch(self.epochs)

    def _train_step(self, batch: dict) -> None:
        steps = self.steps
        metrics = self.train_step(self.state, to_device(batch, self.device),
                                  self.schedulers["generator"].lr,
                                  self.schedulers["discriminator"].lr)
        for k, v in metrics.items():
            self.total_train_loss[k] = self.total_train_loss[k] + v
        self._train_count += 1
        for name, start_key, loss_key in (
                ("generator", "generator_train_start_steps",
                 "train/generator_loss"),
                ("discriminator", "discriminator_train_start_steps",
                 "train/discriminator_loss")):
            if steps <= self.config.get(start_key, 0):
                continue
            if self._plateau[name]:
                # the previous step's loss: its value is ready, so reading
                # it does not wait for this step
                prev = self._pending_sched.pop(name, None)
                if prev is not None:
                    self.schedulers[name].step(float(prev))
                self._pending_sched[name] = metrics[loss_key]
            else:
                self.schedulers[name].step(None)
        if self.steps >= self.config["train_max_steps"]:
            self.finish_train = True

    def _check_log_interval(self) -> None:
        if (self.steps % self.config.get("log_interval_steps", 100)
                or self._train_count == 0):
            return
        elapsed = time.time() - self._last_log_time
        for key, total in sorted(self.total_train_loss.items()):
            logging.info(f"(Steps: {self.steps}) {key} = "
                         f"{float(total) / self._train_count:.4f}.")
        logging.info(f"(Steps: {self.steps}) "
                     f"{self._train_count / max(elapsed, 1e-9):.3f} steps/s.")
        self.total_train_loss = defaultdict(float)
        self._train_count = 0
        self._last_log_time = time.time()

    def _check_eval_interval(self) -> None:
        if self.steps % self.config.get("eval_interval_steps", 1000) == 0:
            self._eval_epoch()

    def _check_save_interval(self) -> None:
        if self.steps % self.config.get("save_interval_steps", 5000) == 0:
            self.save_checkpoint(os.path.join(
                self.outdir, f"checkpoint-{self.steps}steps.ckpt"))
            logging.info(f"Successfully saved checkpoint @ {self.steps} steps.")

    def _eval_epoch(self) -> None:
        logging.info(f"(Steps: {self.steps}) Start evaluation.")
        totals: dict = defaultdict(float)
        count = 0
        for batch in self.data_loader.get("dev", []):
            metrics, _ = self.eval_step(self.state,
                                        to_device(batch, self.device))
            for k, v in metrics.items():
                totals[k] = totals[k] + v
            count += 1
        if count == 0:
            return
        averages = {k: float(v) / count for k, v in totals.items()}
        for key, avg in sorted(averages.items()):
            logging.info(f"(Steps: {self.steps}) {key} = {avg:.4f}.")
        mel = averages.get("eval/mel_loss")
        if mel is not None and mel < self.best_mel_loss:
            self.best_mel_loss = mel
            self.save_checkpoint(os.path.join(self.outdir, "best_mel_ckpt.pkl"))
            with open(os.path.join(self.outdir, "best_mel_step.txt"), "w") as f:
                f.write(f"{self.steps} {self.best_mel_loss}")
            logging.info(f"(Steps: {self.steps}) New best eval/mel_loss "
                         f"{self.best_mel_loss:.4f}.")

    def save_checkpoint(self, path: str) -> None:
        save_checkpoint(path, self.state, schedulers=self.schedulers,
                        epochs=self.epochs)
