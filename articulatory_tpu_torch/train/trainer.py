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

- ``profile_steps: [lo, hi]`` opens a ``torch.profiler`` window (CPU and,
  on a card, CUDA activities) over steps ``lo`` to ``hi - 1``, range-based
  and stateful, so a ``--resume`` that lands inside the window opens it;
  it closes at step ``hi`` or when the run ends, and writes a chrome trace
  to ``<outdir>/profile/trace-<lo>-<hi>.json``. The profiler stays at
  ``Trainer.profiler`` for its ``key_averages()``. On a card the device is
  synchronised at both ends, and the window opens with PROFILE_LEAD_S of
  idle host time (the profiler drops device records it dates before its
  start, and now and then dates the first ones early). The trace holds the
  port's spans (``trace.py``): ``train_step/<phase>`` for each phase of the
  step, and inside them ``generator``, ``discriminator``, ``aux_loss``,
  ``collective`` and ``recompute_grads:<kernel>``.
- SIGTERM (a preemption notice) lets the current step finish, then the
  run's last checkpoint, ``checkpoint-<steps>steps.ckpt``, is written and
  ``run`` returns. The handler is installed only in the main thread, and
  the previous one restored when ``run`` ends.

- ``writer`` (default a ``tensorboardX.SummaryWriter`` on ``outdir``)
  takes the JAX trainer's scalars under its tags: each averaged training
  metric, ``train/steps_per_sec``, ``train/samples_per_sec_per_chip`` and
  ``train/lr_generator`` at every log interval, each averaged ``eval/*``
  metric at every evaluation. At every log interval rank 0 also logs and
  writes ``time/<phase>_ms``: the device ms of each phase of the step
  (``trace.PHASES``), averaged over the interval's steps that ran it, from
  the step's phase account (``trace.StepAccount``). That is where an
  operator reads which phase a step's time goes to, with no profiler on.
- Every evaluation writes the first dev batch's first
  ``num_save_intermediate_results`` (default 4) utterances to
  ``<outdir>/predictions/<steps>steps/``: ``<i>.png`` (target above the
  output) and, for waveform targets, ``<i>_ref.wav`` and ``<i>_gen.wav``.

tensorboardX and matplotlib are imported when first needed; where one is
missing, that is logged once and its output skipped (the wavs are still
written).

Several ranks (``parallel/mesh.py``): every rank steps, evaluates and takes
the save decisions; only rank 0 logs, writes the scalars, the
intermediate results, ``best_mel_step.txt`` and the checkpoints (written
full, then a barrier), and opens the profiler window. The logged training
and evaluation metrics are averaged over the ranks, ``best_mel_loss`` is
rank 0's (broadcast when the trainer starts), and
``samples_per_sec_per_chip`` counts the global batch (``batch_size`` a
data-parallel rank) over the cards in use.

``epoch_batches`` counts the batches taken in the current epoch; it is
saved with the checkpoints, and a resume starts the epoch's loader after
them (``set_epoch(epoch, start)``), so a resumed run takes the batches the
uninterrupted run would have.
"""

from __future__ import annotations

import logging
import os
import signal
import time
from collections import defaultdict

import numpy as np
import torch

from articulatory_tpu_torch import trace
from articulatory_tpu_torch.parallel import mesh
from articulatory_tpu_torch.utils.checkpoint import save_checkpoint
from articulatory_tpu_torch.utils.io import write_wav

# keys the train step consumes; the collater's aliases (audio/art/mel
# duplicate x/y) would otherwise be copied to the device every step
_STEP_BATCH_KEYS = ("x", "y", "ar", "ar2", "spk_id", "ph", "pitch",
                    "periodicity")
PROFILE_LEAD_S = 0.05


def to_device(batch: dict, device: torch.device) -> dict:
    """The step's keys of a collated batch as tensors on ``device``: numpy
    arrays are copied there, tensors already there (the device cache's)
    pass through."""
    def move(v):
        if isinstance(v, tuple):
            return tuple(move(a) for a in v)
        if not torch.is_tensor(v):
            v = torch.from_numpy(np.asarray(v))
        return v.to(device, non_blocking=True)

    return {k: move(v) for k, v in batch.items()
            if k in _STEP_BATCH_KEYS and v is not None}


def _summary_writer(outdir: str):
    """A ``tensorboardX.SummaryWriter`` on ``outdir``, or None (logged)
    without tensorboardX."""
    try:
        from tensorboardX import SummaryWriter
    except ImportError:
        logging.warning("tensorboardX is not installed: the scalars go to "
                        "the log only")
        return None
    return SummaryWriter(outdir)


class Trainer:
    def __init__(self, *, config: dict, state, train_step, eval_step,
                 schedulers: dict, data_loader: dict, outdir: str,
                 device: torch.device, epochs: int = 0, writer=None,
                 epoch_batches: int = 0):
        self.config = config
        self.state = state
        self.train_step = train_step
        self.eval_step = eval_step
        self.schedulers = schedulers
        self.data_loader = data_loader
        self.outdir = outdir
        self.device = device
        self.epochs = epochs
        self.epoch_batches = epoch_batches
        self.is_main = mesh.is_main()
        self.finish_train = False
        self.total_train_loss: dict = defaultdict(float)
        self._train_count = 0
        self._pending_sched: dict = {}
        self._last_log_time = time.time()
        self._traced = trace.resolved()  # steps accounted before this log
        self.best_mel_loss = 1.0e6
        best_path = os.path.join(outdir, "best_mel_step.txt")
        if os.path.exists(best_path):
            fields = open(best_path).read().split()
            if len(fields) >= 2:
                self.best_mel_loss = float(fields[1])
        if mesh.world_size() > 1:  # rank 0 keeps the file
            self.best_mel_loss = mesh.broadcast_float(self.best_mel_loss)
        self._plateau = {k: type(v).__name__ == "ReduceLROnPlateau"
                         for k, v in schedulers.items()}
        self.profiler = None
        self._profiling = False
        self._orbax_logged = False
        self._plot_missing_logged = False
        self._own_writer = writer is None
        self.writer = writer if writer is not None else (
            _summary_writer(outdir) if self.is_main else None)

    @property
    def steps(self) -> int:
        return self.state.steps

    def run(self) -> None:
        previous = self._install_preemption_handler()
        failed = True
        try:
            while not self.finish_train:
                self._train_epoch()
            failed = False
        finally:
            if self._profiling:
                self._stop_profiler()
            # a failing rank saves nothing: the save's collectives would
            # wait for ranks that are still stepping
            if not failed or mesh.world_size() == 1:
                self.save_checkpoint(os.path.join(
                    self.outdir, f"checkpoint-{self.steps}steps.ckpt"))
            if previous is not None:
                signal.signal(signal.SIGTERM, previous)
            if self._own_writer and self.writer is not None:
                self.writer.close()

    def _install_preemption_handler(self):
        """SIGTERM -> finish the current step, checkpoint and stop; returns
        the previous handler, or None outside the main thread."""
        def on_sigterm(signum, frame):
            logging.warning("SIGTERM received: checkpointing and stopping.")
            self.finish_train = True

        try:
            return signal.signal(signal.SIGTERM, on_sigterm)
        except ValueError:  # not the main thread
            return None

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _profile_window(self) -> None:
        window = self.config.get("profile_steps")
        if not window or not self.is_main:
            return
        lo, hi = int(window[0]), int(window[1])
        if not self._profiling and lo <= self.steps < hi:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(ProfilerActivity.CUDA)
            self._sync()
            self.profiler = profile(activities=activities)
            self.profiler.start()
            self._profiling = True
            self._trace_path = os.path.join(self.outdir, "profile",
                                            f"trace-{lo}-{hi}.json")
            if self.device.type == "cuda":
                time.sleep(PROFILE_LEAD_S)
            logging.info(f"profiler started @ step {self.steps}")
        elif self._profiling and self.steps >= hi:
            self._stop_profiler()

    def _stop_profiler(self) -> None:
        self._sync()
        self.profiler.stop()
        self._profiling = False
        os.makedirs(os.path.dirname(self._trace_path), exist_ok=True)
        self.profiler.export_chrome_trace(self._trace_path)
        logging.info(f"profiler stopped @ step {self.steps}; trace "
                     f"{self._trace_path}")

    def _train_epoch(self) -> None:
        for batch in self.data_loader["train"]:
            self._train_step(batch)
            self.epoch_batches += 1
            self._check_log_interval()
            self._check_eval_interval()
            self._check_save_interval()
            if self.finish_train:
                return
        self.epochs += 1
        self.epoch_batches = 0
        self.data_loader["train"].set_epoch(self.epochs)

    def _train_step(self, batch: dict) -> None:
        self._profile_window()
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
        averages = mesh.average({k: float(v) / self._train_count
                                 for k, v in self.total_train_loss.items()})
        for key, avg in sorted(averages.items()):
            if self.is_main:
                logging.info(f"(Steps: {self.steps}) {key} = {avg:.4f}.")
            self._scalar(key, avg)
        steps_per_sec = self._train_count / max(elapsed, 1e-9)
        if self.is_main:
            logging.info(f"(Steps: {self.steps}) {steps_per_sec:.3f} "
                         f"steps/s.")
        self._scalar("train/steps_per_sec", steps_per_sec)
        # batch_size is a data-parallel rank's; the global batch over the
        # cards in use
        samples_per_step = (self.config.get("batch_size", 1)
                            * mesh.layout().dp
                            * self.config.get("batch_max_steps", 0))
        if samples_per_step:
            self._scalar("train/samples_per_sec_per_chip",
                         steps_per_sec * samples_per_step
                         / mesh.cards(self.device))
        self._scalar("train/lr_generator", self.schedulers["generator"].lr)
        self._log_phases()
        self.total_train_loss = defaultdict(float)
        self._train_count = 0
        self._last_log_time = time.time()

    def _log_phases(self) -> None:
        """``time/<phase>_ms`` over the steps accounted since the last log
        (the averages read above waited for the device, so every step of
        the interval is resolved)."""
        phases = [p for _, p in trace.records(self._traced)]
        self._traced = trace.resolved()
        if not self.is_main:
            return
        for name in trace.PHASES:
            ms = trace.mean_ms([p for p in phases if name in p], (name,))
            if ms is not None:
                logging.info(f"(Steps: {self.steps}) time/{name}_ms = "
                             f"{ms:.3f}.")
                self._scalar(f"time/{name}_ms", ms)

    def _check_eval_interval(self) -> None:
        if self.steps % self.config.get("eval_interval_steps", 1000) == 0:
            self._eval_epoch()

    def _check_save_interval(self) -> None:
        if self.steps % self.config.get("save_interval_steps", 5000) == 0:
            self.save_checkpoint(os.path.join(
                self.outdir, f"checkpoint-{self.steps}steps.ckpt"))

    def _eval_epoch(self) -> None:
        if self.is_main:
            logging.info(f"(Steps: {self.steps}) Start evaluation.")
        totals: dict = defaultdict(float)
        count = 0
        first = None
        draws = getattr(self.state, "draws", None)
        for batch in self.data_loader.get("dev", []):
            if draws is not None:  # keyed by the step and the batch
                draws.at(self.steps, count)
            metrics, y_ = self.eval_step(self.state,
                                         to_device(batch, self.device))
            for k, v in metrics.items():
                totals[k] = totals[k] + v
            if first is None:
                first = (batch, y_)
            count += 1
        if count == 0:
            return
        # every rank sees equally many dev batches (wrap-padded shards)
        averages = mesh.average({k: float(v) / count
                                 for k, v in totals.items()})
        for key, avg in sorted(averages.items()):
            if self.is_main:
                logging.info(f"(Steps: {self.steps}) {key} = {avg:.4f}.")
            self._scalar(key, avg)
        mel = averages.get("eval/mel_loss")
        if mel is not None and mel < self.best_mel_loss:
            self.best_mel_loss = mel
            self.save_checkpoint(os.path.join(self.outdir, "best_mel_ckpt.pkl"))
            if self.is_main:
                with open(os.path.join(self.outdir, "best_mel_step.txt"),
                          "w") as f:
                    f.write(f"{self.steps} {self.best_mel_loss}")
                logging.info(f"(Steps: {self.steps}) New best eval/mel_loss "
                             f"{self.best_mel_loss:.4f}.")
        if self.is_main:
            self._save_intermediate(*first)

    def _scalar(self, tag: str, value: float) -> None:
        if self.writer is not None:
            self.writer.add_scalar(tag, value, self.steps)

    def _save_intermediate(self, batch: dict, y_gen) -> None:
        """Plots (and wavs, for waveform targets) of the first utterances of
        an evaluation batch, target against output."""
        y_ref, y_gen = (y.detach().float().cpu().numpy() if torch.is_tensor(y)
                        else np.asarray(y) for y in (batch["y"], y_gen))
        n = min(self.config.get("num_save_intermediate_results", 4),
                len(y_gen), len(y_ref))
        if n <= 0:
            return
        dirname = os.path.join(self.outdir, f"predictions/{self.steps}steps")
        os.makedirs(dirname, exist_ok=True)
        sr = self.config.get("sampling_rate", 16000)
        is_wave = y_ref.ndim == 3 and y_ref.shape[-1] == 1
        plt = self._pyplot()
        for idx in range(n):
            ref, gen = y_ref[idx].squeeze(), y_gen[idx].squeeze()
            if plt is not None:
                fig, axes = plt.subplots(2, 1, figsize=(6, 4))
                axes[0].plot(ref)
                axes[0].set_title("groundtruth")
                axes[1].plot(gen)
                axes[1].set_title(f"generated @ {self.steps} steps")
                fig.tight_layout()
                fig.savefig(os.path.join(dirname, f"{idx}.png"))
                plt.close(fig)
            if is_wave:
                write_wav(os.path.join(dirname, f"{idx}_ref.wav"), ref, sr)
                write_wav(os.path.join(dirname, f"{idx}_gen.wav"), gen, sr)

    def _pyplot(self):
        """matplotlib's pyplot on the Agg backend, or None (logged once)
        without matplotlib."""
        try:
            import matplotlib
        except ImportError:
            if not self._plot_missing_logged:
                logging.warning("matplotlib is not installed: the "
                                "intermediate plots are skipped")
                self._plot_missing_logged = True
            return None
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        return plt

    def save_checkpoint(self, path: str) -> None:
        if (self.config.get("checkpoint_backend") == "orbax"
                and not self._orbax_logged):
            logging.warning("checkpoint_backend: orbax is a JAX checkpoint "
                            "directory; the port writes a torch pickle at "
                            "the same path instead")
            self._orbax_logged = True
        save_checkpoint(path, self.state, schedulers=self.schedulers,
                        epochs=self.epochs, epoch_batches=self.epoch_batches)
        if self.is_main:
            logging.info(f"Successfully saved checkpoint @ {self.steps} "
                         f"steps.")
