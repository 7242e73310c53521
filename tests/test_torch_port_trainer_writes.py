"""What the port's ``Trainer`` writes beside its checkpoints, against the
JAX package's ``Trainer`` driven the same way: both take the same stub
train and eval steps (fixed metrics, a fixed eval output) over the same
numpy batches, with a recording ``writer=``. The ``(tag, step)`` sequences
of their scalars are equal, and so are the scalars' values but the
timings' (``train/steps_per_sec``, ``train/samples_per_sec_per_chip``);
the intermediate results of every evaluation are written under the same
names (``predictions/<steps>steps/<i>.png``, ``<i>_ref.wav``,
``<i>_gen.wav``), the wavs byte for byte. Without tensorboardX or
matplotlib the port logs it and goes on, the wavs still written. And the
train CLI takes a command line of the reference's form (its ignored data
flags and ``--rank``) and trains a step on the CPU."""

import builtins
import os
import types

import numpy as np
import pytest
import torch
import yaml

from articulatory_tpu.parallel.mesh import make_mesh
from articulatory_tpu.train.trainer import Trainer as JaxTrainer
from articulatory_tpu_torch.bin import train as train_cli
from articulatory_tpu_torch.train.schedulers import build_scheduler
from articulatory_tpu_torch.train.trainer import Trainer

torch.set_num_threads(1)

CONFIG = dict(train_max_steps=4, log_interval_steps=2, eval_interval_steps=2,
              save_interval_steps=100, batch_size=3, batch_max_steps=160,
              sampling_rate=16000, num_save_intermediate_results=2)
METRICS = {"train/generator_loss": 1.5, "train/discriminator_loss": 0.25,
           "train/mel_loss": 0.75}
EVAL = {"eval/generator_loss": 2.0, "eval/mel_loss": 0.5}


class Recorder:
    def __init__(self):
        self.scalars = []

    def add_scalar(self, tag, value, step):
        self.scalars.append((tag, float(value), int(step)))


class Batches(list):
    def set_epoch(self, epoch):
        del epoch


def _batches(n, seed):
    rng = np.random.default_rng(seed)
    return Batches({"x": (rng.standard_normal((3, 2, 13)).astype(np.float32),),
                    "y": (0.3 * rng.standard_normal((3, 160, 1))).astype(
                        np.float32)} for _ in range(n))


GENERATED = 0.2 * np.sin(np.arange(3 * 160) / 7.0).reshape(3, 160, 1)


def _port_trainer(outdir, writer, monkeypatch):
    monkeypatch.setattr(Trainer, "save_checkpoint", lambda self, path: None)

    def train_step(state, batch, lr_g, lr_d):
        state.steps += 1
        return {k: torch.tensor(v) for k, v in METRICS.items()}

    def eval_step(state, batch):
        return ({k: torch.tensor(v) for k, v in EVAL.items()},
                torch.tensor(GENERATED, dtype=torch.float32))

    schedulers = {k: build_scheduler("StepLR", 1e-4, {"step_size": 3})
                  for k in ("generator", "discriminator")}
    return Trainer(config=CONFIG, state=types.SimpleNamespace(steps=0),
                   train_step=train_step, eval_step=eval_step,
                   schedulers=schedulers,
                   data_loader={"train": _batches(4, 0),
                                "dev": _batches(2, 1)},
                   outdir=str(outdir), device=torch.device("cpu"),
                   writer=writer)


def _jax_trainer(outdir, writer, monkeypatch):
    from articulatory_tpu.train.schedulers import build_scheduler as jax_sched

    monkeypatch.setattr(JaxTrainer, "save_checkpoint",
                        lambda self, path: None)

    def train_step(state, batch, rng, lr_g, lr_d):
        return state, {k: np.float32(v) for k, v in METRICS.items()}

    def eval_step(state, batch, rng):
        return ({k: np.float32(v) for k, v in EVAL.items()},
                GENERATED.astype(np.float32))

    schedulers = {k: jax_sched("StepLR", 1e-4, {"step_size": 3})
                  for k in ("generator", "discriminator")}
    return JaxTrainer(config=CONFIG, state=None, train_step=train_step,
                      eval_step=eval_step, schedulers=schedulers,
                      data_loader={"train": _batches(4, 0),
                                   "dev": _batches(2, 1)},
                      outdir=str(outdir), mesh=make_mesh(1), writer=writer)


def _files(outdir):
    root = outdir / "predictions"
    return sorted(str(p.relative_to(root)) for p in root.rglob("*")
                  if p.is_file())


def test_writer_tags_and_intermediate_files_match_jax(tmp_path,
                                                      monkeypatch):
    got, want = Recorder(), Recorder()
    for name in ("port", "jax"):
        (tmp_path / name).mkdir()
    _port_trainer(tmp_path / "port", got, monkeypatch).run()
    _jax_trainer(tmp_path / "jax", want, monkeypatch).run()
    assert [(t, s) for t, _, s in got.scalars] == [
        (t, s) for t, _, s in want.scalars]
    assert {"train/steps_per_sec", "train/samples_per_sec_per_chip",
            "train/lr_generator", "eval/mel_loss"} <= {
        t for t, _, _ in got.scalars}
    timed = ("train/steps_per_sec", "train/samples_per_sec_per_chip")
    for (tag, value, _), (_, theirs, _) in zip(got.scalars, want.scalars):
        if tag not in timed:
            assert value == pytest.approx(theirs, rel=1e-6), tag
    files = _files(tmp_path / "port")
    assert files == _files(tmp_path / "jax") == sorted(
        f"{s}steps/{name}" for s in (2, 4) for i in range(2)
        for name in (f"{i}.png", f"{i}_gen.wav", f"{i}_ref.wav"))
    for name in files:
        if name.endswith(".wav"):
            assert ((tmp_path / "port" / "predictions" / name).read_bytes()
                    == (tmp_path / "jax" / "predictions" / name).read_bytes())


def test_missing_tensorboardx_and_matplotlib_are_skipped(tmp_path,
                                                         monkeypatch, caplog):
    real_import = builtins.__import__

    def no_optional(name, *args, **kwargs):
        if name.split(".")[0] in ("tensorboardX", "matplotlib"):
            raise ImportError(name)
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_optional)
    trainer = _port_trainer(tmp_path, None, monkeypatch)
    assert trainer.writer is None
    trainer.run()
    assert sorted(os.listdir(tmp_path / "predictions" / "4steps")) == [
        "0_gen.wav", "0_ref.wav", "1_gen.wav", "1_ref.wav"]
    warned = [r.message for r in caplog.records
              if "matplotlib" in r.message or "tensorboardX" in r.message]
    assert len(warned) == 2  # each once


def test_reference_command_line_trains(tmp_path):
    """``--train-wav-scp x --rank 0`` and the other reference data flags
    are accepted and ignored, as the JAX CLI does; the dump directories
    stay required."""
    from test_torch_port_train_cli import CONFIG as CLI_CONFIG
    from test_torch_port_train_cli import _dump

    _dump(tmp_path)
    config = dict(CLI_CONFIG, train_max_steps=1)
    (tmp_path / "c.yml").write_text(yaml.safe_dump(config))
    args = ["--train-wav-scp", "x", "--train-feats-scp", "x",
            "--train-segments", "x", "--train-dumpdirs", "x",
            "--dev-wav-scp", "x", "--dev-feats-scp", "x",
            "--dev-segments", "x", "--dev-dumpdirs", "x", "--rank", "0",
            "--outdir", str(tmp_path / "exp"),
            "--config", str(tmp_path / "c.yml"),
            "--data-root", str(tmp_path / "data"), "--device", "cpu"]
    dumps = ["--train-dumpdir", str(tmp_path / "dump/tr/norm"),
             "--dev-dumpdir", str(tmp_path / "dump/dev/norm")]
    train_cli.main(args + dumps)
    assert (tmp_path / "exp" / "checkpoint-1steps.ckpt").exists()
    with pytest.raises(SystemExit) as exc:
        train_cli.main(args + dumps[:2])
    assert exc.value.code == 2
