"""The port's tracing (``articulatory_tpu_torch/trace.py``) on a tiny HiFiGAN
+ MSMPD training step: the phase account records exactly the phases that
ran, keyed by ``state.steps``, with device ms that tile the step; gated-off
updates record nothing; the ring stays bounded; without a profiler no span
calls ``record_function``; under a CPU profile the spans appear by name and
nested, each phase's account start within 1 ms of the profiler's start of
its range (one clock); the ``Trainer`` writes ``time/<phase>_ms``. Marked
``gpu``: on a card the phases' device ms cover 85-100 % of the steps' host
time. The file imports no JAX."""

import time

import pytest
import torch

from articulatory_tpu_torch import trace
from articulatory_tpu_torch.models import build_model
from articulatory_tpu_torch.train import gan
from articulatory_tpu_torch.train.optimizers import build_optimizer
from articulatory_tpu_torch.train.schedulers import build_scheduler
from articulatory_tpu_torch.train.trainer import Trainer

torch.set_num_threads(1)

GP = dict(in_channels=13 + 8, out_channels=1, channels=16, kernel_size=7,
          upsample_scales=[5, 4, 2, 2], upsample_kernel_sizes=[10, 8, 4, 4],
          resblock_kernel_sizes=[3], resblock_dilations=[[1, 3]],
          use_ar=True, ar_input=64, ar_hidden=8, ar_output=8)
DP = dict(scales=1, scale_discriminator_params=dict(
    channels=16, max_downsample_channels=32, downsample_scales=[4, 1]),
    periods=[2], period_discriminator_params=dict(
        channels=4, max_downsample_channels=8, downsample_scales=[3, 1]))
OPT = dict(lr=1e-4, betas=[0.5, 0.9])
CONFIG = dict(
    sampling_rate=16000, hop_size=80, dataset_mode="a2w", batch_size=2,
    batch_max_steps=800, generator_type="HiFiGANGenerator",
    generator_params=GP,
    discriminator_type="HiFiGANMultiScaleMultiPeriodDiscriminator",
    discriminator_params=DP, use_stft_loss=False, use_mel_loss=True,
    mel_loss_params=dict(fs=16000, fft_size=256, hop_size=64, num_mels=20,
                         fmin=0, fmax=8000, log_base=None),
    use_feat_match_loss=True, lambda_aux=45.0, lambda_feat_match=2.0,
    generator_train_start_steps=0, discriminator_train_start_steps=0)
UPDATES = ("generator_backward", "generator_update",
           "discriminator_backward", "discriminator_update")


def _state(config, device="cpu"):
    gen = build_model("HiFiGANGenerator", GP, seed=0).to(device)
    disc = build_model(config["discriminator_type"], DP, seed=1).to(device)
    return gan.GANTrainState(
        generator=gen, discriminator=disc,
        opt_g=build_optimizer("Adam", OPT, -1, gen.parameters()),
        opt_d=build_optimizer("Adam", OPT, -1, disc.parameters()),
        draws=gan.RandomDraws(0))


def _batch(seed=0, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    b = {"x": (torch.randn(2, 10, 13, generator=g),),
         "y": 0.3 * torch.randn(2, 800, 1, generator=g),
         "ar": 0.3 * torch.randn(2, 64, 1, generator=g)}
    return {"x": (b["x"][0].to(device),), "y": b["y"].to(device),
            "ar": b["ar"].to(device)}


def _run(config, n, device="cpu"):
    """``n`` steps from a fresh state: (the records they made, each step's
    host ns)."""
    state, step = _state(config, device), gan.make_train_step(
        gan.GANCriterion(config), config)
    since, host = trace.resolved(), []
    for k in range(n):
        batch = _batch(k, device)
        start = time.time_ns()
        step(state, batch, 1e-4, 1e-4)
        if device != "cpu":
            torch.cuda.synchronize()
        host.append(time.time_ns() - start)
    return trace.records(since), host


@pytest.mark.parametrize("gen_start,disc_start", [(0, 0), (1, 0), (2, 1)])
def test_each_step_records_the_phases_that_ran(gen_start, disc_start):
    config = dict(CONFIG, generator_train_start_steps=gen_start,
                  discriminator_train_start_steps=disc_start)
    records, _ = _run(config, 3)
    assert [k for k, _ in records] == [0, 1, 2]
    for k, phases in records:
        ran = [p for p in trace.PHASES
               if p not in UPDATES
               or (p.startswith("generator") and k > gen_start)
               or (p.startswith("discriminator") and k > disc_start)]
        # in the step's order, gated-off updates left out
        assert list(phases) == ran, k


def test_phase_ms_tile_the_step():
    records, host = _run(CONFIG, 2)
    for (_, phases), ns in zip(records, host):
        ms = [p.ms for p in phases.values()]
        assert all(m >= 0 for m in ms) and sum(ms) <= ns / 1e6
        # host intervals in order, none overlapping the next
        times = [t for p in phases.values() for t in (p.start_ns, p.end_ns)]
        assert times == sorted(times)


def test_gated_off_updates_record_nothing():
    config = dict(CONFIG, generator_train_start_steps=5,
                  discriminator_train_start_steps=5)
    records, _ = _run(config, 2)
    for _, phases in records:
        assert set(phases) == {"generator_loss", "regeneration",
                               "discriminator_loss"}


def test_ring_stays_bounded():
    since, first = trace.resolved(), 10 ** 6
    for k in range(trace.RING + 50):
        account = trace.StepAccount(first + k, torch.device("cpu"))
        with account.phase("generator_loss"):
            pass
        account.close()
    assert trace.resolved() == since + trace.RING + 50
    kept = trace.records()
    assert len(kept) == trace.RING
    assert kept[0][0] == first + 50 and kept[-1][0] == first + trace.RING + 49
    assert len(trace.records(since + trace.RING + 40)) == 10
    assert list(trace.steps(first + trace.RING + 45)) == [
        first + trace.RING + k for k in range(45, 50)]


def test_no_record_function_without_a_profiler(monkeypatch):
    calls = []
    real = torch.profiler.record_function

    def counting(name, *args):
        calls.append(name)
        return real(name, *args)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    assert trace.span("x") is trace.span("y")
    # step 1 updates both models
    _run(CONFIG, 2)
    assert calls == []
    # under a profiler the same steps open their spans
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        _run(CONFIG, 2)
    assert "train_step/generator_backward" in calls and "generator" in calls


def test_spans_under_a_cpu_profile_share_the_clock():
    state, step = _state(CONFIG), gan.make_train_step(
        gan.GANCriterion(CONFIG), CONFIG)
    step(state, _batch(), 1e-4, 1e-4)
    since = trace.resolved()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        # the process's first range pays a one-off set-up inside its enter
        with torch.profiler.record_function("warm"):
            pass
        for k in range(2):
            step(state, _batch(k), 1e-4, 1e-4)
    ranges = [(e.name(), e.start_ns(), e.end_ns())
              for e in prof.profiler.kineto_results.events()
              if e.is_user_annotation()]
    names = {n for n, _, _ in ranges}
    assert {f"train_step/{p}" for p in trace.PHASES} <= names
    assert {"generator", "discriminator", "aux_loss"} <= names

    def inside(inner, outer):
        return any(s <= a and b <= e for n, s, e in ranges if n == outer
                   for m, a, b in ranges if m == inner)

    assert inside("generator", "train_step/generator_loss")
    assert inside("generator", "train_step/regeneration")
    assert inside("aux_loss", "train_step/generator_loss")
    assert inside("discriminator", "train_step/discriminator_loss")
    records = trace.records(since)
    assert [k for k, _ in records] == [1, 2]
    for k, phases in records:
        for name, p in phases.items():
            starts = [s for n, s, _ in ranges if n == f"train_step/{name}"]
            assert min(abs(s - p.start_ns) for s in starts) < 1e6, name


class _Recorder:
    def __init__(self):
        self.scalars = []

    def add_scalar(self, tag, value, step):
        self.scalars.append((tag, float(value), int(step)))


class _Batches(list):
    def set_epoch(self, epoch):
        del epoch


def test_trainer_writes_the_phase_times(monkeypatch, tmp_path):
    monkeypatch.setattr(Trainer, "save_checkpoint", lambda self, path: None)
    config = dict(CONFIG, train_max_steps=4, log_interval_steps=2,
                  eval_interval_steps=10 ** 6, save_interval_steps=10 ** 6,
                  generator_train_start_steps=2)
    batches = _Batches({k: (tuple(v.numpy() for v in b[k]) if k == "x"
                            else b[k].numpy()) for k in b}
                       for b in (_batch(k) for k in range(4)))
    writer = _Recorder()
    Trainer(config=config, state=_state(config),
            train_step=gan.make_train_step(gan.GANCriterion(config), config),
            eval_step=None,
            schedulers={k: build_scheduler("StepLR", 1e-4, {"step_size": 9})
                        for k in ("generator", "discriminator")},
            data_loader={"train": batches, "dev": []}, outdir=str(tmp_path),
            device=torch.device("cpu"), writer=writer).run()
    times = {(t, s): v for t, v, s in writer.scalars if t.startswith("time/")}
    # steps 0-1 update the discriminator alone, steps 2-3 both models
    assert set(times) == {(f"time/{p}_ms", s) for p in trace.PHASES
                          for s in (2, 4)} - {
        ("time/generator_backward_ms", 2), ("time/generator_update_ms", 2)}
    assert all(v > 0 for v in times.values())


@pytest.mark.gpu
def test_phases_cover_the_step_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    _run(CONFIG, 3, "cuda")
    records, host = _run(CONFIG, 20, "cuda")
    assert len(records) == 20
    share = sum(p.ms for _, ph in records for p in ph.values()) / (
        sum(host) / 1e6)
    assert 0.85 <= share <= 1.0, share
