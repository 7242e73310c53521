"""The rest of the training loop: the SIGTERM preemption handler (a
subprocess of ``bin/train.py``), the ``profile_steps`` window, and resuming
a JAX checkpoint: optax Adam / AdamW states carried into ``torch.optim``
(one more update from the carried state leaves the parameters equal in
float64 at 1e-10), a JAX checkpoint file resumed by ``train()`` with its
steps, epochs and schedulers, and the refusal of a state torch keeps and
optax does not (ASGD's average past its start). The JAX trees come from ``jax.eval_shape`` of
the models' inits (no model is compiled) filled with seeded values; the
optax updates are compiled at XLA's lowest optimisation level."""

import os
import signal
import subprocess
import sys
import threading
import time

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from articulatory_tpu import models as jax_models
from articulatory_tpu.train.gan import GANTrainState
from articulatory_tpu.train.optimizers import build_optimizer as jax_optimizer
from articulatory_tpu.train.schedulers import build_scheduler as jax_scheduler
from articulatory_tpu.utils.checkpoint import save_checkpoint as jax_save
from articulatory_tpu_torch.bin import train as train_cli
from articulatory_tpu_torch.models import build_model
from articulatory_tpu_torch.train.optimizers import (
    build_optimizer,
    load_optax_state,
)
from articulatory_tpu_torch.utils.checkpoint import (
    load_checkpoint,
    optax_moments,
)
from articulatory_tpu_torch.utils.weights import jax_params_to_state_dict

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GP = dict(in_channels=13 + 8, out_channels=1, channels=16, kernel_size=7,
          upsample_scales=[5, 4, 2, 2], upsample_kernel_sizes=[10, 8, 4, 4],
          resblock_kernel_sizes=[3], resblock_dilations=[[1, 3]],
          use_ar=True, ar_input=64, ar_hidden=8, ar_output=8)
DP = dict(scales=1, scale_discriminator_params=dict(
    channels=128, max_downsample_channels=128, downsample_scales=[4, 1]),
    periods=[2], period_discriminator_params=dict(
        channels=4, max_downsample_channels=8, downsample_scales=[3, 1]))
OPT = dict(lr=1e-4, betas=[0.5, 0.9])
SCHED = dict(gamma=0.5, milestones=[2])
CONFIG = dict(
    sampling_rate=16000, hop_size=80, dataset_mode="a2w", format="npy",
    generator_type="HiFiGANGenerator", generator_params=GP,
    discriminator_type="HiFiGANMultiScaleMultiPeriodDiscriminator",
    discriminator_params=DP, use_stft_loss=False, use_mel_loss=True,
    mel_loss_params=dict(fs=16000, fft_size=256, hop_size=64, num_mels=20,
                         fmin=0, fmax=11025, log_base=None),
    generator_adv_loss_params=dict(average_by_discriminators=False),
    discriminator_adv_loss_params=dict(average_by_discriminators=False),
    use_feat_match_loss=True, lambda_aux=45.0, lambda_feat_match=2.0,
    batch_size=2, batch_max_steps=800, num_workers=0, allow_cache=True,
    generator_optimizer_type="Adam", generator_optimizer_params=OPT,
    generator_scheduler_type="MultiStepLR", generator_scheduler_params=SCHED,
    discriminator_optimizer_type="Adam", discriminator_optimizer_params=OPT,
    discriminator_scheduler_type="MultiStepLR",
    discriminator_scheduler_params=SCHED,
    generator_train_start_steps=1, discriminator_train_start_steps=0,
    train_max_steps=2, save_interval_steps=100000,
    eval_interval_steps=100000, log_interval_steps=1)


def _dump(root, n_utts=3, frames=30):
    """``dump/<set>/norm/<utt>-{wave,feats}.npy`` and ``data/<set>/feats.scp``
    under root."""
    rng = np.random.default_rng(0)
    for stage in ("tr", "dev"):
        dump, data = root / "dump" / stage / "norm", root / "data" / stage
        dump.mkdir(parents=True)
        data.mkdir(parents=True)
        lines = []
        for i in range(n_utts):
            np.save(dump / f"u{i}-wave.npy",
                    (0.3 * rng.standard_normal(frames * 80)).astype(np.float32))
            np.save(dump / f"u{i}-feats.npy", np.zeros((frames, 13),
                                                       np.float32))
            art = data / f"u{i}.npy"
            np.save(art, rng.standard_normal((frames, 13)).astype(np.float32))
            lines.append(f"u{i} {art}\n")
        (data / "feats.scp").write_text("".join(lines))


def _dirs(root):
    return dict(train_dumpdir=str(root / "dump/tr/norm"),
                dev_dumpdir=str(root / "dump/dev/norm"),
                data_root=str(root / "data"))


def _cli_args(root, outdir, config_path, *extra):
    d = _dirs(root)
    return ["--train-dumpdir", d["train_dumpdir"], "--dev-dumpdir",
            d["dev_dumpdir"], "--data-root", d["data_root"], "--outdir",
            str(outdir), "--config", str(config_path), "--device", "cpu",
            *extra]


def _signal_after(proc, marker, sig, timeout):
    """Sends ``sig`` once a line of ``proc``'s stderr holds ``marker`` and
    returns its whole stderr when it has exited. A reader thread takes the
    lines; past ``timeout`` seconds the child is killed and the test fails
    with the tail of its stderr."""
    lines, seen = [], threading.Event()

    def read():
        for line in proc.stderr:
            lines.append(line)
            if marker in line:
                seen.set()

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    deadline = time.monotonic() + timeout
    try:
        while not seen.wait(0.2):
            if proc.poll() is not None:
                reader.join()
                assert seen.is_set(), f"exit {proc.returncode} before {marker}"
            assert time.monotonic() < deadline, f"no {marker} in {timeout} s"
        proc.send_signal(sig)
        proc.wait(max(deadline - time.monotonic(), 1.0))
    except (AssertionError, subprocess.TimeoutExpired) as e:
        proc.kill()
        proc.wait()
        reader.join()
        raise AssertionError(f"{e}: {''.join(lines)[-2000:]}") from e
    reader.join()
    return "".join(lines)


def test_sigterm_checkpoints_and_resume_goes_on(tmp_path):
    _dump(tmp_path)
    config_path = tmp_path / "config.yaml"
    config_path.write_text(yaml.dump(dict(CONFIG, train_max_steps=100000)))
    out = tmp_path / "exp"
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen(
        [sys.executable, "-m", "articulatory_tpu_torch.bin.train",
         *_cli_args(tmp_path, out, config_path)], env=env, cwd=ROOT,
        stderr=subprocess.PIPE, text=True)
    rest = _signal_after(proc, "(Steps: 2)", signal.SIGTERM, 240.0)
    assert proc.returncode == 0, rest
    assert "SIGTERM received" in rest
    ckpts = sorted(out.glob("checkpoint-*steps.ckpt"))
    assert len(ckpts) == 1, ckpts
    steps = load_checkpoint(str(ckpts[0]))["steps"]
    assert ckpts[0].name == f"checkpoint-{steps}steps.ckpt" and steps >= 2

    config_path.write_text(yaml.dump(dict(CONFIG, train_max_steps=steps + 1)))
    train_cli.main(_cli_args(tmp_path, out, config_path, "--resume",
                             str(ckpts[0]), "--verbose", "0"))
    assert load_checkpoint(str(out / f"checkpoint-{steps + 1}steps.ckpt")
                           )["steps"] == steps + 1


def test_profile_window_writes_a_trace(tmp_path):
    _dump(tmp_path)
    out = tmp_path / "exp"
    config = dict(CONFIG, train_max_steps=3, profile_steps=[1, 2])
    trainer = train_cli.train(config, outdir=str(out), device="cpu",
                              **_dirs(tmp_path))
    assert (out / "profile" / "trace-1-2.json").stat().st_size > 0
    assert not trainer._profiling and len(trainer.profiler.key_averages()) > 0
    # a resume landing inside a window opens it; the run's end closes it
    config = dict(CONFIG, train_max_steps=4, profile_steps=[0, 10])
    train_cli.train(config, outdir=str(out), device="cpu",
                    resume=str(out / "checkpoint-3steps.ckpt"),
                    **_dirs(tmp_path))
    assert (out / "profile" / "trace-0-10.json").exists()


def test_profile_trace_holds_the_step_spans(tmp_path):
    _dump(tmp_path)
    out = tmp_path / "exp"
    # step 2 updates both models (generator_train_start_steps 1)
    config = dict(CONFIG, train_max_steps=3, profile_steps=[2, 3])
    train_cli.train(config, outdir=str(out), device="cpu", **_dirs(tmp_path))
    text = (out / "profile" / "trace-2-3.json").read_text()
    for name in ("train_step/generator_backward",
                 "train_step/discriminator_update", "generator",
                 "discriminator", "aux_loss"):
        assert f'"name": "{name}"' in text, name


def _jax_trees(seed, dtype=np.float32):
    """Seeded JAX generator and discriminator param trees of the test's
    configuration (shapes from ``jax.eval_shape``)."""
    gen = jax_models.build_model("HiFiGANGenerator", GP)
    disc = jax_models.build_model(CONFIG["discriminator_type"], DP)
    key = jax.random.PRNGKey(0)
    x = jnp.zeros((1, 10, 13), jnp.float32)
    ar = jnp.zeros((1, GP["ar_input"], 1), jnp.float32)
    shapes = (jax.eval_shape(lambda: gen.init(key, x, ar=ar))["params"],
              jax.eval_shape(lambda: disc.init(
                  {"params": key, "window": key},
                  jnp.zeros((1, 864, 1), jnp.float32)))["params"])
    rng = np.random.default_rng(seed)
    return [jax.tree.map(lambda s: (0.1 * rng.standard_normal(s.shape)
                                    ).astype(dtype), tree) for tree in shapes]


def _random_like(tree, rng):
    return jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(a.dtype),
                        tree)


def _jax_updater(tx, lr):
    """``(params, state, grads) -> (params, state)``: one update as the JAX
    package's train step applies it, compiled once at XLA's lowest backend
    optimisation level."""
    def update(params, state, grads):
        updates, state = tx.update(grads, state, params)
        return optax.apply_updates(params, jax.tree.map(lambda u: -lr * u,
                                                        updates)), state

    return jax.jit(update, compiler_options={
        "xla_backend_optimization_level": 0,
        "xla_llvm_disable_expensive_passes": True})


@pytest.mark.parametrize("name,params,clip", [
    ("Adam", dict(OPT), -1),
    ("Adam", dict(OPT, weight_decay=1e-2), 0.5),
    ("AdamW", dict(weight_decay=1e-2), -1)])
def test_optax_state_carries_into_torch(name, params, clip):
    lr, rng = 1e-2, np.random.default_rng(1)
    config = dict(CONFIG, generator_optimizer_type=name)
    with jax.enable_x64(True):
        tree = _jax_trees(2, np.float64)[0]
        tx = jax_optimizer(name, dict(params, lr=lr), clip)
        state, update = tx.init(tree), _jax_updater(tx, lr)
        for _ in range(3):
            tree, state = update(tree, state, _random_like(tree, rng))
        saved = jax.tree.map(np.asarray,
                             flax.serialization.to_state_dict(state))
        gen = build_model("HiFiGANGenerator", GP).double()
        gen.load_state_dict(jax_params_to_state_dict(tree, GP))
        opt = build_optimizer(name, dict(params, lr=lr), clip,
                              gen.parameters())
        moments = optax_moments({"model": {"generator": tree}, "steps": 3},
                                "generator", config, gen)
        load_optax_state(opt, name, saved, moments, gen)
        grads = _random_like(tree, rng)
        tree, _ = update(tree, state, grads)
    for key, g in moments(grads).items():
        dict(gen.named_parameters())[key].grad = g.double()
    opt.step(lr)
    want = jax_params_to_state_dict(tree, GP)
    assert all(int(s["step"]) == 4 for s in opt.optimizer.state.values())
    for key, p in gen.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[key].numpy(),
                                   rtol=0, atol=1e-10, err_msg=key)


def _jax_checkpoint(path, optimizer="Adam", params=OPT, d_updates=2):
    """A JAX checkpoint after 2 steps: one generator and (by default) two
    discriminator updates, both schedulers stepped accordingly, epochs 1."""
    rng = np.random.default_rng(3)
    params_g, params_d = _jax_trees(4)
    tx = jax_optimizer(optimizer, dict(params), -1)
    opt_g, opt_d = tx.init(params_g), tx.init(params_d)
    update = _jax_updater(tx, 1e-4)
    params_g, opt_g = update(params_g, opt_g, _random_like(params_g, rng))
    for _ in range(d_updates):
        params_d, opt_d = update(params_d, opt_d, _random_like(params_d, rng))
    schedulers = {k: jax_scheduler("MultiStepLR", 1e-4, SCHED)
                  for k in ("generator", "discriminator")}
    schedulers["generator"].step(None)
    for _ in range(2):
        schedulers["discriminator"].step(None)
    state = GANTrainState(params_g=params_g, params_d=params_d, opt_g=opt_g,
                          opt_d=opt_d, steps=jnp.asarray(2, jnp.int32))
    jax_save(str(path), state, schedulers=schedulers, epochs=1)
    return params_g, opt_g


def test_train_resumes_a_jax_checkpoint(tmp_path):
    _dump(tmp_path)
    params_g, opt_g = _jax_checkpoint(tmp_path / "jax.ckpt")
    payload = load_checkpoint(str(tmp_path / "jax.ckpt"))
    # the state carried over, before any step
    from articulatory_tpu_torch.train.gan import GANTrainState as State
    from articulatory_tpu_torch.train.schedulers import build_scheduler
    from articulatory_tpu_torch.utils.checkpoint import restore_state

    gen = build_model("HiFiGANGenerator", GP)
    disc = build_model(CONFIG["discriminator_type"], DP)
    state = State(generator=gen, discriminator=disc,
                  opt_g=build_optimizer("Adam", OPT, -1, gen.parameters()),
                  opt_d=build_optimizer("Adam", OPT, -1, disc.parameters()),
                  draws=None)
    schedulers = {k: build_scheduler("MultiStepLR", 1e-4, SCHED)
                  for k in ("generator", "discriminator")}
    assert restore_state(state, payload, CONFIG, schedulers=schedulers) == 1
    assert state.steps == 2
    assert [schedulers[k].step_count for k in ("generator",
                                               "discriminator")] == [1, 2]
    assert schedulers["discriminator"].lr == pytest.approx(5e-5)
    mu = jax_params_to_state_dict(opt_g[0].mu, GP)
    for key, p in gen.named_parameters():
        torch.testing.assert_close(p.data, jax_params_to_state_dict(
            params_g, GP)[key], rtol=0, atol=0)
        s = state.opt_g.optimizer.state[p]
        assert int(s["step"]) == 1 and s["step"].dtype == torch.float32
        torch.testing.assert_close(s["exp_avg"], mu[key], rtol=0, atol=0)

    out = tmp_path / "exp"
    trainer = train_cli.train(dict(CONFIG, train_max_steps=3), outdir=str(out),
                              resume=str(tmp_path / "jax.ckpt"), device="cpu",
                              **_dirs(tmp_path))
    assert trainer.steps == 3
    last = load_checkpoint(str(out / "checkpoint-3steps.ckpt"))
    # the run ends inside its second epoch (one batch an epoch)
    assert last["steps"] == 3 and last["epochs"] == 1
    assert [last["scheduler"][m]["step_count"]
            for m in ("generator", "discriminator")] == [2, 3]
    assert {m: max(int(s["step"]) for s in last["optimizer"][m]["state"]
                   .values()) for m in ("generator", "discriminator")} == {
        "generator": 2, "discriminator": 3}


def test_jax_resume_refuses_other_optimizers(tmp_path):
    """Every optimizer of the JAX package resumes (the others in
    ``tests/test_torch_port_optax_resume.py``) but where torch keeps a state
    optax does not: ASGD's averaged iterate, once past ``t0`` + 2 updates
    (here the discriminator's 4 with t0 1)."""
    params = dict(lr=1e-4, t0=1)
    _jax_checkpoint(tmp_path / "jax.ckpt", optimizer="ASGD", params=params,
                    d_updates=4)
    _dump(tmp_path)
    config = dict(CONFIG, generator_optimizer_type="ASGD",
                  discriminator_optimizer_type="ASGD",
                  generator_optimizer_params=params,
                  discriminator_optimizer_params=params)
    with pytest.raises(NotImplementedError, match="ASGD"):
        train_cli.train(config, outdir=str(tmp_path / "exp"), device="cpu",
                        resume=str(tmp_path / "jax.ckpt"), **_dirs(tmp_path))
