"""Tensor parallelism (``parallel/tp.py``) on two CPU ranks (gloo, a
``file://`` rendezvous under ``tmp_path``): a ``tensor_parallel: 2`` step of
a HiFi-CAR with two MRF blocks, its generator split between the ranks,
gathered full afterwards and held against the JAX package's single-device
step (SGD, float64, 1e-10) and, with ``grad_norm`` clipping, against the
port's one-rank step; the split and gather of state dicts
(``utils/weights.py``), round trip; and ``bin/train.py --tensor-parallel 2``
through the launcher for one step against the one-process run."""

import functools
import os
import pathlib
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from articulatory_tpu.models import (
    HiFiGANGenerator as JaxGenerator,
    HiFiGANMultiScaleMultiPeriodDiscriminator as JaxMSMPD,
)
from articulatory_tpu.train import gan as jgan
from articulatory_tpu.train.optimizers import build_optimizer as jax_optimizer
from articulatory_tpu_torch.bin import train as train_cli
from articulatory_tpu_torch.models import build_model
from articulatory_tpu_torch.utils.checkpoint import load_checkpoint
from articulatory_tpu_torch.utils.weights import (
    block_owners,
    gather_tp_state_dicts,
    jax_msmpd_to_state_dict,
    jax_params_to_state_dict,
    split_tp_state_dict,
)

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
_jit = functools.partial(jax.jit, compiler_options={
    "xla_backend_optimization_level": 0,
    "xla_llvm_disable_expensive_passes": True})

CONFIG = {
    "dataset_mode": "a2w", "batch_max_steps": 800, "hop_size": 80,
    "use_stft_loss": False, "use_mel_loss": True,
    "mel_loss_params": {"fs": 16000, "fft_size": 256, "hop_size": 80,
                        "num_mels": 20, "fmin": 0, "fmax": 8000},
    "use_feat_match_loss": True,
    "feat_match_loss_params": {"average_by_discriminators": False,
                               "average_by_layers": False},
    "generator_adv_loss_params": {"average_by_discriminators": False},
    "discriminator_adv_loss_params": {"average_by_discriminators": False},
    "lambda_aux": 45.0, "lambda_adv": 1.0, "lambda_feat_match": 2.0,
    "generator_train_start_steps": 0, "discriminator_train_start_steps": 0,
    "generator_params": {"out_channels": 1, "use_ar": True, "ar_input": 64},
}
GP = dict(in_channels=13 + 8, channels=16, upsample_scales=[5, 4, 2, 2],
          upsample_kernel_sizes=[10, 8, 4, 4], resblock_kernel_sizes=[3, 5],
          resblock_dilations=[[1, 3], [1]], use_ar=True, ar_input=64,
          ar_hidden=8, ar_output=8)
DP = dict(scales=1, scale_discriminator_params={
    "channels": 8, "max_downsample_channels": 16, "max_groups": 2},
    periods=[2], period_discriminator_params={"channels": 2,
                                              "max_downsample_channels": 4})
LR = 1e-3

WORKER = textwrap.dedent('''
    import sys

    import numpy as np
    import torch

    torch.set_num_threads(1)
    from articulatory_tpu_torch.models import build_model
    from articulatory_tpu_torch.parallel import mesh, tp
    from articulatory_tpu_torch.train import gan
    from articulatory_tpu_torch.train.optimizers import build_optimizer

    root, rank, world = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    mesh.init_distributed(f"file://{root}/rendezvous", world, rank)
    lay = mesh.make_groups(world)  # one TP group of every rank
    data = dict(np.load(f"{root}/in.npz", allow_pickle=True))
    spec = data["spec"].item()
    out = {}
    for case, grad_norm in (("plain", -1), ("clipped", spec["clip"])):
        gen = build_model("HiFiGANGenerator", spec["gp"]).double()
        disc = build_model("HiFiGANMultiScaleMultiPeriodDiscriminator",
                           spec["dp"]).double()
        for model, prefix in ((gen, "g/"), (disc, "d/")):
            model.load_state_dict({k[2:]: torch.tensor(v)
                                   for k, v in data.items()
                                   if k.startswith(prefix)})
        tp.shard_generator_(gen, lay.tp_group, lay.tp_rank, lay.tp)
        opt_g = build_optimizer("SGD", {}, grad_norm, gen.parameters())
        opt_g.norm_fn = tp.clip_norm_fn(gen)
        state = gan.GANTrainState(
            generator=gen, discriminator=disc, opt_g=opt_g,
            opt_d=build_optimizer("SGD", {}, grad_norm, disc.parameters()),
            steps=1)
        batch = {"x": (torch.tensor(data["x"]),),
                 "y": torch.tensor(data["y"]), "ar": torch.tensor(data["ar"])}
        step = gan.make_train_step(gan.GANCriterion(spec["config"]),
                                   spec["config"])
        step(state, batch, spec["lr"], spec["lr"])
        full = tp.full_state(gen)[0]
        out.update({f"{case}/g/{k}": v.numpy() for k, v in full.items()})
        out.update({f"{case}/d/{k}": v.numpy()
                    for k, v in disc.state_dict().items()})
        out[f"{case}/held"] = sum(p.numel() for p in gen.parameters())
    np.savez(f"{root}/out{rank}.npz", **out)
    mesh.shutdown()
''')


def run_ranks(tmp_path, inputs, n):
    np.savez(tmp_path / "in.npz", **inputs)
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=str(ROOT) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen([sys.executable, str(script), str(tmp_path),
                               str(r), str(n)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(n)]
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=120)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    return [dict(np.load(tmp_path / f"out{r}.npz")) for r in range(n)]


def _random(init, rng, *args, **kwargs):
    """Parameters of ``init``'s shapes drawn from N(0, 0.3^2)."""
    shapes = jax.eval_shape(init, *args, **kwargs)["params"]
    return jax.tree.map(lambda s: 0.3 * rng.standard_normal(s.shape),
                        shapes)


def _tuples(d):
    return {k: tuple(map(tuple, v)) if k == "resblock_dilations"
            else tuple(v) if isinstance(v, list) else v for k, v in d.items()}


@functools.cache
def _jax_setup():
    rng = np.random.default_rng(0)
    batch = {"x": rng.standard_normal((4, 10, 13)),
             "y": rng.standard_normal((4, 800, 1)) * 0.1,
             "ar": rng.standard_normal((4, 64, 1)) * 0.1}
    gen, disc = JaxGenerator(**_tuples(GP)), JaxMSMPD(**_tuples(DP))
    with jax.enable_x64(True):
        cast = functools.partial(jax.tree.map,
                                 lambda a: jnp.asarray(a, jnp.float64))
        # random weights of the models' shapes (no init to compile)
        key = jax.random.PRNGKey(0)
        pg = cast(_random(gen.init, rng, key, jnp.zeros((1, 10, 13)),
                          ar=jnp.zeros((1, 64, 1))))
        pd = cast(_random(disc.init, rng, {"params": key, "window": key},
                          jnp.zeros((1, 864, 1))))
        tx = jax_optimizer("SGD", {})
        state = jgan.GANTrainState(params_g=pg, params_d=pd,
                                   opt_g=tx.init(pg), opt_d=tx.init(pd),
                                   steps=jnp.asarray(1, jnp.int32))
        step = _jit(jgan.make_train_step(gen, disc, jgan.GANCriterion(CONFIG),
                                         CONFIG, tx, tx))
        jb = {"x": (jnp.asarray(batch["x"]),), "y": jnp.asarray(batch["y"]),
              "ar": jnp.asarray(batch["ar"])}
        new, _ = step(state, jb, jax.random.PRNGKey(7), jnp.float64(LR),
                      jnp.float64(LR))
        after = jax.device_get((new.params_g, new.params_d))
    return jax.device_get((pg, pd)), after, batch


def _inputs():
    (pg, pd), _, batch = _jax_setup()
    inputs = {f"g/{k}": v.numpy()
              for k, v in jax_params_to_state_dict(pg, GP).items()}
    inputs.update({f"d/{k}": v.numpy()
                   for k, v in jax_msmpd_to_state_dict(pd, DP).items()})
    inputs.update(batch)
    inputs["spec"] = np.array({"gp": GP, "dp": DP, "config": CONFIG,
                               "lr": LR, "clip": 1e-3}, dtype=object)
    return inputs


def _one_rank(inputs) -> dict:
    """The worker's steps in this process, unsplit."""
    from articulatory_tpu_torch.train import gan
    from articulatory_tpu_torch.train.optimizers import build_optimizer

    spec = inputs["spec"].item()
    out = {}
    for case, grad_norm in (("plain", -1), ("clipped", spec["clip"])):
        models = {}
        for prefix, kind, params in (
                ("g/", "HiFiGANGenerator", GP),
                ("d/", "HiFiGANMultiScaleMultiPeriodDiscriminator", DP)):
            models[prefix] = build_model(kind, params).double()
            models[prefix].load_state_dict({
                k[2:]: torch.tensor(v) for k, v in inputs.items()
                if k.startswith(prefix)})
        gen, disc = models["g/"], models["d/"]
        state = gan.GANTrainState(
            generator=gen, discriminator=disc,
            opt_g=build_optimizer("SGD", {}, grad_norm, gen.parameters()),
            opt_d=build_optimizer("SGD", {}, grad_norm, disc.parameters()),
            steps=1)
        batch = {"x": (torch.tensor(inputs["x"]),),
                 "y": torch.tensor(inputs["y"]),
                 "ar": torch.tensor(inputs["ar"])}
        gan.make_train_step(gan.GANCriterion(CONFIG), CONFIG)(
            state, batch, LR, LR)
        for prefix, model in models.items():
            out.update({f"{case}/{prefix}{k}": v.numpy()
                        for k, v in model.state_dict().items()})
        out[f"{case}/held"] = sum(p.numel() for p in gen.parameters())
    return out


def test_two_rank_tp_step_matches_jax_and_one_rank(tmp_path):
    (two, other) = run_ranks(tmp_path, _inputs(), 2)
    one = _one_rank(_inputs())
    _, (wg, wd), _ = _jax_setup()
    want = {f"g/{k}": v.numpy()
            for k, v in jax_params_to_state_dict(wg, GP).items()}
    want.update({f"d/{k}": v.numpy()
                 for k, v in jax_msmpd_to_state_dict(wd, DP).items()})
    for key, value in want.items():
        np.testing.assert_allclose(two[f"plain/{key}"], value, rtol=1e-10,
                                   atol=1e-10, err_msg=key)
    for key in one:
        if key.endswith("/held"):
            continue
        # the gathered state is the same on both ranks
        np.testing.assert_array_equal(two[key], other[key], key)
        np.testing.assert_allclose(two[key], one[key], rtol=1e-10,
                                   atol=1e-12, err_msg=key)
    # clipping by the global norm moved the weights less than the plain step
    key = "g/input_conv.weight_v"
    assert (np.abs(two[f"clipped/{key}"] - _inputs()[key]).max()
            < np.abs(two[f"plain/{key}"] - _inputs()[key]).max())
    # each rank holds about half of the generator
    full = one["plain/held"]
    for held in (two["plain/held"], other["plain/held"]):
        assert 0.3 * full < held < 0.75 * full


@pytest.mark.parametrize("size", [2, 3])
def test_split_and_gather_state_dicts_round_trip(size):
    gp = dict(GP, resblock_kernel_sizes=[3, 7, 11],
              resblock_dilations=[[1, 3, 5]] * 3)
    full = build_model("HiFiGANGenerator", gp).state_dict()
    parts = [split_tp_state_dict(full, gp, r, size) for r in range(size)]
    back = gather_tp_state_dicts(parts, gp)
    assert list(back) == list(full)
    for key, value in full.items():
        assert torch.equal(back[key], value), key
    # the blocks are whole on their owners, balanced by taps
    owners = block_owners([3, 7, 11], size)
    assert owners == ([0, 0, 1] if size == 2 else [0, 1, 2])
    for n in range(12):
        key = f"blocks.{n}.convs1.0.1.weight_v"
        assert [key in p for p in parts] == [owners[n % 3] == r
                                             for r in range(size)]
    # a split input channel range each
    widths = [p["upsamples.0.1.weight_v"].shape[0] for p in parts]
    assert sum(widths) == 16 and max(widths) - min(widths) <= 1


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_train_cli_tensor_parallel_through_the_launcher(tmp_path):
    rng = np.random.default_rng(0)
    for stage in ("tr", "dev"):
        dump, data = tmp_path / "dump" / stage, tmp_path / "data" / stage
        dump.mkdir(parents=True)
        data.mkdir(parents=True)
        lines = []
        for i in range(2):
            np.save(dump / f"u{i}-wave.npy",
                    (0.3 * rng.standard_normal(2400)).astype(np.float32))
            np.save(dump / f"u{i}-feats.npy", np.zeros((30, 13), np.float32))
            np.save(data / f"u{i}.npy",
                    rng.standard_normal((30, 13)).astype(np.float32))
            lines.append(f"u{i} {data / f'u{i}.npy'}\n")
        (data / "feats.scp").write_text("".join(lines))
    config = dict(
        CONFIG, sampling_rate=16000, format="npy",
        generator_type="HiFiGANGenerator",
        generator_params=dict(GP, out_channels=1),
        discriminator_type="HiFiGANMultiScaleMultiPeriodDiscriminator",
        discriminator_params=DP, batch_size=2, num_workers=0,
        generator_optimizer_type="SGD",
        generator_optimizer_params=dict(lr=1e-3),
        discriminator_optimizer_type="SGD",
        discriminator_optimizer_params=dict(lr=1e-3),
        generator_scheduler_type="MultiStepLR",
        generator_scheduler_params=dict(gamma=0.5, milestones=[10]),
        discriminator_scheduler_type="MultiStepLR",
        discriminator_scheduler_params=dict(gamma=0.5, milestones=[10]),
        generator_grad_norm=1.0, train_max_steps=1, save_interval_steps=1,
        eval_interval_steps=1, log_interval_steps=1,
        num_save_intermediate_results=0)
    path = tmp_path / "config.yaml"
    path.write_text(yaml.dump(config))
    common = ["--train-dumpdir", str(tmp_path / "dump/tr"),
              "--dev-dumpdir", str(tmp_path / "dump/dev"), "--config",
              str(path), "--data-root", str(tmp_path / "data"), "--device",
              "cpu", "--verbose", "0"]
    env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run(
        [sys.executable, "-m", "articulatory_tpu_torch.distributed.launch",
         "--nproc_per_node", "2", "--master_port", str(_free_port()),
         "articulatory_tpu_torch/bin/train.py", *common, "--outdir",
         str(tmp_path / "tp"), "--tensor-parallel", "2"],
        env=env, capture_output=True, text=True, timeout=180, cwd=ROOT)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "tensor parallel rank 1 of 2" in proc.stderr
    train_cli.main(common + ["--outdir", str(tmp_path / "one")])
    got = load_checkpoint(str(tmp_path / "tp/checkpoint-1steps.ckpt"))
    want = load_checkpoint(str(tmp_path / "one/checkpoint-1steps.ckpt"))
    # written full: the one-rank run's keys and shapes, and its values up
    # to float32 summation order
    for model in ("generator", "discriminator"):
        assert list(got["model"][model]) == list(want["model"][model])
        for key, value in want["model"][model].items():
            np.testing.assert_allclose(got["model"][model][key].numpy(),
                                       value.numpy(), rtol=1e-4, atol=1e-6,
                                       err_msg=key)
    assert len(got["optimizer"]["generator"]["param_groups"][0]["params"]) \
        == len(want["optimizer"]["generator"]["param_groups"][0]["params"])
