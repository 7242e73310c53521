"""Data parallelism on two CPU ranks (gloo, a ``file://`` rendezvous under
``tmp_path``): a HiFi-CAR step at ``tests/test_data_parallel.py``'s widths
(SGD, float64), each rank on half of the global batch B 8, against the JAX
package's single-device step on the whole batch (every parameter within
1e-10, both ranks bit-equal); the loader's shards against JAX's
``DataLoader(shard_id, num_shards)``; and a BatchNorm training step on two
ranks against one rank on the global batch.

The ranks import no JAX: the JAX weights and the batch reach them in an
``.npz``, and they write their parameters back in one."""

import functools
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from articulatory_tpu.data.loader import DataLoader as JaxLoader
from articulatory_tpu.models import (
    HiFiGANGenerator as JaxGenerator,
    HiFiGANMultiScaleMultiPeriodDiscriminator as JaxMSMPD,
)
from articulatory_tpu.train import gan as jgan
from articulatory_tpu.train.optimizers import build_optimizer as jax_optimizer
from articulatory_tpu_torch.data.loader import DataLoader
from articulatory_tpu_torch.utils.weights import (
    jax_msmpd_to_state_dict,
    jax_params_to_state_dict,
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
          upsample_kernel_sizes=[10, 8, 4, 4], resblock_kernel_sizes=[3],
          resblock_dilations=[[1]], use_ar=True, ar_input=64, ar_hidden=8,
          ar_output=8)
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
    from articulatory_tpu_torch.parallel import mesh

    mode, root = sys.argv[1], sys.argv[2]
    rank, world = int(sys.argv[3]), int(sys.argv[4])
    mesh.init_distributed(f"file://{root}/rendezvous", world, rank)
    mesh.make_groups(1)
    data = dict(np.load(f"{root}/in.npz", allow_pickle=True))
    out = {}
    if mode == "step":
        from articulatory_tpu_torch.models import build_model
        from articulatory_tpu_torch.train import gan
        from articulatory_tpu_torch.train.optimizers import build_optimizer

        spec = data["spec"].item()
        gen = build_model("HiFiGANGenerator", spec["gp"]).double()
        disc = build_model("HiFiGANMultiScaleMultiPeriodDiscriminator",
                           spec["dp"]).double()
        for model, prefix in ((gen, "g/"), (disc, "d/")):
            model.load_state_dict({k[2:]: torch.tensor(v)
                                   for k, v in data.items()
                                   if k.startswith(prefix)})
        half = slice(4 * rank, 4 * rank + 4)
        batch = {"x": (torch.tensor(data["x"][half]),),
                 "y": torch.tensor(data["y"][half]),
                 "ar": torch.tensor(data["ar"][half])}
        state = gan.GANTrainState(
            generator=gen, discriminator=disc,
            opt_g=build_optimizer("SGD", {}, -1, gen.parameters()),
            opt_d=build_optimizer("SGD", {}, -1, disc.parameters()),
            steps=1)
        step = gan.make_train_step(gan.GANCriterion(spec["config"]),
                                   spec["config"])
        metrics = step(state, batch, spec["lr"], spec["lr"])
        out = {f"g/{k}": v.numpy() for k, v in gen.state_dict().items()}
        out.update({f"d/{k}": v.numpy()
                    for k, v in disc.state_dict().items()})
        out["loss"] = metrics["train/generator_loss"].numpy()
    elif mode == "batchnorm":
        from articulatory_tpu_torch.layers.norm import BatchNorm

        torch.manual_seed(0)
        model = torch.nn.Sequential(torch.nn.Linear(5, 6), BatchNorm(6),
                                    torch.nn.Linear(6, 1)).double()
        mesh.replicate(model)
        n = len(data["x"]) // mesh.world_size()
        x = torch.tensor(data["x"][n * rank:n * (rank + 1)])
        loss = model(x).square().mean()
        loss.backward()
        mesh.all_reduce_grads(model.parameters(), mesh.layout().dp_group)
        with torch.no_grad():
            for p in model.parameters():
                p -= 0.1 * p.grad
        out = {k: v.numpy() for k, v in model.state_dict().items()}
    np.savez(f"{root}/out{rank}.npz", **out)
    mesh.shutdown()
''')


def run_ranks(tmp_path, mode, inputs, n=2):
    """``n`` worker ranks in ``mode`` on ``inputs``; their outputs."""
    np.savez(tmp_path / "in.npz", **inputs)
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=str(ROOT) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen([sys.executable, str(script), mode,
                               str(tmp_path), str(r), str(n)], env=env,
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
    """Initial weights, the global batch B 8 and JAX's SGD step on it
    (float64): (params before, params after, generator loss)."""
    rng = np.random.default_rng(0)
    batch = {"x": rng.standard_normal((8, 10, 13)),
             "y": rng.standard_normal((8, 800, 1)) * 0.1,
             "ar": rng.standard_normal((8, 64, 1)) * 0.1}
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
        new, metrics = step(state, jb, jax.random.PRNGKey(7),
                            jnp.float64(LR), jnp.float64(LR))
        after = jax.device_get((new.params_g, new.params_d))
        loss = float(metrics["train/generator_loss"])
    return jax.device_get((pg, pd)), after, batch, loss


def _state_dicts(params_g, params_d):
    return (jax_params_to_state_dict(params_g, GP),
            jax_msmpd_to_state_dict(params_d, DP))


def test_two_rank_step_matches_jax_single_device(tmp_path):
    (pg, pd), (wg, wd), batch, loss = _jax_setup()
    g0, d0 = _state_dicts(pg, pd)
    inputs = {f"g/{k}": v.numpy() for k, v in g0.items()}
    inputs.update({f"d/{k}": v.numpy() for k, v in d0.items()})
    inputs.update(batch)
    inputs["spec"] = np.array({"gp": GP, "dp": DP, "config": CONFIG,
                               "lr": LR}, dtype=object)
    outs = run_ranks(tmp_path, "step", inputs)
    for key in outs[0]:  # the ranks hold the same parameters
        if key != "loss":
            np.testing.assert_array_equal(outs[0][key], outs[1][key], key)
    # the ranks' mean loss is the global batch's
    np.testing.assert_allclose((outs[0]["loss"] + outs[1]["loss"]) / 2,
                               loss, rtol=1e-10)
    want_g, want_d = _state_dicts(wg, wd)
    moved = 0
    for prefix, want, before in (("g/", want_g, g0), ("d/", want_d, d0)):
        for key, value in want.items():
            got = outs[0][prefix + key]
            np.testing.assert_allclose(got, value.numpy(), rtol=1e-10,
                                       atol=1e-10, err_msg=prefix + key)
            moved += not np.array_equal(got, before[key].numpy())
    assert moved > 10  # the step updated both models


@pytest.mark.parametrize("n,shuffle,drop_last", [
    (11, True, False),  # a wrapped tail: 11 items over 2 shards
    (11, True, True),
    (8, False, False),
])
def test_loader_shards_match_jax(n, shuffle, drop_last):
    items = list(range(n))
    for shard in range(2):
        kwargs = dict(batch_size=2, shuffle=shuffle, drop_last=drop_last,
                      collate_fn=list, seed=5, shard_id=shard, num_shards=2)
        ours, theirs = DataLoader(items, **kwargs), JaxLoader(items, **kwargs)
        for epoch in (0, 1):
            ours.set_epoch(epoch)
            theirs.set_epoch(epoch)
            got, want = list(ours), [list(map(int, b)) for b in theirs]
            assert [list(map(int, b)) for b in got] == want
            assert len(ours) == len(theirs) == len(want)


def test_sharded_batch_sampler_raises():
    with pytest.raises(ValueError, match="batch_sampler"):
        DataLoader(list(range(4)), batch_sampler=[[0, 1], [2, 3]],
                   num_shards=2)


def test_two_rank_batchnorm_step_matches_global_batch(tmp_path):
    """BatchNorm reduces its statistics over the global batch: a step on
    two ranks (half the batch each, the gradients averaged) equals one
    rank's on the whole batch, running statistics included."""
    x = np.random.default_rng(3).standard_normal((8, 7, 5))
    two = run_ranks(tmp_path, "batchnorm", {"x": x})
    one_dir = tmp_path / "one"
    one_dir.mkdir()
    one = run_ranks(one_dir, "batchnorm", {"x": x}, n=1)[0]
    for key, value in one.items():
        np.testing.assert_array_equal(two[0][key], two[1][key], key)
        np.testing.assert_allclose(two[0][key], value, rtol=1e-12,
                                   atol=1e-14, err_msg=key)
    assert one["1.num_batches_tracked"] == 1
