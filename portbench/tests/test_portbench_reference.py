"""The plain reference against the port in float64 at a tiny size on the
CPU: the generator's chunk step (the forward and the carry it hands on)
and the training step. Only this test imports both."""

import pytest
import torch

from conftest import CPU, tiny
from portbench.core import seeds
from portbench.reference import decode
from portbench.reference.discriminators import discriminator_shapes
from portbench.reference.hifigan import generator, generator_shapes
from portbench.reference.train import Trainer


def double(weights):
    return {k: v.double() for k, v in weights.items()}


def port_model(name, params, weights):
    from articulatory_tpu_torch.models import build_model
    model = build_model(name, params).double()
    model.load_state_dict(weights, strict=True)
    return model


@pytest.mark.parametrize("name", ["ema-decode-b64", "mri-decode-hybrid-b16"])
def test_generator_chunk_step(name):
    from articulatory_tpu_torch.inference import chunk_step, chunking
    m = tiny(name).model
    gp = dict(m["generator_params"], compute_dtype=None,
              hybrid_precision=False)
    w = double(seeds.make_weights(generator_shapes(gp), 3, CPU, "g"))
    gen = port_model(m["generator_type"], gp, w).eval()
    frames, samples, carry = decode.chunking(m)
    g = torch.Generator().manual_seed(0)
    feat = gp["in_channels"] - gp["ar_output"]
    c = torch.randn((2, 2 * frames, feat), generator=g, dtype=torch.float64)
    prev = torch.zeros((2, carry, 1), dtype=torch.float64)
    ck = chunking(m)
    with torch.no_grad():
        for k in range(2):
            cin = c[:, k * frames:(k + 1) * frames]
            want = generator(w, gp, cin, prev[..., 0], "f64")
            out, prev = chunk_step(lambda x, a: gen(x, a), cin, prev, ck)
            assert torch.allclose(out[..., 0], want, rtol=0, atol=1e-12)
            assert torch.equal(prev[..., 0], out[:, -carry:, 0])


def test_training_steps():
    from articulatory_tpu_torch.train import gan
    from articulatory_tpu_torch.train.optimizers import build_optimizer
    cell = tiny("ema-train-b64")
    m = cell.model
    gw = double(seeds.make_weights(generator_shapes(m["generator_params"]),
                                   4, CPU, "g"))
    dw = double(seeds.make_weights(discriminator_shapes(
        m["discriminator_params"]), 4, CPU, "d"))
    gen = port_model(m["generator_type"], m["generator_params"], gw)
    disc = port_model(m["discriminator_type"], m["discriminator_params"], dw)
    opts = [build_optimizer("Adam", m[f"{n}_optimizer_params"], -1,
                            mod.parameters())
            for n, mod in (("generator", gen), ("discriminator", disc))]
    state = gan.GANTrainState(generator=gen, discriminator=disc,
                              opt_g=opts[0], opt_d=opts[1])
    step = gan.make_train_step(gan.GANCriterion(m), m)
    ref = Trainer(m, gw, dw, "f64", CPU)
    g = torch.Generator().manual_seed(1)
    gp = m["generator_params"]
    feat = gp["in_channels"] - gp["ar_output"]
    n, past = m["batch_max_steps"], gp["ar_input"]
    for _ in range(3):
        x = torch.randn((2, n // m["hop_size"], feat), generator=g,
                        dtype=torch.float64)
        wave = 0.3 * torch.randn((2, past + n), generator=g,
                                 dtype=torch.float64)
        got = step(state, {"x": (x,), "y": wave[:, past:, None],
                           "ar": wave[:, :past, None]}, 1e-4, 1e-4)
        want = ref.step({"x": x, "y": wave[:, past:], "ar": wave[:, :past]})
        for k in ("generator_loss", "discriminator_loss"):
            assert float(got[f"train/{k}"]) == pytest.approx(float(want[k]),
                                                             rel=1e-10)
    for mod, params in ((gen, ref.g), (disc, ref.d)):
        for k, p in mod.named_parameters():
            assert torch.allclose(p, params[k], rtol=0, atol=1e-12), k
