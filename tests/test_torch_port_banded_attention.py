"""The banded relative-position attention (``ops/banded_attention.py``) on
the CPU: its plain query-block version against the dense logits of
``layers/transformer.py::relative_position_logits`` and against the JAX
package's attention in float64, values and gradients (dq, dk, dv and the
table's), below, at and beyond the published distance m = 100; dropout
masks replayed from the training step's ``RandomDraws`` by tag; the port's
Transformer trained against the benchmark's plain reference
(``portbench/reference/transformer.py``); and the version's largest
intermediate, which grows with L and not with L^2.

The CUDA kernels run only on a card: ``tests/test_torch_port_gpu.py``
holds them against this version."""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax
import jax.numpy as jnp

from articulatory_tpu.layers.transformer import _relative_position_logits
from articulatory_tpu_torch.layers.transformer import (
    MultiHeadAttention,
    TransformerEncoderLayer,
    relative_position_logits,
)
from articulatory_tpu_torch.ops import banded_attention as ba
from articulatory_tpu_torch.train import gan

torch.set_num_threads(1)

M = 100
P = 0.2
# a layer's dropout sites, each drawn as ``<tag>/<site>``
SITES = ("attention", "attention_out", "ffn_hidden", "ffn_out")


def _inputs(b, h, length, d, m=M, seed=0, dtype=torch.float64):
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(b, h, length, d, generator=g, dtype=dtype)
               for _ in range(3))
    table = torch.randn(h, 2 * m - 1, d, generator=g, dtype=dtype) * d ** -0.5
    keep = torch.rand(b, h, length, 2 * m - 1, generator=g) >= P
    return q, k, v, table, keep


def _dense_keep(keep, length):
    """The banded keep mask (B, H, L, 2m - 1) as a dense (B, H, L, L) one,
    True outside the band (where the probabilities are 0)."""
    w = keep.shape[-1]
    pos = torch.arange(length)
    rel = pos[None, :] - pos[:, None] + (w - 1) // 2
    inside = (rel >= 0) & (rel < w)
    idx = rel.clamp(0, w - 1).expand(*keep.shape[:2], length, length)
    return torch.where(inside, keep.gather(-1, idx), True)


def _dense(q, k, v, table, keep, p, m):
    """The dense path of the Transformer before the banded op: (B, H, L, L)
    logits with the -1e8 mask, dropout by the dense form of ``keep``."""
    logits = (torch.einsum("bhqd,bhkd->bhqk", q, k) / q.shape[-1] ** 0.5
              + relative_position_logits(q, table, m))
    probs = torch.softmax(logits, -1)
    if keep is not None:
        probs = probs * _dense_keep(keep, q.shape[2]) / (1 - p)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v)


def _grads(fn, args, do):
    args = [a.detach().requires_grad_(True) for a in args]
    out = fn(*args)
    return [out.detach(), *torch.autograd.grad(out, args, do)]


@pytest.mark.parametrize("block", [ba.PLAIN_BLOCK, 48])
@pytest.mark.parametrize("p", [0.0, P])
@pytest.mark.parametrize("length", [37, M, 2 * M + 30])
def test_banded_matches_dense(length, p, block):
    """o, dq, dk, dv and dE of the query-block version against the dense
    logits, with and without dropout on the probabilities."""
    q, k, v, table, keep = _inputs(2, 2, length, 8)
    keep = keep if p else None
    do = torch.randn_like(q)
    got = _grads(lambda *a: ba.banded_attention(*a, keep, p) if block ==
                 ba.PLAIN_BLOCK else ba.banded_attention_plain(
                     *a, keep, p, block), (q, k, v, table), do)
    want = _grads(lambda *a: _dense(*a, keep, p, M), (q, k, v, table), do)
    for name, a, b in zip(("o", "dq", "dk", "dv", "dE"), got, want):
        torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-12, msg=name)


@pytest.mark.parametrize("length", [37, M, 2 * M + 30])
def test_banded_matches_jax(length):
    """Against the JAX package's attention (its ``_relative_position_logits``
    with the -1e8 mask, softmax, the product with v) and its vjp."""
    q, k, v, table, _ = _inputs(1, 2, length, 8, seed=1)
    do = torch.randn_like(q)

    def jax_attention(q, k, v, table):
        logits = (jnp.einsum("bhqd,bhkd->bhqk", q, k) / q.shape[-1] ** 0.5
                  + _relative_position_logits(q, table, M))
        return jnp.einsum("bhqk,bhkd->bhqd", jax.nn.softmax(logits, -1), v)

    with jax.enable_x64(True):
        out, vjp = jax.vjp(jax_attention, *(jnp.asarray(t.numpy())
                                           for t in (q, k, v, table)))
        want = [np.asarray(out)] + [np.asarray(g) for g in
                                    vjp(jnp.asarray(do.numpy()))]
    got = _grads(ba.banded_attention, (q, k, v, table), do)
    for name, a, b in zip(("o", "dq", "dk", "dv", "dE"), got, want):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-9, atol=1e-12,
                                   err_msg=name)


def test_registered_op_on_cpu_is_the_plain_version():
    """The op a traced call records: on the CPU its forward is the plain
    version's, its backward the plain version's gradients."""
    q, k, v, table, keep = _inputs(1, 2, 150, 8, seed=2)
    do = torch.randn_like(q)
    got = _grads(lambda *a: ba._OP(*a, keep, P)[0], (q, k, v, table), do)
    want = _grads(lambda *a: ba.banded_attention_plain(*a, keep, P),
                  (q, k, v, table), do)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-14)
    assert ba.banded_attention.launches == 0


def test_rejects_what_it_does_not_take():
    q, k, v, table, keep = _inputs(1, 2, 20, 8)
    with pytest.raises(ValueError, match="2m - 1"):
        ba.banded_attention(q, k, v, table[:, 1:])
    with pytest.raises(ValueError, match="keep mask"):
        ba.banded_attention(q, k, v, table, keep[..., 1:], P)
    with pytest.raises(ValueError, match="alike"):
        ba.banded_attention(q, k[:, :, 1:], v, table)


class _Largest(TorchDispatchMode):
    """The largest number of elements of any tensor an op makes."""

    def __init__(self):
        super().__init__()
        self.numel = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in out if isinstance(out, (tuple, list)) else (out,):
            if isinstance(t, torch.Tensor):
                self.numel = max(self.numel, t.numel())
        return out


def _largest_in_layer(length):
    torch.manual_seed(0)
    mha = MultiHeadAttention(16, 4, P, relative_positional_distance=M)
    x = torch.randn(1, length, 16, requires_grad=True)
    draws = gan.RandomDraws(3)
    keep = draws.keep((1, 4, length, 2 * M - 1), P, x, "attention")
    with _Largest() as seen:
        mha(x, keep=keep).square().sum().backward()
    return seen.numel


def test_largest_intermediate_grows_with_length_not_its_square():
    """MultiHeadAttention's forward and backward in training: 4 x L grows
    the largest tensor by at most 4 x, far below one (L, L) tensor."""
    small, large = _largest_in_layer(300), _largest_in_layer(1200)
    assert large <= 4 * small
    assert large < 1200 * 1200 / 4


def _layer(dropout=P):
    torch.manual_seed(1)
    layer = TransformerEncoderLayer(16, 4, 24, dropout,
                                    relative_positional_distance=M)
    return layer.double().train()


def test_layer_masks_replay_from_draws():
    """A layer in training draws each site's mask from the step's draws by
    ``<tag>/<site>``: the same masks drawn by tag and passed by hand give
    the same output, bit for bit; another step draws others."""
    from articulatory_tpu_torch.layers.transformer import dropout
    layer = _layer()
    x = torch.randn(2, 230, 16, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(4))
    draws = gan.RandomDraws(11)
    draws.at(7)
    got = layer(x, draws=draws, tag="generator/layers.0")

    replay = gan.RandomDraws(11)
    replay.at(7)
    attn = layer.self_attn
    shapes = {"attention": (2, 4, 230, 2 * M - 1),
              "attention_out": x.shape, "ffn_hidden": (2, 230, 24),
              "ffn_out": x.shape}
    keep = {s: replay.keep(shapes[s], P, x, f"generator/layers.0/{s}")
            for s in SITES}
    a = dropout(attn(x, keep=keep["attention"]), P, True,
                keep=keep["attention_out"])
    h = layer.norm1(x + a)
    y = layer.linear2(dropout(torch.relu(layer.linear1(h)), P, True,
                              keep=keep["ffn_hidden"]))
    want = layer.norm2(h + dropout(y, P, True, keep=keep["ffn_out"]))
    torch.testing.assert_close(got, want, rtol=0, atol=0)

    draws.at(7)
    torch.testing.assert_close(layer(x, draws=draws,
                                     tag="generator/layers.0"), got,
                               rtol=0, atol=0)
    draws.at(8)
    assert not torch.equal(layer(x, draws=draws, tag="generator/layers.0"),
                           got)
    with torch.no_grad():
        no_drop = _layer(0.0)(x)
    assert torch.equal(layer.eval()(x), no_drop)


def _tiny_inversion():
    from portbench.core import manifest
    m = manifest.cell("w2a-transformer-train-b32").model
    m["generator_params"].update(in_channels=5, out_channels=3,
                                 hidden_dim=16, elayers=2)
    return m


def test_transformer_trains_as_the_reference():
    """The port's Transformer through ``make_train_step`` with no
    discriminator against the plain reference's inversion trainer, in
    float64 on the same seeded weights, batches and dropout masks: the
    loss of each step, the first update's gradients and the weights after
    each Adam step."""
    from articulatory_tpu_torch.models import build_model
    from articulatory_tpu_torch.train.optimizers import build_optimizer
    from portbench.drivers.train_inversion import make_weights
    from portbench.reference.train_inversion import InversionTrainer

    m = _tiny_inversion()
    gp = m["generator_params"]
    w = {k: v.double() if v.is_floating_point() else v
         for k, v in make_weights(gp, 5, torch.device("cpu")).items()}
    gen = build_model("Transformer", gp).double()
    gen.load_state_dict(w, strict=True)
    opt = build_optimizer("Adam", m["generator_optimizer_params"], -1,
                          gen.parameters())
    state = gan.GANTrainState(generator=gen, discriminator=None, opt_g=opt,
                              opt_d=None, draws=gan.RandomDraws(17))
    step = gan.make_train_step(gan.GANCriterion(m), m)
    ref = InversionTrainer(m, w, "f64", 17)
    g = torch.Generator().manual_seed(6)
    for j in range(3):
        x = torch.randn(2, 230, 5, generator=g, dtype=torch.float64)
        y = torch.randn(2, 230, 3, generator=g, dtype=torch.float64)
        if j == 1:
            # the first update's gradients, on the masks of step 1
            gen.train()
            draws = gan.RandomDraws(17)
            draws.at(1)
            loss = torch.mean(torch.abs(gen(x, draws=draws) - y))
            grads = dict(zip(dict(gen.named_parameters()), torch.autograd.grad(
                loss, list(gen.parameters()))))
        got = step(state, {"x": (x,), "y": y}, m[
            "generator_optimizer_params"]["lr"], None)
        want = ref.step({"x": x, "y": y})
        assert float(got["train/generator_loss"]) == pytest.approx(
            float(want["generator_loss"]), rel=1e-10)
        if j == 1:
            for k, v in grads.items():
                torch.testing.assert_close(v, want["generator_grads"][k],
                                           rtol=1e-8, atol=1e-12, msg=k)
        for k, p in gen.named_parameters():
            torch.testing.assert_close(p.detach(), ref.g[k].detach(),
                                       rtol=1e-9, atol=1e-12, msg=k)
