"""The CUDA kernels against their plain versions on the card, their
``autograd.Function``s' gradients against plain autograd, and the generator
and discriminator on the card against the same modules on the CPU. Marked
``gpu``: without a
CUDA device each test skips. This file imports no JAX, so on a machine with
a card and no JAX it runs as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_gpu.py
"""

import pytest
import torch

from articulatory_tpu_torch.models import build_model
from articulatory_tpu_torch.ops.resblock_pair import (
    resblock_pair,
    resblock_pair_backward,
    resblock_pair_backward_plain,
    resblock_pair_plain,
    split_tf32,
    split_tf32_plain,
)
from articulatory_tpu_torch.ops.scale_disc_head import (
    scale_disc_head,
    scale_disc_head_plain,
    split_weights,
    split_weights_plain,
)
from articulatory_tpu_torch.utils.device import set_float32_parity

torch.set_num_threads(1)
pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    set_float32_parity()
    return torch.device("cuda")


def _pair_args(device, b, t, c, k, dtype, seed=0):
    gen = torch.Generator().manual_seed(seed)
    scale = (1.0 / (c * k)) ** 0.5
    x = torch.randn(b, t, c, generator=gen)
    w1 = torch.randn(k, c, c, generator=gen) * scale
    w2 = torch.randn(k, c, c, generator=gen) * scale
    b1 = torch.randn(c, generator=gen) * 0.1
    b2 = torch.randn(c, generator=gen) * 0.1
    return [a.to(device=device, dtype=dtype) for a in (x, w1, b1, w2, b2)]


# one shape per (stage C, K) of the main path at its decode T, B 4
MAIN_PATH = [(4, t, c, k, d) for c, t in ((256, 500), (128, 2000), (64, 4000),
                                         (32, 8000))
             for k, d in ((3, 1), (7, 3), (11, 5))]


@pytest.mark.parametrize("b,t,c,k,d", MAIN_PATH + [
    (2, 537, 256, 11, 5),   # widest stage, worst-case shared memory
    (3, 2003, 128, 7, 3),   # ragged tile
    (1, 8000, 32, 3, 1),
    (2, 1, 64, 11, 5),      # T = 1
    (2, 7, 128, 11, 5),     # T below the halo
    (64, 125, 256, 11, 5),  # the training batch
    (2, 100, 30, 3, 3),     # C % 8 != 0: f32 and bf16 pad to 32
    (2, 300, 48, 7, 3),     # odd 16-channel k steps; f32 N 64 > C
])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_kernel_matches_plain(cuda, b, t, c, k, d, dtype, tol):
    """Error relative to max |y|: f32 sums in another order (1e-4); bf16
    rounds h and y at other points than cuDNN's bf16 convs (2e-2)."""
    args = _pair_args(cuda, b, t, c, k, dtype)
    before = resblock_pair.launches
    y = resblock_pair(*args, dilation=d)
    assert resblock_pair.launches == before + 1
    ref = resblock_pair_plain(*args, dilation=d)
    torch.cuda.synchronize()
    assert y.dtype == dtype and y.shape == ref.shape
    err = (y.float() - ref.float()).abs().max() / ref.float().abs().max()
    assert err <= tol


def test_kernel_rejects_what_it_does_not_take(cuda):
    x, w1, b1, w2, b2 = _pair_args(cuda, 1, 16, 8, 3, torch.float32)
    with pytest.raises(ValueError):  # not contiguous
        resblock_pair(x[:, ::2], w1, b1, w2, b2, dilation=1)
    with pytest.raises(ValueError):
        resblock_pair(x, w1.to(torch.bfloat16), b1, w2, b2, dilation=1)
    with pytest.raises(ValueError):
        resblock_pair(x, w1[:2], b1, w2, b2, dilation=1)
    with pytest.raises(TypeError):
        resblock_pair(x.double(), w1.double(), None, w2.double(), None,
                      dilation=1)
    for dtype in (torch.bfloat16, torch.float32):
        wide = _pair_args(cuda, 1, 16, 512, 3, dtype)
        before = resblock_pair.launches, split_tf32.launches
        with pytest.raises(ValueError):  # the kernel takes C <= 256
            resblock_pair(*wide, dilation=1)
        assert (resblock_pair.launches, split_tf32.launches) == before


@pytest.mark.parametrize("b,t,c,k,d", [(2, 500, 256, 11, 5),
                                       (2, 2000, 128, 7, 3),
                                       (2, 4000, 64, 11, 1),
                                       (2, 8000, 32, 3, 5)])
def test_f32_kernel_matches_float64_pair(cuda, b, t, c, k, d):
    """One shape per generator stage against the plain pair in float64 on
    the card: 3xTF32 with f32 sums stays within 1e-5 of max |y| (a single
    tf32 product reads about 1e-4 here), as chip_smoke holds all 72."""
    args = _pair_args(cuda, b, t, c, k, torch.float32)
    y = resblock_pair(*args, dilation=d)
    ref = resblock_pair_plain(*(a.double() for a in args), dilation=d)
    torch.cuda.synchronize()
    assert (y.double() - ref).abs().max() <= 1e-5 * ref.abs().max()


# the recipe's 36 training shapes (B 64 x 2000 samples) and MRI's last stage
# (B 16 x 30,000)
TRAIN_PAIRS = [(64, t, c, k, d) for c, t in ((256, 125), (128, 500),
                                            (64, 1000), (32, 2000))
               for k in (3, 7, 11) for d in (1, 3, 5)]
MRI_LAST_STAGE = [(16, 30000, 32, k, d) for k in (3, 7, 11) for d in (1, 3, 5)]


@pytest.mark.parametrize("b,t,c,k,d", TRAIN_PAIRS + MRI_LAST_STAGE + [
    (2, 1, 64, 11, 5),      # T = 1
    (2, 7, 128, 11, 5),     # T below the halo
    (2, 100, 30, 3, 3),     # C % 8 != 0: padded to 32
    (3, 257, 200, 7, 5),    # C above 128, not a multiple of it
])
def test_pair_backward_matches_float64(cuda, b, t, c, k, d):
    """The backward kernels' f32 gradients against the plain backward in
    float64 on the card, per tensor: relative L2 within 1e-5 and within
    twice cuDNN f32's own distance (the plain backward in f32), and
    bit-equal over two calls (no atomics). Where cuDNN takes an lrelu' the
    other way from float64 (an h within its rounding of 0) its distance
    reads ~1e-3 and 1e-5 binds; the kernel settles such h exactly."""
    args = _pair_args(cuda, b, t, c, k, torch.float32, seed=7)
    gy = torch.randn(b, t, c, device=cuda,
                     generator=torch.Generator(device=cuda).manual_seed(8))
    got = resblock_pair_backward(*args, gy, dilation=d)
    again = resblock_pair_backward(*args, gy, dilation=d)
    want = resblock_pair_backward_plain(*(a.double() for a in args),
                                        gy.double(), dilation=d)
    cudnn = resblock_pair_backward_plain(*args, gy, dilation=d)
    torch.cuda.synchronize()
    for name, g, g2, w, p in zip(("dx", "dw1", "db1", "dw2", "db2"), got,
                                 again, want, cudnn):
        err = ((g.double() - w).norm() / w.norm()).item()
        ref = ((p.double() - w).norm() / w.norm()).item()
        limit = min(1e-5, 2 * ref)
        print(f"{name}: kernel {err:.3e}, limit {limit:.3e}, cuDNN f32 "
              f"{ref:.3e}")
        assert torch.equal(g, g2), f"{name} differs between two calls"
        assert err <= limit, f"{name}: kernel {err:.3e}, cuDNN f32 {ref:.3e}"


# the recipe's generator: 4 stages x 3 kernel sizes x 3 dilations = 36 pairs
RECIPE_GENERATOR = dict(
    in_channels=141, out_channels=1, channels=512, kernel_size=7,
    upsample_scales=(5, 4, 2, 2), upsample_kernel_sizes=(10, 8, 4, 4),
    resblock_kernel_sizes=(3, 7, 11), resblock_dilations=((1, 3, 5),) * 3,
    use_ar=True, ar_input=512, ar_hidden=256, ar_output=128)


def _device_names(prof) -> list:
    return [e.name for e in prof.events()]


def test_generator_backward_runs_the_pair_backward_kernels(cuda):
    """The recipe's generator differentiated on the card: one launch of the
    pair's backward per pair (36), its kernels in the trace, and no
    recompute of the plain pair."""
    from torch.profiler import ProfilerActivity, profile

    model = build_model("HiFiGANGenerator", RECIPE_GENERATOR).to(cuda)
    gen = torch.Generator().manual_seed(2)
    c = torch.randn(2, 10, 13, generator=gen).to(cuda)
    ar = (0.3 * torch.randn(2, 512, 1, generator=gen)).to(cuda)
    y = model(c, ar)
    before = resblock_pair_backward.launches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        y.square().sum().backward()
        torch.cuda.synchronize()
    assert resblock_pair_backward.launches - before == 36
    names = _device_names(prof)
    assert not any(n.startswith("recompute_grads:resblock_pair_plain")
                   for n in names)
    assert sum("pair_bwd_hidden_kernel" in n for n in names) == 36
    assert sum("pair_bwd_weight_kernel" in n for n in names) == 72


@pytest.mark.parametrize("k1,k2,c", [(3, 3, 256), (11, 11, 32), (7, 5, 48),
                                     (3, 1, 8)])
def test_split_kernel_matches_plain(cuda, k1, k2, c):
    """The prep kernel's tf32 hi/lo split and transpose, bit for bit."""
    gen = torch.Generator().manual_seed(k1 + c)
    w1 = torch.randn(k1, c, c, generator=gen).to(cuda)
    w2 = torch.randn(k2, c, c, generator=gen).to(cuda)
    before = split_tf32.launches
    s1, s2 = split_tf32(w1, w2)
    assert split_tf32.launches == before + 1
    torch.testing.assert_close(s1, split_tf32_plain(w1), rtol=0, atol=0)
    torch.testing.assert_close(s2, split_tf32_plain(w2), rtol=0, atol=0)


def test_split_cached_only_on_inference_tensors(cuda):
    """The decode's kernels are inference tensors: their split is made once.
    Weights that are not (training's, refolded every forward) are split at
    every launch. Both give the same output."""
    args = _pair_args(cuda, 2, 301, 64, 7, torch.float32)
    before = split_tf32.launches
    plain_calls = [resblock_pair(*args, dilation=3) for _ in range(2)]
    assert split_tf32.launches == before + 2
    with torch.inference_mode():
        frozen = [a.clone() for a in args]
        cached_calls = [resblock_pair(*frozen, dilation=3) for _ in range(2)]
    assert split_tf32.launches == before + 3
    for y in plain_calls + cached_calls:
        torch.testing.assert_close(y, plain_calls[0], rtol=0, atol=0)


def test_generator_on_card_matches_cpu(cuda):
    gp = dict(in_channels=13 + 8, channels=32, upsample_scales=(5, 4, 2, 2),
              upsample_kernel_sizes=(10, 8, 4, 4), resblock_kernel_sizes=(3, 7),
              resblock_dilations=((1, 3), (1, 3)), use_ar=True, ar_input=64,
              ar_hidden=8, ar_output=8)
    model = build_model("HiFiGANGenerator", gp).eval()
    gen = torch.Generator().manual_seed(1)
    c = torch.randn(2, 30, 13, generator=gen)
    ar = 0.3 * torch.randn(2, 64, 1, generator=gen)
    with torch.no_grad():
        ref = model(c, ar)
        before = resblock_pair.launches
        out = model.to(cuda)(c.to(cuda), ar.to(cuda)).cpu()
    assert resblock_pair.launches == before + 4 * 2 * 2
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-5)


def _head_args(device, b, t, dtype, seed=0):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(b, t, 1, generator=gen) * 0.3
    w0 = torch.randn(15, 1, 128, generator=gen) / 15 ** 0.5
    b0 = torch.randn(128, generator=gen) * 0.1
    wg = torch.randn(41, 32, 128, generator=gen) / (41 * 32) ** 0.5
    b1 = torch.randn(128, generator=gen) * 0.1
    return [a.to(device=device, dtype=dtype) for a in (x, w0, b0, wg, b1)]


@pytest.mark.parametrize("b,t,stride", [
    (4, 2512, 4),   # the configs' first scale at B 4
    (3, 901, 2),    # ragged T at the Pallas kernel's stride
    (2, 37, 4),     # one short tile
    (1, 1, 2),      # T = 1
    (2, 300, 64),   # a stride whose owned rows reach past the taps
])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_scale_disc_head_matches_plain(cuda, b, t, stride, dtype, tol):
    """Error relative to max |h|: f32 sums in another order (1e-4); bf16
    rounds h0 and h1 where cuDNN's bf16 convs do, over other sums (2e-2)."""
    args = _head_args(cuda, b, t, dtype)
    before = scale_disc_head.launches
    h0, h1 = scale_disc_head(*args, stride=stride)
    assert scale_disc_head.launches == before + 1
    r0, r1 = scale_disc_head_plain(*args, stride=stride)
    torch.cuda.synchronize()
    for got, ref in ((h0, r0), (h1, r1)):
        assert got.dtype == dtype and got.shape == ref.shape
        err = (got.float() - ref.float()).abs().max() / ref.float().abs().max()
        assert err <= tol


@pytest.mark.parametrize("b,t,stride", [(4, 2512, 4), (3, 901, 2),
                                         (2, 300, 64), (1, 1, 2)])
def test_f32_scale_disc_head_matches_float64_head(cuda, b, t, stride):
    """The f32 head (layer 1 in 3xTF32, partial sums folded into f32)
    against the plain head in float64 on the card: within 1e-5 of max |h|
    for h0 and h1, as chip_smoke holds it (a single tf32 product reads about
    2e-4); cuDNN f32's own error is in the message."""
    args = _head_args(cuda, b, t, torch.float32)
    outs = scale_disc_head(*args, stride=stride)
    refs = scale_disc_head_plain(*(a.double() for a in args), stride=stride)
    plains = scale_disc_head_plain(*args, stride=stride)
    torch.cuda.synchronize()
    for got, ref, plain in zip(outs, refs, plains):
        scale = ref.abs().max()
        err = (got.double() - ref).abs().max() / scale
        cudnn = (plain.double() - ref).abs().max() / scale
        assert err <= 1e-5, f"kernel {err:.3e}, cuDNN f32 {cudnn:.3e}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_head_split_kernel_matches_plain(cuda, dtype):
    """The head's prep kernel (tf32 hi/lo split and transpose in f32, the
    transpose in bf16), bit for bit, one launch."""
    wg = _head_args(cuda, 1, 8, dtype, seed=3)[3]
    before = split_weights.launches
    got = split_weights(wg)
    assert split_weights.launches == before + 1
    torch.testing.assert_close(got, split_weights_plain(wg), rtol=0, atol=0)


def test_head_launches_one_split_a_call(cuda):
    """Training moves the weights every step, so every head call splits."""
    args = _head_args(cuda, 2, 400, torch.float32)
    before = scale_disc_head.launches, split_weights.launches
    for _ in range(2):
        scale_disc_head(*args, stride=4)
    assert (scale_disc_head.launches, split_weights.launches) == (
        before[0] + 2, before[1] + 2)


def _grads(fn, args, **kwargs):
    leaves = [a.clone().requires_grad_(True) for a in args]
    out = fn(*leaves, **kwargs)
    outs = out if isinstance(out, tuple) else (out,)
    gen = torch.Generator(device=args[0].device).manual_seed(1)
    sum(torch.sum(o * torch.randn(o.shape, device=o.device, generator=gen))
        for o in outs).backward()
    return outs, [a.grad for a in leaves]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("which", ["resblock_pair", "scale_disc_head"])
def test_functions_grads_match_plain_autograd(cuda, which, dtype, tol):
    """On a CUDA tensor the kernels' outputs carry their Function's grad_fn
    and its backward (the pair's backward kernels in f32; the head's, and
    the bf16 pair's, recompute of the plain version) matches plain
    autograd: relative L2 1e-5 in f32; 1e-2 in bf16, where cuDNN may take
    another algorithm (or order of atomics) for a weight gradient and each
    differing sum rounds to bf16."""
    if which == "resblock_pair":
        args = _pair_args(cuda, 2, 301, 64, 7, dtype)
        fns, kwargs = (resblock_pair, resblock_pair_plain), dict(dilation=3)
    else:
        args = _head_args(cuda, 2, 1001, dtype)
        fns, kwargs = (scale_disc_head, scale_disc_head_plain), dict(stride=4)
    (outs, got), (_, want) = (_grads(f, args, **kwargs) for f in fns)
    assert all(type(o.grad_fn).__name__.endswith("FunctionBackward")
               for o in outs)
    for g, w in zip(got, want):
        assert (g.float() - w.float()).norm() <= tol * w.float().norm()


def test_resblock_pair_without_grad_skips_function(cuda):
    """Under inference_mode (the decode) the pair is one bare launch: no
    grad_fn, one launch counted, the same output as through the Function."""
    args = _pair_args(cuda, 2, 301, 64, 7, torch.bfloat16)
    before = resblock_pair.launches
    with torch.inference_mode():
        y = resblock_pair(*args, dilation=3)
    assert y.grad_fn is None and resblock_pair.launches == before + 1
    leaves = [a.clone().requires_grad_(True) for a in args]
    through = resblock_pair(*leaves, dilation=3)
    assert type(through.grad_fn).__name__ == "ResblockPairFunctionBackward"
    torch.testing.assert_close(through.detach(), y, rtol=0, atol=0)


def test_discriminator_on_card_matches_cpu(cuda):
    dp = dict(scales=2, scale_discriminator_params=dict(
        max_downsample_channels=256, downsample_scales=[4, 4, 1]),
        periods=[2, 3], period_discriminator_params=dict(
            channels=8, max_downsample_channels=32))
    disc = build_model("HiFiGANMultiScaleMultiPeriodDiscriminator", dp)
    x = 0.3 * torch.randn(2, 2512, 1, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        ref = disc(x)
        before = scale_disc_head.launches
        out = disc.to(cuda)(x.to(cuda))
    assert scale_disc_head.launches == before + 2
    for got_maps, ref_maps in zip(out, ref):
        for got, want in zip(got_maps, ref_maps):
            torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-5)


PAIRS = 4 * 2 * 2  # a chunk forward of _loaded's generator: stages x K x d


def _loaded(cuda, ar_input, channels=128, **gp):
    """A small AR generator on the card as a frozen ``LoadedModel``, and its
    config (10-frame chunks: ar_input 64 keeps the last-window carry, 2000
    the shift register). Its stages' C (64 to 8) are multiples of 8, so no
    f32 pair pads its channels: a padded pair splits its padded weights in
    every call."""
    from articulatory_tpu_torch.inference import LoadedModel

    gp = dict(in_channels=13 + 8, channels=channels,
              upsample_scales=[5, 4, 2, 2], upsample_kernel_sizes=[10, 8, 4, 4],
              resblock_kernel_sizes=[3, 7], resblock_dilations=[[1, 3]] * 2,
              use_ar=True, ar_input=ar_input, ar_hidden=8, ar_output=8, **gp)
    config = {"dataset_mode": "a2w", "batch_max_steps": 800, "hop_size": 80,
              "generator_params": gp}
    model = LoadedModel(model=build_model("HiFiGANGenerator", gp).to(cuda).eval(),
                        config=config, device=cuda)
    model.remove_weight_norm()
    return model, config


def _feats(lengths, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(t, 13, generator=gen).numpy() for t in lengths]


@pytest.mark.parametrize("ar_input", [64, 2000])
@pytest.mark.parametrize("compute", [{}, {"compute_dtype": "bfloat16",
                                          "hybrid_precision": True}],
                         ids=["f32", "hybrid"])
def test_graph_replay_matches_eager_loop(cuda, ar_input, compute):
    """The captured chunk step replays the eager loop's kernels in its
    order: the same outputs, lane by lane and for one stream."""
    import numpy as np

    from articulatory_tpu_torch.inference import (
        ar_loop,
        ar_loop_batched,
        ar_loop_scan,
    )

    model, config = _loaded(cuda, ar_input, **compute)
    xs = _feats([30, 20, 27])
    eager = ar_loop_batched(model, xs, config)
    before = resblock_pair.launches
    graph = ar_loop_batched(model, xs, config, scan=True)
    # the warm-up steps and the capture launch; replays run no Python
    assert resblock_pair.launches - before == PAIRS * (2 + 1)
    for e, g in zip(eager, graph):
        np.testing.assert_allclose(g, e, rtol=0, atol=1e-6)
    one = ar_loop_scan(model, xs[0], config)
    np.testing.assert_allclose(one, ar_loop(model, xs[0], config), rtol=0,
                               atol=1e-6)


def test_graph_cache_hit_and_drop(cuda):
    import numpy as np

    from articulatory_tpu_torch.inference import ar_loop_batched

    model, config = _loaded(cuda, 64)
    xs = _feats([25, 25])
    first = ar_loop_batched(model, xs, config, scan=True)
    (graph,) = model.graphs.values()
    before = resblock_pair.launches
    again = ar_loop_batched(model, xs, config, scan=True)
    assert resblock_pair.launches == before  # a hit: replays only
    assert list(model.graphs.values()) == [graph]
    for a, b in zip(first, again):
        np.testing.assert_array_equal(a, b)
    model.to_bf16_weights()
    assert not model.graphs
    before = split_tf32.launches
    bf16 = ar_loop_batched(model, xs, config, scan=True)
    # the f32 pairs split the upcast bf16 kernels once, in the warm-up
    assert split_tf32.launches == before + PAIRS
    assert len(model.graphs) == 1
    for out in bf16:
        assert out.shape == (2000,) and np.isfinite(out).all()


def test_capture_error_raises_and_runs_no_eager_loop(cuda, monkeypatch):
    """A step that cannot be captured (a host sync inside the forward)
    raises; the eager loop is not run in its place."""
    from articulatory_tpu_torch import inference

    model, config = _loaded(cuda, 64)
    forward = model.model.forward

    def syncing_forward(c, ar=None):
        out = forward(c, ar)
        out.sum().item()  # a device-to-host copy: illegal while capturing
        return out

    monkeypatch.setattr(model.model, "forward", syncing_forward)
    monkeypatch.setattr(inference, "_eager_chunks", lambda *a, **k: (
        pytest.fail("the eager loop ran")))
    with pytest.raises(RuntimeError, match="capturing the chunk step"):
        inference.ar_loop_batched(model, _feats([20]), config, scan=True)
    assert not model.graphs


def _bigru(cuda, ar_input=16, out=4, feats=5, chunk=32):
    """A small AR BiGRU on the card as a ``LoadedModel``, and its w2a
    config: 32-row chunks, hop 8; ar_input 16 keeps a 4-frame last-window
    carry, 200 (50 frames) the shift register."""
    from articulatory_tpu_torch.inference import LoadedModel

    gp = dict(in_channels=feats + 8, hidden_size=16, out_channels=out,
              use_ar=True, ar_input=ar_input, ar_hidden=8, ar_output=8)
    config = {"dataset_mode": "w2a", "batch_max_steps": chunk,
              "hop_size": 8, "generator_params": gp}
    model = build_model("BiGRU", gp, seed=ar_input).to(cuda).eval()
    return LoadedModel(model=model, config=config, device=cuda), config


def _rows(lengths, feats=5, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(t, feats, generator=gen).numpy() for t in lengths]


@pytest.mark.parametrize("ar_input", [16, 200])
def test_bigru_graph_matches_eager(cuda, ar_input):
    """The BiGRU's captured chunk step (cuDNN's recurrence inside a CUDA
    graph) gives the eager loop's outputs bit for bit: lanes, one stream,
    and the exact ragged tail after the whole chunks."""
    import numpy as np

    from articulatory_tpu_torch.inference import (
        ar_loop,
        ar_loop_batched,
        ar_loop_scan,
    )

    model, config = _bigru(cuda, ar_input)
    xs = _rows([96, 70, 45])
    eager = ar_loop_batched(model, xs, config)
    graph = ar_loop_batched(model, xs, config, scan=True)
    for e, g in zip(eager, graph):
        np.testing.assert_array_equal(g, e)
    for x in xs:  # 45 rows: a whole chunk and a 13-row tail
        np.testing.assert_array_equal(ar_loop_scan(model, x, config),
                                      ar_loop(model, x, config))
    assert len(model.graphs) == 2  # B 3 and B 1


def test_bigru_f32_on_card_matches_float64(cuda):
    """cuDNN's f32 recurrence (TF32 off) within 1e-4 of max |y| of the same
    module in float64 on the card."""
    import copy

    model, _ = _bigru(cuda, feats=13)
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(4, 300, 13, generator=gen).to(cuda)
    ar = torch.randn(4, 4, 4, generator=gen).to(cuda)
    with torch.inference_mode():
        y = model.model(x, ar)
        y64 = copy.deepcopy(model.model).double()(x.double(), ar.double())
    err = (y.double() - y64).abs().max() / y64.abs().max()
    assert err <= 1e-4, err


@pytest.mark.parametrize("which", ["a2w", "w2a"])
def test_server_graph_step_matches_eager_masked_step(cuda, which):
    """Rounds of a churning server, each replayed from the captured masked
    step, equal the eager masked step on the same inputs, carry and mask,
    output and next carry bit for bit."""
    import numpy as np

    from articulatory_tpu_torch.inference import chunk_step
    from articulatory_tpu_torch.streaming import StreamingServer

    if which == "a2w":
        model, config = _loaded(cuda, 64)
        feats, rows = 13, 10
    else:
        model, config = _bigru(cuda)
        feats, rows = 5, 32
    server = StreamingServer(model, config, max_lanes=3)
    (x,) = _rows([8 * rows], feats=feats)
    plan = [["a"], ["a", "b"], ["b"], ["a", "b", "c"], ["c"], ["a", "c"]]
    for rnd, clients in enumerate(plan):
        for cid in clients:
            if cid not in server.active:
                server.join(cid)
        prev = server.syn._prev.clone()
        subs = {cid: x[rnd * rows:(rnd + 1) * rows] for cid in clients}
        got = server.step(subs)
        feats_in = torch.zeros(3, rows, feats, device=cuda)
        mask = torch.zeros(3, dtype=torch.bool, device=cuda)
        for cid, chunk in subs.items():
            lane = server._lane_of[cid]
            feats_in[lane] = torch.from_numpy(chunk).to(cuda)
            mask[lane] = True
        with torch.inference_mode():
            out, new_prev = chunk_step(model, feats_in, prev, server.syn.ck,
                                       mask)
        assert torch.equal(server.syn._prev, new_prev), rnd
        for cid in clients:
            np.testing.assert_array_equal(
                got[cid], out[server._lane_of[cid]].cpu().numpy()[
                    :len(got[cid])])
    assert len(model.graphs) == 1  # one masked graph for every round


def test_dispatched_chunks_survive_later_replays(cuda):
    """``dispatch_chunk`` hands out a tensor of its own: chunks kept in
    flight keep their values while later chunks replay the graph."""
    from articulatory_tpu_torch.streaming import StreamingSynthesizer

    model, config = _loaded(cuda, 64)
    (x,) = _feats([40])
    syn = StreamingSynthesizer(model, config)
    inflight = [syn.dispatch_chunk(x[i:i + 10]) for i in range(0, 40, 10)]
    syn.reset()
    synced = [syn.synthesize_chunk(x[i:i + 10]) for i in range(0, 40, 10)]
    graph = next(iter(model.graphs.values()))
    for out, want in zip(inflight, synced):
        assert out.data_ptr() != graph.static_out.data_ptr()
        assert torch.equal(out.cpu(), torch.from_numpy(want))


# multi-band HiFi-GAN (upsample (5, 2, 2), 4 bands): its three stages'
# pairs at 100 frames, B 4 (T x5, x10, x20)
MULTIBAND = [(4, t, c, k, d) for c, t in ((256, 500), (128, 1000),
                                         (64, 2000))
             for k, d in ((3, 1), (7, 3), (11, 5))]


@pytest.mark.parametrize("b,t,c,k,d", MULTIBAND)
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_kernel_matches_plain_at_multiband_shapes(cuda, b, t, c, k, d, dtype,
                                                  tol):
    args = _pair_args(cuda, b, t, c, k, dtype, seed=1)
    before = resblock_pair.launches
    y = resblock_pair(*args, dilation=d)
    assert resblock_pair.launches == before + 1
    ref = resblock_pair_plain(*args, dilation=d)
    err = (y.float() - ref.float()).abs().max() / ref.float().abs().max()
    assert err.item() <= tol


def test_multiband_train_step_kernels_match_plain(cuda, monkeypatch):
    """One multi-band HiFi-GAN loss pair (PQMF, subband STFT loss, the
    MSMPD's scale head) with both kernels against both plain versions:
    gradients in relative L2 pooled per model <= 1e-3."""
    from articulatory_tpu_torch.layers import residual
    from articulatory_tpu_torch.models import hifigan
    from articulatory_tpu_torch.train import gan

    gp = dict(in_channels=13, out_channels=4, channels=128,
              upsample_scales=[5, 2, 2], upsample_kernel_sizes=[10, 4, 4])
    dp = dict(scales=2, scale_discriminator_params=dict(
        channels=128, max_downsample_channels=256,
        downsample_scales=[4, 4, 1]), periods=[2, 3])
    config = dict(generator_type="HiFiGANGenerator", generator_params=gp,
                  discriminator_type="HiFiGANMultiScaleMultiPeriodDiscriminator",
                  discriminator_params=dp, pqmf=True,
                  use_subband_stft_loss=True,
                  subband_stft_loss_params=dict(fft_sizes=[128],
                                                hop_sizes=[32],
                                                win_lengths=[64]),
                  use_feat_match_loss=True, lambda_aux=45.0)
    gen = build_model("HiFiGANGenerator", gp).to(cuda)
    disc = build_model(config["discriminator_type"], dp, seed=1).to(cuda)
    state = gan.GANTrainState(generator=gen, discriminator=disc, opt_g=None,
                              opt_d=None, steps=1)
    criterion = gan.GANCriterion(config)
    g = torch.Generator().manual_seed(2)
    batch = {"x": (torch.randn(2, 20, 13, generator=g).to(cuda),),
             "y": (0.3 * torch.randn(2, 1600, 1, generator=g)).to(cuda)}
    with torch.no_grad():
        fake = gan.synthesize(criterion, gan.generate(gen, batch))

    def grads():
        gl, _ = gan.generator_loss(state, criterion, config, batch)
        dl, _ = gan.discriminator_loss(state, criterion, config, batch, fake)
        return (torch.autograd.grad(gl, list(gen.parameters())),
                torch.autograd.grad(dl, list(disc.parameters())))

    pairs, heads = resblock_pair.launches, scale_disc_head.launches
    kernel = grads()
    # 27 pairs (3 stages x 3 blocks x 3 dilations); 2 scales x 4 passes
    assert resblock_pair.launches - pairs == 27
    assert scale_disc_head.launches - heads == 8
    monkeypatch.setattr(residual, "resblock_pair", resblock_pair_plain)
    monkeypatch.setattr(hifigan, "scale_disc_head", scale_disc_head_plain)
    plain = grads()
    for got, want in zip(kernel, plain):
        gap = torch.stack([(a - b).norm() for a, b in zip(got, want)]).norm()
        norm = torch.stack([b.norm() for b in want]).norm()
        assert (gap / norm).item() <= 1e-3


def test_pair_backward_with_frozen_weights_gives_input_grad_only(cuda):
    """A frozen generator (a cascade's generator2) passes gradients through
    the pair: with weights that need no gradient, x's gradient equals plain
    autograd's (relative L2 1e-5), no weight gradient is made or kept, and
    nothing is recomputed: the backward kernels launch no weight-gradient
    work."""
    from torch.profiler import ProfilerActivity, profile

    x, w1, b1, w2, b2 = _pair_args(cuda, 2, 401, 128, 11, torch.float32)
    leaf = x.clone().requires_grad_(True)
    y = resblock_pair(leaf, w1, b1, w2, b2, dilation=5)
    assert type(y.grad_fn).__name__ == "ResblockPairFunctionBackward"
    gy = torch.randn(y.shape, device=cuda,
                     generator=torch.Generator(device=cuda).manual_seed(3))
    before = resblock_pair_backward.launches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        (got,) = torch.autograd.grad(y, leaf, gy)
        torch.cuda.synchronize()
    assert resblock_pair_backward.launches == before + 1
    names = _device_names(prof)
    assert not any(n.startswith("recompute_grads:") for n in names)
    assert any("pair_bwd_input_kernel" in n for n in names)
    assert not any("pair_bwd_weight_kernel" in n
                   or "pair_bwd_reduce_kernel" in n for n in names)
    ref_leaf = x.clone().requires_grad_(True)
    (want,) = torch.autograd.grad(
        resblock_pair_plain(ref_leaf, w1, b1, w2, b2, dilation=5), ref_leaf,
        gy)
    assert (got - want).norm() <= 1e-5 * want.norm()
    assert all(t.grad is None for t in (w1, b1, w2, b2))


def test_conditioned_generator_on_card_matches_cpu(cuda):
    """Speaker and phoneme hooks and the phoneme head: both outputs on the
    card (the pair kernel, 2 stages x 2 blocks x 2 dilations) against the
    same module on the CPU."""
    gp = dict(in_channels=13 + 8, channels=64, upsample_scales=(4, 4),
              upsample_kernel_sizes=(8, 8), resblock_kernel_sizes=(3, 7),
              resblock_dilations=((1, 3), (1, 3)), use_ar=True, ar_input=64,
              ar_hidden=8, ar_output=8, use_spk_id=True, num_spk=3,
              use_ph=True, num_ph=7, use_ph_loss=True)
    model = build_model("HiFiGANGenerator", gp).eval()
    gen = torch.Generator().manual_seed(4)
    c = torch.randn(2, 30, 13, generator=gen)
    ar = 0.3 * torch.randn(2, 64, 1, generator=gen)
    spk = torch.tensor([2, 0], dtype=torch.int32)
    ph = torch.randint(0, 7, (2, 30), generator=gen, dtype=torch.int32)
    with torch.no_grad():
        ref = model(c, ar, spk_id=spk, ph=ph)
        before = resblock_pair.launches
        out = model.to(cuda)(c.to(cuda), ar.to(cuda), spk_id=spk.to(cuda),
                             ph=ph.to(cuda))
    assert resblock_pair.launches == before + 2 * 2 * 2
    assert out[1].shape == (2, 30, 7)
    for got, want in zip(out, ref):
        torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("compute", [{}, {"compute_dtype": "bfloat16",
                                          "hybrid_precision": True}],
                         ids=["f32", "hybrid"])
def test_ph_loss_model_graph_matches_eager_loop(cuda, compute):
    """A phoneme-head model decodes through the captured chunk step, which
    keeps the waveform and drops the logits: outputs as the eager loop's."""
    import numpy as np

    from articulatory_tpu_torch.inference import ar_loop_batched

    model, config = _loaded(cuda, 64, use_ph_loss=True, num_ph=5, **compute)
    xs = _feats([30, 20, 27], seed=5)
    eager = ar_loop_batched(model, xs, config)
    graph = ar_loop_batched(model, xs, config, scan=True)
    for e, g in zip(eager, graph):
        assert g.shape == e.shape and g.ndim == 1
        np.testing.assert_allclose(g, e, rtol=0, atol=1e-6)


def test_cascade_step_kernels_match_plain(cuda, monkeypatch):
    """A cascade's generator loss through a frozen HiFi-GAN on the pair
    kernel: the generator's gradients against the plain pair's (relative
    L2 pooled <= 1e-3), none on generator2, which the step leaves bit for
    bit."""
    from articulatory_tpu_torch.layers import residual
    from articulatory_tpu_torch.train import gan
    from articulatory_tpu_torch.train.optimizers import build_optimizer

    gp2 = dict(in_channels=12, out_channels=13, channels=128,
               upsample_scales=[1], upsample_kernel_sizes=[2])
    config = dict(dataset_mode="w2a", generator_type="BiGRU",
                  generator_params=dict(in_channels=13, hidden_size=32,
                                        out_channels=12, dropout=0.0),
                  generator2_type="HiFiGANGenerator", generator2_params=gp2,
                  discriminator_type="HiFiGANMultiScaleMultiPeriodDiscriminator",
                  discriminator_params=dict(
                      scales=1, scale_discriminator_params=dict(
                          in_channels=13, channels=16,
                          max_downsample_channels=32, max_groups=4),
                      periods=[2], period_discriminator_params=dict(
                          in_channels=13, channels=4,
                          max_downsample_channels=8)),
                  use_stft_loss=False, use_mel_loss=True,
                  use_feat_match_loss=True)
    gen = build_model("BiGRU", config["generator_params"]).to(cuda)
    gen2 = build_model("HiFiGANGenerator", gp2, seed=2).to(cuda)
    gen2.requires_grad_(False)
    disc = build_model(config["discriminator_type"],
                       config["discriminator_params"], seed=1).to(cuda)
    state = gan.GANTrainState(
        generator=gen, discriminator=disc,
        opt_g=build_optimizer("Adam", {}, -1, gen.parameters()),
        opt_d=build_optimizer("Adam", {}, -1, disc.parameters()), steps=1,
        generator2=gen2)
    criterion = gan.GANCriterion(config)
    g = torch.Generator().manual_seed(6)
    batch = {"x": (torch.randn(2, 120, 13, generator=g).to(cuda),),
             "y": torch.randn(2, 120, 12, generator=g).to(cuda)}
    params = list(gen.parameters())

    def grads():
        loss, _ = gan.generator_loss(state, criterion, config, batch)
        return torch.autograd.grad(loss, params)

    before = resblock_pair.launches
    kernel = grads()
    assert resblock_pair.launches - before == 9  # 1 stage x 3 x 3
    assert all(p.grad is None for p in gen2.parameters())
    monkeypatch.setattr(residual, "resblock_pair", resblock_pair_plain)
    plain = grads()
    monkeypatch.undo()
    gap = torch.stack([(a - b).norm() for a, b in zip(kernel, plain)]).norm()
    norm = torch.stack([b.norm() for b in plain]).norm()
    assert (gap / norm).item() <= 1e-3
    frozen = {k: v.clone() for k, v in gen2.state_dict().items()}
    gan.make_train_step(criterion, config)(state, batch, 1e-3, 1e-3)
    for key, value in gen2.state_dict().items():
        assert torch.equal(value, frozen[key]), key


def _cache_items(n=5, seed=0):
    import numpy as np

    rng = np.random.default_rng(seed)
    return [{"audio": (0.3 * rng.standard_normal(f * 80)).astype(np.float32),
             "art": rng.standard_normal((f, 13)).astype(np.float32)}
            for f in rng.integers(30, 60, n)]


def test_device_cache_on_card_matches_cpu_and_trains(cuda):
    """The corpus cache on the card gathers the same batches, bit for bit,
    as on the CPU for the same draws; one training step runs from it."""
    import numpy as np

    from articulatory_tpu_torch.data.device_cache import DeviceCachedBatcher
    from articulatory_tpu_torch.train import gan
    from articulatory_tpu_torch.train.optimizers import build_optimizer
    from articulatory_tpu_torch.train.trainer import to_device

    gp = dict(in_channels=13 + 8, out_channels=1, channels=16,
              upsample_scales=[5, 4, 2, 2],
              upsample_kernel_sizes=[10, 8, 4, 4], use_ar=True, ar_input=64,
              ar_hidden=8, ar_output=8)
    dp = dict(scales=1, scale_discriminator_params=dict(
        channels=128, max_downsample_channels=128, downsample_scales=[4, 1]),
        periods=[2], period_discriminator_params=dict(
            channels=4, max_downsample_channels=8, downsample_scales=[3, 1]))
    config = dict(dataset_mode="a2w", hop_size=80, batch_max_steps=1600,
                  generator_type="HiFiGANGenerator", generator_params=gp,
                  discriminator_type=(
                      "HiFiGANMultiScaleMultiPeriodDiscriminator"),
                  discriminator_params=dp, use_mel_loss=True,
                  mel_loss_params=dict(fs=16000, fft_size=256, hop_size=64,
                                       num_mels=20, fmax=8000,
                                       log_base=None),
                  use_feat_match_loss=True, lambda_aux=45.0)
    items = _cache_items()
    on_card = DeviceCachedBatcher(items, config, batch_size=4, seed=1,
                                  device=cuda)
    on_cpu = DeviceCachedBatcher(items, config, batch_size=4, seed=1,
                                 device="cpu")
    for card, cpu in zip(on_card, on_cpu):
        for a, b in zip((*card["x"], card["y"], card["ar"]),
                        (*cpu["x"], cpu["y"], cpu["ar"])):
            assert a.device.type == "cuda"
            assert torch.equal(a.cpu(), b)
    gathered = next(iter(on_card))
    batch = to_device(gathered, cuda)
    assert batch["y"] is gathered["y"]  # already on the card: no copy
    gen = build_model("HiFiGANGenerator", gp).to(cuda)
    disc = build_model(config["discriminator_type"], dp, seed=1).to(cuda)
    opt = dict(lr=1e-4, betas=[0.5, 0.9])
    state = gan.GANTrainState(
        generator=gen, discriminator=disc,
        opt_g=build_optimizer("Adam", opt, -1, gen.parameters()),
        opt_d=build_optimizer("Adam", opt, -1, disc.parameters()),
        draws=gan.RandomDraws(0), steps=1)
    before = [p.detach().clone() for p in gen.parameters()]
    metrics = gan.make_train_step(gan.GANCriterion(config), config)(
        state, batch, 1e-4, 1e-4)
    assert all(np.isfinite(float(v)) for v in metrics.values())
    assert any(not torch.equal(a, p) for a, p in zip(before,
                                                     gen.parameters()))


@pytest.mark.parametrize("remat", [False, True])
def test_hybrid_train_step_kernels_match_plain(cuda, monkeypatch, remat):
    """One step's losses of the hybrid generator (its first stage on the
    bf16 pair, the last on the f32 one) and the bf16 discriminator (the
    bf16 head): the launches per dtype (two pairs a stage a forward, a
    third forward under ``use_remat``; 2 scales x 4 passes of the head),
    f32 gradients on the f32 parameters, and each model's gradients
    against both plain versions within twice the plain bf16 gradients'
    own distance from the f32 ones (relative L2 pooled)."""
    from articulatory_tpu_torch.layers import residual
    from articulatory_tpu_torch.models import hifigan
    from articulatory_tpu_torch.train import gan

    gp = dict(in_channels=13 + 8, channels=128, upsample_scales=[5, 4],
              upsample_kernel_sizes=[10, 8], resblock_kernel_sizes=[3, 7],
              resblock_dilations=[[1, 3], [1]], use_ar=True, ar_input=64,
              ar_hidden=8, ar_output=8, compute_dtype="bfloat16",
              hybrid_precision=True)
    dp = dict(scales=2, scale_discriminator_params=dict(
        channels=128, max_downsample_channels=256,
        downsample_scales=[4, 4, 1]), periods=[2, 3],
        compute_dtype="bfloat16")
    config = dict(generator_type="HiFiGANGenerator", generator_params=gp,
                  discriminator_type="HiFiGANMultiScaleMultiPeriodDiscriminator",
                  discriminator_params=dp, use_feat_match_loss=True,
                  use_stft_loss=True, stft_loss_params=dict(
                      fft_sizes=[128], hop_sizes=[32], win_lengths=[64]),
                  lambda_aux=45.0, use_remat=remat)
    gen = build_model("HiFiGANGenerator", gp).to(cuda)
    disc = build_model(config["discriminator_type"], dp, seed=1).to(cuda)
    state = gan.GANTrainState(generator=gen, discriminator=disc, opt_g=None,
                              opt_d=None, steps=1)
    criterion = gan.GANCriterion(config)
    g = torch.Generator().manual_seed(2)
    batch = {"x": (torch.randn(2, 20, 13, generator=g).to(cuda),),
             "y": (0.3 * torch.randn(2, 400, 1, generator=g)).to(cuda),
             "ar": (0.3 * torch.randn(2, 64, 1, generator=g)).to(cuda)}
    with torch.no_grad():
        fake = gan.generate(gen, batch)

    def grads():
        gl, _ = gan.generator_loss(state, criterion, config, batch)
        dl, _ = gan.discriminator_loss(state, criterion, config, batch, fake)
        return (torch.autograd.grad(gl, list(gen.parameters())),
                torch.autograd.grad(dl, list(disc.parameters())))

    resblock_pair.launches_by_dtype.clear()
    scale_disc_head.launches_by_dtype.clear()
    kernel = grads()
    forwards = 2 if remat else 1
    assert dict(resblock_pair.launches_by_dtype) == {
        "torch.bfloat16": 3 * forwards, "torch.float32": 3 * forwards}
    assert dict(scale_disc_head.launches_by_dtype) == {"torch.bfloat16": 8}
    assert all(t.dtype == torch.float32 for ts in kernel for t in ts)
    with monkeypatch.context() as m:
        m.setattr(residual, "resblock_pair", resblock_pair_plain)
        m.setattr(hifigan, "scale_disc_head", scale_disc_head_plain)
        plain = grads()
        for module in (*gen.modules(), *disc.modules()):
            if hasattr(module, "compute_dtype"):
                m.setattr(module, "compute_dtype", None)
        f32 = grads()

    def gap(got, want):
        return (torch.stack([(a - b).norm() for a, b in zip(got, want)]).norm()
                / torch.stack([b.norm() for b in want]).norm()).item()

    for got, want, exact in zip(kernel, plain, f32):
        assert gap(got, want) <= max(1e-3, 2 * gap(want, exact))


PAR_GP = dict(in_channels=13 + 8, channels=64, upsample_scales=[5, 4, 2, 2],
              upsample_kernel_sizes=[10, 8, 4, 4],
              resblock_kernel_sizes=[3, 7], resblock_dilations=[[1, 3]] * 2,
              use_ar=True, ar_input=64, ar_hidden=8, ar_output=8)
PAR_DP = dict(scales=1, scale_discriminator_params=dict(
    channels=128, max_downsample_channels=128, downsample_scales=[4, 1]),
    periods=[2], period_discriminator_params=dict(
        channels=4, max_downsample_channels=8, downsample_scales=[3, 1]))
PAR_CONFIG = dict(
    dataset_mode="a2w", batch_max_steps=800, hop_size=80,
    use_stft_loss=False, use_mel_loss=True,
    mel_loss_params=dict(fs=16000, fft_size=256, hop_size=64, num_mels=20,
                         fmin=0, fmax=8000, log_base=None),
    use_feat_match_loss=True,
    generator_adv_loss_params=dict(average_by_discriminators=False),
    discriminator_adv_loss_params=dict(average_by_discriminators=False),
    lambda_aux=45.0, lambda_feat_match=2.0,
    generator_train_start_steps=0, discriminator_train_start_steps=0,
    generator_params=dict(out_channels=1, use_ar=True, ar_input=64))
PAR_WORKER = '''
import sys

import torch

from articulatory_tpu_torch.models import build_model
from articulatory_tpu_torch.parallel import mesh, tp
from articulatory_tpu_torch.train import gan
from articulatory_tpu_torch.train.optimizers import build_optimizer
from articulatory_tpu_torch.utils.device import set_float32_parity

root, rank, mode = sys.argv[1], int(sys.argv[2]), sys.argv[3]
set_float32_parity()
mesh.init_distributed(f"file://{root}/rendezvous", 2, rank,
                      device=torch.device("cuda:0"))
lay = mesh.make_groups(2 if mode == "tp" else 1)
spec = torch.load(f"{root}/in.pt")
gen = build_model("HiFiGANGenerator", spec["gp"]).cuda()
disc = build_model("HiFiGANMultiScaleMultiPeriodDiscriminator",
                   spec["dp"]).cuda()
gen.load_state_dict(spec["gen"])
disc.load_state_dict(spec["disc"])
if mode == "tp":
    tp.shard_generator_(gen, lay.tp_group, lay.tp_rank, lay.tp)
rows = slice(None) if mode == "tp" else slice(2 * rank, 2 * rank + 2)
batch = {k: (tuple(t[rows].cuda() for t in v) if isinstance(v, tuple)
             else v[rows].cuda()) for k, v in spec["batch"].items()}
state = gan.GANTrainState(
    generator=gen, discriminator=disc,
    opt_g=build_optimizer("SGD", {}, -1, gen.parameters()),
    opt_d=build_optimizer("SGD", {}, -1, disc.parameters()), steps=1)
gan.make_train_step(gan.GANCriterion(spec["config"]), spec["config"])(
    state, batch, 1e-3, 1e-3)
full = tp.full_state(gen)[0] if mode == "tp" else gen.state_dict()
torch.save({"gen": {k: v.cpu() for k, v in full.items()},
            "disc": {k: v.cpu() for k, v in disc.state_dict().items()}},
           f"{root}/out{rank}.pt")
mesh.shutdown()
'''


@pytest.mark.parametrize("mode", ["dp", "tp"])
def test_two_ranks_on_the_card_match_one_rank(cuda, tmp_path, mode):
    """Two ranks sharing the card (gloo on CUDA tensors), data parallel on
    half the batch each or tensor parallel on the whole, take the SGD step
    one rank takes on the whole batch (both kernels on every rank)."""
    import os
    import pathlib
    import subprocess
    import sys

    from articulatory_tpu_torch.train import gan
    from articulatory_tpu_torch.train.optimizers import build_optimizer

    gen = build_model("HiFiGANGenerator", PAR_GP)
    disc = build_model("HiFiGANMultiScaleMultiPeriodDiscriminator", PAR_DP,
                       seed=1)
    g = torch.Generator().manual_seed(0)
    batch = {"x": (torch.randn(4, 10, 13, generator=g),),
             "y": 0.3 * torch.randn(4, 800, 1, generator=g),
             "ar": 0.3 * torch.randn(4, 64, 1, generator=g)}
    torch.save({"gp": PAR_GP, "dp": PAR_DP, "config": PAR_CONFIG,
                "gen": gen.state_dict(), "disc": disc.state_dict(),
                "batch": batch}, tmp_path / "in.pt")
    (tmp_path / "worker.py").write_text(PAR_WORKER)
    root = pathlib.Path(__file__).resolve().parent.parent
    env = dict(os.environ, PYTHONPATH=str(root) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen([sys.executable, str(tmp_path / "worker.py"),
                               str(tmp_path), str(r), mode], env=env)
             for r in range(2)]
    assert [p.wait(timeout=300) for p in procs] == [0, 0]
    outs = [torch.load(tmp_path / f"out{r}.pt") for r in range(2)]

    gen, disc = gen.cuda(), disc.cuda()
    state = gan.GANTrainState(
        generator=gen, discriminator=disc,
        opt_g=build_optimizer("SGD", {}, -1, gen.parameters()),
        opt_d=build_optimizer("SGD", {}, -1, disc.parameters()), steps=1)
    gan.make_train_step(gan.GANCriterion(PAR_CONFIG), PAR_CONFIG)(
        state, {k: (tuple(t.cuda() for t in v) if isinstance(v, tuple)
                    else v.cuda()) for k, v in batch.items()}, 1e-3, 1e-3)
    for name, model in (("gen", gen), ("disc", disc)):
        for key, value in model.state_dict().items():
            assert torch.equal(outs[0][name][key], outs[1][name][key]), key
            torch.testing.assert_close(outs[0][name][key], value.cpu(),
                                       rtol=1e-4, atol=1e-6)


def test_pipeline_on_streams_matches_monolith(cuda):
    """PipelinedGenerator on cuda:0, a stream a stage group: bit for bit the
    monolith on the same microbatches, 16 pairs a microbatch."""
    from articulatory_tpu_torch.parallel.pp import PipelinedGenerator

    gen = build_model("HiFiGANGenerator", PAR_GP).cuda().eval()
    gen.remove_weight_norm()
    g = torch.Generator().manual_seed(0)
    c = torch.randn(8, 20, 13, generator=g).cuda()
    ar = (0.3 * torch.randn(8, 64, 1, generator=g)).cuda()
    for groups, m in ((2, 2), (3, 4)):
        with torch.inference_mode():
            want = torch.cat([gen(a, b) for a, b in zip(c.chunk(m),
                                                        ar.chunk(m))])
        before = resblock_pair.launches
        got = PipelinedGenerator(gen, ["cuda:0"] * groups,
                                 num_microbatches=m)(c, ar)
        torch.cuda.synchronize()
        assert resblock_pair.launches - before == 16 * m
        assert torch.equal(got, want)


def test_sequence_parallel_on_card_matches_unsharded(cuda):
    from articulatory_tpu_torch.inference import LoadedModel

    gp = dict(PAR_GP, use_ar=False, in_channels=13)
    model = LoadedModel(build_model("HiFiGANGenerator", gp).cuda().eval(),
                        {"generator_params": gp}, torch.device("cuda"))
    model.remove_weight_norm()
    c = torch.randn(1, 203, 13, generator=torch.Generator().manual_seed(0))
    import torch.nn.functional as F

    padded = F.pad(c.transpose(1, 2), (0, 1)).transpose(1, 2)
    want = model(padded)[:, : 203 * 80]
    model.enable_sequence_parallel(4)
    got = model(c)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * float(
        want.abs().max()))


# --- the pair as a registered op, and the exported generator ----------------

def test_pair_op_counts_each_launch_once(cuda):
    """Through ``resblock_pair`` and through the op itself each call is one
    launch, counted as it runs, per dtype too; a generator forward launches
    one pair per (stage, K, d), as before the op."""
    from articulatory_tpu_torch.ops.resblock_pair import _OP

    args = _pair_args(cuda, 2, 301, 64, 7, torch.float32)
    before, by_dtype = (resblock_pair.launches,
                        resblock_pair.launches_by_dtype["torch.float32"])
    with torch.inference_mode():
        y = resblock_pair(*args, dilation=3)
        z = _OP(*args, 3, 0.1)
    assert resblock_pair.launches == before + 2
    assert resblock_pair.launches_by_dtype["torch.float32"] == by_dtype + 2
    torch.testing.assert_close(z, y, rtol=0, atol=0)
    model, _ = _loaded(cuda, 64)
    before = resblock_pair.launches
    with torch.inference_mode():
        model.model(torch.randn(2, 10, 13, device=cuda),
                    torch.zeros(2, 64, 1, device=cuda))
    assert resblock_pair.launches == before + PAIRS


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pair_op_captures_in_a_cuda_graph(cuda, dtype):
    """The op captured in a CUDA graph (after an eager warm-up that caches
    the f32 weight split) replays on new inputs as the eager op computes
    them; replays run no Python, so only the warm-up and the capture
    count."""
    from articulatory_tpu_torch.ops.resblock_pair import _OP, split_tf32

    with torch.inference_mode():
        x, w1, b1, w2, b2 = _pair_args(cuda, 2, 401, 128, 11, dtype)
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        before = resblock_pair.launches
        with torch.cuda.stream(stream):
            _OP(x, w1, b1, w2, b2, 5, 0.1)
        torch.cuda.current_stream().wait_stream(stream)
        splits = split_tf32.launches
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            y = _OP(x, w1, b1, w2, b2, 5, 0.1)
        assert split_tf32.launches == splits  # cached at the warm-up
        for seed in (1, 2):
            x.copy_(_pair_args(cuda, 2, 401, 128, 11, dtype, seed=seed)[0])
            graph.replay()
            torch.testing.assert_close(y, _OP(x, w1, b1, w2, b2, 5, 0.1),
                                       rtol=0, atol=0)
        assert resblock_pair.launches == before + 2 + 2


@pytest.mark.parametrize("compute", [{}, {"compute_dtype": "bfloat16",
                                          "hybrid_precision": True}],
                         ids=["f32", "hybrid"])
def test_exported_forward_is_the_eager_forward(cuda, compute):
    """``export.to_torch_export`` of a frozen AR generator on the card, sent
    through ``serialize`` / ``deserialize``: the graph holds one pair op a
    (stage, K, d), the loaded program's forward equals the eager forward bit
    for bit and launches the hand kernel once a pair; its f32 pairs split
    their weights in the first forward only."""
    from articulatory_tpu_torch import export

    model, _ = _loaded(cuda, 64, **compute)
    gen = torch.Generator(device=cuda).manual_seed(0)
    c = torch.randn(4, 10, 13, device=cuda, generator=gen)
    ar = torch.randn(4, 64, 1, device=cuda, generator=gen)
    with torch.inference_mode():
        want = model.model(c, ar)
    ep = export.to_torch_export(model.model, (c, ar))
    assert export.pair_nodes(ep) == PAIRS
    program = export.deserialize(export.serialize(ep)).module()
    before, splits = resblock_pair.launches, split_tf32.launches
    f32_pairs = resblock_pair.launches_by_dtype["torch.float32"]
    with torch.inference_mode():
        got = program(c, ar)
        first = split_tf32.launches - splits
        again = program(c, ar)
    assert resblock_pair.launches == before + 2 * PAIRS
    # the f32 pairs split their weights, the program's constants, once
    assert 2 * first == resblock_pair.launches_by_dtype[
        "torch.float32"] - f32_pairs and split_tf32.launches == splits + first
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(again, want, rtol=0, atol=0)


# --- the co-training parity harness against its committed artifact ----------

COTRAIN_STEPS = 20


def test_cotrain_against_artifact_on_card(cuda):
    """``tools/cotrain_parity.py --against`` the committed f32-wide artifact
    for its first COTRAIN_STEPS steps on the card: the inputs remade from
    the artifact's seed match its digests (``against`` raises otherwise),
    the steps' per-step mel stays within the artifact's pre-disc bound
    against JAX's, and the steps launch 72 pairs and 12 heads each, every
    one splitting its weights once (``chip_smoke.expected_launches``)."""
    import sys

    from articulatory_tpu_torch.tools import cotrain_parity

    root = str(cotrain_parity.ROOT)
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_smoke

    path = cotrain_parity.artifact_path("f32-wide")
    report = cotrain_parity.against(path, "cuda", steps=COTRAIN_STEPS)
    saved, _ = cotrain_parity.load_artifact(path)
    assert report["digests"] == saved["digests"]
    assert report["ok"], report["failures"]
    assert len(report["port"]["logs"]) == COTRAIN_STEPS
    assert report["checks"]["pre_disc_mel_max_rel"] <= \
        report["checks"]["pre_disc_mel_max_rel_bound"]
    a = cotrain_parity.settings(saved)
    config = cotrain_parity.train_config(a, saved["gen_cfg"],
                                         saved["disc_cfg"])
    assert report["port"]["launches"]["train"] == \
        chip_smoke.expected_launches(config, COTRAIN_STEPS)


# --- the banded relative-position attention ----------------------------------

def _banded_args(device, b, h, length, d, m, seed=0):
    gen = torch.Generator().manual_seed(seed)
    q, k, v, do = (torch.randn(b, h, length, d, generator=gen)
                   for _ in range(4))
    table = torch.randn(h, 2 * m - 1, d, generator=gen) * d ** -0.5
    keep = torch.rand(b, h, length, 2 * m - 1, generator=gen) >= 0.2
    return [t.to(device) for t in (q, k, v, table, keep, do)]


def _banded_grads(q, k, v, table, keep, p, do):
    """o and the gradients of q, k, v and the table: the plain version for
    float64, the kernels otherwise."""
    from articulatory_tpu_torch.ops.banded_attention import (
        banded_attention,
        banded_attention_plain,
    )
    attend = (banded_attention_plain if q.dtype == torch.float64
              else banded_attention)
    args = [t.detach().requires_grad_(True) for t in (q, k, v, table)]
    o = attend(*args, keep if p else None, p)
    return [o.detach(), *torch.autograd.grad(o, args, do)]


@pytest.mark.parametrize("b,h,length,d,m,p", [
    (32, 8, 2000, 96, 100, 0.2),  # the inversion cell's layer
    (32, 8, 2000, 96, 100, 0.0),
    (2, 8, 300, 96, 100, 0.2),    # L not a multiple of the tiles
    (1, 8, 150, 96, 100, 0.2),    # L below 2m - 1
    (2, 3, 37, 16, 100, 0.2),     # L below m
    (2, 4, 130, 16, 5, 0.1),      # a narrow band
    (2, 8, 257, 8, 100, 0.2),     # d below the smallest tile
])
def test_banded_attention_kernels_match_float64(cuda, b, h, length, d, m, p):
    """The f32 kernels (3xTF32) against the plain version in float64 on the
    card: o and the gradients of q, k, v and the table within 1e-5 of each
    one's largest magnitude; one launch forward and one backward, counted
    per dtype; the same numbers, bit for bit, from call to call."""
    from articulatory_tpu_torch.ops.banded_attention import (
        banded_attention,
        banded_attention_backward,
    )
    q, k, v, table, keep, do = _banded_args(cuda, b, h, length, d, m)
    want = _banded_grads(*(t.double() for t in (q, k, v, table)), keep, p,
                         do.double())
    before = (banded_attention.launches, banded_attention_backward.launches,
              banded_attention.launches_by_dtype["torch.float32"])
    got = _banded_grads(q, k, v, table, keep, p, do)
    assert (banded_attention.launches, banded_attention_backward.launches,
            banded_attention.launches_by_dtype["torch.float32"]) == tuple(
                n + 1 for n in before)
    for name, a, w in zip(("o", "dq", "dk", "dv", "dE"), got, want):
        err = float((a.double() - w).abs().max() / w.abs().max())
        assert err < 1e-5, (name, err)
    again = _banded_grads(q, k, v, table, keep, p, do)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_banded_attention_refuses_other_types_on_the_card(cuda):
    """A CUDA tensor of a type the kernels do not take raises; nothing runs
    the plain version in its place."""
    from articulatory_tpu_torch.ops.banded_attention import banded_attention
    q, k, v, table, keep, _ = _banded_args(cuda, 1, 2, 40, 16, 5)
    before = banded_attention.launches
    for dtype in (torch.float64, torch.float16):
        with pytest.raises(TypeError, match="banded_attention_plain"):
            banded_attention(*(t.to(dtype) for t in (q, k, v, table)), keep,
                             0.2)
    assert banded_attention.launches == before


def test_banded_attention_bf16_kernels_match_plain(cuda):
    """bfloat16 storage, float32 sums: within bf16's rounding of the plain
    version in float32."""
    args = _banded_args(cuda, 2, 8, 300, 96, 100)
    want = _banded_grads(*args[:4], args[4], 0.2, args[5])
    got = _banded_grads(*(t.bfloat16() for t in args[:4]), args[4], 0.2,
                        args[5].bfloat16())
    for name, a, w in zip(("o", "dq", "dk", "dv", "dE"), got, want):
        err = float((a.float() - w).abs().max() / w.abs().max())
        assert err < 3e-2, (name, err)


def test_transformer_step_runs_the_banded_kernels(cuda):
    """A Transformer's training step on the card with dropout 0.2 launches
    one banded forward and one backward a layer, and its loss and
    gradients agree with the same model in float64 on the card (the plain
    version), the same masks drawn by tag."""
    from articulatory_tpu_torch.ops.banded_attention import (
        banded_attention,
        banded_attention_backward,
    )
    from articulatory_tpu_torch.train import gan
    from articulatory_tpu_torch.train.optimizers import build_optimizer

    gp = dict(in_channels=16, out_channels=4, hidden_dim=64, elayers=2,
              dropout=0.2)
    torch.manual_seed(0)
    model = build_model("Transformer", gp)
    x = torch.randn(2, 300, 16, device=cuda)
    y = torch.randn(2, 300, 4, device=cuda)

    def grads(dtype):
        gen = build_model("Transformer", gp).to(cuda, dtype).train()
        gen.load_state_dict(model.state_dict())
        draws = gan.RandomDraws(9)
        draws.at(1)
        loss = torch.mean(torch.abs(gen(x.to(dtype), draws=draws)
                                    - y.to(dtype)))
        return loss, torch.autograd.grad(loss, list(gen.parameters()))

    loss, got = grads(torch.float32)
    want_loss, want = grads(torch.float64)
    assert float(loss) == pytest.approx(float(want_loss), rel=1e-5)
    # against the median leaf's norm where a leaf's is smaller: the conv
    # biases under BatchNorm take gradients of round-off alone
    median = sorted(float(w.norm()) for w in want)[len(want) // 2]
    for a, w in zip(got, want):
        assert float((a.double() - w).norm()) < 1e-4 * max(
            float(w.norm()), median)
    config = dict(dataset_mode="w2a", use_stft_loss=False, use_mel_loss=True,
                  lambda_aux=1.0, generator_train_start_steps=0)
    gen = build_model("Transformer", gp).to(cuda)
    state = gan.GANTrainState(
        generator=gen, discriminator=None, opt_d=None, steps=1,
        opt_g=build_optimizer("Adam", {"lr": 1e-4}, -1, gen.parameters()))
    step = gan.make_train_step(gan.GANCriterion(config), config)
    before = banded_attention.launches, banded_attention_backward.launches
    step(state, {"x": (x,), "y": y}, 1e-4, None)
    torch.cuda.synchronize()
    assert (banded_attention.launches - before[0],
            banded_attention_backward.launches - before[1]) == (2, 2)
