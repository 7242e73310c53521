"""The CUDA kernel against its plain version on the card, and the generator
on the card against the same generator on the CPU. Marked ``gpu``: without a
CUDA device each test skips. This file imports no JAX, so on a machine with
a card and no JAX it runs as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_gpu.py
"""

import pytest
import torch

from articulatory_tpu_torch.models import build_model
from articulatory_tpu_torch.ops.resblock_pair import (
    resblock_pair,
    resblock_pair_plain,
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


@pytest.mark.parametrize("b,t,c,k,d", [
    (2, 537, 256, 11, 5),   # widest stage, worst-case shared memory
    (3, 2003, 128, 7, 3),   # ragged tile
    (1, 8000, 32, 3, 1),
    (2, 1, 64, 11, 5),      # T = 1
    (2, 100, 30, 3, 3),     # C % 4 != 0: the scalar path
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
