"""flops.py and the kernel tables against counts worked by hand."""

import pytest

from portbench import flops
from portbench.core import manifest, peaks
from portbench.kernels import resblock_pair, scale_disc_head


def model(config):
    return manifest.read_json(manifest.BENCH / "configs"
                              / f"{config}.json")["model"]


def ema_chunk_by_hand() -> float:
    """EMA, one lane, 25 frames -> 2000 samples; MRF: 3 blocks (K 3, 7,
    11) x 3 dilations, each a pair of K-tap convolutions."""
    enc = 2 * (512 * 256 + 3 * 256 * 256 + 256 * 128)
    conv_in = 2 * 25 * 141 * 512 * 7
    ups = [(25, 512, 256, 10), (125, 256, 128, 8), (500, 128, 64, 4),
           (1000, 64, 32, 4)]
    up = sum(2 * t * ci * co * k for t, ci, co, k in ups)
    mrf = sum(3 * 4 * t * c * c * 21 for t, c in
              ((125, 256), (500, 128), (1000, 64), (2000, 32)))
    return enc + conv_in + up + mrf + 2 * 2000 * 32 * 7


def test_ema_sample():
    gp = model("ema-hifigan-car")["generator_params"]
    assert flops.generator_flops(gp, 25) == ema_chunk_by_hand()
    assert flops.generator_flops(gp, 25) / 2000 == pytest.approx(2.94e6,
                                                                 rel=2e-3)


def test_mri_sample():
    gp = model("mri-hifigan-car")["generator_params"]
    mrf = sum(3 * 4 * t * c * c * 21 for t, c in
              ((1000, 256), (5000, 128), (15000, 64), (30000, 32)))
    ups = sum(2 * t * ci * co * k for t, ci, co, k in
              ((125, 512, 256, 16), (1000, 256, 128, 10),
               (5000, 128, 64, 6), (15000, 64, 32, 4)))
    by_hand = (2 * (512 * 256 + 3 * 256 * 256 + 256 * 128)
               + 2 * 125 * 358 * 512 * 7 + ups + mrf + 2 * 30000 * 32 * 7)
    assert flops.generator_flops(gp, 125) == by_hand
    assert by_hand / 30000 == pytest.approx(2.088e6, rel=1e-3)


def test_pair_calls_and_bound():
    gp = model("mri-hifigan-car")["generator_params"]
    calls = flops.pair_calls(gp, "hybrid", 16, 125)
    assert len(calls) == 36
    assert {c[4] for c in calls[:27]} == {"bf16"} and {
        c[4] for c in calls[27:]} == {"f32"}
    assert calls[0][:4] == (16, 1000, 256, 3) and calls[-1][:4] == (
        16, 30000, 32, 11)
    # one f32 pair, B 16, T 500, C 128, K 7: 4 B T C^2 K flops at three
    # TF32 products against 495 TFLOP/s; its bytes are far below
    f = 4 * 16 * 500 * 128 * 128 * 7
    assert resblock_pair.bound_s(16, 500, 128, 7, "f32") == pytest.approx(
        3 * f / peaks.TF32_FLOPS)
    # bf16 at C 32 is bound by bytes: x and y of B T C two bytes each
    b = (2 * 16 * 30000 * 32 + 2 * 3 * 32 * 32 + 2 * 32) * 2
    assert resblock_pair.bound_s(16, 30000, 32, 3, "bf16") == pytest.approx(
        b / peaks.HBM_BYTES)


def test_head_and_step():
    m = model("ema-hifigan-car")
    dp = m["discriminator_params"]
    calls = flops.head_calls(dp, 64, flops.disc_length(m))
    assert [c[1] for c in calls] == [2512, 1257, 629]
    t1 = 628
    f = 2 * 64 * 2512 * 128 * 15 + 2 * 64 * t1 * 128 * 32 * 41
    assert scale_disc_head.bound_s(*calls[0], "f32") == pytest.approx(
        3 * f / peaks.TF32_FLOPS)
    assert flops.train_step_flops(m, 64) == pytest.approx(3.71e12, rel=5e-3)
