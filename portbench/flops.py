"""Model FLOPs and hand-kernel calls of a configuration, from its shapes.

A convolution or linear layer counts 2 x multiply-adds; activations,
additions, pooling, the STFT and the mel matrix are left out (each under
0.1 % of a step). A transposed convolution of stride s scatters each input
frame into k taps: 2 x T_in x C_in x C_out x k.
"""

from __future__ import annotations

from portbench.reference.discriminators import (
    period_layers,
    pooled_length,
    scale_layers,
)
from portbench.reference.hifigan import stage_dtypes


def past_encoder_flops(gp: dict) -> float:
    if not gp.get("use_ar", False):
        return 0.0
    dims = [gp["ar_input"]] + [gp["ar_hidden"]] * 4 + [gp["ar_output"]]
    return 2.0 * sum(a * b for a, b in zip(dims, dims[1:]))


def generator_flops(gp: dict, frames: int) -> float:
    """One lane's generator forward over ``frames`` feature frames."""
    ch, k = gp["channels"], gp["kernel_size"]
    flops = past_encoder_flops(gp) + 2.0 * frames * gp["in_channels"] * ch * k
    t = frames
    for i, (s, uk) in enumerate(zip(gp["upsample_scales"],
                                    gp["upsample_kernel_sizes"])):
        c_in, c_out = ch // 2 ** i, ch // 2 ** (i + 1)
        flops += 2.0 * t * c_in * c_out * uk
        t *= s
        for rk, dil in zip(gp["resblock_kernel_sizes"],
                           gp["resblock_dilations"]):
            flops += len(dil) * 4.0 * t * c_out * c_out * rk
    c_last = ch // 2 ** len(gp["upsample_scales"])
    return flops + 2.0 * t * c_last * gp.get("out_channels", 1) * k


def pair_calls(gp: dict, precision: str, batch: int,
               frames: int) -> list[tuple]:
    """The hand pair's calls in one generator forward of ``batch`` lanes:
    (b, t, c, k, dtype) each."""
    _, dts = stage_dtypes(gp, precision)
    calls, t = [], frames
    for i, s in enumerate(gp["upsample_scales"]):
        t *= s
        c = gp["channels"] // 2 ** (i + 1)
        dtype = "bf16" if str(dts[i]).endswith("bfloat16") else "f32"
        for rk, dil in zip(gp["resblock_kernel_sizes"],
                           gp["resblock_dilations"]):
            calls += [(batch, t, c, rk, dtype)] * len(dil)
    return calls


def scale_flops(sp: dict, t: int) -> float:
    flops = 0.0
    for layer in scale_layers(sp):
        t = (t - 1) // layer["stride"] + 1
        flops += (2.0 * t * layer["c_out"] * (layer["c_in"] // layer["groups"])
                  * layer["k"])
    return flops


def period_flops(pp: dict, period: int, t: int) -> float:
    h = -(-t // period)
    flops = 0.0
    for layer in period_layers(pp):
        h = (h + 2 * layer["pad"] - layer["k"]) // layer["stride"] + 1
        flops += 2.0 * h * period * layer["c_out"] * layer["c_in"] * layer["k"]
    return flops


def discriminator_flops(dp: dict, t: int) -> float:
    """One row's multi-scale multi-period forward over ``t`` samples."""
    sp = dp["scale_discriminator_params"]
    pp = dp["period_discriminator_params"]
    flops, ts = 0.0, t
    for _ in range(dp["scales"]):
        flops += scale_flops(sp, ts)
        ts = pooled_length(ts, dp["scale_downsample_pooling_params"])
    return flops + sum(period_flops(pp, p, t) for p in dp["periods"])


def head_calls(dp: dict, batch: int, t: int) -> list[tuple]:
    """The hand head's calls in one discriminator forward: (b, t, ch, k0,
    k1, groups, stride) a scale, where the scale discriminator's first two
    layers are the head's shape."""
    sp = dp["scale_discriminator_params"]
    first, second = scale_layers(sp)[:2]
    calls, ts = [], t
    for _ in range(dp["scales"]):
        calls.append((batch, ts, first["c_out"], first["k"], second["k"],
                      second["groups"], second["stride"]))
        ts = pooled_length(ts, dp["scale_downsample_pooling_params"])
    return calls


# discriminator forwards a training step costs: the generator loss's fake
# pass and its backward to the input (2) and its real pass (1); the
# discriminator loss's real and fake passes (2) and their backward, weight
# and activation gradients (4)
DISC_FORWARDS_A_STEP = 9
# the discriminator forwards that call the head: the two of each loss
HEAD_FORWARDS_A_STEP = 4
# generator forwards a step costs: forward and backward (3), regeneration (1)
GEN_FORWARDS_A_STEP = 4


def disc_length(model: dict) -> int:
    """Samples a row the discriminator sees: the AR past before the crop."""
    gp = model["generator_params"]
    past = gp["ar_input"] if gp.get("use_ar", False) else 0
    return model["batch_max_steps"] + past


def train_step_flops(model: dict, batch: int) -> float:
    gp, dp = model["generator_params"], model["discriminator_params"]
    frames = model["batch_max_steps"] // model["hop_size"]
    return batch * (GEN_FORWARDS_A_STEP * generator_flops(gp, frames)
                    + DISC_FORWARDS_A_STEP
                    * discriminator_flops(dp, disc_length(model)))
