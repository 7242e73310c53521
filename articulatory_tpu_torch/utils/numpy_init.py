"""Random HiFi-GAN weights from a seed with numpy alone, in the JAX
package's parameter layout.

``numpy_generator_params`` makes a ``HiFiGANGenerator`` tree and
``numpy_msmpd_params`` a ``HiFiGANMultiScaleMultiPeriodDiscriminator``
tree, both with torch's default initialisation (U(+-1/sqrt(fan_in)),
fan_in = input channels per group x kernel taps; a transposed conv's fan
counts its output channels). Weight-normed layers start at g = ||v||, so
their effective weight is v. ``utils/weights.py`` turns the trees into the
reference's state dicts (``jax_params_to_state_dict``,
``jax_msmpd_to_state_dict``), so a machine without JAX and without a torch
RNG stream remakes the same weights bit for bit from the seed."""

from __future__ import annotations

import numpy as np


def _uniform(rng: np.random.Generator, shape, fan_in: int) -> np.ndarray:
    bound = 1.0 / np.sqrt(fan_in)
    return rng.uniform(-bound, bound, shape).astype(np.float32)


def _conv(rng: np.random.Generator, kernel: tuple, c_in: int, c_out: int,
          weight_norm: bool, transpose: bool = False, groups: int = 1,
          bias: bool = True) -> dict:
    """A conv of kernel ``kernel`` (taps per axis), JAX layout
    (*kernel, C_in / groups, C_out); g over every axis but C_out (a
    transposed conv's g per input channel, as the JAX package keeps it)."""
    taps = int(np.prod(kernel))
    fan_in = (c_out if transpose else c_in // groups) * taps
    v = _uniform(rng, tuple(kernel) + (c_in // groups, c_out), fan_in)
    p = {}
    if weight_norm:
        keep = len(kernel) + (0 if transpose else 1)
        axes = tuple(a for a in range(v.ndim) if a != keep)
        p["v"], p["g"] = v, np.sqrt((v * v).sum(axis=axes, keepdims=True))
    else:
        p["w"] = v
    if bias:
        p["b"] = _uniform(rng, (c_out,), fan_in)
    return p


def numpy_generator_params(gp: dict, seed: int) -> dict:
    """A HiFiGANGenerator param tree in the JAX package's layout: conv
    (K, C_in, C_out) with weight norm (g = ||v||), transposed conv pre-flipped
    with per-input-channel g, dense (in, out); torch-default U(+-1/sqrt(fan_in))."""
    rng = np.random.default_rng(seed)

    def conv(k, c_in, c_out, transpose=False):
        return _conv(rng, (k,), c_in, c_out, True, transpose)

    ch, k = gp["channels"], gp["kernel_size"]
    tree = {"input_conv": conv(k, gp["in_channels"], ch)}
    for i, uk in enumerate(gp["upsample_kernel_sizes"]):
        c_in, c_out = ch // 2 ** i, ch // 2 ** (i + 1)
        tree[f"upsample_{i}"] = conv(uk, c_in, c_out, transpose=True)
        for j, (rk, rd) in enumerate(zip(gp["resblock_kernel_sizes"],
                                         gp["resblock_dilations"])):
            tree[f"block_{i}_{j}"] = {f"convs{n}_{d}": conv(rk, c_out, c_out)
                                      for n in (1, 2) for d in range(len(rd))}
    tree["output_conv"] = conv(k, ch // 2 ** len(gp["upsample_scales"]),
                               gp["out_channels"])
    if gp.get("use_ar", False):
        dims = [gp["ar_input"]] + [gp["ar_hidden"]] * 4 + [gp["ar_output"]]
        tree["ar_model"] = {
            f"fc{i}": {"w": _uniform(rng, (dims[i], dims[i + 1]), dims[i]),
                       "b": _uniform(rng, (dims[i + 1],), dims[i])}
            for i in range(5)}
    return tree


def numpy_msmpd_params(dp: dict, seed: int) -> dict:
    """A HiFiGANMultiScaleMultiPeriodDiscriminator param tree in the JAX
    package's layout: ``msd/disc_i/layer_k`` plain convs (K, C_in / groups,
    C_out) (the scale stack's norms are no-ops, as in both packages), and
    ``mpd/disc_i/conv_k`` and ``output_conv`` Conv2d (Kh, 1, C_in, C_out)
    with weight norm; the defaults are the models'."""
    rng = np.random.default_rng(seed)
    sp = dict(dp.get("scale_discriminator_params", {}))
    k0, k1, k2, k3 = sp.get("kernel_sizes", (15, 41, 5, 3))
    channels = sp.get("channels", 128)
    max_ch = sp.get("max_downsample_channels", 1024)
    max_groups = sp.get("max_groups", 16)
    bias = sp.get("bias", True)
    msd = {}
    for i in range(dp.get("scales", 3)):
        layers = [(k0, sp.get("in_channels", 1), channels, 1)]
        in_ch = out_ch = channels
        groups = 4
        for _ in sp.get("downsample_scales", (2, 2, 4, 4, 1)):
            layers.append((k1, in_ch, out_ch, groups))
            in_ch, out_ch = out_ch, min(out_ch * 2, max_ch)
            groups = min(groups * 4, max_groups)
        out_ch = min(in_ch * 2, max_ch)
        layers += [(k2, in_ch, out_ch, 1),
                   (k3, out_ch, sp.get("out_channels", 1), 1)]
        msd[f"disc_{i}"] = {
            f"layer_{n}": _conv(rng, (k,), c_in, c_out, False, groups=g,
                                bias=bias)
            for n, (k, c_in, c_out, g) in enumerate(layers)}
    pp = dict(dp.get("period_discriminator_params", {}))
    if pp.get("use_spectral_norm", False):
        raise ValueError("spectral-normed period discriminators carry "
                         "their power-iteration state: not made here")
    wn = pp.get("use_weight_norm", True)
    pk0, pk1 = pp.get("kernel_sizes", (5, 3))
    mpd = {}
    for i, _ in enumerate(dp.get("periods", (2, 3, 5, 7, 11))):
        disc, in_ch, out_ch = {}, pp.get("in_channels", 1), pp.get(
            "channels", 32)
        for n, _ in enumerate(pp.get("downsample_scales", (3, 3, 3, 3, 1))):
            disc[f"conv_{n}"] = _conv(rng, (pk0, 1), in_ch, out_ch, wn,
                                      bias=pp.get("bias", True))
            in_ch = out_ch
            out_ch = min(out_ch * 4, pp.get("max_downsample_channels", 1024))
        disc["output_conv"] = _conv(rng, (pk1 - 1, 1), in_ch,
                                    pp.get("out_channels", 1), wn)
        mpd[f"disc_{i}"] = disc
    return {"msd": msd, "mpd": mpd}
