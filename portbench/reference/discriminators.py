"""Plain PyTorch reference of HiFi-GAN's multi-scale multi-period
discriminator (arXiv:2010.05646) as the recipes configure it.

Functions of a state dict under the recipe's torch parameter names:
``msd.discriminators.{i}.layers.{j}[.0]`` (grouped Conv1d stacks, no
norm) and ``mpd.discriminators.{i}.convs.{j}.0`` / ``output_conv``
(Conv2d over the waveform folded by its period, weight norm). Inputs and
feature maps are channel-first. ``scale_layers`` and ``period_layers`` are
the layer plans that the parameter shapes and ``flops.py`` both read.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference.hifigan import _conv_shapes, weight


def scale_layers(sp: dict) -> list[dict]:
    """The scale discriminator's convolutions in order: in, out, kernel,
    stride, groups, and whether a LeakyReLU follows."""
    k0, k1, k2, k3 = sp["kernel_sizes"]
    ch, top = sp["channels"], sp["max_downsample_channels"]
    layers = [dict(c_in=sp["in_channels"], c_out=ch, k=k0, stride=1,
                   groups=1, act=True)]
    c_in = c_out = ch
    groups = 4
    for s in sp["downsample_scales"]:
        layers.append(dict(c_in=c_in, c_out=c_out, k=k1, stride=s,
                           groups=groups, act=True))
        c_in = c_out
        c_out = min(c_in * 2, top)
        groups = min(groups * 4, sp["max_groups"])
    c_out = min(c_in * 2, top)
    layers.append(dict(c_in=c_in, c_out=c_out, k=k2, stride=1, groups=1,
                       act=True))
    layers.append(dict(c_in=c_out, c_out=sp["out_channels"], k=k3, stride=1,
                       groups=1, act=False))
    return layers


def period_layers(pp: dict) -> list[dict]:
    """The period discriminator's Conv2d layers (kernels (k, 1)) in order;
    the last is the output conv."""
    k0, k1 = pp["kernel_sizes"]
    c_in, c_out = pp["in_channels"], pp["channels"]
    layers = []
    for s in pp["downsample_scales"]:
        layers.append(dict(c_in=c_in, c_out=c_out, k=k0, stride=s,
                           pad=(k0 - 1) // 2, act=True))
        c_in = c_out
        c_out = min(c_out * 4, pp["max_downsample_channels"])
    layers.append(dict(c_in=c_in, c_out=pp["out_channels"], k=k1 - 1,
                       stride=1, pad=(k1 - 1) // 2, act=False))
    return layers


def discriminator_shapes(dp: dict) -> dict:
    shapes = {}
    sp = dp["scale_discriminator_params"]
    pp = dp["period_discriminator_params"]
    plan = scale_layers(sp)
    for i in range(dp["scales"]):
        for j, l in enumerate(plan):
            name = f"msd.discriminators.{i}.layers.{j}" + (
                ".0" if l["act"] else "")
            shapes.update(_conv_shapes(name, l["c_out"],
                                       l["c_in"] // l["groups"], l["k"],
                                       False, sp.get("bias", True)))
    plan = period_layers(pp)
    norm = pp.get("use_weight_norm", True)
    for i in range(len(dp["periods"])):
        for j, l in enumerate(plan):
            name = (f"mpd.discriminators.{i}.convs.{j}.0" if l["act"]
                    else f"mpd.discriminators.{i}.output_conv")
            shapes.update(_conv_shapes(name, l["c_out"], l["c_in"],
                                       (l["k"], 1), norm,
                                       pp.get("bias", True) or not l["act"]))
    return shapes


def pooled_length(t: int, pool: dict) -> int:
    return ((t + 2 * pool["padding"] - pool["kernel_size"]) // pool["stride"]
            + 1)


def discriminator(w: dict, dp: dict, x: torch.Tensor) -> list[list]:
    """x (B, 1, T) -> one list of feature maps a sub-discriminator (scales
    first, then periods), the last of each the logits."""
    sp = dp["scale_discriminator_params"]
    pp = dp["period_discriminator_params"]
    pool = dp["scale_downsample_pooling_params"]
    slope = sp["nonlinear_activation_params"]["negative_slope"]
    outs = []
    plan = scale_layers(sp)
    xs = x
    for i in range(dp["scales"]):
        h, feats = xs, []
        for j, l in enumerate(plan):
            name = f"msd.discriminators.{i}.layers.{j}" + (
                ".0" if l["act"] else "")
            h = F.conv1d(h, weight(w, name), w.get(f"{name}.bias"),
                         stride=l["stride"], padding=(l["k"] - 1) // 2,
                         groups=l["groups"])
            if l["act"]:
                h = F.leaky_relu(h, slope)
            feats.append(h)
        outs.append(feats)
        xs = F.avg_pool1d(xs, pool["kernel_size"], pool["stride"],
                          pool["padding"])
    pslope = pp["nonlinear_activation_params"]["negative_slope"]
    plan = period_layers(pp)
    for i, p in enumerate(dp["periods"]):
        b, c, t = x.shape
        h = x
        if t % p:
            h = F.pad(h, (0, p - t % p), mode="reflect")
        h = h.reshape(b, c, -1, p)
        feats = []
        for j, l in enumerate(plan):
            name = (f"mpd.discriminators.{i}.convs.{j}.0" if l["act"]
                    else f"mpd.discriminators.{i}.output_conv")
            h = F.conv2d(h, weight(w, name), w.get(f"{name}.bias"),
                         stride=(l["stride"], 1), padding=(l["pad"], 0))
            if l["act"]:
                h = F.leaky_relu(h, pslope)
            feats.append(h)
        feats[-1] = feats[-1].flatten(1)
        outs.append(feats)
    return outs
