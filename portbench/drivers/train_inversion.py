"""Inversion training of a generator without an adversary:
``train/gan.py::make_train_step(criterion, config)``'s ``train_step(state,
batch, lr_g, None)`` with no discriminator, one step after another, each
ending in a device synchronisation.

The state is the generator (the configuration's ``generator_type``) with
the benchmark's weights, its Adam optimizer from the configuration and
``RandomDraws`` from the seed, which also draws the dropout masks. Set-up
runs ``warm_steps`` steps. The output check reads, as ``train_step``'s
does, two runs of ``checked_steps`` steps against the plain reference
(``reference/train_inversion.py``) on the same batches and masks: the
first steps of set-up, from the seed's weights, and the window's first
steps, from a copy of the state (weights, Adam's moments and step count)
taken as the window opens. Of each it reads the loss of every step, the
first gradient (Adam's first moment after the first update, less
``beta1`` times the one before it, over ``1 - beta1``) and each
parameter's change over the steps.

Each step's batch is made on the card from the seed, as
``bin/predict_ema.py`` feeds HuBERT states: ``batch`` windows of
``batch_max_steps`` rows at ``sampling_rate``, whose ``in_channels``-wide
inputs are smoothed normal noise drawn at ``feature_rate`` and
interpolated linearly (``align_corners=False``) to the EMA rate, and whose
targets are ``out_channels`` smooth trajectories (normal noise under a
``TARGET_SMOOTH``-row box, unit variance).

Weights are drawn on the card from the seed with each layer's own
initialisation (``reference/transformer.py::parameter_shapes``): torch's
uniform defaults for the convolutions and linear layers, the published
normals of the attention and its table, ones and zeros for the norms.
"""

from __future__ import annotations

import math
import sys

import torch
import torch.nn.functional as F

from portbench.core import seeds, traffic
from portbench.core.trace import span, synchronize
from portbench.drivers.train_step import (
    _device_norms,
    _moment,
    _settle,
    _worst_leaf,
    leaf_norms,
)
from portbench.reference.hifigan import no_tf32
from portbench.reference.train_inversion import LOSS, InversionTrainer
from portbench.reference.transformer import parameter_shapes

TARGET_SMOOTH = 41


def make_weights(gp: dict, seed: int, dev) -> dict:
    """The generator's state dict, drawn on ``dev`` from ``seed``."""
    shapes = parameter_shapes(gp)
    total = sum(math.prod(s) for s, _ in shapes.values())
    g = seeds.generator(seed, dev, "weights", "generator")
    uniform = torch.empty(total, device=dev).uniform_(-1.0, 1.0, generator=g)
    normal = torch.empty(total, device=dev).normal_(generator=g)
    state, at = {}, 0
    for name, (shape, init) in shapes.items():
        n = math.prod(shape)
        if init[0] == "uniform":
            t = uniform[at:at + n] * init[1]
        elif init[0] == "normal":
            t = normal[at:at + n] * init[1]
        else:
            t = torch.full((n,), 1.0 if init[0] == "ones" else 0.0,
                           device=dev)
        state[name] = (t.long() if name.endswith("num_batches_tracked")
                       else t).view(shape)
        at += n
    return state


class Driver:
    def __init__(self, cell, seed: int, dev: torch.device):
        from articulatory_tpu_torch.models import build_model
        from articulatory_tpu_torch.train import gan
        from articulatory_tpu_torch.train.optimizers import build_optimizer
        self.cell, self.seed, self.dev = cell, seed, dev
        self.model = m = cell.model
        gp = m["generator_params"]
        self.weights = make_weights(gp, seed, dev)
        gen = build_model(m["generator_type"], gp).to(dev)
        gen.load_state_dict(self.weights, strict=True)
        self.params = {k: self.weights[k] for k, _ in
                       gen.named_parameters()}
        opt = build_optimizer(m["generator_optimizer_type"],
                              m["generator_optimizer_params"],
                              m.get("generator_grad_norm", -1),
                              gen.parameters())
        self.draws_seed = seeds.sub_seed(seed, "draws")
        self.state = gan.GANTrainState(
            generator=gen, discriminator=None, opt_g=opt, opt_d=None,
            draws=gan.RandomDraws(self.draws_seed))
        self.step_fn = gan.make_train_step(gan.GANCriterion(m), m)
        self.lr = m["generator_optimizer_params"]["lr"]
        self.failed = []     # a flag for each step of the window
        self.attention = []  # the attention's forward launches each step
        self.readings = self.window = self.start = None

    def batch(self, j: int) -> dict:
        m, t = self.model, self.cell.traffic
        gp, b = m["generator_params"], t["batch"]
        rows = m["batch_max_steps"]
        up = round(m["sampling_rate"] / t["feature_rate"])
        g = seeds.generator(self.seed, self.dev, "batch", j)

        def smooth(channels, length, box):
            z = torch.randn((b, channels, length + box - 1), generator=g,
                            device=self.dev)
            return F.conv1d(z, torch.full((channels, 1, box), box ** -0.5,
                                          device=self.dev), groups=channels)

        x = F.interpolate(smooth(gp["in_channels"], -(-rows // up),
                                 traffic.SMOOTH_FRAMES), scale_factor=up,
                          mode="linear", align_corners=False)[..., :rows]
        y = smooth(gp["out_channels"], rows, TARGET_SMOOTH)
        return {"x": (x.transpose(1, 2).contiguous(),),
                "y": y.transpose(1, 2).contiguous()}

    def _step(self, j: int) -> dict:
        metrics = self.step_fn(self.state, self.batch(j), self.lr, None)
        synchronize(self.dev)
        return metrics

    def _read(self, readings: dict, step: int, metrics: dict,
              start) -> None:
        """Into ``readings``, step ``step`` of ``checked_steps`` from
        ``start`` (the snapshot they began from, or None at the seed)."""
        readings["losses"].append(float(metrics[f"train/{LOSS}"]))
        opt = self.state.opt_g.optimizer
        named = dict(self.state.generator.named_parameters())
        if "generator" not in readings["grads"] and opt.state:
            beta1 = opt.param_groups[0]["betas"][0]
            moments = [_moment(opt.state, p, "exp_avg")
                       for p in named.values()]
            if start is not None:
                moments = torch._foreach_sub(moments, torch._foreach_mul(
                    [start["m"][k] for k in named], beta1))
            keys, norms = _device_norms(dict(zip(named, moments)))
            readings["grads"]["generator"] = (keys, norms / (1 - beta1))
        if step == self.cell.traffic["checked_steps"] - 1:
            base = self._base(start)
            readings["change"]["generator"] = _device_norms(dict(zip(
                named, torch._foreach_sub([p.detach() for p in
                                           named.values()],
                                          [base[k] for k in named]))))

    def _base(self, start) -> dict:
        return self.params if start is None else start["weights"]

    def _snapshot(self) -> dict:
        opt = self.state.opt_g.optimizer
        named = dict(self.state.generator.named_parameters())
        stepped = [p for p in named.values() if "step" in opt.state[p]]
        return {"weights": {k: v.detach().clone() for k, v in named.items()},
                "m": {k: _moment(opt.state, p, "exp_avg").clone()
                      for k, p in named.items()},
                "v": {k: _moment(opt.state, p, "exp_avg_sq").clone()
                      for k, p in named.items()},
                "t": int(opt.state[stepped[0]]["step"]) if stepped else 0}

    def _launches(self) -> int:
        from articulatory_tpu_torch.ops.banded_attention import (
            banded_attention,
        )
        return banded_attention.launches

    def warm(self) -> None:
        """The first steps, the first ``checked_steps`` read as they pass;
        then the snapshot the window's check starts from."""
        t = self.cell.traffic
        self.readings = {"losses": [], "grads": {}, "change": {}}
        for j in range(t["warm_steps"]):
            metrics = self._step(j)
            if j < t["checked_steps"]:
                self._read(self.readings, j, metrics, None)
        self.start = self._snapshot()
        self.window = {"losses": [], "grads": {}, "change": {}}

    def unit(self, j: int, traced: bool) -> None:
        before = self._launches()
        with span(traced, "train_step"):
            metrics = self._step(self.cell.traffic["warm_steps"] + j)
        self.attention.append(self._launches() - before)
        self.failed.append(not math.isfinite(float(
            metrics[f"train/{LOSS}"])))
        if j < self.cell.traffic["checked_steps"]:
            self._read(self.window, j, metrics, self.start)

    def counts(self, first: int, last: int) -> dict:
        """Over steps ``first`` to ``last`` (excluded) of the window."""
        n = len(self.failed[first:last])
        return {"attempted": n, "failed": sum(self.failed[first:last]),
                "steps": n,
                "attention_launches": sum(self.attention[first:last])}

    def free(self) -> None:
        steps = max(len(self.attention), 1)
        print(f"launches a step: banded attention "
              f"{sum(self.attention) / steps}", file=sys.stderr)
        self.readings, self.window = (_settle(self.readings),
                                      _settle(self.window))
        del self.state, self.step_fn
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def check_units(self) -> int:
        return self.cell.traffic["checked_steps"]

    def reference_readings(self, precision: str, start=None) -> dict:
        """The reference's ``checked_steps`` from the seed's weights, or
        from the snapshot ``start`` on the window's batches."""
        first = 0 if start is None else self.cell.traffic["warm_steps"]
        ref = InversionTrainer(
            self.model, self._base(start), precision, self.draws_seed,
            None if start is None else {k: start[k] for k in "mvt"}, first)
        losses, grads = [], {}
        for j in range(self.cell.traffic["checked_steps"]):
            b = self.batch(first + j)
            with no_tf32():
                out = ref.step({"x": b["x"][0], "y": b["y"]})
            losses.append(float(out[LOSS]))
            if "generator_grads" in out:
                grads["generator"] = leaf_norms(out["generator_grads"])
        with torch.no_grad():
            base = self._base(start)
            change = {"generator": leaf_norms({k: v - base[k] for k, v in
                                               ref.g.items()})}
        return {"losses": losses, "grads": grads, "change": change}

    def serve_reference(self, precision: str) -> None:
        """Put the reference's own training in ``precision`` in place of
        the program's readings (the check's control)."""
        self.readings = self.reference_readings(precision)
        self.window = self.reference_readings(precision, self.start)

    def check(self) -> list[dict]:
        prec = self.cell.precision
        got = compare(self.readings, self.reference_readings(prec))
        got.update({f"window_{k}": v for k, v in compare(
            self.window, self.reference_readings(prec, self.start)).items()})
        limits = self.cell.spec["limits"]
        return [{"name": k, "value": got[k], "limit": limits[k]}
                for k in limits]


def compare(got: dict, want: dict) -> dict:
    """``loss_gap``: each checked step's loss, relative. ``grad_gap``: the
    first gradient, by the worst leaf. ``change_gap``: each parameter's
    change after the checked steps, by the worst leaf, leaving out leaves
    whose first reference gradient is under a thousandth of the median
    leaf's (moved by round-off alone). As ``train_step``'s readings."""
    loss = max(abs(g - w) / abs(w) for g, w in zip(got["losses"],
                                                   want["losses"]))
    norms = want["grads"]["generator"]
    grad = _worst_leaf(got["grads"].get("generator", {}), norms,
                       lambda k: True)
    median = sorted(norms.values())[len(norms) // 2]
    moved = {k for k, v in norms.items() if v >= 1e-3 * median}
    change = _worst_leaf(got["change"]["generator"],
                         want["change"]["generator"], moved.__contains__)
    return {"loss_gap": loss if len(got["losses"]) == len(want["losses"])
            else math.inf, "grad_gap": grad, "change_gap": change}
