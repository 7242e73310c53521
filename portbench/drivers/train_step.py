"""The recipe's GAN training: ``train/gan.py::make_train_step(criterion,
config)``'s ``train_step(state, batch, lr_g, lr_d)``, one step after
another, each ending in a device synchronisation.

The state is built as ``bin/train.py`` builds it (both models, their Adam
optimizers from the configuration, ``RandomDraws`` from the seed), with the
benchmark's weights. Set-up drives that same state through its first
``warm_steps`` steps, past ``generator_train_start_steps``, so that every
timed step updates both models. The output check reads two runs of
``checked_steps`` steps: the first steps of set-up, from the seed's
weights, and the window's first steps, from a copy of the whole state
(weights, Adam's moments and step counts) taken as the window opens. Of
each it reads the losses of every step, the first gradient of each model
(Adam's first moment after the first update, less ``beta1`` times the one
before it, over ``1 - beta1``) and each parameter's change over the steps;
the window's readings stay on the card until the window has closed.

Each step's batch is made on the card from the seed: ``batch`` crops of
``batch_max_steps`` samples of a tone in noise, each with the ``ar_input``
samples before it as the AR past (``data/collate.py``'s ``ar``) and its
frames of smoothed-noise features.
"""

from __future__ import annotations

import math
import sys

import torch
import torch.nn.functional as F

from portbench.core import program, seeds, traffic
from portbench.core.trace import span, synchronize
from portbench.reference.hifigan import no_tf32
from portbench.reference.train import Trainer

LOSSES = ("generator_loss", "discriminator_loss")


def leaf_norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.float())) for k, v in
            tensors.items()}


def _device_norms(tensors: dict) -> tuple:
    """(keys, their norms in one tensor on the device)."""
    keys = list(tensors)
    norms = torch._foreach_norm([tensors[k].float() for k in keys])
    return keys, torch.stack(norms)


def _moment(state, p, key: str) -> torch.Tensor:
    """Adam's ``key`` moment of ``p``, zero before its first step."""
    return state[p][key] if key in state[p] else torch.zeros_like(p)


def _settle(readings: dict) -> dict:
    """Readings with the norms left on the device read back."""
    def floats(norms):
        if isinstance(norms, tuple):
            return dict(zip(norms[0], norms[1].tolist()))
        return norms
    return {"losses": readings["losses"],
            **{part: {n: floats(v) for n, v in readings[part].items()}
               for part in ("grads", "change")}}


class Driver:
    def __init__(self, cell, seed: int, dev: torch.device):
        from articulatory_tpu_torch.train import gan
        from articulatory_tpu_torch.train.optimizers import build_optimizer
        self.cell, self.seed, self.dev = cell, seed, dev
        self.model = m = cell.model
        gen, self.g_weights = program.generator(m, seed, dev)
        disc, self.d_weights = program.discriminator(m, seed, dev)
        opts = [build_optimizer(m[f"{n}_optimizer_type"],
                                m[f"{n}_optimizer_params"],
                                m.get(f"{n}_grad_norm", -1),
                                model.parameters())
                for n, model in (("generator", gen),
                                 ("discriminator", disc))]
        self.state = gan.GANTrainState(
            generator=gen, discriminator=disc, opt_g=opts[0],
            opt_d=opts[1], draws=gan.RandomDraws(seeds.sub_seed(seed,
                                                               "draws")))
        self.step_fn = gan.make_train_step(gan.GANCriterion(m), m)
        self.lr = (m["generator_optimizer_params"]["lr"],
                   m["discriminator_optimizer_params"]["lr"])
        self.failed = []    # a flag for each step of the window
        self.readings = self.window = self.start = None

    def batch(self, j: int) -> dict:
        m, b = self.model, self.cell.traffic["batch"]
        gp = m["generator_params"]
        past, n = gp["ar_input"], m["batch_max_steps"]
        frames = n // m["hop_size"]
        feat = traffic.features(m)
        g = seeds.generator(self.seed, self.dev, "batch", j)
        t = torch.arange(past + n, device=self.dev) / m["sampling_rate"]
        f0 = 80.0 + 220.0 * torch.rand((b, 1), generator=g, device=self.dev)
        phase = 2 * math.pi * torch.rand((b, 1), generator=g,
                                         device=self.dev)
        wave = (0.3 * torch.sin(2 * math.pi * f0 * t + phase)
                + 0.05 * torch.randn((b, past + n), generator=g,
                                     device=self.dev))
        z = torch.randn((b, feat, frames + traffic.SMOOTH_FRAMES - 1),
                        generator=g, device=self.dev)
        box = torch.full((feat, 1, traffic.SMOOTH_FRAMES),
                         traffic.SMOOTH_FRAMES ** -0.5, device=self.dev)
        x = F.conv1d(z, box, groups=feat).transpose(1, 2).contiguous()
        return {"x": (x,), "y": wave[:, past:, None],
                "ar": wave[:, :past, None]}

    def _step(self, j: int) -> dict:
        metrics = self.step_fn(self.state, self.batch(j), *self.lr)
        synchronize(self.dev)
        return metrics

    def _models(self):
        return (("generator", self.state.opt_g, self.state.generator),
                ("discriminator", self.state.opt_d,
                 self.state.discriminator))

    def _read(self, readings: dict, step: int, metrics: dict,
              start) -> None:
        """Into ``readings``, step ``step`` of ``checked_steps`` from
        ``start`` (the snapshot they began from, or None at the seed)."""
        readings["losses"].append({n: float(metrics[f"train/{n}"])
                                   for n in LOSSES})
        for name, opt, model in self._models():
            state = opt.optimizer.state
            if name in readings["grads"] or not state:
                continue
            beta1 = opt.optimizer.param_groups[0]["betas"][0]
            named = dict(model.named_parameters())
            moments = [_moment(state, p, "exp_avg") for p in named.values()]
            if start is not None:
                moments = torch._foreach_sub(moments, torch._foreach_mul(
                    [start[name]["m"][k] for k in named], beta1))
            keys, norms = _device_norms(dict(zip(named, moments)))
            readings["grads"][name] = (keys, norms / (1 - beta1))
        if step == self.cell.traffic["checked_steps"] - 1:
            base = self._base(start)
            for name, _, model in self._models():
                named = dict(model.named_parameters())
                readings["change"][name] = _device_norms(dict(zip(
                    named, torch._foreach_sub(
                        [p.detach() for p in named.values()],
                        [base[name][k] for k in named]))))

    def _base(self, start) -> dict:
        """Each model's weights at the start of a checked run."""
        if start is None:
            return {"generator": self.g_weights,
                    "discriminator": self.d_weights}
        return {n: start[n]["weights"] for n in start}

    def _snapshot(self) -> dict:
        """The whole training state, copied."""
        snap = {}
        for name, opt, model in self._models():
            state = opt.optimizer.state
            named = dict(model.named_parameters())
            stepped = [p for p in named.values() if "step" in state[p]]
            snap[name] = {
                "weights": {k: v.detach().clone()
                            for k, v in model.state_dict().items()},
                "m": {k: _moment(state, p, "exp_avg").clone()
                      for k, p in named.items()},
                "v": {k: _moment(state, p, "exp_avg_sq").clone()
                      for k, p in named.items()},
                "t": int(state[stepped[0]]["step"]) if stepped else 0}
        return snap

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
        from articulatory_tpu_torch.ops.resblock_pair import resblock_pair
        from articulatory_tpu_torch.ops.scale_disc_head import (
            scale_disc_head,
        )
        self.kernels = (resblock_pair, scale_disc_head)
        self.launches = [k.launches for k in self.kernels]

    def unit(self, j: int, traced: bool) -> None:
        with span(traced, "train_step"):
            metrics = self._step(self.cell.traffic["warm_steps"] + j)
        self.failed.append(not all(math.isfinite(float(
            metrics[f"train/{k}"])) for k in LOSSES))
        if j < self.cell.traffic["checked_steps"]:
            self._read(self.window, j, metrics, self.start)

    def counts(self, first: int, last: int) -> dict:
        """Over steps ``first`` to ``last`` (excluded) of the window."""
        n = len(self.failed[first:last])
        return {"attempted": n, "failed": sum(self.failed[first:last]),
                "steps": n}

    def free(self) -> None:
        steps = len(self.failed)
        launches = [k.launches - n for k, n in zip(self.kernels,
                                                   self.launches)]
        print(f"launches a step: pair {launches[0] / steps}, head "
              f"{launches[1] / steps}", file=sys.stderr)
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
        base = self._base(start)
        ref = Trainer(self.model, base["generator"], base["discriminator"],
                      precision, self.dev, start, first)
        losses, grads = [], {}
        for j in range(self.cell.traffic["checked_steps"]):
            b = self.batch(first + j)
            with no_tf32():
                out = ref.step({"x": b["x"][0], "y": b["y"][..., 0],
                                "ar": b["ar"][..., 0]})
            losses.append({k: float(out[k]) for k in LOSSES})
            for name in ("generator", "discriminator"):
                if f"{name}_grads" in out:
                    grads[name] = leaf_norms(out[f"{name}_grads"])
        with torch.no_grad():
            change = {name: leaf_norms({k: v - base[name][k]
                                        for k, v in params.items()})
                      for name, params in (("generator", ref.g),
                                           ("discriminator", ref.d))}
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


def _worst_leaf(got: dict, want: dict, keep) -> float:
    """The widest gap of a leaf's norm from the reference's, against the
    larger of that leaf's reference norm and the median leaf's."""
    median = sorted(want.values())[len(want) // 2]
    gaps = [abs(got.get(k, math.inf) - w) / max(w, median)
            for k, w in want.items() if keep(k)]
    return max(gaps) if gaps else math.inf


def compare(got: dict, want: dict) -> dict:
    """The numbers compared. ``loss_gap``: each checked step's losses,
    relative. ``grad_gap``: the first gradient of each model, by the worst
    leaf. ``change_gap``: each parameter's change after the checked steps,
    by the worst leaf, leaving out leaves whose first reference gradient is
    under a thousandth of the median leaf's (moved by round-off alone)."""
    loss = max(abs(g[k] - w[k]) / abs(w[k])
               for g, w in zip(got["losses"], want["losses"]) for k in LOSSES)
    grad = max(_worst_leaf(got["grads"].get(n, {}), want["grads"][n],
                           lambda k: True) for n in want["grads"])
    change = 0.0
    for n, norms in want["grads"].items():
        median = sorted(norms.values())[len(norms) // 2]
        moved = {k for k, v in norms.items() if v >= 1e-3 * median}
        change = max(change, _worst_leaf(got["change"][n], want["change"][n],
                                         moved.__contains__))
    return {"loss_gap": loss if len(got["losses"]) == len(want["losses"])
            else math.inf, "grad_gap": grad, "change_gap": change}
