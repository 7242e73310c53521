"""Host-side LR schedulers with torch.optim.lr_scheduler semantics: the
port's own copy of ``articulatory_tpu/train/schedulers.py`` (pure Python).

The reference resolves scheduler classes by name from YAML and steps them
once per train step, ReduceLROnPlateau with the loss. These are plain
objects; the trainer reads ``.lr`` each step and writes it into each
optimizer param group, as the JAX trainer passes ``lr_g``/``lr_d``.
"""

from __future__ import annotations

import bisect
import math
from typing import Sequence


class _Scheduler:
    def __init__(self, base_lr: float):
        self.base_lr = base_lr
        self.lr = base_lr
        self.step_count = 0

    def step(self, metric: float | None = None) -> None:
        self.step_count += 1
        self._update(metric)

    def _update(self, metric):
        raise NotImplementedError

    def state_dict(self) -> dict:
        # exclude non-serializable members (torch parity: LambdaLR.state_dict
        # excludes lr_lambda)
        return {k: v for k, v in self.__dict__.items() if not callable(v)}

    def load_state_dict(self, state: dict) -> None:
        self.__dict__.update(state)


class ConstantLR(_Scheduler):
    """torch semantics: lr * factor until ``total_iters``, then lr.

    Defaults mirror torch's (factor=1/3, total_iters=5) so a YAML config
    that relies on torch defaults trains the same trajectory here; callers
    wanting a true constant must pass ``factor=1.0`` explicitly.
    """

    def __init__(self, base_lr: float, factor: float = 1.0 / 3.0,
                 total_iters: int = 5):
        super().__init__(base_lr)
        self.factor = factor
        self.total_iters = total_iters
        self.lr = base_lr * factor if total_iters > 0 else base_lr

    def _update(self, metric):
        self.lr = (self.base_lr * self.factor
                   if self.step_count < self.total_iters else self.base_lr)


class LinearLR(_Scheduler):
    """torch semantics: linear ramp from ``start_factor`` to ``end_factor``
    over ``total_iters`` steps."""

    def __init__(self, base_lr: float, start_factor: float = 1.0 / 3,
                 end_factor: float = 1.0, total_iters: int = 5):
        super().__init__(base_lr)
        self.start_factor = start_factor
        self.end_factor = end_factor
        self.total_iters = total_iters
        self.lr = base_lr * start_factor

    def _update(self, metric):
        t = min(self.step_count, self.total_iters)
        f = self.start_factor + (self.end_factor - self.start_factor) * (
            t / self.total_iters)
        self.lr = self.base_lr * f


class CosineAnnealingLR(_Scheduler):
    """torch closed form: ``eta_min + (base-eta_min)*(1+cos(pi*t/T_max))/2``."""

    def __init__(self, base_lr: float, T_max: int, eta_min: float = 0.0):
        super().__init__(base_lr)
        self.T_max = T_max
        self.eta_min = eta_min

    def _update(self, metric):
        self.lr = self.eta_min + (self.base_lr - self.eta_min) * (
            1 + math.cos(math.pi * self.step_count / self.T_max)) / 2


class CosineAnnealingWarmRestarts(_Scheduler):
    """torch semantics: cosine within a restart period of ``T_0`` steps,
    each period ``T_mult`` times longer than the last."""

    def __init__(self, base_lr: float, T_0: int, T_mult: int = 1,
                 eta_min: float = 0.0):
        super().__init__(base_lr)
        assert T_0 > 0 and T_mult >= 1
        self.T_0 = T_0
        self.T_mult = T_mult
        self.eta_min = eta_min
        self.T_cur = 0
        self.T_i = T_0

    def _update(self, metric):
        self.T_cur += 1
        if self.T_cur >= self.T_i:
            self.T_cur -= self.T_i
            self.T_i *= self.T_mult
        self.lr = self.eta_min + (self.base_lr - self.eta_min) * (
            1 + math.cos(math.pi * self.T_cur / self.T_i)) / 2


class CyclicLR(_Scheduler):
    """torch semantics: triangular cycles between ``base_lr`` and ``max_lr``.

    Like torch, the scheduler's own ``base_lr`` param overrides the
    optimizer lr; modes: triangular, triangular2, exp_range.
    """

    def __init__(self, optimizer_lr: float, base_lr: float, max_lr: float,
                 step_size_up: int = 2000, step_size_down: int | None = None,
                 mode: str = "triangular", gamma: float = 1.0):
        super().__init__(base_lr)
        assert mode in ("triangular", "triangular2", "exp_range")
        self.max_lr = max_lr
        self.step_size_up = step_size_up
        self.step_size_down = (step_size_down if step_size_down is not None
                               else step_size_up)
        self.mode = mode
        self.gamma = gamma
        self.lr = base_lr

    def _update(self, metric):
        t = self.step_count
        total = self.step_size_up + self.step_size_down
        cycle = t // total
        pos = t - cycle * total
        if pos <= self.step_size_up:
            x = pos / self.step_size_up
        else:
            x = 1.0 - (pos - self.step_size_up) / self.step_size_down
        if self.mode == "triangular2":
            scale = 1.0 / (2.0 ** cycle)
        elif self.mode == "exp_range":
            scale = self.gamma ** t
        else:
            scale = 1.0
        self.lr = self.base_lr + (self.max_lr - self.base_lr) * x * scale


class OneCycleLR(_Scheduler):
    """torch semantics: warm up from ``max_lr/div_factor`` to ``max_lr``
    over ``pct_start`` of the run, then anneal to
    ``max_lr/div_factor/final_div_factor`` (cos or linear; optional
    three-phase). Overrides the optimizer lr, like torch.

    ``cycle_momentum`` (torch default True) is accepted but ignored: this
    trainer sets only the lr of each param group, as the JAX package. A torch run with a momentum-bearing optimizer (SGD
    momentum / Adam betas) would additionally cycle that coefficient —
    documented divergence (docs/MIGRATION.md).
    """

    def __init__(self, optimizer_lr: float, max_lr: float,
                 total_steps: int | None = None, epochs: int | None = None,
                 steps_per_epoch: int | None = None, pct_start: float = 0.3,
                 anneal_strategy: str = "cos", div_factor: float = 25.0,
                 final_div_factor: float = 1e4, three_phase: bool = False,
                 cycle_momentum: bool = True, base_momentum: float = 0.85,
                 max_momentum: float = 0.95):
        super().__init__(optimizer_lr)
        del cycle_momentum, base_momentum, max_momentum  # see docstring
        if total_steps is None:
            if epochs is None or steps_per_epoch is None:
                raise ValueError(
                    "OneCycleLR needs total_steps or epochs+steps_per_epoch")
            total_steps = epochs * steps_per_epoch
        assert anneal_strategy in ("cos", "linear")
        self.total_steps = total_steps
        self.anneal_strategy = anneal_strategy
        initial_lr = max_lr / div_factor
        min_lr = initial_lr / final_div_factor
        # (end_step, start_lr, end_lr) — torch's _schedule_phases
        if three_phase:
            self.phases = [
                (float(pct_start * total_steps) - 1, initial_lr, max_lr),
                (float(2 * pct_start * total_steps) - 2, max_lr, initial_lr),
                (total_steps - 1, initial_lr, min_lr),
            ]
        else:
            self.phases = [
                (float(pct_start * total_steps) - 1, initial_lr, max_lr),
                (total_steps - 1, max_lr, min_lr),
            ]
        self.lr = initial_lr  # value at step 0 (torch last_epoch=0)

    def _anneal(self, start: float, end: float, pct: float) -> float:
        if self.anneal_strategy == "cos":
            return end + (start - end) / 2.0 * (1 + math.cos(math.pi * pct))
        return (end - start) * pct + start

    def _update(self, metric):
        t = self.step_count
        if t > self.total_steps:
            raise ValueError(
                f"Tried to step {t} times; OneCycleLR total_steps="
                f"{self.total_steps} (torch raises here too)")
        start_step = 0.0
        for end_step, start_lr, end_lr in self.phases:
            if t <= end_step or end_step == self.phases[-1][0]:
                pct = (t - start_step) / (end_step - start_step)
                self.lr = self._anneal(start_lr, end_lr, pct)
                break
            start_step = end_step


class MultiStepLR(_Scheduler):
    def __init__(self, base_lr: float, milestones: Sequence[int], gamma: float = 0.1):
        super().__init__(base_lr)
        self.milestones = sorted(milestones)
        self.gamma = gamma

    def _update(self, metric):
        n = sum(1 for m in self.milestones if self.step_count >= m)
        self.lr = self.base_lr * (self.gamma ** n)


class StepLR(_Scheduler):
    def __init__(self, base_lr: float, step_size: int, gamma: float = 0.1):
        super().__init__(base_lr)
        self.step_size = step_size
        self.gamma = gamma

    def _update(self, metric):
        self.lr = self.base_lr * (self.gamma ** (self.step_count // self.step_size))


class ExponentialLR(_Scheduler):
    def __init__(self, base_lr: float, gamma: float):
        super().__init__(base_lr)
        self.gamma = gamma

    def _update(self, metric):
        self.lr = self.base_lr * (self.gamma ** self.step_count)


class LambdaLR(_Scheduler):
    def __init__(self, base_lr: float, lr_lambda):
        super().__init__(base_lr)
        self.lr_lambda = lr_lambda

    def _update(self, metric):
        self.lr = self.base_lr * self.lr_lambda(self.step_count)


class PolynomialLR(_Scheduler):
    """torch semantics: ``base_lr * (1 - t/total_iters)**power`` until
    ``total_iters`` (then unchanged — i.e. it stays at 0)."""

    def __init__(self, base_lr: float, total_iters: int = 5,
                 power: float = 1.0):
        super().__init__(base_lr)
        self.total_iters = total_iters
        self.power = power

    def _update(self, metric):
        t = min(self.step_count, self.total_iters)
        self.lr = self.base_lr * (1.0 - t / self.total_iters) ** self.power


class MultiplicativeLR(_Scheduler):
    """torch semantics: ``lr_t = lr_{t-1} * lr_lambda(t)`` (the factor is a
    function of the step index, applied multiplicatively to the RUNNING lr,
    unlike LambdaLR which rescales base_lr). Takes a Python callable, like
    torch — a reference YAML cannot construct this scheduler either."""

    def __init__(self, base_lr: float, lr_lambda):
        super().__init__(base_lr)
        self.lr_lambda = lr_lambda

    def _update(self, metric):
        self.lr = self.lr * self.lr_lambda(self.step_count)


class ChainedScheduler(_Scheduler):
    """torch semantics: step every child each step; the net lr is the
    product of the children's multiplicative factors applied to base_lr
    (torch chains recursive ``get_lr`` calls through the shared optimizer
    group lr — for factor-form schedulers that telescopes to the same
    product).

    Extension (as in the JAX package): children are YAML-friendly ``{type, params}``
    specs — torch's own ChainedScheduler takes scheduler INSTANCES and is
    therefore unconstructible from the reference's YAML (train.py:1770-1779
    passes only kwargs). Only factor-form children are accepted; lr-override
    schedulers (Cyclic/OneCycle/Plateau/Cosine*) do not telescope and raise.
    """

    _CHAINABLE = ("StepLR", "MultiStepLR", "ExponentialLR", "ConstantLR",
                  "LinearLR", "PolynomialLR", "LambdaLR", "MultiplicativeLR")

    def __init__(self, base_lr: float, schedulers: Sequence[dict]):
        super().__init__(base_lr)
        self._specs = [dict(s) for s in schedulers]
        self.children = [self._build(s) for s in self._specs]
        self._update(None)  # torch applies initial factors at construction

    def _build(self, spec: dict):
        name = spec["type"]
        if name not in self._CHAINABLE:
            raise ValueError(
                f"ChainedScheduler child {name} is not factor-form "
                f"chainable; allowed: {list(self._CHAINABLE)}.")
        return build_scheduler(name, self.base_lr,
                               dict(spec.get("params", {})))

    def _update(self, metric):
        factor = 1.0
        for child in self.children:
            if self.step_count > 0:
                child.step(metric)
            factor *= child.lr / child.base_lr
        self.lr = self.base_lr * factor

    def state_dict(self) -> dict:
        return {"step_count": self.step_count, "lr": self.lr,
                "children": [c.state_dict() for c in self.children]}

    def load_state_dict(self, state: dict) -> None:
        self.step_count = state["step_count"]
        self.lr = state["lr"]
        for child, cs in zip(self.children, state["children"]):
            child.load_state_dict(cs)


class SequentialLR(_Scheduler):
    """torch semantics: run ``schedulers[i]`` between ``milestones[i-1]``
    and ``milestones[i]``; at each milestone the incoming scheduler is reset
    to its own epoch 0 against the ORIGINAL base lr (torch SequentialLR.step:
    ``scheduler._update_lr(0)`` at the boundary).

    Extension (as in the JAX package): children are ``{type, params}`` specs (torch's
    takes instances — unconstructible from the reference's YAML, like
    ChainedScheduler above).
    """

    def __init__(self, base_lr: float, schedulers: Sequence[dict],
                 milestones: Sequence[int]):
        super().__init__(base_lr)
        if len(milestones) != len(schedulers) - 1:
            raise ValueError(
                f"SequentialLR expects {len(schedulers) - 1} milestones for "
                f"{len(schedulers)} schedulers, got {len(milestones)} "
                "(torch raises here too).")
        self._specs = [dict(s) for s in schedulers]
        self.milestones = list(milestones)
        self.children = [
            build_scheduler(s["type"], base_lr, dict(s.get("params", {})))
            for s in self._specs]
        self.lr = self.children[0].lr

    def _update(self, metric):
        t = self.step_count
        idx = bisect.bisect_right(self.milestones, t)
        if idx > 0 and self.milestones[idx - 1] == t:
            # milestone boundary: incoming child restarts at its epoch 0
            s = self._specs[idx]
            self.children[idx] = build_scheduler(
                s["type"], self.base_lr, dict(s.get("params", {})))
        else:
            self.children[idx].step(metric)
        self.lr = self.children[idx].lr

    def state_dict(self) -> dict:
        return {"step_count": self.step_count, "lr": self.lr,
                "milestones": self.milestones,
                "children": [c.state_dict() for c in self.children]}

    def load_state_dict(self, state: dict) -> None:
        self.step_count = state["step_count"]
        self.lr = state["lr"]
        self.milestones = list(state["milestones"])
        for child, cs in zip(self.children, state["children"]):
            child.load_state_dict(cs)


class ReduceLROnPlateau(_Scheduler):
    """torch semantics: shrink lr by ``factor`` after ``patience`` steps
    without improvement beyond ``threshold``."""

    def __init__(self, base_lr: float, mode: str = "min", factor: float = 0.1,
                 patience: int = 10, threshold: float = 1e-4,
                 threshold_mode: str = "rel", cooldown: int = 0,
                 min_lr: float = 0.0):
        super().__init__(base_lr)
        assert mode in ("min", "max")
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.threshold_mode = threshold_mode
        self.cooldown = cooldown
        self.min_lr = min_lr
        self.best = float("inf") if mode == "min" else -float("inf")
        self.num_bad = 0
        self.cooldown_counter = 0

    def _is_better(self, metric: float) -> bool:
        if self.mode == "min":
            if self.threshold_mode == "rel":
                return metric < self.best * (1.0 - self.threshold)
            return metric < self.best - self.threshold
        if self.threshold_mode == "rel":
            return metric > self.best * (1.0 + self.threshold)
        return metric > self.best + self.threshold

    def _update(self, metric):
        if metric is None:
            return
        metric = float(metric)
        if self._is_better(metric):
            self.best = metric
            self.num_bad = 0
        elif self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad = 0
        else:
            self.num_bad += 1
            if self.num_bad > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.cooldown_counter = self.cooldown
                self.num_bad = 0


def build_scheduler(name: str, base_lr: float, params: dict | None = None):
    params = dict(params or {})
    params.pop("optimizer", None)
    registry = {
        "MultiStepLR": MultiStepLR,
        "StepLR": StepLR,
        "ExponentialLR": ExponentialLR,
        "LambdaLR": LambdaLR,
        "ReduceLROnPlateau": ReduceLROnPlateau,
        "ConstantLR": ConstantLR,
        "LinearLR": LinearLR,
        "CosineAnnealingLR": CosineAnnealingLR,
        "CosineAnnealingWarmRestarts": CosineAnnealingWarmRestarts,
        "CyclicLR": CyclicLR,
        "OneCycleLR": OneCycleLR,
        "PolynomialLR": PolynomialLR,
        "MultiplicativeLR": MultiplicativeLR,
        "ChainedScheduler": ChainedScheduler,
        "SequentialLR": SequentialLR,
    }
    if name not in registry:
        raise ValueError(
            f"Unsupported scheduler: {name}. Supported torch names: "
            f"{sorted(registry)}.")
    return registry[name](base_lr, **params)
