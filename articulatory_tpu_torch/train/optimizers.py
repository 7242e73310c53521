"""Optimizers: torch class names from YAML -> ``torch.optim`` (port of
``articulatory_tpu/train/optimizers.py``).

As in the JAX package the learning rate is set from the host scheduler at
every step (``Optimizer.step(lr)`` writes it into each param group), and a
``grad_norm > 0`` clips the global gradient norm first, with optax's rule:
gradients are scaled by ``grad_norm / norm`` when ``norm >= grad_norm``.
The names are those the JAX package's ``build_optimizer`` takes: Adam,
AdamW, RAdam, NAdam, SGD, RMSprop, Adagrad, Adadelta, Adamax, ASGD, Rprop.
The optimizer params go to the ``torch.optim`` class as they are, so an
unknown key raises there.

``load_optax_state`` carries the JAX package's optax state into the torch
optimizer for a resume, for every optimizer of its ``build_optimizer``.
Those chains keep torch's semantics, so each optax field is one torch
state entry (the per-parameter trees through the weights' converter):

- Adam, AdamW, RAdam: ``count`` -> ``step``, ``mu`` / ``nu`` ->
  ``exp_avg`` / ``exp_avg_sq``;
- NAdam: ``count``, ``m`` / ``v`` -> ``exp_avg`` / ``exp_avg_sq``, the
  scalar ``mu_product`` into each parameter's;
- SGD: the momentum ``trace`` -> ``momentum_buffer`` (no state without
  momentum);
- RMSprop: ``sq`` -> ``square_avg``, ``avg`` -> ``grad_avg`` (centered),
  the momentum ``trace`` -> ``momentum_buffer``;
- Adagrad: ``count``, ``sum``; Adadelta: ``sq`` -> ``square_avg``, ``acc``
  -> ``acc_delta``; Adamax: ``count``, ``m`` -> ``exp_avg``, ``u`` ->
  ``exp_inf``; Rprop: ``prev``, ``step_size``;
- ASGD: ``count``; its ``eta`` and ``mu`` follow from it (torch's rules,
  the group's lr, ``lambd``, ``alpha`` and ``t0``), and its averaged
  iterate ``ax`` is the parameter itself while ``mu`` has been 1 (the first
  ``t0`` + 2 steps). optax keeps no average, so a state past that raises.

Where optax keeps no count (SGD, RMSprop, Adadelta, Rprop) ``step`` is the
number of updates the caller says were taken; torch's math does not read
it there. The chains' clip and ``add_decayed_weights`` hold no state, and
torch adds ``weight_decay * p`` to the gradient where optax's chain does;
AdamW decays the weights by ``1 - lr * weight_decay`` where optax adds
``weight_decay * p`` to the update, equal in exact arithmetic.
"""

from __future__ import annotations

from typing import Iterable

import torch

NAMES = ("Adam", "AdamW", "RAdam", "NAdam", "SGD", "RMSprop", "Adagrad",
         "Adadelta", "Adamax", "ASGD", "Rprop")


class Optimizer:
    """A ``torch.optim`` optimizer, its lr set per step, with optional
    global-norm clipping."""

    def __init__(self, optimizer: torch.optim.Optimizer, grad_norm: float):
        self.optimizer = optimizer
        self.grad_norm = grad_norm
        # the global norm of the gradients, where they are split over
        # ranks (``parallel/tp.py::clip_norm_fn``); None: the local norm
        self.norm_fn = None

    @property
    def params(self) -> list[torch.Tensor]:
        return [p for g in self.optimizer.param_groups for p in g["params"]]

    def zero_grad(self) -> None:
        self.optimizer.zero_grad(set_to_none=True)

    def step(self, lr: float) -> None:
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        if self.grad_norm and self.grad_norm > 0:
            grads = [p.grad for p in self.params if p.grad is not None]
            norm = (self.norm_fn(self.params) if self.norm_fn is not None
                    else torch.linalg.vector_norm(torch.stack(
                        [torch.linalg.vector_norm(g) for g in grads])))
            scale = torch.where(norm < self.grad_norm, torch.ones_like(norm),
                                self.grad_norm / norm)
            torch._foreach_mul_(grads, scale)
        self.optimizer.step()

    def state_dict(self) -> dict:
        return self.optimizer.state_dict()

    def load_state_dict(self, state: dict) -> None:
        self.optimizer.load_state_dict(state)


def build_optimizer(name: str, params: dict | None,
                    grad_norm: float = -1,
                    parameters: Iterable[torch.nn.Parameter] = ()
                    ) -> Optimizer:
    """``torch.optim.<name>(parameters, **params)`` behind ``Optimizer``."""
    if name in ("LBFGS", "SparseAdam"):
        raise ValueError(f"{name} cannot run in the reference's train loop "
                         "(LBFGS needs a loss closure, SparseAdam sparse "
                         "gradients), so it is refused here too.")
    if name not in NAMES:
        raise ValueError(f"Unsupported optimizer: {name}. Supported torch "
                         f"names: {', '.join(NAMES)}.")
    params = dict(params or {})
    return Optimizer(getattr(torch.optim, name)(list(parameters), **params),
                     grad_norm)


# the optax field of each torch state tensor that is a tree of the
# parameters' layout, per optimizer; the optax sub-state is found by its
# fields
_TREES = {
    "Adam": {"exp_avg": "mu", "exp_avg_sq": "nu"},
    "NAdam": {"exp_avg": "m", "exp_avg_sq": "v"},
    "SGD": {},
    "RMSprop": {"square_avg": "sq", "grad_avg": "avg"},
    "Adagrad": {"sum": "sum"},
    "Adadelta": {"square_avg": "sq", "acc_delta": "acc"},
    "Adamax": {"exp_avg": "m", "exp_inf": "u"},
    "ASGD": {},
    "Rprop": {"prev": "prev", "step_size": "step_size"},
}
_TREES["AdamW"] = _TREES["RAdam"] = _TREES["Adam"]
_FIELDS = {"Adam": {"count", "mu", "nu"},
           "NAdam": {"count", "m", "v", "mu_product"},
           "RMSprop": {"sq", "avg"}, "Adagrad": {"count", "sum"},
           "Adadelta": {"sq", "acc"}, "Adamax": {"count", "m", "u"},
           "ASGD": {"count"}, "Rprop": {"prev", "step_size"}}
_FIELDS["AdamW"] = _FIELDS["RAdam"] = _FIELDS["Adam"]


def _substate(optax_state: dict, fields: set, name: str) -> dict | None:
    """The one entry of the optax chain's state with exactly ``fields``."""
    found = [v for v in optax_state.values()
             if isinstance(v, dict) and set(v) == fields]
    if len(found) > 1:
        raise ValueError(f"{len(found)} {sorted(fields)} states in the optax "
                         f"chain of {name}")
    return found[0] if found else None


def load_optax_state(optimizer: Optimizer, name: str, optax_state: dict,
                     moments, model: torch.nn.Module,
                     updates: int = 0) -> None:
    """Set the state ``optimizer`` keeps for ``model``'s parameters from an
    optax state dict of the JAX package's ``build_optimizer(name, ...)``
    chain; ``moments`` maps a tree of the parameters' layout to
    ``{parameter name: tensor}`` (``utils/checkpoint.py::optax_moments``);
    ``updates`` is the number of updates taken, the ``step`` of an
    optimizer whose optax state keeps no count."""
    if name not in _TREES:
        raise ValueError(f"Unsupported optimizer: {name}")
    sub = {}
    if name in _FIELDS:
        sub = _substate(optax_state, _FIELDS[name], name)
        if sub is None:
            raise ValueError(f"no {sorted(_FIELDS[name])} state in the optax "
                             f"chain of {name}: {sorted(optax_state)}")
    trace = _substate(optax_state, {"trace"}, name)
    count = int(sub["count"]) if "count" in sub else int(updates)
    # torch keeps a non-capturable step as a float tensor on the host
    scalar = (torch.float64 if torch.get_default_dtype() == torch.float64
              else torch.float32)
    groups = {p: g for g in optimizer.optimizer.param_groups
              for p in g["params"]}
    trees = {key: moments(sub[field])
             for key, field in _TREES[name].items()
             if sub.get(field) is not None}
    if trace is not None:
        trees["momentum_buffer"] = moments(trace["trace"])
    state = optimizer.optimizer.state
    for key, p in model.named_parameters():
        group = groups[p]
        if name in ("SGD", "RMSprop") and group["momentum"] and (
                "momentum_buffer" not in trees):
            raise ValueError(f"{name} with momentum {group['momentum']}: the "
                             "optax chain holds no momentum trace")
        entry = {k: tree[key].to(p.device, p.dtype).clone()
                 for k, tree in trees.items()}
        if name != "SGD":
            entry["step"] = torch.tensor(float(count), dtype=scalar)
        if name == "NAdam":
            entry["mu_product"] = torch.tensor(float(sub["mu_product"]),
                                               dtype=scalar)
        if name == "ASGD":
            entry.update(_asgd_state(p, group, count, scalar))
        state[p] = entry


def _asgd_state(p: torch.Tensor, group: dict, count: int,
                scalar: torch.dtype) -> dict:
    """ASGD's ``step``, ``eta``, ``mu`` and ``ax`` after ``count`` updates,
    as torch writes them at the end of its step ``count``."""
    lr, lambd, alpha, t0 = (group[k] for k in ("lr", "lambd", "alpha", "t0"))
    if count > t0 + 2:
        raise NotImplementedError(
            f"resuming ASGD after {count} updates with t0 {t0}: torch's "
            "averaged iterate ax has left the parameters, and the optax "
            "state keeps no average")
    return {"step": torch.tensor(float(count), dtype=scalar, device=p.device),
            "eta": torch.tensor(lr / ((1 + lambd * lr * count) ** alpha),
                                dtype=scalar, device=p.device),
            "mu": torch.tensor(1 / max(1, count - t0), dtype=scalar,
                               device=p.device),
            "ax": p.detach().clone()}
