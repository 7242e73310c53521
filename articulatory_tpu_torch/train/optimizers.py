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

``load_optax_state`` carries the JAX package's optax Adam / AdamW state
into the torch optimizer for a resume: ``scale_by_adam``'s ``count`` (the
updates taken) becomes each parameter's ``step``, ``mu`` and ``nu``
``exp_avg`` and ``exp_avg_sq``. The chain's clip and
``add_decayed_weights`` hold no state, and torch's Adam adds ``weight_decay
* p`` to the gradient as optax's chain does before ``scale_by_adam``;
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
            norm = torch.linalg.vector_norm(
                torch.stack([torch.linalg.vector_norm(g) for g in grads]))
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


def load_optax_state(optimizer: Optimizer, name: str, optax_state: dict,
                     moments, model: torch.nn.Module) -> None:
    """Set the state ``optimizer`` keeps for ``model``'s parameters from an
    optax state dict of the JAX package's ``build_optimizer(name, ...)``
    chain; ``moments`` maps a moment tree to ``{parameter name: tensor}``
    (``utils/checkpoint.py::optax_moments``). Optimizers other than Adam
    and AdamW raise, naming themselves."""
    if name not in ("Adam", "AdamW"):
        raise NotImplementedError(f"resuming the optax state of {name} is "
                                  "not ported (Adam and AdamW are)")
    adam = [v for v in optax_state.values()
            if isinstance(v, dict) and {"count", "mu", "nu"} <= set(v)]
    if len(adam) != 1:
        raise ValueError(f"no scale_by_adam state in the optax chain of "
                         f"{name}: {sorted(optax_state)}")
    count = int(adam[0]["count"])
    exp_avg, exp_avg_sq = moments(adam[0]["mu"]), moments(adam[0]["nu"])
    # torch keeps a non-capturable step as a float tensor on the host
    scalar = (torch.float64 if torch.get_default_dtype() == torch.float64
              else torch.float32)
    state = optimizer.optimizer.state
    for key, p in model.named_parameters():
        state[p] = {"step": torch.tensor(float(count), dtype=scalar),
                    "exp_avg": exp_avg[key].to(p.device, p.dtype).clone(),
                    "exp_avg_sq": exp_avg_sq[key].to(p.device, p.dtype
                                                     ).clone()}
