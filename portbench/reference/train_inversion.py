"""Plain PyTorch reference of an inversion training step without an
adversary: the L1 between the Transformer's output and the EMA target
(``lambda_aux`` x mean |y_ - y|, the recipes' ``use_mel_loss`` in an
inversion ``dataset_mode``), and an Adam step of the generator when
``steps > generator_train_start_steps``. Dropout draws the training step's
masks (``reference/transformer.py``). A step returns the loss and the
gradients of the first update by this trainer."""

from __future__ import annotations

import torch

from portbench.reference.train import Adam
from portbench.reference.transformer import forward

LOSS = "generator_loss"


class InversionTrainer:
    """From the state dict ``weights`` (copied) at step ``steps``;
    ``start`` the generator's Adam state to start from (``{"m", "v",
    "t"}``); ``draws_seed`` the seed of the program's ``RandomDraws``."""

    def __init__(self, model: dict, weights: dict, precision: str,
                 draws_seed: int, start: dict | None = None,
                 steps: int = 0):
        self.model, self.precision = model, precision
        self.draws_seed, self.steps = draws_seed, steps
        self.g = {k: v.detach().clone().requires_grad_(True)
                  for k, v in weights.items() if v.is_floating_point()}
        go = model["generator_optimizer_params"]
        self.opt = Adam(go["lr"], tuple(go["betas"]))
        if start is not None:
            self.opt.load(start)
        self.updated = False

    def step(self, batch: dict) -> dict:
        """One step on ``x`` (B, T, F) and ``y`` (B, T, C): the loss and, at
        the first update, the gradients (``generator_grads``)."""
        m = self.model
        gen_on = self.steps > m.get("generator_train_start_steps", 0)
        with torch.set_grad_enabled(gen_on):
            y_ = forward(self.g, m["generator_params"], batch["x"],
                         self.precision, self.draws_seed, self.steps)
            loss = m.get("lambda_aux", 1.0) * torch.mean(torch.abs(
                y_ - batch["y"]))
        out = {LOSS: loss.detach()}
        if gen_on:
            grads = dict(zip(self.g, torch.autograd.grad(
                loss, list(self.g.values()), allow_unused=True)))
            grads = {k: torch.zeros_like(self.g[k]) if g is None else g
                     for k, g in grads.items()}
            if not self.updated:
                out["generator_grads"] = grads
                self.updated = True
            self.opt.step(self.g, grads)
        self.steps += 1
        return out
