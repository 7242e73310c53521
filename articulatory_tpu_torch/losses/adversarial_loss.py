"""LSGAN / hinge adversarial losses (port of
``articulatory_tpu/losses/adversarial_loss.py``). Inputs are lists of
per-discriminator outputs; an element that is itself a list carries feature
maps, and only its last entry (the logits) feeds the loss."""

from __future__ import annotations

import torch


def _final_logits(outputs) -> list:
    if isinstance(outputs, (tuple, list)):
        return [o[-1] if isinstance(o, (tuple, list)) else o for o in outputs]
    return [outputs]


class GeneratorAdversarialLoss:
    def __init__(self, average_by_discriminators: bool = True,
                 loss_type: str = "mse"):
        if loss_type not in ("mse", "hinge"):
            raise ValueError(f"{loss_type} is not supported.")
        self.average_by_discriminators = average_by_discriminators
        self.loss_type = loss_type

    def __call__(self, outputs) -> torch.Tensor:
        logits = _final_logits(outputs)
        loss = 0.0
        for x in logits:
            if self.loss_type == "mse":
                loss = loss + torch.mean((x - 1.0) ** 2)
            else:
                loss = loss - torch.mean(x)
        if self.average_by_discriminators and len(logits) > 1:
            loss = loss / len(logits)
        return loss


class DiscriminatorAdversarialLoss:
    def __init__(self, average_by_discriminators: bool = True,
                 loss_type: str = "mse"):
        if loss_type not in ("mse", "hinge"):
            raise ValueError(f"{loss_type} is not supported.")
        self.average_by_discriminators = average_by_discriminators
        self.loss_type = loss_type

    def __call__(self, outputs_hat, outputs
                 ) -> tuple[torch.Tensor, torch.Tensor]:
        """Returns (real_loss, fake_loss)."""
        logits_hat = _final_logits(outputs_hat)
        logits = _final_logits(outputs)
        real_loss = fake_loss = 0.0
        for x_hat, x in zip(logits_hat, logits):
            if self.loss_type == "mse":
                real_loss = real_loss + torch.mean((x - 1.0) ** 2)
                fake_loss = fake_loss + torch.mean(x_hat ** 2)
            else:
                real_loss = real_loss - torch.mean(torch.clamp(x - 1.0, max=0.0))
                fake_loss = fake_loss - torch.mean(
                    torch.clamp(-x_hat - 1.0, max=0.0))
        if self.average_by_discriminators and len(logits) > 1:
            real_loss = real_loss / len(logits)
            fake_loss = fake_loss / len(logits)
        return real_loss, fake_loss
