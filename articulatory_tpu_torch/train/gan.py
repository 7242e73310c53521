"""The GAN training step (port of ``articulatory_tpu/train/gan.py``).

Per step, with the JAX package's semantics:

1. generator loss: mel (or L1 in inversion modes) and/or multi-resolution
   STFT losses times ``lambda_aux``, plus ``lambda_adv`` times (adversarial
   + ``lambda_feat_match`` x feature matching) once
   ``steps > discriminator_train_start_steps``; the real pass for feature
   matching runs under ``torch.no_grad()``. The generator is updated when
   ``steps > generator_train_start_steps``;
2. the fake is regenerated with the updated generator, without grad;
3. the discriminator loss on (real, fake), updated when
   ``steps > discriminator_train_start_steps``.

With ``use_ar`` the AR past (``ar2``, else ``ar``) is concatenated in front
of y and y_ along time before the discriminator. Eager Python ``if``s take
the place of JAX's masked updates: a gated-off update is not taken, and its
optimizer state does not move. Metrics are detached tensors on the device,
so a step does not wait for the card.

Not ported (they raise ``NotImplementedError``): a cascade
(``generator2_type``), PQMF multiband, PCD inputs and the phoneme loss.
"""

from __future__ import annotations

import dataclasses
import logging

import torch
from torch import nn

from articulatory_tpu_torch.losses import (
    DiscriminatorAdversarialLoss,
    FeatureMatchLoss,
    GeneratorAdversarialLoss,
    MelSpectrogramLoss,
    MultiResolutionSTFTLoss,
)
from articulatory_tpu_torch.train.optimizers import Optimizer

INVERSION_MODES = ("art", "a2m", "w2a", "m2a", "ph2a", "ph2m")


@dataclasses.dataclass
class GANTrainState:
    generator: nn.Module
    discriminator: nn.Module
    opt_g: Optimizer
    opt_d: Optimizer
    steps: int = 0


class GANCriterion:
    """Loss bundle built from the experiment config."""

    def __init__(self, config: dict):
        gp = config.get("generator_params", {})
        for flag, what in ((config.get("generator2_type") is not None,
                            "a cascade (generator2_type)"),
                           (gp.get("out_channels", 1) > 1
                            and config.get("pqmf", False), "PQMF multiband"),
                           (config.get("use_subband_stft_loss", False),
                            "the subband STFT loss"),
                           (config.get("use_pcd", False), "PCD inputs"),
                           (gp.get("use_ph_loss", False), "the phoneme loss")):
            if flag:
                raise NotImplementedError(f"training with {what} is not "
                                          "ported yet")
        self.gen_adv = GeneratorAdversarialLoss(
            **config.get("generator_adv_loss_params", {}))
        self.dis_adv = DiscriminatorAdversarialLoss(
            **config.get("discriminator_adv_loss_params", {}))
        self.use_stft_loss = config.get("use_stft_loss", True)
        if self.use_stft_loss:
            self.stft = MultiResolutionSTFTLoss(
                **config.get("stft_loss_params", {}))
        self.use_feat_match_loss = config.get("use_feat_match_loss", False)
        if self.use_feat_match_loss:
            self.feat_match = FeatureMatchLoss(
                **config.get("feat_match_loss_params", {}))
        self.use_mel_loss = config.get("use_mel_loss", False)
        self.mel_is_l1 = config.get("dataset_mode") in INVERSION_MODES
        if self.use_mel_loss and not self.mel_is_l1:
            mel_params = config.get("mel_loss_params")
            if mel_params is None:
                mel_params = dict(
                    fs=config["sampling_rate"], fft_size=config["fft_size"],
                    hop_size=config["hop_size"],
                    win_length=config["win_length"], window=config["window"],
                    num_mels=config["num_mels"], fmin=config["fmin"],
                    fmax=config["fmax"])
            self.mel = MelSpectrogramLoss(**mel_params)
        if config.get("use_inter_loss", False):
            logging.warning("use_inter_loss is disabled (no inter criterion), "
                            "as in the reference and the JAX package")
        self.lambda_aux = config.get("lambda_aux", 1.0)
        self.lambda_adv = config.get("lambda_adv", 1.0)
        self.lambda_feat_match = config.get("lambda_feat_match", 1.0)

    def mel_loss(self, y_: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        if self.mel_is_l1:
            return torch.mean(torch.abs(y_ - y))
        return self.mel(_squeeze_c(y_), _squeeze_c(y))


def _squeeze_c(y: torch.Tensor) -> torch.Tensor:
    """(B, T, 1) -> (B, T); multichannel stays as it is."""
    return y[..., 0] if y.dim() == 3 and y.shape[-1] == 1 else y


def generate(generator: nn.Module, batch: dict) -> torch.Tensor:
    return generator(*batch["x"], ar=batch.get("ar"))


def _disc_inputs(config: dict, batch: dict, y: torch.Tensor,
                 y_: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The AR past in front of y and y_ along time (use_ar)."""
    if config.get("generator_params", {}).get("use_ar", False):
        past = batch.get("ar2")
        if past is None:
            past = batch["ar"]
        return torch.cat([past, y], dim=1), torch.cat([past, y_], dim=1)
    return y, y_


def _aux_loss(criterion: GANCriterion, y_, y, prefix: str) -> tuple:
    aux, metrics = 0.0, {}
    if criterion.use_stft_loss:
        sc, mag = criterion.stft(_squeeze_c(y_), _squeeze_c(y))
        metrics[f"{prefix}/spectral_convergence_loss"] = sc
        metrics[f"{prefix}/log_stft_magnitude_loss"] = mag
        aux = aux + sc + mag
    if criterion.use_mel_loss:
        mel_l = criterion.mel_loss(y_, y)
        metrics[f"{prefix}/mel_loss"] = mel_l
        aux = aux + mel_l
    return aux, metrics


def generator_loss(state: GANTrainState, criterion: GANCriterion,
                   config: dict, batch: dict) -> tuple[torch.Tensor, dict]:
    """The generator's loss at ``state.steps`` and its metrics."""
    y = batch["y"]
    y_ = generate(state.generator, batch)
    aux, metrics = _aux_loss(criterion, y_, y, "train")
    gen_loss = aux * criterion.lambda_aux
    disc_y, disc_y_ = _disc_inputs(config, batch, y, y_)
    p_ = state.discriminator(disc_y_)
    adv = criterion.gen_adv(p_)
    metrics["train/adversarial_loss"] = adv
    if criterion.use_feat_match_loss:
        with torch.no_grad():
            p = state.discriminator(disc_y)
        fm = criterion.feat_match(p_, p)
        metrics["train/feature_matching_loss"] = fm
        adv = adv + criterion.lambda_feat_match * fm
    if state.steps > int(config.get("discriminator_train_start_steps", 0)):
        gen_loss = gen_loss + criterion.lambda_adv * adv
    metrics["train/generator_loss"] = gen_loss
    return gen_loss, metrics


def discriminator_loss(state: GANTrainState, criterion: GANCriterion,
                       config: dict, batch: dict, y_: torch.Tensor
                       ) -> tuple[torch.Tensor, dict]:
    """The discriminator's loss on the real batch and a fake y_."""
    disc_y, disc_y_ = _disc_inputs(config, batch, batch["y"], y_)
    p = state.discriminator(disc_y)
    p_ = state.discriminator(disc_y_)
    real_l, fake_l = criterion.dis_adv(p_, p)
    dis_loss = real_l + fake_l
    return dis_loss, {"train/real_loss": real_l, "train/fake_loss": fake_l,
                      "train/discriminator_loss": dis_loss}


def make_train_step(criterion: GANCriterion, config: dict):
    """``train_step(state, batch, lr_g, lr_d) -> metrics``; updates the
    state's modules and optimizers in place and advances ``state.steps``."""
    gen_start = int(config.get("generator_train_start_steps", 0))
    disc_start = int(config.get("discriminator_train_start_steps", 0))

    def train_step(state: GANTrainState, batch: dict, lr_g: float,
                   lr_d: float) -> dict:
        gen_on = state.steps > gen_start
        disc_on = state.steps > disc_start
        with torch.set_grad_enabled(gen_on):
            gen_loss, metrics = generator_loss(state, criterion, config,
                                               batch)
        if gen_on:
            params = state.opt_g.params
            grads = torch.autograd.grad(gen_loss, params, allow_unused=True)
            for p, g in zip(params, grads):
                p.grad = torch.zeros_like(p) if g is None else g
            state.opt_g.step(lr_g)
            state.opt_g.zero_grad()

        with torch.no_grad():  # the fake from the updated generator
            y2_ = generate(state.generator, batch)
        with torch.set_grad_enabled(disc_on):
            dis_loss, dmetrics = discriminator_loss(state, criterion, config,
                                                    batch, y2_)
        metrics.update(dmetrics)
        if disc_on:
            state.opt_d.zero_grad()
            dis_loss.backward()
            state.opt_d.step(lr_d)
            state.opt_d.zero_grad()
        state.steps += 1
        return {k: v.detach() if torch.is_tensor(v) else torch.tensor(v)
                for k, v in metrics.items()}

    return train_step


def make_eval_step(criterion: GANCriterion, config: dict):
    """``eval_step(state, batch) -> (metrics, y_)``: the losses without
    updates."""

    @torch.no_grad()
    def eval_step(state: GANTrainState, batch: dict):
        y = batch["y"]
        y_ = generate(state.generator, batch)
        aux, metrics = _aux_loss(criterion, y_, y, "eval")
        gen_loss = aux * criterion.lambda_aux
        disc_y, disc_y_ = _disc_inputs(config, batch, y, y_)
        p_ = state.discriminator(disc_y_)
        p = state.discriminator(disc_y)
        adv = criterion.gen_adv(p_)
        metrics["eval/adversarial_loss"] = adv
        if criterion.use_feat_match_loss:
            fm = criterion.feat_match(p_, p)
            metrics["eval/feature_matching_loss"] = fm
            adv = adv + criterion.lambda_feat_match * fm
        metrics["eval/generator_loss"] = gen_loss + criterion.lambda_adv * adv
        real_l, fake_l = criterion.dis_adv(p_, p)
        metrics["eval/real_loss"] = real_l
        metrics["eval/fake_loss"] = fake_l
        metrics["eval/discriminator_loss"] = real_l + fake_l
        return metrics, y_

    return eval_step
