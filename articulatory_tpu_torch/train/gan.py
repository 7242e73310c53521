"""The GAN training step (port of ``articulatory_tpu/train/gan.py``).

Per step, with the JAX package's semantics:

1. generator loss: mel (or L1 in inversion modes) and/or multi-resolution
   STFT losses, with ``use_subband_stft_loss`` half of them plus half the
   subband STFT loss, times ``lambda_aux``; plus ``lambda_adv`` times
   (adversarial + ``lambda_feat_match`` x feature matching) once
   ``steps > discriminator_train_start_steps``; the real pass for feature
   matching runs under ``torch.no_grad()``. The generator is updated when
   ``steps > generator_train_start_steps``;
2. the fake is regenerated with the updated generator, without grad;
3. the discriminator loss on (real, fake), updated when
   ``steps > discriminator_train_start_steps``.

Without a discriminator (``state.discriminator`` and ``state.opt_d``
None; the JAX package always trains one) a step is the generator's aux
loss and its update alone: no adversarial term, no regeneration and no
discriminator phases.

A multi-band generator (``out_channels > 1`` and ``pqmf: true``) is
synthesised by ``ops/pqmf.py`` before the losses and the discriminator;
the subband loss compares its bands with the PQMF analysis of y.

The zoo's signatures: Parallel WaveGAN takes ``(noise, aux)``, the legacy
collater's pair, or the aux alone, its noise then drawn for the step;
StyleMelGAN takes its noise ``z`` and its discriminator the random-window
offsets. ``RandomDraws`` draws them from seeded ``torch.Generator``s (JAX
draws from its rng streams, which torch cannot reproduce): the generator
and regeneration passes draw their own noise, the generator loss's fake
and real discriminator passes share one set of windows, the
discriminator's real and fake passes draw one each, as JAX's ``rng_w1``
.. ``rng_w3``. ``fuse_disc_passes`` is refused for a random-window
discriminator, as in JAX (the port never fuses the passes).

BatchNorm (the Transformer, the BiGRU) follows JAX's masked updates: the
generator pass moves the running statistics only when the generator is
updated, and the regeneration runs in training mode (batch statistics,
dropout) without moving them (``layers/norm.py::frozen_stats``).

With ``use_ar`` the AR past (``ar2``, else ``ar``) is concatenated in front
of y and y_ along time before the discriminator; with ``use_pcd`` the
batch's ``pitch`` and ``periodicity`` (B, frames, 1), linearly interpolated
to ``batch_max_steps``, are concatenated to y and y_ along channels
instead. ``use_ph_loss`` (on ``generator_params``, or on
``generator2_params`` in a cascade) adds ``lambda_ph`` x the mean softmax
cross-entropy of the phoneme head's logits against the batch's ``ph`` to
the generator loss. A speaker- or phoneme-conditioned generator reads the
batch's ``spk_id`` and ``ph``.

A cascade (``generator2_type``) chains the trained generator into
``state.generator2``, frozen (no gradient of its own, held by no optimizer;
its BatchNorm statistics never move), through which the generator's
gradient flows; the target is then the generator's input ``x[0]``
(reference train.py:261-263). ``use_remat`` rematerialises the
generator's forward in the generator loss (``torch.utils.checkpoint``,
non-reentrant): its activations are recomputed in the backward, one more
generator forward a step, for a generator without BatchNorm, as in JAX.
Eager Python ``if``s take the place of JAX's masked updates: a gated-off update is not taken, and its
optimizer state does not move. Metrics are detached tensors on the device,
so a step does not wait for the card.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import hashlib
import logging
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from articulatory_tpu_torch import trace
from articulatory_tpu_torch.layers.norm import BatchNorm, frozen_stats
from articulatory_tpu_torch.losses import (
    DiscriminatorAdversarialLoss,
    FeatureMatchLoss,
    GeneratorAdversarialLoss,
    MelSpectrogramLoss,
    MultiResolutionSTFTLoss,
)
from articulatory_tpu_torch.layers.transformer import keep_mask
from articulatory_tpu_torch.models import (
    DROPOUT_GENERATORS,
    NOISE_DRIVEN_GENERATORS,
    RNG_DISCRIMINATORS,
    RNG_GENERATORS,
)
from articulatory_tpu_torch.ops.interp import interpolate_linear
from articulatory_tpu_torch.ops.pqmf import PQMF
from articulatory_tpu_torch.parallel import mesh, tp
from articulatory_tpu_torch.train.optimizers import Optimizer

INVERSION_MODES = ("art", "a2m", "w2a", "m2a", "ph2a", "ph2m")


class RandomDraws:
    """The step's random numbers: normal noise on the device of ``like``
    and dropout keep masks on the device of ``like``, and window offsets on
    the host (Python ints, so drawing them waits for nothing). ``tag``
    names the pass a draw is for (``generator``, ``regeneration``,
    ``generator_windows``, ``real_windows``, ``fake_windows``, ``eval_*``;
    a dropout mask ``<pass>/layers.<i>/<site>``); a test may replay
    another framework's draws by tag, and a reference the masks.

    Each draw comes from a generator seeded by a hash of ``(seed, steps,
    index, tag, n)``: ``at(steps, index)`` keys the draws that follow by the
    step (and an evaluation batch's index), and ``n`` counts the draws of a
    tag since. The draws are so a pure function of the step, as the JAX
    trainer's ``fold_in`` keys are: a run resumed at step k draws what the
    uninterrupted run drew, and every rank draws the same values. Noise has
    one row an utterance: with ``world`` data-parallel ranks each draws the
    global batch's rows and keeps its own (rank ``rank``), so a step of
    several ranks draws what one rank draws on their concatenated batch."""

    def __init__(self, seed: int = 0, rank: int = 0, world: int = 1):
        self.seed, self.rank, self.world = seed, rank, world
        self.at(0)

    def at(self, steps: int, index: int | None = None) -> None:
        """Key the following draws by ``steps`` (and ``index``)."""
        self._key = (int(steps), index)
        self._counts: collections.Counter = collections.Counter()

    def _generator(self, tag: str, device) -> torch.Generator:
        n = self._counts[tag]
        self._counts[tag] += 1
        key = f"{self.seed}/{self._key[0]}/{self._key[1]}/{tag}/{n}"
        digest = hashlib.sha256(key.encode()).digest()
        return torch.Generator(device).manual_seed(
            int.from_bytes(digest[:8], "little") >> 1)

    def normal(self, shape: Sequence[int], like: torch.Tensor,
               tag: str) -> torch.Tensor:
        shape = tuple(shape)
        rows = shape[0]
        z = torch.randn((rows * self.world,) + shape[1:],
                        generator=self._generator(tag, like.device),
                        device=like.device, dtype=like.dtype)
        return z[self.rank * rows:(self.rank + 1) * rows]

    def keep(self, shape: Sequence[int], p: float, like: torch.Tensor,
             tag: str) -> torch.Tensor:
        """A bool dropout keep mask (True with probability 1 - p) on the
        device of ``like``, one row an utterance as ``normal``."""
        shape = tuple(shape)
        rows = shape[0]
        keep = keep_mask((rows * self.world,) + shape[1:], p, like.device,
                         self._generator(tag, like.device))
        return keep[self.rank * rows:(self.rank + 1) * rows]

    def offsets(self, bounds: Sequence[int], tag: str) -> list[int]:
        gen = self._generator(tag, "cpu")
        return [int(torch.randint(0, b, (1,), generator=gen)) for b in bounds]


@dataclasses.dataclass
class GANTrainState:
    generator: nn.Module
    # None (with ``opt_d``) for a step of the generator alone
    discriminator: nn.Module | None
    opt_g: Optimizer
    opt_d: Optimizer | None
    steps: int = 0
    draws: RandomDraws = dataclasses.field(default_factory=RandomDraws)
    # a cascade's second stage, frozen (``requires_grad_(False)``)
    generator2: nn.Module | None = None


class GANCriterion:
    """Loss bundle built from the experiment config."""

    def __init__(self, config: dict):
        gp = config.get("generator_params", {})
        self.gen_adv = GeneratorAdversarialLoss(
            **config.get("generator_adv_loss_params", {}))
        self.dis_adv = DiscriminatorAdversarialLoss(
            **config.get("discriminator_adv_loss_params", {}))
        self.use_stft_loss = config.get("use_stft_loss", True)
        if self.use_stft_loss:
            self.stft = MultiResolutionSTFTLoss(
                **config.get("stft_loss_params", {}))
        out_ch = gp.get("out_channels", 1)
        self.multiband = out_ch > 1 and config.get("pqmf", False)
        self.use_subband_stft_loss = config.get("use_subband_stft_loss",
                                                False)
        if self.use_subband_stft_loss:
            if not self.multiband:
                raise ValueError("use_subband_stft_loss needs a multi-band "
                                 "generator (out_channels > 1, pqmf: true)")
            self.sub_stft = MultiResolutionSTFTLoss(
                **config.get("subband_stft_loss_params", {}))
        self.pqmf = (PQMF(subbands=out_ch, **config.get("pqmf_params", {}))
                     if self.multiband else None)
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
        # in a cascade the phoneme head may sit on generator2
        self.use_ph_loss = gp.get("use_ph_loss", False) or (
            config.get("generator2_type") is not None
            and config.get("generator2_params", {}).get("use_ph_loss", False))
        self.lambda_aux = config.get("lambda_aux", 1.0)
        self.lambda_adv = config.get("lambda_adv", 1.0)
        self.lambda_feat_match = config.get("lambda_feat_match", 1.0)
        self.lambda_ph = config.get("lambda_ph", 1.0)

    def mel_loss(self, y_: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        if self.mel_is_l1:
            return torch.mean(torch.abs(y_ - y))
        return self.mel(_squeeze_c(y_), _squeeze_c(y))


def ph_cross_entropy(logits: torch.Tensor, targets: torch.Tensor
                     ) -> torch.Tensor:
    """Mean softmax cross-entropy of logits (B, T, C) against integer
    targets (B, T)."""
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           targets.reshape(-1).long())


def _squeeze_c(y: torch.Tensor) -> torch.Tensor:
    """(B, T, 1) -> (B, T); multichannel stays as it is."""
    return y[..., 0] if y.dim() == 3 and y.shape[-1] == 1 else y


def _check_fuse_disc(config: dict) -> None:
    """A random-window discriminator draws fresh windows for the real and
    fake passes; a fused [real; fake] pass would share them, so it is
    refused, as in the JAX package (``_check_fuse_disc``)."""
    if config.get("fuse_disc_passes", False) and config.get(
            "discriminator_type") in RNG_DISCRIMINATORS:
        raise ValueError(
            "fuse_disc_passes=true is incompatible with random-window "
            "discriminators (StyleMelGANDiscriminator draws fresh windows "
            "per pass; the fused pass would share one window RNG across "
            "real and fake). Disable fuse_disc_passes for this config.")


def _inputs(generator: nn.Module, batch: dict, draws: RandomDraws | None,
            tag: str) -> tuple[tuple, dict]:
    """The generator's arguments on ``batch``: noise for a Parallel
    WaveGAN without the legacy noise input and StyleMelGAN's ``z`` come
    from ``draws``, and so do the Transformer's dropout masks; a
    conditioned generator reads ``spk_id`` and ``ph``."""
    x, name = batch["x"], type(generator).__name__
    if name in NOISE_DRIVEN_GENERATORS:
        if len(x) == 2:  # the legacy collater's (noise, aux)
            return x, {}
        y = batch["y"]
        return (draws.normal((y.shape[0], y.shape[1], 1), x[0], tag),
                x[0]), {}
    if name in RNG_GENERATORS:
        c = x[0]
        z = draws.normal((c.shape[0], c.shape[1]
                          // generator.noise_upsample_factor,
                          generator.in_channels), c, tag)
        return (c, z), {}
    if name == "MelGANGenerator":
        return x, {}
    if name in DROPOUT_GENERATORS:
        return x, dict(_conditioning(batch, "ar"), draws=draws, tag=tag)
    return x, _conditioning(batch, "ar")


def _forward(generator: nn.Module, batch: dict,
             draws: RandomDraws | None, tag: str, remat: bool = False):
    """The generator's raw output on ``batch``; with ``remat`` its
    activations are dropped after the forward and recomputed in the
    backward, from the same arguments (the noise drawn once, outside)."""
    args, kwargs = _inputs(generator, batch, draws, tag)
    with trace.span("generator"):
        if remat:
            return checkpoint(generator, *args, use_reentrant=False,
                              **kwargs)
        return generator(*args, **kwargs)


def has_mutables(generator: nn.Module) -> bool:
    """True for a generator with BatchNorm statistics (JAX's mutables)."""
    return any(isinstance(m, BatchNorm) for m in generator.modules())


def _conditioning(batch: dict, ar_key: str) -> dict:
    """The AR past (``batch[ar_key]``) and the batch's speaker and phoneme
    ids: the keywords every AR-capable generator's forward takes (HiFi-GAN,
    GBlock, the BiGRU and the Transformer; those without a hook ignore
    them, as the reference's do)."""
    return {"ar": batch.get(ar_key), "spk_id": batch.get("spk_id"),
            "ph": batch.get("ph")}


def generate_ph(generator: nn.Module, batch: dict,
                draws: RandomDraws | None = None, tag: str = "generator",
                generator2: nn.Module | None = None, remat: bool = False
                ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """``(y_, ph_logits)``: the generator's output on ``batch`` (sub-bands
    for a multi-band model) through ``generator2`` in a cascade, and the
    phoneme head's logits, or None without one; ``remat`` rematerialises
    the generator's forward (not generator2's)."""
    out = _forward(generator, batch, draws, tag, remat)
    if generator2 is not None:
        with frozen_stats(generator2):
            out = generator2(out, **_conditioning(batch, "ar2"))
    return out if isinstance(out, tuple) else (out, None)


def generate(generator: nn.Module, batch: dict,
             draws: RandomDraws | None = None, tag: str = "generator",
             generator2: nn.Module | None = None) -> torch.Tensor:
    """The output of ``generate_ph`` without the phoneme logits."""
    return generate_ph(generator, batch, draws, tag, generator2)[0]


def target(state: GANTrainState, batch: dict) -> torch.Tensor:
    """What the output is held to: ``y``, or in a cascade the generator's
    input ``x[0]`` (reference train.py:261-263)."""
    return batch["x"][0] if state.generator2 is not None else batch["y"]


def discriminate(discriminator: nn.Module, x: torch.Tensor,
                 offsets: list[int] | None = None):
    """The discriminator's outputs; a random-window one reads ``offsets``."""
    with trace.span("discriminator"):
        if type(discriminator).__name__ in RNG_DISCRIMINATORS:
            return discriminator(x, offsets)
        return discriminator(x)


def _offsets(state: GANTrainState, x: torch.Tensor, tag: str):
    d = state.discriminator
    if type(d).__name__ not in RNG_DISCRIMINATORS:
        return None
    return state.draws.offsets(d.window_bounds(x.shape[1]), tag)


def synthesize(criterion: GANCriterion, y_: torch.Tensor) -> torch.Tensor:
    """The full-band waveform of a multi-band output; others unchanged."""
    return criterion.pqmf.to(y_.device).synthesis(y_) if criterion.multiband \
        else y_


def _disc_inputs(config: dict, batch: dict, y: torch.Tensor,
                 y_: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """PCD's pitch and periodicity beside y and y_ along channels
    (use_pcd), else the AR past in front of them along time (use_ar)."""
    if config.get("use_pcd", False):
        n = int(config.get("batch_max_steps", 0))
        extra = [interpolate_linear(batch[k], n)
                 for k in ("pitch", "periodicity")]
        return (torch.cat([y, *extra], dim=-1),
                torch.cat([y_, *extra], dim=-1))
    if config.get("generator_params", {}).get("use_ar", False):
        past = batch.get("ar2")
        if past is None:
            past = batch["ar"]
        return torch.cat([past, y], dim=1), torch.cat([past, y_], dim=1)
    return y, y_


def _aux_loss(criterion: GANCriterion, y_, y, prefix: str,
              y_mb_: torch.Tensor | None = None) -> tuple:
    """Aux losses of the (synthesised) y_ against y; ``y_mb_`` the
    sub-bands of a multi-band generator."""
    with trace.span("aux_loss"):
        aux, metrics = 0.0, {}
        if criterion.use_stft_loss:
            sc, mag = criterion.stft(_squeeze_c(y_), _squeeze_c(y))
            metrics[f"{prefix}/spectral_convergence_loss"] = sc
            metrics[f"{prefix}/log_stft_magnitude_loss"] = mag
            aux = aux + sc + mag
        if criterion.use_subband_stft_loss:
            y_mb = criterion.pqmf.to(y.device).analysis(y)
            sub_sc, sub_mag = criterion.sub_stft(y_mb_, y_mb)
            metrics[f"{prefix}/sub_spectral_convergence_loss"] = sub_sc
            metrics[f"{prefix}/sub_log_stft_magnitude_loss"] = sub_mag
            aux = aux * 0.5 + 0.5 * (sub_sc + sub_mag)
        if criterion.use_mel_loss:
            mel_l = criterion.mel_loss(y_, y)
            metrics[f"{prefix}/mel_loss"] = mel_l
            aux = aux + mel_l
        return aux, metrics


def generator_loss(state: GANTrainState, criterion: GANCriterion,
                   config: dict, batch: dict) -> tuple[torch.Tensor, dict]:
    """The generator's loss at ``state.steps`` and its metrics. With
    ``use_remat`` the generator's forward is rematerialised where a
    gradient is taken and the generator keeps no BatchNorm statistics, as
    the JAX package's rule."""
    y = target(state, batch)
    remat = (bool(config.get("use_remat", False)) and torch.is_grad_enabled()
             and not has_mutables(state.generator))
    y_mb_, ph_ = generate_ph(state.generator, batch, state.draws,
                             "generator", state.generator2, remat)
    y_ = synthesize(criterion, y_mb_)
    aux, metrics = _aux_loss(criterion, y_, y, "train", y_mb_)
    gen_loss = aux * criterion.lambda_aux
    if criterion.use_ph_loss:
        ph_l = ph_cross_entropy(ph_, batch["ph"])
        metrics["train/ph_loss"] = ph_l
        gen_loss = gen_loss + criterion.lambda_ph * ph_l
    if state.discriminator is None:
        metrics["train/generator_loss"] = gen_loss
        return gen_loss, metrics
    disc_y, disc_y_ = _disc_inputs(config, batch, y, y_)
    # the fake and the feature-matching real pass share their windows
    offsets = _offsets(state, disc_y_, "generator_windows")
    p_ = discriminate(state.discriminator, disc_y_, offsets)
    adv = criterion.gen_adv(p_)
    metrics["train/adversarial_loss"] = adv
    if criterion.use_feat_match_loss:
        with torch.no_grad():
            p = discriminate(state.discriminator, disc_y, offsets)
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
    disc_y, disc_y_ = _disc_inputs(config, batch, target(state, batch), y_)
    p = discriminate(state.discriminator, disc_y,
                     _offsets(state, disc_y, "real_windows"))
    p_ = discriminate(state.discriminator, disc_y_,
                      _offsets(state, disc_y_, "fake_windows"))
    real_l, fake_l = criterion.dis_adv(p_, p)
    dis_loss = real_l + fake_l
    return dis_loss, {"train/real_loss": real_l, "train/fake_loss": fake_l,
                      "train/discriminator_loss": dis_loss}


def make_train_step(criterion: GANCriterion, config: dict):
    """``train_step(state, batch, lr_g, lr_d) -> metrics``; updates the
    state's modules and optimizers in place and advances ``state.steps``.
    Each step's phases (``trace.PHASES``, those that run) are accounted and
    spanned by ``trace.StepAccount``, keyed by ``state.steps`` as the step
    begins."""
    gen_start = int(config.get("generator_train_start_steps", 0))
    disc_start = int(config.get("discriminator_train_start_steps", 0))
    _check_fuse_disc(config)

    def train_step(state: GANTrainState, batch: dict, lr_g: float,
                   lr_d: float) -> dict:
        account = trace.StepAccount(
            state.steps, next(state.generator.parameters()).device)
        state.draws.at(state.steps)
        lay = mesh.layout()
        gen_on = state.steps > gen_start
        disc_on = state.steps > disc_start
        # BatchNorm statistics move only with a generator update
        keep = (contextlib.nullcontext() if gen_on
                else frozen_stats(state.generator))
        with (account.phase("generator_loss"), torch.set_grad_enabled(gen_on),
              keep):
            gen_loss, metrics = generator_loss(state, criterion, config,
                                               batch)
        if gen_on:
            params = state.opt_g.params
            with account.phase("generator_backward"):
                grads = torch.autograd.grad(gen_loss, params,
                                            allow_unused=True)
                for p, g in zip(params, grads):
                    p.grad = torch.zeros_like(p) if g is None else g
                mesh.all_reduce_grads(params, lay.dp_group)
                if getattr(state.generator, "tp", None) is not None:
                    tp.sync_replicated_grads(state.generator)
            with account.phase("generator_update"):
                state.opt_g.step(lr_g)
                state.opt_g.zero_grad()
        if state.discriminator is None:
            return _close(state, account, metrics)

        # the fake from the updated generator, in training mode, without
        # moving the BatchNorm statistics
        with (account.phase("regeneration"), torch.no_grad(),
              frozen_stats(state.generator)):
            y2_ = synthesize(criterion, generate(
                state.generator, batch, state.draws, "regeneration",
                state.generator2))
        with account.phase("discriminator_loss"), torch.set_grad_enabled(
                disc_on):
            dis_loss, dmetrics = discriminator_loss(state, criterion, config,
                                                    batch, y2_)
        metrics.update(dmetrics)
        if disc_on:
            with account.phase("discriminator_backward"):
                state.opt_d.zero_grad()
                dis_loss.backward()
                mesh.all_reduce_grads(state.opt_d.params, lay.dp_group)
                # replicated across a TP group: its first rank's gradients
                mesh.follow_first([p.grad for p in state.opt_d.params
                                   if p.grad is not None], lay.tp_group)
            with account.phase("discriminator_update"):
                state.opt_d.step(lr_d)
                state.opt_d.zero_grad()
        return _close(state, account, metrics)

    return train_step


def _close(state: GANTrainState, account: trace.StepAccount,
           metrics: dict) -> dict:
    """The end of a step: the step count advanced, the account closed, the
    metrics detached."""
    state.steps += 1
    account.close()
    return {k: v.detach() if torch.is_tensor(v) else torch.tensor(v)
            for k, v in metrics.items()}


def make_eval_step(criterion: GANCriterion, config: dict):
    """``eval_step(state, batch) -> (metrics, y_)``: the losses without
    updates, the generator in evaluation mode (BatchNorm running
    statistics, no dropout). Its draws follow ``state.draws``'s key, which
    the trainer sets to the step and the batch's index in the evaluation."""
    _check_fuse_disc(config)

    @torch.no_grad()
    def eval_step(state: GANTrainState, batch: dict):
        y = target(state, batch)
        models = [m for m in (state.generator, state.generator2)
                  if m is not None]
        modes = [m.training for m in models]
        for m in models:
            m.eval()
        try:
            y_mb_, ph_ = generate_ph(state.generator, batch, state.draws,
                                     "eval_generator", state.generator2)
        finally:
            for m, mode in zip(models, modes):
                m.train(mode)
        y_ = synthesize(criterion, y_mb_)
        aux, metrics = _aux_loss(criterion, y_, y, "eval", y_mb_)
        gen_loss = aux * criterion.lambda_aux
        if criterion.use_ph_loss:
            ph_l = ph_cross_entropy(ph_, batch["ph"])
            metrics["eval/ph_loss"] = ph_l
            gen_loss = gen_loss + criterion.lambda_ph * ph_l
        if state.discriminator is None:
            metrics["eval/generator_loss"] = gen_loss
            return metrics, y_
        disc_y, disc_y_ = _disc_inputs(config, batch, y, y_)
        p_ = discriminate(state.discriminator, disc_y_,
                          _offsets(state, disc_y_, "eval_fake_windows"))
        p = discriminate(state.discriminator, disc_y,
                         _offsets(state, disc_y, "eval_real_windows"))
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
