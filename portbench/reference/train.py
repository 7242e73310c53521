"""Plain PyTorch reference of the recipe's GAN training step (HiFi-GAN's
losses: mel L1, LSGAN, feature matching; Adam for both models).

One step at ``steps`` on a batch (features ``x`` (B, T, F), target ``y``
(B, S), AR past ``ar`` (B, P)):

1. the generator's loss: ``lambda_aux`` x the mel L1 of y_ = G(x, ar)
   against y; once ``steps > discriminator_train_start_steps`` plus
   ``lambda_adv`` x (LSGAN on D([ar, y_]) + ``lambda_feat_match`` x the L1
   feature matching against D([ar, y]), the real pass without gradient);
   the generator takes an Adam step when ``steps >
   generator_train_start_steps``;
2. the fake regenerated by the updated generator, without gradient;
3. the discriminator's LSGAN loss on ([ar, y], [ar, y2_]), an Adam step
   when ``steps > discriminator_train_start_steps``.

A step returns the losses, and each model's gradients at its first update
by this trainer.

The mel spectrogram is the centred STFT (reflect padding, periodic Hann
window) with the power floored at 1e-10, librosa's Slaney mel matrix, a
floor at 1e-10 and the natural log (``log_base: null``). Sums over
discriminators and layers are not averaged (the recipe's
``average_by_*: false``); feature matching leaves out the logits.
``precision`` is the generator's (``hifigan.generator``); with ``bf16`` the
discriminator also runs in bfloat16 and hands its maps back in float32.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.discriminators import discriminator
from portbench.reference.hifigan import generator


def slaney_mel(sr: float, n_fft: int, n_mels: int, fmin: float,
               fmax: float) -> np.ndarray:
    """(n_mels, 1 + n_fft // 2), librosa's ``filters.mel`` (htk=False,
    norm="slaney")."""
    def hz_to_mel(f):
        f = np.asarray(f, np.float64)
        mel = f / (200.0 / 3)
        log_t = f >= 1000.0
        return np.where(log_t, 15.0 + np.log(np.maximum(f, 1e-10) / 1000.0)
                        / (np.log(6.4) / 27.0), mel)

    def mel_to_hz(m):
        m = np.asarray(m, np.float64)
        f = m * (200.0 / 3)
        return np.where(m >= 15.0, 1000.0 * np.exp((np.log(6.4) / 27.0)
                                                   * (m - 15.0)), f)

    mels = mel_to_hz(np.linspace(hz_to_mel(fmin), hz_to_mel(fmax),
                                 n_mels + 2))
    freqs = np.linspace(0, sr / 2, 1 + n_fft // 2)
    fdiff = np.diff(mels)
    ramps = mels[:, None] - freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0, np.minimum(lower, upper))
    return weights * (2.0 / (mels[2:] - mels[:-2]))[:, None]


class LogMel:
    def __init__(self, p: dict, device):
        self.n_fft, self.hop = p["fft_size"], p["hop_size"]
        win = p.get("win_length") or self.n_fft
        w = torch.hann_window(win, periodic=True, dtype=torch.float64)
        lpad = (self.n_fft - win) // 2
        self.window = F.pad(w, (lpad, self.n_fft - win - lpad)).to(device)
        fmin = p.get("fmin") or 0
        fmax = p.get("fmax") or p["fs"] / 2
        self.mel = torch.from_numpy(slaney_mel(
            p["fs"], self.n_fft, p["num_mels"], fmin, fmax).T.astype(
                np.float32)).to(device)
        if p.get("log_base") is not None:
            raise ValueError("the reference takes the recipe's natural log")

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        z = torch.stft(x, self.n_fft, self.hop,
                       window=self.window.to(x.dtype),
                       center=True, pad_mode="reflect", return_complex=True)
        amp = torch.sqrt(torch.clamp(z.real ** 2 + z.imag ** 2, min=1e-10))
        return torch.log(torch.clamp(amp.transpose(1, 2)
                                     @ self.mel.to(x.dtype), min=1e-10))


@dataclasses.dataclass
class Adam:
    """torch.optim.Adam's update (no weight decay, no amsgrad)."""
    lr: float
    betas: tuple
    eps: float = 1e-8

    def __post_init__(self):
        self.m, self.v, self.t = {}, {}, 0

    def load(self, state: dict) -> None:
        """Start from another Adam's moments (``m``, ``v``, copied) and step
        count (``t``)."""
        self.m = {k: v.clone() for k, v in state["m"].items()}
        self.v = {k: v.clone() for k, v in state["v"].items()}
        self.t = state["t"]

    def step(self, params: dict, grads: dict) -> None:
        self.t += 1
        b1, b2 = self.betas
        with torch.no_grad():
            for k, p in params.items():
                g = grads[k]
                m = self.m.get(k, torch.zeros_like(p)) * b1 + (1 - b1) * g
                v = self.v.get(k, torch.zeros_like(p)) * b2 + (1 - b2) * g * g
                self.m[k], self.v[k] = m, v
                denom = (v / (1 - b2 ** self.t)).sqrt() + self.eps
                p -= self.lr / (1 - b1 ** self.t) * m / denom


def _lsgan_real(outs):
    return sum(torch.mean((o[-1] - 1.0) ** 2) for o in outs)


def _lsgan_fake(outs):
    return sum(torch.mean(o[-1] ** 2) for o in outs)


def _feat_match(fake, real):
    return sum(torch.mean(torch.abs(a - b.detach()))
               for f, r in zip(fake, real) for a, b in zip(f[:-1], r[:-1]))


class Trainer:
    """The reference's training of ``model`` (the recipe's configuration)
    from the state dicts ``g_weights`` and ``d_weights`` (copied), at step
    ``steps``; ``start`` holds each model's Adam state to start from
    (``{"generator": {"m", "v", "t"}, "discriminator": ...}``)."""

    def __init__(self, model: dict, g_weights: dict, d_weights: dict,
                 precision: str, device, start: dict | None = None,
                 steps: int = 0):
        self.model, self.precision = model, precision
        self.g = {k: v.detach().clone().requires_grad_(True)
                  for k, v in g_weights.items()}
        self.d = {k: v.detach().clone().requires_grad_(True)
                  for k, v in d_weights.items()}
        go, do = (model["generator_optimizer_params"],
                  model["discriminator_optimizer_params"])
        self.opt_g = Adam(go["lr"], tuple(go["betas"]))
        self.opt_d = Adam(do["lr"], tuple(do["betas"]))
        if start is not None:
            self.opt_g.load(start["generator"])
            self.opt_d.load(start["discriminator"])
        self.mel = LogMel(model["mel_loss_params"], device)
        self.steps = steps
        self.updated = set()    # the models updated by this trainer

    def _gen(self, batch):
        return generator(self.g, self.model["generator_params"], batch["x"],
                         batch["ar"], self.precision)

    def _disc(self, wave):
        dp = self.model["discriminator_params"]
        if self.precision != "bf16":
            return discriminator(self.d, dp, wave[:, None])
        w = {k: v.bfloat16() for k, v in self.d.items()}
        return [[f.float() for f in o] for o in discriminator(
            w, dp, wave[:, None].bfloat16())]

    def step(self, batch: dict) -> dict:
        """One step; the losses and, for each model updated for the first
        time, its gradients."""
        m = self.model
        gen_on = self.steps > m.get("generator_train_start_steps", 0)
        disc_on = self.steps > m.get("discriminator_train_start_steps", 0)
        y, ar = batch["y"], batch["ar"]
        out = {}
        with torch.set_grad_enabled(gen_on):
            y_ = self._gen(batch)
            gen_loss = m["lambda_aux"] * torch.mean(torch.abs(
                self.mel(y_) - self.mel(y)))
            p_ = self._disc(torch.cat([ar, y_], 1))
            with torch.no_grad():
                p = self._disc(torch.cat([ar, y], 1))
            adv = _lsgan_real(p_) + m["lambda_feat_match"] * _feat_match(
                p_, p)
            if disc_on:
                gen_loss = gen_loss + m["lambda_adv"] * adv
        out["generator_loss"] = gen_loss.detach()
        if gen_on:
            grads = dict(zip(self.g, torch.autograd.grad(
                gen_loss, list(self.g.values()), allow_unused=True)))
            grads = {k: torch.zeros_like(self.g[k]) if g is None else g
                     for k, g in grads.items()}
            if "generator" not in self.updated:
                out["generator_grads"] = grads
                self.updated.add("generator")
            self.opt_g.step(self.g, grads)
        with torch.no_grad():
            y2_ = self._gen(batch)
        with torch.set_grad_enabled(disc_on):
            dis_loss = (_lsgan_real(self._disc(torch.cat([ar, y], 1)))
                        + _lsgan_fake(self._disc(torch.cat([ar, y2_], 1))))
        out["discriminator_loss"] = dis_loss.detach()
        if disc_on:
            grads = dict(zip(self.d, torch.autograd.grad(
                dis_loss, list(self.d.values()), allow_unused=True)))
            grads = {k: torch.zeros_like(self.d[k]) if g is None else g
                     for k, g in grads.items()}
            if "discriminator" not in self.updated:
                out["discriminator_grads"] = grads
                self.updated.add("discriminator")
            self.opt_d.step(self.d, grads)
        self.steps += 1
        return out
