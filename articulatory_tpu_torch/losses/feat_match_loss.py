"""Feature-matching L1 over discriminator feature maps (port of
``articulatory_tpu/losses/feat_match_loss.py``). The groundtruth maps are
constants (``detach``)."""

from __future__ import annotations

import torch


class FeatureMatchLoss:
    def __init__(self, average_by_layers: bool = True,
                 average_by_discriminators: bool = True,
                 include_final_outputs: bool = False):
        self.average_by_layers = average_by_layers
        self.average_by_discriminators = average_by_discriminators
        self.include_final_outputs = include_final_outputs

    def __call__(self, feats_hat, feats) -> torch.Tensor:
        loss = 0.0
        for fh, f in zip(feats_hat, feats):
            if not self.include_final_outputs:
                fh, f = fh[:-1], f[:-1]
            disc_loss = 0.0
            for a, b in zip(fh, f):
                disc_loss = disc_loss + torch.mean(torch.abs(a - b.detach()))
            if self.average_by_layers and len(fh) > 0:
                disc_loss = disc_loss / len(fh)
            loss = loss + disc_loss
        if self.average_by_discriminators and len(feats_hat) > 0:
            loss = loss / len(feats_hat)
        return loss
