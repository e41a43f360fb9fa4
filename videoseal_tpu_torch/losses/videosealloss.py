"""GAN, perceptual, detection and decoding losses, counterpart of
``videoseal_tpu/losses/videosealloss.py``.

* ``generator_losses``: the terms (perceptual, hinge-G on a discriminator
  whose parameters take no gradient, detection BCE, decoding BCE) and their
  static weights;
* ``combine``: static weights, or the adaptive balance: each loss scaled by
  (its weight / the weights' sum) * total_norm / ||d loss / d embedder
  output||, the norms taken by the caller (``parallel/trainer.py``) and
  detached; total_norm 0 takes the last loss's norm;
* ``discriminator_loss``: hinge (or vanilla) D on detached real and fake.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.nn.functional as F

from .perceptual import build_perceptual_loss


def hinge_d_loss(logits_real, logits_fake):
    return 0.5 * (torch.mean(F.relu(1.0 - logits_real)) + torch.mean(F.relu(1.0 + logits_fake)))


def _bce(logits, targets):
    """BCEWithLogits, elementwise."""
    return torch.clamp(logits, min=0) - logits * targets + torch.log1p(torch.exp(-torch.abs(logits)))


def vanilla_d_loss(logits_real, logits_fake):
    return 0.5 * (torch.mean(_bce(logits_real, torch.ones_like(logits_real)))
                  + torch.mean(_bce(logits_fake, torch.zeros_like(logits_fake))))


def adopt_weight(weight: float, global_step: int, threshold: int = 0, value: float = 0.0):
    """The discriminator's warm-up: `value` before step `threshold`."""
    return value if global_step < threshold else weight


@dataclasses.dataclass(frozen=True)
class VideoSealLoss:
    balanced: bool = True
    total_norm: float = 0.0
    disc_weight: float = 1.0
    percep_weight: float = 1.0
    detect_weight: float = 1.0
    decode_weight: float = 0.0
    disc_start: int = 0
    disc_loss: str = "hinge"
    percep_loss: str = "yuv"

    def __post_init__(self):
        object.__setattr__(self, "_percep_fn", build_perceptual_loss(self.percep_loss))

    def generator_losses(self, imgs, imgs_w, masks, msgs, preds,
                         disc_apply: Callable, global_step: int) -> tuple[dict, dict]:
        """The loss terms and their weights, all NHWC. `disc_apply` scores
        images with a discriminator whose parameters take no gradient."""
        losses, weights = {}, {}
        if self.percep_weight > 0:
            losses["percep"] = self._percep_fn(imgs, imgs_w)
            weights["percep"] = self.percep_weight
        if self.disc_weight > 0:
            losses["disc"] = -torch.mean(disc_apply(imgs_w))
            weights["disc"] = adopt_weight(self.disc_weight, global_step, self.disc_start)
        if self.detect_weight > 0:
            det = preds[..., 0:1]
            if det.ndim == 4:
                losses["detect"] = torch.mean(_bce(det, masks))
            else:
                # whole-image detector: every training image carries a mark
                losses["detect"] = torch.mean(_bce(det, torch.ones_like(det)))
            weights["detect"] = self.detect_weight
        if self.decode_weight > 0:
            bits = preds[..., 1:]
            if bits.ndim == 2:
                losses["decode"] = torch.mean(_bce(bits, msgs.float()))
            else:
                # pixelwise: BCE only inside the watermark mask
                tgt = msgs[:, None, None, :].float().expand(bits.shape)
                m = (masks > 0.5).expand(bits.shape).float()
                losses["decode"] = torch.sum(_bce(bits, tgt) * m) / torch.clamp(m.sum(), min=1.0)
            weights["decode"] = self.decode_weight
        return losses, weights

    def combine(self, losses: dict, weights: dict, grad_norms: dict | None):
        """(total, logs): static weights without grad_norms, else the
        adaptive balance."""
        if grad_norms is None:
            scales = {k: weights[k] for k in losses}
        else:
            total_weight = sum(float(w) for w in weights.values())
            keys = list(losses)
            tn = self.total_norm if self.total_norm > 0 else grad_norms[keys[-1]]
            scales = {k: (weights[k] / total_weight) * tn / (1e-12 + grad_norms[k])
                      for k in keys}
        total = sum(scales[k] * losses[k] for k in losses)
        logs = {"total_loss": total,
                **{f"loss_{k}": v for k, v in losses.items()},
                **{f"scale_{k}": scales[k] for k in losses}}
        return total, logs

    def discriminator_loss(self, disc_apply: Callable, imgs, imgs_w, global_step: int):
        """(d_loss, logs) on detached real and fake images."""
        logits_real = disc_apply(imgs.detach())
        logits_fake = disc_apply(imgs_w.detach())
        factor = adopt_weight(1.0, global_step, self.disc_start)
        fn = hinge_d_loss if self.disc_loss == "hinge" else vanilla_d_loss
        d_loss = factor * fn(logits_real, logits_fake)
        logs = {"disc_loss": d_loss, "disc_factor": factor,
                "logits_real": torch.mean(logits_real),
                "logits_fake": torch.mean(logits_fake)}
        return d_loss, logs
