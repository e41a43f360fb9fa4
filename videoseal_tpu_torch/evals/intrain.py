"""In-training evaluation, counterpart of ``videoseal_tpu/evals/intrain.py``.

Every ``eval_freq`` epochs the training loop embeds a held-out batch with
the current state (the embedder in eval mode: BatchNorm's running
statistics), logs PSNR and SSIM, then for every (attack, strength) row of a
validation grid and every validation mask: masks the watermark in,
attacks, resizes, detects and logs bit accuracy. Everything runs under
``torch.no_grad``, so the extractor takes its kernel route (K2 on the
card). Video batches are (V, F, H, W, 3) clips with one message per clip:
key frames embed and spread over the clip (the training step's video
mode), each row attacks clip by clip on the video grid, and every frame is
scored. The video grid's codec rows run the on-device proxy, as the JAX
package's in-training eval does (it jits them); the exact codecs belong to
``evals/full.py``. A pixelwise extractor's bit accuracy counts the bits
under the attacked mask, resized to the prediction's grid (an item whose
mask is empty is left out of the row's mean); with `lambda_det` > 0 each
row also logs the detection channel's pixel accuracy and mean IoU against
the mask before the attack, as the JAX package (and the reference) do.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.metrics import accuracy, bit_accuracy, iou, psnr, ssim
from ..ops.resize import resize_bilinear


def _proxy(aug):
    """The on-device proxy in place of an exact codec row."""
    from ..augmentation import augs as A
    if isinstance(aug, A.VideoCompressionExact):
        return A.VideoCompressionProxy(codec=aug.codec)
    return aug


def make_intrain_eval(mods, eval_augs: str = "subset", validation_masks=None,
                      is_video: bool = False, lambda_det: float = 0.0):
    """eval_fn(state, imgs, generator, msgs=None) -> (scalars dict, imgs_w)
    over TrainerModules `mods`: imgs a held-out (B, H, W, 3) float batch in
    [0, 1] (numpy or tensor), or with is_video (V, F, H, W, 3) clips; the
    messages (one per image or clip) come from `generator`, or `msgs`
    injects them; imgs_w has imgs' shape.
    validation_masks: a list of (H, W) or (H, W, 1) arrays in {0, 1};
    default one all-ones mask."""
    from ..augmentation.validation import (Sequential, get_validation_augs,
                                           get_validation_augs_geometric,
                                           get_validation_augs_subset)
    from ..parallel.trainer import embed_batch, watermark

    s = mods.cfg.img_size
    if eval_augs == "identity":
        grid = get_validation_augs(is_video, only_identity=True)
    elif eval_augs == "full":
        grid = get_validation_augs(is_video)
    elif eval_augs == "geometric":
        grid = get_validation_augs_geometric(is_video)
    else:
        grid = get_validation_augs_subset(is_video)
    grid = [(Sequential(*map(_proxy, aug.augs)) if isinstance(aug, Sequential) else _proxy(aug),
             st) for aug, st in grid]
    rows = [(f"{aug.name}_{st}", aug, st) for aug, strengths in grid for st in strengths]
    if validation_masks is None:
        masks_list = [np.ones((1, 1, 1), np.float32)]     # broadcasts to any H, W
    else:
        masks_list = [np.asarray(m, np.float32) for m in validation_masks]
        masks_list = [m[..., None] if m.ndim == 2 else m for m in masks_list]

    def row(state, imgs, imgs_w, mask, msgs, aug, strength, clips: int) -> dict:
        """imgs, imgs_w: (N, H, W, 3) frames, `clips` equal clips of them."""
        mask_b = mask.expand((imgs_w.shape[0],) + tuple(imgs_w.shape[1:3]) + (1,))
        masked = imgs_w * mask_b + imgs * (1.0 - mask_b)
        # a video row attacks each clip alone: the temporal attacks take one
        # clip's frames as their leading axis
        outs = [aug.apply_strength(x, m, strength) for x, m in
                zip(masked.chunk(clips), mask_b.chunk(clips))]
        att = torch.cat([o[0] for o in outs])
        preds = state.extractor(resize_bilinear(att, s, s))
        if preds.dim() != 4:
            return {"bit_acc": float(torch.mean(bit_accuracy(preds[..., 1:], msgs)))}
        grid = tuple(preds.shape[1:3])
        mask_aug = resize_bilinear(torch.cat([o[1] for o in outs]).float(), *grid)
        out = {"bit_acc": float(torch.nanmean(bit_accuracy(preds[..., 1:], msgs,
                                                           mask=mask_aug)))}
        if lambda_det > 0:
            m_orig = resize_bilinear(mask_b.float(), *grid)
            det = preds[..., :1]
            out["acc"] = float(torch.mean(accuracy(det, m_orig)))
            out["miou"] = float(0.5 * (torch.mean(iou(det, m_orig, label=0))
                                       + torch.mean(iou(det, m_orig, label=1))))
        return out

    def eval_fn(state, imgs, generator: torch.Generator, msgs: torch.Tensor | None = None):
        dev = next(state.embedder.parameters()).device
        imgs = torch.as_tensor(imgs, dtype=torch.float32, device=dev)
        if msgs is None:
            msgs = torch.randint(0, 2, (imgs.shape[0], mods.cfg.nbits), generator=generator,
                                 device=generator.device)
        msgs = msgs.to(dev)
        was_training = state.embedder.training
        state.embedder.eval()
        try:
            with torch.no_grad():
                preds_w, frame_msgs = embed_batch(mods, state.embedder, imgs, msgs, is_video)
                flat = imgs.reshape((-1,) + tuple(imgs.shape[-3:]))
                imgs_w = watermark(mods, flat, preds_w, state.scaling_w)
                scalars = {"psnr": float(torch.mean(psnr(imgs_w, flat))),
                           "ssim": float(torch.mean(ssim(imgs_w, flat)))}
                clips = imgs.shape[0] if is_video else 1
                for mask_id, mask in enumerate(masks_list):
                    mt = torch.as_tensor(mask, device=dev)
                    sfx = "" if mask_id == 0 else f"_mask{mask_id}"
                    for name, aug, st in rows:
                        for k, v in row(state, flat, imgs_w, mt, frame_msgs, aug, st,
                                        clips).items():
                            scalars[f"{k}_{name}{sfx}"] = v
        finally:
            state.embedder.train(was_training)
        return scalars, imgs_w.reshape(imgs.shape)

    return eval_fn
