"""`VideoSeal.embed_detect_planar`: one call watermarks a clip of padded
planar u8 frames and runs the extractor over the watermarked frames, the
extractor's input made inside the blend (the port's scored serving path).
The request ends with a synchronize; its outputs stay on the device."""

from __future__ import annotations

import torch

from .. import checks, costs
from ..reference import pipelines

HARNESS_SYNCS = 1
# the planar layout the entry takes: image rows at [R0, R0 + H), columns at
# [C0, C0 + W) of a zero (F, 3, Hp, Wb) u8 buffer, Hp = 96 n + 32 for n
# tiles of 96 rows, Wb the width rounded up to 128 plus C0 on each side;
# the output is (F, 3, 96 n, Wb - 2 C0) with the image at [:H, :W]
R0, C0, TILE, HALO, ALIGN = 28, 128, 96, 32, 128


def buffer_shape(f: int, h: int, w: int) -> tuple:
    return (f, 3, TILE * -(-h // TILE) + HALO, ALIGN * -(-w // ALIGN) + 2 * C0)


def inputs(workload, card, gen, device):
    f, h, w = workload["frames"], workload["height"], workload["width"]
    buf = torch.zeros(buffer_shape(f, h, w), dtype=torch.uint8, device=device)
    buf[:, :, R0:R0 + h, C0:C0 + w] = checks.draw_frames(f, h, w, gen, device).permute(0, 3, 1, 2)
    return buf


def nhwc(clip, workload):
    h, w = workload["height"], workload["width"]
    return clip[:, :, R0:R0 + h, C0:C0 + w].permute(0, 2, 3, 1)


def call(model, clip, msg, workload):
    return model.embed_detect_planar(clip, workload["height"], workload["width"], msgs=msg,
                                     lowres_attenuation=workload["lowres"], fused_detect=True)


def finish(outputs):
    if outputs["preds"].is_cuda:
        torch.cuda.synchronize()


def keep(outputs):
    return {"frames": outputs["imgs_w"], "logits": outputs["preds"]}


def ref_key(clip_index, msg_index):
    return clip_index, msg_index


def reference(sd, card, clip, msg, workload, ops):
    frames = pipelines.embed_video(sd, card, nhwc(clip, workload), msg, workload["lowres"], ops)
    return {"frames": frames, "logits": pipelines.detect(sd, card, frames, ops),
            "marks": checks.marks(frames, nhwc(clip, workload))}


def as_kept(ref, workload):
    """The reference's outputs in the form `keep` gives the program's."""
    return {"frames": ref["frames"].permute(0, 3, 1, 2), "logits": ref["logits"]}


def compare(kept, ref, workload):
    h, w = workload["height"], workload["width"]
    frames = kept["frames"][:, :, :h, :w].permute(0, 2, 3, 1)
    return {**checks.frame_gaps(frames, ref["frames"], ref["marks"]),
            "logit_gap": checks.logit_gap(kept["logits"], ref["logits"])}


def flops(card, workload):
    f, step = workload["frames"], card["args"]["videoseal_step_size"]
    return costs.model_flops(card, keys=-(-f // step), detect_frames=f)
