"""`VideoSeal.embed(is_video=True)`: one call watermarks a clip of NHWC u8
frames (a VOD pipeline marking decoded frames before the encoder). The
request ends with a synchronize; its outputs stay on the device."""

from __future__ import annotations

import torch

from .. import checks, costs
from ..reference import pipelines

HARNESS_SYNCS = 1


def inputs(workload, card, gen, device):
    return checks.draw_frames(workload["frames"], workload["height"], workload["width"], gen,
                              device)


def call(model, clip, msg, workload):
    return model.embed(clip, msgs=msg, is_video=True, lowres_attenuation=workload["lowres"])


def finish(outputs):
    if outputs["imgs_w"].is_cuda:
        torch.cuda.synchronize()


def keep(outputs):
    return {"frames": outputs["imgs_w"]}


def ref_key(clip_index, msg_index):
    return clip_index, msg_index


def reference(sd, card, clip, msg, workload, ops):
    frames = pipelines.embed_video(sd, card, clip, msg, workload["lowres"], ops)
    return {"frames": frames, "marks": checks.marks(frames, clip)}


def as_kept(ref, workload):
    """The reference's outputs in the form `keep` gives the program's."""
    return {"frames": ref["frames"]}


def compare(kept, ref, workload):
    return checks.frame_gaps(kept["frames"], ref["frames"], ref["marks"])


def flops(card, workload):
    f, step = workload["frames"], card["args"]["videoseal_step_size"]
    return costs.model_flops(card, keys=-(-f // step))
