"""`VideoSeal.detect(is_video=True)`: one call runs the extractor over a
clip of NHWC u8 frames (verification on ingest). The request ends when the
clip's mean logits are read back to the host, as a verifier reads its bits;
the per-frame logits stay on the device."""

from __future__ import annotations

from .. import checks, costs
from ..reference import pipelines

HARNESS_SYNCS = 1


def inputs(workload, card, gen, device):
    return checks.draw_frames(workload["frames"], workload["height"], workload["width"], gen,
                              device)


def call(model, clip, msg, workload):
    return model.detect(clip, is_video=True)


def finish(outputs):
    outputs["mean_logits"] = outputs["preds"].mean(dim=0).cpu()


def keep(outputs):
    return {"logits": outputs["preds"]}


def ref_key(clip_index, msg_index):
    return clip_index


def reference(sd, card, clip, msg, workload, ops):
    return {"logits": pipelines.detect(sd, card, clip, ops)}


def as_kept(ref, workload):
    """The reference's outputs in the form `keep` gives the program's."""
    return ref


def compare(kept, ref, workload):
    return {"logit_gap": checks.logit_gap(kept["logits"], ref["logits"])}


def flops(card, workload):
    return costs.model_flops(card, detect_frames=workload["frames"])
