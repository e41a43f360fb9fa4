"""The system under test: `videoseal_tpu_torch`'s public model, built from a
card and given the benchmark's weights through its public loading path."""

from __future__ import annotations

import functools
import json

import torch


def _meta_model(card: dict):
    from videoseal_tpu_torch.models.videoseal import VideoSeal
    with torch.device("meta"):
        return VideoSeal.from_card(card, device="meta")


@functools.lru_cache(maxsize=8)
def _shapes(card_json: str) -> dict:
    sd = _meta_model(json.loads(card_json)).state_dict()
    return {k: tuple(v.shape) for k, v in sd.items()}


def state_shapes(card: dict) -> dict:
    """{reference name: shape} of the card's state dict, from its structure
    alone (built on the meta device: no weights are made)."""
    return dict(_shapes(json.dumps(card, sort_keys=True)))


def build(card: dict, sd: dict, device, dtype: str):
    """`VideoSeal` for the card on `device`, loaded with `sd` by
    `VideoSeal.load_state_dict`, then `with_dtype(dtype)`: the copy the port
    serves, with its own derived state (folds, packings, kernel parameters)
    made from these weights as it makes them."""
    model = _meta_model(card)
    cast = getattr(torch, dtype)
    for module in (model.embedder, model.extractor):
        module.to_empty(device=device).to(cast)
    model.load_state_dict(sd)
    return model.with_dtype(dtype)
