"""Model cards and model construction, counterpart of ``videoseal_tpu/utils/cfg.py``."""

from __future__ import annotations

import copy

from ..cards import CARDS

DEFAULT_CARD = "videoseal_1.0"
_ALIASES = {"videoseal": DEFAULT_CARD}


def load_card(name: str) -> dict:
    name = _ALIASES.get(name, name)
    if name not in CARDS:
        raise FileNotFoundError(f"Unknown model card {name!r}; available: {sorted(CARDS)}")
    return copy.deepcopy(CARDS[name])


def load(name: str = DEFAULT_CARD, checkpoint: str | None = None, device="cuda",
         seed: int = 0):
    """Build a VideoSeal from a card name ("videoseal" is videoseal_1.0) on
    `device` (the card unless the caller asks for the CPU), at random init
    from `seed` unless a checkpoint is given."""
    from ..models.videoseal import VideoSeal

    return VideoSeal.from_card(load_card(name), checkpoint=checkpoint, device=device,
                               seed=seed)
