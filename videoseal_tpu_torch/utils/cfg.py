"""Model cards and model construction, counterpart of ``videoseal_tpu/utils/cfg.py``.

`load(name_or_path)` takes a card name (``cards.py``), a card file (the JSON
that ``scripts/make_config.py`` writes), 'baseline/<method>' or a
checkpoint path (``.npz`` with an ``__args__`` blob, ``.pth``/``.pt``
with ``args``) from whose embedded training args it rebuilds the card, with
the embedder and extractor presets of ``presets.py``. Nothing is downloaded.
"""

from __future__ import annotations

import copy
import json
import os

import numpy as np

from .. import presets
from ..cards import CARDS

DEFAULT_CARD = "videoseal_1.0"
_ALIASES = {"videoseal": DEFAULT_CARD}
_CKPT_EXTS = (".pth", ".pt", ".npz")
_PRESETS = {"embedder": presets.EMBEDDER, "extractor": presets.EXTRACTOR}


def available_cards() -> list[str]:
    return sorted(CARDS)


def load_card(name: str) -> dict:
    """A card by name, or read from a card file: JSON text, which is also
    YAML (``scripts/make_config.py`` writes it into a ``.yaml`` file that
    the JAX package's `load_card` reads with yaml.safe_load)."""
    name = _ALIASES.get(name, name)
    if name in CARDS:
        return copy.deepcopy(CARDS[name])
    if name.endswith((".yaml", ".yml", ".json")) or os.path.isfile(name):
        if not os.path.isfile(name):
            raise FileNotFoundError(f"no card file {name!r}")
        with open(name) as f:
            text = f.read()
        try:
            return json.loads(text)
        except json.JSONDecodeError as e:
            raise ValueError(f"{name} is not a JSON card: the port reads card files as JSON "
                             "(scripts/make_config.py writes them), it has no YAML "
                             "parser") from e
    raise FileNotFoundError(f"Unknown model card {name!r}; available: {available_cards()}")


def setup_model_from_model_card(name: str, checkpoint: str | None = None, device="cuda",
                                seed: int = 0):
    from ..models.videoseal import VideoSeal

    return VideoSeal.from_card(load_card(name), checkpoint=checkpoint, device=device,
                               seed=seed)


def _checkpoint_args(ckpt_path: str) -> dict:
    """The training-args dict embedded in a checkpoint: ``ckpt["args"]`` of a
    ``.pth``/``.pt`` file, the ``__args__`` JSON blob of an ``.npz``."""
    if ckpt_path.endswith((".pth", ".pt")):
        import torch

        ckpt = torch.load(ckpt_path, map_location="cpu", weights_only=False)
        if not isinstance(ckpt, dict) or "args" not in ckpt:
            raise KeyError(f"{ckpt_path} has no embedded 'args' (cannot rebuild a model "
                           "from a bare state_dict; name a model card instead)")
        args = ckpt["args"]
        if isinstance(args, (str, bytes)):
            raise ValueError(f"{ckpt_path} embeds its args as a YAML string; the port "
                             "reads args as a dict only (the machine that serves it has no "
                             "YAML parser): name a model card and pass checkpoint=")
        return dict(args)
    with np.load(ckpt_path) as data:
        if "__args__" not in data.files:
            raise KeyError(f"{ckpt_path} has no embedded '__args__' blob")
        blob = data["__args__"].tobytes()
    return json.loads(blob.decode())


def get_config_from_checkpoint(ckpt_path: str) -> dict:
    """A model card rebuilt from a checkpoint's embedded training args, the
    embedder and extractor from their presets (``args[<kind>_model]``, else
    the preset file's default), as the JAX package builds it."""
    args = _checkpoint_args(ckpt_path)
    # backward-compatible arg spellings
    if "img_size" not in args and "img_size_proc" not in args:
        if "img_size_extractor" in args:
            args["img_size_proc"] = args["img_size_extractor"]
    args.setdefault("hidden_size_multiplier", 2)

    def sub(kind: str) -> dict:
        cfg_file = args.get(f"{kind}_config", f"{kind}.yaml")
        if os.path.basename(cfg_file) != f"{kind}.yaml":
            raise ValueError(f"{kind}_config={cfg_file!r}: the port carries the package's "
                             f"{kind}.yaml presets as Python data and cannot parse another "
                             "YAML file")
        table = _PRESETS[kind]
        model = args.get(f"{kind}_model") or table["model"]
        if model not in table:
            raise KeyError(f"{kind} preset {model!r} not in {kind}.yaml")
        return {"model": model, "params": copy.deepcopy(table[model])}

    return {"args": args, "embedder": sub("embedder"), "extractor": sub("extractor"),
            "checkpoint_path": ckpt_path}


def setup_model_from_checkpoint(ckpt_path: str, device="cuda", seed: int = 0):
    """Build from 'baseline/<method>', a card name or a checkpoint path with
    embedded args. A baseline needs its TorchScript files: by name alone it
    raises FileNotFoundError (``models/baselines.build_baseline`` takes the
    paths)."""
    if "baseline" in ckpt_path:
        from ..models.baselines import build_baseline

        return build_baseline(ckpt_path, device=device)
    if not ckpt_path.endswith(_CKPT_EXTS) and "/" not in ckpt_path:
        return setup_model_from_model_card(ckpt_path, device=device, seed=seed)
    from ..models.videoseal import VideoSeal

    return VideoSeal.from_card(get_config_from_checkpoint(ckpt_path), checkpoint=ckpt_path,
                               device=device, seed=seed)


def load(name_or_path: str = DEFAULT_CARD, checkpoint: str | None = None, device="cuda",
         seed: int = 0):
    """Build a VideoSeal on `device` (the card unless the caller asks for the
    CPU) from a card name ("videoseal" is videoseal_1.0), optionally with
    `checkpoint`'s weights, or from a bare checkpoint path with embedded args;
    at random init from `seed` where no weights are given."""
    if (name_or_path.endswith(_CKPT_EXTS) and checkpoint is None) or "baseline" in name_or_path:
        return setup_model_from_checkpoint(name_or_path, device=device, seed=seed)
    return setup_model_from_model_card(name_or_path, checkpoint=checkpoint, device=device,
                                       seed=seed)
