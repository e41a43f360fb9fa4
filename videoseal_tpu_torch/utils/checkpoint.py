"""Checkpoint I/O in the JAX package's native ``.npz`` format, numpy only.

Counterpart of ``flatten_tree``, ``unflatten_tree``, ``save_npz``,
``load_npz`` and ``load_into`` in ``videoseal_tpu/utils/checkpoint.py``: the
file holds flattened ``embedder//params//...``, ``embedder//batch_stats//...``
and ``extractor//params//...`` arrays and, optionally, the card's training
args as a JSON blob under ``__args__``. The trees go through
``utils/convert.py`` (``from_jax_variables`` / ``to_jax_variables``) into
and out of the port's state dicts, so either package reads what the other
writes. A reference-named ``torch.save`` file (``.pth``/``.pt``) loads
straight into the port's modules, which keep the reference's names.
"""

from __future__ import annotations

import json

import numpy as np
import torch

SEP = "//"


def flatten_tree(tree: dict, prefix: str = "") -> dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}{SEP}{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(flatten_tree(v, path))
        else:
            out[path] = np.asarray(v)
    return out


def unflatten_tree(flat: dict) -> dict:
    tree: dict = {}
    for path, v in flat.items():
        keys = path.split(SEP)
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = v
    return tree


def save_npz(path: str, model, args: dict | None = None) -> None:
    """Write `model`'s weights (a port ``VideoSeal``) as the JAX package's
    variable trees; `args` (the card's training-args dict) is embedded as a
    JSON blob so that ``utils.cfg.get_config_from_checkpoint`` of either
    package can rebuild the model without a card."""
    from .convert import to_jax_variables

    unet_norm = model.card.get("embedder", {}).get("params", {}).get("unet", {}).get(
        "normalization", "batch")
    emb_vars, ext_vars = to_jax_variables(model.embedder.state_dict(),
                                          model.extractor.state_dict(), unet_norm)
    flat = {f"embedder{SEP}{k}": v for k, v in flatten_tree(emb_vars).items()}
    flat.update({f"extractor{SEP}{k}": v for k, v in flatten_tree(ext_vars).items()})
    if args is not None:
        flat["__args__"] = np.frombuffer(json.dumps(args).encode(), dtype=np.uint8)
    np.savez(path, **flat)


def load_npz(path: str) -> tuple[dict, dict]:
    """(embedder variables, extractor variables) as nested dicts of arrays."""
    with np.load(path) as data:
        tree = unflatten_tree({k: data[k] for k in data.files})
    return tree.get("embedder", {}), tree.get("extractor", {})


def _check_and_cast(loaded: dict, module: torch.nn.Module, where: str) -> dict:
    """`loaded` checked against `module`'s state dict: every entry present
    (``num_batches_tracked``, which no checkpoint format carries, keeps the
    module's), the same shapes, cast to the module's dtypes. Extra entries
    are ignored, as the JAX package ignores them."""
    out = {}
    for k, tv in module.state_dict().items():
        if k not in loaded:
            if k.endswith("num_batches_tracked"):
                out[k] = tv
                continue
            raise KeyError(f"checkpoint missing {where}.{k}")
        lv = torch.as_tensor(loaded[k])
        if tuple(lv.shape) != tuple(tv.shape):
            raise ValueError(f"shape mismatch at {where}.{k}: ckpt {tuple(lv.shape)} vs "
                             f"model {tuple(tv.shape)}")
        out[k] = lv.to(tv.dtype)
    return out


def load_into(path: str, embedder: torch.nn.Module, extractor: torch.nn.Module) -> None:
    """Load a ``.npz`` (native) or ``.pth``/``.pt`` (reference torch names,
    ``embedder.*`` and ``detector.*``, optionally under ``model`` and with a
    ``module.`` prefix) checkpoint into the port's modules."""
    if path.endswith((".pth", ".pt")):
        ckpt = torch.load(path, map_location="cpu", weights_only=False)
        sd = ckpt.get("model", ckpt) if isinstance(ckpt, dict) else ckpt
        sd = {k.removeprefix("module."): v for k, v in sd.items()}
        emb = {k[len("embedder."):]: v for k, v in sd.items() if k.startswith("embedder.")}
        ext = {k[len("detector."):]: v for k, v in sd.items() if k.startswith("detector.")}
    else:
        from .convert import from_jax_variables

        emb, ext = from_jax_variables(*load_npz(path))
    embedder.load_state_dict(_check_and_cast(emb, embedder, "embedder"))
    extractor.load_state_dict(_check_and_cast(ext, extractor, "extractor"))
