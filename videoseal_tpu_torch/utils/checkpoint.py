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
`save_train_state` / `load_train_state` write and read the port's training
state: the modules in the same layout, the optimizers' states beside them.
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


def _unet_norm(embedder: torch.nn.Module) -> str:
    """The UNet's `normalization`, from its first norm module's type."""
    from ..modules.common import ChannelLayerNorm, ChanRMSNorm

    for m in embedder.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            return "batch"
        if isinstance(m, torch.nn.GroupNorm):
            return "group"
        if isinstance(m, ChanRMSNorm):
            return "rms"
        if isinstance(m, ChannelLayerNorm):
            return "layer"
    return "batch"


def _flat_optimizer(prefix: str, opt: torch.optim.Optimizer) -> dict:
    sd = opt.state_dict()
    flat = {f"{prefix}{SEP}param_groups": np.frombuffer(
        json.dumps(sd["param_groups"]).encode(), dtype=np.uint8)}
    for idx, st in sd["state"].items():
        for name, v in st.items():
            flat[f"{prefix}{SEP}state{SEP}{idx}{SEP}{name}"] = v.detach().cpu().numpy()
    return flat


def _load_optimizer(prefix: str, data, opt: torch.optim.Optimizer) -> None:
    groups = json.loads(bytes(data[f"{prefix}{SEP}param_groups"]).decode())
    state: dict = {}
    head = f"{prefix}{SEP}state{SEP}"
    for key in data.files:
        if key.startswith(head):
            idx, name = key[len(head):].split(SEP)
            state.setdefault(int(idx), {})[name] = torch.from_numpy(np.array(data[key]))
    opt.load_state_dict({"state": state, "param_groups": groups})


def save_train_state(path: str, state) -> None:
    """A ``parallel.trainer.TrainState`` to ``.npz``: the embedder's and
    extractor's variables in the JAX layout that `save_npz` writes
    (``embedder//params//...``, ``embedder//batch_stats//...``,
    ``extractor//params//...``), the discriminator's as
    ``discriminator//params//...``, both optimizers' states (tensors by
    parameter index, the param groups as JSON), the lr schedule's state,
    the step and scaling_w."""
    from .convert import disc_to_jax, to_jax_variables

    emb_vars, ext_vars = to_jax_variables(state.embedder.state_dict(),
                                          state.extractor.state_dict(),
                                          _unet_norm(state.embedder))
    flat = {f"embedder{SEP}{k}": v for k, v in flatten_tree(emb_vars).items()}
    flat.update({f"extractor{SEP}{k}": v for k, v in flatten_tree(ext_vars).items()})
    flat.update({f"discriminator{SEP}{k}": v for k, v in
                 flatten_tree(disc_to_jax(state.discriminator.state_dict())).items()})
    flat.update(_flat_optimizer("opt_g", state.opt_g))
    flat.update(_flat_optimizer("opt_d", state.opt_d))
    if state.sched_g is not None:
        flat["sched_g"] = np.frombuffer(json.dumps(state.sched_g.state_dict()).encode(),
                                        dtype=np.uint8)
    flat["step"] = np.asarray(state.step, np.int64)
    flat["scaling_w"] = np.asarray(state.scaling_w, np.float32)
    np.savez(path, **flat)


def load_train_state(path: str, state) -> None:
    """Restore a `save_train_state` file into `state` (a freshly created
    TrainState of the same configuration) in place. A train state written
    by the JAX package (its optax trees stored by leaf index) raises
    NotImplementedError: ROADMAP.md 1.8."""
    from .convert import disc_from_jax, from_jax_variables

    with np.load(path) as data:
        if any(k.startswith("__treedef__") for k in data.files):
            raise NotImplementedError(
                f"{path} is a JAX-written train state (optax trees by leaf index); "
                "resuming from it is ROADMAP.md 1.8")
        tree = unflatten_tree({k: data[k] for k in data.files
                               if k.startswith(("embedder", "extractor", "discriminator"))})
        emb, ext = from_jax_variables(tree["embedder"], tree["extractor"])
        state.embedder.load_state_dict(_check_and_cast(emb, state.embedder, "embedder"))
        state.extractor.load_state_dict(_check_and_cast(ext, state.extractor, "extractor"))
        state.discriminator.load_state_dict(_check_and_cast(
            disc_from_jax(tree["discriminator"]), state.discriminator, "discriminator"))
        _load_optimizer("opt_g", data, state.opt_g)
        _load_optimizer("opt_d", data, state.opt_d)
        if state.sched_g is not None:
            state.sched_g.load_state_dict(json.loads(bytes(data["sched_g"]).decode()))
        state.step = int(data["step"])
        state.scaling_w = float(data["scaling_w"])
