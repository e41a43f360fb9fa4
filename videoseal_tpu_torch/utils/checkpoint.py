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
`load_train_state` also resumes a train state the JAX package wrote (its
optax trees stored leaf by leaf beside their treedefs' text). A resume
restores what optax restores, from either package's files: each
parameter's optimizer state and the schedule's count; the lr, the weight
decay and the schedule are the running optimizers', set by the new run's
flags (the files still carry the param groups and the scheduler's state).
`save_train_state_sharded` / `load_train_state_sharded` are the collective
checkpoints of ``--ckpt_format orbax``: ``torch.distributed.checkpoint``
files (not orbax's) in one numbered subdirectory per step, the last
`keep` kept, as the JAX package lays out its orbax checkpoints.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import warnings

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

    emb_vars, ext_vars = to_jax_variables(model.embedder.state_dict(),
                                          model.extractor.state_dict(),
                                          _unet_norm(model.embedder), _unet_norm(model.extractor))
    flat = {f"embedder{SEP}{k}": v for k, v in flatten_tree(emb_vars).items()}
    flat.update({f"extractor{SEP}{k}": v for k, v in flatten_tree(ext_vars).items()})
    if args is not None:
        flat["__args__"] = np.frombuffer(json.dumps(args).encode(), dtype=np.uint8)
    np.savez(path, **flat)


def load_npz(path: str) -> tuple[dict, dict]:
    """(embedder variables, extractor variables) as nested dicts of arrays,
    also from a train state the JAX package wrote."""
    with np.load(path) as data:
        if "__treedef__embedder_params" in data.files:
            return ({"params": _jax_field(data, "embedder_params"),
                     "batch_stats": _jax_field(data, "embedder_stats")},
                    {"params": _jax_field(data, "extractor_params")})
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
    """A module's `normalization` (the UNet's, HiDDeN's), from its first
    norm module's type."""
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


def _resume_optimizer(opt: torch.optim.Optimizer, state: dict, saved_groups: list) -> None:
    """Restore the per-parameter `state` (tensors by parameter index) into
    `opt`, as optax restores its moments and count: the running param
    groups, whose lr, weight decay and betas the new run's flags set, are
    kept (the saved groups only checked to hold as many parameters)."""
    sd = opt.state_dict()
    have, want = ([len(g["params"]) for g in groups] for groups in (saved_groups,
                                                                    sd["param_groups"]))
    if have != want:
        raise ValueError(f"the checkpoint's optimizer holds {have} parameters a group, "
                         f"the running one {want}")
    sd["state"] = state
    opt.load_state_dict(sd)


def _resume_schedule(sched, count: int) -> None:
    """Put `sched` (a LambdaLR on the new run's schedule) at optax's
    `count`: the next update runs at the new schedule's lr at that count."""
    sched.last_epoch = count - 1
    with warnings.catch_warnings():
        # a position set before the first update, not a step skipped
        warnings.filterwarnings("ignore", message=re.escape("Detected call of `lr_scheduler"))
        sched.step()


def _load_optimizer(prefix: str, data, opt: torch.optim.Optimizer) -> None:
    state: dict = {}
    head = f"{prefix}{SEP}state{SEP}"
    for key in data.files:
        if key.startswith(head):
            idx, name = key[len(head):].split(SEP)
            state.setdefault(int(idx), {})[name] = torch.from_numpy(np.array(data[key]))
    _resume_optimizer(opt, state, json.loads(bytes(data[f"{prefix}{SEP}param_groups"]).decode()))


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
                                          _unet_norm(state.embedder),
                                          _unet_norm(state.extractor))
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
    """Restore a `save_train_state` file, or a train state the JAX package
    wrote, into `state` (a freshly created TrainState of the same
    configuration) in place: the modules, each parameter's optimizer state,
    the schedule's count, the step and scaling_w. `state`'s optimizers and
    schedule keep their hyperparameters, so the next update runs at its
    schedule's lr at the restored count, as the JAX package resumes."""
    from .convert import disc_from_jax, from_jax_variables

    with np.load(path) as data:
        if any(k.startswith("__treedef__") for k in data.files):
            return _load_jax_train_state(data, state)
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
            _resume_schedule(state.sched_g,
                             json.loads(bytes(data["sched_g"]).decode())["last_epoch"])
        state.step = int(data["step"])
        state.scaling_w = float(data["scaling_w"])


# -- a train state the JAX package wrote ------------------------------------------------

# the fields of the optax states a train state can hold, in their order
OPTAX_FIELDS = {"ScaleByAdamState": ("count", "mu", "nu"),
                "FactoredState": ("count", "v_row", "v_col", "v"),
                "ScaleByScheduleState": ("count",), "TraceState": ("trace",),
                "EmptyState": ()}
_TOKEN = re.compile(r"\s*(PyTreeDef\(|CustomNode\(|namedtuple\[(\w+)\]|'([^']*)'|\*|None"
                    r"|[()\[\]{},:])")


def treedef_leaf_paths(text: str) -> list[tuple]:
    """The path of every leaf, in flatten order, of a JAX ``PyTreeDef``'s
    text (``repr(treedef)``): dict keys, tuple and list indices, and
    ``"<namedtuple>.<field>"`` for a namedtuple node (fields from
    OPTAX_FIELDS; an unknown namedtuple raises ValueError)."""
    toks, pos = [], 0
    while pos < len(text):
        m = _TOKEN.match(text, pos)
        if m is None:
            if text[pos:].strip():
                raise ValueError(f"cannot parse the treedef at {text[pos:pos + 40]!r}")
            break
        toks.append(m)
        pos = m.end()
    it = iter(toks)
    paths: list[tuple] = []

    def expect(tok):
        m = next(it)
        if m.group(1) != tok:
            raise ValueError(f"treedef: expected {tok!r}, got {m.group(1)!r}")

    def items(close, prefix, key_of):
        """Read the children up to `close`: key_of(i, m), m a child's first
        token, gives its key and the token its node starts at (a dict's
        child reads its key and colon there)."""
        i = 0
        m = next(it)
        while m.group(1) != close:
            if m.group(1) == ",":
                m = next(it)
                continue
            key, m = key_of(i, m)
            node(m, prefix + (key,))
            i += 1
            m = next(it)

    def node(m, prefix):
        t = m.group(1)
        if t == "*":
            paths.append(prefix)
        elif t == "None":
            pass
        elif t == "(":
            items(")", prefix, lambda i, m: (i, m))
        elif t == "[":
            items("]", prefix, lambda i, m: (i, m))
        elif t == "{":
            def dict_key(i, m):
                if m.group(3) is None:
                    raise ValueError(f"treedef: dict key expected, got {m.group(1)!r}")
                expect(":")
                return m.group(3), next(it)
            items("}", prefix, dict_key)
        elif t == "CustomNode(":
            name = next(it).group(2)
            if name not in OPTAX_FIELDS:
                raise ValueError(f"treedef: namedtuple {name} is not an optax state the "
                                 f"port reads ({sorted(OPTAX_FIELDS)})")
            expect(",")
            expect("[")
            fields = OPTAX_FIELDS[name]
            items("]", prefix, lambda i, m: (f"{name}.{fields[i]}", m))
            expect(")")
        else:
            raise ValueError(f"treedef: unexpected {t!r}")

    expect("PyTreeDef(")
    node(next(it), ())
    return paths


def _jax_field(data, field: str) -> dict:
    """A field of a JAX-written train state as a nested dict keyed by path
    element (dict keys, indices, namedtuple fields)."""
    paths = treedef_leaf_paths(bytes(data[f"__treedef__{field}"]).decode())
    return _nest_paths({path: data[f"{field}{SEP}{i}"] for i, path in enumerate(paths)})


def _flat_paths(tree, prefix=()) -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_paths(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _nest_paths(flat: dict) -> dict:
    tree: dict = {}
    for path, v in flat.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return tree


def _jax_opt_into(opt: torch.optim.Optimizer, chain: dict, jax_params: dict, to_torch,
                  names: list[str], sched=None) -> None:
    """Fill `opt` (whose parameters, in order, carry `names`) from an optax
    chain state over `jax_params`: `to_torch` maps a tree shaped like
    jax_params to the port's tensors by those names. Adam's (and lamb's)
    count, mu and nu become each parameter's step, exp_avg and exp_avg_sq;
    SGD's trace its momentum buffer; adafactor's moments go through
    `_jax_adafactor`; a schedule's count becomes `sched`'s position."""
    from .optim import Adafactor, Lamb

    slots = {k: v for part in chain.values() for k, v in part.items()}
    kinds = {k.split(".")[0] for k in slots}
    unknown = kinds - {"ScaleByAdamState", "TraceState", "FactoredState",
                       "ScaleByScheduleState"}
    if unknown:
        raise ValueError(f"optax states {sorted(unknown)} have no counterpart in the port")
    want = {"ScaleByAdamState": (torch.optim.Adam, torch.optim.AdamW, Lamb),
            "TraceState": (torch.optim.SGD,), "FactoredState": (Adafactor,)}
    for kind, types in want.items():
        if kind in kinds and not isinstance(opt, types):
            raise ValueError(f"a JAX {kind} cannot resume {type(opt).__name__}")
    if not kinds & set(want) and (opt.state or not isinstance(opt, torch.optim.SGD)
                                  or opt.defaults.get("momentum")):
        raise ValueError(f"the JAX optimizer keeps no state; {type(opt).__name__} needs one")
    state: dict = {}
    if "ScaleByAdamState" in kinds:
        step = float(slots["ScaleByAdamState.count"])
        mu, nu = to_torch(slots["ScaleByAdamState.mu"]), to_torch(slots["ScaleByAdamState.nu"])
        state = {i: {"step": torch.tensor(step), "exp_avg": mu[n], "exp_avg_sq": nu[n]}
                 for i, n in enumerate(names)}
    elif "TraceState" in kinds:
        trace = to_torch(slots["TraceState.trace"])
        state = {i: {"momentum_buffer": trace[n]} for i, n in enumerate(names)}
    elif "FactoredState" in kinds:
        state = _jax_adafactor(slots, jax_params, to_torch, names,
                               opt.defaults["min_dim_size_to_factor"])
    dev = opt.param_groups[0]["params"][0].device
    sd = opt.state_dict()
    sd["state"] = {i: {k: v.to(dev) if k != "step" else v for k, v in st.items()}
                   for i, st in state.items()}
    opt.load_state_dict(sd)
    if "ScaleByScheduleState" in kinds:
        if sched is None:
            raise ValueError("the JAX state has an lr schedule and the port's state none")
        _resume_schedule(sched, int(slots["ScaleByScheduleState.count"]))


def _jax_adafactor(slots, jax_params, to_torch, names, min_dim) -> dict:
    """Adafactor's per-parameter state from optax's FactoredState. A
    factored moment (v_row, the mean over JAX axis d0; v_col, over d1) is
    broadcast back to the parameter's JAX shape and converted with it; the
    torch axis that d0 (d1) became is found by converting its coordinates,
    and the moment goes, narrowed on it, to whichever of the port's two
    moments reduces that axis."""
    from .optim import factored_dims
    count = float(slots["FactoredState.count"])
    shapes = {k: np.shape(v) for k, v in _flat_paths(jax_params).items()}
    rows = _flat_paths(slots["FactoredState.v_row"])
    cols = _flat_paths(slots["FactoredState.v_col"])
    full = {"v_row": {}, "v_col": {}, "d0": {}, "d1": {}}
    for k, shape in shapes.items():
        dims = factored_dims(shape, min_dim)
        if dims is None:
            for t in full.values():
                t[k] = np.zeros(shape, np.float32)
            continue
        d1, d0 = dims
        full["v_row"][k] = np.broadcast_to(np.expand_dims(rows[k], d0), shape)
        full["v_col"][k] = np.broadcast_to(np.expand_dims(cols[k], d1), shape)
        for tag, d in (("d0", d0), ("d1", d1)):
            full[tag][k] = np.broadcast_to(np.arange(shape[d], dtype=np.float32).reshape(
                [-1 if i == d else 1 for i in range(len(shape))]), shape)
    whole = _flat_paths(slots["FactoredState.v"])     # (1,) where factored
    full["v"] = {k: whole[k] if factored_dims(shape, min_dim) is None
                 else np.zeros(shape, np.float32) for k, shape in shapes.items()}
    conv = {t: to_torch(_nest_paths(tree)) for t, tree in full.items()}
    state = {}
    for i, n in enumerate(names):
        shape = tuple(conv["d0"][n].shape)
        dims = factored_dims(shape, min_dim)
        if dims is None:
            state[i] = {"step": torch.tensor(count), "v": conv["v"][n]}
            continue
        st = {"step": torch.tensor(count)}
        for src, tag in (("v_row", "d0"), ("v_col", "d1")):
            axis = _axis_of(conv[tag][n])
            slot = {dims[1]: "v_row", dims[0]: "v_col"}.get(axis)
            if slot is None:
                raise ValueError(f"{n}: JAX factors an axis the port does not ({dims})")
            st[slot] = conv[src][n].narrow(axis, 0, 1).contiguous()
        state[i] = st
    return state


def _axis_of(coords: torch.Tensor) -> int:
    """The one axis along which a converted coordinate array varies."""
    axes = [a for a in range(coords.dim()) if coords.shape[a] > 1
            and bool((coords.diff(dim=a) != 0).any())]
    if len(axes) != 1:
        raise ValueError(f"cannot place a factored axis: it varies along {axes}")
    return axes[0]


def _load_jax_train_state(data, state) -> None:
    from .convert import disc_from_jax, from_jax_variables

    e_params, x_params = _jax_field(data, "embedder_params"), _jax_field(data, "extractor_params")
    d_params = _jax_field(data, "disc_params")
    emb, ext = from_jax_variables({"params": e_params,
                                   "batch_stats": _jax_field(data, "embedder_stats")},
                                  {"params": x_params})
    state.embedder.load_state_dict(_check_and_cast(emb, state.embedder, "embedder"))
    state.extractor.load_state_dict(_check_and_cast(ext, state.extractor, "extractor"))
    state.discriminator.load_state_dict(_check_and_cast(
        disc_from_jax({"params": d_params}), state.discriminator, "discriminator"))

    def gen_to_torch(tree):
        e, x = from_jax_variables({"params": tree["embedder"]}, {"params": tree["extractor"]})
        return {**{f"embedder.{k}": t for k, t in e.items()},
                **{f"extractor.{k}": t for k, t in x.items()}}

    gen_names = ([f"embedder.{n}" for n, _ in state.embedder.named_parameters()]
                 + [f"extractor.{n}" for n, _ in state.extractor.named_parameters()])
    _jax_opt_into(state.opt_g, _jax_field(data, "opt_state_g"),
                  {"embedder": e_params, "extractor": x_params}, gen_to_torch, gen_names,
                  state.sched_g)
    _jax_opt_into(state.opt_d, _jax_field(data, "opt_state_d"), d_params,
                  lambda tree: disc_from_jax({"params": tree}),
                  [n for n, _ in state.discriminator.named_parameters()])
    state.step = int(data["step"])
    state.scaling_w = float(data["scaling_w"])


# -- sharded, collective checkpoints (--ckpt_format orbax) -----------------------------

def _sharded_state_dict(state) -> dict:
    sd = {}
    for name in ("embedder", "extractor", "discriminator"):
        sd.update({f"{name}.{k}": v for k, v in getattr(state, name).state_dict().items()})
    for name in ("opt_g", "opt_d"):
        osd = getattr(state, name).state_dict()
        sd[f"{name}.param_groups"] = json.dumps(osd["param_groups"])
        for idx, st in osd["state"].items():
            sd.update({f"{name}.state.{idx}.{k}": v for k, v in st.items()})
    if state.sched_g is not None:
        sd["sched_g"] = json.dumps(state.sched_g.state_dict())
    sd["step"] = torch.tensor(state.step, dtype=torch.int64)
    sd["scaling_w"] = torch.tensor(state.scaling_w, dtype=torch.float64)
    return sd


def checkpoint_steps(ckpt_dir: str) -> list[int]:
    """The steps of the complete checkpoints under ckpt_dir, ascending."""
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(d) for d in os.listdir(ckpt_dir)
                  if d.isdigit() and os.path.exists(os.path.join(ckpt_dir, d, ".metadata")))


def save_train_state_sharded(ckpt_dir: str, state, step: int | None = None,
                             keep: int = 3) -> str:
    """Write `state` as ``ckpt_dir/<step>/`` with
    ``torch.distributed.checkpoint``: call from every rank (collective;
    each rank writes its share of the tensors, replicated ones once). The
    newest `keep` steps stay. Returns the step's directory."""
    import torch.distributed as dist
    import torch.distributed.checkpoint as dcp

    step = int(state.step if step is None else step)
    path = os.path.join(ckpt_dir, str(step))
    dcp.save(_sharded_state_dict(state), checkpoint_id=path)
    if not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0:
        for old in checkpoint_steps(ckpt_dir)[:-keep]:
            shutil.rmtree(os.path.join(ckpt_dir, str(old)), ignore_errors=True)
    return path


def load_train_state_sharded(ckpt_dir: str, state, step: int | None = None) -> int:
    """Restore ``ckpt_dir/<step>/`` (the latest step by default) into
    `state` (a freshly created TrainState of the same configuration) in
    place, on every rank, as `load_train_state` restores a file. Returns
    the step."""
    import torch.distributed.checkpoint as dcp
    from torch.distributed.checkpoint.metadata import TensorStorageMetadata

    steps = checkpoint_steps(ckpt_dir)
    if step is None:
        if not steps:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
        step = steps[-1]
    path = os.path.join(ckpt_dir, str(step))
    meta = dcp.FileSystemReader(path).read_metadata().state_dict_metadata
    target = {k: torch.empty(tuple(m.size), dtype=m.properties.dtype)
              if isinstance(m, TensorStorageMetadata) else "" for k, m in meta.items()}
    dcp.load(target, checkpoint_id=path)
    for name in ("embedder", "extractor", "discriminator"):
        mod = getattr(state, name)
        mod.load_state_dict(_check_and_cast(
            {k[len(name) + 1:]: v for k, v in target.items() if k.startswith(name + ".")},
            mod, name))
    for name in ("opt_g", "opt_d"):
        opt_state: dict = {}
        head = f"{name}.state."
        for k, v in target.items():
            if k.startswith(head):
                idx, leaf = k[len(head):].split(".", 1)
                opt_state.setdefault(int(idx), {})[leaf] = v
        _resume_optimizer(getattr(state, name), opt_state,
                          json.loads(target[f"{name}.param_groups"]))
    if state.sched_g is not None:
        _resume_schedule(state.sched_g, json.loads(target["sched_g"])["last_epoch"])
    state.step = int(target["step"])
    state.scaling_w = float(target["scaling_w"])
    return int(step)
