"""Shared set-up for the port's parity tests (tests/test_torch_*.py).

Builds a tiny card in both packages with the same weights: the JAX model is
initialised from a seed, its BatchNorm statistics and GRN parameters are
randomised with numpy (their init values would hide bugs), and the port gets
the weights through ``videoseal_tpu_torch.utils.convert.from_jax_variables``.
"""

from __future__ import annotations

import copy
import json

import numpy as np
import torch

NBITS = 16
# detector logits: every ConvNeXt block of the port goes through K2, which
# rounds to bf16 inside as the TPU kernel does, while the JAX extractor on the
# CPU is the all-f32 linen module; the planar fused detect input also differs
# by bf16 rounding of the downscale
LOGIT_ATOL = 3e-2


def tiny_card(img_size: int = 128, step: int = 2, chunk: int = 4, out_channels: int = 1,
              blending: str = "additive", video_mode: str = "repeat") -> dict:
    """The tiny card of tests/test_e2e_golden.py, at a given processing size.
    out_channels=3 makes an RGB-in, RGB-out embedder (chunkyseal's layout)."""
    yuv = out_channels == 1
    return {
        "args": {"attenuation": "jnd_1_1", "nbits": NBITS,
                 "hidden_size_multiplier": 2, "img_size_proc": img_size,
                 "blending_method": blending, "scaling_w": 0.2,
                 "scaling_i": 1.0, "videoseal_chunk_size": chunk,
                 "videoseal_step_size": step, "video_mode": video_mode},
        "embedder": {"model": "unet_tiny_yuv" if yuv else "unet_tiny", "params": {
            "msg_processor": {"msg_processor_type": "binary+concat"},
            "unet": {"in_channels": 1 if yuv else 3, "out_channels": out_channels,
                     "z_channels": 4,
                     "num_blocks": 1, "activation": "relu",
                     "normalization": "batch", "z_channels_mults": [1, 2],
                     "last_tanh": True}}},
        "extractor": {"model": "convnext_tiny", "params": {
            "encoder": {"depths": [1, 1, 1, 1], "dims": [8, 16, 32, 64]},
            "pixel_decoder": {"pixelwise": False, "upscale_stages": [1],
                              "embed_dim": 64, "sigmoid_output": False}}},
    }


def tiny_card_v0(img_size: int = 64, step: int = 2, chunk: int = 4) -> dict:
    """videoseal_0.0's layout at narrow widths: an RGB unet_small2 with SiLU
    and RMS norms, the SAM ViT extractor (depth 2, embed_dim 48, 2 heads,
    window 4, global attention at block 1), no JND, scaling_w 1."""
    return {
        "args": {"attenuation": None, "nbits": NBITS, "hidden_size_multiplier": 2,
                 "img_size_proc": img_size, "blending_method": "additive",
                 "scaling_w": 1.0, "scaling_i": 1.0, "videoseal_chunk_size": chunk,
                 "videoseal_step_size": step, "video_mode": "repeat"},
        "embedder": {"model": "unet_small2", "params": {
            "msg_processor": {"msg_processor_type": "binary+concat"},
            "unet": {"in_channels": 3, "out_channels": 3, "z_channels": 4, "num_blocks": 1,
                     "activation": "silu", "normalization": "rms",
                     "z_channels_mults": [1, 2], "last_tanh": True}}},
        "extractor": {"model": "sam_small", "params": {
            "encoder": {"embed_dim": 48, "out_chans": 48, "depth": 2, "num_heads": 2,
                        "patch_size": 16, "global_attn_indexes": [1], "window_size": 4,
                        "mlp_ratio": 4, "qkv_bias": True, "use_rel_pos": True},
            "pixel_decoder": {"pixelwise": False, "upscale_stages": [1], "embed_dim": 48,
                              "sigmoid_output": False, "upscale_type": "bilinear"}}},
    }


def tiny_preset_card(img_size: int = 64, step: int = 2) -> tuple[dict, dict]:
    """(card, training args) of the smallest presets a checkpoint's args can
    name (unet_tiny_yuv_quant, convnext_tiny), as
    ``utils.cfg.get_config_from_checkpoint`` rebuilds them from the args."""
    from videoseal_tpu_torch import presets

    args = {"embedder_model": "unet_tiny_yuv_quant", "extractor_model": "convnext_tiny",
            "nbits": NBITS, "img_size_proc": img_size, "attenuation": "jnd_1_1",
            "scaling_w": 0.2, "videoseal_step_size": step}
    card = {"args": dict(args, hidden_size_multiplier=2),
            "embedder": {"model": "unet_tiny_yuv_quant",
                         "params": copy.deepcopy(presets.EMBEDDER["unet_tiny_yuv_quant"])},
            "extractor": {"model": "convnext_tiny",
                          "params": copy.deepcopy(presets.EXTRACTOR["convnext_tiny"])}}
    return card, args


def _randomize(tree, rng, path=""):
    """Numpy copy of a variables tree with BN stats/affine, GRN, RMS norm
    gains and the ViT's position tables randomised."""
    out = {}
    for k, v in tree.items():
        p = f"{path}/{k}"
        if isinstance(v, dict) or hasattr(v, "items"):
            out[k] = _randomize(dict(v), rng, p)
            continue
        a = np.asarray(v, np.float32).copy()
        if (p.endswith("/bn/mean") or "/grn/" in p or p.endswith("/bn/bias")
                or "/rel_pos_" in p or p.endswith("/pos_embed")):
            a = rng.normal(0.0, 0.1, a.shape).astype(np.float32)
        elif p.endswith("/bn/var") or p.endswith("/bn/scale") or p.endswith("/rms/gamma"):
            a = rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        out[k] = a
    return out


def jax_model(card: dict, seed: int = 0):
    """JAX VideoSeal for `card` with randomised BN/GRN variables (jitted
    init: eager linen init of the two modules takes ~30 s on the CPU)."""
    import jax
    import jax.numpy as jnp
    from videoseal_tpu.models.embedder import build_embedder
    from videoseal_tpu.models.extractor import build_extractor
    from videoseal_tpu.models.videoseal import PipelineConfig, VideoSeal
    from videoseal_tpu.modules.jnd import build_attenuation

    a, e, x = card["args"], card["embedder"], card["extractor"]
    s = a["img_size_proc"]
    emb = build_embedder(e["model"], e["params"], a["nbits"], a["hidden_size_multiplier"])
    ext = build_extractor(x["model"], x["params"], s, a["nbits"])
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    evars = jax.jit(emb.module.init)(k1, jnp.zeros((1, s, s, 1 if emb.yuv else 3)),
                                     jnp.zeros((1, a["nbits"]), jnp.int32))
    xvars = jax.jit(ext.module.init)(k2, jnp.zeros((1, s, s, 3)))
    cfg = PipelineConfig(img_size=s, blending_method=a["blending_method"],
                         chunk_size=a["videoseal_chunk_size"],
                         step_size=a["videoseal_step_size"], video_mode=a["video_mode"],
                         yuv=emb.yuv, nbits=a["nbits"])
    rng = np.random.default_rng(seed + 100)
    return VideoSeal(emb, ext, _randomize(evars, rng), _randomize(xvars, rng),
                     build_attenuation(a["attenuation"]), cfg,
                     scaling_w=a["scaling_w"], scaling_i=a["scaling_i"], card=card)


def port_model(card: dict, jm):
    """Port VideoSeal for `card` holding the weights of JAX model `jm`."""
    from videoseal_tpu_torch import VideoSeal
    from videoseal_tpu_torch.utils.convert import from_jax_variables

    model = VideoSeal.from_card(copy.deepcopy(card), device="cpu")
    emb, ext = from_jax_variables(jm.embedder_vars, jm.extractor_vars)
    model.embedder.load_state_dict(emb)
    model.extractor.load_state_dict(ext)
    return model


def to_np(t) -> np.ndarray:
    return t.detach().float().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


# -- the training tests' tiny modules (test_torch_train, _dist, _optim) --------------

TRAIN_NBITS, TRAIN_SIZE = 8, 64
TRAIN_EMB_CFG = {"msg_processor": {"msg_processor_type": "binary+concat"},
                 "unet": {"in_channels": 1, "out_channels": 1, "z_channels": 4,
                          "num_blocks": 1, "activation": "relu", "normalization": "batch",
                          "z_channels_mults": [1, 2], "last_tanh": True}}
TRAIN_EXT_CFG = {"encoder": {"depths": [1, 1, 1, 1], "dims": [8, 16, 32, 64]},
                 "pixel_decoder": {"pixelwise": False, "upscale_stages": [1],
                                   "embed_dim": 64, "sigmoid_output": False}}


def train_weights(nbits: int = TRAIN_NBITS, size: int = TRAIN_SIZE):
    """(embedder, extractor, discriminator) JAX variables as numpy: the
    port's seeded init carried over by the weight bridge, BatchNorm
    statistics and GRN randomised (a JAX init would compile for ~15 s)."""
    from videoseal_tpu_torch.models.embedder import build_embedder
    from videoseal_tpu_torch.models.extractor import build_extractor
    from videoseal_tpu_torch.models.videoseal import init_weights
    from videoseal_tpu_torch.modules.discriminator import NLayerDiscriminator
    from videoseal_tpu_torch.utils.convert import disc_to_jax, to_jax_variables
    emb = build_embedder("unet_tiny_yuv", TRAIN_EMB_CFG, nbits, 2).module
    ext = build_extractor("convnext_tiny", TRAIN_EXT_CFG, size, nbits).module
    disc = NLayerDiscriminator(ndf=8, n_layers=2)
    gen = torch.Generator().manual_seed(0)
    for m in (emb, ext, disc):
        init_weights(m, gen)
    ev, xv = to_jax_variables(emb.state_dict(), ext.state_dict())
    rng = np.random.default_rng(5)
    return _randomize(ev, rng), _randomize(xv, rng), disc_to_jax(disc.state_dict())


def port_train_mods(weights, balanced: bool, opt: str = "SGD,lr=1.0", mesh=None,
                    augmenter=None, nbits: int = TRAIN_NBITS, size: int = TRAIN_SIZE,
                    video_mode: str = "repeat", conv_layer: str = "conv2d",
                    dtype: torch.dtype = torch.float32, loss=None, schedule=None,
                    scaling_w: float = 0.2):
    """(TrainerModules, TrainState) of the port at the tiny training card
    holding `weights`, the dummy augmenter unless one is given. With
    `conv_layer` "conv2p1d" the UNet's convolutions mix frames: its weights
    are the port's seeded init, the temporal convolutions' too. The modules
    take `dtype`; `loss` (a VideoSealLoss) replaces the default one,
    `schedule` drives the generator's lr, `scaling_w` starts the state."""
    from videoseal_tpu_torch.augmentation.augmenter import get_dummy_augmenter
    from videoseal_tpu_torch.losses.videosealloss import VideoSealLoss
    from videoseal_tpu_torch.models.embedder import build_embedder
    from videoseal_tpu_torch.models.extractor import build_extractor
    from videoseal_tpu_torch.models.videoseal import PipelineConfig
    from videoseal_tpu_torch.modules.discriminator import NLayerDiscriminator
    from videoseal_tpu_torch.modules.jnd import JND
    from videoseal_tpu_torch.parallel.trainer import TrainerModules, create_train_state
    from videoseal_tpu_torch.utils.convert import disc_from_jax, from_jax_variables

    emb_cfg = copy.deepcopy(TRAIN_EMB_CFG)
    emb_cfg["unet"]["conv_layer"] = conv_layer
    emb = build_embedder("unet_tiny_yuv", emb_cfg, nbits, 2).module
    ext = build_extractor("convnext_tiny", TRAIN_EXT_CFG, size, nbits).module
    disc = NLayerDiscriminator(ndf=8, n_layers=2)
    esd, xsd = from_jax_variables(weights[0], weights[1])
    if conv_layer == "conv2d":
        emb.load_state_dict(esd)
    else:
        from videoseal_tpu_torch.models.videoseal import init_weights
        init_weights(emb, torch.Generator().manual_seed(0))
    ext.load_state_dict(xsd)
    disc.load_state_dict(disc_from_jax(weights[2]))
    for m in (emb, ext, disc):
        m.to(dtype)
    mods = TrainerModules(
        embedder=emb, extractor=ext, discriminator=disc,
        augmenter=augmenter or get_dummy_augmenter(), attenuation=JND(),
        cfg=PipelineConfig(img_size=size, chunk_size=4, step_size=2, yuv=True, nbits=nbits,
                           video_mode=video_mode),
        loss=loss or VideoSealLoss(balanced=balanced, total_norm=1.0, percep_loss="yuv",
                                   decode_weight=1.0, detect_weight=0.0),
        balanced=balanced, mesh=mesh)
    return mods, create_train_state(mods, opt, opt, scaling_w=scaling_w, schedule=schedule)


def step_record(state, logs) -> dict:
    """What a step left: its logs, each parameter's gradient and new value
    (named "<0 embedder | 1 extractor | 2 discriminator>.<name>") and the
    embedder's BatchNorm statistics, all on the CPU."""
    mods = (state.embedder, state.extractor, state.discriminator)
    named = [(f"{i}.{n}", p) for i, m in enumerate(mods) for n, p in m.named_parameters()]
    return {"logs": {k: float(v) for k, v in logs.items()},
            "grads": {k: p.grad.detach().cpu().clone() for k, p in named if p.grad is not None},
            "params": {k: p.detach().cpu().clone() for k, p in named},
            "bn": {n: b.detach().cpu().clone() for n, b in state.embedder.named_buffers()
                   if n.endswith(("running_mean", "running_var"))}}


def rank_train_steps(rank, weights, cases):
    """Run on each rank of a process group (``parallel.launch.run_local``):
    for each case (imgs, msgs, balanced, is_video, augs config or None,
    generator seed), one SGD step at lr 1 on the rank's rows of the global
    batch `imgs`, the modules in the images' dtype; msgs (the global
    batch's) injected where given."""
    from videoseal_tpu_torch.augmentation.augmenter import build_augmenter
    from videoseal_tpu_torch.parallel.mesh import make_mesh, shard_batch
    from videoseal_tpu_torch.parallel.trainer import make_train_step
    torch.set_num_threads(1)
    mesh = make_mesh()
    out = []
    for imgs, msgs, balanced, is_video, augs, seed in cases:
        aug = build_augmenter(augs, num_augs=2) if augs else None
        mods, state = port_train_mods(weights, balanced, mesh=mesh, augmenter=aug,
                                      dtype=torch.from_numpy(imgs[:0]).dtype)
        step = make_train_step(mods, is_video=is_video)
        _, logs = step(state, {"imgs": shard_batch(mesh, torch.from_numpy(imgs))},
                       torch.Generator().manual_seed(seed),
                       msgs=None if msgs is None else torch.from_numpy(msgs))
        out.append(step_record(state, logs))
    return out


def rank_counted_step(rank, weights, imgs):
    """One balanced image step at SGD lr 1 on a process group of one rank:
    its record, the all-reduces the step made, and whether every BatchNorm
    took the group."""
    import torch.distributed as dist

    from videoseal_tpu_torch.modules.common import BatchNorm2d
    from videoseal_tpu_torch.parallel.mesh import make_mesh
    from videoseal_tpu_torch.parallel.trainer import make_train_step
    torch.set_num_threads(1)
    mods, state = port_train_mods(weights, True, mesh=make_mesh())
    bns = [m for m in state.embedder.modules() if isinstance(m, BatchNorm2d)]
    calls, all_reduce = [], dist.all_reduce

    def counted(*args, **kwargs):
        calls.append(1)
        return all_reduce(*args, **kwargs)

    dist.all_reduce = counted
    try:
        _, logs = make_train_step(mods)(state, {"imgs": torch.from_numpy(imgs)},
                                        torch.Generator().manual_seed(1))
    finally:
        dist.all_reduce = all_reduce
    return {"record": step_record(state, logs), "all_reduces": len(calls),
            "bn_layers": len(bns), "bn_grouped": all(m.group is not None for m in bns)}


def rank_frames_steps(rank, n_data, n_frames, cases):
    """Run on each rank of an n_data x n_frames mesh: its facts, then for
    each case (weights, imgs (V, F, H, W, 3), msgs or None, balanced,
    video_mode, conv_layer, augs config or None, generator seed, nbits,
    size) one SGD step at lr 1 on the rank's block of the clips, the
    modules in the images' dtype."""
    from videoseal_tpu_torch.augmentation.augmenter import build_augmenter
    from videoseal_tpu_torch.parallel.mesh import gather_frames, make_mesh, shard_batch
    from videoseal_tpu_torch.parallel.trainer import make_train_step
    torch.set_num_threads(1)
    mesh = make_mesh(n_data, n_frames)
    clips = torch.arange(n_data * 4 * n_frames * 2, dtype=torch.float32).reshape(
        n_data, 4 * n_frames, 2)
    facts = {"axes": (mesh.rank, mesh.size, mesh.frames_rank, mesh.frames_size, mesh.world),
             "clip": gather_frames(shard_batch(mesh, clips, frames_axis=1), mesh),
             "want": clips[mesh.shard(n_data)]}
    out = []
    for weights, imgs, msgs, balanced, mode, conv, augs, seed, nbits, size in cases:
        aug = build_augmenter(augs, num_augs=2) if augs else None
        mods, state = port_train_mods(weights, balanced, mesh=mesh, augmenter=aug, nbits=nbits,
                                      size=size, video_mode=mode, conv_layer=conv,
                                      dtype=torch.from_numpy(imgs[:0]).dtype)
        step = make_train_step(mods, is_video=True)
        _, logs = step(state, {"imgs": shard_batch(mesh, torch.from_numpy(imgs), frames_axis=1)},
                       torch.Generator().manual_seed(seed),
                       msgs=None if msgs is None else torch.from_numpy(msgs))
        out.append(step_record(state, logs))
    return facts, out


def rank_collectives(rank, x, tmp):
    """The BatchNorm, gather, metric and checkpoint collectives on a rank."""
    import torch.nn.functional as F

    from videoseal_tpu_torch.modules.common import BatchNorm2d
    from videoseal_tpu_torch.parallel.mesh import make_mesh, shard_batch
    from videoseal_tpu_torch.utils import checkpoint as ckpt_io
    from videoseal_tpu_torch.utils.dist import average_metrics, gather_rows
    from videoseal_tpu_torch.utils.logger import MetricLogger
    mesh = make_mesh()
    bn = BatchNorm2d(x.shape[1])
    bn.group = mesh.group
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5, generator=torch.Generator().manual_seed(0))
        bn.bias.normal_(generator=torch.Generator().manual_seed(1))
    xl = shard_batch(mesh, torch.from_numpy(x)).requires_grad_(True)
    y = bn(xl)
    w = torch.linspace(-1, 1, y.numel()).view(y.shape[::-1]).permute(3, 2, 1, 0) + rank
    F.relu(y * w).sum().backward()
    g = gather_rows(xl * 2.0, mesh.rows(xl.shape[0]), xl.shape[0] * mesh.world, mesh.group)
    logger = MetricLogger()
    logger.update(a=float(rank), b=1.0)
    logger.sync()
    res = {"y": y.detach(), "dx": xl.grad, "dw": bn.weight.grad, "db": bn.bias.grad,
           "running": (bn.running_mean.clone(), bn.running_var.clone()),
           "gathered": g.detach(), "avg": average_metrics({"m": rank + 1.0}),
           "meters": {k: (m.total, m.count) for k, m in logger.meters.items()}}
    _, state = port_train_mods(train_weights(), False, opt="AdamW,lr=1e-3", mesh=mesh)
    for p in state.embedder.parameters():
        p.grad = torch.ones_like(p)
    state.opt_g.step()
    state.step = 7
    ckpt_io.save_train_state_sharded(tmp, state)
    _, fresh = port_train_mods(train_weights(), False, opt="AdamW,lr=1e-3", mesh=mesh)
    res["loaded_step"] = ckpt_io.load_train_state_sharded(tmp, fresh)
    res["same"] = same_state(state, fresh)
    return res


def same_state(a, b) -> bool:
    for m in ("embedder", "extractor", "discriminator"):
        sa, sb = getattr(a, m).state_dict(), getattr(b, m).state_dict()
        if sa.keys() != sb.keys() or not all(torch.equal(sa[k], sb[k]) for k in sa):
            return False
    oa, ob = a.opt_g.state_dict(), b.opt_g.state_dict()
    groups = [json.loads(json.dumps(o["param_groups"])) for o in (oa, ob)]   # tuples as lists
    return (groups[0] == groups[1] and oa["state"].keys() == ob["state"].keys()
            and all(torch.equal(oa["state"][i][k], ob["state"][i][k])
                    for i in oa["state"] for k in oa["state"][i])
            and a.step == b.step and a.scaling_w == b.scaling_w)


def rank_train_main(rank, out):
    """train.main --distributed 1 on a rank: 2 steps with a sharded
    checkpoint, then 1 step resumed from it."""
    import os

    from videoseal_tpu_torch import train
    common = ["--device", "cpu", "--tiny", "1", "--img_size", "64", "--distributed", "1",
              "--synthetic", "1", "--batch_size", "4", "--eval_freq", "1", "--eval_samples",
              "2", "--eval_augs", "identity", "--iter_per_epoch", "2", "--ckpt_format", "orbax",
              "--output_dir", out]
    torch.set_num_threads(1)
    state, _, step_ms = train.main(common + ["--steps", "2"])
    saved = {k: v.clone() for k, v in state.embedder.state_dict().items()}
    resumed, _, _ = train.main(common + ["--steps", "1", "--resume", os.path.join(out, "ckpts")])
    return {"step": state.step, "n_ms": len(step_ms), "saved": saved, "resumed": resumed.step}


# -- the preset and temporal tests' JAX oracles (test_torch_presets, _temporal) --------

def random_tree(shapes, seed: int):
    """Numpy variables for a tree of shapes (``jax.eval_shape`` of an init:
    no init is compiled): kernels N(0, 1/fan_in), norm gains and BatchNorm
    variances U(0.5, 1.5), everything else N(0, 0.1) (the message tables
    N(0, 0.5))."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        p = "/".join(str(getattr(k, "key", k)) for k in path)
        shape = tuple(s.shape)
        if p.endswith("kernel"):
            return rng.normal(0, float(np.prod(shape[:-1])) ** -0.5, shape).astype(np.float32)
        if (p.endswith(("/var", "/scale", "rms/gamma")) or p.endswith("/weight")):
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        return rng.normal(0, 0.5 if "msg_embeddings" in p else 0.1, shape).astype(np.float32)

    import jax
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def jax_random_vars(module, *args, seed: int = 0):
    """Random numpy variables of a linen `module` applied to `args`."""
    import jax
    return random_tree(jax.eval_shape(module.init, jax.random.PRNGKey(0), *args), seed)


def jax_model_random(card: dict, seed: int = 0):
    """JAX VideoSeal for `card` with `random_tree` variables: `jax_model`
    without the init compiles."""
    import jax.numpy as jnp
    from videoseal_tpu.models.embedder import build_embedder
    from videoseal_tpu.models.extractor import build_extractor
    from videoseal_tpu.models.videoseal import PipelineConfig, VideoSeal
    from videoseal_tpu.modules.jnd import build_attenuation

    a, e, x = card["args"], card["embedder"], card["extractor"]
    s = a["img_size_proc"]
    emb = build_embedder(e["model"], e["params"], a["nbits"], a["hidden_size_multiplier"])
    ext = build_extractor(x["model"], x["params"], s, a["nbits"])
    evars = jax_random_vars(emb.module, jnp.zeros((1, s, s, 1 if emb.yuv else 3)),
                            jnp.zeros((1, a["nbits"]), jnp.int32), seed=seed)
    xvars = jax_random_vars(ext.module, jnp.zeros((1, s, s, 3)), seed=seed + 1)
    cfg = PipelineConfig(img_size=s, blending_method=a["blending_method"],
                         chunk_size=a["videoseal_chunk_size"],
                         step_size=a["videoseal_step_size"], video_mode=a["video_mode"],
                         yuv=emb.yuv, nbits=a["nbits"])
    return VideoSeal(emb, ext, evars, xvars, build_attenuation(a["attenuation"]), cfg,
                     scaling_w=a["scaling_w"], scaling_i=a["scaling_i"], card=card)
