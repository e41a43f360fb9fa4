"""The GAN training step, counterpart of ``videoseal_tpu/parallel/trainer.py``.

One call does what the reference's loop does per iteration: embed (train
mode: the BatchNorm statistics update) -> video-mode expand -> resize, blend,
attenuate (JND after the blend), clamp -> mask composite and sampled attack
-> resize -> detect -> generator losses (the adaptive balance takes each
loss's gradient norm with respect to the embedder's output, one
``torch.autograd.grad`` a loss, as the JAX step takes one ``jax.vjp`` a
loss) -> one backward and the generator's optimizer step -> the
discriminator's step on the real images and the detached watermarked ones.

The step differentiates the modules, not the kernels: with grad enabled the
extractor takes its differentiable route (``modules/convnext.py``), as the
JAX step applies the linen modules. It runs in float32, without autocast.
Video batches are (V, F, H, W, 3) with one message per clip.

Parallelism (``mods.mesh``, a ``parallel.mesh.Mesh`` with a process
group): each rank steps on its block of the global batch (its clips by data
rank and, on a frames axis, its frames of each clip by frames rank; equal
blocks) and the step gives JAX's global-batch result. The messages and every
augmenter draw are made for the global batch from the same generator state
on every rank and sliced; the key frames are every step_size-th frame of
the clip by global index (a rank's frame count need not be a multiple of
step_size), their predictions gathered over the frames axis, expanded by
video_mode over the clip and sliced back; a module that mixes frames runs
on the gathered batch (``modules/common.apply_whole_batch``); BatchNorm
normalises with the global batch's statistics
(``modules/common.BatchNorm2d``); the balance's per-loss gradient norms are
the square root of the ranks' summed squares (the local losses are means
over a rank's rows, so each rank's gradient is the world size times its
part of the global one); the gradients are averaged over every rank by one
all-reduce per optimizer, explicitly rather than with
``DistributedDataParallel``, whose reducer fires on every backward and
expects one per forward, where this step takes a gradient per loss and
runs the discriminator under a functional call; the logs are averaged.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..losses.videosealloss import VideoSealLoss
from ..models.blender import blend
from ..models.videoseal import PipelineConfig, _expand_video_mode
from ..modules.common import apply_whole_batch
from ..modules.jnd import JND
from ..ops.color import rgb_to_y
from ..ops.metrics import bit_accuracy, psnr
from ..ops.resize import resize_bilinear
from ..utils.optim import build_optimizer, lr_scheduler


@dataclasses.dataclass
class TrainState:
    """The modules (the embedder's BatchNorm statistics are its buffers),
    their optimizers, the generator's lr schedule (or None), the step and
    the schedulable blend strength."""
    step: int
    embedder: nn.Module
    extractor: nn.Module
    discriminator: nn.Module
    opt_g: torch.optim.Optimizer
    opt_d: torch.optim.Optimizer
    sched_g: Any
    scaling_w: float


@dataclasses.dataclass(frozen=True)
class TrainerModules:
    """What the step closes over: the three modules, the train-path
    augmenter, the attenuation, the pipeline settings and the losses."""
    embedder: nn.Module
    extractor: nn.Module
    discriminator: nn.Module
    augmenter: Any               # augmentation.Augmenter
    attenuation: JND | None
    cfg: PipelineConfig
    loss: VideoSealLoss
    scaling_i: float = 1.0
    temperature: float = 1.0
    balanced: bool = True
    mesh: Any = None             # parallel.mesh.Mesh, or None for one process


def create_train_state(mods: TrainerModules, optimizer_g: str, optimizer_d: str,
                       scaling_w: float = 0.2, schedule: Callable[[int], float] | None = None
                       ) -> TrainState:
    """Optimizers over mods' modules, as they stand (built, initialised and
    on their device): the generator's over the embedder's and then the
    extractor's parameters, the discriminator's over its own; `schedule`
    (a per-step lr function) drives the generator's under a LambdaLR.
    With a process group (mods.mesh) the BatchNorms take the group of every
    rank and every rank starts from rank 0's parameters and buffers."""
    if mods.mesh is not None and mods.mesh.all_group is not None:
        from .mesh import use_global_batchnorm
        for m in (mods.embedder, mods.extractor, mods.discriminator):
            use_global_batchnorm(m, mods.mesh)
            for t in m.state_dict().values():
                dist.broadcast(t, src=0, group=mods.mesh.all_group)
    gen_params = list(mods.embedder.parameters()) + list(mods.extractor.parameters())
    opt_g = build_optimizer(optimizer_g, gen_params)
    opt_d = build_optimizer(optimizer_d, mods.discriminator.parameters())
    return TrainState(step=0, embedder=mods.embedder.train(), extractor=mods.extractor.train(),
                      discriminator=mods.discriminator.train(), opt_g=opt_g, opt_d=opt_d,
                      sched_g=lr_scheduler(opt_g, schedule) if schedule is not None else None,
                      scaling_w=float(scaling_w))


def key_frames(frames: int, step: int, frames_rank: int = 0) -> tuple[int, int]:
    """The global key indices [lo, hi) that a frames rank holding frames
    [frames_rank * frames, (frames_rank + 1) * frames) of its clips embeds:
    key k is the clip's frame k * step."""
    first = frames_rank * frames
    return -(-first // step), -(-(first + frames) // step)


def embed_batch(mods: TrainerModules, embedder: nn.Module, imgs: torch.Tensor,
                msgs: torch.Tensor, is_video: bool, mesh=None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(preds_w at the processing size for every frame (N, s, s, C), the
    messages of every frame (N, nbits)): images embed each; clips embed
    their key frames (every step_size-th of the clip) with the clip's
    message, and the key predictions spread over the clip by video_mode.
    On a frames axis (`mesh`) imgs holds this rank's frames of its clips:
    it embeds the keys among them, and the clip's keys, gathered from its
    frames ranks, expand to the whole clip, of which its frames come back."""
    cfg = mods.cfg
    s, step = cfg.img_size, cfg.step_size
    on_mesh = mesh is not None and mesh.world > 1
    if not is_video:
        imgs_res = resize_bilinear(imgs, s, s)
        inp = rgb_to_y(imgs_res) if cfg.yuv else imgs_res
        if not on_mesh:
            return embedder(inp, msgs), msgs
        b = imgs.shape[0]
        return apply_whole_batch(embedder, mesh, mesh.rows(b), b * mesh.world, inp, msgs), msgs
    v, f = imgs.shape[0], imgs.shape[1]
    nf, fr = (mesh.frames_size, mesh.frames_rank) if on_mesh else (1, 0)
    lo, hi = key_frames(f, step, fr)
    if hi == lo:
        raise ValueError(f"frames rank {fr} holds frames {fr * f}..{fr * f + f - 1}: no key "
                         f"frame of step_size {step}")
    n_keys, k = -(-f * nf // step), hi - lo
    res = resize_bilinear(imgs.reshape((v * f,) + tuple(imgs.shape[2:])), s, s)
    keys_in = res.reshape(v, f, s, s, 3)[:, lo * step - fr * f::step]
    keys_flat = keys_in.reshape(v * k, s, s, 3)
    inp, key_msgs = rgb_to_y(keys_flat) if cfg.yuv else keys_flat, msgs.repeat_interleave(k, 0)
    if on_mesh:
        # the global batch of keys is (clips, n_keys); this rank's are [lo, hi)
        rows = (torch.arange(mesh.rank * v, (mesh.rank + 1) * v)[:, None] * n_keys
                + torch.arange(lo, hi)[None]).reshape(-1)
        preds_k = apply_whole_batch(embedder, mesh, rows, v * mesh.size * n_keys, inp, key_msgs)
    else:
        preds_k = embedder(inp, key_msgs)
    preds_k = preds_k.reshape((v, k) + tuple(preds_k.shape[1:]))
    if on_mesh:
        from .mesh import gather_frames
        preds_k = gather_frames(preds_k, mesh, lo, n_keys)
    preds_w = torch.stack([_expand_video_mode(p, f * nf, step, cfg.video_mode)
                           for p in preds_k])[:, fr * f:(fr + 1) * f]
    return preds_w.reshape((v * f,) + tuple(preds_w.shape[2:])), msgs.repeat_interleave(f, dim=0)


def watermark(mods: TrainerModules, imgs_flat: torch.Tensor, preds_w: torch.Tensor,
              scaling_w: float) -> torch.Tensor:
    """The full-resolution watermarked frames: resize, blend, JND after the
    blend, clamp."""
    h, w = imgs_flat.shape[-3], imgs_flat.shape[-2]
    imgs_w = blend(mods.cfg.blending_method, imgs_flat, resize_bilinear(preds_w, h, w),
                   mods.scaling_i, scaling_w)
    if mods.attenuation is not None:
        imgs_w = mods.attenuation(imgs_flat, imgs_w)
    return torch.clamp(imgs_w, 0.0, 1.0) if mods.cfg.clamp else imgs_w


def _frozen(module: nn.Module) -> Callable:
    """module's forward on detached parameters: a loss through it reaches
    its input, never its parameters."""
    params = {n: p.detach() for n, p in module.named_parameters()}
    return lambda x: torch.func.functional_call(module, params, (x,))


def _average_grads(params, mesh) -> None:
    """Each gradient replaced by its mean over every rank: one all-reduce
    of the gradients laid end to end."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=mesh.all_group)
    flat /= mesh.world
    for g, v in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(v.view_as(g))


def _average_logs(logs: dict, mesh) -> dict:
    keys = [k for k, v in logs.items() if isinstance(v, torch.Tensor)]
    vec = torch.stack([logs[k].detach().float().reshape(()) for k in keys])
    dist.all_reduce(vec, group=mesh.all_group)
    return {**logs, **dict(zip(keys, (vec / mesh.world).unbind()))}


def make_train_step(mods: TrainerModules, is_video: bool = False, mode: str = "both") -> Callable:
    """The step: train_step(state, batch, generator, msgs=None) -> (state,
    logs), updating state in place. batch: {"imgs": (B, H, W, 3) or (V, F,
    H, W, 3) float in [0, 1], "masks": the imgs' [..., :1] shape or absent}
    on the modules' device. The messages (one per image or clip) and the
    augmenter's draws come from `generator`, on that device; `msgs` injects
    the messages instead. mode: "both" (the reference's default), "gen" or
    "disc" (the sleepwake alternation). After the step each parameter's
    .grad holds the gradient its optimizer took (None where none did).
    On a mesh (mods.mesh) the batch is this rank's block (``shard_batch``;
    a video batch's frames on axis 1 where the mesh has a frames axis) and
    `msgs`, when given, the global batch's."""
    if mode not in ("both", "gen", "disc"):
        raise ValueError(f"mode must be both, gen or disc, got {mode!r}")
    cfg, loss_cfg = mods.cfg, mods.loss
    s = cfg.img_size
    # the collectives run wherever there is a process group, one rank too;
    # the gathers only where a rank holds part of the batch
    mesh = mods.mesh if mods.mesh is not None and mods.mesh.all_group is not None else None
    size = mesh.size if mesh is not None else 1
    if mesh is not None and mesh.frames_size > 1 and not is_video:
        raise ValueError("an image batch has no frames to shard: make_mesh(n_frames=1)")
    gen_params = lambda st: list(st.embedder.parameters()) + list(st.extractor.parameters())

    def train_step(state: TrainState, batch: dict, generator: torch.Generator,
                   msgs: torch.Tensor | None = None):
        imgs = batch["imgs"]
        masks = batch.get("masks")
        if msgs is None:
            msgs = torch.randint(0, 2, (imgs.shape[0] * size, cfg.nbits), generator=generator,
                                 device=generator.device)
        if mesh is not None:
            msgs = msgs[mesh.shard(imgs.shape[0] * size)]
        msgs = msgs.to(imgs.device)
        imgs_flat = imgs.reshape((-1,) + tuple(imgs.shape[-3:]))
        masks_flat = (masks.reshape((-1,) + tuple(masks.shape[-3:]))
                      if masks is not None else None)
        state.embedder.train()
        state.extractor.train()
        state.opt_g.zero_grad(set_to_none=True)
        state.opt_d.zero_grad(set_to_none=True)

        # the forward runs with grad in every mode, so that the extractor
        # takes the modules' route (no kernel), as the JAX step's does
        preds_w, msgs_frames = embed_batch(mods, state.embedder, imgs, msgs, is_video, mesh)
        imgs_w = watermark(mods, imgs_flat, preds_w, state.scaling_w)
        frames = imgs.shape[1] if is_video else 1
        imgs_aug, mask_t, _ = mods.augmenter(generator, imgs_w, imgs_flat, masks_flat,
                                             is_video=is_video, train=True, mesh=mesh,
                                             frames=frames)
        x = resize_bilinear(imgs_aug, s, s)
        if mesh is not None:
            rows = mesh.rows(imgs.shape[0], frames)
            preds = apply_whole_batch(state.extractor, mesh, rows, len(rows) * mesh.world, x)
        else:
            preds = state.extractor(x)
        preds = preds / mods.temperature
        if preds.dim() == 4 and tuple(preds.shape[1:3]) != tuple(mask_t.shape[1:3]):
            # a pixelwise map on a coarser grid than the frames (convnext_tiny_pw:
            # 32x down, 16x up) is held to the mask's share of each of its pixels
            mask_t = F.interpolate(mask_t.permute(0, 3, 1, 2), size=tuple(preds.shape[1:3]),
                                   mode="area").permute(0, 2, 3, 1)
        losses, weights = loss_cfg.generator_losses(
            imgs_flat, imgs_w, mask_t, msgs_frames, preds, _frozen(state.discriminator),
            state.step)

        if mode in ("both", "gen"):
            grad_norms = None
            if mods.balanced and len(losses) > 1:
                sq = []
                for v in losses.values():
                    (g,) = torch.autograd.grad(v, preds_w, retain_graph=True, allow_unused=True)
                    # in float32 (float64 in a float64 step)
                    sq.append(torch.sum(g.to(torch.promote_types(g.dtype, torch.float32)) ** 2)
                              .detach() if g is not None else torch.zeros((), device=v.device))
                sq = torch.stack(sq)
                if mesh is not None:
                    dist.all_reduce(sq, group=mesh.all_group)
                world = mesh.world if mesh is not None else 1
                grad_norms = dict(zip(losses, (torch.sqrt(sq) / world).unbind()))
            total, logs = loss_cfg.combine(losses, weights, grad_norms)
            total.backward()
            if mesh is not None:
                _average_grads(gen_params(state), mesh)
            state.opt_g.step()
            if state.sched_g is not None:
                state.sched_g.step()
        else:
            logs = {f"loss_{k}": v for k, v in losses.items()}

        if loss_cfg.disc_weight > 0 and mode in ("both", "disc"):
            d_loss, d_logs = loss_cfg.discriminator_loss(state.discriminator, imgs_flat, imgs_w,
                                                         state.step)
            d_loss.backward()
            if mesh is not None:
                _average_grads(state.discriminator.parameters(), mesh)
            state.opt_d.step()
            logs.update(d_logs)

        with torch.no_grad():
            logs["psnr"] = torch.mean(psnr(imgs_w, imgs_flat))
            bits = preds[..., 1:]
            logs["bit_acc"] = torch.nanmean(bit_accuracy(
                bits, msgs_frames, mask_t if bits.ndim == 4 else None))
        state.step += 1
        logs = {k: v.detach() if isinstance(v, torch.Tensor) else v for k, v in logs.items()}
        return state, _average_logs(logs, mesh) if mesh is not None else logs

    return train_step
