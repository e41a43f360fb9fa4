"""Training entry point, counterpart of ``videoseal_tpu/train.py``.

Wires the data -> the Augmenter -> the GAN train step
(``parallel/trainer.py``) -> logging, the periodic in-training eval and the
checkpoints. One process on the card unless ``--device cpu``; with
``--distributed 1`` one process per rank (torchrun's or SLURM's
environment, ``utils/dist.py``), data parallel over the global batch
``--batch_size`` (which the world size must divide), rank 0 alone logging
and writing ``.npz`` checkpoints.

Smoke run (synthetic data, tiny model, on the CPU):
  python -m videoseal_tpu_torch.train --device cpu --tiny 1 --synthetic 1 --steps 3
On the card:
  python -m videoseal_tpu_torch.train --card videoseal_1.0 \\
      --image_dataset /data/coco --epochs 100 --iter_per_epoch 1000
  torchrun --nproc_per_node 8 -m videoseal_tpu_torch.train --distributed 1 ...

--ckpt_format orbax writes ``torch.distributed.checkpoint`` directories
(``<output_dir>/ckpts/<step>/``, the flag named as in the JAX package);
--resume takes such a directory, the port's ``.npz`` or one the JAX
package wrote. --augmentation_config reads JSON, or takes a pool of
``augmentation/presets.AUGS`` by its name or by the path of its YAML file
(``videoseal_tpu/configs/augs_identity.yaml``), which is not read; another
path raises ValueError.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import time

import numpy as np
import torch


def get_parser():
    p = argparse.ArgumentParser("videoseal_tpu_torch training")
    # model
    p.add_argument("--card", default="videoseal_1.0",
                   help="model card providing embedder/extractor configs")
    p.add_argument("--embedder_model", default=None,
                   help="a preset of presets.EMBEDDER (overrides the card)")
    p.add_argument("--extractor_model", default=None,
                   help="a preset of presets.EXTRACTOR (overrides the card)")
    p.add_argument("--nbits", type=int, default=None)
    p.add_argument("--img_size", type=int, default=None,
                   help="processing resolution (overrides the card's "
                        "img_size_proc when given)")
    p.add_argument("--scaling_w", type=float, default=0.2)
    p.add_argument("--scaling_w_schedule", default=None,
                   help='e.g. "Cosine,scaling_min=0.2,start_epoch=200,epochs=200"')
    p.add_argument("--scaling_i", type=float, default=1.0)
    p.add_argument("--attenuation", default="jnd_1_1")
    # losses (train.py lambda_* flags)
    p.add_argument("--lambda_dec", type=float, default=1.0)
    p.add_argument("--lambda_det", type=float, default=0.0)
    p.add_argument("--lambda_i", type=float, default=0.5)
    p.add_argument("--lambda_d", type=float, default=0.1)
    p.add_argument("--perceptual_loss", default="yuv")
    p.add_argument("--balanced", type=int, default=0)  # reference train.py:179
    p.add_argument("--total_gnorm", type=float, default=1.0)
    p.add_argument("--disc_start", type=int, default=0)
    p.add_argument("--disc_num_layers", type=int, default=2)
    p.add_argument("--sleepwake", type=int, default=0,
                   help="alternate disc/gen epochs (train.py:610-614)")
    p.add_argument("--temperature", type=float, default=1.0)
    # optimizers
    p.add_argument("--optimizer", default="AdamW,lr=1e-4")
    p.add_argument("--optimizer_d", default="AdamW,lr=5e-5")
    p.add_argument("--scheduler", default=None)
    # data
    p.add_argument("--image_dataset", default=None)
    p.add_argument("--video_dataset", default=None)
    p.add_argument("--synthetic", type=int, default=0)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--batch_size_video", type=int, default=1)
    p.add_argument("--frames_per_clip", type=int, default=16)
    p.add_argument("--prop_img_vid", type=float, default=0.5,
                   help="fraction of video epochs in hybrid modality")
    p.add_argument("--augmentation_config", default=None,
                   help="JSON with {masks, augs, augs_params}, or a pool of "
                        "augmentation/presets.AUGS by name or by its YAML file's path")
    p.add_argument("--num_augs", type=int, default=2)
    # schedule
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--iter_per_epoch", type=int, default=1000)
    p.add_argument("--steps", type=int, default=None,
                   help="override: total steps (smoke runs)")
    p.add_argument("--seed", type=int, default=444)
    p.add_argument("--tiny", type=int, default=0, help="tiny debug model")
    # io
    p.add_argument("--output_dir", default="outputs")
    p.add_argument("--saveckpt_freq", type=int, default=10)
    p.add_argument("--eval_freq", type=int, default=5,
                   help="run the in-training eval sweep every N epochs "
                        "(reference train.py:532-544; 0 disables)")
    p.add_argument("--eval_augs", default="subset",
                   choices=["identity", "subset", "geometric", "full"],
                   help="validation grid for the in-training sweep")
    p.add_argument("--eval_samples", type=int, default=8,
                   help="held-out images for the in-training eval")
    p.add_argument("--tensorboard", type=int, default=1,
                   help="write TB scalars + snapshot images (train.py:679-701)")
    p.add_argument("--resume", default=None)
    p.add_argument("--reset_disc", type=int, default=0,
                   help="on --resume, keep a FRESH discriminator (+ its opt "
                        "state) instead of the checkpoint's. A stale disc "
                        "from an earlier GAN stage is instantly confident "
                        "against the resumed watermark and its hinge-G "
                        "gradient crushes the message before the disc gate "
                        "(--disc_start, compared against the RESTORED global "
                        "step) would let a scratch disc warm up.")
    p.add_argument("--ckpt_format", default="npz", choices=["npz", "orbax"],
                   help="orbax: sharded collective checkpoints (torch.distributed."
                        "checkpoint files under <output_dir>/ckpts/<step>)")
    p.add_argument("--distributed", type=int, default=0,
                   help="data parallelism over the process group of a torchrun or "
                        "SLURM launch (NCCL; gloo with --device cpu)")
    p.add_argument("--cpu", type=int, default=0, help="the same as --device cpu")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; raises where there is none) or cpu")
    return p




TINY_CARD = {
    "args": {"attenuation": "jnd_1_1", "nbits": 16, "hidden_size_multiplier": 2,
             "img_size_proc": 64, "blending_method": "additive",
             "scaling_w": 0.2, "scaling_i": 1.0},
    "embedder": {"model": "unet_tiny_yuv", "params": {
        "msg_processor": {"msg_processor_type": "binary+concat"},
        "unet": {"in_channels": 1, "out_channels": 1, "z_channels": 8,
                 "num_blocks": 2, "activation": "relu", "normalization": "batch",
                 "z_channels_mults": [1, 2], "last_tanh": True}}},
    "extractor": {"model": "convnext_tiny", "params": {
        "encoder": {"depths": [1, 1, 2, 1], "dims": [16, 32, 64, 128]},
        "pixel_decoder": {"pixelwise": False, "upscale_stages": [1],
                          "embed_dim": 128, "sigmoid_output": False}}},
}

DEFAULT_AUGS = {
    "masks": {"kind": None},
    "augs": {"identity": 4, "jpeg": 1, "resize": 1, "crop": 1, "rotate": 1,
             "hflip": 1, "perspective": 1, "gaussian_blur": 1, "median_filter": 1,
             "brightness": 1, "contrast": 1, "saturation": 1, "hue": 1,
             "h264": 1, "h264rgb": 1, "h265": 1},
    "augs_params": {
        "resize": {"min_size": 0.7, "max_size": 1.5},
        "crop": {"min_size": 0.5, "max_size": 1.0},
        "rotate": {"min_angle": -10, "max_angle": 10, "do90": True},
        "perspective": {"min_distortion_scale": 0.1, "max_distortion_scale": 0.5},
        "jpeg": {"min_quality": 40, "max_quality": 80},
        "gaussian_blur": {"min_kernel_size": 3, "max_kernel_size": 17},
        "median_filter": {"min_kernel_size": 3, "max_kernel_size": 3},
        "brightness": {"min_factor": 0.5, "max_factor": 2},
        "contrast": {"min_factor": 0.5, "max_factor": 2.0},
        "saturation": {"min_factor": 0.5, "max_factor": 2},
        "hue": {"min_factor": -0.1, "max_factor": 0.1},
        "h264": {"min_crf": 28, "max_crf": 36},
        "h264rgb": {"min_crf": 28, "max_crf": 36},
        "h265": {"min_crf": 28, "max_crf": 36},
    },
}


def augmentation_config(path: str) -> dict:
    """An --augmentation_config: a JSON file, or a pool of presets.AUGS by
    its name or by the path of its YAML file (the file is not read: the
    pool travels as Python data, held equal to the file by the tests)."""
    from .augmentation.presets import AUGS

    if path.endswith(".json"):
        with open(path) as f:
            return json.load(f)
    name = os.path.splitext(os.path.basename(path))[0]
    if name in AUGS:
        return copy.deepcopy(AUGS[name])
    raise ValueError(f"--augmentation_config {path}: the port reads JSON, or one of the pools "
                     f"{sorted(AUGS)} by its name or its YAML file's path (no YAML parser on "
                     "the card's machine)")


def _config(args) -> tuple[dict, dict]:
    """(card, augmentation config) from the flags: the card (or TINY_CARD)
    with the embedder and extractor presets the flags name; the augs from
    --augmentation_config or DEFAULT_AUGS."""
    from . import presets
    from .utils.cfg import load_card

    card = copy.deepcopy(TINY_CARD if args.tiny else load_card(args.card))
    if args.embedder_model:
        card["embedder"] = {"model": args.embedder_model,
                            "params": copy.deepcopy(presets.EMBEDDER[args.embedder_model])}
    if args.extractor_model:
        card["extractor"] = {"model": args.extractor_model,
                             "params": copy.deepcopy(presets.EXTRACTOR[args.extractor_model])}
    aug_cfg = DEFAULT_AUGS
    if args.augmentation_config:
        aug_cfg = augmentation_config(args.augmentation_config)
    return card, aug_cfg


def build_trainer(args, device: torch.device, mesh=None):
    """(TrainerModules, TrainState, host mask embedder or None) for the
    flags: the modules at random init from --seed on `device`; `mesh` (a
    ``parallel.mesh.Mesh``) makes the step data parallel."""
    from .augmentation.augmenter import build_augmenter
    from .losses.videosealloss import VideoSealLoss
    from .models.embedder import build_embedder
    from .models.extractor import build_extractor
    from .models.videoseal import PipelineConfig, init_weights
    from .modules.discriminator import NLayerDiscriminator
    from .modules.jnd import build_attenuation
    from .parallel.trainer import TrainerModules, create_train_state
    from .utils.optim import build_lr_schedule, parse_params

    card, aug_cfg = _config(args)
    cargs = card["args"]
    nbits = args.nbits or int(cargs.get("nbits", 256))
    img_size = int(args.img_size or cargs.get("img_size_proc", 256))
    emb = build_embedder(card["embedder"]["model"], card["embedder"]["params"], nbits,
                         float(cargs.get("hidden_size_multiplier", 2)))
    ext = build_extractor(card["extractor"]["model"], card["extractor"]["params"],
                          img_size, nbits)
    disc = NLayerDiscriminator(n_layers=args.disc_num_layers)
    gen = torch.Generator().manual_seed(args.seed)
    for m in (emb.module, ext.module, disc):
        init_weights(m, gen)

    # mask families: "mixed" (or host) samples on the host with the
    # reference's distributions and feeds the step through "segmentation";
    # "mixed_device" is the on-device sampler
    mask_cfg = dict(aug_cfg.get("masks") or {"kind": None})
    host_masks = None
    if mask_cfg.get("kind") in ("mixed", "host", "mixed_host"):
        from .augmentation.masks_host import get_mask_embedder
        host_masks = get_mask_embedder("mixed", seed=args.seed,
                                       **{k: v for k, v in mask_cfg.items() if k != "kind"})
        aug_cfg = {**aug_cfg, "masks": {"kind": "segmentation"}}
    elif mask_cfg.get("kind") == "mixed_device":
        aug_cfg = {**aug_cfg, "masks": {**mask_cfg, "kind": "mixed"}}
    cfg = PipelineConfig(img_size=img_size, yuv=emb.yuv, nbits=nbits,
                         blending_method=cargs.get("blending_method", "additive"))
    mods = TrainerModules(
        embedder=emb.module.to(device), extractor=ext.module.to(device),
        discriminator=disc.to(device),
        augmenter=build_augmenter(aug_cfg, num_augs=args.num_augs),
        attenuation=build_attenuation(args.attenuation), cfg=cfg,
        loss=VideoSealLoss(balanced=bool(args.balanced), total_norm=args.total_gnorm,
                           disc_weight=args.lambda_d, percep_weight=args.lambda_i,
                           detect_weight=args.lambda_det, decode_weight=args.lambda_dec,
                           disc_start=args.disc_start, percep_loss=args.perceptual_loss),
        scaling_i=args.scaling_i, temperature=args.temperature, balanced=bool(args.balanced),
        mesh=mesh)
    sched = None
    if args.scheduler:
        sched = build_lr_schedule(args.scheduler, args.iter_per_epoch,
                                  parse_params(args.optimizer).get("lr", 1e-4))
    state = create_train_state(mods, args.optimizer, args.optimizer_d,
                               scaling_w=args.scaling_w, schedule=sched)
    return mods, state, host_masks


def _save_ckpt(args, state, is_main: bool) -> None:
    """The sharded checkpoint from every rank (collective), or the .npz
    from rank 0."""
    from .utils import checkpoint as ckpt_io
    if args.ckpt_format == "orbax":
        ckpt_io.save_train_state_sharded(
            os.path.join(os.path.abspath(args.output_dir), "ckpts"), state)
    elif is_main:
        ckpt_io.save_train_state(os.path.join(args.output_dir, "checkpoint.npz"), state)


def main(argv=None):
    """Train as the flags say; returns (state, logger, step_ms): the final
    TrainState, the MetricLogger, and each step's milliseconds (CUDA events
    on the card, the host clock on the CPU)."""
    import torch.distributed as dist

    args = get_parser().parse_args(argv)
    _config(args)                       # refuse an unknown augmentation config first
    want = "cpu" if args.cpu else args.device
    if want != "cpu" and not torch.cuda.is_available():
        raise RuntimeError("train runs on the CUDA device by default and none is available; "
                           "pass --device cpu to train on the CPU")

    from .data.loader import DataLoader
    from .parallel.mesh import make_mesh
    from .parallel.trainer import make_train_step
    from .utils import checkpoint as ckpt_io
    from .utils.dist import average_metrics, init_distributed_mode
    from .utils.logger import MetricLogger
    from .utils.optim import ScalingSchedule
    from .utils.tensorboard import TensorboardWriter

    owns_group = False
    mesh = None
    if args.distributed:
        owns_group = not dist.is_initialized()
        device = init_distributed_mode(want)
        mesh = make_mesh()
    else:
        device = torch.device(want)
    rank, world = (mesh.rank, mesh.size) if mesh is not None else (0, 1)
    is_main = rank == 0
    for flag, n in (("--batch_size", args.batch_size),
                    ("--batch_size_video", args.batch_size_video if args.video_dataset else 0)):
        if n % world:
            raise ValueError(f"{flag} {n} (the global batch) does not split over {world} ranks")
    local_bs, local_bs_video = args.batch_size // world, args.batch_size_video // world

    os.makedirs(args.output_dir, exist_ok=True)
    mods, state, host_masks = build_trainer(args, device, mesh)
    img_size = mods.cfg.img_size
    if args.resume:
        fresh = None
        if args.reset_disc:
            fresh = ({k: v.clone() for k, v in state.discriminator.state_dict().items()},
                     copy.deepcopy(state.opt_d.state_dict()))
        if args.ckpt_format == "orbax" or os.path.isdir(args.resume):
            ckpt_io.load_train_state_sharded(args.resume, state)
        else:
            ckpt_io.load_train_state(args.resume, state)
        if fresh is not None:
            state.discriminator.load_state_dict(fresh[0])
            state.opt_d.load_state_dict(fresh[1])
        if is_main:
            print(f"resumed {args.resume} at step {state.step}", flush=True)
    scaling_sched = (ScalingSchedule(args.scaling_w_schedule, args.scaling_w)
                     if args.scaling_w_schedule else None)

    # data: images and/or video clips, each rank loading its share of the
    # index space; the hybrid modality picks one per epoch
    loaders = {}
    if args.synthetic or not (args.image_dataset or args.video_dataset):
        from .data.datasets import SyntheticImages
        loaders["img"] = DataLoader(SyntheticImages(4096, img_size=img_size, seed=args.seed),
                                    local_bs, seed=args.seed, process_index=rank,
                                    process_count=world)
    if args.image_dataset and not args.synthetic:
        from .data.datasets import ImageFolder
        loaders["img"] = DataLoader(ImageFolder(args.image_dataset, img_size=img_size),
                                    local_bs, seed=args.seed, process_index=rank,
                                    process_count=world)
    if args.video_dataset:
        from .data.datasets import VideoClipDataset
        vds = VideoClipDataset(args.video_dataset, frames_per_clip=args.frames_per_clip,
                               img_size=img_size, seed=args.seed)
        loaders["vid"] = DataLoader(vds, local_bs_video, seed=args.seed, process_index=rank,
                                    process_count=world)

    # synthetic runs keep the whole dataset on the device as u8 and gather
    # each global batch there (every rank draws the same indices and takes
    # its rows): a step uploads batch_size indices, not images
    device_pool = None
    if args.synthetic and host_masks is None:
        ds = loaders["img"].ds
        device_pool = torch.as_tensor(np.stack([
            np.clip(ds[i][0] * 255.0, 0, 255).astype(np.uint8) for i in range(len(ds))]),
            device=device)
        pool_rng = np.random.default_rng(args.seed + 7)

    modes = ("gen", "disc") if args.sleepwake else ("both",)
    step_fns_by_mode = {m: {k: make_train_step(mods, is_video=k == "vid", mode=m)
                            for k in loaders} for m in modes}
    logger = MetricLogger()
    generator = torch.Generator().manual_seed(args.seed)
    modality_rng = np.random.default_rng(args.seed)

    writer = TensorboardWriter(os.path.join(args.output_dir, "tensorboard"),
                               enabled=bool(args.tensorboard) and is_main)
    evals = []          # (prefix, eval_fn, held-out batch)
    if args.eval_freq:
        from .evals.intrain import make_intrain_eval
        if "img" in loaders:
            # representative validation masks only where localisation is trained
            val_masks = None
            if host_masks is not None and args.lambda_det > 0:
                val_masks = [m[0] for m in host_masks.sample_representative_masks(img_size,
                                                                                  img_size)]
            ds_eval = loaders["img"].ds
            evals.append(("", make_intrain_eval(mods, eval_augs=args.eval_augs,
                                                validation_masks=val_masks,
                                                lambda_det=args.lambda_det),
                          np.stack([ds_eval[i][0] for i in range(min(args.eval_samples,
                                                                     len(ds_eval)))])))
        if "vid" in loaders:
            vds_eval = loaders["vid"].ds
            n_clips = min(max(1, args.eval_samples // args.frames_per_clip), len(vds_eval))
            evals.append(("vid_", make_intrain_eval(mods, eval_augs=args.eval_augs,
                                                    is_video=True,
                                                    lambda_det=args.lambda_det),
                          np.stack([vds_eval[i][0] for i in range(n_clips)])))

    def run_eval(epoch, it):
        from .utils.display import create_diff_img, save_img
        for prefix, fn, batch in evals:
            scalars, imgs_w = fn(state, batch, torch.Generator().manual_seed(args.seed + 1))
            scalars = {prefix + k: v for k, v in average_metrics(
                scalars, mesh.group if mesh is not None else None).items()}
            if not is_main:
                continue
            writer.add_scalars("valid", scalars, it)
            with open(os.path.join(args.output_dir, "eval.jsonl"), "a") as f:
                f.write(json.dumps({"epoch": epoch, "step": it,
                                    "modality": prefix.rstrip("_") or "img", **scalars}) + "\n")
            snap = os.path.join(args.output_dir, "snapshots")
            os.makedirs(snap, exist_ok=True)
            ori = batch.reshape((-1,) + batch.shape[-3:])
            wm = imgs_w.cpu().numpy().reshape(ori.shape)
            for i in range(min(2, wm.shape[0])):
                save_img(ori[i], os.path.join(snap, f"{epoch:03d}_{prefix}{i}_ori.png"))
                save_img(wm[i], os.path.join(snap, f"{epoch:03d}_{prefix}{i}_wm.png"))
                save_img(create_diff_img(ori[i], wm[i]),
                         os.path.join(snap, f"{epoch:03d}_{prefix}{i}_diff.png"))
            print("eval @ epoch", epoch,
                  json.dumps({k: round(v, 4) for k, v in scalars.items()}), flush=True)

    total_steps = args.steps or args.epochs * args.iter_per_epoch
    log_path = os.path.join(args.output_dir, "log.txt")
    events = []             # (start, end) CUDA events, or host seconds, a step
    it = epoch = 0
    t_start = time.time()
    while it < total_steps:
        if len(loaders) == 2:
            modality = "vid" if modality_rng.random() < args.prop_img_vid else "img"
        else:
            modality = next(iter(loaders))
        loader = loaders[modality]
        loader.set_epoch(epoch)
        step_fn = step_fns_by_mode[("disc" if epoch % 2 == 1 else "gen") if args.sleepwake
                                   else "both"][modality]
        if scaling_sched is not None:
            state.scaling_w = float(scaling_sched(epoch))
        pooled = device_pool is not None and modality == "img"
        batches = iter(lambda: "pool", None) if pooled else iter(loader)
        for epoch_it, batch in enumerate(batches):
            # an epoch is iter_per_epoch steps (the loaders are effectively
            # infinite)
            if it >= total_steps or epoch_it >= args.iter_per_epoch:
                break
            if pooled:
                idx = pool_rng.integers(0, len(device_pool), args.batch_size)
                if mesh is not None:
                    idx = idx[mesh.shard(args.batch_size)]
                batch = {"imgs": device_pool[torch.as_tensor(idx).to(device)].float()
                         * (1.0 / 255.0)}
            else:
                if host_masks is not None:
                    flat = batch["imgs"].reshape((-1,) + batch["imgs"].shape[-3:])
                    dsm = batch.get("masks")
                    dsm = (np.asarray(dsm).reshape((-1,) + flat.shape[1:3] + (1,))
                           if dsm is not None and np.asarray(dsm).size else None)
                    batch["masks"] = host_masks(flat, dsm).reshape(
                        batch["imgs"].shape[:-1] + (1,))
                batch = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
            if device.type == "cuda":
                ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                ev[0].record()
                _, logs = step_fn(state, batch, generator)
                ev[1].record()
                events.append(ev)
            else:
                t0 = time.perf_counter()
                _, logs = step_fn(state, batch, generator)
                events.append(time.perf_counter() - t0)
            # logs (averaged over the ranks by the step) are read on log
            # steps only: a read waits for the device
            if it % 10 == 0:
                logger.update(**{k: float(v) for k, v in logs.items()})
                if is_main:
                    print(logger.line(prefix=f"step {it}/{total_steps} [{modality}]"),
                          flush=True)
                    with open(log_path, "a") as f:
                        f.write(json.dumps({"step": it, **logger.recent()}) + "\n")
                    writer.add_scalars("train", logger.recent(), it)
            it += 1
        epoch += 1
        if epoch % args.saveckpt_freq == 0:
            _save_ckpt(args, state, is_main)
        if evals and epoch % args.eval_freq == 0:
            run_eval(epoch, it)
    _save_ckpt(args, state, is_main)
    writer.close()
    if device.type == "cuda":
        torch.cuda.synchronize()
        step_ms = [a.elapsed_time(b) for a, b in events]
    else:
        step_ms = [s * 1e3 for s in events]
    if is_main:
        print(f"done: {it} steps in {time.time() - t_start:.1f}s; final {logger.line()}",
              flush=True)
    if owns_group:
        dist.destroy_process_group()
    return state, logger, step_ms


def main_rank(rank: int, argv) -> list:
    """`main(argv)` on one rank of ``parallel.launch.run_local``'s group
    (two gloo ranks on the CPU without torchrun); returns its step times."""
    return main(argv)[2]


if __name__ == "__main__":
    main()
