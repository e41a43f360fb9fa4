"""Training entry point, counterpart of ``videoseal_tpu/train.py``.

Wires the data -> the Augmenter -> the GAN train step
(``parallel/trainer.py``) -> logging, the periodic in-training eval and the
checkpoints. One process on one device: the card unless ``--device cpu``.

Smoke run (synthetic data, tiny model, on the CPU):
  python -m videoseal_tpu_torch.train --device cpu --tiny 1 --synthetic 1 --steps 3
On the card:
  python -m videoseal_tpu_torch.train --card videoseal_1.0 \\
      --image_dataset /data/coco --epochs 100 --iter_per_epoch 1000

Refused (ROADMAP.md 1.8): --distributed 1, --ckpt_format orbax,
--video_dataset, resuming from a JAX-written train state, the lamb and
adafactor optimizers. --augmentation_config reads JSON; a YAML path raises
ValueError.
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
                   help="JSON with {masks, augs, augs_params} (YAML is refused)")
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
                   help="orbax: sharded checkpoints (ROADMAP.md 1.8; refused)")
    p.add_argument("--distributed", type=int, default=0,
                   help="multi-GPU data parallelism (ROADMAP.md 1.8; refused)")
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


def _config(args) -> tuple[dict, dict]:
    """(card, augmentation config) from the flags: the card (or TINY_CARD)
    with the embedder and extractor presets the flags name; the augs from
    a JSON file or DEFAULT_AUGS."""
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
        if not args.augmentation_config.endswith(".json"):
            raise ValueError(f"--augmentation_config {args.augmentation_config}: the port "
                             "reads JSON (no YAML parser on the card's machine)")
        with open(args.augmentation_config) as f:
            aug_cfg = json.load(f)
    return card, aug_cfg


def _refuse(args) -> None:
    for flag, on in (("--distributed 1", args.distributed),
                     ("--ckpt_format orbax", args.ckpt_format == "orbax"),
                     ("--video_dataset", args.video_dataset)):
        if on:
            raise NotImplementedError(f"{flag}: ROADMAP.md 1.8")


def build_trainer(args, device: torch.device):
    """(TrainerModules, TrainState, host mask embedder or None) for the
    flags: the modules at random init from --seed on `device`."""
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
        scaling_i=args.scaling_i, temperature=args.temperature, balanced=bool(args.balanced))
    sched = None
    if args.scheduler:
        sched = build_lr_schedule(args.scheduler, args.iter_per_epoch,
                                  parse_params(args.optimizer).get("lr", 1e-4))
    state = create_train_state(mods, args.optimizer, args.optimizer_d,
                               scaling_w=args.scaling_w, schedule=sched)
    return mods, state, host_masks


def main(argv=None):
    """Train as the flags say; returns (state, logger, step_ms): the final
    TrainState, the MetricLogger, and each step's milliseconds (CUDA events
    on the card, the host clock on the CPU)."""
    args = get_parser().parse_args(argv)
    _refuse(args)
    device = torch.device("cpu" if args.cpu else args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("train runs on the CUDA device by default and none is available; "
                           "pass --device cpu to train on the CPU")

    from .data.datasets import ImageFolder, SyntheticImages
    from .data.loader import DataLoader
    from .parallel.trainer import make_train_step
    from .utils import checkpoint as ckpt_io
    from .utils.logger import MetricLogger
    from .utils.optim import ScalingSchedule
    from .utils.tensorboard import TensorboardWriter

    os.makedirs(args.output_dir, exist_ok=True)
    mods, state, host_masks = build_trainer(args, device)
    img_size = mods.cfg.img_size
    if args.resume:
        fresh = None
        if args.reset_disc:
            fresh = ({k: v.clone() for k, v in state.discriminator.state_dict().items()},
                     copy.deepcopy(state.opt_d.state_dict()))
        ckpt_io.load_train_state(args.resume, state)
        if fresh is not None:
            state.discriminator.load_state_dict(fresh[0])
            state.opt_d.load_state_dict(fresh[1])
        print(f"resumed {args.resume} at step {state.step}", flush=True)
    scaling_sched = (ScalingSchedule(args.scaling_w_schedule, args.scaling_w)
                     if args.scaling_w_schedule else None)

    if args.synthetic or not args.image_dataset:
        ds = SyntheticImages(4096, img_size=img_size, seed=args.seed)
    else:
        ds = ImageFolder(args.image_dataset, img_size=img_size)
    loader = DataLoader(ds, args.batch_size, seed=args.seed)

    # synthetic runs keep the whole dataset on the device as u8 and gather
    # each batch there: a step then uploads batch_size indices, not images
    device_pool = None
    if args.synthetic and host_masks is None:
        device_pool = torch.as_tensor(np.stack([
            np.clip(ds[i][0] * 255.0, 0, 255).astype(np.uint8) for i in range(len(ds))]),
            device=device)
        pool_rng = np.random.default_rng(args.seed + 7)

    step_fns_by_mode = {m: make_train_step(mods, is_video=False, mode=m)
                        for m in (("gen", "disc") if args.sleepwake else ("both",))}
    logger = MetricLogger()
    generator = torch.Generator().manual_seed(args.seed)

    writer = TensorboardWriter(os.path.join(args.output_dir, "tensorboard"),
                               enabled=bool(args.tensorboard))
    eval_fn = None
    if args.eval_freq:
        from .evals.intrain import make_intrain_eval
        # representative validation masks only where localisation is trained
        val_masks = None
        if host_masks is not None and args.lambda_det > 0:
            val_masks = [m[0] for m in host_masks.sample_representative_masks(img_size,
                                                                              img_size)]
        eval_fn = make_intrain_eval(mods, eval_augs=args.eval_augs, validation_masks=val_masks)
        eval_imgs = np.stack([ds[i][0] for i in range(min(args.eval_samples, len(ds)))])

    def run_eval(epoch, it):
        from .utils.display import create_diff_img, save_img
        scalars, imgs_w = eval_fn(state, eval_imgs, torch.Generator().manual_seed(args.seed + 1))
        writer.add_scalars("valid", scalars, it)
        with open(os.path.join(args.output_dir, "eval.jsonl"), "a") as f:
            f.write(json.dumps({"epoch": epoch, "step": it, "modality": "img", **scalars})
                    + "\n")
        snap = os.path.join(args.output_dir, "snapshots")
        os.makedirs(snap, exist_ok=True)
        wm = imgs_w.cpu().numpy()
        for i in range(min(2, wm.shape[0])):
            save_img(eval_imgs[i], os.path.join(snap, f"{epoch:03d}_{i}_ori.png"))
            save_img(wm[i], os.path.join(snap, f"{epoch:03d}_{i}_wm.png"))
            save_img(create_diff_img(eval_imgs[i], wm[i]),
                     os.path.join(snap, f"{epoch:03d}_{i}_diff.png"))
        print("eval @ epoch", epoch, json.dumps({k: round(v, 4) for k, v in scalars.items()}),
              flush=True)

    ckpt_path = os.path.join(args.output_dir, "checkpoint.npz")
    total_steps = args.steps or args.epochs * args.iter_per_epoch
    log_path = os.path.join(args.output_dir, "log.txt")
    events = []             # (start, end) CUDA events, or host seconds, a step
    it = epoch = 0
    t_start = time.time()
    while it < total_steps:
        loader.set_epoch(epoch)
        step_fn = step_fns_by_mode[("disc" if epoch % 2 == 1 else "gen") if args.sleepwake
                                   else "both"]
        if scaling_sched is not None:
            state.scaling_w = float(scaling_sched(epoch))
        batches = iter(lambda: "pool", None) if device_pool is not None else iter(loader)
        for epoch_it, batch in enumerate(batches):
            # an epoch is iter_per_epoch steps (the loaders are effectively
            # infinite)
            if it >= total_steps or epoch_it >= args.iter_per_epoch:
                break
            if batch == "pool":
                idx = torch.as_tensor(pool_rng.integers(0, len(device_pool), args.batch_size))
                batch = {"imgs": device_pool[idx.to(device)].float() * (1.0 / 255.0)}
            else:
                if host_masks is not None:
                    dsm = batch.get("masks")
                    batch["masks"] = host_masks(batch["imgs"], dsm if dsm is not None
                                                and np.asarray(dsm).size else None)
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
            # logs are read on log steps only: a read waits for the device
            if it % 10 == 0:
                logger.update(**{k: float(v) for k, v in logs.items()})
                print(logger.line(prefix=f"step {it}/{total_steps} [img]"), flush=True)
                with open(log_path, "a") as f:
                    f.write(json.dumps({"step": it, **logger.recent()}) + "\n")
                writer.add_scalars("train", logger.recent(), it)
            it += 1
        epoch += 1
        if epoch % args.saveckpt_freq == 0:
            ckpt_io.save_train_state(ckpt_path, state)
        if eval_fn is not None and epoch % args.eval_freq == 0:
            run_eval(epoch, it)
    ckpt_io.save_train_state(ckpt_path, state)
    writer.close()
    if device.type == "cuda":
        torch.cuda.synchronize()
        step_ms = [a.elapsed_time(b) for a, b in events]
    else:
        step_ms = [s * 1e3 for s in events]
    print(f"done: {it} steps in {time.time() - t_start:.1f}s; final {logger.line()}", flush=True)
    return state, logger, step_ms


if __name__ == "__main__":
    main()
