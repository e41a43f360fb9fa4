"""WmForger's preference-model training, counterpart of
``videoseal_tpu/wmforger/train.py``.

A ConvNeXt extractor with nbits=0 learns to score real images above
watermarked ones: BCE or Bradley-Terry (DPO Eq. 2) loss on artificial FFT
watermarks, hardened by gradient perturbation (an inner ascent on an
additive perturbation that raises the watermarked image's score, then the
model trained to rank the perturbed image below the real one). Options: a
second-order gradient-matching term and a weak-against-strong watermark
ranking. The extractor takes its module math here (grad is on), never K2.

The step's random draws (the ascent's step sizes, the random start, the two
strengths) come from `sample_draws` on a ``torch.Generator``; the step
itself is a function of the batch and those draws, so a test can give it
the JAX package's draws.

  python -m videoseal_tpu_torch.wmforger.train --device cpu --tiny 1 --synthetic 1 --steps 2
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def construct_loss(loss_type: str):
    """(real logits, watermarked logits) -> loss: "bce" or "bt_nll"."""

    def bce(logits, targets):
        return torch.mean(torch.clamp(logits, min=0) - logits * targets
                          + torch.log1p(torch.exp(-logits.abs())))

    if loss_type == "bce":
        return lambda real, wm: bce(real, torch.ones_like(real)) + bce(wm, torch.zeros_like(wm))
    if loss_type == "bt_nll":   # Bradley-Terry / DPO Eq. (2)
        return lambda real, wm: bce(real - wm, torch.ones_like(real))
    raise NotImplementedError(f"Loss {loss_type} is not implemented.")


def sample_draws(generator: torch.Generator, n_steps: int, shape, device,
                 min_perturbation: float = 1e-3, max_perturbation: float = 3e-2,
                 use_rand_perturbation: bool = False) -> dict:
    """One step's draws from `generator` (on the CPU): the ascent's step
    sizes U(min, max), its start U(-1, 1) * min where asked, and the two
    U(0, 1) draws of the strength contrast."""
    lrs = min_perturbation + (max_perturbation - min_perturbation) * torch.rand(
        n_steps, generator=generator, dtype=torch.float64)
    init = None
    if use_rand_perturbation:
        init = ((torch.rand(tuple(shape), generator=generator) * 2 - 1)
                * min_perturbation).to(device)
    return {"lrs": lrs.tolist(), "init": init,
            "alphas": torch.rand(2, generator=generator, dtype=torch.float64).tolist()}


def adversarial_perturb(score_fn, imgs_w: torch.Tensor, lrs, init=None,
                        use_grad_sign_only: bool = False) -> torch.Tensor:
    """The attacker's ascent: one gradient step per entry of `lrs` on an
    additive perturbation (from `init`, else 0) raising
    mean(score_fn(imgs_w + pert)); returns clip(imgs_w + pert, 0, 1),
    detached."""
    pert = torch.zeros_like(imgs_w) if init is None else init
    for lr in lrs:
        pert = pert.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(-score_fn(imgs_w + pert).mean(), pert)
        pert = pert - lr * (torch.sign(g) if use_grad_sign_only else g)
    return torch.clamp(imgs_w + pert, 0, 1).detach()


def make_train_step(extractor: torch.nn.Module, loss_type: str,
                    optimizer: torch.optim.Optimizer, n_perturbation_steps: int = 0,
                    use_grad_sign_only: bool = False, grad_matching: bool = False,
                    grad_matching_weight: float = 1.0, strength_contrasting: bool = False,
                    weak_alpha: float = 0.5, strong_alpha: float = 1.5,
                    alpha_range: float = 0.5):
    """step(batch, draws) -> logs: one optimizer step on {"imgs", "imgs_w"}
    with `sample_draws`' draws. A step whose gradients' global norm is not
    finite leaves the parameters and the optimizer's state as they were."""
    loss_fn = construct_loss(loss_type)
    params = [p for p in extractor.parameters() if p.requires_grad]

    def score(x):
        return extractor(x)[..., 0]

    def total_loss(imgs, imgs_w, draws):
        real_logits, wm_logits = score(imgs), score(imgs_w)
        loss = loss_fn(real_logits, wm_logits)
        logs = {}
        if grad_matching:
            # second order: the score's input gradient along -watermark
            pert = torch.zeros_like(imgs_w, requires_grad=True)
            (gp,) = torch.autograd.grad(score(imgs_w + pert).mean(), pert, create_graph=True)
            watermark = imgs_w - imgs
            cos = ((gp * -watermark).sum()
                   / (torch.linalg.vector_norm(gp) * torch.linalg.vector_norm(watermark)
                      + 1e-12))
            loss2 = (1 - cos) * grad_matching_weight
            loss = loss + loss2
            logs["loss_2ndorder"] = loss2.detach()
        if n_perturbation_steps > 0:
            perturbed = adversarial_perturb(score, imgs_w, draws["lrs"][:n_perturbation_steps],
                                            draws["init"], use_grad_sign_only)
            loss = loss + loss_fn(real_logits, score(perturbed))
        if strength_contrasting:
            # a weaker watermark ranked above a stronger one
            u1, u2 = draws["alphas"]
            wm = imgs_w - imgs
            weak = torch.clamp(imgs + (weak_alpha + (u1 - 0.5) * alpha_range) * wm, 0, 1)
            strong = torch.clamp(imgs + (strong_alpha + (u2 - 0.5) * alpha_range) * wm, 0, 1)
            loss_c = loss_fn(score(weak), score(strong))
            loss = loss + loss_c
            logs["loss_wm_contrasting"] = loss_c.detach()
        with torch.no_grad():
            logs["acc"] = ((real_logits > 0).float().mean()
                           + (wm_logits < 0).float().mean()) / 2
            logs["ranking"] = ((real_logits - wm_logits) > 0).float().mean()
        return loss, logs

    def train_step(batch: dict, draws: dict) -> dict:
        optimizer.zero_grad(set_to_none=True)
        loss, logs = total_loss(batch["imgs"], batch["imgs_w"], draws)
        loss.backward()
        gnorm = torch.sqrt(sum((p.grad.float() ** 2).sum() for p in params if p.grad is not None))
        if bool(torch.isfinite(gnorm)):
            optimizer.step()
        logs["loss"] = loss.detach()
        return logs

    return train_step


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("wmforger preference-model training")
    p.add_argument("--loss", default="bt_nll", choices=["bce", "bt_nll"])
    p.add_argument("--generator", default="random",
                   choices=["random", "waves", "gaussian", "lines"])
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--img_size", type=int, default=256)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--n_perturbation_steps", type=int, default=1)
    p.add_argument("--use_grad_sign_only", type=int, default=0)
    p.add_argument("--use_rand_perturbation", type=int, default=0)
    p.add_argument("--grad_matching", type=int, default=0)
    p.add_argument("--grad_matching_weight", type=float, default=1.0)
    p.add_argument("--watermark_strength_contrasting", type=int, default=0)
    p.add_argument("--image_dataset", default=None)
    p.add_argument("--synthetic", type=int, default=0)
    p.add_argument("--tiny", type=int, default=0)
    p.add_argument("--output", default="wmforger_ckpt.npz")
    p.add_argument("--cpu", type=int, default=0, help="the same as --device cpu")
    p.add_argument("--device", default="cuda",
                   help="the device to train on: the card unless 'cpu'")
    return p


def build_preference_model(img_size: int, depths, dims) -> torch.nn.Module:
    """The preference model: convnext_tiny's extractor at these widths, one
    output (nbits=0), a global head."""
    from ..models.extractor import build_extractor
    return build_extractor("convnext_tiny", {
        "encoder": {"depths": list(depths), "dims": list(dims)},
        "pixel_decoder": {"pixelwise": False, "upscale_stages": [1],
                          "embed_dim": dims[-1], "sigmoid_output": False}},
        img_size, nbits=0).module


def main(argv=None):
    """Train as the flags say and write the JAX package's ``.npz`` layout
    (``params//encoder//...``); returns (extractor, step_ms): each step's
    ms (CUDA events on the card, the host clock on the CPU)."""
    args = get_parser().parse_args(argv)
    device = torch.device("cpu" if args.cpu else args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("wmforger.train runs on the CUDA device by default and none is "
                           "available; pass --device cpu to train on the CPU")

    from ..data.datasets import ImageFolder, SyntheticImages
    from ..models.videoseal import init_weights
    from ..utils.checkpoint import flatten_tree
    from ..utils.convert import extractor_to_jax
    from ..utils.timing import timed
    from .generators import build_generator

    depths, dims = (([1, 1, 2, 1], [16, 32, 64, 128]) if args.tiny
                    else ([3, 3, 9, 3], [96, 192, 384, 768]))
    extractor = build_preference_model(args.img_size, depths, dims)
    init_weights(extractor, torch.Generator().manual_seed(0))
    extractor.to(device).train()
    # optax.adamw's defaults: weight decay 1e-4 on every parameter
    optimizer = torch.optim.AdamW(extractor.parameters(), lr=args.lr, betas=(0.9, 0.999),
                                  eps=1e-8, weight_decay=1e-4)
    step_fn = make_train_step(extractor, args.loss, optimizer,
                              n_perturbation_steps=args.n_perturbation_steps,
                              use_grad_sign_only=bool(args.use_grad_sign_only),
                              grad_matching=bool(args.grad_matching),
                              grad_matching_weight=args.grad_matching_weight,
                              strength_contrasting=bool(args.watermark_strength_contrasting))
    if args.image_dataset and not args.synthetic:
        ds = ImageFolder(args.image_dataset, img_size=args.img_size)
    else:
        ds = SyntheticImages(4096, img_size=args.img_size)
    gen = build_generator(args.generator)
    draw_gen = torch.Generator().manual_seed(0)
    rng = np.random.default_rng(0)
    step_ms = []
    t0 = time.time()
    for it in range(args.steps):
        idx = rng.integers(0, len(ds), args.batch_size)
        imgs = torch.as_tensor(np.stack([ds[int(i)][0] for i in idx]), device=device)
        batch = {"imgs": imgs, "imgs_w": gen.embed(imgs)["imgs_w"].float()}
        draws = sample_draws(draw_gen, args.n_perturbation_steps, imgs.shape, device,
                             use_rand_perturbation=bool(args.use_rand_perturbation))
        logs, secs = timed(lambda: step_fn(batch, draws), device)
        step_ms.append(secs * 1e3)
        if it % 10 == 0:
            print(f"step {it}: loss={float(logs['loss']):.4f} acc={float(logs['acc']):.3f} "
                  f"ranking={float(logs['ranking']):.3f}", flush=True)
    print(f"{args.steps} steps in {time.time() - t0:.1f}s")
    np.savez(args.output, **flatten_tree(extractor_to_jax(extractor.state_dict())))
    print(f"saved {args.output}")
    return extractor, step_ms


if __name__ == "__main__":
    main()
