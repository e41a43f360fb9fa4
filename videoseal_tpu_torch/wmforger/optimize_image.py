"""One-shot watermark forging and removal, counterpart of
``videoseal_tpu/wmforger/optimize_image.py``.

Loads a trained preference model and runs SGD on an additive perturbation
that raises the image's "real" score. The residual is the estimated
watermark: subtracting it cleans the image, adding it to another image
forges the watermark.

  python -m videoseal_tpu_torch.wmforger.optimize_image --image in.png \
      --ckpt_path wmforger_ckpt.npz [--device cpu]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def _clip01(x: torch.Tensor) -> torch.Tensor:
    # maximum/minimum split the gradient at a tie, as jnp.clip does
    return torch.minimum(torch.maximum(x, x.new_zeros(())), x.new_ones(()))


def optimize(img, extractor: torch.nn.Module, num_steps: int = 50,
             lr: float = 0.05) -> torch.Tensor:
    """img (H, W, 3) in [0, 1] -> the optimised image, on the extractor's
    device."""
    device = next(extractor.parameters()).device
    x = torch.as_tensor(img, device=device).float()[None]
    pert = torch.zeros_like(x)
    for _ in range(num_steps):
        pert.requires_grad_(True)
        (g,) = torch.autograd.grad(-extractor(_clip01(x + pert))[..., 0].mean(), pert)
        pert = (pert - lr * g).detach()
    return _clip01(x + pert)[0]


def get_watermark(img, optimized: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(cleaned, watermark): the optimised image quantised to 8 bits, and
    the original less it."""
    cleaned = torch.round(optimized * 255.0) / 255.0
    return cleaned, torch.as_tensor(img, device=cleaned.device) - cleaned


def load_preference_model(ckpt_path: str, device="cuda") -> torch.nn.Module:
    """A preference model from a ``.npz`` that either package's
    ``wmforger.train`` wrote, its widths read off the weights."""
    from ..utils.checkpoint import unflatten_tree
    from ..utils.convert import extractor_from_jax
    from .train import build_preference_model

    with np.load(ckpt_path) as data:
        variables = unflatten_tree({k: data[k] for k in data.files})
    enc = variables["params"]["encoder"]
    dim = enc["stem_conv"]["kernel"].shape[-1]
    depth3 = sum(1 for k in enc if k.startswith("stage2_block"))
    depths = [3, 3, depth3, 3] if depth3 > 2 else [1, 1, depth3, 1]
    model = build_preference_model(256, depths, [dim, dim * 2, dim * 4, dim * 8])
    model.load_state_dict(extractor_from_jax(variables))
    return model.to(device).eval()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--image", required=True)
    ap.add_argument("--ckpt_path", required=True)
    ap.add_argument("--num_steps", type=int, default=50)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--output_dir", default="output")
    ap.add_argument("--device", default="cuda", help="the card unless 'cpu'")
    args = ap.parse_args(argv)
    if args.device != "cpu" and not torch.cuda.is_available():
        raise RuntimeError("optimize_image runs on the CUDA device by default and none is "
                           "available; pass --device cpu to run on the CPU")
    import cv2

    model = load_preference_model(args.ckpt_path, args.device)
    img = cv2.imread(args.image, cv2.IMREAD_COLOR)[..., ::-1].astype(np.float32) / 255
    cleaned, watermark = get_watermark(img, optimize(img, model, args.num_steps, args.lr))
    cleaned, watermark = cleaned.cpu().numpy(), watermark.cpu().numpy()
    os.makedirs(args.output_dir, exist_ok=True)
    cv2.imwrite(os.path.join(args.output_dir, "cleaned_image.png"),
                np.clip(cleaned * 255 + 0.5, 0, 255).astype(np.uint8)[..., ::-1])
    cv2.imwrite(os.path.join(args.output_dir, "watermark.png"),
                np.clip(np.abs(watermark) * 16 * 255, 0, 255).astype(np.uint8)[..., ::-1])
    print(f"wrote {args.output_dir}/cleaned_image.png and watermark.png")


if __name__ == "__main__":
    main()
