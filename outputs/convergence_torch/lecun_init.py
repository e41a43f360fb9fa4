"""`python -m videoseal_tpu_torch.train` with the port's random init replaced
by the JAX package's initializers (flax's lecun_normal for conv, transposed
conv and linear weights: a normal truncated at two deviations with variance
1 / fan_in; biases 0; the rest as `models/videoseal.init_weights` draws it).
When these logs were made the port's own init drew weights and biases
U(-1/sqrt(fan_in), 1/sqrt(fan_in)); `init_weights` has drawn flax's
initializers since (ROADMAP §3.46, closed), in this script's order, so the
script now changes nothing. It is kept as the record of how the logs
beside it were made. Run from the repository's root:

    python outputs/convergence_torch/lecun_init.py <train.py's flags>

stageA_lecun_init/ holds the recipe's 15,000 steps with this init.
"""

import os
import sys

import torch

sys.path.insert(0, os.getcwd())
from videoseal_tpu_torch import train  # noqa: E402
from videoseal_tpu_torch.models import videoseal  # noqa: E402

TRUNC_STD = 0.87962566103423978   # the unit normal's deviation truncated at +-2


def lecun_init(module: torch.nn.Module, generator: torch.Generator) -> None:
    with torch.no_grad():
        for m in module.modules():
            if hasattr(m, "init_weights"):
                m.init_weights(generator)
            if isinstance(m, (torch.nn.Conv2d, torch.nn.Conv3d, torch.nn.Linear,
                              torch.nn.ConvTranspose2d)):
                w = m.weight
                fan_in = (w.shape[0] * w[0, 0].numel()
                          if isinstance(m, torch.nn.ConvTranspose2d) else w[0].numel())
                torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
                w.mul_(fan_in ** -0.5 / TRUNC_STD)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, torch.nn.Embedding):
                m.weight.normal_(0.0, 1.0, generator=generator)


if __name__ == "__main__":
    videoseal.init_weights = lecun_init      # train.build_trainer imports it at call time
    train.main(sys.argv[1:])
