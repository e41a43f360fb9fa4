"""A float64 forward and backward of the port stays float64 (the frames
mesh's tests hold the sharding's arithmetic in float64): the layers that
compute in float32 for float32 and bf16 input keep float64 input in
float64, and the bilinear Upsample resamples it exactly, not in bf16. Held
against float64 references to FLOAT64_ATOL, which float32 arithmetic (~1e-7)
and bf16 (~1e-3) miss by orders of magnitude."""

import numpy as np
import torch

from torch_port import TRAIN_NBITS as NBITS
from torch_port import TRAIN_SIZE as SIZE
from torch_port import port_train_mods, train_weights

FLOAT64_ATOL = 1e-12


def _x(shape, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).normal(size=shape))


def test_layers_keep_float64():
    from videoseal_tpu_torch.modules.common import GRN, Interpolate, channel_ln
    from videoseal_tpu_torch.modules.msg_processor import MsgProcessor
    from videoseal_tpu_torch.ops.resize import resize_bilinear, resize_matrix
    x = _x((2, 3, 6, 5))
    mh, mw = (resize_matrix(n, 2 * n, False, torch.float64) for n in (6, 5))
    want = torch.einsum("Hh,Ww,bchw->bcHW", mh, mw, x)
    got = Interpolate(2)(x)
    assert got.dtype == torch.float64
    torch.testing.assert_close(got, want, rtol=0, atol=FLOAT64_ATOL)
    y = x.permute(0, 2, 3, 1)
    torch.testing.assert_close(resize_bilinear(y, 12, 10, antialias=False),
                               want.permute(0, 2, 3, 1), rtol=0, atol=FLOAT64_ATOL)

    w, b = _x((3,), 1), _x((3,), 2)
    mu, var = x.mean(1, keepdim=True), x.var(1, correction=0, keepdim=True)
    want = (x - mu) / torch.sqrt(var + 1e-6) * w[:, None, None] + b[:, None, None]
    torch.testing.assert_close(channel_ln(x, w, b, 1), want, rtol=0, atol=FLOAT64_ATOL)

    grn = GRN(3).double()
    with torch.no_grad():
        grn.gamma.copy_(_x((1, 1, 1, 3), 3))
        grn.beta.copy_(_x((1, 1, 1, 3), 4))
    gx = torch.sqrt((y * y).sum(dim=(1, 2), keepdim=True))
    want = grn.gamma * (y * gx / (gx.mean(-1, keepdim=True) + 1e-6)) + grn.beta + y
    torch.testing.assert_close(grn(y), want, rtol=0, atol=FLOAT64_ATOL)

    mp = MsgProcessor(NBITS, 8, "binary+concat").double()
    with torch.no_grad():
        mp.msg_embeddings.weight.copy_(_x(mp.msg_embeddings.weight.shape, 5))
    msgs = torch.from_numpy(np.random.default_rng(6).integers(0, 2, (3, NBITS)))
    rows = 2 * torch.arange(NBITS) + msgs
    want = mp.msg_embeddings.weight[rows].sum(dim=1)
    torch.testing.assert_close(mp.message_embedding(msgs), want, rtol=0, atol=FLOAT64_ATOL)


def test_float64_embedder_gradient_is_linear():
    """A UNet whose convolutions mix frames (conv2p1d), float64: its
    parameters' gradient of sum(out * R) is the sum of the gradients of the
    two halves of R, as a linear backward gives (9e-4 of the largest apart
    when the bilinear Upsample ran bf16 inside)."""
    mods, _ = port_train_mods(train_weights(), False, conv_layer="conv2p1d",
                              dtype=torch.float64)
    emb = mods.embedder.train()
    rng = np.random.default_rng(1)
    inp = torch.from_numpy(rng.uniform(0, 1, (4, SIZE, SIZE, 1)))
    msgs = torch.from_numpy(rng.integers(0, 2, (4, NBITS)))
    r = _x((4, SIZE, SIZE, 1), 2)

    def grads(weight):
        emb.zero_grad()
        (emb(inp, msgs) * weight).sum().backward()
        return {n: p.grad.clone() for n, p in emb.named_parameters()}

    full = grads(r)
    halves = [grads(r * torch.tensor(m, dtype=r.dtype)[:, None, None, None])
              for m in ([1, 1, 0, 0], [0, 0, 1, 1])]
    scale = max(float(g.abs().max()) for g in full.values())
    for n, g in full.items():
        torch.testing.assert_close(halves[0][n] + halves[1][n], g, rtol=0,
                                   atol=FLOAT64_ATOL * scale, msg=n)
