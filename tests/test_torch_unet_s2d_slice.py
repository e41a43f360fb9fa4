"""The tiny card's bf16 slices with ``s2d_embedder`` set in both packages:
the port's planar (scored mode) and NHWC video paths and its chunk forward
against the JAX package's, on the tiny card with videoseal_1.0's top width
(z=16, the schedule (2, 2)).

Tolerances: u8 frames within 1 LSB on at most 1e-3 of the values or, where
bf16's noise moves more roundings, on at most twice the share where JAX's
own bf16 slice differs from its float32 one; logits within LOGIT_ATOL; the
chunk forward within JAX's bf16 noise as tests/test_torch_unet_s2d.py holds
it. Two wrong routes are the controls: the u8 rule refuses the upsample
without its border strips, the chunk forward's rule a replicate pad in
them."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from torch_port import LOGIT_ATOL, NBITS, jax_model_random, port_model, tiny_card

from videoseal_tpu.models.videoseal import VideoSeal as JaxVideoSeal
from videoseal_tpu_torch import pack_planar
from videoseal_tpu_torch.kernels import unet_s2d as us
from videoseal_tpu_torch.models import videoseal as vs_mod

torch.set_num_threads(1)

BF16_MEAN_FACTOR, BF16_MAX_FACTOR = 1.5, 2.0


# -- the slice: with_dtype("bfloat16") and s2d_embedder set in both packages -----------------

FP, HP, WP = 2, 72, 128           # planar frames
FV, HV, WV = 5, 72, 120           # NHWC video
# u8 frames within 1 LSB on at most U8_SHARE of the values or, where bf16's
# noise moves more roundings (JAX's own bf16 slice differs from its float32
# one on 4.3e-3 of the video's values on this card), on at most
# SLICE_NOISE_FACTOR times the share where JAX's bf16 slice differs from its
# float32 one (chip_smoke.py's rule for the card against the CPU)
U8_SHARE, SLICE_NOISE_FACTOR = 1e-3, 2


@pytest.fixture(scope="module")
def slice_runs():
    """The tiny card with videoseal_1.0's top width (z=16: the schedule
    (2, 2), each level four phases) in both packages, their slices and
    their chunk forwards, and JAX's float32 slice (its bf16 noise)."""
    card = tiny_card(img_size=128)
    card["embedder"]["params"]["unet"]["z_channels"] = 16
    jm = jax_model_random(card, seed=31)
    pm = port_model(card, jm)
    j16, p16 = jm.with_dtype("bfloat16"), pm.with_dtype("bfloat16")
    j16 = JaxVideoSeal(j16.embedder_spec, j16.extractor_spec, j16.embedder_vars,
                       j16.extractor_vars, j16.attenuation,
                       dataclasses.replace(j16.cfg, s2d_embedder=True),
                       scaling_w=j16.scaling_w, scaling_i=j16.scaling_i, card=j16.card)
    p16.cfg = dataclasses.replace(p16.cfg, s2d_embedder=True)
    assert j16.cfg.fused_embedder and p16.cfg.fused_embedder
    rng = np.random.default_rng(32)
    planar = rng.integers(0, 256, (FP, HP, WP, 3), np.uint8)
    video = rng.integers(0, 256, (FV, HV, WV, 3), np.uint8)
    msgs = rng.integers(0, 2, (1, NBITS)).astype(np.int32)
    from videoseal_tpu.kernels.fused_planar import pack_planar as jax_pack
    kw = dict(lowres_attenuation=True, fused_detect=True)
    jp = j16.embed_detect_planar(jax_pack(planar), HP, WP, msgs=jnp.asarray(msgs),
                                 interpret=True, **kw)
    jv = j16.embed(video, msgs=jnp.asarray(msgs), is_video=True)
    from videoseal_tpu.models.videoseal import _make_run_embedder as jax_run
    keys = rng.uniform(0, 1, (4, 128, 128, 3)).astype(np.float32)
    km = rng.integers(0, 2, (4, NBITS)).astype(np.int32)
    want = {f"embedder{t}": np.asarray(jax_run(m.embedder_spec.module, m.cfg, m.embedder_vars)(
        (jnp.asarray(keys), jnp.asarray(km))), np.float32)
        for t, m in (("", j16), ("_f32", jm))}
    want.update({"planar": (np.asarray(jp["imgs_w"]), np.asarray(jp["preds"])),
                 "video": (np.asarray(jv["imgs_w"]),
                           np.asarray(j16.detect(jv["imgs_w"])["preds"])),
                 "video_f32": np.asarray(jm.embed(video, msgs=jnp.asarray(msgs),
                                                  is_video=True)["imgs_w"]),
                 "planar_f32": np.asarray(jm.embed_detect_planar(
                     jax_pack(planar), HP, WP, msgs=jnp.asarray(msgs), interpret=True,
                     **kw)["imgs_w"])})
    tp = p16.embed_detect_planar(pack_planar(torch.from_numpy(planar)), HP, WP,
                                 msgs=torch.from_numpy(msgs).long(), **kw)

    def port_video():
        return p16.embed(torch.from_numpy(video), msgs=torch.from_numpy(msgs).long(),
                         is_video=True)["imgs_w"]

    def port_embedder():
        with torch.no_grad():
            return vs_mod._make_run_embedder(p16.embedder, p16.cfg)(
                (torch.from_numpy(keys), torch.from_numpy(km))).float().numpy()
    tv = port_video()
    got = {"planar": (tp["imgs_w"].numpy(), tp["preds"].float().numpy()),
           "video": (tv.numpy(), p16.detect(tv)["preds"].float().numpy()),
           "embedder": port_embedder()}
    # the port's video slice and chunk forward again, for the controls
    return want, got, {"video": lambda: port_video().numpy(), "embedder": port_embedder}


def _u8_rule(want: dict, path: str, tw: np.ndarray) -> tuple:
    """(largest difference, share of values that differ, the share's
    limit) of the port's u8 frames against JAX's bf16 ones on `path`."""
    jw = want[path][0]
    assert tw.dtype == np.uint8 and tw.shape == jw.shape
    d = np.abs(tw.astype(np.int16) - jw.astype(np.int16))
    share_max = max(U8_SHARE, SLICE_NOISE_FACTOR * float((want[f"{path}_f32"] != jw).mean()))
    return int(d.max()), float((d > 0).mean()), share_max


@pytest.mark.parametrize("path", ["planar", "video"])
def test_slice_s2d_u8_and_logits(slice_runs, path):
    want, got, _ = slice_runs
    dmax, share, share_max = _u8_rule(want, path, got[path][0])
    assert dmax <= 1 and share <= share_max, (dmax, share, share_max)
    np.testing.assert_allclose(got[path][1], want[path][1], atol=LOGIT_ATOL, rtol=0)


def _embedder_rule(want: dict, got: np.ndarray) -> tuple:
    """(mean, max) of the port's chunk forward's distance from JAX's bf16
    one, each over its limit at JAX's own bf16 noise: at most 1 passes."""
    floor = np.abs(want["embedder"] - want["embedder_f32"])
    d = np.abs(got - want["embedder"])
    return (float(d.mean() / (BF16_MEAN_FACTOR * floor.mean())),
            float(d.max() / (BF16_MAX_FACTOR * floor.max())))


def test_slice_s2d_embedder_matches_jax(slice_runs):
    want, got, _ = slice_runs
    assert max(_embedder_rule(want, got["embedder"])) <= 1, _embedder_rule(want, got["embedder"])


def _strips_unfixed(orig):
    """`_up_strips` that hands back the composed cell conv's own border
    cells: the upsample without its exact border strips."""
    def strips(x, w32, b32, s):
        rows, cols = orig(x, w32, b32, s)
        y = F.conv2d(x.permute(0, 3, 1, 2), us.pack_up_conv(w32, s).to(x.dtype),
                     padding=1).permute(0, 2, 3, 1)
        if b32 is not None:
            y = y + b32.repeat(4 * s * s).to(y.dtype)
        return (torch.stack([y[:, :1], y[:, -1:]]).to(rows.dtype),
                torch.stack([y[:, :, :1], y[:, :, -1:]]).to(cols.dtype))
    return strips


def _replicate_pad(m, lo, hi):
    """`_reflected` with the edge row copied (a replicate pad)."""
    return m[([0] if lo else []) + list(range(m.shape[0])) + ([m.shape[0] - 1] if hi else [])]


def test_slice_s2d_rules_refuse_a_wrong_route(slice_runs, monkeypatch):
    """The controls: wrong s2d routes that keep the interior. With the
    border strips left out, the video's u8 frames differ from JAX's on more
    than the u8 rule's share (1.2e-2 against its 8.5e-3, each by 1 LSB;
    the right route 4.5e-3). With the strips padded by replication
    instead of reflection the u8 frames stay within the rule (4.8e-3) and
    the chunk forward, against JAX's bf16 noise, refuses it (its largest
    difference 4.5 times its limit)."""
    want, _, port = slice_runs
    with monkeypatch.context() as mp:
        mp.setattr(us, "_up_strips", _strips_unfixed(us._up_strips))
        dmax, share, share_max = _u8_rule(want, "video", port["video"]())
        assert dmax <= 1 and share > share_max, (dmax, share, share_max)
    with monkeypatch.context() as mp:
        mp.setattr(us, "_CONSTS", {})
        mp.setattr(us, "_reflected", _replicate_pad)
        mean, top = _embedder_rule(want, port["embedder"]())
        assert top > 1, (mean, top)
