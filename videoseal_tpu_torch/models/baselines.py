"""Third-party watermarking baselines, counterpart of
``videoseal_tpu/models/baselines.py``.

TorchScript exports of HiDDeN, MBRS, CIN, WAM and TrustMark behind the
VideoSeal interface (embed / detect / extract_message on NHWC [0, 1] frames),
each with its method's scaling, processing size and input normalisation.
The exports are torch graphs, so here they run on the card
(``torch.jit.load(path, map_location=device)``), around the port's resizes.

Use: ``build_baseline("baseline/hidden", "encoder.jit.pt", "decoder.jit.pt")``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.resize import resize_bilinear

# scaling_w, scaling_i, processing size and input normalisation per method
_BASELINE_SPECS = {
    "hidden": dict(scaling_w=0.2, scaling_i=1.0, img_size=128, norm="pm1"),
    "mbrs": dict(scaling_w=1.0, scaling_i=1.0, img_size=256, norm="pm1"),
    "cin": dict(scaling_w=1.0, scaling_i=1.0, img_size=128, norm="pm1"),
    "wam": dict(scaling_w=2.0, scaling_i=1.0, img_size=256, norm="imnet"),
    "trustmark": dict(scaling_w=1.0, scaling_i=1.0, img_size=256, norm="none"),
}
_DEFAULT_BITS = {"hidden": 48, "mbrs": 256, "cin": 30, "wam": 32, "trustmark": 100}
_IMNET_MEAN = (0.485, 0.456, 0.406)
_IMNET_STD = (0.229, 0.224, 0.225)


class TorchScriptBaseline:
    """A baseline's scripted embedder and extractor on `device` (the card
    unless the caller asks for the CPU)."""

    def __init__(self, method: str, embedder_path: str, extractor_path: str, nbits: int,
                 device="cuda"):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("TorchScriptBaseline runs on the CUDA device by default and "
                               "none is available; pass device='cpu' to run on the CPU")
        self.method = method
        self.spec = _BASELINE_SPECS[method]
        self.device = device
        self.embedder = torch.jit.load(embedder_path, map_location=device).eval()
        self.extractor = torch.jit.load(extractor_path, map_location=device).eval()
        self.nbits = nbits
        self.scaling_w = self.spec["scaling_w"]
        self._rng = np.random.default_rng(0)
        self._mean = torch.tensor(_IMNET_MEAN, device=device)
        self._std = torch.tensor(_IMNET_STD, device=device)

    def _norm(self, x: torch.Tensor) -> torch.Tensor:
        if self.spec["norm"] == "pm1":
            return x * 2 - 1
        if self.spec["norm"] == "imnet":
            return (x - self._mean) / self._std
        return x

    def _denorm(self, x: torch.Tensor) -> torch.Tensor:
        if self.spec["norm"] == "pm1":
            return (x + 1) / 2
        if self.spec["norm"] == "imnet":
            return x * self._std + self._mean
        return x

    def get_random_msg(self, bsz: int = 1) -> torch.Tensor:
        """(bsz, nbits) bits from the baseline's numpy generator (seeded 0)."""
        return torch.as_tensor(self._rng.integers(0, 2, (bsz, self.nbits)), device=self.device)

    def _resized(self, imgs) -> tuple[torch.Tensor, torch.Tensor]:
        x = torch.as_tensor(imgs, device=self.device).float()
        s = self.spec["img_size"]
        return x, resize_bilinear(x, s, s)

    def embed(self, imgs, msgs=None, is_video: bool = False) -> dict:
        """imgs (B|F, H, W, 3) in [0, 1]: embeds at the method's size and adds
        the scaled residual, resized back, at the frames' size."""
        x, x_res = self._resized(imgs)
        if msgs is None:
            msgs = self.get_random_msg(1 if is_video else x.shape[0])
        msgs = torch.as_tensor(msgs, device=self.device)
        m = msgs[:1].expand(x.shape[0], self.nbits) if is_video else msgs
        with torch.no_grad():
            out = self.embedder(self._norm(x_res).permute(0, 3, 1, 2), m.float())
        delta = self._denorm(out.permute(0, 2, 3, 1)) - x_res
        delta_full = resize_bilinear(delta, x.shape[-3], x.shape[-2])
        imgs_w = torch.clamp(x + self.scaling_w * delta_full, 0, 1)
        return {"imgs_w": imgs_w, "msgs": m, "preds_w": delta_full}

    def detect(self, imgs, is_video: bool = False) -> dict:
        """(B|F, 1 + nbits) logits; a zero detection logit is prepended where
        the export gives the bits alone."""
        _, x_res = self._resized(imgs)
        with torch.no_grad():
            preds = self.extractor(self._norm(x_res).permute(0, 3, 1, 2))
        if preds.shape[-1] == self.nbits:
            preds = torch.cat([preds.new_zeros((preds.shape[0], 1)), preds], dim=-1)
        return {"preds": preds}

    def extract_message(self, imgs, aggregation: str = "avg") -> torch.Tensor:
        """(1, nbits) int32 bits from the frames' mean bit logits."""
        preds = self.detect(imgs, is_video=True)["preds"][:, 1:]
        return (preds.mean(dim=0) > 0).to(torch.int32)[None]


def build_baseline(name: str, embedder_path: str | None = None,
                   extractor_path: str | None = None, nbits: int | None = None,
                   device="cuda") -> TorchScriptBaseline:
    """'baseline/<method>' -> the wrapped baseline. The TorchScript files are
    not in the repository: pass local paths."""
    method = name.split("/")[-1]
    if method not in _BASELINE_SPECS:
        raise NotImplementedError(f"baseline {method!r}; available: {sorted(_BASELINE_SPECS)}")
    if not embedder_path or not extractor_path:
        raise FileNotFoundError(
            f"baseline/{method} needs local TorchScript files: pass "
            "embedder_path=/path/encoder.jit.pt and extractor_path=/path/decoder.jit.pt")
    return TorchScriptBaseline(method, embedder_path, extractor_path,
                               nbits or _DEFAULT_BITS[method], device)
