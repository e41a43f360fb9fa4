"""Message processor, counterpart of ``videoseal_tpu/modules/msg_processor.py``.

binary+concat: the `msg_embeddings` table (2*nbits, hidden) holds one row
per (bit, value). The embedding of message m is the even rows' sum plus
m @ (odd - even): a constant plus one matmul instead of a gather-and-sum.
"""

from __future__ import annotations

import torch
from torch import nn


class MsgProcessor(nn.Module):
    def __init__(self, nbits: int, hidden_size: int,
                 msg_processor_type: str = "binary+concat"):
        super().__init__()
        if msg_processor_type != "binary+concat":
            raise NotImplementedError(
                f"msg_processor_type {msg_processor_type!r}: ported with the "
                "other cards (ROADMAP.md 1.2)")
        self.nbits = nbits
        self.hidden_size = hidden_size
        self.msg_embeddings = nn.Embedding(2 * nbits, hidden_size)

    def message_embedding(self, msgs: torch.Tensor) -> torch.Tensor:
        """(B, nbits) {0,1} -> (B, hidden) float32."""
        table = self.msg_embeddings.weight.float()
        even, odd = table[0::2], table[1::2]
        return even.sum(dim=0) + msgs.float() @ (odd - even)

    def forward(self, latents: torch.Tensor, msgs: torch.Tensor) -> torch.Tensor:
        """latents (B, C, h, w) NCHW; returns (B, C + hidden, h, w)."""
        emb = self.message_embedding(msgs).to(latents.dtype)
        b, _, h, w = latents.shape
        emb = emb[:, :, None, None].expand(b, self.hidden_size, h, w)
        return torch.cat([latents, emb], dim=1)


def get_random_msg(nbits: int, bsz: int = 1, nb_repetitions: int = 1,
                   generator: torch.Generator | None = None, device=None) -> torch.Tensor:
    """(bsz, nbits) int64 random bits drawn from `generator` (on the CPU).
    nb_repetitions > 1 draws nbits / nb_repetitions bits and tiles them."""
    if nbits % nb_repetitions:
        raise ValueError(f"nbits={nbits} is not a multiple of nb_repetitions={nb_repetitions}")
    aux = torch.randint(0, 2, (bsz, nbits // nb_repetitions), generator=generator)
    return aux.repeat(1, nb_repetitions).to(device)
