"""Message processor, counterpart of ``videoseal_tpu/modules/msg_processor.py``.

`msg_processor_type` is "<type>+<aggregation>":

* binary: the `msg_embeddings` table (2*nbits, hidden) holds one row per
  (bit, value). The embedding of message m is the even rows' sum plus
  m @ (odd - even): a constant plus one matmul instead of a gather-and-sum;
* gaussian: the table is (nbits, hidden) and the embedding m @ table, for
  real-valued messages (`get_random_msg(msg_type="gaussian")`);
* concat appends the embedding to the latent's channels, add adds it (the
  hidden size is then the latent's width).
"""

from __future__ import annotations

import torch
from torch import nn


class MsgProcessor(nn.Module):
    def __init__(self, nbits: int, hidden_size: int,
                 msg_processor_type: str = "binary+concat"):
        super().__init__()
        self.msg_type, self.msg_agg = msg_processor_type.split("+")
        if not self.msg_type.startswith(("bin", "gau")):
            raise ValueError(f"Invalid msg_type: {self.msg_type}")
        if self.msg_agg not in ("concat", "add"):
            raise ValueError(f"Invalid msg_agg: {self.msg_agg}")
        self.nbits = nbits
        self.hidden_size = hidden_size
        rows = 2 * nbits if self.msg_type.startswith("bin") else nbits
        self.msg_embeddings = nn.Embedding(rows, hidden_size)

    def out_channels(self, latent_channels: int) -> int:
        """The channels of forward's output for a latent of that width."""
        return latent_channels + (self.hidden_size if self.msg_agg == "concat" else 0)

    def message_embedding(self, msgs: torch.Tensor) -> torch.Tensor:
        """(B, nbits) -> (B, hidden) float32 (float64 with a float64 table)."""
        w = self.msg_embeddings.weight
        table = w.to(torch.promote_types(w.dtype, torch.float32))
        if self.msg_type.startswith("gau"):
            return msgs.to(table.dtype) @ table
        even, odd = table[0::2], table[1::2]
        return even.sum(dim=0) + msgs.to(table.dtype) @ (odd - even)

    def forward(self, latents: torch.Tensor, msgs: torch.Tensor) -> torch.Tensor:
        """latents (B, C, h, w) NCHW; returns (B, out_channels(C), h, w)."""
        emb = self.message_embedding(msgs).to(latents.dtype)
        b, _, h, w = latents.shape
        emb = emb[:, :, None, None].expand(b, self.hidden_size, h, w)
        if self.msg_agg == "add":
            return latents + emb
        return torch.cat([latents, emb], dim=1)


def get_random_msg(nbits: int, bsz: int = 1, nb_repetitions: int = 1,
                   generator: torch.Generator | None = None, device=None,
                   msg_type: str = "binary") -> torch.Tensor:
    """(bsz, nbits) random messages drawn from `generator` (on the CPU):
    binary ones int64 bits (nb_repetitions > 1 draws nbits / nb_repetitions
    bits and tiles them), gaussian ones float32 rows of unit norm."""
    if msg_type.startswith("gau"):
        g = torch.randn((bsz, nbits), generator=generator)
        return (g / torch.linalg.vector_norm(g, dim=-1, keepdim=True)).to(device)
    if nbits % nb_repetitions:
        raise ValueError(f"nbits={nbits} is not a multiple of nb_repetitions={nb_repetitions}")
    aux = torch.randint(0, 2, (bsz, nbits // nb_repetitions), generator=generator)
    return aux.repeat(1, nb_repetitions).to(device)
