# RNN-T stateless decoder (predictor) and joiner as PyTorch modules.
#
# Port of sherpa_vietnamese_asr_tpu/models/rnnt.py. The decoder embeds a
# 2-token context and applies a grouped Conv1d + ReLU (icefall "stateless"
# decoder); the joiner projects encoder and decoder outputs to a shared
# joiner space and emits vocab logits through tanh.

from __future__ import annotations

import dataclasses

import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class RnntConfig:
    vocab_size: int = 2000
    context_size: int = 2
    decoder_dim: int = 512
    joiner_dim: int = 512
    encoder_out_dim: int = 256  # = ZipformerConfig.output_dim
    blank_id: int = 0
    unk_id: int = 2


class Decoder(nn.Module):
    """Embedding + grouped Conv1d(D, D, kernel=context_size, groups=D//4)."""

    def __init__(self, cfg: RnntConfig, device=None):
        super().__init__()
        d = cfg.decoder_dim
        self.embedding = nn.Parameter(
            torch.empty(cfg.vocab_size, d, device=device))
        # [D_out, D_in/G, K], the layout of torch's Conv1d and of the JAX tree
        self.conv_weight = nn.Parameter(
            torch.empty(d, 4, cfg.context_size, device=device))

    def forward(self, y: torch.Tensor) -> torch.Tensor:
        """y: [..., context_size] int token ids (>= 0) -> [..., decoder_dim].

        The grouped convolution over exactly context_size positions is one
        grouped product, the JAX package's formulation: on CUDA, cuDNN runs
        a grouped conv1d of more than one row as a kernel a group (128)."""
        emb = self.embedding[y]  # [..., K, D]
        d, in_per_g, k = self.conv_weight.shape
        groups = d // in_per_g
        emb_g = emb.reshape(*emb.shape[:-1], groups, in_per_g)      # [..., K, G, I]
        w_g = self.conv_weight.reshape(groups, d // groups, in_per_g, k)
        out = torch.einsum("...kgi,goik->...go", emb_g, w_g)
        return torch.relu(out.reshape(*emb.shape[:-2], d))


class Joiner(nn.Module):
    def __init__(self, cfg: RnntConfig, device=None):
        super().__init__()
        self.encoder_proj = nn.Linear(cfg.encoder_out_dim, cfg.joiner_dim,
                                      device=device)
        self.decoder_proj = nn.Linear(cfg.decoder_dim, cfg.joiner_dim,
                                      device=device)
        self.output = nn.Linear(cfg.joiner_dim, cfg.vocab_size, device=device)
        self._kernel_layout = (None, None)  # (key, tensors)

    def kernel_layout(self):
        """(W_enc, b_enc, W_dec, b_dec, W_out, b_out) as contiguous float32,
        weights [d_in, d_out]: the layout of the CUDA beam kernel. Built on
        first use and kept until a parameter is moved or changed in place."""
        params = [p for m in (self.encoder_proj, self.decoder_proj, self.output)
                  for p in (m.weight, m.bias)]
        key = tuple((id(p), p.data_ptr(), p._version) for p in params)
        if self._kernel_layout[0] != key:
            with torch.no_grad():
                tensors = tuple((p.t() if p.dim() == 2 else p).to(torch.float32)
                                .contiguous() for p in params)
            self._kernel_layout = (key, tensors)
        return self._kernel_layout[1]

    def forward(self, encoder_out: torch.Tensor,
                decoder_out: torch.Tensor) -> torch.Tensor:
        h = torch.tanh(self.encoder_proj(encoder_out)
                       + self.decoder_proj(decoder_out))
        return self.output(h)


def decoder_forward(decoder: Decoder, y: torch.Tensor) -> torch.Tensor:
    """Stateless decoder. y: [..., context_size] ids -> [..., decoder_dim]."""
    return decoder(y)


def joiner_forward(joiner: Joiner, encoder_out: torch.Tensor,
                   decoder_out: torch.Tensor) -> torch.Tensor:
    """Joiner logits. encoder_out [..., E], decoder_out [..., D] -> [..., V]."""
    return joiner(encoder_out, decoder_out)
