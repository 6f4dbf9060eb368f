"""wenet's attention decoders: TransformerDecoder and BiTransformerDecoder.

Port of cosyvoice_tpu/models/decoder.py: token embedding x sqrt(dim) plus
the absolute sinusoidal table, N pre-norm DecoderLayers (self-attention
under the causal and pad mask, cross-attention onto the encoder memory
under its pad mask, ReLU FFN), the final LayerNorm and the vocab output
layer; the bidirectional decoder adds a right-to-left decoder over
reversed labels.  Nothing in the shipped CosyVoice recipes builds one (the
speech LMs decode through their own stacks), but they are part of the
transformer stack's surface.

Parameter names follow the reference checkpoint (`embed.0`,
`decoders.{i}.{norm1,self_attn,norm2,src_attn,norm3,feed_forward}`,
`after_norm`, `output_layer`; `left_decoder.*` / `right_decoder.*`), so
load_transformer_decoder reads a reference state dict by name.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn

from cosyvoice_tpu_torch.models.conformer import sinusoidal_pos_emb
from cosyvoice_tpu_torch.models.llm_phoneme import DecoderLayer
from cosyvoice_tpu_torch.nn.dense import Dense
from cosyvoice_tpu_torch.nn.norm import LayerNorm
from cosyvoice_tpu_torch.ops.masks import make_non_pad_mask
from cosyvoice_tpu_torch.utils.checkpoint import load_by_name


class TransformerDecoder(nn.Module):
    def __init__(self, vocab_size: int, dim: int, heads: int = 4, linear_units: int = 2048,
                 num_blocks: int = 6, use_output_layer: bool = True,
                 src_attention: bool = True, key_bias: bool = True):
        super().__init__()
        self.dim = dim
        self.embed = nn.ModuleList([nn.Embedding(vocab_size, dim)])
        self.decoders = nn.ModuleList(
            DecoderLayer(dim, heads, linear_units, src_attention, key_bias)
            for _ in range(num_blocks))
        self.after_norm = LayerNorm(dim, 1e-5)
        self.output_layer = Dense(dim, vocab_size) if use_output_layer else None

    def forward(self, memory: torch.Tensor, memory_lens: torch.Tensor, ys_in: torch.Tensor,
                ys_in_lens: torch.Tensor) -> torch.Tensor:
        """memory [B, Tm, dim] (memory_lens [B] valid rows), ys_in [B, To]
        ids (ys_in_lens [B]) -> logits [B, To, vocab] (the hidden state
        without the output layer); pad rows carry no meaning."""
        To = ys_in.shape[1]
        dev = ys_in.device
        x = self.embed[0](ys_in)
        x = x * math.sqrt(self.dim) + sinusoidal_pos_emb(To, self.dim, dtype=x.dtype,
                                                         device=dev)
        sub = torch.arange(To, device=dev)[None, :] <= torch.arange(To, device=dev)[:, None]
        tgt_mask = sub[None] & make_non_pad_mask(ys_in_lens, To)[:, None, :]
        mem_mask = make_non_pad_mask(memory_lens, memory.shape[1])[:, None, :]
        for layer in self.decoders:
            x = layer(x, tgt_mask, memory, mem_mask)
        x = self.after_norm(x)
        return self.output_layer(x) if self.output_layer is not None else x


class BiTransformerDecoder(nn.Module):
    """A left-to-right decoder and, with r_num_blocks > 0, a right-to-left
    one over reversed labels (weighted by reverse_weight in the loss)."""

    def __init__(self, vocab_size: int, dim: int, heads: int = 4, linear_units: int = 2048,
                 num_blocks: int = 6, r_num_blocks: int = 0, use_output_layer: bool = True,
                 key_bias: bool = True):
        super().__init__()
        make = lambda n: TransformerDecoder(vocab_size, dim, heads, linear_units, n,
                                            use_output_layer, key_bias=key_bias)
        self.left_decoder = make(num_blocks)
        self.right_decoder = make(r_num_blocks) if r_num_blocks > 0 else None

    def forward(self, memory, memory_lens, ys_in, ys_in_lens,
                r_ys_in: Optional[torch.Tensor] = None, reverse_weight: float = 0.0):
        """-> (left logits, right logits or a zero scalar)."""
        l_x = self.left_decoder(memory, memory_lens, ys_in, ys_in_lens)
        r_x = torch.zeros((), dtype=l_x.dtype, device=l_x.device)
        if reverse_weight > 0.0 and self.right_decoder is not None:
            if r_ys_in is None:
                raise ValueError("a right-to-left pass needs r_ys_in")
            r_x = self.right_decoder(memory, memory_lens, r_ys_in, ys_in_lens)
        return l_x, r_x


def load_transformer_decoder(decoder: nn.Module, state_dict: dict, prefix: str = "") -> None:
    """Read a reference TransformerDecoder / BiTransformerDecoder state dict
    (its keys under `prefix`) into `decoder` by name."""
    load_by_name(decoder, {k[len(prefix):]: v for k, v in state_dict.items()
                           if k.startswith(prefix)}, "decoder")
