"""RoBERTa text encoder, written by hand, plus the tokenizer front-end (a
frozen copy of the port's models/text_encoder.py).

Module names follow HF `RobertaModel`'s state_dict under `text_encoder.`
(`embeddings.*`, `encoder.layer.{i}.*`, `pooler.dense`), so the reference's
keys load strictly. There are no hub weights: a local pretrained directory
gives HF's fast tokenizer, anything else the deterministic hash tokenizer.
Dropout (config.dropout) applies only when the forward gets a generator: SOC
passes none while the encoder is frozen, as the JAX package runs a frozen
encoder deterministic.
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .common import Dropout, Embedding, LayerNorm, Linear


@dataclasses.dataclass(frozen=True)
class RobertaConfig:
    vocab_size: int = 50265
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 514
    type_vocab_size: int = 1
    pad_token_id: int = 1
    layer_norm_eps: float = 1e-5
    dropout: float = 0.1


ROBERTA_CONFIGS = {
    "roberta-base": RobertaConfig(),
    "roberta-large": RobertaConfig(hidden_size=1024, num_layers=24, num_heads=16,
                                   intermediate_size=4096),
    "distilroberta-base": RobertaConfig(num_layers=6),
    # small config for CPU tests
    "roberta-tiny": RobertaConfig(vocab_size=1024, hidden_size=64, num_layers=2,
                                  num_heads=4, intermediate_size=128),
}


class RobertaEncoder(nn.Module):
    def __init__(self, config: RobertaConfig = RobertaConfig(),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        cfg, C = config, config.hidden_size
        self.config, self.dtype = cfg, dtype
        eps = cfg.layer_norm_eps
        self.embeddings = nn.ModuleDict({
            "word_embeddings": Embedding(cfg.vocab_size, C, std=0.02),
            "position_embeddings": Embedding(cfg.max_position_embeddings, C, std=0.02),
            "token_type_embeddings": Embedding(cfg.type_vocab_size, C, std=0.02),
            "LayerNorm": LayerNorm(C, eps=eps, dtype=dtype),
        })

        def layer():
            return nn.ModuleDict({
                "attention": nn.ModuleDict({
                    "self": nn.ModuleDict({
                        "query": Linear(C, C, dtype=dtype),
                        "key": Linear(C, C, dtype=dtype),
                        "value": Linear(C, C, dtype=dtype),
                    }),
                    "output": nn.ModuleDict({
                        "dense": Linear(C, C, dtype=dtype),
                        "LayerNorm": LayerNorm(C, eps=eps, dtype=dtype),
                    }),
                }),
                "intermediate": nn.ModuleDict({
                    "dense": Linear(C, cfg.intermediate_size, dtype=dtype)}),
                "output": nn.ModuleDict({
                    "dense": Linear(cfg.intermediate_size, C, dtype=dtype),
                    "LayerNorm": LayerNorm(C, eps=eps, dtype=dtype),
                }),
            })

        self.encoder = nn.ModuleDict(
            {"layer": nn.ModuleList(layer() for _ in range(cfg.num_layers))})
        self.pooler = nn.ModuleDict({"dense": Linear(C, C, dtype=dtype)})
        self.drop = Dropout(cfg.dropout)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                rng: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """input_ids, attention_mask: (B, S) int, mask 1 on real tokens; rng:
        the dropout generator (None: no dropout). Returns (last_hidden_state
        (B, S, H), pooler_output (B, H))."""
        drop = self.drop
        cfg, dt, emb = self.config, self.dtype, self.embeddings
        # RoBERTa position ids: incremental over non-pad tokens, offset by
        # padding_idx (the first real token gets index 2)
        mask_i = attention_mask.long()
        position_ids = torch.cumsum(mask_i, dim=1) * mask_i + cfg.pad_token_id
        h = (emb["word_embeddings"](input_ids.long()).to(dt)
             + emb["position_embeddings"](position_ids).to(dt)
             + emb["token_type_embeddings"](torch.zeros_like(mask_i)).to(dt))
        h = drop(emb["LayerNorm"](h), rng)

        pad_bias = torch.where(attention_mask[:, None, None, :] == 0, -1e9, 0.0)
        Hn = cfg.num_heads
        Dh = cfg.hidden_size // Hn
        B, S = input_ids.shape
        for lyr in self.encoder["layer"]:
            sa = lyr["attention"]["self"]
            q = sa["query"](h).view(B, S, Hn, Dh).transpose(1, 2)
            k = sa["key"](h).view(B, S, Hn, Dh).transpose(1, 2)
            v = sa["value"](h).view(B, S, Hn, Dh).transpose(1, 2)
            logits = (q @ k.transpose(-2, -1)) / math.sqrt(Dh)
            logits = logits + pad_bias.to(logits.dtype)
            attn = drop(torch.softmax(logits.float(), dim=-1).to(dt), rng)
            ctx = (attn @ v).transpose(1, 2).reshape(B, S, cfg.hidden_size)
            out = lyr["attention"]["output"]
            h = out["LayerNorm"](h + drop(out["dense"](ctx), rng))
            inter = F.gelu(lyr["intermediate"]["dense"](h))  # exact GELU
            out = lyr["output"]
            h = out["LayerNorm"](h + drop(out["dense"](inter), rng))
        pooled = torch.tanh(self.pooler["dense"](h[:, 0]))
        return h, pooled


class HashTokenizer:
    """Deterministic offline stand-in tokenizer (tests/synthetic only).

    bos=0, pad=1, eos=2; words hash into [10, vocab_size)."""

    def __init__(self, vocab_size: int = 50265):
        self.vocab_size = vocab_size

    def __call__(self, texts: List[str], max_len: Optional[int] = None):
        seqs = []
        for t in texts:
            ids = [0]
            for w in t.lower().split():
                hv = int(hashlib.md5(w.encode()).hexdigest()[:8], 16)
                ids.append(10 + hv % (self.vocab_size - 10))
            ids.append(2)
            seqs.append(ids)
        L = max_len or max(len(s) for s in seqs)
        input_ids = np.full((len(seqs), L), 1, np.int32)
        attn = np.zeros((len(seqs), L), np.int32)
        for i, s in enumerate(seqs):
            s = s[:L]
            input_ids[i, : len(s)] = s
            attn[i, : len(s)] = 1
        return input_ids, attn


def build_tokenizer(text_encoder_type: str, text_bucket: int = 32):
    """The hash tokenizer (the port's tokenizer wherever no pretrained
    directory is given). Returns fn(texts) -> (input_ids, attention_mask),
    int32 numpy arrays padded to `text_bucket`."""
    name = text_encoder_type.split("/")[-1]
    hasher = HashTokenizer(vocab_size=ROBERTA_CONFIGS.get(name, RobertaConfig()).vocab_size)

    def encode(texts: List[str]):
        return hasher(texts, max_len=text_bucket)

    return encode
