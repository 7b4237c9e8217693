"""The CLIP text encoder (Stable Diffusion's conditioning tower) and its BPE
tokenizer.

Port of autodiffusion_tpu/models/clip_text.py (FrozenCLIPEmbedder,
ldm/modules/encoders/modules.py:137-163): the ViT-L/14 text transformer
(token and position embeddings, 12 pre-LayerNorm blocks with causal
self-attention and quick-GELU MLPs, a final LayerNorm) returning the last
hidden state [B, 77, 768] that the UNet cross-attends to. Parameter names
are those of HF's CLIPTextModel (``text_model.embeddings.token_embedding``,
``text_model.encoder.layers.{i}.self_attn.q_proj``, ...), so the
``cond_stage_model.transformer.*`` part of a CompVis checkpoint loads with
``load_state_dict(strict=True)``. The attention is plain PyTorch (77
causal tokens, D = 64), as the JAX package computes it.

:class:`ClipBPETokenizer` is the port's own copy of the JAX package's
tokenizer: vocab.json + merges.txt (or bpe_simple_vocab_16e6.txt.gz) in,
the padded 77-token ids CLIPTokenizer gives FrozenCLIPEmbedder out.

:class:`ClassEmbedder` is the class-conditional LDMs' conditioning tower
(modules.py:21-33): one embedding row a label, as a one-token context.
"""

from __future__ import annotations

import dataclasses
import gzip
import json
import re
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .attention import layer_norm
from .nn import linear

__all__ = ["CLIPTextConfig", "CLIPTextEncoder", "ClipBPETokenizer",
           "ClassEmbedder"]


@dataclasses.dataclass
class CLIPTextConfig:
    """ViT-L/14's text tower by default."""

    vocab_size: int = 49408
    width: int = 768
    layers: int = 12
    heads: int = 12
    mlp_ratio: int = 4
    max_length: int = 77


class _Attention(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q_proj = nn.Linear(width, width)
        self.k_proj = nn.Linear(width, width)
        self.v_proj = nn.Linear(width, width)
        self.out_proj = nn.Linear(width, width)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        b, t, c = x.shape
        hd = c // self.heads
        q, k, v = (linear(m, x).reshape(b, t, self.heads, hd).transpose(1, 2)
                   for m in (self.q_proj, self.k_proj, self.v_proj))
        # the logits in the compute dtype, then float32 for the scale, the
        # causal mask and the softmax (clip_text.py:61-63)
        logits = torch.matmul(q, k.transpose(-1, -2)).float() * hd ** -0.5
        w = torch.softmax(logits + mask, dim=-1).to(v.dtype)
        out = torch.matmul(w, v).transpose(1, 2).reshape(b, t, c)
        return linear(self.out_proj, out)


class _MLP(nn.Module):
    def __init__(self, width: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(width, hidden)
        self.fc2 = nn.Linear(hidden, width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = linear(self.fc1, x)
        return linear(self.fc2, h * torch.sigmoid(1.702 * h))   # quick-GELU


class _Layer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.self_attn = _Attention(cfg.width, cfg.heads)
        self.layer_norm1 = nn.LayerNorm(cfg.width)
        self.mlp = _MLP(cfg.width, cfg.width * cfg.mlp_ratio)
        self.layer_norm2 = nn.LayerNorm(cfg.width)

    def forward(self, h: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        h = h + self.self_attn(layer_norm(self.layer_norm1, h), mask)
        return h + self.mlp(layer_norm(self.layer_norm2, h))


class _Embeddings(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.width)
        self.position_embedding = nn.Embedding(cfg.max_length, cfg.width)
        # HF keeps the position ids as a buffer, and CompVis checkpoints
        # carry it: a state dict of the published layout loads strictly
        self.register_buffer("position_ids",
                             torch.arange(cfg.max_length)[None])


class _Encoder(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.layers = nn.ModuleList([_Layer(cfg) for _ in range(cfg.layers)])


class _TextTransformer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.embeddings = _Embeddings(cfg)
        self.encoder = _Encoder(cfg)
        self.final_layer_norm = nn.LayerNorm(cfg.width)


class CLIPTextEncoder(nn.Module):
    """forward(input_ids [B, T] int) -> last hidden state [B, T, width]
    float32. Computes in ``dtype``; LayerNorms and the softmax in
    float32."""

    def __init__(self, config: CLIPTextConfig = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.config = config or CLIPTextConfig()
        self.dtype = dtype
        self.text_model = _TextTransformer(self.config)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        tm = self.text_model
        t = input_ids.shape[1]
        emb = tm.embeddings
        h = emb.token_embedding.weight.to(self.dtype)[input_ids.long()] \
            + emb.position_embedding.weight[:t].to(self.dtype)[None]
        mask = torch.full((t, t), float("-inf"), device=h.device).triu(1)
        for layer in tm.encoder.layers:
            h = layer(h, mask)
        return F.layer_norm(h.float(), tm.final_layer_norm.normalized_shape,
                            tm.final_layer_norm.weight,
                            tm.final_layer_norm.bias,
                            tm.final_layer_norm.eps)


class ClassEmbedder(nn.Module):
    """[B] int labels -> the [B, 1, D] one-token cross-attention context of
    the class-conditional LDMs (cin256-v2.yaml, cin-ldm-vq-f8.yaml).
    ``embedding.weight`` is CompVis's ``cond_stage_model.embedding.weight``
    (the state dict of ``cond_stage_model.*``)."""

    def __init__(self, embed_dim: int, n_classes: int = 1000):
        super().__init__()
        self.embedding = nn.Embedding(n_classes, embed_dim)

    def forward(self, y: torch.Tensor) -> torch.Tensor:
        return self.embedding(y.long())[:, None, :]


class ClipBPETokenizer:
    """Minimal CLIP byte-pair tokenizer from user-supplied vocab files.

    Accepts either the HF pair (vocab.json + merges.txt) or the original
    OpenAI ``bpe_simple_vocab_16e6.txt.gz``. Produces the padded 77-token
    ids FrozenCLIPEmbedder gets from CLIPTokenizer (modules.py:146-155).
    """

    def __init__(self, encoder: Dict[str, int], merges: List[Tuple[str, str]],
                 max_length: int = 77):
        self.encoder = encoder
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.max_length = max_length
        self.sot = encoder["<|startoftext|>"]
        self.eot = encoder["<|endoftext|>"]
        self.byte_encoder = _bytes_to_unicode()
        self.cache: Dict[str, str] = {}

    @classmethod
    def from_files(cls, vocab_json: str, merges_txt: str,
                   max_length: int = 77) -> "ClipBPETokenizer":
        with open(vocab_json) as f:
            encoder = json.load(f)
        opener = gzip.open if merges_txt.endswith(".gz") else open
        with opener(merges_txt, "rt") as f:
            lines = f.read().split("\n")
        merges = [tuple(l.split()) for l in lines
                  if l and not l.startswith("#") and len(l.split()) == 2]
        # CLIP uses only the first 49152-256-2 merges of the (longer)
        # bpe_simple_vocab_16e6 file; keeping the tail would let
        # out-of-vocab merges win, whose tokens the encoder lacks
        merges = merges[: 49152 - 256 - 2]
        return cls(encoder, merges, max_length)

    def _bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        while len(word) > 1:
            pairs = set(zip(word[:-1], word[1:]))
            best = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if best not in self.bpe_ranks:
                break
            first, second = best
            new_word: List[str] = []
            i = 0
            while i < len(word):
                if (i < len(word) - 1 and word[i] == first
                        and word[i + 1] == second):
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode_text(self, text: str) -> List[int]:
        text = " ".join(text.lower().strip().split())
        ids: List[int] = []
        for tok in re.findall(_CLIP_PRE_TOKEN_PAT, text):
            tok = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._bpe(tok).split(" ")
                       if t in self.encoder)
        return ids

    def __call__(self, texts: List[str]) -> np.ndarray:
        out = np.full((len(texts), self.max_length), self.eot, dtype=np.int32)
        for i, text in enumerate(texts):
            ids = [self.sot] + self.encode_text(text)[: self.max_length - 2] \
                + [self.eot]
            out[i, : len(ids)] = ids
        return out


# CLIP's pre-tokenizer pattern (simple_tokenizer.py): letters group
# ([\p{L}]+ -> [^\W\d_]+), digits split one at a time ([\p{N}] -> \d),
# punctuation runs grouped including underscore ([^\s\p{L}\p{N}]+ ->
# (?:[^\s\w]|_)+), so "photo4k" tokenizes as photo|4|k.
_CLIP_PRE_TOKEN_PAT = re.compile(
    r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"""
    r"""[^\W\d_]+|\d|(?:[^\s\w]|_)+""", re.IGNORECASE)


def _bytes_to_unicode() -> Dict[int, str]:
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(2 ** 8):
        if b not in bs:
            bs.append(b)
            cs.append(2 ** 8 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))
