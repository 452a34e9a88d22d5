"""Transformer NMT (encoder-decoder) with beam-search decoding, in
PyTorch.

Counterpart of the JAX package's `models/transformer.py`:
`TransformerConfig` (`big`, `tiny`), `init` (the same param names,
shapes and axes), `encode`, `decode` (output projection tied to
`tgt_emb.w`), `nmt_loss` (label smoothing, `tgt_len` validity),
`beam_search`, `greedy_decode` and `make_batch`. Padded batches carry
lengths: every encoder self-attention and cross-attention takes an
additive [B, 1, 1, S] mask of -1e9, which on CUDA runs the K2
flash-attention kernels (`ops.attention.mha`); the decoder's causal
self-attention runs K1. As in the reference, `cfg.dropout` is not
applied anywhere and `nmt_loss`'s `rng` is unused.

Under dp and tp (`models/common.py`'s helpers, by `SPLIT_AXES`, which
`init` records, as the JAX package's GSPMD splits its params by their
`init` axes): the embeddings' vocab rows are split (`vocab_embed`),
each attention's q, k and v are column-parallel over the heads and its
`o` row-parallel, each MLP's `up` column-parallel and its `down`
row-parallel, and `decode`'s tied output is vocab-parallel
(`vocab_logits`). Attention runs once per (dp, tp) rank on its rows and
heads (`mha`: the causal decoder self-attention on K1 by the
"splash_shardmap" route, the masked calls on K2 with the padding mask
split by rows). `nmt_loss` takes its log-probs over the vocab ranks
and divides the sum of the valid tokens' losses over the dp ranks by
the global count of valid tokens, which differs between the ranks'
rows. `encode` checks its batch against dp (`shard`, as the JAX
package's constraint there), so `beam_search` and `greedy_decode`
under dp need their sources, and so their B x beam rows, to split
over it.

`beam_search` is a Python loop over `max_len` steps with no KV cache,
re-running `decode` on the whole prefix, as the reference's `lax.scan`
does. Its top-k and its final ordering break ties as `lax.top_k` and
`jnp.argsort` do, lower index first, through stable sorts:
`torch.topk` promises no order among ties, and ties are common (dead
beams at -1e9, finished beams offering only eos).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.attention import mha
from ..ops.tensor import stable_top_k
from ..parallel.mesh import refuse_process_ring
from ..parallel.sharding import shard
from .common import (ParamAxes, Params, ParamStore, dp_sum, gelu, layer_norm,
                     tp_dense, vocab_embed, vocab_log_softmax, vocab_logits)

__all__ = ["TransformerConfig", "SPLIT_AXES", "init", "encode", "decode",
           "nmt_loss", "beam_search", "greedy_decode", "make_batch"]

_NEG = -1e9

# The logical axes of the weights that `models/common.py`'s helpers
# split, by the last part of the name ("dec0.cross.q" -> "q"): `init`
# records them and the ops hand them to the helpers, one source for
# both.
SPLIT_AXES = {"src_emb": ("vocab", "embed"), "tgt_emb": ("vocab", "embed"),
              "q": ("embed", "heads"), "k": ("embed", "heads"),
              "v": ("embed", "heads"), "o": ("heads", "embed"),
              "up": ("embed", "mlp"), "down": ("mlp", "embed")}


def _axes(name: str):
    return SPLIT_AXES[name.rsplit(".", 1)[-1]]


def _dense(params: Params, name: str, x: torch.Tensor, act=None):
    """`tp_dense` of the dense `name`, split by its `SPLIT_AXES`."""
    return tp_dense(params, name, x, _axes(name), act)


@dataclasses.dataclass
class TransformerConfig:
    src_vocab: int = 32000
    tgt_vocab: int = 32000
    hidden: int = 512
    enc_layers: int = 6
    dec_layers: int = 6
    heads: int = 8
    mlp_dim: int = 2048
    max_len: int = 256
    dropout: float = 0.1
    dtype: str = "bfloat16"  # activation dtype
    bos_id: int = 0
    eos_id: int = 1

    @staticmethod
    def big() -> "TransformerConfig":
        return TransformerConfig(hidden=1024, heads=16, mlp_dim=4096)

    @staticmethod
    def tiny() -> "TransformerConfig":
        return TransformerConfig(src_vocab=128, tgt_vocab=128, hidden=32,
                                 enc_layers=2, dec_layers=2, heads=2,
                                 mlp_dim=64, max_len=32, dropout=0.0)

    @property
    def head_dim(self) -> int:
        return self.hidden // self.heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def train_flops_per_seq(self, src_T: int, tgt_T: int) -> float:
        """Training FLOPs per (src, tgt) pair: 3x forward; forward = 2*T*
        matmul params + attention quadratic terms + logits projection
        (the JAX package's accounting)."""
        H, M = self.hidden, self.mlp_dim
        enc_params = self.enc_layers * (4 * H * H + 2 * H * M)
        dec_tgt_params = self.dec_layers * (6 * H * H + 2 * H * M)
        dec_src_params = self.dec_layers * (2 * H * H)
        fwd = (2 * src_T * enc_params
               + self.enc_layers * 4 * src_T * src_T * H
               + 2 * tgt_T * dec_tgt_params
               + 2 * src_T * dec_src_params
               + self.dec_layers * 4 * (tgt_T * tgt_T + tgt_T * src_T) * H
               + 2 * tgt_T * H * self.tgt_vocab)
        return 3 * fwd


def init(generator: torch.Generator, cfg: TransformerConfig, device=None
         ) -> Tuple[Params, ParamAxes]:
    """Random f32 params with the JAX package's names, shapes, axes and
    scales (not its values: torch and jax draw different numbers).
    `device` defaults to cuda (see `resolve_device`)."""
    from .. import resolve_device

    s = ParamStore(generator, resolve_device(device))
    H = cfg.hidden
    s.embedding("src_emb", cfg.src_vocab, H, axes=SPLIT_AXES["src_emb"])
    s.embedding("tgt_emb", cfg.tgt_vocab, H, axes=SPLIT_AXES["tgt_emb"])
    s.embedding("pos", cfg.max_len, H, axes=(None, "embed"))

    def attn(prefix):
        for proj in "qkvo":
            s.dense(f"{prefix}.{proj}", H, H, axes=SPLIT_AXES[proj])
        s.layer_norm(f"{prefix}.ln", H)

    def mlp(prefix):
        s.dense(f"{prefix}.up", H, cfg.mlp_dim, axes=SPLIT_AXES["up"])
        s.dense(f"{prefix}.down", cfg.mlp_dim, H, axes=SPLIT_AXES["down"])
        s.layer_norm(f"{prefix}.ln", H)

    for i in range(cfg.enc_layers):
        attn(f"enc{i}.self")
        mlp(f"enc{i}.mlp")
    for i in range(cfg.dec_layers):
        attn(f"dec{i}.self")
        attn(f"dec{i}.cross")
        mlp(f"dec{i}.mlp")
    s.layer_norm("enc_ln", H)
    s.layer_norm("dec_ln", H)
    return s.params, s.axes


def _mha(params: Params, prefix: str, q_in: torch.Tensor,
         kv_in: torch.Tensor, cfg: TransformerConfig,
         mask: Optional[torch.Tensor] = None,
         causal: bool = False) -> torch.Tensor:
    B, Tq, H = q_in.shape
    Tk = kv_in.shape[1]
    nh, hd = cfg.heads, cfg.head_dim
    q = _dense(params, f"{prefix}.q", q_in).reshape(B, Tq, nh, hd)
    k = _dense(params, f"{prefix}.k", kv_in).reshape(B, Tk, nh, hd)
    v = _dense(params, f"{prefix}.v", kv_in).reshape(B, Tk, nh, hd)
    ctx = mha(q, k, v, mask=mask, causal=causal, scale=1.0 / math.sqrt(hd))
    return _dense(params, f"{prefix}.o", ctx.reshape(B, Tq, H))


def _pad_mask(lengths: torch.Tensor, T: int,
              dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """[B] lengths -> additive [B, 1, 1, T] mask: 0 where attended, -1e9
    past each length."""
    keep = torch.arange(T, device=lengths.device)[None, :] < lengths[:, None]
    return torch.where(keep, 0.0, _NEG)[:, None, None, :].to(dtype)


def _embed(params: Params, cfg: TransformerConfig, table: str,
           ids: torch.Tensor) -> torch.Tensor:
    refuse_process_ring("transformer " + ("encode" if table == "src_emb"
                                          else "decode"))
    T = ids.shape[1]
    x = vocab_embed(params[f"{table}.w"], ids, f"{table}.w",
                    SPLIT_AXES[table]) * math.sqrt(cfg.hidden) \
        + params["pos.w"][:T][None]
    return x.to(cfg.torch_dtype)


def encode(params: Params, cfg: TransformerConfig, src_ids: torch.Tensor,
           src_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[B, S] source ids -> [B, S, H] memory in cfg.dtype."""
    x = shard(_embed(params, cfg, "src_emb", src_ids),
              ("batch", "seq", "embed"))
    mask = _pad_mask(src_len, src_ids.shape[1]) if src_len is not None \
        else None
    for i in range(cfg.enc_layers):
        p = f"enc{i}"
        a = _mha(params, f"{p}.self", x, x, cfg, mask=mask)
        x = layer_norm(params, f"{p}.self.ln", x + a)
        h = _dense(params, f"{p}.mlp.up", x, act=gelu)
        h = _dense(params, f"{p}.mlp.down", h)
        x = layer_norm(params, f"{p}.mlp.ln", x + h)
    return layer_norm(params, "enc_ln", x)


def decode(params: Params, cfg: TransformerConfig, tgt_ids: torch.Tensor,
           memory: torch.Tensor,
           src_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[B, T] target ids and [B, S, H] memory -> [B, T, tgt_vocab] logits
    in cfg.dtype, through the tied `tgt_emb.w`."""
    x = _embed(params, cfg, "tgt_emb", tgt_ids)
    cross_mask = _pad_mask(src_len, memory.shape[1]) \
        if src_len is not None else None
    for i in range(cfg.dec_layers):
        p = f"dec{i}"
        a = _mha(params, f"{p}.self", x, x, cfg, causal=True)
        x = layer_norm(params, f"{p}.self.ln", x + a)
        c = _mha(params, f"{p}.cross", x, memory, cfg, mask=cross_mask)
        x = layer_norm(params, f"{p}.cross.ln", x + c)
        h = _dense(params, f"{p}.mlp.up", x, act=gelu)
        h = _dense(params, f"{p}.mlp.down", h)
        x = layer_norm(params, f"{p}.mlp.ln", x + h)
    x = layer_norm(params, "dec_ln", x)
    return vocab_logits(x, params["tgt_emb.w"], None, "tgt_emb.w",
                        SPLIT_AXES["tgt_emb"])


def nmt_loss(params: Params, cfg: TransformerConfig,
             batch: Dict[str, torch.Tensor],
             rng: Optional[torch.Generator] = None,
             label_smoothing: float = 0.1) -> torch.Tensor:
    """Label-smoothed cross-entropy over the valid target tokens, a f32
    scalar. batch: src_ids [B, S], tgt_ids [B, T+1] (bos ... eos), and
    optionally src_len and tgt_len ([B]; token t is valid while
    t < tgt_len - 1). `rng` is unused, as in the reference."""
    del rng
    src_len = batch.get("src_len")
    memory = encode(params, cfg, batch["src_ids"], src_len)
    logits = decode(params, cfg, batch["tgt_ids"][:, :-1], memory,
                    src_len).float()
    targets = batch["tgt_ids"][:, 1:].long()
    T = targets.shape[1]
    if "tgt_len" in batch:
        valid = torch.arange(T, device=targets.device)[None, :] \
            < batch["tgt_len"][:, None] - 1
    else:
        valid = torch.ones(targets.shape, dtype=torch.bool,
                           device=targets.device)
    logp = vocab_log_softmax(logits)
    eps = label_smoothing
    nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
    smooth = -logp.mean(-1)
    tok_loss = (1 - eps) * nll + eps * smooth
    # the global batch's: dp ranks' sums over the global count
    return dp_sum(tok_loss * valid) / dp_sum(valid).clamp(min=1)


def beam_search(params: Params, cfg: TransformerConfig,
                src_ids: torch.Tensor,
                src_len: Optional[torch.Tensor] = None, beam_size: int = 4,
                max_len: int = 32, length_penalty: float = 0.6
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Static-shape beam search: top-k expansion, finished beams frozen
    (they extend only with eos, at no cost), final ranking by the
    GNMT length penalty ((5 + length) / 6) ** length_penalty. Returns
    (tokens [B, beam, max_len] int64, scores [B, beam] f32), best
    first."""
    B = src_ids.shape[0]
    K, V, eos = beam_size, cfg.tgt_vocab, cfg.eos_id
    dev = src_ids.device
    memory = encode(params, cfg, src_ids, src_len)
    mem_k = memory.repeat_interleave(K, dim=0)            # [B*K, S, H]
    src_len_k = src_len.repeat_interleave(K, dim=0) \
        if src_len is not None else None

    tokens = torch.full((B, K, max_len + 1), eos, dtype=torch.long,
                        device=dev)
    tokens[:, :, 0] = cfg.bos_id
    # only beam 0 is live at first (all beams are identical)
    scores = torch.where(torch.arange(K, device=dev)[None, :] == 0, 0.0,
                         _NEG).float().expand(B, K)
    finished = torch.zeros((B, K), dtype=torch.bool, device=dev)
    eos_only = torch.full((V,), _NEG, device=dev)
    eos_only[eos] = 0.0

    for t in range(max_len):
        flat = tokens.reshape(B * K, max_len + 1)[:, :max_len]
        logits = decode(params, cfg, flat, mem_k, src_len_k)
        logp = F.log_softmax(logits[:, t].float(), dim=-1).reshape(B, K, V)
        logp = torch.where(finished[..., None], eos_only, logp)
        cand = (scores[..., None] + logp).reshape(B, K * V)
        scores, top_idx = stable_top_k(cand, K)
        beam_idx, tok_idx = top_idx // V, top_idx % V
        tokens = torch.gather(tokens, 1, beam_idx[..., None].expand(
            B, K, max_len + 1))
        tokens[:, :, t + 1] = tok_idx
        finished = torch.gather(finished, 1, beam_idx) | (tok_idx == eos)

    lengths = (tokens[:, :, 1:] != eos).sum(-1) + 1
    lp = ((5.0 + lengths.float()) / 6.0) ** length_penalty
    norm = scores / lp
    order = torch.sort(-norm, dim=1, stable=True).indices
    tokens = torch.gather(tokens, 1, order[..., None].expand(
        B, K, max_len + 1))
    return tokens[:, :, 1:], torch.gather(norm, 1, order)


def greedy_decode(params: Params, cfg: TransformerConfig,
                  src_ids: torch.Tensor,
                  src_len: Optional[torch.Tensor] = None,
                  max_len: int = 32) -> torch.Tensor:
    """[B, max_len] tokens: beam search with one beam."""
    toks, _ = beam_search(params, cfg, src_ids, src_len, beam_size=1,
                          max_len=max_len)
    return toks[:, 0]


def make_batch(rng: Union[torch.Generator, np.random.RandomState],
               cfg: TransformerConfig, batch_size: int, src_T: int = 16,
               tgt_T: int = 16, device=None) -> Dict[str, torch.Tensor]:
    """Synthetic padded batch, int64 tensors on `device` (default: the
    generator's device for a torch.Generator, cuda for numpy): src_ids
    [B, src_T] and tgt_ids [B, tgt_T + 1] uniform in [2, vocab) with
    tgt_ids[:, 0] = bos, src_len uniform in [src_T // 2, src_T] and
    tgt_len in [tgt_T // 2, tgt_T], as the reference draws them (not its
    numbers: the generators differ)."""
    from .. import resolve_device

    B = batch_size
    if isinstance(rng, torch.Generator):
        dev = rng.device

        def randint(lo, hi, shape):
            return torch.randint(lo, hi, shape, generator=rng, device=dev)

        target = resolve_device(dev if device is None else device)
    else:
        def randint(lo, hi, shape):
            return torch.from_numpy(rng.randint(lo, hi, shape))

        target = resolve_device(device)
    src = randint(2, cfg.src_vocab, (B, src_T))
    tgt = randint(2, cfg.tgt_vocab, (B, tgt_T + 1))
    tgt[:, 0] = cfg.bos_id
    batch = {"src_ids": src, "tgt_ids": tgt,
             "src_len": randint(src_T // 2, src_T + 1, (B,)),
             "tgt_len": randint(tgt_T // 2, tgt_T + 1, (B,))}
    return {k: v.long().to(target) for k, v in batch.items()}
