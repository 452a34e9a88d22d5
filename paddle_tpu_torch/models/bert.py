"""BERT (encoder-only transformer), the pretraining flagship, in
PyTorch.

Counterpart of the JAX package's `models/bert.py`: `BertConfig`, `init`
(the same param names and layouts), `encode`, `mlm_logits`,
`pretrain_loss` (gathered and dense MLM formats, plus NSP) and
`make_batch`. The JAX package's `shard()` annotations have no
counterpart: its layout is what GSPMD makes of them, and the port
splits where the ops run.

Attention goes through `ops.attention.mha`: on CUDA with no
`attention_mask` it runs the K1 flash-attention kernels, forward and
backward; with one, the padding mask goes to the K2 kernels (additive
bias), forward and backward. Under a mesh with `sp` > 1
(`parallel/mesh.py::mesh_guard`), `mha` takes the ring instead: with
no mask, every layer's attention is `ring_splash`, K3 blocks merged by
logsumexp (see `ops/attention.py`). Under dp and tp (by
`models/common.py`'s helpers and `SPLIT_AXES`, which `init` records):
q, k, v and `mlp.up` are column-parallel, `attn.o` and `mlp.down` row-parallel,
the word embedding and the MLM head (with `mlm.bias`) vocab-parallel,
attention runs once per (dp, tp) rank, and the losses are the global
batch's: the MLM loss divides the sum over the dp ranks by the global
count of valid labels (the count differs between shards), NSP's mean
is the global one. Dropout draws from a
`torch.Generator`: its bits are not jax.random's, so parity checks run
with `deterministic=True`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.attention import mha
from ..parallel.mesh import refuse_process_ring
from .common import (ParamAxes, Params, ParamStore, dp_mean, dp_sum,
                     dropout, gelu, layer_norm, tp_dense, vocab_embed,
                     vocab_log_softmax, vocab_logits)

__all__ = ["BertConfig", "init", "param_shapes", "encode", "mlm_logits",
           "pretrain_loss", "make_batch", "MASK_ID"]

MASK_ID = 103  # the [MASK] token id make_batch writes at masked positions


@dataclasses.dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden: int = 768
    layers: int = 12
    heads: int = 12
    mlp_dim: int = 3072
    max_len: int = 512
    type_vocab: int = 2
    dropout: float = 0.1
    dtype: str = "bfloat16"  # activation dtype

    @staticmethod
    def base() -> "BertConfig":
        return BertConfig()

    @staticmethod
    def tiny() -> "BertConfig":
        return BertConfig(vocab_size=1024, hidden=64, layers=2, heads=4,
                          mlp_dim=128, max_len=64, dropout=0.0)

    @property
    def head_dim(self) -> int:
        return self.hidden // self.heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def train_flops_per_seq(self, seq_len: int, n_masked: int) -> float:
        """Training FLOPs per sequence: 3x forward; forward = 2*T*matmul
        params + attention quadratic term + masked-only vocab
        projection."""
        H, M, L = self.hidden, self.mlp_dim, self.layers
        matmul_params = L * (4 * H * H + 2 * H * M) + 2 * H * H
        fwd = (2 * seq_len * matmul_params
               + L * 4 * seq_len * seq_len * H
               + 2 * n_masked * self.vocab_size * H)
        return 3 * fwd


# The logical axes of the weights that `models/common.py`'s helpers
# split, by name within a layer ("layer{i}." dropped): `init` records
# them and the ops hand them to the helpers, one source for both.
SPLIT_AXES = {"embeddings.word": ("vocab", "embed"),
              "attn.q": ("embed", "heads"), "attn.k": ("embed", "heads"),
              "attn.v": ("embed", "heads"), "attn.o": ("heads", "embed"),
              "mlp.up": ("embed", "mlp"), "mlp.down": ("mlp", "embed"),
              "pooler": ("embed", "embed"),
              "mlm.transform": ("embed", "embed"), "nsp": ("embed", None)}


def _axes(name: str):
    return SPLIT_AXES[name.split(".", 1)[1] if name.startswith("layer")
                      else name]


def param_shapes(cfg: BertConfig) -> Dict[str, Tuple[int, ...]]:
    """{name: shape} of the params, as `init` makes them."""
    H, M = cfg.hidden, cfg.mlp_dim
    shapes = {"embeddings.word.w": (cfg.vocab_size, H),
              "embeddings.position.w": (cfg.max_len, H),
              "embeddings.type.w": (cfg.type_vocab, H),
              "embeddings.ln.scale": (H,), "embeddings.ln.bias": (H,)}

    def dense_(name, d_in, d_out):
        shapes[f"{name}.w"] = (d_in, d_out)
        shapes[f"{name}.b"] = (d_out,)

    def ln(name):
        shapes[f"{name}.scale"] = shapes[f"{name}.bias"] = (H,)

    for i in range(cfg.layers):
        p = f"layer{i}"
        for proj in "qkvo":
            dense_(f"{p}.attn.{proj}", H, H)
        ln(f"{p}.attn.ln")
        dense_(f"{p}.mlp.up", H, M)
        dense_(f"{p}.mlp.down", M, H)
        ln(f"{p}.mlp.ln")
    dense_("pooler", H, H)
    dense_("mlm.transform", H, H)
    ln("mlm.ln")
    shapes["mlm.bias"] = (cfg.vocab_size,)
    dense_("nsp", H, 2)
    return shapes


def init(generator: torch.Generator, cfg: BertConfig, device=None
         ) -> Tuple[Params, ParamAxes]:
    """Random f32 params with the JAX package's names, shapes, axes and
    scales (not its values: torch and jax draw different numbers).
    `device` defaults to cuda (see `resolve_device`)."""
    from .. import resolve_device

    s = ParamStore(generator, resolve_device(device))
    H = cfg.hidden
    s.embedding("embeddings.word", cfg.vocab_size, H,
                axes=SPLIT_AXES["embeddings.word"])
    s.embedding("embeddings.position", cfg.max_len, H, axes=(None, "embed"))
    s.embedding("embeddings.type", cfg.type_vocab, H, axes=(None, "embed"))
    s.layer_norm("embeddings.ln", H)
    for i in range(cfg.layers):
        p = f"layer{i}"
        for proj in "qkvo":
            s.dense(f"{p}.attn.{proj}", H, H, axes=_axes(f"{p}.attn.{proj}"))
        s.layer_norm(f"{p}.attn.ln", H)
        s.dense(f"{p}.mlp.up", H, cfg.mlp_dim, axes=_axes(f"{p}.mlp.up"))
        s.dense(f"{p}.mlp.down", cfg.mlp_dim, H,
                axes=_axes(f"{p}.mlp.down"))
        s.layer_norm(f"{p}.mlp.ln", H)
    s.dense("pooler", H, H, axes=SPLIT_AXES["pooler"])
    # MLM head: transform + tied-embedding output bias
    s.dense("mlm.transform", H, H, axes=SPLIT_AXES["mlm.transform"])
    s.layer_norm("mlm.ln", H)
    s.add("mlm.bias", torch.zeros(cfg.vocab_size, device=s.device),
          ("vocab",))
    s.dense("nsp", H, 2, axes=SPLIT_AXES["nsp"])
    return s.params, s.axes


def _dense(params: Params, name: str, x: torch.Tensor, act=None):
    """`tp_dense` of the dense `name`, split by its `SPLIT_AXES`."""
    return tp_dense(params, name, x, _axes(name), act)


def _attention(params: Params, prefix: str, x: torch.Tensor,
               mask: Optional[torch.Tensor], cfg: BertConfig,
               rng: Optional[torch.Generator],
               deterministic: bool) -> torch.Tensor:
    B, T, H = x.shape
    shape = (B, T, cfg.heads, cfg.head_dim)
    q, k, v = (_dense(params, f"{prefix}.{p}", x).reshape(shape)
               for p in "qkv")
    ctx = mha(q, k, v, mask=mask, scale=1.0 / math.sqrt(cfg.head_dim))
    out = _dense(params, f"{prefix}.o", ctx.reshape(B, T, H))
    return dropout(rng, out, cfg.dropout, deterministic)


def encode(params: Params, cfg: BertConfig, input_ids: torch.Tensor,
           token_type_ids: Optional[torch.Tensor] = None,
           attention_mask: Optional[torch.Tensor] = None,
           rng: Optional[torch.Generator] = None,
           deterministic: bool = True) -> torch.Tensor:
    """[B, T] ids -> [B, T, H] sequence output, activations in
    cfg.dtype. `attention_mask` [B, T] (> 0 = attend) becomes an additive
    [B, 1, 1, T] mask of -1e9 at f32 and -3e4 otherwise; None is the
    padding-free case and builds no mask at all."""
    refuse_process_ring("bert.encode")
    T = input_ids.shape[1]
    adt = cfg.torch_dtype
    if token_type_ids is None:
        token_type_ids = torch.zeros_like(input_ids)
    emb = (vocab_embed(params["embeddings.word.w"], input_ids,
                       "embeddings.word.w", SPLIT_AXES["embeddings.word"])
           + params["embeddings.position.w"][:T][None]
           + params["embeddings.type.w"][token_type_ids])
    x = layer_norm(params, "embeddings.ln", emb).to(adt)
    if attention_mask is None:
        amask = None
    else:
        neg = -1e9 if adt == torch.float32 else -3e4
        amask = torch.where(attention_mask[:, None, None, :] > 0,
                            torch.zeros((), device=x.device),
                            torch.full((), neg, device=x.device))
    for i in range(cfg.layers):
        p = f"layer{i}"
        a = _attention(params, f"{p}.attn", x, amask, cfg, rng,
                       deterministic)
        x = layer_norm(params, f"{p}.attn.ln", x + a)
        h = _dense(params, f"{p}.mlp.up", x, act=gelu)
        h = _dense(params, f"{p}.mlp.down", h)
        h = dropout(rng, h, cfg.dropout, deterministic)
        x = layer_norm(params, f"{p}.mlp.ln", x + h)
    return x


def mlm_logits(params: Params, cfg: BertConfig,
               seq_out: torch.Tensor) -> torch.Tensor:
    """Masked-LM logits over the vocab: transform, layer norm, then the
    tied word embeddings plus `mlm.bias`."""
    h = _dense(params, "mlm.transform", seq_out, act=gelu)
    h = layer_norm(params, "mlm.ln", h)
    return vocab_logits(h, params["embeddings.word.w"], params["mlm.bias"],
                        "embeddings.word.w", SPLIT_AXES["embeddings.word"])


def pretrain_loss(params: Params, cfg: BertConfig,
                  batch: Dict[str, torch.Tensor],
                  rng: Optional[torch.Generator] = None,
                  deterministic: bool = False) -> torch.Tensor:
    """Masked-LM + next-sentence loss (the BERT pretrain objective), a
    f32 scalar.

    Two MLM batch formats:
    - gathered: "masked_positions" [B, P] + "masked_labels" [B, P]
      (-100 = pad slot); only P positions reach the vocab projection.
    - dense: "mlm_labels" [B, T] with -100 for unmasked positions.
    "nsp_labels" [B], when present, adds the next-sentence loss.
    """
    seq = encode(params, cfg, batch["input_ids"],
                 batch.get("token_type_ids"), batch.get("attention_mask"),
                 rng=rng, deterministic=deterministic)
    if "masked_positions" in batch:
        pos = batch["masked_positions"].long()
        labels = batch["masked_labels"]
        gathered = torch.gather(
            seq, 1, pos[..., None].expand(-1, -1, seq.shape[-1]))
        logits = mlm_logits(params, cfg, gathered).float()
    else:
        labels = batch["mlm_labels"]
        logits = mlm_logits(params, cfg, seq).float()
    valid = labels >= 0
    lab = torch.where(valid, labels, torch.zeros_like(labels)).long()
    logp = vocab_log_softmax(logits)
    tok_ll = torch.gather(logp, -1, lab[..., None])[..., 0]
    mlm = -dp_sum(tok_ll * valid) / dp_sum(valid).clamp(min=1)
    if "nsp_labels" in batch:
        cls = torch.tanh(_dense(params, "pooler", seq[:, 0]).float())
        nsp_logits = _dense(params, "nsp", cls.to(seq.dtype)).float()
        nsp_lp = F.log_softmax(nsp_logits, dim=-1)
        nsp_ll = torch.gather(nsp_lp, 1, batch["nsp_labels"].long()[:, None])
        return mlm - dp_mean(nsp_ll)
    return mlm


def make_batch(rng: Union[torch.Generator, np.random.RandomState],
               cfg: BertConfig, batch_size: int,
               seq_len: Optional[int] = None,
               max_predictions: Optional[int] = None,
               device=None) -> Dict[str, torch.Tensor]:
    """Synthetic pretraining batch in the gathered format (the benchmark
    input), int64 tensors on `device` (default: the generator's device
    for a torch.Generator, cuda for numpy). `max_predictions` defaults to
    int(0.15 * T) + 1, as the JAX package's; per row, the first P
    positions of a random permutation are masked (sorted) and their
    ids set to MASK_ID. No attention_mask: benchmark batches are
    padding-free, which selects the maskless flash-attention path."""
    from .. import resolve_device

    B = batch_size
    T = seq_len or cfg.max_len
    P = max_predictions or max(1, int(0.15 * T) + 1)
    if isinstance(rng, torch.Generator):
        dev = rng.device
        ids = torch.randint(0, cfg.vocab_size, (B, T), generator=rng,
                            device=dev)
        perm = torch.argsort(torch.rand(B, T, generator=rng, device=dev),
                             dim=1)
        nsp = torch.randint(0, 2, (B,), generator=rng, device=dev)
        target = resolve_device(dev if device is None else device)
    else:
        ids = torch.from_numpy(rng.randint(0, cfg.vocab_size, (B, T)))
        perm = torch.from_numpy(np.stack([rng.permutation(T)
                                          for _ in range(B)]))
        nsp = torch.from_numpy(rng.randint(0, 2, (B,)))
        target = resolve_device(device)
    pos = torch.sort(perm[:, :P].long(), dim=1).values
    ids = ids.long()
    batch = {"input_ids": ids.scatter(1, pos, MASK_ID),
             "token_type_ids": torch.zeros_like(ids),
             "masked_positions": pos,
             "masked_labels": ids.gather(1, pos),
             "nsp_labels": nsp.long()}
    return {k: v.to(target) for k, v in batch.items()}
