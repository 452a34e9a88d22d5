"""GPT (decoder-only transformer), optionally Mixture-of-Experts, in
PyTorch.

Counterpart of the JAX package's `models/gpt.py`: `GPTConfig`, `init`,
the full forward `apply` (differentiable: under grad its attention runs
the K1 forward and backward kernels on CUDA), `lm_loss` and
`make_batch`, and the decode phases over the paged KV cache:
`apply_prefill` / `apply_decode_step`, and KV reuse's
`apply_prefill_chunk` (chunked prefill) / `apply_verify_step`
(speculative verification).
Params are the JAX package's flat dict, by name and in its layouts:
per-layer params stacked on a leading [L] axis ("blk.wqkv" [L, H, 3H],
...), matrices applied as `x @ w`. The JAX package's `lax.scan` over the
stacked layers is a Python loop over l here.

With `n_experts` > 0 each block's MLP is Switch-style top-1 routing
with capacity (`_moe_mlp`), the reference's dispatch and combine
einsums in plain torch (the JAX package has no kernel for it). The
decode phases refuse such configs, as the JAX engine does at boot.

Under a mesh (`parallel/mesh.py::mesh_guard`):
- `sp` > 1: each block's causal attention is
  `ops/ring_attention.py::ring_attention` over the sp ring, as the JAX
  package's `_attention` does, except inside the pipeline's manual
  region, where it is `mha`;
- `pp` > 1 with `n_microbatches` > 0: `apply` runs the block stack
  through the GPipe pipeline (`parallel/pipeline.py`), S = pp stages
  of L / S layers;
- `ep` > 1: `_moe_mlp` splits the expert FFN along the experts with the
  ep ring's `split` and joins it with its `join`. On the in-process ring
  this computes the same products, bit for bit; the exchange of tokens
  between ranks that ep across cards needs waits for ROADMAP items 20a
  and 20e;
- `tp` > 1 (`models/common.py`'s helpers, by `SPLIT_AXES`, which
  `init` records): `wqkv` and `w1` column-parallel, `wo` and `w2`
  row-parallel, in every block, inside the pipeline's stages too (the
  JAX package leaves tp to GSPMD there); the experts' FFN split along
  "mlp" the same way; the token embedding and the tied LM head
  vocab-parallel, `lm_loss`'s log-softmax over the vocab ranks;
- `dp` > 1: attention once per (dp, tp) rank (`mha`), the pipeline's
  microbatches split over dp (so a pipelined MoE's capacity is a dp
  shard's), and `lm_loss` the global batch's mean.
The decode phases share the blocks' qkv and MLP (`_qkv`, `_mlp`) and
raise under dp or tp larger than 1: the JAX package's serving path
(`serving/decode.py`) builds no mesh and its decode phases no
`shard()`, so there is no split of them to port.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..ops.attention import mha
from ..ops.beam import beam_search
from ..ops.ring_attention import ring_attention
from ..parallel.mesh import current_mesh, refuse_dp_tp, refuse_process_ring
from ..parallel.pipeline import pipeline_apply
from ..core.ring import InProcessRing
from ..parallel.sharding import in_manual_region
from ..serving import kv_cache as kvc
from .common import (ParamAxes, Params, ParamStore, axis_ring, dp_mean, gelu,
                     layer_norm as _ln_named, raw_layer_norm, tp_linear,
                     vocab_embed, vocab_log_softmax, vocab_logits)

__all__ = ["GPTConfig", "init", "param_shapes", "apply", "lm_loss",
           "make_batch", "apply_prefill", "apply_decode_step",
           "apply_prefill_chunk", "apply_verify_step"]


@dataclasses.dataclass
class GPTConfig:
    vocab_size: int = 50304
    hidden: int = 768
    layers: int = 12
    heads: int = 12
    mlp_dim: int = 3072
    max_len: int = 1024
    n_experts: int = 0          # 0 = dense MLP; >0 = Switch top-1 MoE
    capacity_factor: float = 1.25
    dtype: str = "bfloat16"

    @staticmethod
    def tiny(n_experts: int = 0) -> "GPTConfig":
        return GPTConfig(vocab_size=512, hidden=64, layers=4, heads=4,
                         mlp_dim=128, max_len=128, n_experts=n_experts)

    @property
    def head_dim(self):
        return self.hidden // self.heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def train_flops_per_token(self, seq_len: int) -> float:
        H, M, L = self.hidden, self.mlp_dim, self.layers
        # top-1 MoE routes each token through exactly one expert, so its
        # per-token matmul FLOPs equal the dense MLP (router cost omitted)
        mlp = 2 * H * M
        per_layer = 4 * H * H + mlp + 2 * seq_len * H  # qkvo + mlp + attn
        return 3 * 2 * (L * per_layer + self.vocab_size * H)

    def forward_flops(self, tokens: int, context: int,
                      logit_rows: int) -> float:
        """Matmul FLOPs of one dense forward over `tokens` tokens that
        each attend to `context` keys (padding included: a prefill
        bucket's T, a decode row's gathered table), with the LM head on
        `logit_rows` rows: the serving phases' live-MFU numerator,
        which a captured CUDA graph cannot report. Per token and layer,
        qkvo 8 H^2, the MLP 4 H M and attention 4 context H."""
        H, M, L = self.hidden, self.mlp_dim, self.layers
        per_token = L * (8 * H * H + 4 * H * M + 4 * context * H)
        return float(tokens * per_token + 2 * logit_rows * H *
                     self.vocab_size)


def _refuse_for_decode(cfg: GPTConfig):
    """The decode paths serve a dense config on no dp or tp split."""
    if cfg.n_experts:
        raise ValueError("mixture-of-experts GPT configs have no decode "
                         "path (the JAX engine refuses them at boot): "
                         "serve a dense config (n_experts=0)")
    refuse_dp_tp("GPT's decode paths",
                 "the JAX package's serving path, serving/decode.py, runs "
                 "on no mesh: there is no split of them to port")


# The logical axes of the weights that `models/common.py`'s helpers
# split (a block's without its stacked "layer" axis): `init` records
# them and the blocks hand them to the helpers, one source for both.
SPLIT_AXES = {"wte.w": ("vocab", "embed"), "blk.wqkv": ("embed", "heads"),
              "blk.wo": ("heads", "embed"), "blk.w1": ("embed", "mlp"),
              "blk.w2": ("mlp", "embed")}


def param_shapes(cfg: GPTConfig) -> Dict[str, Tuple[int, ...]]:
    """{name: shape} of the config's params, as `init` makes them."""
    L, H, M, E = cfg.layers, cfg.hidden, cfg.mlp_dim, cfg.n_experts
    shapes = {
        "wte.w": (cfg.vocab_size, H), "wpe.w": (cfg.max_len, H),
        "blk.ln1.scale": (L, H), "blk.ln1.bias": (L, H),
        "blk.wqkv": (L, H, 3 * H), "blk.bqkv": (L, 3 * H),
        "blk.wo": (L, H, H), "blk.bo": (L, H),
        "blk.ln2.scale": (L, H), "blk.ln2.bias": (L, H),
    }
    if E:
        shapes.update({"blk.router": (L, H, E), "blk.w1": (L, E, H, M),
                       "blk.w2": (L, E, M, H)})
    else:
        shapes.update({"blk.w1": (L, H, M), "blk.b1": (L, M),
                       "blk.w2": (L, M, H), "blk.b2": (L, H)})
    shapes.update({"ln_f.scale": (H,), "ln_f.bias": (H,)})
    return shapes


def init(generator: torch.Generator, cfg: GPTConfig, device=None
         ) -> Tuple[Params, ParamAxes]:
    """Random f32 params with the JAX package's names, shapes and
    scales (not its values: torch and jax draw different numbers).
    Layer params are stacked on a leading [L] axis. `device` defaults
    to cuda (see `resolve_device`)."""
    from .. import resolve_device

    s = ParamStore(generator, resolve_device(device))
    s.embedding("wte", cfg.vocab_size, cfg.hidden, axes=SPLIT_AXES["wte.w"])
    s.embedding("wpe", cfg.max_len, cfg.hidden, axes=(None, "embed"))
    L, H, M = cfg.layers, cfg.hidden, cfg.mlp_dim

    def stacked(key, shape, scale, axes):
        s.add(key, s.normal((L,) + shape, scale), ("layer",) + axes)

    a = math.sqrt(2.0 / (H + H))
    stacked("blk.ln1.scale", (H,), 0.0, (None,))
    s.params["blk.ln1.scale"] += 1.0
    stacked("blk.ln1.bias", (H,), 0.0, (None,))
    stacked("blk.wqkv", (H, 3 * H), a, SPLIT_AXES["blk.wqkv"])
    stacked("blk.bqkv", (3 * H,), 0.0, ("heads",))
    stacked("blk.wo", (H, H), a / math.sqrt(2 * L), SPLIT_AXES["blk.wo"])
    stacked("blk.bo", (H,), 0.0, (None,))
    stacked("blk.ln2.scale", (H,), 0.0, (None,))
    s.params["blk.ln2.scale"] += 1.0
    stacked("blk.ln2.bias", (H,), 0.0, (None,))
    am = math.sqrt(2.0 / (H + M))
    if cfg.n_experts:
        E = cfg.n_experts
        stacked("blk.router", (H, E), 0.02, ("embed", None))
        stacked("blk.w1", (E, H, M), am, ("expert", "embed", "mlp"))
        stacked("blk.w2", (E, M, H), am / math.sqrt(2 * L),
                ("expert", "mlp", "embed"))
    else:
        stacked("blk.w1", (H, M), am, SPLIT_AXES["blk.w1"])
        stacked("blk.b1", (M,), 0.0, ("mlp",))
        stacked("blk.w2", (M, H), am / math.sqrt(2 * L), SPLIT_AXES["blk.w2"])
        stacked("blk.b2", (H,), 0.0, (None,))
    s.layer_norm("ln_f", H)
    return s.params, s.axes


def _ln(x, scale, bias, eps=1e-5):
    return raw_layer_norm(x, scale, bias, eps)


def _layer(params: Params, l: int) -> Params:
    """Layer l's slice of the stacked "blk.*" params."""
    return {k: v[l] for k, v in params.items() if k.startswith("blk.")}


def _linear(lp, x, w: str, b: str, act=None):
    """`act(x @ lp[w] + lp[b])`, split as `SPLIT_AXES[w]` says."""
    return tp_linear(x, lp[w], lp[b], w, SPLIT_AXES[w], act)


def _qkv(lp, y, cfg: GPTConfig, shape):
    qkv = _linear(lp, y, "blk.wqkv", "blk.bqkv")
    q, k, v = qkv.split(cfg.hidden, dim=-1)
    return q.view(shape), k.view(shape), v.view(shape)


def _mlp(lp, x):
    """The dense MLP of a block, prefill and decode steps included."""
    h = _linear(lp, x, "blk.w1", "blk.b1", act=gelu)
    return _linear(lp, h, "blk.w2", "blk.b2")


def _experts(ein, w1, w2):
    """The expert FFN on dispatched tokens: ein [E, C, H], w1 [E, H, M],
    w2 [E, M, H] -> [E, C, H]. Each expert's product is its own; over a
    ring that carries "mlp", each rank's slice of M, the partial
    products all-reduced."""
    ring = axis_ring("mlp")

    def ffn(w1, w2):
        h = gelu(torch.einsum("ech,ehm->ecm", ein, w1.to(ein.dtype)))
        return torch.einsum("ecm,emh->ech", h, w2.to(ein.dtype))

    if ring is None:
        return ffn(w1, w2)
    return ring.all_reduce([ffn(a, b) for a, b in zip(ring.split(w1, 2),
                                                      ring.split(w2, 1))])[0]


_ONE_RANK = InProcessRing(1)   # the experts' ring with no ep axis


def _moe_mlp(lp, x, cfg: GPTConfig):
    """Switch-style top-1 routing with capacity (dispatch/combine
    einsums), as the JAX package's `_moe_mlp`. Tokens are taken in
    row-major (b, t) order: a token's slot in its expert is its rank
    among the tokens routed there, and one at or past the capacity C is
    dropped (its output is 0). The expert FFN runs on the ep ring's
    shards of the experts (uneven when ep does not divide E; one shard
    of all of them with no ep ring), the counterpart of the JAX
    package's `shard(ein, ("expert", None, "embed"))`."""
    B, T, H = x.shape
    G = B * T
    E = cfg.n_experts
    C = max(1, int(cfg.capacity_factor * G / E))
    xt = x.reshape(G, H)
    logits = (xt @ lp["blk.router"].to(x.dtype)).float()
    probs = torch.softmax(logits, -1)
    gate, idx = probs.max(-1)                                 # [G]
    eo = F.one_hot(idx, E).float()                            # [G, E]
    pos = (torch.cumsum(eo, 0) - 1.0) * eo                    # slot in expert
    within = (pos < C) * eo                                   # under capacity
    # jax.nn.one_hot gives a zero row for a slot >= C, F.one_hot raises:
    # clamp, and `within` zeroes the dropped token's row
    slot = pos.sum(-1).long().clamp(max=C - 1)
    po = F.one_hot(slot, C).float() * within.sum(-1, keepdim=True)
    dispatch = torch.einsum("ge,gc->gec", within, po)         # [G, E, C]
    combine = dispatch * gate[:, None, None]
    ein = torch.einsum("gec,gh->ech", dispatch.to(x.dtype), xt)
    mesh = current_mesh()
    ring = mesh.rings.get("ep", _ONE_RANK) if mesh is not None else _ONE_RANK
    shards = zip(*(ring.split(t, 0, even=False)
                   for t in (ein, lp["blk.w1"], lp["blk.w2"])))
    out = ring.join([_experts(*sh) for sh in shards], 0)
    y = torch.einsum("gec,ech->gh", combine.to(x.dtype), out)
    return y.reshape(B, T, H)


def _block(lp, x, cfg: GPTConfig):
    """One transformer block with this layer's (unstacked) params."""
    B, T, H = x.shape
    h = _ln(x, lp["blk.ln1.scale"], lp["blk.ln1.bias"])
    q, k, v = _qkv(lp, h, cfg, (B, T, cfg.heads, cfg.head_dim))
    mesh = current_mesh()
    if mesh is not None and mesh.shape.get("sp", 1) > 1 \
            and not in_manual_region():
        # the JAX package's explicit ring over 'sp', except inside the
        # 'pp' pipeline's manual region
        ctx = ring_attention(q, k, v, mesh, axis="sp", causal=True)
    else:
        ctx = mha(q, k, v, causal=True, scale=1.0 / math.sqrt(cfg.head_dim))
    # (ctx @ wo + bo) added to x, where the decode paths add ctx @ wo
    # to h first, each as the JAX package's
    x = x + _linear(lp, ctx.reshape(B, T, H), "blk.wo", "blk.bo")
    h = _ln(x, lp["blk.ln2.scale"], lp["blk.ln2.bias"])
    if cfg.n_experts:
        return x + _moe_mlp(lp, h, cfg)
    return x + _mlp(lp, h)


def _blocks(params: Params, x: torch.Tensor, cfg: GPTConfig, layers: int):
    """The first `layers` blocks of the stacked "blk.*" params."""
    for l in range(layers):
        x = _block(_layer(params, l), x, cfg)
    return x


def apply(params: Params, cfg: GPTConfig, ids: torch.Tensor,
          n_microbatches: int = 0) -> torch.Tensor:
    """ids [B, T] -> logits [B, T, vocab], in cfg.dtype.

    n_microbatches > 0 under a mesh with pp > 1 runs the block stack
    through the GPipe pipeline over 'pp' (`parallel/pipeline.py`), B
    split into n_microbatches contiguous groups of rows; otherwise (and
    with 0) a loop over the layers."""
    refuse_process_ring("gpt.apply")
    B, T = ids.shape
    x = (vocab_embed(params["wte.w"], ids, "wte.w", SPLIT_AXES["wte.w"]) +
         params["wpe.w"][:T][None]).to(cfg.torch_dtype)
    mesh = current_mesh()
    if n_microbatches and mesh is not None and mesh.shape.get("pp", 1) > 1:
        S, L = mesh.shape["pp"], cfg.layers
        if L % S:
            raise ValueError(f"layers {L} not divisible by pp {S}")
        if B % n_microbatches:
            raise ValueError(f"batch {B} not divisible by n_microbatches "
                             f"{n_microbatches}")
        # restack [L, ...] -> [S, L // S, ...]
        staged = {k: v.reshape((S, L // S) + v.shape[1:])
                  for k, v in params.items() if k.startswith("blk.")}
        xm = x.reshape((n_microbatches, B // n_microbatches) + x.shape[1:])
        x = pipeline_apply(
            lambda sp, xmb: _blocks(sp, xmb, cfg, L // S),
            staged, xm, mesh)
        x = x.reshape((B,) + x.shape[2:])
    else:
        x = _blocks(params, x, cfg, cfg.layers)
    x = _ln_named(params, "ln_f", x)
    return vocab_logits(x, params["wte.w"], None, "wte.w",
                        SPLIT_AXES["wte.w"])


def lm_loss(params: Params, cfg: GPTConfig, batch: Dict[str, torch.Tensor],
            rng: Optional[torch.Generator] = None,
            n_microbatches: int = 0) -> torch.Tensor:
    """Next-token cross entropy, a f32 scalar; batch = {"ids": [B, T+1]}.
    `rng` is unused (GPT has no dropout), as in the JAX package;
    `n_microbatches` as `apply` takes it."""
    ids = batch["ids"]
    logits = apply(params, cfg, ids[:, :-1], n_microbatches).float()
    logp = vocab_log_softmax(logits)
    ll = torch.gather(logp, -1, ids[:, 1:, None].long())[..., 0]
    return -dp_mean(ll)


def make_batch(generator: torch.Generator, cfg: GPTConfig, batch_size: int,
               seq_len: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """{"ids": [B, T+1]} uniform token ids (int64) on the generator's
    device; T defaults to cfg.max_len."""
    T = seq_len or cfg.max_len
    return {"ids": torch.randint(0, cfg.vocab_size, (batch_size, T + 1),
                                 generator=generator,
                                 device=generator.device)}


# ---------------------------------------------------------------------------
# Decode path (serving/decode.py): paged-KV prefill, single-token steps,
# prompt chunks and speculative verification. Every phase writes K/V into
# the pools IN PLACE (the JAX versions donate the pools and return new
# ones) and samples greedily through
# ops.beam.beam_search with beam_size=1, whose finished-freeze keeps a
# slot whose previous token is eos emitting eos.
# ---------------------------------------------------------------------------


def _beam_top1(prev_ids: torch.Tensor, logits: torch.Tensor,
               eos_id: int) -> torch.Tensor:
    """Greedy next token through the beam_search step (K=1).
    prev_ids [S], logits [S, vocab] -> [S] int64."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    out = beam_search(prev_ids[:, None],
                      torch.zeros(logp.shape[0], 1, device=logp.device),
                      logp[:, None, :], beam_size=1, end_id=int(eos_id),
                      is_accumulated=True)
    return out["selected_ids"][:, 0]


def apply_prefill(params: Params, cfg: GPTConfig, ids: torch.Tensor,
                  length: int, k_pool: torch.Tensor, v_pool: torch.Tensor,
                  block_table: torch.Tensor, *, block_size: int,
                  eos_id: int) -> torch.Tensor:
    """One prompt through the stack, filling its KV blocks.

    ids [1, T] (edge-padded to the prefill bucket T), length = true
    prompt length, block_table [MB] (the sequence's row). Writes every
    position's K/V into k_pool/v_pool in place and returns the first
    sampled token [1]. Padded tail positions write the null block or
    slots that later writes overwrite, and, being causally after every
    real position, never reach the last real position's logits.
    Attention is mha(causal=True): the K1-fwd kernel on CUDA.
    """
    _refuse_for_decode(cfg)
    B, T = ids.shape
    nh, hd = cfg.heads, cfg.head_dim
    x = (params["wte.w"][ids] + params["wpe.w"][:T][None]).to(k_pool.dtype)
    h = x
    for l in range(cfg.layers):
        lp = _layer(params, l)
        y = _ln(h, lp["blk.ln1.scale"], lp["blk.ln1.bias"])
        q, k, v = _qkv(lp, y, cfg, (B, T, nh, hd))
        kvc.write_prefill_kv(k_pool[l], k[0], block_table, block_size)
        kvc.write_prefill_kv(v_pool[l], v[0], block_table, block_size)
        ctx = mha(q, k, v, causal=True, scale=1.0 / math.sqrt(hd))
        ctx = ctx.reshape(B, T, cfg.hidden)
        h = h + ctx @ lp["blk.wo"].to(h.dtype) + lp["blk.bo"].to(h.dtype)
        y = _ln(h, lp["blk.ln2.scale"], lp["blk.ln2.bias"])
        h = h + _mlp(lp, y)
    x = _ln_named(params, "ln_f", h)
    last = max(int(length), 1) - 1
    logits = (x[0, last] @ params["wte.w"].T.to(x.dtype))[None]
    return _beam_top1(ids[0, last][None], logits, eos_id)


def apply_decode_step(params: Params, cfg: GPTConfig, ids: torch.Tensor,
                      positions: torch.Tensor, k_pool: torch.Tensor,
                      v_pool: torch.Tensor, block_tables: torch.Tensor, *,
                      block_size: int, eos_id: int) -> torch.Tensor:
    """One decode step for S resident slots.

    ids [S] (each slot's previous token), positions [S] (where this
    token's K/V lands = current sequence length), block_tables [S, MB].
    Writes each slot's K/V into the pools in place and returns the next
    tokens [S]. Every row's math touches only that row's activations
    and its own blocks, so a slot's tokens do not depend on what else
    shares the batch. Attention gathers each slot's blocks and masks
    positions past its own (plain torch, as the JAX package's step is
    plain XLA)."""
    _refuse_for_decode(cfg)
    S = ids.shape[0]
    nh, hd = cfg.heads, cfg.head_dim
    adt = k_pool.dtype
    x = (params["wte.w"][ids] + params["wpe.w"][positions]).to(adt)
    scale = 1.0 / math.sqrt(hd)
    h = x
    for l in range(cfg.layers):
        lp = _layer(params, l)
        y = _ln(h, lp["blk.ln1.scale"], lp["blk.ln1.bias"])
        q, k, v = _qkv(lp, y, cfg, (S, nh, hd))
        kvc.write_token_kv(k_pool[l], k, block_tables, positions, block_size)
        kvc.write_token_kv(v_pool[l], v, block_tables, positions, block_size)
        keys = kvc.gather_kv(k_pool[l], block_tables)  # [S, M, nh, hd]
        vals = kvc.gather_kv(v_pool[l], block_tables)
        scores = torch.einsum("snd,smnd->snm", q, keys) * scale
        m = keys.shape[1]
        mask = torch.arange(m, device=ids.device)[None, :] \
            <= positions[:, None]
        scores = torch.where(mask[:, None, :], scores, -1e9)
        att = torch.softmax(scores.float(), dim=-1)
        ctx = torch.einsum("snm,smnd->snd", att.to(adt), vals)
        ctx = ctx.reshape(S, cfg.hidden)
        h = h + ctx @ lp["blk.wo"].to(h.dtype) + lp["blk.bo"].to(h.dtype)
        y = _ln(h, lp["blk.ln2.scale"], lp["blk.ln2.bias"])
        h = h + _mlp(lp, y)
    x = _ln_named(params, "ln_f", h)
    logits = x @ params["wte.w"].T.to(x.dtype)          # [S, vocab]
    return _beam_top1(ids, logits, eos_id)


def apply_prefill_chunk(params: Params, cfg: GPTConfig, ids: torch.Tensor,
                        start: torch.Tensor, length: torch.Tensor,
                        k_pool: torch.Tensor, v_pool: torch.Tensor,
                        block_table: torch.Tensor, *, block_size: int,
                        eos_id: int) -> torch.Tensor:
    """One fixed-size SLICE of a prompt through the stack (chunked
    prefill, serving/kv_reuse.py).

    ids [1, C] = the tokens at positions start..start+C-1 (edge-padded
    past `length`), start = the slice's first position, length = the
    true prompt length, both int32 device scalars so that a captured
    chunk step reads them from static buffers. Writes the slice's K/V
    into the sequence's blocks in place and attends gather-style over
    the block table with mask `key_pos <= start + i`, so earlier
    slices' (and prefix-cache reused blocks') K/V take part exactly as
    in a whole-prompt prefill: each row reads only pool state and its
    own activations, so chunked equals whole prefill, and reused equals
    recomputed prefixes, token for token. Returns tok [1], meaningful
    only on the slice holding position length-1. Attention is plain
    torch, as the JAX package's chunk step is plain XLA."""
    _refuse_for_decode(cfg)
    _, C = ids.shape
    nh, hd = cfg.heads, cfg.head_dim
    adt = k_pool.dtype
    pos = start.long() + torch.arange(C, device=ids.device)
    # the final slice's padded tail can run past the positional table;
    # clamp (those rows' outputs are never read, their K/V lands in the
    # null block or in slots later writes overwrite)
    x = (params["wte.w"][ids[0]] +
         params["wpe.w"][pos.clamp(max=cfg.max_len - 1)]).to(adt)
    scale = 1.0 / math.sqrt(hd)
    h = x
    for l in range(cfg.layers):
        lp = _layer(params, l)
        y = _ln(h, lp["blk.ln1.scale"], lp["blk.ln1.bias"])
        q, k, v = _qkv(lp, y, cfg, (C, nh, hd))
        kvc.write_chunk_kv(k_pool[l], k, block_table, start, block_size)
        kvc.write_chunk_kv(v_pool[l], v, block_table, start, block_size)
        keys = kvc.gather_kv(k_pool[l], block_table[None])[0]  # [M, nh, hd]
        vals = kvc.gather_kv(v_pool[l], block_table[None])[0]
        scores = torch.einsum("cnd,mnd->cnm", q, keys) * scale
        m = keys.shape[0]
        mask = torch.arange(m, device=ids.device)[None, :] <= pos[:, None]
        scores = torch.where(mask[:, None, :], scores, -1e9)
        att = torch.softmax(scores.float(), dim=-1)
        ctx = torch.einsum("cnm,mnd->cnd", att.to(adt), vals)
        ctx = ctx.reshape(C, cfg.hidden)
        h = h + ctx @ lp["blk.wo"].to(h.dtype) + lp["blk.bo"].to(h.dtype)
        y = _ln(h, lp["blk.ln2.scale"], lp["blk.ln2.bias"])
        h = h + _mlp(lp, y)
    x = _ln_named(params, "ln_f", h)
    # a device index: no host sync, so the step can be captured
    last = (length.long() - 1 - start.long()).clamp(0, C - 1).view(1)
    logits = x.index_select(0, last) @ params["wte.w"].T.to(x.dtype)
    return _beam_top1(ids[0].index_select(0, last), logits, eos_id)


def apply_verify_step(params: Params, cfg: GPTConfig, ids: torch.Tensor,
                      positions: torch.Tensor, k_pool: torch.Tensor,
                      v_pool: torch.Tensor, block_tables: torch.Tensor, *,
                      block_size: int, eos_id: int) -> torch.Tensor:
    """Speculative verification: W = k+1 tokens per slot in ONE step
    (serving/kv_reuse.py).

    ids [S, W] = each slot's [last_token, d_1..d_k] (its previous real
    token, then the draft model's k proposals), positions [S] = each
    slot's next KV write position. Row j writes its K/V at position
    positions+j and attends `key_pos <= positions + j`, so output j is
    the token a plain apply_decode_step sequence gives after feeding
    ids[:, :j+1] one at a time; kv_reuse.accept_length compares the
    drafts with these outputs. A rejected position's K/V stays in the
    pool until the next real write there, before any mask lets it be
    read. Sampling goes through the same beam_search step as decode, so
    an eos in the fed window freezes the rest of the row to eos.
    Returns tokens [S, W]."""
    _refuse_for_decode(cfg)
    S, W = ids.shape
    nh, hd = cfg.heads, cfg.head_dim
    adt = k_pool.dtype
    pos = positions.long()[:, None] + \
        torch.arange(W, device=ids.device)[None, :]
    x = (params["wte.w"][ids] +
         params["wpe.w"][pos.clamp(max=cfg.max_len - 1)]).to(adt)
    scale = 1.0 / math.sqrt(hd)
    h = x
    for l in range(cfg.layers):
        lp = _layer(params, l)
        y = _ln(h, lp["blk.ln1.scale"], lp["blk.ln1.bias"])
        q, k, v = _qkv(lp, y, cfg, (S, W, nh, hd))
        kvc.write_span_kv(k_pool[l], k, block_tables, positions, block_size)
        kvc.write_span_kv(v_pool[l], v, block_tables, positions, block_size)
        keys = kvc.gather_kv(k_pool[l], block_tables)  # [S, M, nh, hd]
        vals = kvc.gather_kv(v_pool[l], block_tables)
        scores = torch.einsum("swnd,smnd->swnm", q, keys) * scale
        m = keys.shape[1]
        mask = torch.arange(m, device=ids.device)[None, None, :] \
            <= pos[:, :, None]
        scores = torch.where(mask[:, :, None, :], scores, -1e9)
        att = torch.softmax(scores.float(), dim=-1)
        ctx = torch.einsum("swnm,smnd->swnd", att.to(adt), vals)
        ctx = ctx.reshape(S, W, cfg.hidden)
        h = h + ctx @ lp["blk.wo"].to(h.dtype) + lp["blk.bo"].to(h.dtype)
        y = _ln(h, lp["blk.ln2.scale"], lp["blk.ln2.bias"])
        h = h + _mlp(lp, y)
    x = _ln_named(params, "ln_f", h)
    logits = x @ params["wte.w"].T.to(x.dtype)          # [S, W, vocab]
    return _beam_top1(ids.reshape(S * W), logits.reshape(S * W, -1),
                      eos_id).reshape(S, W)
