"""Beam search: one selection step, and the fluid path's three beam ops.

`beam_search` is the counterpart of the JAX package's
`ops/beam.py::beam_search` (the reference's operators/beam_search_op),
and the `beam_search` op of the fluid path calls it, as
`models/transformer.py` does. Beams are a fixed [B, K] lane; a
finished beam (its previous id equals end_id) offers exactly one
candidate, itself, with its unchanged score, so it keeps emitting
end_id; is_accumulated=False log-accumulates raw probabilities onto
pre_scores. end_id=-1 means no beam ever finishes.

Ties break to the lowest flat index, as jax.lax.top_k does: argmax for
beam_size 1 (torch.argmax returns the first maximum), a stable
descending sort otherwise (torch.topk does not promise an order among
ties).

`gather_tree` and `beam_search_decode` walk the recorded steps back
through their parent pointers (beam_search_decode_op.h's sentence
walk), a loop over T from the last step.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..core.registry import register_op
from .tensor import stable_top_k

__all__ = ["beam_search"]

_NEG_INF = -1e9


def beam_search(pre_ids: torch.Tensor, pre_scores: torch.Tensor,
                scores: torch.Tensor, *, beam_size: Optional[int] = None,
                end_id: int, is_accumulated: bool = True,
                ids: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
    """pre_ids [B, K] int, pre_scores [B, K], scores [B, K, W] candidate
    scores, optional ids [B, K, W] candidate ids (default: the class
    axis 0..W-1). Returns selected_ids / selected_scores / parent_idx,
    each [B, beam_size]."""
    if pre_ids.ndim == 1:
        pre_ids, pre_scores = pre_ids[None], pre_scores[None]
    if scores.ndim == 2:  # [K, W] single-sentence convention
        scores = scores[None]
    b, k, w = scores.shape
    beam_size = k if beam_size is None else int(beam_size)
    if ids is not None:
        cand_ids = ids.reshape(b, k, w).long()
    else:
        cand_ids = torch.arange(w, device=scores.device).expand(b, k, w)
    if not is_accumulated:
        scores = pre_scores[:, :, None] + \
            torch.log(torch.clamp(scores, min=1e-20))

    finished = pre_ids.long() == int(end_id)                 # [B, K]
    # built on the device with no host-to-device copy, so a step that
    # calls this can be captured as a CUDA graph
    keep_self = torch.arange(w, device=scores.device) == 0
    own = torch.where(keep_self, pre_scores[:, :, None].to(scores.dtype),
                      _NEG_INF)
    scores = torch.where(finished[:, :, None], own, scores)
    cand_ids = torch.where(finished[:, :, None], int(end_id), cand_ids)

    flat = scores.reshape(b, k * w)
    if beam_size == 1:
        top_idx = flat.argmax(dim=1, keepdim=True)
    else:
        top_idx = stable_top_k(flat, beam_size, dim=1)[1]
    return {"selected_ids": torch.gather(cand_ids.reshape(b, k * w), 1,
                                         top_idx),
            "selected_scores": torch.gather(flat, 1, top_idx),
            "parent_idx": top_idx // w}


@register_op("beam_search", grad=None,
             nondiff_inputs=("pre_ids", "pre_scores", "ids", "scores"))
def beam_search_op(ins, attrs, ctx):
    """One beam-search step of a fluid program: pre_ids [B, K],
    pre_scores [B, K], scores [B, K, W], optional ids [B, K, W] ->
    selected_ids, selected_scores, parent_idx [B, beam_size], through
    `beam_search`."""
    ids = (ins.get("ids") or [None])[0]
    return beam_search(ins["pre_ids"][0], ins["pre_scores"][0],
                       ins["scores"][0],
                       beam_size=attrs.get("beam_size"),
                       end_id=int(attrs["end_id"]),
                       is_accumulated=bool(attrs.get("is_accumulated", True)),
                       ids=ids)


def _backtrack(step_ids, parents):
    """step_ids, parents [T, B, K] -> [T, B, K]: lane j at every t holds
    the token of the path that ends in beam j at the last step."""
    beam = torch.arange(step_ids.shape[2], device=step_ids.device).expand(
        step_ids.shape[1:])
    toks = [None] * step_ids.shape[0]
    for t in range(step_ids.shape[0] - 1, -1, -1):
        toks[t] = torch.gather(step_ids[t], 1, beam)
        beam = torch.gather(parents[t], 1, beam)
    return torch.stack(toks)


@register_op("gather_tree", grad=None, nondiff_inputs=("Ids", "Parents"))
def gather_tree(ins, attrs, ctx):
    """Backtrack full beams from per-step Ids and Parents, [T, B, K] in
    and out (the later-paddle gather_tree contract)."""
    return {"Out": _backtrack(ins["Ids"][0].to(torch.int64),
                              ins["Parents"][0].to(torch.int64))}


@register_op("beam_search_decode", grad=None,
             nondiff_inputs=("Ids", "ParentIdx", "Scores"))
def beam_search_decode(ins, attrs, ctx):
    """The final sentences from the recorded steps: Ids, ParentIdx and
    Scores (accumulated), [T, B, K] each -> SentenceIds [B, K, T] (every
    token after a beam's first end_id is end_id) and SentenceScores
    [B, K] (each beam's score at the last step), best first per
    sentence; equal scores keep their beam order (a stable sort, as
    jnp.argsort's)."""
    end_id = int(attrs["end_id"])
    toks = _backtrack(ins["Ids"][0].to(torch.int64),
                      ins["ParentIdx"][0].to(torch.int64))
    toks = toks.permute(1, 2, 0)                             # [B, K, T]
    ended = torch.cumsum((toks == end_id).to(torch.int32), dim=2) > 0
    shifted = torch.cat([torch.zeros_like(ended[:, :, :1]),
                         ended[:, :, :-1]], dim=2)
    toks = torch.where(shifted, torch.full_like(toks, end_id), toks)
    final = ins["Scores"][0][-1]                              # [B, K]
    order = torch.argsort(-final, dim=1, stable=True)
    return {"SentenceIds": torch.gather(
                toks, 1, order[:, :, None].expand(toks.shape)),
            "SentenceScores": torch.gather(final, 1, order)}
