"""One beam-search selection step, in PyTorch.

Counterpart of the JAX package's `ops/beam.py::beam_search` (the
reference's operators/beam_search_op): beams are a fixed [B, K] lane; a
finished beam (its previous id equals end_id) offers exactly one
candidate, itself, with its unchanged score, so it keeps emitting
end_id; is_accumulated=False log-accumulates raw probabilities onto
pre_scores. end_id=-1 means no beam ever finishes.

Ties break to the lowest flat index, as jax.lax.top_k does: argmax for
beam_size 1 (torch.argmax returns the first maximum), a stable
descending sort otherwise (torch.topk does not promise an order among
ties).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

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
    keep_self = torch.zeros(w, dtype=torch.bool, device=scores.device)
    keep_self[0] = True
    own = torch.where(keep_self, pre_scores[:, :, None].to(scores.dtype),
                      torch.tensor(_NEG_INF, dtype=scores.dtype,
                                   device=scores.device))
    scores = torch.where(finished[:, :, None], own, scores)
    cand_ids = torch.where(finished[:, :, None], int(end_id), cand_ids)

    flat = scores.reshape(b, k * w)
    if beam_size == 1:
        top_idx = flat.argmax(dim=1, keepdim=True)
    else:
        top_idx = torch.sort(flat, dim=1, descending=True,
                             stable=True).indices[:, :beam_size]
    return {"selected_ids": torch.gather(cand_ids.reshape(b, k * w), 1,
                                         top_idx),
            "selected_scores": torch.gather(flat, 1, top_idx),
            "parent_idx": top_idx // w}
