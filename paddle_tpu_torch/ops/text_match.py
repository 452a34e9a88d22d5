"""Text-matching ops of the fluid path: the JAX package's
`ops/text_match.py`, so far the op the dygraph `TreeConv` layer
reaches, `tree_conv` (:195). The rest of that module is still to port
(ROADMAP item 15).
"""

from __future__ import annotations

import torch

from ..core.registry import register_op


def _tree_conv_one(feat, edge, filt, max_depth):
    """One tree: feat [M, F], edge [E, 2] (parent, child; 1-based, a
    (0, 0) row is padding), filt [F, 3, C] -> [M, C] before the tanh."""
    m = feat.shape[0]
    e = edge.shape[0]
    parent = edge[:, 0] - 1
    child = edge[:, 1] - 1
    valid = (edge[:, 0] > 0) & (edge[:, 1] > 0)
    vf = valid.to(feat.dtype)
    # adjacency: adj[parent, child] = 1 for every valid edge (the JAX
    # op's `.at[p, c].max(valid)`)
    flat = parent.clamp(min=0) * m + child.clamp(min=0)
    adj = torch.zeros(m * m, dtype=feat.dtype, device=feat.device)
    adj = adj.scatter_reduce(0, flat, vf, reduce="amax").reshape(m, m)
    # a node's left/right coefficient: its rank among its own siblings
    # in edge order (tree2col), which travels with it into every
    # ancestor's window
    same = (parent[None, :] == parent[:, None]) & valid[None, :] & \
        valid[:, None]
    before = torch.tril(torch.ones(e, e, dtype=torch.bool,
                                   device=feat.device), diagonal=-1)
    rank = torch.sum(same & before, dim=1).to(feat.dtype)
    count = torch.clamp(torch.sum(same, dim=1), min=1).to(feat.dtype)
    edge_eta_r = torch.where(count > 1,
                             rank / torch.clamp(count - 1.0, min=1.0),
                             torch.full_like(rank, 0.5))
    eta_r = torch.zeros(m, dtype=feat.dtype, device=feat.device)
    eta_r = eta_r.scatter_reduce(
        0, child.clamp(min=0),
        torch.where(valid, edge_eta_r, torch.zeros_like(edge_eta_r)),
        reduce="amax")
    eta_l = 1.0 - eta_r
    wt, wl, wr = filt[:, 0], filt[:, 1], filt[:, 2]          # [F, C]
    out = feat @ wt                                           # self: eta_t 1
    reach = adj                                               # depth 1
    for d in range(1, max_depth + 1):
        eta_t = (max_depth - d) / max_depth
        out = out + eta_t * (reach @ (feat @ wt))
        out = out + (1.0 - eta_t) * (
            (reach * eta_l[None, :]) @ (feat @ wl) +
            (reach * eta_r[None, :]) @ (feat @ wr))
        if d < max_depth:
            reach = torch.clamp(reach @ adj, max=1.0)
    return out


@register_op("tree_conv", nondiff_inputs=("EdgeSet",))
def tree_conv(ins, attrs, ctx):
    """reference: tree_conv_op.cc + math/tree2col (TBCNN): a node's
    receptive field is its subtree down to `max_depth` (default 1),
    with three weight planes (top, left, right); the top coefficient
    decays with depth, (max_depth - d) / max_depth. NodesVector [N, M,
    F], EdgeSet [N, E, 2], Filter [F, 3, C] -> Out [N, M, C], tanh
    applied, as the JAX op gives it."""
    nodes = ins["NodesVector"][0]
    edges = ins["EdgeSet"][0].to(torch.int64)
    filt = ins["Filter"][0]
    max_depth = int(attrs.get("max_depth", 1))
    out = torch.stack([_tree_conv_one(nodes[i], edges[i], filt, max_depth)
                       for i in range(nodes.shape[0])])
    return {"Out": torch.tanh(out)}
