"""Text-matching and CTR ops of the fluid path: the JAX package's
`ops/text_match.py`, all ten op types, in its order (reference:
operators/pad_constant_like_op.cc, squared_l2_distance_op.h,
bilinear_tensor_product_op.h, conv_shift_op.cc, cvm_op.h, hash_op.h,
match_matrix_tensor_op.cc, var_conv_2d_op.cc, tree_conv_op.cc,
filter_by_instag_op.h).

`hash` is the JAX op's splitmix-style integer hash bit for bit: its
uint32 lanes are int64 here, masked to 32 bits after every multiply, add
and left shift (the multiply split in 16-bit halves, so no product
leaves int64), since torch's uint32 arithmetic is thin on both the CPU
and CUDA. `cvm` has its own gradient, as the JAX op does: the counters'
slots of dX are the CVM input, not the autodiff of the log transform.
`filter_by_instag` compacts the kept rows with a stable argsort.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.registry import (GRAD_PREFIX_IG, GRAD_PREFIX_IN, GRAD_PREFIX_OG,
                             register_op)

_M32 = 0xFFFFFFFF


@register_op("pad_constant_like", nondiff_inputs=("X",))
def pad_constant_like(ins, attrs, ctx):
    """Out = Y padded at the end of every dim up to X's shape with
    pad_value (the gradient flows to Y)."""
    x = ins["X"][0]
    y = ins["Y"][0]
    pad_value = float(attrs.get("pad_value", 0.0))
    pads = []
    for xs, ys in reversed(list(zip(x.shape, y.shape))):
        pads += [0, int(xs - ys)]
    return {"Out": F.pad(y, pads, value=pad_value)}


@register_op("squared_l2_distance", intermediate_outputs=("sub_result",))
def squared_l2_distance(ins, attrs, ctx):
    """Out [N, 1] = the sum of squares of X - Y over the flattened
    non-batch dims (Y broadcasts when it has one row); sub_result is
    that difference, flattened."""
    x = ins["X"][0]
    y = ins["Y"][0]
    sub = x - y
    flat = sub.reshape(sub.shape[0], -1)
    return {"Out": torch.sum(flat * flat, dim=-1, keepdim=True),
            "sub_result": flat}


@register_op("bilinear_tensor_product")
def bilinear_tensor_product(ins, attrs, ctx):
    """out[n, o] = x_n W_o y_n^T (+ bias), W [O, D1, D2]."""
    x = ins["X"][0]
    y = ins["Y"][0]
    w = ins["Weight"][0]
    out = torch.einsum("nd,ode,ne->no", x, w, y)
    if ins.get("Bias") and ins["Bias"][0] is not None:
        out = out + ins["Bias"][0].reshape(1, -1)
    return {"Out": out}


@register_op("conv_shift")
def conv_shift(ins, attrs, ctx):
    """Circular correlation: out[b, i] = sum_j x[b, (i + j - M/2) mod N]
    * y[b, j], X [B, N], Y [B, M], M odd, M <= N."""
    x = ins["X"][0]
    y = ins["Y"][0]
    m = y.shape[1]
    half = m // 2
    out = torch.zeros_like(x)
    for j in range(m):
        out = out + torch.roll(x, half - j, dims=1) * y[:, j:j + 1]
    return {"Out": out}


def _cvm_grad(ins, attrs, ctx):
    """cvm_op.h CvmGradComputeKernel: dX[:, 0:2] is the CVM input's
    per-sample [show, click], not the autodiff of the log transform; the
    tail passes dY[:, 2:] through with use_cvm, all of dY without."""
    x = ins[GRAD_PREFIX_IN + "X"][0]
    cvm_in = ins[GRAD_PREFIX_IN + "CVM"][0]
    dy = ins[GRAD_PREFIX_OG + "Y"][0]
    use_cvm = bool(attrs.get("use_cvm", True))
    head = torch.broadcast_to(cvm_in[:, :2], (x.shape[0], 2)).to(x.dtype)
    tail = dy[:, 2:] if use_cvm else dy
    return {GRAD_PREFIX_IG + "X": [torch.cat([head, tail], dim=1)]}


@register_op("cvm", grad=_cvm_grad, nondiff_inputs=("CVM",))
def cvm(ins, attrs, ctx):
    """cvm_op.h:26-40: X rows are [show, click, emb...]; with use_cvm the
    counters become [log(show + 1), log(click + 1) - log(show + 1)],
    otherwise they are stripped."""
    x = ins["X"][0]
    if bool(attrs.get("use_cvm", True)):
        show = torch.log(x[:, 0:1] + 1.0)
        click = torch.log(x[:, 1:2] + 1.0) - show
        return {"Y": torch.cat([show, click, x[:, 2:]], dim=1)}
    return {"Y": x[:, 2:]}


def _mul32(h, c):
    """(h * c) mod 2^32 for h in [0, 2^32) (int64) and a 32-bit
    constant c, in 16-bit halves of c so no product leaves int64."""
    lo, hi = c & 0xFFFF, c >> 16
    return (h * lo + (((h * hi) & 0xFFFF) << 16)) & _M32


def _int_hash(vals, seed):
    """The JAX op's `_int_hash` on int64 lanes holding uint32 values:
    a splitmix-style avalanche over the id window, deterministic per
    (window, seed), 31 bits."""
    h = torch.full(vals.shape[:-1], (0x9E3779B9 * (seed + 1)) & _M32,
                   dtype=torch.int64, device=vals.device)
    for i in range(vals.shape[-1]):
        v = vals[..., i] & _M32
        t = (v + 0x85EBCA6B) & _M32
        t = (t + ((h << 6) & _M32)) & _M32
        t = (t + (h >> 2)) & _M32
        h = h ^ t
        h = _mul32(h, 0xC2B2AE35)
        h = h ^ (h >> 16)
    return h & 0x7FFFFFFF


@register_op("hash", grad=None, nondiff_inputs=("X",))
def hash_op(ins, attrs, ctx):
    """hash_op.h:60-63: out[i, k] = hash_k(id window i) % mod_by for k <
    num_hash. X [N, W] int -> Out [N, num_hash] int64. A mod_by of 2^31
    or more leaves the 31-bit hash as it is."""
    x = ins["X"][0].to(torch.int64)
    mod_by = int(attrs.get("mod_by", 100000))
    num_hash = int(attrs.get("num_hash", 1))
    outs = [_int_hash(x, k) for k in range(num_hash)]
    if mod_by < 2 ** 31:
        outs = [o % mod_by for o in outs]
    return {"Out": torch.stack(outs, dim=-1)}


@register_op("match_matrix_tensor", intermediate_outputs=("Tmp",))
def match_matrix_tensor(ins, attrs, ctx):
    """match_matrix_tensor_op.cc: out[n, t, i, j] = x_i^T W_t y_j over X
    [N, Tx, D], Y [N, Ty, D], W [D, dim_t, D]; Tmp = x W."""
    x = ins["X"][0]
    y = ins["Y"][0]
    w = ins["W"][0]
    tmp = torch.einsum("nid,dte->nite", x, w)        # [N, Tx, dim_t, D]
    out = torch.einsum("nite,nje->ntij", tmp, y)     # [N, dim_t, Tx, Ty]
    return {"Out": out, "Tmp": tmp}


def _length_mask(lens, size, axis, stride=1):
    """[N, 1, 1, 1]-broadcastable mask of positions < ceil(len / stride)
    along `axis` (2 rows, 3 columns) of an [N, C, H, W] tensor."""
    lens = lens.reshape(-1).to(torch.int64)
    lens = (lens + stride - 1) // stride
    pos = torch.arange(size, device=lens.device)
    shape = [1, 1, 1, 1]
    shape[axis] = size
    return pos.reshape(shape) < lens.reshape(-1, 1, 1, 1)


@register_op("var_conv_2d", nondiff_inputs=("ROW", "COLUMN"))
def var_conv_2d(ins, attrs, ctx):
    """var_conv_2d_op.cc: a 2-D conv over each row's variable-sized
    grid, as the JAX op computes it: the padded [N, C, H, W] input masked
    past each row's ROW and COLUMN lengths, a dense SAME-padded conv, and
    the output masked past the lengths rounded up by the stride (windows
    just outside a grid still see valid cells)."""
    x = ins["X"][0]
    w = ins["W"][0]
    kh = int(attrs.get("kernel_h", 3))
    kw = int(attrs.get("kernel_w", 3))
    sh = int(attrs.get("stride_h", 1))
    sw = int(attrs.get("stride_w", 1))
    n, c, h, w_dim = x.shape
    if w.dim() == 2:
        w = w.reshape(w.shape[0], c, kh, kw)
    row = ins["ROW"][0] if ins.get("ROW") else None
    col = ins["COLUMN"][0] if ins.get("COLUMN") else None
    if row is not None:
        x = x * _length_mask(row, h, 2).to(x.dtype)
    if col is not None:
        x = x * _length_mask(col, w_dim, 3).to(x.dtype)
    out = F.conv2d(x, w, stride=(sh, sw),
                   padding=((kh - 1) // 2, (kw - 1) // 2))
    if row is not None:
        out = out * _length_mask(row, out.shape[2], 2, sh).to(out.dtype)
    if col is not None:
        out = out * _length_mask(col, out.shape[3], 3, sw).to(out.dtype)
    return {"Out": out}


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


@register_op("filter_by_instag", nondiff_inputs=("Ins_tag", "Filter_tag"))
def filter_by_instag(ins, attrs, ctx):
    """filter_by_instag_op.h: keep the instances whose tags meet
    Filter_tag, compacted to the top in their order (a stable argsort)
    and zero-padded below; LossWeight is 1.0 on kept rows, IndexMap row
    i is [i, original row] for kept rows and -1 below. Ins_tag is the
    padded [N, T] tag matrix (pad with a value not in Filter_tag)."""
    x = ins["Ins"][0]
    tags = ins["Ins_tag"][0]
    filt = ins["Filter_tag"][0].reshape(-1)
    if tags.dim() == 1:
        tags = tags[:, None]
    n = x.shape[0]
    hit = (tags[:, :, None] == filt[None, None, :]).any(2).any(1)
    order = torch.argsort((~hit).to(torch.int32), stable=True)
    kept = torch.where(hit[order][:, None], x[order], torch.zeros_like(x))
    ar = torch.arange(n, device=x.device)
    valid = ar < hit.sum()
    index_map = torch.where(valid[:, None], torch.stack([ar, order], dim=1),
                            torch.full((n, 2), -1, dtype=torch.int64,
                                       device=x.device))
    return {"Out": kept, "LossWeight": valid.to(x.dtype)[:, None],
            "IndexMap": index_map}
