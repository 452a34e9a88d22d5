"""LSTM and GRU ops of the fluid path: the JAX package's `ops/rnn.py`
(reference: operators/lstm_op.cc with math/lstm_compute, gate order
c~, i, f, o; gru_op.cc with math/gru_compute, z, r, c~).

Each recurrence is a Python loop over T (the JAX package's `lax.scan`),
one [N, H] x [H, 4H] (or 3H) product and a few elementwise launches a
step; gradients come from the registry's generic `_grad`, a replay of
the loop under autograd.

As in the JAX package, the LSTM and GRU ops take no lengths and
`is_reverse` flips the whole padded T, so a reversed layer reads a
short row's padding first (ROADMAP F20).
"""

from __future__ import annotations

import torch

from ..core.registry import register_op


def _opt(ins, slot):
    return (ins.get(slot) or [None])[0]


def _state(ins, slot, n, h, x):
    v = _opt(ins, slot)
    return torch.zeros((n, h), dtype=x.dtype, device=x.device) \
        if v is None else v


def _flip(x, is_reverse):
    return torch.flip(x, dims=[1]) if is_reverse else x


def _lstm_loop(x_proj, w_hh, h0, c0):
    """x_proj [N, T, 4H] (input projection and bias added), w_hh
    [H, 4H], gate slices c~, i, f, o: the reference's memory layout
    (math/detail/lstm_cpu_kernel.h), so converged reference weights
    transfer. Returns (hidden [N, T, H], cell [N, T, H], last_h,
    last_c)."""
    hsz = w_hh.shape[0]
    h, c = h0, c0
    hs, cs = [], []
    for t in range(x_proj.shape[1]):
        gates = x_proj[:, t] + h @ w_hh
        g = torch.tanh(gates[:, :hsz])
        i, f, o = torch.sigmoid(gates[:, hsz:]).chunk(3, dim=-1)
        c = f * c + i * g
        h = o * torch.tanh(c)
        hs.append(h)
        cs.append(c)
    return torch.stack(hs, 1), torch.stack(cs, 1), h, c


def _gru_loop(x_proj, w_hh, h0):
    """x_proj [N, T, 3H], w_hh [H, 3H] in z | r | c~ layout. Returns
    (hidden [N, T, H], last_h)."""
    hsz = w_hh.shape[0]
    w_zr, w_c = w_hh[:, :2 * hsz], w_hh[:, 2 * hsz:]
    h = h0
    hs = []
    for t in range(x_proj.shape[1]):
        xt = x_proj[:, t]
        z, r = torch.sigmoid(xt[:, :2 * hsz] + h @ w_zr).chunk(2, dim=-1)
        c = torch.tanh(xt[:, 2 * hsz:] + (r * h) @ w_c)
        h = (1 - z) * h + z * c
        hs.append(h)
    return torch.stack(hs, 1), h


@register_op("lstm_v2", nondiff_inputs=())
def lstm_v2(ins, attrs, ctx):
    """Input [N, T, D], Weight [D + H, 4H] (input rows, then recurrent
    rows), Bias [4H], optional H0 / C0 [N, H] -> Hidden [N, T, H],
    LastH, LastC."""
    x = ins["Input"][0]
    w = ins["Weight"][0]
    b = _opt(ins, "Bias")
    hsz = int(attrs["hidden_size"])
    rev = bool(attrs.get("is_reverse", False))
    x = _flip(x, rev)
    x_proj = torch.einsum("ntd,dh->nth", x, w[:-hsz])
    if b is not None:
        x_proj = x_proj + b
    n = x.shape[0]
    hidden, _, h_last, c_last = _lstm_loop(
        x_proj, w[-hsz:], _state(ins, "H0", n, hsz, x),
        _state(ins, "C0", n, hsz, x))
    return {"Hidden": _flip(hidden, rev), "LastH": h_last, "LastC": c_last}


@register_op("dynamic_lstm_v2", nondiff_inputs=())
def dynamic_lstm_v2(ins, attrs, ctx):
    """The reference dynamic_lstm contract: Input is pre-projected,
    [N, T, 4H]; Weight [H, 4H]. Cell is the per-step cell-state
    sequence."""
    x = ins["Input"][0]
    w = ins["Weight"][0]
    b = _opt(ins, "Bias")
    hsz = int(attrs["hidden_size"])
    rev = bool(attrs.get("is_reverse", False))
    x = _flip(x, rev)
    if b is not None:
        x = x + b
    n = x.shape[0]
    hidden, cell, _, _ = _lstm_loop(x, w, _state(ins, "H0", n, hsz, x),
                                    _state(ins, "C0", n, hsz, x))
    return {"Hidden": _flip(hidden, rev), "Cell": _flip(cell, rev)}


@register_op("gru_v2", nondiff_inputs=())
def gru_v2(ins, attrs, ctx):
    """Input [N, T, D], Weight [D + H, 3H], Bias [3H], optional H0 ->
    Hidden [N, T, H], LastH."""
    x = ins["Input"][0]
    w = ins["Weight"][0]
    b = _opt(ins, "Bias")
    hsz = int(attrs["hidden_size"])
    rev = bool(attrs.get("is_reverse", False))
    x = _flip(x, rev)
    x_proj = torch.einsum("ntd,dh->nth", x, w[:-hsz])
    if b is not None:
        x_proj = x_proj + b
    hidden, h_last = _gru_loop(x_proj, w[-hsz:],
                               _state(ins, "H0", x.shape[0], hsz, x))
    return {"Hidden": _flip(hidden, rev), "LastH": h_last}


@register_op("dynamic_gru_v2", nondiff_inputs=())
def dynamic_gru_v2(ins, attrs, ctx):
    """Pre-projected Input [N, T, 3H], Weight [H, 3H]."""
    x = ins["Input"][0]
    w = ins["Weight"][0]
    b = _opt(ins, "Bias")
    hsz = int(attrs["hidden_size"])
    rev = bool(attrs.get("is_reverse", False))
    x = _flip(x, rev)
    if b is not None:
        x = x + b
    hidden, h_last = _gru_loop(x, w, _state(ins, "H0", x.shape[0], hsz, x))
    return {"Hidden": _flip(hidden, rev), "LastH": h_last}


_ACTS = {
    "identity": lambda x: x,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "relu": torch.relu,
}

# gru_unit's integer activation codes (gru_unit_op.h's enum)
_ACT_CODES = {0: "identity", 1: "sigmoid", 2: "tanh", 3: "relu"}


@register_op("lstm_unit", nondiff_inputs=())
def lstm_unit(ins, attrs, ctx):
    """reference: lstm_unit_op.h:63-71: one LSTM step on pre-projected
    gates X [B, 4D] in (i, f, o, j) order:
    C = C_prev * sigm(f + forget_bias) + sigm(i) * tanh(j);
    H = sigm(o) * tanh(C)."""
    x = ins["X"][0]
    c_prev = ins["C_prev"][0]
    fb = float(attrs.get("forget_bias", 0.0))
    i, f, o, j = x.chunk(4, dim=-1)
    c = c_prev * torch.sigmoid(f + fb) + torch.sigmoid(i) * torch.tanh(j)
    return {"C": c, "H": torch.sigmoid(o) * torch.tanh(c)}


@register_op("gru_unit", nondiff_inputs=())
def gru_unit(ins, attrs, ctx):
    """reference: gru_unit_op.h: one GRU step. Input [B, 3D] is the
    pre-projected x; Weight [D, 3D] = [W_update | W_reset | W_candidate];
    the activations are integer codes (`_ACT_CODES`); Gate holds the
    activated (u, r, c) triple. `origin_mode` takes (1 - u) * c +
    u * h_prev in place of u * c + (1 - u) * h_prev."""
    x = ins["Input"][0]
    h_p = ins["HiddenPrev"][0]
    w = ins["Weight"][0]
    b = _opt(ins, "Bias")
    d = h_p.shape[1]
    act = _ACTS[_ACT_CODES[int(attrs.get("activation", 2))]]
    gate_act = _ACTS[_ACT_CODES[int(attrs.get("gate_activation", 1))]]
    g = x if b is None else x + b.reshape(1, -1)
    g_ur = g[:, :2 * d] + h_p @ w[:, :2 * d]
    u = gate_act(g_ur[:, :d])
    r = gate_act(g_ur[:, d:])
    r_h_p = r * h_p
    c = act(g[:, 2 * d:] + r_h_p @ w[:, 2 * d:])
    if bool(attrs.get("origin_mode", False)):
        h = c + u * (h_p - c)
    else:
        h = u * (c - h_p) + h_p
    return {"Gate": torch.cat([u, r, c], dim=1), "ResetHiddenPrev": r_h_p,
            "Hidden": h}


@register_op("lstmp_v2", nondiff_inputs=())
def lstmp_v2(ins, attrs, ctx):
    """reference: lstmp_op.h: an LSTM with a recurrent projection
    (LSTMP): gates = x_t + r_{t-1} @ Weight [P, 4D]; r_t =
    proj_act(h_t @ ProjWeight [D, P]), with an optional cell and
    projection clip. Input [N, T, 4D] is pre-projected, gates c~, i, f,
    o. H0 is the initial projection [N, P], as the reference kernel
    (lstmp_op.h:211) uses it. use_peepholes is refused, as in the JAX
    package."""
    x = ins["Input"][0]
    w = ins["Weight"][0]
    pw = ins["ProjWeight"][0]
    b = _opt(ins, "Bias")
    if bool(attrs.get("use_peepholes", False)):
        raise ValueError("lstmp_v2: use_peepholes not supported")
    d, p = pw.shape
    n = x.shape[0]
    cell_clip = float(attrs.get("cell_clip", 0.0))
    proj_clip = float(attrs.get("proj_clip", 0.0))
    gate_act = _ACTS[attrs.get("gate_activation", "sigmoid")]
    cell_act = _ACTS[attrs.get("cell_activation", "tanh")]
    cand_act = _ACTS[attrs.get("candidate_activation", "tanh")]
    proj_act = _ACTS[attrs.get("proj_activation", "tanh")]
    rev = bool(attrs.get("is_reverse", False))
    x = _flip(x, rev)
    if b is not None:
        x = x + b.reshape(1, 1, -1)
    h0 = _opt(ins, "H0")
    if h0 is not None and h0.shape[-1] != p:
        raise ValueError(
            f"lstmp_v2: H0 must be the initial projection of shape [N,{p}] "
            f"(the reference kernel uses H0 directly as r0), got "
            f"{tuple(h0.shape)}")
    r = torch.zeros((n, p), dtype=x.dtype, device=x.device) if h0 is None \
        else h0.to(x.dtype)
    c = _state(ins, "C0", n, d, x)
    rs, cs = [], []
    for t in range(x.shape[1]):
        gates = x[:, t] + r @ w
        g, i, f, o = gates.chunk(4, dim=-1)
        i, f, o = gate_act(i), gate_act(f), gate_act(o)
        c = f * c + i * cand_act(g)
        if cell_clip > 0:
            c = torch.clamp(c, -cell_clip, cell_clip)
        r = proj_act((o * cell_act(c)) @ pw)
        if proj_clip > 0:
            r = torch.clamp(r, -proj_clip, proj_clip)
        rs.append(r)
        cs.append(c)
    return {"Projection": _flip(torch.stack(rs, 1), rev),
            "Cell": _flip(torch.stack(cs, 1), rev)}


@register_op("attention_lstm", nondiff_inputs=(),
             intermediate_outputs=("AttentionedX", "AttentionFCOut",
                                   "LSTMX", "LSTMOUT"))
def attention_lstm(ins, attrs, ctx):
    """reference: attention_lstm_op.cc: a fused attention LSTM. At each
    output step, scores = relu(x @ Wa[:M] + c_prev @ Wa[M:]) (then the
    optional scalar stage), softmaxed over the sequence, pool x into
    lstm_x, then one LSTM step whose weight rows are [hidden; x] and
    gates (f, i, o, c~). X [N, T, M] with optional SeqLen [N]; the
    positions past SeqLen score -1e30 (finite: a length-0 row attends
    uniformly)."""
    x = ins["X"][0]
    c = ins["C0"][0]
    h0 = _opt(ins, "H0")
    wa = ins["AttentionWeight"][0].reshape(-1)            # [M + D]
    ba = _opt(ins, "AttentionBias")
    sc = _opt(ins, "AttentionScalar")
    scb = _opt(ins, "AttentionScalarBias")
    lw = ins["LSTMWeight"][0]                             # [D + M, 4D]
    lb = ins["LSTMBias"][0].reshape(-1)                   # [4D]
    seq_len = _opt(ins, "SeqLen")
    n, t, m = x.shape
    d = c.shape[1]
    gate_act = _ACTS[attrs.get("gate_activation", "sigmoid")]
    cell_act = _ACTS[attrs.get("cell_activation", "tanh")]
    cand_act = _ACTS[attrs.get("candidate_activation", "tanh")]

    atted_x = torch.einsum("ntm,m->nt", x, wa[:m])
    if ba is not None:
        atted_x = atted_x + ba.reshape(())
    pos = torch.arange(t, device=x.device)[None, :]
    valid = torch.ones((n, t), dtype=torch.bool, device=x.device) \
        if seq_len is None else pos < seq_len.reshape(-1, 1)
    h = torch.zeros((n, d), dtype=x.dtype, device=x.device) if h0 is None \
        else h0
    masked = torch.tensor(-1e30, dtype=x.dtype, device=x.device)
    hs, cs, atts, lxs = [], [], [], []
    for _ in range(t):
        score = torch.relu(atted_x + (c @ wa[m:])[:, None])      # [N, T]
        if sc is not None:
            score = score * sc.reshape(())
            if scb is not None:
                score = score + scb.reshape(())
            score = torch.relu(score)
        att = torch.softmax(torch.where(valid, score, masked), dim=1)
        lstm_x = torch.einsum("nt,ntm->nm", att, x)
        gates = lstm_x @ lw[d:] + h @ lw[:d] + lb
        f, i, o = (gate_act(gates[:, :d]), gate_act(gates[:, d:2 * d]),
                   gate_act(gates[:, 2 * d:3 * d]))
        c = f * c + i * cand_act(gates[:, 3 * d:])
        h = cell_act(c) * o
        hs.append(h)
        cs.append(c)
        atts.append(att)
        lxs.append(lstm_x)
    hidden, cell = torch.stack(hs, 1), torch.stack(cs, 1)
    return {"Hidden": hidden, "Cell": cell,
            "AttentionedX": atted_x[..., None],
            "AttentionFCOut": torch.stack(atts, 1)[..., None],
            "LSTMX": torch.stack(lxs, 1),
            "LSTMOUT": torch.cat([hidden, cell], dim=-1)}
