"""Sequence-state blocks, the port of `repro/models/ssm.py`: Mamba-2 SSD
(chunked scan, sequential oracle, decode step), xLSTM's mLSTM
(stabilised chunkwise-parallel form, sequential oracle, decode step) and
sLSTM (sequential scan, decode step), and the causal depthwise conv in
front of them.

The reference writes these in plain jnp under `lax.scan`, with no Pallas
kernel; here they are torch ops, and a Python loop over chunks or steps
takes the scan's place. All internals are float32, as in the reference,
and so are the states they return. The reference's padding constants
are kept, since they decide the final states: the chunk is 128 rows, a
ragged tail pads SSD's dt with -1e9 (softplus gives 0: the padded steps
neither decay nor feed the state) and mLSTM's input gate with -1e30 and
its forget gate with 30.0; masked entries are -1e30; sLSTM's m starts
at -1e30, mLSTM's at 0.

The reference's three-operand state updates ("bjhd,bjhe,bjh->bhde" and
its kin) are taken as one scaling and then one two-operand product, so
that no (B, lc, H, D, D) intermediate is ever built, whatever einsum
path the installed torch would choose. `F.softplus` returns x past its
threshold of 20 where `jax.nn.softplus` computes log(1 + e**x); the two
differ by under 1e-8 of x there.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

CHUNK = 128


# ---------------------------------------------------------------------------
# Causal depthwise conv1d
# ---------------------------------------------------------------------------


def causal_conv1d(x, w):
    """x: (B, S, C); w: (K, C) depthwise. Left-padded causal conv, summed
    in float32, returned in x's dtype."""
    k, s = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    wf = w.float()
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(k):
        out = out + xp[:, i:i + s].float() * wf[i]
    return out.to(x.dtype)


def causal_conv1d_step(x_t, conv_state, w):
    """One decode step. x_t: (B, C); conv_state: (B, K - 1, C), the past
    inputs. Returns (y_t, new_conv_state)."""
    full = torch.cat([conv_state, x_t[:, None].to(conv_state.dtype)], dim=1)
    y = (full.float() * w[None].float()).sum(dim=1)
    return y.to(x_t.dtype), full[:, 1:]


# ---------------------------------------------------------------------------
# Mamba-2 SSD
# ---------------------------------------------------------------------------


def ssd_chunked(x, dt, a_log, b, c, d_skip, *, chunk: int = CHUNK):
    """Chunked-parallel SSD scan.

    x: (B, S, H, P) values; dt: (B, S, H) raw (softplus applied here);
    a_log: (H,) (A = -exp(a_log)); b, c: (B, S, N) (one group); d_skip:
    (H,). Returns y (B, S, H, P) in x's dtype and the final state (B, H,
    N, P) in float32."""
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    lc = min(chunk, s)
    s_p = -(-s // lc) * lc
    pad = s_p - s
    xf = F.pad(x.float(), (0, 0, 0, 0, 0, pad))
    # dt padded with a large negative so that softplus(dt) = 0: padded
    # steps neither decay the state (exp(0) = 1) nor feed it
    dtf = F.softplus(F.pad(dt.float(), (0, 0, 0, pad), value=-1e9))
    bf = F.pad(b.float(), (0, 0, 0, pad))
    cf = F.pad(c.float(), (0, 0, 0, pad))
    a = -torch.exp(a_log.float())                     # (H,)
    mask = torch.ones(lc, lc, dtype=torch.bool, device=x.device).tril()
    state = torch.zeros(bsz, h, n, p, dtype=torch.float32, device=x.device)
    ys = []
    # the chunks as one split of each operand (its backward is one cat,
    # where a slice a chunk would write a whole zero gradient each)
    for xb, dtb, bb, cb in zip(*(t.split(lc, dim=1)
                                 for t in (xf, dtf, bf, cf))):
        f = torch.cumsum(dtb * a, dim=1)              # (B, lc, H) inclusive
        # intra-chunk: M_ij = exp(F_i - F_j) for j <= i; above the
        # diagonal exp would overflow, so those entries are -inf before
        # it (exp gives 0, and the backward 0 * exp(-inf) = 0, where
        # dropping an inf after exp would give 0 * inf = NaN)
        wij = f[:, :, None, :] - f[:, None, :, :]     # (B, i, j, H)
        mij = torch.exp(torch.where(mask[None, :, :, None], wij,
                                    torch.full((), -torch.inf,
                                               device=x.device)))
        cbt = torch.bmm(cb, bb.transpose(1, 2))        # (B, i, j)
        g = cbt[..., None] * mij                       # (B, i, j, H)
        dx = dtb[..., None] * xb                       # (B, lc, H, P)
        y_intra = torch.einsum("bijh,bjhp->bihp", g, dx)
        # inter-chunk: y_i += (C_i exp(F_i)) . state
        y_inter = (torch.einsum("bin,bhnp->bihp", cb, state)
                   * torch.exp(f)[..., None])
        # state update: step j's carry to the chunk's end is exp(total - F_j)
        total = f[:, -1]                               # (B, H)
        w_end = torch.exp(total[:, None, :] - f)       # (B, lc, H)
        state = (state * torch.exp(total)[:, :, None, None]
                 + torch.einsum("bjn,bjhp->bhnp", bb, dx * w_end[..., None]))
        ys.append(y_intra + y_inter)
    y = torch.cat(ys, dim=1)[:, :s]
    y = y + x.float() * d_skip.float()[None, None, :, None]
    return y.to(x.dtype), state


def _ssd_update(state, x_t, dt_t, a, b_t, c_t):
    """One float32 SSD step: decay, then add dt B x; y = C . state."""
    dtt = F.softplus(dt_t.float())                     # (B, H)
    decay = torch.exp(dtt * a)
    state = (state * decay[:, :, None, None]
             + b_t.float()[:, None, :, None]
             * (x_t.float() * dtt[..., None])[:, :, None, :])
    y = torch.einsum("bn,bhnp->bhp", c_t.float(), state)
    return y, state


def ssd_sequential(x, dt, a_log, b, c, d_skip):
    """Step-by-step oracle for ssd_chunked: y (B, S, H, P)."""
    bsz, s, h, p = x.shape
    a = -torch.exp(a_log.float())
    state = torch.zeros(bsz, h, b.shape[-1], p, dtype=torch.float32,
                        device=x.device)
    ys = []
    for t in range(s):
        y, state = _ssd_update(state, x[:, t], dt[:, t], a, b[:, t], c[:, t])
        ys.append(y)
    y = torch.stack(ys, dim=1)
    y = y + x.float() * d_skip.float()[None, None, :, None]
    return y.to(x.dtype)


def ssd_step(x_t, dt_t, a_log, b_t, c_t, d_skip, state):
    """One decode step. x_t: (B, H, P); dt_t: (B, H); b_t, c_t: (B, N);
    state: (B, H, N, P). Returns (y_t, new_state)."""
    y, state = _ssd_update(state, x_t, dt_t, -torch.exp(a_log.float()),
                           b_t, c_t)
    y = y + x_t.float() * d_skip.float()[None, :, None]
    return y.to(x_t.dtype), state


# ---------------------------------------------------------------------------
# xLSTM mLSTM (matrix memory)
# ---------------------------------------------------------------------------


def _mlstm_update(cmat, n, m, q_t, k_t, v_t, i_t, f_t):
    """One stabilised float32 mLSTM step on (B, H, D) operands; the state
    (C (B, H, D, D), n (B, H, D), m (B, H)). Returns (h_t, C, n, m)."""
    scale = q_t.shape[-1] ** -0.5
    qt = q_t.float() * scale
    kt = k_t.float() * scale
    vt = v_t.float()
    it = i_t.float()
    ft = F.logsigmoid(f_t.float())
    m_new = torch.maximum(ft + m, it)
    fs = torch.exp(ft + m - m_new)
    is_ = torch.exp(it - m_new)
    cmat = (fs[..., None, None] * cmat
            + is_[..., None, None] * kt[..., :, None] * vt[..., None, :])
    n = fs[..., None] * n + is_[..., None] * kt
    num = (qt[..., None, :] @ cmat)[..., 0, :]         # (B, H, D)
    den = torch.maximum((qt * n).sum(-1).abs(), torch.exp(-m_new))
    return num / den[..., None], cmat, n, m_new


def _mlstm_state0(q):
    bsz, _, h, d = q.shape
    return (torch.zeros(bsz, h, d, d, dtype=torch.float32, device=q.device),
            torch.zeros(bsz, h, d, dtype=torch.float32, device=q.device),
            torch.zeros(bsz, h, dtype=torch.float32, device=q.device))


def mlstm_sequential(q, k, v, i_gate, f_gate):
    """Stabilised sequential mLSTM oracle. q, k, v: (B, S, H, D); i_gate,
    f_gate: (B, S, H) preactivations. Returns h (B, S, H, D)."""
    cmat, n, m = _mlstm_state0(q)
    ys = []
    for t in range(q.shape[1]):
        y, cmat, n, m = _mlstm_update(cmat, n, m, q[:, t], k[:, t], v[:, t],
                                      i_gate[:, t], f_gate[:, t])
        ys.append(y)
    return torch.stack(ys, dim=1).to(q.dtype)


def mlstm_chunked(q, k, v, i_gate, f_gate, *, chunk: int = CHUNK):
    """Stabilised chunkwise-parallel mLSTM (the prefill path), equal to
    mlstm_sequential: the intra-chunk work is quadratic products, the
    cross-chunk state (C, n, m) is carried from chunk to chunk. Returns
    h (B, S, H, D) in q's dtype and the final (C, n, m) in float32."""
    bsz, s, h, d = q.shape
    lc = min(chunk, s)
    s_p = -(-s // lc) * lc
    pad = s_p - s
    scale = d ** -0.5

    def heads(t):            # (B, S, H, D) -> padded (B, H, S_p, D) float32
        return F.pad(t.float(), (0, 0, 0, 0, 0, pad)).transpose(1, 2)

    qf, kf, vf = heads(q) * scale, heads(k) * scale, heads(v)
    # the padded steps contribute nothing: i -1e30 (exp gives 0), f 30
    # (log-sigmoid about 0: no decay)
    i_p = F.pad(i_gate.float(), (0, 0, 0, pad), value=-1e30).transpose(1, 2)
    f_p = F.pad(f_gate.float(), (0, 0, 0, pad), value=30.0).transpose(1, 2)
    mask = torch.ones(lc, lc, dtype=torch.bool, device=q.device).tril()
    neg = torch.full((), -1e30, device=q.device)
    cmat, n, m = _mlstm_state0(q)
    ys = []
    # (B, H, lc, D) and (B, H, lc) chunks, one split of each operand
    for qb, kb, vb, ib, fb in zip(*(t.split(lc, dim=2)
                                    for t in (qf, kf, vf, i_p, f_p))):
        fcum = torch.cumsum(F.logsigmoid(fb), dim=-1)  # inclusive
        # w_ij = Fcum_i - Fcum_j + i_j (j <= i)
        wij = torch.where(mask, fcum[..., :, None] - fcum[..., None, :]
                          + ib[..., None, :], neg)     # (B, H, i, j)
        # the state path's weight for row i: Fcum_i + m_in
        w_state = fcum + m[..., None]                  # (B, H, lc)
        m_i = torch.maximum(wij.amax(dim=-1), w_state)
        pij = torch.exp(wij - m_i[..., None])
        p_state = torch.exp(w_state - m_i)
        gmat = (qb @ kb.transpose(-1, -2)) * pij
        num = gmat @ vb + (qb @ cmat) * p_state[..., None]
        # n_i = sum_j p_ij k_j + p_state n_in; den = |q . n_i|
        n_i = pij @ kb + p_state[..., None] * n[:, :, None, :]
        den = torch.maximum((qb * n_i).sum(-1).abs(), torch.exp(-m_i))
        ys.append(num / den[..., None])
        # the chunk-end state
        total = fcum[..., -1]                          # (B, H)
        w_end = total[..., None] - fcum + ib           # (B, H, lc)
        m_out = torch.maximum(total + m, w_end.amax(dim=-1))
        p_end = torch.exp(w_end - m_out[..., None])
        carry = torch.exp(total + m - m_out)
        kp = kb * p_end[..., None]
        cmat = carry[..., None, None] * cmat + kp.transpose(-1, -2) @ vb
        n = carry[..., None] * n + kp.sum(dim=2)
        m = m_out
    y = torch.cat(ys, dim=2).transpose(1, 2)[:, :s]
    return y.to(q.dtype), (cmat, n, m)


def mlstm_step(q_t, k_t, v_t, i_t, f_t, state):
    """One decode step on (B, H, D) and (B, H) operands; state = (C, n,
    m). Returns (h_t in q_t's dtype, new state)."""
    y, cmat, n, m = _mlstm_update(*state, q_t, k_t, v_t, i_t, f_t)
    return y.to(q_t.dtype), (cmat, n, m)


# ---------------------------------------------------------------------------
# xLSTM sLSTM (scalar memory, recurrent head mixing)
# ---------------------------------------------------------------------------


def _slstm_update(x_gates_t, r32, h, c, n, m):
    """One float32 sLSTM step: x_gates_t (B, 4, d) in (i, f, z, o) order,
    r32 (4, H, hd, hd) float32. Returns (h, c, n, m)."""
    bsz, _, d = x_gates_t.shape
    nh, hd = r32.shape[1], r32.shape[2]
    rec = torch.einsum("bhd,ghde->bghe", h.reshape(bsz, nh, hd), r32)
    pre = x_gates_t.float() + rec.reshape(bsz, 4, d)
    it, ft, zt, ot = pre.unbind(1)
    zt = torch.tanh(zt)
    ot = torch.sigmoid(ot)
    logf = F.logsigmoid(ft)
    m_new = torch.maximum(logf + m, it)
    fs = torch.exp(logf + m - m_new)
    is_ = torch.exp(it - m_new)
    c = fs * c + is_ * zt
    n = fs * n + is_
    # maximum, not clamp: n is exactly 1 after the first step, and there
    # the gradient splits half and half, as jnp.maximum's does
    return (ot * c / torch.maximum(n, torch.ones((), device=n.device)), c,
            n, m_new)


def slstm_scan(x_gates, r_weights, h0=None):
    """Sequential sLSTM over preprojected input gate preactivations.

    x_gates: (B, S, 4, d) in (i, f, z, o) order; r_weights: (4, H, hd, hd)
    per-head recurrent matrices (block diagonal). Returns h (B, S, d) in
    float32 and the final state (h, c, n, m), each (B, d)."""
    bsz, _, _, d = x_gates.shape
    r32 = r_weights.float()
    zeros = torch.zeros(bsz, d, dtype=torch.float32, device=x_gates.device)
    h = zeros if h0 is None else h0.float()
    c, n = zeros, zeros
    m = torch.full((bsz, d), -1e30, dtype=torch.float32,
                   device=x_gates.device)
    ys = []
    # the steps' gates as one unbind (its backward is one stack, where an
    # index a step would write a whole zero gradient each)
    for x_t in x_gates.unbind(1):
        h, c, n, m = _slstm_update(x_t, r32, h, c, n, m)
        ys.append(h)
    return torch.stack(ys, dim=1), (h, c, n, m)


def slstm_step(x_gates_t, r_weights, state):
    """One decode step. x_gates_t: (B, 4, d); state (h, c, n, m). Returns
    (h_t, new state)."""
    h, c, n, m = _slstm_update(x_gates_t, r_weights.float(), *state)
    return h, (h, c, n, m)
