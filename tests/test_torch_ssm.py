"""Port parity for `repro_torch.models.ssm`, the scans of the SSM, xLSTM
and hybrid blocks: each function against `repro.models.ssm` on the same
seeded numpy inputs in float32, on the CPU (the reference's functions
are plain jnp under `lax.scan`; the port's are torch ops under a Python
loop).

Shapes: B 2 throughout; the reduced configs' (xlstm-125m reduced: mLSTM
2 heads of 64, sLSTM d 64 on 2 heads; hymba-1.5b reduced: SSD 2 heads of
P 64, N 4) and wider heads; S ragged against the 128-row chunk (S <
chunk, S = chunk, chunk < S < 2 chunks, past 2 chunks), and a chunk of
16 to run many chunks at a small S. Each chunked form is held to the
reference's chunked form (outputs and final states), to its own
sequential form, and its step form chained over S to the scans.

Tolerance: |got - want| <= 2e-5 max|want| + 1e-6 elementwise, per
output and per state, against the reference. Both sides run the same
float32 steps in another order (XLA's dot, cumulative sum and fused
element-wise ops against torch's CPU BLAS and loops); a recurrence of
up to 300 steps carries a float32 unit (6e-8) per operation, and an
exponential of a cumulative log decay of up to a few hundred carries
that unit of its argument into its value. Measured: up to 5.8e-6 of the
scale (SSD at S 300). A chunked form against the port's own sequential
form: 1e-5 max|want| (measured up to 1.0e-6).
"""
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as jssm
from repro_torch.models import ssm as tssm

B = 2


def _rng(*key):
    """A generator seeded by the case's name (a stable hash of it)."""
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def _both(*arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(np.array(a)) for a in arrays])


def _close(got, want, rel=2e-5):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape and got.dtype == np.float32
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale + 1e-6)


def _normal(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# The causal conv
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s", [1, 2, 3, 5, 130])
@pytest.mark.parametrize("c", [64, 128])
def test_causal_conv1d_matches_reference(s, c):
    rng = _rng("conv", s, c)
    (jx, jw), (tx, tw) = _both(_normal(rng, B, s, c),
                               _normal(rng, 4, c, scale=0.3))
    _close(tssm.causal_conv1d(tx, tw), jssm.causal_conv1d(jx, jw))


def test_causal_conv1d_step_chained_matches_the_conv():
    """Steps from a zero window give the conv's rows; the window after
    the last step holds the last K - 1 inputs, as the reference's step
    returns it."""
    rng = _rng("conv-step")
    x, w = _normal(rng, B, 9, 64), _normal(rng, 4, 64, scale=0.3)
    (jx, jw), (tx, tw) = _both(x, w)
    want = jssm.causal_conv1d(jx, jw)
    state = torch.zeros(B, 3, 64)
    jstate = jnp.zeros((B, 3, 64))
    for t in range(9):
        y, state = tssm.causal_conv1d_step(tx[:, t], state, tw)
        jy, jstate = jssm.causal_conv1d_step(jx[:, t], jstate, jw)
        _close(y, want[:, t])
        _close(y, jy)
    _close(state, jstate)
    np.testing.assert_array_equal(state.numpy(), x[:, -3:])


# ---------------------------------------------------------------------------
# Mamba-2 SSD
# ---------------------------------------------------------------------------

SSD_SHAPES = [(2, 64, 4), (8, 16, 16)]     # (H, P, N): hymba reduced; wider


def _ssd_inputs(rng, s, h, p, n):
    return (_normal(rng, B, s, h, p), _normal(rng, B, s, h),
            _normal(rng, h, scale=0.5), _normal(rng, B, s, n),
            _normal(rng, B, s, n), _normal(rng, h) + 1.0)


@pytest.mark.parametrize("chunk", [128, 16])
@pytest.mark.parametrize("s", [24, 128, 200, 300])
@pytest.mark.parametrize("h,p,n", SSD_SHAPES)
def test_ssd_chunked_matches_reference(h, p, n, s, chunk):
    """y and the final state; S = 24 is under one chunk of 128, 200 and
    300 leave a ragged tail that the padded dt must keep out of the
    state."""
    jx, tx = _both(*_ssd_inputs(_rng("ssd", h, s, chunk), s, h, p, n))
    jy, jstate = jssm.ssd_chunked(*jx, chunk=chunk)
    ty, tstate = tssm.ssd_chunked(*tx, chunk=chunk)
    assert tuple(tstate.shape) == (B, h, n, p)
    _close(ty, jy)
    _close(tstate, jstate)


@pytest.mark.parametrize("s", [7, 40])
@pytest.mark.parametrize("h,p,n", SSD_SHAPES)
def test_ssd_sequential_matches_reference_and_chunked(h, p, n, s):
    jx, tx = _both(*_ssd_inputs(_rng("ssd-seq", h, s), s, h, p, n))
    got = tssm.ssd_sequential(*tx)
    _close(got, jssm.ssd_sequential(*jx))
    _close(tssm.ssd_chunked(*tx, chunk=16)[0], got, rel=1e-5)


@pytest.mark.parametrize("h,p,n", SSD_SHAPES)
def test_ssd_step_chained_matches_the_scans(h, p, n):
    """ssd_step over S = 37 from a zero state: each y_t against the
    sequential scan's row (port and reference), the last state against
    the chunked scan's final state."""
    s = 37
    x, dt, a_log, b, c, d_skip = _ssd_inputs(_rng("ssd-step", h), s, h, p,
                                             n)
    jx, tx = _both(x, dt, a_log, b, c, d_skip)
    want = jssm.ssd_sequential(*jx)
    _, jfinal = jssm.ssd_chunked(*jx)
    state = torch.zeros(B, h, n, p)
    jstate = jnp.zeros((B, h, n, p))
    ta, td = torch.from_numpy(a_log), torch.from_numpy(d_skip)
    for t in range(s):
        y, state = tssm.ssd_step(tx[0][:, t], tx[1][:, t], ta, tx[3][:, t],
                                 tx[4][:, t], td, state)
        jy, jstate = jssm.ssd_step(jx[0][:, t], jx[1][:, t], jx[2],
                                   jx[3][:, t], jx[4][:, t], jx[5], jstate)
        _close(y, want[:, t])
        _close(y, jy)
    _close(state, jstate)
    _close(state, jfinal, rel=1e-5)


def test_ssd_chunked_pads_dt_so_the_tail_leaves_the_state():
    """A prompt of 130 rows pads to 256: the final state equals the
    state of the 130 rows' sequential steps, and a large positive dt in
    the real rows still leaves the padded rows inert."""
    rng = _rng("ssd-pad")
    x, dt, a_log, b, c, d_skip = _ssd_inputs(rng, 130, 2, 64, 4)
    dt[:, -1] = 25.0                 # past F.softplus's threshold
    tx = [torch.from_numpy(a) for a in (x, dt, a_log, b, c, d_skip)]
    _, final = tssm.ssd_chunked(*tx)
    state = torch.zeros(B, 2, 4, 64)
    for t in range(130):
        _, state = tssm.ssd_step(tx[0][:, t], tx[1][:, t], tx[2],
                                 tx[3][:, t], tx[4][:, t], tx[5], state)
    assert bool(torch.isfinite(final).all())
    _close(final, state, rel=1e-5)


# ---------------------------------------------------------------------------
# xLSTM mLSTM
# ---------------------------------------------------------------------------

MLSTM_SHAPES = [(2, 64), (4, 32)]          # (H, D): xlstm reduced; more heads


def _mlstm_inputs(rng, s, h, d):
    return (_normal(rng, B, s, h, d), _normal(rng, B, s, h, d),
            _normal(rng, B, s, h, d), _normal(rng, B, s, h),
            _normal(rng, B, s, h) + 3.0)


@pytest.mark.parametrize("chunk", [128, 16])
@pytest.mark.parametrize("s", [24, 128, 200, 300])
@pytest.mark.parametrize("h,d", MLSTM_SHAPES)
def test_mlstm_chunked_matches_reference(h, d, s, chunk):
    """h and the final (C, n, m): the padded gates (i -1e30, f 30) keep
    the ragged tail out of the state."""
    jx, tx = _both(*_mlstm_inputs(_rng("mlstm", h, s, chunk), s, h, d))
    jy, jstate = jssm.mlstm_chunked(*jx, chunk=chunk)
    ty, tstate = tssm.mlstm_chunked(*tx, chunk=chunk)
    _close(ty, jy)
    shapes = [(B, h, d, d), (B, h, d), (B, h)]
    for got, want, shape in zip(tstate, jstate, shapes):
        assert tuple(got.shape) == shape
        _close(got, want)


@pytest.mark.parametrize("s", [7, 40])
@pytest.mark.parametrize("h,d", MLSTM_SHAPES)
def test_mlstm_sequential_matches_reference_and_chunked(h, d, s):
    jx, tx = _both(*_mlstm_inputs(_rng("mlstm-seq", h, s), s, h, d))
    got = tssm.mlstm_sequential(*tx)
    _close(got, jssm.mlstm_sequential(*jx))
    _close(tssm.mlstm_chunked(*tx, chunk=16)[0], got, rel=1e-5)


@pytest.mark.parametrize("h,d", MLSTM_SHAPES)
def test_mlstm_step_chained_matches_the_scans(h, d):
    """mlstm_step over S = 37 from the zero state (m 0, as the chunked
    form starts): each h_t against the sequential scan, the last (C, n,
    m) against the reference's steps and the chunked final state."""
    s = 37
    jx, tx = _both(*_mlstm_inputs(_rng("mlstm-step", h), s, h, d))
    want = jssm.mlstm_sequential(*jx)
    _, jfinal = jssm.mlstm_chunked(*jx)
    state = (torch.zeros(B, h, d, d), torch.zeros(B, h, d),
             torch.zeros(B, h))
    jstate = tuple(jnp.asarray(t.numpy()) for t in state)
    for t in range(s):
        y, state = tssm.mlstm_step(*(a[:, t] for a in tx), state)
        jy, jstate = jssm.mlstm_step(*(a[:, t] for a in jx), jstate)
        _close(y, want[:, t])
        _close(y, jy)
    for got, want_s, final in zip(state, jstate, jfinal):
        _close(got, want_s)
        _close(got, final, rel=1e-5)


# ---------------------------------------------------------------------------
# xLSTM sLSTM
# ---------------------------------------------------------------------------

SLSTM_SHAPES = [(2, 64), (4, 128)]         # (H, d): xlstm reduced; wider


def _slstm_inputs(rng, s, h, d):
    hd = d // h
    return (_normal(rng, B, s, 4, d),
            _normal(rng, 4, h, hd, hd, scale=hd ** -0.5))


@pytest.mark.parametrize("s", [1, 24, 130])
@pytest.mark.parametrize("h,d", SLSTM_SHAPES)
def test_slstm_scan_matches_reference(h, d, s):
    """h (B, S, d) and the final (h, c, n, m), m from -1e30."""
    jx, tx = _both(*_slstm_inputs(_rng("slstm", h, s), s, h, d))
    jy, jstate = jssm.slstm_scan(*jx)
    ty, tstate = tssm.slstm_scan(*tx)
    _close(ty, jy)
    for got, want in zip(tstate, jstate):
        assert tuple(got.shape) == (B, d)
        _close(got, want)


def test_slstm_scan_takes_an_initial_h():
    jx, tx = _both(*_slstm_inputs(_rng("slstm-h0"), 12, 2, 64))
    h0 = _normal(_rng("h0"), B, 64)
    jy, _ = jssm.slstm_scan(*jx, h0=jnp.asarray(h0))
    ty, _ = tssm.slstm_scan(*tx, h0=torch.from_numpy(h0))
    _close(ty, jy)


@pytest.mark.parametrize("h,d", SLSTM_SHAPES)
def test_slstm_step_chained_matches_the_scan(h, d):
    s = 20
    (jg, jr), (tg, tr) = _both(*_slstm_inputs(_rng("slstm-step", h), s, h,
                                              d))
    want, wfinal = jssm.slstm_scan(jg, jr)
    state = (torch.zeros(B, d), torch.zeros(B, d), torch.zeros(B, d),
             torch.full((B, d), -1e30))
    jstate = tuple(jnp.asarray(t.numpy()) for t in state)
    for t in range(s):
        y, state = tssm.slstm_step(tg[:, t], tr, state)
        jy, jstate = jssm.slstm_step(jg[:, t], jr, jstate)
        _close(y, want[:, t])
        _close(y, jy)
    for got, want_s, final in zip(state, jstate, wfinal):
        _close(got, want_s)
        _close(got, final)


# ---------------------------------------------------------------------------
# dtypes
# ---------------------------------------------------------------------------


def test_scans_keep_float32_states_and_return_their_input_dtype():
    """bfloat16 operands: outputs in bfloat16 (sLSTM's h in float32, as
    the reference's), every state float32."""
    rng = _rng("dtypes")
    bf = torch.bfloat16
    x, dt, a_log, b, c, d_skip = (torch.from_numpy(a) for a in
                                  _ssd_inputs(rng, 20, 2, 64, 4))
    y, state = tssm.ssd_chunked(x.to(bf), dt.to(bf), a_log, b.to(bf),
                                c.to(bf), d_skip)
    assert y.dtype == bf and state.dtype == torch.float32
    q, k, v, i, f = (torch.from_numpy(a).to(bf) for a in
                     _mlstm_inputs(rng, 20, 2, 64))
    y, state = tssm.mlstm_chunked(q, k, v, i, f.float())
    assert y.dtype == bf and all(t.dtype == torch.float32 for t in state)
    g, r = (torch.from_numpy(a) for a in _slstm_inputs(rng, 5, 2, 64))
    hseq, state = tssm.slstm_scan(g.to(bf), r)
    assert hseq.dtype == torch.float32
    assert all(t.dtype == torch.float32 for t in state)
