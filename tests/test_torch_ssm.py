"""The port's state-space mixers (``models/ssm``) and the plain versions of
their scans (K3's and K4's) against the JAX package, on the CPU.

The same seeded numpy inputs go through the reference's function and the
port's.  In float32 both sides compute the same products in the same
order; the scans' sums over a state row (``y = sum_n h C``, ``y = r (s +
u kv)``) and the projections' dots may be taken in other orders, so they
are held to 1e-5.  In bfloat16 both round the projections and residual
terms to bf16 at the same places but accumulate in other orders: 2e-2.
The plain scans are also held to a float64 run of the same recurrence
(1e-5), from a nonzero state, and split at a chunk boundary: two calls
that carry the state give one call's bits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as JS
from repro_torch.kernels.selective_scan import ops as scan_ops
from repro_torch.kernels.selective_scan.ref import selective_scan_plain
from repro_torch.kernels.wkv6 import ops as wkv_ops
from repro_torch.kernels.wkv6.ref import wkv6_plain
from repro_torch.models import ssm as S

B, SEQ, D, N, W = 2, 40, 48, 8, 4
DI = 2 * D
RW_D = 128                      # two RWKV heads of 64
SPLIT = 17


def _rand(seed, *shape, scale=0.5):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(
        np.float32)


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _tol(dtype):
    return 1e-5 if dtype == "float32" else 2e-2


def _both(tree, dtype):
    """(jax tree, torch tree) of numpy leaves in ``dtype`` (float32 keys
    of ``F32`` stay float32, as the reference keeps them)."""
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (
        jnp.bfloat16, torch.bfloat16)
    j, t = {}, {}
    for k, v in tree.items():
        if isinstance(v, dict):
            j[k], t[k] = _both(v, dtype)
        elif k in F32:
            j[k], t[k] = jnp.asarray(v), torch.as_tensor(v)
        else:
            j[k] = jnp.asarray(v, jdt)
            t[k] = torch.as_tensor(v).to(tdt)
    return j, t


F32 = ("logA", "w_bias", "h0", "s0")


def _ssm_params(seed=0):
    rng = np.random.default_rng(seed)

    def normal(*shape, scale=0.2):
        return (rng.normal(size=shape) * scale).astype(np.float32)
    return {"in_proj": normal(D, 2 * DI), "conv": normal(W, DI, scale=0.5),
            "wdt": normal(DI, scale=0.5), "wB": normal(DI, N),
            "wC": normal(DI, N),
            "logA": np.log(np.arange(1, N + 1, dtype=np.float32))[None, :]
            .repeat(DI, 0),
            "out_proj": normal(DI, D), "dskip": 1 + normal(DI)}


def _rwkv_params(seed=1):
    rng = np.random.default_rng(seed)

    def normal(*shape, scale=0.1):
        return (rng.normal(size=shape) * scale).astype(np.float32)
    H = RW_D // S.RWKV_HEAD_DIM
    att = {"mu": normal(5, RW_D, scale=0.5),
           **{w: normal(RW_D, RW_D) for w in ("wr", "wk", "wv", "wg", "wo")},
           "ww": normal(RW_D, RW_D, scale=0.5),
           "w_bias": np.full((RW_D,), -2.0, np.float32),
           "u": normal(H, S.RWKV_HEAD_DIM, scale=0.5)}
    ffn = {"mu": normal(2, RW_D, scale=0.5), "wk": normal(RW_D, 2 * RW_D),
           "wv": normal(2 * RW_D, RW_D), "wr": normal(RW_D, RW_D)}
    return att, ffn


# ---- the plain scans against float64 ----------------------------------------

def _scan_inputs(seed=2):
    x = _rand(seed, B, SEQ, DI)
    dt = np.log1p(np.exp(_rand(seed + 1, B, SEQ, DI)))
    Bc, Cc = _rand(seed + 2, B, SEQ, N), _rand(seed + 3, B, SEQ, N)
    A = -np.exp(np.log(np.arange(1, N + 1, dtype=np.float32)))[None, :] \
        .repeat(DI, 0)
    h0 = _rand(seed + 4, B, DI, N)
    return [torch.as_tensor(a) for a in (x, dt, Bc, Cc, A, h0)]


def _wkv_inputs(seed=3, H=2):
    hd = S.RWKV_HEAD_DIM
    r, k, v = (_rand(seed + i, B, SEQ, H, hd) for i in range(3))
    w = np.exp(-np.exp(_rand(seed + 3, B, SEQ, H, hd) - 1.0))
    u = _rand(seed + 4, H, hd)
    s0 = _rand(seed + 5, B, H, hd, hd)
    return [torch.as_tensor(a) for a in (r, k, v, w, u, s0)]


def test_selective_scan_plain_against_float64():
    ins = _scan_inputs()
    y, hT = selective_scan_plain(*ins)
    y64, h64 = selective_scan_plain(*(t.double() for t in ins))
    assert y.dtype == torch.float32 and hT.shape == (B, DI, N)
    np.testing.assert_allclose(y.numpy(), y64.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(hT.numpy(), h64.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_wkv6_plain_against_float64():
    ins = _wkv_inputs()
    y, sT = wkv6_plain(*ins)
    y64, s64 = wkv6_plain(*(t.double() for t in ins))
    assert y.dtype == torch.float32 and y.shape == ins[0].shape
    np.testing.assert_allclose(y.numpy(), y64.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(sT.numpy(), s64.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_selective_scan_split_carries_the_state():
    x, dt, Bc, Cc, A, h0 = _scan_inputs()
    y, hT = scan_ops.selective_scan(x, dt, Bc, Cc, A, h0)
    y1, h1 = scan_ops.selective_scan(x[:, :SPLIT], dt[:, :SPLIT],
                                     Bc[:, :SPLIT], Cc[:, :SPLIT], A, h0)
    y2, h2 = scan_ops.selective_scan(x[:, SPLIT:], dt[:, SPLIT:],
                                     Bc[:, SPLIT:], Cc[:, SPLIT:], A, h1)
    assert torch.equal(torch.cat([y1, y2], 1), y) and torch.equal(h2, hT)


def test_wkv6_split_carries_the_state():
    r, k, v, w, u, s0 = _wkv_inputs()
    y, sT = wkv_ops.wkv6(r, k, v, w, u, s0)
    cut = [t[:, :SPLIT] for t in (r, k, v, w)]
    y1, s1 = wkv_ops.wkv6(*cut, u, s0)
    y2, s2 = wkv_ops.wkv6(*(t[:, SPLIT:] for t in (r, k, v, w)), u, s1)
    assert torch.equal(torch.cat([y1, y2], 1), y) and torch.equal(s2, sT)


def test_plain_scans_are_differentiable_on_the_cpu():
    ins = [t.requires_grad_(True) for t in _scan_inputs()]
    y, hT = scan_ops.selective_scan(*ins)
    (y.square().sum() + hT.sum()).backward()
    assert all(t.grad is not None and torch.isfinite(t.grad).all()
               for t in ins)
    ins = [t.requires_grad_(True) for t in _wkv_inputs()]
    y, sT = wkv_ops.wkv6(*ins)
    (y.square().sum() + sT.sum()).backward()
    assert all(t.grad is not None and torch.isfinite(t.grad).all()
               for t in ins)


# ---- the recurrences against the reference's lax.scan -----------------------

@pytest.mark.parametrize("nonzero_h0", [False, True])
def test_ssm_recurrence(nonzero_h0):
    p = _ssm_params()
    x = _rand(4, B, SEQ, DI)
    h0 = _rand(5, B, DI, N) if nonzero_h0 else np.zeros((B, DI, N),
                                                         np.float32)
    jp, tp = _both(p, "float32")
    jy, jh = JS._ssm_recurrence(jp, jnp.asarray(x), jnp.asarray(h0))
    ty, th = S._ssm_recurrence(tp, torch.as_tensor(x), torch.as_tensor(h0))
    np.testing.assert_allclose(ty.numpy(), _np(jy), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(th.numpy(), _np(jh), rtol=1e-5, atol=1e-5)


def test_ssm_recurrence_split_matches_the_reference():
    """Two calls that carry the state against the reference's one."""
    p = _ssm_params()
    x = _rand(6, B, SEQ, DI)
    h0 = _rand(7, B, DI, N)
    jp, tp = _both(p, "float32")
    jy, jh = JS._ssm_recurrence(jp, jnp.asarray(x), jnp.asarray(h0))
    tx = torch.as_tensor(x)
    y1, h1 = S._ssm_recurrence(tp, tx[:, :SPLIT], torch.as_tensor(h0))
    y2, h2 = S._ssm_recurrence(tp, tx[:, SPLIT:], h1)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(), _np(jy),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(h2.numpy(), _np(jh), rtol=1e-5, atol=1e-5)


def test_softplus_is_the_reference():
    x = np.concatenate([_rand(8, 4096, scale=10.0),
                        np.array([0.0, -0.0, 30.0, -30.0, 1e-8], np.float32)])
    ref = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    np.testing.assert_allclose(S.softplus(torch.as_tensor(x)).numpy(), ref,
                               rtol=2e-7, atol=1e-7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_carry", [False, True])
def test_causal_conv(dtype, with_carry):
    x, conv = _rand(9, B, SEQ, DI), _rand(10, W, DI)
    carry = _rand(11, B, W - 1, DI) if with_carry else None
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    jo, jc = JS._causal_conv(jnp.asarray(x, jdt), jnp.asarray(conv, jdt),
                             None if carry is None else jnp.asarray(carry,
                                                                    jdt))
    to, tc = S._causal_conv(torch.as_tensor(x).to(tdt),
                            torch.as_tensor(conv).to(tdt),
                            None if carry is None else torch.as_tensor(
                                carry).to(tdt))
    assert to.dtype == tdt and tc.shape == (B, W - 1, DI)
    np.testing.assert_allclose(to.float().numpy(), _np(jo),
                               rtol=_tol(dtype), atol=_tol(dtype))
    np.testing.assert_array_equal(tc.float().numpy(), _np(jc))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_state", [False, True])
def test_ssm_apply(dtype, with_state):
    p = _ssm_params()
    x = _rand(12, B, SEQ, D)
    jp, tp = _both(p, dtype)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    state = carry = None
    jstate = jcarry = None
    if with_state:
        st, cr = _rand(13, B, DI, N), _rand(14, B, W - 1, DI)
        jstate, state = jnp.asarray(st), torch.as_tensor(st)
        jcarry, carry = jnp.asarray(cr, jdt), torch.as_tensor(cr).to(tdt)
    jy, (jst, jcr) = JS.ssm_apply(jp, jnp.asarray(x, jdt), jstate, jcarry)
    ty, (tst, tcr) = S.ssm_apply(tp, torch.as_tensor(x).to(tdt), state,
                                 carry)
    assert ty.dtype == tdt and tst.dtype == torch.float32
    tol = _tol(dtype)
    np.testing.assert_allclose(ty.float().numpy(), _np(jy), rtol=tol,
                               atol=tol)
    np.testing.assert_allclose(tst.numpy(), _np(jst), rtol=tol, atol=tol)
    np.testing.assert_array_equal(tcr.float().numpy(), _np(jcr))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nonzero_state", [False, True])
def test_rwkv_time_mix(dtype, nonzero_state):
    att, _ = _rwkv_params()
    H, hd = RW_D // S.RWKV_HEAD_DIM, S.RWKV_HEAD_DIM
    x = _rand(15, B, SEQ, RW_D)
    sx = _rand(16, B, RW_D) if nonzero_state else np.zeros((B, RW_D),
                                                           np.float32)
    s0 = _rand(17, B, H, hd, hd) if nonzero_state else np.zeros(
        (B, H, hd, hd), np.float32)
    jp, tp = _both(att, dtype)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    jy, jsx, js = JS.rwkv_time_mix(jp, jnp.asarray(x, jdt),
                                   jnp.asarray(sx, jdt), jnp.asarray(s0))
    ty, tsx, ts = S.rwkv_time_mix(tp, torch.as_tensor(x).to(tdt),
                                  torch.as_tensor(sx).to(tdt),
                                  torch.as_tensor(s0))
    assert ty.dtype == tdt and ts.dtype == torch.float32
    tol = _tol(dtype)
    np.testing.assert_allclose(ty.float().numpy(), _np(jy), rtol=tol,
                               atol=tol)
    np.testing.assert_array_equal(tsx.float().numpy(), _np(jsx))
    np.testing.assert_allclose(ts.numpy(), _np(js), rtol=tol, atol=tol)


def test_rwkv_time_mix_split_carries_the_state():
    """Two calls carrying sx and the WKV state against the reference's
    one call, float32."""
    att, _ = _rwkv_params()
    H, hd = RW_D // S.RWKV_HEAD_DIM, S.RWKV_HEAD_DIM
    x = _rand(18, B, SEQ, RW_D)
    s0 = _rand(19, B, H, hd, hd)
    jp, tp = _both(att, "float32")
    jy, _, js = JS.rwkv_time_mix(jp, jnp.asarray(x), jnp.zeros((B, RW_D)),
                                 jnp.asarray(s0))
    tx = torch.as_tensor(x)
    y1, sx1, s1 = S.rwkv_time_mix(tp, tx[:, :SPLIT], torch.zeros(B, RW_D),
                                  torch.as_tensor(s0))
    y2, _, s2 = S.rwkv_time_mix(tp, tx[:, SPLIT:], sx1, s1)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(), _np(jy),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(s2.numpy(), _np(js), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rwkv_channel_mix(dtype):
    _, ffn = _rwkv_params()
    x, sx = _rand(20, B, SEQ, RW_D), _rand(21, B, RW_D)
    jp, tp = _both(ffn, dtype)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    jy, jsx = JS.rwkv_channel_mix(jp, jnp.asarray(x, jdt),
                                  jnp.asarray(sx, jdt))
    ty, tsx = S.rwkv_channel_mix(tp, torch.as_tensor(x).to(tdt),
                                 torch.as_tensor(sx).to(tdt))
    assert ty.dtype == tdt
    tol = _tol(dtype)
    np.testing.assert_allclose(ty.float().numpy(), _np(jy), rtol=tol,
                               atol=tol)
    np.testing.assert_array_equal(tsx.float().numpy(), _np(jsx))


def test_rwkv_state_init():
    ref = JS.rwkv_state_init(2, RW_D)
    ours = S.rwkv_state_init(2, RW_D, "cpu")
    assert set(ours) == set(ref)
    for k, v in ref.items():
        assert tuple(ours[k].shape) == v.shape and not ours[k].any()
        assert str(ours[k].dtype).split(".")[-1] == str(v.dtype)
