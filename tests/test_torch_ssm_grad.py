"""The backward of the SSM's and RWKV's scans (K3's and K4's) on the CPU.

``selective_scan_bwd_plain`` and ``wkv6_bwd_plain`` are the reverse-time
loops that K3-bwd and K4-bwd run (the states recomputed a chunk at a
time from the ones saved at the chunks' starts, then walked back).  They
are held to autograd through the plain forward loops (1e-10 of each
gradient's largest entry in float64; 1e-5 in float32, where the two sum
in other orders), and, through the port's ``_ssm_recurrence`` and
``rwkv_time_mix``, to ``jax.vjp`` of the reference's on the same seeded
numpy inputs as ``tests/test_torch_ssm.py`` (1e-5: the projections' dots
run in other orders).

The ops' ``autograd.Function``s run on the card only.  Here their CUDA
wrappers are replaced by plain stand-ins of the same contract (the
forward also returns the chunk states; the backward is the plain loop),
so the Functions' own work -- what they save, the dtypes they hand back,
a ``None`` gradient of the last state, which inputs need a gradient --
is held to autograd through the plain loop: S below, at and past a
chunk, S = 1, a nonzero starting state, the last state's gradient given
and None, x (r, k, v) in float32 and bfloat16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as JS
from repro_torch.kernels.selective_scan import ops as scan_ops
from repro_torch.kernels.selective_scan.ref import (
    CHUNK as SCAN_CHUNK, selective_scan_bwd_plain, selective_scan_plain,
    selective_scan_states_plain)
from repro_torch.kernels.wkv6 import ops as wkv_ops
from repro_torch.kernels.wkv6.ref import (CHUNK as WKV_CHUNK,
                                          wkv6_bwd_plain, wkv6_plain,
                                          wkv6_states_plain)
from repro_torch.models import ssm as S
from test_torch_ssm import (B, DI, N, RW_D, SEQ, _both, _np, _rand,
                            _rwkv_params, _ssm_params)

# one intra-op thread: the suite runs in parallel workers, and
# torch's default of a thread a core in each oversubscribes the CPU
torch.set_num_threads(1)

# below a chunk, one K3 chunk, past one K3 chunk and K4's two
LENGTHS = (1, 7, 16, 32, 40)


def _rel(a, b) -> float:
    """max |a - b| over max |b| (0 where both are zero)."""
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))


def _scan_inputs(S_, dtype, seed=0, Di=12, N_=4):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, S_, Di)) * 0.5
    dt = np.log1p(np.exp(rng.normal(size=(2, S_, Di)) - 1.0))
    Bc, Cc = (rng.normal(size=(2, S_, N_)) * 0.3 for _ in range(2))
    A = -np.broadcast_to(np.arange(1, N_ + 1, dtype=np.float64), (Di, N_))
    h0 = rng.normal(size=(2, Di, N_)) * 0.1
    return [torch.as_tensor(np.ascontiguousarray(a), dtype=dtype)
            for a in (x, dt, Bc, Cc, A, h0)]


def _wkv_inputs(S_, dtype, seed=1, H=2):
    rng = np.random.default_rng(seed)
    shape = (2, S_, H, 64)
    r, k, v = (rng.normal(size=shape) * 0.5 for _ in range(3))
    w = np.exp(-np.exp(rng.normal(size=shape) - 1.0))
    u = rng.normal(size=(H, 64)) * 0.5
    s0 = rng.normal(size=(2, H, 64, 64)) * 0.1
    return [torch.as_tensor(a, dtype=dtype) for a in (r, k, v, w, u, s0)]


def _autograd(fn, ins, dy, dlast):
    """Gradients of sum(y dy) + sum(last dlast) through ``fn`` (zeros for
    an input that does not reach the loss: w at S = 1 without dlast)."""
    ins = [t.detach().requires_grad_(True) for t in ins]
    y, last = fn(*ins)
    loss = (y.double() * dy.double()).sum()
    if dlast is not None:
        loss = loss + (last.double() * dlast.double()).sum()
    grads = torch.autograd.grad(loss, ins, allow_unused=True)
    return [torch.zeros_like(t) if g is None else g
            for g, t in zip(grads, ins)]


# ---- the plain backwards against autograd ------------------------------------

@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10),
                                       (torch.float32, 1e-5)])
@pytest.mark.parametrize("S_", LENGTHS)
@pytest.mark.parametrize("with_dhT", [True, False])
def test_selective_scan_bwd_plain_against_autograd(dtype, tol, S_, with_dhT):
    ins = _scan_inputs(S_, dtype)
    g = torch.Generator().manual_seed(S_)
    dy = torch.randn(ins[0].shape, generator=g, dtype=torch.float64).to(dtype)
    dhT = torch.randn(ins[5].shape, generator=g,
                      dtype=torch.float64).to(dtype) if with_dhT else None
    want = _autograd(selective_scan_plain, ins, dy, dhT)
    got = selective_scan_bwd_plain(*ins, dy, dhT)
    for name, a, b in zip(("dx", "ddt", "dB", "dC", "dA", "dh0"), got, want):
        assert a.dtype == dtype and a.shape == b.shape, name
        assert _rel(a, b) <= tol, (name, _rel(a, b))


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10),
                                       (torch.float32, 1e-5)])
@pytest.mark.parametrize("S_", LENGTHS)
@pytest.mark.parametrize("with_dsT", [True, False])
def test_wkv6_bwd_plain_against_autograd(dtype, tol, S_, with_dsT):
    ins = _wkv_inputs(S_, dtype)
    g = torch.Generator().manual_seed(S_)
    dy = torch.randn(ins[0].shape, generator=g, dtype=torch.float64).to(dtype)
    dsT = torch.randn(ins[5].shape, generator=g,
                      dtype=torch.float64).to(dtype) if with_dsT else None
    want = _autograd(wkv6_plain, ins, dy, dsT)
    got = wkv6_bwd_plain(*ins, dy, dsT)
    for name, a, b in zip(("dr", "dk", "dv", "dw", "du", "ds0"), got, want):
        assert a.dtype == dtype and a.shape == b.shape, name
        assert _rel(a, b) <= tol, (name, _rel(a, b))


def test_plain_chunk_states_are_the_forward_run_in_chunks():
    """The saved states are the plain forward's at each chunk's start,
    and the chunked run gives the one-call run's y and last state."""
    ins = _scan_inputs(70, torch.float32)
    y, hT, hs = selective_scan_states_plain(*ins)
    y1, h1 = selective_scan_plain(*ins)
    assert torch.equal(y, y1) and torch.equal(hT, h1)
    assert hs.shape == (2, 3, 12, 4) and torch.equal(hs[:, 0], ins[5])
    _, h32 = selective_scan_plain(*(t[:, :SCAN_CHUNK] for t in ins[:4]),
                                  *ins[4:])
    assert torch.equal(hs[:, 1], h32)
    ins = _wkv_inputs(40, torch.float32)
    y, sT, hs = wkv6_states_plain(*ins)
    y1, s1 = wkv6_plain(*ins)
    assert torch.equal(y, y1) and torch.equal(sT, s1)
    assert hs.shape == (2, 2, 3, 64, 64) and torch.equal(hs[:, :, 0], ins[5])
    _, s16 = wkv6_plain(*(t[:, :WKV_CHUNK] for t in ins[:4]), *ins[4:])
    assert torch.equal(hs[:, :, 1], s16)


# ---- the ops' Functions, with plain stand-ins for the kernels ----------------

class _PlainScanKernels:
    """CPU stand-ins of the CUDA wrappers' contracts, counting calls."""

    def __init__(self, states, bwd, start):
        self.states, self.bwd, self.start = states, bwd, start
        self.fwd_calls = self.bwd_calls = 0

    def fwd(self, *ins, save_states=False):
        self.fwd_calls += 1
        y, last, hs = self.states(*ins)
        return (y, last, hs) if save_states else (y, last)

    def grad(self, *args):
        self.bwd_calls += 1
        *ins, hs, dy, dlast = args
        return self.bwd(*ins, self.start(hs), dy, dlast)


@pytest.fixture
def scan_kernels(monkeypatch):
    k = _PlainScanKernels(selective_scan_states_plain,
                          selective_scan_bwd_plain, lambda hs: hs[:, 0])
    monkeypatch.setattr(scan_ops, "selective_scan_cuda", k.fwd)
    monkeypatch.setattr(scan_ops, "selective_scan_grad_cuda", k.grad)
    return k


@pytest.fixture
def wkv_kernels(monkeypatch):
    k = _PlainScanKernels(wkv6_states_plain, wkv6_bwd_plain,
                          lambda hs: hs[:, :, 0])
    monkeypatch.setattr(wkv_ops, "wkv6_cuda", k.fwd)
    monkeypatch.setattr(wkv_ops, "wkv6_grad_cuda", k.grad)
    return k


@pytest.mark.parametrize("S_", (1, 7, 40))
@pytest.mark.parametrize("with_dhT", [True, False])
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
def test_selective_scan_function_gives_the_plain_gradients(
        scan_kernels, S_, with_dhT, x_dtype):
    ins = _scan_inputs(S_, torch.float32, seed=S_)
    ins[0] = ins[0].to(x_dtype)
    g = torch.Generator().manual_seed(7)
    dy = torch.randn(ins[0].shape, generator=g).to(x_dtype)
    dhT = torch.randn(ins[5].shape, generator=g) if with_dhT else None
    want = _autograd(selective_scan_plain, ins, dy, dhT)
    live = [t.detach().requires_grad_(True) for t in ins]
    y, hT = scan_ops._SelectiveScan.apply(*live)
    yp, hp = selective_scan_plain(*ins)
    assert torch.equal(y, yp) and torch.equal(hT, hp)
    outs, grads = [y], [dy]
    if with_dhT:
        outs.append(hT)
        grads.append(dhT)
    got = torch.autograd.grad(outs, live, grads)
    assert scan_kernels.fwd_calls == 1 and scan_kernels.bwd_calls == 1
    for name, a, b, t in zip(("dx", "ddt", "dB", "dC", "dA", "dh0"), got,
                             want, ins):
        assert a.dtype == t.dtype, name
        tol = 1e-5 if t.dtype == torch.float32 else 2 ** -8
        assert _rel(a, b) <= tol, (name, _rel(a, b))


def test_selective_scan_function_needs_only_what_is_asked(scan_kernels):
    """Inputs that need no gradient get None; the state's start (zeros,
    as training passes it) among them."""
    x, dt, Bc, Cc, A, h0 = _scan_inputs(40, torch.float32)
    x.requires_grad_(True)
    A.requires_grad_(True)
    y, _ = scan_ops._SelectiveScan.apply(x, dt, Bc, Cc, A,
                                         torch.zeros_like(h0))
    y.square().sum().backward()
    assert x.grad is not None and A.grad is not None
    assert dt.grad is None and h0.grad is None


@pytest.mark.parametrize("S_", (1, 7, 40))
@pytest.mark.parametrize("with_dsT", [True, False])
@pytest.mark.parametrize("rkv_dtype", [torch.float32, torch.bfloat16])
def test_wkv6_function_gives_the_plain_gradients(wkv_kernels, S_, with_dsT,
                                                 rkv_dtype):
    ins = _wkv_inputs(S_, torch.float32, seed=S_)
    for i in range(3):
        ins[i] = ins[i].to(rkv_dtype)
    ins[4] = ins[4].to(rkv_dtype)              # u in the model's dtype
    g = torch.Generator().manual_seed(7)
    dy = torch.randn(ins[0].shape, generator=g)
    dsT = torch.randn(ins[5].shape, generator=g) if with_dsT else None
    want = _autograd(wkv6_plain, ins, dy, dsT)
    live = [t.detach().requires_grad_(True) for t in ins]
    y, sT = wkv_ops._WKV6.apply(*live)
    yp, sp = wkv6_plain(*ins)
    assert torch.equal(y, yp) and torch.equal(sT, sp)
    outs, grads = [y], [dy]
    if with_dsT:
        outs.append(sT)
        grads.append(dsT)
    got = torch.autograd.grad(outs, live, grads)
    assert wkv_kernels.fwd_calls == 1 and wkv_kernels.bwd_calls == 1
    for name, a, b, t in zip(("dr", "dk", "dv", "dw", "du", "ds0"), got,
                             want, ins):
        assert a.dtype == t.dtype, name
        tol = 1e-5 if t.dtype == torch.float32 else 2 ** -8
        assert _rel(a, b) <= tol, (name, _rel(a, b))


# ---- through the port's mixers against jax.vjp of the reference's ------------

def _vjp_check(jfn, jargs, tfn, targs, seed):
    """Cotangents drawn from ``seed`` for every output; the port's
    gradients of every input against ``jax.vjp``'s within 1e-5 of each
    leaf's largest."""
    jout, pull = jax.vjp(jfn, *jargs)
    rng = np.random.default_rng(seed)
    cots = [rng.normal(size=np.shape(o)).astype(np.float32)
            for o in jax.tree.leaves(jout)]
    jgrads = jax.tree.leaves(pull(jax.tree.unflatten(
        jax.tree.structure(jout), [jnp.asarray(c) for c in cots])))
    live = [t.requires_grad_(True) for t in jax.tree.leaves(
        targs, is_leaf=lambda t: isinstance(t, torch.Tensor))]
    tout = tfn(*targs)
    tgrads = torch.autograd.grad(list(tout), live,
                                 [torch.as_tensor(c) for c in cots])
    assert len(tgrads) == len(jgrads)
    for a, b in zip(tgrads, jgrads):
        b = _np(b)
        err = float(np.abs(a.numpy() - b).max() / max(np.abs(b).max(),
                                                      1e-30))
        assert err <= 1e-5, err


def test_ssm_recurrence_gradients_are_the_reference(scan_kernels,
                                                    monkeypatch):
    """``_ssm_recurrence`` through ``_SelectiveScan`` (its backward the
    plain loop) against ``jax.vjp`` of the reference's: the gradients of
    every parameter it reads, of x and of h0."""
    monkeypatch.setattr(scan_ops, "selective_scan",
                        scan_ops._SelectiveScan.apply)
    keys = ("wdt", "wB", "wC", "logA")
    p = {k: v for k, v in _ssm_params().items() if k in keys}
    x, h0 = _rand(4, B, SEQ, DI), _rand(5, B, DI, N)
    jp, tp = _both(p, "float32")
    _vjp_check(lambda q, a, h: JS._ssm_recurrence(q, a, h),
               (jp, jnp.asarray(x), jnp.asarray(h0)),
               lambda q, a, h: S._ssm_recurrence(q, a, h),
               (tp, torch.as_tensor(x), torch.as_tensor(h0)), seed=8)
    assert scan_kernels.fwd_calls == 1 and scan_kernels.bwd_calls == 1


def test_rwkv_time_mix_gradients_are_the_reference(wkv_kernels,
                                                   monkeypatch):
    """``rwkv_time_mix`` through ``_WKV6`` (its backward the plain loop)
    against ``jax.vjp`` of the reference's: every parameter, x, sx and
    the state."""
    monkeypatch.setattr(wkv_ops, "wkv6", wkv_ops._WKV6.apply)
    att, _ = _rwkv_params()
    H, hd = RW_D // S.RWKV_HEAD_DIM, S.RWKV_HEAD_DIM
    x, sx = _rand(15, B, SEQ, RW_D), _rand(16, B, RW_D)
    s0 = _rand(17, B, H, hd, hd)
    jp, tp = _both(att, "float32")
    _vjp_check(JS.rwkv_time_mix,
               (jp, jnp.asarray(x), jnp.asarray(sx), jnp.asarray(s0)),
               S.rwkv_time_mix,
               (tp, torch.as_tensor(x), torch.as_tensor(sx),
                torch.as_tensor(s0)), seed=9)
    assert wkv_kernels.fwd_calls == 1 and wkv_kernels.bwd_calls == 1
