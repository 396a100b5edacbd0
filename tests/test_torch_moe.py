"""The port's ``moe_apply`` and ``moe_load_balance_loss`` against the JAX
package's, on the CPU.

The same seeded numpy inputs go through ``repro.models.layers.moe_apply``
(jitted, ``constrain`` recording the block-local ``tok_buf`` and ``w_buf``
it pins, ``jax.lax.top_k`` recording the routes) and the port's
``moe_route``/``moe_apply``: the SMOKE widths (d 256, d_ff 128, 4
experts, top-2) and a fine-grained case (64 experts, top-8, d 64), in
float32 and bf16, with 1 and 2 sequence chunks, a capacity factor of 0.5
that drops slots, the GELU experts, and a single decode token (capacity
1).

- Routing is equal: ``top_e`` and ``tok_buf`` exactly, ``w_buf`` bit for
  bit in bf16 and within 1e-6 in float32 (a float32 softmax of its own).
- The combine, fed the reference's own expert rows and weights, is the
  reference's output bit for bit in both dtypes: each token's rows are
  added in ascending slot order, rounding after every add, as the
  reference's scatter-add adds them.
- bf16 output: bit for bit at d 64; at d 256 the expert products
  accumulate their 256-term (and 128-term) dots in another order than
  XLA's CPU dot, which moves a handful of entries by 1-2 bf16 ulps (4
  of 32768 at most here), so within 2 ulps on at most 1e-3 of the
  entries.  float32 output within 1e-6 of its largest entry, the
  load-balance loss within 1e-6 relative.
- ``jax.grad`` against autograd for x, the router and the experts in
  float32: 1e-5 of each gradient's largest entry.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.models import layers as L

# one intra-op thread: the suite runs in parallel workers, and
# torch's default of a thread a core in each oversubscribes the CPU
torch.set_num_threads(1)

CASES = {
    "smoke-f32": dict(dtype="float32"),
    "smoke-bf16": dict(dtype="bfloat16"),
    "chunks2-f32": dict(dtype="float32", seq_chunks=2),
    "chunks2-bf16": dict(dtype="bfloat16", seq_chunks=2),
    "drops-f32": dict(dtype="float32", capacity_factor=0.5),
    "drops-bf16": dict(dtype="bfloat16", capacity_factor=0.5,
                       seq_chunks=2),
    "gelu-bf16": dict(dtype="bfloat16", act="gelu"),
    "e64k8-f32": dict(dtype="float32", D=64, F=32, E=64, K=8),
    "e64k8-bf16": dict(dtype="bfloat16", D=64, F=32, E=64, K=8),
    "decode-f32": dict(dtype="float32", S=1),
    "decode-bf16": dict(dtype="bfloat16", S=1, D=64, F=32, E=64, K=8),
}


def _inputs(B, S, D, F, E, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, S, D)).astype(np.float32)
    p = {"router": rng.normal(size=(D, E)) * 2 / np.sqrt(D),
         "wg": rng.normal(size=(E, D, F)) / np.sqrt(D),
         "wu": rng.normal(size=(E, D, F)) / np.sqrt(D),
         "wo": rng.normal(size=(E, F, D)) / np.sqrt(F)}
    return x, {k: v.astype(np.float32) for k, v in p.items()}


def run_both(dtype, B=2, S=64, D=256, F=128, E=4, K=2,
             capacity_factor=1.25, seq_chunks=1, act="swiglu", seed=0):
    """Both packages' MoE on one case: the reference's routes and pinned
    buffers beside the port's routing, outputs and losses."""
    x, p = _inputs(B, S, D, F, E, seed)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    kw = dict(n_experts=E, top_k=K, capacity_factor=capacity_factor)
    top_k = jax.lax.top_k

    def reference(p, x):
        """The reference's output and loss, its routes and its pins."""
        pins, tops = [], []

        def record_top_k(probs, k):
            tops.append(top_k(probs, k))
            return tops[-1]

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax.lax, "top_k", record_top_k)
            y, aux = JL.moe_apply(
                p, x, act=act, constrain=lambda t, *axes: pins.append(t) or t,
                seq_chunks=seq_chunks, **kw)
        return y, aux, tops, pins

    jy, jaux, tops, pins = jax.jit(reference)(
        {k: jnp.asarray(v, jnp.float32 if k == "router" else jdt)
         for k, v in p.items()}, jnp.asarray(x, jdt))
    tp = {k: torch.tensor(v).to(torch.float32 if k == "router" else tdt)
          for k, v in p.items()}
    tx = torch.tensor(x).to(tdt)
    route = L.moe_route(tx, tp["router"], seq_chunks=seq_chunks, **kw)
    y, aux = L.moe_apply(tp, tx, act=act, seq_chunks=seq_chunks, **kw)
    return {"dtype": dtype, "K": K,
            "ref": {"top_e": np.asarray(tops[0][1]),
                    "tok_buf": np.asarray(pins[0]),
                    "w_buf": np.asarray(pins[1], np.float32),
                    # the rows the reference combines, and its sum of them
                    "expert_out": np.asarray(pins[4], np.float32),
                    "combined": np.asarray(pins[5], np.float32),
                    "y": np.asarray(jy, np.float32), "aux": float(jaux),
                    "y_bits": np.asarray(jy).view(np.uint16)
                    if dtype == "bfloat16" else None},
            "route": route, "y": y, "aux": aux}


@pytest.fixture(scope="module", params=list(CASES))
def both(request):
    return request.param, run_both(**CASES[request.param])


def test_routing_is_the_reference(both):
    name, r = both
    ref, route = r["ref"], r["route"]
    np.testing.assert_array_equal(route.top_e.numpy(), ref["top_e"])
    np.testing.assert_array_equal(route.tok_buf.numpy(), ref["tok_buf"])
    w = route.w_buf.float().numpy()
    if r["dtype"] == "bfloat16":
        assert route.w_buf.dtype == torch.bfloat16
        np.testing.assert_array_equal(w, ref["w_buf"])
    else:
        np.testing.assert_allclose(w, ref["w_buf"], rtol=0, atol=1e-6)
    if name.startswith("drops"):
        assert route.dropped_share() > 0.2
    if name.startswith("decode"):
        assert route.cap == 1 and route.dropped_share() == 0.0


def test_combine_is_the_reference_bit_for_bit(both):
    _, r = both
    route, ref = r["route"], r["ref"]
    dt = getattr(torch, r["dtype"])
    tok, slots = L.expert_rows(route)
    rows = L.expert_major(route, torch.tensor(ref["expert_out"]).to(dt))
    w = L.expert_major(route, torch.tensor(ref["w_buf"]).to(dt))
    y = L._Combine.apply(rows * w[:, None], slots, tok)
    np.testing.assert_array_equal(y.float().numpy(),
                                  ref["combined"].reshape(y.shape))


def test_output_is_the_reference(both):
    _, r = both
    y = r["y"]
    assert y.dtype == getattr(torch, r["dtype"])
    assert y.shape == r["ref"]["y"].shape
    if r["dtype"] == "bfloat16":
        ulps = np.abs(y.view(torch.int16).numpy().view(np.uint16).astype(
            np.int32) - r["ref"]["y_bits"].astype(np.int32))
        assert ulps.max() <= 2 and (ulps > 0).mean() <= 1e-3
    else:
        ref = r["ref"]["y"]
        assert np.abs(y.numpy() - ref).max() <= 1e-6 * np.abs(ref).max()


def test_load_balance_loss_is_the_reference(both):
    _, r = both
    assert r["aux"].dtype == torch.float32 and r["aux"].dim() == 0
    np.testing.assert_allclose(float(r["aux"]), r["ref"]["aux"], rtol=1e-6)


def test_load_balance_loss_alone():
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(50, 8)).astype(np.float32)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    top_e = np.argsort(-probs, axis=-1)[:, :3]
    ref = JL.moe_load_balance_loss(jnp.asarray(probs), jnp.asarray(top_e), 8)
    out = L.moe_load_balance_loss(torch.tensor(probs), torch.tensor(top_e),
                                  8)
    np.testing.assert_allclose(float(out), float(ref), rtol=1e-6)


@pytest.mark.parametrize("case", [
    dict(), dict(capacity_factor=0.5, seq_chunks=2),
    dict(act="gelu", capacity_factor=0.5),
    dict(D=64, F=32, E=64, K=8)], ids=["smoke", "drops-chunks2", "gelu",
                                       "e64k8"])
def test_gradients_are_jax_grad(case):
    """d(sum(y * gy) + 0.3 aux) for x, the router and the experts, float32."""
    case = {"B": 2, "S": 32, "D": 256, "F": 128, "E": 4, "K": 2,
            "capacity_factor": 1.25, "seq_chunks": 1, "act": "swiglu",
            **case}
    B, S, D, F, E, K = (case[k] for k in "BSDFEK")
    x, p = _inputs(B, S, D, F, E, seed=1)
    if case["act"] == "gelu":
        del p["wg"]
    gy = np.random.default_rng(2).normal(size=(B, S, D)).astype(np.float32)
    kw = dict(n_experts=E, top_k=K, capacity_factor=case["capacity_factor"],
              act=case["act"], seq_chunks=case["seq_chunks"])

    def f(p, x):
        y, aux = JL.moe_apply(p, x, **kw)
        return (y * gy).sum() + 0.3 * aux

    jg, jgx = jax.jit(jax.grad(f, argnums=(0, 1)))(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
    tx = torch.tensor(x, requires_grad=True)
    y, aux = L.moe_apply(tp, tx, **kw)
    ((y * torch.tensor(gy)).sum() + 0.3 * aux).backward()
    for name, t, j in [("x", tx, jgx)] + [(k, tp[k], jg[k]) for k in p]:
        j = np.asarray(j)
        assert np.abs(j).max() > 0, name
        assert np.abs(t.grad.numpy() - j).max() <= 1e-5 * np.abs(j).max(), \
            name


def test_combine_uses_no_atomics():
    """The combine and its backward, and the dispatch's backward, are
    ordered gathers and adds: no ``index_add_``/``scatter_add_``."""
    for fn in (L._ordered_sum, L._gather_rows, L._padded, L._Dispatch,
               L._Combine, L.moe_apply):
        src = inspect.getsource(fn)
        assert "index_add_(" not in src and "scatter_add" not in src

