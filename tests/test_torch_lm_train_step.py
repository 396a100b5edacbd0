"""The port's ``make_train_step`` against the JAX package's, on the CPU.

The four dense archs at SMOKE (chunks of 32), float32 and bfloat16, with
``n_microbatches`` 1 and 2 (``F32_CASES`` and ``BF16_CASES``): the
reference LM's weights (QKV biases made random) go through
``params_from_jax``, and both sides take 2 AdamW steps (lr 1e-3, weight
decay 0.1) on the same seeded batches (B 4 x S 64, a random loss mask).
The JAX step is jitted, as its launcher runs it.

At each step the port's gradients (``make_grad_fn``, the train step's
own) are taken at the JAX step's params, so they are held to the
reference's gradients on the same point: float32 within 1e-5 of each
leaf's largest gradient (summation order), bf16 within 5e-2 (both sides
round every matmul, residual and gradient to bf16, at places that differ
where XLA fuses).  The loss: float32 1e-6 relative, bf16 1e-4.

The params after each step are held where the gradient decides them.
Adam's first steps divide a gradient by its own size, so an element
whose gradient is near the summation noise (a sign that the order of
adds decides, or |g| ~ eps = 1e-8) moves by up to a whole learning rate
on one side and not on the other; a bias of k that softmax nearly
ignores is such a leaf.  So every element is held within 4 x lr (two
Adam steps of at most ~1.4 lr each, plus weight decay), and the elements
whose gradient is at least a share of its leaf's largest at every step
so far are held close: float32 (share 1e-2) within 1e-5; bf16 (share
0.1, ten times the gradients' own disagreement) within one bf16 step of
the param (2^-8 relative) + 0.5 lr.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import steps as JST
from repro_torch import configs as C
from repro_torch.launch import steps as ST
from repro_torch.models import transformer as T
from test_torch_lm_train import DENSE, jax_model

# one intra-op thread: the suite runs in parallel workers, and
# torch's default of a thread a core in each oversubscribes the CPU
torch.set_num_threads(1)

LR = 1e-3
B, S = 4, 64


def _grads_jax(model, params, batch, n):
    """The reference train step's gradient: ``forward_loss`` (with
    experts, plus 0.01 x the load-balance loss) per microbatch,
    accumulated in float32 (n <= 4) and cast, as
    ``repro/launch/steps.py:53-84`` does."""
    def loss_fn(p, b):
        loss, aux = model.forward_loss(p, b["tokens"], b["labels"],
                                       loss_mask=b["loss_mask"])
        return loss + 0.01 * aux if model.cfg.moe else loss
    if n == 1:
        return jax.value_and_grad(loss_fn)(params, batch)
    loss, acc = 0.0, jax.tree.map(
        lambda p: jnp.zeros(p.shape, jnp.float32), params)
    for i in range(n):
        mb = jax.tree.map(lambda a: a.reshape(n, a.shape[0] // n,
                                              *a.shape[1:])[i], batch)
        lb, g = jax.value_and_grad(loss_fn)(params, mb)
        acc = jax.tree.map(lambda a, gi: a + gi.astype(a.dtype), acc, g)
        loss = loss + lb
    return loss / n, jax.tree.map(lambda a, p: (a / n).astype(p.dtype), acc,
                                  params)


# every arch in float32 with one microbatch and in bf16 with two; danube
# (the arch the smoke trains at full width) in all four combinations
F32_CASES = [(arch, "float32", 1) for arch in DENSE] + [
    ("h2o-danube-1.8b", "float32", 2)]
BF16_CASES = [(arch, "bfloat16", 2) for arch in DENSE] + [
    ("h2o-danube-1.8b", "bfloat16", 1)]


def case_id(case):
    return f"{case[0]}-{case[1]}-mb{case[2]}"


@pytest.fixture(scope="module", params=F32_CASES + BF16_CASES, ids=case_id)
def two_steps(request):
    return run_two_steps(*request.param)


def run_two_steps(arch, dt, n):
    """Both packages' two steps of one case: per step the loss, the
    gradients at the JAX step's params and the params after it."""
    jdt = jnp.float32 if dt == "float32" else jnp.bfloat16
    model, tree = jax_model(arch, jdt)
    rng = np.random.default_rng(7)
    batches = [{"tokens": rng.integers(0, model.cfg.vocab, (B, S)),
                "labels": rng.integers(0, model.cfg.vocab, (B, S)),
                "loss_mask": (rng.random((B, S)) > 0.2).astype(np.float32)}
               for _ in range(2)]
    jopt, jstep = JST.make_train_step(model, lr=LR, n_microbatches=n)

    @jax.jit
    def jboth(p, state, b):              # one compile: grads, then the step
        return _grads_jax(model, p, b, n), jstep(p, state, b)

    jp = jax.tree.map(jnp.asarray, tree)
    jstate = jopt.init(jp)

    ours = ST.build_model(C.get_smoke(arch).resolve(1), remat=True,
                          q_chunk=32, kv_chunk=32, dtype=getattr(torch, dt),
                          device="cpu")
    opt, step = ST.make_train_step(ours, lr=LR, n_microbatches=n)
    grad_fn = ST.make_grad_fn(ours, n_microbatches=n)
    params = T.params_from_jax(tree)
    state = opt.init(T.tree_leaves(params))
    records = []
    for b in batches:
        jb = {k: jnp.asarray(v, jnp.int32 if k != "loss_mask" else None)
              for k, v in b.items()}
        tb = {k: torch.as_tensor(v, dtype=torch.int32
                                 if k != "loss_mask" else None)
              for k, v in b.items()}
        g, loss_g, _ = grad_fn(T.params_from_jax(
            jax.tree.map(np.asarray, jp)), tb)
        (jloss_g, jg), (jp, jstate, jm) = jboth(jp, jstate, jb)
        jg = [np.asarray(x, np.float32) for x in jax.tree.leaves(jg)]
        params, state, m = step(params, state, tb)
        records.append({
            "loss": (float(jm["loss"]), float(m["loss"])),
            "grad_loss": (float(jloss_g), float(loss_g)),
            "grads": (jg, [x.float().numpy() for x in g]),
            "params": ([np.asarray(x, np.float32)
                        for x in jax.tree.leaves(jp)],
                       [x.float().numpy().copy()
                        for x in T.tree_leaves(params)]),
            "moe_aux": (float(jm["moe_aux"]), m["moe_aux"])})
    return dt, records


def test_train_step_loss(two_steps):
    dt, records = two_steps
    rtol = 1e-6 if dt == "float32" else 1e-4
    for r in records:
        assert np.isfinite(r["loss"][1])
        np.testing.assert_allclose(r["loss"][1], r["loss"][0], rtol=rtol)
        np.testing.assert_allclose(r["grad_loss"][1], r["grad_loss"][0],
                                   rtol=rtol)
        assert r["moe_aux"] == (0.0, 0.0)
    assert records[0]["loss"][1] != records[1]["loss"][1]


def test_train_step_gradients(two_steps):
    dt, records = two_steps
    limit = 1e-5 if dt == "float32" else 5e-2
    for r in records:
        for j, t in zip(*r["grads"]):
            assert t.shape == j.shape
            scale = np.abs(j).max()
            assert np.abs(t - j).max() <= limit * scale + 1e-12


def test_train_step_params(two_steps):
    dt, records = two_steps
    share, close = (1e-2, 1e-5) if dt == "float32" else (0.1, 0.5 * LR)
    decided = None
    for r in records:
        now = [np.abs(g) >= share * np.abs(g).max() for g in r["grads"][0]]
        decided = now if decided is None else [
            a & b for a, b in zip(decided, now)]
        for d, j, t in zip(decided, *r["params"]):
            diff = np.abs(t - j)
            assert diff.max() <= 4 * LR
            if dt == "bfloat16":
                diff = diff - 2.0 ** -8 * np.abs(j)
            assert d.any() and diff[d].max() <= close
