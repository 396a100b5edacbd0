"""The port's ``make_train_step`` on the MoE archs against the JAX
package's, on the CPU.

olmoe-1b-7b and dbrx-132b at SMOKE (chunks of 32), float32 with one
microbatch and bf16 with two, through ``test_torch_lm_train_step``'s
``run_two_steps``: 2 AdamW steps (lr 1e-3, weight decay 0.1,
``moe_aux_weight`` 0.01) on the same seeded batches, from the reference
LM's weights (the float32 router carried bit for bit).  The gradients
are taken at the JAX step's params on both sides.

float32 is held by that file's rules (the loss 1e-6 relative, each
gradient leaf within 1e-5 of its largest entry, the params within 1e-5
where the gradient decides them), and the load-balance loss the step
reports (``moe_aux``, the mean over layers) within 1e-6 relative.

bf16 cannot be held element by element.  The SMOKE routers start near
uniform (4 experts, probabilities 0.2-0.3), and a token whose k-th and
(k+1)-th router probabilities are nearly tied routes to another expert
on each side, since the two sides round the bf16 stream that feeds the
float32 router at different places (``test_torch_lm``); a flipped token
moves its share of the gradient from one expert to another.  Over 2 x 2
microbatches x 2 layers such flips are many: a leaf's largest gradient
entry differs by up to 17%, its root mean square by up to 12% (the
router's).  So bf16 holds the loss within 1e-3 relative (the largest
seen: 1.7e-4), ``moe_aux`` within 1e-2 (9e-4 seen), each gradient
leaf's rms error within 0.2 of its rms, and every param within 4 lr,
the router kept float32.  ``moe_apply`` itself is held to the
reference in bf16 bit for bit on one input (``test_torch_moe``).
"""

import numpy as np
import pytest
import torch

from test_torch_lm_train_step import (
    LR, test_train_step_gradients as _check_gradients,
    test_train_step_params as _check_params, run_two_steps)

# one intra-op thread: the suite runs in parallel workers, and
# torch's default of a thread a core in each oversubscribes the CPU
torch.set_num_threads(1)

CASES = [("olmoe-1b-7b", "float32", 1), ("dbrx-132b", "float32", 1),
         ("olmoe-1b-7b", "bfloat16", 2), ("dbrx-132b", "bfloat16", 2)]


@pytest.fixture(scope="module", params=CASES,
                ids=lambda c: f"{c[0]}-{c[1]}-mb{c[2]}")
def moe_steps(request):
    return run_two_steps(*request.param)


def test_moe_train_step_loss_and_aux(moe_steps):
    dt, records = moe_steps
    rtol, aux_rtol = (1e-6, 1e-6) if dt == "float32" else (1e-3, 1e-2)
    for r in records:
        assert np.isfinite(r["loss"][1])
        np.testing.assert_allclose(r["loss"][1], r["loss"][0], rtol=rtol)
        np.testing.assert_allclose(r["grad_loss"][1], r["grad_loss"][0],
                                   rtol=rtol)
        jaux, taux = r["moe_aux"]
        assert isinstance(taux, torch.Tensor) and taux.dtype == torch.float32
        assert jaux > 0
        np.testing.assert_allclose(float(taux), jaux, rtol=aux_rtol)
    assert records[0]["loss"][1] != records[1]["loss"][1]


def test_moe_train_step_gradients(moe_steps):
    dt, records = moe_steps
    if dt == "float32":
        _check_gradients(moe_steps)
        return
    for r in records:
        for j, t in zip(*r["grads"]):
            assert t.shape == j.shape
            assert np.linalg.norm(t - j) <= 0.2 * np.linalg.norm(j)


def test_moe_train_step_params(moe_steps):
    dt, records = moe_steps
    if dt == "float32":
        _check_params(moe_steps)
        return
    for r in records:
        for j, t in zip(*r["params"]):
            assert np.abs(t - j).max() <= 4 * LR


def test_moe_router_stays_float32():
    """The float32 router of a bf16 model keeps its dtype through the
    step, and its moments are float32 too."""
    from repro_torch import configs as C
    from repro_torch.launch import steps as ST
    from repro_torch.models.transformer import tree_leaves
    model = ST.build_model(C.get_smoke("olmoe-1b-7b").resolve(1),
                           q_chunk=32, kv_chunk=32, device="cpu")
    params = model.init_params(0)
    opt, step = ST.make_train_step(model)
    state = opt.init(tree_leaves(params))
    tok = torch.zeros((1, 32), dtype=torch.int32)
    router = params["layers"]["moe"]["router"]
    before = router.clone()
    params, state, m = step(params, state, {"tokens": tok, "labels": tok})
    assert params["layers"]["moe"]["router"] is router
    assert router.dtype == torch.float32 and not torch.equal(router, before)
    assert params["layers"]["moe"]["wg"].dtype == torch.bfloat16
    leaves = tree_leaves(params)
    for m_, v_, p in zip(*state.inner, leaves):
        assert m_.dtype == v_.dtype == p.dtype
    assert float(m["moe_aux"]) > 0
