"""``tests/test_torch_lm_padded.py``'s checks at ``resolve(2)`` for the
MoE archs (olmoe-1b-7b, dbrx-132b SMOKE: 4 experts, top-2): the port's LM
on one device with ``NO_SHARDING`` against the JAX LM at the same
``resolve``, whose ``moe_apply`` routes each 24-token prompt as two
blocks (``seq_chunks = tp``) and a decode token as one: forward, the
train step's loss (with the load-balance loss), gradients, prefill and
its cache, decode against the JAX decode and against the port's own
forward.  This is the link between ``tests/test_torch_lm_tp.py``'s
expert-parallel runs over gloo, held to the port's one-device run at
``resolve(2)``, and the JAX package."""

import pytest
import torch

from test_torch_lm_padded import (_run, check_decode_against_the_forward,
                                  check_decode_against_the_reference,
                                  test_forward_logits, test_forward_loss,
                                  test_gradients,
                                  test_prefill_logits_and_cache)

# one intra-op thread: the suite runs in parallel workers, and
# torch's default of a thread a core in each oversubscribes the CPU
torch.set_num_threads(1)

CASES = [("olmoe-1b-7b", 2), ("dbrx-132b", 2)]
IDS = [f"{a}-tp{tp}" for a, tp in CASES]

__all__ = ["test_forward_logits", "test_forward_loss", "test_gradients",
           "test_prefill_logits_and_cache"]


@pytest.fixture(scope="module", params=CASES, ids=IDS)
def run_both(request):
    return _run(*request.param)


@pytest.mark.parametrize("arch,tp", CASES, ids=IDS)
def test_decode_is_the_reference_where_no_head_is_padded(arch, tp):
    check_decode_against_the_reference(arch, tp)


@pytest.mark.parametrize("arch,tp", CASES, ids=IDS)
def test_decode_is_the_forward_at_its_last_position(arch, tp):
    check_decode_against_the_forward(arch, tp)

