"""``tests/test_torch_lm_padded.py``'s checks at ``resolve(8)``: every
arch's SMOKE config (8-head archs unpadded, 4-head ones padded to 8)
against the JAX LM at the same ``resolve``: forward, the train step's
loss, gradients, prefill and its cache, decode against the JAX decode
where no head is padded and against the port's own forward everywhere."""

import pytest
import torch

from test_torch_lm_padded import (_run, cases,
                                  check_decode_against_the_forward,
                                  check_decode_against_the_reference,
                                  test_forward_logits, test_forward_loss,
                                  test_gradients,
                                  test_prefill_logits_and_cache)

# one intra-op thread: the suite runs in parallel workers, and
# torch's default of a thread a core in each oversubscribes the CPU
torch.set_num_threads(1)

CASES, IDS, UNPADDED = cases(8)

__all__ = ["test_forward_logits", "test_forward_loss", "test_gradients",
           "test_prefill_logits_and_cache"]


@pytest.fixture(scope="module", params=CASES, ids=IDS)
def run_both(request):
    return _run(*request.param)


@pytest.mark.parametrize("arch,tp", UNPADDED,
                         ids=[f"{a}-tp{tp}" for a, tp in UNPADDED])
def test_decode_is_the_reference_where_no_head_is_padded(arch, tp):
    check_decode_against_the_reference(arch, tp)


@pytest.mark.parametrize("arch,tp", CASES, ids=IDS)
def test_decode_is_the_forward_at_its_last_position(arch, tp):
    check_decode_against_the_forward(arch, tp)
