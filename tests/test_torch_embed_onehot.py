"""The LM's training embedding under sharding rules: its one-hot is built
in the model's dtype (the reference's ``jax.nn.one_hot(...,
dtype=self.dtype)``), never as int64.

- ``LM._one_hot`` is bit-equal to ``F.one_hot(...).to(dtype)`` (a one-hot
  is exact in bf16), and so are ``one_hot @ table`` and the table's
  gradient through it (rules disabled, where ``local_apply`` calls the
  function as it is).
- The embedding alone traced as rank 0 of the production (16, 16) mesh
  under ``TraceMode`` (fake tensors: nothing is allocated), at
  phi4-mini-3.8b's vocab (200064) and train_4k's local batch (16 x
  4096): its peak stays under the bf16 one-hot's bytes, plus the copy of
  this rank's vocab slice of it that DTensor's matmul makes (1/16 of it),
  plus the whole table's and the output's bytes.  The int64 one-hot held
  8 bytes an element and its bf16 copy 2 more (131 GB here).
"""

import torch
import torch.nn.functional as F

from repro_torch import configs as C
from repro_torch.configs.shapes import INPUT_SHAPES
from repro_torch.launch import dryrun as D
from repro_torch.models.sharding import NO_SHARDING
from repro_torch.models.transformer import LM

# one intra-op thread: the suite runs in parallel workers, and
# torch's default of a thread a core in each oversubscribes the CPU
torch.set_num_threads(1)


def test_one_hot_is_bit_equal_to_the_int64_one_hot():
    cfg = C.get_smoke("h2o-danube-1.8b").resolve(1)
    model = LM(cfg, NO_SHARDING, dtype=torch.bfloat16, device="cpu")
    g = torch.Generator().manual_seed(0)
    tokens = torch.randint(0, cfg.vocab, (3, 17), generator=g)
    table = torch.randn(cfg.vocab, 24, generator=g).bfloat16()
    dx = torch.randn(3, 17, 24, generator=g).bfloat16()
    oh = model._one_hot(tokens, cfg.vocab)
    ref = F.one_hot(tokens, cfg.vocab).to(torch.bfloat16)
    assert oh.dtype == torch.bfloat16
    assert torch.equal(oh.view(torch.int16), ref.view(torch.int16))
    outs = []
    for hot in (oh, ref):
        t = table.clone().requires_grad_(True)
        x = hot @ t
        (grad,) = torch.autograd.grad(x, t, dx)
        outs.append((x, grad))
    for a, b in zip(*outs):
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))


def test_train_embedding_peak_at_phi4_train_4k():
    cfg = C.get_full("phi4-mini-3.8b").resolve(16)
    shape = INPUT_SHAPES["train_4k"]
    with D.fake_world(256):
        mesh, rules = D._mesh_and_rules("single")
        rules = rules.for_batch(shape.global_batch, mesh)
        dev = D.trace_device()
        mode = D.TraceMode()
        with mode, mode.local_only(), D._card_collectives(mesh):
            model = LM(cfg, rules, dtype=torch.bfloat16, device=dev)
            specs, layout = model.param_specs(), model.param_layout()
            params = {k: D.fake_dtensor(layout[k].shape, layout[k].dtype,
                                        mesh, specs[k], dev)
                      for k in ("embed", "final_norm")}
            tokens = D.fake_dtensor((shape.global_batch, shape.seq_len),
                                    torch.int32, mesh,
                                    rules.spec("batch", None), dev)
            mode.reset_peak()
            with torch.enable_grad():
                x = model._embed(params, tokens, None)
            peak = mode.peak
    B = shape.global_batch // 16
    one_hot = B * shape.seq_len * cfg.vocab * 2
    table = cfg.vocab * cfg.d_model * 2
    out = B * shape.seq_len * cfg.d_model * 2
    assert tuple(x.shape) == (shape.global_batch, shape.seq_len, cfg.d_model)
    assert peak <= one_hot + one_hot // 16 + table + out, peak / 1e9
