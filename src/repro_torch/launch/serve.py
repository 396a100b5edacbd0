"""Serve an LM with batched requests: prefill, then greedy decode.

The counterpart of ``examples/serve_lm.py``, on ``cuda`` unless told
otherwise.  Weights (bf16) are drawn from seed 0, prompts from numpy with
seed 0, as in the reference.  Every arch of the registry serves here; for
a frontend arch (llava-next-34b, musicgen-large) a prompt of
``prompt_len`` positions is ``n_frontend_tokens`` stub embeddings, drawn
on the host after the tokens from the same generator, then tokens.

  PYTHONPATH=src python -m repro_torch.launch.serve --size full \\
      --batch 2 --prompt-len 8192 --tokens 32
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import configs as C
from repro_torch.device import resolve_device
from repro_torch.launch import steps as ST
from repro_torch.models.config import ArchConfig


@dataclasses.dataclass
class ServeResult:
    cfg: ArchConfig
    prompts: torch.Tensor          # (B, prompt_len - F) int32 tokens
    embeds: torch.Tensor | None    # (B, F, D) stub frontend embeddings
    params: dict
    tokens: np.ndarray             # (B, n_tokens) greedy tokens
    last_logits: torch.Tensor      # (B, 1, Vp) of the last decode step
    pos: int                       # cache position after the last step
    prefill_ms: float              # the timed prefill (after the warm-up)
    decode_ms_per_token: float
    decode_tokens_per_s: float     # batch x decode steps / decode time
    peak_memory_bytes: int | None  # torch.cuda.max_memory_allocated


class _Timer:
    """Milliseconds of the work between ``start`` and ``stop``: CUDA
    events on the card, the host clock on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def start(self):
        if self.cuda:
            self.t0 = torch.cuda.Event(enable_timing=True)
            self.t0.record()
        else:
            self.t0 = time.perf_counter()

    def stop(self) -> float:
        if self.cuda:
            t1 = torch.cuda.Event(enable_timing=True)
            t1.record()
            t1.synchronize()
            return float(self.t0.elapsed_time(t1))
        return (time.perf_counter() - self.t0) * 1e3


def serve(arch: str = "h2o-danube-1.8b", *, batch: int = 4,
          prompt_len: int = 32, tokens: int = 32, size: str = "smoke",
          device: str | torch.device | None = None) -> ServeResult:
    """Prefill ``batch`` seeded prompts of ``prompt_len`` positions (a
    frontend arch's frames, then tokens), then decode ``tokens`` greedy
    tokens per request.  On the card one untimed prefill comes first, so
    the timed one pays no kernel load or allocator growth."""
    dev = resolve_device(device)
    cfg = {"smoke": C.get_smoke, "full": C.get_full}[size](arch).resolve(1)
    nf = cfg.n_frontend_tokens if cfg.frontend else 0
    if prompt_len <= nf:
        raise ValueError(f"a prompt of {prompt_len} leaves no tokens after "
                         f"{cfg.name}'s {nf} frontend embeddings")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    model = ST.build_model(cfg, device=dev)
    params = model.init_params(0)
    rng = np.random.default_rng(0)
    prompts = torch.as_tensor(
        rng.integers(0, cfg.vocab, (batch, prompt_len - nf)),
        dtype=torch.int32, device=dev)
    step_in = {"tokens": prompts}
    embeds = None
    if nf:
        embeds = torch.as_tensor(
            rng.normal(0, 0.02, (batch, nf, cfg.d_model)),
            dtype=torch.float32).to(device=dev, dtype=model.dtype)
        step_in["embeds"] = embeds
    prefill = ST.make_prefill_step(model, capacity=prompt_len + tokens)
    decode = ST.make_decode_step(model)
    timer = _Timer(dev)

    if dev.type == "cuda":
        prefill(params, step_in)
    timer.start()
    logits, cache = prefill(params, step_in)
    next_tok = logits[:, -1].argmax(dim=-1, keepdim=True).to(torch.int32)
    prefill_ms = timer.stop()

    out = [next_tok]
    timer.start()
    for _ in range(tokens - 1):
        logits, cache = decode(params, cache, {"tokens": next_tok})
        next_tok = logits[:, -1].argmax(dim=-1, keepdim=True).to(torch.int32)
        out.append(next_tok)
    decode_ms = timer.stop()
    steps = max(tokens - 1, 1)
    return ServeResult(
        cfg=cfg, prompts=prompts, embeds=embeds, params=params,
        tokens=torch.cat(out, dim=1).cpu().numpy(), last_logits=logits,
        pos=int(cache["pos"]), prefill_ms=prefill_ms,
        decode_ms_per_token=decode_ms / steps,
        decode_tokens_per_s=batch * steps / max(decode_ms / 1e3, 1e-12),
        peak_memory_bytes=(torch.cuda.max_memory_allocated(dev)
                           if dev.type == "cuda" else None))


def main(argv=None) -> ServeResult:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="h2o-danube-1.8b", choices=C.ARCH_NAMES)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--size", choices=("smoke", "full"), default="smoke")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    res = serve(args.arch, batch=args.batch, prompt_len=args.prompt_len,
                tokens=args.tokens, size=args.size, device=args.device)
    dev = res.prompts.device
    frames = 0 if res.embeds is None else res.embeds.shape[1]
    print(f"arch={res.cfg.name} batch={args.batch} prompt={args.prompt_len} "
          f"({frames} frontend embeddings) device={dev}")
    print(f"prefill: {res.prefill_ms:.1f} ms")
    print(f"decode:  {res.decode_ms_per_token:.2f} ms/token, "
          f"{res.decode_tokens_per_s:.1f} tokens/s")
    if res.peak_memory_bytes is not None:
        print(f"peak memory: {res.peak_memory_bytes / 2**30:.2f} GiB")
    for b in range(args.batch):
        print(f"  request {b}: {res.tokens[b, :16].tolist()} ...")
    if res.tokens.shape != (args.batch, args.tokens):
        raise RuntimeError(f"generated {res.tokens.shape}")
    if not ((res.tokens >= 0) & (res.tokens < res.cfg.vocab_padded)).all():
        raise RuntimeError("generated token ids out of range")
    return res


if __name__ == "__main__":
    main()
