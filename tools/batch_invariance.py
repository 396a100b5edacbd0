#!/usr/bin/env python3
"""Is a task's greedy placement decode the same bits whatever batch it is
decoded in?  Finds the first stage whose bits differ.

    PYTHONPATH=src python tools/batch_invariance.py [--device cpu]

An untrained DreamShard agent (seed 0, 16 candidates) decodes DLRM-50
(4) test task 0 four ways: alone, and at other positions in batches of
3, 16 and 20 test tasks (one ``(M_pad, D)`` bucket), each way in two
modes:

* ``power_of_two``: one ``decode_candidates`` call a batch, padded to a
  power of two tasks (1, 4, 16, 32), as ``PlacementSession`` decoded
  before its decode batch was fixed;
* ``session``: ``PlacementSession.place_many``, whose every decode call
  holds ``DECODE_BATCH`` tasks.

Forward hooks keep every output of the networks' MLPs (the policy's and
the cost net's table MLPs; at each step the cost net's three device
heads, whose input is the cost device sums; the policy's cost-feature
MLP; the policy head, whose input holds the policy device sums and whose
output is the step's logits) and the inputs of the device heads and the
policy head (the device reductions).  Task 0's rows of each batched call
are compared bit for bit with the alone run's.  Prints one JSON line a
mode and batch: the first stage that differs (module, call, shape of the
call's whole tensor), how many stages differ, and whether the chosen
assignment is equal; then the card's ``nvidia-smi`` name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

BATCHES = {1: 0, 3: 2, 16: 7, 20: 17}     # batch size -> task 0's position
MODULES = ("policy.table_mlp", "cost.table_mlp", "cost.head_fwd",
           "cost.head_bwd", "cost.head_comm", "policy.cost_mlp",
           "policy.head")
INPUTS = ("cost.head_fwd", "policy.head")  # inputs: the device sums


class Recorder:
    """Keeps every output (and the device sums) of the agent's MLPs while
    ``decode_candidates`` runs (not the tables' sort before it)."""

    def __init__(self, agent):
        from repro_torch.core import rollout as R
        self.calls, self.handles, self.active = [], [], False
        self.R, self.decode = R, R.decode_candidates

        def decode(*args, **kw):
            self.active = True
            try:
                return self.decode(*args, **kw)
            finally:
                self.active = False
        R.decode_candidates = decode
        nets = {"policy": agent.policy_net, "cost": agent.cost_net}
        for name in MODULES:
            net, child = name.split(".")
            module = getattr(nets[net], child)
            self.handles.append(module.register_forward_hook(
                self._hook(name)))

    def _hook(self, name):
        def keep(_module, args, out):
            if not self.active:
                return
            if name in INPUTS:
                self.calls.append((f"{name} input", args[0].detach().clone()))
            self.calls.append((name, out.detach().clone()))
        return keep

    def close(self):
        self.R.decode_candidates = self.decode
        for h in self.handles:
            h.remove()


def record(agent, fn):
    """(stages, result): every call's tensors, labelled by module and its
    call count, while ``fn()`` runs."""
    rec = Recorder(agent)
    try:
        result = fn()
    finally:
        rec.close()
    counts, stages = {}, []
    for name, t in rec.calls:
        counts[name] = counts.get(name, -1) + 1
        stages.append((f"{name}#{counts[name]}", t))
    return stages, result


def compare(alone, batched, row: int, chunk_rows: list) -> dict:
    """Bitwise comparison of task 0's rows: ``alone``'s row 0 of each
    stage against ``batched``'s row ``row`` of the call that held the
    task (``chunk_rows[k]`` is the row in call k, or None)."""
    import torch
    first, n_diff = None, 0
    batched = [s for s, r in zip(batched, chunk_rows) if r is not None]
    if len(batched) != len(alone):
        return {"stages": [len(alone), len(batched)], "first_diff": "count"}
    for (label, a), (label_b, b) in zip(alone, batched):
        if label.split("#")[0] != label_b.split("#")[0]:
            return {"first_diff": f"order {label} / {label_b}"}
        x, y = a[0], b[row]
        if x.shape != y.shape or not torch.equal(x.view(torch.int32),
                                                 y.view(torch.int32)):
            n_diff += 1
            if first is None:
                first = {"stage": label, "alone_shape": list(a.shape),
                         "batched_shape": list(b.shape)}
    return {"stages": len(alone), "first_diff": first,
            "stages_differing": n_diff}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device of the agent (default: cuda)")
    args = ap.parse_args()
    import numpy as np
    import torch
    from repro_torch.api import SimOracle
    from repro_torch.api.session import (DECODE_BATCH, PlacementSession,
                                         pad_feature_batch)
    from repro_torch.core import rollout as R
    from repro_torch.core.trainer import DreamShard, DreamShardConfig
    from repro_torch.data.synthetic import make_dlrm_pool
    from repro_torch.data.tasks import make_benchmark_suite

    pool = make_dlrm_pool(seed=0)
    train, test = make_benchmark_suite(pool, n_tables=50, n_devices=4,
                                       n_tasks=20)
    agent = DreamShard(train, SimOracle(seed=0), DreamShardConfig(seed=0),
                       device=args.device)
    session = PlacementSession(agent, n_candidates=16)
    m_pad, n_dev = session.bucket_key(test[0])
    others = [t for t in test[1:] if session.bucket_key(t) == (m_pad, n_dev)]

    def batch_of(n, pos):
        tasks = others[:n - 1]
        return tasks[:pos] + [test[0]] + tasks[pos:]

    def power_of_two(tasks):
        """One ``decode_candidates`` call, padded to a power of two."""
        entries, orders = [], []
        for t in tasks:
            f, s, order = agent._inference_inputs(t.raw_features)
            entries.append((f[order], s[order]))
            orders.append(order)
        b_pad = 1 << max(0, len(tasks) - 1).bit_length()
        feats, sizes, tmask = pad_feature_batch(entries, m_pad, b_pad)
        dev = agent.device
        with torch.no_grad():
            actions, est = R.decode_candidates(
                agent.policy_net, agent.cost_net,
                torch.as_tensor(feats, device=dev),
                torch.as_tensor(sizes, device=dev), agent.oracle.
                mem_capacity_gb, n_devices=n_dev, n_candidates=16,
                tmask=torch.as_tensor(tmask, device=dev),
                use_cost=agent.cfg.use_cost_features,
                reward_mode=agent.cfg.reward_mode,
                log_targets=agent._log_targets)
        actions, est = actions.cpu().numpy(), est.cpu().numpy()
        out = []
        for j, (t, order) in enumerate(zip(tasks, orders)):
            a = np.empty(t.n_tables, dtype=np.int64)
            a[order] = actions[j, int(np.argmin(est[j])), :t.n_tables]
            out.append(a)
        return out

    def session_decode(tasks):
        return [p.assignment for p in session.place_many(tasks)]

    lines = []
    for mode, fn, per_call in (("power_of_two", power_of_two, None),
                               ("session", session_decode,
                                DECODE_BATCH)):
        alone, alone_out = record(agent, lambda: fn([test[0]]))
        for n, pos in BATCHES.items():
            tasks = batch_of(n, pos)
            stages, result = record(agent, lambda: fn(tasks))
            if per_call is None:        # one call: every stage holds task 0
                rows, row = [pos] * len(stages), pos
            else:                        # the call of task 0's chunk only
                chunk, row = pos // per_call, pos % per_call
                per = len(stages) // -(-n // per_call)
                rows = [row if k // per == chunk else None
                        for k in range(len(stages))]
            line = {"mode": mode, "batch": n, "position": pos,
                    **compare(alone, stages, row, rows),
                    "assignment_equal": bool(np.array_equal(
                        result[pos], alone_out[0]))}
            lines.append(line)
            print(json.dumps(line), flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip() if agent.device.type == "cuda" else "cpu"
    print(json.dumps({"device": str(agent.device), "card": card,
                      "bucket": [m_pad, n_dev],
                      "session_invariant": all(
                          ln["first_diff"] is None and ln["assignment_equal"]
                          for ln in lines if ln["mode"] == "session")}))


if __name__ == "__main__":
    main()
