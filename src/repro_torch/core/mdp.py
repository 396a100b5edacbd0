"""The *real* placement MDP (paper §3.1): states/rewards measured on hardware.

The counterpart of ``repro/core/mdp.py``, host numpy over the port's
``CostSimulator``.  Every ``step`` costs D fused-op measurements;
DreamShard's estimated MDP exists precisely to avoid paying this.  Its
table-by-table ordering is the one ``search.strategies.refine_beam``
follows.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core import features as F
from repro_torch.sim.costsim import CostSimulator


class RealPlacementMDP:
    """One-table-per-step placement environment measured on the simulator."""

    def __init__(self, raw_features: np.ndarray, n_devices: int,
                 sim: CostSimulator, order: np.ndarray | None = None):
        self.raw = np.asarray(raw_features)
        self.n_devices = n_devices
        self.sim = sim
        self.order = (np.asarray(order) if order is not None
                      else np.arange(self.raw.shape[0]))
        self.reset()

    def reset(self):
        self.t = 0
        self.assignment = np.full(self.raw.shape[0], -1, dtype=np.int64)
        self.mem = np.zeros(self.n_devices)
        return self._augmented_state()

    @property
    def done(self) -> bool:
        return self.t >= self.raw.shape[0]

    def legal_actions(self) -> np.ndarray:
        table = self.order[self.t]
        size = self.raw[table, F.TABLE_SIZE_GB]
        legal = (self.mem + size) <= self.sim.spec.mem_capacity_gb
        if not legal.any():
            legal[:] = True
        return np.flatnonzero(legal)

    def _augmented_state(self):
        """(per-device table features, measured q_{t,d}) -- needs hardware."""
        placed = self.assignment >= 0
        if placed.any():
            res = self.sim.evaluate(self.raw[placed], self.assignment[placed],
                                    self.n_devices)
            q = res.cost_features
        else:
            q = np.zeros((self.n_devices, 3))
        per_device = [self.raw[(self.assignment == d)]
                      for d in range(self.n_devices)]
        return per_device, q

    def step(self, action: int):
        assert not self.done
        table = self.order[self.t]
        self.assignment[table] = int(action)
        self.mem[action] += self.raw[table, F.TABLE_SIZE_GB]
        self.t += 1
        if self.done:
            res = self.sim.evaluate(self.raw, self.assignment, self.n_devices)
            return self._augmented_state(), -res.overall, True
        return self._augmented_state(), 0.0, False
