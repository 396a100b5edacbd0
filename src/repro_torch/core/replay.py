"""Device-resident replay buffer and the fused cost-network trainer: the
counterpart of ``repro/core/replay.py``.

The padded cost samples live on the device in a fixed-capacity ring
(``ReplayBuffer``); ``collect`` appends whole batches with one indexed
write, and the ``n_cost``-step update (``make_fused_cost_update``) runs
every step on the device over minibatches gathered there, keeping the
losses on the device until the end: no host round trip inside the stage.

Minibatch indices are drawn on the host (the reference's RNG stream), and
a per-sample weight column masks the tail of partially-filled minibatches,
so one call covers every buffer fill level and reproduces the per-step
loop's ``min(n_batch, len(buffer))`` batches exactly.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import features as F
from repro_torch.core import networks as N
from repro_torch.device import resolve_device
from repro_torch.optim import apply_updates

FIELDS = ("feats", "onehot", "tmask", "dmask", "q", "overall")


class ReplayBuffer:
    """Fixed-capacity ring of padded cost samples, on one device
    (``cuda`` unless ``device`` names another).

    Tensors (all padded to one ``(m_pad, d_pad)`` shape): ``feats (C, M,
    F)``, ``onehot (C, D, M)``, ``tmask (C, M)``, ``dmask (C, D)``, ``q
    (C, D, 3)``, ``overall (C,)``, float32.  The write cursor advances
    modulo capacity; ``count`` is the number of samples ever appended (a
    host int: global sample ``i`` lives in slot ``i % capacity``).
    """

    def __init__(self, capacity: int, m_pad: int, d_pad: int,
                 num_features: int = F.NUM_FEATURES, *, device=None):
        self.capacity = int(capacity)
        self.m_pad, self.d_pad = int(m_pad), int(d_pad)
        self.count = 0
        C, M, D = self.capacity, self.m_pad, self.d_pad
        shapes = {"feats": (C, M, num_features), "onehot": (C, D, M),
                  "tmask": (C, M), "dmask": (C, D), "q": (C, D, 3),
                  "overall": (C,)}
        dev = resolve_device(device)
        self.data = {k: torch.zeros(v, dtype=torch.float32, device=dev)
                     for k, v in shapes.items()}

    @property
    def size(self) -> int:
        """Number of live samples (<= capacity)."""
        return min(self.count, self.capacity)

    def append_batch(self, feats, onehot, tmask, dmask, q, overall):
        """Append B padded samples (numpy arrays or tensors) in one
        indexed write per field."""
        B = feats.shape[0]
        if B == 0:
            return
        # a batch larger than the ring would write duplicate positions:
        # only the newest `capacity` samples can survive, so drop the
        # overwritten head up front
        keep = slice(max(0, B - self.capacity), B)
        pos = (self.count + np.arange(B)[keep]) % self.capacity
        dev = self.data["feats"].device
        pos = torch.as_tensor(pos, device=dev)
        for name, value in zip(FIELDS, (feats, onehot, tmask, dmask, q,
                                        overall)):
            self.data[name][pos] = torch.as_tensor(
                value[keep], dtype=torch.float32, device=dev)
        self.count += B

    def slots(self, sample_idx: np.ndarray) -> np.ndarray:
        """Ring slots for indices into the LIVE window (0 = oldest kept)."""
        return (self.count - self.size + sample_idx) % self.capacity


def cost_loss(cost_net, feats, onehot, tmask, dmask, q_t, c_t, w=None):
    """Eq. 1 on a padded minibatch: the per-device heads' MSE over real
    devices plus the overall head's MSE, each sample weighted by ``w``
    (B,) (all ones when ``None``, the per-step loop's loss)."""
    q, overall = N.cost_net_apply(cost_net, feats, onehot, tmask, dmask)
    if w is None:
        lq = ((q - q_t) ** 2 * dmask[..., None]).sum() / (
            3.0 * torch.clamp(dmask.sum(), min=1.0))
        return lq + ((overall - c_t) ** 2).mean()
    wd = dmask * w[:, None]
    lq = ((q - q_t) ** 2 * wd[..., None]).sum() / (
        3.0 * torch.clamp(wd.sum(), min=1.0))
    lc = ((overall - c_t) ** 2 * w).sum() / torch.clamp(w.sum(), min=1.0)
    return lq + lc


def cost_step(optimizer, cost_net, opt_state, batch, w=None):
    """One optimizer step of the cost network on a padded minibatch;
    returns (opt_state, detached loss)."""
    params = list(cost_net.parameters())
    loss = cost_loss(cost_net, *batch, w)
    grads = torch.autograd.grad(loss, params)
    upd, opt_state = optimizer.update(grads, opt_state, params)
    apply_updates(params, upd)
    return opt_state, loss.detach()


def make_fused_cost_update(optimizer):
    """The ``n_cost``-step cost-network trainer.

    ``update(cost_net, opt_state, buf, idx, w)`` runs Eq.-1 minibatch
    steps over pre-drawn ring slots ``idx (n_steps, n_batch)`` with
    per-sample weights ``w (n_steps, n_batch)`` (0 marks the padded tail
    of a partially-filled minibatch), gathering each minibatch from the
    ring's tensors on the device.  The network is updated in place; the
    losses come back as one (n_steps,) tensor on the device.  Weighted
    losses reduce exactly to the per-step loop's ``lq + lc`` when every
    weight is 1.
    """

    def update(cost_net, opt_state, buf, idx, w):
        dev = buf["feats"].device
        idx = torch.as_tensor(idx, device=dev).long()
        w = torch.as_tensor(w, dtype=torch.float32, device=dev)
        losses = []
        for t in range(idx.shape[0]):
            ib = idx[t]
            batch = tuple(buf[name][ib] for name in FIELDS)
            opt_state, loss = cost_step(optimizer, cost_net, opt_state,
                                        batch, w[t])
            losses.append(loss)
        return cost_net, opt_state, torch.stack(losses)

    return update
