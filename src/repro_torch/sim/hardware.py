"""Hardware specifications for the embedding-cost execution simulator.

The paper measures embedding op costs on real GPUs (2080Ti / V100).  This
container has no accelerator, so the RL loop's measurement oracle is a
calibrated analytical simulator (``repro_torch.sim.costsim``).  Constants for
the default spec are calibrated so that random placement on DLRM-50 (4
devices, batch 65536, dim 16, mean pooling 15) lands at the paper's ~50 ms
scale (Table 6), with fused-op speedups in the paper's observed 1-3x band
(Fig. 12) and all-to-all congestion matching Table 4's imbalance behaviour.

A TPU-v5e spec is provided for the TPU-target experiments: 819 GB/s HBM,
~50 GB/s/link ICI, 197 TFLOP/s bf16 (the roofline constants used by
``launch/dryrun.py`` as well).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    """Parameters of one accelerator + interconnect for the cost simulator."""

    name: str
    # Effective bandwidth (GB/s) of random row gather from device memory when
    # the access misses the cache hierarchy.  Far below peak HBM bandwidth
    # because embedding gathers are scattered, short rows.
    gather_bw_gbs: float
    # Multiplier on gather bandwidth for cache-resident rows.
    cache_speedup: float
    # Capacity (bytes) of the fast level that caches hot embedding rows.
    cache_bytes: float
    # Effective per-device all-to-all bandwidth (GB/s), including protocol
    # overheads; calibrated to the paper's Table 4, not to link peak.
    a2a_bw_gbs: float
    # Fixed per-fused-op launch/setup overhead (ms).  Amortized by fusion;
    # this term is what makes fused cost != sum of single-table costs.
    comp_overhead_ms: float
    # Fixed all-to-all launch overhead (ms).
    comm_overhead_ms: float
    # Backward computation multiplier over forward (gradient read+apply).
    bwd_comp_scale: float
    # Congestion coefficient: extra per-device all-to-all time proportional
    # to (max - mean) payload imbalance (Table 4 shows even non-bottleneck
    # devices slow down under imbalance).
    congestion: float
    # Device memory capacity (GB) for placement legality.
    mem_capacity_gb: float
    # Bytes per embedding element (fp16/bf16).
    bytes_per_elem: int = 2
    # Pipelining efficiency gain from fusing k tables into one op: the
    # marginal gather streams overlap; eff(k) = min(cap, 1 + coef*log2(k)).
    pipeline_coef: float = 0.15
    pipeline_cap: float = 1.7

    # Roofline constants (used by the dry-run analysis, not the simulator).
    peak_flops: float = 0.0          # FLOP/s
    hbm_bw_gbs: float = 0.0          # GB/s
    ici_bw_gbs: float = 0.0          # GB/s per link


# Calibrated to the paper's 2080Ti numbers (Tables 1/6, Fig 12, Table 4).
PAPER_GPU = HardwareSpec(
    name="2080ti-calibrated",
    gather_bw_gbs=22.0,
    cache_speedup=4.0,          # Fig 11: sparse access speedup band
    cache_bytes=12e6,           # effective cache hierarchy (L2+TLB+row buf)
    a2a_bw_gbs=4.0,
    comp_overhead_ms=0.25,
    comm_overhead_ms=0.5,
    bwd_comp_scale=1.5,
    congestion=0.1,
    mem_capacity_gb=11.0,
)

# Larger-memory spec standing in for V100 (Prod-style diverse-dim tables).
PAPER_GPU_LARGE = dataclasses.replace(
    PAPER_GPU, name="v100-calibrated", mem_capacity_gb=32.0,
    gather_bw_gbs=55.0, a2a_bw_gbs=4.0, cache_bytes=6e6,
)

# TPU v5e target (the deployment hardware of the JAX reference package).
TPU_V5E = HardwareSpec(
    name="tpu-v5e",
    gather_bw_gbs=200.0,        # random-gather effective, ~25% of HBM peak
    cache_speedup=4.0,
    cache_bytes=64e6,           # usable VMEM budget for hot rows
    a2a_bw_gbs=45.0,
    comp_overhead_ms=0.02,
    comm_overhead_ms=0.05,
    bwd_comp_scale=1.3,
    congestion=0.2,
    mem_capacity_gb=16.0,
    peak_flops=197e12,
    hbm_bw_gbs=819.0,
    ici_bw_gbs=50.0,
)

SPECS = {s.name: s for s in (PAPER_GPU, PAPER_GPU_LARGE, TPU_V5E)}
