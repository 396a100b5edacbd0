"""Measured-cost profiling: the counterpart of ``repro.profiling``.

Measures the real kernels ONCE offline and lets oracles *interpolate*
those measurements at search/training speed:

* ``microbench``   -- times K1 (the fused embedding bag) and its backward
  at one shape, one fused shape, a whole placement, or a grid of them
  (``sweep``, ``sweep_fused``, ``sweep_sharded``);
* ``collectives``  -- the alpha-beta all-to-all model, fitted to
  ``all_to_all_single`` timed over a process group of >= 2 ranks, or to a
  seeded synthetic trace at one rank;
* ``calibration``  -- the persisted, versioned ``CalibrationTable``
  artifact (the reference's npz format, with a torch/CUDA fingerprint)
  with log2-multilinear interpolation;
* ``calibrate``    -- the ``python -m repro_torch.profiling.calibrate``
  CLI.

``repro_torch.api.MeasuredOracle`` consumes the artifact; the workflow is
calibrate (once) -> train (``DreamShard(tasks, MeasuredOracle())`` or
``KernelOracle()``, which calibrates itself) -> place.
"""

from repro_torch.profiling.calibration import (CALIBRATION_VERSION,
                                               CalibrationTable, FusionModel,
                                               ShardModel,
                                               default_artifact_path,
                                               hardware_fingerprint,
                                               load_or_none)
from repro_torch.profiling.collectives import (CommModel, calibrate_comm,
                                               fit_alpha_beta,
                                               measure_all_to_all,
                                               synthetic_trace)
from repro_torch.profiling.microbench import (BenchPoint, FusedBenchPoint,
                                              ShardBenchPoint,
                                              bench_fused_shape, bench_shape,
                                              measure_placement,
                                              median_time_ms, sweep,
                                              sweep_fused, sweep_sharded)

__all__ = [
    "BenchPoint", "CALIBRATION_VERSION", "CalibrationTable", "CommModel",
    "FusedBenchPoint", "FusionModel", "ShardBenchPoint", "ShardModel",
    "bench_fused_shape", "bench_shape", "calibrate_comm",
    "default_artifact_path", "fit_alpha_beta", "hardware_fingerprint",
    "load_or_none", "measure_all_to_all", "measure_placement",
    "median_time_ms", "sweep", "sweep_fused", "sweep_sharded",
    "synthetic_trace",
]
