"""Measured-cost profiling: the kernel micro-benchmark harness.

``microbench`` times K1 (the fused embedding bag) and its backward at one
shape, one fused shape, or a whole placement.  The calibration artifact,
the collective fits and the measured oracles wait for later slices.
"""
