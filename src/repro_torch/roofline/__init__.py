"""Roofline accounting (the counterpart of ``repro.roofline``): the cost
terms of a step on the H100's peaks, per-layer probes counted by a
dispatch mode, and the report over the dry run's records."""
