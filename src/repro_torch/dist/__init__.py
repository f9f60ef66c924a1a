"""``repro_torch.dist`` — the distribution substrate below ``repro_torch.core``.

  * :mod:`repro_torch.dist.sharding` — the contiguous-range vertex
    partition used by the graph engine (``vertex_partition``);
  * :mod:`repro_torch.dist.exchange` — the wire codec gate and the local
    (single-device transpose) transport.

Nothing in this package imports from ``repro_torch.core``.
"""
