"""``repro_torch.dist`` — the distribution substrate below ``repro_torch.core``.

  * :mod:`repro_torch.dist.sharding` — the contiguous-range vertex
    partition used by the graph engine (``vertex_partition``);
  * :mod:`repro_torch.dist.compression` — the int16/int8 wire formats
    (row-quantized floats, narrowed ints);
  * :mod:`repro_torch.dist.exchange` — the wire codec gate and the local
    transports, immediate and deferred (the delay ring);
  * :mod:`repro_torch.dist.latency` — seeded latency models and the async
    schedule's firing pattern.

Nothing in this package imports from ``repro_torch.core``.
"""
