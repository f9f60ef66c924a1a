"""The JAX package's side of ``tests/test_torch_roofline.py``'s wire
test: the engine's plain and crowded dist ticks lowered on a mesh of 4
CPU devices (``repro.core.engine.lower_tick_for_mesh``), each tick's
``roofline.analyze`` wire and collectives and its optimized HLO text,
written as one JSON file.

    XLA_FLAGS=--xla_force_host_platform_device_count=4 JAX_PLATFORMS=cpu \\
        PYTHONPATH=src python tests/_roofline_jax_ref.py OUT.json NAME...
"""
import dataclasses
import json
import sys

import jax
import numpy as np
from jax.sharding import Mesh

from repro.configs import get_graph_config
from repro.core import engine as E
from repro.roofline import analysis as ra

WORKERS = 4


def main() -> None:
    out, names = sys.argv[1], sys.argv[2:]
    mesh = Mesh(np.array(jax.devices()[:WORKERS]).reshape(WORKERS, 1),
                ("data", "model"))
    rec = {}
    for name in names:
        compiled, info = E.lower_tick_for_mesh(get_graph_config(name), mesh,
                                               WORKERS)
        roof = ra.analyze(compiled)
        rec[name] = {"wire": roof.collective_wire_bytes,
                     "collectives": [dataclasses.asdict(c)
                                     for c in roof.collectives],
                     "hlo": compiled.as_text(), "info": info}
    with open(out, "w") as f:
        json.dump(rec, f)


if __name__ == "__main__":
    main()
