"""The gate of every cell: ``repro_torch.launch.dryrun.lower_cell`` runs
the port's train, prefill or decode step once on meta tensors at the
cell's global shapes, for every arch x shape on the one-pod mesh, and
ends ``ok`` (or ``skip(full-attn)`` for ``long_500k`` on an arch without
long context, as the reference does); its record carries the reference's
keys, the H100's peaks, and a probe-composed roofline whose collective
term is ``None``.  No JAX here: the per-rank blocks the record adds up
are held to the reference's in ``tests/test_torch_dryrun.py``."""
import math

import pytest

pytest.importorskip("torch")

from repro_torch.configs import SHAPES, get_config, list_archs  # noqa: E402
from repro_torch.launch import dryrun as TD  # noqa: E402
from repro_torch.roofline import analysis as TA  # noqa: E402

CELLS = [(a, s) for a in list_archs() for s in SHAPES]
KEYS = {"arch", "shape", "multi_pod", "status", "chips", "lower_s",
        "memory", "model_flops_global", "model_flops_per_chip",
        "sharding_fallbacks", "roofline", "useful_flops_ratio", "peaks",
        "probe_s"}


@pytest.mark.parametrize("arch,shape", CELLS,
                         ids=[f"{a}-{s}" for a, s in CELLS])
def test_lower_cell(arch, shape):
    rec = TD.lower_cell(arch, shape, False)
    if shape == "long_500k" and not get_config(arch).supports_long_context:
        assert rec["status"] == "skip(full-attn)"
        return
    assert rec["status"] == "ok"
    assert set(rec) == KEYS
    mem = rec["memory"]
    assert mem["temp_bytes"] is None
    assert 0 < mem["alias_bytes"] <= mem["output_bytes"] \
        <= mem["argument_bytes"] + mem["output_bytes"]
    assert rec["model_flops_per_chip"] == rec["model_flops_global"] / 256
    rf = rec["roofline"]
    assert rf["collective_wire_bytes"] is None and rf["collective_s"] is None
    assert rf["compute_s"] == rf["flops"] / TA.PEAK_FLOPS
    assert rf["memory_s"] == rf["bytes_accessed"] / TA.HBM_BW
    assert 0 < rf["product_flops"] <= rf["flops"]
    assert math.isclose(sum(p["count"] * p["flops"] / p["share"]
                            for p in rf["pieces"]), rf["flops"])
    assert all(p["share"] >= 1 for p in rf["pieces"])
    assert 0 < rec["useful_flops_ratio"]


def test_two_pod_gate():
    rec = TD.lower_cell("qwen3-4b", "decode_32k", True)
    assert rec["status"] == "ok" and rec["chips"] == 512
    assert "compute_s" not in rec["roofline"]
    one = TD.lower_cell("qwen3-4b", "decode_32k", False)
    assert rec["memory"]["argument_bytes"] < one["memory"]["argument_bytes"]
