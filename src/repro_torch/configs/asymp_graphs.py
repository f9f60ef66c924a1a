"""The paper's own workload configs: ASYMP graph-mining jobs.

The same table as ``repro.configs.asymp_graphs`` (the parity tests hold
the two equal).  The production-scale variants (512-shard RMAT) are
dry-run-only in the JAX package; the port runs none of them yet.
"""
from repro_torch.configs.base import GraphConfig

# Paper's RMAT family: (a,b,c,d) = (0.47, 0.19, 0.19, 0.05), expected degree 32.
RMAT_ABCD = (0.47, 0.19, 0.19, 0.05)


def rmat(log2_nodes: int, *, shards: int = 8, algorithm: str = "cc",
         avg_degree: int = 32, **kw) -> GraphConfig:
    return GraphConfig(
        name=f"rmat{log2_nodes}-{algorithm}",
        algorithm=algorithm,
        num_vertices=1 << log2_nodes,
        avg_degree=avg_degree,
        generator="rmat",
        rmat_abcd=RMAT_ABCD,
        num_shards=shards,
        **kw,
    )


# Executable-scale reproduction configs (container scale).
CONFIGS: dict[str, GraphConfig] = {
    # headline CC job — the paper's primary benchmark
    "asymp_cc": rmat(16, algorithm="cc"),
    # SSSP with weighted edges (paper §4.1, Fig 4)
    "asymp_sssp": rmat(16, algorithm="sssp", weighted=True),
    # input-scalability family (paper Fig 7)
    "asymp_cc_small": rmat(14, algorithm="cc"),
    "asymp_cc_large": rmat(18, algorithm="cc"),
    # compressed-wire CC: labels ride int16 (lossless below the sentinel
    # bound — see dist/exchange.effective_compression)
    "asymp_cc_wire": rmat(14, algorithm="cc", wire_compression="int16"),
    # aggregator-semiring family (core/semiring.py): or / max-min / max
    "asymp_reach": rmat(16, algorithm="reachability"),
    # reachability bits always narrow losslessly (value bound 2), so even
    # int8 wire is exact
    "asymp_reach_wire": rmat(16, algorithm="reachability",
                             wire_compression="int8"),
    "asymp_widest": rmat(14, algorithm="widest_path", weighted=True),
    # widest-path widths floor-quantize on the wire (max-monotone: decoded
    # widths never over-estimate)
    "asymp_widest_wire": rmat(14, algorithm="widest_path", weighted=True,
                              wire_compression="int16"),
    "asymp_labelprop": rmat(16, algorithm="labelprop"),
    "asymp_labelprop_wire": rmat(14, algorithm="labelprop",
                                 wire_compression="int16"),
    # non-idempotent accumulation (SUM aggregator): residual-push
    # PageRank.  Replay recovery is refused — failures take the globally
    # consistent checkpoint-restore path — and any requested
    # wire_compression is gated to "none" (quantization error compounds
    # under (+)); frequent snapshots keep the rollback window short
    "asymp_pagerank": rmat(14, algorithm="pagerank", avg_degree=16,
                           enforce_fraction=0.5, checkpoint_every=4),
    # crowded-cluster emulation (paper §5.4, dist/latency.py): half the
    # shards crowded — outgoing links gain 2 wire ticks, work budget /4;
    # the priority scheduler keeps the degradation well under 2x
    # (benchmarks/bench_crowded.py asserts the shape in CI)
    "asymp_cc_crowded": rmat(14, algorithm="cc", avg_degree=16,
                             latency_profile="stragglers",
                             slow_fraction=0.5, link_delay=2,
                             slow_intensity=4, edge_budget=1024,
                             enforce_fraction=1.0),
    "asymp_sssp_crowded": rmat(12, algorithm="sssp", weighted=True,
                               avg_degree=16,
                               latency_profile="stragglers",
                               slow_fraction=0.5, link_delay=2,
                               slow_intensity=4, edge_budget=512,
                               enforce_fraction=1.0),
    # production-mesh structural config (dry-run only: 512 shards)
    "asymp_cc_prod": rmat(26, shards=512, algorithm="cc"),
    "asymp_sssp_prod": rmat(26, shards=512, algorithm="sssp", weighted=True),
    # production SSSP with quantized float wire (lossy-but-safe ceil grid)
    "asymp_sssp_wire_prod": rmat(26, shards=512, algorithm="sssp",
                                 weighted=True, wire_compression="int16"),
    # production crowded tick (dry-run only): the deferred-delivery ring +
    # throttle pytree is a different lowering than the plain tick, so the
    # 256/512-chip meshes compile it separately — the structural twin of
    # the scenario matrix's crowded x dist cells
    "asymp_cc_crowded_prod": rmat(26, shards=512, algorithm="cc",
                                  latency_profile="stragglers",
                                  slow_fraction=0.5, link_delay=2,
                                  slow_intensity=4,
                                  enforce_fraction=1.0),
}
