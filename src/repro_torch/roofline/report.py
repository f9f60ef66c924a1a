"""Render the roofline table from the port's dry-run records (the
counterpart of ``repro.roofline.report``): the reference's columns, plus
``product share`` (product FLOPs over all FLOPs); a ``null`` term
(the LM cells' collectives, which the port does not model) prints ``-``.

  python -m repro_torch.roofline.report [--dir experiments/dryrun_torch] [--pod2]
"""
from __future__ import annotations

import argparse
import glob
import json
import os

from repro_torch.launch.dryrun import OUT_DIR


def fmt_s(x):
    if x is None:
        return "-"
    if x >= 1:
        return f"{x:.2f}s"
    return f"{x * 1e3:.1f}ms"


def load(dir_: str, multi_pod: bool):
    rows = []
    suffix = "pod2" if multi_pod else "pod1"
    for path in sorted(glob.glob(os.path.join(dir_, f"*__{suffix}.json"))):
        with open(path) as f:
            rows.append(json.load(f))
    return rows


def render(rows) -> list[str]:
    """The table's lines, one row a record."""
    out = ["| arch | shape | status | mem/chip | compute | memory | coll | "
           "dominant | useful | bound-frac | product share |",
           "|---|---|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        if r["status"] != "ok":
            out.append(f"| {r['arch']} | {r['shape']} | {r['status']} | - | "
                       f"- | - | - | - | - | - | - |")
            continue
        rf = r.get("roofline", {})
        mem = r.get("memory", {}).get("peak_per_device_gb", "-")
        if "compute_s" not in rf:
            out.append(f"| {r['arch']} | {r['shape']} | ok(gate) | {mem} | "
                       f"- | - | - | - | - | - | - |")
            continue
        c, m, x = rf["compute_s"], rf["memory_s"], rf["collective_s"]
        tot = max(t for t in (c, m, x) if t is not None)
        frac = c / tot if tot else 0.0  # fraction of bound time doing math
        prod = rf.get("product_flops")
        share = (f"{prod / rf['flops']:.3f}" if prod is not None
                 and rf["flops"] else "-")
        useful = r.get("useful_flops_ratio")
        out.append(f"| {r['arch']} | {r['shape']} | ok | {mem}GB | "
                   f"{fmt_s(c)} | {fmt_s(m)} | {fmt_s(x)} | "
                   f"**{rf['dominant']}** | "
                   f"{'-' if useful is None else f'{useful:.2f}'} | "
                   f"{frac:.2f} | {share} |")
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=OUT_DIR)
    ap.add_argument("--pod2", action="store_true")
    args = ap.parse_args(argv)
    print("\n".join(render(load(args.dir, args.pod2))))


if __name__ == "__main__":
    main()
