"""Summarize dry-run JSON records into tables.

Counterpart of ``repro.launch.summarize``: the dry-run table (per-rank
memory, trace time) and the roofline table (single-pod records), with the
hint of what would move each cell's dominant term.

  PYTHONPATH=src python -m repro_torch.launch.summarize DIR [DIR ...]
"""
from __future__ import annotations

import json
import os
import sys
from typing import Dict, List


def load(dirpath: str) -> List[Dict]:
    recs = []
    for name in sorted(os.listdir(dirpath)):
        if name.endswith(".json"):
            with open(os.path.join(dirpath, name)) as f:
                recs.append(json.load(f))
    return recs


def fmt_bytes(b) -> str:
    return f"{float(b)/2**30:.2f}"


def _mesh(r: Dict) -> str:
    if r.get("mesh"):
        return "x".join(str(v) for v in r["mesh"].values())
    return "2x16x16" if r.get("multi_pod") else "16x16"


def dryrun_table(recs: List[Dict]) -> str:
    rows = ["| arch | shape | mesh | status | HBM/rank GiB (args+temp+out) "
            "| trace s |",
            "|---|---|---|---|---|---|"]
    for r in recs:
        mesh = _mesh(r)
        if r["status"] == "skipped":
            rows.append(f"| {r['arch']} | {r['shape']} | {mesh} | SKIP "
                        f"(full attention @524k) | - | - |")
            continue
        if r["status"] != "ok":
            rows.append(f"| {r['arch']} | {r['shape']} | {mesh} | "
                        f"ERROR {r.get('error', '')[:60]} | - | - |")
            continue
        m = r["memory"]
        hbm = (f"{fmt_bytes(m['argument_size_in_bytes'])}+"
               f"{fmt_bytes(m['temp_size_in_bytes'])}+"
               f"{fmt_bytes(m['output_size_in_bytes'])}")
        rows.append(f"| {r['arch']} | {r['shape']} | {mesh} | ok | {hbm} | "
                    f"{r['trace_s']} |")
    return "\n".join(rows)


def roofline_table(recs: List[Dict]) -> str:
    rows = ["| arch | shape | compute ms | memory ms | coll ms | dominant "
            "| useful/counted | roofline MFU | what would move the "
            "dominant term |",
            "|---|---|---|---|---|---|---|---|---|"]
    for r in recs:
        if r["status"] != "ok" or r.get("multi_pod"):
            continue
        rf = r["roofline"]
        rows.append(
            f"| {r['arch']} | {r['shape']} | {rf['compute_s']*1e3:.2f} | "
            f"{rf['memory_s']*1e3:.2f} | {rf['collective_s']*1e3:.2f} | "
            f"{rf['dominant']} | {rf['useful_flops_fraction']:.2f} | "
            f"{rf['mfu']:.3f} | {_hint(r)} |")
    return "\n".join(rows)


def _hint(r: Dict) -> str:
    dom = r["roofline"]["dominant"]
    if dom == "memory" and r["kind"] == "decode":
        mm = r.get("memory_model", {})
        if mm and mm.get("cache", 0) > mm.get("weights", 0):
            return "KV/SSM cache traffic: quantize cache or shard wider"
        return "weight traffic: lower-bit variants / wider TP"
    if dom == "memory":
        return "activation traffic: bigger fused blocks, less remat"
    if dom == "collective":
        return "resharding: SP/reduce-scatter, overlap, fewer TP syncs"
    return "tensor-core utilization: larger per-rank tiles / fewer small " \
           "products"


def main(argv=None) -> None:
    for d in (sys.argv[1:] if argv is None else argv):
        recs = load(d)
        print(f"\n## {d} ({len(recs)} records)\n")
        print("### Dry-run\n")
        print(dryrun_table(recs))
        if any(not r.get("multi_pod") for r in recs):
            print("\n### Roofline (single-pod)\n")
            print(roofline_table(recs))


if __name__ == "__main__":
    main()
