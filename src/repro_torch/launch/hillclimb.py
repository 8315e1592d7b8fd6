"""Hill climb: named variants of the chosen dry-run cells, each
recorded with its roofline terms.

Counterpart of ``repro.launch.hillclimb``, with the same cells and
variants. The quantization-policy search lives in
``launch/policy_search.py``.

  PYTHONPATH=src python -m repro_torch.launch.hillclimb --cell h1 \\
      --out DIR [--mesh 4x4]
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

from repro_torch.launch.dryrun import dryrun_cell, print_record
from repro_torch.launch.mesh import parse_mesh

# hypothesis -> variants; each entry: (variant_name, kwargs)
CELLS = {
    # H1: qwen2-vl-72b x decode_32k: the paper-representative cell
    # (quantized decode), the most collective-bound overall
    "h1": ("qwen2-vl-72b", "decode_32k", [
        ("base_auto", dict()),                     # auto kv: heads or seq
        ("kv_seq", dict(kv_shard="seq")),          # flash-decoding layout
        ("kv_seq_int8kv", dict(kv_shard="seq",
                               config_override=dict(kv_cache_quant=True))),
    ]),
    # H2: granite-moe-3b-a800m x train_4k: the worst useful-flops ratio
    # and the most collective-bound train cell
    "h2": ("granite-moe-3b-a800m", "train_4k", [
        ("base_tp16", dict()),
        ("pure_fsdp", dict(tp=False)),
        ("pure_fsdp_cf1", dict(tp=False,
                               config_override=dict(capacity_factor=1.0))),
    ]),
    # H3: llama3.2-1b x train_4k: a small dense train cell, collective-
    # bound at TP=16
    "h3": ("llama3.2-1b", "train_4k", [
        ("base_tp16", dict()),
        ("pure_fsdp", dict(tp=False)),
    ]),
    # the decode recipe on a second arch (the same hypothesis as h1)
    "h1b": ("qwen3-1.7b", "decode_32k", [
        ("base_auto", dict()),
        ("kv_seq", dict(kv_shard="seq")),
        ("kv_seq_int8kv", dict(kv_shard="seq",
                               config_override=dict(kv_cache_quant=True))),
    ]),
}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", required=True, choices=sorted(CELLS))
    ap.add_argument("--out", default="results/hillclimb")
    ap.add_argument("--mesh", default=None,
                    help="a smaller mesh of the production shape, as 4x4")
    args = ap.parse_args(argv)
    arch, shape, variants = CELLS[args.cell]
    mesh = parse_mesh(args.mesh) if args.mesh else None
    os.makedirs(args.out, exist_ok=True)
    for name, kw in variants:
        t0 = time.time()
        try:
            rec = dryrun_cell(arch, shape, mesh=mesh, **kw)
        except Exception as e:  # a failure here is a bug in the port
            rec = dict(arch=arch, shape=shape, status="error",
                       error=f"{type(e).__name__}: {e}",
                       traceback=traceback.format_exc()[-2000:])
        rec["variant"] = name
        path = os.path.join(args.out, f"{args.cell}__{name}.json")
        with open(path, "w") as f:
            json.dump(rec, f, indent=1, default=str)
        if rec["status"] == "ok":
            print(f"=== {args.cell}/{name} ({time.time()-t0:.0f}s)")
            print_record(rec)
        else:
            print(f"=== {args.cell}/{name} ERROR: {rec.get('error')}")


if __name__ == "__main__":
    main()
