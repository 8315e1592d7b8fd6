"""Optimized configuration sweep: the hill-climb recipes applied to every
applicable cell, each recorded.

Counterpart of ``repro.launch.optimized_sweep``:
  decode and long cells: the int8 KV cache (H1's recipe);
  train/prefill of the small archs: ``tp_off``, pure FSDP (H3's recipe).

  PYTHONPATH=src python -m repro_torch.launch.optimized_sweep --out DIR \\
      [--kinds decode,train] [--only-arch A,B] [--mesh 4x4]
"""
from __future__ import annotations

import argparse
import json
import os
import traceback

from repro_torch.configs.base import ARCH_IDS, SHAPES, get_arch, \
    shape_applicable
from repro_torch.launch.dryrun import dryrun_cell, print_record
from repro_torch.launch.mesh import parse_mesh

# archs where H3's pure-FSDP remap beats TP on the production mesh
SMALL_DENSE = ("llama3.2-1b", "qwen3-1.7b", "h2o-danube-1.8b",
               "musicgen-large", "granite-moe-3b-a800m", "olmoe-1b-7b",
               "zamba2-1.2b", "mamba2-2.7b", "phi3-mini-3.8b")


def variant_for(arch: str, shape_name: str):
    kind = SHAPES[shape_name].kind
    if kind == "decode":
        return dict(kv_shard="auto",
                    config_override=dict(kv_cache_quant=True))
    if arch in SMALL_DENSE:
        return dict(tp=False)
    return None            # big-model train/prefill: the baseline is right


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="results/dryrun_opt")
    ap.add_argument("--kinds", default="decode",
                    help="comma list of kinds to sweep (decode,train,prefill)")
    ap.add_argument("--only-arch", default=None,
                    help="comma-separated arch filter")
    ap.add_argument("--mesh", default=None,
                    help="a smaller mesh of the production shape, as 4x4")
    args = ap.parse_args(argv)
    kinds = set(args.kinds.split(","))
    archs = args.only_arch.split(",") if args.only_arch else ARCH_IDS[:10]
    mesh = parse_mesh(args.mesh) if args.mesh else None
    os.makedirs(args.out, exist_ok=True)
    for arch in archs:
        for shape_name, shape in SHAPES.items():
            if shape.kind not in kinds:
                continue
            if not shape_applicable(get_arch(arch), shape)[0]:
                continue
            kw = variant_for(arch, shape_name)
            if kw is None:
                continue
            try:
                rec = dryrun_cell(arch, shape_name, mesh=mesh, **kw)
            except Exception as e:  # a failure here is a bug in the port
                rec = dict(arch=arch, shape=shape_name, status="error",
                           error=f"{type(e).__name__}: {e}",
                           traceback=traceback.format_exc()[-1500:])
            path = os.path.join(args.out, f"{arch}__{shape_name}__opt.json")
            with open(path, "w") as f:
                json.dump(rec, f, indent=1, default=str)
            if rec["status"] == "ok":
                print_record(rec)
            else:
                print(f"[ERROR] {arch} x {shape_name}: {rec.get('error')}")


if __name__ == "__main__":
    main()
