"""Path 1's serving rates on one CUDA card, for comparing two checkouts.

    python3 scripts/decode_rate.py [ROOT]

ROOT is a checkout of the repository (default: this one); its
``src/repro_torch`` is imported and its kernels are built into its own
``_build``, so two versions are compared on one card by running the
script once for each, back to back on one machine (parent, change,
change, parent). The workload is chip_smoke's path 1 with longer
decodes: full-width tinyllama-1.1b packed with paper_llama_mix, 8
requests of 6 seeded tokens, 32 new tokens each, 4 slots; one warm-up
run, then 3 runs. The last line is a JSON object: the decode and prefill
tok/s of each run, their medians, the first request's tokens (equal
across versions where the numbers are) and the card's name and power
limit.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
from pathlib import Path

RUNS = 3


def main() -> None:
    root = Path(sys.argv[1] if len(sys.argv) > 1 else
                Path(__file__).resolve().parent.parent).resolve()
    sys.path.insert(0, str(root / "src"))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit("decode_rate: needs a CUDA card")
    from repro_torch.configs.base import get_arch
    from repro_torch.core.policy import get_policy
    from repro_torch.core.qlinear import quantize_params
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import Engine, ServeConfig
    dev = torch.device("cuda")
    cfg = get_arch("tinyllama-1.1b")
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    qp, _ = quantize_params(params, get_policy("paper_llama_mix"))
    del params
    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size, 6)]
               for _ in range(8)]
    eng = Engine(cfg, qp, ServeConfig(
        max_new_tokens=32, max_slots=4, decode_chunk=32, cache_len=64,
        prefill_batch=4, prefill_chunk=16), device=dev)
    eng.generate(prompts[:4])
    decode, prefill, toks = [], [], None
    for _ in range(RUNS):
        torch.cuda.synchronize()
        toks = eng.generate(prompts)
        decode.append(eng.stats["tok_per_s"])
        prefill.append(eng.stats["prefill_tok_per_s"])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"root": str(root), "decode_tok_per_s": decode,
                      "decode_median": statistics.median(decode),
                      "prefill_tok_per_s": prefill,
                      "prefill_median": statistics.median(prefill),
                      "tokens0": toks[0], "card": smi}))


if __name__ == "__main__":
    main()
