#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Run it from the root of a checkout, on a machine with one NVIDIA GPU (it
is written for an H100). It imports neither JAX nor the JAX package.
Phases, each of which exits nonzero on failure:

1. build: compile every CUDA source of the port with nvcc (one process a
   source, all at once), from the checkout's sources, and print the
   build time.
2. kernels: hold every kernel against its plain PyTorch version on the
   card. The fused dequant-matmul: Q2_K/Q3_K at tinyllama-1.1b's five
   (K, N) projection shapes at decode M (``max_slots``) and slice-1
   prefill M (``prefill_batch * prefill_chunk`` = 64), Q3_K also at
   slice-2 prefill M (512); Q4_K/Q6_K at wv's
   (2048, 256), w_down's (5632, 2048) and the LM head's (2048, 32000) at
   decode M and slice-2 prefill M (512); f32 and bf16 outputs; for every
   variant, rows of an M=512 and an M=128 product equal the M=1 product
   bit for bit (at (2048, 256) and (2048, 5632), whose K the kernel
   splits; at the second, one block runs a tile's splits at M=512). The
   fused prefill attention at the serving shape (B=4, C=128, H=32, KH=4,
   D=64, T=1024+128) with empty (-1) ring slots, at D=128 (G=8 and G=1),
   D=80 (G=4) and D=96 (G=1), with a sliding window and with a softcap,
   f32 and bf16, and f32 q with bf16 k/v, on visible rows; batch row 0
   of a B=4 call equals the B=1 call bit for bit. Q3_K_O/Q4_0/Q5_K/Q8_0 at all
   five shapes at decode M and the search's M (128), Q4_0/Q8_0 also at
   (2080, 256) (K a multiple of 32, not of 256), and every variant's
   packing on the card against the CPU's, byte for byte (Q3_K_O on
   tie-free scores). The reduced model's
   logits on the card against the CPU's plain path, on both serving paths
   and under the hand-written slice-3 policy. And every full-width model
   that a later phase packs is checked as soon as it is packed: each of
   its packed weights that the kernel serves (every one but the MoE
   expert stacks, which are multiplied by bmm) through the kernel and its
   plain version at decode M, f32 and bf16 out, at these tolerances, so
   each (variant, K, N) that a served model runs is checked on the card.
3. serve, slice 1: full-width tinyllama-1.1b from random weights (seeded),
   packed with paper_llama_mix on the card, serves the paper's Table IV
   scenario (8 requests, 6-token prompts, 10 new tokens, 4 slots) through
   the port's Engine with the naive prefill attention. The launch counts
   are zeroed just before and read just after; every forward must launch
   45 q2_k + 110 q3_k kernels and no attention kernel. Greedy tokens must
   equal the engine's own generate_reference.
4. timing, slice 1: the matmul kernel's time for one forward's launches of
   each variant, at decode and prefill M, beside its bound, the plain
   version's time and torch.matmul on pre-dequantized bf16 weights; each
   line gives the kernel's share of its bound and its factor over
   torch.matmul.
5. serve, slice 2: the same weights packed with extended_mix and
   ``attn_impl="fused"``; 8 requests with prompts of 256 to 512 tokens
   (seeded), 32 new tokens, 4 slots, 128-token prefill chunks, a
   1024-slot ring. Every forward must launch 110 q3_k + 44 q4_k + 1 q6_k
   kernels and no q2_k; every prefill-chunk forward 22 attention kernels
   and every decode forward none. Greedy tokens must equal
   generate_reference.
6. timing, slice 2: Q3_K/Q4_K/Q6_K as in phase 4 on this layout
   (prefill M 512), and the
   attention kernel's time for the 22 launches of one prefill-chunk
   forward beside its bound, the plain version's time,
   ``scaled_dot_product_attention`` with the equivalent boolean mask, and
   the time of the kernel it replaced (``ATTN_BEFORE_MS``).
7. search, slice 3: ``serve --policy auto`` with no policy file (the
   launcher's ``resolve_policy`` on a fresh temporary path): calibration
   (2 batches of 2 x 64 tokens), the policy search over
   ``DEFAULT_CANDIDATES`` with 2 refinement rounds (every evaluation one
   full-width forward at M = 2 x 64 = 128), the file written; q3_k_o
   kernels must have launched, and the final policy must weakly dominate
   the seed on KL and bytes. The searched policy, packed with the
   search's stats, serves path 1's traffic; every forward must launch
   the kernels its packing implies, and greedy tokens must equal
   generate_reference. One evaluation forward's wall time is set beside
   the device time of its matmul kernels.
8. load, slice 3: a hand-written policy file (q4_0 on wq, q5_k on wo,
   q3_k_o on w_gate, q8_0 on w_down, q3_k elsewhere) through
   ``--policy auto --policy-json``: the launcher recalibrates (a q3_k_o
   rule), packs and serves path 1's traffic; every forward must launch 22
   q4_0 + 22 q5_k + 22 q3_k_o + 22 q8_0 + 67 q3_k kernels, and greedy
   tokens must equal generate_reference.
9. timing, slice 3: Q3_K_O/Q4_0/Q5_K/Q8_0 as in phase 4 on the hand-written
   layout, at decode M and at the search's M (128).
10. kernels, slice 4: the Q8_K quantization kernel against its plain
   version on the card and on the CPU, byte for byte (qs, d, bsums), at M
   in {1, 4, 33, 512} and K in {768, 2048, 3072, 5632}, f32 and bf16, with
   zero super-blocks, with and without a row mask that masks rows (masked
   rows all zero). The dequant-matmul at any N: gpt2-paper's LM head
   (768, 50257) in q2_k and one N = 8 (mod 16) shape per variant against
   the plain version, row 0 of M=33 equal to M=1 bit for bit.
11. serve, slice 4: full-width mobilellama-1.4b under paper_llama_mix and
   gpt2-paper under paper_gpt2_mix, path 1's traffic; every forward must
   launch 49 q2_k + 120 q3_k and 25 q2_k + 24 q3_k kernels, and greedy
   tokens must equal generate_reference.
12. integer path, slice 4: for each of tinyllama-1.1b, mobilellama-1.4b
   and gpt2-paper, every MatMul of the packed model (its paper mix) runs
   through the ISA driver and simulator (``isa.run_matmul``) at M = 4,
   with the Q8_K kernel's count zeroed just before and read just after:
   one launch per SCHEDULE, 1,665, 2,141 and 521 a forward. Each result is
   held against ``matmul_q8k_ref(ops.q8k_quantize(x), t)``, and that
   against ``matmul_ref(dequantize_q8_k(qx), t)``, at 1e-5 relative; the
   paper's traffic model (``total_stream_bytes``) is printed per forward.
13. timing, slice 4: the Q8_K kernel over the launches of one tinyllama
   integer-path forward (timed in groups of 256 launches, each behind its
   own spin kernel, and summed: a stream queues only about a thousand
   launches) and once at (4096, 5632), beside its bound and the plain
   version's time; gpt2-paper's decode forward per packed (variant, K,
   N), the N = 50257 q2_k head among them, beside its bound and
   torch.matmul on the pre-dequantized bf16 weights.
14. serve, slice 5: full-width llama3.2-1b (LM head tied to the
   embedding: an f32 product, no kernel), qwen3-1.7b (qk-norm),
   phi3-mini-3.8b (head N = 32064) and h2o-danube-1.8b (sliding window),
   each from random weights (seeded) packed with paper_llama_mix on the
   card, serve path 1's traffic; every forward must launch 32 + 80, 57 +
   140, 65 + 160 and 49 + 120 q2_k + q3_k kernels, and greedy tokens must
   equal generate_reference. qwen3-1.7b also serves path 2's traffic with
   ``attn_impl="fused"``: 28 attention kernels every prefill-chunk
   forward (D = 128, G = 2). phi3-mini-3.8b's decode forward is timed
   per (variant, K, N) as phase 4 times a variant.
15. temperature, slice 5: full-width qwen3-1.7b under paper_llama_mix at
   temperature 0.8, seed 7, path 1's traffic, without and with an EOS id
   (the token request 0 samples at its third step without it): the
   launch counts as in phase 14; run() equals generate_reference (on 4
   prompts, all it takes), an engine with prefill_batch=1 and a second
   engine of seed 7; seed 8 and greedy give other tokens; EOS ends
   request 0 at its third step.
16. long sequence, slice 5: full-width llama3.2-1b ``forward_seq`` at
   B=1, S=4096 under ``"auto"``, which takes the blockwise attention
   (launch counts zeroed just before and read just after: 32 + 80); its
   logits at the last 16 positions against ``attn_impl="naive"`` at
   ``TOL_LONG``.
17. int8 KV, slice 6: path 1's traffic on an int8 KV ring
   (``kv_cache_quant=True``): 45 q2_k + 110 q3_k launches a forward,
   run() equals generate_reference; ``_quantize_kv`` on the card equals
   the CPU byte for byte on a seeded (4, 4, 64) f32 and bf16 input with
   an all-zero row; decode and prefill tok/s beside the bf16 ring's.
18. prefix cache, slice 6: extended_mix with ``attn_impl="fused"``, 8
   requests of one seeded 384-token shared prefix plus seeded 16-128-token
   suffixes, 32 new tokens, 4 slots, 128-token chunks, a 1024-slot ring,
   16-position pages, a 64 MiB pool (186 pages); one engine with the
   cache off, one with it on run twice on the same prompts. All three
   give the same tokens; every forward launches 110 q3_k + 44 q4_k + 1
   q6_k and every prefill-chunk forward 22 attention kernels;
   ``prefix_hits`` is at least 4, then 8. The 22 attention launches of a
   warm chunk (prefix rows scattered from the pool) are held against the
   plain version and timed.
19. speculative decoding, slice 6: path 1's weights, 8 requests of
   6-token prompts, 32 new tokens, 4 slots, ``decode_chunk=16``,
   ``cache_len=64``, ``draft_k=4``: ngram/scan, ngram/batched and
   self (2 layers)/scan, greedy. Scan runs' tokens equal a plain engine's
   and every verify column is a 155-launch forward; the batched run
   launches 155 kernels a round, all at M = 20, and meets the margin rule;
   the self drafter launches 5 q2_k + 10 q3_k a draft step. At
   temperature 0.8, seed 7 (ngram/scan) run() equals
   generate_spec_reference; an int8 ring with ngram/scan on phase 17's
   traffic gives phase 17's tokens. The q2_k and q3_k launches of one
   batched-verify forward (M = 20) are timed as phase 4 times them.
20. SLO admission, slice 6: path 1's weights, ``preempt=True``,
   ``max_queue=2``, two-step decode chunks: four priority-0 requests fill
   the slots, a poll callback submits a priority-1 request, which
   preempts one of them (it keeps its streamed tokens and gets
   ``on_done`` once) and completes; with the slots full and two requests
   queued, a further submit raises ``EngineSaturated("queue_full")``.
   Phases 17-20 each print their wall time.
21. MoE, slice 7: full-width olmoe-1b-7b (64 experts top-8, qk-norm) from
   random weights (seeded), packed with default_serve_mix on the card
   (the expert stacks along E*K, one layer at a time): 33 q2_k + 80 q3_k
   matmuls (each expert stack counted once a layer). Path 1's traffic;
   every forward launches 33 q2_k + 32 q3_k kernels (no kernel serves an
   expert stack: they are dequantized to bf16 and multiplied by bmm, as
   the reference's einsum), greedy tokens equal generate_reference, and
   an engine with prefill_batch=1 gives prefill_batch=4's tokens. Layer
   0's moe_block on the card equals the same call on the CPU at
   ``TOL_MOE``. The peak ``max_memory_allocated``, decode and prefill
   tok/s, each packed (variant, K, N)'s decode forward timed as phase 4
   times a variant, and one decode forward's expert path by CUDA events
   (dequantize, bmm products, moe_block whole) are printed.
22. MoE fused, slice 7: olmoe with ``attn_impl="fused"`` on path 2's
   traffic: 16 attention kernels every prefill-chunk forward (D = 128,
   G = 1), generate == generate_reference, and the token choices dropped
   a chunk forward (capacity 21 a expert a row at C = 128) printed and
   nonzero; then phase 18's shared-prefix queue (a 512 MiB pool of 256
   2-MiB pages): cache off, then on twice, the same tokens (a warm group
   keeps the cold grid's whole chunks, so the same drops), 16 attention
   launches a prefill-chunk forward, and a warm chunk's 16 attention
   launches held against the plain version and timed.
23. MoE, slice 7: full-width granite-moe-3b-a800m (40 experts top-8,
   GQA 24/8, LM head N = 49155) as phase 21 without the second engine and
   the CPU check: 65 q2_k + 160 q3_k matmuls, 65 q2_k + 64 q3_k launches
   a forward, generate == generate_reference, timings as phase 21.
   Phases 21-23 each print their wall time.
24. recurrent, slice 8: full-width mamba2-2.7b (64 Mamba2 layers, d 2560,
   SSM state 128, LM head N = 50280) from random weights (seeded), packed
   with default_serve_mix on the card one layer at a time (1 q2_k + 128
   q3_k matmuls, each packed weight checked as above). Path 2's traffic
   (8 requests of 256-512-token prompts, 32 new tokens, 128-token chunks,
   4 slots, a 1024-position cache): every forward launches 1 q2_k + 128
   q3_k kernels and no attention kernel, greedy tokens equal
   generate_reference, and an engine with prefill_batch=1 gives
   prefill_batch=4's tokens. Layer 0's mamba2_forward on the card equals
   the same call on the CPU at ``TOL_SSM``. The peak
   ``max_memory_allocated``, decode and prefill tok/s, each packed
   (variant, K, N)'s decode forward timed as phase 4 times a variant,
   and, for one prefill-chunk forward, one decode step and one chunk
   forward's SSD scans, the span between CUDA events beside their
   kernels' device time and the kernels of most device time
   (``torch.profiler``) and the matmul kernels' time are printed.
25. recurrent, slice 8: full-width zamba2-1.2b (38 Mamba2 layers, d 2048,
   and a shared attention block at width 4096 after every 6 layers) as
   phase 24: 3 q2_k + 82 q3_k matmuls packed, 13 q2_k + 112 q3_k launches
   a forward (the shared block's 8 matmuls at each of its 6
   applications).
26. checkpoint prefix cache, slice 8: zamba2-1.2b on phase 18's
   shared-prefix queue with a 1 GiB pool (20 pages of one 128-token
   chunk each: SSM state, conv tail and ring): cache off, then on twice;
   the same tokens, 13 + 112 launches a forward, at least 4 hits then 8,
   and the cold and warm prefill tok/s printed.

Without a GPU, or outside a checkout, it exits nonzero and prints no
result. The last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

# card peaks for bound_ms (NVIDIA H100 SXM data sheet, dense)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
F32_FLOPS_PER_S = 67e12     # CUDA cores, outside the tensor cores

TOL_F32 = 1e-5          # kernel vs plain, f32 out: summation order only
TOL_BF16 = 2.0 ** -7    # bf16 out: one bf16 ulp at the output's max
TOL_ATTN = 5e-6         # attention, f32 out, visible rows: the reference's
                        # own kernel-vs-naive tolerance (f32 order, tiles)
TOL_MODEL = 2.0 ** -7   # reduced model, card vs CPU: bf16 input flips

# tinyllama-1.1b's (K, N): wq/wo, wk/wv, w_gate/w_up, w_down, lm_head
SHAPES = ((2048, 2048), (2048, 256), (2048, 5632), (5632, 2048),
          (2048, 32000))
SERVE = dict(max_new_tokens=10, max_slots=4, decode_chunk=10, cache_len=64,
             prefill_batch=4, prefill_chunk=16, prefill_bucket=16)
N_REQUESTS, PROMPT_LEN = 8, 6
M_DECODE = SERVE["max_slots"]
M_PREFILL = SERVE["prefill_batch"] * SERVE["prefill_chunk"]

# slice 2: extended_mix with the fused prefill attention, real prompts
SHAPES2 = ((2048, 256), (5632, 2048), (2048, 32000))   # wv, w_down, lm_head
SERVE2 = dict(max_new_tokens=32, max_slots=4, decode_chunk=32,
              cache_len=1024, prefill_batch=4, prefill_chunk=128,
              prefill_bucket=128)
PROMPT_RANGE2 = (256, 512)
M_PREFILL2 = SERVE2["prefill_batch"] * SERVE2["prefill_chunk"]
# (B, C, H, KH, D, ring T): the serving shape of one prefill chunk
ATTN_SERVE = (SERVE2["prefill_batch"], SERVE2["prefill_chunk"], 32, 4, 64,
              SERVE2["cache_len"])
# the attention's time a prefill-chunk forward before the tensor-core
# redesign (PERF.md, H100 80GB HBM3 at 700 W)
ATTN_BEFORE_MS = 4.347
# slice 3: --policy auto; a search evaluation is one forward of the eval
# batch (2 sequences of 64 tokens)
M_SEARCH = 2 * 64
SEARCH_ROUNDS = 2
HAND_MIX = {"name": "hand_mix",
            "rules": [["*attn/wq", "q4_0"], ["*attn/wo", "q5_k"],
                      ["*mlp/w_gate", "q3_k_o"], ["*mlp/w_down", "q8_0"]],
            "default": "q3_k"}
HAND_PER_FORWARD = {"q4_0": 22, "q5_k": 22, "q3_k_o": 22, "q8_0": 22,
                    "q3_k": 67}
SLICE3_VARIANTS = ("q3_k_o", "q4_0", "q5_k", "q8_0")
RAGGED_K = ((2080, 256),)       # K % 32 == 0, K % 256 != 0
# slice 4: the integer (Q8_K) datapath at M = 4 over every MatMul of the
# paper's three models; SCHEDULEs (one Q8_K launch each) per forward, by
# the reference's generate_stream
M_INT = 4
TOL_INT = 1e-5          # the reference's test_isa.py tolerance
INT_SCHEDULES = {"tinyllama-1.1b": 1665, "mobilellama-1.4b": 2141,
                 "gpt2-paper": 521}
PAPER_MODELS = (("mobilellama-1.4b", "paper_llama_mix",
                 {"q2_k": 49, "q3_k": 120}),
                ("gpt2-paper", "paper_gpt2_mix", {"q2_k": 25, "q3_k": 24}))
Q8K_MS = (1, 4, 33, 512)
Q8K_KS = (768, 2048, 3072, 5632)
Q8K_BIG = (4096, 5632)
Q8K_BYTES_PER_VALUE = 4 + 1 + 4 / 256 + 2 / 16   # f32 in; qs, d, bsums out
GPT2_HEAD = (768, 50257)
# slice 5: the rest of the dense family under paper_llama_mix, path 1's
# traffic; matmul launches a forward (a tied head is an f32 product with
# the embedding, no kernel)
SLICE5_MODELS = (("llama3.2-1b", {"q2_k": 32, "q3_k": 80}),
                 ("qwen3-1.7b", {"q2_k": 57, "q3_k": 140}),
                 ("phi3-mini-3.8b", {"q2_k": 65, "q3_k": 160}),
                 ("h2o-danube-1.8b", {"q2_k": 49, "q3_k": 120}))
FUSED5 = "qwen3-1.7b"           # also serves path 2's traffic, fused
TIMED5 = "phi3-mini-3.8b"       # its decode shapes timed one by one
TEMP5 = dict(temperature=0.8, seed=7)
LONG5 = ("llama3.2-1b", 4096, 16)   # arch, S, last positions compared
# blockwise against naive at S = 4096 in bf16, relative to the largest
# logit: the two sum the same f32 softmax in another order, so a bf16
# rounding of an attention output can flip by one step (2**-8) and move
# the next layers' inputs; 8 such steps across 16 layers
TOL_LONG = 2.0 ** -5
# slice 6: the engine's int8 KV ring, prefix cache, speculative decoding
# and SLO admission on full-width tinyllama-1.1b
KV8_PER_FORWARD = {"q2_k": 45, "q3_k": 110}         # paper_llama_mix
EXTENDED_PER_FORWARD = {"q3_k": 110, "q4_k": 44, "q6_k": 1}
SERVE_PREFIX = dict(SERVE2, prefill_bucket=16, prefix_page=16,
                    prefix_bytes=64 << 20)
SHARED_PREFIX, SUFFIX_RANGE = 384, (16, 128)
PREFIX_CAPACITY = 186           # 64 MiB over 22 x 16 x 4 x 64 x 2 B x (k, v)
SERVE_SPEC = dict(max_new_tokens=32, max_slots=4, decode_chunk=16,
                  cache_len=64, prefill_batch=4, prefill_chunk=16,
                  prefill_bucket=16, draft_k=4)
M_VERIFY = SERVE_SPEC["max_slots"] * (SERVE_SPEC["draft_k"] + 1)   # 20
DRAFT_LAYERS = 2
SELF_PER_DRAFT = {"q2_k": 5, "q3_k": 10}    # 2 layers' wk, wv + the head
SERVE_SLO = dict(SERVE, decode_chunk=2, preempt=True, max_queue=2)
MARGIN_TOL = 0.1        # ROADMAP's parity contract (test_torch_engine.py)
# slice 7: the MoE family at full width under default_serve_mix (the
# reference launcher's default); (arch, variant_counts, matmul launches a
# forward): the expert stacks are packed (counted once a layer) but run
# as bmm on dequantized bf16 stacks, so no matmul kernel serves them
MOE_POLICY = "default_serve_mix"
MOE_MODELS = (("olmoe-1b-7b", {"q2_k": 33, "q3_k": 80},
               {"q2_k": 33, "q3_k": 32}),
              ("granite-moe-3b-a800m", {"q2_k": 65, "q3_k": 160},
               {"q2_k": 65, "q3_k": 64}))
MOE_FUSED = "olmoe-1b-7b"       # also path 2's traffic fused, and the
                                # prefix cache on phase 18's traffic
# phase 18's queue on olmoe: 2 MiB pages (16 layers x 16 positions x 16
# KV heads x 128 x 2 B x (k, v)), a 512 MiB pool
SERVE_PREFIX_MOE = dict(SERVE_PREFIX, prefix_bytes=512 << 20)
PREFIX_CAPACITY_MOE = 256
TOL_MOE = 2.0 ** -6     # one layer's moe_block, card vs CPU, bf16 out: the
                        # bf16 expert products summed in another order, and
                        # the output rounded again (tests/test_torch_cuda.py)
# slice 8: the recurrent families at full width under default_serve_mix,
# path 2's traffic (no attention kernel: zamba2's shared block prefills
# through the naive attention, as the reference's); (arch, variant_counts,
# matmul launches a forward): zamba2's shared block is packed once and
# runs at each of its six applications
REC_POLICY = "default_serve_mix"
REC_MODELS = (("mamba2-2.7b", {"q2_k": 1, "q3_k": 128},
               {"q2_k": 1, "q3_k": 128}),
              ("zamba2-1.2b", {"q2_k": 3, "q3_k": 82},
               {"q2_k": 13, "q3_k": 112}))
REC_PREFIX = "zamba2-1.2b"      # phase 18's shared-prefix queue, phase 26
# a checkpoint page is one 128-token chunk: 53 MB on zamba2 (39.8 MB of
# SSM state, 1 MB of conv tail, 12.6 MB of ring for 6 applications)
SERVE_PREFIX_REC = dict(SERVE_PREFIX, prefix_bytes=1 << 30)
PREFIX_CAPACITY_REC = 20
TOL_SSM = 2.0 ** -6     # layer 0's mamba2_forward, card vs CPU, bf16 out:
                        # in_proj's bf16 output rounds differently where
                        # the f32 sums differ, and the scan carries it on
# rows held against the M=1 product: places in an 8-token group, in a
# 64-token tile and past the first tile
ROWS_CHECKED = (0, 3, 7, 8, 63, 64, 127, 200, 511)
ROW_SHAPES = ((2048, 256), (2048, 5632))
# launches per timed group: the kernel's wrapper launches one kernel a
# call, the plain version about twenty small ones
Q8K_GROUP, Q8K_GROUP_PLAIN = 256, 16
# each variant at the M of every path that runs it: q3_k is on all three
MATMUL_CASES = (("q2_k", SHAPES, (M_DECODE, M_PREFILL, M_SEARCH)),
                ("q3_k", SHAPES, (M_DECODE, M_PREFILL, M_PREFILL2,
                                  M_SEARCH)),
                ("q4_k", SHAPES, (M_DECODE, M_PREFILL2, M_SEARCH)),
                ("q6_k", SHAPES, (M_DECODE, M_PREFILL2, M_SEARCH)),
                ("q3_k_o", SHAPES, (M_DECODE, M_SEARCH)),
                ("q4_0", SHAPES + RAGGED_K, (M_DECODE, M_SEARCH)),
                ("q5_k", SHAPES, (M_DECODE, M_SEARCH)),
                ("q8_0", SHAPES + RAGGED_K, (M_DECODE, M_SEARCH)))


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def rel_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max()
                 / b.float().abs().max().clamp_min(1e-30))


def phase_build(build):
    t0 = time.perf_counter()
    paths = build.build()
    dt = time.perf_counter() - t0
    regs = [ln.strip() for out in build.build_log.values()
            for ln in out.splitlines() if "registers" in ln]
    print(f"[build] {sorted(paths)} in {dt:.1f}s; ptxas: "
          f"{regs[0] if regs else 'cached build'} ... "
          f"({len(regs)} kernel instantiations)", flush=True)


def phase_kernels(torch, Q, PB, dev):
    """Matmul kernel vs plain at the main paths' shapes; returns max abs
    error (f32 output) per variant."""
    g = torch.Generator(device=dev).manual_seed(1)
    max_abs = {}
    for variant, shapes, ms in MATMUL_CASES:
        worst = 0.0
        for (K, N) in shapes:
            w = torch.randn(K, N, generator=g, device=dev) / K ** 0.5
            t = Q.quantize(variant, w)
            for M in ms:
                x = torch.randn(M, K, generator=g, device=dev).bfloat16()
                y = PB.bfp_matmul_cuda(x, t, out_dtype=torch.float32)
                ref = PB.bfp_matmul_plain(x, t, out_dtype=torch.float32)
                yb = PB.bfp_matmul_cuda(x, t)
                rb = PB.bfp_matmul_plain(x, t)
                torch.cuda.synchronize()
                e32, e16 = rel_err(y, ref), rel_err(yb, rb)
                worst = max(worst, float((y - ref).abs().max()))
                print(f"[kernels] {variant} M={M:3d} K={K:5d} N={N:5d}: "
                      f"f32 rel {e32:.2e} (tol {TOL_F32:.0e}), bf16 rel "
                      f"{e16:.2e} (tol {TOL_BF16:.2e})", flush=True)
                check(bool(torch.isfinite(y).all()), "non-finite output")
                check(e32 <= TOL_F32, f"{variant} {M}x{K}x{N} f32 error")
                check(e16 <= TOL_BF16, f"{variant} {M}x{K}x{N} bf16 error")
        row_ok = rows_independent_of_m(torch, Q, PB, dev, g, variant)
        print(f"[kernels] {variant} rows {ROWS_CHECKED} of M=512 and M=128 "
              f"== M=1 bit for bit ((K, N) in {ROW_SHAPES}, K split in "
              f"{[PB.k_splits(*s) for s in ROW_SHAPES]}; f32 and bf16 out): "
              f"{row_ok}", flush=True)
        check(row_ok, f"{variant}: a row depends on M")
        max_abs[variant] = worst
    phase_packing(torch, Q, PB, dev, g)
    return max_abs


def rows_independent_of_m(torch, Q, PB, dev, g, variant) -> bool:
    """Rows of an M=512 and an M=128 product against the M=1 product of
    each row, bit for bit, at places in an 8-token group and a 64-token
    tile, on two shapes whose K is split: wk's (2048, 256), where the
    partials go through the workspace at every M, and w_up's (2048, 5632),
    where one block runs a tile's splits in turn at M=512."""
    for K, N in ROW_SHAPES:
        x = torch.randn(512, K, generator=g, device=dev).bfloat16()
        t = Q.quantize(variant, torch.randn(K, N, generator=g, device=dev)
                       / K ** 0.5)
        for out_dtype in (torch.float32, torch.bfloat16):
            full = {M: PB.bfp_matmul_cuda(x[:M], t, out_dtype=out_dtype)
                    for M in (512, 128)}
            for m in ROWS_CHECKED:
                one = PB.bfp_matmul_cuda(x[m:m + 1], t,
                                         out_dtype=out_dtype)[0]
                if not all(torch.equal(f[m], one) for M, f in full.items()
                           if m < M):
                    return False
    return True


def tie_free_weights(torch, L, K, N, dev, g):
    """(L, K, N) weights whose |w| are distinct within every column: each
    column holds 1 + p / K for a random permutation p of 0..K-1 (exact in
    f32), with random signs. Activation stats of powers of two keep the
    scores |w| * a distinct too, so top-k has a single answer."""
    perm = torch.argsort(torch.rand(L, N, K, generator=g, device=dev), -1)
    sign = torch.randint(0, 2, (L, K, N), generator=g, device=dev) * 2 - 1
    act = 2.0 ** torch.randint(0, 3, (K,), generator=g, device=dev)
    return (1 + perm.transpose(1, 2).float() / K) * sign, act.float()


def _same_payloads(torch, a, b) -> bool:
    return all(torch.equal(v.cpu().view(torch.uint8),
                           b.data[k].cpu().view(torch.uint8))
               for k, v in a.data.items())


def phase_packing(torch, Q, PB, dev, g):
    """Packing on the card against the CPU's, at w_gate's shape: every
    variant on random normal weights, byte for byte (the reference's
    packing is the CPU's, test_torch_formats). q3_k_o, two stacked layers:
    on tie-free scores byte for byte; on random normal weights exact score
    ties occur at this size and torch.topk orders the tied rows
    differently on the two devices, so there both selections must be
    top-8 sets of the same scores, and the count of (super-block, column)
    pairs whose sidecar differs is printed."""
    L, K, N = 2, 2048, 5632
    for variant in PB.VARIANTS:
        if variant == "q3_k_o":
            continue
        w = torch.randn(K, N, generator=g, device=dev)
        same = _same_payloads(torch, Q.quantize(variant, w),
                              Q.quantize(variant, w.cpu()))
        print(f"[kernels] {variant} packing {(K, N)}: card == CPU byte for "
              f"byte: {same}", flush=True)
        check(same, f"{variant} packing on the card differs from the CPU's")
    w, act = tie_free_weights(torch, L, K, N, dev, g)
    for a in (None, act):
        same = _same_payloads(
            torch, Q.quantize_q3_k_o(w, act_absmax=a),
            Q.quantize_q3_k_o(w.cpu(), act_absmax=None if a is None
                              else a.cpu()))
        print(f"[kernels] q3_k_o packing {(L, K, N)}, tie-free scores, act "
              f"stats {a is not None}: card == CPU byte for byte: {same}",
              flush=True)
        check(same, "q3_k_o packing on the card differs from the CPU's")
    w = torch.randn(L, K, N, generator=g, device=dev)
    gpu, cpu = Q.quantize_q3_k_o(w), Q.quantize_q3_k_o(w.cpu())
    score = w.cpu().abs().reshape(L, K // 256, 256, N)
    picked = {}
    for name, t in (("gpu", gpu), ("cpu", cpu)):
        idx = t.data["oidx"].cpu().long().reshape(L, K // 256, 8, N)
        picked[name] = torch.gather(score, 2, idx).sort(dim=2).values
    differ = (gpu.data["oidx"].cpu() != cpu.data["oidx"]).reshape(
        L, K // 256, 8, N).any(2)
    ok = torch.equal(picked["gpu"], picked["cpu"])
    print(f"[kernels] q3_k_o packing {(L, K, N)}, random normal weights: "
          f"same top-8 scores everywhere: {ok}; sidecar order differs in "
          f"{int(differ.sum())} of {differ.numel()} (super-block, column) "
          f"pairs (exact score ties)", flush=True)
    check(ok, "q3_k_o on the card picks other scores than on the CPU")


def attn_inputs(torch, dev, B, C, H, KH, D, T_ring, start, dtype, g,
                pad=0):
    """One prefill chunk's attention problem as the engine builds it: the
    ring holds positions [0, start) at their slots (the other slots are
    empty, -1), the chunk's C keys follow with positions start.., and the
    last ``pad`` columns of batch row 0 are right-padding (-1 keys)."""
    T = T_ring + C
    q = torch.randn(B, C, H, D, generator=g, device=dev).to(dtype)
    k = torch.randn(B, T, KH, D, generator=g, device=dev).to(dtype)
    v = torch.randn(B, T, KH, D, generator=g, device=dev).to(dtype)
    slots = torch.arange(T_ring, device=dev)
    ring = torch.where(slots < start, slots, torch.full_like(slots, -1))
    q_pos = (start + torch.arange(C, device=dev)).expand(B, C)
    new = q_pos.clone()
    if pad:
        new[0, C - pad:] = -1
    kv_pos = torch.cat([ring.expand(B, T_ring), new], 1)
    return (q, k, v, q_pos.to(torch.int32).contiguous(),
            kv_pos.to(torch.int32).contiguous())


def visible_rows(qp, kp, window):
    vis = (kp[:, None, :] >= 0) & (kp[:, None, :] <= qp[:, :, None])
    if window:
        vis = vis & (kp[:, None, :] > qp[:, :, None] - window)
    return vis


def phase_attention(torch, PA, dev):
    """Attention kernel vs plain; returns max abs error (f32 output)."""
    g = torch.Generator(device=dev).manual_seed(5)
    B, C, H, KH, D, T_ring = ATTN_SERVE
    f32, bf16 = torch.float32, torch.bfloat16
    both = ((f32, f32), (bf16, bf16))
    # (name, attn_inputs' shape, kwargs, (q dtype, k/v dtype) pairs)
    cases = (("serve", (B, C, H, KH, D, T_ring, 256), {}, both),
             ("serve, first chunk", (B, C, H, KH, D, T_ring, 0), {}, both),
             ("D=128", (2, 64, 16, 2, 128, 256, 192), {}, both),
             ("D=128, G=1 (mobilellama-1.4b)",
              (2, 64, 16, 16, 128, 256, 192), {}, both),
             ("D=80, G=4 (h2o-danube-1.8b)", (2, 64, 32, 8, 80, 256, 192),
              {}, both),
             ("D=96, G=1 (phi3-mini)", (2, 64, 32, 32, 96, 256, 192), {},
              both),
             ("mixed, q f32, k/v bf16", (B, C, H, KH, D, T_ring, 256), {},
              ((f32, bf16),)),
             ("window 200", (2, C, H, KH, D, T_ring, 384),
              {"window": 200}, both),
             ("softcap 30", (2, C, H, KH, D, T_ring, 256),
              {"softcap": 30.0}, both))
    worst = 0.0
    for name, shape, kw, dtypes in cases:
        for qdt, kvdt in dtypes:
            q, k, v, qp, kp = attn_inputs(torch, dev, *shape, f32, g, pad=17)
            q, k, v = q.to(qdt), k.to(kvdt), v.to(kvdt)
            y = PA.prefill_attn_cuda(q, k, v, qp, kp, **kw)
            ref = PA.prefill_attn_plain(q, k, v, qp, kp, **kw)
            torch.cuda.synchronize()
            vis = visible_rows(qp, kp, kw.get("window")).any(-1)
            err = rel_err(y[vis], ref[vis])
            tol = TOL_ATTN if qdt == f32 else TOL_BF16
            dt = str(qdt) if qdt == kvdt else f"{qdt} x {kvdt}"
            print(f"[kernels] prefill_attn {name} {tuple(q.shape)} x "
                  f"T={k.shape[1]} {dt}: rel {err:.2e} (tol {tol:.1e}) "
                  f"on {int(vis.sum())} visible rows of "
                  f"{vis.numel()}", flush=True)
            check(bool(torch.isfinite(y[vis]).all()), "non-finite output")
            check(err <= tol, f"prefill_attn {name} {dt} error")
            if qdt == f32:
                worst = max(worst, float((y - ref)[vis].abs().max()))
    q, k, v, qp, kp = attn_inputs(torch, dev, B, C, H, KH, D, T_ring, 256,
                                  torch.bfloat16, g)
    full = PA.prefill_attn_cuda(q, k, v, qp, kp)
    one = PA.prefill_attn_cuda(q[:1], k[:1], v[:1], qp[:1], kp[:1])
    row_ok = torch.equal(full[:1], one)
    print(f"[kernels] prefill_attn batch row 0 of B=4 == B=1 bit for bit: "
          f"{row_ok}", flush=True)
    check(row_ok, "prefill_attn: a batch row depends on B")
    return worst


def phase_small_model(torch, get_arch, quantize_params, to_device, T, dev,
                      policy, attn_impl):
    """Reduced tinyllama in f32: prefill + two decode steps through the
    kernels on the card against the plain path on the CPU."""
    cfg = get_arch("tinyllama-1.1b", reduced=True).replace(
        dtype="float32", attn_impl=attn_impl)
    params = T.init_params(cfg, torch.Generator().manual_seed(2),
                           device="cpu")
    qp, _ = quantize_params(params, policy)
    qg = to_device(qp, dev)
    toks = torch.randint(0, cfg.vocab_size, (2, 8),
                         generator=torch.Generator().manual_seed(3))
    lengths = torch.tensor([8, 5])
    outs = {}
    for name, p, d in (("cpu", qp, torch.device("cpu")), ("cuda", qg, dev)):
        cache = T.init_cache(cfg, 2, 32, dtype=torch.float32, device=d)
        h, cache = T.prefill_chunk(p, cfg, cache, tokens=toks.to(d), start=0,
                                   lengths=lengths.to(d))
        logits = [T.lm_logits(p, cfg, h[torch.arange(2, device=d),
                                        lengths.to(d) - 1])]
        pos = lengths.clone()
        nxt = torch.tensor([1, 2])
        for _ in range(2):
            lg, cache = T.decode_step(p, cfg, cache, tokens=nxt.to(d),
                                      position=pos.to(d))
            logits.append(lg)
            pos = pos + 1
            nxt = nxt + 1
        outs[name] = [lg.cpu() for lg in logits]
    errs = [rel_err(a, b) for a, b in zip(outs["cuda"], outs["cpu"])]
    print(f"[kernels] reduced model ({policy.name}, attn_impl={attn_impl}) "
          f"logits, card vs CPU plain path: rel {max(errs):.2e} (tol "
          f"{TOL_MODEL:.2e})", flush=True)
    check(max(errs) <= TOL_MODEL, "reduced model disagrees with the CPU")
    check(all(bool(torch.isfinite(lg).all()) for lg in outs["cuda"]),
          "non-finite logits")


def phase_serve(torch, cfg, qp, Engine, ServeConfig, PB, PA, T, dev, tag,
                scfg, prompts, per_forward, attn_per_prefill):
    """Serve ``prompts`` through the port's Engine (the main path) with the
    launch counts zeroed just before and read just after; every forward
    must launch ``per_forward`` matmul kernels per variant, every
    prefill-chunk forward ``attn_per_prefill`` attention kernels."""
    eng = Engine(cfg, qp, ServeConfig(**scfg), device=dev)
    slots = scfg["max_slots"]
    eng.generate(prompts[:slots])               # warm-up: allocator, cuBLAS
    torch.cuda.synchronize()

    PB.reset_launches()
    PA.reset_launches()
    t0 = time.perf_counter()
    results = eng.generate(prompts)             # the main path
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(PB.launches)
    attn = PA.launches["prefill_attn"]
    s = dict(eng.stats)

    fwd, pfwd = s["forwards"], s["prefill_forwards"]
    print(f"[{tag}] {len(results)} requests ({s['prefill_tokens']} prompt "
          f"tokens) in {wall:.3f}s: prefill {s['prefill_tok_per_s']:.1f} "
          f"tok/s ({s['prefill_groups']} groups), decode "
          f"{s['tok_per_s']:.1f} tok/s, {s['host_syncs']} host syncs, "
          f"{fwd} forwards ({pfwd} prefill chunks)", flush=True)
    for i, toks in enumerate(results):
        print(f"[{tag}] request {i} ({len(prompts[i])}-token prompt): "
              f"{len(toks)} tokens {toks}", flush=True)
    per_fwd = {v: launches[v] / max(fwd, 1) for v in PB.VARIANTS}
    print(f"[{tag}] kernel launches: {launches} = {per_fwd} per forward; "
          f"prefill_attn {attn} = {attn / max(pfwd, 1)} per prefill-chunk "
          f"forward", flush=True)
    want = {v: per_forward.get(v, 0) * fwd for v in PB.VARIANTS}
    check(fwd > 0 and launches == want,
          f"expected {per_forward} launches per forward, got {launches} "
          f"over {fwd} forwards")
    check(pfwd > 0 and attn == attn_per_prefill * pfwd,
          f"expected {attn_per_prefill} prefill_attn launches per "
          f"prefill-chunk forward and none per decode forward, got {attn} "
          f"over {pfwd} prefill-chunk and {fwd - pfwd} decode forwards")
    budget = scfg["max_new_tokens"]
    check(all(len(t) == budget for t in results),
          f"a request did not get its {budget} tokens")
    check(all(0 <= x < cfg.vocab_size for t in results for x in t),
          "token out of vocabulary")
    for lo in range(0, len(prompts), slots):
        ref = eng.generate_reference(prompts[lo:lo + slots])
        check(ref == results[lo:lo + slots],
              f"requests {lo}..: generate != generate_reference")
    print(f"[{tag}] greedy tokens == generate_reference: True", flush=True)

    n = min(len(prompts[0]), 16)
    cache = T.init_cache(cfg, 1, 16, device=dev)
    h, _ = T.prefill_chunk(qp, cfg, cache, tokens=torch.tensor(
        [prompts[0][:n]], device=dev), start=0,
        lengths=torch.tensor([n], device=dev))
    logits = T.lm_logits(qp, cfg, h[:, n - 1])
    check(logits.shape == (1, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()), "bad full-width logits")
    return launches, attn, s


def _device_ms(torch, fn, reps):
    """Median device time of ``fn`` (many launches): the stream is held by
    a spin kernel while the host enqueues, so host overhead between
    launches does not count."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(max(host_s, 1e-3) * 1.5 * 2e9))
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _timing(ms, plain_ms, library_ms, nbytes, flops, launches,
            peak=BF16_FLOPS_PER_S):
    """A timed row: the kernel's, the plain version's and the library
    call's ms beside the bound, the larger of ``nbytes`` over the HBM
    rate and ``flops`` over ``peak``."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                launches_per_forward=launches, bytes=nbytes, flops=flops)


def phase_timing(torch, qp, cfg, PB, Q, dev, tag, variants, m_prefill,
                 big="prefill", head_m=M_DECODE, decode=True):
    """Per variant, one forward's launches at decode M (unless ``decode``
    is False) and at ``m_prefill`` (the phase named ``big``: a prefill
    chunk, where the LM head runs on ``head_m`` gathered rows, or a search
    evaluation or a batched verify, where it runs on every row)."""
    layers = qp["layers"]
    mats = {v: [] for v in variants}
    for blk, name in (("attn", "wq"), ("attn", "wk"), ("attn", "wv"),
                      ("attn", "wo"), ("mlp", "w_gate"), ("mlp", "w_up"),
                      ("mlp", "w_down")):
        t = layers[blk][name]
        if getattr(t, "variant", None) in mats:
            mats[t.variant] += [(t.layer(i), False)
                                for i in range(cfg.n_layers)]
    if getattr(qp["lm_head"], "variant", None) in mats:
        mats[qp["lm_head"].variant].append((qp["lm_head"], True))
    g = torch.Generator(device=dev).manual_seed(4)
    out = {}
    for variant, ws in mats.items():
        dense = [Q.dequantize(t, torch.bfloat16) for t, _ in ws]
        res = {}
        for phase, M, mh in ((("decode", M_DECODE, M_DECODE),) * decode
                             + ((big, m_prefill, head_m),)):
            ms_ = [mh if head else M for _, head in ws]
            xs = {(m, t.shape[0]): torch.randn(
                m, t.shape[0], generator=g, device=dev).bfloat16()
                for m, (t, _) in zip(ms_, ws)}
            jobs = [(xs[(m, t.shape[0])], t, w)
                    for m, (t, _), w in zip(ms_, ws, dense)]
            kern = _device_ms(torch, lambda: [PB.bfp_matmul_cuda(x, t)
                                              for x, t, _ in jobs], 10)
            plain = _device_ms(torch, lambda: [PB.bfp_matmul_plain(x, t)
                                               for x, t, _ in jobs], 3)
            lib = _device_ms(torch, lambda: [torch.matmul(x, w)
                                             for x, _, w in jobs], 10)
            nbytes = sum(x.numel() * 2 + t.nbytes + x.shape[0] * t.shape[1]
                         * 2 for x, t, _ in jobs)
            flops = sum(2 * x.shape[0] * t.shape[0] * t.shape[1]
                        for x, t, _ in jobs)
            res[phase] = _timing(kern, plain, lib, nbytes, flops,
                                 len(jobs))
            print(f"[{tag}] {variant} {phase} forward ({len(jobs)} "
                  f"launches, M={M}): kernel {kern:.3f} ms, bound "
                  f"{res[phase]['bound_ms']:.3f} ms ({res[phase]['bound_by']}"
                  f", {nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP; kernel "
                  f"at {res[phase]['bound_ms'] / kern:.1%} of it), plain "
                  f"{plain:.3f} ms, torch.matmul on bf16 {lib:.3f} ms "
                  f"(kernel / torch.matmul {kern / lib:.2f}x)", flush=True)
        del dense
        out[variant] = res
    return out


def _sdpa_ms(torch, jobs):
    """The attention's yardstick: one ``scaled_dot_product_attention``
    call a job (q, k, v, q_pos, kv_pos) on the same inputs, heads first,
    with the equivalent boolean mask (never called by the port)."""
    import torch.nn.functional as Fn
    sdpa = [(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
             visible_rows(qp, kp, None)[:, None])
            for q, k, v, qp, kp in jobs]
    return _device_ms(torch, lambda: [Fn.scaled_dot_product_attention(
        q, k, v, attn_mask=m, enable_gqa=True) for q, k, v, m in sdpa], 10)


def phase_attn_timing(torch, PA, n_layers, dev):
    """The 22 attention launches of one prefill-chunk forward at the
    serving shape: the third 128-token chunk of a 512-token prompt (the
    ring holds positions 0..255), different K/V per layer as the ring
    has, so the 22 calls stream their K/V from HBM and not the 50 MB L2."""
    g = torch.Generator(device=dev).manual_seed(6)
    B, C, H, KH, D, T_ring = ATTN_SERVE
    jobs = [attn_inputs(torch, dev, B, C, H, KH, D, T_ring, 256,
                        torch.bfloat16, g) for _ in range(n_layers)]
    kern = _device_ms(torch, lambda: [PA.prefill_attn_cuda(*j)
                                      for j in jobs], 10)
    plain = _device_ms(torch, lambda: [PA.prefill_attn_plain(*j)
                                       for j in jobs], 3)
    lib = _sdpa_ms(torch, jobs)
    # the bytes this data needs: q, the bf16 out and both position
    # vectors in full, K and V only at the slots some query of the batch
    # row can see (the empty ring slots are never read)
    nbytes = sum(2 * q.numel() * q.element_size()
                 + (qp.numel() + kp.numel()) * kp.element_size()
                 + 2 * int(visible_rows(qp, kp, None).any(1).sum())
                 * KH * D * k.element_size()
                 for q, k, _, qp, kp in jobs)
    # the work this data needs: 4 * D flops per visible (query, key) pair
    # and head (q.k and p.v)
    pairs = sum(int(visible_rows(qp, kp, None).sum())
                for _, _, _, qp, kp in jobs)
    flops = pairs * H * 4 * D
    res = _timing(kern, plain, lib, nbytes, flops, len(jobs))
    print(f"[timing2] prefill_attn prefill-chunk forward ({len(jobs)} "
          f"launches, B={B} C={C} H={H} KH={KH} D={D} T={T_ring + C}): "
          f"kernel {kern:.3f} ms, bound {res['bound_ms']:.4f} ms "
          f"({res['bound_by']}, {nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} "
          f"GFLOP), plain {plain:.3f} ms, scaled_dot_product_attention "
          f"{lib:.3f} ms; x lib {kern / lib:.2f}; the CUDA-core kernel it "
          f"replaced took {ATTN_BEFORE_MS} ms", flush=True)
    return res


def pack_full_width(torch, cfg, T, quantize_params, variant_counts,
                    get_policy, policy, dev, expect, PB):
    t0 = time.perf_counter()
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    qp, report = quantize_params(params, get_policy(policy))
    del params
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    counts = variant_counts(report, qp)
    print(f"[pack] full-width {cfg.name} under {policy} packed in "
          f"{time.perf_counter() - t0:.1f}s: {counts} matmuls", flush=True)
    check(counts == expect, f"{policy} layout: {counts}, expected {expect}")
    check_shapes(torch, qp, cfg, PB, dev)
    return qp


def phase_search(torch, cfg, params, resolve_policy, quantize_params,
                 variant_counts, PB, dev, path):
    """``serve --policy auto`` with no file at ``path``: calibrate, search,
    write, pack with the search's stats. The launch counts are zeroed just
    before and read just after."""
    PB.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    policy, calib, info = resolve_policy(
        cfg, params, policy="auto", arch=cfg.name, policy_json=str(path),
        search_rounds=SEARCH_ROUNDS, device=dev)
    torch.cuda.synchronize()
    t_search = time.perf_counter() - t0
    launches = dict(PB.launches)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    meta = info["meta"]
    check(path.exists(), "the search wrote no policy file")
    print(f"[search] calibration ({meta['calib_tokens']} rows) and search "
          f"in {t_search:.1f}s: {info['evaluations']} evaluations at "
          f"M={M_SEARCH}; seed kl {meta['seed']['kl']:.6f} bytes "
          f"{meta['seed']['bytes']} -> final kl {meta['final']['kl']:.6f} "
          f"bytes {meta['final']['bytes']} (top1 {meta['final']['top1']:.3f}"
          f", pseudo-ppl {meta['final']['pseudo_ppl']:.3f})", flush=True)
    print(f"[search] assignment: {info['assignment']}", flush=True)
    print(f"[search] kernel launches during the search: {launches}; peak "
          f"device memory {peak_gb:.2f} GB", flush=True)
    check(launches["q3_k_o"] > 0, "the search launched no q3_k_o kernel")
    check(meta["final"]["kl"] <= meta["seed"]["kl"] * (1 + 1e-6)
          and meta["final"]["bytes"] <= meta["seed"]["bytes"],
          "the searched policy does not weakly dominate the seed")
    t0 = time.perf_counter()
    qp, report = quantize_params(params, policy, calib=calib)
    torch.cuda.synchronize()
    counts = variant_counts(report, qp)
    print(f"[search] searched policy packed in "
          f"{time.perf_counter() - t0:.1f}s: {counts} matmuls", flush=True)
    return qp, counts, launches, dict(t_search=t_search, peak_gb=peak_gb,
                                      evaluations=info["evaluations"],
                                      seed=meta["seed"], final=meta["final"],
                                      assignment=info["assignment"])


def phase_search_eval(torch, cfg, qp, counts, PB, Q, T, dev):
    """Where one search evaluation's time goes: the wall time of one
    forward of the eval batch (2 x 64 tokens) on the searched packing,
    against the device time of its matmul kernels (every launch at
    M = 128, the LM head included)."""
    toks = torch.randint(0, cfg.vocab_size, (2, 64), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(7))
    T.forward_seq(qp, cfg, tokens=toks)
    walls = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        T.forward_seq(qp, cfg, tokens=toks)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall = statistics.median(walls)
    timing = phase_timing(torch, qp, cfg, PB, Q, dev, "timing3s",
                          tuple(counts), M_SEARCH, big="search",
                          head_m=M_SEARCH)
    kern = sum(t["search"]["ms"] for t in timing.values())
    print(f"[search] one evaluation forward (2 x 64 tokens, searched "
          f"layout): {wall:.3f} ms wall (median of 5), of which the matmul "
          f"kernels {kern:.3f} ms of device time ({kern / wall:.0%})",
          flush=True)
    return dict(wall_ms=wall, matmul_ms=kern)


def phase_load(torch, cfg, params, resolve_policy, quantize_params,
               variant_counts, dev, path):
    """``serve --policy auto --policy-json`` on the hand-written file."""
    path.write_text(json.dumps(HAND_MIX))
    t0 = time.perf_counter()
    policy, calib, info = resolve_policy(
        cfg, params, policy="auto", arch=cfg.name, policy_json=str(path),
        device=dev)
    qp, report = quantize_params(params, policy, calib=calib)
    torch.cuda.synchronize()
    counts = variant_counts(report, qp)
    print(f"[load] {path.name} loaded, recalibrated and packed in "
          f"{time.perf_counter() - t0:.1f}s: {counts} matmuls", flush=True)
    check(info is None, "an existing policy file must be loaded, not "
          "searched")
    check(counts == HAND_PER_FORWARD,
          f"hand-written layout: {counts}, expected {HAND_PER_FORWARD}")
    return qp


def _bytes_equal(torch, a, b) -> bool:
    return torch.equal(a.contiguous().view(torch.uint8),
                       b.contiguous().view(torch.uint8))


def phase_q8k(torch, PK, dev):
    """The Q8_K kernel against its plain version, on the card and on the
    CPU, byte for byte; returns the largest absolute difference of any
    output from the plain version on the card."""
    g = torch.Generator(device=dev).manual_seed(9)
    cases, worst = 0, 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for M in Q8K_MS:
            for K in Q8K_KS:
                x = (torch.randn(M, K, generator=g, device=dev) * 3).to(dtype)
                x[0, :256] = 0                  # zero super-blocks
                x[-1, -512:] = 0
                mask = torch.rand(M, generator=g, device=dev) < 0.7
                mask[0] = False                 # at least one masked row
                for valid in (None, mask):
                    got = PK.q8k_quantize_cuda(x, valid)
                    want = PK.q8k_quantize_plain(x, valid)
                    cpu = PK.q8k_quantize_plain(
                        x.cpu(), None if valid is None else valid.cpu())
                    torch.cuda.synchronize()
                    for k in ("qs", "d", "bsums"):
                        check(_bytes_equal(torch, got[k], want[k])
                              and _bytes_equal(torch, got[k].cpu(), cpu[k]),
                              f"q8k_quantize {dtype} M={M} K={K} mask="
                              f"{valid is not None}: {k} differs")
                        worst = max(worst, float(
                            (got[k].double() - want[k].double()).abs().max()))
                    if valid is not None:
                        check(not any(bool(got[k][~valid].any())
                                      for k in got),
                              "a masked row has a nonzero payload")
                    cases += 1
    print(f"[kernels] q8k_quantize: {cases} cases (M in {Q8K_MS}, K in "
          f"{Q8K_KS}, f32 and bf16, zero super-blocks, with and without a "
          f"row mask): card == plain on the card == plain on the CPU, byte "
          f"for byte; masked rows all zero", flush=True)
    return worst


def phase_any_n(torch, Q, PB, dev):
    """The dequant-matmul at N % 16 != 0; returns the max abs error (f32
    output) of the gpt2-paper head shape."""
    g = torch.Generator(device=dev).manual_seed(10)
    worst = 0.0
    cases = [("q2_k", GPT2_HEAD)] + [(v, (2048, 2056)) for v in PB.VARIANTS]
    for variant, (K, N) in cases:
        t = Q.quantize(variant, torch.randn(K, N, generator=g, device=dev)
                       / K ** 0.5)
        ld = t.data[next(iter(t.data))].stride(0)
        for M in (M_DECODE, 33):
            x = torch.randn(M, K, generator=g, device=dev).bfloat16()
            y = PB.bfp_matmul_cuda(x, t, out_dtype=torch.float32)
            ref = PB.bfp_matmul_plain(x, t, out_dtype=torch.float32)
            yb = PB.bfp_matmul_cuda(x, t)
            rb = PB.bfp_matmul_plain(x, t)
            torch.cuda.synchronize()
            e32, e16 = rel_err(y, ref), rel_err(yb, rb)
            if (K, N) == GPT2_HEAD:
                worst = max(worst, float((y - ref).abs().max()))
            print(f"[kernels] {variant} M={M:2d} K={K} N={N} (row stride "
                  f"{ld}): f32 rel {e32:.2e} (tol {TOL_F32:.0e}), bf16 rel "
                  f"{e16:.2e} (tol {TOL_BF16:.2e})", flush=True)
            check(y.shape == (M, N) and bool(torch.isfinite(y).all()),
                  "bad output")
            check(e32 <= TOL_F32, f"{variant} {M}x{K}x{N} f32 error")
            check(e16 <= TOL_BF16, f"{variant} {M}x{K}x{N} bf16 error")
        row_ok = torch.equal(PB.bfp_matmul_cuda(x, t)[0],
                             PB.bfp_matmul_cuda(x[:1], t)[0])
        check(row_ok, f"{variant} N={N}: a row depends on M")
    print("[kernels] any N: row 0 of M=33 == M=1 bit for bit: True",
          flush=True)
    return worst


def phase_integer(torch, cfg, qp, isa, PK, ops, ref, Q, model_matmuls, dev,
                  tag):
    """Every MatMul of the packed model through the ISA driver and
    simulator at M = 4 (the main path of the integer datapath), the Q8_K
    kernel's count zeroed just before and read just after; then each
    result against the integer oracle and that against the dequantized
    product."""
    mats = []
    layer = {}
    for path, K, N in model_matmuls(cfg):
        node = qp
        for part in path.split("/"):
            node = node[part]
        i = layer[path] = layer.get(path, -1) + 1
        mats.append((path, node.layer(i) if path != "lm_head" else node))
    g = torch.Generator(device=dev).manual_seed(8)
    xs = [torch.randn(M_INT, t.shape[0], generator=g, device=dev)
          for _, t in mats]
    torch.cuda.synchronize()
    PK.reset_launches()
    t0 = time.perf_counter()
    runs = [isa.run_matmul(x, t, device=dev) for x, (_, t) in zip(xs, mats)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = PK.launches["q8k_quantize"]
    schedules = sum(st.schedules for _, st in runs)
    total = isa.SimStats()
    for _, st in runs:
        for f in ("weight_bytes", "input_bytes", "output_bytes",
                  "schedules"):
            setattr(total, f, getattr(total, f) + getattr(st, f))
    print(f"[{tag}] {cfg.name}: {len(mats)} MatMuls at M={M_INT} through "
          f"the ISA simulator in {wall:.2f}s: {schedules} SCHEDULEs, "
          f"q8k_quantize launches {launches}; traffic model per forward: "
          f"weights {total.weight_bytes} + inputs {total.input_bytes} + "
          f"outputs {total.output_bytes} = {total.total_stream_bytes} "
          f"bytes", flush=True)
    want = INT_SCHEDULES[cfg.name]
    check(schedules == want and launches == want,
          f"{cfg.name}: expected {want} SCHEDULEs, one q8k_quantize launch "
          f"each; got {schedules} SCHEDULEs and {launches} launches")
    e_sim = e_int = 0.0
    for x, (path, t), (out, _) in zip(xs, mats, runs):
        qx = ops.q8k_quantize(x)
        oi = ref.matmul_q8k_ref(qx, t)
        od = ref.matmul_ref(Q.dequantize_q8_k(qx), t)
        check(out.shape == (M_INT, t.shape[1])
              and bool(torch.isfinite(out).all()), f"{path}: bad output")
        e_sim = max(e_sim, rel_err(out, oi))
        e_int = max(e_int, rel_err(oi, od))
    print(f"[{tag}] {cfg.name}: simulator vs matmul_q8k_ref rel {e_sim:.2e}"
          f", integer vs dequantized product rel {e_int:.2e} (tol "
          f"{TOL_INT:.0e})", flush=True)
    check(e_sim <= TOL_INT, f"{cfg.name}: simulator disagrees with the "
          "integer oracle")
    check(e_int <= TOL_INT, f"{cfg.name}: integer datapath disagrees with "
          "the dequantized product")
    # what the SCHEDULEs quantized: at M = 4 every plan loads the whole
    # input once and takes K in one tile, so each quantizes its (4, K) x
    sched_inputs = []
    for x, (_, t), (_, st) in zip(xs, mats, runs):
        plan = isa.plan_tiling(M_INT, *t.shape, t.variant)
        check(plan.whole_input and plan.tile_k == t.shape[0],
              f"{t.variant} {t.shape}: the plan splits K or the input")
        sched_inputs += [x] * st.schedules
    return dict(launches=launches, schedules=schedules, wall_s=wall,
                matmuls=len(mats), weight_bytes=total.weight_bytes,
                input_bytes=total.input_bytes,
                output_bytes=total.output_bytes,
                total_stream_bytes=total.total_stream_bytes,
                max_rel_err=max(e_sim, e_int)), sched_inputs


def phase_q8k_timing(torch, PK, sched_inputs, dev):
    """The Q8_K kernel's launches of one tinyllama integer-path forward
    (each SCHEDULE quantizes its (4, K) input) and one launch at
    (4096, 5632), beside the bound and the plain version. No single
    PyTorch call computes Q8_K, so there is no library time."""
    g = torch.Generator(device=dev).manual_seed(11)
    big = torch.randn(*Q8K_BIG, generator=g, device=dev)
    res = {}
    for name, xs in (("forward", sched_inputs), ("single", [big])):
        # the forward's 1,665 launches are timed in groups, each behind its
        # own spin kernel, and summed: a stream queues about a thousand
        # launches, and past that the host waits on the device, so one
        # group of them all would time the host's launch rate
        kern = sum(_device_ms(torch, lambda c=c: [PK.q8k_quantize_cuda(x)
                                                  for x in c], 10)
                   for c in _groups(xs, Q8K_GROUP))
        plain = sum(_device_ms(torch, lambda c=c: [PK.q8k_quantize_plain(x)
                                                   for x in c], 3)
                    for c in _groups(xs, Q8K_GROUP_PLAIN))
        values = sum(x.numel() for x in xs)
        nbytes = values * Q8K_BYTES_PER_VALUE
        # abs, max, multiply, round and clamp: ~5 f32 operations a value
        res[name] = _timing(kern, plain, None, nbytes, values * 5, len(xs),
                            peak=F32_FLOPS_PER_S)
        print(f"[timing4] q8k_quantize {name} ({len(xs)} launches, "
              f"{values} values): kernel {kern:.4f} ms, bound "
              f"{res[name]['bound_ms']:.4f} ms ({res[name]['bound_by']}, "
              f"{nbytes / 1e6:.3f} MB), plain {plain:.4f} ms; no single "
              f"PyTorch call computes Q8_K (no library time)", flush=True)
    return res


def _groups(xs, n):
    return [xs[i:i + n] for i in range(0, len(xs), n)]


def _packed(tree):
    """The packed weights (QTensors) of a parameter tree."""
    for v in tree.values():
        if isinstance(v, dict):
            yield from _packed(v)
        elif hasattr(v, "variant"):
            yield v


def _kernel_weights(qp, cfg, uses=False):
    """(variant, K, N) -> every packed weight of that shape that the
    matmul kernel serves, one a layer; the MoE expert stacks, which no
    kernel serves, are left out. zamba2's shared block is one weight each,
    or with ``uses`` one each an application: a forward's launches."""
    groups = {}
    layers = {k: v for k, v in qp["layers"].items() if k != "moe"}
    for t in _packed(layers):
        groups.setdefault((t.variant, *t.shape), []).extend(
            t.layer(i) for i in range(cfg.n_layers))
    # one application after each full group of hybrid_attn_every layers
    apps = (cfg.n_layers // cfg.hybrid_attn_every
            if uses and cfg.family == "hybrid" else 1)
    for t in _packed(qp.get("shared", {})):
        groups.setdefault((t.variant, *t.shape), []).extend([t] * apps)
    if hasattr(qp.get("lm_head"), "variant"):
        t = qp["lm_head"]
        groups.setdefault((t.variant, *t.shape), []).append(t)
    return groups


# (arch, variant, K, N) -> (weights checked, largest f32 abs error) of
# every full-width model packed, filled by check_shapes
PACKED_CHECKED = {}


def check_shapes(torch, qp, cfg, PB, dev):
    """Each weight of ``_kernel_weights`` through the kernel against its
    plain version at M = max_slots, f32 and bf16 out, at phase 2's
    tolerances; one line a (variant, K, N)."""
    g = torch.Generator(device=dev).manual_seed(13)
    for (variant, K, N), ts in sorted(_kernel_weights(qp, cfg).items()):
        x = torch.randn(M_DECODE, K, generator=g, device=dev).bfloat16()
        e32 = e16 = worst = 0.0
        for t in ts:
            y = PB.bfp_matmul_cuda(x, t, out_dtype=torch.float32)
            ref = PB.bfp_matmul_plain(x, t, out_dtype=torch.float32)
            check(bool(torch.isfinite(y).all()),
                  f"{cfg.name} {variant} ({K}, {N}): non-finite output")
            e32 = max(e32, rel_err(y, ref))
            worst = max(worst, float((y - ref).abs().max()))
            e16 = max(e16, rel_err(PB.bfp_matmul_cuda(x, t),
                                   PB.bfp_matmul_plain(x, t)))
        PACKED_CHECKED[(cfg.name, variant, K, N)] = (len(ts), worst)
        print(f"[packed] {cfg.name} {variant} ({K}, {N}) x{len(ts)}, M="
              f"{M_DECODE}: kernel vs plain f32 rel {e32:.2e} (tol "
              f"{TOL_F32:.0e}), bf16 rel {e16:.2e} (tol {TOL_BF16:.2e})",
              flush=True)
        check(e32 <= TOL_F32, f"{cfg.name} {variant} ({K}, {N}) f32 error")
        check(e16 <= TOL_BF16, f"{cfg.name} {variant} ({K}, {N}) bf16 "
              "error")


def phase_shape_timing(torch, qp, cfg, PB, Q, dev, tag):
    """One decode forward's launches (M = max_slots) of each packed
    (variant, K, N) of the model that the kernel serves, timed as phase 4
    times a variant's (each checked by ``check_shapes`` at packing)."""
    groups = _kernel_weights(qp, cfg, uses=True)
    g = torch.Generator(device=dev).manual_seed(14)
    out = {}
    for (variant, K, N), ts in sorted(groups.items()):
        x = torch.randn(M_DECODE, K, generator=g, device=dev).bfloat16()
        dense = [Q.dequantize(t, torch.bfloat16) for t in ts]
        kern = _device_ms(torch, lambda: [PB.bfp_matmul_cuda(x, t)
                                          for t in ts], 10)
        plain = _device_ms(torch, lambda: [PB.bfp_matmul_plain(x, t)
                                           for t in ts], 3)
        lib = _device_ms(torch, lambda: [torch.matmul(x, w)
                                         for w in dense], 10)
        del dense
        nbytes = sum(x.numel() * 2 + t.nbytes + M_DECODE * N * 2
                     for t in ts)
        flops = 2 * M_DECODE * K * N * len(ts)
        res = _timing(kern, plain, lib, nbytes, flops, len(ts))
        out.setdefault(variant, {})[f"{K}x{N}"] = res
        print(f"[{tag}] {cfg.name} {variant} ({K}, {N}) decode forward "
              f"({len(ts)} launches, M={M_DECODE}): kernel {kern:.4f} ms, "
              f"bound {res['bound_ms']:.4f} ms ({res['bound_by']}, "
              f"{nbytes / 1e6:.2f} MB; kernel at {res['bound_ms'] / kern:.1%}"
              f" of it), plain {plain:.3f} ms, torch.matmul on bf16 "
              f"{lib:.4f} ms (kernel / torch.matmul {kern / lib:.2f}x)",
              flush=True)
    return out


def phase_slice5(torch, np, get_arch, T, quantize_params, variant_counts,
                 get_policy, Engine, ServeConfig, PB, PA, Q, dev):
    """Phases 14-16: the rest of the dense family served at full width,
    temperature sampling, and a 4096-token forward through blockwise
    attention. Returns (matmul launches by path, attention launches by
    path, the per-shape timing of ``TIMED5``)."""
    launches, attn, timing = {}, {}, None
    keep = {}
    t_phase = time.perf_counter()
    for arch, per_forward in SLICE5_MODELS:
        cfg = get_arch(arch)
        qp = pack_full_width(torch, cfg, T, quantize_params, variant_counts,
                             get_policy, "paper_llama_mix", dev, per_forward,
                             PB)
        rng = np.random.default_rng(0)
        prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size,
                                                 PROMPT_LEN)]
                   for _ in range(N_REQUESTS)]
        launches[f"{arch}_serve"], _, _ = phase_serve(
            torch, cfg, qp, Engine, ServeConfig, PB, PA, T, dev,
            f"serve5 {arch}", SERVE, prompts, per_forward, 0)
        if arch == FUSED5:
            cfg2 = cfg.replace(attn_impl="fused")
            lens = rng.integers(PROMPT_RANGE2[0], PROMPT_RANGE2[1] + 1,
                                N_REQUESTS)
            prompts2 = [[int(t) for t in rng.integers(0, cfg.vocab_size, n)]
                        for n in lens]
            key = f"{arch}_fused_serve"
            launches[key], attn[key], _ = phase_serve(
                torch, cfg2, qp, Engine, ServeConfig, PB, PA, T, dev,
                f"serve5 {arch} fused", SERVE2, prompts2, per_forward,
                cfg.n_layers)
        if arch == TIMED5:
            timing = phase_shape_timing(torch, qp, cfg, PB, Q, dev,
                                        "timing5")
        if arch in (FUSED5, LONG5[0]):
            keep[arch] = (cfg, qp, prompts, per_forward)
        del qp
        torch.cuda.empty_cache()
    print(f"[serve5] phase 14 took {time.perf_counter() - t_phase:.1f}s",
          flush=True)

    t_phase = time.perf_counter()
    launches[f"{FUSED5}_temperature"] = phase_temperature(
        torch, *keep.pop(FUSED5), Engine, ServeConfig, PB, dev)
    print(f"[temp5] phase 15 took {time.perf_counter() - t_phase:.1f}s",
          flush=True)

    t_phase = time.perf_counter()
    launches[f"{LONG5[0]}_forward_seq_{LONG5[1]}"] = phase_long(
        torch, *keep.pop(LONG5[0]), T, PB, dev)
    print(f"[long5] phase 16 took {time.perf_counter() - t_phase:.1f}s",
          flush=True)
    torch.cuda.empty_cache()
    return launches, attn, timing


def phase_temperature(torch, cfg, qp, prompts, per_forward, Engine,
                      ServeConfig, PB, dev):
    """Path 1's traffic sampled at temperature 0.8 from seed 7, without
    and with an EOS id: run() against generate_reference (on max_slots
    prompts, all it takes), against prefill_batch=1 and against a second
    engine of the same seed; another seed must give other tokens. The
    launch counts are zeroed just before the first 8-request run and read
    just after."""
    def engine(**kw):
        return Engine(cfg, qp, ServeConfig(**{**SERVE, **TEMP5, **kw}),
                      device=dev)

    slots = SERVE["max_slots"]
    few = prompts[:slots]
    engine().generate(few)                      # warm-up
    torch.cuda.synchronize()
    launches = None
    eos = None
    for with_eos in (False, True):
        kw = {"eos_id": eos} if with_eos else {}
        eng = engine(**kw)
        if launches is None:
            PB.reset_launches()
            full = eng.generate(prompts)        # the main path
            torch.cuda.synchronize()
            launches = dict(PB.launches)
            fwd = eng.stats["forwards"]
            want = {v: per_forward.get(v, 0) * fwd for v in PB.VARIANTS}
            check(fwd > 0 and launches == want,
                  f"temperature: expected {per_forward} launches per "
                  f"forward, got {launches} over {fwd} forwards")
        else:
            full = eng.generate(prompts)
        check(engine(**kw).generate(prompts) == full,
              "temperature: the same seed gave other tokens")
        a = eng.generate(few)
        eos = a[0][2] if eos is None else eos
        ref = eng.generate_reference(few)
        single = engine(prefill_batch=1, **kw).generate(few)
        other = engine(seed=TEMP5["seed"] + 1, **kw).generate(few)
        greedy = Engine(cfg, qp, ServeConfig(**{**SERVE, **kw}),
                        device=dev).generate(few)
        print(f"[temp5] {cfg.name} T={TEMP5['temperature']} seed "
              f"{TEMP5['seed']} eos_id={kw.get('eos_id')}: run() {a}; "
              f"generate_reference equal {ref == a}, prefill_batch=1 "
              f"equal {single == a}, seed {TEMP5['seed'] + 1} differs "
              f"{other != a}, greedy differs {greedy != a}", flush=True)
        check(ref == a, "temperature: run() != generate_reference")
        check(single == a, "temperature: prefill_batch=1 gave other tokens")
        check(other != a, "temperature: another seed gave the same tokens")
        check(greedy != a, "temperature: sampling gave the greedy tokens")
        check(all(0 <= x < cfg.vocab_size for t in full for x in t),
              "temperature: token out of vocabulary")
        if with_eos:
            check(len(a[0]) <= 3 and a[0][-1] == eos,
                  f"temperature: eos_id={eos} did not end request 0 at "
                  f"its third step: {a[0]}")
    return launches


def phase_long(torch, cfg, qp, prompts, per_forward, T, PB, dev):
    """forward_seq at B=1, S=4096 under "auto" (blockwise attention), the
    launch counts zeroed just before and read just after; its logits at
    the last positions against attn_impl="naive"."""
    _, S, n_last = LONG5
    g = torch.Generator(device=dev).manual_seed(16)
    toks = torch.randint(0, cfg.vocab_size, (1, S), generator=g, device=dev)
    check(cfg.attn_impl == "auto" and S > T.NAIVE_MAX_SEQ,
          "the long forward must take blockwise under auto")
    torch.cuda.synchronize()
    PB.reset_launches()
    t0 = time.perf_counter()
    logits = T.forward_seq(qp, cfg, tokens=toks)[0, -n_last:]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(PB.launches)
    check(launches == {v: per_forward.get(v, 0) for v in PB.VARIANTS},
          f"long forward: expected {per_forward} launches, got {launches}")
    t0 = time.perf_counter()
    naive = T.forward_seq(qp, cfg.replace(attn_impl="naive"),
                          tokens=toks)[0, -n_last:]
    torch.cuda.synchronize()
    dt_naive = time.perf_counter() - t0
    err = rel_err(logits, naive)
    same = int((logits.argmax(-1) == naive.argmax(-1)).sum())
    print(f"[long5] {cfg.name} forward_seq B=1 S={S} (blockwise, q/kv "
          f"chunks {cfg.attn_q_chunk}/{cfg.attn_kv_chunk}) in {dt:.3f}s, "
          f"naive {dt_naive:.3f}s; logits at the last {n_last} positions: "
          f"rel {err:.2e} (tol {TOL_LONG:.2e}), argmax equal at {same}/"
          f"{n_last}; launches {launches}", flush=True)
    check(bool(torch.isfinite(logits).all()), "long forward: non-finite")
    check(err <= TOL_LONG, "long forward: blockwise disagrees with naive")
    return launches


def _engine_rates(s):
    return (f"prefill {s['prefill_tok_per_s']:.1f} tok/s, decode "
            f"{s['tok_per_s']:.1f} tok/s")


def _served(torch, eng, prompts, PB, reset=None, warm=True):
    """A warm-up (unless ``warm`` is False), then ``eng.generate(prompts)``
    with the matmul launch counts (and ``reset``, if given) zeroed just
    before and read just after: (tokens, stats, launches, wall s)."""
    if warm:
        eng.generate(prompts[:eng.scfg.max_slots])
    torch.cuda.synchronize()
    PB.reset_launches()
    if reset is not None:
        reset()
    t0 = time.perf_counter()
    res = eng.generate(prompts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return res, dict(eng.stats), dict(PB.launches), wall


def _check_launches(tag, PB, launches, stats, per_forward, per_draft=None):
    """Every forward (prefill chunk, decode step, scan-verify column or
    batched-verify round) launches ``per_forward`` matmul kernels a
    variant, every truncated draft step ``per_draft``."""
    fwd, dfwd = stats["forwards"], stats["draft_forwards"]
    want = {v: per_forward.get(v, 0) * fwd
            + (per_draft or {}).get(v, 0) * dfwd for v in PB.VARIANTS}
    print(f"[{tag}] kernel launches: {launches} over {fwd} forwards and "
          f"{dfwd} draft steps", flush=True)
    check(fwd > 0 and launches == want,
          f"{tag}: expected {per_forward} launches a forward and "
          f"{per_draft} a draft step, got {launches} over {fwd} forwards "
          f"and {dfwd} draft steps")


def phase_kv8(torch, cfg, qp, prompts, T, Engine, ServeConfig, PB, PA,
              dev):
    """Phase 17: path 1's traffic on an int8 KV ring; returns (launches,
    tokens, rates)."""
    t_phase = time.perf_counter()
    g = torch.Generator().manual_seed(17)
    for dtype in (torch.float32, torch.bfloat16):
        x = (torch.randn(4, 4, 64, generator=g) * 3).to(dtype)
        x[1, 2] = 0                                 # an all-zero row
        q_cpu, s_cpu = T._quantize_kv(x)
        q_gpu, s_gpu = T._quantize_kv(x.to(dev))
        same = (_bytes_equal(torch, q_gpu.cpu(), q_cpu)
                and _bytes_equal(torch, s_gpu.cpu(), s_cpu))
        print(f"[kv8] _quantize_kv {tuple(x.shape)} {dtype} on the card == "
              f"the CPU byte for byte: {same}", flush=True)
        check(same, f"_quantize_kv on the card differs from the CPU "
                    f"({dtype})")
    cfg8 = cfg.replace(kv_cache_quant=True)
    launches, _, s8 = phase_serve(
        torch, cfg8, qp, Engine, ServeConfig, PB, PA, T, dev, "kv8", SERVE,
        prompts, KV8_PER_FORWARD, 0)
    tokens = Engine(cfg8, qp, ServeConfig(**SERVE), device=dev).generate(
        prompts)
    eng = Engine(cfg, qp, ServeConfig(**SERVE), device=dev)
    _, sb, _, _ = _served(torch, eng, prompts, PB)
    rates = {"int8": {"prefill_tok_per_s": s8["prefill_tok_per_s"],
                      "decode_tok_per_s": s8["tok_per_s"]},
             "bf16": {"prefill_tok_per_s": sb["prefill_tok_per_s"],
                      "decode_tok_per_s": sb["tok_per_s"]}}
    print(f"[kv8] int8 ring: {_engine_rates(s8)}; bf16 ring: "
          f"{_engine_rates(sb)} (host clocks)", flush=True)
    print(f"[kv8] phase 17 took {time.perf_counter() - t_phase:.1f}s",
          flush=True)
    return launches, tokens, rates


def chunk_attn_timing(torch, PA, eng, prompts, n_layers, tag, what):
    """Record the attention launches of ``eng.generate`` on the first
    ``max_slots`` prompts, hold the first chunk forward's ``n_layers``
    against the plain version on visible rows, and time them beside their
    bound and ``scaled_dot_product_attention``."""
    jobs = []
    orig = PA.prefill_attn_cuda

    def record(*a, **kw):
        jobs.append((a, kw))
        return orig(*a, **kw)
    PA.prefill_attn_cuda = record
    try:
        eng.generate(prompts[:eng.scfg.max_slots])
    finally:
        PA.prefill_attn_cuda = orig
    torch.cuda.synchronize()
    chunk = jobs[:n_layers]
    worst = 0.0
    for (q, k, v, qp_, kp), kw in chunk:
        y = orig(q, k, v, qp_, kp, **kw)
        ref = PA.prefill_attn_plain(q, k, v, qp_, kp, **kw)
        vis = visible_rows(qp_, kp, kw.get("window")).any(-1)
        worst = max(worst, rel_err(y[vis], ref[vis]))
    (q, k, v, qp_, kp), _ = chunk[0]
    print(f"[{tag}] {what} attention {tuple(q.shape)} x T={k.shape[1]} "
          f"KH={k.shape[2]} {q.dtype} ({int((kp[0] >= 0).sum())} ring keys "
          f"visible to row 0): kernel vs plain rel {worst:.2e} (tol "
          f"{TOL_BF16:.1e})", flush=True)
    check(worst <= TOL_BF16, f"prefill_attn on a {what} disagrees")
    kern = _device_ms(torch, lambda: [orig(*a, **kw) for a, kw in chunk],
                      10)
    plain = _device_ms(torch, lambda: [PA.prefill_attn_plain(*a, **kw)
                                       for a, kw in chunk], 3)
    lib = _sdpa_ms(torch, [a for a, _ in chunk])
    nbytes = sum(2 * a[0].numel() * a[0].element_size()
                 + (a[3].numel() + a[4].numel()) * a[4].element_size()
                 + 2 * int(visible_rows(a[3], a[4], None).any(1).sum())
                 * a[1].shape[2] * a[1].shape[3] * a[1].element_size()
                 for a, _ in chunk)
    pairs = sum(int(visible_rows(a[3], a[4], None).sum()) for a, _ in chunk)
    flops = pairs * q.shape[2] * 4 * q.shape[3]
    timing = _timing(kern, plain, lib, nbytes, flops, len(chunk))
    print(f"[{tag}] prefill_attn {what} forward ({len(chunk)} launches): "
          f"kernel {kern:.3f} ms, bound {timing['bound_ms']:.4f} ms "
          f"({timing['bound_by']}, {nbytes / 1e6:.1f} MB, "
          f"{flops / 1e9:.2f} GFLOP), plain {plain:.3f} ms, "
          f"scaled_dot_product_attention {lib:.3f} ms; x lib "
          f"{kern / lib:.2f}", flush=True)
    timing["max_rel_err"] = worst
    return timing


def phase_prefix(torch, np, cfg, qp, Engine, ServeConfig, PB, PA, dev,
                 per_forward=EXTENDED_PER_FORWARD, scfg=SERVE_PREFIX,
                 capacity=PREFIX_CAPACITY, tag="prefix", phase="18",
                 warm=True):
    """Phase 18 (phase 22 on olmoe): a shared-prefix queue with the fused
    attention, cache off (after a warm-up run unless ``warm`` is False),
    then on twice; every forward launches ``per_forward`` matmul kernels;
    the warm chunks' attention launches held against the plain version
    and timed. Returns (matmul launches, attention launches, stats,
    attention timing)."""
    t_phase = time.perf_counter()
    rng = np.random.default_rng(18)
    shared = [int(t) for t in rng.integers(0, cfg.vocab_size, SHARED_PREFIX)]
    prompts = [shared + [int(t) for t in rng.integers(
        0, cfg.vocab_size, int(n))]
        for n in rng.integers(SUFFIX_RANGE[0], SUFFIX_RANGE[1] + 1,
                              N_REQUESTS)]
    off = Engine(cfg, qp, ServeConfig(**scfg), device=dev)
    res_off, s_off, _, _ = _served(torch, off, prompts, PB, warm=warm)
    on = Engine(cfg, qp, ServeConfig(**scfg, prefix_cache=True),
                device=dev)
    check(on._prefix.capacity == capacity,
          f"page pool of {on._prefix.capacity} pages, expected {capacity}")
    runs = []
    launches, attn = {v: 0 for v in PB.VARIANTS}, 0
    for i in range(2):
        PB.reset_launches()
        PA.reset_launches()
        torch.cuda.synchronize()
        res = on.generate(prompts)
        torch.cuda.synchronize()
        s = dict(on.stats)
        runs.append((res, s))
        lw, aw = dict(PB.launches), PA.launches["prefill_attn"]
        _check_launches(f"{tag} run {i + 1}", PB, lw, s, per_forward)
        check(aw == cfg.n_layers * s["prefill_forwards"],
              f"{tag} run {i + 1}: {aw} attention launches over "
              f"{s['prefill_forwards']} prefill-chunk forwards")
        launches = {v: launches[v] + lw[v] for v in PB.VARIANTS}
        attn += aw
        print(f"[{tag}] run {i + 1}: {_engine_rates(s)}, "
              f"prefix_hits {s['prefix_hits']}, prefix_tokens_reused "
              f"{s['prefix_tokens_reused']} of {s['prefill_tokens']} prompt "
              f"tokens, {s['prefill_forwards']} prefill-chunk forwards, "
              f"evictions {s['prefix_evictions']}, insert drops "
              f"{s['prefix_insert_drops']}", flush=True)
    print(f"[{tag}] cache off: {_engine_rates(s_off)}, "
          f"{s_off['prefill_forwards']} prefill-chunk forwards", flush=True)
    check(runs[0][0] == res_off and runs[1][0] == res_off,
          f"{tag}: tokens differ from the cache-off engine")
    check(runs[0][1]["prefix_hits"] >= 4 and runs[1][1]["prefix_hits"] == 8,
          f"{tag}: too few hits")
    check(all(len(t) == scfg["max_new_tokens"] for t in res_off),
          f"{tag}: a request did not get its tokens")

    # the warm chunks' attention: record one warm admission's launches,
    # hold each against the plain version, time the 22 of one chunk
    timing = chunk_attn_timing(torch, PA, on, prompts, cfg.n_layers,
                               tag, "warm chunk")
    stats = {"off": s_off, "cold": runs[0][1], "warm": runs[1][1]}
    print(f"[{tag}] phase {phase} took {time.perf_counter() - t_phase:.1f}s",
          flush=True)
    return launches, attn, stats, timing


def _margin_match(torch, T, qp, cfg, dev, refs, gots, prompts):
    """Token for token, or a divergence where the plain model's top-2
    logit margin predicting that token is below MARGIN_TOL (ROADMAP's
    parity contract); returns the number of accepted divergences."""
    ties = 0
    for prompt, ref, got in zip(prompts, refs, gots):
        t = next((i for i, (a, b) in enumerate(zip(ref, got)) if a != b),
                 None)
        if t is None:
            check(len(ref) == len(got), "verify: lengths differ")
            continue
        logits = T.forward_seq(qp, cfg, tokens=torch.tensor(
            [prompt + ref[:t]], device=dev))[0, -1]
        top = torch.topk(logits, 2).values
        margin = float(top[0] - top[1])
        check(margin < MARGIN_TOL, f"verify: divergence at token {t} with "
                                   f"margin {margin}")
        ties += 1
    return ties


def phase_spec(torch, cfg, qp, prompts, kv8_tokens, T, Engine, ServeConfig,
               PB, Q, ops, dev):
    """Phase 19: speculative decoding on path 1's weights; returns
    (launches by run, stats by run, verify-M timing)."""
    t_phase = time.perf_counter()
    plain_eng = Engine(cfg, qp, ServeConfig(**SERVE_SPEC), device=dev)
    ref, s_plain, _, _ = _served(torch, plain_eng, prompts, PB)
    print(f"[spec] plain: {_engine_rates(s_plain)}, "
          f"{s_plain['forwards']} forwards", flush=True)
    launches, stats = {}, {"plain": s_plain}
    S = SERVE_SPEC["draft_k"] + 1
    for name, kw in (("ngram_scan", dict(drafter="ngram")),
                     ("ngram_batched", dict(drafter="ngram",
                                            draft_verify="batched")),
                     ("self_scan", dict(drafter="self",
                                        draft_layers=DRAFT_LAYERS))):
        eng = Engine(cfg, qp, ServeConfig(**SERVE_SPEC, **kw), device=dev)
        ms = {}
        orig = ops.bfp_matmul_cuda

        def record(x, *a, **k):
            ms[x.shape[0]] = ms.get(x.shape[0], 0) + 1
            return orig(x, *a, **k)
        ops.bfp_matmul_cuda = record
        try:
            # the plain run above warmed the kernels and the allocator
            res, s, lw, wall = _served(torch, eng, prompts, PB,
                                       reset=ms.clear, warm=False)
        finally:
            ops.bfp_matmul_cuda = orig
        rounds = s["spec_rounds"]
        verify = s["forwards"] - s["prefill_forwards"]
        print(f"[spec] {name}: {_engine_rates(s)} (plain "
              f"{s_plain['tok_per_s']:.1f}), draft_tokens "
              f"{s['draft_tokens']}, draft_accepted {s['draft_accepted']} "
              f"(accept rate {s['accept_rate']:.1%}), spec_rounds {rounds}, "
              f"{verify} verify forwards, {s['draft_forwards']} draft "
              f"steps, {s['host_syncs']} host syncs, wall {wall:.3f}s; "
              f"matmul launches by M {dict(sorted(ms.items()))}", flush=True)
        _check_launches(f"spec {name}", PB, lw, s, KV8_PER_FORWARD,
                        SELF_PER_DRAFT if kw["drafter"] == "self" else None)
        check(rounds > 0 and s["draft_tokens"] > 0, f"{name}: no speculation")
        if kw.get("draft_verify") == "batched":
            check(verify == rounds, f"{name}: {verify} verify forwards over "
                                    f"{rounds} rounds")
            check(ms.get(M_VERIFY, 0) == sum(KV8_PER_FORWARD.values())
                  * rounds, f"{name}: {ms.get(M_VERIFY, 0)} launches at "
                            f"M={M_VERIFY} over {rounds} rounds")
            ties = _margin_match(torch, T, qp, cfg, dev, ref, res, prompts)
            print(f"[spec] {name}: tokens == plain but {ties} divergence(s) "
                  f"at a top-2 margin below {MARGIN_TOL}", flush=True)
        else:
            check(verify == S * rounds, f"{name}: {verify} verify columns "
                                        f"over {rounds} rounds")
            check(res == ref, f"{name}: tokens differ from plain decode")
            print(f"[spec] {name}: tokens == plain decode: True", flush=True)
        if kw["drafter"] == "self":
            check(s["draft_forwards"] == SERVE_SPEC["draft_k"] * rounds,
                  f"{name}: {s['draft_forwards']} draft steps over "
                  f"{rounds} rounds")
        launches[name], stats[name] = lw, s

    few = prompts[:SERVE_SPEC["max_slots"]]
    temp = Engine(cfg, qp, ServeConfig(**SERVE_SPEC, **TEMP5,
                                       drafter="ngram"), device=dev)
    a = temp.generate(few)
    b = temp.generate_spec_reference(few)
    print(f"[spec] ngram_scan T={TEMP5['temperature']} seed {TEMP5['seed']}:"
          f" run() {a}; generate_spec_reference equal {a == b}", flush=True)
    check(a == b, "spec temperature: run() != generate_spec_reference")
    check(a != ref[:len(few)], "spec temperature gave the greedy tokens")

    kv8 = Engine(cfg.replace(kv_cache_quant=True), qp,
                 ServeConfig(**SERVE, drafter="ngram",
                             draft_k=SERVE_SPEC["draft_k"]), device=dev)
    got = kv8.generate(prompts)
    print(f"[spec] int8 ring, ngram_scan on path 1's traffic: tokens == "
          f"phase 17's: {got == kv8_tokens} ({kv8.stats['spec_rounds']} "
          f"rounds)", flush=True)
    check(got == kv8_tokens, "int8 + ngram: tokens differ from phase 17's")
    timing = phase_timing(torch, qp, cfg, PB, Q, dev, "spec", ("q2_k",
                                                               "q3_k"),
                          M_VERIFY, big="verify", head_m=M_VERIFY,
                          decode=False)
    print(f"[spec] phase 19 took {time.perf_counter() - t_phase:.1f}s",
          flush=True)
    return launches, stats, timing


def phase_slo(torch, cfg, qp, prompts, Engine, ServeConfig,
              EngineSaturated, PB, dev):
    """Phase 20: four priority-0 requests fill the slots (two at a time:
    the queue holds two); a poll callback then submits a priority-1
    request, which preempts one of them, and, with the slots full again,
    two more priority-0 requests fill the queue and a third is rejected.
    Returns the launches."""
    t_phase = time.perf_counter()
    eng = Engine(cfg, qp, ServeConfig(**SERVE_SLO), device=dev)
    streamed, done, reasons = {}, {}, []
    on_token = lambda rid, tok: streamed.setdefault(rid, []).append(tok)
    on_done = lambda r: done.setdefault(r.id, []).append(
        (r.cancelled, r.preempted))
    submit = lambda p, **kw: eng.submit(p, on_token=on_token,
                                        on_done=on_done, **kw)
    low = [submit(p) for p in prompts[:2]]
    late, polls = [], [0]

    def poll():
        polls[0] += 1
        if polls[0] == 2:
            low.extend(submit(p) for p in prompts[2:4])
        if polls[0] in (3, 4):
            check(all(r is not None for r in eng._slots),
                  f"slo: the slots are not full at poll {polls[0]}")
        if polls[0] == 3:
            late.append(submit(prompts[4], priority=1))
        if polls[0] == 4:
            late.extend(submit(p) for p in prompts[5:7])
            try:
                submit(prompts[7])
            except EngineSaturated as e:
                reasons.append(e.reason)
    PB.reset_launches()
    t0 = time.perf_counter()
    res = eng.run(poll=poll)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    s = eng.stats
    pre = [rid for rid, d in done.items() if d[0][1]]
    budget = SERVE_SLO["max_new_tokens"]
    print(f"[slo] {len(res)} requests in {wall:.3f}s: preempted {pre}, "
          f"tokens {[len(res[r]) for r in low + late]}, preemptions "
          f"{s['preemptions']}, rejections {reasons}, on_done calls "
          f"{ {r: len(d) for r, d in done.items()} }", flush=True)
    check(pre == [low[-1]] and s["preemptions"] == 1,
          f"slo: expected request {low[-1]} preempted, got {pre}")
    check(res[pre[0]] == streamed[pre[0]] and 0 < len(res[pre[0]]) < budget,
          "slo: the preempted request lost its streamed tokens")
    check(all(len(d) == 1 for d in done.values())
          and sorted(done) == sorted(low + late),
          "slo: on_done did not fire once per request")
    check(len(res[late[0]]) == budget and not done[late[0]][0][0],
          "slo: the priority-1 request did not complete")
    check(all(len(res[r]) == budget for r in low[:3] + late[1:]),
          "slo: a request lost tokens")
    check(reasons == ["queue_full"], f"slo: rejections {reasons}")
    launches = dict(PB.launches)
    _check_launches("slo", PB, launches, s, KV8_PER_FORWARD)
    print(f"[slo] phase 20 took {time.perf_counter() - t_phase:.1f}s",
          flush=True)
    return launches


def count_drops(torch, PM, T):
    """Wrap ``T.prefill_chunk`` and ``PM.dispatch`` to count, on the device
    with no host sync, the valid token choices (padding columns left out)
    that prefill chunks route and drop. Returns (counters, restore)."""
    orig_chunk, orig_dispatch = T.prefill_chunk, PM.dispatch
    acc = {"calls": 0, "valid": None, "choices": 0, "dropped": 0}

    def chunk(params, cfg, cache, *, tokens, start, lengths):
        C = tokens.shape[1]
        pos = start + torch.arange(C, device=tokens.device)
        acc["valid"] = pos[None] < lengths[:, None]
        try:
            return orig_chunk(params, cfg, cache, tokens=tokens, start=start,
                              lengths=lengths)
        finally:
            acc["valid"] = None

    def dispatch(topi, E, C):
        e, slot, keep = orig_dispatch(topi, E, C)
        if acc["valid"] is not None:
            v = acc["valid"][..., None].expand(topi.shape).reshape(
                keep.shape)
            acc["calls"] += 1
            acc["choices"] = acc["choices"] + v.sum()
            acc["dropped"] = acc["dropped"] + (v & ~keep).sum()
        return e, slot, keep
    T.prefill_chunk, PM.dispatch = chunk, dispatch

    def restore():
        T.prefill_chunk, PM.dispatch = orig_chunk, orig_dispatch
    return acc, restore


def phase_moe_block(torch, cfg, qp, PM, T, dev):
    """Layer 0's moe_block on the card against the same call on the CPU
    (the packed layer moved there), at path 1's prefill-chunk shape."""
    lp = T._layer(qp["layers"], 0)["moe"]
    cpu = {k: v.to("cpu") for k, v in lp.items()}
    g = torch.Generator().manual_seed(21)
    x = torch.randn(SERVE["prefill_batch"], SERVE["prefill_chunk"],
                    cfg.d_model, generator=g).bfloat16()
    y, aux = PM.moe_block(x.to(dev), lp, cfg)
    y_cpu, aux_cpu = PM.moe_block(x, cpu, cfg)
    err = rel_err(y.cpu(), y_cpu)
    print(f"[moe] {cfg.name} layer-0 moe_block {tuple(x.shape)} bf16, card "
          f"vs CPU: rel {err:.2e} (tol {TOL_MOE:.1e}), aux {float(aux):.6f}"
          f" vs {float(aux_cpu):.6f}", flush=True)
    check(err <= TOL_MOE and bool(torch.isfinite(y).all()),
          f"{cfg.name}: moe_block on the card disagrees with the CPU")
    check(abs(float(aux) - float(aux_cpu)) <= 1e-5 * abs(float(aux_cpu)),
          f"{cfg.name}: moe_block aux loss disagrees with the CPU")
    return err


def phase_expert_timing(torch, cfg, qp, PM, T, dev, tag):
    """One decode forward's expert path (B = max_slots, S = 1): every
    layer's three stacks dequantized to bf16, the bmm products (with the
    bf16 silu) on one layer's dequantized stacks at the dispatch shape
    (each layer streams its own 3 stacks from HBM, so one layer's stand
    for every layer's bytes), and ``moe_block`` whole, by CUDA events."""
    moe = qp["layers"]["moe"]
    E, L, B = cfg.n_experts, cfg.n_layers, M_DECODE
    names = ("w_gate", "w_up", "w_down")

    lps = [T._layer(moe, i) for i in range(L)]

    def dequant():
        for lp in lps:
            for n in names:
                PM.expert_weights(lp[n], E)
    deq = _device_ms(torch, dequant, 3)
    wg, wu, wd = (PM.expert_weights(lps[0][n], E) for n in names)
    C = PM._capacity(1, cfg.n_experts_active, E, cfg.capacity_factor)
    g = torch.Generator(device=dev).manual_seed(22)
    bufs = torch.randn(B, E, C, cfg.d_model, generator=g,
                       device=dev).bfloat16()

    def products():
        for _ in range(L):
            for b in range(B):
                hg = torch.bmm(bufs[b], wg)
                hu = torch.bmm(bufs[b], wu)
                torch.bmm(PM._silu_bf16(hg) * hu, wd)
    prod = _device_ms(torch, products, 10)
    del wg, wu, wd
    x = torch.randn(B, 1, cfg.d_model, generator=g, device=dev).bfloat16()
    whole = _device_ms(torch, lambda: [PM.moe_block(x, lp, cfg)
                                       for lp in lps], 3)
    packed = sum(getattr(moe[n], "nbytes", 0) for n in names)
    out = {"dequantize_ms": deq, "products_ms": prod, "moe_block_ms": whole,
           "packed_expert_bytes": packed,
           "dequantized_bf16_bytes": 3 * L * E * cfg.d_model
           * cfg.moe_d_ff * 2}
    print(f"[{tag}] {cfg.name} expert path a decode forward (B={B}, C={C},"
          f" {L} layers): dequantize {deq:.3f} ms ({packed / 1e9:.2f} GB "
          f"packed -> {out['dequantized_bf16_bytes'] / 1e9:.2f} GB bf16), "
          f"bmm products {prod:.3f} ms, moe_block whole {whole:.3f} ms",
          flush=True)
    return out


def phase_slice7(torch, np, get_arch, T, quantize_params, variant_counts,
                 get_policy, Engine, ServeConfig, PB, PA, PM, Q, dev):
    """Phases 21-23: the MoE family at full width. Returns (matmul
    launches by path, attention launches by path, per-shape matmul timing
    by arch, results for the summary line)."""
    launches, attn, timing, out = {}, {}, {}, {}
    for arch, counts, per_forward in MOE_MODELS:
        t_phase = time.perf_counter()
        cfg = get_arch(arch)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        qp = pack_full_width(torch, cfg, T, quantize_params, variant_counts,
                             get_policy, MOE_POLICY, dev, counts, PB)
        rng = np.random.default_rng(0)
        prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size,
                                                 PROMPT_LEN)]
                   for _ in range(N_REQUESTS)]
        key = f"{arch}_serve"
        t0 = time.perf_counter()
        launches[key], _, s = phase_serve(
            torch, cfg, qp, Engine, ServeConfig, PB, PA, T, dev,
            f"moe {arch}", SERVE, prompts, per_forward, 0)
        res = {"serve_wall_s": time.perf_counter() - t0,
               "prefill_tok_per_s": s["prefill_tok_per_s"],
               "decode_tok_per_s": s["tok_per_s"],
               "forwards": s["forwards"]}
        if arch == MOE_FUSED:
            one = Engine(cfg, qp, ServeConfig(**dict(SERVE, prefill_batch=1)),
                         device=dev).generate(prompts)
            batched = Engine(cfg, qp, ServeConfig(**SERVE),
                             device=dev).generate(prompts)
            print(f"[moe] {arch} prefill_batch=4 tokens == prefill_batch=1 "
                  f"tokens: {batched == one}", flush=True)
            check(batched == one, f"{arch}: prefill_batch=4 and 1 differ")
            res["moe_block_card_vs_cpu"] = phase_moe_block(torch, cfg, qp,
                                                           PM, T, dev)
        res["peak_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
        print(f"[moe] {arch} peak torch.cuda.max_memory_allocated "
              f"{res['peak_allocated_gb']:.2f} GB (packing included)",
              flush=True)
        timing[arch] = phase_shape_timing(torch, qp, cfg, PB, Q, dev,
                                          "moe timing")
        res["expert_path"] = phase_expert_timing(torch, cfg, qp, PM, T, dev,
                                                 "moe timing")
        print(f"[moe] {arch} phase {21 if arch == MOE_FUSED else 23} took "
              f"{time.perf_counter() - t_phase:.1f}s", flush=True)
        if arch == MOE_FUSED:
            t_phase = time.perf_counter()
            cfg2 = cfg.replace(attn_impl="fused")
            lens = rng.integers(PROMPT_RANGE2[0], PROMPT_RANGE2[1] + 1,
                                N_REQUESTS)
            prompts2 = [[int(t) for t in rng.integers(0, cfg.vocab_size, n)]
                        for n in lens]
            key = f"{arch}_fused_serve"
            drops, restore = count_drops(torch, PM, T)
            try:
                t0 = time.perf_counter()
                launches[key], attn[key], s2 = phase_serve(
                    torch, cfg2, qp, Engine, ServeConfig, PB, PA, T, dev,
                    f"moe {arch} fused", SERVE2, prompts2, per_forward,
                    cfg.n_layers)
                wall = time.perf_counter() - t0
            finally:
                restore()
            chunk_fwds = max(drops["calls"] / cfg.n_layers, 1)
            per_chunk = int(drops["dropped"]) / chunk_fwds
            cap = PM._capacity(SERVE2["prefill_chunk"],
                               cfg.n_experts_active, cfg.n_experts,
                               cfg.capacity_factor)
            print(f"[moe] {arch} fused: {per_chunk:.1f} of "
                  f"{int(drops['choices']) / chunk_fwds:.0f} valid token "
                  f"choices dropped a chunk forward, all layers (capacity "
                  f"{cap} a expert a row; {chunk_fwds:.0f} chunk forwards)",
                  flush=True)
            check(per_chunk > 0, f"{arch}: no token choice was dropped")
            key = f"{arch}_prefix_cache"
            (launches[key], attn[key], prefix_stats,
             attn_timing) = phase_prefix(
                torch, np, cfg2, qp, Engine, ServeConfig, PB, PA, dev,
                per_forward=per_forward, scfg=SERVE_PREFIX_MOE,
                capacity=PREFIX_CAPACITY_MOE, tag="moe prefix", phase="22",
                warm=False)     # the model ran path 2's traffic just now
            out["fused"] = {
                "serve_wall_s": wall,
                "prefill_tok_per_s": s2["prefill_tok_per_s"],
                "decode_tok_per_s": s2["tok_per_s"],
                "dropped_choices_per_chunk_forward": per_chunk,
                "prefix": prefix_stats, "warm_attn_timing": attn_timing}
            print(f"[moe] {arch} fused phase 22 took "
                  f"{time.perf_counter() - t_phase:.1f}s", flush=True)
        out[arch] = res
        del qp
        torch.cuda.empty_cache()
    return launches, attn, timing, out


def phase_ssm_layer(torch, cfg, qp, M2, T, dev):
    """Layer 0's mamba2_forward on the card against the same call on the
    CPU (the packed layer moved there), at a prefill chunk's shape with a
    carried state and a short row."""
    lp = T._layer(qp["layers"], 0)["ssm"]
    cpu = {k: v.to("cpu") for k, v in lp.items()}
    dd = M2.ssm_dims(cfg)
    g = torch.Generator().manual_seed(24)
    B, C = SERVE2["prefill_batch"], SERVE2["prefill_chunk"]
    x = torch.randn(B, C, cfg.d_model, generator=g).bfloat16()
    conv = torch.randn(B, cfg.ssm_conv_width - 1, dd["conv_ch"],
                       generator=g).bfloat16()
    state = 0.1 * torch.randn(B, dd["n_heads"], dd["head_dim"], dd["state"],
                              generator=g)
    valid = torch.arange(C)[None] < torch.tensor([C, C, 77, C])[:, None]
    args = dict(conv_state=conv, ssm_state=state, valid=valid)
    y, (c1, s1) = M2.mamba2_forward(
        x.to(dev), lp, cfg, **{k: v.to(dev) for k, v in args.items()})
    y_cpu, (c_cpu, s_cpu) = M2.mamba2_forward(x, cpu, cfg, **args)
    keep = valid[..., None]
    err = rel_err(torch.where(keep, y.cpu(), 0), torch.where(keep, y_cpu, 0))
    err_c = rel_err(c1.cpu(), c_cpu)
    err_s = rel_err(s1.cpu(), s_cpu)
    print(f"[recurrent] {cfg.name} layer-0 mamba2_forward {tuple(x.shape)} "
          f"bf16, card vs CPU: out rel {err:.2e}, conv tail rel {err_c:.2e}, "
          f"SSM state rel {err_s:.2e} (tol {TOL_SSM:.1e})", flush=True)
    check(max(err, err_c, err_s) <= TOL_SSM
          and bool(torch.isfinite(y).all()),
          f"{cfg.name}: mamba2_forward on the card disagrees with the CPU")
    return {"out": err, "conv": err_c, "state": err_s}


def _profile(torch, fn, n=8):
    """One call of ``fn`` under ``torch.profiler``: (device ms of all its
    kernels and copies, their count, the ``n`` names of most device time
    as [(name, launches, ms)]), or None where the profiler shows no
    device time (it is untried on this machine)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()

    def dev_us(e):
        return (getattr(e, "self_device_time_total", 0)
                or getattr(e, "self_cuda_time_total", 0))
    rows = sorted(prof.key_averages(), key=dev_us, reverse=True)
    total = sum(dev_us(e) for e in rows)
    if total <= 0:
        return None
    return (total / 1e3, sum(e.count for e in rows),
            [(e.key[:72], e.count, dev_us(e) / 1e3) for e in rows[:n]])


def phase_recurrent_breakdown(torch, cfg, qp, M2, T, PB, dev, tag):
    """Where one prefill-chunk forward (path 2's (4, 128)), one decode
    step (B = 4) and the SSD scans of one chunk forward (every layer's,
    alone) spend their time: the span between CUDA events behind a spin
    kernel (the stream holds about a thousand queued launches, so a call
    of more launches than that also counts host time), the device time
    of their kernels by ``torch.profiler``, and the matmul launches of
    the chunk and the step by CUDA events."""
    B, C = SERVE2["prefill_batch"], SERVE2["prefill_chunk"]
    dd = M2.ssm_dims(cfg)
    H, P, N = dd["n_heads"], dd["head_dim"], dd["state"]
    g = torch.Generator(device=dev).manual_seed(25)
    cache = T.init_cache(cfg, B, SERVE2["cache_len"], device=dev)
    toks = torch.randint(0, cfg.vocab_size, (B, C), generator=g, device=dev)
    lengths = torch.full((B,), C, device=dev)
    pos = torch.full((B,), C, device=dev)
    x = torch.randn(B, C, H, P, generator=g, device=dev)
    dt = torch.rand(B, C, H, generator=g, device=dev) * 0.1
    A = -torch.rand(H, generator=g, device=dev)
    Bm = torch.randn(B, C, N, generator=g, device=dev)
    Cm = torch.randn(B, C, N, generator=g, device=dev)
    s0 = torch.zeros(B, H, P, N, device=dev)
    calls = {
        "chunk": lambda: T.prefill_chunk(qp, cfg, cache, tokens=toks,
                                         start=0, lengths=lengths),
        "decode": lambda: T.decode_step(qp, cfg, cache, tokens=toks[:, 0],
                                        position=pos),
        "ssd_scan": lambda: [M2._ssd_chunk_scan(x, dt, A, Bm, Cm, s0,
                                                cfg.ssm_chunk)
                             for _ in range(cfg.n_layers)]}
    out = {}
    for what, fn in calls.items():
        out[f"{what}_event_ms"] = _device_ms(torch, fn, 3)
        prof = _profile(torch, fn)
        out[f"{what}_kernel_ms"], out[f"{what}_launches"], out[
            f"{what}_top_kernels"] = prof or (None, None, None)
    weights = _kernel_weights(qp, cfg, uses=True)
    for what, M in (("chunk", B * C), ("decode", B)):
        xs = {K: torch.randn(M, K, generator=g, device=dev).bfloat16()
              for (_, K, _) in weights}
        # the head runs on one row a sequence in a chunk forward
        out[f"{what}_matmul_ms"] = _device_ms(torch, lambda: [
            PB.bfp_matmul_cuda(xs[K][:B] if N_ == cfg.vocab_size else xs[K],
                               t)
            for (_, K, N_), ts in weights.items() for t in ts], 3)
    for what, name in (("chunk", "prefill-chunk forward (4, 128)"),
                       ("decode", "decode step (B=4)"),
                       ("ssd_scan", f"SSD scans of {cfg.n_layers} layers")):
        top = out[f"{what}_top_kernels"]
        print(f"[{tag}] {cfg.name} {name}: {out[what + '_event_ms']:.3f} ms "
              f"between CUDA events; kernels " + (
                  "not measured (the profiler shows no device time)"
                  if top is None else
                  f"{out[what + '_kernel_ms']:.3f} ms of device time in "
                  f"{out[what + '_launches']} launches (torch.profiler)")
              + (f", of it matmul kernels {out[what + '_matmul_ms']:.3f} ms "
                 "(CUDA events)" if what + "_matmul_ms" in out else "")
              + ("" if top is None else "; most device time: " + "; ".join(
                  f"{k} x{c} {ms:.3f} ms" for k, c, ms in top[:5])),
              flush=True)
    return out


def phase_recurrent_prefix(torch, np, cfg, qp, Engine, ServeConfig, PB,
                           dev, per_forward):
    """Phase 26: phase 18's shared-prefix queue on a recurrent model with
    a 1 GiB checkpoint pool (pages pinned to the 128-token chunk): cache
    off, then on twice; the same tokens, hits, and the warm and cold
    prefill rates. Returns (matmul launches, stats)."""
    t_phase = time.perf_counter()
    rng = np.random.default_rng(18)
    shared = [int(t) for t in rng.integers(0, cfg.vocab_size, SHARED_PREFIX)]
    prompts = [shared + [int(t) for t in rng.integers(
        0, cfg.vocab_size, int(n))]
        for n in rng.integers(SUFFIX_RANGE[0], SUFFIX_RANGE[1] + 1,
                              N_REQUESTS)]
    scfg = SERVE_PREFIX_REC
    off = Engine(cfg, qp, ServeConfig(**scfg), device=dev)
    res_off, s_off, _, _ = _served(torch, off, prompts, PB, warm=False)
    on = Engine(cfg, qp, ServeConfig(**scfg, prefix_cache=True), device=dev)
    check(on._page == scfg["prefill_chunk"]
          and on._prefix.capacity == PREFIX_CAPACITY_REC,
          f"checkpoint pool of {on._prefix.capacity} pages of {on._page}, "
          f"expected {PREFIX_CAPACITY_REC} of {scfg['prefill_chunk']}")
    runs, launches = [], {v: 0 for v in PB.VARIANTS}
    for i in range(2):
        res, s, lw, _ = _served(torch, on, prompts, PB, warm=False)
        runs.append((res, s))
        _check_launches(f"recurrent prefix run {i + 1}", PB, lw, s,
                        per_forward)
        launches = {v: launches[v] + lw[v] for v in PB.VARIANTS}
        print(f"[recurrent prefix] {cfg.name} run {i + 1}: "
              f"{_engine_rates(s)}, prefix_hits {s['prefix_hits']}, "
              f"prefix_tokens_reused {s['prefix_tokens_reused']} of "
              f"{s['prefill_tokens']} prompt tokens, "
              f"{s['prefill_forwards']} prefill-chunk forwards, evictions "
              f"{s['prefix_evictions']}, insert drops "
              f"{s['prefix_insert_drops']}", flush=True)
    print(f"[recurrent prefix] {cfg.name} cache off: {_engine_rates(s_off)}"
          f", {s_off['prefill_forwards']} prefill-chunk forwards",
          flush=True)
    check(runs[0][0] == res_off and runs[1][0] == res_off,
          f"{cfg.name}: checkpoint prefix cache tokens differ from off")
    check(runs[0][1]["prefix_hits"] >= 4 and runs[1][1]["prefix_hits"] == 8,
          f"{cfg.name}: too few checkpoint hits")
    check(all(len(t) == scfg["max_new_tokens"] for t in res_off),
          f"{cfg.name}: a request did not get its tokens")
    print(f"[recurrent prefix] {cfg.name} prefill tok/s: off "
          f"{s_off['prefill_tok_per_s']:.1f}, cold "
          f"{runs[0][1]['prefill_tok_per_s']:.1f}, warm "
          f"{runs[1][1]['prefill_tok_per_s']:.1f}; phase 26 took "
          f"{time.perf_counter() - t_phase:.1f}s", flush=True)
    return launches, {"off": s_off, "cold": runs[0][1], "warm": runs[1][1]}


def phase_slice8(torch, np, get_arch, T, M2, quantize_params, variant_counts,
                 get_policy, Engine, ServeConfig, PB, PA, Q, dev):
    """Phases 24-26: the recurrent families at full width. Returns
    (matmul launches by path, per-shape matmul timing by arch, results
    for the summary line)."""
    launches, timing, out = {}, {}, {}
    for arch, counts, per_forward in REC_MODELS:
        t_phase = time.perf_counter()
        cfg = get_arch(arch)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        qp = pack_full_width(torch, cfg, T, quantize_params, variant_counts,
                             get_policy, REC_POLICY, dev, counts, PB)
        rng = np.random.default_rng(0)
        lens = rng.integers(PROMPT_RANGE2[0], PROMPT_RANGE2[1] + 1,
                            N_REQUESTS)
        prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size, n)]
                   for n in lens]
        t0 = time.perf_counter()
        launches[f"{arch}_serve"], _, s = phase_serve(
            torch, cfg, qp, Engine, ServeConfig, PB, PA, T, dev,
            f"recurrent {arch}", SERVE2, prompts, per_forward, 0)
        res = {"serve_wall_s": time.perf_counter() - t0,
               "prefill_tok_per_s": s["prefill_tok_per_s"],
               "decode_tok_per_s": s["tok_per_s"],
               "forwards": s["forwards"]}
        one = Engine(cfg, qp, ServeConfig(**dict(SERVE2, prefill_batch=1)),
                     device=dev).generate(prompts)
        batched = Engine(cfg, qp, ServeConfig(**SERVE2),
                         device=dev).generate(prompts)
        print(f"[recurrent] {arch} prefill_batch=4 tokens == prefill_batch=1 "
              f"tokens: {batched == one}", flush=True)
        check(batched == one, f"{arch}: prefill_batch=4 and 1 differ")
        res["mamba2_forward_card_vs_cpu"] = phase_ssm_layer(torch, cfg, qp,
                                                            M2, T, dev)
        res["peak_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
        print(f"[recurrent] {arch} peak torch.cuda.max_memory_allocated "
              f"{res['peak_allocated_gb']:.2f} GB (packing included)",
              flush=True)
        res["breakdown"] = phase_recurrent_breakdown(
            torch, cfg, qp, M2, T, PB, dev, "recurrent timing")
        timing[arch] = phase_shape_timing(torch, qp, cfg, PB, Q, dev,
                                          "recurrent timing")
        print(f"[recurrent] {arch} phase "
              f"{24 if arch == 'mamba2-2.7b' else 25} took "
              f"{time.perf_counter() - t_phase:.1f}s", flush=True)
        if arch == REC_PREFIX:
            launches[f"{arch}_prefix_cache"], res["prefix"] = \
                phase_recurrent_prefix(torch, np, cfg, qp, Engine,
                                       ServeConfig, PB, dev, per_forward)
        out[arch] = res
        del qp
        torch.cuda.empty_cache()
    return launches, timing, out


def phase_slice6(torch, np, cfg, T, quantize_params, variant_counts,
                 get_policy, Engine, ServeConfig, EngineSaturated, PB, PA, Q,
                 ops, dev):
    """Phases 17-20 on full-width tinyllama-1.1b. Returns (matmul launches
    by path, attention launches by path, results for the kernels line)."""
    launches, attn, out = {}, {}, {}
    qp = pack_full_width(torch, cfg, T, quantize_params, variant_counts,
                         get_policy, "paper_llama_mix", dev, KV8_PER_FORWARD,
                         PB)
    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size, PROMPT_LEN)]
               for _ in range(N_REQUESTS)]
    launches["kv8_serve"], kv8_tokens, out["kv8"] = phase_kv8(
        torch, cfg, qp, prompts, T, Engine, ServeConfig, PB, PA, dev)
    spec_launches, out["spec"], out["verify_timing"] = phase_spec(
        torch, cfg, qp, prompts, kv8_tokens, T, Engine, ServeConfig, PB, Q,
        ops, dev)
    launches.update({f"spec_{k}": v for k, v in spec_launches.items()})
    launches["slo"] = phase_slo(torch, cfg, qp, prompts, Engine,
                                ServeConfig, EngineSaturated, PB, dev)
    del qp
    torch.cuda.empty_cache()
    cfg2 = cfg.replace(attn_impl="fused")
    qp = pack_full_width(torch, cfg2, T, quantize_params, variant_counts,
                         get_policy, "extended_mix", dev,
                         EXTENDED_PER_FORWARD, PB)
    (launches["prefix_cache"], attn["prefix_cache"], out["prefix"],
     out["warm_attn_timing"]) = phase_prefix(
        torch, np, cfg2, qp, Engine, ServeConfig, PB, PA, dev)
    del qp
    torch.cuda.empty_cache()
    return launches, attn, out


def main() -> None:
    root = Path(__file__).resolve().parent
    if not (root / "src" / "repro_torch" / "csrc" / "bfp_matmul.cu").is_file():
        fail("run from a checkout of the repository: src/repro_torch is "
             "missing beside this script")
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a GPU")
    sys.path.insert(0, str(root / "src"))
    from repro_torch.configs.base import get_arch
    from repro_torch.core import quantize as Q
    from repro_torch.core.policy import get_policy, policy_from_dict
    from repro_torch.core.qlinear import (quantize_params, to_device,
                                          variant_counts)
    from repro_torch.benchmarks.shapes import model_matmuls
    from repro_torch.core import isa
    from repro_torch.kernels import _build
    from repro_torch.kernels import bfp_matmul as PB
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import prefill_attn as PA
    from repro_torch.kernels import q8k_quant as PK
    from repro_torch.launch.serve import resolve_policy
    from repro_torch.models import mamba2 as M2
    from repro_torch.models import moe as PM
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import (Engine, EngineSaturated,
                                            ServeConfig)

    torch.backends.cuda.matmul.allow_tf32 = False    # plain versions in f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    phase_build(_build)
    max_abs = phase_kernels(torch, Q, PB, dev)
    max_abs["prefill_attn"] = phase_attention(torch, PA, dev)
    max_abs["q8k_quantize"] = phase_q8k(torch, PK, dev)
    max_abs["q2_k_n50257"] = phase_any_n(torch, Q, PB, dev)
    for policy, attn_impl in ((get_policy("paper_llama_mix"), "auto"),
                              (get_policy("extended_mix"), "fused"),
                              (policy_from_dict(HAND_MIX), "auto")):
        phase_small_model(torch, get_arch, quantize_params, to_device, T,
                          dev, policy, attn_impl)

    # slice 1: paper_llama_mix, naive prefill attention
    cfg = get_arch("tinyllama-1.1b")
    qp = pack_full_width(torch, cfg, T, quantize_params, variant_counts,
                         get_policy, "paper_llama_mix", dev,
                         {"q2_k": 45, "q3_k": 110}, PB)
    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size, PROMPT_LEN)]
               for _ in range(N_REQUESTS)]
    launches1, attn1, _ = phase_serve(
        torch, cfg, qp, Engine, ServeConfig, PB, PA, T, dev, "serve", SERVE,
        prompts, {"q2_k": 45, "q3_k": 110}, 0)
    timing = phase_timing(torch, qp, cfg, PB, Q, dev, "timing",
                          ("q2_k", "q3_k"), M_PREFILL)
    integer = {}
    integer[cfg.name], sched_inputs = phase_integer(
        torch, cfg, qp, isa, PK, ops, ref, Q, model_matmuls, dev, "integer")
    q8k_timing = phase_q8k_timing(torch, PK, sched_inputs, dev)
    del qp, sched_inputs
    torch.cuda.empty_cache()

    # slice 2: extended_mix, fused prefill attention, real prompt lengths
    cfg2 = cfg.replace(attn_impl="fused")
    qp = pack_full_width(torch, cfg2, T, quantize_params, variant_counts,
                         get_policy, "extended_mix", dev,
                         {"q3_k": 110, "q4_k": 44, "q6_k": 1}, PB)
    rng = np.random.default_rng(0)
    lens = rng.integers(PROMPT_RANGE2[0], PROMPT_RANGE2[1] + 1, N_REQUESTS)
    prompts2 = [[int(t) for t in rng.integers(0, cfg.vocab_size, n)]
                for n in lens]
    launches2, attn2, _ = phase_serve(
        torch, cfg2, qp, Engine, ServeConfig, PB, PA, T, dev, "serve2",
        SERVE2, prompts2, {"q3_k": 110, "q4_k": 44, "q6_k": 1},
        cfg.n_layers)
    timing2 = phase_timing(torch, qp, cfg2, PB, Q, dev, "timing2",
                           ("q3_k", "q4_k", "q6_k"), M_PREFILL2)
    attn_timing = phase_attn_timing(torch, PA, cfg.n_layers, dev)
    del qp
    torch.cuda.empty_cache()

    # slice 3: --policy auto, search branch then load branch, path 1's
    # traffic; the float weights stay for both (calibration runs on them)
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        qp, counts, launches_search, search = phase_search(
            torch, cfg, params, resolve_policy, quantize_params,
            variant_counts, PB, dev, Path(tmp) / "auto_search.json")
        search["eval_forward"] = phase_search_eval(torch, cfg, qp, counts,
                                                   PB, Q, T, dev)
        launches3s, _, _ = phase_serve(
            torch, cfg, qp, Engine, ServeConfig, PB, PA, T, dev, "serve3s",
            SERVE, prompts, counts, 0)
        del qp
        torch.cuda.empty_cache()
        qp = phase_load(torch, cfg, params, resolve_policy, quantize_params,
                        variant_counts, dev, Path(tmp) / "hand_mix.json")
    del params
    torch.cuda.empty_cache()
    launches3l, _, _ = phase_serve(
        torch, cfg, qp, Engine, ServeConfig, PB, PA, T, dev, "serve3l",
        SERVE, prompts, HAND_PER_FORWARD, 0)
    timing3 = phase_timing(torch, qp, cfg, PB, Q, dev, "timing3",
                           SLICE3_VARIANTS, M_SEARCH, big="search")
    del qp
    torch.cuda.empty_cache()

    # slice 4: the paper's other two models served at full width, and the
    # integer datapath over every MatMul of each
    launches4 = {}
    for arch, policy, per_forward in PAPER_MODELS:
        cfg4 = get_arch(arch)
        qp = pack_full_width(torch, cfg4, T, quantize_params, variant_counts,
                             get_policy, policy, dev, per_forward, PB)
        rng = np.random.default_rng(0)
        prompts4 = [[int(t) for t in rng.integers(0, cfg4.vocab_size,
                                                  PROMPT_LEN)]
                    for _ in range(N_REQUESTS)]
        launches4[arch], _, _ = phase_serve(
            torch, cfg4, qp, Engine, ServeConfig, PB, PA, T, dev,
            f"serve4 {arch}", SERVE, prompts4, per_forward, 0)
        integer[arch], _ = phase_integer(torch, cfg4, qp, isa, PK, ops, ref,
                                         Q, model_matmuls, dev, "integer")
        if arch == "gpt2-paper":
            head_timing = phase_shape_timing(
                torch, qp, cfg4, PB, Q, dev, "timing4")["q2_k"][
                    "x".join(map(str, GPT2_HEAD))]
        del qp
        torch.cuda.empty_cache()

    # slice 5: the rest of the dense family, temperature, blockwise
    launches5, attn5, timing5 = phase_slice5(
        torch, np, get_arch, T, quantize_params, variant_counts, get_policy,
        Engine, ServeConfig, PB, PA, Q, dev)

    # slice 6: int8 KV, speculative decoding, SLO admission, prefix cache
    launches6, attn6, slice6 = phase_slice6(
        torch, np, cfg, T, quantize_params, variant_counts, get_policy,
        Engine, ServeConfig, EngineSaturated, PB, PA, Q, ops, dev)

    # slice 7: the MoE family at full width, fused, prefix cache
    launches7, attn7, timing7, slice7 = phase_slice7(
        torch, np, get_arch, T, quantize_params, variant_counts, get_policy,
        Engine, ServeConfig, PB, PA, PM, Q, dev)

    # slice 8: the recurrent families at full width, the checkpoint
    # prefix cache
    launches8, timing8, slice8 = phase_slice8(
        torch, np, get_arch, T, M2, quantize_params, variant_counts,
        get_policy, Engine, ServeConfig, PB, PA, Q, dev)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    kernels = []
    for v in PB.VARIANTS:
        by_path = {"paper_llama_mix": launches1[v],
                   "extended_mix_fused": launches2[v],
                   "policy_auto_search": launches_search[v],
                   "policy_auto_searched_serve": launches3s[v],
                   "policy_auto_hand_mix_serve": launches3l[v],
                   **{f"{a}_serve": launches4[a][v] for a in launches4},
                   **{p: launches5[p][v] for p in launches5},
                   **{p: launches6[p][v] for p in launches6},
                   **{p: launches7[p][v] for p in launches7},
                   **{p: launches8[p][v] for p in launches8}}
        t = next(tt[v] for tt in (timing, timing2, timing3) if v in tt)
        dec = t["decode"]
        kernels.append({
            "name": f"bfp_matmul_{v}", "route": "cuda",
            "source": "src/repro_torch/csrc/bfp_matmul.cu",
            "replaces": "src/repro/kernels/bfp_matmul.py:89",
            "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": max_abs[v],
            "ms": dec["ms"], "plain_ms": dec["plain_ms"],
            "bound_ms": dec["bound_ms"], "bound_by": dec["bound_by"],
            "library_ms": dec["library_ms"],
            "per": "the launches of one decode forward (M=max_slots)",
            **{k: t[k] for k in ("prefill", "search") if k in t}})
        if v in timing and v in timing2:    # on both paths' layouts
            kernels[-1]["extended_mix"] = timing2[v]
        if v in timing5:
            kernels[-1][f"{TIMED5}_decode_shapes"] = timing5[v]
        for arch, t7 in {**timing7, **timing8}.items():
            if v in t7:
                kernels[-1][f"{arch}_decode_shapes"] = t7[v]
        checked = {f"{a} {K}x{N}": {"weights": n, "max_abs_err": e}
                   for (a, vv, K, N), (n, e) in PACKED_CHECKED.items()
                   if vv == v}
        if checked:
            kernels[-1]["packed_weights_checked"] = checked
        if v in slice6["verify_timing"]:
            kernels[-1]["batched_verify"] = slice6["verify_timing"][v][
                "verify"]
        if v == "q2_k":
            kernels[-1]["gpt2_head_n50257"] = head_timing
            kernels[-1]["max_abs_err_n50257"] = max_abs["q2_k_n50257"]
    kernels.append({
        "name": "prefill_attn", "route": "cuda",
        "source": "src/repro_torch/csrc/prefill_attn.cu",
        "replaces": "src/repro/kernels/prefill_attn.py:80",
        "launches": attn1 + attn2 + sum(attn5.values())
        + sum(attn6.values()) + sum(attn7.values()),
        "launches_by_path": {"paper_llama_mix": attn1,
                             "extended_mix_fused": attn2, **attn5, **attn6,
                             **attn7},
        "max_abs_err": max_abs["prefill_attn"],
        "ms": attn_timing["ms"], "plain_ms": attn_timing["plain_ms"],
        "bound_ms": attn_timing["bound_ms"],
        "bound_by": attn_timing["bound_by"],
        "library_ms": attn_timing["library_ms"],
        "per": "the launches of one prefill-chunk forward (22 layers)",
        "bytes": attn_timing["bytes"], "flops": attn_timing["flops"],
        "warm_prefix_chunk": slice6["warm_attn_timing"],
        f"{MOE_FUSED}_warm_prefix_chunk": slice7["fused"][
            "warm_attn_timing"]})
    q8k = q8k_timing["forward"]
    kernels.append({
        "name": "q8k_quantize", "route": "cuda",
        "source": "src/repro_torch/csrc/q8k_quant.cu",
        "replaces": "src/repro/kernels/q8k_quant.py:41",
        "launches": sum(r["launches"] for r in integer.values()),
        "launches_by_path": {f"integer_{a}": r["launches"]
                             for a, r in integer.items()},
        "max_abs_err": max_abs["q8k_quantize"],
        "ms": q8k["ms"], "plain_ms": q8k["plain_ms"],
        "bound_ms": q8k["bound_ms"], "bound_by": q8k["bound_by"],
        "library_ms": None,
        "library_note": "no single PyTorch call computes Q8_K (absmax "
                        "scale, int8 codes and 16-value block sums)",
        "per": "the launches of one tinyllama-1.1b integer-path forward "
               "(M=4, one per SCHEDULE)",
        "bytes": q8k["bytes"], "single_4096x5632": q8k_timing["single"]})
    print(f"[integer] summary: {json.dumps(integer)}", flush=True)
    print(f"[search] summary: {json.dumps(search)}", flush=True)
    summary6 = {k: slice6[k] for k in ("kv8", "spec", "prefix")}
    print(f"[slice6] summary: {json.dumps(summary6)}", flush=True)
    print(f"[slice7] summary: {json.dumps(slice7)}", flush=True)
    print(f"[slice8] summary: {json.dumps(slice8)}", flush=True)
    print(f"[done] all phases passed in {time.perf_counter() - t_start:.1f}s",
          flush=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
