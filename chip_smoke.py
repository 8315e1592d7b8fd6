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
   each (variant, K, N) that a served model runs is checked on the card;
   its f32 output is also held within 1e-6 of the exact (f64) product.
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
14. serve, slice 5: llama3.2-1b (LM head tied to the embedding: an f32
   product, no kernel), qwen3-1.7b (qk-norm), phi3-mini-3.8b (head N =
   32064) and h2o-danube-1.8b (sliding window), at full width and depth
   cut to 8 layers for time, each from random weights (seeded) packed
   with paper_llama_mix on the card, serve path 1's traffic; every
   forward must launch 16 + 40 (llama) or 17 + 40 q2_k + q3_k kernels,
   and greedy tokens must equal generate_reference. qwen3-1.7b also
   serves path 2's traffic with ``attn_impl="fused"``: 8 attention
   kernels every prefill-chunk forward (D = 128, G = 2).
   phi3-mini-3.8b's decode forward is timed per (variant, K, N) as phase
   4 times a variant.
15. temperature, slice 5: full-width qwen3-1.7b under paper_llama_mix at
   temperature 0.8, seed 7, path 1's traffic, without and with an EOS id
   (the token request 0 samples at its third step without it): the
   launch counts as in phase 14; run() equals generate_reference (on 4
   prompts, all it takes), an engine with prefill_batch=1 and a second
   engine of seed 7; seed 8 and greedy give other tokens; EOS ends
   request 0 at its third step (8 layers, as phase 14).
16. long sequence, slice 5: llama3.2-1b (8 layers) ``forward_seq`` at
   B=1, S=4096 under ``"auto"``, which takes the blockwise attention
   (launch counts zeroed just before and read just after: 16 + 40); its
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
   6-token prompts, 16 new tokens, 4 slots, ``decode_chunk=16``,
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
21. MoE, slice 7: olmoe-1b-7b (64 experts top-8, qk-norm) at full width,
   depth cut to 8 of 16 layers for time, from random weights (seeded),
   packed with default_serve_mix on the card (the expert stacks along
   E*K, one layer at a time): 17 q2_k + 40 q3_k matmuls (each expert
   stack counted once a layer). Path 1's traffic; every forward launches
   17 q2_k + 16 q3_k kernels (no kernel serves an
   expert stack: they are dequantized to bf16 and multiplied by bmm, as
   the reference's einsum), greedy tokens equal generate_reference, and
   an engine with prefill_batch=1 gives prefill_batch=4's tokens. Layer
   0's moe_block on the card equals the same call on the CPU at
   ``TOL_MOE``. The peak ``max_memory_allocated``, decode and prefill
   tok/s, each packed (variant, K, N)'s decode forward timed as phase 4
   times a variant, and one decode forward's expert path by CUDA events
   (dequantize, bmm products, moe_block whole) are printed.
22. MoE fused, slice 7: olmoe with ``attn_impl="fused"`` on path 2's
   traffic: 8 attention kernels every prefill-chunk forward (D = 128,
   G = 1), generate == generate_reference, and the token choices dropped
   a chunk forward (capacity 21 a expert a row at C = 128) printed and
   nonzero; then phase 18's shared-prefix queue (a 512 MiB pool of 512
   1-MiB pages): cache off, then on twice, the same tokens (a warm group
   keeps the cold grid's whole chunks, so the same drops), 8 attention
   launches a prefill-chunk forward, and a warm chunk's 8 attention
   launches held against the plain version and timed.
23. MoE, slice 7: granite-moe-3b-a800m (40 experts top-8, GQA 24/8, LM
   head N = 49155) at full width, 8 of 32 layers, as phase 21 without
   the second engine and the CPU check: 17 q2_k + 40 q3_k matmuls, 17
   q2_k + 16 q3_k launches a forward, generate == generate_reference,
   timings as phase 21.
   Phases 21-23 each print their wall time.
24. recurrent, slice 8: mamba2-2.7b (d 2560, SSM state 128, LM head N =
   50280) at full width, depth cut to 16 of 64 Mamba2 layers for time,
   from random weights (seeded), packed with default_serve_mix on the
   card one layer at a time (1 q2_k + 32 q3_k matmuls, each packed weight
   checked as above). Path 2's traffic (8 requests of 256-512-token
   prompts, 32 new tokens, 128-token chunks, 4 slots, a 1024-position
   cache): every forward launches 1 q2_k + 32 q3_k kernels and no
   attention kernel, greedy tokens equal
   generate_reference, and an engine with prefill_batch=1 gives
   prefill_batch=4's tokens. Layer 0's mamba2_forward on the card equals
   the same call on the CPU at ``TOL_SSM``. The peak
   ``max_memory_allocated``, decode and prefill tok/s, each packed
   (variant, K, N)'s decode forward timed as phase 4 times a variant,
   and, for one prefill-chunk forward, one decode step and one chunk
   forward's SSD scans, the span between CUDA events beside their
   kernels' device time and the kernels of most device time
   (``torch.profiler``) and the matmul kernels' time are printed.
25. recurrent, slice 8: zamba2-1.2b (d 2048, a shared attention block at
   width 4096 after every 6 Mamba2 layers) at full width, depth cut to 12
   of 38 layers (two applications of the shared block), as phase 24: 3
   q2_k + 30 q3_k matmuls packed, 5 q2_k + 36 q3_k launches a forward
   (the shared block's 8 matmuls at each application).
26. checkpoint prefix cache, slice 8: zamba2-1.2b (12 layers) on phase
   18's shared-prefix queue with a 1 GiB pool (62 pages of one 128-token
   chunk each: SSM state, conv tail and rings): cache off, then on twice;
   the same tokens, 5 + 36 launches a forward, at least 4 hits then 8,
   and the cold and warm prefill tok/s printed.
27. disaggregated serving, slice 9 (path 20, run after phase 18 on its
   weights): full-width tinyllama-1.1b under extended_mix with the fused
   attention, phase 18's queue plus one sub-page prompt, through
   ``DisaggEngine`` (prefill workers, KV page hand-off through host
   memory, decode workers behind the KV-aware router). 1P+1D greedy
   tokens equal the monolithic engine's with the prefix cache off and
   on, and so do 1P+1D at temperature 0.8 (seed 7), 1P+1D with int8 KV
   and 2P+2D greedy (both decode workers used); pages migrate, the
   sub-page prompt goes straight to decode, the decode tier's prefix
   cache hits; every forward of either tier launches 110 q3_k + 44 q4_k
   + 1 q6_k kernels and every prefill-chunk forward 22 attention kernels.
   The pages the prefill worker exports equal, bit for bit, those the
   monolithic prefix-on engine exports for the same prompts; export,
   import into a fresh engine and export again give the same bits. The
   monolithic and 1P+1D prefill and decode tok/s and TTFT p50/p99, the
   export and import ms a request and the bytes a page are printed.
28. disaggregated MoE, slice 9 (path 21, after phase 22 on its weights):
   olmoe-1b-7b (fused) 1P+1D on the first 4 requests of phase 18's queue
   with 512 MiB pools, 8 new tokens: tokens equal the monolithic
   engine's, 33 q2_k + 32 q3_k launches a forward, 16 attention launches
   a prefill-chunk forward.
29. the HTTP front end, slice 9 (path 22, after phase 20 on path 1's
   weights): a ``Frontend`` on an ephemeral loopback port over path 1's
   engine, then over a 1P+1D ``DisaggEngine``. The engine thread runs on
   the stream the engine was built on; 8 concurrent ``http.client``
   clients, 4 of them SSE, get ``Engine.generate``'s tokens in whole
   forwards of 45 q2_k + 110 q3_k launches; a ``timeout_s`` request
   finishes "timeout" with a prefix of its tokens; a client that
   disconnects mid-stream is cancelled and its slot freed; the three
   GETs answer. On an engine with ``max_slots=1, max_queue=1`` (its one
   slot held by a gate in the running request's decode chunk) a third
   request gets 429 ``queue_full``. Client TTFT p50/p99 is printed.
   Phases 27-29 each print their wall time.
30. training, slice 10 (path 23): ``run_training`` on full-width
   tinyllama-1.1b (f32 master weights, bf16 compute, remat on) for 20
   steps of the synthetic pipeline at global batch 8 x 256 in 2
   microbatches: every loss finite, the mean of the last 5 below the mean
   of the first 5, and no kernel of the port launched (training runs
   float weights and the naive attention, as the reference's). Step
   p50/p99, tokens/s, the peak ``max_memory_allocated``, the step's
   operations beside their bound, and one more step under
   ``torch.profiler`` (its kernels' device time against its span between
   CUDA events: the device-idle share) are printed.
31. training, card against CPU: one ``make_train_step`` step (2
   microbatches) of reduced tinyllama from one state, on the card and on
   the CPU, in f32 compute (loss, grad norm and the update at
   ``TOL_TRAIN_*_F32``) and in bf16 (``TOL_TRAIN_BF16``, and the update
   within twice the CPU's own bf16 update against its f32 one); no
   parameter more than 2 x lr apart.
32. resume and preemption: tinyllama at full width cut to 2 layers (a
   2.6 GB checkpoint in a temporary directory): 6 steps straight against
   3 + restart + 3 end within ``TOL_RESUME`` (the largest parameter
   difference printed); then ``python -m repro_torch.launch.train`` in a
   subprocess gets SIGTERM after its step-10 line, must say it was
   preempted and leave a checkpoint, and a resumed run finishes the
   remaining steps.
33. the other families: granite-moe-3b-a800m (4 of 32 layers; its aux
   loss finite and above 0), mamba2-2.7b (8 of 64) and zamba2-1.2b (6 of
   38: one application of the shared block), full width, 3 steps each at
   4 x 256: finite losses, the peak ``max_memory_allocated``.
   olmoe-1b-7b's train state at full depth is printed (110.7 GB of f32
   params, grads, m and v: it does not fit one card; its width is not
   cut).
34. training under ``attn_impl="fused"`` raises a NotImplementedError
   that names ``naive`` and ``blockwise`` (the kernel has no backward).
   Phases 30, 32 and 33 each print their wall time.
35. ``--policy auto`` on the other families, slice 11: ``resolve_policy``
   with no policy file on full-width olmoe-1b-7b, mamba2-2.7b and
   zamba2-1.2b at full depth: calibration, the search (2 x 64-token
   evaluations through the kernels, q3_k_o probes included, 2 rounds),
   the file written; the final policy must weakly dominate the seed on
   KL and bytes. The searched packing serves path 1's traffic (every
   forward launches one kernel a packed weight the kernel serves, no
   kernel for an expert stack; greedy tokens equal generate_reference),
   and the load branch on the written file packs the same bytes.
36. qwen2-vl-72b (vlm: M-RoPE, 64 heads on 8 KV heads, d_ff 29568, a
   152064-way head) at full width and depth under default_serve_mix,
   built a layer at a time (``init_params`` of a one-layer config from a
   generator seeded by (seed, layer), packed, copied into payloads
   allocated for all 80 layers: the whole f32 tree, 285.8 GB, cannot
   exist on one card), after checking at 2 layers that this equals
   packing the stack at once, byte for byte: 161 q2_k + 320 q3_k + 80
   q8_0 matmuls (w_down's K = 29568 is not a multiple of 256), 43.48 GB;
   the build time, the peak memory and the packed bytes printed, and
   every packed weight checked through the kernel as above (q8_0 at
   (29568, 8192): the kernel's last 256-row tile partial). Then
   ``training.steps.make_serve_steps`` under ``attn_impl="fused"``: a
   prefill of 2 x 512 seeded f32 embeddings with three distinct M-RoPE
   streams (a 4 x 8 x 8 patch grid, then text), ``cache_from_prefill``
   into a 1024-slot ring, 16 decode steps on seeded embeddings; each
   forward's launches per variant (161 + 320 + 80) and 80 attention
   launches a prefill, finite logits; the first decode step's logits
   against ``forward_seq``'s last position over the same 513 embeddings
   (``TOL_EMBED_STEP``, argmax equal or the margin rule), and two
   controls above that tolerance (the step at a position off by one, and
   on a ring whose layers are rolled by one); one decode step's span and its kernels' device time beside its bound. Each
   packed (variant, K, N) is timed over its first 8 layers' launches,
   rows of M=512 and 128 of the q8_0 w_down equal M=1 bit for bit, and
   the 80 f32 attention launches of a prefill are held against the
   plain version and timed.
37. musicgen-large (audio: sinusoidal positions, LayerNorm/GELU, 32
   heads on 32 KV heads, D = 64) at full width and depth, packed whole,
   the same serve steps: 97 q2_k + 192 q3_k launches a forward, 48
   attention launches a prefill.
38. training, slice 11: one ``make_train_step`` step (2 microbatches) of
   each: reduced, card against CPU as phase 31 (qwen2-vl on (3, B, S)
   M-RoPE positions); then at full width, 4 x 256 embeddings: musicgen
   cut to 4 of 48 layers, a whole step; qwen2-vl cut to 1 of 80 layers,
   its loss and gradients only (its 1.25 B-parameter head: the whole
   step's update, which keeps the old and new state together, runs out
   of memory at 1 layer); a finite loss and gradient norm, the peak
   memory. Phases 35-38 each print their wall time.
39. tensor parallelism, slice 12: tinyllama-1.1b at full width, depth cut
   to 8 layers, packed with paper_llama_mix, ``attn_impl="fused"``,
   served at tp = 2 and 4 with every rank on cuda:0 (this run needs one
   card: gloo, CUDA operands staged through host memory; the engine
   prints its backend), datapath "padded", over ngram speculation x the
   prefix cache (cold and warm): tokens, prefix hits and draft
   acceptances equal tp=1's; every forward 17 + 40 matmul launches and
   every prefill chunk 8 attention launches (H/tp heads), on rank 0 and,
   read through the group, on every other rank.
40. the same model's first-token logits under "sliced" and "sliced_row"
   against tp=1: within ``TOL_TP_ROW`` (f32 and bf16 activations),
   "padded" bit for bit; at tp=4 w_down (K = 5632) takes the "dequant"
   row mode and wo (K = 2048) "packed", whose f32-out partials run the
   kernel; the float weights in f32 printed beside the reference's 1e-4.
41. olmoe-1b-7b (8 layers, phase 21's traffic) at tp=2 with expert
   parallelism: tokens equal tp=1's and tp=2's with EP off.
42. the kernels at every TP launch shape: the matmul on the zero-embedded
   full-width weights of "padded" (the rank's columns equal the whole
   weight's bit for bit, the others 0), the lane slices of "sliced"
   (strided views; within ``TOL_F32`` of the whole product's columns)
   and the K-row slices of "sliced_row" (f32 out), against the plain
   version at decode and prefill M and timed at decode M beside the
   bound and torch.matmul; the attention at H = 16, KH = 2 and H = 8,
   KH = 1, against the plain version and timed over 22 launches beside
   scaled_dot_product_attention.
43. one decode chunk's wall time, rank 0's kernel ms (``torch.profiler``)
   and collectives a step at tp=2 beside tp=1: shared card, host-staged
   gloo, a record and not a claim.
44. the dry run, slice 13 (``launch/dryrun.py``): ``DRYRUN_CELLS`` (the
   two-pod production mesh, (2, 16, 16)) at full width and depth, one
   rank's real step on a fake 512-rank world, run by a subprocess that sees no card, after phase 43 (nothing
   runs beside the earlier phases' host clocks). Every cell must run
   within ``DRYRUN_WAIT_S`` and be ``ok``, with no kind of DTensor
   fallback outside its list and CUDA never initialised in its process;
   ``torch.cuda.memory_allocated`` is unchanged across the phase in this
   one. Each rank's memory (and whether it fits 80 GB), the three
   roofline terms at the H100's rates, ``dominant``, ``mfu`` and the
   trace time printed.
45. the dry run against real steps on a (1, 1) mesh: tinyllama-1.1b's
   path-23 train step (8 x 256, 2 microbatches) and a default_serve_mix
   decode step at B = 8 over 4096 slots. The dry run's argument bytes
   equal the real state's (or packed weights', cache's) and inputs'
   byte for byte; its argument + temp peak over the card's
   ``max_memory_allocated`` of the same step on the dry run's datapath
   (plain matmul, blockwise attention, remat) lies in
   ``DRYRUN_PEAK_BAND``; the card's own datapath (the matmul kernel for
   the decode, whose launches are counted) is timed beside the
   roofline's ``step_time_s``.
46. ``distributed/compress.py::compressed_psum`` over 2 ranks on cuda:0
   (gloo, staged through the host; the group phases 47-48 use next), 2
   steps: each rank's error state is its rounding residual bit for bit,
   the second step fed the first's; both ranks' means equal, within
   their bf16 roundings of the plain mean.
47. disaggregated serving over tensor-parallel engines, slice 14 (path
   35): full-width, full-depth tinyllama-1.1b (22 layers,
   paper_llama_mix, ``attn_impl="fused"``) on phase 39's traffic, through
   a 1P+1D and a 2P+2D ``DisaggEngine`` at tp=2 ("padded") with both
   ranks on cuda:0 (gloo, host-staged; NCCL between cards is not measured
   here), greedy, and a 1P+1D at temperature 0.8: each run's tokens
   equal the monolithic tp=1 engine's and the tp=1 ``DisaggEngine``'s
   (the same ServeConfig and seed); the tp=2 prefill tier's exported
   pages equal the tp=1 tier's bit for bit; rank 0 (and, read through the
   group, rank 1) launches 45 q2_k + 110 q3_k matmuls a forward and 22
   attention kernels a prefill-chunk forward on both tiers; every rank's
   ``torch.cuda.memory_allocated`` with the 2P+2D engine serving stays
   within its reading before plus four workers' rings and page pools
   (each half of what 1P+1D adds), plus 5% (one weight shard set a
   rank). Wall, TTFT p50/p99, migrated pages and the hand-off's ms,
   payload bytes and pipe bytes printed.
48. at ``TP_DEPTH`` layers: one completion and one streamed completion
   through the HTTP front end over a tp=2 ``DisaggEngine`` on phase 47's
   group, the engine's tokens; a 1P+1D at tp=4 (four ranks on cuda:0)
   with tp=1's tokens; the launcher's ``main`` with
   ``--disagg --tp 2 --device cuda:0,cuda:0`` against its ``--tp 1`` run
   (full depth, 45 + 110 launches a forward); every engine and group
   closed and no worker process left. Phases 47-48 print their walls.
49. the matmul's on-chip budget, slice 15: for each of the 40
   instantiations (8 variants x the launcher's 8-, 16-, 32- and 64-token
   tiles and the folded 64), ``kernels/bfp_matmul.py::smem_bytes``
   (computed from the constants of ``csrc/bfp_matmul.cu``) against
   ``cuFuncGetAttribute`` on the handle from the loaded library: static
   shared memory (0) and the dynamic figure the launch allows must be
   equal; registers a thread and local (spill) bytes are printed.
50. the serve flow: ``python -m repro_torch.launch.serve_quantized
   --full`` through its ``main``: full-width tinyllama-1.1b packed with
   paper_llama_mix, 6 requests of 6-token prompts on 2 slots, 10 new
   tokens, an ``on_token`` callback each; launch counts zeroed just
   before and read just after: 45 q2_k + 110 q3_k every forward, no
   attention kernel; the streamed tokens equal run()'s, which equal
   ``generate_reference``; the callbacks fire in the order of the same
   flow's reduced run on the CPU (which the tests hold to the reference
   example's).
51. the mixed-policy flow (``launch/mixed_quant_policy.py``, reduced
   llama3.2-1b as the reference example) on the card and on the CPU from
   one set of weights and tokens: each of the six policies packs the
   same bytes; the card's forwards launch ``FLOW_POLICY_LAUNCHES`` (every
   format the policies name: q2_k, q3_k, q4_k, q6_k); KL is finite,
   orders the pure variants and lies within ``TOL_FLOW_KL`` (1e-2
   relative) of the CPU's for every policy, which holds each format's
   kernel at the flow's reduced shapes (K = 256 and 512, M = 64).
52. the train flow: ``python -m repro_torch.launch.train_e2e --steps
   FLOW_TRAIN_STEPS`` through its ``main``: the ~100M llama of the
   example at its shapes (8 x 128, AdamW 6e-4, checkpoints in a
   temporary directory), finite losses that fall, no kernel of the port
   launched; step p50/p99 and tokens/s printed. Phases 49-52 print their
   wall.

Without a GPU, or outside a checkout, it exits nonzero and prints no
result. The last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import gc
import http.client
import json
import os
import shutil
import signal
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

# card peaks for bound_ms (NVIDIA H100 SXM data sheet, dense)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
F32_FLOPS_PER_S = 67e12     # CUDA cores, outside the tensor cores
# f32 products on the tensor cores, as the attention kernel's f32 path makes
# them: three TF32 MMAs a product (3xTF32) at the 495 TFLOP/s TF32 rate
F32_3XTF32_FLOPS_PER_S = 495e12 / 3

TOL_F32 = 1e-5          # kernel vs plain, f32 out: summation order only
TOL_EXACT = 1e-6        # kernel vs the f64 product of its bf16 operands, f32
                        # out: a tile's 16 k16 steps in the tensor cores'
                        # accumulator (not rounded to nearest), then f32
                        # adds; a chain of 512 k16 steps read 1.02e-5
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
# traffic, at full width and depth cut to 8 layers (of 16, 28, 32 and 24)
# to keep the run inside its time limit; (arch, layers, matmul launches a
# forward: 2 q2_k and 5 q3_k a layer and the head's q2_k, but a tied head
# is an f32 product with the embedding, no kernel)
DEPTH5 = 8
SLICE5_MODELS = (("llama3.2-1b", DEPTH5, {"q2_k": 16, "q3_k": 40}),
                 ("qwen3-1.7b", DEPTH5, {"q2_k": 17, "q3_k": 40}),
                 ("phi3-mini-3.8b", DEPTH5, {"q2_k": 17, "q3_k": 40}),
                 ("h2o-danube-1.8b", DEPTH5, {"q2_k": 17, "q3_k": 40}))
FUSED5 = "qwen3-1.7b"           # also serves path 2's traffic, fused
TIMED5 = "phi3-mini-3.8b"       # its decode shapes timed one by one
TEMP5 = dict(temperature=0.8, seed=7)
LONG5 = ("llama3.2-1b", 4096, 16)   # arch, S, last positions compared
# blockwise against naive at S = 4096 in bf16, relative to the largest
# logit: the two sum the same f32 softmax in another order, so a bf16
# rounding of an attention output can flip by one step (2**-8) and move
# the next layers' inputs; 8 such steps (a bound set at 16 layers, kept
# at the cut depth)
TOL_LONG = 2.0 ** -5
# slice 6: the engine's int8 KV ring, prefix cache, speculative decoding
# and SLO admission on full-width tinyllama-1.1b
KV8_PER_FORWARD = {"q2_k": 45, "q3_k": 110}         # paper_llama_mix
EXTENDED_PER_FORWARD = {"q3_k": 110, "q4_k": 44, "q6_k": 1}
SERVE_PREFIX = dict(SERVE2, prefill_bucket=16, prefix_page=16,
                    prefix_bytes=64 << 20)
SHARED_PREFIX, SUFFIX_RANGE = 384, (16, 128)
PREFIX_CAPACITY = 186           # 64 MiB over 22 x 16 x 4 x 64 x 2 B x (k, v)
# 16 new tokens (32 until slice 14, cut for the run's time)
SERVE_SPEC = dict(max_new_tokens=16, max_slots=4, decode_chunk=16,
                  cache_len=64, prefill_batch=4, prefill_chunk=16,
                  prefill_bucket=16, draft_k=4)
M_VERIFY = SERVE_SPEC["max_slots"] * (SERVE_SPEC["draft_k"] + 1)   # 20
DRAFT_LAYERS = 2
SELF_PER_DRAFT = {"q2_k": 5, "q3_k": 10}    # 2 layers' wk, wv + the head
SERVE_SLO = dict(SERVE, decode_chunk=2, preempt=True, max_queue=2)
MARGIN_TOL = 0.1        # ROADMAP's parity contract (test_torch_engine.py)
# slice 7: the MoE family at full width under default_serve_mix (the
# reference launcher's default), depth cut to 8 layers (of 16 and 32) for
# time; (arch, layers, variant_counts, matmul launches a forward): the
# expert stacks are packed (counted once a layer) but run as bmm on
# dequantized bf16 stacks, so no matmul kernel serves them
MOE_POLICY = "default_serve_mix"
MOE_MODELS = (("olmoe-1b-7b", 8, {"q2_k": 17, "q3_k": 40},
               {"q2_k": 17, "q3_k": 16}),
              ("granite-moe-3b-a800m", 8, {"q2_k": 17, "q3_k": 40},
               {"q2_k": 17, "q3_k": 16}))
MOE_FUSED = "olmoe-1b-7b"       # also path 2's traffic fused, and the
                                # prefix cache on phase 18's traffic
# phase 18's queue on olmoe: 1 MiB pages (8 layers x 16 positions x 16
# KV heads x 128 x 2 B x (k, v)), a 512 MiB pool
SERVE_PREFIX_MOE = dict(SERVE_PREFIX, prefix_bytes=512 << 20)
PREFIX_CAPACITY_MOE = 512
TOL_MOE = 2.0 ** -6     # one layer's moe_block, card vs CPU, bf16 out: the
                        # bf16 expert products summed in another order, and
                        # the output rounded again (tests/test_torch_cuda.py)
# slice 8: the recurrent families at full width under default_serve_mix,
# path 2's traffic (no attention kernel: zamba2's shared block prefills
# through the naive attention, as the reference's), depth cut for time to
# 16 of 64 layers and 12 of 38 (two applications of zamba2's shared
# block); (arch, layers, variant_counts, matmul launches a forward):
# zamba2's shared block is packed once and runs at each application
REC_POLICY = "default_serve_mix"
REC_MODELS = (("mamba2-2.7b", 16, {"q2_k": 1, "q3_k": 32},
               {"q2_k": 1, "q3_k": 32}),
              ("zamba2-1.2b", 12, {"q2_k": 3, "q3_k": 30},
               {"q2_k": 5, "q3_k": 36}))
REC_PREFIX = "zamba2-1.2b"      # phase 18's shared-prefix queue, phase 26
# a checkpoint page is one 128-token chunk: 17.1 MB on zamba2 at 12
# layers (SSM state, conv tail, and the rings of 2 applications)
SERVE_PREFIX_REC = dict(SERVE_PREFIX, prefix_bytes=1 << 30)
PREFIX_CAPACITY_REC = 62
TOL_SSM = 2.0 ** -6     # layer 0's mamba2_forward, card vs CPU, bf16 out:
                        # in_proj's bf16 output rounds differently where
                        # the f32 sums differ, and the scan carries it on
# slice 9: disaggregated serving and the HTTP front end. Path 20 is path
# 11's queue plus one sub-page prompt (direct to decode) on tinyllama;
# path 21 the first requests of that queue on olmoe (fused, 512 MiB pools)
N_MOE_DISAGG, MOE_DISAGG_TOKENS = 4, 8
# slice 10: training (path 23). Full-width tinyllama-1.1b, f32 master
# weights, bf16 compute, remat on, global batch 8 x 256 in 2 microbatches
TRAIN_ARCH = "tinyllama-1.1b"
TRAIN_RUN = dict(steps=20, global_batch=8, seq_len=256, microbatches=2,
                 seed=0)
TRAIN_OPT = dict(lr=5e-4, warmup_steps=4)
# resume and preemption: full width, depth cut to 2 layers (a 2.6 GB
# checkpoint of f32 params, m and v)
RESUME_LAYERS, RESUME_STEPS = 2, 6
PREEMPT_STEPS, PREEMPT_AT = 40, 10      # SIGTERM after the step-10 log line
TOL_RESUME = 1e-4       # the reference's own bound (test_checkpoint.py)
# card against CPU, one train step of reduced tinyllama from one state:
# f32 compute holds f32 sums in another order; bf16 compute the update
# within twice the CPU's own bf16 update against its f32 one; no element
# more than 2 x lr apart (Adam's first step is lr x g / (|g| + eps): an
# element whose gradient is near 0 can step the other way)
TOL_TRAIN_LOSS_F32, TOL_TRAIN_GNORM_F32, TOL_TRAIN_UPD_F32 = 1e-5, 1e-4, 1e-3
TOL_TRAIN_BF16 = 2e-2
# the other families, full width, depth cut for time and memory; a few
# steps each at 4 x 256
TRAIN_FAMILIES = (("granite-moe-3b-a800m", 4), ("mamba2-2.7b", 8),
                  ("zamba2-1.2b", 6))
FAMILY_RUN = dict(steps=3, global_batch=4, seq_len=256)
# slice 11: serve --policy auto on MoE, ssm and hybrid at full width
SEARCH_FAMILIES = ("olmoe-1b-7b", "mamba2-2.7b", "zamba2-1.2b")
# the embedding-input families at full width under default_serve_mix (the
# reference launcher's default): qwen2-vl-72b's d_ff 29568 is not a
# multiple of 256, so its w_down falls back to q8_0
EMBED_POLICY = "default_serve_mix"
EMBED_MODELS = ("qwen2-vl-72b", "musicgen-large")
VL_COUNTS = {"q2_k": 161, "q3_k": 320, "q8_0": 80}
MUSICGEN_COUNTS = {"q2_k": 97, "q3_k": 192}
# the serve steps: a prefill of 2 x 512 embeddings, a 1024-slot ring, 16
# decode steps
EMBED_PROMPT, EMBED_CACHE, EMBED_DECODE = 512, 1024, 16
# a decode step against forward_seq's last position, relative to the
# largest logit: the decode step reads its K/V from the bf16 ring where
# forward_seq keeps them in f32 (the f32 embeddings keep an f32 stream),
# a bf16 rounding in each layer's K and V; and the attention is the plain
# decode attention against the fused kernel. Two controls must read above
# it: the step at a position off by one, and on a ring whose layers are
# rolled by one
TOL_EMBED_STEP = 2.0 ** -7
# layers timed a (variant, K, N): qwen2-vl's 80 layers' w_gate alone
# would take 38.7 GB dequantized
EMBED_TIMED_LAYERS = 8
# (arch, layers, whether the optimizer update runs) at full width:
# qwen2-vl cut to 1 of 80 layers, its loss and gradients only: its 152064
# x 8192 head alone is 1.25 B parameters, and the port's AdamW returns
# new trees, so at the update the old and new params and moments live
# together; the whole step at 1 layer ran out of memory in the update
# (72.7 GB allocated, 2.12 B parameters); musicgen cut to 4 of 48, the
# whole step
EMBED_TRAIN = (("qwen2-vl-72b", 1, False), ("musicgen-large", 4, True))
# slice 12: tensor- and expert-parallel serving (phases 39-43). This run
# needs one card, so every rank of a group runs on cuda:0: the ranks share
# it, and the backend rule gives gloo with CUDA operands staged through
# host memory. NCCL between cards is not measured here.
TP_DEGREES = (2, 4)
# full width, depth cut to 8 of 22 layers for time: a step at tp > 1 runs
# 4 host-staged all-gathers a layer (these phases took 447 s at 22 layers
# on an H100)
TP_ARCH, TP_POLICY, TP_DEPTH = "tinyllama-1.1b", "paper_llama_mix", 8
TP_PER_FORWARD = {"q2_k": 2 * TP_DEPTH + 1, "q3_k": 5 * TP_DEPTH}
TP_SERVE = dict(max_new_tokens=8, max_slots=4, decode_chunk=8,
                cache_len=256, prefill_batch=4, prefill_chunk=64,
                prefill_bucket=16)
TP_SHARED, TP_SUFFIX, TP_REQUESTS = 64, (8, 48), 4
TP_SPEC = dict(drafter="ngram", draft_k=3)
TP_PREFIX = dict(prefix_cache=True, prefix_page=16)
TP_MATRIX = ((False, False), (False, True), (True, False), (True, True))
TP_TIMEOUT_S = 300.0
# "sliced" and "sliced_row" logits against tp=1, rtol and atol / max|ref|:
# the reference's tolerance for packed weights
# (tests/test_tp_serving.py::test_sliced_row_quantized_row_modes): a packed
# product rounds its input to bf16, so an f32 ulp upstream can move an
# input by a bf16 ulp, in f32 activations too (k_splits gives w_gate and
# w_up 4 parts at N = 5632, 8 at N / 2 and N / 4). A "sliced" product
# itself is held to TOL_F32 against the whole weight's columns (phase
# 42). The reference's 1e-4 on float weights in f32 was set on its
# 2-layer reduced model on the CPU (the CPU tests hold it); here the f32
# reassociations of 8 full-width layers are printed beside it, not gated
TOL_TP_ROW = 2e-2
TOL_TP_FLOAT_REFERENCE = 1e-4
# phase 43: a decode chunk of 8 steps timed, another profiled, after an
# untimed one
TP_DECODE = dict(TP_SERVE, max_new_tokens=25)
# the attention at a rank's heads: tinyllama's 32 heads and 4 kv heads
# over 2 and 4 ranks
TP_ATTN = ((16, 2), (8, 1))
# slice 13 (phases 44-46): the dry run. Phase 44's production cells, run
# after phase 43 by a subprocess with CUDA_VISIBLE_DEVICES empty, all
# within DRYRUN_WAIT_S: (arch, shape, multi_pod, the kinds of op that
# DTensor may refuse in it and the dry run may gather for; a kind outside
# the list fails the phase; as torch 2.11 gave them on an H100's host).
# One cell, the two-pod decode (20-33 s there), to keep phases 44-46 near
# 120 s: the hill-climb base cells (llama3.2-1b train_4k 58-92 s,
# granite-moe-3b-a800m train_4k 84 s, qwen2-vl-72b decode_32k 98 s on
# that host) are left to `python -m repro_torch.launch.dryrun` (PERF.md)
DRYRUN_CELLS = (
    ("llama3.2-1b", "decode_32k", True,
     ("aten.view.default (gathered over 1 mesh dims)",
      "aten.index_put_.default (local in-place)",
      "aten.index.Tensor (gathered over 2 mesh dims)")),)
DRYRUN_WAIT_S = 300.0
CARD_BYTES = 80e9               # an H100's HBM
# phase 45: the dry run against real steps on a (1, 1) mesh: tinyllama's
# training step of path 23 (8 x 256 in 2 microbatches) and a
# default_serve_mix decode step at B = 8 over a 4096-slot cache; the dry
# run's argument + temp peak over the card's max_memory_allocated of the
# same datapath must lie in this band (set from the first runs on an
# H100: PERF.md, slice 13)
DRYRUN_TRAIN = dict(global_batch=8, seq_len=256, microbatches=2)
DRYRUN_DECODE = dict(global_batch=8, seq_len=4096)
DRYRUN_PEAK_BAND = (0.95, 1.05)
DRYRUN_TIMED_STEPS = 5
# phase 46: compressed_psum over 2 ranks sharing cuda:0 (gloo), grads of
# these shapes from a seed
COMPRESS_SHAPES = {"w": (2048, 5632), "b": (5632,), "emb": (32000, 64)}
# slice 14 (phases 47-48): DisaggEngine over tp=2 engines on phase 39's
# traffic (full depth), at tp=4 and through the launcher and the front end
# at TP_DEPTH layers; the workers turn the prefix cache on (16-position
# pages)
DTP = 2
DTP_SERVE = dict(TP_SERVE, prefix_page=16)
DTP_TEMP = dict(temperature=0.8, seed=7)
DTP_PER_FORWARD = {"q2_k": 45, "q3_k": 110}
DTP_MEM_SLACK = 0.05
# slice 15 (phases 49-52): the on-chip budget read back, and the example
# flows through their entry points. The serve flow's forward at full width
# (tinyllama-1.1b, paper_llama_mix) launches path 1's kernels. The policy
# flow (reduced llama3.2-1b, 2 layers, tied head: no kernel) packs six
# policies and runs one student forward each: 14 launches a policy, q2_k
# pure 14 + paper mix wk, wv 4; q3_k pure 14 + paper mix 10 + extended mix
# wq, wk, wo, w_gate, w_up 10; q4_k pure 14 + extended mix wv, w_down 4;
# q6_k pure 14. The train flow runs FLOW_TRAIN_STEPS of the example's 300
# steps, for time.
FLOW_SERVE_PER_FORWARD = {"q2_k": 45, "q3_k": 110}
FLOW_POLICY_LAUNCHES = {"q2_k": 18, "q3_k": 34, "q4_k": 18, "q6_k": 14}
FLOW_TRAIN_STEPS = 30
# the policy flow's KL on the card against the CPU's, relative, a policy:
# the same bf16 forwards whose products sum in another order (predicted
# 1%; an H100 80GB HBM3 at 700 W read at most 0.156%)
TOL_FLOW_KL = 1e-2
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
    return all(rows_of_weight(torch, PB, Q.quantize(variant, torch.randn(
        K, N, generator=g, device=dev) / K ** 0.5), dev, g)
        for K, N in ROW_SHAPES)


def rows_of_weight(torch, PB, t, dev, g):
    """Rows of an M=512 and an M=128 product against the M=1 product of
    each row, bit for bit, on one packed weight of the model."""
    x = torch.randn(512, t.shape[0], generator=g, device=dev).bfloat16()
    for out_dtype in (torch.float32, torch.bfloat16):
        full = {M: PB.bfp_matmul_cuda(x[:M], t, out_dtype=out_dtype)
                for M in (512, 128)}
        for m in ROWS_CHECKED:
            one = PB.bfp_matmul_cuda(x[m:m + 1], t, out_dtype=out_dtype)[0]
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
                    get_policy, policy, dev, expect, PB, shapes=True):
    t0 = time.perf_counter()
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    qp, report = quantize_params(params, get_policy(policy))
    del params
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    counts = variant_counts(report, qp)
    print(f"[pack] full-width {cfg.name} ({cfg.n_layers} layers) under "
          f"{policy} packed in "
          f"{time.perf_counter() - t0:.1f}s: {counts} matmuls", flush=True)
    check(counts == expect, f"{policy} layout: {counts}, expected {expect}")
    if shapes:
        check_shapes(torch, qp, cfg, PB, dev)
    return qp


def phase_search(torch, cfg, params, resolve_policy, quantize_params,
                 variant_counts, PB, dev, path, tag="search"):
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
    print(f"[{tag}] calibration ({meta['calib_tokens']} rows) and search "
          f"in {t_search:.1f}s: {info['evaluations']} evaluations at "
          f"M={M_SEARCH}; seed kl {meta['seed']['kl']:.6f} bytes "
          f"{meta['seed']['bytes']} -> final kl {meta['final']['kl']:.6f} "
          f"bytes {meta['final']['bytes']} (top1 {meta['final']['top1']:.3f}"
          f", pseudo-ppl {meta['final']['pseudo_ppl']:.3f})", flush=True)
    print(f"[{tag}] assignment: {info['assignment']}", flush=True)
    print(f"[{tag}] kernel launches during the search: {launches}; peak "
          f"device memory {peak_gb:.2f} GB", flush=True)
    check(launches["q3_k_o"] > 0, "the search launched no q3_k_o kernel")
    check(meta["final"]["kl"] <= meta["seed"]["kl"] * (1 + 1e-6)
          and meta["final"]["bytes"] <= meta["seed"]["bytes"],
          "the searched policy does not weakly dominate the seed")
    t0 = time.perf_counter()
    qp, report = quantize_params(params, policy, calib=calib)
    torch.cuda.synchronize()
    counts = variant_counts(report, qp)
    print(f"[{tag}] searched policy packed in "
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


def _leaves(tree, prefix=""):
    """(path, leaf) of a parameter tree, a packed weight (QTensor) or a
    float tensor each."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield prefix + k, v


def _packed(tree):
    """The packed weights (QTensors) of a parameter tree."""
    return (v for _, v in _leaves(tree) if hasattr(v, "variant"))


def _float_leaves(tree):
    return (v for _, v in _leaves(tree) if not hasattr(v, "variant"))


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


# (arch, variant, K, N) -> (weights checked, largest f32 abs error against
# the plain version, the kernel's and the plain version's largest f32
# relative error against the exact product, the kernel's K splits) of
# every full-width model packed, filled by check_shapes
PACKED_CHECKED = {}
# columns of the f64 product computed at once (the head's 152064 at once
# would be 10 GB)
EXACT_COLS = 16384


def exact_product(torch, x, t):
    """x @ W in f64, W the packed weight dequantized and rounded to bf16 as
    both the kernel and the plain version take it: each product of a bf16
    x and a bf16 weight is exact in f32, so the two differ from this only
    by their f32 summation."""
    from repro_torch.core.quantize import dequantize
    w = dequantize(t, dtype=torch.float32).bfloat16()
    xd = x.double()
    return torch.cat([xd @ w[:, j:j + EXACT_COLS].double()
                      for j in range(0, w.shape[1], EXACT_COLS)], 1)


def check_shapes(torch, qp, cfg, PB, dev):
    """Each weight of ``_kernel_weights`` through the kernel against its
    plain version at M = max_slots, f32 and bf16 out, at phase 2's
    tolerances; one line a (variant, K, N). The kernel's f32 output is also
    held within ``TOL_EXACT`` of the exact (f64) product, and the plain
    version's error against it printed beside, with the kernel's K
    splits (one part of 32 tiles at wide N)."""
    g = torch.Generator(device=dev).manual_seed(13)
    for (variant, K, N), ts in sorted(_kernel_weights(qp, cfg).items()):
        x = torch.randn(M_DECODE, K, generator=g, device=dev).bfloat16()
        e32 = e16 = worst = ek = ep = 0.0
        for t in ts:
            y = PB.bfp_matmul_cuda(x, t, out_dtype=torch.float32)
            ref = PB.bfp_matmul_plain(x, t, out_dtype=torch.float32)
            check(bool(torch.isfinite(y).all()),
                  f"{cfg.name} {variant} ({K}, {N}): non-finite output")
            e32 = max(e32, rel_err(y, ref))
            worst = max(worst, float((y - ref).abs().max()))
            exact = exact_product(torch, x, t)
            ek = max(ek, rel_err(y.double(), exact))
            ep = max(ep, rel_err(ref.double(), exact))
            del exact
            e16 = max(e16, rel_err(PB.bfp_matmul_cuda(x, t),
                                   PB.bfp_matmul_plain(x, t)))
        splits = PB.k_splits(K, N)
        PACKED_CHECKED[(cfg.name, variant, K, N)] = (len(ts), worst, ek, ep,
                                                     splits)
        print(f"[packed] {cfg.name} {variant} ({K}, {N}) x{len(ts)}, M="
              f"{M_DECODE}: kernel vs plain f32 rel {e32:.2e} (tol "
              f"{TOL_F32:.0e}), bf16 rel {e16:.2e} (tol {TOL_BF16:.2e}); "
              f"against the exact product: kernel {ek:.2e} (tol "
              f"{TOL_EXACT:.0e}), plain {ep:.2e}; K in {splits} part(s) of "
              f"{-(-K // 256) // splits} 256-row tiles", flush=True)
        check(e32 <= TOL_F32, f"{cfg.name} {variant} ({K}, {N}) f32 error")
        check(ek <= TOL_EXACT, f"{cfg.name} {variant} ({K}, {N}): f32 error "
              "against the exact product")
        check(e16 <= TOL_BF16, f"{cfg.name} {variant} ({K}, {N}) bf16 "
              "error")


def phase_shape_timing(torch, qp, cfg, PB, Q, dev, tag, layers=None):
    """One decode forward's launches (M = max_slots) of each packed
    (variant, K, N) of the model that the kernel serves, timed as phase 4
    times a variant's (each checked by ``check_shapes`` at packing); with
    ``layers``, the launches of the first ``layers`` layers (and the
    head's)."""
    groups = {k: ts[:layers] for k, ts in
              _kernel_weights(qp, cfg, uses=True).items()}
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
    for arch, depth, per_forward in SLICE5_MODELS:
        cfg = get_arch(arch).replace(n_layers=depth)
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


def prefix_prompts(np, cfg):
    """Path 11's queue: ``N_REQUESTS`` prompts of one ``SHARED_PREFIX``-token
    prefix and a suffix of ``SUFFIX_RANGE`` tokens each."""
    rng = np.random.default_rng(18)
    shared = [int(t) for t in rng.integers(0, cfg.vocab_size, SHARED_PREFIX)]
    return [shared + [int(t) for t in rng.integers(
        0, cfg.vocab_size, int(n))]
        for n in rng.integers(SUFFIX_RANGE[0], SUFFIX_RANGE[1] + 1,
                              N_REQUESTS)]


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
    prompts = prefix_prompts(np, cfg)
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
                 get_policy, Engine, ServeConfig, DisaggEngine, PB, PA, PM, Q,
                 dev):
    """Phases 21-23: the MoE family at full width, and slice 9's phase 28
    (olmoe disaggregated) on phase 22's weights. Returns (matmul launches
    by path, attention launches by path, per-shape matmul timing by arch,
    results for the summary line)."""
    launches, attn, timing, out = {}, {}, {}, {}
    for arch, depth, counts, per_forward in MOE_MODELS:
        t_phase = time.perf_counter()
        cfg = get_arch(arch).replace(n_layers=depth)
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
            key = f"{arch}_disagg_1p1d"
            launches[key], attn[key], out["disagg"] = phase_disagg_moe(
                torch, np, cfg2, qp, Engine, ServeConfig, DisaggEngine, PB,
                PA, dev, per_forward)
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
    for arch, depth, counts, per_forward in REC_MODELS:
        t_phase = time.perf_counter()
        cfg = get_arch(arch).replace(n_layers=depth)
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


def _routed(torch, DisaggEngine, ServeConfig, PB, PA, cfg, qp, dev, scfg,
            prompts, per_forward, tag, p=1, d=1):
    """``prompts`` through a fresh pP+dD ``DisaggEngine`` (the main path)
    with the launch counts zeroed just before and read just after; every
    forward of either tier launches ``per_forward`` matmul kernels, every
    prefill-chunk forward ``cfg.n_layers`` attention kernels. Returns
    (engine, tokens, stats, matmul launches, attention launches, wall s)."""
    dis = DisaggEngine(cfg, qp, ServeConfig(**scfg), prefill_workers=p,
                       decode_workers=d, device=dev)
    torch.cuda.synchronize()
    PB.reset_launches()
    PA.reset_launches()
    t0 = time.perf_counter()
    res = dis.generate(prompts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    s = dict(dis.stats)
    lw, aw = dict(PB.launches), PA.launches["prefill_attn"]
    _check_launches(tag, PB, lw, s, per_forward)
    check(aw == cfg.n_layers * s["prefill_forwards"],
          f"{tag}: {aw} attention launches over {s['prefill_forwards']} "
          "prefill-chunk forwards")
    rt = s["router"]
    print(f"[{tag}] {len(res)} requests in {wall:.3f}s: "
          f"{_engine_rates(s)}, ttft p50 {s['ttft_p50_s'] * 1e3:.1f} ms, "
          f"p99 {s['ttft_p99_s'] * 1e3:.1f} ms; migrated "
          f"{s['migrated_pages']} pages for {s['migrated_requests']} "
          f"requests, direct-to-decode {rt['direct_decode']}, decode-tier "
          f"prefix_hits {s['prefix_hits']}, decode requests "
          f"{rt['decode_requests']}, {s['prefill_forwards']} prefill-chunk "
          f"forwards of {s['forwards']}", flush=True)
    check(s["migrated_pages"] > 0 and s["prefix_hits"] > 0,
          f"{tag}: no page migrated or reused")
    check(all(len(t) == scfg["max_new_tokens"] for t in res),
          f"{tag}: a request did not get its tokens")
    return dis, res, s, lw, aw, wall


def _payload_bytes(kv) -> int:
    return sum(v.numel() * v.element_size() for v in kv.payload.values())


def phase_disagg(torch, np, cfg, qp, Engine, ServeConfig, DisaggEngine, PB,
                 PA, dev):
    """Phase 27 (path 20): path 11's queue plus one sub-page prompt on
    full-width tinyllama (extended_mix, fused attention) through the
    disaggregated path, held token for token to the monolithic engine:
    1P+1D greedy (cache off and on), at temperature 0.8, with int8 KV, and
    2P+2D greedy; the prefill worker's pages against the monolithic
    engine's bit for bit; export, import, export bit for bit. Returns
    (matmul launches by path, attention launches by path, summary)."""
    t_phase = time.perf_counter()
    rng = np.random.default_rng(27)
    prompts = prefix_prompts(np, cfg) + [
        [int(t) for t in rng.integers(0, cfg.vocab_size,
                                      SERVE_PREFIX["prefix_page"] // 2)]]
    scfg, per_forward = SERVE_PREFIX, EXTENDED_PER_FORWARD
    off = Engine(cfg, qp, ServeConfig(**scfg), device=dev)
    mono, s_mono, _, wall_mono = _served(torch, off, prompts, PB)
    on = Engine(cfg, qp, ServeConfig(**scfg, prefix_cache=True), device=dev)
    check(on.generate(prompts) == mono,
          "disagg: the monolithic prefix-on engine differs from cache-off")
    print(f"[disagg] monolithic: {len(mono)} requests in {wall_mono:.3f}s: "
          f"{_engine_rates(s_mono)}, ttft p50 "
          f"{s_mono['ttft_p50_s'] * 1e3:.1f} ms, p99 "
          f"{s_mono['ttft_p99_s'] * 1e3:.1f} ms", flush=True)
    launches, attn, out = {}, {}, {"monolithic": _rates(s_mono)}
    dis, res, s1, launches["disagg_1p1d"], attn["disagg_1p1d"], _ = _routed(
        torch, DisaggEngine, ServeConfig, PB, PA, cfg, qp, dev, scfg,
        prompts, per_forward, "disagg 1P+1D")
    check(res == mono, "disagg 1P+1D: tokens differ from the monolithic "
                       "engine's")
    check(s1["router"]["direct_decode"] == 1,
          "disagg 1P+1D: the sub-page prompt did not go straight to decode")
    out["1p1d"] = _rates(s1)

    # the prefill worker's pages against the monolithic engine's, and a
    # round trip through a fresh engine, timed a request
    worker = dis.prefill_engines[0]
    dst = Engine(cfg, qp, ServeConfig(**scfg, prefix_cache=True), device=dev)
    exp_ms, imp_ms, same, trip = [], [], True, True
    for p in prompts[:N_REQUESTS]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        kv = worker.export_kv_pages(p)
        exp_ms.append((time.perf_counter() - t0) * 1e3)
        ref = on.export_kv_pages(p)
        same &= (kv.n_pages > 0 and kv.tokens == ref.tokens
                 and set(kv.payload) == set(ref.payload)
                 and all(_bytes_equal(torch, kv.payload[k], ref.payload[k])
                         for k in ref.payload))
        t0 = time.perf_counter()
        dst.import_kv_pages(kv)
        torch.cuda.synchronize()
        imp_ms.append((time.perf_counter() - t0) * 1e3)
        back = dst.export_kv_pages(p)
        trip &= (back.tokens == kv.tokens and all(
            _bytes_equal(torch, back.payload[k], v)
            for k, v in kv.payload.items()))
    page_bytes = _payload_bytes(kv) // kv.n_pages
    print(f"[disagg] prefill worker's pages == the monolithic prefix-on "
          f"engine's bit for bit, {N_REQUESTS} prompts: {same}; export -> "
          f"import -> export bit for bit: {trip}", flush=True)
    check(same, "disagg: the prefill worker's pages differ from the "
                "monolithic engine's")
    check(trip, "disagg: export -> import -> export changed a bit")
    out["handoff"] = {
        "export_ms_mean": statistics.mean(exp_ms),
        "export_ms_max": max(exp_ms),
        "import_ms_mean": statistics.mean(imp_ms),
        "import_ms_max": max(imp_ms), "bytes_per_page": page_bytes,
        "pages_per_request": kv.n_pages}
    print(f"[disagg] hand-off a request ({kv.n_pages} pages of "
          f"{page_bytes / 2**20:.3f} MiB): export mean "
          f"{statistics.mean(exp_ms):.3f} ms (max {max(exp_ms):.3f}), import "
          f"mean {statistics.mean(imp_ms):.3f} ms (max {max(imp_ms):.3f}; "
          f"a chain already resident dedups) (host clocks, synced)",
          flush=True)

    mono_t = Engine(cfg, qp, ServeConfig(**scfg, **TEMP5),
                    device=dev).generate(prompts)
    _, res_t, _, launches["disagg_1p1d_t08"], attn["disagg_1p1d_t08"], _ = \
        _routed(torch, DisaggEngine, ServeConfig, PB, PA, cfg, qp, dev,
                dict(scfg, **TEMP5), prompts, per_forward,
                "disagg 1P+1D t=0.8")
    print(f"[disagg] temperature 0.8 seed 7: 1P+1D == monolithic: "
          f"{res_t == mono_t}; sampled != greedy: {mono_t != mono}",
          flush=True)
    check(res_t == mono_t and mono_t != mono,
          "disagg: sampled tokens differ from the monolithic engine's")
    cfg8 = cfg.replace(kv_cache_quant=True)
    mono8 = Engine(cfg8, qp, ServeConfig(**scfg), device=dev).generate(
        prompts)
    _, res8, _, launches["disagg_1p1d_kv8"], attn["disagg_1p1d_kv8"], _ = \
        _routed(torch, DisaggEngine, ServeConfig, PB, PA, cfg8, qp, dev,
                scfg, prompts, per_forward, "disagg 1P+1D int8 KV")
    print(f"[disagg] int8 KV: 1P+1D == monolithic: {res8 == mono8}",
          flush=True)
    check(res8 == mono8, "disagg: int8-KV tokens differ from the "
                         "monolithic engine's")
    _, res22, s22, launches["disagg_2p2d"], attn["disagg_2p2d"], _ = _routed(
        torch, DisaggEngine, ServeConfig, PB, PA, cfg, qp, dev, scfg,
        prompts, per_forward, "disagg 2P+2D", p=2, d=2)
    print(f"[disagg] 2P+2D == monolithic: {res22 == mono}", flush=True)
    check(res22 == mono, "disagg 2P+2D: tokens differ from the monolithic "
                         "engine's")
    check(all(n > 0 for n in s22["router"]["decode_requests"]),
          "disagg 2P+2D: a decode worker was not used")
    out["2p2d"] = _rates(s22)
    print(f"[disagg] phase 27 took {time.perf_counter() - t_phase:.1f}s",
          flush=True)
    return launches, attn, out


def _rates(s):
    return {"prefill_tok_per_s": s["prefill_tok_per_s"],
            "decode_tok_per_s": s["tok_per_s"],
            "ttft_p50_s": s["ttft_p50_s"], "ttft_p99_s": s["ttft_p99_s"]}


def phase_disagg_moe(torch, np, cfg, qp, Engine, ServeConfig, DisaggEngine,
                     PB, PA, dev, per_forward):
    """Phase 28 (path 21): olmoe (fused) 1P+1D on the first
    ``N_MOE_DISAGG`` requests of path 11's queue, a 512 MiB pool each
    worker: tokens equal the monolithic engine's. Returns (matmul
    launches, attention launches, rates)."""
    t_phase = time.perf_counter()
    prompts = prefix_prompts(np, cfg)[:N_MOE_DISAGG]
    scfg = dict(SERVE_PREFIX_MOE, max_new_tokens=MOE_DISAGG_TOKENS)
    mono = Engine(cfg, qp, ServeConfig(**scfg), device=dev).generate(prompts)
    _, res, s, launches, attn, _ = _routed(
        torch, DisaggEngine, ServeConfig, PB, PA, cfg, qp, dev, scfg,
        prompts, per_forward, "moe disagg 1P+1D")
    print(f"[moe disagg] 1P+1D == monolithic: {res == mono}; phase 28 took "
          f"{time.perf_counter() - t_phase:.1f}s", flush=True)
    check(res == mono, "moe disagg: tokens differ from the monolithic "
                       "engine's")
    return launches, attn, _rates(s)


class _Gate:
    """Parks an engine's ``_run_chunk`` (on the engine thread) while held."""

    def __init__(self, eng):
        self.open = threading.Event()
        self.open.set()
        self.parked = threading.Event()
        run_chunk = eng._run_chunk

        def gated():
            if not self.open.is_set():
                self.parked.set()
                self.open.wait(120)
            run_chunk()
        eng._run_chunk = gated


def _wait_for(cond, what, limit=60.0):
    deadline = time.perf_counter() + limit
    while time.perf_counter() < deadline:
        if cond():
            return
        time.sleep(0.005)
    fail(f"frontend: timed out waiting for {what}")


def _http(port, method, path, payload=None, timeout=120.0):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    conn.request(method, path, None if payload is None
                 else json.dumps(payload),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    body = json.loads(resp.read())
    conn.close()
    return resp.status, body


def _client(port, prompt, max_tokens, stream, out, i):
    """One client: POST a completion; SSE reads event by event. Records
    (tokens, finish_reason, s to the first token or None, s in all)."""
    t0 = time.perf_counter()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    conn.request("POST", "/v1/completions", json.dumps(dict(
        prompt=prompt, max_tokens=max_tokens, stream=stream)),
        {"Content-Type": "application/json"})
    resp = conn.getresponse()
    if not stream:
        body = json.loads(resp.read())
        ch = body["choices"][0]
        out[i] = (ch["token_ids"], ch["finish_reason"], None,
                  time.perf_counter() - t0)
    else:
        toks, first, fin = [], None, None
        while True:
            line = resp.readline()
            if not line or line.strip() == b"data: [DONE]":
                break
            if not line.startswith(b"data: "):
                continue
            ch = json.loads(line[6:])["choices"][0]
            if "token_id" in ch:
                toks.append(ch["token_id"])
                if first is None:
                    first = time.perf_counter() - t0
            if ch.get("finish_reason"):
                fin = ch["finish_reason"]
        out[i] = (toks, fin, first, time.perf_counter() - t0)
    conn.close()


def phase_frontend(torch, np, cfg, qp, prompts, Engine, ServeConfig,
                   DisaggEngine, FE, PB, dev):
    """Phase 29 (path 22): the HTTP front end on an ephemeral loopback port
    over path 1's engine (full-width tinyllama, paper_llama_mix), then
    over a 1P+1D DisaggEngine. Each: 8 concurrent clients, 4 of them SSE,
    get ``Engine.generate``'s tokens; a ``timeout_s`` request finishes
    "timeout" with its partial tokens; a client that disconnects
    mid-stream frees its slot; the GETs answer. Then a max_slots=1,
    max_queue=1 engine refuses a third request with 429 queue_full.
    Returns (matmul launches by path, summary)."""
    t_phase = time.perf_counter()
    budget = SERVE["max_new_tokens"]
    expect = Engine(cfg, qp, ServeConfig(**SERVE), device=dev).generate(
        prompts)
    launches, out = {}, {}
    for kind in ("engine", "disagg"):
        tag = f"http {kind}"
        if kind == "engine":
            eng = serving = Engine(cfg, qp, ServeConfig(**SERVE), device=dev)
        else:
            eng = DisaggEngine(cfg, qp, ServeConfig(**SERVE), device=dev)
            serving = eng.decode_engines[0]
        fe = FE.Frontend(eng, FE.FrontendConfig(
            model_name=cfg.name, request_timeout_s=300.0)).start()
        try:
            _wait_for(lambda: fe.engine_stream is not None,
                      "the engine thread")
            main_stream = torch.cuda.current_stream(dev)
            print(f"[{tag}] listening on port {fe.port}; engine thread's "
                  f"stream == the stream the engine was built on: "
                  f"{fe.engine_stream == main_stream}", flush=True)
            check(fe.engine_stream == main_stream,
                  f"{tag}: the engine thread runs on another stream")
            torch.cuda.synchronize()
            PB.reset_launches()
            res = [None] * len(prompts)
            threads = [threading.Thread(target=_client, args=(
                fe.port, p, budget, i % 2 == 0, res, i))
                for i, p in enumerate(prompts)]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join(600)
            wall = time.perf_counter() - t0
            lw = dict(PB.launches)
            launches[f"http_{kind}"] = lw
            check(all(r is not None for r in res), f"{tag}: a client hung")
            toks = [r[0] for r in res]
            ttft = [r[2] for r in res if r[2] is not None]
            lat = [r[3] for r in res]
            print(f"[{tag}] 8 concurrent clients (4 SSE) in {wall:.3f}s: "
                  f"tokens == Engine.generate: {toks == expect}; client "
                  f"TTFT (SSE) p50 {np.percentile(ttft, 50) * 1e3:.1f} ms, "
                  f"p99 {np.percentile(ttft, 99) * 1e3:.1f} ms; latency p50 "
                  f"{np.percentile(lat, 50) * 1e3:.1f} ms; matmul launches "
                  f"{lw}", flush=True)
            check(toks == expect, f"{tag}: tokens differ from "
                                  "Engine.generate's")
            check(all(r[1] == "length" for r in res),
                  f"{tag}: finish reasons {[r[1] for r in res]}")
            fwd = lw["q2_k"] // KV8_PER_FORWARD["q2_k"]
            check(fwd > 0 and lw == {v: KV8_PER_FORWARD.get(v, 0) * fwd
                                     for v in PB.VARIANTS},
                  f"{tag}: launches {lw} are not whole forwards of "
                  f"{KV8_PER_FORWARD}")
            out[kind] = {"wall_s": wall, "forwards": fwd,
                         "client_ttft_p50_s": float(np.percentile(ttft, 50)),
                         "client_ttft_p99_s": float(np.percentile(ttft, 99)),
                         "latency_p50_s": float(np.percentile(lat, 50))}

            status, body = _http(fe.port, "POST", "/v1/completions", dict(
                prompt=prompts[0], max_tokens=50, timeout_s=0.001))
            ch = body["choices"][0]
            kept = ch["token_ids"]
            n = min(len(kept), budget)
            print(f"[{tag}] timeout_s=0.001: {status} finish_reason "
                  f"{ch['finish_reason']}, {len(kept)} of 50 tokens kept, "
                  f"their first {n} the greedy run's: "
                  f"{kept[:n] == expect[0][:n]}", flush=True)
            check(status == 200 and ch["finish_reason"] == "timeout"
                  and len(kept) < 50 and kept[:n] == expect[0][:n],
                  f"{tag}: the timeout request did not finish 'timeout' "
                  "with its partial tokens")

            sock = socket.create_connection(("127.0.0.1", fe.port),
                                            timeout=120)
            payload = json.dumps(dict(prompt=prompts[1], max_tokens=50,
                                      stream=True)).encode()
            sock.sendall(b"POST /v1/completions HTTP/1.1\r\nHost: x\r\n"
                         b"Content-Type: application/json\r\n"
                         + f"Content-Length: {len(payload)}\r\n\r\n".encode()
                         + payload)
            check(bool(sock.recv(64)), f"{tag}: the stream did not start")
            sock.close()
            _wait_for(lambda: fe.stats["disconnects"] > 0,
                      "the disconnect to cancel its request")
            _wait_for(lambda: all(r is None for r in serving._slots),
                      "the disconnected request's slot to free")
            status, body = _http(fe.port, "POST", "/v1/completions", dict(
                prompt=prompts[2], max_tokens=budget))
            check(status == 200 and body["choices"][0]["token_ids"]
                  == expect[2], f"{tag}: no request served after the "
                                "disconnect")
            print(f"[{tag}] a client disconnected mid-stream: cancelled, "
                  f"slot freed, the next request served", flush=True)
            gets = {path: _http(fe.port, "GET", path) for path in (
                "/health", "/v1/models", "/stats")}
            check(all(st == 200 for st, _ in gets.values())
                  and gets["/health"][1]["status"] == "ok"
                  and gets["/v1/models"][1]["data"][0]["id"] == cfg.name
                  and gets["/stats"][1]["frontend"]["completions"] >= 10,
                  f"{tag}: GETs {gets}")
            json.dumps(eng.stats)
            print(f"[{tag}] GET /health, /v1/models, /stats: 200; frontend "
                  f"stats {gets['/stats'][1]['frontend']}", flush=True)
        finally:
            fe.close()

    # saturation: A holds the one slot (parked in its decode chunk), B
    # queues, C is refused
    eng = Engine(cfg, qp, ServeConfig(**dict(SERVE, max_slots=1,
                                             max_queue=1)), device=dev)
    gate = _Gate(eng)
    fe = FE.Frontend(eng, FE.FrontendConfig(model_name=cfg.name)).start()
    try:
        gate.open.clear()
        conns = [http.client.HTTPConnection("127.0.0.1", fe.port,
                                            timeout=300) for _ in range(3)]
        try:
            conns[0].request("POST", "/v1/completions", json.dumps(dict(
                prompt=prompts[0], max_tokens=40, stream=True)))
            ra = conns[0].getresponse()
            _wait_for(gate.parked.is_set, "A to reach its decode chunk")
            for i, conn in enumerate(conns[1:], 1):
                conn.request("POST", "/v1/completions", json.dumps(dict(
                    prompt=prompts[i], max_tokens=2)))
                _wait_for(lambda: fe._inbox.qsize() >= i,
                          f"request {'BC'[i - 1]} in the inbox")
        finally:
            gate.open.set()
        rc = conns[2].getresponse()
        body_c = json.loads(rc.read())
        rb = conns[1].getresponse()
        body_b = json.loads(rb.read())
        done_a = ra.read().endswith(b"data: [DONE]\n\n")
        for conn in conns:
            conn.close()
    finally:
        fe.close()
    err = body_c.get("error", {})
    print(f"[http saturation] max_slots=1, max_queue=1: third request "
          f"{rc.status} {err.get('type')} {err.get('reason')}; the queued "
          f"one {rb.status}, the running one finished: {done_a}", flush=True)
    check(rc.status == 429 and err.get("reason") == "queue_full",
          f"http saturation: expected 429 queue_full, got {rc.status} "
          f"{body_c}")
    check(rb.status == 200 and body_b["choices"][0]["token_ids"]
          == expect[1][:2] and done_a,
          "http saturation: the queued or running request did not serve")
    print(f"[http] phase 29 took {time.perf_counter() - t_phase:.1f}s",
          flush=True)
    return launches, out


def phase_slice6(torch, np, cfg, T, quantize_params, variant_counts,
                 get_policy, Engine, ServeConfig, EngineSaturated,
                 DisaggEngine, FE, PB, PA, Q, ops, dev):
    """Phases 17-20 on full-width tinyllama-1.1b, and slice 9's phases 29
    (the front end, on path 1's weights) and 27 (disaggregated, on path
    11's). Returns (matmul launches by path, attention launches by path,
    results for the kernels line)."""
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
    http_launches, out["frontend"] = phase_frontend(
        torch, np, cfg, qp, prompts, Engine, ServeConfig, DisaggEngine, FE,
        PB, dev)
    launches.update(http_launches)
    del qp
    torch.cuda.empty_cache()
    cfg2 = cfg.replace(attn_impl="fused")
    qp = pack_full_width(torch, cfg2, T, quantize_params, variant_counts,
                         get_policy, "extended_mix", dev,
                         EXTENDED_PER_FORWARD, PB)
    (launches["prefix_cache"], attn["prefix_cache"], out["prefix"],
     out["warm_attn_timing"]) = phase_prefix(
        torch, np, cfg2, qp, Engine, ServeConfig, PB, PA, dev)
    dl, da, out["disagg"] = phase_disagg(
        torch, np, cfg2, qp, Engine, ServeConfig, DisaggEngine, PB, PA, dev)
    launches.update(dl)
    attn.update(da)
    del qp
    torch.cuda.empty_cache()
    return launches, attn, out


def _kernel_launches(PB, PA, PK) -> int:
    return (sum(PB.launches.values()) + PA.launches["prefill_attn"]
            + PK.launches["q8k_quantize"])


def _reset_kernels(PB, PA, PK) -> None:
    PB.reset_launches()
    PA.reset_launches()
    PK.reset_launches()


def _n_params(tree) -> int:
    if isinstance(tree, dict):
        return sum(_n_params(v) for v in tree.values())
    return tree.numel()


def _train_step_profile(torch, step_fn, state, batch):
    """One train step under ``torch.profiler``, with CUDA events around it:
    (span ms between the events, device ms of its kernels and copies,
    their count, the 6 names of most device time)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        start.record()
        state, _ = step_fn(state, batch)
        end.record()
        torch.cuda.synchronize()

    def dev_us(e):
        return (getattr(e, "self_device_time_total", 0)
                or getattr(e, "self_cuda_time_total", 0))
    rows = sorted(prof.key_averages(), key=dev_us, reverse=True)
    busy = sum(dev_us(e) for e in rows) / 1e3
    return (start.elapsed_time(end), busy, sum(e.count for e in rows),
            [(e.key[:60], e.count, round(dev_us(e) / 1e3, 3))
             for e in rows[:6]])


def _train_flops(cfg, n_layer_params, n_head_params, tokens, remat):
    """Matmul and attention operations of one train step: forward 2, backward
    4 a parameter a token, a layer recomputed under remat, and the naive
    attention's full S x S scores and values (2 products, 2 x B x S^2 x
    H x Dh each) a layer, forward, backward (twice) and recompute."""
    B, S = tokens
    n = B * S
    mm = (6 * (n_layer_params + n_head_params) * n
          + (2 * n_layer_params * n if remat else 0))
    attn = (2 * 2 * B * S * S * cfg.n_heads * cfg.d_head * cfg.n_layers
            * (4 if remat else 3))
    return mm + attn


def phase_train_full(torch, np, cfg, S, loop, AdamWConfig, DP, PB, PA, PK,
                     dev):
    """Phase 30 (path 23): ``run_training`` at full width and depth."""
    t_phase = time.perf_counter()
    opt = AdamWConfig(total_steps=TRAIN_RUN["steps"], **TRAIN_OPT)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _reset_kernels(PB, PA, PK)
    res = loop.run_training(
        cfg, opt=opt, log_every=5, device=dev,
        log_fn=lambda m: print(f"[train] {m}", flush=True), **TRAIN_RUN)
    launched = _kernel_launches(PB, PA, PK)
    peak = torch.cuda.max_memory_allocated() / 1e9
    losses = res["losses"]
    check(len(losses) == TRAIN_RUN["steps"]
          and all(np.isfinite(losses)), f"training losses {losses}")
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    print(f"[train] {cfg.name} losses {[round(x, 4) for x in losses]}; "
          f"mean of the first 5 {first:.4f}, of the last 5 {last:.4f}",
          flush=True)
    check(last < first, f"training loss did not fall: {first} -> {last}")
    check(launched == 0, f"training launched {launched} kernels of the "
          "port: none is on this path")
    params = res["state"]["params"]
    n_all = _n_params(params)
    n_head = params["lm_head"].numel()
    n_layers = _n_params(params["layers"])
    t = res["timing"]
    B, Sq = TRAIN_RUN["global_batch"], TRAIN_RUN["seq_len"]
    flops = _train_flops(cfg, n_layers, n_head, (B, Sq), cfg.remat)
    # one more step, profiled, on the run's next batch
    step_fn = S.make_train_step(cfg, opt,
                                microbatches=TRAIN_RUN["microbatches"])
    data = DP.DataPipeline(DP.DataConfig(vocab_size=cfg.vocab_size,
                                         seq_len=Sq, global_batch=B,
                                         seed=TRAIN_RUN["seed"]))
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in data.batch(TRAIN_RUN["steps"]).items()}
    span, busy, n_kernels, top = _train_step_profile(
        torch, step_fn, res["state"], batch)
    out = {"params": n_all, "steps": len(losses),
           "loss_first5": first, "loss_last5": last,
           "step_p50_s": t["p50"], "step_p99_s": t["p99"],
           "tokens_per_s": B * Sq / t["p50"], "peak_allocated_gb": peak,
           "flops_per_step": flops,
           "bound_ms": flops / BF16_FLOPS_PER_S * 1e3,
           "profiled_step_span_ms": span, "profiled_device_ms": busy,
           # None where the profiler shows no device time
           "device_idle_share": max(0.0, 1 - busy / span) if busy else None,
           "profiled_launches": n_kernels, "top_kernels": top,
           "kernel_launches": launched}
    print(f"[train] {cfg.name} {n_all:,} params, {len(losses)} steps of "
          f"{B} x {Sq} ({TRAIN_RUN['microbatches']} microbatches, remat "
          f"{cfg.remat}): step p50 {t['p50'] * 1e3:.1f} ms p99 "
          f"{t['p99'] * 1e3:.1f} ms, {out['tokens_per_s']:.1f} tok/s, peak "
          f"torch.cuda.max_memory_allocated {peak:.2f} GB; "
          f"{flops / 1e12:.2f} TFLOP a step (bound {out['bound_ms']:.2f} "
          f"ms at 989 TFLOP/s); a profiled step spans {span:.1f} ms, its "
          f"{n_kernels} kernels and copies {busy:.1f} ms of device time "
          f"(idle share {out['device_idle_share']}); top {top}; "
          f"kernels of the port launched: {launched}", flush=True)
    print(f"[train] phase 30 took {time.perf_counter() - t_phase:.1f}s",
          flush=True)
    return out


def _to(tree, where):
    if isinstance(tree, dict):
        return {k: _to(v, where) for k, v in tree.items()}
    return tree.to(where)


def _update_err(new, ref, p0, leaves) -> float:
    """The largest leaf's norm of (new - ref) over its norm of (ref - p0):
    how far two updates from p0 are apart, relative to the update."""
    return max(float((a.double() - b.double()).norm()
                     / (b.double() - c.double()).norm().clamp_min(1e-30))
               for a, b, c in zip(leaves(new), leaves(ref), leaves(p0)))


def phase_train_card_vs_cpu(torch, np, get_arch, S, AdamWConfig, leaves,
                            dev, arch=TRAIN_ARCH):
    """Phase 31: one make_train_step step of reduced tinyllama (or
    ``arch``) from one state, on the card against the CPU, in f32 and in
    bf16 compute."""
    cfg = get_arch(arch, reduced=True)
    opt = AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=10)
    state = S.init_train_state(cfg, opt, torch.Generator().manual_seed(0),
                               device="cpu")
    batch = train_batch(torch, np, cfg, 4, 64, "cpu")

    def one(c, where):
        new, m = S.make_train_step(c, opt, microbatches=2)(
            _to(state, where), {k: v.to(where) for k, v in batch.items()})
        return _to(new["params"], "cpu"), {k: float(v) for k, v in m.items()}
    out, p0 = {}, state["params"]
    cpu32 = None
    for dtype in ("float32", "bfloat16"):
        c = cfg.replace(dtype=dtype)
        card, mc = one(c, dev)
        cpu, mp = one(c, "cpu")
        rel = {k: abs(mc[k] - mp[k]) / abs(mp[k])
               for k in ("loss", "grad_norm")}
        upd = _update_err(card, cpu, p0, leaves)
        worst = max(float((a - b).abs().max())
                    for a, b in zip(leaves(card), leaves(cpu)))
        check(worst <= 2 * mc["lr"], f"train step {dtype}: a parameter "
              f"{worst} apart on the card, past 2 x lr")
        if dtype == "float32":
            check(rel["loss"] <= TOL_TRAIN_LOSS_F32
                  and rel["grad_norm"] <= TOL_TRAIN_GNORM_F32
                  and upd <= TOL_TRAIN_UPD_F32,
                  f"train step f32 card vs CPU: {rel}, update {upd}")
            cpu32 = cpu
            noise = None
        else:
            noise = _update_err(cpu, cpu32, p0, leaves)
            check(max(rel.values()) <= TOL_TRAIN_BF16 and upd <= 2 * noise,
                  f"train step bf16 card vs CPU: {rel}, update {upd}, the "
                  f"CPU's bf16 against f32 {noise}")
        out[dtype] = {"loss_rel": rel["loss"],
                      "grad_norm_rel": rel["grad_norm"],
                      "update_rel": upd, "max_abs_param": worst,
                      "cpu_bf16_vs_f32_update": noise,
                      "loss": mc["loss"]}
        print(f"[train] card vs CPU, reduced {cfg.name}, {dtype} compute: "
              f"loss {mc['loss']:.6f} vs {mp['loss']:.6f} (rel "
              f"{rel['loss']:.2e}), grad norm rel {rel['grad_norm']:.2e}, "
              f"update rel {upd:.2e}"
              + (f" (CPU bf16 vs f32 {noise:.2e})" if noise else "")
              + f", largest parameter difference {worst:.2e}", flush=True)
    return out


def phase_train_resume(torch, np, cfg, S, loop, AdamWConfig, Checkpointer,
                       leaves, root, dev):
    """Phase 32: 6 steps straight against 3 + restart + 3 at full width,
    2 layers; then the launcher in a subprocess, preempted by SIGTERM, and
    the rest of its run resumed."""
    t_phase = time.perf_counter()
    cfg2 = cfg.replace(n_layers=RESUME_LAYERS)
    opt = AdamWConfig(total_steps=RESUME_STEPS, **TRAIN_OPT)
    kw = dict(global_batch=TRAIN_RUN["global_batch"],
              seq_len=TRAIN_RUN["seq_len"],
              microbatches=TRAIN_RUN["microbatches"], opt=opt, seed=3,
              log_fn=lambda *_: None, device=dev)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        res_a = loop.run_training(cfg2, steps=RESUME_STEPS, **kw)
        d1 = Path(tmp) / "resume"
        half = RESUME_STEPS // 2
        t0 = time.perf_counter()
        loop.run_training(cfg2, steps=half, ckpt_dir=str(d1),
                          ckpt_every=half, **kw)
        t_save = time.perf_counter() - t0
        res_b = loop.run_training(cfg2, steps=RESUME_STEPS,
                                  ckpt_dir=str(d1), ckpt_every=half, **kw)
        ck_bytes = sum(f.stat().st_size
                       for f in (d1 / f"step_{half}").iterdir())
        check(len(res_b["losses"]) == RESUME_STEPS - half,
              f"resume ran {len(res_b['losses'])} steps")
        dl = abs(res_a["losses"][-1] - res_b["losses"][-1])
        dp = max(float((a.float() - b.float()).abs().max())
                 for a, b in zip(leaves(res_a["state"]["params"]),
                                 leaves(res_b["state"]["params"])))
        print(f"[train] resume at {RESUME_LAYERS} layers: {RESUME_STEPS} "
              f"steps straight end at loss {res_a['losses'][-1]:.6f}, "
              f"{half} + restart + {half} at {res_b['losses'][-1]:.6f} "
              f"(|diff| {dl:.2e}, bound {TOL_RESUME}); largest parameter "
              f"difference {dp:.3e}; checkpoint {ck_bytes / 1e9:.2f} GB, "
              f"the {half}-step run with its two saves took {t_save:.1f}s",
              flush=True)
        check(dl <= TOL_RESUME, f"resumed loss {dl} apart")
        out.update(loss_diff=dl, max_param_diff=dp,
                   checkpoint_gb=ck_bytes / 1e9)
        del res_a, res_b
        shutil.rmtree(d1)

        # the launcher, preempted
        ckdir = Path(tmp) / "preempt"
        env = dict(os.environ, PYTHONPATH=str(root / "src"))
        cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
               TRAIN_ARCH, "--device", str(dev), "--layers",
               str(RESUME_LAYERS), "--steps",
               str(PREEMPT_STEPS), "--batch", str(kw["global_batch"]),
               "--seq", str(kw["seq_len"]), "--microbatches",
               str(kw["microbatches"]), "--lr", str(TRAIN_OPT["lr"]),
               "--warmup", str(TRAIN_OPT["warmup_steps"]), "--ckpt-dir",
               str(ckdir), "--ckpt-every", "1000", "--seed", "3"]
        proc = subprocess.Popen(cmd, cwd=str(root), env=env,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        lines = []
        try:
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < 300:
                line = proc.stdout.readline()
                if not line:
                    break
                lines.append(line.rstrip())
                if line.startswith(f"step {PREEMPT_AT:5d}"):
                    proc.send_signal(signal.SIGTERM)
                    break
            rest, _ = proc.communicate(timeout=300)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        lines += rest.splitlines()
        for ln in lines:
            print(f"[train] launcher: {ln}", flush=True)
        check(proc.returncode == 0, f"the launcher exited {proc.returncode}")
        check(any(ln.startswith("[preempt] SIGTERM at step")
                  for ln in lines), "the launcher did not say it was "
              "preempted")
        steps = Checkpointer(str(ckdir)).all_steps()
        check(bool(steps) and steps[-1] < PREEMPT_STEPS,
              f"preemption left checkpoints {steps}")
        res = loop.run_training(cfg2, steps=PREEMPT_STEPS,
                                ckpt_dir=str(ckdir), ckpt_every=1000,
                                **dict(kw, opt=AdamWConfig(
                                    total_steps=PREEMPT_STEPS, **TRAIN_OPT)))
        check(len(res["losses"]) == PREEMPT_STEPS - steps[-1]
              and all(np.isfinite(res["losses"])),
              f"the resumed run took {len(res['losses'])} steps")
        print(f"[train] preempted after step {steps[-1] - 1}: checkpoint "
              f"step_{steps[-1]}; the resumed run finished the remaining "
              f"{len(res['losses'])} steps, final loss "
              f"{res['losses'][-1]:.4f}", flush=True)
        out.update(preempted_at=steps[-1],
                   resumed_steps=len(res["losses"]))
        del res
    torch.cuda.empty_cache()
    print(f"[train] phase 32 took {time.perf_counter() - t_phase:.1f}s",
          flush=True)
    return out


def phase_train_families(torch, np, get_arch, S, AdamWConfig, DP, dev):
    """Phase 33: a few train steps of the MoE, ssm and hybrid families at
    full width, depth cut; olmoe-1b-7b's state size at full depth."""
    t_phase = time.perf_counter()
    out = {}
    opt = AdamWConfig(total_steps=FAMILY_RUN["steps"], **TRAIN_OPT)
    for arch, depth in TRAIN_FAMILIES:
        cfg = get_arch(arch).replace(n_layers=depth)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        state = S.init_train_state(
            cfg, opt, torch.Generator(device=dev).manual_seed(0), device=dev)
        step_fn = S.make_train_step(cfg, opt)
        data = DP.DataPipeline(DP.DataConfig(
            vocab_size=cfg.vocab_size, seq_len=FAMILY_RUN["seq_len"],
            global_batch=FAMILY_RUN["global_batch"]))
        losses, auxes, times = [], [], []
        for i in range(FAMILY_RUN["steps"]):
            t0 = time.perf_counter()
            batch = {k: torch.from_numpy(v).to(dev)
                     for k, v in data.batch(i).items()}
            state, m = step_fn(state, batch)
            losses.append(float(m["loss"]))
            auxes.append(float(m["aux"]))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated() / 1e9
        n = _n_params(state["params"])
        check(all(np.isfinite(losses)) and all(np.isfinite(auxes)),
              f"{arch}: losses {losses}, aux {auxes}")
        if cfg.family == "moe":
            check(min(auxes) > 0, f"{arch}: aux {auxes}")
        out[arch] = {"layers": depth, "params": n, "losses": losses,
                     "aux": auxes, "step_s": times, "peak_allocated_gb": peak}
        print(f"[train] {arch} at full width, {depth} of "
              f"{get_arch(arch).n_layers} layers ({n:,} params), "
              f"{FAMILY_RUN['global_batch']} x {FAMILY_RUN['seq_len']}: "
              f"losses {[round(x, 4) for x in losses]}, aux "
              f"{[round(x, 4) for x in auxes]}, step s "
              f"{[round(x, 3) for x in times]}, peak "
              f"torch.cuda.max_memory_allocated {peak:.2f} GB", flush=True)
        del state, step_fn
    # olmoe-1b-7b at full depth: its f32 params, grads, m and v
    cfg = get_arch("olmoe-1b-7b")
    counts = []
    for depth in (1, 2):
        p = S.T.init_params(cfg.replace(n_layers=depth),
                            torch.Generator(device=dev).manual_seed(0),
                            device=dev)
        counts.append(_n_params(p))
        del p
    n = counts[0] + (cfg.n_layers - 1) * (counts[1] - counts[0])
    out["olmoe-1b-7b"] = {"params": n, "train_state_gb": 16 * n / 1e9}
    print(f"[train] olmoe-1b-7b not trained: {n:,} params x 16 B of f32 "
          f"params, grads, m and v = {16 * n / 1e9:.1f} GB at full depth, "
          f"past one card's 80 GB (its width is not cut)", flush=True)
    torch.cuda.empty_cache()
    print(f"[train] phase 33 took {time.perf_counter() - t_phase:.1f}s",
          flush=True)
    return out


def phase_train_fused(torch, np, get_arch, S, AdamWConfig, dev):
    """Phase 34: training under ``attn_impl="fused"`` raises."""
    cfg = get_arch(TRAIN_ARCH).replace(n_layers=1, attn_impl="fused")
    opt = AdamWConfig()
    state = S.init_train_state(cfg, opt,
                               torch.Generator(device=dev).manual_seed(0),
                               device=dev)
    toks = torch.zeros((1, 16), dtype=torch.int32, device=dev)
    try:
        S.make_train_step(cfg, opt)(state, {"tokens": toks, "labels": toks})
    except NotImplementedError as e:
        msg = str(e)
    else:
        fail("training under attn_impl='fused' did not raise")
    check("naive" in msg and "blockwise" in msg, f"unclear refusal: {msg}")
    print(f"[train] fused attention refused: {msg}", flush=True)
    del state
    torch.cuda.empty_cache()
    return msg


def phase_slice10(torch, np, get_arch, dev, root, PB, PA, PK):
    """Phases 30-34: training (path 23)."""
    from repro_torch.checkpoint.ckpt import Checkpointer
    from repro_torch.data import pipeline as DP
    from repro_torch.optim.adamw import AdamWConfig, tree_leaves
    from repro_torch.training import loop
    from repro_torch.training import steps as S
    t0 = time.perf_counter()
    cfg = get_arch(TRAIN_ARCH)
    out = {"full": phase_train_full(torch, np, cfg, S, loop, AdamWConfig,
                                    DP, PB, PA, PK, dev)}
    torch.cuda.empty_cache()
    out["card_vs_cpu"] = phase_train_card_vs_cpu(torch, np, get_arch, S,
                                                 AdamWConfig, tree_leaves,
                                                 dev)
    out["resume"] = phase_train_resume(torch, np, cfg, S, loop, AdamWConfig,
                                       Checkpointer, tree_leaves, root, dev)
    out["families"] = phase_train_families(torch, np, get_arch, S,
                                           AdamWConfig, DP, dev)
    out["fused_refusal"] = phase_train_fused(torch, np, get_arch, S,
                                             AdamWConfig, dev)
    out["wall_s"] = time.perf_counter() - t0
    print(f"[train] phases 30-34 took {out['wall_s']:.1f}s", flush=True)
    return out


# ---------------------------------------------------------------------------
# slice 11: --policy auto on MoE, ssm and hybrid; the embedding-input
# families (qwen2-vl-72b, musicgen-large) through the serve steps
# ---------------------------------------------------------------------------

def _per_forward(qp, cfg):
    """Matmul launches a forward by variant: every weight the kernel
    serves (``_kernel_weights`` with zamba2's shared block once an
    application; MoE expert stacks run by bmm, no kernel)."""
    out = {}
    for (v, _, _), ts in _kernel_weights(qp, cfg, uses=True).items():
        out[v] = out.get(v, 0) + len(ts)
    return out


def phase_search_families(torch, np, get_arch, T, resolve_policy,
                          quantize_params, variant_counts, Engine,
                          ServeConfig, PB, PA, dev, tmp):
    """Phase 35: ``serve --policy auto`` through ``resolve_policy`` on
    olmoe-1b-7b, mamba2-2.7b and zamba2-1.2b at full width and depth: the
    search (calibration, 2 x 64-token evaluations, ``SEARCH_ROUNDS``
    rounds) weakly dominates its seed, the searched packing serves path
    1's traffic (launch counts, generate == generate_reference), and the
    load branch on the written file packs the same bytes."""
    out, launches = {}, {}
    for arch in SEARCH_FAMILIES:
        t_phase = time.perf_counter()
        cfg = get_arch(arch)
        torch.cuda.empty_cache()
        params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                               device=dev)
        path = Path(tmp) / f"auto_{arch}.json"
        qp, counts, search_launches, res = phase_search(
            torch, cfg, params, resolve_policy, quantize_params,
            variant_counts, PB, dev, path, tag=f"search {arch}")
        per_forward = _per_forward(qp, cfg)
        rng = np.random.default_rng(0)
        prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size,
                                                 PROMPT_LEN)]
                   for _ in range(N_REQUESTS)]
        key = f"{arch}_policy_auto_searched_serve"
        launches[key], _, s = phase_serve(
            torch, cfg, qp, Engine, ServeConfig, PB, PA, T, dev,
            f"search {arch} serve", SERVE, prompts, per_forward, 0)
        launches[f"{arch}_policy_auto_search"] = search_launches
        t0 = time.perf_counter()
        pol, calib, info = resolve_policy(cfg, params, policy="auto",
                                          arch=arch, policy_json=str(path),
                                          device=dev)
        loaded, _ = quantize_params(params, pol, calib=calib)
        same = _same_trees(torch, loaded, qp)
        print(f"[search {arch}] load branch: {path.name} loaded and packed "
              f"in {time.perf_counter() - t0:.1f}s; payloads == the "
              f"search's packing: {same}", flush=True)
        check(info is None and same, f"{arch}: the load branch packed "
              "other bytes than the search")
        res.update(per_forward=per_forward, serve_decode_tok_per_s=s[
            "tok_per_s"], wall_s=time.perf_counter() - t_phase)
        out[arch] = res
        print(f"[search {arch}] phase 35 took {res['wall_s']:.1f}s",
              flush=True)
        del params, qp, loaded
        torch.cuda.empty_cache()
    return launches, out


def embed_inputs(torch, cfg, B, S, g, dev):
    """Seeded f32 embeddings (B, S, d) and, under M-RoPE, (3, B, S)
    positions with three distinct streams: a 4 x 8 x 8 (t, h, w) grid of
    vision patches, then text. A text position rides all three streams
    and is its sequence index, since ``decode_step``'s position is both
    its ring slot and its rotary position."""
    emb = torch.randn(B, S, cfg.d_model, generator=g, device=dev)
    if cfg.pos_emb != "mrope":
        return emb, None
    t, h, w = torch.meshgrid(torch.arange(4), torch.arange(8),
                             torch.arange(8), indexing="ij")
    vis = torch.stack([t.reshape(-1), h.reshape(-1), w.reshape(-1)])
    text = torch.arange(vis.shape[1], S).expand(3, -1)
    pos = torch.cat([vis, text], 1)[:, None].expand(3, B, S)
    return emb, pos.to(torch.int32).contiguous().to(dev)


def _layer_seed(seed, li):
    return seed * 1_000_003 + li


def build_by_layer(torch, cfg, T, quantize_params, policy, dev, seed=0,
                   n_layers=None):
    """The packed tree of ``cfg`` at depth ``n_layers`` (default all),
    built a layer at a time: ``init_params`` of a one-layer config from a
    generator seeded by (seed, layer), packed, and copied into payloads
    allocated for the whole stack (a concatenation along L, without two
    copies at once). The head and final norm are layer 0's draw's."""
    L = n_layers or cfg.n_layers
    one = cfg.replace(n_layers=1)
    stack, report, rest = None, None, None

    def alloc(node):
        if isinstance(node, dict):
            return {k: alloc(v) for k, v in node.items()}
        if hasattr(node, "variant"):
            return type(node)(node.variant, node.shape, {
                k: torch.empty((L,) + v.shape[1:], dtype=v.dtype, device=dev)
                for k, v in node.data.items()})
        return torch.empty((L,) + node.shape[1:], dtype=node.dtype,
                           device=dev)

    def put(dst, src, li):
        if isinstance(dst, dict):
            for k in dst:
                put(dst[k], src[k], li)
        elif hasattr(dst, "variant"):
            for k, v in dst.data.items():
                v[li] = src.data[k][0]
        else:
            dst[li] = src[0]

    for li in range(L):
        p = T.init_params(one, torch.Generator(device=dev).manual_seed(
            _layer_seed(seed, li)), device=dev)
        q, rep = quantize_params({"layers": p.pop("layers")}, policy)
        if li == 0:
            stack, report = alloc(q["layers"]), rep
            rest, rest_rep = quantize_params(p, policy)
            report.update(rest_rep)
        put(stack, q["layers"], li)
        del p, q
    rest["layers"] = stack
    return rest, report


def _same_trees(torch, a, b) -> bool:
    qa, qb = ({k: v for k, v in _leaves(t) if hasattr(v, "variant")}
              for t in (a, b))
    return sorted(qa) == sorted(qb) and all(
        qa[k].variant == qb[k].variant and _same_payloads(torch, qa[k], qb[k])
        for k in qa)


def phase_build_vl(torch, cfg, T, quantize_params, variant_counts, policy,
                   PB, dev):
    """qwen2-vl-72b's packed tree at full width and depth, a layer at a
    time; first, at 2 layers, the layer-at-a-time tree against packing
    the 2-layer float stack at once, byte for byte."""
    two, _ = build_by_layer(torch, cfg, T, quantize_params, policy, dev,
                            n_layers=2)
    floats = [T.init_params(cfg.replace(n_layers=1), torch.Generator(
        device=dev).manual_seed(_layer_seed(0, li)), device=dev)
        for li in range(2)]
    cat = dict(floats[0])
    cat["layers"] = _cat_layers(torch, floats[0]["layers"],
                                floats[1]["layers"])
    del floats
    whole, _ = quantize_params(cat, policy)
    del cat
    same = _same_trees(torch, two, whole)
    print(f"[vl] 2 layers at full width: packed a layer at a time == the "
          f"2-layer stack packed at once, byte for byte: {same}",
          flush=True)
    check(same, "qwen2-vl: the layer-at-a-time packing differs")
    del two, whole
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    qp, report = build_by_layer(torch, cfg, T, quantize_params, policy, dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    sizes = {"packed": sum(t.nbytes for t in _packed(qp))}
    sizes["float"] = sum(v.numel() * v.element_size()
                         for v in _float_leaves(qp))
    counts = variant_counts(report, qp)
    print(f"[vl] full-width {cfg.name}, {cfg.n_layers} layers, built a "
          f"layer at a time under {policy.name} in {build_s:.1f}s: {counts} "
          f"matmuls; packed {sizes['packed'] / 1e9:.3f} GB + float "
          f"{sizes['float'] / 1e9:.4f} GB; peak "
          f"torch.cuda.max_memory_allocated {peak:.2f} GB", flush=True)
    check(counts == VL_COUNTS, f"qwen2-vl layout {counts}, expected "
          f"{VL_COUNTS}")
    check_shapes(torch, qp, cfg, PB, dev)
    return qp, dict(build_s=build_s, peak_allocated_gb=peak,
                    packed_gb=sizes["packed"] / 1e9,
                    float_gb=sizes["float"] / 1e9, matmuls=counts)


def _cat_layers(torch, a, b):
    if isinstance(a, dict):
        return {k: _cat_layers(torch, a[k], b[k]) for k in a}
    return torch.cat([a, b])


def phase_embed_serve(torch, cfg, qp, S, T, PB, PA, dev, tag):
    """Phases 36-37's serving: ``make_serve_steps`` under the fused
    attention. Prefill 2 rows of ``EMBED_PROMPT`` seeded f32 embeddings
    (three distinct M-RoPE streams where the model has them), then
    ``cache_from_prefill`` into a ``EMBED_CACHE``-slot ring, then
    ``EMBED_DECODE`` decode steps on seeded embeddings; the launch counts
    zeroed just before and read just after each; finite logits. The first
    decode step's logits against ``forward_seq``'s last position over the
    same prompt + 1 embeddings (argmax equal, or the margin rule; max
    error relative to the largest logit within ``TOL_EMBED_STEP``)."""
    cfgf = cfg.replace(attn_impl="fused")
    prefill, decode = S.make_serve_steps(cfgf)
    B, P, N = 2, EMBED_PROMPT, EMBED_DECODE
    g = torch.Generator(device=dev).manual_seed(31)
    emb, pos = embed_inputs(torch, cfg, B, P + N, g, dev)
    per_forward = _per_forward(qp, cfg)

    def batch(n):
        b = {"embeds": emb[:, :n]}
        if pos is not None:
            b["positions"] = pos[:, :, :n]
        return b
    prefill(qp, batch(16))                       # warm-up: allocator, cuBLAS
    torch.cuda.synchronize()
    PB.reset_launches()
    PA.reset_launches()
    t0 = time.perf_counter()
    logits, caches = prefill(qp, batch(P))
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    got = (dict(PB.launches), PA.launches["prefill_attn"])
    want = ({v: per_forward.get(v, 0) for v in PB.VARIANTS}, cfg.n_layers)
    print(f"[{tag}] prefill of {B} x {P} embeddings in {prefill_s * 1e3:.1f} "
          f"ms ({B * P / prefill_s:.1f} tok/s): launches {got[0]}, "
          f"prefill_attn {got[1]}", flush=True)
    check(got == want, f"{tag} prefill launches {got}, expected {want}")
    check(logits.shape == (B, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()), f"{tag}: bad prefill logits")
    cache = T.cache_from_prefill(cfgf, caches, P, cache_len=EMBED_CACHE)
    del caches
    check(cache["k"].shape[2] == EMBED_CACHE
          and int(cache["pos"][0, P - 1]) == P - 1
          and int(cache["pos"][0, P]) == -1, f"{tag}: cache_from_prefill")
    # the controls of the decode-vs-forward_seq check, on copies of the
    # ring: the first step at position P + 1 (its rotary position and slot
    # off by one), and on a ring whose layers are rolled by one (each
    # layer reads the K/V of the layer below)
    control = {}
    for name in ("position off by one", "ring layers rolled by one"):
        ring = {k: v.clone() for k, v in cache.items()}
        at = P + 1 if name == "position off by one" else P
        if name == "ring layers rolled by one":
            ring["k"], ring["v"] = ring["k"].roll(1, 0), ring["v"].roll(1, 0)
        control[name] = decode(qp, ring, {
            "embeds": emb[:, P],
            "position": torch.full((B,), at, dtype=torch.long,
                                   device=dev)})[0]
        del ring
    PB.reset_launches()
    PA.reset_launches()
    steps, first = [], None
    for j in range(N):
        position = torch.full((B,), P + j, dtype=torch.long, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, cache = decode(qp, cache, {"embeds": emb[:, P + j],
                                       "position": position})
        torch.cuda.synchronize()
        steps.append((time.perf_counter() - t0) * 1e3)
        check(bool(torch.isfinite(lg).all()), f"{tag}: decode step {j} "
              "logits not finite")
        if j == 0:
            first = lg.clone()
    dec_got = (dict(PB.launches), PA.launches["prefill_attn"])
    want = ({v: N * per_forward.get(v, 0) for v in PB.VARIANTS}, 0)
    print(f"[{tag}] {N} decode steps (B={B}): median "
          f"{statistics.median(steps):.2f} ms a step (host clock after a "
          f"sync), launches {dec_got[0]}, prefill_attn {dec_got[1]}",
          flush=True)
    check(dec_got == want, f"{tag} decode launches {dec_got}, expected "
          f"{want}")
    seq = T.forward_seq(qp, cfgf, **batch(P + 1))[:, -1]
    err = float((first - seq).abs().max() / seq.abs().max())
    control = {k: float((v - seq).abs().max() / seq.abs().max())
               for k, v in control.items()}
    top2 = torch.topk(seq, 2, dim=-1).values
    margin = float((top2[:, 0] - top2[:, 1]).min())
    same = bool(torch.equal(first.argmax(-1), seq.argmax(-1)))
    print(f"[{tag}] decode step 0 vs forward_seq's position {P} over "
          f"{P + 1} embeddings: rel {err:.2e} (tol {TOL_EMBED_STEP:.2e}), "
          f"argmax equal {same} (top-2 margin {margin:.4f}); controls: "
          + ", ".join(f"{k} {v:.2e}" for k, v in control.items()),
          flush=True)
    check(err <= TOL_EMBED_STEP, f"{tag}: decode step vs forward_seq")
    check(same or margin < MARGIN_TOL, f"{tag}: argmax differs past the "
          "margin rule")
    check(min(control.values()) > TOL_EMBED_STEP, f"{tag}: a control of "
          f"the decode check reads within its tolerance: {control}")
    del seq
    # one decode step: its span, and its kernels' device time
    position = torch.full((B,), P + N, dtype=torch.long, device=dev)
    step = lambda: decode(qp, cache, {"embeds": emb[:, -1],  # noqa: E731
                                      "position": position})
    span = _device_ms(torch, step, 3)
    prof = _profile(torch, step)
    wbytes = sum(t.nbytes for t in _packed(qp)) + sum(
        v.numel() * v.element_size() for v in _float_leaves(qp))
    ring = sum(cache[k].numel() * cache[k].element_size()
               for k in ("k", "v"))
    bound = (wbytes + ring) / HBM_BYTES_PER_S * 1e3
    out = dict(prefill_ms=prefill_s * 1e3,
               prefill_tok_per_s=B * P / prefill_s,
               decode_step_ms=statistics.median(steps),
               decode_step_span_ms=span, decode_step_bound_ms=bound,
               decode_vs_forward_rel=err, decode_controls_rel=control,
               argmax_equal=same, per_forward=per_forward,
               launches={v: got[0][v] + dec_got[0][v] for v in PB.VARIANTS},
               attn_launches=got[1] + dec_got[1])
    if prof is not None:
        out.update(decode_kernel_ms=prof[0], decode_launches=prof[1],
                   decode_top_kernels=prof[2])
    print(f"[{tag}] one decode step (B={B}): {span:.2f} ms between CUDA "
          f"events; kernels " + ("not measured (the profiler shows no "
                                 "device time)" if prof is None else
                                 f"{prof[0]:.2f} ms of device time in "
                                 f"{prof[1]} launches (torch.profiler)")
          + f"; bound {bound:.2f} ms ({(wbytes + ring) / 1e9:.2f} GB of "
          f"weights and ring at {HBM_BYTES_PER_S / 1e12:.2f} TB/s)"
          + ("" if prof is None else "; most device time: " + "; ".join(
              f"{k} x{c} {ms:.3f} ms" for k, c, ms in prof[2][:5])),
          flush=True)
    return out


def phase_embed_attn_timing(torch, PA, cfg, B, S, dev, tag):
    """The attention launches of one prefill (``forward_seq`` under the
    fused attention: q_pos = kv_pos = 0..S-1, f32 q/k/v, as the f32
    embeddings give) at the model's shape, held against the plain version
    on the visible rows and timed beside its bound, the plain version and
    ``scaled_dot_product_attention``."""
    g = torch.Generator(device=dev).manual_seed(33)
    H, KH, D = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    jobs = [attn_inputs(torch, dev, B, S, H, KH, D, 0, 0, torch.float32, g)
            for _ in range(cfg.n_layers)]
    q, k, v, qp, kp = jobs[0]
    vis = visible_rows(qp, kp, None)
    err = rel_err(PA.prefill_attn_cuda(q, k, v, qp, kp),
                  PA.prefill_attn_plain(q, k, v, qp, kp))
    check(err <= TOL_ATTN, f"{tag}: attention at (B={B}, S={S}, H={H}, "
          f"KH={KH}, D={D}) rel {err}")
    kern = _device_ms(torch, lambda: [PA.prefill_attn_cuda(*j)
                                      for j in jobs], 5)
    plain = _device_ms(torch, lambda: [PA.prefill_attn_plain(*j)
                                       for j in jobs], 2)
    lib = _sdpa_ms(torch, jobs)
    nbytes = len(jobs) * (2 * q.numel() * q.element_size()
                          + 2 * k.numel() * k.element_size()
                          + (qp.numel() + kp.numel()) * 4)
    flops = len(jobs) * int(vis.sum()) * H * 4 * D
    res = _timing(kern, plain, lib, nbytes, flops, len(jobs),
                  peak=F32_3XTF32_FLOPS_PER_S)
    res["max_rel_err"] = err
    print(f"[{tag}] prefill_attn prefill forward ({len(jobs)} launches, "
          f"B={B} S={S} H={H} KH={KH} D={D}, f32): kernel vs plain rel "
          f"{err:.2e} (tol {TOL_ATTN:.0e}); kernel {kern:.3f} ms, bound "
          f"{res['bound_ms']:.4f} ms ({res['bound_by']}, {nbytes / 1e6:.1f} "
          f"MB, {flops / 1e9:.2f} GFLOP at the 3xTF32 rate), plain "
          f"{plain:.3f} ms, scaled_dot_product_attention {lib:.3f} ms; x "
          f"lib {kern / lib:.2f}", flush=True)
    return res


def phase_train_embed(torch, np, get_arch, S, AdamWConfig, leaves, dev):
    """Phase 38: one make_train_step step (2 microbatches) of each
    embedding-input family: reduced, card against CPU at the
    ``TOL_TRAIN_*`` tolerances (phase 31's check, on embeddings and, for
    qwen2-vl, (3, B, S) positions); then full width, depth cut, on the
    card alone: a finite loss and gradient norm, the peak memory above
    what was allocated before. Where the update cannot fit
    (``EMBED_TRAIN``), the step's loss and gradients
    (``steps.value_and_grad``) run without it."""
    out = {}
    for arch, depth, update in EMBED_TRAIN:
        out[arch] = {"card_vs_cpu": phase_train_card_vs_cpu(
            torch, np, get_arch, S, AdamWConfig, leaves, dev, arch=arch)}
        cfg = get_arch(arch).replace(n_layers=depth)
        opt = AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=10)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated() / 1e9
        gen = torch.Generator(device=dev).manual_seed(0)
        batch = train_batch(torch, np, cfg, 4, 256, dev)
        t0 = time.perf_counter()
        if update:
            state = S.init_train_state(cfg, opt, gen, device=dev)
            state, m = S.make_train_step(cfg, opt, microbatches=2)(state,
                                                                    batch)
            loss, gnorm = float(m["loss"]), float(m["grad_norm"])
            params = state["params"]
            del state
        else:
            params = S.T.init_params(cfg, gen, device=dev)
            loss, _, grads = S.value_and_grad(S.make_loss_fn(cfg), params,
                                              batch)
            loss = float(loss)
            gnorm = float(torch.stack([g.float().norm()
                                       for g in leaves(grads)]).norm())
            del grads
        step_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 1e9 - base
        n = _n_params(params)
        check(np.isfinite(loss) and np.isfinite(gnorm),
              f"{arch}: loss {loss}, grad norm {gnorm}")
        out[arch]["full"] = {"layers": depth, "params": n, "loss": loss,
                             "grad_norm": gnorm, "update": update,
                             "step_s": step_s, "peak_allocated_gb": peak}
        what = ("a train step in 2 microbatches" if update else
                "loss and gradients, no update (the step ran out of memory "
                "in its update)")
        print(f"[train] {arch} at full width, {depth} of "
              f"{get_arch(arch).n_layers} layers ({n:,} params), 4 x 256 "
              f"embeddings, {what}: loss {loss:.4f}, grad norm {gnorm:.4f}, "
              f"{step_s:.2f}s (the first), peak "
              f"torch.cuda.max_memory_allocated {peak:.2f} GB above the "
              f"{base:.2f} GB allocated before", flush=True)
        del params
        torch.cuda.empty_cache()
    return out


def train_batch(torch, np, cfg, B, S_, where, seed=0):
    """A seeded batch: tokens, or f32 embeddings (with (3, B, S) M-RoPE
    positions of three distinct streams where the model has them), then
    labels."""
    rng = np.random.default_rng(seed)
    b = {}
    if cfg.embed_input:
        b["tokens"] = rng.integers(0, cfg.vocab_size, (B, S_)).astype(
            np.int32)
    else:
        b["embeds"] = rng.standard_normal((B, S_, cfg.d_model)).astype(
            np.float32)
    b["labels"] = rng.integers(0, cfg.vocab_size, (B, S_)).astype(np.int32)
    if cfg.pos_emb == "mrope":
        t = np.arange(S_)
        b["positions"] = np.broadcast_to(
            np.stack([t // 16, (t // 4) % 4, t % 4])[:, None],
            (3, B, S_)).astype(np.int32)
    return {k: torch.from_numpy(v).to(where) for k, v in b.items()}


def phase_slice11(torch, np, get_arch, T, quantize_params, variant_counts,
                  get_policy, resolve_policy, Engine, ServeConfig, PB, PA, Q,
                  dev):
    """Phases 35-38. Returns (matmul launches by path, attention launches
    by path, per-shape timing by arch, results for the summary line)."""
    from repro_torch.optim.adamw import AdamWConfig, tree_leaves
    from repro_torch.training import steps as S
    launches, attn, timing, out = {}, {}, {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        l35, out["search"] = phase_search_families(
            torch, np, get_arch, T, resolve_policy, quantize_params,
            variant_counts, Engine, ServeConfig, PB, PA, dev, tmp)
    launches.update(l35)
    policy = get_policy(EMBED_POLICY)
    for arch in EMBED_MODELS:
        t_phase = time.perf_counter()
        cfg = get_arch(arch)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        if arch == "qwen2-vl-72b":
            qp, res = phase_build_vl(torch, cfg, T, quantize_params,
                                     variant_counts, policy, PB, dev)
        else:
            qp = pack_full_width(torch, cfg, T, quantize_params,
                                 variant_counts, get_policy, EMBED_POLICY,
                                 dev, MUSICGEN_COUNTS, PB)
            res = {}
        PB.reset_launches()
        PA.reset_launches()
        res["serve"] = phase_embed_serve(torch, cfg, qp, S, T, PB, PA, dev,
                                         f"embed {arch}")
        res["peak_allocated_gb_serve"] = torch.cuda.max_memory_allocated() / 1e9
        # launches of the main path, as counted: one prefill and
        # EMBED_DECODE steps
        launches[f"{arch}_serve_steps"] = res["serve"]["launches"]
        attn[f"{arch}_serve_steps"] = res["serve"]["attn_launches"]
        timing[arch] = phase_shape_timing(torch, qp, cfg, PB, Q, dev,
                                          "embed timing",
                                          layers=EMBED_TIMED_LAYERS)
        if arch == "qwen2-vl-72b":
            g = torch.Generator(device=dev).manual_seed(34)
            # layer 0's view, not held past the call: it keeps the whole
            # 80-layer payload (20.6 GB) alive
            shape = qp["layers"]["mlp"]["w_down"].shape
            ok = rows_of_weight(torch, PB,
                                qp["layers"]["mlp"]["w_down"].layer(0), dev,
                                g)
            print(f"[embed timing] {arch} q8_0 w_down {shape} (K % 256 = "
                  f"{shape[0] % 256}: the last 256-row tile partial): rows "
                  f"of M=512 and 128 == M=1 bit for bit: {ok}", flush=True)
            check(ok, f"{arch}: a row of the q8_0 w_down product depends "
                  "on M")
            res["q8_0_rows_independent_of_m"] = ok
        del qp
        torch.cuda.empty_cache()
        res["attn_timing"] = phase_embed_attn_timing(
            torch, PA, cfg, 2, EMBED_PROMPT, dev, "embed timing")
        res["wall_s"] = time.perf_counter() - t_phase
        print(f"[embed] {arch} phase {36 if arch == 'qwen2-vl-72b' else 37}"
              f" took {res['wall_s']:.1f}s", flush=True)
        out[arch] = res
    t_phase = time.perf_counter()
    out["train"] = phase_train_embed(torch, np, get_arch, S, AdamWConfig,
                                     tree_leaves, dev)
    print(f"[train] phase 38 took {time.perf_counter() - t_phase:.1f}s",
          flush=True)
    return launches, attn, timing, out


# ---------------------------------------------------------------------------
# slice 12: tensor- and expert-parallel serving
# ---------------------------------------------------------------------------

def rank_launches(reset=False):
    """This rank's matmul launches by variant and attention launches (each
    rank of a group counts its own; ``TPGroup.map`` reads them all),
    zeroed after reading with ``reset``."""
    from repro_torch.kernels import bfp_matmul as PB
    from repro_torch.kernels import prefill_attn as PA
    out = (dict(PB.launches), PA.launches["prefill_attn"])
    if reset:
        PB.reset_launches()
        PA.reset_launches()
    return out


def _reset_all(torch, PB, PA, group):
    """Zero the launch counts of every rank of ``group``."""
    torch.cuda.synchronize()
    group.map(rank_launches, [(True,)] * group.size)


def _tp_prompts(np, cfg):
    rng = np.random.default_rng(12)
    shared = [int(t) for t in rng.integers(0, cfg.vocab_size, TP_SHARED)]
    return [shared + [int(t) for t in rng.integers(0, cfg.vocab_size, n)]
            for n in rng.integers(*TP_SUFFIX, TP_REQUESTS)]


def _tp_kw(spec, prefix):
    return dict(TP_SERVE, **(TP_SPEC if spec else {}),
                **(TP_PREFIX if prefix else {}))


def _tp_runs(eng, prompts, prefix):
    """Cold (and, with the prefix cache, warm) runs: (tokens a run, the
    runs' summed forwards, prefill forwards and the last run's stats)."""
    outs, fwd, pfwd = [], 0, 0
    for _ in range(1 + prefix):
        outs.append(eng.generate(prompts))
        fwd += eng.stats["forwards"]
        pfwd += eng.stats["prefill_forwards"]
    return outs, fwd, pfwd, dict(eng.stats)


def phase_tp_serve(torch, cfg, qp, prompts, Engine, ServeConfig, PB, PA,
                   group, refs, dev):
    """Phase 39 at one degree: the padded datapath over the speculation x
    prefix-cache matrix, every rank on cuda:0; tokens (cold and warm) equal
    tp=1's, the prefix hits and draft acceptances too; every forward
    launches the paper mix's 45 + 110 matmul kernels and every
    prefill-chunk forward 22 attention kernels (fused, at H/tp heads), on
    rank 0 and, read through the group, on every other rank."""
    tp = group.size
    launches, attn, out = {}, {}, {}
    for spec, prefix in TP_MATRIX:
        key = f"tp{tp}_padded_{'ngram' if spec else 'plain'}_" \
              f"{'prefix' if prefix else 'noprefix'}"
        kw = _tp_kw(spec, prefix)
        if (spec, prefix) not in refs:
            with Engine(cfg, qp, ServeConfig(**kw), device=dev) as e1:
                refs[(spec, prefix)] = _tp_runs(e1, prompts, prefix)
        want, _, _, s1 = refs[(spec, prefix)]
        with Engine(cfg, qp, ServeConfig(tp=tp, **kw), group=group) as eng:
            _reset_all(torch, PB, PA, group)
            t0 = time.perf_counter()
            got, fwd, pfwd, s = _tp_runs(eng, prompts, prefix)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            ranks = group.map(rank_launches, [()] * tp)
        lau, at = dict(PB.launches), PA.launches["prefill_attn"]
        print(f"[tp] {key}: {len(got)} run(s) of {len(prompts)} requests in "
              f"{wall:.2f}s, {fwd} forwards ({pfwd} prefill chunks), "
              f"tokens == tp=1: {got == want}; prefix hits {s['prefix_hits']}"
              f" (tp=1 {s1['prefix_hits']}), drafts "
              f"{s['draft_accepted']}/{s['draft_tokens']} (tp=1 "
              f"{s1['draft_accepted']}/{s1['draft_tokens']})", flush=True)
        check(got == want, f"{key}: tokens differ from tp=1")
        check((s["prefix_hits"], s["draft_tokens"], s["draft_accepted"])
              == (s1["prefix_hits"], s1["draft_tokens"],
                  s1["draft_accepted"]), f"{key}: stats differ from tp=1")
        if prefix:
            check(s["prefix_hits"] > 0, f"{key}: the warm run missed")
        _check_launches(f"tp {key}", PB, lau, {"forwards": fwd,
                                               "draft_forwards": 0},
                        TP_PER_FORWARD)
        check(at == cfg.n_layers * pfwd,
              f"{key}: {at} attention launches over {pfwd} prefill chunks")
        check(all(r == (lau, at) for r in ranks),
              f"{key}: ranks launched {ranks}, rank 0 {(lau, at)}")
        launches[key], attn[key] = lau, at
        out[key] = {"wall_s": wall, "forwards": fwd,
                    "decode_tok_per_s": s["tok_per_s"],
                    "prefill_tok_per_s": s["prefill_tok_per_s"]}
    return launches, attn, out


def phase_tp_sliced(torch, np, cfg, qp, fp, prompts, Engine, ServeConfig,
                    PB, group, refs, dev):
    """Phase 40 at one degree: first-token logits (``Engine.prefill_logits``)
    of each datapath against tp=1's: "padded" bit for bit; on the packed
    weights ``qp`` "sliced" (f32 activations) and "sliced_row" (f32 and
    bf16) within ``TOL_TP_ROW``; on the float weights ``fp`` in f32 both
    printed beside ``TOL_TP_FLOAT_REFERENCE`` (a record). At tp=4
    "sliced_row" takes "dequant" for w_down (K = 5632) and "packed" for
    wo (K = 2048); the packed mode's partials run the kernel with f32
    output."""
    tp = group.size
    L = cfg.n_layers
    cases = (("packed", qp, "float32", {"padded": 0.0, "sliced": TOL_TP_ROW,
                                         "sliced_row": TOL_TP_ROW}),
             ("packed", qp, "bfloat16", {"padded": 0.0,
                                          "sliced_row": TOL_TP_ROW}),
             ("float", fp, "float32", {"sliced": None, "sliced_row": None}))
    out, launches = {}, {}
    for weights, params, dtype, tols in cases:
        c = cfg.replace(dtype=dtype)
        if (weights, dtype) not in refs:
            with Engine(c, params, ServeConfig(**TP_SERVE),
                        device=dev) as e1:
                refs[(weights, dtype)] = e1.prefill_logits(prompts)
        ref = refs[(weights, dtype)]
        top = float(np.abs(ref).max())
        for mm, tol in tols.items():
            with Engine(c, params, ServeConfig(tp=tp, tp_matmul=mm,
                                               **TP_SERVE),
                        group=group) as eng:
                PB.reset_launches()
                got = eng.prefill_logits(prompts)
                fwd = eng.stats["forwards"]
                plan = eng._plan
            key = f"tp{tp}_{mm}_{weights}_{dtype}"
            launches[key] = dict(PB.launches)
            err = float(np.abs(got - ref).max()) / top
            gate = (f"tol {tol:.0e}" if tol is not None else
                    f"a record: the reference's {TOL_TP_FLOAT_REFERENCE:.0e}"
                    " was set at 2 reduced layers")
            print(f"[tp] {key} logits ({len(prompts)} prompts, {fwd} "
                  f"prefill forwards) vs tp=1: max |diff| / max|ref| "
                  f"{err:.3e} ({gate}); row modes attn {plan.attn_row!r} "
                  f"mlp {plan.mlp_row!r}; launches {launches[key]}",
                  flush=True)
            if tol == 0.0:
                check(np.array_equal(got, ref), f"{key}: padded != tp=1")
            elif tol is not None:
                check(np.allclose(got, ref, rtol=tol, atol=tol * top),
                      f"{key}: logits outside the tolerance")
            if mm == "sliced_row" and weights == "packed":
                want = ("packed", "dequant" if tp == 4 else "packed")
                check((plan.attn_row, plan.mlp_row) == want,
                      f"{key}: row modes {plan.attn_row!r}, "
                      f"{plan.mlp_row!r}, expected {want}")
                # wo's row-parallel partials run the kernel (f32 out);
                # w_down's too where it is "packed"
                per = {"q2_k": 2 * L + 1,
                       "q3_k": 5 * L - (L if tp == 4 else 0)}
                check(launches[key] == {v: per.get(v, 0) * fwd
                                        for v in PB.VARIANTS},
                      f"{key}: launches {launches[key]}")
            out[key] = err
    return launches, out


def phase_tp_moe(torch, np, get_arch, T, quantize_params, variant_counts,
                 get_policy, Engine, ServeConfig, PB, group, dev):
    """Phase 41: full-width olmoe-1b-7b (8 layers, phase 21's cut) at tp=2
    with expert parallelism (each rank the products of 32 of the 64
    experts, whose packed rows it cuts before it dequantizes): phase 21's
    traffic gives the tp=1 tokens, and those of tp=2 with EP off."""
    arch, depth, counts, per_forward = MOE_MODELS[0]
    cfg = get_arch(arch).replace(n_layers=depth)
    qp = pack_full_width(torch, cfg, T, quantize_params, variant_counts,
                         get_policy, MOE_POLICY, dev, counts, PB)
    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size,
                                             PROMPT_LEN)]
               for _ in range(N_REQUESTS)]
    res, walls = {}, {}
    with Engine(cfg, qp, ServeConfig(**SERVE), device=dev) as e1:
        t0 = time.perf_counter()
        res["tp1"] = e1.generate(prompts)
        walls["tp1"] = time.perf_counter() - t0
    launches = {}
    for ep in (True, False):
        key = f"tp{group.size}_{'ep' if ep else 'no_ep'}"
        with Engine(cfg, qp, ServeConfig(tp=group.size, tp_ep=ep, **SERVE),
                    group=group) as eng:
            check(eng._plan.moe_ep == ep, f"{key}: plan {eng._plan}")
            PB.reset_launches()
            t0 = time.perf_counter()
            res[key] = eng.generate(prompts)
            walls[key] = time.perf_counter() - t0
            fwd = eng.stats["forwards"]
        launches[f"{arch}_{key}"] = dict(PB.launches)
        _check_launches(f"tp {arch} {key}", PB, dict(PB.launches),
                        {"forwards": fwd, "draft_forwards": 0}, per_forward)
    for key in ("tp2_ep", "tp2_no_ep"):
        print(f"[tp] {arch} ({depth} layers) {key} tokens == tp=1: "
              f"{res[key] == res['tp1']} ({walls[key]:.2f}s, tp=1 "
              f"{walls['tp1']:.2f}s)", flush=True)
        check(res[key] == res["tp1"], f"{arch} {key}: tokens differ")
    del qp
    torch.cuda.empty_cache()
    return launches, {k: round(v, 3) for k, v in walls.items()}


def _embedded(torch, SH, ops, t, r, tp):
    """Rank r's zero-embedded full-width view of ``t`` (the padded
    datapath's weight)."""
    with SH.serve_tp(SH.ServeTPPlan(size=tp), r, group=True):
        return ops.tp_embed_lanes(SH.lane_shard_qtensor(t, r, tp))


def phase_tp_kernels(torch, np, cfg, qp, Q, PB, PA, SH, ops, dev,
                     attn_layers):
    """Phase 42: the kernels at every new launch shape of phases 39-41.
    The matmul against its plain version (f32 and bf16 out, decode M and a
    prefill chunk's M): the zero-embedded full-width weights of "padded"
    (whose rank columns equal the whole weight's bit for bit and whose
    other columns are zero), the lane slices of "sliced" (strided views)
    and the K-row slices of "sliced_row" with f32 output, each timed at
    decode M beside its bound, the plain version and torch.matmul on the
    dequantized bf16 slice. The attention at a rank's heads (H/tp, KH/tp)
    against its plain version, timed over a prefill-chunk forward's 22
    launches (``attn_layers``: the full model's) beside
    scaled_dot_product_attention."""
    g = torch.Generator(device=dev).manual_seed(42)
    lay = {n: qp["layers"][b][n].layer(0) for b, n in (
        ("attn", "wq"), ("attn", "wk"), ("attn", "wv"), ("attn", "wo"),
        ("mlp", "w_gate"), ("mlp", "w_up"), ("mlp", "w_down"))}
    cases = []
    for tp in TP_DEGREES:
        r = tp - 1
        for name, t in lay.items():
            cases.append((f"padded tp{tp} {name}", t,
                          _embedded(torch, SH, ops, t, r, tp), r, tp))
            cases.append((f"sliced tp{tp} {name}",
                          t, SH.lane_shard_qtensor(t, r, tp), r, tp))
        for name in ("wo", "w_down"):
            t = lay[name]
            if t.shape[0] % (tp * 256) == 0:
                cases.append((f"sliced_row tp{tp} {name} (f32 out)", None,
                              SH.row_shard_qtensor(t, r, tp), r, tp))
    M_PF = TP_SERVE["prefill_batch"] * TP_SERVE["prefill_chunk"]
    worst, rows = 0.0, {}
    for name, whole, w, r, tp in cases:
        K, N = w.shape
        for M in (TP_SERVE["max_slots"], M_PF):
            x = torch.randn(M, K, generator=g, device=dev).bfloat16()
            y = PB.bfp_matmul_cuda(x, w, out_dtype=torch.float32)
            ref = PB.bfp_matmul_plain(x, w, out_dtype=torch.float32)
            yb, rb = PB.bfp_matmul_cuda(x, w), PB.bfp_matmul_plain(x, w)
            torch.cuda.synchronize()
            e32, e16 = rel_err(y, ref), rel_err(yb, rb)
            worst = max(worst, float((y - ref).abs().max()))
            check(bool(torch.isfinite(y).all()), f"{name}: non-finite")
            check(e32 <= TOL_F32 and e16 <= TOL_BF16,
                  f"{name} M={M}: rel {e32:.2e} / {e16:.2e}")
            if whole is not None and N == whole.shape[1]:
                n = N // tp
                full = PB.bfp_matmul_cuda(x, whole, out_dtype=torch.float32)
                same = torch.equal(y[:, r * n:(r + 1) * n],
                                   full[:, r * n:(r + 1) * n])
                zero = bool((y[:, :r * n] == 0).all()
                            and (y[:, (r + 1) * n:] == 0).all())
                check(same and zero, f"{name} M={M}: padded columns "
                      f"(same {same}, zeros {zero})")
            elif whole is not None:
                # "sliced": the reference's contract, this rank's columns
                # within an f32 reassociation of the whole product's (the
                # K split follows N)
                full = PB.bfp_matmul_cuda(x, whole, out_dtype=torch.float32)
                e_whole = rel_err(y, full[:, r * N:(r + 1) * N])
                check(e_whole <= TOL_F32, f"{name} M={M}: columns "
                      f"{e_whole:.2e} off the whole product's")
        M = TP_SERVE["max_slots"]
        x = torch.randn(M, K, generator=g, device=dev).bfloat16()
        wd = Q.dequantize(w, torch.bfloat16)
        kern = _device_ms(torch, lambda: PB.bfp_matmul_cuda(x, w), 20)
        plain = _device_ms(torch, lambda: PB.bfp_matmul_plain(x, w), 5)
        lib = _device_ms(torch, lambda: torch.matmul(x, wd), 20)
        nbytes = x.numel() * 2 + w.nbytes + M * N * 2
        res = _timing(kern, plain, lib, nbytes, 2 * M * K * N, 1)
        res.update(max_abs_err=float((y - ref).abs().max()),
                   shape=[M, K, N], variant=w.variant,
                   k_splits=PB.k_splits(K, N))
        rows[name] = res
        cols = ("; rank columns == the whole weight's, the others 0"
                if name.startswith("padded") else
                f"; columns {e_whole:.1e} off the whole product's"
                if name.startswith("sliced ") else "")
        print(f"[tp kernels] {name} {w.variant} ({K}, {N}) M={M}: kernel "
              f"{kern:.4f} ms, bound {res['bound_ms']:.4f} ms "
              f"({res['bound_by']}), plain {plain:.4f} ms, torch.matmul "
              f"{lib:.4f} ms; f32 rel {e32:.1e}, bf16 rel {e16:.1e}{cols}",
              flush=True)
    attn_rows, attn_worst = {}, 0.0
    B, C, _, _, D, T_ring = ATTN_SERVE
    for H, KH in TP_ATTN:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, qp_, kp = attn_inputs(torch, dev, B, C, H, KH, D,
                                           T_ring, 256, dtype, g, pad=17)
            y = PA.prefill_attn_cuda(q, k, v, qp_, kp)
            ref = PA.prefill_attn_plain(q, k, v, qp_, kp)
            torch.cuda.synchronize()
            vis = visible_rows(qp_, kp, None).any(-1)
            err = rel_err(y[vis], ref[vis])
            tol = TOL_ATTN if dtype == torch.float32 else TOL_BF16
            check(bool(torch.isfinite(y[vis]).all()) and err <= tol,
                  f"prefill_attn H={H} KH={KH} {dtype}: rel {err:.2e}")
            if dtype == torch.float32:
                attn_worst = max(attn_worst,
                                 float((y - ref)[vis].abs().max()))
            print(f"[tp kernels] prefill_attn H={H} KH={KH} {dtype}: rel "
                  f"{err:.2e} (tol {tol:.1e})", flush=True)
        jobs = [attn_inputs(torch, dev, B, C, H, KH, D, T_ring, 256,
                            torch.bfloat16, g) for _ in range(attn_layers)]
        kern = _device_ms(torch, lambda: [PA.prefill_attn_cuda(*j)
                                          for j in jobs], 10)
        plain = _device_ms(torch, lambda: [PA.prefill_attn_plain(*j)
                                           for j in jobs], 3)
        lib = _sdpa_ms(torch, jobs)
        nbytes = sum(2 * q.numel() * q.element_size()
                     + (qp_.numel() + kp.numel()) * kp.element_size()
                     + 2 * int(visible_rows(qp_, kp, None).any(1).sum())
                     * KH * D * k.element_size()
                     for q, k, _, qp_, kp in jobs)
        pairs = sum(int(visible_rows(qp_, kp, None).sum())
                    for _, _, _, qp_, kp in jobs)
        res = _timing(kern, plain, lib, nbytes, pairs * H * 4 * D,
                      len(jobs))
        attn_rows[f"H{H}_KH{KH}"] = res
        print(f"[tp kernels] prefill_attn prefill-chunk forward at a rank's "
              f"heads ({len(jobs)} launches, B={B} C={C} H={H} KH={KH} "
              f"D={D}): kernel {kern:.3f} ms, bound {res['bound_ms']:.4f} ms"
              f" ({res['bound_by']}), plain {plain:.3f} ms, sdpa "
              f"{lib:.3f} ms", flush=True)
    return worst, rows, attn_worst, attn_rows


def _decode_chunk_timing(torch, eng, prompts):
    """Admit ``prompts``, run one decode chunk untimed, then time one
    chunk: its wall time (ends in the chunk's host sync), and, in another
    chunk under ``torch.profiler``, the device time of rank 0's kernels,
    the matmul kernels' part and the collectives rank 0 took part in."""
    from torch.profiler import ProfilerActivity, profile
    eng._reset()
    for p in prompts:
        eng.submit(p)
    eng._admit_pending()
    eng._run_chunk()
    torch.cuda.synchronize()
    group = eng._group
    if group is not None:
        c0, b0 = dict(group.counts), group.wire_bytes
    t0 = time.perf_counter()
    eng._run_chunk()
    wall = time.perf_counter() - t0
    steps = TP_DECODE["decode_chunk"]
    coll = ({k: (group.counts[k] - c0[k]) // steps for k in c0}
            if group is not None else None)
    wire = ((group.wire_bytes - b0) // steps if group is not None
            else None)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        eng._run_chunk()
        torch.cuda.synchronize()

    def dev_us(e):
        return (getattr(e, "self_device_time_total", 0)
                or getattr(e, "self_cuda_time_total", 0))
    ev = prof.key_averages()
    kern = sum(dev_us(e) for e in ev) / 1e3
    mm = sum(dev_us(e) for e in ev if "bfp_matmul" in e.key) / 1e3
    eng.run()
    return {"chunk_wall_ms": wall * 1e3, "step_wall_ms": wall * 1e3 / steps,
            "kernel_ms_per_step": kern / steps,
            "matmul_kernel_ms_per_step": mm / steps,
            "collectives_per_step": coll, "sent_bytes_per_step": wire}


def phase_tp_decode_timing(torch, cfg, qp, prompts, Engine, ServeConfig,
                           group, dev):
    """Phase 43: one decode chunk's wall time and kernel ms at tp=2 beside
    tp=1 (4 slots, 8 steps, paper_llama_mix, padded): a record of this
    machine's shared card and host-staged gloo, not a claim about TP."""
    with Engine(cfg, qp, ServeConfig(**TP_DECODE), device=dev) as e1:
        one = _decode_chunk_timing(torch, e1, prompts[:4])
    with Engine(cfg, qp, ServeConfig(tp=group.size, **TP_DECODE),
                group=group) as eng:
        two = _decode_chunk_timing(torch, eng, prompts[:4])
        backend = eng.tp_backend
    print(f"[tp decode] shared card, host-staged gloo ({backend}, ranks on "
          f"{', '.join(map(str, group.devices))}): a decode step "
          f"{two['step_wall_ms']:.1f} ms wall at tp={group.size} "
          f"({two['kernel_ms_per_step']:.3f} ms of rank 0's kernels, "
          f"{two['matmul_kernel_ms_per_step']:.3f} ms matmul; collectives a "
          f"step {two['collectives_per_step']}, {two['sent_bytes_per_step']} "
          f"bytes sent by rank 0) against "
          f"{one['step_wall_ms']:.1f} ms wall at tp=1 "
          f"({one['kernel_ms_per_step']:.3f} ms kernels, "
          f"{one['matmul_kernel_ms_per_step']:.3f} ms matmul)", flush=True)
    return {"backend": backend, "tp1": one, f"tp{group.size}": two,
            "note": "shared card, host-staged gloo: a record, not a claim"}


def phase_slice12(torch, np, get_arch, T, quantize_params, variant_counts,
                  get_policy, Engine, ServeConfig, PB, PA, Q, dev):
    """Phases 39-43 (module note). Returns (matmul launches by path,
    attention launches by path, the kernel rows at the TP shapes, the
    summary)."""
    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed.group import GroupCache
    from repro_torch.kernels import ops
    t_phase = time.perf_counter()
    cfg = get_arch(TP_ARCH).replace(attn_impl="fused", n_layers=TP_DEPTH)
    fp = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                       device=dev)
    qp, report = quantize_params(fp, get_policy(TP_POLICY))
    check(variant_counts(report, qp) == TP_PER_FORWARD,
          f"{TP_POLICY} layout: {variant_counts(report, qp)}")
    check_shapes(torch, qp, cfg, PB, dev)
    prompts = _tp_prompts(np, cfg)
    groups = GroupCache(lambda n: ["cuda:0"] * n, timeout_s=TP_TIMEOUT_S)
    launches, attn, summary, refs, lrefs = {}, {}, {}, {}, {}
    try:
        for tp in TP_DEGREES:
            group = groups.get(tp)
            t0 = time.perf_counter()
            lau, at, summary[f"tp{tp}_serve"] = phase_tp_serve(
                torch, cfg, qp, prompts, Engine, ServeConfig, PB, PA,
                group, refs, dev)
            launches.update(lau)
            attn.update(at)
            lau, summary[f"tp{tp}_logits"] = phase_tp_sliced(
                torch, np, cfg, qp, fp, prompts[:TP_SERVE["prefill_batch"]],
                Engine, ServeConfig, PB, group, lrefs, dev)
            launches.update(lau)
            if tp == 2:
                summary["decode_timing"] = phase_tp_decode_timing(
                    torch, cfg, qp, prompts, Engine, ServeConfig, group, dev)
                lau, summary["moe_walls_s"] = phase_tp_moe(
                    torch, np, get_arch, T, quantize_params, variant_counts,
                    get_policy, Engine, ServeConfig, PB, group, dev)
                launches.update(lau)
            print(f"[tp] tp={tp} phases in {time.perf_counter() - t0:.1f}s",
                  flush=True)
    finally:
        groups.close()
    mm_worst, rows, attn_worst, attn_rows = phase_tp_kernels(
        torch, np, cfg, qp, Q, PB, PA, SH, ops, dev,
        get_arch(TP_ARCH).n_layers)
    del qp, fp
    torch.cuda.empty_cache()
    summary["wall_s"] = time.perf_counter() - t_phase
    print(f"[tp] slice 12 in {summary['wall_s']:.1f}s", flush=True)
    return launches, attn, {"matmul_max_abs": mm_worst, "matmul": rows,
                            "attn_max_abs": attn_worst,
                            "attn": attn_rows}, summary


# ---------------------------------------------------------------------------
# slice 13: the dry run (launch/dryrun.py), its analytic models and the
# compressed gradient all-reduce
# ---------------------------------------------------------------------------

DRYRUN_CELLS_CODE = r"""
import json, sys, time
import torch
torch.set_num_threads(1)
from repro_torch.launch import dryrun as D
if torch.cuda.is_available():
    sys.exit("the dry run's process sees a card")
for arch, shape, multi, _ in json.loads(sys.argv[1]):
    t0 = time.perf_counter()
    rec = D.dryrun_cell(arch, shape, multi_pod=multi)
    rec["wall_s"] = time.perf_counter() - t0
    rec["cuda_initialized"] = torch.cuda.is_initialized()
    print("RECORD " + json.dumps(rec, default=str), flush=True)
"""


def phase_dryrun_cells(torch, root: Path):
    """Phase 44: the production cells (module note), through
    ``launch.dryrun.dryrun_cell`` in a subprocess that sees no card. Every
    cell must have run, come out ``ok`` with no kind of DTensor fallback
    outside its list, and left CUDA uninitialised in its process; this
    process's allocation on the card is unchanged too."""
    t_phase = time.perf_counter()
    alloc0 = torch.cuda.memory_allocated()
    env = dict(os.environ, PYTHONPATH=str(root / "src"),
               CUDA_VISIBLE_DEVICES="")
    try:
        proc = subprocess.run(
            [sys.executable, "-c", DRYRUN_CELLS_CODE,
             json.dumps(DRYRUN_CELLS)], cwd=root, env=env,
            capture_output=True, text=True, timeout=DRYRUN_WAIT_S)
        out, err, rc = proc.stdout, proc.stderr, proc.returncode
    except subprocess.TimeoutExpired as e:
        out, err, rc = e.stdout or "", e.stderr or "", "timed out"
        out, err = (x.decode() if isinstance(x, bytes) else x
                    for x in (out, err))
    recs = [json.loads(ln[len("RECORD "):]) for ln in out.splitlines()
            if ln.startswith("RECORD ")]
    ran = {(rec["arch"], rec["shape"], rec["multi_pod"]) for rec in recs}
    missed = [c[:3] for c in DRYRUN_CELLS if tuple(c[:3]) not in ran]
    check(not missed and rc == 0,
          f"the dry run did not run {missed} within {DRYRUN_WAIT_S:.0f}s "
          f"(exit {rc}): {err[-3000:]}")
    allowed = {tuple(c[:3]): set(c[3]) for c in DRYRUN_CELLS}
    rows = []
    for rec in recs:
        tag = f"{rec['arch']} x {rec['shape']} multi_pod={rec['multi_pod']}"
        check(rec["status"] == "ok", f"dry run {tag}: {rec}")
        check(not rec["cuda_initialized"],
              f"dry run {tag} initialised CUDA")
        new = set(rec["fallbacks"]) - allowed[(rec["arch"], rec["shape"],
                                               rec["multi_pod"])]
        check(not new, f"dry run {tag}: fallbacks outside its list: {new}")
        m, r = rec["memory"], rec["roofline"]
        fits = m["total_hbm_bytes"] <= CARD_BYTES
        rows.append(dict(cell=tag, trace_s=rec["trace_s"],
                         wall_s=rec["wall_s"], n_chips=rec["n_chips"],
                         total_hbm_bytes=m["total_hbm_bytes"],
                         argument_bytes=m["argument_size_in_bytes"],
                         temp_bytes=m["temp_size_in_bytes"], fits=fits,
                         compute_s=r["compute_s"], memory_s=r["memory_s"],
                         collective_s=r["collective_s"],
                         dominant=r["dominant"], mfu=r["mfu"],
                         useful=r["useful_flops_fraction"],
                         fallbacks=rec["fallbacks"],
                         link_domain_exceeded=rec["link_domain_exceeded"]))
        print(f"[dryrun] {tag}: per rank {m['total_hbm_bytes'] / 1e9:.2f} "
              f"GB (args {m['argument_size_in_bytes'] / 1e9:.3f}, temp "
              f"{m['temp_size_in_bytes'] / 1e9:.2f}), fits 80 GB: {fits}; "
              f"compute {r['compute_s'] * 1e3:.3f} ms, memory "
              f"{r['memory_s'] * 1e3:.3f} ms, collective "
              f"{r['collective_s'] * 1e3:.3f} ms -> {r['dominant']}, mfu "
              f"{r['mfu']:.4f}, useful/counted "
              f"{r['useful_flops_fraction']:.3f}; traced in "
              f"{rec['trace_s']}s ({rec['wall_s']:.1f}s with set-up)",
              flush=True)
    check(torch.cuda.memory_allocated() == alloc0,
          "phase 44 allocated on the card")
    wall = time.perf_counter() - t_phase
    print(f"[dryrun] all {len(recs)} cells ok; phase 44 in {wall:.1f}s",
          flush=True)
    return {"cells": rows, "wait_s": wall}


def _tree_bytes(tree) -> int:
    """Bytes of a tree of tensors and packed weights."""
    return sum(v.nbytes if hasattr(v, "variant")
               else v.numel() * v.element_size() for _, v in _leaves(tree))


def _card_peak(torch, fn):
    """(fn's result, its peak allocation above what was allocated before
    it, in bytes)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() - base


def _step_ms(torch, fn, n):
    """Median wall time of ``n`` calls of ``fn``, each ending in a
    synchronize, after one untimed call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _dryrun_vs_card(torch, tag, rec, args_bytes, peak_dry, peak_card,
                    step_ms):
    r = rec["roofline"]
    ratio = peak_dry / peak_card
    print(f"[dryrun-card] {tag}: argument bytes dry run "
          f"{rec['memory']['argument_size_in_bytes']:,} == real "
          f"{args_bytes:,}; argument + temp peak dry run "
          f"{peak_dry / 1e9:.3f} GB, card max_memory_allocated (same "
          f"datapath) {peak_card / 1e9:.3f} GB, ratio {ratio:.3f} (band "
          f"{DRYRUN_PEAK_BAND}); card's datapath step {step_ms:.3f} ms, "
          f"roofline step_time_s {r['step_time_s'] * 1e3:.3f} ms "
          f"({r['dominant']}-bound)", flush=True)
    check(rec["memory"]["argument_size_in_bytes"] == args_bytes,
          f"{tag}: dry-run argument bytes differ from the real ones")
    check(DRYRUN_PEAK_BAND[0] <= ratio <= DRYRUN_PEAK_BAND[1],
          f"{tag}: dry-run peak / card peak {ratio:.3f} outside "
          f"{DRYRUN_PEAK_BAND}")
    return dict(argument_bytes=args_bytes, peak_dry_bytes=peak_dry,
                peak_card_bytes=peak_card, ratio=ratio, step_ms=step_ms,
                roofline_step_ms=r["step_time_s"] * 1e3,
                dominant=r["dominant"], trace_s=rec["trace_s"])


def phase_dryrun_vs_card(torch, get_arch, T, S, quantize_params,
                         get_policy, PB, dev):
    """Phase 45 (module note). Returns (the decode step's matmul launches
    by variant on the card's datapath, the summary)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed.sharding import MeshShape
    from repro_torch.launch import dryrun as D
    from repro_torch.optim.adamw import AdamWConfig
    t_phase = time.perf_counter()
    one = MeshShape(("data", "model"), (1, 1))
    cfg = get_arch(TRAIN_ARCH)
    out = {}

    # (a) training: path 23's step
    B, Sq, mb = (DRYRUN_TRAIN[k] for k in ("global_batch", "seq_len",
                                            "microbatches"))
    rec = D.dryrun_cell(TRAIN_ARCH, ShapeConfig("train_path23", Sq, B,
                                                "train"),
                        mesh=one, microbatches=mb)
    check(rec["status"] == "ok", f"dry run of the train step: {rec}")
    cfg_d = D._tune_for_dryrun(cfg, ShapeConfig("t", Sq, B, "train"))
    opt = AdamWConfig(**TRAIN_OPT)
    g = torch.Generator(device=dev).manual_seed(0)
    state = S.init_train_state(cfg_d, opt, g, device=dev)
    batch = {k: torch.randint(0, cfg.vocab_size, (B, Sq), generator=g,
                              device=dev, dtype=torch.int32)
             for k in ("tokens", "labels")}
    args_bytes = _tree_bytes(state) + _tree_bytes(batch)
    step_d = S.make_train_step(cfg_d, opt, microbatches=mb)
    _, peak = _card_peak(torch, lambda: step_d(state, batch))
    step_c = S.make_train_step(cfg, opt, microbatches=mb)
    ms = _step_ms(torch, lambda: step_c(state, batch), DRYRUN_TIMED_STEPS)
    m = rec["memory"]
    out["train"] = _dryrun_vs_card(
        torch, f"{TRAIN_ARCH} train {B} x {Sq} ({mb} microbatches)", rec,
        args_bytes, m["argument_size_in_bytes"] + m["temp_size_in_bytes"],
        peak + args_bytes, ms)
    del state, batch
    torch.cuda.empty_cache()

    # (b) decode under default_serve_mix
    B, Sc = DRYRUN_DECODE["global_batch"], DRYRUN_DECODE["seq_len"]
    shape = ShapeConfig("decode_check", Sc, B, "decode")
    rec = D.dryrun_cell(TRAIN_ARCH, shape, mesh=one)
    check(rec["status"] == "ok", f"dry run of the decode step: {rec}")
    g = torch.Generator(device=dev).manual_seed(1)
    fp = T.init_params(cfg, g, dtype=torch.bfloat16, device=dev)
    qp, _ = quantize_params(fp, get_policy("default_serve_mix"))
    del fp
    cache = T.init_cache(cfg, B, Sc, device=dev)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B,), generator=g,
                                     device=dev, dtype=torch.int32),
             "position": torch.full((B,), Sc // 2, dtype=torch.int32,
                                    device=dev)}
    args_bytes = _tree_bytes(qp) + _tree_bytes(cache) + _tree_bytes(batch)
    _, dec_d = S.make_serve_steps(D._tune_for_dryrun(cfg, shape))
    _, peak = _card_peak(torch, lambda: dec_d(qp, cache, batch))
    _, dec_c = S.make_serve_steps(cfg)
    PB.reset_launches()
    logits, _ = dec_c(qp, cache, batch)
    torch.cuda.synchronize()
    launches = dict(PB.launches)
    check(bool(torch.isfinite(logits).all()) and sum(launches.values()) > 0,
          f"the card's decode step: finite logits and kernel launches "
          f"({launches})")
    ms = _step_ms(torch, lambda: dec_c(qp, cache, batch), DRYRUN_TIMED_STEPS)
    m = rec["memory"]
    out["decode"] = _dryrun_vs_card(
        torch, f"{TRAIN_ARCH} decode B={B} over {Sc} slots "
        "(default_serve_mix)", rec, args_bytes,
        m["argument_size_in_bytes"] + m["temp_size_in_bytes"],
        peak + args_bytes, ms)
    out["decode"]["launches_per_step"] = launches
    del qp, cache
    torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"[dryrun-card] phase 45 in {out['wall_s']:.1f}s", flush=True)
    return launches, out


def compress_rank(seed, error_steps, shapes):
    """One rank of phase 46: this rank's gradients of ``shapes`` (seeded
    by its rank) on its device, ``compressed_psum`` for ``error_steps``
    steps, each fed the last one's error state; every step's (reduced,
    error) as numpy."""
    import numpy as np
    import torch
    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed.compress import compressed_psum
    rank, dev = SH.serve_tp_rank(), SH.serve_tp_group().device
    rng = np.random.default_rng(seed + rank)
    grads = {k: torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)).to(dev) for k, s in shapes.items()}
    err, out = None, []
    for _ in range(error_steps):
        red, err = compressed_psum(grads, error=err)
        out.append(({k: v.cpu().numpy() for k, v in red.items()},
                    {k: v.cpu().numpy() for k, v in err.items()}))
    return out


def phase_compress(torch, np, group):
    """Phase 46 (module note) on ``group``, 2 ranks on cuda:0: two steps,
    the second fed the first's error state. Each rank's error state is its
    corrected gradient's rounding residual, bit for bit; the mean is the
    plain mean of the corrected gradients within one bf16 rounding of each
    cast and of the sum (a relative 2^-8 each: 2^-7 of the mean
    magnitude)."""
    t0 = time.perf_counter()
    print(f"[compress] {group.describe()}", flush=True)
    got = group.map(compress_rank, [(46, 2, COMPRESS_SHAPES)] * 2)
    grads = []
    for rank in range(2):
        rng = np.random.default_rng(46 + rank)
        grads.append({k: torch.from_numpy(rng.standard_normal(s).astype(
            np.float32)) for k, s in COMPRESS_SHAPES.items()})
    worst = 0.0
    for step in range(2):
        for k in COMPRESS_SHAPES:
            corr = [grads[r][k] + (0 if step == 0 else torch.from_numpy(
                got[r][0][1][k])) for r in range(2)]
            for r in range(2):
                want = corr[r] - corr[r].to(torch.bfloat16).to(torch.float32)
                check(np.array_equal(got[r][step][1][k], want.numpy()),
                      f"step {step}: rank {r}'s error state of {k} is not "
                      "its rounding residual")
            red = got[0][step][0][k]
            check(np.array_equal(red, got[1][step][0][k]),
                  "the ranks' means differ")
            mean = ((corr[0] + corr[1]) / 2).numpy()
            bound = 2.0 ** -7 * (np.abs(corr[0]) + np.abs(corr[1])).numpy() / 2
            check(bool(np.all(np.abs(red - mean) <= bound)),
                  f"step {step}: the compressed mean of {k} is off by more "
                  "than its bf16 roundings")
            worst = max(worst, float(np.max(np.abs(red - mean))))
    wall = time.perf_counter() - t0
    print(f"[compress] 2 ranks on cuda:0, 2 steps: every error state the "
          f"rank's rounding residual bit for bit; the means within their "
          f"bf16 roundings of the plain mean (max abs {worst:.3e}); "
          f"{wall:.1f}s", flush=True)
    return {"max_abs_vs_plain_mean": worst, "wall_s": wall}


# ---------------------------------------------------------------------------
# slice 14: disaggregated serving over tensor-parallel engines
# ---------------------------------------------------------------------------

def rank_memory():
    """This rank's ``torch.cuda.memory_allocated`` (its own allocations:
    a worker's CUDA IPC mappings of rank 0's weights are not in it)."""
    import torch
    torch.cuda.synchronize()
    return torch.cuda.memory_allocated()


def _same_pages(torch, a, b) -> bool:
    return (a.tokens == b.tokens and set(a.payload) == set(b.payload)
            and all(torch.equal(a.payload[k].view(torch.uint8),
                                b.payload[k].view(torch.uint8))
                    for k in a.payload))


def _collect(torch):
    """Free what dropped engines held (their callbacks close reference
    cycles) before a memory reading."""
    gc.collect()
    torch.cuda.synchronize()


def _dtp_run(torch, DisaggEngine, ServeConfig, PB, PA, cfg, qp, prompts,
             group, per_forward, tag, p=1, d=1, extra=None, mem=False):
    """``prompts`` through a pP+dD ``DisaggEngine`` at ``group.size`` ranks
    on ``group``, the launch counts of every rank zeroed just before and
    read just after: every forward of either tier launches
    ``per_forward`` matmul kernels, every prefill-chunk forward
    ``cfg.n_layers`` attention kernels, on rank 0 and on every other
    rank. Returns (tokens, stats, matmul launches, attention launches,
    wall s, every rank's memory with the engine alive or None, rank 0's
    tier exports of ``prompts``)."""
    tp = group.size
    dis = DisaggEngine(cfg, qp, ServeConfig(tp=tp, **DTP_SERVE,
                                            **(extra or {})),
                       prefill_workers=p, decode_workers=d, group=group)
    try:
        _reset_all(torch, PB, PA, group)
        t0 = time.perf_counter()
        res = dis.generate(prompts)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        s = dict(dis.stats)
        ranks = group.map(rank_launches, [()] * tp)
        lau, at = dict(PB.launches), PA.launches["prefill_attn"]
        memory = group.map(rank_memory, [()] * tp) if mem else None
        pages = [dis.prefill_engines[0].export_kv_pages(q) for q in prompts]
    finally:
        dis.close()
    del dis
    _collect(torch)
    _check_launches(tag, PB, lau, {"forwards": s["forwards"],
                                   "draft_forwards": 0}, per_forward)
    check(at == cfg.n_layers * s["prefill_forwards"],
          f"{tag}: {at} attention launches over {s['prefill_forwards']} "
          "prefill-chunk forwards")
    check(all(r == (lau, at) for r in ranks),
          f"{tag}: ranks launched {ranks}, rank 0 {(lau, at)}")
    rt = s["router"]
    handoffs = sum(rt["prefill_requests"])
    print(f"[disagg tp] {tag}: {len(res)} requests in {wall:.3f}s, ttft p50 "
          f"{s['ttft_p50_s'] * 1e3:.1f} ms, p99 {s['ttft_p99_s'] * 1e3:.1f} "
          f"ms; {s['forwards']} forwards ({s['prefill_forwards']} prefill "
          f"chunks); migrated {s['migrated_pages']} pages for "
          f"{s['migrated_requests']} requests; hand-off "
          f"{s['handoff_s'] * 1e3:.2f} ms for {handoffs} requests, "
          f"{s['handoff_bytes']} payload bytes, {s['handoff_pipe_bytes']} "
          f"bytes over the pipe; decode requests {rt['decode_requests']}",
          flush=True)
    check(s["migrated_pages"] > 0 and s["prefix_hits"] > 0,
          f"{tag}: no page migrated or reused")
    check(all(len(t) == DTP_SERVE["max_new_tokens"] for t in res),
          f"{tag}: a request did not get its tokens")
    out = {"wall_s": wall, "ttft_p50_ms": s["ttft_p50_s"] * 1e3,
           "ttft_p99_ms": s["ttft_p99_s"] * 1e3,
           "forwards": s["forwards"],
           "prefill_forwards": s["prefill_forwards"],
           "migrated_pages": s["migrated_pages"], "handoffs": handoffs,
           "handoff_ms": s["handoff_s"] * 1e3,
           "handoff_payload_bytes": s["handoff_bytes"],
           "handoff_pipe_bytes": s["handoff_pipe_bytes"],
           "decode_tok_per_s": s["tok_per_s"]}
    return res, out, lau, at, memory, pages


def _tp1_refs(torch, Engine, DisaggEngine, ServeConfig, cfg, qp, prompts,
              dev, extra=None):
    """The monolithic tp=1 engine's tokens and the tp=1 1P+1D
    ``DisaggEngine``'s (which must equal them), that tier's exported
    pages and its hand-off (ms, payload bytes, requests)."""
    kw = dict(DTP_SERVE, **(extra or {}))
    with Engine(cfg, qp, ServeConfig(**kw), device=dev) as e1:
        mono = e1.generate(prompts)
    with DisaggEngine(cfg, qp, ServeConfig(**kw), device=dev) as d1:
        one = d1.generate(prompts)
        s = d1.stats
        pages = [d1.prefill_engines[0].export_kv_pages(q) for q in prompts]
    _collect(torch)
    check(one == mono, f"tp=1 DisaggEngine ({extra}) != the monolithic "
          "engine")
    handoff = {"handoff_ms": s["handoff_s"] * 1e3,
               "handoff_payload_bytes": s["handoff_bytes"],
               "handoffs": sum(s["router"]["prefill_requests"])}
    print(f"[disagg tp] tp=1 1P+1D ({extra or 'greedy'}): tokens == "
          f"monolithic; hand-off {handoff['handoff_ms']:.2f} ms for "
          f"{handoff['handoffs']} requests, "
          f"{handoff['handoff_payload_bytes']} payload bytes", flush=True)
    return mono, pages, handoff


def phase_disagg_tp(torch, np, get_arch, T, quantize_params, variant_counts,
                    get_policy, Engine, ServeConfig, DisaggEngine, PB, PA,
                    group, dev):
    """Phase 47 (path 35; module note) on ``group``, two ranks on cuda:0
    (phase 46's). Returns (matmul launches by path, attention launches by
    path, summary)."""
    t_phase = time.perf_counter()
    cfg = get_arch(TP_ARCH).replace(attn_impl="fused")
    qp = pack_full_width(torch, cfg, T, quantize_params, variant_counts,
                         get_policy, TP_POLICY, dev, DTP_PER_FORWARD, PB,
                         shapes=False)
    prompts = _tp_prompts(np, cfg)
    mono, pages1, handoff1 = _tp1_refs(torch, Engine, DisaggEngine,
                                       ServeConfig, cfg, qp, prompts, dev)
    mono_t, _, _ = _tp1_refs(torch, Engine, DisaggEngine, ServeConfig, cfg,
                             qp, prompts, dev, DTP_TEMP)
    check(mono_t != mono, "temperature 0.8 gave the greedy tokens")
    launches, attn, out = {}, {}, {"tp1_1p1d_handoff": handoff1}
    _collect(torch)
    mem0 = group.map(rank_memory, [()] * DTP)
    mems = {}
    for key, p, d, extra, want in (
            ("1p1d", 1, 1, None, mono), ("2p2d", 2, 2, None, mono),
            ("1p1d_t0.8", 1, 1, DTP_TEMP, mono_t)):
        tag = f"tinyllama_disagg_tp{DTP}_{key}"
        res, out[key], lau, at, mems[key], pages = _dtp_run(
            torch, DisaggEngine, ServeConfig, PB, PA, cfg, qp, prompts,
            group, DTP_PER_FORWARD, tag, p, d, extra, mem=extra is None)
        print(f"[disagg tp] {tag}: tokens == monolithic tp=1 and tp=1 "
              f"DisaggEngine: {res == want}", flush=True)
        check(res == want, f"{tag}: tokens differ from tp=1's")
        if key == "1p1d":
            same = all(_same_pages(torch, a, b)
                       for a, b in zip(pages, pages1))
            print(f"[disagg tp] {tag}: prefill-tier pages == tp=1's bit "
                  f"for bit: {same} ({sum(x.n_pages for x in pages)} "
                  "pages)", flush=True)
            check(same, f"{tag}: exported pages differ from tp=1's")
        launches[tag], attn[tag] = lau, at
    # one weight shard set a rank: the workers' rings and page pools (a
    # tp=2 engine's, allocated at first use, the same in either tier) are
    # all that 2P+2D adds over 1P+1D
    for r in range(DTP):
        one = (mems["1p1d"][r] - mem0[r]) / 2
        bound = (mem0[r] + 4 * one) * (1 + DTP_MEM_SLACK)
        print(f"[disagg tp] rank {r} memory_allocated: {mem0[r] / 1e6:.1f} "
              f"MB before, {mems['1p1d'][r] / 1e6:.1f} MB with 1P+1D serving "
              f"(a worker's ring and pool {one / 1e6:.1f} MB), "
              f"{mems['2p2d'][r] / 1e6:.1f} MB with 2P+2D (bound "
              f"{bound / 1e6:.1f} MB)", flush=True)
        check(mems["2p2d"][r] <= bound, f"rank {r}: {mems['2p2d'][r]} bytes "
              f"with 2P+2D, over {bound:.0f}: a weight copy a worker?")
    out["memory_mb"] = {"before": [m / 1e6 for m in mem0],
                        **{k: [m / 1e6 for m in mems[k]]
                           for k in ("1p1d", "2p2d")}}
    del qp
    torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"[disagg tp] phase 47 took {out['wall_s']:.1f}s", flush=True)
    return launches, attn, out


def _disagg_tp_http(torch, cfg, qp, prompt, ServeConfig, DisaggEngine, FE,
                    group):
    """Phase 48's front-end part: one completion and one SSE completion
    through the HTTP front end over a tp=2 ``DisaggEngine`` on ``group``,
    each the engine's tokens."""
    with DisaggEngine(cfg, qp, ServeConfig(tp=DTP, **DTP_SERVE),
                      group=group) as dis:
        want = dis.generate([prompt])[0]
        front = FE.Frontend(dis, FE.FrontendConfig(
            model_name=TP_ARCH, request_timeout_s=120.0)).start()
        try:
            got = [None, None]
            for i, stream in enumerate((False, True)):
                _client(front.port, prompt, len(want), stream, got, i)
        finally:
            front.close()
    _collect(torch)
    print(f"[disagg tp] HTTP over a tp={DTP} DisaggEngine: completion "
          f"{got[0][1]!r} in {got[0][3] * 1e3:.1f} ms, stream {got[1][1]!r} "
          f"(first token {got[1][2] * 1e3:.1f} ms, all "
          f"{got[1][3] * 1e3:.1f} ms); tokens == the engine's: "
          f"{[g[0] == want for g in got]}", flush=True)
    check(all(g[0] == want and g[1] == "length" for g in got),
          "HTTP over the tp=2 DisaggEngine: tokens differ")
    return {"completion_ms": got[0][3] * 1e3,
            "stream_first_ms": got[1][2] * 1e3,
            "stream_all_ms": got[1][3] * 1e3}


def phase_disagg_tp_entry_points(torch, np, get_arch, T, quantize_params,
                                 variant_counts, get_policy, Engine,
                                 ServeConfig, DisaggEngine, FE, PB, PA,
                                 group, dev):
    """Phase 48 (module note) at ``TP_DEPTH`` layers: the HTTP front end
    on ``group`` (two ranks on cuda:0, phases 46-47's), which it then
    closes; the tp=4 1P+1D; the launcher (full depth); then no worker of
    any of these groups may be left. Returns (matmul launches by path,
    attention launches by path, summary)."""
    import multiprocessing
    from repro_torch.distributed.group import TPGroup
    from repro_torch.launch import serve as launcher
    t_phase = time.perf_counter()
    cfg = get_arch(TP_ARCH).replace(attn_impl="fused", n_layers=TP_DEPTH)
    qp = pack_full_width(torch, cfg, T, quantize_params, variant_counts,
                         get_policy, TP_POLICY, dev, TP_PER_FORWARD, PB,
                         shapes=False)
    prompts = _tp_prompts(np, cfg)
    mono, _, _ = _tp1_refs(torch, Engine, DisaggEngine, ServeConfig, cfg, qp,
                           prompts, dev)
    launches, attn = {}, {}
    out = {"http": _disagg_tp_http(torch, cfg, qp, prompts[0], ServeConfig,
                                   DisaggEngine, FE, group)}
    procs = list(group._procs)
    group.close()
    with TPGroup(4, ["cuda:0"] * 4, timeout_s=TP_TIMEOUT_S) as group:
        procs += group._procs
        tag = "tinyllama_disagg_tp4_1p1d"
        res, out["tp4_1p1d"], lau, at, _, _ = _dtp_run(
            torch, DisaggEngine, ServeConfig, PB, PA, cfg, qp, prompts,
            group, TP_PER_FORWARD, tag)
        check(res == mono, f"{tag}: tokens differ from tp=1's")
        launches[tag], attn[tag] = lau, at
    # the launcher (full depth: it has no depth cut): --disagg --tp 2 with
    # both ranks on the one card against its --tp 1 run (the same seed:
    # weights, prompts)
    argv = ["--arch", TP_ARCH, "--policy", TP_POLICY, "--requests", "4",
            "--slots", "4", "--tokens", "8",
            "--cache-len", "256", "--prefill-chunk", "64",
            "--shared-prefix", str(TP_SHARED), "--prompt-len", "24",
            "--prefix-page", "16"]
    t0 = time.perf_counter()
    _, one = launcher.main(argv + ["--device", "cuda"])
    PB.reset_launches()
    PA.reset_launches()
    eng, two = launcher.main(argv + ["--disagg", "--tp", str(DTP),
                                     "--device", "cuda:0,cuda:0"])
    procs += eng.group._procs
    lau = dict(PB.launches)
    tag = "tinyllama_launcher_disagg_tp2"
    _check_launches(tag, PB, lau, {"forwards": eng.stats["forwards"],
                                   "draft_forwards": 0}, DTP_PER_FORWARD)
    launches[tag] = lau
    print(f"[disagg tp] launcher --disagg --tp {DTP} --device cuda:0,cuda:0: "
          f"tokens == --tp 1: {two == one}; closed {eng.closed}, group "
          f"closed {eng.group.closed}; {time.perf_counter() - t0:.1f}s for "
          "both runs", flush=True)
    check(two == one and len(two) == 4, "launcher --disagg --tp 2 tokens "
          "differ from --tp 1")
    check(eng.closed and eng.group.closed, "the launcher left its engine "
          "open")
    del eng
    for p in procs:
        p.join(TP_TIMEOUT_S)
    alive = [p.name for p in procs if p.is_alive()]
    left = multiprocessing.active_children()
    print(f"[disagg tp] {len(procs)} worker processes started, alive after "
          f"close: {alive}; children left: {left}", flush=True)
    check(not alive and not left, f"worker processes left: {alive} {left}")
    del qp
    torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"[disagg tp] phase 48 took {out['wall_s']:.1f}s", flush=True)
    return launches, attn, out


# ---------------------------------------------------------------------------
# slice 15: the matmul's on-chip budget, and the example flows
# ---------------------------------------------------------------------------

def phase_budget(PB):
    """Phase 49: every instantiation's computed shared memory against the
    card's reading (``cuFuncGetAttribute`` through the loaded library);
    registers and spills reported. Returns {variant: [schedule rows]}."""
    t0 = time.perf_counter()
    out = {}
    for row in PB.budget(card=True):
        card = row["card"]
        name = (f"{row['variant']} {row['tokens']}-token tile"
                f"{', folded' if row['fold'] else ''}")
        check(card["static_smem"] == row["static"],
              f"budget {name}: static shared memory {card['static_smem']} "
              f"B on the card, {row['static']} computed")
        check(card["max_dynamic_smem"] == row["dynamic"],
              f"budget {name}: dynamic shared memory "
              f"{card['max_dynamic_smem']} B on the card, {row['dynamic']} "
              "computed")
        check(row["total"] <= PB.SMEM_PER_BLOCK,
              f"budget {name}: {row['total']} B past a block's")
        out.setdefault(row["variant"], []).append(
            {k: row[k] for k in ("groups", "tokens", "fold", "x_tile",
                                 "w_packed_tile", "out_tile", "static",
                                 "dynamic")}
            | {"regs": card["regs"], "local_bytes": card["local_bytes"]})
    for v, rows in out.items():
        print(f"[budget] {v}: " + "; ".join(
            f"{r['tokens']}{'f' if r['fold'] else ''} {r['dynamic']} B smem "
            f"{r['regs']} regs {r['local_bytes']} B local" for r in rows),
            flush=True)
    print(f"[budget] {sum(len(r) for r in out.values())} instantiations: "
          "computed shared memory == cuFuncGetAttribute's (static 0, "
          f"dynamic as launched); {time.perf_counter() - t0:.2f}s",
          flush=True)
    return out


def phase_serve_flow(torch, PB, PA, dev):
    """Phase 50: ``python -m repro_torch.launch.serve_quantized --full``
    through its ``main``: full-width tinyllama-1.1b under paper_llama_mix,
    6 requests on 2 slots with streaming callbacks, the launch counts
    zeroed just before and read just after. Returns (launches, summary)."""
    from repro_torch.launch import serve_quantized as SQ
    t0 = time.perf_counter()
    PB.reset_launches()
    PA.reset_launches()
    out = SQ.main(["--full"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, s = dict(PB.launches), out["stats"]
    check(out["layers"] == FLOW_SERVE_PER_FORWARD,
          f"serve flow packed {out['layers']}")
    _check_launches("serve flow", PB, launches, s, FLOW_SERVE_PER_FORWARD)
    check(PA.launches["prefill_attn"] == 0, "serve flow: attention kernel "
          "launched on the naive path")
    check(out["streamed"] == out["results"] and len(out["results"]) == 6
          and all(len(t) == 10 for t in out["results"].values()),
          "serve flow: the callbacks differ from run()'s results")
    eng, prompts = out["engine"], out["prompts"]
    ref = []
    for lo in range(0, len(prompts), SQ.SERVE["max_slots"]):
        ref += eng.generate_reference(prompts[lo:lo + SQ.SERVE["max_slots"]])
    check(ref == [out["results"][i] for i in range(len(prompts))],
          "serve flow: run() != generate_reference")
    # the callbacks' order is the scheduler's: the CPU's reduced run, which
    # the tests hold to the reference's example, calls them alike
    cpu = SQ.main(["--device", "cpu"])
    order = [r for r, _ in out["events"]]
    check(order == [r for r, _ in cpu["events"]],
          "serve flow: the callbacks fire in another order than on the CPU")
    print(f"[serve flow] full-width tinyllama-1.1b: {s['forwards']} "
          f"forwards, {launches['q2_k']} q2_k + {launches['q3_k']} q3_k "
          f"launches; callbacks == run() == generate_reference; callback "
          f"order == the CPU's {order}; {s['tok_per_s']:.1f} tok/s decode, "
          f"{s['host_syncs']} host syncs over {s['chunks']} chunks; "
          f"{wall:.1f}s with packing", flush=True)
    summary = {"wall_s": wall, "forwards": s["forwards"],
               "tok_per_s": s["tok_per_s"], "host_syncs": s["host_syncs"],
               "chunks": s["chunks"], "sizes": out["sizes"]}
    del out, eng, cpu
    torch.cuda.empty_cache()
    return launches, summary


def phase_policy_flow(torch, get_arch, T, to_device, PB, dev):
    """Phase 51: the mixed-policy flow (reduced llama3.2-1b, as the
    reference) on the card and on the CPU from the same weights and
    tokens: the same bytes a policy, the launches a policy's forward
    makes, KL card against CPU within ``TOL_FLOW_KL``. Returns (launches,
    rows)."""
    from repro_torch.core import quality
    from repro_torch.launch import mixed_quant_policy as MQ
    t0 = time.perf_counter()
    cfg = get_arch("llama3.2-1b", reduced=True)
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    toks = quality.eval_tokens(cfg, batch=MQ.BATCH, seq=MQ.SEQ, seed=1,
                               device="cpu")
    cpu = MQ.run(cfg, params, toks, log=lambda *_: None)
    PB.reset_launches()
    card = MQ.run(cfg, to_device(params, dev), toks.to(dev))
    torch.cuda.synchronize()
    launches = dict(PB.launches)
    want = {v: FLOW_POLICY_LAUNCHES.get(v, 0) for v in PB.VARIANTS}
    check(launches == want, f"policy flow launches {launches}, expected "
          f"{want}")
    rows = []
    for c, h in zip(card, cpu):
        check(c["policy"] == h["policy"] and c["sizes"] == h["sizes"],
              f"policy flow {c['policy']}: bytes {c['sizes']} on the card, "
              f"{h['sizes']} on the CPU")
        check(0 < c["kl"] < float("inf"), f"policy flow {c['policy']}: KL "
              f"{c['kl']}")
        rel = abs(c["kl"] - h["kl"]) / h["kl"]
        check(rel <= TOL_FLOW_KL, f"policy flow {c['policy']}: KL "
              f"{c['kl']} on the card, {h['kl']} on the CPU ({rel:.2e} "
              f"apart, past {TOL_FLOW_KL})")
        rows.append({"policy": c["policy"], "bytes": c["sizes"]["total"],
                     "kl": c["kl"], "kl_cpu": h["kl"], "kl_rel_diff": rel})
    kl = {r["policy"]: r["kl"] for r in rows}
    check(kl["pure_q6_k"] < kl["pure_q4_k"] < kl["pure_q3_k"]
          < kl["pure_q2_k"], f"policy flow: KL out of order {kl}")
    wall = time.perf_counter() - t0
    print(f"[policy flow] launches {launches} == {want}; bytes equal the "
          f"CPU's; KL card vs CPU (within {TOL_FLOW_KL}) " + ", ".join(
              f"{r['policy']} {r['kl']:.6f} / {r['kl_cpu']:.6f}"
              for r in rows) + f"; {wall:.1f}s", flush=True)
    return launches, {"rows": rows, "wall_s": wall}


def phase_train_flow(torch, PB, PA, PK):
    """Phase 52: ``python -m repro_torch.launch.train_e2e --steps
    FLOW_TRAIN_STEPS`` through its ``main`` (the ~100M llama at the
    example's shapes, checkpoints in a temporary directory): the loss
    falls (``main`` raises otherwise), every loss is finite, no kernel of
    the port launches."""
    from repro_torch.launch import train_e2e as TE
    t0 = time.perf_counter()
    _reset_kernels(PB, PA, PK)
    res = TE.main(["--steps", str(FLOW_TRAIN_STEPS)])
    wall = time.perf_counter() - t0
    losses, t = res["losses"], res["timing"]
    check(len(losses) == FLOW_TRAIN_STEPS
          and all(x == x and abs(x) < float("inf") for x in losses),
          f"train flow losses {losses}")
    check(_kernel_launches(PB, PA, PK) == 0,
          "train flow launched a kernel of the port")
    n = _n_params(res["state"]["params"])
    tok_s = TE.RUN["global_batch"] * TE.RUN["seq_len"] / t["p50"]
    print(f"[train flow] llama-100m ({n:,} params), {FLOW_TRAIN_STEPS} steps "
          f"of {TE.RUN['global_batch']} x {TE.RUN['seq_len']}: loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}, step p50 "
          f"{1e3 * t['p50']:.1f} ms p99 {1e3 * t['p99']:.1f} ms "
          f"({tok_s:.0f} tok/s), no kernel launched; {wall:.1f}s with the "
          "final checkpoint", flush=True)
    out = {"params": n, "losses": losses, "p50_ms": 1e3 * t["p50"],
           "p99_ms": 1e3 * t["p99"], "tok_per_s": tok_s, "wall_s": wall}
    del res
    torch.cuda.empty_cache()
    return out


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
    from repro_torch.serving import frontend as FE
    from repro_torch.serving.disagg import DisaggEngine
    from repro_torch.serving.engine import (Engine, EngineSaturated,
                                            ServeConfig)
    from repro_torch.training import steps as S

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
        Engine, ServeConfig, EngineSaturated, DisaggEngine, FE, PB, PA, Q,
        ops, dev)

    # slice 7: the MoE family at full width, fused, prefix cache
    launches7, attn7, timing7, slice7 = phase_slice7(
        torch, np, get_arch, T, quantize_params, variant_counts, get_policy,
        Engine, ServeConfig, DisaggEngine, PB, PA, PM, Q, dev)

    # slice 8: the recurrent families at full width, the checkpoint
    # prefix cache
    launches8, timing8, slice8 = phase_slice8(
        torch, np, get_arch, T, M2, quantize_params, variant_counts,
        get_policy, Engine, ServeConfig, PB, PA, Q, dev)

    # slice 11: --policy auto on MoE, ssm and hybrid; the embedding-input
    # families through the serve steps
    launches11, attn11, timing11, slice11 = phase_slice11(
        torch, np, get_arch, T, quantize_params, variant_counts, get_policy,
        resolve_policy, Engine, ServeConfig, PB, PA, Q, dev)

    # slice 10: training at full width (path 23)
    slice10 = phase_slice10(torch, np, get_arch, dev, root, PB, PA, PK)

    # slice 12: tensor- and expert-parallel serving, ranks sharing cuda:0
    launches12, attn12, tp_kernels, slice12 = phase_slice12(
        torch, np, get_arch, T, quantize_params, variant_counts, get_policy,
        Engine, ServeConfig, PB, PA, Q, dev)

    # slice 13: the dry run, its check against real steps, the compressed
    # gradient all-reduce
    slice13 = {"cells": phase_dryrun_cells(torch, root)}
    launches13, slice13["card"] = phase_dryrun_vs_card(
        torch, get_arch, T, S, quantize_params, get_policy, PB, dev)
    # phase 46 and slice 14's tp=2 phases on one group of two ranks on
    # cuda:0 (a group's start costs several seconds a worker); phase 48
    # closes it before its tp=4 group and the launcher's
    from repro_torch.distributed.group import TPGroup
    group = TPGroup(DTP, ["cuda:0"] * DTP, timeout_s=TP_TIMEOUT_S)
    try:
        slice13["compress"] = phase_compress(torch, np, group)
        # slice 14: disaggregated serving over tensor-parallel engines
        print(f"[disagg tp] {group.describe()}", flush=True)
        launches14, attn14, slice14 = phase_disagg_tp(
            torch, np, get_arch, T, quantize_params, variant_counts,
            get_policy, Engine, ServeConfig, DisaggEngine, PB, PA, group,
            dev)
        lau, at, slice14["entry_points"] = phase_disagg_tp_entry_points(
            torch, np, get_arch, T, quantize_params, variant_counts,
            get_policy, Engine, ServeConfig, DisaggEngine, FE, PB, PA, group,
            dev)
    finally:
        group.close()
    launches14.update(lau)
    attn14.update(at)

    # slice 15: the on-chip budget read back, the example flows
    t15 = time.perf_counter()
    slice15 = {"budget": phase_budget(PB)}
    launches15 = {}
    launches15["serve_quantized_flow"], slice15["serve_flow"] = \
        phase_serve_flow(torch, PB, PA, dev)
    launches15["mixed_quant_policy_flow"], slice15["policy_flow"] = \
        phase_policy_flow(torch, get_arch, T, to_device, PB, dev)
    slice15["train_flow"] = phase_train_flow(torch, PB, PA, PK)
    slice15["wall_s"] = time.perf_counter() - t15
    print(f"[flows] phases 49-52 took {slice15['wall_s']:.1f}s", flush=True)

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
                   **{p: launches8[p][v] for p in launches8},
                   **{p: launches11[p][v] for p in launches11},
                   **{p: launches12[p][v] for p in launches12},
                   "dryrun_check_decode": launches13.get(v, 0),
                   **{p: launches14[p][v] for p in launches14},
                   **{p: launches15[p][v] for p in launches15}}
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
        for arch, t7 in {**timing7, **timing8, **timing11}.items():
            if v in t7:
                kernels[-1][f"{arch}_decode_shapes"] = t7[v]
        checked = {f"{a} {K}x{N}": {"weights": n, "max_abs_err": e,
                                    "kernel_vs_exact_rel": ek,
                                    "plain_vs_exact_rel": ep,
                                    "k_splits": sp}
                   for (a, vv, K, N), (n, e, ek, ep, sp)
                   in PACKED_CHECKED.items() if vv == v}
        if checked:
            kernels[-1]["packed_weights_checked"] = checked
        if v in slice6["verify_timing"]:
            kernels[-1]["batched_verify"] = slice6["verify_timing"][v][
                "verify"]
        tp_rows = {k: r for k, r in tp_kernels["matmul"].items()
                   if r["variant"] == v}
        if tp_rows:
            kernels[-1]["tp_shapes"] = tp_rows
            kernels[-1]["max_abs_err_tp_shapes"] = tp_kernels[
                "matmul_max_abs"]
        kernels[-1]["smem_budget"] = slice15["budget"][v]
        if v == "q2_k":
            kernels[-1]["gpt2_head_n50257"] = head_timing
            kernels[-1]["max_abs_err_n50257"] = max_abs["q2_k_n50257"]
    kernels.append({
        "name": "prefill_attn", "route": "cuda",
        "source": "src/repro_torch/csrc/prefill_attn.cu",
        "replaces": "src/repro/kernels/prefill_attn.py:80",
        "launches": attn1 + attn2 + sum(attn5.values())
        + sum(attn6.values()) + sum(attn7.values()) + sum(attn11.values())
        + sum(attn12.values()) + sum(attn14.values()),
        "launches_by_path": {"paper_llama_mix": attn1,
                             "extended_mix_fused": attn2, **attn5, **attn6,
                             **attn7, **attn11, **attn12, **attn14},
        "max_abs_err": max_abs["prefill_attn"],
        "ms": attn_timing["ms"], "plain_ms": attn_timing["plain_ms"],
        "bound_ms": attn_timing["bound_ms"],
        "bound_by": attn_timing["bound_by"],
        "library_ms": attn_timing["library_ms"],
        "per": "the launches of one prefill-chunk forward (22 layers)",
        "bytes": attn_timing["bytes"], "flops": attn_timing["flops"],
        "warm_prefix_chunk": slice6["warm_attn_timing"],
        f"{MOE_FUSED}_warm_prefix_chunk": slice7["fused"][
            "warm_attn_timing"],
        **{f"{a}_prefill_f32": slice11[a]["attn_timing"]
           for a in EMBED_MODELS},
        "tp_heads": tp_kernels["attn"],
        "max_abs_err_tp_heads": tp_kernels["attn_max_abs"]})
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
    summary9 = {"disagg": slice6["disagg"], "frontend": slice6["frontend"],
                f"{MOE_FUSED}_disagg": slice7["disagg"]}
    print(f"[slice9] summary: {json.dumps(summary9)}", flush=True)
    print(f"[slice8] summary: {json.dumps(slice8)}", flush=True)
    print(f"[slice10] summary: {json.dumps(slice10)}", flush=True)
    print(f"[slice11] summary: {json.dumps(slice11)}", flush=True)
    print(f"[slice12] summary: {json.dumps(slice12)}", flush=True)
    print(f"[slice13] summary: {json.dumps(slice13)}", flush=True)
    print(f"[slice14] summary: {json.dumps(slice14)}", flush=True)
    print(f"[slice15] summary: {json.dumps(slice15)}", flush=True)
    print(f"[done] all phases passed in {time.perf_counter() - t_start:.1f}s",
          flush=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
