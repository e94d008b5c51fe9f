#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the script (nonzero exit) if it fails:

1. device   — the card's name, and its name and power limit as
              ``nvidia-smi --query-gpu=name,power.limit`` reports them;
2. build    — compile the CUDA kernels from ``src/repro_torch/csrc``
              (logging each kernel's registers, any spills and ptxas's
              notes that it serialized wgmma);
3. kernels  — ``gram_norm`` (triangular and full grid) and ``direct_norm``
              against their plain PyTorch versions in f32 and bf16 at the
              main path's shapes, a ragged shape and the LM head (in bf16
              also at the moe, gemma2 and qwen2-vl paths' block and head
              shapes, 3584 → 256,000 the widest, and at the deepseek
              path's, its prefix layer's and MoE layers' included, kv_down's
              5120 → 576 and kv_up's 512 → 32,768 the first path widths
              off the multiples of 128; in f32 also at the f32 MoE routers,
              phi3.5-moe's 4096 → 16 and deepseek's 5120 → 160; the
              rwkv6, zamba2 and seamless paths' shapes and heads in bf16
              (zamba2's 3584 → 14,576, off the multiples of 128;
              seamless's 1024 → 256,208) and in f32 at the exact phases'
              B=4, S=256, rwkv6's 32 → 2560 on the path's own strided view
              of tanh(mix_a) (each of its five slices' offsets, TMA
              asserted), each of these repeated bit for bit; every
              shape at the (B, S), and so on the plan, its path launches:
              B=8, S=512, moe's B=32, S=256, deepseek's B=16, S=256; after
              the paths every gram and direct launch of theirs, of either
              dtype, asserted to be at a shape held here), each bf16
              launch's copy route asserted (TMA there; the staged route on
              rows of an odd pitch, checked too) and the bf16 launches at
              the main and head shapes run twice for bitwise-equal
              results; the three
              flash attention kernels (forward, dQ, dK/dV) against theirs in
              f32 and bf16 at every ``FLASH_CASES`` case (the main path's
              shape, ragged S, S = 65 and 320, MHA, rep 8, D=32 and D=128,
              qwen2-vl's shape (B=8, 32 q heads on 4, S=512, D=128),
              windows of 48 to 128, softcaps, and q/k/v sliced from a fused
              projection and from rows of an odd pitch, with the copy route
              each bf16 launch was given), and the backward run twice for
              bitwise-equal dQ, dK and dV;
4. exact    — llama3.2-1b at full width in f32: ``Engine.step([Norms(),
              Grads()])``, unfused and with ``AttnCfg.flash``, against a
              per-example loop of plain (unfused) backward passes, and its
              summed gradient against a plain batch backward;
5. main     — the main path: llama3.2-1b at full width in bf16, B=8,
              S=512, three DP-SGD steps ``[Norms, Clip, Noise, GNS]`` each
              followed by an AdamW update (CUDA events split each step's
              stream time into ``Engine.step`` and the update), with the
              kernel launches of the forward and of each backward pass
              counted, every gram and
              direct launch on the TMA route, and CUDA events around the
              unfused attention core (forward and backward);
6. flash    — the same three steps with ``AttnCfg.flash=True`` on the same
              parameters, batches and noise seed: the attention runs
              through the flash kernels, whose launches per pass are
              counted; step 0's loss against phase 5's;
7. moe-exact — phi3.5-moe at full width, 2 layers, f32, B=32, S=64 (16
              dispatch groups; capacity drops may occur):
              ``Engine.step([Norms(), Grads()])`` against the per-example
              gradients of the batched loss (B ``autograd.grad`` calls over
              one plain batched forward, since capacity dispatch couples
              examples), and its summed gradient against the batch backward;
8. moe      — the MoE path: phi3.5-moe at its published widths, 2 layers,
              bf16, B=32, S=256, three DP-SGD steps ``[Norms, Clip, Noise,
              GNS]`` each followed by AdamW, the launches of each pass
              counted (3 ``segmented_norm`` launches per layer in the norms
              backward, none in the reweighted one), every non-empty
              segment on the gram route, and CUDA events around every
              segmented launch; the segment ids of its first step are
              saved to ``build/moe_seg_ids.pt`` for ``seg_times()``;
9. segmented — ``segmented_norm`` against its plain version in f32 and bf16
              at the MoE path's gate/up (4096→6400) and down (6400→4096)
              shapes with the segment ids of its first step (after phase
              22 also at the deepseek path's 5120→1536 and 1536→5120 on
              its ids, timed by ``seg_times``), a ragged T and
              p_out, all rows dropped, empty segments, one segment (direct
              route), mixed lengths (512→384, 1 to 1,500 rows on both
              routes in one launch), wide rows (28,672→8,192) and the LoRA
              tenants' example-id segments (256→8 and 8→256 in f32 at
              512 examples of S=64; 2048→8 and 8→2048 in bf16 at phase
              26's ragged batch, S=512; every segment on the direct
              route), each run twice for bitwise-equal results, each
              launch's segments and kernels by route asserted; the rows
              of a segment share a random component, so every tile pair
              weighs in the norm;
10. token-exact — llama3.2-1b at full width in f32,
              ``Engine(granularity="token")``: the (B, S) norm map against
              per-token stats summed in plain f32 from a recorded plain
              forward and backward, and ``[Clip(C, granularity="token"),
              Grads()]`` against the plain backward of Σ c_{j,t}·ℓ_{j,t}
              with c held fixed;
11. token   — the main path's model, parameters and batches (bf16, B=8,
              S=512), three steps of ``[Clip(0.5, granularity="token"),
              Grads()]`` each followed by AdamW: every per-token Σx² of
              the norms backward is a ``rowsumsq`` launch (2 per dense
              tap, 1 per scale tap, 1 for the embedding), the reweighted
              backward launches none, and no norm kernel runs; CUDA
              events around every ``rowsumsq`` launch;
12. moe-token — one phi3.5-moe token-clipping step at phase 8's shapes:
              the launches as in phase 11, every kept capacity slot's row
              the row of the token its slot → token table names, and its
              stat added at that token and nowhere else;
13. onepass — paper §6's one-pass clipping in f32 against per-example
              gradients from a loop of single-example backward passes: the
              MLP form at B=256 (4096→4096→4096) and the sequence form at
              B=8, S=512 with llama3.2-1b's MLP widths; one ``clip_scale``
              launch per tapped layer;
14. rows    — ``rowsumsq`` and ``clip_scale`` against their plain versions
              in f32 and bf16 at every shape phases 11–13 gave them, a
              ragged width, a non-contiguous (B, S) view, unaligned rows
              and a single row, each twice for bitwise-equal results
              (``clip_scale`` exactly equal, with c holding 0, 1 and values
              below 1);
15. table   — each kernel's time, plain time and bound at its path's
              shapes (gram and direct on ``device_ms``, ``time_ms`` in
              brackets, with a cuBLAS ``torch.bmm`` of the same products as
              a yardstick of the tensor cores' rate, the direct form's own
              operation floor at the head, each bf16 body's registers,
              local memory, shared memory and blocks per SM, and each
              launcher's host µs a call, ``norm_host_us``), each of
              the two kernels at the other's shapes (the route the pick
              did not take: direct at the LM head's, gram at wk/wv's) and
              gram's full grid at its own, the segmented kernel at the
              MoE path's two shapes with its ids (``device_ms`` by shape
              times launches, the path's events beside it, a cuBLAS
              ``bmm`` of each segment's Grams padded to the longest
              segment as a yardstick, the gram body's registers, local
              memory, shared memory and blocks per SM, the kernels' own
              operations over the fewest, the launcher's host µs a call,
              ``seg_host_us``, and its device time split into the sort,
              the plan and the kernels, ``seg_parts``), the flash kernels
              beside PyTorch's ``scaled_dot_product_attention`` (both on
              the device, in turns, with each kernel's registers, local
              memory, shared memory and blocks per SM, Δ = ``row_delta``
              timed beside SDPA's backward, and each launcher's host µs a
              call, ``flash_host_us``), and
              ``rowsumsq`` and ``clip_scale`` beside
              ``torch.linalg.vector_norm`` and ``torch.mul`` (each library
              call timed as a yardstick only; the port never calls it);
16. dispatch — at each bf16 launch shape of the main, gemma2, qwen2-vl,
              LoRA, rwkv6, zamba2 and seamless paths (the LoRA path's five
              rank-thin adapter shapes, rwkv6's thin mix and decay LoRAs)
              and of qwen2-7b and minitron-4b (their blocks and heads) at
              B=8, S=512, and of the deepseek path (its prefix
              and MoE layers' dense shapes and head) at B=16, S=256, the
              priced cost
              of both routes (``core.norms.dense_cost(use_kernels=True)``),
              both kernels' measured times (``norm_times()``) and the
              pick, which must be the faster kernel wherever the two
              times differ by more than ``PICK_MARGIN`` (20%);
17. train   — the port's ``Trainer`` (``repro_torch.train``) on
              llama3.2-1b at full width in bf16 with ``SyntheticLM``
              batches (B=8, S=512): 4 steps of ``consumers_for_mode("clip",
              8, noise_std=0.1)`` under AdamW with a warm-up cosine
              schedule, then 2 of ``consumers_for_mode("importance", 8)``
              (k = 2): each step's norms pass launches gram and direct by
              the priced pick on 8 examples, its gradient pass none (on 8
              examples, or on the 2 sampled ones), every launch on the TMA
              route; the trainer's metric lines, step ms and peak memory;
18. gemma2-exact — gemma2-9b at full width, 4 layers (two local/global
              periods), f32, B=4, S=256: phase 4's checks, and with
              ``AttnCfg.flash=True`` no flash launch at all (its softcap and
              local layers close the reference's gate);
19. gemma2  — gemma2-9b at full width, 4 layers, bf16, B=8, S=512: three
              steps of phase 5's consumers under AdamW, the launches of
              each pass asserted (gram and direct by the priced pick), the
              unfused attention core timed; at S=512 the window of 4,096
              does not bind, so its local and global layers compute alike
              here (the CPU tests hold the window);
20. qwen2-vl — qwen2-vl-7b at full width, 2 layers, bf16, B=8, S=512,
              with the registry's visual embeds, mask and (B, 3, S) M-RoPE
              positions and ``AttnCfg.flash=True``: the same three steps,
              the flash kernels counted (D=128, 32 q heads on 4), and step
              0's loss against a plain unfused forward on the same
              parameters and batch;
21. deepseek-exact — deepseek-v2-236b at full width, 2 layers (the dense
              prefix layer and one MoE layer: MLA, 2 shared and 160 routed
              experts, top-6), f32, B=16, S=32: ``Engine.step([Norms()])``
              against phase 7's batched-graph oracle, one f32 gradient
              tree at a time;
22. deepseek — the same at full width in bf16 (5.36B parameters), B=16
              (16 dispatch groups of one example), S=256: three steps of
              phase 5's consumers under AdamW (its loop over chunks and
              the in-place noise add keep the step on the card), 17 gram
              and 1 direct (the f32 router) launch and 3 segmented
              launches (2,560 segments of ≤ 16 rows, every one on the
              gram route) per norms backward, MLA's unfused attention core
              timed, ``Engine.step`` and AdamW stream ms and peak memory;
23. lora-exact — llama3.2-1b at full width in f32 with ``LoraCfg(rank=8,
              alpha=16.0)`` on the 7 default sites of all 16 layers (B
              factors drawn non-zero), B=4, S=256: ``Engine.step([Norms(),
              Grads()])`` over the whole LoRA-fied tree against phase 4's
              per-example loop (1e-3) and plain batch backward (1e-4), the
              frozen bases' gradients exactly zero, every adapter tap on
              direct;
24. lora    — the same model in bf16, B=8, S=512, three steps of phase 5's
              consumers each followed by AdamW on the adapters: 224
              ``direct_norm`` launches (the adapters, rank-thin) and the
              head's ``gram_norm`` per norms pass by the priced pick, none
              in the reweighted pass, every launch on the TMA route; the
              adapter launches' host µs, ``Engine.step`` and AdamW stream
              ms, norm-kernel ms and peak memory;
25. tenants-exact — ``tests/test_lora_tenancy.py``'s per-tenant oracle in
              f32 at the reference benchmark's widths (d = o = 256, r = 8,
              S = 64): 110 tenants of ragged 1–4 examples (seed 7), one
              fused ``TenantService.step`` against a loop of single-tenant
              Engines (norms, clip coefficients and each tenant's updated
              row, rtol 1e-5, atol 1e-6, its noise from its own derived
              generator), at example granularity (2 segmented launches,
              every segment on direct) and at token granularity with an
              explicit noise scale (4 ``rowsumsq`` launches); each tenant's
              noise bit for bit ``add_grad_noise`` on its tree alone; the
              example service's save and restore (``ckpt_manager=``) into
              a fresh store, its tenants renumbered into new slots: every
              row bit for bit its saved value, and one further fused step
              after the restore bit for bit the step the service takes
              without the round trip;
26. tenants — the fused DP step (norms, Clip, per-tenant Noise, SGD)
              against the plain multi-tenant LoRA step through an inert
              tap, in turns, as ``bench_lora_tenants.step_pair`` times
              them: in f32 at its 256 tenants × 2 examples, 1,024 × 1 and
              64 × 8 (d = o = 256, r = 8, S = 64), and in bf16 at
              llama3.2-1b's wq width (d = o = 2048, r = 8, α = 16,
              S = 512, 128 tenants of ragged 1–4 examples, seed 0): both
              step times and the overhead beside DESIGN.md §14's ≤ 10%
              target (reported), the segmented launches by route (every
              segment on direct, asserted), each launch's ``device_ms``
              (``tenant_seg_times``) against its bound and a cuBLAS
              ``bmm`` of H_jᵀZ̄_j over the segments, and the per-tenant
              noise add's ms;
27. rwkv6-exact — rwkv6-3b at full width, 2 layers (the reference's probe
              depth), f32, B=4, S=256: phase 4's checks, the norms over
              the pex scope (the μ's, w0 and u are trained but give no
              stat; the summed gradient covers them), the gram and direct
              launches those of the priced pick and nothing else;
28. rwkv6   — the same in bf16, B=8, S=512, three steps of phase 5's
              consumers under AdamW: 17 gram (r/k/v/g/o and the channel
              mix's three, the head) and 16 direct (the thin mix and decay
              LoRAs, mix_b on strided views) launches a norms pass by the
              priced pick, asserted, none in the reweighted pass, every
              launch on TMA; the WKV recurrence (chunked, f32) timed by
              events; each launch shape's ``device_ms`` against its bound
              and a cuBLAS ``bmm``;
29. zamba2-exact — zamba2-7b at full width, 9 layers (the reference's
              third probe: one group of 6 mamba blocks, the shared block
              once, 3 tail blocks), f32, B=4, S=256: phase 27's checks;
              the shared block's leaves (and the SSMs' conv and decay
              tensors) take the batch backward's gradient and no stat, and
              no launch comes from the shared block;
30. zamba2  — the same in bf16, B=8, S=512: 19 gram launches a norms pass
              (in_proj 3584 → 14,576 and out_proj of 9 blocks, the head),
              the SSD recurrence and the shared block's attention core
              timed, peak memory;
31. seamless-exact — seamless-m4t-medium at full depth (12 + 12 layers,
              0.88B parameters), f32, B=4, S=S_src=256: phase 27's checks;
32. seamless — the same in bf16, B=8, S=S_src=512: 144 direct (the
              1024 ↔ 1024 projections, self and cross) and 49 gram (the
              MLPs and the 1024 → 256,208 head) launches a norms pass by
              the priced pick, the unfused attention cores timed;
33. serve-exact — serving (``forward_tokens`` with caches) at full width in
              f32 for all ten archs, each at its training phases' depth
              (llama3.2-1b and seamless at full depth), B=2, S=32: prefill
              31 tokens (qwen2-vl with its visual embeds and (B, 3, S)
              positions, seamless from ``src_frames``), decode 1, the last
              logits against the full forward at 2e-3 (MoE archs at
              ``capacity_factor = n_experts``: no drops); rwkv6 and zamba2
              also a two-segment prefill (5 + rest) against one shot; each
              arch's cache bytes a slot; no counted kernel launched;
34. serve   — the slice's path: ``serve.Engine.generate`` on llama3.2-1b
              at full depth and width in bf16, 16 slots of 2,048 cache
              rows, 32 requests (prompts of 64–512 tokens from numpy seed
              0, 128 new tokens each), greedy: every request gets its 128
              tokens, a repeat of the first batch gives the same tokens,
              no counted kernel launches; prefill ms per batch, the median
              decode step's stream ms (events) against the host's ms to
              queue it and its kernels' device ms (profiler), its byte bound
              (weights and the KV rows read at 3.35 TB/s), tokens/s, peak
              and KV-cache GiB;
35. serve-families — 8 requests × 32 new tokens through ``Engine.generate``
              in bf16 for deepseek-v2-236b (2 layers: MLA's latent cache,
              160 experts), phi3.5-moe (2), gemma2-9b (4), qwen2-vl-7b (2),
              rwkv6-3b (2) and zamba2-7b (9), prompts of 16–128 tokens;
              seamless-m4t-medium at full depth through ``forward_tokens``
              prefilled from source frames; phase 34's numbers for each;
36. dp-exact — data parallelism (``dist.pex``) at two ranks: both on
              cuda:0 over gloo (NCCL refuses two ranks on one card; the
              card's compute mode must be ``Default``), each spawned, a
              ``make_host_mesh()`` mesh, llama3.2-1b at full width, 2
              layers, f32, B=4, S=256: ``Engine(mesh=)``'s
              ``value_grads_and_norms``, ``value_and_norms``,
              ``clipped_step`` without and with noise and ``step([Clip,
              GNS])`` against the one-process ``Engine`` on the first rank
              at the reference selfcheck's tolerances (loss 1e-5, norms
              1e-4, gradients rtol 1e-4 / atol 1e-5 of each leaf's
              largest |value|) and bit for bit against the two shards'
              one-process passes summed (and noised), both ranks' noised
              gradients bit for bit equal, each rank's gram and direct
              launches per pass those of one process on its 2 rows;
37. dp      — the slice's path: phase 17's clip steps (same seeds and
              schedule) through ``Trainer(mesh=make_host_mesh())`` on a
              one-rank NCCL group, llama3.2-1b at full depth and width in
              bf16, B=8, S=512: the parameters after the steps bit for bit
              phase 17's (a digest of each leaf), the launches of each pass
              phase 5's, the stream ms of the gradient all-reduce and of the
              per-example gathers (events), step ms beside phase 17's, peak
              memory; then ``python -m repro_torch.launch.train --arch
              llama3.2-1b --smoke --data-parallel --steps 2`` once (exit 0).
38. ckpt    — checkpointing: phase 17's trainer (llama3.2-1b at full width
              in bf16, B=8, S=512, ``SyntheticLM``, AdamW with the warm-up
              cosine schedule) with ``consumers_for_mode("clip", 8)`` and no
              noise (nothing is drawn): 4 steps straight; 2 steps with
              ``ckpt_every=2``; a fresh trainer's ``train(resume=True)`` to
              4 (saving step 4 too): its parameters, moments and optimizer
              step bit for bit the straight run's (per-leaf sha256), its
              last two losses the straight run's; then the newest step
              corrupted by ``ft.corrupt_newest_checkpoint``:
              ``restore_from`` warns, falls back to step 2 and gives step
              2's digest. Full depth when the temporary directory has 3×
              the state's bytes free (``keep=2``), else 2 layers; it raises
              with both numbers when even that does not fit. Each norms
              pass launches gram and direct by the priced pick (phase 5's
              counts), the reweighted pass none. Logs the state's GiB, the
              ms ``save()`` blocks the step loop (the device→host copy),
              the writer's seconds to commit and its GB/s, the restore's
              seconds (read, sha256, host→device) and peak memory;
39. soak    — ``python -m repro_torch.launch.soak --hosts 4 --steps 24
              --storm short --device cuda``: 4 gloo ranks on cuda:0 (compute
              mode ``Default``), the ``short`` storm with its three
              invariants; exit 0, and the summary's coverage (≥ 2
              contractions, ≥ 1 expansion, ≥ 1 fallback, the quarantine of
              exactly the poisoned rows); its wall time.

Every kernel is called through its ``repro_torch.kernels.ops`` wrapper,
the one the main path goes through. A kernel's bound is the least time the
card could take for the function, whichever route computes it: the input
bytes over the HBM rate or the fewer operations of the two routes
(``ops.flop_estimate``; per segment for ``segmented_norm``,
``ops.segmented_flop_estimate``, over the rows this run keeps) over the
bf16 tensor-core peak, whichever is longer.

The flash path's step time, peak memory and attention time are logged
beside the main path's from the same call, the MoE path's step time,
peak memory and segmented kernel time per step after them, then the token
paths' step times, peak memory and ``rowsumsq`` time per step, those of
gemma2, qwen2-vl, deepseek and the LoRA path, the tenant steps, those of
rwkv6, zamba2 and seamless, the served paths' decode steps and tokens
per second, the data-parallel phases' seconds, step ms and collective
stream ms, and the whole run's seconds.
``update_times()`` (not in a whole run) times one AdamW update and one
in-place noise add, with the transient memory of each. TF32 is off
for matmuls and cuDNN throughout, so the f32 plain versions are full f32.
The last line of standard output is ``{"ok": true, "device": {...}}``; the
line before it is the kernel table as JSON, and the line before that the
``nvidia-smi`` reading.
"""
from __future__ import annotations

import dataclasses
import datetime
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

B, S = 8, 512            # main path batch and sequence length
EXACT_B, EXACT_S = 4, 256
MOE_LAYERS = 2           # phi3.5-moe depth cut 32 → 2 (the reference's
                         # own probe depth); widths as published
MOE_B, MOE_S = 32, 256   # MoE path: ng=16 groups of bg=2, capacity 88
MOE_EXACT_B, MOE_EXACT_S = 32, 64
GEMMA_LAYERS = 4         # gemma2-9b depth cut 42 → 4: two local/global
                         # periods, the reference's own probe depth
VL_LAYERS = 2            # qwen2-vl-7b depth cut 28 → 2 (its probe depth)
DS_LAYERS = 2            # deepseek-v2-236b depth cut 60 → 2 (the reference's
                         # probe depth): the dense prefix and one MoE layer
DS_B, DS_S = 16, 256     # deepseek path: 16 dispatch groups of one example,
                         # capacity 16, so 2,560 segments of <= 16 rows
DS_EXACT_B, DS_EXACT_S = 16, 32
#: phases 27–32: (arch, depth cut (None: full depth), tag); every depth cut
#: one of the reference's probe depths, every width as published
FAMILY_PATHS = (("rwkv6-3b", 2, "rwkv6"),        # 32 → 2
                ("zamba2-7b", 9, "zamba2"),      # 81 → 9: one group of 6,
                                                 # the shared block once,
                                                 # 3 tail blocks
                ("seamless-m4t-medium", None, "seamless"))   # 12 + 12
STEPS = 3
T0 = 0.0                 # perf_counter at the start of main()
PEAK_BYTES_PER_S = 3.35e12                      # H100 SXM HBM3
PEAK_FLOPS = {"torch.bfloat16": 989e12,         # dense tensor-core bf16
              "torch.float32": 67e12}           # f32 outside tensor cores
TOL = {"torch.float32": 1e-4,    # summation order only
       "torch.bfloat16": 5e-4}   # bf16 inputs, whose products are exact
                                 # in f32; both sides accumulate in f32 in
                                 # another order (worst reading 5.92e-5,
                                 # gram at the head). A 128-wide p_out
                                 # column of G dropped or doubled at the
                                 # head moves the norm by ~1/1002 = 1e-3
FLASH_TOL = {"torch.float32": 1e-4,   # of each output's max |value|:
                                      # summation order only
             "torch.bfloat16": 1e-2}  # O, dQ, dK, dV round to bf16
                                      # (2^-8 = 3.9e-3 of the value) and
                                      # the kernels round P and dS to bf16
                                      # for the tensor cores; both sides
                                      # accumulate in f32
LSE_TOL = 1e-4                        # of max |lse|, both types: f32 sums
                                      # of the same bf16/f32 products
LOSS_TOL = 5e-3                       # relative, flash vs unfused step-0
                                      # loss in bf16: the two routes round
                                      # the attention to bf16 at different
                                      # points; more than ~1 bf16 ulp of
                                      # the loss would be another function
SOURCES = {"gram_norm": ("src/repro_torch/csrc/gram_norm.cu",
                         "src/repro/kernels/gram_norm.py:297"),
           "direct_norm": ("src/repro_torch/csrc/direct_norm.cu",
                           "src/repro/kernels/direct_norm.py:141"),
           "segmented_norm": ("src/repro_torch/csrc/segmented_norm.cu",
                              "src/repro/kernels/segmented_norm.py:204"),
           "gram_norm_full": ("src/repro_torch/csrc/gram_norm.cu",
                              "src/repro/kernels/gram_norm.py:254"),
           "rowsumsq": ("src/repro_torch/csrc/rowsumsq.cu",
                        "src/repro/kernels/rowsumsq.py:58"),
           "clip_scale": ("src/repro_torch/csrc/clip_scale.cu",
                          "src/repro/kernels/clip_scale.py:56"),
           "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                               "src/repro/kernels/flash_attention.py:182"),
           "flash_attention_bwd_dq": (
               "src/repro_torch/csrc/flash_attention.cu",
               "src/repro/kernels/flash_attention.py:337"),
           "flash_attention_bwd_dkv": (
               "src/repro_torch/csrc/flash_attention.cu",
               "src/repro/kernels/flash_attention.py:361")}
ROW_TOL = 1e-5                        # rowsumsq vs its plain version, both
                                      # types, relative: f32 sums of the
                                      # same squares in another order (bf16
                                      # squares are exact in f32)
TOKEN_TOL = 1e-4                      # token-exact and onepass, f32 vs
                                      # plain autograd: summation order
ONEPASS_B, ONEPASS_D = 256, 4096      # §6 MLP form: B, widths D→D→D
# segment sizes of phase 9's mixed case at 512 → 384 (the gram route takes
# up to 376 rows there): one and three tile pairs, both sides of the
# crossover, an empty segment, and 1,500 rows on the direct route
MIXED_SIZES = (1, 5, 30, 63, 64, 65, 129, 250, 376, 377, 0, 700, 1500, 90)
NORM_KERNELS = ("gram_norm", "direct_norm")
FLASH_KERNELS = ("flash_attention", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv")
# (B, Hq, Hkv, S, D, softcap, window, layout) of the flash kernel checks:
# the main path's shape first. Layout None is the model's: (B, H, S, D)
# views of (B, S, H, D) projections. "fused" slices q, k and v out of one
# (B, S, Hq + 2 Hkv, D) tensor (strides in 16-byte multiples: the bf16
# kernels' TMA route); "odd" slices each out of a (B, S, H, D + 1) tensor
# (strides no 16-byte multiple: the synchronous route, at D = 64, 128 and
# 32, whose tiles are laid out apart)
FLASH_CASES = [(B, 32, 8, S, 64, None, None, None),
               (2, 8, 2, 200, 64, None, None, None),
               (2, 4, 4, 256, 64, None, None, None),
               (2, 4, 4, 192, 32, None, None, None),
               (2, 8, 2, 256, 128, None, None, None),
               (2, 8, 2, S, 64, None, 128, None),
               (2, 8, 2, 256, 64, 50.0, None, None),
               (1, 4, 2, 333, 64, 30.0, 100, None),
               (2, 8, 2, 320, 64, None, None, None),     # S = 5 x 64
               (2, 4, 2, 65, 64, None, None, None),      # one row past
               (2, 8, 2, 256, 64, None, 48, None),       # window < a tile
               (2, 32, 4, 256, 64, None, None, None),    # rep = 8
               (B, 32, 4, S, 128, None, None, None),     # qwen2-vl's
               (2, 8, 2, 200, 64, None, None, "fused"),
               (2, 8, 2, 200, 64, None, None, "odd"),
               (1, 8, 2, 320, 128, 20.0, 48, "odd"),
               (2, 4, 2, 200, 32, None, None, "odd")]


def log(msg: str) -> None:
    print(msg, flush=True)


def rel_err(got, want):
    return ((got - want).abs() / want.abs()).max().item()


def norm_key(h, z, *_):
    """(dtype, b, s, p_in, p_out) of a gram or direct launch on ``h``,
    ``z``: the key by which phase 3 holds each launch shape of a path."""
    return (str(h.dtype),) + tuple(h.shape) + (z.shape[-1],)


def router_shapes(cfg):
    """(p_in, p_out) of the MoE router: the one dense tap whose weight, and
    so whose gram/direct launch, stays f32 in a bf16 model."""
    return ([(cfg.d_model, cfg.moe.n_experts)]
            if getattr(cfg, "moe", None) is not None else [])


def layer_shapes(cfg, dense_mlp=False):
    """(p_in, p_out) of every tapped dense layer of one block that the
    gram/direct dispatch takes: attention (GQA's four projections or MLA's
    five), then the MLP (a prefix layer's own with ``dense_mlp``) or the MoE
    router (f32) and shared MLP (the MoE experts go to
    ``segmented_norm``)."""
    d = cfg.d_model
    if cfg.lora is not None:
        return lora_shapes(cfg, dense_mlp)
    if cfg.mla is not None:
        m = cfg.mla
        attn = [(d, m.q_lora), (m.q_lora, m.n_heads * (m.qk_nope + m.qk_rope)),
                (d, m.kv_lora + m.qk_rope),
                (m.kv_lora, m.n_heads * (m.qk_nope + m.v_dim)),
                (m.n_heads * m.v_dim, d)]
    else:
        a = cfg.attn
        hq, hkv = a.n_heads_p * a.head_dim, a.n_kv * a.head_dim
        attn = [(d, hq), (d, hkv), (d, hkv), (hq, d)]
    if cfg.moe is not None and not dense_mlp:
        f = cfg.moe.n_shared * cfg.moe.d_ff
        shared = [(d, f), (d, f), (f, d)] if f else []
        return attn + [(d, cfg.moe.n_experts)] + shared
    mcfg = cfg.dense_prefix_mlp if dense_mlp and cfg.dense_prefix_mlp \
        else cfg.mlp
    f = mcfg.d_ff
    return attn + ([(d, f)] if mcfg.gated else []) + [(d, f), (f, d)]


def lora_shapes(cfg, dense_mlp=False):
    """(p_in, p_out) of every tapped dense layer of one block of a
    LoRA-fied GQA config with a dense MLP: each site's two factors, A (p_in
    → r) and B (r → p_out), in the order of ``layer_shapes`` (the frozen
    bases are not tapped)."""
    if cfg.mla is not None or cfg.moe is not None:
        raise NotImplementedError("chip_smoke's LoRA shapes are those of a "
                                  "GQA config with a dense MLP")
    base = layer_shapes(dataclasses.replace(cfg, lora=None), dense_mlp)
    names = ["wq", "wk", "wv", "wo"] + (["gate"] if cfg.mlp.gated else []) \
        + ["up", "down"]
    out = []
    for name, (pi, po) in zip(names, base):
        if name in cfg.lora.sites:
            r = cfg.lora.rank_for(name)
            out += [(pi, r), (r, po)]
    return out


def family(cfg) -> str:
    """The model family of a config: transformer, rwkv6, zamba2 or
    seamless."""
    if hasattr(cfg, "rwkv_cfg"):
        return "rwkv6"
    if hasattr(cfg, "ssm"):
        return "zamba2"
    if hasattr(cfg, "n_enc"):
        return "seamless"
    return "transformer"


def family_shapes(cfg):
    """[(shapes of one block, blocks of that kind)] of the tapped dense
    layers of rwkv6 (the time mix's mix_a, its five mix_b slices (32 →
    d on a strided view), r/k/v/g, the decay LoRA and wo; the channel mix's
    k, v and r), zamba2 (each mamba block's in_proj and out_proj; the
    shared block's tap is inert) and seamless (the encoder's attention and
    MLP, the decoder's self and cross attention and MLP)."""
    d = cfg.d_model
    fam = family(cfg)
    if fam == "rwkv6":
        r = cfg.rwkv_cfg
        tmix = ([(d, 5 * r.mix_lora)] + [(r.mix_lora, d)] * 5 + [(d, d)] * 4
                + [(d, r.decay_lora), (r.decay_lora, d), (d, d)])
        return [(tmix + [(d, r.d_ff), (r.d_ff, d), (d, d)], cfg.n_layers)]
    if fam == "zamba2":
        c = cfg.ssm
        return [([(d, 2 * c.d_inner + 2 * c.d_state + c.n_heads),
                  (c.d_inner, d)], cfg.n_layers)]
    a = cfg.attn_cfg()
    hq, hkv = a.n_heads_p * a.head_dim, a.n_kv * a.head_dim
    attn = [(d, hq), (d, hkv), (d, hkv), (hq, d)]
    mlp = [(d, cfg.d_ff), (cfg.d_ff, d)]
    return [(attn + mlp, cfg.n_enc), (attn + attn + mlp, cfg.n_dec)]


def head_shape(cfg):
    """(p_in, p_out) of the LM head's launch: the vocab padded to its
    multiple (seamless's 256,206 → 256,208)."""
    return (cfg.d_model, cfg.vocab_cfg.vocab_p)


def model_shapes(cfg):
    """[(shapes of one block, layers of that kind)]: the dense prefix
    layers, then the blocks (the other families: ``family_shapes``)."""
    if family(cfg) != "transformer":
        return family_shapes(cfg)
    n_pre = cfg.n_dense_prefix
    out = [(layer_shapes(cfg, dense_mlp=True), n_pre)] if n_pre else []
    return out + [(layer_shapes(cfg), cfg.n_layers - n_pre)]


def cut(spec, n_layers, **kw):
    """``spec``'s published config at ``n_layers`` layers, every width as
    published."""
    return dataclasses.replace(spec.full(**kw), n_layers=n_layers)


def with_flash(cfg):
    """``cfg`` with ``AttnCfg.flash`` set (MLA has no flash route: an MLA
    config is returned as it is)."""
    if getattr(cfg, "attn", None) is None:
        return cfg
    return dataclasses.replace(cfg, attn=dataclasses.replace(cfg.attn,
                                                             flash=True))


def moe_layers(cfg):
    """Layers with a MoE FFN: all but the dense prefix."""
    if getattr(cfg, "moe", None) is None:
        return 0
    return cfg.n_layers - cfg.n_dense_prefix


def main_path_launches(cfg, s):
    """{kernel: {(p_in, p_out): launches per step}} from the port's own
    dispatch: each block's dense layers (a dense prefix layer's apart from
    the MoE layers') and the LM head by the priced pick
    (``pick_method(..., use_kernels=True)``)."""
    from repro_torch.core.norms import pick_method
    out = {"gram_norm": {}, "direct_norm": {}}
    shapes = [(sh, n) for block, n in model_shapes(cfg) for sh in block]
    for (pi, po), n in shapes + [(head_shape(cfg), 1)]:
        k = pick_method(s, pi, po, use_kernels=True) + "_norm"
        out[k][(pi, po)] = out[k].get((pi, po), 0) + n
    return out


def pass_launches(expected, cfg):
    """Launches of every counted kernel in the tapped forward, the norms
    backward and the reweighted backward of one step: the norm kernels in
    the norms backward only (with MoE, three segmented launches per MoE
    layer: gate, up, down); with ``AttnCfg.flash``, one forward launch per
    layer in the forward and one dQ and one dK/dV launch per layer in each
    backward."""
    from repro_torch.kernels import ops
    flash = getattr(cfg, "attn", None) is not None and cfg.attn.flash
    zero = dict.fromkeys(ops.launch_counts(), 0)
    norms = {k: sum(v.values()) for k, v in expected.items()}
    if moe_layers(cfg):
        norms["segmented_norm"] = 3 * moe_layers(cfg)
    bwd = ({"flash_attention_bwd_dq": cfg.n_layers,
            "flash_attention_bwd_dkv": cfg.n_layers} if flash else {})
    return ({**zero, "flash_attention": cfg.n_layers if flash else 0},
            {**zero, **norms, **bwd}, {**zero, **bwd})


def token_pass_launches(cfg):
    """Launches of every counted kernel in the tapped forward, the norms
    backward and the reweighted backward of one token-clipping step: in the
    norms backward one ``rowsumsq`` per operand of every per-token stat —
    two per dense or expert tap (h and z̄), one per bias tap (z̄), one per
    scale tap (h ⊙ z̄: two RMSNorms a layer, two more for gemma2's sandwich
    norms or MLA's q_norm and kv_norm) and one for the embedding (z̄) — and
    nothing else; nothing in the other two passes."""
    from repro_torch.kernels import ops
    zero = dict.fromkeys(ops.launch_counts(), 0)
    dense = sum(len(block) * n for block, n in model_shapes(cfg)) + 1  # head
    expert = 3 * moe_layers(cfg)                             # gate, up, down
    bias = (3 * cfg.n_layers if cfg.attn is not None and cfg.attn.bias
            else 0)                                          # wq, wk, wv
    per_layer = 2 + 2 * cfg.post_norms + 2 * (cfg.mla is not None)
    scale = per_layer * cfg.n_layers + 1                     # and ln_f
    n = 2 * (dense + expert) + bias + scale + 1              # and the embed
    return dict(zero), {**zero, "rowsumsq": n}, dict(zero)


class RecordingTap:
    """A plain forward in which every op a live tap would instrument is its
    untapped counterpart, recording the op's input and, through a tensor
    hook, the cotangent of its output, and the per-token loss map: the
    port's taps, layouts and kernels take no part in it."""
    live = False

    def __init__(self, spec):
        self.spec = spec
        self.ops = []
        self.token_map = None

    def _rec(self, kind, h, z):
        rec = {"kind": kind, "h": h.detach()}
        self.ops.append(rec)
        z.register_hook(lambda g: rec.__setitem__("zbar", g.detach()))
        return z

    def dense(self, h, w, *, group="all", method=None):
        return self._rec("dense", h, h @ w)

    def bias_add(self, x, b, *, group="all"):
        return self._rec("bias", x, x + b)

    def scale(self, h, g, *, group="all"):
        return self._rec("scale", h, h * g)

    def embedding(self, table, ids, *, group="embed"):
        return self._rec("embed", ids, table[ids])

    def token_loss(self, token_losses):
        self.token_map = token_losses
        return token_losses

    def token_stats(self):
        """Each token's squared gradient norm summed over the recorded ops
        in plain f32: ‖h_t‖²·‖z̄_t‖² for a dense op, ‖h_t ⊙ z̄_t‖² for a
        scale, ‖z̄_t‖² for a bias or an embedding."""
        import torch

        def sq(x):
            return torch.sum(torch.square(x.float()), dim=-1)
        total = 0.0
        for r in self.ops:
            h, z = r["h"], r["zbar"]
            total = total + {"dense": lambda: sq(h) * sq(z),
                             "scale": lambda: sq(h.float() * z.float()),
                             "bias": lambda: sq(z),
                             "embed": lambda: sq(z)}[r["kind"]]()
        return total


class AttentionEvents:
    """CUDA events around the attention core of every layer: the forward
    call, and in each backward pass the span from the cotangent's arrival
    at the core's output to the last cotangent leaving q, k and v (tensor
    hooks, which run on the autograd stream in the order the grads are
    formed)."""

    def __init__(self, fn):
        self.fn = fn
        self.fwd, self.bwd = [], []

    def _event(self):
        import torch
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def __call__(self, q, k, v, *a, **kw):
        e0 = self._event()
        y = self.fn(q, k, v, *a, **kw)
        self.fwd.append((e0, self._event()))
        if y.requires_grad:
            y.register_hook(lambda g: self.bwd.append(("start",
                                                       self._event())))
            for x in (q, k, v):
                x.register_hook(lambda g: self.bwd.append(("end",
                                                           self._event())))
        return y

    def clear(self):
        self.fwd.clear()
        self.bwd.clear()

    def ms(self):
        """(forward ms, backward ms) summed over the calls since clear()."""
        fwd = sum(a.elapsed_time(b) for a, b in self.fwd)
        bwd, start, last = 0.0, None, None
        for kind, e in self.bwd + [("start", None)]:
            if kind == "start":
                if start is not None and last is not None:
                    bwd += start.elapsed_time(last)
                start, last = e, None
            else:
                last = e
        return fwd, bwd


def time_ms(fn, reps):
    """Mean device time of ``fn()`` over ``reps`` runs after one warm-up,
    from CUDA events."""
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


L2_BYTES = 50 * 2**20    # H100 L2 cache


def device_ms(fn, inputs, reps):
    """Mean device time of ``fn(x)`` over ``reps`` runs after one warm-up,
    ``x`` cycling through ``inputs`` (copies enough to exceed twice the L2
    cache, so each run reads its input from device memory as the path
    does). The card is held busy (``torch.cuda._sleep``) while the host
    queues the runs, so the events time the kernels back to back and not
    the host's launch overhead, which exceeds a small kernel's own time."""
    import torch
    fn(inputs[0])
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)     # ~25 ms at the H100's clocks
    start.record()
    for i in range(reps):
        fn(inputs[i % len(inputs)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_device():
    import torch
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"[device] {name}; count {torch.cuda.device_count()}; "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    log(f"[device] nvidia-smi: {smi}")
    log("[device] TF32 off: torch.backends.cuda.matmul.allow_tf32 = False, "
        "torch.backends.cudnn.allow_tf32 = False")
    return name, smi


def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.load()
    log(f"[build] {_build.lib_path()} in {time.perf_counter() - t0:.1f} s")
    for line in _build.build_log().splitlines():
        if ("Used" in line or "Compiling entry" in line
                or "Performance Loss" in line
                or ("spill stores" in line
                    and " 0 bytes spill stores" not in line)):
            log(f"[build] {line.strip()}")


def phase_kernels(cfg, errs, others=(), f32_others=()):
    """Every kernel against its plain version; ``errs`` collects the max
    abs error of each kernel at the main path's shapes in bf16. The other
    paths ``others``, each (config, B, S) (phi3.5-moe at (MOE_B, MOE_S),
    gemma2-9b and qwen2-vl-7b at (B, S), deepseek-v2-236b at (DS_B,
    DS_S)), add their block shapes (a dense prefix layer's too) and heads
    in bf16 at their own (B, S), the shape its path launches, so on the
    path's plan (gram's feature ranges and scratch follow B); their MoE
    routers, whose weights stay f32, are held in f32 at that (B, S)
    against both plain versions. ``f32_others``, each (config, B, S) (the
    exact phases 27, 29 and 31), add their block shapes and heads in f32
    at their (B, S). rwkv6's 32 → d_model launches take their h as the
    path does: a (B, S, 32) view at a 160-element row pitch into
    tanh(mix_a)'s output, at the offset of slice 1 (and in bf16 at each of
    the five slices' offsets, TMA asserted). The bf16 launches at the other
    families' shapes repeat bit for bit too. The other heads' direct_norm_ref would
    hold a (B, p_in, p_out) f32 product of 29 GB, so both kernels are held
    against gram_norm_ref there. Each bf16 gram and direct launch's copy
    route is the one its inputs call for (TMA here; the staged route on
    rows of an odd pitch), and the bf16 launches at the main path's and
    the head's shapes repeat bit for bit. Returns the launch shapes
    checked, keyed as ``norm_key`` keys a path's launches."""
    import torch
    from repro_torch.kernels import direct_norm as dn
    from repro_torch.kernels import gram_norm as gn
    from repro_torch.kernels import ops
    from repro_torch.kernels.direct_norm import direct_norm_ref
    from repro_torch.kernels.ref import gram_norm_ref

    gen = torch.Generator(device="cuda").manual_seed(0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    main = [(B, S, pi, po) for pi, po in sorted(set(layer_shapes(cfg)))]
    cases = [(3, 37, 80, 200)] + main + [(B, S, cfg.d_model, cfg.vocab)]
    def shapes_of(paths):
        return {(b, s, pi, po) for c, b, s in paths
                for block, _ in model_shapes(c) for pi, po in block}
    heads = sorted({(b, s) + head_shape(c) for c, b, s in others}
                   - set(cases))
    routers = sorted({(b, s, pi, po) for c, b, s in others
                      for pi, po in router_shapes(c)})
    extra = sorted(shapes_of(others) - set(main) - set(routers)) + heads
    exact_heads = {(b, s) + head_shape(c) for c, b, s in f32_others}
    exact = sorted(shapes_of(f32_others) | exact_heads)
    families = [(c, b, s) for c, b, s in list(others) + list(f32_others)
                if family(c) != "transformer"]
    strided = {(b, s, c.rwkv_cfg.mix_lora, c.d_model) for c, b, s in families
               if family(c) == "rwkv6"}
    # the LoRA adapters' rank-thin shapes (one side r) and the other
    # families' shapes: repeated bit for bit too
    thin = ({c for c in extra if min(c[2:]) <= 16} | shapes_of(families)
            | {(b, s) + head_shape(c) for c, b, s in families})
    checked = set()
    for dt in (torch.float32, torch.bfloat16):
        tol = TOL[str(dt)]
        bf = dt == torch.bfloat16
        # the llama head stays last: the gram-vs-direct check reads it
        for b, s, pi, po in cases[:-1] + (extra if bf else routers + exact) \
                + cases[-1:]:
            if (b, s, pi, po) in strided:
                # rwkv6's mix_b input: slice 1 of tanh(mix_a) as a view
                h = torch.randn(b, s, 5 * pi, generator=gen,
                                device="cuda").to(dt)[..., pi:2 * pi]
            else:
                h = torch.randn(b, s, pi, generator=gen, device="cuda").to(dt)
            z = torch.randn(b, s, po, generator=gen, device="cuda").to(dt)
            want_g = gram_norm_ref(h, z)
            want_d = (want_g if (b, s, pi, po) in heads
                      or (not bf and (b, s, pi, po) in exact_heads)
                      else direct_norm_ref(h, z))
            gn.route_launches.clear()
            dn.route_launches.clear()
            got = {"gram_norm": ops.gram_norm(h, z),
                   "gram_norm_full": ops.gram_norm(h, z, triangular=False),
                   "direct_norm": ops.direct_norm(h, z)}
            routes = {**gn.route_launches, **dn.route_launches}
            want_routes = ({("gram", "tma"): 2, ("direct", "tma"): 1}
                           if bf else {})
            if routes != want_routes:
                raise AssertionError(f"norm routes {routes} at "
                                     f"{(b, s, pi, po)} {dt}, expected "
                                     f"{want_routes}")
            torch.cuda.synchronize()
            want = {"gram_norm": want_g, "gram_norm_full": want_g,
                    "direct_norm": want_d}
            line = []
            for k, v in got.items():
                r = rel_err(v, want[k])
                line.append(f"{k} rel {r:.2e}")
                if not r <= tol:
                    raise AssertionError(
                        f"{k} disagrees with its plain version at "
                        f"{(b, s, pi, po)} {dt}: rel err {r} > {tol}")
                if bf and (b, s, pi, po) in main + cases[-1:]:
                    errs[k] = max(errs.get(k, 0.0),
                                  (v - want[k]).abs().max().item())
            r_tf = rel_err(got["gram_norm"], got["gram_norm_full"])
            line.append(f"tri-vs-full rel {r_tf:.2e}")
            if not r_tf <= tol:
                raise AssertionError(f"triangular vs full grid: {r_tf}")
            if bf and ((b, s, pi, po) in main + cases[-1:]
                       or (b, s, pi, po) in thin):
                for k, again in (("gram_norm", ops.gram_norm(h, z)),
                                 ("direct_norm", ops.direct_norm(h, z))):
                    if not torch.equal(got[k], again):
                        raise AssertionError(f"{k} not bitwise repeatable "
                                             f"at {(b, s, pi, po)}")
                line.append("gram and direct bitwise equal on a second run")
            how = ", TMA route" if bf else ""
            if (b, s, pi, po) in strided:
                how += (f", h a view at row pitch {h.stride(1)} and offset "
                        f"{h.storage_offset()}")
            if (b, s, pi, po) in routers and not bf:
                # the least time of the f32 router's launch on the card
                by = {"bytes": 4 * (h.numel() + z.numel() + b)
                      / PEAK_BYTES_PER_S,
                      "operations": ops.flop_estimate(b, s, pi, po)
                      / PEAK_FLOPS[str(dt)]}
                kind = max(by, key=by.get)
                how += f", bound {1e3 * by[kind]:.4f} ms ({kind})"
            if bf and po > 100_000:
                p = gn.plan(b, s, pi, po, True, sms)
                how += (f", plan {p.n_h}x{p.n_z} feature ranges, scratch "
                        f"{4 * math.prod(p.gram_shape(b)) / 1e6:.1f} MB")
            checked.add((str(dt), b, s, pi, po))
            log(f"[kernels] {str(dt)[6:]} {(b, s, pi, po)}{how}: "
                + ", ".join(line) + f" (tol {tol})")
            del h, z, want_g, want_d
        # gram against direct: the identity the kernels rest on
        r = rel_err(got["gram_norm"], got["direct_norm"])
        log(f"[kernels] {str(dt)[6:]} gram vs direct at the head shape: "
            f"rel {r:.2e} (tol {tol})")
        if not r <= tol:
            raise AssertionError(f"gram vs direct disagree: {r}")
    # rwkv6's mix_b launches at each of the five slices' offsets (0 to 256
    # bytes into a 320-byte row): TMA, as the path's launches take it
    for b, s, r, d in sorted(strided):
        base = torch.randn(b, s, 5, r, generator=gen, device="cuda").to(
            torch.bfloat16)
        z = torch.randn(b, s, d, generator=gen, device="cuda").to(
            torch.bfloat16)
        line = []
        for i in range(5):
            h = base[:, :, i]
            gn.route_launches.clear()
            dn.route_launches.clear()
            want = gram_norm_ref(h, z)
            got = {"gram_norm": ops.gram_norm(h, z),
                   "direct_norm": ops.direct_norm(h, z)}
            routes = {**gn.route_launches, **dn.route_launches}
            if routes != {("gram", "tma"): 1, ("direct", "tma"): 1}:
                raise AssertionError(f"norm routes {routes} at rwkv6's "
                                     f"mix_b slice {i}, expected TMA")
            for k, v in got.items():
                r_err = rel_err(v, want)
                if not r_err <= TOL["torch.bfloat16"]:
                    raise AssertionError(f"{k} at rwkv6's mix_b slice {i}: "
                                         f"rel err {r_err}")
                if not torch.equal(v, getattr(ops, k)(h, z)):
                    raise AssertionError(f"{k} not bitwise repeatable at "
                                         f"rwkv6's mix_b slice {i}")
            line.append(f"slice {i} (offset {2 * h.storage_offset()} B) "
                        + ", ".join(f"{k} rel {rel_err(v, want):.2e}"
                                    for k, v in got.items()))
        log(f"[kernels] bf16 {(b, s, r, d)} rwkv6 mix_b views, TMA route, "
            f"bitwise equal on a second run: " + "; ".join(line))
    # rows of an odd pitch from a base off the 16-byte grid: no tensor map
    # describes them, so both bf16 launches take the staged route
    h = torch.randn(3, 40, 25, generator=gen, device="cuda").to(
        torch.bfloat16)[:, :, 1:]
    z = torch.randn(3, 40, 37, generator=gen, device="cuda").to(
        torch.bfloat16)[:, :, 1:]
    gn.route_launches.clear()
    dn.route_launches.clear()
    want = gram_norm_ref(h, z)
    got = {"gram_norm": ops.gram_norm(h, z),
           "direct_norm": ops.direct_norm(h, z)}
    routes = {**gn.route_launches, **dn.route_launches}
    if routes != {("gram", "synchronous"): 1, ("direct", "synchronous"): 1}:
        raise AssertionError(f"norm routes {routes} on rows of an odd "
                             f"pitch, expected the staged route")
    tol = TOL["torch.bfloat16"]
    for k, v in got.items():
        r = rel_err(v, want)
        if not r <= tol:
            raise AssertionError(f"{k} on the staged route: rel err {r} > "
                                 f"{tol}")
    log(f"[kernels] bf16 (3, 40, 24, 36) rows of an odd pitch, staged "
        f"route: " + ", ".join(f"{k} rel {rel_err(v, want):.2e}"
                               for k, v in got.items()) + f" (tol {tol})")
    # rank 4 in bf16: 8-byte rows, off the 16-byte pitch, so both kernels
    # take the staged route on either side of the adapter
    for pi, po in ((cfg.d_model, 4), (4, cfg.d_model)):
        h = torch.randn(B, S, pi, generator=gen, device="cuda").to(
            torch.bfloat16)
        z = torch.randn(B, S, po, generator=gen, device="cuda").to(
            torch.bfloat16)
        gn.route_launches.clear()
        dn.route_launches.clear()
        want = gram_norm_ref(h, z)
        got = {"gram_norm": ops.gram_norm(h, z),
               "direct_norm": ops.direct_norm(h, z)}
        routes = {**gn.route_launches, **dn.route_launches}
        if routes != {("gram", "synchronous"): 1,
                      ("direct", "synchronous"): 1}:
            raise AssertionError(f"norm routes {routes} at rank 4 "
                                 f"{(B, S, pi, po)}, expected the staged "
                                 f"route")
        line = []
        for k, v in got.items():
            r = rel_err(v, want)
            line.append(f"{k} rel {r:.2e}")
            if not r <= tol:
                raise AssertionError(f"{k} at rank 4 {(B, S, pi, po)}: rel "
                                     f"err {r} > {tol}")
            if not torch.equal(v, getattr(ops, k)(h, z)):
                raise AssertionError(f"{k} not bitwise repeatable at rank 4 "
                                     f"{(B, S, pi, po)}")
        log(f"[kernels] bf16 {(B, S, pi, po)} rank 4, staged route: "
            + ", ".join(line) + f" (tol {tol}); bitwise equal on a second "
            f"run")
    return checked


def flash_inputs(b, hq, hkv, s, d, dt, gen, layout=None):
    """q (B, Hq, S, D), k, v (B, Hkv, S, D) and dO as (B, H, S, D) views:
    of (B, S, H, D) tensors as the model passes them, or laid out as
    ``layout`` says (``FLASH_CASES``)."""
    import torch

    def draw(h, width=d):
        return torch.randn(b, s, h, width, generator=gen,
                           device="cuda").to(dt)
    if layout == "fused":
        qkv = draw(hq + 2 * hkv)
        q, k, v = qkv.split((hq, hkv, hkv), dim=2)
        do = draw(hq)
    elif layout == "odd":
        q, k, v, do = (draw(h, d + 1)[..., :d] for h in (hq, hkv, hkv, hq))
    else:
        q, k, v, do = (draw(h) for h in (hq, hkv, hkv, hq))
    return tuple(x.transpose(1, 2) for x in (q, k, v, do))


def phase_flash_kernels(errs):
    """The flash kernels against their plain versions: O and lse, then dQ,
    dK and dV on the plain forward's O and lse; the backward twice, for
    bitwise-equal results."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops

    gen = torch.Generator(device="cuda").manual_seed(3)
    for dt in (torch.float32, torch.bfloat16):
        tol = FLASH_TOL[str(dt)]
        for case in FLASH_CASES:
            b, hq, hkv, s, d, cap, win, layout = case
            q, k, v, do = flash_inputs(b, hq, hkv, s, d, dt, gen, layout)
            kw = dict(scale=d ** -0.5, softcap=cap, window=win)
            fa.route_launches.clear()
            o, lse = ops.flash_attention(q, k, v, return_lse=True, **kw)
            o_ref, lse_ref = fa.flash_attention_fwd_ref(q, k, v, **kw)
            grads = ops.flash_attention_bwd(q, k, v, o_ref, lse_ref, do, **kw)
            # the route the bf16 launches were given: the model's views and
            # the fused projection by TMA, rows of an odd pitch staged
            route = "synchronous" if layout == "odd" else "tma"
            want_routes = ({("fwd", route): 1, ("dq", route): 1,
                            ("dkv", route): 1}
                           if dt == torch.bfloat16 else {})
            if dict(fa.route_launches) != want_routes:
                raise AssertionError(f"flash routes {dict(fa.route_launches)}"
                                     f" at {case} {dt}, expected "
                                     f"{want_routes}")
            again = ops.flash_attention_bwd(q, k, v, o_ref, lse_ref, do, **kw)
            want = fa.flash_attention_bwd_ref(q, k, v, o_ref, lse_ref, do,
                                              **kw)
            torch.cuda.synchronize()
            line = []
            for name, got, ref, lim in (
                    [("O", o, o_ref, tol), ("lse", lse, lse_ref, LSE_TOL)]
                    + [(n, g, w, tol) for n, g, w in
                       zip(("dQ", "dK", "dV"), grads, want)]):
                err = (got.float() - ref.float()).abs().max().item()
                r = err / ref.float().abs().max().item()
                line.append(f"{name} {r:.2e}")
                if not r <= lim:
                    raise AssertionError(
                        f"flash {name} disagrees with its plain version at "
                        f"{case} {dt}: {r} of max |value| > {lim}")
                if (dt == torch.bfloat16 and case == FLASH_CASES[0]
                        and name != "lse"):
                    key = {"O": "flash_attention",
                           "dQ": "flash_attention_bwd_dq"}.get(
                               name, "flash_attention_bwd_dkv")
                    errs[key] = max(errs.get(key, 0.0), err)
            for name, a, b in zip(("dQ", "dK", "dV"), grads, again):
                if not torch.equal(a, b):
                    raise AssertionError(f"flash {name} not bitwise "
                                         f"reproducible at {case} {dt}")
            how = f", {route} route" if dt == torch.bfloat16 else ""
            log(f"[kernels] flash {str(dt)[6:]} (B,Hq,Hkv,S,D,cap,win,"
                f"layout)={case}{how}: err/max " + ", ".join(line)
                + f" (tol {tol}, lse {LSE_TOL}); dQ, dK and dV bitwise "
                f"equal on a second run")
            del q, k, v, do, o, lse, o_ref, lse_ref, grads, again, want


class NormShapes:
    """Records ``norm_key`` of every gram and direct launch while active
    (``with NormShapes() as shapes:``), through the launchers that
    ``kernels.ops`` calls."""

    def __enter__(self):
        from repro_torch.kernels import direct_norm as dn
        from repro_torch.kernels import gram_norm as gn
        self.shapes = set()
        self.orig = [(gn, "gram_norm", gn.gram_norm),
                     (dn, "direct_norm", dn.direct_norm)]
        for mod, name, fn in self.orig:
            def rec(*a, _fn=fn, **kw):
                self.shapes.add(norm_key(*a))
                return _fn(*a, **kw)
            setattr(mod, name, rec)
        return self.shapes

    def __exit__(self, *exc):
        for mod, name, fn in self.orig:
            setattr(mod, name, fn)


def phase_exact(spec, registry, pex, cfg=None, tag="exact",
                flash_launches=None, flashes=(False, True), prepare=None,
                shapes=None):
    """Full width in f32: Engine norms vs per-example plain backward, for
    llama3.2-1b (phase 4; ``cfg`` None) or another config (gemma2-9b at
    its cut depth, phase 18; the LoRA-fied llama3.2-1b, phase 23; rwkv6-3b,
    zamba2-7b and seamless-m4t-medium, phases 27, 29 and 31), unfused
    and (in ``flashes``) with ``AttnCfg.flash``. The norms are held over
    the arch's pex scope (``registry.scope_mask``: zamba2's shared block
    and its SSM's conv and decay tensors, rwkv6's μ's, w0 and u are
    trained but give no stat); the summed gradient over every leaf. ``flash_launches`` is the
    launches of each flash kernel the flash run must make (default: one
    per layer). Where it is 0 (gemma2: its softcap and local layers close
    the reference's gate) the flash run repeats the unfused one, so only
    its launch counts are kept. ``prepare`` edits the parameters after
    ``init``. A leaf the plain loss does not reach (a LoRA site's frozen
    base) must have an engine gradient of exactly zero. ``shapes`` (a set)
    collects the ``norm_key`` of every gram and direct launch. Returns the
    launches of the unfused run."""
    import torch
    from repro_torch.configs.common import ShapeSpec
    from repro_torch.nn.param import tree_flatten, tree_unflatten

    from repro_torch.kernels import ops

    cfg = cfg or spec.full(dtype="float32")
    if flash_launches is None:
        flash_launches = cfg.n_layers
    mod = registry.family_module(spec)
    params = mod.init(cfg, torch.Generator(device="cuda").manual_seed(0))
    if prepare is not None:
        params = prepare(params)
    batch = registry.make_train_batch(
        spec, cfg, ShapeSpec(tag, "train", EXACT_S, EXACT_B), rng_seed=0)
    loss_fn = registry.make_loss_fn_v2(spec, cfg)
    results, unfused_launches = {}, None
    for flash in flashes:
        c = with_flash(cfg) if flash else cfg
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        with NormShapes() as seen:
            res = pex.Engine(pex.PexSpec()).step(
                registry.make_loss_fn_v2(spec, c), params, batch,
                [pex.Norms(), pex.Grads()])
            torch.cuda.synchronize()
        if shapes is not None:
            shapes |= seen
        n = ops.launch_counts()
        log(f"[{tag}] {cfg.name}, {cfg.n_layers} layers: Engine.step([Norms, "
            f"Grads]) f32 B={EXACT_B} S={EXACT_S} flash={flash}: "
            f"{(time.perf_counter() - t0) * 1e3:.1f} ms (first call); "
            f"launches {n}")
        if not flash:
            unfused_launches = n
        want = flash_launches if flash else 0
        if any(n[k] != want for k in FLASH_KERNELS):
            raise AssertionError(f"{tag} flash={flash}: flash launches {n}, "
                                 f"expected {want} of each")
        if flash and not want:
            log(f"[{tag}] flash=True took the unfused route, as the gate "
                f"says; its result is not kept")
        else:
            results[flash] = res
        del res

    leaves, treedef = tree_flatten(params)
    leaves = [x.detach().requires_grad_() for x in leaves]
    p = tree_unflatten(treedef, leaves)
    scope = registry.scope_mask(spec.arch_id, params)
    oracle = []
    for j in range(EXACT_B):
        ex = {k: v[j:j + 1] for k, v in batch.items()}
        gs = torch.autograd.grad(loss_fn(p, ex, pex.NULL)[0][0], leaves,
                                 allow_unused=True)
        oracle.append(sum(torch.sum(torch.square(g.float()))
                          for g, m in zip(gs, scope)
                          if g is not None and m))
        del gs
    oracle = torch.stack(oracle)
    log(f"[{tag}] per-example sq norms over {sum(scope)} of {len(scope)} "
        f"leaves (the pex scope): plain  {oracle.tolist()}")
    gs = torch.autograd.grad(loss_fn(p, batch, pex.NULL)[0].sum(), leaves,
                             allow_unused=True)
    for flash, res in results.items():
        norms = res.sq_norms.sum(-1)
        r = rel_err(norms, oracle)
        log(f"[{tag}] flash={flash} per-example sq norms: engine "
            f"{norms.tolist()}")
        log(f"[{tag}] flash={flash} norms max rel err {r:.2e} (tol 1e-3: "
            f"f32, summation order of the kernels vs cuBLAS)")
        if not r < 1e-3:
            raise AssertionError(f"{tag}: full-width norms disagree (flash="
                                 f"{flash}): {r}")
        worst, frozen = 0.0, 0
        for g_eng, g in zip(tree_flatten(res.grads)[0], gs):
            if g is None:   # no path to the loss: a frozen base
                if int(torch.count_nonzero(g_eng)):
                    raise AssertionError(f"{tag}: a frozen leaf of shape "
                                         f"{tuple(g_eng.shape)} has a "
                                         f"non-zero engine gradient")
                frozen += 1
                continue
            worst = max(worst, ((g_eng - g).norm() / g.norm()).item())
        log(f"[{tag}] flash={flash} summed grads vs plain batch backward: "
            f"max rel (Frobenius) err over {len(gs) - frozen} leaves "
            f"{worst:.2e} (tol 1e-4: f32); {frozen} frozen leaves exactly "
            f"zero")
        if not worst < 1e-4:
            raise AssertionError(f"{tag}: summed gradients disagree (flash="
                                 f"{flash}): {worst}")
    return unfused_launches


def phase_main(spec, registry, pex, cfg, shape, tag, want, kernels, *,
               token=False, steps=STEPS, cores=None):
    """A DP-SGD path: ``steps`` steps of ``cfg`` at ``shape`` = (B, S): the
    main path (phase 5), the flash path (phase 6), the MoE path (phase 8),
    the gemma2, qwen2-vl and deepseek paths (phases 19, 20 and 22) or,
    with ``token``, a token-clipping path (phases 11 and 12:
    ``Engine(granularity="token")``, ``[Clip(0.5, granularity="token"),
    Grads()]``). ``want`` holds the launches each pass must make
    (forward, norms backward, reweighted backward); ``kernels`` are the
    counted kernels the path must launch. A LoRA-fied ``cfg`` (phase 24)
    updates its adapters alone with AdamW (the bases stay frozen).
    ``cores`` ({label: (module, function)}) are the spans timed by CUDA
    events forward and backward (``AttentionEvents``): by default the
    attention core (``_attend``, MLA's, or the flash route's
    ``flash_attention_vjp``); rwkv6's WKV and zamba2's SSD recurrence on
    their paths. Returns a dict of what the run read, each kernel's
    launcher host µs a step among it (``attn_ms``: the first core's)."""
    import torch
    from repro_torch.configs.common import ShapeSpec
    from repro_torch.core import plan as plan_mod
    from repro_torch.kernels import direct_norm as dn
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import gram_norm as gn
    from repro_torch.kernels import ops
    from repro_torch.kernels import rowsumsq as rs
    from repro_torch.kernels import segmented_norm as sn
    from repro_torch.nn import attention as attn_mod
    from repro_torch.nn import lora as lora_mod
    from repro_torch.nn import mla as mla_mod
    from repro_torch.optim import adamw

    b, s = shape
    flash = getattr(cfg, "attn", None) is not None and cfg.attn.flash
    mod = registry.family_module(spec)
    params = mod.init(cfg, torch.Generator(device="cuda").manual_seed(0))
    loss_fn = registry.make_loss_fn_v2(spec, cfg)
    opt_cfg = adamw.AdamWConfig()
    # what AdamW trains: the adapters alone on a LoRA path (in place, so
    # params sees the update)
    trained = (lora_mod.adapter_tree if getattr(cfg, "lora", None)
               is not None else lambda tree: tree)
    opt = adamw.init(trained(params))
    noise_gen = torch.Generator(device="cuda").manual_seed(1)
    eng = pex.Engine(pex.PexSpec(),
                     granularity="token" if token else "example")
    consumers = ([pex.Clip(0.5, granularity="token"), pex.Grads()] if token
                 else [pex.Norms(), pex.Clip(1.0), pex.Noise(0.1, noise_gen),
                       pex.GNS()])
    want_fwd, want_norms, want_grads = want
    log(f"[{tag}] {cfg.name}, {cfg.n_layers} layers, {cfg.dtype}, B={b} "
        f"S={s}, {'token' if token else 'example'} granularity; expected "
        f"launches per step: forward {want_fwd}; norms backward "
        f"{want_norms}; reweighted backward {want_grads}")
    batches = [registry.make_train_batch(
        spec, cfg, ShapeSpec(tag, "train", s, b), rng_seed=i)
        for i in range(steps)]

    # observe the real path: launches in the forward and per backward pass,
    # each kernel's device time from CUDA events around its launch
    # function, and the attention core's from events around it
    passes = []
    events = {k: [] for k in kernels}
    host_us = {k: 0.0 for k in kernels}   # launcher host µs this step
    seg_calls = []        # per step: (seg_ids, n_seg, T, p_in, p_out, dtype)
    row_calls = []        # per step: (rows shape, dtype) of each rowsumsq
    norm_shapes = set()   # (dtype, b, s, p_in, p_out) of each gram/direct
    bf16_norms = dict.fromkeys(NORM_KERNELS, 0)   # bf16 launches
    orig_grad = plan_mod._grad
    kfns = {"gram_norm": (gn, "gram_norm"),
            "direct_norm": (dn, "direct_norm"),
            "segmented_norm": (sn, "segmented_norm"),
            "rowsumsq": (rs, "rowsumsq"),
            "flash_attention": (fa, "flash_attention_fwd"),
            "flash_attention_bwd_dq": (fa, "flash_attention_bwd_dq"),
            "flash_attention_bwd_dkv": (fa, "flash_attention_bwd_dkv")}
    kfns = {k: kfns[k] for k in kernels}
    orig_fns = {k: getattr(m, a) for k, (m, a) in kfns.items()}
    if cores is None:
        cores = {"attention": (
            (ops, "flash_attention_vjp") if flash
            else (mla_mod if getattr(cfg, "mla", None) is not None
                  else attn_mod, "_attend"))}
    orig_cores = {k: getattr(m, n) for k, (m, n) in cores.items()}
    core_events = {k: AttentionEvents(fn) for k, fn in orig_cores.items()}
    attn = next(iter(core_events.values()))

    def counted_grad(out, inputs, seed, **kw):
        before = ops.launch_counts()
        gs = orig_grad(out, inputs, seed, **kw)
        after = ops.launch_counts()
        passes.append((len(inputs), before,
                       {k: after[k] - before[k] for k in after}))
        return gs

    def timed(name):
        fn = orig_fns[name]

        def wrapper(*a, **kw):
            if name == "segmented_norm":
                h, z, seg_ids, n_seg = a
                seg_calls[-1].append((seg_ids, n_seg, h.shape[0], h.shape[1],
                                      z.shape[1], h.dtype))
            if name == "rowsumsq":
                row_calls[-1].append((tuple(a[0].shape), a[0].dtype))
            if name in NORM_KERNELS:
                norm_shapes.add(norm_key(*a))
                if (a[0].dtype == torch.bfloat16
                        and kw.get("triangular", True)):
                    bf16_norms[name] += 1
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            host_us[name] += (time.perf_counter() - t0) * 1e6
            e1.record()
            events[name].append((e0, e1))
            return out
        return wrapper

    plan_mod._grad = counted_grad
    for k, (m, a) in kfns.items():
        setattr(m, a, timed(k))
    for k, (m, n) in cores.items():
        setattr(m, n, core_events[k])
    step_ms, kern_ms, attn_ms, losses, kern_host_us = [], [], [], [], []
    core_ms = {k: [] for k in cores}   # per step: (forward ms, backward ms)
    engine_ms, adamw_ms = [], []   # stream ms in Engine.step, in AdamW
    enqueue_ms = []                # host ms to return from Engine.step
    torch.cuda.reset_peak_memory_stats()
    try:
        ops.reset_launch_counts()
        gn.route_launches.clear()
        dn.route_launches.clear()
        sn.reset_route_counts()
        for i, batch in enumerate(batches):
            passes.clear()
            for ev in core_events.values():
                ev.clear()
            seg_calls.append([])
            row_calls.append([])
            for v in events.values():
                v.clear()
            host_us.update(dict.fromkeys(host_us, 0.0))
            torch.cuda.synchronize()
            at_start = ops.launch_counts()
            marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            t0 = time.perf_counter()
            marks[0].record()
            res = eng.step(loss_fn, params, batch, consumers)
            # the host's time to queue the step (no sync inside it): near
            # the stream's time in it, the card waited on the host
            enqueue_ms.append((time.perf_counter() - t0) * 1e3)
            marks[1].record()
            _, opt = adamw.update(opt_cfg, opt, trained(params),
                                  trained(res.grads))
            marks[2].record()
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            engine_ms.append(marks[0].elapsed_time(marks[1]))
            adamw_ms.append(marks[1].elapsed_time(marks[2]))
            kern_ms.append({k: sum(a.elapsed_time(b) for a, b in v)
                            for k, v in events.items()})
            kern_host_us.append(dict(host_us))
            attn_ms.append(attn.ms())
            for k, ev in core_events.items():
                core_ms[k].append(ev.ms())
            losses.append(res.loss.item())
            cc = res.clip_coef
            if token:
                norms = res.sq_norms
                if tuple(norms.shape) != (b, s):
                    raise AssertionError(f"step {i}: token map of shape "
                                         f"{tuple(norms.shape)}")
                seen = (f"token sq norms mean {norms.mean().item():.4g}, "
                        f"max {norms.max().item():.4g}; clip coef min "
                        f"{cc.min().item():.4g}, "
                        f"{(cc < 1).float().mean().item():.1%} of tokens "
                        f"clipped")
                finite = (("loss", res.loss), ("norms", norms))
            else:
                norms = res.sq_norms.sum(-1)
                seen = (f"sq norms {norms.tolist()}; clip coef "
                        f"{cc.tolist()}; gns {res.gns.item():.4g}")
                finite = (("loss", res.loss), ("norms", norms),
                          ("gns", res.gns))
            log(f"[{tag}] step {i}: {step_ms[-1]:.1f} ms (stream ms in "
                f"Engine.step {engine_ms[-1]:.1f}, queued by the host in "
                f"{enqueue_ms[-1]:.1f}; in the AdamW update "
                f"{adamw_ms[-1]:.1f}); loss "
                f"{losses[-1]:.4f}; {seen}; kernel ms "
                f"{ {k: round(v, 3) for k, v in kern_ms[-1].items()} }; "
                + "; ".join(f"{k} core fwd/bwd ms {v[-1][0]:.3f}/"
                            f"{v[-1][1]:.3f}" for k, v in core_ms.items())
                + f"; launches per backward {[p[2] for p in passes]}")
            for name, t in finite:
                if not bool(torch.isfinite(t).all()):
                    raise AssertionError(f"step {i}: {name} not finite")
            if not bool(((cc > 0) & (cc <= 1)).all()):
                raise AssertionError(f"step {i}: clip coef outside (0, 1]")
            if len(passes) != 2:
                raise AssertionError(f"step {i}: {len(passes)} backward "
                                     f"passes, expected norms + reweighted")
            (n_in0, before0, norms_pass), (_, _, grads_pass) = passes
            fwd_pass = {k: before0[k] - at_start[k] for k in before0}
            if fwd_pass != want_fwd:
                raise AssertionError(f"step {i}: the tapped forward "
                                     f"launched {fwd_pass}, expected "
                                     f"{want_fwd}")
            if n_in0 != 1 or norms_pass != want_norms:
                raise AssertionError(f"step {i}: norms pass launched "
                                     f"{norms_pass}, expected {want_norms}")
            if grads_pass != want_grads:
                raise AssertionError(f"step {i}: the reweighted backward "
                                     f"launched {grads_pass}, expected "
                                     f"{want_grads}")
            del res
        launches = ops.launch_counts()
    finally:
        plan_mod._grad = orig_grad
        for k, (m, a) in kfns.items():
            setattr(m, a, orig_fns[k])
        for k, (m, n) in cores.items():
            setattr(m, n, orig_cores[k])
    per_step = {k: want_fwd[k] + want_norms[k] + want_grads[k]
                for k in launches}
    for k, n in launches.items():
        if n != steps * per_step[k] or (k in kernels and n == 0):
            raise AssertionError(f"{k}: {n} launches on the {tag} path, "
                                 f"expected {steps * per_step[k]}")
    # every bf16 gram and direct launch of the dense paths and of deepseek's
    # (whose f32 router launches take no copy route) on the TMA route
    routes = {**gn.route_launches, **dn.route_launches}
    if tag in ("main", "flash", "gemma2", "qwen2-vl", "deepseek", "lora",
               "rwkv6", "zamba2", "seamless"):
        want_routes = {(k, "tma"): bf16_norms[f"{k}_norm"]
                       for k in ("gram", "direct") if bf16_norms[f"{k}_norm"]}
        if routes != want_routes:
            raise AssertionError(f"{tag}: norm routes {routes}, expected "
                                 f"{want_routes}")
    if "segmented_norm" in kernels:
        # every non-empty segment of the MoE path on the gram route
        segs = sn.route_segments()
        kept = sum(int((sn.segment_sizes(seg, n) > 0).sum())
                   for calls in seg_calls for seg, n, *_ in calls)
        if segs != {"gram": kept, "direct": 0}:
            raise AssertionError(f"{tag}: segments by route {segs}, expected "
                                 f"all {kept} non-empty ones on gram")
        log(f"[{tag}] segmented routes: segments {segs} (every non-empty "
            f"segment on gram); launches by route and copy "
            f"{dict(sn.route_launches)}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[{tag}] launches over {steps} steps: {launches}; every pass "
        f"launched what it should; gram/direct copy routes {routes}")
    log(f"[{tag}] peak memory {peak:.2f} GiB (since the phase began)")
    return {"launches": launches, "kern_ms": kern_ms, "step_ms": step_ms,
            "attn_ms": attn_ms, "core_ms": core_ms, "losses": losses,
            "peak_gib": peak,
            "seg_calls": seg_calls, "row_calls": row_calls,
            "norm_shapes": norm_shapes, "engine_ms": engine_ms,
            "adamw_ms": adamw_ms, "host_us": kern_host_us,
            "enqueue_ms": enqueue_ms}


def phase_moe_exact(spec, registry, pex, layers=MOE_LAYERS,
                    shape=(MOE_EXACT_B, MOE_EXACT_S), tag="moe-exact",
                    grads=True):
    """A MoE config at full width in f32, cut to ``layers``, at ``shape`` =
    (B, S): Engine norms against per-example gradients of the batched loss
    (phi3.5-moe, phase 7; deepseek-v2-236b, phase 21). Capacity dispatch
    couples the examples of a group (which tokens get a slot), so the
    oracle is example j's gradient of ONE batched forward with every other
    example present, not a forward of example j alone; each gradient is
    reduced to its squared norm as soon as it is formed, so one f32
    gradient tree lives at a time. With ``grads`` the step also takes
    ``Grads()``, and its summed gradient is held against the batch
    backward (deepseek's takes ``[Norms()]`` alone: its f32 parameters,
    a tree of grads and the oracle's would not fit the card together)."""
    import torch
    from repro_torch.configs.common import ShapeSpec
    from repro_torch.kernels import ops
    from repro_torch.kernels import segmented_norm as sn
    from repro_torch.nn.param import tree_flatten, tree_unflatten

    b, s = shape
    cfg = cut(spec, layers, dtype="float32")
    params = registry.family_module(spec).init(
        cfg, torch.Generator(device="cuda").manual_seed(0))
    batch = registry.make_train_batch(
        spec, cfg, ShapeSpec(tag, "train", s, b), rng_seed=0)
    loss_fn = registry.make_loss_fn_v2(spec, cfg)
    kept = []             # (valid slots, n_seg) of each segmented launch
    launch = sn.segmented_norm

    def recorded(h, z, seg_ids, n_seg):
        kept.append((int(((seg_ids >= 0) & (seg_ids < n_seg)).sum()), n_seg))
        return launch(h, z, seg_ids, n_seg)

    consumers = [pex.Norms(), pex.Grads()] if grads else [pex.Norms()]
    sn.segmented_norm = recorded
    torch.cuda.reset_peak_memory_stats()
    try:
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        res = pex.Engine(pex.PexSpec()).step(loss_fn, params, batch,
                                             consumers)
        torch.cuda.synchronize()
        n = ops.launch_counts()
    finally:
        sn.segmented_norm = launch
    assignments = b * s * cfg.moe.top_k
    log(f"[{tag}] {cfg.name}: Engine.step("
        f"{[type(c).__name__ for c in consumers]}) f32 {cfg.n_layers} "
        f"layers B={b} S={s}: {(time.perf_counter() - t0) * 1e3:.1f} ms "
        f"(first call); launches {n}; slots kept per segmented launch "
        f"{[k for k, _ in kept]} of {assignments} token-expert assignments "
        f"({assignments - min(k for k, _ in kept)} dropped at most), "
        f"{kept[0][1]} composite segments")
    if n["segmented_norm"] != 3 * moe_layers(cfg):
        raise AssertionError(f"{tag}: {n['segmented_norm']} segmented "
                             f"launches, expected {3 * moe_layers(cfg)}")

    leaves, treedef = tree_flatten(params)
    leaves = [x.detach().requires_grad_() for x in leaves]
    p = tree_unflatten(treedef, leaves)
    lv = loss_fn(p, batch, pex.NULL)[0]
    oracle = []
    for j in range(b):
        gs = torch.autograd.grad(lv[j], leaves, retain_graph=grads
                                 or j < b - 1)
        oracle.append(sum(torch.sum(torch.square(g)) for g in gs))
        del gs
    oracle = torch.stack(oracle)
    norms = res.sq_norms.sum(-1)
    r = rel_err(norms, oracle)
    log(f"[{tag}] per-example sq norms: oracle {oracle.tolist()}")
    log(f"[{tag}] per-example sq norms: engine {norms.tolist()}")
    log(f"[{tag}] norms max rel err {r:.2e} (tol 1e-3: f32, summation "
        f"order of the kernels vs cuBLAS)")
    if not r < 1e-3:
        raise AssertionError(f"{cfg.name} norms disagree with the batched-"
                             f"graph oracle: {r}")
    if grads:
        gs = torch.autograd.grad(lv.sum(), leaves)
        worst = 0.0
        for g_eng, g in zip(tree_flatten(res.grads)[0], gs):
            worst = max(worst, ((g_eng - g).norm() / g.norm()).item())
        log(f"[{tag}] summed grads vs plain batch backward: max rel "
            f"(Frobenius) err over {len(gs)} leaves {worst:.2e} (tol 1e-4: "
            f"f32)")
        if not worst < 1e-4:
            raise AssertionError(f"{cfg.name} summed gradients disagree: "
                                 f"{worst}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[{tag}] peak memory {peak:.2f} GiB (since the phase began)")
    return {"rel_err": r, "peak_gib": peak}


def seg_inputs(t, p_in, p_out, dt, gen, seg, n_seg):
    """Random (h, z̄) whose rows share a component within each segment
    (x = a + b_seg), so that the Grams' entries off the diagonal are of
    the order of those on it and every tile pair weighs in the norm."""
    import torch
    from repro_torch.kernels import segmented_norm as sn
    key = sn.drop_bucket(seg, n_seg)
    return tuple((torch.randn(t, p, generator=gen, device="cuda")
                  + torch.randn(n_seg + 1, p, generator=gen,
                                device="cuda")[key]).to(dt)
                 for p in (p_in, p_out))


#: where phase 8 leaves the segment ids of its first step, for
#: :func:`seg_times` (in the checkout's build directory)
SEG_IDS = os.path.join(ROOT, "build", "moe_seg_ids.pt")


def seg_path(seg_calls, save=True):
    """[(T, p_in, p_out, seg_ids, n_seg)] of a MoE path's two shapes, with
    the ids of the first launch at each in its first step; with ``save``
    (the phi3.5-moe path's) saved to :data:`SEG_IDS`."""
    import torch
    first = {(pi, po): (seg, n_seg) for seg, n_seg, _, pi, po, _
             in reversed(seg_calls[0])}
    path = [(seg.shape[0], pi, po, seg, n_seg)
            for (pi, po), (seg, n_seg) in sorted(first.items())]
    if save:
        os.makedirs(os.path.dirname(SEG_IDS), exist_ok=True)
        torch.save([(t, pi, po, seg.cpu(), n) for t, pi, po, seg, n in path],
                   SEG_IDS)
    return path


def load_seg_path():
    """The MoE path's segment ids as :func:`seg_path` saved them, on the
    card."""
    import torch
    if not os.path.exists(SEG_IDS):
        raise FileNotFoundError(f"{SEG_IDS}: run chip_smoke.py first (its "
                                f"phase 8 saves the MoE path's segment ids)")
    return [(t, pi, po, seg.cuda(), n)
            for t, pi, po, seg, n in torch.load(SEG_IDS)]


def phase_seg_kernels(path, errs, edges=True):
    """``segmented_norm`` against its plain version: at a MoE path's
    gate/up and down shapes with the segment ids of its first step
    (``path``, :func:`seg_path`; random inputs), and with ``edges`` at the
    edge cases and the LoRA tenants' example-id segments (every one on the
    direct route); each twice, for bitwise-equal results."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import ops
    from repro_torch.kernels import segmented_norm as sn
    from repro_torch.kernels.segmented_norm import segmented_norm_ref

    gen = torch.Generator(device="cuda").manual_seed(5)

    def ids(t, n, drop):
        seg = torch.randint(0, n, (t,), generator=gen, device="cuda")
        off = torch.rand(t, generator=gen, device="cuda") < drop
        return torch.where(off, n + 3, seg)

    edge = [("ragged T and p_out", 777, 256, 333, ids(777, 20, 0.2), 20),
            ("all rows dropped", 500, 128, 64,
             torch.full((500,), 9, device="cuda"), 4),
            ("empty segments", 600, 200, 136, 2 * ids(600, 15, 0.1), 30),
            ("one segment", 3000, 512, 384,
             torch.zeros(3000, dtype=torch.long, device="cuda"), 1)]
    # mixed lengths: one launch with segments on both sides of 512 → 384's
    # crossover (gram up to 376 rows, direct from 377), an empty one and
    # dropped rows
    mixed = torch.cat([
        torch.repeat_interleave(torch.arange(len(MIXED_SIZES),
                                             device="cuda"),
                                torch.tensor(MIXED_SIZES, device="cuda")),
        torch.full((100,), len(MIXED_SIZES) + 2, device="cuda")])
    mixed = mixed[torch.randperm(mixed.numel(), generator=gen,
                                 device="cuda")]
    edge.append(("mixed lengths", mixed.numel(), 512, 384, mixed,
                 len(MIXED_SIZES)))
    # rows wider than the path's: llama3-70b's down projection (28,672 →
    # 8,192), 24 segments of ~77 rows; the bf16 error must not grow with
    # the width
    edge.append(("wide rows", 2048, *WIDE, ids(2048, 24, 0.1), 24))
    cases = [(f"path {pi}->{po}", t, pi, po, seg, n)
             for t, pi, po, seg, n in path] + (edge if edges else [])
    checks = [(dt, case) for dt in (torch.float32, torch.bfloat16)
              for case in cases]
    if edges:
        # the LoRA tenants' factor taps: example-id segments (S rows each)
        # at phase 26's f32 (256 tenants x 2, S=64) and bf16 (llama3.2-1b's
        # wq width, S=512) shapes, on the direct route
        for dtn, n_ten, per, d, s_len in TENANT_SEG_CASES:
            dt = getattr(torch, dtn)
            n = tenant_owner(n_ten, per, 0).size
            seg = torch.arange(n, device="cuda").repeat_interleave(s_len)
            for pi, po in ((d, TENANT_R), (TENANT_R, d)):
                checks.append((dt, (f"tenants {pi}->{po}", n * s_len, pi,
                                    po, seg, n)))
    for dt, (name, t, pi, po, seg, n) in checks:
        tol = TOL[str(dt)]
        h, z = seg_inputs(t, pi, po, dt, gen, seg, n)
        copy = "fma" if dt == torch.float32 else (
            "cp.async" if _build.aligned_rows(h, z) else "synchronous")
        sn.reset_route_counts()
        got = ops.segmented_norm(h, z, seg, n)
        again = ops.segmented_norm(h, z, seg, n)
        want = segmented_norm_ref(h, z, seg, n)
        torch.cuda.synchronize()
        full = want > 0
        r = rel_err(got[full], want[full]) if bool(full.any()) else 0.0
        if not (r <= tol and bool((got[~full] == 0).all())):
            raise AssertionError(
                f"segmented_norm disagrees with its plain version at "
                f"{name} (T={t}, {pi}->{po}, {n} segments) {dt}: rel err "
                f"{r} > {tol}, or an empty segment is not 0")
        if not torch.equal(got, again):
            raise AssertionError(f"segmented_norm not bitwise "
                                 f"reproducible at {name} {dt}")
        # each launch's segments by route, and its kernels by route
        sizes = sn.segment_sizes(seg, n).cpu().numpy()
        gram = sn.takes_gram(sizes, pi, po)
        want_segs = {"gram": 2 * int(gram.sum()),
                     "direct": 2 * int(((sizes > 0) & ~gram).sum())}
        lim = sn.limits(t, n, pi, po)
        want_launch = {(k, copy): 2 for k, on in
                       (("gram", lim.gram), ("direct", lim.directs)) if on}
        segs = sn.route_segments()
        if segs != want_segs or dict(sn.route_launches) != want_launch:
            raise AssertionError(
                f"segmented routes at {name} {dt}: segments {segs}, "
                f"launches {dict(sn.route_launches)}; expected "
                f"{want_segs}, {want_launch}")
        if name.startswith("tenants") and want_segs["gram"]:
            raise AssertionError(f"{name} {dt}: a tenant segment takes the "
                                 f"gram route")
        if dt == torch.bfloat16 and name.startswith("path"):
            errs["segmented_norm"] = max(
                errs.get("segmented_norm", 0.0),
                (got - want).abs().max().item())
        log(f"[segmented] {str(dt)[6:]} {name}: T={t} {pi}->{po}, {n} "
            f"segments ({int(full.sum())} non-empty, "
            f"{int(((seg >= 0) & (seg < n)).sum())} rows kept): rel "
            f"{r:.2e} (tol {tol}); empty segments 0; bitwise equal on a "
            f"second run; segments by route over both runs {segs}, "
            f"kernel launches {dict(sn.route_launches)}")
        del h, z, got, again, want
        torch.cuda.empty_cache()


def seg_bound_ms(calls):
    """The least time the card could take for the segmented launches of one
    step: per launch, the larger of the bytes the function must move (the
    kept rows of h and z̄, the ids, the output) over the HBM rate and the
    fewest operations it needs on this data (per segment, the gram or the
    direct form, ``ops.segmented_flop_estimate``) over the peak for its
    type. Also returns the kernels' own operations (by the route each
    segment takes, ``segmented_norm.flop_estimate``) over the fewest,
    summed over the launches."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import segmented_norm as sn
    total, by, done, least = 0.0, {}, 0.0, 0.0
    for seg, n_seg, t, pi, po, dt in calls:
        item = 2 if str(dt) == "torch.bfloat16" else 4
        t_bytes = sn.bytes_estimate(seg, n_seg, pi, po, item) \
            / PEAK_BYTES_PER_S * 1e3
        flops = ops.segmented_flop_estimate(seg, n_seg, pi, po)
        t_ops = flops / PEAK_FLOPS[str(dt)] * 1e3
        total += max(t_bytes, t_ops)
        key = "bytes" if t_bytes >= t_ops else "operations"
        by[key] = by.get(key, 0.0) + max(t_bytes, t_ops)
        done += sn.flop_estimate(seg, n_seg, pi, po)
        least += flops
    return total, max(by, key=by.get), done / least


#: (p_in, p_out) of the MoE path's segmented launches: gate and up, down
SEG_SHAPES = [(4096, 6400), (6400, 4096)]
#: (p_in, p_out) of phase 9's wide case
WIDE = (28672, 8192)


def seg_sets(t, pi, po, gen):
    """bf16 (h, z̄) input copies of (T, pi), (T, po), together past twice
    the L2 cache (one copy where one already is)."""
    import torch
    sets = []
    while sum((h.numel() + z.numel()) * 2 for h, z in sets) < 2 * L2_BYTES:
        sets.append(tuple(
            torch.randn(t, p, generator=gen, device="cuda").to(
                torch.bfloat16) for p in (pi, po)))
    return sets


def seg_times(path=None, reps=10, tag="seg-times"):
    """Device time of one bf16 segmented launch (ms) at the MoE path's
    gate/up (4096→6400) and down (6400→4096) shapes, with ``device_ms``
    (card held busy, input copies past the L2), on the path's own segment
    ids: ``path`` as :func:`seg_path` gives it, by default the ids phase 8
    of a whole run left in :data:`SEG_IDS`. A call takes ~0.4 ms of host
    time (``seg_host_us``), so ``reps`` stays small enough for the host to
    queue them all inside ``device_ms``'s busy window. Returns
    ``{"segmented_norm 4096x6400": ms, ...}``. It uses only the wrapper's
    public signature, so a copy of this file placed in an older checkout,
    with the ids file copied to that checkout's ``build/``, times that
    checkout's kernel on the same ids: ``python3 -c "import chip_smoke;
    chip_smoke.seg_times()"``."""
    import torch
    from repro_torch.kernels import ops

    gen = torch.Generator(device="cuda").manual_seed(8)
    out = {}
    for t, pi, po, seg, n in path or load_seg_path():
        sets = seg_sets(t, pi, po, gen)
        out[f"segmented_norm {pi}x{po}"] = device_ms(
            lambda x: ops.segmented_norm(x[0], x[1], seg, n), sets, reps)
        del sets
        torch.cuda.empty_cache()
        kept = int(((seg >= 0) & (seg < n)).sum())
    log(f"[{tag}] the MoE path's ids: T={t}, {n} segments, {kept} rows "
        f"kept, bf16, device ms per call: {json.dumps(out)}")
    return out


def seg_host_us(ids, reps=20):
    """Host time of one call (µs) of the bf16 segmented launcher at the
    gate/up shape on the segment ids ``ids`` = (seg_ids, n_seg), with the
    card held busy so that no call waits for it (``time.perf_counter``
    around ``reps`` calls after a warm-up; few enough that their ~35
    launches each do not fill the stream's launch queue), and the parts of
    it spent in ``csr`` (the sort and offsets), ``plan``
    (``segmented_norm.plan``) and ``ctypes_launch`` (the C call with its
    launches), timed inside the same number of launcher calls; ``python``
    is the rest of those timed calls (checks, scratch, route counts).
    Fails if the calls took half the ~0.2 s the card was held busy: a
    launcher that waited for the card (a host sync on the launch path)
    would take all of it."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import segmented_norm as sn

    seg, n = ids
    pi, po = SEG_SHAPES[0]
    gen = torch.Generator(device="cuda").manual_seed(7)
    h, z = seg_sets(seg.numel(), pi, po, gen)[0]
    lib = _build.load()
    spent = {"csr": 0.0, "plan": 0.0, "ctypes_launch": 0.0}

    def timed(key, fn):
        def wrapper(*a):
            t0 = time.perf_counter()
            out = fn(*a)
            spent[key] += time.perf_counter() - t0
            return out
        return wrapper

    class Spy:          # the C launch, timed
        def __getattr__(self, attr):
            fn = getattr(lib, attr)
            return (timed("ctypes_launch", fn)
                    if attr == "segmented_norm_launch" else fn)

    def host_us():
        sn.segmented_norm(h, z, seg, n)
        torch.cuda.synchronize()
        spent.update(dict.fromkeys(spent, 0.0))
        torch.cuda._sleep(400_000_000)    # ~0.2 s at the H100's clocks
        t0 = time.perf_counter()
        for _ in range(reps):
            sn.segmented_norm(h, z, seg, n)
        us = (time.perf_counter() - t0) / reps * 1e6
        torch.cuda.synchronize()
        if us * reps > 0.1e6:
            raise AssertionError(f"segmented launcher: {reps} calls took "
                                 f"{us * reps / 1e3:.1f} ms of host time "
                                 f"with the card held busy ~200 ms: it "
                                 f"waits for the card")
        return us

    out = {"total": host_us()}
    real = (sn.csr, sn.plan, _build.load)
    sn.csr, sn.plan = timed("csr", sn.csr), timed("plan", sn.plan)
    _build.load = Spy
    try:
        spied = host_us()
    finally:
        sn.csr, sn.plan, _build.load = real
    out.update({k: v / reps * 1e6 for k, v in spent.items()})
    out["python"] = spied - sum(out[k] for k in spent)
    log(f"[seg-host] host µs per call, card held busy, T={seg.numel()} "
        f"{pi}->{po} bf16: {json.dumps(out)}; no call waited for the card")
    return out


def seg_parts(ids, reps=10):
    """Device time (ms) of the parts of one bf16 segmented call at each of
    the MoE path's shapes on the segment ids ``ids`` = (seg_ids, n_seg),
    with ``device_ms``: ``csr`` (the sort and offsets), ``plan``
    (``segmented_norm.plan`` from those offsets), ``call`` (the whole
    launcher) and ``kernels`` (the call less the other two: the gram and
    direct kernels and the sums, and the scratch)."""
    import torch
    from repro_torch.kernels import segmented_norm as sn

    seg, n = ids
    t = seg.numel()
    _, offsets = sn.csr(seg, n)
    gen = torch.Generator(device="cuda").manual_seed(8)
    out = {}
    for pi, po in SEG_SHAPES:
        sets = seg_sets(t, pi, po, gen)
        part = {"csr": device_ms(lambda x: sn.csr(seg, n), sets, reps),
                "plan": device_ms(lambda x: sn.plan(offsets, t, pi, po),
                                  sets, reps),
                "call": device_ms(lambda x: sn.segmented_norm(x[0], x[1],
                                                              seg, n),
                                  sets, reps)}
        part["kernels"] = part["call"] - part["csr"] - part["plan"]
        out[f"{pi}x{po}"] = part
        del sets
        torch.cuda.empty_cache()
    log(f"[seg-parts] T={t}, {n} segments, bf16, device ms: "
        f"{json.dumps(out)}")
    return out


def seg_bmm_ms(sets, seg, n, reps):
    """cuBLAS ``torch.bmm`` of HHᵀ and Z̄Z̄ᵀ over each segment's rows padded
    to the longest segment (bf16 out), a yardstick of the tensor cores'
    rate on the gram form's products only (the port never calls it). The
    padded copies are made outside the timing."""
    import torch
    from repro_torch.kernels import segmented_norm as sn
    order, offsets = sn.csr(seg, n)
    sizes = (offsets[1:] - offsets[:-1]).long()
    longest = int(sizes.max())
    pos = offsets[:-1, None].long() + torch.arange(longest, device="cuda")
    rows = order.long()[pos.clamp(max=order.numel() - 1)]
    valid = (torch.arange(longest, device="cuda") < sizes[:, None])[..., None]
    padded = [tuple(torch.where(valid, x[rows], torch.zeros((), dtype=x.dtype,
                                                            device="cuda"))
                    for x in xs) for xs in sets]

    def fn(x):
        torch.bmm(x[0], x[0].transpose(1, 2))
        torch.bmm(x[1], x[1].transpose(1, 2))
    ms = device_ms(fn, padded, reps)
    return ms, longest


def seg_table(path, errs, run):
    """The segmented kernel's row: device time a launch at the path's two
    shapes with the path's ids (``device_ms``) times launches per step, the
    CUDA events around its launches on the path per steady step in
    brackets, the plain version's time and the bound from this run's
    launches, a cuBLAS ``bmm`` yardstick of the gram form's products
    (:func:`seg_bmm_ms`), the bf16 gram body's registers, local memory,
    shared memory and blocks per SM, the kernels' own operations over the
    fewest, and the launcher's host µs (:func:`seg_host_us`)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import segmented_norm as sn
    from repro_torch.kernels.segmented_norm import segmented_norm_ref

    gen = torch.Generator(device="cuda").manual_seed(6)
    dt = torch.bfloat16
    per_step = {}        # (p_in, p_out) → launches per step
    for _, _, _, pi, po, _ in run["seg_calls"][0]:
        per_step[(pi, po)] = per_step.get((pi, po), 0) + 1
    info = sn.kernel_info()
    tot = {"ms": 0.0, "ev_ms": 0.0, "plain_ms": 0.0, "bmm_ms": 0.0}
    for t, pi, po, seg, n in path:
        k = per_step[(pi, po)]
        sets = seg_sets(t, pi, po, gen)
        h, z = sets[0]
        ms = device_ms(lambda x: ops.segmented_norm(x[0], x[1], seg, n),
                       sets, 10)
        ev_ms = time_ms(lambda: ops.segmented_norm(h, z, seg, n), 10)
        p_ms = time_ms(lambda: segmented_norm_ref(h, z, seg, n), 1)
        b_ms, by, extra = seg_bound_ms([(seg, n, t, pi, po, dt)])
        lib_ms, longest = seg_bmm_ms(sets, seg, n, 10)
        items = int(sn.plan(sn.csr(seg, n)[1], t, pi, po).n_items)
        grid = min(sn.limits(t, n, pi, po).items,
                   sn.BLOCKS_PER_SM * torch.cuda.get_device_properties(
                       0).multi_processor_count)
        log(f"[table] segmented_norm bf16 T={t} {pi}->{po}, {n} segments "
            f"({items} gram items on a grid of {grid} blocks: "
            f"{items / grid:.2f} waves) x{k}/step: kernel {ms:.4f} ms "
            f"[{ev_ms:.4f}], plain "
            f"{p_ms:.3f} ms, bound {b_ms:.4f} ms ({by}), {b_ms / ms:.1%} of "
            f"bound; the kernels do {extra:.2f}x the fewest operations the "
            f"function needs here; cuBLAS bmm of HHᵀ and Z̄Z̄ᵀ over the "
            f"segments padded to {longest} rows {lib_ms:.4f} ms (yardstick "
            f"only)")
        tot["ms"] += k * ms
        tot["ev_ms"] += k * ev_ms
        tot["plain_ms"] += k * p_ms
        tot["bmm_ms"] += k * lib_ms
        del h, z, sets
        torch.cuda.empty_cache()
    steady = run["seg_calls"][1:] or run["seg_calls"][:1]
    bounds = [seg_bound_ms(c) for c in steady]
    kms = [m["segmented_norm"] for m in run["kern_ms"][1:]] \
        or [run["kern_ms"][0]["segmented_norm"]]
    path_ms = sum(kms) / len(kms)
    bound = sum(b for b, _, _ in bounds) / len(bounds)
    host = seg_host_us(path[0][3:])
    parts = seg_parts(path[0][3:])
    log(f"[table] segmented_norm: per step {tot['ms']:.3f} ms by shape on "
        f"the device [{tot['ev_ms']:.3f}], {path_ms:.3f} ms on the MoE path "
        f"(events); bound {bound:.4f} ms per step from its launches' "
        f"segments and kept rows ({bounds[0][1]}), {bound / tot['ms']:.1%} "
        f"of bound; the kernels do {bounds[0][2]:.2f}x the fewest "
        f"operations; gram body {info['registers']} registers, "
        f"{info['local_bytes']} B local, {info['smem_bytes']} B shared "
        f"memory, {info['threads']} threads, {info['blocks_per_sm']} blocks "
        f"per SM")
    return {"name": "segmented_norm", "route": "cuda",
            "source": SOURCES["segmented_norm"][0],
            "replaces": SOURCES["segmented_norm"][1],
            "launches": run["launches"]["segmented_norm"],
            "max_abs_err": errs["segmented_norm"], "ms": tot["ms"],
            "path_events_ms": path_ms, "plain_ms": tot["plain_ms"],
            "bound_ms": bound, "bound_by": bounds[0][1], "library_ms": None,
            "bmm_ms": tot["bmm_ms"], "own_over_fewest": bounds[0][2],
            "registers": info["registers"],
            "local_bytes": info["local_bytes"],
            "smem_bytes": info["smem_bytes"],
            "blocks_per_sm": info["blocks_per_sm"], "host_us": host,
            "parts_ms": parts,
            "per": f"phi3.5-moe step, {MOE_LAYERS} layers, B={MOE_B} "
                   f"S={MOE_S} bf16"}


def norm_sets(pi, po, gen, b=B, s=S):
    """bf16 (h, z̄) input copies of (b, s, pi), (b, s, po), together past
    twice the L2 cache (one copy where one already is)."""
    import torch
    sets = []
    while sum((h.numel() + z.numel()) * 2 for h, z in sets) < 2 * L2_BYTES:
        sets.append(tuple(
            torch.randn(b, s, p, generator=gen, device="cuda").to(
                torch.bfloat16) for p in (pi, po)))
    return sets


def bmm_ms(name, sets, reps):
    """cuBLAS ``torch.bmm`` of the products the kernel forms, a yardstick of
    the tensor cores' rate at this shape only (the port never calls it):
    HHᵀ and Z̄Z̄ᵀ for gram, HᵀZ̄ for direct, bf16 out."""
    import torch
    if name == "gram_norm":
        def fn(x):
            torch.bmm(x[0], x[0].transpose(1, 2))
            torch.bmm(x[1], x[1].transpose(1, 2))
    else:
        def fn(x):
            torch.bmm(x[0].transpose(1, 2), x[1])
    return device_ms(fn, sets, reps)


def phase_table(expected, errs, launches, kern_ms):
    """Per-shape kernel and plain times and the bound; JSON rows with the
    main path's per-step totals. The kernels' times are ``device_ms`` (card
    held busy, inputs past the L2 cache) with ``time_ms`` (back-to-back
    launches, host in the loop) in brackets; a cuBLAS ``torch.bmm`` of the
    same products is timed beside each as a yardstick."""
    import torch
    from repro_torch.kernels import direct_norm as dn
    from repro_torch.kernels import gram_norm as gn
    from repro_torch.kernels import ops
    from repro_torch.kernels.direct_norm import direct_norm_ref
    from repro_torch.kernels.ref import gram_norm_ref

    gen = torch.Generator(device="cuda").manual_seed(2)
    dt = torch.bfloat16
    kern = {"gram_norm": (ops.gram_norm, gram_norm_ref, gn.kernel_info()),
            "direct_norm": (ops.direct_norm, direct_norm_ref,
                            dn.kernel_info())}
    host = norm_host_us()
    rows = []
    full_ms = 0.0        # the gram kernel's full grid at the gram shapes
    for name, shapes in expected.items():
        run, plain, info = kern[name]
        tot = {"ms": 0.0, "ev_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
               "bmm_ms": 0.0}
        bound_by = {}
        for (pi, po), n in sorted(shapes.items()):
            sets = norm_sets(pi, po, gen)
            h, z = sets[0]
            head = po > 10 * pi
            reps = 3 if head else 20
            ms = device_ms(lambda x: run(*x), sets, 2 * reps)
            ev_ms = time_ms(lambda: run(h, z), reps)
            plain_ms = time_ms(lambda: plain(h, z), max(1, reps // 3))
            lib_ms = bmm_ms(name, sets, reps)
            nbytes = (h.numel() + z.numel()) * h.element_size() + B * 4
            flops = ops.flop_estimate(B, S, pi, po)
            t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
            t_ops = flops / PEAK_FLOPS[str(dt)] * 1e3
            bound = max(t_bytes, t_ops)
            by = "bytes" if t_bytes >= t_ops else "operations"
            bound_by[by] = bound_by.get(by, 0.0) + n * bound
            log(f"[table] {name} bf16 ({B},{S},{pi})x({B},{S},{po}) x{n}/step:"
                f" kernel {ms:.4f} ms [{ev_ms:.4f}], plain {plain_ms:.3f} ms,"
                f" bound {bound:.4f} ms ({by}: {flops:.3g} flops, "
                f"{nbytes:.3g} B), {bound / ms:.1%} of bound; cuBLAS bmm of "
                f"the same products {lib_ms:.4f} ms (yardstick only)")
            other = "gram_norm" if name == "direct_norm" else "direct_norm"
            o_ms = device_ms(lambda x: kern[other][0](*x), sets, 2 * reps)
            log(f"[table] {other} at the same shape (the route the main "
                f"path does not take here): {o_ms:.4f} ms, "
                f"{bound / o_ms:.1%} of bound")
            if head:
                own = dn.flop_estimate(B, S, pi, po)
                log(f"[table] direct_norm's own form at this shape: "
                    f"{own:.3g} flops, {own / PEAK_FLOPS[str(dt)] * 1e3:.4f} "
                    f"ms at the bf16 peak (its floor), against the "
                    f"function's bound {bound:.4f} ms")
            if name == "gram_norm":
                f_ms = device_ms(
                    lambda x: ops.gram_norm(*x, triangular=False), sets,
                    2 * reps)
                full_ms += n * f_ms
                log(f"[table] gram_norm full grid (triangular=False, not on "
                    f"a path) at the same shape: {f_ms:.4f} ms, "
                    f"{bound / f_ms:.1%} of bound")
            tot["ms"] += n * ms
            tot["ev_ms"] += n * ev_ms
            tot["plain_ms"] += n * plain_ms
            tot["bound_ms"] += n * bound
            tot["bmm_ms"] += n * lib_ms
            del h, z, sets
            torch.cuda.empty_cache()
        steady = [k[name] for k in kern_ms[1:]] or [kern_ms[0][name]]
        path_ms = sum(steady) / len(steady)
        log(f"[table] {name}: per step {tot['ms']:.3f} ms by shape on the "
            f"device [{tot['ev_ms']:.3f}], {path_ms:.3f} ms on the main path "
            f"(events); {info['registers']} registers, "
            f"{info['local_bytes']} B local, {info['smem_bytes']} B shared "
            f"memory, {info['threads']} threads, {info['blocks_per_sm']} "
            f"blocks per SM")
        rows.append({
            "name": name, "route": "cuda", "source": SOURCES[name][0],
            "replaces": SOURCES[name][1], "launches": launches[name],
            "max_abs_err": errs[name], "ms": tot["ms"],
            "path_events_ms": path_ms, "plain_ms": tot["plain_ms"],
            "bound_ms": tot["bound_ms"],
            "bound_by": max(bound_by, key=bound_by.get),
            "library_ms": None, "bmm_ms": tot["bmm_ms"],
            "registers": info["registers"],
            "local_bytes": info["local_bytes"],
            "smem_bytes": info["smem_bytes"],
            "blocks_per_sm": info["blocks_per_sm"],
            "host_us": host[name],
            "per": "main-path step, B=8 S=512 bf16"})
        if name == "gram_norm":
            rows.append({**rows[-1], "name": "gram_norm_full",
                         "source": SOURCES["gram_norm_full"][0],
                         "replaces": SOURCES["gram_norm_full"][1],
                         "launches": 0, "max_abs_err": errs["gram_norm_full"],
                         "ms": full_ms, "path_events_ms": None,
                         "per": "main-path step if the gram launches ran the "
                                "full grid (not on a path; by shape)"})
    return rows


#: (p_in, p_out) of every tapped dense layer of a block and of the LM head
#: of llama3.2-1b (wk/wv, wq/wo, w1/w3, w2, head), gemma2-9b (wq, wk/wv,
#: wo, w1/w3, w2, head), qwen2-vl-7b and qwen2-7b (wk/wv, w1/w3, w2, head;
#: their wq/wo are gemma2's), minitron-4b (wk/wv, wq, wo, w1, w2, head),
#: the LoRA adapters, rwkv6-3b (mix_a, mix_b, r/k/v/g/o and the channel
#: mix's r, decay_a, decay_b, the channel mix's k and v, head), zamba2-7b
#: (in_proj, out_proj, head) and seamless-m4t-medium (attention, MLP up and
#: down, head)
NORM_SHAPES = [(2048, 512), (2048, 2048), (2048, 8192), (8192, 2048),
               (2048, 128256),
               (3584, 4096), (3584, 2048), (4096, 3584), (3584, 14336),
               (14336, 3584), (3584, 256000),
               (2048, 8), (8192, 8), (8, 2048), (8, 512), (8, 8192),
               (3584, 512), (3584, 18944), (18944, 3584), (3584, 152064),
               (3072, 1024), (3072, 4096), (4096, 3072), (3072, 9216),
               (9216, 3072), (3072, 256000),
               (2560, 160), (32, 2560), (2560, 2560), (2560, 64), (64, 2560),
               (2560, 8960), (8960, 2560), (2560, 65536),
               (3584, 14576), (7168, 3584), (3584, 32000),
               (1024, 1024), (1024, 4096), (4096, 1024), (1024, 256208)]
#: deepseek-v2-236b's (q_down, q_up, kv_down, kv_up, wo, the prefix MLP's
#: w1/w3 and w2, the shared MLP's, head; its router runs in f32), timed at
#: its path's (DS_B, DS_S)
DS_NORM_SHAPES = [(5120, 1536), (1536, 24576), (5120, 576), (512, 32768),
                  (16384, 5120), (5120, 12288), (12288, 5120), (5120, 3072),
                  (3072, 5120), (5120, 102400)]


def norm_times(reps=20, shapes=None, b=B, s=S):
    """Device time of one call (ms) of the bf16 gram and direct kernels,
    each at every ``shapes`` shape (default ``NORM_SHAPES``) at (b, s)
    (default B=8, S=512), with ``device_ms`` (card held busy, input copies
    past the L2). Returns ``{"gram_norm 2048x2048": ms, ...}``. It uses
    only the wrappers' public signatures, so a copy of this file placed in
    an older checkout times that checkout's kernels: ``python3 -c "import
    chip_smoke; chip_smoke.norm_times()"``."""
    import torch
    from repro_torch.kernels import ops

    gen = torch.Generator(device="cuda").manual_seed(8)
    fns = {"gram_norm": ops.gram_norm, "direct_norm": ops.direct_norm}
    out = {}
    for pi, po in shapes or NORM_SHAPES:
        sets = norm_sets(pi, po, gen, b, s)
        n = max(2, reps // 10) if po > 10 * pi else reps
        for name, fn in fns.items():
            out[f"{name} {pi}x{po}"] = device_ms(lambda x: fn(*x), sets, n)
        del sets
        torch.cuda.empty_cache()
    log(f"[norm-times] B={b} S={s} bf16, device ms per call: "
        f"{json.dumps(out)}")
    return out


#: (arch, layers) of ``update_times``: full depth where None
UPDATE_ARCHS = (("llama3.2-1b", None), ("gemma2-9b", GEMMA_LAYERS),
                ("deepseek-v2-236b", DS_LAYERS))


def update_times():
    """Stream ms and transient GiB (peak allocated less the allocated before
    the call) of one AdamW update (``adamw.update``, two timed after one
    untimed) and of one in-place noise add (``passes.add_grad_noise``) on
    bf16 parameters and random bf16 gradients of each ``UPDATE_ARCHS``
    arch, with f32 moments. ``python3 -c "import chip_smoke;
    chip_smoke.update_times()"`` on the card."""
    import torch
    from repro_torch.core import passes
    from repro_torch.models import registry
    from repro_torch.nn.param import count_params, tree_map
    from repro_torch.optim import adamw

    out = {}

    def timed(fn, reps=1):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        torch.cuda.synchronize()
        return {"ms": e0.elapsed_time(e1) / reps,
                "transient_gib": (torch.cuda.max_memory_allocated() - base)
                / 2**30}

    for arch, layers in UPDATE_ARCHS:
        spec = registry.get(arch)
        cfg = spec.full() if layers is None else cut(spec, layers)
        gen = torch.Generator(device="cuda").manual_seed(0)
        params = registry.family_module(spec).init(cfg, gen)
        grads = tree_map(lambda p: (torch.randn(p.shape, generator=gen,
                                                device="cuda") * 1e-3)
                         .to(p.dtype), params)
        opt_cfg = adamw.AdamWConfig()
        state = adamw.init(params)

        def update():
            adamw.update(opt_cfg, state, params, grads)
        update()                                      # warm-up, not timed
        noise = torch.Generator(device="cuda").manual_seed(1)
        row = {"params": count_params(params),
               "update": timed(update, reps=2),
               "noise_in_place": timed(lambda: passes.add_grad_noise(
                   grads, 0.1, 1.0, noise))}
        out[arch] = row
        log(f"[update-times] {arch} ({row['params'] / 1e9:.3f}B parameters, "
            f"bf16, f32 moments): {json.dumps(row)}")
        del params, grads, state
        torch.cuda.empty_cache()
    return out


#: the dispatch phase's margin: where one kernel's measured time exceeds the
#: other's by more than this, the priced pick must be the faster one
PICK_MARGIN = 0.2


def phase_dispatch(cfgs):
    """At each bf16 launch shape of the paths of ``cfgs``, each (config,
    B, S) (their blocks' dense layers, a dense prefix layer's too, and
    LM heads; not a MoE router, which runs in f32): the priced cost of both
    routes (``core.norms.dense_cost(use_kernels=True)``, ms a launch at the
    path's B and S), both kernels' measured times (``norm_times()`` at
    ``NORM_SHAPES`` for the paths at (B, S), at ``DS_NORM_SHAPES`` for the
    deepseek path's (DS_B, DS_S)) and the pick. The pick must be the
    faster kernel wherever the two times differ by more than
    ``PICK_MARGIN``."""
    from repro_torch.core.norms import dense_cost, pick_method

    paths = {}        # (b, s) → {(p_in, p_out): [path names]}
    for c, b, s in cfgs:
        router = router_shapes(c)
        for block, _ in model_shapes(c):
            for sh in block + [head_shape(c)]:
                if sh not in router:
                    paths.setdefault((b, s), {}).setdefault(sh, []).append(
                        c.name + (" head" if sh == head_shape(c) else ""))
    timed = {(B, S): NORM_SHAPES, (DS_B, DS_S): DS_NORM_SHAPES}
    out = {}
    for (b, s), by_shape in sorted(paths.items()):
        shapes = sorted(by_shape)
        if not set(shapes) <= set(timed.get((b, s), ())):
            raise AssertionError(f"path shapes {shapes} at B={b} S={s} not "
                                 f"all timed by norm_times")
        times = norm_times(shapes=timed[b, s], b=b, s=s)
        for pi, po in shapes:
            price = {k: dense_cost(k, s, pi, po, use_kernels=True) * b * 1e3
                     for k in ("gram", "direct")}
            ms = {k: times[f"{k}_norm {pi}x{po}"] for k in price}
            pick = pick_method(s, pi, po, use_kernels=True)
            faster = min(ms, key=ms.get)
            ratio = max(ms.values()) / min(ms.values())
            out[f"{pi}x{po} B={b} S={s}"] = {
                "priced_ms": price, "measured_ms": ms, "pick": pick}
            names = ", ".join(sorted(set(by_shape[pi, po])))
            log(f"[dispatch] B={b} S={s} {pi}->{po} ({names}): priced gram "
                f"{price['gram']:.4f} ms, direct {price['direct']:.4f} ms a "
                f"launch; measured gram {ms['gram']:.4f} ms, direct "
                f"{ms['direct']:.4f} ms; pick {pick}; faster {faster} by "
                f"{ratio:.2f}x")
            if ratio > 1 + PICK_MARGIN and pick != faster:
                raise AssertionError(f"the priced pick at {pi}->{po} (B={b} "
                                     f"S={s}) is {pick}, but {faster} is "
                                     f"faster by {ratio:.2f}x")
    return out


def plain_loss(spec, registry, pex, cfg):
    """Step 0's loss of a ``phase_main`` path (parameters from seed 0, the
    batch of numpy seed 0 at (B, S)) from a plain forward under ``cfg``."""
    import torch
    from repro_torch.configs.common import ShapeSpec

    params = registry.family_module(spec).init(
        cfg, torch.Generator(device="cuda").manual_seed(0))
    batch = registry.make_train_batch(spec, cfg,
                                      ShapeSpec("plain", "train", S, B),
                                      rng_seed=0)
    return pex.Engine(pex.PexSpec()).step(
        registry.make_loss_fn_v2(spec, cfg), params, batch, []).loss.item()


TRAIN_CLIP_STEPS, TRAIN_IMPORTANCE_STEPS = 4, 2


def phase_train(spec, registry, cfg):
    """The port's ``Trainer`` on llama3.2-1b at full width in bf16 with
    ``SyntheticLM`` batches (B=8, S=512): ``TRAIN_CLIP_STEPS`` steps of
    ``consumers_for_mode("clip", 8, noise_std=0.1)`` under AdamW with a
    warm-up cosine schedule, then ``TRAIN_IMPORTANCE_STEPS`` of
    ``consumers_for_mode("importance", 8)`` (k = 2) on the same
    parameters. Each backward pass's launches are counted: in a clip step
    the norms pass launches gram and direct by the priced pick and the
    reweighted pass none; in an importance step the norm kernels run on the
    8-example pool only and the gradient pass sees 2 examples. Every bf16
    gram and direct launch takes the TMA route."""
    import torch
    from repro_torch.core import plan as plan_mod
    from repro_torch.core.taps import PexSpec
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.kernels import direct_norm as dn
    from repro_torch.kernels import gram_norm as gn
    from repro_torch.kernels import ops
    from repro_torch.optim import adamw
    from repro_torch.optim.schedule import linear_warmup_cosine
    from repro_torch.train.trainer import (TrainConfig, Trainer,
                                           consumers_for_mode)

    steps = TRAIN_CLIP_STEPS + TRAIN_IMPORTANCE_STEPS
    norms_want = {k: sum(v.values())
                  for k, v in main_path_launches(cfg, S).items()
                  if v}
    params = registry.family_module(spec).init(
        cfg, torch.Generator(device="cuda").manual_seed(0))
    loss_fn = registry.make_loss_fn_v2(spec, cfg)
    passes = []     # per backward: (loss rows, launches, norm-launch rows)
    rows = []       # examples of each norm-kernel launch
    norm_shapes = set()     # norm_key of each norm-kernel launch
    orig_grad = plan_mod._grad
    orig = {"gram_norm": gn.gram_norm, "direct_norm": dn.direct_norm}

    def counted_grad(out, inputs, seed, **kw):
        before, first = ops.launch_counts(), len(rows)
        gs = orig_grad(out, inputs, seed, **kw)
        after = ops.launch_counts()
        passes.append((out.shape[0], {k: after[k] - before[k] for k in after
                                      if after[k] != before[k]},
                       set(rows[first:])))
        return gs

    def rows_of(name):
        def wrapper(h, z, *a, **kw):
            rows.append(h.shape[0])
            norm_shapes.add(norm_key(h, z))
            return orig[name](h, z, *a, **kw)
        return wrapper

    log(f"[train] {cfg.name}, {cfg.n_layers} layers, {cfg.dtype}, "
        f"SyntheticLM(vocab={cfg.vocab}, seq={S}, global_batch={B}): "
        f"{TRAIN_CLIP_STEPS} clip+noise steps, then "
        f"{TRAIN_IMPORTANCE_STEPS} importance steps (k={B // 4}); norms "
        f"pass launches by the priced pick {norms_want}")
    plan_mod._grad = counted_grad
    gn.gram_norm, dn.direct_norm = rows_of("gram_norm"), rows_of("direct_norm")
    torch.cuda.reset_peak_memory_stats()
    metrics = []
    try:
        ops.reset_launch_counts()
        gn.route_launches.clear()
        dn.route_launches.clear()
        for mode, n, seed in (("clip", TRAIN_CLIP_STEPS, 0),
                              ("importance", TRAIN_IMPORTANCE_STEPS, 1)):
            passes.clear()
            t = Trainer(loss_fn, params, PexSpec(),
                        adamw.AdamWConfig(
                            schedule=linear_warmup_cosine(2, steps)),
                        TrainConfig(consumers=consumers_for_mode(
                            mode, B, noise_std=0.1), steps=n, log_every=1,
                            seed=seed),
                        DataConfig(vocab=cfg.vocab, seq=S, global_batch=B,
                                   seed=seed))
            ms = t.train()
            params = t.params
            if mode == "clip":
                # phase 37 reproduces these bits through a one-rank mesh
                clip_digest = tree_digest(params)
            del t
            k = B if mode == "clip" else B // 4
            for i, m in enumerate(ms):
                metrics.append(dict(m, mode=mode))
                (n_norms, norms, r_norms), (n_grads, grads, r_grads) = \
                    passes[2 * i:2 * i + 2]
                log(f"[train] {mode} step {i}: {m['time_s'] * 1e3:.1f} ms; "
                    f"norms pass on {n_norms} examples launched {norms}; "
                    f"gradient pass on {n_grads} examples launched "
                    f"{grads or 'nothing'}")
                if not all(math.isfinite(m[key]) for key in
                           ("loss", "norm_mean", "norm_max")):
                    raise AssertionError(f"train {mode} step {i}: {m}")
                if norms != norms_want or r_norms != {B} or n_norms != B \
                        or grads or r_grads or n_grads != k:
                    raise AssertionError(
                        f"train {mode} step {i}: norms pass on {n_norms} "
                        f"examples launched {norms} on {r_norms} (want "
                        f"{norms_want} on {B}); gradient pass on {n_grads} "
                        f"examples launched {grads} (want none on {k})")
            if len(passes) != 2 * n:
                raise AssertionError(f"train {mode}: {len(passes)} backward "
                                     f"passes over {n} steps")
        launches = ops.launch_counts()
    finally:
        plan_mod._grad = orig_grad
        gn.gram_norm, dn.direct_norm = orig["gram_norm"], orig["direct_norm"]
    routes = {**gn.route_launches, **dn.route_launches}
    want_routes = {(k[:-5], "tma"): steps * n for k, n in norms_want.items()}
    if routes != want_routes:
        raise AssertionError(f"train: norm routes {routes}, expected "
                             f"{want_routes}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[train] launches over {steps} steps: "
        f"{ {k: v for k, v in launches.items() if v} }; gram/direct copy "
        f"routes {routes}; peak memory {peak:.2f} GiB (since the phase "
        f"began)")
    return {"metrics": metrics, "launches": launches, "peak_gib": peak,
            "step_ms": [m["time_s"] * 1e3 for m in metrics],
            "norm_shapes": norm_shapes, "clip_digest": clip_digest,
            "norms_want": norms_want}


def tree_digest(tree) -> list:
    """(path, sha256 of the bytes) of every leaf of a parameter tree, in
    its order: two trees are bitwise equal iff their digests are."""
    import hashlib

    import torch
    from repro_torch.nn.param import tree_leaves, tree_paths

    out = []
    for path, x in zip(tree_paths(tree), tree_leaves(tree)):
        raw = x.detach().contiguous().view(torch.uint8).cpu().numpy()
        out.append(("/".join(map(str, path)),
                    hashlib.sha256(raw.tobytes()).hexdigest()))
    return out


DP_WORLD = 2                  # phase 36's ranks, both on cuda:0 over gloo
DP_EXACT_LAYERS, DP_EXACT_B, DP_EXACT_S = 2, 4, 256
DP_NOISE_SEED = 7
DP_TIMEOUT_S = 300            # a collective that waits longer fails
#: the reference selfcheck's tolerances (src/repro/dist/selfcheck.py):
#: (rtol, atol) of the loss and per-example losses, the norms, gradients
DP_TOL = {"loss": (1e-5, 1e-6), "sq_norms": (1e-4, 1e-6),
          "grads": (1e-4, 1e-5)}


def compute_mode() -> str:
    """The card's compute mode as ``nvidia-smi`` reports it."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.splitlines()[0]


def dp_rank(rank, world, tmp, fn):
    """One spawned rank of phase 36 on cuda:0: join the gloo group, run
    ``fn(rank)``, leave the group, write its result to ``tmp``."""
    import pickle

    import torch
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")   # one host
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=DP_TIMEOUT_S))
    try:
        out = fn(rank)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


class PassLaunches:
    """Counts the gram and direct launches of every backward pass
    (``plan._grad``), in order, while entered."""

    def __init__(self):
        self.passes = []

    def __enter__(self):
        from repro_torch.core import plan as plan_mod
        from repro_torch.kernels import ops

        self.orig = plan_mod._grad

        def counted(out, inputs, seed, **kw):
            before = ops.launch_counts()
            gs = self.orig(out, inputs, seed, **kw)
            after = ops.launch_counts()
            self.passes.append({k: after[k] - before[k]
                                for k in NORM_KERNELS
                                if after[k] != before[k]})
            return gs

        plan_mod._grad = counted
        return self

    def __exit__(self, *exc):
        from repro_torch.core import plan as plan_mod
        plan_mod._grad = self.orig


def dp_exact_work(rank):
    """Phase 36 on one rank: ``Engine(mesh=make_host_mesh())``'s
    ``value_grads_and_norms``, ``value_and_norms``, ``clipped_step``
    (without and with noise) and ``step([Clip, GNS])`` on llama3.2-1b at
    full width (``DP_EXACT_LAYERS`` layers, f32) on the global batch; the
    noised gradients checked bitwise against the first rank's. The first
    rank also runs the one-process ``Engine`` on the whole batch (every
    output within ``DP_TOL``) and on each shard's rows: their passes
    summed (and noised) must be the mesh's bit for bit, and the first
    shard's launches per pass are those each rank must make."""
    import torch
    from repro_torch import pex
    from repro_torch.configs.common import ShapeSpec
    from repro_torch.dist import pex as dpex
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.core.passes import add_grad_noise
    from repro_torch.models import registry
    from repro_torch.nn.param import tree_leaves, tree_map, tree_paths

    spec = registry.get("llama3.2-1b")
    cfg = cut(spec, DP_EXACT_LAYERS, dtype="float32")
    params = registry.family_module(spec).init(
        cfg, torch.Generator(device="cuda").manual_seed(0))
    batch = registry.make_train_batch(
        spec, cfg, ShapeSpec("dp-exact", "train", DP_EXACT_S, DP_EXACT_B),
        rng_seed=0)
    loss_fn = registry.make_loss_fn_v2(spec, cfg)
    mesh = make_host_mesh()
    dpex.check_replicated(params, mesh)

    def passes(eng, b):
        """The five calls, in order; their results."""
        g = eng.value_grads_and_norms(loss_fn, params, b)
        n = eng.value_and_norms(loss_fn, params, b)
        c = eng.clipped_step(loss_fn, params, b, clip_norm=clip)
        cn = eng.clipped_step(
            loss_fn, params, b, clip_norm=clip, noise_std=0.5,
            rng=torch.Generator(device="cuda").manual_seed(DP_NOISE_SEED))
        p = eng.step(loss_fn, params, b, [pex.Clip(clip), pex.GNS()])
        return {"grads": g, "norms": n, "clipped": c, "noised": cn,
                "plan": p}

    # the clip threshold of the reference selfcheck: half the median
    # per-example norm, from a one-process pass (the same on every rank)
    clip = 0.5 * float(torch.sqrt(torch.median(pex.Engine(
        pex.PexSpec()).value_and_norms(loss_fn, params, batch)
        .sq_norms.sum(-1))))
    ops.reset_launch_counts()
    with PassLaunches() as counted:
        got = passes(pex.Engine(pex.PexSpec(), mesh=mesh), batch)
    launches = ops.launch_counts()
    dpex.check_replicated(got["noised"].grads, mesh,
                          what="noised gradients")
    out = {"launches": counted.passes, "total": launches, "clip": clip,
           "digest": tree_digest(got["noised"].grads)}
    if rank:
        return out
    local = pex.Engine(pex.PexSpec())
    # against one process on the whole batch: loss and per-example losses
    # at 1e-5, norms (and GNS) at 1e-4, gradients at rtol 1e-4 and atol
    # 1e-5 of each leaf's largest |value| (the reference selfcheck's atol
    # is absolute: at its smoke widths the same scale); the elements an
    # absolute atol of 1e-5 would flag are counted
    want = passes(local, batch)
    checks, flagged = [], 0
    for tag in got:
        g, w = got[tag], want[tag]
        pairs = [("loss", "loss", g.loss, w.loss),
                 ("loss", "loss_vec", g.loss_vec, w.loss_vec),
                 ("sq_norms", "sq_norms", g.sq_norms, w.sq_norms)]
        if getattr(g, "gns", None) is not None:
            pairs.append(("sq_norms", "gns", g.gns, w.gns))
        if g.grads is not None:
            pairs += [("grads", p, a, b) for p, a, b in zip(
                tree_paths(g.grads), tree_leaves(g.grads),
                tree_leaves(w.grads))]
        for kind, name, a, b in pairs:
            rtol, atol = DP_TOL[kind]
            a, b = a.float(), b.float()
            scale = float(b.abs().max()) if kind == "grads" else 1.0
            err = float((a - b).abs().max())
            checks.append((tag, kind, str(name), bool(torch.allclose(
                a, b, rtol=rtol, atol=atol * scale)), err, scale))
            if kind == "grads":
                flagged += int(((a - b).abs()
                                > atol + rtol * b.abs()).sum())
    del want
    # exact: each pass is the two shards' one-process passes, summed
    rows = DP_EXACT_B // DP_WORLD
    halves = []
    for r in range(DP_WORLD):
        with PassLaunches() as one:
            h = passes(local, {k: v[r * rows:(r + 1) * rows]
                               for k, v in batch.items()})
        if r == 0:
            out["one_process"] = one.passes
        for tag in ("norms", "noised"):
            del h[tag]
        halves.append(h)
    exact = {}
    for tag in ("grads", "clipped", "plan"):
        exact[tag] = all(torch.equal(g, a + b) for g, a, b in zip(
            tree_leaves(got[tag].grads),
            *(tree_leaves(h[tag].grads) for h in halves))) and all(
            torch.equal(getattr(got[tag], k),
                        torch.cat([getattr(h[tag], k) for h in halves]))
            for k in ("loss_vec", "sq_norms"))
    summed = tree_map(lambda a, b: a + b, halves[0]["clipped"].grads,
                      halves[1]["clipped"].grads)
    del halves
    add_grad_noise(summed, 0.5, clip, torch.Generator(
        device="cuda").manual_seed(DP_NOISE_SEED))
    exact["noised"] = all(torch.equal(g, w) for g, w in zip(
        tree_leaves(got["noised"].grads), tree_leaves(summed)))
    out.update(checks=checks, flagged=flagged, exact=exact)
    return out


def phase_dp_exact():
    """Phase 36: two ranks on cuda:0 over gloo (``make_host_mesh()``)
    against the one-process ``Engine`` on llama3.2-1b at full width, 2
    layers, f32, B=4, S=256, at the reference selfcheck's tolerances (the
    gradients' atol scaled by each leaf's largest |value|: its absolute
    1e-5 was set at smoke widths) and, bit for bit, against the two
    shards' one-process passes summed; both ranks' noised gradients bit
    for bit equal; each shard's gram and direct launches per pass those of
    a one-process pass on its 2 rows."""
    import pickle
    import tempfile

    import torch
    import torch.multiprocessing as mp

    mode = compute_mode()
    log(f"[dp-exact] compute mode {mode!r}; {DP_WORLD} ranks on cuda:0 "
        f"over gloo; llama3.2-1b, {DP_EXACT_LAYERS} layers, float32, "
        f"B={DP_EXACT_B}, S={DP_EXACT_S}")
    if mode != "Default":
        raise AssertionError(f"compute mode {mode!r}: two processes cannot "
                             f"share the card")
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(dp_rank, args=(DP_WORLD, tmp, dp_exact_work),
                           nprocs=DP_WORLD, start_method="spawn")
        ranks = []
        for r in range(DP_WORLD):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                ranks.append(pickle.load(f))
    first = ranks[0]
    bad = [c for c in first["checks"] if not c[3]]
    worst = {}
    for tag, kind, _, _, err, _ in first["checks"]:
        worst[(tag, kind)] = max(worst.get((tag, kind), 0.0), err)
    log(f"[dp-exact] clip {first['clip']:.4g}; max |Δ| against one process "
        f"by pass and output: "
        f"{ {f'{t}/{k}': float(f'{e:.3g}') for (t, k), e in worst.items()} }"
        f" (tolerances {DP_TOL}, gradients' atol of each leaf's max "
        f"|value|); gradient elements an absolute atol of 1e-5 flags: "
        f"{first['flagged']}; bit for bit the two shards' one-process "
        f"passes summed: {first['exact']}")
    if bad:
        raise AssertionError(
            f"dp-exact: {len(bad)} outputs outside the tolerance "
            f"(pass, kind, output, ok, max |Δ|, max |value|): {bad[:8]}")
    if not all(first["exact"].values()):
        raise AssertionError(f"dp-exact: not the shards' passes summed: "
                             f"{first['exact']}")
    for r, rank in enumerate(ranks):
        if rank["digest"] != first["digest"]:
            raise AssertionError(f"dp-exact: rank {r}'s noised gradients "
                                 f"differ from rank 0's")
        if rank["launches"] != first["one_process"]:
            raise AssertionError(
                f"dp-exact: rank {r} launched {rank['launches']} per pass, "
                f"one process on {DP_EXACT_B // DP_WORLD} rows "
                f"{first['one_process']}")
        if not any(rank["total"][k] for k in NORM_KERNELS):
            raise AssertionError(f"dp-exact: rank {r} launched no norm "
                                 f"kernel: {rank['total']}")
    log(f"[dp-exact] both ranks' noised gradients bitwise equal "
        f"({len(first['digest'])} leaves); gram/direct launches per pass "
        f"on each rank {first['launches']}, as one process on "
        f"{DP_EXACT_B // DP_WORLD} rows; {time.perf_counter() - t0:.1f} s")
    return {"worst": worst, "launches": first["launches"],
            "seconds": time.perf_counter() - t0}


def clip_trainer(spec, registry, cfg, mesh=None):
    """Phase 17's clip trainer on fresh parameters (seed 0):
    ``TRAIN_CLIP_STEPS`` steps of ``consumers_for_mode("clip", B,
    noise_std=0.1)`` on ``SyntheticLM`` (seed 0) under AdamW with phase
    17's warm-up cosine over all its steps; on ``mesh``, or alone."""
    import torch
    from repro_torch.core.taps import PexSpec
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.optim import adamw
    from repro_torch.optim.schedule import linear_warmup_cosine
    from repro_torch.train.trainer import (TrainConfig, Trainer,
                                           consumers_for_mode)

    params = registry.family_module(spec).init(
        cfg, torch.Generator(device="cuda").manual_seed(0))
    return Trainer(registry.make_loss_fn_v2(spec, cfg), params, PexSpec(),
                   adamw.AdamWConfig(schedule=linear_warmup_cosine(
                       2, TRAIN_CLIP_STEPS + TRAIN_IMPORTANCE_STEPS)),
                   TrainConfig(consumers=consumers_for_mode(
                       "clip", B, noise_std=0.1), steps=TRAIN_CLIP_STEPS,
                       log_every=1, seed=0),
                   DataConfig(vocab=cfg.vocab, seq=S, global_batch=B,
                              seed=0), mesh=mesh)


class one_rank_nccl:
    """A one-rank NCCL group on cuda:0 for the body; enters as
    ``make_host_mesh()`` over it."""

    def __enter__(self):
        import tempfile

        import torch
        import torch.distributed as dist
        from repro_torch.launch.mesh import make_host_mesh

        torch.cuda.set_device(0)
        self.tmp = tempfile.TemporaryDirectory()
        dist.init_process_group(
            "nccl", init_method=f"file://{self.tmp.name}/store", rank=0,
            world_size=1, timeout=datetime.timedelta(seconds=DP_TIMEOUT_S))
        return make_host_mesh()

    def __exit__(self, *exc):
        import torch.distributed as dist
        dist.destroy_process_group()
        self.tmp.cleanup()


class CollectiveSpans:
    """CUDA events around ``dist.pex``'s gradient all-reduce and
    per-example gathers, grouped by the trainer's steps, while entered."""

    def __init__(self, trainer):
        self.trainer = trainer
        self.spans = []

    def _timed(self, kind, fn):
        import torch

        def wrapper(*a, **kw):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = fn(*a, **kw)
            e1.record()
            self.spans[-1][kind].append((e0, e1))
            return out
        return wrapper

    def __enter__(self):
        from repro_torch.dist import pex as dpex

        self.orig = dpex._reduce_grads, dpex._gather_rows
        run_step = self.trainer.run_step

        def marked(batch):
            self.spans.append({"reduce": [], "gather": []})
            return run_step(batch)

        self.trainer.run_step = marked
        dpex._reduce_grads = self._timed("reduce", self.orig[0])
        dpex._gather_rows = self._timed("gather", self.orig[1])
        return self

    def __exit__(self, *exc):
        from repro_torch.dist import pex as dpex
        dpex._reduce_grads, dpex._gather_rows = self.orig
        del self.trainer.run_step

    def ms(self, kind) -> list:
        """Stream ms of ``kind`` ("reduce" or "gather") a step (after the
        card is synchronized)."""
        return [sum(a.elapsed_time(b) for a, b in sp[kind])
                for sp in self.spans]


def dp_times(pairs=2):
    """Phase 17's clip steps alone and through a one-rank NCCL mesh
    (``clip_trainer``), in turns (alone, mesh, mesh, alone, ...): each
    run's steady step ms (steps 1 to the last) and the mesh runs' gradient
    all-reduce and gather stream ms a step. Not in a whole run."""
    import torch
    from repro_torch.models import registry

    phase_build()
    spec = registry.get("llama3.2-1b")
    cfg = spec.full()
    out = {"alone": [], "mesh": [], "reduce_ms": [], "gather_ms": []}
    with one_rank_nccl() as mesh:
        for i in range(2 * pairs):
            kind = ("alone", "mesh", "mesh", "alone")[i % 4]
            t = clip_trainer(spec, registry, cfg,
                             mesh if kind == "mesh" else None)
            with CollectiveSpans(t) as spans:
                metrics = t.train()
            torch.cuda.synchronize()
            out[kind].append([round(m["time_s"] * 1e3, 1)
                              for m in metrics[1:]])
            if kind == "mesh":
                for k in ("reduce", "gather"):
                    out[f"{k}_ms"].append([round(x, 3)
                                           for x in spans.ms(k)[1:]])
            del t, spans
            torch.cuda.empty_cache()
    log(f"[dp-times] in turns (alone, mesh, mesh, alone): {json.dumps(out)}")
    return out


def phase_dp(spec, registry, cfg, train_run):
    """Phase 37, the slice's path: phase 17's clip steps through
    ``Trainer(mesh=make_host_mesh())`` on a one-rank NCCL group, llama3.2-1b
    at full depth and width in bf16, B=8, S=512, the same seeds and
    schedule; the parameters after the steps bit for bit phase 17's; the
    stream ms of the gradient all-reduce and of the per-example gathers
    (CUDA events around ``dist.pex``'s two collectives), step ms beside
    phase 17's, peak memory, and each pass's gram and direct launches
    (phase 5's in the norms pass, none in the reweighted pass). Then the
    launcher's ``--data-parallel`` once in a subprocess."""
    import torch
    import torch.distributed as dist
    from repro_torch.kernels import ops

    norms_want = train_run["norms_want"]
    log(f"[dp] {cfg.name}, {cfg.n_layers} layers, {cfg.dtype}, B={B}, "
        f"S={S}: phase 17's {TRAIN_CLIP_STEPS} clip+noise steps through "
        f"Trainer(mesh=make_host_mesh()) on a one-rank NCCL group")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with one_rank_nccl() as mesh:
        t = clip_trainer(spec, registry, cfg, mesh)
        backend = dist.get_backend()
        ops.reset_launch_counts()
        with CollectiveSpans(t) as spans, PassLaunches() as counted:
            metrics = t.train()
        launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    digest = tree_digest(t.params)
    del t
    torch.cuda.synchronize()
    reduce_ms, gather_ms = spans.ms("reduce"), spans.ms("gather")
    n_coll = [(len(sp["reduce"]), len(sp["gather"])) for sp in spans.spans]
    step_ms = [m["time_s"] * 1e3 for m in metrics]
    want = [norms_want, {}] * TRAIN_CLIP_STEPS
    log(f"[dp] backend {backend}; step ms {[round(x, 1) for x in step_ms]}"
        f" (phase 17's clip steps "
        f"{[round(x, 1) for x in train_run['step_ms'][:TRAIN_CLIP_STEPS]]}"
        f"); gradient all-reduce stream ms a step "
        f"{[round(x, 3) for x in reduce_ms]}, per-example gathers "
        f"{[round(x, 3) for x in gather_ms]} (collectives a step, "
        f"reduce/gather: {n_coll}); peak memory {peak:.2f} GiB (phase "
        f"17's {train_run['peak_gib']:.2f}); launches per pass "
        f"{counted.passes[:2]} (phase 5's norms pass {norms_want})")
    if counted.passes != want:
        raise AssertionError(f"dp: launches per pass {counted.passes}, "
                             f"expected {want}")
    if {k: launches[k] for k in NORM_KERNELS} != {
            k: TRAIN_CLIP_STEPS * norms_want.get(k, 0)
            for k in NORM_KERNELS}:
        raise AssertionError(f"dp: launches {launches}")
    if not all(math.isfinite(m[k]) for m in metrics
               for k in ("loss", "norm_mean", "norm_max")):
        raise AssertionError(f"dp: {metrics}")
    differ = [p for (p, a), (_, b) in zip(digest, train_run["clip_digest"])
              if a != b]
    if len(digest) != len(train_run["clip_digest"]) or differ:
        raise AssertionError(f"dp: the parameters after {TRAIN_CLIP_STEPS} "
                             f"steps differ from phase 17's in "
                             f"{len(differ)} leaves: {differ[:8]}")
    log(f"[dp] the parameters after {TRAIN_CLIP_STEPS} steps equal phase "
        f"17's bit for bit ({len(digest)} leaves)")
    t0 = time.perf_counter()
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           "llama3.2-1b", "--smoke", "--data-parallel", "--steps", "2"]
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                       cwd=ROOT, env=dict(os.environ, PYTHONPATH=os.path.join(
                           ROOT, "src")))
    log(f"[dp] {' '.join(cmd[1:])}: exit {r.returncode} in "
        f"{time.perf_counter() - t0:.1f} s; "
        f"{' | '.join(r.stdout.strip().splitlines()[-3:])}")
    if r.returncode or "data-parallel over 1 ranks (nccl, cuda)" \
            not in r.stdout:
        raise AssertionError(f"dp launcher: exit {r.returncode}\n"
                             f"{r.stdout[-2000:]}\n{r.stderr[-4000:]}")
    return {"step_ms": step_ms, "reduce_ms": reduce_ms,
            "gather_ms": gather_ms, "peak_gib": peak}


CKPT_STEPS, CKPT_EVERY = 4, 2     # phase 38: 4 straight; 2 + resume + 2
CKPT_LAYERS = 2                   # its depth cut when the disk is short
CKPT_FREE_FACTOR = 3              # free bytes needed, in states


class CkptTimes:
    """While entered: the ms each ``CheckpointManager.save`` blocks its
    caller (the device→host copy), the seconds each write takes on the
    writer thread (serialize, sha256, commit) and each ``restore``'s
    seconds (read, sha256, host→device, synchronized)."""

    def __enter__(self):
        import torch
        from repro_torch.ckpt.checkpoint import CheckpointManager as cm

        self.save_ms, self.write_s, self.restore_s = [], [], []
        self.orig = cm.save, cm._write_inner, cm.restore

        def save(mgr, *a, **kw):
            t0 = time.perf_counter()
            self.orig[0](mgr, *a, **kw)
            self.save_ms.append((time.perf_counter() - t0) * 1e3)

        def write(mgr, *a, **kw):
            t0 = time.perf_counter()
            self.orig[1](mgr, *a, **kw)
            self.write_s.append(time.perf_counter() - t0)

        def restore(mgr, *a, **kw):
            t0 = time.perf_counter()
            out = self.orig[2](mgr, *a, **kw)
            torch.cuda.synchronize()
            self.restore_s.append(time.perf_counter() - t0)
            return out

        cm.save, cm._write_inner, cm.restore = save, write, restore
        return self

    def __exit__(self, *exc):
        from repro_torch.ckpt.checkpoint import CheckpointManager as cm
        cm.save, cm._write_inner, cm.restore = self.orig


def ckpt_trainer(spec, registry, cfg, steps, ckpt_dir=None):
    """Phase 38's trainer: phase 17's clip trainer without noise (nothing
    drawn), its schedule over ``CKPT_STEPS``, checkpointing every
    ``CKPT_EVERY`` steps into ``ckpt_dir`` (``keep=2``) when given."""
    import torch
    from repro_torch.core.taps import PexSpec
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.optim import adamw
    from repro_torch.optim.schedule import linear_warmup_cosine
    from repro_torch.train.trainer import (TrainConfig, Trainer,
                                           consumers_for_mode)

    params = registry.family_module(spec).init(
        cfg, torch.Generator(device="cuda").manual_seed(0))
    t = Trainer(registry.make_loss_fn_v2(spec, cfg), params, PexSpec(),
                adamw.AdamWConfig(schedule=linear_warmup_cosine(
                    2, CKPT_STEPS)),
                TrainConfig(consumers=consumers_for_mode("clip", B),
                            steps=steps, log_every=1, ckpt_every=CKPT_EVERY,
                            ckpt_dir=ckpt_dir, seed=0),
                DataConfig(vocab=cfg.vocab, seq=S, global_batch=B, seed=0))
    if t.ckpt is not None:
        t.ckpt.keep = 2
    return t


def state_digest(t) -> list:
    """Per-leaf sha256 of a trainer's parameters and moments, and its
    optimizer step."""
    return tree_digest(t._state_tree()) + [("opt_step",
                                            str(int(t.opt_state.step)))]


def phase_ckpt(spec, registry, cfg, train_run):
    """Phase 38, the slice's path: phase 17's trainer without noise, 4
    steps straight against 2 + ``train(resume=True)`` + 2 through the
    port's ``CheckpointManager``, bit for bit; then a corrupted newest
    step and ``restore_from``'s fall-back to step 2's digest. Full depth
    when the temporary directory holds ``CKPT_FREE_FACTOR`` states, else
    ``CKPT_LAYERS`` layers; raises when even that does not fit."""
    import shutil
    import tempfile
    import warnings

    import torch
    from repro_torch import ft
    from repro_torch.kernels import ops
    from repro_torch.nn.param import count_params, tree_leaves

    def n_params(c):
        n = count_params(registry.family_module(spec).init(
            c, torch.Generator(device="cuda").manual_seed(0)))
        torch.cuda.empty_cache()
        return n

    tmp_root = tempfile.gettempdir()
    free = shutil.disk_usage(tmp_root).free
    per_param = 2 + 4 + 4        # bf16 parameter, f32 mu and nu
    n_full = n_params(cfg)
    need_full = CKPT_FREE_FACTOR * per_param * n_full
    if free >= need_full:
        ck_cfg, ck_params = cfg, n_full
        depth = f"full depth ({cfg.n_layers} layers)"
    else:
        ck_cfg = cut(spec, CKPT_LAYERS)
        ck_params = n_params(ck_cfg)
        depth = (f"{CKPT_LAYERS} layers (the disk holds {free / 2**30:.1f} "
                 f"GiB, full depth needs {need_full / 2**30:.1f})")
    need = CKPT_FREE_FACTOR * per_param * ck_params
    log(f"[ckpt] {ck_cfg.name}, {depth}, {ck_cfg.dtype}, B={B}, S={S}: "
        f"{ck_params / 1e9:.3f}B parameters, state "
        f"{per_param * ck_params / 2**30:.2f} GiB; {tmp_root} has {free / 2**30:.1f} GiB free (need "
        f"{need / 2**30:.1f}, {CKPT_FREE_FACTOR} states)")
    if free < need:
        raise AssertionError(f"ckpt: {tmp_root} has {free} bytes free, a "
                             f"{CKPT_FREE_FACTOR}-state run needs {need}")
    norms_want = {k: sum(v.values())
                  for k, v in main_path_launches(ck_cfg, S).items() if v}
    d = tempfile.mkdtemp(prefix="ckpt_", dir=tmp_root)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    runs = {}
    try:
        with CkptTimes() as times:
            for tag, steps, ckpt_dir, resume in (
                    ("straight", CKPT_STEPS, None, False),
                    ("first", CKPT_EVERY, d, False),
                    ("resumed", CKPT_STEPS, d, True)):
                t = ckpt_trainer(spec, registry, ck_cfg, steps, ckpt_dir)
                ops.reset_launch_counts()
                with PassLaunches() as counted:
                    metrics = t.train(resume=resume)
                launches = ops.launch_counts()
                n = len(metrics)
                if counted.passes != [norms_want, {}] * n:
                    raise AssertionError(
                        f"ckpt {tag}: launches per pass {counted.passes}, "
                        f"expected {[norms_want, {}] * n}")
                if not all(math.isfinite(m[k]) for m in metrics
                           for k in ("loss", "norm_mean", "norm_max")):
                    raise AssertionError(f"ckpt {tag}: {metrics}")
                if tag == "straight":
                    state_bytes = sum(x.numel() * x.element_size()
                                      for x in tree_leaves(t._state_tree()))
                runs[tag] = {"digest": state_digest(t), "step": t.step,
                             "losses": [m["loss"] for m in metrics],
                             "launches": {k: launches[k]
                                          for k in NORM_KERNELS}}
                if tag == "resumed":
                    steps_on_disk = t.ckpt.all_steps()
                    newest = ft.corrupt_newest_checkpoint(d)
                    with warnings.catch_warnings(record=True) as caught:
                        warnings.simplefilter("always")
                        back = t.restore_from()
                    fell = [str(w.message) for w in caught
                            if "falling back" in str(w.message)]
                    runs["fallback"] = {"digest": state_digest(t),
                                        "step": back}
                del t
                torch.cuda.empty_cache()
    finally:
        shutil.rmtree(d, ignore_errors=True)
    peak = torch.cuda.max_memory_allocated() / 2**30
    straight, first, resumed = (runs[k] for k in
                                ("straight", "first", "resumed"))
    exact = resumed["digest"] == straight["digest"]
    losses = resumed["losses"] == straight["losses"][CKPT_EVERY:]
    fb = runs["fallback"]
    log(f"[ckpt] losses straight {straight['losses']}, first "
        f"{first['losses']}, resumed {resumed['losses']}; launches per "
        f"norms pass {norms_want} in every step; steps on disk "
        f"{steps_on_disk}, corrupted step {newest}; restore_from fell back "
        f"to step {fb['step']} ({len(fell)} warning: "
        f"{fell[0][:90] if fell else None!r})")
    if not exact or not losses or resumed["step"] != CKPT_STEPS:
        differ = [p for (p, a), (_, b) in zip(resumed["digest"],
                                              straight["digest"]) if a != b]
        raise AssertionError(f"ckpt: 2 + resume + 2 differs from 4 straight "
                             f"in {len(differ)} leaves {differ[:8]}; losses "
                             f"equal: {losses}")
    if steps_on_disk != [CKPT_EVERY, CKPT_STEPS] or newest != CKPT_STEPS \
            or fb["step"] != CKPT_EVERY or not fell \
            or fb["digest"] != first["digest"]:
        raise AssertionError(f"ckpt: the fall-back past corrupted step "
                             f"{newest} gave step {fb['step']} (warnings "
                             f"{fell}); step {CKPT_EVERY}'s digest: "
                             f"{fb['digest'] == first['digest']}")
    gb = state_bytes / 1e9
    out = {"state_gib": state_bytes / 2**30, "depth": ck_cfg.n_layers,
           "save_ms": times.save_ms, "write_s": times.write_s,
           "write_gb_s": [gb / x for x in times.write_s],
           "restore_s": times.restore_s, "peak_gib": peak}
    log(f"[ckpt] resumed bit for bit ({len(straight['digest'])} leaves and "
        f"the optimizer step); state {out['state_gib']:.2f} GiB; save() "
        f"blocked the step loop {[round(x, 1) for x in times.save_ms]} ms "
        f"(device→host copy); writer commit "
        f"{[round(x, 2) for x in times.write_s]} s "
        f"({[round(x, 2) for x in out['write_gb_s']]} GB/s); restore "
        f"{[round(x, 2) for x in times.restore_s]} s (read, sha256, "
        f"host→device; the resume's, then the fall-back's); peak memory "
        f"{peak:.2f} GiB (phase 17's {train_run['peak_gib']:.2f})")
    return out


SOAK_ARGS = ("--hosts", "4", "--steps", "24", "--storm", "short",
             "--device", "cuda")


def phase_soak():
    """Phase 39: the port's soak launcher (4 gloo ranks on cuda:0, the
    ``short`` storm, its three invariants) in a subprocess; exit 0 and the
    storm's coverage; its wall time."""
    mode = compute_mode()
    log(f"[soak] compute mode {mode!r}; python -m repro_torch.launch.soak "
        f"{' '.join(SOAK_ARGS)}")
    if mode != "Default":
        raise AssertionError(f"compute mode {mode!r}: four processes cannot "
                             f"share the card")
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.soak",
                        *SOAK_ARGS], capture_output=True, text=True,
                       timeout=600, cwd=ROOT,
                       env=dict(os.environ,
                                PYTHONPATH=os.path.join(ROOT, "src")))
    wall = time.perf_counter() - t0
    if r.returncode or "\n{" not in "\n" + r.stdout:
        raise AssertionError(f"soak: exit {r.returncode}\n"
                             f"{r.stdout[-3000:]}\n{r.stderr[-4000:]}")
    out = ("\n" + r.stdout)
    summary = json.loads(out[out.rindex("\n{") + 1:])
    storm = [ln for ln in r.stdout.splitlines() if ln.startswith("[soak]")]
    cov = {k: summary[k] for k in ("contractions", "expansions", "fallbacks",
                                   "quarantined_steps",
                                   "quarantined_examples", "ticks",
                                   "final_hosts")}
    log(f"[soak] exit 0 in {wall:.1f} s; invariants {summary['invariants']}; "
        f"coverage {cov}; recoveries "
        f"{[(x['reason'], x['restored_step'], x['hosts']) for x in summary['recoveries']]}"
        f"; storm: {' | '.join(x[7:] for x in storm)}")
    if summary["invariants"] != "PASS" or summary["contractions"] < 2 \
            or summary["expansions"] < 1 or summary["fallbacks"] < 1 \
            or not summary["quarantined_steps"]:
        raise AssertionError(f"soak: the storm's coverage is short: {cov}")
    return {"seconds": wall, "summary": summary}


def norm_host_us(reps=200):
    """Host time of one call (µs) of the bf16 gram launcher at wq's shape
    and of the direct launcher at wk's (B=8, S=512), with the card held
    busy so that no call waits for it (``time.perf_counter`` around
    ``reps`` calls after a warm-up), split into ``checks``
    (``_build.pair_inputs``), ``python`` (the rest of the launcher before
    the C call: outputs, scratch, the plan, the route, the stream),
    ``ctypes_launch`` (the C call with its launches, on the staged route,
    which encodes no tensor map) and ``encode`` (the TMA route's C call
    less the staged one's: its tensor maps). The C calls replay the
    arguments the launcher passed."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import direct_norm as dn
    from repro_torch.kernels import gram_norm as gn

    gen = torch.Generator(device="cuda").manual_seed(7)
    h = torch.randn(B, S, 2048, generator=gen, device="cuda").to(
        torch.bfloat16)
    zq, zk = (torch.randn(B, S, p, generator=gen, device="cuda").to(
        torch.bfloat16) for p in (2048, 512))
    launchers = {"gram_norm": ("gram_norm_launch", 15,
                               lambda: gn.gram_norm(h, zq), zq),
                 "direct_norm": ("direct_norm_launch", 13,
                                 lambda: dn.direct_norm(h, zk), zk)}
    lib = _build.load()

    def host_us(fn):
        fn()
        torch.cuda.synchronize()
        torch.cuda._sleep(400_000_000)    # ~0.2 s at the H100's clocks
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        us = (time.perf_counter() - t0) / reps * 1e6
        torch.cuda.synchronize()
        return us

    out = {}
    for name, (c_name, tma_arg, call, z) in launchers.items():
        recorded = {}
        c_fn = getattr(lib, c_name)

        class Spy:      # the C call's arguments, as the launcher made them
            def __getattr__(self, attr):
                if attr != c_name:
                    return getattr(lib, attr)
                return lambda *a: recorded.setdefault("args", a) and c_fn(*a)
        real_load = _build.load
        _build.load = Spy
        try:
            kept = call()   # its scratch stays alive for the replays
        finally:
            _build.load = real_load
        args = list(recorded["args"])
        staged = args[:tma_arg] + [0] + args[tma_arg + 1:]
        total = host_us(call)
        c_tma = host_us(lambda: c_fn(*args))
        c_staged = host_us(lambda: c_fn(*staged))
        chk = host_us(lambda: _build.pair_inputs(h, z, name))
        out[name] = {"total": total, "checks": chk,
                     "python": total - c_tma - chk,
                     "ctypes_launch": c_staged, "encode": c_tma - c_staged,
                     "route": "tma" if args[tma_arg] else "synchronous"}
        del kept
    log(f"[norm-host] host µs per call, card held busy, B={B} S={S} bf16 "
        f"(gram at 2048→2048, direct at 2048→512): {json.dumps(out)}")
    return out


def flash_times():
    """Device time of one call (ms) of each bf16 flash kernel at the main
    path's shape and of its yardstick, PyTorch's
    ``scaled_dot_product_attention``: its forward beside ``fwd``, its
    autograd backward (dQ, dK and dV in one call) beside ``dq`` and
    ``dkv``, and beside ``delta``, Δ = rowsum(dO ⊙ O) (``row_delta``, a
    torch expression the port runs before its two backward kernels, while
    SDPA's backward forms its own). Each pair is timed with ``device_ms``
    (card held busy, input copies cycled past the L2) in turns kernel,
    library, library, kernel. Returns ``{kind: {"kernel": [t1, t4],
    "library": [t2, t3]}}`` and the input sets. It uses only the launchers' public signatures, so a copy of
    this file placed in an older checkout times that checkout's kernels:
    ``python3 -c "import chip_smoke; chip_smoke.flash_times()"``."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(4)
    dt = torch.bfloat16
    b, hq, hkv, s, d = FLASH_CASES[0][:5]
    scale = d ** -0.5
    sets = []       # input copies, together above twice the L2 cache
    while sum(sum(t.numel() * t.element_size() for t in x[:6])
              for x in sets) < 2 * L2_BYTES:
        q, k, v, do = flash_inputs(b, hq, hkv, s, d, dt, gen)
        o, lse = fa.flash_attention_fwd(q, k, v, scale=scale)
        ql, kl, vl = (x.detach().requires_grad_() for x in (q, k, v))
        out = F.scaled_dot_product_attention(
            ql, kl, vl, is_causal=True, scale=scale, enable_gqa=True)
        sets.append((q, k, v, do, lse, fa.row_delta(o, do), ql, kl, vl, out,
                     o))
    kern = {"fwd": lambda x: fa.flash_attention_fwd(*x[:3], scale=scale),
            "dq": lambda x: fa.flash_attention_bwd_dq(*x[:6], scale=scale),
            "dkv": lambda x: fa.flash_attention_bwd_dkv(*x[:6], scale=scale),
            "delta": lambda x: fa.row_delta(x[10], x[3])}
    # the yardstick: one PyTorch call for the same attention; never on the
    # path
    lib = {"fwd": lambda x: F.scaled_dot_product_attention(
               x[6], x[7], x[8], is_causal=True, scale=scale,
               enable_gqa=True),
           "bwd": lambda x: torch.autograd.grad(
               x[9], (x[6], x[7], x[8]), x[3], retain_graph=True)}
    times = {}
    for kind, fn in kern.items():
        yard = lib["fwd" if kind == "fwd" else "bwd"]
        turns = [device_ms(fn, sets, 20), device_ms(yard, sets, 20),
                 device_ms(yard, sets, 20), device_ms(fn, sets, 20)]
        times[kind] = {"kernel": [turns[0], turns[3]],
                       "library": [turns[1], turns[2]]}
    log(f"[flash-times] {len(sets)} input sets (B,Hq,Hkv,S,D)=({b},{hq},"
        f"{hkv},{s},{d}) bf16, device ms per call: {json.dumps(times)}")
    return times, sets


def flash_host_us(reps=200):
    """Host time of one call (µs) of each bf16 flash launcher at the main
    path's shape, with the card held busy so that no call waits for it
    (``time.perf_counter`` around ``reps`` calls after a warm-up), split
    into: ``checks`` (the launcher's checks of its inputs and options),
    ``python`` (the rest of the launcher before the C call: outputs, the
    stream, the strides array, the route), ``ctypes_launch`` (the C call
    with its launch, on the staged route, which encodes no tensor map) and
    ``encode`` (the TMA route's C call less the staged one's: its tensor
    maps). The C calls replay the arguments the launcher passed."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(6)
    dt = torch.bfloat16
    b, hq, hkv, s, d = FLASH_CASES[0][:5]
    scale = d ** -0.5
    q, k, v, do = flash_inputs(b, hq, hkv, s, d, dt, gen)
    o, lse = fa.flash_attention_fwd(q, k, v, scale=scale)
    delta = fa.row_delta(o, do)
    launchers = {
        "fwd": ("flash_attention_fwd_launch", 16,
                lambda: fa.flash_attention_fwd(q, k, v, scale=scale),
                lambda: fa._inputs("flash_attention", q, k, v)),
        "dq": ("flash_attention_bwd_dq_launch", 18,
               lambda: fa.flash_attention_bwd_dq(q, k, v, do, lse, delta,
                                                 scale=scale),
               lambda: fa._inputs("flash_attention_bwd_dq", q, k, v, do)),
        "dkv": ("flash_attention_bwd_dkv_launch", 19,
                lambda: fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                                   scale=scale),
                lambda: fa._inputs("flash_attention_bwd_dkv", q, k, v, do))}
    lib = _build.load()

    def host_us(fn):
        fn()
        torch.cuda.synchronize()
        torch.cuda._sleep(400_000_000)    # ~0.2 s at the H100's clocks
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        us = (time.perf_counter() - t0) / reps * 1e6
        torch.cuda.synchronize()
        return us

    out = {}
    for kind, (name, tma_arg, call, inputs) in launchers.items():
        recorded = {}
        c_fn = getattr(lib, name)

        class Spy:      # the C call's arguments, as the launcher made them
            def __getattr__(self, attr):
                if attr != name:
                    return getattr(lib, attr)
                return lambda *a: recorded.setdefault("args", a) and c_fn(*a)
        real_load = _build.load
        _build.load = Spy
        try:
            kept = call()   # its outputs stay alive for the replays
        finally:
            _build.load = real_load
        args = list(recorded["args"])
        staged = args[:tma_arg] + [0] + args[tma_arg + 1:]

        def checks():
            inputs()
            if kind != "fwd":
                fa._rows(lse, q, "lse")
                fa._rows(delta, q, "delta")
            fa._options(None, None)
        total = host_us(call)
        c_tma = host_us(lambda: c_fn(*args))
        c_staged = host_us(lambda: c_fn(*staged))
        chk = host_us(checks)
        out[kind] = {"total": total, "checks": chk,
                     "python": total - c_tma - chk,
                     "ctypes_launch": c_staged,
                     "encode": c_tma - c_staged,
                     "route": "tma" if args[tma_arg] else "synchronous"}
        del kept
    log(f"[flash-host] host µs per call, card held busy, (B,Hq,Hkv,S,D)="
        f"({b},{hq},{hkv},{s},{d}) bf16: {json.dumps(out)}")
    return out


CLOCK_NAMES = ("total", "first_tile", "copy_waits", "product_waits",
               "softmax")


def flash_clocks(reps=5):
    """Clock counts inside the bf16 forward at the main path's shape: a copy
    of ``csrc/flash_attention.cu`` built with ``-DREPRO_FLASH_CLOCKS`` into
    ``build/flash_clocks/`` (the package's own library is not touched),
    launched ``reps`` times through the forward's launcher; the last
    launch's records, one per (block, consumer warpgroup) of
    ``CLOCK_NAMES`` cycles: from the warpgroup's start to the end of its
    tiles, to its first tile's arrival, in waits for copies and block
    barriers, in waits for products, in the softmax. Returns their means
    and each mean's share of the total. It goes through the launcher, so a
    copy of this file in an older checkout with the probes reads that
    checkout's kernel: ``python3 -c "import chip_smoke;
    chip_smoke.flash_clocks()"``."""
    import ctypes
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa

    out_dir = os.path.join(ROOT, "build", "flash_clocks")
    os.makedirs(out_dir, exist_ok=True)
    lib_file = os.path.join(out_dir, "libflash_clocks.so")
    csrc = os.path.join(ROOT, "src", "repro_torch", "csrc")
    subprocess.run([_build._nvcc(), *_build.ARCH_FLAGS, "-std=c++17", "-O3",
                    "-Xcompiler", "-fPIC", "-DREPRO_FLASH_CLOCKS", "-shared",
                    "-o", lib_file, os.path.join(csrc, "flash_attention.cu"),
                    os.path.join(csrc, "errors.cu")],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(lib_file)
    for name, argtypes in _build._SIGNATURES.items():
        if name.startswith("flash_attention"):
            getattr(lib, name).argtypes = list(argtypes)
            getattr(lib, name).restype = ctypes.c_int
    lib.repro_error_string.argtypes = [ctypes.c_int]
    lib.repro_error_string.restype = ctypes.c_char_p
    lib.flash_attention_clocks.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.flash_attention_clocks.restype = ctypes.c_int

    gen = torch.Generator(device="cuda").manual_seed(5)
    b, hq, hkv, s, d = FLASH_CASES[0][:5]
    q, k, v, _ = flash_inputs(b, hq, hkv, s, d, torch.bfloat16, gen)
    real_load = _build.load
    _build.load = lambda: lib
    try:
        for _ in range(reps):
            fa.flash_attention_fwd(q, k, v, scale=d ** -0.5)
        torch.cuda.synchronize()
    finally:
        _build.load = real_load
    n = 8192 * len(CLOCK_NAMES)
    buf = (ctypes.c_longlong * n)()
    code = lib.flash_attention_clocks(buf, n)
    if code != 0:
        raise RuntimeError(f"reading the clock records: CUDA error {code}")
    recs = torch.tensor(list(buf), dtype=torch.float64).view(
        -1, len(CLOCK_NAMES))
    recs = recs[recs[:, 0] > 0]         # the records this launch wrote
    means = recs.mean(dim=0).tolist()
    out = {name: {"cycles": m, "share": m / means[0]}
           for name, m in zip(CLOCK_NAMES, means)}
    log(f"[flash-clocks] forward (B,Hq,Hkv,S,D)=({b},{hq},{hkv},{s},{d}) "
        f"bf16, mean over {recs.shape[0]} (block, warpgroup) records: "
        f"{json.dumps(out)}")
    return out


def flash_table(errs, launches, kern_ms):
    """The flash kernels at the main path's shape (bf16), each beside SDPA
    (:func:`flash_times`); the plain version and the bound per launch;
    scaled to the flash path's launches per step. ``path_events_ms`` keeps
    the CUDA events around the launches on the path. Each row carries its
    kernel's registers, local memory, shared memory and resident blocks
    per SM, as the runtime reports them (the registers and local bytes are
    those ``nvcc -Xptxas -v`` printed in phase 2)."""
    from repro_torch.kernels import flash_attention as fa

    times, sets = flash_times()
    b, hq, hkv, s, d = FLASH_CASES[0][:5]
    scale = d ** -0.5
    plain = {"fwd": lambda x: fa.flash_attention_fwd_ref(*x[:3], scale=scale),
             "dq": lambda x: fa.flash_attention_bwd_dq_ref(*x[:6],
                                                           scale=scale),
             "dkv": lambda x: fa.flash_attention_bwd_dkv_ref(*x[:6],
                                                             scale=scale)}
    kinds = {"flash_attention": "fwd", "flash_attention_bwd_dq": "dq",
             "flash_attention_bwd_dkv": "dkv"}
    rows, per_launch = [], {}
    for name, kind in kinds.items():
        n = launches[name] // STEPS
        kt, lt = times[kind]["kernel"], times[kind]["library"]
        ms, lib_ms = sum(kt) / 2, sum(lt) / 2
        per_launch[kind] = (ms, lib_ms)
        plain_ms = device_ms(plain[kind], sets, 3)
        flops = fa.flop_estimate(kind, b, hq, s, s, d)
        nbytes = fa.byte_estimate(kind, b, hq, hkv, s, s, d, 2)
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS["torch.bfloat16"] * 1e3
        bound = max(t_bytes, t_ops)
        by = "bytes" if t_bytes >= t_ops else "operations"
        steady = [m[name] for m in kern_ms[1:]] or [kern_ms[0][name]]
        info = fa.kernel_info(kind, d)
        log(f"[table] {name} bf16 x{n}/step: kernel {ms:.4f} ms (turns "
            f"{kt[0]:.4f}, {kt[1]:.4f}), library {lib_ms:.4f} ms "
            f"(turns {lt[0]:.4f}, {lt[1]:.4f}), plain {plain_ms:.3f} "
            f"ms, bound {bound:.4f} ms ({by}: {flops:.3g} flops, "
            f"{nbytes:.3g} B), {bound / ms:.1%} of bound; "
            f"{info['registers']} registers, {info['local_bytes']} B local, "
            f"{info['smem_bytes']} B shared memory, {info['threads']} "
            f"threads, {info['blocks_per_sm']} blocks per SM; on the flash "
            f"path {sum(steady) / len(steady):.3f} ms per step (events)")
        row = {"name": name, "route": "cuda", "source": SOURCES[name][0],
               "replaces": SOURCES[name][1], "launches": launches[name],
               "max_abs_err": errs[name], "ms": n * ms,
               "path_events_ms": sum(steady) / len(steady),
               "plain_ms": n * plain_ms, "bound_ms": n * bound,
               "bound_by": by, "bound_share": bound / ms,
               "library_ms": n * lib_ms, "registers": info["registers"],
               "local_bytes": info["local_bytes"],
               "smem_bytes": info["smem_bytes"],
               "blocks_per_sm": info["blocks_per_sm"],
               "per": "flash-path step, B=8 S=512 bf16"}
        if kind != "fwd":
            row["library_note"] = ("scaled_dot_product_attention's autograd "
                                   "backward, which forms dQ, dK and dV in "
                                   "one call")
        rows.append(row)
    bwd = per_launch["dq"][0] + per_launch["dkv"][0]
    delta = sum(times["delta"]["kernel"]) / 2
    lib_bwd = [t for k in ("dq", "dkv", "delta")
               for t in times[k]["library"]]
    log(f"[table] per launch: forward {per_launch['fwd'][0]:.4f} ms vs SDPA "
        f"forward {per_launch['fwd'][1]:.4f} ms; dQ + dK/dV {bwd:.4f} ms, "
        f"with Δ (row_delta, {delta:.4f} ms) {bwd + delta:.4f} ms, vs SDPA "
        f"autograd backward (which forms its own Δ) "
        f"{sum(lib_bwd) / len(lib_bwd):.4f} ms ({min(lib_bwd):.4f}–"
        f"{max(lib_bwd):.4f} over its six turns)")
    host = flash_host_us()
    for row in rows:
        row["host_us"] = host[kinds[row["name"]]]
    return rows


def phase_lora(spec, registry, pex, lora_cfg):
    """Phases 23 and 24: the LoRA-fied llama3.2-1b at full width (rank 8,
    α 16, the seven default sites of all 16 layers). Phase 23: in f32 at
    (EXACT_B, EXACT_S), B factors drawn non-zero (std 0.02) so both
    factors have gradients, ``Engine.step([Norms(), Grads()])`` over the
    whole tree against per-example plain backward passes (1e-3) and the
    plain batch backward, the frozen bases' gradients exactly zero, and
    the launches by the priced pick at S = EXACT_S. Phase 24: in bf16, B=8,
    S=512, three steps of phase 5's consumers, each followed by AdamW on
    the adapters: 224 direct_norm launches (the adapters, rank-thin) and
    the head's by the priced pick per norms pass, none in the reweighted
    pass, every launch on the TMA route; the adapters' launches' host µs
    a step."""
    import torch
    from repro_torch.nn import lora as lora_mod

    f32 = dataclasses.replace(spec.full(dtype="float32"), lora=lora_cfg.lora)

    def live_b(params):
        gen = torch.Generator(device="cuda").manual_seed(4)
        for pair in lora_mod.adapter_tree(params).values():
            pair.b.copy_(0.02 * torch.randn(pair.b.shape, generator=gen,
                                            device="cuda"))
        return params

    n = phase_exact(spec, registry, pex, f32, "lora-exact", flashes=(False,),
                    prepare=live_b)
    want = {k: sum(v.values())
            for k, v in main_path_launches(f32, EXACT_S).items()}
    got = {k: n[k] for k in want}
    if got != want or want["direct_norm"] < 14 * f32.n_layers:
        raise AssertionError(f"lora-exact: norm launches {got}, expected "
                             f"{want} (the 224 adapter taps on direct)")
    log(f"[lora-exact] norm launches {got} (the priced pick at S="
        f"{EXACT_S}: every adapter tap on direct)")
    torch.cuda.empty_cache()
    lora_want = main_path_launches(lora_cfg, S)
    if sum(lora_want["direct_norm"].values()) != 14 * lora_cfg.n_layers:
        raise AssertionError(f"lora: the priced pick sends "
                             f"{lora_want['direct_norm']} to direct, not the "
                             f"224 adapter taps")
    kernels = tuple(k for k, v in lora_want.items() if v)
    run = phase_main(spec, registry, pex, lora_cfg, (B, S), "lora",
                     pass_launches(lora_want, lora_cfg), kernels)
    # the adapters' direct launches by shape: device ms against the bound
    # and a cuBLAS bmm of HᵀZ̄, per step
    from repro_torch.kernels import ops
    gen = torch.Generator(device="cuda").manual_seed(6)
    times = norm_times(shapes=sorted(lora_want["direct_norm"]))
    tot = {"ms": 0.0, "bound_ms": 0.0, "bmm_ms": 0.0}
    for (pi, po), n_launch in sorted(lora_want["direct_norm"].items()):
        t_bytes = (2 * B * S * (pi + po) + 4 * B) / PEAK_BYTES_PER_S * 1e3
        t_ops = ops.flop_estimate(B, S, pi, po) / PEAK_FLOPS[
            "torch.bfloat16"] * 1e3
        sets = norm_sets(pi, po, gen)
        bmm = bmm_ms("direct_norm", sets, 20)
        del sets
        ms = times[f"direct_norm {pi}x{po}"]
        log(f"[lora] direct {pi}->{po} x {n_launch} a norms pass: "
            f"{ms:.4f} ms a launch (device_ms), bound "
            f"{max(t_bytes, t_ops):.4f} "
            f"({'bytes' if t_bytes >= t_ops else 'operations'}), cuBLAS bmm "
            f"of HᵀZ̄ {bmm:.4f}")
        tot["ms"] += n_launch * ms
        tot["bound_ms"] += n_launch * max(t_bytes, t_ops)
        tot["bmm_ms"] += n_launch * bmm
    run["direct_by_shape"] = tot
    log(f"[lora] the adapters' direct launches a step, by shape: "
        f"{tot['ms']:.3f} ms against a bound of {tot['bound_ms']:.3f} ms "
        f"({tot['bound_ms'] / tot['ms']:.1%}), cuBLAS bmm {tot['bmm_ms']:.3f}")
    log(f"[lora] launches per norms pass {lora_want}; launcher host µs a "
        f"step {[{k: round(v) for k, v in h.items()} for h in run['host_us']]}"
        f" ({14 * lora_cfg.n_layers} adapter launches on direct); steady "
        f"step ms {run['step_ms'][1:]}, Engine.step stream ms "
        f"{[round(x, 1) for x in run['engine_ms'][1:]]}, AdamW (adapters) "
        f"{[round(x, 2) for x in run['adamw_ms'][1:]]}; norm kernel ms "
        f"{[{k: round(m[k], 3) for k in kernels} for m in run['kern_ms'][1:]]}"
        f"; peak {run['peak_gib']:.2f} GiB")
    return run


# ---------------------------------------------------------------------------
# the other families (phases 27–32)
# ---------------------------------------------------------------------------

def family_cfg(spec, layers, dtype="bfloat16"):
    """``spec``'s published config in ``dtype``, cut to ``layers`` (None:
    full depth)."""
    cfg = spec.full(dtype=dtype)
    return cfg if layers is None else dataclasses.replace(cfg,
                                                          n_layers=layers)


def family_cores(cfg):
    """The spans ``phase_main`` times on a family's path: rwkv6's WKV
    recurrence, zamba2's SSD recurrence and its shared block's unfused
    attention core, seamless's unfused attention cores (encoder, decoder
    self and cross)."""
    from repro_torch.nn import attention as attn_mod
    from repro_torch.nn import rwkv as rwkv_mod
    from repro_torch.nn import ssm as ssm_mod
    return {"rwkv6": {"wkv": (rwkv_mod, "wkv")},
            "zamba2": {"ssd": (ssm_mod, "ssd"),
                       "attention": (attn_mod, "_attend")},
            "seamless": {"attention": (attn_mod, "_attend")}}[family(cfg)]


def phase_family(spec, registry, pex, layers, tag, shapes):
    """Phases 27–32 for one of rwkv6-3b, zamba2-7b and seamless-m4t-medium.
    The exact phase (27, 29, 31): the config in f32 at (EXACT_B, EXACT_S),
    ``phase_exact``'s checks over the arch's pex scope, its gram and direct
    launches those of the priced pick at S = EXACT_S over the tapped
    shapes (zamba2's shared block launches none) and nothing else. The
    path (28, 30, 32): bf16, B=8, S=512, three steps of phase 5's consumers
    under AdamW, each pass's launches asserted (gram and direct by the
    priced pick; none in the reweighted pass; every bf16 launch on TMA),
    the family's cores timed (``family_cores``). ``shapes`` collects the
    exact phase's launch shapes. Returns the path's ``phase_main`` dict
    with its expected launches (``want``)."""
    import torch
    f32 = family_cfg(spec, layers, "float32")
    n = phase_exact(spec, registry, pex, f32, f"{tag}-exact",
                    flashes=(False,), shapes=shapes)
    want = {k: sum(v.values())
            for k, v in main_path_launches(f32, EXACT_S).items()}
    if any(n[k] != want.get(k, 0) for k in n):
        raise AssertionError(f"{tag}-exact: launches {n}, expected {want} "
                             f"and nothing else")
    log(f"[{tag}-exact] norm launches {want} (the priced pick at S="
        f"{EXACT_S} over the tapped shapes; nothing else launched)")
    torch.cuda.empty_cache()
    cfg = family_cfg(spec, layers)
    path_want = main_path_launches(cfg, S)
    kernels = tuple(k for k, v in path_want.items() if v)
    log(f"[{tag}] launches per norms pass by the priced pick: "
        f"{ {k: sum(v.values()) for k, v in path_want.items()} } "
        f"({path_want})")
    run = phase_main(spec, registry, pex, cfg, (B, S), tag,
                     pass_launches(path_want, cfg), kernels,
                     cores=family_cores(cfg))
    run["want"] = path_want
    return run


def family_norm_table(tag, want, dispatch):
    """A family path's gram and direct launches by shape: ``device_ms`` a
    launch (phase 16's reading), launches a norms pass, the bound and a
    cuBLAS ``bmm`` of the kernel's products (a yardstick only). Returns
    the per-kernel totals a step."""
    import torch
    from repro_torch.kernels import ops
    gen = torch.Generator(device="cuda").manual_seed(9)
    out = {}
    for name, by_shape in want.items():
        tot = {"ms": 0.0, "bound_ms": 0.0, "bmm_ms": 0.0, "launches": 0}
        for (pi, po), n in sorted(by_shape.items()):
            ms = dispatch[f"{pi}x{po} B={B} S={S}"]["measured_ms"][
                name.split("_")[0]]
            t_bytes = (2 * B * S * (pi + po) + 4 * B) / PEAK_BYTES_PER_S \
                * 1e3
            t_ops = ops.flop_estimate(B, S, pi, po) / PEAK_FLOPS[
                "torch.bfloat16"] * 1e3
            sets = norm_sets(pi, po, gen)
            bmm = bmm_ms(name, sets, 3 if po > 10 * pi else 20)
            del sets
            torch.cuda.empty_cache()
            bound = max(t_bytes, t_ops)
            log(f"[{tag}] {name} bf16 ({B},{S},{pi})x({B},{S},{po}) x{n} a "
                f"norms pass: {ms:.4f} ms a launch (device_ms), bound "
                f"{bound:.4f} ({'bytes' if t_bytes >= t_ops else 'operations'}"
                f"), {bound / ms:.1%} of bound; cuBLAS bmm {bmm:.4f}")
            tot["ms"] += n * ms
            tot["bound_ms"] += n * bound
            tot["bmm_ms"] += n * bmm
            tot["launches"] += n
        if tot["launches"]:
            out[name] = tot
            log(f"[{tag}] {name} a norms pass, by shape: {tot['ms']:.3f} ms "
                f"over {tot['launches']} launches against a bound of "
                f"{tot['bound_ms']:.3f} ms ({tot['bound_ms'] / tot['ms']:.1%}"
                f"), cuBLAS bmm {tot['bmm_ms']:.3f}")
    return out


# ---------------------------------------------------------------------------
# LoRA tenants (phases 25 and 26)
# ---------------------------------------------------------------------------

TENANT_R = 8                 # adapter rank of the tenant phases
TENANT_ALPHA = 16.0          # α = 2r, as benchmarks/bench_lora_tenants.py
TENANT_C, TENANT_SIGMA, TENANT_LR = 1.0, 0.3, 0.1   # tests/test_lora_tenancy
TENANT_EXACT_S, TENANT_EXACT_D = 64, 256
#: phase 26's cases: (dtype, tenants, examples each — 0: ragged 1 to 4 —,
#: width d = o, S): benchmarks/bench_lora_tenants.py's three in f32, then
#: llama3.2-1b's wq width in bf16
TENANT_CASES = [("float32", 256, 2, 256, 64), ("float32", 1024, 1, 256, 64),
                ("float32", 64, 8, 256, 64), ("bfloat16", 128, 0, 2048, 512)]
#: phase 9's tenant cases: the f32 256 x 2 case and the bf16 one
TENANT_SEG_CASES = (TENANT_CASES[0], TENANT_CASES[-1])
TENANT_REPS = 4              # timed steps of each kind, in turns


def tenant_owner(n_tenants, per, seed):
    """(B,) owning tenant (0..n_tenants-1) of each example, shuffled by
    numpy ``default_rng(seed)``: ``per`` examples each, or with ``per`` 0
    a ragged 1 to 4."""
    import numpy as np
    rs = np.random.default_rng(seed)
    counts = (rs.integers(1, 5, n_tenants) if per == 0
              else np.full(n_tenants, per))
    owner = np.repeat(np.arange(n_tenants), counts)
    rs.shuffle(owner)
    return owner


def tenant_problem(dt, n_examples, d, s, seed):
    """A multi-tenant LoRA problem on the card, as the reference's test and
    benchmark pose it: a frozen base (d, d) of std 0.2, each tenant's pair
    (rank ``TENANT_R``, α ``TENANT_ALPHA``, B of std 0.3) from the
    generator it is given, and (B, S, d) inputs and targets. Returns
    (init_fn, loss over per-example adapters, batch)."""
    import torch
    from repro_torch.nn import lora as lora_mod
    from repro_torch.nn.linear import linear

    gen = torch.Generator(device="cuda").manual_seed(seed)
    base = (0.2 * torch.randn(d, d, generator=gen, device="cuda")).to(dt)
    batch = {k: torch.randn(n_examples, s, d, generator=gen,
                            device="cuda").to(dt) for k in ("x", "y")}

    def init_fn(g):
        return {"site": lora_mod.init_pair(g, d, d, TENANT_R, TENANT_ALPHA,
                                           dtype=dt, device=g.device,
                                           b_std=0.3)}

    def loss(adapters, data, tap):
        z = linear({"w": base, "lora": adapters["site"]}, data["x"],
                   tap=tap)
        tok = torch.sum(torch.square(z.float() - data["y"].float()), dim=-1)
        return torch.sum(tap.token_loss(tok), dim=1), {}

    return init_fn, loss, batch


def within(got, want, rtol, atol):
    """The largest |got − want| − (atol + rtol·|want|): ≤ 0 when every
    element is within the tolerance."""
    return ((got.float() - want.float()).abs()
            - (atol + rtol * want.float().abs())).max().item()


def phase_tenants_exact(pex):
    """Phase 25: ``tests/test_lora_tenancy.py``'s per-tenant oracle on the
    card, in f32 at the reference benchmark's widths (d = o = 256, r = 8,
    S = 64): 110 tenants of ragged 1 to 4 examples (the test's mix, seed
    7). One fused ``TenantService.step`` (Clip, per-tenant Noise, SGD)
    against a loop of single-tenant Engines, each tenant's noise from its
    own derived generator: norms and clip coefficients (rtol 1e-5, atol
    1e-6), each tenant's updated store row (the same), at example
    granularity and at token granularity with an explicit noise scale;
    then each tenant's noise bit for bit against ``add_grad_noise`` on its
    tree alone."""
    import numpy as np
    import torch
    from repro_torch.core import passes
    from repro_torch.kernels import ops
    from repro_torch.kernels import segmented_norm as sn
    from repro_torch.nn.param import fold_seed, tree_leaves, tree_map
    from repro_torch.tenancy import AdapterStore, TenantService, assemble

    rs = np.random.RandomState(7)
    tenants = rs.choice(np.arange(1000, 50_000), size=110, replace=False)
    owner = np.concatenate([np.full(rs.randint(1, 5), t) for t in tenants])
    rs.shuffle(owner)
    init_fn, loss, batch = tenant_problem(
        torch.float32, owner.size, TENANT_EXACT_D, TENANT_EXACT_S, 7)
    tb = assemble(batch, owner)
    c, sigma, lr = TENANT_C, TENANT_SIGMA, TENANT_LR
    rtol, atol = 1e-5, 1e-6
    zero = dict.fromkeys(ops.launch_counts(), 0)
    services = {}
    for gran in ("example", "token"):
        store = AdapterStore(init_fn, capacity=128, seed=7)
        # admitted in the draw's order, so the slots are not the tenant-id
        # order a restore repacks them in
        for t in tenants:
            store.admit(int(t))
        svc = TenantService(store, loss, clip_norm=c, noise_std=sigma,
                            noise_scale=c, lr=lr, granularity=gran)
        services[gran] = svc
        seed = passes.step_seed(torch.Generator(device="cuda").manual_seed(99))
        ops.reset_launch_counts()
        sn.reset_route_counts()
        t0 = time.perf_counter()
        res = svc.step(batch, owner,
                       rng=torch.Generator(device="cuda").manual_seed(99))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        n = ops.launch_counts()
        want_n = ({**zero, "segmented_norm": 2} if gran == "example"
                  else {**zero, "rowsumsq": 4})
        if n != want_n:
            raise AssertionError(f"tenants-exact {gran}: launches {n}, "
                                 f"expected {want_n}")
        if gran == "example":
            segs = sn.route_segments()
            if segs != {"gram": 0, "direct": 2 * owner.size}:
                raise AssertionError(f"tenants-exact: segments by route "
                                     f"{segs}, expected every one of the "
                                     f"2 x {owner.size} on direct")
        oracle = pex.Engine(pex.PexSpec(), granularity=gran)
        worst = dict.fromkeys(("norms", "clip", "rows"), -math.inf)
        for t in tb.unique_tenants:
            at = init_fn(torch.Generator(device="cuda").manual_seed(
                fold_seed(7, int(t))))
            idx = torch.as_tensor(np.flatnonzero(owner == t), device="cuda")
            r_t = oracle.step(
                loss, at, {k: v.index_select(0, idx)
                           for k, v in batch.items()},
                [pex.Clip(c, granularity=gran),
                 pex.Noise(sigma, passes.tenant_generator(seed, int(t),
                                                          "cuda"),
                           scale=c)])
            pos = torch.as_tensor(np.flatnonzero(tb.tenant_ids == t),
                                  device="cuda")
            new = tree_map(lambda a, g: a - lr * g, at, r_t.grads)
            for k, got, want in (
                    ("norms", res.sq_norms.index_select(0, pos),
                     r_t.sq_norms),
                    ("clip", res.clip_coef.index_select(0, pos),
                     r_t.clip_coef)) + tuple(
                        ("rows", g[0], w) for g, w in zip(
                            tree_leaves(store.gather([t])),
                            tree_leaves(new))):
                worst[k] = max(worst[k], within(got, want, rtol, atol))
        log(f"[tenants-exact] {gran}: {len(tenants)} tenants, B="
            f"{owner.size}, S={TENANT_EXACT_S}, {TENANT_EXACT_D}->"
            f"{TENANT_R}->{TENANT_EXACT_D} f32; service step {ms:.1f} ms "
            f"(first call); launches {n}; worst excess over rtol {rtol}, "
            f"atol {atol} (≤ 0 passes): {worst}")
        if not all(v <= 0 for v in worst.values()):
            raise AssertionError(f"tenants-exact {gran}: the fused step "
                                 f"disagrees with the per-tenant oracle: "
                                 f"{worst}")
    # each tenant's noise, bit for bit against its tree alone
    gen = torch.Generator(device="cuda").manual_seed(3)
    tree = {k: torch.randn(len(tenants), *shape, generator=gen,
                           device="cuda")
            for k, shape in (("a", (TENANT_EXACT_D, TENANT_R)),
                             ("b", (TENANT_R, TENANT_EXACT_D)))}
    segs = torch.as_tensor(tb.unique_tenants, device="cuda")
    noised = passes.add_grad_noise_segmented(
        tree_map(torch.clone, tree), sigma, c,
        torch.Generator(device="cuda").manual_seed(5), segs)
    seed = passes.step_seed(torch.Generator(device="cuda").manual_seed(5))
    for i, t in enumerate(tb.unique_tenants):
        alone = passes.add_grad_noise(
            {k: v[i].clone() for k, v in tree.items()}, sigma, c,
            passes.tenant_generator(seed, int(t), "cuda"))
        if not all(torch.equal(noised[k][i], alone[k]) for k in tree):
            raise AssertionError(f"tenant {t}'s segmented noise is not the "
                                 f"bits of add_grad_noise on its tree alone")
    log(f"[tenants-exact] per-tenant noise of {len(tenants)} tenants bit for "
        f"bit add_grad_noise on each tenant's tree alone")
    tenant_round_trip(services["example"], init_fn, batch, owner)


def tenant_round_trip(svc, init_fn, batch, owner):
    """Phase 25's checkpoint round trip: ``svc`` (trained one step) saves
    through a ``CheckpointManager``; a fresh store restores it, its tenants
    repacked into slots [0..n) in id order (not the slots they held); every
    tenant's rows bit for bit their saved value; then one more fused step
    (seed 100) on each service: the losses, norms and every tenant's
    updated rows bit for bit equal."""
    import shutil
    import tempfile

    import torch
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.nn.param import tree_leaves
    from repro_torch.tenancy import AdapterStore, TenantService

    store = svc.store
    tenants = [int(t) for t in store.tenants]
    moved = sum(int(store.slot_of(t)) != i for i, t in enumerate(tenants))
    tmp = tempfile.mkdtemp(prefix="tenants_ckpt_")
    try:
        svc.ckpt_manager = CheckpointManager(tmp)
        svc.save(step=1)
        saved = {t: [x.clone() for x in tree_leaves(store.gather([t]))]
                 for t in tenants}
        fresh = AdapterStore(init_fn, capacity=store.capacity,
                             seed=store.seed)
        twin = TenantService(fresh, svc.loss_fn, clip_norm=svc.clip_norm,
                             noise_std=svc.noise_std,
                             noise_scale=svc.noise_scale, lr=svc.lr,
                             ckpt_manager=CheckpointManager(tmp))
        if twin.restore() != tenants:
            raise AssertionError("tenants-exact: the restore returned other "
                                 "tenants")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    bad = [t for t in tenants if not all(torch.equal(a, b) for a, b in zip(
        tree_leaves(fresh.gather([t])), saved[t]))]
    if bad or [fresh.slot_of(t) for t in tenants] != list(range(len(tenants))):
        raise AssertionError(f"tenants-exact: {len(bad)} tenants' rows "
                             f"differ after the restore: {bad[:8]}")
    got, want = (s.step(batch, owner, rng=torch.Generator(
        device="cuda").manual_seed(100)) for s in (twin, svc))
    same = torch.equal(got.loss_vec, want.loss_vec) and torch.equal(
        got.sq_norms, want.sq_norms) and all(
        torch.equal(a, b) for t in tenants for a, b in zip(
            tree_leaves(fresh.gather([t])), tree_leaves(store.gather([t]))))
    log(f"[tenants-exact] save/restore round trip: {len(tenants)} tenants, "
        f"{moved} of them in another slot than the restore's; every row bit "
        f"for bit after the restore; the next fused step bit for bit the "
        f"step without the round trip: {same}")
    if not same:
        raise AssertionError("tenants-exact: the step after the restore is "
                             "not the step without the round trip")


def tenant_seg_times(reps=10):
    """Device time of one segmented launch (ms) at each factor tap of phase
    26's cases (example-id segments of S rows: d → r and r → d), with
    ``device_ms`` (card held busy, input copies past the L2). It uses only
    the wrapper's public signature, so a copy of this file placed in an
    older checkout times that checkout's kernel on the same ids, in turns:
    ``python3 -c "import chip_smoke; chip_smoke.tenant_seg_times()"``."""
    import torch
    from repro_torch.kernels import ops

    gen = torch.Generator(device="cuda").manual_seed(8)
    out = {}
    for dtn, n_ten, per, d, s in TENANT_CASES:
        dt = getattr(torch, dtn)
        n = tenant_owner(n_ten, per, 0).size
        seg = torch.arange(n, device="cuda").repeat_interleave(s)
        for pi, po in ((d, TENANT_R), (TENANT_R, d)):
            sets = []
            while sum((h.numel() + z.numel()) * h.element_size()
                      for h, z in sets) < 2 * L2_BYTES:
                sets.append(tuple(torch.randn(n * s, p, generator=gen,
                                              device="cuda").to(dt)
                                  for p in (pi, po)))
            out[f"{dtn} {n_ten}x{per or 'ragged'} {pi}->{po}"] = device_ms(
                lambda x: ops.segmented_norm(x[0], x[1], seg, n), sets, reps)
            del sets
            torch.cuda.empty_cache()
    log(f"[tenant-seg-times] device ms a launch: {json.dumps(out)}")
    return out


def plain_times(reps=3):
    """The plain PyTorch versions' ms where the kernel table's rows of PRs
    22–23 had none: ``gram_norm_ref`` and ``direct_norm_ref`` at every
    bf16 launch shape of the LoRA, rwkv6, zamba2 and seamless paths (B=8,
    S=512, the priced pick's kernel, ms a launch × launches a norms
    pass), and ``segmented_norm_ref`` at each factor tap of phase 26's
    ``TENANT_SEG_CASES`` (ms a launch). Events around ``reps`` calls after
    a warm-up (``time_ms``). Not in a whole run: ``python3 -c "import
    chip_smoke; chip_smoke.plain_times()"``."""
    import torch
    from repro_torch.kernels.direct_norm import direct_norm_ref
    from repro_torch.kernels.ref import gram_norm_ref
    from repro_torch.kernels.segmented_norm import segmented_norm_ref
    from repro_torch.models import registry
    from repro_torch.nn.lora import LoraCfg

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(2)
    refs = {"gram_norm": gram_norm_ref, "direct_norm": direct_norm_ref}
    llama = registry.get("llama3.2-1b").full()
    paths = [("lora", dataclasses.replace(
        llama, lora=LoraCfg(rank=TENANT_R, alpha=TENANT_ALPHA)))]
    paths += [(tag, family_cfg(registry.get(a), n))
              for a, n, tag in FAMILY_PATHS]
    out = {}
    for tag, cfg in paths:
        for name, shapes in main_path_launches(cfg, S).items():
            if not shapes:
                continue
            tot = 0.0
            for (pi, po), n in sorted(shapes.items()):
                h, z = norm_sets(pi, po, gen)[0]
                ms = time_ms(lambda: refs[name](h, z), reps)
                log(f"[plain-times] {tag} {name} bf16 ({B},{S},{pi})x"
                    f"({B},{S},{po}) x{n} a norms pass: plain {ms:.4f} ms "
                    f"a launch")
                tot += n * ms
                del h, z
                torch.cuda.empty_cache()
            out[f"{tag} {name}"] = tot
            log(f"[plain-times] {tag} {name}: plain {tot:.3f} ms a norms "
                f"pass")
    for dtn, n_ten, per, d, s in TENANT_SEG_CASES:
        dt = getattr(torch, dtn)
        n = tenant_owner(n_ten, per, 0).size
        seg = torch.arange(n, device="cuda").repeat_interleave(s)
        for pi, po in ((d, TENANT_R), (TENANT_R, d)):
            h, z = (torch.randn(n * s, p, generator=gen, device="cuda").to(dt)
                    for p in (pi, po))
            key = f"tenants {dtn} {n_ten}x{per or 'ragged'} {pi}->{po}"
            out[key] = time_ms(lambda: segmented_norm_ref(h, z, seg, n), reps)
            log(f"[plain-times] {key}: segmented plain {out[key]:.4f} ms a "
                f"launch")
    log(f"[plain-times] {json.dumps(out)}")
    return out


def seg_bits(out_path):
    """The segmented launcher's outputs on seeded inputs — phase 26's
    example-id segments in both types, and mixed lengths on both routes,
    one long segment, ragged widths and dropped rows — saved with
    ``torch.save`` to ``out_path``. It uses only the wrapper's public
    signature, so a copy of this file in an older checkout saves that
    checkout's outputs, to be compared bit for bit with ``torch.equal``:
    ``python3 -c "import chip_smoke; chip_smoke.seg_bits('x.pt')"``."""
    import torch
    from repro_torch.kernels import ops

    gen = torch.Generator(device="cuda").manual_seed(11)
    cases = []
    for dt in (torch.float32, torch.bfloat16):
        for dtn, n_ten, per, d, s in TENANT_SEG_CASES:
            n = tenant_owner(n_ten, per, 0).size
            seg = torch.arange(n, device="cuda").repeat_interleave(s)
            cases += [(dt, n * s, pi, po, seg, n)
                      for pi, po in ((d, TENANT_R), (TENANT_R, d))]
        for t, pi, po, n in ((3750, 512, 384, 14), (3000, 512, 384, 1),
                             (777, 256, 333, 20), (6000, 4096, 6400, 64)):
            seg = torch.randint(0, n + 2, (t,), generator=gen,
                                device="cuda")
            cases.append((dt, t, pi, po, seg, n))
    out = []
    for dt, t, pi, po, seg, n in cases:
        h, z = (torch.randn(t, p, generator=gen, device="cuda").to(dt)
                for p in (pi, po))
        out.append(ops.segmented_norm(h, z, seg, n).cpu())
    torch.save(out, out_path)
    log(f"[seg-bits] {len(out)} launches' outputs saved to {out_path}")


def phase_tenants(pex):
    """Phase 26: the fused DP step (norms, Clip(1.0), per-tenant
    Noise(0.2), SGD) against the plain multi-tenant LoRA step through an
    inert tap (one backward, SGD), as ``bench_lora_tenants.step_pair``
    times them, at each ``TENANT_CASES`` case, in turns. For each: both
    steps' host ms, the overhead beside DESIGN.md §14's ≤ 10% target
    (reported, not asserted), the segmented launches by route (every
    non-empty segment on direct, asserted), each launch's device ms
    (``tenant_seg_times``) against its bound and a cuBLAS ``bmm`` of
    H_jᵀZ̄_j over the segments, and the per-tenant noise add's ms
    (events)."""
    import torch
    from repro_torch.core import plan as plan_mod
    from repro_torch.kernels import ops
    from repro_torch.kernels import segmented_norm as sn
    from repro_torch.nn.param import tree_flatten, tree_map, tree_unflatten
    from repro_torch.tenancy import AdapterStore, assemble

    seg_ms = tenant_seg_times()
    eng = pex.Engine(pex.PexSpec())
    out = {}
    for dtn, n_ten, per, d, s in TENANT_CASES:
        dt = getattr(torch, dtn)
        tag = f"{dtn} {n_ten}x{per or 'ragged'}"
        owner = tenant_owner(n_ten, per, 0)
        init_fn, loss, batch = tenant_problem(dt, owner.size, d, s, 0)
        tb = assemble(batch, owner)
        store = AdapterStore(init_fn, capacity=n_ten, seed=0)
        for t in range(n_ten):
            store.admit(t)
        active = store.gather(tb.unique_tenants)
        leaves, treedef = tree_flatten(active)

        def closure(adapters, eb, tap):
            idx = eb["tenant_index"]
            return loss(tree_map(lambda v: v.index_select(0, idx), adapters),
                        eb, tap)

        gen = torch.Generator(device="cuda").manual_seed(9)
        cons = [pex.Clip(1.0), pex.Noise(0.2, gen, scale=1.0,
                                         segments=tb.segments())]

        def fused():
            res = eng.step(closure, active, tb.batch, cons)
            return tree_map(lambda a, g: a - TENANT_LR * g.to(a.dtype),
                            active, res.grads)

        def plain():
            ls = [x.detach().requires_grad_() for x in leaves]
            lv, _ = closure(tree_unflatten(treedef, ls), tb.batch, pex.NULL)
            gs = torch.autograd.grad(lv.sum(), ls)
            return [a - TENANT_LR * g.to(a.dtype) for a, g in zip(leaves, gs)]

        # one observed fused step: the segmented launches (inputs, events)
        # and the noise add (events)
        calls, seg_ev, noise_ev = [], [], []
        orig_seg, orig_noise = sn.segmented_norm, \
            plan_mod.add_grad_noise_segmented

        def seg_wrap(h, z, seg, n):
            calls.append((h, z, seg, n))
            e = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            e[0].record()
            r = orig_seg(h, z, seg, n)
            e[1].record()
            seg_ev.append(e)
            return r

        def noise_wrap(*a, **kw):
            e = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            e[0].record()
            r = orig_noise(*a, **kw)
            e[1].record()
            noise_ev.append(e)
            return r

        fused()
        plain()
        torch.cuda.synchronize()
        sn.segmented_norm = seg_wrap
        plan_mod.add_grad_noise_segmented = noise_wrap
        try:
            ops.reset_launch_counts()
            sn.reset_route_counts()
            fused()
            torch.cuda.synchronize()
        finally:
            sn.segmented_norm = orig_seg
            plan_mod.add_grad_noise_segmented = orig_noise
        n = ops.launch_counts()
        segs = sn.route_segments()
        if n["segmented_norm"] != 2 or segs != {"gram": 0,
                                                "direct": 2 * owner.size}:
            raise AssertionError(f"tenants {tag}: segmented launches "
                                 f"{n['segmented_norm']}, segments by route "
                                 f"{segs}; expected 2 launches and every "
                                 f"one of the 2 x {owner.size} segments on "
                                 f"direct")
        path_seg_ms = [a.elapsed_time(b) for a, b in seg_ev]
        noise_ms = sum(a.elapsed_time(b) for a, b in noise_ev)
        # time the two steps in turns
        times = {"fused": [], "plain": []}
        for kind in ("fused", "plain", "plain", "fused") * (TENANT_REPS // 2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            (fused if kind == "fused" else plain)()
            torch.cuda.synchronize()
            times[kind].append((time.perf_counter() - t0) * 1e3)
        mean = {k: sum(v) / len(v) for k, v in times.items()}
        over = (mean["fused"] - mean["plain"]) / mean["plain"]
        # each launch against its bound and a bmm of H_jᵀZ̄_j
        rows = []
        for (h, z, seg, n_seg), ev_ms in zip(calls, path_seg_ms):
            pi, po = h.shape[1], z.shape[1]
            bound, by, _ = seg_bound_ms([(seg, n_seg, h.shape[0], pi, po,
                                          h.dtype)])
            sets = [(h, z)]
            while sum((x.numel() + y.numel()) * x.element_size()
                      for x, y in sets) < 2 * L2_BYTES:
                sets.append((h.clone(), z.clone()))
            bmm = device_ms(lambda x: torch.bmm(
                x[0].view(n_seg, s, pi).transpose(1, 2),
                x[1].view(n_seg, s, po)), sets, 10)
            del sets
            ms = seg_ms[f"{tag} {pi}->{po}"]
            rows.append({"shape": f"{pi}->{po}", "ms": ms, "path_ms": ev_ms,
                         "bound_ms": bound, "bound_by": by, "bmm_ms": bmm})
        del calls
        out[tag] = {"fused_ms": times["fused"], "plain_ms": times["plain"],
                    "overhead": over, "noise_ms": noise_ms,
                    "segmented": rows, "segments": segs}
        log(f"[tenants] {tag}: B={owner.size} S={s} {d}->{TENANT_R}->{d}; "
            f"fused DP step ms {[round(x, 2) for x in times['fused']]}"
            f", plain step ms {[round(x, 2) for x in times['plain']]}: "
            f"overhead {over:+.1%} (DESIGN.md §14's target ≤ +10%, "
            f"reported); per-tenant noise add {noise_ms:.3f} ms (events); "
            f"segments by route {segs}; segmented a launch: "
            + "; ".join(f"{r['shape']} {r['ms']:.4f} ms (path "
                        f"{r['path_ms']:.4f}), bound {r['bound_ms']:.4f} "
                        f"({r['bound_by']}, {r['bound_ms'] / r['ms']:.1%}), "
                        f"bmm {r['bmm_ms']:.4f}" for r in rows))
        del active, store, tb, batch, leaves
        torch.cuda.empty_cache()
    return out


def phase_token_exact(spec, registry, pex):
    """llama3.2-1b at full width in f32, token granularity: the engine's
    (B, S) map against per-token stats summed in plain f32 from a recorded
    plain forward and backward (``RecordingTap``), and the token-clipped
    gradient against the plain backward of Σ c_{j,t}·ℓ_{j,t} with c held
    fixed."""
    import torch
    from repro_torch.configs.common import ShapeSpec
    from repro_torch.kernels import ops
    from repro_torch.nn.param import tree_flatten, tree_unflatten

    cfg = spec.full(dtype="float32")
    params = registry.family_module(spec).init(
        cfg, torch.Generator(device="cuda").manual_seed(0))
    batch = registry.make_train_batch(
        spec, cfg, ShapeSpec("token-exact", "train", EXACT_S, EXACT_B),
        rng_seed=0)
    loss_fn = registry.make_loss_fn_v2(spec, cfg)
    eng = pex.Engine(pex.PexSpec(), granularity="token")
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = eng.step(loss_fn, params, batch, [pex.Norms()])
    torch.cuda.synchronize()
    n = ops.launch_counts()
    log(f"[token-exact] Engine(granularity='token').step([Norms]) f32 "
        f"B={EXACT_B} S={EXACT_S}: {(time.perf_counter() - t0) * 1e3:.1f} ms "
        f"(first call); launches {n}")
    if n != token_pass_launches(cfg)[1]:
        raise AssertionError(f"token-exact: launches {n}, expected "
                             f"{token_pass_launches(cfg)[1]}")

    leaves, treedef = tree_flatten(params)
    leaves = [x.detach().requires_grad_() for x in leaves]
    rec = RecordingTap(pex.PexSpec())
    lv, _ = loss_fn(tree_unflatten(treedef, leaves), batch, rec)
    torch.autograd.grad(lv.sum(), leaves, retain_graph=True)
    want = rec.token_stats()
    r = rel_err(res.sq_norms, want)
    log(f"[token-exact] (B, S) map vs per-token stats of a recorded plain "
        f"backward ({len(rec.ops)} ops): max rel err {r:.2e} (tol "
        f"{TOKEN_TOL}: f32, summation order); map mean "
        f"{want.mean().item():.4g}, min {want.min().item():.4g}, max "
        f"{want.max().item():.4g}")
    if not r <= TOKEN_TOL:
        raise AssertionError(f"token map disagrees with the plain per-token "
                             f"stats: {r}")

    clip = float(torch.sqrt(want).median())
    res = eng.step(loss_fn, params, batch,
                   [pex.Clip(clip, granularity="token"), pex.Grads()])
    c = res.clip_coef
    gs = torch.autograd.grad(torch.sum(c.detach() * rec.token_map), leaves)
    worst = 0.0
    for g_eng, g in zip(tree_flatten(res.grads)[0], gs):
        worst = max(worst, ((g_eng - g).norm() / g.norm()).item())
    log(f"[token-exact] Clip({clip:.4g}, token) + Grads: "
        f"{(c < 1).float().mean().item():.1%} of tokens clipped; grads vs "
        f"the plain backward of Σ c·ℓ with c fixed: max rel (Frobenius) err "
        f"over {len(gs)} leaves {worst:.2e} (tol {TOKEN_TOL}: f32)")
    if not worst <= TOKEN_TOL:
        raise AssertionError(f"token-clipped gradients disagree: {worst}")


def phase_moe_token(spec, registry, pex, cfg):
    """One phi3.5-moe token-clipping step at the moe phase's shapes, with two
    checks that every kept capacity slot's stat lands at its token: in the
    forward, the kept rows of each gate/up expert buffer equal the MoE
    input's rows at the positions the slot → token table names; in the
    norms backward, what each expert tap adds to the (B, S) map equals its
    per-slot ‖x‖²·‖z̄‖², summed in plain f32 and added at those positions,
    and is exactly 0 at every token that no kept slot names."""
    import torch
    from repro_torch.core import taps as taps_mod
    from repro_torch.models import transformer

    moe_in = []
    seen = {"rows": 0, "gathers": 0, "scatters": 0, "worst": 0.0}
    orig_moe = transformer.moe
    orig_tap = taps_mod.Tap.dense_expert_grouped
    orig_add = taps_mod.TokenLayout.add_expert_grouped

    def kept(tok, bg, s):
        tg = bg * s
        valid = (tok >= 0) & (tok < tg)
        glob = torch.arange(tok.shape[0], device=tok.device)[:, None, None] \
            * tg + tok
        return valid, glob

    def moe_rec(p, x, **kw):
        moe_in.append(x.detach())
        return orig_moe(p, x, **kw)

    def tap_rec(self, x, w, seg, bg, tok=None, **kw):
        xin = moe_in[-1]
        if x.shape[-1] == xin.shape[-1]:           # gate / up: the buffer
            valid, glob = kept(tok, bg, xin.shape[1])
            rows = xin.reshape(-1, xin.shape[-1])[glob[valid]]
            if not torch.equal(x[valid], rows):
                raise AssertionError("moe-token: a kept slot's row is not "
                                     "its token's MoE input row")
            seen["rows"] += int(valid.sum())
            seen["gathers"] += 1
        return orig_tap(self, x, w, seg, bg, tok, **kw)

    def add_rec(self, acc_bar, x, zbar, seg, group, bg, use_kernels, *,
                tok):
        out = orig_add(self, acc_bar, x, zbar, seg, group, bg, use_kernels,
                       tok=tok)
        b, s = acc_bar.shape
        valid, glob = kept(tok, bg, s)
        stat = (torch.sum(torch.square(x.float()), dim=-1)
                * torch.sum(torch.square(zbar.float()), dim=-1))
        want = torch.zeros(b * s, device=x.device).index_add_(
            0, glob[valid], stat[valid]).reshape(b, s)
        hit = torch.zeros(b * s, dtype=torch.bool, device=x.device)
        hit[glob[valid]] = True
        hit = hit.reshape(b, s)
        delta = out - acc_bar
        if bool((delta[~hit] != 0).any()):
            raise AssertionError("moe-token: a stat landed at a token that "
                                 "no kept slot names")
        # |out - acc_bar| carries the rounding of the sum: half an ulp of out
        err = ((delta - want).abs() - 2.0 ** -23 * out.abs())[hit] \
            / want[hit]
        seen["worst"] = max(seen["worst"], float(err.max()))
        seen["scatters"] += 1
        return out

    transformer.moe = moe_rec
    taps_mod.Tap.dense_expert_grouped = tap_rec
    taps_mod.TokenLayout.add_expert_grouped = add_rec
    try:
        run = phase_main(spec, registry, pex, cfg, (MOE_B, MOE_S),
                         "moe-token", token_pass_launches(cfg), ("rowsumsq",),
                         token=True, steps=1)
    finally:
        transformer.moe = orig_moe
        taps_mod.Tap.dense_expert_grouped = orig_tap
        taps_mod.TokenLayout.add_expert_grouped = orig_add
    log(f"[moe-token] {seen['gathers']} gate/up buffers: {seen['rows']} kept "
        f"slots hold their token's row; {seen['scatters']} expert-tap "
        f"scatters: each adds its slots' stats at their tokens only, max "
        f"rel err {seen['worst']:.2e} against plain f32 sums (tol "
        f"{ROW_TOL})")
    if seen["scatters"] != 3 * cfg.n_layers or not seen["worst"] <= ROW_TOL:
        raise AssertionError(f"moe-token: {seen}")
    return run


def phase_onepass():
    """Paper §6 one-pass clipping on the card in f32 against per-example
    gradients from a loop of single-example backward passes (one loop for
    the norms, which set C at their median, one for Σ_j c_j g_j): the MLP
    form at B=256 (4096→4096→4096) and the sequence form at B=8, S=512 with
    llama3.2-1b's MLP widths (2048→8192→2048), each run twice (the second
    run's ``clip_scale`` launches are timed with CUDA events). One
    ``clip_scale`` launch per tapped layer; the MLP form's norms from two
    ``rowsumsq`` launches per layer, the sequence form's from the
    gram/direct route."""
    import torch
    from repro_torch.core import clipping
    from repro_torch.kernels import clip_scale as cs
    from repro_torch.kernels import ops
    from repro_torch.kernels import rowsumsq as rs

    gen = torch.Generator(device="cuda").manual_seed(7)
    run = {"scale_calls": [], "row_calls": [], "ms": 0.0, "launches": 0}
    # scale_calls / row_calls: (shape, dtype) of each launch, both runs
    orig = {"cs": cs.clip_scale, "rs": rs.rowsumsq}
    events = []

    def scale_timed(z, c):
        run["scale_calls"].append((tuple(z.shape), z.dtype))
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = orig["cs"](z, c)
        e1.record()
        events.append((e0, e1))
        return out

    def rows_rec(x):
        run["row_calls"].append((tuple(x.shape), x.dtype))
        return orig["rs"](x)

    forms = (("mlp", (ONEPASS_B,), (ONEPASS_D,) * 3,
              clipping.onepass_clipped_weight_grads),
             ("seq", (B, S), (2048, 8192, 2048),
              clipping.onepass_clipped_weight_grads_seq))
    cs.clip_scale, rs.rowsumsq = scale_timed, rows_rec
    try:
        for name, lead, (d0, d1, d2), fn in forms:
            params = {"w1": torch.randn(d0, d1, generator=gen, device="cuda")
                      * d0 ** -0.5,
                      "w2": torch.randn(d1, d2, generator=gen, device="cuda")
                      * d1 ** -0.5}
            batch = {"x": torch.randn(*lead, d0, generator=gen,
                                      device="cuda"),
                     "y": torch.randn(*lead, d2, generator=gen,
                                      device="cuda")}
            shapes = {"w1": lead + (d1,), "w2": lead + (d2,)}

            def forward(p, tp, bt):
                h1 = torch.tanh(bt["x"] @ p["w1"] + tp["w1"])
                z2 = h1 @ p["w2"] + tp["w2"]
                lv = torch.sum(torch.square(z2 - bt["y"])
                               .reshape(bt["x"].shape[0], -1), dim=-1)
                return lv, {"w1": bt["x"], "w2": h1}

            w = {k: v.detach().requires_grad_() for k, v in params.items()}
            one = {k: torch.zeros((1,) + s_[1:], device="cuda")
                   for k, s_ in shapes.items()}

            def example_grads(j):
                ex = {k: v[j:j + 1] for k, v in batch.items()}
                return torch.autograd.grad(forward(w, one, ex)[0][0],
                                           [w["w1"], w["w2"]])

            oracle = torch.stack([sum(torch.sum(g * g)
                                      for g in example_grads(j))
                                  for j in range(lead[0])])
            clip = float(torch.sqrt(oracle).median())
            ms = []
            for _ in range(2):           # the second run is the timed one
                ops.reset_launch_counts()
                events.clear()
                t0 = time.perf_counter()
                _, sq, wbar = fn(forward, params, batch, shapes, clip)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                n = ops.launch_counts()
                run["launches"] += n["clip_scale"]
            run["ms"] += sum(a.elapsed_time(b) for a, b in events)
            c = torch.clamp(clip / (torch.sqrt(oracle) + 1e-6), max=1.0)
            want = {"w1": 0.0, "w2": 0.0}
            for j in range(lead[0]):
                g1, g2 = example_grads(j)
                want["w1"] = want["w1"] + c[j] * g1
                want["w2"] = want["w2"] + c[j] * g2
            r = rel_err(sq, oracle)
            worst = max(((wbar[k] - want[k]).norm() / want[k].norm()).item()
                        for k in want)
            log(f"[onepass] {name} form, lead {lead}, widths {d0}->{d1}->"
                f"{d2}, f32: {ms[0]:.1f} ms first run, {ms[1]:.1f} ms second "
                f"(host clock); launches per run {n}; clip_scale "
                f"{sum(a.elapsed_time(b) for a, b in events):.4f} ms in the "
                f"second run (events); "
                f"C={clip:.4g}, {(c < 1).float().mean().item():.1%} of "
                f"examples clipped; norms vs the per-example loop max rel "
                f"err {r:.2e}, clipped grads max rel (Frobenius) err "
                f"{worst:.2e} (tol {TOKEN_TOL}: f32)")
            want_n = {"clip_scale": 2, "rowsumsq": 4 if name == "mlp" else 0}
            routes = n["gram_norm"] + n["direct_norm"]
            if (any(n[k] != v for k, v in want_n.items())
                    or routes != (0 if name == "mlp" else 2)):
                raise AssertionError(f"onepass {name}: launches {n}")
            if not (r <= TOKEN_TOL and worst <= TOKEN_TOL):
                raise AssertionError(f"onepass {name} disagrees with the "
                                     f"per-example loop: {r}, {worst}")
            del params, batch, w, wbar, want
    finally:
        cs.clip_scale, rs.rowsumsq = orig["cs"], orig["rs"]
    return run


def phase_row_kernels(row_shapes, scale_shapes, errs):
    """``rowsumsq`` and ``clip_scale`` against their plain versions in f32
    and bf16 at every distinct shape their kernels took on the token and
    one-pass paths and at edge cases (a ragged width, a non-contiguous
    (B, S) view, an unaligned row start, a single row); each case twice,
    for bitwise-equal results. ``clip_scale``'s c holds 0, 1 and values
    below 1, and its result must equal the plain version exactly."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import clip_scale_ref, rowsumsq_ref

    gen = torch.Generator(device="cuda").manual_seed(8)

    def draw(shape, dt):
        return torch.randn(*shape, generator=gen, device="cuda").to(dt)

    edges = [("ragged width", lambda dt: draw((3, 37, 77), dt)),
             ("(B, S) view", lambda dt: draw((4, 2, 40, 72), dt)[:, 1]),
             ("unaligned rows", lambda dt: draw((4, 40, 70), dt)[..., 3:]),
             ("single row", lambda dt: draw((1, 1, 1000), dt))]
    for dt in (torch.float32, torch.bfloat16):
        cases = [(f"path {sh}", lambda dt, sh=sh: draw(sh, dt))
                 for sh in sorted(row_shapes)] + edges
        for name, make in cases:
            x = make(dt)
            got, again = ops.rowsumsq(x, 2), ops.rowsumsq(x, 2)
            want = rowsumsq_ref(x)
            torch.cuda.synchronize()
            r = rel_err(got, want)
            if not (r <= ROW_TOL and torch.equal(got, again)):
                raise AssertionError(f"rowsumsq at {name} {dt}: rel err {r} "
                                     f"> {ROW_TOL} or not bitwise repeatable")
            if dt == torch.bfloat16 and name.startswith("path"):
                errs["rowsumsq"] = max(errs.get("rowsumsq", 0.0),
                                       (got - want).abs().max().item())
            log(f"[rows] rowsumsq {str(dt)[6:]} {name} {tuple(x.shape)}: rel "
                f"{r:.2e} (tol {ROW_TOL}); bitwise equal on a second run")
            del x, got, again, want
        cases = [(f"path {sh}", lambda dt, sh=sh: draw(sh, dt))
                 for sh in sorted(scale_shapes)] + edges
        for name, make in cases:
            z = make(dt)
            c = torch.rand(z.shape[0], generator=gen, device="cuda")
            c[0] = 0.0
            c[-1] = 1.0
            got, again = ops.clip_scale(z, c), ops.clip_scale(z, c)
            want = clip_scale_ref(z, c)
            torch.cuda.synchronize()
            if not (torch.equal(got, want) and torch.equal(got, again)):
                raise AssertionError(
                    f"clip_scale at {name} {dt}: max abs err "
                    f"{(got.float() - want.float()).abs().max().item()} "
                    f"(must be 0) or not bitwise repeatable")
            if name.startswith("path"):
                errs["clip_scale"] = max(
                    errs.get("clip_scale", 0.0),
                    (got.float() - want.float()).abs().max().item())
            log(f"[rows] clip_scale {str(dt)[6:]} {name} {tuple(z.shape)}: "
                f"equal to the plain version; bitwise equal on a second run")
            del z, got, again, want


def row_table(errs, token_run, onepass):
    """The ``rowsumsq`` row (per token-path step) and the ``clip_scale``
    row (per one-pass run, both forms): at the path's calls (shapes and
    counts of the last step or run) the kernel's, the plain version's and
    the library call's time (the library call timed only, never called by
    the port), each on the device with the host's launch overhead hidden
    and the inputs read from device memory, not the L2 cache
    (``device_ms``), and the bound. These kernels take 3–90 µs, less than
    the host needs to issue one, so the CUDA events around them on the
    path (``path_events_ms``, logged too) also time the card waiting for
    the host; ``ms`` is the device time. Both functions do f32 arithmetic on every element:
    operations are priced at the f32 rate outside the tensor cores."""
    import torch
    from repro_torch.kernels import clip_scale as cs
    from repro_torch.kernels import ops
    from repro_torch.kernels import rowsumsq as rs
    from repro_torch.kernels.ref import clip_scale_ref, rowsumsq_ref

    gen = torch.Generator(device="cuda").manual_seed(9)

    def bound(nbytes, flops):
        t_b = nbytes / PEAK_BYTES_PER_S * 1e3
        t_o = flops / PEAK_FLOPS["torch.float32"] * 1e3
        return max(t_b, t_o), "bytes" if t_b >= t_o else "operations"

    def count(calls):
        out = {}
        for c in calls:
            out[c] = out.get(c, 0) + 1
        return sorted(out.items(), key=str)

    rows = []
    for name, calls, runs, launches, ms, per in (
            ("rowsumsq", token_run["row_calls"][-1], 1,
             token_run["launches"]["rowsumsq"],
             [m["rowsumsq"] for m in token_run["kern_ms"][1:]]
             or [token_run["kern_ms"][0]["rowsumsq"]],
             f"token-path step, B={B} S={S} bf16"),
            ("clip_scale", onepass["scale_calls"], 2, onepass["launches"],
             [onepass["ms"]], f"one-pass run (MLP form B={ONEPASS_B} and "
                              f"sequence form B={B} S={S}), f32")):
        tot = {"kern": 0.0, "plain": 0.0, "lib": 0.0, "bound": 0.0}
        by = {}
        for (shape, dt), n in count(calls):
            n //= runs
            nbytes = dt.itemsize
            for d in shape:
                nbytes *= d
            xs = [torch.randn(*shape, generator=gen, device="cuda").to(dt)
                  for _ in range(min(20, -(-2 * L2_BYTES // nbytes)))]
            x = xs[0]
            if name == "rowsumsq":
                kern = lambda x: ops.rowsumsq(x, 2)  # noqa: E731
                plain = rowsumsq_ref
                lib = lambda x: torch.linalg.vector_norm(  # noqa: E731
                    x, dim=-1, dtype=torch.float32).square()
                nr, nc = shape[0] * shape[1], shape[2]
                t, key = bound(rs.bytes_estimate(nr, nc, x.element_size()),
                               rs.flop_estimate(nr, nc))
            else:
                c = torch.rand(shape[0], generator=gen, device="cuda")
                kern = lambda x: ops.clip_scale(x, c)  # noqa: E731
                plain = lambda x: clip_scale_ref(x, c)  # noqa: E731
                lib = lambda x: torch.mul(x, c.view(-1, 1, 1))  # noqa: E731
                t, key = bound(cs.bytes_estimate(x.numel(), shape[0],
                                                 x.element_size()),
                               cs.flop_estimate(x.numel()))
            k_ms, p_ms, l_ms = (device_ms(kern, xs, 20),
                                device_ms(plain, xs, 5),
                                device_ms(lib, xs, 20))
            log(f"[table] {name} {str(dt)[6:]} {shape} x{n}/{per}: kernel "
                f"{k_ms:.4f} ms, plain {p_ms:.4f} ms, library {l_ms:.4f} ms, "
                f"bound {t:.4f} ms ({key}), {t / k_ms:.1%} of bound")
            tot["kern"] += n * k_ms
            tot["plain"] += n * p_ms
            tot["lib"] += n * l_ms
            tot["bound"] += n * t
            by[key] = by.get(key, 0.0) + n * t
            del x, xs
        mean_ms = sum(ms) / len(ms)
        log(f"[table] {name}: {tot['kern']:.3f} ms per {per} (device, by "
            f"shape), {mean_ms:.3f} ms in events on the path; bound "
            f"{tot['bound']:.4f} ms, {tot['bound'] / tot['kern']:.1%} of "
            f"bound; plain {tot['plain']:.3f} ms, library "
            f"{tot['lib']:.3f} ms")
        rows.append({"name": name, "route": "cuda",
                     "source": SOURCES[name][0], "replaces": SOURCES[name][1],
                     "launches": launches, "max_abs_err": errs[name],
                     "ms": tot["kern"], "path_events_ms": mean_ms,
                     "plain_ms": tot["plain"],
                     "bound_ms": tot["bound"],
                     "bound_by": max(by, key=by.get),
                     "library_ms": tot["lib"], "per": per})
    return rows


# ---------------------------------------------------------------------------
# Serving (phases 33–35)
# ---------------------------------------------------------------------------

SERVE_EXACT_B, SERVE_EXACT_S = 2, 32
SERVE_EXACT_TOL = 2e-3   # tests/test_serve.py's: prefill + decode against
                         # the full forward, f32 sums in another order
#: phase 33: (arch, depth cut (None: full depth)), each arch at the depth
#: its training phases run (qwen2-7b and minitron-4b: phase 16's)
SERVE_EXACT_ARCHS = (("llama3.2-1b", None), ("qwen2-7b", VL_LAYERS),
                     ("qwen2-vl-7b", VL_LAYERS), ("minitron-4b", VL_LAYERS),
                     ("gemma2-9b", GEMMA_LAYERS), ("phi3.5-moe", MOE_LAYERS),
                     ("deepseek-v2-236b", DS_LAYERS), ("rwkv6-3b", 2),
                     ("zamba2-7b", 9), ("seamless-m4t-medium", None))
SERVE_SLOTS, SERVE_CACHE = 16, 2048     # phase 34: slots, cache rows
SERVE_REQUESTS, SERVE_NEW = 32, 128     # requests, new tokens each
SERVE_PROMPTS = (64, 512)               # prompt lengths, numpy seed 0
#: phase 35: (arch, depth cut) served through Engine.generate, bf16
FAMILY_SERVE = (("deepseek-v2-236b", DS_LAYERS), ("phi3.5-moe", MOE_LAYERS),
                ("gemma2-9b", GEMMA_LAYERS), ("qwen2-vl-7b", VL_LAYERS),
                ("rwkv6-3b", 2), ("zamba2-7b", 9))
FAMILY_SLOTS, FAMILY_CACHE = 8, 256
FAMILY_REQUESTS, FAMILY_NEW = 8, 32
FAMILY_PROMPTS = (16, 128)              # zamba2's SSD prefill is host-bound
DECODE_REPS = 5                         # decode steps profiled


def serve_cfg(spec, registry, layers, dtype, seq, slots):
    """``spec``'s published config in ``dtype`` cut to ``layers`` (None:
    full depth), with the cache lengths of a serve shape."""
    from repro_torch.configs.common import ShapeSpec
    return registry.serving_config(spec, family_cfg(spec, layers, dtype),
                                   ShapeSpec("serve", "decode", seq, slots))


def tree_bytes(tree) -> int:
    from repro_torch.nn.param import tree_leaves
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree)
               if x is not None)


def decode_bound(cfg, params, caches, b, kv_len):
    """(bytes, operations) the card must at least move and do for one
    decode step of ``b`` slots at ``kv_len`` cache rows: every weight read
    once (the embedding table's b rows only; of a MoE layer's routed
    experts at most b·top_k), the self-attention caches' first ``kv_len``
    rows (MLA's latent and rope key), the cross caches whole, the
    recurrent states read and written, the logits written; operations
    2·b per weight read and 4·b·kv_len per attention head dimension."""
    from repro_torch.nn.param import tree_flatten, tree_paths
    leaves, _ = tree_flatten(params)
    w_bytes, ops_n = 0, 0
    moe = getattr(cfg, "moe", None)
    for path, x in zip(tree_paths(params), leaves):
        n = x.numel()
        if path[0] == "embed":
            n = b * x.shape[-1]
        elif moe is not None and "moe" in path and path[-1] in ("gate", "up",
                                                                "down"):
            n = n * min(moe.n_experts, b * moe.top_k) // moe.n_experts
        w_bytes += n * x.element_size()
        if path[0] != "embed":
            ops_n += 2 * b * n
    c_bytes = 0

    def walk(node, key):
        nonlocal c_bytes, ops_n
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, k if key != "cross" else "cross")
        elif isinstance(node, list):
            for v in node:
                walk(v, key)
        elif node is not None and key != "memory":
            if key in ("k", "v", "ckv", "krope"):      # rows [0, kv_len)
                rows = node[:, :kv_len]
                c_bytes += rows.numel() * rows.element_size()
                ops_n += 2 * rows.numel()
            elif key == "cross":                      # whole
                c_bytes += node.numel() * node.element_size()
                ops_n += 2 * node.numel()
            else:                                     # a state, read+write
                c_bytes += 2 * node.numel() * node.element_size()
    walk(caches, None)
    logits = b * cfg.vocab_cfg.vocab_p * cfg.torch_dtype.itemsize
    return w_bytes + c_bytes + logits, ops_n


class ServeTimer:
    """Wraps ``forward_tokens``: per call the tokens it took, its cache
    index, the host's ms to return (to queue the call) and CUDA events
    around it (its span on the stream, the card's waits on the host
    included)."""

    def __init__(self, fn):
        self.fn = fn
        self.calls = []

    def __call__(self, params, batch, caches, index):
        import torch
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        t0 = time.perf_counter()
        out = self.fn(params, batch, caches, index)
        host = (time.perf_counter() - t0) * 1e3
        e1.record()
        self.calls.append((batch["ids"].shape[1], index, host, e0, e1))
        return out

    def read(self):
        """{"prefill": [(tokens, stream ms, host ms)], "decode": [(cache
        index, stream ms, host ms)]}."""
        import torch
        torch.cuda.synchronize()
        out = {"prefill": [], "decode": []}
        for s, idx, host, e0, e1 in self.calls:
            ms = e0.elapsed_time(e1)
            if s > 1 or idx == 0:
                out["prefill"].append((s, ms, host))
            else:
                out["decode"].append((idx, ms, host))
        return out


def median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2] if xs else float("nan")


def decode_kernels(fwd, params, caches, tok, index):
    """(kernel ms, kernels) of one decode step (``tok`` at ``index``,
    rewriting the same cache row each time): ``torch.profiler`` over
    ``DECODE_REPS`` steps, every kernel's device time summed a step. The
    profiler stretches the host's time, not a kernel's, so 1 − kernel ms /
    stream ms of an unprofiled step is the card's idle share of it. (A
    card held busy by ``torch.cuda._sleep`` while the host queues cannot
    time a step of ~1,300 launches: the launch queue fills and the host
    waits for the card.)"""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fwd(params, {"ids": tok}, caches, index)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(DECODE_REPS):
            fwd(params, {"ids": tok}, caches, index)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        raise AssertionError("the profiler recorded no kernel of a decode "
                             "step")
    return (sum(e.time_range.elapsed_us() for e in kernels) / DECODE_REPS
            / 1e3, len(kernels) / DECODE_REPS)


def log_kernels(tag, out):
    log(f"[{tag}] decode step: {out['kernels']:.0f} kernels, "
        f"{out['kernel_ms']:.3f} ms of kernel time (profiler) against a "
        f"stream of {out['decode_ms']:.3f} ms (the host queues it in "
        f"{out['decode_host_ms']:.3f}): the card idles "
        f"{1 - out['kernel_ms'] / out['decode_ms']:.0%} of a served step; "
        f"kernel time {out['kernel_ms'] / out['bound_ms']:.1f}× the bound "
        f"of {out['bound_ms']:.3f} ms")


def serve_requests(vocab, n, lo, hi, max_new):
    """``n`` requests with prompt lengths in [lo, hi] and tokens from
    numpy seed 0."""
    import numpy as np
    from repro_torch.serve import Request
    rng = np.random.default_rng(0)
    lens = rng.integers(lo, hi + 1, size=n)
    return [Request(prompt=[int(t) for t in rng.integers(0, vocab, int(m))],
                    max_new=max_new) for m in lens]


def serve_report(tag, cfg, params, timer, caches, b, wall_s, tokens):
    """Logs and returns a served run's numbers: prefill ms per batch,
    the median decode step's stream ms and host queue ms, its byte and
    operation bound at its cache rows, tokens
    per second, peak and cache GiB."""
    import torch
    r = timer.read()
    dec = r["decode"]
    mid = sorted(dec, key=lambda d: d[1])[len(dec) // 2]
    kv_len = mid[0] + 1
    nbytes, nops = decode_bound(cfg, params, caches, b, kv_len)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = nops / PEAK_FLOPS[str(cfg.torch_dtype)] * 1e3
    out = {"prefill_ms": [round(ms, 2) for _, ms, _ in r["prefill"]],
           "prefill_tokens": [s for s, _, _ in r["prefill"]],
           "prefill_host_ms": [round(h, 2) for _, _, h in r["prefill"]],
           "decode_steps": len(dec),
           "decode_ms": median([ms for _, ms, _ in dec]),
           "decode_host_ms": median([h for _, _, h in dec]),
           "decode_kv_len": kv_len,
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "bound_gb": nbytes / 1e9,
           "tokens": tokens, "wall_s": wall_s,
           "tok_per_s": tokens / wall_s,
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "cache_gib": tree_bytes(caches) / 2**30}
    log(f"[{tag}] prefill ms per batch {out['prefill_ms']} (tokens a slot "
        f"{out['prefill_tokens']}; host ms to queue "
        f"{out['prefill_host_ms']}); {out['decode_steps']} decode steps: "
        f"median stream ms {out['decode_ms']:.3f}, host ms to queue "
        f"{out['decode_host_ms']:.3f}; bound at {kv_len} cache rows "
        f"{out['bound_ms']:.3f} ms ({out['bound_by']}: "
        f"{out['bound_gb']:.3f} GB at 3.35 TB/s, {nops / 1e9:.1f} GFLOP); "
        f"{tokens} tokens in {wall_s:.2f} s: {out['tok_per_s']:.1f} tok/s; "
        f"peak {out['peak_gib']:.2f} GiB, caches {out['cache_gib']:.3f} GiB")
    return out


def serve_profile(rows=533, reps=5, top=25):
    """Profiles phase 34's decode step (llama3.2-1b, bf16, ``SERVE_SLOTS``
    slots, the token at cache row ``rows`` - 1, phase 34's median step)
    with ``torch.profiler`` over ``reps`` steps: the kernels a step, their
    summed device ms a step against the span from a step's first kernel to
    its last, the ``top`` kernels by device time, and any host
    synchronisation or device-to-host copy. Not in a whole run:
    ``python3 -c "import chip_smoke; chip_smoke.serve_profile()"``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import registry
    spec = registry.get("llama3.2-1b")
    cfg = serve_cfg(spec, registry, None, "bfloat16", SERVE_CACHE,
                    SERVE_SLOTS)
    mod = registry.family_module(spec)
    params = mod.init(cfg, torch.Generator(device="cuda").manual_seed(0))
    fwd = registry.make_forward_tokens(spec, cfg)
    caches = mod.init_caches(SERVE_SLOTS, cfg)
    fwd(params, {"ids": torch.zeros(SERVE_SLOTS, rows - 1, dtype=torch.long,
                                    device="cuda")}, caches, 0)
    tok = torch.zeros(SERVE_SLOTS, 1, dtype=torch.long, device="cuda")
    for _ in range(3):
        fwd(params, {"ids": tok}, caches, rows - 1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fwd(params, {"ids": tok}, caches, rows - 1)
        torch.cuda.synchronize()
    events = prof.events()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    by_name = {}
    for e in kernels:
        n, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    busy = sum(us for _, us in by_name.values()) / reps / 1e3
    span = (max(e.time_range.end for e in kernels)
            - min(e.time_range.start for e in kernels)) / reps / 1e3
    syncs = {}
    for e in events:
        if e.device_type == DeviceType.CPU and (
                "ynchronize" in e.name or "Memcpy" in e.name
                or e.name in ("aten::item", "aten::_local_scalar_dense")):
            syncs[e.name] = syncs.get(e.name, 0) + 1
    log(f"[serve-profile] llama3.2-1b decode, bf16, {SERVE_SLOTS} slots, "
        f"cache row {rows - 1}: {len(kernels) / reps:.0f} kernels a step, "
        f"{busy:.3f} ms of kernel time a step over a span of {span:.3f} ms "
        f"(the card idles {1 - busy / span:.0%} of it under the profiler); "
        f"host syncs and copies over {reps} steps {syncs}")
    for name, (n, us) in sorted(by_name.items(),
                                key=lambda kv: -kv[1][1])[:top]:
        log(f"[serve-profile] {us / reps / 1e3:8.3f} ms a step, "
            f"{n / reps:5.0f} a step: {name[:150]}")
    return {"kernels": len(kernels) / reps, "busy_ms": busy, "span_ms": span}


def phase_serve_exact(registry):
    """Phase 33: each arch of ``SERVE_EXACT_ARCHS`` at full width in f32,
    B=2, S=32: prefill S-1 tokens (qwen2-vl with its visual embeds and
    (B, 3, S) positions, seamless from its ``src_frames``), decode 1, and
    the last logits against the full forward (``tests/test_serve.py``'s
    property) at 2e-3; MoE archs with ``capacity_factor = n_experts`` (no
    drops); rwkv6 and zamba2 also a two-segment prefill (5 + rest) against
    one shot. No counted kernel launches. Logs each arch's cache bytes a
    slot."""
    import torch
    from repro_torch.configs.common import ShapeSpec
    from repro_torch.kernels import ops
    b, s = SERVE_EXACT_B, SERVE_EXACT_S
    out = {}
    for arch, layers in SERVE_EXACT_ARCHS:
        spec = registry.get(arch)
        cfg = serve_cfg(spec, registry, layers, "float32", s, b)
        if getattr(cfg, "moe", None) is not None:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=float(cfg.moe.n_experts)))
        mod = registry.family_module(spec)
        params = mod.init(cfg, torch.Generator(device="cuda").manual_seed(0))
        fwd = registry.make_forward_tokens(spec, cfg)
        batch = registry.make_train_batch(spec, cfg,
                                          ShapeSpec("serve", "train", s, b),
                                          rng_seed=0)
        batch.pop("labels")
        v = cfg.vocab
        ops.reset_launch_counts()
        tr = spec.family == "transformer"
        full, _ = fwd(params, batch, None if tr else mod.init_caches(b, cfg),
                      None if tr else 0)
        pre = {k: (x if k == "src_frames" else
                   x[:, :, :s - 1] if k == "positions" else x[:, :s - 1])
               for k, x in batch.items()}
        caches = mod.init_caches(b, cfg)
        _, caches = fwd(params, pre, caches, 0)
        last, caches = fwd(params, {"ids": batch["ids"][:, s - 1:]}, caches,
                           s - 1)
        want, got = full[:, -1, :v].float(), last[:, 0, :v].float()
        err = (got - want).abs().max().item()
        ok = bool(torch.allclose(got, want, rtol=SERVE_EXACT_TOL,
                                 atol=SERVE_EXACT_TOL))
        msg = (f"[serve-exact] {arch} ({cfg.n_layers} layers, f32, B={b}, "
               f"S={s}): decode vs full forward max abs err {err:.3e} "
               f"(max |logit| {want.abs().max().item():.3f})")
        if arch in ("rwkv6-3b", "zamba2-7b"):
            c2 = mod.init_caches(b, cfg)
            _, c2 = fwd(params, {"ids": batch["ids"][:, :5]}, c2, 0)
            rest, _ = fwd(params, {"ids": batch["ids"][:, 5:]}, c2, 5)
            seg = (rest[..., :v] - full[:, 5:, :v]).abs().max().item()
            ok &= bool(torch.allclose(rest[..., :v].float(),
                                      full[:, 5:, :v].float(),
                                      rtol=SERVE_EXACT_TOL,
                                      atol=SERVE_EXACT_TOL))
            msg += f"; two-segment prefill (5 + {s - 5}) vs one shot {seg:.3e}"
        n = ops.launch_counts()
        if any(n.values()):
            raise AssertionError(f"[serve-exact] {arch}: counted kernels "
                                 f"launched while serving: {n}")
        per_slot = tree_bytes(caches) / b
        grow = (tree_bytes(mod.init_caches(1, dataclasses.replace(
            cfg, max_cache_len=2 * s))) - tree_bytes(mod.init_caches(
                1, cfg))) / s
        msg += (f"; caches {per_slot / 2**20:.3f} MiB a slot at {s} rows, "
                f"{grow:.0f} B a slot per context row (f32)")
        log(msg)
        if not ok:
            raise AssertionError(f"[serve-exact] {arch}: prefill + decode "
                                 f"differ from the full forward beyond "
                                 f"{SERVE_EXACT_TOL}")
        out[arch] = {"err": err, "cache_mib_per_slot": per_slot / 2**20,
                     "bytes_per_row": grow}
        del params, caches, full, last
        torch.cuda.empty_cache()
    log(f"[serve-exact] all {len(out)} archs: prefill + decode equals the "
        f"full forward within {SERVE_EXACT_TOL}; no counted kernel launched")
    return out


def serve_path(tag, arch, registry, layers, seq, slots, requests,
               check_repeat=False):
    """Serve ``requests`` through ``Engine.generate`` (greedy) on ``arch``
    in bf16 at ``layers`` (None: full depth) with ``slots`` slots and
    ``seq`` cache rows, every ``forward_tokens`` call timed
    (``ServeTimer``), the counted kernels' launches reset before and read
    after (none: the serving path runs no tap and no flash route); every
    request must get its ``max_new`` tokens, and with ``check_repeat`` a
    second engine on the first batch must give its tokens again. Then one
    decode step's device ms on a busy card. Returns ``serve_report``'s
    numbers."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.nn.param import count_params
    from repro_torch.serve import Engine, Request
    spec = registry.get(arch)
    cfg = serve_cfg(spec, registry, layers, "bfloat16", seq, slots)
    mod = registry.family_module(spec)
    params = mod.init(cfg, torch.Generator(device="cuda").manual_seed(0))
    log(f"[{tag}] {arch}: {cfg.n_layers} layers, bf16, "
        f"{count_params(params) / 1e9:.2f}B parameters; {len(requests)} requests (prompts of "
        f"{min(len(r.prompt) for r in requests)}–"
        f"{max(len(r.prompt) for r in requests)} tokens, "
        f"{requests[0].max_new} new each), {slots} slots, {seq} cache rows, "
        f"greedy")
    eng = Engine(arch, cfg, params, batch_slots=slots)
    timer = ServeTimer(eng.fwd)
    eng.fwd = timer
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    done = eng.generate(requests)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = ops.launch_counts()
    if any(n.values()):
        raise AssertionError(f"[{tag}] counted kernels launched while "
                             f"serving: {n}")
    lens = [len(r.out) for r in done]
    if lens != [r.max_new for r in done]:
        raise AssertionError(f"[{tag}] tokens per request {lens}")
    if any(not 0 <= t < cfg.vocab for r in done for t in r.out):
        raise AssertionError(f"[{tag}] a token outside the vocab")
    caches = mod.init_caches(slots, cfg)
    out = serve_report(tag, cfg, params, timer, caches, slots, wall,
                       sum(lens))
    log(f"[{tag}] launches of the counted kernels while serving: none "
        f"({n})")
    if check_repeat:
        first = done[:slots]
        again = Engine(arch, cfg, params, batch_slots=slots).generate(
            [Request(r.prompt, r.max_new) for r in first])
        same = [a.out == r.out for a, r in zip(again, first)]
        log(f"[{tag}] a repeat of the first batch gives the same tokens in "
            f"{sum(same)} of {len(same)} requests")
        if not all(same):
            raise AssertionError(f"[{tag}] greedy decode not repeatable")
    # one decode step profiled, at the median step's cache rows
    kv = out["decode_kv_len"]
    tok = torch.zeros(slots, 1, dtype=torch.long, device="cuda")
    fwd = registry.make_forward_tokens(spec, cfg)
    fwd(params, {"ids": torch.zeros(slots, kv - 1, dtype=torch.long,
                                    device="cuda")}, caches, 0)
    out["kernel_ms"], out["kernels"] = decode_kernels(fwd, params, caches,
                                                      tok, kv - 1)
    log_kernels(tag, out)
    del params, caches, eng
    torch.cuda.empty_cache()
    return out


def phase_serve(registry):
    """Phase 34, the slice's path: llama3.2-1b at full depth and width in
    bf16 serving ``SERVE_REQUESTS`` requests (prompts of 64–512 tokens,
    ``SERVE_NEW`` new tokens each) greedily in ``SERVE_SLOTS`` slots of
    ``SERVE_CACHE`` rows."""
    spec = registry.get("llama3.2-1b")
    reqs = serve_requests(spec.full().vocab, SERVE_REQUESTS,
                          *SERVE_PROMPTS, SERVE_NEW)
    return serve_path("serve", "llama3.2-1b", registry, None, SERVE_CACHE,
                      SERVE_SLOTS, reqs, check_repeat=True)


def serve_seamless(registry):
    """seamless-m4t-medium at full depth in bf16 through
    ``forward_tokens``: ``FAMILY_SLOTS`` slots prefilled with source frames
    (numpy seed 0, ``FAMILY_PROMPTS[1]`` frames) and 16-token prompts, then
    ``FAMILY_NEW`` - 1 greedy decode steps against the cross caches."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    spec = registry.get("seamless-m4t-medium")
    b, src = FAMILY_SLOTS, FAMILY_PROMPTS[1]
    cfg = serve_cfg(spec, registry, None, "bfloat16", FAMILY_CACHE, b)
    mod = registry.family_module(spec)
    params = mod.init(cfg, torch.Generator(device="cuda").manual_seed(0))
    rng = np.random.default_rng(0)
    frames = torch.as_tensor(rng.normal(size=(b, src, cfg.d_model)) * 0.1,
                             device="cuda").to(cfg.torch_dtype)
    ids = torch.as_tensor(rng.integers(0, cfg.vocab, (b, 16)),
                          device="cuda")
    log(f"[serve-families] seamless-m4t-medium: {cfg.n_layers} layers, "
        f"bf16, {b} slots, {src} source frames, 16-token prompts, "
        f"{FAMILY_NEW} new tokens, greedy, through forward_tokens")
    timer = ServeTimer(registry.make_forward_tokens(spec, cfg))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    caches = mod.init_caches(b, cfg)
    logits, caches = timer(params, {"ids": ids, "src_frames": frames},
                           caches, 0)
    tok = torch.argmax(logits[:, -1, :cfg.vocab], dim=-1)
    outs = [[t] for t in tok.tolist()]
    for t in range(1, FAMILY_NEW):
        logits, caches = timer(params, {"ids": tok[:, None]}, caches,
                               16 + t - 1)
        tok = torch.argmax(logits[:, -1, :cfg.vocab], dim=-1)
        for o, x in zip(outs, tok.tolist()):
            o.append(x)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = ops.launch_counts()
    if any(n.values()) or any(len(o) != FAMILY_NEW for o in outs):
        raise AssertionError(f"[serve-families] seamless: launches {n}, "
                             f"tokens {[len(o) for o in outs]}")
    out = serve_report("serve-families seamless-m4t-medium", cfg, params,
                       timer, caches, b, wall, b * FAMILY_NEW)
    out["kernel_ms"], out["kernels"] = decode_kernels(
        timer.fn, params, caches, tok[:, None], out["decode_kv_len"] - 1)
    log_kernels("serve-families seamless-m4t-medium", out)
    del params, caches
    torch.cuda.empty_cache()
    return out


def phase_serve_families(registry):
    """Phase 35: ``FAMILY_REQUESTS`` requests of ``FAMILY_NEW`` new tokens
    through ``Engine.generate`` for each of ``FAMILY_SERVE`` at its probe
    depth in bf16 (the configs' own MoE capacity, as served), then
    seamless at full depth through ``forward_tokens`` from source
    frames."""
    out = {}
    for arch, layers in FAMILY_SERVE:
        spec = registry.get(arch)
        reqs = serve_requests(spec.full().vocab, FAMILY_REQUESTS,
                              *FAMILY_PROMPTS, FAMILY_NEW)
        out[arch] = serve_path(f"serve-families {arch}", arch, registry,
                               layers, FAMILY_CACHE, FAMILY_SLOTS, reqs)
    out["seamless-m4t-medium"] = serve_seamless(registry)
    return out


def main() -> int:
    global T0
    T0 = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch import pex
    from repro_torch.models import registry
    from repro_torch.nn.lora import LoraCfg

    name, smi = phase_device()
    phase_build()
    spec = registry.get("llama3.2-1b")
    cfg = spec.full()
    gemma_spec = registry.get("gemma2-9b")
    gemma_cfg = cut(gemma_spec, GEMMA_LAYERS)
    vl_spec = registry.get("qwen2-vl-7b")
    vl_cfg = with_flash(cut(vl_spec, VL_LAYERS))
    ds_spec = registry.get("deepseek-v2-236b")
    ds_cfg = cut(ds_spec, DS_LAYERS)
    moe_spec = registry.get("phi3.5-moe")
    moe_cfg = cut(moe_spec, MOE_LAYERS)
    lora = LoraCfg(rank=TENANT_R, alpha=TENANT_ALPHA)
    lora_cfg = dataclasses.replace(cfg, lora=lora)
    fam_specs = [(registry.get(a), n, tag) for a, n, tag in FAMILY_PATHS]
    fam_cfgs = [family_cfg(sp, n) for sp, n, _ in fam_specs]
    errs = {}
    checked = phase_kernels(
        cfg, errs, ((moe_cfg, MOE_B, MOE_S), (gemma_cfg, B, S),
                    (vl_cfg, B, S), (ds_cfg, DS_B, DS_S), (lora_cfg, B, S))
        + tuple((c, B, S) for c in fam_cfgs),
        tuple((family_cfg(sp, n, "float32"), EXACT_B, EXACT_S)
              for sp, n, _ in fam_specs))
    phase_flash_kernels(errs)
    phase_exact(spec, registry, pex)
    torch.cuda.empty_cache()
    expected = main_path_launches(cfg, S)
    main_run = phase_main(spec, registry, pex, cfg, (B, S), "main",
                          pass_launches(expected, cfg), NORM_KERNELS)
    torch.cuda.empty_cache()
    flash_run = phase_main(spec, registry, pex, with_flash(cfg), (B, S),
                           "flash", pass_launches(expected, with_flash(cfg)),
                           NORM_KERNELS + FLASH_KERNELS)
    torch.cuda.empty_cache()
    d_loss = abs(flash_run["losses"][0] - main_run["losses"][0]) \
        / abs(main_run["losses"][0])
    log(f"[flash] step-0 loss {flash_run['losses'][0]:.6f} vs unfused "
        f"{main_run['losses'][0]:.6f}: rel diff {d_loss:.2e} (tol "
        f"{LOSS_TOL}: same params and batch, only the attention route "
        f"differs)")
    if not d_loss <= LOSS_TOL:
        raise AssertionError(f"flash and unfused step-0 losses differ by "
                             f"{d_loss}")
    for tag, r in (("main (unfused)", main_run), ("flash", flash_run)):
        steady = r["step_ms"][1:]
        fl = [sum(m[k] for k in FLASH_KERNELS if k in m)
              for m in r["kern_ms"][1:]]
        log(f"[compare] {tag}: steady step ms {steady}; attention core "
            f"fwd+bwd ms per steady step "
            f"{[round(a + b, 3) for a, b in r['attn_ms'][1:]]}; flash "
            f"kernel ms per steady step {[round(x, 3) for x in fl]}; peak "
            f"memory {r['peak_gib']:.2f} GiB")
    phase_moe_exact(moe_spec, registry, pex)
    torch.cuda.empty_cache()
    moe_run = phase_main(moe_spec, registry, pex, moe_cfg, (MOE_B, MOE_S),
                         "moe", pass_launches(main_path_launches(
                             moe_cfg, MOE_S), moe_cfg),
                         NORM_KERNELS + ("segmented_norm",))
    torch.cuda.empty_cache()
    log(f"[compare] moe: steady step ms {moe_run['step_ms'][1:]}; segmented "
        f"kernel ms per steady step "
        f"{[round(m['segmented_norm'], 3) for m in moe_run['kern_ms'][1:]]};"
        f" attention core fwd+bwd ms per steady step "
        f"{[round(a + b, 3) for a, b in moe_run['attn_ms'][1:]]}; peak "
        f"memory {moe_run['peak_gib']:.2f} GiB")
    path = seg_path(moe_run["seg_calls"])
    phase_seg_kernels(path, errs)
    torch.cuda.empty_cache()
    phase_token_exact(spec, registry, pex)
    torch.cuda.empty_cache()
    token_run = phase_main(spec, registry, pex, cfg, (B, S), "token",
                           token_pass_launches(cfg), ("rowsumsq",),
                           token=True)
    torch.cuda.empty_cache()
    moe_token_run = phase_moe_token(moe_spec, registry, pex, moe_cfg)
    torch.cuda.empty_cache()
    onepass = phase_onepass()
    torch.cuda.empty_cache()
    for tag, r in (("token", token_run), ("moe-token", moe_token_run)):
        log(f"[compare] {tag}: step ms {r['step_ms']}; rowsumsq kernel ms "
            f"per step {[round(m['rowsumsq'], 3) for m in r['kern_ms']]}; "
            f"attention core fwd+bwd ms per step "
            f"{[round(a + b, 3) for a, b in r['attn_ms']]}; peak memory "
            f"{r['peak_gib']:.2f} GiB")
    row_shapes = {sh for run in (token_run, moe_token_run)
                  for calls in run["row_calls"] for sh, _ in calls}
    row_shapes |= {sh for sh, _ in onepass["row_calls"]}
    phase_row_kernels(row_shapes, {sh for sh, _ in onepass["scale_calls"]},
                      errs)
    rows = phase_table(expected, errs, main_run["launches"],
                       main_run["kern_ms"])
    rows.append(seg_table(path, errs, moe_run))
    rows += flash_table(errs, flash_run["launches"], flash_run["kern_ms"])
    rows += row_table(errs, token_run, onepass)
    torch.cuda.empty_cache()
    dispatch = phase_dispatch([(c, B, S) for c in (
        cfg, gemma_cfg, vl_cfg, cut(registry.get("qwen2-7b"), VL_LAYERS),
        cut(registry.get("minitron-4b"), VL_LAYERS), lora_cfg, *fam_cfgs)]
        + [(ds_cfg, DS_B, DS_S)])
    torch.cuda.empty_cache()
    train_run = phase_train(spec, registry, cfg)
    torch.cuda.empty_cache()
    log(f"[compare] train: step ms {train_run['step_ms']} (clip steps "
        f"{TRAIN_CLIP_STEPS}, then importance); main path steady step ms "
        f"{main_run['step_ms'][1:]}; peak memory {train_run['peak_gib']:.2f} "
        f"GiB (main {main_run['peak_gib']:.2f})")
    phase_exact(gemma_spec, registry, pex,
                cut(gemma_spec, GEMMA_LAYERS, dtype="float32"),
                "gemma2-exact", flash_launches=0)
    torch.cuda.empty_cache()
    gemma_want = main_path_launches(gemma_cfg, S)
    gemma_kernels = tuple(k for k, v in gemma_want.items() if v)
    gemma_run = phase_main(gemma_spec, registry, pex, gemma_cfg, (B, S),
                           "gemma2", pass_launches(gemma_want, gemma_cfg),
                           gemma_kernels)
    torch.cuda.empty_cache()
    vl_unfused = plain_loss(vl_spec, registry, pex, dataclasses.replace(
        vl_cfg, attn=dataclasses.replace(vl_cfg.attn, flash=False)))
    torch.cuda.empty_cache()
    vl_want = main_path_launches(vl_cfg, S)
    vl_kernels = tuple(k for k, v in vl_want.items() if v) + FLASH_KERNELS
    vl_run = phase_main(vl_spec, registry, pex, vl_cfg, (B, S), "qwen2-vl",
                        pass_launches(vl_want, vl_cfg), vl_kernels)
    torch.cuda.empty_cache()
    d_loss = abs(vl_run["losses"][0] - vl_unfused) / abs(vl_unfused)
    log(f"[qwen2-vl] step-0 loss {vl_run['losses'][0]:.6f} (flash) vs "
        f"unfused {vl_unfused:.6f} on the same params and batch: rel diff "
        f"{d_loss:.2e} (tol {LOSS_TOL})")
    if not d_loss <= LOSS_TOL:
        raise AssertionError(f"qwen2-vl flash and unfused step-0 losses "
                             f"differ by {d_loss}")
    ds_exact = phase_moe_exact(ds_spec, registry, pex, DS_LAYERS,
                               (DS_EXACT_B, DS_EXACT_S), "deepseek-exact",
                               grads=False)
    torch.cuda.empty_cache()
    ds_want = main_path_launches(ds_cfg, DS_S)
    ds_kernels = tuple(k for k, v in ds_want.items() if v) \
        + ("segmented_norm",)
    ds_run = phase_main(ds_spec, registry, pex, ds_cfg, (DS_B, DS_S),
                        "deepseek", pass_launches(ds_want, ds_cfg),
                        ds_kernels)
    torch.cuda.empty_cache()
    # segmented on the deepseek step's own ids (5120↔1536, 2,560 segments);
    # the kernel's row stays the phi3.5-moe path's
    ds_path = seg_path(ds_run["seg_calls"], save=False)
    ds_errs = {}
    phase_seg_kernels(ds_path, ds_errs, edges=False)
    ds_seg_ms = seg_times(ds_path, tag="deepseek-seg-times")
    torch.cuda.empty_cache()
    lora_run = phase_lora(spec, registry, pex, lora_cfg)
    torch.cuda.empty_cache()
    phase_tenants_exact(pex)
    torch.cuda.empty_cache()
    tenants = phase_tenants(pex)
    torch.cuda.empty_cache()
    fam_runs, fam_exact_shapes, fam_tables = {}, {}, {}
    for sp, n, tag in fam_specs:
        fam_exact_shapes[tag] = set()
        fam_runs[tag] = phase_family(sp, registry, pex, n, tag,
                                     fam_exact_shapes[tag])
        torch.cuda.empty_cache()
        fam_tables[tag] = family_norm_table(tag, fam_runs[tag]["want"],
                                            dispatch)
        torch.cuda.empty_cache()
    serve_exact = phase_serve_exact(registry)
    serve_run = phase_serve(registry)
    serve_fams = phase_serve_families(registry)
    torch.cuda.empty_cache()
    dp_exact = phase_dp_exact()
    dp_run = phase_dp(spec, registry, cfg, train_run)
    torch.cuda.empty_cache()
    ckpt_run = phase_ckpt(spec, registry, cfg, train_run)
    torch.cuda.empty_cache()
    soak_run = phase_soak()
    for tag, r in (("serve llama3.2-1b", serve_run),
                   *((f"serve-families {a}", r)
                     for a, r in serve_fams.items())):
        log(f"[compare] {tag}: prefill ms per batch {r['prefill_ms']}; "
            f"decode step ms: stream {r['decode_ms']:.3f}, host to queue "
            f"{r['decode_host_ms']:.3f}, kernels {r['kernel_ms']:.3f} "
            f"({r['kernels']:.0f} a step), bound {r['bound_ms']:.3f} "
            f"({r['bound_by']}); {r['tok_per_s']:.1f} tok/s; peak "
            f"{r['peak_gib']:.2f} GiB, caches {r['cache_gib']:.3f} GiB")
    errs_by_arch = {a: float(f"{r['err']:.3e}")
                    for a, r in serve_exact.items()}
    log(f"[compare] serve-exact max abs err by arch {errs_by_arch}")
    # every gram and direct launch of every path, of either dtype, at a
    # shape, and so on a plan, that phase 3 held against its plain version
    for tag, r in (("main", main_run), ("flash", flash_run),
                   ("moe", moe_run), ("token", token_run),
                   ("moe-token", moe_token_run), ("train", train_run),
                   ("gemma2", gemma_run), ("qwen2-vl", vl_run),
                   ("deepseek", ds_run), ("lora", lora_run),
                   *fam_runs.items(),
                   *((f"{t}-exact", {"norm_shapes": v})
                     for t, v in fam_exact_shapes.items())):
        if not r["norm_shapes"] <= checked:
            raise AssertionError(f"{tag}: gram/direct launched at "
                                 f"{sorted(r['norm_shapes'] - checked)}, "
                                 f"not checked in phase 3")
        log(f"[kernels] {tag}: every gram/direct launch shape "
            f"{sorted(r['norm_shapes'])} was held in phase 3")
    for tag, r in (("main", main_run), ("gemma2", gemma_run),
                   ("qwen2-vl", vl_run), ("deepseek", ds_run),
                   ("lora", lora_run), *fam_runs.items()):
        log(f"[compare] {tag}: steady stream ms in Engine.step "
            f"{[round(x, 1) for x in r['engine_ms'][1:]]} (queued by the "
            f"host in {[round(x, 1) for x in r['enqueue_ms'][1:]]}), in the "
            f"AdamW "
            f"update {[round(x, 1) for x in r['adamw_ms'][1:]]} (host step "
            f"ms {[round(x, 1) for x in r['step_ms'][1:]]})")
    for tag, r, kerns in (("gemma2", gemma_run, gemma_kernels),
                          ("qwen2-vl", vl_run, vl_kernels),
                          ("deepseek", ds_run, ds_kernels)):
        log(f"[compare] {tag}: steady step ms {r['step_ms'][1:]} (step 0 "
            f"{r['step_ms'][0]:.1f}); kernel ms per steady step "
            f"{[{k: round(m[k], 3) for k in kerns} for m in r['kern_ms'][1:]]}"
            f"; attention core fwd+bwd ms per steady step "
            f"{[round(a + b, 3) for a, b in r['attn_ms'][1:]]}; peak memory "
            f"{r['peak_gib']:.2f} GiB")
    for tag, r in fam_runs.items():
        log(f"[compare] {tag}: steady step ms {r['step_ms'][1:]} (step 0 "
            f"{r['step_ms'][0]:.1f}); launches per norms pass "
            f"{ {k: sum(v.values()) for k, v in r['want'].items()} }; norm "
            f"kernel ms per steady step (events) "
            f"{[{k: round(m[k], 3) for k in r['want'] if k in m} for m in r['kern_ms'][1:]]}"
            f"; by shape a step {json.dumps(fam_tables[tag])}; cores "
            f"fwd+bwd ms per steady step "
            f"{ {k: [round(a + b, 3) for a, b in v[1:]] for k, v in r['core_ms'].items()} }"
            f"; peak memory {r['peak_gib']:.2f} GiB")
    log(f"[compare] deepseek: launches over {STEPS} steps "
        f"{ {k: v for k, v in ds_run['launches'].items() if v} }; segmented "
        f"bf16 max abs err on its ids {ds_errs['segmented_norm']:.3g}, "
        f"device ms a launch {json.dumps(ds_seg_ms)}; deepseek-exact norms "
        f"max rel err {ds_exact['rel_err']:.2e}, peak memory "
        f"{ds_exact['peak_gib']:.2f} GiB")
    tenant_means = {k: [round(sum(v[f]) / len(v[f]), 2)
                        for f in ("fused_ms", "plain_ms")]
                    for k, v in tenants.items()}
    log(f"[table] kernels: {', '.join(r['name'] for r in rows)}; main step "
        f"ms {main_run['step_ms']}; flash step ms {flash_run['step_ms']}; "
        f"moe step ms {moe_run['step_ms']}; token step ms "
        f"{token_run['step_ms']}; moe-token step ms "
        f"{moe_token_run['step_ms']}; train step ms "
        f"{train_run['step_ms']}; gemma2 step ms {gemma_run['step_ms']}; "
        f"qwen2-vl step ms {vl_run['step_ms']}; deepseek step ms "
        f"{ds_run['step_ms']}; lora step ms {lora_run['step_ms']}; tenant "
        f"fused, plain step ms {tenant_means}; "
        + "".join(f"{t} step ms {r['step_ms']}; " for t, r in fam_runs.items())
        + f"serve decode step ms {serve_run['decode_ms']:.3f}, "
        f"{serve_run['tok_per_s']:.1f} tok/s; dp-exact "
        f"{dp_exact['seconds']:.1f} s; dp step ms {dp_run['step_ms']} "
        f"(all-reduce {dp_run['reduce_ms']}, gathers "
        f"{dp_run['gather_ms']} stream ms a step); ckpt "
        f"{ckpt_run['depth']} layers, state {ckpt_run['state_gib']:.2f} GiB, "
        f"save blocks {[round(x, 1) for x in ckpt_run['save_ms']]} ms, "
        f"commit {[round(x, 2) for x in ckpt_run['write_s']]} s, restore "
        f"{[round(x, 2) for x in ckpt_run['restore_s']]} s; soak "
        f"{soak_run['seconds']:.1f} s; whole run "
        f"{time.perf_counter() - T0:.1f} s")
    log(smi)
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
