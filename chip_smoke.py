"""Smoke run of the PyTorch/CUDA port on one card.

Phases:
  1. the card: name and power limit (nvidia-smi), and whether PyTorch runs
     an int32 einsum on CUDA;
  2. build every CUDA kernel from the sources in this checkout (nvcc,
     one process per source, all at once);
  3. hold each kernel against its plain PyTorch version on the card:
     random and ragged shapes, zero and negative weights, checksum
     wraparound; the block join at C = 9 and 12 key columns (R spanning
     several chunks), the fused ingest pass at k_pad 131,075 and 1,048,576
     (dense) and a static table of as many reducers;
  4. the main path at the paper's §9.1 scale (|R| = 10^6, |S| = 10^5, one
     heavy hitter B=7 in 10% of tuples, q = 1000) through ``run_join`` on
     the card, checked against a host group-by oracle, with the kernels'
     launch counts;
4b. the same join through ``run_join_speculative`` (n_shards=4, capped by
     the plan's residual joins; max_workers=4, each shard's reduce the
     block join on the card from a worker thread): clean, then under one
     fault of each shard class (drop, delay, duplicate, preempt, a corrupted
     result caught by its CRC envelope), each exact against ``run_join``;
     then with ``max_attempts=1`` and a dropped shard, which must raise;
     wall time, attempts and backups per shard, the block join's launches;
  5. each kernel at the shapes the main path gives it: device time (a CUDA
     graph of repeated calls), its plain version's time and result, and the
     bound, the function's (every weight and the valid rows' keys read
     once; C + 3 operations a valid row) beside every slot's bytes and the
     earlier nested-loop kernel's operations (C + 2 a pair of valid rows);
  6. the paper's 3-way query (§9.2, at the scale of
     ``examples/multiway_join.py``) on the card against the host oracle;
6b. the distributed shuffle (``run_distributed``, ``_distributed_phase``)
     over this process's one-rank NCCL group: the §9.1 join of phase 4,
     three times, equal to ``run_join`` in count, checksum, every
     ``comm_tuples`` entry and every reducer load, with no overflow, and to
     the oracle; the 3-way query of phase 6 likewise; wall seconds and K1's
     launches (one a run);
  7. the streaming engine's fused path on the card: six micro-batches of
     ``benchmarks/bench_stream.py``'s drifting Zipf stream at 100,000 R and
     25,000 S rows each (q=1000), against the host group-by oracle, with
     the kernels' launch counts, per-batch ingest times, the tracer's
     time per span and, from a profiler trace of the last batch, the
     device's busy share;
  8. the baseline path (plain ``map_phase``, the block join, the Count-Min
     kernel) on the first three of those batches: every report equals the
     fused path's;
  9. the fused path with static route tables (``fused_dynamic_routes=
     False``, the static-table pass) on the same three batches: every
     report equals the fused path's;
 10. each stream kernel at the shapes the stream gave it: its device time
     (a CUDA graph), its wrapper's time, its plain version's time and
     result, and the bound; an empty kernel's time, the launch floor that
     the Count-Min kernel (K4) is read against, and the zero fill of its
     table; K4 on batch 0's S join column, on 100,000 equal keys and on as
     many rows as one cluster covers (the table stored); K4 and the fused
     pass's sketch half exactly against their plain versions on all-equal
     and random keys, N of 1, 4,097, 8,192, 8,193, 100,000 and 300,007,
     widths 1, 2,048, 12,288 and 12,289, depth 4 and 32, two sketched
     columns of three;
10b. the streaming engine survives host loss and preemption on the card,
     on phase 7's six batches (fused path, a window of 4 batches, 8
     simulated hosts, ``_recovery_phase``): an injected loss of host 2 at
     batch 3 recovered by lineage replay (verified through the block join,
     replayed = the lost share, the plan untouched); a checkpoint, restored
     into a second engine (its state rebuilt through the ingest kernel);
     batches 4 and 5 into both (retention retracts 0 and 1; equal reports;
     the fault does not fire again); the loss of hosts 0, 1, 3 and 4 on
     both, a degrade (``repair_plan``, a rebuild), equal and verified; each
     window against the host oracle.  Times of each ``recovery.*`` span,
     the save, the restore and an ingest after it, and the kernels'
     launches inside recovery.  Then, for the replay's and the degrade's
     verify join, the block join (K1) on a few reducers' carried bins (the
     most loaded, one cut into most slices, one of the lost host) held
     exactly against its plain version, slice by slice and summed over
     each reducer;
10c. many queries on one card (``_tenancy_phase``): a ``MultiQueryEngine``
     of three tenants (t0, t1, t2; weights 2, 1, 1), each with phase 7's
     configuration, over phase 7's six batches; t1 poisoned at batch 2
     (quarantined by its breaker); a checkpoint after batch 3 restored into
     a new engine (breaker state included), which takes batches 4 and 5.
     t0 and t2 equal phase 7's reports batch for batch, no tenant computes
     a private sketch pass, the shared Count-Min pass (K4) runs once per
     sketched column and batch, every tenant's total equals the host
     oracle; per batch the multi-tenant ingest beside the tenants' solo
     times from phase 7, the save and the restore, the kernels' launches;
 11. FlashAttention (K6) against its plain version on the card, each case
     naming the kernel ``kernel_variant`` picks: the five shapes of the
     reference kernel tests and a ragged L = 200 in fp32; in bf16 the wgmma
     kernel at D = 64 and 128 with ragged L (200, 1000), GQA 32:8 and 4:1,
     Lq != Lk both ways and the layer's [B, L, H, D] views, the mma.sync
     kernel at D = 96, D = 40 (zero-padded to 48) in fp32 and bf16, and
     OLMo-1B's [4, 16, 2048, 128] causal (tolerance 2e-5 in fp32, 2e-2 in
     bf16);
 12. the histogram (K5) against its plain version, exactly: N of 0, 1,
     4,097 and 1,000,003 by 1, 513, 12,288, 12,289, 100,000 and 2^20 bins
     with negative and out-of-range values, a quarter or all of them equal,
     and the heavy-hitter count of phase 4's R join column (10^6 values,
     100,000 bins);
 13. OLMo-1B at full width (16 layers, d = 2048, random weights from seed
     0) in fp32: the parallel ``prefill`` of [2, 256] prompts (K6 in every
     layer) against ``scan_prefill`` (no K6), logits and one decode step
     from each cache (2e-3); ``forward_hidden`` through K6 against the
     same call with K6's plain version (2e-4);
 14. the same model behind ``BucketServer`` in fp32: six requests with
     prompts of 16 and 32 tokens and max_new = 8, drained; each completion
     equals ``greedy_generate`` of its prompt alone;
 15. bf16 serving, the LM main path: ``prefill`` of [4, 2048] prompts, then
     32 greedy decode steps from that cache; prefill ms, ms per decode
     step, peak device memory, the device's busy share of one prefill and
     one decode step (``torch.profiler``), and K6's launches (16 per
     prefill);
 16. K6 and K5 at the main path's shapes: device time, plain time, one
     PyTorch call's time (``scaled_dot_product_attention``,
     ``torch.bincount``; timed here, never called by the port), bound;
 17. the wkv6 recurrence (K7) against its plain version on the card, each
     case naming its launch geometry: eight shapes (ragged L = 77 at hd =
     16, 48 and 128, a given state, the decode shape [4, 1, 40, 64],
     rwkv6-3b's [4, 2048, 40, 64], and hd = 24 (padded to 32) at L = 77 and
     1 from a state), L = 1 with the state in place at every
     hd (the step kernel), each hd's split kernel found in the library
     with its registers, and one pass
     of L = 2048 against two of 1024 with the state carried in place
     (relative tolerance 2e-4);
 18. rwkv6-3b at full width (32 layers, d = 2560, 40 heads of 64, random
     weights from seed 0; OLMo's freed first) in fp32, on [2, 64] prompts:
     each block on the forward's own input, through K7 (L = 64 from zero)
     against the plain recurrence and decoded token by token (K7 at L = 1,
     the state carried in place) against the forward (2e-4); end to end,
     ``forward_hidden`` logits against token-by-token ``decode_step``
     logits at every position and ``forward_hidden`` through K7 against the
     plain recurrence, on three prompts (5e-2: 32 random layers amplify
     rounding; see the source);
 19. the same model behind ``BucketServer`` in fp32: six requests with
     prompts of 16 and 32 tokens and max_new = 8; each completion equals
     ``greedy_generate`` of its prompt alone;
 20. bf16 serving, the RWKV main path: a forward-only ``loss_fn`` over
     [4, 2048] prompts (scoring long prompts, 32 K7 launches at L = 2048),
     then ``greedy_generate`` of 4 prompts of 128 tokens with 32 new tokens
     (``scan_prefill`` and ``decode_step``); forward ms, ms per decode step,
     the host's PyTorch calls in one decode step, the device's busy share of
     one forward and one decode step, peak device memory, K7's launches;
 21. K7 at the model's shapes, [4, 2048, 40, 64] from zero and [4, 1, 40, 64]
     with a state: device time (a CUDA graph), plain time, bound.
 22. FlashAttention's backward (K6b, ``flash_attention_bwd``: the delta
     pass, the key-tile dK/dV kernel and the query-tile dQ kernel) on the
     forward kernel's o and lse, against ``flash_attention_bwd_ref`` on the
     plain forward's o and lse (so a wrong o or lse from the forward kernel
     shows in dq, dk and dv too): fp32 and bf16, D = 64, 128, 96 and 40
     (padded to 48), GQA 32:8 and 4:1, causal and bidirectional, ragged L =
     200, 300 and 1000, OLMo-1B's [4, 16, 2048, 128] causal bf16.  The
     forward's lse against ``flash_attention_ref_lse``'s (1e-5) and its o
     (2e-5 in fp32, 2e-2 in bf16); dq, dk and dv elementwise (2e-5 in fp32,
     2e-2 in bf16) and by relative norm ||got - want|| / ||want|| (1e-5 in
     fp32; 1e-2 in bf16: rounding P and dS to bf16 before their products
     and the outputs to bf16 gives about 3e-3, one key tile dropped from
     every long row about 4e-2); two calls equal bit for bit;
 23. OLMo-1B at full width and depth (seed 0) in fp32 on [2, 256] tokens:
     one train step (``loss_fn`` with remat, backward, ``adamw_update``)
     through K6's ``FlashAttentionFn`` against the same step with autograd
     through ``flash_attention_ref``: the loss (1e-5 relative), every
     gradient (1e-3 of each leaf's largest entry; wq, wk and wv nonzero) and
     the params after AdamW (1e-3 of the update's norm);
 24. bf16 training, the training main path: OLMo-1B at full width and depth
     over fp32 master weights on [4, 2048] tokens of ``TokenPipeline(seed=
     1)``, ``make_train_step``: eight steps on one batch (the loss must
     fall), then four on the pipeline's prefetch thread; ms a step
     (synchronised), tokens/s, peak device memory, K6's forward and
     backward launches (32 and 16 a step: remat runs each forward twice),
     the device's busy share and time by CUDA function of one step
     (``torch.profiler``), and model-FLOPs utilisation on a line of its own
     (``mfu=``);
 25. checkpoint and resume at full width, depth 2, [2, 512] bf16:
     ``run_elastic_loop`` under a ``PreemptionGuard`` signalled (SIGTERM)
     during step 3 saves through ``AsyncCheckpointer`` in the JAX layout;
     a fresh state, ``load_checkpoint``, ``restore_tree(device=)``, steps 4
     and 5: losses, params, m and v equal an uninterrupted run bit for bit;
     save ms and bytes, restore ms;
 26. K6's backward at the main path's shape, [4, 16, 2048, 128] causal bf16:
     device time (a CUDA graph), plain time, the backward of
     ``scaled_dot_product_attention`` (forward and backward less forward;
     timed here, never called by the port), bound;
 27. the MoE dispatch (``models.moe``, SharesSkew replica slots) on the card
     against the CPU, exactly: the top-k order on tie-heavy router rows
     (fp32 and bf16), then ``assign_slots`` and ``dispatch`` (the replica
     plan, each choice's slot, loads, each buffer row's choice and token,
     the inverse map) on seeded top-k choices, uniform,
     Zipf skewed and all first choices on one expert, at qwen2-moe-a2.7b's
     [4, 2048] x top-4 of 60 and at [8, 256] x top-2 of 16, extra_slots 0,
     8 and 16, capacity factors 1.25 and 1.0; then
     ``benchmarks/bench_moe_skew.py:22-40``'s cell on the port's weights
     (seed 0; 16 experts, top-2, d = 64, the router biased toward experts
     0 and 3, x [8, 256, 64] from ``default_rng(0)``): drop rate and
     slot-load imbalance at extra_slots 0 and 8, cf 1.25 and 1.0, replica
     slots dropping no more than the capacity router;
 28. qwen2-moe-a2.7b (``_full_size_phases``, as phases 42-56 below) at
     full width in fp32, cut to depth 4 (a full-depth fp32 copy is 57 GB;
     random weights from seed 0), capacity factor E / k = 15 so that nothing
     drops: ``forward_hidden`` of [2, 32] through K6 against the same call
     with K6's plain version (2e-4), token-by-token ``decode_step`` logits
     against the forward's at every position (2e-3), and six requests
     (prompts of 16 and 32 tokens, max_new 8) behind ``BucketServer``, each
     equal to ``greedy_generate`` alone; then one fp32 train step at depth 2
     on [2, 256] through K6 and K6b against autograd through plain
     attention: the loss (1e-5 relative), every gradient (1e-3 of each
     leaf's largest entry; router, experts, shared expert and its gate and
     wq/wk/wv nonzero), the params after AdamW (1e-3 of the update);
 29. bf16 serving at full width and depth, the MoE main path (14.3·10⁹
     parameters, built in bf16): a forward-only ``loss_fn`` over [4, 2048]
     (24 K6 launches a forward, asserted), then ``greedy_generate`` of 4
     prompts of 128 tokens with 32 new tokens; forward ms, ms per decode
     step, the host's PyTorch calls in a decode step, peak memory, the busy
     share of a forward and a decode step, time by CUDA function, and the
     forward's busy time by part (``record_function`` ranges around each
     step of ``moe_ffn``: expert GEMMs, K6, the router, the dispatch) with
     the dispatch's share on a line of its own; layer 0's drop rate and
     slot loads at extra_slots 0 and 8;
 30. bf16 training at full width cut to depth 4 (2.9·10⁹ parameters; fp32
     params, gradients, m and v take about 46 GB): ``make_train_step`` with
     extra_slots 8 and cf 1.25 on [4, 2048] tokens of ``TokenPipeline(seed=
     1)``, AdamW as phase 24: eight steps on one batch (the loss must
     fall); the first two steps run again from the same state (the state
     after them kept on the host) equal bit for bit in loss, params, m and
     v, and once more with autograd through plain attention (each loss
     within 2e-2 relative); ms a step, tokens/s, peak memory, K6/K6b
     launches a step, busy share and time by function, and ``mfu=`` by
     6·N_active·T of the cut config plus 12·D a kept (query, key) pair a
     head.
 32. the Zamba2 hybrid (``models.mamba2``, zamba2-2.7b: 54 Mamba2 layers,
     d = 2560, the shared attention-and-MLP block of 32 heads of 80 after
     every 6; ``_hybrid_phases``) at full width in fp32, cut to depth 12 (two
     invocations of the shared block; random weights from seed 0):
     ``forward_hidden`` of [2, 32] through K6 against the same call with
     K6's plain version (2e-4), token-by-token ``decode_step`` logits (the
     SSD's direct update) against the forward's (the chunked SSD) at every
     position (2e-3);
 33. one fp32 train step at that depth on [2, 256] through K6 and K6b
     against autograd through plain attention: the loss (1e-5 relative),
     every gradient (1e-3 of each leaf's largest entry, every leaf nonzero),
     the params after AdamW (1e-3 of the update); then
     ``compressed_tree_psum`` over that gradient tree on the one-rank NCCL
     group: each mean equal to ``dequantize(quantize(g))`` and each residual
     to g - mean, bit for bit;
 34. bf16 serving at full width and depth, the hybrid's main path (2.31·10⁹
     parameters, built in bf16): a forward-only ``loss_fn`` over [4, 2048]
     (9 K6 launches a forward on the ``bf16_wgmma`` route at D = 80,
     asserted), then ``greedy_generate`` of 4 prompts of 128 tokens with 32
     new tokens; forward ms, ms per decode step, the host's PyTorch calls in
     a decode step, peak memory, the busy share of a forward and a decode
     step, time by CUDA function, and the forward's busy time by part
     (``record_function`` ranges around ``mamba2.ssd``, ``_causal_conv`` and
     ``_shared_apply``) with the SSD's share on a line of its own;
 35. bf16 training at full width, cut to depth 18 for the script's time
     limit (three invocations of the shared block; fp32 params, gradients, m
     and v: about 13 GB) with ``make_train_step`` on [4, 2048] tokens of
     ``TokenPipeline(seed=1)``, AdamW as phase 24: eight steps on one batch
     (the loss must fall); the first two steps run again from the same state
     (kept on the host) equal bit for bit in loss, params, m and v; ms a
     step, tokens/s, peak memory, K6/K6b launches a step (6 and 3), busy
     share, the SSD's share and time by function, and ``mfu=`` by 6·N·T,
     N every matrix a token passes through (the shared block once an
     invocation), plus the attention term;
 36. K6 and K6b at the hybrid's shape, [4, 32, 2048, 80] causal bf16 (the
     ``wgmma`` route at D = 80; q, k, v of the shared block's first
     invocation): each against its plain version (2e-2; K6b also by
     relative norm, 1e-2), device time (a CUDA graph), plain time, SDPA's
     forward and backward, bound, the route's registers and spills
     (``-Xptxas -v``), and the yardstick of the wgmma kernels at D = 128 on
     q, k, v and dO zero-padded to 128 (the kernels alone, and the forward
     with the padding copies); the kernels line carries them as ``*_d80``.
 37. K7b, the recurrence's backward (``kernels.wkv6.wkv6_bwd``), against
     ``wkv6_bwd_ref`` on the card (``_rwkv_train_phases``): [4, 2048, 40] at
     hd 64 (the model's), hd 16, 80 and 72 (run padded to 128) and 128, L = 1,
     lengths around K7b's chunk of C = 32 tokens (C - 1, C, C + 1, 2C + 3) and
     ragged L, with and without s0 and dS_final, fp32 and bf16 inputs; every
     gradient within 2e-4 of its largest entry in fp32 (1e-2 in bf16: the
     gradients are rounded to bf16), two calls equal bit for bit; each
     instantiation's registers and spills (``-Xptxas -v``);
 38. one fp32 rwkv6-3b train step at full width, cut to depth 4, on [2, 256]
     through K7 and K7b (``Wkv6Fn``) against autograd through the plain
     recurrence: the loss (1e-5 relative), every gradient (1e-3 of each
     leaf's largest entry; every time-mix leaf nonzero), the params after
     AdamW (1e-3 of the update);
 39. rwkv6-3b bf16 training at full width and depth (fp32 params,
     gradients, m and v: about 49 GB) with ``make_train_step`` on [4, 2048]
     tokens of ``TokenPipeline(seed=1)``, AdamW as phase 24, through
     ``_train_bf16``: eight steps on one batch (the loss must fall), a traced
     ninth, two steps again from seed 0 equal bit for bit; ms a step,
     tokens/s, peak memory, K7 and K7b launches a step (64 and 32) and their
     share of busy time, ``mfu=`` by 6·N·T;
 40. K7b at the model's shape, [4, 2048, 40, 64] fp32 from zero: device time
     (a CUDA graph) and each pass's time an event (passes A and B,
     ``wkv6_bwd_state_kernel``; pass C, ``wkv6_bwd_chunk_kernel``; du), plain
     time, the function's bound and this design's own operations and bytes
     (no single PyTorch call computes it);
 41. the launcher (``_launcher_phase``): ``repro_torch.launch.train``'s
     ``main`` as a subprocess at a world of one (NCCL), OLMo-1B at full
     width cut to depth 2 for the script's time limit (at full depth one
     14.1 GB checkpoint took most of the phase's 112.6 s; the launcher
     takes no depth, so a bootstrap wraps its ``get_config``),
     three steps on [2, 512]: preempted by SIGTERM during its first step (a
     checkpoint of step 1, 2.8 GB, the phase's one save) and resumed with
     ``--resume`` to the end (one restore, no save); ``make_train_step``
     driven by hand, uninterrupted, in this process on the same batches
     gives the launcher's logged losses bit for bit: step 0's, and step 2's
     after the resume, which reads every restored parameter, moment and the
     step count.  The checkpoint under ``build/chip_smoke_launcher``,
     removed after;
 42-56. the five configurations the card had run only at reduced size, at
     full width (``_full_size_phases``, three phases each, in this order:
     qwen3-moe-30b-a3b 42-44, granite-3-8b 45-47, gemma3-4b 48-50,
     internvl2-1b 51-53, hubert-xlarge 54-56; random weights from seed 0):
     (a) fp32 cut to depth 2: ``forward_hidden`` of [2, 32] from the
     family's ``make_batch`` (internvl2: 8 patch embeddings ahead of the
     tokens; hubert: frames) through K6 against the same call with K6's
     plain version (2e-4); for the decoders, token-by-token ``decode_step``
     logits against the forward's over the tokens at every position (2e-3;
     MoE at a capacity factor of E / k, so that no choice can drop); one
     train step on [2, 256] through K6 and K6b against autograd through
     plain attention (``_step_vs_plain``; wq/wk/wv, and for MoE the router
     and experts, nonzero); (b) bf16 serving at full width and depth, built
     in bf16 on the card after the earlier phases' models are freed: the
     parameter count against ``ArchConfig.n_params()`` (which counts the
     matrices, and a gate hubert's MLP lacks), peak memory during the
     build, a forward-only ``loss_fn`` over [4, 2048] from ``make_batch``
     four times and once traced (K6 launches a forward asserted: 48, 40,
     0 (gemma3's windowed layers take the plain branches, as the reference
     routes them), 24, 48), and for the decoders ``greedy_generate`` of 4
     prompts of 16 tokens with 8 new (cut from phase 29's 128 and 32 for
     the script's time: the prompt is scanned one ``decode_step`` a token);
     for qwen3 the dispatch's share of the forward's busy time beside
     qwen2-moe-a2.7b's from phase 29 and layer 0's drop rate and slot-load
     imbalance at extra_slots 0 and 8; (c) bf16 training with
     ``make_train_step`` on [4, 2048] tokens of ``TokenPipeline(seed=1)``
     (internvl2: and 64 patch embeddings; hubert: frames and labels from
     ``make_batch``), AdamW as phase 24, MoE with extra_slots 8 at cf 1.25,
     at depth 4 (qwen3: 49.8 GB of fp32 params, gradients, m and v), 16
     (granite: 54.2 GB) and full depth (gemma3, internvl2, hubert), through
     ``_train_bf16``: eight steps on one batch (the loss must fall), a
     traced ninth, two again from seed 0 bit for bit, and the same two
     with autograd through plain attention (each loss within 2e-2 of the
     kernels', relative: a sound kernel path follows the plain one, also
     where the loss first rises; not for gemma3, whose path is the plain
     one); ``mfu=`` by 6 N T (N the matrices a position passes through,
     MoE's active ones) plus 12 D a kept (query, key) pair a head;
 57. K6 and K6b at each new shape, on layer 0's bf16 q, k, v of the serving
     batch (taken at the forward's first K6 call, which then stops), as
     phase 36: qwen3-moe-30b-a3b's [4, 32, 2048, 128] causal GQA 32:4 and
     granite-3-8b's GQA 32:8 (wgmma), internvl2-1b's [4, 14, 2112, 64]
     causal GQA 14:2 (wgmma, a ragged last tile), hubert-xlarge's [4, 16,
     2048, 80] non-causal (wgmma at D = 80): each against its plain version
     (2e-2; K6b also by relative norm, 1e-2), device time (a CUDA graph),
     plain time, SDPA's forward and backward (``enable_gqa`` under GQA),
     bound, the route's registers and spills, at D = 80 the padded-to-128
     yardstick; the kernels line carries them as ``*_qwen3``, ``*_granite``,
     ``*_internvl2`` and ``*_d80_noncausal``;
 58. tensor parallelism (``_tp_phase``): two ranks share this card over
     gloo (CUDA tensors), a (1, 2) ("data", "model") mesh,
     ``tools/tensor_parallel.py --smoke`` in two processes: olmo-1b at full
     width cut to depth 2, split over "model"
     (``build_model(cfg, tp=mesh)``), the residual stream's sequence split
     over the two ranks between blocks (sequence parallelism: each rank
     prints the stream's shape at a block's entry, [2, 128, 2048] in the
     fp32 loss, asserted).  Each rank
     holds the whole model on one rank, built beside it: the fp32 loss of
     [2, 256] tokens and the
     prefill logits of [2, 64] prompts (K6 on the rank's 8 heads) to 1e-4
     relative, 5 greedy tokens (the prefill's, then 4 decode steps) equal;
     two bf16 train steps on [2, 512] (K6 and K6b on the rank's heads) whose
     losses and global norms are the same bits on both ranks, the losses
     within 2e-2 of the whole model's, and before each step the split's
     bf16 gradients against the whole model's at the same weights (the
     norms within 2e-2, or twice the whole model's bf16 distance from its
     fp32 gradient; the split's distance from that fp32 gradient at most
     twice the whole model's plus 1e-2 of its norm), the replicated leaves the same bits on
     both (olmo-1b has none: its LayerNorm has no parameters and its table
     splits on the vocab); K6's and K6b's launches on each rank, counted
     over the split path alone; the phase's seconds;
 59. expert parallelism (``_ep_phase``): as phase 58, with
     ``tools/expert_parallel.py --smoke``: qwen2-moe-a2.7b at full width
     cut to depth 2 with 8 replica slots at capacity factor 1.25, split
     over "model" (30 experts and 4 replica slots a rank, the replica
     slots' weights fetched from their owners; the stream's sequence split
     as phase 58's, gathered before the router), against the whole model on
     one rank: the fp32 loss of [2, 256] tokens and the prefill
     logits (``moe.prefill``) of [2, 64] prompts to 1e-4 relative, each
     layer's integer dispatch (slot loads, drops, the replica slots'
     experts) equal, 5 greedy tokens equal; two bf16 train steps on [2,
     512] whose losses and global norms are the same bits on both ranks and
     within 2e-2 of the whole model's, the replicated leaves the same bits
     on both; K6's and K6b's launches on each rank over the split path
     alone; the phase's seconds.  The two ranks share the one-rank run
     (the first its checks, the second its steps), and phases 58 and 59
     run their four processes at once (their seconds overlap);
 60. tensor parallelism of the recurrent families (``_tp_recurrent_phase``):
     as phase 58, with ``tools/tensor_parallel.py --smoke --recurrent``:
     rwkv6-3b at full width cut to depth 2 (20 of its 40 heads a rank: K7,
     and K7b under a gradient, on [B, L, 20, 64]) and zamba2-2.7b cut to
     one group (6 Mamba2 layers, 40 of 80 SSM heads a rank, and the shared
     block: K6 and K6b at D = 80 on 16 of its 32 heads), the stream's
     sequence split as phase 58's ([2, 128, 2560] a rank), each against the
     whole model on one rank: the fp32 loss of [2, 256] tokens and the
     last position's logits of a forward over [2, 64] prompts to 1e-4
     relative, 5 greedy tokens after 8 prompt tokens equal, two bf16 steps
     on [2, 512] the same bits on both ranks, their losses within 2e-2 of
     the whole model's and their gradients held to the whole model's at the
     same weights (as phase 58's: ``tools/tensor_parallel.py::
     _same_weights``), the replicated leaves the same bits on both, K7/K7b (rwkv6)
     and K6/K6b (zamba2) launches on each rank over the split path alone;
     its two processes start when phases 58 and 59 have ended (six
     processes at once ran the card out of memory).

Every kernel's time is device time per call of everything the wrapper
launches, from CUDA events around the replay of a CUDA graph of repeated
calls: no host gaps and no trace.  Beside it a ``torch.profiler`` trace of
the same calls gives each CUDA function's time an event and the count of
its events against the calls (each ``[trace]`` line; one event of each
function a call, asserted).  Every trace starts with the profiler's own
warm-up step, since a trace taken after a long one loses its first few
device events; a long trace (a stream batch, an RWKV forward or decode
step) may still lose one, shown by the count of the port's kernels in it,
and its busy share then reads low.  The wrapper's time, host work
included, is CUDA events around repeated calls.

The training phases keep the state after two steps in page-locked host
blocks that each reuses (``_HostCopy``) and compare the second run's with
it on the card.

Prints a ``kernels`` JSON line (each entry's launches on the main path and
on each other path: ``launches_speculative``, ``launches_distributed``, ...,
``launches_hybrid``, ``launches_rwkv_train``, ``launches_launcher`` and
``launches_qwen3``, ``launches_granite``, ``launches_gemma3``,
``launches_internvl2``, ``launches_hubert`` (phases 43-44, ..., 55-56),
``launches_tp`` (phase 58, both ranks), ``launches_ep`` (phase 59, both ranks),
``launches_tp_recurrent`` (phase 60, both ranks and both configurations);
K7b's entry, ``wkv6_bwd``, counts phase 39's), each phase group's seconds,
and, last, ``{"ok": true, "device": ...}``.
Any failure raises and exits non-zero.  Needs one CUDA card.

Run from the root of a checkout:  python3 chip_smoke.py
"""
from __future__ import annotations

import contextlib
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM peaks (NVIDIA data sheet), at 700 W: HBM3 3.35 TB/s; int32:
# 64 results per clock per SM for 32-bit integer add and compare (CUDA C++
# Programming Guide, arithmetic instruction throughput, compute capability
# 9.0) x 132 SMs x 1.98 GHz boost (the data sheet's 67 TFLOP/s fp32 is 128
# lanes x 2 flop x the same clock)
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 64 * 132 * 1.98e9
BF16_FLOPS = 989e12  # dense tensor-core rate
FP32_FLOPS = 67e12  # CUDA cores, outside the tensor cores

# the CUDA functions of each source, as the profiler names them
JOIN_KERNELS = ("hash_join_kernel",)
CMS_KERNELS = ("cms_cluster_kernel", "cms_global_kernel")
INGEST_KERNELS = ("ingest_count_kernel", "ingest_scan_kernel", "ingest_rank_kernel",
                  *CMS_KERNELS)
TRACE_WARMUP = 256  # tiny kernels in the profiler's warm-up step before every trace
TRACE_PAD_S = 0.02  # host seconds idle at each end of a trace's active step
FLASH_KERNELS = ("flash_fwd_wgmma_kernel", "flash_fwd_bf16_kernel", "flash_fwd_f32_kernel")
FLASH_BWD_KERNELS = ("flash_bwd_delta_kernel", "flash_bwd_dkdv_wgmma_kernel",
                     "flash_bwd_dq_wgmma_kernel", "flash_bwd_dkdv_bf16_kernel",
                     "flash_bwd_dq_bf16_kernel", "flash_bwd_dkdv_f32_kernel",
                     "flash_bwd_dq_f32_kernel")
CKPT_DIR = ROOT / "build" / "chip_smoke_train_ckpt"  # phase 25's checkpoint (gitignored)
HIST_KERNELS = ("histogram_narrow_kernel", "histogram_sparse_kernel")
WKV_KERNELS = ("wkv6_split_kernel", "wkv6_step_kernel")
WKV_BWD_KERNELS = ("wkv6_bwd_state_kernel", "wkv6_bwd_chunk_kernel", "wkv6_bwd_du_kernel")
K6_SHARES = {"K6 forward": FLASH_KERNELS, "K6 backward": FLASH_BWD_KERNELS}
LAUNCHER_DIR = ROOT / "build" / "chip_smoke_launcher"  # phase 41's checkpoints (gitignored)
# moe_ffn's steps by the range each runs in under a trace (``_ranges``)
MOE_RANGES = {"moe.route": "route", "moe.dispatch": "dispatch", "moe.gather": "_gather",
              "moe.experts": "_expert_mlp", "moe.combine": "_combine"}
# the hybrid's parts likewise: the SSD recurrence, the causal conv, the
# shared attention-and-MLP block (K6 inside it)
HYBRID_RANGES = {"mamba2.ssd": "ssd", "mamba2.conv": "_causal_conv",
                 "mamba2.shared": "_shared_apply"}
# phases 42-56: the configurations run on the card at full size in this
# script alone, each with the K6 launches of a full-depth forward (none in
# gemma3's windowed layers) and the depth it trains at (None: full depth)
FULL_SIZE = (("qwen3-moe-30b-a3b", 48, 4), ("granite-3-8b", 40, 16), ("gemma3-4b", 0, None),
             ("internvl2-1b", 24, None), ("hubert-xlarge", 48, None))
RETAKEN: list[str] = []  # kernels whose trace lost device events and was taken again


def _say(*args) -> None:
    print(*args, flush=True)


def _events_ms(fn, reps: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _traced(fn, counts=None, spans=None):
    """(fn's result, device microseconds by CUDA function name) of one
    call of ``fn`` under ``torch.profiler``.  The profiler's own warm-up
    step, TRACE_WARMUP tiny kernels whose events it drops, comes first:
    without it a trace taken after a long one loses its first device
    records.  The active step also starts and ends with TRACE_PAD_S
    seconds of an idle card around ``fn``, so that no call's device records
    lie near the step's edges, where traces lost records now and then.  A dict given as ``counts`` receives the number
    of device events by name.  A dict given as ``spans`` (range name -> 0)
    receives the device microseconds of the kernels launched inside each
    ``record_function`` range of that name; the ranges' own device-side
    markers are not device work and stay out of the busy time.  Without
    ``spans`` the profiler records the device alone: parsing the host's
    events, which nothing here reads, took most of a train step's trace
    (PERF.md §6)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    ready = []
    warm = torch.zeros(1, device="cuda")
    activities = [ProfilerActivity.CUDA] if spans is None else [ProfilerActivity.CPU,
                                                                ProfilerActivity.CUDA]
    with profile(activities=activities,
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=lambda p: ready.append(p.events())) as prof:
        for _ in range(TRACE_WARMUP):
            warm.add_(1)
        torch.cuda.synchronize()
        prof.step()
        time.sleep(TRACE_PAD_S)
        out = fn()
        torch.cuda.synchronize()
        time.sleep(TRACE_PAD_S)
        prof.step()
    us: dict[str, float] = {}
    for ev in ready[0]:
        if spans is not None and ev.name in spans:
            if ev.device_type == DeviceType.CPU:
                spans[ev.name] += ev.device_time_total
            continue
        # the step's own span is an annotation, not device work
        if ev.device_type == DeviceType.CUDA and not ev.name.startswith("ProfilerStep"):
            us[ev.name] = us.get(ev.name, 0.0) + ev.time_range.elapsed_us()
            if counts is not None:
                counts[ev.name] = counts.get(ev.name, 0) + 1
    return out, us


def _graph_ms(fn, reps: int) -> float:
    """Device ms per call of ``fn``, host gaps excluded: ``reps`` calls
    captured in a CUDA graph after a warm-up call, the graph replayed once
    to warm it and once between CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    stop.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(stop) / reps


def _kernel_ms(fn, names, reps: int):
    """(ms, ms an event by function, wrapper ms) of the CUDA functions of
    ``fn`` whose names contain one of ``names``.  ms is device time a call,
    by replaying a CUDA graph of ``reps`` calls (``_graph_ms``).  ms an
    event is each function's device time over its events in a profiler
    trace of ``reps`` calls, which must hold one event of each function a
    call (printed, and asserted).  The wrapper's time is CUDA events
    around ``reps`` calls, host gaps included."""
    import torch

    ms = _graph_ms(fn, reps)
    wrapper = _events_ms(fn, reps)

    def calls():
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()

    for attempt in range(3):
        counts: dict[str, int] = {}
        _, us = _traced(calls, counts)
        mine = [k for k in us if any(nm in k for nm in names)]
        if mine and all(counts[k] == reps for k in mine):
            break
        # a trace now and then loses some or all of its device events
        # (PERF.md §7): say so and take it again; the one kept must be
        # whole, and a run that has to retake more than one trace fails at
        # its end
        RETAKEN.append("/".join(names))
        _say(f"[trace] the trace of {reps} calls of {'/'.join(names)} held "
             f"{ {k: counts[k] for k in mine} } of its events ({sum(counts.values())} device "
             f"events in all; attempt {attempt + 1}); tracing again")
    per_event = {k: us[k] / 1e3 / counts[k] for k in mine}
    _say(f"[trace] {sum(counts[k] for k in mine)} device events of {'/'.join(names)} in the "
         f"trace of {reps} calls ({sum(counts.values())} device events in all); "
         + "; ".join(f"{_short({k: per_event[k]})} ms each over {counts[k]}" for k in mine))
    assert mine and all(counts[k] == reps for k in mine), (counts, reps)
    return ms, per_event, wrapper


def _short(by_fn) -> str:
    out = []
    for k, v in by_fn.items():
        nm = k.split("(")[0] if "(anonymous namespace)::" not in k else \
            k.split("(anonymous namespace)::")[1].split("(")[0]
        out.append(f"{nm} {v:.4f}")
    return ", ".join(out)


def _plain_ms(fn):
    """(result, ms) of one call of a plain version on the card, host clock
    around a synchronised call, after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t) * 1e3


def _bound(ops: float, n_bytes: float, ops_per_s: float = INT32_OPS_PER_S) -> tuple[float, str]:
    t_ops = ops / ops_per_s * 1e3
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _join_work(r_keys, r_w, s_keys, s_w) -> tuple[float, float, float, float]:
    """(int32 operations, bytes, bytes of every slot, nested-loop
    operations) of one block join on these inputs.  The function's work: an
    aggregate by key, about C + 3 operations a valid row of either side
    (hash the C columns, compare them, add the count and the weight, or
    multiply-add on a hit); every weight read once, the C keys of the valid
    rows only (a padding slot's key is never needed), both [K] outputs
    written once.  Every slot's keys and weights, the earlier statement of
    the bytes, and the nested loop's operations, the bound of the earlier
    kernel (C compares and two adds a pair of valid slots), are returned
    for comparison."""
    c = r_keys.shape[-1]
    n_r = (r_w > 0).sum(dim=-1).double()
    n_s = (s_w > 0).sum(dim=-1).double()
    rows = float((n_r + n_s).sum())
    out = 8 * r_w.shape[0]
    n_bytes = 4 * (r_w.numel() + s_w.numel()) + 4 * c * rows + out
    all_slots = 4 * (r_keys.numel() + r_w.numel() + s_keys.numel() + s_w.numel()) + out
    return rows * (c + 3), float(n_bytes), float(all_slots), float((n_r * n_s).sum()) * (c + 2)


def _max_abs_err(got, want) -> int:
    """Largest |got - want| over paired tensors (None pairs with None);
    shapes must agree."""
    err = 0
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if w is None:
            continue
        assert g.shape == w.shape, (tuple(g.shape), tuple(w.shape))
        if w.numel():
            err = max(err, int((g.long() - w.long()).abs().max()))
    return err


def _zipf_batch(rng, shift, n_r, n_s, domain, a):
    """benchmarks/bench_stream.py's stream: R(A, B), S(B, C) with Zipf B."""
    import numpy as np

    b_r = ((rng.zipf(a, n_r) - 1) + shift) % domain
    b_s = ((rng.zipf(a, n_s) - 1) + shift) % domain
    r = np.stack([rng.integers(0, domain, n_r), b_r], 1).astype(np.int64)
    s = np.stack([b_s, rng.integers(0, domain, n_s)], 1).astype(np.int64)
    return {"R": r, "S": s}


def _skewed_plan(query, q):
    """A small plan with pinned heavy hitters, so pins and excludes route."""
    import numpy as np

    from repro_torch.core import plan_shares_skew

    rng = np.random.default_rng(7)
    data = {r.name: rng.integers(0, 50, (600, r.arity)).astype(np.int64)
            for r in query.relations}
    for r in query.relations:
        data[r.name][:300, -1] = 7
    return plan_shares_skew(query, data, q=q)


def _ingest_work(rows, enc, dest, n_sketch_cols, depth, width, k):
    """(int32 operations, bytes) of one fused ingest pass on these inputs.

    Operations: per (row, live column) one compare for each pin and each
    exclude value that is on, and for each emission the row does make, 12
    per hashed term (9 for mix32's xors, shifts and multiplies, then the
    modulo, the multiply by the stride and the add) and 2 to rank and count
    it; a padded column costs one compare per row; the Count-Min half
    costs 11 per row, column and sketch row (mix32, modulo, add).  Bytes:
    the rows and the encoding read once; dest and rank over the live
    columns, counts [k] and the Count-Min tables written once."""
    import numpy as np

    n = rows.shape[0]
    live = np.asarray(enc["col_valid"]) != 0
    checks = enc["p_on"].sum(-1) + enc["e_on"].sum((-1, -2))
    hashed = (enc["h_stride"] != 0).sum(-1)
    emitted = (dest >= 0).sum(0).cpu().numpy().astype(np.float64)
    ops = float(n * (checks[live].sum() + (~live).sum()))
    ops += float((emitted * (12 * hashed + 2)).sum())
    ops += 11.0 * n * n_sketch_cols * depth
    n_bytes = 4 * (rows.numel() + sum(np.asarray(v).size for v in enc.values())
                   + 2 * n * int(live.sum()) + k + n_sketch_cols * depth * width)
    return ops, float(n_bytes)


def _max_float_err(got, want) -> float:
    assert got.shape == want.shape and got.dtype == want.dtype, (got.shape, want.shape)
    return float((got.float() - want.float()).abs().max())


def _rel_norm_err(got, want) -> float:
    """||got - want|| / ||want|| over every entry, in fp32."""
    g, w = got.float(), want.float()
    return float((g - w).norm() / w.norm().clamp(min=1e-30))


def _close(got, want, tol: float) -> bool:
    """|got - want| <= tol + tol |want| everywhere: the JAX package's
    kernel tests' rtol = atol = tol."""
    g, w = got.float(), want.float()
    return bool(((g - w).abs() <= tol + tol * w.abs()).all())


def _ptxas_regs(log: str, kernel: str):
    """Registers a thread of the first kernel whose mangled name contains
    ``kernel``, from ``nvcc -Xptxas -v``'s lines (None if absent)."""
    import re

    name = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and name and kernel in name:
            return int(m.group(1))
    return None


def _ptxas_spills(log: str, kernel: str):
    """(spill store bytes, spill load bytes) of the first kernel whose
    mangled name contains ``kernel``, from ``nvcc -Xptxas -v``'s lines
    (None if absent)."""
    import re

    name = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name and kernel in name:
            return int(m.group(1)), int(m.group(2))
    return None


def _flash_work(b, h, l, d, causal, elem_bytes, hkv=None):
    """(operations, bytes) of one attention forward: 4 D per (query, key)
    pair that the mask keeps (two products, a multiply and an add each),
    q and o (``h`` heads) and k and v (``hkv`` heads, default ``h``) moved
    once."""
    pairs = b * h * (l * (l + 1) // 2 if causal else l * l)
    return 4.0 * d * pairs, 2.0 * b * (h + (hkv or h)) * l * d * elem_bytes


def _wkv_work(b, l, h, hd, with_state):
    """(fp32 operations, bytes) of one wkv6 call: per (b, t, h), 5 hd^2 for
    y's sums r_i S_ij (a multiply and an add) and the state update
    w_i S_ij + k_i v_j (two multiplies and an add), and 5 hd for the bonus
    (r_i u_i k_i: two multiplies and an add; v_j times it, added to y_j).
    Bytes: r, k, v, w read and y written once, u read, the final state
    written once and, when given, the initial state read once."""
    n = b * l * h
    state = 4.0 * b * h * hd * hd
    return float(n * (5 * hd * hd + 5 * hd)), 20.0 * n * hd + 4.0 * h * hd + state * (
        2 if with_state else 1)


def _lm_phases(dev, r_col):
    """Phases 11-16; returns the kernels line's K6 and K5 entries."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import histogram as hg
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.models import build_model, layers
    from repro_torch.models import transformer as tt
    from repro_torch.serve import BucketServer, Request, greedy_generate, scan_prefill

    torch.backends.cuda.matmul.allow_tf32 = False  # fp32 phases: full fp32, no TF32
    torch.backends.cudnn.allow_tf32 = False
    f32, bf16 = torch.float32, torch.bfloat16

    # ---- 11. K6 against its plain version -----------------------------------
    olmo_qkv = None
    for b, h, hkv, lq, lk, d, causal, dtype, view in [
        (1, 2, 2, 128, 128, 32, True, f32, False), (2, 4, 2, 128, 128, 64, True, f32, False),
        (1, 8, 1, 256, 256, 32, True, f32, False), (2, 2, 2, 128, 128, 32, False, f32, False),
        (1, 4, 4, 64, 64, 16, True, f32, False), (2, 4, 2, 200, 200, 64, True, f32, False),
        (1, 32, 8, 512, 512, 128, True, bf16, False),
        # the wgmma kernel: D = 64, 80 and 128, ragged L, GQA 4, Lq != Lk,
        # the attention layer's [B, L, H, D] views
        (2, 4, 4, 200, 200, 64, True, bf16, False), (1, 8, 8, 1000, 1000, 128, True, bf16, False),
        (2, 16, 4, 130, 130, 80, True, bf16, False), (1, 4, 4, 77, 300, 80, False, bf16, False),
        (2, 16, 16, 333, 333, 80, False, bf16, True),
        (2, 16, 4, 256, 256, 128, True, bf16, False), (2, 8, 2, 1000, 1000, 64, True, bf16, False),
        (2, 4, 4, 77, 300, 128, False, bf16, False), (1, 4, 2, 300, 77, 64, False, bf16, False),
        (2, 16, 4, 333, 333, 128, True, bf16, True), (2, 8, 2, 200, 200, 64, True, bf16, True),
        (2, 4, 4, 200, 200, 96, True, bf16, False),  # a head dim for mma.sync
        # D = 40, no multiple of 16: q, k, v zero-padded to 48, scale 1/sqrt(40)
        (2, 8, 2, 200, 200, 40, True, f32, False), (2, 8, 2, 200, 200, 40, True, bf16, True),
        (1, 4, 4, 77, 130, 40, False, bf16, False),
        (4, 16, 16, 2048, 2048, 128, True, bf16, False),
    ]:
        g = torch.Generator(device=dev).manual_seed(b * 1000 + h + lq + lk + d)
        if view:  # [B, L, H, D] projections seen as [B, H, L, D], as the layer passes them
            q, k, v = (torch.randn(s, generator=g, device=dev, dtype=f32).to(dtype).transpose(1, 2)
                       for s in ((b, lq, h, d), (b, lk, hkv, d), (b, lk, hkv, d)))
        else:
            q, k, v = (torch.randn(s, generator=g, device=dev, dtype=f32).to(dtype)
                       for s in ((b, h, lq, d), (b, hkv, lk, d), (b, hkv, lk, d)))
        n0 = launches()["flash_attention"]
        got = fa.flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        assert launches()["flash_attention"] == n0 + 1
        want = fa.flash_attention_ref(q, k, v, causal=causal)
        err = _max_float_err(got, want)
        tol = 2e-5 if dtype == f32 else 2e-2
        _say(f"[check] flash_attention ({fa.kernel_variant(dtype, fa.padded_head_dim(d))}"
             f"{f' at D={fa.padded_head_dim(d)}, padded' if d % 16 else ''}) q {(b, h, lq, d)} "
             f"k {(b, hkv, lk, d)} causal={causal} {str(dtype)[6:]}"
             f"{' [B, L, H, D] views' if view else ''}: max_abs_err={err:.3g} "
             f"(rtol = atol = {tol})")
        assert _close(got, want, tol)
        if lq == 2048:
            olmo_qkv, olmo_err = (q, k, v), err

    # ---- 12. K5 against its plain version -----------------------------------
    # values below 0 and at or above num_bins (dropped), a quarter on one
    # value, or all on one; both sides of the shared-memory kernel's range
    # (12,288 bins), the §9.1 range and 2^20 bins; N empty, one, ragged
    for n in (0, 1, 4097, 1_000_003):
        for bins in (1, 513, 12_288, 12_289, 100_000, 1 << 20):
            for equal in (False, True):
                vals = np.random.default_rng(n + bins).integers(-3, bins + 5, n)
                vals[: n if equal else n // 4] = bins // 2
                vals = torch.from_numpy(vals.astype(np.int32)).to(dev)
                got = hg.histogram(vals, bins)
                torch.cuda.synchronize()
                err = _max_abs_err([got], [hg.histogram_ref(vals, bins)])
                _say(f"[check] histogram N={n} bins={bins}{' all equal' if equal else ''}: "
                     f"max_abs_err={err}")
                assert err == 0
    hh_vals = torch.from_numpy(r_col.astype(np.int32)).to(dev)
    hh = hg.histogram(hh_vals, 100_000)
    torch.cuda.synchronize()
    hh_want, hist_plain = _plain_ms(lambda: hg.histogram_ref(hh_vals, 100_000))
    hist_err = _max_abs_err([hh], [hh_want])
    top = torch.topk(hh, 3)
    _say(f"[check] histogram of the §9.1 R join column (N={hh_vals.shape[0]}, 100,000 bins): "
         f"max_abs_err={hist_err}; heaviest values {top.indices.tolist()} with counts "
         f"{top.values.tolist()}")
    assert hist_err == 0 and int(top.indices[0]) == 7

    # ---- 13. OLMo-1B at full width in fp32: prefill (K6) against scan ---------
    cfg = get_config("olmo-1b")
    model = build_model(cfg, device=dev)
    t = time.perf_counter()
    params = model.init_params(0, dtype=f32)
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in [params["embed"]["table"]] + [
        w for blk in params["blocks"] for part in ("attn", "mlp") for w in blk[part].values()])
    _say(f"[lm] olmo-1b at full width: {cfg.n_layers} layers d={cfg.d_model} "
         f"heads={cfg.n_heads}x{cfg.hd} ff={cfg.d_ff} vocab={cfg.vocab}; {n_params} "
         f"parameters, fp32 init {time.perf_counter() - t:.2f} s")
    gen = np.random.default_rng(0)
    prompts = torch.from_numpy(gen.integers(0, cfg.vocab, (2, 256)).astype(np.int32)).to(dev)
    nxt = torch.from_numpy(gen.integers(0, cfg.vocab, (2, 1)).astype(np.int32)).to(dev)
    reset_launches()
    cache_a = model.init_cache(2, 264, dtype=f32)
    logits_a, _ = tt.prefill(cfg, params, prompts, cache_a, dtype=f32)
    assert launches()["flash_attention"] == cfg.n_layers, launches()
    t = time.perf_counter()
    cache_b = model.init_cache(2, 264, dtype=f32)
    logits_b, _ = scan_prefill(model, params, cache_b, prompts, dtype=f32)
    torch.cuda.synchronize()
    t_scan = time.perf_counter() - t
    assert launches()["flash_attention"] == cfg.n_layers, "scan_prefill reached K6"
    err_logits = _max_float_err(logits_a, logits_b)
    err_cache = _max_float_err(cache_a["k"], cache_b["k"])
    step_a, _ = model.decode_step(params, cache_a, nxt, 256, dtype=f32)
    step_b, _ = model.decode_step(params, cache_b, nxt, 256, dtype=f32)
    err_step = _max_float_err(step_a, step_b)
    _say(f"[lm] fp32 prefill {list(prompts.shape)} (K6) vs scan_prefill ({t_scan:.2f} s, "
         f"{prompts.shape[1]} decode steps): "
         f"logits max_abs_err={err_logits:.3g}, k cache {err_cache:.3g}, one decode step "
         f"after {err_step:.3g} (tolerance 2e-3); logits scale "
         f"{float(logits_a.abs().max()):.3g}")
    assert torch.isfinite(logits_a).all() and logits_a.shape == (2, cfg.vocab)
    assert max(err_logits, err_cache, err_step) <= 2e-3
    hid = model.forward_hidden(params, {"tokens": prompts}, dtype=f32)
    layers.flash_attention = fa.flash_attention_ref  # the same call, plain attention
    try:
        hid_plain = model.forward_hidden(params, {"tokens": prompts}, dtype=f32)
    finally:
        layers.flash_attention = fa.flash_attention
    err_hid = _max_float_err(hid, hid_plain)
    _say(f"[lm] fp32 forward_hidden {list(prompts.shape)} through K6 vs plain attention: "
         f"max_abs_err={err_hid:.3g} (tolerance 2e-4)")
    assert err_hid <= 2e-4

    # ---- 14. BucketServer in fp32: every completion equals solo generation ----
    server = BucketServer(model, params, max_batch=8, dtype=f32)
    reqs = [Request(uid=i, prompt=gen.integers(0, cfg.vocab, 16 if i % 2 else 32)
                    .astype(np.int32), max_new=8) for i in range(6)]
    for r in reqs:
        server.submit(r)
    t = time.perf_counter()
    done = server.drain()
    t_drain = time.perf_counter() - t
    assert sorted(c.uid for c in done) == list(range(6))
    for c in done:
        solo = greedy_generate(model, params, reqs[c.uid].prompt[None], 8, dtype=f32)
        assert c.tokens.shape == (8,) and np.array_equal(c.tokens, solo[0]), \
            (c.uid, c.tokens, solo[0])
    _say(f"[lm] BucketServer fp32: 6 requests (prompts of 16 and 32 tokens, max_new=8) "
         f"drained in two waves in {t_drain:.2f} s; each completion equals greedy_generate "
         f"of its prompt alone")
    del params, cache_a, cache_b, server

    # ---- 15. bf16 serving: prefill [4, 2048] + 32 greedy decode steps ---------
    torch.cuda.empty_cache()
    params = model.init_params(0, dtype=bf16)
    batch, l_prompt, n_new = 4, 2048, 32
    prompts = torch.from_numpy(gen.integers(0, cfg.vocab, (batch, l_prompt))
                               .astype(np.int32)).to(dev)
    cache = model.init_cache(batch, l_prompt + n_new, dtype=bf16)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    def do_prefill():
        t = time.perf_counter()
        out, _ = tt.prefill(cfg, params, prompts, cache, dtype=bf16)
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t) * 1e3

    reset_launches()
    n_prefill = 0
    prefill_ms = []
    for _ in range(4):  # the first is a warm-up
        logits, ms = do_prefill()
        prefill_ms.append(ms)
        n_prefill += 1
    for attempt in range(3):
        n_ev_pre: dict[str, int] = {}
        (logits, ms_traced), busy_pre = _traced(do_prefill, n_ev_pre)
        n_prefill += 1
        n_k6 = sum(n for k, n in n_ev_pre.items() if any(nm in k for nm in FLASH_KERNELS))
        if n_k6 == cfg.n_layers:
            break
        # a trace now and then loses device events (PERF.md §7): say so and
        # take it again; the one kept must be whole, and a run that has to
        # retake more than one trace fails at its end
        RETAKEN.append("prefill")
        _say(f"[trace] the prefill's trace held {n_k6} of its {cfg.n_layers} K6 events "
             f"(attempt {attempt + 1}); tracing again")
    tok = torch.argmax(logits, -1).to(torch.int32)
    out = [tok]
    step_ms = []
    for pos in range(l_prompt, l_prompt + n_new - 1):
        t = time.perf_counter()
        logits, _ = model.decode_step(params, cache, tok[:, None], pos, dtype=bf16)
        tok = torch.argmax(logits, -1).to(torch.int32)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        out.append(tok)
    lm_launches = launches()
    peak = torch.cuda.max_memory_allocated()
    gen_tokens = torch.stack(out, 1)

    def one_step():
        t = time.perf_counter()
        lg, _ = model.decode_step(params, cache, tok[:, None], l_prompt + n_new - 1, dtype=bf16)
        torch.cuda.synchronize()
        return lg, (time.perf_counter() - t) * 1e3

    (_, ms_step_traced), busy_dec = _traced(one_step)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        one_step()
    n_calls = sum(1 for ev in prof.events() if ev.cpu_parent is None)
    _say(f"[lm] one decode step makes {n_calls} top-level PyTorch calls on the host "
         f"({cfg.n_layers} layers)")
    _say(f"[lm] bf16 serving olmo-1b: prefill [{batch}, {l_prompt}] ms "
         f"{[round(x, 3) for x in prefill_ms]} (first is the warm-up); {n_new} greedy tokens "
         f"per sequence: first from the prefill, then {len(step_ms)} decode steps, ms per step "
         f"({batch} sequences) median {float(np.median(step_ms)):.3f} min {min(step_ms):.3f} "
         f"max {max(step_ms):.3f}; {float(np.median(step_ms)) / batch:.3f} ms per token")
    _say(f"[lm] generated tokens (sequence 0): {gen_tokens[0].tolist()}")
    _say(f"[lm] peak device memory {peak} bytes ({peak / 2**30:.2f} GiB); launches={lm_launches}")
    for what, busy, wall in [("prefill", busy_pre, ms_traced), ("decode step", busy_dec,
                                                                  ms_step_traced)]:
        assert busy, f"the {what}'s profiler trace holds no device events"
        b_ms = sum(busy.values()) / 1e3
        _say(f"[lm] one {what} under the profiler: device busy {b_ms:.3f} ms of {wall:.3f} ms "
             f"({100 * b_ms / wall:.2f} %, idle {100 - 100 * b_ms / wall:.2f} %); by function "
             "(ms): " + "; ".join(f"{k[:60]} {v / 1e3:.3f}" for k, v in
                                  sorted(busy.items(), key=lambda kv: -kv[1])[:6]))
    assert torch.isfinite(logits).all() and gen_tokens.shape == (batch, n_new)
    assert lm_launches["flash_attention"] == cfg.n_layers * n_prefill, lm_launches
    # K6 in the prefill's trace, by CUDA function: the wgmma kernel, one event a layer
    k6_pre = {k: v for k, v in busy_pre.items() if any(nm in k for nm in FLASH_KERNELS)}
    assert k6_pre and all("flash_fwd_wgmma_kernel" in k for k in k6_pre), k6_pre
    n_k6_pre = sum(n_ev_pre[k] for k in k6_pre)
    assert n_k6_pre == cfg.n_layers, (n_k6_pre, cfg.n_layers)
    k6_in_prefill = sum(k6_pre.values()) / 1e3 / n_k6_pre
    _say(f"[lm] K6 in the prefill's trace: {_short({k: v / 1e3 for k, v in k6_pre.items()})} "
         f"ms over {n_k6_pre} events ({cfg.n_layers} layers), {k6_in_prefill:.4f} ms a call, "
         f"{100 * sum(k6_pre.values()) / sum(busy_pre.values()):.2f} % of the device's busy time")
    del params, cache
    torch.cuda.empty_cache()

    # ---- 16. K6 and K5 at the main path's shapes -----------------------------
    q, k, v = olmo_qkv
    ms6, ev6, wrap6 = _kernel_ms(lambda: fa.flash_attention(q, k, v), FLASH_KERNELS, reps=10)
    _, plain6 = _plain_ms(lambda: fa.flash_attention_ref(q, k, v))
    lib6 = _events_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, is_causal=True), reps=10)
    ops6, bytes6 = _flash_work(*q.shape[:3], q.shape[3], True, q.element_size())
    bound6, by6 = _bound(ops6, bytes6, BF16_FLOPS)
    regs6 = _ptxas_regs(_build.build_all(["flash_attention"])["flash_attention"].ptxas,
                        "flash_fwd_wgmma_kernelILi128E")
    _say(f"[K6] flash_attention {tuple(q.shape)} bf16 causal "
         f"({fa.kernel_variant(q.dtype, q.shape[3])}, {regs6} registers a thread at launch): "
         f"kernel {ms6:.4f} ms (CUDA graph of 10 calls; {_short(ev6)} ms an event in a trace; "
         f"wrapper {wrap6:.4f} ms; in the prefill's trace {k6_in_prefill:.4f} ms a call); plain "
         f"{plain6:.2f} ms; "
         f"scaled_dot_product_attention "
         f"{lib6:.4f} ms; bound {bound6:.4f} ms by {by6} ({ops6:.4g} operations at 989 TFLOP/s, "
         f"{bytes6:.4g} bytes); {100 * bound6 / ms6:.1f} % of the bound; the mma.sync kernel it "
         f"replaces took 0.8505-0.8798 ms (PERF.md)")
    q32, k32, v32 = (x.float() for x in olmo_qkv)  # the fp32 kernel (CUDA cores), same shape
    ms6f, ev6f, wrap6f = _kernel_ms(lambda: fa.flash_attention(q32, k32, v32), FLASH_KERNELS,
                                    reps=5)
    _say(f"[K6] flash_attention {tuple(q.shape)} fp32 causal (CUDA cores): kernel {ms6f:.4f} ms "
         f"(CUDA graph of 5 calls; {_short(ev6f)} ms an event in a trace; wrapper {wrap6f:.4f} "
         "ms)")
    del q32, k32, v32
    ms5, ev5, wrap5 = _kernel_ms(lambda: hg.histogram(hh_vals, 100_000), HIST_KERNELS, reps=20)
    lib5 = _events_ms(lambda: torch.bincount(hh_vals, minlength=100_000), reps=20)
    bound5, by5 = _bound(2.0 * hh_vals.shape[0], 4.0 * (hh_vals.shape[0] + 100_000))
    _say(f"[K5] histogram N={hh_vals.shape[0]} bins=100000: kernel {ms5:.4f} ms (CUDA graph "
         f"of 20 calls; {_short(ev5)} ms an event in a trace; wrapper {wrap5:.4f} ms); plain "
         f"{hist_plain:.3f} ms; torch.bincount {lib5:.4f} ms; bound {bound5:.5f} ms by {by5}; "
         f"the PR 13 kernel took 0.0562-0.0581 ms (PERF.md)")
    return [{
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:91",
        "launches": lm_launches["flash_attention"], "max_abs_err": olmo_err,
        "ms": ms6, "plain_ms": plain6, "bound_ms": bound6, "bound_by": by6,
        "library_ms": lib6,
    }, {
        "name": "histogram", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/histogram.cu",
        "replaces": "src/repro/kernels/histogram.py:35",
        "launches": lm_launches["histogram"], "max_abs_err": hist_err,
        "ms": ms5, "plain_ms": hist_plain, "bound_ms": bound5, "bound_by": by5,
        "library_ms": lib5,
    }]


def _rwkv_phases(dev):
    """Phases 17-21; returns the kernels line's K7 entry."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import _build, launches, reset_launches
    from repro_torch.kernels import wkv6 as wk
    from repro_torch.models import build_model, layers, rwkv6
    from repro_torch.serve import BucketServer, Request, greedy_generate

    torch.backends.cuda.matmul.allow_tf32 = False
    f32, bf16 = torch.float32, torch.bfloat16
    tol = 2e-4  # the JAX package's wkv6 kernel tests

    def wkv_inputs(b, l, h, hd, seed):
        """r, k, v, w, u, s0 drawn as the JAX kernel tests draw them: k
        scaled by 0.3, w in (0.6, 0.999), u != 0."""
        g = torch.Generator(device=dev).manual_seed(seed)
        r, k, v = (torch.randn((b, l, h, hd), generator=g, device=dev) for _ in range(3))
        w = 0.6 + 0.399 * torch.rand((b, l, h, hd), generator=g, device=dev)
        u = 0.1 * torch.randn((h, hd), generator=g, device=dev)
        s0 = 0.5 * torch.randn((b, h, hd, hd), generator=g, device=dev)
        return r, 0.3 * k, v, w, u, s0

    # ---- 17. K7 against its plain version -----------------------------------
    for b, l, h, hd, with_s0 in [(1, 64, 2, 16, False), (2, 100, 4, 16, False),
                                 (2, 128, 4, 32, True), (2, 77, 3, 16, True),
                                 (2, 77, 3, 48, True), (2, 77, 3, 128, True),
                                 (4, 1, 40, 64, True), (4, 2048, 40, 64, False),
                                 # hd = 24, no multiple of 16: run padded to 32
                                 (2, 77, 3, 24, True), (2, 1, 3, 24, True)]:
        r, k, v, w, u, s0 = wkv_inputs(b, l, h, hd, b * 1000 + l + hd)
        s0 = s0 if with_s0 else None
        y, s = wk.wkv6(r, k, v, w, u, s0)
        torch.cuda.synchronize()
        y_want, s_want = wk.wkv6_ref(r, k, v, w, u, s0)
        err = max(_max_float_err(y, y_want), _max_float_err(s, s_want))
        _say(f"[check] wkv6 {(b, l, h, hd)} (JC, P, C) = {wk.launch_geometry(hd, l)} "
             f"s0={'given' if with_s0 else 'zero'}: max_abs_err={err:.3g} over y and the state "
             f"(|y| up to {float(y_want.abs().max()):.3g}; rtol = atol = {tol})")
        assert _close(y, y_want, tol) and _close(s, s_want, tol)
        if l == 2048:
            fwd_in, fwd_err, fwd_want = (r, k, v, w, u), err, (y_want, s_want)
    built7 = _build.build_all(["wkv6"])["wkv6"]
    log7, lib7 = built7.ptxas, built7.path.read_bytes()
    for hd in wk.HEAD_DIMS:  # the decode step's L = 1, the state in place, every hd
        r, k, v, w, u, s0 = wkv_inputs(2, 1, 3, hd, 17 + hd)
        y_want, s_want = wk.wkv6_ref(r, k, v, w, u, s0)
        buf = s0.clone()
        y, s = wk.wkv6(r, k, v, w, u, buf, state_out=buf)
        torch.cuda.synchronize()
        err = max(_max_float_err(y, y_want), _max_float_err(buf, s_want))
        jc, p, c = wk.launch_geometry(hd)
        name = f"wkv6_split_kernelILi{hd}ELi{jc}ELi{p}ELi{c}E"
        assert name.encode() in lib7, f"no split kernel <{hd}, {jc}, {p}, {c}> in wkv6's library"
        regs = _ptxas_regs(log7, name)
        _say(f"[check] wkv6 (2, 1, 3, {hd}) with the state in place (the step kernel, "
             f"{_ptxas_regs(log7, f'wkv6_step_kernelILi{hd}E')} registers): max_abs_err="
             f"{err:.3g}; hd={hd} sequences take (JC, P, C) = {(jc, p, c)}, {regs} registers")
        assert s.data_ptr() == buf.data_ptr()
        assert _close(y, y_want, tol) and _close(buf, s_want, tol)
    r, k, v, w, u = fwd_in
    y, s = wk.wkv6(r, k, v, w, u)
    half = r.shape[1] // 2
    state = torch.zeros_like(s)
    y1, _ = wk.wkv6(r[:, :half], k[:, :half], v[:, :half], w[:, :half], u, state,
                    state_out=state)
    y2, _ = wk.wkv6(r[:, half:], k[:, half:], v[:, half:], w[:, half:], u, state,
                    state_out=state)
    torch.cuda.synchronize()
    err2 = max(_max_float_err(torch.cat([y1, y2], 1), y), _max_float_err(state, s))
    _say(f"[check] wkv6 one pass of L={r.shape[1]} vs two of {half} with the state carried "
         f"in place: max_abs_err={err2:.3g}")
    assert _close(torch.cat([y1, y2], 1), y, tol) and _close(state, s, tol)
    dec_in = wkv_inputs(4, 1, 40, 64, 7)

    # ---- 18. rwkv6-3b at full width in fp32: forward (K7) against decode ------
    cfg = get_config("rwkv6-3b")
    model = build_model(cfg, device=dev)

    def end_to_end(params, prompts):
        """Max |error| over every position between forward_hidden's logits
        and token-by-token decode_step's, and between forward_hidden through
        K7 and through the plain recurrence; the logits' scale."""
        hid = model.forward_hidden(params, {"tokens": prompts}, dtype=f32)
        want = hid @ params["lm_head"]["w"]  # [B, L, V]
        assert torch.isfinite(want).all() and want.shape == (*prompts.shape, cfg.vocab)
        state = model.init_cache(prompts.shape[0], dtype=f32)
        err_dec = 0.0
        for pos in range(prompts.shape[1]):
            logits, state = model.decode_step(params, state, prompts[:, pos:pos + 1], pos,
                                              dtype=f32)
            err_dec = max(err_dec, _max_float_err(logits, want[:, pos]))
        with _plain_recurrence():
            hid_plain = model.forward_hidden(params, {"tokens": prompts}, dtype=f32)
        return err_dec, _max_float_err(hid, hid_plain), float(want.abs().max())

    t = time.perf_counter()
    params = model.init_params(0, dtype=f32)
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in _leaves(params))
    _say(f"[rwkv] rwkv6-3b at full width: {cfg.n_layers} layers d={cfg.d_model} "
         f"heads={cfg.n_heads}x{cfg.hd} ff={cfg.d_ff} vocab={cfg.vocab}; {n_params} parameters, "
         f"fp32 init {time.perf_counter() - t:.2f} s")
    gen = np.random.default_rng(1)
    prompts = torch.from_numpy(gen.integers(0, cfg.vocab, (2, 64)).astype(np.int32)).to(dev)
    # Layer by layer, each block fed the forward's own input: its output
    # through K7 (L = 64 from zero) against the plain recurrence, and
    # token-by-token decoding of the block (K7 at L = 1, the layer's state
    # carried in place) against the forward.
    reset_launches()
    x = layers.layer_norm(params["ln0"], layers.embed(params["embed"], prompts, f32))
    state = model.init_cache(2, dtype=f32)
    err_plain = err_step = 0.0
    t = time.perf_counter()
    for i, blk in enumerate(params["blocks"]):
        out = rwkv6._block_apply(cfg, blk, x)
        with _plain_recurrence():
            out_plain = rwkv6._block_apply(cfg, blk, x)
        steps = torch.cat([rwkv6._block_step(cfg, blk, x[:, pos:pos + 1], state, i)
                           for pos in range(prompts.shape[1])], dim=1)
        torch.cuda.synchronize()
        assert _close(out, out_plain, tol) and _close(steps, out, tol), i
        err_plain = max(err_plain, _max_float_err(out, out_plain))
        err_step = max(err_step, _max_float_err(steps, out))
        x = out
    assert launches()["wkv6"] == cfg.n_layers * (1 + prompts.shape[1]), launches()
    _say(f"[rwkv] fp32 each of the {cfg.n_layers} blocks on the forward's own input "
         f"{list(prompts.shape)} ({time.perf_counter() - t:.2f} s): through K7 vs the plain "
         f"recurrence max_abs_err={err_plain:.3g}; token-by-token (K7 at L = 1, the state "
         f"carried in place) vs the forward max_abs_err={err_step:.3g} (|x| up to "
         f"{float(x.abs().max()):.3g}; rtol = atol = {tol})")
    # End to end, 32 layers of random weights carry a rounding difference
    # from one layer into the next and multiply it: the same comparisons on
    # three prompts part by 1e-4 to 1e-2 with every block within 2e-4
    # above.  So the end-to-end bound, 5e-2, catches a fault of structure
    # (a state carried wrongly parts the logits by their own scale) and not
    # the depth's amplification of rounding.
    for seed in (1, 2, 3):
        p_seed = prompts if seed == 1 else torch.from_numpy(np.random.default_rng(seed).integers(
            0, cfg.vocab, (2, 64)).astype(np.int32)).to(dev)
        t = time.perf_counter()
        err_dec, err_hid, scale = end_to_end(params, p_seed)
        _say(f"[rwkv] fp32 end to end, prompt seed {seed}: forward_hidden (K7 from zero) vs "
             f"token-by-token decode_step logits at every position max_abs_err={err_dec:.3g}; "
             f"forward_hidden through K7 vs the plain recurrence max_abs_err={err_hid:.3g} "
             f"(tolerance 5e-2; logits scale {scale:.3g}; {time.perf_counter() - t:.2f} s)")
        assert err_dec <= 5e-2 and err_hid <= 5e-2
    del x, out, out_plain, steps, state

    # ---- 19. BucketServer in fp32: every completion equals solo generation ----
    server = BucketServer(model, params, max_batch=8, dtype=f32)
    reqs = [Request(uid=i, prompt=gen.integers(0, cfg.vocab, 16 if i % 2 else 32)
                    .astype(np.int32), max_new=8) for i in range(6)]
    for req in reqs:
        server.submit(req)
    t = time.perf_counter()
    done = server.drain()
    t_drain = time.perf_counter() - t
    assert sorted(c.uid for c in done) == list(range(6))
    for c in done:
        solo = greedy_generate(model, params, reqs[c.uid].prompt[None], 8, dtype=f32)
        assert c.tokens.shape == (8,) and np.array_equal(c.tokens, solo[0]), \
            (c.uid, c.tokens, solo[0])
    _say(f"[rwkv] BucketServer fp32: 6 requests (prompts of 16 and 32 tokens, max_new=8) "
         f"drained in two waves in {t_drain:.2f} s; each completion equals greedy_generate "
         f"of its prompt alone")
    del params, server
    torch.cuda.empty_cache()

    # ---- 20. bf16 serving: loss_fn [4, 2048], then greedy generation ---------
    params = model.init_params(0, dtype=bf16)
    batch, l_long, l_prompt, n_new = 4, 2048, 128, 32
    long = torch.from_numpy(gen.integers(0, cfg.vocab, (batch, l_long)).astype(np.int32)).to(dev)
    prompts = gen.integers(0, cfg.vocab, (batch, l_prompt)).astype(np.int32)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    def do_forward():
        t = time.perf_counter()
        out = model.loss_fn(params, {"tokens": long}, dtype=bf16)
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t) * 1e3

    step_ms = []

    def timed_step(*args, **kw):
        t = time.perf_counter()
        out = model.decode_step(*args, **kw)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        return out

    reset_launches()
    fwd_ms = [do_forward()[1] for _ in range(4)]  # the first is a warm-up
    n_ev_fwd: dict[str, int] = {}
    (loss, ms_traced), busy_fwd = _traced(do_forward, n_ev_fwd)
    t = time.perf_counter()
    tokens = greedy_generate(dataclasses.replace(model, decode_step=timed_step), params,
                             prompts, n_new, dtype=bf16)
    t_gen = time.perf_counter() - t
    rwkv_launches = launches()
    peak = torch.cuda.max_memory_allocated()
    decode_ms = step_ms[l_prompt:]  # after the prompt's scan
    state = model.init_cache(batch, dtype=bf16)
    tok = torch.from_numpy(prompts[:, :1]).to(dev)

    def one_step():
        t = time.perf_counter()
        lg, _ = model.decode_step(params, state, tok, dtype=bf16)
        torch.cuda.synchronize()
        return lg, (time.perf_counter() - t) * 1e3

    one_step()
    n_ev_dec: dict[str, int] = {}
    (_, ms_step_traced), busy_dec = _traced(one_step, n_ev_dec)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        one_step()
    n_calls = sum(1 for ev in prof.events() if ev.cpu_parent is None)
    _say(f"[rwkv] one decode step makes {n_calls} top-level PyTorch calls on the host "
         f"({cfg.n_layers} layers)")
    _say(f"[rwkv] bf16 serving rwkv6-3b: loss_fn [{batch}, {l_long}] = {float(loss):.4f}, ms "
         f"{[round(x, 3) for x in fwd_ms]} (first is the warm-up); greedy_generate of "
         f"[{batch}, {l_prompt}] prompts, {n_new} new tokens in {t_gen:.2f} s: {len(step_ms)} "
         f"decode steps ({l_prompt} of the prompt's scan), ms per step ({batch} sequences) "
         f"after the prompt median {float(np.median(decode_ms)):.3f} min {min(decode_ms):.3f} "
         f"max {max(decode_ms):.3f}, over all median {float(np.median(step_ms)):.3f}; "
         f"{float(np.median(decode_ms)) / batch:.3f} ms per token")
    _say(f"[rwkv] generated tokens (sequence 0): {tokens[0].tolist()}")
    _say(f"[rwkv] peak device memory {peak} bytes ({peak / 2**30:.2f} GiB); "
         f"launches={rwkv_launches}")
    for what, busy, wall in [("forward", busy_fwd, ms_traced),
                             ("decode step", busy_dec, ms_step_traced)]:
        b_ms = sum(busy.values()) / 1e3
        _say(f"[rwkv] one {what} under the profiler: device busy {b_ms:.3f} ms of "
             f"{wall:.3f} ms ({100 * b_ms / wall:.2f} %, idle {100 - 100 * b_ms / wall:.2f} "
             "%); by function (ms): " + "; ".join(
                 f"{k[:60]} {v / 1e3:.3f}" for k, v in
                 sorted(busy.items(), key=lambda kv: -kv[1])[:6]))
    # K7 inside the model: device ms an event, and the events, from the two
    # traces above.  A long trace may lose events; K7's count (one a layer)
    # shows it, and a busy share from such a trace is a lower bound.
    in_model = []
    for what, busy, n_ev in (("forward", busy_fwd, n_ev_fwd), ("decode step", busy_dec, n_ev_dec)):
        mine = [k for k in busy if any(nm in k for nm in WKV_KERNELS)]
        n7 = sum(n_ev[k] for k in mine)
        in_model.append(sum(busy[k] for k in mine) / 1e3 / n7 if n7 else float("nan"))
        _say(f"[rwkv] K7 in one {what}'s trace: {n7} events ({cfg.n_layers} layers), "
             f"{in_model[-1]:.4f} ms each" + ("" if n7 == cfg.n_layers else
                                             "; the trace lost events: its busy share above "
                                             "is a lower bound"))
    assert np.isfinite(float(loss)) and tokens.shape == (batch, n_new)
    assert len(step_ms) == l_prompt + n_new - 1
    assert rwkv_launches["wkv6"] == cfg.n_layers * (5 + len(step_ms)), rwkv_launches
    del params, state
    torch.cuda.empty_cache()

    # ---- 21. K7 at the model's shapes ------------------------------------------
    r, k, v, w, u = fwd_in
    ms7, ev7, wrap7 = _kernel_ms(lambda: wk.wkv6(r, k, v, w, u), WKV_KERNELS, reps=10)
    _, plain7 = _plain_ms(lambda: wk.wkv6_ref(r, k, v, w, u))
    ops7, bytes7 = _wkv_work(*r.shape, False)
    bound7, by7 = _bound(ops7, bytes7, FP32_FLOPS)
    _say(f"[K7] wkv6 {tuple(r.shape)} from zero, (JC, P, C) = {wk.launch_geometry(r.shape[3])}: "
         f"kernel {ms7:.4f} ms (CUDA graph of 10 calls; {_short(ev7)} ms an event in a trace; "
         f"wrapper {wrap7:.4f} ms); plain "
         f"{plain7:.2f} ms; bound {bound7:.4f} ms by {by7} ({ops7:.4g} fp32 operations at 67 "
         f"TFLOP/s, {bytes7:.4g} bytes); {100 * bound7 / ms7:.1f} % of the bound; in the forward's "
         f"trace {in_model[0]:.4f} ms an event; the earlier kernel (one block of hd threads a head) "
         f"took 0.7507-0.7620 ms")
    rd, kd, vd, wd, ud, sd = dec_in
    ms7d, ev7d, wrap7d = _kernel_ms(lambda: wk.wkv6(rd, kd, vd, wd, ud, sd, state_out=sd),
                                    WKV_KERNELS, reps=50)
    _, plain7d = _plain_ms(lambda: wk.wkv6_ref(rd, kd, vd, wd, ud, sd))
    ops7d, bytes7d = _wkv_work(*rd.shape, True)
    bound7d, by7d = _bound(ops7d, bytes7d, FP32_FLOPS)
    _say(f"[K7] wkv6 {tuple(rd.shape)} with the state in place: {ms7d:.4f} ms a call "
         f"(CUDA graph of 50 calls; {_short(ev7d)} ms an event in a trace; wrapper {wrap7d:.4f} "
         f"ms), {100 * bound7d / ms7d:.1f} % of the bound; plain {plain7d:.3f} ms; bound {bound7d:.5f} ms by {by7d}; in the decode step's trace "
         f"{in_model[1]:.4f} ms an event, {100 * bound7d / in_model[1]:.1f} % of the bound (the "
         "earlier kernel: 0.0042 ms a call there)")
    return [{
        "name": "wkv6", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/wkv6.cu",
        "replaces": "src/repro/kernels/wkv6.py:51",
        "launches": rwkv_launches["wkv6"], "max_abs_err": fwd_err,
        "ms": ms7, "plain_ms": plain7, "bound_ms": bound7, "bound_by": by7,
        "library_ms": None,
    }]


def _wkv_bwd_work(b, l, h, hd, with_s0, with_ds):
    """(fp32 operations, bytes) of one wkv6 backward from its inputs, per
    (b, t, h): for each state element, the state S_{t-1} (3 operations:
    w S + k v, needed again since the forward saves none), G's update
    w G + r dy (3), and the sums over a row or a column, a multiply and an
    add each: dr's sum_j S_ij dy_j, dk's sum_j G_ij v_j, dv's sum_i G_ij k_i
    and dw's sum_j G_ij S_ij (2 each): 14 hd^2.  The bonus terms, factored
    through a = v.dy and c = sum_i r_i u_i k_i: a (2 hd), dr's u_i k_i a
    (3 hd), dk's u_i (r_i a) (3 hd), du's k_i (r_i a) (2 hd), c (2 hd) and
    dv's dy_j c (2 hd): 14 hd.  Bytes: r, k, v, w and dy read and dr, dk,
    dv and dw written once (36 an element), u read and du written, ds0
    written, s0 and dS_final read when given."""
    n = b * l * h
    state = 4.0 * b * h * hd * hd
    return float(n * (14 * hd * hd + 14 * hd)), 36.0 * n * hd + 8.0 * h * hd + state * (
        1 + with_s0 + with_ds)


def _wkv_bwd_design_work(b, l, h, hd):
    """(fp32 operations, device bytes) of K7b's chunked design from zero,
    per (b, h) and state element: passes A and B a product and an add a
    token each (4); pass C's forward walk the state's update (2) over all
    tiles but a chunk's last, its backward walk the tile's states again
    (2) and dr, dk, dw, dv and G (2 + 2 + 2 + 2 + 3 = 11): 18.5 hd^2 a
    token at C = 32 and T = 8; the bonus terms left out.  Bytes: r, k, v,
    w, dy read by passes A and B (k, w, v and r, w, dy) and again by C; dr,
    dk, dv, dw written; the chunk boundaries' states, written by A and B
    and read by C."""
    from repro_torch.kernels import wkv6 as wk

    chunk, tile = wk.BWD_CHUNK, wk.BWD_TILE
    n = b * l * h
    ops = n * hd * hd * (4 + 2 * (1 - tile / chunk) + 2 + 11)
    states = 2 * 2 * b * h * hd * hd * 4.0 * -(-l // chunk)
    return float(ops), 4.0 * n * hd * (6 + 5 + 4) + states


def _rwkv_train_phases(dev, check=(4, 2048, 40), grad=(2, 256), grad_depth=4, train=(4, 2048)):
    """Phases 37-40: K7b against its plain version, one fp32 rwkv6-3b train
    step through K7/K7b against the plain recurrence, bf16 training at full
    width (the path's launches), K7b's time at the model's shape.  Returns
    (the kernels line's K7b entry, the training path's launches).  The
    shapes are the card's; a CPU rehearsal cuts them."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline
    from repro_torch.kernels import _build, launches, reset_launches
    from repro_torch.kernels import wkv6 as wk
    from repro_torch.models import build_model
    from repro_torch.train import OptConfig, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    f32, bf16 = torch.float32, torch.bfloat16
    t_phase = time.perf_counter()

    def inputs(b, l, h, hd, seed, dtype):
        """r, k, v, w, u, s0 as phase 17 draws them, dy and dS_final normal;
        r, k, v, w, u and dy in ``dtype``, the states fp32."""
        g = torch.Generator(device=dev).manual_seed(seed)
        r, k, v, dy = (torch.randn((b, l, h, hd), generator=g, device=dev) for _ in range(4))
        w = 0.6 + 0.399 * torch.rand((b, l, h, hd), generator=g, device=dev)
        u = 0.1 * torch.randn((h, hd), generator=g, device=dev)
        s0, ds = (torch.randn((b, h, hd, hd), generator=g, device=dev) for _ in range(2))
        return [t.to(dtype) for t in (r, 0.3 * k, v, w, u, dy)] + [0.5 * s0, ds]

    # ---- 37. K7b against its plain version ------------------------------------
    b0, l0, h0 = check
    c = wk.BWD_CHUNK  # lengths around K7b's chunk: C - 1, C, C + 1, 2C + 3
    cases = [(b0, l0, h0, 64, False, False, f32), (2, 77, 3, 16, True, True, f32),
             (2, 77, 3, 80, True, False, f32), (2, 77, 3, 72, True, True, f32),
             (2, 300, 3, 128, False, True, f32),
             (b0, 1, h0, 64, True, True, f32), (2, 1, 3, 24, False, True, f32),
             (2, c - 1, 3, 64, True, True, f32), (2, c, 3, 64, False, True, f32),
             (2, c + 1, 3, 128, True, False, f32), (2, 2 * c + 3, 3, 64, True, True, f32),
             (2, 2 * c + 3, 3, 128, False, False, f32), (2, c + 1, 3, 16, True, True, f32),
             (2, 2 * c + 3, 3, 24, True, True, f32),
             (2, 77, 3, 64, True, True, bf16), (b0, l0, h0, 64, True, True, bf16)]
    reset_launches()
    for b, l, h, hd, with_s0, with_ds, dtype in cases:
        r, k, v, w, u, dy, s0, ds = inputs(b, l, h, hd, b * 100 + l + hd, dtype)
        args = (r, k, v, w, u, dy, s0 if with_s0 else None, ds if with_ds else None)
        got = wk.wkv6_bwd(*args)
        again = wk.wkv6_bwd(*args)
        torch.cuda.synchronize()
        same = all(torch.equal(x, y) for x, y in zip(got, again))
        want = wk.wkv6_bwd_ref(*args)
        tol = 2e-4 if dtype == f32 else 1e-2
        errs = {nm: float((x.float() - y.float()).abs().max()
                          / y.float().abs().max().clamp(min=1e-30))
                for nm, x, y in zip(("dr", "dk", "dv", "dw", "du", "ds0"), got, want)}
        _say(f"[check] wkv6_bwd {(b, l, h, hd)} {str(dtype)[6:]} "
             f"s0={'given' if with_s0 else 'zero'} dS_final={'given' if with_ds else 'zero'} "
             f"(hd {hd} runs at "
             f"{wk.bwd_head_dim(hd)}): max |err| over each gradient's largest entry "
             + ", ".join(f"{nm} {e:.3g}" for nm, e in errs.items())
             + f" (tolerance {tol}); two calls equal bit for bit: {same}")
        assert same and max(errs.values()) <= tol, errs
        if (b, l, h, hd, dtype) == (b0, l0, h0, 64, f32):
            main_in = args
            main_err = max(_max_float_err(x, y) for x, y in zip(got, want))
        del got, again, want
    assert launches()["wkv6_bwd"] == 2 * len(cases), launches()
    log = _build.build_all(["wkv6_bwd"])["wkv6_bwd"].ptxas
    for hd in wk.BWD_HEAD_DIMS:
        _say(f"[K7b] hd {hd}: " + "; ".join(
            f"{nm} {_ptxas_regs(log, f'{nm}ILi{hd}E')} registers, spills (store, load bytes) "
            f"{_ptxas_spills(log, f'{nm}ILi{hd}E')}"
            for nm in ("wkv6_bwd_state_kernel", "wkv6_bwd_chunk_kernel")))
    torch.cuda.empty_cache()

    # ---- 38. one fp32 train step through K7 and K7b against the plain recurrence
    full = get_config("rwkv6-3b")
    cfg = dataclasses.replace(full, n_layers=grad_depth)
    model = build_model(cfg, device=dev)
    opt_cfg = OptConfig(lr=3e-4, warmup_steps=4, total_steps=1000)
    tokens = torch.from_numpy(np.random.default_rng(38).integers(0, cfg.vocab, grad)
                              .astype(np.int32)).to(dev)
    tree = _step_vs_plain("rwkv-train", model, {"tokens": tokens}, opt_cfg,
                          {"wkv6": 2 * cfg.n_layers, "wkv6_bwd": cfg.n_layers},
                          _plain_recurrence)
    rec = {nm: float(g.abs().max()) > 0 for nm, g in tree.items()
           if "/tm/" in nm and nm.split("/")[-1] in ("u", "w0", "wA", "wB", "Wr", "Wk", "Wv")}
    _say(f"[rwkv-train] the time mix's gradient leaves (u, w0, wA, wB, Wr, Wk, Wv of every "
         f"layer) nonzero: {all(rec.values())} ({len(rec)} leaves)")
    assert all(rec.values()) and len(rec) == 7 * cfg.n_layers, sorted(rec)
    del tree, model
    torch.cuda.empty_cache()

    # ---- 39. bf16 training at full width ---------------------------------------
    cfg = full
    model = build_model(cfg, device=dev)
    step_fn = make_train_step(model, opt_cfg, {"dtype": bf16})
    pipe = TokenPipeline(vocab=cfg.vocab, batch=train[0], seq=train[1] - 1, seed=1)
    first = {"tokens": torch.from_numpy(pipe.next_batch()).to(dev)}
    ms_med, n_params, busy, _, train_launches = _train_bf16(
        "rwkv-train", model, step_fn, first, {"wkv6": 2 * cfg.n_layers, "wkv6_bwd": cfg.n_layers},
        {"K7": WKV_KERNELS, "K7b": WKV_BWD_KERNELS})
    n_tok = train[0] * train[1]
    n_mat = n_params - cfg.vocab * cfg.d_model  # every matrix but the embedding's lookup
    flops = 6.0 * n_mat * n_tok
    mfu = flops / (ms_med / 1e3) / BF16_FLOPS
    _say(f"[rwkv-train] mfu={mfu:.4f} (6 N T = {flops:.4g} model flops a step, N = {n_mat} "
         f"parameters less the embedding table, depth {cfg.n_layers}; the recurrence's own "
         f"5 hd^2 a token and head, about 0.5 %, left out; over {ms_med:.2f} ms at 989 TFLOP/s "
         f"bf16)")
    del step_fn, first, model
    torch.cuda.empty_cache()

    # ---- 40. K7b at the model's shape --------------------------------------------
    r, k, v, w, u, dy, _, _ = main_in
    ms, ev, wrap = _kernel_ms(lambda: wk.wkv6_bwd(r, k, v, w, u, dy), WKV_BWD_KERNELS, reps=10)
    _, plain = _plain_ms(lambda: wk.wkv6_bwd_ref(r, k, v, w, u, dy))
    ops, n_bytes = _wkv_bwd_work(*r.shape, False, False)
    bound, by = _bound(ops, n_bytes, FP32_FLOPS)
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    d_ops, d_bytes = _wkv_bwd_design_work(*r.shape)
    passes = {nm: next((v for k, v in ev.items() if nm in k), float("nan"))
              for nm in WKV_BWD_KERNELS}
    _say(f"[K7b] wkv6_bwd {tuple(r.shape)} fp32 from zero: kernels {ms:.4f} ms (CUDA graph of "
         f"10 calls; wrapper {wrap:.4f} ms); a pass an event in a trace: A and B "
         f"(wkv6_bwd_state_kernel) {passes['wkv6_bwd_state_kernel']:.4f} ms, C "
         f"(wkv6_bwd_chunk_kernel) {passes['wkv6_bwd_chunk_kernel']:.4f} ms, du "
         f"{passes['wkv6_bwd_du_kernel']:.4f} ms; plain {plain:.2f} ms; the function's bound "
         f"{bound:.4f} ms by {by} ({ops:.4g} fp32 operations at 67 TFLOP/s; {n_bytes:.4g} bytes, "
         f"{t_bytes:.4f} ms at 3.35 TB/s); {100 * bound / ms:.1f} % of the bound; this design "
         f"does {d_ops:.4g} fp32 operations ({d_ops / FP32_FLOPS * 1e3:.4f} ms) and moves "
         f"{d_bytes:.4g} bytes ({d_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms); no single PyTorch "
         f"call computes it")
    del main_in, r, k, v, w, u, dy
    torch.cuda.empty_cache()
    _say(f"[rwkv-train] phases 37-40: {time.perf_counter() - t_phase:.1f} s")
    return {
        "name": "wkv6_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/wkv6_bwd.cu",
        "replaces": "none: the JAX package differentiates _wkv_scan "
                    "(src/repro/models/rwkv6.py:95) by autodiff; no Pallas backward",
        "launches": train_launches["wkv6_bwd"], "max_abs_err": main_err,
        "ms": ms, "plain_ms": plain, "bound_ms": bound, "bound_by": by, "library_ms": None,
    }, train_launches


def _launcher_phase(dev, shape=(2, 512), reduced=False):
    """Phase 41: the launcher (``repro_torch.launch.train.main``) as a
    subprocess at a world of one on the card, olmo-1b at full width cut to
    2 layers (its ``get_config`` wrapped by a bootstrap, since the launcher,
    as the JAX package's, takes no depth), three steps on
    ``shape`` tokens: preempted by SIGTERM during its first step (it
    checkpoints step 1 and exits: the phase's one save), then run again
    with ``--resume`` to the end (one restore; ``--ckpt-every`` beyond the
    last step, so it writes nothing); then ``make_train_step`` driven by
    hand in this process on the same pipeline batches, uninterrupted.  The
    hand-driven run's losses equal the ones the launcher logged bit for
    bit: step 0's before the preemption, and step 2's after the resume,
    which reads every restored parameter, AdamW moment and the step count
    (step 1's update).  The CPU tests compare the whole resumed state.
    Returns the launcher's kernel launches over both runs, as it prints
    them.  ``reduced`` (a CPU rehearsal) passes ``--reduced``."""
    import ast
    import dataclasses
    import os
    import re
    import shutil
    import signal
    import threading

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline
    from repro_torch.models import build_model
    from repro_torch.train import OptConfig, init_train_state, latest_step, make_train_step

    arch, steps, depth = "olmo-1b", 3, 2
    t_phase = time.perf_counter()
    shutil.rmtree(LAUNCHER_DIR, ignore_errors=True)
    boot = ("import dataclasses, sys; from repro_torch.launch import train; "
            "get = train.get_config; train.get_config = lambda arch: dataclasses.replace("
            "get(arch), n_layers=int(sys.argv[1])); train.main(sys.argv[2:])")
    argv = [sys.executable, "-c", boot, str(depth), "--arch", arch, "--steps",
            str(steps), "--batch", str(shape[0]), "--seq", str(shape[1]), "--ckpt-every",
            str(steps + 1), "--ckpt-dir", str(LAUNCHER_DIR), "--device", dev.type] + (
                ["--reduced"] if reduced else [])
    env = {**os.environ, "PYTHONPATH": str(SRC)}

    def drive(*extra, preempt=False):
        t = time.perf_counter()
        proc = subprocess.Popen(argv + list(extra), stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True, env=env, cwd=ROOT)
        watchdog = threading.Timer(600, proc.kill)
        watchdog.start()
        lines = []
        try:
            for line in proc.stdout:
                lines.append(line.rstrip())
                if preempt and line.startswith("training "):
                    proc.send_signal(signal.SIGTERM)  # during the first step
            rc = proc.wait()
        finally:
            watchdog.cancel()
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        assert rc == 0, "\n".join(lines[-40:])
        losses = {int(m_.group(1)): float(m_.group(2)) for m_ in
                  re.finditer(r"^step +(\d+) loss=(\S+)", "\n".join(lines), re.M)}
        counts = [ast.literal_eval(ln[len("kernel launches "):]) for ln in lines
                  if ln.startswith("kernel launches ")]
        _say(f"[launcher] {' '.join(extra) or 'first run'}"
             f"{' (SIGTERM during the first step)' if preempt else ''}: "
             f"{time.perf_counter() - t:.1f} s; "
             + " | ".join(ln for ln in lines if not ln.startswith("kernel launches ")))
        return lines, losses, counts[0]

    lines_b, loss_b, launches_b = drive(preempt=True)
    assert any(ln.startswith("preempted") for ln in lines_b), lines_b
    assert latest_step(str(LAUNCHER_DIR)) == 1 and list(loss_b) == [0]
    n_bytes = sum(f.stat().st_size for f in LAUNCHER_DIR.rglob("*") if f.is_file())
    lines_r, loss_r, launches_r = drive("--resume")
    assert any(ln.startswith("resumed from step 1") for ln in lines_r), lines_r
    assert latest_step(str(LAUNCHER_DIR)) == 1 and list(loss_r) == [steps - 1]
    launches = {k_: launches_b[k_] + launches_r[k_] for k_ in launches_b}
    cfg = dataclasses.replace(get_config(arch), n_layers=depth)
    cfg = cfg.reduced() if reduced else cfg
    n_attn = 0 if dev.type == "cpu" else cfg.n_layers  # the CPU launches no kernel
    assert launches["flash_attention"] == 2 * n_attn * steps, launches
    assert launches["flash_attention_bwd"] == n_attn * steps, launches

    # make_train_step by hand on the same batches, uninterrupted, in this process
    model = build_model(cfg, device=dev)
    step = make_train_step(model, OptConfig(total_steps=steps, warmup_steps=max(5, steps // 20)))
    params, opt = init_train_state(model, 0)
    pipe = TokenPipeline(vocab=cfg.vocab, batch=shape[0], seq=shape[1], seed=0)
    losses = []
    for _ in range(steps):
        tokens = torch.from_numpy(pipe.next_batch()).to(dev)
        params, opt, m = step(params, opt, {"tokens": tokens})
        losses.append(float(m["loss"]))
    del params, opt, step, model
    torch.cuda.empty_cache()
    size = "reduced" if reduced else f"at full width, depth {cfg.n_layers}"
    _say(f"[launcher] {arch} {size}, {steps} steps on {list(shape)} tokens: the launcher "
         f"logged losses {loss_b} (preempted; its checkpoint of step 1 is {n_bytes} bytes) and "
         f"{loss_r} (resumed from it); make_train_step by hand, uninterrupted: {losses}; equal "
         f"bit for bit: {loss_b[0] == losses[0] and loss_r[steps - 1] == losses[-1]}; kernel "
         f"launches over both runs {launches}")
    assert loss_b[0] == losses[0] and loss_r[steps - 1] == losses[-1]
    shutil.rmtree(LAUNCHER_DIR, ignore_errors=True)
    _say(f"[launcher] phase 41: {time.perf_counter() - t_phase:.1f} s")
    return launches


def _two_ranks(tool, dev, reduced=False, args=()):
    """Starts ``tools/<tool> --smoke [args]`` as two ranks on this card over
    gloo (on the CPU at the reduced config where ``reduced``); returns a
    function that waits for them and gives each rank's ``RESULT``."""
    import os
    import socket
    import threading

    with socket.socket() as sock:  # a free port on this host for the ranks' store
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = {**os.environ, "PYTHONPATH": str(SRC), "MASTER_ADDR": "127.0.0.1",
           "MASTER_PORT": str(port), "WORLD_SIZE": "2"}
    argv = [sys.executable, str(ROOT / "tools" / tool), "--smoke", "--backend",
            "gloo", "--device", dev.type, *args] + (["--reduced"] if reduced else [])
    procs = [subprocess.Popen(argv, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              cwd=ROOT, env={**env, "RANK": str(r), "LOCAL_RANK": str(r)})
             for r in range(2)]
    watchdogs = [threading.Timer(300, p.kill) for p in procs]
    for w in watchdogs:
        w.start()

    def wait():
        try:
            outs = [p.communicate()[0] for p in procs]
        finally:
            for w, p in zip(watchdogs, procs):
                w.cancel()
                if p.poll() is None:
                    p.kill()
                p.wait()
        for p, out in zip(procs, outs):
            assert p.returncode == 0, out[-4000:]
        return [json.loads([ln for ln in out.splitlines() if ln.startswith("RESULT ")][-1][7:])
                for out in outs]

    return wait


def _tp_phase(dev, reduced=False, ranks=None):
    """Phase 58: ``tools/tensor_parallel.py --smoke`` as two ranks on this
    card over gloo (``reduced``, a CPU rehearsal: on the CPU at the reduced
    config; ``ranks``: the ranks' wait, where ``_two_ranks`` started them
    already).  Holds each rank's results to the phase's checks and returns
    the kernel launches summed over the ranks."""
    t = time.perf_counter()
    res = (ranks or _two_ranks("tensor_parallel.py", dev, reduced))()
    for r in res:
        _say(f"[tp] rank {r['rank']} of a (1, 2) mesh on one card over gloo: "
             f"{_stream_text(r)}; fp32 loss "
             f"{r['loss']!r} vs one rank's {r['loss_one']!r} (rel {r['loss_rel']:.3g}), prefill "
             f"logits {r['logits_rel']:.3g} of the largest off (tol 1e-4); greedy {r['tokens']} "
             f"(one rank {r['tokens_one']}); bf16 (loss, global norm) of two steps "
             f"{r['bf16_metrics']} (one rank {r['bf16_metrics_one']}); before each step "
             f"{_same_weights_text(r['same_weights'])}; {r['replicated_leaves']} "
             f"replicated leaves; K6 {r['launches']['flash_attention']}, K6b "
             f"{r['launches']['flash_attention_bwd']} launches; the split path "
             f"{r['path_s']:.2f} s of the rank's {r['seconds']:.2f} s")
        assert r["loss_rel"] <= 1e-4 and r["logits_rel"] <= 1e-4, r
        assert r["tokens"] == r["tokens_one"], r
        for (loss, _), (want, _) in zip(r["bf16_metrics"], r["bf16_metrics_one"]):
            assert abs(loss - want) <= 2e-2 * abs(want), r
        assert len(r["same_weights"]) == 2 and all(w["ok"] for w in r["same_weights"]), r
        _assert_stream_split(r)
    for key in ("bf16_metrics", "replicated_sha", "tokens"):
        assert res[0][key] == res[1][key], (key, res[0][key], res[1][key])
    n_attn = 2 if dev.type == "cuda" else 0  # olmo-1b cut to 2 layers; the CPU launches none
    for r in res:  # the fp32 loss, the prefill, two steps of forward + remat
        assert r["launches"]["flash_attention"] == 6 * n_attn, r["launches"]
        assert r["launches"]["flash_attention_bwd"] == 2 * n_attn, r["launches"]
    total = {k: res[0]["launches"][k] + res[1]["launches"][k] for k in res[0]["launches"]}
    _say(f"[tp] phase 58: {time.perf_counter() - t:.1f} s (both ranks' launches {total})")
    return total


def _stream_text(r) -> str:
    """A smoke rank's residual stream at a block's entry."""
    return (f"the stream at a block's entry {r['stream']} a rank (the whole model's "
            f"{r['stream_one']})")


def _assert_stream_split(r) -> None:
    """Sequence parallelism: the check's length divides the two ranks, so
    each holds [B, S/2, d] of the stream at every block's entry."""
    b, length, d = r["stream_one"]
    assert r["stream"] == [b, length // 2, d] and r["stream_same"], r["stream"]


def _same_weights_text(same) -> str:
    """``tools/tensor_parallel.py``'s same-weights gradient checks, a step each."""
    return "; ".join(
        f"the split's bf16 global norm {w['norm']:.6g} vs the whole model's {w['norm_one']:.6g} "
        f"at the same weights (tol {w['norm_tol']:.4g}: 2e-2 of it, or twice its bf16 "
        f"gradient's distance {w['off_fp32_one']:.4g} from its fp32 one, norm "
        f"{w['norm_fp32']:.6g}), the split's distance from the fp32 gradient {w['off_fp32']:.4g} "
        f"(tol twice the whole model's + 1e-2 of the fp32 norm): ok {w['ok']}" for w in same)


def _tp_recurrent_phase(dev, reduced=False):
    """Phase 60: ``tools/tensor_parallel.py --smoke --recurrent`` as two
    ranks on this card over gloo (``reduced``: the CPU rehearsal), as phase
    58, for rwkv6-3b cut to depth 2 and zamba2-2.7b cut to one group (6
    Mamba2 layers and the shared block).  Holds each rank's results to the
    phase's checks and returns the kernel launches summed over the ranks
    and both configurations."""
    t = time.perf_counter()
    res = _two_ranks("tensor_parallel.py", dev, reduced, ("--recurrent",))()
    cuda = dev.type == "cuda"  # the CPU launches no kernel
    # per rank: rwkv6's fp32 loss (2 layers) and forward logits (2), 12 decode
    # steps (8 prompt tokens, 4 more) x 2, two steps of forward + remat (8);
    # K7b once a layer and step.  zamba2's one shared block: the loss, the
    # logits, two steps of forward + remat; decode attends without K6.
    want = {"rwkv6-3b": {"wkv6": 36, "wkv6_bwd": 4},
            "zamba2-2.7b": {"flash_attention": 6, "flash_attention_bwd": 2}}
    total = {}
    for name in ("rwkv6-3b", "zamba2-2.7b"):
        got = [r["configs"][name] for r in res]
        for r in got:
            _say(f"[tp-rec] rank {r['rank']} of a (1, 2) mesh on one card over gloo, {name} cut "
                 f"to {r['layers']} layers: {_stream_text(r)}; fp32 loss {r['loss']!r} vs one rank's "
                 f"{r['loss_one']!r} (rel {r['loss_rel']:.3g}), the prompts' logits "
                 f"{r['logits_rel']:.3g} of the largest off (tol 1e-4); greedy {r['tokens']} (one "
                 f"rank {r['tokens_one']}); bf16 (loss, global norm) of two steps "
                 f"{r['bf16_metrics']} (one rank {r['bf16_metrics_one']}); before each step "
                 f"{_same_weights_text(r['same_weights'])}; "
                 f"{r['replicated_leaves']} replicated leaves; launches "
                 f"{ {k: v for k, v in r['launches'].items() if v} }; the split path "
                 f"{r['path_s']:.2f} s of {r['seconds']:.2f} s")
            assert r["loss_rel"] <= 1e-4 and r["logits_rel"] <= 1e-4, r
            assert r["tokens"] == r["tokens_one"], r
            for (loss, _), (want_loss, _) in zip(r["bf16_metrics"], r["bf16_metrics_one"]):
                assert abs(loss - want_loss) <= 2e-2 * abs(want_loss), r
            assert len(r["same_weights"]) == 2 and all(w["ok"] for w in r["same_weights"]), r
            _assert_stream_split(r)
            for kernel, n in want[name].items():
                assert r["launches"][kernel] == (n if cuda else 0), (name, r["launches"])
        for key in ("bf16_metrics", "replicated_sha", "tokens"):
            assert got[0][key] == got[1][key], (name, key, got[0][key], got[1][key])
        for r in got:
            for k, n in r["launches"].items():
                total[k] = total.get(k, 0) + n
    _say(f"[tp-rec] phase 60: {time.perf_counter() - t:.1f} s (the ranks' own "
         f"{max(r['seconds'] for r in res):.1f} s; both ranks' launches "
         f"{ {k: v for k, v in total.items() if v} })")
    return total


def _ep_phase(dev, reduced=False, ranks=None):
    """Phase 59: ``tools/expert_parallel.py --smoke`` as two ranks on this
    card over gloo (``reduced``: the CPU rehearsal), as phase 58.  Holds
    each rank's results to the phase's checks and returns the kernel
    launches summed over the ranks."""
    t = time.perf_counter()
    res = (ranks or _two_ranks("expert_parallel.py", dev, reduced))()
    for r in res:
        _say(f"[ep] rank {r['rank']} of a (1, 2) mesh on one card over gloo, qwen2-moe-a2.7b "
             f"cut to 2 layers, 8 replica slots: {_stream_text(r)}; fp32 loss {r['loss']!r} vs one rank's "
             f"{r['loss_one']!r} (rel {r['loss_rel']:.3g}, tol 1e-4), prefill logits "
             f"{r['logits_rel']:.3g} of the largest off (tol 1e-4); each layer's slot loads, "
             f"drops {r['dropped']} and replica slots' experts {r['slot_expert']} (layer 0) "
             f"equal one rank's: {r['dispatch_equal']}; greedy {r['tokens']} (one rank "
             f"{r['tokens_one']}); bf16 (loss, global norm) of two steps {r['bf16_metrics']} "
             f"(one rank {r['bf16_metrics_one']}); {r['replicated_leaves']} replicated leaves; "
             f"replica-slot fetch {r['fetch_bytes_per_layer']} bytes a layer's forward; K6 "
             f"{r['launches']['flash_attention']}, K6b {r['launches']['flash_attention_bwd']} "
             f"launches; the split path {r['path_s']:.2f} s of the rank's {r['seconds']:.2f} s")
        assert r["loss_rel"] <= 1e-4 and r["logits_rel"] <= 1e-4, r
        assert r["dispatch_equal"] and r["tokens"] == r["tokens_one"], r
        for (loss, _), (want, _) in zip(r["bf16_metrics"], r["bf16_metrics_one"]):
            assert abs(loss - want) <= 2e-2 * abs(want), r
        _assert_stream_split(r)
    for key in ("bf16_metrics", "replicated_sha", "tokens"):
        assert res[0][key] == res[1][key], (key, res[0][key], res[1][key])
    n_attn = 2 if dev.type == "cuda" else 0  # 2 layers; the CPU launches none
    for r in res:  # the fp32 loss, the prefill, two steps of forward + remat
        assert r["launches"]["flash_attention"] == 6 * n_attn, r["launches"]
        assert r["launches"]["flash_attention_bwd"] == 2 * n_attn, r["launches"]
    total = {k: res[0]["launches"][k] + res[1]["launches"][k] for k in res[0]["launches"]}
    _say(f"[ep] phase 59: {time.perf_counter() - t:.1f} s (both ranks' launches {total})")
    return total


def _flash_bwd_work(b, h, l, d, causal, elem_bytes, hkv=None):
    """(operations, bytes) of one attention backward: 2 D flops for each of
    the five products of a (query, key) pair that the mask keeps (S = q k^T
    and dP = do v^T rebuilt, dv += P^T do, dq += dS k, dk += dS^T q); q, k,
    v, o and do read once, the fp32 lse read once, dq, dk and dv written
    once (k, v, dk and dv of ``hkv`` heads, default ``h``)."""
    pairs = b * h * (l * (l + 1) // 2 if causal else l * l)
    return 10.0 * d * pairs, 4.0 * b * (h + (hkv or h)) * l * d * elem_bytes + 4.0 * b * h * l


def _train_phases(dev, depth=None, main=(4, 2048), check=(2, 256), ckpt=(2, 512)):
    """Phases 22-26; returns the kernels line's K6b entry and the training
    path's launches.  ``depth``, ``main``, ``check`` and ``ckpt`` cut the
    model and the batches (a CPU rehearsal); the card runs the defaults."""
    import dataclasses
    import os
    import shutil
    import signal

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import _build, launches, reset_launches
    from repro_torch.models import build_model, layers
    from repro_torch.models.convert import flat_from_jax_layout, train_state_to_jax_layout
    from repro_torch.train import (
        AsyncCheckpointer,
        OptConfig,
        PreemptionGuard,
        adamw_update,
        init_train_state,
        load_checkpoint,
        make_train_step,
        restore_tree,
        run_elastic_loop,
    )
    from repro_torch.train.optimizer import leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    f32, bf16 = torch.float32, torch.bfloat16

    # ---- 22. K6's backward against its plain version --------------------------
    # (b, h, hkv, Lq, Lk, d, causal, dtype); bf16 at D = 64, 80 and 128 runs
    # the wgmma kernels: GQA 4:1, ragged L, Lq != Lk, one query, L below a tile
    olmo_bwd = None
    for b, h, hkv, lq, lk, d, causal, dtype in [
        (2, 4, 2, 200, 200, 64, True, f32), (1, 4, 1, 200, 200, 128, False, f32),
        (2, 8, 2, 200, 200, 40, True, f32), (2, 32, 8, 200, 200, 128, True, bf16),
        (1, 8, 8, 1000, 1000, 128, True, bf16), (2, 8, 2, 1000, 1000, 64, True, bf16),
        (2, 4, 4, 200, 200, 96, False, bf16), (2, 8, 2, 200, 200, 40, True, bf16),
        (1, 4, 1, 300, 300, 64, False, bf16), (1, 8, 2, 77, 300, 128, False, bf16),
        (2, 8, 2, 1, 100, 64, False, bf16), (2, 8, 2, 40, 40, 128, True, bf16),
        (2, 16, 4, 130, 130, 80, True, bf16), (1, 4, 2, 77, 300, 80, False, bf16),
        (4, 16, 16, 2048, 2048, 128, True, bf16),
    ]:
        g = torch.Generator(device=dev).manual_seed(b * 1000 + h + lq + d)
        q, k, v, do = (torch.randn(s, generator=g, device=dev, dtype=f32).to(dtype)
                       for s in ((b, h, lq, d), (b, hkv, lk, d), (b, hkv, lk, d), (b, h, lq, d)))
        o, lse = fa.flash_attention_lse(q, k, v, causal=causal)
        o_ref, lse_ref = fa.flash_attention_ref_lse(q, k, v, causal=causal)
        n0 = launches()["flash_attention_bwd"]
        got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
        again = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
        torch.cuda.synchronize()
        assert launches()["flash_attention_bwd"] == n0 + 2
        want = fa.flash_attention_bwd_ref(q, k, v, o_ref, lse_ref, do, causal=causal)
        tol, rel_tol = (2e-5, 1e-5) if dtype == f32 else (2e-2, 1e-2)
        errs = [_max_float_err(x, w) for x, w in zip(got, want)]
        rels = [_rel_norm_err(x, w) for x, w in zip(got, want)]
        same = all(torch.equal(x, y) for x, y in zip(got, again))
        _say(f"[check] flash_attention_bwd {fa.bwd_kernel_variant(dtype, fa.padded_head_dim(d))} "
             f"({str(dtype)[6:]}{f' at D={fa.padded_head_dim(d)}, padded' if d % 16 else ''}) q "
             f"{(b, h, lq, d)} k {(b, hkv, lk, d)} causal={causal}: forward lse max_abs_err "
             f"{_max_float_err(lse, lse_ref):.3g} (rtol = atol = 1e-5), o "
             f"{_max_float_err(o, o_ref):.3g}; max_abs_err dq {errs[0]:.3g} dk {errs[1]:.3g} "
             f"dv {errs[2]:.3g} (rtol = atol = {tol}); relative norm error dq {rels[0]:.3g} "
             f"dk {rels[1]:.3g} dv {rels[2]:.3g} (limit {rel_tol}); two calls equal bit for "
             f"bit: {same}")
        assert _close(lse, lse_ref, 1e-5) and _close(o, o_ref, tol)
        assert same and all(_close(x, w, tol) for x, w in zip(got, want))
        assert max(rels) <= rel_tol
        if lq == 2048:
            olmo_bwd, olmo_bwd_err = (q, k, v, o, lse, do), max(errs)
        del q, k, v, do, o, lse, o_ref, lse_ref, got, again, want

    # ---- 23. one fp32 train step through K6's Function against plain attention
    cfg = get_config("olmo-1b")
    if depth is not None:
        cfg = dataclasses.replace(cfg, n_layers=depth)
    model = build_model(cfg, device=dev)
    opt_cfg = OptConfig(lr=3e-4, warmup_steps=4, total_steps=1000)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, check)
                              .astype(np.int32)).to(dev)
    runs = []
    for plain in (False, True):
        params, opt = init_train_state(model, 0)
        for p in leaves(params):
            p.grad = None
        reset_launches()
        if plain:
            layers.flash_attention = fa.flash_attention_ref  # autograd through the plain version
        try:
            loss = model.loss_fn(params, {"tokens": tokens}, dtype=f32)
            loss.backward()
        finally:
            layers.flash_attention = fa.flash_attention
        torch.cuda.synchronize()
        n = launches()
        assert (n["flash_attention"], n["flash_attention_bwd"]) == (
            (0, 0) if plain else (2 * cfg.n_layers, cfg.n_layers)), n
        grads = [p.grad for p in leaves(params)]
        for p in leaves(params):
            p.grad = None
        p0 = [p.detach().clone() for p in leaves(params)] if not plain else None
        adamw_update(params, grads, opt, opt_cfg)
        runs.append((float(loss.detach()), grads, [p.detach() for p in leaves(params)], p0))
        del opt
    (loss_k, g_k, p_k, p0), (loss_p, g_p, p_p, _) = runs
    names = ["/".join(path) for path in _leaf_paths(params)]
    g_err = {nm: float((a - w).abs().max() / w.abs().max().clamp(min=1e-30))
             for nm, a, w in zip(names, g_k, g_p)}
    worst = max(g_err, key=g_err.get)
    attn = {nm: e for nm, e in g_err.items() if nm.split("/")[-1] in ("wq", "wk", "wv")}
    moved = torch.sqrt(sum(((w - a) ** 2).sum() for w, a in zip(p_p, p0)))
    diff = torch.sqrt(sum(((a - w) ** 2).sum() for a, w in zip(p_k, p_p)))
    _say(f"[train] fp32 step on {list(tokens.shape)} ({cfg.n_layers} layers, d={cfg.d_model}): "
         f"loss K6 {loss_k:.7f} vs plain attention {loss_p:.7f}; gradients, max |err| over "
         f"each leaf's largest entry: worst {worst} {g_err[worst]:.3g}, wq/wk/wv worst "
         f"{max(attn.values()):.3g} over {len(attn)} leaves, all nonzero: "
         f"{all(float(g.abs().max()) > 0 for nm, g in zip(names, g_k) if nm in attn)}; params "
         f"after AdamW differ by {float(diff):.3g} against an update of norm {float(moved):.3g} "
         f"(tolerances: loss 1e-5 relative, gradients 1e-3, params 1e-3 of the update)")
    assert abs(loss_k - loss_p) <= 1e-5 * abs(loss_p)
    assert max(g_err.values()) <= 1e-3 and len(attn) == 3 * cfg.n_layers
    assert all(float(g.abs().max()) > 0 for nm, g in zip(names, g_k) if nm in attn)
    assert float(diff) <= 1e-3 * float(moved)
    del runs, g_k, g_p, p_k, p_p, p0, params, grads
    torch.cuda.empty_cache()

    # ---- 24. bf16 training, the main path ------------------------------------
    params, opt = init_train_state(model, 0)
    step_fn = make_train_step(model, opt_cfg, {"dtype": bf16})
    pipe = TokenPipeline(vocab=cfg.vocab, batch=main[0], seq=main[1] - 1, seed=1)
    first = {"tokens": torch.from_numpy(pipe.next_batch()).to(dev)}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    losses, step_ms = [], []

    def timed(batch):
        nonlocal params, opt
        t = time.perf_counter()
        params, opt, m = step_fn(params, opt, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        losses.append(float(m["loss"]))
        return m

    for _ in range(8):
        timed(first)
    pipe.start()
    for _ in range(4):
        timed({"tokens": torch.from_numpy(pipe.next_prefetched()).to(dev)})
    pipe.stop()
    train_launches = launches()
    peak = torch.cuda.max_memory_allocated()
    n_ev: dict[str, int] = {}
    (m, ms_traced), busy = _traced(lambda: (timed(first), step_ms[-1]), n_ev)
    steps = 12
    _say(f"[train] bf16 olmo-1b ({cfg.n_layers} layers, fp32 master weights) on "
         f"[{main[0]}, {main[1]}] tokens: losses on one batch "
         f"{[round(x, 4) for x in losses[:8]]}, then on the pipeline "
         f"{[round(x, 4) for x in losses[8:12]]}")
    assert all(np.isfinite(losses)) and losses[7] < losses[0], losses
    assert train_launches["flash_attention"] == 2 * cfg.n_layers * steps, train_launches
    assert train_launches["flash_attention_bwd"] == cfg.n_layers * steps, train_launches
    ms_med = float(np.median(step_ms[1:12]))
    n_tok = main[0] * main[1]
    n_params = sum(p.numel() for p in leaves(params))
    flops = 6.0 * n_params * n_tok + 6.0 * cfg.n_layers * main[0] * cfg.n_heads * main[1] ** 2 \
        * cfg.hd
    mfu = flops / (ms_med / 1e3) / BF16_FLOPS
    b_ms = sum(busy.values()) / 1e3
    k6f = {k: v for k, v in busy.items() if any(nm in k for nm in FLASH_KERNELS)}
    k6b = {k: v for k, v in busy.items() if any(nm in k for nm in FLASH_BWD_KERNELS)}
    _say(f"[train] step ms {[round(x, 2) for x in step_ms[:12]]} (the first a warm-up), median "
         f"after it {ms_med:.2f} ms, {n_tok / (ms_med / 1e3):.0f} tokens/s; peak device memory "
         f"{peak} bytes ({peak / 2**30:.2f} GiB); {n_params} parameters; launches over {steps} "
         f"steps {train_launches} ({train_launches['flash_attention'] // steps} K6 forward, "
         f"{train_launches['flash_attention_bwd'] // steps} backward a step)")
    _say(f"[train] one step under the profiler: device busy {b_ms:.3f} ms of {ms_traced:.3f} ms "
         f"({100 * b_ms / ms_traced:.2f} %, idle {100 - 100 * b_ms / ms_traced:.2f} %); K6 "
         f"forward {sum(k6f.values()) / 1e3:.3f} ms over {sum(n_ev[k] for k in k6f)} events, "
         f"backward {sum(k6b.values()) / 1e3:.3f} ms over {sum(n_ev[k] for k in k6b)} events; by "
         "function (ms): " + "; ".join(f"{k[:60]} {v / 1e3:.3f}" for k, v in
                                      sorted(busy.items(), key=lambda kv: -kv[1])[:8]))
    _say(f"[train] mfu={mfu:.4f} (6 N T + 6 layers B H L^2 D = {flops:.4g} model flops a step "
         f"over {ms_med:.2f} ms at 989 TFLOP/s bf16)")
    del params, opt, step_fn
    torch.cuda.empty_cache()

    # ---- 25. checkpoint and resume: depth 2, preempted at step 3 --------------
    cfg2 = dataclasses.replace(get_config("olmo-1b"), n_layers=2)
    model2 = build_model(cfg2, device=dev)
    step2 = make_train_step(model2, opt_cfg, {"dtype": bf16})
    pipe2 = TokenPipeline(vocab=cfg2.vocab, batch=ckpt[0], seq=ckpt[1] - 1, seed=1)
    total = 6

    def batch_at(i):
        return {"tokens": torch.from_numpy(pipe2.batch_at(i)).to(dev)}

    ref_p, ref_o = init_train_state(model2, 0)
    ref_losses = []
    for i in range(total):
        ref_p, ref_o, m = step2(ref_p, ref_o, batch_at(i))
        ref_losses.append(float(m["loss"]))
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    ck = AsyncCheckpointer(str(CKPT_DIR), keep=2)
    state = dict(zip(("params", "opt"), init_train_state(model2, 0)))
    losses2, save_ms = [], []

    def step_fn2(i):
        state["params"], state["opt"], m = step2(state["params"], state["opt"], batch_at(i))
        losses2.append(float(m["loss"]))
        if i == 3:
            os.kill(os.getpid(), signal.SIGTERM)

    def save_fn(i):  # ms until save returns (the host snapshot), then until written
        t = time.perf_counter()
        ck.save(i + 1, train_state_to_jax_layout(state))
        save_ms.append((time.perf_counter() - t) * 1e3)
        ck.wait()
        save_ms.append((time.perf_counter() - t) * 1e3)

    with PreemptionGuard() as guard:
        last = run_elastic_loop(total, step_fn2, save_fn, checkpoint_every=0, guard=guard)
    assert last == 3 and guard.should_stop and len(save_ms) == 2
    n_bytes = sum(f.stat().st_size for f in (CKPT_DIR / "step_00000004").iterdir())
    del state
    torch.cuda.synchronize()
    t = time.perf_counter()
    step_no, flat = load_checkpoint(str(CKPT_DIR))
    fresh = dict(zip(("params", "opt"), init_train_state(model2, 7)))
    restored = restore_tree(fresh, flat_from_jax_layout(flat), device=dev)
    torch.cuda.synchronize()
    restore_ms = (time.perf_counter() - t) * 1e3
    del fresh, flat
    p, o = restored["params"], restored["opt"]
    for x in leaves(p):
        x.requires_grad_(True)
    assert step_no == 4 and int(o["step"]) == 4
    for i in range(step_no, total):
        p, o, m = step2(p, o, batch_at(i))
        losses2.append(float(m["loss"]))
    same_p = all(torch.equal(a, w) for a, w in zip(leaves(p), leaves(ref_p)))
    same_o = all(torch.equal(a, w) for a, w in zip(leaves(o), leaves(ref_o)))
    _say(f"[train] checkpoint and resume (2 layers, [{ckpt[0]}, {ckpt[1]}] bf16): preempted "
         f"after step 3 by SIGTERM, AsyncCheckpointer save {save_ms[0]:.1f} ms to return (the host "
         f"snapshot), {save_ms[1]:.1f} ms written, {n_bytes} bytes; restore (load + "
         f"restore_tree onto the card) {restore_ms:.1f} ms; losses "
         f"resumed {[round(x, 5) for x in losses2]} vs uninterrupted "
         f"{[round(x, 5) for x in ref_losses]}: equal bit for bit "
         f"{losses2 == ref_losses}; params {same_p}, m and v {same_o}")
    assert losses2 == ref_losses and same_p and same_o
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    del p, o, ref_p, ref_o, restored
    torch.cuda.empty_cache()

    # ---- 26. K6's backward at the main path's shape ---------------------------
    q, k, v, o, lse, do = olmo_bwd
    ms_b, ev_b, wrap_b = _kernel_ms(lambda: fa.flash_attention_bwd(q, k, v, o, lse, do),
                                    FLASH_BWD_KERNELS, reps=10)
    _, plain_b = _plain_ms(lambda: fa.flash_attention_bwd_ref(q, k, v, o, lse, do))
    qg, kg, vg = (x.detach().clone().requires_grad_(True) for x in (q, k, v))

    def sdpa_fwd():
        return torch.nn.functional.scaled_dot_product_attention(qg, kg, vg, is_causal=True)

    def sdpa_fwd_bwd():
        return torch.autograd.grad(sdpa_fwd(), (qg, kg, vg), do)

    lib_fwd = _events_ms(sdpa_fwd, reps=10)
    lib_b = _events_ms(sdpa_fwd_bwd, reps=10) - lib_fwd
    ops_b, bytes_b = _flash_bwd_work(*q.shape[:3], q.shape[3], True, q.element_size())
    bound_b, by_b = _bound(ops_b, bytes_b, BF16_FLOPS)
    log6b = _build.build_all(["flash_attention_bwd"])["flash_attention_bwd"].ptxas
    variant_b = fa.bwd_kernel_variant(q.dtype, q.shape[3])
    for kname in ("flash_bwd_dkdv_wgmma_kernelILi128E", "flash_bwd_dq_wgmma_kernelILi128E"):
        _say(f"[K6b] {kname.split('ILi')[0]}<128> ({variant_b}): {_ptxas_regs(log6b, kname)} "
             f"registers, spill stores/loads {_ptxas_spills(log6b, kname)} bytes (nvcc -Xptxas -v)")
    _say(f"[K6b] flash_attention_bwd {tuple(q.shape)} bf16 causal: kernels {ms_b:.4f} ms "
         f"(CUDA graph of 10 calls; {_short(ev_b)} ms an event in a trace; wrapper "
         f"{wrap_b:.4f} ms); plain {plain_b:.2f} ms; scaled_dot_product_attention's backward "
         f"{lib_b:.4f} ms (forward and backward {lib_b + lib_fwd:.4f} less forward "
         f"{lib_fwd:.4f}); bound {bound_b:.4f} ms by {by_b} ({ops_b:.4g} operations at 989 "
         f"TFLOP/s, {bytes_b:.4g} bytes); {100 * bound_b / ms_b:.1f} % of the bound")
    return {
        "name": "flash_attention_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "replaces": "none: the JAX package differentiates _sdpa "
                    "(src/repro/models/layers.py:205); no Pallas backward",
        "launches": train_launches["flash_attention_bwd"], "max_abs_err": olmo_bwd_err,
        "ms": ms_b, "plain_ms": plain_b, "bound_ms": bound_b, "bound_by": by_b,
        "library_ms": lib_b,
    }, train_launches


def _ranges(module, table):
    """A context in which each function of ``module`` named in ``table``
    (range name -> function name) runs inside a
    ``torch.profiler.record_function`` range of that name (the module's
    functions wrapped, restored on exit), so a trace can add up each
    part's device time."""
    import contextlib

    import torch

    @contextlib.contextmanager
    def ranges():
        saved = {fn: getattr(module, fn) for fn in table.values()}

        def wrap(fn, label):
            def inner(*args, **kw):
                with torch.profiler.record_function(label):
                    return fn(*args, **kw)
            return inner

        for label, fn in table.items():
            setattr(module, fn, wrap(saved[fn], label))
        try:
            yield
        finally:
            for fn, f in saved.items():
                setattr(module, fn, f)

    return ranges()


def _topi_case(rng, kind, g, tg, k, e):
    """Each token's k distinct experts, from ``rng``: uniform, Zipf skewed,
    or every token's first choice on expert 0."""
    import numpy as np

    if kind == "skewed":
        p = 1.0 / np.arange(1, e + 1) ** 1.2
        out = np.stack([rng.choice(e, k, replace=False, p=p / p.sum()) for _ in range(g * tg)])
        return out.reshape(g, tg, k).astype(np.int64)
    out = np.argsort(rng.random((g, tg, e)), -1)[..., :k]
    if kind == "one_hot":
        hit = out == 0
        out[hit] = out[..., :1].repeat(k, -1)[hit]  # the choices stay distinct
        out[..., 0] = 0
    return out.astype(np.int64)


def _same_dispatch(topi, dev, n_experts: int, cap: int, extra: int) -> int:
    """``moe.assign_slots`` (each choice's slot, the replica plan) and every
    field of ``moe.dispatch`` on ``topi`` [g, tg, k] on ``dev`` equal the
    CPU's, bit for bit; returns the dropped choices."""
    import dataclasses

    import torch

    from repro_torch.models import moe

    topi = topi.cpu()
    runs = []
    for t in (topi.to(dev), topi):
        disp = moe.dispatch(t, n_experts, cap, extra)
        slot, slot_expert = moe.assign_slots(t.reshape(t.shape[0], -1).long(), n_experts, cap,
                                             extra)
        fields = {f.name: getattr(disp, f.name) for f in dataclasses.fields(disp)}
        runs.append({**fields, "slot": slot, "plan": slot_expert})
    for name, x in runs[0].items():
        y = runs[1][name]
        if not isinstance(x, torch.Tensor) or not isinstance(y, torch.Tensor):
            assert x == y, (name, x, y)
            continue
        assert x.dtype == y.dtype and torch.equal(x.cpu(), y), name
    return int((runs[1]["pos"] < 0).sum())


@contextlib.contextmanager
def _plain_attention():
    """The models' attention through K6's plain version (autograd through
    it), not K6 and K6b."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import layers

    layers.flash_attention = fa.flash_attention_ref
    try:
        yield
    finally:
        layers.flash_attention = fa.flash_attention


@contextlib.contextmanager
def _plain_recurrence():
    """RWKV-6's recurrence through K7's plain version (autograd through it),
    not K7 and K7b."""
    from repro_torch.kernels import wkv6 as wk
    from repro_torch.models import rwkv6

    rwkv6.wkv6 = lambda r, k, v, w, u, s0=None, state_out=None: wk.wkv6_ref(r, k, v, w, u, s0)
    try:
        yield
    finally:
        rwkv6.wkv6 = wk.wkv6


def _step_vs_plain(tag, model, batch, opt_cfg, per_call, plain=_plain_attention):
    """One fp32 train step (``loss_fn`` with remat, backward, ``adamw_update``)
    on ``batch`` from seed 0 through the kernels (``per_call``: launches by
    wrapper, asserted) and again with ``plain()`` swapping in autograd
    through their plain version (none launched): the loss (1e-5 relative),
    every gradient (1e-3 of each leaf's largest entry) and the params after
    AdamW (1e-3 of the update), printed on a ``[tag]`` line and asserted.
    Returns the kernels' gradients by leaf path (phases 33, 38 and the
    first of each three from 28 on)."""
    import torch

    from repro_torch.kernels import launches, reset_launches
    from repro_torch.train import adamw_update, init_train_state
    from repro_torch.train.optimizer import leaves

    runs = []
    for swap in (False, True):
        params, opt = init_train_state(model, 0)
        reset_launches()
        with plain() if swap else contextlib.nullcontext():
            loss = model.loss_fn(params, batch, dtype=torch.float32)
            loss.backward()
        torch.cuda.synchronize()
        n = launches()
        assert {k_: n[k_] for k_ in per_call} == (
            dict.fromkeys(per_call, 0) if swap else per_call), n
        # a leaf the loss does not read (hubert's token table) has no
        # gradient: zeros, as make_train_step gives it
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in leaves(params)]
        for p in leaves(params):
            p.grad = None
        p0 = [p.detach().clone() for p in leaves(params)] if not swap else None
        adamw_update(params, grads, opt, opt_cfg)
        runs.append((float(loss.detach()), grads, [p.detach() for p in leaves(params)], p0))
        del opt
    (loss_k, g_k, p_k, p0), (loss_p, g_p, p_p, _) = runs
    names = ["/".join(path) for path in _leaf_paths(params)]
    g_err = {nm: float((a - w).abs().max() / w.abs().max().clamp(min=1e-30))
             for nm, a, w in zip(names, g_k, g_p)}
    worst = max(g_err, key=g_err.get)
    moved = torch.sqrt(sum(((w - a) ** 2).sum() for w, a in zip(p_p, p0)))
    diff = torch.sqrt(sum(((a - w) ** 2).sum() for a, w in zip(p_k, p_p)))
    shape = list(batch.get("tokens", batch.get("prefix_embeds")).shape[:2])
    _say(f"[{tag}] fp32 train step on {shape} ({model.cfg.n_layers} layers at full "
         f"width): loss through {'/'.join(per_call)} {loss_k:.7f} vs the plain version "
         f"{loss_p:.7f}; gradients, max |err| "
         f"over each leaf's largest entry: worst {worst} {g_err[worst]:.3g}; params after AdamW "
         f"differ by {float(diff):.3g} against an update of norm {float(moved):.3g} (tolerances: "
         f"loss 1e-5 relative, gradients 1e-3, params 1e-3 of the update)")
    assert abs(loss_k - loss_p) <= 1e-5 * abs(loss_p)
    assert max(g_err.values()) <= 1e-3
    assert float(diff) <= 1e-3 * float(moved)
    return dict(zip(names, g_k))


def _serve_bf16(tag, model, params, batch, prompts, n_new, n_attn, ranges=None):
    """The bf16 serving main path of a model (phase 34 and the second of
    each three from 28 on): a forward-only ``loss_fn`` over ``batch``
    four times (the first a warm-up; ``n_attn`` K6 launches each, asserted)
    and once under the profiler (inside ``_ranges(*ranges)`` when
    given); then, for a model with a decode step (``prompts`` not None),
    ``greedy_generate`` of ``prompts`` with ``n_new`` new tokens, one decode
    step under the profiler and the host's PyTorch calls in one.  Prints the
    ``[tag]`` lines; returns (the forward's busy microseconds by function,
    its event counts, the ranges' microseconds, the launches)."""
    import contextlib
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.kernels import launches, reset_launches
    from repro_torch.serve import greedy_generate

    bf16 = torch.bfloat16
    shape = list(batch.get("tokens", batch.get("prefix_embeds")).shape[:2])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    def do_forward():
        t = time.perf_counter()
        out = model.loss_fn(params, batch, dtype=bf16)
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t) * 1e3

    step_ms = []

    def timed_step(*args, **kw):
        t = time.perf_counter()
        out = model.decode_step(*args, **kw)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        return out

    reset_launches()
    fwd_ms = []
    for _ in range(4):  # the first is a warm-up
        n0 = launches()["flash_attention"]
        fwd_ms.append(do_forward()[1])
        assert launches()["flash_attention"] - n0 == n_attn, launches()
    spans = {label: 0.0 for label in (ranges[1] if ranges else {})}
    n_ev_fwd: dict[str, int] = {}
    with _ranges(*ranges) if ranges else contextlib.nullcontext():
        (loss, ms_traced), busy_fwd = _traced(do_forward, n_ev_fwd, spans or None)
    traces = [("forward", busy_fwd, ms_traced)]
    served = f"forward-only loss_fn {shape} = {float(loss):.4f}, ms " \
             f"{[round(x, 3) for x in fwd_ms]} (first is the warm-up)"
    if prompts is not None:
        batch_p, l_prompt = prompts.shape
        t = time.perf_counter()
        tokens = greedy_generate(dataclasses.replace(model, decode_step=timed_step), params,
                                 prompts, n_new, dtype=bf16)
        t_gen = time.perf_counter() - t
        serve_launches = launches()
        peak = torch.cuda.max_memory_allocated()
        decode_ms = step_ms[l_prompt:]  # after the prompt's scan
        cache = model.init_cache(batch_p, l_prompt + n_new, dtype=bf16)
        tok = torch.from_numpy(prompts[:, :1]).to(model.device)

        def one_step():
            t = time.perf_counter()
            lg, _ = model.decode_step(params, cache, tok, 0, dtype=bf16)
            torch.cuda.synchronize()
            return lg, (time.perf_counter() - t) * 1e3

        one_step()
        (_, ms_step_traced), busy_dec = _traced(one_step)
        traces.append(("decode step", busy_dec, ms_step_traced))
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            one_step()
        n_calls = sum(1 for ev in prof.events() if ev.cpu_parent is None)
        _say(f"[{tag}] one decode step makes {n_calls} top-level PyTorch calls on the host "
             f"({model.cfg.n_layers} layers)")
        served += (
            f"; greedy_generate of [{batch_p}, {l_prompt}] prompts, {n_new} new tokens in "
            f"{t_gen:.2f} s: {len(step_ms)} decode steps ({l_prompt} of the prompt's scan), ms per "
            f"step ({batch_p} sequences) after the prompt median "
            f"{float(np.median(decode_ms)):.3f} min {min(decode_ms):.3f} max {max(decode_ms):.3f}, "
            f"over all median {float(np.median(step_ms)):.3f}; "
            f"{float(np.median(decode_ms)) / batch_p:.3f} ms per token")
        assert tokens.shape == (batch_p, n_new) and len(step_ms) == l_prompt + n_new - 1
    else:
        serve_launches = launches()
        peak = torch.cuda.max_memory_allocated()
    _say(f"[{tag}] bf16 serving {model.cfg.name}: {served}")
    if prompts is not None:
        _say(f"[{tag}] generated tokens (sequence 0): {tokens[0].tolist()}")
    _say(f"[{tag}] peak device memory {peak} bytes ({peak / 2**30:.2f} GiB); "
         f"launches={serve_launches}")
    _k6_in_trace(tag, "forward", busy_fwd, n_ev_fwd, model.cfg.hd)
    for what, busy, wall in traces:
        assert busy, f"the {what}'s profiler trace holds no device events"
        b_ms = sum(busy.values()) / 1e3
        _say(f"[{tag}] one {what} under the profiler: device busy {b_ms:.3f} ms of {wall:.3f} ms "
             f"({100 * b_ms / wall:.2f} %, idle {100 - 100 * b_ms / wall:.2f} %); by function "
             "(ms): " + "; ".join(f"{k_[:60]} {v / 1e3:.3f}" for k_, v in
                                  sorted(busy.items(), key=lambda kv: -kv[1])[:8]))
    assert np.isfinite(float(loss))
    assert serve_launches["flash_attention"] == 5 * n_attn, serve_launches
    return busy_fwd, n_ev_fwd, spans, serve_launches


class _HostCopy:
    """A copy of device tensors' bytes in page-locked host memory, packed
    into blocks of 1 GiB (a power of two, so the pinned allocator rounds
    nothing up) that every later copy reuses: the training phases keep the
    state after two steps here and compare a second run's with it on the
    card, at the host link's rate and with no page to fault in after the
    first use (pageable copies compared on the host took tens of seconds a
    phase: PERF.md §6).  The blocks stay until the process ends."""

    BLOCK = 1 << 30

    def __init__(self):
        self.blocks: list = []

    def _spans(self, tensors):
        """(a slice of a tensor's bytes, its block, its offset there), the
        tensors' bytes laid end to end."""
        import torch

        pos = 0
        for x in tensors:
            flat = x.detach().reshape(-1).view(torch.uint8)
            at = 0
            while at < flat.numel():
                block, off = divmod(pos, self.BLOCK)
                n = min(flat.numel() - at, self.BLOCK - off)
                yield flat[at:at + n], block, off
                at, pos = at + n, pos + n

    def take(self, tensors) -> None:
        import torch

        need = -(-sum(x.numel() * x.element_size() for x in tensors) // self.BLOCK)
        while len(self.blocks) < need:
            self.blocks.append(torch.empty(self.BLOCK, dtype=torch.uint8,
                                           pin_memory=torch.cuda.is_available()))
        for src, block, off in self._spans(tensors):
            self.blocks[block][off:off + src.numel()].copy_(src, non_blocking=True)
        torch.cuda.synchronize()  # before a step updates them in place

    def equal(self, tensors) -> bool:
        import torch

        differ = None
        for src, block, off in self._spans(tensors):
            back = self.blocks[block][off:off + src.numel()].to(src.device, non_blocking=True)
            d = (back != src).any()
            differ = d if differ is None else differ | d
        return differ is None or not bool(differ)


HOST_COPY = _HostCopy()


def _train_bf16(tag, model, step_fn, batch, per_step, shares, ranges=None, plain=None):
    """bf16 training from seed 0 (phases 35, 39 and the third of each
    three from 28 on): eight steps on ``batch`` (the loss must fall), the
    state after the second kept on the host, a ninth under the profiler
    (inside ``_ranges(*ranges)`` when given); then two steps again from
    seed 0, equal bit for bit in loss, params, m and v; ``per_step``
    launches a step by wrapper (asserted).  With ``plain`` (a context that
    swaps the kernels for autograd through their plain versions), the same
    two steps once more under it: each loss within 2e-2 of the kernels'
    (relative), none of their kernels launched.
    ``shares`` (label -> CUDA function names) picks the kernels whose time
    and share of the traced step's busy time are printed.  Prints the
    ``[tag]`` lines; returns (median ms a step after the first, parameters,
    the traced step's busy microseconds by function, the ranges'
    microseconds, the launches)."""
    import contextlib

    import numpy as np
    import torch

    from repro_torch.kernels import launches, reset_launches
    from repro_torch.train import init_train_state
    from repro_torch.train.optimizer import leaves

    n_steps, t_parts = 8, [time.perf_counter()]
    params, opt = init_train_state(model, 0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    losses, step_ms = [], []

    def timed():
        nonlocal params, opt
        t = time.perf_counter()
        params, opt, m = step_fn(params, opt, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        losses.append(float(m["loss"]))
        return step_ms[-1]

    for i in range(n_steps):
        timed()
        if i == 1:  # the state after two steps, kept on the host
            HOST_COPY.take(leaves(params) + leaves(opt["m"]) + leaves(opt["v"]))
    peak = torch.cuda.max_memory_allocated()
    t_parts.append(time.perf_counter())
    n_ev: dict[str, int] = {}
    spans = {label: 0.0 for label in (ranges[1] if ranges else {})}
    with _ranges(*ranges) if ranges else contextlib.nullcontext():
        ms_traced, busy = _traced(timed, n_ev, spans or None)
    t_parts.append(time.perf_counter())
    steps = n_steps + 1
    n_params = sum(p.numel() for p in leaves(params))
    del params, opt
    torch.cuda.empty_cache()
    # two steps again from the same state on the same batch
    params, opt = init_train_state(model, 0)
    again = []
    for _ in range(2):
        params, opt, m = step_fn(params, opt, batch)
        again.append(float(m["loss"]))
    same = HOST_COPY.equal(leaves(params) + leaves(opt["m"]) + leaves(opt["v"]))
    train_launches = launches()  # the steps above and these two
    t_parts.append(time.perf_counter())
    plain_losses = []
    if plain is not None:  # the same two steps through the plain versions
        del params, opt
        torch.cuda.empty_cache()
        params, opt = init_train_state(model, 0)
        with plain():
            for _ in range(2):
                params, opt, m = step_fn(params, opt, batch)
                plain_losses.append(float(m["loss"]))
        assert launches() == train_launches, launches()
        t_parts.append(time.perf_counter())
    shape = list(batch.get("tokens", batch.get("prefix_embeds")).shape[:2])
    _say(f"[{tag}] bf16 {model.cfg.name} training at full width, depth {model.cfg.n_layers} "
         f"({n_params} parameters; fp32 master weights, AdamW) on {shape} tokens: losses on one "
         f"batch {[round(x, 4) for x in losses[:n_steps]]}")
    _say(f"[{tag}] two steps from the same state and batch, run twice: losses {losses[:2]} and "
         f"{again}; params, m and v equal bit for bit: {same} (seconds: init and {n_steps} "
         f"steps, the state after two copied to the host "
         f"{t_parts[1] - t_parts[0]:.1f}, the traced step {t_parts[2] - t_parts[1]:.1f}, two "
         f"steps again and the comparison {t_parts[3] - t_parts[2]:.1f})")
    assert all(np.isfinite(losses)) and losses[n_steps - 1] < losses[0], losses
    assert again == losses[:2] and same
    if plain_losses:
        # the kernels round P and dS to bf16 where the plain versions keep
        # fp32: about 1e-3 of a loss at step 0, more after an AdamW step
        # that follows each gradient entry's sign
        rel = max(abs(a - w) / abs(w) for a, w in zip(losses[:2], plain_losses))
        _say(f"[{tag}] the same two steps with autograd through the plain versions: losses "
             f"{plain_losses}, against the kernels' {losses[:2]}: largest relative difference "
             f"{rel:.3g} (tolerance 2e-2; {t_parts[4] - t_parts[3]:.1f} s)")
        assert rel <= 2e-2, (losses[:2], plain_losses)
    for name, n in per_step.items():
        assert train_launches[name] == n * (steps + 2), train_launches
    ms_med = float(np.median(step_ms[1:n_steps]))
    b_ms = sum(busy.values()) / 1e3
    _k6_in_trace(tag, "train step", busy, n_ev, model.cfg.hd)
    parts = []
    for label, names in shares.items():
        mine = [k_ for k_ in busy if any(nm in k_ for nm in names)]
        ms_k = sum(busy[k_] for k_ in mine) / 1e3
        parts.append(f"{label} {ms_k:.3f} ms over {sum(n_ev[k_] for k_ in mine)} events "
                     f"({100 * ms_k / b_ms:.2f} % of busy)")
    _say(f"[{tag}] train step ms {[round(x, 2) for x in step_ms[:n_steps]]} (the first a "
         f"warm-up), median after it {ms_med:.2f} ms, "
         f"{shape[0] * shape[1] / (ms_med / 1e3):.0f} tokens/s; "
         f"peak device memory {peak} bytes ({peak / 2**30:.2f} GiB); launches a step {per_step}")
    _say(f"[{tag}] one train step under the profiler: device busy {b_ms:.3f} ms of {ms_traced:.3f} "
         f"ms ({100 * b_ms / ms_traced:.2f} %, idle {100 - 100 * b_ms / ms_traced:.2f} %); "
         + "; ".join(parts) + "; by function (ms): " + "; ".join(
             f"{k_[:60]} {v / 1e3:.3f}" for k_, v in sorted(busy.items(),
                                                         key=lambda kv: -kv[1])[:8]))
    del params, opt
    torch.cuda.empty_cache()
    return ms_med, n_params, busy, spans, train_launches


def _moe_dispatch_share(tag, busy_fwd, n_ev_fwd, spans, beside=""):
    """Prints one traced forward's device busy time by part (``MOE_RANGES``
    around each step of ``moe_ffn``, K6, the rest) and the dispatch's share
    of it (``beside``: text after it); returns that share in %."""
    busy_ms = sum(busy_fwd.values()) / 1e3
    k6_ms = sum(v for k_, v in busy_fwd.items() if any(nm in k_ for nm in FLASH_KERNELS)) / 1e3
    n_k6 = sum(n for k_, n in n_ev_fwd.items() if any(nm in k_ for nm in FLASH_KERNELS))
    span_ms = {label: us / 1e3 for label, us in spans.items()}
    disp_ms = span_ms["moe.dispatch"] + span_ms["moe.gather"] + span_ms["moe.combine"]
    rest = busy_ms - k6_ms - sum(span_ms.values())
    _say(f"[{tag}] the forward's device busy time by part (ms, % of busy): "
         f"expert GEMMs and silu (moe.experts) {span_ms['moe.experts']:.3f} "
         f"({100 * span_ms['moe.experts'] / busy_ms:.2f} %); attention K6 {k6_ms:.3f} over "
         f"{n_k6} events ({100 * k6_ms / busy_ms:.2f} %); router GEMM, softmax and top-k sort "
         f"(moe.route) {span_ms['moe.route']:.3f} ({100 * span_ms['moe.route'] / busy_ms:.2f} %); "
         f"dispatch {disp_ms:.3f}: plan, hash, bin (moe.dispatch) {span_ms['moe.dispatch']:.3f}, "
         f"gather (moe.gather) {span_ms['moe.gather']:.3f}, combine (moe.combine) "
         f"{span_ms['moe.combine']:.3f}; the rest (attention projections, norms, the shared "
         f"expert, the loss) {rest:.3f} ({100 * rest / busy_ms:.2f} %)")
    _say(f"[{tag}] dispatch share of the forward's busy time: {100 * disp_ms / busy_ms:.2f} % "
         f"({disp_ms:.3f} of {busy_ms:.3f} ms; with the router's top-k "
         f"{100 * (disp_ms + span_ms['moe.route']) / busy_ms:.2f} %)"
         + ("" if disp_ms > 0 else ": the trace linked no kernel to the ranges, not measured")
         + beside)
    return 100 * disp_ms / busy_ms


def _moe_layer0_stats(tag, cfg, params, tokens):
    """Layer 0 of a bf16 MoE model on ``tokens``: its drop rate and
    slot-load imbalance (max/mean) at capacity factor 1.25, extra_slots 0
    and 8, printed."""
    import torch

    from repro_torch.models import layers, moe
    from repro_torch.models import transformer as tt

    bf16 = torch.bfloat16
    with torch.no_grad():
        x0 = layers.embed(params["embed"], tokens, bf16)
        blk0 = params["blocks"][0]
        x0 = x0 + layers.attention(blk0["attn"], tt.attn_config(cfg),
                                   layers.apply_norm(cfg.norm, blk0["ln1"], x0))
        h0 = layers.apply_norm(cfg.norm, blk0["ln2"], x0)
        for extra in (0, 8):
            _, _, st = moe.moe_ffn(blk0, h0, cfg, 1.25, extra, return_stats=True)
            loads = st["slot_loads"].double()
            _say(f"[{tag}] layer 0 on the batch, cf 1.25, extra_slots={extra}: dropped "
                 f"{int(st['dropped'])} of {tokens.numel() * cfg.top_k} choices (drop rate "
                 f"{100 * float(st['drop_rate']):.3f} %), slot-load imbalance (max/mean) "
                 f"{float(loads.max() / loads.mean()):.4f}, slot loads max {int(loads.max())} min "
                 f"{int(loads.min())} over {loads.numel()} slots")


def _moe_dispatch_phase(dev, serve=(4, 2048)):
    """Phase 27: the MoE dispatch on the card against the CPU, exactly, and
    ``benchmarks/bench_moe_skew.py``'s skewed layer.  ``serve`` is the
    serving batch whose dispatch is checked; a CPU rehearsal cuts it."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import moe

    f32, bf16 = torch.float32, torch.bfloat16
    full = get_config("qwen2-moe-a2.7b")
    e, k = full.n_experts, full.top_k
    t_phase = time.perf_counter()

    # ---- 27. the dispatch on the card against the CPU, exactly ----------------
    # routing on ties: one-hot tokens read router rows of four values as
    # their logits exactly
    rng = np.random.default_rng(27)
    router = torch.from_numpy(rng.choice([0.0, 0.5, 1.0, 1.5], (64, e)).astype(np.float32))
    for dtype in (f32, bf16):
        x = torch.eye(64, dtype=dtype)[None]
        _, w_cpu, i_cpu = moe.route({"router": router}, x, k)
        _, w_dev, i_dev = moe.route({"router": router.to(dev)}, x.to(dev), k)
        ties = sum(int(len(set(row)) < len(row)) for row in
                   (x.float() @ router).to(dtype).tolist()[0])
        assert torch.equal(i_dev.cpu(), i_cpu), dtype
        assert _max_float_err(w_dev.cpu(), w_cpu) <= 1e-6
        _say(f"[moe] top-{k} of {e} experts on tie-heavy rows ({ties} of 64 rows hold ties, "
             f"{str(dtype)[6:]}): the card's order equals the CPU's (lower index first)")
    n_cases = 0
    for g, tg, kk, ee in [(serve[0], serve[1], k, e), (8, 256, 2, 16)]:
        for kind in ("uniform", "skewed", "one_hot"):
            topi = torch.from_numpy(_topi_case(rng, kind, g, tg, kk, ee))
            drops = []
            for extra in (0, 8, 16):
                for cf in (1.25, 1.0):
                    cap = max(8, int(np.ceil(tg * kk * cf / (ee + extra))))
                    drops.append(f"x{extra}/cf{cf}: {_same_dispatch(topi, dev, ee, cap, extra)}")
                    n_cases += 1
            _say(f"[moe] dispatch [{g}, {tg}] x top-{kk} of {ee} experts, {kind}: card equals CPU "
                 f"in every field (plan, slots, loads, each buffer row's choice and token, the "
                 f"inverse map); "
                 f"dropped {'; '.join(drops)}")
    # benchmarks/bench_moe_skew.py:22-40's cell, on the port's own weights
    cell = dataclasses.replace(full.reduced(), n_experts=16, top_k=2, d_model=64, n_layers=1)
    blk = moe.init_params(cell, 0, dev, f32)["blocks"][0]
    bias = torch.zeros((cell.d_model, cell.n_experts), device=dev)
    bias[:, 0], bias[:, 3] = 0.35, 0.25
    blk["router"] = blk["router"] + bias
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(8, 256, cell.d_model))
                         .astype(np.float32)).to(dev)
    dropped = {}
    for cf in (1.25, 1.0):
        for extra in (0, 8):
            _, _, st = moe.moe_ffn(blk, x, cell, cf, extra, return_stats=True)
            _, _, topi = moe.route(blk, x, cell.top_k)
            cap = max(8, int(np.ceil(256 * cell.top_k * cf / (cell.n_experts + extra))))
            _same_dispatch(topi, dev, cell.n_experts, cap, extra)
            loads = st["slot_loads"].double()
            dropped[cf, extra] = int(st["dropped"])
            _say(f"[moe] skew cell (bench_moe_skew: 16 experts, top-2, d=64, router +0.35 on "
                 f"expert 0 and +0.25 on 3, x [8, 256, 64]) cf={cf} extra_slots={extra}: "
                 f"dropped {dropped[cf, extra]} of {8 * 256 * 2}, drop rate "
                 f"{100 * float(st['drop_rate']):.3f} %, slot-load imbalance (max/mean) "
                 f"{float(loads.max() / loads.mean()):.4f}, loads {loads.long().tolist()}")
    assert dropped[1.25, 8] <= dropped[1.25, 0] and dropped[1.0, 8] <= dropped[1.0, 0], dropped
    _say(f"[moe] phase 27: {n_cases} dispatches equal on card and CPU; SharesSkew drops no more "
         f"than the capacity router at cf 1.25 and 1.0 ({time.perf_counter() - t_phase:.1f} s)")


def _distributed_phase(dev, query, data, plan, base, oracle, base_s, per_run, three):
    """Phase 6b: the distributed shuffle (``run_distributed``) over this
    process's one-rank NCCL group on the card: the §9.1 join at full scale
    against ``run_join`` (``base``, which took ``base_s`` seconds and
    launched K1 ``per_run`` times) and the oracle, then the 3-way query
    (``three``: query, data, plan, ``run_join``'s result, the oracle).
    Returns the phase's kernel launches."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.distributed import resolve_group
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.mapreduce import predicted_comm, run_distributed

    group = resolve_group(None, dev)
    _say(f"[dist] group: backend {group.name()}, world {group.size()}, rank {group.rank()} "
         f"(this process's own, on a private FileStore; torch.distributed initialized: "
         f"{dist.is_initialized()})")
    assert group.size() == 1 and not dist.is_initialized()
    assert group.name() == ("nccl" if dev.type == "cuda" else "gloo")
    reset_launches()
    secs = []
    for _ in range(3):  # the first builds the group and warms the caches
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = run_distributed(query, data, plan, cap_factor=3.0, device=dev)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t)
        assert (res.count, res.checksum) == oracle and res.overflow == 0
        assert (res.count, res.checksum, res.comm_tuples) == (
            base.count, base.checksum, base.comm_tuples)
        assert np.array_equal(res.reducer_loads, base.reducer_loads)
    n = launches()
    _say(f"[dist] §9.1 run_distributed ({group.name()}, world {group.size()}): count={res.count} "
         f"checksum="
         f"{res.checksum} overflow={res.overflow} comm={res.comm_tuples}; equal to run_join in "
         f"count, checksum, every comm_tuples entry and all {res.reducer_loads.size} "
         f"reducer_loads, and to the oracle; wall s {[round(x, 4) for x in secs]} (run_join "
         f"{base_s:.4f}); K1 launches {n['reducer_join']} over 3 runs")
    assert res.comm_tuples == predicted_comm(plan)
    assert n["reducer_join"] == 3 * per_run > 0, n
    q3, d3, plan3, base3, oracle3 = three
    t = time.perf_counter()
    res3 = run_distributed(q3, d3, plan3, cap_factor=5.0, device=dev)
    torch.cuda.synchronize()
    t3 = time.perf_counter() - t
    _say(f"[dist] §9.2 3-way run_distributed: count={res3.count} checksum={res3.checksum} "
         f"overflow={res3.overflow}, oracle {oracle3}; {t3:.3f} s")
    assert (res3.count, res3.checksum) == oracle3 and res3.overflow == 0
    assert res3.comm_tuples == base3.comm_tuples
    assert np.array_equal(res3.reducer_loads, base3.reducer_loads)
    return launches()


def _k6_in_trace(tag, what, busy, n_ev, hd):
    """Prints the K6 and K6b CUDA functions of a trace (``busy``: device us
    by function, ``n_ev``: events) with their events, and asserts that each
    is a wgmma kernel where ``kernel_variant`` names that route for bf16 at
    head dim ``hd`` as the wrapper pads it (D = 64, 80 and 128), so no
    mma.sync kernel (nor its delta pass) runs there."""
    import torch

    from repro_torch.kernels import flash_attention as fa

    dp = fa.padded_head_dim(hd)
    route = fa.kernel_variant(torch.bfloat16, dp)
    mine = {k_: n_ev.get(k_, 0) for k_ in busy
            if any(nm in k_ for nm in FLASH_KERNELS + FLASH_BWD_KERNELS)}
    if not mine:
        return
    _say(f"[trace] {tag} {what}: K6/K6b functions ({route} at D = {dp}): "
         + "; ".join(f"{k_[:90]} x{n}" for k_, n in sorted(mine.items())))
    if route == "bf16_wgmma":
        assert all("wgmma_kernel" in k_ for k_ in mine), mine


def _flash_pair(what, q, k, v, causal, seed):
    """K6 and K6b on a model's own bf16 q, k, v (``what`` names where they
    come from): each against its plain version (2e-2; K6b also by relative
    norm, 1e-2), device time (a CUDA graph of 10 calls), plain time,
    ``scaled_dot_product_attention``'s forward and backward (timed here,
    never called by the port; ``enable_gqa`` where k and v have fewer heads
    than q), the bound, and the wgmma route's registers and spills (``nvcc
    -Xptxas -v``); the output's gradient drawn from ``seed``.  At D = 80
    also the yardstick: the wgmma kernels at D = 128 on q, k, v and dO
    zero-padded to 128 (scale 1/sqrt(80)), held against the plain version
    and timed alone (``padded128_ms``) and, for the forward, with the
    padding copies a call would make (``padded128_route_ms``).  Prints the
    ``[K6]`` and ``[K6b]`` lines; returns the kernels line's numbers of each
    (``ms``, ``plain_ms``, ``bound_ms``, ``bound_by``, ``library_ms``,
    ``max_abs_err``, and at D = 80 the yardstick's)."""
    import math

    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa

    q, k, v = (x.contiguous() for x in (q, k, v))
    h, hkv = q.shape[1], k.shape[1]
    gqa = {"enable_gqa": True} if hkv != h else {}
    mask = ("causal" if causal else "non-causal") + (f", GQA {h}:{hkv}" if gqa else "")
    got = fa.flash_attention(q, k, v, causal=causal)
    want, plain6 = _plain_ms(lambda: fa.flash_attention_ref(q, k, v, causal))
    err6 = _max_float_err(got, want)
    assert _close(got, want, 2e-2), err6
    del got, want
    ms6, ev6, wrap6 = _kernel_ms(lambda: fa.flash_attention(q, k, v, causal=causal),
                                 FLASH_KERNELS, reps=10)
    lib6 = _events_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, is_causal=causal, **gqa), reps=10)
    ops6, bytes6 = _flash_work(*q.shape[:3], q.shape[3], causal, q.element_size(), hkv)
    bound6, by6 = _bound(ops6, bytes6, BF16_FLOPS)
    _say(f"[K6] flash_attention {tuple(q.shape)} bf16 {mask}, {what} "
         f"({fa.kernel_variant(q.dtype, q.shape[3])}): max_abs_err={err6:.3g} (rtol = atol = "
         f"2e-2); kernel {ms6:.4f} ms (CUDA graph of 10 calls; {_short(ev6)} ms an event in a "
         f"trace; wrapper {wrap6:.4f} ms); plain {plain6:.2f} ms; scaled_dot_product_attention "
         f"{lib6:.4f} ms; bound {bound6:.4f} ms by {by6} ({ops6:.4g} operations at 989 TFLOP/s); "
         f"{100 * bound6 / ms6:.1f} % of the bound")
    o, lse = fa.flash_attention_lse(q, k, v, causal=causal)
    do = torch.randn(q.shape, generator=torch.Generator(device=q.device).manual_seed(seed),
                     device=q.device, dtype=torch.float32).to(q.dtype)
    got_b = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    o_ref, lse_ref = fa.flash_attention_ref_lse(q, k, v, causal)
    want_b, plain_b = _plain_ms(lambda: fa.flash_attention_bwd_ref(q, k, v, o_ref, lse_ref, do,
                                                                    causal))
    err_b = max(_max_float_err(x, w) for x, w in zip(got_b, want_b))
    rel_b = max(_rel_norm_err(x, w) for x, w in zip(got_b, want_b))
    assert all(_close(x, w, 2e-2) for x, w in zip(got_b, want_b)) and rel_b <= 1e-2, (err_b, rel_b)
    del got_b, want_b, o_ref, lse_ref
    ms_b, ev_b, wrap_b = _kernel_ms(
        lambda: fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal), FLASH_BWD_KERNELS,
        reps=10)
    qg, kg, vg = (x.detach().clone().requires_grad_(True) for x in (q, k, v))

    def sdpa_fwd():
        return torch.nn.functional.scaled_dot_product_attention(qg, kg, vg, is_causal=causal,
                                                                **gqa)

    lib_fwd = _events_ms(sdpa_fwd, reps=10)
    lib_b = _events_ms(lambda: torch.autograd.grad(sdpa_fwd(), (qg, kg, vg), do), reps=10) \
        - lib_fwd
    ops_b, bytes_b = _flash_bwd_work(*q.shape[:3], q.shape[3], causal, q.element_size(), hkv)
    bound_b, by_b = _bound(ops_b, bytes_b, BF16_FLOPS)
    _say(f"[K6b] flash_attention_bwd {tuple(q.shape)} bf16 {mask}, {what} "
         f"({fa.bwd_kernel_variant(q.dtype, q.shape[3])}): max_abs_err={err_b:.3g} (rtol = atol "
         f"= 2e-2), relative norm {rel_b:.3g} (limit 1e-2); kernels {ms_b:.4f} ms (CUDA graph of "
         f"10 calls; {_short(ev_b)} ms an event in a trace; wrapper {wrap_b:.4f} ms); plain "
         f"{plain_b:.2f} ms; scaled_dot_product_attention's backward {lib_b:.4f} ms; bound "
         f"{bound_b:.4f} ms by {by_b}; {100 * bound_b / ms_b:.1f} % of the bound")
    dp = fa.padded_head_dim(q.shape[3])
    if fa.kernel_variant(q.dtype, dp) == "bf16_wgmma":  # the route's registers and spills
        built = _build.build_all(["flash_attention", "flash_attention_bwd"])
        for src, nm in (("flash_attention", "flash_fwd_wgmma_kernel"),
                        ("flash_attention_bwd", "flash_bwd_dq_wgmma_kernel"),
                        ("flash_attention_bwd", "flash_bwd_dkdv_wgmma_kernel")):
            log, nm = built[src].ptxas, f"{nm}ILi{dp}E"
            _say(f"[K6] {what}: {nm} ({src}.cu): {_ptxas_regs(log, nm)} registers, spill "
                 f"stores/loads {_ptxas_spills(log, nm)} bytes (nvcc -Xptxas -v)")
    fwd = {"ms": ms6, "plain_ms": plain6, "bound_ms": bound6, "bound_by": by6,
           "library_ms": lib6, "max_abs_err": err6}
    bwd = {"ms": ms_b, "plain_ms": plain_b, "bound_ms": bound_b, "bound_by": by_b,
           "library_ms": lib_b, "max_abs_err": err_b}
    if q.shape[3] == 80:  # the yardstick: the D = 128 wgmma kernels on zero-padded inputs
        scale = 1.0 / math.sqrt(80)
        qp, kp, vp, dop = (fa.pad_head_dim(x, 128) for x in (q, k, v, do))
        op, lsep = fa._launch(qp, kp, vp, causal, 80, with_lse=True)
        got_p = fa._launch_bwd(qp, kp, vp, op, lsep, dop, causal, scale)
        want_p = fa.flash_attention_ref(q, k, v, causal)
        err_p = _max_float_err(op[..., :80], want_p)
        o_ref, lse_ref = fa.flash_attention_ref_lse(q, k, v, causal)
        want_b = fa.flash_attention_bwd_ref(q, k, v, o_ref, lse_ref, do, causal)
        rel_p = max(_rel_norm_err(x[..., :80], w) for x, w in zip(got_p, want_b))
        assert _close(op[..., :80], want_p, 2e-2) and rel_p <= 1e-2, (err_p, rel_p)
        del got_p, want_p, o_ref, lse_ref, want_b
        pad_ms = _graph_ms(lambda: fa._launch(qp, kp, vp, causal, 80), 10)
        route_ms = _graph_ms(lambda: fa._launch(
            *(fa.pad_head_dim(x, 128) for x in (q, k, v)), causal, 80)[0][..., :80], 10)
        pad_b = _graph_ms(lambda: fa._launch_bwd(qp, kp, vp, op, lsep, dop, causal, scale), 10)
        _say(f"[K6] the yardstick at {tuple(q.shape)} {mask}: the wgmma kernels at D = 128 on q, "
             f"k, v and dO zero-padded to 128 (max_abs_err {err_p:.3g}, K6b relative norm "
             f"{rel_p:.3g}): K6 {pad_ms:.4f} ms alone, {route_ms:.4f} ms with the padding copies; "
             f"K6b {pad_b:.4f} ms alone (CUDA graphs of 10 calls); the D = 80 route "
             f"{ms6:.4f} and {ms_b:.4f} ms; faster forward: "
             f"{'D = 80' if ms6 <= pad_ms else 'padded'}, backward: "
             f"{'D = 80' if ms_b <= pad_b else 'padded'}")
        fwd.update(padded128_ms=pad_ms, padded128_route_ms=route_ms)
        bwd.update(padded128_ms=pad_b)
        del qp, kp, vp, dop, op, lsep
    return fwd, bwd


def _hybrid_phases(dev, check=(2, 32), grad=(2, 256), serve=(4, 2048),
                   prompt=(4, 128, 32), train=(4, 2048), train_depth=18):
    """Phases 32-36; returns the kernels line's numbers at the hybrid's
    shapes (K6 and K6b: ms, plain ms, bound and what binds it, SDPA's ms,
    max_abs_err) and the hybrid path's launches (phases 34 and 35).  The
    shapes are the card's; a CPU rehearsal cuts them."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline
    from repro_torch.distributed import resolve_group
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.models import build_model, layers, mamba2
    from repro_torch.models import transformer as tt
    from repro_torch.train import (OptConfig, compressed_tree_psum, dequantize, init_residuals,
                                   make_train_step, quantize)
    from repro_torch.train.optimizer import leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    f32, bf16 = torch.float32, torch.bfloat16
    full = get_config("zamba2-2.7b")
    n_groups = full.n_layers // full.hybrid_period
    t_phase = time.perf_counter()

    # ---- 32. fp32 at full width, cut in depth: K6 vs plain, decode vs forward -
    # two invocations of the shared block: the fewest that show its
    # parameters shared across invocations and one KV cache for each
    cfg_c = dataclasses.replace(full, n_layers=2 * full.hybrid_period)
    groups_c = cfg_c.n_layers // cfg_c.hybrid_period
    model = build_model(cfg_c, device=dev)
    params = model.init_params(0, dtype=f32)
    gen = np.random.default_rng(32)
    prompts = torch.from_numpy(gen.integers(0, full.vocab, check).astype(np.int32)).to(dev)
    reset_launches()
    hid = model.forward_hidden(params, {"tokens": prompts}, dtype=f32)
    assert launches()["flash_attention"] == groups_c, launches()
    layers.flash_attention = fa.flash_attention_ref  # the same call, plain attention
    try:
        hid_plain = model.forward_hidden(params, {"tokens": prompts}, dtype=f32)
    finally:
        layers.flash_attention = fa.flash_attention
    err_hid = _max_float_err(hid, hid_plain)
    want = hid @ tt.logits_table(cfg_c, params).T  # [B, L, V] fp32
    cache = model.init_cache(check[0], check[1], dtype=f32)
    err_dec = 0.0
    for pos in range(check[1]):
        logits, cache = model.decode_step(params, cache, prompts[:, pos:pos + 1], pos, dtype=f32)
        assert _close(logits, want[:, pos], 2e-3), pos
        err_dec = max(err_dec, _max_float_err(logits, want[:, pos]))
    _say(f"[hybrid] zamba2-2.7b at full width in fp32, cut to depth {cfg_c.n_layers} ({groups_c} "
         f"invocations of the shared block; {sum(p.numel() for p in leaves(params))} "
         f"parameters): forward_hidden {list(prompts.shape)} through K6 "
         f"({fa.kernel_variant(f32, full.hd)}) vs plain attention: max_abs_err={err_hid:.3g} "
         f"(tolerance 2e-4); token-by-token decode_step logits (the SSD's direct update, conv "
         f"and KV states in place) vs the forward's (chunked SSD) at all {check[1]} positions: "
         f"max_abs_err={err_dec:.3g} (rtol = atol = 2e-3), logits scale "
         f"{float(want.abs().max()):.3g}")
    assert err_hid <= 2e-4
    del hid, hid_plain, want, cache, params
    torch.cuda.empty_cache()

    # ---- 33. one fp32 train step through K6 and K6b against plain attention ---
    opt_cfg = OptConfig(lr=3e-4, warmup_steps=4, total_steps=1000)
    tokens2 = torch.from_numpy(np.random.default_rng(33).integers(0, full.vocab, grad)
                               .astype(np.int32)).to(dev)
    tree = _step_vs_plain("hybrid", model, {"tokens": tokens2}, opt_cfg,
                          {"flash_attention": 2 * groups_c, "flash_attention_bwd": groups_c})
    _say(f"[hybrid] every one of the {len(tree)} gradient leaves nonzero: "
         f"{all(float(g.abs().max()) > 0 for g in tree.values())}")
    assert all(float(g.abs().max()) > 0 for g in tree.values())
    # the int8 gradient all-reduce on this real gradient tree, world one:
    # the mean is the dequantized grid, the residual what it leaves
    reset = init_residuals(tree)
    t = time.perf_counter()
    mean, residual = compressed_tree_psum(tree, reset)
    torch.cuda.synchronize()
    t_c = time.perf_counter() - t
    exact = all(torch.equal(mean[nm], dequantize(*quantize(g)).to(f32))
                and torch.equal(residual[nm], g - mean[nm]) for nm, g in tree.items())
    # each leaf's error against half its grid step, scale / 2 (scale = its
    # largest entry / 127 + 1e-12)
    steps = {nm: float((mean[nm] - g).abs().max() / (g.abs().max() / 127 + 1e-12) / 0.5)
             for nm, g in tree.items()}
    group = resolve_group(None, dev)
    _say(f"[dist] compressed_tree_psum ({group.name()}, world {group.size()}) over the step's "
         f"{len(tree)} gradient leaves ({sum(g.numel() for g in tree.values())} values) in "
         f"{t_c * 1e3:.1f} ms: each mean equals dequantize(quantize(g)) and each residual g - "
         f"mean, bit for bit: {exact}; the largest error is {max(steps.values()):.7f} of half a "
         f"leaf's grid step")
    assert exact and max(steps.values()) <= 1 + 1e-5
    del tree, mean, residual, reset, model
    torch.cuda.empty_cache()

    # ---- 34. bf16 serving at full width and depth, the hybrid's main path -----
    model = build_model(full, device=dev)
    t = time.perf_counter()
    params = model.init_params(0, dtype=bf16)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in leaves(params))
    n_block = sum(p.numel() for p in leaves(params["blocks"][0]))
    n_shared = sum(p.numel() for p in leaves(params["shared_attn"]))
    n_embed = params["embed"]["table"].numel()
    _say(f"[hybrid] zamba2-2.7b at full width and depth in bf16: {full.n_layers} Mamba2 layers, "
         f"d={full.d_model}, d_inner {full.d_inner} ({full.ssm_heads} SSM heads of "
         f"{full.d_inner // full.ssm_heads}, state {full.ssm_state}), a shared block of "
         f"{full.n_heads} heads of {full.hd} and d_ff {full.d_ff} after every "
         f"{full.hybrid_period} ({n_groups} invocations), vocab {full.vocab} tied: {n_params} "
         f"parameters (a Mamba2 block {n_block}, the shared block {n_shared}, the embedding "
         f"{n_embed}; ArchConfig.n_params() says {full.n_params()}), init "
         f"{time.perf_counter() - t:.2f} s")
    batch, l_prompt, n_new = prompt
    long = torch.from_numpy(gen.integers(0, full.vocab, serve).astype(np.int32)).to(dev)
    prompts = gen.integers(0, full.vocab, (batch, l_prompt)).astype(np.int32)
    busy_fwd, n_ev_fwd, spans, serve_launches = _serve_bf16(
        "hybrid", model, params, {"tokens": long}, prompts, n_new, n_groups,
        (mamba2, HYBRID_RANGES))
    busy_ms = sum(busy_fwd.values()) / 1e3
    k6_ms = sum(v for k_, v in busy_fwd.items() if any(nm in k_ for nm in FLASH_KERNELS)) / 1e3
    n_k6 = sum(n for k_, n in n_ev_fwd.items() if any(nm in k_ for nm in FLASH_KERNELS))
    span_ms = {label: us / 1e3 for label, us in spans.items()}
    rest = busy_ms - sum(span_ms.values())
    _say("[hybrid] the forward's device busy time by part (ms, % of busy): the SSD "
         f"(mamba2.ssd, fp32) {span_ms['mamba2.ssd']:.3f} "
         f"({100 * span_ms['mamba2.ssd'] / busy_ms:.2f} %); the shared block (mamba2.shared) "
         f"{span_ms['mamba2.shared']:.3f} ({100 * span_ms['mamba2.shared'] / busy_ms:.2f} %), of "
         f"it K6 {k6_ms:.3f} over {n_k6} events ({100 * k6_ms / busy_ms:.2f} %); the causal "
         f"conv (mamba2.conv) {span_ms['mamba2.conv']:.3f} "
         f"({100 * span_ms['mamba2.conv'] / busy_ms:.2f} %); the rest (in/out projections, "
         f"gating, norms, the head and loss) {rest:.3f} ({100 * rest / busy_ms:.2f} %)")
    _say(f"[hybrid] SSD share of the forward's busy time: "
         f"{100 * span_ms['mamba2.ssd'] / busy_ms:.2f} % ({span_ms['mamba2.ssd']:.3f} of "
         f"{busy_ms:.3f} ms)" + ("" if span_ms["mamba2.ssd"] > 0 else
                                 ": the trace linked no kernel to the range, not measured"))
    assert fa.kernel_variant(bf16, full.hd) == fa.bwd_kernel_variant(bf16, full.hd) == "bf16_wgmma"
    # the shared block's q, k, v at its first invocation, for phase 36
    acfg = tt.attn_config(full)
    with torch.no_grad():
        x = layers.embed(params["embed"], long, bf16)
        for blk in params["blocks"][:full.hybrid_period]:
            x = mamba2._mamba_body(full, blk, x, 64)
        hybrid_qkv = layers.rotated_qkv(params["shared_attn"]["attn"], acfg,
                                        layers.apply_norm(full.norm,
                                                          params["shared_attn"]["ln1"], x))
    del params, long, x
    torch.cuda.empty_cache()

    # ---- 35. bf16 training at full width, cut in depth ------------------------
    # (a third of the 54 layers, three invocations of the shared block: the
    # script's time limit; the path and its checks are the full model's)
    cfg_t = dataclasses.replace(full, n_layers=train_depth)
    groups_t = cfg_t.n_layers // cfg_t.hybrid_period
    model = build_model(cfg_t, device=dev)
    step_fn = make_train_step(model, opt_cfg, {"dtype": bf16})
    pipe = TokenPipeline(vocab=full.vocab, batch=train[0], seq=train[1] - 1, seed=1)
    first = {"tokens": torch.from_numpy(pipe.next_batch()).to(dev)}
    ms_med, _, busy, spans, train_launches = _train_bf16(
        "hybrid", model, step_fn, first,
        {"flash_attention": 2 * groups_t, "flash_attention_bwd": groups_t}, K6_SHARES,
        (mamba2, HYBRID_RANGES))
    n_tok = train[0] * train[1]
    # the matmul parameters a token passes through: every Mamba2 block, the
    # shared block once an invocation, the tied head
    n_eff = n_block * cfg_t.n_layers + n_shared * groups_t + n_embed
    flops = 6.0 * n_eff * n_tok + 6.0 * groups_t * train[0] * full.n_heads * train[1] ** 2 \
        * full.hd
    mfu = flops / (ms_med / 1e3) / BF16_FLOPS
    b_ms = sum(busy.values()) / 1e3
    ssd_ms = spans["mamba2.ssd"] / 1e3
    _say(f"[hybrid] the train step's SSD forwards (remat runs each twice; the backward is outside "
         f"the range) {ssd_ms:.3f} ms of {b_ms:.3f} ms busy ({100 * ssd_ms / b_ms:.2f} %)")
    _say(f"[hybrid] mfu={mfu:.4f} (6 N T + 6 invocations B H L^2 D = {flops:.4g} model flops a "
         f"step, N = {n_eff}: {cfg_t.n_layers} Mamba2 blocks, the shared block {groups_t} times, "
         f"the tied head; over {ms_med:.2f} ms at 989 TFLOP/s bf16)")
    del step_fn, first
    torch.cuda.empty_cache()

    # ---- 36. K6 and K6b at the hybrid's shape ([4, 32, 2048, 80], wgmma) ----
    k6, k6b = _flash_pair("the hybrid's shared block", *hybrid_qkv, causal=True, seed=36)
    del hybrid_qkv
    torch.cuda.empty_cache()
    _say(f"[hybrid] phases 32-36: {time.perf_counter() - t_phase:.1f} s")
    d80 = {"flash_attention": {f"{key}_d80": x for key, x in k6.items()},
           "flash_attention_bwd": {f"{key}_d80": x for key, x in k6b.items()}}
    return d80, {k_: serve_launches.get(k_, 0) + train_launches.get(k_, 0)
                 for k_ in set(serve_launches) | set(train_launches)}


def _attn_pairs(cfg, l):
    """The (query, key) pairs that a forward's attention keeps over a
    sequence of ``l``, summed over the layers and per (batch row, head):
    l^2 without a mask, l (l + 1) / 2 causal, fewer in a windowed layer."""
    from repro_torch.models.transformer import _layer_flags

    def kept(w):
        return w * (w + 1) // 2 + (l - w) * w

    if not cfg.causal:
        return cfg.n_layers * l * l
    return sum(kept(l if is_global or not cfg.window else min(cfg.window, l))
               for is_global in _layer_flags(cfg))


class _Stop(Exception):
    """Ends a forward at its first attention call (``_first_attention``)."""


def _first_attention(run):
    """The q, k and v of the first K6 call that ``run()`` makes: the
    forward is stopped there, so no kernel launches."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import layers

    got = []

    def grab(q, k, v, causal=True):
        got.append((q.detach().clone(), k.detach().clone(), v.detach().clone(), causal))
        raise _Stop

    layers.flash_attention = grab
    try:
        run()
    except _Stop:
        pass
    finally:
        layers.flash_attention = fa.flash_attention
    return got[0]


def _full_size_phases(dev, name, phase, n_attn, train_depth, check=(2, 32), grad=(2, 256),
                      serve=(4, 2048), prompt=(4, 16, 8), train=(4, 2048), qwen2_share=None,
                      check_depth=2, bucket=False):
    """Phases ``phase`` to ``phase + 2`` (28-30, 42-56): the configuration
    ``name`` at full width.  First fp32 cut to ``check_depth`` layers (K6
    against plain attention, decode against the forward, with ``bucket``
    six requests behind ``BucketServer`` against ``greedy_generate``) and
    one train step at depth 2 through K6/K6b against plain attention; then
    bf16 serving at full width and depth (``n_attn`` K6 launches a forward,
    asserted); then bf16 training at ``train_depth`` layers (None: full
    depth), its first two steps also through plain attention.  Returns (the
    serving and training launches; layer 0's bf16 q, k, v and mask on the
    serving batch, None without K6; for MoE the dispatch's share of the
    serving forward's busy time in %, else None).  The shapes are the
    card's; a CPU rehearsal cuts them."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.models import build_model, make_batch, moe
    from repro_torch.models import transformer as tt
    from repro_torch.serve import BucketServer, Request, greedy_generate
    from repro_torch.train import OptConfig, make_train_step
    from repro_torch.train.optimizer import leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    f32, bf16 = torch.float32, torch.bfloat16
    full = get_config(name)
    is_moe, decoder = full.family == "moe", full.has_decoder
    tag = name.split("-")[0]
    # the fp32 checks route at a capacity of a whole group's tokens, so that
    # no choice can drop (a drop in the forward that decoding, one token a
    # group, does not see makes the two differ from that token on)
    kw = {"capacity_factor": full.n_experts / full.top_k} if is_moe else {}
    opt_cfg = OptConfig(lr=3e-4, warmup_steps=4, total_steps=1000)

    def n_k6(cfg):  # K6 launches of one forward: none in a windowed config
        return 0 if cfg.window else cfg.n_layers

    def hidden(model, params, batch, dtype):
        out = model.forward_hidden(params, batch, dtype=dtype, **kw)
        return out[0] if is_moe else out

    # ---- fp32 at full width, cut in depth ------------------------------------
    t_phase = time.perf_counter()
    cfg_c = dataclasses.replace(full, n_layers=check_depth)
    model = build_model(cfg_c, device=dev)
    params = model.init_params(0, dtype=f32)
    batch = make_batch(cfg_c, np.random.default_rng(phase), *check, device=dev)
    reset_launches()
    hid = hidden(model, params, batch, f32)
    assert launches()["flash_attention"] == n_k6(cfg_c), launches()
    with _plain_attention():
        hid_plain = hidden(model, params, batch, f32)
    err_hid = _max_float_err(hid, hid_plain)
    assert err_hid <= 2e-4, err_hid
    line = (f"[{tag}] {name} at full width in fp32, cut to depth {cfg_c.n_layers} "
            f"({sum(p.numel() for p in leaves(params))} parameters): forward_hidden of "
            f"{list(hid.shape[:2])} positions ({sorted(batch)}) through K6 "
            f"({n_k6(cfg_c)} launches) vs plain attention: max_abs_err={err_hid:.3g} "
            f"(tolerance 2e-4)")
    del hid, hid_plain
    if decoder:  # the tokens alone, decoded one at a time against the forward
        tokens = batch["tokens"]
        want = hidden(model, params, {"tokens": tokens}, f32) @ tt.logits_table(cfg_c, params).T
        cache = model.init_cache(check[0], check[1], dtype=f32)
        err_dec = 0.0
        for pos in range(check[1]):
            logits, cache = model.decode_step(params, cache, tokens[:, pos:pos + 1], pos,
                                              dtype=f32, **kw)
            assert _close(logits, want[:, pos], 2e-3), pos
            err_dec = max(err_dec, _max_float_err(logits, want[:, pos]))
        line += (f"; token-by-token decode_step logits vs the forward's at all {check[1]} "
                 f"positions: max_abs_err={err_dec:.3g} (rtol = atol = 2e-3), logits scale "
                 f"{float(want.abs().max()):.3g}")
        del want, cache
    _say(line + (f"; capacity factor {kw['capacity_factor']}" if is_moe else ""))
    if bucket:  # six requests in two waves, each equal to its prompt alone
        gen = np.random.default_rng(phase + 50)
        server = BucketServer(model, params, max_batch=8, dtype=f32)
        reqs = [Request(uid=i, prompt=gen.integers(0, full.vocab, 16 if i % 2 else 32)
                        .astype(np.int32), max_new=8) for i in range(6)]
        for r in reqs:
            server.submit(r)
        t = time.perf_counter()
        done = server.drain()
        t_drain = time.perf_counter() - t
        assert sorted(c.uid for c in done) == list(range(6))
        for c in done:
            solo = greedy_generate(model, params, reqs[c.uid].prompt[None], 8, dtype=f32)
            assert c.tokens.shape == (8,) and np.array_equal(c.tokens, solo[0]), \
                (c.uid, c.tokens, solo[0])
        _say(f"[{tag}] BucketServer fp32: 6 requests (prompts of 16 and 32 tokens, max_new=8) "
             f"drained in two waves in {t_drain:.2f} s; each completion equals greedy_generate "
             f"of its prompt alone")
        del server
    del params, model, batch
    torch.cuda.empty_cache()
    cfg2 = dataclasses.replace(full, n_layers=2)
    model = build_model(cfg2, device=dev)
    gbatch = make_batch(cfg2, np.random.default_rng(phase + 100), *grad, device=dev)
    grads = _step_vs_plain(tag, model, gbatch, opt_cfg,
                           {"flash_attention": 2 * n_k6(cfg2),
                            "flash_attention_bwd": n_k6(cfg2)})
    # q, k, v of attention; the router and the experts; a shared expert's
    # three matrices (named as the experts') and its gate
    names = ("wq", "wk", "wv") + (("router", "w_gate", "w_up", "w_down") if is_moe else ()) \
        + (("shared_gate",) if full.n_shared else ())
    per_layer = 3 + (4 if is_moe else 0) + (4 if full.n_shared else 0)
    nonzero = {nm: float(g.abs().max()) > 0 for nm, g in grads.items()
               if nm.split("/")[-1] in names}
    _say(f"[{tag}] {', '.join(names)} gradients nonzero: {all(nonzero.values())} "
         f"({len(nonzero)} leaves)")
    assert all(nonzero.values()) and len(nonzero) == cfg2.n_layers * per_layer, sorted(nonzero)
    del grads, model, gbatch
    torch.cuda.empty_cache()
    _say(f"[{tag}] phase {phase}: {time.perf_counter() - t_phase:.1f} s")

    # ---- bf16 serving at full width and depth -----------------------------------
    t_phase = time.perf_counter()
    model = build_model(full, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    params = model.init_params(0, dtype=bf16)
    torch.cuda.synchronize()
    t_init, build_peak = time.perf_counter() - t, torch.cuda.max_memory_allocated()
    n_params = sum(p.numel() for p in leaves(params))
    n_mat = sum(p.numel() for p in leaves(params) if p.dim() >= 2)
    # ArchConfig.n_params() counts the matrices, and a gated MLP in every
    # dense family: hubert's MLP is a plain GELU of two; it leaves out a
    # shared expert's gate, a [d, 1] matrix a layer
    gate = full.n_layers * full.d_model * full.d_ff if full.family == "audio" else 0
    shared_gate = full.n_layers * full.d_model if full.n_shared else 0
    weights = sum(p.numel() * p.element_size() for p in leaves(params))
    _say(f"[{tag}] {name} at full width and depth in bf16: {full.n_layers} layers, d="
         f"{full.d_model}, {full.n_heads} heads of {full.hd} ({full.n_kv} kv), d_ff {full.d_ff}"
         + (f", {full.n_experts} experts of {full.d_expert} top-{full.top_k}" if is_moe else "")
         + (f", window {full.window} (every {full.global_period}th layer global)"
            if full.window else "")
         + f", vocab {full.vocab}: {n_params} parameters, {n_mat} in matrices "
         f"(ArchConfig.n_params() {full.n_params()}"
         + (f", less a gate matrix a layer, {gate}" if gate else "")
         + (f", and the shared expert's gates, {shared_gate}" if shared_gate else "") + "; "
         f"n_active_params() {full.n_active_params()}); weights {weights} bytes; init "
         f"{t_init:.2f} s, peak device memory during the build {build_peak} bytes "
         f"({build_peak / 2**30:.2f} GiB)")
    assert n_mat == full.n_params() - gate + shared_gate, (n_mat, full.n_params())
    assert n_attn == n_k6(full), (n_attn, n_k6(full))
    sbatch = make_batch(full, np.random.default_rng(phase + 1), *serve, device=dev)
    batch_p, l_prompt, n_new = prompt
    prompts = np.random.default_rng(phase + 2).integers(
        0, full.vocab, (batch_p, l_prompt)).astype(np.int32) if decoder else None
    busy_fwd, n_ev_fwd, spans, serve_launches = _serve_bf16(
        tag, model, params, sbatch, prompts, n_new, n_attn, (moe, MOE_RANGES) if is_moe else None)
    l_all = sbatch.get("tokens", sbatch.get("prefix_embeds")).shape[1] + (
        sbatch["prefix_embeds"].shape[1] if full.family == "vlm" else 0)
    k6_shape = (serve[0], full.n_heads, l_all, full.hd)
    if n_attn:  # K6 at this model's shape, from the traced forward
        mine = [k_ for k_ in busy_fwd if any(nm in k_ for nm in FLASH_KERNELS)]
        ms_k6 = sum(busy_fwd[k_] for k_ in mine) / 1e3
        bound6, by6 = _bound(*_flash_work(*k6_shape, full.causal, 2, full.n_kv), BF16_FLOPS)
        _say(f"[{tag}] K6 at {list(k6_shape)} bf16 {'causal' if full.causal else 'non-causal'} "
             f"(GQA {full.n_heads}:{full.n_kv}, {fa.kernel_variant(bf16, full.hd)}) in the traced "
             f"forward: {ms_k6:.3f} ms over {sum(n_ev_fwd[k_] for k_ in mine)} events, "
             f"{ms_k6 / n_attn:.4f} ms a call; bound {bound6:.4f} ms by {by6}"
             + (f", {100 * bound6 * n_attn / ms_k6:.1f} % of it" if ms_k6 else ""))
    share = None
    if is_moe:
        beside = ("" if qwen2_share is None else
                  f"; qwen2-moe-a2.7b's in phase 29 of this run {qwen2_share:.2f} %")
        share = _moe_dispatch_share(tag, busy_fwd, n_ev_fwd, spans, beside)
        _moe_layer0_stats(tag, full, params, sbatch["tokens"])
    qkv = None
    if n_attn:  # layer 0's q, k, v on the serving batch, for K6/K6b at this shape,
        # kept on the host so that later phases' peaks read as before
        with torch.no_grad():
            qkv = _first_attention(lambda: model.loss_fn(params, sbatch, dtype=bf16))
        assert tuple(qkv[0].shape) == k6_shape and qkv[1].shape[1] == full.n_kv, \
            [tuple(x.shape) for x in qkv[:3]]
        qkv = (*(x.cpu() for x in qkv[:3]), qkv[3])
    del params, sbatch, model
    torch.cuda.empty_cache()
    _say(f"[{tag}] phase {phase + 1}: {time.perf_counter() - t_phase:.1f} s")

    # ---- bf16 training at full width ----------------------------------------------
    t_phase = time.perf_counter()
    cfg_t = full if train_depth is None else dataclasses.replace(full, n_layers=train_depth)
    model = build_model(cfg_t, device=dev)
    loss_kw = {"dtype": bf16}
    if is_moe:  # the JAX launcher's replica slots
        loss_kw.update(extra_slots=8, capacity_factor=1.25)
    step_fn = make_train_step(model, opt_cfg, loss_kw)
    tbatch = make_batch(cfg_t, np.random.default_rng(1), *train, device=dev)
    if decoder:
        pipe = TokenPipeline(vocab=full.vocab, batch=train[0], seq=train[1] - 1, seed=1)
        tbatch["tokens"] = torch.from_numpy(pipe.next_batch()).to(dev)
    nt = n_k6(cfg_t)
    ms_med, _, busy, _, train_launches = _train_bf16(
        tag, model, step_fn, tbatch, {"flash_attention": 2 * nt, "flash_attention_bwd": nt},
        K6_SHARES, plain=_plain_attention if nt else None)
    if nt:  # K6b at this model's shape, from the traced step
        ms_b = sum(v for k_, v in busy.items() if any(nm in k_ for nm in FLASH_BWD_KERNELS)) / 1e3
        bound_b, by_b = _bound(*_flash_bwd_work(*k6_shape, full.causal, 2, full.n_kv), BF16_FLOPS)
        _say(f"[{tag}] K6b at {list(k6_shape)} bf16 ({fa.bwd_kernel_variant(bf16, full.hd)}) in "
             f"the traced step: {ms_b:.3f} ms over {nt} calls, {ms_b / nt:.4f} ms a call; bound "
             f"{bound_b:.4f} ms by {by_b}"
             + (f", {100 * bound_b * nt / ms_b:.1f} % of it" if ms_b else ""))
    # model flops: 6 N T over the positions (patches included) with N the
    # matrices a position passes through (MoE: n_active_params of the cut
    # config), and 12 D a kept (query, key) pair a head
    l_all = train[1] + (tbatch["prefix_embeds"].shape[1] if full.family == "vlm" else 0)
    n_eff = cfg_t.n_active_params() if is_moe else cfg_t.n_params() - (
        cfg_t.n_layers * cfg_t.d_model * cfg_t.d_ff if gate else 0)
    flops = 6.0 * n_eff * train[0] * l_all \
        + 12.0 * train[0] * cfg_t.n_heads * cfg_t.hd * _attn_pairs(cfg_t, l_all)
    mfu = flops / (ms_med / 1e3) / BF16_FLOPS
    _say(f"[{tag}] mfu={mfu:.4f} (6 N T + 12 B H D pairs = {flops:.4g} model flops a step, N = "
         f"{n_eff}{' active' if is_moe else ''} of depth {cfg_t.n_layers}, T = {train[0]} x "
         f"{l_all} positions; over {ms_med:.2f} ms at 989 TFLOP/s bf16"
         + ("; extra_slots 8, cf 1.25)" if is_moe else ")"))
    del step_fn, tbatch, model
    torch.cuda.empty_cache()
    _say(f"[{tag}] phase {phase + 2}: {time.perf_counter() - t_phase:.1f} s")
    return {k_: serve_launches.get(k_, 0) + train_launches.get(k_, 0)
            for k_ in set(serve_launches) | set(train_launches)}, qkv, share


def _leaf_paths(tree, prefix=()):
    """Paths of ``train.optimizer.leaves(tree)``, in its order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [p for key in sorted(tree) for p in _leaf_paths(tree[key], prefix + (str(key),))]
    if isinstance(tree, list):
        return [p for i, sub in enumerate(tree) for p in _leaf_paths(sub, prefix + (str(i),))]
    return [prefix]


def _recovery_phase(dev, batches, q=1000):
    """Phase 10b: recovery, checkpoint and restore of the fused engine on
    phase 7's batches.  Returns the phase's kernel launches."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from repro_torch.core import two_way
    from repro_torch.kernels import block_join as bj
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.mapreduce import groupby_oracle_two_way
    from repro_torch.stream import (
        ObsPolicy,
        RecoveryPolicy,
        RetentionPolicy,
        StreamConfig,
        StreamingJoinEngine,
    )
    from repro_torch.testing import FaultInjector, FaultSpec

    cfg = StreamConfig(q=q, decay=0.5, load_factor=2.0, fused_ingest=True,
                       retention=RetentionPolicy(window_batches=4),
                       recovery=RecoveryPolicy(n_hosts=8), obs=ObsPolicy(trace=True))
    inj = FaultInjector([FaultSpec(kind="host_loss", target="host", host_id=2, batch=3)])
    in_recovery: list[dict[str, int]] = []
    checks = []  # (spec, bins, valids, info, label): the first engine's verify joins

    def count_recoveries(eng, keep=False):
        """Launches of each recovery of ``eng``, from inside ``_recover``;
        with ``keep``, a few reducers' operands of its verify join."""
        inner = eng._recover

        def counted(lost_hosts, bid):
            before = launches()
            lost = np.flatnonzero(np.isin(eng._hosts.host_of, lost_hosts)).tolist()
            rep = inner(lost_hosts, bid)
            torch.cuda.synchronize()
            in_recovery.append({k: n - before[k] for k, n in launches().items()
                                if n - before[k]})
            if keep:  # the carried bins as the verify joined them
                among = lost if rep.mode == "replay" else ()
                checks.append((*_verify_subset(eng, among), f"batch {bid} {rep.mode}"))
            return rep
        eng._recover = counted

    def timed(fn):
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t) * 1e3

    t_phase = time.perf_counter()
    reset_launches()
    eng = StreamingJoinEngine(two_way(), cfg, device=dev)
    eng.arm_faults(inj)
    count_recoveries(eng, keep=True)
    ms = [timed(lambda: eng.ingest(b))[1] for b in batches[:4]]
    assert len(eng.recoveries) == 1, eng.recoveries
    rep = eng.recoveries[0]
    _say(f"[recovery] batch {rep.batch}: mode={rep.mode} lost hosts {rep.lost_hosts}, "
         f"{rep.lost_reducers} of {rep.reducers_before} reducers, replayed "
         f"{rep.replayed_tuples}/{rep.lost_share_tuples} lost-share tuples from "
         f"{rep.batches_replayed} batches, verified={rep.verified}; launches inside "
         f"{in_recovery[0]}; ingest ms {[round(x, 1) for x in ms]}")
    assert (rep.batch, rep.lost_hosts, rep.mode) == (3, (2,), "replay") and rep.verified
    assert rep.replayed_tuples == rep.lost_share_tuples > 0
    assert rep.reducers_before == rep.reducers_after and rep.migrated_tuples == 0
    caps = {nm: tuple(b.shape) for nm, (b, _, _) in eng._state.items()}
    pairs = caps["R"][1] * caps["S"][1]
    _say(f"[recovery] carried bins {caps}: cap_r x cap_s = {pairs} "
         f"({'below' if pairs < bj.PAIR_LIMIT else 'at or above'} the block join's 2^31 a "
         f"launch: the verify join takes {-(-caps['R'][1] // ((bj.PAIR_LIMIT - 1) // caps['S'][1]))} "
         f"slice(s) of R's rows)")

    ckpt = tempfile.mkdtemp(prefix="ckpt_", dir=ROOT / "build")
    try:
        path, save_ms = timed(lambda: eng.save_checkpoint(ckpt))
        n_bytes = sum(f.stat().st_size for f in Path(path).iterdir())
        before = launches()
        back, restore_ms = timed(lambda: StreamingJoinEngine.restore(
            ckpt, two_way(), cfg, device=dev))
        restore_launches = {k: n - before[k] for k, n in launches().items() if n - before[k]}
    finally:
        shutil.rmtree(ckpt)
    back.arm_faults(inj)
    count_recoveries(back)
    _say(f"[checkpoint] {n_bytes} bytes ({len(eng._retained_ids)} retained batches) saved in "
         f"{save_ms:.1f} ms; restored in {restore_ms:.1f} ms, rebuild included (launches "
         f"{restore_launches})")
    assert back.reports == eng.reports and back.recoveries == eng.recoveries
    assert restore_launches.get("fused_ingest_dense", 0) > 0, restore_launches

    for b in batches[4:]:
        rep_a, ms_a = timed(lambda: eng.ingest(b))
        rep_b, ms_b = timed(lambda: back.ingest(b))
        _say(f"[checkpoint] batch {rep_a.batch}: original {ms_a:.1f} ms, restored "
             f"{ms_b:.1f} ms; expired {rep_a.expired_batches} (retracted "
             f"{rep_a.retracted_count}); window count {rep_a.window_count}")
        assert rep_a == rep_b, f"restored batch {rep_a.batch} differs"
    assert eng.expired_batches == back.expired_batches == 2
    assert len(eng.recoveries) == len(back.recoveries) == 1  # batch 3's fault fired once
    assert len(inj.events) == 1

    degrade = [timed(lambda: e.fail_hosts([0, 1, 3, 4])) for e in (eng, back)]
    (deg, deg_ms), (deg_b, deg_b_ms) = degrade
    _say(f"[recovery] degrade: {deg.survivors} of 8 hosts left, mode={deg.mode}, reducers "
         f"{deg.reducers_before} -> {deg.reducers_after}, migrated {deg.migrated_tuples}, "
         f"verified={deg.verified}; {deg_ms:.1f} / {deg_b_ms:.1f} ms (original / restored); "
         f"launches inside {in_recovery[1]} / {in_recovery[2]}")
    assert deg == deg_b and deg.mode == "degrade" and deg.verified
    inj.assert_all_resolved()

    want, oracle_s = timed(lambda: groupby_oracle_two_way(two_way(), eng.history_data()))
    for e in (eng, back):
        assert (e.window_count, e.window_checksum) == want
    _say(f"[recovery] window count={eng.window_count} checksum={eng.window_checksum} equals "
         f"the host oracle on both engines ({oracle_s / 1e3:.2f} s on the host)")
    spans: dict[str, list[float]] = {}
    for ev in eng.obs.tracer.events:
        if ev.get("ph") == "X" and ev["name"].startswith(("recovery.", "checkpoint.")):
            spans.setdefault(ev["name"], []).append(ev["dur"] / 1e3)
    _say("[recovery] spans of the original engine (ms): " + "; ".join(
        f"{nm} {[round(d, 1) for d in durs]}" for nm, durs in sorted(spans.items())))
    assert in_recovery[0].get("reducer_join", 0) > 0, in_recovery
    assert in_recovery[1].get("fused_ingest_dense", 0) > 0, in_recovery
    _say(f"[recovery] phase 10b: {time.perf_counter() - t_phase:.1f} s")
    phase_launches = launches()  # the checks' own launches are not the path's
    for *subset, label in checks:
        _check_verify_join(*subset, label, dev)
    return phase_launches


def _speculative_phase(dev, query, data, plan, base, base_s):
    """Phase 4b: the §9.1 join through ``run_join_speculative`` on the card,
    clean, under one fault of each shard class, and with one attempt and a
    dropped shard (which must raise).  Returns the clean run's launches."""
    import numpy as np
    import torch

    from repro_torch.kernels import launches, reset_launches
    from repro_torch.mapreduce import run_join_speculative, straggler
    from repro_torch.testing import FaultInjector, FaultSpec

    runs = []  # the ShardOutcome lists of each run, for the prints
    inner = straggler.run_with_speculation

    def kept(*args, **kw):
        out = inner(*args, **kw)
        runs.append(out)
        return out

    def speculative(**kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = run_join_speculative(query, data, plan, cap_factor=3.0, n_shards=4,
                                   max_workers=4, device=dev, **kw)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t

    def shards(outcomes):
        return "; ".join(f"shard {o.shard_id}: {o.attempts} attempt(s), "
                         f"{'backup' if o.speculated else 'no backup'}, "
                         f"{o.elapsed_s * 1e3:.1f} ms" for o in outcomes)

    def same(res, label):
        assert (res.count, res.checksum, res.comm_tuples, res.overflow) == (
            base.count, base.checksum, base.comm_tuples, 0), label
        # the shards' loads: a sub-plan hashes each residual under its index
        # in the sub-plan (as the JAX package's does), so the per-reducer
        # loads of a shard past the first differ from run_join's; their
        # count, their sum and the first shard's block agree
        k0 = plan.residuals[0].num_reducers
        assert res.reducer_loads.shape == base.reducer_loads.shape, label
        assert int(res.reducer_loads.sum()) == int(base.reducer_loads.sum()), label
        assert np.array_equal(res.reducer_loads[:k0], base.reducer_loads[:k0]), label

    straggler.run_with_speculation = kept
    try:
        reset_launches()
        clean, clean_s = speculative()
        clean_launches = launches()
        n_shards = len(runs[-1])
        same(clean, "clean")
        _say(f"[speculative] {n_shards} shard(s) of {len(plan.residuals)} residual joins "
             f"(n_shards=4 capped by the residuals), max_workers=4: count={clean.count} "
             f"checksum={clean.checksum} comm={clean.comm_tuples} overflow={clean.overflow} "
             f"equal run_join's; {clean_s:.4f} s against run_join's {base_s:.4f} s; "
             f"{shards(runs[-1])}; K1 launches {clean_launches['reducer_join']}; loads "
             f"equal run_join's per reducer: "
             f"{np.array_equal(clean.reducer_loads, base.reducer_loads)}")
        assert clean_launches["reducer_join"] >= n_shards, clean_launches
        assert n_shards == min(4, len(plan.residuals))

        last = n_shards - 1
        inj = FaultInjector([
            FaultSpec(kind="drop", shard_id=0, attempt=1),
            FaultSpec(kind="delay", shard_id=0, attempt=2, delay_s=0.2),
            FaultSpec(kind="duplicate", shard_id=last),
            FaultSpec(kind="preempt", shard_id=last, attempt=1),
            FaultSpec(kind="corrupt_result", shard_id=last, attempt=2),
        ])
        before = launches()["reducer_join"]
        faulted, faulted_s = speculative(injector=inj, checksum_results=True)
        same(faulted, "faulted")
        inj.assert_all_resolved()
        _say(f"[speculative] under drop, delay, duplicate, preempt and corrupt_result: "
             f"exact in {faulted_s:.4f} s; {shards(runs[-1])}; faults {inj.report()}; "
             f"K1 launches {launches()['reducer_join'] - before}")
        assert inj.report().unresolved == 0

        inj = FaultInjector([FaultSpec(kind="drop", shard_id=0, attempt=1)])
        raised = None
        try:
            speculative(injector=inj, max_attempts=1)
        except RuntimeError as e:
            raised = e
        assert raised is not None and "shard 0" in str(raised), raised
        inj.assert_all_resolved()
        _say(f"[speculative] max_attempts=1 with shard 0 dropped raises: {raised}")
    finally:
        straggler.run_with_speculation = inner
    return clean_launches


def _tenancy_phase(dev, batches, solo_reports, solo_ms, q=1000):
    """Phase 10c: three tenants over phase 7's six batches behind one
    ingest, t1 poisoned at batch 2, a checkpoint after batch 3 restored
    into a new engine that takes batches 4 and 5.  Returns the phase's
    kernel launches."""
    import os
    import shutil
    import tempfile

    import torch

    from repro_torch.core import two_way
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.mapreduce import groupby_oracle_two_way
    from repro_torch.stream import (
        QUARANTINED,
        RUNNING,
        MultiQueryEngine,
        ObsPolicy,
        StreamConfig,
        TenantSpec,
    )
    from repro_torch.testing import FaultInjector, FaultSpec

    cfg = StreamConfig(q=q, decay=0.5, load_factor=2.0, fused_ingest=True,
                       obs=ObsPolicy(trace=True))  # phase 7's
    specs = [TenantSpec("t0", two_way(), cfg, weight=2.0), TenantSpec("t1", two_way(), cfg),
             TenantSpec("t2", two_way(), cfg)]
    inj = FaultInjector([FaultSpec(kind="poison_rows", target="tenant", tenant="t1", batch=2,
                                   poison="nan")])

    def timed(fn):
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t) * 1e3

    def ingest(mq, i):
        out, ms = timed(lambda: mq.ingest(batches[i]))
        served = [nm for nm, r in sorted(out.items()) if r is not None]
        solo = solo_ms[i] * len(served)
        _say(f"[tenancy] batch {i}: {ms:.1f} ms for {len(served)} tenant(s) {served} against "
             f"{solo:.1f} ms solo (phase 7's {solo_ms[i]:.1f} ms each; {ms / solo:.3f}x); "
             f"states {[st.state for _, st in sorted(mq.status().items())]}")
        for nm in ("t0", "t2"):
            assert out[nm] == solo_reports[i], f"{nm} batch {i} differs from phase 7"
        return out

    t_phase = time.perf_counter()
    reset_launches()
    mq = MultiQueryEngine(specs, device=dev)
    mq.arm_faults(inj)
    outs = [ingest(mq, i) for i in range(4)]
    assert outs[2]["t1"] is None and outs[3]["t1"] is None
    status = mq.status()
    assert status["t1"].state == QUARANTINED, status
    passes = mq.shared_sketch_passes
    private = {nm: mq.engine(nm).sketch_ingest_calls for nm in status}

    ckpt = tempfile.mkdtemp(prefix="tenancy_", dir=ROOT / "build")
    try:
        _, save_ms = timed(lambda: mq.save_checkpoint(ckpt))
        n_bytes = sum(os.path.getsize(os.path.join(dp, f))
                      for dp, _, fs in os.walk(ckpt) for f in fs)
        before = launches()
        back, restore_ms = timed(lambda: MultiQueryEngine.restore(ckpt, specs, device=dev))
        restore_launches = {k: n - before[k] for k, n in launches().items() if n - before[k]}
    finally:
        shutil.rmtree(ckpt)
    def breaker(st):  # what the control namespace keeps (not last_error)
        return {nm: (t.state, t.failures, t.reopens, t.quarantined_until) for nm, t in st.items()}

    assert breaker(back.status()) == breaker(status) and back.batches == 4
    for nm in status:
        assert back.engine(nm).reports == mq.engine(nm).reports, nm
    del mq
    _say(f"[tenancy] checkpoint of 3 tenants + control: {n_bytes} bytes in {save_ms:.1f} ms; "
         f"restored in {restore_ms:.1f} ms, rebuilds included (launches {restore_launches}); "
         f"t1 {back.status()['t1'].state} until batch {back.status()['t1'].quarantined_until} "
         f"after the restore")
    assert restore_launches.get("fused_ingest_dense", 0) > 0, restore_launches
    back.arm_faults(inj)
    outs += [ingest(back, i) for i in range(4, len(batches))]
    passes += back.shared_sketch_passes
    inj.assert_all_resolved()
    phase_launches = launches()

    final = back.status()
    assert final["t1"].state == RUNNING and final["t1"].reopens == 1, final
    assert inj.report().contained == 1
    sketched = 2  # the join column B in R and in S
    assert passes == sketched * len(batches), passes
    assert phase_launches["cms_update"] == passes, (phase_launches, passes)
    assert all(n == 0 for n in private.values()), private
    assert all(back.engine(nm).sketch_ingest_calls == 0 for nm in final)
    for nm in final:
        eng = back.engine(nm)
        want, oracle_ms = timed(lambda: groupby_oracle_two_way(two_way(), eng.history_data()))
        assert (eng.total_count, eng.total_checksum) == want, nm
        _say(f"[tenancy] {nm}: {len(eng.reports)} batches, count={eng.total_count} "
             f"checksum={eng.total_checksum} equal the host oracle ({oracle_ms / 1e3:.2f} s)")
    _say(f"[tenancy] shared sketch passes {passes} (= {sketched} columns x {len(batches)} "
         f"batches), K4 launches {phase_launches['cms_update']}, private passes 0; launches in "
         f"the phase {phase_launches}")
    _say(f"[tenancy] phase 10c: {time.perf_counter() - t_phase:.1f} s")
    return phase_launches


def _verify_subset(eng, among=()):
    """(spec, bins, valids, what they are) of a few of ``eng``'s reducers,
    copied on the host from the carried state the recovery verify joins:
    the one with most candidate pairs, the one with most R rows, the one
    whose R rows fall in most of the verify's slices, the median by pairs,
    and the one of ``among`` with most R rows."""
    import numpy as np

    from repro_torch.mapreduce.local_join import slice_rows

    r_ok, s_ok = eng._state["R"][1], eng._state["S"][1]
    cap_r, cap_s = r_ok.shape[1], s_ok.shape[1]
    step = slice_rows(cap_r, cap_s)
    n_r, n_s = r_ok.sum(1), s_ok.sum(1)
    pairs = n_r * n_s
    in_slice = np.stack([r_ok[:, lo:lo + step].any(1) for lo in range(0, cap_r, step)]).sum(0)
    pick = {int(pairs.argmax()), int(n_r.argmax()), int((in_slice * cap_r + n_r).argmax()),
            int(np.argsort(pairs, kind="stable")[pairs.size // 2])}
    among = [k for k in among if k < n_r.size]
    if among:
        pick.add(among[int(n_r[among].argmax())])
    idx = sorted(pick)
    bins = {nm: b[idx] for nm, (b, _, _) in eng._state.items()}
    valids = {nm: v[idx] for nm, (_, v, _) in eng._state.items()}
    info = {"bins": (tuple(eng._state["R"][0].shape), tuple(eng._state["S"][0].shape)),
            "slice_rows": step, "reducers": idx, "r_rows": n_r[idx].tolist(),
            "s_rows": n_s[idx].tolist(), "slices_holding_r": in_slice[idx].tolist()}
    return eng.spec, bins, valids, info


def _check_verify_join(spec, bins, valids, info, label, dev):
    """Hold the recovery verify's block join on a few reducers' carried
    bins (``_verify_subset``) against its plain version on the card,
    through the operands ``_state_join_fingerprint`` builds: each slice of R's
    rows through ``reducer_join`` against ``block_join_ref`` on that
    slice, and ``_binary_count_checksum`` of each reducer, which slices as
    the verify does, against ``block_join_ref`` summed over the whole
    reducer.  Exact (max_abs_err 0)."""
    import torch

    from repro_torch.kernels import block_join as bj
    from repro_torch.mapreduce.local_join import _binary_count_checksum, binary_join_operands

    sub = binary_join_operands(
        spec, {nm: torch.from_numpy(b).to(dev) for nm, b in bins.items()},
        {nm: torch.from_numpy(v).to(dev) for nm, v in valids.items()})
    r_keys, r_w, s_keys, s_w = sub
    step = info["slice_rows"]
    t = time.perf_counter()
    err, sums = 0, []
    for lo in range(0, r_keys.shape[1], step):
        part = (r_keys[:, lo:lo + step].contiguous(), r_w[:, lo:lo + step].contiguous(),
                s_keys, s_w)
        err = max(err, _max_abs_err(bj.reducer_join(*part), bj.block_join_ref(*part)))
    for i in range(r_keys.shape[0]):
        cnt, chk = _binary_count_checksum(*(x[i:i + 1] for x in sub))
        sums.append(torch.stack([cnt, chk]))
    # the whole reducer's reference in int64, over R chunks of its own
    # (2^30 pairs, where the reference's int32 count cannot wrap)
    want = torch.zeros((r_keys.shape[0], 2), dtype=torch.int64, device=r_keys.device)
    chunk = max(1, (1 << 30) // max(s_keys.shape[1], 1))
    for lo in range(0, r_keys.shape[1], chunk):
        cnt, chk = bj.block_join_ref(r_keys[:, lo:lo + chunk], r_w[:, lo:lo + chunk],
                                     s_keys, s_w)
        want[:, 0] += cnt.long()
        want[:, 1] = (want[:, 1] + (chk.long() & 0xFFFFFFFF)) & 0xFFFFFFFF
    err_sum = _max_abs_err([torch.stack(sums)], [want])
    torch.cuda.synchronize()
    _say(f"[recovery] {label} verify join, K1 against block_join_ref on reducers "
         f"{info['reducers']} of bins {info['bins']} (R rows {info['r_rows']}, S rows "
         f"{info['s_rows']}, R rows in {info['slices_holding_r']} slice(s) of "
         f"{step} rows): max_abs_err={err} a slice, {err_sum} a reducer summed over its "
         f"slices (count, checksum {want.tolist()}); "
         f"{time.perf_counter() - t:.1f} s")
    assert err == 0 and err_sum == 0, (label, err, err_sum)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [] if tree is None else [tree]


def main() -> int:
    if not (SRC / "repro_torch").is_dir():
        print("chip_smoke.py: run it from the root of a checkout (no src/repro_torch here)",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    sys.path.insert(0, str(ROOT / "tests"))
    import numpy as np

    from repro_torch.core import plan_shares_skew, three_way_paper, two_way
    from repro_torch.data import paper_2way, paper_3way
    from repro_torch.kernels import _build, launches, reset_launches
    from repro_torch.kernels import block_join as bj
    from repro_torch.kernels import ingest_fused as fi
    from repro_torch.kernels import sketch_update as su
    from repro_torch.mapreduce.keys import static_route_table
    from repro_torch.stream import ObsPolicy, StreamConfig, StreamingJoinEngine
    from repro_torch.mapreduce import (
        LocalJoinSpec,
        binary_join_operands,
        groupby_oracle_two_way,
        map_and_bin,
        oracle_join,
        predicted_comm,
        run_join,
    )
    from repro_torch.mapreduce.hashing import row_weight_torch
    from torch_cases import wide_routes

    t_all = time.perf_counter()
    dev = torch.device("cuda")

    # ---- 1. the card ------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    _say(f"[card] nvidia-smi: {smi}")
    _say(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
         f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    a = torch.ones((2, 3, 4), dtype=torch.int32, device=dev)
    try:  # a probe of PyTorch, not a phase: either answer is reported
        torch.einsum("kab,kbc->kac", a, a.transpose(1, 2).contiguous())
        torch.cuda.synchronize()
        _say("[card] int32 einsum on CUDA: runs")
    except RuntimeError as e:
        _say(f"[card] int32 einsum on CUDA: raises ({str(e).splitlines()[0][:120]})")

    # ---- 2. build ----------------------------------------------------------
    built = _build.build_all()
    for b in built.values():
        _say(f"[build] {b.name}: {b.seconds:.2f} s nvcc -> {b.path.name}")
        for line in b.ptxas.splitlines():
            _say(f"[build]   {line.strip()}")

    # ---- 3. kernels against their plain versions, assorted shapes -----------
    rng = np.random.default_rng(0)
    for k, cap_r, cap_s, c in [(1, 8, 8, 1), (3, 100, 77, 1), (5, 513, 1030, 2),
                               (2, 2049, 4100, 3), (6, 3008, 3008, 1), (4, 700, 9, 8),
                               (3, 2500, 700, 9), (2, 1100, 3000, 12)]:
        ops = [rng.integers(0, 5, (k, cap_r, c)), rng.integers(-1, 4, (k, cap_r)),
               rng.integers(0, 5, (k, cap_s, c)), rng.integers(-1, 4, (k, cap_s))]
        ops = [torch.from_numpy(o.astype(np.int32)).to(dev) for o in ops]
        got = bj.reducer_join(*ops)
        torch.cuda.synchronize()
        want = bj.block_join_ref(*ops)
        err = _max_abs_err(got, want)
        _say(f"[check] reducer_join K={k} cap_r={cap_r} cap_s={cap_s} C={c} "
             f"(chunk, slots)={bj.chunk_geometry(cap_r, c)}: max_abs_err={err}")
        assert err == 0
    n = 256  # the wraparound case of the reference kernel tests
    z = torch.zeros((n, 1), dtype=torch.int32, device=dev)
    w = torch.full((n,), 40_000, dtype=torch.int32, device=dev)
    cnt, chk = bj.flat_join(z, w, z, w)
    assert int(cnt) == n * n and int(chk) & 0xFFFFFFFF == (40_000 * 40_000 * n * n) % (1 << 32)
    for n_r, n_s, c in [(5000, 3001, 2), (1, 1, 1), (70_000, 1_000, 1), (10_000, 3_000, 12)]:
        ops = [rng.integers(0, 50, (n_r, c)), rng.integers(0, 1 << 31, n_r),
               rng.integers(0, 50, (n_s, c)), rng.integers(0, 1 << 31, n_s)]
        ops = [torch.from_numpy(o.astype(np.int32)).to(dev) for o in ops]
        err = _max_abs_err(bj.flat_join(*ops), bj.tiled_join_ref(*ops))
        _say(f"[check] flat_join N={n_r} M={n_s} C={c}: max_abs_err={err}")
        assert err == 0
    _say("[check] flat_join wraparound 256x256 at weight 40000: ok")

    # the fused ingest pass (K2 dense, K3 static) and the Count-Min update
    # (K4): ragged and empty N, W = 1, pins and excludes with V = 8, k not a
    # multiple of 128, hashed values at -2^31 and 2^31-1, seeds >= 2^31
    i32 = np.iinfo(np.int32)
    seeds = (11, 222, (1 << 31) + 5, (1 << 32) - 1)

    def edge_rows(n, arity, seed):
        rows = np.random.default_rng(seed).integers(0, 60, (n, arity)).astype(np.int32)
        if n >= 4:
            rows[-1], rows[-2], rows[-3, 0] = i32.min, i32.max, 7
        return torch.from_numpy(rows).to(dev)

    for query, q_small in [(two_way(), 8), (three_way_paper(), 8)]:
        plan_s = _skewed_plan(query, q_small)
        k_pad = -(-plan_s.total_reducers // 128) * 128
        for rel in query.relations:
            routes = static_route_table(plan_s, rel)
            w = fi.route_width(routes)
            enc = fi.dense_route_encoding(routes, rel.arity, 1 << max(0, (w - 1).bit_length()), 8)
            for n in (0, 1, 4095, 4097, 100_003 if len(query.relations) == 2 else 30_011):
                rows = edge_rows(n, rel.arity, n)
                kw = dict(sketch_cols=(rel.arity - 1,), seeds=seeds, width=2048, k_pad=k_pad)
                got = fi.fused_ingest_dense(rows, enc, **kw)
                torch.cuda.synchronize()
                err = _max_abs_err(got, fi.fused_ingest_dense_ref(rows, enc, **kw))
                _say(f"[check] fused_ingest_dense {rel.name} of {len(query.relations)}-way "
                     f"N={n} Wp={enc['col_base'].shape[0]} k={plan_s.total_reducers} "
                     f"k_pad={k_pad}: max_abs_err={err}")
                assert err == 0
            kw = dict(routes=routes, sketch_cols=(0,), seeds=seeds, width=100,
                      num_reducers=plan_s.total_reducers)
            for mode, mkw in [("route", dict(kw, sketch_cols=())),
                              ("sketch", dict(kw, routes=())), ("both", kw)]:
                rows = edge_rows(10_007, rel.arity, 3)
                got = fi.fused_ingest(rows, **mkw)
                torch.cuda.synchronize()
                err = _max_abs_err(got, fi.fused_ingest_ref(rows, **mkw))
                _say(f"[check] fused_ingest ({mode}) {rel.name} N=10007 W={w} "
                     f"k={plan_s.total_reducers}: max_abs_err={err}")
                assert err == 0
    one = plan_shares_skew(two_way(), {"R": np.zeros((20, 2), np.int64),
                                       "S": np.ones((20, 2), np.int64)}, q=1000)
    for rel in two_way().relations:
        kw = dict(routes=static_route_table(one, rel), num_reducers=one.total_reducers)
        assert fi.route_width(kw["routes"]) == 1
        rows = edge_rows(999, 2, 5)
        err = _max_abs_err(fi.fused_ingest(rows, **kw), fi.fused_ingest_ref(rows, **kw))
        enc = fi.dense_route_encoding(kw["routes"], 2, 1, 8)
        err = max(err, _max_abs_err(fi.fused_ingest_dense(rows, enc, k_pad=128),
                                    fi.fused_ingest_dense_ref(rows, enc, k_pad=128)))
        _say(f"[check] fused_ingest and fused_ingest_dense W=1 {rel.name} N=999: "
             f"max_abs_err={err}")
        assert err == 0
    # destinations that repeat within a row and across rows, with
    # histograms of 128 and 65,536 destinations and wider than one block's
    # range of counters (131,075 and 1,048,576; the first kernels stopped
    # at 114,688)
    for k_pad in (128, 65_536, 131_075, 1_048_576):
        enc = fi.dense_route_encoding((), 3, 8, max_values=2)
        rng_e = np.random.default_rng(k_pad)
        enc["col_valid"][:7] = 1
        enc["col_base"][:] = [0, 0, 3, 5, 5, 1, 2, 9]
        enc["col_base"][:7] += k_pad - 20
        enc["h_col"][:, 0] = rng_e.integers(0, 3, 8)
        enc["h_seed"][:, 0] = rng_e.integers(i32.min, i32.max, 8)
        enc["h_dim"][:, 0] = [2, 3, 1, 4, 4, 2, 1, 1]
        enc["h_stride"][:, 0] = [1, 1, 0, 2, 2, 3, 0, 0]
        enc["p_col"][3, 0], enc["p_val"][3, 0], enc["p_on"][3, 0] = 1, 2, 1
        enc["e_col"][5, 1], enc["e_val"][5, 1], enc["e_on"][5, 1] = 2, [0, 4], [1, 1]
        rows = torch.from_numpy(rng_e.integers(0, 5, (200_003, 3)).astype(np.int32)).to(dev)
        err = _max_abs_err(fi.fused_ingest_dense(rows, enc, k_pad=k_pad),
                           fi.fused_ingest_dense_ref(rows, enc, k_pad=k_pad))
        _say(f"[check] fused_ingest_dense repeated destinations N=200003 k_pad={k_pad} "
             f"rows a tile={fi.rows_per_tile(200_003, 8, 3, k_pad, dev)}: "
             f"max_abs_err={err}")
        assert err == 0
    # a static table of as many reducers: a pin, an exclude list, two
    # hashed terms, destinations up to k - 1
    for k in (131_075, 1_048_576):
        kw = dict(routes=wide_routes(k), sketch_cols=(1,), seeds=seeds, width=64,
                  num_reducers=k)
        rows = edge_rows(100_003, 2, k)
        got = fi.fused_ingest(rows, **kw)
        torch.cuda.synchronize()
        err = _max_abs_err(got, fi.fused_ingest_ref(rows, **kw))
        _say(f"[check] fused_ingest (both) static table N=100003 W=4 k={k}: max_abs_err={err}")
        assert err == 0 and int(got[0].max()) == k - 1
    for width in (1, 251, 2048, 20_000):
        vals = np.random.default_rng(width).integers(i32.min, i32.max, 100_003, dtype=np.int64,
                                                     endpoint=True)
        vals[:2], vals[2:60_000] = [i32.min, i32.max], 42
        vals = torch.from_numpy(vals.astype(np.int32)).to(dev)
        got = su.cms_update(vals, seeds, width)
        torch.cuda.synchronize()
        err = _max_abs_err([got], [su.cms_update_ref(vals, seeds, width)])
        _say(f"[check] cms_update N=100003 width={width}: max_abs_err={err}")
        assert err == 0

    # ---- 4. main path: the §9.1 join at full scale ----------------------------
    t = time.perf_counter()
    data = paper_2way(np.random.default_rng(0), n_r=1_000_000, n_s=100_000)
    t_data = time.perf_counter() - t
    query = two_way()
    t = time.perf_counter()
    plan = plan_shares_skew(query, data, q=1000)
    t_plan = time.perf_counter() - t
    _say(plan.describe())
    t = time.perf_counter()
    want_count, want_checksum = groupby_oracle_two_way(query, data)
    t_oracle = time.perf_counter() - t

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    phases: dict[str, float] = {}
    reset_launches()
    t = time.perf_counter()
    res = run_join(query, data, plan, cap_factor=3.0, device=dev, phase_seconds=phases)
    torch.cuda.synchronize()
    t_e2e = time.perf_counter() - t
    main_launches = launches()
    peak = torch.cuda.max_memory_allocated()

    _say(f"[main] reducers={plan.total_reducers} count={res.count} checksum={res.checksum} "
         f"overflow={res.overflow} comm={res.comm_tuples} max_load={res.max_load}")
    _say(f"[main] oracle count={want_count} checksum={want_checksum}; the count is "
         f"{'below' if want_count < 1 << 31 else 'NOT below'} 2^31 = {1 << 31}, so the "
         "reference run_join's int32 count would not wrap here")
    assert (res.count, res.checksum) == (want_count, want_checksum)
    assert res.overflow == 0
    assert res.comm_tuples == predicted_comm(plan)
    assert int(res.reducer_loads.sum()) == res.total_comm
    assert main_launches["reducer_join"] > 0, main_launches
    _say(f"[main] launches during run_join: {main_launches}")
    _say("[main] seconds: data={:.3f} plan={:.3f} oracle(host)={:.3f} ".format(t_data, t_plan, t_oracle)
         + " ".join(f"{k}={v:.4f}" for k, v in phases.items())
         + f" run_join={t_e2e:.4f} plan+run_join={t_plan + t_e2e:.3f}")
    _say(f"[main] peak device memory: {peak} bytes ({peak / 2**30:.2f} GiB)")

    # ---- 4b. the same join through speculative reduce shards ----------------
    spec_launches = _speculative_phase(dev, query, data, plan, res, t_e2e)

    # ---- 5. each kernel at the main path's shapes ---------------------------
    bins, valids = map_and_bin(query, data, plan, cap_factor=3.0, device=dev)
    ops = binary_join_operands(LocalJoinSpec.from_query(query), bins, valids)
    _say(f"[K1a] reducer_join inputs: r_keys {tuple(ops[0].shape)} s_keys {tuple(ops[2].shape)}")
    got = bj.reducer_join(*ops)
    torch.cuda.synchronize()
    t = time.perf_counter()
    want = bj.block_join_ref(*ops)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t) * 1e3
    err_a = _max_abs_err(got, want)
    assert err_a == 0
    assert int(got[0].long().sum()) == res.count
    ms_a, ev_a, wrap_a = _kernel_ms(lambda: bj.reducer_join(*ops), JOIN_KERNELS, reps=20)
    ops_a, bytes_a, slots_a, pairs_a = _join_work(*ops)
    bound_a, by_a = _bound(ops_a, bytes_a)
    nested_a, _ = _bound(pairs_a, bytes_a)
    _say(f"[K1a] kernel {ms_a:.4f} ms (CUDA graph of 20 calls; {_short(ev_a)} ms an event in "
         f"a trace; wrapper {wrap_a:.4f} ms); plain {plain_ms:.1f} ms "
         f"(all {ops[0].shape[0]} reducers, (chunk, slots)="
         f"{bj.chunk_geometry(ops[0].shape[1], ops[0].shape[2])}, max_abs_err={err_a}); bound "
         f"{bound_a:.4f} ms by {by_a} ({ops_a:.4g} int32 ops, {bytes_a:.4g} bytes: every weight, "
         f"the valid rows' keys), {100 * bound_a / ms_a:.1f} % of it; every slot's bytes "
         f"{slots_a:.4g} ({slots_a / HBM_BYTES_PER_S * 1e3:.4f} ms); the nested loop's bound "
         f"(the earlier kernel's) {nested_a:.4f} ms by operations ({pairs_a:.4g})")
    kernels = [{
        "name": "reducer_join", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/block_join.cu",
        "replaces": "src/repro/kernels/block_join.py:39",
        "launches": main_launches["reducer_join"], "max_abs_err": err_a,
        "ms": ms_a, "plain_ms": plain_ms, "bound_ms": bound_a, "bound_by": by_a,
        "library_ms": None,
    }]

    # flat join: the heavy hitter's tuples joined unbinned, one R x S pair
    hh = int(plan.hh_values["B"][0])
    r_hh = torch.from_numpy(data["R"][data["R"][:, 1] == hh].astype(np.int32)).to(dev)
    s_hh = torch.from_numpy(data["S"][data["S"][:, 0] == hh].astype(np.int32)).to(dev)
    flat = (r_hh[:, 1:2].contiguous(), row_weight_torch(r_hh, 0x5EED),
            s_hh[:, 0:1].contiguous(), row_weight_torch(s_hh, 0x5EED + 1))
    got = bj.flat_join(*flat)
    torch.cuda.synchronize()
    t = time.perf_counter()
    want = bj.tiled_join_ref(*flat)
    torch.cuda.synchronize()
    plain_b = (time.perf_counter() - t) * 1e3
    err_b = _max_abs_err(got, want)
    assert err_b == 0
    assert int(got[0]) == r_hh.shape[0] * s_hh.shape[0]
    ms_b, ev_b, wrap_b = _kernel_ms(lambda: bj.flat_join(*flat), JOIN_KERNELS, reps=10)
    ops_b, bytes_b, slots_b, pairs_b = _join_work(*(x[None] for x in flat))
    bound_b, by_b = _bound(ops_b, bytes_b)
    nested_b, _ = _bound(pairs_b, bytes_b)
    _say(f"[K1b] flat_join {r_hh.shape[0]} x {s_hh.shape[0]} (B={hh}): kernel {ms_b:.4f} ms "
         f"(CUDA graph of 10 calls; {_short(ev_b)} ms an event in a trace; wrapper "
         f"{wrap_b:.4f} ms); plain {plain_b:.1f} ms (max_abs_err={err_b}); bound {bound_b:.5f} "
         f"ms by {by_b} ({bytes_b:.4g} bytes; every slot's {slots_b:.4g}); the nested loop's "
         f"bound (the earlier kernel's) {nested_b:.4f} ms by operations")
    kernels.append({
        "name": "flat_join", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/block_join.cu",
        "replaces": "src/repro/kernels/block_join.py:102",
        "launches": main_launches["flat_join"], "max_abs_err": err_b,
        "ms": ms_b, "plain_ms": plain_b, "bound_ms": bound_b, "bound_by": by_b,
        "library_ms": None,
    })
    del bins, valids, ops, flat

    # ---- 6. the paper's 3-way query: the n-way reduce on the card -----------
    q3 = three_way_paper()
    d3 = paper_3way(np.random.default_rng(0), n=2_000, domain=20_000)
    plan3 = plan_shares_skew(q3, d3, q=120)
    reset_launches()
    t = time.perf_counter()
    res3 = run_join(q3, d3, plan3, cap_factor=5.0, device=dev)
    t3 = time.perf_counter() - t
    c3, k3, _, _ = oracle_join(q3, d3)
    _say(f"[3way] reducers={plan3.total_reducers} count={res3.count} checksum={res3.checksum} "
         f"oracle=({c3}, {k3}) overflow={res3.overflow} run_join={t3:.3f} s "
         f"launches={launches()}")
    assert (res3.count, res3.checksum) == (c3, k3) and res3.overflow == 0
    assert res3.comm_tuples == predicted_comm(plan3)

    # ---- 6b. the distributed shuffle: §9.1 and §9.2 over NCCL at world one --
    dist_launches = _distributed_phase(dev, query, data, plan, res, (want_count, want_checksum),
                                       t_e2e, main_launches["reducer_join"],
                                       (q3, d3, plan3, res3, (c3, k3)))

    # ---- 7. the streaming engine, fused path, at scale ----------------------
    t = time.perf_counter()
    rng_s = np.random.default_rng(0)
    batches = [
        _zipf_batch(rng_s, 0 if i < 2 else 33_333, 100_000, 25_000, 100_000,
                    2.0 if i < 2 else 1.4)
        for i in range(6)
    ]
    t_data = time.perf_counter() - t
    cfg = StreamConfig(q=1000, decay=0.5, load_factor=2.0, fused_ingest=True,
                       obs=ObsPolicy(trace=True))
    eng = StreamingJoinEngine(two_way(), cfg, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t_stream = time.perf_counter()
    ingest_ms = []
    for i, batch in enumerate(batches):
        def one():
            t = time.perf_counter()
            rep = eng.ingest(batch)
            torch.cuda.synchronize()
            ingest_ms.append((time.perf_counter() - t) * 1e3)
            return rep

        if i == len(batches) - 1:  # the last batch under the profiler
            n_dense = launches()["fused_ingest_dense"]
            n_ev_s: dict[str, int] = {}
            rep, busy = _traced(one, n_ev_s)
            n_dense = launches()["fused_ingest_dense"] - n_dense
        else:
            rep = one()
        _say(f"[stream] batch {rep.batch}: {ingest_ms[-1]:.1f} ms epoch={rep.plan_epoch} "
             f"replanned={rep.replanned} ({rep.drift_reason or '-'}) k={eng.plan.total_reducers} "
             f"delta={rep.delta_count} comm={rep.comm_tuples} migrated={rep.migrated_tuples} "
             f"max_load={rep.max_load} hh={rep.hh_values}")
    t_stream = time.perf_counter() - t_stream
    stream_launches = launches()
    peak = torch.cuda.max_memory_allocated()
    widths = {r.name: fi.route_width(static_route_table(eng.plan, r)) for r in two_way().relations}
    t = time.perf_counter()
    want_count, want_checksum = groupby_oracle_two_way(two_way(), eng.history_data())
    t_oracle = time.perf_counter() - t
    _say(f"[stream] total count={eng.total_count} checksum={eng.total_checksum}; oracle "
         f"count={want_count} checksum={want_checksum} ({t_oracle:.2f} s on the host)")
    _say(f"[stream] fused_batches={eng.fused_batches} replans={eng.replan_count} "
         f"final k={eng.plan.total_reducers} W={widths} launches={stream_launches}")
    _say("[stream] binned state on the host: " + ", ".join(
        f"{nm} {tuple(b.shape)} ({b.nbytes + v.nbytes} bytes)"
        for nm, (b, v, _) in eng._state.items()))
    _say(f"[stream] seconds: data={t_data:.2f} six ingests={t_stream:.3f} "
         f"ingest ms={[round(x, 1) for x in ingest_ms]}; peak device memory {peak} bytes")
    spans: dict[str, list[float]] = {}
    for ev in eng.obs.tracer.events:
        if ev.get("ph") == "X":
            spans.setdefault(ev["name"], []).append(ev["dur"] / 1e3)
    for name, durs in sorted(spans.items(), key=lambda kv: -sum(kv[1])):
        _say(f"[stream] span {name}: {sum(durs):.1f} ms total over {len(durs)}")
    busy_ms = sum(busy.values()) / 1e3
    _say(f"[stream] batch 5 under the profiler: device busy {busy_ms:.3f} ms of "
         f"{ingest_ms[-1]:.1f} ms ({100 * busy_ms / ingest_ms[-1]:.3f} %, idle "
         f"{100 - 100 * busy_ms / ingest_ms[-1]:.3f} %); by function (ms): "
         + "; ".join(f"{k[:70]} {v / 1e3:.3f}" for k, v in
                     sorted(busy.items(), key=lambda kv: -kv[1])[:8]))
    # K2's kernels, one event of each a call, show whether the trace lost
    # events (then the busy share is a lower bound)
    n_ev_k2 = {nm: sum(n for k, n in n_ev_s.items() if nm in k) for nm in INGEST_KERNELS[:3]}
    _say(f"[stream] batch 5's trace: {n_ev_k2} events of K2's kernels, {n_dense} calls"
         + ("" if all(n == n_dense for n in n_ev_k2.values()) else
            "; the trace lost events: its busy share is a lower bound"))
    assert n_dense > 0, n_dense
    assert (eng.total_count, eng.total_checksum) == (want_count, want_checksum)
    assert eng.fused_batches == 6 and eng.replan_count >= 1
    assert stream_launches["fused_ingest_dense"] > 0, stream_launches
    assert stream_launches["fused_ingest_sketch"] > 0, stream_launches

    # ---- 8. the baseline path on the first three batches --------------------
    base = StreamingJoinEngine(two_way(), StreamConfig(
        q=1000, decay=0.5, load_factor=2.0, use_device_sketch=True), device=dev)
    reset_launches()
    t = time.perf_counter()
    base_ms = []
    for i, batch in enumerate(batches[:3]):
        t_b = time.perf_counter()
        rep = base.ingest(batch)
        base_ms.append((time.perf_counter() - t_b) * 1e3)
        assert rep == eng.reports[i], f"baseline batch {i} differs from the fused path"
    t_base = time.perf_counter() - t
    base_launches = launches()
    _say(f"[baseline] 3 batches equal the fused reports in {t_base:.3f} s "
         f"(ingest ms {[round(x, 1) for x in base_ms]}); launches={base_launches}; "
         f"total count after 3 batches={base.total_count} (2^31 = {1 << 31})")
    assert base_launches["cms_update"] > 0 and base_launches["reducer_join"] > 0, base_launches
    del base

    # ---- 9. the static-table fused path on the first three batches ----------
    stat = StreamingJoinEngine(two_way(), StreamConfig(
        q=1000, decay=0.5, load_factor=2.0, fused_ingest=True,
        fused_dynamic_routes=False), device=dev)
    reset_launches()
    t = time.perf_counter()
    stat_ms = []
    for i, batch in enumerate(batches[:3]):
        t_b = time.perf_counter()
        rep = stat.ingest(batch)
        stat_ms.append((time.perf_counter() - t_b) * 1e3)
        assert rep == eng.reports[i], f"static-table batch {i} differs from the fused path"
    t_stat = time.perf_counter() - t
    stat_launches = launches()
    _say(f"[static] 3 batches equal the fused reports in {t_stat:.3f} s "
         f"(ingest ms {[round(x, 1) for x in stat_ms]}); launches={stat_launches}")
    assert stat_launches["fused_ingest"] > 0 and stat_launches["fused_ingest_sketch"] > 0, \
        stat_launches
    del stat

    # ---- 10. each stream kernel at the shapes the stream gave it ------------
    seeds = eng.tracker.seeds
    width = cfg.sketch_width
    k_fin = eng.plan.total_reducers
    rows0 = torch.from_numpy(batches[0]["R"].astype(np.int32)).to(dev)
    for rel in two_way().relations:
        routes = static_route_table(eng.plan, rel)
        packed = eng._dense_routes(rel, routes)  # what the engine launches K2 with
        cols = tuple(c for _, c in eng._sketch_cols[rel.name])
        rows = torch.from_numpy(batches[-1][rel.name].astype(np.int32)).to(dev)
        kw = dict(sketch_cols=cols, seeds=seeds, width=width, k_pad=k_fin)
        got = fi.fused_ingest_dense(rows, packed, **kw)
        want, plain_ms = _plain_ms(lambda: fi.fused_ingest_dense_ref(rows, packed.arrays, **kw))
        err = _max_abs_err(got, want)
        assert err == 0
        ms, by_fn, wrap = _kernel_ms(lambda: fi.fused_ingest_dense(rows, packed, **kw),
                                     INGEST_KERNELS, reps=20)
        ops, n_bytes = _ingest_work(rows, packed.arrays, got[0], len(cols), len(seeds), width,
                                    k_fin)
        bound, by = _bound(ops, n_bytes)
        rpt = fi.rows_per_tile(rows.shape[0], packed.wp, rows.shape[1], k_fin, dev)
        _say(f"[K2] fused_ingest_dense {rel.name} N={rows.shape[0]} W={packed.wp} "
             f"k={k_fin} ({-(-rows.shape[0] // rpt)} tiles of {rpt} rows): kernel {ms:.4f} ms "
             f"(CUDA graph of 20 calls; ms an event in a trace {_short(by_fn)}; wrapper "
             f"{wrap:.4f} ms); plain {plain_ms:.1f} ms (max_abs_err={err}); bound {bound:.4f} ms "
             f"by {by} ({ops:.4g} int32 ops, {n_bytes:.4g} bytes)")
        if rel.name != "R":
            continue
        # the larger pass of the two goes in the kernels line
        kernels.append({
            "name": "fused_ingest_dense", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ingest_fused.cu",
            "replaces": "src/repro/kernels/ingest_fused.py:535",
            "launches": stream_launches["fused_ingest_dense"], "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": None,
        })
        # K3 with routes and sketch, as the static-table path (phase 9) ran it
        kws = dict(routes=routes, sketch_cols=cols, seeds=seeds, width=width,
                   num_reducers=k_fin)
        got = fi.fused_ingest(rows, **kws)
        want, plain_s = _plain_ms(lambda: fi.fused_ingest_ref(rows, **kws))
        err_s = _max_abs_err(got, want)
        assert err_s == 0
        ms_s, by_s, wrap_s = _kernel_ms(lambda: fi.fused_ingest(rows, **kws), INGEST_KERNELS,
                                        reps=20)
        enc_s = fi._static_routes(routes, rel.arity, dev).arrays
        ops_s, bytes_s = _ingest_work(rows, enc_s, got[0], len(cols), len(seeds), width, k_fin)
        bound_s, by_bs = _bound(ops_s, bytes_s)
        _say(f"[K3] fused_ingest routes+sketch R N={rows.shape[0]} W={got[0].shape[1]} "
             f"k={k_fin}: kernel {ms_s:.4f} ms (CUDA graph of 20 calls; ms an event in a trace "
             f"{_short(by_s)}; wrapper {wrap_s:.4f} ms); plain {plain_s:.1f} ms "
             f"(max_abs_err={err_s}); bound {bound_s:.4f} ms by {by_bs}")
        kernels.append({
            "name": "fused_ingest", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ingest_fused.cu",
            "replaces": "src/repro/kernels/ingest_fused.py:223",
            "launches": stat_launches["fused_ingest"], "max_abs_err": err_s,
            "ms": ms_s, "plain_ms": plain_s, "bound_ms": bound_s, "bound_by": by_bs,
            "library_ms": None,
        })
        # K3 as batch 0 ran it, before any plan: the sketch-only pass, whose
        # one kernel is the Count-Min kernel
        kw3 = dict(sketch_cols=cols, seeds=seeds, width=width)
        got = fi.fused_ingest(rows0, **kw3)
        want, plain3 = _plain_ms(lambda: fi.fused_ingest_ref(rows0, **kw3))
        err3 = _max_abs_err(got, want)
        assert err3 == 0
        ms3, ev3, wrap3 = _kernel_ms(lambda: fi.fused_ingest(rows0, **kw3), CMS_KERNELS, reps=20)
        ops3 = 11.0 * rows0.shape[0] * len(cols) * len(seeds)
        bytes3 = 4.0 * (rows0.numel() + len(cols) * len(seeds) * width)
        bound3, by3 = _bound(ops3, bytes3)
        _say(f"[K3] fused_ingest sketch-only N={rows0.shape[0]}: kernel {ms3:.4f} ms (CUDA graph "
             f"of 20 calls; {_short(ev3)} ms an event in a trace; wrapper {wrap3:.4f} "
             f"ms); plain {plain3:.1f} ms (max_abs_err={err3}); bound {bound3:.4f} ms by {by3}; "
             f"the PR 12 kernel took 0.0094-0.0095 ms (PR 18, PERF.md)")
        kernels.append({
            "name": "fused_ingest_sketch", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/cms_update.cu",
            "replaces": "src/repro/kernels/ingest_fused.py:223",
            "launches": stream_launches["fused_ingest_sketch"], "max_abs_err": err3,
            "ms": ms3, "plain_ms": plain3, "bound_ms": bound3, "bound_by": by3,
            "library_ms": None,
        })
        # K4 as the baseline tracker ran it: one column of R, 4 seeds
        vals = rows0[:, 1].contiguous()
        got = su.cms_update(vals, seeds, width)
        want, plain4 = _plain_ms(lambda: su.cms_update_ref(vals, seeds, width))
        err4 = _max_abs_err([got], [want])
        assert err4 == 0
        ms4, ev4, wrap4 = _kernel_ms(lambda: su.cms_update(vals, seeds, width), CMS_KERNELS,
                                     reps=50)
        ops4 = 11.0 * vals.shape[0] * len(seeds)
        bytes4 = 4.0 * (vals.numel() + len(seeds) * width)
        bound4, by4 = _bound(ops4, bytes4)
        _say(f"[K4] cms_update N={vals.shape[0]} depth={len(seeds)} width={width}: "
             f"kernel {ms4:.4f} ms (CUDA graph of 50 calls; {_short(ev4)} ms an event in a "
             f"trace; wrapper {wrap4:.4f} ms); plain {plain4:.1f} ms (max_abs_err={err4}); "
             f"bound {bound4:.4f} ms by {by4}; the PR 12 kernel took 0.0089-0.0099 ms "
             f"(PR 16-18, PERF.md)")
        # the launch floor: an empty kernel (one warp), timed the same way
        floor = _graph_ms(lambda: su.empty_launch(dev), 50)
        _say(f"[floor] an empty kernel: {floor:.4f} ms a launch (CUDA graph of 50 calls); "
             f"K4's bound {bound4:.5f} ms and K3 sketch-only's {bound3:.5f} ms lie "
             f"{'below' if max(bound3, bound4) < floor else 'above'} it; K4 takes "
             f"{ms4 / floor:.2f} floors, K3 sketch-only {ms3 / floor:.2f}")
        kernels.append({
            "name": "cms_update", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/cms_update.cu",
            "replaces": "src/repro/kernels/sketch_update.py:48",
            "launches": base_launches["cms_update"], "max_abs_err": err4,
            "ms": ms4, "plain_ms": plain4, "bound_ms": bound4, "bound_by": by4,
            "library_ms": None, "launch_floor_ms": floor,
        })
        # K4 on batch 0's S join column (25,000 keys, the baseline's other
        # call), on 100,000 equal keys, and on as many rows as one cluster
        # covers (the table stored, no zero fill); the zero fill itself
        one_rows = _build.library("cms_update").cms_one_cluster_rows()
        s_col = torch.from_numpy(batches[0]["S"][:, 0].astype(np.int32)).to(dev)
        times = []
        for x in (s_col, torch.full_like(vals, 7), vals[:one_rows]):
            assert torch.equal(su.cms_update(x, seeds, width), su.cms_update_ref(x, seeds, width))
            times.append(_graph_ms(lambda: su.cms_update(x, seeds, width), 50))
        fill = _graph_ms(lambda: torch.zeros((len(seeds), width), dtype=torch.int32,
                                             device=dev), 50)
        _say(f"[K4] cms_update batch 0's S column (N={s_col.shape[0]}) {times[0]:.4f} ms, "
             f"{vals.shape[0]} equal keys {times[1]:.4f} ms, N={one_rows} (one cluster, the table "
             f"stored) {times[2]:.4f} ms; the zero fill of a [{len(seeds)}, {width}] table "
             f"{fill:.4f} ms (CUDA graph of 50 calls each)")
        # K4 and the fused pass's sketch half on every class of input,
        # exactly: all keys equal, N = 1, N ragged, one cluster's N and
        # several clusters', widths 1, 12,288 and 12,289 (the shared-memory
        # tables' edge), depth 1 and 32, two sketched columns of three
        i32 = np.iinfo(np.int32)
        rng_k = np.random.default_rng(4)
        for n in (1, 4097, 8192, 8193, 100_000, 300_007):
            for kind in ("random", "equal"):
                keys = rng_k.integers(i32.min, i32.max, n, dtype=np.int64, endpoint=True)
                if kind == "equal":
                    keys[:] = -5
                keys = torch.from_numpy(keys.astype(np.int32)).to(dev)
                for depth, w in ((4, 1), (4, 2048), (32, 2048), (4, 12_288), (2, 12_289)):
                    sd = (seeds * 8)[:depth]
                    err = _max_abs_err([su.cms_update(keys, sd, w)],
                                       [su.cms_update_ref(keys, sd, w)])
                    assert err == 0, (n, kind, depth, w)
                rows3 = torch.stack([keys, keys.flip(0), keys // 3], 1).contiguous()
                for cols3, w in (((0, 2), 2048), ((2, 1), 12_289)):
                    err = _max_abs_err([su.cms_tables(rows3, cols3, seeds, w)],
                                       [su.cms_tables_ref(rows3, cols3, seeds, w)])
                    assert err == 0, (n, kind, cols3, w)
                _say(f"[check] cms_update N={n} {kind} keys at depth 4/32, widths 1, 2048, "
                     f"12,288, 12,289, and cms_tables of two of three columns: max_abs_err=0")

    # ---- 10b. recovery, checkpoint and restore on the card -----------------
    reset_launches()
    rec_launches = _recovery_phase(dev, batches)
    _say(f"[recovery] launches in phase 10b: {rec_launches}")
    solo_reports = list(eng.reports)
    del eng
    gc.collect()

    # ---- 10c. three tenants behind one ingest, a checkpoint, a restore ----------
    ten_launches = _tenancy_phase(dev, batches, solo_reports, ingest_ms)
    gc.collect()

    kernels += _lm_phases(dev, data["R"][:, 1])
    torch.cuda.empty_cache()
    kernels += _rwkv_phases(dev)
    torch.cuda.empty_cache()
    k6b, train_launches = _train_phases(dev)
    kernels.append(k6b)
    torch.cuda.empty_cache()
    _moe_dispatch_phase(dev)
    # qwen2-moe-a2.7b's K6 shape is OLMo-1B's, held in phases 16 and 26
    moe_launches, _, qwen2_share = _full_size_phases(
        dev, "qwen2-moe-a2.7b", 28, 24, 4, check_depth=4, bucket=True, prompt=(4, 128, 32))
    torch.cuda.empty_cache()
    d80, hybrid_launches = _hybrid_phases(dev)
    torch.cuda.empty_cache()
    k7b, rwkv_train_launches = _rwkv_train_phases(dev)
    kernels.append(k7b)
    torch.cuda.empty_cache()
    launcher_launches = _launcher_phase(dev)
    torch.cuda.empty_cache()
    full_launches, full_qkv = {}, {}
    for i, (name, n_attn, depth) in enumerate(FULL_SIZE):
        full_launches[name], full_qkv[name], _ = _full_size_phases(
            dev, name, 42 + 3 * i, n_attn, depth, qwen2_share=qwen2_share)

    # ---- 57. K6 and K6b at each new shape: layer 0's q, k, v of phases 43-55 --
    t = time.perf_counter()
    at_shapes = {}
    for name, qkv in full_qkv.items():
        if qkv is None:  # gemma3-4b runs no K6
            continue
        *qkv, causal = qkv
        tag = name.split("-")[0]
        k6, k6b = _flash_pair(f"{name}'s first layer", *(x.to(dev) for x in qkv),
                              causal=causal, seed=57)
        suffix = "d80_noncausal" if tag == "hubert" else tag
        for entry, nums in (("flash_attention", k6), ("flash_attention_bwd", k6b)):
            at_shapes.setdefault(entry, {}).update(
                {f"{key}_{suffix}": x for key, x in nums.items()})
    del full_qkv, qkv
    torch.cuda.empty_cache()
    _say(f"[K6] phase 57: {time.perf_counter() - t:.1f} s")

    # ---- 58, 59 and 60. tensor and expert parallelism: two ranks of a (1, 2)
    # mesh on this card each, 58's and 59's four processes at once, then 60's
    gc.collect()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    ep_ranks = _two_ranks("expert_parallel.py", dev)
    tp_launches = _tp_phase(dev, ranks=_two_ranks("tensor_parallel.py", dev))
    ep_launches = _ep_phase(dev, ranks=ep_ranks)
    _say(f"[tp] phases 58 and 59 together: {time.perf_counter() - t:.1f} s")
    # after them: with phase 60's two processes beside their four the card ran
    # out of memory (78.76 GiB in use)
    rec_launches = _tp_recurrent_phase(dev)

    # beside each path's own count, phases 4b's, 6b's, 10b's, 10c's, 24's,
    # 29 + 30's, 34 + 35's, 39's, 41's (the launcher's own counts, summed
    # over its two runs) and each full-size configuration's serving and
    # training (43 + 44, ..., 55 + 56); K6 and K6b at the hybrid's head dim
    # of 80 and at each shape of phase 57
    for entry in kernels:
        entry["launches_speculative"] = spec_launches.get(entry["name"], 0)
        entry["launches_distributed"] = dist_launches.get(entry["name"], 0)
        entry["launches_recovery"] = rec_launches.get(entry["name"], 0)
        entry["launches_tenancy"] = ten_launches.get(entry["name"], 0)
        entry["launches_train"] = train_launches.get(entry["name"], 0)
        entry["launches_moe"] = moe_launches.get(entry["name"], 0)
        entry["launches_hybrid"] = hybrid_launches.get(entry["name"], 0)
        entry["launches_rwkv_train"] = rwkv_train_launches.get(entry["name"], 0)
        entry["launches_launcher"] = launcher_launches.get(entry["name"], 0)
        entry["launches_tp"] = tp_launches.get(entry["name"], 0)
        entry["launches_ep"] = ep_launches.get(entry["name"], 0)
        entry["launches_tp_recurrent"] = rec_launches.get(entry["name"], 0)
        for name, counts in full_launches.items():
            entry[f"launches_{name.split('-')[0]}"] = counts.get(entry["name"], 0)
        entry.update(d80.get(entry["name"], {}))
        entry.update(at_shapes.get(entry["name"], {}))
    _say(f"[trace] {len(RETAKEN)} trace(s) lost device events and were taken again: "
         f"{RETAKEN}")
    assert len(RETAKEN) <= 1, f"more than one trace lost device events: {RETAKEN}"
    _say(f"[done] wall {time.perf_counter() - t_all:.1f} s")
    _say(json.dumps({"kernels": kernels}))
    _say(smi)
    _say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
