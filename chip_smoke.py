#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card (NVIDIA H100).

    python3 chip_smoke.py

Phases, each of which raises (non-zero exit, no result line) on failure:

1. device and build: the card's name and power limit; all five CUDA kernels
   (``src/repro_torch/kernels/*/csrc``) compiled from the sources here, one
   nvcc each, all started together.
2. kernels against their plain PyTorch versions on the card, at small
   shapes: E1 ``zsign_encode`` bit-exact (z=1: bit-exact or every differing
   bit within 4 f32 ulp of its threshold, the erf rule) and each client's
   bytes in a batched launch equal to its own n = 1 launch; R1
   ``sign_reduce`` (n in {1, 8, 13}) with f32 weights and a 0/1 mask, with
   and without a carried sum, and in fold mode (``sign_fold_step``: shard sequences such
   as (3, 5, 8, 1, 13) whose pending rows carry over, finalized with and
   without pending rows); F1 ``ef_sign_rows`` (n in {1, 3, 8}, d not a
   multiple of 8192, one dead client, with and without q, in place); C1
   ``zsign_compress_rows`` (sigma 0 and > 0, elements whose unfused y is
   exactly 0); U1 ``unpack_sum``. E1 also with a sigma vector that differs
   across clients and holds a 0 (the sto-sign route). Outputs are compared
   as int32 bit patterns (bytes for payloads).
3. twenty paths at full width through ``repro_torch.launch.train.run``:
   qwen2-0.5B (24 layers, d = 494,032,768 coordinates, bf16), 1 local step
   (moe_round, encdec_round and hybrid_reduced keep 2), micro-batch 2, seq
   64, 2 rounds where a round hands state or a warm round time to the next
   (zsign, ef, ef_stream, cv_stream, plateau, ef_topk; the async paths 3),
   else 1:
     zsign            zsign(z=1, sigma=0.01), 8 clients: E1 + R1 once a round
     ef               ef|zsign(use_kernel=true), 8 clients: F1 + R1 once
     zsign_packed_z2  zsign_packed(z=2, sigma=0.01), 8 clients: C1 + R1 once
     zsign_groups     zsign, --clients 1 --groups 8: E1 with n = 1 eight
                      times, R1 once
     zsign_stream     zsign, --clients 32 --cohort auto, which resolves to
                      stream(shard=8): E1 and R1 (add mode) 4 times
     ef_stream        ef|zsign(use_kernel=true), --clients 16 --cohort
                      "stream(shard=6)": F1 3 times, R1 in fold mode 3 times
                      (shard 2 and shard 3 each complete one 8-client block,
                      the finalize closes the 2 pending rows; shard 1's 6
                      rows only pend)
     stosign          --compressor stosign, 8 clients: E1 + R1 once a round;
                      the (8,) sigma vector E1 gets equals the 8 row norms
                      recomputed in f64 (relative 1e-6), and its entries
                      differ
     dp_zsign         dp(clip=1.0,eps=2.0,steps=200,q=0.3)|zsign_packed, 8
                      clients: E1 (z=1) + R1 once; the codec's sigma is the
                      port's calibrate_noise(...) * 1.0, E1 gets it for
                      every row; each row whose norm before the clip was
                      above 1 reaches E1 at norm 1 +/- 1e-6, any other
                      unchanged (norms in f64)
     sigma_sched      sigma_sched(head=2.0,tail=0.5)|zsign(z=1,sigma=0.01),
                      8 clients: E1 + R1 once
     cv_stream        cv|zsign_packed(z=1,sigma=0.01), --clients 16 --cohort
                      "stream(shard=6)": E1 and R1 (add mode) 3 times, fold
                      mode never; every cv row and the server variate
                      non-zero after round 1
     plateau          zsign with --plateau, 8 clients: the dynamic route
                      (E1 gets f32 state.sigma), E1 + R1 once
     dpgauss          --compressor dpgauss, 8 clients, one round: E1 and R1
                      never (the dense wire), 32 * 8 * d uplink bits
     vote             zsign(z=1,sigma=0.01,agg=vote), 8 clients: E1 + R1
                      once a round, R1 giving the vote pair's signed count
     trimmed_stream   zsign_packed(z=1,sigma=0.01,agg=trimmed(f=2)), 16
                      clients, stream(shard=6): E1 and R1 (add mode) 3
                      times, the int32 pair carried, the last shard wrapped
     median_attack    zsign(z=1,sigma=0.01,agg=median) under --adversary
                      byte_corrupt(f=2,p=0.1), 8 clients: E1 + R1 once
     ef_topk          --compressor topk (ef|topk(frac=0.01)), 8 clients: no
                      kernel; 0.64 bits a coordinate
     topk_coord_stream  topk(frac=0.01,agg=coord), 16 clients,
                      stream(shard=6): the (2, d) f32 carry, no kernel
     qsgd             --compressor qsgd --qsgd-s 1, 8 clients: no kernel; 2
                      bits a coordinate
     async_zsign      zsign, 16 clients, stream(shard=8,feed=host),
                      --round-mode "async(deadline=1.0,staleness=cutoff(2))"
                      --latency "linear(base=0.0,step=0.25)": clients 0-4
                      on time, 5-8 one round late, 9-12 two, 13-15 dropped;
                      participation 5, 9, 13; E1 2 a round, R1 (add mode)
                      2, 6, 10 (each stale row a one-row fold into the
                      carried sum, the first held against the plain
                      version by ``_StaleFoldProbe``); the host queue holds
                      the late rows (61,754,368 bytes each) between rounds
     async_ef_poly    ef|zsign(use_kernel=true), the same cohort and latency,
                      async(deadline=1.0,staleness=poly(0.5)): every late
                      client computes; participation 5, 5 + 4 * 2^-0.5,
                      5 + 4 * 2^-0.5 + 4 * 3^-0.5 (to 1e-6 relative, as the
                      port's partition_round and the driver's f32 sum give
                      it); F1 2 a round, R1 in fold mode every round
   The last six run under a wire probe (``_WireProbe``, which lists what it
   checks in the first round).
   Each path: finite loss, some param leaf changed in every round, n * d *
   bits uplink bits per round (32 on dpgauss, 0.64 on top-k, 2 on QSGD at
   s = 1; the engine's f32 product), every client-state row (EF residual,
   cv) and the server state non-zero after round 1, its peak
   ``torch.cuda.max_memory_allocated``, and every launch counter set to 0
   just before the path and read just after (a wrapper counts only launches
   on CUDA tensors, so this also shows the buffers lived on the card).
   Then the plans' identity, one round each from the same seeds, params
   compared as bit patterns and residual rows by a position-weighted
   int64 digest of their int32 patterns: (a) the 8-client vmap round equals
   --clients 1 --groups 8; (b) 16 zsign clients under vmap equal
   stream(shard=5); (c) 16 EF clients under stream(shard=6),
   stream(shard=8), stream(shard=8,feed=host) and the group scan
   --clients 8 --groups 2 --cohort vmap are one round (at this width
   --cohort auto streams 16 clients in shards of 8); (d) the same four plans
   for 16 cv clients (cv rows by digest, the server variate as int32
   patterns); (e) 16 clients of zsign(z=1,sigma=0.01,agg=trimmed(f=2))
   under vmap, stream(shard=6) (trimmed_stream), stream(shard=8,feed=host)
   and --clients 8 --groups 2 --cohort vmap, the int32 vote pairs by
   digest too; (f) collude(f=2,rotate=true) on agg=vote, 8 clients, vmap =
   stream(shard=3); (g) 16 EF clients under async(deadline=1.0) with zero
   latency equal the stream(shard=8,feed=host) run of (c), loss,
   participation, uplink bits and shard size included. Each run's plan and
   launches are checked too. Then one round of the paper's non-iid MLP task
   (10 clients, dim 64, width 64) under zsign(z=1,sigma=0.05): E1 and R1
   once each, their outputs equal to their plain versions. Then the
   dynamic sigma: one round with RoundContext(dynamic_sigma=True) from a
   state whose sigma is set to 0.015 (as launch/train.py does after a
   Plateau stall) sends the payload bytes of the static zsign(z=1,
   sigma=0.015) round from the same seeds, and decodes by f32(eta_1) *
   f32(0.015).
4. serving, the MoE, xLSTM, enc-dec and hybrid families and checkpoints, at
   full width (the hybrid reduced):
     serve_qwen2      qwen2-0.5B (bf16, seed-0 weights): 16 requests of one
                      start token, 64 greedy steps through the bundle's
                      decode_step against init_cache(16, 4096) (805,306,368
                      cache bytes); ms a step (CUDA events after a warm-up
                      step), tokens/s, peak memory; every token in range, the
                      cache non-zero exactly at positions < 64
     decode_vs_forward  the same model in f32, batch 2, 16 positions:
                      forward logits against 16 decode steps, max |delta| <
                      2e-2; in bf16 printed (max |delta|, top-1 agreement)
     moe_round        granite-moe-1b-a400m (24 layers, d_model 1024, 32
                      experts of d_ff 512, top-8, vocab 49,155, bf16, router
                      f32; d = 1,334,628,352), zsign at 4 clients under vmap,
                      2 rounds: E1 + R1 once a round, round 0's launches
                      held against their plain versions (``_PlainCheckProbe``);
                      layer 0 of the final params on a (2, 64, 1024) f32
                      input: top-k equal to the CPU's on settled tokens,
                      capacity cells equal to a numpy recount, output and aux
                      within 1e-4 of an f64 per-expert loop; the aux of the
                      final params finite (printed); then 64 greedy steps of
                      16 requests against init_cache(16, 512)
     ckpt_replay      qwen2-0.5B, ef|zsign(use_kernel=true) at 2 clients: 2
                      rounds straight; 1 round under --ckpt-dir, then a
                      rerun to 2 that restores and runs round 2; params and
                      EF residuals bit-identical to the straight run; the
                      checkpoint's bytes and its save and restore times; a
                      host-fed state's pinned rows restore pinned
     xlstm_round      xlstm-350m (24 blocks: 18 mLSTM + 6 sLSTM, d_model
                      1024, bf16; d = 164,979,856), zsign(z=1,sigma=0.05) at
                      2 clients under vmap (4 until shard_xlstm took its
                      time), seq 512 (two mLSTM key chunks,
                      two sLSTM scan chunks), 1 local step, 1 round (its
                      host-bound sLSTM scan takes 20-50 s a round at 2
                      local steps): E1 + R1 once, held against their plain
                      versions
     xlstm_serve      its trained params: 16 requests x 64 greedy steps,
                      the recurrent cache's bytes equal after step 1 and
                      step 64; then in f32, batch 2, 64 positions, the
                      one-token recurrence against the teacher-forced
                      parallel form, max |delta| < 2e-2
     encdec_round     seamless-m4t-large-v2 (24 + 24 layers, d_model 1024,
                      d_ff 8192, vocab 256,206, bf16; d = 1,772,429,312),
                      zsign at 4 clients under vmap, seq 64 (32 source
                      frames + 32 tokens), 2 rounds, E1/R1 as moe_round
     encdec_serve     prefill_cache over 16 requests of 2048 seeded f32
                      frames (timed after a warm-up call), 64 greedy steps
     mamba_jamba_width  one mamba sublayer at Jamba's width (d_model 8192,
                      f32 weights, 1.68 GB): mamba_block on (2, 512, 8192)
                      against 512 mamba_decode_step calls, max |delta| <=
                      1e-4 of max |out|; both timed
     hybrid_reduced   jamba-1.5-large-398b's reduced config (one
                      super-block, d_model 64; the full model does not fit
                      the card), zsign at 4 clients, 2 rounds (E1 + R1 once
                      a round), then 16 greedy decode steps
     remat_qwen2_4k   qwen2-0.5B at full width, one client, micro-batch 1,
                      seq 4,096 (the train_4k length), one local SGD step
                      through build_round_step on the dense f32 wire: at
                      full depth with every layer and cross-entropy chunk
                      rematerialized (the default), then at 12 of its 24
                      layers with and without (at 24 it does not fit the
                      card without): params bit-identical, each run's
                      seconds and peak printed; then the zsign path's
                      round (8 clients, seq 64) without remat, with, with
                      and without, 2 rounds each: params and losses
                      bit-identical every round, each round's seconds
   Every training path runs with the port's default remat (every layer,
   mamba and sLSTM scan chunk and cross-entropy chunk recomputed in the
   backward pass, as the reference does).
5. multi_device, ``stream(shard=K,devices=2)``: two ranks (fresh
   processes, ``torch.multiprocessing.spawn``, started once for the three
   paths) of a gloo group share the one card (NCCL refuses two ranks on
   one device) and each runs ``launch.train.run`` at full qwen2-0.5B
   width; each path runs first in
   this process under ``stream(shard=K)``:
     multi_zsign      zsign(z=1, sigma=0.01), 16 clients, shards of 4, 2
                      rounds: each rank E1 (n = 4, (4, 494,034,944) f32)
                      and R1 twice a round, both held to their plain
                      versions on round 0; params after every round equal
                      on both ranks and to the one-process run
     multi_ef         ef|zsign(use_kernel=true), 8 clients, shards of 2, 1
                      round: each rank F1 twice ((2, 494,034,944) f32) and
                      R1 once in fold mode (the pending 4 clients padded
                      to 8), both held to their plain versions on round 0;
                      residual rows equal to the one-process run's, 4 x d x
                      4 bytes a rank; the decoded f32 update and every
                      param leaf, bf16 too, within rtol 5e-5 / atol 1e-7
                      of it (the f32 sums meet in another association
                      order), the largest ulp gaps printed
     multi_trimmed    zsign_packed(z=1,sigma=0.01,agg=trimmed(f=2)), 16
                      clients, shards of 4, 1 round: the int32 vote pair
                      crosses ranks; params equal to the one-process run
   Each rank makes one reduce of its accumulator and one of the loss a
   round (``core.wire.reduce_accumulator``), moving at most 2 x the
   accumulator's bytes + 8; printed with the round times at D = 1 and D =
   2, each rank's peak memory and the backend. A reduce's time in a round
   includes the wait for the other rank's shards; after the rounds each
   rank times the same reduce twice more, alone after a barrier, for the
   transfer's time and rate. Then ``round_mfu``: 6 *
   N_active * 2,048 tokens (the port's roofline) over the H100's peak,
   against the zsign path's round times.
   ``sharded_replica`` (run before phase 3's paths, while the host's
   memory is free), the model-sharded client replica: four ranks
   (fresh processes, started once for the seven paths) of a (data=2,
   model=2) gloo grid share the card and
   run ``launch/dryrun.build_train_cell``'s step for real; each path runs
   first in this process without a grid (seed-0 weights, the same tokens
   and keys):
     shard_qwen2      qwen2-0.5B at full width, the regular plan: 2 clients
                      side by side (one a data row), each replica over
                      `model` (flat ranges of 247,021,568), zsign(z=1,
                      sigma=0.01), E = 1, micro-batch 2, seq 256, 1 round
                      (shard_granite_moe's 2 rounds cover the regular
                      plan's later round); then, in the same ranks, one
                      ``ef|zsign(use_kernel=true)`` round from round 0's
                      weights and tokens on the range state: F1 once a
                      rank over its range, R1 over the all-gathered (2,
                      n_bytes) rows, both bit-exact against their plain
                      versions; the scale bit-identical across a replica's
                      ranks and within SHARD_EF_SCALE_RTOL of the
                      one-process row's; wire bits off the one-process F1
                      payload only where the pseudo-gradients' signs
                      differ (at most SHARD_EF_FLIP_SHARE); the padding sent
                      as +1 with no residual; collective bytes equal to
                      the dry run's; F1 timed at the range shape
     shard_qwen25_32b qwen2.5-32b at full width with 1 of its 64 layers
                      (d = 2,044,745,728), the big plan: 2 sequential groups
                      of one client, the replica over data x model (a
                      quarter of the padded row each), the micro-batch over
                      data; 1 round
     shard_granite_moe  granite-moe-1b-a400m at full width with 12 of its
                      24 layers (d = 692,482,048; 32 experts of d_ff 512,
                      top-8), the regular plan as shard_qwen2, the experts
                      (E over `model`) gathered a layer; 2 sequence shards
                      of 128 (capacity 40 a shard); 2 rounds
     shard_llama4_scout llama4-scout-17b-a16e at full width with 1 of its
                      48 layers (d = 3,110,763,520; 16 experts of 5120 x
                      8192, top-1, the tied 202,048 x 5120 embedding), the
                      big plan with 1 of its 4 sequential groups, global
                      batch 4 (micro-batch 4 over data), expert-parallel: E over
                      `model`, d_ff over `data` (gathered a layer), the
                      dispatch buffer to the experts' ranks and back by
                      all-to-alls (capacity 10 a shard); 1 round
     shard_internvl2  internvl2-1b at full width (d = 493,780,992), the
                      regular plan, seq 512 (256 stub image embeds + 256
                      text tokens), the text looked up in the gathered
                      table; 1 round
     shard_xlstm      xlstm-350m at full width (d = 164,979,856; 18 mLSTM +
                      6 sLSTM, bf16), the regular plan, zsign(z=1,
                      sigma=0.05), seq 256: the mLSTM's K, V and gates
                      gathered along the sequence (the forget gates'
                      cumulative sum across the shards), the sLSTM's input
                      gathered and its recurrence run whole on each
                      sequence rank; 1 round
     shard_hybrid     jamba-1.5-large-398b's REDUCED config (one
                      super-block: attention, 7 mamba, 4 MoE of 4 experts
                      top-2, 4 SwiGLU; d_model 64, f32; the full width does
                      not fit one card), the big plan: 2 sequential groups,
                      the mamba sublayers channel-parallel over `model`,
                      the MoE expert-parallel; seq 64, 1 round. Then, in
                      the same ranks, one mamba sublayer at Jamba's width
                      (d_model 8192, d_inner 16384, bf16, B = 2, T = 512),
                      forward and backward, its weights stored as the big
                      plan's shards and gathered, channel-parallel on the
                      four ranks, against the one-process block: the output
                      rows, the input's and each weight shard's gradient
                      within relative L2 SHARD_MAMBA_REL_L2; in one process
                      and on each rank with its scan chunks rematerialized
                      and without, the two passes' bits equal and each
                      pass's peak printed. Then the same
                      round again, from the same seed-0 weights and
                      tokens, under the forced stream cohort
                      SHARD_STREAM_COHORT (the big plan's 2 groups in
                      shards of one: E1 and R1 in add mode once a shard
                      over each range): its params bit-identical to the
                      group round's on every rank, its collective bytes by
                      use equal to the group round's
     shard_encdec     seamless-m4t-large-v2 at full width (d_model 1024,
                      16/16 heads, d_ff 8192, the tied 256,206-row table,
                      bf16) with 4 + 4 of its 24 + 24 layers (d =
                      514,035,712), the regular plan, seq 256 (128 frames
                      and 128 target tokens): the encoder's bidirectional
                      attention over the gathered K/V, its memory gathered
                      along the sequence once and every decoder layer's
                      cross-attention over all of it; 1 round; its
                      collective bytes by use equal to the dry run's
   The one-process runs count the MoE's capacity over the grid's 2
   sequence shards (``hints.seq_shard_view``), as the reference's
   ``moe_apply`` does under its mesh. Each rank: E1 (with its tile0) G
   times and R1 once a round, both held to their plain versions on round
   0; its collective bytes by kind equal to ``dryrun.analyze``'s count for
   its rank; its pseudo-gradient range against the one-process row leaf by
   leaf (relative L2 at most SHARD_PG_REL_L2 on round 0, a later round's
   limit by path in SHARD_PG_REL_L2_LATER); wire
   bits off the one-process run's only where the two pseudo-gradients
   differ, at most SHARD_FLIP_SHARE of those sent (a path's own share in
   SHARD_FLIP_SHARE_BY_PATH); params off it (rtol
   1e-5) only at coordinates where a wire bit differed; the loss within
   1e-4 of it; on shard_qwen25_32b and shard_llama4_scout a peak at most 0.6
   x one process's. Printed
   per rank: peak beside one process's and the dry run's, collective bytes
   beside the dry run's, round time and the seconds inside collectives;
   E1 timed at a range shape beside its plain version and bound.
6. the public op ``zsign_decompress_sum`` (U1, on no round path) on a
   full-width payload stack, checked against R1 with unit weights; then
   times at the paths' shapes (n = 8, d as above) with CUDA events, each
   kernel beside its plain version on the same inputs and its bound (R1 in
   add and in fold mode, E1 also at n = 1); and the plain-torch layers of
   the noise controls (row norms, the clip, the sigma_sched multiply, the
   cv correction, row update and server update) and of the new laws and
   codecs (``times_wire_layers``: the vote pair on R1's and on the popcount
   route, the vote decode, the top-k selection, the COO scatter, QSGD's
   norms and quantize, the adversary) beside their bounds.

The last line is ``{"ok": true, "device": {...}}``; the line before it
lists each kernel with its check, launches and times.
"""
from __future__ import annotations

import gc
import json
import math
import os
import subprocess
import sys
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

import torch  # noqa: E402

#: H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, non-tensor f32 ops/s
HBM_BYTES_PER_S = 3.35e12
NON_TENSOR_OPS_PER_S = 67e12
#: integer ops per threefry2x32-13 counter (13 rounds of add, rotate, xor;
#: 3 key injections of 3 ops; the first injection and ks2), and f32 ops per
#: encoded element (u, r, P, threshold, compare; erf counted as 20 for z=1)
OPS_PER_COUNTER = 13 * 3 + 3 * 3 + 4
OPS_PER_ELEM = 8
ERF_OPS = 20
#: f32 ops per element of F1 (add, compare, select, subtract) and of C1
#: (multiply, add, compare)
EF_OPS_PER_ELEM = 4
COMPRESS_OPS_PER_ELEM = 3
#: integer ops per threefry2x32-20 counter of jax's key stream (20 rounds
#: of add, rotate, xor; 5 key injections of 3 ops; the first injection,
#: ks2 and the final xor), and the f32 ops per QSGD coordinate (uniform,
#: |p|/nrm*s, floor, clip, compare, level, sign, product)
KEY_OPS_PER_COUNTER = 20 * 3 + 5 * 3 + 5
QSGD_OPS_PER_ELEM = 16
#: f32 ops per coordinate of the trimmed vote decode
VOTE_DECODE_OPS = 16

COMMON_ARGS = ["--arch", "qwen2_0_5b", "--local-steps", "1",
               "--micro-batch", "2", "--seq-len", "64", "--device", "cuda"]
ZSIGN = ["--compressor", "zsign", "--z", "1", "--sigma", "0.01"]
EF = ["--pipeline", "ef|zsign(use_kernel=true)"]
CV = ["--pipeline", "cv|zsign_packed(z=1,sigma=0.01)"]
DP_SPEC = "dp(clip=1.0,eps=2.0,steps=200,q=0.3)|zsign_packed"
#: the accountant's arguments of DP_SPEC, and its clip norm
DP_ACCOUNT = {"q": 0.3, "steps": 200, "target_eps": 2.0, "delta": 1e-5}
DP_CLIP = 1.0
VOTE = "zsign(z=1,sigma=0.01,agg=vote)"
#: the async paths' cohort: 16 clients host-fed in shards of 8, client i
#: taking 0.25 * i round windows (on time: 0-4; 1 round late: 5-8; 2: 9-12;
#: 3: 13-15, which cutoff(2) drops)
ASYNC_LATENCY = "linear(base=0.0,step=0.25)"
ASYNC_COHORT = ["--clients", "16", "--cohort", "stream(shard=8,feed=host)",
                "--latency", ASYNC_LATENCY]
ASYNC_PATHS = ("async_zsign", "async_ef_poly")
TRIMMED = "zsign(z=1,sigma=0.01,agg=trimmed(f=2))"
#: counters of a path that launches no kernel
NO_KERNEL = {"zsign_encode": 0, "sign_reduce": 0, "ef_sign": 0,
             "zsign_compress": 0, "unpack_sum": 0}
#: the full-width paths: label, train flags, launches per round (kernel
#: counters; "_n1" and "_fold" are the subsets with n = 1 and in fold mode)
PATHS = [
    ("zsign", ZSIGN + ["--clients", "8"],
     {"zsign_encode": 1, "sign_reduce": 1, "ef_sign": 0,
      "zsign_compress": 0, "sign_reduce_fold": 0}),
    ("ef", EF + ["--clients", "8"],
     {"zsign_encode": 0, "sign_reduce": 1, "ef_sign": 1,
      "zsign_compress": 0, "sign_reduce_fold": 0}),
    ("zsign_packed_z2", ["--pipeline", "zsign_packed(z=2,sigma=0.01)",
                         "--clients", "8"],
     {"zsign_encode": 0, "sign_reduce": 1, "ef_sign": 0,
      "zsign_compress": 1}),
    ("zsign_groups", ZSIGN + ["--clients", "1", "--groups", "8"],
     {"zsign_encode": 8, "zsign_encode_n1": 8, "sign_reduce": 1,
      "sign_reduce_fold": 0}),
    ("zsign_stream", ZSIGN + ["--clients", "32", "--cohort", "auto"],
     {"zsign_encode": 4, "zsign_encode_n1": 0, "sign_reduce": 4,
      "sign_reduce_fold": 0, "ef_sign": 0}),
    ("ef_stream", EF + ["--clients", "16", "--cohort", "stream(shard=6)"],
     {"zsign_encode": 0, "ef_sign": 3, "sign_reduce": 3,
      "sign_reduce_fold": 3}),
    ("stosign", ["--compressor", "stosign", "--clients", "8"],
     {"zsign_encode": 1, "sign_reduce": 1, "ef_sign": 0,
      "zsign_compress": 0, "sign_reduce_fold": 0}),
    ("dp_zsign", ["--pipeline", DP_SPEC, "--clients", "8"],
     {"zsign_encode": 1, "sign_reduce": 1, "ef_sign": 0,
      "zsign_compress": 0, "sign_reduce_fold": 0}),
    ("sigma_sched", ["--pipeline",
                     "sigma_sched(head=2.0,tail=0.5)|zsign(z=1,sigma=0.01)",
                     "--clients", "8"],
     {"zsign_encode": 1, "sign_reduce": 1, "ef_sign": 0,
      "zsign_compress": 0, "sign_reduce_fold": 0}),
    ("cv_stream", CV + ["--clients", "16", "--cohort", "stream(shard=6)"],
     {"zsign_encode": 3, "sign_reduce": 3, "sign_reduce_fold": 0,
      "zsign_compress": 0, "ef_sign": 0}),
    ("plateau", ZSIGN + ["--clients", "8", "--plateau"],
     {"zsign_encode": 1, "sign_reduce": 1, "ef_sign": 0,
      "zsign_compress": 0, "sign_reduce_fold": 0}),
    ("dpgauss", ["--compressor", "dpgauss", "--clients", "8"],
     {"zsign_encode": 0, "sign_reduce": 0, "ef_sign": 0,
      "zsign_compress": 0, "unpack_sum": 0}),
    ("vote", ["--pipeline", VOTE, "--clients", "8"],
     {"zsign_encode": 1, "sign_reduce": 1, "sign_reduce_fold": 0,
      "ef_sign": 0, "zsign_compress": 0}),
    ("trimmed_stream", ["--pipeline",
                        "zsign_packed(z=1,sigma=0.01,agg=trimmed(f=2))",
                        "--clients", "16", "--cohort", "stream(shard=6)"],
     {"zsign_encode": 3, "sign_reduce": 3, "sign_reduce_fold": 0,
      "ef_sign": 0, "zsign_compress": 0}),
    ("median_attack", ["--pipeline", "zsign(z=1,sigma=0.01,agg=median)",
                       "--clients", "8", "--adversary",
                       "byte_corrupt(f=2,p=0.1)"],
     {"zsign_encode": 1, "sign_reduce": 1, "sign_reduce_fold": 0,
      "ef_sign": 0, "zsign_compress": 0}),
    ("ef_topk", ["--compressor", "topk", "--clients", "8"], NO_KERNEL),
    ("topk_coord_stream", ["--pipeline", "topk(frac=0.01,agg=coord)",
                           "--clients", "16", "--cohort", "stream(shard=6)"],
     NO_KERNEL),
    ("qsgd", ["--compressor", "qsgd", "--qsgd-s", "1", "--clients", "8"],
     NO_KERNEL),
    # async rounds: a list gives the launches of each round
    ("async_zsign", ZSIGN + ASYNC_COHORT + [
        "--round-mode", "async(deadline=1.0,staleness=cutoff(2))"],
     {"zsign_encode": [2, 2, 2], "sign_reduce": [2, 6, 10],
      "sign_reduce_fold": [0, 0, 0], "ef_sign": 0, "zsign_compress": 0}),
    ("async_ef_poly", EF + ASYNC_COHORT + [
        "--round-mode", "async(deadline=1.0,staleness=poly(0.5))"],
     {"zsign_encode": 0, "ef_sign": [2, 2, 2], "zsign_compress": 0}),
]
#: rounds of a path where it is not ROUNDS, and uplink bits per coordinate
#: where it is not 1. A path whose rounds carry no state (no residual, cv
#: row, Plateau sigma or async queue) runs one: its checks read round 0
PATH_ROUNDS = {"dpgauss": 1, "async_zsign": 3, "async_ef_poly": 3,
               "xlstm_round": 1, "zsign_packed_z2": 1, "zsign_groups": 1,
               "zsign_stream": 1, "stosign": 1, "dp_zsign": 1,
               "sigma_sched": 1, "vote": 1, "trimmed_stream": 1,
               "median_attack": 1, "topk_coord_stream": 1, "qsgd": 1}
PATH_BITS = {"dpgauss": 32, "ef_topk": 64 * 0.01,
             "topk_coord_stream": 64 * 0.01, "qsgd": 2}
#: paths whose E1 calls the probe records (see _E1Probe)
PROBED = ("stosign", "dp_zsign", "plateau")
#: clients per shard each path must resolve to (0: the vmap plan)
PATH_SHARD = {"zsign_groups": 0, "zsign_stream": 8, "ef_stream": 6,
              "zsign_16_vmap": 0, "zsign_16_stream5": 5, "ef_16_stream8": 8,
              "ef_16_stream8_host": 8, "ef_8x2_groups": 0, "cv_stream": 6,
              "cv_16_stream8": 8, "cv_16_stream8_host": 8,
              "cv_8x2_groups": 0, "vote": 0, "trimmed_stream": 6,
              "median_attack": 0, "ef_topk": 0, "topk_coord_stream": 6,
              "qsgd": 0, "trimmed_16_vmap": 0, "trimmed_16_stream8_host": 8,
              "trimmed_8x2_groups": 0, "collude_vmap": 0,
              "collude_stream3": 3, "async_zsign": 8, "async_ef_poly": 8,
              "async_ef_zero": 8, "moe_round": 0}
#: paths whose wire the probe checks (see _WireProbe); the vote-pair
#: digest of their first round joins the identity record
WIRE_PROBED = ("vote", "trimmed_stream", "median_attack", "ef_topk",
               "topk_coord_stream", "qsgd", "trimmed_16_vmap",
               "trimmed_16_stream8_host", "trimmed_8x2_groups",
               "collude_vmap", "collude_stream3")
#: the paths on R1's vote-pair route
VOTE_ROUTE = ("vote", "trimmed_stream", "median_attack")
TOPK_K = max(1, int(494_032_768 * 0.01))
ROUNDS = 2
#: the plan identities: (name, [(label, flags, launches per round), ...]);
#: a label naming a path of PATHS reuses that path's first round. 16
#: clients stream under --cohort auto at this width, so the group scan is
#: asked for with --cohort vmap.
IDENTITIES = [
    ("a", [("zsign", None, None), ("zsign_groups", None, None)]),
    ("b", [("zsign_16_vmap", ZSIGN + ["--clients", "16", "--cohort", "vmap"],
            {"zsign_encode": 1, "sign_reduce": 1}),
           ("zsign_16_stream5", ZSIGN + ["--clients", "16", "--cohort",
                                         "stream(shard=5)"],
            {"zsign_encode": 4, "sign_reduce": 4, "sign_reduce_fold": 0})]),
    ("c", [("ef_stream", None, None),
           ("ef_16_stream8", EF + ["--clients", "16", "--cohort",
                                   "stream(shard=8)"],
            {"ef_sign": 2, "sign_reduce": 2, "sign_reduce_fold": 2}),
           ("ef_16_stream8_host", EF + ["--clients", "16", "--cohort",
                                        "stream(shard=8,feed=host)"],
            {"ef_sign": 2, "sign_reduce": 2, "sign_reduce_fold": 2}),
           ("ef_8x2_groups", EF + ["--clients", "8", "--groups", "2",
                                   "--cohort", "vmap"],
            {"ef_sign": 2, "sign_reduce": 1, "sign_reduce_fold": 0})]),
    ("d", [("cv_stream", None, None),
           ("cv_16_stream8", CV + ["--clients", "16", "--cohort",
                                   "stream(shard=8)"],
            {"zsign_encode": 2, "sign_reduce": 2, "sign_reduce_fold": 0}),
           ("cv_16_stream8_host", CV + ["--clients", "16", "--cohort",
                                        "stream(shard=8,feed=host)"],
            {"zsign_encode": 2, "sign_reduce": 2, "sign_reduce_fold": 0}),
           ("cv_8x2_groups", CV + ["--clients", "8", "--groups", "2",
                                   "--cohort", "vmap"],
            {"zsign_encode": 2, "sign_reduce": 1, "sign_reduce_fold": 0})]),
    ("e", [("trimmed_16_vmap", ["--pipeline", TRIMMED, "--clients", "16",
                                "--cohort", "vmap"],
            {"zsign_encode": 1, "sign_reduce": 1}),
           ("trimmed_stream", None, None),
           ("trimmed_16_stream8_host", ["--pipeline", TRIMMED, "--clients",
                                        "16", "--cohort",
                                        "stream(shard=8,feed=host)"],
            {"zsign_encode": 2, "sign_reduce": 2, "sign_reduce_fold": 0}),
           ("trimmed_8x2_groups", ["--pipeline", TRIMMED, "--clients", "8",
                                   "--groups", "2", "--cohort", "vmap"],
            {"zsign_encode": 2, "sign_reduce": 1, "sign_reduce_fold": 0})]),
    ("f", [("collude_vmap", ["--pipeline", VOTE, "--clients", "8",
                             "--adversary", "collude(f=2,rotate=true)",
                             "--cohort", "vmap"],
            {"zsign_encode": 1, "sign_reduce": 1}),
           ("collude_stream3", ["--pipeline", VOTE, "--clients", "8",
                                "--adversary", "collude(f=2,rotate=true)",
                                "--cohort", "stream(shard=3)"],
            {"zsign_encode": 3, "sign_reduce": 3, "sign_reduce_fold": 0})]),
    # zero latency: the async round is the sync host-fed round, metrics too
    ("g", [("ef_16_stream8_host", None, None),
           ("async_ef_zero", EF + ["--clients", "16", "--cohort",
                                   "stream(shard=8,feed=host)",
                                   "--round-mode", "async(deadline=1.0)"],
            {"ef_sign": 2, "sign_reduce": 2, "sign_reduce_fold": 2})]),
]
QWEN2_COORDS = 494_032_768
#: granite-moe-1b-a400m at full width (24 layers, d_model 1024, 32 experts
#: of d_ff 512, top-8, vocab 49,155, bf16 with the router f32)
MOE_COMMON = ["--arch", "granite_moe_1b_a400m", "--local-steps", "2",
              "--micro-batch", "2", "--seq-len", "64", "--device", "cuda"]
MOE_COORDS = 1_334_628_352
MOE_FLAGS = ZSIGN + ["--clients", "4", "--cohort", "vmap"]
E1_R1_ONCE = {"zsign_encode": 1, "sign_reduce": 1, "sign_reduce_fold": 0,
                "ef_sign": 0, "zsign_compress": 0}
#: xlstm-350m at full width (24 blocks: 18 mLSTM + 6 sLSTM, d_model 1024,
#: 4 heads, vocab 50,304, bf16 with wr, bif, b f32; d = 164,979,856); seq 512
#: gives the mLSTM two key chunks and the sLSTM two scan chunks; one local
#: step (the sLSTM's Python loop makes each 20-25 s on the card's host)
XLSTM_COMMON = ["--arch", "xlstm_350m", "--local-steps", "1",
                "--micro-batch", "2", "--seq-len", "512", "--device", "cuda"]
XLSTM_COORDS = 164_979_856
XLSTM_FLAGS = ["--pipeline", "zsign(z=1,sigma=0.05)", "--sigma", "0.05",
               "--clients", "2", "--cohort", "vmap"]
#: seamless-m4t-large-v2 at full width (24 encoder + 24 decoder layers,
#: d_model 1024, 16 heads, d_ff 8192, vocab 256,206, bf16; d =
#: 1,772,429,312); seq 64 = 32 source frames + 32 tokens
ENCDEC_COMMON = ["--arch", "seamless_m4t_large_v2", "--local-steps", "2",
                 "--micro-batch", "2", "--seq-len", "64", "--device", "cuda"]
ENCDEC_COORDS = 1_772_429_312
#: the hybrid family at jamba-1.5-large-398b's reduced config (8 sublayers,
#: d_model 64, 4 experts top-2, f32): the full model does not fit the card
HYBRID_COMMON = ["--arch", "jamba_1_5_large_398b", "--reduced",
                 "--local-steps", "2", "--micro-batch", "2", "--seq-len",
                 "64", "--device", "cuda"]
#: paths whose round-0 E1 and R1 are held against their plain versions
PLAIN_CHECKED = ("moe_round", "xlstm_round", "encdec_round")
#: serving of the new families: xLSTM 16 requests x 64 greedy steps (an
#: O(1) recurrent cache), its f32 decode against the parallel forward over
#: 64 positions; enc-dec 16 requests of 2048 source frames, 64 steps; the
#: reduced hybrid 16 steps of 4 requests
XLSTM_SERVE = {"batch": 16, "steps": 64, "dvf_positions": 64}
ENCDEC_SERVE = {"batch": 16, "steps": 64, "max_len": 128}
HYBRID_DECODE = {"batch": 4, "steps": 16, "max_len": 32}
#: one mamba sublayer at Jamba's width (d_model 8192, d_inner 16384, dt_rank
#: 512, f32): mamba_block over B x T against T calls of mamba_decode_step,
#: max |delta| <= MAMBA_REL * max |out| (stated before the first run)
JAMBA_MAMBA = {"d_model": 8192, "batch": 2, "seq": 512}
MAMBA_REL = 1e-4
#: remat_qwen2_4k: qwen2-0.5B at full width, one client, micro-batch 1, the
#: train_4k length, one local SGD step at client_lr lr. Without remat the
#: full 24 layers ran out of the card's 80 GB (an H100 80GB HBM3 at 700 W:
#: ~3.3 GB of flash-attention chunk tensors kept a layer), so the run with
#: remat and the one without meet at cut_layers, where the params must be
#: bit-identical
REMAT_4K = {"arch": "qwen2_0_5b", "seq": 4096, "micro": 1, "lr": 0.01,
            "cut_layers": 12}
#: and the zsign path's round (qwen2-0.5B, 8 clients, micro-batch 2, seq
#: 64, z = 1, sigma 0.01) without remat, with, with, without, 2 rounds
#: each: what the default remat costs the main path, read in one process
REMAT_ZSIGN = {"clients": 8, "micro": 2, "seq": 64, "z": 1, "sigma": 0.01,
               "lr": 0.01, "rounds": 2}
#: serving: requests, greedy steps, cache length (qwen2-0.5B full width);
#: the MoE decode after its round
SERVE = {"batch": 16, "steps": 64, "max_len": 4096}
MOE_SERVE = {"batch": 16, "steps": 64, "max_len": 512}
#: the MoE layer check: a top-k counts as settled where every gap of the
#: k + 1 largest gates exceeds MOE_GAP (the CPU tests' rule); output and aux
#: against the f64 loop within MOE_RTOL (relative to max |out|, and to aux)
MOE_GAP, MOE_RTOL = 1e-5, 1e-4
#: the checkpoint replay: EF at 2 clients (3.95 GB of residuals)
CKPT_FLAGS = EF + ["--clients", "2", "--save-every", "20"]
#: the multi-device phase: stream(shard=K,devices=2), two ranks of a gloo
#: group sharing the one card (NCCL refuses two ranks on one device), each
#: path first in one process under stream(shard=K). Label, train flags,
#: shard, rounds, and each rank's launches a round
MULTI_RANKS = 2
MULTI_PATHS = [
    ("multi_zsign", ZSIGN + ["--clients", "16"], 4, 2,
     {"zsign_encode": 2, "sign_reduce": 2, "sign_reduce_fold": 0,
      "ef_sign": 0}),
    ("multi_ef", EF + ["--clients", "8"], 2, 1,
     {"zsign_encode": 0, "sign_reduce": 1, "sign_reduce_fold": 1,
      "ef_sign": 2}),
    ("multi_trimmed", ["--pipeline",
                       "zsign_packed(z=1,sigma=0.01,agg=trimmed(f=2))",
                       "--clients", "16"], 4, 1,
     {"zsign_encode": 2, "sign_reduce": 2, "sign_reduce_fold": 0,
      "ef_sign": 0}),
]
#: paths whose kernels are held to their plain versions on round 0 (on
#: every rank and in the one-process run), with the rows of each kernel's
#: first launch there; its columns are d_pad for E1 and F1, the payload's
#: d_pad / 8 bytes for R1 (add mode, or fold mode closing the pending
#: block of 4 clients padded to 8)
MULTI_PLAIN = {
    "multi_zsign": {"zsign_encode": 4, "sign_reduce": 4},
    "multi_ef": {"ef_sign": 2, "sign_reduce_fold": 8},
    "multi_trimmed": {"zsign_encode": 4, "sign_reduce": 4},
}
#: seconds a rank waits at init and in a collective before failing
MULTI_TIMEOUT_S = 300
#: the reference's tolerance on f32 results of the f32-weighted EF sum
#: (tests/test_cohort_stream.py:382-384)
EF_RTOL, EF_ATOL = 5e-5, 1e-7
#: round_mfu: tokens of one zsign round (8 clients x E 1 x micro-batch 2 x
#: seq 64)
MFU_TOKENS = 8 * 1 * 2 * 64


def _wrappers():
    """Every kernel wrapper of the port, by kernel name."""
    from repro_torch.kernels.efsign import ops as eops
    from repro_torch.kernels.zsign import ops
    return {"zsign_encode": ops.zsign_encode, "sign_reduce": ops.sign_reduce,
            "ef_sign": eops.ef_sign_rows,
            "zsign_compress": ops.zsign_compress_rows,
            "unpack_sum": ops.unpack_sum}


def _reset_counts():
    ops = _wrappers()
    for w in ops.values():
        w.launches = 0
    ops["zsign_encode"].launches_n1 = 0
    ops["zsign_encode"].launches_range = 0
    ops["sign_reduce"].fold_launches = 0


def _counts():
    ops = _wrappers()
    out = {k: w.launches for k, w in ops.items()}
    out["zsign_encode_n1"] = ops["zsign_encode"].launches_n1
    out["zsign_encode_range"] = ops["zsign_encode"].launches_range
    out["sign_reduce_fold"] = ops["sign_reduce"].fold_launches
    return out


def _time_ms(fn, reps: int, warmup: int = 1) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _bound(nbytes: float, ops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / NON_TENSOR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _same_bits(a, b) -> bool:
    """Equal dtypes and equal bit patterns (floats compared as ints)."""
    if a.dtype != b.dtype:
        return False
    if a.is_floating_point():
        iv = {2: torch.int16, 4: torch.int32}[a.element_size()]
        return torch.equal(a.view(iv), b.view(iv))
    return torch.equal(a, b)


DEV = torch.device("cuda", 0)


def _free():
    gc.collect()
    torch.cuda.empty_cache()


def _rank_loop(rank, world, setup, setup_args, jobs, done):
    """A rank of a ``_RankPool``: joins the group (``setup``), then runs
    each job ``(fn, args)`` of its queue as ``fn(rank, world, ctx,
    *args)`` (``ctx`` is what ``setup`` returned) and frees the card's
    cache and the pinned blocks torch's caching host allocator keeps (the
    gloo staging of ``launch/hints``) after it, so that none outlives its
    path into the next one's peaks, until a None."""
    import torch.distributed as dist
    ctx = setup(rank, world, *setup_args)
    while True:
        job = jobs[rank].get()
        if job is None:
            break
        fn, args = job
        fn(rank, world, ctx, *args)
        _free()
        torch._C._host_emptyCache()
        done.put(rank)
    dist.barrier()
    dist.destroy_process_group()


class _RankPool:
    """``n`` ranks of a gloo group in fresh processes
    (``torch.multiprocessing.spawn``), started once for every path of a
    phase: each joins the group once and then runs the jobs ``run`` hands
    it, one path at a time, so that a path pays for no process start,
    import, card context or group of its own."""

    def __init__(self, n, setup, setup_args, timeout_s):
        import torch.multiprocessing as mp
        spawn = mp.get_context("spawn")
        self.n, self.timeout_s = n, timeout_s
        self.jobs = [spawn.SimpleQueue() for _ in range(n)]
        self.done = spawn.Queue()
        self.ctx = mp.spawn(_rank_loop, nprocs=n, join=False,
                            args=(n, setup, setup_args, self.jobs,
                                  self.done))

    def run(self, fn, *args):
        """Every rank runs ``fn(rank, world, ctx, *args)``; returns when
        all have, and raises as ``mp.spawn`` does when a rank failed."""
        import queue
        for q in self.jobs:
            q.put((fn, args))
        got, t0 = 0, time.time()
        while got < self.n:
            try:
                self.done.get(timeout=1.0)
                got += 1
            except queue.Empty:
                # a rank that failed raises here (the others are ended)
                self.ctx.join(timeout=0)
                if time.time() - t0 > self.timeout_s:
                    raise TimeoutError(f"{fn.__name__}: {got} of "
                                       f"{self.n} ranks done after "
                                       f"{self.timeout_s} s")

    def close(self, ok=True):
        """Ends the ranks: a None to each, then a wait for every exit (a
        rank that failed raises here); ``ok`` false ends them at once."""
        if ok:
            for q in self.jobs:
                q.put(None)
            t0 = time.time()
            while not self.ctx.join(timeout=1.0):
                if time.time() - t0 > self.timeout_s:
                    ok = False
                    break
        if not ok:
            for p in self.ctx.processes:
                if p.is_alive():
                    p.terminate()
            for p in self.ctx.processes:
                p.join()


def phase_device_and_build():
    from repro_torch.kernels import build
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(f"# device: {name} (count {torch.cuda.device_count()})")
    print(smi)
    t0 = time.time()
    build.build_all()
    print(f"# {len(build.SOURCES)} kernels built in {time.time() - t0:.1f} s")
    for src, log in build.BUILD_LOG.items():
        used = [ln.strip() for ln in log.splitlines() if "Used" in ln
                or "spill" in ln]
        print(f"# ptxas {src}: " + " | ".join(used))
    return name, smi


def check_encode_and_reduce(dev):
    from repro_torch.core import noise
    from repro_torch.kernels.zsign import ops
    gen = torch.Generator(device=dev).manual_seed(11)
    d = 5 * 8192 + 3
    d_pad = -(-d // ops.TILE) * ops.TILE
    flips_z1 = 0
    for n in (1, 8, 13):
        x = torch.zeros((n, d_pad), device=dev)
        x[:, :d] = torch.randn((n, d), generator=gen, device=dev)
        keys = noise.client_keys(noise.prng_key(5), 0, n)
        for z in (noise.Z_INF, 1):
            for s in (0.0, 0.05):
                sig = torch.full((n,), s, device=dev)
                got = ops.zsign_encode(x, keys, sig, z)
                want = ops.zsign_encode_plain(x, keys, sig, z)
                torch.cuda.synchronize()
                nflip, far = ops.erf_rule_flips(x, keys, sig, z, got, want)
                if z == 1:
                    flips_z1 += nflip
                if far or (z != 1 and nflip):
                    raise AssertionError(
                        f"E1 n={n} z={z} sigma={s}: {nflip} bits differ "
                        f"({far} outside the erf rule)")
                if n == 8:
                    for c in range(n):
                        one = ops.zsign_encode(x[c:c + 1].contiguous(),
                                               keys[c:c + 1], sig[c:c + 1], z)
                        if not torch.equal(one[0], got[c]):
                            raise AssertionError(
                                f"E1 client {c}: batched bytes != n=1 bytes")
                    torch.cuda.synchronize()
    # a sigma for each client, one of them 0 (the sto-sign route)
    for n in (8, 13):
        x = torch.randn((n, d_pad), generator=gen, device=dev)
        keys = noise.client_keys(noise.prng_key(6), 0, n)
        sig = torch.rand((n,), generator=gen, device=dev) * 2.0 + 0.05
        sig[3] = 0.0
        for z in (noise.Z_INF, 1):
            got = ops.zsign_encode(x, keys, sig, z)
            want = ops.zsign_encode_plain(x, keys, sig, z)
            torch.cuda.synchronize()
            nflip, far = ops.erf_rule_flips(x, keys, sig, z, got, want)
            if z == 1:
                flips_z1 += nflip
            free = ops.zsign_encode_plain(x[3:4], keys[3:4], sig[3:4], None)
            if (far or (z != 1 and nflip)
                    or not torch.equal(got[3], free[0])):
                raise AssertionError(f"E1 per-client sigma n={n} z={z}: "
                                     f"{nflip} bits differ ({far} outside "
                                     "the erf rule) or the sigma-0 row is "
                                     "not its noise-free pack")
    print(f"# E1 checks passed (one sigma and a sigma per client); z=1 bits "
          f"differing from the plain version: {flips_z1}")
    nb = 5 * 1024 + 7
    for n in (1, 8, 13):
        packed = torch.randint(0, 256, (n, nb), generator=gen, device=dev,
                               dtype=torch.uint8)
        weights = {"f32": torch.randn((n,), generator=gen, device=dev),
                   "mask": torch.randint(0, 2, (n,), generator=gen,
                                         device=dev).float()}
        acc = torch.randn((8 * nb,), generator=gen, device=dev)
        for wname, w in weights.items():
            for a in (None, acc):
                got = ops.sign_reduce(packed, w, a)
                want = ops.sign_reduce_plain(packed, w, a)
                torch.cuda.synchronize()
                if not _same_bits(got, want):
                    raise AssertionError(f"R1 n={n} {wname} acc="
                                         f"{a is not None}: bits differ")
    print("# R1 checks passed (int32 bit patterns equal)")
    return flips_z1


def check_fold(dev):
    """R1 in fold mode against its plain version: f32 weights (a first
    block of -0.0 weights), shard sequences whose pending rows carry over,
    finalized with and without pending rows; int32 patterns of the final
    sum, also against the one-shot R1 over all rows."""
    from repro_torch.core import wire
    from repro_torch.kernels.zsign import ops
    gen = torch.Generator(device=dev).manual_seed(16)
    nb = 5 * 1024 + 7
    n_cases = 0
    for shards in ((3, 5, 8, 1, 13), (3, 5, 8, 1, 15), (8, 8), (6, 6, 6),
                   (1, 2, 3, 4, 5, 6, 7)):
        n = sum(shards)
        packed = torch.randint(0, 256, (n, nb), generator=gen, device=dev,
                               dtype=torch.uint8)
        w = torch.randn((n,), generator=gen, device=dev)
        w[:8] = -0.0
        got = wire.sign_fold_init(nb, dev)
        want = wire.sign_fold_init(nb, dev)
        lo = 0
        for k in shards:
            got = ops.sign_fold_step(packed[lo:lo + k], w[lo:lo + k], got)
            want = wire._sign_fold_step(
                packed[lo:lo + k], w[lo:lo + k], want,
                close=lambda r, ww, a: ops.sign_reduce_plain(r, ww, a,
                                                             fold=True))
            lo += k
        if got.pend_n != want.pend_n or got.pend_n != n % 8:
            raise AssertionError(f"R1 fold {shards}: pending rows differ")
        out = ops.sign_fold_finalize(got)
        ref = wire.sign_fold_finalize(
            want, close=lambda r, ww, a: ops.sign_reduce_plain(r, ww, a,
                                                               fold=True))
        one = ops.sign_reduce(packed, w)
        torch.cuda.synchronize()
        if not (_same_bits(out, ref) and _same_bits(out, one)):
            raise AssertionError(f"R1 fold {shards}: bits differ")
        n_cases += 1
    print(f"# R1 fold-mode checks passed ({n_cases} shard sequences, int32 "
          "bit patterns equal to the plain fold and to one-shot R1)")


def check_ef_compress_unpack(dev):
    from repro_torch.kernels.efsign import ops as eops
    from repro_torch.kernels.zsign import ops
    gen = torch.Generator(device=dev).manual_seed(13)
    d = 2 * 8192 + 37                     # not a multiple of 8192
    d_pad = 3 * 8192
    for n in (1, 3, 8):
        g = torch.zeros((n, d_pad), device=dev)
        g[:, :d] = torch.randn((n, d), generator=gen, device=dev)
        e = torch.randn((n, d), generator=gen, device=dev) * 0.3
        g[:, :d:7] = -e[:, ::7]           # p == 0 exactly: packs as +1
        scale = torch.rand((n,), generator=gen, device=dev) + 0.1
        live = torch.ones((n,), device=dev)
        live[n // 2] = 0.0                # one dead client
        for lv in (None, live):
            for with_q in (False, True):
                got = eops.ef_sign_rows(g, e, scale, live=lv, with_q=with_q)
                want = eops.ef_sign_rows_plain(g, e, scale, live=lv,
                                               with_q=with_q)
                torch.cuda.synchronize()
                for k in range(3 if with_q else 2):
                    if not _same_bits(got[k], want[k]):
                        raise AssertionError(
                            f"F1 n={n} live={lv is not None} q={with_q}: "
                            f"output {k} differs")
        e2 = e.clone()
        packed, out, _ = eops.ef_sign_rows(g, e2, scale, live=live,
                                           in_place=True)
        want = eops.ef_sign_rows_plain(g, e, scale, live=live)
        torch.cuda.synchronize()
        if (out.data_ptr() != e2.data_ptr() or not _same_bits(packed, want[0])
                or not _same_bits(e2, want[1])
                or not _same_bits(e2[n // 2], e[n // 2])):
            raise AssertionError(f"F1 n={n} in place: differs")
        x = torch.zeros((n, d_pad), device=dev)
        nz = torch.zeros_like(x)
        x[:, :d] = torch.randn((n, d), generator=gen, device=dev) * 0.05
        nz[:, :d] = torch.randn((n, d), generator=gen, device=dev)
        sig = torch.rand((n,), generator=gen, device=dev) * 0.1
        x[:, :d:5] = -(sig.reshape(n, 1) * nz[:, :d:5])   # y == 0 unfused
        for s in (sig, torch.zeros_like(sig)):
            got = ops.zsign_compress_rows(x, nz, s)
            want = ops.zsign_compress_rows_plain(x, nz, s)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"C1 n={n}: bytes differ")
        p = torch.randint(0, 256, (n, 5 * 1024 + 7), generator=gen,
                          device=dev, dtype=torch.uint8)
        got, want = ops.unpack_sum(p), ops.unpack_sum_plain(p)
        torch.cuda.synchronize()
        if not _same_bits(got, want):
            raise AssertionError(f"U1 n={n}: bits differ")
    print("# F1, C1, U1 checks passed (bit patterns equal)")


class _E1Probe:
    """Stands in for the kernel module inside ``core.compression`` while a
    path runs: each E1 call goes to the real wrapper (whose launch count
    stays its own) and is recorded with its z, its sigma vector and, for
    the first call, the f64 L2 norms of the rows it got."""

    def __init__(self, ops, d: int):
        self._ops, self._d, self.calls = ops, d, []

    def __getattr__(self, name):
        return getattr(self._ops, name)

    def zsign_encode(self, x2d, keys, sigma, z, tile0=None):
        out = self._ops.zsign_encode(x2d, keys, sigma, z, tile0)
        call = {"z": z, "sigma": sigma.detach().clone()}
        if not self.calls:
            call["norms64"] = _norms64(x2d, self._d)
        self.calls.append(call)
        return out


class _StaleFoldProbe:
    """Stands in for the kernel module inside ``core.compression`` on the
    async zsign path: the first one-row R1 add-mode call with a carried
    ``acc`` (a stale payload folded into the round's sum) is held against
    the plain version on the same acc, row and weight, as int32 patterns.
    The plain call is not counted; the real one counts as ever."""

    def __init__(self, ops):
        self._ops, self.seen = ops, None

    def __getattr__(self, name):
        return getattr(self._ops, name)

    def sign_reduce(self, packed, weights, acc=None):
        if self.seen is None and packed.shape[0] == 1 and acc is not None:
            want = self._ops.sign_reduce_plain(packed, weights, acc)
            got = self._ops.sign_reduce(packed, weights, acc)
            torch.cuda.synchronize()
            if not _same_bits(got, want):
                raise AssertionError("R1 one-row stale fold: bits differ "
                                     "from the plain version")
            self.seen = {"n": 1, "n_bytes": int(packed.shape[1]),
                         "weight": float(weights[0]), "equal": True}
            del want
            return got
        return self._ops.sign_reduce(packed, weights, acc)


class _PlainCheckProbe:
    """Stands in for the kernel module inside ``core.compression`` on a
    path whose round-0 E1 and R1 launches are held against their plain
    versions on the same buffer, keys and weights: E1 by the erf rule
    (bit-exact, or every differing bit within 4 f32 ulp of its
    threshold), R1 in add mode and in fold mode (the carry before the
    launch, which writes over it) as int32 patterns. The plain calls are
    not counted."""

    def __init__(self, ops):
        self._ops, self.seen = ops, {}

    def __getattr__(self, name):
        return getattr(self._ops, name)

    def zsign_encode(self, x2d, keys, sigma, z, tile0=None):
        got = self._ops.zsign_encode(x2d, keys, sigma, z, tile0)
        if "zsign_encode" not in self.seen:
            want = self._ops.zsign_encode_plain(x2d, keys, sigma, z, tile0)
            nflip, far = self._ops.erf_rule_flips(x2d, keys, sigma, z, got,
                                                  want, tile0=tile0)
            if far:
                raise AssertionError(f"E1: {far} bits differ from the plain "
                                     "version outside the erf rule")
            self.seen["zsign_encode"] = {
                "shape": list(x2d.shape), "tile0": tile0,
                "bits_differing": nflip, "max_abs_err": 1 if nflip else 0}
            del want
        return got

    def sign_reduce(self, packed, weights, acc=None):
        got = self._ops.sign_reduce(packed, weights, acc)
        if "sign_reduce" not in self.seen:
            want = self._ops.sign_reduce_plain(packed, weights, acc)
            if not _same_bits(got, want):
                raise AssertionError("R1: bits differ from the plain "
                                     "version")
            self.seen["sign_reduce"] = {"shape": list(packed.shape),
                                        "max_abs_err": 0.0}
            del want
        return got

    def _fold_close(self, rows, w, sums):
        if "sign_reduce_fold" in self.seen:
            return self._ops._fold_close(rows, w, sums)
        want = self._ops.sign_reduce_plain(rows, w, sums, fold=True)
        got = self._ops._fold_close(rows, w, sums)
        if not _same_bits(got, want):
            raise AssertionError("R1 fold mode: bits differ from the plain "
                                 "version")
        self.seen["sign_reduce_fold"] = {"shape": list(rows.shape),
                                         "max_abs_err": 0.0}
        del want
        return got

    def sign_fold_step(self, packed, weights, acc):
        from repro_torch.core import wire
        return wire._sign_fold_step(packed, weights, acc,
                                    close=self._fold_close)

    def sign_fold_finalize(self, acc):
        from repro_torch.core import wire
        return wire.sign_fold_finalize(acc, close=self._fold_close)


class _EfPlainProbe:
    """Stands in for the F1 module inside ``core.compression``: the first
    ``ef_sign_rows`` launch is held against ``ef_sign_rows_plain`` on the
    same rows, residuals (before the launch, which writes over them),
    scales and live mask; payload bytes and residual bit patterns equal.
    The plain call is not counted. Records into ``seen`` (shared with a
    ``_PlainCheckProbe``)."""

    def __init__(self, eops, seen):
        self._eops, self.seen = eops, seen

    def __getattr__(self, name):
        return getattr(self._eops, name)

    def ef_sign_rows(self, g2d, e2d, scale, **kw):
        if "ef_sign" in self.seen:
            return self._eops.ef_sign_rows(g2d, e2d, scale, **kw)
        want = self._eops.ef_sign_rows_plain(g2d, e2d, scale,
                                             **{**kw, "in_place": False})
        got = self._eops.ef_sign_rows(g2d, e2d, scale, **kw)
        for k, name in enumerate(("payload", "residuals", "q")):
            if want[k] is not None and not _same_bits(got[k], want[k]):
                raise AssertionError(f"F1: {name} differ from the plain "
                                     "version")
        self.seen["ef_sign"] = {"shape": list(g2d.shape), "max_abs_err": 0.0}
        del want
        return got


class _ClipProbe:
    """Stands in for ``core.dp`` inside ``core.compression`` on the DP
    path: the first clip records the f64 L2 norms of the rows before it
    clips them with the real ``clip_rows_``."""

    def __init__(self, dp):
        self._dp, self.before64 = dp, None

    def __getattr__(self, name):
        return getattr(self._dp, name)

    def clip_rows_(self, p2d, n_coords, max_norm, nrms=None):
        if self.before64 is None:
            self.before64 = _norms64(p2d, n_coords)
        return self._dp.clip_rows_(p2d, n_coords, max_norm, nrms)


class _WireProbe:
    """Wraps ``Pipeline.encode_batch``, ``aggregate`` and ``decode_sum``
    while a path of the new codecs and laws runs, and checks what crosses
    the wire in its first round (the calls before the first decode):

      vote            the pair from R1's route equals the plain popcount
                      route (``wire.vote_accumulator`` on the same card
                      tensors) as int32; the decoded update lies in
                      {-1, 0, +1}
      trimmed, vote   the carried accumulator is the (2, d_pad) int32 pair;
      pair routes     n_live (row 1) is the cohort size on every
                      coordinate, so the wrapped last shard added nothing
      median_attack   bytes of rows 0-1 differ from their honest encode in
                      a share of 0.1 * 255/256 (within six standard
                      deviations), rows 2-7 are untouched
      ef_topk         exactly k indices per client, unique, in
                      [0, n_coords), int32
      topk_coord      the (2, n_coords) f32 carry; the count row is an
                      integer in [0, clients]
      qsgd            every q coordinate is 0 or +/- the row's f32 norm
                      (+1e-12), and that norm is the f64 norm of the row
                      before the encode to 1e-4 (f32 summation)

    Checks run on the card and read back one bool or a few numbers; the
    first round's decoded aggregate (the vote pair, where there is one)
    is digested for the plan identities. Launch counts are untouched: the
    plain route it compares with launches no kernel."""

    def __init__(self, label, clients):
        self.label, self.clients = label, clients
        self.out, self.first, self.digest = {}, True, None

    def install(self, compression):
        P = compression.Pipeline
        self._P = P
        self._orig = (P.encode_batch, P.aggregate, P.decode_sum)
        enc0, agg0, dec0 = self._orig
        probe = self

        def encode_batch(pipe, keys, flat2d, n_coords=None, *a, **kw):
            pre = probe.before_encode(flat2d, n_coords)
            out = enc0(pipe, keys, flat2d, n_coords, *a, **kw)
            probe.after_encode(out[0], pre, n_coords)
            return out

        def aggregate(pipe, payload, mask, n_coords, acc=None):
            if probe.first:
                probe.on_aggregate(payload, mask, n_coords, acc)
            return agg0(pipe, payload, mask, n_coords, acc)

        def decode_sum(pipe, enc_sum, n_live, *a, **kw):
            out = dec0(pipe, enc_sum, n_live, *a, **kw)
            if probe.first:
                probe.on_decode(enc_sum, out)
                probe.first = False
            return out

        P.encode_batch, P.aggregate, P.decode_sum = (encode_batch, aggregate,
                                                     decode_sum)

    def uninstall(self):
        self._P.encode_batch, self._P.aggregate, self._P.decode_sum = \
            self._orig

    def _fail(self, what):
        raise AssertionError(f"{self.label}: {what}")

    def before_encode(self, x2d, d):
        if not self.first:
            return None
        if self.label == "qsgd":
            from repro_torch.core import dp
            return _norms64(x2d, d), dp.row_norms(x2d, d) + 1e-12
        return None

    def after_encode(self, payload, pre, d):
        if not self.first:
            return
        if self.label == "median_attack":
            self.honest = payload.clone()
        elif self.label == "qsgd":
            norms64, nrm = pre
            rel = []
            for c in range(payload.shape[0]):
                row = payload[c, :d]
                mag = torch.abs(row)
                if not bool(torch.all((row == 0) | (mag == nrm[c]))):
                    self._fail(f"q row {c} holds values besides 0 and "
                               f"+/-{float(nrm[c])}")
                rel.append(abs(float(nrm[c]) - float(norms64[c]))
                           / float(norms64[c]))
            # torch's f32 vector_norm is off the f64 norm by ~4e-6 at 138K
            # coordinates on the CPU; the reading at full width is kept
            if max(rel) > 1e-4:
                self._fail(f"q magnitudes off the f64 row norms by {rel}")
            self.out["q_levels_vs_f64_norm_max_rel"] = max(rel)

    def on_aggregate(self, payload, mask, d, acc):
        from repro_torch.core import wire
        if self.label == "vote":
            plain = wire.vote_accumulator(payload, mask)
            self.pending_plain = plain
        elif self.label == "median_attack":
            diff = (payload != self.honest).float().mean(1).tolist()
            want = 0.1 * 255 / 256
            # six standard deviations of a share of n_bytes draws
            tol = 6 * math.sqrt(want * (1 - want) / payload.shape[1])
            if (any(abs(x - want) > tol for x in diff[:2])
                    or any(diff[2:])):
                self._fail(f"corrupted byte shares per row {diff}, want "
                           f"{want:.5f} +/- {tol:.2e} for rows 0-1 and 0 "
                           "elsewhere")
            self.out["corrupt_byte_share"] = diff
            del self.honest
        elif self.label == "ef_topk":
            idx = payload["indices"]
            if idx.dtype != torch.int32 or idx.shape[1] != TOPK_K:
                self._fail(f"indices {idx.dtype} {tuple(idx.shape)}, want "
                           f"int32 (n, {TOPK_K})")
            for c in range(idx.shape[0]):
                srt = torch.sort(idx[c].long()).values
                if not (bool(torch.all(srt[1:] > srt[:-1]))
                        and int(srt[0]) >= 0 and int(srt[-1]) < d):
                    self._fail(f"client {c}'s indices are not unique in "
                               f"[0, {d})")
            self.out["indices_per_client"] = int(idx.shape[1])
        elif self.label == "topk_coord_stream" and acc is not None:
            if acc.dtype != torch.float32 or tuple(acc.shape) != (2, d):
                self._fail(f"carry {acc.dtype} {tuple(acc.shape)}")
        elif acc is not None and acc.dtype != torch.int32:
            self._fail(f"carry {acc.dtype}, want the int32 vote pair")

    def on_decode(self, enc_sum, out):
        if self.label == "topk_coord_stream":
            cnt = enc_sum[1]
            if (enc_sum.dtype != torch.float32 or enc_sum.shape[0] != 2
                    or float(cnt.min()) < 0
                    or float(cnt.max()) > self.clients
                    or not bool(torch.all(cnt == torch.round(cnt)))):
                self._fail("count row not an integer in [0, clients]")
            self.out["count_row_max"] = float(cnt.max())
            return
        if self.label in ("ef_topk", "qsgd"):
            return
        if enc_sum.dtype != torch.int32 or enc_sum.shape[0] != 2:
            self._fail(f"aggregate {enc_sum.dtype} {tuple(enc_sum.shape)} "
                       "is not the int32 vote pair")
        if not bool(torch.all(enc_sum[1] == self.clients)):
            self._fail("n_live row is not the cohort size everywhere")
        if self.label == "vote":
            if not torch.equal(enc_sum, self.pending_plain):
                self._fail("R1's vote pair differs from the popcount route")
            del self.pending_plain
            g = out[:QWEN2_COORDS]
            if not bool(torch.all((g == 0) | (g == 1) | (g == -1))):
                self._fail("the decoded update leaves {-1, 0, +1}")
            self.out.update({"pair_equals_popcount_route": True,
                             "decoded_zero_share": float((g == 0).float()
                                                         .mean())})
        self.digest = _digest(enc_sum.reshape(-1).view(torch.int32))


def _norms64(x2d, d: int):
    return torch.stack([_norm64(x2d[c, :d]) for c in range(x2d.shape[0])])


def _norm64(row, chunk=1 << 26):
    acc = torch.zeros((), dtype=torch.float64, device=row.device)
    for lo in range(0, row.numel(), chunk):
        acc += torch.sum(row[lo:lo + chunk].double() ** 2)
    return torch.sqrt(acc)


def _digest(row, chunk=1 << 26):
    """(sum, position-weighted sum) of a row's bit pattern (int32 for 4-byte
    elements, int16 for bf16), int64 arithmetic mod 2^64."""
    iv = {2: torch.int16, 4: torch.int32}[row.element_size()]
    row = row.reshape(-1)
    a = b = 0
    for lo in range(0, row.numel(), chunk):
        x = row[lo:lo + chunk].to(DEV, non_blocking=True)
        x = x.view(iv).to(torch.int64)
        pos = torch.arange(lo + 1, lo + 1 + x.numel(), device=DEV,
                           dtype=torch.int64) * 2654435761
        a += int(x.sum())
        b += int((x * pos).sum())
    return a, b


def _round0_record(after):
    """A first round's outcome: the params and the server state on the
    host (bit patterns compared later) and, per client-state row of every
    slot, a digest of its int32 pattern."""
    from repro_torch.core.tree import tree_paths
    rec = {"params": {p: v.detach().to("cpu", copy=True) for p, v in
                      tree_paths(after.params)}, "rows": None,
           "server": None}
    if after.comp_state is not None:
        rec["rows"] = {k: [_digest(r) for r in v.reshape(-1, v.shape[-1])]
                       for k, v in after.comp_state.items()}
    if after.comp_server is not None:
        # a copy: the next round updates the server state in place
        rec["server"] = {k: v.detach().to("cpu", copy=True)
                         for k, v in after.comp_server.items()}
    return rec


def _state_nonzero(after) -> bool:
    """Every client-state row of every slot, and every server-state
    buffer, holds a non-zero entry."""
    ok = True
    for v in (after.comp_state or {}).values():
        rows = v.reshape(-1, v.shape[-1])
        ok &= all(bool(torch.any(rows[r].to(DEV) != 0))
                  for r in range(rows.shape[0]))
    for v in (after.comp_server or {}).values():
        ok &= bool(torch.any(v != 0))
    return ok


def _same_record(x, y) -> bool:
    if (x["params"].keys() != y["params"].keys() or x["rows"] != y["rows"]
            or x.get("enc_sum") != y.get("enc_sum")
            or (x["server"] is None) != (y["server"] is None)):
        return False
    for k, a in (x["server"] or {}).items():
        if not _same_bits(a, y["server"][k]):
            return False
    return all(_same_bits(a, y["params"][k])
               for k, a in x["params"].items())


def _async_plan(args):
    """What the port's ``partition_round`` says an async run does, round by
    round: the participation (on-time mask weights plus the stale weights
    that arrive, added in f32 as the driver adds them) and the payload rows
    still queued after the round."""
    import numpy as np
    from repro_torch.core.context import RoundModePolicy
    from repro_torch.fed.async_server import parse_latency, partition_round
    total = args.clients * args.groups
    pol = RoundModePolicy.parse(args.round_mode)
    lat = parse_latency(args.latency)
    queue, part, queued = {}, [], []
    for r in range(args.rounds):
        on_time, s, w, _ = partition_round(pol, lat.sample(r, total),
                                           np.ones(total, bool))
        for c in np.nonzero((w > 0.0) & ~on_time)[0]:
            queue.setdefault(r + int(s[c]), []).append((r, int(c),
                                                        float(w[c])))
        stale = 0.0
        for *_, wc in sorted(queue.pop(r, [])):
            stale += wc
        eff = on_time.astype(np.float32)
        eff[0] += np.float32(stale)
        part.append(float(np.sum(eff, dtype=np.float32)))
        queued.append(sum(len(v) for v in queue.values()))
    return part, queued


#: the async paths' participation in closed form, rounds 0-2
ASYNC_CLOSED_FORM = {
    "async_zsign": [5.0, 9.0, 13.0],
    "async_ef_poly": [5.0, 5.0 + 4 * 2 ** -0.5,
                      5.0 + 4 * 2 ** -0.5 + 4 * 3 ** -0.5]}


def _async_checks(label, args, per, queue_rows):
    """Participation against the partition (and its closed form) to 1e-6
    relative, and the host queue's bytes after each round."""
    want, queued = _async_plan(args)
    closed = ASYNC_CLOSED_FORM[label]
    # a zsign payload row (the tile-padded bytes), plus the f32 EF scale
    row_bytes = -(-QWEN2_COORDS // 8192) * 1024 + (
        4 if (args.pipeline or "").startswith("ef|") else 0)
    got = [r["part"] for r in per]
    for g, w, c in zip(got, want, closed):
        if abs(g - w) > 1e-6 * w or abs(w - c) > 1e-6 * c:
            raise AssertionError(f"{label}: participation {got}, partition "
                                 f"{want}, closed form {closed}")
    want_bytes = [q * row_bytes for q in queued]
    if queue_rows != want_bytes:
        raise AssertionError(f"{label}: host queue bytes {queue_rows} != "
                             f"{want_bytes} ({queued} rows of {row_bytes})")
    return {"participation": got, "participation_partition": want,
            "host_queue_bytes": queue_rows, "host_queue_rows": queued}


def phase_path(label, flags, per_round=None, rounds=None,
               common=COMMON_ARGS, coords=QWEN2_COORDS, keep_final=False):
    """Drive one full-width path through ``train.run`` with every launch
    counter at 0 just before and read just after. -> its summary, with the
    record of its first round (and, with ``keep_final``, the last round's
    state). A list in ``per_round`` gives each round's launches (the
    counters are read after every round). ``common`` and ``coords`` are the
    model's flags and its wire coordinates (qwen2-0.5B unless given)."""
    from repro_torch.core import compression, wire
    from repro_torch.core.tree import tree_leaves
    from repro_torch.fed.async_server import queue_bytes
    from repro_torch.kernels.zsign import ops
    from repro_torch.launch import train
    rounds = PATH_ROUNDS.get(label, ROUNDS) if rounds is None else rounds
    args = train.parse_args(common + flags + ["--rounds", str(rounds)])
    total = args.clients * args.groups
    bits_per_coord = PATH_BITS.get(label, 1)
    per, state_ok, first, steps, queue = [], [], {}, [], []
    is_async = args.round_mode != "sync"

    def on_round(t, before, after, m, sec):
        if keep_final and t == args.rounds - 1:
            first["final"] = after
        if t == 0:
            first["record"] = _round0_record(after)
            first["metrics"] = (float(m.loss), float(m.participation),
                                float(m.uplink_bits), int(m.shard_clients))
            if after.comp_state is not None or after.comp_server is not None:
                state_ok.append(_state_nonzero(after))
        if is_async:
            queue.append(queue_bytes(steps[0].pending))
        per.append({"sec": sec, "loss": float(m.loss),
                    "bits": float(m.uplink_bits),
                    "part": float(m.participation),
                    "counts": _counts(),
                    "shard": int(m.shard_clients),
                    "n_coords": wire.tree_spec(after.params).n_coords,
                    "sigma": float(after.sigma),
                    # some leaf moved (top-k may leave any given slice)
                    "changed": any(not torch.equal(a, b) for a, b in zip(
                        tree_leaves(before.params),
                        tree_leaves(after.params)))})

    probe = _E1Probe(ops, QWEN2_COORDS) if label in PROBED else None
    clip = _ClipProbe(compression.dplib) if label == "dp_zsign" else None
    wprobe = _WireProbe(label, total) if label in WIRE_PROBED else None
    fold = _StaleFoldProbe(ops) if label == "async_zsign" else None
    plain = _PlainCheckProbe(ops) if label in PLAIN_CHECKED else None
    _free()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    if probe is not None:
        compression.K = probe
    if fold is not None:
        compression.K = fold
    if plain is not None:
        compression.K = plain
    if clip is not None:
        compression.dplib = clip
    if wprobe is not None:
        wprobe.install(compression)
    try:
        # the async step's late-payload queue, read after each round
        history = train.run(args, on_round=on_round, on_build=steps.append)
        torch.cuda.synchronize()
    finally:
        compression.K = ops
        if clip is not None:
            compression.dplib = clip._dp
        if wprobe is not None:
            wprobe.uninstall()
    launches = _counts()
    peak = torch.cuda.max_memory_allocated()
    if len(history) != args.rounds or len(per) != args.rounds:
        raise AssertionError(f"{label}: train.run did not run every round")
    for r in per:
        if not math.isfinite(r["loss"]):
            raise AssertionError(f"{label}: non-finite loss {r['loss']}")
        if r["n_coords"] != coords:
            raise AssertionError(f"d = {r['n_coords']} != {coords}")
        # every client live (the async paths with latency: the folded
        # weight, checked below); the engine's f32 product n_live * (d *
        # bits)
        if label not in ASYNC_CLOSED_FORM and r["part"] != float(total):
            raise AssertionError(f"{label}: participation {r['part']} != "
                                 f"{total}")
        want_bits = float(torch.tensor(r["part"], device=DEV)
                          * float(coords * bits_per_coord))
        if r["bits"] != want_bits:
            raise AssertionError(f"{label}: uplink bits {r['bits']} != "
                                 f"{bits_per_coord} * {r['part']} * "
                                 f"{coords}")
        if label in PATH_SHARD and r["shard"] != PATH_SHARD[label]:
            raise AssertionError(f"{label}: {r['shard']} clients a shard, "
                                 f"want {PATH_SHARD[label]}")
    if not all(r["changed"] for r in per):
        raise AssertionError(f"{label}: params did not change in a round")
    if state_ok and not state_ok[0]:
        raise AssertionError(f"{label}: a client-state row or the server "
                             "state is zero after round 1")
    by_round = {name: [r["counts"][name] - (per[t - 1]["counts"][name]
                                            if t else 0)
                       for t, r in enumerate(per)] for name in launches}
    for name, k in (per_round or {}).items():
        want = k if isinstance(k, list) else [k] * args.rounds
        if by_round[name] != want:
            raise AssertionError(
                f"{label}: {name} launched {by_round[name]} times in its "
                f"{args.rounds} rounds (want {want})")
    extra = _probe_checks(label, probe, args, per, clip) if probe else {}
    if label in ASYNC_CLOSED_FORM:
        extra.update(_async_checks(label, args, per, queue))
        extra["launches_by_round"] = by_round
    elif any(queue):
        raise AssertionError(f"{label}: zero latency queued {queue} bytes")
    if plain is not None:
        if set(plain.seen) != {"zsign_encode", "sign_reduce"}:
            raise AssertionError(f"{label}: E1/R1 not held against their "
                                 f"plain versions ({sorted(plain.seen)})")
        extra["kernels_vs_plain_round0"] = plain.seen
    if fold is not None:
        if fold.seen is None:
            raise AssertionError(f"{label}: no one-row stale fold ran")
        extra["stale_fold_vs_plain"] = fold.seen
    if label == "async_ef_poly" and not all(by_round["sign_reduce_fold"]):
        raise AssertionError(f"{label}: R1 fold mode launched "
                             f"{by_round['sign_reduce_fold']} a round")
    if wprobe is not None:
        if wprobe.first:
            raise AssertionError(f"{label}: the wire probe saw no decode")
        extra.update(wprobe.out)
        first["record"]["enc_sum"] = wprobe.digest
    secs = [r["sec"] for r in per]
    print(json.dumps({"path": label, "flags": flags, "clients": total,
                      "groups": args.groups, "cohort": args.cohort,
                      "shard_clients": per[0]["shard"],
                      "local_steps": args.local_steps,
                      "rounds": args.rounds, "round_s": secs,
                      "loss": [r["loss"] for r in per],
                      "peak_mem_GB": peak / 1e9,
                      "launches": launches,
                      "state_nonzero_after_round_1":
                          state_ok[0] if state_ok else None, **extra}))
    out = {"launches": launches, "secs": secs, "peak": peak,
           "record": first["record"], "metrics": first["metrics"],
           "checks": extra, "final": first.get("final")}
    del per, history, first, probe, clip, plain
    _free()
    return out


def _probe_checks(label, probe, args, per, clip=None):
    """What the E1 probe saw on a path: sto-sign's per-client sigma
    vector, DP's calibrated sigma and clipped rows (against their norms
    before the clip, from the clip probe), the Plateau route's state
    sigma."""
    from repro_torch.core import dp, noise
    calls = probe.calls
    if len(calls) != args.rounds:
        raise AssertionError(f"{label}: E1 called {len(calls)} times")
    c0 = calls[0]
    out = {"e1_sigma_round1": c0["sigma"].tolist()}
    if label == "stosign":
        rel = float(torch.max(torch.abs(c0["sigma"].double() - c0["norms64"])
                              / c0["norms64"]))
        if (any(c["z"] != noise.Z_INF for c in calls) or rel > 1e-6
                or len(set(c0["sigma"].tolist())) != args.clients):
            raise AssertionError(
                f"stosign: E1's sigma vector {c0['sigma'].tolist()} is not "
                f"the rows' f64 norms {c0['norms64'].tolist()} (max rel "
                f"{rel} > 1e-6) or its entries are not distinct")
        out.update({"sigma_vs_f64_norms_max_rel": rel})
    elif label == "dp_zsign":
        want = dp.calibrate_noise(hi=200.0, **DP_ACCOUNT) * DP_CLIP
        sig = torch.full_like(c0["sigma"], want)
        if any(c["z"] != 1 or not _same_bits(c["sigma"], sig)
               for c in calls):
            raise AssertionError(
                f"dp_zsign: E1 sigma {c0['sigma'].tolist()} != {want}")
        before, after = clip.before64.tolist(), c0["norms64"].tolist()
        for b, a in zip(before, after):
            ok = (abs(a - DP_CLIP) <= DP_CLIP * 1e-6 if b > DP_CLIP
                  else a == b)
            if not ok:
                raise AssertionError(
                    f"dp_zsign: row norms {before} before the clip reach "
                    f"E1 as {after}, not at {DP_CLIP} +/- 1e-6 (or "
                    "unchanged where they were under it)")
        out.update({"calibrated_sigma": want,
                    "row_norms_before_clip": before,
                    "clipped_row_norms": after})
    elif label == "plateau":
        for t, c in enumerate(calls):
            want = torch.full_like(c["sigma"], per[t - 1]["sigma"]
                                   if t else args.sigma)
            if c["z"] != 1 or not _same_bits(c["sigma"], want):
                raise AssertionError(f"plateau: E1 sigma in round {t} is "
                                     f"{c['sigma'].tolist()}")
        out["state_sigma"] = [r["sigma"] for r in per]
    return out


def phase_identities(results):
    """The plan identities: each group of runs must give one first round
    (identity g also its loss, participation, uplink bits and shard size).
    A run that a later identity names is kept until then."""
    reused = {label for _, runs in IDENTITIES for label, flags, _ in runs
              if flags is None}
    kept = {}
    for name, runs in IDENTITIES:
        recs = []
        for label, flags, per_round in runs:
            if flags is None:
                out = results[label] if label in results else kept[label]
            else:
                out = phase_path(label, flags, per_round, rounds=1)
                if label in reused:
                    kept[label] = out
            recs.append((label, {**out["record"],
                                 "metrics": out["metrics"]}))
            del out
        base_label, base = recs[0]
        for label, rec in recs[1:]:
            if not _same_record(base, rec) or (
                    name == "g" and rec["metrics"] != base["metrics"]):
                raise AssertionError(f"plan identity ({name}): {label} "
                                     f"differs from {base_label}")
        print(json.dumps({"identity": name,
                          "runs": [label for label, _ in recs],
                          "state_rows_compared": {
                              k: len(v) for k, v in (base["rows"] or {})
                              .items()},
                          "server_state_compared": sorted(
                              base["server"] or {}),
                          "vote_pair_compared": base.get("enc_sum")
                          is not None,
                          "metrics_compared": name == "g",
                          "equal": True}))
        del recs, base
        _free()


def phase_mlp(dev):
    """One round of the paper's non-iid MLP task (10 clients, one label
    each, dim 64, width 64) under zsign(z=1,sigma=0.05) on the card: E1 and
    R1 launched once each, E1's payload bytes equal to its plain version on
    the same buffer and keys, R1's sum equal to its plain version (int32
    patterns), a finite loss and moved params."""
    from repro_torch.core import compression, fedavg, noise
    from repro_torch.data import synthetic
    from repro_torch.kernels.zsign import ops
    from repro_torch.models.mlp import mlp_loss_builder
    n, sigma = 10, 0.05
    seen = {}

    class Recording(compression.Pipeline):
        def encode_batch(self, keys, flat2d, *a, **kw):
            seen.update(keys=keys.clone(), rows=flat2d.clone())
            payload, state = super().encode_batch(keys, flat2d, *a, **kw)
            seen["payload"] = payload
            return payload, state

        def decode_sum(self, enc_sum, n_live, sigma=None, spec=None):
            seen["enc_sum"] = enc_sum.clone()
            return super().decode_sum(enc_sum, n_live, sigma=sigma,
                                      spec=spec)

    x, y = synthetic.gaussian_mixture_task(n_classes=10, dim=64,
                                           n_per_class=200)
    parts = synthetic.label_partition(y, n)
    init, loss_fn, acc_fn = mlp_loss_builder(64, 10)
    comp = Recording(f"zsign(z=1,sigma={sigma})")
    cfg = fedavg.FedConfig(n_clients=n, client_lr=0.05, server_lr=0.5)
    step = fedavg.build_round_step(loss_fn, comp, cfg, fedavg.RoundContext(
        weights_are_mask=True))
    state = fedavg.init_server_state(
        init(torch.Generator().manual_seed(0), dev), cfg, comp,
        noise.prng_key(1))
    batch = synthetic.client_batches(x, y, parts, (1, n, 1, 32), seed=1,
                                     round_idx=0, device=dev)
    mask = torch.ones((1, n))
    _reset_counts()
    t0 = time.time()
    after, m = step(state, batch, mask)
    loss = float(m.loss)
    sec = time.time() - t0
    launches = _counts()
    if launches["zsign_encode"] != 1 or launches["sign_reduce"] != 1:
        raise AssertionError(f"mlp: launches {launches}")
    if seen["payload"].device != dev or not math.isfinite(loss):
        raise AssertionError(f"mlp: payload on {seen['payload'].device}, "
                             f"loss {loss}")
    plain = ops.zsign_encode_plain(
        seen["rows"], seen["keys"],
        torch.full((n,), sigma, dtype=torch.float32, device=dev), 1)
    if not torch.equal(seen["payload"], plain):
        raise AssertionError("mlp: E1's payload bytes differ from its "
                             "plain version")
    plain_sum = ops.sign_reduce_plain(seen["payload"],
                                      mask.reshape(-1).to(dev))
    if not _same_bits(seen["enc_sum"], plain_sum):
        raise AssertionError("mlp: R1's sum differs from its plain version")
    if all(torch.equal(a, b) for a, b in zip(state.params.values(),
                                             after.params.values())):
        raise AssertionError("mlp: params did not change")
    out = {"mlp": {"clients": n, "d_pad": seen["rows"].shape[1],
                   "n_coords": sum(v.numel() for v in state.params.values()),
                   "launches": {k: launches[k] for k in
                                ("zsign_encode", "sign_reduce")},
                   "payload_bytes_equal_plain": True,
                   "r1_sum_equal_plain": True, "loss": loss,
                   "participation": float(m.participation), "round_s": sec}}
    print(json.dumps(out))
    del seen, state, after, batch
    _free()
    return out


def phase_dynamic_sigma(dev):
    """One full-width round of 8 clients under RoundContext(dynamic_sigma=
    True) from a state whose sigma is set to 0.015, as ``launch/train.py``
    sets it after a Plateau stall, against the static zsign(z=1,
    sigma=0.015) round from the same seeds: the same payload bytes, and the
    dynamic decode is (sum / n_live) * (f32(eta_1) * f32(0.015))."""
    from repro_torch.configs.common import get_arch
    from repro_torch.core import compression, fedavg, noise
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.models.api import build_model

    seen = {}

    class Recording(compression.Pipeline):
        def encode_batch(self, *a, **kw):
            payload, state = super().encode_batch(*a, **kw)
            seen["payload"] = payload
            return payload, state

        def decode_sum(self, enc_sum, n_live, sigma=None, spec=None):
            out = super().decode_sum(enc_sum, n_live, sigma=sigma, spec=spec)
            seen.update(enc_sum=enc_sum, n_live=n_live, out=out)
            return out

    arch = get_arch("qwen2_0_5b")
    bundle = build_model(arch.model)
    params = bundle.init(torch.Generator(device=dev).manual_seed(0), dev)
    batch = {"tokens": TokenStream(vocab=arch.model.vocab).round_batch(
        0, (1, 8, 2, 2), 64, dev)}
    mask = torch.ones((1, 8))
    cfg = fedavg.FedConfig(n_clients=8, local_steps=2, client_lr=0.05,
                           server_lr=0.5)
    s = 0.015
    runs = {}
    for label, spec, dynamic in (("dynamic", "zsign(z=1,sigma=0.01)", True),
                                 ("static", f"zsign(z=1,sigma={s})", False)):
        comp = Recording(spec)
        step = fedavg.build_round_step(
            bundle.loss_fn, comp, cfg, fedavg.RoundContext(
                weights_are_mask=True, dynamic_sigma=dynamic))
        state = fedavg.init_server_state(params, cfg, comp,
                                         noise.prng_key(1), sigma0=0.01)
        if dynamic:
            state = state._replace(sigma=torch.tensor(
                s, dtype=torch.float32, device=dev))
        _free()
        _reset_counts()
        t0 = time.time()
        _, m = step(state, batch, mask)
        loss = float(m.loss)
        sec = time.time() - t0
        launches = _counts()
        if (launches["zsign_encode"], launches["sign_reduce"]) != (1, 1) \
                or not math.isfinite(loss):
            raise AssertionError(f"dynamic sigma ({label}): launches "
                                 f"{launches}, loss {loss}")
        runs[label] = dict(seen, sec=sec)
        seen.clear()
        del step, state, m
    dyn, sta = runs["dynamic"], runs["static"]
    if not torch.equal(dyn["payload"], sta["payload"]):
        raise AssertionError("dynamic sigma 0.015: payload bytes differ from "
                             "the static zsign(sigma=0.015) round")
    eta1 = noise.eta_z(1)
    f_dyn = torch.tensor(eta1, dtype=torch.float32, device=dev) * \
        torch.tensor(s, dtype=torch.float32, device=dev)
    f_sta = torch.tensor(eta1 * s, dtype=torch.float32, device=dev)
    mean = dyn["enc_sum"] / dyn["n_live"]
    if not (_same_bits(dyn["out"], mean * f_dyn)
            and _same_bits(sta["out"], (sta["enc_sum"] / sta["n_live"])
                           * f_sta)):
        raise AssertionError("dynamic sigma: the decode factor is not "
                             "f32(eta_1) * f32(0.015)")
    out = {"dynamic_sigma": s, "payload_bytes_equal": True,
           "decode_factor_dynamic": float(f_dyn),
           "decode_factor_static": float(f_sta),
           "factors_differ_in_bits": not _same_bits(f_dyn, f_sta),
           "round_s": {k: v["sec"] for k, v in runs.items()}}
    print(json.dumps(out))
    del runs, dyn, sta, params, bundle, batch, mean
    _free()
    return out


def _greedy(bundle, params, cache, tokens, steps, after_first=None):
    """``steps`` greedy decode steps from ``tokens`` (B, 1) at positions
    0.. through the bundle's decode_step; the first step is the warm-up and
    the rest are timed with CUDA events (``after_first(cache)`` is called
    between them, untimed). -> (tokens (B, steps + 1), ms per timed step,
    warm-up ms)."""
    out = [tokens]
    t0 = time.time()
    logits, cache = bundle.decode_step(params, cache, tokens, 0)
    tokens = torch.argmax(logits[:, -1:], dim=-1)
    out.append(tokens)
    torch.cuda.synchronize()
    warm_ms = (time.time() - t0) * 1e3
    if after_first is not None:
        after_first(cache)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for pos in range(1, steps):
        logits, cache = bundle.decode_step(params, cache, tokens, pos)
        tokens = torch.argmax(logits[:, -1:], dim=-1)
        out.append(tokens)
    stop.record()
    torch.cuda.synchronize()
    return torch.cat(out, dim=1), start.elapsed_time(stop) / (steps - 1), \
        warm_ms


def _serve_checks(label, seqs, cache, vocab, steps):
    """Every token in range; the cache holds non-zero K and V exactly at
    positions < steps."""
    if not bool(torch.all((seqs >= 0) & (seqs < vocab))):
        raise AssertionError(f"{label}: a decoded token is out of range")
    for name in ("k", "v"):
        nz = (cache[name] != 0).any(dim=4).any(dim=3).any(dim=1).any(dim=0)
        if not (bool(nz[:steps].all()) and not bool(nz[steps:].any())):
            raise AssertionError(f"{label}: cache {name} is not non-zero "
                                 f"exactly at positions < {steps}")


def phase_serve(dev, smi):
    """serve_qwen2: qwen2-0.5B at full width (bf16, seed-0 weights), 16
    requests of one start token, 64 greedy decode steps against
    init_cache(16, 4096), through the bundle's decode_step."""
    from repro_torch.configs.common import get_arch
    from repro_torch.models.api import build_model
    cfg = get_arch("qwen2_0_5b").model
    bundle = build_model(cfg)
    params = bundle.init(torch.Generator(device=dev).manual_seed(0), dev)
    B, steps, max_len = SERVE["batch"], SERVE["steps"], SERVE["max_len"]
    _free()
    torch.cuda.reset_peak_memory_stats()
    cache = bundle.init_cache(B, max_len, dev)
    cache_bytes = sum(v.numel() * v.element_size() for v in cache.values())
    want_bytes = cfg.n_layers * B * max_len * cfg.n_kv_heads * cfg.d_head \
        * 2 * torch.finfo(cfg.dtype).bits // 8
    if cache_bytes != want_bytes:
        raise AssertionError(f"serve: cache {cache_bytes} bytes != "
                             f"{want_bytes}")
    start = torch.randint(0, cfg.vocab, (B, 1), device=dev,
                          generator=torch.Generator(device=dev)
                          .manual_seed(1))
    seqs, ms, warm_ms = _greedy(bundle, params, cache, start, steps)
    peak = torch.cuda.max_memory_allocated()
    _serve_checks("serve_qwen2", seqs, cache, cfg.vocab, steps)
    out = {"phase": "serve_qwen2", "arch": cfg.name, "layers":
           cfg.n_layers, "batch": B, "steps": steps, "max_len": max_len,
           "ms_per_step": ms, "warmup_step_ms": warm_ms,
           "tokens_per_s": B * 1e3 / ms, "cache_bytes": cache_bytes,
           "peak_mem_GB": peak / 1e9, "sample": seqs[0, :12].tolist(),
           "card": smi}
    print(json.dumps(out))
    del cache, seqs
    _free()
    return out, params


def phase_decode_vs_forward(dev, smi, params_bf16):
    """decode_vs_forward: the serve model cast to f32, batch 2, 16
    positions: teacher-forced forward logits against 16 decode_steps, max
    |delta| < 2e-2 (the reference's bound); in bf16 the same comparison is
    printed (max |delta|, top-1 agreement), not gated."""
    import dataclasses
    from repro_torch.configs.common import get_arch
    from repro_torch.core.tree import tree_map
    from repro_torch.models import transformer as T
    from repro_torch.models.api import build_model
    S = 16
    toks = torch.randint(0, get_arch("qwen2_0_5b").model.vocab, (2, S),
                         device=dev,
                         generator=torch.Generator(device=dev).manual_seed(3))
    res = {}
    for tag, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        cfg = dataclasses.replace(get_arch("qwen2_0_5b").model, dtype=dtype)
        bundle = build_model(cfg)
        params = tree_map(lambda w: w.to(dtype), params_bf16)
        with torch.no_grad():
            full, _ = T.forward(params, toks, cfg)
        cache = bundle.init_cache(2, S, dev)
        outs = []
        for t in range(S):
            lg, cache = bundle.decode_step(params, cache, toks[:, t:t + 1], t)
            outs.append(lg[:, 0])
        dec = torch.stack(outs, dim=1)
        res[tag] = {"max_abs_delta": float((dec - full).abs().max()),
                    "top1_agree": float((dec.argmax(-1) == full.argmax(-1))
                                        .float().mean())}
        del params, full, dec, cache, outs
        _free()
    if not res["f32"]["max_abs_delta"] < 2e-2:
        raise AssertionError(f"decode_vs_forward (f32): max |delta| "
                             f"{res['f32']['max_abs_delta']} >= 2e-2")
    out = {"phase": "decode_vs_forward", "batch": 2, "positions": S,
           **res, "bound_f32": 2e-2, "card": smi}
    print(json.dumps(out))
    return out


def _moe_layer_check(dev, params, cfg, smi):
    """Layer 0's MoE of the final params, in f32 on a seeded (2, 64, 1024)
    input: the card's routing against the CPU's where the rule of the CPU
    tests holds (equal top-k where every gap of the k + 1 largest gates
    exceeds MOE_GAP; at least 90 % of tokens), the card's capacity cells
    against positions recounted in numpy from its top-k, and the card's
    output and aux against an f64 per-expert loop on the CPU that takes the
    card's top-k (max |delta| <= MOE_RTOL * max |out|; aux within MOE_RTOL
    relative)."""
    import numpy as np
    import torch.nn.functional as F
    from repro_torch.models import layers as L
    E, k = cfg.moe_experts, cfg.moe_topk
    lp = {n: v[0].to(torch.float32) for n, v in params["moe"].items()}
    gen = torch.Generator(device=dev).manual_seed(17)
    x = torch.randn((2, 64, cfg.d_model), generator=gen, device=dev)
    with torch.no_grad():
        r = L.moe_route(x, lp["router"], E, k)
        y, aux = L.moe_apply(x, lp, E, k)
        torch.cuda.synchronize()
        lp_c = {n: v.cpu() for n, v in lp.items()}
        r_cpu = L.moe_route(x.cpu(), lp_c["router"], E, k)
    gate_cpu = r_cpu.gate_all.numpy()
    top = -np.sort(-gate_cpu, axis=-1)[..., :k + 1]
    stable = np.all(-np.diff(top, axis=-1) > MOE_GAP, axis=-1)
    idx = r.idx.cpu().numpy()
    if stable.mean() < 0.9 or not np.array_equal(
            idx[stable], r_cpu.idx.numpy()[stable]):
        raise AssertionError(
            f"moe layer: card top-k differs from the CPU's on stable tokens "
            f"(stable share {stable.mean():.3f})")
    B, S = idx.shape[:2]
    C = r.capacity
    pos = np.zeros((B, S * k), np.int64)
    for b in range(B):
        count = np.zeros(E, np.int64)
        for j, e in enumerate(idx[b].reshape(-1)):
            pos[b, j], count[e] = count[e], count[e] + 1
    keep = pos < C
    flat = idx.reshape(B, S * k)
    if not (np.array_equal(r.keep.cpu().numpy(), keep)
            and np.array_equal(r.e_idx.cpu().numpy(),
                               np.where(keep, flat, E - 1))
            and np.array_equal(r.p_idx.cpu().numpy(),
                               np.where(keep, pos, C - 1))):
        raise AssertionError("moe layer: capacity cells differ from the "
                             "recount of the card's top-k")
    x64 = x.cpu().double().reshape(B * S, -1)
    w = {n: v.double() for n, v in lp_c.items()}
    ga = r.gate_all.cpu().double().reshape(B * S, E)
    it = torch.from_numpy(idx.reshape(B * S, k))
    g = torch.gather(ga, 1, it)
    g = g / g.sum(-1, keepdim=True)
    kt = torch.from_numpy(keep.reshape(B * S, k))
    ref = torch.zeros_like(x64)
    for e in range(E):
        tok, j = torch.nonzero((it == e) & kt, as_tuple=True)
        xs = x64[tok]
        ye = (F.silu(xs @ w["w1"][e]) * (xs @ w["w3"][e])) @ w["w2"][e]
        ref.index_add_(0, tok, ye * g[tok, j, None])
    delta = float((y.cpu().double().reshape(B * S, -1) - ref).abs().max())
    scale = float(ref.abs().max())
    frac = F.one_hot(it[:, 0], E).double().mean(0)
    aux_ref = float(E * torch.sum(frac * ga.mean(0)))
    res = {"phase": "moe_layer_check", "layer": 0, "shape": [B, S,
           cfg.d_model], "stable_share": float(stable.mean()),
           "kept_slots": int(keep.sum()), "slots": int(keep.size),
           "capacity": C, "max_abs_delta": delta, "max_abs_out": scale,
           "aux": float(aux), "aux_f64": aux_ref, "rtol": MOE_RTOL,
           "card": smi}
    print(json.dumps(res))
    if delta > MOE_RTOL * scale:
        raise AssertionError(f"moe layer: output max |delta| {delta} > "
                             f"{MOE_RTOL} * {scale}")
    if abs(float(aux) - aux_ref) > MOE_RTOL * aux_ref:
        raise AssertionError(f"moe layer: aux {float(aux)} against f64 "
                             f"{aux_ref}")
    return res


def phase_moe(dev, smi):
    """moe_round: granite-moe-1b-a400m at full width, zsign at 4 clients
    (vmap: a (4, d_pad) f32 cohort buffer of 21.4 GB), 2 rounds through
    launch.train.run: E1 and R1 once a round and equal to their plain
    versions on round 0's buffer; then one full-width MoE layer of the
    final params held to its routing rule and a plain dispatch
    (``_moe_layer_check``), the aux of the final params on one micro-batch
    (finite; printed, not bounded) and 64 greedy decode steps of 16
    requests against init_cache(16, 512)."""
    from repro_torch.configs.common import get_arch
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.models import transformer as T
    from repro_torch.models.api import build_model
    out = phase_path("moe_round", MOE_FLAGS, E1_R1_ONCE, common=MOE_COMMON,
                     coords=MOE_COORDS, keep_final=True)
    cfg = get_arch("granite_moe_1b_a400m").model
    params = out.pop("final").params
    if params["moe"]["router"].dtype != torch.float32:
        raise AssertionError("moe_round: the router is not f32")
    toks = TokenStream(vocab=cfg.vocab).round_batch(0, (1, 1, 1, 2), 64,
                                                    dev)[0, 0, 0]
    with torch.no_grad():
        _, aux = T.forward_hidden(params, toks, cfg)
    aux = float(aux)
    if not math.isfinite(aux):
        raise AssertionError(f"moe_round: aux {aux} is not finite")
    out["layer_check"] = _moe_layer_check(dev, params, cfg, smi)
    bundle = build_model(cfg)
    B, steps, max_len = (MOE_SERVE["batch"], MOE_SERVE["steps"],
                         MOE_SERVE["max_len"])
    cache = bundle.init_cache(B, max_len, dev)
    start = toks[:1, :1].expand(B, 1).contiguous()
    seqs, ms, warm_ms = _greedy(bundle, params, cache, start, steps)
    _serve_checks("moe decode", seqs, cache, cfg.vocab, steps)
    dec = {"phase": "moe_decode", "batch": B, "steps": steps,
           "max_len": max_len, "ms_per_step": ms, "warmup_step_ms": warm_ms,
           "tokens_per_s": B * 1e3 / ms, "aux_final_params": aux,
           "aux_at_least_1": aux >= 1.0, "card": smi}
    print(json.dumps(dec))
    out["decode"] = dec
    del params, cache, seqs
    _free()
    return out


def _nbytes(tree) -> int:
    from repro_torch.core.tree import tree_leaves
    return sum(v.numel() * v.element_size() for v in tree_leaves(tree))


def _decode_vs_forward(bundle, params, toks, forward):
    """Teacher-forced ``forward(params, toks)`` logits against one decode
    step a position from a fresh cache. -> max |delta|, top-1 agreement."""
    S = toks.shape[1]
    with torch.no_grad():
        full = forward(params, toks)
    cache = bundle.init_cache(toks.shape[0], S, toks.device)
    outs = []
    for t in range(S):
        lg, cache = bundle.decode_step(params, cache, toks[:, t:t + 1], t)
        outs.append(lg[:, 0])
    dec = torch.stack(outs, dim=1)
    return (float((dec - full).abs().max()),
            float((dec.argmax(-1) == full.argmax(-1)).float().mean()))


def phase_xlstm(dev, smi):
    """xlstm_round: xlstm-350m at full width, zsign(z=1,sigma=0.05) at 2
    clients under vmap, E = 1, micro-batch 2, seq 512, 1 round
    (PATH_ROUNDS) through launch.train.run: E1 and R1 once and equal to
    their plain versions. xlstm_serve: the trained params serve 16 requests
    x 64 greedy steps; the recurrent cache has the same bytes after step 1
    and step 64 and its state moved; then the params cast to f32, batch 2,
    64 positions: the one-token recurrence against the teacher-forced
    parallel form, max |delta| < 2e-2."""
    import dataclasses
    from repro_torch.configs.common import get_arch
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.models import xlstm as X
    from repro_torch.models.api import build_model
    out = phase_path("xlstm_round", XLSTM_FLAGS, E1_R1_ONCE,
                     common=XLSTM_COMMON, coords=XLSTM_COORDS,
                     keep_final=True)
    params = out.pop("final").params
    cfg = get_arch("xlstm_350m").model
    if params["slstm"]["wr"].dtype != torch.float32:
        raise AssertionError("xlstm_round: sLSTM wr is not f32")
    bundle = build_model(cfg)
    B, steps = XLSTM_SERVE["batch"], XLSTM_SERVE["steps"]
    _free()
    torch.cuda.reset_peak_memory_stats()
    cache = bundle.init_cache(B, steps, dev)
    first = {}
    start = torch.randint(0, cfg.vocab, (B, 1), device=dev,
                          generator=torch.Generator(device=dev)
                          .manual_seed(1))
    seqs, ms, warm_ms = _greedy(
        bundle, params, cache, start, steps,
        after_first=lambda c: first.update(bytes=_nbytes(c)))
    peak = torch.cuda.max_memory_allocated()
    if not bool(torch.all((seqs >= 0) & (seqs < cfg.vocab))):
        raise AssertionError("xlstm_serve: a decoded token is out of range")
    if first["bytes"] != _nbytes(cache):
        raise AssertionError("xlstm_serve: the recurrent cache grew")
    if not all(bool(torch.isfinite(v).all()) for v in tree_leaves(cache)) \
            or not bool((cache["m"]["C"] != 0).any()) \
            or not bool((cache["s"]["h"] != 0).any()):
        raise AssertionError("xlstm_serve: the recurrent state did not move "
                             "or is not finite")
    S = XLSTM_SERVE["dvf_positions"]
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    p32 = tree_map(lambda w: w.to(torch.float32), params)
    toks = torch.randint(0, cfg.vocab, (2, S), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(3))
    delta, top1 = _decode_vs_forward(build_model(cfg32), p32, toks,
                                     lambda p, t: X.forward(p, t, cfg32))
    res = {"phase": "xlstm_serve", "arch": cfg.name, "batch": B,
           "steps": steps, "ms_per_step": ms, "warmup_step_ms": warm_ms,
           "tokens_per_s": B * 1e3 / ms, "cache_bytes_step1": first["bytes"],
           f"cache_bytes_step{steps}": _nbytes(cache),
           "peak_mem_GB": peak / 1e9,
           "sample": seqs[0, :12].tolist(),
           "decode_vs_forward_f32": {"batch": 2, "positions": S,
                                     "max_abs_delta": delta,
                                     "top1_agree": top1, "bound": 2e-2},
           "card": smi}
    print(json.dumps(res))
    if not delta < 2e-2:
        raise AssertionError(f"xlstm decode_vs_forward (f32): max |delta| "
                             f"{delta} >= 2e-2")
    out["serve"] = res
    del params, p32, cache, seqs
    _free()
    return out


def phase_encdec(dev, smi):
    """encdec_round: seamless-m4t-large-v2 at full width, zsign at 4 clients
    under vmap, E = 2, micro-batch 2, seq 64 (32 source frames + 32
    tokens), 2 rounds: E1 and R1 once a round and equal to their plain
    versions on round 0 (a (4, d_pad) f32 buffer of 28.4 GB).
    encdec_serve: prefill_cache over 16 requests of 2048 seeded f32 frames
    (the bundle's src_len: the cross-attention is unmasked), then 64 greedy
    steps."""
    from repro_torch.configs.common import get_arch
    from repro_torch.models import encdec as E
    from repro_torch.models.api import build_model
    out = phase_path("encdec_round", ZSIGN + ["--clients", "4", "--cohort",
                                              "vmap"], E1_R1_ONCE,
                     common=ENCDEC_COMMON, coords=ENCDEC_COORDS,
                     keep_final=True)
    params = out.pop("final").params
    cfg = get_arch("seamless_m4t_large_v2").model
    bundle = build_model(cfg)
    B, steps, max_len = (ENCDEC_SERVE["batch"], ENCDEC_SERVE["steps"],
                         ENCDEC_SERVE["max_len"])
    _free()
    torch.cuda.reset_peak_memory_stats()
    cache = bundle.init_cache(B, max_len, dev)
    src_len = cache["mem_k"].shape[2]
    frames = torch.randn((B, src_len, cfg.d_model), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(5))
    prefill_ms = []
    for _ in range(2):          # the first call warms up
        t0 = time.time()
        E.prefill_cache(params, cache, frames, cfg)
        torch.cuda.synchronize()
        prefill_ms.append((time.time() - t0) * 1e3)
    if not bool((cache["mem_k"] != 0).any(dim=4).any(dim=3).all()):
        raise AssertionError("encdec_serve: a memory slot stayed zero")
    start = torch.randint(0, cfg.vocab, (B, 1), device=dev,
                          generator=torch.Generator(device=dev)
                          .manual_seed(1))
    seqs, ms, warm_ms = _greedy(bundle, params, cache, start, steps)
    peak = torch.cuda.max_memory_allocated()
    _serve_checks("encdec_serve", seqs, cache, cfg.vocab, steps)
    res = {"phase": "encdec_serve", "arch": cfg.name, "batch": B,
           "src_len": src_len, "steps": steps, "max_len": max_len,
           "prefill_ms": prefill_ms[1], "prefill_warmup_ms": prefill_ms[0],
           "ms_per_step": ms, "warmup_step_ms": warm_ms,
           "tokens_per_s": B * 1e3 / ms, "cache_bytes": _nbytes(cache),
           "peak_mem_GB": peak / 1e9, "sample": seqs[0, :12].tolist(),
           "card": smi}
    print(json.dumps(res))
    out["serve"] = res
    del params, cache, frames, seqs
    _free()
    return out


def phase_mamba_jamba_width(dev, smi):
    """mamba_jamba_width: one mamba sublayer at Jamba's full width (d_model
    8192, d_inner 16384, dt_rank 512, f32 weights of 1.68 GB, seed 0): B = 2,
    T = 512 (two scan chunks) through mamba_block and through 512 calls of
    mamba_decode_step from the zero cache; max |delta| <= MAMBA_REL * max
    |out|. Both timed after a warm-up call (CUDA events)."""
    from repro_torch.models import mamba as M
    D, B, T = (JAMBA_MAMBA["d_model"], JAMBA_MAMBA["batch"],
               JAMBA_MAMBA["seq"])
    _free()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(0)
    lp = {k: v[0] for k, v in M.mamba_init(gen, D, 1, torch.float32,
                                           dev).items()}
    n_w = sum(v.numel() for v in lp.values())
    x = torch.randn((B, T, D), generator=gen, device=dev)

    def recurrence():
        c = M.mamba_cache_init(B, D, 1, dev)
        h, conv, ys = c["h"][0], c["conv"][0], []
        for t in range(T):
            y, h, conv = M.mamba_decode_step(x[:, t:t + 1], lp, h, conv,
                                             d_model=D)
            ys.append(y)
        return torch.cat(ys, dim=1)

    with torch.no_grad():
        block = M.mamba_block(x, lp, d_model=D)
        block_ms = _time_ms(lambda: M.mamba_block(x, lp, d_model=D), 1, 0)
        rec = recurrence()
        rec_ms = _time_ms(recurrence, 1, 0)
    peak = torch.cuda.max_memory_allocated()
    delta = float((rec - block).abs().max())
    scale = float(block.abs().max())
    res = {"phase": "mamba_jamba_width", "d_model": D, "d_inner": 2 * D,
           "dt_rank": D // 16, "weights": n_w, "weight_bytes": n_w * 4,
           "batch": B, "seq": T, "block_ms": block_ms,
           "recurrence_ms": rec_ms, "recurrence_ms_per_step": rec_ms / T,
           "max_abs_delta": delta, "max_abs_out": scale,
           "rel": delta / scale, "bound_rel": MAMBA_REL,
           "finite": bool(torch.isfinite(block).all()),
           "peak_mem_GB": peak / 1e9, "card": smi}
    print(json.dumps(res))
    if not (res["finite"] and delta <= MAMBA_REL * scale):
        raise AssertionError(f"mamba_jamba_width: block vs recurrence max "
                             f"|delta| {delta} > {MAMBA_REL} * {scale}")
    del lp, x, block, rec
    _free()
    return res


def phase_remat_qwen2_4k(dev, smi):
    """remat_qwen2_4k: qwen2-0.5B at full width (bf16), one client,
    micro-batch 1, seq 4,096 (the train_4k cell's length), one local SGD
    step through ``build_round_step`` on the dense f32 wire (the identity
    codec: every bit of the gradient reaches the params), from seed-0
    weights and TokenStream tokens: at full depth (24 layers, d =
    494,032,768) with every layer and cross-entropy chunk rematerialized
    (its ``remat`` default; without remat the round does not fit the
    card's 80 GB: REMAT_4K), then at REMAT_4K's cut depth once with remat
    and once without. Then REMAT_ZSIGN: the zsign path's rounds without
    remat, with, with and without, from the same seed-0 weights, tokens
    and noise key. Gates: the cut depth's two runs' params bit-identical
    and their losses equal; the zsign runs' params and losses bit-identical
    every round. Each run's round seconds (host clock, synchronized) and
    ``max_memory_allocated``."""
    import dataclasses
    from repro_torch.configs.common import get_arch
    from repro_torch.core import compression, fedavg, noise
    from repro_torch.core.tree import tree_leaves
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.models.api import build_model
    arch = get_arch(REMAT_4K["arch"])
    comp = compression.Compressor()
    cfg = fedavg.FedConfig(n_clients=1, local_steps=1,
                           client_lr=REMAT_4K["lr"], server_lr=1.0)
    ctx = fedavg.RoundContext(weights_are_mask=True)
    tokens = TokenStream(vocab=arch.model.vocab).round_batch(
        0, (1, 1, 1, REMAT_4K["micro"]), REMAT_4K["seq"], dev)
    mask = torch.ones((1, 1))

    def run(layers, remat):
        bundle = build_model(dataclasses.replace(arch.model,
                                                 n_layers=layers))
        _free()
        step = fedavg.build_round_step(bundle.loss_fn, comp, cfg, ctx,
                                       remat=remat)
        state = fedavg.init_server_state(
            bundle.init(torch.Generator(device=dev).manual_seed(0), dev),
            cfg, comp, noise.prng_key(1))
        _free()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, m = step(state, {"tokens": tokens}, mask)
        torch.cuda.synchronize()
        out = {"layers": layers, "remat": remat,
               "round_s": time.perf_counter() - t0,
               "peak_GB": torch.cuda.max_memory_allocated() / 1e9,
               "loss": float(m.loss),
               "coords": sum(w.numel() for w in tree_leaves(state.params))}
        params = [w.cpu() for w in tree_leaves(state.params)]
        del state, step, m
        _free()
        return out, params

    full, _ = run(arch.model.n_layers, True)
    cut = REMAT_4K["cut_layers"]
    on, p_on = run(cut, True)
    off, p_off = run(cut, False)
    same = len(p_on) == len(p_off) and all(
        _same_bits(a, b) for a, b in zip(p_on, p_off))
    del p_on, p_off
    zsign, zsign_same = _remat_zsign_rounds(arch, dev)
    res = {"phase": "remat_qwen2_4k", "arch": REMAT_4K["arch"],
           "seq": REMAT_4K["seq"], "micro": REMAT_4K["micro"],
           "wire": "identity (f32)", "runs": [full, on, off],
           "params_bit_identical": same, "zsign": zsign,
           "zsign_bit_identical": zsign_same, "card": smi}
    print(json.dumps(res))
    ok = (same and zsign_same and on["loss"] == off["loss"] and
          full["coords"] == QWEN2_COORDS and
          all(math.isfinite(r["loss"]) for r in (full, on, off)))
    if not ok:
        raise AssertionError(f"remat_qwen2_4k: params bit-identical {same}, "
                             f"zsign rounds {zsign_same}, losses "
                             f"{[r['loss'] for r in (full, on, off)]}, "
                             f"{full['coords']} coordinates")
    return res


def _remat_zsign_rounds(arch, dev):
    """REMAT_ZSIGN's four runs through ``build_round_step``. -> ([each
    run's remat, round seconds, peak], whether every run's params and
    losses are the first run's bits each round)."""
    from repro_torch.core import compression, fedavg, noise
    from repro_torch.core.tree import tree_leaves
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.models.api import build_model
    z = REMAT_ZSIGN
    bundle = build_model(arch.model)
    comp = compression.ZSignCompressor(z=z["z"], sigma=z["sigma"])
    cfg = fedavg.FedConfig(n_clients=z["clients"], local_steps=1,
                           client_lr=z["lr"], server_lr=1.0)
    ctx = fedavg.RoundContext(weights_are_mask=True)
    stream = TokenStream(vocab=arch.model.vocab)
    mask = torch.ones((1, z["clients"]))
    runs, first, same = [], None, True
    for remat in (False, True, True, False):
        step = fedavg.build_round_step(bundle.loss_fn, comp, cfg, ctx,
                                       remat=remat)
        state = fedavg.init_server_state(
            bundle.init(torch.Generator(device=dev).manual_seed(0), dev),
            cfg, comp, noise.prng_key(1), sigma0=z["sigma"])
        _free()
        torch.cuda.reset_peak_memory_stats()
        secs, marks = [], []
        for t in range(z["rounds"]):
            tokens = stream.round_batch(t, (1, z["clients"], 1, z["micro"]),
                                        z["seq"], dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, {"tokens": tokens}, mask)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            marks.append((float(m.loss), [w.detach().cpu() for w in
                                          tree_leaves(state.params)]))
        runs.append({"remat": remat, "round_s": secs,
                     "peak_GB": torch.cuda.max_memory_allocated() / 1e9})
        if first is None:
            first = marks
        else:
            same = same and all(
                la == lb and all(_same_bits(a, b) for a, b in zip(pa, pb))
                for (la, pa), (lb, pb) in zip(first, marks))
        del step, state, m, marks
        _free()
    return runs, same


def phase_hybrid_reduced(dev, smi):
    """hybrid_reduced: jamba-1.5-large-398b's REDUCED config (one
    super-block: attention, 7 mamba sublayers, 4 MoE of 4 experts top-2, 4
    SwiGLU; d_model 64, f32), zsign at 4 clients under vmap, 2 rounds
    through launch.train.run (E1 + R1 once a round), then 16 greedy decode
    steps of 4 requests: attention, mamba, MoE and both caches on CUDA."""
    import numpy as np
    from repro_torch.configs.common import get_arch
    from repro_torch.core.tree import tree_leaves
    from repro_torch.models import hybrid as Hy
    from repro_torch.models.api import build_model
    cfg = get_arch("jamba_1_5_large_398b").reduced().model
    coords = sum(int(np.prod(s)) for s in tree_leaves(Hy.param_shapes(cfg)))
    out = phase_path("hybrid_reduced", ZSIGN + ["--clients", "4", "--cohort",
                                                "vmap"], E1_R1_ONCE,
                     common=HYBRID_COMMON, coords=coords, keep_final=True)
    params = out.pop("final").params
    bundle = build_model(cfg)
    B, steps, max_len = (HYBRID_DECODE["batch"], HYBRID_DECODE["steps"],
                         HYBRID_DECODE["max_len"])
    cache = bundle.init_cache(B, max_len, dev)
    start = torch.randint(0, cfg.vocab, (B, 1), device=dev,
                          generator=torch.Generator(device=dev)
                          .manual_seed(1))
    seqs, ms, warm_ms = _greedy(bundle, params, cache, start, steps)
    _serve_checks("hybrid_reduced decode", seqs, cache, cfg.vocab, steps)
    if not (bool((cache["h"] != 0).any()) and bool((cache["conv"] != 0)
                                                    .any())):
        raise AssertionError("hybrid_reduced: the mamba caches did not move")
    res = {"phase": "hybrid_reduced_decode", "reduced": True,
           "arch": cfg.name + " (reduced)", "layers": cfg.n_layers,
           "d_model": cfg.d_model, "coords": coords, "batch": B,
           "steps": steps, "ms_per_step": ms, "warmup_step_ms": warm_ms,
           "tokens_per_s": B * 1e3 / ms, "card": smi}
    print(json.dumps(res))
    out["decode"] = res
    del params, cache, seqs
    _free()
    return out


def _pinned_restore_check(dev):
    """A stream(feed=host) state (params on the card, client rows in
    pinned host memory) saved and restored: the rows come back pinned, bit
    for bit."""
    import tempfile
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.core import compression, fedavg, noise
    comp = compression.Pipeline("ef|zsign")
    cfg = fedavg.FedConfig(n_clients=4)
    params = {"x": torch.zeros(10_000, device=dev)}
    st = fedavg.init_server_state(params, cfg, comp, noise.prng_key(2),
                                  host_state=True)
    rows = st.comp_state["ef"]
    rows.copy_(torch.randn(rows.shape))
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d)
        mgr.save(1, st._asdict())
        tmpl = fedavg.init_server_state(params, cfg, comp, noise.prng_key(2),
                                        host_state=True)
        _, got = mgr.restore_latest(tmpl._asdict())
    back = got["comp_state"]["ef"]
    if not (rows.is_pinned() and back.is_pinned()
            and back.device.type == "cpu" and _same_bits(back, rows)
            and got["params"]["x"].device == dev):
        raise AssertionError("checkpoint: host-fed rows did not restore "
                             "pinned and bit-equal")
    return True


def phase_ckpt_replay(dev, smi):
    """ckpt_replay: qwen2-0.5B at full width, ef|zsign(use_kernel=true) at
    2 clients (bf16 params, 3.95 GB of f32 residuals). 2 rounds straight
    through; then 1 round under --ckpt-dir (saved at its end), the state
    dropped, and a rerun to 2 rounds that restores into a fresh template
    and runs round 2. Its params and EF residuals must equal the straight
    run's bit for bit. Prints the checkpoint's bytes and the times to save
    (to host, write, hash) and restore (hash, load)."""
    import tempfile
    from repro_torch.launch import train
    recs, events, runs = {}, [], {}
    args = COMMON_ARGS + CKPT_FLAGS

    def keep(tag, last):
        def on_round(t, before, after, m, sec):
            if t == last:
                recs[tag] = _round0_record(after)
                recs[tag + "_loss"] = float(m.loss)
        return on_round

    _free()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    train.run(train.parse_args(args + ["--rounds", "2"]),
              on_round=keep("straight", 1))
    _free()
    with tempfile.TemporaryDirectory() as d:
        ck = ["--ckpt-dir", d]
        t0 = time.time()
        train.run(train.parse_args(args + ck + ["--rounds", "1"]),
                  on_ckpt=lambda e, st: events.append((e, st)))
        runs["first_s"] = time.time() - t0
        _free()
        _reset_counts()
        t0 = time.time()
        hist = train.run(train.parse_args(args + ck + ["--rounds", "2"]),
                         on_round=keep("resumed", 1),
                         on_ckpt=lambda e, st: events.append((e, st)))
        runs["resumed_s"] = time.time() - t0
        launches = _counts()
    peak = torch.cuda.max_memory_allocated()
    if len(hist) != 1 or [e for e, _ in events] != ["save", "restore",
                                                     "save"]:
        raise AssertionError(f"ckpt_replay: {len(hist)} rounds after the "
                             f"resume, events {[e for e, _ in events]}")
    if not _same_record(recs["straight"], recs["resumed"]):
        raise AssertionError("ckpt_replay: params or EF residuals after the "
                             "restart differ from the straight run")
    want = {"ef_sign": 1, "sign_reduce": 1, "zsign_encode": 0}
    if any(launches[k] != v for k, v in want.items()):
        raise AssertionError(f"ckpt_replay: launches {launches}")
    pinned = _pinned_restore_check(dev)
    save, restore = events[0][1], events[1][1]
    out = {"phase": "ckpt_replay", "clients": 2,
           "bit_identical": True, "residual_rows_compared":
           len(recs["straight"]["rows"]["ef"]),
           "loss_round2": [recs["straight_loss"], recs["resumed_loss"]],
           "checkpoint_bytes": save["bytes"], "save_s": save,
           "restore_s": restore, "launches_resumed_round": launches,
           "peak_mem_GB": peak / 1e9, "pinned_rows_restored": pinned,
           "run_s": runs, "card": smi}
    print(json.dumps(out))
    del recs
    _free()
    return {"launches": launches, "secs": [runs["resumed_s"]], "peak": peak,
            "checks": out}


def times_encode_reduce(dev):
    """E1 and R1 at n = 8, full width; then the public op U1 on E1's
    payload stack, held against R1 with unit weights."""
    from repro_torch.core import noise
    from repro_torch.kernels.zsign import ops
    n, d = 8, QWEN2_COORDS
    d_pad = -(-d // ops.TILE) * ops.TILE
    nb = d_pad // 8
    gen = torch.Generator(device=dev).manual_seed(12)
    x = torch.zeros((n, d_pad), device=dev)
    for c in range(n):
        x[c, :d] = torch.randn((d,), generator=gen, device=dev) * 0.01
    keys = noise.client_keys(noise.prng_key(7), 0, n)
    sig = torch.full((n,), 0.01, device=dev)
    z = 1
    rows = {}
    got = ops.zsign_encode(x, keys, sig, z)
    want = ops.zsign_encode_plain(x, keys, sig, z)
    torch.cuda.synchronize()
    nflip, far = ops.erf_rule_flips(x, keys, sig, z, got, want)
    if far:
        raise AssertionError(f"E1 at full width: {far} bits outside the "
                             "erf rule")
    enc_ms = _time_ms(lambda: ops.zsign_encode(x, keys, sig, z), reps=10,
                      warmup=2)
    enc_plain_ms = _time_ms(lambda: ops.zsign_encode_plain(x, keys, sig, z),
                            reps=2)
    elems = n * d_pad
    enc_bound, enc_by = _bound(
        nbytes=elems * 4 + elems / 8 + keys.numel() * 8 + n * 4,
        ops=elems / 4 * OPS_PER_COUNTER + elems * (OPS_PER_ELEM + ERF_OPS))
    # n = 1 (the TPU kernel K1; the sequential-client route): one row of
    # the same stack
    one = (x[:1], keys[:1], sig[:1], z)
    got1 = ops.zsign_encode(*one)
    torch.cuda.synchronize()
    if not torch.equal(got1[0], got[0]):
        raise AssertionError("E1 n = 1 at full width: bytes differ from row "
                             "0 of the n = 8 launch")
    n1_ms = _time_ms(lambda: ops.zsign_encode(*one), reps=20, warmup=2)
    n1_plain_ms = _time_ms(lambda: ops.zsign_encode_plain(*one), reps=1)
    n1_bound, n1_by = _bound(
        nbytes=d_pad * 4 + d_pad / 8 + 16 + 4,
        ops=d_pad / 4 * OPS_PER_COUNTER + d_pad * (OPS_PER_ELEM + ERF_OPS))
    rows["zsign_encode"] = {
        "ms": enc_ms, "plain_ms": enc_plain_ms, "bound_ms": enc_bound,
        "bound_by": enc_by, "bits_differing": nflip,
        "max_abs_err": 1 if nflip else 0, "n1_ms": n1_ms,
        "n1_plain_ms": n1_plain_ms, "n1_bound_ms": n1_bound,
        "n1_bound_by": n1_by}
    del x, want, got1
    _free()
    packed = got
    mask = torch.ones((n,), device=dev)
    mask[3] = 0.0
    r_got = ops.sign_reduce(packed, mask)
    r_want = ops.sign_reduce_plain(packed, mask)
    torch.cuda.synchronize()
    if not _same_bits(r_got, r_want):
        raise AssertionError("R1 at full width: bits differ")
    red_ms = _time_ms(lambda: ops.sign_reduce(packed, mask), reps=10,
                      warmup=2)
    red_plain_ms = _time_ms(lambda: ops.sign_reduce_plain(packed, mask),
                            reps=2)
    red_bound, red_by = _bound(nbytes=n * nb + 8 * nb * 4 + n * 4,
                               ops=n * 8 * nb * 2)
    rows["sign_reduce"] = {
        "ms": red_ms, "plain_ms": red_plain_ms, "bound_ms": red_bound,
        "bound_by": red_by,
        "max_abs_err": float((r_got - r_want).abs().max())}
    del r_got, r_want
    _free()
    # R1 in fold mode: the 8 rows close one block into a carried sum in
    # place, with f32 weights (the streamed EF route)
    from repro_torch.core import wire
    w = torch.rand((n,), generator=gen, device=dev) + 0.5
    carry = torch.randn((8 * nb,), generator=gen, device=dev)
    acc = wire.sign_fold_init(nb, dev)
    acc.sums.copy_(carry)
    f_got = ops.sign_fold_step(packed, w, acc).sums
    f_want = ops.sign_reduce_plain(packed, w, carry, fold=True)
    torch.cuda.synchronize()
    if acc.pend_n or not _same_bits(f_got, f_want):
        raise AssertionError("R1 fold mode at full width: bits differ")
    f_err = float((f_got - f_want).abs().max())
    del f_want
    _free()
    fold_ms = _time_ms(lambda: ops.sign_fold_step(packed, w, acc), reps=10,
                       warmup=2)
    fold_plain_ms = _time_ms(lambda: ops.sign_reduce_plain(
        packed, w, carry, fold=True), reps=2)
    # the one-shot bytes plus the carry read
    fold_bound, fold_by = _bound(
        nbytes=n * nb + 8 * nb * 4 + 8 * nb * 4 + n * 4,
        ops=n * 8 * nb * 2)
    rows["sign_reduce"].update({
        "fold_ms": fold_ms, "fold_plain_ms": fold_plain_ms,
        "fold_bound_ms": fold_bound, "fold_bound_by": fold_by,
        "fold_max_abs_err": f_err})
    del acc, carry, f_got
    _free()
    # U1 through the public op, as a user calls it
    from repro_torch.kernels.zsign import zsign_decompress_sum
    _reset_counts()
    u_got = zsign_decompress_sum(packed, d)
    torch.cuda.synchronize()
    u_launches = _counts()["unpack_sum"]
    unit = ops.sign_reduce(packed, torch.ones((n,), device=dev))[:d]
    u_plain = ops.unpack_sum_plain(packed)[:d]
    torch.cuda.synchronize()
    if not (_same_bits(u_got, unit) and _same_bits(u_got, u_plain)):
        raise AssertionError("U1 at full width: differs from R1 with unit "
                             "weights or from its plain version")
    del unit
    u_ms = _time_ms(lambda: ops.unpack_sum(packed), reps=10, warmup=2)
    u_plain_ms = _time_ms(lambda: ops.unpack_sum_plain(packed), reps=2)
    u_bound, u_by = _bound(nbytes=n * nb + 8 * nb * 4,
                           ops=n * 8 * nb * 2)
    rows["unpack_sum"] = {
        "ms": u_ms, "plain_ms": u_plain_ms, "bound_ms": u_bound,
        "bound_by": u_by, "launches": u_launches,
        "max_abs_err": float((u_got - u_plain).abs().max())}
    del packed, got, u_got, u_plain
    _free()
    return rows


def times_plain_layers(dev):
    """The plain-torch layers the noise controls add, at n = 8 and full
    width, as the paths run them (one row at a time or in place), each
    beside its byte bound (inputs read once, outputs written once)."""
    from repro_torch.configs.common import get_arch
    from repro_torch.core import compression, dp, noise, wire
    from repro_torch.models.api import build_model
    n, d = 8, QWEN2_COORDS
    d_pad = -(-d // compression.ENCODE_TILE) * compression.ENCODE_TILE
    gen = torch.Generator(device=dev).manual_seed(17)
    params = build_model(get_arch("qwen2_0_5b").model).init(
        torch.Generator(device=dev).manual_seed(0), dev)
    spec = wire.tree_spec(params)
    del params
    _free()
    x = torch.zeros((n, d_pad), device=dev)
    cv = torch.empty((n, d), device=dev)
    for c in range(n):
        x[c, :d] = torch.randn((d,), generator=gen, device=dev) * 0.01
        cv[c] = torch.randn((d,), generator=gen, device=dev) * 0.001
    c_srv = torch.randn((d,), generator=gen, device=dev) * 0.001
    g = torch.randn((d_pad,), generator=gen, device=dev) * 0.01
    row = n * d * 4
    out = {}

    def put(name, ms, nbytes, ops):
        bound, by = _bound(nbytes=nbytes, ops=ops)
        out[name] = {"ms": ms, "bound_ms": bound, "bound_by": by,
                     "share_of_bound": bound / ms}

    nrm = dp.row_norms(x, d)
    put("row_norms", _time_ms(lambda: dp.row_norms(x, d), reps=5),
        row + n * 4, 2 * n * d)
    # factor 1 (max_norm far above every norm): the same traffic, x kept
    put("clip_given_norms", _time_ms(
        lambda: dp.clip_rows_(x, d, 1e30, nrms=nrm), reps=5),
        2 * row + n * 4, n * d)
    put("clip_with_norms", _time_ms(lambda: dp.clip_rows_(x, d, 1e30),
                                    reps=5), 2 * row, 3 * n * d)
    sched = compression.SigmaSchedule(head=2.0, tail=0.5)
    put("sigma_sched_scale", _time_ms(lambda: sched.scale(x, spec), reps=2),
        2 * row, n * d)
    sched.unscale(x, spec)
    sched.unscale(x, spec)
    sched.unscale(x, spec)
    cvt = compression.ControlVariate()
    state, server = {"cv": cv}, {"cv_server": c_srv}
    put("cv_correction", _time_ms(
        lambda: cvt.pre_encode(x, state, server), reps=3),
        3 * row + d * 4, 2 * n * d)
    keys = noise.client_keys(noise.prng_key(8), 0, n)
    codec = compression.SignCodec(z=1, sigma=0.01)
    packed, local = codec.encode_with_decode_batch(keys, x, d,
                                                   need_decode=True)
    put("cv_row_update", _time_ms(
        lambda: cvt.post_encode(state, x, local, range(n)), reps=3),
        2 * row + n * d / 8, 3 * n * d)
    n_live = torch.tensor(float(n), device=dev)
    put("cv_server_update", _time_ms(
        lambda: cvt.update_server(server, g, n_live, float(n)), reps=5),
        3 * d * 4, 2 * d)
    del x, cv, c_srv, g, packed, local, state, server
    _free()
    return out


def times_wire_layers(dev):
    """The plain-torch layers of the new laws and codecs at full width, as
    the paths run them, each beside its bound (inputs read once, outputs
    written once; threefry at KEY_OPS_PER_COUNTER): the vote pair on R1's
    route and on the plain popcount route (n = 8), the trimmed and the
    vote decode, the top-k selection of one row (and torch.topk alone, the
    library call inside it), the COO scatter of 8 clients' k pairs, QSGD's
    row norms (8 rows) and quantize (one row), and the adversary's
    byte_corrupt and collude on 2 of 8 packed rows."""
    from repro_torch.core import compression, dp, noise, wire
    from repro_torch.fed.adversary import parse_adversary
    n, d = 8, QWEN2_COORDS
    d_pad = -(-d // compression.ENCODE_TILE) * compression.ENCODE_TILE
    nb = d_pad // 8
    k = TOPK_K
    gen = torch.Generator(device=dev).manual_seed(18)
    out = {}

    def put(name, ms, nbytes, ops, **kw):
        bound, by = _bound(nbytes=nbytes, ops=ops)
        out[name] = {"ms": ms, "bound_ms": bound, "bound_by": by,
                     "share_of_bound": bound / ms, **kw}

    packed = torch.randint(0, 256, (n, nb), generator=gen, device=dev,
                           dtype=torch.uint8)
    mask = torch.ones((n,), device=dev)
    pair = compression.vote_pair(packed, mask, "cuda")
    plain = wire.vote_accumulator(packed, mask)
    torch.cuda.synchronize()
    if not torch.equal(pair, plain):
        raise AssertionError("vote pair: R1 route != popcount route")
    del plain
    _free()
    pair_bytes = n * nb + 2 * d_pad * 4 + n * 4
    put("vote_pair_r1_route", _time_ms(
        lambda: compression.vote_pair(packed, mask, "cuda"), reps=5),
        pair_bytes, n * 8 * nb * 2)
    put("vote_pair_popcount_route", _time_ms(
        lambda: wire.vote_accumulator(packed, mask), reps=2),
        pair_bytes, n * 8 * nb * 2)
    for law, f in (("trimmed", 2), ("vote", 0)):
        put(f"vote_decode_{law}", _time_ms(
            lambda: wire.vote_decode(pair, law, f), reps=3),
            3 * d_pad * 4, d_pad * VOTE_DECODE_OPS)
    del pair, packed
    _free()
    x = torch.zeros((n, d), device=dev)
    for c in range(n):
        x[c] = torch.randn((d,), generator=gen, device=dev) * 0.01
    # gradients of a bf16 model: bf16-rounded, ties at every magnitude
    x[0] = x[0].to(torch.bfloat16).to(torch.float32)
    score = torch.abs(x[0])
    put("topk_select_row", _time_ms(
        lambda: compression.topk_select(torch.abs(x[0]), k), reps=2),
        d * 4 + k * 8, 2 * d, library_ms=_time_ms(
            lambda: torch.topk(score, k, sorted=False), reps=2))
    del score
    _free()
    codec = compression.TopKCodec(frac=0.01)
    payload, _ = codec.encode_with_decode_batch(None, x, d)
    put("coo_scatter_8_clients", _time_ms(
        lambda: wire.scatter_sum_coo(payload["values"], payload["indices"],
                                     mask, d), reps=3),
        n * k * 8 + n * 4 + d * 4, 2 * n * k,
        library_ms=_time_ms(lambda: torch.zeros(
            (d,), device=dev).index_add_(
                0, payload["indices"].reshape(-1).long(),
                (payload["values"] * mask[:, None]).reshape(-1)), reps=3))
    del payload
    _free()
    put("qsgd_row_norms_8", _time_ms(lambda: dp.row_norms(x, d), reps=3),
        n * d * 4 + n * 4, 2 * n * d)
    qcodec = compression.QSGDCodec(s=1)
    key = noise.client_keys(noise.prng_key(10), 0, 1)[0]
    nrm = dp.row_norms(x[1:2], d)[0] + 1e-12
    put("qsgd_quantize_row", _time_ms(
        lambda: qcodec._quantize_row(key, x[1], nrm), reps=2),
        2 * d * 4, d * (KEY_OPS_PER_COUNTER + QSGD_OPS_PER_ELEM))
    del x
    _free()
    packed = torch.randint(0, 256, (n, nb), generator=gen, device=dev,
                           dtype=torch.uint8)
    idx = torch.arange(n)
    # byte_corrupt: two draws (hit, byte) per byte of 2 rows, read and
    # written; collude: one pattern draw, written over 2 rows
    for spec, counters, nbytes in (("byte_corrupt(f=2,p=0.1)", 4 * nb,
                                    4 * nb),
                                   ("collude(f=2)", nb, 2 * nb)):
        adv = parse_adversary(spec).bind(n)
        put(spec.split("(")[0], _time_ms(
            lambda: adv.corrupt(packed, idx, 0), reps=2),
            nbytes, counters * KEY_OPS_PER_COUNTER)
    del packed
    _free()
    return out


def times_ef(dev):
    """F1 at n = 8, full width: the encode form (no q) checked against its
    plain version and timed, the form with q timed; and the plain-torch
    scale reduction the EF path runs before F1."""
    from repro_torch.core import compression
    from repro_torch.kernels.efsign import ops as eops
    n, d = 8, QWEN2_COORDS
    d_pad = -(-d // eops.TILE) * eops.TILE
    gen = torch.Generator(device=dev).manual_seed(14)
    g = torch.zeros((n, d_pad), device=dev)
    e = torch.empty((n, d), device=dev)
    for c in range(n):
        g[c, :d] = torch.randn((d,), generator=gen, device=dev) * 0.01
        e[c] = torch.randn((d,), generator=gen, device=dev) * 0.003
    live = torch.ones((n,), device=dev)
    live[3] = 0.0
    scale = compression._mean_abs_rows(g, d, e)
    scale_ms = _time_ms(lambda: compression._mean_abs_rows(g, d, e), reps=3)
    got = eops.ef_sign_rows(g, e, scale, live=live)
    torch.cuda.synchronize()
    want = eops.ef_sign_rows_plain(g, e, scale, live=live)
    torch.cuda.synchronize()
    if not (_same_bits(got[0], want[0]) and _same_bits(got[1], want[1])):
        raise AssertionError("F1 at full width: differs from plain")
    err = 0.0          # equal bit patterns (no (n, d) difference buffer)
    del got, want
    _free()
    # timed as the paths run it: every client live, e' over e in place
    live = torch.ones((n,), device=dev)
    ms = _time_ms(lambda: eops.ef_sign_rows(g, e, scale, live=live,
                                            in_place=True), reps=10,
                  warmup=2)
    plain_ms = _time_ms(lambda: eops.ef_sign_rows_plain(
        g, e, scale, live=live, in_place=True), reps=2)
    ms_q = _time_ms(lambda: eops.ef_sign_rows(g, e, scale, live=live,
                                              in_place=True, with_q=True),
                    reps=5, warmup=1)
    elems = n * d_pad
    # reads g and e, writes e' and the payload (and the scale, live flags)
    nbytes = elems * 4 + 2 * n * d * 4 + elems / 8 + n * 8
    bound, by = _bound(nbytes=nbytes, ops=elems * EF_OPS_PER_ELEM)
    bound_q, _ = _bound(nbytes=nbytes + n * d * 4,
                        ops=elems * EF_OPS_PER_ELEM)
    scale_bound, _ = _bound(nbytes=2 * n * d * 4 + n * 4, ops=3 * n * d)
    del g, e
    _free()
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": by, "ms_with_q": ms_q, "bound_ms_with_q": bound_q,
            "scale_reduction_ms": scale_ms,
            "scale_reduction_bound_ms": scale_bound, "max_abs_err": err}


def times_compress(dev):
    """C1 at n = 8, full width, on the z=2 noise the dense path draws."""
    from repro_torch.core import noise
    from repro_torch.kernels.zsign import ops
    n, d = 8, QWEN2_COORDS
    d_pad = -(-d // ops.TILE) * ops.TILE
    gen = torch.Generator(device=dev).manual_seed(15)
    x = torch.zeros((n, d_pad), device=dev)
    nz = torch.zeros_like(x)
    keys = noise.client_keys(noise.prng_key(9), 0, n)
    for c in range(n):
        x[c, :d] = torch.randn((d,), generator=gen, device=dev) * 0.01
        nz[c, :d] = noise.sample_z_noise(keys[c], (d,), 2, device=dev)
    sig = torch.full((n,), 0.01, device=dev)
    got = ops.zsign_compress_rows(x, nz, sig)
    want = ops.zsign_compress_rows_plain(x, nz, sig)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError("C1 at full width: bytes differ from plain")
    del got, want
    ms = _time_ms(lambda: ops.zsign_compress_rows(x, nz, sig), reps=10,
                  warmup=2)
    plain_ms = _time_ms(lambda: ops.zsign_compress_rows_plain(x, nz, sig),
                        reps=2)
    elems = n * d_pad
    bound, by = _bound(nbytes=2 * elems * 4 + elems / 8 + n * 4,
                       ops=elems * COMPRESS_OPS_PER_ELEM)
    del x, nz
    _free()
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": by, "max_abs_err": 0}


def _ulp_gap(a, b, chunk=1 << 26):
    """Largest distance of two same-dtype float tensors in units in the
    last place (their bit patterns as integers), and how many elements
    differ."""
    a, b = a.detach().reshape(-1), b.detach().reshape(-1)
    iv = {2: torch.int16, 4: torch.int32}[a.element_size()]
    gap = n = 0
    for lo in range(0, a.numel(), chunk):
        d = (a[lo:lo + chunk].view(iv).to(torch.int64)
             - b[lo:lo + chunk].view(iv).to(torch.int64)).abs()
        gap = max(gap, int(d.max()))
        n += int((d != 0).sum())
    return gap, n


def _outside_tol(got, want, chunk=1 << 26):
    """Elements of ``got`` outside rtol EF_RTOL / atol EF_ATOL of ``want``
    (compared in f32), and the largest relative gap."""
    got, want = got.detach().reshape(-1), want.detach().reshape(-1)
    n, rel = 0, 0.0
    for lo in range(0, got.numel(), chunk):
        g = got[lo:lo + chunk].float()
        w = want[lo:lo + chunk].float()
        d = (g - w).abs()
        n += int((d > EF_ATOL + EF_RTOL * w.abs()).sum())
        rel = max(rel, float((d / w.abs().clamp_min(1e-30)).max()))
    return n, rel


def _multi_run(label, flags, shard, rounds, devices, ref_path=None,
               save_ref=None):
    """One multi-device path through ``train.run``: the one-process
    stream(shard=K) plan (``devices`` 1), or this rank's part of
    stream(shard=K,devices=D). Counters and the reduce's statistics at 0
    just before, read after every round. E1, R1 and F1 are held to their
    plain versions on round 0 (``MULTI_PLAIN``). ``save_ref``: where the
    one-process run writes its decoded update and params; ``ref_path``:
    where a rank reads them to compare its own. -> a JSON-able record."""
    from repro_torch.core import compression, wire
    from repro_torch.core.tree import tree_leaves
    from repro_torch.kernels.efsign import ops as eops
    from repro_torch.kernels.zsign import ops
    from repro_torch.launch import train
    cohort = (f"stream(shard={shard})" if devices == 1 else
              f"stream(shard={shard},devices={devices})")
    args = train.parse_args(COMMON_ARGS + flags + [
        "--cohort", cohort, "--rounds", str(rounds)])
    per, keep, decoded = [], {}, []
    decode = compression.Pipeline.decode_sum

    def decode_sum(self, *a, **k):
        g = decode(self, *a, **k)
        decoded[:] = [g]
        return g

    def on_round(t, before, after, m, sec):
        per.append({"sec": sec, "loss": float(m.loss),
                    "part": float(m.participation), "counts": _counts(),
                    "params": [_digest(v) for v in tree_leaves(after.params)],
                    "reduce": dict(wire.REDUCE_STATS)})
        if t == rounds - 1:
            keep["state"] = after

    plain = _PlainCheckProbe(ops) if label in MULTI_PLAIN else None
    _free()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    wire.reset_reduce_stats()
    if plain is not None:
        compression.K = plain
        compression.EK = _EfPlainProbe(eops, plain.seen)
    compression.Pipeline.decode_sum = decode_sum
    try:
        history = train.run(args, on_round=on_round)
        torch.cuda.synchronize()
    finally:
        compression.K, compression.EK = ops, eops
        compression.Pipeline.decode_sum = decode
    if len(history) != rounds:
        raise AssertionError(f"{label}: train.run ran {len(history)} rounds")
    st = keep.pop("state")
    rec = {"devices": devices, "cohort": cohort,
           "peak_GB": torch.cuda.max_memory_allocated() / 1e9,
           "round_s": [r["sec"] for r in per],
           "loss": [r["loss"] for r in per],
           "participation": [r["part"] for r in per],
           "params": [r["params"] for r in per],
           "counts": per[-1]["counts"],
           "counts_by_round": [{k: r["counts"][k] - (per[t - 1]["counts"][k]
                                                     if t else 0)
                                for k in r["counts"]}
                               for t, r in enumerate(per)],
           "reduce_by_round": [{k: r["reduce"][k] - (per[t - 1]["reduce"][k]
                                                     if t else 0)
                                for k in r["reduce"]}
                               for t, r in enumerate(per)],
           "rows": None, "state_bytes": None, "acc_bytes": None}
    if plain is not None:
        rec["vs_plain_round0"] = plain.seen
    if st.comp_state is not None:
        rec["rows"] = {k: [_digest(r) for r in v.reshape(-1, v.shape[-1])]
                       for k, v in st.comp_state.items()}
        rec["state_bytes"] = sum(v.numel() * v.element_size()
                                 for v in st.comp_state.values())
    g = decoded[0]
    if save_ref is not None:
        torch.save({"g": g.cpu(), "params": [v.cpu() for v in
                                             tree_leaves(st.params)]},
                   save_ref)
    if ref_path is not None:
        ref = torch.load(ref_path, map_location=g.device)
        rec["update_outside_tol"], rec["update_max_rel"] = _outside_tol(
            g, ref["g"])
        rec["update_ulp"] = _ulp_gap(g, ref["g"])
        # every leaf, f32 and bf16, held to the tolerance; the ulp gap is
        # printed for information
        p_out = p_ulp = p_diff = 0
        for v, w in zip(tree_leaves(st.params), ref["params"]):
            gap, n = _ulp_gap(v, w)
            p_out += _outside_tol(v, w)[0]
            p_ulp, p_diff = max(p_ulp, gap), p_diff + n
        rec.update(params_outside_tol=p_out, params_ulp=p_ulp,
                   params_differing=p_diff)
        del ref
    del st, decoded, g
    _free()
    return rec


def _multi_setup(rank, world, store):
    """A rank of the multi-device phase, once for every path: joins the
    gloo group through a FileStore."""
    import datetime
    os.environ["LOCAL_RANK"] = str(rank)
    # two ranks share the card: cached blocks that fit no later request
    # would hold several GB a rank (before this process touches the card)
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.launch.mesh import make_cohort_group
    make_cohort_group(init_method=f"file://{store}", rank=rank,
                      world_size=world, verbose=rank == 0,
                      timeout=datetime.timedelta(seconds=MULTI_TIMEOUT_S))


def _rank_worker(rank, world, ctx, label, flags, shard, rounds, ref_path,
                 out):
    """One path on a rank of the multi-device phase (``_multi_setup``'s
    group): runs its part of the path and writes its record to
    ``out.format(rank)``."""
    import torch.distributed as dist
    rec = _multi_run(label, flags, shard, rounds, world, ref_path=ref_path)
    rec.update(rank=rank, backend=dist.get_backend(),
               device=f"cuda:{torch.cuda.current_device()}",
               reduce_alone=_reduce_alone(flags, world))
    with open(out.format(rank), "w") as f:
        json.dump(rec, f)
    dist.barrier()


def _reduce_alone(flags, world, reps=2):
    """The path's cross-rank reduce alone, ``reps`` times, each after a
    barrier: the ranks start it together, so its seconds are the transfer
    (pinned staging and gloo) and not a wait for a peer's shards. The
    accumulator is the path's (the f32 sum, or the robust laws' (2, d_pad)
    int32 pair) filled with ones, so the sum must be ``world``."""
    import torch.distributed as dist
    from repro_torch.core import wire
    from repro_torch.kernels.zsign.ops import TILE
    d_pad = -(-QWEN2_COORDS // TILE) * TILE
    pair = "agg=" in " ".join(flags)
    acc = torch.ones((2, d_pad) if pair else (d_pad,),
                     dtype=torch.int32 if pair else torch.float32,
                     device=torch.cuda.current_device())
    out = []
    for _ in range(reps):
        dist.barrier()
        torch.cuda.synchronize()
        wire.reset_reduce_stats()
        t0 = time.perf_counter()
        got = wire.reduce_accumulator(acc)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        if not bool((got == world).all()):
            raise AssertionError("the timed reduce's sum is not the world "
                                 "size")
        moved = wire.REDUCE_STATS["sent"] + wire.REDUCE_STATS["received"]
        out.append({"ms": sec * 1e3, "bytes": moved,
                    "GB_per_s": moved / sec / 1e9})
        del got
    del acc
    _free()
    return out


def phase_multi_device(dev, smi):
    """multi_device: each of MULTI_PATHS first in this process under
    stream(shard=K), then on two ranks (fresh processes, ``_RankPool``,
    spawned once for every path) running ``launch.train.run`` under
    stream(shard=K,devices=2) on the one card. Params after every round
    equal on both ranks and, for zsign and trimmed, to the one-process
    run's; EF: residual rows equal to it, the decoded f32 update and every
    param leaf within the reference's rtol 5e-5 / atol 1e-7, each rank's
    residuals 4 x d x 4 bytes. Each rank's launches a round as MULTI_PATHS
    says, its round-0 kernels held to their plain versions as MULTI_PLAIN
    says; one reduce of the accumulator and one of the loss a round, at
    most 2 x the accumulator's bytes + 8 a rank."""
    import shutil
    import tempfile
    from repro_torch.kernels.zsign.ops import TILE
    d_pad = -(-QWEN2_COORDS // TILE) * TILE
    out, tmp = {}, tempfile.mkdtemp(prefix="chip_smoke_multi_")
    ranks_pool, ok = None, False
    try:
        # the ranks start beside the first path's one-process run
        ranks_pool = _RankPool(MULTI_RANKS, _multi_setup,
                               (os.path.join(tmp, "group.store"),),
                               MULTI_TIMEOUT_S)
        for label, flags, shard, rounds, want in MULTI_PATHS:
            ref = (os.path.join(tmp, label + "_ref.pt")
                   if label == "multi_ef" else None)
            # as the ranks' records arrive: through JSON
            one = json.loads(json.dumps(_multi_run(label, flags, shard,
                                                   rounds, 1, save_ref=ref)))
            rec_path = os.path.join(tmp, label + "_rank{}.json")
            t0 = time.time()
            ranks_pool.run(_rank_worker, label, flags, shard, rounds, ref,
                           rec_path)
            ranks_s = time.time() - t0
            ranks = []
            for r in range(MULTI_RANKS):
                with open(rec_path.format(r)) as f:
                    ranks.append(json.load(f))
            if ref is not None:
                os.unlink(ref)
            out.update(_multi_checks(label, flags, rounds, want, one, ranks,
                                     d_pad, ranks_s, smi))
        ok = True
    finally:
        if ranks_pool is not None:
            ranks_pool.close(ok)
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def _plain_shapes(label, who, rec, d_pad):
    """The kernels a MULTI_PLAIN path's run held to their plain versions
    on round 0, at the shapes MULTI_PLAIN gives."""
    if label not in MULTI_PLAIN:
        return
    want = {k: [n, d_pad // 8 if k.startswith("sign_reduce") else d_pad]
            for k, n in MULTI_PLAIN[label].items()}
    got = {k: v["shape"] for k, v in rec["vs_plain_round0"].items()}
    if got != want:
        raise AssertionError(f"{label}: {who}: kernels held against their "
                             f"plain versions at {got}, want {want}")


def _multi_checks(label, flags, rounds, want, one, ranks, d_pad, ranks_s,
                  smi):
    """The checks of one multi-device path, its JSON line, and its
    summaries for the kernels line (``<label>`` the ranks' launches
    summed, ``<label>_d1`` the one-process run's)."""
    total = int(flags[flags.index("--clients") + 1])
    # the f32 sum, or the robust laws' (2, d_pad) int32 vote pair
    acc_bytes = (2 if "agg=" in " ".join(flags) else 1) * 4 * d_pad
    for rk in ranks:
        r = rk["rank"]
        if rk["backend"] != "gloo" or rk["device"] != "cuda:0":
            raise AssertionError(f"{label}: rank {r} on {rk['device']} "
                                 f"with {rk['backend']}")
        if rk["participation"] != [float(total)] * rounds:
            raise AssertionError(f"{label}: rank {r} participation "
                                 f"{rk['participation']}")
        for t, c in enumerate(rk["counts_by_round"]):
            got = {k: c[k] for k in want}
            if got != want:
                raise AssertionError(f"{label}: rank {r} round {t} "
                                     f"launched {got}, want {want}")
        for t, red in enumerate(rk["reduce_by_round"]):
            moved = red["sent"] + red["received"]
            if red["calls"] != 2 or moved > 2 * acc_bytes + 8:
                raise AssertionError(f"{label}: rank {r} round {t}: "
                                     f"{red['calls']} reduces moving {moved}"
                                     f" bytes (at most {2 * acc_bytes + 8})")
        _plain_shapes(label, f"rank {r}", rk, d_pad)
    _plain_shapes(label, "one process", one, d_pad)
    if ranks[0]["params"] != ranks[1]["params"]:
        raise AssertionError(f"{label}: params differ between the ranks")
    if ranks[0]["loss"] != ranks[1]["loss"]:
        raise AssertionError(f"{label}: losses differ between the ranks")
    checks = {"params_equal_across_ranks": True}
    if label == "multi_ef":
        if ranks[0]["rows"]["ef"] + ranks[1]["rows"]["ef"] != \
                one["rows"]["ef"]:
            raise AssertionError(f"{label}: residual rows differ from the "
                                 "one-process run")
        for rk in ranks:
            if rk["state_bytes"] != 4 * QWEN2_COORDS * 4:
                raise AssertionError(f"{label}: rank {rk['rank']} holds "
                                     f"{rk['state_bytes']} residual bytes")
            if rk["update_outside_tol"] or rk["params_outside_tol"]:
                raise AssertionError(
                    f"{label}: rank {rk['rank']}: {rk['update_outside_tol']}"
                    f" update coordinates and {rk['params_outside_tol']} "
                    f"params outside rtol {EF_RTOL} / atol {EF_ATOL} of the "
                    f"one-process run (params up to {rk['params_ulp']} ulp "
                    "from it)")
        checks.update(
            residual_rows_equal=True,
            residual_bytes_per_rank=ranks[0]["state_bytes"],
            update_max_rel=max(rk["update_max_rel"] for rk in ranks),
            update_ulp_max=max(rk["update_ulp"][0] for rk in ranks),
            update_coords_differing=ranks[0]["update_ulp"][1],
            params_ulp_max=max(rk["params_ulp"] for rk in ranks),
            params_differing=ranks[0]["params_differing"],
            params_outside_rtol_atol=ranks[0]["params_outside_tol"])
    else:
        if ranks[0]["params"] != one["params"]:
            raise AssertionError(f"{label}: params differ from the "
                                 "one-process stream run")
        checks["params_equal_to_one_process"] = True
    # time in the round's reduce calls: the wait for the peer included
    reduce = [[{"ms_in_call": red["seconds"] * 1e3,
                "bytes": red["sent"] + red["received"]}
               for red in rk["reduce_by_round"]] for rk in ranks]
    print(json.dumps({
        "multi_device": label, "flags": flags, "clients": total,
        "rounds": rounds, "ranks": MULTI_RANKS,
        "backend": ranks[0]["backend"], "card": smi,
        "round_s": {"D1": one["round_s"],
                    "D2": [rk["round_s"] for rk in ranks]},
        "reduce_per_rank": reduce, "acc_bytes": acc_bytes,
        "reduce_alone_per_rank": [rk["reduce_alone"] for rk in ranks],
        "peak_mem_GB": {"D1": one["peak_GB"],
                        "D2": [rk["peak_GB"] for rk in ranks]},
        "launches_by_round": {"D1": one["counts_by_round"],
                              "D2": [rk["counts_by_round"] for rk in ranks]},
        "kernels_vs_plain_round0": [rk.get("vs_plain_round0")
                                    for rk in ranks],
        "ranks_run_s": ranks_s, **checks}))
    summed = {k: sum(rk["counts"][k] for rk in ranks)
              for k in ranks[0]["counts"]}
    return {label: {"launches": summed,
                    "secs": [max(x) for x in zip(*(rk["round_s"]
                                                   for rk in ranks))],
                    "peak": max(rk["peak_GB"] for rk in ranks) * 1e9,
                    "vs_plain": [rk.get("vs_plain_round0") for rk in ranks]},
            label + "_d1": {"launches": one["counts"],
                            "secs": one["round_s"],
                            "peak": one["peak_GB"] * 1e9}}


# ---------------------------------------------------------------------------
# sharded_replica: the model-sharded client replica on a 2 x 2 grid of ranks
# ---------------------------------------------------------------------------

SHARD_GRID, SHARD_AXES = (2, 2), ("data", "model")
SHARD_RANKS = 4
#: the grid's sequence shards (the `model` axis): the MoE's capacity is
#: counted per shard, so the one-process rows run under
#: ``hints.seq_shard_view`` of this count
SHARD_SEQ_SHARDS = SHARD_GRID[SHARD_AXES.index("model")]
#: (label, arch, layers kept (None: all of them; "reduced": the arch's
#: reduced config), rounds, seq, global batch). shard_granite_moe's 2
#: rounds cover the regular plan's later round. A global batch of 4 is a
#: micro-batch of 2 a client step on the regular plan (2 clients side by
#: side) and on the big plans' 2 sequential groups of one, and of 4 on
#: llama4-scout's one group (cut from 4 by SHARD_GROUPS). internvl2's sequence is its 256 stub image
#: tokens and 256 text tokens. xlstm-350m runs seq 256, not 128: at random
#: init its mLSTM divides by a denominator that can pass near 0, so its
#: gradient is ill-conditioned for some token sequences (seq 128's client 0
#: moved 2.8e-2 relative L2 in one process, f32, under an exact change of
#: the key chunk; the bf16 grid lay 0.4-1.0 from the one-process row on an
#: H100 80GB HBM3 at 700 W), while seq 256 moves 1.2e-2 and its grid lies
#: within 2.0e-2. Jamba at full width does not fit one card
#: (one super-block is ~44 B parameters): its grid round runs the reduced
#: config at seq 64, and one mamba sublayer at its width runs beside it
#: (SHARD_MAMBA). seamless-m4t-large-v2 keeps 4 + 4 of its 24 + 24 layers
#: (d = 514,035,712, near qwen2's; at full depth, d = 1,772,429,312, a
#: round would take ~3.6x shard_qwen2's), seq 256: 128 frames, 128 tokens
SHARD_PATHS = [("shard_qwen2", "qwen2_0_5b", None, 1, 256, 4),
               ("shard_qwen25_32b", "qwen2_5_32b", 1, 1, 256, 4),
               ("shard_granite_moe", "granite_moe_1b_a400m", 12, 2, 256,
                4),
               ("shard_internvl2", "internvl2_1b", None, 1, 512, 4),
               ("shard_xlstm", "xlstm_350m", None, 1, 256, 4),
               ("shard_hybrid", "jamba_1_5_large_398b", "reduced", 1, 64,
                4),
               ("shard_encdec", "seamless_m4t_large_v2", 4, 1, 256, 4),
               ("shard_llama4_scout", "llama4_scout_17b_a16e", 1, 1, 256, 4)]
#: the codec's sigma where a path's differs from its arch's default (the
#: xlstm_round path's)
SHARD_SIGMA = {"xlstm_350m": 0.05}
#: the path whose ranks also run one mamba sublayer at Jamba's width,
#: channel-parallel on the big plan's grid, after its round: its shape
SHARD_MAMBA_PATH = "shard_hybrid"
SHARD_MAMBA = {"d_model": 8192, "batch": 2, "seq": 512}
#: its output rows, input gradient and each weight shard's gradient
#: against the one-process block's: relative L2, the grid's bf16 limit
#: (SHARD_PG_REL_L2): the ``x_proj`` and ``out_proj`` partials over the
#: channel slices are rounded to bf16 and summed in bf16, the weight
#: gradients' reduce-scatters too, where one process rounds one sum
SHARD_MAMBA_REL_L2 = 3e-2
#: sequential client groups kept where a path cuts its config's, as layers
#: are cut: llama4-scout's big plan has 4, each gathering the replica and
#: reduce-scattering its gradients through gloo (~25 s a group on the
#: card's host). 1 since the default remat's recompute took the script's
#: time: the big plan's loop over groups and its second E1 range a rank
#: stay covered by shard_qwen25_32b and shard_hybrid (2 groups each)
SHARD_GROUPS = {"llama4_scout_17b_a16e": 1}
#: the paths whose rank peaks are gated against one process's
SHARD_PEAK_GATED = ("shard_qwen25_32b", "shard_llama4_scout")
#: the paths whose collective bytes are gated by use (every path's by
#: kind) against the dry run's
SHARD_BY_USE_GATED = ("shard_encdec",)
#: the path whose ranks run its round 0 again under the forced stream
#: cohort of a plan without client axes (the big plan's sequential
#: groups, one a shard), from the same seed-0 weights and tokens
SHARD_STREAM_PATH = "shard_hybrid"
SHARD_STREAM_COHORT = "stream(shard=1)"
#: params at coordinates whose wire bits agree: rtol (the CPU tests')
SHARD_RTOL = 1e-5
#: the round's loss against the one-process round's: rtol (bf16 model, the
#: sequence-split sums in another order; 2.0e-5 at most measured on the
#: H100)
SHARD_LOSS_RTOL = 1e-4
#: each rank's pseudo-gradient range against the same coordinates of the
#: one-process row on round 0 (the same params in both runs): relative L2
#: error of each leaf's piece, twice the most measured on an H100 80GB HBM3
#: at 700 W (bf16 partial gradients summed by reduce-scatters: 1.48e-2 on
#: qwen2.5-32b, 1.26e-2 on granite-moe). A missing sum in a backward gives
#: 0.2-1.0 (a mutated copy, on the CPU), so this limit is the one that
#: separates it.
SHARD_PG_REL_L2 = 3e-2
#: the same for a later round, by path: only a path that runs one has a
#: limit. Its params differ from the one-process run's at the flipped
#: coordinates, the f32 router's among them, so tokens route to other
#: experts and whole expert rows of the gradient differ: 0.118-0.125 on
#: granite-moe's round 1 (the same card), limit twice that. It lies inside
#: a missing sum's range and does not separate one; round 0's limit and
#: the params check do.
SHARD_PG_REL_L2_LATER = {"shard_granite_moe": 0.25}
#: wire bits that differ from the one-process run's, over all bits sent
#: (7.0e-5 at most measured on the H100)
SHARD_FLIP_SHARE = 2e-4
#: the same share where a path's bf16 pseudo-gradients lie farther from
#: the one-process run's: xlstm-350m's 1.75e-4 (round 0's worst leaf 2.0e-2:
#: the sLSTM input's and the K/V gradients summed over the sequence ranks
#: in bf16; an H100 80GB HBM3 at 700 W, seq 256), limit about twice that
SHARD_FLIP_SHARE_BY_PATH = {"shard_xlstm": 4e-4}
#: SHARD_PEAK_GATED: each rank's peak at most this share of one process's
SHARD_PEAK_RATIO = 0.6
#: the path whose ranks also run one EF round (F1 over each rank's range)
#: after their own rounds, from round 0's params and tokens
SHARD_EF_PATH = "shard_qwen2"
SHARD_EF_SPEC = "ef|zsign(use_kernel=true)"
#: EF's noise-free wire bits that differ from the one-process F1 payload,
#: over all bits sent: every one lies where the two bf16 pseudo-gradients'
#: signs differ (checked one by one), so this is the share of such signs,
#: 1.58e-3 measured on an H100 80GB HBM3 at 700 W, with 2.5x room.
#: SHARD_FLIP_SHARE is z = 1's, whose noise flips a bit for only a |dp| /
#: sigma share of a sign difference; a missing sum in a backward (a leaf's
#: relative L2 of 0.2-1.0) flips a tenth or more of the signs.
SHARD_EF_FLIP_SHARE = 4e-3
#: the EF scale mean(|p|) of a grid client against the same client's
#: one-process row (summed in f64): relative error (the bf16 gradients
#: differ by their reduce-scatters' order, by relative L2 under
#: SHARD_PG_REL_L2; a missing sum moves the scale by far more)
SHARD_EF_SCALE_RTOL = 1e-3
#: the rounds the same ranks run after the EF round, each from round 0's
#: weights and tokens beside its one-process round: (tag, pipeline,
#: adversary). The robust median under a byte-corrupting client (R1 as the
#: vote pair's count over the all-gathered rows), dense z = 2 (C1 over each
#: range, the block-keyed draw's slice) and EF top-k (the whole row's
#: selection from the ranges' radix-select counts)
SHARD_SPEC_ROUNDS = [
    ("median", "zsign(z=1,sigma=0.01,agg=median)", "byte_corrupt(f=1,p=0.1)"),
    ("z2", "zsign_packed(z=2,sigma=0.01)", "none"),
    ("ef_topk", "ef|topk(frac=0.01)", "none")]
#: ef_topk: coordinates in one run's kept set and not in the other's (a
#: client's grid range against its one-process row), over the entries
#: kept: the pseudo-gradients differ by their bf16 reduce-scatters' order,
#: which moves entries near the threshold only (1.32e-2 measured on an
#: H100 80GB HBM3 at 700 W). A missing sum in a backward (a CPU copy whose
#: reduce-scatter returns its own chunk unsummed, at the reduced model)
#: moved 0.495 of the set.
SHARD_TOPK_SETDIFF_SHARE = 5e-2
SHARD_TIMEOUT_S = 600
#: serving on the grid (the dry run's prefill and decode cells), in these
#: paths' ranks after their rounds, from the seed-0 weights, beside the
#: one-process prefill and decode of the same weights and tokens: label ->
#: (prefill (global batch, seq) or None, decode batch, cache slots, steps).
#: A batch of 16 splits over the production mesh's 16 (``cache_specs``'
#: rule), so over the 2 x 2 grid's `data`: 8 rows a rank; the slots split
#: over `model` (4 and 2 a rank), and the steps cross from the first
#: sequence rank's slots into the second's. A cache length must not equal
#: another cache dimension (qwen2's 24 layers, 32B's 1; 16 rows), or
#: ``cache_specs`` shards that dimension as the sequence. A step gathers the
#: replica's weights through gloo: 1.1-2.1 s for qwen2's 0.99 GB, 5.4-7.7 s
#: for 32B's 5.06 GB at 2 layers on an H100 80GB HBM3 at 700 W, so 6 and 4
#: steps (20 and 8 took 105 s, above the phase's 45 s); 32B's 4 write every
#: slot, two on each sequence rank
SHARD_SERVE = {"shard_qwen2": ((4, 256), 16, 8, 6),
               "shard_qwen25_32b": (None, 16, 4, 4),
               # xlstm-350m full width: the sLSTM's (6, 16, 1,024) state
               # leaves cut over `model` on D, the mLSTM's on the rows
               # (its cache has no slots: 8 is any length)
               "shard_xlstm": ((4, 256), 16, 8, 6),
               # jamba's reduced config (f32; d_inner 128 is under the
               # state rule's 1,024: SHARD_MAMBA_DECODE cuts the state)
               "shard_hybrid": ((4, 64), 16, 8, 6),
               # seamless 4 + 4 layers: the prefill cell's 128 frames, then
               # the 32 rows' memory of 2,048 seeded frames filled on the
               # grid (``fill_cache``) beside 6 self-attention slots (3 a
               # sequence rank, 4 steps into the second's; 4 would be the
               # layers' count). 16 rows would equal its 16 kv heads, which
               # ``cache_specs`` then cuts as rows too
               "shard_encdec": ((4, 256), 32, 6, 4)}
#: the seed of the enc-dec serving paths' f32 frames (N(0, 1)): the prefill
#: cell's, then the decode memory's
SERVE_FRAME_SEED = 9
#: the one-process decode's top-2 logit gap above which the grid's greedy
#: token must be the one-process token: twice the largest logit error
#: measured (0.0 on an H100 80GB HBM3 at 700 W: the grid's logits are the
#: one-process bits), so every token with a gap; where a token differs the
#: decode goes on teacher-forced from the one-process tokens, which both
#: runs take as input at every step
SERVE_GAP_MARGIN = 0.0
#: the grid's logits (prefill and every decode step) and its cache slice
#: against the one-process run's: relative L2, twice the most measured on
#: an H100 80GB HBM3 at 700 W (0.0 for all three: the softmax's max and sum
#: are folded before its probabilities are rounded to bf16 and the ranks'
#: f32 V products added before their one rounding, as one process rounds
#: them, and the gathered weights' bf16 matmuls give each row the same bits
#: on 8 rows as on 16), so the same bits
SERVE_REL_L2 = 0.0
#: the limits where a path's design does not keep every sum whole: path ->
#: {"prefill", "decode", "cache": relative L2 limit, "gap": top-2 margin},
#: against the one-process run over each `data` rank's rows
#: (SERVE_ROW_SPLIT). The reduced hybrid is f32: its channel-parallel
#: mamba prefill sums the x_proj partials over the channel slices and its
#: decode's softmax fold scales each rank's f32 softmax by its share (6.1e-6,
#: 1.2e-6 and 8.5e-7 measured on an H100 80GB HBM3 at 700 W; the top-2
#: gaps down to 7.0e-4), so 1e-4 and a gap of 1e-3. The
#: enc-dec's cross-attention adds the memory slots' f32 products over the
#: ranks where one process takes one bf16 matmul, and its encoder runs over
#: sequence shards (6.5e-3, 8.3e-3 and 5.0e-3 measured, the logits 3.1e-2
#: apart at most), so 2e-2 and a gap of 0.1. The xLSTM keeps 0.0: its
#: prefill, decode and state were the reference's bits
SERVE_LIMITS_BY_PATH = {
    "shard_hybrid": {"prefill": 1e-4, "decode": 1e-4, "cache": 1e-4,
                     "gap": 1e-3},
    "shard_encdec": {"prefill": 2e-2, "decode": 2e-2, "cache": 2e-2,
                     "gap": 0.1}}
#: shard_hybrid's ranks also step one mamba sublayer at Jamba's width
#: (SHARD_MAMBA's d_model) as the decode cell does, its h (B, d_inner, 16)
#: and conv (B, 3, d_inner) state cut over `model` on d_inner, the rows
#: over `data`: B rows, steps one-token steps from a zero state, beside the
#: one-process ``mamba_decode_step``. Its activations are gathered over the
#: channel ranks (every sum whole): every step's output and the final state
#: slices are the one-process bits (limit 0.0)
SHARD_MAMBA_DECODE = {"batch": 16, "steps": 4}
#: the serving paths whose one-process reference runs over each `data`
#: rank's rows alone (``_serve_one``), as the grid's ranks run them: the
#: card's bf16 GEMMs may round a row otherwise at 16 rows than at 8
#: (xlstm-350m's one-process decode over 16 rows lay 7.3e-2 relative L2
#: from the same rows run 8 at a time, its prefill 0.104, on an H100 80GB
#: HBM3 at 700 W: its mLSTM rms-normalizes near-zero products at random
#: init), so the grid's bits are those of a run over its rows. The
#: Jamba-width mamba decode (SHARD_MAMBA_DECODE) is held the same way
SERVE_ROW_SPLIT = ("shard_xlstm", "shard_hybrid", "shard_encdec")
#: coordinates a chunk of the ranks' plain checks (a multiple of E1's tile)
RANGE_CHECK_COORDS = 1 << 26


class _GridShape:
    """The 2 x 2 grid's shape, for ``make_plan`` without a group."""
    axis_names = SHARD_AXES
    shape = dict(zip(SHARD_AXES, SHARD_GRID))


def _shard_arch(arch_id, layers):
    import dataclasses
    from repro_torch.configs.common import get_arch
    arch = get_arch(arch_id)
    if layers == "reduced":
        arch = arch.reduced()
    elif layers is not None:
        arch = dataclasses.replace(arch, model=dataclasses.replace(
            arch.model, n_layers=layers))
    if arch_id in SHARD_SIGMA:
        arch = dataclasses.replace(arch, zsign_sigma=SHARD_SIGMA[arch_id])
    if arch_id in SHARD_GROUPS:
        arch = dataclasses.replace(arch,
                                   seq_client_groups=SHARD_GROUPS[arch_id])
    return arch


def _shard_shape(seq, batch):
    from repro_torch.configs.common import ShapeCfg
    return ShapeCfg(f"chip_train_{seq}", "train", seq, batch)


def _shard_batch(plan, cfg, seq: int, t: int, dev):
    """Round t's (G, N, E, micro, ...) batch, the same in every process:
    tokens, and for the VLM its stub image embeds (f32, N(0, 1)) in place
    of the first n_img_tokens."""
    from repro_torch.models.api import build_model
    gen = torch.Generator().manual_seed(4000 + t)
    lead = (plan.client_groups, plan.n_clients, plan.local_steps,
            plan.micro)
    out = {}
    for k, leaf in sorted(build_model(cfg).train_batch_spec(
            plan.micro, seq).items()):
        shape = lead + tuple(leaf.shape[1:])
        out[k] = (torch.randint(0, cfg.vocab, shape, generator=gen,
                                dtype=torch.int32)
                  if leaf.dtype == torch.int32 else
                  torch.randn(shape, generator=gen, dtype=leaf.dtype)).to(dev)
    return out


def _shard_init(arch, dev):
    """The path's seed-0 weights, drawn on the card (every process draws
    the same)."""
    from repro_torch.models.api import build_model
    gen = torch.Generator(device=dev).manual_seed(0)
    return build_model(arch.model).init(gen, device=dev)


def _meminfo() -> dict:
    """/proc/meminfo's fields in bytes."""
    out = {}
    with open("/proc/meminfo") as f:
        for line in f:
            k, v = line.split(":", 1)
            out[k] = int(v.split()[0]) * 1024
    return out


class _HostPeak(threading.Thread):
    """Polls /proc/meminfo while a path runs (its one-process run and its
    ranks): the peaks of ``Shmem`` (the shared row pool, whatever of it is
    touched, and any other shared pages) and of MemTotal - MemAvailable
    (all the machine reports in use: the shared pages, the ranks' pinned
    staging and every process's own), beside MemTotal. (torch's pinned-
    allocator peaks are summed over its size buckets: on an H100 host they
    read more than the host holds, so they are not used.)"""

    def __init__(self, every_s: float = 0.2):
        super().__init__(daemon=True)
        self.every_s, self.done = every_s, threading.Event()
        self.shmem = self.used = self.total = 0

    def run(self):
        while True:
            m = _meminfo()
            self.shmem = max(self.shmem, m.get("Shmem", 0))
            self.used = max(self.used, m["MemTotal"] - m["MemAvailable"])
            self.total = m["MemTotal"]
            if self.done.wait(self.every_s):
                return

    def stop(self) -> dict:
        self.done.set()
        self.join()
        return {"shmem_peak": self.shmem / 1e9, "used_peak": self.used / 1e9,
                "mem_total": self.total / 1e9}


class _Toucher(threading.Thread):
    """Touches ``pool[lo:]`` (zeroes it) in ascending chunks in the
    background, once started; ``wait(n)`` returns when ``pool[:n]`` is
    touched (at once where ``n`` <= ``lo``)."""

    def __init__(self, pool, lo: int, chunk: int = 1 << 28):
        super().__init__(daemon=True)
        self.pool, self.upto, self.chunk = pool, lo, chunk
        self.cv, self.halt = threading.Condition(), False

    def run(self):
        n = self.pool.numel()
        try:
            while self.upto < n and not self.halt:
                b = min(n, self.upto + self.chunk)
                self.pool[self.upto:b].zero_()
                with self.cv:
                    self.upto = b
                    self.cv.notify_all()
        finally:                    # a waiter raises if it stopped short
            with self.cv:
                self.halt = True
                self.cv.notify_all()

    def wait(self, n: int):
        n = min(n, self.pool.numel())
        if n <= self.upto:
            return
        if self.ident is None:
            self.start()
        with self.cv:
            self.cv.wait_for(lambda: self.upto >= n or self.halt)
        if self.upto < n:
            raise RuntimeError(f"touching the row pool stopped at "
                               f"{self.upto} of {n}")

    def stop(self):
        self.halt = True
        if self.ident is not None:
            self.join()


def _shard_one(label, arch_id, layers, rounds, seq, gbatch, tmp, pool):
    """The path's rounds in this process, alone on the card, without a
    grid (the vmap plan: 2 clients in one E1 launch, or the group scan of
    the sequential groups of one client), the MoE's capacity counted over
    the grid's sequence shards (``hints.seq_shard_view``). Copies each
    client's pseudo-gradient row into the next (d,) piece of ``pool``, a
    shared host tensor (``_shared_row``; the ranks get the same pages, and
    the machine's disk, whose writes are capped, holds none of it), and
    writes
    each client's payload bytes and the final params to ``tmp`` for the
    ranks. -> (record, {(round, client): row})."""
    from repro_torch.core import compression
    from repro_torch.core import fedavg as TF
    from repro_torch.core import noise as TN
    from repro_torch.core.tree import tree_leaves, tree_paths
    from repro_torch.launch import hints
    from repro_torch.launch import sharding as SH
    from repro_torch.models.api import build_model
    arch = _shard_arch(arch_id, layers)
    plan = SH.make_plan(arch, _shard_shape(seq, gbatch), _GridShape())
    bundle = build_model(arch.model)
    params = _shard_init(arch, DEV)
    d = sum(v.numel() for v in tree_leaves(params))
    comp = compression.Pipeline(
        f"zsign(z={arch.zsign_z},sigma={arch.zsign_sigma})")
    fcfg = TF.FedConfig(n_clients=plan.n_clients,
                        client_groups=plan.client_groups,
                        local_steps=plan.local_steps,
                        client_lr=arch.client_lr, server_lr=arch.server_lr)
    step = TF.build_round_step(bundle.loss_fn, comp, fcfg,
                               SH.round_context(plan, cohort="vmap"))
    state = TF.init_server_state(params, fcfg, comp, TN.prng_key(1))
    del params
    rows, payloads = {}, {}
    cur = {"t": 0, "lo": 0, "copy_s": 0.0}
    enc = compression.Pipeline.encode_batch
    # fresh shared pages take a device-to-host copy at ~0.3 GB/s, a copy
    # from pinned memory at ~0.9 (an H100 80GB HBM3 host, 8 cores)
    stage = torch.empty(RANGE_CHECK_COORDS, dtype=torch.float32,
                        pin_memory=True)

    def encode_batch(self, keys, flat2d, n_coords=None, *a, **k):
        out, st = enc(self, keys, flat2d, n_coords, *a, **k)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(flat2d.shape[0]):
            key = (cur["t"], cur["lo"] + i)
            rows[key] = pool[len(rows) * d:(len(rows) + 1) * d]
            for lo in range(0, d, RANGE_CHECK_COORDS):
                hi = min(d, lo + RANGE_CHECK_COORDS)
                stage[:hi - lo].copy_(flat2d[i, lo:hi])
                rows[key][lo:hi].copy_(stage[:hi - lo])
            payloads[key] = out[i].cpu()
        cur["lo"] += flat2d.shape[0]
        cur["copy_s"] += time.perf_counter() - t0
        return out, st

    _free()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    compression.Pipeline.encode_batch = encode_batch
    secs, losses = [], []
    try:
        for t in range(rounds):
            cur.update(t=t, lo=0, copy_s=0.0)
            batch = _shard_batch(plan, arch.model, seq, t, DEV)
            mask = torch.ones((plan.client_groups, plan.n_clients))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with hints.seq_shard_view(SHARD_SEQ_SHARDS):
                state, m = step(state, batch, mask)
            torch.cuda.synchronize()
            # the host copies of this check are not the round's
            secs.append(time.perf_counter() - t0 - cur["copy_s"])
            losses.append(float(m.loss))
    finally:
        compression.Pipeline.encode_batch = enc
    peak = torch.cuda.max_memory_allocated()
    counts = _counts()
    del stage
    torch.save({f"{t}_{c}": v for (t, c), v in payloads.items()},
               os.path.join(tmp, label + "_bytes.pt"))
    torch.save({".".join(p): v.cpu() for p, v in tree_paths(state.params)},
               os.path.join(tmp, label + "_params.pt"))
    del state, payloads
    _free()
    return {"d": d, "peak": peak, "round_s": secs, "loss": losses,
            "counts": counts, "plan": plan,
            "rows_bytes": 4 * d * len(rows)}, rows


def _payload_cpu(p):
    """A copy of a payload stack on the host: bytes, or a dict of its
    tensors."""
    if isinstance(p, dict):
        return {k: v.to("cpu", copy=True) for k, v in p.items()}
    return p.to("cpu", copy=True)


def _shard_specs_one(label, arch_id, layers, seq, gbatch, tmp):
    """SHARD_SPEC_ROUNDS' one-process rounds (the vmap plan: both clients
    in one encode) from the seed-0 weights and round 0's tokens, under
    their adversaries: each client's payload as encoded and as the
    aggregate took it (after the attack), and the params, written to
    ``tmp`` for the ranks. -> {tag: record}"""
    from repro_torch.core import compression
    from repro_torch.core import fedavg as TF
    from repro_torch.core import noise as TN
    from repro_torch.core.tree import tree_paths
    from repro_torch.launch import hints
    from repro_torch.launch import sharding as SH
    from repro_torch.models.api import build_model
    arch = _shard_arch(arch_id, layers)
    plan = SH.make_plan(arch, _shard_shape(seq, gbatch), _GridShape())
    bundle = build_model(arch.model)
    enc = compression.Pipeline.encode_batch
    agg = compression.Pipeline.aggregate
    out = {}
    for tag, spec, adv in SHARD_SPEC_ROUNDS:
        comp = compression.Pipeline(spec)
        fcfg = TF.FedConfig(n_clients=plan.n_clients,
                            client_groups=plan.client_groups,
                            local_steps=plan.local_steps,
                            client_lr=arch.client_lr,
                            server_lr=arch.server_lr)
        step = TF.build_round_step(bundle.loss_fn, comp, fcfg,
                                   SH.round_context(plan, cohort="vmap",
                                                    adversary=adv))
        state = TF.init_server_state(_shard_init(arch, DEV), fcfg, comp,
                                     TN.prng_key(1))
        seen = {"copy_s": 0.0}

        def encode_batch(self, *a, **k):
            got, st = enc(self, *a, **k)
            t0 = time.perf_counter()
            seen["encoded"] = _payload_cpu(got)
            seen["copy_s"] += time.perf_counter() - t0
            return got, st

        def aggregate(self, payload, *a, **k):
            t0 = time.perf_counter()
            seen["sent"] = _payload_cpu(payload)
            seen["copy_s"] += time.perf_counter() - t0
            return agg(self, payload, *a, **k)

        batch = _shard_batch(plan, arch.model, seq, 0, DEV)
        mask = torch.ones((plan.client_groups, plan.n_clients))
        _reset_counts()
        compression.Pipeline.encode_batch = encode_batch
        compression.Pipeline.aggregate = aggregate
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with hints.seq_shard_view(SHARD_SEQ_SHARDS):
                state, m = step(state, batch, mask)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0 - seen["copy_s"]
        finally:
            compression.Pipeline.encode_batch = enc
            compression.Pipeline.aggregate = agg
        torch.save({"encoded": seen["encoded"], "sent": seen["sent"]},
                   os.path.join(tmp, f"{label}_{tag}_payload.pt"))
        torch.save({".".join(p): v.cpu() for p, v in tree_paths(state.params)},
                   os.path.join(tmp, f"{label}_{tag}_params.pt"))
        out[tag] = {"sec": sec, "loss": float(m.loss),
                    "uplink_bits": float(m.uplink_bits), "counts": _counts()}
        del state, batch, m, seen
        _free()
    return out


def _shard_rows(arch_id, layers, rounds, seq, gbatch) -> int:
    """f32 elements of a path's one-process rows: d for each client of
    each round (shapes only, nothing allocated)."""
    from repro_torch.core.tree import tree_paths
    from repro_torch.launch import sharding as SH
    from repro_torch.models.api import family_module
    arch = _shard_arch(arch_id, layers)
    plan = SH.make_plan(arch, _shard_shape(seq, gbatch), _GridShape())
    d = sum(math.prod(s) for _, s in tree_paths(
        family_module(arch.model).param_shapes(arch.model)))
    return d * rounds * plan.client_groups * plan.n_clients


def _shared_row(n: int) -> torch.Tensor:
    """An (n,) f32 CPU tensor in shared memory, allocated there (no copy),
    which ``torch.multiprocessing`` hands to the spawned ranks by its
    pages. The phase allocates one, for the most rows a path keeps, and
    every path refills it: pages touched once take a copy ~3x faster than
    fresh ones (an H100 80GB HBM3 host)."""
    storage = torch.UntypedStorage._new_shared(4 * n)
    return torch.empty(0, dtype=torch.float32).set_(storage)


class _RangePlainProbe(_PlainCheckProbe):
    """``_PlainCheckProbe`` for the sharded rounds (E1 with its tile0, R1
    add mode). Four ranks share the card, so the plain versions run over
    tile-aligned chunks of RANGE_CHECK_COORDS coordinates (E1's plain
    encode of coordinates [a, b) with tile0 + a / 8192 is the byte slice
    [a / 8, b / 8) of the whole range's; R1's coordinates are independent),
    and their temporaries are kept out of the rank's peak: the peak before
    the check is kept and the counter reset after it."""

    def __init__(self, ops):
        super().__init__(ops)
        self.peak = 0

    def _before(self):
        torch.cuda.synchronize()
        self.peak = max(self.peak, torch.cuda.max_memory_allocated())

    def _after(self):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

    def zsign_encode(self, x2d, keys, sigma, z, tile0=None):
        got = self._ops.zsign_encode(x2d, keys, sigma, z, tile0)
        if "zsign_encode" in self.seen:
            return got
        self._before()
        nflip, t0, tile = 0, tile0 or 0, self._ops.TILE
        for a in range(0, x2d.shape[1], RANGE_CHECK_COORDS):
            b = min(x2d.shape[1], a + RANGE_CHECK_COORDS)
            x = x2d[:, a:b]
            want = self._ops.zsign_encode_plain(x, keys, sigma, z,
                                                t0 + a // tile)
            n, far = self._ops.erf_rule_flips(
                x, keys, sigma, z, got[:, a // 8:b // 8].contiguous(), want,
                tile0=t0 + a // tile)
            if far:
                raise AssertionError(f"E1: {far} bits differ from the plain "
                                     "version outside the erf rule")
            nflip += n
            del want
        self.seen["zsign_encode"] = {
            "shape": list(x2d.shape), "tile0": tile0,
            "bits_differing": nflip, "max_abs_err": 1 if nflip else 0}
        self._after()
        return got

    def sign_reduce(self, packed, weights, acc=None):
        got = self._ops.sign_reduce(packed, weights, acc)
        if "sign_reduce" in self.seen:
            return got
        self._before()
        step = RANGE_CHECK_COORDS // 8
        for a in range(0, packed.shape[1], step):
            b = min(packed.shape[1], a + step)
            want = self._ops.sign_reduce_plain(
                packed[:, a:b], weights,
                None if acc is None else acc[8 * a:8 * b])
            if not _same_bits(got[8 * a:8 * b], want):
                raise AssertionError("R1: bits differ from the plain "
                                     "version")
            del want
        self.seen["sign_reduce"] = {"shape": list(packed.shape),
                                    "max_abs_err": 0.0}
        self._after()
        return got


class _SpecRangeProbe(_RangePlainProbe):
    """``_RangePlainProbe`` for SHARD_SPEC_ROUNDS: also C1 over the range
    (kernel against ``zsign_compress_rows_plain``, bytes equal, in chunks of
    RANGE_CHECK_COORDS: C1 is elementwise) and, on the vote route, R1's
    weighted count as the vote pair's signed count: its int32 cast equal to
    the popcount route's (``wire.vote_accumulator``) row 0 on the same
    gathered rows and mask."""

    def zsign_compress_rows(self, x2d, noise2d, sigma):
        got = self._ops.zsign_compress_rows(x2d, noise2d, sigma)
        if "zsign_compress" in self.seen:
            return got
        self._before()
        for a in range(0, x2d.shape[1], RANGE_CHECK_COORDS):
            b = min(x2d.shape[1], a + RANGE_CHECK_COORDS)
            want = self._ops.zsign_compress_rows_plain(
                x2d[:, a:b].contiguous(), noise2d[:, a:b].contiguous(),
                sigma)
            if not torch.equal(got[:, a // 8:b // 8], want):
                raise AssertionError("C1 over a range: bytes differ from "
                                     "the plain version")
            del want
        self.seen["zsign_compress"] = {"shape": list(x2d.shape),
                                       "max_abs_err": 0}
        self._after()
        return got

    def sign_reduce(self, packed, weights, acc=None):
        from repro_torch.core import wire
        got = super().sign_reduce(packed, weights, acc)
        if "vote_count" in self.seen:
            return got
        self._before()
        step = RANGE_CHECK_COORDS // 8
        for a in range(0, packed.shape[1], step):
            b = min(packed.shape[1], a + step)
            want = wire.vote_accumulator(packed[:, a:b], weights)[0]
            if not torch.equal(got[8 * a:8 * b].to(torch.int32), want):
                raise AssertionError("R1 as the vote count: differs from "
                                     "the popcount pair")
            del want
        self.seen["vote_count"] = {"shape": list(packed.shape),
                                   "max_abs_err": 0}
        self._after()
        return got


def _vote_decode_f64(pair, agg: str, trim_f: int = 0):
    """``wire.vote_decode``'s closed forms evaluated in f64 and rounded
    once to f32."""
    s, n = pair[0].to(torch.float64), pair[1].to(torch.float64)
    f_max = torch.floor((torch.clamp_min(n, 1.0) - 1.0) / 2.0)
    f = f_max if agg == "median" else torch.clamp_max(f_max, float(trim_f))
    m = torch.clamp_min(n - 2.0 * f, 1.0)
    plus = torch.minimum(torch.clamp_min((s + n) * 0.5 - f, 0.0), m)
    return torch.where(n > 0, (2.0 * plus - m) / m, 0.0).to(torch.float32)


def _range_bit_flips(got, want, x, lo, hi, d):
    """The coordinates (global) where a range's payload bytes ``got``
    differ from the one-process bytes ``want`` (the same range), and the
    range's codec input there."""
    diff = got ^ want
    nz = torch.nonzero(diff).reshape(-1)
    bits = torch.nonzero((diff[nz].unsqueeze(-1) >> torch.arange(
        8, device=diff.device, dtype=torch.uint8)) & 1)
    coords = nz[bits[:, 0]] * 8 + bits[:, 1]
    coords = coords[coords < d - lo]
    return {"coords": (coords + lo).cpu(), "vals": x[coords].cpu(),
            "sent": min(hi, d) - lo}


def _topk_range_record(p, got, e, lo, one_idx):
    """EF top-k over one range: the kept entries' values are the codec
    input's; the residual is zero exactly at the kept coordinates and the
    input elsewhere; the range's share of the whole row's certificate
    (the smallest kept |p| and the largest kept index at it, the largest
    unkept |p| and the smallest unkept index at it); the kept set against
    the one-process client's entries in the range."""
    real = p.shape[0]
    idx = got["indices"][0].long()
    score = p.abs()
    kept = torch.zeros((real,), dtype=torch.bool, device=p.device)
    kept[idx] = True
    if int(kept.sum()) != idx.numel():
        raise AssertionError("top-k: a range kept an index twice")
    if not _same_bits(got["values"][0], p[idx]):
        raise AssertionError("top-k: kept values are not the codec input's")
    if not (_same_bits(e[kept], torch.zeros_like(e[kept]))
            and _same_bits(e[~kept], p[~kept])):
        raise AssertionError("EF top-k: the residual is not the input with "
                             "the kept coordinates zeroed")
    t_kept = score[kept].min()
    t_unkept = score[~kept].max()
    rec = {"kept": idx.numel(), "min_kept": float(t_kept),
           "max_kept_idx_at_min": lo + int(torch.nonzero(
               kept & (score == t_kept)).max()),
           "max_unkept": float(t_unkept),
           "min_unkept_idx_at_max": lo + int(torch.nonzero(
               ~kept & (score == t_unkept)).min())}
    one = one_idx.to(p.device).long()
    one = one[(one >= lo) & (one < lo + real)] - lo
    kept_one = torch.zeros_like(kept)
    kept_one[one] = True
    rec["kept_one_process"] = one.numel()
    rec["setdiff"] = int((kept ^ kept_one).sum())
    rec["union"] = (torch.nonzero(kept | kept_one).reshape(-1) + lo).cpu()
    return rec


def _range_vs_row(x, row, lo, hi, spec):
    """A rank's pseudo-gradient range ``x`` against coordinates [lo, hi)
    of the one-process row ``row`` (a shared host tensor, read in 256 MiB
    pieces), leaf by leaf of ``spec`` (a ``wire.TreeSpec``), so a wrong
    small leaf is not lost in a large one: each leaf piece's relative L2
    error, the worst of them, the largest error over the row's largest
    magnitude, and the coordinates that differ (past hi ``x`` must be
    0)."""
    leaves = []
    for name, shape, off in zip(spec.paths, spec.shapes, spec.offsets):
        a, b = max(lo, off), min(hi, off + math.prod(shape))
        if b > a:
            leaves.append({"leaf": ".".join(name) if isinstance(
                name, tuple) else str(name), "a": a, "b": b,
                "err2": 0.0, "ref2": 0.0})
    err_max = ref_max = 0.0
    differing = int(torch.count_nonzero(x[hi - lo:]))
    for a in range(lo, hi, 1 << 26):
        b = min(hi, a + (1 << 26))
        ref = row[a:b].to(x.device)
        diff = x[a - lo:b - lo] - ref
        for lf in leaves:
            u, v = max(a, lf["a"]), min(b, lf["b"])
            if v > u:
                dd, rr = diff[u - a:v - a], ref[u - a:v - a]
                lf["err2"] += float(torch.sum(dd * dd, dtype=torch.float64))
                lf["ref2"] += float(torch.sum(rr * rr, dtype=torch.float64))
        err_max = max(err_max, float(diff.abs().max()))
        ref_max = max(ref_max, float(ref.abs().max()))
        differing += int(torch.count_nonzero(diff))
        del ref, diff
    rel = {lf["leaf"]: math.sqrt(lf["err2"] / lf["ref2"]) if lf["ref2"]
           else (0.0 if lf["err2"] == 0 else math.inf) for lf in leaves}
    err2 = sum(lf["err2"] for lf in leaves)
    ref2 = sum(lf["ref2"] for lf in leaves)
    worst = max(rel, key=rel.get)
    return {"rel_l2": math.sqrt(err2 / max(ref2, 1e-300)),
            "rel_l2_by_leaf": rel, "worst_leaf": worst,
            "worst_leaf_rel_l2": rel[worst],
            "max_err": err_max / max(ref_max, 1e-30),
            "coords_differing": differing, "coords": hi - lo}


class _EfRangeProbe:
    """Stands in for the F1 module inside ``core.compression`` on the
    sharded EF round: the range's F1 launch is held against
    ``ef_sign_rows_plain`` on the same range row, residual (before the
    launch, which writes over it), scale and live mask, in tile-aligned
    chunks of RANGE_CHECK_COORDS (F1 is elementwise: a chunk's payload and
    residual are the slices of the whole range's); payload bytes and
    residual bit patterns equal. Its temporaries are kept out of the
    rank's peak, as ``_RangePlainProbe``'s. Records the scale's bits."""

    def __init__(self, eops):
        self._eops, self.seen, self.peak = eops, {}, 0

    def __getattr__(self, name):
        return getattr(self._eops, name)

    def ef_sign_rows(self, g2d, e2d, scale, **kw):
        torch.cuda.synchronize()
        self.peak = max(self.peak, torch.cuda.max_memory_allocated())
        e0 = e2d.clone()
        got = self._eops.ef_sign_rows(g2d, e2d, scale, **kw)
        torch.cuda.synchronize()
        real = e2d.shape[1]
        for a in range(0, g2d.shape[1], RANGE_CHECK_COORDS):
            b = min(g2d.shape[1], a + RANGE_CHECK_COORDS)
            v = min(b, real)
            if v <= a:
                raise AssertionError("F1 check: a chunk of padding only")
            want = self._eops.ef_sign_rows_plain(
                g2d[:, a:b], e0[:, a:v].clone(), scale,
                **{**kw, "in_place": False})
            if not (_same_bits(got[0][:, a // 8:b // 8], want[0])
                    and _same_bits(got[1][:, a:v], want[1])):
                raise AssertionError("F1 over a range: differs from the "
                                     "plain version")
            del want
        self.seen["ef_sign"] = {
            "shape": list(g2d.shape), "residual": list(e2d.shape),
            "max_abs_err": 0.0,
            "scale": float(scale[0]),
            "scale_bits": int(scale.view(torch.int32)[0])}
        del e0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        return got


def _shard_ef_round(grid, arch, seq, gbatch, dev, rows):
    """One ``SHARD_EF_SPEC`` round of the dry run's train cell on this
    rank's grid, from the seed-0 weights and round 0's tokens (the zsign
    rounds' first): F1 once over this rank's range and R1 over the
    all-gathered (2, n_bytes) rows, each held to its plain version; the
    payload's bits against the one-process pseudo-gradient row's signs
    (round 0's rows, ``rows``, are what F1 sends for it with a zero
    residual). -> the record."""
    import torch.distributed as dist
    from repro_torch.core import compression, wire
    from repro_torch.core import fedavg as TF
    from repro_torch.core import noise as TN
    from repro_torch.kernels.efsign import ops as eops
    from repro_torch.kernels.zsign import ops
    from repro_torch.launch import dryrun, hints
    from repro_torch.models.api import shard_params
    step, example, plan = dryrun.build_train_cell(
        arch, _shard_shape(seq, gbatch), grid, pipeline=SHARD_EF_SPEC)
    full = _shard_init(arch, dev)
    shards = shard_params(full, arch.model, grid, plan, device=dev)
    del full
    layout = step.layout(shards)
    lo, hi = layout.bounds
    d = layout.spec.n_coords
    state = TF.init_server_state(shards, example["fcfg"], example["comp"],
                                 TN.prng_key(1), layout=layout)
    del shards
    batch = _shard_batch(plan, arch.model, seq, 0, dev)
    mask = torch.ones((plan.client_groups, plan.n_clients))
    client = grid.index(plan.client_axes)
    seen = {}
    enc = compression.Pipeline.encode_range

    def encode_range(self, keys, x2d, tile0, sigma=None, **kw):
        got = enc(self, keys, x2d, tile0, sigma=sigma, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        flips, sent, abs_one = 0, min(hi, d) - lo, 0.0
        row = rows[(0, client)]
        for a in range(0, sent, RANGE_CHECK_COORDS):
            b = min(sent, a + RANGE_CHECK_COORDS)
            x = x2d[0, a:b]
            r = row[lo + a:lo + b].to(dev)
            # the one-process row's sum of |p| over this range, in f64
            abs_one += float(torch.sum(torch.abs(r), dtype=torch.float64))
            one = r >= 0
            del r
            bits = wire.unpack_bits(got["packed"][0, a // 8:-(-b // 8)])[
                :b - a]
            off = bits != one
            if bool(((x[off] >= 0) == one[off]).any()):
                raise AssertionError("EF: wire bits differ where the "
                                     "pseudo-gradients' signs agree")
            flips += int(off.sum())
            del x, one, bits, off
        pad = wire.unpack_bits(got["packed"][0])[sent:]
        seen.update(flips=flips, sent=sent, padding_bits_set=int(pad.sum()),
                    padding_bits=int(pad.numel()), abs_sum_one_f64=abs_one)
        seen["check_s"] = time.perf_counter() - t0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        dist.barrier()
        return got

    probe, rprobe = _EfRangeProbe(eops), _RangePlainProbe(ops)
    _free()
    torch.cuda.reset_peak_memory_stats()
    hints.reset_collective_stats()
    wire.reset_reduce_stats()
    before = _counts()
    compression.Pipeline.encode_range = encode_range
    compression.EK, compression.K = probe, rprobe
    dist.barrier()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        state, m = step(state, batch, mask)
        torch.cuda.synchronize()
    finally:
        compression.Pipeline.encode_range = enc
        compression.EK, compression.K = eops, ops
    sec = time.perf_counter() - t0 - seen["check_s"]
    after = _counts()
    peak = max(probe.peak, rprobe.peak, torch.cuda.max_memory_allocated())
    e = state.comp_state["ef"]
    rec = {"sec": sec, "loss": float(m.loss), "peak": peak,
           "uplink_bits": float(m.uplink_bits),
           "counts": {k: after[k] - before[k] for k in after},
           "collective_bytes": hints.collective_totals(0),
           "collective_by_use": {k: list(v) for k, v in
                                 hints.COLLECTIVES.items()},
           "vs_plain": {**probe.seen, **rprobe.seen},
           "residual_shape": list(e.shape),
           "residual_padding_nonzero": int(torch.count_nonzero(
               e[..., min(hi, d) - lo:])),
           "client": client, **seen}
    del state, e, batch
    _free()
    return rec


def _shard_spec_round(grid, arch, seq, gbatch, dev, tmp, label, tag, spec,
                      adv):
    """One SHARD_SPEC_ROUNDS round of the dry run's train cell on this
    rank's grid, from the seed-0 weights and round 0's tokens: its kernels
    held to their plain versions (``_SpecRangeProbe``); the range's payload
    against the one-process round's (``_shard_specs_one``): its bits, or
    top-k's kept set and certificate; the adversary's attack on the range
    against the same attack on the whole payload; the dense draw's range
    against the whole row's; the median decode against its f64 closed
    form; the params against the one-process params. -> the record."""
    import torch.distributed as dist
    from repro_torch.core import compression
    from repro_torch.core import fedavg as TF
    from repro_torch.core import noise as TN
    from repro_torch.fed import adversary as TA
    from repro_torch.kernels.zsign import ops
    from repro_torch.launch import dryrun, hints
    from repro_torch.models.api import shard_params
    step, example, plan = dryrun.build_train_cell(
        arch, _shard_shape(seq, gbatch), grid, pipeline=spec, adversary=adv)
    full = _shard_init(arch, dev)
    shards = shard_params(full, arch.model, grid, plan, device=dev)
    del full
    layout = step.layout(shards)
    lo, hi = layout.bounds
    d = layout.spec.n_coords
    real = min(hi, d) - lo
    state = TF.init_server_state(shards, example["fcfg"], example["comp"],
                                 TN.prng_key(1), layout=layout)
    del shards
    batch = _shard_batch(plan, arch.model, seq, 0, dev)
    mask = torch.ones((plan.client_groups, plan.n_clients))
    client = grid.index(plan.client_axes)
    one = torch.load(os.path.join(tmp, f"{label}_{tag}_payload.pt"))
    seen = {"check_s": 0.0, "peak": 0}
    enc = compression.Pipeline.encode_range
    dec = compression.Pipeline.decode_sum
    corrupt, draw = TA.Adversary.corrupt, TN.sample_z_noise

    def checked(fn):
        # a check's time and buffers are kept out of the round's
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        seen["peak"] = max(seen["peak"], torch.cuda.max_memory_allocated())
        fn()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        seen["check_s"] += time.perf_counter() - t0

    def encode_range(self, keys, x2d, tile0, sigma=None, **kw):
        got = enc(self, keys, x2d, tile0, sigma=sigma, **kw)

        def check():
            if isinstance(got, dict):
                seen["topk"] = _topk_range_record(
                    x2d[0, :real], got, kw["state"]["ef"][0, :real], lo,
                    one["encoded"]["indices"][client])
            else:
                want = one["encoded"][client][lo // 8:hi // 8].to(dev)
                seen["flips"] = _range_bit_flips(got[0], want, x2d[0], lo,
                                                 hi, d)
        checked(check)
        return got

    def attack(self, payload, idx, round_idx, b0=0):
        pre = payload.clone()
        out = corrupt(self, payload, idx, round_idx, b0)

        def check():
            nb = pre.shape[1]
            # the whole payload: ceil(d / 8192) tiles of 1024 bytes
            whole = torch.zeros((1, -(-d // ops.TILE) * ops.TILE // 8),
                                dtype=torch.uint8, device=dev)
            whole[:, b0:b0 + nb] = pre
            corrupt(self, whole, idx, round_idx, 0)
            if not torch.equal(whole[:, b0:b0 + nb], out):
                raise AssertionError("the attack on a byte range is not the "
                                     "slice of the whole payload's")
            # where the range's bytes before the attack are the one-process
            # client's, the attacked bytes are too
            one_pre = one["encoded"][client][b0:b0 + nb].to(dev)
            one_sent = one["sent"][client][b0:b0 + nb].to(dev)
            same = pre[0] == one_pre
            seen["attack"] = {
                "client": int(idx[0]), "b0": b0, "bytes": nb,
                "bytes_hit": int((out != pre).sum()),
                "bytes_off_one_process_where_inputs_agree": int(
                    (out[0][same] != one_sent[same]).sum())}
            del whole
        checked(check)
        return out

    def sample(key, shape, z, device=None, dtype=torch.float32, lo=0):
        got = draw(key, shape, z, device=device, dtype=dtype, lo=lo)

        def check():
            n = got.numel()
            whole = draw(key, (d,), z, device=device, dtype=dtype)
            if not _same_bits(whole[lo:lo + n], got.reshape(-1)):
                raise AssertionError("the dense draw of a range is not the "
                                     "slice of the whole row's")
            seen["noise"] = {"range": [lo, lo + n], "row": d, "z": z}
            del whole
        checked(check)
        return got

    def decode_sum(self, enc_sum, n_live, *a, **k):
        g = dec(self, enc_sum, n_live, *a, **k)
        agg = getattr(self.codec, "agg", "mean")
        if agg in ("vote", "trimmed", "median"):
            def check():
                for a0 in range(0, g.shape[0], RANGE_CHECK_COORDS):
                    b0 = min(g.shape[0], a0 + RANGE_CHECK_COORDS)
                    want = _vote_decode_f64(enc_sum[:, a0:b0], agg,
                                            self.codec.trim_f)
                    if not _same_bits(g[a0:b0], want):
                        raise AssertionError(f"the {agg} decode differs "
                                             "from its f64 closed form")
                seen["decode"] = {"agg": agg, "shape": list(enc_sum.shape),
                                  "max_abs_err": 0}
            checked(check)
        return g

    probe = _SpecRangeProbe(ops)
    _free()
    torch.cuda.reset_peak_memory_stats()
    hints.reset_collective_stats()
    before = _counts()
    compression.Pipeline.encode_range = encode_range
    compression.Pipeline.decode_sum = decode_sum
    TA.Adversary.corrupt, TN.sample_z_noise = attack, sample
    compression.K = probe
    dist.barrier()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        state, m = step(state, batch, mask)
        torch.cuda.synchronize()
    finally:
        compression.Pipeline.encode_range = enc
        compression.Pipeline.decode_sum = dec
        TA.Adversary.corrupt, TN.sample_z_noise = corrupt, draw
        compression.K = ops
    sec = time.perf_counter() - t0 - seen["check_s"]
    after = _counts()
    peak = max(probe.peak, seen["peak"], torch.cuda.max_memory_allocated())
    outside, differing, off = _shard_params_vs_one(
        state.params, os.path.join(tmp, f"{label}_{tag}_params.pt"), arch,
        grid, plan, layout, dev)
    rec = {"sec": sec, "loss": float(m.loss), "peak": peak,
           "uplink_bits": float(m.uplink_bits),
           "counts": {k: after[k] - before[k] for k in after},
           "collective_bytes": hints.collective_totals(0),
           "collective_by_use": {k: list(v) for k, v in
                                 hints.COLLECTIVES.items()},
           "vs_plain": probe.seen, "client": client,
           "params_outside_rtol": outside, "params_off_coords": off,
           "params_differing": differing,
           **{k: v for k, v in seen.items() if k not in ("check_s", "peak")},
           "check_s": seen["check_s"]}
    del state, batch, m
    _free()
    dist.barrier()
    return rec


def _shard_setup(rank, world, store, pool):
    """A rank of the 2 x 2 grid (four ranks share cuda:0), once for every
    sharded path: joins the gloo group and makes the grid. -> (the grid,
    the shared row pool)."""
    import datetime
    os.environ["LOCAL_RANK"] = str(rank)
    # four ranks share the card: cached blocks that fit no later request
    # would hold several GB a rank (before this process touches the card)
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.launch.mesh import make_replica_grid
    grid = make_replica_grid(
        SHARD_GRID, SHARD_AXES, device_type=DEV.type,
        init_method=f"file://{store}", rank=rank,
        timeout=datetime.timedelta(seconds=SHARD_TIMEOUT_S))
    return grid, pool


def _shard_rank(rank, world, ctx, label, arch_id, layers, rounds, seq,
                gbatch, tmp, spans, out):
    """One path on a rank of the 2 x 2 grid (``_shard_setup``'s ``ctx``):
    builds the dry run's train cell (``dryrun.build_train_cell``), takes
    its shards of the seed-0 weights, runs the rounds and writes its record
    to ``out.format(rank)``. ``spans`` places each one-process row in the
    shared pool: {(round, client): (first element, length)}."""
    import torch.distributed as dist
    from repro_torch.core import compression, wire
    from repro_torch.core import fedavg as TF
    from repro_torch.core import noise as TN
    from repro_torch.core.tree import tree_paths
    from repro_torch.kernels.zsign import ops
    from repro_torch.launch import dryrun, hints
    from repro_torch.models.api import shard_params
    grid, pool = ctx
    rows = {k: pool[a:a + n] for k, (a, n) in spans.items()}
    # every rank of the one-card machine computes on cuda:0
    dev = DEV
    arch = _shard_arch(arch_id, layers)
    step, example, plan = dryrun.build_train_cell(
        arch, _shard_shape(seq, gbatch), grid)
    full = _shard_init(arch, dev)
    shards = shard_params(full, arch.model, grid, plan, device=dev)
    del full
    _free()
    state = TF.init_server_state(shards, example["fcfg"], example["comp"],
                                 TN.prng_key(1))
    layout = step.layout(shards)
    # the state holds the params: nothing else may keep them past the
    # rounds (the EF round below measures its own peak)
    del shards
    lo, hi = layout.bounds
    d = layout.spec.n_coords
    one_bytes = torch.load(os.path.join(tmp, label + "_bytes.pt"))
    row = grid.index(plan.client_axes)
    seen = {"t": 0, "g": 0, "flips": [], "pg": [], "check_s": 0.0,
            "peak": 0}
    enc = compression.Pipeline.encode_range

    def encode_range(self, keys, x2d, tile0, sigma=None, **kw):
        got = enc(self, keys, x2d, tile0, sigma=sigma, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        # the check's own buffers are kept out of the rank's peak
        seen["peak"] = max(seen["peak"], torch.cuda.max_memory_allocated())
        client = seen["g"] * plan.n_clients + row
        seen["g"] += 1
        seen["pg"].append({"t": seen["t"], "client": client,
                           **_range_vs_row(x2d[0], rows[(seen["t"], client)],
                                           lo, min(hi, d), layout.spec)})
        want = one_bytes[f"{seen['t']}_{client}"][lo // 8:hi // 8].to(dev)
        diff = got[0] ^ want
        nz = torch.nonzero(diff).reshape(-1)
        bits = torch.nonzero((diff[nz].unsqueeze(-1) >> torch.arange(
            8, device=dev, dtype=torch.uint8)) & 1)
        coords = nz[bits[:, 0]] * 8 + bits[:, 1]
        coords = coords[coords < d - lo]
        seen["flips"].append({"t": seen["t"], "client": client,
                              "coords": (coords + lo).cpu(),
                              "vals": x2d[0, coords].cpu(),
                              "sent": min(hi, d) - lo})
        del diff, nz, bits, coords, want
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        # every rank waits here for the slowest check, so no rank's round
        # time holds another's
        dist.barrier()
        seen["check_s"] += time.perf_counter() - t0
        return got

    _free()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    per, peak = [], 0
    compression.Pipeline.encode_range = encode_range
    try:
        for t in range(rounds):
            seen.update(t=t, g=0, check_s=0.0)
            batch = _shard_batch(plan, arch.model, seq, t, dev)
            mask = torch.ones((plan.client_groups, plan.n_clients))
            hints.reset_collective_stats()
            wire.reset_reduce_stats()
            before = _counts()
            probe = _RangePlainProbe(ops) if t == 0 else None
            if probe is not None:
                compression.K = probe
            dist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                state, m = step(state, batch, mask)
                torch.cuda.synchronize()
            finally:
                compression.K = ops
            # the host reads of this check are not the round's
            sec = time.perf_counter() - t0 - seen["check_s"]
            after = _counts()
            if probe is not None:
                peak = max(peak, probe.peak)
            per.append({
                "sec": sec, "loss": float(m.loss),
                "counts": {k: after[k] - before[k] for k in after},
                "collective_bytes": hints.collective_totals(0),
                "collective_calls": hints.collective_totals(1),
                "collective_s": hints.collective_totals(2),
                "collective_by_use": {k: list(v) for k, v in
                                      hints.COLLECTIVES.items()},
                "reduce": dict(wire.REDUCE_STATS),
                "vs_plain": None if probe is None else probe.seen})
    finally:
        compression.Pipeline.encode_range = enc
    peak = max(peak, seen["peak"], torch.cuda.max_memory_allocated())
    del batch, m, probe
    group_params = ({p: v.clone() for p, v in tree_paths(state.params)}
                    if label == SHARD_STREAM_PATH else None)
    outside, differing, off = _shard_params_vs_one(
        state.params, os.path.join(tmp, label + "_params.pt"), arch, grid,
        plan, layout, dev)
    import resource
    rec = {"rank": rank, "coords": dict(grid.coords),
           # the process's peak over this path and the ones before it
           "host_max_rss_GB": resource.getrusage(
               resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9,
           "backend": dist.get_backend(),
           "device": str(dev), "bounds": [lo, hi], "d": d, "peak": peak, "rounds": per,
           "flips": seen["flips"], "pg_vs_one_process": seen["pg"],
           "params_outside_rtol": outside, "params_off_coords": off,
           "params_differing": differing,
           "shard_bytes": sum(v.numel() * v.element_size()
                              for _, v in tree_paths(state.params))}
    del state
    _free()
    if label == SHARD_EF_PATH:
        rec["ef"] = _shard_ef_round(grid, arch, seq, gbatch, dev, rows)
        rec["specs"] = {tag: _shard_spec_round(grid, arch, seq, gbatch, dev,
                                               tmp, label, tag, spec, adv)
                        for tag, spec, adv in SHARD_SPEC_ROUNDS}
    if label in SHARD_SERVE:
        rec["serve"] = _shard_serve(grid, arch, dev, tmp, label)
    if label == SHARD_MAMBA_PATH:
        rec["mamba"] = _shard_mamba(grid, dev, tmp)
        rec["mamba_decode"] = _shard_mamba_decode(grid, dev, tmp)
    if label == SHARD_STREAM_PATH:
        rec["stream"] = _shard_stream_round(grid, arch, seq, gbatch, dev,
                                            group_params)
    torch.save(rec, out.format(rank))
    dist.barrier()


def _shard_stream_round(grid, arch, seq, gbatch, dev, want):
    """The path's round 0 again on this rank, from the seed-0 weights and
    round 0's tokens, under SHARD_STREAM_COHORT (``fedavg.
    build_sharded_round_step``'s stream plan: each shard's clients encoded
    over the range at once, folded into one running range accumulator)
    -> its time, launches, ``shard_clients``, loss, collective bytes by
    use, and the params entries whose bits differ from the group round's
    (``want``)."""
    import torch.distributed as dist
    from repro_torch.core import fedavg as TF
    from repro_torch.core import noise as TN
    from repro_torch.core.tree import tree_paths
    from repro_torch.launch import dryrun, hints
    from repro_torch.models.api import shard_params
    step, example, plan = dryrun.build_train_cell(
        arch, _shard_shape(seq, gbatch), grid, cohort=SHARD_STREAM_COHORT)
    full = _shard_init(arch, dev)
    shards = shard_params(full, arch.model, grid, plan, device=dev)
    del full
    state = TF.init_server_state(shards, example["fcfg"], example["comp"],
                                 TN.prng_key(1))
    del shards
    batch = _shard_batch(plan, arch.model, seq, 0, dev)
    mask = torch.ones((plan.client_groups, plan.n_clients))
    hints.reset_collective_stats()
    torch.cuda.reset_peak_memory_stats()
    before = _counts()
    dist.barrier()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, m = step(state, batch, mask)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    after = _counts()
    differing = sum(int((a.reshape(-1) != want[p].reshape(-1)).sum())
                    if not _same_bits(a, want[p]) else 0
                    for p, a in tree_paths(state.params))
    return {"sec": sec, "counts": {k: after[k] - before[k] for k in after},
            "shard_clients": int(m.shard_clients), "loss": float(m.loss),
            "groups": plan.client_groups,
            "peak": torch.cuda.max_memory_allocated(),
            "collective_by_use": {k: list(v) for k, v in
                                  hints.COLLECTIVES.items()},
            "params_differing": differing,
            "params_same_bits": all(_same_bits(a, want[p]) for p, a in
                                    tree_paths(state.params))}


def _shard_stream_checks(label, ranks, smi):
    """The forced stream round of SHARD_STREAM_PATH's ranks: params
    bit-identical to the group round's on every rank, E1 and R1 (add mode)
    once a shard, ``shard_clients`` the shard, the loss within rtol 1e-6
    and the collective bytes by use equal to the group round's (a shard of
    one client a group runs the group round's per-client collectives). ->
    its summary for the kernels line."""
    for rk in ranks:
        st, r = rk["stream"], rk["rank"]
        n = st["groups"]
        want = {"zsign_encode": n, "zsign_encode_range": n,
                "sign_reduce": n, "sign_reduce_fold": 0, "ef_sign": 0}
        got = {k: st["counts"][k] for k in want}
        if got != want:
            raise AssertionError(f"{label}_stream: rank {r} launched {got}, "
                                 f"want {want}")
        if not st["params_same_bits"]:
            raise AssertionError(f"{label}_stream: rank {r}: "
                                 f"{st['params_differing']} params entries "
                                 f"off the group round's bits")
        if st["shard_clients"] != 1 or abs(
                st["loss"] - rk["rounds"][0]["loss"]) > 1e-6 * abs(
                rk["rounds"][0]["loss"]):
            raise AssertionError(f"{label}_stream: rank {r}: shard_clients "
                                 f"{st['shard_clients']}, loss {st['loss']}"
                                 f" against {rk['rounds'][0]['loss']}")
        group = {k: v[0] for k, v in rk["rounds"][0][
            "collective_by_use"].items()}
        if {k: v[0] for k, v in st["collective_by_use"].items()} != group:
            raise AssertionError(f"{label}_stream: rank {r} moved "
                                 f"{st['collective_by_use']}, the group "
                                 f"round {group}")
    print(json.dumps({
        "sharded_replica": label + "_stream", "card": smi,
        "cohort": SHARD_STREAM_COHORT,
        "round_s": {"group": [rk["rounds"][0]["sec"] for rk in ranks],
                    "stream": [rk["stream"]["sec"] for rk in ranks]},
        "launches": [rk["stream"]["counts"] for rk in ranks],
        "params_differing": [rk["stream"]["params_differing"]
                             for rk in ranks],
        "peak_GB": [rk["stream"]["peak"] / 1e9 for rk in ranks],
        "loss": [rk["stream"]["loss"] for rk in ranks]}))
    summed = {k: sum(rk["stream"]["counts"][k] for rk in ranks)
              for k in ranks[0]["stream"]["counts"]}
    return {label + "_stream": {
        "launches": summed,
        "secs": [max(rk["stream"]["sec"] for rk in ranks)],
        "peak": max(rk["stream"]["peak"] for rk in ranks)}}


def _serve_shapes(label):
    """(prefill ShapeCfg or None, decode ShapeCfg) of SHARD_SERVE[label]."""
    from repro_torch.configs.common import ShapeCfg
    pre, batch, slots, _ = SHARD_SERVE[label]
    return (None if pre is None else
            ShapeCfg(f"chip_prefill_{pre[1]}", "prefill", pre[1], pre[0]),
            ShapeCfg(f"chip_decode_{slots}", "decode", slots, batch))


def _serve_tokens(batch, seq, vocab, seed):
    """(batch, seq) int32 tokens below ``vocab`` from a CPU generator of
    ``seed`` (the same in every process)."""
    return torch.randint(0, vocab, (batch, seq), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(seed))


def _rel_l2(got, want) -> float:
    g, w = got.double(), want.double()
    return float(torch.linalg.vector_norm(g - w) /
                 torch.linalg.vector_norm(w).clamp_min(1e-300))


def _serve_inputs(cfg, pre, dec):
    """(the prefill cell's input, the enc-dec's decode memory frames or
    None), on the CPU, the same in every process: the prefill's tokens or,
    for the enc-dec, its seq // 2 f32 frames; the decode memory's
    ENCDEC_SRC_LEN f32 frames of every row."""
    from repro_torch.models.api import ENCDEC_SRC_LEN
    gen = torch.Generator().manual_seed(SERVE_FRAME_SEED)
    frames = None
    if cfg.family == "encdec":
        x = None if pre is None else torch.randn(
            (pre.global_batch, pre.seq_len // 2, cfg.d_model), generator=gen)
        frames = torch.randn((dec.global_batch, ENCDEC_SRC_LEN, cfg.d_model),
                             generator=gen)
    else:
        x = None if pre is None else _serve_tokens(
            pre.global_batch, pre.seq_len, cfg.vocab, 7)
    return x, frames


def _tree_bytes(tree) -> int:
    from repro_torch.core.tree import tree_leaves
    return sum(v.numel() * v.element_size() for v in tree_leaves(tree))


def _row_blocks(n_rows):
    """The rows of each `data` rank of the 2 x 2 grid: the blocks a
    cache's batch dimension splits into (``cache_specs`` cuts it over
    `data` on both plans)."""
    n = SHARD_GRID[SHARD_AXES.index("data")]
    per = n_rows // n
    return [slice(i * per, (i + 1) * per) for i in range(n)]


def _row_dims(arch, dec):
    """{cache leaf path: its batch dimension} of SHARD_SERVE's decode
    cache: the dimension ``cache_specs`` cuts over `data`."""
    from repro_torch.core.tree import tree_paths
    from repro_torch.launch import sharding as SH
    from repro_torch.models.api import ENCDEC_SRC_LEN, build_model
    plan = SH.make_plan(arch, dec, _GridShape())
    meta = build_model(arch.model).init_cache(dec.global_batch, dec.seq_len,
                                              device="meta")
    cspecs = SH.cache_specs(meta, plan, batch=dec.global_batch,
                            seq_lens=(dec.seq_len, ENCDEC_SRC_LEN))
    return {p: next(d for d, a in SH.spec_dims(sp) if a == ("data",))
            for p, sp in tree_paths(cspecs)}


def _serve_one(label, arch_id, layers, tmp):
    """SHARD_SERVE's one-process prefill and greedy decode on the card,
    from the path's seed-0 weights through the bundle's entry points: the
    prefill's output (the last token's logits; the enc-dec's memory frame;
    under ``hints.seq_shard_view``, the grid's MoE capacity), the enc-dec's
    memory filled (``prefill_cache``), each decode step's logits and argmax
    and the final cache; ms a step (after the warm-up step) and the
    warm-up's. For SERVE_ROW_SPLIT each runs over each `data` rank's rows
    alone (``_row_blocks``), as the grid's ranks run them, and a step's
    time is the blocks' together. The output, logits, argmax, top-2 logit
    gaps, the tokens the grid is fed and the cache are written to ``tmp``
    for the checks. -> the record."""
    from repro_torch.core.tree import tree_map, tree_paths, tree_set
    from repro_torch.launch import hints
    from repro_torch.models import encdec
    from repro_torch.models.api import build_model
    arch = _shard_arch(arch_id, layers)
    bundle = build_model(arch.model)
    cfg = arch.model
    pre, dec = _serve_shapes(label)
    steps = SHARD_SERVE[label][3]
    params = _shard_init(arch, DEV)
    x, frames = _serve_inputs(cfg, pre, dec)
    B = dec.global_batch

    def blocks(n):
        return _row_blocks(n) if label in SERVE_ROW_SPLIT else [slice(0, n)]

    _free()
    torch.cuda.reset_peak_memory_stats()
    before = _counts()
    out = {"steps": steps}
    prefill = None
    if pre is not None:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        # the grid's MoE capacity, counted per sequence shard
        with hints.seq_shard_view(SHARD_SEQ_SHARDS):
            prefill = [bundle.prefill(params, x[rows].to(DEV))
                       for rows in blocks(x.shape[0])]
        torch.cuda.synchronize()
        out["prefill_s"] = time.perf_counter() - t0
        prefill = torch.cat([p.cpu() for p in prefill])
    rows_of = blocks(B)
    caches = [bundle.init_cache(rows.stop - rows.start, dec.seq_len, DEV)
              for rows in rows_of]
    if frames is not None:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for rows, cache in zip(rows_of, caches):
            encdec.prefill_cache(params, cache, frames[rows].to(DEV), cfg)
        torch.cuda.synchronize()
        out["fill_s"] = time.perf_counter() - t0
    tok = _serve_tokens(B, 1, cfg.vocab, 8)
    toks = [tok[rows].to(DEV) for rows in rows_of]
    logits, tokens, ms = [], [tok], []
    for t in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lgs = []
        for i in range(len(rows_of)):
            lg, caches[i] = bundle.decode_step(params, caches[i], toks[i], t)
            toks[i] = torch.argmax(lg[:, -1:], dim=-1).to(torch.int32)
            lgs.append(lg)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        logits.append(torch.cat([lg.cpu() for lg in lgs]))
        tokens.append(torch.cat([tk.cpu() for tk in toks]))
    out.update(peak=torch.cuda.max_memory_allocated(),
               counts=_counts(), counts_before=before,
               warmup_ms=ms[0], ms_per_step=sum(ms[1:]) / (steps - 1),
               cache_bytes=sum(_tree_bytes(c) for c in caches))
    if len(caches) == 1:
        cache = tree_map(lambda v: v.cpu(), caches[0])
    else:
        # the blocks' caches joined along each leaf's batch dimension
        cache, leaves = {}, [dict(tree_paths(c)) for c in caches]
        for path, dim in _row_dims(arch, dec).items():
            tree_set(cache, path, torch.cat([c[path].cpu() for c in leaves],
                                            dim=dim))
        del leaves
    del caches
    ref = {"logits": torch.stack(logits), "tokens": torch.cat(tokens, dim=1),
           "cache": cache}
    top2 = torch.topk(ref["logits"][:, :, -1], 2, dim=-1).values
    ref.update(argmax=torch.argmax(ref["logits"][:, :, -1], dim=-1).T,
               gaps=top2[..., 0] - top2[..., 1])
    if prefill is not None:
        torch.save({"tokens": x, "logits": prefill},
                   os.path.join(tmp, label + "_prefill.pt"))
    torch.save(ref, os.path.join(tmp, label + "_decode.pt"))
    del params, ref, logits
    _free()
    return out


def _serve_slices(spec, grid, shape):
    """This rank's index into a full tensor of ``shape`` under ``spec``."""
    from repro_torch.launch import sharding as SH
    idx = [slice(None)] * len(shape)
    for dim, axes in SH.spec_dims(spec):
        n = math.prod(grid.shape[a] for a in axes)
        per = shape[dim] // n
        i = grid.index(axes)
        idx[dim] = slice(i * per, (i + 1) * per)
    return tuple(idx)


def _shard_serve(grid, arch, dev, tmp, label):
    """SHARD_SERVE on this rank of the grid: the dry run's prefill and
    decode cells (``dryrun.build_prefill_cell``, ``build_decode_cell``)
    from this rank's shards of the seed-0 weights, beside the one-process
    run's files in ``tmp``. The prefill's output (the whole batch on every
    rank) against the one-process prefill's; the decode from this rank's
    slice of the family's initial cache (``models/api.shard_cache``; the
    enc-dec's memory filled on the grid by the cell's ``fill_cache``, each
    rank's frames into its own slots), fed the one-process tokens at every
    step (teacher-forced where they differ), each step's logits against
    the one-process step's, its own argmax beside the one-process token,
    its collective bytes; then every leaf of its cache slice against the
    one-process cache's slice. -> the record."""
    import torch.distributed as dist
    from repro_torch.core.tree import tree_map, tree_paths
    from repro_torch.launch import dryrun, hints
    from repro_torch.models.api import build_model, shard_cache, \
        shard_params
    t_all = time.perf_counter()
    pre, dec = _serve_shapes(label)
    steps = SHARD_SERVE[label][3]
    step, ex, plan = dryrun.build_decode_cell(arch, dec, grid)
    full = _shard_init(arch, dev)
    shards = shard_params(full, arch.model, grid, plan, device=dev)
    del full
    x, frames = _serve_inputs(arch.model, pre, dec)
    _free()
    torch.cuda.reset_peak_memory_stats()
    before = _counts()
    rec = {"rank": grid.rank, "coords": dict(grid.coords)}

    def by_use():
        return {k: list(v) for k, v in hints.COLLECTIVES.items()}

    def timed(fn):
        hints.reset_collective_stats()
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = fn()
        torch.cuda.synchronize()
        return got, time.perf_counter() - t0

    if pre is not None:
        prefill = dryrun.build_prefill_cell(arch, pre, grid)[0]
        one = torch.load(os.path.join(tmp, label + "_prefill.pt"))
        got, sec = timed(lambda: prefill(shards, one["tokens"].to(dev)))
        rec["prefill"] = {"sec": sec, "collective_by_use": by_use(),
                          "shape": list(got.shape),
                          "rel_l2": _rel_l2(got.cpu().float(),
                                            one["logits"].float()),
                          "digest": _digest(got.float().reshape(-1))}
        del got, one
    whole = build_model(arch.model).init_cache(dec.global_batch,
                                               dec.seq_len, dev)
    init = shard_cache(whole, ex["cache_specs"], grid, device=dev)
    del whole
    cache = tree_map(torch.clone, init)
    if frames is not None:
        _, sec = timed(lambda: ex["fill_cache"](shards, cache,
                                               frames.to(dev)))
        rec["fill"] = {"sec": sec, "collective_by_use": by_use()}
    one = torch.load(os.path.join(tmp, label + "_decode.pt"))
    per = []
    for t in range(steps):
        tok = one["tokens"][:, t:t + 1].to(dev)
        (lg, cache), sec = timed(lambda: step(shards, cache, tok, t))
        mine = torch.argmax(lg[:, -1], dim=-1).cpu()
        want = one["argmax"][:, t]
        per.append({"sec": sec, "collective_by_use": by_use(),
                    "rel_l2": _rel_l2(lg.cpu(), one["logits"][t]),
                    "max_abs_err": float((lg.cpu() - one["logits"][t])
                                         .abs().max()),
                    "differ": (mine != want).nonzero().reshape(-1).tolist(),
                    "digest": _digest(lg.reshape(-1))})
        del lg
    rec.update(steps=per, counts=_counts(), counts_before=before,
               peak=torch.cuda.max_memory_allocated(), cache={})
    specs = dict(tree_paths(ex["cache_specs"]))
    inits = dict(tree_paths(init))
    for path, v in tree_paths(cache):
        whole = one["cache"]
        for k in path:
            whole = whole[k]
        want = whole[_serve_slices(specs[path], grid, whole.shape)]
        if len(path) == 1 and path[0] in hints.SLOT_LEAVES:
            # the slots (dim 2) holding a written K/V
            written = int((v != 0).reshape(v.shape[0], v.shape[1],
                                           v.shape[2], -1).any(dim=3)
                          .any(dim=1).any(dim=0).sum())
        else:
            # the state's entries stepped off their initial values
            written = int((v != inits[path]).sum())
        rec["cache"][".".join(path)] = {
            "shape": list(v.shape), "bytes": v.numel() * v.element_size(),
            "rel_l2": _rel_l2(v.cpu().float(), want.float()),
            "written": written}
    del cache, init, shards, one
    _free()
    dist.barrier()
    rec["total_s"] = time.perf_counter() - t_all
    return rec


def _serve_predict(arch_id, layers, label, rank):
    """``dryrun.analyze_serving`` of SHARD_SERVE[label]'s prefill and
    decode cells for ``rank`` of a fake 2 x 2 group (meta tensors), in a
    process of the predictions pool. -> (prefill record or None, decode
    record)."""
    import torch.distributed as dist
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_replica_grid
    arch = _shard_arch(arch_id, layers)
    pre, dec = _serve_shapes(label)
    dryrun.fake_group(SHARD_RANKS, rank)
    try:
        grid = make_replica_grid(SHARD_GRID, SHARD_AXES, device_type="cpu")
        out = []
        for shape, build in ((pre, dryrun.build_prefill_cell),
                             (dec, dryrun.build_decode_cell)):
            if shape is None:
                out.append(None)
                continue
            step, ex, _ = build(arch, shape, grid)
            out.append(dryrun.analyze_serving(step, ex, grid, arch_id))
        return tuple(out)
    finally:
        dist.destroy_process_group()


def _serve_limits(label) -> dict:
    """SHARD_SERVE[label]'s limits: relative L2 of the prefill, the decode
    logits and the cache against one process, and the top-2 gap margin
    (SERVE_REL_L2 and SERVE_GAP_MARGIN unless SERVE_LIMITS_BY_PATH says
    otherwise)."""
    out = {"prefill": SERVE_REL_L2, "decode": SERVE_REL_L2,
           "cache": SERVE_REL_L2, "gap": SERVE_GAP_MARGIN}
    out.update(SERVE_LIMITS_BY_PATH.get(label, {}))
    return out


def _shard_serve_checks(label, one, ranks, predicted, smi, tmp):
    """The checks of SHARD_SERVE[label] on the grid, and its JSON line: no
    kernel launched; each rank's collective bytes, by kind and use, of the
    prefill and of every decode step equal to the dry run's cells for that
    rank, and the enc-dec's memory fill gathering no memory; the outputs
    the same bits on every rank and within the path's limits
    (``_serve_limits``) of the one-process run's (prefill and every step);
    the grid's greedy token the one-process token at every step where the
    one-process top-2 gap exceeds the path's margin; each leaf of each
    rank's cache slice of the ``cache_specs`` shard's shape and bytes,
    within the path's limit of the one-process cache's slice, with written
    slots (or stepped state) on every rank."""
    from repro_torch.core.tree import tree_paths
    from repro_torch.launch import sharding as SH
    from repro_torch.models.api import ENCDEC_SRC_LEN, build_model
    pre, dec = _serve_shapes(label)
    lim = _serve_limits(label)
    arch = _shard_arch(*next((p[1], p[2]) for p in SHARD_PATHS
                             if p[0] == label))
    cfg = arch.model
    plan = SH.make_plan(arch, dec, _GridShape())
    meta = build_model(cfg).init_cache(dec.global_batch, dec.seq_len,
                                       device="meta")
    cspecs = SH.cache_specs(meta, plan, batch=dec.global_batch,
                            seq_lens=(dec.seq_len, ENCDEC_SRC_LEN))
    metas = {".".join(p): v for p, v in tree_paths(meta)}
    specs = {".".join(p): v for p, v in tree_paths(cspecs)}
    gaps = torch.load(os.path.join(tmp, label + "_decode.pt"))["gaps"]
    if one["counts"] != one["counts_before"]:
        raise AssertionError(f"{label} serve: one process launched "
                             f"kernels {one['counts']}")
    worst = {"prefill": 0.0, "decode": 0.0, "cache": 0.0, "abs": 0.0}
    forced = 0
    for rk in ranks:
        r, sv = rk["rank"], rk["serve"]
        p_pre, p_dec = predicted[r]
        if sv["counts"] != sv["counts_before"]:
            raise AssertionError(f"{label} serve: rank {r} launched kernels")
        if pre is not None:
            got = {k: v[0] for k, v in sv["prefill"]["collective_by_use"]
                   .items()}
            if got != p_pre["collectives_by_use"]:
                raise AssertionError(f"{label} prefill: rank {r} moved {got}"
                                     f", the dry run counts "
                                     f"{p_pre['collectives_by_use']}")
            if sv["prefill"]["digest"] != ranks[0]["serve"]["prefill"][
                    "digest"]:
                raise AssertionError(f"{label} prefill: rank {r}'s output "
                                     "differs from rank 0's")
            worst["prefill"] = max(worst["prefill"], sv["prefill"]["rel_l2"])
        if "fill" in sv and any("mem" in k for k in
                                sv["fill"]["collective_by_use"]):
            raise AssertionError(f"{label} fill: rank {r} gathered the "
                                 f"memory: {sv['fill']['collective_by_use']}")
        for t, st in enumerate(sv["steps"]):
            got = {k: v[0] for k, v in st["collective_by_use"].items()}
            if got != p_dec["collectives_by_use"]:
                raise AssertionError(f"{label} decode: rank {r} step {t} "
                                     f"moved {got}, the dry run counts "
                                     f"{p_dec['collectives_by_use']}")
            if st["digest"] != ranks[0]["serve"]["steps"][t]["digest"]:
                raise AssertionError(f"{label} decode: rank {r} step {t}: "
                                     "logits differ from rank 0's")
            for b in st["differ"]:
                if float(gaps[t, b]) > lim["gap"]:
                    raise AssertionError(
                        f"{label} decode: step {t} row {b}: greedy token "
                        f"off the one-process token at a top-2 gap of "
                        f"{float(gaps[t, b])} (margin {lim['gap']})")
            if r == 0:
                forced += len(st["differ"])
            worst["decode"] = max(worst["decode"], st["rel_l2"])
            worst["abs"] = max(worst["abs"], st["max_abs_err"])
        if set(sv["cache"]) != set(metas):
            raise AssertionError(f"{label} cache: rank {r} holds "
                                 f"{sorted(sv['cache'])}")
        for k, c in sv["cache"].items():
            want = SH.shard_shape(tuple(metas[k].shape), specs[k],
                                  _GridShape())
            if tuple(c["shape"]) != want or c["bytes"] != math.prod(
                    want) * metas[k].element_size():
                raise AssertionError(f"{label} cache {k}: rank {r} holds "
                                     f"{c['shape']}, cache_specs' shard is "
                                     f"{want}")
            if c["written"] == 0:
                raise AssertionError(f"{label} cache {k}: rank {r} has no "
                                     "written slot or stepped state")
            worst["cache"] = max(worst["cache"], c["rel_l2"])
    for key in ("prefill", "decode", "cache"):
        if not worst[key] <= lim[key]:
            raise AssertionError(f"{label} serve: {key} relative L2 "
                                 f"{worst[key]} off one process (limit "
                                 f"{lim[key]})")
    secs = [[st["sec"] for st in rk["serve"]["steps"]] for rk in ranks]
    step_s = [max(x) for x in zip(*secs)]
    line = {
        "sharded_serve": label, "card": smi,
        "grid": dict(zip(SHARD_AXES, SHARD_GRID)), "backend": "gloo",
        "prefill": None if pre is None else {
            "global_batch": pre.global_batch, "seq": pre.seq_len,
            "s_ranks": [rk["serve"]["prefill"]["sec"] for rk in ranks],
            "s_one_process": one["prefill_s"],
            "rel_l2": worst["prefill"],
            "collectives_by_use": ranks[0]["serve"]["prefill"][
                "collective_by_use"]},
        "fill": None if "fill" not in ranks[0]["serve"] else {
            "s_ranks": [rk["serve"]["fill"]["sec"] for rk in ranks],
            "s_one_process": one["fill_s"],
            "collectives_by_use": ranks[0]["serve"]["fill"][
                "collective_by_use"]},
        "decode": {"batch": dec.global_batch, "cache_slots": dec.seq_len,
                   "steps": one["steps"],
                   "cache_specs": {k: list(v) for k, v in specs.items()},
                   "ms_per_step": 1e3 * sum(step_s[1:]) / (len(step_s) - 1),
                   "warmup_step_ms": 1e3 * step_s[0],
                   "one_process_ms_per_step": one["ms_per_step"],
                   "one_process_warmup_ms": one["warmup_ms"],
                   "logits_rel_l2": worst["decode"],
                   "logits_max_abs_err": worst["abs"],
                   "teacher_forced_tokens": forced,
                   "tokens_held_above_margin": int(
                       (gaps > lim["gap"]).sum()),
                   "tokens": int(gaps.numel()),
                   "min_gap_one_process": float(gaps.min()),
                   "collectives_by_use_step": ranks[0]["serve"]["steps"][-1][
                       "collective_by_use"]},
        "cache": {"rel_l2": worst["cache"],
                  "rank_bytes": [sum(c["bytes"] for c in rk["serve"][
                      "cache"].values()) for rk in ranks],
                  "one_process_bytes": one["cache_bytes"],
                  "written": [{k: c["written"] for k, c in
                               rk["serve"]["cache"].items()}
                              for rk in ranks]},
        "limits": lim,
        "peak_GB": {"one_process": one["peak"] / 1e9,
                    "ranks": [rk["serve"]["peak"] / 1e9 for rk in ranks],
                    "dry_run_decode": [p[1]["peak_bytes"] / 1e9
                                       for p in predicted]}}
    print(json.dumps(line))
    return line


def _mamba_inputs(dev):
    """SHARD_MAMBA's sublayer: seed-0 weights (``mamba_init``, bf16; a_log
    and d_skip f32), the input x and the upstream gradient dy, (B, T, D)
    bf16, the same in every process."""
    from repro_torch.models import mamba as M
    D, B, T = (SHARD_MAMBA["d_model"], SHARD_MAMBA["batch"],
               SHARD_MAMBA["seq"])
    gen = torch.Generator(device=dev).manual_seed(0)
    lp = {k: v[0] for k, v in M.mamba_init(gen, D, 1, torch.bfloat16,
                                           dev).items()}
    x = torch.randn((B, T, D), generator=gen, device=dev).to(torch.bfloat16)
    dy = torch.randn((B, T, D), generator=gen, device=dev).to(
        torch.bfloat16)
    return lp, x, dy


def _mamba_one(tmp):
    """SHARD_MAMBA's sublayer in this process without a grid: forward and
    backward of dy, three passes (host clock, synchronized): a warm-up,
    then with its scan chunks rematerialized (the default; its output,
    input gradient and weight gradients written to ``tmp`` for the ranks)
    and without, each with its peak. Gate: the two passes' results
    bit-identical. -> its record."""
    from repro_torch.launch import hints
    from repro_torch.models import mamba as M
    _free()
    lp, x, dy = _mamba_inputs(DEV)
    names = sorted(lp)
    for v in lp.values():
        v.requires_grad_(True)
    x.requires_grad_(True)

    def run(remat):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with hints.remat_mode(remat):
            y = M.mamba_block(x, lp, d_model=SHARD_MAMBA["d_model"])
            grads = torch.autograd.grad(y, [x] + [lp[k] for k in names], dy)
        torch.cuda.synchronize()
        return ([y.detach()] + list(grads), time.perf_counter() - t0,
                torch.cuda.max_memory_allocated())

    warm = run(False)[1]
    outs, sec, peak = run(True)
    outs = [t.cpu() for t in outs]
    torch.save({"y": outs[0], "dx": outs[1],
                "dw": dict(zip(names, outs[2:]))},
               os.path.join(tmp, "mamba_one.pt"))
    outs_off, sec_off, peak_off = run(False)
    same = all(_same_bits(a.to(DEV), b) for a, b in zip(outs, outs_off))
    n_w = sum(v.numel() for v in lp.values())
    del lp, x, dy, outs, outs_off
    _free()
    if not same:
        raise AssertionError("mamba at Jamba's width: the remat and no-remat "
                             "passes differ")
    return {"sec": sec, "warmup_sec": warm, "peak": peak,
            "sec_no_remat": sec_off, "peak_no_remat": peak_off,
            "weights": n_w}


def _cut(v, spec, grid):
    """This rank's shard of ``v`` under ``spec`` on ``grid``."""
    from repro_torch.launch import sharding as SH
    for d, axes in SH.spec_dims(spec):
        n = SH.axis_size(grid, axes)
        c = v.shape[d] // n
        v = v.narrow(d, grid.index(axes) * c, c)
    return v


def _shard_mamba(grid, dev, tmp):
    """SHARD_MAMBA's sublayer on a rank of the 2 x 2 grid under the big
    plan's hints (the hybrid path's plan: the sequence over `model`, the
    batch over `data`, the replica over both): its weights stored as the
    plan's (1, ...) shards and gathered (``hints.fsdp_gather``), this
    rank's (batch, sequence) slice of x and dy, forward and backward
    through the channel-parallel ``mamba_block``, two passes: with its
    scan chunks rematerialized (the default; its time holds the first
    call's warm-up) and without, each with its peak; the remat pass's
    results against the one-process run's (``_mamba_one``, read from
    ``tmp``) by relative L2, and against the other pass's bits. -> its
    record."""
    import torch.distributed as dist
    from repro_torch.launch import hints
    from repro_torch.launch import sharding as SH
    from repro_torch.models import mamba as M
    D, B, T = (SHARD_MAMBA["d_model"], SHARD_MAMBA["batch"],
               SHARD_MAMBA["seq"])
    arch = _shard_arch(*next((p[1], p[2]) for p in SHARD_PATHS
                             if p[0] == SHARD_MAMBA_PATH))
    plan = SH.make_plan(arch, _shard_shape(T, B), _GridShape())
    lp, x, dy = _mamba_inputs(dev)
    specs = SH.param_specs({"mamba": {k: (1,) + tuple(v.shape)
                                      for k, v in lp.items()}}, grid, plan)
    names = sorted(lp)
    shards = {k: _cut(lp[k][None], specs["mamba"][k], grid).contiguous()
              .requires_grad_(True) for k in names}
    del lp
    _free()

    def run(remat):
        torch.cuda.reset_peak_memory_stats()
        with hints.sharding_hints(grid, plan.seq_axes, plan.micro_axes,
                                  replica_axes=plan.replica_axes,
                                  specs=specs, remat=remat):
            hints.local_positions(B, T, dev)
            bounds = hints.batch_bounds(B), hints.seq_bounds(T)
            xs = hints.seq_shard(x).contiguous().requires_grad_(True)
            dys = hints.seq_shard(dy).contiguous()
            hints.reset_collective_stats()
            dist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            w = hints.fsdp_gather({k: v[0] for k, v in shards.items()},
                                  ("mamba",))
            y = M.mamba_block(xs, w, d_model=D)
            grads = torch.autograd.grad(
                y, [xs] + [shards[k] for k in names], dys)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            del w
        return ([y.detach()] + list(grads), sec,
                torch.cuda.max_memory_allocated(), bounds,
                {k: list(v) for k, v in hints.COLLECTIVES.items()})

    outs, sec, peak, ((b0, b1), (s0, s1)), by_use = run(True)
    outs_off, sec_off, peak_off, _, by_use_off = run(False)
    same = all(_same_bits(a, b) for a, b in zip(outs, outs_off))
    y, grads = outs[0], outs[1:]
    one = torch.load(os.path.join(tmp, "mamba_one.pt"))
    rel = {"y": _rel_l2(y, one["y"][b0:b1, s0:s1].to(dev)),
           "dx": _rel_l2(grads[0], one["dx"][b0:b1, s0:s1].to(dev))}
    for k, g in zip(names, grads[1:]):
        want = _cut(one["dw"][k][None], specs["mamba"][k], grid)
        rel["dw." + k] = _rel_l2(g, want.to(dev))
    return {"coords": dict(grid.coords), "rel_l2": rel, "sec": sec,
            "peak": peak, "sec_no_remat": sec_off,
            "peak_no_remat": peak_off, "remat_bit_identical": same,
            "by_use_equal_no_remat": {k: v[0] for k, v in by_use.items()}
            == {k: v[0] for k, v in by_use_off.items()},
            "shard_shapes": {k: list(v.shape) for k, v in shards.items()},
            "collective_by_use": by_use}


def _shard_mamba_checks(one, ranks, smi):
    """SHARD_MAMBA's gates: every rank's output rows, input gradient and
    weight shards' gradients within SHARD_MAMBA_REL_L2 of the one-process
    block's, and the bits of the rank's pass without remat, whose
    collectives by use are the remat pass's; the sublayer's collectives by
    use, the same on every rank."""
    D, B, T = (SHARD_MAMBA["d_model"], SHARD_MAMBA["batch"],
               SHARD_MAMBA["seq"])
    recs = [rk["mamba"] for rk in ranks]
    for r in recs:
        bad = {k: v for k, v in r["rel_l2"].items()
               if not v <= SHARD_MAMBA_REL_L2}
        if bad:
            raise AssertionError(f"mamba at Jamba's width on the grid, rank "
                                 f"{r['coords']}: {bad} above relative L2 "
                                 f"{SHARD_MAMBA_REL_L2}")
        if not (r["remat_bit_identical"] and r["by_use_equal_no_remat"]):
            raise AssertionError(f"mamba at Jamba's width on the grid, rank "
                                 f"{r['coords']}: the pass without remat "
                                 f"differs (bits {r['remat_bit_identical']}, "
                                 f"bytes {r['by_use_equal_no_remat']})")
    uses = {k: v[0] for k, v in recs[0]["collective_by_use"].items()}
    for r in recs[1:]:
        if {k: v[0] for k, v in r["collective_by_use"].items()} != uses:
            raise AssertionError("mamba at Jamba's width: the ranks' "
                                 "collective bytes differ")
    # the input gathered over `model` at (B / 2, T, D) bf16, the output
    # reduce-scattered to (B / 2, T / 2, D)
    want = {"all_gather:mamba_in": B // 2 * T * D * 2,
            "reduce_scatter:mamba_out": B // 2 * T // 2 * D * 2}
    if any(uses.get(k) != v for k, v in want.items()):
        raise AssertionError(f"mamba at Jamba's width: collectives {uses}, "
                             f"want {want}")
    print(json.dumps({
        "sharded_mamba": "jamba_width", "card": smi,
        "grid": dict(zip(SHARD_AXES, SHARD_GRID)), "d_model": D,
        "d_inner": 2 * D, "batch": B, "seq": T, "dtype": "bfloat16",
        "weights": one["weights"],
        "s": {"one_process": one["sec"], "one_process_warmup":
              one["warmup_sec"], "one_process_no_remat":
              one["sec_no_remat"], "ranks_first_pass": [r["sec"]
                                                       for r in recs],
              "ranks_no_remat": [r["sec_no_remat"] for r in recs]},
        "peak_GB": {"one_process": one["peak"] / 1e9,
                    "one_process_no_remat": one["peak_no_remat"] / 1e9,
                    "ranks": [r["peak"] / 1e9 for r in recs],
                    "ranks_no_remat": [r["peak_no_remat"] / 1e9
                                       for r in recs]},
        "rel_l2": [r["rel_l2"] for r in recs],
        "bound_rel_l2": SHARD_MAMBA_REL_L2,
        "shard_shapes": recs[0]["shard_shapes"],
        "collective_by_use": [r["collective_by_use"] for r in recs]}))


def _mamba_decode_inputs(dev):
    """SHARD_MAMBA_DECODE's sublayer: SHARD_MAMBA's seed-0 weights and
    ``steps`` one-token inputs of ``batch`` rows, (steps, B, 1, D) bf16
    N(0, 1), the same in every process."""
    lp = _mamba_inputs(dev)[0]
    B, n = SHARD_MAMBA_DECODE["batch"], SHARD_MAMBA_DECODE["steps"]
    gen = torch.Generator().manual_seed(11)
    xs = torch.randn((n, B, 1, SHARD_MAMBA["d_model"]), generator=gen)
    return lp, xs.to(device=dev, dtype=torch.bfloat16)


def _mamba_decode_one(tmp):
    """SHARD_MAMBA_DECODE in this process without a grid: ``steps`` calls
    of ``mamba_decode_step`` from a zero state over each `data` rank's rows
    alone (SERVE_ROW_SPLIT), each step timed over the blocks together (host
    clock, synchronized); the outputs and final state (the reference) are
    written to ``tmp`` for the ranks. -> its record."""
    from repro_torch.models import mamba as M
    D = SHARD_MAMBA["d_model"]
    B = SHARD_MAMBA_DECODE["batch"]
    _free()
    torch.cuda.reset_peak_memory_stats()
    lp, xs = _mamba_decode_inputs(DEV)
    blocks = _row_blocks(B)
    h = [torch.zeros((rows.stop - rows.start, 2 * D, M.D_STATE),
                     dtype=torch.float32, device=DEV) for rows in blocks]
    conv = [torch.zeros((rows.stop - rows.start, M.D_CONV - 1, 2 * D),
                        dtype=torch.float32, device=DEV) for rows in blocks]
    ys, secs = [], []
    with torch.no_grad():
        for x in xs:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            yb = []
            for i, rows in enumerate(blocks):
                y, h[i], conv[i] = M.mamba_decode_step(x[rows], lp, h[i],
                                                       conv[i], d_model=D)
                yb.append(y)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            ys.append(torch.cat([y.cpu() for y in yb]))
    ref = {"y": torch.stack(ys), "h": torch.cat([t.cpu() for t in h]),
           "conv": torch.cat([t.cpu() for t in conv])}
    torch.save(ref, os.path.join(tmp, "mamba_decode_one.pt"))
    peak = torch.cuda.max_memory_allocated()
    del lp, xs, h, conv
    _free()
    return {"secs": secs, "peak": peak}


def _shard_mamba_decode(grid, dev, tmp):
    """SHARD_MAMBA_DECODE on a rank of the 2 x 2 grid under the decode
    cell's serving hints on the big plan: the sublayer's weights stored as
    the plan's (1, ...) shards and gathered each step
    (``hints.fsdp_gather``), its state (1, B, d_inner, 16) and (1, B, 3,
    d_inner) cut by ``cache_specs`` (the rows over `data`, d_inner over
    `model`), this rank's rows of each step's input through
    ``mamba_decode_step``; each step's output rows and the final state
    slices against the one-process run's (``_mamba_decode_one``, read from
    ``tmp``) by relative L2. -> its record."""
    import torch.distributed as dist
    from repro_torch.configs.common import ShapeCfg
    from repro_torch.launch import hints
    from repro_torch.launch import sharding as SH
    from repro_torch.models import mamba as M
    from repro_torch.models.api import ENCDEC_SRC_LEN
    D = SHARD_MAMBA["d_model"]
    B, d_in = SHARD_MAMBA_DECODE["batch"], 2 * SHARD_MAMBA["d_model"]
    arch = _shard_arch(*next((p[1], p[2]) for p in SHARD_PATHS
                             if p[0] == SHARD_MAMBA_PATH))
    plan = SH.make_plan(arch, ShapeCfg("chip_mamba_decode", "decode", 8, B),
                        _GridShape())
    lp, xs = _mamba_decode_inputs(dev)
    specs = SH.param_specs({"mamba": {k: (1,) + tuple(v.shape)
                                      for k, v in lp.items()}}, grid, plan)
    shards = {k: _cut(lp[k][None], specs["mamba"][k], grid).contiguous()
              for k in sorted(lp)}
    del lp
    cshapes = {"h": (1, B, d_in, M.D_STATE),
               "conv": (1, B, M.D_CONV - 1, d_in)}
    seq_lens = (SHARD_MAMBA["seq"], ENCDEC_SRC_LEN)
    cspecs = SH.cache_specs(cshapes, plan, batch=B, seq_lens=seq_lens)
    state = {k: torch.zeros(SH.shard_shape(v, cspecs[k], grid),
                            dtype=torch.float32, device=dev)
             for k, v in cshapes.items()}
    _free()
    torch.cuda.reset_peak_memory_stats()
    one = torch.load(os.path.join(tmp, "mamba_decode_one.pt"))
    steps = []
    with torch.no_grad(), hints.serving_hints(
            grid, plan, specs, cache_specs=cspecs, cache_shapes=cshapes,
            batch=B, seq_lens=seq_lens):
        b0, b1 = hints.batch_bounds(B)
        lo, hi = hints.state_bounds(d_in)
        for t, x in enumerate(xs):
            hints.reset_collective_stats()
            dist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            w = hints.fsdp_gather({k: v[0] for k, v in shards.items()},
                                  ("mamba",))
            y, h, conv = M.mamba_decode_step(x[b0:b1], w, state["h"][0],
                                             state["conv"][0], d_model=D)
            state["h"][0], state["conv"][0] = h, conv
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            del w
            steps.append({"sec": sec, "rel_l2": _rel_l2(
                y.cpu(), one["y"][t][b0:b1]),
                "collective_by_use": {k: list(v) for k, v in
                                      hints.COLLECTIVES.items()}})
    rel = {"h": _rel_l2(state["h"][0].cpu(), one["h"][b0:b1, lo:hi]),
           "conv": _rel_l2(state["conv"][0].cpu(),
                           one["conv"][b0:b1, :, lo:hi])}
    return {"coords": dict(grid.coords), "steps": steps, "state_rel_l2": rel,
            "peak": torch.cuda.max_memory_allocated(),
            "rows": [b0, b1], "channels": [lo, hi],
            "cache_specs": {k: list(v) for k, v in cspecs.items()},
            "gathered_weight_bytes": sum(
                math.prod((1,) + tuple(v.shape[1:])) * v.element_size()
                * math.prod(SH.axis_size(grid, a) for _, a in
                            SH.spec_dims(specs["mamba"][k]))
                for k, v in shards.items()
                if SH.spec_dims(specs["mamba"][k]))}


def _shard_mamba_decode_checks(one, ranks, smi):
    """SHARD_MAMBA_DECODE's gates: every rank's output rows at every step
    and its final state slices the one-process bits (relative L2 0.0:
    every sum over channels is whole); each step's collectives by use the
    sublayer's gathered weights and its activations' gathers, B_loc x
    d_inner bf16 each."""
    B, n = SHARD_MAMBA_DECODE["batch"], SHARD_MAMBA_DECODE["steps"]
    d_in = 2 * SHARD_MAMBA["d_model"]
    recs = [rk["mamba_decode"] for rk in ranks]
    for r in recs:
        worst = max([st["rel_l2"] for st in r["steps"]]
                    + list(r["state_rel_l2"].values()))
        if not worst == 0.0:
            raise AssertionError(f"mamba decode at Jamba's width on the "
                                 f"grid, rank {r['coords']}: relative L2 "
                                 f"{worst} off one process (limit 0.0): "
                                 f"{r['steps']} {r['state_rel_l2']}")
        b_loc = r["rows"][1] - r["rows"][0]
        want = {"all_gather:weight": r["gathered_weight_bytes"],
                "all_gather:mamba_act": b_loc * d_in * 2,
                "all_gather:mamba_y": b_loc * d_in * 2}
        for st in r["steps"]:
            got = {k: v[0] for k, v in st["collective_by_use"].items()}
            if got != want:
                raise AssertionError(f"mamba decode at Jamba's width: rank "
                                     f"{r['coords']} moved {got}, want "
                                     f"{want}")
    step_s = [max(x) for x in zip(*[[st["sec"] for st in r["steps"]]
                                    for r in recs])]
    line = {"sharded_mamba_decode": "jamba_width", "card": smi,
            "grid": dict(zip(SHARD_AXES, SHARD_GRID)),
            "d_model": SHARD_MAMBA["d_model"], "d_inner": d_in, "batch": B,
            "steps": n, "dtype": "bfloat16",
            "cache_specs": recs[0]["cache_specs"],
            "ms_per_step": 1e3 * sum(step_s[1:]) / (n - 1),
            "warmup_step_ms": 1e3 * step_s[0],
            "one_process_ms_per_step": 1e3 * sum(one["secs"][1:]) / (n - 1),
            "one_process_warmup_ms": 1e3 * one["secs"][0],
            "rel_l2": 0.0, "limit": 0.0,
            "peak_GB": {"one_process": one["peak"] / 1e9,
                        "ranks": [r["peak"] / 1e9 for r in recs]},
            "collectives_by_use_step": {
                k: v for k, v in recs[0]["steps"][-1][
                    "collective_by_use"].items()}}
    print(json.dumps(line))
    return line


def _shard_params_vs_one(params, path, arch, grid, plan, layout, dev):
    """A rank's params against the one-process run's (saved at ``path``),
    shard by shard, in a frame of its own so that none of its copies
    outlives it -> (entries outside SHARD_RTOL, entries differing, the flat
    coordinates of those outside)."""
    from repro_torch.core.tree import tree_paths, tree_set
    from repro_torch.models.api import shard_params
    loaded = torch.load(path, mmap=True)
    tree = {}
    for k, v in loaded.items():
        tree_set(tree, tuple(k.split(".")), v)
    want = shard_params(tree, arch.model, grid, plan, device=dev)
    outside, differing, off = 0, 0, []
    for i, ((_, a), (_, b)) in enumerate(zip(tree_paths(params),
                                             tree_paths(want))):
        af, bf = a.float().reshape(-1), b.float().reshape(-1)
        far = torch.nonzero((af - bf).abs() > SHARD_RTOL * bf.abs())
        outside += far.numel()
        off.append(layout.flat_coords(i, far.reshape(-1)).cpu())
        differing += int((a != b).sum())
    return outside, differing, torch.cat(off)


def _shard_predict(arch_id, layers, seq, gbatch, rank, pipeline=None,
                   adversary="none"):
    """``dryrun.analyze`` of the same cell (with ``pipeline``, else the
    arch's codec) for ``rank`` of a fake 2 x 2 group (meta tensors, E1, R1
    and F1 stood in by their kernels' outputs, the card's route), in a
    process of its own (``phase_sharded_replica`` runs the four ranks' in a
    pool beside the one-process run)."""
    import torch.distributed as dist
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_replica_grid
    arch = _shard_arch(arch_id, layers)
    dryrun.fake_group(SHARD_RANKS, rank)
    try:
        grid = make_replica_grid(SHARD_GRID, SHARD_AXES, device_type="cpu")
        step, ex, _ = dryrun.build_train_cell(
            arch, _shard_shape(seq, gbatch), grid, pipeline=pipeline,
            agg_backend="cuda", encode_backend="cuda", adversary=adversary)
        return dryrun.analyze(step, ex, grid, arch_id)
    finally:
        dist.destroy_process_group()


def _shard_time_e1(dev, lo, hi):
    """E1 at a rank's range shape, (1, hi - lo) f32 with tile0 = lo / 8192:
    kernel and plain ms (CUDA events) beside the bound, bit-exact first."""
    from repro_torch.core import noise
    from repro_torch.kernels.zsign import ops
    n = hi - lo
    gen = torch.Generator(device=dev).manual_seed(21)
    x = torch.randn((1, n), generator=gen, device=dev) * 0.01
    keys = noise.client_keys(noise.prng_key(7), 0, 1)
    sig = torch.full((1,), 0.01, device=dev)
    t0 = lo // ops.TILE
    got = ops.zsign_encode(x, keys, sig, 1, t0)
    want = ops.zsign_encode_plain(x, keys, sig, 1, t0)
    torch.cuda.synchronize()
    nflip, far = ops.erf_rule_flips(x, keys, sig, 1, got, want, tile0=t0)
    if far:
        raise AssertionError(f"E1 (1, {n}) tile0 {t0}: {far} bits outside "
                             "the erf rule")
    del want
    ms = _time_ms(lambda: ops.zsign_encode(x, keys, sig, 1, t0), reps=10,
                  warmup=2)
    plain_ms = _time_ms(lambda: ops.zsign_encode_plain(x, keys, sig, 1, t0),
                        reps=1)
    bound, by = _bound(nbytes=n * 4 + n / 8 + 16 + 4,
                       ops=n / 4 * OPS_PER_COUNTER
                       + n * (OPS_PER_ELEM + ERF_OPS))
    del x, got
    _free()
    return {"shape": [1, n], "tile0": t0, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "bits_differing": nflip}


def _shard_time_f1(dev, lo, hi, d):
    """F1 at a rank's range shape: (1, hi - lo) f32 rows, the (1, real)
    residual in place and one scale, as the EF grid round runs it; kernel
    and plain ms (CUDA events) beside the bound, bit-exact first."""
    from repro_torch.kernels.efsign import ops as eops
    n, real = hi - lo, min(hi, d) - lo
    gen = torch.Generator(device=dev).manual_seed(23)
    g = torch.zeros((1, n), device=dev)
    g[:, :real] = torch.randn((1, real), generator=gen, device=dev) * 0.01
    e = torch.randn((1, real), generator=gen, device=dev) * 0.003
    scale = torch.full((1,), 0.008, device=dev)
    live = torch.ones((1,), device=dev)
    got = eops.ef_sign_rows(g, e, scale, live=live)
    want = eops.ef_sign_rows_plain(g, e, scale, live=live)
    torch.cuda.synchronize()
    if not (_same_bits(got[0], want[0]) and _same_bits(got[1], want[1])):
        raise AssertionError(f"F1 (1, {n}): differs from plain")
    del got, want
    _free()
    ms = _time_ms(lambda: eops.ef_sign_rows(g, e, scale, live=live,
                                            in_place=True), reps=10,
                  warmup=2)
    plain_ms = _time_ms(lambda: eops.ef_sign_rows_plain(
        g, e, scale, live=live, in_place=True), reps=1)
    # reads g and e, writes e' and the payload (and the scale, live flag)
    bound, by = _bound(nbytes=n * 4 + 2 * real * 4 + n / 8 + 8,
                       ops=n * EF_OPS_PER_ELEM)
    del g, e
    _free()
    return {"shape": [1, n], "residual": [1, real], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by}


def _shard_time_c1(dev, lo, hi, d):
    """C1 at a rank's range shape: (1, hi - lo) f32 rows and their z = 2
    noise (zero past d), as the z = 2 grid round runs it; kernel and plain
    ms (CUDA events) beside the bound, bytes equal first."""
    from repro_torch.core import noise
    from repro_torch.kernels.zsign import ops
    n, real = hi - lo, min(hi, d) - lo
    gen = torch.Generator(device=dev).manual_seed(29)
    x = torch.zeros((1, n), device=dev)
    x[:, :real] = torch.randn((1, real), generator=gen, device=dev) * 0.01
    nz = torch.zeros_like(x)
    nz[0, :real] = noise.sample_z_noise(noise.prng_key(9), (real,), 2,
                                        device=dev, lo=lo)
    sig = torch.full((1,), 0.01, device=dev)
    got = ops.zsign_compress_rows(x, nz, sig)
    want = ops.zsign_compress_rows_plain(x, nz, sig)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"C1 (1, {n}): bytes differ from plain")
    del got, want
    _free()
    ms = _time_ms(lambda: ops.zsign_compress_rows(x, nz, sig), reps=10,
                  warmup=2)
    plain_ms = _time_ms(lambda: ops.zsign_compress_rows_plain(x, nz, sig),
                        reps=2)
    bound, by = _bound(nbytes=2 * n * 4 + n / 8 + 4,
                       ops=n * COMPRESS_OPS_PER_ELEM)
    del x, nz
    _free()
    return {"shape": [1, n], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by}


def _shard_time_r1_vote(dev, lo, hi):
    """R1 at the median round's shape: the (2, (hi - lo) / 8) all-gathered
    range rows under a 0/1 mask, the vote pair's count; kernel and plain ms
    (CUDA events) beside the bound, int32 equal to the popcount route's
    first."""
    from repro_torch.core import wire
    from repro_torch.kernels.zsign import ops
    nb = (hi - lo) // 8
    gen = torch.Generator(device=dev).manual_seed(31)
    packed = torch.randint(0, 256, (2, nb), generator=gen, device=dev,
                           dtype=torch.uint8)
    mask = torch.ones((2,), device=dev)
    got = ops.sign_reduce(packed, mask).to(torch.int32)
    if not torch.equal(got, wire.vote_accumulator(packed, mask)[0]):
        raise AssertionError(f"R1 (2, {nb}): the vote count differs from "
                             "the popcount pair")
    del got
    _free()
    ms = _time_ms(lambda: ops.sign_reduce(packed, mask), reps=10, warmup=2)
    plain_ms = _time_ms(lambda: ops.sign_reduce_plain(packed, mask), reps=2)
    bound, by = _bound(nbytes=2 * nb + 8 * nb * 4 + 8, ops=0)
    del packed
    _free()
    return {"shape": [2, nb], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by}


def _shard_spec_checks(label, one, specs_one, rows, ranks, predicted, smi):
    """The checks of SHARD_SPEC_ROUNDS inside ``label``'s ranks, a JSON
    line each, and their summaries for the kernels line: each round's
    launches (E1 and R1 for the median, C1 and R1 for z = 2, none for EF
    top-k), its kernels held to their plain versions on every rank, its
    collective bytes equal to the dry run's (top-k's values and indices
    aside: the dry run counts an even share of k a range), the loss equal
    on every rank and within SHARD_LOSS_RTOL of the one-process round's;
    wire bits off the one-process payload only where the pseudo-gradients
    differ and at most SHARD_FLIP_SHARE of those sent, params off it only
    where a bit differed; the attack a slice of the whole payload's; the
    dense draw a slice of the whole row's; top-k's kept set the whole
    row's exactly (the ranges' certificate: k entries a client, every
    unkept |p| below the smallest kept one or tied with it at a higher
    index), at most SHARD_TOPK_SETDIFF_SHARE of it off the one-process
    set, params off only inside either set."""
    want = {"median": {"zsign_encode": 1, "sign_reduce": 1,
                       "zsign_compress": 0, "ef_sign": 0},
            "z2": {"zsign_encode": 0, "sign_reduce": 1,
                   "zsign_compress": 1, "ef_sign": 0},
            "ef_topk": {"zsign_encode": 0, "sign_reduce": 0,
                        "zsign_compress": 0, "ef_sign": 0}}
    kernels_seen = {"median": {"zsign_encode", "sign_reduce", "vote_count"},
                    "z2": {"zsign_compress", "sign_reduce", "vote_count"},
                    "ef_topk": set()}
    d = one["d"]
    out = {}
    for tag, spec, adv in SHARD_SPEC_ROUNDS:
        recs = [rk["specs"][tag] for rk in ranks]
        pred = predicted[tag]
        n_flips = n_sent = 0
        union, cert = [], {}
        for rk, rec, pr in zip(ranks, recs, pred):
            r = rk["rank"]
            got = {k: rec["counts"][k] for k in want[tag]}
            if got != want[tag]:
                raise AssertionError(f"{label} {tag}: rank {r} launched "
                                     f"{got}, want {want[tag]}")
            if set(rec["vs_plain"]) != kernels_seen[tag]:
                raise AssertionError(f"{label} {tag}: rank {r}: kernels "
                                     f"held to plain {rec['vs_plain']}")
            skip = ("all_gather:wire_values", "all_gather:wire_indices")
            mine = {k: v[0] for k, v in rec["collective_by_use"].items()
                    if k not in skip}
            dry = {k: v for k, v in pr["collectives_by_use"].items()
                   if k not in skip}
            if mine != dry:
                raise AssertionError(f"{label} {tag}: rank {r} moved {mine}"
                                     f", the dry run counts {dry}")
            if not math.isfinite(rec["loss"]) or abs(
                    rec["loss"] - specs_one[tag]["loss"]) > \
                    SHARD_LOSS_RTOL * abs(specs_one[tag]["loss"]):
                raise AssertionError(f"{label} {tag}: rank {r} loss "
                                     f"{rec['loss']}, one process "
                                     f"{specs_one[tag]['loss']}")
            if rec["uplink_bits"] != specs_one[tag]["uplink_bits"]:
                raise AssertionError(f"{label} {tag}: uplink bits "
                                     f"{rec['uplink_bits']}")
            if "flips" in rec:
                f = rec["flips"]
                n_sent += f["sent"]
                p_one = rows[(0, rec["client"])][f["coords"]]
                if bool((p_one == f["vals"]).any()):
                    raise AssertionError(f"{label} {tag}: rank {r}: wire "
                                         "bits differ where the pseudo-"
                                         "gradients agree")
                n_flips += f["coords"].numel()
                union.append(f["coords"])
            if "topk" in rec:
                union.append(rec["topk"]["union"])
                cert.setdefault(rec["client"], []).append(rec["topk"])
        if tag == "median":
            for rec in recs:
                a = rec.get("attack")
                if a is None or a["bytes_off_one_process_where_inputs_agree"]:
                    raise AssertionError(f"{label} {tag}: attack {a}")
            if not any(rec["attack"]["bytes_hit"] for rec in recs):
                raise AssertionError(f"{label} {tag}: no byte was hit")
        if tag == "z2" and not all("noise" in rec for rec in recs):
            raise AssertionError(f"{label} {tag}: a range drew no noise")
        setdiff = kept = 0
        for c, parts in cert.items():
            k = sum(p["kept"] for p in parts)
            if k != max(1, int(d * 0.01)):
                raise AssertionError(f"{label} {tag}: client {c} kept {k}")
            t = min(p["min_kept"] for p in parts)
            ties_kept = max(p["max_kept_idx_at_min"] for p in parts
                            if p["min_kept"] == t)
            for p in parts:
                if p["max_unkept"] > t or (
                        p["max_unkept"] == t
                        and p["min_unkept_idx_at_max"] < ties_kept):
                    raise AssertionError(f"{label} {tag}: client {c}: the "
                                         "kept set is not the whole row's "
                                         f"top k ({parts})")
            setdiff += sum(p["setdiff"] for p in parts)
            kept += k
        if n_flips > SHARD_FLIP_SHARE * max(n_sent, 1):
            raise AssertionError(f"{label} {tag}: {n_flips} of {n_sent} "
                                 "wire bits differ from the one-process "
                                 f"run's (limit {SHARD_FLIP_SHARE})")
        if kept and setdiff > SHARD_TOPK_SETDIFF_SHARE * kept:
            raise AssertionError(f"{label} {tag}: {setdiff} of {kept} kept "
                                 "entries off the one-process sets (limit "
                                 f"{SHARD_TOPK_SETDIFF_SHARE})")
        union = torch.unique(torch.cat(union)) if union else \
            torch.empty((0,), dtype=torch.int64)
        for rk, rec in zip(ranks, recs):
            stray = rec["params_off_coords"][~torch.isin(
                rec["params_off_coords"], union)]
            if stray.numel():
                raise AssertionError(
                    f"{label} {tag}: rank {rk['rank']}: {stray.numel()} "
                    f"param coordinates outside rtol {SHARD_RTOL} where "
                    f"neither a wire bit nor a kept entry differed")
        if len({rec["loss"] for rec in recs}) != 1:
            raise AssertionError(f"{label} {tag}: the ranks' losses differ")
        line = {
            "sharded_spec_round": label, "tag": tag, "pipeline": spec,
            "adversary": adv, "card": smi,
            "grid": dict(zip(SHARD_AXES, SHARD_GRID)),
            "round_s": {"one_process": specs_one[tag]["sec"],
                        "ranks": [rec["sec"] for rec in recs],
                        "checks_ranks": [rec["check_s"] for rec in recs]},
            "loss": {"one_process": specs_one[tag]["loss"],
                     "ranks": [rec["loss"] for rec in recs]},
            "uplink_bits": specs_one[tag]["uplink_bits"],
            "collective_by_use": [rec["collective_by_use"] for rec in recs],
            "collective_by_use_dry_run": [p["collectives_by_use"]
                                          for p in pred],
            "peak_GB": {"ranks": [rec["peak"] / 1e9 for rec in recs],
                        "dry_run": [p["peak_bytes"] / 1e9 for p in pred]},
            "kernels_vs_plain": [rec["vs_plain"] for rec in recs],
            "wire_bits_differing": n_flips, "wire_bits_sent": n_sent,
            "params_outside_rtol": [rec["params_outside_rtol"]
                                    for rec in recs],
            "params_differing": [rec["params_differing"] for rec in recs],
            **({"attack": [rec["attack"] for rec in recs]}
               if tag == "median" else {}),
            **({"decode": [rec["decode"] for rec in recs]}
               if tag == "median" else {}),
            **({"noise": [rec["noise"] for rec in recs]}
               if tag == "z2" else {}),
            **({"topk": {"kept": kept, "setdiff_vs_one_process": setdiff,
                         "ranges": [{k: v for k, v in rec["topk"].items()
                                     if k != "union"} for rec in recs]}}
               if tag == "ef_topk" else {})}
        if tag == "z2":
            line["c1_range"] = _shard_time_c1(DEV, *ranks[1]["bounds"], d)
        if tag == "median":
            line["r1_vote_range"] = _shard_time_r1_vote(DEV,
                                                        *ranks[1]["bounds"])
        print(json.dumps(line))
        summed = {k: sum(rec["counts"][k] for rec in recs)
                  for k in recs[0]["counts"]}
        out[f"{label}_{tag}"] = {
            "launches": summed, "secs": [max(rec["sec"] for rec in recs)],
            "peak": max(rec["peak"] for rec in recs),
            "vs_plain": [rec["vs_plain"] for rec in recs],
            **{k: line[k] for k in ("c1_range", "r1_vote_range")
               if k in line}}
    return out


def _shard_ef_checks(label, one, ranks, predicted, smi):
    """The checks of the EF round inside ``label``'s ranks, its JSON line,
    and its summary for the kernels line: F1 and R1 launched once a rank
    and bit-exact against their plain versions; the scale bit-identical
    across a replica's ranks and within SHARD_EF_SCALE_RTOL of the
    one-process row's; wire bits off the one-process F1 payload only where
    the pseudo-gradients' signs differ, at most SHARD_EF_FLIP_SHARE of
    those sent; the padding past d sent as +1 and holding no residual; the
    state the rank's range; collective bytes equal to the dry run's. The
    line is printed before the last two gates."""
    want_counts = {"zsign_encode": 0, "sign_reduce": 1,
                   "sign_reduce_fold": 0, "ef_sign": 1, "zsign_compress": 0,
                   "unpack_sum": 0}
    d = one["d"]
    scale_err, by_client, scale_grid = 0.0, {}, {}
    # the one-process scale of each client: mean |p| of its row in f64,
    # from the partial sums the ranks took over their ranges
    scale_one = {}
    for rk in ranks:
        c = rk["ef"]["client"]
        scale_one[c] = scale_one.get(c, 0.0) + rk["ef"]["abs_sum_one_f64"] / d
    n_flips = n_sent = 0
    for rk, pred in zip(ranks, predicted):
        r, ef = rk["rank"], rk["ef"]
        lo, hi = rk["bounds"]
        got = {k: ef["counts"][k] for k in want_counts}
        if got != want_counts:
            raise AssertionError(f"{label} EF: rank {r} launched {got}, "
                                 f"want {want_counts}")
        if ef["collective_bytes"] != pred["collectives"]:
            raise AssertionError(
                f"{label} EF: rank {r} moved {ef['collective_bytes']}, the "
                f"dry run counts {pred['collectives']}")
        seen = ef["vs_plain"]
        if {k: v["shape"] for k, v in seen.items()} != {
                "ef_sign": [1, hi - lo], "sign_reduce": [
                    SHARD_GRID[0], (hi - lo) // 8]} or \
                seen["ef_sign"]["residual"] != [1, min(hi, d) - lo]:
            raise AssertionError(f"{label} EF: rank {r}: kernels held to "
                                 f"their plain versions at {seen}")
        if ef["residual_shape"] != [1, 1, hi - lo] or \
                ef["residual_padding_nonzero"] or \
                ef["padding_bits_set"] != ef["padding_bits"]:
            raise AssertionError(f"{label} EF: rank {r}: state {ef}")
        c = ef["client"]
        bits = seen["ef_sign"]["scale_bits"]
        if by_client.setdefault(c, bits) != bits:
            raise AssertionError(f"{label} EF: client {c}'s scale differs "
                                 "across its replica's ranks")
        scale_grid[c] = seen["ef_sign"]["scale"]
        err = abs(seen["ef_sign"]["scale"] - scale_one[c]) / scale_one[c]
        scale_err = max(scale_err, err)
        if not err <= SHARD_EF_SCALE_RTOL:
            raise AssertionError(f"{label} EF: client {c}'s scale "
                                 f"{seen['ef_sign']['scale']}, one process "
                                 f"{scale_one[c]} (rel {err})")
        n_flips += ef["flips"]
        n_sent += ef["sent"]
        if not math.isfinite(ef["loss"]):
            raise AssertionError(f"{label} EF: rank {r} loss {ef['loss']}")
    f1 = _shard_time_f1(DEV, *ranks[1]["bounds"], d)
    print(json.dumps({
        "sharded_ef_round": label, "pipeline": SHARD_EF_SPEC, "card": smi,
        "grid": dict(zip(SHARD_AXES, SHARD_GRID)),
        "round_s": [rk["ef"]["sec"] for rk in ranks],
        "loss": [rk["ef"]["loss"] for rk in ranks],
        "uplink_bits": [rk["ef"]["uplink_bits"] for rk in ranks],
        "scale_grid": scale_grid,
        "scale_one_process_f64": scale_one,
        "scale_max_rel_err": scale_err,
        "wire_bits_differing": n_flips, "wire_bits_sent": n_sent,
        "collective_bytes": [rk["ef"]["collective_bytes"] for rk in ranks],
        "collective_bytes_dry_run": [p["collectives"] for p in predicted],
        "collective_by_use": [rk["ef"]["collective_by_use"]
                              for rk in ranks],
        "state_bytes_dry_run": [p["state_bytes"] for p in predicted],
        "peak_GB": {"ranks": [rk["ef"]["peak"] / 1e9 for rk in ranks],
                    "dry_run": [p["peak_bytes"] / 1e9 for p in predicted]},
        "kernels_vs_plain": [rk["ef"]["vs_plain"] for rk in ranks],
        "f1_range": f1}))
    if n_flips > SHARD_EF_FLIP_SHARE * n_sent:
        raise AssertionError(f"{label} EF: {n_flips} of {n_sent} wire bits "
                             "differ from the one-process F1 payload (limit "
                             f"{SHARD_EF_FLIP_SHARE})")
    if len({rk["ef"]["loss"] for rk in ranks}) != 1:
        raise AssertionError(f"{label} EF: the ranks' losses differ")
    summed = {k: sum(rk["ef"]["counts"][k] for rk in ranks)
              for k in ranks[0]["ef"]["counts"]}
    return {label + "_ef": {
        "launches": summed,
        "secs": [max(rk["ef"]["sec"] for rk in ranks)],
        "peak": max(rk["ef"]["peak"] for rk in ranks),
        "vs_plain": [rk["ef"]["vs_plain"] for rk in ranks],
        "f1_range": f1}}


def _shard_checks(label, layers, rounds, seq, gbatch, one, rows, ranks,
                  predicted, ranks_s, smi):
    """The checks of one sharded path, its JSON line, and its summary for
    the kernels line."""
    plan = one["plan"]
    G, N = plan.client_groups, plan.n_clients
    want_counts = {"zsign_encode": G, "sign_reduce": 1,
                   "sign_reduce_fold": 0, "ef_sign": 0, "zsign_compress": 0,
                   "unpack_sum": 0}
    n_flips, n_sent, union = 0, 0, []
    for rk in ranks:
        r = rk["rank"]
        if rk["backend"] != "gloo" or rk["device"] != str(DEV):
            raise AssertionError(f"{label}: rank {r} on {rk['device']} with "
                                 f"{rk['backend']}")
        lo, hi = rk["bounds"]
        if lo % 8192 or (hi - lo) % 8192:
            raise AssertionError(f"{label}: rank {r} range {lo}..{hi}")
        for t, rd in enumerate(rk["rounds"]):
            got = {k: rd["counts"][k] for k in want_counts}
            if got != want_counts:
                raise AssertionError(f"{label}: rank {r} round {t} launched "
                                     f"{got}, want {want_counts}")
            if rd["collective_bytes"] != predicted[r]["collectives"]:
                raise AssertionError(
                    f"{label}: rank {r} round {t} moved "
                    f"{rd['collective_bytes']}, the dry run counts "
                    f"{predicted[r]['collectives']}")
            by_use = {k: v[0] for k, v in rd["collective_by_use"].items()}
            if label in SHARD_BY_USE_GATED and \
                    by_use != predicted[r]["collectives_by_use"]:
                raise AssertionError(
                    f"{label}: rank {r} round {t} moved {by_use} by use, "
                    f"the dry run counts "
                    f"{predicted[r]['collectives_by_use']}")
            if not math.isfinite(rd["loss"]) or abs(
                    rd["loss"] - one["loss"][t]) > SHARD_LOSS_RTOL * abs(
                    one["loss"][t]):
                raise AssertionError(f"{label}: rank {r} round {t} loss "
                                     f"{rd['loss']}, one process "
                                     f"{one['loss'][t]}")
        seen = rk["rounds"][0]["vs_plain"]
        # R1 reduces the range's rows of every client, all-gathered over
        # the client axes
        if {k: v["shape"] for k, v in seen.items()} != {
                "zsign_encode": [1, hi - lo],
                "sign_reduce": [G * N, (hi - lo) // 8]}:
            raise AssertionError(f"{label}: rank {r}: kernels held to "
                                 f"their plain versions at {seen}")
        if seen["zsign_encode"]["tile0"] != lo // 8192:
            raise AssertionError(f"{label}: rank {r}: E1 tile0 "
                                 f"{seen['zsign_encode']['tile0']}")
        for pg in rk["pg_vs_one_process"]:
            limit = (SHARD_PG_REL_L2 if pg["t"] == 0 else
                     SHARD_PG_REL_L2_LATER[label])
            if not pg["worst_leaf_rel_l2"] <= limit:
                raise AssertionError(
                    f"{label}: rank {r} round {pg['t']} client "
                    f"{pg['client']}: pseudo-gradient of {pg['worst_leaf']} "
                    f"off the one-process row by relative L2 "
                    f"{pg['worst_leaf_rel_l2']} (limit {limit}; all leaves "
                    f"{pg['rel_l2_by_leaf']})")
        for f in rk["flips"]:
            n_sent += f["sent"]
            p_one = rows[(f["t"], f["client"])][f["coords"]]
            if bool((p_one == f["vals"]).any()):
                raise AssertionError(f"{label}: rank {r}: wire bits differ "
                                     "where the pseudo-gradients agree")
            n_flips += f["coords"].numel()
            union.append(f["coords"])
    flip_share = SHARD_FLIP_SHARE_BY_PATH.get(label, SHARD_FLIP_SHARE)
    if n_flips > flip_share * n_sent:
        raise AssertionError(f"{label}: {n_flips} of {n_sent} wire bits "
                             "differ from the one-process run's (limit "
                             f"{flip_share})")
    # each param coordinate off the one-process run lies where some
    # client's wire bit differed in some round (the server step is
    # elementwise, and each coordinate's update is a function of the
    # clients' bits there)
    union = torch.unique(torch.cat(union)) if union else \
        torch.empty((0,), dtype=torch.int64)
    for rk in ranks:
        stray = rk["params_off_coords"][~torch.isin(
            rk["params_off_coords"], union)]
        if stray.numel() or rk["params_off_coords"].numel() != \
                rk["params_outside_rtol"]:
            raise AssertionError(
                f"{label}: rank {rk['rank']}: {stray.numel()} of "
                f"{rk['params_outside_rtol']} param coordinates outside "
                f"rtol {SHARD_RTOL} where no wire bit differed (first: "
                f"{stray[:8].tolist()})")
    peaks = [rk["peak"] for rk in ranks]
    if label in SHARD_PEAK_GATED and max(peaks) > SHARD_PEAK_RATIO * \
            one["peak"]:
        raise AssertionError(f"{label}: rank peaks {peaks} above "
                             f"{SHARD_PEAK_RATIO} x the one-process peak "
                             f"{one['peak']}")
    losses = {rd["loss"] for rk in ranks for rd in rk["rounds"][-1:]}
    if len(losses) != 1:
        raise AssertionError(f"{label}: the ranks' losses differ: {losses}")
    e1 = _shard_time_e1(DEV, *ranks[1]["bounds"])
    print(json.dumps({
        "sharded_replica": label, "card": smi,
        "grid": dict(zip(SHARD_AXES, SHARD_GRID)), "backend": "gloo",
        "plan": {"client_axes": plan.client_axes,
                 "micro_axes": plan.micro_axes, "seq_axes": plan.seq_axes,
                 "replica_axes": plan.replica_axes, "n_clients": N,
                 "client_groups": G, "micro": plan.micro},
        "cuts": {"layers": layers, "seq": seq, "global_batch": gbatch,
                 "rounds": rounds, "local_steps": 1},
        "seq_shards": SHARD_SEQ_SHARDS,
        "d": one["d"], "ranges": [rk["bounds"] for rk in ranks],
        "round_s": {"one_process": one["round_s"],
                    "ranks": [[rd["sec"] for rd in rk["rounds"]]
                              for rk in ranks]},
        "collective_s": [[rd["collective_s"] for rd in rk["rounds"]]
                         for rk in ranks],
        "collective_by_use_last_round": [rk["rounds"][-1][
            "collective_by_use"] for rk in ranks],
        "collective_bytes": [rk["rounds"][0]["collective_bytes"]
                             for rk in ranks],
        "collective_bytes_dry_run": [p["collectives"] for p in predicted],
        "collective_calls": [rk["rounds"][0]["collective_calls"]
                             for rk in ranks],
        "host_GB": {"rows_shared": one["rows_bytes"] / 1e9,
                    "ranks_max_rss": [rk["host_max_rss_GB"] for rk in ranks],
                    **one["host"]},
        "peak_GB": {"one_process": one["peak"] / 1e9,
                    "ranks": [p / 1e9 for p in peaks],
                    "dry_run": [p["peak_bytes"] / 1e9 for p in predicted],
                    "ratio_to_one_process": max(peaks) / one["peak"]},
        "shard_bytes": [rk["shard_bytes"] for rk in ranks],
        "dry_run_flops": [p["flops_per_device"] for p in predicted],
        "loss": {"one_process": one["loss"],
                 "ranks": [rk["rounds"][-1]["loss"] for rk in ranks]},
        "wire_bits_differing": n_flips, "wire_bits_sent": n_sent,
        "coords_with_a_differing_bit": int(union.numel()),
        "pseudo_gradient_vs_one_process": [
            [{k: pg[k] for k in ("t", "client", "rel_l2", "worst_leaf",
                                 "worst_leaf_rel_l2", "max_err",
                                 "coords_differing", "coords")}
             for pg in rk["pg_vs_one_process"]] for rk in ranks],
        "params_outside_rtol": [rk["params_outside_rtol"] for rk in ranks],
        "params_differing": [rk["params_differing"] for rk in ranks],
        "kernels_vs_plain_round0": [rk["rounds"][0]["vs_plain"]
                                    for rk in ranks],
        "e1_range": e1, "ranks_run_s": ranks_s}))
    summed = {k: sum(rd["counts"][k] for rk in ranks for rd in rk["rounds"])
              for k in ranks[0]["rounds"][0]["counts"]}
    return {label: {"launches": summed,
                    "secs": [max(x) for x in zip(*([rd["sec"] for rd in
                                                    rk["rounds"]]
                                                   for rk in ranks))],
                    "peak": max(peaks),
                    "vs_plain": [rk["rounds"][0]["vs_plain"]
                                 for rk in ranks],
                    "e1_range": e1},
            label + "_d1": {"launches": one["counts"],
                            "secs": one["round_s"], "peak": one["peak"]}}


def start_shard_predictions():
    """Every sharded path's dry run (four ranks each; the EF round's cell
    right after its path's) in a pool of SHARD_RANKS processes on the
    host's cores, started as early as the caller likes (``main``: before
    the kernels are built) so that the traces run while the card works.
    -> (pool, {label: pending results})."""
    import torch.multiprocessing as mp
    pool = mp.get_context("spawn").Pool(SHARD_RANKS)
    pending = {}
    for p in SHARD_PATHS:
        pending[p[0]] = pool.starmap_async(
            _shard_predict, [(p[1], p[2], p[4], p[5], r)
                             for r in range(SHARD_RANKS)])
        if p[0] == SHARD_EF_PATH:
            pending[p[0] + "_ef"] = pool.starmap_async(
                _shard_predict, [(p[1], p[2], p[4], p[5], r, SHARD_EF_SPEC)
                                 for r in range(SHARD_RANKS)])
            for tag, spec, adv in SHARD_SPEC_ROUNDS:
                pending[p[0] + "_" + tag] = pool.starmap_async(
                    _shard_predict, [(p[1], p[2], p[4], p[5], r, spec, adv)
                                     for r in range(SHARD_RANKS)])
        if p[0] in SHARD_SERVE:
            pending[p[0] + "_serve"] = pool.starmap_async(
                _serve_predict, [(p[1], p[2], p[0], r)
                                 for r in range(SHARD_RANKS)])
    return pool, pending


def phase_sharded_replica(dev, smi, predictions=None):
    """sharded_replica: each of SHARD_PATHS first in this process without a
    grid, then on four ranks (fresh processes, ``_RankPool``, spawned once
    for every path) of a (data=2, model=2) gloo grid sharing the one card,
    running the dry run's train cell (``dryrun.build_train_cell``) for
    real. Each rank: E1 (with its tile0) and R1 launched as the plan says
    and held to their plain versions on round 0; its collective bytes by
    kind equal to the dry run's count for its rank; its pseudo-gradient
    range within SHARD_PG_REL_L2 of the one-process row, leaf by leaf; wire
    bits that differ from the one-process run's only where the
    pseudo-gradients differ, and at most SHARD_FLIP_SHARE of them; params
    off it only at coordinates where a wire bit differed; the loss within
    SHARD_LOSS_RTOL; on shard_qwen25_32b a peak at most SHARD_PEAK_RATIO of
    one process's."""
    import shutil
    import tempfile
    out, tmp = {}, tempfile.mkdtemp(prefix="chip_smoke_shard_")
    store = os.path.join(tmp, "grid.store")
    # the one-process rows of every path, one after another, in one shared
    # host tensor sized for the path that keeps the most (a copy into fresh
    # pages is ~3x slower than into touched ones). The pages past the first
    # path's rows are touched in the background, in the order the later
    # paths reach them, from the end of the first path's one-process run on
    # (a one-process run that copies its rows into fresh pages while they
    # are touched takes several times longer), and each path waits until
    # its own rows' pages are touched
    need = {p[0]: _shard_rows(*p[1:]) for p in SHARD_PATHS}
    row_pool = _shared_row(max(need.values()))
    toucher = _Toucher(row_pool, need[SHARD_PATHS[0][0]])
    # every path's dry run, from ``start_shard_predictions`` (the caller's,
    # started earlier, or here), while the card runs the paths
    pool, pending = predictions or start_shard_predictions()
    ranks_pool, ok = None, False
    try:
        # the ranks start beside the first path's one-process run
        ranks_pool = _RankPool(SHARD_RANKS, _shard_setup, (store, row_pool),
                               SHARD_TIMEOUT_S)
        for label, arch_id, layers, rounds, seq, gbatch in SHARD_PATHS:
            toucher.wait(need[label])
            avail = _meminfo()["MemAvailable"] / 1e9
            print(f"# {label}: host memory available {avail:.1f} GB")
            host = _HostPeak()
            host.start()
            t0 = time.time()
            one, rows = _shard_one(label, arch_id, layers, rounds, seq,
                                   gbatch, tmp, row_pool)
            if label == SHARD_EF_PATH:
                specs_one = _shard_specs_one(label, arch_id, layers, seq,
                                             gbatch, tmp)
            if label in SHARD_SERVE:
                serve_one = _serve_one(label, arch_id, layers, tmp)
            if label == SHARD_MAMBA_PATH:
                mamba_one = _mamba_one(tmp)
                mamba_decode_one = _mamba_decode_one(tmp)
            one_s = time.time() - t0
            if toucher.ident is None:
                toucher.start()
            predicted = (pending[label] if pool is None else
                         pending[label].get(timeout=SHARD_TIMEOUT_S))
            predict_s = time.time() - t0
            rec_path = os.path.join(tmp, label + "_rank{}.pt")
            spans = {k: (v.storage_offset(), v.numel())
                     for k, v in rows.items()}
            t0 = time.time()
            ranks_pool.run(_shard_rank, label, arch_id, layers, rounds, seq,
                           gbatch, tmp, spans, rec_path)
            ranks_s = time.time() - t0
            one["host"] = {"available_before": avail, **host.stop()}
            ranks = [torch.load(rec_path.format(r))
                     for r in range(SHARD_RANKS)]
            out.update(_shard_checks(label, layers, rounds, seq, gbatch,
                                     one, rows, ranks, predicted, ranks_s,
                                     smi))
            if label == SHARD_EF_PATH:
                key = label + "_ef"
                out.update(_shard_ef_checks(
                    label, one, ranks,
                    pending[key] if pool is None else
                    pending[key].get(timeout=SHARD_TIMEOUT_S), smi))
                out.update(_shard_spec_checks(
                    label, one, specs_one, rows, ranks,
                    {tag: pending[f"{label}_{tag}"] if pool is None else
                     pending[f"{label}_{tag}"].get(timeout=SHARD_TIMEOUT_S)
                     for tag, _, _ in SHARD_SPEC_ROUNDS}, smi))
            if label in SHARD_SERVE:
                key = label + "_serve"
                _shard_serve_checks(
                    label, serve_one, ranks,
                    pending[key] if pool is None else
                    pending[key].get(timeout=SHARD_TIMEOUT_S), smi, tmp)
                print(f"# {label}: serving on the grid "
                      f"{max(rk['serve']['total_s'] for rk in ranks):.1f} s "
                      f"a rank")
            if label == SHARD_MAMBA_PATH:
                _shard_mamba_checks(mamba_one, ranks, smi)
                _shard_mamba_decode_checks(mamba_decode_one, ranks, smi)
            if label == SHARD_STREAM_PATH:
                out.update(_shard_stream_checks(label, ranks, smi))
            print(f"# {label}: one process {one_s:.1f} s, with the dry run "
                  f"beside it {predict_s:.1f} s, ranks {ranks_s:.1f} s; "
                  f"host peaks: Shmem {one['host']['shmem_peak']:.2f} GB, "
                  f"in use {one['host']['used_peak']:.2f} of "
                  f"{one['host']['mem_total']:.2f} GB")
            del rows, ranks
            for f in os.listdir(tmp):
                if os.path.join(tmp, f) != store:
                    os.unlink(os.path.join(tmp, f))
            _free()
            if pool is not None:
                # every dry run is done by now: its processes' memory goes
                # before the larger paths
                pending = {k: v.get(timeout=SHARD_TIMEOUT_S)
                           for k, v in pending.items()}
                pool.close()
                pool.join()
                pool = None
        ok = True
    finally:
        if ranks_pool is not None:
            ranks_pool.close(ok)
        if pool is not None:
            pool.terminate()
            pool.join()
        toucher.stop()
        row_pool.set_()             # the shared pages go now
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card visible", file=sys.stderr)
        return 1
    dev = DEV
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.time()
    # the sharded phase's dry runs start first: they trace on the host's
    # cores while the kernels build and the checks below run
    predictions = start_shard_predictions()
    smi = phase_device_and_build()[1]
    flips_z1 = check_encode_and_reduce(dev)
    check_fold(dev)
    check_ef_compress_unpack(dev)
    results = {}
    # first of the paths: its ranks and files need the host's memory, which
    # the host-fed paths' pinned rows take later
    t_new = time.time()
    print(f"# kernels built and checked at {t_new - t_start:.1f} s")
    results.update(phase_sharded_replica(dev, smi, predictions))
    print(f"# sharded-replica phase ran {time.time() - t_new:.1f} s")
    t_new = time.time()
    for label, flags, per_round in PATHS:
        results[label] = phase_path(label, flags, per_round)
    print(f"# full-width paths ran {time.time() - t_new:.1f} s")
    t_new = time.time()
    phase_identities(results)
    phase_mlp(dev)
    dynamic = phase_dynamic_sigma(dev)
    print(f"# identities, MLP and dynamic sigma ran "
          f"{time.time() - t_new:.1f} s")
    t_new = time.time()
    params = phase_serve(dev, smi)[1]
    phase_decode_vs_forward(dev, smi, params)
    del params
    _free()
    results["moe_round"] = phase_moe(dev, smi)
    results["ckpt_replay"] = phase_ckpt_replay(dev, smi)
    print(f"# serve, decode, MoE and checkpoint phases ran "
          f"{time.time() - t_new:.1f} s")
    t_new = time.time()
    results["xlstm_round"] = phase_xlstm(dev, smi)
    results["encdec_round"] = phase_encdec(dev, smi)
    mamba = phase_mamba_jamba_width(dev, smi)
    results["hybrid_reduced"] = phase_hybrid_reduced(dev, smi)
    print(f"# xLSTM, enc-dec, mamba and hybrid phases ran "
          f"{time.time() - t_new:.1f} s")
    t_new = time.time()
    remat_4k = phase_remat_qwen2_4k(dev, smi)
    print(f"# remat_qwen2_4k ran {time.time() - t_new:.1f} s")
    t_new = time.time()
    multi = phase_multi_device(dev, smi)
    results.update(multi)
    print(f"# multi-device phase ran {time.time() - t_new:.1f} s")
    t_new = time.time()
    times = times_encode_reduce(dev)
    times["ef_sign"] = times_ef(dev)
    times["zsign_compress"] = times_compress(dev)
    for k, r in times.items():
        print(json.dumps({"time": k, "shape": f"n=8 d={QWEN2_COORDS}",
                          **{f: v for f, v in r.items()}}))
    plain = times_plain_layers(dev)
    print(json.dumps({"plain_layers": plain,
                      "shape": f"n=8 d={QWEN2_COORDS}", "card": smi}))
    wire_layers = times_wire_layers(dev)
    print(json.dumps({"wire_layers": wire_layers,
                      "shape": f"n=8 d={QWEN2_COORDS} k={TOPK_K}",
                      "card": smi}))
    print(f"# kernel and layer timings ran {time.time() - t_new:.1f} s")
    enc, red = times["zsign_encode"], times["sign_reduce"]
    secs = results["zsign"]["secs"]
    print(json.dumps({"round_split_ms": {
        "round_min": min(secs) * 1e3, "encode_E1": enc["ms"],
        "reduce_R1": red["ms"],
        "local_sgd_and_rest": min(secs) * 1e3 - enc["ms"] - red["ms"]},
        "round_s": {k: v["secs"] for k, v in results.items()},
        "dynamic_sigma_round_s": dynamic["round_s"],
        "mamba_jamba_width_ms": {"block": mamba["block_ms"],
                                 "recurrence": mamba["recurrence_ms"]},
        "peak_mem_GB": {k: v["peak"] / 1e9 for k, v in results.items()},
        "remat_qwen2_4k": [{k: r[k] for k in ("layers", "remat", "round_s",
                                               "peak_GB")}
                           for r in remat_4k["runs"]],
        "remat_zsign_round_s": [(r["remat"], r["round_s"])
                                for r in remat_4k["zsign"]],
        "card": smi}))
    # the useful-work share of the zsign round: 6 * N_active * tokens from
    # the port's roofline, over the H100's peak, against the round time
    from repro_torch.configs.common import get_arch
    from repro_torch.launch.roofline import H100, param_counts
    n_active = param_counts(get_arch("qwen2_0_5b"))["active"]
    flops = 6.0 * n_active * MFU_TOKENS
    print(json.dumps({"round_mfu": {
        "path": "zsign", "n_active": n_active, "tokens": MFU_TOKENS,
        "model_flops": flops, "peak_flops": H100.peak_flops,
        "at_peak_ms": flops / H100.peak_flops * 1e3,
        "round_s": results["zsign"]["secs"],
        "mfu": [flops / H100.peak_flops / t
                for t in results["zsign"]["secs"]]}, "card": smi}))
    total = {k: sum(r["launches"][k] for r in results.values())
             for k in results["zsign"]["launches"]}
    by_path = {k: {p: r["launches"][k] for p, r in results.items()
                   if r["launches"][k]} for k in total}
    src = "src/repro_torch/kernels/"
    tpu = "src/repro/kernels/"
    kernels = [
        {"name": "zsign_encode", "route": "cuda",
         "source": src + "zsign/csrc/zsign_encode.cu",
         "replaces": tpu + "zsign/zsign.py:145 (n = 1: zsign.py:123)",
         "launches": total["zsign_encode"],
         "launches_n1": total["zsign_encode_n1"],
         "launches_range": total["zsign_encode_range"],
         "check": f"bit-exact vs plain, z=1 flips {flips_z1} (small) / "
                  f"{enc['bits_differing']} (full width); batched bytes "
                  "equal to n = 1 launches; a sigma per client (one 0) "
                  "bit-exact vs plain",
         "per_client_sigma": {
             "stosign_path_sigma": results["stosign"]["checks"][
                 "e1_sigma_round1"],
             "check": "E1's (8,) sigma vector on the stosign path equals "
                      "the rows' L2 norms in f64 (max rel "
                      f"{results['stosign']['checks']['sigma_vs_f64_norms_max_rel']:.2e}"
                      " <= 1e-6), 8 distinct entries"},
         "n1_ms": enc["n1_ms"], "n1_plain_ms": enc["n1_plain_ms"],
         "n1_bound_ms": enc["n1_bound_ms"]},
        {"name": "sign_reduce", "route": "cuda",
         "source": src + "zsign/csrc/sign_reduce.cu",
         "replaces": tpu + "zsign/zsign.py:226",
         "launches": total["sign_reduce"],
         "launches_fold": total["sign_reduce_fold"],
         "launches_vote_route": sum(results[p]["launches"]["sign_reduce"]
                                    for p in VOTE_ROUTE),
         "check": "int32 bit patterns equal to plain, add and fold mode "
                  "(small shard sequences and full width); as the vote "
                  "pair's route, int32 equal to the popcount route on the "
                  "vote path at full width"},
        {"name": "ef_sign", "route": "cuda",
         "source": src + "efsign/csrc/ef_sign.cu",
         "replaces": tpu + "efsign/efsign.py:39",
         "launches": total["ef_sign"],
         "check": "payload bytes and e' int32 bit patterns equal to plain"},
        {"name": "zsign_compress", "route": "cuda",
         "source": src + "zsign/csrc/zsign_compress.cu",
         "replaces": tpu + "zsign/zsign.py:68",
         "launches": total["zsign_compress"],
         "check": "payload bytes equal to plain"},
        {"name": "unpack_sum", "route": "cuda",
         "source": src + "zsign/csrc/unpack_sum.cu",
         "replaces": tpu + "zsign/zsign.py:193",
         "launches": times["unpack_sum"]["launches"],
         "check": "int32 bit patterns equal to plain and to R1 with unit "
                  "weights; launched by the public op zsign_decompress_sum "
                  "(on no round path)"},
    ]
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")
    for k in kernels:
        k.update({f: times[k["name"]][f] for f in keys})
        k["library_ms"] = None
        if k["name"] in by_path:
            k["launches_by_path"] = by_path[k["name"]]
    kernels[1].update({f: times["sign_reduce"][f] for f in (
        "fold_ms", "fold_plain_ms", "fold_bound_ms", "fold_max_abs_err")})
    for path in PLAIN_CHECKED:
        seen = results[path]["checks"]["kernels_vs_plain_round0"]
        kernels[0][path + "_vs_plain"] = seen["zsign_encode"]
        kernels[1][path + "_vs_plain"] = seen["sign_reduce"]
    by_name = {k["name"]: k for k in kernels}
    for path in MULTI_PLAIN:
        seen = results[path]["vs_plain"]
        for kern in MULTI_PLAIN[path]:
            kname, tag = ((kern[:-5], "_fold_vs_plain")
                          if kern.endswith("_fold") else (kern, "_vs_plain"))
            by_name[kname][path + tag] = [s[kern] for s in seen]
    ef_grid = results[SHARD_EF_PATH + "_ef"]
    by_name["ef_sign"].update({
        "launches_range": ef_grid["launches"]["ef_sign"],
        SHARD_EF_PATH + "_ef_vs_plain": [s["ef_sign"] for s in
                                         ef_grid["vs_plain"]],
        SHARD_EF_PATH + "_ef_range": ef_grid["f1_range"]})
    by_name["sign_reduce"][SHARD_EF_PATH + "_ef_vs_plain"] = [
        s["sign_reduce"] for s in ef_grid["vs_plain"]]
    for tag, _, _ in SHARD_SPEC_ROUNDS:
        res = results[f"{SHARD_EF_PATH}_{tag}"]
        for kname in ("zsign_encode", "sign_reduce", "zsign_compress"):
            seen = [s[kname] for s in res["vs_plain"] if kname in s]
            if seen:
                by_name[kname][f"{SHARD_EF_PATH}_{tag}_vs_plain"] = seen
    z2_grid = results[SHARD_EF_PATH + "_z2"]
    by_name["zsign_compress"].update({
        "launches_range": z2_grid["launches"]["zsign_compress"],
        SHARD_EF_PATH + "_z2_range": z2_grid["c1_range"]})
    by_name["sign_reduce"]["launches_vote_range"] = results[
        SHARD_EF_PATH + "_median"]["launches"]["sign_reduce"]
    median = results[SHARD_EF_PATH + "_median"]
    by_name["sign_reduce"].update({
        SHARD_EF_PATH + "_median_vote_count": [s["vote_count"] for s in
                                               median["vs_plain"]],
        SHARD_EF_PATH + "_median_vote_range": median["r1_vote_range"]})
    for path in (p[0] for p in SHARD_PATHS):
        seen = results[path]["vs_plain"]
        for kname in ("zsign_encode", "sign_reduce"):
            by_name[kname][path + "_vs_plain"] = [s[kname] for s in seen]
        e1 = results[path]["e1_range"]
        by_name["zsign_encode"][path + "_range"] = {
            k: e1[k] for k in ("shape", "tile0", "ms", "plain_ms",
                               "bound_ms", "bound_by", "bits_differing")}
    print(f"# chip_smoke ran {time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
