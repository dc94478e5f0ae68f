#!/usr/bin/env python3
"""Run the PyTorch port (``summer_clip_torch``) on one CUDA card, end to end.

    python3 chip_smoke.py
    python3 chip_smoke.py --only {attention,block,cache,decode} [--baseline OLD/<source>.cu ...]

The second form builds only what one kernel family's checks need and runs only
them, then stops (no contract line): ``attention`` (K4, K11, K12 and the
towers), ``block`` (K5, K6, K9 and the towers), ``cache`` (K3, K2, K1 with
the affinity probe, K13) or ``decode`` (K7 and K10, then K8). With
``--baseline`` earlier copies of those sources (``attention_kernels.cu``,
``block_kernels.cu``, ``cache_kernels.cu``; for ``decode``
``gemv_kernels.cu`` and/or ``decode_kernels.cu``, e.g. from ``git show
<commit>:summer_clip_torch/csrc/...``) are built beside this tree's, each
against the headers (``*.cuh``) that lie beside it (copy its commit's there;
a header missing there is taken from this tree), and the attention checks,
K5, K6, K9, K1 (at CLIP-search's shape), K7, K10 and K8 also time them in
turns with the kernel (baseline, kernel, kernel, baseline) on the same inputs;
a ``block_kernels.cu`` from before the GEMM chain is called on its own K5 and
K6 entries (``PER_HEAD_BLOCK_SIGNATURES``), a ``gemv_kernels.cu`` or
``decode_kernels.cu`` of the workspace-and-ticket design on its own
(``WORKSPACE_K7_SIGNATURES``, ``WORKSPACE_K8_SIGNATURES``), a
``gemv_kernels.cu`` with the two-launch K10 on its own K10 entry
(``TWO_LAUNCH_K10_SIGNATURES``).

0. Run without ``PYTHONHASHSEED`` in its environment, it runs itself again
   with ``PYTHONHASHSEED=0``: the synthetic datasets draw each image from
   ``hash(path)``, so every call draws the same images.
1. Refuses to run without CUDA. Prints the card (``nvidia-smi`` name and power
   limit) and the torch, CUDA, nvcc and Triton versions.
2. Builds every kernel from ``summer_clip_torch/csrc`` with nvcc, one process
   per source, all started together (``-Xptxas -v`` report printed), and
   beside them the native JPEG library (``summer_clip_torch/native``, g++;
   which decoder the host's build takes is printed).
3. Holds each kernel against its plain PyTorch version on the card at the
   shapes of the main paths, with the tolerances below, and times both with
   CUDA events (TF32 off for the plain f32 products):
   - K5 fused_ln_attn and K6 fused_ln_mlp at the ViT-B/16 image tower
     (B=32, T=197, D=768, 12 heads), its text tower (B=256, T=77, D=512,
     8 heads, causal), the ViT-L/14 text tower (B=256, T=77, D=768, 12
     heads, causal) and a CoOp forward through it (B=1000), each with its
     chain's steps timed one by one; K9 fused_ln_mlp_chunked at the ViT-L/14
     image tower (B=32, T=257, D=1024, H=4096); for all three two runs bit for
     bit and a sequence alone against the same sequence among others; cuBLAS
     on K6's c_fc product at the ViT-B/16 image shape beside the port's GEMM
     (a yardstick used nowhere in the port), and there the QuickGELU epilogue
     against quick_gelu on the same h (every output within |h| 2^-7, one bf16
     ulp of the sigmoid and the product's rounding);
   - K4 short_attention_packed at the ViT-L/14 image tower (B=32, T=257,
     D=1024, 16 heads), at ViT-L/14@336 (T=577) and at its limit T=640 (B=32,
     16 heads), at text shapes (B=256, T=77, D=512, 8 heads, causal), at
     train_gpt's (B=32, T=80, D=1280, 20 heads, causal), at the int8 ViT-B/16
     image tower's (B=32, T=197, D=768, 12 heads) and, for
     its f32 variant, at gen_gpt's perplexity shape for T = 512 (B=8, D=1280,
     20 heads, causal), K12 short_attention at (512, 257, 64); for both also
     ``F.scaled_dot_product_attention`` on the same q/k/v, timed as the
     library yardstick and used nowhere in the port; two planted faults read
     against the same limits (the last key tile dropped at ViT-L/14, the
     causal mask shifted by one key at the text shape);
   - K3 onehot_grouped on a class-grouped Tip cache (Nt=8192, Nc=16*1000,
     D=512, C=1000, 16 betas of the Tip grid) and K2 labels_dense on the same
     cache with its rows shuffled; K3 == K2 on the grouped cache; K3 once more
     as CLIP-search gives it (Nt=1000, D=768, a prediction-sorted selection
     padded with label -1 to 1024 or 2048 rows, 8 betas);
   - K1 cache_dense at Nt=8192, Nc=16384, D=768, C=1000, 8 betas (CLIP-search's
     beta chunk) with bf16 softmax values and with int8 one-hot values, the
     latter also against K2 on the same labels; K1 once more at the pipeline's
     own size (Nt=1000, Nc=2048); K1's affinity (wgmma) against K2's (WMMA)
     bit for bit on 64 tiles at widths 16 to 256 (the affinity probe);
   - K13 onehot_variant at the sweep tool's first geometry (Nt=50176, D=1024,
     C=1000, 16 cache rows a class, 8 betas, block_n 1024), each expand mode
     ("highest" with cast_w, "split3", "default") against its plain version,
     "highest" == "split3" bit for bit, both against K3 and K1 (int8
     one-hots), "default" against "highest", two runs bit for bit, and the
     readings of a planted fault (one class's partial dropped);
   - K14 blend_argmax_hits at a Tip chunk (16 betas x 50,000 rows x 1,000
     classes x the grid's 20 alphas) against its plain version bit for bit,
     with planted ties, two runs bit for bit, timed beside the plain version
     and its bound;
   - K7 streamed_qmatmul at every matrix a decoded token of ClipGPT on
     gpt2-large reads ((1280, 3840), (1280, 1280), (1280, 5120), (5120, 1280),
     the head (1280, 49408), the adapters (512, 1024) and (1024, 1280)) with
     R = 1, 3 (the batched sampler's rows) and 8 rows, int8 and bf16 weights;
     K10 fused_qmlp at D = 1280, H = 5120 with the same rows, also beside the
     unfused pair through K7, its plan logged with the clusters the card holds
     at once; for both, two runs and a row alone against the
     same row among others must give the same bits. Both are
     timed as device time in a CUDA graph over copies of the weights (cold,
     as a decode loop finds them) and as calls of the wrapper from Python;
     K7 also with programmatic dependent launch off, and after a PyTorch
     kernel that writes its x, and beside ``torch._weight_int8pack_mm``
     (int8) or a cuBLAS bf16 product (bf16), yardsticks used nowhere in the
     port; K7 must read the right x after a slow predecessor that writes it
     (a large reduction, and a K7 whose output is the next one's x);
   - K8 decode_block at gpt2-large (36 blocks, D = 1280, H = 5120, 20 heads)
     with 1, 3 and 8 streams over int8 rings of 256 and 1024 rows filled to
     different indices (an empty ring, a full one, left pads), int8 weights,
     and with one stream over bf16 weights and bf16 rings: each block on the
     plain version's input for that block, the whole stack against the plain
     chain, two runs bit for bit, a stream of a batched call against its solo
     call bit for bit; timed with CUDA events beside its byte bound (block
     weights and live ring rows);
   - K11 flash_attention at (160, 1024, 64) causal, at tq = 128 of tk = 1024
     with q_offset = 896 and non-causal at T = 577, each in bf16 and in f32,
     beside ``F.scaled_dot_product_attention``, with a planted fault at the
     causal shapes (the kernel with its causal mask shifted by one key);
   - the ViT-B/16 image (B=32) and text (B=256) towers, the ViT-L/14 text
     tower at a CoOp forward (B=1000) and the ViT-L/14 image
     tower (24 blocks, B=32) through the kernels against the same blocks
     through the plain versions, the ViT-L/14 image tower also in
     ``FUSED_BLOCK_MODE="mlp"`` (K4 + K9); RN50's image tower (cuDNN, no
     kernel of the port) in bf16 against f32.
   Each kernel's bound is worked out from these shapes: the larger of its
   bytes (inputs read once, outputs written once) at 3.35 TB/s and its
   operations at the H100's peak for their type (989 TFLOP/s bf16 tensor
   cores, 67 TFLOP/s f32); a causal attention counts the (t + 1) / 2 keys a
   row reaches on average.
4. Drives the main paths through the apps' entry points with random
   weights (seed 0), each with every launch count set to 0 just before it and
   read just after:
   - Tip-Adapter at ViT-B/16: save_features -> eval_clip -> tip_adapter on
     ``synthetic`` (4 classes, a class-grouped cache: K3) and tip_adapter on
     ``synthetic_1k`` (1000 classes, 1 shot: K2). Checks the catalog, the
     records, the launch counts (K5, K6, K3, K2) and the stored features
     against the f32 model on the CPU.
   - CLIP-search at ViT-L/14, full width and depth: save_features ->
     save_image_outs -> image_attention with Hard and with Softmax values on
     ``synthetic_1k`` (8 selection strategies at 3 of the config's 6 cache
     sizes, the config's beta and alpha lists). A random text tower scores nearly every image for one class (a
     prediction-sorted cache of one class: K3), so image_attention runs twice
     more over pseudo-labels that scatter (cosines to the class means of the
     stored features: K2 for Hard values, K1 for Softmax). Then the same three
     apps on the 4-class ``synthetic``. Checks the record counts, that
     alpha = 0 reproduces the zero-shot accuracy, the launch counts (K1, K2,
     K3, K4, K5, K6; K4 = 24 x image batches), for three of the runs every
     record's saved predictions against predictions rebuilt from the stored
     arrays and the plain version of the cache logits, and the stored
     ViT-L/14 features and zero-shot scores against the f32 model on the CPU.
   - ClipGPT generation at gpt2-large, full width and depth (36 x 1280, 20
     heads, CLIP vocabulary 49408, adapters 1024): the model is made from seed
     0, saved as a trainable-only checkpoint (and a second, gpt2-width ClipGPT
     from seed 1 as the speculative path's draft), and served by
     ``apps.gen_gpt.run`` ten times. With ``generation.megakernel=false``: the
     int8 tree in the device loop (3 prompts x 20 tokens) with the perplexity
     pass over a (16, 1024) token matrix on the default route, the int8 tree
     batched (K7 at R = 3), the int8 tree with ``SUMMER_CLIP_FUSED_MLP=1``
     (K10), and the perplexity pass with ``ops.attention.FLASH_ENABLED`` on
     (K11). The serving paths: ``megakernel=auto`` solo and batched (K8 at 1
     and 3 streams), ``continuous=true`` with 12 requests through 8 slots on
     the megakernel and on the K7 engine (every synchronisation inside a
     burst is an error: ``torch.cuda.set_sync_debug_mode``), and
     ``speculative=true`` (k = 4) with the gpt2-width draft and with the target
     as its own draft (every window accepted); the app decodes both models'
     full-precision trees there whatever ``quant_int8`` says, as the JAX app
     does, and int8 speculation is timed through
     ``engine.speculative.generate_device_speculative``. Checks the launch counts exactly
     (K7 147 a decoded token, K10 36 a token on the opt-in run, K11 2 x 36; K8
     1 and K7 3 a decoded token on the megakernel routes), the perplexity of
     the two routes, and then, outside the counted run: each route's greedy
     picks, and the solo routes' teacher-forced logits, against the plain route
     of the same int8 tree; the engine's requests (also of a run with budgets
     of 8 to 24 tokens, so that slots are reused mid-decode) against the solo
     megakernel sampler and the plain route; host loop == device loop, the int8
     tree's logits against the f32 tree's, the K11 route's logits against the
     plain route's; and prints prefill ms, ms a token, tokens/s and the host's
     share of a token for each sampler, the engine's drain time and aggregate
     tokens/s, and the speculative runs' verify iterations and tokens/s.
   - Training through the frozen towers at ViT-L/14 (``train_coop``): (a)
     save_features on ``synthetic_1k`` (2000 + 1000 images, batch 32) with
     ``FUSED_BLOCK_MODE="mlp"`` (K4 and K9 each 24 x 95 launches), the stored
     rows held against the "block"-mode store of the CLIP-search path (min
     cosine 0.999) and the f32 CPU model; (b) train_coop with CoOp over those
     features, 1000 classes, 1 shot, batch 32, a 16-token prompt, one epoch
     (31 steps) and validation on the test features (K5 and K6 12 times a
     text-tower forward: 33 forwards); (d) eval_prompt on the learned prompt;
     (e) train_coop with Gumbel v1a1, the suffix fluency loss and
     ``loss.fluency=0.5`` through the gpt2-large ClipGPT checkpoint of the
     gen_gpt path (K4 36 times an LM forward) at ViT-B/16 on ``synthetic``;
     (f) train_adapter -> eval_adapter over (a)'s features (the zero-shot
     classifier through K5 / K6). Then, outside the counted run, (c) the
     gradient gate: one batch's loss and prompt gradient through the kernel
     route against the route that launches no kernel (``FUSED_BLOCK_MODE=
     "xla"``, ``SHORT_FUSED_ENABLED=False``), ``loss.backward()`` launching no
     kernel, a planted fault's readings beside the limits, and the ms of a
     CoOp step (forward and backward apart, both routes) and its peak memory.
   - Prompt search and few-shot adaptation (``prompt_search``): (g)
     train_autoprompt in AutoPrompt mode at ViT-L/14 over ``synthetic_1k``
     (1000 classes, 1 shot, batch 125: 4 HotFlip steps of 10 candidates on 2
     batches), (h) the same app in FluentPrompt mode (batch 250: 4 SGLD
     steps), (i) train_coop with Gumbelv3a1 (the adapter head on the gen_gpt
     path's gpt2-large checkpoint, 8 positions, the suffix fluency loss) at
     ViT-B/16 on ``synthetic``, (j) train_prolip at ViT-B/16 on ``synthetic``
     (8 shots, 60 full-batch steps), (k) image_attention over the CLIP-search
     path's prototype store with a weights strategy the kernels do not know
     (``tip_formula_weights``: Tip-Adapter's formula by its own
     ``transform``), so that it takes the dense route. Checks each app's K4,
     K5 and K6 launches exactly; then, outside the counted run: every HotFlip
     loss against the route that launches no kernel and the yaml heap, the
     FluentPrompt prompt on vocabulary rows after every step, Gumbelv3a1's
     fluency term (loss and proposer gradient) on one batch against the plain
     route, its CLIP term (through the bf16 text tower) no farther from the
     route with an f32 tower than 1.5x the plain route's distance, ProLIP's
     W against the same training on the CPU and its CE falling, the dense
     route's saved predictions against its plain f32 function on the stored
     arrays, and its records against the kernel route's record by record
     (accuracies within 1 point: the 1% of rows the prediction gates allow).
   - The sweep tool's first geometry (``onehot_sweep``:
     ``tools/torch_sweep_onehot_variants.bench``): K1 over int8 one-hots
     twice, each of K13's three arms at block_n 1024 and 2048 twice, checksums
     against K1's.
   - Tip-Adapter at ImageNet scale (``tip_adapter.run_imagenet``, RN50 at
     random weights, ``dataset=synthetic_1k load_cache=true
     load_pre_feat=true finetune.enabled=true``, the config's (200, 20) grid)
     over a written store: 16 shots x 1000 classes of 1024-wide keys, 50000
     val and 50000 test rows, 16000 train rows, class prototypes plus noise.
     Checks the records, the searched accuracy, that Tip-Adapter-F's train CE
     falls, K3's and K14's launch counts, and the same store through the plain route
     (the same searched (beta, alpha) and accuracies); prints each stage's
     time and the peak memory.
   - ClipGPT training (``train_gpt``): tokenize_dataset writes a synthetic
     corpus (244 chunks of 80 tokens) and a validation corpus (55), then
     train_gpt at gpt2-large, full width and depth (36 x 1280, 20 heads,
     CLIP vocabulary 49408, clip_emb 512, adapters 1024), bf16, remat, batch
     32: 5 micro-steps (a subpart of 161 chunks) with ``grad_accum_steps`` cut
     from 16 to 2 (2 updates and a pending gradient), one eval and a step
     checkpoint with its optimizer. Checks K4's count exactly (36 x (2 x 5 +
     1): remat runs each block's forward again in the backward); that the
     checkpoint reloads through ``gen_gpt.load_pretrained_clip_gpt`` leaf for
     leaf (the frozen leaves redrawn from the seed: bit-identical to the ones
     trained around); that a resume with ``pretrained.optimizer=true``
     restores the calls, the updates, the accumulator and Adam's moments bit
     for bit; then, from the initial weights again, the first micro-step's
     loss and every leaf's gradient norm on the kernel route against the route
     that launches no kernel and an f32 route, and the adapters after the same
     two updates on the plain route; prints a micro-step's forward and
     backward ms, tokens/s, the optimizer's accumulate and update ms and the
     peak memory with remat off, on, ``remat_policy=dots`` and on the plain
     route, beside the micro-step's bound.
   - The int8 towers (``int8_towers``): save_features with ``clip.quant=int8``
     at ViT-B/16 (K4 12 launches an image batch) and RN50 on ``synthetic``
     (images only). Checks K4's count and the stored features; then one
     layer's int8 products on the card against the CPU's on the same input
     bit for bit (ViT-B/16 block 0's q/k/v int32 sums from the same q; RN50's
     stem convolution, K = 27 padded to 32), the int8 features against the
     bf16 tower's at B = 32 (min cosine ``TOL_INT8_COS``) with a planted
     fault's reading each, and prints img/s int8 against bf16 per tower.
   - The analysis apps over the CLIP-search path's ViT-L/14 store:
     ``maha_distance``, ``train_em`` (diagonal covariances) and
     ``class_projector``; records in range, every logits matrix finite.
   - The sandbox (``sandbox``) at gpt2-large, full width and depth, on
     random weights (seed 0): (l) the tree written as the JAX package's
     ``save_pytree`` writes it (flax msgpack, ``engine.checkpoint.save_pytree
     (format="msgpack")``) and read back through ``load_pytree`` bit for bit,
     with its size and read rate, then one 1.1 GiB leaf that the writer cuts
     into flax's chunks of 2^30 bytes, read back bit for bit; on that file
     (m) the generate CLI (``sandbox.anomalous_tokens.main``, 20 greedy
     tokens), (n) ``backwards_main`` (batch 8, input_len 10, k-means init over
     the 50257-row table, 4 epochs) and (o) ``create_trigger.main`` (a
     ``[T] [T] [T] {sentence} [P]`` template, 2 labels, 64 train and 32 dev
     rows written from a seed, 2 iterations, ``--filter``). Checks K4's
     count exactly (36 a wide forward, none in a backward); then, outside
     the counted run: the generate CLI's text against ``generate_device`` on
     the same tree, one ``optimise_input`` step's input-embedding gradient on
     the kernel route against the route that launches no kernel (the f32
     route: the CLI's GPT-2 is f32) within the CoOp gate's limits, a planted
     fault's readings (K4 with the last two keys dropped), and the trigger
     search on the plain route: the same slots and acceptances, each
     iteration's metric within one dev row, the same best trigger or dev
     accuracies within one row.
   - The serving side of the multi-device layer (``multi_device``, phase (p)),
     at full width, with real collectives. World 2 on the one card (two
     processes, gloo over CUDA tensors: NCCL refuses two ranks on one device):
     ``save_features`` with ``meta.world_size=2`` (ViT-B/16, batch 32: each
     rank encodes 16 rows of a batch, rank 0 writes the store) against the
     tip_adapter path's one-device store row for row; ``gen_gpt`` with
     ``generation.tp=2`` (the int8 device loop over the gen_gpt path's
     checkpoint, each rank's block stack on its Megatron slices); then one
     group of two ranks for image_attention over the CLIP-search path's
     ViT-L/14 store with the cache's rows split over the ranks (Hard values
     over the one-class outs: K3 a rank; over the prototype labels: K2 a
     rank; their Softmax values: K1 a rank; one all-reduce of the partial
     logits), the engine at tp = 2 (12 requests through 8 slots, the K7
     route) and the batched sampler at tp = 2. World 1 through NCCL: the two
     searches over the prototype labels and the device loop through the
     decoder of one rank.
     Checks every rank's launches exactly (K5 and K6 12 a batch; K7 147 a
     decoded token a rank at tp = 2 as at one device: ``tp_k7_per_token``;
     K2 + K3 one a selection, K1 one a (selection, value setting)); that the
     ranks pick the same ids; the store (max |d| 1e-4, a planted fault: each
     batch's halves gathered in the wrong order); each search's saved
     predictions against the clip_search path's one-device run record by
     record (agreement ``TOL_MD_PRED_AGREE``; a planted fault: rank 1's partial
     dropped); the TP runs' picks teacher forced through the plain route
     (``TOL_GREEDY_TIE``) and the device loop's logits step by step through the
     decoder (``TOL_GREEDY_LOGITS``; a planted fault: rank 1's slice of one
     block's c_proj dropped); at world 1 the decoder's ids and logits equal to
     the one-device model's bit for bit. With more than one card also every
     card through NCCL (image_attention, gen_gpt where the heads divide).
   - The training side of the multi-device layer (``multi_device_train``,
     phase (q)): ``train_gpt`` at gpt2-large full width and depth (ClipGPT
     with the train_gpt path's adapters, bf16, remat, batch 8 x 80,
     ``grad_accum_steps`` 2, ``clip_grad_norm`` 1.0: 2 micro-steps, one
     update, one eval batch) at world 1 as the reference and with
     ``scan_layers``, then in one world-2 group on the one card (gloo) under
     dp = 2, tp = 2 (K4 on 10 heads a rank), fsdp and pp = 2 (2
     microbatches), and EP at width 1280 (4 experts over 2 ranks) against the
     dense MoE. ``tools/torch_gloo_probe.py`` first logs what gloo does with
     CUDA tensors. Gates, each layout against the reference: every
     micro-step's loss, the update's norm over every leaf, the eval loss, the
     adapters and their first Adam moments read from the step checkpoint
     rank 0 wrote, loaded into the one-device trainer (standard layout); K4's
     launches a rank exactly (``mdt_k4_per_rank``); a planted fault (the
     pipeline's stage sum transposed as a second all-reduce) read against
     the norm gate. Logs each layout's seconds, ms a micro-step, the update's
     gradient all-reduce, peak memory and parameter bytes a rank.
   - The JPEG input path (``jpeg_extract``, phase (r)): a Caltech101-shaped
     tree of 2048 JPEG files written from the seed (101 classes, quality 90,
     smooth content plus noise; half at 500x375 or 375x500, a quarter at
     1600x1200, which takes the DCT-scaled decode, a quarter at 300x200; 1024
     train and 1024 test rows), then ``save_features`` (``dataset_name=
     caltech101``, ViT-B/16, batch 32) on the loader's own choice (the test
     split through the native library) and with the library reported
     missing (PIL throughout), and ``eval_clip`` over the first store. Checks
     each split's route, K5 and K6 12 times an image batch and a text chunk,
     the native store against the PIL run's (min row cosine 0.99, not equal
     bit for bit; the train split, PIL in both, equal bit for bit), the native
     library's pixels of the first 64 test files against PIL's EvalTransform
     (per-image mean and max |d|, with two planted faults: the crop one pixel
     off, bilinear taps), the stored native rows of those files against the
     f32 CPU model on those pixels (cosine 0.99) with a planted fault's
     reading (the channel means applied in reversed order), and eval_clip's
     record; prints img/s of each run and split, the card's busy share (an
     estimate from one batch's kernel time, taken after the apps), the loader
     alone (native at 1 thread and at one a core, PIL) and the host's cores.
   The CLIP-search, train_coop and prompt_search paths, the analysis apps and
   phase (p)'s searches build their apps' random towers once a process
   (``shared_towers``: the host spends ~6 s drawing ViT-L/14 an app); every
   app still runs whole.
5. Prints a JSON line of the kernels of the main paths (K12 runs on none,
   so it has a line of its own), then as its last line
   ``{"ok": true, "device": {...}}``. Any failure exits non-zero.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import ctypes
import json
import os
import subprocess
import sys
import tempfile
import time
import typing as tp
from pathlib import Path

KERNEL_SOURCES = ("block_kernels", "cache_kernels", "attention_kernels", "gemv_kernels",
                  "decode_kernels")
PEAK_BYTES = 3.35e12      # H100 SXM device memory, bytes/s
PEAK_BF16 = 989e12        # dense bf16 tensor-core FLOP/s
PEAK_F32 = 67e12          # f32 FLOP/s outside the tensor cores
# exponentials (MUFU.EX2): 16 a clock an SM (CUDA C Programming Guide, arithmetic
# instruction throughput, compute capability 9.0) on the card's SMs at its
# maximum SM clock (nvidia-smi clocks.max.sm, read in main; the H100 SXM's
# 1980 MHz until then)
EXP_PER_CLOCK_SM = 16
CARD = {"sms": 132, "sm_clock_hz": 1.98e9}

# bf16 kernel vs bf16 plain version: the same rounding points, other f32
# summation orders. An intermediate (q/k/v, hidden, scores) may round to the
# neighbouring bf16 value, which moves an output of size ~4 by a few bf16 ulps
# (2^-6 each at [4, 8)).
TOL_BLOCK_MAX = 0.125
TOL_BLOCK_MEAN = 2e-3
# Cache sums (<= 16 terms of size <= 1 per class): a weight may round to the
# neighbouring bf16 value when the plain f32 affinity differs in its last bit.
TOL_CACHE_VS_PLAIN = 2e-2
# K3 and K2 add the same bf16 weights (same affinity tiles); only the f32
# summation order differs.
TOL_K3_VS_K2 = 1e-4
# K1: sums of up to 16384 weights <= 1 times values <= 1 (outputs up to ~30);
# same rounding argument as the label kernels, larger sums.
TOL_K1_VS_PLAIN = 3e-2
# Attention outputs are averages of values of size ~1: a probability that
# rounds to the neighbouring bf16 value moves an output by a few bf16 ulps.
TOL_ATTN_MAX = 0.05
TOL_ATTN_MEAN = 1e-3
# CLIP-search predictions, app (kernels) vs plain version: a cache logit that
# differs by one bf16 weight step flips an argmax only at a near tie.
TOL_PRED_AGREE = 0.99
# ... and the comparison means something only if the cache logits decide
# predictions at all: at the largest alpha they must change this share of them.
MIN_PRED_CHANGED = 0.10
# Zero-shot scores are cosines; a bf16 text classifier at cosine 0.9998 of the
# f32 one moves a score by at most sqrt(2 (1 - 0.9998)) = 0.02.
TOL_OUTS_VS_CPU = 0.02
# K7 / K10 vs their plain versions: the same exact products (bf16 x int8 or bf16
# is exact in f32), f32 sums in another order. Relative to the largest output.
TOL_GEMV_REL = 1e-4
# K10 also rounds the hidden to bf16 between its products: a hidden that differs
# in its last f32 bit may round to the neighbouring bf16 value (2^-9 relative),
# one term of 5120 in an output.
TOL_QMLP_REL = 1e-3
# K11 f32 vs the plain f32 softmax: other summation order, expf vs torch's exp.
TOL_FLASH_F32 = 2e-5
# The gradient gate of the training path: one CoOp batch through the kernel
# route (K5 / K6 forwards, plain recompute backwards) against the route that
# launches no kernel, both bf16. The routes' forwards differ by bf16 roundings
# of intermediates, which the backward sees through its inputs. Limits set
# between the routes' readings and a planted fault's (64 of block 5's 3072
# hidden units zeroed in c_fc), both printed by the script. Two runs on the
# H100 (the trained prompt differs between runs): routes 4.9e-5 and 9.1e-5 /
# 9.4e-3 and 7.5e-3 / 1 - 4e-5 and 1 - 3e-5, the fault 3.5e-4 and 3.4e-4 /
# 3.7e-2 and 3.5e-2 / 1 - 7.0e-4 and 1 - 6.3e-4 (PERF.md section 6). The
# cosine separates them best; any one reading past its limit fails the gate.
TOL_GATE_LOSS = 2.5e-4      # |loss_kernel - loss_plain| / |loss_plain|
TOL_GATE_GRAD_REL = 2e-2    # |g_kernel - g_plain| / |g_plain|, the prompt gradient
TOL_GATE_GRAD_COS = 0.9998  # cosine of the two prompt gradients
# save_features in "mlp" mode (K9) against the "block" mode store (plain MLP):
# the same function in bf16, sums in another order
TOL_MODE_STORE_COS = 0.999


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def versions() -> str:
    import torch

    from summer_clip_torch.ops import _lib

    nvcc = subprocess.run([_lib._nvcc(), "--version"], capture_output=True, text=True)
    nvcc_v = nvcc.stdout.strip().splitlines()[-1] if nvcc.returncode == 0 else "missing"
    try:
        import triton
        triton_v = triton.__version__
    except ImportError:
        triton_v = "not installed"
    return (f"python {sys.version.split()[0]} | torch {torch.__version__} | "
            f"torch CUDA {torch.version.cuda} | nvcc {nvcc_v} | triton {triton_v}")


def exp_rate() -> float:
    """Exponentials a second the card's special-function units retire."""
    return EXP_PER_CLOCK_SM * CARD["sms"] * CARD["sm_clock_hz"]


def bound(bytes_moved: float, bf16_flops: float, f32_flops: float = 0.0,
          exps: float = 0.0) -> dict:
    """The least time the card could take: bytes at the memory rate against
    operations at the peak rate of their type; exponentials (``exps``) on the
    special-function units, which run beside the other units."""
    by_bytes = bytes_moved / PEAK_BYTES * 1e3
    by_ops = max(bf16_flops / PEAK_BF16 + f32_flops / PEAK_F32, exps / exp_rate()) * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def read_card_clock() -> None:
    """The SM count and the maximum SM clock of card 0 into ``CARD``."""
    import torch

    CARD["sms"] = torch.cuda.get_device_properties(0).multi_processor_count
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True, text=True,
                         timeout=60)
    if out.returncode == 0 and out.stdout.strip():
        CARD["sm_clock_hz"] = float(out.stdout.strip().splitlines()[0]) * 1e6


def cuda_time_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# --------------------------------------------------------------------------- #
# phase 3: kernels against their plain versions
# --------------------------------------------------------------------------- #
def _randn(shape, gen, scale=1.0, dtype=None, device="cuda"):
    import torch

    t = torch.randn(shape, generator=gen) * scale
    return t.to(device=device, dtype=dtype or torch.bfloat16)


def block_params(d: int, gen):
    import torch

    f32 = torch.float32
    return dict(
        ln_w=_randn((d,), gen, 0.1, f32) + 1.0, ln_b=_randn((d,), gen, 0.1, f32),
        in_w=_randn((3 * d, d), gen, d ** -0.5), in_b=_randn((3 * d,), gen, 0.02),
        out_w=_randn((d, d), gen, d ** -0.5), out_b=_randn((d,), gen, 0.02),
        fc_w=_randn((4 * d, d), gen, d ** -0.5), fc_b=_randn((4 * d,), gen, 0.02),
        proj_w=_randn((d, 4 * d), gen, (4 * d) ** -0.5), proj_b=_randn((d,), gen, 0.02))


BLOCK_SHAPES = {   # (B, T, D, heads, causal) of the towers' residual blocks
    "vit_b16_image": (32, 197, 768, 12, False),
    "vit_b16_text": (256, 77, 512, 8, True),
    "vit_l14_text": (256, 77, 768, 12, True),
    "coop_l14_text": (1000, 77, 768, 12, True),   # train_coop: 1000 class prompts a forward
    "vit_l14_image": (32, 257, 1024, 16, False)}


def check_block_kernels(results: dict) -> None:
    import torch

    from summer_clip_torch.ops import block_kernels as bk

    gen = torch.Generator().manual_seed(0)
    for tower, (b, t, d, heads, causal) in BLOCK_SHAPES.items():
        p = block_params(d, gen)
        x = _randn((b, t, d), gen)
        attn_args = (x, p["ln_w"], p["ln_b"], p["in_w"], p["in_b"], p["out_w"], p["out_b"])
        mlp_args = (x, p["ln_w"], p["ln_b"], p["fc_w"], p["fc_b"], p["proj_w"], p["proj_b"])
        cases = {
            "K5 fused_ln_attn": (
                lambda a=attn_args: bk.fused_ln_attn(*a, num_heads=heads, causal=causal),
                lambda: bk.ln_attn_reference(*attn_args, num_heads=heads, causal=causal),
                attn_args),
            "K6 fused_ln_mlp": (lambda a=mlp_args: bk.fused_ln_mlp(*a),
                                lambda: bk.ln_mlp_reference(*mlp_args), mlp_args),
        }
        if tower == "vit_l14_image":
            cases = {"K9 fused_ln_mlp_chunked": (lambda a=mlp_args: bk.fused_ln_mlp_chunked(*a),
                                                 lambda: bk.ln_mlp_reference(*mlp_args),
                                                 mlp_args)}
        for name, (kern, plain, args) in cases.items():
            got, want = kern(), plain()
            torch.cuda.synchronize()
            diff = (got.float() - want.float()).abs()
            err, mean_err = float(diff.max()), float(diff.mean())
            if not torch.isfinite(got).all():
                raise AssertionError(f"{name} {tower}: non-finite output")
            ms, plain_ms = cuda_time_ms(kern, 20), cuda_time_ms(plain, 20)
            prev = (baseline_ms(kern, 20, "block_kernels") if name.startswith("K9")
                    else baseline_block_ms(kern, name, args, heads, causal, 20))
            log(f"{name:18s} {tower:14s} B={b} T={t} D={d} heads={heads} causal={causal}: "
                f"max|d|={err:.3e} (tol {TOL_BLOCK_MAX}) mean|d|={mean_err:.3e} "
                f"(tol {TOL_BLOCK_MEAN}) kernel {ms:.4f} ms plain {plain_ms:.4f} ms"
                + in_turns(prev))
            if err > TOL_BLOCK_MAX or mean_err > TOL_BLOCK_MEAN:
                raise AssertionError(f"{name} {tower}: kernel disagrees with its plain version")
            # sums in one fixed order: the same bits twice, a sequence alone as among others
            again = kern()
            alone = kern((x[7:8].contiguous(), *args[1:]))
            torch.cuda.synchronize()
            log(f"{name.split()[0]} {tower}: two runs bit for bit: {torch.equal(got, again)}; "
                f"sequence 7 alone == among {b}: {torch.equal(alone[0], got[7])}")
            if not (torch.equal(got, again) and torch.equal(alone[0], got[7])):
                raise AssertionError(f"{name} {tower}: not deterministic, or a row depends on "
                                     f"others")
            if not name.startswith("K9"):
                log(f"{name.split()[0]} {tower} chain: " + ", ".join(
                    f"{step} {step_ms:.4f} ms" for step, step_ms in
                    block_chain_ms(name, args, heads, causal).items()))
            m = b * t
            weights = 4 * d * d if name.startswith("K5") else 8 * d * d
            # a causal row's scores and products reach only (t + 1) / 2 keys on average
            pairs = t * (t + 1) // 2 if causal else t * t
            flops = (2 * m * d * 4 * d + 4 * b * heads * pairs * (d // heads)
                     if name.startswith("K5") else 2 * 2 * m * d * 4 * d)
            r = results.setdefault(name, {"max_abs_err": 0.0, "shapes": {}, "library_ms": None})
            r["max_abs_err"] = max(r["max_abs_err"], err)
            r["shapes"][tower] = {"ms": ms, "plain_ms": plain_ms, "max_abs_err": err,
                                  **({"baseline_ms": prev[0], "in_turns_ms": prev[1]}
                                     if prev else {}),
                                  **bound(2 * (2 * m * d + weights), flops)}
        if tower == "vit_b16_image":
            results["c_fc yardstick"] = gemm_yardstick(x.view(b * t, d), p["fc_w"], p["fc_b"])
    torch.cuda.synchronize()


def block_chain_ms(name: str, args, heads: int, causal: bool) -> dict:
    """The launches of K5's or K6's chain (the wrapper's own list) timed one
    by one on the call's inputs, after one run of the chain has written every
    intermediate."""
    from summer_clip_torch.ops import block_kernels as bk

    if name.startswith("K5"):
        chain = bk._attn_chain(*args, num_heads=heads, causal=causal, eps=1e-5)
    else:
        chain = bk._mlp_chain(*args, eps=1e-5)
    bk._run(chain)
    return {step: cuda_time_ms(launch, 20) for step, launch in chain[0]}


def gemm_yardstick(y, fc_w, fc_b) -> dict:
    """cuBLAS (``torch.matmul``) on K6's c_fc product at the ViT-B/16 image
    shape, beside the port's own GEMM on the same product: a yardstick for the
    GEMM design, used nowhere in the port. The L2 intake each implies is
    counted at 128 x 256 tiles (what a tile of that size takes in a call)."""
    import torch

    from summer_clip_torch.ops import _lib
    from summer_clip_torch.ops import block_kernels as bk

    m, k = y.shape
    n = fc_w.shape[0]
    lib, stream = bk._lib_block(), _lib.torch_stream()
    mm_ms = cuda_time_ms(lambda: torch.matmul(y, fc_w.t()), 20)
    ours_ms = cuda_time_ms(lambda: bk._gemm(lib, y, fc_w, fc_b, "bias", stream), 20)
    flops = 2 * m * n * k
    intake = -(-m // 128) * -(-n // 256) * (128 + 256) * k * 2
    # the QuickGELU epilogue against the plain quick_gelu (torch.sigmoid) on
    # the bias epilogue's h: its sigmoid (the special-function unit's) may
    # round to the bf16 next to torch.sigmoid's, so an output may move by one
    # bf16 ulp of the sigmoid times |h|, with the product's rounding |h| 2^-7
    h = bk._gemm(lib, y, fc_w, fc_b, "bias", stream)
    got, want = bk._gemm(lib, y, fc_w, fc_b, "gelu", stream), bk.quick_gelu(h)
    gelu_differ = int((got != want).sum())
    past = int(((got.float() - want.float()).abs() > h.float().abs() * 2.0 ** -7).sum())
    out = {"cublas_ms": mm_ms, "gemm_ms": ours_ms, "flops": flops, "intake_bytes_128x256": intake,
           "gemm_tile": bk.gemm_tile(m, n, k), "gelu_outputs_differing": gelu_differ}
    log(f"c_fc QuickGELU epilogue against quick_gelu on its bias epilogue's h: {gelu_differ} of "
        f"{m * n} outputs differ, {past} by more than |h| 2^-7 (gate 0)")
    if past:
        raise AssertionError("K6's QuickGELU epilogue is past one sigmoid ulp of quick_gelu")
    log(f"c_fc yardstick ({m} x {k}) . ({k} x {n}) bf16: cuBLAS {mm_ms:.4f} ms "
        f"({flops / mm_ms / 1e9:.1f} TFLOP/s, {intake / mm_ms / 1e9:.2f} TB/s of L2 intake at "
        f"128 x 256 tiles); block_gemm + bias (tile {out['gemm_tile']}) {ours_ms:.4f} ms "
        f"({flops / ours_ms / 1e9:.1f} TFLOP/s)")
    return out


def label_bound(nt: int, n_real: int, d: int, c: int, nb: int) -> dict:
    """K2's and K3's bound: bf16 features and int32 labels read once, the f32
    output written once; the affinity's products on the tensor cores, one
    exponential (special-function units) and one add a (query, row, beta)."""
    return bound(2 * (nt + n_real) * d + 4 * n_real + 4 * nb * nt * c,
                 2 * nt * n_real * d, nb * nt * n_real, nb * nt * n_real)


def check_cache_kernels(results: dict) -> None:
    import numpy as np
    import torch

    from summer_clip_torch.methods.tip import beta_alpha_grid
    from summer_clip_torch.ops import cache_kernels as ck

    nt, per_class, c, d = 8192, 16, 1000, 512
    rng = np.random.default_rng(0)

    def unit(n):
        a = rng.standard_normal((n, d)).astype(np.float32)
        return torch.from_numpy(a / np.linalg.norm(a, axis=1, keepdims=True)).cuda()

    f, keys = unit(nt), unit(per_class * c)
    labels = np.repeat(np.arange(c, dtype=np.int32), per_class)        # class-grouped
    betas = torch.from_numpy(beta_alpha_grid((7, 3), (200, 20))[0][::12][:16]).cuda()
    perm = rng.permutation(labels.shape[0])
    keys_sh, labels_sh = keys[torch.from_numpy(perm).cuda()], labels[perm]
    if ck.onehot_k_max(labels, c, d, 2) > 128 or ck.onehot_k_max(labels_sh, c, d, 2) <= 128:
        raise AssertionError("route test: grouped cache must take K3, shuffled K2")

    def plain(k, lab):
        return ck.cache_attention_labels_reference(
            f, k, torch.from_numpy(lab), betas, c, compute_dtype=torch.bfloat16)

    k3 = lambda: ck.cache_attention_onehot(f, keys, labels, betas, c)       # noqa: E731
    k2 = lambda: ck.cache_attention_labels(f, keys_sh, labels_sh, betas, c)  # noqa: E731
    want = plain(keys, labels)
    got3, got2, again3 = k3(), k2(), k3()
    got2_grouped = ck.cache_attention_labels(f, keys, labels, betas, c)
    torch.cuda.synchronize()
    e3 = float((got3 - want).abs().max())
    e2 = float((got2 - want).abs().max())
    e32 = float((got3 - got2_grouped).abs().max())
    shape = f"Nt={nt} Nc={per_class * c} D={d} C={c} betas={betas.shape[0]}"
    ms3, ms2 = cuda_time_ms(k3, 3, 1), cuda_time_ms(k2, 3, 1)
    plain_ms = cuda_time_ms(lambda: plain(keys, labels), 2, 1)
    prev3 = baseline_label_ms(k3, "onehot_grouped", f, keys, labels, betas, c)
    prev2 = baseline_label_ms(k2, "labels_dense", f, keys_sh, labels_sh, betas, c)
    nc, nb = per_class * c, int(betas.shape[0])
    work = label_bound(nt, nc, d, c, nb)
    log(f"K3 onehot_grouped   grouped cache  {shape}: max|d| vs plain={e3:.3e} "
        f"(tol {TOL_CACHE_VS_PLAIN}) kernel {ms3:.4f} ms plain {plain_ms:.4f} ms "
        f"bound {work['bound_ms']:.4f} ms ({work['bound_by']})" + in_turns(prev3))
    log(f"K2 labels_dense     shuffled cache {shape}: max|d| vs plain={e2:.3e} "
        f"(tol {TOL_CACHE_VS_PLAIN}) kernel {ms2:.4f} ms plain {plain_ms:.4f} ms" + in_turns(prev2))
    log(f"K3 == K2 on the grouped cache: max|d|={e32:.3e} (tol {TOL_K3_VS_K2}); "
        f"two runs equal: {bool(torch.equal(got3, again3))}")
    if not (torch.isfinite(got3).all() and torch.isfinite(got2).all()):
        raise AssertionError("cache kernels: non-finite output")
    if e3 > TOL_CACHE_VS_PLAIN or e2 > TOL_CACHE_VS_PLAIN or e32 > TOL_K3_VS_K2:
        raise AssertionError("cache kernels disagree")
    if not torch.equal(got3, again3):
        raise AssertionError("K3: two runs differ")
    results["K3 onehot_grouped"] = {
        "max_abs_err": e3, "ms": ms3, "plain_ms": plain_ms, "k3_vs_k2": e32, "library_ms": None,
        **({"baseline_ms": prev3[0], "in_turns_ms": prev3[1]} if prev3 else {}), **work}
    results["K2 labels_dense"] = {
        "max_abs_err": e2, "ms": ms2, "plain_ms": plain_ms, "library_ms": None, "shapes": {},
        **({"baseline_ms": prev2[0], "in_turns_ms": prev2[1]} if prev2 else {}), **work}
    check_weight_rate()

    # K3 as CLIP-search gives it: D=768, 1000 test rows, a prediction-sorted
    # selection padded with label -1 to a multiple of 1024 rows, the config's 8
    # betas. Once with predictions collapsed onto a few classes (what a random
    # model gives), once spread over 100 classes. K2 on the same labels
    # shuffled (CLIP-search's scattered pseudo-labels take K2).
    d, nt = 768, 1000
    f = unit(nt)
    betas8 = torch.tensor([0.1, 1.0, 1.5, 3.5, 5.5, 7.5, 9.5, 11.5], device="cuda")
    shapes = results["K3 onehot_grouped"]["shapes"] = {}
    for case, real in {
            "search_collapsed": np.sort(rng.choice([7, 421, 998], 2000, p=[0.9, 0.07, 0.03])),
            "search_100_classes": np.repeat(np.arange(0, 1000, 10), 6)}.items():
        lab = np.full((-(-real.shape[0] // 1024) * 1024,), -1, np.int32)
        lab[:real.shape[0]] = real
        keys = unit(lab.shape[0])
        if ck.onehot_k_max(lab, c, d, 2) > 128:
            raise AssertionError(f"route test: {case} must take K3")
        kern = lambda: ck.cache_attention_from_labels(f, keys, lab, betas8, c)   # noqa: E731
        ref = lambda: ck.cache_attention_labels_reference(                       # noqa: E731
            f, keys, torch.from_numpy(lab), betas8, c, compute_dtype=torch.bfloat16)
        before = ck.cache_attention_onehot.launches
        got, want = kern(), ref()
        torch.cuda.synchronize()
        if ck.cache_attention_onehot.launches != before + 1:
            raise AssertionError(f"{case}: the label route did not launch K3")
        err = float((got - want).abs().max())
        ms, ref_ms = cuda_time_ms(kern, 5, 1), cuda_time_ms(ref, 5, 1)
        prev = baseline_label_ms(kern, "onehot_grouped", f, keys, lab, betas8, c)
        n_real = real.shape[0]
        work = label_bound(nt, n_real, d, c, 8)
        log(f"K3 onehot_grouped   {case:18s} Nt={nt} Nc={lab.shape[0]} ({n_real} real) "
            f"D={d} C={c} betas=8: max|d| vs plain={err:.3e} (tol {TOL_CACHE_VS_PLAIN}) "
            f"kernel {ms:.4f} ms plain {ref_ms:.4f} ms bound {work['bound_ms']:.4f} ms"
            + in_turns(prev))
        if not torch.isfinite(got).all() or err > TOL_CACHE_VS_PLAIN:
            raise AssertionError(f"K3 {case}: kernel disagrees with its plain version")
        shapes[case] = {"ms": ms, "plain_ms": ref_ms, "max_abs_err": err,
                        **({"baseline_ms": prev[0], "in_turns_ms": prev[1]} if prev else {}),
                        **work}
        results["K3 onehot_grouped"]["max_abs_err"] = max(
            results["K3 onehot_grouped"]["max_abs_err"], err)
        # K2: the same rows in another order
        sh = rng.permutation(lab.shape[0])
        keys_s, lab_s = keys[torch.from_numpy(sh).cuda()], lab[sh]
        k2s = lambda: ck.cache_attention_labels(f, keys_s, lab_s, betas8, c)   # noqa: E731
        got2 = k2s()
        torch.cuda.synchronize()
        err2 = float((got2 - want).abs().max())
        ms2 = cuda_time_ms(k2s, 5, 1)
        log(f"K2 labels_dense     {case:18s} shuffled: max|d| vs plain={err2:.3e} "
            f"(tol {TOL_CACHE_VS_PLAIN}) kernel {ms2:.4f} ms plain {ref_ms:.4f} ms")
        if not torch.isfinite(got2).all() or err2 > TOL_CACHE_VS_PLAIN:
            raise AssertionError(f"K2 {case} shuffled: kernel disagrees with its plain version")
        results["K2 labels_dense"]["shapes"][case] = {"ms": ms2, "plain_ms": ref_ms,
                                                      "max_abs_err": err2, **work}
        results["K2 labels_dense"]["max_abs_err"] = max(
            results["K2 labels_dense"]["max_abs_err"], err2)
    torch.cuda.synchronize()


def check_blend_argmax(results: dict) -> None:
    """K14 at a Tip chunk: (16, 50,000, 1,000) cache logits and the grid's 20
    alphas, half the rows on a 0.5 grid (exact ties, lowest index) with labels
    at a tied maximum, against the plain version bit for bit; two runs equal."""
    import torch

    from summer_clip_torch.methods.tip import beta_alpha_grid
    from summer_clip_torch.ops import cache_kernels as ck

    nb, nt, c = 16, 50000, 1000
    gen = torch.Generator(device="cuda").manual_seed(5)
    cl = torch.randn(nt, c, device="cuda", generator=gen) * 4
    cache = torch.rand(nb, nt, c, device="cuda", generator=gen)
    half = nt // 2
    cl[:half] = torch.randint(0, 4, (half, c), device="cuda", generator=gen) * 0.5
    cache[:, :half] = torch.randint(0, 3, (nb, half, c), device="cuda", generator=gen) * 0.5
    alphas = torch.from_numpy(beta_alpha_grid((7, 3), (200, 20))[1]).cuda()
    alphas[-1] = 1.0        # exact blends on the grid rows: ties
    labels = torch.randint(0, c, (nt,), device="cuda", generator=gen)
    labels[:half] = (cl[:half] + cache[0, :half]).argmax(-1)
    kern = lambda: ck.blend_argmax_hits(cache, cl, labels, alphas)     # noqa: E731
    plain = lambda: ck.blend_argmax_hits_reference(cache, cl, labels, alphas)  # noqa: E731
    got, again, want = kern(), kern(), plain()
    torch.cuda.synchronize()
    equal, repeat = bool(torch.equal(got, want)), bool(torch.equal(got, again))
    ms, plain_ms = cuda_time_ms(kern, 10), cuda_time_ms(plain, 2, 1)
    work = bound(nb * nt * c * 4 + nt * c * 4 + nt * 8 + nb * 20 * 4, 0.0, 2.0 * nb * nt * c * 20)
    log(f"K14 blend_argmax_hits Tip chunk betas={nb} Nt={nt} C={c} alphas=20: counts equal to "
        f"plain {equal}, two runs equal {repeat}, hits {int(got.sum())} of {nb * 20 * nt}; "
        f"kernel {ms:.4f} ms ({ms / nb:.4f} a beta) plain {plain_ms:.4f} ms bound "
        f"{work['bound_ms']:.4f} ms ({work['bound_by']})")
    if not (equal and repeat):
        raise AssertionError("K14: counts differ from the plain version or between runs")
    results["K14 blend_argmax_hits"] = {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
                                        "library_ms": None, "shapes": {}, **work}


def check_weight_rate() -> None:
    """What a loop of nothing but weights reaches on the card (no tiles, no
    boundaries, no stores): the ceiling of the label kernels' walk."""
    import torch

    from summer_clip_torch.ops import _lib
    from summer_clip_torch.ops import cache_kernels as ck

    betas = torch.linspace(0.1, 11.5, 16, device="cuda")
    blocks, rows = CARD["sms"], 1 << 16
    out = torch.empty(blocks * 256, device="cuda")
    lib = ck._lib_cache()
    ms = cuda_time_ms(lambda: _lib.check(lib.weight_rate_probe_bf16(
        betas.data_ptr(), out.data_ptr(), rows, blocks, _lib.torch_stream()), "weight_rate"), 3)
    rate = blocks * 256 * rows * 4 / (ms * 1e-3)
    per_clock = rate / CARD["sms"] / CARD["sm_clock_hz"]
    log(f"weight-rate probe: {rate:.3e} bf16 weights/s = {per_clock:.2f} a clock an SM at the "
        f"max SM clock ({rate / exp_rate():.2f} of the exponential rate)")


def in_turns(prev: tp.Optional[tuple]) -> str:
    return f"; in turns: baseline {prev[0]:.4f} ms, kernel {prev[1]:.4f} ms" if prev else ""


# --only: the checks of one kernel family (its main source first); --baseline:
# earlier copies of its sources, built beside them and timed in turns with them
ONLY_SOURCES = {"attention": "attention_kernels", "block": "block_kernels",
                "cache": "cache_kernels", "decode": "decode_kernels"}
ONLY_BUILDS = {"attention": ("attention_kernels", "block_kernels"),   # the towers run both
               "block": ("block_kernels", "attention_kernels"),
               "cache": ("cache_kernels",),
               "decode": ("gemv_kernels", "decode_kernels")}


def _ops_module(source: str):
    import importlib

    return importlib.import_module(
        {"attention_kernels": "summer_clip_torch.ops.attention",
         "block_kernels": "summer_clip_torch.ops.block_kernels",
         "cache_kernels": "summer_clip_torch.ops.cache_kernels",
         "gemv_kernels": "summer_clip_torch.ops.gemv",
         "decode_kernels": "summer_clip_torch.ops.decode_block"}[source])


def baseline_source(only: str, src: str) -> str:
    """The source an old copy given to ``--baseline`` stands for: its file name,
    which must be one of the ``--only`` family's sources."""
    name = Path(src).stem
    if name not in ONLY_BUILDS[only]:
        raise ValueError(f"--baseline {src}: --only {only} takes "
                         f"{' or '.join(f'{n}.cu' for n in ONLY_BUILDS[only])}")
    return name


def load_baseline(src: str, source: str):
    """Build another copy of ``csrc/<source>.cu`` (an earlier design,
    ``--baseline``) with the port's flags against the headers beside it (its
    own commit's; a header that is not there comes from this tree), and declare
    the entry points of the tree's wrapper module that it has: its times stand
    beside the kernels' in the checks, in turns on the same inputs."""
    import shutil

    from summer_clip_torch.ops import _lib

    out_dir = Path(tempfile.mkdtemp(prefix=f"{source}_baseline_"))
    for header in _lib.CSRC_DIR.glob("*.cuh"):     # an older source may include fewer
        shutil.copy(header, out_dir)
    for header in Path(src).resolve().parent.glob("*.cuh"):   # the old source's own
        shutil.copy(header, out_dir)
    shutil.copy(src, out_dir / f"{source}.cu")
    out = out_dir / f"lib{source}_baseline.so"
    proc = subprocess.run([_lib._nvcc(), *_lib.NVCC_FLAGS, "-o", str(out),
                           str(out_dir / f"{source}.cu")], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for the baseline {src}:\n{proc.stderr[-4000:]}")
    lib = ctypes.CDLL(str(out))
    signatures = dict(_ops_module(source)._SIGNATURES)
    if source == "cache_kernels" and not hasattr(lib, "grouped_stages"):
        signatures.update(PER_GROUP_LABEL_SIGNATURES)   # the label kernels before the template
    if source == "block_kernels" and not hasattr(lib, "block_gemm_bf16"):
        signatures.update(PER_HEAD_BLOCK_SIGNATURES)    # K5 and K6 before the GEMM chain
    if source == "gemv_kernels" and not hasattr(lib, "cluster_qmatmul_i8"):
        signatures.update(WORKSPACE_K7_SIGNATURES)      # K7 before the cluster reduction
    lib.two_launch_k10 = source == "gemv_kernels" and "qmlp_reduce_kernel" in Path(src).read_text()
    if lib.two_launch_k10:
        signatures.update(TWO_LAUNCH_K10_SIGNATURES)    # K10 before the single launch
    if source == "decode_kernels" and not hasattr(lib, "decode_stack"):
        signatures.update(WORKSPACE_K8_SIGNATURES)      # K8 before the weight ring
    for fn, argtypes in signatures.items():
        if hasattr(lib, fn):
            f = getattr(lib, fn)
            f.argtypes, f.restype = list(argtypes), ctypes.c_int
    return lib


# The label kernels' entry points before the class-grouped template (K2 a
# dense WMMA product, K3 and K13 a block per 16-class group): the sorted rows
# and class offsets, or the labels, instead of the template's host tables.
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
PER_GROUP_LABEL_SIGNATURES = {
    "labels_dense_bf16": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "onehot_grouped_bf16": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "onehot_variant_bf16": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
}


def per_group_label_call(lib, name: str, f, keys, labels, betas, c: int,
                         block_n: int = 1, mode: int = 0):
    """One call of a per-group-design label kernel, its arguments made as
    its wrapper made them: K2 takes all betas at once over 16-row query and
    128-row cache padding; K3 and K13 take 16 betas a launch over 64-row query
    padding and the host's class-row table."""
    import numpy as np
    import torch

    from summer_clip_torch.ops import _lib
    from summer_clip_torch.ops import cache_kernels as ck

    nt, stream = f.shape[0], _lib.torch_stream()
    bet = betas.float().contiguous()
    out = torch.empty(bet.shape[0], nt, c, dtype=torch.float32, device=f.device)
    if name == "labels_dense":
        ff, cf, nt_p, nc_p, d_p = ck._cuda_features(f, keys, 16, 128)
        lab = torch.full((nc_p,), -1, dtype=torch.int32, device=f.device)
        lab[:keys.shape[0]] = torch.from_numpy(np.asarray(labels, np.int32)).to(f.device)
        _lib.check(lib.labels_dense_bf16(ff.data_ptr(), cf.data_ptr(), lab.data_ptr(),
                                         bet.data_ptr(), out.data_ptr(), bet.shape[0], nt, nt_p,
                                         nc_p, d_p, c, stream), name)
        return out
    ff, cf, nt_p, _, d_p = ck._cuda_features(f, keys, 64)
    rows, offs = ck.class_row_table(np.asarray(labels, np.int32), c)
    rows_t, offs_t = torch.from_numpy(rows).to(f.device), torch.from_numpy(offs).to(f.device)
    extra = (block_n, mode, 0) if name == "onehot_variant" else ()
    for s in range(0, bet.shape[0], 16):
        chunk, view = bet[s:s + 16].contiguous(), out[s:s + 16]
        _lib.check(getattr(lib, f"{name}_bf16")(
            ff.data_ptr(), cf.data_ptr(), rows_t.data_ptr(), offs_t.data_ptr(), chunk.data_ptr(),
            view.data_ptr(), chunk.shape[0], nt, nt_p, d_p, c, *extra, stream), name)
    return out


# K5's and K6's entry points before the GEMM chain: K5 a WMMA block per
# (sequence, head) making q/k/v, scores and o, then linear_residual (out_proj);
# K6 a WMMA block per 32- or 48-row tile over all D columns
PER_HEAD_BLOCK_SIGNATURES = {
    "ln_attn_heads_bf16": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
    "linear_residual_bf16": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
    "ln_mlp_bf16": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _P],
}


def per_head_block_call(lib, name: str, args, heads: int, causal: bool):
    """One K5 or K6 call of the design before the GEMM chain, on its own entries."""
    import torch

    from summer_clip_torch.ops import _lib

    x, ln_w, ln_b, w1, b1, w2, b2 = args
    b, t, d = x.shape
    stream, out = _lib.torch_stream(), torch.empty_like(x)
    if name.startswith("K5"):
        o = torch.empty_like(x)
        _lib.check(lib.ln_attn_heads_bf16(x.data_ptr(), ln_w.data_ptr(), ln_b.data_ptr(),
                                          w1.data_ptr(), b1.data_ptr(), o.data_ptr(), b, t, d,
                                          heads, int(causal), 1e-5, stream), "ln_attn_heads")
        _lib.check(lib.linear_residual_bf16(o.data_ptr(), w2.data_ptr(), b2.data_ptr(),
                                            x.data_ptr(), out.data_ptr(), b * t, d, d, stream),
                   "linear_residual")
    else:
        _lib.check(lib.ln_mlp_bf16(x.data_ptr(), ln_w.data_ptr(), ln_b.data_ptr(), w1.data_ptr(),
                                   b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), out.data_ptr(),
                                   b * t, d, w1.shape[0], 1e-5, stream), "ln_mlp")
    return out


# K7's and K8's entry points of the workspace-and-ticket design (PR 3's K7,
# PR 4's K8): split-K partials in a workspace, added by the last block to
# arrive at a column tile; K8 one cooperative launch
WORKSPACE_K7_SIGNATURES = {f"streamed_qmatmul_{t}": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P]
                           for t in ("i8", "bf16", "f32")}
WORKSPACE_K8_SIGNATURES = {"decode_block": [_P, _P, _I, _I, _P, _P]}
_OLD_SCRATCH: dict = {}


def _old_scratch(kind: str, numel: int, dtype):
    """Zeroed scratch of the old designs, grown on demand (their tickets go
    back to zero after every launch)."""
    import torch

    buf = _OLD_SCRATCH.get(kind)
    if buf is None or buf.numel() < numel:
        buf = _OLD_SCRATCH[kind] = torch.zeros(max(numel, 1024), dtype=dtype, device="cuda")
    return buf


def workspace_k7_call(lib, x, w, scale):
    """One K7 call of the workspace-and-ticket design on its own entry: 128-
    column tiles, K split until the tiles reach 264 blocks, in chunks of 64 to
    1024 rows (its wrapper's rule)."""
    import torch

    from summer_clip_torch.ops import _lib

    k, n = w.shape
    rows, size = x.shape[0], w.element_size()
    tiles = -(-n // (8 * (16 // size)))
    splits = max(1, min(round(2 * 132 / tiles), k // 64))
    chunk = -(-k // splits)
    chunk = min(1024, -(-chunk // 32) * 32)
    out = torch.empty((rows, n), dtype=torch.float32, device=x.device)
    ws = _old_scratch("k7_partials", -(-k // chunk) * rows * n, torch.float32)
    tickets = _old_scratch("k7_tickets", tiles, torch.int32)
    entry = {1: "streamed_qmatmul_i8", 2: "streamed_qmatmul_bf16", 4: "streamed_qmatmul_f32"}[size]
    _lib.check(getattr(lib, entry)(x.data_ptr(), w.data_ptr(),
                                   0 if scale is None else scale.data_ptr(), out.data_ptr(),
                                   ws.data_ptr(), tickets.data_ptr(), rows, k, n, chunk,
                                   _lib.torch_stream()), entry)
    return out


def workspace_k8_call(lib, x, packed, kv, idx, padv, nh: int):
    """One K8 call of the workspace-and-ticket design on its own entry (PR 4's
    cooperative launch: split-K partials and tickets, K chunks of 64 to 1024
    rows aiming at one work item an SM)."""
    import torch

    from summer_clip_torch.ops import _lib

    n_layer, batch, t, d = kv["k"].shape
    h = packed["w1"].shape[2]
    size = packed["wqkv"].element_size()
    shapes = ((d, 3 * d), (d, d), (d, h), (h, d))

    def chunk_of(k, n):
        tiles = -(-n // (8 * (16 // size)))
        splits = max(1, min(132 // tiles, k // 64))
        chunk = -(-k // splits)
        return min(1024, -(-chunk // 32) * 32)

    chunks = [chunk_of(k, n) for k, n in shapes]
    part = max(-(-k // c) * batch * n for (k, n), c in zip(shapes, chunks))
    work = _old_scratch("k8_work", batch * (4 * d + h) + part, torch.float32)
    qkv, att, hid, parts = work.split([batch * 3 * d, batch * d, batch * h,
                                       work.numel() - batch * (4 * d + h)])
    tickets = _old_scratch("k8_tickets", 8192, torch.int32)
    y = x.to(torch.float32).clone()
    kq = torch.empty((n_layer, batch, d), dtype=kv["k"].dtype, device=x.device)
    vq = torch.empty_like(kq)
    ksn = torch.empty((n_layer, batch, 1), dtype=torch.float32, device=x.device)
    vsn = torch.empty_like(ksn)
    tensors = [y, packed["wqkv"], packed["wproj"], packed["w1"], packed["w2"], packed["sqkv"],
               packed["bqkv"], packed["sproj"], packed["bproj"], packed["s1"], packed["b1"],
               packed["s2"], packed["b2"], packed["ln"], kv["k"], kv["v"], kv["ks"], kv["vs"],
               idx, padv, kq, vq, ksn, vsn, qkv, att, hid, parts, tickets]
    ptrs = (ctypes.c_void_p * 30)(*[a.data_ptr() for a in tensors], None)
    dims = (ctypes.c_int * 10)(n_layer, batch, t, d, h, nh, *chunks)
    _lib.check(lib.decode_block(ptrs, dims, int(size == 2), int(kv["k"].dtype == torch.bfloat16),
                                _lib.torch_stream(), None), "decode_block (baseline)")
    return y, kq, vq, ksn, vsn


# K10's entry point of the two-launch design: blocks of 32 hidden units write (H / 32,
# rows, D) partials to a workspace, a second kernel adds them in chunk order
TWO_LAUNCH_K10_SIGNATURES = {"fused_qmlp_i8": [_P] * 9 + [_I] * 3 + [_P]}


def two_launch_k10_call(lib, x, w1, s1, b1, w2, s2, b2):
    """One K10 call of the two-launch design on its own entry."""
    import torch

    from summer_clip_torch.ops import _lib

    rows, d = x.shape
    h = w1.shape[1]
    out = torch.empty((rows, d), dtype=torch.float32, device=x.device)
    part = _old_scratch("k10_partials", (h // 32) * rows * d, torch.float32)
    _lib.check(lib.fused_qmlp_i8(x.data_ptr(), w1.data_ptr(), s1.data_ptr(), b1.data_ptr(),
                                 w2.data_ptr(), s2.data_ptr(), b2.data_ptr(), out.data_ptr(),
                                 part.data_ptr(), rows, d, h, _lib.torch_stream()),
               "fused_qmlp (baseline)")
    return out


def on_baseline(source: str, fn):
    """``fn()`` with the wrapper module of ``source`` calling its ``--baseline``
    build (an earlier copy of the source with the same entry points)."""
    from summer_clip_torch.ops import _lib

    ours = _lib.load(source, _ops_module(source)._SIGNATURES)
    _lib._LIBS[source] = BASELINE[source]
    try:
        return fn()
    finally:
        _lib._LIBS[source] = ours


BASELINE: dict = {}    # source -> the --baseline build of it, when given


def in_turns_ms(old, new, timer) -> tuple:
    """(old, new) timed in turns, old, new, new, old, each pair averaged."""
    b1, k1, k2, b2 = (timer(f) for f in (old, new, new, old))
    return (b1 + b2) / 2, (k1 + k2) / 2


def baseline_ms(fn, iters: int, source: str) -> tp.Optional[tuple]:
    """The kernel call ``fn`` (from ``csrc/<source>.cu``) timed on the
    baseline build and on this tree's, in turns (baseline, kernel, kernel,
    baseline); None without a baseline of that source."""
    if source not in BASELINE:
        return None
    from summer_clip_torch.ops import _lib

    base = BASELINE[source]
    ours = _lib.load(source, _ops_module(source)._SIGNATURES)

    def on(which):
        _lib._LIBS[source] = which
        try:
            return cuda_time_ms(fn, iters)
        finally:
            _lib._LIBS[source] = ours

    b1, k1, k2, b2 = on(base), on(ours), on(ours), on(base)
    return (b1 + b2) / 2, (k1 + k2) / 2


def baseline_label_ms(fn, name: str, f, keys, labels, betas, c: int, iters: int = 3,
                      block_n: int = 1, mode: int = 0) -> tp.Optional[tuple]:
    """A label kernel call ``fn`` (K2 ``labels_dense``, K3 ``onehot_grouped``
    or K13 ``onehot_variant``) timed on the cache baseline and on this tree's
    build in turns; a baseline of the per-group design is called with its own
    arguments on the same inputs. None without a cache baseline."""
    if "cache_kernels" not in BASELINE:
        return None
    base = BASELINE["cache_kernels"]
    if hasattr(base, "grouped_stages"):
        return baseline_ms(fn, iters, "cache_kernels")
    old = lambda: per_group_label_call(base, name, f, keys, labels, betas, c,   # noqa: E731
                                       block_n, mode)
    old()
    b1, k1, k2, b2 = (cuda_time_ms(g, iters) for g in (old, fn, fn, old))
    return (b1 + b2) / 2, (k1 + k2) / 2


def baseline_block_ms(fn, name: str, args, heads: int, causal: bool,
                      iters: int) -> tp.Optional[tuple]:
    """K5 or K6 (``fn``) timed on the block baseline and on this tree's build
    in turns; a baseline of the design before the GEMM chain is called on its
    own entries with the same inputs (and its output held against the tree's
    kernel). None without a block baseline."""
    if "block_kernels" not in BASELINE:
        return None
    base = BASELINE["block_kernels"]
    if hasattr(base, "block_gemm_bf16"):
        return baseline_ms(fn, iters, "block_kernels")
    import torch

    old = lambda: per_head_block_call(base, name, args, heads, causal)   # noqa: E731
    err = float((old().float() - fn().float()).abs().max())
    torch.cuda.synchronize()
    log(f"{name.split()[0]} baseline against this tree's kernel: max|d|={err:.3e}")
    b1, k1, k2, b2 = (cuda_time_ms(g, iters) for g in (old, fn, fn, old))
    return (b1 + b2) / 2, (k1 + k2) / 2


def _attention_readings(got, want) -> tuple:
    import torch

    diff = (got.float() - want.float()).abs()
    if not torch.isfinite(got.float()).all():
        return float("inf"), float("inf")
    return float(diff.max()), float(diff.mean())


def check_attention_kernels(results: dict) -> None:
    """K4 at the ViT-L/14 image tower, at ViT-L/14@336 (T = 577), at its limit
    T = 640, at text shapes (causal) and in f32 at gen_gpt's perplexity shape
    for T = 512; K12 at (512, 257, 64). Each against its plain version and
    beside SDPA, with two planted faults read against the same limits: the
    plain version with the last key tile dropped, and with the causal mask
    shifted by one key."""
    import torch
    import torch.nn.functional as F

    from summer_clip_torch.ops import attention as at

    gen = torch.Generator().manual_seed(2)

    def run(name, shape_name, kern, plain, library, b, h, t, f32=False):
        got, want = kern(), plain()
        torch.cuda.synchronize()
        err, mean_err = _attention_readings(got, want)
        tol_max, tol_mean = (TOL_FLASH_F32, TOL_FLASH_F32) if f32 else (TOL_ATTN_MAX, TOL_ATTN_MEAN)
        ms, plain_ms, lib_ms = cuda_time_ms(kern, 20), cuda_time_ms(plain, 20), cuda_time_ms(library, 20)
        prev = baseline_ms(kern, 20, "attention_kernels")
        log(f"{name:25s} {shape_name:16s}: max|d|={err:.3e} (tol {tol_max}) "
            f"mean|d|={mean_err:.3e} (tol {tol_mean}) kernel {ms:.4f} ms plain "
            f"{plain_ms:.4f} ms SDPA {lib_ms:.4f} ms"
            + (f"; in turns: baseline {prev[0]:.4f} ms, kernel {prev[1]:.4f} ms" if prev else ""))
        if err > tol_max or mean_err > tol_mean:
            raise AssertionError(f"{name} {shape_name}: kernel disagrees with its plain version")
        r = results.setdefault(name, {"max_abs_err": 0.0, "shapes": {}})
        if not f32:      # the line's error is the bf16 kernel's; the f32 variant's is logged
            r["max_abs_err"] = max(r["max_abs_err"], err)
        flops = 4 * b * h * t * t * 64 // (2 if f32 else 1)   # the f32 case is causal
        r["shapes"][shape_name] = {
            "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms, "max_abs_err": err,
            **({"baseline_ms": prev[0]} if prev else {}),
            **(bound(4 * b * h * t * 64 * 4, 0, flops) if f32
               else bound(4 * b * h * t * 64 * 2, flops))}
        return got

    def fault(what, got, faulty_plain):
        """The check's readings of a kernel that computed ``faulty_plain``."""
        err, mean_err = _attention_readings(got, faulty_plain())
        log(f"  planted fault ({what}): max|d|={err:.3e} (tol {TOL_ATTN_MAX}) "
            f"mean|d|={mean_err:.3e} (tol {TOL_ATTN_MEAN})")
        if err <= TOL_ATTN_MAX and mean_err <= TOL_ATTN_MEAN:
            raise AssertionError(f"K4: the planted fault ({what}) reads within the limits")

    for shape_name, (b, t, d, heads, causal, dtype) in {
            "vit_l14_image": (32, 257, 1024, 16, False, torch.bfloat16),
            "vit_l14_336_image": (32, 577, 1024, 16, False, torch.bfloat16),
            "t640": (32, 640, 1024, 16, False, torch.bfloat16),
            "text_causal": (256, 77, 512, 8, True, torch.bfloat16),
            # train_gpt's causal self-attention at gpt2-large, T = 80
            "gpt2_large_train": (32, 80, 1280, 20, True, torch.bfloat16),
            # the int8 ViT-B/16 image tower (the bf16 one runs K5)
            "vit_b16_image": (32, 197, 768, 12, False, torch.bfloat16),
            # gen_gpt's perplexity pass over an f32 gpt2-large at T = 512: the f32 variant
            "gpt2_large_t512_f32": (8, 512, 1280, 20, True, torch.float32)}.items():
        # q, k, v as the tower has them: views of one fused projection
        q, k, v = _randn((b, t, 3 * d), gen, dtype=dtype).split(d, dim=-1)

        def heads_view(x):
            return x.view(b, t, heads, d // heads).transpose(1, 2)

        got = run("K4 short_attention_packed", shape_name,
                  lambda: at.short_attention_packed(q, k, v, num_heads=heads, causal=causal),
                  lambda: at.short_attention_packed_reference(q, k, v, num_heads=heads,
                                                              causal=causal),
                  lambda: F.scaled_dot_product_attention(heads_view(q), heads_view(k),
                                                         heads_view(v), is_causal=causal),
                  b, heads, t, f32=dtype == torch.float32)
        if shape_name == "vit_l14_image":
            keep = (t - 1) // 64 * 64      # keys before the last tile
            fault(f"keys {keep}..{t - 1} dropped", got, lambda: at.mha_reference(
                heads_view(q), heads_view(k)[..., :keep, :],
                heads_view(v)[..., :keep, :]).transpose(1, 2).reshape(b, t, d))
        if shape_name == "text_causal":
            fault("causal mask shifted by one key", got, lambda: at.mha_reference(
                heads_view(q), heads_view(k), heads_view(v),
                mask=at._causal_bias(t, t, 1, device="cuda")).transpose(1, 2).reshape(b, t, d))
        del q, k, v, got
    q, k, v = (_randn((512, 257, 64), gen) for _ in range(3))
    run("K12 short_attention", "vit_l14_image", lambda: at.short_attention(q, k, v),
        lambda: at.mha_reference(q, k, v),
        lambda: F.scaled_dot_product_attention(q, k, v), 512, 1, 257)
    torch.cuda.synchronize()


def check_dense_cache_kernel(results: dict) -> None:
    import numpy as np
    import torch

    from summer_clip_torch.ops import cache_kernels as ck

    rng = np.random.default_rng(1)
    d, c, nb = 768, 1000, 8
    betas = torch.tensor([0.1, 1.0, 1.5, 3.5, 5.5, 7.5, 9.5, 11.5], device="cuda")

    def unit(n):
        a = rng.standard_normal((n, d)).astype(np.float32)
        return torch.from_numpy(a / np.linalg.norm(a, axis=1, keepdims=True)).cuda()

    r = results.setdefault("K1 cache_dense", {"max_abs_err": 0.0, "shapes": {}, "library_ms": None})
    for shape_name, (nt, nc) in {"clip_search": (8192, 16384), "pipeline": (1000, 2048)}.items():
        f, keys = unit(nt), unit(nc)
        outs = torch.from_numpy(rng.standard_normal((nc, c)).astype(np.float32)).cuda() * 0.05
        labels = outs.argmax(1)
        for vname, v in (("bf16 softmax values", torch.softmax(100.0 * outs, 1).to(torch.bfloat16)),
                         ("int8 one-hot values",
                          torch.nn.functional.one_hot(labels, c).to(torch.int8))):
            kern = lambda: ck.cache_attention(f, keys, v, betas)             # noqa: E731
            plain = lambda: ck.cache_attention_dense_reference(              # noqa: E731
                f, keys, v, betas, compute_dtype=torch.bfloat16)
            got, want = kern(), plain()
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            if not torch.isfinite(got).all():
                raise AssertionError(f"K1 {shape_name} {vname}: non-finite output")
            ms, plain_ms = cuda_time_ms(kern, 3, 1), cuda_time_ms(plain, 2, 1)
            prev = baseline_ms(kern, 3, "cache_kernels") if shape_name == "clip_search" else None
            log(f"K1 cache_dense     {shape_name:11s} Nt={nt} Nc={nc} D={d} C={c} betas={nb} "
                f"{vname}: max|d| vs plain={err:.3e} (tol {TOL_K1_VS_PLAIN}) kernel {ms:.4f} ms "
                f"plain {plain_ms:.4f} ms"
                + (f"; in turns: baseline {prev[0]:.4f} ms, kernel {prev[1]:.4f} ms" if prev
                   else ""))
            if err > TOL_K1_VS_PLAIN:
                raise AssertionError(f"K1 {shape_name} {vname}: kernel disagrees with plain")
            r["max_abs_err"] = max(r["max_abs_err"], err)
            vbytes = v.element_size()
            r["shapes"][f"{shape_name} {vname.split()[0]}"] = {
                "ms": ms, "plain_ms": plain_ms, "max_abs_err": err,
                **({"baseline_ms": prev[0], "in_turns_ms": prev[1]} if prev else {}),
                **bound(2 * (nt + nc) * d + vbytes * nc * c + 4 * nb * nt * c,
                        2 * nt * nc * d + nb * 2 * nt * nc * c, 0, nb * nt * nc)}
        k2 = ck.cache_attention_labels(f, keys, labels.cpu().numpy(), betas, c)
        torch.cuda.synchronize()
        e12 = float((got - k2).abs().max())
        log(f"K1 (int8 one-hots) == K2 on the same labels, {shape_name}: max|d|={e12:.3e} "
            f"(tol {TOL_K3_VS_K2})")
        if e12 > TOL_K3_VS_K2:
            raise AssertionError("K1 with one-hot values disagrees with K2")
    check_affinity_probe()
    torch.cuda.synchronize()


def check_affinity_probe() -> None:
    """The affinity three ways, bit for bit, over 64 tiles of 64 queries x 128
    cache rows at widths up to 1024 (the label kernels run 512, 768 and
    1024): WMMA, K1's transposed wgmma.m64n16k16 and the class-grouped
    template's wgmma.m64n128k16 (queries as M). The reason K1 == K2 holds at
    1e-4 and K13 == K1 at 1e-5 of max |out|: all add the same bf16 weights."""
    import torch

    from summer_clip_torch.ops import _lib
    from summer_clip_torch.ops import cache_kernels as ck

    gen = torch.Generator(device="cuda").manual_seed(5)
    lib = ck._lib_cache()
    tiles, differ = 64, {}
    for d in (16, 64, 192, 256, 512, 768, 1024):
        f = torch.randn(tiles * 64, d, device="cuda", generator=gen)
        c = torch.randn(tiles * 128, d, device="cuda", generator=gen)
        f = (f / f.norm(dim=1, keepdim=True)).to(torch.bfloat16)
        c = (c / c.norm(dim=1, keepdim=True)).to(torch.bfloat16)
        out = torch.zeros(3, tiles, 64, 128, device="cuda")
        _lib.check(lib.affinity_probe_bf16(f.data_ptr(), c.data_ptr(), out.data_ptr(), d, tiles,
                                           _lib.torch_stream()), "affinity_probe")
        torch.cuda.synchronize()
        differ[d] = (int((out[1] != out[0]).sum()), int((out[2] != out[0]).sum()))
    log(f"affinity probe ({tiles} tiles of 64 queries x 128 cache rows): elements of K1's "
        f"wgmma.m64n16k16 / the grouped template's wgmma.m64n128k16 that differ from WMMA at D = "
        + ", ".join(f"{d}: {a} / {b}" for d, (a, b) in differ.items()) + " (must be 0)")
    if any(a or b for a, b in differ.values()):
        raise AssertionError("the cache kernels' affinities differ")


# K13 at the JAX sweep tool's first geometry (its "top16-per-class"): Nt=50176,
# D=1024, C=1000, 16 cache rows a class, 8 betas, block_n 1024
K13_SHAPE = dict(nt=50176, d=1024, c=1000, per_class=16, block_n=1024)
# "highest" and "split3" against K3 and K1 (int8 one-hots), relative to max |out|:
# the same bf16 weights (one affinity routine), f32 sums in another order
# (per-block partials, then their sum, against row by row)
TOL_K13_VS_K3_REL = 1e-5
# "default" rounds each (class, block) partial to bf16: within 2^-8 relative
# each (bf16 keeps 8 significant bits), the weights are positive, so output by
# output within 2^-8 of "highest"
TOL_K13_DEFAULT_REL = 2.0 ** -8
# "default" against its plain version: where the kernel's and the plain f32
# partial straddle a bf16 rounding point they round one bf16 step apart (2^-7
# of the partial's binade), on top of K3's weight-flip tolerance
TOL_K13_DEFAULT_STEP = 2.0 ** -7


def check_onehot_variant(results: dict) -> None:
    """K13 against its plain version, K3 and K1, at the sweep tool's geometry;
    a planted fault (one class's partial dropped) read on the same gates."""
    import numpy as np
    import torch

    from summer_clip_torch.ops import cache_kernels as ck

    nt, d, c, per_class, block_n = (K13_SHAPE[k] for k in ("nt", "d", "c", "per_class",
                                                           "block_n"))
    nc = per_class * c
    gen = torch.Generator(device="cuda").manual_seed(13)

    def unit(n):
        x = torch.randn(n, d, generator=gen, device="cuda")
        return (x / x.norm(dim=1, keepdim=True)).to(torch.bfloat16)

    f, keys = unit(nt), unit(nc)
    labels = np.repeat(np.arange(c, dtype=np.int32), per_class)
    betas = torch.linspace(0.1, 11.5, 8, device="cuda")
    arms = {"highest": True, "split3": False, "default": False}   # expand_mode: cast_w

    def kern(mode, lab=labels):
        return ck.onehot_variant(f, keys, lab, betas, c, block_n=block_n, expand_mode=mode,
                                 cast_w=arms[mode])

    def plain(mode):
        return ck.onehot_variant_reference(f, keys, labels, betas, c, block_n=block_n,
                                           expand_mode=mode, cast_w=arms[mode])

    got = {m: kern(m) for m in arms}
    again = {m: kern(m) for m in arms}
    k3 = ck.cache_attention_onehot(f, keys, labels, betas, c)
    onehot = torch.zeros(nc, c, dtype=torch.int8, device="cuda")
    onehot[torch.arange(nc, device="cuda"), torch.from_numpy(labels).long().cuda()] = 1
    k1 = ck.cache_attention(f, keys, onehot, betas)
    torch.cuda.synchronize()
    scale = float(got["highest"].abs().max())
    shape = (f"Nt={nt} Nc={nc} D={d} C={c} betas={betas.shape[0]} block_n={block_n} "
             f"({per_class} rows a class)")

    def readings(out, want_plain, mode):
        """The gates' readings of one output against the plain version of
        ``mode``, K3, K1 and (for "default") "highest"."""
        r = {"vs_plain": float((out - want_plain).abs().max()),
             "vs_k3_rel": float((out - k3).abs().max()) / scale,
             "vs_k1_rel": float((out - k1).abs().max()) / scale}
        if mode == "default":
            r["default_vs_highest_rel"] = float(
                ((out - got["highest"]).abs() / got["highest"].abs().clamp_min(1e-30)).max())
        return r

    def passes(r, mode):
        if mode == "default":
            return (r["default_vs_highest_rel"] <= TOL_K13_DEFAULT_REL
                    and r["vs_plain"] <= TOL_K13_DEFAULT_STEP * scale + TOL_CACHE_VS_PLAIN)
        return (r["vs_plain"] <= TOL_CACHE_VS_PLAIN and r["vs_k3_rel"] <= TOL_K13_VS_K3_REL
                and r["vs_k1_rel"] <= TOL_K13_VS_K3_REL)

    entry = results["K13 onehot_variant"] = {"max_abs_err": 0.0, "library_ms": None,
                                             "shapes": {}}
    nb = int(betas.shape[0])
    work = label_bound(nt, nc, d, c, nb)
    for mode in arms:
        want = plain(mode)
        torch.cuda.synchronize()
        r = readings(got[mode], want, mode)
        del want
        if not torch.isfinite(got[mode]).all():
            raise AssertionError(f"K13 {mode}: non-finite output")
        if not torch.equal(got[mode], again[mode]):
            raise AssertionError(f"K13 {mode}: two runs differ")
        ms = cuda_time_ms(lambda m=mode: kern(m), 3, 1)
        plain_ms = cuda_time_ms(lambda m=mode: plain(m), 2, 1)
        prev = baseline_label_ms(lambda m=mode: kern(m), "onehot_variant", f, keys, labels, betas,
                                 c, block_n=block_n, mode=ck.EXPAND_MODES.index(mode))
        log(f"K13 onehot_variant {mode:8s} cast_w={arms[mode]!s:5s} {shape}: "
            + " ".join(f"{k}={v:.3e}" for k, v in r.items())
            + f" (tol: plain {TOL_CACHE_VS_PLAIN}"
            + (f" + {TOL_K13_DEFAULT_STEP:.3e} of max|out|, vs highest {TOL_K13_DEFAULT_REL:.3e}"
               if mode == "default" else f", K3 and K1 {TOL_K13_VS_K3_REL} of max|out|")
            + f"), two runs equal; kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
              f"bound {work['bound_ms']:.4f} ms ({work['bound_by']})" + in_turns(prev))
        if not passes(r, mode):
            raise AssertionError(f"K13 {mode}: kernel disagrees")
        entry["shapes"][mode] = {"ms": ms, "plain_ms": plain_ms, "max_abs_err": r["vs_plain"],
                                 **({"baseline_ms": prev[0], "in_turns_ms": prev[1]} if prev
                                    else {}), **r, **work}
        entry["max_abs_err"] = max(entry["max_abs_err"], r["vs_plain"])
    if not torch.equal(got["highest"], got["split3"]):
        raise AssertionError("K13: split3 is not highest bit for bit")
    log("K13 split3 == highest bit for bit")

    # planted fault: the rows of one class relabelled -1, so the kernel drops
    # that class's partial (its only one: 16 rows of a class sit in one block)
    dropped = c * 417 // 1000
    planted = labels.copy()
    planted[labels == dropped] = -1
    want = plain("highest")
    for mode in arms:
        r = readings(kern(mode, planted), want if mode != "default" else plain(mode), mode)
        log(f"K13 planted fault (class {dropped}'s partial dropped), {mode}: "
            + " ".join(f"{k}={v:.3e}" for k, v in r.items())
            + f" -> {'passes (gate blind)' if passes(r, mode) else 'fails the gates'}")
        if passes(r, mode):
            raise AssertionError(f"K13 gates cannot see a dropped partial ({mode})")
    del got, again, k3, k1, want
    torch.cuda.empty_cache()
    check_onehot_variant_blocks(entry)


# K13 where classes span several block_n blocks (the sweep tool's full cache
# has ~1281 rows a class at block_n 1024 and 2048): sorted random labels,
# ~320 rows a class, block_n 128
K13_BLOCKS_SHAPE = dict(nt=8192, nc=32000, d=1024, c=100, block_n=128)


def check_onehot_variant_blocks(entry: dict) -> None:
    """Each arm of K13 against its plain version and K3 where a class's rows
    fall into 2 to 4 block_n blocks (a segment each), two runs equal."""
    import numpy as np
    import torch

    from summer_clip_torch.ops import cache_kernels as ck

    nt, nc, d, c, block_n = (K13_BLOCKS_SHAPE[k] for k in ("nt", "nc", "d", "c", "block_n"))
    gen = torch.Generator(device="cuda").manual_seed(17)
    f = torch.randn(nt, d, generator=gen, device="cuda")
    keys = torch.randn(nc, d, generator=gen, device="cuda")
    f, keys = ((x / x.norm(dim=1, keepdim=True)).to(torch.bfloat16) for x in (f, keys))
    labels = np.sort(np.random.default_rng(17).integers(0, c, nc)).astype(np.int32)
    per_block = [np.unique(labels[i:i + block_n]).shape[0] for i in range(0, nc, block_n)]
    betas = torch.linspace(0.1, 11.5, 8, device="cuda")
    k3 = ck.cache_attention_onehot(f, keys, labels, betas, c)
    work = label_bound(nt, nc, d, c, 8)
    shape = (f"Nt={nt} Nc={nc} D={d} C={c} betas=8 block_n={block_n} ({nc // c} rows a class, "
             f"{max(per_block)} classes at most in a block)")
    for mode in ck.EXPAND_MODES:
        kern = lambda m=mode: ck.onehot_variant(f, keys, labels, betas, c,  # noqa: E731
                                                block_n=block_n, expand_mode=m)
        got, again = kern(), kern()
        want = ck.onehot_variant_reference(f, keys, labels, betas, c, block_n=block_n,
                                           expand_mode=mode)
        torch.cuda.synchronize()
        scale = float(want.abs().max())
        err = float((got - want).abs().max())
        vs_k3 = float((got - k3).abs().max()) / scale
        tol = TOL_CACHE_VS_PLAIN + (TOL_K13_DEFAULT_STEP * scale if mode == "default" else 0.0)
        ms, plain_ms = cuda_time_ms(kern, 3, 1), cuda_time_ms(
            lambda m=mode: ck.onehot_variant_reference(f, keys, labels, betas, c,
                                                       block_n=block_n, expand_mode=m), 1, 0)
        tol_k3 = TOL_K13_DEFAULT_REL if mode == "default" else TOL_K13_VS_K3_REL
        log(f"K13 onehot_variant {mode:8s} {shape}: vs_plain={err:.3e} (tol {tol:.3e}) "
            f"vs_k3_rel={vs_k3:.3e} (tol {tol_k3}), two runs equal; kernel {ms:.4f} ms plain "
            f"{plain_ms:.4f} ms bound {work['bound_ms']:.4f} ms ({work['bound_by']})")
        if not torch.isfinite(got).all() or not torch.equal(got, again):
            raise AssertionError(f"K13 {mode} across blocks: non-finite or two runs differ")
        if err > tol or vs_k3 > tol_k3:
            raise AssertionError(f"K13 {mode} across blocks: kernel disagrees")
        entry["shapes"][f"{mode} across blocks"] = {"ms": ms, "plain_ms": plain_ms,
                                                    "max_abs_err": err, "vs_k3_rel": vs_k3,
                                                    **work}
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
        del got, again, want
    torch.cuda.empty_cache()


def run_onehot_sweep() -> dict:
    """The sweep tool's first geometry (``tools/torch_sweep_onehot_variants.bench``):
    K1 twice, each of 3 arms x 2 blockings of K13 twice."""
    import importlib.util

    path = Path(__file__).resolve().parent / "tools" / "torch_sweep_onehot_variants.py"
    spec = importlib.util.spec_from_file_location("torch_sweep_onehot_variants", path)
    sweep = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sweep)
    t0 = time.perf_counter()
    out = sweep.bench(K13_SHAPE["nt"], 0, K13_SHAPE["d"], K13_SHAPE["c"],
                      rows_per_class=K13_SHAPE["per_class"])
    for row in out["rows"][1:]:
        tol = TOL_K13_DEFAULT_REL if row["mode"] == "default" else TOL_K13_VS_K3_REL
        if not row["checksum_rel"] <= tol:
            raise AssertionError(f"onehot_sweep: {row['arm']} checksum {row['checksum_rel']:.3e} "
                                 f"from K1's (tol {tol})")
    return {"times_s": {"bench": time.perf_counter() - t0}, "rows": out["rows"]}


GPT2_LARGE_GEMVS = {
    # name: (K, N) of every matrix a decoded token of ClipGPT on gpt2-large reads
    "c_attn": (1280, 3840), "c_proj": (1280, 1280), "mlp_c_fc": (1280, 5120),
    "mlp_c_proj": (5120, 1280), "lm_head": (1280, 49408), "adapter_fc1": (512, 1024),
    "adapter_fc2": (1024, 1280)}


# the third main path's prompts: 10, 5 and 17 tokens with the start token, so
# one of them prefills through K7 (at most 8 rows) and two take the wide route
GEN_PROMPTS = ("a photo of a", "a dog", "this is a picture of")
GEN_NEW_TOKENS = 20
# the serving engine's requests: more than its 8 slots, so slots are reused. The
# longest is 16 tokens, a whole prefill bucket: the engine without the
# megakernel sizes its cache to the longest prompt, and takes the wave path
# only if the shared bucket fits that.
ENGINE_PROMPTS = ("a photo of a", "a dog", "this is a picture", "a cat", "the sky",
                  "an image showing a", "two birds", "a red car", "my house", "a tree",
                  "some food", "one boat")
ENGINE_BUDGETS = tuple(8 + (5 * i) % 17 for i in range(len(ENGINE_PROMPTS)))   # 8 .. 24 tokens
ENGINE_SLOTS, ENGINE_BURST, ENGINE_PIPELINE = 8, 16, 4
SPEC_K = 4
# rows K7 and K10 are held at: one stream, the batched sampler's rows, the most
GEMV_ROWS = (1, len(GEN_PROMPTS), 8)

COLD_BYTES = 128 * 1024 * 1024   # distinct weight bytes a timed round walks: over twice the 50 MB L2


def graph_time_ms(calls, reps: int = 5) -> float:
    """Mean device time of one call: ``calls`` captured in order into one CUDA
    graph, which is replayed ``reps`` times between two events. No host code
    runs between the launches of a replay, so a kernel of a few microseconds
    is timed and not the Python of its wrapper."""
    import torch

    for fn in calls:        # workspaces and libraries exist before the capture
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for fn in calls:
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * len(calls))


def _copies(nbytes: int) -> int:
    return max(2, -(-COLD_BYTES // nbytes))


def _quant_cols(wf):
    """Per-column int8 of an f32 (K, N) matrix on the card: (q, scale (1, N))."""
    import torch

    scale = (wf.abs().amax(0, keepdim=True) / 127.0).cuda()
    return torch.round(wf.cuda() / scale).clamp(-127, 127).to(torch.int8), scale


def k7_library(x, w, scale):
    """One PyTorch call computing K7's function, a yardstick used nowhere in the
    port: ``torch._weight_int8pack_mm`` for int8 weights (w as (N, K), x and
    the scale in f32 where the card's PyTorch takes them, else bf16), a cuBLAS
    product of the bf16 operands for bf16 weights (f32 out where ``torch.mm``
    takes ``out_dtype``, else bf16 out). Returns (a call on one copy of the
    stored weights, (the copy's tensors), a note on where its rounding differs
    from K7's), or None with the reason when the card's PyTorch has none."""
    import torch

    xb = x.to(torch.bfloat16)
    if w.dtype == torch.int8:
        wt = w.t().contiguous()
        for dt in (torch.float32, torch.bfloat16):
            xa, sa = xb.to(dt), scale.reshape(-1).to(dt)
            try:
                torch._weight_int8pack_mm(xa, wt, sa)
            except (RuntimeError, NotImplementedError, TypeError) as exc:
                reason = f"torch._weight_int8pack_mm: {str(exc).splitlines()[0][:120]}"
                continue
            note = ("int8pack_mm, f32 x (bf16-rounded) and scale, f32 out" if dt == torch.float32
                    else "int8pack_mm in bf16: the scale and the output round to bf16")
            return (lambda c: torch._weight_int8pack_mm(xa, c, sa)), wt, note
        return None, None, reason
    try:
        torch.mm(xb, w, out_dtype=torch.float32)
        return (lambda c: torch.mm(xb, c, out_dtype=torch.float32)), w, "cuBLAS bf16, f32 out"
    except (TypeError, RuntimeError):
        return (lambda c: torch.mm(xb, c)), w, "cuBLAS bf16: the output rounds to bf16"


def check_k7_reads_x_after_its_predecessor(w8, scale) -> None:
    """Programmatic dependent launch lets K7 start before the kernel before it
    ends: it must read x only after that kernel's writes. x is filled with NaN,
    then written by a slow predecessor -- a reduction over 84 MB, or a K7 whose
    output it is (the decode chain's c_fc -> c_proj) -- and K7 runs at once."""
    import torch

    from summer_clip_torch.ops import gemv

    k, n = w8.shape                                  # (1280, 5120): c_fc
    gen = torch.Generator(device="cuda").manual_seed(11)
    big = torch.randn((8, n, 512), device="cuda", generator=gen)
    w2 = torch.randint(-127, 128, (n, k), dtype=torch.int8, device="cuda", generator=gen)
    s2 = torch.full((1, k), 1e-3, device="cuda")
    x0 = torch.randn((8, k), device="cuda", generator=gen)
    # what K7 gives on x once x is surely written (a synchronised call each)
    x_sum = big.sum(-1)
    torch.cuda.synchronize()
    want_sum = gemv.streamed_qmatmul(x_sum, w2, s2)
    torch.cuda.synchronize()
    hidden = gemv.streamed_qmatmul(x0, w8, scale)
    torch.cuda.synchronize()
    want_chain = gemv.streamed_qmatmul(hidden, w2, s2)
    torch.cuda.synchronize()
    differ = 0
    xbuf = torch.empty((8, n), device="cuda")
    for _ in range(20):
        xbuf.fill_(float("nan"))
        torch.sum(big, dim=-1, out=xbuf)
        got_sum = gemv.streamed_qmatmul(xbuf, w2, s2)
        # a NaN block of the output's size, freed: the caching allocator hands it
        # to the first K7's output, so x holds NaN until that K7 writes it
        del hidden
        torch.full((8, n), float("nan"), device="cuda")
        hidden = gemv.streamed_qmatmul(x0, w8, scale)
        got_chain = gemv.streamed_qmatmul(hidden, w2, s2)
        differ += int(not torch.equal(got_sum, want_sum)) + int(not torch.equal(got_chain, want_chain))
    plain = float((want_sum - gemv.matmul_reference(x_sum, w2, s2)).abs().max()
                  / want_sum.abs().max())
    log(f"K7 after a slow predecessor that writes its x (20 x two chains, PDL on): {differ} of 40 "
        f"results differ from the synchronised call's bits; that call against plain "
        f"{plain:.3e} of max (tol {TOL_GEMV_REL})")
    if differ or not plain <= TOL_GEMV_REL:
        raise AssertionError("K7 read its x before the kernel before it had written it")


def check_gemv_kernels(results: dict) -> None:
    """K7 at every gpt2-large shape with R = 1, 3 (the batched sampler's rows
    on the third main path) and 8, int8 and bf16 weights, and K10 at D = 1280,
    H = 5120 with the same rows, against their plain versions.

    Times are device times from a CUDA graph (:func:`graph_time_ms`) whose
    launches walk copies of the weights, 128 MB in all, so that every launch
    reads its matrix from device memory as a decode loop does (a token reads
    773 MB between two reads of the same matrix). ``eager_ms`` is the time of
    back-to-back calls of the wrapper from Python, which is the host's time.
    At R = 1 K7 is also timed with programmatic dependent launch off
    (``serial_ms``), and each launch after a PyTorch kernel that writes its x,
    with it on and off (``after_torch_ms``, ``after_torch_serial_ms``); with a
    gemv baseline, K7's and K10's earlier designs in turns (``baseline_ms``).
    K10's plan is logged with the clusters the card holds at once."""
    import torch

    from summer_clip_torch.ops import _lib, gemv

    gen = torch.Generator().manual_seed(4)
    r7 = results.setdefault("K7 streamed_qmatmul", {"max_abs_err": 0.0, "shapes": {},
                                                    "library_ms": None})
    base = BASELINE.get("gemv_kernels")
    for name, (k, n) in GPT2_LARGE_GEMVS.items():
        wf = torch.randn((k, n), generator=gen) * k ** -0.5
        w8, scale = _quant_cols(wf)
        wb = wf.to("cuda", torch.bfloat16)
        if name == "mlp_c_fc":
            check_k7_reads_x_after_its_predecessor(w8, scale)
        for wname, w, sc in (("int8", w8, scale), ("bf16", wb, None)):
            ws = [w] + [w.clone() for _ in range(_copies(w.numel() * w.element_size()) - 1)]
            for rows in GEMV_ROWS:
                x = _randn((rows, k), gen, dtype=torch.float32)
                got, want = gemv.streamed_qmatmul(x, w, sc), gemv.matmul_reference(x, w, sc)
                torch.cuda.synchronize()
                err = float((got - want).abs().max())
                tol = TOL_GEMV_REL * float(want.abs().max())
                if not torch.equal(got, gemv.streamed_qmatmul(x, w, sc)):
                    raise AssertionError(f"K7 {name} R={rows} {wname}: two runs differ")
                if rows > 1 and not torch.equal(got[:1], gemv.streamed_qmatmul(x[:1], w, sc)):
                    raise AssertionError(f"K7 {name} {wname}: a row's result depends on the "
                                         f"rows that ride with it")
                ours = [lambda c=c: gemv.streamed_qmatmul(x, c, sc) for c in ws]
                ms = graph_time_ms(ours)
                plain_ms = graph_time_ms([lambda c=c: gemv.matmul_reference(x, c, sc) for c in ws[:8]])
                eager_ms = cuda_time_ms(lambda: gemv.streamed_qmatmul(x, w, sc), 20)
                b = bound(w.numel() * w.element_size() + 4 * rows * (k + n) + (4 * n if sc is not None else 0),
                          2 * rows * k * n)
                extra, line = {}, ""
                call, lib_w, note = k7_library(x, w, sc)
                if call is not None:
                    copies = [lib_w] + [lib_w.clone() for _ in range(len(ws) - 1)]
                    extra["library_ms"] = graph_time_ms([lambda c=c: call(c) for c in copies])
                    line += f", library {extra['library_ms']:.4f} ms ({note})"
                    del copies
                else:
                    extra["library_ms"] = None
                    line += f", library: none ({note})"
                if rows == 1:
                    gemv.PDL = False
                    try:
                        extra["serial_ms"] = graph_time_ms(ours)
                        extra["after_torch_serial_ms"] = graph_time_ms(
                            [lambda c=c: (x.mul_(1.0), gemv.streamed_qmatmul(x, c, sc)) for c in ws])
                    finally:
                        gemv.PDL = True
                    extra["after_torch_ms"] = graph_time_ms(
                        [lambda c=c: (x.mul_(1.0), gemv.streamed_qmatmul(x, c, sc)) for c in ws])
                    line += (f"; PDL off {extra['serial_ms']:.4f} ms; after a PyTorch kernel "
                             f"{extra['after_torch_ms']:.4f} ms a pair (PDL off "
                             f"{extra['after_torch_serial_ms']:.4f})")
                if base is not None and hasattr(base, "cluster_qmatmul_i8"):
                    old = [lambda c=c: on_baseline("gemv_kernels",
                                                   lambda: gemv.streamed_qmatmul(x, c, sc))
                           for c in ws]
                elif base is not None:
                    old = [lambda c=c: workspace_k7_call(base, x, c, sc) for c in ws]
                if base is not None:
                    old_err = float((old[0]() - got).abs().max())
                    extra["baseline_ms"], extra["in_turns_ms"] = in_turns_ms(old, ours, graph_time_ms)
                    line += (f"; in turns: baseline {extra['baseline_ms']:.4f} ms, kernel "
                             f"{extra['in_turns_ms']:.4f} ms (baseline vs kernel max|d| "
                             f"{old_err:.3e})")
                log(f"K7 streamed_qmatmul {name:11s} ({k}, {n}) R={rows} {wname} plan "
                    f"{gemv.k7_plan(k, n, w.element_size())}: max|d|={err:.3e} (tol {tol:.3e}) "
                    f"kernel {ms:.4f} ms (cold, in a graph; {eager_ms:.4f} ms a call from Python), "
                    f"plain {plain_ms:.4f} ms, bound {b['bound_ms']:.4f} ms by {b['bound_by']}{line}")
                if not torch.isfinite(got).all() or err > tol:
                    raise AssertionError(f"K7 {name} R={rows} {wname}: kernel disagrees with plain")
                r7["max_abs_err"] = max(r7["max_abs_err"], err)
                r7["shapes"][f"{name} R={rows} {wname}"] = {
                    "ms": ms, "eager_ms": eager_ms, "plain_ms": plain_ms, "max_abs_err": err,
                    **extra, **b}
            del ws
    # one decoded token's 147 int8 products at R = 1: 36 blocks of 4, 2 adapters, the head
    keys = ("ms", "eager_ms", "plain_ms", "bound_ms", "serial_ms") + (
        ("baseline_ms", "in_turns_ms") if base is not None else ())
    token = dict.fromkeys(keys, 0.0)
    for name in GPT2_LARGE_GEMVS:
        count = 36 if name in ("c_attn", "c_proj", "mlp_c_fc", "mlp_c_proj") else 1
        for key in token:
            token[key] += count * r7["shapes"][f"{name} R=1 int8"][key]
    r7["shapes"]["token R=1 int8"] = {**token, "bound_by": "bytes", "max_abs_err": r7["max_abs_err"]}
    log(f"K7 one token (147 products, R=1, int8): kernels {token['ms']:.4f} ms on the device "
        f"(PDL off {token['serial_ms']:.4f}), {token['eager_ms']:.4f} ms called from Python, plain "
        f"{token['plain_ms']:.4f} ms, bound {token['bound_ms']:.4f} ms by bytes"
        + (f"; in turns: baseline {token['baseline_ms']:.4f} ms, kernel {token['in_turns_ms']:.4f} ms"
           if base is not None else ""))

    d, h = 1280, 5120
    r10 = results.setdefault("K10 fused_qmlp", {"max_abs_err": 0.0, "shapes": {},
                                                "library_ms": None})
    w1, s1 = _quant_cols(torch.randn((d, h), generator=gen) * d ** -0.5)
    w2, s2 = _quant_cols(torch.randn((h, d), generator=gen) * h ** -0.5)
    b1, b2 = _randn((h,), gen, 0.1, torch.float32), _randn((d,), gen, 0.1, torch.float32)
    pairs = [(w1, w2)] + [(w1.clone(), w2.clone()) for _ in range(_copies(2 * d * h) - 1)]

    def unfused(x, a, b):   # the pair through K7, as the block runs it without the opt-in
        hidden = torch.nn.functional.gelu(gemv.streamed_qmatmul(x, a, s1) + b1, approximate="tanh")
        return gemv.streamed_qmatmul(hidden, b, s2) + b2

    def old_k10(x, a, b):   # the --baseline build's K10, on its own entry if it is two launches
        if base.two_launch_k10:
            return two_launch_k10_call(base, x, a, s1, b1, b, s2, b2)
        return on_baseline("gemv_kernels", lambda: gemv.fused_qmlp(x, a, s1, b1, b, s2, b2))

    plan = gemv.k10_plan(d, h)
    r10["plan"] = plan._asdict()
    for rows in GEMV_ROWS:
        held = ctypes.c_int(0)
        _lib.check(gemv._lib_gemv().fused_qmlp_clusters(rows, d, h, plan.hc, plan.split, plan.br1,
                                                        plan.twb2, plan.br2,
                                                        ctypes.addressof(held)), "fused_qmlp_clusters")
        log(f"K10 plan D={d} H={h}: {plan} -> {plan.ctas} CTAs in {plan.clusters} clusters of "
            f"{plan.split}; R={rows}: {gemv.k10_smem(plan, rows)} bytes of shared memory a CTA, the "
            f"card holds {held.value} such clusters at once"
            + ("" if held.value >= plan.clusters else " (fewer than the launch has: not every "
               "weight byte is asked for at launch)"))
        x = _randn((rows, d), gen, dtype=torch.float32)
        got = gemv.fused_qmlp(x, w1, s1, b1, w2, s2, b2)
        want = gemv.fused_qmlp_reference(x, w1, s1, b1, w2, s2, b2)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        tol = TOL_QMLP_REL * float(want.abs().max())
        if not torch.equal(got, gemv.fused_qmlp(x, w1, s1, b1, w2, s2, b2)):
            raise AssertionError(f"K10 R={rows}: two runs differ")
        if rows > 1 and not torch.equal(got[:1], gemv.fused_qmlp(x[:1], w1, s1, b1, w2, s2, b2)):
            raise AssertionError("K10: a row's result depends on the rows that ride with it")
        ms = graph_time_ms([lambda a=a, b=b: gemv.fused_qmlp(x, a, s1, b1, b, s2, b2) for a, b in pairs])
        plain_ms = graph_time_ms([lambda a=a, b=b: gemv.fused_qmlp_reference(x, a, s1, b1, b, s2, b2)
                                  for a, b in pairs[:4]])
        pair_ms = graph_time_ms([lambda a=a, b=b: unfused(x, a, b) for a, b in pairs])
        eager_ms = cuda_time_ms(lambda: gemv.fused_qmlp(x, w1, s1, b1, w2, s2, b2), 20)
        b = bound(2 * d * h + 4 * (2 * rows * d + 2 * h + 2 * d), 4 * rows * d * h)
        extra, line = {}, ""
        if base is not None:
            old = [lambda a=a, b=b: old_k10(x, a, b) for a, b in pairs]
            ours = [lambda a=a, b=b: gemv.fused_qmlp(x, a, s1, b1, b, s2, b2) for a, b in pairs]
            old_err = float((old[0]() - got).abs().max())
            extra["baseline_ms"], extra["in_turns_ms"] = in_turns_ms(old, ours, graph_time_ms)
            line = (f"; in turns: baseline {extra['baseline_ms']:.4f} ms, kernel "
                    f"{extra['in_turns_ms']:.4f} ms (baseline vs kernel max|d| {old_err:.3e})")
        log(f"K10 fused_qmlp D={d} H={h} R={rows}: max|d|={err:.3e} (tol {tol:.3e}) kernel "
            f"{ms:.4f} ms (cold, in a graph; {eager_ms:.4f} ms a call from Python), plain "
            f"{plain_ms:.4f} ms, the unfused K7 pair {pair_ms:.4f} ms, bound {b['bound_ms']:.4f} ms "
            f"by {b['bound_by']}{line}")
        if not torch.isfinite(got).all() or err > tol:
            raise AssertionError(f"K10 R={rows}: kernel disagrees with its plain version")
        r10["max_abs_err"] = max(r10["max_abs_err"], err)
        r10["shapes"][f"R={rows}"] = {"ms": ms, "eager_ms": eager_ms, "plain_ms": plain_ms,
                                      "k7_pair_ms": pair_ms, "max_abs_err": err, **extra, **b}
    torch.cuda.synchronize()


# K8 against its plain version, one block at a time on equal inputs (the plain
# version's): the same rounding points, f32 sums in another order. A value that
# lands on the other side of a rounding tie (a fresh K or V that rounds to the
# neighbouring int8 step, a bf16 operand one ulp off) moves a block's output by
# about 1e-4 of the largest, so the JAX test's 1e-4 at width 128 does not hold
# at width 1280 with 1024 ring rows; the fresh rows stay within one int8 step
# (bf16: one bf16 ulp of values up to 8). A row's scale is its largest |value|
# over 127: one input of the qkv product that rounds to the other bf16
# neighbour moves that value by ~3e-5 of itself, so the JAX test's 1e-5 does
# not hold either.
# tools/torch_gen_gpt_routes.py plants a fault in K8 and reads it on this gate.
TOL_K8_BLOCK_REL = 2e-3
TOL_K8_ROWS = {"int8": 1.0, "bf16": 0.0625}
TOL_K8_SCALE_REL = 2e-4
# ... and over the whole stack against the plain chain: every flip feeds the
# next block's roundings (tools/torch_gen_gpt_routes.py follows a K7 step block
# by block: the routes end 2e-3 apart). Reported; gated only against a wreck.
TOL_K8_STACK_REL = 5e-2
K8_SHAPES = ((1, 256), (3, 256), (8, 256), (1, 1024), (3, 1024), (8, 1024))


def random_stack(n_layer: int, d: int, h: int, store: str, seed: int) -> dict:
    """Block parameters in K8's layout, drawn on the card: LeCun-normal
    kernels (int8 per output column, or bf16), small biases, LayerNorm leaves
    near one and zero."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)

    def rn(*shape, scale=1.0):
        return torch.randn(shape, device="cuda", generator=g) * scale

    packed = {}
    for wkey, tag, (k, n) in (("wqkv", "qkv", (d, 3 * d)), ("wproj", "proj", (d, d)),
                              ("w1", "1", (d, h)), ("w2", "2", (h, d))):
        w = rn(n_layer, k, n, scale=k ** -0.5)
        if store == "int8":
            scale = w.abs().amax(1, keepdim=True).clamp_min(1e-12) / 127.0
            packed[wkey] = torch.round(w / scale).clamp(-127, 127).to(torch.int8)
            packed["s" + tag] = scale
        else:
            packed[wkey] = w.to(torch.bfloat16)
            packed["s" + tag] = torch.ones((n_layer, 1, n), device="cuda")
        packed["b" + tag] = rn(n_layer, 1, n, scale=0.02)
        del w
    packed["ln"] = torch.stack([1 + rn(n_layer, d, scale=0.1), rn(n_layer, d, scale=0.1),
                                1 + rn(n_layer, d, scale=0.1), rn(n_layer, d, scale=0.1)], 1)
    return packed


def random_rings(n_layer: int, batch: int, t: int, d: int, kv_dtype, seed: int) -> dict:
    import torch

    from summer_clip_torch.ops import decode_block as DB

    g = torch.Generator(device="cuda").manual_seed(seed)
    layers = []
    for _ in range(n_layer):     # a layer at a time: the f32 rows of all layers are 1.5 GB
        k = DB._quant_rows(torch.randn((batch, t, d), device="cuda", generator=g), kv_dtype)
        v = DB._quant_rows(torch.randn((batch, t, d), device="cuda", generator=g) * 0.5, kv_dtype)
        layers.append((k[0], v[0], k[1], v[1]))
    return {name: torch.stack([lay[i] for lay in layers])
            for i, name in enumerate(("k", "v", "ks", "vs"))}


def k8_fill(batch: int, t: int):
    """Fill indices and left pads of ``batch`` streams over rings of ``t``
    rows: a part-filled ring, an empty one (index 0), a full one (index t), a
    few rows, fills at and just past a 256-row pass, pads inside a pass."""
    index = [int(0.7 * t), 0, t, 5, t // 4, t // 4 + 1, int(0.9 * t), 33][:batch]
    pad = [3 if batch == 1 else 0, 0, 16, 0, 3, t // 4 - 6, t // 10, 32][:batch]
    return index, pad


def check_decode_block(results: dict) -> None:
    """K8 at gpt2-large (36 blocks, D = 1280, H = 5120, 20 heads) against its
    plain version: 1, 3 and 8 streams over rings of 256 and 1024 rows filled to
    different indices with left pads (int8 weights, int8 rings), and one
    stream with bf16 weights and bf16 rings. Each block is held on the plain
    version's input for that block; the whole stack is held against the plain
    chain; two runs must give the same bits, and a stream of a batched call
    the bits of its solo call. Times: CUDA events around 10 launches (a launch
    reads 708 MB of weights, so every launch finds them cold); with a decode
    baseline, the earlier design in turns on the same inputs."""
    import torch

    from summer_clip_torch.ops import decode_block as DB

    n_layer, d, h, nh = 36, 1280, 5120, 20
    r8 = results.setdefault("K8 decode_block", {"max_abs_err": 0.0, "shapes": {},
                                                "library_ms": None})
    base = BASELINE.get("decode_kernels")
    log(f"K8 decode_block: persistent grid of {DB.grid_blocks()} CTAs in clusters of "
        f"{DB.CLUSTER}, {DB.barriers(n_layer)} grid-wide barriers a launch at {n_layer} blocks; "
        f"tiles (bytes, box rows) of qkv, proj, fc, out: int8 "
        f"{[DB.stage_plan(k, n, 1) for _, k, n in DB._products(d, h)]}, bf16 "
        f"{[DB.stage_plan(k, n, 2) for _, k, n in DB._products(d, h)]}")
    cases = [("int8", torch.int8, b, t) for b, t in K8_SHAPES] + [("bf16", torch.bfloat16, 1, 1024)]
    packed, packed_store = None, None
    for store, kv_dtype, batch, t in cases:
        if store != packed_store:      # one stack on the card at a time
            del packed
            packed, packed_store = random_stack(n_layer, d, h, store, seed=8), store
        kv = random_rings(n_layer, batch, t, d, kv_dtype, seed=batch * t)
        index, pad = k8_fill(batch, t)
        idx = torch.tensor(index, dtype=torch.int32, device="cuda")
        padv = torch.tensor(pad, dtype=torch.int32, device="cuda")
        x = torch.randn((batch, d), device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(t + batch))
        # block by block on the plain version's inputs
        worst = {"y": 0.0, "abs": 0.0, "rows": 0.0, "scale": 0.0}
        xl = x
        plain_ms = 0.0
        for lay in range(n_layer):
            one = {k: v[lay:lay + 1] for k, v in packed.items()}
            kvl = {k: v[lay:lay + 1] for k, v in kv.items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want = DB.decode_block_reference(xl, one, kvl, idx, nh=nh, pad=padv)
            torch.cuda.synchronize()
            plain_ms += (time.perf_counter() - t0) * 1e3
            got = DB.decode_block(xl, one, kvl, idx, nh=nh, pad=padv)
            err = float((got[0] - want[0]).abs().max())
            worst["abs"] = max(worst["abs"], err)
            worst["y"] = max(worst["y"], err / float(want[0].abs().max()))
            worst["rows"] = max(worst["rows"], *(float((g.float() - w.float()).abs().max())
                                                 for g, w in zip(got[1:3], want[1:3])))
            worst["scale"] = max(worst["scale"], *(float(((g - w).abs() / w).max())
                                                   for g, w in zip(got[3:], want[3:])))
            xl = want[0]
        got = DB.decode_block(x, packed, kv, idx, nh=nh, pad=padv)
        torch.cuda.synchronize()
        stack_rel = float((got[0] - xl).abs().max()) / float(xl.abs().max())
        again = DB.decode_block(x, packed, kv, idx, nh=nh, pad=padv)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"K8 B={batch} T={t} {store}: two runs differ")
        if batch > 1:
            row = batch - 1
            solo = DB.decode_block(x[row:], packed, {k: v[:, row:].contiguous() for k, v in kv.items()},
                                   idx[row:], nh=nh, pad=padv[row:])
            if not (torch.equal(solo[0], got[0][row:])
                    and all(torch.equal(a, b[:, row:]) for a, b in zip(solo[1:], got[1:]))):
                raise AssertionError(f"K8 B={batch} T={t}: a stream's result depends on the "
                                     f"streams that ride with it")
        ours = lambda: DB.decode_block(x, packed, kv, idx, nh=nh, pad=padv)   # noqa: E731
        ms = cuda_time_ms(ours, 10)
        turns, line = {}, ""
        if base is not None:
            old = lambda: workspace_k8_call(base, x, packed, kv, idx, padv, nh)   # noqa: E731
            old_err = float((old()[0] - got[0]).abs().max() / got[0].abs().max())
            turns["baseline_ms"], turns["in_turns_ms"] = in_turns_ms(
                old, ours, lambda f: cuda_time_ms(f, 10))
            line = (f"; in turns: baseline {turns['baseline_ms']:.4f} ms, kernel "
                    f"{turns['in_turns_ms']:.4f} ms (their y max|d|/max|y| {old_err:.3e})")
        size = packed["wqkv"].element_size()
        live = sum(max(i - p, 0) for i, p in zip(index, pad))
        moved = (n_layer * (12 * d * d * size + 4 * (2 * (4 * d + h + 2 * d) + 4 * d))   # weights, scales, biases, ln
                 + n_layer * live * 2 * (d * kv["k"].element_size() + 4)                # live ring rows
                 + n_layer * batch * 2 * (d * kv["k"].element_size() + 4) + 8 * batch * d)
        b = bound(moved, 2 * batch * 12 * d * d * n_layer)
        log(f"K8 decode_block B={batch} T={t} {store} weights, {store} rings, index {index} pad "
            f"{pad}: a block on equal inputs max|d|/max|y| {worst['y']:.3e} (tol "
            f"{TOL_K8_BLOCK_REL}), fresh rows {worst['rows']:.4g} (tol {TOL_K8_ROWS[store]}), "
            f"scales {worst['scale']:.2e} (tol {TOL_K8_SCALE_REL}); whole stack against the "
            f"plain chain {stack_rel:.3e} (tol {TOL_K8_STACK_REL}); kernel {ms:.4f} ms, plain "
            f"{plain_ms:.1f} ms, bound {b['bound_ms']:.4f} ms by {b['bound_by']} "
            f"({moved / 1e6:.1f} MB, {live} live ring rows){line}")
        if (not all(torch.isfinite(a.float()).all() for a in got)
                or worst["y"] > TOL_K8_BLOCK_REL or worst["rows"] > TOL_K8_ROWS[store]
                or worst["scale"] > TOL_K8_SCALE_REL or stack_rel > TOL_K8_STACK_REL):
            raise AssertionError(f"K8 B={batch} T={t} {store}: kernel disagrees with its plain version")
        r8["max_abs_err"] = max(r8["max_abs_err"], worst["abs"])
        r8["shapes"][f"B={batch} T={t} {store}"] = {
            "ms": ms, "plain_ms": plain_ms, "max_abs_err": worst["abs"], "block_rel": worst["y"],
            "stack_rel": stack_rel, "live_rows": live, **turns, **b}
        del kv
    del packed
    torch.cuda.empty_cache()


def check_flash_kernels(results: dict) -> None:
    """K11 at the perplexity pass's shape (BH = 8 x 20, T = 1024, causal) in bf16
    and f32, at a chunked-prefill shape (tq = 128 of tk = 1024 at q_offset 896)
    and non-causal at T = 577, against its plain version and beside SDPA; at
    the causal shapes also the readings of a planted fault (the kernel with its
    causal mask shifted by one key)."""
    import torch
    import torch.nn.functional as F

    from summer_clip_torch.ops import attention as at

    gen = torch.Generator().manual_seed(5)
    r = results.setdefault("K11 flash_attention", {"max_abs_err": 0.0, "shapes": {}})
    cases = {
        "ppl_causal_bf16": (160, 1024, 1024, True, 0, torch.bfloat16),
        "ppl_causal_f32": (160, 1024, 1024, True, 0, torch.float32),
        "chunked_prefill_bf16": (160, 128, 1024, True, 896, torch.bfloat16),
        "chunked_prefill_f32": (160, 128, 1024, True, 896, torch.float32),
        "vit_l14_336_bf16": (160, 577, 577, False, 0, torch.bfloat16),
        "vit_l14_336_f32": (160, 577, 577, False, 0, torch.float32)}
    for name, (bh, tq, tk, causal, off, dtype) in cases.items():
        q = _randn((bh, tq, 64), gen, dtype=dtype)
        k, v = _randn((bh, tk, 64), gen, dtype=dtype), _randn((bh, tk, 64), gen, dtype=dtype)
        bias = at._causal_bias(tq, tk, off, device="cuda") if causal else None
        kern = lambda: at.flash_attention(q, k, v, causal=causal, q_offset=off)              # noqa: E731
        plain = lambda: at.flash_attention_reference(q, k, v, causal=causal, q_offset=off)   # noqa: E731
        q4, k4, v4 = q[None], k[None], v[None]      # (1, heads, T, 64), SDPA's layout
        if causal and tq == tk:
            lib = lambda: F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)   # noqa: E731
        else:
            lib = lambda: F.scaled_dot_product_attention(                              # noqa: E731
                q4, k4, v4, attn_mask=None if bias is None else bias.to(dtype))
        got, want = kern(), plain()
        torch.cuda.synchronize()
        err, mean_err = _attention_readings(got, want)
        ms, plain_ms, lib_ms = cuda_time_ms(kern, 5), cuda_time_ms(plain, 3), cuda_time_ms(lib, 5)
        prev = baseline_ms(kern, 5, "attention_kernels")
        seen = tq * tk if not causal else sum(min(tk, off + i + 1) for i in range(tq))
        flops = 4 * bh * seen * 64
        itemsize = q.element_size()
        b = (bound(itemsize * bh * 64 * (2 * tq + 2 * tk), flops) if dtype == torch.bfloat16
             else bound(itemsize * bh * 64 * (2 * tq + 2 * tk), 0, flops))
        tol_max, tol_mean = ((TOL_ATTN_MAX, TOL_ATTN_MEAN) if dtype == torch.bfloat16
                             else (TOL_FLASH_F32, TOL_FLASH_F32))
        log(f"K11 flash_attention {name:22s} BH={bh} tq={tq} tk={tk} causal={causal} "
            f"q_offset={off}: max|d|={err:.3e} (tol {tol_max}) mean|d|={mean_err:.3e} kernel "
            f"{ms:.4f} ms plain {plain_ms:.4f} ms SDPA {lib_ms:.4f} ms bound {b['bound_ms']:.4f} "
            f"ms by {b['bound_by']}"
            + (f"; in turns: baseline {prev[0]:.4f} ms, kernel {prev[1]:.4f} ms" if prev else ""))
        if err > tol_max or mean_err > tol_mean:
            raise AssertionError(f"K11 {name}: kernel disagrees with its plain version")
        if causal:
            # planted fault: the kernel itself with its causal mask shifted by one key
            f_err, f_mean = _attention_readings(
                at.flash_attention(q, k, v, causal=True, q_offset=off + 1), want)
            log(f"  planted fault (causal mask shifted by one key): max|d|={f_err:.3e} "
                f"(tol {tol_max}) mean|d|={f_mean:.3e} (tol {tol_mean})")
            if f_err <= tol_max and f_mean <= tol_mean:
                raise AssertionError(f"K11 {name}: the planted fault reads within the limits")
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r["shapes"][name] = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                             "max_abs_err": err, **({"baseline_ms": prev[0]} if prev else {}),
                             **b}
    torch.cuda.synchronize()


def _plain_blocks(transformer, x, causal: bool = False):
    """The tower's residual blocks through the plain versions (measurement
    only). They compute what either route of a block computes."""
    from summer_clip_torch.ops import block_kernels as bk

    for blk in transformer.resblocks:
        a, m = blk.attn, blk.mlp
        x = bk.ln_attn_reference(x, blk.ln_1.weight, blk.ln_1.bias, a.in_proj_weight,
                                 a.in_proj_bias, a.out_proj.weight, a.out_proj.bias,
                                 num_heads=a.num_heads, causal=causal)
        x = bk.ln_mlp_reference(x, blk.ln_2.weight, blk.ln_2.bias, m.c_fc.weight, m.c_fc.bias,
                                m.c_proj.weight, m.c_proj.bias)
    return x


def time_towers(results: dict) -> None:
    """Towers at the main paths' batches: every block through the kernels
    against the same blocks through the plain versions. ViT-B/16 image and
    text and the ViT-L/14 text tower at a CoOp forward's 1000 prompts (K5 +
    K6); the ViT-L/14 image tower's 24 blocks (K4 + cuBLAS)."""
    import torch

    from summer_clip_torch.models.clip import modeling
    from summer_clip_torch.models.clip.configs import CLIP_CONFIGS
    from summer_clip_torch.models.clip.modeling import Transformer
    from summer_clip_torch.ops import block_kernels as bk

    gen = torch.Generator().manual_seed(1)

    def tower(width, layers, heads):
        # only the blocks are timed, so only they are built (the CLIP class's
        # init scales: fan-in-scaled weights, zero biases)
        mod = Transformer(width, layers, heads)
        with torch.no_grad():
            for name, p in mod.named_parameters():
                if p.dim() == 2:
                    p.copy_(torch.randn(p.shape, generator=gen) * p.shape[1] ** -0.5)
                elif "ln_" not in name:
                    p.zero_()
                if "ln_" not in name:
                    p.data = p.data.to(torch.bfloat16)
        return mod.requires_grad_(False).to("cuda").eval()

    b16, l14 = CLIP_CONFIGS["ViT-B/16"], CLIP_CONFIGS["ViT-L/14"]
    for name, (cfg_t, b, t, causal) in {
            "ViT-B/16 image B=32": ((b16.vision_width, b16.vision_layers, b16.vision_heads),
                                    32, 197, False),
            "ViT-B/16 text B=256": ((b16.text_width, b16.text_layers, b16.text_heads),
                                    256, 77, True),
            "ViT-L/14 text B=1000": ((l14.text_width, l14.text_layers, l14.text_heads),
                                     1000, 77, True),   # a CoOp forward's 1000 class prompts
            "ViT-L/14 image B=32": ((l14.vision_width, l14.vision_layers, l14.vision_heads),
                                    32, 257, False)}.items():
        mod = tower(*cfg_t)
        x = _randn((b, t, cfg_t[0]), gen)
        with torch.inference_mode():
            got, want = mod(x, causal), _plain_blocks(mod, x, causal)
            cos = float(torch.nn.functional.cosine_similarity(
                got.float().flatten(1), want.float().flatten(1), dim=1).min())
            ms = cuda_time_ms(lambda: mod(x, causal), 5)
            plain_ms = cuda_time_ms(lambda: _plain_blocks(mod, x, causal), 5)
        log(f"tower {name:20s} {cfg_t[1]} blocks: kernels {ms:.3f} ms ({b / ms * 1e3:.1f} rows/s) "
            f"plain {plain_ms:.3f} ms ({b / plain_ms * 1e3:.1f} rows/s), min cosine vs plain "
            f"{cos:.6f} (tol >= 0.999)")
        if cos < 0.999:
            raise AssertionError(f"tower {name}: kernels disagree with the plain blocks")
        results[f"tower {name}"] = {"ms": ms, "plain_ms": plain_ms}
        if name.startswith("ViT-L/14 image"):
            # the "mlp" mode of the same blocks: K4 + K9, against "block" (K4 + cuBLAS MLP)
            modeling.FUSED_BLOCK_MODE = "mlp"
            try:
                with torch.inference_mode():
                    k9 = bk.fused_ln_mlp_chunked.launches
                    got_mlp = mod(x, causal)
                    ran = bk.fused_ln_mlp_chunked.launches - k9
                    cos_mlp = float(torch.nn.functional.cosine_similarity(
                        got_mlp.float().flatten(1), want.float().flatten(1), dim=1).min())
                    mlp_ms = cuda_time_ms(lambda: mod(x, causal), 5)
            finally:
                modeling.FUSED_BLOCK_MODE = "block"
            log(f"tower {name:20s} FUSED_BLOCK_MODE=mlp (K4 + K9, {ran} K9 launches): "
                f"{mlp_ms:.3f} ms ({b / mlp_ms * 1e3:.1f} rows/s) against block mode {ms:.3f} ms, "
                f"min cosine vs plain {cos_mlp:.6f} (tol >= 0.999)")
            if ran != cfg_t[1] or cos_mlp < 0.999:
                raise AssertionError(f"tower {name} in mlp mode: K9 did not run on every block "
                                     f"or disagrees with the plain blocks")
            results[f"tower {name} mlp mode"] = {"ms": mlp_ms, "block_ms": ms}
        del mod
    torch.cuda.synchronize()


def check_resnet_tower(results: dict) -> None:
    """RN50's image tower (stock cuDNN convolutions, no hand-written kernel; the
    default ``clip`` of ``image_attention.yaml``) in bf16 against the same
    random weights in f32, both on the card, and its time at the extract batch."""
    import torch

    from summer_clip_torch.models.clip import build_clip

    model, cfg = build_clip("RN50", torch.Generator().manual_seed(0), device="cuda")
    images = _randn((32, cfg.image_resolution, cfg.image_resolution, 3),
                    torch.Generator().manual_seed(3), dtype=torch.float32)
    with torch.inference_mode():
        want = model.encode_image(images)
        model.to_compute(torch.bfloat16)
        got = model.encode_image(images)
        cos = float(torch.nn.functional.cosine_similarity(got.float(), want, dim=-1).min())
        ms = cuda_time_ms(lambda: model.encode_image(images), 30, 5)
    log(f"tower RN50 image B=32 (cuDNN, no kernel of the port): bf16 {ms:.3f} ms "
        f"({32 / ms * 1e3:.1f} img/s), min cosine vs f32 {cos:.6f} (tol >= 0.99)")
    if tuple(got.shape) != (32, cfg.embed_dim) or not torch.isfinite(got.float()).all() \
            or cos < 0.99:
        raise AssertionError("RN50 tower: bf16 features disagree with f32")
    results["tower RN50 image B=32"] = {"ms": ms}


# --------------------------------------------------------------------------- #
# phase 4: the main paths through the port's entry points
# --------------------------------------------------------------------------- #
def launch_counters():
    """Every kernel wrapper of the port by name (each counts its own launches)."""
    from summer_clip_torch.parallel.mesh import kernel_counters

    return kernel_counters()


def counted(path_name: str, needed, drive):
    """Set every launch count to 0, drive one main path, read the counts, and
    fail if a kernel of that path never launched."""
    import torch

    counters = launch_counters()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    out = drive()
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    log(f"phase pipeline {path_name}: {time.perf_counter() - t0:.2f} s, per app "
        + json.dumps({k: round(v, 3) for k, v in out["times_s"].items()}))
    log(f"pipeline {path_name} launches: {json.dumps(launches)}")
    missing = [k for k in needed if launches[k] <= 0]
    if missing:
        raise AssertionError(f"main path {path_name} did not launch {missing}")
    return out, launches


def run_apps(runs, work: Path) -> dict:
    """Each (name, app function, argv) in its own working directory."""
    import os

    times = {}
    cwd = os.getcwd()
    try:
        for name, fn, argv in runs:
            sub = work / name
            sub.mkdir(parents=True, exist_ok=True)
            os.chdir(sub)
            t0 = time.perf_counter()
            fn(argv=argv)
            times[name] = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
    return times


@contextlib.contextmanager
def shared_towers():
    """Inside, every CLIP session an app builds from random weights takes the
    towers already drawn in this process for the same (model, seed, dtype,
    device, quant) instead of drawing them again: drawing ViT-L/14 takes the
    host ~6 s an app. Building a model also draws from torch's global
    generator (the modules' default initialisation); that generator is left
    where the build would have left it, so what an app draws after its session
    does not change. Only for apps that leave the towers as they are (none of
    them is given ``clip.proj_path``, which writes into the tower)."""
    import torch

    from summer_clip_torch.apps import common
    from summer_clip_torch.models.clip.modeling import CLIP, CLIP_CONFIGS

    real, drawn, moves = common.build_clip, {}, {}

    def build(name, gen, **kw):
        key = (name, gen.initial_seed(), *sorted((k, str(v)) for k, v in kw.items()))
        before = (name, torch.get_rng_state().numpy().tobytes())
        if key not in drawn:
            drawn[key] = real(name, gen, **kw)
        elif before in moves:
            torch.set_rng_state(moves[before])
        else:
            CLIP(CLIP_CONFIGS[name])   # draws what the build draws from the global generator
        moves[before] = torch.get_rng_state()
        return drawn[key]

    common.build_clip = build
    try:
        yield
    finally:
        common.build_clip = real
        drawn.clear()


def records(run_root: Path, kind: tp.Optional[str]) -> list:
    """The records of every run under ``run_root`` of type ``kind`` (all with None)."""
    out = []
    for p in sorted(run_root.rglob("records.jsonl")):
        out.extend(r for r in map(json.loads, p.read_text().splitlines())
                   if kind is None or r.get("type") == kind)
    return out


def run_pipeline(work: Path, clip: str = "vit_b16", batch: int = 32,
                 search_step: str = "[32,4]") -> dict:
    """save_features -> eval_clip -> tip_adapter (synthetic: K3) and
    tip_adapter (synthetic_1k, 1 shot: K2), each app in its own directory."""
    import numpy as np

    from summer_clip_torch.store import FeatureStore
    from summer_clip_torch.apps import eval_clip, save_features, tip_adapter

    store = work / "features"
    tag = "ViT-B16"
    common = [f"clip={clip}"]
    tip = ["root_path=''", f"data.batch_size={batch}", f"search_step={search_step}",
           "search_scale=[7,3]"]
    times = run_apps([
        ("save_features", save_features.run, common + [
            "dataset_name=synthetic", "dataset@train_dataset=synthetic_train",
            "dataset@test_dataset=synthetic_test", f"data.batch_size={batch}",
            f"store.root={store}"]),
        ("eval_clip", eval_clip.run, common + [
            "dataset_name=synthetic", "dataset=synthetic_test", f"store.root={store}",
            f"eval.features_key=synthetic_test-{tag}"]),
        ("tip_adapter", tip_adapter.run,
         common + ["dataset=synthetic", "shots=2", "augment_epoch=2", *tip]),
        ("tip_adapter_1k", tip_adapter.run,
         common + ["dataset=synthetic_1k", "shots=1", "augment_epoch=1", *tip]),
    ], work)

    fs = FeatureStore(store)
    for split in ("train", "test"):
        key = f"synthetic_{split}-{tag}"
        if key not in fs:
            raise AssertionError(f"catalog key {key} missing")
        feats = fs.load(key, "features")
        if feats.ndim != 2 or not np.isfinite(feats).all():
            raise AssertionError(f"{key}: bad features {feats.shape}")
    for sub, kinds in (("eval_clip", ("zero_shot",)),
                       ("tip_adapter", ("zero_shot", "tip_result", "tip_searched")),
                       ("tip_adapter_1k", ("zero_shot", "tip_result", "tip_searched"))):
        for kind in kinds:
            recs = records(work / sub, kind)
            if not recs or not all(0.0 <= r["acc1"] <= 100.0 for r in recs):
                raise AssertionError(f"{sub}: record {kind} missing or out of range")
    return {"times_s": times, "store": store}


def check_against_cpu(store: Path, model_name: str, n: int, outs: bool = False,
                      ds_name: str = "synthetic"):
    """What the card's bf16 kernel route stored for ``ds_name`` against the
    same random model in f32 on the CPU (plain versions): the first ``n`` test
    features (min cosine), and with ``outs`` the zero-shot scores that
    ``save_image_outs`` stored for the train split against the stored features
    times the CPU model's text classifier (max |difference| of cosines)."""
    import numpy as np
    import torch

    from summer_clip_torch.data.datasets import SyntheticDataset, SyntheticImageNetScale
    from summer_clip_torch.methods.zeroshot import clip_logits, zeroshot_classifier
    from summer_clip_torch.models.clip import build_clip
    from summer_clip_torch.store import FeatureStore

    model, cfg = build_clip(model_name, torch.Generator().manual_seed(0), device="cpu")
    ds = {"synthetic": SyntheticDataset, "synthetic_1k": SyntheticImageNetScale}[ds_name]()
    fs, tag = FeatureStore(store), model_name.replace("/", "")
    images = np.stack([SyntheticDataset.render(i.impath, cfg.image_resolution)
                       for i in ds.test[:n]])
    with torch.inference_mode():
        ref = model.encode_image(torch.from_numpy(images)).numpy()
        got = fs.load(f"{ds_name}_test-{tag}", "features")[:n]
        cos = (got * ref).sum(1) / (np.linalg.norm(got, axis=1) * np.linalg.norm(ref, axis=1))
        if not outs:
            return float(cos.min()), None
        classifier = zeroshot_classifier(model.encode_text, ds.classnames, ds.template,
                                         chunk_size=len(ds.classnames), device="cpu")
        feats = torch.from_numpy(np.array(fs.load(f"synthetic_train-{tag}", "features")))
        want = clip_logits(feats, classifier, scale=1.0).numpy()
    stored = fs.load(f"synthetic_train_outs-{tag}", "outs")
    return float(cos.min()), float(np.abs(stored - want).max())


def write_prototype_outs(store: Path, ds: str, tag: str) -> int:
    """Pseudo-label scores that do not collapse: the cosine of each stored
    train feature to every class's mean train feature, saved as ``outs`` under
    ``{ds}_train_protos-{tag}``. A random text tower scores nearly every image
    for one class, so ``save_image_outs`` alone gives CLIP-search a cache of
    one class; with these its predicted classes scatter, as a trained model's
    do. Returns the number of distinct predicted classes."""
    import numpy as np
    import torch

    from summer_clip_torch.store import FeatureStore

    fs = FeatureStore(store)
    feats = torch.from_numpy(np.array(fs.load(f"{ds}_train-{tag}", "features"))).cuda()
    labels = torch.from_numpy(np.array(fs.load(f"{ds}_train-{tag}", "labels"))).long().cuda()
    feats = feats / feats.norm(dim=1, keepdim=True)
    protos = torch.zeros(int(labels.max()) + 1, feats.shape[1], device="cuda")
    protos.index_add_(0, labels, feats)
    protos = protos / protos.norm(dim=1, keepdim=True)
    outs = (feats @ protos.t()).cpu().numpy().astype(np.float32)
    fs.save(f"{ds}_train_protos-{tag}", outs=outs)
    return int(np.unique(outs.argmax(1)).shape[0])


def check_search_predictions(run_root: Path, store: Path, ds: str, tag: str,
                             outs_key: str, compute_dtype: str = "bfloat16",
                             witness_dtype: tp.Optional[str] = None) -> dict:
    """Every ``searcher_result`` record of one image_attention run, made with
    ``run_saves.save_logits``, ``save_cache_inds`` and ``save_preds``: the
    predictions the app saved (its kernels, its resident sorted cache, its
    gathers and label tables) against predictions rebuilt here from the stored
    arrays, the saved selection and the plain dense version of the cache
    logits, computed in ``compute_dtype`` (the kernels' bf16, or f32 for the
    dense route of another weights strategy). Returns the least share of test
    rows on which the two agree, the share of rows whose prediction the cache
    changed at the largest alpha, and the number of records compared; with
    ``witness_dtype``, also ``witness``: for each record in the file's order,
    the share of rows on which the plain rebuild in ``compute_dtype`` and the
    plain rebuild in ``witness_dtype`` agree (what rounding alone flips)."""
    import numpy as np
    import torch

    from summer_clip_torch.core import config as C
    from summer_clip_torch.ops import cache_kernels as ck
    from summer_clip_torch.store import FeatureStore

    fs = FeatureStore(store)

    def unit(key):
        x = torch.from_numpy(np.array(fs.load(key, "features"), np.float32)).cuda()
        return x / x.norm(dim=1, keepdim=True).clamp_min(1e-12)

    test, cache = unit(f"{ds}_test-{tag}"), unit(f"{ds}_train-{tag}")
    outs = np.array(fs.load(outs_key, "outs"), np.float32)
    rec_file, = run_root.rglob("records.jsonl")
    run_dir = rec_file.parent
    recs = [json.loads(line) for line in rec_file.read_text().splitlines()]
    zero, = (r for r in recs if r.get("type") == "zero_shot")
    clip = torch.from_numpy(np.load(run_dir / zero["logits_path"])).cuda()
    zero_preds = clip.argmax(1)
    top_alpha = max(r["alpha"] for r in recs if r.get("type") == "searcher_result")

    worst, changed, n, witness = 1.0, 0.0, 0, []
    inds, plain = None, {}
    for r in recs:
        if r.get("type") == "cache_info":
            inds, plain = np.load(run_dir / r["cache_inds_path"]), {}
        if r.get("type") != "searcher_result":
            continue
        vkey = json.dumps(r["cache_value_strategy"], sort_keys=True)
        beta = float(r["cache_weights_strategy"]["beta"])
        for dtype in filter(None, (compute_dtype, witness_dtype)):
            if (vkey, beta, dtype) not in plain:
                values = C.instantiate(r["cache_value_strategy"]).transform(outs[inds])
                plain[vkey, beta, dtype] = ck.cache_attention_dense_reference(
                    test, cache[torch.from_numpy(inds).cuda()], torch.from_numpy(values).cuda(),
                    torch.tensor([beta]), compute_dtype=getattr(torch, dtype))[0]
        want = (clip + r["alpha"] * plain[vkey, beta, compute_dtype]).argmax(1)
        got = torch.from_numpy(np.load(run_dir / r["preds_path"])).cuda()
        worst = min(worst, float((got == want).float().mean()))
        if witness_dtype:
            other = (clip + r["alpha"] * plain[vkey, beta, witness_dtype]).argmax(1)
            witness.append(float((other == want).float().mean()))
        if r["alpha"] == top_alpha:
            changed = max(changed, float((want != zero_preds).float().mean()))
        n += 1
    return {"agree_min": worst, "changed_max": changed, "records": n, "witness": witness}


SEARCH_STRATEGIES = ("topk", "topk_prob", "topk_per_gold", "topk_prob_per_gold",
                     "per_pred_class_random", "per_gold_class_random", "global_random")


SEARCH_TAG = "ViT-L14"
SEARCH_SAVES = ("run_saves.save_logits=true", "run_saves.save_cache_inds=true",
                "run_saves.save_preds=true")


def search_argv(ds: str, outs_key: str, value: str, extra=()) -> list:
    """image_attention's arguments over the CLIP-search store (without
    ``clip`` and ``store.root``). Depth cut: 3 of the 6 cache sizes of each
    selection strategy (the widths, the strategies, the value settings and the
    (beta, alpha) grid are whole)."""
    sizes = [f"cache_strategies.{name}.topk=[1,4,32]" for name in SEARCH_STRATEGIES]
    return [*sizes, f"dataset_name={ds}", "dataset=synthetic_test", f"dataset.dataset={ds}",
            "dataset.load_images=false", "dataset@cache.dataset=synthetic_train",
            f"cache.dataset.dataset={ds}", "cache.dataset.load_images=false",
            f"data.features_key={ds}_test-{SEARCH_TAG}", f"cache.features_key={ds}_train-{SEARCH_TAG}",
            f"cache.outs_key={outs_key}", f"cache_value_strategy={value}", *extra]


def run_clip_search(work: Path) -> dict:
    """CLIP-search at ViT-L/14 on ``synthetic_1k``: save_features ->
    save_image_outs -> image_attention with Hard, then Softmax values; then
    image_attention twice more over prototype pseudo-labels
    (:func:`write_prototype_outs`), whose predictions scatter; then the chain
    on the 4-class ``synthetic`` with Hard values. Three of the runs save their
    predictions and are held against the plain version record by record."""
    from summer_clip_torch.apps import image_attention, save_features, save_image_outs

    store = work / "features"
    tag = SEARCH_TAG
    common = ["clip=vit_l14", f"store.root={store}"]
    saves = SEARCH_SAVES
    scattered = {}
    log(f"clip_search: each of the {len(SEARCH_STRATEGIES)} selection strategies runs at cache "
        f"sizes 1, 4, 32 (the config has 1, 2, 4, 8, 16, 32), to keep the script short")

    def search(ds: str, name: str, outs_key: str, value: str, extra=()):
        return (f"image_attention_{ds}_{name}", image_attention.run,
                search_argv(ds, outs_key, value, extra))

    def chain(ds: str, searches) -> list:
        runs = [
            (f"save_features_{ds}", save_features.run,
             [f"dataset_name={ds}", "dataset@train_dataset=synthetic_train",
              "dataset@test_dataset=synthetic_test", f"train_dataset.dataset={ds}",
              f"test_dataset.dataset={ds}", "save_train_outs=false"]),
            (f"save_image_outs_{ds}", save_image_outs.run,
             [f"dataset_name={ds}", "dataset=synthetic_train", f"dataset.dataset={ds}",
              "dataset.load_images=false", f"data.features_key={ds}_train-{tag}",
              f"data.output_key={ds}_train_outs-{tag}"]),
            *searches]
        return [(name, fn, common + argv) for name, fn, argv in runs]

    outs_1k, protos_1k = f"synthetic_1k_train_outs-{tag}", f"synthetic_1k_train_protos-{tag}"
    with shared_towers():
        times = run_apps(
            chain("synthetic_1k", [
                search("synthetic_1k", "hard_cache", outs_1k, "hard_cache", saves),
                search("synthetic_1k", "softmax_cache", outs_1k, "softmax_cache"),
                ("prototype_outs", lambda argv: scattered.update(
                    classes=write_prototype_outs(store, "synthetic_1k", tag)), []),
                search("synthetic_1k", "protos_hard_cache", protos_1k, "hard_cache", saves),
                search("synthetic_1k", "protos_softmax_cache", protos_1k, "softmax_cache",
                       saves)])
            + chain("synthetic", [search("synthetic", "hard_cache",
                                         f"synthetic_train_outs-{tag}", "hard_cache")]), work)
    log(f"prototype pseudo-labels of synthetic_1k: {scattered['classes']} distinct predicted "
        f"classes of 1000")
    if scattered["classes"] < 500:
        raise AssertionError("prototype pseudo-labels do not scatter")

    # 7 strategies x 3 cache sizes + all_logits, x value settings x 8 betas x 7 alphas
    selections, betas, alphas = len(SEARCH_STRATEGIES) * 3 + 1, 8, 7
    for sub, n_values, outs_key in (
            ("image_attention_synthetic_1k_hard_cache", 1, outs_1k),
            ("image_attention_synthetic_1k_softmax_cache", 3, None),
            ("image_attention_synthetic_1k_protos_hard_cache", 1, protos_1k),
            ("image_attention_synthetic_1k_protos_softmax_cache", 3, protos_1k),
            ("image_attention_synthetic_hard_cache", 1, None)):
        recs = records(work / sub, "searcher_result")
        want = selections * n_values * betas * alphas
        if len(recs) != want:
            raise AssertionError(f"{sub}: {len(recs)} searcher_result records, expected {want}")
        zero = records(work / sub, "zero_shot")
        if len(zero) != 1:
            raise AssertionError(f"{sub}: expected one zero_shot record")
        for r in recs:
            if not (0.0 <= r["acc1"] <= r["acc5"] <= 100.0):
                raise AssertionError(f"{sub}: accuracies out of range in {r}")
            if r["alpha"] == 0.0 and abs(r["acc1"] - zero[0]["acc1"]) > 1e-6:
                raise AssertionError(f"{sub}: alpha = 0 does not reproduce zero-shot: {r}")
        if len(records(work / sub, "cache_info")) != selections:
            raise AssertionError(f"{sub}: expected {selections} cache_info records")
        log(f"{sub}: {len(recs)} searcher_result records, "
            f"{times[sub] / (selections * n_values) * 1e3:.1f} ms of wall clock per "
            f"(selection, value) combination of {betas} betas x {alphas} alphas, zero-shot acc1 "
            f"{zero[0]['acc1']:.2f}, best acc1 {max(r['acc1'] for r in recs):.2f}")
        if outs_key is None:
            continue
        t0 = time.perf_counter()
        held = check_search_predictions(work / sub, store, "synthetic_1k", tag, outs_key)
        log(f"{sub}: saved predictions of {held['records']} records vs the plain version on the "
            f"stored arrays: least agreement {held['agree_min']:.4f} of rows (tol >= "
            f"{TOL_PRED_AGREE}), the cache changed up to {held['changed_max']:.4f} of the "
            f"zero-shot predictions at the largest alpha (scattered pseudo-labels: must be >= "
            f"{MIN_PRED_CHANGED}), "
            f"{time.perf_counter() - t0:.2f} s")
        if held["records"] != want or held["agree_min"] < TOL_PRED_AGREE:
            raise AssertionError(f"{sub}: the app's predictions disagree with the plain version")
        # a cache whose pseudo-labels fell onto one class adds to one column only
        if outs_key == protos_1k and held["changed_max"] < MIN_PRED_CHANGED:
            raise AssertionError(f"{sub}: the cache logits change no prediction, so the "
                                 f"comparison shows nothing")
    return {"times_s": times, "store": store}


GEN_MODEL_CFG = {"gpt_config": "gpt2-large", "clip_emb_dim": 512,
                 "adapters": {"emb_hid_dim": 1024, "head_hid_dim": 1024}}
# perplexity of the flash route against the plain route: the same f32 math,
# sums in another order
TOL_PPL_REL = 1e-3
# ... and their logits: K11 f32 differs from the plain softmax by ~2e-6 a call
# (sums in another order), carried through 36 blocks of f32 products
TOL_FLASH_LOGITS_REL = 1e-3
# greedy logits of the int8 tree against the f32 tree (weight-only int8, ~0.4%
# relative error a matrix): reported, gated only at this cosine
MIN_INT8_COSINE = 0.99
# Greedy ids of two routes of one int8 tree. Each of a token's 147 products
# rounds its input to bf16, and an input that differs in its last f32 bit
# between two routes (sums in another order) may round to the neighbouring
# bf16 value (2^-9 relative). tools/torch_gen_gpt_routes.py follows one decode
# step block by block: the first rounding flips in block 2, from block 5 on
# some 500 of a block's 1280 inputs round differently, and the routes' logits
# end 4.5e-3 of their spread (best minus mean) apart, while K7 alone stays at
# 1e-6 of the plain version whenever both get the same input. The weights are
# random, so a step's logits are nearly flat, and two tokens may tie to within
# that. So equality of the ids is reported, and two readings are gated, each
# set between what the routes read and what a planted fault reads (one
# 128-column tile of one block's c_proj scaled by zero; same tool):
# - a route's picks, teacher forced against the plain route's logits: a pick
#   may miss the plain route's best by this share of the row's spread (routes
#   read 0 to 3.3e-3 over two sets of weights, the fault 1.4e-2);
TOL_GREEDY_TIE = 7e-3
# - the kernel route's own teacher-forced logits, centred, against the plain
#   route's, as a share of the same spread (routes 4.5e-3, the fault 7.1e-2).
TOL_GREEDY_LOGITS = 2e-2
# The megakernel routes also keep K and V as int8 with a scale per row, which
# the plain route (f32 cache) does not; that moves their logits to 6.5e-3 of
# the spread, and the same fault planted into K8's packed parameters reads
# 1.4e-2 on the picks and 7.2e-2 on the logits (same tool), so the same two
# limits hold them.


def _gen_results(run_dir: Path) -> dict:
    import yaml

    path, = run_dir.rglob("results.yaml")
    return yaml.safe_load(path.read_text())


def _device_kernels_ms(fn) -> dict:
    """Device time by kernel name (ms) of one call, from a ``torch.profiler``
    trace of it; empty where the profiler sees no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:   # host events cost seconds a trace
        fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:   # an operator's entry repeats its kernels' time
            continue
        us = float(getattr(ev, "self_device_time_total", 0.0)
                   or getattr(ev, "self_cuda_time_total", 0.0))
        if us > 0:
            out[ev.key] = out.get(ev.key, 0.0) + us / 1e3
    return out


def _wall_ms(fn) -> float:
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def run_gen_gpt(work: Path, launches_of) -> dict:
    """The third main path: ClipGPT on gpt2-large (36 x 1280, 20 heads, CLIP
    vocabulary 49408), random weights from seed 0 (drawn on the host, held on
    the card), saved as a trainable-only checkpoint and served by ``apps.gen_gpt.run``: int8 device
    loop with the perplexity pass on the default route, int8 batched, int8 with
    the fused-MLP opt-in, and the perplexity pass with the flash switch on.
    ``launches_of()`` reads the launch counts; each run's own are differences."""
    import os

    import numpy as np
    import torch

    from summer_clip_torch.apps import gen_gpt
    from summer_clip_torch.engine import serving
    from summer_clip_torch.models.tokenizer import get_tokenizer
    from summer_clip_torch.ops import attention as at

    tok = get_tokenizer()
    model = gen_gpt.build_clip_gpt(GEN_MODEL_CFG, tok.vocab_size, 0)
    if not model.clip_emb.is_cuda:
        raise AssertionError("build_clip_gpt did not pick the card")
    ckpt_dir = gen_gpt.save_clip_gpt_checkpoint(work / "ckpt", model, GEN_MODEL_CFG, 0, step=0)
    del model
    torch.cuda.empty_cache()
    val = work / "val_tokens.npy"
    work.mkdir(parents=True, exist_ok=True)
    np.save(val, np.random.default_rng(0).integers(0, tok.vocab_size, (16, 1024)))
    # the speculative path's draft: a second random ClipGPT of gpt2 width (12 x 768)
    draft_cfg = dict(GEN_MODEL_CFG, gpt_config="gpt2")
    draft = gen_gpt.build_clip_gpt(draft_cfg, tok.vocab_size, 1)
    draft_dir = gen_gpt.save_clip_gpt_checkpoint(work / "draft", draft, draft_cfg, 1, step=0)
    del draft
    torch.cuda.empty_cache()

    def prompt_list(ps):
        return "prompts=[" + ",".join(f'"{p}"' for p in ps) + "]"

    prompts = prompt_list(GEN_PROMPTS)
    common = [f"model.checkpoint_dir={ckpt_dir}", f"generation.max_new_tokens={GEN_NEW_TOKENS}",
              "generation.top_k=1"]
    mega = common + ["generation.quant_int8=true", prompts]          # megakernel=auto: K8
    int8 = mega + ["generation.megakernel=false"]                    # the K7 route
    engine = common + ["generation.quant_int8=true", prompt_list(ENGINE_PROMPTS),
                       "generation.continuous=true", f"generation.batch_slots={ENGINE_SLOTS}",
                       f"generation.burst={ENGINE_BURST}", f"generation.pipeline={ENGINE_PIPELINE}"]
    spec = int8 + ["generation.speculative=true", f"generation.speculative_k={SPEC_K}"]
    n_prompt = [1 + len(tok.encode(p)) for p in GEN_PROMPTS]
    layers, steps = 36, GEN_NEW_TOKENS - 1          # decode forwards after the prefill
    per_token = 4 * layers + 2 + 1                  # K7 a decoded token: blocks, adapters, head
    per_token_fused = 2 * layers + 2 + 1

    def prefill_k7(fused: bool, blocks: int = layers) -> int:   # prompts of <= 8 tokens prefill through K7
        return sum((2 if fused else 4) * blocks + 2 for n in n_prompt if n <= 8)

    # the engine's iterations: a wave is a batched prefill (wide: no kernel of
    # the port) and chained bursts that run to the largest remaining budget
    waves = -(-len(ENGINE_PROMPTS) // ENGINE_SLOTS)
    chains = min(ENGINE_PIPELINE, -(-(GEN_NEW_TOKENS - 1) // ENGINE_BURST))
    engine_steps = waves * chains * ENGINE_BURST

    times, deltas = {}, {}

    bursts = {"n": 0}

    def guarded(fn):
        """A burst of the engine with every synchronisation an error."""
        def burst(*args, **kwargs):
            bursts["n"] += 1
            torch.cuda.set_sync_debug_mode("error")
            try:
                return fn(*args, **kwargs)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        return burst

    def run(name, argv, env=None, flash=False, sync_free=False):
        before = launches_of()
        old_env = {k: os.environ.get(k) for k in (env or {})}
        os.environ.update(env or {})
        at.FLASH_ENABLED = flash
        real = serving._mega_burst, serving._engine_burst
        if sync_free:
            serving._mega_burst, serving._engine_burst = guarded(real[0]), guarded(real[1])
        try:
            times.update(run_apps([(name, gen_gpt.run, argv)], work))
        finally:
            serving._mega_burst, serving._engine_burst = real
            at.FLASH_ENABLED = False
            for k, v in old_env.items():
                os.environ.pop(k, None) if v is None else os.environ.__setitem__(k, v)
        torch.cuda.synchronize()
        after = launches_of()
        deltas[name] = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        log(f"gen_gpt {name}: {times[name]:.2f} s, launches {json.dumps(deltas[name])}")
        return _gen_results(work / name)

    res = {
        "int8_device": run("int8_device", int8 + [f"val.tokens_path={val}"]),
        "int8_batched": run("int8_batched", int8 + ["generation.batched=true"]),
        "int8_fused_mlp": run("int8_fused_mlp", int8, env={"SUMMER_CLIP_FUSED_MLP": "1"}),
        "ppl_flash": run("ppl_flash", common + ["prompts=[]", f"val.tokens_path={val}"], flash=True),
        "mega_device": run("mega_device", mega),
        "mega_batched": run("mega_batched", mega + ["generation.batched=true"]),
        "engine_mega": run("engine_mega", engine, sync_free=True),
        "engine_k7": run("engine_k7", engine + ["generation.megakernel=false"], sync_free=True),
        "spec_gpt2": run("spec_gpt2", spec + [f"generation.draft_checkpoint_dir={draft_dir}"]),
        "spec_self": run("spec_self", spec + [f"generation.draft_checkpoint_dir={ckpt_dir}"]),
    }
    spec_iters = {name: records(work / name, "speculative")[0]["verify_iters"]
                  for name in ("spec_gpt2", "spec_self")}

    want = {
        "int8_device": {"K7 streamed_qmatmul": prefill_k7(False) + 3 * steps * per_token},
        "int8_batched": {"K7 streamed_qmatmul": steps * per_token},
        "int8_fused_mlp": {"K7 streamed_qmatmul": prefill_k7(True) + 3 * steps * per_token_fused,
                           "K10 fused_qmlp": layers * (sum(n <= 8 for n in n_prompt) + 3 * steps)},
        "ppl_flash": {"K11 flash_attention": 2 * layers},
        # the megakernel routes: K8 once and K7 three times (2 adapters, the head) a decoded token
        "mega_device": {"K8 decode_block": 3 * steps,
                        "K7 streamed_qmatmul": prefill_k7(False) + 3 * steps * 3},
        "mega_batched": {"K8 decode_block": steps, "K7 streamed_qmatmul": steps * 3},
        # (a wave's batched prefill is wide, but its head read is 8 rows: K7 once a wave)
        "engine_mega": {"K8 decode_block": engine_steps,
                        "K7 streamed_qmatmul": engine_steps * 3 + waves},
        "engine_k7": {"K7 streamed_qmatmul": engine_steps * per_token + waves},
        # the app's speculative arm decodes the full-precision trees whatever
        # quant_int8 says, as the JAX app does: every forward is the plain route
        "spec_gpt2": {},
        "spec_self": {},
    }
    for name, expected in want.items():
        if deltas[name] != expected:
            raise AssertionError(f"gen_gpt {name}: launches {deltas[name]}, expected {expected} "
                                 f"({per_token} K7 a decoded token, {layers} K10 a token with the "
                                 f"opt-in, 2 x {layers} K11 on the perplexity pass; K8 1 and K7 3 a "
                                 f"decoded token on the megakernel routes)")
    n_engine = [1 + len(tok.encode(p)) for p in ENGINE_PROMPTS]
    for name, res_n in res.items():
        if name == "ppl_flash":
            continue
        gens = res_n["generations"]
        lens = n_engine if name.startswith("engine") else n_prompt
        if len(gens) != len(lens) or any(
                len(g["ids"]) != n + GEN_NEW_TOKENS and tok.eot_token not in g["ids"]
                for g, n in zip(gens, lens)):
            raise AssertionError(f"gen_gpt {name}: bad generations {gens}")
    log(f"gen_gpt engine runs: {len(ENGINE_PROMPTS)} requests through {ENGINE_SLOTS} slots, "
        f"{engine_steps} iterations in {bursts['n']} bursts, every request complete, no "
        f"synchronisation inside a burst (torch.cuda.set_sync_debug_mode('error') around each)")
    if bursts["n"] != 2 * waves * chains:
        raise AssertionError(f"the engine runs made {bursts['n']} bursts, expected {2 * waves * chains}")
    log(f"gen_gpt speculative runs (the app: full-precision trees, quant_int8 ignored), k = "
        f"{SPEC_K}: verify iterations a prompt, gpt2-width draft {spec_iters['spec_gpt2']}, the "
        f"target as its own draft {spec_iters['spec_self']} (every window accepted: "
        f"{-(-GEN_NEW_TOKENS // (SPEC_K + 1))})")
    ppl_plain, ppl_flash = res["int8_device"]["perplexity"], res["ppl_flash"]["perplexity"]
    rel = abs(ppl_flash - ppl_plain) / ppl_plain
    log(f"gen_gpt perplexity over (16, 1024) random tokens: plain route {ppl_plain:.4f}, K11 route "
        f"{ppl_flash:.4f}, relative difference {rel:.3e} (tol {TOL_PPL_REL})")
    if not (np.isfinite(ppl_plain) and np.isfinite(ppl_flash)) or rel > TOL_PPL_REL:
        raise AssertionError("perplexity of the K11 route disagrees with the plain route")
    return {"times_s": times, "results": res, "deltas": deltas, "ckpt_dir": ckpt_dir,
            "draft_dir": draft_dir, "common": common, "int8": int8, "n_prompt": n_prompt,
            "n_engine": n_engine, "guarded": guarded}


def _greedy_margin(qmodel, table, ids, n_prompt: int, stepwise=False, mega=None,
                   stepper=None) -> tuple:
    """How far a route's greedy picks are from the plain route's, teacher
    forced: the whole sequence goes through the int8 tree in one forward (more
    than 8 rows, so every product is the plain version, and the hoisted int8
    head table through its plain version too). For every generated token:
    the plain route's best logit minus its logit of the token picked, as a
    share of the row's spread (best minus mean). (largest share, picks that
    are not the plain route's argmax, logit share). With ``stepwise`` the
    sequence also goes token by token through the cache as the device loop
    runs it (one row: K7, and K10 under its opt-in), and the logit share is the
    largest |d| of those logits, centred, against the plain route's, as a
    share of the same spread; else None. With ``stepwise="mega"`` the walk is
    the megakernel route's: the wide prefill, the cache as int8 rings, then K8 a
    token (``mega``: the packed parameters and the head of ``_mega_state``).
    ``stepper``: what walks the sequence step by step in ``qmodel``'s place
    (a tensor-parallel decoder of it)."""
    import torch

    from summer_clip_torch.models.gpt2 import decode_inputs
    from summer_clip_torch.ops import decode_block as DB
    from summer_clip_torch.ops import gemv

    with torch.inference_mode():
        x = torch.tensor([ids[:-1]], device="cuda")
        hidden = qmodel(x, compute_logits=False)["hidden"][0, n_prompt - 1:]
        logits = gemv.matmul_reference(hidden, table.q, table.scale)
        picked = logits.gather(-1, torch.tensor(ids[n_prompt:], device="cuda")[:, None])[:, 0]
        best = logits.max(-1).values
        spread = best - logits.mean(-1)
        share = (best - picked) / spread
        logit_share = None
        if stepwise:
            walker = stepper or qmodel
            out = walker(x[:, :n_prompt], position_offset=0, cache=walker.init_cache(1, len(ids)),
                         compute_logits=False)
            rows = [gemv.qdot(out["hidden"][:, -1, :], table, torch.float32)[0]]
            if stepwise == "mega":
                packed, head = mega
                kv = DB.cache_to_mega(out["cache"], len(ids), torch.int8)
            for pos in range(n_prompt, len(ids) - 1):
                if stepwise == "mega":
                    offset = torch.full((1,), pos, dtype=torch.long, device="cuda")
                    y, *fresh = DB.decode_block(decode_inputs(qmodel, x[0, pos:pos + 1], offset),
                                                packed, kv, offset, nh=qmodel.config.n_head)
                    DB.mega_update_kv(kv, *fresh, offset)
                    rows.append(head(y)[0])
                    continue
                out = walker(x[:, pos:pos + 1], position_offset=pos, cache=out["cache"],
                             compute_logits=False)
                rows.append(gemv.qdot(out["hidden"][:, -1, :], table, torch.float32)[0])
            own = torch.stack(rows)
            d = (own - own.mean(-1, keepdim=True)) - (logits - logits.mean(-1, keepdim=True))
            logit_share = float((d.abs().amax(-1) / spread).max())
    return float(share.max()), int((share > 0).sum()), logit_share


def check_gen_gpt(gen: dict) -> None:
    """What the kernel route gave, held against other routes of the same
    model (outside the counted run, on one more copy of the model): the int8
    tree through the plain versions (``SUMMER_CLIP_GEMV=0`` and teacher
    forced), the host loop against the device loop, the int8 tree's logits
    against the f32 tree's, the K11 route's logits against the plain route's;
    and the time of a token."""
    import os

    import torch

    from summer_clip_torch.apps import gen_gpt
    from summer_clip_torch.engine import serving
    from summer_clip_torch.engine.quant import quant_head_table, quantize_tree
    from summer_clip_torch.engine.speculative import generate_device_speculative
    from summer_clip_torch.models.tokenizer import get_tokenizer
    from summer_clip_torch.ops import attention as at
    from summer_clip_torch.ops import decode_block as DB
    from summer_clip_torch.ops import gemv

    t0 = time.perf_counter()
    laps = {}

    def lap(name):           # seconds since the last lap, for the phase line
        laps[name] = round(time.perf_counter() - t0 - sum(laps.values()), 2)

    tok = get_tokenizer()
    model = gen_gpt.load_pretrained_clip_gpt(gen["ckpt_dir"], tok)
    qmodel = model.with_tree(quantize_tree(model.tree())).eval()
    table = quant_head_table(qmodel)
    all_ids = [[tok.sot_token] + tok.encode(p) for p in GEN_PROMPTS]
    ids = all_ids[0]
    greedy = dict(max_new_tokens=GEN_NEW_TOKENS, top_k=1, eot_id=tok.eot_token)

    lap("load and quantise")
    os.environ["SUMMER_CLIP_GEMV"] = "0"
    try:
        before = gemv.streamed_qmatmul.launches
        plain_ids = [gen_gpt.generate_device(qmodel, p, quant_int8=True, **greedy) for p in all_ids]
        if gemv.streamed_qmatmul.launches != before:
            raise AssertionError("SUMMER_CLIP_GEMV=0 still launched K7")
    finally:
        del os.environ["SUMMER_CLIP_GEMV"]
    routes = {name: [g["ids"] for g in gen["results"][name]["generations"]]
              for name in ("int8_device", "int8_batched", "int8_fused_mlp", "mega_device",
                           "mega_batched")}
    # K7 and K8 give a row the same bits at 3 rows as at 1 (check_gemv_kernels,
    # check_decode_block), so a batched route's arithmetic is its solo route's
    # and its logits are not walked again
    stepwise = {"int8_device": {}, "int8_fused_mlp": {"SUMMER_CLIP_FUSED_MLP": "1"},
                "mega_device": {}}
    mega_state = gen_gpt._mega_state(qmodel, "check")
    for name, route_ids in routes.items():
        same = sum(a == b for seq, ref in zip(route_ids, plain_ids) for a, b in zip(seq, ref))
        total = sum(len(seq) for seq in route_ids)
        worst, off, worst_logits = 0.0, 0, None
        is_mega = name.startswith("mega")
        tol_tie, tol_logits = TOL_GREEDY_TIE, TOL_GREEDY_LOGITS
        os.environ.update(stepwise.get(name, {}))
        try:
            before = gemv.fused_qmlp.launches
            for seq, n in zip(route_ids, gen["n_prompt"]):
                share, n_off, logit_share = _greedy_margin(
                    qmodel, table, seq, n, name in stepwise and ("mega" if is_mega else True),
                    mega_state)
                worst, off = max(worst, share), off + n_off
                if logit_share is not None:
                    worst_logits = max(worst_logits or 0.0, logit_share)
            if (name == "int8_fused_mlp") != (gemv.fused_qmlp.launches > before):
                raise AssertionError(f"{name}: the teacher-forced walk took the wrong MLP route")
        finally:
            for k in stepwise.get(name, {}):
                del os.environ[k]
        log(f"gen_gpt greedy ids, int8 tree, {name}: equal to the plain route's "
            f"(SUMMER_CLIP_GEMV=0): {route_ids == plain_ids} ({same} of {total} ids); teacher forced "
            f"through the plain route, {off} picks are not its argmax, the farthest by "
            f"{worst:.3e} of the row's logit spread (tol {tol_tie})"
            + ("" if worst_logits is None else
               f"; the route's own teacher-forced logits lie up to {worst_logits:.3e} of the spread "
               f"from the plain route's (tol {tol_logits})"))
        if worst > tol_tie or (worst_logits or 0.0) > tol_logits:
            raise AssertionError(f"{name}: the kernel route disagrees with the plain route "
                                 f"beyond what the order of the sums explains")

    def count_same(a_ids, b_ids):
        return (sum(x == y for a, b in zip(a_ids, b_ids) for x, y in zip(a, b)),
                sum(len(a) for a in a_ids))

    for a, b in (("mega_device", "int8_device"), ("mega_batched", "mega_device")):
        same, total = count_same(routes[a], routes[b])
        log(f"gen_gpt greedy ids, {a} against {b}: {same} of {total} ids equal")

    # the app's speculative runs decode the full-precision trees: their ids
    # against the full tree's solo greedy sampler, and teacher forced through
    # the full tree in one forward, each pick within TOL_GREEDY_TIE of the
    # row's best logit (a verify forward of k + 1 rows sums in another order
    # than a one-row step)
    full_ids = [gen_gpt.generate_device(model, p, **greedy) for p in all_ids]
    for name in ("spec_gpt2", "spec_self"):
        spec_ids = [g["ids"] for g in gen["results"][name]["generations"]]
        worst = 0.0
        with torch.inference_mode():
            for seq, n in zip(spec_ids, gen["n_prompt"]):
                logits = model(torch.tensor([seq[:-1]], device="cuda"))["logits"][0, n - 1:]
                logits = logits.float()
                picked = logits.gather(-1, torch.tensor(seq[n:], device="cuda")[:, None])[:, 0]
                best = logits.max(-1).values
                worst = max(worst, float(((best - picked) / (best - logits.mean(-1))).max()))
        same, total = count_same(spec_ids, full_ids)
        log(f"gen_gpt greedy ids, {name} (full-precision trees) against the full tree's solo "
            f"greedy sampler: {same} of {total} ids equal; teacher forced through the full tree, "
            f"the farthest pick is {worst:.3e} of the row's logit spread from its best (tol "
            f"{TOL_GREEDY_TIE})")
        if worst > TOL_GREEDY_TIE:
            raise AssertionError(f"{name}: speculative picks are not the full tree's greedy picks")

    lap("greedy routes")
    # the engine: every request of the app's two runs, and of a run with
    # staggered budgets (8 .. 24 tokens, short chains, so that slots are
    # reused while others are mid-decode), against the solo megakernel sampler
    # and, teacher forced, against the plain route
    engine_ids = [[tok.sot_token] + tok.encode(p) for p in ENGINE_PROMPTS]
    solo = {}

    def solo_mega(i, budget):
        if (i, budget) not in solo:
            solo[i, budget] = gen_gpt.generate_device(
                qmodel, engine_ids[i], max_new_tokens=budget, top_k=1, quant_int8=True,
                megakernel=True, eot_id=tok.eot_token)
        return solo[i, budget]

    drain_ms = {}

    def engine_run(megakernel: bool, guard: bool = True):
        real = serving._mega_burst, serving._engine_burst
        if guard:
            serving._mega_burst, serving._engine_burst = (gen["guarded"](real[0]),
                                                          gen["guarded"](real[1]))
        try:
            eng = serving.ContinuousBatcher(
                qmodel, batch_slots=ENGINE_SLOTS, max_len=16 + max(ENGINE_BUDGETS), top_k=1,
                quant_int8=True, megakernel=megakernel, burst=4, pipeline=2)
            torch.cuda.synchronize()
            start = time.perf_counter()
            reqs = [eng.submit(p, max_new_tokens=n) for p, n in zip(engine_ids, ENGINE_BUDGETS)]
            eng.run()
            torch.cuda.synchronize()
            drain_ms[megakernel] = (time.perf_counter() - start) * 1e3
        finally:
            serving._mega_burst, serving._engine_burst = real
        if any(not r.done or len(r.out_ids) != n for r, n in zip(reqs, ENGINE_BUDGETS)):
            raise AssertionError("the engine left a request incomplete")
        return [p + r.out_ids for p, r in zip(engine_ids, reqs)]

    runs = {"engine_mega (app, 20 tokens each)":
            ([g["ids"] for g in gen["results"]["engine_mega"]["generations"]],
             [GEN_NEW_TOKENS] * len(engine_ids), TOL_GREEDY_TIE),
            "engine_k7 (app, 20 tokens each)":
            ([g["ids"] for g in gen["results"]["engine_k7"]["generations"]],
             [GEN_NEW_TOKENS] * len(engine_ids), TOL_GREEDY_TIE),
            "engine, megakernel, budgets 8-24": (engine_run(True), ENGINE_BUDGETS, TOL_GREEDY_TIE),
            "engine, K7, budgets 8-24": (engine_run(False), ENGINE_BUDGETS, TOL_GREEDY_TIE)}
    for name, (ids_run, budgets, tol) in runs.items():
        want = [solo_mega(i, n) for i, n in enumerate(budgets)]
        same, total = count_same(ids_run, want)
        whole = sum(a == b for a, b in zip(ids_run, want))
        worst, off = 0.0, 0
        for seq, n in zip(ids_run, gen["n_engine"]):
            share, n_off, _ = _greedy_margin(qmodel, table, seq, n)
            worst, off = max(worst, share), off + n_off
        log(f"gen_gpt {name}: {whole} of {len(want)} requests ({same} of {total} ids) equal the "
            f"solo megakernel sampler's; teacher forced through the plain route, {off} picks are "
            f"not its argmax, the farthest by {worst:.3e} of the row's logit spread (tol {tol})")
        if worst > tol:
            raise AssertionError(f"{name}: the engine disagrees with the plain route beyond what "
                                 f"the order of the sums and the int8 rings explain")

    lap("engine routes")
    dev = gen_gpt.generate_device(model, ids, **greedy)
    host = gen_gpt.generate(model, ids, **greedy)
    log(f"gen_gpt f32 tree, one prompt: host loop ids == device loop ids: {dev == host}")
    if dev != host:
        raise AssertionError(f"host loop ids {host} != device loop ids {dev}")

    with torch.inference_mode():
        x = torch.tensor([ids], device="cuda")
        lf = model(x)["logits"][0, -1]
        lq = qmodel(x)["logits"][0, -1]
        cos = float(torch.nn.functional.cosine_similarity(lf, lq, dim=0))
    log(f"gen_gpt int8 tree against f32 tree, last-position logits of one prompt: cosine {cos:.6f} "
        f"(reported; gated at >= {MIN_INT8_COSINE}), argmax equal: {int(lf.argmax()) == int(lq.argmax())}")
    if cos < MIN_INT8_COSINE:
        raise AssertionError("int8 logits disagree with f32 logits")

    lap("host loop, cosine")
    # one batch of the perplexity pass (8 x 1024 tokens, f32 tree) on either route
    batch = torch.randint(0, tok.vocab_size, (8, 1024), device="cuda",
                          generator=torch.Generator(device="cuda").manual_seed(0))
    ppl_ms, logits = {}, {}
    with torch.inference_mode():
        model(batch)                                      # warm-up
        for route, flash in (("plain", False), ("K11", True)):
            at.FLASH_ENABLED = flash
            try:
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                logits[route] = model(batch)["logits"]
                end.record()
                torch.cuda.synchronize()
                ppl_ms[route] = start.elapsed_time(end)
            finally:
                at.FLASH_ENABLED = False
        # the perplexity of random weights is ln V whatever attention does, so
        # the two routes are also held logit by logit, centred over the vocabulary
        centred = {k: v - v.mean(-1, keepdim=True) for k, v in logits.items()}
        err = float((centred["K11"] - centred["plain"]).abs().max())
        spread = float(centred["plain"].abs().max())
    log("gen_gpt perplexity pass, one (8, 1024) batch through the f32 tree with its logits: "
        + ", ".join(f"{k} route {v:.2f} ms" for k, v in ppl_ms.items())
        + f" (36 attention calls of (160, 1024, 64) f32 in each); logits of the K11 route against "
          f"the plain route: max|d| {err:.3e} of a largest centred logit {spread:.3e} "
          f"(tol {TOL_FLASH_LOGITS_REL} of it)")
    if not err <= TOL_FLASH_LOGITS_REL * spread:
        raise AssertionError("logits of the K11 route disagree with the plain route")
    del model, batch, logits, centred
    torch.cuda.empty_cache()

    lap("perplexity batch")
    # the time of a token: the samplers called as the app calls them. A call
    # for 1 new token is the prefill, the head table and one pick; a call for
    # 20 adds 19 decode steps, so the difference is the decode steps alone.
    with torch.inference_mode():
        cache = qmodel.init_cache(1, len(ids) + GEN_NEW_TOKENS)
        prefill = lambda: qmodel(torch.tensor([ids], device="cuda"), position_offset=0,  # noqa: E731
                                 cache=[dict(c, index=0) for c in cache])
        prefill_ms = cuda_time_ms(prefill, 3, 1)
    log(f"gen_gpt prefill of {len(ids)} tokens on the int8 tree (more than 8 rows: the plain "
        f"route, no kernel of the port): {prefill_ms:.3f} ms")
    kw = dict(top_k=1, quant_int8=True)
    cases = {
        "int8 device loop": (1, {}, lambda n: gen_gpt.generate_device(
            qmodel, ids, max_new_tokens=n, **kw)),
        "int8 batched, 3 rows": (3, {}, lambda n: gen_gpt.generate_device_batched(
            qmodel, all_ids, max_new_tokens=n, **kw)),
        "int8 device loop, fused-MLP opt-in (K10)": (
            1, {"SUMMER_CLIP_FUSED_MLP": "1"},
            lambda n: gen_gpt.generate_device(qmodel, ids, max_new_tokens=n, **kw)),
        "int8 device loop, megakernel (K8)": (1, {}, lambda n: gen_gpt.generate_device(
            qmodel, ids, max_new_tokens=n, megakernel=True, **kw)),
        "int8 batched, 3 rows, megakernel (K8)": (3, {}, lambda n: gen_gpt.generate_device_batched(
            qmodel, all_ids, max_new_tokens=n, megakernel=True, **kw)),
    }
    steps = GEN_NEW_TOKENS - 1
    for name, (rows, env, fn) in cases.items():
        os.environ.update(env)
        try:
            fn(GEN_NEW_TOKENS)
            wall = (_wall_ms(lambda: fn(GEN_NEW_TOKENS)) - _wall_ms(lambda: fn(1))) / steps
            long, short = (_device_kernels_ms(lambda: fn(GEN_NEW_TOKENS)),
                           _device_kernels_ms(lambda: fn(1)))
        finally:
            for k in env:
                del os.environ[k]
        by_kernel = {k: (v - short.get(k, 0.0)) / steps for k, v in long.items()}
        dev_ms = sum(by_kernel.values())
        if not long:
            log(f"gen_gpt {name}: {wall:.3f} ms a decode step, {rows / wall * 1e3:.1f} tokens/s; "
                f"device time not measured (the profiler saw none)")
            continue
        log(f"gen_gpt {name}: {wall:.3f} ms a decode step of wall clock ({steps} steps, prefill "
            f"and head table taken off; one pair of calls), {rows / wall * 1e3:.1f} tokens/s; summed "
            f"device-kernel time {dev_ms:.3f} ms a step; the host's share of a step "
            f"{1.0 - min(1.0, dev_ms / wall):.3f}")
        top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]
        log(f"gen_gpt {name}: device time a step by kernel: "
            + "; ".join(f"{k[:60]} {v:.3f} ms" for k, v in top))
    lap("token times")
    # the engine: a whole drain of the 12 requests (budgets 8-24, prefills
    # included), and the speculative decoder on one prompt
    total = sum(ENGINE_BUDGETS)
    for name, megakernel in (("megakernel", True), ("K7", False)):
        engine_run(megakernel, guard=False)
        wall = drain_ms[megakernel]        # submit and run of a warm engine, its set-up left out
        dev_ms = sum(_device_kernels_ms(lambda: engine_run(megakernel, guard=False)).values())
        log(f"gen_gpt engine, {name}, {len(engine_ids)} requests of 8-24 tokens through "
            f"{ENGINE_SLOTS} slots (bursts of 4, 2 chained): {wall:.1f} ms for {total} tokens, "
            f"{total / wall * 1e3:.1f} tokens/s in aggregate; summed device-kernel time "
            f"{dev_ms:.1f} ms; the host's share {1.0 - min(1.0, dev_ms / wall):.3f}")
    qdraft = gen_gpt.load_pretrained_clip_gpt(gen["draft_dir"], tok)
    qdraft = qdraft.with_tree(quantize_tree(qdraft.tree())).eval()
    for name, draft in (("gpt2-width draft", qdraft), ("the target as its own draft", qmodel)):
        spec = lambda: generate_device_speculative(   # noqa: E731
            qmodel, draft, ids, max_new_tokens=GEN_NEW_TOKENS, k=SPEC_K, quant_int8=True,
            draft_quant_int8=True, return_stats=True)
        spec()
        wall = _wall_ms(spec)
        _, stats = spec()
        log(f"gen_gpt speculative engine (engine.speculative.generate_device_speculative over "
            f"the int8 trees; the app decodes the full trees), k = {SPEC_K}, {name}: "
            f"{stats['verify_iters']} verify "
            f"iterations for {GEN_NEW_TOKENS} tokens ({stats['emitted']} emitted), {wall:.1f} ms, "
            f"{GEN_NEW_TOKENS / wall * 1e3:.1f} tokens/s, prefill of both models included")
    lap("engine and speculative times")
    log(f"phase check gen_gpt: {time.perf_counter() - t0:.2f} s, {json.dumps(laps)}")


# --------------------------------------------------------------------------- #
# the training path: through the frozen towers
# --------------------------------------------------------------------------- #
# Tip-Adapter at ImageNet scale (``tip_adapter_imagenet``, ``clip: rn50``): 16
# shots x 1000 classes of RN50-width (1024) cache keys, 50000 val and 50000 test
# rows, 16000 un-augmented train rows for Tip-Adapter-F; rows are class
# prototypes plus noise (per-coordinate 0.15 of a unit prototype: the cache alone
# ranks ~80% of rows right, the search has to find the (beta, alpha) that
# outvotes the zero-shot logits)
TIP_IMAGENET = dict(classes=1000, shots=16, d=1024, n_val=50000, n_test=50000, noise=0.15)
# one K3 launch per 16-beta chunk: tip_result 1, the search ceil(200 / 16) = 13,
# tip_searched 1, and the same again for Tip-Adapter-F
TIP_IMAGENET_K3 = 2 * (1 + -(-200 // 16) + 1)
TIP_IMAGENET_K14 = 2 * -(-200 // 16)    # one K14 launch a chunk of each search
# tip_searched acc1, chance 0.1: the first run on an H100 read 17.602 (Tip-Adapter-F
# searched 35.648; the random RN50 text tower's zero-shot logits are noise that
# the cache term has to outvote)
MIN_TIP_IMAGENET_ACC = 10.0
# finetune.epochs: conf/tip_adapter_imagenet.yaml's 20, cut to 10 (depth only: the
# store, the grid and Tip-Adapter-F's steps are whole) to keep the script near half
# its time limit
TIP_IMAGENET_EPOCHS = 10


def write_tip_imagenet_store(root: Path) -> dict:
    """The feature store ``tip_adapter_imagenet`` loads with ``load_cache`` and
    ``load_pre_feat`` from its working directory ``root``
    (``caches/synthetic_1k``), made on the card from seed 0."""
    import numpy as np
    import torch

    from summer_clip_torch.store import FeatureStore

    c, shots, d = TIP_IMAGENET["classes"], TIP_IMAGENET["shots"], TIP_IMAGENET["d"]
    gen = torch.Generator(device="cuda").manual_seed(0)
    protos = torch.nn.functional.normalize(
        torch.randn(c, d, generator=gen, device="cuda"), dim=1)

    def rows(labels: torch.Tensor, noise: float) -> np.ndarray:
        x = protos[labels] + noise * torch.randn(labels.shape[0], d, generator=gen,
                                                 device="cuda")
        return torch.nn.functional.normalize(x, dim=1).cpu().numpy()

    fs = FeatureStore(root / "caches" / "synthetic_1k")
    cache_labels = torch.arange(c, device="cuda").repeat_interleave(shots)   # class-grouped
    keys = rows(cache_labels, TIP_IMAGENET["noise"])
    values = np.zeros((c * shots, c), np.float32)
    values[np.arange(c * shots), cache_labels.cpu().numpy()] = 1.0
    fs.save(f"cache_{shots}shots", features=keys, extra={"values": values},
            meta={"shots": shots})
    train = torch.nn.functional.normalize(torch.from_numpy(keys).cuda() + 0.02 * torch.randn(
        keys.shape, generator=gen, device="cuda"), dim=1).cpu().numpy()
    fs.save("train_eval_features", features=train, labels=cache_labels.cpu().numpy())
    for split in ("val", "test"):
        labels = torch.randint(0, c, (TIP_IMAGENET[f"n_{split}"],), generator=gen, device="cuda")
        fs.save(f"{split}_features", features=rows(labels, TIP_IMAGENET["noise"]),
                labels=labels.cpu().numpy())
    return {"rows": c * shots * 2 + TIP_IMAGENET["n_val"] + TIP_IMAGENET["n_test"]}


class _StageTimer:
    """Wraps named functions of a module, adding each call's wall time (the
    card drained before and after) to ``seconds[name]``; ``restore`` undoes it."""

    def __init__(self, module, names):
        import torch

        self.module, self.saved, self.seconds = module, {}, {}
        for name in names:
            fn = self.saved[name] = getattr(module, name)

            def wrapper(*a, _fn=fn, _name=name, **k):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = _fn(*a, **k)
                torch.cuda.synchronize()
                self.seconds[_name] = self.seconds.get(_name, 0.0) + time.perf_counter() - t0
                return out
            setattr(module, name, wrapper)

    def restore(self):
        for name, fn in self.saved.items():
            setattr(self.module, name, fn)


TIP_IMAGENET_RECORDS = ("tip_result", "tip_searched", "tipf_result", "tipf_searched")


def run_tip_imagenet(work: Path) -> dict:
    """``tip_adapter.run_imagenet`` at ImageNet scale on RN50 (random weights:
    its text tower encodes 1000 x 7 prompts through K5 and K6) over a written
    store, Tip-Adapter-F on, the config's full (200, 20) grid; the stages timed
    and the peak memory read."""
    import torch

    from summer_clip_torch.apps import tip_adapter
    from summer_clip_torch.methods import tip as tip_methods

    t0 = time.perf_counter()
    written = write_tip_imagenet_store(work / "tip_adapter_imagenet")
    t_store = time.perf_counter() - t0
    stages = _StageTimer(tip_methods, ("search_hp", "finetune_cache_keys"))
    zs = _StageTimer(tip_adapter, ("zeroshot_classifier",))
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    try:
        times = run_apps([("tip_adapter_imagenet", tip_adapter.run_imagenet,
                           TIP_IMAGENET_ARGV)], work)
    finally:
        stages.restore(), zs.restore()
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    log(f"tip_adapter_imagenet: store of {written['rows']} rows written in {t_store:.2f} s; "
        f"app {times['tip_adapter_imagenet']:.2f} s: text classifier "
        f"{zs.seconds.get('zeroshot_classifier', 0.0):.2f} s, two (200, 20) searches "
        f"{stages.seconds.get('search_hp', 0.0):.2f} s, Tip-Adapter-F training "
        f"{stages.seconds.get('finetune_cache_keys', 0.0):.2f} s; peak memory {peak:.3f} GiB "
        f"above the {base / 2 ** 30:.3f} GiB resident before it")
    times["write_store"] = t_store
    return {"times_s": times, "peak_gib": peak, "stages_s": {**stages.seconds, **zs.seconds}}


TIP_IMAGENET_ARGV = ["dataset=synthetic_1k", "load_cache=true", "load_pre_feat=true",
                     "finetune.enabled=true", f"finetune.epochs={TIP_IMAGENET_EPOCHS}",
                     "hydra.job.chdir=false", "root_path=''"]


def check_tip_imagenet(work: Path) -> None:
    """The records of the kernel run, then the same store through the plain
    route (``cache_attention_labels_reference`` in place of the kernels): the
    same searched (beta, alpha) and accuracies."""
    import torch

    from summer_clip_torch.apps import tip_adapter
    from summer_clip_torch.methods import tip as tip_methods
    from summer_clip_torch.ops import cache_kernels as ck

    run = work / "tip_adapter_imagenet"
    got = {k: records(run, k) for k in (*TIP_IMAGENET_RECORDS, "zero_shot", "tipf_epoch")}
    for kind in TIP_IMAGENET_RECORDS:
        if len(got[kind]) != 1 or not 0.0 <= got[kind][0]["acc1"] <= 100.0:
            raise AssertionError(f"tip_adapter_imagenet: record {kind} missing or out of range")
    losses = [r["loss"] for r in got["tipf_epoch"]]
    log("tip_adapter_imagenet records: " + json.dumps({k: {kk: v[0][kk] for kk in v[0]
                                                         if kk != "type"}
                                                     for k, v in got.items() if k != "tipf_epoch"})
        + f"; Tip-Adapter-F train CE by epoch {[round(x, 4) for x in losses]}")
    if got["tip_searched"][0]["acc1"] < MIN_TIP_IMAGENET_ACC:
        raise AssertionError(f"tip_searched acc1 {got['tip_searched'][0]['acc1']} below "
                             f"{MIN_TIP_IMAGENET_ACC}")
    if len(losses) != TIP_IMAGENET_EPOCHS or not losses[-1] < losses[0]:
        raise AssertionError(f"Tip-Adapter-F train CE did not fall: {losses}")

    def plain_route(f, keys, vals, betas, cache_labels=None):
        return ck.cache_attention_labels_reference(
            f, keys, torch.as_tensor(cache_labels), torch.as_tensor(betas, dtype=torch.float32),
            int(vals.shape[1]), compute_dtype=torch.bfloat16)

    plain = work / "plain"
    (plain / "tip_adapter_imagenet").mkdir(parents=True)
    (plain / "tip_adapter_imagenet" / "caches").symlink_to(run / "caches")
    real = tip_methods.cache_attention_auto
    tip_methods.cache_attention_auto = plain_route
    t0 = time.perf_counter()
    try:
        run_apps([("tip_adapter_imagenet", tip_adapter.run_imagenet, TIP_IMAGENET_ARGV)], plain)
    finally:
        tip_methods.cache_attention_auto = real
    want = {k: records(plain / "tip_adapter_imagenet", k) for k in TIP_IMAGENET_RECORDS}
    log(f"tip_adapter_imagenet through the plain route: {time.perf_counter() - t0:.2f} s, "
        + json.dumps({k: {kk: v[0][kk] for kk in ("beta", "alpha", "acc1")}
                      for k, v in want.items()}))
    for kind in TIP_IMAGENET_RECORDS:
        g, w = got[kind][0], want[kind][0]
        if any(g[k] != w[k] for k in ("beta", "alpha", "acc1")):
            raise AssertionError(f"tip_adapter_imagenet {kind}: kernels {g} != plain {w}")


def run_analysis(store: Path, work: Path) -> dict:
    """``maha_distance``, ``train_em`` (diagonal covariances) and
    ``class_projector`` over the ViT-L/14 ``synthetic_1k`` store of the
    CLIP-search path; the records in range and every logits matrix finite."""
    import numpy as np
    import torch

    from summer_clip_torch.apps import class_projector, maha_distance, train_em

    finite = []

    def watch(owner, name):
        """Record whether each output of ``owner.name`` is finite."""
        import inspect

        raw = inspect.getattr_static(owner, name)
        fn = getattr(owner, name)

        def wrapper(*a, **k):
            out = fn(*a, **k)
            finite.append((name, bool(np.isfinite(
                out.detach().cpu().numpy() if isinstance(out, torch.Tensor) else out).all())))
            return out
        setattr(owner, name, staticmethod(wrapper) if isinstance(raw, staticmethod) else wrapper)
        return owner, name, raw

    tag = "ViT-L14"
    common = ["clip=vit_l14", f"store.root={store}", "dataset_name=synthetic_1k",
              "dataset=synthetic_test", "dataset.dataset=synthetic_1k",
              "dataset.load_images=false", f"data.features_key=synthetic_1k_test-{tag}"]
    saved = [watch(maha_distance, "maha_logits"),
             watch(train_em.FixedMeansGMM, "predict_log_proba"),
             watch(class_projector.ClassProjector, "compute_clip_logits")]
    try:
        with shared_towers():
            times = run_apps([
                ("maha_distance", maha_distance.run,
                 common + [f"cache.features_key=synthetic_1k_train-{tag}"]),
                ("train_em", train_em.run, common + ["em_model.covariance_type=diag"]),
                ("class_projector", class_projector.run, common)], work)
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)
    recs = {"maha_result": records(work / "maha_distance", "maha_result"),
            "em_result": records(work / "train_em", "em_result"),
            "pca": [r for r in records(work / "class_projector", None)
                    if "n_components" in r]}
    log("analysis: " + json.dumps({k: [{kk: r[kk] for kk in ("n_components", "acc1", "acc5")
                                        if kk in r} for r in v] for k, v in recs.items()})
        + " " + json.dumps({k: round(v, 2) for k, v in times.items()}))
    if len(recs["maha_result"]) != 1 or len(recs["em_result"]) != 1 or len(recs["pca"]) != 5:
        raise AssertionError(f"analysis: records missing {recs}")
    for r in [*recs["maha_result"], *recs["em_result"], *recs["pca"]]:
        if not 0.0 <= r["acc1"] <= r["acc5"] <= 100.0:
            raise AssertionError(f"analysis: accuracies out of range in {r}")
    if not list(work.rglob("em_model.ckpt")):
        raise AssertionError("train_em saved no model")
    if not finite or not all(ok for _, ok in finite):
        raise AssertionError(f"analysis: non-finite logits {finite}")
    return {"times_s": times}


TRAIN_STEPS = 1000 // 32                  # synthetic_1k, 1 shot of 1000 classes, batch 32
TEXT_FORWARDS = TRAIN_STEPS + 2           # the steps, then the train and val accuracy passes
IMAGE_BATCHES_1K = -(-2000 // 32) + -(-1000 // 32)
GUMBEL_STEPS = 32 // 8                    # synthetic: 32 train images, batch 8


def _store_cosine(store_a: Path, store_b: Path, key: str) -> float:
    import numpy as np

    from summer_clip_torch.store import FeatureStore

    a = np.array(FeatureStore(store_a).load(key, "features"), np.float64)
    b = np.array(FeatureStore(store_b).load(key, "features"), np.float64)
    if a.shape != b.shape or not np.isfinite(a).all():
        raise AssertionError(f"{key}: stores of {a.shape} and {b.shape}, or non-finite rows")
    return float(((a * b).sum(1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))).min())


def run_training(work: Path, search_store: Path, tip_store: Path, gpt_ckpt: Path,
                 launches_of) -> dict:
    """The fourth main path (module docstring, step 4): (a) save_features at
    ViT-L/14 in "mlp" mode, (b) train_coop with CoOp over 1000 classes, (d)
    eval_prompt, (e) train_coop with Gumbel and fluency through gpt2-large,
    (f) train_adapter -> eval_adapter. Returns the times, the (b) trainer (for
    the gradient gate) and each app's own launch counts."""
    import yaml

    from summer_clip_torch.apps import (eval_adapter, eval_prompt, save_features, train_adapter,
                                        train_coop)
    from summer_clip_torch.models.clip import modeling

    store = work / "features"
    tag, ds = "ViT-L14", "synthetic_1k"
    views = [f"dataset_name={ds}", "dataset=synthetic_train", f"dataset.dataset={ds}",
             "dataset.load_images=false"]
    captured = {}
    real_run_trainer = train_coop.run_trainer

    def capture(cls, cfg):
        captured.setdefault("trainer", real_run_trainer(cls, cfg))
        return captured["trainer"]

    per_app, last = {}, launches_of()

    def counted_app(name, fn):
        def run(argv):
            nonlocal last
            fn(argv=argv)
            now = launches_of()
            per_app[name] = {k: now[k] - last[k] for k in now if now[k] != last[k]}
            last = now
        return run

    def mlp_mode(argv):
        modeling.FUSED_BLOCK_MODE = "mlp"
        try:
            save_features.run(argv=argv)
        finally:
            modeling.FUSED_BLOCK_MODE = "block"

    train_coop.run_trainer = capture
    try:
        times = run_apps([
            ("a_save_features_mlp_mode", counted_app("a", mlp_mode), [
                "clip=vit_l14", f"store.root={store}", f"dataset_name={ds}",
                "dataset@train_dataset=synthetic_train", "dataset@test_dataset=synthetic_test",
                f"train_dataset.dataset={ds}", f"test_dataset.dataset={ds}",
                "save_train_outs=false"]),
            ("b_train_coop", counted_app("b", train_coop.run), [
                "clip=vit_l14", f"store.root={store}", *views,
                "dataset@val_dataset=synthetic_test", f"val_dataset.dataset={ds}",
                "val_dataset.load_images=false", f"data.features_key={ds}_train-{tag}",
                f"data.val_features_key={ds}_test-{tag}", "data.batch_size=32",
                "dataset_info.k_shots=1", "prompt.length=16", "training.epochs_num=1"]),
        ], work)
        coop_dir, = (work / "b_train_coop").rglob("checkpoints/epoch_1")
        learned = yaml.safe_load((coop_dir / "prompt.yaml").read_text())["ids"]
        times.update(run_apps([
            ("d_eval_prompt", counted_app("d", eval_prompt.run), [
                "clip=vit_l14", f"store.root={store}", f"dataset_name={ds}",
                "dataset=synthetic_test", f"dataset.dataset={ds}", "dataset.load_images=false",
                f"clip_data.features_key={ds}_test-{tag}", f"prompts_ids=[{learned}]"]),
            ("e_train_coop_gumbel_fluency", counted_app("e", train_coop.run), [
                "clip=vit_b16", f"store.root={tip_store}", "dataset_name=synthetic",
                "dataset=synthetic_train", "dataset.load_images=false", "val_dataset=null",
                "data.features_key=synthetic_train-ViT-B16", "data.batch_size=8",
                "training.epochs_num=1", "prompt.length=8", "prompt_model=gumbel_v1a1",
                "temp_scheduler=linear", f"temp_scheduler.steps_num={GUMBEL_STEPS}",
                "lm_loss=suffix", "loss.fluency=0.5", f"+gpt.checkpoint_dir={gpt_ckpt}"]),
            ("f_train_adapter", counted_app("f_train", train_adapter.run), [
                "clip=vit_l14", f"store.root={store}", *views,
                f"data.features_key={ds}_train-{tag}", "data.batch_size=32",
                "training.epochs_num=2", "training.adam_params.lr=0.001"]),
        ], work))
        adapter_dir, = (work / "f_train_adapter").rglob("checkpoints/epoch_2")
        times.update(run_apps([
            ("f_eval_adapter", counted_app("f_eval", eval_adapter.run), [
                "clip=vit_l14", f"store.root={store}", f"dataset_name={ds}",
                "dataset=synthetic_test", f"dataset.dataset={ds}", "dataset.load_images=false",
                f"eval.checkpoint_dir={adapter_dir}", f"eval.features_key={ds}_test-{tag}"]),
        ], work))
    finally:
        train_coop.run_trainer = real_run_trainer

    # (a) the "mlp" mode store against the "block" mode store of the same model
    for split in ("train", "test"):
        cos = _store_cosine(store, search_store, f"{ds}_{split}-{tag}")
        log(f"train_coop (a): {ds}_{split}-{tag} stored in mlp mode (K9) vs block mode: "
            f"min cosine {cos:.6f} (tol >= {TOL_MODE_STORE_COS})")
        if cos < TOL_MODE_STORE_COS:
            raise AssertionError("mlp-mode features disagree with the block-mode store")
    # (b) records and files
    recs = records(work / "b_train_coop", "prompt")
    if len(recs) != 1 or len(recs[0]["prompt_ids"]) != 16:
        raise AssertionError(f"train_coop: expected one 16-token prompt record, got {recs}")
    if not {"model.ckpt", "meta.yaml", "prompt.yaml"} <= {p.name for p in coop_dir.iterdir()}:
        raise AssertionError(f"train_coop: {coop_dir} lacks the checkpoint files")
    epoch = _epoch_record(work / "b_train_coop")
    log(f"train_coop (b): {TRAIN_STEPS} steps, loss/clip {epoch['loss/clip']:.4f}, train acc1 "
        f"{epoch['train/acc1']:.2f}, val acc1 {epoch['val/acc1']:.2f}, prompt "
        f"{recs[0]['prompt_text']!r}")
    # (d), (e), (f)
    for sub, kind in (("d_eval_prompt", "eval_prompt"), ("f_eval_adapter", "eval_adapter")):
        rec = records(work / sub, kind)
        if len(rec) != 1 or not 0 <= rec[0]["acc1"] <= 100:
            raise AssertionError(f"{sub}: expected one {kind} record in range, got {rec}")
        log(f"train_coop ({sub[0]}): {kind} acc1 {rec[0]['acc1']:.2f} acc5 {rec[0]['acc5']:.2f}")
    gumbel = _epoch_record(work / "e_train_coop_gumbel_fluency")
    norms = [v for k, v in gumbel.items() if k.startswith("prompt_grad_norm/")]
    log(f"train_coop (e): loss/clip {gumbel['loss/clip']:.4f} loss/fluency "
        f"{gumbel['loss/fluency']:.4f}, prompt_embs gradient norms {min(norms):.3e} .. "
        f"{max(norms):.3e}")
    if len(norms) != 8 or not all(0 < v < float("inf") for v in norms):
        raise AssertionError("train_coop (e): the prompt_embs gradient is not finite and non-zero")

    # each app's own launches: exact where the path fixes them
    want = {"a": {"K4 short_attention_packed": 24 * IMAGE_BATCHES_1K,
                  "K9 fused_ln_mlp_chunked": 24 * IMAGE_BATCHES_1K},
            "b": {"K5 fused_ln_attn": 12 * TEXT_FORWARDS, "K6 fused_ln_mlp": 12 * TEXT_FORWARDS},
            "e": {"K4 short_attention_packed": 36 * GUMBEL_STEPS}}
    log(f"train_coop launches by app: {json.dumps(per_app)}")
    for app, counts in want.items():
        for k, n in counts.items():
            if per_app[app].get(k, 0) != n:
                raise AssertionError(f"train_coop ({app}): {k} launched {per_app[app].get(k, 0)} "
                                     f"times, expected {n}")
    for app in ("d", "f_train", "f_eval"):
        if not (per_app[app].get("K5 fused_ln_attn", 0) > 0 and per_app[app].get("K6 fused_ln_mlp", 0) > 0):
            raise AssertionError(f"train_coop ({app}): the text tower did not run K5 and K6")
    return {"times_s": times, "store": store, "trainer": captured["trainer"]}


def _epoch_record(run_root: Path, key: str = "loss/total") -> dict:
    rec_file, = run_root.rglob("records.jsonl")
    recs = [json.loads(line) for line in rec_file.read_text().splitlines()]
    return [r for r in recs if "epoch" in r and key in r][-1]


def check_training(trainer) -> None:
    """(c) The gradient gate on one CoOp batch of the (b) trainer, the planted
    fault's readings, and the step's time and peak memory."""
    import numpy as np
    import torch

    from summer_clip_torch.models.clip import modeling
    from summer_clip_torch.ops import attention as at

    counters = launch_counters()
    counts = lambda: {k: f.launches for k, f in counters.items()}   # noqa: E731
    idx = torch.from_numpy(trainer.train_indices[:32]).to(trainer.device)
    labels = torch.from_numpy(trainer.labels).to(trainer.device)[idx]
    feats = trainer.image_features[idx]
    lm_idx = trainer.labels[trainer.train_indices[:32]]
    prompt0 = {k: v.detach().clone() for k, v in trainer.prompt_params.items()}

    def step(timed=False):
        params = {k: v.clone().requires_grad_() for k, v in prompt0.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _ = trainer.loss_fn(params, feats, labels, lm_idx, 1.0)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        before = counts()
        loss.backward()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        launched = {k: v - before[k] for k, v in counts().items() if v != before[k]}
        return float(loss), params["prompt_embs"].grad.float(), launched, (t1 - t0) * 1e3, (t2 - t1) * 1e3

    def routes(name):
        before = counts()
        out = step()
        fwd = {k: v - before[k] for k, v in counts().items() if v != before[k]}
        if out[2]:
            raise AssertionError(f"gate ({name}): loss.backward() launched {out[2]}")
        return out, fwd

    def readings(a, b):
        return {"loss_rel": abs(a[0] - b[0]) / abs(b[0]),
                "grad_rel": float((a[1] - b[1]).norm() / b[1].norm()),
                "grad_cos": float(torch.nn.functional.cosine_similarity(
                    a[1].flatten(), b[1].flatten(), dim=0))}

    (kern, kern_fwd), (plain, plain_fwd) = routes("kernels"), plain_route(lambda: routes("plain"))
    if kern_fwd != {"K5 fused_ln_attn": 12, "K6 fused_ln_mlp": 12} or plain_fwd:
        raise AssertionError(f"gate: kernel route launched {kern_fwd}, plain route {plain_fwd}")
    gate = readings(kern, plain)
    # the planted fault: 64 hidden units of block 5's c_fc zeroed on the kernel route
    mlp = trainer.session.model.transformer.resblocks[5].mlp
    saved = mlp.c_fc.weight[:64].clone(), mlp.c_fc.bias[:64].clone()
    with torch.no_grad():
        mlp.c_fc.weight[:64] = 0
        mlp.c_fc.bias[:64] = 0
    try:
        fault = readings(routes("fault")[0], plain)
    finally:
        with torch.no_grad():
            mlp.c_fc.weight[:64], mlp.c_fc.bias[:64] = saved
    fmt = lambda r: ", ".join(f"{k} {v:.4e}" for k, v in r.items())   # noqa: E731
    log(f"gate: kernel route vs plain route on one batch of 32 (loss {plain[0]:.6f}, |g| "
        f"{float(plain[1].norm()):.4e}): {fmt(gate)}; limits loss_rel <= {TOL_GATE_LOSS}, "
        f"grad_rel <= {TOL_GATE_GRAD_REL}, grad_cos >= {TOL_GATE_GRAD_COS}; planted fault "
        f"(block 5, c_fc hidden 0..63 zeroed): {fmt(fault)}")
    if not (float(kern[1].norm()) > 0 and np.isfinite(kern[0])):
        raise AssertionError("gate: the kernel route's prompt gradient is zero or not finite")
    if (gate["loss_rel"] > TOL_GATE_LOSS or gate["grad_rel"] > TOL_GATE_GRAD_REL
            or gate["grad_cos"] < TOL_GATE_GRAD_COS):
        raise AssertionError("gate: the kernel route's loss or gradient disagrees with plain")
    if not (fault["loss_rel"] > TOL_GATE_LOSS or fault["grad_rel"] > TOL_GATE_GRAD_REL
            or fault["grad_cos"] < TOL_GATE_GRAD_COS):
        raise AssertionError("gate: the limits do not catch the planted fault")

    # a CoOp step's time, forward and backward apart, both routes, and its peak memory
    for name, run in (("kernels", step), ("plain", lambda: plain_route(step)),
                      ("kernels", step), ("plain", lambda: plain_route(step))):
        run()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        times = [run()[3:] for _ in range(3)]
        peak = torch.cuda.max_memory_allocated() - base
        fwd, bwd = (float(np.median([t[i] for t in times])) for i in (0, 1))
        log(f"CoOp step, {len(trainer.classes)} classes x 77 tokens, ViT-L/14 text tower, "
            f"{name} route: forward {fwd:.2f} ms, backward {bwd:.2f} ms, step {fwd + bwd:.2f} ms, "
            f"peak memory of a step {peak / 2 ** 30:.3f} GiB above the resident "
            f"{base / 2 ** 30:.3f} GiB")


# --------------------------------------------------------------------------- #
# prompt_search: AutoPrompt, FluentPrompt, Gumbelv3a1, ProLIP, the dense route
# --------------------------------------------------------------------------- #
# the losses of a HotFlip step on the kernel route against the route that
# launches no kernel: CE over the classes through two bf16 towers that round
# in other places (the CoOp gate reads its loss at 2.5e-4)
TOL_SEARCH_LOSS_REL = 1e-3
# ProLIP's W trained on the card against the same training on the CPU from the
# same pre-projection features: |W_card - W_cpu| / |W_cpu - W0| (Frobenius),
# f32 with TF32 off on both sides, sums in another order over 60 Adam steps
TOL_PROLIP_W_REL = 1e-3
# Gumbelv3a1's fluency term, its loss and proposer gradient: an f32 ClipGPT on
# both routes, K4's f32 forward against the plain attention (the backward
# recomputes)
TOL_FLUENCY_REL = 1e-4
# ... and its CLIP term, which crosses the bf16 text tower over 4 classes: the
# kernel route's text features and proposer gradient, vectors, no farther from
# the route with an f32 tower than this many times the plain route's are (two
# bf16 routes part by rounding, ROADMAP Queue 3).
TOL_F32_RATIO = 1.5
# The CLIP loss is the same f32 function of F on every route, so it moves from
# the plain route's by its first-order change <dL/dF, F_k - F_p> and, beyond
# that, by at most this share of |dL/dF| |F_k - F_p| (the second order; read
# at 1e-4 of it) and a few f32 units of the loss.
TOL_LOSS_SECOND_ORDER = 0.05
F32_UNIT = 2.0 ** -23
PROMPT_SEARCH_PATH = ("K4 short_attention_packed", "K5 fused_ln_attn", "K6 fused_ln_mlp")


def tip_formula_weights(beta: float):
    """A weights strategy the cache kernels do not know, computing Tip-Adapter's
    formula by its own ``transform`` (``image_attention`` takes its dense
    route); ``_target_: chip_smoke.tip_formula_weights``."""
    import numpy as np

    from summer_clip_torch.methods.cache import CacheWeightsStrategy

    def unit(x):
        x = np.asarray(x, np.float32)
        return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-12)

    class TipFormula(CacheWeightsStrategy):
        def transform(self, test_image_features, cache_image_features):
            return np.exp(-beta * (1.0 - unit(test_image_features) @ unit(cache_image_features).T))
    return TipFormula()


def plain_route(fn):
    """``fn()`` on the route that launches no kernel: the towers' blocks
    through XLA's counterpart and K4 off (``FUSED_BLOCK_MODE="xla"``,
    ``SHORT_FUSED_ENABLED=False``)."""
    from summer_clip_torch.models.clip import modeling
    from summer_clip_torch.ops import attention as at

    modeling.FUSED_BLOCK_MODE, at.SHORT_FUSED_ENABLED = "xla", False
    try:
        return fn()
    finally:
        modeling.FUSED_BLOCK_MODE, at.SHORT_FUSED_ENABLED = "block", True


def prompt_search_sizes(search_store: Path, search_dir: Path, tip_store: Path,
                        gpt_ckpt: Path) -> dict:
    """The full-width sizes: (g), (h), (k) at ViT-L/14 over ``synthetic_1k``
    (1000 classes, the CLIP-search path's store), (i) at ViT-B/16 on
    ``synthetic`` through the gen_gpt path's gpt2-large checkpoint, (j) at
    ViT-B/16 on ``synthetic``."""
    return dict(
        text_clip=["clip=vit_l14"], text_layers=12, text_store=search_store,
        text_ds="synthetic_1k", text_tag="ViT-L14", k_shots=1, n_train=1000, ap_batch=125,
        fluent_batch=250,
        gumbel_clip=["clip=vit_b16"], gumbel_layers=12, gumbel_store=tip_store,
        gumbel_tag="ViT-B16", gpt_ckpt=gpt_ckpt, gpt_layers=36,
        prolip_clip=["clip=vit_b16"], prolip_layers=(12, 12),
        search_dir=search_dir / "image_attention_synthetic_1k_protos_hard_cache",
        search_outs="synthetic_1k_train_protos-ViT-L14",
        search_sizes=[f"cache_strategies.{n}.topk=[1,4,32]" for n in SEARCH_STRATEGIES])


def run_prompt_search(work: Path, s: dict, launches_of, phases: str = "ghijk") -> dict:
    """The sixth main path, ``prompt_search`` (module docstring, step 4): (g)
    train_autoprompt in AutoPrompt mode, (h) in FluentPrompt mode, (i)
    train_coop with Gumbelv3a1 (adapter head) and fluency, (j) train_prolip,
    (k) image_attention with a weights strategy the kernels do not know.
    Returns the times, each app's own launch counts, the trainers and what
    the gates read afterwards (:func:`check_prompt_search`)."""
    import numpy as np
    import torch

    from summer_clip_torch.apps import image_attention, train_autoprompt, train_coop, train_prolip
    from summer_clip_torch.methods import fluentprompt

    out = {"launches": {}, "trainers": {}, "losses": [], "projections": [], "sizes": s,
           "phases": phases, "work": work}
    last = launches_of()

    def counted_app(name, fn, capture=None):
        def run(argv):
            nonlocal last
            real = capture.run_trainer if capture else None
            if capture:
                capture.run_trainer = lambda cls, cfg: out["trainers"].setdefault(
                    name, real(cls, cfg))
            try:
                fn(argv=argv)
            finally:
                if capture:
                    capture.run_trainer = real
            now = launches_of()
            out["launches"][name] = {k: now[k] - last[k] for k in now if now[k] != last[k]}
            last = now
        return run

    ds, tag = s["text_ds"], s["text_tag"]
    search = [*s["text_clip"], f"store.root={s['text_store']}", f"dataset_name={ds}",
              "dataset=synthetic_train", f"dataset.dataset={ds}", "dataset.load_images=false",
              "val_dataset=null", f"data.features_key={ds}_train-{tag}",
              f"dataset_info.k_shots={s['k_shots']}", "training.epochs_num=1"]
    runs = []
    if "g" in phases:
        runs.append(("g_train_autoprompt", counted_app("g", train_autoprompt.run, train_autoprompt),
                     search + [f"data.batch_size={s['ap_batch']}", "search.num_cands=10",
                               "search.search_steps=2", "search.save_every=2"]))
    if "h" in phases:
        runs.append(("h_train_fluentprompt",
                     counted_app("h", train_autoprompt.run, train_autoprompt),
                     search + [f"data.batch_size={s['fluent_batch']}", "search.mode=fluentprompt"]))
    if "i" in phases:
        runs.append(("i_train_coop_gumbel_v3a1", counted_app("i", train_coop.run, train_coop), [
            *s["gumbel_clip"], f"store.root={s['gumbel_store']}", "dataset_name=synthetic",
            "dataset=synthetic_train", "dataset.load_images=false", "val_dataset=null",
            f"data.features_key=synthetic_train-{s['gumbel_tag']}", "data.batch_size=8",
            "training.epochs_num=1", "prompt.length=8", "prompt_model=gumbel_v3a1",
            "lm_loss=suffix", "loss.fluency=0.5", f"+gpt.checkpoint_dir={s['gpt_ckpt']}"]))
    if "j" in phases:
        runs.append(("j_train_prolip", counted_app("j", train_prolip.run, train_prolip), [
            *s["prolip_clip"], "dataset=synthetic", "root_path=''", "shots=8",
            "data.batch_size=32", "train.epochs=60", "train.lr=0.003"]))
    if "k" in phases:
        runs.append(("k_image_attention_dense", counted_app("k", image_attention.run), [
            *s["search_sizes"], *s["text_clip"], f"store.root={s['text_store']}",
            f"dataset_name={ds}", "dataset=synthetic_test", f"dataset.dataset={ds}",
            "dataset.load_images=false", "dataset@cache.dataset=synthetic_train",
            f"cache.dataset.dataset={ds}", "cache.dataset.load_images=false",
            f"data.features_key={ds}_test-{tag}", f"cache.features_key={ds}_train-{tag}",
            f"cache.outs_key={s['search_outs']}", "cache_value_strategy=hard_cache",
            "cache_weights_strategy._target_=chip_smoke.tip_formula_weights",
            "run_saves.save_logits=true", "run_saves.save_cache_inds=true",
            "run_saves.save_preds=true"]))

    # record every HotFlip loss and every FluentPrompt projection as they happen
    trainer_cls = train_autoprompt.PromptTrainer
    real_loss, real_project = trainer_cls.loss_value, fluentprompt.FluentPromptState.project

    def loss_value(self, prompt_embs, prompt_ids, batch):
        value = real_loss(self, prompt_embs, prompt_ids, batch)
        out["losses"].append((np.array(prompt_embs, np.float32), list(prompt_ids), batch, value))
        return value

    def project(self):
        ids = real_project(self)
        embs = self.params["prompt_embs"].detach()
        out["projections"].append(bool(torch.equal(embs, self.clip_embs[torch.as_tensor(
            ids, device=embs.device)])))
        return ids

    sys.modules.setdefault("chip_smoke", sys.modules[__name__])   # the (k) strategy's _target_
    trainer_cls.loss_value, fluentprompt.FluentPromptState.project = loss_value, project
    try:
        out["times_s"] = run_apps(runs, work)
    finally:
        trainer_cls.loss_value, fluentprompt.FluentPromptState.project = real_loss, real_project
    return out


def check_prompt_search(out: dict) -> None:
    """The gates of the prompt_search path, after its counted run: exact
    launch counts of each app, then (g) every HotFlip loss against the route
    that launches no kernel and the heap written, (h) the prompt on vocabulary
    rows after every step, (i) one batch's loss and proposer gradients
    against the plain route and a route with an f32 text tower, (j) W against
    the CPU's training and CE falling, (k) the dense route against its plain
    f32 function and the kernel route's records."""
    import numpy as np
    import torch
    import yaml

    s, work, phases, launches = out["sizes"], out["work"], out["phases"], out["launches"]
    log(f"prompt_search launches by app: {json.dumps(launches)}")
    want = {}
    if "g" in phases:   # a step: one gradient forward, search_steps x (1 + num_cands) losses
        steps = (s["n_train"] // s["ap_batch"]) // 2
        forwards = steps * (1 + 2 * (1 + 10)) + 1          # + the metric pass
        want["g"] = {"K5 fused_ln_attn": s["text_layers"] * forwards,
                     "K6 fused_ln_mlp": s["text_layers"] * forwards}
    if "h" in phases:
        forwards = s["n_train"] // s["fluent_batch"] + 1
        want["h"] = {"K5 fused_ln_attn": s["text_layers"] * forwards,
                     "K6 fused_ln_mlp": s["text_layers"] * forwards}
    if "i" in phases:   # synthetic: 32 train rows in batches of 8, then the train accuracy pass
        want["i"] = {"K4 short_attention_packed": s["gpt_layers"] * 4,
                     "K5 fused_ln_attn": s["gumbel_layers"] * 5,
                     "K6 fused_ln_mlp": s["gumbel_layers"] * 5}
    if "j" in phases:   # two image batches (32 train, 16 test rows), one text batch (4 classes)
        n = 2 * s["prolip_layers"][0] + s["prolip_layers"][1]
        want["j"] = {"K5 fused_ln_attn": n, "K6 fused_ln_mlp": n}
    if "k" in phases:   # the zero-shot classifier: 1000 (or 4) prompts in chunks of 256
        n = s["text_layers"] * -(-(1000 if s["text_ds"] == "synthetic_1k" else 4) // 256)
        want["k"] = {"K5 fused_ln_attn": n, "K6 fused_ln_mlp": n, "K3 onehot_grouped": 0,
                     "K2 labels_dense": 0, "K1 cache_dense": 0}
    for app, counts in want.items():
        for k, n in counts.items():
            if launches[app].get(k, 0) != n:
                raise AssertionError(f"prompt_search ({app}): {k} launched "
                                     f"{launches[app].get(k, 0)} times, expected {n}")

    if "g" in phases:
        t0 = time.perf_counter()
        trainer = out["trainers"]["g"]
        rel = [abs(v - p) / abs(p) for v, p in (
            (value, plain_route(lambda: trainer.loss_value(embs, ids, batch)))
            for embs, ids, batch, value in out["losses"])]
        steps = (s["n_train"] // s["ap_batch"]) // 2
        heap = yaml.safe_load(next((work / "g_train_autoprompt").rglob(
            "epoch_1/step_final/prompts.yaml")).read_text())
        log(f"prompt_search (g): {steps} HotFlip steps, {len(rel)} losses (each step's current "
            f"prompt and its 10 candidates on 2 batches) vs the plain route: max relative "
            f"difference {max(rel):.3e} (tol {TOL_SEARCH_LOSS_REL}), {time.perf_counter() - t0:.2f}"
            f" s; final prompt {trainer.state.prompt_ids}, heap of {len(heap)}, best loss "
            f"{heap[0]['loss']:.4f}")
        if len(rel) != steps * 2 * 11 or max(rel) > TOL_SEARCH_LOSS_REL:
            raise AssertionError("prompt_search (g): the HotFlip losses disagree with the plain "
                                 "route (or were not all recorded)")
        if not heap or not all(np.isfinite(r["loss"]) and len(r["prompt_ids"]) == 8 for r in heap):
            raise AssertionError("prompt_search (g): the yaml heap is missing or malformed")
    if "h" in phases:
        trainer = out["trainers"]["h"]
        epoch = _epoch_record(work / "h_train_fluentprompt", "loss/train")
        steps = s["n_train"] // s["fluent_batch"]
        log(f"prompt_search (h): {len(out['projections'])} SGLD steps, the prompt on vocabulary "
            f"rows after each: {out['projections']}, loss/train {epoch['loss/train']:.4f}, final "
            f"prompt {trainer.state.prompt_ids}")
        if out["projections"] != [True] * steps or not np.isfinite(epoch["loss/train"]):
            raise AssertionError("prompt_search (h): a step left the prompt off the vocabulary "
                                 "rows, or the loss is not finite")
    if "i" in phases:
        check_gumbel_v3a1(out["trainers"]["i"], s)
    if "j" in phases:
        check_prolip(out["trainers"]["j"], work / "j_train_prolip")
    if "k" in phases:
        check_dense_route(work / "k_image_attention_dense", s)


def check_gumbel_v3a1(trainer, s: dict) -> None:
    """(i) One batch through the kernel route, the route that launches no
    kernel, and that route with the text tower in f32, the loss's two terms
    apart. The kernel route's forward launches K4 once a layer of the fluency
    LM and K5 and K6 once a layer of the text tower, its ``backward`` none.
    The fluency term's loss and proposer gradient (an f32 ClipGPT: K4 against
    the plain attention) lie within ``TOL_FLUENCY_REL`` of the plain route's.
    The CLIP term crosses the bf16 text tower: its text features F and its
    proposer gradient lie no farther from the f32 route's than
    ``TOL_F32_RATIO`` times the plain route's do, and its loss, an f32
    function of F, differs from the plain route's by the first-order change
    that F's difference makes, within ``TOL_LOSS_SECOND_ORDER``. Each route's
    loss distance from the f32 route's is logged beside its first-order
    prediction: a projection of F's error, it swings both ways while F's
    distances hold. Every gradient is finite and non-zero. Also logged: the share of
    F's elements on which the two bf16 routes agree bit for bit, and whether
    the kernel route gives the same bits when run again."""
    import copy

    import torch
    import torch.nn.functional as F

    counters = launch_counters()
    counts = lambda: {k: f.launches for k, f in counters.items()}   # noqa: E731
    idx = torch.from_numpy(trainer.train_indices[:8]).to(trainer.device)
    labels = torch.from_numpy(trainer.labels).to(trainer.device)[idx]
    feats = trainer.image_features[idx]
    lm_idx = trainer.labels[trainer.train_indices[:8]]
    start = {k: v.detach().clone() for k, v in trainer.prompt_params.items()}

    def step():
        params = {k: v.clone().requires_grad_() for k, v in start.items()}
        leaves = [params[k] for k in sorted(params)]
        real, text = trainer.text_features_for, []
        trainer.text_features_for = lambda embs: text.append(real(embs)) or text[-1]
        before = counts()
        try:
            _, metrics = trainer.loss_fn(params, feats, labels, lm_idx, 1.0)
        finally:
            del trainer.text_features_for
        mid = counts()
        losses, grads = {}, {}
        for term in ("loss/clip", "loss/fluency"):
            g = torch.autograd.grad(metrics[term], leaves, retain_graph=term == "loss/clip")
            losses[term] = float(metrics[term].detach())
            grads[term] = torch.cat([t.flatten() for t in g]).float()
        after = counts()
        return (losses, grads, {k: mid[k] - before[k] for k in mid if mid[k] != before[k]},
                {k: after[k] - mid[k] for k in after if after[k] != mid[k]},
                text[0].detach().float())

    def f32_tower():
        model, embeds = trainer.session.model, trainer.class_embeds
        trainer.session.model = copy.deepcopy(model).to(torch.float32)
        trainer.class_embeds = embeds.float()
        try:
            return plain_route(step)
        finally:
            trainer.session.model, trainer.class_embeds = model, embeds

    def rel(a, b):
        return (float((a - b).norm() / b.norm()) if isinstance(a, torch.Tensor)
                else abs(a - b) / abs(b))

    def clip_loss(text):
        logits = trainer.logit_scale * feats.float() @ F.normalize(text, dim=-1).t()
        return F.cross_entropy(logits, labels)

    kern, plain, f32 = step(), plain_route(step), f32_tower()
    again = step()
    # dL/dF on the plain route's features: the loss's first-order change is <dL/dF, dF>
    text = plain[4].clone().requires_grad_()
    g_text, = torch.autograd.grad(clip_loss(text), text)
    d_kp = kern[4] - plain[4]
    loss_kp = kern[0]["loss/clip"] - plain[0]["loss/clip"]
    loss_first = float((g_text * d_kp).sum())
    loss_bound = (TOL_LOSS_SECOND_ORDER * float(g_text.norm() * d_kp.norm())
                  + 4 * F32_UNIT * abs(plain[0]["loss/clip"]))
    rd = {}
    for i, what in ((0, "loss"), (1, "grad")):
        rd[f"fluency_{what}_rel"] = rel(kern[i]["loss/fluency"], plain[i]["loss/fluency"])
        for name, route in (("kernels", kern), ("plain", plain)):
            rd[f"clip_{what}_{name}_vs_f32"] = rel(route[i]["loss/clip"], f32[i]["loss/clip"])
    for name, route in (("kernels", kern), ("plain", plain)):
        rd[f"text_{name}_vs_f32"] = rel(route[4], f32[4])
        # the first-order prediction of the loss's distance from the f32 route's
        rd[f"clip_loss_{name}_vs_f32_first_order"] = abs(
            float((g_text * (route[4] - f32[4])).sum())) / abs(f32[0]["loss/clip"])
    rd["clip_grad_kernels_vs_plain"] = rel(kern[1]["loss/clip"], plain[1]["loss/clip"])
    rd["text_kernels_vs_plain"] = rel(kern[4], plain[4])
    same_bits = float((kern[4] == plain[4]).float().mean())
    repeat = (again[0] == kern[0] and torch.equal(again[4], kern[4])
              and all(torch.equal(again[1][t], kern[1][t]) for t in kern[1]))
    want = {"K4 short_attention_packed": s["gpt_layers"], "K5 fused_ln_attn": s["gumbel_layers"],
            "K6 fused_ln_mlp": s["gumbel_layers"]}
    log(f"prompt_search (i): Gumbelv3a1 (adapter head on the fluency LM, 8 positions) one batch "
        f"of 8: losses {plain[0]} (kernels {kern[0]}, f32 tower {f32[0]}), |g| clip "
        f"{float(plain[1]['loss/clip'].norm()):.4e} fluency "
        f"{float(plain[1]['loss/fluency'].norm()):.4e} over {plain[1]['loss/clip'].numel()} "
        f"proposer parameters; " + ", ".join(f"{k} {v:.4e}" for k, v in rd.items())
        + f"; clip loss kernels - plain {loss_kp:+.4e}, its first-order change "
        f"<dL/dF, F_k - F_p> {loss_first:+.4e}, the rest {abs(loss_kp - loss_first):.4e} (limit "
        f"{loss_bound:.4e}); text features equal bit for bit on {same_bits:.4f} "
        f"of {kern[4].numel()} elements; kernel route run again gives the same bits: {repeat} "
        f"(limits: fluency <= {TOL_FLUENCY_REL}; text and clip gradient kernels vs f32 <= "
        f"{TOL_F32_RATIO} x plain vs f32); forward launches {kern[2]} (expected {want}), plain "
        f"{plain[2]}, f32 {f32[2]}")
    if kern[2] != want or kern[3] or plain[3] or plain[2] or f32[2] or f32[3]:
        raise AssertionError(f"(i): forward launches {kern[2]} (expected {want}), backward "
                             f"{kern[3]} / {plain[3]} / {f32[3]}, plain forwards {plain[2]} / "
                             f"{f32[2]}")
    for g in (*kern[1].values(), *plain[1].values()):
        if not (torch.isfinite(g).all() and float(g.norm()) > 0):
            raise AssertionError("(i): a proposer gradient is zero or not finite")
    if (max(rd["fluency_loss_rel"], rd["fluency_grad_rel"]) > TOL_FLUENCY_REL
            or rd["text_kernels_vs_f32"] > TOL_F32_RATIO * rd["text_plain_vs_f32"]
            or rd["clip_grad_kernels_vs_f32"] > TOL_F32_RATIO * rd["clip_grad_plain_vs_f32"]
            or abs(loss_kp - loss_first) > loss_bound):
        raise AssertionError("(i): the kernel route's loss or gradient disagrees with plain")


def check_prolip(trainer, run_root: Path) -> None:
    """(j) W trained on the card against ``train_projection`` on the CPU from
    the same pre-projection features; CE falls."""
    import numpy as np

    from summer_clip_torch.methods import prolip

    t0 = time.perf_counter()
    w_card = np.load(next(run_root.rglob("prolip_proj.npy")))
    tcfg = trainer.cfg.train
    w_cpu = prolip.train_projection(
        trainer.train_pre, trainer.train_labels, trainer.classifier, trainer.W0,
        epochs=int(tcfg.epochs), lr=float(tcfg.lr),
        weight_decay_to_init=float(tcfg.weight_decay_to_init), scale=float(tcfg.scale),
        device="cpu")
    rel = float(np.linalg.norm(w_card - w_cpu) / np.linalg.norm(w_cpu - trainer.W0))
    ce = [r["ce"] for r in records(run_root, "prolip_train")]
    res, = records(run_root, "prolip_result")
    log(f"prompt_search (j): ProLIP W on the card vs the CPU's training: |dW| / |W - W0| "
        f"{rel:.3e} (tol {TOL_PROLIP_W_REL}), |W - W0| {np.linalg.norm(w_cpu - trainer.W0):.4e}; "
        f"CE {ce[0]:.4f} -> {ce[-1]:.4f}; train acc1 {res['acc1_train_zero_shot']:.2f} -> "
        f"{res['acc1_train']:.2f}, test acc1 {res['acc1_zero_shot']:.2f} -> {res['acc1']:.2f}; "
        f"{time.perf_counter() - t0:.2f} s")
    if not rel <= TOL_PROLIP_W_REL or not ce[-1] < ce[0]:
        raise AssertionError("(j): ProLIP's W disagrees with the CPU's, or CE did not fall")


def check_dense_route(run_root: Path, s: dict) -> None:
    """(k) The dense route (a weights strategy the kernels do not know): its
    saved predictions against the plain f32 function rebuilt from the stored
    arrays (``check_search_predictions``), and its records against the kernel
    route's at the same selection, beta and alpha: the same combinations, the
    accuracies within 100 (1 - ``TOL_PRED_AGREE``) points, and record by
    record the share of test rows with the same prediction. The kernel route
    rounds its affinities to bf16 and the dense route does not, which flips
    near-tied rows; the witness is the plain function itself rebuilt in bf16
    against the plain f32 rebuild on the same arrays and selection. The dense
    route sits within 1 - ``TOL_PRED_AGREE`` of the f32 rebuild (gated here)
    and the kernel route within as much of the bf16 rebuild (the clip_search
    gate), so a record's rows must agree at least as often as the witness's
    less twice that."""
    import numpy as np

    def by_combo(root):
        rec_file, = root.rglob("records.jsonl")
        out = {}
        for r in map(json.loads, rec_file.read_text().splitlines()):
            if r.get("type") == "searcher_result":
                key = json.dumps([r["cache_strategy"], r["cache_value_strategy"],
                                  r["cache_weights_strategy"]["beta"], r["alpha"]],
                                 sort_keys=True)
                out[key] = (r, rec_file.parent)
        return out

    t0 = time.perf_counter()
    held = check_search_predictions(run_root, s["text_store"], s["text_ds"], s["text_tag"],
                                    s["search_outs"], compute_dtype="float32",
                                    witness_dtype="bfloat16")
    dense, kern = by_combo(run_root), by_combo(s["search_dir"])
    if not dense or dense.keys() != kern.keys() or held["records"] != len(dense):
        raise AssertionError(f"(k): {len(dense)} dense records against {len(kern)} kernel-route "
                             f"records, or other combinations")
    margin = 2.0 * (1.0 - TOL_PRED_AGREE)
    agree, dacc, slack, short = 1.0, 0.0, 1.0, []
    for (key, (r, d)), witness in zip(dense.items(), held["witness"]):
        k, kd = kern[key]
        got, want = np.load(d / r["preds_path"]), np.load(kd / k["preds_path"])
        rows = float((got == want).mean())
        agree = min(agree, rows)
        slack = min(slack, rows - (witness - margin))
        if rows < witness - margin:
            short.append((key, rows, witness))
        dacc = max(dacc, abs(r["acc1"] - k["acc1"]), abs(r["acc5"] - k["acc5"]))
    limit = 100.0 * (1.0 - TOL_PRED_AGREE)
    log(f"prompt_search (k): {len(dense)} records of the dense route: saved predictions vs the "
        f"plain f32 function on the stored arrays, least agreement {held['agree_min']:.4f} (tol >= "
        f"{TOL_PRED_AGREE}); witness, the plain function in bf16 vs in f32 on the same arrays "
        f"and selections: rows agreeing {min(held['witness']):.4f} to "
        f"{max(held['witness']):.4f} a record; dense vs the kernel route's records: max |d acc| "
        f"{dacc:.3f} points (tol {limit:.1f}), rows agreeing at least {agree:.4f}, each record "
        f"at least its witness less {margin:.2f} (least slack {slack:.4f}); "
        f"{time.perf_counter() - t0:.2f} s")
    if held["agree_min"] < TOL_PRED_AGREE or dacc > limit or short:
        raise AssertionError(f"(k): the dense route disagrees with its plain version or with the "
                             f"kernel route's records ({len(short)} records short of the witness, "
                             f"first {short[:1]})")


def run_small_prompt_search(work: Path, phases: str = "ghijk") -> None:
    """The prompt_search path's gates at test size on the card (the ``cuda``
    tests): a ViT-B/16-width CLIP cut to 2 blocks a tower on ``synthetic``
    (4 classes), a 256-wide 2-block ClipGPT; its own store, kernel-route
    CLIP-search run and checkpoint first."""
    import dataclasses

    from summer_clip_torch.apps import gen_gpt, image_attention, save_features, save_image_outs
    from summer_clip_torch.models.clip.configs import CLIP_CONFIGS
    from summer_clip_torch.models.tokenizer import get_tokenizer

    name = "cut-ViT-B/16"
    CLIP_CONFIGS[name] = dataclasses.replace(CLIP_CONFIGS["ViT-B/16"], name=name,
                                             vision_layers=2, text_layers=2)
    tag, store = "cut-ViT-B16", work / "features"
    clip = ["clip=vit_b16", f"clip.model_name={name}"]
    common = [*clip, f"store.root={store}", "dataset_name=synthetic"]
    sizes = [f"cache_strategies.{n}.topk=[2,16]" for n in SEARCH_STRATEGIES]
    run_apps([
        ("save_features", save_features.run, common + [
            "dataset@train_dataset=synthetic_train", "dataset@test_dataset=synthetic_test",
            "save_train_outs=false"]),
        ("save_image_outs", save_image_outs.run, common + [
            "dataset=synthetic_train", "dataset.load_images=false",
            f"data.features_key=synthetic_train-{tag}",
            f"data.output_key=synthetic_train_outs-{tag}"]),
        ("search", image_attention.run, common + [
            *sizes, "dataset=synthetic_test", "dataset.load_images=false",
            "dataset@cache.dataset=synthetic_train", "cache.dataset.load_images=false",
            f"data.features_key=synthetic_test-{tag}", f"cache.features_key=synthetic_train-{tag}",
            f"cache.outs_key=synthetic_train_outs-{tag}", "cache_value_strategy=hard_cache",
            "run_saves.save_preds=true"]),
    ], work)
    cfg = {"gpt_config": "test-gpt-mega", "clip_emb_dim": 512,
           "adapters": {"emb_hid_dim": 256, "head_hid_dim": 256}}
    model = gen_gpt.build_clip_gpt(cfg, get_tokenizer().vocab_size, 0)
    ckpt = gen_gpt.save_clip_gpt_checkpoint(work / "gpt", model, cfg, 0, step=0)
    s = dict(text_clip=clip, text_layers=2, text_store=store, text_ds="synthetic", text_tag=tag,
             k_shots=-1, n_train=32, ap_batch=8, fluent_batch=8, gumbel_clip=clip, gumbel_layers=2,
             gumbel_store=store, gumbel_tag=tag, gpt_ckpt=ckpt, gpt_layers=2,
             prolip_clip=clip, prolip_layers=(2, 2), search_dir=work / "search",
             search_outs=f"synthetic_train_outs-{tag}", search_sizes=sizes)
    counters = launch_counters()
    out = run_prompt_search(work / "prompt_search", s,
                            lambda: {k: f.launches for k, f in counters.items()}, phases)
    check_prompt_search(out)


# --------------------------------------------------------------------------- #
# train_gpt: ClipGPT training at gpt2-large; int8_towers: clip.quant=int8
# --------------------------------------------------------------------------- #
TRAIN_GPT_PATH = ("K4 short_attention_packed",)
INT8_PATH = ("K4 short_attention_packed",)
TRAIN_GPT_BATCH, TRAIN_GPT_T = 32, 80        # conf/train_gpt.yaml's batch, tokenize_dataset's length
TRAIN_GPT_ACCUM = 2        # conf/train_gpt.yaml's 16, cut so that 5 micro-steps make 2 updates
TRAIN_GPT_MICRO = 5        # an odd count: the step checkpoint's accumulator holds a gradient
TRAIN_GPT_DOCS, TRAIN_GPT_SUBPART = 64, 0.66  # 244 chunks of 80 tokens, 161 of them: 5 batches
TRAIN_GPT_VAL_DOCS = 12
# the first micro-step's loss and every leaf's gradient norm, kernel route (K4
# forward, bf16) against the route that launches no kernel on the same
# weights and batch; each route's distance to an f32 route of the same weights
# may reach TOL_LM_F32_RATIO times the plain route's (or the limit itself)
TOL_LM_LOSS_REL = 1e-3
TOL_LM_NORM_REL = 2e-2
TOL_LM_F32_RATIO = 1.5
# the adapters' change over the run's two updates, kernel route against plain
TOL_ADAPTER_COS = 0.99
# int8 towers: min cosine of the int8 features to the bf16 tower's at B = 32,
# and the planted fault each tower's reading must fall below: ViT-B/16 reads
# 0.99952, 0.99843 with its fault; RN50 0.99978, 0.99423 with its fault
TOL_INT8_COS = 0.999
INT8_FAULTS = {"ViT-B/16": ("block 5 c_fc hidden 0..63 zeroed",
                            lambda m: m.visual.transformer.resblocks[5].mlp.c_fc.weight[:64]),
               "RN50": ("layer3.0 conv2 output channels 0..31 zeroed",
                        lambda m: m.visual.layer3[0].conv2.weight[:32])}


def train_gpt_k4_launches(micro_steps: int, eval_batches: int, n_layer: int = 36,
                          remat: bool = True) -> int:
    """K4's launches in a train_gpt run: one a block and forward, a second one
    a block when remat recomputes the forward in the backward (eval runs
    without grad, so once)."""
    return n_layer * ((2 if remat else 1) * micro_steps + eval_batches)


def train_gpt_argv(work: Path, corpus: Path, val: Path) -> list:
    return ["clip_gpt.gpt_config=gpt2-large", "clip_gpt.clip_emb_dim=512",
            "clip_gpt.adapters.emb_hid_dim=1024", "clip_gpt.adapters.head_hid_dim=1024",
            f"dataset.train.tokens_path={corpus}", f"dataset.train.subpart={TRAIN_GPT_SUBPART}",
            f"dataset.val.tokens_path={val}",
            f"data_loader.train.batch_size={TRAIN_GPT_BATCH}",
            f"data_loader.val.batch_size={TRAIN_GPT_BATCH}", "training.epochs_num=1",
            f"training.grad_accum_steps={TRAIN_GPT_ACCUM}", "training.evals_per_epoch=1",
            "training.info_steps=1", "training.bf16=true", "training.remat=true",
            f"training.checkpoints_dir={work / 'ckpt'}"]


def run_train_gpt(work: Path) -> dict:
    """The seventh main path, ``train_gpt`` (module docstring, step 4):
    tokenize_dataset twice (train and val corpora), then train_gpt at
    gpt2-large full width. Returns the times and the trainer."""
    from summer_clip_torch.apps import tokenize_dataset, train_gpt

    corpus, val = work / "corpus.npy", work / "val.npy"
    argv = train_gpt_argv(work, corpus, val)
    captured = {}
    real_run_trainer = train_gpt.run_trainer

    def capture(cls, cfg):
        captured.setdefault("trainer", real_run_trainer(cls, cfg))
        return captured["trainer"]

    train_gpt.run_trainer = capture
    try:
        times = run_apps([
            ("tokenize_train", tokenize_dataset.run,
             [f"max_length={TRAIN_GPT_T}", f"source.n_docs={TRAIN_GPT_DOCS}",
              f"output_path={corpus}"]),
            ("tokenize_val", tokenize_dataset.run,
             [f"max_length={TRAIN_GPT_T}", f"source.n_docs={TRAIN_GPT_VAL_DOCS}",
              f"output_path={val}"]),
            ("train_gpt", train_gpt.run, argv)], work)
    finally:
        train_gpt.run_trainer = real_run_trainer
    return {"times_s": times, "trainer": captured["trainer"], "argv": argv, "work": work}


def _lm_step(trainer, ids, model=None) -> tuple:
    """Loss and the global norm of every leaf's gradient of one micro-step
    (the optimizer untouched); the gradients are cleared after."""
    import torch

    from summer_clip_torch.apps.train_gpt import lm_loss_fn

    model = model or trainer.model
    loss = lm_loss_fn(model(ids)["logits"], ids)
    loss.backward()
    params = list(model.parameters())
    norm = float(torch.sqrt(sum((p.grad.float() ** 2).sum() for p in params)))
    for p in params:
        p.grad = None
    return float(loss.detach()), norm


def _adapters(model) -> dict:
    return {n: p.detach().clone() for n, p in model.named_parameters() if n.startswith("adapter_")}


def check_train_gpt(out: dict, launches: dict) -> None:
    """The gates of the train_gpt path (module docstring, step 4), then a
    micro-step's time, token rate, update time and peak memory with remat off,
    on, ``dots`` and on the plain route."""
    import os

    import numpy as np
    import torch

    from summer_clip_torch.apps import train_gpt
    from summer_clip_torch.apps.gen_gpt import load_pretrained_clip_gpt
    from summer_clip_torch.core import config as C
    from summer_clip_torch.models import gpt2 as G

    trainer, work = out["trainer"], out["work"]
    n_layer = trainer.model.config.n_layer
    evals = len(train_gpt.eval_starts(len(trainer.val_tokens), TRAIN_GPT_BATCH))
    micro = len(trainer.train_tokens) // TRAIN_GPT_BATCH
    want = train_gpt_k4_launches(micro, evals, n_layer)
    log(f"train_gpt gpt2-large: {micro} micro-steps of {TRAIN_GPT_BATCH} x {TRAIN_GPT_T}, "
        f"{trainer.tx.count} updates, {evals} eval batches: K4 "
        f"{launches['K4 short_attention_packed']} launches (expected {want})")
    if (micro, trainer.tx.count, trainer.tx.calls) != (TRAIN_GPT_MICRO, 2, TRAIN_GPT_MICRO):
        raise AssertionError(f"train_gpt: {micro} micro-steps, {trainer.tx.count} updates")
    if launches["K4 short_attention_packed"] != want:
        raise AssertionError(f"train_gpt: K4 launched {launches['K4 short_attention_packed']} "
                             f"times, expected {want}")

    # the step checkpoint: it rebuilds the trained tree (frozen leaves from the seed)
    t0 = time.perf_counter()
    step_dir = work / "ckpt" / "epoch_1" / f"step_{micro}"
    if not (step_dir / "optimizer.ckpt").exists():
        raise AssertionError(f"train_gpt: {step_dir} has no optimizer.ckpt")
    reloaded = dict(load_pretrained_clip_gpt(step_dir, trainer.tokenizer,
                                             device=trainer.device).named_parameters())
    for name, p in trainer.model.named_parameters():
        if not torch.equal(reloaded[name], p.detach()):
            raise AssertionError(f"train_gpt: {name} reloads through gen_gpt other than trained")
    del reloaded
    # a resume with pretrained.optimizer=true: counts, accumulator and Adam state
    cfg = C.compose(Path(train_gpt.__file__).resolve().parent.parent / "conf", "train_gpt",
                    out["argv"] + [f"pretrained.model={step_dir}", "pretrained.optimizer=true"])
    cfg.pop("hydra")
    resume_dir = work / "resume"
    resume_dir.mkdir()
    cwd = os.getcwd()
    os.chdir(resume_dir)
    try:
        resumed = train_gpt.ClipGPTTrainer(cfg)
        resumed.setup()
    finally:
        os.chdir(cwd)
    same = (resumed.tx.calls, resumed.tx.count) == (trainer.tx.calls, trainer.tx.count)
    same = same and all(torch.equal(a, b) for a, b in zip(resumed.tx._acc, trainer.tx._acc))
    for a, b in zip(resumed.tx.inner.params, trainer.tx.inner.params):
        sa, sb = resumed.tx.inner.optimizer.state[a], trainer.tx.inner.optimizer.state[b]
        same = same and torch.equal(a, b) and all(torch.equal(sa[k].cpu(), sb[k].cpu())
                                                  for k in sb)
    if not same:
        raise AssertionError("train_gpt: the resumed optimizer differs from the saved one")
    del resumed
    torch.cuda.empty_cache()
    log(f"train_gpt checkpoint: reloads through gen_gpt leaf for leaf (frozen leaves = the "
        f"seed's), resume restores {trainer.tx.calls} calls, {trainer.tx.count} updates, the "
        f"accumulator and Adam's moments bit for bit; {time.perf_counter() - t0:.2f} s")

    # the gates on the initial weights and the first micro-batch
    t0 = time.perf_counter()
    trained = _adapters(trainer.model)
    with torch.no_grad():
        trainer.model.init_weights(torch.Generator().manual_seed(trainer._init_seed))
    init = _adapters(trainer.model)
    order = np.random.default_rng((int(trainer.cfg.meta.random_state), 1)).permutation(
        len(trainer.train_tokens))
    batches = [torch.from_numpy(trainer.train_tokens[order[i * TRAIN_GPT_BATCH:
                                                          (i + 1) * TRAIN_GPT_BATCH]]
                                ).to(trainer.device)
               for i in range(micro)]
    counters = launch_counters()
    k4 = counters["K4 short_attention_packed"]
    before = k4.launches
    kern = _lm_step(trainer, batches[0])
    if k4.launches - before != 2 * n_layer:
        raise AssertionError(f"train_gpt gate: the kernel route launched K4 "
                             f"{k4.launches - before} times, expected {2 * n_layer}")
    before = k4.launches
    plain = plain_route(lambda: _lm_step(trainer, batches[0]))
    m32 = G.ClipGPT(trainer.model.config, clip_vocab_size=trainer.tokenizer.vocab_size,
                    clip_emb_dim=512, emb_hid_dim=1024, head_hid_dim=1024, dtype=torch.float32,
                    device="meta", remat=True)
    m32.load_tree(trainer.model.tree())       # the same tensors, an f32 compute dtype
    m32.requires_grad_(True)
    f32 = plain_route(lambda: _lm_step(trainer, batches[0], m32))
    del m32
    if k4.launches != before:
        raise AssertionError("train_gpt gate: the plain routes launched K4")
    loss_rel = abs(kern[0] - plain[0]) / abs(plain[0])
    norm_rel = abs(kern[1] - plain[1]) / plain[1]
    log(f"train_gpt gate, first micro-step (B={TRAIN_GPT_BATCH}, T={TRAIN_GPT_T}): loss kernel "
        f"{kern[0]:.7f} plain {plain[0]:.7f} f32 {f32[0]:.7f}; every leaf's gradient norm "
        f"kernel {kern[1]:.6e} plain {plain[1]:.6e} f32 {f32[1]:.6e}; kernel vs plain: loss "
        f"{loss_rel:.3e} (tol {TOL_LM_LOSS_REL}), norm {norm_rel:.3e} (tol {TOL_LM_NORM_REL}); "
        f"to f32: loss kernel {abs(kern[0] - f32[0]):.3e} plain {abs(plain[0] - f32[0]):.3e}, "
        f"norm kernel {abs(kern[1] - f32[1]):.3e} plain {abs(plain[1] - f32[1]):.3e}")
    if loss_rel > TOL_LM_LOSS_REL or norm_rel > TOL_LM_NORM_REL or not np.isfinite(kern).all():
        raise AssertionError("train_gpt gate: the kernel route's loss or norm disagrees with plain")
    for i, tol in ((0, TOL_LM_LOSS_REL), (1, TOL_LM_NORM_REL)):
        if abs(kern[i] - f32[i]) > max(TOL_LM_F32_RATIO * abs(plain[i] - f32[i]), tol * f32[i]):
            raise AssertionError("train_gpt gate: the kernel route is farther from f32 than plain")

    # the same five micro-steps (two updates) on the plain route from the same start
    trainer.setup_optimizer()
    plain_route(lambda: [trainer.train_step(ids) for ids in batches])
    moved = _adapters(trainer.model)
    dk = torch.cat([(trained[n] - init[n]).flatten() for n in init])
    dp = torch.cat([(moved[n] - init[n]).flatten() for n in init])
    cos = float(torch.nn.functional.cosine_similarity(dk, dp, dim=0))
    rel = float((dk - dp).norm() / dp.norm())
    log(f"train_gpt adapters after {trainer.tx.count} updates, kernel vs plain route: change "
        f"|d| {float(dk.norm()):.4e} vs {float(dp.norm()):.4e}, cosine {cos:.6f} (tol >= "
        f"{TOL_ADAPTER_COS}), relative difference {rel:.3e}; {time.perf_counter() - t0:.2f} s")
    if not cos >= TOL_ADAPTER_COS:
        raise AssertionError("train_gpt: the kernel route's adapters disagree with plain")
    time_train_gpt(trainer, batches[0])


def train_gpt_bound(cfg, vocab: int, clip_dim: int = 512, hid: int = 1024,
                    b: int = TRAIN_GPT_BATCH, t: int = TRAIN_GPT_T, remat: bool = True) -> dict:
    """A micro-step's least time: the block and adapter products in bf16 (a
    forward, twice that for the gradients of every leaf, and the forward again
    under remat), the head's three products in f32; bytes: the f32 leaves read
    and their gradients written once."""
    d, n = cfg.n_embd, cfg.n_layer
    tokens = b * t
    blocks = tokens * n * (24 * d * d + 2 * t * d)         # causal: half of 4 t d
    adapters = 2 * vocab * (clip_dim * hid + hid * d) + 2 * tokens * (clip_dim * hid + hid * d)
    head = 2 * tokens * d * vocab
    bf16 = 3 * (blocks + adapters) + (blocks if remat else 0)
    params = 12 * d * d * n + vocab * clip_dim + 2 * (clip_dim * hid + hid * d)
    return bound(8 * params, bf16, 3 * head)


def time_train_gpt(trainer, ids) -> None:
    """A micro-step's forward and backward (CUDA events), the optimizer's
    accumulate and update calls, tokens/s and peak memory above what is
    resident, with remat off, on, ``dots`` and on the plain route."""
    import numpy as np
    import torch

    from summer_clip_torch.apps.train_gpt import lm_loss_fn

    model, tx = trainer.model, trainer.tx
    bound_ms = train_gpt_bound(model.config, trainer.tokenizer.vocab_size)["bound_ms"]
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]

    def micro():
        updating = (tx.calls + 1) % tx.every == 0
        ev[0].record()
        loss = lm_loss_fn(model(ids)["logits"], ids)
        ev[1].record()
        loss.backward()
        ev[2].record()
        tx.step()
        ev[3].record()
        tx.zero_grad()
        torch.cuda.synchronize()
        return [ev[i].elapsed_time(ev[i + 1]) for i in range(3)] + [updating]

    for name, remat, policy, route in (("remat off", False, None, "kernels"),
                                       ("remat on", True, None, "kernels"),
                                       ("remat dots", True, "dots", "kernels"),
                                       ("remat on", True, None, "plain")):
        model.core.remat, model.core.remat_policy = remat, policy
        run = micro if route == "kernels" else (lambda: plain_route(micro))
        run()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        times = [run() for _ in range(4)]           # two accumulate calls, two updates
        peak = torch.cuda.max_memory_allocated() - base
        fwd, bwd = (float(np.median([t[i] for t in times])) for i in (0, 1))
        acc = float(np.median([t[2] for t in times if not t[3]]))
        upd = float(np.median([t[2] for t in times if t[3]]))
        step = fwd + bwd
        log(f"train_gpt micro-step gpt2-large B={TRAIN_GPT_BATCH} T={TRAIN_GPT_T} bf16, {name}, "
            f"{route} route: forward {fwd:.2f} ms, backward {bwd:.2f} ms, micro-step {step:.2f} "
            f"ms ({TRAIN_GPT_BATCH * TRAIN_GPT_T / step * 1e3:.0f} tokens/s; bound "
            f"{bound_ms:.2f} ms), accumulate {acc:.2f} ms, update {upd:.2f} ms, peak "
            f"{peak / 2 ** 30:.3f} GiB above the resident {base / 2 ** 30:.3f} GiB")
    model.core.remat, model.core.remat_policy = True, None


def run_int8_towers(work: Path) -> dict:
    """The eighth main path, ``int8_towers``: save_features with
    ``clip.quant=int8`` at ViT-B/16 and RN50 on ``synthetic`` (images only)."""
    store = work / "features"
    from summer_clip_torch.apps import save_features

    common = ["clip.quant=int8", "dataset_name=synthetic", "dataset@train_dataset=synthetic_train",
              "dataset@test_dataset=synthetic_test", "data.batch_size=32",
              f"store.root={store}", "save_train_outs=false"]
    times = run_apps([(f"save_features_int8_{clip}", save_features.run, [f"clip={clip}", *common])
                      for clip in ("vit_b16", "rn50")], work)
    return {"times_s": times, "store": store}


def check_int8_towers(out: dict, launches: dict) -> None:
    """K4's count (12 a ViT-B/16 image batch, none on RN50), the stored
    features, one layer's int32 sums against the CPU's on the same q, the int8
    towers against the bf16 towers (and a planted fault's reading), img/s."""
    import numpy as np
    import torch

    from summer_clip_torch.models.clip import build_clip
    from summer_clip_torch.ops import int8
    from summer_clip_torch.store import FeatureStore

    batches = -(-32 // 32) + -(-16 // 32)          # synthetic: 32 train and 16 test images
    if launches["K4 short_attention_packed"] != 12 * batches:
        raise AssertionError(f"int8_towers: K4 launched {launches['K4 short_attention_packed']} "
                             f"times, expected 12 x {batches}")
    fs = FeatureStore(out["store"])
    for tag, dim in (("ViT-B16", 512), ("RN50", 1024)):
        for split, n in (("train", 32), ("test", 16)):
            feats = fs.load(f"synthetic_{split}-{tag}", "features")
            if feats.shape != (n, dim) or not np.isfinite(feats).all():
                raise AssertionError(f"int8_towers: stored {tag} {split} features {feats.shape}")
    gen = torch.Generator().manual_seed(3)
    for name in ("ViT-B/16", "RN50"):
        q, cfg = build_clip(name, torch.Generator().manual_seed(0), dtype=torch.bfloat16,
                            quant="int8")
        ref, _ = build_clip(name, torch.Generator().manual_seed(0), dtype=torch.bfloat16)
        r = cfg.image_resolution
        images = _randn((32, r, r, 3), gen, dtype=torch.float32)
        with torch.no_grad():
            # one layer's int32 sums on the card against the CPU's from the same q
            if name == "ViT-B/16":
                blk = q.visual.transformer.resblocks[0]
                seen = []
                hook = blk.register_forward_pre_hook(lambda m, a: seen.append(a[0]))
                q.encode_image(images)
                hook.remove()
                u = blk.ln_1(seen[0]).reshape(-1, cfg.vision_width)
                x8, xs = int8.quantize_rows(u)
                w8, ws = int8.quantize_cols(blk.attn.in_proj_weight.t())
                sums = int8.int8_sums(x8, w8)
                x8c, xsc = int8.quantize_rows(u.cpu())
                same = (torch.equal(x8c, x8.cpu()) and torch.equal(xsc, xs.cpu())
                        and torch.equal(int8.int8_sums(x8c, w8.cpu()), sums.cpu()))
                what = f"block 0 q/k/v sums ({u.shape[0]} x {u.shape[1]} @ {tuple(w8.shape)})"
            else:
                x = images.to(torch.bfloat16).permute(0, 3, 1, 2)
                w = q.visual.conv1.weight
                got = int8.int8_conv2d(x, w, 2, 1)
                same = torch.equal(got.cpu(), int8.int8_conv2d(x.cpu(), w.cpu(), 2, 1))
                what = f"stem conv (K = 27 padded to 32, {tuple(got.shape)})"
            if not same:
                raise AssertionError(f"int8_towers {name}: {what} differ from the CPU's")
            got, want = q.encode_image(images).float(), ref.encode_image(images).float()
            cos = float(torch.nn.functional.cosine_similarity(got, want, dim=-1).min())
            fault_what, fault_view = INT8_FAULTS[name]
            weight = fault_view(q)
            saved = weight.clone()
            weight.zero_()
            fault = q.encode_image(images).float()
            weight.copy_(saved)
            fault_cos = float(torch.nn.functional.cosine_similarity(fault, want, dim=-1).min())
            ms_q = cuda_time_ms(lambda: q.encode_image(images), 10, 2)
            ms_b = cuda_time_ms(lambda: ref.encode_image(images), 10, 2)
        tol = TOL_INT8_COS
        log(f"int8_towers {name} B=32: {what} equal to the CPU's bit for bit; int8 vs bf16 "
            f"features min cosine {cos:.6f} (tol >= {tol}), planted fault ({fault_what}) "
            f"{fault_cos:.6f}; int8 {ms_q:.3f} ms ({32 / ms_q * 1e3:.1f} img/s), bf16 "
            f"{ms_b:.3f} ms ({32 / ms_b * 1e3:.1f} img/s)")
        if not (torch.isfinite(got).all() and cos >= tol):
            raise AssertionError(f"int8_towers {name}: int8 features disagree with bf16")
        if fault_cos >= tol:
            raise AssertionError(f"int8_towers {name}: the limit does not catch the planted fault")
        del q, ref
        torch.cuda.empty_cache()


# --------------------------------------------------------------------------- #
# sandbox: the JAX package's checkpoints read at scale, then the sandbox CLIs
# --------------------------------------------------------------------------- #
SANDBOX_PATH = ("K4 short_attention_packed",)
SANDBOX_MODEL = "gpt2-large"
SANDBOX_PROMPT = "the anomalous token"
SANDBOX_NEW_TOKENS = 20
SANDBOX_EPOCHS, SANDBOX_CHECK = 4, 2          # backwards_main's --epochs and --w_freq
SANDBOX_BATCH, SANDBOX_INPUT_LEN = 8, 10      # its --batch_size and --input_len
SANDBOX_TARGET = 262                          # --target: one token, so out_len = 1
CHUNKED_LEAF_BYTES = int(1.1 * 2 ** 30)       # above flax's MAX_CHUNK_SIZE of 2^30 bytes
TRIGGER_TEMPLATE = "[T] [T] [T] {sentence} [P]"
TRIGGER_LABELS = {"0": "bad", "1": "good"}
TRIGGER_ROWS = {"train": 64, "dev": 32}
TRIGGER_ITERS = 2
TRIGGER_WORDS = ("the", "a", "movie", "film", "was", "is", "very", "not", "quite", "plot",
                 "acting", "story", "great", "awful", "dull", "fun", "long", "short", "and")


def sandbox_k4_launches(forwards: int, n_layer: int = 36) -> int:
    """K4's launches in ``forwards`` wide GPT-2 forwards: one a block. A
    gradient's backward launches none (the ``_ad`` wrapper recomputes the
    plain version)."""
    return n_layer * forwards


def backwards_forwards(epochs: int, checks: int, out_len: int = 1) -> int:
    """GPT-2 forwards of ``optimise_input``: each epoch's rollout (``out_len``
    steps without gradient, then the differentiable forward) and each
    check's greedy decode of the nearest tokens (the same rollout)."""
    return (epochs + checks) * (out_len + 1)


def trigger_forwards(history: tp.Sequence[dict], accumulation_steps: int = 4) -> int:
    """GPT-2 forwards of ``TriggerSearch.search``: the first dev evaluation
    (one batch of 32), then per iteration ``accumulation_steps`` gradient
    batches, as many batches scoring every candidate in one forward, and a
    dev evaluation when a candidate was accepted."""
    return 1 + sum(2 * accumulation_steps + int(h["accepted"]) for h in history[1:])


def _tree_items(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _tree_items(v, prefix + (k,))
        else:
            yield ".".join(prefix + (k,)), v


def write_trigger_data(work: Path) -> dict:
    import numpy as np

    rng = np.random.default_rng(0)
    paths = {}
    for split, n in TRIGGER_ROWS.items():
        rows = ["sentence\tlabel"]
        for _ in range(n):
            words = rng.choice(TRIGGER_WORDS, size=int(rng.integers(4, 9)))
            rows.append(f"{' '.join(words)}\t{int(rng.integers(0, 2))}")
        paths[split] = work / f"{split}.tsv"
        paths[split].write_text("\n".join(rows) + "\n")
    return paths


def trigger_argv(work: Path, tree: Path, data: dict, name: str) -> list:
    return ["--train", str(data["train"]), "--dev", str(data["dev"]),
            "--template", TRIGGER_TEMPLATE, "--label-map", json.dumps(TRIGGER_LABELS),
            "--model", SANDBOX_MODEL, "--checkpoint", str(tree),
            "--iters", str(TRIGGER_ITERS), "--filter", "--out", str(work / f"{name}.json")]


def run_sandbox(work: Path, launches_of) -> dict:
    """The tenth main path, ``sandbox`` (module docstring, step 4): (l) a
    random gpt2-large tree written as the JAX package writes it and read back,
    one leaf above flax's chunk size too; then the sandbox's CLIs on that
    file: (m) the generate CLI, (n) ``backwards_main``, (o) ``create_trigger``."""
    import torch

    from summer_clip_torch.engine import checkpoint as ckpt
    from summer_clip_torch.models import gpt2 as G
    from summer_clip_torch.sandbox import anomalous_tokens, create_trigger

    work.mkdir(parents=True, exist_ok=True)
    times, launches = {}, {}

    def phase(name, fn):
        before = launches_of()
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        times[name] = time.perf_counter() - t0
        launches[name] = {k: v - before[k] for k, v in launches_of().items() if v != before[k]}
        return result

    # (l) the reader at scale
    t0 = time.perf_counter()
    tree = G.GPT2(G.GPT2_CONFIGS[SANDBOX_MODEL]).init_weights(
        torch.Generator().manual_seed(0)).tree()
    times["draw"] = time.perf_counter() - t0
    path = work / f"{SANDBOX_MODEL}.msgpack"
    t0 = time.perf_counter()
    ckpt.save_pytree(path, tree, format="msgpack")
    times["write"] = time.perf_counter() - t0
    back = phase("read", lambda: ckpt.load_pytree(path))
    want, got = dict(_tree_items(tree)), dict(_tree_items(back))
    if set(got) != set(want) or not all(torch.equal(got[k], v) for k, v in want.items()):
        raise AssertionError("sandbox (l): the msgpack tree does not read back bit for bit")
    size = path.stat().st_size
    log(f"sandbox (l): {SANDBOX_MODEL} tree, {len(want)} leaves, {size / 1e9:.3f} GB msgpack: "
        f"written {times['write']:.2f} s, read {times['read']:.2f} s "
        f"({size / times['read'] / 1e9:.2f} GB/s, warm page cache), bit for bit; card "
        f"{card_line()}")
    del tree, back, want, got
    big_path = work / "chunked.msgpack"
    big = torch.rand(CHUNKED_LEAF_BYTES // 4, generator=torch.Generator().manual_seed(1))
    ckpt.save_pytree(big_path, {"big": big}, format="msgpack")
    with open(big_path, "rb") as f:
        chunked = b"__msgpack_chunked_array__" in f.read(64)
    read = phase("read_chunked", lambda: ckpt.load_pytree(big_path)["big"])
    if not (chunked and torch.equal(read, big)):
        raise AssertionError(f"sandbox (l): the chunked leaf (chunked: {chunked}) does not read "
                             f"back bit for bit")
    log(f"sandbox (l): one f32 leaf of {big.numel() * 4 / 2 ** 30:.3f} GiB in flax's chunks of "
        f"2^30 bytes, read {times['read_chunked']:.2f} s, bit for bit")
    del big, read
    big_path.unlink()

    # (m) the generate CLI, (n) backwards_main, (o) create_trigger
    text = phase("generate", lambda: anomalous_tokens.main([
        "-m", SANDBOX_MODEL, "-i", SANDBOX_PROMPT, "-o", str(SANDBOX_NEW_TOKENS),
        "--checkpoint", str(path)]))
    backwards = phase("backwards", lambda: anomalous_tokens.backwards_main([
        "--model_name", SANDBOX_MODEL, "--checkpoint", str(path),
        "--epochs", str(SANDBOX_EPOCHS), "--w_freq", str(SANDBOX_CHECK),
        "--batch_size", str(SANDBOX_BATCH), "--input_len", str(SANDBOX_INPUT_LEN),
        "--target", str(SANDBOX_TARGET), "--log", str(work / "backwards.jsonl")]))
    data = write_trigger_data(work)
    trigger = phase("trigger", lambda: create_trigger.main(
        trigger_argv(work, path, data, "trigger_kernel")))
    log(f"sandbox launches by phase: {json.dumps(launches)}; s by phase: "
        + json.dumps({k: round(v, 3) for k, v in times.items()}))
    return {"times_s": times, "launches": launches, "tree": path, "text": text,
            "backwards": backwards, "trigger": trigger, "data": data, "work": work}


def check_sandbox(out: dict) -> None:
    """The sandbox path's checks outside the counted run: the launches of
    each phase; the generate CLI's text against ``generate_device`` on the
    same tree; one ``optimise_input`` step's input-embedding gradient, kernel
    route against the route that launches no kernel (the f32 route: the CLI's
    GPT-2 is f32, as the JAX one), with a planted fault's readings against the
    same limits; the trigger search on the route that launches no kernel."""
    import numpy as np
    import torch

    from summer_clip_torch.apps.gen_gpt import generate_device
    from summer_clip_torch.core.device import resolve_device
    from summer_clip_torch.models.tokenizer import get_tokenizer
    from summer_clip_torch.ops import attention as at
    from summer_clip_torch.sandbox import anomalous_tokens as AT
    from summer_clip_torch.sandbox import create_trigger as CT

    launches, k4 = out["launches"], "K4 short_attention_packed"
    device = resolve_device(None)
    model, cfg = CT.load_gpt2(SANDBOX_MODEL, str(out["tree"]), 0, device)
    n_layer = cfg.n_layer
    if launches["generate"]:
        log(f"sandbox (m): the generate CLI launched {launches['generate']}")
    # (m) the CLI's greedy ids are generate_device's on the same weights
    tok = get_tokenizer()
    ix = [i % cfg.vocab_size for i in tok.encode(SANDBOX_PROMPT)]
    ids = generate_device(model, ix, max_new_tokens=SANDBOX_NEW_TOKENS, top_k=1)
    if tok.decode(ids) != out["text"] or len(ids) != len(ix) + SANDBOX_NEW_TOKENS:
        raise AssertionError("sandbox (m): the generate CLI's tokens differ from generate_device")
    log(f"sandbox (m): {len(ix)} prompt tokens + {SANDBOX_NEW_TOKENS} greedy tokens equal "
        f"generate_device's; launches {launches['generate'] or 'none'} (the f32 tree's products "
        f"are plain matmuls and the cached attention takes the plain route)")

    # (n) K4's count, then the gradient gate on one step
    want = sandbox_k4_launches(backwards_forwards(SANDBOX_EPOCHS,
                                                  SANDBOX_EPOCHS // SANDBOX_CHECK), n_layer)
    run, = out["backwards"]["runs"]
    log(f"sandbox (n): backwards_main {SANDBOX_EPOCHS} epochs, {run['num_found']} found, K4 "
        f"{launches['backwards'].get(k4, 0)} launches (expected {want})")
    if launches["backwards"].get(k4, 0) != want or run["epochs_run"] != SANDBOX_EPOCHS:
        raise AssertionError(f"sandbox (n): K4 launched {launches['backwards']}, expected {want}")
    emb = AT._l2n(model.wte.embedding.float())
    _, cents = AT.kmeans(emb, SANDBOX_BATCH * SANDBOX_INPUT_LEN, seed=0)
    x0 = cents.reshape(SANDBOX_BATCH, SANDBOX_INPUT_LEN, -1)
    target = torch.tensor([SANDBOX_TARGET], device=device)
    counter = launch_counters()[k4]
    gpt_apply = AT._gpt_apply(model)

    def step():
        x = x0.clone().requires_grad_(True)
        before = counter.launches
        total, *_ = AT.input_loss(gpt_apply, x, emb, target, out_len=1)
        fwd = counter.launches - before
        total.backward()
        return float(total.detach()), x.grad.flatten(), fwd, counter.launches - before - fwd

    def readings(a, b):
        return {"loss_rel": abs(a[0] - b[0]) / abs(b[0]),
                "grad_rel": float((a[1] - b[1]).norm() / b[1].norm()),
                "grad_cos": float(torch.nn.functional.cosine_similarity(a[1], b[1], dim=0))}

    kern, plain = step(), plain_route(step)
    if (kern[2], kern[3], plain[2] + plain[3]) != (sandbox_k4_launches(2, n_layer), 0, 0):
        raise AssertionError(f"sandbox (n) gate: K4 launched {kern[2]} + {kern[3]} (forward + "
                             f"backward) on the kernel route, {plain[2] + plain[3]} on the plain")
    gate = readings(kern, plain)
    real = at.short_attention_packed

    def keys_dropped(q, k, v, *, num_heads, causal=False):
        """K4 with the last two keys of the sequence dropped."""
        b, t, d = q.shape
        keep = t - 2

        def heads(x, n):
            return x[:, :n].reshape(b, n, num_heads, d // num_heads).transpose(1, 2)

        o = at.mha_reference(heads(q, t), heads(k, keep), heads(v, keep),
                             mask=at._causal_bias(t, keep, 0, device=q.device))
        return o.transpose(1, 2).reshape(b, t, d)

    at.short_attention_packed = keys_dropped
    try:
        fault = readings(step(), plain)
    finally:
        at.short_attention_packed = real
    fmt = lambda r: ", ".join(f"{k} {v:.4e}" for k, v in r.items())   # noqa: E731
    log(f"sandbox (n) gate: one optimise_input step ({SANDBOX_BATCH} x {SANDBOX_INPUT_LEN} "
        f"inputs, out_len 1, f32), K4 {kern[2]} launches forward (2 forwards x {n_layer}), "
        f"{kern[3]} backward; loss kernel {kern[0]:.7f} plain (f32) {plain[0]:.7f}; kernel vs "
        f"plain: {fmt(gate)}; limits loss_rel <= {TOL_GATE_LOSS}, grad_rel <= "
        f"{TOL_GATE_GRAD_REL}, grad_cos >= {TOL_GATE_GRAD_COS}; planted fault (K4 with the "
        f"last two keys dropped): {fmt(fault)}")
    if not (np.isfinite(kern[0]) and float(kern[1].norm()) > 0):
        raise AssertionError("sandbox (n) gate: the kernel route's gradient is zero or not finite")
    if (gate["loss_rel"] > TOL_GATE_LOSS or gate["grad_rel"] > TOL_GATE_GRAD_REL
            or gate["grad_cos"] < TOL_GATE_GRAD_COS):
        raise AssertionError("sandbox (n) gate: the kernel route disagrees with the plain route")
    if not (fault["loss_rel"] > TOL_GATE_LOSS or fault["grad_rel"] > TOL_GATE_GRAD_REL
            or fault["grad_cos"] < TOL_GATE_GRAD_COS):
        raise AssertionError("sandbox (n) gate: the limits do not catch the planted fault")
    del model
    torch.cuda.empty_cache()

    # (o) K4's count, then the same search on the route that launches no kernel
    kern_res = out["trigger"]
    want = sandbox_k4_launches(trigger_forwards(kern_res["history"]), n_layer)
    if launches["trigger"].get(k4, 0) != want:
        raise AssertionError(f"sandbox (o): K4 launched {launches['trigger']}, expected {want}")
    t0 = time.perf_counter()
    plain_res = plain_route(lambda: CT.main(trigger_argv(out["work"], out["tree"], out["data"],
                                                         "trigger_plain")))
    k_best, p_best = kern_res["best"], plain_res["best"]
    dev_tol = 1.0 / TRIGGER_ROWS["dev"]
    slots = [h["slot"] for h in kern_res["history"][1:]]
    log(f"sandbox (o): create_trigger {TRIGGER_ITERS} iterations, slots {slots}, K4 "
        f"{launches['trigger'].get(k4, 0)} launches (expected {want}); best trigger kernel "
        f"{k_best['trigger_ids']} dev {k_best['dev_metric']:.4f}, plain {p_best['trigger_ids']} "
        f"dev {p_best['dev_metric']:.4f} (the same trigger, or dev accuracies within "
        f"{dev_tol:.4f}: one of {TRIGGER_ROWS['dev']} rows); plain rerun "
        f"{time.perf_counter() - t0:.2f} s")
    steps = [(h["slot"], h["accepted"]) for h in kern_res["history"][1:]]
    metric = lambda h: h["train_metric"] if "train_metric" in h else h["dev_metric"]  # noqa: E731
    metrics = [(metric(a), metric(b)) for a, b in zip(kern_res["history"], plain_res["history"])]
    log("sandbox (o): metric by iteration, kernel / plain route: "
        + ", ".join(f"{a:.4f} / {b:.4f}" for a, b in metrics))
    if steps != [(h["slot"], h["accepted"]) for h in plain_res["history"][1:]]:
        raise AssertionError("sandbox (o): the two routes drew other slots or accepted others")
    if any(abs(a - b) > dev_tol for a, b in metrics):
        raise AssertionError("sandbox (o): the routes' metrics part by more than one row")
    if (k_best["trigger_ids"] != p_best["trigger_ids"]
            and abs(k_best["dev_metric"] - p_best["dev_metric"]) > dev_tol):
        raise AssertionError("sandbox (o): the kernel route's search disagrees with plain")


# ---------------------------------------------------------------------------
# (p) multi_device: the serving side of the port's multi-device layer
# ---------------------------------------------------------------------------
MULTI_PATH = ("K1 cache_dense", "K2 labels_dense", "K3 onehot_grouped", "K5 fused_ln_attn",
              "K6 fused_ln_mlp", "K7 streamed_qmatmul")
# image_attention over the CLIP-search store at world 2: the one-class Hard
# cache (K3 a rank), the scattered prototype labels (K2 a rank) and their
# Softmax values (K1 a rank); (name, outs key, value strategy)
MD_SEARCHES = (("hard_cache", f"synthetic_1k_train_outs-{SEARCH_TAG}", "hard_cache"),
               ("protos_hard_cache", f"synthetic_1k_train_protos-{SEARCH_TAG}", "hard_cache"),
               ("protos_softmax_cache", f"synthetic_1k_train_protos-{SEARCH_TAG}",
                "softmax_cache"))
MD_SELECTIONS = len(SEARCH_STRATEGIES) * 3 + 1


def md_searches(world1: bool) -> tuple:
    """The searches of a group: all three at world 2; at world 1 the two over the
    prototype labels (K2, K1), to keep the phase short."""
    return MD_SEARCHES[1:] if world1 else MD_SEARCHES
# stored rows of the data-parallel store against the one-device store
# (tests/test_parallel.py's DP tolerance); a planted fault (each batch's two
# halves gathered in the wrong order) is read against it
TOL_MD_FEATURES = 1e-4
# a world-2 search's saved predictions against the one-device run's, record by
# record: the shards' partial sums add in another order than one kernel's, so
# a near-tie row may flip (the gate of the one-device run against the plain
# version); a planted fault (rank 1's partial logits dropped) is read against it
TOL_MD_PRED_AGREE = TOL_PRED_AGREE


def tp_k7_per_token(cfg, tp_size: int, clip_emb: int = 512, hid: int = 1024,
                    vocab: int = 49408) -> int:
    """K7 launches a rank makes for one decoded token of the int8 ClipGPT at
    ``tp_size``: every product that ``qdot`` sends to K7 (tile-legal at one
    row): the emb adapter's two (replicated), each block's four on the rank's
    slices (c_attn and mlp_c_fc column slices, c_proj and mlp_c_proj row
    slices) and the hoisted int8 head table (the decode loops read it as the
    one-device route does; the decoder's own plain head serves prefill only)."""
    from summer_clip_torch.ops.gemv import _tile_legal

    d = cfg.n_embd
    shapes = [(clip_emb, hid), (hid, d)]
    shapes += cfg.n_layer * [(d, 3 * d // tp_size), (d // tp_size, d), (d, 4 * d // tp_size),
                             (4 * d // tp_size, d)]
    shapes.append((d, vocab))
    return sum(_tile_legal(k, n, 1) for k, n in shapes)


def _md_count(out: dict, name: str, fn):
    """Run ``fn`` in this rank with every launch count at 0, keep its counts
    and seconds under ``name``."""
    import torch

    counters = launch_counters()
    for f in counters.values():
        f.launches = 0
    t0 = time.perf_counter()
    value = fn()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    out["seconds"][name] = time.perf_counter() - t0
    out["launches"][name] = {k: f.launches for k, f in counters.items()}
    return value


def _md_app(work: str, name: str, fn, argv: list):
    """An app of this rank in a directory of the rank's own (rank 0's gets the
    records, the store's catalog and the results)."""
    import torch.distributed as dist

    sub = Path(work) / name / f"rank{dist.get_rank()}"
    sub.mkdir(parents=True, exist_ok=True)
    cwd = os.getcwd()
    os.chdir(sub)
    try:
        return fn(argv=argv)
    finally:
        os.chdir(cwd)


def _md_int8_model(model):
    """The int8 tree of ``model`` (its float tree dropped) and its head table."""
    from summer_clip_torch.engine.quant import quant_head_table, quantize_tree

    qmodel = model.with_tree(quantize_tree(model.tree())).eval()
    return qmodel, quant_head_table(qmodel)


def md_group_rank(work: str, search_store: str, ckpt_dir: str, world1: bool, sf_argv: list,
                  gen_argv: list) -> dict:
    """One rank of phase (p)'s groups. At world 2 first the apps inside the
    group: ``save_features`` (``sf_argv``: data parallel, each rank renders
    and encodes its half of every batch) and ``gen_gpt`` (``gen_argv``,
    ``generation.tp=2``: the int8 device loop); then image_attention over the
    CLIP-search store (and the same with rank 1's partial logits dropped), and
    tensor-parallel decode of the gen_gpt path's checkpoint, reusing the app's
    model: the engine (12 requests, 8 slots, the K7 route), the batched
    sampler, and the app's device-loop ids walked step by step through the
    decoder against the plain route, with a planted fault. At world 1 (NCCL)
    the searches over the prototype labels and the device loop through the
    decoder of one rank against the one-device sampler."""
    import torch
    import torch.distributed as dist

    from summer_clip_torch.apps import gen_gpt, image_attention, save_features
    from summer_clip_torch.engine.serving import ContinuousBatcher
    from summer_clip_torch.models.tokenizer import get_tokenizer
    from summer_clip_torch.parallel import create_mesh, sharded_cache
    from summer_clip_torch.parallel.tp_int8 import tp_int8_decoder

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"launches": {}, "seconds": {}, "rank": dist.get_rank(), "backend": dist.get_backend()}
    tok = get_tokenizer()
    if not world1:
        _md_count(out, "save_features", lambda: _md_app(work, "save_features", save_features.run,
                                                         sf_argv))
        trainer = _md_count(out, "gen_gpt tp2", lambda: _md_app(work, "gen_gpt_tp2", gen_gpt.run,
                                                                 gen_argv))
        dist.barrier()   # rank 0's results are written
        out["tp_ids"] = [g["ids"] for g in
                         _gen_results(Path(work) / "gen_gpt_tp2" / "rank0")["generations"]]
        qmodel, table = _md_count(out, "int8 model", lambda: _md_int8_model(trainer.model))
        del trainer
    else:
        qmodel, table = _md_count(out, "int8 model", lambda: _md_int8_model(
            gen_gpt.load_pretrained_clip_gpt(ckpt_dir, tok)))
    common = ["clip=vit_l14", f"store.root={search_store}"]
    with shared_towers():   # one ViT-L/14 drawn a rank, not one a search
        for name, outs_key, value in md_searches(world1):
            _md_count(out, name, lambda: _md_app(
                work, name, image_attention.run,
                common + search_argv("synthetic_1k", outs_key, value, SEARCH_SAVES)))
        if not world1:
            real = sharded_cache.all_reduce

            def dropped(x, mesh, axis="model"):   # the planted fault: rank 1 adds nothing
                if mesh.coords[axis] == 1:
                    x.zero_()
                return real(x, mesh, axis)

            sharded_cache.all_reduce = dropped
            try:
                _, outs_key, value = MD_SEARCHES[1]
                _md_count(out, "fault protos_hard_cache", lambda: _md_app(
                    work, "fault_protos_hard_cache", image_attention.run,
                    common + search_argv("synthetic_1k", outs_key, value, SEARCH_SAVES)))
            finally:
                sharded_cache.all_reduce = real

    mesh = create_mesh(data=1, model=dist.get_world_size())
    dec = tp_int8_decoder(qmodel, mesh)   # this rank's slices, cut once
    greedy = dict(max_new_tokens=GEN_NEW_TOKENS, top_k=1, quant_int8=True, eot_id=tok.eot_token)
    prompts = [[tok.sot_token] + tok.encode(p) for p in GEN_PROMPTS]
    if world1:
        solo = [gen_gpt.generate_device(qmodel, p, **greedy) for p in prompts]
        out["device"] = _md_count(out, "device", lambda: [
            gen_gpt.generate_device(dec, p, mesh=mesh, **greedy) for p in prompts])
        diffs = []
        for seq, p in zip(out["device"], prompts):
            # the decoder's step-by-step logits against the one-device model's
            walks = [_md_walk(m, table, seq, len(p)) for m in (dec, qmodel)]
            diffs.append(float((walks[0] - walks[1]).abs().max()))
        out["solo_device"], out["walk_max_abs_diff"] = solo, diffs
        return out

    engine_ids = [[tok.sot_token] + tok.encode(p) for p in ENGINE_PROMPTS]

    def engine():
        eng = ContinuousBatcher(qmodel, batch_slots=ENGINE_SLOTS,
                                max_len=min(qmodel.config.n_positions,
                                            max(map(len, engine_ids)) + GEN_NEW_TOKENS),
                                top_k=1, burst=ENGINE_BURST, pipeline=ENGINE_PIPELINE,
                                quant_int8=True, eot_id=tok.eot_token, mesh=mesh,
                                generator=torch.Generator(device="cuda").manual_seed(0))
        reqs = [eng.submit(p, max_new_tokens=GEN_NEW_TOKENS) for p in engine_ids]
        eng.run()
        return [p + r.out_ids for p, r in zip(engine_ids, reqs)]

    out["engine"] = _md_count(out, "engine", engine)
    out["batched"] = _md_count(out, "batched", lambda: gen_gpt.generate_device_batched(
        dec, prompts, mesh=mesh, **greedy))

    def margins():
        got = {name: [_greedy_margin(qmodel, table, seq, len(p))[:2]
                      for seq, p in zip(seqs, engine_ids if name == "engine" else prompts)]
               for name, seqs in (("engine", out["engine"]), ("batched", out["batched"]))}
        got["device"] = [_greedy_margin(qmodel, table, seq, len(p), stepwise=True, stepper=dec)
                         for seq, p in zip(out["tp_ids"], prompts)]
        return got

    out["margins"] = _md_count(out, "margins", margins)

    def fault():   # rank 1's slice of block 5's c_proj adds nothing to the sum; one prompt
        leaf = dec.local["h_5"]["attn"]["c_proj"]["kernel"]
        if mesh.coords["model"] == 1:
            dec.local["h_5"]["attn"]["c_proj"]["kernel"] = type(leaf)(torch.zeros_like(leaf.q),
                                                                      leaf.scale)
        try:
            seq = gen_gpt.generate_device(dec, prompts[0], mesh=mesh, **greedy)
            return [_greedy_margin(qmodel, table, seq, len(prompts[0]), stepwise=True,
                                   stepper=dec)]
        finally:
            dec.local["h_5"]["attn"]["c_proj"]["kernel"] = leaf

    out["fault_margins"] = _md_count(out, "fault tp", fault)
    return out


def _md_walk(walker, table, ids, n_prompt: int):
    """The int8 head's logits of every generated position, the sequence fed
    token by token through ``walker``'s cache (as the device loop runs it)."""
    import torch

    from summer_clip_torch.ops import gemv

    with torch.inference_mode():
        x = torch.tensor([ids], device="cuda")
        out = walker(x[:, :n_prompt], position_offset=0, cache=walker.init_cache(1, len(ids)),
                     compute_logits=False)
        rows = [gemv.qdot(out["hidden"][:, -1, :], table, torch.float32)[0]]
        for pos in range(n_prompt, len(ids) - 1):
            out = walker(x[:, pos:pos + 1], position_offset=pos, cache=out["cache"],
                         compute_logits=False)
            rows.append(gemv.qdot(out["hidden"][:, -1, :], table, torch.float32)[0])
    return torch.stack(rows)


def _md_preds_agreement(run_a: Path, run_b: Path) -> dict:
    """Record by record: the share of test rows whose saved predictions agree
    between two image_attention runs (the same grid), its least value, the
    records equal bit for bit, and the largest |d acc1|."""
    import numpy as np

    def recs(root):
        path, = root.rglob("records.jsonl")
        rs = [json.loads(line) for line in path.read_text().splitlines()]
        return path.parent, [r for r in rs if r.get("type") == "searcher_result"]

    (da, ra), (db, rb) = recs(run_a), recs(run_b)
    if len(ra) != len(rb) or not ra:
        raise AssertionError(f"{run_a.name}: {len(ra)} records against {len(rb)}")
    least, same, dacc = 1.0, 0, 0.0
    for a, b in zip(ra, rb):
        for k in ("cache_strategy", "cache_value_strategy", "cache_weights_strategy", "alpha"):
            if a[k] != b[k]:
                raise AssertionError(f"{run_a.name}: records out of step at {k}")
        pa, pb = np.load(da / a["preds_path"]), np.load(db / b["preds_path"])
        agree = float((pa == pb).mean())
        least, same = min(least, agree), same + int(agree == 1.0)
        dacc = max(dacc, abs(a["acc1"] - b["acc1"]))
    return {"least": least, "equal": same, "records": len(ra), "max_dacc1": dacc}


def _md_rank_sum(ranks: list, names) -> dict:
    """Launches by kernel over the ranks and the named sub-runs."""
    total = {}
    for r in ranks:
        for name in names:
            for k, v in r["launches"][name].items():
                total[k] = total.get(k, 0) + v
    return total


def run_multi_device(work: Path, search_work: Path, tip_store: Path, gen: dict) -> dict:
    """Phase (p): the serving side of the multi-device layer at full width.
    World 2 on the one card (two processes, gloo over CUDA tensors), one group:
    the apps inside it (``save_features`` at ViT-B/16, batch 32, data
    parallel; ``gen_gpt`` with ``generation.tp=2``, the int8 device loop),
    image_attention over the CLIP-search ViT-L/14 store (Hard: K3 / K2,
    Softmax: K1 a rank), the engine and the batched sampler at tp = 2 (K7 a
    rank). World 1 through NCCL: image_attention over the prototype labels
    (K2, K1) and the device loop through the decoder of one rank. Every rank's
    launches come back per sub-run; the path's are their sum (planted-fault
    runs apart). Where the machine has more cards, the apps' own launchers
    over every card through NCCL."""
    import numpy as np
    import torch

    from summer_clip_torch.apps import gen_gpt, image_attention
    from summer_clip_torch.parallel import launch
    from summer_clip_torch.store import FeatureStore

    torch.cuda.empty_cache()
    work.mkdir(parents=True, exist_ok=True)
    out = {"seconds": {}}
    cwd = os.getcwd()

    def app(name, fn, argv):
        sub = work / name
        sub.mkdir(parents=True, exist_ok=True)
        os.chdir(sub)
        t0 = time.perf_counter()
        try:
            res = fn(argv=argv)
        finally:
            os.chdir(cwd)
        out["seconds"][name] = time.perf_counter() - t0
        return res

    sf_argv = ["clip=vit_b16", "dataset_name=synthetic", "dataset@train_dataset=synthetic_train",
               "dataset@test_dataset=synthetic_test", "data.batch_size=32",
               "save_train_outs=false", f"store.root={work / 'features'}"]
    gen_argv = gen["int8"] + ["generation.tp=2"]
    t0 = time.perf_counter()
    shared = launch(md_group_rank, ["cuda:0", "cuda:0"], str(work / "w2"),
                    str(search_work / "features"), str(gen["ckpt_dir"]), False, sf_argv, gen_argv)
    out["seconds"]["group w2 (gloo)"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    nccl = launch(md_group_rank, ["cuda:0"], str(work / "w1"), str(search_work / "features"),
                  str(gen["ckpt_dir"]), True, [], [], backend="nccl")
    out["seconds"]["group w1 (nccl)"] = time.perf_counter() - t0
    out.update(shared=[r.value for r in shared], nccl=[r.value for r in nccl])

    # the data-parallel store against the one-device store, row for row
    one, two = FeatureStore(tip_store), FeatureStore(work / "features")
    worst, fault, equal = 0.0, 0.0, True
    for key in ("synthetic_train-ViT-B16", "synthetic_test-ViT-B16"):
        if not np.array_equal(one.load(key, "labels"), two.load(key, "labels")):
            raise AssertionError(f"{key}: the data-parallel store's labels or row order differ")
        a, b = np.asarray(one.load(key, "features")), np.asarray(two.load(key, "features"))
        worst, equal = max(worst, float(np.abs(a - b).max())), equal and np.array_equal(a, b)
        # planted fault: each batch's two halves gathered in the wrong order
        swapped = np.concatenate([np.roll(b[i:i + 32], 16, axis=0) for i in range(0, len(b), 32)])
        fault = max(fault, float(np.abs(a - swapped).max()))
    out["store"] = {"max_abs": worst, "bit_equal": equal, "fault": fault}

    if torch.cuda.device_count() > 1:   # every card through NCCL, through the apps' launchers
        n = torch.cuda.device_count()
        name, outs_key, value = MD_SEARCHES[1]
        app(f"image_attention_{name}_w{n}", image_attention.run,
            ["clip=vit_l14", f"store.root={search_work / 'features'}", f"meta.world_size={n}",
             *search_argv("synthetic_1k", outs_key, value, SEARCH_SAVES)])
        if 20 % n == 0:   # gpt2-large's heads split over the cards
            app(f"gen_gpt_tp{n}", gen_gpt.run, gen["int8"] + [f"generation.tp={n}"])
    return out


def check_multi_device(md: dict, search_work: Path, gen: dict) -> dict:
    """Phase (p)'s gates, each beside a planted fault's reading, and its
    launches per rank; every reading is logged before the first failed gate
    raises (all of them, in one AssertionError). Returns the path's launches
    (summed over ranks)."""
    from summer_clip_torch.models.gpt2 import GPT2_CONFIGS

    work = search_work.parent / "multi_device"
    per_token = tp_k7_per_token(GPT2_CONFIGS["gpt2-large"], 2)
    steps = GEN_NEW_TOKENS - 1
    n_prompt = gen["n_prompt"]
    prefill = sum(4 * 36 + 2 for n in n_prompt if n <= 8)
    waves = -(-len(ENGINE_PROMPTS) // ENGINE_SLOTS)
    engine_steps = waves * min(ENGINE_PIPELINE, -(-steps // ENGINE_BURST)) * ENGINE_BURST
    failures = []

    def fail(msg):
        log(f"multi_device FAILED: {msg}")
        failures.append(msg)

    log(f"multi_device: seconds {json.dumps({k: round(v, 2) for k, v in md['seconds'].items()})}")
    for name, group in (("w2 (gloo, one card shared)", md["shared"]),
                        ("w1 (nccl)", md["nccl"])):
        log(f"multi_device group {name}: backends {[r['backend'] for r in group]}, seconds by "
            f"sub-run (rank 0) {json.dumps({k: round(v, 2) for k, v in group[0]['seconds'].items()})}")

    # launches per rank, asserted
    def check(label, launches, want):
        got = {k: launches.get(k, 0) for k in want}
        log(f"multi_device {label}: launches {json.dumps({k: v for k, v in launches.items() if v})}")
        if got != want:
            fail(f"multi_device {label}: launches {got}, expected {want}")

    for res in md["shared"]:
        r = res["rank"]
        check(f"save_features w2 rank {r}", res["launches"]["save_features"],
              {"K5 fused_ln_attn": 12 * 2, "K6 fused_ln_mlp": 12 * 2})   # 2 batches of 16 rows a rank
        check(f"gen_gpt tp=2 device loop rank {r}", res["launches"]["gen_gpt tp2"],
              {"K7 streamed_qmatmul": prefill + 3 * steps * per_token, "K8 decode_block": 0,
               "K10 fused_qmlp": 0})
    for group, world in ((md["shared"], 2), (md["nccl"], 1)):
        for res in group:
            for name, _, value in md_searches(world == 1):
                got = res["launches"][name]
                label = f"image_attention {name} w{world} rank {res['rank']}"
                if value == "hard_cache":
                    check(label, got, {"K1 cache_dense": 0})
                    if got["K2 labels_dense"] + got["K3 onehot_grouped"] != MD_SELECTIONS:
                        fail(f"{label}: K2 + K3 launched "
                                             f"{got['K2 labels_dense'] + got['K3 onehot_grouped']}"
                                             f" times, expected {MD_SELECTIONS}")
                else:
                    check(label, got, {"K1 cache_dense": MD_SELECTIONS * 3, "K2 labels_dense": 0,
                                       "K3 onehot_grouped": 0})
    for res in md["shared"]:
        check(f"engine tp=2 rank {res['rank']}", res["launches"]["engine"],
              {"K7 streamed_qmatmul": engine_steps * per_token + waves, "K8 decode_block": 0})
        check(f"batched tp=2 rank {res['rank']}", res["launches"]["batched"],
              {"K7 streamed_qmatmul": steps * per_token})
    for res in md["nccl"]:
        check(f"device loop tp=1 (nccl) rank {res['rank']}", res["launches"]["device"],
              {"K7 streamed_qmatmul": prefill + 3 * steps * per_token})

    # the ranks agree
    for key in ("engine", "batched"):
        if md["shared"][0][key] != md["shared"][1][key]:
            fail(f"multi_device: the two ranks picked different ids ({key})")

    # the stores
    st = md["store"]
    log(f"multi_device save_features w2 store vs the one-device store (ViT-B/16, tip path): "
        f"max|d| {st['max_abs']:.3e} (tol {TOL_MD_FEATURES}), bit for bit: {st['bit_equal']}; "
        f"planted fault (each batch's halves gathered in the wrong order) reads "
        f"{st['fault']:.3e}")
    if st["max_abs"] > TOL_MD_FEATURES or st["fault"] <= TOL_MD_FEATURES:
        fail("the data-parallel store disagrees with the one-device store")

    # the searches, record by record against the clip_search path's one-device runs
    for world, root in ((2, work / "w2"), (1, work / "w1")):
        for name, _, _ in md_searches(world == 1):
            one = search_work / f"image_attention_synthetic_1k_{name}"
            got = _md_preds_agreement(root / name / "rank0", one)
            log(f"multi_device image_attention {name} w{world}: saved predictions of "
                f"{got['records']} records against the one-device run: least agreement "
                f"{got['least']:.4f} (tol >= {TOL_MD_PRED_AGREE}), {got['equal']} records bit for "
                f"bit, max |d acc1| {got['max_dacc1']:.3f}")
            if got["least"] < TOL_MD_PRED_AGREE:
                fail(f"multi_device image_attention {name} w{world} disagrees "
                                     f"with the one-device run")
    fault = _md_preds_agreement(work / "w2" / "fault_protos_hard_cache" / "rank0",
                                search_work / "image_attention_synthetic_1k_protos_hard_cache")
    log(f"multi_device planted fault (rank 1's partial logits dropped), protos_hard_cache: least "
        f"agreement {fault['least']:.4f}, max |d acc1| {fault['max_dacc1']:.3f}")
    if fault["least"] >= TOL_MD_PRED_AGREE:
        fail("the planted fault passes the multi_device search gate")

    # tensor-parallel decode
    solo = {"device": [g["ids"] for g in gen["results"]["int8_device"]["generations"]],
            "batched": [g["ids"] for g in gen["results"]["int8_batched"]["generations"]],
            "engine": [g["ids"] for g in gen["results"]["engine_k7"]["generations"]]}
    shared = md["shared"][0]
    runs = {"device": shared["tp_ids"], "batched": shared["batched"], "engine": shared["engine"]}
    for name, ids in runs.items():
        same = sum(a == b for a, b in zip(ids, solo[name]))
        margins = shared["margins"][name]
        worst = max(m[0] for m in margins)
        log(f"multi_device tp=2 {name}: {same} of {len(ids)} sequences equal the one-device "
            f"run's; teacher forced through the plain route, {sum(m[1] for m in margins)} picks "
            f"are not its argmax, the farthest by {worst:.3e} of the row's spread (tol "
            f"{TOL_GREEDY_TIE})")
        if worst > TOL_GREEDY_TIE:
            fail(f"multi_device tp=2 {name}: picks beyond the tie tolerance")
    walk = max(m[2] for m in shared["margins"]["device"])
    f_pick = max(m[0] for m in shared["fault_margins"])
    f_walk = max(m[2] for m in shared["fault_margins"])
    log(f"multi_device tp=2 device loop, step by step through the decoder: logits {walk:.3e} of "
        f"the spread from the plain route's (tol {TOL_GREEDY_LOGITS}); planted fault (rank 1's "
        f"slice of block 5's c_proj dropped): picks {f_pick:.3e} (tol {TOL_GREEDY_TIE}), logits "
        f"{f_walk:.3e}")
    if walk > TOL_GREEDY_LOGITS or (f_walk <= TOL_GREEDY_LOGITS and f_pick <= TOL_GREEDY_TIE):
        fail("multi_device tp=2: logits beyond the gate, or the fault passes it")
    w1 = md["nccl"][0]
    log(f"multi_device tp=1 (nccl) device loop: ids equal the one-device sampler's: "
        f"{w1['device'] == w1['solo_device']}, step-by-step logits max|d| against the one-device "
        f"model: {max(w1['walk_max_abs_diff']):.3e}")
    if w1["device"] != w1["solo_device"] or max(w1["walk_max_abs_diff"]) != 0.0:
        fail("the decoder of one rank is not the one-device forward bit for bit")

    names = ["save_features", "gen_gpt tp2", "engine", "batched"] + [n for n, _, _ in MD_SEARCHES]
    total = _md_rank_sum(md["shared"], names)
    for k, v in _md_rank_sum(md["nccl"], ["device"] + [n for n, _, _ in md_searches(True)]).items():
        total[k] = total.get(k, 0) + v
    log(f"multi_device launches over every rank and sub-run: "
        f"{json.dumps({k: v for k, v in total.items() if v})}")
    missing = [k for k in MULTI_PATH if total.get(k, 0) <= 0]
    if missing:
        fail(f"main path multi_device did not launch {missing}")
    if failures:
        raise AssertionError("multi_device: " + "; ".join(failures))
    return {k: total.get(k, 0) for k in launch_counters()}


# ---------------------------------------------------------------------------
# (q) multi_device_train: the training side of the multi-device layer
# ---------------------------------------------------------------------------
MDT_PATH = ("K4 short_attention_packed",)
MDT_BATCH, MDT_ACCUM, MDT_MICRO = 8, 2, 2      # global batch 8 x 80, one update, one eval batch
MDT_STAGES, MDT_PP_MICRO = 2, 2
MDT_DEVICES = ("cuda:0", "cuda:0")             # world 2 on the one card
MDT_LAYOUTS = {"dp": [], "tp": ["training.tp=2"], "fsdp": ["training.fsdp=true"],
               "pp": [f"training.pp={MDT_STAGES}", f"training.pp_microbatches={MDT_PP_MICRO}"]}
# a layout's micro-step losses, eval loss, update norm (over every leaf) and
# the adapters' first Adam moments against the one-device reference (bf16,
# K4): the train_gpt gate's limits (kernel route against plain on one device);
# the one-device bf16 route's own distance to an f32 route of the same
# weights and batch is logged beside them. The update's learning rate is
# warmup's 0, so the adapters themselves must equal the reference's.
TOL_MDT_LOSS_REL = TOL_LM_LOSS_REL
TOL_MDT_NORM_REL = TOL_LM_NORM_REL
TOL_MDT_MOMENT_REL = TOL_LM_NORM_REL
# EP at width 1280, f32: the forward and every gradient against the dense MoE
TOL_EP_REL = 1e-4


def mdt_k4_per_rank(layout: str, n_layer: int = 36, micro: int = MDT_MICRO, evals: int = 1,
                    stages: int = MDT_STAGES, n_micro: int = MDT_PP_MICRO) -> int:
    """K4's launches a rank makes in a layout's run: a block and forward, a
    second time under remat's recompute, once an eval batch; a pipeline stage
    runs its blocks at every one of ``M + S - 1`` ticks."""
    if layout == "pp":
        return n_layer // stages * (n_micro + stages - 1) * (2 * micro + evals)
    return n_layer * (2 * micro + evals)


def mdt_argv(work: Path, corpus: Path, val: Path, name: str, rows: int) -> list:
    return ["clip_gpt.gpt_config=gpt2-large", "clip_gpt.clip_emb_dim=512",
            "clip_gpt.adapters.emb_hid_dim=1024", "clip_gpt.adapters.head_hid_dim=1024",
            f"dataset.train.tokens_path={corpus}",
            f"dataset.train.subpart={(MDT_BATCH * MDT_MICRO + 0.5) / rows}",
            f"dataset.val.tokens_path={val}", f"data_loader.train.batch_size={MDT_BATCH}",
            f"data_loader.val.batch_size={MDT_BATCH}", "training.epochs_num=1",
            f"training.grad_accum_steps={MDT_ACCUM}", "training.clip_grad_norm=1.0",
            "training.evals_per_epoch=1", "training.info_steps=1", "training.bf16=true",
            "training.remat=true", f"training.checkpoints_dir={work / ('ckpt_' + name)}",
            # one update: the cosine schedule would have no decay steps (optax raises)
            "scheduler.name=linear"]


def _mdt_run(work: str, name: str, argv: list, out: dict):
    """One layout's ``train_gpt`` in this rank: each micro-step's loss, ms,
    and each update's norm and gradient all-reduce seconds recorded, with the
    rank's peak memory and resident parameter bytes."""
    import gc

    import torch

    from summer_clip_torch.apps import train_gpt

    cls = train_gpt.ClipGPTTrainer
    step = cls.train_step
    rec = {"losses": [], "ms": [], "norms": [], "sync_s": []}
    cuda = torch.cuda.is_available()

    def recorded(self, ids):
        count = self.tx.count
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step(self, ids)
        if cuda:
            torch.cuda.synchronize()
        rec["ms"].append((time.perf_counter() - t0) * 1e3)
        rec["losses"].append(loss)
        if self.tx.count != count:
            rec["norms"].append(self.tx.inner.last_grad_norm)
            rec["sync_s"].append(self.layout.last_sync_s)
        return loss

    gc.collect()      # the previous layout's trainer
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    cls.train_step = recorded
    try:
        trainer = _md_count(out, name, lambda: _md_app(work, f"mdt_{name}", train_gpt.run, argv))
    finally:
        cls.train_step = step
    rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30 if cuda else 0.0
    rec["param_bytes"] = sum(p.numel() * p.element_size() for p in trainer.model.parameters())
    rec["describe"] = trainer.layout.describe
    out["runs"][name] = rec


def _mdt_fault_run(work: str, argv: list, out: dict) -> None:
    """The planted fault: a pipeline run whose stage sum is transposed as a
    second all-reduce (``axis_sum`` then ``axis_copy``) instead of the
    identity, so every gradient is summed over the stages once too often."""
    from summer_clip_torch.parallel import pp
    from summer_clip_torch.parallel.mesh import axis_copy

    real = pp.axis_sum
    pp.axis_sum = lambda x, mesh, axis: axis_copy(real(x, mesh, axis), mesh, axis)
    try:
        _mdt_run(work, "fault pp", argv, out)
    finally:
        pp.axis_sum = real


def mdt_group_rank(work: str, argvs: dict, fault_argv: list, ep: dict) -> dict:
    """One rank of phase (q)'s world-2 group on the one card: each layout's
    train_gpt run (dp, tp, fsdp, pp), the planted fault's pipeline run, and EP
    at width 1280 against the dense MoE."""
    import torch
    import torch.distributed as dist

    from summer_clip_torch.parallel import create_mesh, moe_apply_ep, moe_forward_dense
    from summer_clip_torch.parallel import shard_experts_ep

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"launches": {}, "seconds": {}, "runs": {}, "rank": dist.get_rank(),
           "backend": dist.get_backend()}
    for name, argv in argvs.items():
        _mdt_run(work, name, argv, out)
    _mdt_fault_run(work, fault_argv, out)

    def experts():
        mesh = create_mesh(axes={"expert": 2})
        g = torch.Generator().manual_seed(ep["seed"])
        whole = {k: (torch.randn(shape, generator=g) * scale).to(mesh.device)
                 for k, (shape, scale) in ep["shapes"].items()}
        x = torch.randn(ep["x"], generator=g).to(mesh.device)
        res = {}
        for route in ("dense", "ep"):
            params = {k: v.clone().requires_grad_(True) for k, v in whole.items()}
            xx = x.clone().requires_grad_(True)
            if route == "dense":
                y = moe_forward_dense(params, xx)
            else:
                local = shard_experts_ep(params, mesh)
                y = moe_apply_ep(local, xx, mesh)
            (y ** 2).sum().backward()
            res[route] = {"y": y.detach(), "x": xx.grad, **{k: p.grad for k, p in params.items()}}
        i = mesh.coords["expert"]
        e = ep["shapes"]["w1"][0][0] // 2
        rel = {}
        for k in res["dense"]:
            want = res["dense"][k]
            if k in ("w1", "b1", "w2", "b2"):     # this rank's experts
                want = want[i * e:(i + 1) * e]
                got = res["ep"][k][i * e:(i + 1) * e]
            else:
                got = res["ep"][k]
            rel[k] = float((got - want).norm() / want.norm())
        return rel

    out["ep_rel"] = _md_count(out, "ep", experts)
    return out


def gloo_probe():
    """Start ``tools/torch_gloo_probe.py`` in a process of its own (it may
    crash or hang a rank, and kills its ranks after 60 s): what gloo does with
    CUDA tensors of two ranks on one card, op by op. Returns a function that
    waits for its answer."""
    import subprocess

    probe = subprocess.Popen([sys.executable, str(Path(__file__).resolve().parent / "tools"
                                                  / "torch_gloo_probe.py"), "--timeout", "60"],
                             stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)

    def answer() -> dict:
        try:
            stdout, _ = probe.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            probe.kill()
            stdout, _ = probe.communicate()
        lines = [line for line in stdout.splitlines() if line.startswith("{")]
        return json.loads(lines[-1]) if lines else {"probe": f"exit {probe.returncode}"}

    return answer


def run_multi_device_train(work: Path, lm_work: Path) -> dict:
    """Phase (q): ``train_gpt`` at gpt2-large full width and depth (36 layers,
    1280 wide, 20 heads; ClipGPT with the adapters of ``train_gpt_argv``; bf16,
    remat; batch 8 x 80, ``grad_accum_steps`` 2, ``clip_grad_norm`` 1.0; 2
    micro-steps and one eval batch) at world 1 in this process (the
    reference, then ``scan_layers``), then in one world-2 group on the one
    card (gloo) under dp = 2, tp = 2, fsdp and pp = 2 (2 microbatches), and EP
    at width 1280 (4 experts over 2 ranks); the gloo probe first."""
    import numpy as np
    import torch

    from summer_clip_torch.apps import train_gpt
    from summer_clip_torch.parallel import launch

    torch.cuda.empty_cache()
    work.mkdir(parents=True, exist_ok=True)
    out = {"seconds": {}}
    probe = gloo_probe()      # beside the world-1 runs

    corpus = lm_work / "corpus.npy"
    rows = len(np.load(corpus))
    val = work / "val8.npy"
    np.save(val, np.load(lm_work / "val.npy")[:MDT_BATCH])      # one eval batch
    captured = {}
    real_run_trainer = train_gpt.run_trainer

    def capture(cls, cfg):
        captured["trainer"] = real_run_trainer(cls, cfg)
        return captured["trainer"]

    ref = {}
    train_gpt.run_trainer = capture
    try:
        for name, extra in (("reference", []), ("scan", ["training.scan_layers=true"])):
            sub = work / name
            sub.mkdir()
            cwd = os.getcwd()
            os.chdir(sub)
            losses, norms = [], []
            step = train_gpt.ClipGPTTrainer.train_step

            def recorded(self, ids, losses=losses, norms=norms, step=step):
                count = self.tx.count
                loss = step(self, ids)
                losses.append(loss)
                if self.tx.count != count:
                    norms.append(self.tx.inner.last_grad_norm)
                return loss

            train_gpt.ClipGPTTrainer.train_step = recorded
            t0 = time.perf_counter()
            try:
                counters = launch_counters()
                for f in counters.values():
                    f.launches = 0
                train_gpt.run(argv=mdt_argv(work, corpus, val, name, rows) + extra
                              + ["meta.world_size=1"])
                launches = {k: f.launches for k, f in counters.items()}
            finally:
                train_gpt.ClipGPTTrainer.train_step = step
                os.chdir(cwd)
            out["seconds"][name] = time.perf_counter() - t0
            trainer = captured.pop("trainer")
            ref[name] = {"losses": losses, "norms": norms, "launches": launches,
                         "k4": launches["K4 short_attention_packed"],
                         "eval": records(sub, "gpt_eval")[-1]["loss/eval"],
                         "adapters": {n: p.detach().cpu().clone()
                                      for n, p in trainer.model.named_parameters()
                                      if n.startswith("adapter_")}}
            if name == "reference":
                ref[name]["moments"] = {
                    n: trainer.tx.inner.optimizer.state[p]["exp_avg"].detach().cpu().clone()
                    for n, p in trainer.model.named_parameters() if n.startswith("adapter_")}
                ref[name]["f32_spread"] = _mdt_f32_spread(trainer)
                out["reference_trainer"] = trainer
            del trainer
            torch.cuda.empty_cache()
    finally:
        train_gpt.run_trainer = real_run_trainer
    out["ref"] = ref

    argvs = {name: mdt_argv(work, corpus, val, name, rows) + extra
             for name, extra in MDT_LAYOUTS.items()}
    ep = {"seed": 17, "x": (8, 80, 1280),
          "shapes": {"router": ((1280, 4), 1280 ** -0.5), "w1": ((4, 1280, 5120), 1280 ** -0.5),
                     "b1": ((4, 5120), 0.02), "w2": ((4, 5120, 1280), 5120 ** -0.5),
                     "b2": ((4, 1280), 0.02)}}
    t0 = time.perf_counter()
    out["gloo"] = probe()
    fault_argv = mdt_argv(work, corpus, val, "fault_pp", rows) + MDT_LAYOUTS["pp"]
    group = launch(mdt_group_rank, list(MDT_DEVICES), str(work / "w2"), argvs, fault_argv, ep)
    out["seconds"]["group w2 (gloo)"] = time.perf_counter() - t0
    out["group"] = [r.value for r in group]
    return out


def _mdt_f32_spread(trainer) -> float:
    """The one-device bf16 route's first micro-step loss against an f32 route
    of the same weights and batch (relative): the spread of the bf16 route
    itself, logged beside the layouts' gates. The weights are the initial
    ones (the one update's rate is warmup's 0)."""
    import numpy as np
    import torch

    from summer_clip_torch.apps.train_gpt import lm_loss_fn
    from summer_clip_torch.models import gpt2 as G

    order = np.random.default_rng((int(trainer.cfg.meta.random_state), 1)).permutation(
        len(trainer.train_tokens))
    ids = torch.from_numpy(trainer.train_tokens[order[:MDT_BATCH]]).to(trainer.device)
    with torch.no_grad():
        bf16 = float(lm_loss_fn(trainer.model(ids)["logits"], ids))
        m32 = G.ClipGPT(**{**trainer.model._ctor, "dtype": torch.float32}, device="meta")
        m32.load_tree(trainer.model.tree())
        f32 = float(lm_loss_fn(plain_route(lambda: m32(ids)["logits"]), ids))
    return abs(bf16 - f32) / abs(f32)


def check_multi_device_train(mdt: dict, work: Path) -> dict:
    """Phase (q)'s gates, each beside the planted fault's reading where one
    applies; every reading is logged before the failures raise together.
    Returns the path's launches (every rank's layout runs summed)."""
    import numpy as np
    import torch

    from summer_clip_torch.engine import checkpoint as ckpt

    failures = []

    def fail(msg):
        log(f"multi_device_train FAILED: {msg}")
        failures.append(msg)

    ref = mdt["ref"]["reference"]
    ref_trainer = mdt.pop("reference_trainer")
    log(f"multi_device_train gloo on CUDA tensors, two ranks on one card "
        f"(tools/torch_gloo_probe.py): {json.dumps(mdt['gloo'])}")
    log(f"multi_device_train seconds {json.dumps({k: round(v, 2) for k, v in mdt['seconds'].items()})}")
    want_ref = mdt_k4_per_rank("dp")
    log(f"multi_device_train reference (world 1): losses {ref['losses']}, norm {ref['norms']}, "
        f"eval {ref['eval']:.6f}, K4 {ref['k4']} (expected {want_ref}); the bf16 route's first "
        f"loss {ref['f32_spread']:.3e} from an f32 route of the same weights")
    if ref["k4"] != want_ref or len(ref["losses"]) != MDT_MICRO or len(ref["norms"]) != 1:
        fail(f"the reference run: K4 {ref['k4']}, {len(ref['losses'])} micro-steps")

    def rel(a, b):
        return abs(a - b) / abs(b)

    def gate_run(label, run_losses, run_norms, run_eval, adapters):
        loss_rel = max(rel(a, b) for a, b in zip(run_losses, ref["losses"]))
        norm_rel = rel(run_norms[0], ref["norms"][0])
        eval_rel = rel(run_eval, ref["eval"])
        same = all(torch.equal(adapters[n].cpu(), ref["adapters"][n]) for n in ref["adapters"])
        log(f"multi_device_train {label}: micro-step losses {loss_rel:.3e} (tol "
            f"{TOL_MDT_LOSS_REL}), update norm {norm_rel:.3e} (tol {TOL_MDT_NORM_REL}), eval "
            f"{eval_rel:.3e} (tol {TOL_MDT_LOSS_REL}), adapters equal the reference's (the "
            f"update's rate is warmup's 0): {same}")
        if (len(run_losses) != MDT_MICRO or loss_rel > TOL_MDT_LOSS_REL
                or norm_rel > TOL_MDT_NORM_REL or eval_rel > TOL_MDT_LOSS_REL or not same):
            fail(f"{label} disagrees with the one-device reference")

    scan = mdt["ref"]["scan"]
    gate_run("scan_layers (world 1)", scan["losses"], scan["norms"], scan["eval"],
             scan["adapters"])
    if scan["k4"] != want_ref:
        fail(f"scan_layers: K4 {scan['k4']}, expected {want_ref}")

    group = mdt["group"]
    total: dict = {}
    for run in (ref, scan):
        for k, v in run["launches"].items():
            total[k] = total.get(k, 0) + v
    for name in MDT_LAYOUTS:
        want_k4 = mdt_k4_per_rank(name)
        for res in group:
            run, r = res["runs"][name], res["rank"]
            k4 = res["launches"][name]["K4 short_attention_packed"]
            for k, v in res["launches"][name].items():
                total[k] = total.get(k, 0) + v
            log(f"multi_device_train {name} ({run['describe']}) rank {r}: {res['seconds'][name]:.2f} "
                f"s, micro-steps {[round(m, 1) for m in run['ms']]} ms, update all-reduce "
                f"{[round(s * 1e3, 1) for s in run['sync_s']]} ms, peak {run['peak_gib']:.3f} GiB, "
                f"parameters {run['param_bytes'] / 2 ** 30:.3f} GiB, K4 {k4} (expected {want_k4})")
            if k4 != want_k4:
                fail(f"{name} rank {r}: K4 launched {k4} times, expected {want_k4}")
            if any(v for k, v in res["launches"][name].items() if k != "K4 short_attention_packed"):
                fail(f"{name} rank {r} launched another kernel")
            if run["losses"] != group[0]["runs"][name]["losses"]:
                fail(f"{name}: the ranks logged other losses")
        step_dir = work / f"ckpt_{name}" / "epoch_1" / f"step_{MDT_MICRO}"
        saved = ckpt.load_checkpoint(step_dir)
        flat = dict(ckpt_leaves(saved["params"]))
        run = group[0]["runs"][name]
        records_eval = records(work / "w2" / f"mdt_{name}" / "rank0", "gpt_eval")[-1]["loss/eval"]
        gate_run(name, run["losses"], run["norms"], records_eval, flat)
        # the one-device app reads it: the standard layout, and its optimizer state
        named = dict(ref_trainer.model.named_parameters())
        try:
            for n, leaf in flat.items():
                if tuple(leaf.shape) != tuple(named[n].shape):
                    raise ValueError(f"{n} is {tuple(leaf.shape)}, the model's "
                                     f"{tuple(named[n].shape)}")
                with torch.no_grad():
                    named[n].copy_(leaf)
            ref_trainer.tx.load_state_dict(saved["opt_state"])
            moment_rel = max(
                float((ref_trainer.tx.inner.optimizer.state[named[n]]["exp_avg"].cpu() - m).norm()
                      / m.norm()) for n, m in ref["moments"].items())
        except (ValueError, KeyError, RuntimeError) as exc:
            fail(f"{name}: the step checkpoint does not load into the one-device app ({exc})")
            continue
        log(f"multi_device_train {name}: step checkpoint {sorted(flat)[:2]}... ({len(flat)} "
            f"leaves) loads into the one-device trainer; the adapters' first moments "
            f"{moment_rel:.3e} from the reference's (tol {TOL_MDT_MOMENT_REL})")
        if moment_rel > TOL_MDT_MOMENT_REL:
            fail(f"{name}: the update's moments disagree with the reference's")
    fault = group[0]["runs"]["fault pp"]
    fault_rel = rel(fault["norms"][0], ref["norms"][0])
    log(f"multi_device_train planted fault (pp, the stage sum's backward a second all-reduce): "
        f"update norm {fault['norms'][0]:.6e}, {fault_rel:.3e} from the reference's (tol "
        f"{TOL_MDT_NORM_REL}, {fault_rel / TOL_MDT_NORM_REL:.1f}x); losses "
        f"{max(rel(a, b) for a, b in zip(fault['losses'], ref['losses'])):.3e}")
    if fault_rel < 3 * TOL_MDT_NORM_REL:
        fail("the planted fault passes the multi_device_train gates")
    for res in group:
        ep_rel = res["ep_rel"]
        log(f"multi_device_train EP (width 1280, 4 experts over 2 ranks) rank {res['rank']}: "
            f"relative to the dense MoE {json.dumps({k: float(f'{v:.3e}') for k, v in ep_rel.items()})} "
            f"(tol {TOL_EP_REL})")
        if max(ep_rel.values()) > TOL_EP_REL:
            fail("EP disagrees with the dense MoE")
    log(f"multi_device_train launches over the world-1 runs, both ranks and the layouts: "
        f"{json.dumps({k: v for k, v in total.items() if v})}")
    missing = [k for k in MDT_PATH if total.get(k, 0) <= 0]
    if missing:
        fail(f"main path multi_device_train did not launch {missing}")
    del ref_trainer
    torch.cuda.empty_cache()
    if failures:
        raise AssertionError("multi_device_train: " + "; ".join(failures))
    return {k: total.get(k, 0) for k in launch_counters()}


# --------------------------------------------------------------------------- #
# phase (r): save_features on JPEG files through the native input path
# --------------------------------------------------------------------------- #
JPEG_PATH = ("K5 fused_ln_attn", "K6 fused_ln_mlp")
JPEG_IMAGES = 2048
JPEG_CLASSES = 101                       # Caltech101's object classes
# (width, height) by image index mod 4: half at ImageNet's common 500x375 (both
# orientations), a quarter at 1600x1200 (the DCT-scaled decode: 1/2 for a 224
# target), a quarter at Caltech101's typical 300x200
JPEG_SIZES = ((500, 375), (375, 500), (1600, 1200), (300, 200))
JPEG_QUALITY = 90
JPEG_BATCH = 32
JPEG_CPU_ROWS = 64
# stored native rows against the PIL run's and against the f32 CPU model on the
# native library's own pixels (min row cosine, the pipelines' gate)
TOL_JPEG_COS = 0.99
# the native library's pixels against PIL's EvalTransform of the same files
# (normalized units): the largest per-image mean |d| and the max |d| over the
# first JPEG_CPU_ROWS test files. Readings 0.004941 / 0.042558 under Pillow
# 12.1.0 and 12.2.0 alike (the latter the H100 host's); planted faults: the crop
# one pixel off 0.1395 / 0.5687, bilinear taps 0.010425 / 0.090047
TOL_JPEG_PIX_MEAN = 0.008
TOL_JPEG_PIX_MAX = 0.065


def write_caltech_tree(root: Path, seed: int, n_images: int = JPEG_IMAGES,
                       n_classes: int = JPEG_CLASSES, threads: int = 0) -> dict:
    """A Caltech101-shaped tree under ``root``: ``caltech-101/101_ObjectCategories/
    <class>/*.jpg`` (JPEG quality 90; smooth content plus noise drawn from
    ``(seed, i)``, the noise a window of one field a size; image ``i`` at
    ``JPEG_SIZES[i % 4]``, of class ``i %
    n_classes``) and ``caltech-101/split_zhou_Caltech101.json``, whose train and
    test splits take alternate blocks of four images (each split holds every
    size; no val rows). Returns each split's row count."""
    import numpy as np
    from PIL import Image

    base = root / "caltech-101"
    names = [f"class_{k:03d}" for k in range(n_classes)]

    # noise: one field a size, each image a window of it at an offset of its own
    pad = 64
    noise = {(w, h): np.random.default_rng((seed, w, h)).integers(
        -12, 13, (h + pad, w + pad, 3), dtype=np.int16) for w, h in JPEG_SIZES}

    def one(i: int) -> list:
        w, h = JPEG_SIZES[i % len(JPEG_SIZES)]
        rng = np.random.default_rng((seed, i))
        coarse = (rng.random((h // 40 + 2, w // 40 + 2, 3)) * 255).astype(np.uint8)
        arr = np.asarray(Image.fromarray(coarse).resize((w, h), Image.BILINEAR), np.int16)
        dy, dx = rng.integers(0, pad, 2)
        arr = np.clip(arr + noise[w, h][dy:dy + h, dx:dx + w], 0, 255)
        label = i % n_classes
        rel = f"{names[label]}/image_{i:05d}.jpg"
        path = base / "101_ObjectCategories" / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        Image.fromarray(arr.astype(np.uint8)).save(path, quality=JPEG_QUALITY)
        return [rel, label, names[label]]

    with concurrent.futures.ThreadPoolExecutor(threads or os.cpu_count() or 4) as pool:
        rows = list(pool.map(one, range(n_images)))
    split = {"train": [r for i, r in enumerate(rows) if (i // 4) % 2 == 0], "val": [],
             "test": [r for i, r in enumerate(rows) if (i // 4) % 2 == 1]}
    (base / "split_zhou_Caltech101.json").write_text(json.dumps(split))
    return {k: len(v) for k, v in split.items()}


def jpeg_argv(data: Path, store: Path) -> list:
    """save_features over the Caltech101 tree at ``data`` at ViT-B/16, batch 32."""
    return ["clip=vit_b16", "dataset_name=caltech101", f"path.cache_dir={data}",
            f"data.batch_size={JPEG_BATCH}", f"store.root={store}"]


def build_native() -> str:
    """Build the native JPEG library from the checkout's source; what it took."""
    import PIL

    from summer_clip_torch import native

    t0 = time.perf_counter()
    native.ensure_built()
    return (f"native preprocess library built in {time.perf_counter() - t0:.2f} s (g++; Pillow "
            f"{PIL.__version__} decodes at the library's DCT scale)")


def jpeg_pixel_readings(paths: tp.Sequence[str], pixels) -> dict:
    """(largest per-image mean |d|, max |d|) of the native rows ``pixels`` of
    ``paths`` against PIL's ``EvalTransform`` rows of the same files, and of
    two planted faults read the same way: the native crop one pixel off (its
    columns 1.. against PIL's 0..S-2) and bilinear taps (Pillow's bilinear
    resize, then the same crop and normalize, in the native rows' place)."""
    import numpy as np
    from PIL import Image

    from summer_clip_torch.data.transforms import (CLIP_MEAN, CLIP_STD, EvalTransform,
                                                   load_image)

    size = pixels.shape[1]

    def bilinear(path):
        img = load_image(path)
        w, h = img.size
        nw, nh = (size, max(1, round(h * size / w))) if w <= h else \
            (max(1, round(w * size / h)), size)
        left, top = (nw - size) // 2, (nh - size) // 2
        img = img.resize((nw, nh), Image.BILINEAR).crop((left, top, left + size, top + size))
        return (np.asarray(img, np.float32) / 255.0 - CLIP_MEAN) / CLIP_STD

    pil = np.stack([EvalTransform(size)(load_image(p)) for p in paths])

    def reading(a, b):
        d = np.abs(a - b).reshape(len(a), -1)
        return float(d.mean(1).max()), float(d.max())

    return {"native": reading(pixels, pil),
            "the crop one pixel off": reading(pixels[:, :, 1:], pil[:, :, :-1]),
            "bilinear taps": reading(np.stack([bilinear(p) for p in paths]), pil)}


def loader_rate(data, **kw) -> float:
    """Images a second of an ``ImageBatcher`` over ``data`` alone (no device)."""
    from summer_clip_torch.data.loader import ImageBatcher
    from summer_clip_torch.data.transforms import EvalTransform

    batcher = ImageBatcher(data, batch_size=JPEG_BATCH,
                           transform=EvalTransform(224, device_normalize=True), **kw)
    t0 = time.perf_counter()
    rows = sum(int(b.mask.sum()) for b in batcher)
    return rows / (time.perf_counter() - t0)


def run_jpeg_extract(work: Path, seed: int = 0) -> dict:
    """Phase (r): a seed-made Caltech101 tree of JPEG files through the port's
    ``save_features`` at ViT-B/16 (K5 + K6), batch 32, twice: on the loader's
    own choice (the test split's eval transform over ``.jpg`` files takes the
    native library; the train split's train transform decodes with PIL) and
    with ``ImageBatcher._native_available`` answering False; then
    ``eval_clip`` over the first run's store. Wrapping
    ``save_features.extract_image_features`` records each split's route, rows
    and wall time, and the span of its encode calls between CUDA events (two
    event records a batch: the only instrumentation inside the apps' timed
    windows). After the apps, one batch's encode with nothing else running,
    between CUDA events and as its kernels' device time; each app's launches
    are kept. Then the loader alone: the native path at one thread and at one
    a core, and PIL."""
    import torch

    from summer_clip_torch.apps import eval_clip, save_features
    from summer_clip_torch.data.datasets import build_dataset
    from summer_clip_torch.data.loader import ImageBatcher

    t0 = time.perf_counter()
    rows = write_caltech_tree(work / "data", seed)
    times = {"write_tree": time.perf_counter() - t0}
    log(f"jpeg_extract: a Caltech101 tree of {JPEG_IMAGES} JPEG files ({json.dumps(rows)}; "
        f"{JPEG_CLASSES} classes; sizes {JPEG_SIZES}, quality {JPEG_QUALITY}) written in "
        f"{times['write_tree']:.2f} s")
    splits: tp.List[dict] = []
    encoders = []
    real_extract = save_features.extract_image_features
    counters = launch_counters()

    def extract(session, batcher, preproj=False):
        events = []
        real_encode = session.encode_image

        def encode(images):
            start, end = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            start.record()
            out = real_encode(images)
            end.record()
            events.append((start, end))
            return out

        session.encode_image = encode
        torch.cuda.synchronize()
        t = time.perf_counter()
        try:
            res = real_extract(session, batcher, preproj)
        finally:
            del session.encode_image
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        encoders[:] = [(real_encode, session.input_size)]
        splits.append({"native": bool(batcher.use_native), "rows": len(res[0]),
                       "batches": len(events), "wall_s": wall,
                       "span_s": sum(s.elapsed_time(e) for s, e in events) / 1e3})
        return res

    stores = {"native": work / "native" / "features", "pil": work / "pil" / "features"}
    runs = [("save_features_native", save_features.run, jpeg_argv(work / "data", stores["native"])),
            ("save_features_pil", save_features.run, jpeg_argv(work / "data", stores["pil"])),
            ("eval_clip", eval_clip.run,
             ["clip=vit_b16", "dataset_name=caltech101", f"path.cache_dir={work / 'data'}",
              f"store.root={stores['native']}", "eval.features_key=caltech101_test-ViT-B16"])]
    launches, by_run = {}, {}
    real_available = ImageBatcher.__dict__["_native_available"]
    save_features.extract_image_features = extract
    try:
        for name, fn, argv in runs:
            if name == "save_features_pil":
                ImageBatcher._native_available = staticmethod(lambda: False)
            before, n_splits = {k: f.launches for k, f in counters.items()}, len(splits)
            try:
                times.update(run_apps([(name, fn, argv)], work))
            finally:
                ImageBatcher._native_available = real_available
            launches[name] = {k: f.launches - before[k] for k, f in counters.items()}
            by_run[name] = splits[n_splits:]
    finally:
        save_features.extract_image_features = real_extract

    # one batch's encode with nothing else running on the host, after the apps: its
    # time between CUDA events and its kernels' device time (torch.profiler); these
    # launches are not the path's, so the counts are put back
    (encode, input_size), = encoders
    launched = {k: f.launches for k, f in counters.items()}
    x = torch.zeros((JPEG_BATCH, input_size, input_size, 3), device="cuda")
    alone = {"alone_ms": cuda_time_ms(lambda: encode(x), 5, 1),
             "device_ms": sum(_device_kernels_ms(lambda: encode(x)).values()) or None}
    for k, f in counters.items():
        f.launches = launched[k]
    del encoders[:], encode, x

    test = build_dataset("caltech101", str(work / "data"), -1).test
    cores = os.cpu_count() or 1
    t0 = time.perf_counter()
    loader = {"native, 1 thread": loader_rate(test[:256], use_native=True, num_threads=1),
              f"native, {cores} threads": loader_rate(test[:512], use_native=True,
                                                      num_threads=cores),
              "PIL, 16 threads": loader_rate(test[:512], use_native=False)}
    times["loader_alone"] = time.perf_counter() - t0
    return {"times_s": times, "rows": rows, "stores": stores, "splits": by_run, "alone": alone,
            "launches": launches, "loader": loader, "cores": cores, "test": test,
            "data": work / "data", "work": work}


def check_jpeg_extract(out: dict) -> None:
    """Phase (r)'s gates, each reading beside its limit: the routes each
    extraction took, K5's and K6's launches (12 an image batch and a text
    chunk), the native store against the PIL run's (min cosine; not equal bit
    for bit; the train split's, PIL in both runs, equal bit for bit), the
    native library's pixels of the first ``JPEG_CPU_ROWS`` test files against
    PIL's ``EvalTransform`` of them, with two planted faults (the crop one
    pixel off, bilinear taps) read against the same limits, the stored native
    rows of those files against the f32 CPU model on those pixels, a planted
    fault (the pixels with the channel means applied in reversed order,
    encoded on the card) read against the same limit, and eval_clip's record;
    then the rates."""
    import numpy as np
    import torch

    from summer_clip_torch import native
    from summer_clip_torch.apps import save_features
    from summer_clip_torch.core import config as C
    from summer_clip_torch.data.transforms import CLIP_MEAN, CLIP_STD
    from summer_clip_torch.models.clip import build_clip
    from summer_clip_torch.store import FeatureStore

    failures = []

    def fail(msg):
        log(f"jpeg_extract FAILED: {msg}")
        failures.append(msg)

    rows, splits = out["rows"], out["splits"]
    routes = {k: [s["native"] for s in v] for k, v in splits.items()}
    log(f"jpeg_extract routes (train split, test split; native?): {json.dumps(routes)}")
    if routes.get("save_features_native") != [False, True] \
            or routes.get("save_features_pil") != [False, False]:
        fail(f"the runs took routes {routes}, expected the native library for the first run's "
             f"test split only")
    cfg = C.compose(Path(save_features.__file__).resolve().parent.parent / "conf",
                    "save_features", jpeg_argv(out["data"], out["stores"]["native"]))
    chunks = -(-JPEG_CLASSES * len(cfg.prompting.templates) // 256)   # zeroshot_classifier's
    batches = -(-rows["train"] // JPEG_BATCH) + -(-rows["test"] // JPEG_BATCH)
    for name, want in (("save_features_native", 12 * (batches + chunks)),
                       ("save_features_pil", 12 * (batches + chunks)),
                       ("eval_clip", 12 * chunks)):
        got = {k: v for k, v in out["launches"][name].items() if v}
        log(f"jpeg_extract {name} launches: {json.dumps(got)} (expected K5 = K6 = {want}: 12 "
            f"blocks x ({batches if name != 'eval_clip' else 0} image batches + {chunks} text "
            f"chunk))")
        if got != {"K5 fused_ln_attn": want, "K6 fused_ln_mlp": want}:
            fail(f"{name} launched {got}, expected K5 = K6 = {want}")

    nat, pil = FeatureStore(out["stores"]["native"]), FeatureStore(out["stores"]["pil"])

    def cosines(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        return (a * b).sum(1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))

    key = "caltech101_test-ViT-B16"
    a, b = nat.load(key, "features"), pil.load(key, "features")
    cos = cosines(a, b)
    same_train = np.array_equal(nat.load("caltech101_train-ViT-B16", "features"),
                                pil.load("caltech101_train-ViT-B16", "features"))
    log(f"jpeg_extract native test store ({len(a)} rows) against the PIL run's: min row cosine "
        f"{cos.min():.6f} (tol >= {TOL_JPEG_COS}), mean {cos.mean():.6f}, equal bit for bit: "
        f"{np.array_equal(a, b)} (must be False); the train split (PIL in both runs) equal bit "
        f"for bit: {same_train}")
    if len(a) != rows["test"] or cos.min() < TOL_JPEG_COS or np.array_equal(a, b) or not same_train:
        fail("the native store against the PIL run's")

    # the native library's own pixels of the first test files against PIL's
    t0 = time.perf_counter()
    paths = [d.impath for d in out["test"][:JPEG_CPU_ROWS]]
    pixels, ok = native.preprocess_batch(paths, 224)
    pix = jpeg_pixel_readings(paths, pixels)
    log(f"jpeg_extract the native library's pixels of the first {len(paths)} test files against "
        f"PIL's EvalTransform (normalized units): the largest per-image mean |d| "
        f"{pix['native'][0]:.6f} (tol <= {TOL_JPEG_PIX_MEAN}), max |d| {pix['native'][1]:.6f} "
        f"(tol <= {TOL_JPEG_PIX_MAX}); planted faults: "
        + "; ".join(f"{k} {m:.6f} ({m / TOL_JPEG_PIX_MEAN:.2f}x the limit) / {x:.6f} "
                    f"({x / TOL_JPEG_PIX_MAX:.2f}x)" for k, (m, x) in pix.items() if k != "native")
        + f" ({time.perf_counter() - t0:.2f} s)")
    if not ok.all() or pix["native"][0] > TOL_JPEG_PIX_MEAN or pix["native"][1] > TOL_JPEG_PIX_MAX:
        fail("the native library's pixels against PIL's")
    for k, (m, x) in pix.items():
        if k != "native" and m <= TOL_JPEG_PIX_MEAN and x <= TOL_JPEG_PIX_MAX:
            fail(f"the planted fault ({k}) passes the pixel gate")

    # the stored native rows of those files against the f32 CPU model on those pixels
    t0 = time.perf_counter()
    model, _ = build_clip("ViT-B/16", torch.Generator().manual_seed(0), device="cpu")
    with torch.inference_mode():
        ref = model.encode_image(torch.from_numpy(pixels)).numpy()
    del model
    card, _ = build_clip("ViT-B/16", torch.Generator().manual_seed(0), dtype=torch.bfloat16,
                         device="cuda")
    mean, std = np.asarray(CLIP_MEAN), np.asarray(CLIP_STD)
    faulty = ((pixels * std + mean) - mean[::-1]) / std   # the channel means in reversed order
    with torch.inference_mode():
        again = torch.cat([card.encode_image(torch.from_numpy(pixels[i:i + JPEG_BATCH]).cuda())
                           for i in range(0, len(pixels), JPEG_BATCH)]).float().cpu().numpy()
        fault = torch.cat([card.encode_image(
            torch.from_numpy(np.ascontiguousarray(faulty[i:i + JPEG_BATCH], np.float32)).cuda())
            for i in range(0, len(faulty), JPEG_BATCH)]).float().cpu().numpy()
    del card
    torch.cuda.empty_cache()
    stored = np.asarray(a[:JPEG_CPU_ROWS])
    got, bad = cosines(stored, ref).min(), cosines(fault, ref).min()
    log(f"jpeg_extract first {JPEG_CPU_ROWS} native test rows against the f32 CPU model on the "
        f"native library's pixels of those files: min cosine {got:.6f} (tol >= {TOL_JPEG_COS}); "
        f"the card's encode of the same pixels against the stored rows: max|d| "
        f"{np.abs(again - stored).max():.3e}; planted fault (the channel means applied in "
        f"reversed order) reads {bad:.6f}, {(1 - bad) / (1 - TOL_JPEG_COS):.1f}x the limit's "
        f"distance from 1 ({time.perf_counter() - t0:.2f} s)")
    if got < TOL_JPEG_COS:
        fail("the native store against the f32 CPU model")
    if bad >= TOL_JPEG_COS:
        fail("the planted fault passes the CPU gate")

    zero = records(out["work"] / "eval_clip", "zero_shot")
    log(f"jpeg_extract eval_clip over the native store: {zero}")
    if len(zero) != 1 or not 0.0 <= zero[0]["acc1"] <= zero[0]["acc5"] <= 100.0:
        fail(f"eval_clip's record missing or out of range: {zero}")

    card_name = card_line()
    host = (f"host: {out['cores']} cores (os.cpu_count), {len(os.sched_getaffinity(0))} "
            f"usable; card: {card_name}")
    times, alone = out["times_s"], out["alone"]
    log(f"jpeg_extract one batch's encode alone, after the apps: {alone['alone_ms']:.3f} ms "
        f"between CUDA events, "
        + (f"{alone['device_ms']:.3f} ms of kernel time" if alone["device_ms"] is not None else
           "kernel time not measured (the profiler saw no device time)") + f"; card: {card_line()}")
    for name in ("save_features_native", "save_features_pil"):
        n = sum(s["rows"] for s in splits[name])

        def busy(s):
            if alone["device_ms"] is None:
                return "the card's busy share not measured (the profiler saw no device time)"
            return (f"the card busy ~{s['batches'] * alone['device_ms'] / 1e3 / s['wall_s']:.3f} "
                    f"of it (an estimate: {s['batches']} batches x one batch's "
                    f"{alone['device_ms']:.3f} ms of kernel time, over the wall time)")

        parts = "; ".join(
            f"{'train' if i == 0 else 'test'} split ({'native' if s['native'] else 'PIL'}) "
            f"{s['rows'] / s['wall_s']:.1f} img/s, {s['wall_s']:.2f} s, {busy(s)}; the encode "
            f"calls span {s['span_s'] / s['wall_s']:.3f} of the split between CUDA events (the "
            f"card waiting on the host's launches)" for i, s in enumerate(splits[name]))
        log(f"jpeg_extract {name}: {n} images in {times[name]:.2f} s of the app, "
            f"{n / times[name]:.1f} img/s end to end (session set-up and text tower included); "
            f"{parts}; {host}")
    log("jpeg_extract the loader alone over test rows (EvalTransform 224, batch 32; 256 rows at "
        "1 thread, 512 otherwise): "
        + ", ".join(f"{k} {v:.1f} img/s" for k, v in out["loader"].items()) + f"; {host}")
    if failures:
        raise AssertionError("jpeg_extract: " + "; ".join(failures))


def ckpt_leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from ckpt_leaves(v, prefix + (k,))
        else:
            yield ".".join(prefix + (k,)), v


KERNELS = {
    # name: (source, TPU kernel it replaces, shape whose times stand in the kernels line)
    "K1 cache_dense": ("summer_clip_torch/csrc/cache_kernels.cu",
                       "summer_clip_tpu/ops/cache_kernels.py:103", "clip_search bf16"),
    "K2 labels_dense": ("summer_clip_torch/csrc/cache_kernels.cu",
                        "summer_clip_tpu/ops/cache_kernels.py:509", None),
    "K3 onehot_grouped": ("summer_clip_torch/csrc/cache_kernels.cu",
                          "summer_clip_tpu/ops/cache_kernels.py:394", None),
    "K4 short_attention_packed": ("summer_clip_torch/csrc/attention_kernels.cu",
                                  "summer_clip_tpu/ops/attention.py:248", "vit_l14_image"),
    "K5 fused_ln_attn": ("summer_clip_torch/csrc/block_kernels.cu",
                         "summer_clip_tpu/ops/block_kernels.py:255", "vit_b16_image"),
    "K6 fused_ln_mlp": ("summer_clip_torch/csrc/block_kernels.cu",
                        "summer_clip_tpu/ops/block_kernels.py:75", "vit_b16_image"),
    "K9 fused_ln_mlp_chunked": ("summer_clip_torch/csrc/block_kernels.cu",
                                "summer_clip_tpu/ops/block_kernels.py:132", "vit_l14_image"),
    "K12 short_attention": ("summer_clip_torch/csrc/attention_kernels.cu",
                            "summer_clip_tpu/ops/attention.py:195", "vit_l14_image"),
    "K7 streamed_qmatmul": ("summer_clip_torch/csrc/gemv_kernels.cu",
                            "summer_clip_tpu/ops/gemv.py:80", "mlp_c_fc R=1 int8"),
    "K10 fused_qmlp": ("summer_clip_torch/csrc/gemv_kernels.cu",
                       "summer_clip_tpu/ops/gemv.py:186", "R=1"),
    "K11 flash_attention": ("summer_clip_torch/csrc/attention_kernels.cu",
                            "summer_clip_tpu/ops/attention.py:87", "ppl_causal_f32"),
    "K8 decode_block": ("summer_clip_torch/csrc/decode_kernels.cu",
                        "summer_clip_tpu/ops/decode_block.py:723", "B=1 T=256 int8"),
    "K13 onehot_variant": ("summer_clip_torch/csrc/cache_kernels.cu",
                           "tools/sweep_onehot_variants.py:38", "split3"),
    "K14 blend_argmax_hits": ("summer_clip_torch/csrc/cache_kernels.cu",
                              "none: XLA fuses summer_clip_tpu/methods/tip.py:107-116", None),
}
TIP_PATH = ("K5 fused_ln_attn", "K6 fused_ln_mlp", "K3 onehot_grouped", "K2 labels_dense",
            "K14 blend_argmax_hits")
SEARCH_PATH = ("K1 cache_dense", "K2 labels_dense", "K3 onehot_grouped",
               "K4 short_attention_packed", "K5 fused_ln_attn", "K6 fused_ln_mlp")
GEN_PATH = ("K7 streamed_qmatmul", "K8 decode_block", "K10 fused_qmlp", "K11 flash_attention")
TRAIN_PATH = ("K4 short_attention_packed", "K5 fused_ln_attn", "K6 fused_ln_mlp",
              "K9 fused_ln_mlp_chunked")
TIP_IMAGENET_PATH = ("K3 onehot_grouped", "K5 fused_ln_attn", "K6 fused_ln_mlp",
                     "K14 blend_argmax_hits")
ONEHOT_SWEEP_PATH = ("K1 cache_dense", "K13 onehot_variant")


MAIN_PATHS = {"tip_adapter": TIP_PATH, "clip_search": SEARCH_PATH, "gen_gpt": GEN_PATH,
              "train_coop": TRAIN_PATH, "tip_adapter_imagenet": TIP_IMAGENET_PATH,
              "onehot_sweep": ONEHOT_SWEEP_PATH, "prompt_search": PROMPT_SEARCH_PATH,
              "multi_device": MULTI_PATH, "multi_device_train": MDT_PATH,
              "jpeg_extract": JPEG_PATH, "train_gpt": TRAIN_GPT_PATH, "int8_towers": INT8_PATH,
              "sandbox": SANDBOX_PATH}


def kernel_entry(name: str, results: dict, by_path: dict) -> dict:
    """``launches`` is the count over the main paths;
    ``launches_by_path`` gives each path's own."""
    src, replaces, shape = KERNELS[name]
    r = results[name]
    at_shape = {**r, **r["shapes"][shape]} if shape else r
    return {"name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": r["max_abs_err"],
            **{k: at_shape[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}}


def kernels_lines(results: dict, launches: dict) -> tp.Tuple[list, list]:
    """The kernels of the main paths and those off them, each with its
    launches by path; ``launches`` maps every name of ``MAIN_PATHS`` to that
    path's counts."""
    on_path = [n for n in KERNELS if any(n in path for path in MAIN_PATHS.values())]
    by_path = {n: {p: launches[p][n] for p in MAIN_PATHS} for n in KERNELS}
    return ([kernel_entry(n, results, by_path[n]) for n in on_path],
            [kernel_entry(n, results, by_path[n]) for n in KERNELS if n not in on_path])


def main(argv: tp.Optional[tp.Sequence[str]] = None) -> int:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description="Run the port on one CUDA card, end to end.")
    parser.add_argument("--only", choices=sorted(ONLY_SOURCES),
                        help="only build and run the checks of one kernel family, then stop "
                             "(no contract line): attention (K4, K11, K12 and the towers), "
                             "block (K5, K6, K9 and the towers), cache (K1, K2, K3, K13, "
                             "K14) or "
                             "decode (K7, K10, K8)")
    parser.add_argument("--baseline", metavar="CU", nargs="+",
                        help="with --only: earlier copies of its sources (attention_kernels.cu, "
                             "block_kernels.cu, cache_kernels.cu; gemv_kernels.cu and/or "
                             "decode_kernels.cu), each built against the headers beside it and "
                             "timed in turns beside this tree's kernels in the checks")
    args = parser.parse_args(argv)
    if args.baseline and not args.only:
        parser.error("--baseline needs --only (the source it is an earlier copy of)")
    try:
        old = {baseline_source(args.only, cu): cu for cu in args.baseline or ()}
    except ValueError as exc:
        parser.error(str(exc))
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script runs only on a "
              "CUDA card", file=sys.stderr)
        return 2
    started = time.perf_counter()
    card = card_line()
    log(f"card: {card}")
    log(versions())
    read_card_clock()
    log(f"SMs {CARD['sms']}, max SM clock {CARD['sm_clock_hz'] / 1e6:.0f} MHz: "
        f"{exp_rate():.3e} exponentials/s")

    from summer_clip_torch.ops import _lib

    torch.backends.cuda.matmul.allow_tf32 = False   # plain f32 products stay f32
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    sources = ONLY_BUILDS[args.only] if args.only else KERNEL_SOURCES
    # one nvcc a source, and g++ for the native library
    with concurrent.futures.ThreadPoolExecutor(len(sources) + len(old) + 1) as pool:
        builds = [pool.submit(_lib.build, name, True) for name in sources]
        baselines = {name: pool.submit(load_baseline, cu, name) for name, cu in old.items()}
        # the native JPEG library (g++) beside them, for phase (r)
        preprocess = None if args.only else pool.submit(build_native)
        for b in builds:
            b.result()
        BASELINE.update({name: b.result() for name, b in baselines.items()})
        if preprocess is not None:
            log(preprocess.result())
    log(f"phase build: {time.perf_counter() - t0:.2f} s")

    results: dict = {}
    t0 = time.perf_counter()
    if args.only:
        if args.only == "attention":
            check_flash_kernels(results)
            check_attention_kernels(results)
        elif args.only == "block":
            check_block_kernels(results)
        elif args.only == "decode":
            check_gemv_kernels(results)
            check_decode_block(results)
        else:
            check_cache_kernels(results)
            check_blend_argmax(results)
            check_dense_cache_kernel(results)
            check_onehot_variant(results)
        if args.only in ("attention", "block"):
            time_towers(results)
        log(f"phase {args.only}: {time.perf_counter() - t0:.2f} s")
        log(f"card: {card}")
        print(json.dumps({args.only: results}))
        return 0
    check_gemv_kernels(results)
    check_decode_block(results)
    check_flash_kernels(results)
    check_block_kernels(results)
    check_attention_kernels(results)
    check_cache_kernels(results)
    check_blend_argmax(results)
    check_dense_cache_kernel(results)
    t1 = time.perf_counter()
    check_onehot_variant(results)
    log(f"phase K13: {time.perf_counter() - t1:.2f} s")
    time_towers(results)
    check_resnet_tower(results)
    log(f"phase kernels: {time.perf_counter() - t0:.2f} s")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        pipe, tip_launches = counted("tip_adapter ViT-B/16", TIP_PATH,
                                     lambda: run_pipeline(Path(tmp) / "tip"))
        cos, _ = check_against_cpu(pipe["store"], "ViT-B/16", n=4)
        log(f"stored ViT-B/16 features vs f32 CPU model: min cosine {cos:.6f} (tol >= 0.99)")
        if cos < 0.99:
            raise AssertionError("stored ViT-B/16 features disagree with the f32 model")

        search, search_launches = counted("clip_search ViT-L/14", SEARCH_PATH,
                                          lambda: run_clip_search(Path(tmp) / "search"))
        # synthetic_1k: 2000 + 1000 images, synthetic: 32 + 16, in batches of 32
        batches = -(-2000 // 32) + -(-1000 // 32) + 1 + 1
        if search_launches["K4 short_attention_packed"] != 24 * batches:
            raise AssertionError(f"K4 launched {search_launches['K4 short_attention_packed']} "
                                 f"times, expected 24 x {batches} image batches")
        t0 = time.perf_counter()
        cos, outs_err = check_against_cpu(search["store"], "ViT-L/14", n=2, outs=True)
        log(f"stored ViT-L/14 features vs f32 CPU model: min cosine {cos:.6f} (tol >= 0.99); "
            f"stored zero-shot scores vs the f32 CPU text classifier: max|d| {outs_err:.3e} "
            f"(tol {TOL_OUTS_VS_CPU}), {time.perf_counter() - t0:.2f} s")
        if cos < 0.99 or outs_err > TOL_OUTS_VS_CPU:
            raise AssertionError("stored ViT-L/14 features or scores disagree with the f32 model")

        counters = launch_counters()
        gen, gen_launches = counted(
            "gen_gpt gpt2-large int8", GEN_PATH,
            lambda: run_gen_gpt(Path(tmp) / "gen", lambda: {k: f.launches for k, f in counters.items()}))
        check_gen_gpt(gen)

        with shared_towers():
            train, train_launches = counted(
                "train_coop ViT-L/14", TRAIN_PATH,
                lambda: run_training(Path(tmp) / "train", search["store"], pipe["store"],
                                     Path(tmp) / "gen" / "ckpt" / "step_0",
                                     lambda: {k: f.launches for k, f in counters.items()}))
        t0 = time.perf_counter()
        cos, _ = check_against_cpu(train["store"], "ViT-L/14", n=2, ds_name="synthetic_1k")
        log(f"stored ViT-L/14 features in mlp mode vs f32 CPU model: min cosine {cos:.6f} "
            f"(tol >= 0.99), {time.perf_counter() - t0:.2f} s")
        if cos < 0.99:
            raise AssertionError("stored mlp-mode ViT-L/14 features disagree with the f32 model")
        t0 = time.perf_counter()
        check_training(train.pop("trainer"))
        log(f"phase check train_coop: {time.perf_counter() - t0:.2f} s")

        search_sizes = prompt_search_sizes(search["store"], Path(tmp) / "search", pipe["store"],
                                           Path(tmp) / "gen" / "ckpt" / "step_0")
        with shared_towers():
            prompts, prompts_launches = counted(
                "prompt_search", PROMPT_SEARCH_PATH,
                lambda: run_prompt_search(Path(tmp) / "prompt_search", search_sizes,
                                          lambda: {k: f.launches for k, f in counters.items()}))
        t0 = time.perf_counter()
        check_prompt_search(prompts)
        log(f"phase check prompt_search: {time.perf_counter() - t0:.2f} s")

        lm, lm_launches = counted("train_gpt gpt2-large", TRAIN_GPT_PATH,
                                  lambda: run_train_gpt(Path(tmp) / "train_gpt"))
        t0 = time.perf_counter()
        check_train_gpt(lm, lm_launches)
        del lm
        log(f"phase check train_gpt: {time.perf_counter() - t0:.2f} s")

        towers, int8_launches = counted("int8_towers ViT-B/16 RN50", INT8_PATH,
                                        lambda: run_int8_towers(Path(tmp) / "int8"))
        t0 = time.perf_counter()
        check_int8_towers(towers, int8_launches)
        log(f"phase check int8_towers: {time.perf_counter() - t0:.2f} s")

        _, sweep_launches = counted("onehot_sweep", ONEHOT_SWEEP_PATH, run_onehot_sweep)
        # K1 warm-up + timed; 3 arms x 2 blockings of K13, warm-up + timed each
        if (sweep_launches["K13 onehot_variant"], sweep_launches["K1 cache_dense"]) != (12, 2):
            raise AssertionError(f"onehot_sweep launched K13 {sweep_launches['K13 onehot_variant']}"
                                 f" and K1 {sweep_launches['K1 cache_dense']} times, expected 12, 2")

        t0 = time.perf_counter()
        _, tipi_launches = counted("tip_adapter_imagenet RN50", TIP_IMAGENET_PATH,
                                      lambda: run_tip_imagenet(Path(tmp) / "tip_imagenet"))
        if (tipi_launches["K3 onehot_grouped"], tipi_launches["K2 labels_dense"],
                tipi_launches["K14 blend_argmax_hits"]) != (TIP_IMAGENET_K3, 0, TIP_IMAGENET_K14):
            raise AssertionError(f"tip_adapter_imagenet launched K3 "
                                 f"{tipi_launches['K3 onehot_grouped']}, K2 "
                                 f"{tipi_launches['K2 labels_dense']} and K14 "
                                 f"{tipi_launches['K14 blend_argmax_hits']} times, expected "
                                 f"{TIP_IMAGENET_K3}, 0 and {TIP_IMAGENET_K14}")
        check_tip_imagenet(Path(tmp) / "tip_imagenet")
        log(f"phase tip_adapter_imagenet: {time.perf_counter() - t0:.2f} s")

        t0 = time.perf_counter()
        run_analysis(search["store"], Path(tmp) / "analysis")
        log(f"phase analysis: {time.perf_counter() - t0:.2f} s")

        sandbox, sandbox_launches = counted(
            "sandbox gpt2-large", SANDBOX_PATH,
            lambda: run_sandbox(Path(tmp) / "sandbox",
                                lambda: {k: f.launches for k, f in counters.items()}))
        t0 = time.perf_counter()
        check_sandbox(sandbox)
        log(f"phase check sandbox: {time.perf_counter() - t0:.2f} s")

        t0 = time.perf_counter()
        md = run_multi_device(Path(tmp) / "multi_device", Path(tmp) / "search", pipe["store"], gen)
        md_launches = check_multi_device(md, Path(tmp) / "search", gen)
        log(f"phase multi_device: {time.perf_counter() - t0:.2f} s")

        t0 = time.perf_counter()
        mdt = run_multi_device_train(Path(tmp) / "multi_device_train", Path(tmp) / "train_gpt")
        mdt_launches = check_multi_device_train(mdt, Path(tmp) / "multi_device_train")
        log(f"phase multi_device_train: {time.perf_counter() - t0:.2f} s")

        t0 = time.perf_counter()
        jpeg, jpeg_launches = counted("jpeg_extract ViT-B/16 caltech101", JPEG_PATH,
                                      lambda: run_jpeg_extract(Path(tmp) / "jpeg"))
        check_jpeg_extract(jpeg)
        log(f"phase jpeg_extract: {time.perf_counter() - t0:.2f} s")

    kernels, off_path = kernels_lines(results, {
        "tip_adapter": tip_launches, "clip_search": search_launches, "gen_gpt": gen_launches,
        "train_coop": train_launches, "tip_adapter_imagenet": tipi_launches,
        "onehot_sweep": sweep_launches, "prompt_search": prompts_launches,
        "train_gpt": lm_launches, "int8_towers": int8_launches, "sandbox": sandbox_launches,
        "multi_device": md_launches, "multi_device_train": mdt_launches,
        "jpeg_extract": jpeg_launches})
    log(f"chip_smoke: {time.perf_counter() - started:.1f} s in all; card: {card}")
    # ported kernels that no main path runs: checked and timed above, listed apart
    print(json.dumps({"kernels_off_the_main_paths": off_path}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if "PYTHONHASHSEED" not in os.environ:
        # the synthetic datasets draw each image from hash(path): one hash seed
        # for every call, so that every call draws the same images
        os.execve(sys.executable, [sys.executable, *sys.argv],
                  {**os.environ, "PYTHONHASHSEED": "0"})
    sys.exit(main())
