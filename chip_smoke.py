#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase; needs one CUDA card
    python3 chip_smoke.py --zero-only  # phases 1 and 25 (--zero across
                                       # the visible cards) alone
    python3 chip_smoke.py --gspmd-only  # phases 1 and 26 (--zero1,
                                        # --fsdp, --model_parallel) alone
    python3 chip_smoke.py --sp-only  # phases 1 and 27 (train_lm
                                     # --parallel sp) alone
    python3 chip_smoke.py --mp-only  # phases 1 and 28 (train_lm
                                     # --parallel pp|tp, --zero, --remat)
                                     # alone
    python3 chip_smoke.py --moe-only  # phases 1 and 29 (train_lm
                                      # --n_experts in every mode) alone
    python3 chip_smoke.py --heal-only  # phases 1, 2 and 30 (restarts,
                                       # SIGTERM, sharded checkpoints,
                                       # peer loss, --profile) alone
    python3 chip_smoke.py --tp-only  # phases 1 and 31 (serve_lm --tp
                                     # across the visible cards) alone
    python3 chip_smoke.py --serve-heal-only  # phases 1, 2 and 32
                                             # (fault-tolerant serving)
    python3 chip_smoke.py --scope-only  # phases 1, 2 and 33
                                        # (observability) alone
    python3 chip_smoke.py --fleet-only  # phase 33's [fleet-xcard] alone
                                        # (four cards)
    python3 chip_smoke.py --gen-only  # phases 1 and 34 (ragged generate,
                                      # beam search, HF interop, ViT's
                                      # ring) alone
    python3 chip_smoke.py --vit-seq-only  # phase 34's [vit-seq] alone
                                          # (degree 2 and 4 need cards)

Phases (each prints its lines; any failure raises and exits non-zero,
nothing is caught):

1. device  — CUDA present; the card's name and power limit as
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
   prints them.
2. build   — every kernel of ``ops/csrc`` compiled from the checkout,
   one ``nvcc`` per source started together; build seconds; the
   ``-Xptxas -v`` lines, and the registers and spills of each of the 27
   decode instantiations (split kernel: dense/paged x model dtype/int8 x
   f32/bf16 q x Dh 32/64/128; merge kernel: Dh 32/64/128), of the 18
   flash instantiations (forward, dq, dk/dv x bf16/f32 x Dh 32/64/128;
   serialised ``wgmma``, ptxas's C7512, named) and of the 4 ring
   kernels (one rank per card and loopback, 8 or 16 data warps).
3. kernel  — the decode-attention kernels (row 1: the split-K
   ``decode_split_kernel``, and ``decode_merge_kernel`` where the window
   spans more than one split; each line names the cut) against their
   plain PyTorch version at gpt_small decode shapes (8 slots, 12 heads,
   Dh 64), KV windows 16/64/256/1024 with ragged positions including 0,
   W-1 and one beyond the window, in f32 and bf16; two calls, and one
   call captured in a CUDA graph and replayed, give the eager bits.
   Device times per call (CUDA graph of 20 calls replayed 100 times
   between CUDA events, median) of the kernel with its window L2-warm
   and L2-cold (the 20 calls cycle through copies of the inputs whose
   bytes exceed the 50 MB L2 twice), the plain version and the library
   yardstick ``F.scaled_dot_product_attention`` (timed here only; the
   port never calls it), beside the HBM-bytes bound; and the kernel's
   eager per-call time (median of 100 single calls, host launch cost
   included).
4. serve   — the port's ``serve_lm.main`` (its normal entry) on
   full-width gpt_small, random weights from a seed, bf16, 8 slots, 16
   synthetic requests, 32 new tokens each, decode horizon 4. Every
   request must complete and the kernel must have launched exactly
   ``num_layers`` times per decode step; tokens/s and TTFT p50/p99 from
   the run's metrics.
5. exact   — gpt_small in f32 (TF32 off for matmuls and cuDNN): 4
   requests through the engine are token-exact with the port's
   ``generate``.
6. flash   — the three flash-attention kernels (forward, dq, dk/dv)
   against their plain versions at the training slice's shapes (B 8,
   H 12, Dh 64, S 1024, causal) in bf16 and f32, plus a ragged
   non-causal case (Sq 197, Skv 300), S 129 (one row past the bf16
   kernels' 64-row tiles and their 128-row CTAs) and Dh 32/128; the
   forward (output and lse) and the backward pair each bit-equal over
   two calls at the main shapes, in bf16 and f32;
   there each kernel's device time (CUDA graph), eager time, the plain
   version's time, its TFLOP/s, the library yardstick's
   (``F.scaled_dot_product_attention``, and autograd through it minus
   its forward for the backward pair; timed here only, the port never
   calls it) and the bound ``max(flops / peak, bytes / HBM rate)`` (the
   f32 peak is 3xTF32 on the tensor cores, 495 / 3 TFLOP/s, the card's
   fastest exact-f32 route; the CUDA cores' 67 TFLOP/s FMA bound is
   printed beside it); the forward against SDPA's forward; and the pair
   plus ``flash_dterm`` (the backward's torch ops beside the pair)
   against SDPA's backward, whose own dO.O pass is inside its time. In
   f32 (all three kernels 3xTF32 ``wgmma`` fed by TMA) also each
   kernel's largest error at a peaky softmax (q and k x 4; the forward's
   out and lse apart), printed, not asserted.
7. train   — the port's ``train_lm.main`` (its normal entry) on
   full-width gpt_small, random init from seed 0, bf16, batch 8 x 1024
   tokens, lr 0.01, 1 epoch of the default 200 000-token synthetic corpus
   with ``--val_frac 0.1``: 21 train steps and 2 eval batches. Every step
   ran, the forward kernel launched 12 times per train step and per eval
   batch and each backward kernel 12 times per train step, the epoch's
   loss is finite and below the first printed loss, and ``train.log``,
   ``test.log``, ``model_1.pth`` and its sidecar exist; tokens/s and the
   steady step time.
7b. train-f32 — phase 7 with ``train_lm``'s default ``--dtype
   float32``: the 3xTF32 forward and backward pair at full width, with
   the same launch counts, loss check and files asserted;
   tokens/s and the steady step time.
8. train-exact — gpt_small at 2 layers in f32 (TF32 off): 3 SGD steps
   through the kernels (``attn_impl="flash"``) and through the plain
   masked softmax (``"xla"``) from the same params and batches agree in
   loss and params.
9. sgd     — the fused SGD kernel against its plain version at N =
   4,903,242 (ResNet-18's parameters) and a ragged N = 1,000,003, over 4
   steps (the first with init 0, two more, one with keep False), Nesterov
   on and off: bit-equal (tolerance 0). At the ResNet-18 N: the kernel's
   device time (CUDA graph), its eager time, the plain version's, the
   HBM-bytes bound (5 x 4 B per element), and the library yardstick
   ``torch._fused_sgd_`` — the one kernel ``torch.optim.SGD(...,
   nesterov=True, fused=True).step()`` launches (timed here only; the
   port never calls it; the eager ``step()`` is printed beside it).
10. image-train — the port's ``main.main`` (its normal entry) on
   full-width ResNet-18 ([1,1,1,1], 64-512 channels, 10 classes), random
   init from seed 0, f32 with PyTorch's default TF32 convolutions (the
   CLI's setting), ``--optimizer sgd_fused``, ``--world_size 1``,
   ``PMDT_SMALL_SYNTH=8192`` (8,192 train and 2,048 test images), batch
   64, 1 epoch: 128 train steps and 32 eval batches. The kernel launched
   once per train step, the epoch loss is finite and below the first
   printed loss, and ``train.log``, ``test.log``, ``model_1.pth``, the
   two PNGs and the ``main.py`` snapshot exist; images/s and the steady
   step time.
11. image-exact — ResNet-18 in f32 (TF32 off for matmuls and cuDNN,
   deterministic cuDNN): 3 steps with ``sgd`` and 3 with ``sgd_fused``
   from the same weights and batches of 64 agree in losses, params and
   BN running stats.
12. paged-kernel — the int8 dense variant (row 1q) and the paged
   variants, model dtype and int8 (rows 2 and 2q), on the same split-K
   kernels, against their plain versions at gpt_small decode shapes (8
   slots, 12 heads, Dh 64), page size 16, windows 64/256/1024, ragged
   positions including 0, W-1 and one beyond the window, shuffled page
   tables whose unallocated entries point at a scratch page 0 of NaN (K)
   and 1e30 (V), in f32 and bf16; two calls and a graph replay give the
   eager bits. A dense window and the same columns in shuffled pages
   give the same bits (model dtype and int8, f32 and bf16, each window).
   At W=1024 in bf16, per variant: device time (CUDA graph; L2-warm and
   L2-cold), eager time, the plain version's time, the bound and the
   library yardstick ``F.scaled_dot_product_attention`` on the already
   gathered and dequantized dense window (timed here only; the port
   never calls it). Then where row 1's device time goes between its
   split and merge kernels (``torch.profiler`` over 20 eager calls), and
   the A/B of the split size (64, 128 and 256 keys a CTA; 128 is the
   default) for rows 1, 1q, 2 and 2q at bf16 W=1024, timed in turns (64,
   128, 256, 256, 128, 64), L2-warm and L2-cold, each checked against
   its plain version first, as ``[decode-ab]`` lines.
13. serve-paged — ``serve_lm.main`` on full-width gpt_small, random
   weights from seed 0, bf16, 8 slots, 16 synthetic requests of 32 new
   tokens, decode horizon 4, three times: ``--kv_layout paged
   --page_size 16 --prefix_cache 8 --num_pages 64``, the same with
   ``--kv_dtype int8``, and dense ``--kv_dtype int8``. Every request
   completes; the run's kernel variant launches exactly 12 times per
   decode step and no other variant launches; after the drain only the
   prefix cache holds pages. Tokens/s, TTFT p50/p99 and the pool's bytes
   against the dense pool's.
14. paged-exact — gpt_small in f32 (TF32 off): 4 requests through the
   paged engine, the dense engine and ``generate`` are token-exact; a
   repeated prompt (full prefix hit) and one that diverges after its
   first page (partial hit) are token-exact with ``generate``; the int8
   paged engine equals the int8 dense engine token for token.
15. verify-kernel — the k-query verify variants of speculative decode,
   dense (row 3) and paged (row 4), model dtype and int8, against their
   plain versions at K1 = 5 query rows (draft_k 4), gpt_small decode
   shapes (8 slots, 12 heads, Dh 64), windows 64/256/1024, page size
   16, positions including 0, one whose last row lands on the window's
   last column and one whose rows reach past it, shuffled tables over a
   scratch page 0 of NaN (K) and 1e30 (V), in f32 and bf16; two calls
   give the same bits; the dense window laid out in shuffled pages gives
   the dense variant's bits (model dtype and int8, f32 and bf16, each
   window). At W=1024 in bf16, per variant: device time (CUDA graph),
   eager time, the plain version's time, the bound ``max(4 K1 n Dh flops
   / peak, bytes / HBM rate)`` over the rows' reach, and the library
   yardstick ``F.scaled_dot_product_attention`` with the row-staggered
   boolean mask on the already gathered and dequantized window (timed
   here only; the port never calls it). Then row 3 in bf16 at W=1024
   for K1 = 2, 5, 9 and 16 (error, times, bound), and the A/B of the
   split size (64, 128 and 256 keys a CTA; 128 is the default) for the
   four variants at the main shape, timed in turns (64, 128, 256, 256,
   128, 64), each checked against its plain version first; and where
   row 3's device time goes between its split and merge kernels
   (``torch.profiler`` over 20 eager calls).
16. serve-spec — ``serve_lm.main`` on full-width gpt_small, random
   weights from seed 0, bf16, 8 slots, 16 synthetic requests of 32 new
   tokens, decode horizon 4, ``--draft_k 4``, five times: self-drafting
   dense, dense ``--kv_dtype int8``, paged (phase 13's flags), paged
   int8, and ``--draft_model gpt_tiny --s_max 256`` (draft-model mode,
   random draft weights from seed 1). Every request completes; the run's
   verify variant launches exactly 12 times per armed pass and its
   decode variant 12 times per k=0 pass (plus, in draft-model mode, the
   draft's 4 layers x 5 steps of the dense decode kernel per armed
   pass), counted from the passes the engine launched at each k, and no
   other variant launches. Tokens/s, acceptance, TTFT p50/p99 beside the
   same run without ``--draft_k``, and the share of requests whose bf16
   transcript equals that run's (printed, not asserted: the verify pass
   runs the projections on 5-row blocks, where cuBLAS may round
   otherwise).
17. spec-exact — gpt_small in f32 (TF32 off): 4 requests and one that
   ends at s_max through the speculative engine (draft_k 4, horizon 4):
   dense, paged and draft-model mode (the target as its own draft) are
   token-exact with ``generate``; int8 paged equals int8 dense and the
   non-speculative int8 engine.

18. ring-loopback — the pipelined ring all-reduce kernel in its
   single-card form (n ranks in one cooperative launch of
   ``ring_loopback_kernel``) against its plain version on the card at
   n = 2, 4 and 8: 50 consecutive calls each, on fresh inputs cycling
   through (40, 33), 1, 3,007, 4,903,242 (ResNet-18's parameters) and
   1,000,003 elements, f32 then bf16: bit-equal (tolerance 0). At
   n = 4, N = 4,903,242 f32: the blocks a rank the launch keeps
   resident (``G_loop``), the kernel's device time in place on a
   prepared ``[n, padded]`` buffer (CUDA events around 20 back-to-back
   launches: the cooperative launch is not captured into a graph), the
   wrapper's device and eager times, the plain version's, the library
   yardstick ``torch.sum`` over the stacked ranks (timed here only; the
   port never calls it) and the HBM bound (each rank's payload read once
   and its result written once). Then the ``allreduce_bw`` entry with
   ``--loopback 4`` at that N: 21 launches (a warm-up and 20 timed
   calls); then the kernel's settings (blocks, data threads, step,
   slots, control warps: the defaults, then each changed alone over
   ``RING_AB_VALUES``) timed in turns through ``--ring_configs`` as
   ``[ring-ab]`` lines.
19. ring-xcard — the peer-access matrix of the visible cards and what
   ``nvidia-smi`` reports of their links (``topo -m``, ``nvlink
   --status``); then, only with two or more cards visible (else one line
   says so), the ``allreduce_bw`` entry on min(cards, 4) processes, one per
   card, ``--ring --check`` at N = 4,903,242, 64 MiB and 4 KiB: the
   kernel over peer memory (``ring_kernel``) bit-equal to the plain
   version of every rank's seeded inputs, its time, bus GiB/s and cut
   (blocks, steps a hop) beside NCCL ``all_reduce`` (``psum_``, the
   library yardstick; the ring never calls it) and the NVLink bound
   (2(n-1)/n of the payload each way at 450 GB/s), and its launches;
   the per-rank comm buffer's bytes (fixed, allocated once); and the
   same settings' A/B in turns at the first two payloads.
20. imagenet — ``main.main`` on ``bench.py``'s ``resnet50_imagenet``:
   ResNet-50 with the ImageNet stem, the CLI's f32 (TF32 convolutions),
   ``--optimizer sgd_fused``, batch 256 on the synthetic ImageNet set at
   224 under ``PMDT_SMALL_SYNTH=1`` (1024 train, 256 test images: 4
   steps, one eval batch); images/s per card, the first and last loss
   (finite, or the phase fails), peak memory; the fused SGD kernel once
   a step, then held bit for bit against its plain version at
   ResNet-50's N (25,557,032) and timed beside ``torch._fused_sgd_`` and
   its HBM bound; the host time of one synthetic batch.
21. convnext — the same for ``convnext_lamb``: ConvNeXt-T, 21,841
   classes, ``--optimizer lamb``, bf16, batch 256.
22. vit — the same for ``vit_b16_imagenet``: ViT-B/16, bf16, batch 256,
   on the einsum attention the CLI builds; then one ViT-B/16 encoder
   block with ``flash=True`` against the same block with ``flash=False``,
   forward and backward, at B 8, S 197 (f32 within phase 6's gradient
   tolerance; bf16 both against the f32 block, the flash route at most
   twice as far off as the einsum one), and the non-causal bf16 flash
   forward at B 64, H 12, S 197, Dh 64 timed beside SDPA's.
23. head-dim — every attention row (1-7, and 1q-4q) launched and held
   against its plain version at Dh 16, 48, 80, 96, 112 and 20 (20: no
   whole 16-byte row in bf16 or int8, so the wrapper pads it), f32 and
   bf16, causal and not for rows 5-7; Dh 160 refused; each row's device
   time at Dh 48, 64 and 96 (``[head-dim-time]``); a GPT of hidden 512
   and 32 heads (Dh 16) through 3 f32 SGD steps, flash against the
   plain attention at phase 8's tolerances, and 4 requests through the
   engine token-exact with ``generate``.
24. transforms — ``main.main`` on ``resnet50_imagenet`` as phase 20 with
   ``--optimizer sgd_fused --grad_accum 2 --clip_grad_norm 1.0 --ema
   0.999 --remat --torch_export``: images/s per card, the first and last
   loss (finite, or the phase fails), the fused SGD kernel once an
   optimizer step, peak memory beside phase 20's, and the exported
   ``model_1.torch.pth`` read back into the port's ResNet-50, equal to
   the checkpoint's final params and BN stats; one ResNet-50 step at the
   microbatch (128) with and without ``remat``, its peak memory each
   way; then ResNet-18 on CIFAR-10 shapes, batch 512, f32 (TF32 off,
   deterministic cuDNN) with the same transforms: 3 steps on
   ``sgd_fused`` bit-equal to 3 on ``sgd`` (params, momenta, BN stats,
   EMA), and one step with ``remat`` bit-equal to one without (params
   and BN stats), with each one's peak memory.
25. zero — ``main.main --zero`` (graftzero's sharded update) on ResNet-18
   / synthetic CIFAR-10, batch 512, one step and 4 steps, ``--optimizer
   sgd`` and ``lamb``, each beside the same run without ``--zero``: with
   two or more cards visible on min(cards, 4) NCCL ranks, one a card
   (else one line says so, and one rank holds the one shard, bit-equal
   to the plain run); the largest parameter and moment differences
   against their tolerances (after one step they differ by the order of
   the reduction's sums only), each rank's optimizer-state bytes beside
   the plain run's and the plan's static collective bytes; and the
   ``--zero`` checkpoint resumed by a plain run for a second epoch,
   beside the plain run's own second epoch.
26. gspmd — ``main.main`` with the GSPMD placements on ResNet-18 /
   synthetic CIFAR-10, f32 (TF32 off, deterministic cuDNN), batch 512,
   ``--optimizer sgd`` (lr 0.01) and ``lamb`` (lr 0.001), 4 epochs of
   one step with a checkpoint each (after 1 and after 4 steps), on NCCL
   ranks, one a card, laid out as a ``(data, model)`` grid over
   min(cards, 4) cards: ``--zero1`` and ``--fsdp`` at (W, 1); with two
   or more cards ``--model_parallel 2`` at (1, 2); with four,
   ``--model_parallel 2 --zero1`` at (2, 2) and ``--model_parallel 4``
   at (1, 4) (the 10-class head stays whole there). Each beside the
   plain run at the same data degree: the largest parameter, moment and
   BN-stat differences after 1 step (the order of the reduction only)
   and after 4; each rank's resident bytes of params, stats and moments
   beside JAX's per-device bytes of that placement (``JAX_RESIDENT``,
   held against JAX's ``state_shardings`` by a CPU test) and equal to
   them; peak memory per rank; the 4-step run's wall time beside the
   plain run's. On one card the grid is (1, 1) (one line says so) and
   each mode is bit-equal to the plain run. Then one ResNet-50
   ``--fsdp`` step at 224, batch 128, on the visible cards (the step
   API, a random batch): its peak memory and resident bytes beside the
   plain step's.
27. sp — sequence parallelism (``train_lm --parallel sp``). On one card,
   gpt_small at B 8 x S 1024, bf16 and f32, one step of the SP step on a
   1 x 1 ``(data, seq)`` grid in each ``sp_mode`` beside the plain DP
   step from the same params: ring and ulysses bit-equal (params after
   the step, loss), zigzag within ``SP_ZIGZAG_TOL``, and the flash
   launches of the step equal to the hop schedule (12 layers x 1, 3, 1
   of each kernel); ``--vocab_chunks 8`` beside the dense head (loss
   within ``SP_CHUNK_LOSS_TOL``, the step's peak memory lower); the
   non-causal bf16 forward (and the backward pair) at a hop's shape, B 8
   H 12 S 256 Dh 64 (gpt_small's S 1024 over four ranks), timed beside
   SDPA's (``[sp-hop]``); gpt_lm_long's geometry (gpt_small at
   max_seq_len 4096, bf16, B 2 x S 4096) through the plain step on one
   card: 3 steps, losses, step time, peak memory. With two or more
   cards, on W = min(cards, 4) NCCL ranks, one a card: the CLI
   ``train_lm --model gpt_small --dtype bfloat16 --batch_size 8
   --seq_len 1024 --parallel sp --degree W`` in each mode beside
   ``--parallel dp`` on the same ranks (first loss, tokens/s, peak
   memory a card, and each rank's flash launches equal to the schedule:
   ring ``i + 1`` a layer a step on seq rank ``i``, zigzag ``2W + 1``,
   ulysses 1), then gpt_lm_long's geometry through the SP step at degree
   W in each mode beside the one-card DP step (losses within
   ``SP_LONG_LOSS_TOL``, step time, peak memory a card).
28. mp — ``train_lm``'s model-parallel modes on gpt_small, B 8 x S 1024,
   ``MP_STEPS`` steps from seed 0's params. On one card, bf16 and f32:
   the plain DP step, then at degree 1 the pipelined step (gpipe and
   1f1b; within ``MP_PP_TOL`` of it), the tensor-parallel step (plain,
   ``--zero1``, ``--fsdp``), ``--zero`` and ``--remat`` (each bit-equal
   to it); each run's flash launches a step equal to the schedule's (12
   a kernel, the forward 24 under 1f1b and remat), its resident bytes
   equal to JAX's placement's (``MP_JAX_RESIDENT``), its peak memory and
   step time. Across W cards (4 where four are visible, else 2; one
   NCCL rank a card): pp (gpipe, 1f1b) and tp (plain, ``--zero1``,
   ``--fsdp``) at degree 2 and W, bf16 and f32, each rank's launches and
   resident bytes asserted, losses and params within ``MP_XCARD_TOL``
   of the one-card plain step. Then ``train_lm --parallel pp|tp
   --degree W`` through the CLI (one card: degree 1): an epoch with a
   checkpoint, ``--resume auto`` into a second with ``--val_frac`` and
   ``--sample 8`` at S 1016 (the sample fits max_seq_len; launches, the
   resumed epoch and the sample asserted).
29. moe — Mixture of Experts. The full-width MoE layer (B 8, S 1024, D
   768, H 3072, E 8; top-1 and top-2; f32 and bf16) on the card against
   the same module on the CPU: the share of routes that agree and the
   largest error over the tokens whose routes and kept slots agree
   (``MOE_LAYER_TOL``), its forward and forward + backward times. At
   degree 1 on one card (gpt_small with 8 top-1 experts, B 8 x S 1024,
   ``MOE_STEPS`` steps from seed 0's params, bf16 and f32): the plain
   MoE step, sp (ring, ulysses), tp, ``--remat`` and ``--zero`` bit-equal
   to it (losses, balance losses and params), pp (gpipe, 1f1b) within
   ``MP_PP_TOL``; launches a step as scheduled; the plain bf16 step
   profiled (``profile_train_lm``'s groups and the MoE layers' share)
   beside the dense gpt_small bf16 step of the same run. Through the
   CLI, ``train_lm --n_experts 8`` and ``--moe_top_k 2`` (bf16, lr
   0.01): 4 steps and an eval batch with their Aux column, step time and
   peak memory, then ``--resume auto`` at S 1016 with ``--sample 8``
   (the dropless decode: 12 decode-kernel launches a decode step).
   Across W cards (4 where four are visible): tp at (1, W) in f32 held
   against one card (``MP_XCARD_TOL``; resident bytes =
   ``MOE_JAX_RESIDENT``), pp gpipe and sp ring at degree W reported
   beside one card's losses (a per-shard balance loss and capacity,
   JAX's semantics).
30. heal — fault tolerance through the CLIs, each child a fresh
   interpreter with phase 25's deterministic settings: (1) ``main`` on
   ResNet-18 ``[1,1,1,1]`` (CIFAR shapes, B 64, ``--optimizer
   sgd_fused``, 3 epochs of ``HEAL_IMAGE_STEPS``, ``--save_every 1
   --max_restarts 2 --restart_backoff 0``) with ``PMDT_FAULT_PLAN=
   HEAL_FAULT_PLAN`` failing epoch 2's checkpoint write once: one
   restart, the resume from ``model_1.pth``, the rows and the final
   ``model_3.pth`` against the uninterrupted run (``HEAL_PAYLOAD_TOL``),
   row 8's launches over the process; (2) the same with ``train_lm``
   (gpt_small bf16, B 8 x S 1024, lr 0.01, 3 epochs of
   ``HEAL_LM_STEPS``): rows, payload, rows 5-7's launches; (3) SIGTERM
   to the image run at epoch 2 step 2: exit code 0, ``model_1.pth``
   kept, ``--resume auto`` to a ``model_3.pth`` equal to the
   uninterrupted one; (4) ``main --fsdp`` at (2, 2) (four cards; (1, 2)
   with two; a 1 x 1 grid with one) with ``--ckpt_backend orbax
   --ckpt_async --save_every 1``: each rank's bytes against the state's
   over the ranks, ``--resume auto`` against the uninterrupted gathered
   run, and the checkpoint restored into a plain one-card state against
   the weights the run gathered (``--torch_export``); (5) with two or
   more cards, ``train_lm --parallel dp`` on two NCCL ranks under
   ``PMDT_HEARTBEAT=HEAL_HEARTBEAT``, rank 1 SIGKILLed after its first
   window: rank 0 raises ``PeerLostError`` naming rank 1, within the
   hard limit plus two polls and one window of the kill; (6) ``main
   --profile`` for one epoch: the trace file's size and row 8's CUDA
   kernels as the trace lists them.
31. tp — tensor-parallel serving: (1) on one card, the TP code path at
   M = 1 (a 1 x 1 grid, ``ServingEngine(mesh=...)``) on phase 4's
   workload (gpt_small bf16, 8 slots, 16 prompts x 32 new tokens,
   horizon 4), plain and ``--draft_k 4`` speculative in model dtype and
   int8, dense and paged: transcripts bit-equal to the plain engine's,
   rows 1-4 and their int8 twins launched 12 times a decode pass or
   armed pass; (2) every one of those rows at a rank's shapes for M = 2
   and 4 (``TP_HEADS``: 6 and 3 heads; windows ``TP_WINDOWS``, 64 and
   1024) against its plain version in f32 and bf16, timed in bf16 with
   its bound and SDPA's time (``[tp-kernel]`` lines); (3) with two or
   more cards, ``serve_lm --tp M`` for each of ``TP_CONFIGS`` (gpt_small
   at M = 2 and 4, gpt_medium at 4) on phase 4's workload, dense, paged
   with the prefix cache, int8 and ``--draft_k 4``, in bf16 and f32 (TF32
   off), beside the same run on one card: f32 transcripts token-exact,
   bf16's identical streams counted (first differing positions named);
   decode tokens/s, decode step, TTFT p50/p99, a rank's param bytes
   (against ``TP_JAX_PARAM_BYTES``) and KV pool bytes (one card's / M),
   rank 0's launches held to L a decode pass of the run's variant (L an
   armed pass of its verify variant) and its all-gathers to 1 + 4L a
   pass (``[tp-xcard]`` lines); and gpt_small bf16 dense decode passes
   on one card and at each M, timed and traced by ``torch.profiler`` on
   rank 0: the card's busy time, the NCCL kernels' time and count, a
   cold and a warm serve (``[tp-profile]`` lines).
32. serve-heal — fault-tolerant serving on one card, phase 4's workload
   (gpt_small, 8 slots, 16 prompts x 32 new tokens, horizon 4) in f32
   with TF32 off, through ``serve_lm.main`` unless named: (a) the
   uninterrupted runs with ``--journal``, dense, paged and ``--draft_k
   4`` (the journal empty after the clean drain; launches 12 a pass of
   the run's variant), dense in turns without and with the journal
   (three pairs after a warm-up serve: the engine step's wall and
   tokens/s over it with and without the journal, which writes after
   the ``decode_step`` metric stops; fsync ms a step, journal bytes a
   token); (b) a fatal at ``serving.decode_dispatch``'s 7th hit
   (``PMDT_FAULT_PLAN``'s grammar, armed in this process) under
   ``--max_restarts 2 --journal``, the same three ways: one restart,
   every stream token-exact with (a), the decode and verify rows
   launched again under replay, seconds from the fatal to the rebuilt
   engine's first token; (c) ``serve_lm`` in a child SIGKILLed at half
   its tokens and the same command again: the transcripts together are
   (a)'s, no uid served twice, seconds from the re-run's start to its
   first redelivered token; (d) SIGTERM with ``--drain_deadline_s``:
   exit 0, every request finished token-exact or failed named
   (``DeadlineExceeded``, reason drain) and terminal in the journal, the
   drain's wall time; (e) the engine API: a transient ``error:2`` at
   the dispatch (2 retries, the horizon collapsed, streams exact),
   ``submit(deadline_s=)`` (failed named, the rest exact) and a hung
   readback under ``readback_timeout_s`` (``FaultTimeout``, one watchdog
   trip); (f) (b)'s dense restart in bf16: the exact streams counted, a
   divergence stopped by the journal's named error; (g) ``train_lm``
   saves with ``--ckpt_backend msgpack`` and ``orbax`` and ``serve_lm
   --ckpt`` (``--ckpt_epoch 1`` too) serves each token-exact with the
   same params bound in memory (``[serve-heal]`` lines).
33. scope — observability, armed against disarmed, with
   ``torch.cuda.set_sync_debug_mode("warn")`` counting each run's
   synchronizing CUDA calls: (a) phase 4's serve through
   ``serve_lm.main`` after a warm-up, disarmed and armed
   (``--trace_out``, ``--events_out``, ``--stats_port``) in turns, three
   times each: decode tokens/s, row 1's launches (12 a step) and the
   sync warnings, equal in every run; while the armed serve runs, a
   thread GETs ``/metrics``, ``/snapshot.json``, ``/events.json`` and
   ``/healthz`` (200, ``ready``); the trace parses, carries
   ``request.submit``, ``request.admit`` and ``request.done`` for the 16
   uids and one ``decode.dispatch`` and one ``decode.drain`` a dispatch
   (``[scope-serve]``); (b) a fatal at the 4th dispatch under
   ``--flight_path``: the CLI raises ``GraftFaultError`` and the dump
   ends in ``engine.fatal`` (``[scope-flight]``); (c) the device-memory
   ledger's entries for phase 4's engine and for a gpt_small bf16
   ``train_lm`` state beside ``torch.cuda.memory_allocated()`` over the
   same construction, the ledger never above it (``[hbm]``); (d)
   ``train_lm`` gpt_small bf16 for 4 steps and ``main`` ResNet-18
   ``--optimizer sgd_fused`` for 16, each disarmed, with ``--trace_out``
   and disarmed again: rows 5-7 launch 12 a step and row 8 once, the
   armed run's sync warnings equal the disarmed run's after it
   (``[scope-train]``); (e) with four cards, ``train_lm --parallel dp``
   on four NCCL ranks under ``PMDT_FLEET``, rank 2 slowed by
   ``store.set=hang:0:0.05``: rank 0's ``FleetCollector`` (over the
   rendezvous store and every rank's stats server, before they close)
   merges four lanes, names rank 2 the straggler and reads every rank's
   ``goodput_frac`` in (0, 1] (``[fleet-xcard]``; skipped with fewer
   cards).
34. gen — the rest of generation and of ``train_lm``: (a) gpt_small, 8
   prompts of lengths spread over 17-512 left-padded to 512 into one
   ``generate(..., prompt_lengths=)`` call, 32 new tokens, f32 (TF32
   off) and bf16: every f32 row equals its one-row call on its unpadded
   prompt, bf16 rows counted; row 1 launches 12 a decode step
   (``[ragged]``); (b) row 1 with ``starts`` (each slot's first valid
   column, drawn below its reach) at B 8, H 12, W 1024, Dh 64, f32 and
   bf16, against its plain version; zeros bit-equal to no ``starts``;
   the bf16 call timed (L2-warm and cold, eager, plain, SDPA with the
   same mask, bound) beside the same call without ``starts``
   (``[gen-starts]``); (c) ``beam_search`` on gpt_small bf16, one prompt
   of 128 tokens, 32 new: beam 1 equals greedy ``generate``; 4 beams'
   row-1 launches a step (12) and the step's wall; 4 beams in f32 on
   the card against the CPU, tokens equal and scores within 1e-4
   (``[beam]``); (d) ``train_lm --sample 32 --sample_beams 4
   --hf_export`` (gpt_small bf16, 4 steps of B 8 x S 128): its sample
   equals ``beam_search``'s best beam on the saved params
   (``[lm-beams]``); (e) ``--hf_init`` of that run's export at lr 0, in
   a temporary directory: the file has GPT-2's names and shapes, its
   import is the saved params bit for bit, the first eval loss the
   exporting run's last (``[hf]``); (f) ViT-B/16
   bf16 at 224, batch 64, ``seq_axis`` over a 1 x N grid, the same batch
   on every rank, against the one-card ``flash=True`` ViT with the same
   weights: logits and gradients within 2e-2 normwise, flash launches a
   step the hop schedule's, step time and peak a card beside one card's;
   N = 1 here, 2 and 4 on NCCL ranks where that many cards are visible
   (``[vit-seq]``).
   Then the run's wall time.

The line before the last is ``{"kernels": [...]}`` (one entry per
ported kernel: launches on the main path, error against the plain
version, and the times at the main path's shapes: the largest decode
window of phase 4 for the decode kernel (with its W=1024 numbers
beside them; every decode entry also carries its L2-cold time), bf16 B
8 x S 1024 for the flash kernels
and f32 for their ``_f32`` twins (launches from phase 7b),
ResNet-18's N for fused SGD (with its ResNet-50 numbers from phase 20
beside them, ``r50_*``, and its launches in phase 24's ResNet-50 run
with the step transforms, ``transforms_launches``), bf16 W=1024 for the int8 and paged decode
variants and, at K1 = 5, for the verify variants, n = 4 loopback at
ResNet-18's N for the ring, with its cross-card numbers at that N, at
64 MiB and at 4 KiB, or nulls where phase 19 did not run; the
attention rows also carry their Dh 48/64/96 times, ``head_dim_ms``,
and the bf16 forward its ViT-shape numbers, ``vit_*``; the bf16 flash
entries carry each phase 28 run's launches a step,
``mp_launches_per_step``, and each phase 29 MoE run's,
``moe_launches_per_step``, and phase 30's restarted LM run's,
``heal_restart_launches`` (the fused SGD entry its restarted image
run's); rows 1, 2 and 3 carry phase 32's launches in its uninterrupted
and restarted serves, ``serve_heal_launches`` (null on the rows phase 32
does not run); the decode entry carries phase 29's ``--sample`` launches,
``moe_sample_launches``, and phase 34's launches a step of the ragged
``generate`` and of ``beam_search``, ``train_lm --sample_beams``'s
launches, the ``starts`` call's times and error (``starts_*``) and the
ring ViT's errors and step times (``vit_seq``); rows 1, 5-7 (bf16)
and 8 carry phase 33's launches a step armed and disarmed,
``scope_launches_per_step``; rows
1-4 and their int8 twins carry phase 31's
launches a pass on the M = 1 TP path, ``tp_launches_per_step``, and
their checks and times at a rank's shapes, ``tp_shapes`` keyed
``H{heads}_W{window}``);
the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import collections
import contextlib
import gc
import importlib
import io
import itertools
import json
import re
import math
import os
import queue
import random
import signal
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import traceback

# peak HBM bytes/s by card name (NVIDIA data sheets, SXM parts unless
# named); the roofline bound's denominator
HBM_BYTES_PER_S = (("H200", 4.8e12), ("H100 PCIe", 2.0e12),
                   ("H100 NVL", 3.9e12), ("H100", 3.35e12))
# f32 outside the tensor cores (the decode, SGD and ring kernels' math,
# and the flash kernels' FMA bound beside their 3xTF32 one), H100 SXM
F32_FLOPS_PER_S = 67e12
# exact f32 products on the tensor cores: 3xTF32 (three TF32 products a
# product) at 495 TFLOP/s of TF32, H100 SXM; the card's fastest route to
# f32-accurate products, so the bound of every f32 flash kernel
TF32X3_FLOPS_PER_S = 495e12 / 3
# dense bf16 on the tensor cores, H100 SXM: the bound of bf16 attention
BF16_FLOPS_PER_S = 989e12

DECODE_SHAPE = dict(slots=8, heads=12, head_dim=64)  # gpt_small decode
WINDOWS = (16, 64, 256, 1024)
# the H100's L2: an L2-cold time cycles its calls through input copies
# whose bytes exceed it twice, as a decode step's 12 layers read 12
# distinct windows
L2_BYTES = 50 * 2 ** 20
DECODE_KERNELS = "decode_split_kernel + decode_merge_kernel"
TOL = {"float32": 1e-4, "bfloat16": 1e-4}
REPS = 100
GRAPH_CALLS = 20

FLASH_SHAPE = dict(batch=8, heads=12, head_dim=64, seq=1024)  # gpt_small
# kernel vs plain version: in f32 the same math summed in another order;
# in bf16 the kernels round P and dS to bf16 before their tensor-core
# products (where the Pallas kernels do) and the plain version keeps f32,
# and both round the outputs to bf16 (one unit in the last place near 4
# is 3e-2)
FLASH_TOL = {"float32": dict(out=1e-4, grad=5e-4),
             "bfloat16": dict(out=2e-2, grad=2e-2)}
FLASH_REPLACES = {
    "flash_fwd": "flash_attention.py:44",       # _fwd_kernel
    "flash_bwd_dq": "flash_attention.py:181",   # _bwd_dq_kernel
    "flash_bwd_dkv": "flash_attention.py:220",  # _bwd_dkv_kernel
}
# the kernel each wrapper launches, bf16 (phase 7's path) and f32 (phase
# 7b's, train_lm's default dtype)
FLASH_KERNELS = {"flash_fwd": "flash_fwd_wgmma_kernel",
                 "flash_bwd_dq": "flash_bwd_dq_wgmma_kernel",
                 "flash_bwd_dkv": "flash_bwd_dkv_wgmma_kernel"}
FLASH_KERNELS_F32 = {"flash_fwd": "flash_fwd_tf32x3_kernel",
                     "flash_bwd_dq": "flash_bwd_dq_tf32x3_kernel",
                     "flash_bwd_dkv": "flash_bwd_dkv_tf32x3_kernel"}
# phase 6's peaky softmax: q and k scaled by this (logits x 16)
PEAKY = 4.0
# products per (row, live column) pair: forward QK^T, PV; dq QK^T, dO V^T,
# dS K; dk/dv QK^T, dO V^T, P^T dO, dS^T Q
FLASH_PRODUCTS = {"flash_fwd": 2, "flash_bwd_dq": 3, "flash_bwd_dkv": 4}
# the CLI's default lr (0.1, the reference's) diverges on gpt_small's
# 50257-token head within a few steps, in f32 as in bf16; 0.01 trains
TRAIN_LR = "0.01"
TRAIN_LAYERS_EXACT = 2
# phase 8, kernels vs plain attention through 3 f32 SGD steps: both sides
# compute attention in f32 and differ by summation order only (~1e-6)
EXACT_LOSS_TOL = 1e-4
EXACT_PARAM_TOL = 2e-5

# fused SGD: the kernel rounds each product and sum on its own, as the
# plain version's separate ops do, so the two agree bit for bit
SGD_SIZES = (4_903_242, 1_000_003)  # ResNet-18's parameters; ragged
SGD_HYPER = dict(lr=0.1, momentum=0.9, weight_decay=1e-4)
SGD_BYTES_PER_ELEMENT = 5 * 4  # read p, g, buf; write p, buf (f32)
SGD_FLOPS_PER_ELEMENT = 8  # 4 products, 4 sums and differences (Nesterov)
IMAGE_STEPS, IMAGE_EVALS = 128, 32  # 8192 / 64 and 2048 / 64
# phase 11, sgd vs sgd_fused through 3 f32 steps: bit-equal updates on
# deterministic cuDNN, so any difference would be the kernel's
IMAGE_EXACT_TOL = 0.0


# paged and int8 decode (phases 12-14)
PAGE_SIZE = 16
PAGED_WINDOWS = (64, 256, 1024)
PAGED_TOL = 1e-4  # both sides dequantize alike: row 1's tolerance
DECODE_AB_SPLITS = (64, 128, 256)  # keys a decode CTA walks, in turns
DECODE_REPLACES = "pytorch_multiprocessing_distributed_tpu/ops/pallas/"
VARIANTS = {  # name: (kernel row, replaces line, paged, int8)
    "decode_attention_int8": ("1q", "decode_attention.py:71", False, True),
    "paged_decode_attention": ("2", "decode_attention.py:191", True, False),
    "paged_decode_attention_int8": ("2q", "decode_attention.py:191", True,
                                    True),
}
SERVE_BASE = ["--model", "gpt_small", "--random_init", "--dtype",
              "bfloat16", "--max_slots", "8", "--synthetic", "16",
              "--max_new_tokens", "32", "--decode_horizon", "4", "--seed",
              "0", "--quiet"]
SERVE_PAGED = ["--kv_layout", "paged", "--page_size", str(PAGE_SIZE),
               "--prefix_cache", "8", "--num_pages", "64"]
# speculative decode (phases 15-17)
DRAFT_K = 4
VERIFY_ROWS = DRAFT_K + 1
VERIFY_TOL = 1e-4  # the decode variants' tolerance: same math, same values
VERIFY_SWEEP = (2, 5, 9, 16)  # K1 of phase 15's sweep of row 3
VERIFY_AB_SPLITS = (64, 128, 256)  # keys a verify CTA walks, in turns
PROFILE_CALLS = 20
VERIFY_VARIANTS = {  # name: (kernel row, replaces line, paged, int8)
    "verify_decode_attention": ("3", "decode_attention.py:496", False,
                                False),
    "verify_decode_attention_int8": ("3q", "decode_attention.py:496", False,
                                     True),
    "paged_verify_decode_attention": ("4", "decode_attention.py:616", True,
                                      False),
    "paged_verify_decode_attention_int8": ("4q", "decode_attention.py:616",
                                           True, True),
}
# phase 16: (verify variant, decode variant, extra serve_lm flags)
SPEC_RUNS = (
    ("verify_decode_attention", "decode_attention", []),
    ("verify_decode_attention_int8", "decode_attention_int8",
     ["--kv_dtype", "int8"]),
    ("paged_verify_decode_attention", "paged_decode_attention", SERVE_PAGED),
    ("paged_verify_decode_attention_int8", "paged_decode_attention_int8",
     SERVE_PAGED + ["--kv_dtype", "int8"]),
    ("verify_decode_attention", "decode_attention",
     ["--draft_model", "gpt_tiny", "--s_max", "256"]),
)
DRAFT_LAYERS = 4  # gpt_tiny's
# ring all-reduce (phases 18-19): per-rank shapes cycled through the
# consecutive calls; the timed n and N (ResNet-18's parameters)
RING_SHAPES = ((40, 33), (1,), (3 * 1000 + 7,), (4_903_242,), (1_000_003,))
RING_CALLS = 50
RING_MAIN_N, RING_MAIN_SIZE = 4, 4_903_242
RING_ITERS = 20
RING_KERNEL = "ring_kernel (one rank per card) / ring_loopback_kernel"
# the cross-card payloads of phase 19: ResNet-18's N, 64 MiB, 4 KiB
RING_XCARD_BYTES = (RING_MAIN_SIZE * 4, 64 * 2 ** 20, 4096)
# the values the ring's settings are A/B'd over, one change at a time
# from the module's defaults: blocks, data threads, step elements (8,
# 16, 32 and 64 KB), slots, control warps
RING_AB_VALUES = ((16, 32, 64), (256, 512), (2048, 4096, 8192, 16384),
                  (2, 4, 8), (1, 2, 4))
# NVLink of an H100 SXM: 900 GB/s to the other cards, 450 each way
NVLINK_BYTES_PER_S = 450e9

# the ImageNet slice (phases 20-22): bench.py's configs through the
# port's main on the synthetic set at 224 (PMDT_SMALL_SYNTH: 1024 train
# and 256 test images, 4 steps and one eval batch at bench.py's batch)
IMAGENET_BASE = ["--device", "cuda", "--world_size", "1", "--dataset",
                 "imagenet", "--synthetic", "--epochs", "1", "--seed", "0",
                 "--print-freq", "1"]
IMAGENET_RUNS = (  # (phase, bench.py config, flags)
    ("20", "resnet50_imagenet",
     ["--model", "resnet50", "--batch_size", "256", "--optimizer",
      "sgd_fused"]),
    ("21", "convnext_lamb",
     ["--model", "convnext_t", "--num_classes", "21841", "--optimizer",
      "lamb", "--dtype", "bfloat16", "--batch_size", "256"]),
    ("22", "vit_b16_imagenet",
     ["--model", "vit_b16", "--dtype", "bfloat16", "--batch_size", "256"]),
)
IMAGENET_STEPS, IMAGENET_EVALS = 4, 1  # 1024 / 256 and 256 / 256
R50_PARAMS = 25_557_032  # ResNet-50's parameters at 1000 classes
# phase 24: the step transforms on phase 20's run, and at ResNet-18's
TRANSFORM_FLAGS = ["--grad_accum", "2", "--clip_grad_norm", "1.0", "--ema",
                   "0.999", "--remat"]
TRANSFORM_KW = dict(grad_accum=2, clip_grad_norm=1.0, ema_decay=0.999,
                    remat=True)
TRANSFORM_BATCH, TRANSFORM_STEPS = 512, 3
# phase 25: --zero on ResNet-18 / synthetic CIFAR-10, 1 and 4 steps of 512
ZERO_ONE_SYNTH, ZERO_SYNTH, ZERO_BATCH, ZERO_STEPS = "512", "2048", 512, 4
ZERO_MAX_RANKS = 4
# --zero against the plain run across NCCL ranks: the reduce-scatter sums
# each element in another ring order than the all-reduce, so the reduced
# gradients differ by about one f32 rounding, and after one step so do
# the moments and (times the lr) the params; every later step carries
# that through the network's ReLUs and BatchNorms, which 4 steps at lr
# 0.01 grew to 3.5e-4 in the params on four H100s, and 8 to 1.2e-3. At
# one rank the two runs are the same arithmetic (tolerance 0)
ZERO_STEP_TOL = 1e-5
ZERO_PARAM_TOL = 1e-2
# phase 26: the GSPMD placements on ResNet-18 / synthetic CIFAR-10, 4
# epochs of one step of 512 (a checkpoint each); the same tolerances as
# phase 25 (one step: the reduction's order only)
GSPMD_SYNTH, GSPMD_BATCH, GSPMD_STEPS = "512", 512, 4
# JAX's per-device bytes (params, batch_stats, one moment tree; f32) of
# state_shardings on a (data, model) mesh: ResNet-18 (CIFAR stem, 10
# classes) and ResNet-50 (ImageNet stem, 1000 classes), keyed by (model,
# placement, data, model); LAMB holds two moment trees
JAX_RESIDENT = {
    ("res", "zero1", 1, 1): (19612968, 23040, 19612968),
    ("res", "zero1", 2, 1): (19612968, 23040, 9806484),
    ("res", "zero1", 3, 1): (19612968, 23040, 7025448),
    ("res", "zero1", 4, 1): (19612968, 23040, 4903272),
    ("res", "fsdp", 1, 1): (19612968, 23040, 19612968),
    ("res", "fsdp", 2, 1): (9806484, 11520, 9806484),
    ("res", "fsdp", 3, 1): (7025448, 23040, 7025448),
    ("res", "fsdp", 4, 1): (4903272, 5760, 4903272),
    ("res", "plain", 1, 2): (9806484, 11520, 9806484),
    ("res", "zero1", 2, 2): (9806484, 11520, 4910740),
    ("res", "plain", 1, 4): (4918632, 5760, 4918632),
    ("resnet50", "plain", 1, 1): (102228128, 212480, 102228128),
    ("resnet50", "fsdp", 1, 1): (102228128, 212480, 102228128),
    ("resnet50", "fsdp", 2, 1): (51114064, 106240, 51114064),
    ("resnet50", "fsdp", 3, 1): (72023712, 212480, 72023712),
    ("resnet50", "fsdp", 4, 1): (25557032, 53120, 25557032),
}
R50_FSDP_BATCH = 128
# phase 22: one ViT-B/16 encoder block, flash=True against flash=False
VIT_BLOCK = dict(batch=8, seq=197, dim=768, heads=12, mlp=3072)
VIT_FWD_SHAPE = dict(batch=64, heads=12, seq=197, head_dim=64)
# phase 23: head_dims off the kernels' tiles (20: no whole 16-byte row in
# bf16 or int8, so the wrapper pads it), and the ones timed beside Dh 64
ODD_HEAD_DIMS = (16, 48, 80, 96, 112, 20)
TIMED_HEAD_DIMS = (48, 64, 96)
HEAD_DIM_WINDOW = 256
HEAD_DIM_FLASH = dict(batch=2, heads=4, seqs=((197, 197), (130, 70)))
# a GPT of head_dim 16: gpt_small's vocab and depth cut, 32 heads of 16
GPT_DH16 = dict(hidden_size=512, num_heads=32, mlp_dim=2048, num_layers=2)
# phase 27: sequence parallelism. gpt_small at the CLI's largest S (1024)
# and at bench.py's gpt_lm_long geometry (S 4096, batch 2, the model
# built at max_seq_len 4096); the hop shape of S 1024 over four ranks
SP_MODES = ("ring", "zigzag", "ulysses")
SP_SHAPE = dict(batch=8, seq=1024)
SP_LONG = dict(batch=2, seq=4096, steps=3)
SP_HOP = dict(batch=8, heads=12, seq=256, head_dim=64)
SP_MAX_RANKS = 4
SP_CLI_STEPS = 4
SP_LR = 0.01
SP_CHUNKS = 8
# zigzag at degree 1 folds two half-blocks per row where the plain step
# runs one kernel: the attention output differs by rounding (bf16: the
# per-hop outputs are rounded to bf16 before the f32 fold), so the loss
# and, through lr x the gradient, the params after one step differ
SP_ZIGZAG_TOL = {"float32": dict(loss=1e-5, param=1e-6),
                 "bfloat16": dict(loss=1e-2, param=1e-4)}
# the chunked head sums the same f32 CE in another order
SP_CHUNK_LOSS_TOL = 1e-4
# bf16 ring/ulysses across W cards against the one-card plain step: the
# fold's rounding and another order of the gradient sums
SP_LONG_LOSS_TOL = 2e-2
# phase 28: train_lm's model-parallel modes on gpt_small at B 8 x S 1024
# (bench.py's gpt_lm geometry), MP_STEPS SGD steps from seed 0's params.
# Runs at degree 1 on one card; across W cards pp and tp at degree 2 and
# W. The second grid axis of each kind: pp "pipe", tp and dp "model"
MP_SHAPE = dict(batch=8, seq=1024)
MP_STEPS = 3
MP_AXES = {"dp": "model", "pp": "pipe", "tp": "model", "sp": "seq"}
MP_ONE_CARD = ({"kind": "dp"}, {"kind": "pp", "schedule": "gpipe"},
               {"kind": "pp", "schedule": "1f1b"}, {"kind": "tp"},
               {"kind": "tp", "zero1": True}, {"kind": "tp", "fsdp": True},
               {"kind": "dp", "zero": True}, {"kind": "dp", "remat": True})
MP_CROSS = ({"kind": "pp", "schedule": "gpipe"},
            {"kind": "pp", "schedule": "1f1b"}, {"kind": "tp"},
            {"kind": "tp", "zero1": True}, {"kind": "tp", "fsdp": True})
# pp at degree 1 against the plain step after MP_STEPS steps: the
# pipelined steps' final LayerNorm takes the two-pass variance and their
# CE the vocab-parallel log-sum-exp (JAX's gpt_pipeline); in bf16 their
# embedding is rounded after the position add, the plain model's before
MP_PP_TOL = {"float32": dict(loss=1e-5, param=1e-6),
             "bfloat16": dict(loss=1e-3, param=2e-4)}
# pp and tp across cards against one card's plain step: the reductions'
# order, microbatched matmuls, and the pp differences above
MP_XCARD_TOL = {"float32": dict(loss=1e-5, param=1e-6),
                "bfloat16": dict(loss=1e-3, param=2e-4)}
# the CLI: 2 train steps and 1 eval batch an epoch (25000 tokens, 34%
# held out: 16 and 8 windows of 1016), S 1016 so that --sample 8 fits
# max_seq_len 1024
MP_CLI_MODES = (["--parallel", "pp"], ["--parallel", "tp", "--zero1"])
MP_CLI_SEQ, MP_CLI_SAMPLE = 1016, 8
MP_CLI_TOKENS, MP_CLI_VAL, MP_CLI_STEPS, MP_CLI_EVALS = 25000, 0.34, 2, 1
# JAX's per-device bytes (params, one moment tree; f32) of gpt_small under
# its placements, keyed by (kind, placement, data, degree): pp by
# pipeline_specs on a (data, pipe) mesh, tp by state_shardings on a
# (data, model) mesh, dp replicated
MP_JAX_RESIDENT = {
    ("dp", "plain", 1, 1): (652349764, 652349764),
    ("pp", "plain", 1, 1): (652349764, 652349764),
    ("pp", "plain", 1, 2): (327753892, 327753892),
    ("pp", "plain", 2, 2): (327753892, 327753892),
    ("pp", "plain", 1, 4): (165455956, 165455956),
    ("tp", "plain", 1, 1): (652349764, 652349764),
    ("tp", "zero1", 1, 1): (652349764, 652349764),
    ("tp", "fsdp", 1, 1): (652349764, 652349764),
    ("tp", "plain", 1, 2): (403470148, 403470148),
    ("tp", "zero1", 1, 2): (403470148, 403470148),
    ("tp", "fsdp", 1, 2): (403470148, 403470148),
    ("tp", "plain", 2, 2): (403470148, 403470148),
    ("tp", "zero1", 2, 2): (403470148, 240554308),
    ("tp", "fsdp", 2, 2): (240554308, 240554308),
    ("tp", "plain", 1, 4): (279030340, 279030340),
    ("tp", "zero1", 1, 4): (279030340, 279030340),
    ("tp", "fsdp", 1, 4): (279030340, 279030340),
}
# phase 29: Mixture of Experts. The layer at gpt_small's widths with 8
# experts (capacity factor 1.0: 128 slots an expert for top-1, 256 for
# top-2), B 8 x S 1024, on the card against the CPU: the share of the
# (token, choice) routes that agree (the router is f32 on both; a route
# can flip only at a near tie) and the largest y error over the tokens
# whose routes and kept slots agree: f32 (TF32 off) the products' order,
# bf16 one bf16 rounding of the experts' products and of the combine
MOE_LAYER = dict(batch=8, seq=1024, dim=768, hidden=3072, experts=8)
MOE_LAYER_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
MOE_ROUTE_SHARE = 0.999
# the MoE train steps at degree 1 (each bit-equal to the plain MoE step
# but pp, held to MP_PP_TOL as in phase 28), and across the cards
MOE_STEPS = 3
MOE_ONE_CARD = ({"kind": "dp"}, {"kind": "sp", "sp_mode": "ring"},
                {"kind": "sp", "sp_mode": "ulysses"}, {"kind": "tp"},
                {"kind": "pp", "schedule": "gpipe"},
                {"kind": "pp", "schedule": "1f1b"},
                {"kind": "dp", "remat": True}, {"kind": "dp", "zero": True})
MOE_CROSS = ({"kind": "tp"}, {"kind": "pp", "schedule": "gpipe"},
             {"kind": "sp", "sp_mode": "ring"})
# the CLI: 4 train steps and 1 eval batch an epoch (42000 tokens, 20%
# held out), at S 1024 and, resumed with --sample 8, at S 1016
MOE_CLI_TOKENS, MOE_CLI_VAL, MOE_CLI_STEPS, MOE_CLI_EVALS = 42000, 0.2, 4, 1
# JAX's per-device bytes (params, one moment tree; f32) of gpt_small with
# 8 experts under state_shardings on a (data, model) mesh, keyed by
# (placement, data, degree)
MOE_JAX_RESIDENT = {
    ("plain", 1, 1): (2239381828, 2239381828),
    ("plain", 1, 2): (1196986180, 1196986180),
    ("plain", 1, 4): (675788356, 675788356),
}

# phase 30: fault tolerance. The restart drills fail the second
# checkpoint write once (epoch 2's) in a child's environment; the
# children run f32 convolutions deterministic with TF32 off (phase 25's
# settings), so a resumed run is held bit for bit against the
# uninterrupted one
HEAL_FAULT_PLAN = "seed=0;train.checkpoint_write=error:1:1"
HEAL_IMAGES, HEAL_IMAGE_STEPS = 1024, 16  # ResNet-18 B 64: 1024 / 64
HEAL_PROFILE_IMAGES = 512  # --profile: 8 steps, 2 eval batches
HEAL_IMAGE_COMMON = ["--model", "res", "--synthetic", "--batch_size", "64",
                     "--seed", "0"]
HEAL_IMAGE_ARGV = ["--device", "cuda", "--world_size", "1", "--optimizer",
                   "sgd_fused"] + HEAL_IMAGE_COMMON
HEAL_LM_STEPS = 4  # 32768 tokens = 32 windows of 1024 = 4 batches of 8
HEAL_LM_ARGV = ["--device", "cuda", "--model", "gpt_small", "--dtype",
                "bfloat16", "--batch_size", "8", "--seq_len", "1024",
                "--lr", TRAIN_LR, "--seed", "0", "--corpus_tokens", "32768"]
HEAL_PAYLOAD_TOL = 0.0  # deterministic: the same bits
HEAL_LM_TOL = 0.0
HEAL_SHARD_SLACK = 1.25  # a rank's bytes over state / ranks (DCP's
                         # per-item framing, replicated leaves written once)
HEAL_HEARTBEAT = "2:6:0.5"  # soft : hard : poll interval (seconds)
HEAL_CHILD_TIMEOUT = 300
# a phase 30 child: the CLI's main in a fresh interpreter (the fault plan
# and the heartbeat arm at import), every kernel counter of the process
# after it; argv: cli, summary path ("-" = none), the CLI's flags
HEAL_CHILD = r"""
import importlib, json, os, sys
sys.path.insert(0, os.getcwd())
import torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cudnn.deterministic = True
torch.backends.cudnn.benchmark = False
port = "pytorch_multiprocessing_distributed_tpu_torch"
cli = importlib.import_module(port + "." + sys.argv[1])
fa = importlib.import_module(port + ".ops.flash_attention")
kernels = {"fused_sgd": importlib.import_module(
               port + ".ops.fused_update").fused_sgd_,
           "flash_fwd": fa.flash_fwd, "flash_bwd_dq": fa.flash_bwd_dq,
           "flash_bwd_dkv": fa.flash_bwd_dkv}
for kernel in kernels.values():
    kernel.launches = 0
summary = cli.main(sys.argv[3:])
summary["process_launches"] = {n: k.launches for n, k in kernels.items()}
if sys.argv[2] != "-":
    with open(sys.argv[2], "w") as f:
        json.dump(summary, f)
"""

# phase 31: tensor-parallel serving. A rank's heads at M = 2 and 4 of
# gpt_small's 12, the windows its kernel rows are held and timed at, the
# (model, M) runs across cards and their serve_lm variants
TP_HEADS = (6, 3)
TP_WINDOWS = (64, 1024)
TP_CONFIGS = (("gpt_small", 2), ("gpt_small", 4), ("gpt_medium", 4))
TP_RUNS = (("dense", []), ("paged", SERVE_PAGED),
           ("int8", ["--kv_dtype", "int8"]),
           ("spec", ["--draft_k", str(DRAFT_K)]))
# each TP_RUNS run's decode variant and verify variant (None: unarmed)
TP_RUN_VARIANTS = {"dense": ("decode_attention", None),
                   "paged": ("paged_decode_attention", None),
                   "int8": ("decode_attention_int8", None),
                   "spec": ("decode_attention", "verify_decode_attention")}
# the M = 1 runs on one card, TP path beside the plain engine: the
# speculative runs launch every decode row on their k = 0 passes and
# every verify row on their armed ones; (label, decode variant, verify
# variant, engine options)
TP_ONE_CARD = (
    ("dense", "decode_attention", None, {}),
    ("spec", "decode_attention", "verify_decode_attention",
     dict(draft_k=DRAFT_K)),
    ("spec-int8", "decode_attention_int8", "verify_decode_attention_int8",
     dict(draft_k=DRAFT_K, kv_dtype="int8")),
    ("spec-paged", "paged_decode_attention", "paged_verify_decode_attention",
     dict(draft_k=DRAFT_K, kv_layout="paged", page_size=PAGE_SIZE,
          prefix_cache=8, num_pages=64)),
    ("spec-paged-int8", "paged_decode_attention_int8",
     "paged_verify_decode_attention_int8",
     dict(draft_k=DRAFT_K, kv_layout="paged", page_size=PAGE_SIZE,
          prefix_cache=8, num_pages=64, kv_dtype="int8")),
)
# JAX's per-device param bytes (f32) of shard_params_for_tp_decode's
# tree, and of its LayerNorm leaves, keyed by (model, M)
TP_JAX_PARAM_BYTES = {
    ("gpt_small", 2): (403470148, 76800),
    ("gpt_small", 4): (279030340, 38400),
    ("gpt_medium", 4): (560876868, 100352),
}
TP_RANKS_TIMEOUT = 900
TP_PROFILE_STEPS = 4  # engine steps timed, then traced, by _tp_profile
# the CUDA runtime calls in which the host waits for the card
TP_HOST_WAITS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
                 "cudaEventSynchronize", "cudaMemcpyAsync", "cudaMemcpy")

# phase 32: fault-tolerant serving. Phase 4's workload in f32 (TF32 off),
# its serve_lm variants (label, extra flags, decode variant, verify
# variant), the fatal injected at the decode dispatch's 7th hit, the
# token lines a child prints before its SIGKILL (half of 16 x 32) or
# SIGTERM, and the drain deadline of that drill
SERVE_HEAL_ARGV = ["--model", "gpt_small", "--random_init", "--dtype",
                   "float32", "--max_slots", "8", "--synthetic", "16",
                   "--max_new_tokens", "32", "--decode_horizon", "4",
                   "--seed", "0"]
SERVE_HEAL_RUNS = (
    ("dense", [], "decode_attention", None),
    ("paged", SERVE_PAGED, "paged_decode_attention", None),
    ("spec", ["--draft_k", str(DRAFT_K)], "decode_attention",
     "verify_decode_attention"),
)
SERVE_HEAL_FATAL = "seed=0;serving.decode_dispatch=fatal:1:6"
SERVE_HEAL_RESTART = ["--max_restarts", "2", "--restart_backoff", "0"]
SERVE_HEAL_KILL_AT = 256
SERVE_HEAL_TERM_AT = 96
SERVE_HEAL_DRAIN_S = 0.3
# the signal goes this long after the line that triggers it: the child
# has printed that step's events and is inside the next step
SERVE_HEAL_SIGNAL_DELAY_S = 0.01
SERVE_HEAL_DEADLINE_RUNNING_S = 0.5  # (e): a 512-token request's budget
SERVE_HEAL_HANG_S, SERVE_HEAL_WATCHDOG_S = 3.0, 0.5
# (g): train_lm's runs (HEAL_LM_ARGV: 4 bf16 steps an epoch) and the
# serve of each checkpoint (8 requests x 16 tokens, f32)
SERVE_HEAL_CKPT_ARGV = ["--model", "gpt_small", "--dtype", "float32",
                        "--max_slots", "8", "--synthetic", "8",
                        "--max_new_tokens", "16", "--decode_horizon", "4",
                        "--seed", "0"]
# a phase 32 child: serve_lm's main in a fresh interpreter with TF32 off
# (the fault plan, if any, arms at import from its environment)
SERVE_HEAL_CHILD = r"""
import os, sys
sys.path.insert(0, os.getcwd())
import torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
from pytorch_multiprocessing_distributed_tpu_torch import serve_lm
serve_lm.main(sys.argv[1:])
"""

# phase 34: the rest of generation and of train_lm. [ragged]: gpt_small
# prompts left-padded to one length, their lengths spread over [min_len,
# pad_to]; [gen-starts]: row 1 with a first valid column a slot, at
# DECODE_SHAPE and W 1024; [beam]: one prompt, beams 1 and BEAMS;
# [lm-beams] and [hf]: train_lm gpt_small bf16 for 4 steps of B 8 x S 128
# (5120 tokens, 20% held out: 32 and 8 windows); [vit-seq]: ViT-B/16 at
# 224, the same batch on every rank of a seq axis
GEN_MODEL = "gpt_small"
GEN_RAGGED = dict(rows=8, pad_to=512, min_len=17, new=32)
GEN_STARTS_WINDOW = 1024
GEN_BEAM = dict(prompt=128, new=32, beams=4)
GEN_BEAM_SCORE_TOL = 1e-4  # f32, card against CPU: the sums' order
GEN_LM_ARGV = ["--model", GEN_MODEL, "--dtype", "bfloat16", "--batch_size",
               "8", "--seq_len", "128", "--corpus_tokens", "5120",
               "--val_frac", "0.2", "--epochs", "1", "--lr", TRAIN_LR,
               "--seed", "0", "--print_freq", "1"]
GEN_LM_SAMPLE = 32
GEN_EVAL_TOL = 1e-6  # the importing run's first eval against the last
VIT_SEQ = dict(model="vit_b16", batch=64, image=224, classes=1000, steps=3)
VIT_SEQ_MAX_RANKS = 4
VIT_SEQ_TOL = 2e-2  # rows 5-7's bf16 tolerance, each tensor normwise


def _print(*parts):
    print(*parts, flush=True)


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()
    return out[0]


def _hbm_rate(name: str) -> float:
    for key, rate in HBM_BYTES_PER_S:
        if key in name:
            return rate
    raise RuntimeError(f"no HBM peak on record for card {name!r}")


def _eager_ms(fn, torch, reps=REPS, warmup=10):
    """Median over ``reps`` single calls timed with CUDA events: the
    device time of one call as the eager caller gets it, host launch
    cost included (the card idles while the host prepares the call)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _device_ms(fn, torch, calls=GRAPH_CALLS, reps=REPS):
    """Device time of one call: ``calls`` calls captured into a CUDA
    graph, the graph replayed ``reps`` times between CUDA events, the
    median replay divided by ``calls`` — no host work inside the timed
    window."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def _nbytes(*xs):
    """Bytes of tensors and int8 K/V pairs (None counts 0)."""
    return sum(_nbytes(x.data, x.scale) if hasattr(x, "scale")
               else x.numel() * x.element_size()
               for x in xs if x is not None)


def _cold_ms(call, inputs, torch):
    """Device time of one ``call(*inputs)`` with its inputs L2-cold: the
    graph's calls cycle through copies of ``inputs`` (tensors, int8 K/V
    pairs, None) whose bytes exceed the L2 twice."""
    def clone(x):
        if x is None:
            return None
        if hasattr(x, "scale"):
            return type(x)(x.data.clone(), x.scale.clone())
        return x.clone()

    n = math.ceil(2 * L2_BYTES / _nbytes(*inputs)) + 1
    copies = itertools.cycle([tuple(clone(x) for x in inputs)
                              for _ in range(n)])
    ms = _device_ms(lambda: call(*next(copies)), torch)
    del copies
    torch.cuda.empty_cache()
    return ms


def _graph_bits(call, torch):
    """``call()`` captured once in a CUDA graph and replayed into an
    output cleared first: its bits, to hold against an eager call."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = call()
    out.zero_()
    graph.replay()
    torch.cuda.synchronize()
    return out


def _plan_text(da, q, window):
    """The decode kernels' cut of a call, as the lines print it."""
    b, _, h, d = q.shape
    plan = da.decode_split_plan(b, h, window, d)
    return (f"split {plan.split} x {plan.n_splits}, "
            + ("one launch" if plan.partials is None
               else "split + merge launches"))


def _decode_builds(entries):
    """``(kernel, registers, spill stores, spill loads)`` of every
    decode split and merge instantiation in the ``-Xptxas -v`` report,
    the kernel named by its template arguments (q type, K/V type, Dh,
    paged)."""
    types = {"f": "f32", "a": "int8", "13__nv_bfloat16": "bf16"}
    found = []
    for name, *counts, _ in entries:
        split = re.search(r"decode_split_kernelI(f|13__nv_bfloat16)"
                          r"(f|a|13__nv_bfloat16|S\d*_)Li(\d+)ELb(\d)E",
                          name)
        merge = re.search(r"decode_merge_kernelILi(\d+)E", name)
        if split:
            q_type = types[split.group(1)]
            kv = types.get(split.group(2), q_type)
            label = (f"decode_split_kernel<q {q_type}, K/V {kv}, Dh "
                     f"{split.group(3)}, "
                     f"{'paged' if split.group(4) == '1' else 'dense'}>")
        elif merge:
            label = f"decode_merge_kernel<Dh {merge.group(1)}>"
        else:
            continue
        found.append((label, *counts))
    return found


def _ring_builds(entries):
    """``(kernel, registers, spill stores, spill loads)`` of the ring
    kernels in the ``-Xptxas -v`` report (one rank per card and
    loopback, 8 or 16 data warps)."""
    found = []
    for name, *counts, _ in entries:
        kernel = re.search(r"(ring_kernel|ring_loopback_kernel)ILi(\d+)E",
                           name)
        if kernel:
            found.append((f"{kernel.group(1)}<{kernel.group(2)} data "
                          f"warps>", *counts))
    return found


def _flash_builds(entries):
    """``(kernel, registers, spill stores, spill loads)`` of the 18 flash
    instantiations (forward, dq, dk/dv x bf16/f32 x Dh 32/64/128) among
    the ``-Xptxas -v`` report's entries, each with ", wgmma serialised
    (C7512)" where ptxas says so."""
    found = []
    for name, *counts, serialised in entries:
        kernel = re.search(r"(flash_(?:fwd|bwd_dq|bwd_dkv)_(?:wgmma|tf32x3)"
                           r"_kernel)ILi(\d+)E", name)
        if kernel:
            found.append((f"{kernel.group(1)}<Dh {kernel.group(2)}>"
                          + (", wgmma serialised (C7512)" if serialised
                             else ""), *counts))
    return found


def _decode_inputs(torch, window, dtype, seed, head_dim=None, heads=None):
    """q/k/v/positions at gpt_small decode shapes (another ``head_dim``,
    or a tensor-parallel rank's ``heads``, where given); positions hold
    0, W-1, one beyond the window and random columns."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    n, h, d = (DECODE_SHAPE[k] for k in ("slots", "heads", "head_dim"))
    d, h = head_dim or d, heads or h
    q = torch.randn(n, 1, h, d, generator=gen, device="cuda").to(dtype)
    # k/v as the engine passes them: a window view of an s_max cache
    s_max = max(WINDOWS)
    k = torch.randn(n, s_max, h, d, generator=gen, device="cuda").to(dtype)
    v = torch.randn(n, s_max, h, d, generator=gen, device="cuda").to(dtype)
    pos = torch.randint(0, window, (n,), generator=gen, device="cuda")
    pos[0], pos[1], pos[2] = 0, window - 1, window + 5
    return q, k[:, :window], v[:, :window], pos.to(torch.int32)


def _bound(q, k, positions, rate, starts=None):
    """Least time for the work these inputs need: each row reads
    min(pos, W-1)+1 key and value columns once (from its start where
    ``starts`` is given), plus q, positions (and starts) and the f32
    output; the f32 math is 4 flops per K/V element read."""
    n, _, h, d = q.shape
    reach = positions.clamp(max=k.shape[1] - 1)
    first = 0 if starts is None else starts
    cols = int((reach - first + 1).clamp(min=0).sum())
    elt = k.element_size()
    nbytes = (2 * cols * h * d * elt + q.numel() * elt
              + n * 4 * (1 if starts is None else 2) + q.numel() * 4)
    flops = 2 * cols * h * d * 2
    t_bytes, t_ops = nbytes / rate, flops / F32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _time_decode(torch, F, decode_attention, torch_decode_attention, q, k,
                 v, pos, rate, starts=None):
    """Device times of the kernel (its window L2-warm, and L2-cold), the
    plain version and the library call (the same mask: from ``starts``
    where given), the kernel's eager per-call time, and the bound, for
    one input. Launches made here are not counted."""
    scale = q.shape[-1] ** -0.5
    cols = torch.arange(k.shape[1], device="cuda")[None, :]
    mask = cols <= pos.long()[:, None]
    if starts is not None:
        mask = mask & (cols >= starts.long()[:, None])
    mask = mask[:, None, None, :]
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    launches = decode_attention.launches

    def call(q_, k_, v_, pos_, starts_):
        return decode_attention(q_, k_, v_, pos_, starts=starts_,
                                impl="cuda")

    def kernel():
        call(q, k, v, pos, starts)

    ms = _device_ms(kernel, torch)
    cold_ms = _cold_ms(call, (q, k, v, pos, starts), torch)
    eager_ms = _eager_ms(kernel, torch)
    decode_attention.launches = launches
    plain_ms = _device_ms(
        lambda: torch_decode_attention(q, k, v, pos, starts), torch)
    library_ms = _device_ms(
        lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                               scale=scale), torch)
    bound_ms, bound_by = _bound(q, k, pos, rate, starts)
    return dict(ms=ms, cold_ms=cold_ms, eager_ms=eager_ms,
                plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                bound_by=bound_by)


def _flash_inputs(torch, b, sq, skv, h, d, dtype, seed):
    """q/k/v as the model hands them to the kernels: [B, S, H, Dh] views
    of one fused QKV projection (row stride 3*H*Dh); dO contiguous."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    fused_q = torch.randn(b, sq, 3 * h * d, generator=gen, device="cuda")
    fused_k = torch.randn(b, skv, 3 * h * d, generator=gen, device="cuda")
    q = fused_q.to(dtype)[..., :h * d].view(b, sq, h, d)
    k = fused_k.to(dtype)[..., h * d:2 * h * d].view(b, skv, h, d)
    v = fused_k.to(dtype)[..., 2 * h * d:].view(b, skv, h, d)
    do = torch.randn(b, sq, h, d, generator=gen, device="cuda").to(dtype)
    return q, k, v, do


def _flash_calls(fa, q, k, v, do, causal):
    """The three kernel calls, the three plain calls, and the inputs the
    backward pair reads (the plain forward's lse and dterm)."""
    scale = q.shape[-1] ** -0.5
    kw = dict(scale=scale, causal=causal)
    ref_out, lse = fa.torch_flash_fwd(q, k, v, **kw)
    dterm = fa.flash_dterm(do, ref_out)
    kernels = {
        "flash_fwd": lambda: fa.flash_fwd(q, k, v, impl="cuda", **kw),
        "flash_bwd_dq": lambda: fa.flash_bwd_dq(q, k, v, do, lse, dterm,
                                                impl="cuda", **kw),
        "flash_bwd_dkv": lambda: fa.flash_bwd_dkv(q, k, v, do, lse, dterm,
                                                  impl="cuda", **kw),
    }
    plains = {
        "flash_fwd": lambda: fa.torch_flash_fwd(q, k, v, **kw),
        "flash_bwd_dq": lambda: fa.torch_flash_bwd_dq(q, k, v, do, lse,
                                                      dterm, **kw),
        "flash_bwd_dkv": lambda: fa.torch_flash_bwd_dkv(q, k, v, do, lse,
                                                        dterm, **kw),
    }
    return kernels, plains, lse, dterm


def _tuple(out):
    """A kernel's outputs as a tuple (dq is one tensor)."""
    return out if isinstance(out, tuple) else (out,)


def _flash_errors(torch, kernels, plains, tol):
    """Max |kernel - plain| per kernel over its outputs; raises past the
    tolerance (lse, f32 in both dtypes, is held at 1e-4)."""
    errs = {}
    for name, kernel in kernels.items():
        got, ref = _tuple(kernel()), _tuple(plains[name]())
        torch.cuda.synchronize()
        worst = 0.0
        for i, (g, r) in enumerate(zip(got, ref)):
            is_lse = name == "flash_fwd" and i == 1
            t = 1e-4 if is_lse else tol["out" if name == "flash_fwd"
                                         else "grad"]
            diff = (g.float() - r.float()).abs()
            if not bool((diff <= t + t * r.float().abs()).all()):
                raise AssertionError(
                    f"{name} output {i}: max|err| {float(diff.max())} past "
                    f"atol=rtol={t}")
            worst = max(worst, float(diff.max()))
        errs[name] = worst
    return errs


def _flash_flops(name, q, k, causal):
    """One kernel's flops: 2 Dh per product per live (row, column) pair;
    causal counts the live pairs, S (S + 1) / 2."""
    b, sq, h, d = q.shape
    pairs = sq * (sq + 1) // 2 if causal else sq * k.shape[1]
    return 2 * FLASH_PRODUCTS[name] * b * h * pairs * d


def _flash_bound(name, q, k, causal, rate, f32_peak=TF32X3_FLOPS_PER_S):
    """Least time for one kernel's work: its flops over the peak of the
    input type (bf16 on the tensor cores; f32 at ``f32_peak``, by default
    3xTF32 on the tensor cores, the card's fastest exact-f32 route)
    against its own reads and writes over the HBM rate."""
    b, sq, h, d = q.shape
    skv = k.shape[1]
    flops = _flash_flops(name, q, k, causal)
    elt = q.element_size()
    q_bytes, kv_bytes, rows = b * sq * h * d * elt, b * skv * h * d * elt, \
        b * h * sq * 4
    nbytes = {"flash_fwd": 2 * q_bytes + 2 * kv_bytes + rows,
              "flash_bwd_dq": 3 * q_bytes + 2 * kv_bytes + 2 * rows,
              "flash_bwd_dkv": 2 * q_bytes + 4 * kv_bytes + 2 * rows}[name]
    peak = BF16_FLOPS_PER_S if elt == 2 else f32_peak
    t_bytes, t_ops = nbytes / rate, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _time_flash(torch, F, fa, q, k, v, do, causal, rate):
    """Per kernel: device ms (CUDA graph), eager ms, plain ms, bound,
    TFLOP/s; the library yardstick: SDPA's forward, and autograd through
    SDPA minus its forward for the backward pair (dq, dk and dv
    together, its own dO.O pass included); and ``flash_dterm``, the torch
    ops the port's backward runs beside the pair. Launches made here are
    not counted."""
    kernels, plains, _, _ = _flash_calls(fa, q, k, v, do, causal)
    saved = {n: getattr(fa, n).launches for n in kernels}
    qt, kt, vt = (t.detach().transpose(1, 2).requires_grad_()
                  for t in (q, k, v))
    dot = do.transpose(1, 2)

    def lib_fwd():
        with torch.no_grad():
            F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)

    def lib_fwd_bwd():
        out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
        torch.autograd.grad(out, (qt, kt, vt), dot)

    lib_f = _device_ms(lib_fwd, torch, calls=5, reps=20)
    lib_bwd = _device_ms(lib_fwd_bwd, torch, calls=5, reps=20) - lib_f
    out = {}
    for name, kernel in kernels.items():
        bound_ms, bound_by = _flash_bound(name, q, k, causal, rate)
        ms = _device_ms(kernel, torch, calls=5, reps=20)
        out[name] = dict(
            ms=ms, eager_ms=_eager_ms(kernel, torch, reps=20, warmup=3),
            plain_ms=_device_ms(plains[name], torch, calls=2, reps=10),
            library_ms=lib_f if name == "flash_fwd" else lib_bwd,
            bound_ms=bound_ms, bound_by=bound_by,
            tflop_per_s=_flash_flops(name, q, k, causal) / ms / 1e9)
        if q.element_size() == 4:  # the CUDA cores' FMA bound beside it
            out[name]["fma_bound_ms"] = _flash_bound(
                name, q, k, causal, rate, F32_FLOPS_PER_S)[0]
    fwd_out = kernels["flash_fwd"]()[0]
    dterm_ms = _device_ms(lambda: fa.flash_dterm(do, fwd_out), torch,
                          calls=5, reps=20)
    for n, count in saved.items():
        getattr(fa, n).launches = count
    return out, dterm_ms


def _train_phase(train_lm, fa, dtype, smi):
    """Phases 7 and 7b: ``train_lm.main`` on full-width gpt_small, B 8 x
    S 1024, lr 0.01, one epoch of the default corpus with ``--val_frac
    0.1``, in ``dtype`` (None: the CLI's default, float32). Asserts the
    steps, the flash launches (12 per train step and per eval batch for
    the forward, 12 per train step for each backward kernel), a finite
    epoch loss below the first printed loss and the files; prints
    tokens/s and the steady step. Returns the launches."""
    for kname in FLASH_PRODUCTS:
        getattr(fa, kname).launches = 0
    argv = ["--model", "gpt_small", "--batch_size", "8", "--seq_len",
            "1024", "--epochs", "1", "--val_frac", "0.1", "--lr", TRAIN_LR,
            "--seed", "0"]
    if dtype is not None:
        argv += ["--dtype", dtype]
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        summary = train_lm.main(argv + ["--save_path", tmp])
        wall = time.perf_counter() - t0
        missing = [f for f in ("train.log", "test.log", "model_1.pth",
                               "model_1.pth.sha256")
                   if not os.path.exists(os.path.join(tmp, f))]
    launches = {n: getattr(fa, n).launches for n in FLASH_PRODUCTS}
    if missing:
        raise AssertionError(f"train_lm wrote no {missing}")
    steps, evals = 21, 2
    if summary["steps"] != steps:
        raise AssertionError(f"train_lm ran {summary['steps']}/{steps} steps")
    want = {"flash_fwd": 12 * (steps + evals), "flash_bwd_dq": 12 * steps,
            "flash_bwd_dkv": 12 * steps}
    if launches != want or summary["launches"] != want:
        raise AssertionError(
            f"flash kernels launched {launches} (the CLI counted "
            f"{summary['launches']}); expected {want}: 12 (layers) per "
            "train step and per eval batch for the forward, 12 per train "
            "step for each backward kernel")
    loss = summary["epoch_losses"][0]
    if not math.isfinite(loss) or not loss < summary["first_loss"]:
        raise AssertionError(
            f"epoch loss {loss} is not finite and below the first printed "
            f"loss {summary['first_loss']}")
    tag = "train" if dtype == "bfloat16" else "train-f32"
    _print(f"[{tag}] gpt_small {dtype or 'float32 (default)'} B=8 S=1024, "
           f"{steps} steps + {evals} eval batches: wall {wall:.2f} s, first "
           f"loss {summary['first_loss']:.4f}, epoch loss {loss:.4f}, val "
           f"loss {summary['val_losses'][0]:.4f}, tokens/s "
           f"{summary['tokens_per_sec']:.1f}, steady step "
           f"{summary['steady_step_s'] * 1e3:.2f} ms, launches "
           f"{launches} [{smi}]")
    return launches


def _sgd_buffers(torch, n, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return (torch.randn(n, generator=gen, device="cuda"),
            torch.randn(n, generator=gen, device="cuda"))


def _sgd_flags(torch, initialized):
    return (torch.tensor(initialized, device="cuda"),
            torch.zeros((), dtype=torch.int32, device="cuda"))


def _sgd_steps(torch, update, n, nesterov, **impl):
    """Four updates from the same start: the first (init 0), two more,
    one skipped (keep False, NaN gradients) between them; returns
    (params, momenta, initialized, count)."""
    p, g0 = _sgd_buffers(torch, n, seed=n + int(nesterov))
    buf = torch.zeros_like(p)
    init, count = _sgd_flags(torch, False)
    for step, keep in enumerate((True, True, False, True)):
        grads = g0 * (step + 1) - 0.5
        if not keep:
            grads[7] = float("nan")
        update(p, grads, buf, init, count, torch.tensor(keep, device="cuda"),
               nesterov=nesterov, **SGD_HYPER, **impl)
    torch.cuda.synchronize()
    return p, buf, bool(init), int(count)


def _sgd_bound(n, rate):
    t_bytes = SGD_BYTES_PER_ELEMENT * n / rate
    t_ops = SGD_FLOPS_PER_ELEMENT * n / F32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _time_sgd(torch, fused_sgd_, torch_fused_sgd_, n, rate):
    """At ``n``: the kernel's device ms (CUDA graph) and eager ms, the
    plain version's device ms, the library yardstick's (the kernel
    ``torch.optim.SGD(fused=True).step()`` launches, ``torch._fused_sgd_``,
    graph-timed) and the eager ``step()``, and the bound. Launches made
    here are not counted."""
    p, g = _sgd_buffers(torch, n, seed=3)
    buf = torch.zeros_like(p)
    init, count = _sgd_flags(torch, True)
    keep = torch.tensor(True, device="cuda")
    launches = fused_sgd_.launches

    def kernel():
        fused_sgd_(p, g, buf, init, count, keep, impl="cuda", nesterov=True,
                   **SGD_HYPER)

    ms = _device_ms(kernel, torch)
    eager_ms = _eager_ms(kernel, torch)
    fused_sgd_.launches = launches
    plain_ms = _device_ms(lambda: torch_fused_sgd_(
        p, g, buf, init, count, keep, nesterov=True, **SGD_HYPER), torch)
    lib_p, lib_buf = p.clone(), buf.clone()

    def library():
        torch._fused_sgd_([lib_p], [g], [lib_buf], weight_decay=1e-4,
                          momentum=0.9, lr=0.1, dampening=0.0, nesterov=True,
                          maximize=False, is_first_step=False)

    library_ms = _device_ms(library, torch)
    param = torch.nn.Parameter(p.clone())
    param.grad = g
    opt = torch.optim.SGD([param], lr=0.1, momentum=0.9, weight_decay=1e-4,
                          nesterov=True, fused=True)
    step_ms = _eager_ms(opt.step, torch)
    bound_ms, bound_by = _sgd_bound(n, rate)
    return dict(ms=ms, eager_ms=eager_ms, plain_ms=plain_ms,
                library_ms=library_ms, library_step_ms=step_ms,
                bound_ms=bound_ms, bound_by=bound_by)


def _variant_case(torch, quantize_kv, variant, window, dtype, seed,
                  head_dim=None, heads=None):
    """Inputs of one decode variant at gpt_small decode shapes (another
    ``head_dim``, or a rank's ``heads``, where given): q, K/V
    (an int8 dense window view of an s_max cache, or page storage with a
    scratch page 0 of NaN and 1e30), the shuffled table (paged) and
    positions 0, W-1, one beyond the window and random columns."""
    _, paged, quant = VARIANTS[variant][1:]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    n, h, d = (DECODE_SHAPE[k] for k in ("slots", "heads", "head_dim"))
    d, h = head_dim or d, heads or h
    q = torch.randn(n, 1, h, d, generator=gen, device="cuda").to(dtype)
    pos = torch.randint(0, window, (n,), generator=gen, device="cuda")
    pos[0], pos[1], pos[2] = 0, window - 1, window + 5
    pos = pos.to(torch.int32)
    if not paged:
        s_max = max(PAGED_WINDOWS)
        k = quantize_kv(torch.randn(n, s_max, h, d, generator=gen,
                                    device="cuda") * 2)
        v = quantize_kv(torch.randn(n, s_max, h, d, generator=gen,
                                    device="cuda"))
        return q, k[:, :window], v[:, :window], None, pos
    ps = PAGE_SIZE
    n_win = window // ps
    n_pages = 1 + n * n_win + 7
    k = torch.randn(n_pages, h, ps, d, generator=gen, device="cuda")
    v = torch.randn(n_pages, h, ps, d, generator=gen, device="cuda")
    perm = torch.randperm(n_pages - 1, generator=gen, device="cuda") + 1
    table = perm[:n * n_win].view(n, n_win).to(torch.int32)
    for row, p in enumerate(pos.tolist()):
        table[row, -(-(min(p, window - 1) + 1) // ps):] = 0
    if quant:
        k, v = quantize_kv(k * 2), quantize_kv(v)
        k.data[0], v.data[0] = 127, 127
        k.scale[0], v.scale[0] = float("nan"), 1e30
    else:
        k, v = k.to(dtype), v.to(dtype)
        k[0], v[0] = float("nan"), 1e30
    return q, k, v, table, pos


def _variant_calls(da, variant, q, k, v, table, pos, window):
    """(kernel call, plain call) of one variant on one input."""
    if table is None:
        return (lambda: da.decode_attention(q, k, v, pos, impl="cuda"),
                lambda: da.torch_decode_attention(q, k, v, pos))
    return (lambda: da.paged_decode_attention(q, k, v, table, pos,
                                              window=window, impl="cuda"),
            lambda: da.torch_paged_decode_attention(q, k, v, table, pos,
                                                    window))


def _variant_bound(q, k, table, pos, window, rate):
    """Least time for one variant's work on these inputs: each row
    reads its min(pos, W-1)+1 columns of K and V once (int8: a byte a
    lane plus a 4-byte scale per (token, head); else 2 or 4 bytes a
    lane), its table entries, q, positions and the f32 output; the f32
    math is 4 flops per K/V element read, plus one dequant product per
    int8 element."""
    n, _, h, d = q.shape
    cols_per_row = (pos.long().clamp(max=window - 1) + 1).tolist()
    cols = sum(cols_per_row)
    quant = hasattr(k, "scale")
    group = d + 4 if quant else d * k.element_size()
    entries = (sum(-(-c // PAGE_SIZE) for c in cols_per_row)
               if table is not None else 0)
    nbytes = (2 * cols * h * group + q.numel() * q.element_size() + n * 4
              + entries * 4 + q.numel() * 4)
    flops = cols * h * d * (4 + (2 if quant else 0))
    t_bytes, t_ops = nbytes / rate, flops / F32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _time_variant(torch, F, da, variant, q, k, v, table, pos, window,
                  rate):
    """Device times of one variant's kernel (its inputs L2-warm, and
    L2-cold), its plain version and the library call (SDPA on the window
    gathered and dequantized before the timing), the kernel's eager time
    and the bound. Launches made here are not counted."""
    counts = _decode_counts(da)
    kernel, plain = _variant_calls(da, variant, q, k, v, table, pos,
                                   window)
    cold_ms = _cold_ms(
        lambda *x: _variant_calls(da, variant, *x, window)[0](),
        (q, k, v, table, pos), torch)
    if table is None:
        kd, vd = (da.dequantize_kv(t, q.dtype) for t in (k, v))
    else:
        kd, vd = (da._gather_paged_window(t, table, q.dtype, window)
                  for t in (k, v))
    mask = (torch.arange(window, device="cuda")[None, :]
            <= pos.long()[:, None])[:, None, None, :]
    qt, kt, vt = (t.transpose(1, 2) for t in (q, kd, vd))
    scale = q.shape[-1] ** -0.5
    bound_ms, bound_by = _variant_bound(q, k, table, pos, window, rate)
    t = dict(
        ms=_device_ms(kernel, torch), cold_ms=cold_ms,
        eager_ms=_eager_ms(kernel, torch), plain_ms=_device_ms(plain, torch),
        library_ms=_device_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, scale=scale), torch),
        bound_ms=bound_ms, bound_by=bound_by)
    _set_decode_counts(da, counts)
    return t


_COUNTED = ("decode_attention", "paged_decode_attention",
            "verify_decode_attention", "paged_verify_decode_attention")


def _decode_split_ab(torch, da, variant, inputs, window):
    """The decode kernels at each split of DECODE_AB_SPLITS in turns
    (forward, then back), each call first checked against the plain
    version: ``{split: ([L2-warm ms], [L2-cold ms])}``."""
    kernel, plain = _variant_calls(da, variant, *inputs, window)
    ref = plain()
    default = da.DECODE_SPLIT
    times = {split: ([], []) for split in DECODE_AB_SPLITS}
    try:
        for split in DECODE_AB_SPLITS + DECODE_AB_SPLITS[::-1]:
            da.DECODE_SPLIT = split
            err = float((kernel() - ref).abs().max())
            if not err <= PAGED_TOL:
                raise AssertionError(
                    f"{variant} split {split}: max|err| {err} > "
                    f"{PAGED_TOL}")
            times[split][0].append(_device_ms(kernel, torch))
            times[split][1].append(_cold_ms(
                lambda *x: _variant_calls(da, variant, *x, window)[0](),
                inputs, torch))
    finally:
        da.DECODE_SPLIT = default
    return times


def _zero_decode_counts(da):
    """Every decode and verify variant's launch count to 0."""
    for name in _COUNTED:
        getattr(da, name).launches = 0
        getattr(da, name).int8_launches = 0


def _set_decode_counts(da, counts):
    """Put back the launch counts :func:`_decode_counts` read."""
    for name in _COUNTED:
        getattr(da, name).launches = counts[name]
        getattr(da, name).int8_launches = counts[f"{name}_int8"]


def _decode_counts(da):
    """Launch counts of the eight decode and verify variants, by the
    variant names of the kernels line."""
    counts = {}
    for name in _COUNTED:
        counts[name] = getattr(da, name).launches
        counts[f"{name}_int8"] = getattr(da, name).int8_launches
    return counts


def _verify_case(torch, quantize_kv, variant, window, dtype, seed,
                 rows=VERIFY_ROWS, head_dim=None, heads=None):
    """Inputs of one verify variant at gpt_small decode shapes: q ``[8,
    rows, 12, 64]`` (K1 = ``rows``; another Dh than 64 where
    ``head_dim`` is given, a rank's ``heads`` than 12), K/V (a dense window view of an s_max
    cache, or page storage with a scratch page 0 of NaN and 1e30 that no
    entry up to a slot's last reachable column points at), the shuffled
    table (paged) and positions 0, W-K1 (the last row lands on column
    W-1), W-2 (rows reach past the window) and random columns."""
    _, _, paged, quant = VERIFY_VARIANTS[variant]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    n, h, d = (DECODE_SHAPE[k] for k in ("slots", "heads", "head_dim"))
    d, h = head_dim or d, heads or h
    q = torch.randn(n, rows, h, d, generator=gen, device="cuda").to(dtype)
    pos = torch.randint(0, window - rows, (n,), generator=gen, device="cuda")
    pos[0], pos[1], pos[2] = 0, window - rows, window - 2
    pos = pos.to(torch.int32)
    if not paged:
        s_max = max(PAGED_WINDOWS) + DRAFT_K  # the spare columns
        k = torch.randn(n, s_max, h, d, generator=gen, device="cuda") * 2
        v = torch.randn(n, s_max, h, d, generator=gen, device="cuda")
        if quant:
            k, v = quantize_kv(k), quantize_kv(v)
        else:
            k, v = k.to(dtype), v.to(dtype)
        return q, k[:, :window], v[:, :window], None, pos
    ps = PAGE_SIZE
    n_win = window // ps
    n_pages = 1 + n * n_win + 7
    k = torch.randn(n_pages, h, ps, d, generator=gen, device="cuda")
    v = torch.randn(n_pages, h, ps, d, generator=gen, device="cuda")
    perm = torch.randperm(n_pages - 1, generator=gen, device="cuda") + 1
    table = perm[:n * n_win].view(n, n_win).to(torch.int32)
    for row, p in enumerate(pos.tolist()):
        reach = min(p + rows - 1, window - 1)
        table[row, -(-(reach + 1) // ps):] = 0
    if quant:
        k, v = quantize_kv(k * 2), quantize_kv(v)
        k.data[0], v.data[0] = 127, 127
        k.scale[0], v.scale[0] = float("nan"), 1e30
    else:
        k, v = k.to(dtype), v.to(dtype)
        k[0], v[0] = float("nan"), 1e30
    return q, k, v, table, pos


def _paged_twin(torch, da, k, v, pos, window, seed, rows=VERIFY_ROWS):
    """The dense window ``k``/``v`` (``[8, W, 12, 64]``, or its int8
    pair) laid out in shuffled pages of PAGE_SIZE behind a scratch page 0
    (K NaN, V 1e30; int8: 127 with those scales), with the table entries
    past each slot's last reachable column (of ``rows`` query rows) on
    page 0: (K pages, V pages, table)."""
    n, _, h, _ = k.shape
    ps = PAGE_SIZE
    n_win = -(-window // ps)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    table = (torch.randperm(n * n_win, generator=gen, device="cuda")
             + 1).view(n, n_win).to(torch.int32)

    def lay(x, garbage):
        if hasattr(x, "scale"):
            return da.QuantizedKV(
                lay(x.data, 127), lay(x.scale[..., None], garbage)[..., 0])
        d = x.shape[-1]
        pages = torch.full((1 + n * n_win, h, ps, d), garbage,
                           dtype=x.dtype, device="cuda")
        pages[table.long()] = x.reshape(n, n_win, ps, h, d).permute(
            0, 1, 3, 2, 4)
        return pages

    kp, vp = lay(k, float("nan")), lay(v, 1e30)
    for row, p in enumerate(pos.tolist()):
        reach = min(p + rows - 1, window - 1)
        table[row, -(-(reach + 1) // ps):] = 0
    return kp, vp, table


def _verify_calls(da, q, k, v, table, pos, window):
    """(kernel call, plain call) of one verify variant on one input."""
    if table is None:
        return (lambda: da.verify_decode_attention(q, k, v, pos,
                                                   impl="cuda"),
                lambda: da.torch_verify_decode_attention(q, k, v, pos))
    return (lambda: da.paged_verify_decode_attention(
        q, k, v, table, pos, window=window, impl="cuda"),
        lambda: da.torch_paged_verify_decode_attention(q, k, v, table, pos,
                                                       window))


def _verify_bound(q, k, table, pos, window, rate):
    """Least time for one verify variant's work on these inputs: each
    slot reads the columns its last row reaches, min(pos + K1 - 1, W-1)
    + 1, of K and V once (int8: a byte a lane plus a 4-byte scale per
    (token, head)), its table entries, q, positions and the f32 output;
    row i does 4 flops per Dh lane for each of its min(pos + i, W-1) + 1
    columns, at the peak of q's type (bf16 on the tensor cores, f32
    outside them)."""
    n, k1, h, d = q.shape
    reach = [min(p + k1 - 1, window - 1) + 1 for p in pos.tolist()]
    rows = sum(min(p + i, window - 1) + 1 for p in pos.tolist()
               for i in range(k1))
    quant = hasattr(k, "scale")
    group = d + 4 if quant else d * k.element_size()
    entries = (sum(-(-c // PAGE_SIZE) for c in reach)
               if table is not None else 0)
    nbytes = (2 * sum(reach) * h * group + q.numel() * q.element_size()
              + n * 4 + entries * 4 + q.numel() * 4)
    peak = (BF16_FLOPS_PER_S if q.element_size() == 2
            else F32_FLOPS_PER_S)
    t_bytes, t_ops = nbytes / rate, 4 * rows * h * d / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _time_verify(torch, F, da, q, k, v, table, pos, window, rate):
    """Device times of one verify variant's kernel, its plain version
    and the library call (SDPA with the row-staggered mask on the window
    gathered and dequantized before the timing), the kernel's eager time
    and the bound. Launches made here are not counted."""
    kernel, plain = _verify_calls(da, q, k, v, table, pos, window)
    if table is None:
        kd, vd = ((da.dequantize_kv(t, q.dtype) if hasattr(t, "scale")
                   else t) for t in (k, v))
    else:
        kd, vd = (da._gather_paged_window(t, table, q.dtype, window)
                  for t in (k, v))
    rows = torch.arange(q.shape[1], device="cuda")
    mask = (torch.arange(window, device="cuda")[None, None, :]
            <= pos.long()[:, None, None] + rows[None, :, None])[:, None]
    qt, kt, vt = (t.transpose(1, 2) for t in (q, kd, vd))
    scale = q.shape[-1] ** -0.5
    bound_ms, bound_by = _verify_bound(q, k, table, pos, window, rate)
    return dict(
        ms=_device_ms(kernel, torch), eager_ms=_eager_ms(kernel, torch),
        plain_ms=_device_ms(plain, torch),
        library_ms=_device_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, scale=scale), torch),
        bound_ms=bound_ms, bound_by=bound_by)


def _split_profile(torch, kernel, names):
    """Device time a call of each kernel in ``names`` (a split kernel
    and its merge kernel), from ``torch.profiler`` over PROFILE_CALLS
    eager calls (None where the trace shows no device time). Launches
    made here are not counted."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(5):
        kernel()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_CALLS):
            kernel()
        torch.cuda.synchronize()
    times = dict.fromkeys(names)
    for event in prof.key_averages():
        total = getattr(event, "device_time_total", 0)
        for name in times:
            if name in event.key and total > 0:
                times[name] = total / PROFILE_CALLS
    return times


def _stream_ms(fn, torch, calls=GRAPH_CALLS, reps=10):
    """Device time of one call that no CUDA graph holds: ``calls``
    back-to-back eager calls between CUDA events, the median over
    ``reps`` divided by ``calls`` (calls that the host queues faster than
    the card runs them give the device time)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def _topology(torch) -> str:
    """The links between the visible cards: the peer-access matrix
    (``torch.cuda.can_device_access_peer``, row reaches column), what
    ``nvidia-smi topo -m`` prints (or its failure), and per card the
    NVLinks and their rates from ``nvidia-smi nvlink --status``."""
    cards = torch.cuda.device_count()
    peer = [["-" if i == j else int(torch.cuda.can_device_access_peer(i, j))
             for j in range(cards)] for i in range(cards)]
    topo = subprocess.run(["nvidia-smi", "topo", "-m"], capture_output=True,
                          text=True)
    links = subprocess.run(["nvidia-smi", "nvlink", "--status"],
                           capture_output=True, text=True)
    rates, card = {}, None
    for line in links.stdout.splitlines():
        head = re.match(r"\s*GPU (\d+):", line)
        link = re.match(r"\s*Link \d+: ([\d.]+) GB/s", line)
        if head:
            card = int(head.group(1))
            rates[card] = []
        elif link and card is not None:
            rates[card].append(link.group(1))
    nvlink = "; ".join(f"card {c}: {len(r)} links at {sorted(set(r))} GB/s"
                       for c, r in rates.items()) or "no links reported"
    shown = (topo.stdout.rstrip() if topo.returncode == 0 else
             f"rc {topo.returncode} ({(topo.stdout + topo.stderr).strip()})")
    return (f"{cards} card(s); peer access {peer}; nvidia-smi nvlink "
            f"--status: {nvlink}; nvidia-smi topo -m: {shown}")


def _ring_inputs(torch, n, shape, dtype, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [(torch.randn(shape, generator=gen, device="cuda") * 1e3).to(dtype)
            for _ in range(n)]


def _time_ring(torch, ring, n, size, rate):
    """At n ranks of ``size`` f32 elements in loopback: the kernel's
    device time on a prepared work buffer (in place), the wrapper's
    device time (``_stream_ms``: its one launch on the caller's tensors
    and the outputs' allocation) and eager time, the plain version's and
    ``torch.sum`` over the stacked ranks, and the HBM bound (each rank's
    payload read once, its result written once). Launches made here are
    not counted."""
    xs = _ring_inputs(torch, n, (size,), torch.float32, seed=18)
    work = torch.zeros(n, ring.ring_layout(size, n)[2], device="cuda")
    launches = ring.ring_all_reduce_loopback.launches
    ms = _stream_ms(lambda: ring.launch_loopback_(work), torch)
    wrapper_ms = _stream_ms(lambda: ring.ring_all_reduce_loopback(
        xs, impl="cuda"), torch)
    eager_ms = _eager_ms(lambda: ring.ring_all_reduce_loopback(
        xs, impl="cuda"), torch)
    ring.ring_all_reduce_loopback.launches = launches
    plain_ms = _stream_ms(lambda: ring.torch_ring_all_reduce(xs), torch,
                          calls=5)
    stacked = torch.stack(xs)
    library_ms = _device_ms(lambda: torch.sum(stacked, dim=0), torch)
    t_bytes = 2 * n * size * 4 / rate
    t_ops = (n - 1) * size / F32_FLOPS_PER_S
    return dict(ms=ms, wrapper_ms=wrapper_ms, eager_ms=eager_ms,
                plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def _ring_ab(ring):
    """``--ring_configs`` of the A/B: the defaults first, then each
    setting of ``RING_AB_VALUES`` changed alone, as ``G:T:S:K:C``."""
    base = (ring.RING_BLOCKS, ring.RING_THREADS, ring.RING_STEP,
            ring.RING_SLOTS, ring.RING_CONTROL)
    configs = [base]
    for i, values in enumerate(RING_AB_VALUES):
        configs += [base[:i] + (v,) + base[i + 1:] for v in values
                    if v != base[i]]
    return [":".join(map(str, c)) for c in configs]


def _serve_transcripts(serve_lm, argv):
    """``serve_lm.main(argv)`` with its per-request lines captured:
    ``(snapshot, {uid: tokens})``."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        snap = serve_lm.main(argv)
    found = re.findall(r"^req=(\S+) tokens=(\[.*\])$", out.getvalue(),
                       re.M)
    return snap, {uid: json.loads(toks) for uid, toks in found}


def _imagenet_phase(image_main, fused_sgd_, phase, config, flags, smi,
                    inspect=None):
    """One of phases 20-22 and 24: ``main.main`` on the synthetic
    ImageNet set at 224 with ``flags``; asserts the steps, the files and
    finite losses; prints images/s a card, the first and last loss and
    the peak memory; ``inspect(save_path)`` then reads the run's files.
    Returns the summary, the fused SGD kernel's launches in the run and
    the peak memory (GiB)."""
    import torch

    fused_sgd_.launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        summary = image_main.main(IMAGENET_BASE + flags + ["--save_path",
                                                           tmp])
        wall = time.perf_counter() - t0
        missing = [f for f in ("train.log", "test.log", "model_1.pth",
                               "model_1.pth.sha256")
                   if not os.path.exists(os.path.join(tmp, f))]
        if inspect is not None and not missing:
            inspect(tmp)
    launches = fused_sgd_.launches
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if missing:
        raise AssertionError(f"phase {phase}: main wrote no {missing}")
    if summary["steps"] != IMAGENET_STEPS:
        raise AssertionError(
            f"phase {phase}: main ran {summary['steps']}/{IMAGENET_STEPS} "
            "train steps")
    losses = (summary["first_loss"], summary["last_loss"],
              summary["epoch_losses"][0])
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"phase {phase}: losses {losses} not finite")
    _print(f"[imagenet] phase {phase} {config}: {' '.join(flags)} at 224, "
           f"{IMAGENET_STEPS} steps + {IMAGENET_EVALS} eval batch: wall "
           f"{wall:.2f} s, first loss {losses[0]:.4f}, last loss "
           f"{losses[1]:.4f}, images/s per card "
           f"{summary['images_per_sec_per_card']:.1f}, steady step "
           f"{summary['steady_step_s'] * 1e3:.3f} ms, peak memory "
           f"{peak:.2f} GiB, fused_sgd launches {launches} [{smi}]")
    torch.cuda.empty_cache()
    return summary, launches, peak


def _zero_rank(rank, world, port, argv, out_path):
    """One NCCL rank of phase 25, started by :func:`_zero_main`: the
    ``PMDT_*`` env names the group, f32 convolutions run deterministic
    with TF32 off, then the CLI's ``main``; rank 0 writes the summary."""
    os.environ.update(PMDT_MASTER_ADDR=f"127.0.0.1:{port}",
                      PMDT_WORLD_SIZE=str(world), PMDT_RANK=str(rank))
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch

    _deterministic(torch)
    from pytorch_multiprocessing_distributed_tpu_torch import main as image_main

    summary = image_main.main(argv)
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump(summary, f)


def _deterministic(torch):
    """f32 convolutions and matmuls without TF32, deterministic cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False


def _store_port() -> int:
    """A free port for the ranks' rendezvous store, outside the kernel's
    ephemeral range where any is left: a rank still connecting before
    rank 0 listens may draw the store's own port as its local port and
    connect to itself, and rank 0 then cannot listen there."""
    with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
        lo, hi = (int(x) for x in f.read().split())
    outside = [p for p in range(10000, 65536) if not lo <= p <= hi]
    for port in random.Random(os.getpid()).sample(outside,
                                                  min(64, len(outside))):
        with socket.socket() as sock:
            try:
                sock.bind(("127.0.0.1", port))
            except OSError:
                continue
            return port
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _store_ports(n: int) -> list:
    """``n`` distinct free ports for the rendezvous stores of
    consecutive groups: a rank that leaves one group early must not find
    the store of the group it just left on the next group's port."""
    ports, held = [], []
    try:
        while len(ports) < n:
            port = _store_port()
            sock = socket.socket()
            try:
                sock.bind(("127.0.0.1", port))
            except OSError:
                sock.close()
                continue
            held.append(sock)
            ports.append(port)
    finally:
        for sock in held:
            sock.close()
    return ports


def _run_ranks(target, world, args, timeout_s=600, per_rank=False):
    """``target(rank, world, port, *args, out_path)`` in ``world``
    spawned processes, one a card, joined within ``timeout_s`` (every
    process stopped); returns the JSON rank 0 writes to ``out_path``,
    or with ``per_rank`` the list of every rank's, each written to
    ``{out_path}.{rank}``."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "summary.json")
        port = _store_port()
        ctx = mp.start_processes(target, args=(world, port, *args, out),
                                 nprocs=world, join=False,
                                 start_method="spawn")
        deadline = time.monotonic() + timeout_s
        try:
            while not ctx.join(timeout=max(0.0,
                                           deadline - time.monotonic())):
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"{target.__name__} ranks still "
                                       f"running after {timeout_s} s")
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.terminate()
                    proc.join(5)
        if not per_rank:
            with open(out) as f:
                return json.load(f)
        ranks = []
        for r in range(world):
            with open(f"{out}.{r}") as f:
                ranks.append(json.load(f))
        return ranks


def _zero_main(image_main, argv, world, timeout_s=600):
    """``main.main(argv)`` on ``world`` ranks: in this process for one,
    else one spawned process a card. Returns the primary rank's
    summary."""
    import torch

    _deterministic(torch)
    if world == 1:
        return image_main.main(argv)
    return _run_ranks(_zero_rank, world, (argv,), timeout_s)


def _payload_diff(torch, path_a, path_b, prefix):
    """The largest |a - b| over the two checkpoints' floating ``prefix``
    tensors; their other ``prefix`` entries (count, ``initialized``)
    must be equal."""
    a = torch.load(path_a, map_location="cpu", weights_only=True)
    b = torch.load(path_b, map_location="cpu", weights_only=True)
    keys = [k for k in a if k.startswith(prefix)]
    if not keys or set(keys) != {k for k in b if k.startswith(prefix)}:
        raise AssertionError(f"checkpoints differ in their {prefix} keys")
    for k in keys:
        if not a[k].is_floating_point() and not torch.equal(a[k], b[k]):
            raise AssertionError(f"checkpoints differ at {k}")
    return max(float((a[k] - b[k]).abs().max()) for k in keys
               if a[k].is_floating_point())


def _step_peak(torch, model, opt, step_kw, images, labels):
    """Peak memory (GiB) and device time (ms, CUDA events) of the second
    of two image steps of ``model`` on one batch."""
    from pytorch_multiprocessing_distributed_tpu_torch.train import (
        create_train_state, make_train_step)

    state = create_train_state(model, opt)
    step = make_train_step(model, opt, **step_kw)
    step(state, images, labels)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    step(state, images, labels)
    end.record()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() / 2 ** 30,
            start.elapsed_time(end))


def _zero_phase(torch, image_main, smi):
    """Phase 25: ``main.main --zero`` beside the plain run (see the module
    docstring), on min(cards, 4) ranks."""
    cards = torch.cuda.device_count()
    world = min(cards, ZERO_MAX_RANKS)
    if world < 2:
        _print(f"[zero] {cards} card visible: --zero runs on one rank (one "
               "shard, the plain run's arithmetic); its NCCL ranks need two "
               "or more cards")
    zero_tol = ZERO_PARAM_TOL if world > 1 else 0.0
    step_tol = ZERO_STEP_TOL if world > 1 else 0.0
    base = ["--device", "cuda", "--world_size", str(world), "--model", "res",
            "--synthetic", "--batch_size", str(ZERO_BATCH), "--seed", "0",
            "--print-freq", "100"]
    zero_dirs = tempfile.TemporaryDirectory()
    for opt_name, lr in (("sgd", "0.01"), ("lamb", "0.001")):
        paths, summaries, errs = {}, {}, {}
        for steps, synth, tol in ((1, ZERO_ONE_SYNTH, step_tol),
                                  (ZERO_STEPS, ZERO_SYNTH, zero_tol)):
            os.environ["PMDT_SMALL_SYNTH"] = synth
            for mode in ("plain", "zero"):
                paths[mode] = os.path.join(zero_dirs.name,
                                           f"{opt_name}-{mode}-{steps}")
                argv = base + ["--optimizer", opt_name, "--lr", lr,
                               "--epochs", "1", "--save_path",
                               paths[mode]] + (
                                   ["--zero"] if mode == "zero" else [])
                t0 = time.perf_counter()
                summaries[mode] = _zero_main(image_main, argv, world)
                summaries[mode]["wall"] = time.perf_counter() - t0
                if (summaries[mode]["steps"] != steps or not math.isfinite(
                        summaries[mode]["last_loss"])):
                    raise AssertionError(
                        f"--zero phase {mode}: {summaries[mode]}")
            ckpt = {m: os.path.join(paths[m], "model_1.pth") for m in paths}
            errs[steps] = (
                _payload_diff(torch, ckpt["plain"], ckpt["zero"], "params/"),
                _payload_diff(torch, ckpt["plain"], ckpt["zero"],
                              "opt_state/"))
            bound = errs[steps] if steps == 1 else errs[steps][:1]
            if not max(bound) <= tol:
                raise AssertionError(
                    f"--zero {opt_name} after {steps} step(s): param and "
                    f"moment differences from the plain run "
                    f"{errs[steps]} (tol {tol})")
        zb, pb = (summaries["zero"]["opt_state_bytes"],
                  summaries["plain"]["opt_state_bytes"])
        comm = summaries["zero"]["static_comm_bytes"]
        if not (len(zb) == world and max(zb) * world == comm["reduce_scatter"]
                * (2 if opt_name == "lamb" else 1)):
            raise AssertionError(f"--zero {opt_name}: optimizer-state bytes "
                                 f"{zb} per rank, plan {comm}")
        _print(f"[zero] {opt_name} ResNet-18 B={ZERO_BATCH} on {world} "
               f"rank(s), --zero vs plain: after 1 step max |param diff| "
               f"{errs[1][0]:.3e}, |moment diff| {errs[1][1]:.3e} (tol "
               f"{step_tol}); after {ZERO_STEPS} steps |param diff| "
               f"{errs[ZERO_STEPS][0]:.3e} (tol {zero_tol}), |moment diff| "
               f"{errs[ZERO_STEPS][1]:.3e}; optimizer-state bytes per rank "
               f"--zero {zb} plain {pb}; static_comm_bytes {comm}; wall of "
               f"the {ZERO_STEPS}-step runs plain "
               f"{summaries['plain']['wall']:.1f} s, --zero "
               f"{summaries['zero']['wall']:.1f} s [{smi}]")
        if opt_name != "sgd":
            continue
        # the --zero checkpoint resumed by a plain run, beside the plain
        # run's own second epoch
        for mode in ("plain", "zero"):
            resumed = _zero_main(image_main, base + [
                "--optimizer", opt_name, "--lr", lr, "--epochs", "2",
                "--resume", "auto", "--save_path", paths[mode]], world)
            if resumed["steps"] != ZERO_STEPS:
                raise AssertionError(f"resumed {mode}: {resumed}")
        r_err = _payload_diff(torch, os.path.join(paths["plain"],
                                                  "model_2.pth"),
                              os.path.join(paths["zero"], "model_2.pth"),
                              "params/")
        if not r_err <= zero_tol:
            raise AssertionError(
                f"the --zero checkpoint resumed by a plain run: params "
                f"{r_err} from the plain run's (tol {zero_tol})")
        _print(f"[zero] the sgd --zero checkpoint (epoch 1, moments "
               f"gathered) resumed by a plain run for epoch 2: max |param "
               f"diff| {r_err:.3e} from the plain run's epoch 2 (tol "
               f"{zero_tol})")
    zero_dirs.cleanup()


def _gspmd_grids(cards):
    """Phase 26's runs over ``cards`` cards: ``(name, placement, (data,
    model), flags)``."""
    w = min(cards, ZERO_MAX_RANKS)
    grids = [("zero1", "zero1", (w, 1), ["--zero1"]),
             ("fsdp", "fsdp", (w, 1), ["--fsdp"])]
    if cards >= 2:
        grids.append(("mp2", "plain", (1, 2), ["--model_parallel", "2"]))
    if cards >= 4:
        grids += [("mp2-zero1", "zero1", (2, 2),
                   ["--model_parallel", "2", "--zero1"]),
                  ("mp4", "plain", (1, 4), ["--model_parallel", "4"])]
    return grids


def _resident_want(model, placement, data, mp, moments=1):
    params, stats, opt = JAX_RESIDENT[(model, placement, data, mp)]
    return {"params": params, "batch_stats": stats,
            "opt_state": moments * opt}


def _gspmd_phase(torch, image_main, smi):
    """Phase 26: ``main.main`` with ``--zero1``/``--fsdp``/
    ``--model_parallel`` beside the plain run (see the module
    docstring), then one ResNet-50 ``--fsdp`` step."""
    cards = torch.cuda.device_count()
    if cards < 2:
        _print(f"[gspmd] {cards} card visible: the grid is (1, 1), every "
               "slice is the whole leaf and each mode must be bit-equal to "
               "the plain run; (data, model) grids of NCCL ranks need two "
               "or more cards")
    base = ["--device", "cuda", "--model", "res", "--synthetic",
            "--batch_size", str(GSPMD_BATCH), "--seed", "0", "--print-freq",
            "100", "--epochs", str(GSPMD_STEPS), "--save_every", "1"]
    os.environ["PMDT_SMALL_SYNTH"] = GSPMD_SYNTH
    dirs = tempfile.TemporaryDirectory()
    for opt_name, lr in (("sgd", "0.01"), ("lamb", "0.001")):
        plains = {}

        def run(tag, data, mp, flags):
            path = os.path.join(dirs.name, f"{opt_name}-{tag}")
            t0 = time.perf_counter()
            summary = _zero_main(image_main, base + [
                "--optimizer", opt_name, "--lr", lr, "--world_size",
                str(data), "--save_path", path] + flags, data * mp)
            summary["wall"] = time.perf_counter() - t0
            if (summary["steps"] != GSPMD_STEPS
                    or not math.isfinite(summary["last_loss"])
                    or summary["grid"] != [data, mp]):
                raise AssertionError(f"gspmd run {tag}: {summary}")
            return path, summary

        for name, placement, (data, mp), flags in _gspmd_grids(cards):
            if data not in plains:
                plains[data] = run(f"plain{data}", data, 1, [])
            plain_path, plain = plains[data]
            path, summary = run(name, data, mp, flags)
            one = data * mp == 1
            errs = {e: tuple(_payload_diff(
                torch, os.path.join(plain_path, f"model_{e}.pth"),
                os.path.join(path, f"model_{e}.pth"), prefix)
                for prefix in ("params/", "opt_state/", "batch_stats/"))
                for e in (1, GSPMD_STEPS)}
            step_tol = 0.0 if one else ZERO_STEP_TOL
            if not (max(errs[1]) <= step_tol and (
                    max(errs[GSPMD_STEPS]) == 0.0 if one
                    else errs[GSPMD_STEPS][0] <= ZERO_PARAM_TOL)):
                raise AssertionError(
                    f"{' '.join(flags)} {opt_name} at ({data}, {mp}): "
                    f"param/moment/stat differences from the plain run "
                    f"after 1 and {GSPMD_STEPS} steps {errs}")
            want = _resident_want("res", placement, data, mp,
                                  2 if opt_name == "lamb" else 1)
            got = [{k: r[k] for k in want}
                   for r in summary["resident_bytes"]]
            if len(got) != data * mp or any(r != want for r in got):
                raise AssertionError(
                    f"{' '.join(flags)} at ({data}, {mp}): resident bytes "
                    f"{got}, JAX's per device {want}")
            peaks = [round(p / 2 ** 30, 3)
                     for p in summary["peak_memory_bytes"]]
            plain_peaks = [round(p / 2 ** 30, 3)
                           for p in plain["peak_memory_bytes"]]
            _print(f"[gspmd] {opt_name} ResNet-18 B={GSPMD_BATCH} "
                   f"{' '.join(flags)} on grid ({data}, {mp}) vs plain DP "
                   f"at {data}: after 1 step max |param|/|moment|/|stat| "
                   f"diff {errs[1][0]:.3e}/{errs[1][1]:.3e}/"
                   f"{errs[1][2]:.3e} (tol {step_tol}); after "
                   f"{GSPMD_STEPS} steps {errs[GSPMD_STEPS][0]:.3e}/"
                   f"{errs[GSPMD_STEPS][1]:.3e}/{errs[GSPMD_STEPS][2]:.3e} "
                   f"(param tol {0.0 if one else ZERO_PARAM_TOL}); "
                   f"resident bytes per rank {got[0]} (= JAX's per device; "
                   f"plain {plain['resident_bytes'][0]}); peak GiB per rank "
                   f"{peaks} (plain {plain_peaks}); wall of the "
                   f"{GSPMD_STEPS}-step run {summary['wall']:.1f} s (plain "
                   f"{plain['wall']:.1f} s), train {summary['train_s']:.2f}"
                   f" s (plain {plain['train_s']:.2f} s) [{smi}]")
    dirs.cleanup()
    _r50_fsdp(torch, smi)


def _r50_steps(torch):
    """Phase 26's ResNet-50 part on this rank of the ``PMDT_*`` group
    (none for one card): a warm-up and a timed step, plain and under
    ``--fsdp``, of ``R50_FSDP_BATCH`` random 224 images over the ranks;
    every rank's peak memory, resident bytes and step time."""
    from pytorch_multiprocessing_distributed_tpu_torch.models import (
        get_model, init_model)
    from pytorch_multiprocessing_distributed_tpu_torch.parallel import (
        all_gather_objects, dist)
    from pytorch_multiprocessing_distributed_tpu_torch.parallel.mesh import (
        make_grid)
    from pytorch_multiprocessing_distributed_tpu_torch.train import (
        create_train_state, make_train_step, sgd)
    from pytorch_multiprocessing_distributed_tpu_torch.train.gspmd import (
        make_train_step_tp)
    from pytorch_multiprocessing_distributed_tpu_torch.train.placement import (
        plan_placement, shard_state)

    dist.init_process("cuda")
    world = dist.get_world_size()
    grid = make_grid(world, 1)
    device = dist.device_for_rank("cuda")
    gen = torch.Generator().manual_seed(dist.get_rank())
    rows = R50_FSDP_BATCH // world
    images = torch.randn(rows, 224, 224, 3, generator=gen).to(device)
    labels = torch.randint(0, 1000, (rows,), generator=gen).to(device)
    out = {}
    for mode in ("plain", "fsdp"):
        model = init_model(get_model("resnet50", stem="imagenet",
                                     num_classes=1000), 0).to(device)
        opt = sgd(0.1)
        state = create_train_state(model, opt)
        if mode == "fsdp":
            state = shard_state(state, plan_placement(
                model, world, 1, fsdp=True), grid)
        step = (make_train_step_tp if mode == "fsdp" else make_train_step)(
            model, opt)
        step(state, images, labels)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        start, end = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
        start.record()
        _, m = step(state, images, labels)
        end.record()
        torch.cuda.synchronize()
        out[mode] = {"peak": torch.cuda.max_memory_allocated(device),
                     "ms": start.elapsed_time(end), "loss": float(m["loss"]),
                     "resident": {"params": 4 * state.params.numel(),
                                  "batch_stats": 4 * state.stats.numel(),
                                  "opt_state": 4 * state.momentum.numel()}}
        del model, state, step, m
        torch.cuda.empty_cache()
    every = all_gather_objects(out) if world > 1 else [out]
    dist.destroy_process_group()
    return every


def _r50_rank(rank, world, port, out_path):
    """One NCCL rank of :func:`_r50_steps`; rank 0 writes the results."""
    os.environ.update(PMDT_MASTER_ADDR=f"127.0.0.1:{port}",
                      PMDT_WORLD_SIZE=str(world), PMDT_RANK=str(rank))
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch

    every = _r50_steps(torch)
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump(every, f)


def _r50_fsdp(torch, smi):
    """One ResNet-50 ``--fsdp`` step beside the plain step on
    min(cards, 4) ranks (see the module docstring)."""
    world = min(torch.cuda.device_count(), ZERO_MAX_RANKS)
    every = (_r50_steps(torch) if world == 1
             else _run_ranks(_r50_rank, world, ()))
    for mode, placement in (("plain", "plain"), ("fsdp", "fsdp")):
        want = _resident_want("resnet50", placement,
                              1 if mode == "plain" else world, 1)
        got = [r[mode]["resident"] for r in every]
        if any(r != want for r in got) or not all(
                math.isfinite(r[mode]["loss"]) for r in every):
            raise AssertionError(f"ResNet-50 {mode} step on {world} rank(s):"
                                 f" {every}, JAX's per device {want}")
    _print(f"[gspmd] ResNet-50 (ImageNet stem, 1000 classes) sgd, one step "
           f"of batch {R50_FSDP_BATCH} at 224 on {world} rank(s): peak GiB "
           f"per rank --fsdp "
           f"{[round(r['fsdp']['peak'] / 2 ** 30, 3) for r in every]}, "
           f"plain {[round(r['plain']['peak'] / 2 ** 30, 3) for r in every]};"
           f" resident bytes per rank --fsdp {every[0]['fsdp']['resident']}"
           f", plain {every[0]['plain']['resident']} (= JAX's per device); "
           f"step ms (CUDA events) --fsdp "
           f"{[round(r['fsdp']['ms'], 2) for r in every]}, plain "
           f"{[round(r['plain']['ms'], 2) for r in every]} [{smi}]")


FLASH_ROWS = {"flash_fwd": "5", "flash_bwd_dq": "6", "flash_bwd_dkv": "7"}


def _by_head_dim(times, row):
    """``{"Dh48": ms, "Dh64": ms, "Dh96": ms}`` of one kernel row."""
    return {f"Dh{d}": t[row] for d, t in times.items()}


def _imagenet_host_ms(batch):
    """Host milliseconds to assemble one synthetic ImageNet train batch
    of ``batch`` at 224 (index hash, flip, normalise; no copy to the
    card), median of three, inline (no producer thread)."""
    from pytorch_multiprocessing_distributed_tpu_torch.data import (
        IndexedLoader, SyntheticImageNet)

    loader = IndexedLoader(SyntheticImageNet(4 * batch), batch_size=batch,
                           world_size=1, prefetch_batches=0)
    times, it = [], iter(loader)
    for _ in range(3):
        t0 = time.perf_counter()
        next(it)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _vit_block_check(torch, vit, dtype, seed):
    """One ViT-B/16 encoder block with ``flash=True`` against the same
    block (same weights, same input) with ``flash=False``, forward and
    backward; returns the two blocks' (out, input grad, param grads)."""
    cfg = VIT_BLOCK
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(cfg["batch"], cfg["seq"], cfg["dim"], generator=gen,
                    device="cuda").to(dtype)
    g = torch.randn(x.shape, generator=gen, device="cuda").to(dtype)
    blocks = {}
    for flash in (False, True):
        torch.manual_seed(seed)
        block = vit.EncoderBlock(cfg["dim"], cfg["heads"], cfg["mlp"],
                                 flash=flash).cuda()
        for prm in block.parameters():
            torch.nn.init.normal_(prm, 0.0, 0.05)
        xi = x.clone().requires_grad_()
        out = block(xi)
        out.backward(g)
        blocks[flash] = (out.detach().float(), xi.grad.float(),
                         [p.grad.float() for p in block.parameters()])
    return blocks


def _block_err(a, b, normwise=False):
    """The largest |a - b| over a block's output, input grad and param
    grads; ``normwise``: each over its tensor's largest |b| (at least
    1), as the bf16 comparison reads it."""
    def err(x, y):
        e = float((x - y).abs().max())
        return e / max(1.0, float(y.abs().max())) if normwise else e

    return max([err(a[0], b[0]), err(a[1], b[1])]
               + [err(x, y) for x, y in zip(a[2], b[2])])


def _head_dim_checks(torch, quantize_kv, da, fa, d):
    """Rows 1-7 (and 1q-4q) against their plain versions at head_dim
    ``d`` in f32 and bf16: each wrapper must launch its kernel (its
    count rises by one a call). Returns the largest error by row."""
    errs = {}
    counted = _decode_counts(da)
    fa_saved = {n: getattr(fa, n).launches for n in FLASH_PRODUCTS}
    for dtype in (torch.float32, torch.bfloat16):
        w = HEAD_DIM_WINDOW
        q, k, v, pos = _decode_inputs(torch, w, dtype, seed=d,
                                      head_dim=d)
        cases = [("1", lambda: da.decode_attention(q, k, v, pos,
                                                   impl="cuda"),
                  lambda: da.torch_decode_attention(q, k, v, pos),
                  da.decode_attention, "launches", TOL["float32"])]
        for variant, (row, _, paged, quant) in VARIANTS.items():
            args = _variant_case(torch, quantize_kv, variant, w, dtype,
                                 seed=d + 1, head_dim=d)
            kern, plain = _variant_calls(da, variant, *args, w)
            fn = da.paged_decode_attention if paged else da.decode_attention
            cases.append((row, kern, plain, fn,
                          "int8_launches" if quant else "launches",
                          PAGED_TOL))
        for variant, (row, _, paged, quant) in VERIFY_VARIANTS.items():
            args = _verify_case(torch, quantize_kv, variant, w, dtype,
                                seed=d + 2, head_dim=d)
            kern, plain = _verify_calls(da, *args, w)
            fn = (da.paged_verify_decode_attention if paged
                  else da.verify_decode_attention)
            cases.append((row, kern, plain, fn,
                          "int8_launches" if quant else "launches",
                          VERIFY_TOL))
        for row, kern, plain, fn, counter, tol in cases:
            before = getattr(fn, counter)
            got, ref = kern(), plain()
            torch.cuda.synchronize()
            if getattr(fn, counter) != before + 1:
                raise AssertionError(
                    f"Dh {d} row {row}: the kernel did not launch")
            err = float((got - ref).abs().max())
            if not (got.shape[-1] == d and err <= tol):
                raise AssertionError(
                    f"Dh {d} row {row} {dtype}: max|err| {err} (tol {tol}),"
                    f" shape {tuple(got.shape)}")
            errs[row] = max(errs.get(row, 0.0), err)
        tname = "float32" if dtype == torch.float32 else "bfloat16"
        for sq, skv in HEAD_DIM_FLASH["seqs"]:
            for causal in ((True, False) if sq == skv else (False,)):
                q, k, v, do = _flash_inputs(
                    torch, HEAD_DIM_FLASH["batch"], sq, skv,
                    HEAD_DIM_FLASH["heads"], d, dtype, seed=d + sq)
                kernels, plains, _, _ = _flash_calls(fa, q, k, v, do,
                                                     causal)
                before = [getattr(fa, n).launches for n in kernels]
                for name, e in _flash_errors(torch, kernels, plains,
                                             FLASH_TOL[tname]).items():
                    row = FLASH_ROWS[name]
                    errs[row] = max(errs.get(row, 0.0), e)
                if [getattr(fa, n).launches for n in kernels] != \
                        [n + 1 for n in before]:
                    raise AssertionError(
                        f"Dh {d}: a flash kernel did not launch")
    _set_decode_counts(da, counted)
    for n, count in fa_saved.items():
        getattr(fa, n).launches = count
    return errs


def _head_dim_times(torch, quantize_kv, da, fa, d):
    """Device ms of each row's kernel at head_dim ``d``: the decode
    family at gpt_small's decode shape (8 slots, 12 heads, W 1024, bf16
    q; rows 3-4 at K1 5), rows 5-7 at gpt_small's training shape (B 8,
    H 12, S 1024, causal, bf16). Launches made here are not counted."""
    saved = _decode_counts(da)
    fa_saved = {n: getattr(fa, n).launches for n in FLASH_PRODUCTS}
    w, dt = max(WINDOWS), torch.bfloat16
    out = {}
    q, k, v, pos = _decode_inputs(torch, w, dt, seed=7, head_dim=d)
    out["1"] = _device_ms(lambda: da.decode_attention(q, k, v, pos,
                                                      impl="cuda"), torch)
    for variant, (row, *_) in VARIANTS.items():
        args = _variant_case(torch, quantize_kv, variant, w, dt, seed=8,
                             head_dim=d)
        out[row] = _device_ms(_variant_calls(da, variant, *args, w)[0],
                              torch)
    for variant, (row, *_) in VERIFY_VARIANTS.items():
        args = _verify_case(torch, quantize_kv, variant, w, dt, seed=9,
                            head_dim=d)
        out[row] = _device_ms(_verify_calls(da, *args, w)[0], torch)
    shape = FLASH_SHAPE
    q, k, v, do = _flash_inputs(torch, shape["batch"], shape["seq"],
                                shape["seq"], shape["heads"], d, dt, seed=6)
    kernels, _, _, _ = _flash_calls(fa, q, k, v, do, True)
    for name, row in FLASH_ROWS.items():
        out[row] = _device_ms(kernels[name], torch, calls=5, reps=20)
    _set_decode_counts(da, saved)
    for n, count in fa_saved.items():
        getattr(fa, n).launches = count
    torch.cuda.empty_cache()
    return out


def _sp_launches_want(mode, deg, rank, layers=12):
    """Each flash kernel's launches a train step on seq rank ``rank`` of
    ``deg`` under ``mode`` (None: the plain DP step): the hop schedule's
    folds a layer (ring ``rank + 1``, zigzag ``2 deg + 1``, ulysses and
    DP 1)."""
    per = {None: 1, "dp": 1, "ulysses": 1, "ring": rank + 1,
           "zigzag": 2 * deg + 1}[mode]
    return {n: layers * per for n in FLASH_PRODUCTS}


def _sp_step_run(torch, fa, dtype, mode, tokens, chunks=0, steps=1,
                 max_seq_len=None, profile=False):
    """``steps`` train steps of gpt_small (plain DP step for ``mode`` None,
    else the SP step on the grid already made) from seed 0's params on
    ``tokens`` ``[steps, B, S]`` on this process's card: losses, the
    params after the first step (on the host), the first step's flash
    launches, the peak memory above the state and the later steps' mean
    device time (CUDA events); with ``profile``, where two more steps'
    device time goes (``profile_train_lm``'s kernel groups, ms a
    step)."""
    from pytorch_multiprocessing_distributed_tpu_torch.models import (
        get_model)
    from pytorch_multiprocessing_distributed_tpu_torch.serving import (
        init_params)
    from pytorch_multiprocessing_distributed_tpu_torch.train import (
        create_lm_train_state, make_lm_train_step, sgd)

    kw = {} if mode is None else dict(seq_axis="seq", sp_mode=mode)
    if max_seq_len:
        kw["max_seq_len"] = max_seq_len
    model = get_model("gpt_small", dtype=dtype, **kw)
    dev = torch.device("cuda", torch.cuda.current_device())
    state = create_lm_train_state(model, init_params(model, 0, dev))
    step = make_lm_train_step(model, sgd(SP_LR), seq_axis=kw.get("seq_axis"),
                              vocab_chunks=chunks)
    for n in FLASH_PRODUCTS:
        getattr(fa, n).launches = 0
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    losses = [float(step(state, tokens[0])[1]["loss"])]
    peak = torch.cuda.max_memory_allocated() - base
    launches = {n: getattr(fa, n).launches for n in FLASH_PRODUCTS}
    params = state.params.detach().cpu()
    times = []
    for tok in tokens[1:steps]:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        _, m = step(state, tok)
        end.record()
        losses.append(float(m["loss"]))
        times.append(start.elapsed_time(end))
    out = dict(losses=losses, params=params, launches=launches,
               peak_gib=peak / 2 ** 30,
               step_ms=statistics.mean(times) if times else None,
               state_gib=base / 2 ** 30)
    if profile:
        from pytorch_multiprocessing_distributed_tpu_torch.profile_train_lm \
            import profile_steps

        step_s, kernels, groups = profile_steps(
            lambda i: step(state, tokens[-1]), 2)
        out["profile"] = dict(
            step_ms=step_s * 1e3,
            busy_ms=sum(kernels.values()) / 1e3 / 2,
            groups_ms={g: us / 1e3 / 2 for g, us in sorted(
                groups.items(), key=lambda kv: -kv[1])})
    del state, model, step
    torch.cuda.empty_cache()
    return out


def _sp_tokens(torch, batch, seq, steps, device="cuda"):
    """``[steps, batch, seq]`` synthetic gpt_small tokens (seed 0), the
    same on every rank."""
    from pytorch_multiprocessing_distributed_tpu_torch.data import (
        synthetic_tokens)

    t = synthetic_tokens(steps * batch * seq, vocab_size=50257, seed=0)
    return torch.from_numpy(t.astype("int64")).view(steps, batch, seq).to(
        device)


def _sp_profile_text(run):
    """A profiled run's device time by kernel group, ms a step."""
    p = run["profile"]
    groups = ", ".join(f"{g} {ms:.2f}" for g, ms in p["groups_ms"].items())
    return (f"step {p['step_ms']:.2f} ms (host clock), kernels "
            f"{p['busy_ms']:.2f} ms (NCCL overlaps the compute stream): "
            f"{groups}")


def _sp_diagnose(torch, fa, dtype):
    """Which op of a degree-1 ring differs from the plain flash path:
    the forward, or the backward, at one layer's shape."""
    from pytorch_multiprocessing_distributed_tpu_torch.parallel.ring_attention \
        import ring_attention

    q, k, v, do = _flash_inputs(torch, SP_SHAPE["batch"], SP_SHAPE["seq"],
                                SP_SHAPE["seq"], 12, 64, dtype, seed=5)
    outs = {}
    for name, fn in (("flash_attention", fa.flash_attention),
                     ("ring_attention", ring_attention)):
        qq, kk, vv = (t.detach().clone().requires_grad_() for t in (q, k, v))
        o = fn(qq, kk, vv, causal=True)
        o.backward(do)
        outs[name] = (o, qq.grad, kk.grad, vv.grad)
    return {what: float((a.float() - b.float()).abs().max())
            for what, a, b in zip(("out", "dq", "dk", "dv"),
                                  outs["flash_attention"],
                                  outs["ring_attention"])}


def _sp_one_card(torch, fa, F, rate, smi):
    """Phase 27 on one card: the degree-1 comparisons, ``--vocab_chunks``,
    the hop shape and the one-card step at gpt_lm_long's geometry.
    Returns the numbers the kernels line and the cross-card part read."""
    from pytorch_multiprocessing_distributed_tpu_torch.parallel.mesh import (
        make_grid, reset_grid)

    make_grid(1, 1, axis="seq")
    launches = {}
    try:
        tokens = _sp_tokens(torch, SP_SHAPE["batch"], SP_SHAPE["seq"], 1)
        for dtype in (torch.bfloat16, torch.float32):
            tname = str(dtype).split(".")[1]
            plain = _sp_step_run(torch, fa, dtype, None, tokens)
            want = _sp_launches_want(None, 1, 0)
            if plain["launches"] != want:
                raise AssertionError(f"plain step launched "
                                     f"{plain['launches']}, want {want}")
            for mode in SP_MODES:
                got = _sp_step_run(torch, fa, dtype, mode, tokens)
                want = _sp_launches_want(mode, 1, 0)
                if got["launches"] != want:
                    raise AssertionError(
                        f"sp {mode} {tname} launched {got['launches']} in "
                        f"one step, the schedule wants {want}")
                launches[mode] = got["launches"]
                dloss = abs(got["losses"][0] - plain["losses"][0])
                dparam = float((got["params"] - plain["params"]).abs().max())
                if mode == "zigzag":
                    tol = SP_ZIGZAG_TOL[tname]
                    if dloss > tol["loss"] or dparam > tol["param"]:
                        raise AssertionError(
                            f"zigzag {tname} at degree 1: loss err {dloss}, "
                            f"param err {dparam}, past {tol}")
                    verdict = f"within {tol}"
                else:
                    if dloss or not torch.equal(got["params"],
                                                plain["params"]):
                        raise AssertionError(
                            f"{mode} {tname} at degree 1 is not bit-equal "
                            f"to the plain step: loss err {dloss}, param "
                            f"err {dparam}; one layer's attention, ring "
                            f"against flash: {_sp_diagnose(torch, fa, dtype)}")
                    verdict = "bit-equal"
                _print(f"[sp] gpt_small {tname} B={SP_SHAPE['batch']} "
                       f"S={SP_SHAPE['seq']} 1x1 grid sp_mode={mode}: loss "
                       f"{got['losses'][0]:.6f} (plain "
                       f"{plain['losses'][0]:.6f}), loss err {dloss}, param "
                       f"err {dparam} after one step ({verdict}), launches "
                       f"{got['launches']} [{smi}]")
            del plain
        # the chunked head beside the dense one (f32, the CLI's default)
        dense = _sp_step_run(torch, fa, torch.float32, None, tokens)
        chunked = _sp_step_run(torch, fa, torch.float32, None, tokens,
                               chunks=SP_CHUNKS)
        dloss = abs(chunked["losses"][0] - dense["losses"][0])
        dparam = float((chunked["params"] - dense["params"]).abs().max())
        if dloss > SP_CHUNK_LOSS_TOL or not chunked["peak_gib"] < dense[
                "peak_gib"]:
            raise AssertionError(
                f"--vocab_chunks {SP_CHUNKS}: loss err {dloss} (tol "
                f"{SP_CHUNK_LOSS_TOL}), step peak {chunked['peak_gib']:.3f} "
                f"GiB against the dense head's {dense['peak_gib']:.3f}")
        _print(f"[sp] --vocab_chunks {SP_CHUNKS} gpt_small f32 B=8 S=1024: "
               f"loss {chunked['losses'][0]:.6f} (dense "
               f"{dense['losses'][0]:.6f}, err {dloss}, tol "
               f"{SP_CHUNK_LOSS_TOL}), param err {dparam} after one step, "
               f"step peak above the state {chunked['peak_gib']:.3f} GiB "
               f"against {dense['peak_gib']:.3f} (state "
               f"{dense['state_gib']:.3f} GiB) [{smi}]")
        del dense, chunked
    finally:
        reset_grid()
    # the hop's shape: S 1024 over four ranks, non-causal off the diagonal
    h = SP_HOP
    q, k, v, do = _flash_inputs(torch, h["batch"], h["seq"], h["seq"],
                                h["heads"], h["head_dim"], torch.bfloat16,
                                seed=27)
    kernels, plains, _, _ = _flash_calls(fa, q, k, v, do, False)
    hop_err = _flash_errors(torch, kernels, plains, FLASH_TOL["bfloat16"])
    hop, hop_dterm = _time_flash(torch, F, fa, q, k, v, do, False, rate)
    for name, t in hop.items():
        _print(f"[sp-hop] {name} bf16 non-causal B={h['batch']} "
               f"H={h['heads']} S={h['seq']} Dh={h['head_dim']}: "
               f"{t['ms']:.4f} ms (eager {t['eager_ms']:.4f}), "
               f"{t['tflop_per_s']:.1f} TFLOP/s, bound {t['bound_ms']:.4f} "
               f"ms ({t['bound_by']}), plain {t['plain_ms']:.4f} ms, "
               f"{'SDPA' if name == 'flash_fwd' else 'SDPA backward'} "
               f"{t['library_ms']:.4f} ms "
               f"({t['ms'] / t['library_ms']:.3f}x), max|err| "
               f"{hop_err[name]} [{smi}]")
    _print(f"[sp-hop] flash_dterm {hop_dterm:.4f} ms [{smi}]")
    del q, k, v, do
    # gpt_lm_long's geometry on one card: the reference of the cross-card
    # runs
    long_tokens = _sp_tokens(torch, SP_LONG["batch"], SP_LONG["seq"],
                             SP_LONG["steps"])
    one = _sp_step_run(torch, fa, torch.bfloat16, None, long_tokens,
                       steps=SP_LONG["steps"], max_seq_len=SP_LONG["seq"],
                       profile=True)
    _print(f"[sp-long] gpt_small bf16 max_seq_len {SP_LONG['seq']} "
           f"B={SP_LONG['batch']} S={SP_LONG['seq']} plain step on one "
           f"card: losses {one['losses']}, step {one['step_ms']:.2f} ms, "
           f"peak above the state {one['peak_gib']:.3f} GiB (state "
           f"{one['state_gib']:.3f}); profile {_sp_profile_text(one)} "
           f"[{smi}]")
    del one["params"]
    return dict(launches=launches, hop=hop, hop_err=hop_err,
                hop_dterm_ms=hop_dterm, long=one)


def _sp_cli_rank(rank, world, port, argv, out_path):
    """One NCCL rank of phase 27's CLI runs: ``train_lm.main(argv)``; each
    rank writes its summary to ``{out_path}.{rank}``."""
    os.environ.update(PMDT_MASTER_ADDR=f"127.0.0.1:{port}",
                      PMDT_WORLD_SIZE=str(world), PMDT_RANK=str(rank))
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from pytorch_multiprocessing_distributed_tpu_torch import train_lm

    with tempfile.TemporaryDirectory() as tmp:
        summary = train_lm.main(argv + ["--save_path", tmp])
    with open(f"{out_path}.{rank}", "w") as f:
        json.dump(summary, f)


def _sp_long_rank(rank, world, port, out_path):
    """One NCCL rank of phase 27's gpt_lm_long runs: the SP step at degree
    ``world`` in each mode; each rank writes its numbers to
    ``{out_path}.{rank}``."""
    os.environ.update(PMDT_MASTER_ADDR=f"127.0.0.1:{port}",
                      PMDT_WORLD_SIZE=str(world), PMDT_RANK=str(rank))
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch

    fa = importlib.import_module(
        "pytorch_multiprocessing_distributed_tpu_torch.ops.flash_attention")
    from pytorch_multiprocessing_distributed_tpu_torch.parallel import dist
    from pytorch_multiprocessing_distributed_tpu_torch.parallel.mesh import (
        make_grid)

    dist.init_process("cuda")
    make_grid(1, world, axis="seq")
    tokens = _sp_tokens(torch, SP_LONG["batch"], SP_LONG["seq"],
                        SP_LONG["steps"], dist.device_for_rank("cuda"))
    out = {}
    for mode in SP_MODES:
        run = _sp_step_run(torch, fa, torch.bfloat16, mode, tokens,
                           steps=SP_LONG["steps"],
                           max_seq_len=SP_LONG["seq"], profile=True)
        del run["params"]
        out[mode] = run
    with open(f"{out_path}.{rank}", "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


def _sp_cross_card(torch, one, smi):
    """Phase 27 across W = min(cards, 4) cards: the CLI in each mode
    beside ``--parallel dp``, then gpt_lm_long's geometry through the SP
    step beside the one-card plain step ``one``."""
    cards = torch.cuda.device_count()
    world = min(cards, SP_MAX_RANKS)
    if world < 2:
        _print(f"[sp] {cards} card visible: the CLI at degree W and "
               "gpt_lm_long's geometry across cards need two or more "
               "(python3 chip_smoke.py --sp-only where four are visible)")
        return None
    tokens = SP_SHAPE["batch"] * SP_SHAPE["seq"] * SP_CLI_STEPS + 1
    argv = ["--model", "gpt_small", "--dtype", "bfloat16", "--batch_size",
            str(SP_SHAPE["batch"]), "--seq_len", str(SP_SHAPE["seq"]),
            "--epochs", "1", "--lr", str(SP_LR), "--corpus_tokens",
            str(tokens), "--print_freq", "1", "--seed", "0"]
    cli = {}
    for mode in ("dp",) + SP_MODES:
        extra = (["--parallel", "dp"] if mode == "dp" else
                 ["--parallel", "sp", "--degree", str(world), "--sp_mode",
                  mode])
        t0 = time.perf_counter()
        ranks = _run_ranks(_sp_cli_rank, world, (argv + extra,),
                           per_rank=True)
        wall = time.perf_counter() - t0
        for r, summary in enumerate(ranks):
            want = {n: c * SP_CLI_STEPS for n, c in _sp_launches_want(
                mode, world, r).items()}
            if summary["launches"] != want or summary["steps"] != \
                    SP_CLI_STEPS:
                raise AssertionError(
                    f"train_lm {mode} rank {r}: {summary['steps']} steps, "
                    f"flash launches {summary['launches']}, the schedule "
                    f"wants {want} in {SP_CLI_STEPS} steps")
        first = ranks[0]["first_loss"]
        if not math.isfinite(first):
            raise AssertionError(f"train_lm {mode}: first loss {first}")
        peaks = [s["peak_memory_bytes"] / 2 ** 30 for s in ranks]
        cli[mode] = dict(first_loss=first, peaks=peaks,
                         tokens_per_sec=ranks[0]["tokens_per_sec"],
                         launches=[s["launches"] for s in ranks])
        _print(f"[sp-cli] train_lm gpt_small bf16 B=8 S=1024 "
               f"{' '.join(extra)} on {world} ranks ({ranks[0]['grid']} "
               f"grid): first loss {first:.6f}, epoch loss "
               f"{ranks[0]['epoch_losses'][0]:.6f}, tokens/s "
               f"{ranks[0]['tokens_per_sec']:.1f}, steady step "
               f"{(ranks[0]['steady_step_s'] or 0) * 1e3:.2f} ms, peak a "
               f"card {[round(p, 3) for p in peaks]} GiB, launches a rank "
               f"{[s['launches']['flash_fwd'] for s in ranks]} (fwd) in "
               f"{SP_CLI_STEPS} steps, wall {wall:.1f} s [{smi}]")
    for mode in SP_MODES:
        if abs(cli[mode]["first_loss"] - cli["dp"]["first_loss"]) > \
                SP_LONG_LOSS_TOL:
            raise AssertionError(
                f"train_lm sp {mode}: first loss {cli[mode]['first_loss']} "
                f"against dp {cli['dp']['first_loss']} (tol "
                f"{SP_LONG_LOSS_TOL})")
    ranks = _run_ranks(_sp_long_rank, world, (), per_rank=True)
    long = {}
    for mode in SP_MODES:
        for r, got in enumerate(ranks):
            want = _sp_launches_want(mode, world, r)
            if got[mode]["launches"] != want:
                raise AssertionError(
                    f"gpt_lm_long {mode} rank {r}: one step launched "
                    f"{got[mode]['launches']}, the schedule wants {want}")
        run = ranks[0][mode]
        errs = [abs(a - b) for a, b in zip(run["losses"], one["losses"])]
        if errs[0] > SP_LONG_LOSS_TOL or errs[1] > SP_LONG_LOSS_TOL:
            raise AssertionError(
                f"gpt_lm_long {mode} at degree {world}: losses "
                f"{run['losses']} against one card's {one['losses']} (tol "
                f"{SP_LONG_LOSS_TOL})")
        peaks = [g[mode]["peak_gib"] for g in ranks]
        long[mode] = dict(losses=run["losses"], step_ms=run["step_ms"],
                          peaks=peaks)
        _print(f"[sp-long] gpt_small bf16 B={SP_LONG['batch']} "
               f"S={SP_LONG['seq']} sp_mode={mode} degree {world}: losses "
               f"{run['losses']} (one card {one['losses']}, errs {errs}, "
               f"tol {SP_LONG_LOSS_TOL}), step {run['step_ms']:.2f} ms (one "
               f"card {one['step_ms']:.2f}), peak above the state a card "
               f"{[round(p, 3) for p in peaks]} GiB (one card "
               f"{one['peak_gib']:.3f}); rank 0's profile "
               f"{_sp_profile_text(run)} [{smi}]")
    return dict(world=world, cli=cli, long=long)


def _sp_phase(torch, fa, F, rate, smi):
    """Phase 27 (see the module docstring)."""
    one = _sp_one_card(torch, fa, F, rate, smi)
    one["cross"] = _sp_cross_card(torch, one["long"], smi)
    return one


# ---- phase 28: train_lm's model-parallel modes -------------------------


def _mp_launches_want(run, layers=12):
    """Each flash kernel's launches a train step on any rank of ``run``:
    one a layer for the forward and each backward kernel (a pipeline
    stage runs L/N layers on each of its N microbatches); 1F1B and
    ``remat`` run the forward a second time, rematerialized."""
    twice = run.get("schedule") == "1f1b" or run.get("remat")
    return {"flash_fwd": 2 * layers if twice else layers,
            "flash_bwd_dq": layers, "flash_bwd_dkv": layers}


def _mp_name(run):
    flags = [k for k in ("zero1", "fsdp", "zero", "remat") if run.get(k)]
    return "_".join([run["kind"]] + [run[k] for k in ("schedule", "sp_mode")
                                     if k in run] + flags)


def _mp_state(torch, model, params, run, grid, opt):
    """``run``'s state and train step on the grid already made (``sp``:
    the model built with ``seq_axis="seq"``)."""
    from pytorch_multiprocessing_distributed_tpu_torch.parallel import (
        gpt_pipeline as gp)
    from pytorch_multiprocessing_distributed_tpu_torch.parallel.zero import (
        plan_buckets, zeroify_state)
    from pytorch_multiprocessing_distributed_tpu_torch.train import (
        create_lm_train_state, make_lm_train_step, make_lm_train_step_tp)
    from pytorch_multiprocessing_distributed_tpu_torch.train.placement import (
        plan_placement, shard_state)

    if run["kind"] == "pp":
        state = gp.create_pipelined_lm_state(model, params, grid.model)
        step = gp.make_pipelined_lm_train_step(model, opt,
                                               schedule=run["schedule"])
        return state, step, state.resident_bytes()
    if run["kind"] == "tp":
        placement = plan_placement(model, grid.data, grid.model,
                                   zero1=run.get("zero1", False),
                                   fsdp=run.get("fsdp", False))
        state = shard_state(create_lm_train_state(model, params), placement,
                            grid)
        nbytes = placement.resident_bytes()
        del nbytes["batch_stats"]
        return state, make_lm_train_step_tp(model, opt), nbytes
    plan = plan_buckets(model, grid.size) if run.get("zero") else None
    state = create_lm_train_state(model, params, plan=plan)
    if plan is not None:
        zeroify_state(state, plan, grid.rank)
    step = make_lm_train_step(model, opt, remat=run.get("remat", False),
                              seq_axis="seq" if run["kind"] == "sp"
                              else None)
    return state, step, {"params": 4 * state.n,
                         "opt_state": 4 * state.momentum.numel()}


def _mp_whole(state, run, vocab):
    """The run's whole params on the host, under the GPT's names (a
    collective)."""
    from pytorch_multiprocessing_distributed_tpu_torch.parallel import (
        gpt_pipeline as gp)

    if run["kind"] == "pp":
        whole = gp.unstack_pipeline_params(state.stacked(state.params), vocab)
    elif run["kind"] == "tp":
        full = state.gathered()
        whole = full.views(full.params)
    else:
        whole = state.views(state.params)
    return {k: v.detach().cpu() for k, v in whole.items()}


def _mp_run(torch, fa, dtype, run, params, tokens, grid, profile=False):
    """``run`` (``kind`` dp|sp|pp|tp with its flags; ``moe``, the MoE
    keywords of the model) on gpt_small from ``params`` over ``tokens``
    ``[steps, B, S]`` (this rank takes its data index's rows) on the grid
    already made: the losses (and an MoE model's balance losses), the
    whole params after the last step, the first step's flash launches
    and peak memory above the state, the later steps' period (host clock
    between synchronizes), the resident bytes; with ``profile``, where
    two more steps' device time goes (``profile_train_lm``'s groups, ms
    a step, and an MoE model's MoE layers; every rank of the grid must
    profile)."""
    from pytorch_multiprocessing_distributed_tpu_torch.models import (
        get_model)
    from pytorch_multiprocessing_distributed_tpu_torch.train import sgd

    kw = dict(run.get("moe", {}))
    if run["kind"] == "sp":
        kw.update(seq_axis="seq", sp_mode=run["sp_mode"])
    model = get_model("gpt_small", dtype=dtype, **kw)
    state, step, resident = _mp_state(
        torch, model, {k: v.clone() for k, v in params.items()}, run, grid,
        sgd(SP_LR))
    b = tokens.shape[1] // grid.data
    rows = tokens[:, grid.data_index * b:(grid.data_index + 1) * b]
    for n in FLASH_PRODUCTS:
        getattr(fa, n).launches = 0
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    first = step(state, rows[0])[1]
    losses = [float(first["loss"])]
    peak = torch.cuda.max_memory_allocated() - base
    launches = {n: getattr(fa, n).launches for n in FLASH_PRODUCTS}
    # the later steps' period: host clock between two synchronizes, the
    # ranks of a grid lined up first (a stage that finished its first
    # step early would otherwise time its wait for the others)
    if grid.size > 1:
        import torch.distributed as tdist

        tdist.barrier()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics = [step(state, tok)[1] for tok in rows[1:]]
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / max(1, len(metrics))
    losses += [float(m["loss"]) for m in metrics]
    out = dict(losses=losses, params=_mp_whole(state, run, model.vocab_size),
               launches=launches, peak_gib=peak / 2 ** 30,
               state_gib=base / 2 ** 30, resident=resident, step_ms=step_ms)
    if "moe_aux" in first:
        out["aux"] = [float(m["moe_aux"]) for m in [first] + metrics]
    if profile:
        from pytorch_multiprocessing_distributed_tpu_torch.profile_train_lm \
            import moe_layer_ms, profile_steps

        step_s, kernels, groups = profile_steps(
            lambda i: step(state, rows[-1]), 2)
        out["profile"] = dict(
            step_ms=step_s * 1e3,
            busy_ms=sum(kernels.values()) / 1e3 / 2,
            groups_ms={g: us / 1e3 / 2 for g, us in sorted(
                groups.items(), key=lambda kv: -kv[1])})
        if run.get("moe"):
            out["profile"]["moe_ms"] = moe_layer_ms(
                state.model, lambda i: step(state, rows[-1]), 2)
    del state, step, model
    gc.collect()  # a placed model and its state refer to each other
    torch.cuda.empty_cache()
    return out


def _mp_err(a, b):
    """The largest difference of two runs' whole params."""
    return max(float((a[k] - b[k]).abs().max()) for k in a)


def _mp_check_resident(run, got, data, deg):
    mode = next((k for k in ("zero1", "fsdp") if run.get(k)), "plain")
    want = MP_JAX_RESIDENT[(run["kind"], mode, data, deg)]
    if (got["params"], got["opt_state"]) != want:
        raise AssertionError(
            f"{_mp_name(run)} on ({data}, {deg}): resident bytes {got}, "
            f"JAX's placement puts {want} on a device")
    return want


def _mp_one_card(torch, fa, smi):
    """Phase 28 on one card: every mode at degree 1 against the plain DP
    step from the same params, bf16 and f32. Returns the plain runs (the
    cross-card reference) and each run's launches."""
    from pytorch_multiprocessing_distributed_tpu_torch.models import (
        get_model)
    from pytorch_multiprocessing_distributed_tpu_torch.parallel.mesh import (
        make_grid, reset_grid)
    from pytorch_multiprocessing_distributed_tpu_torch.serving import (
        init_params)

    dev = torch.device("cuda", torch.cuda.current_device())
    tokens = _sp_tokens(torch, MP_SHAPE["batch"], MP_SHAPE["seq"], MP_STEPS)
    plains, launches = {}, {}
    for dtype in (torch.bfloat16, torch.float32):
        tname = str(dtype).split(".")[1]
        params = init_params(get_model("gpt_small"), 0, dev)
        plain = None
        for run in MP_ONE_CARD:
            grid = make_grid(1, 1, axis=MP_AXES[run["kind"]])
            try:
                got = _mp_run(torch, fa, dtype, run, params, tokens, grid)
            finally:
                reset_grid()
            name = _mp_name(run)
            want = _mp_launches_want(run)
            if got["launches"] != want:
                raise AssertionError(
                    f"{name} {tname} at degree 1 launched {got['launches']} "
                    f"in one step, the schedule wants {want}")
            launches[name] = got["launches"]
            jax_bytes = _mp_check_resident(run, got["resident"], 1, 1)
            if plain is None:
                plain = got
                verdict = "the reference"
                dloss = dparam = 0.0
            else:
                dloss = max(abs(a - b) for a, b in zip(got["losses"],
                                                       plain["losses"]))
                dparam = _mp_err(got["params"], plain["params"])
                if run["kind"] == "pp":
                    tol = MP_PP_TOL[tname]
                    if dloss > tol["loss"] or dparam > tol["param"]:
                        raise AssertionError(
                            f"{name} {tname} at degree 1: loss err {dloss}, "
                            f"param err {dparam} after {MP_STEPS} steps, "
                            f"past {tol}")
                    verdict = f"within {tol}"
                else:
                    if dloss or dparam:
                        raise AssertionError(
                            f"{name} {tname} at degree 1 is not bit-equal "
                            f"to the plain step: loss err {dloss}, param "
                            f"err {dparam}")
                    verdict = "bit-equal"
            _print(f"[mp] gpt_small {tname} B={MP_SHAPE['batch']} "
                   f"S={MP_SHAPE['seq']} {name} on a 1x1 grid: losses "
                   f"{got['losses']} ({verdict}: loss err {dloss}, param "
                   f"err {dparam} after {MP_STEPS} steps), launches a step "
                   f"{got['launches']}, resident {got['resident']} B "
                   f"(JAX {jax_bytes}), peak above the state "
                   f"{got['peak_gib']:.3f} GiB (state "
                   f"{got['state_gib']:.3f}), step {got['step_ms']:.2f} ms "
                   f"[{smi}]")
            if got is not plain:
                del got
        plains[tname] = plain
        del params
        torch.cuda.empty_cache()
    return plains, launches


def _mp_rank(rank, world, port, runs, ref_path, out_path):
    """One NCCL rank of phase 28's cross-card runs: each run of ``runs``
    (``(dtype name, run, degree)``) on its grid from seed 0's params;
    rank 0 holds the whole params against the one-card plain run's
    (``ref_path``). Each rank writes its numbers to ``{out_path}.{rank}``."""
    os.environ.update(PMDT_MASTER_ADDR=f"127.0.0.1:{port}",
                      PMDT_WORLD_SIZE=str(world), PMDT_RANK=str(rank))
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch

    fa = importlib.import_module(
        "pytorch_multiprocessing_distributed_tpu_torch.ops.flash_attention")
    from pytorch_multiprocessing_distributed_tpu_torch.models import (
        get_model)
    from pytorch_multiprocessing_distributed_tpu_torch.parallel import dist
    from pytorch_multiprocessing_distributed_tpu_torch.parallel.mesh import (
        make_grid, reset_grid)
    from pytorch_multiprocessing_distributed_tpu_torch.serving import (
        init_params)

    dist.init_process("cuda")
    dev = dist.device_for_rank("cuda")
    tokens = _sp_tokens(torch, MP_SHAPE["batch"], MP_SHAPE["seq"], MP_STEPS,
                        dev)
    ref = torch.load(ref_path, weights_only=True) if rank == 0 else None
    params = {}  # seed 0's, by the model's MoE keywords
    out = []
    for tname, run, deg in runs:
        dtype = getattr(torch, tname)
        key = json.dumps(run.get("moe", {}), sort_keys=True)
        if key not in params:
            params.clear()
            params[key] = init_params(get_model(
                "gpt_small", **run.get("moe", {})), 0, dev)
        grid = make_grid(world // deg, deg, axis=MP_AXES[run["kind"]])
        t0 = time.perf_counter()
        got = _mp_run(torch, fa, dtype, run, params[key], tokens, grid,
                      profile=(tname == "bfloat16" and deg == world
                               and not run.get("moe")))
        reset_grid()
        whole = got.pop("params")
        if rank == 0:
            got["param_err"] = _mp_err(whole, ref[tname])
        got["wall_s"] = time.perf_counter() - t0
        out.append(got)
        del whole
    with open(f"{out_path}.{rank}", "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


def _mp_cross_card(torch, plains, smi):
    """Phase 28 across W cards (4 where four are visible, else 2): pp at
    degree 2 and W (gpipe and 1f1b) and tp at degree 2 and W (plain,
    ``--zero1``, ``--fsdp``), bf16 and f32, against the one-card plain
    step."""
    cards = torch.cuda.device_count()
    world = 4 if cards >= 4 else 2 if cards >= 2 else 1
    if world < 2:
        _print(f"[mp] {cards} card visible: pp and tp at degree 2 and 4 "
               "need two or more (python3 chip_smoke.py --mp-only where "
               "four are visible)")
        return None
    degrees = sorted({2, world})
    runs = [(tname, run, deg) for tname in ("bfloat16", "float32")
            for deg in degrees for run in MP_CROSS]
    with tempfile.TemporaryDirectory() as tmp:
        ref_path = os.path.join(tmp, "plain.pt")
        torch.save({t: p["params"] for t, p in plains.items()}, ref_path)
        t0 = time.perf_counter()
        ranks = _run_ranks(_mp_rank, world, (runs, ref_path),
                           timeout_s=900, per_rank=True)
        wall = time.perf_counter() - t0
    out = {}
    for i, (tname, run, deg) in enumerate(runs):
        name = _mp_name(run)
        plain = plains[tname]
        want = _mp_launches_want(run)
        for r, got in enumerate(ranks):
            if got[i]["launches"] != want:
                raise AssertionError(
                    f"{name} {tname} degree {deg} rank {r}: one step "
                    f"launched {got[i]['launches']}, the schedule wants "
                    f"{want}")
            _mp_check_resident(run, got[i]["resident"], world // deg, deg)
        got = ranks[0][i]
        dloss = max(abs(a - b) for a, b in zip(got["losses"],
                                               plain["losses"]))
        tol = MP_XCARD_TOL[tname]
        if dloss > tol["loss"] or got["param_err"] > tol["param"]:
            raise AssertionError(
                f"{name} {tname} at degree {deg} on {world} cards: loss err "
                f"{dloss}, param err {got['param_err']} after {MP_STEPS} "
                f"steps against one card's plain step, past {tol}")
        peaks = [round(g[i]["peak_gib"], 3) for g in ranks]
        steps = [round(g[i]["step_ms"], 2) for g in ranks]
        out[f"{name}_{tname}_{world // deg}x{deg}"] = dict(
            losses=got["losses"], loss_err=dloss,
            param_err=got["param_err"], step_ms=steps, peak_gib=peaks,
            resident=got["resident"], launches=got["launches"])
        profiles = "".join(
            f"; rank {r}'s profile {_sp_profile_text(g[i])}"
            for r, g in enumerate(ranks) if "profile" in g[i])
        _print(f"[mp-xcard] gpt_small {tname} B={MP_SHAPE['batch']} "
               f"S={MP_SHAPE['seq']} {name} degree {deg} on a "
               f"({world // deg}, {deg}) grid: losses {got['losses']} (one "
               f"card {plain['losses']}), loss err {dloss}, param err "
               f"{got['param_err']} after {MP_STEPS} steps (tol {tol}); "
               f"step a rank {steps} ms (one card {plain['step_ms']:.2f}), "
               f"peak above the state a rank {peaks} GiB (one card "
               f"{plain['peak_gib']:.3f}), resident a rank "
               f"{got['resident']} B, launches a step {got['launches']}"
               f"{profiles} [{smi}]")
    _print(f"[mp-xcard] {len(runs)} runs on {world} ranks: wall "
           f"{wall:.1f} s [{smi}]")
    return dict(world=world, runs=out)


def _mp_cli(train_lm, torch, smi):
    """``train_lm --parallel pp|tp --degree W`` through the CLI over the
    W visible cards (one card: degree 1 in this process): an epoch with
    a checkpoint, then ``--resume auto`` to a second one with
    ``--val_frac`` and ``--sample``; the launches, the resume and the
    sample asserted."""
    cards = torch.cuda.device_count()
    world = 4 if cards >= 4 else 2 if cards >= 2 else 1
    base = ["--model", "gpt_small", "--dtype", "bfloat16", "--batch_size",
            str(MP_SHAPE["batch"]), "--seq_len", str(MP_CLI_SEQ),
            "--lr", str(SP_LR), "--corpus_tokens", str(MP_CLI_TOKENS),
            "--val_frac", str(MP_CLI_VAL), "--print_freq", "1", "--seed",
            "0", "--degree", str(world)]
    out = {}
    for extra in MP_CLI_MODES:
        name = "_".join(a.lstrip("-") for a in extra[1:])
        with tempfile.TemporaryDirectory() as tmp:
            runs = []
            for epochs, more in (("1", []), ("2", [
                    "--resume", "auto", "--sample", str(MP_CLI_SAMPLE)])):
                argv = base + extra + ["--epochs", epochs] + more
                t0 = time.perf_counter()
                if world == 1:
                    ranks = [train_lm.main(argv + ["--save_path", tmp])]
                else:
                    ranks = _run_ranks(_mp_cli_rank, world, (argv, tmp),
                                       per_rank=True)
                runs.append((ranks, time.perf_counter() - t0))
        run = {"schedule": "1f1b"} if "1f1b" in extra else {}
        per_step = _mp_launches_want(run)
        for ranks, _ in runs:
            for r, summary in enumerate(ranks):
                steps, evals = summary["steps"], MP_CLI_EVALS
                want = {n: c * steps for n, c in per_step.items()}
                want["flash_fwd"] += 12 * evals
                if summary["launches"] != want or steps != MP_CLI_STEPS:
                    raise AssertionError(
                        f"train_lm {' '.join(extra)} rank {r}: {steps} "
                        f"steps, launches {summary['launches']}, want "
                        f"{want} ({MP_CLI_STEPS} steps, {evals} eval "
                        "batches)")
        second = runs[1][0][0]
        if (len(second["epoch_losses"]) != 1
                or len(second["sample"]) != MP_CLI_SAMPLE
                or not all(math.isfinite(v) for v in
                           second["epoch_losses"] + second["val_losses"])):
            raise AssertionError(
                f"train_lm {' '.join(extra)} --resume auto: epoch losses "
                f"{second['epoch_losses']}, val {second['val_losses']}, "
                f"sample {second.get('sample')} (want one resumed epoch, "
                f"finite losses and {MP_CLI_SAMPLE} tokens)")
        out[name] = dict(first=runs[0][0][0]["epoch_losses"][0],
                         resumed=second["epoch_losses"][0],
                         val=second["val_losses"][0], sample=second["sample"],
                         peaks=[s.get("peak_memory_bytes", 0) / 2 ** 30
                                for s in runs[1][0]],
                         resident=[s["resident_bytes"] for s in runs[1][0]],
                         tokens_per_sec=second["tokens_per_sec"])
        _print(f"[mp-cli] train_lm gpt_small bf16 B={MP_SHAPE['batch']} "
               f"S={MP_CLI_SEQ} {' '.join(extra)} "
               f"--degree {world} on {world} rank(s): epoch 1 loss "
               f"{out[name]['first']:.6f} (wall {runs[0][1]:.1f} s), "
               f"resumed epoch 2 loss {out[name]['resumed']:.6f}, val "
               f"{out[name]['val']:.6f}, sample {second['sample']}, "
               f"tokens/s {second['tokens_per_sec']:.1f}, peak a card "
               f"{[round(p, 3) for p in out[name]['peaks']]} GiB, resident "
               f"a rank {out[name]['resident']} B (wall {runs[1][1]:.1f} s) "
               f"[{smi}]")
    return out


def _mp_cli_rank(rank, world, port, argv, save_path, out_path):
    """One NCCL rank of phase 28's CLI runs: ``train_lm.main(argv)`` into
    the shared ``save_path``; each rank writes its summary to
    ``{out_path}.{rank}``."""
    os.environ.update(PMDT_MASTER_ADDR=f"127.0.0.1:{port}",
                      PMDT_WORLD_SIZE=str(world), PMDT_RANK=str(rank))
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from pytorch_multiprocessing_distributed_tpu_torch import train_lm

    summary = train_lm.main(argv + ["--save_path", save_path])
    with open(f"{out_path}.{rank}", "w") as f:
        json.dump(summary, f)


def _mp_phase(torch, fa, train_lm, smi):
    """Phase 28 (see the module docstring)."""
    t0 = time.perf_counter()
    plains, launches = _mp_one_card(torch, fa, smi)
    cross = _mp_cross_card(torch, plains, smi)
    cli = _mp_cli(train_lm, torch, smi)
    _print(f"[mp] phase 28 wall {time.perf_counter() - t0:.1f} s [{smi}]")
    return dict(launches=launches, cross=cross, cli=cli)


# ------------------------------------------------------------- phase 29


def _moe_layer_params(torch, seed=0):
    """A full-width MoE layer's params on the host (``MOE_LAYER``'s
    widths): flax's ``lecun_normal`` kernels as ``init_params`` draws
    them, and small random expert biases (so that the biases count)."""
    from pytorch_multiprocessing_distributed_tpu_torch.serving.params import (
        _lecun_normal)

    d, h, e = MOE_LAYER["dim"], MOE_LAYER["hidden"], MOE_LAYER["experts"]
    gen = torch.Generator().manual_seed(seed)
    return {"gate": _lecun_normal((d, e), gen),
            "w1": _lecun_normal((e, d, h), gen),
            "b1": 0.02 * torch.randn((e, h), generator=gen),
            "w2": _lecun_normal((e, h, d), gen),
            "b2": 0.02 * torch.randn((e, d), generator=gen)}


def _moe_layer_check(torch, smi):
    """Phase 29's layer: the full-width MoE layer (B 8, S 1024, D 768,
    H 3072, E 8) on the card against the same module on the CPU, top-1
    and top-2, f32 (TF32 off) and bf16: the share of (token, choice)
    routes that agree, the largest error of ``y`` over the tokens whose
    routes and kept slots agree (within ``MOE_LAYER_TOL``), aux and z;
    and the layer's forward and forward + backward device times."""
    from pytorch_multiprocessing_distributed_tpu_torch.ops.moe import (
        MoEMlp, dispatch_masks, route)

    b, s, d = MOE_LAYER["batch"], MOE_LAYER["seq"], MOE_LAYER["dim"]
    params = _moe_layer_params(torch)
    dev = torch.device("cuda", torch.cuda.current_device())
    x = torch.randn((b, s, d), generator=torch.Generator().manual_seed(1))
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 is f32
    out = {}
    for k in (1, 2):
        for dtype in (torch.float32, torch.bfloat16):
            tname = str(dtype).split(".")[1]
            host, card = (MoEMlp(d, MOE_LAYER["experts"],
                                 MOE_LAYER["hidden"], 1.0, k)
                          for _ in range(2))
            host.load_state_dict(params, assign=True)
            card.load_state_dict({n: t.to(dev) for n, t in params.items()},
                                 assign=True)
            t0 = time.perf_counter()
            with torch.no_grad():
                y_ref, aux_ref, z_ref = host(x, dtype)
            cpu_s = time.perf_counter() - t0
            xc = x.to(dev)
            with torch.no_grad():
                y, aux, z = card(xc, dtype)
            cap = card.capacity(s)
            routes, kept = [], []
            for m, xx in ((host, x), (card, xc)):
                _, _, _, topi = route(m.gate, xx, k)
                _, _, keep = dispatch_masks(
                    torch.nn.functional.one_hot(topi, MOE_LAYER["experts"])
                    .float(), cap)
                routes.append(topi.cpu())
                kept.append(keep.cpu())
            same = routes[0] == routes[1]
            agree = (same & (kept[0] == kept[1])).all(-1)      # [B, S]
            err = float((y.float().cpu() - y_ref.float())[agree].abs().max())
            share = float(same.float().mean())
            tol = MOE_LAYER_TOL[tname]
            if share < MOE_ROUTE_SHARE or err > tol:
                raise AssertionError(
                    f"MoE layer top-{k} {tname} on the card: {share:.6f} of "
                    f"the routes agree with the CPU's (want >= "
                    f"{MOE_ROUTE_SHARE}), largest y error {err} on the "
                    f"tokens whose routes agree (tol {tol})")

            def fwd():
                return card(xc, dtype)

            for p in card.parameters():
                p.requires_grad_(True)
            xg = xc.clone().requires_grad_(True)
            dy = torch.randn_like(y.float())

            def fwd_bwd():
                yy, a, zz = card(xg, dtype)
                torch.autograd.backward([yy, a, zz],
                                        [dy, torch.ones_like(a),
                                         torch.ones_like(zz)])

            with torch.no_grad():
                fwd_ms = _eager_ms(fwd, torch, reps=10, warmup=2)
            train_ms = _eager_ms(fwd_bwd, torch, reps=10, warmup=2)
            out[f"top{k}_{tname}"] = dict(share=share, err=err,
                                          fwd_ms=fwd_ms, train_ms=train_ms)
            _print(f"[moe-layer] MoE layer B={b} S={s} D={d} H="
                   f"{MOE_LAYER['hidden']} E={MOE_LAYER['experts']} top-{k} "
                   f"{tname} (capacity {cap}): card vs CPU, {share:.6f} of "
                   f"the (token, choice) routes agree, {int(agree.sum())} of "
                   f"{b * s} tokens with every route and kept slot equal, "
                   f"largest y error on them {err:.3e} (tol {tol}); aux "
                   f"{float(aux):.6f} (CPU {float(aux_ref):.6f}), z "
                   f"{float(z):.6f} (CPU {float(z_ref):.6f}); CPU forward "
                   f"{cpu_s:.1f} s; card forward {fwd_ms:.3f} ms, forward + "
                   f"backward {train_ms:.3f} ms (eager, median of 10) [{smi}]")
            del host, card, y_ref, y, xg
            torch.cuda.empty_cache()
    return out


def _moe_check_resident(run, got, moe_total):
    """A degree-1 run's resident bytes: the whole MoE state, which JAX's
    placement on one device is (``MOE_JAX_RESIDENT``), the ``--zero``
    moments a padded bucket layout of it."""
    if run.get("zero"):
        ok = (got["params"] == moe_total
              and moe_total <= got["opt_state"] < moe_total + 4 * 2 ** 20)
    else:
        want = MOE_JAX_RESIDENT[("plain", 1, 1)]
        ok = (got["params"], got["opt_state"]) == want
    if not ok:
        raise AssertionError(f"MoE {_mp_name(run)} at degree 1: resident "
                             f"bytes {got}, the whole state is {moe_total}")


def _moe_one_card(torch, fa, smi):
    """Phase 29 at degree 1 on one card, bf16 and f32, top-1: the plain
    MoE step, then sp (ring, ulysses), tp, ``--remat`` and ``--zero``
    (each bit-equal to it) and pp (gpipe, 1f1b; within ``MP_PP_TOL``);
    each run's flash launches a step as scheduled; the plain bf16 step
    profiled (kernel groups and the MoE layers' share); the dense plain
    bf16 step beside it. Returns the plain MoE runs (the cross-card
    reference), each run's launches and the numbers the kernels line and
    ``PERF.md`` take."""
    from pytorch_multiprocessing_distributed_tpu_torch.models import (
        get_model)
    from pytorch_multiprocessing_distributed_tpu_torch.parallel.mesh import (
        make_grid, reset_grid)
    from pytorch_multiprocessing_distributed_tpu_torch.serving import (
        init_params)

    dev = torch.device("cuda", torch.cuda.current_device())
    tokens = _sp_tokens(torch, MP_SHAPE["batch"], MP_SHAPE["seq"], MOE_STEPS)
    plains, launches, out = {}, {}, {}
    moe = dict(n_experts=MOE_LAYER["experts"])
    grid = make_grid(1, 1)
    try:
        dense = _mp_run(torch, fa, torch.bfloat16, {"kind": "dp"},
                        init_params(get_model("gpt_small"), 0, dev), tokens,
                        grid)
    finally:
        reset_grid()
    out["dense_step_ms"] = dense["step_ms"]
    del dense
    params = init_params(get_model("gpt_small", **moe), 0, dev)
    moe_total = 4 * sum(t.numel() for t in params.values())
    for dtype in (torch.bfloat16, torch.float32):
        tname = str(dtype).split(".")[1]
        plain = None
        for run in MOE_ONE_CARD:
            run = dict(run, moe=moe)
            grid = make_grid(1, 1, axis=MP_AXES[run["kind"]])
            try:
                got = _mp_run(torch, fa, dtype, run, params, tokens, grid,
                              profile=plain is None and tname == "bfloat16")
            finally:
                reset_grid()
            name = _mp_name(run)
            want = _mp_launches_want(run)
            if got["launches"] != want:
                raise AssertionError(
                    f"MoE {name} {tname} at degree 1 launched "
                    f"{got['launches']} in one step, the schedule wants "
                    f"{want}")
            launches[name] = got["launches"]
            _moe_check_resident(run, got["resident"], moe_total)
            if plain is None:
                plain, verdict, dloss, dparam = got, "the reference", 0.0, 0.0
            else:
                dloss = max(abs(a - b) for a, b in zip(got["losses"],
                                                       plain["losses"]))
                dparam = _mp_err(got["params"], plain["params"])
                if run["kind"] == "pp":
                    tol = MP_PP_TOL[tname]
                    if dloss > tol["loss"] or dparam > tol["param"]:
                        raise AssertionError(
                            f"MoE {name} {tname} at degree 1: loss err "
                            f"{dloss}, param err {dparam} after {MOE_STEPS} "
                            f"steps, past {tol}")
                    verdict = f"within {tol}"
                elif dloss or dparam or got["aux"] != plain["aux"]:
                    raise AssertionError(
                        f"MoE {name} {tname} at degree 1 is not bit-equal "
                        f"to the plain MoE step: loss err {dloss}, param err "
                        f"{dparam}, aux {got['aux']} vs {plain['aux']}")
                else:
                    verdict = "bit-equal"
            if not all(math.isfinite(v) for v in got["losses"] + got["aux"]):
                raise AssertionError(f"MoE {name} {tname}: losses "
                                     f"{got['losses']}, aux {got['aux']}")
            _print(f"[moe] gpt_small E={moe['n_experts']} top-1 {tname} "
                   f"B={MP_SHAPE['batch']} S={MP_SHAPE['seq']} {name} on a "
                   f"1x1 grid: losses {got['losses']}, aux {got['aux']} "
                   f"({verdict}: loss err {dloss}, param err {dparam} after "
                   f"{MOE_STEPS} steps), launches a step {got['launches']}, "
                   f"resident {got['resident']} B, peak above the state "
                   f"{got['peak_gib']:.3f} GiB (state "
                   f"{got['state_gib']:.3f}), step {got['step_ms']:.2f} ms "
                   f"[{smi}]")
            if "profile" in got:
                prof = got["profile"]
                out["moe_step_ms"] = got["step_ms"]
                out["moe_peak_gib"] = got["peak_gib"]
                out["moe_state_gib"] = got["state_gib"]
                out["moe_ms"] = prof["moe_ms"]
                out["moe_share"] = prof["moe_ms"] / prof["step_ms"]
                _print(f"[moe-profile] gpt_small E={moe['n_experts']} top-1 "
                       f"bf16 B={MP_SHAPE['batch']} S={MP_SHAPE['seq']} "
                       f"plain step {got['step_ms']:.2f} ms (dense gpt_small "
                       f"bf16 plain step in this run {out['dense_step_ms']:.2f}"
                       f" ms): {_sp_profile_text(got)}; MoE layers (router, "
                       f"dispatch, experts, combine; forward and backward, "
                       f"CUDA events) {prof['moe_ms']:.2f} ms a step, "
                       f"{out['moe_share']:.3f} of the profiled step [{smi}]")
            if got is not plain:
                del got
        plains[tname] = plain
        torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()
    out["launches"] = launches
    return plains, out


def _moe_cli(train_lm, torch, smi, da):
    """``train_lm --n_experts 8 [--moe_top_k 2]`` through the CLI on one
    card (gpt_small bf16, B 8 x S 1024, lr 0.01): an epoch of
    ``MOE_CLI_STEPS`` steps and ``MOE_CLI_EVALS`` eval batch with a
    checkpoint, then ``--resume auto`` into a second at S 1016 with
    ``--sample 8`` through the dropless decode (row 1: 12 launches a
    decode step). The launches, the Aux column, the resume and the
    sample asserted; the step, peak memory and Aux printed."""
    base = ["--model", "gpt_small", "--dtype", "bfloat16", "--batch_size",
            str(MP_SHAPE["batch"]), "--lr", str(SP_LR), "--corpus_tokens",
            str(MOE_CLI_TOKENS), "--val_frac", str(MOE_CLI_VAL),
            "--print_freq", "1", "--seed", "0", "--n_experts",
            str(MOE_LAYER["experts"])]
    out = {}
    for k in (1, 2):
        extra = ["--moe_top_k", str(k)] if k > 1 else []
        with tempfile.TemporaryDirectory() as tmp:
            first = train_lm.main(base + extra + [
                "--seq_len", str(MP_SHAPE["seq"]), "--epochs", "1",
                "--save_path", tmp])
            decode0 = da.decode_attention.launches
            second = train_lm.main(base + extra + [
                "--seq_len", str(MP_CLI_SEQ), "--epochs", "2", "--resume",
                "auto", "--sample", str(MP_CLI_SAMPLE), "--save_path", tmp])
            decodes = da.decode_attention.launches - decode0
        want = {n: c * MOE_CLI_STEPS for n, c in _mp_launches_want({}).items()}
        want["flash_fwd"] += 12 * MOE_CLI_EVALS
        decode_want = 12 * (MP_CLI_SAMPLE - 1)
        for summary in (first, second):
            if (summary["launches"] != want
                    or summary["steps"] != MOE_CLI_STEPS
                    or len(summary["moe_aux"]) != MOE_CLI_STEPS):
                raise AssertionError(
                    f"train_lm --n_experts 8 top-{k}: {summary['steps']} "
                    f"steps, launches {summary['launches']}, Aux "
                    f"{summary['moe_aux']}, want {want} ({MOE_CLI_STEPS} "
                    f"steps, {MOE_CLI_EVALS} eval batch)")
        values = (first["epoch_losses"] + first["val_losses"]
                  + second["epoch_losses"] + second["val_losses"]
                  + first["moe_aux"] + second["moe_aux"])
        if (decodes != decode_want or len(second["sample"]) != MP_CLI_SAMPLE
                or not all(math.isfinite(v) for v in values)
                or not first["epoch_losses"][0] < first["first_loss"]):
            raise AssertionError(
                f"train_lm --n_experts 8 top-{k}: losses {first} / "
                f"{second}; decode launches {decodes} (want {decode_want})")
        step_ms = first["steady_step_s"] * 1e3
        peak = first["peak_memory_bytes"] / 2 ** 30
        out[f"top{k}"] = dict(step_ms=step_ms, peak_gib=peak,
                              aux=first["moe_aux"], sample=second["sample"],
                              decode_launches=decodes)
        _print(f"[moe-cli] train_lm gpt_small bf16 B={MP_SHAPE['batch']} "
               f"S={MP_SHAPE['seq']} --n_experts {MOE_LAYER['experts']} "
               f"top-{k}: {first['steps']} steps, losses printed "
               f"{first['first_loss']:.4f} -> epoch {first['epoch_losses'][0]:.6f},"
               f" val {first['val_losses'][0]:.6f}, Aux column "
               f"{[round(a, 3) for a in first['moe_aux']]}, steady step "
               f"{step_ms:.2f} ms (host clock), peak memory {peak:.3f} GiB, "
               f"tokens/s {first['tokens_per_sec']:.1f}; resumed at S "
               f"{MP_CLI_SEQ}: epoch 2 loss {second['epoch_losses'][0]:.6f}, "
               f"Aux {[round(a, 3) for a in second['moe_aux']]}, --sample "
               f"{MP_CLI_SAMPLE} {second['sample']} (decode kernel launches "
               f"{decodes}) [{smi}]")
    return out


def _moe_cross_card(torch, plains, smi):
    """Phase 29 across W cards (4 where four are visible, else 2): tp at
    (1, W) in f32, held against one card's plain MoE step within
    ``MP_XCARD_TOL`` (JAX's global semantics: the same function); pp
    (gpipe) and sp (ring) at degree W, whose balance loss is a per-shard
    statistic and whose capacity is per microbatch or per shard (JAX's
    semantics), reported beside one card's without a bound."""
    cards = torch.cuda.device_count()
    world = 4 if cards >= 4 else 2 if cards >= 2 else 1
    if world < 2:
        _print(f"[moe-xcard] {cards} card visible: tp, pp and sp across "
               "cards need two or more (python3 chip_smoke.py --moe-only "
               "where four are visible)")
        return None
    moe = dict(n_experts=MOE_LAYER["experts"])
    runs = [("float32", dict(run, moe=moe), world) for run in MOE_CROSS]
    with tempfile.TemporaryDirectory() as tmp:
        ref_path = os.path.join(tmp, "plain.pt")
        torch.save({"float32": plains["float32"]["params"]}, ref_path)
        t0 = time.perf_counter()
        ranks = _run_ranks(_mp_rank, world, (runs, ref_path),
                           timeout_s=900, per_rank=True)
        wall = time.perf_counter() - t0
    plain = plains["float32"]
    out = {}
    for i, (tname, run, deg) in enumerate(runs):
        name = _mp_name(run)
        for r, got in enumerate(ranks):
            want = (_sp_launches_want(run["sp_mode"], deg, r)
                    if run["kind"] == "sp" else _mp_launches_want(run))
            if got[i]["launches"] != want:
                raise AssertionError(
                    f"MoE {name} degree {deg} rank {r}: one step launched "
                    f"{got[i]['launches']}, the schedule wants {want}")
        got = ranks[0][i]
        dloss = max(abs(a - b) for a, b in zip(got["losses"],
                                               plain["losses"]))
        if run["kind"] == "tp":
            tol = MP_XCARD_TOL[tname]
            for r, g in enumerate(ranks):
                jax_bytes = MOE_JAX_RESIDENT[("plain", 1, deg)]
                if (g[i]["resident"]["params"],
                        g[i]["resident"]["opt_state"]) != jax_bytes:
                    raise AssertionError(
                        f"MoE tp degree {deg} rank {r}: resident "
                        f"{g[i]['resident']}, JAX's placement {jax_bytes}")
            if dloss > tol["loss"] or got["param_err"] > tol["param"]:
                raise AssertionError(
                    f"MoE tp f32 at (1, {deg}): loss err {dloss}, param err "
                    f"{got['param_err']} after {MOE_STEPS} steps against one "
                    f"card's plain MoE step, past {tol}")
            verdict = f"held within {tol}"
        else:
            verdict = ("reported, no bound: a per-shard balance loss and "
                       "capacity, JAX's semantics")
        out[name] = dict(losses=got["losses"], aux=got["aux"],
                         loss_err=dloss, param_err=got["param_err"],
                         step_ms=[g[i]["step_ms"] for g in ranks],
                         peak_gib=[g[i]["peak_gib"] for g in ranks])
        _print(f"[moe-xcard] gpt_small E={moe['n_experts']} top-1 f32 "
               f"B={MP_SHAPE['batch']} S={MP_SHAPE['seq']} {name} degree "
               f"{deg} on {world} cards: losses {got['losses']} (one card "
               f"{plain['losses']}), aux {got['aux']} (one card "
               f"{plain['aux']}), loss err {dloss}, param err "
               f"{got['param_err']} ({verdict}); step a rank "
               f"{[round(g[i]['step_ms'], 2) for g in ranks]} ms (one card "
               f"{plain['step_ms']:.2f}), peak above the state a rank "
               f"{[round(g[i]['peak_gib'], 3) for g in ranks]} GiB, "
               f"launches a step {got['launches']} [{smi}]")
    _print(f"[moe-xcard] {len(runs)} runs on {world} ranks: wall "
           f"{wall:.1f} s [{smi}]")
    return out


def _moe_phase(torch, fa, train_lm, smi, da):
    """Phase 29 (see the module docstring)."""
    t0 = time.perf_counter()
    layer = _moe_layer_check(torch, smi)
    plains, one = _moe_one_card(torch, fa, smi)
    cli = _moe_cli(train_lm, torch, smi, da)
    cross = _moe_cross_card(torch, plains, smi)
    _print(f"[moe] phase 29 wall {time.perf_counter() - t0:.1f} s [{smi}]")
    return dict(layer=layer, cli=cli, cross=cross, **one)


# ------------------------------------------------------------- phase 30


def _lines_until(proc, deadline):
    """``proc``'s output lines as they come, until its end or the
    deadline (read on a thread: a silent child cannot block the loop)."""
    lines = queue.Queue()

    def pump():
        for line in proc.stdout:
            lines.put(line)
        lines.put(None)

    threading.Thread(target=pump, daemon=True).start()
    while True:
        try:
            line = lines.get(timeout=max(0.0, deadline - time.monotonic()))
        except queue.Empty:
            return
        if line is None:
            return
        yield line


def _heal_env(**extra):
    """The environment of a phase 30 child: this one's, without any
    fault plan, heartbeat or group of this process, plus ``extra``."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("PMDT_FAULT_PLAN", "PMDT_HEARTBEAT",
                        "PMDT_MASTER_ADDR", "PMDT_WORLD_SIZE", "PMDT_RANK")}
    env.update(extra)
    return env


def _heal_child(cli, argv, env, timeout_s=HEAL_CHILD_TIMEOUT):
    """``{cli}.main(argv)`` in a fresh interpreter (the fault plan is
    armed at import, from ``env``): returns (its summary, with every
    kernel counter of that process under ``process_launches``; its
    merged output)."""
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "summary.json")
        proc = subprocess.run(
            [sys.executable, "-u", "-c", HEAL_CHILD, cli, out, *argv],
            cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            timeout=timeout_s)
        if proc.returncode != 0:
            raise AssertionError(
                f"{cli} {' '.join(argv)} exited {proc.returncode}:\n"
                f"{proc.stdout[-4000:]}")
        with open(out) as f:
            return json.load(f), proc.stdout


def _heal_payload_diff(torch, path_a, path_b):
    """The largest |a - b| over two checkpoints' floating tensors; every
    other entry (count, ``initialized``, epoch) must be equal."""
    a = torch.load(path_a, map_location="cpu", weights_only=True)
    b = torch.load(path_b, map_location="cpu", weights_only=True)
    if set(a) != set(b):
        raise AssertionError(f"{path_a} and {path_b} hold other keys")
    diff = 0.0
    for k, x in a.items():
        if isinstance(x, torch.Tensor) and x.is_floating_point():
            diff = max(diff, float((x.double() - b[k].double()).abs().max()))
        elif not (torch.equal(x, b[k]) if isinstance(x, torch.Tensor)
                  else x == b[k]):
            raise AssertionError(f"{path_a} and {path_b} differ at {k}")
    return diff


def _heal_launches(fa, fused_sgd_):
    return {"fused_sgd": fused_sgd_.launches,
            **{n: getattr(fa, n).launches for n in FLASH_PRODUCTS}}


def _heal_zero(fa, fused_sgd_):
    fused_sgd_.launches = 0
    for n in FLASH_PRODUCTS:
        getattr(fa, n).launches = 0


def _rows_by_epoch(path):
    """``{epoch: row}`` of a log (a restart rewrites an epoch's row;
    the last one stands) and how many rows repeat an epoch."""
    rows = [line.split() for line in open(path) if line.strip()]
    by = {int(r[0]): r for r in rows}
    return by, len(rows) - len(by)


def _heal_restart(torch, cli, argv, plain, save_path, epochs):
    """Phase 30 parts 1 and 2: ``cli`` under ``--max_restarts 2`` with
    the second checkpoint write failing once (a child), against the
    uninterrupted run's rows and final payload (``plain``: its save
    path). Returns the child's summary."""
    env = _heal_env(PMDT_FAULT_PLAN=HEAL_FAULT_PLAN)
    summary, out = _heal_child(cli, argv + [
        "--max_restarts", "2", "--restart_backoff", "0", "--save_path",
        save_path], env)
    if summary.get("restarts") != 1:
        raise AssertionError(f"{cli}: {summary.get('restarts')} restarts, "
                             "expected 1")
    resumed = re.findall(r"^Resumed from (\S+) \(continuing at epoch 2\)",
                         out, re.M)
    if [os.path.basename(p) for p in resumed] != ["model_1.pth"]:
        raise AssertionError(f"{cli}: resumed from {resumed}, expected "
                             "model_1.pth once")
    ours, repeats = _rows_by_epoch(os.path.join(save_path, "train.log"))
    ref, _ = _rows_by_epoch(os.path.join(plain, "train.log"))
    if sorted(ours) != list(range(1, epochs + 1)) or repeats != 1:
        raise AssertionError(f"{cli}: train.log epochs {sorted(ours)} with "
                             f"{repeats} repeated rows")
    row_diff = max(abs(float(a) - float(b)) for e in ref
                   for a, b in zip(ours[e][1:], ref[e][1:]))
    final = f"model_{epochs}.pth"
    with open(os.path.join(save_path, final), "rb") as f:
        a = f.read()
    with open(os.path.join(plain, final), "rb") as f:
        b = f.read()
    pay_diff = _heal_payload_diff(torch, os.path.join(save_path, final),
                                  os.path.join(plain, final))
    return summary, row_diff, pay_diff, a == b


def _heal_image(torch, image_main, fa, fused_sgd_, smi, tmp):
    """Phase 30 parts 1, 3 and 6 (the image CLI)."""
    os.environ["PMDT_SMALL_SYNTH"] = str(HEAL_IMAGES)
    argv = HEAL_IMAGE_ARGV + ["--epochs", "3", "--save_every", "1"]
    plain = os.path.join(tmp, "image-plain")
    _heal_zero(fa, fused_sgd_)
    t0 = time.perf_counter()
    ref = image_main.main(argv + ["--save_path", plain])
    plain_wall = time.perf_counter() - t0
    if fused_sgd_.launches != 3 * HEAL_IMAGE_STEPS:
        raise AssertionError(f"the plain image run launched fused_sgd "
                             f"{fused_sgd_.launches} times")
    # 1. restart after the epoch-2 checkpoint write fails
    t0 = time.perf_counter()
    child, row_diff, pay_diff, same = _heal_restart(
        torch, "main", argv, plain, os.path.join(tmp, "image-restart"), 3)
    wall = time.perf_counter() - t0
    want = 4 * HEAL_IMAGE_STEPS  # epochs 1, 2, then 2 and 3 again
    got = child["process_launches"]["fused_sgd"]
    if got != want:
        raise AssertionError(f"the restarted image run launched fused_sgd "
                             f"{got} times, expected {want}")
    if pay_diff > HEAL_PAYLOAD_TOL or row_diff > HEAL_PAYLOAD_TOL:
        raise AssertionError(f"restarted image run off the plain one: rows "
                             f"{row_diff}, payload {pay_diff}")
    _print(f"[heal] image restart: ResNet-18 f32 B 64, 3 epochs of "
           f"{HEAL_IMAGE_STEPS} steps, '{HEAL_FAULT_PLAN}': 1 restart, "
           f"resumed from model_1.pth, rows max diff {row_diff:g}, "
           f"model_3.pth payload max diff {pay_diff:g} (file bytes "
           f"{'equal' if same else 'differ'}) against the uninterrupted "
           f"run; fused_sgd launches {got} (plain run {3 * HEAL_IMAGE_STEPS}"
           f"); wall {wall:.2f} s (plain in-process {plain_wall:.2f} s) "
           f"[{smi}]")
    # 3. SIGTERM during epoch 2, then --resume auto
    term = os.path.join(tmp, "image-term")
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-u", "-c", HEAL_CHILD, "main", "-", *argv,
         "--print-freq", "1", "--save_path", term],
        cwd=os.path.dirname(os.path.abspath(__file__)), env=_heal_env(),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lines, sent = [], None
    try:
        for line in _lines_until(proc, time.monotonic() + HEAL_CHILD_TIMEOUT):
            lines.append(line)
            if sent is None and line.startswith("Epoch: [2][2/"):
                proc.send_signal(signal.SIGTERM)
                sent = time.perf_counter()
        rc = proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    out = "".join(lines)
    kept = os.path.join(term, "model_1.pth")
    if (sent is None or rc != 0 or f"keeping existing {kept}" not in out
            or os.path.exists(os.path.join(term, "model_2.pth"))):
        raise AssertionError(f"SIGTERM drill: rc {rc}, signal sent "
                             f"{sent is not None}:\n{out[-3000:]}")
    exit_s = time.perf_counter() - sent
    _heal_zero(fa, fused_sgd_)
    resumed = image_main.main(argv + ["--resume", "auto", "--save_path",
                                      term])
    term_diff = _heal_payload_diff(torch,
                                   os.path.join(term, "model_3.pth"),
                                   os.path.join(plain, "model_3.pth"))
    if term_diff > HEAL_PAYLOAD_TOL or fused_sgd_.launches != \
            2 * HEAL_IMAGE_STEPS:
        raise AssertionError(f"SIGTERM drill resume: payload diff "
                             f"{term_diff}, launches {fused_sgd_.launches}")
    _print(f"[heal] SIGTERM drill: signal at epoch 2 step 2, exit code "
           f"{rc} {exit_s:.2f} s later, model_1.pth kept (no model_2.pth); "
           f"--resume auto ran epochs 2-3 ({resumed['steps']} steps, "
           f"fused_sgd launches {fused_sgd_.launches}) to model_3.pth, "
           f"payload max diff {term_diff:g} against the uninterrupted run; "
           f"wall {time.perf_counter() - t0:.2f} s [{smi}]")
    # 6. --profile LOGDIR for one epoch
    os.environ["PMDT_SMALL_SYNTH"] = str(HEAL_PROFILE_IMAGES)
    logdir = os.path.join(tmp, "profile")
    _heal_zero(fa, fused_sgd_)
    image_main.main(HEAL_IMAGE_ARGV + [
        "--epochs", "1", "--profile", logdir, "--save_path",
        os.path.join(tmp, "image-profile")])
    traces = [os.path.join(root, n) for root, _, names in os.walk(logdir)
              for n in names if n.endswith(".pt.trace.json")]
    if len(traces) != 1:
        raise AssertionError(f"--profile wrote {traces}")
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    sgd = collections.Counter(
        e["name"] for e in events
        if e.get("cat") == "kernel" and "fused_sgd" in e.get("name", ""))
    steps = HEAL_PROFILE_IMAGES // 64
    # one call: the update kernel (vector or scalar form) and the flags'
    updates = sum(n for name, n in sgd.items() if "flags" not in name)
    if updates != steps or fused_sgd_.launches != steps:
        raise AssertionError(f"the trace lists {dict(sgd)} fused_sgd "
                             f"kernels, launches {fused_sgd_.launches}; "
                             f"expected {steps} updates")
    _print(f"[heal] profile: main --profile, 1 epoch of {steps} steps: "
           f"{os.path.basename(traces[0])} {os.path.getsize(traces[0])} "
           f"bytes, {len(events)} events; row 8 listed as {dict(sgd)} "
           f"({steps} launches) [{smi}]")
    return {"restart_launches": got, "resume_launches": 2 * HEAL_IMAGE_STEPS,
            "profile_kernel": sorted(sgd)}


def _heal_lm(torch, train_lm, fa, fused_sgd_, smi, tmp):
    """Phase 30 part 2: train_lm under --max_restarts."""
    argv = HEAL_LM_ARGV + ["--epochs", "3", "--save_every", "1"]
    plain = os.path.join(tmp, "lm-plain")
    _heal_zero(fa, fused_sgd_)
    train_lm.main(argv + ["--save_path", plain])
    plain_launches = _heal_launches(fa, fused_sgd_)
    t0 = time.perf_counter()
    child, row_diff, pay_diff, same = _heal_restart(
        torch, "train_lm", argv, plain, os.path.join(tmp, "lm-restart"), 3)
    wall = time.perf_counter() - t0
    got = {n: child["process_launches"][n] for n in FLASH_PRODUCTS}
    steps = 4 * HEAL_LM_STEPS  # epochs 1, 2, then 2 and 3 again
    want = {n: 12 * steps for n in FLASH_PRODUCTS}
    if got != want:
        raise AssertionError(f"the restarted LM run launched {got}, "
                             f"expected {want}")
    if row_diff > HEAL_LM_TOL:
        raise AssertionError(f"restarted LM rows off by {row_diff}")
    ours, _ = _rows_by_epoch(os.path.join(tmp, "lm-restart", "train.log"))
    _print(f"[heal] LM restart: gpt_small bf16 B 8 x S 1024 lr 0.01, 3 "
           f"epochs of {HEAL_LM_STEPS} steps: 1 restart, resumed from "
           f"model_1.pth, epoch losses "
           f"{[float(ours[e][1]) for e in sorted(ours)]}, rows max diff "
           f"{row_diff:g}, model_3.pth payload max diff {pay_diff:g} (file "
           f"bytes {'equal' if same else 'differ'}) against the "
           f"uninterrupted run; launches {got} (plain {plain_launches}); "
           f"wall {wall:.2f} s [{smi}]")
    return got


def _heal_sharded(torch, image_main, smi, tmp):
    """Phase 30 part 4: ``main --fsdp`` with the sharded async backend."""
    from pytorch_multiprocessing_distributed_tpu_torch.train.orbax_ckpt \
        import OrbaxCheckpointer

    cards = torch.cuda.device_count()
    data, mp = (2, 2) if cards >= 4 else (1, 2) if cards >= 2 else (1, 1)
    os.environ["PMDT_SMALL_SYNTH"] = str(HEAL_IMAGES)
    base = ["--device", "cuda", "--world_size", str(data),
            "--model_parallel", str(mp), "--fsdp"] + HEAL_IMAGE_COMMON
    orbax = ["--ckpt_backend", "orbax", "--ckpt_async", "--save_every", "1"]
    world = data * mp
    gathered = os.path.join(tmp, "fsdp-msgpack")
    sharded = os.path.join(tmp, "fsdp-orbax")
    t0 = time.perf_counter()
    _zero_main(image_main, base + ["--epochs", "2", "--save_path",
                                   gathered], world)
    _zero_main(image_main, base + orbax + ["--epochs", "1", "--save_path",
                                           sharded], world)
    _zero_main(image_main, base + orbax + [
        "--epochs", "2", "--resume", "auto", "--torch_export",
        "--save_path", sharded], world)
    wall = time.perf_counter() - t0
    ck = OrbaxCheckpointer(sharded)
    by_rank = ck.bytes_by_rank(1)
    ref = torch.load(os.path.join(gathered, "model_2.pth"),
                     map_location="cpu", weights_only=True)
    state_bytes = sum(t.numel() * t.element_size() for t in ref.values()
                      if isinstance(t, torch.Tensor))
    if sorted(by_rank) != list(range(world)) or max(by_rank.values()) > \
            HEAL_SHARD_SLACK * state_bytes / world:
        raise AssertionError(f"sharded save bytes by rank {by_rank}, the "
                             f"state {state_bytes} B over {world} ranks")
    got = ck.load_payload(2)
    resume_diff = max(float((got[k].double() - ref[k].double()).abs().max())
                      for k in ref if isinstance(ref[k], torch.Tensor))
    if set(got) != set(ref) or resume_diff > HEAL_PAYLOAD_TOL:
        raise AssertionError(f"the resumed sharded run is off the gathered "
                             f"uninterrupted one by {resume_diff}")
    # the sharded checkpoint into a plain state on one card, against the
    # weights the sharded run gathered itself (--torch_export)
    from pytorch_multiprocessing_distributed_tpu_torch.models import (
        get_model, init_model)
    from pytorch_multiprocessing_distributed_tpu_torch.train import (
        create_train_state, sgd)

    model = init_model(get_model("res"), 1).cuda()
    state = create_train_state(model, sgd(0.1, momentum=0.9,
                                          weight_decay=1e-4, nesterov=True))
    ck.restore(state, 2)
    export = torch.load(os.path.join(sharded, "model_2.torch.pth"),
                        map_location="cpu", weights_only=True)
    mine = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    one_diff = max(float((mine[k].double() - export[k].double()).abs().max())
                   for k in export if export[k].is_floating_point())
    if one_diff != 0.0:
        raise AssertionError(f"the one-card restore is off the gathered "
                             f"weights by {one_diff}")
    _print(f"[heal] sharded checkpoint: main --fsdp at ({data}, {mp}) on "
           f"{world} card(s), --ckpt_backend orbax --ckpt_async: bytes a "
           f"rank {by_rank} against the state's {state_bytes} / {world} = "
           f"{state_bytes / world:.0f}; --resume auto payload max diff "
           f"{resume_diff:g} against the uninterrupted gathered run; the "
           f"checkpoint restored into a plain one-card state: max diff "
           f"{one_diff:g} against the run's gathered weights; wall "
           f"{wall:.2f} s [{smi}]"
           + ("" if world > 1 else " (one card visible: a 1 x 1 grid; "
              "on four cards, python3 chip_smoke.py --heal-only "
              "runs (2, 2))"))
    del state, model
    return by_rank


def _heal_peer_loss(torch, smi):
    """Phase 30 part 5: two NCCL ranks of train_lm under
    PMDT_HEARTBEAT, rank 1 SIGKILLed after the first window."""
    if torch.cuda.device_count() < 2:
        _print(f"[heal] peer loss: needs two cards (one NCCL rank a card), "
               f"{torch.cuda.device_count()} visible: not run on this call "
               f"(on four cards: python3 chip_smoke.py --heal-only) "
               f"[{smi}]")
        return None
    soft, hard, interval = (float(x) for x in HEAL_HEARTBEAT.split(":"))
    port = _store_port()
    procs = []
    with tempfile.TemporaryDirectory() as tmp:
        try:
            for rank in range(2):
                env = _heal_env(PMDT_MASTER_ADDR=f"127.0.0.1:{port}",
                                PMDT_WORLD_SIZE="2", PMDT_RANK=str(rank),
                                PMDT_HEARTBEAT=HEAL_HEARTBEAT)
                procs.append(subprocess.Popen(
                    [sys.executable, "-u", "-c", HEAL_CHILD, "train_lm", "-",
                     *HEAL_LM_ARGV, "--corpus_tokens", "200000", "--epochs",
                     "1", "--print_freq", "1", "--save_path", tmp],
                    cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True))
            killed = raised = t_first = window_s = None
            lines = []
            for line in _lines_until(procs[0], time.monotonic()
                                     + HEAL_CHILD_TIMEOUT):
                lines.append(line)
                now = time.perf_counter()
                if line.startswith("Epoch: [1][0/"):
                    t_first = now
                if killed is None and line.startswith("Epoch: [1][1/"):
                    window_s = now - t_first
                    procs[1].send_signal(signal.SIGKILL)
                    killed = now
                if "PeerLostError: peer" in line:
                    raised = now
                    break
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                proc.wait()
    out = "".join(lines)
    if killed is None or raised is None or "peer '1' lost" not in out:
        raise AssertionError(f"peer-loss drill: killed {killed is not None},"
                             f" raised {raised is not None}:\n{out[-3000:]}")
    secs = raised - killed
    # seeing rank 1's last beat takes up to one poll, the verdict past
    # the hard limit up to another
    bound = hard + 2 * interval + window_s
    if secs > bound:
        raise AssertionError(f"PeerLostError {secs:.2f} s after the kill, "
                             f"past {bound:.2f} s")
    err = lines[-1].strip()
    _print(f"[heal] peer loss: train_lm --parallel dp on 2 NCCL ranks, "
           f"PMDT_HEARTBEAT={HEAL_HEARTBEAT}, rank 1 SIGKILLed after its "
           f"first window: rank 0 raised '{err}' {secs:.2f} s after the "
           f"kill (bound: hard {hard:g} s + 2 polls of {interval:g} s + one "
           f"window {window_s:.2f} s = {bound:.2f} s) [{smi}]")
    return secs


def _heal_phase(torch, image_main, train_lm, fa, fused_sgd_, smi):
    """Phase 30 (see the module docstring)."""
    t0 = time.perf_counter()
    _deterministic(torch)
    with tempfile.TemporaryDirectory() as tmp:
        image = _heal_image(torch, image_main, fa, fused_sgd_, smi, tmp)
        lm = _heal_lm(torch, train_lm, fa, fused_sgd_, smi, tmp)
        shards = _heal_sharded(torch, image_main, smi, tmp)
    peer = _heal_peer_loss(torch, smi)
    _print(f"[heal] phase 30 wall {time.perf_counter() - t0:.1f} s [{smi}]")
    return dict(image=image, lm=lm, shards=shards, peer_s=peer)


# ------------------------------------------------------------- phase 31


def _tp_engine_runs(torch, serve_lm, da, smi):
    """The M = 1 tensor-parallel path (a 1 x 1 grid) on phase 4's
    workload beside the plain engine, one TP_ONE_CARD run at a time:
    transcripts bit-equal, the TP run's launches 12 a decode pass of its
    decode variant and 12 an armed pass of its verify variant (none of
    any other). Returns ``{variant: launches a pass}``."""
    from pytorch_multiprocessing_distributed_tpu_torch.models import (
        get_model)
    from pytorch_multiprocessing_distributed_tpu_torch.parallel.mesh import (
        make_grid, reset_grid)
    from pytorch_multiprocessing_distributed_tpu_torch.serving import (
        ServingEngine, init_params)

    model = get_model("gpt_small", dtype=torch.bfloat16)
    model.load_state_dict(init_params(model, 0, "cuda"), assign=True)
    args = serve_lm.build_parser().parse_args(SERVE_BASE)
    requests = list(serve_lm._load_requests(args, model.vocab_size, []))
    per_pass = {}
    grid = make_grid(1, 1)
    try:
        for label, decode_v, verify_v, kw in TP_ONE_CARD:
            common = dict(max_slots=8, decode_horizon=4, **kw)
            plain = [r.tokens for r in ServingEngine(
                model, **common).serve(requests)]
            _zero_decode_counts(da)
            t0 = time.perf_counter()
            engine = ServingEngine(model, mesh=grid, **common)
            got = [r.tokens for r in engine.serve(requests)]
            wall = time.perf_counter() - t0
            counts = _decode_counts(da)
            passes = engine.passes_by_k
            plain_passes = passes.get(0, 0)
            armed = sum(n for k, n in passes.items() if k)
            want = {name: 0 for name in counts}
            want[decode_v] = 12 * plain_passes
            if verify_v is not None:
                want[verify_v] = 12 * armed
            if got != plain:
                raise AssertionError(
                    f"tp M=1 {label}: transcripts differ from the plain "
                    "engine's")
            if (plain_passes < 1 or (verify_v is not None and armed < 1)
                    or counts != want):
                raise AssertionError(
                    f"tp M=1 {label}: launches {counts} over passes "
                    f"{passes}; expected {want}")
            per_pass[decode_v] = counts[decode_v] / plain_passes
            if verify_v is not None:
                per_pass[verify_v] = counts[verify_v] / armed
            _print(f"[tp] M=1 {label}: gpt_small bf16 16 requests x 32 "
                   f"tokens, 8 slots, horizon 4 {kw}: transcripts "
                   f"bit-equal to the plain engine, passes by k {passes}, "
                   f"launches { {n: c for n, c in counts.items() if c} } "
                   f"(12 a pass), all-gathers {engine.decode_gathers}, "
                   f"wall {wall:.2f} s [{smi}]")
            del engine
    finally:
        reset_grid()
    return per_pass


def _tp_kernel_rows(torch, F, da, quantize_kv, rate, smi):
    """Rows 1-4 (and their int8 twins) at a tensor-parallel rank's
    shapes: TP_HEADS heads of gpt_small's decode (8 slots, Dh 64;
    verify K1 = VERIFY_ROWS), windows TP_WINDOWS, against their plain
    versions in f32 and bf16, and timed in bf16 with their bound and
    SDPA's time at that shape. Returns ``{name: {"H6_W64": times and
    error, ...}}``."""
    rows = {}
    for heads in TP_HEADS:
        for w in TP_WINDOWS:
            for name in ("decode_attention",) + tuple(VARIANTS) + tuple(
                    VERIFY_VARIANTS):
                verify = name in VERIFY_VARIANTS
                errs = []
                for dtype in (torch.float32, torch.bfloat16):
                    seed = 31 + heads + w
                    if name == "decode_attention":
                        q, k, v, pos = _decode_inputs(torch, w, dtype, seed,
                                                      heads=heads)
                        table = None
                        kernel, plain = _variant_calls(da, name, q, k, v,
                                                       None, pos, w)
                    elif verify:
                        q, k, v, table, pos = _verify_case(
                            torch, quantize_kv, name, w, dtype, seed,
                            heads=heads)
                        kernel, plain = _verify_calls(da, q, k, v, table,
                                                      pos, w)
                    else:
                        q, k, v, table, pos = _variant_case(
                            torch, quantize_kv, name, w, dtype, seed,
                            heads=heads)
                        kernel, plain = _variant_calls(da, name, q, k, v,
                                                       table, pos, w)
                    counts = _decode_counts(da)
                    got = kernel()
                    torch.cuda.synchronize()
                    _set_decode_counts(da, counts)
                    err = float((got - plain()).abs().max())
                    tol = VERIFY_TOL if verify else PAGED_TOL
                    if not (bool(torch.isfinite(got).all()) and err <= tol):
                        raise AssertionError(
                            f"{name} H={heads} W={w} {dtype}: max|err| "
                            f"{err} > {tol} (or not finite)")
                    errs.append(err)
                if name == "decode_attention":
                    t = _time_decode(torch, F, da.decode_attention,
                                     da.torch_decode_attention, q, k, v,
                                     pos, rate)
                elif verify:
                    t = _time_verify(torch, F, da, q, k, v, table, pos, w,
                                     rate)
                else:
                    t = _time_variant(torch, F, da, name, q, k, v, table,
                                      pos, w, rate)
                t = dict(t, max_abs_err=max(errs))
                rows.setdefault(name, {})[f"H{heads}_W{w}"] = t
                _print(f"[tp-kernel] {name} bf16 N=8"
                       + (f" K1={VERIFY_ROWS}" if verify else "")
                       + f" H={heads} Dh=64 W={w}: max_abs_err "
                       f"{max(errs):.3e} (f32 and bf16 against the plain "
                       f"version) ms={t['ms']:.5f} "
                       f"eager_ms={t['eager_ms']:.5f} "
                       f"plain_ms={t['plain_ms']:.5f} "
                       f"library_ms={t['library_ms']:.5f} "
                       f"bound_ms={t['bound_ms']:.5f} ({t['bound_by']}) "
                       f"[{smi}]")
                del q, k, v, table, pos
    return rows


def _tp_profile(torch, serve_lm, grid, traced):
    """Decode passes of gpt_small bf16 dense (8 slots, horizon 4, phase
    4's first 8 prompts) on ``grid`` (None: the plain engine on one
    card). The 8 prompts x 8 tokens are served twice (the first on a
    fresh engine and group), then with 64 new tokens each
    TP_PROFILE_STEPS steady engine steps are timed on the host clock and
    as many more traced by ``torch.profiler`` when ``traced`` (rank 0;
    the other ranks step alike, untraced). Returns both serves' walls
    and, a decode pass: the host wall, and from the trace the wall, the
    card's busy time (the union of its kernels' intervals), the NCCL
    kernels' time and count, the other kernels' time, the host's time
    inside the all-gather calls and its time blocked on the card
    (TP_HOST_WAITS)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from pytorch_multiprocessing_distributed_tpu_torch.models import (
        get_model)
    from pytorch_multiprocessing_distributed_tpu_torch.serving import (
        ServingEngine, init_params)

    model = get_model("gpt_small", dtype=torch.bfloat16)
    model.load_state_dict(init_params(model, 0, "cuda"), assign=True)
    args = serve_lm.build_parser().parse_args(SERVE_BASE)
    prompts = [p for p, _ in serve_lm._load_requests(
        args, model.vocab_size, [])][:8]
    engine = ServingEngine(model, mesh=grid, max_slots=8, decode_horizon=4)
    walls = []
    for _ in range(2):  # the first: NCCL's communicators, cuBLAS, caches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.serve([(p, 8) for p in prompts])
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    for p in prompts:
        engine.submit(p, 64)
    while engine.scheduler.queue_depth or engine._pending is not None:
        engine.step()

    def steps():
        torch.cuda.synchronize()
        before = sum(engine.passes_by_k.values())
        t0 = time.perf_counter()
        for _ in range(TP_PROFILE_STEPS):
            engine.step()
        torch.cuda.synchronize()
        passes = sum(engine.passes_by_k.values()) - before
        return (time.perf_counter() - t0) * 1e3 / passes, passes

    wall_ms, passes = steps()
    out = dict(passes=passes, wall_ms=wall_ms, cold_serve_ms=walls[0],
               warm_serve_ms=walls[1])
    if not traced:
        steps()
        return out
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        traced_ms, passes = steps()
    kernels, nccl, gather_calls, waits = [], [], [], []
    for e in prof.events():
        span = (e.time_range.start, e.time_range.end)
        name = e.name.lower()
        if e.device_type == DeviceType.CUDA:
            if getattr(e, "is_user_annotation", False):
                continue  # a record_function's span on the card's line
            kernels.append(span)
            if "nccl" in name:
                nccl.append(span)
        elif "all_gather" in name or "allgather" in name:
            gather_calls.append(span)
        elif e.name in TP_HOST_WAITS:
            waits.append(span)

    def per_pass(spans):  # ms a pass covered by the union of the spans
        total, reach = 0.0, float("-inf")
        for start, end in sorted(spans):
            if end > reach:
                total += end - max(start, reach)
                reach = end
        return total / 1e3 / passes

    busy = per_pass(kernels)
    return dict(out, traced_passes=passes, traced_wall_ms=traced_ms,
                busy_ms=busy, idle=1 - busy / traced_ms,
                nccl_ms=per_pass(nccl), nccl_kernels=len(nccl) / passes,
                other_ms=per_pass(set(kernels) - set(nccl)),
                gather_host_ms=per_pass(gather_calls),
                wait_host_ms=per_pass(waits))


def _tp_rank(rank, world, port, runs, ports, out_path):
    """One NCCL rank of phase 31's runs across cards: ``serve_lm.main(
    argv + ["--tp", world])`` for each run, a fresh rendezvous port
    each, then :func:`_tp_profile` on the ``(1, world)`` grid on the
    last port; rank 0 writes ``{name: (snapshot, {uid: tokens})}`` and
    ``"profile"``."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch

    from pytorch_multiprocessing_distributed_tpu_torch import serve_lm
    from pytorch_multiprocessing_distributed_tpu_torch.parallel import dist
    from pytorch_multiprocessing_distributed_tpu_torch.parallel.mesh import (
        make_grid)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    for (name, argv), run_port in zip(runs, ports):
        os.environ.update(PMDT_MASTER_ADDR=f"127.0.0.1:{run_port}",
                          PMDT_WORLD_SIZE=str(world), PMDT_RANK=str(rank))
        try:
            out[name] = _serve_transcripts(serve_lm,
                                           argv + ["--tp", str(world)])
        except BaseException:
            # every rank's own traceback (the spawn reports one rank's)
            print(f"[tp-xcard] rank {rank} failed in {name}:",
                  file=sys.stderr, flush=True)
            traceback.print_exc()
            raise
    os.environ.update(PMDT_MASTER_ADDR=f"127.0.0.1:{ports[-1]}",
                      PMDT_WORLD_SIZE=str(world), PMDT_RANK=str(rank))
    dist.init_process("cuda")
    out["profile"] = _tp_profile(torch, serve_lm, make_grid(1, world),
                                 traced=rank == 0)
    dist.barrier()
    dist.destroy_process_group()
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump(out, f)


def _first_diff(a, b):
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                min(len(a), len(b)))


def _tp_cross_card(torch, serve_lm, smi):
    """TP_CONFIGS through ``serve_lm --tp M`` on M cards, each TP_RUNS
    variant in bf16 and f32 (TF32 off) on phase 4's workload, beside the
    same run on one card: f32 transcripts token-exact, bf16 agreement
    printed; tokens/s, TTFT and a rank's bytes; rank 0's launches held
    to L a decode pass of the run's decode variant (and L an armed pass
    of its verify variant, none of any other) and its all-gathers to
    1 + 4L a pass."""
    from pytorch_multiprocessing_distributed_tpu_torch.models import (
        get_model)

    cards = torch.cuda.device_count()
    configs = [(m, tp) for m, tp in TP_CONFIGS if tp <= cards]
    if not configs:
        _print(f"[tp-xcard] skipped: {cards} card(s) visible; tensor-"
               "parallel serving needs two or more (python3 chip_smoke.py "
               f"--tp-only where four are visible) [{smi}]")
        return {}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    base = [a for a in SERVE_BASE if a != "--quiet"]
    results = {}
    profiles = {1: _tp_profile(torch, serve_lm, None, traced=True)}
    for model in sorted({m for m, _ in configs}):
        for dtype in ("bfloat16", "float32"):
            for label, extra in TP_RUNS:
                argv = [a if a != "gpt_small" else model for a in base]
                argv = [a if a != "bfloat16" else dtype for a in argv]
                one = _serve_transcripts(serve_lm, argv + extra)
                results[(model, dtype, label, 1)] = one
    for tp in sorted({tp for _, tp in configs}):
        runs = []
        for model, m in configs:
            if m != tp:
                continue
            for dtype in ("bfloat16", "float32"):
                for label, extra in TP_RUNS:
                    argv = [a if a != "gpt_small" else model for a in base]
                    argv = [a if a != "bfloat16" else dtype for a in argv]
                    runs.append((f"{model}|{dtype}|{label}", argv + extra))
        t0 = time.perf_counter()
        got = _run_ranks(_tp_rank, tp,
                         (runs, _store_ports(len(runs) + 1)),
                         TP_RANKS_TIMEOUT)
        _print(f"[tp-xcard] M={tp}: {len(runs)} serve_lm --tp {tp} runs in "
               f"{time.perf_counter() - t0:.1f} s [{smi}]")
        profiles[tp] = got.pop("profile")
        for key, value in got.items():
            model, dtype, label = key.split("|")
            results[(model, dtype, label, tp)] = value
    summary = {}
    for model, tp in configs:
        jax_bytes, jax_small = TP_JAX_PARAM_BYTES[(model, tp)]
        for dtype in ("bfloat16", "float32"):
            for label, extra in TP_RUNS:
                snap, toks = results[(model, dtype, label, tp)]
                one_snap, one = results[(model, dtype, label, 1)]
                if snap["requests_completed"] != 16 or len(toks) != 16:
                    raise AssertionError(
                        f"tp {model} M={tp} {dtype} {label}: "
                        f"{snap['requests_completed']}/16 requests")
                same = sum(toks[u] == one.get(u) for u in toks)
                diffs = {u: _first_diff(toks[u], one[u]) for u in toks
                         if toks[u] != one.get(u)}
                if dtype == "float32" and same != 16:
                    raise AssertionError(
                        f"tp {model} M={tp} f32 {label}: {same}/16 streams "
                        f"equal to one card's; first differences {diffs}")
                small = snap["small_leaf_bytes"]
                if (snap["jax_param_bytes"] != jax_bytes
                        or snap["param_bytes"] - small
                        != jax_bytes - jax_small
                        or snap["kv_pool_bytes"] * tp
                        != one_snap["kv_pool_bytes"]):
                    raise AssertionError(
                        f"tp {model} M={tp} {label}: param bytes "
                        f"{snap['param_bytes']} (JAX {jax_bytes}, small "
                        f"leaves {small} / {jax_small}), KV bytes "
                        f"{snap['kv_pool_bytes']} x {tp} against one card's "
                        f"{one_snap['kv_pool_bytes']}")
                by_k = {int(k): n
                        for k, n in snap["decode_passes_by_k"].items()}
                passes = sum(by_k.values())
                armed = passes - by_k.get(0, 0)
                layers = get_model(model).num_layers
                decode_v, verify_v = TP_RUN_VARIANTS[label]
                want = {n: 0 for n in snap["decode_launches"]}
                want[decode_v] = layers * by_k.get(0, 0)
                if verify_v is not None:
                    want[verify_v] = layers * armed
                if (by_k.get(0, 0) < 1 or (verify_v is not None
                                           and armed < 1)
                        or snap["decode_launches"] != want
                        or snap["tp_decode_gathers"]
                        != passes * (1 + 4 * layers)):
                    raise AssertionError(
                        f"tp {model} M={tp} {dtype} {label}: rank 0 "
                        f"launches {snap['decode_launches']} and "
                        f"{snap['tp_decode_gathers']} all-gathers over "
                        f"passes {by_k}; expected {want} and "
                        f"{passes * (1 + 4 * layers)}")
                gathers = snap["tp_decode_gathers"] / passes
                launches = {n: c for n, c in snap["decode_launches"].items()
                            if c}
                summary[(model, tp, dtype, label)] = dict(
                    tokens_per_s=snap["decode_tokens_per_sec"],
                    one_tokens_per_s=one_snap["decode_tokens_per_sec"],
                    step_ms=snap["decode_step_p50_s"] * 1e3,
                    one_step_ms=one_snap["decode_step_p50_s"] * 1e3,
                    same=same, gathers=gathers, launches=launches)
                _print(f"[tp-xcard] {model} {dtype} M={tp} {label} "
                       f"({' '.join(extra) or 'dense'}): streams equal to one "
                       f"card's {same}/16"
                       + (f" (first differences {diffs})" if diffs else "")
                       + f", decode tokens/s "
                       f"{snap['decode_tokens_per_sec']:.1f} (one card "
                       f"{one_snap['decode_tokens_per_sec']:.1f}), decode "
                       f"step p50 {snap['decode_step_p50_s'] * 1e3:.2f} ms "
                       f"(one card {one_snap['decode_step_p50_s'] * 1e3:.2f}"
                       f"), TTFT p50 {snap['ttft_p50_s'] * 1e3:.1f} ms p99 "
                       f"{snap['ttft_p99_s'] * 1e3:.1f} ms (one card "
                       f"{one_snap['ttft_p50_s'] * 1e3:.1f} / "
                       f"{one_snap['ttft_p99_s'] * 1e3:.1f}), param bytes a "
                       f"rank {snap['param_bytes']} (JAX {jax_bytes}; "
                       f"LayerNorm leaves whole {small}; one card "
                       f"{one_snap.get('param_bytes', 'whole')}), KV pool "
                       f"bytes a rank {snap['kv_pool_bytes']} (one card "
                       f"{one_snap['kv_pool_bytes']}), all-gathers a decode "
                       f"pass {gathers:.1f}, rank 0 launches {launches} "
                       f"[{smi}]")
    for m, prof in sorted(profiles.items()):
        summary[("profile", m)] = prof
        _print(f"[tp-profile] gpt_small bf16 dense M={m} (8 slots, horizon "
               f"4, {TP_PROFILE_STEPS} steady engine steps, "
               f"{prof['passes']} decode passes; the trace on rank 0 over "
               f"{TP_PROFILE_STEPS} more, {prof['traced_passes']} passes): "
               f"a decode pass {prof['wall_ms']:.3f} ms on the host clock "
               f"untraced, {prof['traced_wall_ms']:.3f} traced; card busy "
               f"{prof['busy_ms']:.3f} ms (idle {prof['idle']:.3f}); NCCL "
               f"kernels {prof['nccl_kernels']:.1f} a pass, "
               f"{prof['nccl_ms']:.3f} ms; other kernels "
               f"{prof['other_ms']:.3f} ms; host in the all-gather calls "
               f"{prof['gather_host_ms']:.3f} ms, blocked on the card "
               f"{prof['wait_host_ms']:.3f} ms; 8 prompts x 8 tokens served "
               f"cold {prof['cold_serve_ms']:.1f} ms, warm "
               f"{prof['warm_serve_ms']:.1f} ms [{smi}]")
    return summary


def _tp_phase(torch, serve_lm, F, da, quantize_kv, rate, smi):
    """Phase 31 (see the module docstring). Returns the kernels line's
    additions: ``per_pass`` (launches a pass on the M = 1 path) and
    ``rows`` (the per-rank-shape checks and times)."""
    t0 = time.perf_counter()
    per_pass = _tp_engine_runs(torch, serve_lm, da, smi)
    rows = _tp_kernel_rows(torch, F, da, quantize_kv, rate, smi)
    cross = _tp_cross_card(torch, serve_lm, smi)
    _print(f"[tp] phase 31 wall {time.perf_counter() - t0:.1f} s [{smi}]")
    return dict(per_pass=per_pass, rows=rows, cross=cross)


def _tp_fields(tp, name):
    """A decode or verify row's phase 31 keys in the kernels line."""
    return {"tp_launches_per_step": tp["per_pass"].get(name),
            "tp_shapes": tp["rows"][name]}


# ------------------------------------------------------------- phase 32


class _Stamped(io.TextIOBase):
    """A text stream that keeps each complete line with the
    ``perf_counter`` time it was written."""

    def __init__(self):
        super().__init__()
        self.lines = []
        self._buf = ""

    def writable(self):
        return True

    def write(self, text):
        self._buf += text
        while "\n" in self._buf:
            line, self._buf = self._buf.split("\n", 1)
            self.lines.append((time.perf_counter(), line))
        return len(text)

    def text(self):
        return "\n".join(line for _, line in self.lines)


def _sh_transcripts(text):
    """``{uid: tokens}`` of the ``req=<uid> tokens=[...]`` lines, raising
    if a uid finished twice."""
    found = re.findall(r"^req=(\S+) tokens=(\[.*\])$", text, re.M)
    uids = [uid for uid, _ in found]
    if len(set(uids)) != len(uids):
        raise AssertionError(f"a uid was served twice: {sorted(uids)}")
    return {uid: json.loads(toks) for uid, toks in found}


def _sh_serve(serve_lm, argv, da, plan=None):
    """``serve_lm.main(argv)`` in this process with its output captured
    (the decode counts zeroed just before and read just after; a fault
    plan of ``PMDT_FAULT_PLAN``'s grammar armed around it): (snapshot,
    transcripts, stdout, stderr, launch counts)."""
    from pytorch_multiprocessing_distributed_tpu_torch.runtime import faults

    out, err = _Stamped(), _Stamped()
    armed = (faults.armed(faults.plan_from_spec(plan)) if plan
             else contextlib.nullcontext())
    _zero_decode_counts(da)
    with armed, contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(err):
        snap = serve_lm.main(argv)
    counts = _decode_counts(da)
    return snap, _sh_transcripts(out.text()), out, err, counts


def _sh_launches(label, snap, counts, decode_v, verify_v):
    """The run's launches held to 12 a plain decode pass of its decode
    variant and 12 an armed pass of its verify variant, none of any
    other, over every engine it built (the snapshot's ``attempts``); the
    snapshot's own count must agree. Returns ``{variant: launches}``."""
    passes, counted = {}, {name: 0 for name in counts}
    for attempt in snap["attempts"]:
        for k, n in attempt["decode_passes_by_k"].items():
            passes[int(k)] = passes.get(int(k), 0) + n
        for name, n in attempt["decode_launches"].items():
            counted[name] += n
    plain = passes.get(0, 0)
    armed = sum(n for k, n in passes.items() if k)
    want = {name: 0 for name in counts}
    want[decode_v] = 12 * plain
    if verify_v is not None:
        want[verify_v] = 12 * armed
    if (counts != want or counted != counts or plain < 1
            or (verify_v is not None and armed < 1)):
        raise AssertionError(
            f"[serve-heal] {label}: launches {counts} (snapshot "
            f"{counted}) over passes {passes}; expected {want}")
    return {n: c for n, c in counts.items() if c}


@contextlib.contextmanager
def _sh_journal_meter(heal):
    """For the block: the wall time of every engine step (the journal's
    write and fsync come after the step's ``decode_step`` metric stops,
    so that metric cannot see them), every ``os.fsync``'s time, and each
    journal's bytes before its compaction. Yields ``{"step_s", "steps",
    "fsync_s", "fsyncs", "bytes"}``."""
    from pytorch_multiprocessing_distributed_tpu_torch.serving import (
        ServingEngine)

    meter = {"step_s": 0.0, "steps": 0, "fsync_s": 0.0, "fsyncs": 0,
             "bytes": 0}
    fsync, close = os.fsync, heal.RequestJournal.close
    step = ServingEngine.step

    def timed_step(self):
        t0 = time.perf_counter()
        try:
            return step(self)
        finally:
            meter["step_s"] += time.perf_counter() - t0
            meter["steps"] += 1

    def timed_fsync(fd):
        t0 = time.perf_counter()
        try:
            return fsync(fd)
        finally:
            meter["fsync_s"] += time.perf_counter() - t0
            meter["fsyncs"] += 1

    def sized_close(self, compact=True):
        if self._fh is not None:
            self._fh.flush()
            meter["bytes"] += os.path.getsize(self.path)
        return close(self, compact)

    os.fsync, heal.RequestJournal.close = timed_fsync, sized_close
    ServingEngine.step = timed_step
    try:
        yield meter
    finally:
        os.fsync, heal.RequestJournal.close = fsync, close
        ServingEngine.step = step


def _sh_reference(serve_lm, da, heal, smi, tmp):
    """(a) the uninterrupted f32 runs with --journal, dense, paged and
    speculative; dense in turns without and with the journal (the
    journal's cost in the same call; the first serve of the process
    warms it up). Returns ``{label: transcripts}``, the launches and the
    journal's numbers."""
    refs, launches, cost = {}, {}, {}
    for label, extra, decode_v, verify_v in SERVE_HEAL_RUNS:
        wal = os.path.join(tmp, f"ref-{label}.jsonl")
        runs = ((("plain", False),) + (("journal", True),
                                         ("plain", False)) * 3
                if label == "dense" else (("journal", True),))
        for name, journal in runs:
            argv = SERVE_HEAL_ARGV + extra
            if journal:
                argv = argv + ["--journal", wal]
            with _sh_journal_meter(heal) as meter:
                snap, got, _, _, counts = _sh_serve(serve_lm, argv, da)
            if len(got) != 16 or snap["requests_completed"] != 16:
                raise AssertionError(
                    f"[serve-heal] (a) {label} {name}: {len(got)}/16 "
                    "requests finished")
            if label in refs and got != refs[label]:
                raise AssertionError(
                    f"[serve-heal] (a) {label}: the transcripts with and "
                    "without --journal differ")
            refs[label] = got
            launches[label] = _sh_launches(f"(a) {label}", snap, counts,
                                           decode_v, verify_v)
            if journal:
                if os.path.getsize(wal) != 0:
                    raise AssertionError(
                        f"[serve-heal] (a) {label}: the journal holds "
                        f"{os.path.getsize(wal)} bytes after the clean "
                        "drain")
            step_ms = meter["step_s"] * 1e3 / meter["steps"]
            tps = snap["tokens_generated"] / meter["step_s"]
            if label == "dense":
                cost.setdefault("runs", []).append((name, step_ms, tps))
                if journal and "fsync_ms_per_step" not in cost:
                    cost["fsync_ms_per_step"] = (
                        meter["fsync_s"] * 1e3 / meter["steps"])
                    cost["fsync_ms_per_call"] = (
                        meter["fsync_s"] * 1e3 / max(1, meter["fsyncs"]))
                    cost["fsyncs"] = meter["fsyncs"]
                    cost["steps"] = meter["steps"]
                    cost["bytes_per_token"] = (
                        meter["bytes"] / snap["tokens_generated"])
                    cost["bytes"] = meter["bytes"]
            _print(f"[serve-heal] (a) {label} {name}: gpt_small f32 16 "
                   f"requests x 32 tokens, 8 slots, horizon 4: 16/16 "
                   f"done, passes by k {snap['decode_passes_by_k']}, "
                   f"launches {launches[label]} (12 a pass), engine step "
                   f"{step_ms:.3f} ms ({meter['steps']} steps), tokens/s "
                   f"{tps:.1f} over the steps' wall, decode_step metric "
                   f"{snap['decode_step_avg_s'] * 1e3:.3f} ms"
                   + (", journal empty after the drain" if journal
                      else "") + f" [{smi}]")
    for name in ("plain", "journal"):
        # the process's first serve (a warm-up) left out
        runs = [r for r in cost["runs"][1:] if r[0] == name]
        cost[f"{name}_step_ms"] = statistics.median(r[1] for r in runs)
        cost[f"{name}_tokens_per_s"] = statistics.median(r[2] for r in runs)
    _print(f"[serve-heal] journal cost (dense f32, same call, in turns; "
           f"the first is the process's first serve): engine step ms "
           + ", ".join(f"{n} {ms:.3f}" for n, ms, _ in cost["runs"])
           + "; tokens/s " + ", ".join(f"{n} {t:.1f}"
                                      for n, _, t in cost["runs"])
           + f"; medians after the first: step {cost['journal_step_ms']:.3f}"
           f" ms with the journal, {cost['plain_step_ms']:.3f} without, "
           f"tokens/s {cost['journal_tokens_per_s']:.1f} and "
           f"{cost['plain_tokens_per_s']:.1f}"
           + f"; fsync {cost['fsync_ms_per_step']:.3f} ms an engine step "
           f"({cost['fsyncs']} fsyncs in {cost['steps']} steps, 16 of them "
           f"at admission and 2 at the compaction, "
           f"{cost['fsync_ms_per_call']:.3f} ms each), "
           f"journal {cost['bytes']} bytes before compaction = "
           f"{cost['bytes_per_token']:.1f} bytes a token [{smi}]")
    return refs, launches, cost


@contextlib.contextmanager
def _sh_build_memory(serve_lm):
    """For the block: the card's allocated bytes just before each engine
    ``serve_lm`` builds (a restart must not hold the crashed engine's
    KV pool beside the new one)."""
    import torch

    real, seen = serve_lm.ServingEngine, []

    def build(*args, **kwargs):
        torch.cuda.synchronize()
        seen.append(torch.cuda.memory_allocated())
        return real(*args, **kwargs)

    serve_lm.ServingEngine = build
    try:
        yield seen
    finally:
        serve_lm.ServingEngine = real


def _sh_restart(serve_lm, da, smi, tmp, refs, dtype="float32"):
    """(b) and (f): the fatal at the decode dispatch under --max_restarts
    2 --journal, in process. f32: each run of SERVE_HEAL_RUNS restarts
    once and is token-exact with (a). bf16 (``refs`` its own reference):
    the dense run's exact streams counted, a divergence named. Returns
    ``{label: result}``."""
    out = {}
    runs = (SERVE_HEAL_RUNS if dtype == "float32"
            else SERVE_HEAL_RUNS[:1])
    for label, extra, decode_v, verify_v in runs:
        wal = os.path.join(tmp, f"restart-{label}-{dtype}.jsonl")
        argv = (SERVE_HEAL_ARGV + extra + SERVE_HEAL_RESTART
                + ["--journal", wal])
        argv[argv.index("float32")] = dtype
        if dtype == "float32":
            with _sh_build_memory(serve_lm) as built:
                snap, got, sout, serr, counts = _sh_serve(
                    serve_lm, argv, da, SERVE_HEAL_FATAL)
        else:
            from pytorch_multiprocessing_distributed_tpu_torch.runtime import (
                heal)

            try:
                with _sh_build_memory(serve_lm) as built:
                    snap, got, sout, serr, counts = _sh_serve(
                        serve_lm, argv, da, SERVE_HEAL_FATAL)
            except heal.RestartBudgetExhausted as e:
                if "diverged" not in str(e):
                    raise
                out[label] = dict(exact=None, error=str(e))
                _print(f"[serve-heal] (f) {label} bf16: the replay "
                       f"diverged, named: {type(e).__name__}: {e} [{smi}]")
                continue
        if snap["restarts"] != 1:
            raise AssertionError(f"[serve-heal] {label} {dtype}: "
                                 f"{snap['restarts']} restarts, expected 1")
        # the crashed engine's pool freed before the rebuilt one's
        if len(built) != 2 or built[1] - built[0] >= snap["kv_pool_bytes"]:
            raise AssertionError(
                f"[serve-heal] {label} {dtype}: allocated bytes before "
                f"each engine {built}, the pool {snap['kv_pool_bytes']}: "
                "the crashed engine's pool was held at the rebuild")
        rebuilt = [t for t, line in sout.lines
                   if line.startswith("graftheal: restart 1: engine rebuilt")]
        fatal = [t for t, line in serr.lines
                 if line.startswith("graftheal: restart 1/")]
        if len(rebuilt) != 1 or len(fatal) != 1:
            raise AssertionError(f"[serve-heal] {label} {dtype}: restart "
                                 f"lines {len(fatal)} / {len(rebuilt)}")
        first = min(t for t, line in sout.lines
                    if t >= rebuilt[0] and line.startswith("req="))
        exact = sum(got.get(uid) == toks for uid, toks in refs[label].items())
        result = dict(exact=exact, restart_s=first - fatal[0],
                      redelivered=snap["requests_redelivered"],
                      launches=_sh_launches(f"{label} {dtype}", snap,
                                            counts, decode_v, verify_v))
        if dtype == "float32" and (exact != 16 or len(got) != 16):
            raise AssertionError(
                f"[serve-heal] (b) {label}: {exact}/16 streams token-exact "
                f"with (a) after the restart ({len(got)} finished)")
        if os.path.getsize(wal) != 0:
            raise AssertionError(f"[serve-heal] {label} {dtype}: journal "
                                 "not empty after the drain")
        out[label] = result
        _print(f"[serve-heal] ({'b' if dtype == 'float32' else 'f'}) "
               f"{label} {dtype}: fatal at serving.decode_dispatch hit 7, "
               f"1 restart, {snap['requests_redelivered']} requests "
               f"redelivered, {exact}/16 streams token-exact with the "
               f"uninterrupted run, passes by k (each engine) "
               f"{[a['decode_passes_by_k'] for a in snap['attempts']]}, "
               f"launches "
               f"{result['launches']} (12 a pass), allocated bytes "
               f"before each engine {built} (pool {snap['kv_pool_bytes']}), "
               f"fatal to the rebuilt "
               f"engine's first token {result['restart_s']:.3f} s [{smi}]")
    return out


def _sh_child(argv, env):
    return subprocess.Popen(
        [sys.executable, "-u", "-c", SERVE_HEAL_CHILD, *argv],
        cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _sh_stream(proc, stop_at, sig, timeout_s=HEAL_CHILD_TIMEOUT):
    """``proc``'s stdout lines with their arrival times; ``sig`` is sent
    SERVE_HEAL_SIGNAL_DELAY_S after the ``stop_at``-th token line (None:
    read to the end). Returns (lines, its exit code, its stderr, the
    time the signal was sent)."""
    lines, toks, sent = [], 0, None
    for line in _lines_until(proc, time.monotonic() + timeout_s):
        lines.append((time.perf_counter(), line.rstrip("\n")))
        if line.startswith("req=") and " tok=" in line:
            toks += 1
            if sig is not None and toks == stop_at:
                time.sleep(SERVE_HEAL_SIGNAL_DELAY_S)
                sent = time.perf_counter()
                proc.send_signal(sig)
    try:
        rc = proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return lines, rc, proc.stderr.read(), sent


def _sh_kill(smi, tmp, ref):
    """(c) SIGKILL of a serve_lm process at half its tokens, then the
    same command again: the two transcripts together are (a)'s, no uid
    finished in both, and the journal is empty after the re-run. A
    request the killed process journaled done (the step's fsync) but
    had not printed yet (the kill landed between the two) is read from
    the journal as the kill left it, and counted."""
    from pytorch_multiprocessing_distributed_tpu_torch.runtime import heal

    wal = os.path.join(tmp, "kill.jsonl")
    metrics = os.path.join(tmp, "kill-metrics.json")
    argv = SERVE_HEAL_ARGV + ["--journal", wal, "--metrics_out", metrics]
    env = _heal_env()
    first, rc, _, _ = _sh_stream(_sh_child(argv, env), SERVE_HEAL_KILL_AT,
                                 signal.SIGKILL)
    if rc != -signal.SIGKILL:
        raise AssertionError(f"[serve-heal] (c) the first run exited {rc}, "
                             "not by the SIGKILL")
    before = _sh_transcripts("\n".join(line for _, line in first))
    unprinted = {e.uid: e.tokens for e in heal.load_journal_entries(wal)
                 if e.done and e.uid not in before}
    t0 = time.perf_counter()
    second, rc, err, _ = _sh_stream(_sh_child(argv, env), None, None)
    if rc != 0:
        raise AssertionError(f"[serve-heal] (c) the re-run exited {rc}:\n"
                             f"{err[-3000:]}")
    after = _sh_transcripts("\n".join(line for _, line in second))
    both = set(before) & set(after)
    served_again = {line.split()[0][4:] for _, line in second
                    if line.startswith("req=")} & set(before)
    if both or served_again:
        raise AssertionError(f"[serve-heal] (c) uids served in both runs: "
                             f"{sorted(both | served_again)}")
    if set(unprinted) & set(after) or {**before, **unprinted,
                                       **after} != ref:
        raise AssertionError("[serve-heal] (c) the two runs' transcripts "
                             "are not the uninterrupted run's")
    if os.path.getsize(wal) != 0:
        raise AssertionError("[serve-heal] (c) journal not empty after "
                             "the re-run")
    with open(metrics) as f:
        snap = json.load(f)
    redelivered = snap["requests_redelivered"]
    first_tok = min(t for t, line in second if line.startswith("req="))
    _print(f"[serve-heal] (c) SIGKILL after {SERVE_HEAL_KILL_AT} of 512 "
           f"tokens ({len(before)} requests finished, {len(unprinted)} "
           f"more journaled done but not yet printed), the same command "
           f"again: {redelivered} redelivered, {len(after)} finished, the "
           f"union token-exact with (a), no uid served twice; re-run start "
           f"to its first redelivered token {first_tok - t0:.3f} s "
           f"(process start included) [{smi}]")
    return dict(first_token_s=first_tok - t0, redelivered=redelivered)


def _sh_term(smi, tmp, ref):
    """(d) SIGTERM with --drain_deadline_s: exit 0, every admitted request
    finished token-exact or failed named (DeadlineExceeded, reason
    drain), and terminal in the journal (empty after the compaction)."""
    wal = os.path.join(tmp, "term.jsonl")
    metrics = os.path.join(tmp, "term-metrics.json")
    argv = SERVE_HEAL_ARGV + ["--journal", wal, "--metrics_out", metrics,
                              "--drain_deadline_s", str(SERVE_HEAL_DRAIN_S)]
    proc = _sh_child(argv, _heal_env())
    lines, rc, err, term_t = _sh_stream(proc, SERVE_HEAL_TERM_AT,
                                        signal.SIGTERM)
    exit_s = time.perf_counter() - term_t
    if rc != 0:
        raise AssertionError(f"[serve-heal] (d) exit {rc} after SIGTERM:\n"
                             f"{err[-3000:]}")
    done = _sh_transcripts("\n".join(line for _, line in lines))
    failed = re.findall(r"^failed: req=(\S+) reason=(\S+) (\w+):", err,
                        re.M)
    with open(metrics) as f:
        snap = json.load(f)
    wrong = {uid: toks for uid, toks in done.items() if ref[uid] != toks}
    if (wrong or any(r != "drain" or e != "DeadlineExceeded"
                     for _, r, e in failed)
            or snap["requests_failed"] != len(failed)
            or snap["requests_completed"] != len(done)
            or len(done) + len(failed) != 16):
        raise AssertionError(
            f"[serve-heal] (d) finished {sorted(done)} (not exact: "
            f"{sorted(wrong)}), failed {failed}, snapshot completed "
            f"{snap['requests_completed']} failed {snap['requests_failed']}")
    if os.path.getsize(wal) != 0:
        raise AssertionError("[serve-heal] (d) an admitted request is not "
                             "terminal in the journal")
    _print(f"[serve-heal] (d) SIGTERM after {SERVE_HEAL_TERM_AT} tokens, "
           f"--drain_deadline_s {SERVE_HEAL_DRAIN_S}: exit 0, {len(done)} "
           f"finished token-exact, {len(failed)} failed named "
           f"DeadlineExceeded (reason drain), journal empty; the drain "
           f"{snap['drain_s']:.3f} s, SIGTERM to exit {exit_s:.3f} s [{smi}]")
    return dict(drain_s=snap["drain_s"], exit_s=exit_s, done=len(done),
                failed=len(failed))


def _sh_engine(torch, serve_lm, smi):
    """(e) the engine API on gpt_small f32 (8 requests, 8 slots, horizon
    4): a transient error:2 at the dispatch (2 retries, the horizon
    collapsed in the cooldown, streams exact), deadlines (failed named,
    the rest exact), a hung readback under the watchdog."""
    from pytorch_multiprocessing_distributed_tpu_torch.models import (
        get_model)
    from pytorch_multiprocessing_distributed_tpu_torch.runtime.faults import (
        DeadlineExceeded, FaultPlan, FaultRule, FaultTimeout, armed)
    from pytorch_multiprocessing_distributed_tpu_torch.serving import (
        ServingEngine, init_params)

    model = get_model("gpt_small", dtype=torch.float32)
    model.load_state_dict(init_params(model, 0, "cuda"), assign=True)
    args = serve_lm.build_parser().parse_args(SERVE_HEAL_ARGV)
    requests = list(serve_lm._load_requests(args, model.vocab_size, []))[:8]
    kw = dict(max_slots=8, decode_horizon=4)
    base = [r.tokens for r in ServingEngine(model, **kw).serve(requests)]

    engine = ServingEngine(model, **kw)
    plan = FaultPlan([FaultRule("serving.decode_dispatch", "error",
                                times=2, after=3)])
    with armed(plan):
        got = [r.tokens for r in engine.serve(requests)]
    snap = engine.metrics.snapshot()
    if (plan.triggered() != 2 or snap["dispatch_retries"] != 2
            or snap["horizon_collapses"] < 1 or got != base):
        raise AssertionError(
            f"[serve-heal] (e) transient: {plan.triggered()} faults, "
            f"{snap['dispatch_retries']} retries, "
            f"{snap['horizon_collapses']} collapses, streams exact "
            f"{got == base}")
    _print(f"[serve-heal] (e) error:2 at serving.decode_dispatch (hit 4): "
           f"{snap['dispatch_retries']} retries, "
           f"{snap['horizon_collapses']} horizon collapses, 8/8 streams "
           f"exact with the fault-free engine [{smi}]")

    engine = ServingEngine(model, **kw)
    doomed = (1, 4, 6)
    reqs = []
    for i, (prompt, max_new) in enumerate(requests):
        if i in doomed:
            reqs.append(engine.submit(prompt, max_new, deadline_s=0.0))
        elif i == 7:
            reqs.append(engine.submit(
                prompt, 512, deadline_s=SERVE_HEAL_DEADLINE_RUNNING_S))
        else:
            reqs.append(engine.submit(prompt, max_new))
    for _ in engine.run():
        pass
    for i, r in enumerate(reqs):
        if i in doomed or i == 7:
            ok = (r.state == "failed" and r.finish_reason == "deadline"
                  and isinstance(r.error, DeadlineExceeded)
                  and (not r.tokens if i in doomed else
                       0 < len(r.tokens) < 512
                       and r.tokens[:32] == base[7][:len(r.tokens)]))
        else:
            ok = r.state == "done" and r.tokens == base[i]
        if not ok:
            raise AssertionError(
                f"[serve-heal] (e) deadline: request {i} {r.state} "
                f"{r.finish_reason} {len(r.tokens)} tokens")
    _print(f"[serve-heal] (e) deadlines: requests {list(doomed)} "
           f"(deadline 0 s) failed DeadlineExceeded in the queue, request 7 "
           f"(512 tokens, {SERVE_HEAL_DEADLINE_RUNNING_S} s) evicted "
           f"running after {len(reqs[7].tokens)} tokens, the other 4 "
           f"streams exact [{smi}]")

    engine = ServingEngine(model, readback_timeout_s=SERVE_HEAL_WATCHDOG_S,
                           **kw)
    plan = FaultPlan([FaultRule("serving.horizon_readback", "hang",
                                hang_s=SERVE_HEAL_HANG_S)])
    raised = None
    t0 = time.perf_counter()
    with armed(plan):
        try:
            engine.serve(requests)
        except FaultTimeout as e:
            raised = e
    wall = time.perf_counter() - t0
    if (raised is None or engine.metrics.watchdog_trips != 1
            or not engine.health.dead):
        raise AssertionError(
            f"[serve-heal] (e) watchdog: raised {raised!r}, trips "
            f"{engine.metrics.watchdog_trips}, health "
            f"{engine.health.state}")
    _print(f"[serve-heal] (e) hang {SERVE_HEAL_HANG_S} s at "
           f"serving.horizon_readback under readback_timeout_s "
           f"{SERVE_HEAL_WATCHDOG_S}: FaultTimeout, 1 watchdog trip, engine "
           f"DEAD, {wall:.3f} s from the serve's start [{smi}]")
    time.sleep(SERVE_HEAL_HANG_S)  # the hung readback thread ends
    del model, engine


def _sh_ckpt(torch, serve_lm, train_lm, da, smi, tmp):
    """(g) train_lm saves (msgpack: model_1.pth; orbax: epochs 1 and 2),
    serve_lm --ckpt serves each (--ckpt_epoch 1 pins one), and each
    transcript equals an engine on the same params read straight from
    the checkpoint into memory."""
    from pytorch_multiprocessing_distributed_tpu_torch.models import (
        get_model)
    from pytorch_multiprocessing_distributed_tpu_torch.serving import (
        ServingEngine)
    from pytorch_multiprocessing_distributed_tpu_torch.train.orbax_ckpt import (
        OrbaxCheckpointer)

    runs = {}
    for backend, epochs in (("msgpack", 1), ("orbax", 2)):
        path = os.path.join(tmp, f"train-{backend}")
        t0 = time.perf_counter()
        train_lm.main(HEAL_LM_ARGV + [
            "--epochs", str(epochs), "--save_every", "1", "--ckpt_backend",
            backend, "--save_path", path])
        runs[backend] = (path, time.perf_counter() - t0)
    model = get_model("gpt_small", dtype=torch.float32)
    args = serve_lm.build_parser().parse_args(
        SERVE_HEAL_CKPT_ARGV + ["--random_init"])
    requests = list(serve_lm._load_requests(args, model.vocab_size, []))
    cases = (("msgpack", ["--ckpt", os.path.join(runs["msgpack"][0],
                                                 "model_1.pth")], 1),
             ("orbax", ["--ckpt", runs["orbax"][0]], 2),
             ("orbax", ["--ckpt", runs["orbax"][0], "--ckpt_epoch", "1"], 1))
    for backend, flags, epoch in cases:
        snap, got, _, _, counts = _sh_serve(
            serve_lm, SERVE_HEAL_CKPT_ARGV + flags, da)
        if backend == "msgpack":
            payload = torch.load(flags[1], map_location="cpu",
                                 weights_only=True)
        else:
            payload = OrbaxCheckpointer(runs["orbax"][0]).load_payload(epoch)
        params = {k[len("params/"):].replace("/", "."): v.to("cuda")
                  for k, v in payload.items() if k.startswith("params/")}
        model = get_model("gpt_small", dtype=torch.float32)
        model.load_state_dict(params, assign=True)
        mem = ServingEngine(model, max_slots=8, decode_horizon=4).serve(
            requests)
        want = {f"src-{i}": r.tokens for i, r in enumerate(mem)}
        if got != want:
            raise AssertionError(
                f"[serve-heal] (g) {backend} epoch {epoch}: serve_lm --ckpt "
                "differs from the in-memory params")
        _print(f"[serve-heal] (g) train_lm --ckpt_backend {backend} "
               f"({runs[backend][1]:.1f} s) -> serve_lm "
               f"{' '.join(flags[2:]) or '(latest)'} epoch {epoch}: 8 "
               f"requests x 16 tokens token-exact with the same params in "
               f"memory, launches { {n: c for n, c in counts.items() if c} }"
               f" [{smi}]")


def _serve_heal_phase(torch, serve_lm, train_lm, da, smi):
    """Phase 32 (see the module docstring). Returns the kernels line's
    additions: each decode and verify row's launches in (a) and (b)."""
    from pytorch_multiprocessing_distributed_tpu_torch.runtime import heal

    t0 = time.perf_counter()
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with tempfile.TemporaryDirectory() as tmp:
            refs, ref_launches, cost = _sh_reference(serve_lm, da, heal, smi,
                                                     tmp)
            restart = _sh_restart(serve_lm, da, smi, tmp, refs)
            kill = _sh_kill(smi, tmp, refs["dense"])
            term = _sh_term(smi, tmp, refs["dense"])
            _sh_engine(torch, serve_lm, smi)
            argv = SERVE_HEAL_ARGV + ["--journal",
                                      os.path.join(tmp, "ref-bf16.jsonl")]
            argv[argv.index("float32")] = "bfloat16"
            _, bf16_ref, _, _, _ = _sh_serve(serve_lm, argv, da)
            bf16 = _sh_restart(serve_lm, da, smi, tmp, {"dense": bf16_ref},
                               dtype="bfloat16")["dense"]
            _print(f"[serve-heal] (f) bf16 dense restart: "
                   + (f"{bf16['exact']}/16 streams token-exact with the "
                      "uninterrupted bf16 run" if bf16["exact"] is not None
                      else "the replay diverged and stopped named")
                   + f" [{smi}]")
            _sh_ckpt(torch, serve_lm, train_lm, da, smi, tmp)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    launches = {}
    for label, _, decode_v, verify_v in SERVE_HEAL_RUNS:
        for name in (decode_v, verify_v):
            if name is not None:
                entry = launches.setdefault(name, {})
                entry[f"reference_{label}"] = ref_launches[label][name]
                entry[f"restart_{label}"] = restart[label]["launches"][name]
    _print(f"[serve-heal] phase 32 wall {time.perf_counter() - t0:.1f} s "
           f"[{smi}]")
    return dict(launches=launches, cost=cost, restart=restart, kill=kill,
                term=term, bf16=bf16)


def _serve_heal_fields(sh, name):
    """A decode or verify row's phase 32 keys in the kernels line."""
    return {"serve_heal_launches": sh["launches"].get(name)}


# phase 33: observability. Phase 4's serve and phase 7's/10's trainers,
# disarmed and armed (--trace_out, --events_out, --stats_port), with
# torch.cuda.set_sync_debug_mode("warn") counting the host syncs; the
# armed serve's routes read by a thread while it serves
SCOPE_SERVE_ARGV = ["--model", "gpt_small", "--random_init", "--dtype",
                    "bfloat16", "--max_slots", "8", "--synthetic", "16",
                    "--max_new_tokens", "32", "--decode_horizon", "4",
                    "--seed", "0", "--quiet"]
# (layout, extra flags, row's wrapper, runs): dense in turns after a
# warm-up, paged (row 2) once each way
SCOPE_SERVE_RUNS = (
    ("dense", [], "decode_attention",
     ("warm-up",) + ("disarmed", "armed") * 3),
    ("paged", ["--kv_layout", "paged"], "paged_decode_attention",
     ("disarmed", "armed")))
SCOPE_TRAIN_STEPS = 4
SCOPE_LM_ARGV = ["--model", "gpt_small", "--batch_size", "8", "--seq_len",
                 "1024", "--epochs", "1", "--corpus_tokens",
                 str(SCOPE_TRAIN_STEPS * 8 * 1024), "--lr", TRAIN_LR,
                 "--seed", "0", "--dtype", "bfloat16"]
SCOPE_IMAGE_SYNTH = "1024"  # 16 steps of 64 and 4 eval batches
SCOPE_IMAGE_ARGV = ["--device", "cuda", "--world_size", "1", "--model",
                    "res", "--synthetic", "--optimizer", "sgd_fused",
                    "--batch_size", "64", "--epochs", "1", "--seed", "0",
                    "--print-freq", "4"]
SCOPE_ROUTES = ("/metrics", "/snapshot.json", "/events.json", "/healthz")
# [fleet-xcard]: train_lm --parallel dp on four ranks under PMDT_FLEET,
# rank FLEET_SLOW slowed by a hang at every store write (its arrival
# stamps), gate and stamp at every step
FLEET_RANKS, FLEET_SLOW, FLEET_HANG_S = 4, 2, 0.05
FLEET_RUN = "chip-smoke-33"


def _disarm_telemetry():
    """What a CLI's flags armed in this process: the scope, the ledger,
    the goodput ledger."""
    from pytorch_multiprocessing_distributed_tpu_torch.runtime import (
        fleet, hbm, scope)

    scope.disarm()
    hbm.disarm()
    fleet.disarm_goodput()


def _counting_syncs(torch, fn):
    """``fn()`` with ``torch.cuda.set_sync_debug_mode("warn")``: its
    result and the synchronizing CUDA calls it made (one warning each)."""
    import warnings

    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode(prev)
    return out, sum("synchroniz" in str(w.message) for w in caught)


def _scrape_while_up(port, got, stop):
    """Wait for ``/healthz`` to answer 200, then GET every route once
    into ``got`` (code, body)."""
    import urllib.error
    import urllib.request

    base = f"http://127.0.0.1:{port}"
    while not stop.is_set():
        try:
            with urllib.request.urlopen(base + "/healthz",
                                        timeout=2) as resp:
                if resp.status != 200:
                    continue
        except OSError:
            time.sleep(0.005)
            continue
        for route in SCOPE_ROUTES:
            try:
                with urllib.request.urlopen(base + route, timeout=5) as r:
                    got[route] = (r.status, r.read().decode())
            except urllib.error.HTTPError as e:
                got[route] = (e.code, "")
        return


def _scope_serve(torch, serve_lm, da, smi, tmp):
    """[scope-serve]: phase 4's serve disarmed and armed in turns (dense
    three times each after a warm-up, paged once each): tokens/s, the
    row's launches and the sync warnings of each, equal armed and
    disarmed; the armed runs' routes, trace and events. Returns the
    runs by layout."""
    out = {}
    for layout, extra, row, labels in SCOPE_SERVE_RUNS:
        kernel = getattr(da, row)
        runs = []
        for label in labels:
            runs.append(_scope_serve_run(torch, serve_lm, kernel, smi, tmp,
                                         layout, extra, label))
        counted = [r for r in runs if r["label"] != "warm-up"]
        if len({r["syncs"] for r in counted}) != 1 or len(
                {r["launches"] / r["steps"] for r in counted}) != 1:
            raise AssertionError(
                f"[scope-serve] {layout}: armed and disarmed serves "
                "differ: " + ", ".join(
                    f"{r['label']} syncs {r['syncs']} launches "
                    f"{r['launches']}" for r in counted))
        out[layout] = counted
    return out


def _scope_serve_run(torch, serve_lm, kernel, smi, tmp, layout, extra,
                     label):
    """One serve of [scope-serve] through ``serve_lm.main``."""
    armed = label == "armed"
    n = len(os.listdir(tmp))
    argv = SCOPE_SERVE_ARGV + extra + [
        "--metrics_out", os.path.join(tmp, f"m{n}.json")]
    got, stop = {}, threading.Event()
    if armed:
        port = _store_port()
        trace = os.path.join(tmp, f"t{n}.json")
        events = os.path.join(tmp, f"e{n}.jsonl")
        argv += ["--trace_out", trace, "--events_out", events,
                 "--stats_port", str(port)]
        scraper = threading.Thread(target=_scrape_while_up,
                                   args=(port, got, stop), daemon=True)
        scraper.start()
    kernel.launches = 0
    try:
        snap, syncs = _counting_syncs(torch, lambda: serve_lm.main(argv))
    finally:
        stop.set()
        _disarm_telemetry()
    launches = kernel.launches
    steps = round(snap["decode_horizon_avg"] * snap["decode_dispatches"])
    if snap["requests_completed"] != 16 or launches != 12 * steps:
        raise AssertionError(
            f"[scope-serve] {layout} {label}: served "
            f"{snap['requests_completed']}/16, {kernel.__name__} launched "
            f"{launches} times over {steps} steps (12 a step)")
    run = dict(label=label, tok_s=snap["decode_tokens_per_sec"],
               launches=launches, steps=steps, syncs=syncs,
               dispatches=snap["decode_dispatches"])
    if armed:
        scraper.join(5)
        _check_scope_serve(run, got, trace, events)
    _print(f"[scope-serve] {layout} {label}: decode tokens/s "
           f"{run['tok_s']:.1f}, decode steps {steps}, {kernel.__name__} "
           f"launches {launches} (12 a step), sync warnings {syncs}"
           + (f", trace {run['events']} events {run['trace_bytes']} "
              f"bytes (JSONL {run['jsonl_bytes']} bytes), /metrics "
              f"{run['metrics_lines']} lines, /events.json "
              f"{run['scraped_events']} events, /healthz 200 ready"
              if armed else "") + f" [{smi}]")
    return run


def _check_scope_serve(run, got, trace, events):
    """An armed serve's routes (read while it served) and its trace."""
    codes = {r: got.get(r, (None,))[0] for r in SCOPE_ROUTES}
    if set(codes.values()) != {200}:
        raise AssertionError(
            f"[scope-serve] routes answered {codes} while serving")
    health = json.loads(got["/healthz"][1])
    live = json.loads(got["/snapshot.json"][1])
    if health["state"] != "ready" or not any(
            k.startswith("hbm_") for k in live) or "goodput_frac" not in live:
        raise AssertionError(
            f"[scope-serve] /healthz {health}, /snapshot.json keys "
            f"{sorted(live)[:8]}...")
    with open(trace) as f:
        doc = json.load(f)
    names = collections.Counter(e["name"] for e in doc["traceEvents"])
    uids = {f"src-{i}" for i in range(16)}
    for name in ("request.submit", "request.admit", "request.done"):
        seen = {e["args"]["req"] for e in doc["traceEvents"]
                if e["name"] == name}
        if seen != uids:
            raise AssertionError(
                f"[scope-serve] {name} for {sorted(seen)}, not the 16 uids")
    if not (names["decode.dispatch"] == names["decode.drain"]
            == run["dispatches"]):
        raise AssertionError(
            f"[scope-serve] {names['decode.dispatch']} dispatch and "
            f"{names['decode.drain']} drain events over "
            f"{run['dispatches']} dispatches")
    run.update(events=len(doc["traceEvents"]),
               trace_bytes=os.path.getsize(trace),
               jsonl_bytes=os.path.getsize(events),
               metrics_lines=got["/metrics"][1].count("\n"),
               scraped_events=len(json.loads(got["/events.json"][1])))


def _scope_flight(serve_lm, smi, tmp):
    """[scope-flight]: a fatal at the 4th decode dispatch under
    ``--flight_path``: the CLI raises it (as JAX's) and the dump ends in
    ``engine.fatal``."""
    from pytorch_multiprocessing_distributed_tpu_torch.runtime import faults

    path = os.path.join(tmp, "flight.jsonl")
    plan = faults.plan_from_spec("serving.decode_dispatch=fatal:1:3")
    raised = None
    with faults.armed(plan):
        try:
            serve_lm.main(SCOPE_SERVE_ARGV + ["--flight_path", path])
        except faults.GraftFaultError as e:
            raised = e
        finally:
            _disarm_telemetry()
    gc.collect()
    if raised is None:
        raise AssertionError("[scope-flight] the fatal did not propagate")
    if not os.path.exists(path):
        raise AssertionError("[scope-flight] the fatal left no dump")
    with open(path) as f:
        lines = [json.loads(line) for line in f]
    if lines[-1]["name"] != "engine.fatal":
        raise AssertionError(
            f"[scope-flight] the dump ends in {lines[-1]['name']}")
    _print(f"[scope-flight] serving.decode_dispatch=fatal:1:3 -> "
           f"{type(raised).__name__}; flight dump {len(lines) - 1} events, "
           f"reason {lines[0]['graftscope_flight']!r}, last "
           f"{lines[-1]['name']} ({lines[-1].get('error')}) [{smi}]")


def _scope_hbm(torch, smi):
    """[hbm]: the ledger's entries for phase 4's engine and for a
    gpt_small bf16 train_lm state, beside torch.cuda.memory_allocated()
    over the same construction."""
    from pytorch_multiprocessing_distributed_tpu_torch.models import (
        get_model)
    from pytorch_multiprocessing_distributed_tpu_torch.runtime import hbm
    from pytorch_multiprocessing_distributed_tpu_torch.serving import (
        ServingEngine, init_params)
    from pytorch_multiprocessing_distributed_tpu_torch.train import (
        create_lm_train_state)
    from pytorch_multiprocessing_distributed_tpu_torch.train.step import (
        register_state_hbm)

    out = {}
    for what in ("engine", "train_lm state"):
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        with hbm.scoped_ledger() as ledger:
            model = get_model("gpt_small", dtype=torch.bfloat16)
            params = init_params(model, 0, "cuda")
            if what == "engine":
                model.load_state_dict(params, assign=True)
                del params
                held = ServingEngine(model, max_slots=8, decode_horizon=4)
            else:
                held = create_lm_train_state(model, params)
                del params
                register_state_hbm(held)
            torch.cuda.synchronize()
            alloc = torch.cuda.memory_allocated() - base
        registered = ledger.total_bytes
        entries = {k: b for k, (_, b, _) in sorted(ledger.entries().items())}
        del held, model
        if not 0 < registered <= alloc:
            raise AssertionError(
                f"[hbm] {what}: registered {registered} bytes, "
                f"memory_allocated grew {alloc}")
        out[what] = dict(registered=registered, allocated=alloc,
                         entries=entries)
        _print(f"[hbm] {what}: ledger {registered} bytes {entries}; "
               f"memory_allocated +{alloc} bytes; gap {alloc - registered} "
               f"bytes ({(alloc - registered) / alloc:.4f} of allocated) "
               f"[{smi}]")
    gc.collect()
    return out


def _scope_train(torch, train_lm, image_main, fa, fused_sgd_, smi, tmp):
    """[scope-train]: train_lm gpt_small bf16 for 4 steps and main
    ResNet-18 --optimizer sgd_fused, each disarmed, with --trace_out,
    and disarmed again: rows 5-7 launch 12 a step and row 8 once a step
    in every run, and the sync warnings of the armed run equal the
    disarmed runs'."""
    out = {}
    prev_synth = os.environ.get("PMDT_SMALL_SYNTH")
    os.environ["PMDT_SMALL_SYNTH"] = SCOPE_IMAGE_SYNTH
    try:
        for cli, argv in (("train_lm", SCOPE_LM_ARGV),
                          ("main", SCOPE_IMAGE_ARGV)):
            runs = []
            for label in ("disarmed", "armed", "disarmed"):
                save = os.path.join(tmp, f"{cli}-{len(runs)}")
                args = argv + ["--save_path", save]
                if label == "armed":
                    trace = os.path.join(tmp, f"{cli}-{len(runs)}.json")
                    args += ["--trace_out", trace]
                for name in FLASH_PRODUCTS:
                    getattr(fa, name).launches = 0
                fused_sgd_.launches = 0
                run_main = (train_lm.main if cli == "train_lm"
                            else image_main.main)
                try:
                    summary, syncs = _counting_syncs(
                        torch, lambda: run_main(args))
                finally:
                    _disarm_telemetry()
                steps = summary["steps"]
                launches = ({n: getattr(fa, n).launches
                             for n in FLASH_PRODUCTS}
                            if cli == "train_lm"
                            else {"fused_sgd": fused_sgd_.launches})
                want = ({n: 12 * steps for n in FLASH_PRODUCTS}
                        if cli == "train_lm" else {"fused_sgd": steps})
                if launches != want or (cli == "train_lm"
                                        and steps != SCOPE_TRAIN_STEPS):
                    raise AssertionError(
                        f"[scope-train] {cli} {label}: {steps} steps, "
                        f"launches {launches}, expected {want}")
                run = dict(label=label, steps=steps, launches=launches,
                           syncs=syncs,
                           rate=summary.get("tokens_per_sec",
                                            summary.get("images_per_sec")))
                if label == "armed":
                    with open(trace) as f:
                        events = json.load(f)["traceEvents"]
                    names = collections.Counter(e["name"] for e in events)
                    if names["train.window"] < 1 or names[
                            "train.metrics_fetch"] != names["train.window"]:
                        raise AssertionError(
                            f"[scope-train] {cli}: trace spans {dict(names)}")
                    run.update(events=len(events),
                               trace_bytes=os.path.getsize(trace))
                runs.append(run)
                _print(f"[scope-train] {cli} {label}: {steps} steps, "
                       f"launches {launches}, sync warnings {syncs}, "
                       f"{'tokens' if cli == 'train_lm' else 'images'}/s "
                       f"{run['rate']:.1f}"
                       + (f", trace {run['events']} events "
                          f"{run['trace_bytes']} bytes"
                          if label == "armed" else "") + f" [{smi}]")
            if runs[1]["syncs"] != runs[2]["syncs"] or runs[1][
                    "launches"] != runs[2]["launches"]:
                raise AssertionError(
                    f"[scope-train] {cli}: armed syncs {runs[1]['syncs']} "
                    f"launches {runs[1]['launches']}, disarmed "
                    f"{runs[2]['syncs']} / {runs[2]['launches']}")
            out[cli] = runs
    finally:
        if prev_synth is None:
            os.environ.pop("PMDT_SMALL_SYNTH", None)
        else:
            os.environ["PMDT_SMALL_SYNTH"] = prev_synth
    return out


def _fleet_rank(rank, world, port, argv, slow, hang_s, out_path):
    """One rank of [fleet-xcard]: ``train_lm.main(argv)`` under
    ``PMDT_FLEET`` (rank ``slow`` under a store-write hang). At the
    run's end, before any stats server closes, rank 0 runs the
    collector over the rendezvous store and every rank's server; each
    rank writes its summary (rank 0 the collector's views too)."""
    os.environ.update(PMDT_MASTER_ADDR=f"127.0.0.1:{port}",
                      PMDT_WORLD_SIZE=str(world), PMDT_RANK=str(rank),
                      PMDT_FLEET=FLEET_RUN, OMP_NUM_THREADS="1")
    if rank == slow:
        os.environ["PMDT_FAULT_PLAN"] = f"store.set=hang:0:{hang_s}"
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch
    import torch.distributed as tdist

    from pytorch_multiprocessing_distributed_tpu_torch import train_lm
    from pytorch_multiprocessing_distributed_tpu_torch.runtime import (
        fleet, telemetry)

    if argv[argv.index("--device") + 1] == "cpu":
        torch.set_num_threads(1)  # gloo ranks share the host's cores

    report = {}
    stop = telemetry.stop_stats

    def collect_then_stop(server):
        if server is not None and not report:
            report["done"] = True
            tdist.barrier()  # every rank's last stamp is in the store
            if rank == 0:
                monitor = fleet.active_fleet()
                col = fleet.FleetCollector(monitor.store,
                                           run_uid=monitor.run_uid)
                scraped = col.scrape()
                merged = col.merged_timeline(
                    {r: s["events"] for r, s in scraped.items()})
                report.update(
                    straggler=col.straggler_report(),
                    lanes=sum(e.get("name") == "process_name"
                              for e in merged["traceEvents"]),
                    merged_events=len(merged["traceEvents"]),
                    goodput={r: s["snapshot"]["goodput_frac"]
                             for r, s in scraped.items()},
                    gauges=len(col.merged_gauges(
                        {r: s["snapshot"] for r, s in scraped.items()})),
                    endpoints=len(col.endpoints()))
            tdist.barrier()  # rank 0 read the store and the servers
            report["monitor"] = fleet.active_fleet().snapshot()
        stop(server)

    telemetry.stop_stats = collect_then_stop
    summary = train_lm.main(argv)
    with open(f"{out_path}.{rank}", "w") as f:
        json.dump({"steps": summary["steps"], "report": report}, f)


def _free_ports_from(n: int) -> int:
    """A port with the ``n - 1`` after it free too (rank r's stats server
    binds ``--stats_port + r``), apart from the rendezvous store's."""
    for _ in range(200):
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            base = sock.getsockname()[1]
        held = []
        try:
            for p in range(base, base + n):
                sock = socket.socket()
                held.append(sock)
                sock.bind(("127.0.0.1", p))
            return base
        except OSError:
            continue
        finally:
            for sock in held:
                sock.close()
    raise RuntimeError(f"no {n} consecutive free ports")


def _fleet_run(device, model, extra, hang_s=FLEET_HANG_S, timeout_s=600):
    """[fleet-xcard]'s four ranks on ``device``, rank FLEET_SLOW slowed by
    ``hang_s`` a store write; returns rank 0's collector views (with
    every rank's arrivals and dropped stamps) and every rank's steps."""
    port = _free_ports_from(FLEET_RANKS)
    with tempfile.TemporaryDirectory() as tmp:
        # a full-log scope on every rank (rank 0 writes the trace)
        argv = ["--model", model, "--parallel", "dp", "--device", device,
                "--epochs", "1", "--print_freq", "1", "--seed", "0",
                "--stats_port", str(port), "--trace_out",
                os.path.join(tmp, "trace.json"), "--save_path", tmp]
        ranks = _run_ranks(_fleet_rank, FLEET_RANKS,
                           (argv + extra, FLEET_SLOW, hang_s),
                           timeout_s=timeout_s, per_rank=True)
    report = dict(ranks[0]["report"],
                  dropped=[r["report"]["monitor"]["fleet_dropped_stamps"]
                           for r in ranks],
                  arrivals=[r["report"]["monitor"]["fleet_arrivals"]
                            for r in ranks])
    return report, [r["steps"] for r in ranks]


def _scope_fleet(torch, smi):
    """[fleet-xcard] on four cards (skipped with fewer)."""
    cards = torch.cuda.device_count()
    if cards < FLEET_RANKS:
        _print(f"[fleet-xcard] skipped: {cards} card(s) visible, "
               f"{FLEET_RANKS} needed (python3 chip_smoke.py --scope-only "
               "where four are visible)")
        return None
    t0 = time.perf_counter()
    report, steps = _fleet_run(
        "cuda", "gpt_small",
        ["--batch_size", "16", "--seq_len", "1024", "--corpus_tokens",
         str(SCOPE_TRAIN_STEPS * 16 * 1024), "--lr", TRAIN_LR, "--dtype",
         "bfloat16"])
    _check_fleet(report, steps)
    strag = report["straggler"]
    _print(f"[fleet-xcard] train_lm gpt_small bf16 --parallel dp on "
           f"{FLEET_RANKS} cards, {steps[0]} steps, rank {FLEET_SLOW} "
           f"slowed {FLEET_HANG_S} s a store write: lanes "
           f"{report['lanes']}, merged trace {report['merged_events']} "
           f"entries, collectives matched {strag['collectives']}, "
           f"straggler rank {strag['straggler_rank']} (lag p95 "
           f"{strag['straggler_lag_p95_s'] * 1e3:.2f} ms; skew p50 "
           f"{strag['skew_p50_s'] * 1e3:.2f} ms p95 "
           f"{strag['skew_p95_s'] * 1e3:.2f} ms), goodput_frac "
           f"{report['goodput']}, arrivals {report['arrivals']}, dropped "
           f"stamps {report['dropped']}, "
           f"wall {time.perf_counter() - t0:.1f} s [{smi}]")
    return report


def _check_fleet(report, steps):
    if len(set(steps)) != 1 or report.get("lanes") != FLEET_RANKS:
        raise AssertionError(f"[fleet-xcard] steps {steps}, {report}")
    strag = report["straggler"]
    if strag["straggler_rank"] != FLEET_SLOW:
        raise AssertionError(
            f"[fleet-xcard] the report names rank "
            f"{strag['straggler_rank']}, not the slowed {FLEET_SLOW}: "
            f"{strag['by_rank']}")
    if not all(0.0 < g <= 1.0 for g in report["goodput"].values()):
        raise AssertionError(f"[fleet-xcard] goodput {report['goodput']}")


def _scope_phase(torch, serve_lm, train_lm, image_main, da, fa, fused_sgd_,
                 smi):
    """Phase 33 (see the module docstring). Returns the kernels line's
    additions: rows 1, 5-7 and 8's launches armed and disarmed."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        serve = _scope_serve(torch, serve_lm, da, smi, tmp)
        _scope_flight(serve_lm, smi, tmp)
        hbm_out = _scope_hbm(torch, smi)
        train = _scope_train(torch, train_lm, image_main, fa, fused_sgd_,
                             smi, tmp)
    fleet_out = _scope_fleet(torch, smi)
    pairs = [(r["label"], round(r["tok_s"], 1)) for r in serve["dense"]]
    _print(f"[scope] phase 33 wall {time.perf_counter() - t0:.1f} s; "
           f"dense decode tokens/s in turns {pairs} [{smi}]")
    per_step = {
        **{row: {r["label"]: r["launches"] / r["steps"]
                 for r in serve[layout][:2]}
           for layout, _, row, _ in SCOPE_SERVE_RUNS},
        **{name: {r["label"]: r["launches"][name] / r["steps"]
                  for r in train["train_lm"][:2]} for name in FLASH_PRODUCTS},
        "fused_sgd": {r["label"]: r["launches"]["fused_sgd"] / r["steps"]
                      for r in train["main"][:2]}}
    return dict(serve=serve, train=train, hbm=hbm_out, fleet=fleet_out,
                per_step=per_step)


# ------------------------------------------------------------- phase 34


def _gen_model(torch, dtype, device="cuda"):
    """GEN_MODEL at full width, random weights from seed 0, on
    ``device``."""
    from pytorch_multiprocessing_distributed_tpu_torch.models import (
        get_model)
    from pytorch_multiprocessing_distributed_tpu_torch.serving import (
        init_params)

    model = get_model(GEN_MODEL, dtype=dtype)
    model.load_state_dict(init_params(model, 0, device), assign=True)
    return model


def _gen_ragged(torch, np, generate, da, smi):
    """[ragged]: GEN_RAGGED's prompts left-padded into one ``generate``
    call, each row against a one-row call on its unpadded prompt (f32:
    every row exact; bf16: counted), and row 1's launches a decode step
    of the ragged call."""
    cfg = GEN_RAGGED
    rng = np.random.default_rng(34)
    lengths = np.linspace(cfg["min_len"], cfg["pad_to"],
                          cfg["rows"]).astype(np.int64)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        tname = str(dtype).split(".")[1]
        model = _gen_model(torch, dtype)
        prompts = [rng.integers(0, model.vocab_size, n) for n in lengths]
        padded = torch.tensor(np.stack([
            np.concatenate([np.zeros(cfg["pad_to"] - len(p), np.int64), p])
            for p in prompts]), device="cuda")
        steps = cfg["new"] - 1
        with torch.no_grad():
            generate(model, padded, max_new_tokens=2,
                     prompt_lengths=torch.tensor(lengths, device="cuda"))
            torch.cuda.synchronize()
            da.decode_attention.launches = 0
            t0 = time.perf_counter()
            got = generate(model, padded, max_new_tokens=cfg["new"],
                           prompt_lengths=torch.tensor(lengths,
                                                       device="cuda"))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = da.decode_attention.launches
            rows = [generate(model, torch.tensor(p[None], device="cuda"),
                             max_new_tokens=cfg["new"])[0, -cfg["new"]:]
                    .tolist() for p in prompts]
        if launches != model.num_layers * steps:
            raise AssertionError(
                f"ragged generate {tname}: row 1 launched {launches} times "
                f"over {steps} decode steps; expected {model.num_layers} a "
                "step")
        exact = sum(got[i, -cfg["new"]:].tolist() == rows[i]
                    for i in range(cfg["rows"]))
        if dtype == torch.float32 and exact != cfg["rows"]:
            raise AssertionError(
                f"ragged generate f32: {exact}/{cfg['rows']} rows equal "
                "their one-row calls")
        out[tname] = dict(exact=exact, launches=launches, steps=steps,
                          wall_s=wall)
        required = " (all required)" if dtype == torch.float32 else ""
        _print(f"[ragged] {GEN_MODEL} {tname}: {cfg['rows']} prompts of "
               f"lengths {lengths.tolist()} left-padded to {cfg['pad_to']}, "
               f"{cfg['new']} new tokens: {exact}/{cfg['rows']} rows equal "
               f"their one-row calls{required}, "
               f"row 1 launches {launches} over {steps} decode steps "
               f"({launches / steps:g} a step), wall {wall:.3f} s [{smi}]")
        del model
        torch.cuda.empty_cache()
    return out


def _gen_starts(torch, F, da, rate, smi):
    """[gen-starts]: row 1 with a first valid column a slot (starts drawn
    below each slot's reach) against its plain version in f32 and bf16,
    null-equivalent zeros bit-equal to no starts, the graph replay
    bit-equal; the bf16 call timed beside the same call without
    ``starts``. Launches made here are not counted."""
    w = GEN_STARTS_WINDOW
    launches = da.decode_attention.launches
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        tname = str(dtype).split(".")[1]
        q, k, v, pos = _decode_inputs(torch, w, dtype, seed=34)
        gen = torch.Generator(device="cuda").manual_seed(35)
        reach = pos.clamp(max=w - 1)
        starts = (torch.rand(pos.shape, generator=gen, device="cuda")
                  * (reach + 1)).floor().to(torch.int32)

        def call(s=starts):
            return da.decode_attention(q, k, v, pos, starts=s, impl="cuda")

        got = call()
        err = float((got - da.torch_decode_attention(q, k, v, pos, starts))
                    .abs().max())
        if not err <= TOL[tname]:
            raise AssertionError(
                f"decode_attention with starts {tname}: max|err| {err} > "
                f"{TOL[tname]}")
        if not (torch.equal(got, call())
                and torch.equal(_graph_bits(call, torch), got)):
            raise AssertionError(
                f"decode_attention with starts {tname}: two calls, or the "
                "graph replay and the eager call, differ")
        if not torch.equal(call(torch.zeros_like(starts)),
                           da.decode_attention(q, k, v, pos, impl="cuda")):
            raise AssertionError(
                f"decode_attention {tname}: starts of zeros differ from no "
                "starts")
        out[tname] = dict(max_abs_err=err)
        if dtype == torch.bfloat16:
            t = _time_decode(torch, F, da.decode_attention,
                             da.torch_decode_attention, q, k, v, pos, rate,
                             starts)
            t0 = _time_decode(torch, F, da.decode_attention,
                              da.torch_decode_attention, q, k, v, pos, rate)
            out[tname].update(t, no_starts=t0)
        _print(f"[gen-starts] decode_attention {tname} N=8 H=12 Dh=64 W={w} "
               f"({DECODE_KERNELS}: {_plan_text(da, q, w)}) positions="
               f"{pos.tolist()} starts={starts.tolist()} max_abs_err="
               f"{err:.3e} (tol {TOL[tname]}), zeros bit-equal to no starts, "
               "two calls and the graph replay bit-equal"
               + ("" if dtype != torch.bfloat16 else
                  f"; ms={t['ms']:.5f} (L2-warm) cold_ms={t['cold_ms']:.5f} "
                  f"eager_ms={t['eager_ms']:.5f} plain_ms={t['plain_ms']:.5f}"
                  f" library_ms={t['library_ms']:.5f} (SDPA, the same mask) "
                  f"bound_ms={t['bound_ms']:.5f} ({t['bound_by']}); without "
                  f"starts ms={t0['ms']:.5f} cold_ms={t0['cold_ms']:.5f} "
                  f"bound_ms={t0['bound_ms']:.5f} library_ms="
                  f"{t0['library_ms']:.5f}") + f" [{smi}]")
    da.decode_attention.launches = launches
    return out


def _gen_beam(torch, np, generate, beam_search, da, smi):
    """[beam]: GEN_MODEL bf16 on one prompt: ``beam_size`` 1 against
    greedy ``generate``; BEAMS beams' row-1 launches a step and the
    step's wall; and f32 (TF32 off) BEAMS beams on the card against the
    same call on the CPU."""
    cfg = GEN_BEAM
    rng = np.random.default_rng(36)
    model = _gen_model(torch, torch.bfloat16)
    prompt = torch.tensor(rng.integers(0, model.vocab_size,
                                       (1, cfg["prompt"])), device="cuda")
    steps = cfg["new"] - 1
    with torch.no_grad():
        greedy = generate(model, prompt, max_new_tokens=cfg["new"])
        one, _ = beam_search(model, prompt, max_new_tokens=cfg["new"],
                             beam_size=1)
        if not torch.equal(one[:, 0], greedy):
            raise AssertionError(
                f"beam_search beam_size=1 {one[0, 0, -cfg['new']:].tolist()}"
                f" != greedy generate {greedy[0, -cfg['new']:].tolist()}")
        beam_search(model, prompt, max_new_tokens=cfg["new"],
                    beam_size=cfg["beams"])  # warm
        torch.cuda.synchronize()
        da.decode_attention.launches = 0
        t0 = time.perf_counter()
        toks, scores = beam_search(model, prompt, max_new_tokens=cfg["new"],
                                   beam_size=cfg["beams"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = da.decode_attention.launches
        t0 = time.perf_counter()
        beam_search(model, prompt, max_new_tokens=1, beam_size=cfg["beams"])
        torch.cuda.synchronize()
        wall_prefill = time.perf_counter() - t0
    if launches != model.num_layers * steps:
        raise AssertionError(
            f"beam_search: row 1 launched {launches} times over {steps} "
            f"steps; expected {model.num_layers} a step")
    step_ms = (wall - wall_prefill) / steps * 1e3
    del model
    torch.cuda.empty_cache()
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    runs = {}
    for device in ("cuda", "cpu"):
        model = _gen_model(torch, torch.float32, device)
        with torch.no_grad():
            runs[device] = [t.cpu() for t in beam_search(
                model, prompt.to(device), max_new_tokens=cfg["new"],
                beam_size=cfg["beams"])]
        del model
    torch.backends.cuda.matmul.allow_tf32 = allow
    torch.cuda.empty_cache()
    score_err = float((runs["cuda"][1] - runs["cpu"][1]).abs().max())
    if not (torch.equal(runs["cuda"][0], runs["cpu"][0])
            and score_err <= GEN_BEAM_SCORE_TOL):
        raise AssertionError(
            f"beam_search f32 {cfg['beams']} beams: the card's tokens "
            f"{runs['cuda'][0][0, :, -cfg['new']:].tolist()} against the "
            f"CPU's {runs['cpu'][0][0, :, -cfg['new']:].tolist()}, scores "
            f"err {score_err} (tol {GEN_BEAM_SCORE_TOL})")
    _print(f"[beam] {GEN_MODEL} bf16 prompt {cfg['prompt']}, {cfg['new']} new "
           f"tokens: beam_size 1 equals greedy generate; beam_size "
           f"{cfg['beams']}: scores "
           f"{[round(x, 4) for x in scores[0].tolist()]}"
           f", row 1 launches {launches} over {steps} steps "
           f"({launches / steps:g} a step), call wall {wall * 1e3:.2f} ms, "
           f"a step {step_ms:.3f} ms (the call's wall less a one-token "
           f"call's {wall_prefill * 1e3:.2f} ms, over {steps} steps); f32 "
           f"(TF32 off) {cfg['beams']} beams on the card equal the CPU's "
           f"tokens, scores err {score_err:.3e} (tol {GEN_BEAM_SCORE_TOL}) "
           f"[{smi}]")
    return dict(launches=launches, steps=steps, step_ms=step_ms,
                wall_s=wall, score_err=score_err)


def _gen_lm_beams(torch, train_lm, beam_search, da, smi, tmp):
    """[lm-beams]: ``train_lm --sample --sample_beams --hf_export`` on
    the card; its sample against ``beam_search``'s best beam on its
    saved params. Returns the run's summary and ``save_path`` (``[hf]``
    reads its export)."""
    from pytorch_multiprocessing_distributed_tpu_torch.data import (
        synthetic_tokens)
    from pytorch_multiprocessing_distributed_tpu_torch.models import (
        get_model)
    from pytorch_multiprocessing_distributed_tpu_torch.serving import (
        load_params)
    from pytorch_multiprocessing_distributed_tpu_torch.utils.gpt_interop \
        import GPT2_LN_EPS

    save = os.path.join(tmp, "export")
    beams = GEN_BEAM["beams"]
    da.decode_attention.launches = 0
    t0 = time.perf_counter()
    summary = train_lm.main(GEN_LM_ARGV + [
        "--sample", str(GEN_LM_SAMPLE), "--sample_beams", str(beams),
        "--hf_export", "--save_path", save])
    wall = time.perf_counter() - t0
    launches = da.decode_attention.launches
    steps = GEN_LM_SAMPLE - 1
    model = get_model(GEN_MODEL, dtype=torch.bfloat16, ln_eps=GPT2_LN_EPS,
                      head_bias=False)  # --hf_export's configuration
    if launches != model.num_layers * steps:
        raise AssertionError(
            f"train_lm --sample_beams {beams}: row 1 launched {launches} "
            f"times over {steps} beam steps; expected {model.num_layers} a "
            "step")
    params = load_params(model, os.path.join(save, "model_1.pth"))
    model.load_state_dict({k: t.cuda() for k, t in params.items()},
                          assign=True)
    flags = dict(zip(GEN_LM_ARGV[::2], GEN_LM_ARGV[1::2]))
    seq = int(flags["--seq_len"])
    tokens = synthetic_tokens(int(flags["--corpus_tokens"]),
                              vocab_size=model.vocab_size,
                              seed=int(flags["--seed"]))
    with torch.no_grad():
        best, _ = beam_search(
            model, torch.as_tensor(tokens[:seq][None], dtype=torch.long,
                                   device="cuda"),
            max_new_tokens=GEN_LM_SAMPLE, beam_size=beams)
    want = best[0, 0, -GEN_LM_SAMPLE:].tolist()
    if summary["sample"] != want:
        raise AssertionError(
            f"train_lm --sample_beams {beams} printed {summary['sample']}; "
            f"beam_search's best beam on its params is {want}")
    _print(f"[lm-beams] train_lm {' '.join(GEN_LM_ARGV)} --sample "
           f"{GEN_LM_SAMPLE} --sample_beams {beams} --hf_export: "
           f"{summary['steps']} "
           f"steps, loss {summary['epoch_losses']}, the printed sample "
           f"equals beam_search's best beam on the saved params, row 1 "
           f"launches {launches} ({launches / steps:g} a beam step), wall "
           f"{wall:.2f} s [{smi}]")
    del model
    torch.cuda.empty_cache()
    return dict(launches=launches, steps=steps, summary=summary, save=save)


def _gpt2_shapes(v, p, d, layers, mlp):
    """GPT-2's ``GPT2LMHeadModel`` parameter names and shapes (its
    ``Conv1D`` weights ``[in, out]``; the causal-mask buffers left out)."""
    shapes = {"transformer.wte.weight": (v, d),
              "transformer.wpe.weight": (p, d)}
    for i in range(layers):
        pre = f"transformer.h.{i}."
        shapes.update({
            pre + "ln_1.weight": (d,), pre + "ln_1.bias": (d,),
            pre + "attn.c_attn.weight": (d, 3 * d),
            pre + "attn.c_attn.bias": (3 * d,),
            pre + "attn.c_proj.weight": (d, d),
            pre + "attn.c_proj.bias": (d,),
            pre + "ln_2.weight": (d,), pre + "ln_2.bias": (d,),
            pre + "mlp.c_fc.weight": (d, mlp), pre + "mlp.c_fc.bias": (mlp,),
            pre + "mlp.c_proj.weight": (mlp, d),
            pre + "mlp.c_proj.bias": (d,)})
    shapes.update({"transformer.ln_f.weight": (d,),
                   "transformer.ln_f.bias": (d,), "lm_head.weight": (v, d)})
    return shapes


def _gen_hf(torch, train_lm, smi, tmp, lm):
    """[hf]: the ``--hf_export`` of ``[lm-beams]``'s run (``lm``), then
    a ``--hf_init`` run of its file at lr 0: the file's names and shapes
    are GPT-2's, its import is the exported params bit for bit, and the
    importing run's first eval loss is the exporting run's last."""
    from pytorch_multiprocessing_distributed_tpu_torch.models import (
        get_model)
    from pytorch_multiprocessing_distributed_tpu_torch.serving import (
        load_params)
    from pytorch_multiprocessing_distributed_tpu_torch.utils.gpt_interop \
        import GPT2_LN_EPS, from_gpt2_state_dict

    exported = lm["summary"]
    path = exported["hf_export"]
    size = os.path.getsize(path)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    model = get_model(GEN_MODEL, ln_eps=GPT2_LN_EPS, head_bias=False)
    want = _gpt2_shapes(model.vocab_size, model.max_seq_len,
                        model.hidden_size, model.num_layers, model.mlp_dim)
    got = {k: tuple(t.shape) for k, t in sd.items()}
    if got != want:
        raise AssertionError(
            f"--hf_export wrote {len(got)} tensors; GPT-2's names and shapes "
            f"differ at {sorted(set(got.items()) ^ set(want.items()))[:4]}")
    _, imported = from_gpt2_state_dict(sd, model.num_heads)
    saved = load_params(model, os.path.join(lm["save"], "model_1.pth"))
    differ = sorted(k for k in saved if not torch.equal(saved[k],
                                                         imported[k]))
    if set(saved) != set(imported) or differ:
        raise AssertionError(
            f"the imported params differ from the exported run's: {differ[:4]}"
            f" (names equal: {set(saved) == set(imported)})")
    importing = train_lm.main(GEN_LM_ARGV + [
        "--hf_init", path, "--lr", "0", "--save_path",
        os.path.join(tmp, "import")])
    last, first = exported["val_losses"][-1], importing["val_losses"][0]
    if not abs(first - last) <= GEN_EVAL_TOL:
        raise AssertionError(
            f"--hf_init run's first eval loss {first} against the exporting "
            f"run's last {last} (tol {GEN_EVAL_TOL})")
    _print(f"[hf] [lm-beams]'s --hf_export: "
           f"{os.path.basename(path)} {size} bytes, {len(sd)} tensors with "
           f"GPT-2's names and shapes, imported bit for bit; --hf_init at lr "
           f"0: first eval loss {first!r} against the exporting run's last "
           f"{last!r} (diff {abs(first - last)}, tol {GEN_EVAL_TOL}) [{smi}]")
    return dict(tensors=len(sd), bytes=size, eval_diff=abs(first - last))


def _vit_seq_setup(torch, device):
    """The ring ViT (``seq_axis="seq"``) and the one-card ViT
    (``flash=True``) with the same weights, and the batch every rank
    takes, on ``device``."""
    from pytorch_multiprocessing_distributed_tpu_torch.models import (
        get_model, init_model)

    cfg = VIT_SEQ
    kw = dict(dtype=torch.bfloat16, num_classes=cfg["classes"],
              image_size=cfg["image"])
    ring = init_model(get_model(cfg["model"], seq_axis="seq", **kw), 0)
    one = get_model(cfg["model"], flash=True, **kw)
    one.load_state_dict(ring.state_dict())
    gen = torch.Generator(device=device).manual_seed(34)
    x = torch.randn(cfg["batch"], cfg["image"], cfg["image"], 3,
                    generator=gen, device=device)
    y = torch.randint(0, cfg["classes"], (cfg["batch"],), generator=gen,
                      device=device)
    return ring.to(device), one.to(device), x, y


def _vit_seq_steps(torch, fa, model, x, y):
    """One counted step of ``model`` (forward, CE, backward): its logits,
    parameter gradients and flash launches; then VIT_SEQ's steps timed
    with CUDA events and the peak memory of a step."""
    import torch.nn.functional as F

    def step():
        model.zero_grad(set_to_none=True)
        logits = model(x)
        F.cross_entropy(logits, y).backward()
        return logits

    before = {n: getattr(fa, n).launches for n in FLASH_PRODUCTS}
    for n in FLASH_PRODUCTS:
        getattr(fa, n).launches = 0
    logits = step().detach().float()
    launches = {n: getattr(fa, n).launches for n in FLASH_PRODUCTS}
    grads = [p.grad.float().clone() for p in model.parameters()]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(VIT_SEQ["steps"]):
        step()
    end.record()
    end.synchronize()
    for n, count in before.items():  # the timed steps are not counted
        getattr(fa, n).launches = count + launches[n]
    return dict(logits=logits, grads=grads, launches=launches,
                step_ms=start.elapsed_time(end) / VIT_SEQ["steps"],
                peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)


def _vit_seq_compare(torch, fa, n, rank, device):
    """The ring ViT at degree ``n`` (this rank of a 1 x n seq grid)
    against the one-card ViT on the same batch: normwise logits and
    gradient errors, bit-equality, launches against the hop schedule,
    step times and peaks."""
    ring_mod = importlib.import_module(
        "pytorch_multiprocessing_distributed_tpu_torch.parallel."
        "ring_attention")

    ring, one, x, y = _vit_seq_setup(torch, device)
    got = _vit_seq_steps(torch, fa, ring, x, y)
    ref = _vit_seq_steps(torch, fa, one, x, y)

    def err(a, b):
        return float((a - b).norm() / b.norm().clamp_min(1e-30))

    quads = sum(len(q) for _, q in ring_mod.hop_schedule(n, rank,
                                                          causal=False))
    want = {name: ring.num_layers * quads for name in FLASH_PRODUCTS}
    return dict(
        logits_err=err(got["logits"], ref["logits"]),
        grad_err=max(err(a, b) for a, b in zip(got["grads"], ref["grads"])),
        bit_equal=(torch.equal(got["logits"], ref["logits"])
                   and all(torch.equal(a, b) for a, b in zip(got["grads"],
                                                             ref["grads"]))),
        launches=got["launches"], want=want, one_launches=ref["launches"],
        step_ms=got["step_ms"], one_step_ms=ref["step_ms"],
        peak_gib=got["peak_gib"], one_peak_gib=ref["peak_gib"])


def _vit_seq_rank(rank, world, port, out_path):
    """One NCCL rank of ``[vit-seq]`` at degree ``world``; writes its
    comparison to ``{out_path}.{rank}``."""
    os.environ.update(PMDT_MASTER_ADDR=f"127.0.0.1:{port}",
                      PMDT_WORLD_SIZE=str(world), PMDT_RANK=str(rank))
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch

    fa = importlib.import_module(
        "pytorch_multiprocessing_distributed_tpu_torch.ops.flash_attention")
    from pytorch_multiprocessing_distributed_tpu_torch.parallel import dist
    from pytorch_multiprocessing_distributed_tpu_torch.parallel.mesh import (
        make_grid)

    dist.init_process("cuda")
    make_grid(1, world, axis="seq")
    out = _vit_seq_compare(torch, fa, world, rank,
                           dist.device_for_rank("cuda"))
    with open(f"{out_path}.{rank}", "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


def _vit_seq_line(n, res, smi):
    for r, got in enumerate(res):
        if got["launches"] != got["want"]:
            raise AssertionError(
                f"ViT seq_axis degree {n} rank {r}: flash launches "
                f"{got['launches']} in a step, the hop schedule wants "
                f"{got['want']}")
        if not (got["logits_err"] <= VIT_SEQ_TOL
                and got["grad_err"] <= VIT_SEQ_TOL):
            raise AssertionError(
                f"ViT seq_axis degree {n} rank {r}: logits err "
                f"{got['logits_err']}, grad err {got['grad_err']} against "
                f"one card (tol {VIT_SEQ_TOL}, normwise)")
    cfg = VIT_SEQ
    r0 = res[0]
    errs = {key: [float(f"{g[key]:.3e}") for g in res]
            for key in ("logits_err", "grad_err")}
    _print(f"[vit-seq] ViT-B/16 bf16 {cfg['image']}x{cfg['image']} batch "
           f"{cfg['batch']}, the same batch on each of {n} rank(s) of a seq "
           f"axis, ring attention (non-causal): logits err "
           f"{errs['logits_err']}, grad err {errs['grad_err']} against one "
           f"card (tol "
           f"{VIT_SEQ_TOL}, normwise; bit-equal "
           f"{[g['bit_equal'] for g in res]}), flash launches a rank a step "
           f"{[g['launches']['flash_fwd'] for g in res]} fwd / "
           f"{[g['launches']['flash_bwd_dq'] for g in res]} dq / "
           f"{[g['launches']['flash_bwd_dkv'] for g in res]} dkv (the hop "
           f"schedule's; one card {r0['one_launches']}), step "
           f"{[round(g['step_ms'], 2) for g in res]} ms against one card's "
           f"{r0['one_step_ms']:.2f}, peak a card "
           f"{[round(g['peak_gib'], 3) for g in res]} GiB against "
           f"{r0['one_peak_gib']:.3f} (CUDA events over {cfg['steps']} "
           f"steps) [{smi}]")


def _gen_vit_seq(torch, fa, smi):
    """[vit-seq]: degree 1 on this card, then 2 and 4 where that many
    cards are visible."""
    from pytorch_multiprocessing_distributed_tpu_torch.parallel.mesh import (
        make_grid, reset_grid)

    make_grid(1, 1, axis="seq")
    try:
        one = _vit_seq_compare(torch, fa, 1, 0, "cuda")
    finally:
        reset_grid()
    torch.cuda.empty_cache()
    _vit_seq_line(1, [one], smi)
    out = {1: [one]}
    cards = torch.cuda.device_count()
    for n in (2, VIT_SEQ_MAX_RANKS):
        if cards < n:
            _print(f"[vit-seq] degree {n} skipped: {cards} card(s) visible "
                   f"(python3 chip_smoke.py --gen-only where {n} are) "
                   f"[{smi}]")
            continue
        out[n] = _run_ranks(_vit_seq_rank, n, (), per_rank=True)
        _vit_seq_line(n, out[n], smi)
    return out


def _gen_phase(torch, np, F, train_lm, generate, beam_search, da, fa, rate,
               smi):
    """Phase 34 (see the module docstring). Returns the kernels line's
    additions to row 1."""
    t0 = time.perf_counter()
    ragged = _gen_ragged(torch, np, generate, da, smi)
    starts = _gen_starts(torch, F, da, rate, smi)
    beam = _gen_beam(torch, np, generate, beam_search, da, smi)
    with tempfile.TemporaryDirectory() as tmp:
        lm = _gen_lm_beams(torch, train_lm, beam_search, da, smi, tmp)
        hf = _gen_hf(torch, train_lm, smi, tmp, lm)
    vit = _gen_vit_seq(torch, fa, smi)
    _print(f"[gen] phase 34 wall {time.perf_counter() - t0:.1f} s [{smi}]")
    t = starts["bfloat16"]
    return {
        "ragged_launches_per_step": {
            tname: r["launches"] / r["steps"] for tname, r in ragged.items()},
        "beam_launches_per_step": beam["launches"] / beam["steps"],
        "sample_beams_launches": lm["launches"],
        **{f"starts_{key}": t[key] for key in (
            "ms", "cold_ms", "eager_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")},
        "starts_max_abs_err": max(s["max_abs_err"] for s in starts.values()),
        "starts_no_starts_ms": t["no_starts"]["ms"],
        "starts_shape": f"bf16 N=8 H=12 Dh=64 W={GEN_STARTS_WINDOW}",
        "vit_seq": {n: [{k: g[k] for k in ("logits_err", "grad_err",
                                             "step_ms", "one_step_ms")}
                        for g in res] for n, res in vit.items()}}


def main() -> int:
    import numpy as np
    import torch

    t_start = time.perf_counter()
    # -- phase 1: device
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this "
              "smoke test needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch.nn.functional as F

    from pytorch_multiprocessing_distributed_tpu_torch import (
        allreduce_bw, serve_lm, train_lm)
    from pytorch_multiprocessing_distributed_tpu_torch import (
        main as image_main)
    from pytorch_multiprocessing_distributed_tpu_torch.data import (
        normalize, synthetic_cifar10)
    from pytorch_multiprocessing_distributed_tpu_torch.inference import (
        beam_search, generate)
    from pytorch_multiprocessing_distributed_tpu_torch.models import (
        get_model, init_resnet)
    from pytorch_multiprocessing_distributed_tpu_torch.ops import _build
    # the module (the package's ``flash_attention`` name is the function)
    fa = importlib.import_module(
        "pytorch_multiprocessing_distributed_tpu_torch.ops.flash_attention")
    from pytorch_multiprocessing_distributed_tpu_torch.ops.decode_attention \
        import decode_attention, torch_decode_attention
    from pytorch_multiprocessing_distributed_tpu_torch.ops.fused_update \
        import fused_sgd_, torch_fused_sgd_
    from pytorch_multiprocessing_distributed_tpu_torch.ops.kv_quant import (
        quantize_kv)
    da = importlib.import_module(
        "pytorch_multiprocessing_distributed_tpu_torch.ops.decode_attention")
    ring = importlib.import_module(
        "pytorch_multiprocessing_distributed_tpu_torch.ops.ring_allreduce")
    from pytorch_multiprocessing_distributed_tpu_torch.serving import (
        ServingEngine, SlotPool, init_params)
    from pytorch_multiprocessing_distributed_tpu_torch.train import (
        create_lm_train_state, create_train_state, make_lm_train_step,
        make_train_step, sgd, sgd_fused)

    smi = _nvidia_smi()
    card = torch.cuda.get_device_name(0)
    rate = _hbm_rate(card)
    _print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
           f"python {sys.version.split()[0]}; card {card}; "
           f"{torch.cuda.device_count()} device(s)")
    _print(smi)
    if "--zero-only" in sys.argv[1:]:
        _zero_phase(torch, image_main, smi)
        _print(f"[total] chip_smoke --zero-only wall "
               f"{time.perf_counter() - t_start:.1f} s")
        return 0
    if "--gspmd-only" in sys.argv[1:]:
        _gspmd_phase(torch, image_main, smi)
        _print(f"[total] chip_smoke --gspmd-only wall "
               f"{time.perf_counter() - t_start:.1f} s")
        return 0
    if "--sp-only" in sys.argv[1:]:
        _sp_phase(torch, fa, F, rate, smi)
        _print(f"[total] chip_smoke --sp-only wall "
               f"{time.perf_counter() - t_start:.1f} s")
        return 0
    if "--mp-only" in sys.argv[1:]:
        _mp_phase(torch, fa, train_lm, smi)
        _print(f"[total] chip_smoke --mp-only wall "
               f"{time.perf_counter() - t_start:.1f} s")
        return 0
    if "--moe-only" in sys.argv[1:]:
        _moe_phase(torch, fa, train_lm, smi, da)
        _print(f"[total] chip_smoke --moe-only wall "
               f"{time.perf_counter() - t_start:.1f} s")
        return 0
    if "--tp-only" in sys.argv[1:]:
        t0 = time.perf_counter()
        _build.build_all()  # the spawned ranks find the kernels built
        _print(f"[build] {time.perf_counter() - t0:.2f} s")
        _tp_phase(torch, serve_lm, F, da, quantize_kv, rate, smi)
        _print(f"[total] chip_smoke --tp-only wall "
               f"{time.perf_counter() - t_start:.1f} s")
        return 0
    if "--serve-heal-only" in sys.argv[1:]:
        t0 = time.perf_counter()
        reports = _build.build_all()  # the children find the kernels built
        _print(f"[build] {len(reports)} source(s) in "
               f"{time.perf_counter() - t0:.2f} s")
        _serve_heal_phase(torch, serve_lm, train_lm, da, smi)
        _print(f"[total] chip_smoke --serve-heal-only wall "
               f"{time.perf_counter() - t_start:.1f} s")
        return 0
    if "--fleet-only" in sys.argv[1:]:
        t0 = time.perf_counter()
        _build.build_all()  # the spawned ranks find the kernels built
        _print(f"[build] {time.perf_counter() - t0:.2f} s")
        _scope_fleet(torch, smi)
        _print(f"[total] chip_smoke --fleet-only wall "
               f"{time.perf_counter() - t_start:.1f} s")
        return 0
    if "--scope-only" in sys.argv[1:]:
        t0 = time.perf_counter()
        reports = _build.build_all()
        _print(f"[build] {len(reports)} source(s) in "
               f"{time.perf_counter() - t0:.2f} s")
        _scope_phase(torch, serve_lm, train_lm, image_main, da, fa,
                     fused_sgd_, smi)
        _print(f"[total] chip_smoke --scope-only wall "
               f"{time.perf_counter() - t_start:.1f} s")
        return 0
    if "--vit-seq-only" in sys.argv[1:]:
        t0 = time.perf_counter()
        _build.build_all()  # the spawned ranks find the kernels built
        _print(f"[build] {time.perf_counter() - t0:.2f} s")
        _gen_vit_seq(torch, fa, smi)
        _print(f"[total] chip_smoke --vit-seq-only wall "
               f"{time.perf_counter() - t_start:.1f} s")
        return 0
    if "--gen-only" in sys.argv[1:]:
        t0 = time.perf_counter()
        reports = _build.build_all()  # the spawned ranks find them built
        _print(f"[build] {len(reports)} source(s) in "
               f"{time.perf_counter() - t0:.2f} s")
        _gen_phase(torch, np, F, train_lm, generate, beam_search, da, fa,
                   rate, smi)
        _print(f"[total] chip_smoke --gen-only wall "
               f"{time.perf_counter() - t_start:.1f} s")
        return 0
    if "--heal-only" in sys.argv[1:]:
        t0 = time.perf_counter()
        _build.build_all()  # the children find the kernels built
        _print(f"[build] {time.perf_counter() - t0:.2f} s")
        _heal_phase(torch, image_main, train_lm, fa, fused_sgd_, smi)
        _print(f"[total] chip_smoke --heal-only wall "
               f"{time.perf_counter() - t_start:.1f} s")
        return 0

    # -- phase 2: build
    t0 = time.perf_counter()
    reports = _build.build_all()
    _print(f"[build] {len(reports)} source(s) in "
           f"{time.perf_counter() - t0:.2f} s")
    for src, log in reports.items():
        for line in log.splitlines():
            if ("registers" in line or "spill" in line
                    or "entry function" in line or "C7512" in line):
                _print(f"[build] {src}: {line.strip()}")

    def ptxas(src):
        """The ``-Xptxas -v`` entries of ``src``'s build: this run's, or
        the log of the build it found."""
        log = _build.BUILD_DIR / f"{src}.log"
        return _build.ptxas_entries(
            reports.get(src) or (log.read_text() if log.exists() else ""))

    decode_builds = _decode_builds(ptxas("decode_attention"))
    if len(decode_builds) != 2 * 2 * 2 * 3 + 3:
        raise AssertionError(
            f"the decode build report names {len(decode_builds)} split and "
            "merge instantiations; expected 27 (dense/paged x model "
            "dtype/int8 x f32/bf16 q x Dh 32/64/128, and 3 merges)")
    for label, regs, stores, loads in decode_builds:
        _print(f"[build] {label}: {regs} registers, spill stores {stores} "
               f"bytes, spill loads {loads} bytes")
    flash_builds = _flash_builds(ptxas("flash_attention"))
    if len(flash_builds) != 3 * 2 * 3:
        raise AssertionError(
            f"the flash build report names {len(flash_builds)} kernels; "
            "expected 18 (forward, dq, dk/dv x bf16/f32 x Dh 32/64/128)")
    for label, regs, stores, loads in flash_builds:
        _print(f"[build] {label}: {regs} registers, spill stores {stores} "
               f"bytes, spill loads {loads} bytes")
    ring_builds = _ring_builds(ptxas("ring_allreduce"))
    if len(ring_builds) != 4:
        raise AssertionError(
            f"the ring build report names {len(ring_builds)} kernels; "
            "expected 4 (one rank per card and loopback, 8 and 16 data "
            "warps)")
    for label, regs, stores, loads in ring_builds:
        _print(f"[build] {label}: {regs} registers, spill stores {stores} "
               f"bytes, spill loads {loads} bytes")

    # -- phase 3: kernel against its plain version
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        tname = str(dtype).split(".")[1]
        for w in WINDOWS:
            q, k, v, pos = _decode_inputs(torch, w, dtype, seed=w)

            def call():
                return decode_attention(q, k, v, pos, impl="cuda")

            got, again = call(), call()
            torch.cuda.synchronize()
            ref = torch_decode_attention(q, k, v, pos)
            err = float((got - ref).abs().max())
            if not err <= TOL[tname]:
                raise AssertionError(
                    f"decode_attention {tname} W={w}: max|err| {err} > "
                    f"{TOL[tname]}")
            if not (torch.equal(got, again)
                    and torch.equal(_graph_bits(call, torch), got)):
                raise AssertionError(
                    f"decode_attention {tname} W={w}: two calls, or the "
                    "graph replay and the eager call, differ")
            worst = max(worst, err)
            t = _time_decode(torch, F, decode_attention,
                             torch_decode_attention, q, k, v, pos, rate)
            _print(f"[kernel] decode_attention {tname} N=8 H=12 Dh=64 "
                   f"W={w} ({DECODE_KERNELS}: {_plan_text(da, q, w)}) "
                   f"positions={pos.tolist()} max_abs_err={err:.3e} "
                   f"(tol {TOL[tname]}), two calls and the graph replay "
                   f"bit-equal, ms={t['ms']:.5f} (L2-warm) "
                   f"cold_ms={t['cold_ms']:.5f} (L2-cold) "
                   f"eager_ms={t['eager_ms']:.5f} "
                   f"plain_ms={t['plain_ms']:.5f} "
                   f"library_ms={t['library_ms']:.5f} "
                   f"bound_ms={t['bound_ms']:.5f} ({t['bound_by']}) "
                   f"[{smi}]")
            if dtype == torch.bfloat16 and w == max(WINDOWS):
                row1_long = dict(t, max_abs_err=err)

    # -- phase 4: serve through the port's CLI entry
    decode_attention.launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        metrics_path = os.path.join(tmp, "metrics.json")
        t0 = time.perf_counter()
        snap = serve_lm.main([
            "--model", "gpt_small", "--random_init", "--dtype", "bfloat16",
            "--max_slots", "8", "--synthetic", "16", "--max_new_tokens",
            "32", "--decode_horizon", "4", "--seed", "0", "--quiet",
            "--metrics_out", metrics_path])
        wall = time.perf_counter() - t0
    launches = decode_attention.launches
    if snap["requests_completed"] != 16:
        raise AssertionError(f"served {snap['requests_completed']}/16")
    steps = round(snap["decode_horizon_avg"] * snap["decode_dispatches"])
    if steps < 1 or launches != 12 * steps:
        raise AssertionError(
            f"decode_attention launched {launches} times over {steps} "
            "decode steps; expected 12 (layers) per step")
    _print(f"[serve] gpt_small bf16 16 requests x 32 tokens, 8 slots, "
           f"horizon 4: wall {wall:.2f} s, decode steps {steps}, kernel "
           f"launches {launches} (12 per step), decode tokens/s "
           f"{snap['decode_tokens_per_sec']:.1f}, TTFT p50 "
           f"{snap['ttft_p50_s'] * 1e3:.1f} ms p99 "
           f"{snap['ttft_p99_s'] * 1e3:.1f} ms, windows "
           f"{snap['decode_windows']} [{smi}]")

    # -- phase 5: engine == generate on the card, f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = get_model("gpt_small", dtype=torch.float32)
    model.load_state_dict(init_params(model, 1, "cuda"), assign=True)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, model.vocab_size, (n,)).tolist()
               for n in (5, 11, 17, 23)]
    engine = ServingEngine(model, max_slots=4, s_max=64, decode_horizon=4)
    served = engine.serve([(p, 12) for p in prompts])
    for request, prompt in zip(served, prompts):
        ref = generate(model, torch.tensor([prompt], device="cuda"),
                       max_new_tokens=12)[0, -12:].tolist()
        if request.tokens != ref:
            raise AssertionError(
                f"engine {request.tokens} != generate {ref} (prompt len "
                f"{len(prompt)})")
    _print("[exact] gpt_small f32: 4 requests through the engine are "
           "token-exact with generate")

    # -- phase 6: the flash-attention kernels against their plain versions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fb, fh, fd, fs = (FLASH_SHAPE[k] for k in ("batch", "heads",
                                               "head_dim", "seq"))
    flash_cases = [  # (label, B, Sq, Skv, H, Dh, causal, timed)
        ("main", fb, fs, fs, fh, fd, True, True),
        ("ragged", 2, 197, 300, fh, fd, False, False),
        ("straddle", 2, 129, 129, fh, fd, True, False),
        ("dh32", 2, 512, 512, 4, 32, True, False),
        ("dh128", 2, 512, 512, 4, 128, True, False),
    ]
    flash_main = {"bfloat16": {}, "float32": {}}
    for dtype in (torch.bfloat16, torch.float32):
        tname = str(dtype).split(".")[1]
        for label, b, sq, skv, h, d, causal, timed in flash_cases:
            q, k, v, do = _flash_inputs(torch, b, sq, skv, h, d, dtype,
                                        seed=sq + d)
            kernels, plains, _, _ = _flash_calls(fa, q, k, v, do, causal)
            errs = _flash_errors(torch, kernels, plains, FLASH_TOL[tname])
            shape = (f"{tname} B={b} Sq={sq} Skv={skv} H={h} Dh={d} "
                     f"{'causal' if causal else 'non-causal'}")
            if not timed:
                _print(f"[flash] {label} {shape}: max_abs_err "
                       + " ".join(f"{n}={e:.3e}" for n, e in errs.items())
                       + f" (tol {FLASH_TOL[tname]})")
                continue
            for group in (("flash_fwd",), ("flash_bwd_dq", "flash_bwd_dkv")):
                first, second = ([t for n in group for t in _tuple(
                    kernels[n]())] for _ in range(2))
                torch.cuda.synchronize()
                if not all(map(torch.equal, first, second)):
                    raise AssertionError(
                        f"flash {' + '.join(group)} {shape}: two calls "
                        "differ")
                _print(f"[flash] {' + '.join(group)} {shape}: two calls "
                       "bit-equal")
            times, dterm_ms = _time_flash(torch, F, fa, q, k, v, do,
                                          causal, rate)
            for kname, t in times.items():
                _print(f"[flash] {kname} {shape} "
                       f"max_abs_err={errs[kname]:.3e}"
                       f" ms={t['ms']:.5f} eager_ms={t['eager_ms']:.5f} "
                       f"plain_ms={t['plain_ms']:.5f} "
                       f"library_ms={t['library_ms']:.5f} "
                       f"bound_ms={t['bound_ms']:.5f} ({t['bound_by']}) "
                       + (f"fma_bound_ms={t['fma_bound_ms']:.5f} "
                          if "fma_bound_ms" in t else "")
                       + f"tflop_per_s={t['tflop_per_s']:.1f} [{smi}]")
                flash_main[tname][kname] = dict(t, max_abs_err=errs[kname],
                                                shape=shape)
            fwd = times["flash_fwd"]
            _print(f"[flash] forward {shape}: flash_fwd {fwd['ms']:.5f} ms, "
                   f"SDPA forward {fwd['library_ms']:.5f} ms (flash_fwd / "
                   f"SDPA {fwd['ms'] / fwd['library_ms']:.3f}) [{smi}]")
            pair = times["flash_bwd_dq"]["ms"] + times["flash_bwd_dkv"]["ms"]
            lib_bwd = times["flash_bwd_dq"]["library_ms"]
            _print(f"[flash] backward {shape}: pair (dq + dk/dv) "
                   f"{pair:.5f} ms, dterm (flash_dterm) {dterm_ms:.5f} ms, "
                   f"pair + dterm {pair + dterm_ms:.5f} ms, SDPA backward "
                   f"{lib_bwd:.5f} ms (pair + dterm / SDPA "
                   f"{(pair + dterm_ms) / lib_bwd:.3f}) [{smi}]")
            if dtype == torch.float32:
                # a peaky softmax (logits x 16): each kernel's largest
                # error against its plain version (the forward's out and
                # lse apart), printed only
                pk, pp, _, _ = _flash_calls(fa, q * PEAKY, k * PEAKY, v, do,
                                            causal)
                peaky = {}
                for n in FLASH_PRODUCTS:
                    got, ref = _tuple(pk[n]()), _tuple(pp[n]())
                    errs = [float((g - r).abs().max())
                            for g, r in zip(got, ref)]
                    if n == "flash_fwd":
                        peaky["flash_fwd_out"], peaky["flash_fwd_lse"] = errs
                    else:
                        peaky[n] = max(errs)
                _print(f"[flash] peaky {shape}, q and k x {PEAKY}: "
                       "max_abs_err " + " ".join(
                           f"{n}={e:.3e}" for n, e in peaky.items()))
                del pk, pp
            del q, k, v, do, kernels, plains
            torch.cuda.empty_cache()

    # -- phase 7: train through the port's CLI entry, bf16
    train_launches = _train_phase(train_lm, fa, "bfloat16", smi)

    # -- phase 7b: the same in f32, the CLI's default dtype
    train_launches_f32 = _train_phase(train_lm, fa, None, smi)

    # -- phase 8: a training step through the kernels == the plain one, f32
    rng = np.random.default_rng(8)
    batches = [torch.from_numpy(rng.integers(0, 50257, (2, 1024))).cuda()
               for _ in range(3)]
    runs = {}
    for impl in ("flash", "xla"):
        model = get_model("gpt_small", num_layers=TRAIN_LAYERS_EXACT,
                          attn_impl=impl)
        state = create_lm_train_state(model, init_params(model, 3, "cuda"))
        step = make_lm_train_step(model, sgd(0.1))
        losses = [float(step(state, b)[1]["loss"]) for b in batches]
        runs[impl] = (losses, state.params.clone())
        del model, state
    loss_err = max(abs(a - b) for a, b in zip(runs["flash"][0],
                                              runs["xla"][0]))
    param_err = float((runs["flash"][1] - runs["xla"][1]).abs().max())
    if not (loss_err <= EXACT_LOSS_TOL and param_err <= EXACT_PARAM_TOL):
        raise AssertionError(
            f"flash vs xla training: loss err {loss_err} (tol "
            f"{EXACT_LOSS_TOL}), param err {param_err} (tol "
            f"{EXACT_PARAM_TOL})")
    _print(f"[train-exact] gpt_small {TRAIN_LAYERS_EXACT} layers f32, 3 SGD "
           f"steps B=2 S=1024: losses flash {runs['flash'][0]} xla "
           f"{runs['xla'][0]}, max loss err {loss_err:.3e} (tol "
           f"{EXACT_LOSS_TOL}), max param err {param_err:.3e} (tol "
           f"{EXACT_PARAM_TOL})")

    # -- phase 9: the fused SGD kernel against its plain version
    sgd_worst = 0.0
    for n in SGD_SIZES:
        for nesterov in (True, False):
            kp, kb, kinit, kcount = _sgd_steps(torch, fused_sgd_, n, nesterov,
                                               impl="cuda")
            pp, pb, pinit, pcount = _sgd_steps(torch, torch_fused_sgd_, n,
                                               nesterov)
            err = max(float((kp - pp).abs().max()),
                      float((kb - pb).abs().max()))
            if not (err <= 0.0 and (kinit, kcount) == (pinit, pcount)
                    == (True, 3)):
                raise AssertionError(
                    f"fused_sgd N={n} nesterov={nesterov}: max|err| {err} "
                    f"(tol 0), flags {(kinit, kcount)} vs {(pinit, pcount)}")
            sgd_worst = max(sgd_worst, err)
    sgd_t = _time_sgd(torch, fused_sgd_, torch_fused_sgd_, SGD_SIZES[0], rate)
    _print(f"[sgd] fused_sgd N={SGD_SIZES[0]} (and {SGD_SIZES[1]}), 4 steps "
           f"incl. first and skipped, nesterov on/off: max_abs_err="
           f"{sgd_worst:.3e} (tol 0) ms={sgd_t['ms']:.5f} "
           f"eager_ms={sgd_t['eager_ms']:.5f} "
           f"plain_ms={sgd_t['plain_ms']:.5f} "
           f"library_ms={sgd_t['library_ms']:.5f} (torch._fused_sgd_) "
           f"library_step_ms={sgd_t['library_step_ms']:.5f} "
           f"(SGD(fused=True).step(), eager) "
           f"bound_ms={sgd_t['bound_ms']:.5f} ({sgd_t['bound_by']}) "
           f"[{smi}]")

    # -- phase 10: train the image model through the port's CLI entry
    torch.backends.cuda.matmul.allow_tf32 = False  # PyTorch's defaults:
    torch.backends.cudnn.allow_tf32 = True  # the CLI's setting
    os.environ["PMDT_SMALL_SYNTH"] = "8192"
    fused_sgd_.launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        summary = image_main.main([
            "--device", "cuda", "--world_size", "1", "--model", "res",
            "--synthetic", "--optimizer", "sgd_fused", "--batch_size", "64",
            "--epochs", "1", "--seed", "0", "--print-freq", "16",
            "--save_path", tmp])
        wall = time.perf_counter() - t0
        missing = [f for f in ("train.log", "test.log", "model_1.pth",
                               "model_1.pth.sha256", "test_accuracy.png",
                               "loss.png", "main.py")
                   if not os.path.exists(os.path.join(tmp, f))]
    image_launches = fused_sgd_.launches
    if missing:
        raise AssertionError(f"main wrote no {missing}")
    if summary["steps"] != IMAGE_STEPS:
        raise AssertionError(
            f"main ran {summary['steps']}/{IMAGE_STEPS} train steps")
    if (image_launches != IMAGE_STEPS
            or summary["launches"]["fused_sgd"] != IMAGE_STEPS):
        raise AssertionError(
            f"fused_sgd launched {image_launches} times (the CLI counted "
            f"{summary['launches']}); expected one per train step, "
            f"{IMAGE_STEPS}")
    loss = summary["epoch_losses"][0]
    if not math.isfinite(loss) or not loss < summary["first_loss"]:
        raise AssertionError(
            f"epoch loss {loss} is not finite and below the first printed "
            f"loss {summary['first_loss']}")
    _print(f"[image-train] ResNet-18 f32 (cuDNN TF32 on) B=64, "
           f"{IMAGE_STEPS} steps + {IMAGE_EVALS} eval batches: wall "
           f"{wall:.2f} s, first loss {summary['first_loss']:.4f}, epoch "
           f"loss {loss:.4f}, test accuracy {summary['test_acc'][0]:.2f}, "
           f"images/s {summary['images_per_sec']:.1f}, steady step "
           f"{summary['steady_step_s'] * 1e3:.3f} ms, launches "
           f"{image_launches} [{smi}]")

    # -- phase 11: sgd == sgd_fused through 3 full-width steps, f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    x, y = synthetic_cifar10(3 * 64, seed=11)
    images = torch.from_numpy(normalize(x)).cuda().view(3, 64, 32, 32, 3)
    labels = torch.from_numpy(y).cuda().view(3, 64)
    runs = {}
    for opt_name, make in (("sgd", sgd), ("sgd_fused", sgd_fused)):
        model = init_resnet(get_model("res"), 3).cuda()
        state = create_train_state(model)
        step = make_train_step(model, make(0.1))
        losses = [float(step(state, xb, yb)[1]["loss"])
                  for xb, yb in zip(images, labels)]
        runs[opt_name] = (losses, state.params.clone(), state.stats.clone())
        del model, state
    img_errs = (max(abs(a - b) for a, b in zip(runs["sgd"][0],
                                               runs["sgd_fused"][0])),
                float((runs["sgd"][1] - runs["sgd_fused"][1]).abs().max()),
                float((runs["sgd"][2] - runs["sgd_fused"][2]).abs().max()))
    if not max(img_errs) <= IMAGE_EXACT_TOL:
        raise AssertionError(
            f"sgd vs sgd_fused image training: loss/param/stat errors "
            f"{img_errs} (tol {IMAGE_EXACT_TOL})")
    _print(f"[image-exact] ResNet-18 f32 (TF32 off, deterministic cuDNN), "
           f"3 steps B=64: losses sgd {runs['sgd'][0]} sgd_fused "
           f"{runs['sgd_fused'][0]}, max loss/param/stat err "
           f"{img_errs} (tol {IMAGE_EXACT_TOL})")

    # -- phase 12: the int8 and paged decode variants against plain
    variant_worst = {name: 0.0 for name in VARIANTS}
    variant_main = {}
    for variant in VARIANTS:
        for dtype in (torch.float32, torch.bfloat16):
            tname = str(dtype).split(".")[1]
            for w in PAGED_WINDOWS:
                q, k, v, table, pos = _variant_case(torch, quantize_kv,
                                                    variant, w, dtype,
                                                    seed=w + 7)
                kernel, plain = _variant_calls(da, variant, q, k, v, table,
                                               pos, w)
                got, again = kernel(), kernel()
                torch.cuda.synchronize()
                ref = plain()
                err = float((got - ref).abs().max())
                if not (bool(torch.isfinite(got).all())
                        and err <= PAGED_TOL):
                    raise AssertionError(
                        f"{variant} {tname} W={w}: max|err| {err} > "
                        f"{PAGED_TOL} (or not finite)")
                if not (torch.equal(got, again)
                        and torch.equal(_graph_bits(kernel, torch), got)):
                    raise AssertionError(
                        f"{variant} {tname} W={w}: two calls, or the graph "
                        "replay and the eager call, differ")
                variant_worst[variant] = max(variant_worst[variant], err)
                paging = (f" page_size={PAGE_SIZE}" if table is not None
                          else "")
                line = (f"[paged-kernel] {variant} {tname} N=8 H=12 Dh=64 "
                        f"W={w}{paging} ({DECODE_KERNELS}: "
                        f"{_plan_text(da, q, w)}) positions={pos.tolist()} "
                        f"max_abs_err={err:.3e} (tol {PAGED_TOL}), two calls "
                        "and the graph replay bit-equal")
                if dtype == torch.bfloat16 and w == max(PAGED_WINDOWS):
                    t = _time_variant(torch, F, da, variant, q, k, v, table,
                                      pos, w, rate)
                    variant_main[variant] = dict(
                        t, shape=f"bf16 N=8 H=12 Dh=64 W={w}{paging}"
                        + (" int8 KV" if VARIANTS[variant][3] else ""))
                    line += (f" ms={t['ms']:.5f} (L2-warm) "
                             f"cold_ms={t['cold_ms']:.5f} (L2-cold) "
                             f"eager_ms={t['eager_ms']:.5f}"
                             f" plain_ms={t['plain_ms']:.5f} "
                             f"library_ms={t['library_ms']:.5f} "
                             f"bound_ms={t['bound_ms']:.5f} "
                             f"({t['bound_by']}) [{smi}]")
                _print(line)
                del q, k, v, table, pos
    # a dense window and the same columns in shuffled pages: one order
    for quant in (False, True):
        for dtype in (torch.float32, torch.bfloat16):
            for w in PAGED_WINDOWS:
                if quant:
                    q, k, v, _, pos = _variant_case(
                        torch, quantize_kv, "decode_attention_int8", w,
                        dtype, seed=w + 12)
                else:
                    q, k, v, pos = _decode_inputs(torch, w, dtype,
                                                  seed=w + 12)
                kp, vp, table = _paged_twin(torch, da, k, v, pos, w,
                                            seed=w + 12, rows=1)
                dense = da.decode_attention(q, k, v, pos, impl="cuda")
                paged = da.paged_decode_attention(q, kp, vp, table, pos,
                                                  window=w, impl="cuda")
                torch.cuda.synchronize()
                if not (torch.equal(dense, paged)
                        and bool(torch.isfinite(paged).all())):
                    raise AssertionError(
                        f"decode int8={quant} {dtype} W={w}: dense and "
                        "paged differ on the same columns")
                del q, k, v, kp, vp, table, pos
    _print("[paged-kernel] dense == paged bit for bit on the same columns "
           f"(page_size={PAGE_SIZE}, shuffled, scratch page 0 of NaN/1e30): "
           f"model dtype and int8, f32 and bf16, W={list(PAGED_WINDOWS)}")
    # where a call's device time goes, and the split size, at bf16 W=1024
    w = max(PAGED_WINDOWS)
    q, k, v, pos = _decode_inputs(torch, w, torch.bfloat16, seed=w)
    counts = _decode_counts(da)
    decode_us = _split_profile(
        torch, lambda: da.decode_attention(q, k, v, pos, impl="cuda"),
        ("decode_split_kernel", "decode_merge_kernel"))
    _print(f"[paged-kernel] profile decode_attention bf16 N=8 H=12 Dh=64 "
           f"W={w} ({_plan_text(da, q, w)}; torch.profiler, "
           f"{PROFILE_CALLS} eager calls): "
           + ", ".join(f"{name} {t:.3f} us a call" if t is not None
                       else f"{name} not measured"
                       for name, t in decode_us.items()) + f" [{smi}]")
    for variant in ("decode_attention",) + tuple(VARIANTS):
        if variant != "decode_attention":
            q, k, v, table, pos = _variant_case(
                torch, quantize_kv, variant, w, torch.bfloat16, seed=w + 7)
        else:
            table = None
        paging = f" page_size={PAGE_SIZE}" if table is not None else ""
        times = _decode_split_ab(torch, da, variant, (q, k, v, table, pos), w)
        _print(f"[decode-ab] {variant} bf16 N=8 H=12 Dh=64 W={w}{paging}: "
               + ", ".join(
                   f"split {split} {statistics.mean(warm) * 1e3:.3f} us "
                   f"L2-warm ({warm[0] * 1e3:.3f} / {warm[1] * 1e3:.3f}), "
                   f"{statistics.mean(cold) * 1e3:.3f} us L2-cold "
                   f"({cold[0] * 1e3:.3f} / {cold[1] * 1e3:.3f})"
                   for split, (warm, cold) in times.items())
               + f" (default {da.DECODE_SPLIT}) [{smi}]")
        del q, k, v, table, pos
    _set_decode_counts(da, counts)

    # -- phase 13: serve paged, paged int8 and dense int8 through the CLI
    serve_runs = (
        ("paged_decode_attention", SERVE_PAGED),
        ("paged_decode_attention_int8", SERVE_PAGED + ["--kv_dtype", "int8"]),
        ("decode_attention_int8", ["--kv_dtype", "int8"]),
    )
    variant_launches = {}
    for variant, extra in serve_runs:
        _zero_decode_counts(da)
        t0 = time.perf_counter()
        psnap = serve_lm.main(SERVE_BASE + extra)
        wall = time.perf_counter() - t0
        counts = _decode_counts(da)
        variant_launches[variant] = counts[variant]
        if psnap["requests_completed"] != 16:
            raise AssertionError(
                f"{variant}: served {psnap['requests_completed']}/16")
        steps = round(psnap["decode_horizon_avg"]
                      * psnap["decode_dispatches"])
        want = {name: (12 * steps if name == variant else 0)
                for name in counts}
        if steps < 1 or counts != want:
            raise AssertionError(
                f"{variant} serve: launches {counts} over {steps} decode "
                f"steps; expected {want}")
        held = psnap.get("pages_in_use", 0) - psnap.get(
            "prefix_cache_pages", 0)
        if held != 0:
            raise AssertionError(
                f"{variant} serve: {held} page(s) still held by requests "
                "after the drain")
        small = get_model("gpt_small", dtype=torch.bfloat16)
        dense_bytes = {kv: 8 * SlotPool.per_slot_kv_bytes(small, 1024, kv)
                       for kv in ("model", "int8")}
        _print(f"[serve-paged] {variant}: gpt_small bf16 16 requests x 32 "
               f"tokens, 8 slots, horizon 4, {' '.join(extra)}: wall "
               f"{wall:.2f} s, decode steps {steps}, launches {counts}, "
               f"decode tokens/s {psnap['decode_tokens_per_sec']:.1f}, "
               f"TTFT p50 {psnap['ttft_p50_s'] * 1e3:.1f} ms p99 "
               f"{psnap['ttft_p99_s'] * 1e3:.1f} ms, pages_in_use "
               f"{psnap.get('pages_in_use', '-')} (prefix cache "
               f"{psnap.get('prefix_cache_pages', '-')}, requests 0), "
               f"prefix misses/hits {psnap['prefix_misses']}/"
               f"{psnap['prefix_hits']}, page holds "
               f"{psnap['page_holds']}, KV pool bytes "
               f"{psnap['kv_pool_bytes']} vs dense bf16 s_max 1024 "
               f"{dense_bytes['model']} (dense int8 {dense_bytes['int8']}) "
               f"[{smi}]")

    # -- phase 14: paged == dense == generate on the card, f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = get_model("gpt_small", dtype=torch.float32)
    model.load_state_dict(init_params(model, 1, "cuda"), assign=True)
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, model.vocab_size, (n,)).tolist()
               for n in (5, 11, 17, 23)]
    common = dict(max_slots=4, s_max=64, decode_horizon=4)
    paged_kw = dict(kv_layout="paged", page_size=PAGE_SIZE, prefix_cache=8)

    def transcripts(reqs, **kw):
        return [r.tokens for r in ServingEngine(
            model, **common, **kw).serve([(p, 12) for p in reqs])]

    want = [generate(model, torch.tensor([p], device="cuda"),
                     max_new_tokens=12)[0, -12:].tolist() for p in prompts]
    if not transcripts(prompts) == transcripts(prompts, **paged_kw) == want:
        raise AssertionError("paged, dense and generate disagree (f32)")
    engine = ServingEngine(model, **common, **paged_kw)
    diverged = prompts[3][:PAGE_SIZE] + [7, 8, 9]
    first = engine.serve([(prompts[3], 12)])[0]
    full, partial = engine.serve([(prompts[3], 12), (diverged, 12)])
    tail = generate(model, torch.tensor([diverged], device="cuda"),
                    max_new_tokens=12)[0, -12:].tolist()
    if not ((first.tokens, full.tokens, partial.tokens)
            == (want[3], want[3], tail)
            and (full.prefix_hit, partial.prefix_hit)
            == ("full", "partial")):
        raise AssertionError(
            f"prefix hits: full {full.prefix_hit} {full.tokens} vs "
            f"{want[3]}, partial {partial.prefix_hit} {partial.tokens} vs "
            f"{tail}")
    int8_paged = transcripts(prompts, kv_dtype="int8", **paged_kw)
    int8_dense = transcripts(prompts, kv_dtype="int8")
    if int8_paged != int8_dense:
        raise AssertionError(
            f"int8 paged {int8_paged} != int8 dense {int8_dense}")
    _print(f"[paged-exact] gpt_small f32: 4 requests, paged == dense == "
           f"generate; full hit and partial hit == generate; int8 paged "
           f"== int8 dense (agrees with the model-dtype stream on "
           f"{sum(a == b for a, b in zip(int8_dense, want))}/4 requests)")

    # -- phase 15: the verify variants against their plain versions
    verify_worst = {name: 0.0 for name in VERIFY_VARIANTS}
    verify_main = {}
    for variant in VERIFY_VARIANTS:
        for dtype in (torch.float32, torch.bfloat16):
            tname = str(dtype).split(".")[1]
            for w in PAGED_WINDOWS:
                q, k, v, table, pos = _verify_case(torch, quantize_kv,
                                                   variant, w, dtype,
                                                   seed=w + 15)
                kernel, plain = _verify_calls(da, q, k, v, table, pos, w)
                got = kernel()
                again = kernel()
                torch.cuda.synchronize()
                ref = plain()
                err = float((got - ref).abs().max())
                if not (bool(torch.isfinite(got).all())
                        and err <= VERIFY_TOL):
                    raise AssertionError(
                        f"{variant} {tname} W={w} K1={VERIFY_ROWS}: "
                        f"max|err| {err} > {VERIFY_TOL} (or not finite)")
                if not torch.equal(got, again):
                    raise AssertionError(
                        f"{variant} {tname} W={w}: two calls differ")
                verify_worst[variant] = max(verify_worst[variant], err)
                paging = (f" page_size={PAGE_SIZE}" if table is not None
                          else "")
                line = (f"[verify-kernel] {variant} {tname} N=8 K1="
                        f"{VERIFY_ROWS} H=12 Dh=64 W={w}{paging} positions="
                        f"{pos.tolist()} max_abs_err={err:.3e} (tol "
                        f"{VERIFY_TOL}), two calls bit-equal")
                if dtype == torch.bfloat16 and w == max(PAGED_WINDOWS):
                    t = _time_verify(torch, F, da, q, k, v, table, pos, w,
                                     rate)
                    verify_main[variant] = dict(
                        t, shape=f"bf16 N=8 K1={VERIFY_ROWS} H=12 Dh=64 "
                        f"W={w}{paging}"
                        + (" int8 KV" if VERIFY_VARIANTS[variant][3]
                           else ""))
                    line += (f" ms={t['ms']:.5f} eager_ms={t['eager_ms']:.5f}"
                             f" plain_ms={t['plain_ms']:.5f} "
                             f"library_ms={t['library_ms']:.5f} "
                             f"bound_ms={t['bound_ms']:.5f} "
                             f"({t['bound_by']}) [{smi}]")
                _print(line)
                del q, k, v, table, pos
    for variant in ("verify_decode_attention", "verify_decode_attention_int8"):
        for dtype in (torch.float32, torch.bfloat16):
            for w in PAGED_WINDOWS:
                q, k, v, _, pos = _verify_case(torch, quantize_kv, variant,
                                               w, dtype, seed=w + 16)
                kp, vp, table = _paged_twin(torch, da, k, v, pos, w, seed=w)
                dense = da.verify_decode_attention(q, k, v, pos, impl="cuda")
                paged = da.paged_verify_decode_attention(
                    q, kp, vp, table, pos, window=w, impl="cuda")
                torch.cuda.synchronize()
                if not (torch.equal(dense, paged)
                        and bool(torch.isfinite(paged).all())):
                    raise AssertionError(
                        f"{variant} {dtype} W={w}: dense and paged verify "
                        "differ on the same columns")
                del q, k, v, kp, vp, table, pos
    _print("[verify-kernel] dense == paged bit for bit on the same columns "
           f"(page_size={PAGE_SIZE}, shuffled, scratch page 0 of NaN/1e30): "
           f"model dtype and int8, f32 and bf16, W={list(PAGED_WINDOWS)}")
    w = max(PAGED_WINDOWS)
    for rows in VERIFY_SWEEP:
        q, k, v, table, pos = _verify_case(
            torch, quantize_kv, "verify_decode_attention", w,
            torch.bfloat16, seed=w + rows, rows=rows)
        kernel, plain = _verify_calls(da, q, k, v, table, pos, w)
        err = float((kernel() - plain()).abs().max())
        if not err <= VERIFY_TOL:
            raise AssertionError(
                f"verify_decode_attention bf16 W={w} K1={rows}: max|err| "
                f"{err} > {VERIFY_TOL}")
        t = _time_verify(torch, F, da, q, k, v, table, pos, w, rate)
        _print(f"[verify-kernel] sweep verify_decode_attention bf16 N=8 "
               f"K1={rows} H=12 Dh=64 W={w} positions={pos.tolist()} "
               f"max_abs_err={err:.3e} ms={t['ms']:.5f} "
               f"eager_ms={t['eager_ms']:.5f} plain_ms={t['plain_ms']:.5f} "
               f"library_ms={t['library_ms']:.5f} "
               f"bound_ms={t['bound_ms']:.5f} ({t['bound_by']}) [{smi}]")
        del q, k, v, table, pos
    q, k, v, table, pos = _verify_case(torch, quantize_kv,
                                       "verify_decode_attention", w,
                                       torch.bfloat16, seed=w + 15)
    split_us = _split_profile(
        torch, _verify_calls(da, q, k, v, table, pos, w)[0],
        ("verify_split_kernel", "verify_merge_kernel"))
    _print(f"[verify-kernel] profile verify_decode_attention bf16 N=8 "
           f"K1={VERIFY_ROWS} H=12 Dh=64 W={w} (torch.profiler, "
           f"{PROFILE_CALLS} eager calls): "
           + ", ".join(f"{name} {t:.3f} us a call" if t is not None
                       else f"{name} not measured"
                       for name, t in split_us.items()) + f" [{smi}]")
    del q, k, v, table, pos
    default_split = da.VERIFY_SPLIT
    for variant in VERIFY_VARIANTS:
        q, k, v, table, pos = _verify_case(torch, quantize_kv, variant, w,
                                           torch.bfloat16, seed=w + 15)
        kernel, plain = _verify_calls(da, q, k, v, table, pos, w)
        ref = plain()
        times = {split: [] for split in VERIFY_AB_SPLITS}
        try:
            for split in VERIFY_AB_SPLITS + VERIFY_AB_SPLITS[::-1]:
                da.VERIFY_SPLIT = split
                err = float((kernel() - ref).abs().max())
                if not err <= VERIFY_TOL:
                    raise AssertionError(
                        f"{variant} split {split}: max|err| {err} > "
                        f"{VERIFY_TOL}")
                times[split].append(_device_ms(kernel, torch))
        finally:
            da.VERIFY_SPLIT = default_split
        _print(f"[verify-ab] {variant} bf16 N=8 K1={VERIFY_ROWS} H=12 Dh=64 "
               f"W={w}: " + ", ".join(
                   f"split {split} {statistics.mean(ms) * 1e3:.3f} us "
                   f"({ms[0] * 1e3:.3f} / {ms[1] * 1e3:.3f})"
                   for split, ms in times.items())
               + f" (default {default_split}) [{smi}]")
        del q, k, v, table, pos

    # -- phase 16: serve speculatively through the CLI
    spec_launches = {name: 0 for name in VERIFY_VARIANTS}
    spec_base = [a for a in SERVE_BASE if a != "--quiet"]
    for variant, decode_variant, extra in SPEC_RUNS:
        draft_model = "--draft_model" in extra
        _zero_decode_counts(da)
        t0 = time.perf_counter()
        ssnap, spec_out = _serve_transcripts(
            serve_lm, spec_base + extra + ["--draft_k", str(DRAFT_K)])
        wall = time.perf_counter() - t0
        counts = _decode_counts(da)
        spec_launches[variant] += counts[variant]
        if ssnap["requests_completed"] != 16 or len(spec_out) != 16:
            raise AssertionError(
                f"{variant} spec serve: {ssnap['requests_completed']}/16 "
                "requests")
        passes = {int(k): n for k, n in ssnap["decode_passes_by_k"].items()}
        armed = sum(n for k, n in passes.items() if k)
        plain_passes = passes.get(0, 0)
        want = {name: 0 for name in counts}
        want[variant] = 12 * armed
        want[decode_variant] = 12 * plain_passes + (
            DRAFT_LAYERS * (DRAFT_K + 1) * armed if draft_model else 0)
        if armed < 1 or counts != want:
            raise AssertionError(
                f"{variant} spec serve ({' '.join(extra)}): launches "
                f"{counts} over passes {passes}; expected {want}")
        held = ssnap.get("pages_in_use", 0) - ssnap.get(
            "prefix_cache_pages", 0)
        if held != 0:
            raise AssertionError(
                f"{variant} spec serve: {held} page(s) still held by "
                "requests after the drain")
        bsnap, base_out = _serve_transcripts(
            serve_lm, [a for a in spec_base + extra
                       if a not in ("--draft_model", "gpt_tiny")])
        same = sum(spec_out[u] == base_out.get(u) for u in spec_out)
        _print(f"[serve-spec] {variant}{' (draft model gpt_tiny)' if draft_model else ''}: "
               f"gpt_small bf16 16 requests x 32 tokens, 8 slots, horizon "
               f"4, --draft_k {DRAFT_K} {' '.join(extra)}: wall "
               f"{wall:.2f} s, passes by k {passes}, launches "
               f"{ {n: c for n, c in counts.items() if c} }, decode "
               f"tokens/s {ssnap['decode_tokens_per_sec']:.1f} (without "
               f"--draft_k {bsnap['decode_tokens_per_sec']:.1f}), "
               f"spec_accept_rate {ssnap['spec_accept_rate']:.4f}, "
               f"spec_accepted_per_target_step "
               f"{ssnap['spec_accepted_per_target_step']:.4f}, TTFT p50 "
               f"{ssnap['ttft_p50_s'] * 1e3:.1f} ms p99 "
               f"{ssnap['ttft_p99_s'] * 1e3:.1f} ms (without "
               f"{bsnap['ttft_p50_s'] * 1e3:.1f} / "
               f"{bsnap['ttft_p99_s'] * 1e3:.1f} ms), KV pool bytes "
               f"{ssnap['kv_pool_bytes']} (without "
               f"{bsnap['kv_pool_bytes']}), transcripts equal to the run "
               f"without --draft_k: {same}/16 [{smi}]")

    # -- phase 17: speculative == generate on the card, f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = get_model("gpt_small", dtype=torch.float32)
    params = init_params(model, 1, "cuda")
    model.load_state_dict(params, assign=True)
    rng = np.random.default_rng(17)
    prompts = [rng.integers(0, model.vocab_size, (n,)).tolist()
               for n in (5, 11, 17, 23)]
    reqs = [(p, 12) for p in prompts] + [(prompts[3], 64 - 23)]
    common = dict(max_slots=4, s_max=64, decode_horizon=4)
    paged_kw = dict(kv_layout="paged", page_size=PAGE_SIZE, prefix_cache=8)

    def spec_transcripts(**kw):
        engine = ServingEngine(model, **common, **kw)
        return [r.tokens for r in engine.serve(reqs)], engine

    want = [generate(model, torch.tensor([p], device="cuda"),
                     max_new_tokens=n)[0, -n:].tolist() for p, n in reqs]
    exact = {}
    for label, kw in (
            ("dense", dict(draft_k=DRAFT_K)),
            ("paged", dict(draft_k=DRAFT_K, **paged_kw)),
            ("draft-model", dict(draft_k=DRAFT_K,
                                 draft_model=get_model(
                                     "gpt_small", dtype=torch.float32),
                                 draft_params=params))):
        got, engine = spec_transcripts(**kw)
        esnap = engine.metrics.snapshot()
        if got != want:
            raise AssertionError(
                f"spec {label} != generate (f32): {got} vs {want}")
        exact[label] = (esnap["spec_verify_passes"],
                        round(esnap["spec_accept_rate"], 4))
        del engine
    int8_paged, _ = spec_transcripts(draft_k=DRAFT_K, kv_dtype="int8",
                                     **paged_kw)
    int8_dense, _ = spec_transcripts(draft_k=DRAFT_K, kv_dtype="int8")
    int8_plain, _ = spec_transcripts(kv_dtype="int8")
    if not int8_paged == int8_dense == int8_plain:
        raise AssertionError(
            f"int8 spec paged {int8_paged} / dense {int8_dense} != "
            f"non-spec int8 {int8_plain}")
    _print(f"[spec-exact] gpt_small f32: 5 requests (one to s_max 64), "
           f"draft_k {DRAFT_K}, horizon 4: dense, paged and draft-model "
           f"(target as its own draft) speculative == generate; int8 "
           f"paged == int8 dense == non-speculative int8 (== generate on "
           f"{sum(a == b for a, b in zip(int8_dense, want))}/5); (verify "
           f"passes, accept rate) {exact}")
    del model, params

    # -- phase 18: the ring kernel in loopback against its plain version
    ring_worst = 0.0
    for n in (2, 4, 8):
        for call in range(RING_CALLS):
            shape = RING_SHAPES[call % len(RING_SHAPES)]
            dtype = (torch.float32, torch.bfloat16)[
                (call // len(RING_SHAPES)) % 2]
            xs = _ring_inputs(torch, n, shape, dtype, seed=1000 * n + call)
            got = ring.ring_all_reduce_loopback(xs, impl="cuda")
            want = ring.torch_ring_all_reduce(xs)
            torch.cuda.synchronize()
            err = max(float((g.float() - w.float()).abs().max())
                      for g, w in zip(got, want))
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                raise AssertionError(
                    f"ring loopback n={n} call {call} {shape} {dtype}: "
                    f"not bit-equal to the plain version (max|err| {err})")
            ring_worst = max(ring_worst, err)
            del xs, got, want
        _print(f"[ring-loopback] n={n}: {RING_CALLS} consecutive calls on "
               f"fresh inputs, shapes {list(RING_SHAPES)}, f32 then bf16: "
               f"bit-equal to the plain version (tol 0), max_abs_err "
               f"{ring_worst:.3e}")
    torch.cuda.empty_cache()
    ring_t = _time_ring(torch, ring, RING_MAIN_N, RING_MAIN_SIZE, rate)
    ring_mb = repr(RING_MAIN_SIZE * 4 / 2 ** 20)  # exactly N f32 elements
    ring.ring_all_reduce_loopback.launches = 0
    loop_lines = allreduce_bw.main([
        "--device", "cuda", "--loopback", str(RING_MAIN_N), "--sizes-mb",
        ring_mb, "--iters", str(RING_ITERS)])
    ring_launches = ring.ring_all_reduce_loopback.launches
    if ring_launches != RING_ITERS + 1 or loop_lines[0]["launches"] != \
            ring_launches:
        raise AssertionError(
            f"allreduce_bw --loopback launched the ring {ring_launches} "
            f"times (the entry counted {loop_lines[0]['launches']}); "
            f"expected {RING_ITERS + 1}")
    g_loop = ring.loopback_plan(RING_MAIN_SIZE, RING_MAIN_N,
                                torch.device("cuda")).blocks
    _print(f"[ring-loopback] ring_all_reduce f32 n={RING_MAIN_N} "
           f"N={RING_MAIN_SIZE}, G_loop={g_loop} blocks a rank "
           f"({ring.RING_THREADS} data threads, steps of "
           f"{ring.RING_STEP} elements, K={ring.RING_SLOTS}): "
           f"ms={ring_t['ms']:.5f} wrapper_ms={ring_t['wrapper_ms']:.5f} "
           f"eager_ms={ring_t['eager_ms']:.5f} "
           f"plain_ms={ring_t['plain_ms']:.5f} "
           f"library_ms={ring_t['library_ms']:.5f} (torch.sum over the "
           f"stacked ranks) bound_ms={ring_t['bound_ms']:.5f} "
           f"({ring_t['bound_by']}); allreduce_bw --loopback "
           f"{RING_MAIN_N}: {loop_lines[0]['time_ms']:.5f} ms a call, "
           f"{loop_lines[0]['bus_gb_per_sec']:.2f} GiB/s bus, launches "
           f"{ring_launches} [{smi}]")
    for d in allreduce_bw.main([
            "--device", "cuda", "--loopback", str(RING_MAIN_N),
            "--sizes-mb", ring_mb, "--iters", str(RING_ITERS),
            "--ring_configs", *_ring_ab(ring)])[1:]:
        _print(f"[ring-ab] loopback n={RING_MAIN_N} N={RING_MAIN_SIZE} "
               f"G:T:S:K:C={d['config']}: {d['time_ms']:.5f} ms (turns "
               f"{d['turn_ms'][0]:.5f}, {d['turn_ms'][1]:.5f}) [{smi}]")

    # -- phase 19: the ring across cards through the allreduce_bw entry
    cards = torch.cuda.device_count()
    _print(f"[ring-xcard] {_topology(torch)}")
    xcard = dict.fromkeys(("world", "ms", "bus_gb_per_sec", "bound_ms",
                           "library_ms", "library_bus_gb_per_sec",
                           "launches", "max_abs_err", "shape", "comm_bytes",
                           "64mib_ms", "64mib_bound_ms", "64mib_library_ms",
                           "4kib_ms", "4kib_library_ms"))
    if cards < 2:
        _print(f"[ring-xcard] not run: {cards} CUDA card visible, the "
               "cross-card ring needs two or more (phase 18 ran the kernel "
               "in loopback)")
    else:
        world = min(cards, 4)
        torch.cuda.empty_cache()
        sizes_mb = [repr(b / 2 ** 20) for b in RING_XCARD_BYTES]
        lines = allreduce_bw.main([
            "--device", "cuda", "--world_size", str(world), "--ring",
            "--check", "--sizes-mb", *sizes_mb, "--iters",
            str(RING_ITERS)])
        psums = [d for d in lines if d["metric"].startswith("psum_")]
        rings = [d for d in lines
                 if d["metric"] == "cuda_ring_allreduce_bus_bw"]
        if len(psums) != len(RING_XCARD_BYTES) or len(rings) != len(psums):
            raise AssertionError(f"allreduce_bw printed {lines}")
        for d in rings:
            if d["max_abs_err"] != 0.0 or d["launches"] != RING_ITERS + 1:
                raise AssertionError(
                    f"cross-card ring at {d['payload_bytes']} B: max|err| "
                    f"{d['max_abs_err']} (tol 0), launches {d['launches']} "
                    f"(expected {RING_ITERS + 1})")
        comm_bytes = ring.ring_plan(RING_MAIN_SIZE, world).comm_bytes
        _print(f"[ring-xcard] comm buffer {comm_bytes} B a rank, fixed "
               f"({ring.RING_BLOCKS} blocks x {ring.RING_SLOTS} slots x "
               f"{ring.RING_STEP} f32, and flags), allocated once")
        by_size = {}
        for p, d, nbytes in zip(psums, rings, RING_XCARD_BYTES):
            plan = ring.ring_plan(nbytes // 4, world)
            bound_ms = 2 * (world - 1) / world * nbytes / \
                NVLINK_BYTES_PER_S * 1e3
            by_size[nbytes] = (d, p, bound_ms)
            _print(f"[ring-xcard] world={world} {nbytes} B: ring "
                   f"{d['time_ms']:.5f} ms {d['bus_gb_per_sec']:.2f} GiB/s "
                   f"bus ({plan.blocks} blocks x {plan.steps} steps a hop "
                   f"of {plan.step} f32), NCCL all_reduce "
                   f"({p['metric']}) {p['time_ms']:.5f} ms "
                   f"{p['bus_gb_per_sec']:.2f} GiB/s, NVLink bound "
                   f"{bound_ms:.5f} ms, launches {d['launches']}, "
                   f"max_abs_err {d['max_abs_err']:.3e} (tol 0) [{smi}]")
        main_d, main_p, main_bound = by_size[RING_XCARD_BYTES[0]]
        big_d, big_p, big_bound = by_size[RING_XCARD_BYTES[1]]
        small_d, small_p, _ = by_size[RING_XCARD_BYTES[2]]
        xcard.update(
            world=world, ms=main_d["time_ms"],
            bus_gb_per_sec=main_d["bus_gb_per_sec"], bound_ms=main_bound,
            library_ms=main_p["time_ms"],
            library_bus_gb_per_sec=main_p["bus_gb_per_sec"],
            shape=f"f32 N={RING_MAIN_SIZE} per rank, {world} cards",
            launches=sum(d["launches"] for d in rings),
            max_abs_err=max(d["max_abs_err"] for d in rings),
            comm_bytes=comm_bytes, **{
                "64mib_ms": big_d["time_ms"], "64mib_bound_ms": big_bound,
                "64mib_library_ms": big_p["time_ms"],
                "4kib_ms": small_d["time_ms"],
                "4kib_library_ms": small_p["time_ms"]})
        for d in allreduce_bw.main([
                "--device", "cuda", "--world_size", str(world), "--ring",
                "--sizes-mb", *sizes_mb[:2], "--iters", str(RING_ITERS),
                "--ring_configs", *_ring_ab(ring)]):
            if d["metric"] == "cuda_ring_ab_allreduce_bus_bw":
                _print(f"[ring-ab] world={world} {d['payload_bytes']} B "
                       f"G:T:S:K:C={d['config']}: {d['time_ms']:.5f} ms "
                       f"(turns {d['turn_ms'][0]:.5f}, "
                       f"{d['turn_ms'][1]:.5f}) [{smi}]")

    # -- phases 20-22: bench.py's ImageNet configs through main at 224
    os.environ["PMDT_SMALL_SYNTH"] = "1"
    torch.backends.cuda.matmul.allow_tf32 = False  # PyTorch's defaults:
    torch.backends.cudnn.allow_tf32 = True  # the CLI's setting
    torch.backends.cudnn.deterministic = False
    imagenet = {}
    for phase, config, flags in IMAGENET_RUNS:
        torch.cuda.reset_peak_memory_stats()
        imagenet[config] = _imagenet_phase(image_main, fused_sgd_, phase,
                                           config, flags, smi)
        if phase == "20":
            # the fused SGD kernel at ResNet-50's N, held and timed
            if imagenet[config][1] != IMAGENET_STEPS:
                raise AssertionError(
                    f"fused_sgd launched {imagenet[config][1]} times in "
                    f"phase 20, expected one per step ({IMAGENET_STEPS})")
            r50_worst = 0.0
            for nesterov in (True, False):
                kp, kb, kf = _sgd_steps(torch, fused_sgd_, R50_PARAMS,
                                        nesterov, impl="cuda")[:3]
                pp, pb, pf = _sgd_steps(torch, torch_fused_sgd_, R50_PARAMS,
                                        nesterov)[:3]
                err = max(float((kp - pp).abs().max()),
                          float((kb - pb).abs().max()))
                if not (err <= 0.0 and kf == pf):
                    raise AssertionError(
                        f"fused_sgd N={R50_PARAMS}: max|err| {err} (tol 0)")
                r50_worst = max(r50_worst, err)
                del kp, kb, pp, pb
            r50_sgd = _time_sgd(torch, fused_sgd_, torch_fused_sgd_,
                                R50_PARAMS, rate)
            _print(f"[imagenet] host: one synthetic train batch of 256 at "
                   f"224 takes {_imagenet_host_ms(256):.1f} ms to assemble "
                   "(median of 3, one thread; the loader's producer thread "
                   "runs it beside the steps)")
            _print(f"[sgd] fused_sgd N={R50_PARAMS} (ResNet-50, 1000 "
                   f"classes), 4 steps incl. first and skipped, nesterov "
                   f"on/off: max_abs_err={r50_worst:.3e} (tol 0) "
                   f"ms={r50_sgd['ms']:.5f} "
                   f"plain_ms={r50_sgd['plain_ms']:.5f} "
                   f"library_ms={r50_sgd['library_ms']:.5f} "
                   f"(torch._fused_sgd_) bound_ms={r50_sgd['bound_ms']:.5f} "
                   f"({r50_sgd['bound_by']}) [{smi}]")
            torch.cuda.empty_cache()

    # -- phase 22 (cont.): the ViT-B/16 block, flash against einsum
    vit = importlib.import_module(
        "pytorch_multiprocessing_distributed_tpu_torch.models.vit")
    torch.backends.cuda.matmul.allow_tf32 = False
    ref32 = _vit_block_check(torch, vit, torch.float32, seed=22)
    f32_err = _block_err(ref32[True], ref32[False])
    tol32 = FLASH_TOL["float32"]["grad"]
    if not f32_err <= tol32:
        raise AssertionError(
            f"ViT block f32: flash vs einsum max|err| {f32_err} (tol "
            f"{tol32})")
    bf = _vit_block_check(torch, vit, torch.bfloat16, seed=22)
    # bf16: both routes against the f32 einsum block; the flash route may
    # stray no further than twice the einsum route (the JAX bf16 rule)
    bf_flash, bf_einsum = (_block_err(bf[f], ref32[False], normwise=True)
                           for f in (True, False))
    if not bf_flash <= 2 * bf_einsum:
        raise AssertionError(
            f"ViT block bf16: flash {bf_flash} vs einsum {bf_einsum} off "
            "the f32 block (flash may be at most twice einsum)")
    _print(f"[vit-block] ViT-B/16 encoder block B={VIT_BLOCK['batch']} "
           f"S={VIT_BLOCK['seq']}, forward and backward: f32 flash vs "
           f"einsum max|err| {f32_err:.3e} (tol {tol32}); bf16 off the f32 "
           f"block, normwise: flash {bf_flash:.3e}, einsum {bf_einsum:.3e} "
           "(flash at most 2x einsum)")
    del ref32, bf
    vs = VIT_FWD_SHAPE
    q, k, v, do = _flash_inputs(torch, vs["batch"], vs["seq"], vs["seq"],
                                vs["heads"], vs["head_dim"], torch.bfloat16,
                                seed=23)
    vit_fwd = _time_flash(torch, F, fa, q, k, v, do, False, rate)[0][
        "flash_fwd"]
    _print(f"[vit-fwd] flash_fwd bf16 non-causal B={vs['batch']} "
           f"H={vs['heads']} S={vs['seq']} Dh={vs['head_dim']}: ms="
           f"{vit_fwd['ms']:.5f} library_ms={vit_fwd['library_ms']:.5f} "
           f"(F.scaled_dot_product_attention) plain_ms="
           f"{vit_fwd['plain_ms']:.5f} bound_ms={vit_fwd['bound_ms']:.5f} "
           f"({vit_fwd['bound_by']}) tflop_per_s="
           f"{vit_fwd['tflop_per_s']:.1f} [{smi}]")
    del q, k, v, do
    torch.cuda.empty_cache()

    # -- phase 23: every attention kernel at head_dims off its tiles
    hd_errs = {}
    for d in ODD_HEAD_DIMS:
        hd_errs[d] = _head_dim_checks(torch, quantize_kv, da, fa, d)
        _print(f"[head-dim] Dh {d}, f32 and bf16, kernel launched and held "
               "against its plain version: max_abs_err " + " ".join(
                   f"row{r}={e:.3e}" for r, e in sorted(hd_errs[d].items())))
    for dtype in (torch.bfloat16, torch.float32):
        wide = torch.zeros(1, 16, 2, 160, dtype=dtype, device="cuda")
        try:
            fa.flash_fwd(wide, wide, wide)
        except ValueError:
            pass
        else:
            raise AssertionError("flash_fwd took Dh 160")
    hd_times = {d: _head_dim_times(torch, quantize_kv, da, fa, d)
                for d in TIMED_HEAD_DIMS}
    for row in ("1", "1q", "2", "2q", "3", "3q", "4", "4q", "5", "6", "7"):
        _print(f"[head-dim-time] row {row}: " + " ".join(
            f"Dh{d}={hd_times[d][row] * 1e3:.2f}us" for d in TIMED_HEAD_DIMS)
            + f" (bf16; decode W={max(WINDOWS)}, flash S="
            f"{FLASH_SHAPE['seq']} causal) [{smi}]")
    # a GPT of head_dim 16 trains and serves through the kernels
    rng = np.random.default_rng(23)
    batches = [torch.from_numpy(rng.integers(0, 50257, (2, 1024))).cuda()
               for _ in range(3)]
    runs = {}
    for impl in ("flash", "xla"):
        model = get_model("gpt_small", attn_impl=impl, **GPT_DH16)
        state = create_lm_train_state(model, init_params(model, 3, "cuda"))
        step = make_lm_train_step(model, sgd(0.1))
        before = fa.flash_fwd.launches
        losses = [float(step(state, b)[1]["loss"]) for b in batches]
        if impl == "flash" and fa.flash_fwd.launches == before:
            raise AssertionError("the Dh 16 GPT did not launch flash_fwd")
        runs[impl] = (losses, state.params.clone())
        del model, state
    loss_err = max(abs(a - b) for a, b in zip(runs["flash"][0],
                                              runs["xla"][0]))
    param_err = float((runs["flash"][1] - runs["xla"][1]).abs().max())
    if not (loss_err <= EXACT_LOSS_TOL and param_err <= EXACT_PARAM_TOL):
        raise AssertionError(
            f"Dh 16 GPT flash vs xla: loss err {loss_err} (tol "
            f"{EXACT_LOSS_TOL}), param err {param_err} (tol "
            f"{EXACT_PARAM_TOL})")
    model = get_model("gpt_small", dtype=torch.float32, **GPT_DH16)
    model.load_state_dict(init_params(model, 1, "cuda"), assign=True)
    prompts = [rng.integers(0, model.vocab_size, (n,)).tolist()
               for n in (5, 11, 17, 23)]
    dh16_launches = da.decode_attention.launches
    engine = ServingEngine(model, max_slots=4, s_max=64, decode_horizon=4)
    served = engine.serve([(p, 12) for p in prompts])
    if da.decode_attention.launches == dh16_launches:
        raise AssertionError("the Dh 16 engine did not launch the kernel")
    for request, prompt in zip(served, prompts):
        ref = generate(model, torch.tensor([prompt], device="cuda"),
                       max_new_tokens=12)[0, -12:].tolist()
        if request.tokens != ref:
            raise AssertionError(
                f"Dh 16 engine {request.tokens} != generate {ref}")
    da.decode_attention.launches = dh16_launches
    _print(f"[head-dim] GPT hidden 512 x 32 heads (Dh 16), f32: 3 SGD steps "
           f"B=2 S=1024 losses flash {runs['flash'][0]} xla "
           f"{runs['xla'][0]}, max loss err {loss_err:.3e} (tol "
           f"{EXACT_LOSS_TOL}), max param err {param_err:.3e} (tol "
           f"{EXACT_PARAM_TOL}); 4 requests through the engine token-exact "
           "with generate")
    del model, engine, runs
    torch.cuda.empty_cache()

    # -- phase 24: the step transforms through main, ResNet-50 at 224
    from pytorch_multiprocessing_distributed_tpu_torch.utils.torch_interop \
        import load_torch_checkpoint

    os.environ["PMDT_SMALL_SYNTH"] = "1"
    torch.backends.cuda.matmul.allow_tf32 = False  # the CLI's settings
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cudnn.deterministic = False
    exported = {}

    def read_export(save_path):
        """The exported state_dict in the port's ResNet-50 against the
        run's checkpoint: its final params and BN stats."""
        model = get_model("resnet50", stem="imagenet", num_classes=1000)
        load_torch_checkpoint(os.path.join(save_path, "model_1.torch.pth"),
                              model)
        payload = torch.load(os.path.join(save_path, "model_1.pth"),
                             map_location="cpu", weights_only=True)
        worst = 0.0
        for name, t in model.state_dict().items():
            group = ("batch_stats" if name.endswith(
                ("running_mean", "running_var")) else "params")
            ref = payload[f"{group}/{name.replace('.', '/')}"]
            worst = max(worst, float((t - ref).abs().max()))
        exported.update(err=worst, tensors=len(model.state_dict()),
                        ema=any(k.startswith("ema_params/") for k in payload))

    torch.cuda.reset_peak_memory_stats()
    t24, t24_launches, t24_peak = _imagenet_phase(
        image_main, fused_sgd_, "24", "resnet50_imagenet",
        IMAGENET_RUNS[0][2] + TRANSFORM_FLAGS + ["--torch_export"], smi,
        inspect=read_export)
    if (t24_launches != IMAGENET_STEPS
            or t24["launches"]["fused_sgd"] != IMAGENET_STEPS):
        raise AssertionError(
            f"fused_sgd launched {t24_launches} times in phase 24, expected "
            f"one per optimizer step ({IMAGENET_STEPS})")
    if exported.get("err") != 0.0 or not exported["ema"]:
        raise AssertionError(
            f"phase 24: the exported state_dict differs from the final "
            f"params by {exported.get('err')} (tol 0), or the checkpoint "
            "has no ema_params")
    r50_peak = imagenet["resnet50_imagenet"][2]
    _print(f"[transforms] phase 24: fused_sgd launches {t24_launches} (one "
           f"per optimizer step), peak memory {t24_peak:.2f} GiB with "
           f"{' '.join(TRANSFORM_FLAGS)} beside phase 20's {r50_peak:.2f} "
           f"GiB without them; model_1.torch.pth read back into ResNet-50: "
           f"{exported['tensors']} tensors, max |diff| {exported['err']} "
           f"against the checkpoint's params and BN stats (tol 0) [{smi}]")
    gen = torch.Generator(device="cuda").manual_seed(24)
    x128 = torch.randn(128, 224, 224, 3, generator=gen, device="cuda")
    y128 = torch.randint(0, 1000, (128,), generator=gen, device="cuda")
    remat_ab = {}
    for remat in (False, True):
        model = init_resnet(get_model("resnet50", stem="imagenet",
                                      num_classes=1000), 0).cuda()
        remat_ab[remat] = _step_peak(torch, model, sgd_fused(0.1),
                                     {"remat": remat}, x128, y128)
        del model
        torch.cuda.empty_cache()
    _print(f"[transforms] ResNet-50 224 f32 one step at batch 128 (phase "
           f"24's microbatch): peak memory {remat_ab[False][0]:.2f} GiB "
           f"without remat, {remat_ab[True][0]:.2f} GiB with; step "
           f"{remat_ab[False][1]:.2f} ms without, {remat_ab[True][1]:.2f} "
           f"ms with (CUDA events, second step) [{smi}]")
    del x128, y128
    _deterministic(torch)
    x, y = synthetic_cifar10(TRANSFORM_STEPS * TRANSFORM_BATCH, seed=24)
    images = torch.from_numpy(normalize(x)).cuda().view(
        TRANSFORM_STEPS, TRANSFORM_BATCH, 32, 32, 3)
    labels = torch.from_numpy(y).cuda().view(TRANSFORM_STEPS,
                                             TRANSFORM_BATCH)
    runs = {}
    for opt_name, make in (("sgd", sgd), ("sgd_fused", sgd_fused)):
        model = init_resnet(get_model("res"), 3).cuda()
        opt = make(0.1)
        state = create_train_state(model, opt, ema=True)
        step = make_train_step(model, opt, **TRANSFORM_KW)
        before = fused_sgd_.launches
        losses = [float(step(state, xb, yb)[1]["loss"])
                  for xb, yb in zip(images, labels)]
        runs[opt_name] = (losses, [t.clone() for t in (
            state.params, state.momentum, state.stats, state.ema)],
            fused_sgd_.launches - before)
        del model, state
    t_errs = [float((a - b).abs().max()) for a, b in zip(
        runs["sgd"][1], runs["sgd_fused"][1])]
    if (runs["sgd"][0] != runs["sgd_fused"][0] or max(t_errs) > 0.0
            or (runs["sgd"][2], runs["sgd_fused"][2])
            != (0, TRANSFORM_STEPS)):
        raise AssertionError(
            f"transforms sgd vs sgd_fused: losses {runs['sgd'][0]} vs "
            f"{runs['sgd_fused'][0]}, param/momentum/stat/EMA errors "
            f"{t_errs} (tol 0), launches {runs['sgd'][2]}, "
            f"{runs['sgd_fused'][2]}")
    one = {}
    for remat in (False, True):
        model = init_resnet(get_model("res"), 3).cuda()
        torch.cuda.reset_peak_memory_stats()
        opt = sgd_fused(0.1)
        state = create_train_state(model, opt)
        make_train_step(model, opt, remat=remat)(state, images[0], labels[0])
        torch.cuda.synchronize()
        one[remat] = (state.params.clone(), state.stats.clone(),
                      torch.cuda.max_memory_allocated() / 2 ** 30)
        del model, state
    remat_errs = (float((one[True][0] - one[False][0]).abs().max()),
                  float((one[True][1] - one[False][1]).abs().max()))
    if max(remat_errs) > 0.0:
        raise AssertionError(f"remat vs no remat: param/stat errors "
                             f"{remat_errs} (tol 0)")
    _print(f"[transforms] ResNet-18 f32 (TF32 off, deterministic cuDNN) "
           f"B={TRANSFORM_BATCH}, {TRANSFORM_STEPS} steps with "
           f"{' '.join(TRANSFORM_FLAGS)}: losses sgd {runs['sgd'][0]} "
           f"sgd_fused {runs['sgd_fused'][0]}, max param/momentum/stat/EMA "
           f"err {t_errs} (tol 0), fused_sgd launches "
           f"{runs['sgd_fused'][2]}; one step remat vs not: param/stat err "
           f"{remat_errs} (tol 0), peak memory {one[True][2]:.2f} GiB with "
           f"remat, {one[False][2]:.2f} GiB without [{smi}]")
    del runs, one, images, labels
    torch.cuda.empty_cache()

    # -- phase 25: --zero through main, across the visible cards
    _zero_phase(torch, image_main, smi)

    # -- phase 26: the GSPMD placements through main, across the cards
    _gspmd_phase(torch, image_main, smi)

    # -- phase 27: sequence parallelism, one card and across the cards
    sp = _sp_phase(torch, fa, F, rate, smi)

    # -- phase 28: pipeline and tensor parallelism, --zero and --remat
    mp = _mp_phase(torch, fa, train_lm, smi)

    # -- phase 29: Mixture of Experts in every mode, dropless decode
    moe = _moe_phase(torch, fa, train_lm, smi, da)

    # -- phase 30: supervised restart, SIGTERM, sharded checkpoints,
    # peer loss, --profile
    heal = _heal_phase(torch, image_main, train_lm, fa, fused_sgd_, smi)

    # -- phase 31: tensor-parallel serving, one card and across the cards
    tp = _tp_phase(torch, serve_lm, F, da, quantize_kv, rate, smi)

    # -- phase 32: fault-tolerant serving, and serving from training
    serve_heal = _serve_heal_phase(torch, serve_lm, train_lm, da, smi)

    # -- phase 33: observability, armed against disarmed
    scope33 = _scope_phase(torch, serve_lm, train_lm, image_main, da, fa,
                           fused_sgd_, smi)

    # -- phase 34: ragged generate, beam search, HF interop, ViT's ring
    gen34 = _gen_phase(torch, np, F, train_lm, generate, beam_search, da, fa,
                       rate, smi)
    _print(f"[total] chip_smoke wall {time.perf_counter() - t_start:.1f} s")

    # the kernels line: the kernel at the main path's largest window
    w_main = max(snap["decode_windows"])
    q, k, v, pos = _decode_inputs(torch, w_main, torch.bfloat16, seed=1)
    err = float((decode_attention(q, k, v, pos, impl="cuda")
                 - torch_decode_attention(q, k, v, pos)).abs().max())
    t = _time_decode(torch, F, decode_attention, torch_decode_attention,
                     q, k, v, pos, rate)
    flash_src = ("pytorch_multiprocessing_distributed_tpu_torch/ops/csrc/"
                 "flash_attention.cu")
    flash_entries = [{
        "name": name if tname == "bfloat16" else f"{name}_f32",
        "kernel": kernels_of[name], "route": "cuda", "source": flash_src,
        "replaces": "pytorch_multiprocessing_distributed_tpu/ops/pallas/"
                    + FLASH_REPLACES[name],
        "launches": launches_of[name],
        "max_abs_err": flash_main[tname][name]["max_abs_err"],
        "ms": flash_main[tname][name]["ms"],
        "kernel_ms": flash_main[tname][name]["ms"],
        "eager_ms": flash_main[tname][name]["eager_ms"],
        "plain_ms": flash_main[tname][name]["plain_ms"],
        "bound_ms": flash_main[tname][name]["bound_ms"],
        "bound_by": flash_main[tname][name]["bound_by"],
        "tflop_per_s": flash_main[tname][name]["tflop_per_s"],
        "library_ms": flash_main[tname][name]["library_ms"],
        "library": ("F.scaled_dot_product_attention" if name == "flash_fwd"
                    else "autograd through F.scaled_dot_product_attention "
                         "minus its forward (dq, dk and dv together)"),
        "shape": flash_main[tname][name]["shape"],
        **({"fma_bound_ms": flash_main[tname][name]["fma_bound_ms"]}
           if tname == "float32" else {
               "head_dim_ms": _by_head_dim(hd_times, FLASH_ROWS[name])}),
        **({f"vit_{key}": vit_fwd[key] for key in (
            "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}
           if (tname, name) == ("bfloat16", "flash_fwd") else {}),
        **({"sp_launches_per_step": {mode: sp["launches"][mode][name]
                                     for mode in SP_MODES},
            **{f"hop_{key}": sp["hop"][name][key] for key in (
                "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")},
            "hop_max_abs_err": sp["hop_err"][name],
            "hop_shape": "bf16 non-causal B8 H12 S256 Dh64"}
           if tname == "bfloat16" else {}),
        **({"mp_launches_per_step": {mode: counts[name] for mode, counts
                                     in mp["launches"].items()},
            "moe_launches_per_step": {mode: counts[name] for mode, counts
                                      in moe["launches"].items()},
            "heal_restart_launches": heal["lm"][name],
            "scope_launches_per_step": scope33["per_step"][name]}
           if tname == "bfloat16" else {})}
        for tname, kernels_of, launches_of in (
            ("bfloat16", FLASH_KERNELS, train_launches),
            ("float32", FLASH_KERNELS_F32, train_launches_f32))
        for name in FLASH_PRODUCTS]
    _print(json.dumps({"kernels": [{
        "name": "decode_attention", "kernel": DECODE_KERNELS,
        "route": "cuda",
        "source": "pytorch_multiprocessing_distributed_tpu_torch/ops/"
                  "csrc/decode_attention.cu",
        "replaces": "pytorch_multiprocessing_distributed_tpu/ops/pallas/"
                    "decode_attention.py:71",
        "launches": launches, "max_abs_err": max(worst, err),
        "ms": t["ms"], "kernel_ms": t["ms"], "cold_ms": t["cold_ms"],
        "eager_ms": t["eager_ms"], "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
        "library_ms": t["library_ms"],
        "library": "F.scaled_dot_product_attention with the position mask",
        "shape": f"bf16 N=8 H=12 Dh=64 W={w_main}",
        "head_dim_ms": _by_head_dim(hd_times, "1"),
        "moe_sample_launches": {f"top{k}": moe["cli"][f"top{k}"][
            "decode_launches"] for k in (1, 2)},
        **_tp_fields(tp, "decode_attention"),
        **_serve_heal_fields(serve_heal, "decode_attention"),
        "scope_launches_per_step": scope33["per_step"]["decode_attention"],
        **gen34,
        **{f"w{max(WINDOWS)}_{key}": row1_long[key]
           for key in ("ms", "cold_ms", "eager_ms", "plain_ms", "bound_ms",
                       "bound_by", "library_ms")}}]
        + flash_entries + [{
        "name": "fused_sgd", "route": "cuda",
        "source": "pytorch_multiprocessing_distributed_tpu_torch/ops/"
                  "csrc/fused_update.cu",
        "replaces": "pytorch_multiprocessing_distributed_tpu/ops/pallas/"
                    "fused_update.py:33",
        "launches": image_launches, "max_abs_err": sgd_worst,
        "ms": sgd_t["ms"], "kernel_ms": sgd_t["ms"],
        "eager_ms": sgd_t["eager_ms"], "plain_ms": sgd_t["plain_ms"],
        "bound_ms": sgd_t["bound_ms"], "bound_by": sgd_t["bound_by"],
        "library_ms": sgd_t["library_ms"],
        "library": "torch._fused_sgd_ (the kernel of torch.optim.SGD("
                   "nesterov=True, fused=True).step())",
        "library_step_ms": sgd_t["library_step_ms"],
        "shape": f"f32 N={SGD_SIZES[0]}",
        "r50_launches": imagenet["resnet50_imagenet"][1],
        "transforms_launches": t24_launches,
        "heal_restart_launches": heal["image"]["restart_launches"],
        "scope_launches_per_step": scope33["per_step"]["fused_sgd"],
        "r50_max_abs_err": r50_worst,
        **{f"r50_{key}": r50_sgd[key] for key in (
            "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}}] + [{
        "name": variant, "kernel": DECODE_KERNELS, "route": "cuda",
        "source": "pytorch_multiprocessing_distributed_tpu_torch/ops/"
                  "csrc/decode_attention.cu",
        "replaces": DECODE_REPLACES + VARIANTS[variant][1],
        "launches": variant_launches[variant],
        "max_abs_err": variant_worst[variant],
        "ms": variant_main[variant]["ms"],
        "kernel_ms": variant_main[variant]["ms"],
        "cold_ms": variant_main[variant]["cold_ms"],
        "eager_ms": variant_main[variant]["eager_ms"],
        "plain_ms": variant_main[variant]["plain_ms"],
        "bound_ms": variant_main[variant]["bound_ms"],
        "bound_by": variant_main[variant]["bound_by"],
        "library_ms": variant_main[variant]["library_ms"],
        "library": "F.scaled_dot_product_attention on the gathered, "
                   "dequantized dense window",
        "shape": variant_main[variant]["shape"],
        "head_dim_ms": _by_head_dim(hd_times, VARIANTS[variant][0]),
        **_tp_fields(tp, variant),
        **_serve_heal_fields(serve_heal, variant),
        "scope_launches_per_step": scope33["per_step"].get(variant)}
        for variant in VARIANTS] + [{
        "name": variant, "route": "cuda",
        "source": "pytorch_multiprocessing_distributed_tpu_torch/ops/"
                  "csrc/decode_attention.cu",
        "replaces": DECODE_REPLACES + VERIFY_VARIANTS[variant][1],
        "launches": spec_launches[variant],
        "max_abs_err": verify_worst[variant],
        "ms": verify_main[variant]["ms"],
        "kernel_ms": verify_main[variant]["ms"],
        "eager_ms": verify_main[variant]["eager_ms"],
        "plain_ms": verify_main[variant]["plain_ms"],
        "bound_ms": verify_main[variant]["bound_ms"],
        "bound_by": verify_main[variant]["bound_by"],
        "library_ms": verify_main[variant]["library_ms"],
        "library": "F.scaled_dot_product_attention with the row-staggered "
                   "mask on the gathered, dequantized dense window",
        "shape": verify_main[variant]["shape"],
        "head_dim_ms": _by_head_dim(hd_times, VERIFY_VARIANTS[variant][0]),
        **_tp_fields(tp, variant),
        **_serve_heal_fields(serve_heal, variant)}
        for variant in VERIFY_VARIANTS] + [{
        "name": "ring_all_reduce", "kernel": RING_KERNEL, "route": "cuda",
        "source": "pytorch_multiprocessing_distributed_tpu_torch/ops/"
                  "csrc/ring_allreduce.cu",
        "replaces": "pytorch_multiprocessing_distributed_tpu/ops/pallas/"
                    "ring_allreduce.py:63",
        "launches": ring_launches, "max_abs_err": ring_worst,
        "ms": ring_t["ms"], "kernel_ms": ring_t["ms"],
        "wrapper_ms": ring_t["wrapper_ms"],
        "eager_ms": ring_t["eager_ms"], "plain_ms": ring_t["plain_ms"],
        "bound_ms": ring_t["bound_ms"], "bound_by": ring_t["bound_by"],
        "library_ms": ring_t["library_ms"],
        "library": "torch.sum over the stacked ranks (dim 0)",
        "blocks": g_loop,
        "shape": f"f32 N={RING_MAIN_SIZE} per rank, n={RING_MAIN_N} "
                 "loopback on one card",
        **{f"xcard_{k}": v for k, v in xcard.items()},
        "xcard_library": "NCCL all_reduce (psum_)",
        "xcard_bound_by": "bytes (NVLink)"}]}))
    _print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
