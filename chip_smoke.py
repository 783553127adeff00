#!/usr/bin/env python3
"""The quickest proof that the PyTorch/CUDA port starts and is right on an
NVIDIA GPU:

    python3 chip_smoke.py

It needs one card, builds every kernel from the sources in the checkout, and
imports nothing of JAX. Phases, in order; any failure raises and the exit
code is non-zero:

1. card: name and power limit (``nvidia-smi``); no CUDA device is an error.
2. build: kernels B1 (``acmil_tpu_torch/csrc/attn_pool.cu``), B2
   (``acmil_tpu_torch/csrc/attn_pool_bwd.cu``), the ViT GEMMs
   (``csrc/vit_gemm.cu``: TMA, wgmma at bf16 and fp16, LayerNorm prologue;
   ``csrc/vit_gemm_f32.cu``: TMA and split-TF32 wgmma ``.tf32`` at f32,
   W split once a call) and MHA B5'/B7
   (``csrc/vit_attn.cu``, bf16 and fp16) from which the B3 and B4 chains
   are built, B5'/B7 at f32 on the tensor cores (``csrc/vit_attn_f32.cu``,
   the split-TF32 route ``tf32x3``), B7's fma route
   (``csrc/vit_attn_generic.cu``), and B6
   (``csrc/dsmil_pool.cu``): one ``nvcc`` each, all together; ptxas's
   registers and spills of every kernel, and how B5'/B7 launches at the
   trunks' shapes (wgmma or mma.sync, passes over the keys, warps, shared
   memory).
3. kernel B1 against its plain PyTorch version on the card at the serving
   width (Df=384, L=A=128), K in {5, 1}, N in {300, 16384, 65536}, B=1 and
   B=3 with one all-masked bag, fp16 and f32 features, and at every other
   pretrain width (Df, L) in ``WIDE_DIMS`` (L = 256 to 768) with K in {5,
   128}; two launches must agree bit for bit. Then at every width the
   near-0 stress bag (``_stress_bag``: rows whose pre-activations all lie
   within rounding of 0), where B1's H must also equal B2's H bit for bit
   (both read through the wrappers' ``_workspace``). Then timed with CUDA
   events at N=16384 and 65536, its device time (every CUDA kernel of
   ``ops/attn_pool.py::B1_KERNELS``) at N=65536 at every L, printed split
   by kernel at L=128 and L=768.
4. kernel B2 against its plain closed form and against torch autograd
   through the plain forward, at the same shapes (at the wider L: K=5 at
   N=300 and 65536, K=128 at N=4099), with dx off and on and cotangents
   that are nonzero at pad slots too; two launches must agree bit for bit.
   Then B2 and the plain backward timed at N=16384 and 65536 (and at
   N=65536 at every L); B2's device time sums every CUDA kernel it runs
   (``ops/attn_pool.py::B2_KERNELS``; its first three, the H stage, are
   B1's), and is printed split by kernel at L=128 and L=768.
5. serving: an ACMIL_GA head at the camelyon_medical_ssl widths
   (n_token=5, weights from a seeded ``torch.Generator``) scores 16
   synthetic slides of 1k-50k patches through ``cli/predict.py``'s ``main``
   on ``cuda``. B1 must launch once per slide; the probabilities must be
   finite, sum to 1 and match the plain model route (``fused=False``).
   Then the same at the natural_supervised widths (Df 512, L 256: B1's
   32-row tiles) on 6 slides.
6. training, the slice's main path: ``cli/step3_acmil.py``'s ``main`` trains
   the ACMIL recipe (n_token 5, n_masked_patch 10, mask_drop 0.6) at the
   camelyon_medical_ssl widths for 2 epochs on 24 synthetic slides of
   1k-50k patches, on ``cuda``. B2 must launch once per train step and B1
   once per train step and once per eval bag; every epoch's loss must be
   finite; ``checkpoint-best.pth`` and ``checkpoint-last.pth`` must exist,
   and the best one must score slides through ``cli/predict.py``. Then one
   epoch at the natural_supervised widths (8 train, 2 val, 2 test slides)
   through B1 and B2 at L = 256, with the same launch rule.
7. fused against plain training on one 50000-patch bag: from the same
   weights with the same STKIM uniforms, one step's loss and every gradient
   of the fused route (B1 + B2) match the plain route (forward and
   autograd), and five AdamW steps give matching losses; then the
   per-step wall time of both routes.
8. ViT kernels against their plain versions, bf16: B5' at the widths of
   ViT-S/16, ViT-S/8, CLIP-L/336 and GigaPath with B in {1, 64}; the B3
   chain at ViT-S/16 with B in {1, 7, 256} and at ViT-S/8's 785 tokens
   (outside the TPU's VMEM model, where the wrapper still launches); the B4
   chain at ViT-B/16, UNI (with layerscale, B=4 and the path's B=32) and
   ViT-S/8. Then each timed with CUDA events at its main path's shape, with
   the matrices in bf16 as the path holds them (B3 at B=256, B4 at UNI,
   B5' at ViT-S/16, B=256, where Step2 launches it, and at CLIP-L/336,
   B=32), beside its plain version and, for B5',
   ``F.scaled_dot_product_attention`` on the same qkv, for B3 and B4 the
   sum of one bf16 ``torch.matmul`` per GEMM shape of the chain (yardsticks
   the port never calls); for B3 and B4 also the device time of their B5'
   step, of their GEMMs (with TFLOP/s) and of their LayerNorm prologues.
9. Step2, slice 3's main path: ``cli/step2_extract.py``'s ``main`` extracts
   ViT-S/16 medical_ssl features (full width, depth 12, batch 256, seeded
   random weights) from three synthetic slides of 1135 patches on ``cuda``;
   the B3 chain must launch 12 times per batch, and B5' once per B3; the
   features must be fp16,
   finite, ``[N, 384]`` and within cosine 0.999 per patch of the plain route
   (``fused=False``); ``cli/predict.py`` then scores the feature file with an
   ACMIL_GA head (B1 once per slide), pixels to probabilities.
10. ``vit_encode`` at UNI ViT-L/16 (B4, then the MLP half as two GEMMs in
   ``csrc/vit_gemm_f32.cu``'s bf16-A mode: ``_gemm.launches["bf16a"]`` must
   count 2 a block) and CLIP-L/336 (route 3: qkv and proj on the bf16-A
   mode around B5', 2 a block; the plain quick_gelu MLP half) full
   width, depth 2, B=32, against ``fused=False``. Then the bf16-A mode
   alone at UNI's fc1 (LayerNorm prologue, gelu) and fc2 (layerscale
   residual) and GigaPath's fc1 (LayerNorm prologue, the SwiGLU epilogue,
   K 1536, N 8192), M = 256 x 197: with f32 out (no prologue) against a float64
   product at the f32 bar of ``tests/test_torch_gpu_gemm.py``, with bf16
   out against its plain version (LayerNorm rows rounded to bf16), bit for
   bit against the f32 mode on ``a.float()`` (epilogue 0), then timed
   beside f32 ``torch.matmul`` (TF32 off, what the plain MLP half runs).
11. kernel B6 (``csrc/dsmil_pool.cu``) against its plain version at (D, Q) of
   camelyon_medical_ssl (384, 128) and UNI (1024, 512), C in {2, 4}, N in
   {300, 16384, 65536}, B=1 and B=3 with one all-masked bag, fp16 and f32
   features (C=4 at D=1024 on the split-TF32 route, the rest on the row
   kernel), and C in {9, 128} (the split-TF32 route) at N=300 (B=3) and
   65536; at C=2 and C=128 each launched twice, which must give the same
   bits. Then B6 (C=2, C=128, and C=2 at UNI's widths), the plain pooling
   and the whole fused and plain DSMIL eval forwards timed with CUDA events,
   B6's device time split by kernel (``ops/dsmil_pool.py::B6_KERNELS``), and
   the N from which the fused forward wins on this card printed beside
   ``FUSE_MIN_N``.
12. DSMIL scoring, slice 4's main path: a DSMIL head at the
   camelyon_medical_ssl widths (seeded weights, saved through
   ``engine/checkpoint.save``) scores 16 synthetic slides of 1k-65k patches
   through ``cli/predict.py``'s ``main`` on ``cuda``; B6 must launch once per
   slide whose bucket reaches ``FUSE_MIN_N``; the probabilities must be
   finite, sum to 1 and match the plain route. Then where one 50000-patch
   slide's time goes, from host features to probabilities.
13. DSMIL training: ``cli/step3_generic.py``'s ``main --arch dsmil`` trains 2
   epochs on 24 synthetic slides of 1k-65k patches on ``cuda``; B6 must
   launch once per val/test bag whose bucket reaches ``FUSE_MIN_N``, per
   epoch; losses finite; the best checkpoint scores slides through
   ``cli/predict.py``.
14. kernel B7 (the strided entry of ``csrc/vit_attn.cu``) against its plain
   version, bf16, at ViT-S/16, ViT-S/8 and CLIP-L/336 with B in {1, 64} and
   on q, k, v that are strided views of a packed qkv; B5' and B7 at the
   kernel's edges (``EDGE_N`` x every head width); its backward on the
   card against autograd through the plain version; then B7, the plain
   version and ``F.scaled_dot_product_attention`` timed at ViT-S/16, B=256.
15. the SPY reader (``wsi/native.py``, cv2's JPEG codec) on this machine: a
   raw-codec round trip exact; a JPEG one equal to the tiles' own cv2 round
   trips assembled outside the reader, and within ``SPY_JPEG_MAE`` of its
   source; regions across the right and bottom edges and fully outside
   white as ``ImageSlide`` fills them. Then the pipeline in the port alone,
   Step1 -> Step4: six synthetic 5120x3840 slides written as SPY pyramids
   (JPEG, 256-px tiles, ``wsi/synthetic.py::write_synthetic_spy``) by
   spawned workers; ``cli/step1_patches.py`` segments and tiles them into
   256-px patches (coords as torch files), printing each slide's seg, patch
   and stitch seconds; coords must be non-empty and inside each slide.
   ``cli/step2_extract.py`` extracts ViT-S/16 features on those coords (full
   width, depth 12, batch 256; B3 12 times a batch, B5' once per B3;
   features fp16 and finite), printing per slide the open time, Step2's
   patches/s and the host's read+decode ms per 256-patch batch beside the
   encoder's ms a batch, and for contrast slide 0 as a PNG (open and a
   batch's read);
   ``cli/step3_acmil.py`` trains ACMIL_GA 2 epochs on a 4/1/1 split (B1 and
   B2 counted, losses finite); ``cli/predict.py`` scores the six (B1 once a
   slide, rows sum to 1); ``cli/step4_heatmap.py`` renders the test slide
   through B1 (one launch; a PNG of its rendered level's shape, not blank),
   and B1's attention must match the plain forward's within
   ``STEP4_ATOL`` at valid slots.
16. ACMIL_MHA and MHA: ``cli/step3_acmil.py --arch mha`` (8 heads, n_token
   5, STKIM on) trains 2 epochs on 24 synthetic slides of 1k-65k patches;
   ``cli/predict.py`` scores them on the card and on the CPU, which must
   agree within ``MHA_CPU_ATOL``; ``cli/step4_heatmap.py`` renders two of
   phase 15's slides with it; ``cli/step3_generic.py --arch mha`` trains
   MHA (``mha_single``) one epoch; then a training step and a slide's eval
   at 50000 patches timed, with their device time.
17. CLAM_SB and CLAM_MB at the camelyon_medical_ssl widths (D_feat 384,
   D_inner 128, A 128): (a) fused (B1 + B2; MB through
   ``ops/attn_pool.py::gated_attn_pool_grad_one``, B1's stats and B2 under
   lse₁) against plain training on 50000-patch bags with ``droprate: 0``,
   n_class 2 and 4 (subtyping on): one step's loss, instance loss and every
   gradient by phase 7's rules, five AdamW steps' losses; (b) two epochs of
   ``cli/step3_generic.py --arch clam_sb`` and ``--arch clam_mb`` at
   ``droprate: 0`` on phase 16's 24 slides: B1 and B2 once per train step
   whose bucket reaches ``FUSE_MIN_N``, B1 once per such val/test bag; the
   best checkpoint scores through ``cli/predict.py`` within
   ``CLAM_PROB_ATOL`` of the plain route; ``cli/step4_heatmap.py`` renders
   a SPY slide of phase 15 with the MB head (B1 once); (c) one epoch at the
   reference's dropout 0.25, which launches no B2; (d) a training step and
   an eval at 50000 patches timed, with their device time.
18. the rest of the generic zoo at the camelyon_medical_ssl widths, on
   phase 16's 24 slides: (a) ``cli/step3_generic.py --arch A`` trains one
   epoch for each A of ``ZOO_ARCHS`` (meanmil, maxmil, lbmil, attmil,
   attmil_gated, ilra, ips, bmil_vis, bmil_enc, bmil_spvis with the slides'
   coords), every loss finite; each best checkpoint scores
   ``ZOO_CPU_SLIDES`` through ``cli/predict.py`` on the card and on the CPU,
   within ``ZOO_CPU_ATOL``; (b) IBMIL: ``cli/step3_ibmil.py`` phase 1,
   ``cli/ibmil_clustering.py`` (prototypes [8, 128], finite), phase 2 with
   ``--c_path`` (finite loss, ``deconf_attn`` rows summing to 1);
   ``cli/predict.py`` refuses the phase-2 checkpoint with the training YAML
   (its model keys hold no ``c_path``, as in the JAX package) and scores it,
   card against CPU, with a YAML that names ``c_path``; (c)
   ``cli/step4_heatmap.py`` renders a SPY slide of phase 15 with the IBMIL
   and bmil_spvis heads (a PNG of the rendered level's shape, not blank) and
   refuses lbmil (``model emits no attention``); (d) for each arch a
   training step and an eval at 50000 patches timed with CUDA events, with
   their device time and device events from ``torch.profiler``. None of
   these heads reaches a kernel, in either package: B1, B2 and B6 must
   count no launch over the phase.
19. TransMIL and MHIM on phase 16's 24 slides: (a) ``cli/step3_generic.py
   --arch transmil`` trains one epoch at the camelyon_medical_ssl widths
   (D_inner 128: 8 heads of 16, 64 landmarks), every loss finite; its best
   checkpoint scores ``TM_CPU_SLIDES`` through ``cli/predict.py`` on the
   card and on the CPU within ``ZOO_CPU_ATOL``, a ``compute_dtype:
   bfloat16`` eval on the card within ``TRANSMIL_BF16_ATOL`` of the f32
   one, and ``cli/step4_heatmap.py`` refuses it (``model emits no
   attention``); (b) MHIM's two stages through ``cli/step3_mhim.py`` at the
   script's mlp_dim 512 (8 heads of 64, 256 landmarks), for each baseline
   (selfattn, attn): ``--model pure`` one epoch, then ``--model mhim
   --teacher_init <its dir> --init_stu_type fc --mask_ratio_h 0.1
   --mask_ratio_hr 0.5 --mm_sche --mrh_sche`` one epoch, every loss finite,
   the checkpoint's teacher off its start and off the student; each best
   checkpoint scored card against CPU within ``ZOO_CPU_ATOL``; on one
   50000-patch bag at step 0 the student keeps exactly 45000 patches, every
   dropped one in the teacher's top 20% by rank; (c) a training step and
   an eval at 50000 patches for transmil, pure, mhim selfattn and mhim
   attn, timed with CUDA events, with device time and device events from
   ``torch.profiler``, the step's four largest device events by name and
   its peak memory. No kernel runs: B1, B2 and B6 must count no launch
   over the phase.
20. DTFD, SAM and Step2's ResNet trunks, with ``models/fast.py::
   DTFD_FUSE_MIN_S`` pinned to 0 for DTFD (as the JAX package's tests pin
   it): (a) ``cli/step3_dtfd.py`` (numGroup 4, MaxMinS, per-module clip 5)
   trains one epoch on phase 16's 24 slides, every loss finite, B1 and B2
   once a train step and B1 once an eval bag; its best checkpoint scores
   ``ZOO_CPU_SLIDES`` through ``cli/predict.py`` on the card (B1 once a
   slide) and on the CPU within ``DTFD_CPU_ATOL``; one epoch at the
   natural_supervised widths (L = 256) under the same launch rule; (b) on
   one 50000-patch bag, fused (B1 + B2 on the gathered ``mid``, W1 = I)
   against plain from the same weights and grouping uniforms: one step's
   ``loss0``, ``loss1`` and every gradient by phase 7's rules, five clipped
   Adam steps' losses; the step and the eval of each route timed (CUDA
   events, ``torch.profiler`` device time and events, the step's peak
   memory), and B1 and B2 alone at DTFD's call shape split by kernel, the
   H stage's share printed; (c) ``cli/step3_acmil.py`` with ``use_sam:
   true`` trains ACMIL_GA one epoch, B1 and B2 twice a train step; one SAM
   step on a 50000-patch bag card against CPU from the same weights and
   STKIM uniforms (``SAM_CPU_RTOL``, parameters within lr); the SAM step
   timed against the plain one; (d) ``cli/step2_extract.py`` with ResNet-50
   and ResNet-18 (natural_supervised, bf16, batch 256, seeded random
   weights) on two of phase 15's SPY slides, features finite; one batch's
   first ``RESNET_CPU_PATCHES`` on the card against float32 on the CPU
   (per-row cosine ``COS_MIN``); patches/s, the encoder's ms a batch and
   the host's read ms; ``--roi_dir`` on a synthetic ImageFolder writes
   ``roi_feats.npy``, card against CPU within cosine ``COS_MIN``.
21. Step3 across processes (``acmil_tpu_torch/parallel``), each launch
   ``python -m torch.distributed.run --standalone`` of this script's
   ``--mesh-worker`` mode, every rank required to exit 0: (a) NCCL at world
   size 1, ``cli/step3_acmil.py --mesh_data 1`` for one epoch on phase 15's
   corpus, its metrics and B1/B2 launches equal to the run without a mesh;
   (b) two ranks on the card joined by ``gloo`` at seq 2, one ACMIL_GA step
   at full width (``MESH_LENGTHS`` patches in bucket ``MESH_N``, the second
   bag's valid rows all on rank 0): B1 and B2 once a rank, bag and lse
   within ``MESH_POOL_ATOL`` of the one-process kernel, loss and every
   gradient by phase 7's rules, each rank's step timed with CUDA events and
   its collectives' host time apart, and which collectives ``gloo`` takes
   on CUDA tensors; (c) four ranks, ``gloo``, data 2
   x seq 2: ``cli/step3_acmil.py`` with ``mesh_shape`` on phase 16's
   slides, one epoch and eval, metrics within ``MESH_METRIC_ATOL`` of the
   one-process run's, one writer; (d) TransMIL's step at seq 2 on
   ``MESH_TM_N`` patches against the one-process step.
22. Step2 across processes (``--mesh_data``, ``--mesh_model``,
   ``parallel/tp.py``), each multi-rank launch a torchrun of this script's
   ``--mesh-worker`` mode, every rank required to exit 0: (a) NCCL at world
   size 1, ``cli/step2_extract.py --mesh_data 1`` at ViT-S/16 (depth 12,
   batch 256) on phase 15's SPY slides: the file equal to phase 15's bit for
   bit, B3 and B5' launched as there; (b) two gloo ranks on the card,
   ``--mesh_data 2``: the same file bit for bit, each rank's launches one
   process's (it encodes half of every batch), patches/s (also over the
   slides after the first, beside phase 15's) and each rank's host read of
   its half batch; (c) ``--mesh_model 2`` at ViT-S/16, batch
   ``TP_BATCH``, two slides: per-patch cosine ``COS_MIN`` against phase
   15's file, B7 (tensor-core route) depth x batches a rank, a batch's
   span and its ms in collectives; (d) four ranks, data 2 x model 2, at UNI
   (full width and depth, layerscale ``TP_LS``, random weights), batch
   ``TP_UNI_BATCH``, against the one-process run (B4 + the f32 MLP half);
   (e) GigaPath ViT-G/16 at full width, depth ``TP_GIGA_DEPTH``, model 2
   through ``tp_encoder_feature_fn`` against one process (B5' + the MLP
   half); (f) an f32 ViT-S/16 at model 2 (B7's tf32x3 route) within
   ``TP_F32_REL`` of the module forward at f32, ``vit_encode(fused=False)``
   printed beside it; (g) B7 against its plain version at f32 and fp16,
   dh in ``B7_DH``, N in ``B7_N``, contiguous and strided (at dh in {16,
   32, 64, 128} f32 takes the tf32x3 route and fp16 the tensor-core route,
   both the fma route elsewhere), the TP block's calls into a NaN-filled
   token-major buffer, then B7 at f32 [256, 6, 197, 64] twice for the same
   bits and timed on the tf32x3 route and on the fma route (``_launch_fma``)
   beside the plain version and SDPA, device times from whole profiler
   windows (``_kernel_ms``).
23. Step3's scanned epoch (``--scan_epoch``) on bench.py's scan-epoch
   cohort (242 bags of clip(lognormal(log 3000, 0.7), 500, 20000) patches,
   D_feat 384, fp16, ``min_bucket`` 1024, the ACMIL recipe at lr 1e-4, 100
   epochs scheduled), plus 20 val and 20 test bags: (a)
   ``cli/step3_acmil.py --scan_epoch`` trains 2 epochs from the cohort's
   ``.pt`` file, printing the graph route once, B1 and B2 launched by the
   replays once per step and eval bag; (b) one epoch on the graph route
   against the eager scanned route, same order and draws, bit for bit
   (``SCAN_GRAPH_ATOL``), with each bucket's capture ms and pool growth;
   (c) ``evaluate_scanned`` against ``evaluate`` and against each bag's eval
   step; (d) ``torch.profiler`` over one graph epoch counts one B1 row
   kernel and one B2 weight-gradient kernel a replay, short by at most
   ``SCAN_PROFILER_LOST`` of them (events the tracer loses); (e) the per-bag loop,
   the eager scanned route and the graph route, one epoch each: wall
   (``utils/profiling.py::StepTimer``), device busy time and idle share
   (``profile_trace``), and STKIM's branch on the device against the
   host's; (f) ABMIL, CLAM_SB and CLAM_MB graph against eager on the first
   ``SCAN_SUB`` bags, and DSMIL's scanned eval with B6 in the graph
   against ``evaluate``; (g) every other family the JAX package scans, each
   one graph epoch against one eager scanned epoch on the first
   ``SCAN_FAMILY_SUB`` bags (``SCAN_LIGHT_SUB`` for pure, MHIM, TransMIL
   and the plain heads) from
   the same weights and draws, bit for bit, each arch's route chosen by
   ``scan_route``: ACMIL_GA and DSMIL with ``use_sam`` (B1 and B2 twice a
   replay on ga), DTFD with ``DTFD_FUSE_MIN_S`` pinned to 0 (B1 and B2
   once a replay, on the gathered ``mid``) and at its default, pure, then
   MHIM with that pure model as its teacher (the teacher bit for bit too),
   TransMIL and the twelve plain heads (``SCAN_PLAIN_HEADS``), the replays'
   B1/B2 launches equal to one capture's times the steps and to the eager
   epoch's; DSMIL's scanned eval after its SAM run, B6 in the graph,
   against ``evaluate``; ``cli/step3_acmil.py`` with ``use_sam: true`` and
   ``cli/step3_mhim.py --model mhim`` (``MHIM_STAGE_B``) with
   ``--scan_epoch``, 2 epochs each, printing the graph route once; and
   the per-bag loop, eager scanned and graph epochs of ``SCAN_TIMED``
   (SAM-ga, fused DTFD, MHIM, TransMIL, ILRA) timed as in (e).
24. the ViT trunks at float16 and float32 (``vit_dtypes_run``): (a) Step2's
   feature path at ViT-S/16 (full width, depth 12, batch 256, seeded random
   weights), ``build_encoder(conf, dtype=...)`` → ``encoder_feature_fn`` →
   ``cli/step2_extract.py::extract_slide_features`` on phase 9's three
   synthetic slides, at fp16 and at f32: B3 depth x batches, its GEMM four
   times a launch at that dtype (``csrc/vit_gemm.cu`` fp16,
   ``csrc/vit_gemm_f32.cu`` f32) and B5' once (fp16: tensor cores; f32:
   the tf32x3 route, ``csrc/vit_attn_f32.cu``), no other route (no fma
   launch); features within cosine
   ``COS_MIN_F32`` / ``COS_MIN_F16`` per patch of the plain route; (b)
   ``CPU_F32_PATCHES`` patches at f32 on the card against the plain
   ``vit_encode`` on the CPU within ``CPU_F32_REL``, cuDNN's TF32 allowed
   as PyTorch's default has it, and that flag off at each f32 convolution
   (``fast.conv_precision``); (c) ViT-B/16 (B=64), UNI and CLIP-L/336
   (B=32) at full width, depth 2, at fp16 and f32: each layer's B4 or packed attention half
   against its plain version, then ``vit_encode`` fused against plain with
   each route's launch count; (d) the fp16 and f32 GEMMs at B3's four
   calls (ViT-S/16, B=256) against their plain versions (f32: also W's
   split bit for bit against ``split_w``'s plain version) and timed beside
   ``torch.matmul`` in the same dtype (f32: also TF32 ``torch.matmul``, one
   TF32 product, not the same function), B5' at fp16 and f32 beside SDPA (f32
   also on B7's fma route, its earlier route, through ``_launch_fma``), a
   B3 layer at each dtype split by kernel.
25. Step3's scanned epoch on a ``(data, seq)`` mesh of processes
   (``scan_mesh_run``; it runs after phase 23, whose cohort file and
   checkpoint it reads, and before phase 24), each launch a torchrun of this
   script's ``--mesh-worker`` mode, every rank required to exit 0: (a) NCCL
   at world 1, ``cli/step3_acmil.py --scan_epoch --mesh_data 1`` for 2
   epochs on phase 23's cohort: the graph route printed once, B1 and B2
   replayed once a step and B1 once an eval bag, and the last checkpoint
   equal to phase 23 (a)'s within ``SCAN_GRAPH_ATOL``; (b) two gloo ranks at
   data 2, B 2, one scanned epoch of the cohort on the eager route (the
   reason printed) against the per-bag mesh loop (``train_one_epoch``) fed
   its visit order from the same weights and draws: parameters within lr a
   step, mean loss and gradient norm within ``SCAN_MESH_LOSS_RTOL`` and
   ``SCAN_MESH_GNORM_RTOL``, every rank's parameters equal, B1 and B2 once a
   step a rank; epoch wall, ms in gloo collectives a step; (c) the same at
   four ranks, data 2 x seq 2, on the first ``SCAN_SUB`` bags (B1 and B2 on
   each rank's slice of N under the flash merge); (d) DSMIL's scanned eval
   at data 2 on phase 23's ``SCAN_DSMIL_BAGS`` bags: B6 once a bag a rank,
   the metrics of ``evaluate`` on the mesh on every rank.

The line before the kernels line is ``{"zoo": {...}}``: phase 18's and
phase 19's numbers per arch (training epoch wall and loss, predict seconds,
card-vs-CPU error, step and eval ms, device ms and device events; phase
19's also the step's peak memory), the kernel launches phase 18 counted,
phase 19's checks under ``transmil_mhim`` and phase 20's numbers under
``dtfd_sam_resnet``, phase 21's under ``mesh`` and phase 22's under
``step2_mesh``, phase 23's under ``scan_epoch``, phase 24's under
``vit_dtypes`` and phase 25's under ``scan_mesh``. The line before the last but one is ``{"kernels": [...]}``
with each kernel's launches on its path (``gemm_f16``, ``gemm_f32``,
``b5_f16`` and ``b5_b7_f32_tf32x3`` on phase 24's Step2 path at their
dtype, timed at ViT-S/16, B=256, the GEMMs summed over B3's four calls;
the tf32x3 entry also its launches in phase 24's f32 trunks and phase 22
(f), and B7's time on that route (``b7``); ``b5_f32_fma``, B5' at f32 on
B7's fma route, 0 launches on the path, timed at the same shape; every
f32 entry's bound (``gemm_f32``, the tf32x3 route, the fma route) counts
its products at the card's rate for f32 accuracy, three TF32 products
each, with its bound at the f32 FMA rate beside it as ``fma_bound_ms``;
B7 has an entry per route, each with its launches on phase 22's
tensor-parallel paths summed over the ranks: the tensor-core route's at
bf16 (c)-(e), timed at phase 14's bf16 shape, its count over phases 3-13
beside it; the fma route's (0 since f32 takes the tf32x3 route), timed
at f32; B5''s are its
launches as B3's attention step on the Step2 path, with its launches in
``vit_encode`` beside them), its worst error against the plain version,
its time (``ms``: CUDA events around one call of the wrapper;
``device_ms``: the kernels' own device time from ``torch.profiler``), the
plain version's, a library call's where one exists, and the bound (the
larger of FLOPs / 989 TFLOP/s and bytes / 3.35 TB/s, f32 as above); B1 and B2 also at the wider L (``wider_l``) and B1
split by kernel (``by_kernel``), B6 also split by kernel (``by_kernel``),
with ptxas's registers and spills of each of its kernels (``ptxas``), at
C=128 (``c128``) and at UNI's widths (``uni``), B3 and B4 also their
GEMMs' device time and rate; B1, B2, B3 and B5' also their launches in
phase 15 (``launches_pipeline_step2``, ``_step3``, ``_predict``,
``_step4``), and B1 and B2 their launches on phase 17's CLAM paths
(``launches_clam_*``) and on phase 20's DTFD and SAM paths
(``launches_dtfd_*``, ``launches_sam_step3``) with their device time at
DTFD's call shape split by kernel (``dtfd_call``), and on phase 21's mesh
paths (``launches_sharded_step3`` and B1's ``launches_sharded_eval``: the
data 2 x seq 2 epoch summed over its ranks; ``launches_sharded_step_seq2``,
``launches_mesh_nccl_world1``), and on phase 23's scanned epochs
(``launches_scan_epoch_step3``: (a)'s warm-ups plus its replays times the
launches of one capture; ``launches_scan_graph_epochs``: (b) and (e)'s
graph epochs; B6's ``launches_scan_eval_graph``: (f);
``launches_scan_sam_graph``, ``launches_scan_dtfd_graph`` and
``launches_scan_sam_cli``: (g)'s SAM-ga and fused DTFD graph epochs and
its SAM CLI; B6's ``launches_scan_sam_eval_graph``: (g)'s DSMIL eval
after SAM), and on phase 25's
scanned mesh epochs, summed over the ranks (``launches_scan_mesh_nccl_world1``:
(a)'s warm-ups and replays; ``launches_scan_mesh_data2``,
``launches_scan_mesh_data2_seq2``: (b) and (c)'s scanned epochs; B6's
``launches_scan_mesh_eval_data2``: (d)); then the card's
name and power limit; the last line
is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import copy
import gc
import json
import math
import os
import re
import statistics
import subprocess
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
YML = os.path.join(REPO, "config", "camelyon_medical_ssl_config.yml")
# the natural_supervised configs (camelyon, bracs, lct): D_feat 512,
# D_inner 256
WIDE_YML = os.path.join(REPO, "config", "camelyon_natural_supervised_config.yml")
D_FEAT, D_INNER, D_ATTN, N_TOKEN = 384, 128, 128, 5   # camelyon_medical_ssl, ACMIL
# (D_feat, D_inner) of the other pretrain tags (config.PRETRAIN_DIMS), where
# kernel B1 runs 32-row tiles
WIDE_DIMS = ((512, 256), (768, 384), (1024, 512), (1536, 768))
N_MASKED_PATCH, MASK_DROP = 10, 0.6                   # the README's ACMIL recipe
SEED = 0
# kernel vs plain: both f32 with TF32 off; only the order of the sums
# differs, over up to 384-term dots and 65536-term softmax sums
ATOL, RTOL = 1e-4, 1e-4
PROB_ATOL = 1e-5
# B2 vs plain, error relative to each output's largest magnitude: the weight
# gradients are sums over up to 3 x 65536 rows in other orders; an fp16 dx
# is rounded once to fp16 (2**-11 of the value)
BWD_REL, BWD_REL_FP16 = 1e-4, 1e-3
# fused vs plain training route, f32 both, TF32 off: one step's loss, and
# each gradient within STEP_GRAD_REL of its largest magnitude plus
# STEP_GRAD_ATOL; the routes differ in summation order and in how STKIM is
# applied (an O(K k) correction of the pooled bag against a masked softmax
# over N). The atol covers the attention's output bias, whose gradient is 0
# in exact arithmetic (the softmax ignores a shift of the logits), so both
# routes give rounding noise there
STEP_LOSS_RTOL, STEP_GRAD_REL, STEP_GRAD_ATOL = 1e-5, 1e-3, 1e-7
# losses over five AdamW steps: Adam divides by sqrt(v), which magnifies
# rounding in tiny gradient components, so the paths drift apart slowly
ADAM_LOSS_RTOL = 1e-3
TRAIN_EPOCHS, N_TRAIN, N_VAL, N_TEST = 2, 16, 4, 4
# the natural_supervised phases: slides scored; (train, val, test) slides of
# one training epoch
WIDE_SLIDES, WIDE_TRAIN = 6, (8, 2, 2)
# bounds: H100 SXM dense bf16/fp16 tensor-core peak and HBM rate, published
PEAK_FLOPS, HBM_BYTES_PER_S = 989e12, 3.35e12
# H100 SXM, published: dense TF32 on the tensor cores, and float32 outside
# them. The card's rate for products of f32 accuracy is the first over
# three: split-TF32 (the f32 GEMM's route) issues three TF32 products for
# each f32 product; the second is what f32 FMA code, as B7's fma route,
# reaches at best
PEAK_TF32_FLOPS, PEAK_F32_FLOPS = 495e12, 67e12
# ViT kernels vs their plain versions, bf16 both: the same rounding points
# (f32 LN, products, softmax and residuals; bf16 y, qkv, p, o, gelu output),
# so only the order of f32 sums differs, and it can flip a bf16 rounding by
# one step (2**-8 relative). A flipped p moves an output by up to
# 2**-8 * p * |v|, which is small against the largest output, not against an
# output that cancels to near 0: so each check allows TOL * |want| + TOL *
# max|want|, with B5' at one step either side and a chain at two (a flipped
# qkv, p or o element goes on through proj and the residual)
B5_TOL, CHAIN_TOL = 2.0 ** -7, 2.0 ** -6
COS_MIN = 0.999            # features of the fused and plain routes, per patch
# (name, dim, heads) of the trunks whose widths the ViT kernels are checked at
VIT_S16, VIT_S8 = (197, 384, 6), (785, 384, 6)
VIT_B16, UNI, CLIP_L, GIGA = (197, 768, 12), (197, 1024, 16), (577, 1024, 16), \
    (197, 1536, 24)
STEP2_BATCH, STEP2_DEPTH, PATCH_PX = 256, 12, 224
STEP2_SLIDES = ((5600, 3360), (4480, 4480), (6720, 2688))   # 375+400+360 patches
BIG_BATCH, BIG_DEPTH = 32, 2
# DSMIL: (D, Q) of camelyon_medical_ssl and UNI; B6 against its plain version
# at the JAX test's tolerance (tests/test_attn_pool.py), both f32 with TF32
# off: only the order of the sums differs (B6 folds the critical queries
# into the features' space, D·C instead of D·Q products per row); fused
# against plain scoring at tests/test_attn_pool.py's eval tolerance
DSMIL_WIDTHS = ((384, 128), (1024, 512))
DSMIL_ATOL, DSMIL_RTOL = 1e-4, 1e-4
DSMIL_PROB_ATOL, DSMIL_PROB_RTOL = 2e-5, 2e-4
DSMIL_SERVE_SLIDES, DSMIL_BIG_SLIDES = 16, 5
# the pipeline phase: six synthetic SPY slides (JPEG, 256-px tiles) tiled by
# Step1 into 256-px patches (~110 each at a_t = a_h = 1), a 4/1/1 split
PIPE_SLIDE_WH, PIPE_SLIDES, PIPE_PATCH = (5120, 3840), 6, 256
PIPE_SPLIT = (4, 1, 1)
# Step4's attention through B1 against the plain forward, probabilities at
# valid slots, f32 with TF32 off
STEP4_ATOL = 1e-5
# ACMIL_MHA on the card against the same checkpoint scored on the CPU
MHA_CPU_ATOL = 1e-4
MHA_HEADS = 8
# the SPY reader: a JPEG round trip at quality 90 against its source, mean
# |error| per channel over a region's pixels inside the slide. The
# synthetic tissue's +-15 per-pixel texture costs up to 3.09 on a
# tissue-filled region and 2.51 over level 0 (cv2 4.13 and 5.0 alike); a
# channel swap costs 8.75. The exact check against the tiles' own round
# trips is the one a misplaced tile fails
SPY_JPEG_MAE = 3.5
# CLAM: the routes are held by phase 7's rules (STEP_*, ADAM_LOSS_RTOL) on
# bags of these lengths (bucket 65536 each, so both kernels run), at these
# class counts (4: subtyping on); the card's probabilities (B1) against the
# plain route's, as ACMIL's PROB_ATOL
CLAM_ROUTE_LENGTHS = (50000, 40000, 60000)
CLAM_CLASSES = (2, 4)
CLAM_PROB_ATOL = 1e-5
# the generic zoo (phase 18): the archs cli/step3_generic.py trains one epoch
# each on phase 16's corpus; IBMIL runs its two-phase protocol beside them.
# Each best checkpoint scores ZOO_CPU_SLIDES (1000, 50000, 65536 and 50000
# patches) through cli/predict.py on the card and on the CPU: f32 both, TF32
# off, so the probabilities differ by the order of sums only, as ACMIL_MHA's
# do in phase 16 (MHA_CPU_ATOL)
ZOO_ARCHS = ("meanmil", "maxmil", "lbmil", "attmil", "attmil_gated", "ilra",
             "ips", "bmil_vis", "bmil_enc", "bmil_spvis")
ZOO_CPU_SLIDES = ("slide_00", "slide_01", "slide_16", "slide_20")
ZOO_CPU_ATOL = 1e-4
IBMIL_K = 8
# TransMIL (phase 19): a compute_dtype bfloat16 eval of the f32 checkpoint,
# probabilities against the f32 eval's, at the bf16-vs-f32 logit tolerance
# of the JAX package's tests/test_model_zoo.py::test_transmil_bf16_matches_f32
TRANSMIL_BF16_ATOL = 0.05
# phase 19's card-vs-CPU slides (1000 and 50000 patches): an MHIM
# SAttention forward at 65536 patches is ~1.4 TFLOP, seconds on the CPU
TM_CPU_SLIDES = ("slide_00", "slide_01")
# MHIM's two stages (the head-to-head's stage B, scripts/head_to_head.py)
MHIM_STAGE_B = ("--mask_ratio_h", "0.1", "--mask_ratio_hr", "0.5",
                "--mm_sche", "--mrh_sche")
# DTFD (phase 20): the routes' bags (50000, 65536 and 50000 patches, each
# bucket 65536: four groups of 16384); its checkpoint scored card against CPU
# on ZOO_CPU_SLIDES, f32 both with TF32 off, as the zoo's heads, on the same
# distilled instances (DTFD_TIE_ATOL)
DTFD_ROUTE_SLIDES = ("slide_01", "slide_16", "slide_20")
DTFD_CPU_ATOL = 1e-4
# DTFD distils the top-k CAM probabilities; near 0.5 they tie within an ulp
# (6e-8) or two, and two devices or routes round them apart, so compared
# runs share the first run's choices, and a choice the second run would
# have made otherwise must score within this of the first's: rounding's
# reach, not a different instance
DTFD_TIE_ATOL = 1e-6
# one SAM step, card against CPU: the loss, grad_norm and parts relative;
# each parameter within one learning rate (Adam's first step is about
# lr * sign(g), and a rounding-noise gradient may flip its sign)
SAM_CPU_RTOL = 1e-3
# Step2's ResNet trunks (natural_supervised rows) on two of phase 15's SPY
# slides; the card's bf16 features against the CPU's float32 on the first
# patches of one batch (per-row cosine COS_MIN); the ROI path on a synthetic
# ImageFolder, card against CPU (both bf16)
RESNET_BACKBONES = ("Resnet50", "Resnet18")
RESNET_CPU_PATCHES = 32
ROI_CLASSES, ROI_CROPS = 3, 2


def card() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs only on a GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def build() -> None:
    from acmil_tpu_torch.ops import _build

    names = ("attn_pool", "attn_pool_bwd", "vit_gemm", "vit_gemm_f32",
             "vit_attn", "vit_attn_generic", "vit_attn_f32", "dsmil_pool")
    t0 = time.perf_counter()
    _build.build(*names)
    for name in names:
        _build.load(name)
    print(f"build: {', '.join(names)} in {time.perf_counter() - t0:.2f} s")
    for name in names:
        info = _build.build_info.get(name, {})
        print(f"  {name}: nvcc {info.get('seconds', 0.0):.2f} s")
        for line in info.get("log", "").splitlines():
            if "entry function" in line or "registers" in line \
                    or "spill" in line:
                print(f"    ptxas: {line.strip()}")
    # how B5'/B7 launches at the trunks' shapes (csrc/vit_attn.cu's route)
    import ctypes

    shape = _build.load("vit_attn").b5_launch_shape
    for label, n, dh in (("ViT-S/16, UNI, GigaPath", 197, 64),
                         ("CLIP-L/336", 577, 64), ("ViT-S/8", 785, 64),
                         ("dh=128", 577, 128)):
        out = [ctypes.c_int() for _ in range(5)]
        if shape(n, dh, *map(ctypes.byref, out)):
            raise RuntimeError(f"b5_launch_shape({n}, {dh}) failed")
        warpgroup, passes, warps, smem, resident = (x.value for x in out)
        print(f"  B5'/B7 at {label} (N={n}, dh={dh}): "
              f"{'wgmma' if warpgroup else 'mma.sync'}, {passes} "
              f"pass{'es' if passes > 1 else ''} over the keys, {warps} warps "
              f"a block, {smem} bytes of shared memory, keys and values "
              f"{'resident' if resident else 'streamed'}")


def _weights(gen, k, df=D_FEAT, l=D_INNER):
    def uni(*shape, fan_in):
        b = fan_in ** -0.5
        return (torch.rand(*shape, generator=gen, device="cuda") * 2 - 1) * b

    return [uni(df, l, fan_in=df), torch.zeros(l, device="cuda"),
            uni(l, D_ATTN, fan_in=l), uni(D_ATTN, fan_in=l),
            uni(l, D_ATTN, fan_in=l), uni(D_ATTN, fan_in=l),
            uni(D_ATTN, k, fan_in=D_ATTN), uni(k, fan_in=D_ATTN)]


def _time_ms(fn, iters=30):
    """Mean device ms per call, L2 flushed before each call (a new slide
    arrives cold from the host)."""
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        total += e0.elapsed_time(e1)
    return total / iters


def _device_events(prof):
    """(name, us) of each event the profiler saw on the card: kernels,
    copies and sets. Only these are summed: a CPU op's self device time
    repeats the time of the kernels it launched. The schedule's step
    annotation, which spans a step on the card too, is left out."""
    from torch.autograd import DeviceType

    return [(e.name, e.time_range.elapsed_us()) for e in prof.events()
            if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and not e.name.startswith("ProfilerStep")]


def _profiled(fn, reps, before=None):
    """(profile of ``reps`` calls of ``fn``, host ms per call under it).
    Tracing starts one call early (the schedule's warm-up), and each call is
    waited on, so that the window holds every launch of its calls."""
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=reps,
                                   repeat=1)) as prof:
        for i in range(reps + 1):
            if i == 1:
                t0 = time.perf_counter()
            if before is not None:
                before()
            fn()
            torch.cuda.synchronize()
            prof.step()
    return prof, (time.perf_counter() - t0) * 1e3 / reps


def _device_ms(fn, kernels, reps=20):
    """(device ms per call of ``fn`` in the kernels whose names contain one
    of ``kernels``, their launches per call), from ``torch.profiler`` with
    the L2 flushed before each call as in ``_time_ms``: the kernels' own
    time, without the wrapper's host work that a CUDA-event span around a
    short call also holds. Each kernel's mean over the launches seen times
    its launches per call, so an event the trace lost does not count as 0
    ms. (None, 0) when the profiler sees none."""
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    prof, _ = _profiled(fn, reps, before=flush.zero_)
    by_name = {}
    for name, us in _device_events(prof):
        if any(k in name for k in kernels):
            by_name.setdefault(name, []).append(us)
    if not by_name:
        return None, 0
    per_call = {name: max(1, round(len(v) / reps))
                for name, v in by_name.items()}
    ms = sum(statistics.fmean(v) * per_call[name]
             for name, v in by_name.items()) / 1e3
    return ms, sum(per_call.values())


def _split_ms(kernels, fn, reps=10) -> dict:
    """Device ms per call of ``fn`` in each CUDA kernel named in
    ``kernels`` (``ap.B1_KERNELS``, ``ap.B2_KERNELS``), from one
    ``torch.profiler`` window with the L2 flushed before each call, as in
    ``_device_ms``."""
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    prof, _ = _profiled(fn, reps, before=flush.zero_)
    per = {}
    for name, us in _device_events(prof):
        for k in kernels:
            if k in name:
                per[k] = per.get(k, 0.0) + us / reps / 1e3
    return per


def _kernel_ms(fn, expect: dict, reps=10):
    """Device ms per call of ``fn`` in each kernel of ``expect`` ({part of
    the kernel's name: its launches per call}), from the first of up to
    three ``torch.profiler`` windows, the L2 flushed before each call, in
    which the trace holds each of those kernels exactly reps x its launches
    times. None where no window did: a window the trace lost events of is
    not scaled up to a whole one."""
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        prof, _ = _profiled(fn, reps, before=flush.zero_)
        seen = {k: [] for k in expect}
        for name, us in _device_events(prof):
            for k in expect:
                if k in name:
                    seen[k].append(us)
        if all(len(seen[k]) == reps * n for k, n in expect.items()):
            return {k: sum(v) / reps / 1e3 for k, v in seen.items()}
    return None


def _fmt_split(per: dict) -> str:
    return ", ".join(f"{k} {v:.4f}" for k, v in per.items())


def _fmt_ms(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def _bound_share(r: dict) -> str:
    """The bound as a share of the kernels' device time, or of the call's
    CUDA-event time where the profiler saw no device time."""
    t, what = ((r["device_ms"], "device") if r.get("device_ms")
               else (r["ms"], "call"))
    return f"{100 * r['bound_ms'] / t:.1f}% of bound ({what} time)"


def _wall_ms(fn, reps):
    """Median host ms of ``fn`` over ``reps`` calls, each waited on."""
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out)


def _host_ms(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


def _bound(flops: float, nbytes: float, peak: float = PEAK_FLOPS) -> dict:
    """The least time the card could take: the larger of the operations
    over ``peak`` (by default the bf16 tensor-core peak) and the bytes over
    the HBM rate."""
    t_ops = flops / peak * 1e3
    t_mem = nbytes / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(t_ops, t_mem),
            "bound_by": "operations" if t_ops >= t_mem else "bytes"}


def _f32_bound(flops: float, nbytes: float) -> dict:
    """``_bound`` of float32 products at f32 accuracy: the operations at
    the card's rate for them, three TF32 products each; the operations at
    the f32 FMA rate beside it as ``fma_bound_ms``."""
    return {**_bound(flops, nbytes, PEAK_TF32_FLOPS / 3),
            "fma_bound_ms": flops / PEAK_F32_FLOPS * 1e3}


def _pool_weight_count(k: int, df: int = D_FEAT, l: int = D_INNER) -> int:
    return df * l + l + 2 * (l * D_ATTN + D_ATTN) + D_ATTN * k + k


def _b1_bound(n: int, k: int, df: int = D_FEAT, l: int = D_INNER) -> dict:
    """B1 on one fp16 bag of n rows: x·W1, both gates, the logits and the
    pooling; reads the features, the mask and the f32 weights once, writes
    the logits, the bag and (m, s)."""
    flops = 2 * n * (df * l + 2 * l * D_ATTN + D_ATTN * k + k * l)
    nbytes = (n * df * 2 + n + 4 * _pool_weight_count(k, df, l)
              + 4 * (k * n + k * l + 2 * k))
    return _bound(flops, nbytes)


def _b2_bound(n: int, k: int, df: int = D_FEAT, l: int = D_INNER) -> dict:
    """B2 on one fp16 bag, weight gradients only: the forward's recompute
    (x·W1, gates, logits) and the backward's products (d_p, d_g, d_h, dW1,
    dV, dU, dw); reads features, mask, weights, lse, c, d_bag, d_logits,
    writes the weight gradients."""
    flops = 2 * n * (2 * df * l + 6 * l * D_ATTN + 3 * D_ATTN * k + 2 * l * k)
    nbytes = (n * df * 2 + n + 8 * _pool_weight_count(k, df, l)
              + 4 * (2 * k + k * l + k * n))
    return _bound(flops, nbytes)


def _rel_to_max(got, want) -> float:
    """Largest |got - want| relative to want's largest magnitude."""
    diff = float((got.float() - want.float()).abs().max())
    return diff / max(float(want.float().abs().max()), 1e-30)


def _b1_check(ap, gen, ws, k, n, b, dtype, df=D_FEAT, l=D_INNER) -> float:
    """B1 on one random batch against its plain version; the worst abs
    error of (bag, logits, m)."""
    x = torch.randn(b, n, df, generator=gen, device="cuda").to(dtype)
    m = torch.rand(b, n, generator=gen, device="cuda") < 0.9
    if b == 3:
        m[1] = False                  # an all-masked bag
    return _b1_against_plain(ap, x, m, ws, f"Df={df} L={l} K={k} N={n} B={b} "
                                           f"{str(dtype)[6:]}")


def _b1_against_plain(ap, x, m, ws, label, workspace=None) -> float:
    """B1 twice on (x, m) against its plain version; the two launches must
    agree bit for bit. The worst abs error of (bag, logits, m)."""
    got = ap.fused_gated_attn_pool_batched(x, m, *ws, return_stats=True,
                                           _workspace=workspace)
    again = ap.fused_gated_attn_pool_batched(x, m, *ws, return_stats=True)
    torch.cuda.synchronize()
    if not all(torch.equal(g, g2) for g, g2 in zip(got, again)):
        raise AssertionError(f"B1 differs between two launches ({label})")
    bag, lg, mx, s = got
    rbag, rlg = ap._reference_batched(x.float(), m, *ws)
    rmx, rs = ap._softmax_stats(rlg, m)
    valid = m[:, None, :].expand_as(lg)
    for got, want in ((bag, rbag), (lg[valid], rlg[valid]), (mx, rmx)):
        torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)
    torch.testing.assert_close(s, rs, atol=0, rtol=RTOL)
    if not bool((lg[~valid] == ap.NEG).all()):
        raise AssertionError("pad logits are not NEG")
    dead = ~m.any(dim=1)
    if bool(bag.isnan().any()) or bool(bag[dead].any()) \
            or bool(s[dead].any()) or not bool((mx[dead] == ap.NEG).all()):
        raise AssertionError("all-masked bag is not bag 0, s 0, m -1e30")
    err = max(float((bag - rbag).abs().max()),
              float((lg[valid] - rlg[valid]).abs().max()),
              float((mx - rmx).abs().max()))
    s_rel = float(((s - rs).abs() / rs.abs().clamp_min(1e-30)).max())
    print(f"kernel B1 vs plain: {label}: max_abs_err {err:.3e} (bag, "
          f"logits, m), s rel err {s_rel:.3e}, two launches identical")
    return err


def _stress_bag(gen, ws, df, dtype):
    """Three bags of 4099 rows (one all masked) whose near-0 pre-activations
    crowd the H stage's recompute: rows 1-5, 200 and 4098 of bag 0 and row 7
    of bag 2 copy row 0 of bag 0, and b1 = -(x_0 W1), formed on the card,
    puts every pre-activation of those rows within rounding of 0 (six rows
    of one 128-row tile list 768 elements, past a tile's list of 512). (x,
    mask, weights with that b1)."""
    n = 4099
    x = torch.randn(3, n, df, generator=gen, device="cuda").to(dtype)
    m = torch.rand(3, n, generator=gen, device="cuda") < 0.9
    m[1] = False
    row = x[0, 0].clone()
    x[0, [1, 2, 3, 4, 5, 200, n - 1]] = row
    x[2, 7] = row
    m[0, :6] = True
    return x, m, [ws[0], -(row.float() @ ws[0]), *ws[2:]]


def _b1_stress_check(ap, gen, df, l, dtype) -> float:
    """B1 on the stress bag against its plain version, and its H against
    B2's H on the same inputs, bit for bit."""
    x, m, ws = _stress_bag(gen, _weights(gen, N_TOKEN, df, l), df, dtype)
    fwd, bwd = {}, {}
    err = _b1_against_plain(ap, x, m, ws, f"stress bag Df={df} L={l} "
                            f"K={N_TOKEN} N={x.shape[1]} B=3 "
                            f"{str(dtype)[6:]}", fwd)
    listed = int(fwd["near_counts"].sum())
    # per 128 columns: rows 0-5 list 512 of their 768, the other three 384
    if listed < 6 * l:
        raise AssertionError(f"the stress bag listed only {listed} near-0 "
                             f"elements")
    lse, c, d_bag, d_logits = _bwd_inputs(ap, gen, ws, x, m, N_TOKEN)
    ap.fused_gated_attn_pool_bwd(x, m, *ws, lse, c, d_bag, d_logits,
                                 need_dx=False, _workspace=bwd)
    torch.cuda.synchronize()
    if not torch.equal(fwd["h"], bwd["h"]):
        raise AssertionError(f"B1's H differs from B2's H (Df={df} L={l} "
                             f"{dtype})")
    print(f"  B1's H equals B2's H bit for bit; {listed} near-0 elements "
          f"listed")
    return err


@torch.no_grad()
def kernel_vs_plain(smi: str) -> dict:
    from acmil_tpu_torch.ops import attn_pool as ap

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    worst = 0.0
    for k in (N_TOKEN, 1):
        ws = _weights(gen, k)
        for n in (300, 16384, 65536):
            for b in (1, 3):
                for dtype in (torch.float16, torch.float32):
                    worst = max(worst, _b1_check(ap, gen, ws, k, n, b, dtype))
    # every other pretrain width (32-row tiles), K up to the kernel's 128
    for df, l in WIDE_DIMS:
        for k in (N_TOKEN, 128):
            ws = _weights(gen, k, df, l)
            for n, b in ((300, 3), (65536, 1)):
                for dtype in (torch.float16, torch.float32):
                    worst = max(worst, _b1_check(ap, gen, ws, k, n, b, dtype,
                                                 df, l))
    # near-0 pre-activations in crowds, at every width
    for df, l in ((D_FEAT, D_INNER),) + WIDE_DIMS:
        for dtype in (torch.float16, torch.float32):
            worst = max(worst, _b1_stress_check(ap, gen, df, l, dtype))
    times = {}
    ws = _weights(gen, N_TOKEN)
    for n in (16384, 65536):
        x = torch.randn(1, n, D_FEAT, generator=gen, device="cuda").half()
        m = torch.ones(1, n, dtype=torch.bool, device="cuda")
        t_k = _time_ms(lambda: ap.fused_gated_attn_pool_batched(x, m, *ws))
        t_p = _time_ms(lambda: ap._reference_batched(x.float(), m, *ws))
        flops = 2 * n * (D_FEAT * D_INNER + 2 * D_INNER * D_ATTN
                         + D_ATTN * N_TOKEN + N_TOKEN * D_INNER)
        tflops = flops / (t_k * 1e-3) / 1e12
        print(f"kernel B1 time: N={n} B=1 K={N_TOKEN} fp16: kernel {t_k:.4f} ms, "
              f"plain {t_p:.4f} ms, kernel {tflops:.1f} TFLOP/s [{smi}]")
        times[n] = (t_k, t_p)
    call = lambda: ap.fused_gated_attn_pool_batched(x, m, *ws)  # noqa: E731
    dev, per_call = _device_ms(call, ap.B1_KERNELS)
    by_kernel = {f"L={D_INNER}": _split_ms(ap.B1_KERNELS, call)}
    print(f"kernel B1 device time: N=65536 B=1 K={N_TOKEN} fp16: "
          f"{_fmt_ms(dev)} in {per_call:g} launches per call [{smi}]")
    print(f"kernel B1 device time by kernel, ms: L={D_INNER}: "
          f"{_fmt_split(by_kernel[f'L={D_INNER}'])} [{smi}]")
    wide = {}
    for df, l in WIDE_DIMS:
        ws = _weights(gen, N_TOKEN, df, l)
        x = torch.randn(1, 65536, df, generator=gen, device="cuda").half()
        call = lambda: ap.fused_gated_attn_pool_batched(x, m, *ws)  # noqa: E731
        r = {"device_ms": _device_ms(call, ap.B1_KERNELS)[0],
             "plain_ms": _time_ms(
                 lambda: ap._reference_batched(x.float(), m, *ws), 10),
             **_b1_bound(65536, N_TOKEN, df, l)}
        print(f"kernel B1 device time: Df={df} L={l} N=65536 B=1 "
              f"K={N_TOKEN} fp16: {_fmt_ms(r['device_ms'])}, plain "
              f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}), {_bound_share(r)} [{smi}]")
        if l == WIDE_DIMS[-1][1]:
            by_kernel[f"L={l}"] = _split_ms(ap.B1_KERNELS, call)
            print(f"kernel B1 device time by kernel, ms: L={l}: "
                  f"{_fmt_split(by_kernel[f'L={l}'])} [{smi}]")
        wide[f"L={l}"] = r
    return {"max_abs_err": worst, "ms": times[65536][0], "device_ms": dev,
            "plain_ms": times[65536][1], **_b1_bound(65536, N_TOKEN),
            "library_ms": None, "wider_l": wide, "by_kernel": by_kernel}


GRAD_NAMES = ("dx", "dW1", "db1", "dV", "dbv", "dU", "dbu", "dw", "dbw")


def _bwd_inputs(ap, gen, ws, x, m, k):
    """B1's forward on (x, m) and what the backward takes from it: lse, c,
    and random cotangents, d_logits nonzero at pad slots too."""
    b, n, _ = x.shape
    l = ws[0].shape[1]
    bag, _, mx, s = ap.fused_gated_attn_pool_batched(x, m, *ws,
                                                      return_stats=True)
    lse = mx + torch.log(s.clamp_min(1e-30))
    d_bag = torch.randn(b, k, l, generator=gen, device="cuda")
    d_logits = torch.randn(b, k, n, generator=gen, device="cuda")
    return lse, (d_bag * bag).sum(dim=2), d_bag, d_logits


def _reference_vjp(ap, x, m, ws, d_bag, d_logits, need_dx):
    """Torch autograd through the plain forward, f32."""
    with torch.enable_grad():
        xr = x.float().requires_grad_(need_dx)
        wr = [w.detach().clone().requires_grad_() for w in ws]
        outs = ap._reference_batched(xr, m, *wr)
        grads = torch.autograd.grad(outs, ([xr] if need_dx else []) + wr,
                                    (d_bag, d_logits))
    return ((grads[0] if need_dx else None),) + tuple(grads[-8:])


def _b2_check(ap, gen, ws, k, n, b, dtype, df=D_FEAT, l=D_INNER):
    """B2 on one random batch, dx off and on, against its plain closed form
    and autograd through the plain forward; two launches must agree bit
    for bit. (worst abs error, worst error relative to each output's
    largest magnitude)."""
    worst_abs = worst_rel = 0.0
    x = torch.randn(b, n, df, generator=gen, device="cuda").to(dtype)
    m = torch.rand(b, n, generator=gen, device="cuda") < 0.9
    if b == 3:
        m[1] = False                  # an all-masked bag
    lse, c, d_bag, d_logits = _bwd_inputs(ap, gen, ws, x, m, k)
    for need_dx in (False, True):
        args = (x, m, *ws, lse, c, d_bag, d_logits)
        got = ap.fused_gated_attn_pool_bwd(*args, need_dx=need_dx)
        again = ap.fused_gated_attn_pool_bwd(*args, need_dx=need_dx)
        torch.cuda.synchronize()
        for name, g, g2 in zip(GRAD_NAMES, got, again):
            if g is not None and not torch.equal(g, g2):
                raise AssertionError(f"B2 {name} differs between two launches")
        plain = ap._fused_pool_bwd_stats(*args, need_dx=need_dx)
        auto = _reference_vjp(ap, x, m, ws, d_bag, d_logits, need_dx)
        errs = []
        for name, g, p, a in zip(GRAD_NAMES, got, plain, auto):
            if g is None:
                if p is not None or need_dx:
                    raise AssertionError(f"B2 gave no {name}")
                continue
            tol = BWD_REL_FP16 if g.dtype == torch.float16 else BWD_REL
            rel = max(_rel_to_max(g, p), _rel_to_max(g, a))
            if not rel <= tol:
                raise AssertionError(
                    f"B2 {name} off by {rel:.3e} of its max (Df={df} L={l} "
                    f"K={k} N={n} B={b} {dtype} dx={need_dx})")
            errs.append(rel)
            worst_abs = max(worst_abs, float((g.float() - p.float()).abs().max()))
        worst_rel = max(worst_rel, max(errs))
        if need_dx and bool(got[0][~m].any()):
            raise AssertionError("B2 dx is nonzero at pad rows")
        print(f"kernel B2 vs plain: Df={df} L={l} K={k} N={n} B={b} "
              f"{str(dtype)[6:]} dx={'on' if need_dx else 'off'}: worst "
              f"error {max(errs):.3e} of max (vs closed form and vs "
              f"autograd), two launches identical")
    return worst_abs, worst_rel


@torch.no_grad()
def bwd_kernel_vs_plain(smi: str) -> dict:
    from acmil_tpu_torch.ops import attn_pool as ap

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    worst_abs = worst_rel = 0.0
    cases = [(k, D_FEAT, D_INNER, n, b, dtype) for k in (N_TOKEN, 1)
             for n in (300, 16384, 65536) for b in (1, 3)
             for dtype in (torch.float16, torch.float32)]
    # every other pretrain width (panels of 128 columns, longer products)
    cases += [(k, df, l, n, b, dtype) for df, l in WIDE_DIMS
              for k, n, b in ((N_TOKEN, 300, 3), (128, 4099, 1),
                              (N_TOKEN, 65536, 1))
              for dtype in (torch.float16, torch.float32)]
    for k, df, l, n, b, dtype in cases:
        ws = _weights(gen, k, df, l)
        a, r = _b2_check(ap, gen, ws, k, n, b, dtype, df, l)
        worst_abs, worst_rel = max(worst_abs, a), max(worst_rel, r)
    times = {}
    ws = _weights(gen, N_TOKEN)
    for n in (16384, 65536):
        x = torch.randn(1, n, D_FEAT, generator=gen, device="cuda").half()
        m = torch.ones(1, n, dtype=torch.bool, device="cuda")
        lse, c, d_bag, d_logits = _bwd_inputs(ap, gen, ws, x, m, N_TOKEN)
        t_k = _time_ms(lambda: ap.fused_gated_attn_pool_bwd(
            x, m, *ws, lse, c, d_bag, d_logits, need_dx=False))
        with torch.enable_grad():
            wr = [w.detach().clone().requires_grad_() for w in ws]
            outs = ap._reference_batched(x.float(), m, *wr)
            t_p = _time_ms(lambda: torch.autograd.grad(
                outs, wr, (d_bag, d_logits), retain_graph=True))
        print(f"kernel B2 time: N={n} B=1 K={N_TOKEN} fp16, weight gradients "
              f"only: kernel {t_k:.4f} ms, plain autograd backward "
              f"{t_p:.4f} ms [{smi}]")
        times[n] = (t_k, t_p)
    def split(fn):
        return _fmt_split(_split_ms(ap.B2_KERNELS, fn))

    kernels = ap.B2_KERNELS
    call = lambda: ap.fused_gated_attn_pool_bwd(     # noqa: E731
        x, m, *ws, lse, c, d_bag, d_logits, need_dx=False)
    dev, per_call = _device_ms(call, kernels)
    print(f"kernel B2 device time: N=65536 B=1 K={N_TOKEN} fp16, weight "
          f"gradients only: {_fmt_ms(dev)} in {per_call:g} launches per call "
          f"[{smi}]")
    print(f"kernel B2 device time by kernel, ms: L={D_INNER}: {split(call)} "
          f"[{smi}]")
    wide = {}
    for df, l in WIDE_DIMS:
        ws = _weights(gen, N_TOKEN, df, l)
        x = torch.randn(1, 65536, df, generator=gen, device="cuda").half()
        lse, c, d_bag, d_logits = _bwd_inputs(ap, gen, ws, x, m, N_TOKEN)
        with torch.enable_grad():
            wr = [w.detach().clone().requires_grad_() for w in ws]
            outs = ap._reference_batched(x.float(), m, *wr)
            t_p = _time_ms(lambda: torch.autograd.grad(
                outs, wr, (d_bag, d_logits), retain_graph=True), 10)
        call = lambda: ap.fused_gated_attn_pool_bwd(     # noqa: E731
            x, m, *ws, lse, c, d_bag, d_logits, need_dx=False)
        r = {"device_ms": _device_ms(call, kernels)[0],
             "plain_ms": t_p, **_b2_bound(65536, N_TOKEN, df, l)}
        print(f"kernel B2 device time: Df={df} L={l} N=65536 B=1 "
              f"K={N_TOKEN} fp16, weight gradients only: "
              f"{_fmt_ms(r['device_ms'])}, plain autograd {t_p:.4f} ms, "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
              f"{_bound_share(r)} [{smi}]")
        if l == WIDE_DIMS[-1][1]:
            print(f"kernel B2 device time by kernel, ms: L={l}: "
                  f"{split(call)} [{smi}]")
        wide[f"L={l}"] = r
    return {"max_abs_err": worst_abs, "max_rel_to_max_err": worst_rel,
            "ms": times[65536][0], "device_ms": dev,
            "plain_ms": times[65536][1], **_b2_bound(65536, N_TOKEN),
            "library_ms": None, "wider_l": wide}


def _synthetic_slides(rs, lengths, d_feat=D_FEAT):
    """fp16 bags of the given lengths; odd slides carry a shifted 5% of
    their patches, the class signal."""
    slides = {}
    for i, n in enumerate(lengths):
        feat = rs.standard_normal((n, d_feat), dtype=np.float32)
        label = i % 2
        if label:
            feat[rs.choice(n, n // 20, replace=False)] += 1.5
        slides[f"slide_{i:02d}"] = {"feat": feat.astype(np.float16),
                                    "coords": rs.integers(0, 100000, (n, 2)),
                                    "label": label}
    return slides


def _check_predictions(res, n_slides, n_class):
    probs = np.asarray([r[2:2 + n_class] for r in res["rows"]])
    if probs.shape != (n_slides, n_class) or not np.isfinite(probs).all():
        raise AssertionError(f"bad probabilities {probs.shape}")
    np.testing.assert_allclose(probs.sum(axis=1), 1.0, atol=1e-5)


@torch.no_grad()
def slice_run(smi: str) -> int:
    from acmil_tpu_torch.cli import predict
    from acmil_tpu_torch.config import Config
    from acmil_tpu_torch.data.bags import pad_bag
    from acmil_tpu_torch.data.ptio import write_feature_pt
    from acmil_tpu_torch.engine import checkpoint, make_eval_step
    from acmil_tpu_torch.models import build_mil_model
    from acmil_tpu_torch.models.common import torch_linear_init_
    from acmil_tpu_torch.ops.attn_pool import fused_gated_attn_pool_batched

    conf = Config.from_yaml(YML, {"arch": "ga", "n_token": N_TOKEN})
    if (conf.D_feat, conf.D_inner) != (D_FEAT, D_INNER):
        raise AssertionError(f"unexpected widths {conf.D_feat}/{conf.D_inner}")
    model, family = build_mil_model(conf)
    torch_linear_init_(model, torch.Generator().manual_seed(SEED))
    rs = np.random.default_rng(SEED)
    lengths = [1000, 50000] + rs.integers(1000, 50001, 14).tolist()
    slides = _synthetic_slides(rs, lengths)
    with tempfile.TemporaryDirectory() as tmp:
        feats = os.path.join(tmp, "feats.pt")
        ckpt = os.path.join(tmp, "checkpoint-best.pth")
        write_feature_pt(feats, slides)
        checkpoint.save(ckpt, model, epoch=0, conf=conf)
        argv = ["--config", YML, "--ckpt", ckpt, "--features", feats,
                "--out_csv", os.path.join(tmp, "preds.csv"), "--device", "cuda"]

        fused_gated_attn_pool_batched.launches = 0
        t0 = time.perf_counter()
        res = predict.main(argv)
        wall = time.perf_counter() - t0
        launches = fused_gated_attn_pool_batched.launches

    if launches != len(slides):
        raise AssertionError(f"B1 launched {launches} times for "
                             f"{len(slides)} slides (one batch each)")
    _check_predictions(res, len(slides), conf.n_class)

    model.cuda().eval()
    steps = {"fused": make_eval_step(model, family, fused=True),
             "plain": make_eval_step(model, family, fused=False)}
    lat = {route: [] for route in steps}
    worst = 0.0
    for row in res["rows"]:
        item = slides[row[0]]
        bag = pad_bag(item["feat"], item["coords"], item["label"],
                      min_bucket=conf.min_bucket,
                      max_patches=conf.max_patches, dtype=np.float16).to("cuda")
        plain = steps["plain"](bag)[0].cpu().numpy()
        worst = max(worst, float(np.abs(plain - row[2:2 + conf.n_class]).max()))
        for route, step in steps.items():
            step(bag)
            lat[route].append(_wall_ms(lambda: step(bag), 5))
    if worst > PROB_ATOL:
        raise AssertionError(f"fused and plain probabilities differ by {worst}")
    print(f"serving: {len(slides)} slides ({min(lengths)}-{max(lengths)} patches) "
          f"scored by cli/predict.py in {wall:.2f} s; B1 launches {launches}; "
          f"probabilities finite, rows sum to 1, max |fused - plain| {worst:.3e}")
    if res["metrics"] is not None:
        print("serving metrics (random weights): " + json.dumps(res["metrics"]))
    big = [r[0] for r in res["rows"]].index("slide_01")     # 50000 patches
    print(f"serving per-slide latency, bag on the device, median over slides: "
          f"fused {statistics.median(lat['fused']):.4f} ms, "
          f"plain {statistics.median(lat['plain']):.4f} ms; at 50000 patches: "
          f"fused {lat['fused'][big]:.4f} ms, plain {lat['plain'][big]:.4f} ms "
          f"[{smi}]")
    return launches


@torch.no_grad()
def wide_serve_run(smi: str) -> int:
    """An ACMIL_GA head at the natural_supervised widths (Df 512, L 256)
    scores slides through ``cli/predict.py`` on ``cuda``: B1 at L = 256."""
    from acmil_tpu_torch.cli import predict
    from acmil_tpu_torch.config import Config
    from acmil_tpu_torch.data.bags import pad_bag
    from acmil_tpu_torch.data.ptio import write_feature_pt
    from acmil_tpu_torch.engine import checkpoint, make_eval_step
    from acmil_tpu_torch.models import build_mil_model
    from acmil_tpu_torch.models.common import torch_linear_init_
    from acmil_tpu_torch.ops.attn_pool import fused_gated_attn_pool_batched

    conf = Config.from_yaml(WIDE_YML, {"arch": "ga", "n_token": N_TOKEN})
    if (conf.D_feat, conf.D_inner) != WIDE_DIMS[0]:
        raise AssertionError(f"unexpected widths {conf.D_feat}/{conf.D_inner}")
    model, family = build_mil_model(conf)
    torch_linear_init_(model, torch.Generator().manual_seed(SEED))
    rs = np.random.default_rng(SEED + 8)
    lengths = [1000, 50000] + rs.integers(1000, 50001, WIDE_SLIDES - 2).tolist()
    slides = _synthetic_slides(rs, lengths, conf.D_feat)
    with tempfile.TemporaryDirectory() as tmp:
        feats = os.path.join(tmp, "feats.pt")
        ckpt = os.path.join(tmp, "checkpoint-best.pth")
        write_feature_pt(feats, slides)
        checkpoint.save(ckpt, model, epoch=0, conf=conf)
        fused_gated_attn_pool_batched.launches = 0
        t0 = time.perf_counter()
        res = predict.main(["--config", WIDE_YML, "--ckpt", ckpt, "--features",
                            feats, "--out_csv", os.path.join(tmp, "preds.csv"),
                            "--device", "cuda"])
        wall = time.perf_counter() - t0
        launches = fused_gated_attn_pool_batched.launches
    if launches != len(slides):
        raise AssertionError(f"B1 launched {launches} times for "
                             f"{len(slides)} slides at L={conf.D_inner}")
    _check_predictions(res, len(slides), conf.n_class)
    model.cuda().eval()
    plain = make_eval_step(model, family, fused=False)
    worst = 0.0
    for row in res["rows"]:
        item = slides[row[0]]
        bag = pad_bag(item["feat"], item["coords"], item["label"],
                      min_bucket=conf.min_bucket,
                      max_patches=conf.max_patches, dtype=np.float16).to("cuda")
        want = plain(bag)[0].cpu().numpy()
        worst = max(worst, float(np.abs(want - row[2:2 + conf.n_class]).max()))
    if worst > PROB_ATOL:
        raise AssertionError(f"fused and plain probabilities differ by {worst}")
    print(f"serving at the natural_supervised widths (Df={conf.D_feat}, "
          f"L={conf.D_inner}): {len(slides)} slides ({min(lengths)}-"
          f"{max(lengths)} patches) scored by cli/predict.py in {wall:.2f} s; "
          f"B1 launches {launches}; probabilities finite, rows sum to 1, max "
          f"|fused - plain| {worst:.3e} [{smi}]")
    return launches


def _write_split_corpus(tmp, slides, yml, pretrain, n_train, n_val):
    """The feature file, Step3's frozen split for its default seed 4 (the
    first n_train sorted slides train, the next n_val validate, the rest
    test) and a copy of ``yml`` pointing at it; (data_dir, feature file,
    config)."""
    from acmil_tpu_torch.data.ptio import write_feature_pt

    names = sorted(slides)
    data_dir = os.path.join(tmp, "data")
    feats = os.path.join(data_dir, f"patch_feats_pretrain_{pretrain}.pt")
    write_feature_pt(feats, slides)
    split_dir = os.path.join(tmp, "splits")
    os.makedirs(os.path.join(split_dir, "camelyon"))
    with open(os.path.join(split_dir, "camelyon", "split_4.json"), "w") as f:
        json.dump({"train_names": names[:n_train],
                   "val_names": names[n_train:n_train + n_val],
                   "test_names": names[n_train + n_val:]}, f)
    conf = os.path.join(tmp, "config.yml")
    with open(yml) as src, open(conf, "w") as dst:
        dst.write(src.read() + f"\nsplit_dir: {split_dir}\n")
    return data_dir, feats, conf


def wide_train_run(smi: str) -> dict:
    """One epoch of the ACMIL recipe at the natural_supervised widths (Df
    512, L 256) through ``cli/step3_acmil.py`` on ``cuda``: B1 and B2 at
    L = 256."""
    from acmil_tpu_torch.cli import step3_acmil
    from acmil_tpu_torch.ops import attn_pool as ap

    rs = np.random.default_rng(SEED + 9)
    n_train, n_val, n_test = WIDE_TRAIN
    lengths = [1000, 50000] + rs.integers(
        1000, 50001, n_train + n_val + n_test - 2).tolist()
    slides = _synthetic_slides(rs, lengths, WIDE_DIMS[0][0])
    with tempfile.TemporaryDirectory() as tmp:
        data_dir, _, yml = _write_split_corpus(tmp, slides, WIDE_YML,
                                               "natural_supervised", n_train,
                                               n_val)
        log_dir = os.path.join(tmp, "log")
        argv = ["--config", yml, "--data_dir", data_dir, "--ckpt_dir",
                os.path.join(tmp, "ckpt"), "--log_dir", log_dir,
                "--train_epoch", "1", "--n_token", str(N_TOKEN),
                "--n_masked_patch", str(N_MASKED_PATCH), "--mask_drop",
                str(MASK_DROP), "--device", "cuda"]
        ap.fused_gated_attn_pool_batched.launches = 0
        ap.fused_gated_attn_pool_bwd.launches = 0
        t0 = time.perf_counter()
        step3_acmil.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"B1": ap.fused_gated_attn_pool_batched.launches,
                    "B2": ap.fused_gated_attn_pool_bwd.launches}
        with open(os.path.join(log_dir, "metrics.jsonl")) as f:
            losses = [r["train/loss"] for r in map(json.loads, f)
                      if "_config" not in r]
    evals = n_val + n_test
    if launches["B2"] != n_train or launches["B1"] != n_train + evals:
        raise AssertionError(f"launches {launches}: want B2 once per train "
                             f"step ({n_train}), B1 once per step and eval "
                             f"bag ({n_train + evals})")
    if len(losses) != 1 or not math.isfinite(losses[0]):
        raise AssertionError(f"epoch losses {losses}")
    print(f"training at the natural_supervised widths (Df={WIDE_DIMS[0][0]}, "
          f"L={WIDE_DIMS[0][1]}): cli/step3_acmil.py, 1 epoch x {n_train} "
          f"steps on {len(slides)} slides, {wall:.2f} s wall; launches B1 "
          f"{launches['B1']}, B2 {launches['B2']}; epoch loss "
          f"{losses[0]:.6f} [{smi}]")
    return launches


def train_run(smi: str) -> dict:
    """The slice's main path: Step3 ACMIL training through the port's CLI."""
    from acmil_tpu_torch.cli import predict, step3_acmil
    from acmil_tpu_torch.ops import attn_pool as ap

    rs = np.random.default_rng(SEED + 1)
    n_slides = N_TRAIN + N_VAL + N_TEST
    lengths = [1000, 50000] + rs.integers(1000, 50001, n_slides - 2).tolist()
    slides = _synthetic_slides(rs, lengths)
    with tempfile.TemporaryDirectory() as tmp:
        data_dir, feats, yml = _write_split_corpus(tmp, slides, YML,
                                                   "medical_ssl", N_TRAIN,
                                                   N_VAL)
        ckpt_dir, log_dir = os.path.join(tmp, "ckpt"), os.path.join(tmp, "log")
        argv = ["--config", yml, "--data_dir", data_dir, "--ckpt_dir", ckpt_dir,
                "--log_dir", log_dir, "--train_epoch", str(TRAIN_EPOCHS),
                "--n_token", str(N_TOKEN), "--n_masked_patch",
                str(N_MASKED_PATCH), "--mask_drop", str(MASK_DROP),
                "--device", "cuda"]

        ap.fused_gated_attn_pool_batched.launches = 0
        ap.fused_gated_attn_pool_bwd.launches = 0
        t0 = time.perf_counter()
        best = step3_acmil.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"B1": ap.fused_gated_attn_pool_batched.launches,
                    "B2": ap.fused_gated_attn_pool_bwd.launches}

        steps = TRAIN_EPOCHS * N_TRAIN
        evals = TRAIN_EPOCHS * (N_VAL + N_TEST)
        if launches["B2"] != steps or launches["B1"] != steps + evals:
            raise AssertionError(
                f"launches {launches}: want B2 once per train step ({steps}) "
                f"and B1 once per step and eval bag ({steps + evals})")
        with open(os.path.join(log_dir, "metrics.jsonl")) as f:
            epochs = [r for r in map(json.loads, f) if "_config" not in r]
        losses = [r["train/loss"] for r in epochs]
        if len(losses) != TRAIN_EPOCHS or not all(map(math.isfinite, losses)):
            raise AssertionError(f"epoch losses {losses}")
        for tag in ("best", "last"):
            if not os.path.isfile(os.path.join(ckpt_dir, f"checkpoint-{tag}.pth")):
                raise AssertionError(f"no checkpoint-{tag}.pth")
        res = predict.main(["--config", yml, "--ckpt", ckpt_dir, "--features",
                            feats, "--out_csv", os.path.join(tmp, "preds.csv"),
                            "--device", "cuda"])
        _check_predictions(res, n_slides, 2)
    print(f"training: cli/step3_acmil.py, {TRAIN_EPOCHS} epochs x {N_TRAIN} "
          f"steps on {n_slides} slides ({min(lengths)}-{max(lengths)} patches), "
          f"{wall:.2f} s wall; launches B1 {launches['B1']} (= {steps} steps + "
          f"{evals} eval bags), B2 {launches['B2']}; epoch losses "
          f"{', '.join(f'{v:.6f}' for v in losses)}; best epoch "
          f"{best.get('epoch')}; checkpoint-best rescored {n_slides} slides "
          f"through cli/predict.py")
    return launches


def train_routes(smi: str) -> None:
    """Fused (B1 + B2) against plain (forward and autograd) training."""
    from acmil_tpu_torch.config import Config
    from acmil_tpu_torch.data.bags import pad_bag
    from acmil_tpu_torch.engine import (create_train_state, get_family,
                                        make_train_step)
    from acmil_tpu_torch.models import build_mil_model

    def route_conf(fused, stkim=True):
        return Config.from_yaml(YML, {
            "arch": "ga", "n_token": N_TOKEN, "fused_train": fused,
            "n_masked_patch": N_MASKED_PATCH if stkim else 0,
            "mask_drop": MASK_DROP})

    conf = route_conf(True)
    torch.manual_seed(SEED)
    model0, family = build_mil_model(conf)
    fam = get_family(family)
    rs = np.random.default_rng(SEED + 2)
    lengths = [50000, 20000, 35000]
    bags = [pad_bag(d["feat"], d["coords"], d["label"],
                    min_bucket=conf.min_bucket, max_patches=conf.max_patches,
                    dtype=np.float16).to("cuda")
            for d in _synthetic_slides(rs, lengths).values()]
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    us = [torch.rand(1, N_TOKEN, b.feats.shape[1], generator=gen,
                     device="cuda") for b in bags]

    one = {}
    for fused in (True, False):
        c = route_conf(fused)
        model = copy.deepcopy(model0).cuda()
        conf_d = fam.conf_dict(c)
        out = fam.train_outputs(model, bags[0], conf_d, stkim_u=us[0])
        loss, _ = fam.loss(out, bags[0], bags[0].mask.any(dim=1), conf_d)
        loss.backward()
        one[fused] = (float(loss.detach()),
                      {n: p.grad for n, p in model.named_parameters()})
    (l_f, g_f), (l_p, g_p) = one[True], one[False]
    if not abs(l_f - l_p) <= STEP_LOSS_RTOL * abs(l_p):
        raise AssertionError(f"one-step loss: fused {l_f} plain {l_p}")
    for n in g_p:
        err = float((g_f[n] - g_p[n]).abs().max())
        if not err <= STEP_GRAD_REL * float(g_p[n].abs().max()) + STEP_GRAD_ATOL:
            raise AssertionError(f"one-step gradient of {n} differs by {err:.3e}")
    worst = max(_rel_to_max(g_f[n], g_p[n]) for n in g_p
                if n != "attention.attention_weights.bias")
    print(f"training routes, one step at {lengths[0]} patches, STKIM on with "
          f"the same uniforms: loss fused {l_f:.7f} plain {l_p:.7f}; worst "
          f"gradient difference {worst:.3e} of its max over the other "
          f"{len(g_p) - 1} tensors, attention output bias "
          f"|fused| {float(g_f['attention.attention_weights.bias'].abs().max()):.3e} "
          f"|plain| {float(g_p['attention.attention_weights.bias'].abs().max()):.3e}")

    losses, per_step = {}, {}
    for name, fused, stkim in (("fused", True, True), ("plain", False, True),
                               ("fused, STKIM off", True, False)):
        c = route_conf(fused, stkim)
        model = copy.deepcopy(model0).cuda()
        state = create_train_state(model, c, steps_per_epoch=len(bags))
        step = make_train_step(model, c, family)
        losses[name] = [float(step(state, bags[i % 3], stkim_u=us[i % 3])["loss"])
                        for i in range(5)]
        per_step[name] = _wall_ms(lambda: step(state, bags[0], stkim_u=us[0]),
                                  20)
    worst = max(abs(a - b) / abs(b) for a, b in zip(losses["fused"],
                                                    losses["plain"]))
    if not worst <= ADAM_LOSS_RTOL:
        raise AssertionError(f"AdamW losses: {losses}")
    print(f"training routes, five AdamW steps over 3 bags: losses fused "
          f"{losses['fused']} plain {losses['plain']}, worst relative "
          f"difference {worst:.3e}")
    print(f"training step wall time at {lengths[0]} patches (bucket "
          f"{bags[0].feats.shape[1]}), median of 20, bag on the device: "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in per_step.items())
          + f" [{smi}]")


def _layer_flops(n: int, d: int, hidden: int, mlp: bool) -> int:
    """One image through a ViT layer (mlp) or its attention half: the qkv,
    proj (and fc1, fc2) products and QK^T and PV over all heads."""
    flops = 2 * n * d * 3 * d + 2 * n * d * d + 4 * n * n * d
    return flops + (4 * n * d * hidden if mlp else 0)


def _layer_bytes(b: int, n: int, d: int, hidden: int, mlp: bool,
                 ls: bool) -> int:
    """bf16 x read and out written once; the bf16 matrices (cast once, as
    ``cast_kernel_weights`` gives them to the chain) and the f32 biases and
    LN parameters read once."""
    matrices = d * 3 * d + d * d + (2 * d * hidden if mlp else 0)
    vectors = 3 * d + d + 2 * d + (d if ls else 0)
    if mlp:
        vectors += hidden + d + 2 * d
    return 2 * 2 * b * n * d + 2 * matrices + 4 * vectors


def _gemm_shapes(m: int, d: int, hidden: int, mlp: bool) -> list:
    """(M, K, N) of a chain's GEMMs: qkv and proj (and fc1, fc2)."""
    shapes = [(m, d, 3 * d), (m, d, d)]
    return shapes + ([(m, d, hidden), (m, hidden, d)] if mlp else [])


def _library_gemms(gen, shapes, kern: str, smi: str) -> float:
    """The sum over a chain's GEMM shapes of one bf16 ``torch.matmul``
    call's time (CUDA events, L2 flushed): the library yardstick of the
    chain's GEMMs. The port never calls it."""
    total = 0.0
    for m, k, n in shapes:
        a = torch.randn(m, k, generator=gen, device="cuda").bfloat16()
        w = torch.randn(n, k, generator=gen, device="cuda").bfloat16()
        t = _time_ms(lambda: torch.matmul(a, w.t()), 20)
        print(f"library yardstick for {kern}: bf16 torch.matmul M={m} K={k} "
              f"N={n}: {t:.4f} ms ({2 * m * k * n / (t * 1e-3) / 1e12:.1f} "
              f"TFLOP/s) [{smi}]")
        total += t
    return total


def _vit_weights(gen, d, hidden, ls=False):
    """A layer's weights in the port's layout, seeded: LN near identity,
    Linear U(±scale/sqrt(fan_in)), qkv three times wider so the softmax is
    not flat; layerscale U(0.25, 0.75)."""
    def lin(out, inp, scale=1.0):
        w = (torch.rand(out, inp, generator=gen, device="cuda") * 2 - 1)
        return w * scale / math.sqrt(inp), 0.1 * torch.randn(
            out, generator=gen, device="cuda")

    def vec(base):
        return base + 0.1 * torch.randn(d, generator=gen, device="cuda")

    w = {"norm1.weight": vec(1.0), "norm1.bias": vec(0.0),
         "norm2.weight": vec(1.0), "norm2.bias": vec(0.0)}
    w["attn.qkv.weight"], w["attn.qkv.bias"] = lin(3 * d, d, 3.0)
    w["attn.proj.weight"], w["attn.proj.bias"] = lin(d, d)
    w["mlp.fc1.weight"], w["mlp.fc1.bias"] = lin(hidden, d)
    w["mlp.fc2.weight"], w["mlp.fc2.bias"] = lin(d, hidden)
    if ls:
        w["ls1.gamma"] = 0.25 + 0.5 * torch.rand(d, generator=gen,
                                                 device="cuda")
    return w


def _cast_matrices(w: dict) -> dict:
    """A layer's weights with its four matrices in bf16, the form the main
    path's ``cast_kernel_weights`` hands the chains."""
    return {k: v.bfloat16() if v.dim() == 2 else v for k, v in w.items()}


def _err(got, want, tol) -> float:
    """Worst |got - want|, after checking it is within tol·|want| +
    tol·max|want|."""
    got, want = got.float(), want.float()
    torch.testing.assert_close(got, want, rtol=tol,
                               atol=tol * float(want.abs().max()))
    return float((got - want).abs().max())


@torch.no_grad()
def vit_kernels_vs_plain(smi: str) -> dict:
    """B5', B3 and B4 against their plain versions, bf16, then timed."""
    from acmil_tpu_torch.ops import vit_attn_packed as pk
    from acmil_tpu_torch.ops import vit_layer as vl

    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    worst = {"B3": 0.0, "B4": 0.0, "B5": 0.0}
    for name, (n, d, heads) in (("ViT-S/16", VIT_S16), ("ViT-S/8", VIT_S8),
                                ("CLIP-L/336", CLIP_L), ("GigaPath", GIGA)):
        for b in (1, 64):
            qkv = (2 * torch.randn(b, n, 3 * d, generator=gen,
                                   device="cuda")).bfloat16()
            got = pk.fused_mha_packed(qkv, heads)
            torch.cuda.synchronize()
            err = _err(got, pk._reference_packed(qkv, heads), B5_TOL)
            worst["B5"] = max(worst["B5"], err)
            print(f"kernel B5' vs plain: {name} N={n} D={d} H={heads} B={b} "
                  f"bf16: max_abs_err {err:.3e}")
    # B3 also at ViT-S/8's 785 tokens, outside the TPU's fits_vmem: on the
    # card the wrapper launches there too; B4 also at UNI's path shape
    cases = [("B3", vl.fused_vit_layer, vl._reference_layer, name, shape, b,
              False) for name, shape, b in (("ViT-S/16", VIT_S16, 1),
                                            ("ViT-S/16", VIT_S16, 7),
                                            ("ViT-S/16", VIT_S16, 256),
                                            ("ViT-S/8", VIT_S8, 2))]
    cases += [("B4", vl.fused_vit_attn_half, vl._reference_attn_half, name,
               shape, b, ls) for name, shape, b, ls in
              (("ViT-B/16", VIT_B16, 4, False), ("UNI ViT-L/16", UNI, 4, True),
               ("UNI ViT-L/16", UNI, BIG_BATCH, True),
               ("ViT-S/8", VIT_S8, 4, False))]
    for kern, fused, plain, name, (n, d, heads), b, ls in cases:
        w = _vit_weights(gen, d, 4 * d, ls)
        x = torch.randn(b, n, d, generator=gen, device="cuda").bfloat16()
        got = fused(x, w, heads)
        torch.cuda.synchronize()
        err = _err(got, plain(x, w, heads), CHAIN_TOL)
        worst[kern] = max(worst[kern], err)
        print(f"kernel {kern} chain vs plain: {name} N={n} D={d} H={heads} "
              f"B={b}{' ls1' if ls else ''} bf16: max_abs_err {err:.3e}")

    out = {}
    # the chains' kernels: the GEMM, its LayerNorm prologue and B5'
    chain = ("gemm_kernel", "ln_rows_kernel", "mha_kernel")
    for kern, (n, d, heads), b, mlp, ls, fused, plain in (
            ("B3", VIT_S16, STEP2_BATCH, True, False, vl.fused_vit_layer,
             vl._reference_layer),
            ("B4", UNI, BIG_BATCH, False, True, vl.fused_vit_attn_half,
             vl._reference_attn_half)):
        w = _cast_matrices(_vit_weights(gen, d, 4 * d, ls))
        x = torch.randn(b, n, d, generator=gen, device="cuda").bfloat16()
        shapes = _gemm_shapes(b * n, d, 4 * d, mlp)
        gemm_ms = _device_ms(lambda: fused(x, w, heads), ("gemm_kernel",),
                             10)[0]
        flops = sum(2 * m * k * nn for m, k, nn in shapes)
        out[kern] = {
            "ms": _time_ms(lambda: fused(x, w, heads), 20),
            "device": _device_ms(lambda: fused(x, w, heads), chain, 10),
            "attention_step": _device_ms(lambda: fused(x, w, heads),
                                         ("mha_kernel",), 10),
            "gemm_device_ms": gemm_ms,
            # None where the tracer lost the window's GEMM events
            "gemm_tflops": (None if gemm_ms is None
                            else flops / (gemm_ms * 1e-3) / 1e12),
            "ln_device_ms": _device_ms(lambda: fused(x, w, heads),
                                       ("ln_rows_kernel",), 10)[0],
            "plain_ms": _time_ms(lambda: plain(x, w, heads), 10),
            "library_ms": _library_gemms(gen, shapes, kern, smi),
            **_bound(b * _layer_flops(n, d, 4 * d, mlp),
                     _layer_bytes(b, n, d, 4 * d, mlp, ls))}
        r = out[kern]
        rate = ("rate not measured" if gemm_ms is None else
                f"{r['gemm_tflops']:.1f} TFLOP/s "
                f"({100 * r['gemm_tflops'] * 1e12 / PEAK_FLOPS:.1f}% of the "
                f"bf16 peak)")
        print(f"kernel {kern}'s GEMMs: {len(shapes)} launches, "
              f"{_fmt_ms(gemm_ms)} of device time for {flops / 1e9:.1f} "
              f"GFLOP, {rate}, against bf16 torch.matmul at the same shapes "
              f"{r['library_ms']:.4f} ms; LayerNorm prologues "
              f"{_fmt_ms(r['ln_device_ms'])} [{smi}]")
    # B5' at Step2's shape (the attention step of B3 there) and at CLIP-L's,
    # beside scaled_dot_product_attention on q, k, v viewed in the same qkv
    for kern, (n, d, heads), b in (("B5", VIT_S16, STEP2_BATCH),
                                   ("B5 CLIP-L", CLIP_L, BIG_BATCH)):
        qkv = torch.randn(b, n, 3 * d, generator=gen, device="cuda").bfloat16()
        q, k, v = qkv.view(b, n, 3, heads, d // heads).permute(2, 0, 3, 1, 4)
        out[kern] = {
            "ms": _time_ms(lambda: pk.fused_mha_packed(qkv, heads), 20),
            "device": _device_ms(lambda: pk.fused_mha_packed(qkv, heads),
                                 ("mha_kernel",)),
            "plain_ms": _time_ms(lambda: pk._reference_packed(qkv, heads), 10),
            "library_ms": _time_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    q, k, v), 20),
            **_bound(b * 4 * n * n * d, b * 2 * (n * 3 * d + n * d))}
    for kern, shape in (("B3", f"ViT-S/16 B={STEP2_BATCH} N=197"),
                        ("B4", f"UNI B={BIG_BATCH} N=197 ls1"),
                        ("B5", f"ViT-S/16 B={STEP2_BATCH} N=197"),
                        ("B5 CLIP-L", f"CLIP-L/336 B={BIG_BATCH} N=577")):
        r = out[kern]
        r["device_ms"], per_call = r.pop("device")
        lib = (f", scaled_dot_product_attention {r['library_ms']:.4f} ms"
               if kern.startswith("B5") else
               f", bf16 torch.matmul at its GEMM shapes {r['library_ms']:.4f} "
               f"ms")
        step = ""
        if "attention_step" in r:
            r["attention_step_device_ms"], _ = r.pop("attention_step")
            step = (f"; its B5' attention step "
                    f"{_fmt_ms(r['attention_step_device_ms'])} of device time")
        print(f"kernel {kern} time: {shape} bf16: kernel {r['ms']:.4f} ms "
              f"(device {_fmt_ms(r['device_ms'])} in {per_call:g} launches), "
              f"plain {r['plain_ms']:.4f} ms{lib}, bound {r['bound_ms']:.4f} "
              f"ms ({r['bound_by']}), {_bound_share(r)}{step} [{smi}]")
        r["max_abs_err"] = worst[kern.split()[0]]
    return out


_STEP2_INPUTS: list = []


def _step2_inputs():
    """:func:`_write_step2_inputs` once a process, into a directory removed
    when the process ends: phases 9 and 24 read the same slides, and
    writing them takes 13-25 s on the card's host."""
    if not _STEP2_INPUTS:
        tmp = tempfile.TemporaryDirectory()
        _STEP2_INPUTS.extend([tmp, *_write_step2_inputs(tmp.name)])
    return tuple(_STEP2_INPUTS[1:])


def _write_step2_inputs(tmp: str):
    """Three synthetic PNG slides with every 224-px grid patch as Step1
    coords, in the torch coords file (the card's machine has no h5py)."""
    import cv2

    from acmil_tpu_torch.wsi.synthetic import make_synthetic_slide_image
    from acmil_tpu_torch.wsi.tiling import save_coords_pt

    slide_dir, coords_dir = (os.path.join(tmp, d) for d in ("slides", "coords"))
    os.makedirs(slide_dir)
    labels = os.path.join(tmp, "labels.csv")
    with open(labels, "w") as f:
        f.write("slide_id,label\n")
        for i, (w, h) in enumerate(STEP2_SLIDES):
            name = f"slide_{i}"
            img, _ = make_synthetic_slide_image(w, h, seed=SEED + i,
                                                tumor=bool(i % 2))
            cv2.imwrite(os.path.join(slide_dir, f"{name}.png"),
                        cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
            xs, ys = np.meshgrid(np.arange(0, w - PATCH_PX + 1, PATCH_PX),
                                 np.arange(0, h - PATCH_PX + 1, PATCH_PX),
                                 indexing="ij")
            save_coords_pt(os.path.join(coords_dir, f"{name}.pt"),
                           np.stack([xs.ravel(), ys.ravel()], 1),
                           {"patch_size": PATCH_PX, "patch_level": 0,
                            "downsample": 1.0})
            f.write(f"{name},{i % 2}\n")
    return slide_dir, coords_dir, labels


def _row_cosine(a, b):
    a, b = a.float(), b.float()
    return (a * b).sum(-1) / (a.norm(dim=-1) * b.norm(dim=-1)).clamp_min(1e-12)


def step2_run(smi: str) -> dict:
    """Slice 3's main path: Step2 extraction through the port's CLI, then
    scoring of the features it wrote."""
    import warnings

    from acmil_tpu_torch.cli import predict, step2_extract
    from acmil_tpu_torch.config import Config
    from acmil_tpu_torch.data.patch_dataset import SlidePatchBatches
    from acmil_tpu_torch.engine import checkpoint
    from acmil_tpu_torch.models import build_mil_model
    from acmil_tpu_torch.models.common import torch_linear_init_
    from acmil_tpu_torch.models.encoders.build import (build_encoder,
                                                       encoder_feature_fn,
                                                       preprocess)
    from acmil_tpu_torch.models.encoders.fast import (cast_kernel_weights,
                                                      vit_encode)
    from acmil_tpu_torch.ops import attn_pool, vit_attn_packed, vit_layer
    from acmil_tpu_torch.wsi.slide import open_slide
    from acmil_tpu_torch.wsi.tiling import load_coords_pt

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        slide_dir, coords_dir, labels = _step2_inputs()
        print(f"step2 inputs: {len(STEP2_SLIDES)} synthetic PNG slides "
              f"written in {time.perf_counter() - t0:.2f} s")
        out_dir = os.path.join(tmp, "feats")
        argv = ["--slide_dir", slide_dir, "--coords_dir", coords_dir,
                "--output_dir", out_dir, "--pretrain", "medical_ssl",
                "--backbone", "ViT-S/16", "--batch_size", str(STEP2_BATCH),
                "--label_csv", labels, "--coords_format", "pt",
                "--out_format", "pt", "--device", "cuda"]
        counters = (vit_layer.fused_vit_layer, vit_layer.fused_vit_attn_half,
                    vit_attn_packed.fused_mha_packed,
                    vit_attn_packed._launch_packed)
        for c in counters:
            c.launches = 0
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")        # no pretrain_weights: seeded
            t0 = time.perf_counter()
            res = step2_extract.main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        b3, b4, b5, b5_steps = (c.launches for c in counters)
        batches = sum(-(-n // STEP2_BATCH) for n in res["slides"].values())
        if b3 != STEP2_DEPTH * batches or b4 or b5 or b5_steps != b3:
            raise AssertionError(
                f"B3/B4/B5 (public entry)/B5' launched {b3}/{b4}/{b5}/"
                f"{b5_steps} times: want B3 {STEP2_DEPTH} x {batches} batches, "
                f"each launching B5' once as its attention step")
        feats = torch.load(res["out_path"], weights_only=True)
        if res["patches"] < 1100 or len(feats) != len(STEP2_SLIDES):
            raise AssertionError(f"Step2 wrote {res['slides']}")

        # the same encoder (Step2 seeds its random init with 0) on the plain
        # route, over the same patch batches
        conf = Config.from_dict({"pretrain": "medical_ssl",
                                 "backbone": "ViT-S/16"})
        with warnings.catch_warnings(), torch.random.fork_rng(devices=[]):
            warnings.simplefilter("ignore")
            torch.manual_seed(0)
            model, spec, _ = build_encoder(conf)
        dev = torch.device("cuda")
        embed = encoder_feature_fn(model, spec, dev)
        plain = encoder_feature_fn(model, spec, dev, fused=False)
        worst_cos, worst_abs = 1.0, 0.0
        first_batch = None
        for name, item in sorted(feats.items()):
            coords, _, attrs = load_coords_pt(os.path.join(coords_dir,
                                                           f"{name}.pt"))
            f = item["feat"]
            if f.dtype != torch.float16 or tuple(f.shape) != (len(coords), 384) \
                    or not bool(torch.isfinite(f).all()):
                raise AssertionError(f"{name}: features {f.dtype} "
                                     f"{tuple(f.shape)}")
            slide = open_slide(os.path.join(slide_dir, f"{name}.png"))
            src = SlidePatchBatches(slide, coords, PATCH_PX, 0,
                                    target_size=spec.img_size,
                                    batch_size=STEP2_BATCH)
            ref = []
            for imgs, _, n in src:
                first_batch = imgs if first_batch is None else first_batch
                ref.append(plain(imgs)[:n])
            ref = torch.cat(ref)
            got = f.to(dev)
            worst_cos = min(worst_cos, float(_row_cosine(got, ref).min()))
            worst_abs = max(worst_abs, float((got.float() - ref.float())
                                             .abs().max()))
        if not worst_cos >= COS_MIN:
            raise AssertionError(f"fused vs plain features: cosine {worst_cos}")

        # encoder device time per batch of 256, pixels already on the card,
        # parameters as encoder_feature_fn holds them
        enc = model.encoder
        params = cast_kernel_weights(
            {k: v.to(dev) for k, v in enc.state_dict().items()},
            n_tok=(enc.img_size // enc.patch) ** 2 + 1, heads=enc.heads,
            dtype=enc.dtype)
        x = preprocess(torch.from_numpy(first_batch).to(dev), spec)
        kw = dict(patch=enc.patch, depth=enc.depth, heads=enc.heads,
                  dtype=enc.dtype)
        enc_ms = _time_ms(lambda: vit_encode(params, x, **kw), 5)
        plain_ms = _time_ms(lambda: vit_encode(params, x, **kw, fused=False),
                            3)
        embed_ms = _wall_ms(lambda: embed(first_batch), 5)
        # the host side of one batch: opening a slide (decode and pyramid),
        # then reading 256 patches, as SlidePatchBatches' thread does
        name0 = sorted(feats)[0]
        coords0, _, _ = load_coords_pt(os.path.join(coords_dir, f"{name0}.pt"))
        t0 = time.perf_counter()
        slide0 = open_slide(os.path.join(slide_dir, f"{name0}.png"),
                            cache=False)        # a decode, not a cache hit
        open_ms = (time.perf_counter() - t0) * 1e3
        src0 = SlidePatchBatches(slide0, coords0, PATCH_PX, 0,
                                 target_size=spec.img_size,
                                 batch_size=STEP2_BATCH)
        read_ms = statistics.median(
            _host_ms(lambda: src0._make(np.arange(STEP2_BATCH)))
            for _ in range(3))

        # pixels to probabilities: an ACMIL_GA head scores the feature file
        yml_conf = Config.from_yaml(YML, {"arch": "ga", "n_token": N_TOKEN})
        head, _ = build_mil_model(yml_conf)
        torch_linear_init_(head, torch.Generator().manual_seed(SEED))
        ckpt = os.path.join(tmp, "checkpoint-best.pth")
        checkpoint.save(ckpt, head, epoch=0, conf=yml_conf)
        attn_pool.fused_gated_attn_pool_batched.launches = 0
        scored = predict.main(["--config", YML, "--ckpt", ckpt, "--features",
                               res["out_path"], "--out_csv",
                               os.path.join(tmp, "preds.csv"),
                               "--device", "cuda"])
        b1 = attn_pool.fused_gated_attn_pool_batched.launches
        if b1 != len(feats):
            raise AssertionError(f"B1 launched {b1} times for {len(feats)} "
                                 f"slides")
        _check_predictions(scored, len(feats), yml_conf.n_class)
    print(f"step2: cli/step2_extract.py, ViT-S/16 medical_ssl full width, "
          f"depth {STEP2_DEPTH}, batch {STEP2_BATCH}: {res['patches']} patches "
          f"of {len(feats)} slides in {batches} batches; B3 launches {b3} "
          f"(= {STEP2_DEPTH} x {batches}), B5' launches {b5_steps} (one "
          f"attention step each); fp16 [N, 384] finite; fused vs "
          f"plain route worst cosine {worst_cos:.6f}, max_abs_err "
          f"{worst_abs:.3e}")
    print(f"step2 throughput: {res['patches'] / res['seconds']:.1f} patches/s "
          f"(wall of extraction, slide decode and patch reads included; "
          f"{wall:.2f} s for the whole main()); encoder device time per "
          f"batch of {STEP2_BATCH}: fused {enc_ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms; feature closure wall per batch from host "
          f"pixels {embed_ms:.4f} ms [{smi}]")
    print(f"step2 host side: opening a {STEP2_SLIDES[0][0]}x"
          f"{STEP2_SLIDES[0][1]} PNG slide (decode and pyramid) "
          f"{open_ms:.1f} ms; reading {STEP2_BATCH} patches of {PATCH_PX} px "
          f"{read_ms:.2f} ms (median of 3), against {enc_ms:.2f} ms of "
          f"encoder device time per batch")
    print(f"step2 -> cli/predict.py: {len(feats)} slides scored, B1 launches "
          f"{b1}, probabilities finite and rows sum to 1")
    return {"B3": b3, "B5": b5_steps, "B1": b1, "cosine": worst_cos}


@torch.no_grad()
def big_trunk_run(smi: str) -> dict:
    """vit_encode's attention-half route (UNI, B4) and packed route
    (CLIP-L/336, B5' between qkv and proj on the bf16-A GEMM) at full
    width, depth 2, against the plain route."""
    from acmil_tpu_torch.models.encoders.build import (CLIP_MEAN, CLIP_STD,
                                                       IMAGENET_MEAN,
                                                       IMAGENET_STD,
                                                       EncoderSpec,
                                                       preprocess)
    from acmil_tpu_torch.models.encoders.fast import (cast_kernel_weights,
                                                      vit_encode)
    from acmil_tpu_torch.models.encoders.vit import ViT
    from acmil_tpu_torch.ops import vit_attn_packed, vit_layer

    # (name, kernel, its counter, bf16-A GEMMs a block, module kw, mean,
    # std): UNI's two are its gelu MLP half's fc1 and fc2; CLIP-L/336's
    # are route 3's qkv and proj, which launch B5' themselves (its
    # quick_gelu MLP half stays plain)
    trunks = (("UNI ViT-L/16", "B4", vit_layer.fused_vit_attn_half, 2,
               dict(patch=16, dim=1024, heads=16, layerscale=True),
               IMAGENET_MEAN, IMAGENET_STD),
              ("CLIP-L/336", "B5", vit_attn_packed._launch_packed, 2,
               dict(patch=14, dim=1024, heads=16, img_size=336, proj_dim=768,
                    pre_norm=True, act="quick_gelu"), CLIP_MEAN, CLIP_STD))
    launches, b5_launches, bf16a = {}, {}, {}
    for name, kern, counter, per_block, kw, mean, std in trunks:
        torch.manual_seed(SEED)
        m = ViT(depth=BIG_DEPTH, **kw)
        gen = torch.Generator().manual_seed(SEED)
        for blk in m.blocks:
            for ls in (blk.ls1, blk.ls2):
                if hasattr(ls, "gamma"):
                    ls.gamma.data = 0.25 + 0.5 * torch.rand(ls.gamma.shape,
                                                            generator=gen)
        params = cast_kernel_weights(
            {k: v.cuda() for k, v in m.state_dict().items()},
            n_tok=(m.img_size // m.patch) ** 2 + 1, heads=m.heads,
            dtype=torch.bfloat16, act=m.act)
        spec = EncoderSpec(None, m.embed_dim, m.img_size, mean, std, "vit")
        u8 = torch.randint(0, 256, (BIG_BATCH, m.img_size, m.img_size, 3),
                           generator=gen, dtype=torch.uint8).cuda()
        x = preprocess(u8, spec)
        enc_kw = dict(patch=m.patch, depth=BIG_DEPTH, heads=m.heads,
                      act=m.act, pre_norm=m.pre_norm, proj_dim=m.proj_dim)
        counter.launches = vit_attn_packed._launch_packed.launches = 0
        vit_layer._gemm.launches["bf16a"] = 0
        got = vit_encode(params, x, **enc_kw)
        torch.cuda.synchronize()
        launches[kern] = counter.launches
        b5_launches[name] = vit_attn_packed._launch_packed.launches
        bf16a[name] = vit_layer._gemm.launches["bf16a"]
        if launches[kern] != BIG_DEPTH:
            raise AssertionError(f"{name}: {kern} launched {launches[kern]} "
                                 f"times for {BIG_DEPTH} layers")
        want_bf16a = per_block * BIG_DEPTH
        if bf16a[name] != want_bf16a:
            raise AssertionError(f"{name}: the bf16-A GEMM launched "
                                 f"{bf16a[name]} times, not {want_bf16a}")
        want = vit_encode(params, x, **enc_kw, fused=False)
        cos = float(_row_cosine(got, want).min())
        if tuple(got.shape) != (BIG_BATCH, m.embed_dim) or cos < COS_MIN \
                or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{name}: {tuple(got.shape)}, cosine {cos}")
        t_f = _time_ms(lambda: vit_encode(params, x, **enc_kw), 5)
        t_p = _time_ms(lambda: vit_encode(params, x, **enc_kw, fused=False), 3)
        print(f"vit_encode {name}: full width, depth {BIG_DEPTH}, B={BIG_BATCH} "
              f"bf16: {kern} launches {launches[kern]}, B5' launches "
              f"{b5_launches[name]}, bf16-A GEMM launches {bf16a[name]}; "
              f"fused vs plain route "
              f"worst cosine {cos:.6f}; device time fused {t_f:.4f} ms, plain "
              f"{t_p:.4f} ms [{smi}]")
    return {**launches, "B5'": b5_launches, "gemm_bf16a": bf16a}


# UNI's MLP half (D 1024, hidden 4096) as the benchmark's Step2 batch makes
# it: M = 256 images x 197 tokens; GigaPath's fc1 (D 1536, SwiGLU-packed to
# 8192) at the same M
UNI_MLP = (STEP2_BATCH * 197, 1024, 4096)
GIGAPATH_FC1 = (1536, 8192)
# the f32 bar of tests/test_torch_gpu_gemm.py: against a float64 product,
# the error at most twice that of f32 torch.matmul plus a few f32 steps of
# the largest output; a bf16 output may differ from its plain version by
# one bf16 step of itself and of the largest output
F32_FLOOR, BF16_TOL = 2.0 ** -21, 2.0 ** -7


@torch.no_grad()
def gemm_bf16a_run(smi: str) -> dict:
    """The f32 GEMM's bf16-A mode (``csrc/vit_gemm_f32.cu``, bf16 A, f32
    W, two TF32 products a product) at UNI's fc1 (LayerNorm prologue,
    gelu) and fc2 (layerscale residual) and GigaPath's fc1 (LayerNorm
    prologue, SwiGLU at half width): checked three ways, then timed beside
    f32 ``torch.matmul`` (TF32 off)."""
    from acmil_tpu_torch.ops import vit_layer as vl

    m, d, hid = UNI_MLP
    gd, ghid = GIGAPATH_FC1
    gen = torch.Generator(device="cuda").manual_seed(SEED + 27)
    r = lambda *shape: torch.randn(*shape, generator=gen, device="cuda")
    x = (1.5 * r(m, d) + 0.3).bfloat16()
    h = (r(m, hid) * 0.5).bfloat16()
    ls = 0.25 + 0.5 * r(d).abs()
    # (label, a, w, bias, epilogue, ln, ls, residual)
    calls = (("fc1", x, r(hid, d) / d ** 0.5, 0.1 * r(hid), vl.EPI_BIAS_GELU,
              (1 + 0.1 * r(d), 0.1 * r(d)), None, None),
             ("fc2", h, r(d, hid) / hid ** 0.5, 0.1 * r(d),
              vl.EPI_BIAS_LS_RES, None, ls, x),
             ("swiglu_fc1", (1.5 * r(m, gd) + 0.3).bfloat16(),
              r(ghid, gd) / gd ** 0.5, 0.1 * r(ghid), vl.EPI_BIAS_SWIGLU,
              (1 + 0.1 * r(gd), 0.1 * r(gd)), None, None))
    out = {}
    for label, a, w, bias, epi, ln, gamma, res in calls:
        n, k = w.shape
        n_out = n // 2 if epi == vl.EPI_BIAS_SWIGLU else n
        kw = dict(ln=ln, ls=gamma, res=res)
        launched = vl._gemm.launches["bf16a"]
        # f32 out against float64 on the bf16 rows as they are (no
        # prologue: its rows, rounded to bf16, may flip a rounding against
        # any other LayerNorm's, which the bf16 check below allows)
        before = vl._gemm.launches["bf16a"]
        got = vl._gemm(a, w, bias, epi, out_dtype=torch.float32, ls=gamma,
                       res=res)
        torch.cuda.synchronize()
        if vl._gemm.launches["bf16a"] != before + 1:
            raise AssertionError(f"bf16-A GEMM {label}: not launched")
        lib = _gemm_plain(a, w, bias, epi, torch.float32, ls=gamma, res=res)
        exact = _gemm_plain(a.double(), w.double(), bias, epi, torch.float64,
                            ls=gamma, res=res)
        err = float((got.double() - exact).abs().max())
        lib_err = float((lib.double() - exact).abs().max())
        del got, lib
        if not err <= 2 * lib_err + F32_FLOOR * float(exact.abs().max()):
            raise AssertionError(f"bf16-A GEMM {label}: error {err:.3e} "
                                 f"against float64, f32 matmul's {lib_err:.3e}")
        del exact
        # the call as the MLP half makes it, prologue included: bf16 out
        got = vl._gemm(a, w, bias, epi, out_dtype=torch.bfloat16, **kw)
        worst = _err(got, _gemm_plain(a, w, bias, epi, torch.bfloat16, **kw),
                     BF16_TOL)
        del got
        # A's lo is 0: two products give the three's bits on a.float()
        a32 = a.float()
        two = vl._gemm(a, w, bias, vl.EPI_BIAS, out_dtype=torch.float32)
        three = vl._gemm(a32, w, bias, vl.EPI_BIAS, out_dtype=torch.float32)
        if not torch.equal(two.view(torch.int32), three.view(torch.int32)):
            raise AssertionError(f"bf16-A GEMM {label}: not the f32 mode's "
                                 f"bits on a.float()")
        del two, three
        launched = vl._gemm.launches["bf16a"] - launched
        flops = 2 * m * n * k
        nbytes = (2 * m * k + 4 * n * k + 4 * n + 2 * m * n_out
                  + (0 if res is None else 2 * m * n))
        ms = _time_ms(lambda: vl._gemm(a, w, bias, epi,
                                       out_dtype=torch.bfloat16, **kw), 10)
        plain_ms = _time_ms(lambda: _gemm_plain(a, w, bias, epi,
                                                torch.bfloat16, **kw), 5)
        lib_ms = _time_ms(lambda: torch.matmul(a32, w.t()), 10)
        del a32
        expect = {"gemm_f32_kernel": 1, "split_w_kernel": 1,
                  **({"ln_rows_kernel": 1} if ln is not None else {})}
        split = _kernel_ms(lambda: vl._gemm(a, w, bias, epi,
                                            out_dtype=torch.bfloat16, **kw),
                           expect, 5) or {}
        gemm_dev = split.get("gemm_f32_kernel")
        rec = {"launches": launched, "ms": ms,
               "device_ms": sum(split.values()) if split else None,
               "gemm_device_ms": gemm_dev,
               "split_device_ms": split.get("split_w_kernel"),
               "ln_device_ms": split.get("ln_rows_kernel"),
               "plain_ms": plain_ms, "library_ms": lib_ms,
               **_bound(flops, nbytes, PEAK_TF32_FLOPS / 2),
               "fma_bound_ms": flops / PEAK_F32_FLOPS * 1e3,
               "max_abs_err": worst, "f32_err_vs_float64": err,
               "matmul_err_vs_float64": lib_err, "gflop": flops / 1e9}
        rate = ("" if gemm_dev is None else
                f", {flops / (gemm_dev * 1e-3) / 1e12:.1f} TFLOP/s of products")
        print(f"GEMM bf16a {label} (bf16 A, f32 W, 2 TF32 products) M={m} "
              f"N={n} K={k}, {launched} launches: kernel {ms:.4f} ms (device: product "
              f"{_fmt_ms(gemm_dev)}{rate}, split of W "
              f"{_fmt_ms(rec['split_device_ms'])}, LayerNorm prologue "
              f"{_fmt_ms(rec['ln_device_ms'])}), plain {plain_ms:.4f} ms, f32 "
              f"torch.matmul {lib_ms:.4f} ms, bound {rec['bound_ms']:.4f} ms "
              f"({rec['bound_by']}, 2 TF32 products each; at the f32 FMA rate "
              f"{rec['fma_bound_ms']:.4f} ms); against float64 {err:.3e} "
              f"(f32 matmul {lib_err:.3e}), bf16 out against plain "
              f"{worst:.3e}, bit for bit the f32 mode's on a.float() [{smi}]")
        out[label] = rec
    return out


def _dsmil_model(conf):
    """The registered DSMIL head with every Linear and the fcc Conv1d drawn
    from torch's default U(±1/sqrt(fan_in)) by a seeded generator."""
    from torch import nn

    from acmil_tpu_torch.models import build_mil_model

    model, family = build_mil_model(conf)
    gen = torch.Generator().manual_seed(SEED)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Linear, nn.Conv1d)):
                bound = m.weight[0].numel() ** -0.5
                m.weight.uniform_(-bound, bound, generator=gen)
                m.bias.uniform_(-bound, bound, generator=gen)
    return model, family


def _b6_bound(n: int, d: int, q: int, c: int, feat_bytes: int) -> dict:
    """B6 on one bag of n rows, counting the work the function needs: the
    fold u_c = Wq q_max_c / sqrt(Q), beta_c (2 C Q (D + 1)), then the
    logits x·u_c + beta_c and the pooling p x (4 N C D). The TPU kernel's
    q = x·Wq is not counted: the fold gives the same logits without it.
    Reads x, the mask, Wq, bq and q_max once, writes the logits and the
    bag."""
    flops = 2 * c * q * (d + 1) + 4 * n * c * d
    nbytes = (n * d * feat_bytes + n + 4 * (d * q + q + c * q)
              + 4 * (c * n + c * d))
    return _bound(flops, nbytes)


def _b6_ptxas() -> dict:
    """{kernel: [registers, spill store bytes]} of each kernel ptxas built
    for ``csrc/dsmil_pool.cu`` in this run, its template arguments kept
    short (``b6_rows_kernel<h,2,2>``: fp16 features, 2 classes, 2 column
    units a lane)."""
    from acmil_tpu_torch.ops import _build

    out, kern = {}, None
    for line in _build.build_info.get("dsmil_pool", {}).get("log", "").splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"(b6_[a-z]+_kernel)(?:I(6__half|f)((?:Li\d+E)+))?",
                          line)
            kern = m and m.group(1)
            if m and m.group(2):
                args = ["h" if m.group(2) == "6__half" else "f"]
                args += re.findall(r"Li(\d+)E", m.group(3))
                kern += f"<{','.join(args)}>"
        elif kern and "spill stores" in line:
            out[kern] = [None, int(re.search(r"(\d+) bytes spill stores",
                                             line).group(1))]
        elif kern in out and "registers" in line:
            out[kern][0] = int(re.search(r"Used (\d+) registers", line).group(1))
    return out


def _b6_inputs(gen, b, n, d, q, c, dtype):
    """Features, a 90% mask (bag 1 of 3 all masked), Wq and bq at torch's
    Linear scale, and q_max from one random row per class, as the critical
    instances give it."""
    x = torch.randn(b, n, d, generator=gen, device="cuda").to(dtype)
    m = torch.rand(b, n, generator=gen, device="cuda") < 0.9
    if b == 3:
        m[1] = False
    bound = d ** -0.5
    wq = (torch.rand(d, q, generator=gen, device="cuda") * 2 - 1) * bound
    bq = (torch.rand(q, generator=gen, device="cuda") * 2 - 1) * bound
    idx = torch.randint(0, n, (b, c), generator=gen, device="cuda")
    rows = torch.arange(b, device="cuda")[:, None]
    q_max = x.float()[rows, idx] @ wq + bq
    return x, m, wq, bq, q_max


@torch.no_grad()
def dsmil_kernel_vs_plain(smi: str) -> dict:
    """B6 against its plain version, then timed; the DSMIL eval crossover."""
    from acmil_tpu_torch.config import Config
    from acmil_tpu_torch.data.bags import pad_bag
    from acmil_tpu_torch.engine import get_family
    from acmil_tpu_torch.models import fast
    from acmil_tpu_torch.ops import dsmil_pool as dp

    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    worst, checks = 0.0, 0
    cases = [(d, q, c, n, b, dtype) for d, q in DSMIL_WIDTHS for c in (2, 4)
             for n in (300, 16384, 65536) for b in (1, 3)
             for dtype in (torch.float16, torch.float32)]
    # 9 to 128 classes: the split-TF32 route
    cases += [(d, q, c, n, b, dtype) for d, q in DSMIL_WIDTHS for c in (9, 128)
              for n, b in ((300, 3), (65536, 1))
              for dtype in (torch.float16, torch.float32)]
    for d, q, c, n, b, dtype in cases:
        x, m, wq, bq, q_max = _b6_inputs(gen, b, n, d, q, c, dtype)
        bag, lg = dp.fused_dsmil_pool(x, m, wq, bq, q_max)
        torch.cuda.synchronize()
        checks += 1
        if c in (2, 128):
            bag2, lg2 = dp.fused_dsmil_pool(x, m, wq, bq, q_max)
            if not (torch.equal(bag, bag2) and torch.equal(lg, lg2)):
                raise AssertionError(f"B6 at C={c}: two launches differ")
        rbag, rlg = dp.dsmil_pool_reference(x.float(), m, wq, bq, q_max)
        valid = m[:, None, :].expand_as(lg)
        torch.testing.assert_close(bag, rbag, atol=DSMIL_ATOL, rtol=DSMIL_RTOL)
        torch.testing.assert_close(lg[valid], rlg[valid], atol=DSMIL_ATOL,
                                   rtol=DSMIL_RTOL)
        if not bool((lg[~valid] == dp.NEG).all()):
            raise AssertionError("B6 pad logits are not NEG")
        if bool(bag.isnan().any()) or (b == 3 and bool(bag[1].any())):
            raise AssertionError("B6 all-masked bag is not 0")
        err = max(float((bag - rbag).abs().max()),
                  float((lg[valid] - rlg[valid]).abs().max()))
        worst = max(worst, err)
        print(f"kernel B6 vs plain: D={d} Q={q} C={c} N={n} B={b} "
              f"{str(dtype)[6:]}: max_abs_err {err:.3e} (bag, logits)")

    d, q, c = D_FEAT, D_INNER, 2
    times = {}
    for n in (16384, 32768, 65536):
        x, m, wq, bq, q_max = _b6_inputs(gen, 1, n, d, q, c, torch.float16)
        m[:] = True
        t_k = _time_ms(lambda: dp.fused_dsmil_pool(x, m, wq, bq, q_max))
        t_p = _time_ms(lambda: dp.dsmil_pool_reference(x.float(), m, wq, bq,
                                                       q_max))
        dev, per_call = _device_ms(
            lambda: dp.fused_dsmil_pool(x, m, wq, bq, q_max), dp.B6_KERNELS)
        times[n] = (t_k, t_p, dev)
        r = {"ms": t_k, "device_ms": dev, **_b6_bound(n, d, q, c, 2)}
        print(f"kernel B6 time: N={n} B=1 D={d} Q={q} C={c} fp16: call "
              f"{t_k:.4f} ms, device {_fmt_ms(dev)} in {per_call:g} launches, "
              f"plain {t_p:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}), {_bound_share(r)} [{smi}]")
    call = lambda: dp.fused_dsmil_pool(x, m, wq, bq, q_max)  # noqa: E731
    by_kernel = {"C=2": _split_ms(dp.B6_KERNELS, call)}
    # at the kernel's most classes (the split-TF32 route), and at UNI's
    # widths
    more = {}
    for label, dd, qq, cc in (("c128", d, q, 128), ("uni", 1024, 512, 2)):
        x, m, wq, bq, q_max = _b6_inputs(gen, 1, 65536, dd, qq, cc,
                                         torch.float16)
        m[:] = True
        call = lambda: dp.fused_dsmil_pool(x, m, wq, bq, q_max)  # noqa: E731
        r = {"ms": _time_ms(call, 10), "device_ms": _device_ms(
                 call, dp.B6_KERNELS)[0],
             "plain_ms": _time_ms(lambda: dp.dsmil_pool_reference(
                 x.float(), m, wq, bq, q_max), 10),
             **_b6_bound(65536, dd, qq, cc, 2)}
        by_kernel[f"C={cc}, D={dd}"] = _split_ms(dp.B6_KERNELS, call)
        more[label] = r
        print(f"kernel B6 time: N=65536 B=1 D={dd} Q={qq} C={cc} fp16: call "
              f"{r['ms']:.4f} ms, device {_fmt_ms(r['device_ms'])}, plain "
              f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}), {_bound_share(r)} [{smi}]")
    for label, per in by_kernel.items():
        print(f"kernel B6 device time by kernel, ms: {label}: "
              f"{_fmt_split(per)} [{smi}]")
    ptxas = _b6_ptxas()
    print("kernel B6 ptxas (registers, spill store bytes): " + ", ".join(
        f"{k} {v[0]}/{v[1]}" for k, v in ptxas.items()))

    # the whole eval forward, fused (B6) against plain, per padded length
    conf = Config.from_yaml(YML, {"arch": "dsmil"})
    model, family = _dsmil_model(conf)
    model.cuda().eval()
    fam = get_family(family)
    rs = np.random.default_rng(SEED + 4)
    route_ms = {}
    for n_pad in [2 ** e for e in range(10, 17)]:
        feat = rs.standard_normal((n_pad - n_pad // 8, D_FEAT),
                                  dtype=np.float32)
        bag = pad_bag(feat, None, 0, n_pad=n_pad, dtype=np.float16).to("cuda")
        route_ms[n_pad] = (
            _time_ms(lambda: fast.dsmil_eval_fused(model, bag.feats, bag.mask),
                     20),
            _time_ms(lambda: fam.eval_outputs(model, bag, fused=False), 20))
    wins = [n for n, (f, p) in route_ms.items() if f < p]
    cross = next((n for n in sorted(route_ms)
                  if all(m in wins for m in route_ms if m >= n)), None)
    print("DSMIL eval forward, fused (B6) vs plain, device ms per bag with "
          "7/8 of its padded length valid: " + ", ".join(
              f"N={n} {f:.4f} vs {p:.4f}" for n, (f, p) in route_ms.items())
          + f" [{smi}]")
    print(f"DSMIL eval crossover on this card: the fused route wins from "
          f"N={cross} up (None: at no tested N); FUSE_MIN_N = "
          f"{fast.FUSE_MIN_N} (the JAX package's value, kept) [{smi}]")
    return {"max_abs_err": worst, "checks": checks,
            "ms": times[65536][0], "device_ms": times[65536][2],
            "plain_ms": times[65536][1],
            **_b6_bound(65536, d, q, c, 2), "library_ms": None,
            "library": "none (q must be formed first: two calls)",
            "crossover_n": cross, "by_kernel": by_kernel, "ptxas": ptxas,
            **more}


def dsmil_serve_run(smi: str) -> dict:
    """Slice 4's main path: DSMIL scoring through the port's CLI."""
    from acmil_tpu_torch.cli import predict
    from acmil_tpu_torch.config import Config
    from acmil_tpu_torch.data.bags import bucket_length, pad_bag
    from acmil_tpu_torch.data.ptio import write_feature_pt
    from acmil_tpu_torch.engine import checkpoint, make_eval_step
    from acmil_tpu_torch.models import fast
    from acmil_tpu_torch.ops.dsmil_pool import (B6_KERNELS,
                                                dsmil_pool_reference,
                                                fused_dsmil_pool)

    conf = Config.from_yaml(YML, {"arch": "dsmil"})
    if (conf.D_feat, conf.D_inner, conf.n_class) != (D_FEAT, D_INNER, 2):
        raise AssertionError(f"unexpected widths {conf.D_feat}/{conf.D_inner}")
    model, family = _dsmil_model(conf)
    rs = np.random.default_rng(SEED + 5)
    lengths = [1000, 50000, 65536, 40000, 33000, 60000] + rs.integers(
        1000, 65537, DSMIL_SERVE_SLIDES - 6).tolist()
    slides = _synthetic_slides(rs, lengths)
    big = sum(n > 32768 for n in lengths)
    fused_bags = sum(bucket_length(n, conf.min_bucket, conf.max_patches)
                     >= fast.FUSE_MIN_N for n in lengths)
    if big < DSMIL_BIG_SLIDES or fused_bags != big:
        raise AssertionError(f"{big} slides over 32768 patches")
    with tempfile.TemporaryDirectory() as tmp:
        feats = os.path.join(tmp, "feats.pt")
        ckpt = os.path.join(tmp, "checkpoint-best.pth")
        write_feature_pt(feats, slides)
        checkpoint.save(ckpt, model, epoch=0, conf=conf)
        argv = ["--config", YML, "--ckpt", ckpt, "--features", feats,
                "--out_csv", os.path.join(tmp, "preds.csv"), "--device", "cuda"]

        fused_dsmil_pool.launches = 0
        t0 = time.perf_counter()
        res = predict.main(argv)
        wall = time.perf_counter() - t0
        launches = fused_dsmil_pool.launches
    if launches != fused_bags:
        raise AssertionError(f"B6 launched {launches} times for {fused_bags} "
                             f"slides with a bucket of at least "
                             f"{fast.FUSE_MIN_N}")
    _check_predictions(res, len(slides), conf.n_class)

    model.cuda().eval()
    plain = make_eval_step(model, family, fused=False)
    fused = make_eval_step(model, family)
    worst = 0.0
    for row in res["rows"]:
        item = slides[row[0]]
        bag = pad_bag(item["feat"], item["coords"], item["label"],
                      min_bucket=conf.min_bucket,
                      max_patches=conf.max_patches, dtype=np.float16).to("cuda")
        want = plain(bag)[0].cpu().numpy()
        got = np.asarray(row[2:2 + conf.n_class])
        np.testing.assert_allclose(got, want, rtol=DSMIL_PROB_RTOL,
                                   atol=DSMIL_PROB_ATOL)
        worst = max(worst, float(np.abs(got - want).max()))
    print(f"dsmil serving: {len(slides)} slides ({min(lengths)}-{max(lengths)} "
          f"patches, {big} over 32768) scored by cli/predict.py in {wall:.2f} s; "
          f"B6 launches {launches} (= slides with a bucket >= FUSE_MIN_N); "
          f"probabilities finite, rows sum to 1, max |fused - plain| "
          f"{worst:.3e}")
    if res["metrics"] is not None:
        print("dsmil serving metrics (random weights): "
              + json.dumps(res["metrics"]))

    # where one 50000-patch slide's time goes, from host features
    item = slides["slide_01"]
    t_pad = statistics.median(_host_ms(lambda: pad_bag(
        item["feat"], item["coords"], item["label"], min_bucket=conf.min_bucket,
        max_patches=conf.max_patches, dtype=np.float16)) for _ in range(3))
    host = pad_bag(item["feat"], item["coords"], item["label"],
                   min_bucket=conf.min_bucket, max_patches=conf.max_patches,
                   dtype=np.float16)
    t_pin = statistics.median(_host_ms(host.pin_memory) for _ in range(3))
    pinned = host.pin_memory()
    t_h2d = _wall_ms(lambda: pinned.to("cuda", non_blocking=True), 5)
    bag = pinned.to("cuda")
    fused(bag)
    step_fused = _wall_ms(lambda: fused(bag), 10)
    step_plain = _wall_ms(lambda: plain(bag), 10)
    t_fused_dev = _time_ms(lambda: fused(bag), 10)
    x32 = bag.feats.float()
    rows = torch.arange(1, device="cuda")[:, None]
    inst_fc, q_fc = model.i_classifier.fc[0], model.b_classifier.q
    with torch.no_grad():
        inst = torch.nn.functional.linear(x32, inst_fc.weight, inst_fc.bias)
        crit = inst.argmax(dim=1)
        q_max = torch.nn.functional.linear(x32[rows, crit], q_fc.weight,
                                           q_fc.bias)
        wq, bq = q_fc.weight.t(), q_fc.bias
        t_b6 = _time_ms(lambda: fused_dsmil_pool(bag.feats, bag.mask, wq, bq,
                                                 q_max), 20)
        b6_dev, _ = _device_ms(lambda: fused_dsmil_pool(
            bag.feats, bag.mask, wq, bq, q_max), B6_KERNELS)
        t_pool_plain = _time_ms(lambda: dsmil_pool_reference(
            x32, bag.mask, wq, bq, q_max), 10)
    busy = _profile_device_ms(lambda: fused(bag), 5, step_fused)
    print(f"dsmil scoring, one {len(item['feat'])}-patch slide (bucket "
          f"{bag.feats.shape[1]}), from host features: pad_bag {t_pad:.3f} ms, "
          f"pin_memory {t_pin:.3f} ms, host->device {t_h2d:.3f} ms, eval step "
          f"wall {step_fused:.4f} ms fused ({t_fused_dev:.4f} ms CUDA events; "
          f"B6 alone {t_b6:.4f} ms a call, {_fmt_ms(b6_dev)} of device "
          f"time), plain {step_plain:.4f} ms (its pooling "
          f"alone {t_pool_plain:.4f} ms) [{smi}]")
    print(f"dsmil scoring, fused eval step under torch.profiler: {busy} "
          f"[{smi}]")
    return {"launches": launches, "slides": len(slides)}


def _profile_device_ms(fn, reps: int, wall_ms: float) -> str:
    """Device busy ms per call of ``fn`` and the top kernels by device time,
    from ``torch.profiler``, with the idle share against ``wall_ms`` (the
    call's wall without the profiler, which slows the host); "not measured"
    when two profiler windows in a row see no device time."""
    for _ in range(2):   # a window whose trace lost every device event
        prof, prof_wall = _profiled(fn, reps)
        events = _device_events(prof)
        if events:
            break
    by_name = {}
    for name, us in events:
        by_name[name] = by_name.get(name, 0.0) + us
    total = sum(by_name.values()) / 1e3 / reps
    if total <= 0:
        return "device time not measured (the profiler saw none, twice)"
    top = sorted(by_name.items(), key=lambda kv: kv[1], reverse=True)[:5]
    return (f"{total:.4f} ms of device time per step in {len(events) / reps:g} "
            f"device events, against {wall_ms:.4f} ms of wall unprofiled "
            f"(device idle {100 * (1 - total / wall_ms):.1f}%) and "
            f"{prof_wall:.4f} ms profiled; top: " + "; ".join(
                f"{name[:64]} {us / 1e3 / reps:.4f} ms" for name, us in top))


def dsmil_train_run(smi: str) -> int:
    """DSMIL training through the port's generic Step3 CLI; B6 scores every
    val/test bag whose bucket reaches FUSE_MIN_N."""
    from acmil_tpu_torch.cli import predict, step3_generic
    from acmil_tpu_torch.data.bags import bucket_length
    from acmil_tpu_torch.models import fast
    from acmil_tpu_torch.ops.dsmil_pool import fused_dsmil_pool

    rs = np.random.default_rng(SEED + 6)
    n_slides = N_TRAIN + N_VAL + N_TEST
    lengths = rs.integers(1000, 65537, n_slides).tolist()
    # big bags among val (slides 16-19) and test (20-23) too
    lengths[N_TRAIN], lengths[N_TRAIN + N_VAL] = 50000, 65536
    lengths[0], lengths[1] = 1000, 60000
    slides = _synthetic_slides(rs, lengths)
    evals = sum(bucket_length(n) >= fast.FUSE_MIN_N
                for n in lengths[N_TRAIN:])
    with tempfile.TemporaryDirectory() as tmp:
        data_dir, feats, yml = _write_split_corpus(tmp, slides, YML,
                                                   "medical_ssl", N_TRAIN,
                                                   N_VAL)
        ckpt_dir, log_dir = os.path.join(tmp, "ckpt"), os.path.join(tmp, "log")
        argv = ["--config", yml, "--arch", "dsmil", "--seed", "4",
                "--data_dir", data_dir, "--ckpt_dir", ckpt_dir,
                "--log_dir", log_dir, "--train_epoch", str(TRAIN_EPOCHS),
                "--device", "cuda"]

        torch.manual_seed(SEED)
        fused_dsmil_pool.launches = 0
        t0 = time.perf_counter()
        best = step3_generic.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = fused_dsmil_pool.launches

        if launches != TRAIN_EPOCHS * evals:
            raise AssertionError(f"B6 launched {launches} times: want once per "
                                 f"val/test bag with a bucket >= FUSE_MIN_N "
                                 f"per epoch ({TRAIN_EPOCHS} x {evals})")
        with open(os.path.join(log_dir, "metrics.jsonl")) as f:
            epochs = [r for r in map(json.loads, f) if "_config" not in r]
        losses = [r["train/loss"] for r in epochs]
        if len(losses) != TRAIN_EPOCHS or not all(map(math.isfinite, losses)):
            raise AssertionError(f"epoch losses {losses}")
        for tag in ("best", "last"):
            if not os.path.isfile(os.path.join(ckpt_dir, f"checkpoint-{tag}.pth")):
                raise AssertionError(f"no checkpoint-{tag}.pth")
        res = predict.main(["--config", yml, "--ckpt", ckpt_dir, "--features",
                            feats, "--out_csv", os.path.join(tmp, "preds.csv"),
                            "--device", "cuda"])
        _check_predictions(res, n_slides, 2)
    print(f"dsmil training: cli/step3_generic.py --arch dsmil, {TRAIN_EPOCHS} "
          f"epochs x {N_TRAIN} steps on {n_slides} slides "
          f"({min(lengths)}-{max(lengths)} patches), {wall:.2f} s wall; B6 "
          f"launches {launches} (= {TRAIN_EPOCHS} epochs x {evals} val/test "
          f"bags with a bucket >= FUSE_MIN_N); epoch losses "
          f"{', '.join(f'{v:.6f}' for v in losses)}; best epoch "
          f"{best.get('epoch')}; checkpoint-best rescored {n_slides} slides "
          f"through cli/predict.py [{smi}]")
    return launches


def _write_pipeline_slide(path: str, seed: int, tumor: bool) -> None:
    """One synthetic slide as a SPY pyramid, JPEG in 256-px tiles, through
    the port's writer (run in a worker process)."""
    from acmil_tpu_torch.wsi.synthetic import write_synthetic_spy

    write_synthetic_spy(path, *PIPE_SLIDE_WH, seed=seed, tumor=tumor)


def _batch_read_ms(slide, coords_pt: str, shard=(0, 1)) -> float:
    """Median host ms of Step2's read of one full batch from ``slide``: the
    coords of ``coords_pt`` cycled to STEP2_BATCH, each patch read and
    resized to 224 px as ``data/patch_dataset.py`` reads it, no prefetch.
    With ``shard=(index, count)``, data rank ``index``'s rows of it."""
    from acmil_tpu_torch.data.patch_dataset import SlidePatchBatches
    from acmil_tpu_torch.wsi.tiling import load_coords_pt

    coords, _, attrs = load_coords_pt(coords_pt)
    src = SlidePatchBatches(slide, np.resize(coords, (STEP2_BATCH, 2)),
                            int(attrs["patch_size"] * attrs.get("downsample",
                                                                1.0)),
                            int(attrs.get("patch_level", 0)),
                            target_size=PATCH_PX, batch_size=STEP2_BATCH,
                            prefetch=0, shard=shard)
    idx = np.arange(STEP2_BATCH)[src.pick]
    return statistics.median(_host_ms(lambda: src._make(idx))
                             for _ in range(3))


def _write_split(split_dir: str, train, val, test) -> None:
    os.makedirs(os.path.join(split_dir, "camelyon"), exist_ok=True)
    with open(os.path.join(split_dir, "camelyon", "split_4.json"), "w") as f:
        json.dump({"train_names": list(train), "val_names": list(val),
                   "test_names": list(test)}, f)


def _yml_with(tmp: str, name: str, **keys) -> str:
    """A copy of the camelyon_medical_ssl YAML with ``keys`` appended."""
    path = os.path.join(tmp, name)
    with open(YML) as src, open(path, "w") as dst:
        dst.write(src.read() + "".join(f"\n{k}: {v}" for k, v in keys.items())
                  + "\n")
    return path


def _epoch_losses(log_dir: str) -> list:
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        return [r["train/loss"] for r in map(json.loads, f)
                if "_config" not in r]


def pipeline_run(smi: str, tmp: str) -> dict:
    """Step1 -> Step2 -> Step3 -> predict -> Step4 through the port's CLIs
    alone, on six synthetic slides."""
    import concurrent.futures
    import multiprocessing
    import warnings

    import cv2

    from acmil_tpu_torch.cli import (predict, step1_patches, step2_extract,
                                     step3_acmil, step4_heatmap)
    from acmil_tpu_torch.config import Config
    from acmil_tpu_torch.data.bags import pad_bag
    from acmil_tpu_torch.data.ptio import open_feature_source
    from acmil_tpu_torch.engine import checkpoint
    from acmil_tpu_torch.models import build_mil_model
    from acmil_tpu_torch.models.encoders.build import (build_encoder,
                                                       encoder_feature_fn)
    from acmil_tpu_torch.ops import attn_pool as ap
    from acmil_tpu_torch.ops import vit_attn_packed, vit_layer
    from acmil_tpu_torch.wsi.heatmap import render_level
    from acmil_tpu_torch.wsi.slide import clear_slide_cache, open_slide
    from acmil_tpu_torch.wsi.synthetic import make_synthetic_slide_image
    from acmil_tpu_torch.wsi.tiling import load_coords_pt

    t_phase = time.perf_counter()
    names = [f"slide_{i}" for i in range(PIPE_SLIDES)]
    slide_dir = os.path.join(tmp, "slides")
    os.makedirs(slide_dir)
    t0 = time.perf_counter()
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(
            max_workers=min(PIPE_SLIDES, os.cpu_count() or 1),
            mp_context=ctx) as pool:
        futures = [pool.submit(_write_pipeline_slide,
                               os.path.join(slide_dir, f"{n}.spy"), SEED + i,
                               bool(i % 2)) for i, n in enumerate(names)]
        for fut in futures:
            fut.result()
    print(f"pipeline inputs: {PIPE_SLIDES} synthetic {PIPE_SLIDE_WH[0]}x"
          f"{PIPE_SLIDE_WH[1]} slides written as SPY pyramids (JPEG, "
          f"256-px tiles, wsi/native.py::write_spy) in "
          f"{time.perf_counter() - t0:.2f} s")

    # Step1: segmentation, tiling, masks, stitches, coords as torch files
    save_dir = os.path.join(tmp, "step1")
    t0 = time.perf_counter()
    done = step1_patches.main([
        "--source", slide_dir, "--save_dir", save_dir, "--patch_size",
        str(PIPE_PATCH), "--step_size", str(PIPE_PATCH), "--a_t", "1",
        "--a_h", "1", "--coords_format", "pt"])
    step1_s = time.perf_counter() - t0
    coords_dir = os.path.join(save_dir, "patches")
    n_patches = {}
    for n in names:
        sid = f"{n}.spy"
        coords, _, attrs = load_coords_pt(os.path.join(coords_dir, f"{n}.pt"))
        w, h = PIPE_SLIDE_WH
        if sid not in done or len(coords) == 0 or coords.min() < 0 \
                or coords[:, 0].max() >= w or coords[:, 1].max() >= h:
            raise AssertionError(f"{n}: Step1 coords {coords.shape}, "
                                 f"range {coords.min(0)}-{coords.max(0)}")
        for sub in ("masks", "stitches"):
            if not os.path.isfile(os.path.join(save_dir, sub, f"{n}.jpg")):
                raise AssertionError(f"{n}: no {sub} image")
        n_patches[n] = len(coords)
        print(f"  step1 {n}: {len(coords)} patches of {PIPE_PATCH} px; seg "
              f"{done[sid]['seg_s']:.3f} s, patch {done[sid]['patch_s']:.3f} "
              f"s, stitch {done[sid]['stitch_s']:.3f} s")
    total = sum(n_patches.values())
    print(f"step1: cli/step1_patches.py, {PIPE_SLIDES} slides of "
          f"{PIPE_SLIDE_WH[0]}x{PIPE_SLIDE_WH[1]}, {total} patches, "
          f"{step1_s:.2f} s wall (host)")

    # Step2: ViT-S/16 at full width, depth 12, batch 256 (B3, B5')
    labels = os.path.join(tmp, "labels.csv")
    with open(labels, "w") as f:
        f.write("slide_id,label\n" + "".join(f"{n},{i % 2}\n"
                                             for i, n in enumerate(names)))
    feat_dir = os.path.join(tmp, "feats")
    counters = (vit_layer.fused_vit_layer, vit_attn_packed._launch_packed)
    for c in counters:
        c.launches = 0
    # each step runs as its own command in use: no slide handle carries over
    clear_slide_cache()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")        # no pretrain_weights: seeded
        t0 = time.perf_counter()
        res = step2_extract.main([
            "--slide_dir", slide_dir, "--coords_dir", coords_dir,
            "--output_dir", feat_dir, "--pretrain", "medical_ssl",
            "--backbone", "ViT-S/16", "--batch_size", str(STEP2_BATCH),
            "--label_csv", labels, "--coords_format", "pt", "--out_format",
            "pt", "--device", "cuda"])
        torch.cuda.synchronize()
        step2_wall = time.perf_counter() - t0
    b3, b5 = (c.launches for c in counters)
    batches = sum(-(-n // STEP2_BATCH) for n in res["slides"].values())
    if b3 != STEP2_DEPTH * batches or b5 != b3:
        raise AssertionError(f"B3/B5' launched {b3}/{b5} times: want "
                             f"{STEP2_DEPTH} x {batches} batches each")
    feats = torch.load(res["out_path"], weights_only=True)
    for n in names:
        f = feats[n]["feat"]
        if f.dtype != torch.float16 or tuple(f.shape) != (n_patches[n], 384) \
                or not bool(torch.isfinite(f).all()):
            raise AssertionError(f"{n}: features {f.dtype} {tuple(f.shape)}")
    open_ms = [_host_ms(lambda n=n: open_slide(
        os.path.join(slide_dir, f"{n}.spy"), cache=False)) for n in names]
    # Step2's host read of one 256-patch batch per slide (its coords cycled
    # to 256), on the SPY pyramid and, for slide 0, on the same pixels as a
    # PNG opened as Step2 opened it before (decoded whole, ImageSlide)
    read_ms = [_batch_read_ms(open_slide(os.path.join(slide_dir, f"{n}.spy"),
                                         cache=False),
                              os.path.join(coords_dir, f"{n}.pt"))
               for n in names]
    png = os.path.join(tmp, "slide_0.png")
    img, _ = make_synthetic_slide_image(*PIPE_SLIDE_WH, seed=SEED, tumor=False)
    cv2.imwrite(png, cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
    del img
    png_open_ms = _host_ms(lambda: open_slide(png, cache=False))
    png_read_ms = _batch_read_ms(open_slide(png, cache=False),
                                 os.path.join(coords_dir, "slide_0.pt"))
    # the encoder's device time per batch of 256 patches of this slide set
    with warnings.catch_warnings(), torch.random.fork_rng(devices=[]):
        warnings.simplefilter("ignore")
        torch.manual_seed(0)
        model, spec, _ = build_encoder(Config.from_dict(
            {"pretrain": "medical_ssl", "backbone": "ViT-S/16"}))
    embed = encoder_feature_fn(model, spec, torch.device("cuda"))
    pix = np.random.default_rng(SEED).integers(
        0, 256, (STEP2_BATCH, spec.img_size, spec.img_size, 3), np.uint8)
    embed_ms = _time_ms(lambda: embed(pix), 5)
    for n, o, r in zip(names, open_ms, read_ms):
        print(f"  step2 {n}: open {o:.2f} ms (SPY header and tile tables), "
              f"{res['slides'][n]} patches at "
              f"{res['slides'][n] / res['slide_seconds'][n]:.1f} patches/s; "
              f"read+decode {r:.2f} ms per {STEP2_BATCH}-patch batch (host) "
              f"beside the encoder's {embed_ms:.4f} ms (device, CUDA events) "
              f"[{smi}]")
    print(f"step2: cli/step2_extract.py on Step1's coords over the SPY "
          f"slides, ViT-S/16 full width, depth {STEP2_DEPTH}, batch "
          f"{STEP2_BATCH}: {res['patches']} patches in {batches} batches, "
          f"{res['patches'] / res['seconds']:.1f} patches/s "
          f"({step2_wall:.2f} s for the whole main()); B3 launches {b3}, B5' "
          f"{b5}; fp16 [N, 384] finite; the same pixels as a PNG "
          f"(slide_0): open {png_open_ms:.1f} ms (decode and ImageSlide "
          f"pyramid), read {png_read_ms:.2f} ms a batch; feature closure per "
          f"batch of {STEP2_BATCH} from host pixels, CUDA events "
          f"{embed_ms:.4f} ms [{smi}]")

    # Step3: ACMIL_GA at camelyon_medical_ssl widths, 2 epochs, 4/1/1 split
    n_tr, n_va, _ = PIPE_SPLIT
    split_dir = os.path.join(tmp, "splits")
    _write_split(split_dir, names[:n_tr], names[n_tr:n_tr + n_va],
                 names[n_tr + n_va:])
    yml = _yml_with(tmp, "pipeline.yml", split_dir=split_dir,
                    data_dir=feat_dir)
    ckpt_dir, log_dir = os.path.join(tmp, "ckpt"), os.path.join(tmp, "log")
    ap.fused_gated_attn_pool_batched.launches = 0
    ap.fused_gated_attn_pool_bwd.launches = 0
    t0 = time.perf_counter()
    step3_acmil.main(["--config", yml, "--ckpt_dir", ckpt_dir, "--log_dir",
                      log_dir, "--train_epoch", str(TRAIN_EPOCHS),
                      "--n_token", str(N_TOKEN), "--n_masked_patch",
                      str(N_MASKED_PATCH), "--mask_drop", str(MASK_DROP),
                      "--device", "cuda"])
    torch.cuda.synchronize()
    step3_wall = time.perf_counter() - t0
    step3 = {"B1": ap.fused_gated_attn_pool_batched.launches,
             "B2": ap.fused_gated_attn_pool_bwd.launches}
    steps, evals = TRAIN_EPOCHS * n_tr, TRAIN_EPOCHS * (PIPE_SLIDES - n_tr)
    if step3 != {"B1": steps + evals, "B2": steps}:
        raise AssertionError(f"Step3 launches {step3}: want B2 {steps}, B1 "
                             f"{steps + evals}")
    losses = _epoch_losses(log_dir)
    if len(losses) != TRAIN_EPOCHS or not all(map(math.isfinite, losses)):
        raise AssertionError(f"epoch losses {losses}")

    # predict over every slide's features
    ap.fused_gated_attn_pool_batched.launches = 0
    scored = predict.main(["--config", yml, "--ckpt", ckpt_dir, "--features",
                           res["out_path"], "--out_csv",
                           os.path.join(tmp, "preds.csv"), "--device", "cuda"])
    b1_predict = ap.fused_gated_attn_pool_batched.launches
    if b1_predict != PIPE_SLIDES:
        raise AssertionError(f"predict: B1 launched {b1_predict} times")
    _check_predictions(scored, PIPE_SLIDES, 2)

    # Step4: heatmaps of the test slide through B1
    heat_dir = os.path.join(tmp, "heatmaps")
    clear_slide_cache()
    ap.fused_gated_attn_pool_batched.launches = 0
    t0 = time.perf_counter()
    heat = step4_heatmap.main(["--config", yml, "--ckpt_dir", ckpt_dir,
                               "--slide_dir", slide_dir, "--output_dir",
                               heat_dir, "--patch_size", str(PIPE_PATCH),
                               "--device", "cuda"])
    step4_wall = time.perf_counter() - t0
    b1_step4 = ap.fused_gated_attn_pool_batched.launches
    test_names = names[n_tr + n_va:]
    if sorted(heat["slides"]) != test_names or not heat["fused"] \
            or b1_step4 != len(test_names):
        raise AssertionError(f"Step4 rendered {sorted(heat['slides'])}, "
                             f"fused {heat['fused']}, B1 launches {b1_step4}")
    for n, r in heat["slides"].items():
        img = cv2.imread(r["path"])
        slide = open_slide(os.path.join(slide_dir, f"{n}.spy"))
        lw, lh = slide.level_dimensions[render_level(slide)]
        if img is None or img.shape != (lh, lw, 3) or img.std() < 5:
            raise AssertionError(f"{n}: heatmap {None if img is None else img.shape}"
                                 f" against level {(lh, lw)}")
    # B1's attention against the plain forward's on the same bag (these
    # launches are a comparison, outside the counted path)
    ck = checkpoint.load(checkpoint.checkpoint_path(ckpt_dir, "best"))
    conf = Config.from_yaml(yml)
    checkpoint.adopt_checkpoint_config(conf, ck["config"])
    head, family = build_mil_model(conf)
    head.load_state_dict(ck["model"])
    head.cuda().eval()
    src = open_feature_source(res["out_path"], test_names)
    item = src[0]
    bag = pad_bag(item["input"], item["coords"], item["label"],
                  dtype=np.float16).to("cuda")
    fused = step4_heatmap.attention_probs(head, bag, family)
    plain = step4_heatmap.attention_probs(head, bag, family, fused=False)
    n_valid = int(bag.mask.sum())
    step4_err = float((fused - plain)[0, :n_valid].abs().max())
    if step4_err > STEP4_ATOL:
        raise AssertionError(f"Step4 attention B1 vs plain {step4_err}")
    per = [f"{n}: attention {r['attn_ms']:.2f} ms, render {r['render_ms']:.1f} ms"
           for n, r in heat["slides"].items()]
    print(f"step3 -> predict -> step4: cli/step3_acmil.py --arch ga "
          f"({TRAIN_EPOCHS} epochs x {n_tr} steps on Step2's features, "
          f"{step3_wall:.2f} s wall; launches B1 {step3['B1']}, B2 "
          f"{step3['B2']}; epoch losses {', '.join(f'{v:.6f}' for v in losses)})"
          f"; cli/predict.py scored {PIPE_SLIDES} slides (B1 {b1_predict}); "
          f"cli/step4_heatmap.py rendered {len(heat['slides'])} test slide "
          f"heatmap(s) at the rendered level's shape in {step4_wall:.2f} s "
          f"(B1 {b1_step4}; {'; '.join(per)}); Step4 B1 vs plain attention "
          f"max |diff| {step4_err:.3e} at valid slots [{smi}]")
    print(f"pipeline phase wall {time.perf_counter() - t_phase:.2f} s [{smi}]")
    return {"B3": b3, "B5": b5, "B1_step3": step3["B1"], "B2": step3["B2"],
            "B1_predict": b1_predict, "B1_step4": b1_step4,
            "slide_dir": slide_dir, "coords_dir": coords_dir,
            "feat_path": res["out_path"], "yml": yml, "labels": labels,
            "step2_slides": res["slides"],
            "step2_seconds": res["slide_seconds"],
            "names": names, "step4_err": step4_err}


def mha_run(smi: str, tmp: str, pipe: dict) -> dict:
    """ACMIL_MHA and MHA: Step3 training, scoring on the card and on the
    CPU, Step4 on two slides of the pipeline phase, the generic trainer's
    ``mha``; then a step and a slide at 50000 patches timed. Returns the
    24-slide corpus (data_dir, yml, feats, lengths, slides) for phase 17."""
    from acmil_tpu_torch.cli import (predict, step3_acmil, step3_generic,
                                     step4_heatmap)
    from acmil_tpu_torch.config import Config
    from acmil_tpu_torch.data.bags import pad_bag
    from acmil_tpu_torch.engine import (checkpoint, create_train_state,
                                        get_family, make_eval_step,
                                        make_train_step)
    from acmil_tpu_torch.models import build_mil_model
    from acmil_tpu_torch.models.acmil import ACMIL_MHA

    t_phase = time.perf_counter()
    rs = np.random.default_rng(SEED + 15)
    n_slides = N_TRAIN + N_VAL + N_TEST
    lengths = rs.integers(1000, 65537, n_slides).tolist()
    lengths[0], lengths[1] = 1000, 50000
    lengths[N_TRAIN], lengths[N_TRAIN + N_VAL] = 65536, 50000
    slides = _synthetic_slides(rs, lengths)
    root = os.path.join(tmp, "mha")
    data_dir, feats, yml = _write_split_corpus(root, slides, YML,
                                               "medical_ssl", N_TRAIN, N_VAL)
    ckpt_dir, log_dir = os.path.join(root, "ckpt"), os.path.join(root, "log")
    torch.manual_seed(SEED)
    t0 = time.perf_counter()
    step3_acmil.main(["--config", yml, "--arch", "mha", "--data_dir",
                      data_dir, "--ckpt_dir", ckpt_dir, "--log_dir", log_dir,
                      "--train_epoch", str(TRAIN_EPOCHS), "--n_token",
                      str(N_TOKEN), "--n_masked_patch", str(N_MASKED_PATCH),
                      "--mask_drop", str(MASK_DROP), "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    losses = _epoch_losses(log_dir)
    if len(losses) != TRAIN_EPOCHS or not all(map(math.isfinite, losses)):
        raise AssertionError(f"ACMIL_MHA epoch losses {losses}")
    ck = checkpoint.load(checkpoint.checkpoint_path(ckpt_dir, "best"))
    if ck["config"]["arch"] != "mha":
        raise AssertionError(f"checkpoint arch {ck['config']['arch']}")

    scored = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        scored[dev] = predict.main([
            "--config", yml, "--ckpt", ckpt_dir, "--features", feats,
            "--out_csv", os.path.join(root, f"preds_{dev}.csv"), "--device",
            dev])
        scored[dev + "_s"] = time.perf_counter() - t0
        _check_predictions(scored[dev], n_slides, 2)
    card_p = np.asarray([r[2:4] for r in scored["cuda"]["rows"]])
    cpu_p = np.asarray([r[2:4] for r in scored["cpu"]["rows"]])
    cpu_err = float(np.abs(card_p - cpu_p).max())
    if cpu_err > MHA_CPU_ATOL:
        raise AssertionError(f"ACMIL_MHA card vs CPU probabilities {cpu_err}")

    # Step4 with this head on two slides of the pipeline phase
    names = pipe["names"]
    split_dir = os.path.join(root, "splits4")
    _write_split(split_dir, names[:-2], [], names[-2:])
    yml4 = _yml_with(root, "step4.yml", split_dir=split_dir,
                     data_dir=os.path.dirname(pipe["feat_path"]))
    heat = step4_heatmap.main(["--config", yml4, "--ckpt_dir", ckpt_dir,
                               "--slide_dir", pipe["slide_dir"],
                               "--output_dir", os.path.join(root, "heat"),
                               "--patch_size", str(PIPE_PATCH),
                               "--device", "cuda"])
    if sorted(heat["slides"]) != names[-2:] or any(
            not os.path.isfile(r["path"]) or not np.isfinite(r["scores"]).all()
            for r in heat["slides"].values()):
        raise AssertionError(f"Step4 with ACMIL_MHA: {sorted(heat['slides'])}")

    # the generic trainer's `mha` is MHA (`mha_single`)
    gen_ckpt, gen_log = os.path.join(root, "ckpt_g"), os.path.join(root, "log_g")
    t0 = time.perf_counter()
    step3_generic.main(["--config", yml, "--arch", "mha", "--data_dir",
                        data_dir, "--ckpt_dir", gen_ckpt, "--log_dir",
                        gen_log, "--train_epoch", "1", "--device", "cuda"])
    torch.cuda.synchronize()
    gen_wall = time.perf_counter() - t0
    gen_losses = _epoch_losses(gen_log)
    gck = checkpoint.load(checkpoint.checkpoint_path(gen_ckpt, "last"))
    if gck["config"]["arch"] != "mha_single" or len(gen_losses) != 1 \
            or not math.isfinite(gen_losses[0]):
        raise AssertionError(f"generic mha: arch {gck['config']['arch']}, "
                             f"losses {gen_losses}")

    # one 50000-patch bag on the device: a training step and a slide's eval
    conf = Config.from_yaml(YML, {"arch": "mha", "n_token": N_TOKEN,
                                  "n_masked_patch": N_MASKED_PATCH,
                                  "mask_drop": MASK_DROP})
    model, family = build_mil_model(conf)
    model.load_state_dict(ck["model"])
    model.cuda()
    if not isinstance(model, ACMIL_MHA) or \
            model.sub_attention[0].num_heads != MHA_HEADS:
        raise AssertionError("unexpected ACMIL_MHA build")
    item = slides["slide_01"]
    bag = pad_bag(item["feat"], item["coords"], item["label"],
                  dtype=np.float16).to("cuda")
    state = create_train_state(model, conf, 1)
    step = make_train_step(model, conf, get_family(family))
    step_ms = _wall_ms(lambda: step(state, bag), 10)
    step_dev = _profile_device_ms(lambda: step(state, bag), 5, step_ms)
    eval_step = make_eval_step(model, family)
    eval_ms = _wall_ms(lambda: eval_step(bag), 10)
    eval_dev = _profile_device_ms(lambda: eval_step(bag), 5, eval_ms)
    print(f"acmil_mha: cli/step3_acmil.py --arch mha ({MHA_HEADS} heads, "
          f"n_token {N_TOKEN}, STKIM on), {TRAIN_EPOCHS} epochs x {N_TRAIN} "
          f"steps on {n_slides} slides ({min(lengths)}-{max(lengths)} "
          f"patches), {wall:.2f} s wall; epoch losses "
          f"{', '.join(f'{v:.6f}' for v in losses)}; cli/predict.py on cuda "
          f"{scored['cuda_s']:.2f} s and on the CPU {scored['cpu_s']:.2f} s "
          f"for {n_slides} slides, max |card - CPU| probability "
          f"{cpu_err:.3e}; cli/step4_heatmap.py rendered "
          f"{len(heat['slides'])} slides [{smi}]")
    print(f"mha (generic trainer, mha_single): 1 epoch x {N_TRAIN} steps, "
          f"{gen_wall:.2f} s wall, loss {gen_losses[0]:.6f} [{smi}]")
    print(f"acmil_mha at 50000 patches (bucket 65536), bag on the device: "
          f"training step {step_ms:.4f} ms wall (median of 10), {step_dev} "
          f"[{smi}]")
    print(f"acmil_mha eval per slide at 50000 patches: {eval_ms:.4f} ms wall "
          f"(median of 10), {eval_dev} [{smi}]")
    print(f"acmil_mha phase wall {time.perf_counter() - t_phase:.2f} s [{smi}]")
    return {"data_dir": data_dir, "yml": yml, "feats": feats,
            "lengths": lengths, "slides": slides}


# (location in level-0 px, level, (w, h)) of the reader check: inside,
# across the right and bottom edges, across the top-left corner, fully
# outside past each edge, straddling tiles, whole levels
READER_REGIONS = (((0, 0), 0, (256, 256)), ((100, 37), 0, (300, 200)),
                  ((1200, 1000), 0, (300, 300)), ((1250, 100), 0, (300, 64)),
                  ((-50, -70), 0, (120, 130)), ((5000, 100), 0, (64, 64)),
                  ((100, 5000), 0, (64, 64)), ((-900, 0), 0, (100, 100)),
                  ((0, -900), 0, (100, 100)), ((513, 257), 1, (300, 200)),
                  ((-100, 300), 1, (700, 500)), ((0, 0), 0, (1300, 1100)),
                  ((0, 0), 1, (650, 550)))


def _tile_round_trip(level: np.ndarray, tile: int) -> np.ndarray:
    """``level`` with each tile JPEG-coded and decoded on its own by cv2, as
    a SPY file holds it."""
    from acmil_tpu_torch.wsi.native import decode_jpeg, encode_jpeg

    out = np.empty_like(level)
    for y in range(0, level.shape[0], tile):
        for x in range(0, level.shape[1], tile):
            t = level[y:y + tile, x:x + tile]
            out[y:y + tile, x:x + tile] = decode_jpeg(encode_jpeg(t))
    return out


def reader_check(smi: str, tmp: str) -> None:
    """The SPY reader on this machine's cv2: a raw-codec round trip exact; a
    JPEG one equal to the tiles' own round trips assembled, and within
    SPY_JPEG_MAE of its source; white past every edge as ``ImageSlide``
    fills it."""
    import cv2

    from acmil_tpu_torch.wsi.native import NativeSlide, write_spy
    from acmil_tpu_torch.wsi.slide import ImageSlide
    from acmil_tpu_torch.wsi.synthetic import make_synthetic_slide_image

    img, _ = make_synthetic_slide_image(1300, 1100, seed=SEED + 20,
                                        tumor=True)
    ref = ImageSlide(img)
    # the JPEG file's pixels, assembled tile by tile outside the reader
    coded = copy.copy(ref)
    coded._levels = [_tile_round_trip(l, 256) for l in ref._levels]
    worst, timing = {}, {}
    for codec in ("raw", "jpeg"):
        path = os.path.join(tmp, f"reader_{codec}.spy")
        write_spy(path, ref._levels, tile_size=256, codec=codec)
        t0 = time.perf_counter()
        slide = NativeSlide(path)
        open_ms = (time.perf_counter() - t0) * 1e3
        if (slide.level_dimensions != ref.level_dimensions
                or slide.level_downsamples != ref.level_downsamples):
            raise AssertionError(f"{codec}: levels {slide.level_dimensions}")
        mae = 0.0
        for loc, level, (w, h) in READER_REGIONS:
            got = slide.read_region(loc, level, (w, h))
            want = ref.read_region(loc, level, (w, h))
            # the window's pixels inside the level
            lw, lh = ref.level_dimensions[level]
            ds = ref.level_downsamples[level]
            xs = int(loc[0] / ds) + np.arange(w)
            ys = int(loc[1] / ds) + np.arange(h)
            inside = (((ys >= 0) & (ys < lh))[:, None]
                      & ((xs >= 0) & (xs < lw))[None, :])
            if not np.array_equal(got[~inside], want[~inside]) \
                    or not (got[~inside] == 255).all():
                raise AssertionError(f"{codec} {loc} {level}: fill past the "
                                     "edge is not ImageSlide's white")
            exact = want if codec == "raw" else coded.read_region(
                loc, level, (w, h))
            if not np.array_equal(got, exact):
                raise AssertionError(f"{codec} {loc} {level}: pixels differ "
                                     "from the tiles' own round trip")
            if inside.any():
                mae = max(mae, float(np.abs(got[inside].astype(np.float64)
                                            - want[inside]).mean()))
        if codec == "jpeg" and not mae <= SPY_JPEG_MAE:
            raise AssertionError(f"JPEG round trip: mean |error| {mae}")
        worst[codec] = mae
        read_ms = statistics.median(
            _host_ms(lambda: slide.read_region((700, 500), 0, (256, 256)))
            for _ in range(20))
        timing[codec] = (open_ms, read_ms)
        slide.close()
    print(f"SPY reader (wsi/native.py, cv2 {cv2.__version__}): a 1300x1100 "
          f"synthetic slide, {len(ref._levels)} levels, 256-px tiles, "
          f"{len(READER_REGIONS)} regions each (edges, fully outside, whole "
          f"levels): raw round trip exact, JPEG equal to its tiles' own cv2 "
          f"round trips and its worst mean |error| against the source "
          f"{worst['jpeg']:.4f} (limit {SPY_JPEG_MAE}); white past every edge "
          f"as ImageSlide; open {timing['raw'][0]:.3f} / "
          f"{timing['jpeg'][0]:.3f} ms, a 256-px read across 4 tiles "
          f"{timing['raw'][1]:.3f} / {timing['jpeg'][1]:.3f} ms (raw / JPEG, "
          f"host) [{smi}]")


def _clam_conf(arch: str, n_class: int, **keys):
    from acmil_tpu_torch.config import Config

    return Config.from_yaml(YML, {"arch": arch, "n_class": n_class,
                                  "droprate": 0, **keys})


def _clam_routes(smi: str, arch: str, n_class: int) -> float:
    """Fused (B1 + B2) against plain training of one CLAM head on 50000-patch
    bags, from the same weights: one step's loss, instance loss and every
    gradient, then five AdamW steps' losses. Returns the worst relative
    gradient difference."""
    from acmil_tpu_torch.data.bags import pad_bag
    from acmil_tpu_torch.engine import (create_train_state, get_family,
                                        make_train_step)
    from acmil_tpu_torch.models import build_mil_model
    from acmil_tpu_torch.ops import attn_pool as ap

    model0, family = build_mil_model(_clam_conf(arch, n_class))
    fam = get_family(family)
    rs = np.random.default_rng(SEED + 16)
    bags = [pad_bag(d["feat"], d["coords"], i % n_class,
                    dtype=np.float16).to("cuda")
            for i, d in enumerate(_synthetic_slides(
                rs, CLAM_ROUTE_LENGTHS).values())]
    one = {}
    for fused in (True, False):
        model = copy.deepcopy(model0).cuda()
        conf_d = fam.conf_dict(_clam_conf(arch, n_class, fused_train=fused))
        ap.fused_gated_attn_pool_batched.launches = 0
        ap.fused_gated_attn_pool_bwd.launches = 0
        out = fam.train_outputs(model.train(), bags[0], conf_d)
        loss, parts = fam.loss(out, bags[0], bags[0].mask.any(dim=1), conf_d)
        loss.backward()
        launched = (ap.fused_gated_attn_pool_batched.launches,
                    ap.fused_gated_attn_pool_bwd.launches)
        if launched != ((1, 1) if fused else (0, 0)):
            raise AssertionError(f"{arch}: B1/B2 launched {launched}")
        one[fused] = (float(loss.detach()),
                      float(parts["instance_loss"].detach()),
                      {n: p.grad for n, p in model.named_parameters()})
    (l_f, i_f, g_f), (l_p, i_p, g_p) = one[True], one[False]
    if not (abs(l_f - l_p) <= STEP_LOSS_RTOL * abs(l_p)
            and abs(i_f - i_p) <= STEP_LOSS_RTOL * abs(i_p)):
        raise AssertionError(f"{arch} C={n_class} one step: loss fused {l_f} "
                             f"plain {l_p}, instance {i_f} / {i_p}")
    # the attention output bias's gradient is the sum of the rows' logit
    # gradients, which cancels: to 0 in exact arithmetic for SB's softmax
    # (a shift is ignored), to the phantom logit's share, ~1/N, for MB's
    # softmax-one. Both routes give that sum's rounding residue, so it is
    # held against the scale of the output weight's gradient, whose terms
    # are the same rows'
    zero = "attention_net.2.attention_c.bias"
    for n in g_p:
        err = float((g_f[n] - g_p[n]).abs().max())
        scale = g_p[n.replace("bias", "weight") if n == zero else n]
        if not err <= STEP_GRAD_REL * float(scale.abs().max()) + STEP_GRAD_ATOL:
            raise AssertionError(f"{arch} C={n_class}: gradient of {n} "
                                 f"differs by {err:.3e}")
    worst = max(_rel_to_max(g_f[n], g_p[n]) for n in g_p if n != zero)
    losses = {}
    for fused in (True, False):
        conf = _clam_conf(arch, n_class, fused_train=fused)
        model = copy.deepcopy(model0).cuda()
        state = create_train_state(model, conf, steps_per_epoch=len(bags))
        step = make_train_step(model, conf, family)
        losses[fused] = [float(step(state, bags[i % 3])["loss"])
                         for i in range(5)]
    adam = max(abs(a - b) / abs(b) for a, b in zip(losses[True],
                                                   losses[False]))
    if not adam <= ADAM_LOSS_RTOL:
        raise AssertionError(f"{arch} C={n_class} AdamW losses {losses}")
    print(f"  {arch} C={n_class}: one step at {CLAM_ROUTE_LENGTHS[0]} "
          f"patches, loss fused {l_f:.7f} plain {l_p:.7f}, instance loss "
          f"{i_f:.7f} / {i_p:.7f}; worst gradient difference {worst:.3e} of "
          f"its max over the other {len(g_p) - 1} tensors, attention output "
          f"bias |fused| {float(g_f[zero].abs().max()):.3e} |plain| "
          f"{float(g_p[zero].abs().max()):.3e} against |output weight| "
          f"{float(g_p[zero.replace('bias', 'weight')].abs().max()):.3e}; "
          f"five AdamW steps, worst relative loss difference {adam:.3e}")
    return worst


def _clam_train(yml, data_dir, arch, ckpt_dir, log_dir, epochs):
    """``cli/step3_generic.py --arch ARCH`` on the card; (launches of B1 and
    B2, wall s, epoch losses)."""
    from acmil_tpu_torch.cli import step3_generic
    from acmil_tpu_torch.ops import attn_pool as ap

    ap.fused_gated_attn_pool_batched.launches = 0
    ap.fused_gated_attn_pool_bwd.launches = 0
    t0 = time.perf_counter()
    step3_generic.main(["--config", yml, "--arch", arch, "--data_dir",
                        data_dir, "--ckpt_dir", ckpt_dir, "--log_dir", log_dir,
                        "--train_epoch", str(epochs), "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"B1": ap.fused_gated_attn_pool_batched.launches,
                "B2": ap.fused_gated_attn_pool_bwd.launches}
    losses = _epoch_losses(log_dir)
    if len(losses) != epochs or not all(map(math.isfinite, losses)):
        raise AssertionError(f"{arch} epoch losses {losses}")
    return launches, wall, losses


def clam_run(smi: str, tmp: str, pipe: dict, corpus: dict) -> dict:
    """CLAM_SB and CLAM_MB at the camelyon_medical_ssl widths: (a) fused
    against plain training on 50000-patch bags, n_class 2 and 4; (b) two
    epochs of the generic trainer per arch at ``droprate: 0`` on phase 16's
    24 slides, B1/B2 counted, the best checkpoint scored through
    ``cli/predict.py`` against the plain route, Step4 on a SPY slide of
    phase 15 with the MB head; (c) one epoch at the reference's dropout
    0.25, which must launch no B2; (d) a step and an eval at 50000 patches
    timed. Returns the launch counts."""
    from acmil_tpu_torch.cli import predict, step4_heatmap
    from acmil_tpu_torch.config import Config
    from acmil_tpu_torch.data.bags import bucket_length, pad_bag
    from acmil_tpu_torch.engine import (checkpoint, create_train_state,
                                        get_family, make_eval_step,
                                        make_train_step)
    from acmil_tpu_torch.models import build_mil_model, fast
    from acmil_tpu_torch.ops import attn_pool as ap
    from acmil_tpu_torch.wsi.slide import clear_slide_cache

    t_phase = time.perf_counter()
    # (a) the routes, and the softmax-one wrapper on the card (MB)
    worst = {(a, c): _clam_routes(smi, a, c) for a in ("clam_sb", "clam_mb")
             for c in CLAM_CLASSES}
    print(f"clam routes: fused (B1, B2; MB through the softmax-one rescale "
          f"and lse1) against plain, f32 with TF32 off, at n_class "
          f"{CLAM_CLASSES}: worst gradient difference "
          f"{max(worst.values()):.3e} of its max [{smi}]")

    # (b) two epochs per arch at droprate 0 on phase 16's corpus
    root = os.path.join(tmp, "clam")
    os.makedirs(root)
    yml = os.path.join(root, "clam.yml")
    with open(corpus["yml"]) as src, open(yml, "w") as dst:
        dst.write(src.read() + "\ndroprate: 0\n")
    conf = Config.from_yaml(yml)
    big = [bucket_length(n, conf.min_bucket, conf.max_patches)
           >= fast.FUSE_MIN_N for n in corpus["lengths"]]
    steps, evals = sum(big[:N_TRAIN]), sum(big[N_TRAIN:])
    out, ckpts = {}, {}
    for arch in ("clam_sb", "clam_mb"):
        ckpts[arch] = os.path.join(root, f"ckpt_{arch}")
        launches, wall, losses = _clam_train(
            yml, corpus["data_dir"], arch, ckpts[arch],
            os.path.join(root, f"log_{arch}"), TRAIN_EPOCHS)
        want = {"B1": TRAIN_EPOCHS * (steps + evals),
                "B2": TRAIN_EPOCHS * steps}
        if launches != want:
            raise AssertionError(f"{arch} launches {launches}: want {want} "
                                 f"({steps} train steps and {evals} val/test "
                                 f"bags a epoch with a bucket >= FUSE_MIN_N)")
        ck = checkpoint.load(checkpoint.checkpoint_path(ckpts[arch], "best"))
        if ck["config"]["arch"] != arch or ck["config"]["droprate"] != 0:
            raise AssertionError(f"{arch} checkpoint config {ck['config']}")
        # the best checkpoint through cli/predict.py (B1 at every bucket >=
        # FUSE_MIN_N), against the plain route on the same bags
        ap.fused_gated_attn_pool_batched.launches = 0
        t0 = time.perf_counter()
        scored = predict.main(["--config", yml, "--ckpt", ckpts[arch],
                               "--features", corpus["feats"], "--out_csv",
                               os.path.join(root, f"preds_{arch}.csv"),
                               "--device", "cuda"])
        predict_s = time.perf_counter() - t0
        b1_predict = ap.fused_gated_attn_pool_batched.launches
        if b1_predict != sum(big):
            raise AssertionError(f"{arch} predict: B1 launched {b1_predict}")
        _check_predictions(scored, len(corpus["lengths"]), 2)
        head, _ = build_mil_model(_clam_conf(arch, 2))
        head.load_state_dict(ck["model"])
        plain_step = make_eval_step(head.cuda(), "clam", fused=False)
        err = 0.0
        for row in scored["rows"]:
            d = corpus["slides"][row[0]]
            bag = pad_bag(d["feat"], d["coords"], d["label"],
                          dtype=np.float16).to("cuda")
            want_p = plain_step(bag)[0].cpu().numpy()
            err = max(err, float(np.abs(np.asarray(row[2:4]) - want_p).max()))
        if not err <= CLAM_PROB_ATOL:
            raise AssertionError(f"{arch} predict against plain: {err}")
        out[arch] = {"B1": launches["B1"], "B2": launches["B2"],
                     "B1_predict": b1_predict}
        print(f"{arch}: cli/step3_generic.py --arch {arch} (droprate 0), "
              f"{TRAIN_EPOCHS} epochs x {N_TRAIN} steps on "
              f"{len(corpus['lengths'])} slides "
              f"({min(corpus['lengths'])}-{max(corpus['lengths'])} patches), "
              f"{wall:.2f} s wall; launches B1 {launches['B1']}, B2 "
              f"{launches['B2']} (= {TRAIN_EPOCHS} x ({steps} steps, {evals} "
              f"eval bags) with a bucket >= FUSE_MIN_N); epoch losses "
              f"{', '.join(f'{v:.6f}' for v in losses)}; cli/predict.py "
              f"{predict_s:.2f} s, B1 {b1_predict}, max |card - plain| "
              f"probability {err:.3e} [{smi}]")

    # Step4 on a SPY slide of phase 15 with the MB head (B1 once)
    names = pipe["names"]
    split_dir = os.path.join(root, "splits4")
    _write_split(split_dir, names[:-1], [], names[-1:])
    yml4 = _yml_with(root, "step4.yml", split_dir=split_dir,
                     data_dir=os.path.dirname(pipe["feat_path"]))
    clear_slide_cache()
    ap.fused_gated_attn_pool_batched.launches = 0
    heat = step4_heatmap.main(["--config", yml4, "--ckpt_dir",
                               ckpts["clam_mb"], "--slide_dir",
                               pipe["slide_dir"], "--output_dir",
                               os.path.join(root, "heat"), "--patch_size",
                               str(PIPE_PATCH), "--device", "cuda"])
    b1_step4 = ap.fused_gated_attn_pool_batched.launches
    r = heat["slides"].get(names[-1])
    if not heat["fused"] or b1_step4 != 1 or r is None \
            or not os.path.isfile(r["path"]) \
            or not np.isfinite(r["scores"]).all():
        raise AssertionError(f"Step4 with CLAM_MB: {sorted(heat['slides'])}, "
                             f"B1 {b1_step4}")
    print(f"clam_mb Step4: cli/step4_heatmap.py rendered {names[-1]}.spy "
          f"(attention {r['attn_ms']:.2f} ms, render {r['render_ms']:.1f} "
          f"ms; B1 {b1_step4}) [{smi}]")

    # (c) the reference's dropout 0.25: the plain training route, no B2
    drop, drop_wall, drop_losses = _clam_train(
        corpus["yml"], corpus["data_dir"], "clam_mb",
        os.path.join(root, "ckpt_drop"), os.path.join(root, "log_drop"), 1)
    if drop != {"B1": evals, "B2": 0}:
        raise AssertionError(f"droprate 0.25 launches {drop}: want B1 "
                             f"{evals} (eval only), B2 0")
    print(f"clam_mb at droprate 0.25: 1 epoch, {drop_wall:.2f} s wall, loss "
          f"{drop_losses[0]:.6f}; launches B1 {drop['B1']} (eval bags), B2 "
          f"{drop['B2']} [{smi}]")

    # (d) a step and an eval at 50000 patches (bucket 65536)
    d = corpus["slides"]["slide_01"]
    bag = pad_bag(d["feat"], d["coords"], d["label"],
                  dtype=np.float16).to("cuda")
    for arch in ("clam_sb", "clam_mb"):
        conf = _clam_conf(arch, 2)
        model, family = build_mil_model(conf)
        model.cuda()
        state = create_train_state(model, conf, 1)
        step = make_train_step(model, conf, get_family(family))
        eval_step = make_eval_step(model, family)
        ap.fused_gated_attn_pool_batched.launches = 0
        ap.fused_gated_attn_pool_bwd.launches = 0
        step(state, bag)
        eval_step(bag)
        torch.cuda.synchronize()
        per = (ap.fused_gated_attn_pool_batched.launches,
               ap.fused_gated_attn_pool_bwd.launches)
        if per != (2, 1):
            raise AssertionError(f"{arch}: a step and an eval launched "
                                 f"B1/B2 {per}")
        step_ms = _wall_ms(lambda: step(state, bag), 10)
        step_dev = _profile_device_ms(lambda: step(state, bag), 5, step_ms)
        eval_ms = _wall_ms(lambda: eval_step(bag), 10)
        eval_dev = _profile_device_ms(lambda: eval_step(bag), 5, eval_ms)
        print(f"{arch} at {len(d['feat'])} patches (bucket "
              f"{bag.feats.shape[1]}), bag on the device: training step "
              f"(B1 1, B2 1) {step_ms:.4f} ms wall (median of 10), "
              f"{step_dev} [{smi}]")
        print(f"{arch} eval (B1 1): {eval_ms:.4f} ms wall (median of 10), "
              f"{eval_dev} [{smi}]")
    print(f"clam phase wall {time.perf_counter() - t_phase:.2f} s [{smi}]")
    out["B1_step4"], out["dropout_epoch"] = b1_step4, drop
    return out


def _event_ms(fn, reps):
    """Median ms of ``fn`` between two CUDA events over ``reps`` calls."""
    out = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        out.append(e0.elapsed_time(e1))
    return statistics.median(out)


def _device_profile(fn, reps):
    """(device ms, device events) per call of ``fn`` from ``torch.profiler``:
    every kernel, copy and set on the card; (None, None) when two windows in
    a row see no device event."""
    for _ in range(2):
        prof, _ = _profiled(fn, reps)
        events = _device_events(prof)
        if events:
            return sum(us for _, us in events) / 1e3 / reps, len(events) / reps
    return None, None


def _top_kernels(fn, reps=3, k=4) -> dict:
    """The ``k`` device events of ``fn`` with the most time, ms per call by
    name (cut to 60 characters), from one ``torch.profiler`` window."""
    prof, _ = _profiled(fn, reps)
    per = {}
    for name, us in _device_events(prof):
        per[name[:60]] = per.get(name[:60], 0.0) + us / reps / 1e3
    return dict(sorted(per.items(), key=lambda kv: -kv[1])[:k])


def _raises(fn, exc, words: str) -> str:
    """Run ``fn``, which must raise ``exc`` with ``words`` in its message;
    returns the message. Any other outcome raises."""
    try:
        fn()
    except exc as e:
        if words not in str(e):
            raise
        return str(e)
    raise AssertionError(f"expected {exc.__name__} ({words!r})")


def zoo_run(smi: str, tmp: str, pipe: dict, corpus: dict) -> dict:
    """The rest of the generic zoo at the camelyon_medical_ssl widths on
    phase 16's 24 slides: (a) one epoch of ``cli/step3_generic.py`` per arch
    of ``ZOO_ARCHS``, each best checkpoint scored through ``cli/predict.py``
    on the card and on the CPU; (b) IBMIL's two phases and its clustering
    between them; (c) Step4 on a SPY slide of phase 15 with IBMIL and
    bmil_spvis, and lbmil refused; (d) a training step and an eval at 50000
    patches per arch, timed with CUDA events, with their device time and
    device events from ``torch.profiler``. None of these heads reaches a
    kernel (as in the JAX package): B1, B2 and B6 must count no launch over
    the phase. Returns the ``zoo`` line's object."""
    import cv2

    from acmil_tpu_torch.cli import (ibmil_clustering, predict,
                                     step3_generic, step3_ibmil,
                                     step4_heatmap)
    from acmil_tpu_torch.config import Config
    from acmil_tpu_torch.data.bags import pad_bag
    from acmil_tpu_torch.data.ptio import write_feature_pt
    from acmil_tpu_torch.engine import (checkpoint, create_train_state,
                                        make_eval_step, make_train_step)
    from acmil_tpu_torch.models import IBMIL, build_mil_model
    from acmil_tpu_torch.ops import attn_pool as ap
    from acmil_tpu_torch.ops.dsmil_pool import fused_dsmil_pool
    from acmil_tpu_torch.wsi.heatmap import render_level
    from acmil_tpu_torch.wsi.slide import clear_slide_cache, open_slide

    t_phase = time.perf_counter()
    root = os.path.join(tmp, "zoo")
    os.makedirs(root)
    subset = os.path.join(root, "cpu_subset.pt")
    write_feature_pt(subset, {n: corpus["slides"][n] for n in ZOO_CPU_SLIDES})
    counters = (ap.fused_gated_attn_pool_batched, ap.fused_gated_attn_pool_bwd,
                fused_dsmil_pool)
    for c in counters:
        c.launches = 0
    data = ["--data_dir", corpus["data_dir"]]
    res = {}

    def train(cli, tag, *args):
        ckpt_dir = os.path.join(root, f"ckpt_{tag}")
        log_dir = os.path.join(root, f"log_{tag}")
        t0 = time.perf_counter()
        cli.main(["--config", corpus["yml"], *data, "--ckpt_dir", ckpt_dir,
                  "--log_dir", log_dir, "--train_epoch", "1", "--device",
                  "cuda", *args])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        losses = _epoch_losses(log_dir)
        if len(losses) != 1 or not math.isfinite(losses[0]):
            raise AssertionError(f"{tag} epoch losses {losses}")
        return ckpt_dir, wall, losses[0]

    def score(tag, yml, ckpt_dir):
        """The subset through cli/predict.py on the card and on the CPU;
        (card seconds, max |card - CPU| probability)."""
        probs, secs = {}, {}
        for dev in ("cuda", "cpu"):
            t0 = time.perf_counter()
            out = predict.main(["--config", yml, "--ckpt", ckpt_dir,
                                "--features", subset, "--out_csv",
                                os.path.join(root, f"preds_{tag}_{dev}.csv"),
                                "--device", dev])
            secs[dev] = time.perf_counter() - t0
            _check_predictions(out, len(ZOO_CPU_SLIDES), 2)
            probs[dev] = np.asarray([r[2:4] for r in out["rows"]])
        err = float(np.abs(probs["cuda"] - probs["cpu"]).max())
        if not err <= ZOO_CPU_ATOL:
            raise AssertionError(f"{tag}: card vs CPU probabilities {err}")
        return secs["cuda"], err

    # (a) one epoch per arch, then predict on the card and on the CPU
    ckpts = {}
    for arch in ZOO_ARCHS:
        ckpts[arch], wall, loss = train(step3_generic, arch, "--arch", arch)
        ck = checkpoint.load(checkpoint.checkpoint_path(ckpts[arch], "best"))
        if ck["config"]["arch"] != arch:
            raise AssertionError(f"{arch}: checkpoint arch "
                                 f"{ck['config']['arch']}")
        predict_s, err = score(arch, corpus["yml"], ckpts[arch])
        res[arch] = {"train_s": wall, "loss": loss, "predict_s": predict_s,
                     "cpu_err": err}
        print(f"{arch}: cli/step3_generic.py 1 epoch x {N_TRAIN} steps on "
              f"{len(corpus['lengths'])} slides, {wall:.2f} s wall, loss "
              f"{loss:.6f}; cli/predict.py on {len(ZOO_CPU_SLIDES)} slides "
              f"{predict_s:.2f} s on the card, max |card - CPU| probability "
              f"{err:.3e} [{smi}]")

    # (b) IBMIL: phase 1, the clustering, phase 2
    ckpts["ibmil"], wall1, loss1 = train(step3_ibmil, "ibmil")
    t0 = time.perf_counter()
    npy = ibmil_clustering.main(["--config", corpus["yml"], *data,
                                 "--ckpt_dir", ckpts["ibmil"], "--k",
                                 str(IBMIL_K), "--out_dir",
                                 os.path.join(root, "deconf"), "--device",
                                 "cuda"])
    cluster_s = time.perf_counter() - t0
    protos = np.load(npy)
    if protos.shape != (IBMIL_K, D_INNER) or not np.isfinite(protos).all():
        raise AssertionError(f"IBMIL prototypes {protos.shape}")
    ckpts["ibmil_p2"], wall2, loss2 = train(step3_ibmil, "ibmil_p2",
                                            "--c_path", npy)
    ck2 = checkpoint.load(checkpoint.checkpoint_path(ckpts["ibmil_p2"],
                                                     "best"))
    head = IBMIL(2, D_FEAT, D_INNER, confounders=protos)
    head.load_state_dict(ck2["model"])
    d = corpus["slides"]["slide_01"]
    bag = pad_bag(d["feat"], d["coords"], d["label"],
                  dtype=np.float16).to("cuda")
    with torch.no_grad():
        deconf = head.cuda().eval()(bag.feats, bag.mask)["deconf_attn"]
    row_err = float((deconf.sum(-1) - 1).abs().max())
    if deconf.shape != (1, IBMIL_K) or row_err > 1e-5:
        raise AssertionError(f"deconf_attn {tuple(deconf.shape)}, rows sum "
                             f"to 1 within {row_err}")
    # the checkpoint's model keys hold no c_path: with the training YAML the
    # phase-2 weights do not load, as in the JAX package's scripts/predict.py
    refused = _raises(lambda: predict.main([
        "--config", corpus["yml"], "--ckpt", ckpts["ibmil_p2"], "--features",
        subset, "--out_csv", os.path.join(root, "refused.csv"), "--device",
        "cuda"]), RuntimeError, "W_q")
    yml2 = os.path.join(root, "ibmil_p2.yml")
    with open(corpus["yml"]) as src, open(yml2, "w") as dst:
        dst.write(src.read() + f"\nc_path: [{npy}]\n")
    for tag, yml, loss, wall in (("ibmil", corpus["yml"], loss1, wall1),
                                 ("ibmil_p2", yml2, loss2, wall2)):
        predict_s, err = score(tag, yml, ckpts[tag])
        res[tag] = {"train_s": wall, "loss": loss, "predict_s": predict_s,
                    "cpu_err": err}
    res["ibmil"]["cluster_s"] = cluster_s
    print(f"ibmil: cli/step3_ibmil.py phase 1 {wall1:.2f} s (loss "
          f"{loss1:.6f}); cli/ibmil_clustering.py k={IBMIL_K} on the card "
          f"{cluster_s:.2f} s -> {protos.shape}; phase 2 --c_path "
          f"{wall2:.2f} s (loss {loss2:.6f}), deconf_attn rows sum to 1 "
          f"within {row_err:.1e}; cli/predict.py with the training YAML "
          f"refuses the phase-2 checkpoint ({refused.splitlines()[0][:80]}"
          f"...), and with c_path in the YAML scores it, max |card - CPU| "
          f"{res['ibmil_p2']['cpu_err']:.3e} (phase 1 "
          f"{res['ibmil']['cpu_err']:.3e}) [{smi}]")

    # (c) Step4 on a SPY slide of phase 15: IBMIL and bmil_spvis render,
    # lbmil has no attention
    names = pipe["names"]
    split_dir = os.path.join(root, "splits4")
    _write_split(split_dir, names[:-1], [], names[-1:])
    yml4 = _yml_with(root, "step4.yml", split_dir=split_dir,
                     data_dir=os.path.dirname(pipe["feat_path"]))
    slide = open_slide(os.path.join(pipe["slide_dir"], f"{names[-1]}.spy"))
    lw, lh = slide.level_dimensions[render_level(slide)]
    for arch in ("ibmil", "bmil_spvis"):
        clear_slide_cache()
        heat = step4_heatmap.main([
            "--config", yml4, "--ckpt_dir", ckpts[arch], "--slide_dir",
            pipe["slide_dir"], "--output_dir", os.path.join(root, f"heat_{arch}"),
            "--patch_size", str(PIPE_PATCH), "--device", "cuda"])
        r = heat["slides"].get(names[-1])
        img = None if r is None else cv2.imread(r["path"])
        if img is None or img.shape != (lh, lw, 3) or img.std() < 5 \
                or not np.isfinite(r["scores"]).all():
            raise AssertionError(f"Step4 with {arch}: "
                                 f"{None if img is None else img.shape} "
                                 f"against level {(lh, lw)}")
        print(f"{arch} Step4: cli/step4_heatmap.py rendered {names[-1]}.spy "
              f"at {img.shape[1]}x{img.shape[0]} (pixel std "
              f"{img.std():.1f}; attention {r['attn_ms']:.2f} ms, render "
              f"{r['render_ms']:.1f} ms) [{smi}]")
    _raises(lambda: step4_heatmap.main([
        "--config", yml4, "--ckpt_dir", ckpts["lbmil"], "--slide_dir",
        pipe["slide_dir"], "--output_dir", os.path.join(root, "heat_lbmil"),
        "--patch_size", str(PIPE_PATCH), "--device", "cuda"]),
        ValueError, "model emits no attention")

    # (d) a training step and an eval at 50000 patches (bucket 65536)
    for arch in ZOO_ARCHS + ("ibmil", "ibmil_p2"):
        keys = {"arch": arch}
        if arch.startswith("ibmil"):
            keys = {"arch": "ibmil", "c_path": [npy] if arch == "ibmil_p2"
                    else None}
        conf = Config.from_yaml(YML, keys)
        model, family = build_mil_model(conf)
        model.cuda()
        state = create_train_state(model, conf, 1)
        step = make_train_step(model, conf, family)
        eval_step = make_eval_step(model, family)
        step(state, bag)
        eval_step(bag)
        r = res[arch]
        r["step_ms"] = _event_ms(lambda: step(state, bag), 10)
        r["step_device_ms"], r["step_launches"] = _device_profile(
            lambda: step(state, bag), 5)
        r["eval_ms"] = _event_ms(lambda: eval_step(bag), 10)
        r["eval_device_ms"], r["eval_launches"] = _device_profile(
            lambda: eval_step(bag), 5)
        print(f"{arch} at {len(d['feat'])} patches (bucket "
              f"{bag.feats.shape[1]}): training step {r['step_ms']:.4f} ms "
              f"(CUDA events, median of 10), {_fmt_ms(r['step_device_ms'])} "
              f"of device time in {r['step_launches']} device events; eval "
              f"{r['eval_ms']:.4f} ms, {_fmt_ms(r['eval_device_ms'])} in "
              f"{r['eval_launches']} device events [{smi}]")
    launched = {c.__name__: c.launches for c in counters}
    if any(launched.values()):
        raise AssertionError(f"the zoo's path launched kernels {launched}")
    print(f"zoo phase wall {time.perf_counter() - t_phase:.2f} s [{smi}]")
    return {"archs": res, "kernel_launches": launched,
            "bag_patches": len(d["feat"]), "bucket": int(bag.feats.shape[1])}


def transmil_mhim_run(smi: str, tmp: str, pipe: dict, corpus: dict) -> dict:
    """TransMIL and MHIM on phase 16's 24 slides: (a) one epoch of
    ``cli/step3_generic.py --arch transmil``, its best checkpoint scored card
    against CPU, in bf16 against f32, and refused by Step4; (b) MHIM's two
    stages through ``cli/step3_mhim.py`` for each baseline, each best
    checkpoint scored card against CPU, the teacher moved, the student's
    masks at step 0 on a 50000-patch bag held to the ranks; (c) a step and
    an eval at 50000 patches per head, timed, with device time, device
    events and the step's peak memory. None of these heads reaches a kernel:
    B1, B2 and B6 must count no launch over the phase. Returns the phase's
    numbers: ``archs`` joins the ``zoo`` line's archs, the rest goes under
    its ``transmil_mhim``."""
    from acmil_tpu_torch.cli import predict, step3_generic, step3_mhim
    from acmil_tpu_torch.cli import step4_heatmap
    from acmil_tpu_torch.config import Config
    from acmil_tpu_torch.data.bags import pad_bag
    from acmil_tpu_torch.data.ptio import write_feature_pt
    from acmil_tpu_torch.engine import (checkpoint, create_train_state,
                                        make_eval_step, make_train_step)
    from acmil_tpu_torch.models import build_mil_model
    from acmil_tpu_torch.models.mhim import _rank
    from acmil_tpu_torch.ops import attn_pool as ap
    from acmil_tpu_torch.ops.dsmil_pool import fused_dsmil_pool

    t_phase = time.perf_counter()
    root = os.path.join(tmp, "transmil_mhim")
    os.makedirs(root)
    subset = os.path.join(root, "cpu_subset.pt")
    write_feature_pt(subset, {n: corpus["slides"][n] for n in TM_CPU_SLIDES})
    counters = (ap.fused_gated_attn_pool_batched, ap.fused_gated_attn_pool_bwd,
                fused_dsmil_pool)
    for c in counters:
        c.launches = 0
    data = ["--data_dir", corpus["data_dir"]]
    res, out = {}, {}

    def train(cli, tag, *args):
        ckpt_dir = os.path.join(root, f"ckpt_{tag}")
        log_dir = os.path.join(root, f"log_{tag}")
        t0 = time.perf_counter()
        cli.main(["--config", corpus["yml"], *data, "--ckpt_dir", ckpt_dir,
                  "--log_dir", log_dir, "--train_epoch", "1", "--device",
                  "cuda", *args])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        losses = _epoch_losses(log_dir)
        if len(losses) != 1 or not math.isfinite(losses[0]):
            raise AssertionError(f"{tag} epoch losses {losses}")
        return ckpt_dir, {"train_s": wall, "loss": losses[0]}

    def score(tag, yml, ckpt_dir, devices=("cuda", "cpu")):
        """TM_CPU_SLIDES through cli/predict.py on each device; (card
        seconds, probabilities per device)."""
        probs, secs = {}, {}
        for dev in devices:
            t0 = time.perf_counter()
            res_ = predict.main(["--config", yml, "--ckpt", ckpt_dir,
                                 "--features", subset, "--out_csv",
                                 os.path.join(root, f"preds_{tag}_{dev}.csv"),
                                 "--device", dev])
            secs[dev] = time.perf_counter() - t0
            _check_predictions(res_, len(TM_CPU_SLIDES), 2)
            probs[dev] = np.asarray([r[2:4] for r in res_["rows"]])
        return secs["cuda"], probs

    def card_vs_cpu(tag, yml, ckpt_dir):
        predict_s, probs = score(tag, yml, ckpt_dir)
        err = float(np.abs(probs["cuda"] - probs["cpu"]).max())
        if not err <= ZOO_CPU_ATOL:
            raise AssertionError(f"{tag}: card vs CPU probabilities {err}")
        return {"predict_s": predict_s, "cpu_err": err}

    # (a) TransMIL: one epoch, predict card vs CPU, bf16, Step4 refuses
    ckpt, res["transmil"] = train(step3_generic, "transmil", "--arch",
                                  "transmil")
    res["transmil"].update(card_vs_cpu("transmil", corpus["yml"], ckpt))
    bf16_yml = _yml_with(root, "bf16.yml", compute_dtype="bfloat16")
    _, p16 = score("transmil_bf16", bf16_yml, ckpt, ("cuda",))
    _, p32 = score("transmil_f32", corpus["yml"], ckpt, ("cuda",))
    bf16_err = float(np.abs(p16["cuda"] - p32["cuda"]).max())
    if not bf16_err <= TRANSMIL_BF16_ATOL:
        raise AssertionError(f"transmil bf16 vs f32 probabilities {bf16_err}")
    out["transmil_bf16_err"] = bf16_err
    names = pipe["names"]
    split_dir = os.path.join(root, "splits4")
    _write_split(split_dir, names[:-1], [], names[-1:])
    yml4 = _yml_with(root, "step4.yml", split_dir=split_dir,
                     data_dir=os.path.dirname(pipe["feat_path"]))
    _raises(lambda: step4_heatmap.main([
        "--config", yml4, "--ckpt_dir", ckpt, "--slide_dir",
        pipe["slide_dir"], "--output_dir", os.path.join(root, "heat"),
        "--patch_size", str(PIPE_PATCH), "--device", "cuda"]),
        ValueError, "model emits no attention")
    r = res["transmil"]
    print(f"transmil: cli/step3_generic.py 1 epoch x {N_TRAIN} steps, "
          f"{r['train_s']:.2f} s wall, loss {r['loss']:.6f}; cli/predict.py "
          f"on {len(TM_CPU_SLIDES)} slides {r['predict_s']:.2f} s on the "
          f"card, max |card - CPU| probability {r['cpu_err']:.3e}; bf16 eval "
          f"max |bf16 - f32| probability {bf16_err:.3e}; Step4 refuses it "
          f"[{smi}]")

    # (b) MHIM: pure, then mhim with the pure run as teacher, per baseline
    for baseline in ("selfattn", "attn"):
        yml = _yml_with(root, f"{baseline}.yml", baseline=baseline)
        common = ["--baseline", baseline]
        pure_ckpt, pure_r = train(step3_mhim, f"pure_{baseline}", *common,
                                  "--model", "pure")
        mhim_ckpt, mhim_r = train(step3_mhim, f"mhim_{baseline}", *common,
                                  "--model", "mhim", "--teacher_init",
                                  pure_ckpt, "--init_stu_type", "fc",
                                  *MHIM_STAGE_B)
        start = checkpoint.load(checkpoint.checkpoint_path(pure_ckpt, "best"))
        last = checkpoint.load(checkpoint.checkpoint_path(mhim_ckpt, "last"))
        moved = {k: float((last["teacher"][k] - v).abs().max())
                 for k, v in start["model"].items()}
        apart = {k: float((last["teacher"][k] - v).abs().max())
                 for k, v in last["model"].items()}
        if not max(moved.values()) > 0 or not max(apart.values()) > 0:
            raise AssertionError(f"mhim {baseline}: teacher moved "
                                 f"{max(moved.values())}, apart from the "
                                 f"student {max(apart.values())}")
        for tag, ck, r in ((f"pure_{baseline}", pure_ckpt, pure_r),
                           (f"mhim_{baseline}", mhim_ckpt, mhim_r)):
            r.update(card_vs_cpu(tag, yml, ck))
            res[tag] = r
        mhim_r["teacher_max_move"] = max(moved.values())
        mhim_r["teacher_student_max_diff"] = max(apart.values())
        print(f"mhim {baseline}: cli/step3_mhim.py --model pure 1 epoch "
              f"{pure_r['train_s']:.2f} s (loss {pure_r['loss']:.6f}), then "
              f"--model mhim --teacher_init --init_stu_type fc "
              f"{' '.join(MHIM_STAGE_B)} 1 epoch {mhim_r['train_s']:.2f} s "
              f"(loss {mhim_r['loss']:.6f}); teacher moved up to "
              f"{mhim_r['teacher_max_move']:.3e} off the pure weights and "
              f"differs from the student by up to "
              f"{mhim_r['teacher_student_max_diff']:.3e}; cli/predict.py max "
              f"|card - CPU| probability pure {pure_r['cpu_err']:.3e}, mhim "
              f"{mhim_r['cpu_err']:.3e} [{smi}]")

    # the student's masks at step 0 on one 50000-patch bag
    d = corpus["slides"]["slide_01"]
    bag = pad_bag(d["feat"], d["coords"], d["label"],
                  dtype=np.float16).to("cuda")
    n_valid = int(bag.mask.sum())
    mhim_conf = dict(arch="mhim", mask_ratio_h=0.1, mask_ratio_hr=0.5,
                     mm_sche=True, mrh_sche=True, steps_per_epoch=N_TRAIN)
    conf = Config.from_yaml(YML, mhim_conf)
    model, family = build_mil_model(conf)
    model.cuda()
    state = create_train_state(model, conf, N_TRAIN, family=family)
    mrh = torch.tensor(np.float32(0.1), device="cuda")
    with torch.no_grad():
        tea = state.teacher(bag.feats, bag.mask, return_attn=True)
        keep = model.train()(bag.feats, bag.mask, deterministic=False,
                             teacher_attn=tea["attn"], mask_ratio_h=mrh,
                             generator=state.generator)["keep"]
    dropped = bag.mask & ~keep
    ranks = _rank(tea["attn"], bag.mask, largest=True)
    want_keep = n_valid - math.ceil(n_valid * 0.1)
    top = math.ceil(n_valid * 0.2)
    if int(keep.sum()) != want_keep or not bool(
            (ranks[dropped] < top).all()) or bool((keep & ~bag.mask).any()):
        raise AssertionError(f"mhim masks: kept {int(keep.sum())} of "
                             f"{n_valid} (want {want_keep}), dropped ranks "
                             f"up to {int(ranks[dropped].max())}")
    out["mask_check"] = {"valid": n_valid, "kept": int(keep.sum()),
                         "dropped_max_rank": int(ranks[dropped].max()),
                         "top": top}
    print(f"mhim masks at step 0 on a {n_valid}-patch bag (mrh 0.1, hr "
          f"0.5): the student keeps {int(keep.sum())} = {n_valid} - "
          f"ceil({n_valid} x 0.1); every dropped patch ranks below {top} of "
          f"the teacher's attention (worst rank "
          f"{out['mask_check']['dropped_max_rank']}) [{smi}]")

    # (c) a training step and an eval at 50000 patches (bucket 65536)
    heads = {"transmil": {"arch": "transmil"},
             "pure_selfattn": {"arch": "pure"}, "mhim_selfattn": mhim_conf,
             "mhim_attn": dict(mhim_conf, baseline="attn")}
    for tag, keys in heads.items():
        conf = Config.from_yaml(YML, keys)
        model, family = build_mil_model(conf)
        model.cuda()
        state = create_train_state(model, conf, N_TRAIN, family=family)
        step = make_train_step(model, conf, family)
        eval_step = make_eval_step(model, family)
        step(state, bag)
        eval_step(bag)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step(state, bag)
        torch.cuda.synchronize()
        r = res.setdefault(tag, {})
        r["step_peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        r["step_ms"] = _event_ms(lambda: step(state, bag), 10)
        r["step_device_ms"], r["step_launches"] = _device_profile(
            lambda: step(state, bag), 5)
        r["step_top"] = _top_kernels(lambda: step(state, bag))
        r["eval_ms"] = _event_ms(lambda: eval_step(bag), 10)
        r["eval_device_ms"], r["eval_launches"] = _device_profile(
            lambda: eval_step(bag), 5)
        print(f"{tag} at {n_valid} patches (bucket {bag.feats.shape[1]}): "
              f"training step {r['step_ms']:.4f} ms (CUDA events, median of "
              f"10), {_fmt_ms(r['step_device_ms'])} of device time in "
              f"{r['step_launches']} device events, peak "
              f"{r['step_peak_gib']:.3f} GiB allocated; eval "
              f"{r['eval_ms']:.4f} ms, {_fmt_ms(r['eval_device_ms'])} in "
              f"{r['eval_launches']} device events; the step's largest "
              f"device events: {_fmt_split(r['step_top'])} [{smi}]")
        del model, state, step, eval_step
    launched = {c.__name__: c.launches for c in counters}
    if any(launched.values()):
        raise AssertionError(f"TransMIL/MHIM launched kernels {launched}")
    out["kernel_launches"] = launched
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"transmil/mhim phase wall {out['wall_s']:.2f} s [{smi}]")
    return {"archs": res, **out}


class _Selections:
    """DTFD's distillation choices (``models/dtfd.py::first_k``) recorded on
    one run and replayed on a second, so that two devices or routes are
    compared on the same distilled instances. CAM probabilities near 0.5
    tie within an ulp or two, and the devices' exp and sums round apart, so
    their own top-k may pick another member of a tie: each choice the
    replayed run would have made otherwise must score within
    ``DTFD_TIE_ATOL`` of the recorded one, on both runs' scores."""

    def __init__(self):
        from acmil_tpu_torch.models import dtfd

        self.dtfd, self.real = dtfd, dtfd.first_k
        self.calls, self.flips, self.worst_gap = [], 0, 0.0

    def record(self):
        def rec(score, k):
            idx = self.real(score, k)
            self.calls.append((score.detach().cpu(), idx.cpu()))
            return idx
        self.dtfd.first_k = rec
        return self

    def replay(self):
        it = iter(self.calls)

        def rep(score, k):
            s0, idx0 = next(it)
            s1, own = score.detach().cpu(), self.real(score, k).cpu()
            differ = own != idx0
            if differ.any():
                gap = max(float((s.gather(-1, own) - s.gather(-1, idx0)
                                 ).abs()[differ].max()) for s in (s0, s1))
                if not gap <= DTFD_TIE_ATOL:
                    raise AssertionError(f"dtfd: the runs distil other "
                                         f"instances, {gap:.3e} apart")
                self.flips += int(differ.sum())
                self.worst_gap = max(self.worst_gap, gap)
            return idx0.to(score.device)
        self.dtfd.first_k = rep
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.dtfd.first_k = self.real


def _dtfd_train(smi: str, root: str, corpus: dict) -> dict:
    """(a) one epoch of ``cli/step3_dtfd.py`` at camelyon_medical_ssl on
    phase 16's corpus, the best checkpoint scored card against CPU, then one
    epoch at natural_supervised (L = 256); B1/B2 counted over each."""
    from acmil_tpu_torch.cli import predict, step3_dtfd
    from acmil_tpu_torch.data.ptio import write_feature_pt
    from acmil_tpu_torch.ops import attn_pool as ap

    b1, b2 = ap.fused_gated_attn_pool_batched, ap.fused_gated_attn_pool_bwd
    evals = N_VAL + N_TEST

    def train(tag, yml, data_dir, n_train, n_evals):
        ckpt_dir = os.path.join(root, f"ckpt_{tag}")
        log_dir = os.path.join(root, f"log_{tag}")
        b1.launches = b2.launches = 0
        t0 = time.perf_counter()
        step3_dtfd.main(["--config", yml, "--data_dir", data_dir,
                         "--ckpt_dir", ckpt_dir, "--log_dir", log_dir,
                         "--train_epoch", "1", "--device", "cuda"])
        torch.cuda.synchronize()
        r = {"train_s": time.perf_counter() - t0, "B1": b1.launches,
             "B2": b2.launches}
        with open(os.path.join(log_dir, "metrics.jsonl")) as f:
            rows = [x for x in map(json.loads, f) if "_config" not in x]
        if len(rows) != 1 or not all(math.isfinite(rows[0][f"train/{k}"])
                                     for k in ("loss", "loss0", "loss1")):
            raise AssertionError(f"dtfd {tag} epoch rows {rows}")
        r.update(loss0=rows[0]["train/loss0"], loss1=rows[0]["train/loss1"])
        if (r["B1"], r["B2"]) != (n_train + n_evals, n_train):
            raise AssertionError(f"dtfd {tag}: B1/B2 launched {r['B1']}/"
                                 f"{r['B2']}, want {n_train + n_evals}/"
                                 f"{n_train}")
        return ckpt_dir, r

    ckpt, res = train("medical_ssl", corpus["yml"], corpus["data_dir"],
                      N_TRAIN, evals)
    subset = os.path.join(root, "cpu_subset.pt")
    write_feature_pt(subset, {n: corpus["slides"][n] for n in ZOO_CPU_SLIDES})
    probs = {}
    with _Selections() as sel:
        for tag, dev in (("card", "cuda"), ("cpu", "cpu")):
            (sel.record() if tag == "card" else sel.replay())
            b1.launches = 0
            t0 = time.perf_counter()
            scored = predict.main(["--config", corpus["yml"], "--ckpt", ckpt,
                                   "--features", subset, "--out_csv",
                                   os.path.join(root, f"preds_{tag}.csv"),
                                   "--device", dev])
            res[f"predict_{tag}_s"] = time.perf_counter() - t0
            _check_predictions(scored, len(ZOO_CPU_SLIDES), 2)
            probs[tag] = np.asarray([r[2:4] for r in scored["rows"]])
            res[f"B1_predict_{tag}"] = b1.launches
    res["cpu_flips"], res["cpu_flip_gap"] = sel.flips, sel.worst_gap
    if (res["B1_predict_card"], res["B1_predict_cpu"]) != (
            len(ZOO_CPU_SLIDES), 0):
        raise AssertionError(f"dtfd predict launched B1 "
                             f"{res['B1_predict_card']} on the card, "
                             f"{res['B1_predict_cpu']} on the CPU")
    res["cpu_err"] = float(np.abs(probs["card"] - probs["cpu"]).max())
    if not res["cpu_err"] <= DTFD_CPU_ATOL:
        raise AssertionError(f"dtfd card vs CPU probabilities "
                             f"{res['cpu_err']}")
    print(f"dtfd (camelyon_medical_ssl, numGroup 4, MaxMinS): "
          f"cli/step3_dtfd.py 1 epoch x {N_TRAIN} steps, "
          f"{res['train_s']:.2f} s wall, loss0 {res['loss0']:.6f} loss1 "
          f"{res['loss1']:.6f}; B1 {res['B1']} B2 {res['B2']}; cli/predict.py "
          f"on {len(ZOO_CPU_SLIDES)} slides {res['predict_card_s']:.2f} s on "
          f"the card (B1 {res['B1_predict_card']}), max |card - CPU| probability "
          f"{res['cpu_err']:.3e} on the card's distilled instances (the "
          f"CPU's own top-k differs in {res['cpu_flips']} choices, ties "
          f"within {res['cpu_flip_gap']:.3e}) [{smi}]")

    rs = np.random.default_rng(SEED + 20)
    n_train, n_val, n_test = WIDE_TRAIN
    lengths = [1000, 50000] + rs.integers(
        1000, 50001, n_train + n_val + n_test - 2).tolist()
    slides = _synthetic_slides(rs, lengths, WIDE_DIMS[0][0])
    wide_root = os.path.join(root, "natural_supervised")
    data_dir, _, yml = _write_split_corpus(wide_root, slides, WIDE_YML,
                                           "natural_supervised", n_train,
                                           n_val)
    _, wide = train("natural_supervised", yml, data_dir, n_train,
                    n_val + n_test)
    print(f"dtfd (natural_supervised, L={WIDE_DIMS[0][1]}): 1 epoch x "
          f"{n_train} steps, {wide['train_s']:.2f} s wall, loss0 "
          f"{wide['loss0']:.6f} loss1 {wide['loss1']:.6f}; B1 {wide['B1']} "
          f"B2 {wide['B2']} [{smi}]")
    res["natural_supervised"] = wide
    return res


def _dtfd_routes(smi: str, corpus: dict) -> dict:
    """(b) fused against plain DTFD on one 50000-patch bag: one step's
    losses and gradients, five clipped Adam steps, then the step and the
    eval timed per route, the step's peak memory, and B1's and B2's device
    time at DTFD's call shape split by kernel."""
    from acmil_tpu_torch.config import Config
    from acmil_tpu_torch.data.bags import pad_bag
    from acmil_tpu_torch.engine import (create_train_state, get_family,
                                        make_eval_step, make_train_step)
    from acmil_tpu_torch.models import build_mil_model
    from acmil_tpu_torch.ops import attn_pool as ap

    b1, b2 = ap.fused_gated_attn_pool_batched, ap.fused_gated_attn_pool_bwd
    conf_of = lambda fused: Config.from_yaml(YML, {"arch": "dtfd",
                                                   "fused_train": fused})
    model0, family = build_mil_model(conf_of(True))
    fam = get_family(family)
    bags = [pad_bag(d["feat"], d["coords"], d["label"],
                    dtype=np.float16).to("cuda")
            for d in (corpus["slides"][n] for n in DTFD_ROUTE_SLIDES)]
    bag = bags[0]
    n_valid = int(bag.mask.sum())
    u = torch.rand(bag.mask.shape, device="cuda",
                   generator=torch.Generator("cuda").manual_seed(SEED))
    one = {}
    # the plain route first: the fused route replays its distilled instances
    with _Selections() as sel:
        for fused in (False, True):
            (sel.replay() if fused else sel.record())
            model = copy.deepcopy(model0).cuda()
            conf_d = fam.conf_dict(conf_of(fused))
            b1.launches = b2.launches = 0
            out = fam.train_outputs(model.train(), bag, conf_d, stkim_u=u)
            loss, parts = fam.loss(out, bag, bag.mask.any(dim=1), conf_d)
            loss.backward()
            if (b1.launches, b2.launches) != ((1, 1) if fused else (0, 0)):
                raise AssertionError(f"dtfd route fused={fused}: B1/B2 "
                                     f"launched {b1.launches}/{b2.launches}")
            one[fused] = ({k: float(v.detach()) for k, v in parts.items()},
                          {n: p.grad for n, p in model.named_parameters()})
    flips = sel.flips
    (l_f, g_f), (l_p, g_p) = one[True], one[False]
    for k in l_p:
        if not abs(l_f[k] - l_p[k]) <= STEP_LOSS_RTOL * abs(l_p[k]):
            raise AssertionError(f"dtfd one step {k}: fused {l_f[k]} plain "
                                 f"{l_p[k]}")
    # each attention's output bias has a 0 gradient in exact arithmetic (a
    # softmax ignores a shift): held to its output weight's scale, as CLAM's
    for n in g_p:
        scale = g_p[n.replace("weights.bias", "weights.weight")]
        err = float((g_f[n] - g_p[n]).abs().max())
        if not err <= STEP_GRAD_REL * float(scale.abs().max()) + STEP_GRAD_ATOL:
            raise AssertionError(f"dtfd: gradient of {n} differs by {err:.3e}")
    worst = max(_rel_to_max(g_f[n], g_p[n]) for n in g_p
                if not n.endswith("weights.bias"))
    losses = {}
    with _Selections() as sel:
        for fused in (False, True):
            (sel.replay() if fused else sel.record())
            model = copy.deepcopy(model0).cuda()
            conf = conf_of(fused)
            state = create_train_state(model, conf, len(bags), family=family)
            step = make_train_step(model, conf, family)
            losses[fused] = [float(step(state, bags[i % len(bags)])["loss"])
                             for i in range(5)]
    flips += sel.flips
    adam = max(abs(a - b) / abs(b) for a, b in zip(losses[True],
                                                   losses[False]))
    if not adam <= ADAM_LOSS_RTOL:
        raise AssertionError(f"dtfd clipped Adam losses {losses}")
    r = {"one_step": {"fused": l_f, "plain": l_p, "worst_grad_rel": worst},
         "adam_worst_rel": adam, "patches": n_valid, "flips": flips,
         "bucket": int(bag.feats.shape[1])}
    print(f"dtfd fused vs plain at {n_valid} patches (bucket "
          f"{r['bucket']}, 4 groups of {r['bucket'] // 4}): one step loss0 "
          f"{l_f['loss0']:.7f} / {l_p['loss0']:.7f}, loss1 "
          f"{l_f['loss1']:.7f} / {l_p['loss1']:.7f}; worst gradient "
          f"difference {worst:.3e} of its max; five clipped Adam steps, "
          f"worst relative loss difference {adam:.3e}; on the plain route's "
          f"distilled instances (the fused route's own top-k differs in "
          f"{flips} choices, ties within {DTFD_TIE_ATOL}) [{smi}]")

    for fused in (True, False):
        tag = "fused" if fused else "plain"
        model = copy.deepcopy(model0).cuda()
        conf = conf_of(fused)
        state = create_train_state(model, conf, len(bags), family=family)
        step = make_train_step(model, conf, family)
        eval_step = make_eval_step(model, family, fused=fused)
        step(state, bag)
        eval_step(bag)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step(state, bag)
        torch.cuda.synchronize()
        t = {"step_peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
             "step_ms": _event_ms(lambda: step(state, bag), 10),
             "eval_ms": _event_ms(lambda: eval_step(bag), 10)}
        t["step_device_ms"], t["step_events"] = _device_profile(
            lambda: step(state, bag), 5)
        t["eval_device_ms"], t["eval_events"] = _device_profile(
            lambda: eval_step(bag), 5)
        t["step_top"] = _top_kernels(lambda: step(state, bag))
        r[tag] = t
        print(f"dtfd {tag} at {n_valid} patches: training step "
              f"{t['step_ms']:.4f} ms (CUDA events, median of 10), "
              f"{_fmt_ms(t['step_device_ms'])} of device time in "
              f"{t['step_events']} device events, peak "
              f"{t['step_peak_gib']:.3f} GiB allocated; eval "
              f"{t['eval_ms']:.4f} ms, {_fmt_ms(t['eval_device_ms'])} in "
              f"{t['eval_events']} device events; the step's largest device "
              f"events: {_fmt_split(t['step_top'])} [{smi}]")

    # B1 and B2 alone at DTFD's call: the gathered mid [B·G, S, L] f32,
    # W1 = I, b1 = 0, K = 1
    model = model0.cuda()
    with torch.no_grad():
        gfeat, gmask = model.pseudo_bags(bag.feats, bag.mask, False, u)
        x = gfeat.reshape(-1, *gfeat.shape[2:]).contiguous()
    m = gmask.reshape(x.shape[:2])
    att = model.attention
    ldim = x.shape[-1]
    ws = [torch.eye(ldim, device="cuda"), torch.zeros(ldim, device="cuda"),
          att.attention_V[0].weight.t().contiguous(),
          att.attention_V[0].bias.detach(),
          att.attention_U[0].weight.t().contiguous(),
          att.attention_U[0].bias.detach(),
          att.attention_weights.weight.t().contiguous(),
          att.attention_weights.bias.detach()]
    ws = [w.detach() for w in ws]
    gen = torch.Generator("cuda").manual_seed(SEED)
    lse, c, d_bag, d_logits = _bwd_inputs(ap, gen, ws, x, m, 1)
    calls = {"B1": (ap.B1_KERNELS, lambda: b1(x, m, *ws)),
             "B2": (ap.B2_KERNELS, lambda: b2(x, m, *ws, lse, c, d_bag,
                                               d_logits, True))}
    n_rows = x.shape[0] * x.shape[1]
    bounds = {"B1": _b1_bound(n_rows, 1, ldim, ldim),
              "B2": _b2_bound(n_rows, 1, ldim, ldim)}
    for name, (kernels, fn) in calls.items():
        per = _split_ms(kernels, fn)
        total = sum(per.values())
        h = sum(v for k, v in per.items() if k in ap.H_STAGE_KERNELS)
        r[f"{name}_call"] = {"ms": _time_ms(fn), "device_ms": total,
                             "by_kernel": per,
                             "h_stage_share": h / total if total else None,
                             "shape": list(x.shape), **bounds[name]}
        print(f"{name} at DTFD's call (x {list(x.shape)} f32, W1 = I, K = 1, "
              f"{int(m.sum())} valid rows): {r[name + '_call']['ms']:.4f} ms "
              f"call, {total:.4f} ms device: {_fmt_split(per)}; the H stage "
              f"{100 * h / max(total, 1e-12):.1f}%; bound "
              f"{bounds[name]['bound_ms']:.4f} ms ({bounds[name]['bound_by']}) "
              f"[{smi}]")
    return r


def _sam_run(smi: str, root: str, corpus: dict) -> dict:
    """(c) one epoch of ``cli/step3_acmil.py`` with ``use_sam: true``
    (B1 and B2 twice a train step), one SAM step on a 50000-patch bag card
    against CPU, and the SAM step timed against the plain step."""
    from acmil_tpu_torch.cli import step3_acmil
    from acmil_tpu_torch.config import Config
    from acmil_tpu_torch.data.bags import pad_bag
    from acmil_tpu_torch.engine import create_train_state, make_train_step
    from acmil_tpu_torch.models import build_mil_model
    from acmil_tpu_torch.ops import attn_pool as ap

    b1, b2 = ap.fused_gated_attn_pool_batched, ap.fused_gated_attn_pool_bwd
    yml = os.path.join(root, "sam.yml")
    with open(corpus["yml"]) as src, open(yml, "w") as dst:
        dst.write(src.read() + "\nuse_sam: true\n")
    log_dir = os.path.join(root, "log_sam")
    b1.launches = b2.launches = 0
    t0 = time.perf_counter()
    step3_acmil.main(["--config", yml, "--data_dir", corpus["data_dir"],
                      "--ckpt_dir", os.path.join(root, "ckpt_sam"),
                      "--log_dir", log_dir, "--train_epoch", "1",
                      "--n_token", str(N_TOKEN), "--n_masked_patch",
                      str(N_MASKED_PATCH), "--mask_drop", str(MASK_DROP),
                      "--device", "cuda"])
    torch.cuda.synchronize()
    r = {"train_s": time.perf_counter() - t0, "B1": b1.launches,
         "B2": b2.launches}
    losses = _epoch_losses(log_dir)
    if len(losses) != 1 or not math.isfinite(losses[0]):
        raise AssertionError(f"sam epoch losses {losses}")
    if (r["B1"], r["B2"]) != (2 * N_TRAIN + N_VAL + N_TEST, 2 * N_TRAIN):
        raise AssertionError(f"sam: B1/B2 launched {r['B1']}/{r['B2']}")
    r["loss"] = losses[0]

    keys = {"arch": "ga", "n_token": N_TOKEN, "n_masked_patch":
            N_MASKED_PATCH, "mask_drop": MASK_DROP}
    d = corpus["slides"]["slide_01"]
    model0, family = build_mil_model(Config.from_yaml(YML, keys))
    bag = pad_bag(d["feat"], d["coords"], d["label"], dtype=np.float16)
    u = torch.rand(1, N_TOKEN, bag.feats.shape[1],
                   generator=torch.Generator().manual_seed(SEED))
    got = {}
    for tag, dev in (("card", "cuda"), ("cpu", "cpu")):
        conf = Config.from_yaml(YML, {**keys, "use_sam": True})
        model = copy.deepcopy(model0).to(dev)
        bag = bag.to(dev)
        state = create_train_state(model, conf, N_TRAIN, family=family)
        aux = make_train_step(model, conf, family)(state, bag,
                                                   stkim_u=u.to(dev))
        got[tag] = ({k: float(v) for k, v in aux.items()},
                    {n: p.detach().cpu() for n, p in model.named_parameters()})
    (a_c, p_c), (a_h, p_h) = got["card"], got["cpu"]
    for k in a_h:
        if not abs(a_c[k] - a_h[k]) <= SAM_CPU_RTOL * abs(a_h[k]):
            raise AssertionError(f"sam step {k}: card {a_c[k]} CPU {a_h[k]}")
    lr = Config.from_yaml(YML, keys).lr
    moved = max(float((p_c[n] - p_h[n]).abs().max()) for n in p_h)
    if not moved <= lr:
        raise AssertionError(f"sam step: parameters apart by {moved}")
    r.update(step_card=a_c, step_cpu=a_h, params_max_diff=moved)

    bag = bag.to("cuda")
    ug = u.cuda()
    for sam in (True, False):
        conf = Config.from_yaml(YML, {**keys, "use_sam": sam})
        model = copy.deepcopy(model0).cuda()
        state = create_train_state(model, conf, N_TRAIN, family=family)
        step = make_train_step(model, conf, family)
        step(state, bag, stkim_u=ug)
        tag = "sam" if sam else "plain"
        r[f"{tag}_step_ms"] = _event_ms(lambda: step(state, bag, stkim_u=ug),
                                        10)
        r[f"{tag}_step_device_ms"], r[f"{tag}_step_events"] = \
            _device_profile(lambda: step(state, bag, stkim_u=ug), 5)
    print(f"sam (ACMIL_GA, rho 0.05): cli/step3_acmil.py 1 epoch x {N_TRAIN} "
          f"steps, {r['train_s']:.2f} s wall, loss {r['loss']:.6f}; B1 "
          f"{r['B1']} B2 {r['B2']}; one step at 50000 patches card vs CPU: "
          f"loss {a_c['loss']:.7f} / {a_h['loss']:.7f}, grad_norm "
          f"{a_c['grad_norm']:.6f} / {a_h['grad_norm']:.6f}, parameters "
          f"apart by {moved:.3e}; step {r['sam_step_ms']:.4f} ms with SAM "
          f"({_fmt_ms(r['sam_step_device_ms'])} device), "
          f"{r['plain_step_ms']:.4f} ms without "
          f"({_fmt_ms(r['plain_step_device_ms'])}) [{smi}]")
    return r


def _resnet_step2(smi: str, root: str, pipe: dict) -> dict:
    """(d) ``cli/step2_extract.py`` with ResNet-50 and ResNet-18 on two of
    phase 15's SPY slides, one batch card (bf16) against CPU (f32), the
    encoder's and the host's ms a batch; then ``--roi_dir`` card against
    CPU."""
    import cv2

    from acmil_tpu_torch.cli import step2_extract
    from acmil_tpu_torch.config import Config
    from acmil_tpu_torch.data.patch_dataset import SlidePatchBatches
    from acmil_tpu_torch.data.ptio import open_feature_source
    from acmil_tpu_torch.models.encoders.build import encoder_feature_fn
    from acmil_tpu_torch.wsi.slide import open_slide
    from acmil_tpu_torch.wsi.tiling import load_coords_pt

    names = pipe["names"][:2]
    coords_dir = os.path.join(root, "resnet_coords")
    os.makedirs(coords_dir)
    for n in names:
        with open(os.path.join(pipe["coords_dir"], f"{n}.pt"), "rb") as src, \
                open(os.path.join(coords_dir, f"{n}.pt"), "wb") as dst:
            dst.write(src.read())
    slide_pt = os.path.join(coords_dir, f"{names[0]}.pt")
    coords, _, attrs = load_coords_pt(slide_pt)
    slide = open_slide(os.path.join(pipe["slide_dir"], f"{names[0]}.spy"))
    imgs = next(iter(SlidePatchBatches(
        slide, coords, int(attrs["patch_size"] * attrs.get("downsample", 1.0)),
        int(attrs.get("patch_level", 0)), target_size=PATCH_PX,
        batch_size=STEP2_BATCH, prefetch=0)))[0]
    read_ms = _batch_read_ms(slide, slide_pt)
    out = {}
    for backbone in RESNET_BACKBONES:
        res = step2_extract.main([
            "--slide_dir", pipe["slide_dir"], "--coords_dir", coords_dir,
            "--output_dir", os.path.join(root, f"feats_{backbone}"),
            "--pretrain", "natural_supervised", "--backbone", backbone,
            "--batch_size", str(STEP2_BATCH), "--coords_format", "pt",
            "--out_format", "pt", "--device", "cuda"])
        src = open_feature_source(res["out_path"], names)
        dim = 2048 if backbone == "Resnet50" else 512
        for n in names:
            f = np.asarray(src[src.names.index(n)]["input"], np.float32)
            if f.shape != (res["slides"][n], dim) or not np.isfinite(f).all():
                raise AssertionError(f"{backbone} {n}: features {f.shape}")
        conf = Config.from_dict({"pretrain": "natural_supervised",
                                 "backbone": backbone})
        model, spec = step2_extract._encoder(conf)
        card = encoder_feature_fn(model, spec, torch.device("cuda"))
        batch_ms = _event_ms(lambda: card(imgs), 10)
        cpu_model = copy.deepcopy(model)
        cpu_model.encoder.dtype = torch.float32
        cpu = encoder_feature_fn(cpu_model, spec, torch.device("cpu"),
                                 out_dtype=torch.float32)
        few = imgs[:RESNET_CPU_PATCHES]
        cos = float(_row_cosine(card(few).float().cpu(),
                                cpu(few)).min())
        if not cos >= COS_MIN:
            raise AssertionError(f"{backbone}: card vs CPU cosine {cos}")
        r = {"patches": res["patches"], "seconds": res["seconds"],
             "patches_per_s": res["patches"] / res["seconds"],
             "encoder_batch_ms": batch_ms, "host_read_ms": read_ms,
             "cpu_cosine_min": cos}
        out[backbone] = r
        print(f"step2 {backbone} (natural_supervised, bf16, batch "
              f"{STEP2_BATCH}) on {len(names)} SPY slides: {r['patches']} "
              f"patches in {r['seconds']:.2f} s, {r['patches_per_s']:.1f} "
              f"patches/s; encoder {batch_ms:.4f} ms a batch (CUDA events, "
              f"median of 10), the host's read+decode {read_ms:.1f} ms a "
              f"batch; card vs CPU (f32) on {len(few)} patches, worst row "
              f"cosine {cos:.6f} [{smi}]")

    rs = np.random.default_rng(SEED + 21)
    roi = os.path.join(root, "roi")
    for c in range(ROI_CLASSES):
        os.makedirs(os.path.join(roi, f"class_{c}"))
        for j in range(ROI_CROPS):
            h, w = rs.integers(200, 320, 2)
            img = rs.integers(0, 256, (h, w, 3), dtype=np.uint8)
            cv2.imwrite(os.path.join(roi, f"class_{c}", f"crop_{j}.png"), img)
    cents = {}
    for tag, dev in (("card", "cuda"), ("cpu", "cpu")):
        res = step2_extract.main([
            "--roi_dir", roi, "--output_dir", os.path.join(root, f"roi_{tag}"),
            "--pretrain", "natural_supervised", "--backbone", "Resnet18",
            "--batch_size", str(ROI_CROPS), "--device", dev])
        cents[tag] = np.load(res["out_path"])
    if cents["card"].shape != (ROI_CLASSES - 1, 512):
        raise AssertionError(f"roi centroids {cents['card'].shape}")
    roi_cos = float(_row_cosine(torch.from_numpy(cents["card"]),
                                torch.from_numpy(cents["cpu"])).min())
    if not roi_cos >= COS_MIN:
        raise AssertionError(f"roi centroids card vs CPU cosine {roi_cos}")
    out["roi_cosine_min"] = roi_cos
    print(f"step2 --roi_dir (Resnet18, {ROI_CLASSES} classes x {ROI_CROPS} "
          f"crops): roi_feats.npy {list(cents['card'].shape)}, card vs CPU "
          f"worst centroid cosine {roi_cos:.6f} [{smi}]")
    return out


def dtfd_sam_resnet_run(smi: str, tmp: str, pipe: dict,
                        corpus: dict) -> dict:
    """Phase 20: DTFD's training, scoring and routes with
    ``models/fast.py::DTFD_FUSE_MIN_S`` pinned to 0 (as the JAX package's
    tests pin it), SAM's step, Step2's ResNet trunks and ROI path. Returns
    the phase's numbers and B1/B2's launches on its paths."""
    from acmil_tpu_torch.models import fast

    t_phase = time.perf_counter()
    root = os.path.join(tmp, "dtfd_sam_resnet")
    os.makedirs(root)
    gate = fast.DTFD_FUSE_MIN_S
    fast.DTFD_FUSE_MIN_S = 0
    try:
        out = {"dtfd_train": _dtfd_train(smi, root, corpus),
               "dtfd_routes": _dtfd_routes(smi, corpus)}
    finally:
        fast.DTFD_FUSE_MIN_S = gate
    out["sam"] = _sam_run(smi, root, corpus)
    out["resnet"] = _resnet_step2(smi, root, pipe)
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"dtfd/sam/resnet phase wall {out['wall_s']:.2f} s [{smi}]")
    return out


VIT_ATTN_SHAPES = (("ViT-S/16", 6, 197, 64), ("ViT-S/8", 6, 785, 64),
                   ("CLIP-L/336", 16, 577, 64))
# N at csrc/vit_attn.cu's edges: the ragged 16-key chunk; at dh=64 the
# warpgroup routes' 208-key steps (one for N in [145, 208], two up to 416,
# three up to 624, mma.sync above); keys resident against streamed (N > 896
# at dh=64, > 448 at dh=128)
EDGE_N = (1, 15, 16, 17, 63, 64, 65, 144, 145, 197, 208, 209, 416, 417, 448,
          449, 577, 624, 625, 785, 896, 897)


def vit_attn_b7_vs_plain(smi: str) -> dict:
    """B7 against its plain version (forward and backward), then timed."""
    from acmil_tpu_torch.ops import vit_attn as va
    from acmil_tpu_torch.ops.vit_attn_packed import KERNEL_HEAD_DIMS

    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    worst, checks = 0.0, 0

    def randn(*shape):
        return (2 * torch.randn(*shape, generator=gen,
                                device="cuda")).bfloat16()

    with torch.no_grad():
        for name, heads, n, dh in VIT_ATTN_SHAPES:
            for b in (1, 64):
                q, k, v = (randn(b, heads, n, dh) for _ in range(3))
                got = va.fused_vit_attention(q, k, v)
                torch.cuda.synchronize()
                checks += 1
                err = _err(got, va._reference_attention(q, k, v), B5_TOL)
                worst = max(worst, err)
                print(f"kernel B7 vs plain: {name} H={heads} N={n} dh={dh} "
                      f"B={b} bf16: max_abs_err {err:.3e}")
        # q, k, v as strided views of one packed qkv [B, N, 3, H, dh]
        name, heads, n, dh = VIT_ATTN_SHAPES[0]
        qkv = randn(4, n, 3, heads, dh)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)
        got = va.fused_vit_attention(q, k, v, scale=0.1)
        torch.cuda.synchronize()
        checks += 1
        err = _err(got, va._reference_attention(q, k, v, 0.1), B5_TOL)
        worst = max(worst, err)
        print(f"kernel B7 vs plain: {name} B=4 on strided views of a packed "
              f"qkv, scale 0.1: max_abs_err {err:.3e}")

        # B5' on a packed qkv and B7 on strided views of it at the edges
        from acmil_tpu_torch.ops import vit_attn_packed as pk

        b5_worst, b5_checks, b7_edge = 0.0, 0, 0.0
        for dh in KERNEL_HEAD_DIMS:
            for n in EDGE_N:
                qkv = randn(2, n, 3 * 2 * dh)
                got = pk.fused_mha_packed(qkv, 2)
                torch.cuda.synchronize()
                b5_worst = max(b5_worst, _err(got, pk._reference_packed(qkv, 2),
                                              B5_TOL))
                b5_checks += 1
                q, k, v = qkv.view(2, n, 3, 2, dh).permute(2, 0, 3, 1, 4)
                got = va.fused_vit_attention(q, k, v, scale=-0.2)
                torch.cuda.synchronize()
                b7_edge = max(b7_edge, _err(
                    got, va._reference_attention(q, k, v, -0.2), B5_TOL))
                checks += 1
        worst = max(worst, b7_edge)
        print(f"kernels B5' and B7 vs plain at the edges: N in {EDGE_N}, dh in "
              f"{KERNEL_HEAD_DIMS}, B=2 H=2 (B7 on strided views, scale "
              f"-0.2): {b5_checks} shapes each, max_abs_err B5' "
              f"{b5_worst:.3e}, B7 {b7_edge:.3e}")

    # the backward recomputes through the plain version
    name, heads, n, dh = VIT_ATTN_SHAPES[0]
    ins = [randn(2, heads, n, dh).requires_grad_() for _ in range(3)]
    g = randn(2, heads, n, dh)
    out = va.fused_vit_attention(*ins)
    grads = torch.autograd.grad(out, ins, g)
    refs = [t.detach().clone().requires_grad_() for t in ins]
    want = torch.autograd.grad(va._reference_attention(*refs), refs, g)
    checks += 1
    for gname, a, w in zip("qkv", grads, want):
        err = _err(a, w, B5_TOL)
        print(f"kernel B7 backward vs autograd through the plain version: "
              f"d{gname} max_abs_err {err:.3e}")

    b = STEP2_BATCH
    q, k, v = (randn(b, heads, n, dh) for _ in range(3))
    d = heads * dh
    with torch.no_grad():
        r = {"ms": _time_ms(lambda: va.fused_vit_attention(q, k, v), 20),
             "device": _device_ms(lambda: va.fused_vit_attention(q, k, v),
                                  ("mha_kernel",)),
             "plain_ms": _time_ms(lambda: va._reference_attention(q, k, v), 10),
             "library_ms": _time_ms(
                 lambda: torch.nn.functional.scaled_dot_product_attention(
                     q, k, v), 20),
             **_bound(b * 4 * n * n * d, b * 2 * 4 * n * d)}
    r["device_ms"], per_call = r.pop("device")
    print(f"kernel B7 time: {name} B={b} H={heads} N={n} dh={dh} bf16: kernel "
          f"{r['ms']:.4f} ms (device {_fmt_ms(r['device_ms'])} in "
          f"{per_call:g} launches), plain {r['plain_ms']:.4f} ms, "
          f"scaled_dot_product_attention {r['library_ms']:.4f} ms, bound "
          f"{r['bound_ms']:.4f} ms ({r['bound_by']}), {_bound_share(r)} "
          f"[{smi}]")
    return {"max_abs_err": worst, "checks": checks, **r,
            "b5_edges": {"max_abs_err": b5_worst, "checks": b5_checks}}


# ---------------------------------------------------------------------------
# phase 21: Step3 across processes (acmil_tpu_torch/parallel)
# ---------------------------------------------------------------------------

# the sequence-sharded step's bags: a 100000-patch bag under max_patches
# 131072 (bucket 131072: 65536 fp16 rows a rank at seq 2), and a 40000-patch
# bag padded to the same bucket, whose valid rows all lie on rank 0
MESH_N, MESH_LENGTHS = 131072, (100000, 40000)
# TransMIL at seq 2: one bag of this many patches (bucket 65536)
MESH_TM_N, MESH_TM_BUCKET = 50000, 65536
# the sharded pooling's bag and lse against the one-process kernel's (the
# JAX package's tests/test_attn_pool.py sharded-pool tolerance)
MESH_POOL_ATOL = 2e-5
# TransMIL's Nystrom pseudo-inverse amplifies the order of f32 sums (the
# tolerance of tests/test_torch_transmil.py): loss relative, each gradient
# relative to its largest magnitude
MESH_TM_LOSS_RTOL, MESH_TM_GRAD_REL = 1e-4, 1e-3
# metrics of a mesh run's epoch against the one-process run's
MESH_METRIC_ATOL = 1e-4
# the phase's ranks must be done in this many seconds a launch
MESH_LAUNCH_TIMEOUT = 300


class _CollectiveClock:
    """Host seconds spent in ``parallel/collectives.py``'s transfers
    (``all_reduce_``, ``gather_list``, ``broadcast_``), each timed from a
    synchronised card: ``gloo`` moves CUDA tensors through host memory, so
    the wall time around a call is its cost, the copies and the wait for
    the other ranks included."""

    def __init__(self):
        from acmil_tpu_torch.parallel import collectives as C

        self.C, self.seconds, self.calls = C, 0.0, 0
        self._orig = {n: getattr(C, n) for n in
                      ("all_reduce_", "gather_list", "broadcast_")}
        for name, fn in self._orig.items():
            setattr(C, name, self._timed(fn))

    def _timed(self, fn):
        def run(*a, **k):
            # the card's queued work first, so the clock reads the transfer
            # and the wait for the other ranks, not this rank's kernels
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                self.seconds += time.perf_counter() - t0
                self.calls += 1
        return run

    def reset(self):
        self.seconds, self.calls = 0.0, 0

    def restore(self):
        """Put the untimed collectives back."""
        for name, fn in self._orig.items():
            setattr(self.C, name, fn)


def _mesh_bag(n_lengths, n_pad, device, seed):
    """The global bag of the sharded step: fp16 features from a seeded CUDA
    generator, the first ``n`` rows of each bag valid, labels 1, 0, ..."""
    from acmil_tpu_torch.data.bags import Bag

    gen = torch.Generator(device=device).manual_seed(seed)
    b = len(n_lengths)
    feats = torch.randn(b, n_pad, D_FEAT, generator=gen, device=device,
                        dtype=torch.float16)
    mask = torch.zeros(b, n_pad, dtype=torch.bool, device=device)
    for i, n in enumerate(n_lengths):
        mask[i, :n] = True
    feats = feats * mask[..., None]
    coords = torch.zeros(b, n_pad, 2, dtype=torch.int32, device=device)
    label = torch.tensor([(i + 1) % 2 for i in range(b)], device=device)
    return Bag(feats, mask, coords, label)


def _mesh_ga_setup(device, mesh=None):
    from acmil_tpu_torch.config import Config
    from acmil_tpu_torch.engine import create_train_state, make_train_step
    from acmil_tpu_torch.models import build_mil_model
    from acmil_tpu_torch.parallel import shard_params

    conf = Config.from_yaml(YML, {"arch": "ga", "n_token": N_TOKEN,
                                  "n_masked_patch": N_MASKED_PATCH,
                                  "mask_drop": MASK_DROP,
                                  "max_patches": MESH_N})
    model, fam = build_mil_model(conf, mesh=mesh)
    model.to(device)
    if mesh is not None:
        shard_params(model, mesh)
    state = create_train_state(model, conf, 10, family=fam)
    return model, state, make_train_step(model, conf, fam, mesh=mesh)


def _mesh_tm_setup(device, mesh=None):
    from acmil_tpu_torch.config import Config
    from acmil_tpu_torch.engine import create_train_state, make_train_step
    from acmil_tpu_torch.models import build_mil_model
    from acmil_tpu_torch.parallel import shard_params

    conf = Config.from_yaml(YML, {"arch": "transmil"})
    model, fam = build_mil_model(conf, mesh=mesh)
    model.to(device)
    if mesh is not None:
        shard_params(model, mesh)
    state = create_train_state(model, conf, 10, family=fam)
    return model, state, make_train_step(model, conf, fam, mesh=mesh)


def _grads(model) -> dict:
    return {n: p.grad.detach().clone() for n, p in model.named_parameters()}


def _gloo_cuda_probe(device) -> dict:
    """Which collectives of the sharded path ``gloo`` takes on a CUDA
    tensor (``parallel/collectives.py`` hands them to it as they are):
    ``ok``, or the first line of its refusal. Run on a group of its own, so
    that a refusal leaves the mesh's groups alone."""
    import torch.distributed as dist

    group = dist.new_group(backend="gloo")
    t = torch.ones(4, device=device)
    out = {}
    calls = {
        "all_reduce_sum": lambda: dist.all_reduce(t.clone(), group=group),
        "all_reduce_max": lambda: dist.all_reduce(
            t.clone(), op=dist.ReduceOp.MAX, group=group),
        "all_reduce_min": lambda: dist.all_reduce(
            t.clone(), op=dist.ReduceOp.MIN, group=group),
        "all_gather": lambda: dist.all_gather(
            [torch.empty_like(t) for _ in range(dist.get_world_size())],
            t, group=group),
        "broadcast": lambda: dist.broadcast(t.clone(), src=0, group=group)}
    for name, call in calls.items():
        try:
            call()
            torch.cuda.synchronize()
            out[name] = "ok"
        except Exception as e:        # a refusal is the answer sought
            out[name] = str(e).splitlines()[0][:160]
    return out


def _mesh_worker_steps(out: str) -> None:
    """(b) and (d) on this rank of a (data 1, seq 2) gloo mesh: ACMIL_GA's
    sequence-sharded step at full width, then TransMIL's."""
    from acmil_tpu_torch.models.fast import _ga_weights
    from acmil_tpu_torch.ops import attn_pool as ap
    from acmil_tpu_torch.parallel import (init_distributed, make_mesh,
                                          shard_bag)

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    init_distributed(device, backend="gloo", timeout=MESH_LAUNCH_TIMEOUT)
    mesh = make_mesh(1, 2, device)
    res = {"rank": mesh.rank, "gloo_cuda": _gloo_cuda_probe(device)}
    clock = _CollectiveClock()

    whole = _mesh_bag(MESH_LENGTHS, MESH_N, device, SEED + 21)
    part = shard_bag(whole, mesh, shard_seq=True)
    u = torch.rand(len(MESH_LENGTHS), N_TOKEN, MESH_N, device=device,
                   generator=torch.Generator(device=device).manual_seed(SEED))
    torch.manual_seed(SEED)
    model, state, step = _mesh_ga_setup(device, mesh)
    # the merge's bag and lse, read for the check (outside the counted step)
    with torch.no_grad():
        b_, _, m, s = ap._pool_forward(part.feats, part.mask,
                                       *_ga_weights(model))
        bag, lse = ap._merge_seq(b_, m, s, mesh.seq_group)
    res["valid_rows"] = int(part.mask.sum())
    ap.fused_gated_attn_pool_batched.launches = 0
    ap.fused_gated_attn_pool_bwd.launches = 0
    aux = step(state, part, stkim_u=u)
    torch.cuda.synchronize()
    res["B1"] = ap.fused_gated_attn_pool_batched.launches
    res["B2"] = ap.fused_gated_attn_pool_bwd.launches
    res["loss"], res["grad_norm"] = float(aux["loss"]), float(aux["grad_norm"])
    torch.save({"bag": bag.cpu(), "lse": lse.cpu(),
                "grads": {n: g.cpu() for n, g in _grads(model).items()}},
               f"{out}.ga{mesh.rank}.pt")
    # the step timed: CUDA events around it, and the host's time in the
    # collectives apart
    clock.reset()
    res["step_ms"] = _event_ms(lambda: step(state, part, stkim_u=u), 5)
    res["collective_ms"] = clock.seconds * 1e3 / 5
    res["collective_calls"] = clock.calls / 5
    # the card's share: every kernel of a step, and B1's and B2's alone
    res["device_ms"], res["device_events"] = _device_profile(
        lambda: step(state, part, stkim_u=u), 3)
    res["b1_b2_device_ms"], _ = _device_ms(
        lambda: step(state, part, stkim_u=u),
        ap.B1_KERNELS + ap.B2_KERNELS, reps=3)
    del whole, part, u, model, state, step
    torch.cuda.empty_cache()

    # (d) TransMIL: the bag's slices gathered, the Nystrom core sharded
    tm_whole = _mesh_bag((MESH_TM_N,), MESH_TM_BUCKET, device, SEED + 22)
    tm_part = shard_bag(tm_whole, mesh, shard_seq=True)
    torch.manual_seed(SEED)
    model, state, step = _mesh_tm_setup(device, mesh)
    aux = step(state, tm_part)
    res["tm_loss"] = float(aux["loss"])
    torch.save({n: g.cpu() for n, g in _grads(model).items()},
               f"{out}.tm{mesh.rank}.pt")
    clock.reset()
    res["tm_step_ms"] = _event_ms(lambda: step(state, tm_part), 3)
    res["tm_collective_ms"] = clock.seconds * 1e3 / 3
    with open(f"{out}.rank{mesh.rank}.json", "w") as f:
        json.dump(res, f)


def _mesh_worker_cli(out: str, argv: list) -> None:
    """``cli/step3_acmil.py`` on this rank, B1 and B2 counted apart for the
    train steps and the eval (``evaluate``)."""
    import acmil_tpu_torch.cli.train as cli
    from acmil_tpu_torch.cli import step3_acmil
    from acmil_tpu_torch.ops import attn_pool as ap

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    evaluate, evals = cli.evaluate, {"B1": 0}

    def counted(*a, **k):
        before = ap.fused_gated_attn_pool_batched.launches
        try:
            return evaluate(*a, **k)
        finally:
            evals["B1"] += ap.fused_gated_attn_pool_batched.launches - before

    cli.evaluate = counted
    ap.fused_gated_attn_pool_batched.launches = 0
    ap.fused_gated_attn_pool_bwd.launches = 0
    clock = _CollectiveClock()
    t0 = time.perf_counter()
    best = step3_acmil.main(argv)
    torch.cuda.synchronize()
    res = {"best": best, "wall_s": time.perf_counter() - t0,
           "B1": ap.fused_gated_attn_pool_batched.launches,
           "B2": ap.fused_gated_attn_pool_bwd.launches,
           "B1_eval": evals["B1"], "collective_s": clock.seconds,
           "backend": (torch.distributed.get_backend()
                       if torch.distributed.is_initialized() else None)}
    rank = int(os.environ.get("RANK", "0"))
    with open(f"{out}.rank{rank}.json", "w") as f:
        json.dump(res, f)


def mesh_worker(job: str, out: str, *argv: str) -> None:
    """One rank of a phase-21, 22 or 25 launch (``python -m
    torch.distributed.run ... chip_smoke.py --mesh-worker JOB OUT
    [ARGV...]``)."""
    if job == "steps":
        _mesh_worker_steps(out)
    elif job == "cli":
        _mesh_worker_cli(out, list(argv))
    elif job == "step2_cli":
        _step2_worker_cli(out, list(argv))
    elif job == "step2_pair":
        _step2_worker_pair(out, *argv)
    elif job == "scan_cli":
        _scan_worker_cli(out, list(argv))
    elif job == "scan_mesh":
        _scan_worker_mesh(out, *argv)
    else:
        raise ValueError(f"no mesh job {job!r}")
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


def _torchrun(n: int, job: str, out: str, *argv: str) -> list:
    """``n`` ranks of ``mesh_worker(job)`` under torchrun; every rank must
    exit 0. Returns each rank's result."""
    import sys

    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(n), os.path.abspath(__file__),
           "--mesh-worker", job, out, *argv]
    env = dict(os.environ, PYTHONPATH=REPO)
    t0 = time.perf_counter()
    r = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                       text=True, timeout=MESH_LAUNCH_TIMEOUT)
    if r.returncode:
        raise RuntimeError(f"{n}-rank {job} launch failed ({r.returncode}):\n"
                           f"{r.stdout[-3000:]}\n{r.stderr[-6000:]}")
    res = []
    for rank in range(n):
        with open(f"{out}.rank{rank}.json") as f:
            res.append(json.load(f))
    res[0]["launch_s"] = time.perf_counter() - t0
    return res


def _same_metrics(got: dict, want: dict, what: str) -> float:
    worst = 0.0
    for k, v in want.items():
        if k == "epoch":
            if got[k] != v:
                raise AssertionError(f"{what}: best epoch {got[k]} != {v}")
            continue
        if math.isnan(v) and math.isnan(got[k]):
            continue
        worst = max(worst, abs(got[k] - v))
    if not worst <= MESH_METRIC_ATOL:
        raise AssertionError(f"{what}: metrics {got} against one process "
                             f"{want}")
    return worst


def mesh_run(smi: str, tmp: str, pipe: dict, corpus: dict) -> dict:
    """Phase 21: Step3 on a (data, seq) mesh of processes, the ranks started
    by torchrun. (a) NCCL at world size 1 on phase 15's corpus; (b) gloo, two
    ranks on the card at seq 2: ACMIL_GA's sharded step at full width against
    the one-process step; (c) gloo, four ranks, data 2 x seq 2: one epoch of
    cli/step3_acmil.py against the one-process run; (d) TransMIL's step at
    seq 2 against the one-process step."""
    from acmil_tpu_torch.cli import step3_acmil
    from acmil_tpu_torch.ops import attn_pool as ap

    t_phase = time.perf_counter()
    root = os.path.join(tmp, "mesh")
    os.makedirs(root)
    out = {}

    # (a) NCCL at world size 1, against the run without a mesh
    def pipe_argv(tag, *extra):
        return ["--config", pipe["yml"], "--train_epoch", "1",
                "--n_token", str(N_TOKEN), "--n_masked_patch",
                str(N_MASKED_PATCH), "--mask_drop", str(MASK_DROP),
                "--ckpt_dir", os.path.join(root, tag, "ckpt"),
                "--log_dir", os.path.join(root, tag, "log"),
                "--device", "cuda", *extra]

    ap.fused_gated_attn_pool_batched.launches = 0
    ap.fused_gated_attn_pool_bwd.launches = 0
    want = step3_acmil.main(pipe_argv("one_a"))
    want_counts = (ap.fused_gated_attn_pool_batched.launches,
                   ap.fused_gated_attn_pool_bwd.launches)
    (a,) = _torchrun(1, "cli", os.path.join(root, "a"),
                     *pipe_argv("nccl", "--mesh_data", "1"))
    if a["backend"] != "nccl" or (a["B1"], a["B2"]) != want_counts:
        raise AssertionError(f"(a) backend {a['backend']}, launches B1 "
                             f"{a['B1']} B2 {a['B2']} against {want_counts}")
    err_a = _same_metrics(a["best"], want, "(a) NCCL world 1")
    out["nccl_world1"] = {"B1": a["B1"], "B2": a["B2"],
                          "metric_err": err_a, "wall_s": a["wall_s"],
                          "launch_s": a["launch_s"]}
    print(f"mesh (a): cli/step3_acmil.py --mesh_data 1 under torchrun, "
          f"nccl, world 1: one epoch's metrics equal the run without a "
          f"mesh (max |diff| {err_a:.3e}), B1 {a['B1']} B2 {a['B2']} as "
          f"there; {a['wall_s']:.2f} s in main(), {a['launch_s']:.2f} s the "
          f"launch [{smi}]")

    # (b) and (d): two ranks on the card, gloo, seq 2
    ranks = _torchrun(2, "steps", os.path.join(root, "b"))
    device = torch.device("cuda")
    whole = _mesh_bag(MESH_LENGTHS, MESH_N, device, SEED + 21)
    u = torch.rand(len(MESH_LENGTHS), N_TOKEN, MESH_N, device=device,
                   generator=torch.Generator(device=device).manual_seed(SEED))
    torch.manual_seed(SEED)
    model, state, step = _mesh_ga_setup(device)
    from acmil_tpu_torch.models.fast import _ga_weights

    with torch.no_grad():
        b_, _, m, s = ap._pool_forward(whole.feats, whole.mask,
                                       *_ga_weights(model))
        lse1 = m + torch.log(torch.clamp_min(s, 1e-30))
    aux = step(state, whole, stkim_u=u)
    g1 = _grads(model)
    loss1 = float(aux["loss"])
    pool_err, grad_worst = 0.0, 0.0
    for r in ranks:
        got = torch.load(os.path.join(root, f"b.ga{r['rank']}.pt"),
                         map_location=device)
        pool_err = max(pool_err, float((got["bag"] - b_).abs().max()),
                       float((got["lse"] - lse1).abs().max()))
        if not abs(r["loss"] - loss1) <= STEP_LOSS_RTOL * abs(loss1):
            raise AssertionError(f"(b) rank {r['rank']} loss {r['loss']} "
                                 f"against {loss1}")
        for n, g in g1.items():
            e = float((got["grads"][n] - g).abs().max())
            if not e <= STEP_GRAD_REL * float(g.abs().max()) + STEP_GRAD_ATOL:
                raise AssertionError(f"(b) rank {r['rank']} gradient of {n} "
                                     f"differs by {e:.3e}")
            if n != "attention.attention_weights.bias":
                grad_worst = max(grad_worst, _rel_to_max(got["grads"][n], g))
        if (r["B1"], r["B2"]) != (1, 1):
            raise AssertionError(f"(b) rank {r['rank']} launched B1 {r['B1']}"
                                 f" B2 {r['B2']} in one step")
    if pool_err > MESH_POOL_ATOL:
        raise AssertionError(f"(b) sharded bag/lse differ by {pool_err:.3e}")
    one_ms = _event_ms(lambda: step(state, whole, stkim_u=u), 5)
    del whole, u, model, state, step, b_, g1
    torch.cuda.empty_cache()
    out["ga_seq2"] = {"ranks": ranks, "pool_err": pool_err,
                      "grad_rel": grad_worst, "one_process_step_ms": one_ms}
    print(f"mesh (b): ACMIL_GA at full width (Df {D_FEAT}, L = A = "
          f"{D_INNER}, K {N_TOKEN}, STKIM {N_MASKED_PATCH}/{MASK_DROP}), two "
          f"bags of {MESH_LENGTHS} patches in bucket {MESH_N}, seq 2 over two "
          f"gloo ranks on the card (valid rows a rank: "
          f"{[r['valid_rows'] for r in ranks]}): B1 and B2 once a rank a "
          f"step; bag and lse against the one-process kernel max |diff| "
          f"{pool_err:.3e}, loss {[r['loss'] for r in ranks]} against "
          f"{loss1:.7f}, worst gradient {grad_worst:.3e} of its max; step "
          f"{[round(r['step_ms'], 4) for r in ranks]} ms a rank (CUDA events, "
          f"median of 5), of it {[round(r['collective_ms'], 4) for r in ranks]} "
          f"ms of host time in {ranks[0]['collective_calls']:.0f} gloo "
          f"collectives; one process {one_ms:.4f} ms [{smi}]")
    print(f"mesh (b): a rank's step on the card (torch.profiler): "
          f"{[r['device_ms'] for r in ranks]} ms of device time in "
          f"{[r['device_events'] for r in ranks]} events, B1 + B2 "
          f"{[r['b1_b2_device_ms'] for r in ranks]} ms; gloo on CUDA tensors "
          f"as they are: {ranks[0]['gloo_cuda']} [{smi}]")

    # (d) TransMIL against the one-process step
    tm_whole = _mesh_bag((MESH_TM_N,), MESH_TM_BUCKET, device, SEED + 22)
    torch.manual_seed(SEED)
    model, state, step = _mesh_tm_setup(device)
    aux = step(state, tm_whole)
    tm_loss, tm_g = float(aux["loss"]), _grads(model)
    tm_worst = 0.0
    for r in ranks:
        if not abs(r["tm_loss"] - tm_loss) <= MESH_TM_LOSS_RTOL * abs(tm_loss):
            raise AssertionError(f"(d) rank {r['rank']} TransMIL loss "
                                 f"{r['tm_loss']} against {tm_loss}")
        got = torch.load(os.path.join(root, f"b.tm{r['rank']}.pt"),
                         map_location=device)
        for n, g in tm_g.items():
            e = _rel_to_max(got[n], g)
            if not e <= MESH_TM_GRAD_REL:
                raise AssertionError(f"(d) rank {r['rank']} TransMIL "
                                     f"gradient of {n}: {e:.3e} of its max")
            tm_worst = max(tm_worst, e)
    tm_ms = _event_ms(lambda: step(state, tm_whole), 3)
    del tm_whole, model, state, step, tm_g
    torch.cuda.empty_cache()
    out["transmil_seq2"] = {"loss": tm_loss, "grad_rel": tm_worst,
                            "step_ms": [r["tm_step_ms"] for r in ranks],
                            "collective_ms": [r["tm_collective_ms"]
                                              for r in ranks],
                            "one_process_step_ms": tm_ms}
    print(f"mesh (d): TransMIL one step at seq 2 on {MESH_TM_N} patches "
          f"(bucket {MESH_TM_BUCKET}): loss {[r['tm_loss'] for r in ranks]} "
          f"against one process {tm_loss:.7f}, worst gradient {tm_worst:.3e} "
          f"of its max; step {[round(r['tm_step_ms'], 4) for r in ranks]} "
          f"ms a rank, {[round(r['tm_collective_ms'], 4) for r in ranks]} ms "
          f"of it in gloo collectives; one process {tm_ms:.4f} ms [{smi}]")

    # (c) four ranks on the card, gloo, data 2 x seq 2, against one process
    yml = os.path.join(root, "mesh.yml")
    with open(corpus["yml"]) as src, open(yml, "w") as dst:
        dst.write(src.read() + "\nmesh_shape: {data: 2, seq: 2}"
                  "\ndist_backend: gloo\n")

    def corpus_argv(cfg, tag, device):
        return ["--config", cfg, "--data_dir", corpus["data_dir"],
                "--arch", "ga", "--B", "2",
                "--train_epoch", "1", "--n_token", str(N_TOKEN),
                "--n_masked_patch", str(N_MASKED_PATCH), "--mask_drop",
                str(MASK_DROP), "--ckpt_dir", os.path.join(root, tag, "ckpt"),
                "--log_dir", os.path.join(root, tag, "log"), "--device",
                device]

    want = step3_acmil.main(corpus_argv(corpus["yml"], "one_c", "cuda"))
    ranks_c = _torchrun(4, "cli", os.path.join(root, "c"),
                        *corpus_argv(yml, "mesh_c", "cuda:0"))
    err_c = max(_same_metrics(r["best"], want, f"(c) rank {i}")
                for i, r in enumerate(ranks_c))
    for i, r in enumerate(ranks_c):
        if r["B1"] - r["B1_eval"] != r["B2"] or not r["B2"] \
                or not r["B1_eval"] or r["backend"] != "gloo":
            raise AssertionError(f"(c) rank {i}: {r}")
    logs = os.listdir(os.path.join(root, "mesh_c", "log"))
    if sorted(os.listdir(os.path.join(root, "mesh_c", "ckpt"))) != [
            "checkpoint-best.pth", "checkpoint-last.pth"] \
            or logs != ["metrics.jsonl"]:
        raise AssertionError(f"(c) one writer: ckpt/log hold {logs}")
    out["data2_seq2_cli"] = {
        "B1_step3": sum(r["B1"] - r["B1_eval"] for r in ranks_c),
        "B2_step3": sum(r["B2"] for r in ranks_c),
        "B1_eval": sum(r["B1_eval"] for r in ranks_c),
        "metric_err": err_c, "wall_s": [r["wall_s"] for r in ranks_c],
        "collective_s": [r["collective_s"] for r in ranks_c],
        "launch_s": ranks_c[0]["launch_s"]}
    print(f"mesh (c): cli/step3_acmil.py with mesh_shape {{data: 2, seq: 2}}, "
          f"four gloo ranks on the card, B 2, one epoch and eval on phase "
          f"16's slides: metrics equal the one-process run's (max |diff| "
          f"{err_c:.3e}); B1 {[r['B1'] - r['B1_eval'] for r in ranks_c]} and "
          f"B2 {[r['B2'] for r in ranks_c]} a rank in training, B1 "
          f"{[r['B1_eval'] for r in ranks_c]} in eval; "
          f"{[round(r['wall_s'], 2) for r in ranks_c]} s in main(), of it "
          f"{[round(r['collective_s'], 2) for r in ranks_c]} s in gloo "
          f"collectives; {ranks_c[0]['launch_s']:.2f} s the launch [{smi}]")
    print(f"mesh phase wall {time.perf_counter() - t_phase:.2f} s [{smi}]")
    return out


# ---------------------------------------------------------------------------
# phase 22: Step2 across processes (the data axis, parallel/tp.py, B7)
# ---------------------------------------------------------------------------

# (c) tensor parallelism at ViT-S/16: this batch, on two of phase 15's slides
TP_BATCH, TP_SLIDES = 64, 2
# (d) UNI at data 2 x model 2: this batch over the first patches of a slide
TP_UNI_BATCH, TP_UNI_PATCHES = 16, 48
# (e) GigaPath ViT-G/16 at full width and this depth; (e) and (f) encode one
# batch of this many seeded images
TP_GIGA_DEPTH, TP_IMAGES = 2, 16
# layerscale of the random UNI and GigaPath trunks: at the init's 1e-5 the
# blocks would add next to nothing to the residual stream
TP_LS = 0.5
# (f) the f32 TP forward against the module forward at f32 on the card, TF32
# off both: the order of the f32 sums differs (the model group's all-reduce
# adds two partial products), relative to the largest feature
TP_F32_REL = 1e-4
# (g) B7 against its plain version at these head widths and token counts;
# f32 within B7_F32_TOL of the largest output (the order of f32 sums and
# exp's rounding), fp16 and bf16 by B5_TOL
B7_DH, B7_N, B7_F32_TOL = (16, 48, 64, 80, 128, 256), (197, 577, 1025), 1e-5
# (g) the TP block's B7 call at each path's shape: (path, images a rank,
# heads a rank, dtype, route); dh 64 and N 197 throughout
TP_B7_CALLS = (("(f)", TP_IMAGES, 3, torch.float32, "tf32x3"),
               ("(c)", TP_BATCH, 3, torch.bfloat16, "mma"),
               ("(d)", TP_UNI_BATCH // 2, 8, torch.bfloat16, "mma"),
               ("(e)", TP_IMAGES, 12, torch.bfloat16, "mma"))
# the fma route's kernel, as the profiler names it (the tf32x3 route's is
# ops/vit_attn_packed.py::TF32X3_KERNELS)
B7_FMA_KERNELS = ("b7_generic_kernel",)


def _step2_counts() -> dict:
    """The ViT kernels' launch counts: B3, B4, B5' and B7 by route."""
    from acmil_tpu_torch.ops import vit_attn, vit_attn_packed, vit_layer

    routes = vit_attn.fused_vit_attention.route_launches
    return {"B3": vit_layer.fused_vit_layer.launches,
            "B4": vit_layer.fused_vit_attn_half.launches,
            "B5": vit_attn_packed._launch_packed.launches,
            "B7_mma": routes["mma"], "B7_tf32x3": routes["tf32x3"],
            "B7_fma": routes["fma"]}


def _counted(clock, fn):
    """(fn's result, its kernel launches, host seconds, seconds of it in
    collectives)."""
    before = _step2_counts()
    clock.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    after = _step2_counts()
    return out, {k: after[k] - before[k] for k in after}, wall, clock.seconds


class _UniSpec:
    """UNI's encoder spec with every layerscale at ``TP_LS``, for the
    duration (random UNI weights whose blocks count)."""

    KEY = ("UNI", "ViT-L/16")

    def __enter__(self):
        from dataclasses import replace

        from acmil_tpu_torch.models.encoders import build
        from acmil_tpu_torch.models.encoders.vit import ViT

        self.build, self.old = build, build.ENCODER_SPECS[self.KEY]
        build.ENCODER_SPECS[self.KEY] = replace(self.old, builder=lambda dt: ViT(
            16, 1024, 24, 16, layerscale=True, ls_init=TP_LS, dtype=dt))
        return self

    def __exit__(self, *exc):
        self.build.ENCODER_SPECS[self.KEY] = self.old


def _tp_trunk(kind: str):
    """(CustomModel, spec) of a seeded trunk: GigaPath ViT-G/16 at full
    width and ``TP_GIGA_DEPTH`` (bf16), or ViT-S/16 at f32."""
    from acmil_tpu_torch.models.encoders import build
    from acmil_tpu_torch.models.encoders.vit import ViT

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(SEED)
        if kind == "giga":
            spec = build.ENCODER_SPECS[("GigaPath", "ViT-G/16")]
            enc = ViT(16, 1536, TP_GIGA_DEPTH, 24, mlp_ratio=16.0 / 3.0,
                      act="swiglu", layerscale=True, ls_init=TP_LS,
                      dtype=torch.bfloat16)
        else:
            spec = build.ENCODER_SPECS[("medical_ssl", "ViT-S/16")]
            enc = ViT(16, 384, STEP2_DEPTH, 6, dtype=torch.float32)
    return build.CustomModel(enc, 2), spec


def _tp_images() -> np.ndarray:
    return np.random.default_rng(SEED + 22).integers(
        0, 256, (TP_IMAGES, PATCH_PX, PATCH_PX, 3), np.uint8)


def _step2_worker_cli(out: str, argv: list) -> None:
    """``cli/step2_extract.py`` on this rank (UNI's layerscale at
    ``TP_LS``), its ViT kernel launches and collective seconds counted."""
    from acmil_tpu_torch.cli import step2_extract

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    clock = _CollectiveClock()
    with _UniSpec():
        res, counts, wall, coll = _counted(
            clock, lambda: step2_extract.main(argv))
    rank = int(os.environ.get("RANK", "0"))
    with open(f"{out}.rank{rank}.json", "w") as f:
        json.dump({"rank": rank, "counts": counts, "wall_s": wall,
                   "collective_s": coll, "slides": res["slides"],
                   "patches": res["patches"], "seconds": res["seconds"],
                   "out_path": res["out_path"],
                   "backend": torch.distributed.get_backend()}, f)


def _step2_worker_pair(out: str, params_path: str) -> None:
    """(b), (c), (e) and (f) on this rank of two gloo ranks on the card."""
    from acmil_tpu_torch.cli import step2_extract
    from acmil_tpu_torch.parallel import init_distributed, make_mesh
    from acmil_tpu_torch.parallel.tp import tp_encoder_feature_fn
    from acmil_tpu_torch.wsi.slide import open_slide

    with open(params_path) as f:
        p = json.load(f)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    init_distributed(device, backend="gloo", timeout=MESH_LAUNCH_TIMEOUT)
    rank = torch.distributed.get_rank()
    clock = _CollectiveClock()
    res = {"rank": rank}

    def cli(key, argv):
        r, counts, wall, coll = _counted(clock,
                                         lambda: step2_extract.main(argv))
        res[key] = {"counts": counts, "wall_s": wall, "collective_s": coll,
                    "collective_calls": clock.calls,
                    "slides": r["slides"], "patches": r["patches"],
                    "seconds": r["seconds"],
                    "slide_seconds": r["slide_seconds"],
                    "out_path": r["out_path"]}

    # (b) the data axis: each rank reads and encodes half of every batch
    cli("b", p["b"])
    name = p["names"][0]
    res["b"]["read_ms"] = _batch_read_ms(
        open_slide(os.path.join(p["slide_dir"], f"{name}.spy"), cache=False),
        os.path.join(p["coords_dir"], f"{name}.pt"), shard=(rank, 2))
    # (c) the model axis at ViT-S/16 through the CLI
    cli("c", p["c"])
    # (e) GigaPath, (f) ViT-S/16 at f32, through tp_encoder_feature_fn
    mesh = make_mesh(1, 1, device, model=2)
    u8 = _tp_images()
    for key, kind, dtype in (("e", "giga", torch.float16),
                             ("f", "vits_f32", torch.float32)):
        model, spec = _tp_trunk(kind)
        fn = tp_encoder_feature_fn(model, spec, mesh, device, out_dtype=dtype)
        feats, counts, wall, _ = _counted(clock, lambda: fn(u8))
        torch.save(feats[:TP_IMAGES].cpu(), f"{out}.{key}{rank}.pt")
        clock.reset()
        ms = _event_ms(lambda: fn(u8), 3)
        res[key] = {"counts": counts, "ms": ms,
                    "collective_ms": clock.seconds * 1e3 / 3}
        del model, fn, feats
        torch.cuda.empty_cache()
    with open(f"{out}.rank{rank}.json", "w") as f:
        json.dump(res, f)


def _same_file(got_path: str, want: dict, names, what: str) -> dict:
    """Hold a feature file against ``want`` slide by slide: coords and labels
    equal; returns the features' worst |diff| and worst row cosine."""
    got = torch.load(got_path, weights_only=True)
    if sorted(got) != sorted(names):
        raise AssertionError(f"{what}: slides {sorted(got)} != {sorted(names)}")
    worst, cos = 0.0, 1.0
    for n in names:
        g, w = got[n], want[n]
        if not torch.equal(g["coords"], w["coords"]) \
                or int(g["label"]) != int(w["label"]) \
                or g["feat"].shape != w["feat"].shape \
                or g["feat"].dtype != torch.float16:
            raise AssertionError(f"{what}: {n} coords, label or shape differ")
        worst = max(worst, float((g["feat"].float()
                                  - w["feat"].float()).abs().max()))
        cos = min(cos, float(_row_cosine(g["feat"], w["feat"]).min()))
    return {"max_abs_diff": worst, "cosine_min": cos}


def _want_launches(got: dict, want: dict, what: str) -> None:
    for k, v in want.items():
        if got[k] != v:
            raise AssertionError(f"{what}: {k} launched {got[k]} times, "
                                 f"want {v} ({got})")


def _attention_f64(q, k, v, scale):
    """softmax(q k^T scale) v in float64: the function itself."""
    s = (q.double() @ k.double().transpose(-1, -2)) * scale
    return torch.softmax(s, dim=-1) @ v.double()


@torch.no_grad()
def vit_attn_b7_every_width(smi: str) -> dict:
    """(g): B7 at f32 and fp16 against its plain version over ``B7_DH`` x
    ``B7_N``, contiguous and on strided views of a packed qkv (f32 on the
    tf32x3 route at the tensor cores' head widths, fp16 on the mma route
    there, both on the fma route at the others); the TP block's calls; then
    B7 at f32 [256, 6, 197, 64] timed on the tf32x3 route and on the fma
    route (``_launch_fma``, its earlier route) beside the plain version and
    SDPA, device times from whole profiler windows (``_kernel_ms``)."""
    from acmil_tpu_torch.ops import vit_attn as va
    from acmil_tpu_torch.ops import vit_attn_packed as pk

    gen = torch.Generator(device="cuda").manual_seed(SEED + 22)
    worst, checks = {}, 0
    # f32, relative to the largest output: kernel against plain, kernel and
    # plain against float64 (the function itself), by route
    rel = {}
    for dtype in (torch.float32, torch.float16):
        tol = B7_F32_TOL if dtype == torch.float32 else B5_TOL
        for dh in B7_DH:
            for n in B7_N:
                base = 2 * torch.randn(2, n, 3, 2, dh, generator=gen,
                                       device="cuda")
                packed = base.to(dtype).permute(2, 0, 3, 1, 4)
                # the tensor cores' head widths take their route at each
                # dtype: tf32x3 at f32, mma at fp16
                route = ("fma" if dh not in va.KERNEL_HEAD_DIMS else
                         "tf32x3" if dtype == torch.float32 else "mma")
                for q, k, v in (packed, [t.contiguous() for t in packed]):
                    before = va.fused_vit_attention.route_launches[route]
                    got = va.fused_vit_attention(q, k, v, scale=0.3)
                    torch.cuda.synchronize()
                    if va.fused_vit_attention.route_launches[route] != \
                            before + 1:
                        raise AssertionError(f"B7 {dtype} dh={dh}: not the "
                                             f"{route} route")
                    key = (str(dtype)[6:], route)
                    want = va._reference_attention(q, k, v, 0.3)
                    worst[key] = max(worst.get(key, 0.0),
                                     _err(got, want, tol))
                    checks += 1
                    if dtype == torch.float32:
                        truth = _attention_f64(q, k, v, 0.3)
                        mx = float(truth.abs().max())
                        for what, a, b_ in (("plain", got, want),
                                            ("f64", got, truth),
                                            ("plain_f64", want, truth)):
                            e = float((a.double() - b_.double()).abs().max())
                            rel[(route, what)] = max(
                                rel.get((route, what), 0.0), e / mx)
    # the fma route where it still serves beside those: f32 rows off 16-byte
    # boundaries (a token stride of dh + 2), bf16 off the tensor cores'
    # widths
    for dtype, dh, pad in ((torch.float32, 64, 2), (torch.bfloat16, 48, 0),
                           (torch.bfloat16, 80, 0)):
        q, k, v = ((2 * torch.randn(2, 2, B7_N[0], dh + pad, generator=gen,
                                    device="cuda")).to(dtype)[..., :dh]
                   for _ in range(3))
        before = va.fused_vit_attention.route_launches["fma"]
        got = va.fused_vit_attention(q, k, v, scale=0.3)
        torch.cuda.synchronize()
        if va.fused_vit_attention.route_launches["fma"] != before + 1:
            raise AssertionError(f"B7 {dtype} dh={dh} pad={pad}: not the "
                                 f"fma route")
        key = (str(dtype)[6:], "fma")
        worst[key] = max(worst.get(key, 0.0), _err(
            got, va._reference_attention(q, k, v, 0.3),
            B7_F32_TOL if dtype == torch.float32 else B5_TOL))
        checks += 1
    print(f"kernel B7 vs plain: dh in {B7_DH}, N in {B7_N}, B=2 H=2, "
          f"contiguous and strided views of a packed qkv, scale 0.3, "
          f"tf32x3 route at f32 and mma at fp16 for dh in "
          f"{va.KERNEL_HEAD_DIMS}, fma elsewhere: {checks} shapes, "
          f"max_abs_err "
          + ", ".join(f"{dt} {rt} {e:.3e}" for (dt, rt), e in worst.items())
          + f"; and fma at f32 on rows off 16-byte boundaries, at bf16 at "
          f"dh 48 and 80 (tol f32 {B7_F32_TOL}, fp16 and bf16 {B5_TOL} of "
          f"the max) [{smi}]")
    print("kernel B7 at f32, worst relative to the largest output: "
          + ", ".join(f"{rt} against {w} {e:.3e}" for (rt, w), e in
                      rel.items()) + f" [{smi}]")

    # the TP block's own call at each path's shape: strided views of the
    # local qkv in, a token-major buffer's view out (parallel/tp.py), the
    # buffer NaN before the call
    n, dh = VIT_S16[0], 64
    tp_err = {}
    for tag, b, hl, dtype, route in TP_B7_CALLS:
        qkv = torch.randn(b, n, 3 * hl * dh, generator=gen,
                          device="cuda").to(dtype)
        q, k, v = qkv.view(b, n, 3, hl, dh).permute(2, 0, 3, 1, 4)
        buf = torch.full((b, n, hl * dh), float("nan"), dtype=dtype,
                         device="cuda")
        before = va.fused_vit_attention.route_launches[route]
        va.fused_vit_attention(q, k, v,
                               out=buf.view(b, n, hl, dh).transpose(1, 2))
        torch.cuda.synchronize()
        if va.fused_vit_attention.route_launches[route] != before + 1 \
                or not bool(torch.isfinite(buf).all()):
            raise AssertionError(f"B7 TP call {tag}: not the {route} route, "
                                 f"or the buffer not filled")
        tol = B7_F32_TOL if dtype == torch.float32 else B5_TOL
        tp_err[tag] = _err(buf.view(b, n, hl, dh).transpose(1, 2),
                           va._reference_attention(q, k, v), tol)
    print(f"kernel B7 vs plain on the TP block's call (strided q, k, v of a "
          f"packed local qkv, out a view of a token-major buffer): "
          + ", ".join(f"{tag} [{b}, {hl}, {n}, {dh}] {str(dt)[6:]} {route} "
                      f"{tp_err[tag]:.3e}"
                      for tag, b, hl, dt, route in TP_B7_CALLS)
          + f" (tol f32 {B7_F32_TOL}, bf16 {B5_TOL} of the max) [{smi}]")

    b, (n, d, heads) = STEP2_BATCH, VIT_S16
    dh = d // heads
    scale = 1.0 / math.sqrt(dh)
    q, k, v = (torch.randn(b, heads, n, dh, generator=gen, device="cuda")
               for _ in range(3))
    out = torch.empty_like(q)
    want = va._reference_attention(q, k, v)
    got = va.fused_vit_attention(q, k, v)
    if not torch.equal(got, va.fused_vit_attention(q, k, v)):
        raise AssertionError("B7's tf32x3 route: two launches differ")
    timed = {"tf32x3": _err(got, want, B7_F32_TOL),
             "fma": _err(pk._launch_fma(q, k, v, out, scale), want,
                         B7_F32_TOL)}
    calls = {"tf32x3": (lambda: va.fused_vit_attention(q, k, v),
                        pk.TF32X3_KERNELS[0]),
             "fma": (lambda: pk._launch_fma(q, k, v, out, scale),
                     B7_FMA_KERNELS[0])}
    shared = {"plain_ms": _time_ms(lambda: va._reference_attention(q, k, v),
                                   10),
              "library_ms": _time_ms(
                  lambda: torch.nn.functional.scaled_dot_product_attention(
                      q, k, v), 20),
              **_f32_bound(b * 4 * n * n * d, b * 4 * 4 * n * d)}
    res = {}
    for rt, (fn, kernel) in calls.items():
        dev = _kernel_ms(fn, {kernel: 1}, 20)
        res[rt] = {"ms": _time_ms(fn, 20),
                   "device_ms": None if dev is None else dev[kernel],
                   **shared, "max_abs_err_timed": timed[rt]}
        r = res[rt]
        print(f"kernel B7 {rt} route time: ViT-S/16 B={b} H={heads} N={n} "
              f"dh={dh} float32 (against its plain version "
              f"{timed[rt]:.3e}, tol {B7_F32_TOL} of the max): kernel "
              f"{r['ms']:.4f} ms (device {_fmt_ms(r['device_ms'])}), plain "
              f"{r['plain_ms']:.4f} ms, scaled_dot_product_attention f32 "
              f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}, f32 products at "
              f"{PEAK_TF32_FLOPS / 3e12:g} TFLOP/s: three TF32 products "
              f"each; at the f32 FMA rate {r['fma_bound_ms']:.4f} ms), "
              f"{_bound_share(r)} [{smi}]")
    if not res["tf32x3"]["ms"] <= res["tf32x3"]["library_ms"]:
        print(f"note: B7's tf32x3 route call {res['tf32x3']['ms']:.4f} ms is "
              f"slower than f32 SDPA's {res['tf32x3']['library_ms']:.4f} ms "
              f"in this run [{smi}]")
    tp = {rt: {c[0]: tp_err[c[0]] for c in TP_B7_CALLS if c[4] == rt}
          for rt in ("tf32x3", "mma")}
    res["tf32x3"].update({
        "max_abs_err": max(worst[("float32", "tf32x3")], timed["tf32x3"],
                           *tp["tf32x3"].values()),
        "rel_to_max": {f"{w}": e for (rt, w), e in rel.items()
                       if rt == "tf32x3"},
        "max_abs_err_tp_calls": tp["tf32x3"],
        "checks": checks + len(TP_B7_CALLS) + 2})
    res["fma"].update({
        "max_abs_err": max(worst[("float32", "fma")], timed["fma"]),
        "max_abs_err_fp16": worst[("float16", "fma")],
        "max_abs_err_bf16": worst[("bfloat16", "fma")],
        "max_abs_err_fp16_mma": worst[("float16", "mma")]})
    res["tp_calls_mma"] = tp["mma"]
    return res


def step2_mesh_run(smi: str, tmp: str, pipe: dict) -> dict:
    """Phase 22: Step2 on a (data, model) mesh of processes, each launch a
    torchrun of this script's ``--mesh-worker`` mode. (a) NCCL at world 1
    and (b) two gloo ranks at data 2, each file against phase 15's; (c)
    model 2 at ViT-S/16, (d) data 2 x model 2 at UNI, (e) GigaPath and (f)
    an f32 ViT-S/16 at model 2, against one process; (g) B7 against its
    plain version at every width, and timed at f32."""
    import warnings

    from acmil_tpu_torch.cli import step2_extract
    from acmil_tpu_torch.models.encoders.build import (encoder_feature_fn,
                                                       preprocess)
    from acmil_tpu_torch.models.encoders.fast import vit_encode
    from acmil_tpu_torch.wsi.tiling import load_coords_pt, save_coords_pt

    t_phase = time.perf_counter()
    root = os.path.join(tmp, "step2_mesh")
    os.makedirs(root)
    names = pipe["names"]
    want = torch.load(pipe["feat_path"], weights_only=True)
    one = {"B3": pipe["B3"], "B5": pipe["B5"]}

    def argv(tag, coords_dir=pipe["coords_dir"], batch=STEP2_BATCH,
             device="cuda", pretrain=("medical_ssl", "ViT-S/16")):
        return ["--slide_dir", pipe["slide_dir"], "--coords_dir", coords_dir,
                "--output_dir", os.path.join(root, tag), "--pretrain",
                pretrain[0], "--backbone", pretrain[1], "--batch_size",
                str(batch), "--label_csv", pipe["labels"], "--coords_format",
                "pt", "--out_format", "pt", "--device", device]

    out = {}
    # (a) NCCL at world size 1: the one-process file, the same launches
    (a,) = _torchrun(1, "step2_cli", os.path.join(root, "a"),
                     *argv("a", device="cuda"), "--mesh_data", "1")
    if a["backend"] != "nccl":
        raise AssertionError(f"(a) backend {a['backend']}")
    _want_launches(a["counts"], {**one, "B7_mma": 0, "B7_tf32x3": 0,
                                 "B7_fma": 0}, "(a)")
    diff_a = _same_file(a["out_path"], want, names, "(a)")
    if diff_a["max_abs_diff"] != 0.0:
        raise AssertionError(f"(a) features differ from one process: {diff_a}")
    out["a_nccl_world1"] = {"counts": a["counts"], "wall_s": a["wall_s"],
                            "launch_s": a["launch_s"]}
    print(f"step2 mesh (a): cli/step2_extract.py --mesh_data 1 under "
          f"torchrun, nccl, world 1, ViT-S/16 depth {STEP2_DEPTH} batch "
          f"{STEP2_BATCH} on phase 15's {len(names)} SPY slides: the file "
          f"equals the one-process file bit for bit; B3 {a['counts']['B3']} "
          f"B5' {a['counts']['B5']} as there; {a['wall_s']:.2f} s in main(), "
          f"{a['launch_s']:.2f} s the launch [{smi}]")

    # (b), (c), (e), (f): two gloo ranks on the card
    coords2 = os.path.join(root, "coords_two")
    os.makedirs(coords2)
    for n in names[:TP_SLIDES]:
        c, labels, attrs = load_coords_pt(os.path.join(pipe["coords_dir"],
                                                       f"{n}.pt"))
        save_coords_pt(os.path.join(coords2, f"{n}.pt"), c, attrs, labels)
    gloo_yml = os.path.join(root, "gloo.yml")
    with open(gloo_yml, "w") as f:
        f.write("dist_backend: gloo\n")      # several ranks on the one card
    gloo = ["--config", gloo_yml]
    params = {"b": argv("b", device="cuda:0") + ["--mesh_data", "2"] + gloo,
              "c": argv("c", coords2, TP_BATCH, "cuda:0")
              + ["--mesh_model", "2"] + gloo,
              "names": names, "slide_dir": pipe["slide_dir"],
              "coords_dir": pipe["coords_dir"]}
    params_path = os.path.join(root, "pair.json")
    with open(params_path, "w") as f:
        json.dump(params, f)
    pair = _torchrun(2, "step2_pair", os.path.join(root, "pair"), params_path)

    # (b) every rank reads and encodes half of every batch
    batches = sum(-(-v // STEP2_BATCH) for v in pair[0]["b"]["slides"].values())
    for r in pair:
        _want_launches(r["b"]["counts"], {**one, "B7_mma": 0}, f"(b) rank "
                       f"{r['rank']}")
    diff_b = _same_file(pair[0]["b"]["out_path"], want, names, "(b)")
    pps = pair[0]["b"]["patches"] / pair[0]["b"]["seconds"]

    def warm_rate(slides, seconds):
        # patches/s over the slides after the first, whose time holds the
        # process's first launches (the worker's card is cold)
        rest = [n for n in names[1:] if n in slides]
        return sum(slides[n] for n in rest) / sum(seconds[n] for n in rest)

    warm_b = warm_rate(pair[0]["b"]["slides"], pair[0]["b"]["slide_seconds"])
    warm_one = warm_rate(pipe["step2_slides"], pipe["step2_seconds"])
    out["b_data2"] = {"diff": diff_b, "patches_per_s": pps,
                      "patches_per_s_after_first": warm_b,
                      "one_process_patches_per_s_after_first": warm_one,
                      "read_ms": [r["b"]["read_ms"] for r in pair],
                      "collective_s": [r["b"]["collective_s"] for r in pair],
                      "counts": [r["b"]["counts"] for r in pair]}
    print(f"step2 mesh (b): --mesh_data 2, two gloo ranks on the card, same "
          f"slides: the file against the one-process file max |diff| "
          f"{diff_b['max_abs_diff']:.3e} (worst row cosine "
          f"{diff_b['cosine_min']:.7f}); B3 {[r['b']['counts']['B3'] for r in pair]} "
          f"a rank ({batches} batches of {STEP2_BATCH // 2} rows each); "
          f"{pps:.1f} patches/s, {warm_b:.1f} after the first slide "
          f"(phase 15's one process {warm_one:.1f}); each rank's "
          f"read+decode of its "
          f"{STEP2_BATCH // 2} rows of a batch "
          f"{[round(r['b']['read_ms'], 2) for r in pair]} ms (host), "
          f"{[round(r['b']['collective_s'], 3) for r in pair]} s in gloo "
          f"collectives [{smi}]")
    if diff_b["max_abs_diff"] != 0.0:
        raise AssertionError(f"(b) features differ from one process: "
                             f"{diff_b}")

    # (c) model 2 at ViT-S/16 against the one-process file
    two = names[:TP_SLIDES]
    batches_c = sum(-(-v // TP_BATCH) for v in pair[0]["c"]["slides"].values())
    for r in pair:
        _want_launches(r["c"]["counts"], {"B3": 0, "B5": 0, "B7_fma": 0,
                                          "B7_tf32x3": 0,
                                          "B7_mma": STEP2_DEPTH * batches_c},
                       f"(c) rank {r['rank']}")
    diff_c = _same_file(pair[0]["c"]["out_path"], want, two, "(c)")
    if diff_c["cosine_min"] < COS_MIN:
        raise AssertionError(f"(c) against one process: {diff_c}")
    span_c = [1e3 * r["c"]["seconds"] / batches_c for r in pair]
    coll_c = [1e3 * r["c"]["collective_s"] / batches_c for r in pair]
    calls_c = pair[0]["c"]["collective_calls"] / batches_c
    out["c_model2_vits"] = {"diff": diff_c, "batch_ms": span_c,
                            "collective_ms_a_batch": coll_c,
                            "collectives_a_batch": calls_c,
                            "collective_s": [r["c"]["collective_s"]
                                             for r in pair],
                            "B7": [r["c"]["counts"]["B7_mma"] for r in pair]}
    print(f"step2 mesh (c): --mesh_model 2 at ViT-S/16 (3 heads a rank), "
          f"depth {STEP2_DEPTH}, batch {TP_BATCH}, {TP_SLIDES} slides: worst "
          f"row cosine against the one-process file {diff_c['cosine_min']:.6f}, "
          f"max |diff| {diff_c['max_abs_diff']:.3e}; B7 (mma route) "
          f"{out['c_model2_vits']['B7']} a rank ({STEP2_DEPTH} x {batches_c} "
          f"batches); a batch {[round(s, 2) for s in span_c]} ms a rank "
          f"(host), of it {[round(c, 2) for c in coll_c]} ms in "
          f"{calls_c:.1f} gloo collectives (two all-reduces a layer of "
          f"[{TP_BATCH}, 197, 384] f32, {TP_BATCH * 197 * 384 * 4 / 1e6:.1f} "
          f"MB each) [{smi}]")

    # (e) GigaPath at full width, depth TP_GIGA_DEPTH, model 2
    u8 = _tp_images()
    model, spec = _tp_trunk("giga")
    ref = encoder_feature_fn(model, spec, torch.device("cuda"))(u8)
    del model
    torch.cuda.empty_cache()
    got = [torch.load(os.path.join(root, f"pair.e{r}.pt")).cuda()
           for r in range(2)]
    cos_e = float(_row_cosine(got[0], ref).min())
    if not torch.equal(got[0], got[1]) or cos_e < COS_MIN \
            or not bool(torch.isfinite(got[0]).all()):
        raise AssertionError(f"(e) GigaPath: ranks equal "
                             f"{torch.equal(got[0], got[1])}, cosine {cos_e}")
    for r in pair:
        _want_launches(r["e"]["counts"], {"B7_mma": TP_GIGA_DEPTH, "B5": 0},
                       f"(e) rank {r['rank']}")
    out["e_model2_gigapath"] = {
        "cosine_min": cos_e,
        "max_abs_diff": float((got[0].float() - ref.float()).abs().max()),
        "ms": [r["e"]["ms"] for r in pair],
        "collective_ms": [r["e"]["collective_ms"] for r in pair]}
    print(f"step2 mesh (e): GigaPath ViT-G/16 full width (SwiGLU halves split "
          f"on the hidden axis, 12 heads a rank), depth {TP_GIGA_DEPTH}, "
          f"{TP_IMAGES} images, model 2: worst row cosine against one process "
          f"(B5' + the MLP half) {cos_e:.6f}, max |diff| "
          f"{out['e_model2_gigapath']['max_abs_diff']:.3e}; B7 "
          f"{[r['e']['counts']['B7_mma'] for r in pair]} a rank; a batch "
          f"{[round(r['e']['ms'], 3) for r in pair]} ms (CUDA events), "
          f"{[round(r['e']['collective_ms'], 3) for r in pair]} ms of it in "
          f"gloo collectives [{smi}]")

    # (f) f32 ViT-S/16 through tp_encoder_feature_fn: B7's tf32x3 route
    model, spec = _tp_trunk("vits_f32")
    enc = model.encoder.cuda().eval()
    x = preprocess(torch.from_numpy(u8).cuda(), spec, torch.float32)
    with torch.no_grad():
        module = enc(x)
        encode = vit_encode({k: v for k, v in enc.state_dict().items()}, x,
                            patch=16, depth=STEP2_DEPTH, heads=6,
                            dtype=torch.float32, fused=False)
    got = [torch.load(os.path.join(root, f"pair.f{r}.pt")).cuda()
           for r in range(2)]
    scale = float(module.abs().max())
    rel_f = float((got[0] - module).abs().max()) / scale
    rel_encode = float((got[0] - encode).abs().max()) / scale
    if not torch.equal(got[0], got[1]) or not rel_f <= TP_F32_REL:
        raise AssertionError(f"(f) f32 TP against the module forward: "
                             f"{rel_f:.3e} of the max")
    for r in pair:
        _want_launches(r["f"]["counts"], {"B7_tf32x3": STEP2_DEPTH,
                                          "B7_fma": 0, "B7_mma": 0},
                       f"(f) rank {r['rank']}")
    out["f_model2_vits_f32"] = {"rel_to_module": rel_f,
                                "rel_to_vit_encode": rel_encode,
                                "ms": [r["f"]["ms"] for r in pair]}
    print(f"step2 mesh (f): ViT-S/16 at float32 through tp_encoder_feature_fn,"
          f" model 2, {TP_IMAGES} images: against the module forward at f32 "
          f"on the card {rel_f:.3e} of the largest feature (tol "
          f"{TP_F32_REL}); against vit_encode(fused=False) {rel_encode:.3e} "
          f"(its B3 route's gelu is tanh-approximate at every dtype); B7 "
          f"tf32x3 route {[r['f']['counts']['B7_tf32x3'] for r in pair]} a "
          f"rank; a batch "
          f"{[round(r['f']['ms'], 3) for r in pair]} ms [{smi}]")
    del model, enc, x, module, encode
    torch.cuda.empty_cache()

    # (d) UNI at data 2 x model 2 on four ranks against one process
    uni_dir = os.path.join(root, "coords_uni")
    os.makedirs(uni_dir)
    c, labels, attrs = load_coords_pt(os.path.join(pipe["coords_dir"],
                                                   f"{names[0]}.pt"))
    save_coords_pt(os.path.join(uni_dir, f"{names[0]}.pt"),
                   c[:TP_UNI_PATCHES], attrs,
                   None if labels is None else labels[:TP_UNI_PATCHES])
    uni = ("UNI", "ViT-L/16")
    clock = _CollectiveClock()
    with _UniSpec(), warnings.catch_warnings():
        warnings.simplefilter("ignore")        # no pretrain_weights: seeded
        res, counts_one, _, _ = _counted(clock, lambda: step2_extract.main(
            argv("uni_one", uni_dir, TP_UNI_BATCH, pretrain=uni)))
    clock.restore()
    batches_d = -(-TP_UNI_PATCHES // TP_UNI_BATCH)
    _want_launches(counts_one, {"B4": 24 * batches_d}, "(d) one process")
    want_uni = torch.load(res["out_path"], weights_only=True)
    ranks_d = _torchrun(4, "step2_cli", os.path.join(root, "d"),
                        *argv("uni_mesh", uni_dir, TP_UNI_BATCH, "cuda:0",
                              uni), "--mesh_data", "2", "--mesh_model", "2",
                        *gloo)
    for r in ranks_d:
        _want_launches(r["counts"], {"B4": 0, "B7_mma": 24 * batches_d},
                       f"(d) rank {r['rank']}")
    diff_d = _same_file(ranks_d[0]["out_path"], want_uni, [names[0]], "(d)")
    if diff_d["cosine_min"] < COS_MIN:
        raise AssertionError(f"(d) UNI against one process: {diff_d}")
    out["d_data2_model2_uni"] = {
        "diff": diff_d, "wall_s": [r["wall_s"] for r in ranks_d],
        "collective_s": [r["collective_s"] for r in ranks_d],
        "B7": [r["counts"]["B7_mma"] for r in ranks_d],
        "launch_s": ranks_d[0]["launch_s"]}
    print(f"step2 mesh (d): UNI ViT-L/16 full width and depth 24 (layerscale "
          f"{TP_LS}, random weights), data 2 x model 2 on four gloo ranks, "
          f"batch {TP_UNI_BATCH}, {TP_UNI_PATCHES} patches: worst row cosine "
          f"against one process (B4 + the f32 MLP half) "
          f"{diff_d['cosine_min']:.6f}, max |diff| "
          f"{diff_d['max_abs_diff']:.3e}; B7 {out['d_data2_model2_uni']['B7']} "
          f"a rank (24 x {batches_d} batches), B4 {counts_one['B4']} in one "
          f"process; {[round(r['wall_s'], 2) for r in ranks_d]} s in main() "
          f"a rank, {[round(r['collective_s'], 3) for r in ranks_d]} s of it "
          f"in gloo collectives [{smi}]")

    # (g) B7 against its plain version at every width; the f32 routes timed
    out["b7_f32"] = vit_attn_b7_every_width(smi)
    out["B7_mma_path"] = (sum(out["c_model2_vits"]["B7"])
                          + sum(out["d_data2_model2_uni"]["B7"])
                          + sum(r["e"]["counts"]["B7_mma"] for r in pair))
    out["B7_tf32x3_path"] = sum(r["f"]["counts"]["B7_tf32x3"] for r in pair)
    out["B7_fma_path"] = sum(r[tag]["counts"]["B7_fma"] for r in pair
                             for tag in ("c", "e", "f"))
    print(f"step2 mesh phase wall {time.perf_counter() - t_phase:.2f} s "
          f"[{smi}]")
    return out


# ---------------------------------------------------------------------------
# Phase 23: Step3's scanned epoch, each shape group's step a CUDA graph
# ---------------------------------------------------------------------------

# the cohort of bench.py's scan-epoch line: bags of clip(lognormal(log 3000,
# 0.7), 500, 20000) patches at D_feat 384, fp16, labels i % 2, min_bucket
# 1024, and its ACMIL recipe with 100 epochs scheduled
SCAN_BAGS, SCAN_VAL, SCAN_TEST = 242, 20, 20
SCAN_MIN_BUCKET = 1024
SCAN_LOADER_SEED = 4
# (f): the bags of the ABMIL and CLAM graph epochs; DSMIL's scanned eval on
# SCAN_DSMIL_BAGS bags of SCAN_DSMIL_N patches, whose bucket reaches
# FUSE_MIN_N, so that B6 replays in the graph
SCAN_SUB = 64
SCAN_DSMIL_BAGS, SCAN_DSMIL_N = 4, 65536
# the graph route against the eager scanned route: the same kernels on the
# same inputs in the same order, so bit for bit
SCAN_GRAPH_ATOL = 0.0
# (d): the share of a graph epoch's B1/B2 kernel events the tracer may
# lose (it loses a few of any route's, the eager route's included)
SCAN_PROFILER_LOST = 0.02


class _ListSrc:
    """In-RAM bags with the loader's source protocol."""

    def __init__(self, slides):
        self.items = [{"input": d["feat"], "coords": d["coords"],
                       "label": d["label"]} for d in slides.values()]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]

    def lengths(self):
        return [len(it["input"]) for it in self.items]


def _scan_cohort(n: int, seed: int) -> dict:
    """bench.py's recipe from ``RandomState(seed)``: its first 242 bags are
    bench.py's at seed 0, the rest drawn on from the same stream."""
    rs = np.random.RandomState(seed)
    slides = {}
    for i in range(n):
        m = int(np.clip(rs.lognormal(np.log(3000), 0.7), 500, 20000))
        slides[f"slide_{i:03d}"] = {
            "feat": rs.randn(m, D_FEAT).astype(np.float16),
            "coords": np.zeros((m, 2), np.int64), "label": i % 2}
    return slides


def _scan_conf(arch="ga", **kw):
    from acmil_tpu_torch.config import Config

    d = dict(n_class=2, D_feat=D_FEAT, D_inner=D_INNER, arch=arch,
             n_token=N_TOKEN, n_masked_patch=N_MASKED_PATCH,
             mask_drop=MASK_DROP, lr=1e-4, wd=1e-5, train_epoch=100,
             warmup_epoch=2, B=1, min_bucket=SCAN_MIN_BUCKET, seed=SEED)
    d.update(kw)
    return Config.from_dict(d)


def _counts() -> dict:
    from acmil_tpu_torch.engine.graphs import launch_counters

    return {k: f.launches for k, f in launch_counters().items()}


def _zero_counts() -> None:
    from acmil_tpu_torch.engine.graphs import launch_counters

    for f in launch_counters().values():
        f.launches = 0


def _sum_counts(*ds) -> dict:
    out = {}
    for d in ds:
        for k, v in d.items():
            out[k] = out.get(k, 0) + v
    return out


def _scan_cli(smi: str, tmp: str, slides: dict) -> dict:
    """(a) ``cli/step3_acmil.py --scan_epoch`` on the cohort's feature file,
    2 epochs with val and test: the graph route, printed once."""
    import contextlib
    import io

    from acmil_tpu_torch.cli import step3_acmil
    from acmil_tpu_torch.cli import train as train_cli

    data_dir, _, yml = _write_split_corpus(tmp, slides, YML, "medical_ssl",
                                           SCAN_BAGS, SCAN_VAL)
    ckpt_dir, log_dir = os.path.join(tmp, "ckpt"), os.path.join(tmp, "log")
    made = []
    real = (train_cli.make_scan_train_step, train_cli.make_scan_eval_step)
    train_cli.make_scan_train_step = lambda *a, **k: made.append(
        real[0](*a, **k)) or made[-1]
    train_cli.make_scan_eval_step = lambda *a, **k: made.append(
        real[1](*a, **k)) or made[-1]
    out = io.StringIO()
    _zero_counts()
    try:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            best = step3_acmil.main([
                "--config", yml, "--data_dir", data_dir, "--ckpt_dir",
                ckpt_dir, "--log_dir", log_dir, "--train_epoch", "2",
                "--n_token", str(N_TOKEN), "--n_masked_patch",
                str(N_MASKED_PATCH), "--mask_drop", str(MASK_DROP),
                "--min_bucket", str(SCAN_MIN_BUCKET), "--scan_epoch",
                "--device", "cuda"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        train_cli.make_scan_train_step, train_cli.make_scan_eval_step = real
    text = out.getvalue()
    routes = [ln for ln in text.splitlines() if ln.startswith("scan_epoch:")]
    if len(routes) != 1 or "graph route" not in routes[0]:
        raise AssertionError(f"the CLI's route lines: {routes}")
    warm = _counts()
    replayed = _sum_counts(*(m.kernel_launches() for m in made))
    steps, evals = 2 * SCAN_BAGS, 2 * (SCAN_VAL + SCAN_TEST)
    if replayed.get("B2") != steps or replayed.get("B1") != steps + evals:
        raise AssertionError(f"replayed launches {replayed}: want B2 {steps} "
                             f"and B1 {steps + evals}")
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        epochs = [r for r in map(json.loads, f) if "_config" not in r]
    vals = [r[k] for r in epochs for k in ("train/loss", "perf/val_loss",
                                           "perf/test_loss")]
    if len(epochs) != 2 or not all(map(math.isfinite, vals)):
        raise AssertionError(f"epochs {epochs}")
    for tag in ("best", "last"):
        if not os.path.isfile(os.path.join(ckpt_dir, f"checkpoint-{tag}.pth")):
            raise AssertionError(f"no checkpoint-{tag}.pth")
    total = _sum_counts(warm, replayed)
    print(f"scan (a): cli/step3_acmil.py --scan_epoch, 2 epochs x "
          f"{SCAN_BAGS} bags + {SCAN_VAL} val + {SCAN_TEST} test, "
          f"{wall:.2f} s wall; {routes[0]}; launches B1 {total['B1']}, B2 "
          f"{total['B2']} (replays {replayed['B1']}/{replayed['B2']}, "
          f"warm-ups {warm['B1']}/{warm['B2']}); train losses "
          f"{', '.join('%.6f' % r['train/loss'] for r in epochs)}; best "
          f"epoch {best.get('epoch')} val auc {best.get('auc', float('nan')):.4f} "
          f"[{smi}]")
    return total, {"data_dir": data_dir, "yml": yml, "ckpt_dir": ckpt_dir,
                   "best": best}


def _same_eval(got: dict, want: dict) -> bool:
    """Equal metrics; the loss, a mean over the bags taken in another
    order, to 1e-12 relative."""
    return got.keys() == want.keys() and all(
        math.isclose(got[k], want[k], rel_tol=1e-12) if k == "loss"
        else got[k] == want[k] or (math.isnan(got[k]) and math.isnan(want[k]))
        for k in got)


def _scan_timed(fn, device, export: bool = True) -> dict:
    """One epoch ``fn()`` timed (host span ending in a synchronise, and
    ``StepTimer``'s CUDA events), then one more under ``profile_trace``,
    the card's activity alone: its device busy time and its B1 row and B2
    weight-gradient kernels (one each a launch), and the idle share of the
    timed epoch. ``export=False`` profiles the same activity without
    writing its Chrome trace (seconds for an epoch's tens of thousands of
    events)."""
    from torch.profiler import ProfilerActivity, profile

    from acmil_tpu_torch.utils.profiling import (StepTimer, device_events,
                                                 profile_trace)

    timer = StepTimer(device)
    t0 = time.perf_counter()
    fn()
    event_s = timer.tick()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with tempfile.TemporaryDirectory() as trace_dir:
        with (profile_trace(trace_dir, device, cpu=False) if export else
              profile(activities=[ProfilerActivity.CUDA])) as prof:
            fn()
            torch.cuda.synchronize()
    events = device_events(prof)
    busy = sum(ms for _, ms in events)
    count = lambda k: sum(k in name for name, _ in events)
    return {"wall_ms": wall_ms, "event_ms": event_s * 1e3,
            "device_ms": busy, "idle": 1.0 - busy / wall_ms,
            "events": len(events), "b1_rows": count("b1_row_kernel"),
            "b2_wgrads": count("b2_wgrad_kernel")}


def _scan_routes(smi: str, slides: dict) -> dict:
    """(b)-(e) on the cohort: the graph route against the eager scanned
    route, the scanned eval against ``evaluate``, B1/B2 in the replays by
    the profiler's count, and the three routes' epochs timed."""
    from acmil_tpu_torch.data import BagLoader
    from acmil_tpu_torch.engine.graphs import take
    from acmil_tpu_torch.engine.train import (create_train_state, evaluate,
                                              evaluate_scanned,
                                              make_eval_step,
                                              make_scan_eval_step,
                                              make_scan_train_step,
                                              make_train_step,
                                              train_one_epoch,
                                              train_one_epoch_scanned)
    from acmil_tpu_torch.models import build_mil_model
    from acmil_tpu_torch.models.fast import acmil_ga_apply_batched

    dev = torch.device("cuda")
    conf = _scan_conf()
    src = _ListSrc(slides)
    kw = dict(min_bucket=SCAN_MIN_BUCKET, dtype=np.float16, device=dev)
    base = BagLoader(src, 1, shuffle=True, seed=SCAN_LOADER_SEED, **kw)
    t0 = time.perf_counter()
    groups = base.device_groups()
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    rng0 = copy.deepcopy(base.rng)

    def twin():
        loader = BagLoader(src, 1, shuffle=True, seed=SCAN_LOADER_SEED, **kw)
        loader._device_groups, loader.rng = groups, copy.deepcopy(rng0)
        return loader

    torch.manual_seed(SEED)
    model, family = build_mil_model(conf)
    model.to(dev)
    out = {"upload_s": upload_s,
           "buckets": {int(g.feats.shape[2]): int(g.label.shape[0])
                       for g in groups}}
    runs = {}
    for route in ("eager", "graph"):
        m = copy.deepcopy(model)
        state = create_train_state(m, conf, SCAN_BAGS, family=family)
        scan = make_scan_train_step(m, conf, family, route=route)
        loader = twin()
        torch.cuda.manual_seed(SEED)
        t0 = time.perf_counter()
        _, stats = train_one_epoch_scanned(state, scan, loader, 0)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        runs[route] = (m, state, stats, scan, loader, first_s)
    (m_e, st_e, s_e, _, l_e, _), (m_g, st_g, s_g, scan_g, l_g, first_g) = (
        runs["eager"], runs["graph"])
    diff = max(float((p - q).detach().abs().max()) for p, q in
               zip(m_g.parameters(), m_e.parameters()))
    if st_g.step != st_e.step or diff > SCAN_GRAPH_ATOL:
        raise AssertionError(f"graph route vs eager: step {st_g.step} vs "
                             f"{st_e.step}, max param diff {diff:.3e}")
    sums = {k: (s_g[k] * SCAN_BAGS, s_e[k] * SCAN_BAGS)
            for k in ("loss", "grad_norm")}
    if any(a != b for a, b in sums.values()):
        raise AssertionError(f"graph vs eager sums {sums}")
    graphs = scan_g.graphs
    by_key = {g.feats.data_ptr(): int(g.feats.shape[2]) for g in groups}
    capture = {by_key[k]: round(v * 1e3, 3) for k, v in
               graphs.capture_s.items()}
    pool = {by_key[k]: v for k, v in graphs.pool_bytes.items()}
    print(f"scan (b): one epoch of {SCAN_BAGS} bags in "
          f"{len(groups)} buckets {out['buckets']}, graph route vs eager "
          f"scanned route in one visit order: max param diff {diff:.3e} "
          f"(tolerance {SCAN_GRAPH_ATOL}), loss sums "
          f"{sums['loss'][0]:.9g} / {sums['loss'][1]:.9g}, grad_norm sums "
          f"{sums['grad_norm'][0]:.9g} / {sums['grad_norm'][1]:.9g}; "
          f"first graph epoch {first_g:.3f} s with warm-ups and captures "
          f"(capture ms by bucket {capture}, pool bytes by bucket {pool}) "
          f"[{smi}]")
    out.update(graph_vs_eager_max_diff=diff, capture_ms=capture,
               pool_bytes=pool, first_graph_epoch_s=first_g)

    # (c) the scanned eval, graph route, against evaluate and per bag
    eval_loader = BagLoader(src, 1, **kw)
    scan_eval = make_scan_eval_step(m_g, family, route="graph")
    step = make_eval_step(m_g, family)
    got = evaluate_scanned(scan_eval, eval_loader, conf.n_class)
    want = evaluate(step, BagLoader(src, 1, **kw), conf.n_class)
    worst = 0.0
    for stacked in eval_loader.device_groups():
        probs = scan_eval(stacked)
        for i in range(int(stacked.label.shape[0])):
            one = step(take(stacked, torch.tensor([i], device=dev)))
            worst = max(worst, float((probs[i] - one).abs().max()))
    if not _same_eval(got, want) or worst != 0.0:
        raise AssertionError(f"evaluate_scanned {got} vs evaluate {want}, "
                             f"largest probability difference {worst:.3e}")
    print(f"scan (c): evaluate_scanned (graph route) vs evaluate on "
          f"{SCAN_BAGS} bags: largest probability difference {worst:.3e}, "
          f"auc {got['auc']:.6f} = {want['auc']:.6f} [{smi}]")

    # (e): one more epoch of each route timed, one more profiled
    before = graphs.kernel_launches()
    epoch = iter(range(1, 3))
    t_graph = _scan_timed(lambda: train_one_epoch_scanned(
        st_g, scan_g, l_g, next(epoch)), dev)
    after = graphs.kernel_launches()
    per = {k: after[k] - before[k] for k in ("B1", "B2")}
    if per["B1"] != 2 * SCAN_BAGS or per["B2"] != 2 * SCAN_BAGS:
        raise AssertionError(f"replays of two epochs launched {per}")
    # (d): the tracer loses a kernel event now and then (one of 242 and one
    # of 32 b1_row_kernel in two runs, 3-4 of the eager route's 242, whose
    # wrapper counted every launch), so the count may fall short of
    # replays x launches per capture by SCAN_PROFILER_LOST of it, never more
    lost = {k: SCAN_BAGS - t_graph[k] for k in ("b1_rows", "b2_wgrads")}
    if not all(0 <= v <= max(1, SCAN_PROFILER_LOST * SCAN_BAGS)
               for v in lost.values()):
        raise AssertionError(
            f"the profiler saw {t_graph['b1_rows']} b1_row_kernel and "
            f"{t_graph['b2_wgrads']} b2_wgrad_kernel in one graph epoch; "
            f"replays x launches per capture = {SCAN_BAGS}")
    print(f"scan (d): one profiled graph epoch: {t_graph['b1_rows']} "
          f"b1_row_kernel and {t_graph['b2_wgrads']} b2_wgrad_kernel events "
          f"against {SCAN_BAGS} replays x 1 launch per capture (events the "
          f"tracer lost: {lost['b1_rows']}, {lost['b2_wgrads']}) [{smi}]")
    epoch = iter(range(1, 3))
    # the graph epoch's Chrome trace is written (profile_trace); the other
    # two are profiled alike without one
    t_eager = _scan_timed(lambda: train_one_epoch_scanned(
        st_e, runs["eager"][3], l_e, next(epoch)), dev, export=False)
    m_l = copy.deepcopy(model)
    st_l = create_train_state(m_l, conf, SCAN_BAGS, family=family)
    loop_step = make_train_step(m_l, conf, family)
    loop_loader = BagLoader(src, 1, shuffle=True, seed=SCAN_LOADER_SEED,
                            cache_device=True, **kw)
    train_one_epoch(st_l, loop_step, loop_loader, 0)       # uploads the bags
    epoch = iter(range(1, 3))
    t_loop = _scan_timed(lambda: train_one_epoch(st_l, loop_step,
                                                 loop_loader, next(epoch)),
                         dev, export=False)
    # STKIM's branch on the device: a step's forward and backward at the
    # most common bucket with the select (both branches) and with the
    # host's branch (one sync)
    bag = take(max(groups, key=lambda g: int(g.label.shape[0])),
               torch.tensor([0], device=dev))
    gen = torch.Generator(device=dev).manual_seed(SEED)
    m_x = copy.deepcopy(model)

    def fwd_bwd(on_device):
        sub, slide, _ = acmil_ga_apply_batched(
            m_x, bag.feats, bag.mask, stkim_generator=gen,
            n_masked_patch=N_MASKED_PATCH, mask_drop=MASK_DROP,
            stkim_on_device=on_device)
        (sub.sum() + slide.sum()).backward()

    stkim = {on: _event_ms(lambda: fwd_bwd(on), 20) for on in (True, False)}
    del m_x
    n_bucket = int(bag.feats.shape[1])
    routes = {"per-bag loop": t_loop, "eager scanned": t_eager,
              "graph": t_graph}
    for name, t in routes.items():
        print(f"scan (e): {name} epoch of {SCAN_BAGS} bags: wall "
              f"{t['wall_ms']:.3f} ms (CUDA events {t['event_ms']:.3f} ms), "
              f"device busy {t['device_ms']:.3f} ms in {t['events']} device "
              f"events, idle {100 * t['idle']:.1f}%, "
              f"{t['wall_ms'] / SCAN_BAGS:.4f} ms a bag [{smi}]")
    print(f"scan (e): STKIM's branch on the device at N={n_bucket}: forward "
          f"+ backward {stkim[True]:.4f} ms with both branches selected on "
          f"the device, {stkim[False]:.4f} ms with the host's branch and its "
          f"sync (+{stkim[True] - stkim[False]:.4f} ms) [{smi}]")
    out.update(epochs={k: {kk: round(vv, 4) if isinstance(vv, float) else vv
                           for kk, vv in v.items()}
                       for k, v in routes.items()},
               stkim_select_ms=stkim[True], stkim_host_ms=stkim[False],
               stkim_n=n_bucket,
               launches_graph=graphs.kernel_launches())
    return out


def _scan_heads(smi: str, slides: dict) -> dict:
    """(f) ABMIL, CLAM_SB and CLAM_MB: one graph epoch on the first
    ``SCAN_SUB`` bags against their eager scanned epoch; DSMIL's scanned
    eval on bags of ``SCAN_DSMIL_N`` patches (B6 in the graph) against
    ``evaluate``."""
    from acmil_tpu_torch.data import BagLoader
    from acmil_tpu_torch.engine.train import (create_train_state, evaluate,
                                              evaluate_scanned,
                                              make_eval_step,
                                              make_scan_eval_step,
                                              make_scan_train_step,
                                              train_one_epoch_scanned)
    from acmil_tpu_torch.models import build_mil_model, fast

    dev = torch.device("cuda")
    names = sorted(slides)[:SCAN_SUB]
    src = _ListSrc({n: slides[n] for n in names})
    kw = dict(min_bucket=SCAN_MIN_BUCKET, dtype=np.float16, device=dev)
    out = {}
    for arch in ("abmil", "clam_sb", "clam_mb"):
        conf = _scan_conf(arch)
        torch.manual_seed(SEED)
        model, family = build_mil_model(conf)
        model.to(dev)
        res = {}
        for route in ("eager", "graph"):
            m = copy.deepcopy(model)
            state = create_train_state(m, conf, SCAN_SUB, family=family)
            scan = make_scan_train_step(m, conf, family, route=route)
            loader = BagLoader(src, 1, shuffle=True, seed=SCAN_LOADER_SEED,
                               **kw)
            torch.cuda.manual_seed(SEED)
            t0 = time.perf_counter()
            _, stats = train_one_epoch_scanned(state, scan, loader, 0)
            torch.cuda.synchronize()
            res[route] = (m, stats, time.perf_counter() - t0)
        diff = max(float((p - q).detach().abs().max()) for p, q in zip(
            res["graph"][0].parameters(), res["eager"][0].parameters()))
        if diff > SCAN_GRAPH_ATOL or res["graph"][1] != res["eager"][1]:
            raise AssertionError(f"{arch}: graph vs eager max param diff "
                                 f"{diff:.3e}, stats {res['graph'][1]} vs "
                                 f"{res['eager'][1]}")
        out[arch] = {"max_param_diff": diff,
                     "loss": res["graph"][1]["loss"],
                     "graph_epoch_s": res["graph"][2],
                     "eager_epoch_s": res["eager"][2]}
        print(f"scan (f): {arch} one epoch of {SCAN_SUB} bags, graph vs "
              f"eager scanned: max param diff {diff:.3e}, loss "
              f"{res['graph'][1]['loss']:.6f}; first epochs "
              f"{res['graph'][2]:.3f} s (with captures) / "
              f"{res['eager'][2]:.3f} s [{smi}]")
    rs = np.random.RandomState(SEED + 23)
    big = {f"dsmil_{i}": {
        "feat": rs.randn(SCAN_DSMIL_N - 7 * i, D_FEAT).astype(np.float16),
        "coords": np.zeros((SCAN_DSMIL_N - 7 * i, 2), np.int64),
        "label": i % 2} for i in range(SCAN_DSMIL_BAGS)}
    conf = _scan_conf("dsmil")
    torch.manual_seed(SEED)
    model, family = build_mil_model(conf)
    model.to(dev)
    src = _ListSrc(big)
    scan_eval = make_scan_eval_step(model, family, route="graph")
    from acmil_tpu_torch.ops import dsmil_pool

    before = dsmil_pool.fused_dsmil_pool.launches
    got = evaluate_scanned(scan_eval, BagLoader(src, 1, **kw), conf.n_class)
    warm = dsmil_pool.fused_dsmil_pool.launches - before
    want = evaluate(make_eval_step(model, family), BagLoader(src, 1, **kw),
                    conf.n_class)
    replayed = scan_eval.kernel_launches().get("B6", 0)
    if int(SCAN_DSMIL_N) < fast.FUSE_MIN_N or replayed != SCAN_DSMIL_BAGS:
        raise AssertionError(f"B6 replays {replayed}, want {SCAN_DSMIL_BAGS}")
    diff = abs(got["loss"] - want["loss"])
    if not _same_eval(got, want):
        raise AssertionError(f"dsmil evaluate_scanned {got} vs evaluate {want}")
    print(f"scan (f): dsmil scanned eval (graph) of {SCAN_DSMIL_BAGS} bags "
          f"of ~{SCAN_DSMIL_N} patches vs evaluate: metrics equal (loss diff "
          f"{diff:.3e}); B6 replays {replayed} (1 launch per capture), "
          f"warm-up launches {warm} [{smi}]")
    out["dsmil_eval"] = {"B6_replays": replayed, "B6_warm": warm,
                         "loss": got["loss"]}
    return out


# (g): every family the JAX package scans, one graph epoch against one eager
# scanned epoch on the first SCAN_FAMILY_SUB bags of the cohort (SAM and
# DTFD, whose steps run the kernels; SCAN_LIGHT_SUB for the Nystrom heads,
# MHIM, its pure stage, TransMIL and the plain heads): ACMIL_GA and DSMIL
# with SAM (B1/B2 twice a step on ga), DTFD through B1/B2 (DTFD_FUSE_MIN_S
# pinned to 0) and on its default plain route, pure then mhim with that
# pure model as its teacher, TransMIL and the twelve plain heads. Half and
# a quarter of (f)'s SCAN_SUB keep the whole script inside its time limit:
# on an H100 (700 W) it took 1149 s of its 1200 with (g) at 64 and 32
# bags, 158.8 s of them in (g)
SCAN_FAMILY_SUB, SCAN_LIGHT_SUB = 32, 16
SCAN_PLAIN_HEADS = ("mha_single", "meanmil", "maxmil", "lbmil", "attmil",
                    "attmil_gated", "ilra", "ips", "ibmil", "bmil_vis",
                    "bmil_enc", "bmil_spvis")
SCAN_FAMILY_CASES = (("ga+sam", "dsmil+sam", "dtfd+fused", "dtfd", "pure",
                      "mhim", "transmil") + SCAN_PLAIN_HEADS)
# (g): the heads whose loop, eager scanned and graph epochs are timed
SCAN_TIMED = ("ga+sam", "dtfd+fused", "mhim", "transmil", "ilra")
# (g): the SAM and MHIM CLIs' val and test bags
SCAN_CLI_EVAL = 4


def _family_conf(case: str):
    """``case`` is an arch with options: ``+sam`` (use_sam), ``+fused``
    (DTFD without dropout, through B1/B2 where DTFD_FUSE_MIN_S routes)."""
    arch, *opts = case.split("+")
    kw = dict(use_sam="sam" in opts)
    if arch in ("pure", "mhim"):
        # the MHIM script's stage B (MHIM_STAGE_B), its defaults otherwise
        kw.update(mlp_dim=512, baseline="selfattn", dropout=0.25,
                  steps_per_epoch=SCAN_LIGHT_SUB)
        if arch == "mhim":
            kw.update(mask_ratio_h=0.1, mask_ratio_hr=0.5, mm_sche=True,
                      mrh_sche=True)
    if arch == "dtfd":
        kw.update(numGroup=4, total_instance=4,
                  droprate=0.0 if "fused" in opts else 0.25)
    return _scan_conf(arch, **kw)


def _family_sub(case: str) -> int:
    return (SCAN_FAMILY_SUB if case.split("+")[0] in ("ga", "dsmil", "dtfd")
            else SCAN_LIGHT_SUB)


def _graph_vs_eager(smi: str, case: str, slides: dict, teacher=None) -> dict:
    """One eager scanned epoch and one graph epoch of ``case`` on the first
    bags of ``slides``, from the same weights (``teacher``: the EMA
    teacher's start) in one visit order: parameters, teacher and sums bit
    for bit; the replays' B1/B2 launches equal one capture's times the
    steps."""
    from acmil_tpu_torch.data import BagLoader
    from acmil_tpu_torch.engine.train import (create_train_state,
                                              make_scan_train_step,
                                              scan_route,
                                              train_one_epoch_scanned)
    from acmil_tpu_torch.models import build_mil_model

    dev = torch.device("cuda")
    conf = _family_conf(case)
    n = _family_sub(case)
    route, why = scan_route(conf, dev)
    if route != "graph":
        raise AssertionError(f"{case}: scan_route gives {route} ({why})")
    names = sorted(slides)[:n]
    src = _ListSrc({k: slides[k] for k in names})
    kw = dict(min_bucket=SCAN_MIN_BUCKET, dtype=np.float16, device=dev)
    torch.manual_seed(SEED)
    model, family = build_mil_model(conf)
    model.to(dev)
    runs = {}
    for route in ("eager", "graph"):
        m = copy.deepcopy(model)
        state = create_train_state(m, conf, n, family=family)
        if teacher is not None:
            state.teacher.load_state_dict(teacher)
        scan = make_scan_train_step(m, conf, family, route=route)
        loader = BagLoader(src, 1, shuffle=True, seed=SCAN_LOADER_SEED, **kw)
        torch.cuda.manual_seed(SEED)
        _zero_counts()
        t0 = time.perf_counter()
        _, stats = train_one_epoch_scanned(state, scan, loader, 0)
        torch.cuda.synchronize()
        runs[route] = dict(model=m, state=state, stats=stats, scan=scan,
                           loader=loader, seconds=time.perf_counter() - t0,
                           counted=_counts())
    e, g = runs["eager"], runs["graph"]
    pairs = list(zip(g["model"].parameters(), e["model"].parameters()))
    if conf.arch == "mhim":
        pairs += list(zip(g["state"].teacher.parameters(),
                          e["state"].teacher.parameters()))
    diff = max(float((p - q).detach().abs().max()) for p, q in pairs)
    if (diff > SCAN_GRAPH_ATOL or g["stats"] != e["stats"]
            or g["state"].step != e["state"].step != n):
        raise AssertionError(f"{case}: graph vs eager max param diff "
                             f"{diff:.3e}, steps {g['state'].step}/"
                             f"{e['state'].step}, stats {g['stats']} vs "
                             f"{e['stats']}")
    graphs = g["scan"].graphs
    replayed = graphs.kernel_launches()
    per_step = 0
    if conf.arch == "ga" or case == "dtfd+fused":
        per_step = 2 if conf.use_sam else 1
    per_capture = {k: sorted({v[k] for v in graphs.per_replay.values()})
                   for k in ("B1", "B2")}
    if (sum(graphs.replays.values()) != n
            or any(per_capture[k] != [per_step] for k in ("B1", "B2"))
            or replayed.get("B1") != per_step * n
            or replayed.get("B2") != per_step * n
            or e["counted"].get("B1") != per_step * n
            or e["counted"].get("B2") != per_step * n):
        raise AssertionError(f"{case}: per capture {per_capture}, replays "
                             f"{graphs.replays}, launched {replayed}, eager "
                             f"{e['counted']}: want {per_step} a step")
    out = {"bags": n, "groups": len(graphs.replays), "max_param_diff": diff,
           "loss": g["stats"]["loss"], "launches": replayed,
           "b1_b2_per_replay": per_step,
           "capture_ms": round(1e3 * sum(graphs.capture_s.values()), 3),
           "pool_bytes": sum(graphs.pool_bytes.values()),
           "graph_epoch_s": g["seconds"], "eager_epoch_s": e["seconds"]}
    print(f"scan (g): {case} one epoch of {n} bags in {out['groups']} "
          f"buckets, graph vs eager scanned: max param diff {diff:.3e}"
          f"{' (teacher included)' if conf.arch == 'mhim' else ''}, loss "
          f"{out['loss']:.6f}; B1/B2 {per_step} a replay, replays launched "
          f"B1 {replayed.get('B1')} B2 {replayed.get('B2')}; first epochs "
          f"{g['seconds']:.3f} s (warm-ups and captures "
          f"{out['capture_ms']:.1f} ms of capture) / {e['seconds']:.3f} s "
          f"[{smi}]")
    return out, runs, src


def _family_cli(smi: str, tmp: str, slides: dict, module, tag: str,
                yml: str, argv: list) -> dict:
    """``module.main`` (a Step3 CLI) with ``--scan_epoch`` and the config
    ``yml`` for 2 epochs on the first SCAN_FAMILY_SUB bags (SCAN_CLI_EVAL
    val and test): the graph route, printed once; the launches of B1/B2 by
    the replays and outside them."""
    import contextlib
    import io

    from acmil_tpu_torch.cli import train as train_cli

    names = sorted(slides)[:SCAN_FAMILY_SUB + 2 * SCAN_CLI_EVAL]
    root = os.path.join(tmp, tag)
    os.makedirs(root)
    data_dir, _, yml = _write_split_corpus(
        root, {k: slides[k] for k in names}, yml, "medical_ssl",
        SCAN_FAMILY_SUB, SCAN_CLI_EVAL)
    name = f"cli/{module.__name__.rsplit('.', 1)[-1]}.py {' '.join(argv)}"
    made = []
    real = (train_cli.make_scan_train_step, train_cli.make_scan_eval_step)
    train_cli.make_scan_train_step = lambda *a, **k: made.append(
        real[0](*a, **k)) or made[-1]
    train_cli.make_scan_eval_step = lambda *a, **k: made.append(
        real[1](*a, **k)) or made[-1]
    out = io.StringIO()
    _zero_counts()
    try:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            module.main(["--config", yml, "--data_dir", data_dir,
                         "--ckpt_dir", os.path.join(root, "ckpt"),
                         "--log_dir", os.path.join(root, "log"),
                         "--train_epoch", "2", "--min_bucket",
                         str(SCAN_MIN_BUCKET), "--scan_epoch",
                         "--device", "cuda"] + argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        train_cli.make_scan_train_step, train_cli.make_scan_eval_step = real
    routes = [ln for ln in out.getvalue().splitlines()
              if ln.startswith("scan_epoch:")]
    if len(routes) != 1 or "graph route" not in routes[0]:
        raise AssertionError(f"{name}: the CLI's route lines {routes}")
    with open(os.path.join(root, "log", "metrics.jsonl")) as f:
        epochs = [r for r in map(json.loads, f) if "_config" not in r]
    if len(epochs) != 2 or not all(math.isfinite(r["train/loss"])
                                   for r in epochs):
        raise AssertionError(f"{name}: epochs {epochs}")
    warm = _counts()
    replayed = _sum_counts(*(m.kernel_launches() for m in made))
    print(f"scan (g): {name} ({tag}), 2 epochs x {SCAN_FAMILY_SUB} bags + "
          f"{SCAN_CLI_EVAL} val + {SCAN_CLI_EVAL} test, {wall:.2f} s wall; "
          f"{routes[0]}; replays launched B1 {replayed.get('B1', 0)} B2 "
          f"{replayed.get('B2', 0)}, warm-ups B1 {warm['B1']} B2 "
          f"{warm['B2']}; train losses "
          f"{', '.join('%.6f' % r['train/loss'] for r in epochs)} [{smi}]")
    return {"wall_s": wall, "route": routes[0], "replayed": replayed,
            "warm": warm, "launches": _sum_counts(warm, replayed)}


def _family_timed(smi: str, case: str, runs: dict, src) -> dict:
    """One more epoch of the graph and eager scanned routes of
    :func:`_graph_vs_eager`'s ``runs`` and of the per-bag loop over the same
    bags, each timed then profiled (:func:`_scan_timed`)."""
    from acmil_tpu_torch.data import BagLoader
    from acmil_tpu_torch.engine.train import (create_train_state,
                                              make_train_step,
                                              train_one_epoch,
                                              train_one_epoch_scanned)
    from acmil_tpu_torch.models import build_mil_model

    dev = torch.device("cuda")
    out = {}
    for route in ("graph", "eager"):
        r = runs[route]
        epoch = iter(range(1, 3))
        out[route] = _scan_timed(lambda: train_one_epoch_scanned(
            r["state"], r["scan"], r["loader"], next(epoch)), dev,
            export=False)
    conf = _family_conf(case)
    torch.manual_seed(SEED)
    model, family = build_mil_model(conf)
    model.to(dev)
    n = len(src)
    state = create_train_state(model, conf, n, family=family)
    step = make_train_step(model, conf, family)
    loader = BagLoader(src, 1, shuffle=True, seed=SCAN_LOADER_SEED,
                       cache_device=True, min_bucket=SCAN_MIN_BUCKET,
                       dtype=np.float16, device=dev)
    train_one_epoch(state, step, loader, 0)            # uploads the bags
    epoch = iter(range(1, 3))
    out["loop"] = _scan_timed(lambda: train_one_epoch(state, step, loader,
                                                      next(epoch)), dev,
                              export=False)
    for name, key in (("per-bag loop", "loop"), ("eager scanned", "eager"),
                      ("graph", "graph")):
        t = out[key]
        print(f"scan (g): {case} {name} epoch of {n} bags: wall "
              f"{t['wall_ms']:.3f} ms (CUDA events {t['event_ms']:.3f} ms), "
              f"device busy {t['device_ms']:.3f} ms in {t['events']} device "
              f"events, idle {100 * t['idle']:.1f}%, "
              f"{t['wall_ms'] / n:.4f} ms a bag [{smi}]")
    return {k: {kk: round(vv, 4) if isinstance(vv, float) else vv
                for kk, vv in v.items()} for k, v in out.items()}


def _scan_families(smi: str, tmp: str, slides: dict) -> dict:
    """(g) every family the JAX package scans, on the graph route: each
    case of SCAN_FAMILY_CASES against its eager scanned epoch; DSMIL's
    scanned eval after its SAM run, B6 in the graph; the SAM and MHIM CLIs;
    loop, eager and graph epochs timed for SCAN_TIMED."""
    from acmil_tpu_torch.cli import step3_acmil, step3_mhim
    from acmil_tpu_torch.data import BagLoader
    from acmil_tpu_torch.engine.train import (evaluate, evaluate_scanned,
                                              make_eval_step,
                                              make_scan_eval_step)
    from acmil_tpu_torch.models import fast
    from acmil_tpu_torch.ops import dsmil_pool

    t0 = time.perf_counter()
    out = {"cases": {}, "timed": {}}
    pure = None
    for case in SCAN_FAMILY_CASES:
        pinned = fast.DTFD_FUSE_MIN_S
        if case == "dtfd+fused":
            fast.DTFD_FUSE_MIN_S = 0
        try:
            res, runs, src = _graph_vs_eager(
                smi, case, slides,
                teacher=pure if case == "mhim" else None)
            if case in SCAN_TIMED:
                out["timed"][case] = _family_timed(smi, case, runs, src)
        finally:
            fast.DTFD_FUSE_MIN_S = pinned
        if case == "pure":
            pure = copy.deepcopy(runs["graph"]["model"].state_dict())
        if case == "dsmil+sam":
            dsmil = runs["graph"]
        out["cases"][case] = res
        del runs
    out["cases_s"] = time.perf_counter() - t0

    # DSMIL's scanned eval after its SAM graph epoch, on the route of its
    # train step: B6 in the graph, against evaluate
    rs = np.random.RandomState(SEED + 23)
    big = {f"dsmil_{i}": {
        "feat": rs.randn(SCAN_DSMIL_N - 7 * i, D_FEAT).astype(np.float16),
        "coords": np.zeros((SCAN_DSMIL_N - 7 * i, 2), np.int64),
        "label": i % 2} for i in range(SCAN_DSMIL_BAGS)}
    kw = dict(min_bucket=SCAN_MIN_BUCKET, dtype=np.float16,
              device=torch.device("cuda"))
    model, route = dsmil["model"], dsmil["scan"].route
    scan_eval = make_scan_eval_step(model, "dsmil", route=route)
    before = dsmil_pool.fused_dsmil_pool.launches
    got = evaluate_scanned(scan_eval, BagLoader(_ListSrc(big), 1, **kw), 2)
    warm = dsmil_pool.fused_dsmil_pool.launches - before
    want = evaluate(make_eval_step(model, "dsmil"),
                    BagLoader(_ListSrc(big), 1, **kw), 2)
    replayed = scan_eval.kernel_launches().get("B6", 0)
    if route != "graph" or replayed != SCAN_DSMIL_BAGS \
            or not _same_eval(got, want):
        raise AssertionError(f"dsmil+sam eval on the {route} route: B6 "
                             f"replays {replayed}, {got} vs {want}")
    print(f"scan (g): dsmil after its SAM graph epoch, scanned eval (graph) "
          f"of {SCAN_DSMIL_BAGS} bags of ~{SCAN_DSMIL_N} patches vs "
          f"evaluate: metrics equal (loss {got['loss']:.6f}); B6 replays "
          f"{replayed} (1 launch per capture), warm-up launches {warm} "
          f"[{smi}]")
    out["sam_eval"] = {"B6_replays": replayed, "B6_warm": warm,
                       "loss": got["loss"]}
    del dsmil, model, scan_eval

    t1 = time.perf_counter()
    sam_yml = os.path.join(tmp, "sam.yml")
    with open(YML) as src_f, open(sam_yml, "w") as dst:
        dst.write(src_f.read() + "\nuse_sam: true\n")
    out["cli_sam"] = _family_cli(smi, tmp, slides, step3_acmil, "cli_sam",
                                 sam_yml, ["--n_token", str(N_TOKEN),
                                           "--n_masked_patch",
                                           str(N_MASKED_PATCH), "--mask_drop",
                                           str(MASK_DROP)])
    steps = 2 * SCAN_FAMILY_SUB
    evals = 2 * 2 * SCAN_CLI_EVAL
    rep = out["cli_sam"]["replayed"]
    if rep.get("B2") != 2 * steps or rep.get("B1") != 2 * steps + evals:
        raise AssertionError(f"the SAM CLI's replays launched {rep}: want "
                             f"B2 {2 * steps} and B1 {2 * steps + evals}")
    out["cli_mhim"] = _family_cli(smi, tmp, slides, step3_mhim, "cli_mhim",
                                  YML, ["--model", "mhim", *MHIM_STAGE_B])
    out["cli_s"] = time.perf_counter() - t1
    # the graphs, their pools and the warm states hold the card's memory
    # until their reference cycles are collected; phase 25's ranks share
    # the card
    gc.collect()
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    return out


def scan_epoch_run(smi: str, tmp: str) -> dict:
    """Phase 23: Step3's scanned epoch on the card (a)-(g)."""
    t0 = time.perf_counter()
    slides = _scan_cohort(SCAN_BAGS + SCAN_VAL + SCAN_TEST, SEED)
    cohort = {k: slides[k] for k in sorted(slides)[:SCAN_BAGS]}
    made_s = time.perf_counter() - t0
    root = os.path.join(tmp, "scan")
    os.makedirs(root)
    t1 = time.perf_counter()
    cli, out_cli = _scan_cli(smi, root, slides)
    t2 = time.perf_counter()
    out = _scan_routes(smi, cohort)
    t3 = time.perf_counter()
    out["heads"] = _scan_heads(smi, cohort)
    t4 = time.perf_counter()
    out["families"] = _scan_families(smi, root, cohort)
    out["part_s"] = {"cohort": t1 - t0, "cli": t2 - t1, "routes": t3 - t2,
                     "heads": t4 - t3, "families": time.perf_counter() - t4}
    out["launches_cli"] = cli
    out["cli_run"] = out_cli
    out["cohort_s"] = made_s
    out["seconds"] = time.perf_counter() - t0
    print(f"scan: phase 23 in {out['seconds']:.1f} s (by part "
          f"{ {k: round(v, 1) for k, v in out['part_s'].items()} }) [{smi}]")
    return out


# ---------------------------------------------------------------------------
# Phase 25: Step3's scanned epoch on a (data, seq) mesh of processes
# ---------------------------------------------------------------------------

# (b)-(d): the scanned mesh epoch against the per-bag mesh loop in its visit
# order with the same draws. The scanned route on a card takes its rate
# from the device and steps a capturable AdamW, the loop the host's rate:
# parameters within lr a step (shift-invariant biases move by rounding
# noise alone), the mean loss and gradient norm to the bounds of the JAX
# comparison (tests/test_torch_scan_epoch.py)
SCAN_MESH_LOSS_RTOL, SCAN_MESH_GNORM_RTOL = 1e-4, 1e-3
# (c): ACMIL_GA at data 2 x seq 2 on the first SCAN_SUB bags of the cohort


def _scan_src(feats_path: str, n: int):
    """The first ``n`` bags of phase 23's cohort, from its feature file."""
    from acmil_tpu_torch.data.ptio import PtBagSource

    names = sorted(torch.load(feats_path, map_location="cpu", mmap=True,
                              weights_only=True))[:n]
    return PtBagSource(feats_path, names)


def _params_diff(a, b) -> float:
    return max(float((p - q).detach().abs().max())
               for p, q in zip(a.parameters(), b.parameters()))


def _rank_spread(model, mesh) -> float:
    """The largest difference of this rank's parameters from global rank
    0's."""
    from acmil_tpu_torch.parallel import collectives as C

    worst = 0.0
    with torch.no_grad():
        for p in model.parameters():
            q = C.broadcast_(p.detach().clone(), 0, mesh.world_group)
            worst = max(worst, float((p - q).abs().max()))
    return worst


def _scan_vs_loop(mesh, conf, src, device, batch: int) -> dict:
    """One scanned epoch of ACMIL_GA on ``mesh`` (``batch`` slides a batch)
    and the per-bag mesh loop (``train_one_epoch``) fed its visit order from
    the same weights and generator: each timed, its gloo collectives and
    its B1/B2 launches counted."""
    from acmil_tpu_torch.data import BagLoader
    from acmil_tpu_torch.engine.graphs import take
    from acmil_tpu_torch.engine.train import (create_train_state,
                                              make_scan_train_step,
                                              make_train_step,
                                              train_one_epoch,
                                              train_one_epoch_scanned)
    from acmil_tpu_torch.models import build_mil_model
    from acmil_tpu_torch.parallel import shard_params

    torch.manual_seed(SEED)
    model, fam = build_mil_model(conf, mesh=mesh)
    model.to(device)
    shard_params(model, mesh)
    twin = copy.deepcopy(model)
    loader = BagLoader(src, batch, shuffle=True, drop_last=True,
                       seed=SCAN_LOADER_SEED, min_bucket=SCAN_MIN_BUCKET,
                       dtype=np.float16, device=device, mesh=mesh)
    t0 = time.perf_counter()
    groups = loader.device_groups()
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    state = create_train_state(model, conf, len(loader), family=fam)
    scan = make_scan_train_step(model, conf, fam, mesh=mesh)
    seen = []

    def recording(st, stacked, chunk, gs):
        seen.append((stacked, [int(i) for i in chunk]))
        return scan(st, stacked, chunk, gs)

    # one throwaway step of each route first, on copies: the process's
    # first launches (modules loaded, gloo's pairs opened) stay out of the
    # timed epochs
    bag0 = take(groups[0], torch.tensor([0], device=device))
    for make in (make_scan_train_step, make_train_step):
        warm = copy.deepcopy(model)
        w_state = create_train_state(warm, conf, len(loader), family=fam)
        w_step = make(warm, conf, fam, mesh=mesh)
        if make is make_train_step:
            w_step(w_state, bag0)
        else:
            w_step(w_state, groups[0], [0], groups)
        del warm, w_state, w_step
    torch.cuda.synchronize()
    clock = _CollectiveClock()
    res = {"route": scan.route, "reason": scan.reason, "upload_s": upload_s,
           "groups": len(groups), "rank": mesh.rank}
    for name in ("scan", "loop"):
        if name == "loop":
            st = create_train_state(twin, conf, len(loader), family=fam)
            step = make_train_step(twin, conf, fam, mesh=mesh)
            bags = [take(stacked, torch.tensor([i], device=device))
                    for stacked, chunk in seen for i in chunk]
            run = lambda: train_one_epoch(st, step, bags, 0)
        else:
            run = lambda: train_one_epoch_scanned(state, recording, loader, 0)
        _zero_counts()
        clock.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, stats = run()
        torch.cuda.synchronize()
        res[name] = {"wall_s": time.perf_counter() - t0, "stats": stats,
                     "collective_s": clock.seconds,
                     "collective_calls": clock.calls, **_counts()}
    clock.restore()
    steps = sum(len(c) for _, c in seen)
    res.update(steps=steps, state_step=state.step, loop_step=st.step,
               param_diff=_params_diff(model, twin),
               rank_spread=_rank_spread(model, mesh))
    del groups, bags, bag0, loader, model, twin
    torch.cuda.empty_cache()
    return res


def _scan_worker_cli(out: str, argv: list) -> None:
    """(a): ``cli/step3_acmil.py --scan_epoch`` on this rank, with the
    replays of the scanned steps it made counted and its route lines
    kept."""
    import contextlib
    import io

    import acmil_tpu_torch.cli.train as cli
    from acmil_tpu_torch.cli import step3_acmil

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    made = []
    real = (cli.make_scan_train_step, cli.make_scan_eval_step)
    cli.make_scan_train_step = lambda *a, **k: made.append(
        real[0](*a, **k)) or made[-1]
    cli.make_scan_eval_step = lambda *a, **k: made.append(
        real[1](*a, **k)) or made[-1]
    _zero_counts()
    text = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(text):
        best = step3_acmil.main(argv)
    torch.cuda.synchronize()
    res = {"best": best, "wall_s": time.perf_counter() - t0,
           "warm": _counts(),
           "replayed": _sum_counts(*(m.kernel_launches() for m in made)),
           "routes": [ln for ln in text.getvalue().splitlines()
                      if ln.startswith("scan_epoch")],
           "backend": torch.distributed.get_backend()}
    rank = int(os.environ.get("RANK", "0"))
    with open(f"{out}.rank{rank}.json", "w") as f:
        json.dump(res, f)


def _scan_worker_mesh(out: str, feats_path: str, seq: str) -> None:
    """(b) and (d) at data 2 (``seq`` 1), or (c) at data 2 x seq 2, on this
    gloo rank on the card."""
    from acmil_tpu_torch.data import BagLoader
    from acmil_tpu_torch.engine.train import (evaluate, evaluate_scanned,
                                              make_eval_step,
                                              make_scan_eval_step)
    from acmil_tpu_torch.models import build_mil_model
    from acmil_tpu_torch.ops import dsmil_pool
    from acmil_tpu_torch.parallel import (init_distributed, make_mesh,
                                          shard_params)

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    init_distributed(device, backend="gloo", timeout=MESH_LAUNCH_TIMEOUT)
    seq = int(seq)
    mesh = make_mesh(2, seq, device)
    n = SCAN_BAGS if seq == 1 else SCAN_SUB
    res = _scan_vs_loop(mesh, _scan_conf("ga", B=2), _scan_src(feats_path, n),
                        device, 2)
    if seq == 1:
        # (d) DSMIL's scanned eval at data 2 through B6, against evaluate
        rs = np.random.RandomState(SEED + 23)
        big = {f"dsmil_{i}": {
            "feat": rs.randn(SCAN_DSMIL_N - 7 * i, D_FEAT).astype(np.float16),
            "coords": np.zeros((SCAN_DSMIL_N - 7 * i, 2), np.int64),
            "label": i % 2} for i in range(SCAN_DSMIL_BAGS)}
        conf = _scan_conf("dsmil", B=2)
        torch.manual_seed(SEED)
        model, fam = build_mil_model(conf, mesh=mesh)
        model.to(device)
        shard_params(model, mesh)
        kw = dict(min_bucket=SCAN_MIN_BUCKET, dtype=np.float16,
                  device=device, mesh=mesh)
        src = _ListSrc(big)
        ev = {}
        scan_eval = make_scan_eval_step(model, fam, mesh=mesh)
        ev["route"] = scan_eval.route
        for name in ("scan", "per_bag"):
            loader = BagLoader(src, 2, **kw)
            if name == "scan":
                run = lambda: evaluate_scanned(scan_eval, loader,
                                               conf.n_class, mesh=mesh)
            else:
                step = make_eval_step(model, fam, mesh=mesh)
                run = lambda: evaluate(step, loader, conf.n_class, mesh=mesh)
            # the first call uploads the bags and loads the kernels; the
            # second is timed and counted
            run()
            torch.cuda.synchronize()
            before = dsmil_pool.fused_dsmil_pool.launches
            t0 = time.perf_counter()
            got = run()
            torch.cuda.synchronize()
            ev[name] = {"metrics": got, "wall_s": time.perf_counter() - t0,
                        "B6": dsmil_pool.fused_dsmil_pool.launches - before,
                        "bags": sum(int(g.label.shape[0])
                                    for g in loader.device_groups())
                        if name == "scan" else None}
        res["dsmil_eval"] = ev
    with open(f"{out}.rank{mesh.rank}.json", "w") as f:
        json.dump(res, f)


def scan_mesh_run(smi: str, tmp: str, p23: dict) -> dict:
    """Phase 25: the scanned epoch on a mesh of processes, each launch a
    torchrun of this script's ``--mesh-worker``: (a) NCCL at world 1 through
    the CLI against phase 23 (a)'s one-process run; (b) two gloo ranks at
    data 2, B 2, against the per-bag mesh loop; (c) four gloo ranks at data
    2 x seq 2 on the first ``SCAN_SUB`` bags, the same; (d) DSMIL's scanned
    eval at data 2 (B6) against ``evaluate`` on the mesh."""
    from acmil_tpu_torch.engine import checkpoint

    t_phase = time.perf_counter()
    root = os.path.join(tmp, "scan_mesh")
    os.makedirs(root)
    run = p23["cli_run"]
    out = {}

    # (a) NCCL at world 1: the graph route, equal to one process
    ckpt_dir = os.path.join(root, "a", "ckpt")
    (a,) = _torchrun(1, "scan_cli", os.path.join(root, "a"),
                     "--config", run["yml"], "--data_dir", run["data_dir"],
                     "--ckpt_dir", ckpt_dir, "--log_dir",
                     os.path.join(root, "a", "log"), "--train_epoch", "2",
                     "--n_token", str(N_TOKEN), "--n_masked_patch",
                     str(N_MASKED_PATCH), "--mask_drop", str(MASK_DROP),
                     "--min_bucket", str(SCAN_MIN_BUCKET), "--scan_epoch",
                     "--mesh_data", "1", "--device", "cuda")
    steps, evals = 2 * SCAN_BAGS, 2 * (SCAN_VAL + SCAN_TEST)
    if a["backend"] != "nccl" or len(a["routes"]) != 1 \
            or "graph route" not in a["routes"][0]:
        raise AssertionError(f"(a) backend {a['backend']}, route lines "
                             f"{a['routes']}")
    if a["replayed"].get("B2") != steps \
            or a["replayed"].get("B1") != steps + evals:
        raise AssertionError(f"(a) replayed launches {a['replayed']}: want "
                             f"B2 {steps} and B1 {steps + evals}")
    got = checkpoint.load(checkpoint.checkpoint_path(ckpt_dir, "last"))
    want = checkpoint.load(checkpoint.checkpoint_path(run["ckpt_dir"], "last"))
    diff = max(float((got["model"][k] - v).abs().max())
               for k, v in want["model"].items())
    if got["step"] != want["step"] or diff > SCAN_GRAPH_ATOL \
            or not _same_eval({k: v for k, v in a["best"].items()},
                              run["best"]):
        raise AssertionError(f"(a) against phase 23 (a): step {got['step']} "
                             f"vs {want['step']}, max weight diff "
                             f"{diff:.3e}, best {a['best']} vs {run['best']}")
    out["nccl_world1"] = {"wall_s": a["wall_s"], "launch_s": a["launch_s"],
                          "max_weight_diff": diff, "route": a["routes"][0],
                          "B1": a["warm"]["B1"] + a["replayed"]["B1"],
                          "B2": a["warm"]["B2"] + a["replayed"]["B2"],
                          "replayed": a["replayed"]}
    print(f"scan mesh (a): cli/step3_acmil.py --scan_epoch --mesh_data 1 "
          f"under torchrun, {a['backend']}, world 1, 2 epochs x {SCAN_BAGS} bags + "
          f"{SCAN_VAL} val + {SCAN_TEST} test: {a['routes'][0]}; last "
          f"checkpoint against phase 23 (a)'s one process: max weight diff "
          f"{diff:.3e} (tolerance {SCAN_GRAPH_ATOL}), step {got['step']}, "
          f"best metrics equal; replayed B1 {a['replayed']['B1']} B2 "
          f"{a['replayed']['B2']}, warm-ups {a['warm']['B1']}/"
          f"{a['warm']['B2']}; {a['wall_s']:.2f} s in main(), "
          f"{a['launch_s']:.2f} s the launch [{smi}]")

    feats = os.path.join(run["data_dir"], "patch_feats_pretrain_medical_ssl.pt")

    def check(ranks, what, seq):
        for r in ranks:
            s_, l_ = r["scan"]["stats"], r["loop"]["stats"]
            bad = []
            if r["route"] != "eager" or "gloo" not in r["reason"]:
                bad.append(f"route {r['route']} ({r['reason']})")
            if not r["state_step"] == r["loop_step"] == r["steps"] > 0:
                bad.append(f"steps {r['state_step']}/{r['loop_step']}/"
                           f"{r['steps']}")
            if r["param_diff"] > r["steps"] * _scan_conf().lr \
                    or r["rank_spread"] != 0:
                bad.append(f"param diff {r['param_diff']:.3e}, rank spread "
                           f"{r['rank_spread']:.3e}")
            if not math.isclose(s_["loss"], l_["loss"],
                                rel_tol=SCAN_MESH_LOSS_RTOL) \
                    or not math.isclose(s_["grad_norm"], l_["grad_norm"],
                                        rel_tol=SCAN_MESH_GNORM_RTOL):
                bad.append(f"stats {s_} vs {l_}")
            for name in ("scan", "loop"):
                if (r[name]["B1"], r[name]["B2"]) != (r["steps"],) * 2:
                    bad.append(f"{name} launched B1 {r[name]['B1']} B2 "
                               f"{r[name]['B2']} in {r['steps']} steps")
            if bad:
                raise AssertionError(f"{what} rank {r['rank']}: "
                                     f"{'; '.join(bad)}")
        r0 = ranks[0]
        per = lambda name, k: [round(r[name][k] * 1e3 / r["steps"], 3)
                               for r in ranks]
        print(f"scan mesh {what}: ACMIL_GA (Df {D_FEAT}, L = A = {D_INNER}, "
              f"K {N_TOKEN}, STKIM {N_MASKED_PATCH}/{MASK_DROP}), B 2, "
              f"{len(ranks)} gloo ranks on the card at data 2 x seq {seq}, "
              f"{r0['steps']} steps a rank in {r0['groups']} groups, "
              f"{r0['route']} route ({r0['reason']}): scanned epoch against "
              f"the per-bag mesh loop in its order, max param diff "
              f"{max(r['param_diff'] for r in ranks):.3e}, loss "
              f"{r0['scan']['stats']['loss']:.7f} / "
              f"{r0['loop']['stats']['loss']:.7f}, grad_norm "
              f"{r0['scan']['stats']['grad_norm']:.6f} / "
              f"{r0['loop']['stats']['grad_norm']:.6f}; every rank's "
              f"parameters equal; B1 and B2 {r0['scan']['B1']} a rank (once a "
              f"step{', each on its slice of N' if seq > 1 else ''}); epoch wall "
              f"{[round(r['scan']['wall_s'], 3) for r in ranks]} s scanned, "
              f"{[round(r['loop']['wall_s'], 3) for r in ranks]} s loop; "
              f"ms in gloo collectives a step {per('scan', 'collective_s')} "
              f"scanned, {per('loop', 'collective_s')} loop, "
              f"{r0['scan']['collective_calls'] / r0['steps']:.1f} calls a "
              f"step; upload {r0['upload_s']:.2f} s; "
              f"{r0['launch_s']:.2f} s the launch [{smi}]")
        return {"steps_a_rank": r0["steps"], "groups": r0["groups"],
                "route": r0["route"], "reason": r0["reason"],
                "param_diff": max(r["param_diff"] for r in ranks),
                "loss": [r0["scan"]["stats"]["loss"],
                         r0["loop"]["stats"]["loss"]],
                "grad_norm": [r0["scan"]["stats"]["grad_norm"],
                              r0["loop"]["stats"]["grad_norm"]],
                "epoch_wall_s": [r["scan"]["wall_s"] for r in ranks],
                "loop_wall_s": [r["loop"]["wall_s"] for r in ranks],
                "collective_ms_a_step": per("scan", "collective_s"),
                "loop_collective_ms_a_step": per("loop", "collective_s"),
                "B1": sum(r["scan"]["B1"] for r in ranks),
                "B2": sum(r["scan"]["B2"] for r in ranks),
                "launch_s": r0["launch_s"]}

    # (b) and (d): two gloo ranks at data 2
    ranks = _torchrun(2, "scan_mesh", os.path.join(root, "b"), feats, "1")
    out["data2"] = check(ranks, "(b)", 1)
    for r in ranks:
        ev = r["dsmil_eval"]
        if ev["route"] != "eager" or ev["scan"]["B6"] != ev["scan"]["bags"] \
                or ev["per_bag"]["B6"] != ev["scan"]["bags"] \
                or not _same_eval(ev["scan"]["metrics"],
                                  ev["per_bag"]["metrics"]) \
                or ev["scan"]["metrics"] != ranks[0]["dsmil_eval"]["scan"][
                    "metrics"]:
            raise AssertionError(f"(d) rank {r['rank']}: {ev}")
    ev = ranks[0]["dsmil_eval"]
    out["dsmil_eval_data2"] = {
        "B6": sum(r["dsmil_eval"]["scan"]["B6"] for r in ranks),
        "bags_a_rank": ev["scan"]["bags"],
        "wall_s": [r["dsmil_eval"]["scan"]["wall_s"] for r in ranks],
        "per_bag_wall_s": [r["dsmil_eval"]["per_bag"]["wall_s"]
                           for r in ranks],
        "loss": ev["scan"]["metrics"]["loss"]}
    print(f"scan mesh (d): DSMIL's scanned eval at data 2 (two gloo ranks, B "
          f"2) of {SCAN_DSMIL_BAGS} bags of ~{SCAN_DSMIL_N} patches: B6 "
          f"{[r['dsmil_eval']['scan']['B6'] for r in ranks]} a rank, once a "
          f"bag of its {ev['scan']['bags']}; metrics equal evaluate's on the "
          f"mesh on every rank (auc {ev['scan']['metrics']['auc']:.6f}, loss "
          f"{ev['scan']['metrics']['loss']:.7f}); "
          f"{[round(r['dsmil_eval']['scan']['wall_s'], 3) for r in ranks]} s "
          f"scanned, "
          f"{[round(r['dsmil_eval']['per_bag']['wall_s'], 3) for r in ranks]}"
          f" s per bag [{smi}]")

    # (c) four gloo ranks at data 2 x seq 2
    ranks = _torchrun(4, "scan_mesh", os.path.join(root, "c"), feats, "2")
    out["data2_seq2"] = check(ranks, "(c)", 2)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"scan mesh: phase 25 in {out['seconds']:.1f} s [{smi}]")
    return out


# phase 24: the ViT trunks at float16 and float32. Features of the fused
# route against the plain route's, per patch (f32: the order of f32 sums
# alone; fp16: one fp16 rounding may flip at each rounding point)
COS_MIN_F32, COS_MIN_F16 = 0.9999, 0.999
# the card's f32 features against the CPU's plain vit_encode on one batch of
# CPU_F32_PATCHES, relative to the largest feature: full f32 differs from
# the CPU in the order of f32 sums alone (~1e-6 a layer); TF32 anywhere on
# the card's path keeps 2**-11 of each product and shows at ~1e-3
CPU_F32_REL, CPU_F32_PATCHES = 1e-4, 8
# kernel against plain, as tests/test_torch_vit_chains.py and
# test_torch_gpu_b6_b7.py hold them: a chain at two fp16 steps, B5' and the
# GEMM at one; at f32 the order of f32 sums (and the GEMM's split-TF32
# products, about 2**-22 of each term) amplified by the LayerNorms
DT_CHAIN_TOL = {torch.float16: 2.0 ** -9, torch.float32: 3e-5}
DT_ONE_TOL = {torch.float16: 2.0 ** -10, torch.float32: 1e-5}
# the trunks checked layer by layer at depth BIG_DEPTH: (name, module
# widths, batch); their routes at fp16 and f32 follow vit_route
DT_TRUNKS = (("ViT-B/16", dict(patch=16, dim=768, heads=12), 64),
             ("UNI ViT-L/16", dict(patch=16, dim=1024, heads=16,
                                   layerscale=True), BIG_BATCH),
             ("CLIP-L/336", dict(patch=14, dim=1024, heads=16, img_size=336,
                                 proj_dim=768, pre_norm=True,
                                 act="quick_gelu"), BIG_BATCH))


def _vit_counts() -> dict:
    """B3, B4, the GEMM by dtype and B5' by route, as flat counts."""
    from acmil_tpu_torch.ops import vit_attn_packed as pk
    from acmil_tpu_torch.ops import vit_layer as vl

    return {"B3": vl.fused_vit_layer.launches,
            "B4": vl.fused_vit_attn_half.launches,
            **{f"gemm_{k}": v for k, v in vl._gemm.launches.items()},
            **{f"b5_{k}": v for k, v in pk._launch_packed.route_launches.items()}}


def _zero_vit_counts() -> None:
    from acmil_tpu_torch.ops import vit_attn_packed as pk
    from acmil_tpu_torch.ops import vit_layer as vl

    vl.fused_vit_layer.launches = vl.fused_vit_attn_half.launches = 0
    pk._launch_packed.launches = 0
    for d in (vl._gemm.launches, pk._launch_packed.route_launches):
        for k in d:
            d[k] = 0


def _gemm_plain(a, w, bias, epilogue, out_dtype, ln=None, res=None,
                ls=None):
    """The GEMM's contract in plain torch: f32 LayerNorm (or none) of a,
    rounded to w's dtype (a bf16 a with an f32 w, the bf16-A mode: to
    bf16), an f32 product, the epilogue in f32. With float64 operands
    every step is float64."""
    from acmil_tpu_torch.ops import vit_layer as vl

    acc_dtype = torch.float64 if w.dtype == torch.float64 else torch.float32
    rows = (torch.bfloat16 if (a.dtype, w.dtype) == (torch.bfloat16,
                                                     torch.float32)
            else w.dtype)
    af = a.to(acc_dtype)
    if ln is not None:
        af = vl._ln_f32(af, *(t.to(acc_dtype) for t in ln))
    acc = af.to(rows).to(acc_dtype) @ w.to(acc_dtype).t() + bias.to(acc_dtype)
    if epilogue == vl.EPI_BIAS_GELU:
        acc = torch.nn.functional.gelu(acc, approximate="tanh")
    elif epilogue == vl.EPI_RES_BIAS:
        acc = acc + res.to(acc_dtype)
    elif epilogue == vl.EPI_BIAS_LS_RES:
        acc = res.to(acc_dtype) + (acc * ls.to(acc_dtype) if ls is not None
                                   else acc)
    elif epilogue == vl.EPI_BIAS_SWIGLU:
        # w as published: gate rows, then value rows
        gate, value = acc.chunk(2, dim=1)
        acc = torch.nn.functional.silu(gate) * value
    return acc.to(out_dtype)


def _b3_gemm_calls(gen, dtype):
    """The four GEMM calls of a B3 layer at ViT-S/16, B=256, as the chain
    makes them at ``dtype``: (label, a, w, bias, epilogue, out dtype, ln,
    residual)."""
    from acmil_tpu_torch.ops import vit_layer as vl

    m, d, hid = STEP2_BATCH * VIT_S16[0], VIT_S16[1], 4 * VIT_S16[1]
    f32 = torch.float32
    r = lambda *shape: torch.randn(*shape, generator=gen, device="cuda")
    ln = (1 + 0.1 * r(d), 0.1 * r(d))
    ln2 = (1 + 0.1 * r(d), 0.1 * r(d))
    x, h = r(m, d).to(dtype), r(m, d)
    return (("qkv", x, (r(3 * d, d) / d ** 0.5).to(dtype), 0.1 * r(3 * d),
             vl.EPI_BIAS, dtype, ln, None),
            ("proj", r(m, d).to(dtype), (r(d, d) / d ** 0.5).to(dtype),
             0.1 * r(d), vl.EPI_RES_BIAS, f32, None, x),
            ("fc1", h, (r(hid, d) / d ** 0.5).to(dtype), 0.1 * r(hid),
             vl.EPI_BIAS_GELU, dtype, ln2, None),
            ("fc2", r(m, hid).to(dtype), (r(d, hid) / hid ** 0.5).to(dtype),
             0.1 * r(d), vl.EPI_RES_BIAS, dtype, None, h))


# the device kernels of one GEMM call at each dtype ({part of the name:
# launches a call}; f32: the split of W, then the product), besides the
# LayerNorm prologue of a call that has one
GEMM_KERNELS = {torch.float16: {"gemm_kernel": 1},
                torch.float32: {"gemm_f32_kernel": 1, "split_w_kernel": 1}}


def _four_gemms(dtype) -> dict:
    """GEMM_KERNELS for a B3 layer's four GEMM calls."""
    return {k: 4 * n for k, n in GEMM_KERNELS[dtype].items()}


def _gemm_timed(smi: str, dtype) -> dict:
    """The GEMM at ``dtype`` (fp16: ``csrc/vit_gemm.cu``; f32:
    ``csrc/vit_gemm_f32.cu``) at B3's four calls, ViT-S/16 B=256: against
    its plain version (f32: W's split also bit for bit against its plain
    version), then timed (summed over the four) beside the plain version
    and ``torch.matmul`` in the same dtype (f32: TF32 off; and TF32
    ``torch.matmul``, one TF32 product, as a second yardstick)."""
    from acmil_tpu_torch.ops import vit_layer as vl
    from acmil_tpu_torch.ops.vit_attn_packed import DTYPE_KEYS

    gen = torch.Generator(device="cuda").manual_seed(SEED + 24)
    calls = _b3_gemm_calls(gen, dtype)
    key = DTYPE_KEYS[dtype]
    tol = DT_ONE_TOL[dtype]
    worst, flops, nbytes = 0.0, 0, 0
    ms = plain_ms = lib_ms = tf32_ms = 0.0
    for label, a, w, bias, epi, out_dtype, ln, res in calls:
        kw = dict(out_dtype=out_dtype, ln=ln, res=res)
        before = vl._gemm.launches[key]
        got = vl._gemm(a, w, bias, epi, **kw)
        torch.cuda.synchronize()
        if vl._gemm.launches[key] != before + 1:
            raise AssertionError(f"GEMM {key} {label}: not launched")
        worst = max(worst, _err(got, _gemm_plain(a, w, bias, epi, out_dtype,
                                                 ln, res), tol))
        m, k = a.shape
        n = w.shape[0]
        flops += 2 * m * n * k
        nbytes += (a.element_size() * m * k + w.element_size() * n * k
                   + got.element_size() * m * n
                   + (0 if res is None else res.element_size() * m * n))
        ms += _time_ms(lambda: vl._gemm(a, w, bias, epi, **kw), 10)
        plain_ms += _time_ms(lambda: _gemm_plain(a, w, bias, epi, out_dtype,
                                                 ln, res), 5)
        a_lib = a.to(w.dtype)        # fc1's A is the f32 residual h
        lib_ms += _time_ms(lambda: torch.matmul(a_lib, w.t()), 10)
        if dtype == torch.float32:
            torch.backends.cuda.matmul.allow_tf32 = True
            try:
                tf32_ms += _time_ms(lambda: torch.matmul(a_lib, w.t()), 10)
            finally:
                torch.backends.cuda.matmul.allow_tf32 = False
    if dtype == torch.float32:
        w = calls[0][2]              # qkv's W: the split bit for bit
        if not torch.equal(vl.split_w(w).cpu().view(torch.int32),
                           vl._split_w_reference(w.cpu()).view(torch.int32)):
            raise AssertionError("split_w: kernel and plain version differ")

    def four():
        for _, a, w, bias, epi, out_dtype, ln, res in calls:
            vl._gemm(a, w, bias, epi, out_dtype=out_dtype, ln=ln, res=res)

    # two of the four calls (qkv, fc1) run the LayerNorm prologue first
    split = _kernel_ms(four, {**_four_gemms(dtype), "ln_rows_kernel": 2},
                       5) or {}
    gemm = "gemm_kernel" if dtype != torch.float32 else "gemm_f32_kernel"
    gemm_dev, ln_dev = split.get(gemm), split.get("ln_rows_kernel")
    split_dev = split.get("split_w_kernel")
    r = {"ms": ms, "device_ms": sum(split.values()) if split else None,
         "gemm_device_ms": gemm_dev, "ln_device_ms": ln_dev,
         "plain_ms": plain_ms, "library_ms": lib_ms,
         **(_f32_bound(flops, nbytes) if dtype == torch.float32
            else _bound(flops, nbytes)),
         "max_abs_err": worst, "gflop": flops / 1e9}
    rate = ("" if gemm_dev is None else
            f", {flops / (gemm_dev * 1e-3) / 1e12:.1f} TFLOP/s of products")
    extra = ""
    if dtype == torch.float32:
        r.update({"split_device_ms": split_dev, "tf32_library_ms": tf32_ms})
        extra = (f", bound at the f32 FMA rate {r['fma_bound_ms']:.4f} ms; "
                 f"TF32 torch.matmul (one TF32 product, not the same "
                 f"function) {tf32_ms:.4f} ms")
    print(f"GEMM {key} ({'TMA + split-TF32 wgmma .tf32' if dtype == torch.float32 else 'TMA + wgmma'}) "
          f"at B3's four calls, ViT-S/16 B={STEP2_BATCH} ({flops / 1e9:.1f} "
          f"GFLOP): kernel {ms:.4f} ms (device: products "
          f"{_fmt_ms(gemm_dev)}{rate}, LayerNorm prologues {_fmt_ms(ln_dev)}"
          f"{'' if dtype != torch.float32 else ', splits of W ' + _fmt_ms(split_dev)}), "
          f"plain {plain_ms:.4f} ms, {str(dtype)[6:]} torch.matmul "
          f"{lib_ms:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}"
          f"{', 3 TF32 products each' if dtype == torch.float32 else ''})"
          f"{extra}; against plain max_abs_err {worst:.3e} [{smi}]")
    return r


def _b5_timed(smi: str, dtype) -> dict:
    """B5' at ViT-S/16, B=256 (B3's attention step) at ``dtype``: fp16 on
    the tensor cores, f32 on the tf32x3 route (and on B7's fma route, its
    earlier route, through ``_launch_fma`` on the same views), beside its
    plain version and scaled_dot_product_attention in the same dtype;
    device times from whole profiler windows (``_kernel_ms``)."""
    from acmil_tpu_torch.ops import vit_attn_packed as pk

    gen = torch.Generator(device="cuda").manual_seed(SEED + 25)
    b, (n, d, heads) = STEP2_BATCH, VIT_S16
    qkv = (2 * torch.randn(b, n, 3 * d, generator=gen, device="cuda")).to(
        dtype)
    q, k, v = qkv.view(b, n, 3, heads, d // heads).permute(2, 0, 3, 1, 4)
    route = "f16" if dtype == torch.float16 else "tf32x3"
    before = pk._launch_packed.route_launches[route]
    want = pk._reference_packed(qkv, heads)
    got = pk.fused_mha_packed(qkv, heads)
    err = _err(got, want, DT_ONE_TOL[dtype])
    if pk._launch_packed.route_launches[route] != before + 1:
        raise AssertionError(f"B5' {dtype}: not the {route} route")
    if not torch.equal(got, pk.fused_mha_packed(qkv, heads)):
        raise AssertionError(f"B5' {dtype}: two launches differ")
    kernel = "mha_kernel" if route == "f16" else pk.TF32X3_KERNELS[0]
    dev = _kernel_ms(lambda: pk.fused_mha_packed(qkv, heads), {kernel: 1},
                     20)
    r = {"ms": _time_ms(lambda: pk.fused_mha_packed(qkv, heads), 20),
         "device_ms": None if dev is None else dev[kernel],
         "plain_ms": _time_ms(lambda: pk._reference_packed(qkv, heads), 10),
         "library_ms": _time_ms(
             lambda: torch.nn.functional.scaled_dot_product_attention(
                 q, k, v), 20), "max_abs_err": err}
    flops, nbytes = b * 4 * n * n * d, b * qkv.element_size() * (
        n * 3 * d + n * d)
    r.update(_f32_bound(flops, nbytes) if dtype == torch.float32
             else _bound(flops, nbytes))
    fma = (f", at the f32 FMA rate {r['fma_bound_ms']:.4f} ms"
           if dtype == torch.float32 else "")
    print(f"kernel B5' {str(dtype)[6:]} ({'tensor cores' if route == 'f16' else 'tf32x3 route, split-TF32 tensor cores'}) "
          f"time: ViT-S/16 B={b} N={n} H={heads}: kernel {r['ms']:.4f} ms "
          f"(device {_fmt_ms(r['device_ms'])}), plain "
          f"{r['plain_ms']:.4f} ms, scaled_dot_product_attention "
          f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
          f"({r['bound_by']}{fma}), {_bound_share(r)}; against plain "
          f"{err:.3e} [{smi}]")
    if dtype == torch.float32:
        # the earlier route at the same shape and views
        out = torch.empty(b, n, d, device="cuda")
        o = out.view(b, n, heads, d // heads).transpose(1, 2)
        call = lambda: pk._launch_fma(q, k, v, o, 1.0 / math.sqrt(d // heads))
        call()
        fma_err = _err(out, want, DT_ONE_TOL[dtype])
        fdev = _kernel_ms(call, {B7_FMA_KERNELS[0]: 1}, 20)
        r["fma_route"] = {
            "ms": _time_ms(call, 20),
            "device_ms": None if fdev is None else fdev[B7_FMA_KERNELS[0]],
            "max_abs_err": fma_err}
        f = r["fma_route"]
        print(f"kernel B5' float32 on B7's fma route (its earlier route, "
              f"_launch_fma on the same views): kernel {f['ms']:.4f} ms "
              f"(device {_fmt_ms(f['device_ms'])}); against plain "
              f"{fma_err:.3e} [{smi}]")
        if not r["ms"] <= r["library_ms"]:
            print(f"note: B5''s tf32x3 route call {r['ms']:.4f} ms is "
                  f"slower than f32 SDPA's {r['library_ms']:.4f} ms in this "
                  f"run [{smi}]")
    return r


def _layer_timed(smi: str, dtype) -> dict:
    """A B3 layer at ViT-S/16, B=256 at ``dtype``: the chain beside its
    plain version, and its device time split by kernel (GEMM, LayerNorm
    prologue, attention)."""
    from acmil_tpu_torch.ops import vit_layer as vl

    gen = torch.Generator(device="cuda").manual_seed(SEED + 26)
    (n, d, heads), b = VIT_S16, STEP2_BATCH
    w = {k: (v.to(dtype) if v.dim() == 2 else v)
         for k, v in _vit_weights(gen, d, 4 * d).items()}
    x = torch.randn(b, n, d, generator=gen, device="cuda").to(dtype)
    err = _err(vl.fused_vit_layer(x, w, heads),
               vl._reference_layer(x, w, heads), DT_CHAIN_TOL[dtype])
    attn = "mha_kernel" if dtype == torch.float16 else "b7_tf32x3_kernel"
    split = _kernel_ms(lambda: vl.fused_vit_layer(x, w, heads),
                       {**_four_gemms(dtype), "ln_rows_kernel": 2, attn: 1})
    r = {"ms": _time_ms(lambda: vl.fused_vit_layer(x, w, heads), 10),
         "plain_ms": _time_ms(lambda: vl._reference_layer(x, w, heads), 5),
         "split_device_ms": split, "max_abs_err": err}
    print(f"kernel B3 {str(dtype)[6:]}: ViT-S/16 B={b} layer {r['ms']:.4f} ms, "
          f"plain {r['plain_ms']:.4f} ms; device ms by kernel: "
          f"{'not measured' if split is None else _fmt_split(split)}; "
          f"against plain {err:.3e} [{smi}]")
    return r


def _dtype_trunks(smi: str) -> dict:
    """ViT-B/16, UNI and CLIP-L/336 at full width, depth BIG_DEPTH, at fp16
    and f32: each layer's kernel (B4, or B5' inside the packed route's
    attention half) against its plain version on the plain route's
    activations, then vit_encode fused against plain."""
    from acmil_tpu_torch.models.encoders.build import (IMAGENET_MEAN,
                                                       IMAGENET_STD,
                                                       EncoderSpec,
                                                       preprocess)
    from acmil_tpu_torch.models.encoders.fast import (_mlp_half,
                                                      block_weights,
                                                      cast_kernel_weights,
                                                      vit_embed, vit_encode,
                                                      vit_route)
    from acmil_tpu_torch.models.encoders.vit import ViT
    from acmil_tpu_torch.ops import vit_attn_packed as pk
    from acmil_tpu_torch.ops import vit_layer as vl

    out = {}
    for name, kw, b in DT_TRUNKS:
        for dtype in (torch.float16, torch.float32):
            torch.manual_seed(SEED)
            m = ViT(depth=BIG_DEPTH, dtype=dtype, **kw)
            gen = torch.Generator().manual_seed(SEED)
            for blk in m.blocks:
                for ls in (blk.ls1, blk.ls2):
                    if hasattr(ls, "gamma"):
                        ls.gamma.data = 0.25 + 0.5 * torch.rand(
                            ls.gamma.shape, generator=gen)
            n_tok = (m.img_size // m.patch) ** 2 + 1
            params = cast_kernel_weights(
                {k: v.cuda() for k, v in m.state_dict().items()},
                n_tok=n_tok, heads=m.heads, dtype=dtype, act=m.act)
            route = vit_route(params, n_tok, m.heads, dtype, m.act)
            spec = EncoderSpec(None, m.embed_dim, m.img_size, IMAGENET_MEAN,
                               IMAGENET_STD, "vit")
            u8 = torch.randint(0, 256, (b, m.img_size, m.img_size, 3),
                               generator=gen, dtype=torch.uint8).cuda()
            x = preprocess(u8, spec, dtype)
            enc_kw = dict(patch=m.patch, depth=BIG_DEPTH, heads=m.heads,
                          dtype=dtype, act=m.act, pre_norm=m.pre_norm,
                          proj_dim=m.proj_dim)
            # layer by layer on the plain route's activations
            t = vit_embed(params, x, patch=m.patch, dtype=dtype,
                          pre_norm=m.pre_norm)
            worst = 0.0
            for i in range(BIG_DEPTH):
                bp = block_weights(params, i)
                if route == "half":
                    got = vl.fused_vit_attn_half(t, bp, m.heads)
                    want = vl._reference_attn_half(t, bp, m.heads)
                else:
                    got = vl._unfused_attn_half(t, bp, m.heads,
                                                mha=pk.fused_mha_packed)
                    want = vl._unfused_attn_half(t, bp, m.heads,
                                                 mha=pk._reference_packed)
                torch.cuda.synchronize()
                worst = max(worst, _err(got, want, DT_CHAIN_TOL[dtype]))
                t = _mlp_half(want, bp, m.act)
            _zero_vit_counts()
            got = vit_encode(params, x, **enc_kw)
            torch.cuda.synchronize()
            counts = _vit_counts()
            key = ("B4" if route == "half" else
                   "b5_f16" if dtype == torch.float16 else "b5_tf32x3")
            if counts[key] != BIG_DEPTH:
                raise AssertionError(f"{name} {dtype}: {key} launched "
                                     f"{counts[key]} times: {counts}")
            want = vit_encode(params, x, **enc_kw, fused=False)
            cos = float(_row_cosine(got, want).min())
            cmin = COS_MIN_F32 if dtype == torch.float32 else COS_MIN_F16
            if tuple(got.shape) != (b, m.embed_dim) or not cos >= cmin \
                    or not bool(torch.isfinite(got).all()):
                raise AssertionError(f"{name} {dtype}: {tuple(got.shape)}, "
                                     f"cosine {cos}")
            out[f"{name} {pk.DTYPE_KEYS[dtype]}"] = {
                "route": route, "launches": counts, "max_abs_err": worst,
                "cosine": cos}
            print(f"vit_encode {name} {str(dtype)[6:]}, full width, depth "
                  f"{BIG_DEPTH}, B={b}: route {route}, launches "
                  f"{ {k: v for k, v in counts.items() if v} }; each layer's "
                  f"kernel vs plain max_abs_err {worst:.3e} (tol "
                  f"{DT_CHAIN_TOL[dtype]} of the max); fused vs plain "
                  f"worst cosine {cos:.6f} [{smi}]")
    return out


def vit_dtypes_run(smi: str) -> dict:
    """Phase 24: Step2's ViT-S/16 feature path (build_encoder →
    encoder_feature_fn → extract_slide_features) at fp16 and f32 through
    B3's chains, an f32 batch against the CPU, the other trunks layer by
    layer, then the new kernels timed."""
    import warnings

    from acmil_tpu_torch.cli.step2_extract import extract_slide_features
    from acmil_tpu_torch.config import Config
    from acmil_tpu_torch.data.patch_dataset import SlidePatchBatches
    from acmil_tpu_torch.models.encoders.build import (build_encoder,
                                                       encoder_feature_fn)
    from acmil_tpu_torch.ops.vit_attn_packed import DTYPE_KEYS
    from acmil_tpu_torch.wsi.slide import open_slide
    from acmil_tpu_torch.wsi.tiling import load_coords_pt

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    conf = Config.from_dict({"pretrain": "medical_ssl",
                             "backbone": "ViT-S/16"})
    out = {"step2": {}}
    with tempfile.TemporaryDirectory() as tmp:
        slide_dir, coords_dir, _ = _step2_inputs()
        slides = []
        for i in range(len(STEP2_SLIDES)):
            coords, _, _ = load_coords_pt(os.path.join(coords_dir,
                                                       f"slide_{i}.pt"))
            slides.append((open_slide(os.path.join(slide_dir,
                                                   f"slide_{i}.png")),
                           coords))
        batches = sum(-(-len(c) // STEP2_BATCH) for _, c in slides)
        models = {}
        for dtype in (torch.float16, torch.float32):
            with warnings.catch_warnings(), torch.random.fork_rng(devices=[]):
                warnings.simplefilter("ignore")   # no pretrain_weights: seeded
                torch.manual_seed(0)
                model, spec, _ = build_encoder(conf, dtype=dtype)
            models[dtype] = (model, spec)
            embed = encoder_feature_fn(model, spec, dev)
            plain = encoder_feature_fn(model, spec, dev, fused=False)
            _zero_vit_counts()
            t0 = time.perf_counter()
            feats = [extract_slide_features(embed, spec, sl, c, PATCH_PX, 0,
                                            batch_size=STEP2_BATCH)
                     for sl, c in slides]
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = _vit_counts()
            key = DTYPE_KEYS[dtype]
            b5_key = "b5_f16" if dtype == torch.float16 else "b5_tf32x3"
            want = {"B3": STEP2_DEPTH * batches, "B4": 0,
                    f"gemm_{key}": 4 * STEP2_DEPTH * batches,
                    "b5_fma": 0, b5_key: STEP2_DEPTH * batches}
            if any(counts[k] != v for k, v in want.items()) or sum(
                    counts[k] for k in counts if k.startswith("gemm_")) != \
                    want[f"gemm_{key}"]:
                raise AssertionError(f"Step2 at {dtype}: launches {counts}, "
                                     f"want {want}")
            ref = [extract_slide_features(plain, spec, sl, c, PATCH_PX, 0,
                                          batch_size=STEP2_BATCH)
                   for sl, c in slides]
            got_t = torch.from_numpy(np.concatenate(feats)).float()
            ref_t = torch.from_numpy(np.concatenate(ref)).float()
            cos = float(_row_cosine(got_t, ref_t).min())
            max_abs = float((got_t - ref_t).abs().max())
            cmin = COS_MIN_F32 if dtype == torch.float32 else COS_MIN_F16
            if got_t.shape != (sum(len(c) for _, c in slides), 384) \
                    or not bool(torch.isfinite(got_t).all()) \
                    or not cos >= cmin:
                raise AssertionError(f"Step2 at {dtype}: {tuple(got_t.shape)}"
                                     f", cosine {cos}")
            # the encoder's device time per batch, pixels on the card
            imgs = next(iter(SlidePatchBatches(
                slides[0][0], slides[0][1], PATCH_PX, 0,
                target_size=spec.img_size, batch_size=STEP2_BATCH)))[0]
            u8 = torch.from_numpy(imgs).to(dev)
            enc_ms = _time_ms(lambda: embed(u8), 3)
            plain_ms = _time_ms(lambda: plain(u8), 2)
            out["step2"][key] = {
                "launches": counts, "cosine": cos, "max_abs": max_abs,
                "patches": int(got_t.shape[0]), "wall_s": wall,
                "encoder_ms_per_batch": enc_ms, "plain_ms_per_batch": plain_ms}
            print(f"step2 at {str(dtype)[6:]}: build_encoder -> "
                  f"encoder_feature_fn -> extract_slide_features, ViT-S/16 "
                  f"full width, depth {STEP2_DEPTH}, batch {STEP2_BATCH}: "
                  f"{got_t.shape[0]} patches in {batches} batches, "
                  f"{wall:.2f} s; launches "
                  f"{ {k: v for k, v in counts.items() if v} }; fused vs "
                  f"plain route worst cosine {cos:.6f} (min {cmin}), max_abs "
                  f"{max_abs:.3e}; encoder per batch of {STEP2_BATCH}: fused "
                  f"{enc_ms:.4f} ms, plain {plain_ms:.4f} ms [{smi}]")
            if dtype == torch.float32:
                # one batch on the card against the plain route on the CPU,
                # f32 features out: TF32 anywhere on the card would show.
                # cuDNN's TF32 is on for the card's run, as PyTorch's
                # default has it: fast.conv_precision alone keeps the
                # patch embed in f32
                cpu = encoder_feature_fn(model, spec, torch.device("cpu"),
                                         fused=False, out_dtype=torch.float32)
                card_fn = encoder_feature_fn(model, spec, dev,
                                             out_dtype=torch.float32)
                few = imgs[:CPU_F32_PATCHES]
                # (cuDNN may keep a convolution in f32 even where TF32 is
                # allowed, as it did the patch embed's on an H100: the flag
                # is read at each f32 convolution as well)
                conv, tf32_at_conv = torch.nn.functional.conv2d, []

                def spy(x, *args, **kwargs):
                    if x.is_cuda and x.dtype == torch.float32:
                        tf32_at_conv.append(torch.backends.cudnn.allow_tf32)
                    return conv(x, *args, **kwargs)

                torch.nn.functional.conv2d = spy
                torch.backends.cudnn.allow_tf32 = True
                try:
                    got_c = card_fn(few).cpu()
                finally:
                    torch.nn.functional.conv2d = conv
                    torch.backends.cudnn.allow_tf32 = False
                want_c = cpu(few)
                rel = float((got_c - want_c).abs().max()
                            / want_c.abs().max())
                if not rel <= CPU_F32_REL or not tf32_at_conv \
                        or any(tf32_at_conv):
                    raise AssertionError(f"f32 card vs CPU: {rel}; cuDNN's "
                                         f"TF32 at each f32 convolution: "
                                         f"{tf32_at_conv}")
                out["step2"]["f32_cpu_rel"] = rel
                print(f"step2 f32, {CPU_F32_PATCHES} patches: card (fused, "
                      f"cuDNN TF32 allowed) against the CPU's plain "
                      f"vit_encode, max |diff| / max "
                      f"|feature| {rel:.3e} (max {CPU_F32_REL}); cuDNN's "
                      f"TF32 off at each of its {len(tf32_at_conv)} f32 "
                      f"convolutions [{smi}]")
    out["trunks"] = _dtype_trunks(smi)
    for dtype in (torch.float16, torch.float32):
        key = DTYPE_KEYS[dtype]
        out[f"gemm_{key}"] = _gemm_timed(smi, dtype)
        out[f"b5_{key}"] = _b5_timed(smi, dtype)
        out[f"b3_{key}"] = _layer_timed(smi, dtype)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"phase 24 in {out['seconds']:.1f} s")
    return out


def main() -> None:
    import sys

    from acmil_tpu_torch.ops.vit_attn import fused_vit_attention

    if sys.argv[1:2] == ["--mesh-worker"]:
        # one rank of phase 21, 22 or 25, started by torchrun
        mesh_worker(*sys.argv[2:])
        return
    smi = card()
    build()
    # B7 has no production caller: its count over every path below (phases
    # 3-13) is read before phase 14, whose checks launch it
    fused_vit_attention.launches = 0
    b1 = kernel_vs_plain(smi)
    b2 = bwd_kernel_vs_plain(smi)
    serve_launches = slice_run(smi)
    wide_serve = wide_serve_run(smi)
    train_launches = train_run(smi)
    wide_train = wide_train_run(smi)
    train_routes(smi)
    vit = vit_kernels_vs_plain(smi)
    step2 = step2_run(smi)
    big = big_trunk_run(smi)
    gemm_bf16a = gemm_bf16a_run(smi)
    b6 = dsmil_kernel_vs_plain(smi)
    dsmil_serve = dsmil_serve_run(smi)
    dsmil_train = dsmil_train_run(smi)
    b7_launches = fused_vit_attention.launches
    b7 = vit_attn_b7_vs_plain(smi)
    with tempfile.TemporaryDirectory() as tmp:
        reader_check(smi, tmp)
        pipe = pipeline_run(smi, tmp)
        corpus = mha_run(smi, tmp, pipe)
        clam = clam_run(smi, tmp, pipe, corpus)
        zoo = zoo_run(smi, tmp, pipe, corpus)
        transmil_mhim = transmil_mhim_run(smi, tmp, pipe, corpus)
        p20 = dtfd_sam_resnet_run(smi, tmp, pipe, corpus)
        p21 = mesh_run(smi, tmp, pipe, corpus)
        del corpus
        p22 = step2_mesh_run(smi, tmp, pipe)
        p23 = scan_epoch_run(smi, tmp)
        p25 = scan_mesh_run(smi, tmp, p23)
    p24 = vit_dtypes_run(smi)
    zoo["archs"].update(transmil_mhim.pop("archs"))
    zoo["transmil_mhim"] = transmil_mhim
    zoo["dtfd_sam_resnet"] = p20
    zoo["mesh"] = p21
    b7_f32 = p22.pop("b7_f32")
    b7["max_abs_err_tp_calls"] = b7_f32.pop("tp_calls_mma")
    b7["max_abs_err"] = max(b7["max_abs_err"],
                            *b7["max_abs_err_tp_calls"].values())
    zoo["step2_mesh"] = p22
    zoo["vit_dtypes"] = {"step2": p24["step2"], "trunks": p24["trunks"],
                         "b3_f16": p24["b3_f16"], "b3_f32": p24["b3_f32"],
                         "seconds": p24["seconds"]}
    s24 = p24["step2"]
    zoo["scan_epoch"] = {k: p23[k] for k in (
        "buckets", "graph_vs_eager_max_diff", "capture_ms", "pool_bytes",
        "first_graph_epoch_s", "epochs", "stkim_select_ms", "stkim_host_ms",
        "stkim_n", "heads", "families", "seconds")}
    zoo["scan_mesh"] = p25
    scan_cli, scan_graph = p23["launches_cli"], p23["launches_graph"]
    fam23 = p23["families"]
    scan_sam = fam23["cases"]["ga+sam"]["launches"]
    scan_dtfd = fam23["cases"]["dtfd+fused"]["launches"]
    sam_cli = fam23["cli_sam"]["launches"]
    mesh_ga, mesh_cli = p21["ga_seq2"]["ranks"], p21["data2_seq2_cli"]
    dtfd_t, dtfd_r, sam = p20["dtfd_train"], p20["dtfd_routes"], p20["sam"]
    b5_edges = b7.pop("b5_edges")
    vit["B5"]["max_abs_err"] = max(vit["B5"]["max_abs_err"],
                                   b5_edges["max_abs_err"])
    vit_src = "acmil_tpu_torch/csrc/vit_gemm.cu + acmil_tpu_torch/csrc/vit_attn.cu"
    print(json.dumps({"zoo": zoo}))
    print(json.dumps({"kernels": [{
        "name": "B1 fused gated-attention pooling (forward)",
        "route": "cuda",
        "source": "acmil_tpu_torch/csrc/attn_pool.cu",
        "replaces": "acmil_tpu/ops/attn_pool.py:54",
        "launches": train_launches["B1"],
        "launches_serving": serve_launches,
        "launches_step2_scoring": step2["B1"],
        "launches_natural_supervised_serving": wide_serve,
        "launches_natural_supervised_training": wide_train["B1"],
        "launches_pipeline_step3": pipe["B1_step3"],
        "launches_pipeline_predict": pipe["B1_predict"],
        "launches_pipeline_step4": pipe["B1_step4"],
        "launches_clam_sb_step3": clam["clam_sb"]["B1"],
        "launches_clam_mb_step3": clam["clam_mb"]["B1"],
        "launches_clam_sb_predict": clam["clam_sb"]["B1_predict"],
        "launches_clam_mb_predict": clam["clam_mb"]["B1_predict"],
        "launches_clam_mb_step4": clam["B1_step4"],
        "launches_clam_dropout_epoch": clam["dropout_epoch"]["B1"],
        "launches_dtfd_step3": dtfd_t["B1"],
        "launches_dtfd_predict": dtfd_t["B1_predict_card"],
        "launches_dtfd_natural_supervised_step3":
            dtfd_t["natural_supervised"]["B1"],
        "launches_sam_step3": sam["B1"],
        "launches_sharded_step3": mesh_cli["B1_step3"],
        "launches_sharded_eval": mesh_cli["B1_eval"],
        "launches_sharded_step_seq2": sum(r["B1"] for r in mesh_ga),
        "launches_mesh_nccl_world1": p21["nccl_world1"]["B1"],
        "launches_scan_epoch_step3": scan_cli["B1"],
        "launches_scan_graph_epochs": scan_graph["B1"],
        "launches_scan_sam_graph": scan_sam["B1"],
        "launches_scan_dtfd_graph": scan_dtfd["B1"],
        "launches_scan_sam_cli": sam_cli["B1"],
        "launches_scan_mesh_nccl_world1": p25["nccl_world1"]["B1"],
        "launches_scan_mesh_data2": p25["data2"]["B1"],
        "launches_scan_mesh_data2_seq2": p25["data2_seq2"]["B1"],
        "dtfd_call": dtfd_r["B1_call"],
        **b1}, {
        "name": "B2 fused gated-attention pooling (backward)",
        "route": "cuda",
        "source": "acmil_tpu_torch/csrc/attn_pool_bwd.cu",
        "replaces": "acmil_tpu/ops/attn_pool.py:240",
        "launches": train_launches["B2"],
        "launches_natural_supervised_training": wide_train["B2"],
        "launches_pipeline_step3": pipe["B2"],
        "launches_clam_sb_step3": clam["clam_sb"]["B2"],
        "launches_clam_mb_step3": clam["clam_mb"]["B2"],
        "launches_clam_dropout_epoch": clam["dropout_epoch"]["B2"],
        "launches_dtfd_step3": dtfd_t["B2"],
        "launches_dtfd_natural_supervised_step3":
            dtfd_t["natural_supervised"]["B2"],
        "launches_sam_step3": sam["B2"],
        "launches_sharded_step3": mesh_cli["B2_step3"],
        "launches_sharded_step_seq2": sum(r["B2"] for r in mesh_ga),
        "launches_mesh_nccl_world1": p21["nccl_world1"]["B2"],
        "launches_scan_epoch_step3": scan_cli["B2"],
        "launches_scan_graph_epochs": scan_graph["B2"],
        "launches_scan_sam_graph": scan_sam["B2"],
        "launches_scan_dtfd_graph": scan_dtfd["B2"],
        "launches_scan_sam_cli": sam_cli["B2"],
        "launches_scan_mesh_nccl_world1": p25["nccl_world1"]["B2"],
        "launches_scan_mesh_data2": p25["data2"]["B2"],
        "launches_scan_mesh_data2_seq2": p25["data2_seq2"]["B2"],
        "dtfd_call": dtfd_r["B2_call"],
        **b2}, {
        "name": "B3 fused ViT layer (chain: 4 GEMM launches, 2 of them "
                "after a LayerNorm prologue, + B5')",
        "route": "cuda",
        "source": vit_src,
        "replaces": "acmil_tpu/ops/vit_layer.py:45",
        "launches": step2["B3"],
        "launches_pipeline_step2": pipe["B3"],
        "launches_step2_float16": s24["f16"]["launches"]["B3"],
        "launches_step2_float32": s24["f32"]["launches"]["B3"],
        "float16_layer": p24["b3_f16"],
        "float32_layer": p24["b3_f32"],
        **vit["B3"]}, {
        "name": "B4 fused ViT attention half (chain: 2 GEMM launches, one "
                "after a LayerNorm prologue, + B5')",
        "route": "cuda",
        "source": vit_src,
        "replaces": "acmil_tpu/ops/vit_layer.py:239",
        "launches": big["B4"],
        "launches_trunks_float16_float32": {
            k: v["launches"]["B4"] for k, v in p24["trunks"].items()
            if v["route"] == "half"},
        **vit["B4"]}, {
        "name": "B5 packed multi-head attention (B5')",
        "route": "cuda",
        "source": "acmil_tpu_torch/csrc/vit_attn.cu",
        "replaces": "acmil_tpu/ops/vit_attn_packed.py:37",
        "launches": step2["B5"],
        "path": "Step2 ViT-S/16, the attention step of B3; times at its "
                "shape, B=256 N=197",
        "launches_vit_encode": big["B5'"],
        "launches_pipeline_step2": pipe["B5"],
        "edge_checks": b5_edges["checks"],
        "clip_l_b32": vit["B5 CLIP-L"],
        "launches_step2_float16": s24["f16"]["launches"]["b5_f16"],
        "launches_step2_float32": s24["f32"]["launches"]["b5_tf32x3"],
        **vit["B5"]}, {
        "name": "B6 fused DSMIL bag-stream pooling",
        "route": "cuda",
        "source": "acmil_tpu_torch/csrc/dsmil_pool.cu",
        "replaces": "acmil_tpu/ops/dsmil_pool.py:37",
        "launches": dsmil_serve["launches"] + dsmil_train,
        "launches_serving": dsmil_serve["launches"],
        "launches_training_eval": dsmil_train,
        "launches_scan_eval_graph": p23["heads"]["dsmil_eval"]["B6_replays"]
        + p23["heads"]["dsmil_eval"]["B6_warm"],
        "launches_scan_sam_eval_graph": fam23["sam_eval"]["B6_replays"]
        + fam23["sam_eval"]["B6_warm"],
        "launches_scan_mesh_eval_data2": p25["dsmil_eval_data2"]["B6"],
        **b6}, {
        "name": "B7 multi-head attention over separate q, k, v, tensor-core "
                "route (bfloat16, dh in {16, 32, 64, 128}; the strided entry "
                "of B5')",
        "route": "cuda",
        "source": "acmil_tpu_torch/csrc/vit_attn.cu",
        "replaces": "acmil_tpu/ops/vit_attn.py:39",
        "launches": p22["B7_mma_path"],
        "path": "Step2 --mesh_model: the tensor-parallel block's local "
                "attention, phase 22 (c)-(e) summed over the ranks; times at "
                "ViT-S/16 B=256 bf16 (phase 14)",
        "launches_phases_3_13": b7_launches,
        **b7}, {
        "name": "B7 multi-head attention over separate q, k, v, fma route "
                "(float16 and bfloat16 off the tensor cores' head widths, "
                "float32 at dh 48, 80, 256, unaligned views)",
        "route": "cuda",
        "source": "acmil_tpu_torch/csrc/vit_attn_generic.cu",
        "replaces": "acmil_tpu/ops/vit_attn.py:39",
        "launches": p22["B7_fma_path"],
        "path": "Step2 tensor parallelism, phase 22 (c), (e), (f) summed "
                "over the ranks: 0 since f32 takes the tf32x3 route; its "
                "checks in (g) at the widths it still serves; times at "
                "ViT-S/16 B=256 float32 through _launch_fma",
        **b7_f32["fma"]}, {
        "name": "gemm_f16: the GEMM of B3/B4 at float16 (TMA + wgmma "
                ".f16, LayerNorm prologue to fp16 rows)",
        "route": "cuda",
        "source": "acmil_tpu_torch/csrc/vit_gemm.cu",
        "replaces": "acmil_tpu/ops/vit_layer.py:45",
        "launches": s24["f16"]["launches"]["gemm_f16"],
        "path": "Step2 ViT-S/16 at float16 through B3 (phase 24); times "
                "summed over B3's four calls at B=256",
        **p24["gemm_f16"]}, {
        "name": "gemm_f32: the GEMM of B3/B4 at float32 (TMA + "
                "split-TF32 wgmma .tf32, W split once a call, f32 accuracy, "
                "LayerNorm prologue to f32 rows)",
        "route": "cuda",
        "source": "acmil_tpu_torch/csrc/vit_gemm_f32.cu",
        "replaces": "acmil_tpu/ops/vit_layer.py:45",
        "launches": s24["f32"]["launches"]["gemm_f32"],
        "path": "Step2 ViT-S/16 at float32 through B3 (phase 24); times "
                "summed over B3's four calls at B=256 (device: products, W's "
                "splits, LayerNorm prologues); bound at TF32 x 3; "
                "tf32_library_ms: TF32 torch.matmul, one TF32 product",
        **p24["gemm_f32"]}, {
        "name": "gemm_bf16a: the float32 GEMM's bf16-A mode (bf16 A by TMA, "
                "widened in registers, f32 W split once a call, two TF32 "
                "products a product, LayerNorm prologue to bf16 rows, bf16 "
                "residual and output)",
        "route": "cuda",
        "source": "acmil_tpu_torch/csrc/vit_gemm_f32.cu",
        "replaces": "acmil_tpu/models/encoders/fast.py:42 (the MLP half's "
                    "f32 products of a bf16 trunk)",
        "launches": big["gemm_bf16a"]["UNI ViT-L/16"],
        "path": "vit_encode at UNI ViT-L/16, depth 2, B=32 (phase 10): fc1 "
                "and fc2 of each block's MLP half; at CLIP-L/336 qkv and "
                "proj of route 3's attention half; times at UNI's fc1 and "
                "fc2 and GigaPath's fc1 (SwiGLU), M = 256 x 197 (device: "
                "product, W's split, LayerNorm prologue); bound at TF32 x "
                "2; library_ms: f32 torch.matmul, TF32 off",
        "launches_clip_l": big["gemm_bf16a"]["CLIP-L/336"],
        **gemm_bf16a}, {
        "name": "b5_f16: B5' at float16 on the tensor cores",
        "route": "cuda",
        "source": "acmil_tpu_torch/csrc/vit_attn.cu",
        "replaces": "acmil_tpu/ops/vit_attn_packed.py:37",
        "launches": s24["f16"]["launches"]["b5_f16"],
        "path": "Step2 ViT-S/16 at float16, B3's attention step (phase "
                "24); times at B=256 N=197",
        **p24["b5_f16"]}, {
        "name": "b5_f32_fma: B5' at float32 through B7's fma route on "
                "strided views of the packed qkv (its route before the "
                "tf32x3 route)",
        "route": "cuda",
        "source": "acmil_tpu_torch/csrc/vit_attn_generic.cu",
        "replaces": "acmil_tpu/ops/vit_attn_packed.py:37",
        "launches": s24["f32"]["launches"]["b5_fma"],
        "path": "Step2 ViT-S/16 at float32 (phase 24): 0 since B3's "
                "attention step takes the tf32x3 route; times at B=256 N=197 "
                "through _launch_fma on the same views; bound at TF32 x 3",
        **{k: p24["b5_f32"][k] for k in (
            "plain_ms", "library_ms", "bound_ms", "bound_by",
            "fma_bound_ms")},
        **p24["b5_f32"]["fma_route"]}, {
        "name": "b5_b7_f32_tf32x3: B5' and B7 at float32 on the tensor "
                "cores, split-TF32 mma.sync in one pass (the tf32x3 route)",
        "route": "cuda",
        "source": "acmil_tpu_torch/csrc/vit_attn_f32.cu",
        "replaces": "acmil_tpu/ops/vit_attn_packed.py:37 + "
                    "acmil_tpu/ops/vit_attn.py:39",
        "launches": s24["f32"]["launches"]["b5_tf32x3"],
        "path": "Step2 ViT-S/16 at float32, B3's attention step (phase 24); "
                "times at B=256 N=197; bound at TF32 x 3",
        "launches_trunks_float32": {
            k: v["launches"]["b5_tf32x3"] for k, v in p24["trunks"].items()
            if k.endswith("f32")},
        "launches_tp_float32": p22["B7_tf32x3_path"],
        "b7": b7_f32["tf32x3"],
        **{k: v for k, v in p24["b5_f32"].items() if k != "fma_route"}}]}))
    print(f"card: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
