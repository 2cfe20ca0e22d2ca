#!/usr/bin/env python3
"""Run the PyTorch port (``lidarcrafter_tpu_torch``) on one NVIDIA GPU and
check it; the quickest proof that the port still builds and starts there.

Phases, each printing one JSON line:

1. device and build: the card's name and power limit, the ``nvcc`` build of
   ``lidarcrafter_tpu_torch/csrc/*.cu`` (four sources, one ``nvcc`` each, in
   parallel) and the loader's ``x·2`` self-check, with the probe kernel's
   device time beside its bound and ``torch.mul(x, 2)``; each Hopper-core
   kernel's ptxas registers, static shared memory and spills, and the
   core's plan mirrors (``attention.plan``, ``oaca.plan``) against the
   library's own at every attention head-dim pair and OACA instantiation;
2. every kernel against its plain PyTorch version on the card, at the main
   paths' shapes and at ragged / masked edges, in float32 (TF32 off) and
   bfloat16, held to a limit on the largest error and one on the error's
   norm, with the kernel's, the plain version's and one PyTorch library
   call's device times, the least time the card could take (no row may
   read below it), and the route the wrapper took (``wgmma bf16`` / ``tma
   mma 3xTF32`` on the Hopper core of ``hopper_flash.cuh``: bf16 at every
   head dim, float32 for OACA at head dims 64 and attention above 128;
   ``mma 3xTF32`` on ``flash_mma.cuh``'s cp.async loader for float32 at
   attention head dims up to 128 and OACA's 32-wide builds; where both
   routes exist the row holds each, by name, against the plain version and
   carries both times, the replaced ``mma.sync`` one as ``earlier_ms``; the
   wide heads' and OACA 64³'s rows carry their replaced route's from the
   kernel table (``EARLIER_MS``); GroupNorm on the CUDA cores as
   ``one-launch grid-sync``: one launch per norm, at most one block per SM
   with a grid sync, fed the modules' raw operands: weight, bias and the
   strided scale/shift halves of the conditioning projection), and
   GroupNorm at the layout branch's UNet1D token shapes, (104, 1, 512) and
   (104, 1, 1024) with eps 1e-5 and (104, 1, 512) with eps 1e-6, float32
   (as the branch serves) and bfloat16 (as it trains under AMP); and the
   shapes of phase 11: OACA at head dims 64 (the v0 stack, ds4 L=2048 and a
   ragged L=1000, 8 heads), GroupNorm on v0's (8, 32·1024, 256) and
   (8, 32·1024, 512) slabs and kitti-360's (8, 64·1024, 64) AdaGN, and
   attention at kitti-360's 1,024 tokens (head dims 64 and 32); the GLIDE
   block's attention (ds 4 and 8, 13 encoder tokens in front) and OACA at
   positional head dims 16 and 64, which phase 14 timed before;
3. full-width forwards on the card with the kernels against the same
   forwards on the CPU with the plain versions, shared seeded weights: the
   layout stack (encoder + ``LayoutUnetV1``, 32x1024) and ``EfficientUNet``
   (``nuscenes-unet-uncond``, 32x1024), in float32 and served in bfloat16
   (``to_serving_dtype_`` and the engine's ``dtype``);
4. the main paths, each with the launch counters set to 0 just before it
   and read just after, seeded random weights, 8 frames a request:
   ``CondFrameGenerator`` for ``nuscenes-box-layout-v6`` and
   ``UncondFrameGenerator`` for ``nuscenes-unet-uncond`` (DDIM@25 and
   DPM-Solver++(2M)@15 each), then ``FlowFrameGenerator`` for
   ``meanflow-nusc`` (one step), all in float32; then each path served in
   bfloat16 answers one request (DPM-Solver++(2M)@15, MeanFlow one step);
5. a ``torch.profiler`` trace of one denoiser call of the layout and of the
   unconditional path (after one warm-up cycle of the trace, and queued
   behind a ~20 ms sleep: the trace drops the kernels of its first
   milliseconds), in float32 and in bfloat16: device time by kernel
   category, the device kernels launched per call and the device's idle
   share; the ``groupnorm kernel`` category must hold exactly one device
   kernel per norm (101 a layout call, 50 an uncond call): a trace with
   more fails, one with fewer is taken again, up to three traces, each
   reported;
6. the 4D rollout, in float32 and then served in bfloat16:
   ``RolloutGenerator`` (``nuscenes-box-layout-v6`` frame 0,
   ``nuscenes-auto-reg-v2`` after it) rolls 8 synthetic scenes of 4 boxes
   1 + 7 frames with DPM-Solver++(2M)@15, after one short warm-up, with
   the launch counters set to 0 just before and read just after: rollout
   seconds and frames/s, the geometry step's device time per frame and the
   denoiser calls' (CUDA events around each), peak memory; checks 8 finite,
   non-constant (8, 32, 1024, 2) frames, exactly 11·15·8 OACA and
   101·15·8 GroupNorm launches, and one frame's geometry step on the card
   against the CPU from the same frame (condition maps equal to 1e-5 on at
   least 99.9% of the pixels; the rest are bin-edge flips);
7. training ("train"): (a) each kernel route's backward (the float32
   recompute of its plain version) on the card against autograd through the
   plain version, float32 and bfloat16, at the largest main-path shapes, to
   the forward rows' limits, timed beside the library's forward + backward
   (SDPA with the layout strip concatenated; ``F.group_norm`` with affine
   only); (b) one full-width ``nuscenes-box-layout-v6`` step at B=1 in
   float32, card (kernels) against CPU (plain), same weights, x_0, t, noise
   and conditions: loss to 1e-4 relative, every gradient to 1e-3 relative
   L2; (c) ``Trainer`` on ``nuscenes-box-layout-v6`` and
   ``nuscenes-unet-uncond`` at B=8, float32 and bf16 AMP, 2 warm-up and 3
   timed steps: steps/s, frames/s, peak memory, and exactly 11 OACA + 101
   GroupNorm launches a layout step, 2 attention + 50 GroupNorm an uncond
   step, and a profile of one float32 step (the AMP steps' launches are
   counted, not traced; phase 9's trainers alike); (d) ``nuscenes-auto-reg-v2`` at full width, B=2, float32, 30
   steps on banded synthetic range images (lr 1e-4, warm-up 20): the mean
   of the last 10 losses must lie below that of the first 10; (e) its
   checkpoint read back through ``sample_temporal``'s ``--autoreg-ckpt``
   loader, EMA weights equal bit for bit, and one DPM-Solver++(2M)@15 frame
   sampled from them, finite;
8. the layout and object branches, float32 at their published widths:
   (a) ``LayoutGenerator`` (``nuscenes-layout``) on 8 synthetic scene
   graphs of ego + 12 objects (N = 104 nodes): the ``SceneGraph`` latent
   and one denoiser call (``SceneGraph`` + ``UNet1DModel``) on the card
   against the CPU to 1e-3, exactly 56 GroupNorm launches in that call and
   56 GroupNorm device kernels in a profiled one (device busy, idle
   share), then a DDPM@256 and a DDIM@50 request with the counters set to
   0 just before and read just after (56 a denoiser call): seconds, ms a
   call, finite samples, and finite centres, yaw and trajectories after
   ``unscale_boxes_3d`` (the share of finite sizes is reported: an
   untrained denoiser's unclipped x̂_0 can overflow exp(log size));
   (b) ``ObjectGenerator`` (``nuscenes-object``) on the 96 objects of those
   scenes × 1024 points: one call card vs CPU to 1e-3, a profile, both
   requests, finite clouds; no kernel of the port runs there, and every
   launch counter must stay at 0;
9. branch training ("branch_train"): (a) the forward-mode routes of the
   attention (``d_block4``, ``u_block4``) and GroupNorm (the uncond level-0
   AdaGN, ds8) kernels under ``torch.func.jvp`` and ``forward_ad``, float32
   and bfloat16, one kernel launch a call, primal and tangent against
   ``torch.func.jvp`` through the plain version to the forward rows'
   limits, timed beside that plain jvp and the least time the card could
   take; (b) one full-width float32 step of ``LayoutTrainer``
   (``nuscenes-layout``, 8 scenes of ego + 12, budgets 112 / 3,536),
   ``ObjectTrainer`` (``nuscenes-object``, 96 objects × 1024 points) and
   ``FlowTrainer`` (``meanflow-nusc``, the MeanFlow JVP loss, B=1), card
   against CPU on the same weights, batch and draws: loss to 1e-4
   relative, every gradient to 1e-3 relative L2; (c) each trainer at B=8 (8
   scenes for the layout), float32 and bf16 AMP, as phase 7 (c), with
   exactly 56 GroupNorm launches a layout step, 2 attention + 50 GroupNorm
   a MeanFlow step and none an object step; (d) a 30-step loss gate of
   each (lr 1e-4, warm-up 20; 8 scenes, 96 objects, MeanFlow at B=2) and
   its checkpoint served
   through the branch's generator (EMA weights and running statistics bit
   for bit, finite samples);
10. the metric suite ("evaluate") over phase 6's float32 rollout as host
   clouds (scenes 0-3 "real", 4-7 "gen", 32 clouds each), with a RangeNet-53
   (32x1024, 4,096 features) and a PointNet (k=16, 2,048 points) of seeded
   weights: ``EvaluationEngine`` (frd, fpd and their squared MMDs, BEV jsd
   and mmd), ``evaluate`` (cd and the chamfer mmd on 8 aligned pairs, emd
   on them resampled to 2,048 points, jsd, and frid through a pretrained
   folder written from the RangeNet-53), ``sequence_tcd`` (splits 1-4) of
   each scene, and ICP recovering a 3° / (1.0, 0.5, 0) m motion of a frame
   to 0.05 m; every metric again through the port on the CPU (the engine's
   from the card's cached features; cd, mmd and TCD on clouds resampled to
   2,048 points on both sides, as a CPU chamfer grows with N²; the features
   and FRID descriptors of 8 clouds turned half a pixel, off the bin edges
   their points lie on), held to 1e-4 relative (cd, jsd, mmd, TCD), 1e-3
   (Fréchet distances in float64, emd) and 1e-3 relative L2 (features);
   device times of the RangeNet-53 / PointNet features and the BEV histogram
   a cloud, one chamfer at 32,768², one EMD at 26,624 points, the Fréchet
   distance and squared MMD of 2,000 x 4,096 features, peak memory; no
   kernel of the port launches;
11. the rest of the registry's image configs ("zoo"), at full width, seeded
   random weights: ``nuscenes-box-layout`` (v0: ``LayoutUnet``, OACA at
   head dims 64, 6 a call), ``nuscenes-box-layout-v5`` (served from a
   batch with the v5 encoder's inputs), ``nuscenes-auto-reg`` (12 encoder
   channels), ``kitti-360`` (64x1024) and ``nuscenes-hdit-uncond`` (HDiT,
   plain PyTorch): one forward card vs CPU as phase 3 (f32 1e-3, bf16
   5e-2; HDiT's bf16 call against the CPU's bf16 call, since its serving
   cast rounds the Fourier time features as the JAX package's does, and
   its gap to float32 reported), then one B=8 DPM++(2M)@15 request each
   in float32 and in bfloat16 through ``CondFrameGenerator`` /
   ``UncondFrameGenerator``, the counters set to 0 just before and read
   just after (exactly one OACA per ``ObjectAwareCrossAttention``, one
   attention per attention block, one GroupNorm per norm module, a call;
   HDiT none), with seconds, frames/s and peak memory; a profile of one
   v0 and one HDiT call; then on ``nuscenes-unet-uncond`` one RePaint
   request (10 steps x 2 resamplings x jump 2, every other beam known:
   the known beams held to (1 − α(0)) + 6·σ(0)) and one
   ``DiscreteDiffusion`` DDPM@50 request (1,000 training steps, set on
   the config: the registry leaves them unset);
12. released checkpoints and the CLIP text tower ("ingest"): for one config
   of each architecture pair that the JAX route ingests (v6, v0,
   ``nuscenes-unet-uncond``, ``meanflow-nusc``, ``nuscenes-hdit-uncond``,
   ``nuscenes-layout``, ``nuscenes-object``; v5 is refused there) at full
   width, an upstream-format engine ``.pth`` written from seeded port
   modules through the inverse tables (online weights 1.0 off the EMA
   ones), converted by ``python -m lidarcrafter_tpu_torch.convert_checkpoint``
   (all seven processes at once, on the CPU) and loaded through the
   generator's ``ckpt=`` on the card: every tensor equal to its source bit
   for bit, one denoiser call against the source modules on the CPU to
   1e-3 with exact launches (11 OACA + 101 GroupNorm v6, 6 + 67 v0, 2
   attention + 50 GroupNorm uncond and MeanFlow, 56 GroupNorm layout, none
   HDiT and object); then the CLIP text tower at ViT-B/32 text width
   (vocab 49,408, context 77, width 512, 8 heads, 12 layers, 512-d),
   seeded weights under OpenAI's names saved as a state dict and as a
   TorchScript archive, each loaded on the card with a synthetic merges
   table (the same features, bit for bit), the class and relationship
   words card vs CPU to 1e-4; then words to frames: 8 synthetic scenes of
   ego + 12 objects through ``build_scene_graph_info``,
   ``SceneGraphAssigner`` (train-split edits) and ``collate_scene_graphs``
   with that tower's features, the converted ``nuscenes-layout`` stack
   serving them with DDIM@50 (56 GroupNorm launches a call) and its boxes
   conditioning the converted v6 stack in one DPM++(2M)@15 request (11 +
   101 a call), finite frames; conversion seconds per config, CLIP ms a
   batch of words and the request seconds, beside the card's name and
   power limit; ``build_clip_cache`` on the card with that archive:
   ``obj-text`` (the 9 class names' features against the CPU tower to
   1e-4) and ``warm-cache`` over a small synthetic tree's val split into
   an empty cache (its ``CLIP_%07d.pkl`` files written, finite);
13. training from nuScenes-format files ("data"): a synthetic tree
   (``utils/synthetic.py::write_nuscenes_tree``: 2 scenes x 4 frames a
   split, 35,000-point clouds at uniform random angles and depths, lidarseg
   labels, info pickles, a GT database, a CLIP cache); the dataset's host
   projection of 3 clouds against the card's (no pixel's winner may differ,
   depth to a float32 ulp) with the ms of each; the loader's batches/s at 0
   and 4 threads; ``nuscenes-auto-reg-v2`` at full width through
   ``train.main`` (B=2, bf16 AMP, 4 loader threads, ``JsonlTracker``, the
   profiling window over steps 4-6, 10 steps and one DDIM@10 preview on
   the EMA weights at the last: exactly 11 OACA + 101 GroupNorm launches a
   forward, 20 forwards; finite losses, no ``preview_error``, PNGs that
   decode; steps/s over steps 6-10 and the device's idle share) against
   the same run on the synthetic source, run first; ``nuscenes-unet-uncond``,
   ``nuscenes-layout`` and ``nuscenes-object`` 2 steps each from files
   (2 + 50, 56 and no launches a step); and ``torchrun --nproc-per-node 1``
   (NCCL) for 2 steps of ``nuscenes-box-layout-v6`` with
   ``--deterministic``, at once with the same 2 steps without a process
   group, whose losses it must equal bit for bit; and
   ``sample_and_save_cond --synthetic 15`` (``nuscenes-auto-reg-v2`` at
   full width, two batches of 8, DDIM@2: exactly 11 OACA + 101 GroupNorm a
   call, 15 dumps named as the JAX tool names them, read back as points).

14. the rest of the model registry ("registry"), at full width (32x1024,
   64 model channels, multipliers (1, 2, 4, 8), 2 residual blocks,
   attention at ds 4 and 8, B=8): (a) the attention kernel at OpenAIUNet's
   wide heads (one head of 256 over 2,048 tokens, one of 512 over 512, a
   ragged 384-wide case with a ``kv_len`` mask), float32 and bfloat16,
   each against its plain version at phase 2's limits, beside SDPA and the
   bound (phase 2 holds the GLIDE block's shapes, the v6 stack's ds 4, 8
   heads of 32 over 2,048 queries and 13 + 2,048 keys, and ds 8, 16 heads
   over 512 and 13 + 512: per-head views of the [q|k|v]-packed projection,
   the encoder's K/V in front, and OACA at positional head dims 16 and 64
   on the ds 4 v6 shape); (b) forwards card vs CPU (float32 1e-3, bfloat16
   5e-2 against the float32 CPU forward): ``OpenAIUNet`` with GLIDE blocks
   at its default heads and with ``SpatialTransformer``s of 32-channel
   heads over a (B, 13, 64) context (B=1), the v6 stack with GLIDE blocks,
   ``LiDARGenRefineNet`` (base 128, multipliers (1, 2, 2, 2), B=1, float32)
   and ``SpatialRescaler`` (bilinear and nearest, B=8, float32), HDiT with a
   Fourier-feature positional embedding and ``EfficientUNet`` with
   spherical harmonics (as phase 11's); (c) the GLIDE v6 stack served
   through ``CondFrameGenerator`` at B=8, DPM-Solver++(2M)@15, float32 and
   bfloat16, with exactly 11 attention and 68 GroupNorm launches a call
   (worked out from the block list), a profile of one float32 call (as
   many attention and GroupNorm device kernels), and ``OpenAIUNet`` at B=8,
   ms a forward in float32 and bfloat16 (11 attention, 56 GroupNorm);
   (d) one GLIDE v6 training step card vs CPU as phase 7 (b), then 2 steps
   each of ``nuscenes-box-layout`` (v0), ``nuscenes-hdit-uncond`` and the
   GLIDE v6 stack through ``train.main`` at B=2 on the synthetic source,
   finite losses and exact launches (the forward's, twice).
15. the sparse 3D stack ("sparse"), plain PyTorch: (a) MinkowskiNet and
   SPVCNN at upstream's eval widths (``DEFAULT_LAYERS`` at cr 0.5, 4 input
   dims, 17 classes) of seeded weights, written as torchsparse
   ``model.ckpt`` files under a pretrained root, FSVD and FPVD through
   ``evaluate --pretrained-root`` at 32,768 points a cloud over phase 6's
   rollout clouds; card vs CPU: the level-0 voxel coordinates and masks of
   4 clouds exactly, their descriptors to 1e-3 of the largest, FSVD / FPVD
   on the CPU from the card's descriptors to 1e-3; ms a cloud of each
   backbone's descriptor (CUDA events); (b) Voxel R-CNN (CenterHead with
   the six nuScenes class groups and the RoI head) from a pcdet file of
   seeded weights at ±54 × [-5, 3] m and (0.075, 0.075, 0.2) m, 65,536
   voxels: ``predict`` on 4 rollout clouds (seconds a cloud), the voxel
   coordinates exactly and the dense head maps to 1e-3 of the largest on 2
   of them against the CPU, and the same NMS keep set on the card and on
   the CPU from the card's boxes and scores; (c) ``evaluate_detection`` and
   ``extract_foreground`` on the card (``--pcdet-ckpt`` and
   ``--random-params``) over 2 clouds with synthetic ground truth; (d)
   every kernel counter at 0.
16. the object-level metrics ("objects"), plain PyTorch, seeded weights at
   full width: (a) CGF: PointMLP (``point_mlp(4)``, 1,024 points) over 512
   synthetic box-normalised crops at B = 32; card vs CPU on 16 crops: the
   first stage's FPS indices, the logits (1e-4 of the largest) and the CGF
   dictionary; one batch traced (kernels, busy ms, idle share, the sorts'
   share); (b) RGF: GLENet at exp20 (latent 8, 512 points), 10 folds ×
   30 passes over the same crops at B = 64, the normal draws from a CPU
   generator on both sides; fold 0's 30 passes card vs CPU (variances and
   overlaps to 1e-4), and traced; (c) DCF on phase 15's Voxel R-CNN
   detections; (d) 20 steps of each trainer through its CLI
   (``train_pointmlp`` B = 32, ``train_glenet`` one fold B = 64,
   ``train_rangenet`` RangeNet-53 B = 8 at 32 × 1,024): finite losses that
   fall (PointMLP at lr 0.02: the default 0.1 does not fall in 20 steps;
   GLENet's reconstruction loss, the total being annealed), steps/s; one
   step of each card vs CPU (PointMLP B = 4 and GLENet in float64,
   RangeNet-53 B = 1 in float32), every parameter and running statistic
   to 1e-4; one float32 step of PointMLP (B = 8) and GLENet (B = 64) card
   vs CPU: loss and running statistics to 1e-4, the update in relative L2
   to 2e-2 / 1e-3 (GLENet without the biases its loss's data term does
   not reach); (e) ``extract_foreground --gt-infos`` on the card over the
   rollout clouds (scenes 0-3 the ``ori`` arm, 4-7 the ``our`` arm; two
   car boxes and a truck box at the densest places of each cloud), then
   ``evaluate_our -m dcf cgf rgf obj --random-extractors`` on those crops
   (every ``obj`` number finite; the car crops' PointMLP features card vs
   CPU on 8, 1e-4; its Fréchet distance and squared MMD on the CPU from the
   card's features, 1e-3), and ``evaluate_r2dm --random-extractors`` on
   the rollout frames written as ``.pth`` dumps (generated) and point
   files (real); each writes its JSON; ms a batch of PointMLP and of
   GLENet, RGF seconds, the CLIs' seconds, each section's seconds;
   (f) every kernel counter at 0.

17. serving export ("export"): ``serving/export.py`` at full width, B=8,
   for ``nuscenes-box-layout-v6`` and ``nuscenes-auto-reg-v2`` (DPM++(2M))
   and ``nuscenes-unet-uncond`` (DDIM), in float32 (2 steps) and served in
   bfloat16 (1 step): the sampler traced on the card (the kernels are
   ``torch.library`` operators in the graph: exactly 112 / 52 a denoiser
   call), saved, loaded and replayed as ``fn(seed[, condition])`` with the
   counters set to 0 just before and read just after (one launch per
   operator call); its frames against the eager generator's for the same
   seed and condition (float32 1e-5 of the largest, bfloat16 5e-2; bit for
   bit expected); then the uncond float32 sampler traced on the CPU and
   moved to the card at load, whose replay launches the kernels and equals
   the card generator's frames to 1e-5; export, save and load seconds and
   artifact bytes.

18. the azimuth axis ("sp"; ``parallel/mesh.py``): two ranks share card 0
   (``torchrun --nproc-per-node 2`` of this script as ``chip_smoke.py
   sp-rank DIR NAME...``; each rank joins its group on card 0 over gloo:
   NCCL takes one rank a card) on a (1, 2) mesh, one pair of ranks for each
   of uncond, auto-reg-v2, v0 and HDiT, one for GLIDE v6, ``OpenAIUNet``,
   the discrete engine and MeanFlow in turn and one for the two branches,
   every pair at once, beside two processes (``chip_smoke.py sp-one``) running
   the one-process paths and train CLIs in turn.  At full width, B=2, seeded weights:
   ``nuscenes-unet-uncond``, ``nuscenes-auto-reg-v2``,
   ``nuscenes-box-layout`` (v0: zero-padded convs, OACA 64³ over gathered
   keys) and ``nuscenes-hdit-uncond`` one forward and a DDIM@2 sample in
   float32 and served in bfloat16, each rank on its 512 columns, gathered,
   against the same in this process (forwards to 1e-3 / 5e-2 of the
   largest; the float32 samples: 99.9% of the values within 1e-3 of the
   largest, or the share of one process's batch against its rows one at a
   time where that is lower; bfloat16 as ``SP_BF16_SAMPLE_FACTOR`` says); GLIDE v6,
   ``OpenAIUNet`` (phase 14's, GLIDE blocks of one head of 256 / 512) and
   the discrete engine over the uncond stack one forward in each dtype;
   ``meanflow-nusc`` one forward in each dtype, the tangent du/dt along
   (v, 1, 0) of its loss in float32 (to the forwards' limit) and its
   one-step sample in each dtype (as the DDIM@2 samples are held), each
   path's exchanges a call on its line;
   exact launches on each rank (a norm of image activations two GroupNorm
   launches, ``partials`` and ``apply``; OACA's token norms one; every OACA
   over gathered keys; the attention blocks one each; HDiT none); then
   ``train.py --sp 2``'s ``main`` on the ranks' group against the train CLI
   in one process, 2 float32 steps each from a synthetic nuScenes tree with
   ``--deterministic``, for
   the four stacks, MeanFlow and ``nuscenes-layout`` and
   ``nuscenes-object`` (whose ranks replicate): losses to 1e-5, the
   parameters and Adam's first moments after the steps to 1e-4 relative
   L2, exact launches; step seconds (all runs share the card at once: not a
   speed comparison).  Phase 2 holds the two GroupNorm launches at rank 0's
   half of the uncond level-0 AdaGN, and the ds4 shards (Lq 1,024) of OACA
   over gathered keys at 32³ and 64³ (Lk 2,048, and a ragged Lq 1,000 /
   Lk 2,000 at 64³), GLIDE v6's attention (13 + 2,048 keys) and
   ``OpenAIUNet``'s (one head of 256 over 2,048 keys), and the MeanFlow
   loss's tangents there: the split norm under ``torch.func.jvp`` (one
   ``gn_partials`` and one ``gn_apply`` launch) and ``attention_jvp`` at
   d_block4's shard (Lq 256 over 512 gathered keys).

The phases run in the order of their numbers, but for 14, 13, 15, 16 and
11, which run after 10; phases 17 and 18 then run in processes of their own
(``chip_smoke.py export-lane`` and the processes of phase 18, the latter at
nice 10) beside phase 12, which times host-bound conversions, and their
lines follow phase 12's.

Phase 4 also serves ``viewer.py`` on the card (full width, float32): one
``POST /api/sample`` of each of its four configs over HTTP (DDIM@2,
MeanFlow one step, v6 with two edited boxes) with exact launches.  Phase 8
also runs ``generate_box_condition --random-params --synthetic-scenes 2
--num-steps 8`` (no kernel launched; finite (3, 32, 1024) conditions).

Every phase ends with a ``phase seconds`` line, and the script with the
seconds of each.  Then a ``kernels`` JSON line (OACA, GroupNorm, attention,
the sharded ``groupnorm_partials`` / ``groupnorm_apply`` / ``oaca_gathered``
launches and the probe, which runs once when the kernels load; attention
with its ``glide`` and ``wide_heads`` rows, OACA with its
``positional_dims`` rows),
the ``nvidia-smi`` name/power-limit line and, last, ``{"ok": true,
"device": {...}}``.  Any failed check raises, so the
script exits non-zero; so does a machine without CUDA or a directory without
the port.

Usage: ``python3 chip_smoke.py`` (one card).
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import gzip
import io
import json
import math
import os
import pickle
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
DEVICE = "cuda"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
# peak rate of each route's operations: GroupNorm ("one-launch grid-sync") in
# f32 on the CUDA cores (bf16 is widened on load); OACA and attention on the
# tensor cores, f32 as 3xTF32 (three TF32 products each)
GN_ROUTE = "one-launch grid-sync"
# the azimuth-sharded GroupNorm's two launches (sp > 1): a shard's
# partials, then the norm from every shard's partials; CUDA cores as GN_ROUTE
GN_PARTIALS_ROUTE, GN_APPLY_ROUTE = "partials (grid-sync merge)", "apply (merge S partials)"
# the routes' backward and tangent: the plain version recomputed in float32
# (TF32 off); their bound is the same work at the peak of the operands' type
# (work_route), not that of the recompute
PLAIN_ROUTE = "plain f32 recompute"
PEAK_FLOPS = {GN_ROUTE: 67e12, GN_PARTIALS_ROUTE: 67e12, GN_APPLY_ROUTE: 67e12, "mma 3xTF32": 495e12 / 3,
              "mma bf16": 989e12}
# the Hopper routes (csrc/hopper_flash.cuh: TMA producer warp, two consumer
# warpgroups) bound the same work at the same peaks: bf16 on wgmma, f32 as
# 3xTF32 on mma.sync
PEAK_FLOPS |= {"wgmma bf16": PEAK_FLOPS["mma bf16"], "tma mma 3xTF32": PEAK_FLOPS["mma 3xTF32"]}
# device ms of the routes the Hopper core replaced (PERF.md's kernel table:
# OACA 64^3 on mma.sync and the wide heads' 128-wide chunks, H100 80GB HBM3
# at 700 W), beside this run's rows of the same shape
EARLIER_MS = {
    ("oaca", "v0 ds4 B=8 h=8 L=2048 d=64"): {"float32": 2.4571, "bfloat16": 0.4251},
    ("oaca", "v0 ragged B=8 h=8 L=1000 d=64"): {"float32": 0.6643, "bfloat16": 0.1187},
    ("attention", "wide B=8 h=1 L=2048 d=256"): {"float32": 1.3372, "bfloat16": 0.2434},
    ("attention", "wide B=8 h=1 L=512 d=512"): {"float32": 0.2755, "bfloat16": 0.0568},
    ("attention", "wide ragged B=8 h=2 L=1000 kv_len=777 d=384"): {"float32": 1.0426, "bfloat16": 0.2015},
}
TOL = {"float32": 1e-4, "bfloat16": 2e-2}  # max |kernel − plain| / max(1, max |plain|)
# ‖kernel − plain‖₂ / ‖plain‖₂: attention outputs average thousands of keys
# and are mostly far below 1, where the max-based limit is as large as a
# typical value; this one catches a fault on a few percent of the keys (a
# missed key tile, a missed fill).  A correct kernel reads about 2^-9 in
# bfloat16 (one rounding of the output) and 1e-5 or less in float32.
NORM_TOL = {"float32": 1e-3, "bfloat16": 1e-2}
FORWARD_RTOL = 1e-3  # card (kernels, cuDNN f32) vs CPU (plain), relative to max |CPU|
# card served in bfloat16 vs CPU float32, relative to max |CPU|: bfloat16 keeps
# 8 mantissa bits (2^-9 relative per rounding) through ~40-60 layers
BF16_FORWARD_RTOL = 5e-2
OACA_PER_FORWARD, GN_PER_FORWARD = 11, 101  # layout UNet, per denoiser call
ATTN_PER_UNET, GN_PER_UNET = 2, 50  # EfficientUNet / MFEfficientUNet, per call
REQUESTS = (("ddim", 25), ("dpmpp_2m", 15))
BATCH = 8
ROLLOUT_SCENES, ROLLOUT_FRAMES, ROLLOUT_STEPS = 8, 7, 15  # 1 + 7 frames, DPM++(2M)@15
GEOMETRY_RTOL, GEOMETRY_PIXEL_SHARE = 1e-5, 0.999  # card vs CPU condition maps
TRAIN_LOSS_RTOL, TRAIN_GRAD_RTOL = 1e-4, 1e-3  # one v6 step, card vs CPU
TRAIN_WARMUP, TRAIN_TIMED = 2, 3  # steps of the B=8 training runs
# the loss gates' steps (nuscenes-auto-reg-v2 on banded range images at B=2):
# 30 (in a 40-step run the losses at step 31 lay 38%, 65% and 11% below the
# mean of the first 10 on auto-reg-v2, layout and MeanFlow, at step 21 4%,
# 45% and 7%); the layout and MeanFlow branches, past the 4% of auto-reg-v2's
# warm-up at step 21, take 20 (the script's time goes to phase 18's MeanFlow
# pair); the object branch, whose loss falls by ~10% in 100 steps of ~13 ms
# each, keeps 100
GATE_STEPS, GATE_BATCH = 30, 2
GATE_STEPS_BY_CONFIG = {"nuscenes-object": 100, "nuscenes-layout": 20, "meanflow-nusc": 20}
# the layout and object branches: 8 scenes of ego + 12 objects (13 nodes, the
# frame stack's layout_length; N = 104), and the 96 objects of those scenes
LAYOUT_SCENES, LAYOUT_OBJECTS = 8, 12
BRANCH_REQUESTS = (("ddpm", 256), ("ddim", 50))  # DDPM@256 is the JAX tools' default
GN_PER_UNET1D = 56  # 22 ResBlock1D x 2, 11 SpatialTransformer1Token, the output norm
# a profiled call is queued behind a sleep of ~20 ms (4e7 cycles) and traced
# again while a category holds fewer kernels than expected (see phase_profile)
TRACE_SLEEP_CYCLES, TRACE_ATTEMPTS = int(4e7), 3


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3, sleep_cycles: int = int(5e7), gc_off: bool = True) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls.  The
    card sleeps first (5e7 cycles, ~30 ms at the H100's clock) while the
    host queues the calls, so launch-bound calls are timed on the device
    and not at the host's enqueue rate.  With ``gc_off`` (the kernel rows)
    Python's garbage collector runs once before and is off while the host
    queues, since a collection pause there longer than the sleep would read
    as the kernel's device time (late in a whole run a 0.8 ms jvp row read
    20–38 ms with it on).  End-to-end times (a denoiser call, a train step,
    a geometry step) pass ``gc_off=False``: a real call pays for its
    collections."""
    import gc

    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if gc_off:
        gc.collect()
        gc.disable()
    try:
        torch.cuda._sleep(sleep_cycles)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
    finally:
        if gc_off:
            gc.enable()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: int, flops: float, route: str) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[route] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def mma_route(dname: str) -> str:
    """The peak that bounds tensor-core work on ``dname`` operands: 3xTF32
    for float32, bf16 for bfloat16 (the kernel rows name the route each
    call took from its wrapper, ``attention.route`` / ``oaca.route``)."""
    return "mma 3xTF32" if dname == "float32" else "mma bf16"


def work_route(kernel: str, dname: str) -> str:
    """The route whose peak bounds a kernel's work on ``dname`` operands,
    forward, backward or tangent: the tensor cores for OACA and attention
    (their backward and tangent are matrix products too), the CUDA cores
    for GroupNorm."""
    return GN_ROUTE if kernel.startswith("groupnorm") else mma_route(dname)


def earlier(kernel: str, label: str, dname: str, ms: float) -> dict:
    """The replaced route's ms at this shape and the ratio of this run's to
    it, where the Hopper core took the shape over (else nothing)."""
    before = EARLIER_MS.get((kernel, label), {}).get(dname)
    return {} if before is None else {"earlier_ms": before, "ms_over_earlier": ms / before}


def hopper_ptxas(log: str) -> list:
    """Registers, static shared memory and spills of each kernel of the
    Hopper core (``hflash::flash_kernel`` instantiations) in nvcc's
    ``-Xptxas -v`` output.  The registers are those of the launch (168, or
    80 at two blocks an SM); the consumers raise theirs to 240 (104) with
    setmaxnreg.  Dynamic shared memory is the plan's (``attention.plan``,
    ``oaca.plan``)."""
    import re

    rows, cur, source = [], None, None
    for ln in log.splitlines():
        if ln.startswith("== "):
            source = ln.strip("= ")
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            cur = {"source": source, "entry": m.group(1), "static_smem": 0} if "flash_kernel" in m.group(1) else None
            if cur:
                rows.append(cur)
            continue
        if cur is None:
            continue
        if m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln):
            cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
        if m := re.search(r"Used (\d+) registers", ln):
            cur["registers"] = int(m.group(1))
            if sm := re.search(r"(\d+) bytes smem", ln):
                cur["static_smem"] = int(sm.group(1))
    return rows


# the Hopper core's instantiations: attention 7 bf16 (d <= 128: 3; wide: 4)
# + 6 f32 (3 + 3), OACA 3 bf16 ((32, 32 | 64, 32), 64^3) + 4 f32 (dp 16 too)
HOPPER_KERNELS = 20
OACA_HEAD_DIMS = ((32, 32), (32, 16), (32, 64), (64, 64))  # (dc, dp); dv = dc


def hopper_smem() -> dict:
    """The dynamic shared memory (bytes) a block of the Hopper core asks for
    at the kernel table's shapes, by the plans ``check_plans`` holds to the
    library's."""
    import torch

    from lidarcrafter_tpu_torch.kernels import attention, oaca

    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        for d in (32, 64, 128, 256, 512, 384):
            out[f"attention d={d} {dname}"] = attention.plan(d, d, dtype).layout.smem
        for dc, dp in OACA_HEAD_DIMS:
            out[f"oaca ({dc}, {dp}, {dc}) {dname}"] = oaca.plan(dc, dp, dtype).layout.smem
    return out


def check_plans() -> dict:
    """The wrappers' mirrors of the core's plans against the library's own:
    ``attention.plan`` against ``attention_plan`` at every pair of head dims
    from 8 to 512 in steps of 8, ``oaca.plan`` against ``oaca_plan`` at every
    head dims OACA takes, both dtypes; fails on any difference or on a plan
    over the card's shared memory."""
    import ctypes

    import torch

    from lidarcrafter_tpu_torch.kernels import attention, loader, oaca

    lib, out, n = loader.library("attention"), (ctypes.c_int32 * 6)(), 0
    olib, oout = loader.library("oaca"), (ctypes.c_int32 * 4)()
    for dtype, code in ((torch.float32, 0), (torch.bfloat16, 1)):
        for dqk in range(8, 513, 8):
            for dv in range(8, 513, 8):
                check(lib.attention_plan(code, dqk, dv, out) == 0, f"attention_plan {dqk} {dv}")
                p = attention.plan(dqk, dv, dtype)
                mirror = [int(p.split), p.bk, p.nv, p.blocks, p.layout.stages, p.layout.smem]
                check(list(out) == mirror, f"attention plan ({dqk}, {dv}) {dtype}: library {list(out)}, mirror {mirror}")
                check(1 <= p.layout.stages and p.layout.smem <= (loader.SMEM_LIMIT if p.blocks == 1 else loader.SMEM_LIMIT2),
                      f"attention plan ({dqk}, {dv}) {dtype}")
                n += 1
        for dc, dp in OACA_HEAD_DIMS:
            check(olib.oaca_plan(code, dc, dp, dc, oout) == 0, f"oaca_plan {dc} {dp}")
            p = oaca.plan(dc, dp, dtype)
            mirror = [p.bk, p.blocks, p.layout.stages, p.layout.smem]
            check(list(oout) == mirror, f"oaca plan ({dc}, {dp}) {dtype}: library {list(oout)}, mirror {mirror}")
            check(1 <= p.layout.stages and p.layout.smem <= (loader.SMEM_LIMIT if p.blocks == 1 else loader.SMEM_LIMIT2),
                  f"oaca plan ({dc}, {dp}) {dtype}")
            n += 1
    return {"plans_checked": n}


def max_err(got, want) -> tuple[float, float]:
    """(max |got − want|, that over max(1, max |want|))."""
    err = float((got.float() - want.float()).abs().max())
    return err, err / max(1.0, float(want.float().abs().max()))


def kernel_errors(what: str, dname: str, got, want) -> dict:
    """The kernel's output against its plain version on both measures, each
    checked against its limit; the row's error fields."""
    err, rel = max_err(got, want)
    diff = float((got.float() - want.float()).norm())
    norm_rel = diff / float(want.float().norm())
    check(rel <= TOL[dname], f"{what} {dname}: relative error {rel:.3g} > {TOL[dname]}")
    check(norm_rel <= NORM_TOL[dname], f"{what} {dname}: norm-relative error {norm_rel:.3g} > {NORM_TOL[dname]}")
    return {"max_abs_err": err, "rel_err": rel, "tol": TOL[dname],
            "norm_rel_err": norm_rel, "norm_tol": NORM_TOL[dname]}


def reset_counters() -> dict:
    """Every kernel's launch counter, set to 0: the one-launch GroupNorm,
    the azimuth-sharded GroupNorm's two (``groupnorm_partials``,
    ``groupnorm_apply``), OACA (all launches; ``oaca_gathered`` counts again
    those whose image keys are gathered from the ``sp`` ranks, Lk != Lq) and
    attention."""
    from lidarcrafter_tpu_torch.kernels import attention, groupnorm, oaca

    counters = {"oaca": oaca.launches, "oaca_gathered": oaca.gathered_launches, "groupnorm": groupnorm.launches,
                "groupnorm_partials": groupnorm.partials_launches, "groupnorm_apply": groupnorm.apply_launches,
                "attention": attention.launches}
    for c in counters.values():
        c.n = 0
    return counters


def with_zeros(expected: dict, launches: dict) -> dict:
    """``expected`` with 0 for every other counter that ``launches`` reads."""
    return {k: expected.get(k, 0) for k in launches}


# ------------------------------------------------------------------ phase 2


def oaca_operands(B, H, L, L2, dtype, gen, d=32, dp=None):
    """Operands laid out as the attention block produces them: per-head
    views of one fused qkv projection, a positional strip, a small layout
    strip; head dims (d, dp, d), dp = d unless given."""
    import torch

    dp = d if dp is None else dp
    C = H * d
    dev = DEVICE
    qkv = torch.randn(B, L, 3 * C, generator=gen, device=dev).to(dtype)
    heads = lambda t: t.reshape(B, t.shape[1], H, -1).transpose(1, 2)  # noqa: E731
    q_c, k_c, v_c = (heads(t) for t in qkv.chunk(3, dim=-1))
    ipe = heads(torch.randn(B, L, H * dp, generator=gen, device=dev).to(dtype))
    k_l = torch.randn(B, H, L2, d + dp, generator=gen, device=dev).to(dtype)
    v_l = heads(torch.randn(B, L2, 2 * C, generator=gen, device=dev).to(dtype).chunk(2, -1)[1])
    return q_c, ipe, k_c, k_l, v_c, v_l


def check_oaca(label, B, H, L, dtype, gen, d=32, dp=None):
    """One OACA row at head dims (d, dp, d): 32 for the v1-v6 and auto-reg
    stacks, 64 for the v0 stack; a positional width dp of 16 or 64 for
    ``channels_scale_for_positional_embedding`` 0.5 or 2 (dp = d unless
    given)."""
    import torch
    import torch.nn.functional as F

    from lidarcrafter_tpu_torch.kernels import oaca

    L2 = 13
    dp = d if dp is None else dp
    ops = oaca_operands(B, H, L, L2, dtype, gen, d, dp)
    scale = 1.0 / math.sqrt(math.sqrt(d + dp))
    got = oaca.oaca_attention(*ops, scale=scale)
    want = oaca.oaca_attention_plain(*ops, scale=scale)
    torch.cuda.synchronize()
    dname = str(dtype).split(".")[-1]
    errors = kernel_errors(f"oaca {label}", dname, got, want)
    q_c, ipe, k_c, k_l, v_c, v_l = ops
    q_img = torch.cat([q_c, ipe], -1)
    k_mix = torch.cat([torch.cat([k_c, ipe], -1), k_l], 2)
    v_mix = torch.cat([v_c, v_l], 2)
    library = time_ms(lambda: F.scaled_dot_product_attention(q_img, k_mix, v_mix, scale=scale ** 2))
    elt = torch.finfo(dtype).bits // 8
    # q_c, ipe, k_c, v_c and the output; k_l and v_l
    nbytes = elt * (B * H * L * (4 * d + dp) + B * H * L2 * (2 * d + dp))
    flops = 2.0 * B * H * L * (L + L2) * (2 * d + dp)
    route = oaca.route(d, dp, d, dtype)
    bound, by = bound_ms(nbytes, flops, route)
    ms = time_ms(lambda: oaca.oaca_attention(*ops, scale=scale))
    routes = {} if d != 32 else both_routes("oaca", label, dname, ms, errors, route,
                                           lambda on: oaca.launch(*ops, scale=scale, on=on), want, bound)
    return {
        "kernel": "oaca", "shape": label, "dtype": dname, "head_dims": [d, dp, d], "route": route,
        **errors,
        "ms": ms, **(routes or earlier("oaca", label, dname, ms)),
        "plain_ms": time_ms(lambda: oaca.oaca_attention_plain(*ops, scale=scale), iters=5),
        "library_ms": library, "library": "F.scaled_dot_product_attention on the concatenated strips",
        "bound_ms": bound, "bound_by": by, "bytes": nbytes, "flops": flops,
    }


def check_oaca_gathered(label, B, H, Lq, sp, dtype, gen, d=32):
    """One row of OACA with gathered image keys, as a rank of an ``sp``-way
    mesh runs it: its Lq queries (per-head views of its fused projection)
    with their positional rows, over the Lk = sp·Lq keys and values of every
    rank (gathered, contiguous) with the whole positional strip, and the
    13-token layout strip; head dims d³ (32 for the v1-v6 stacks, both
    routes by name; 64 for v0, on the Hopper core alone)."""
    import torch
    import torch.nn.functional as F

    from lidarcrafter_tpu_torch.kernels import oaca

    L2, Lk, C = 13, sp * Lq, H * d
    heads = lambda t: t.reshape(B, t.shape[1], H, -1).transpose(1, 2)  # noqa: E731
    q_c = heads(torch.randn(B, Lq, 3 * C, generator=gen, device=DEVICE).to(dtype)[..., :C])
    kv = torch.randn(B, Lk, 2 * C, generator=gen, device=DEVICE).to(dtype)
    k_c, v_c = (heads(t) for t in kv.chunk(2, dim=-1))
    ipe_k = heads(torch.randn(B, Lk, C, generator=gen, device=DEVICE).to(dtype))
    ipe = heads(torch.randn(B, Lq, C, generator=gen, device=DEVICE).to(dtype))
    k_l = torch.randn(B, H, L2, 2 * d, generator=gen, device=DEVICE).to(dtype)
    v_l = torch.randn(B, H, L2, d, generator=gen, device=DEVICE).to(dtype)
    ops = (q_c, ipe, k_c, k_l, v_c, v_l)
    scale = 1.0 / math.sqrt(math.sqrt(2 * d))
    got = oaca.oaca_attention(*ops, scale=scale, ipe_k=ipe_k)
    want = oaca.oaca_attention_plain(*ops, scale=scale, ipe_k=ipe_k)
    torch.cuda.synchronize()
    dname = str(dtype).split(".")[-1]
    errors = kernel_errors(f"oaca_gathered {label}", dname, got, want)
    q_img = torch.cat([q_c, ipe], -1)
    k_mix = torch.cat([torch.cat([k_c, ipe_k], -1), k_l], 2)
    v_mix = torch.cat([v_c, v_l], 2)
    library = time_ms(lambda: F.scaled_dot_product_attention(q_img, k_mix, v_mix, scale=scale ** 2))
    elt = torch.finfo(dtype).bits // 8
    # the queries' q_c and ipe and the output; the keys' k_c, ipe_k and v_c; k_l and v_l
    nbytes = elt * (B * H * Lq * 3 * d + B * H * Lk * 3 * d + B * H * L2 * 3 * d)
    flops = 2.0 * B * H * Lq * (Lk + L2) * 3 * d
    route = oaca.route(d, d, d, dtype)
    bound, by = bound_ms(nbytes, flops, route)
    ms = time_ms(lambda: oaca.oaca_attention(*ops, scale=scale, ipe_k=ipe_k))
    routes = {} if d != 32 else both_routes("oaca_gathered", label, dname, ms, errors, route,
                                           lambda on: oaca.launch(*ops, scale=scale, ipe_k=ipe_k, on=on), want, bound)
    return {
        "kernel": "oaca_gathered", "shape": label, "dtype": dname, "head_dims": [d, d, d], "route": route,
        "Lq": Lq, "Lk": Lk, **errors, "ms": ms, **routes,
        "plain_ms": time_ms(lambda: oaca.oaca_attention_plain(*ops, scale=scale, ipe_k=ipe_k), iters=5),
        "library_ms": library, "library": "F.scaled_dot_product_attention on the concatenated strips (Lq, Lk + 13)",
        "bound_ms": bound, "bound_by": by, "bytes": nbytes, "flops": flops,
    }


def check_groupnorm_split(label, shape, sp, dtype, scale_shift, silu, gen, groups=8, eps=1e-6, affine=False):
    """Two rows, ``groupnorm_partials`` and ``groupnorm_apply``: the
    azimuth-sharded GroupNorm on rank 0's shard of ``shape`` split into
    ``sp`` along W, its partials exchanged as the mesh does (every shard's
    partials from the kernel, stacked); each launch against its plain
    version on the same inputs."""
    import torch
    import torch.nn.functional as F

    from lidarcrafter_tpu_torch.kernels import groupnorm

    B, C = shape[0], shape[-1]
    whole = (torch.randn(shape, generator=gen, device=DEVICE) * 2 + 1).to(dtype)
    shards = [t.contiguous() for t in whole.chunk(sp, dim=2)]
    x = shards[0]
    w = b = s = t = None
    if affine:
        w = (1 + 0.1 * torch.randn(C, generator=gen, device=DEVICE)).to(dtype)
        b = (0.1 * torch.randn(C, generator=gen, device=DEVICE)).to(dtype)
    if scale_shift:
        s, t = (0.3 * torch.randn(B, 2 * C, generator=gen, device=DEVICE)).to(dtype).chunk(2, dim=-1)
    parts = torch.stack([groupnorm.launch_partials(z, groups) for z in shards])
    plain_parts = torch.stack([groupnorm.group_norm_partials_plain(z, groups) for z in shards])
    check(torch.equal(parts[:, :, 0], plain_parts[:, :, 0]), f"groupnorm_partials {label}: counts differ")

    def mean_var(p):  # a shard's (B, 3, G) partials as its groups' means and variances
        return torch.stack([p[:, 1], p[:, 2] / p[:, 0]])

    args = dict(num_groups=groups, eps=eps, silu=silu)
    got = groupnorm.launch_apply(x, parts, w, b, s, t, **args)
    want = groupnorm.group_norm_apply_plain(x, plain_parts, w, b, scale=s, shift=t, **args)
    torch.cuda.synchronize()
    dname = str(dtype).split(".")[-1]
    elt = torch.finfo(dtype).bits // 8
    rows = []
    x_nchw = x.reshape(B, -1, 1, C).permute(0, 3, 1, 2)
    x_groups = x.view(B, -1, groups, C // groups)
    for kernel, route, err, n_bytes, ops_per, ms, plain_ms, library in (
        ("groupnorm_partials", GN_PARTIALS_ROUTE, kernel_errors(f"groupnorm_partials {label}", dname,
                                                                 mean_var(parts[0]), mean_var(plain_parts[0])),
         elt * x.numel() + 4 * 3 * B * groups, 4.0,
         time_ms(lambda: groupnorm.launch_partials(x, groups)),
         time_ms(lambda: groupnorm.group_norm_partials_plain(x, groups)),
         time_ms(lambda: torch.var_mean(x_groups, dim=(1, 3), correction=0))),
        ("groupnorm_apply", GN_APPLY_ROUTE, kernel_errors(f"groupnorm_apply {label}", dname, got, want),
         elt * (2 * x.numel() + 2 * C * affine + 2 * B * C * scale_shift) + 4 * parts.numel(), 10.0,
         time_ms(lambda: groupnorm.launch_apply(x, parts, w, b, s, t, **args)),
         time_ms(lambda: groupnorm.group_norm_apply_plain(x, parts, w, b, scale=s, shift=t, **args)),
         time_ms(lambda: F.group_norm(x_nchw, groups, w, b, eps))),
    ):
        bound, by = bound_ms(n_bytes, ops_per * x.numel(), route)
        rows.append({
            "kernel": kernel, "shape": label, "dtype": dname, "route": route, "sp": sp, "groups": groups,
            "scale_shift": scale_shift, "silu": silu, "affine": affine, **err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library,
            "library": ("torch.var_mean over the shard's groups (no count, no M2)" if kernel == "groupnorm_partials"
                        else "F.group_norm on the shard (its own statistics; affine only)"),
            "bound_ms": bound, "bound_by": by, "bytes": n_bytes,
        })
    return rows


def library_jvp(fn, primals, tangents) -> tuple[float | None, str]:
    """Device ms of ``torch.func.jvp`` of one PyTorch call, or None and the
    error where the call has no forward-mode rule on the card."""
    import torch

    try:
        torch.func.jvp(fn, primals, tangents)
    except (RuntimeError, NotImplementedError) as e:
        return None, f"raises: {type(e).__name__}: {str(e).splitlines()[0][:200]}"
    return time_ms(lambda: torch.func.jvp(fn, primals, tangents), iters=5, warmup=1), "ok"


def check_groupnorm_split_jvp(label, shape, sp, dtype, gen, groups=8, eps=1e-6):
    """Phase 2, the MeanFlow loss's tangent through an azimuth-sharded norm:
    rank 0's shard of ``shape`` (AdaGN's scale-shift + SiLU, the level-0
    norms of the MeanFlow stack) under ``torch.func.jvp``: the rank's
    ``gn_partials`` and ``gn_apply`` launches through their Functions, the
    tangent from their forward-mode rules, the other shards' partials (the
    kernel's) and their tangents as the exchange hands them; against
    ``torch.func.jvp`` through the plain split, timed beside it and beside
    ``torch.func.jvp`` of ``F.group_norm`` on the shard (NCHW, its own
    statistics)."""
    import torch
    import torch.nn.functional as F

    from lidarcrafter_tpu_torch.kernels import groupnorm

    def r(*size, scale=1.0):
        return (scale * torch.randn(*size, generator=gen, device=DEVICE)).to(dtype)

    B, C = shape[0], shape[-1]
    whole, dwhole = r(*shape, scale=2.0) + 1, r(*shape)
    shards, dshards = ([z.contiguous() for z in t.chunk(sp, dim=2)] for t in (whole, dwhole))
    others = torch.stack([groupnorm.launch_partials(z, groups) for z in shards[1:]])
    dothers = torch.stack([groupnorm.group_norm_partials_jvp(z, d, groups) for z, d in zip(shards[1:], dshards[1:])])
    primals, tangents = (shards[0], r(B, 2 * C, scale=0.3), others), (dshards[0], r(B, 2 * C), dothers)

    def rank(partials, apply):
        def norm(x, proj, others):
            s, t = proj.chunk(2, dim=-1)
            parts = torch.cat([partials(x, groups)[None], others])
            return apply(x, parts, None, None, num_groups=groups, eps=eps, scale=s, shift=t, silu=True)
        return norm

    call = rank(groupnorm.group_norm_partials, groupnorm.group_norm_apply)
    plain = rank(groupnorm.group_norm_partials_plain, groupnorm.group_norm_apply_plain)
    counters = (groupnorm.partials_launches, groupnorm.apply_launches)
    before = [c.n for c in counters]
    out, tan = torch.func.jvp(call, primals, tangents)
    torch.cuda.synchronize()
    launched = [c.n - n for c, n in zip(counters, before)]
    dname = str(dtype).split(".")[-1]
    check(launched == [1, 1], f"groupnorm split jvp {label} {dname}: {launched} partials / apply launches, not 1 / 1")
    want_out, want_tan = torch.func.jvp(plain, primals, tangents)
    kernel_errors(f"groupnorm split jvp {label} primal", dname, out, want_out)
    errors = kernel_errors(f"groupnorm split jvp {label} tangent", dname, tan, want_tan)
    del out, tan, want_out, want_tan
    x, dx = primals[0], tangents[0]
    x_nchw, dx_nchw = (t.reshape(B, -1, 1, C).permute(0, 3, 1, 2).contiguous() for t in (x, dx))
    library, said = library_jvp(lambda z: F.group_norm(z, groups, None, None, eps), (x_nchw,), (dx_nchw,))
    n = x.numel()
    nbytes = torch.finfo(dtype).bits // 8 * (4 * n + 4 * B * C) + 4 * 2 * others.numel()
    bound, by = bound_ms(nbytes, 30.0 * n, work_route("groupnorm", dname))
    return {
        "kernel": "groupnorm_apply", "sub": "split jvp", "pass": "jvp", "shape": label, "dtype": dname,
        "route": JVP_ROUTE, "sp": sp, "groups": groups, "launches_per_call": {"groupnorm_partials": 1,
                                                                               "groupnorm_apply": 1},
        **errors,
        "ms": time_ms(lambda: torch.func.jvp(call, primals, tangents), iters=5, warmup=1),
        "plain_ms": time_ms(lambda: torch.func.jvp(plain, primals, tangents), iters=5, warmup=1),
        "library_ms": library, "library": f"torch.func.jvp of F.group_norm on the shard (NCHW, its own statistics, "
                                          f"no scale-shift): {said}",
        "bound_ms": bound, "bound_by": by, "bytes": nbytes, "flops": 30.0 * n,
    }


def check_attention_jvp_gathered(label, B, H, L, d, sp, dtype, gen):
    """Phase 2, the MeanFlow loss's tangent through its attention block on
    the azimuth axis: a rank's L / sp queries (its normed q, pre-scaled)
    over the L keys and values gathered from every rank (views of one
    (B, L, 2, heads, d) tensor), under ``torch.func.jvp`` (one kernel
    launch, the tangent from ``attention_jvp``) against ``torch.func.jvp``
    through the plain version, timed beside it and beside ``torch.func.jvp``
    of ``F.scaled_dot_product_attention``."""
    import torch
    import torch.nn.functional as F

    from lidarcrafter_tpu_torch.kernels import attention

    def r(*size):
        return torch.randn(*size, generator=gen, device=DEVICE).to(dtype)

    Lq = L // sp
    primals, tangents = (r(B, Lq, H, d) * d**-0.5, r(B, L, 2, H, d)), (r(B, Lq, H, d), r(B, L, 2, H, d))

    def heads(q, kv):
        k, v = kv.unbind(dim=2)
        return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)

    def call(q, kv):
        return attention.attention(*heads(q, kv), scale=1.0)

    def plain(q, kv):
        return attention.attention_plain(*heads(q, kv), scale=1.0)

    n = attention.launches.n
    out, tan = torch.func.jvp(call, primals, tangents)
    torch.cuda.synchronize()
    dname = str(dtype).split(".")[-1]
    check(attention.launches.n == n + 1, f"attention jvp {label} {dname}: {attention.launches.n - n} launches, not 1")
    want_out, want_tan = torch.func.jvp(plain, primals, tangents)
    kernel_errors(f"attention jvp {label} primal", dname, out, want_out)
    errors = kernel_errors(f"attention jvp {label} tangent", dname, tan, want_tan)
    del out, tan, want_out, want_tan
    sdpa_primals, sdpa_tangents = heads(*primals), heads(*tangents)
    library, said = library_jvp(lambda q, k, v: F.scaled_dot_product_attention(q, k, v, scale=1.0), sdpa_primals,
                                sdpa_tangents)
    elt = torch.finfo(dtype).bits // 8
    nbytes = elt * B * H * d * 2 * (2 * Lq + 2 * L)  # q, k, v and their tangents read; out and its tangent written
    flops = 12.0 * B * H * Lq * L * d  # the forward's 4, the tangent's 8
    bound, by = bound_ms(nbytes, flops, work_route("attention", dname))
    return {
        "kernel": "attention", "sub": "jvp over gathered keys", "pass": "jvp", "shape": label, "dtype": dname,
        "route": JVP_ROUTE, "head_dim": d, "lq": Lq, "lkv": L, "sp": sp, "launches_per_call": {"attention": 1},
        **errors,
        "ms": time_ms(lambda: torch.func.jvp(call, primals, tangents), iters=5, warmup=1),
        "plain_ms": time_ms(lambda: torch.func.jvp(plain, primals, tangents), iters=5, warmup=1),
        "library_ms": library, "library": f"torch.func.jvp of F.scaled_dot_product_attention: {said}",
        "bound_ms": bound, "bound_by": by, "bytes": nbytes, "flops": flops,
    }


def check_groupnorm(label, shape, dtype, scale_shift, silu, gen, groups=32, eps=1e-5, affine=True):
    """The operands as the modules pass them: the norm's (C,) weight and bias
    (none for AdaGN) and the ``chunk`` halves of a (B, 2C) projection as
    scale and shift, all in the serving dtype."""
    import torch
    import torch.nn.functional as F

    from lidarcrafter_tpu_torch.kernels import groupnorm

    B, C = shape[0], shape[-1]
    x = (torch.randn(shape, generator=gen, device=DEVICE) * 2 + 1).to(dtype)
    w = b = s = t = None
    if affine:
        w = (1 + 0.1 * torch.randn(C, generator=gen, device=DEVICE)).to(dtype)
        b = (0.1 * torch.randn(C, generator=gen, device=DEVICE)).to(dtype)
    if scale_shift:
        s, t = (0.3 * torch.randn(B, 2 * C, generator=gen, device=DEVICE)).to(dtype).chunk(2, dim=-1)
    args = dict(num_groups=groups, eps=eps, scale=s, shift=t, silu=silu)
    got = groupnorm.group_norm(x, w, b, **args)
    want = groupnorm.group_norm_plain(x, w, b, **args)
    torch.cuda.synchronize()
    dname = str(dtype).split(".")[-1]
    errors = kernel_errors(f"groupnorm {label}", dname, got, want)
    x_nchw = x.reshape(B, -1, 1, C).permute(0, 3, 1, 2)
    library = time_ms(lambda: F.group_norm(x_nchw, groups, w, b, eps))
    elt = torch.finfo(dtype).bits // 8
    # x read and y written once; weight and bias (C,), scale and shift (B, C)
    nbytes = elt * (2 * x.numel() + 2 * C * affine + 2 * B * C * scale_shift)
    bound, by = bound_ms(nbytes, 10.0 * x.numel(), GN_ROUTE)
    HW = x.numel() // (B * C)
    plan = groupnorm.plan(B, HW, C, groups, elt, torch.cuda.get_device_properties(0).multi_processor_count)
    return {
        "kernel": "groupnorm", "shape": label, "dtype": dname, "route": GN_ROUTE,
        "groups": groups, "scale_shift": scale_shift, "silu": silu, "affine": affine, **errors,
        "ms": time_ms(lambda: groupnorm.group_norm(x, w, b, **args)),
        "plain_ms": time_ms(lambda: groupnorm.group_norm_plain(x, w, b, **args)),
        "library_ms": library, "library": "F.group_norm (affine only, no scale-shift or SiLU)",
        "bound_ms": bound, "bound_by": by, "bytes": nbytes,
        "blocks_per_image": plan.k, "grid_sync": plan.k > 1,
        "staged_rows_share": plan.stage_rows / plan.rows_per_block,
    }


def check_attention(label, B, H, Lq, Lkv, d, dtype, gen, kv_len=None):
    """q, k, v as strided per-head views of one (B, L, 3C) projection, as
    ``SelfAttention2d`` produces them (Lq == Lkv), else separate strips."""
    import torch

    C = H * d
    heads = lambda t: t.reshape(B, t.shape[1], H, d).transpose(1, 2)  # noqa: E731
    if Lq == Lkv:
        qkv = torch.randn(B, Lq, 3 * C, generator=gen, device=DEVICE).to(dtype)
        q, k, v = (heads(t) for t in qkv.split(C, dim=-1))
    else:
        q = heads(torch.randn(B, Lq, C, generator=gen, device=DEVICE).to(dtype))
        k, v = (heads(torch.randn(B, Lkv, C, generator=gen, device=DEVICE).to(dtype)) for _ in range(2))
    return attention_row(label, q, k, v, dtype, kv_len)


def check_attention_glide(label, B, H, L, d, dtype, gen, L_enc=13, sp=1):
    """The operands as ``GLIDEAttentionBlock`` hands them: q, k and v
    per-head views of one (B, L, heads·3d) projection packed per head as
    [q|k|v], and the encoder's ``L_enc`` tokens' K/V (one (B, L_enc, 2C)
    projection) concatenated in front of the image's (none with ``L_enc``
    0: ``OpenAIUNet``'s blocks).  With ``sp`` > 1 as a rank of the mesh
    hands them: q its L / sp tokens' views, k and v views of every rank's
    [k|v], gathered (B, L, heads, 2d)."""
    import torch

    C = H * d
    Lq = L // sp
    qkv = torch.randn(B, Lq, 3 * C, generator=gen, device=DEVICE).to(dtype).view(B, Lq, H, 3 * d)
    q, k, v = (t.transpose(1, 2) for t in qkv.split(d, dim=-1))
    if sp > 1:
        kv = torch.randn(B, L, 2 * C, generator=gen, device=DEVICE).to(dtype).view(B, L, H, 2 * d)
        k, v = (t.transpose(1, 2) for t in kv.split(d, dim=-1))
    if L_enc:
        ekv = torch.randn(B, L_enc, 2 * C, generator=gen, device=DEVICE).to(dtype).view(B, L_enc, H, 2 * d)
        ek, ev = (t.transpose(1, 2) for t in ekv.split(d, dim=-1))
        k, v = torch.cat([ek, k], dim=2), torch.cat([ev, v], dim=2)
    return attention_row(label, q, k, v, dtype)


def both_routes(kernel: str, label: str, dname: str, ms: float, errors: dict, route: str, launch, plain,
                bound: float) -> dict:
    """Where the cp.async + mma.sync loader still takes a shape (attention
    head dims <= 128, OACA's 32-wide builds): the route the wrapper did not
    take, forced by name (``launch(on)``), held against the plain version
    and timed in this process on the same operands, beside the taken
    route's ``ms`` and errors; the replaced route is the mma.sync one
    (``earlier_ms``).  Fails a route below its bound."""
    import torch

    from lidarcrafter_tpu_torch.kernels import loader

    taken = "core" if route in loader.CORE_ROUTES.values() else "mma"
    other = "mma" if taken == "core" else "core"
    err = kernel_errors(f"{kernel} {label} ({other} route)", dname, launch(other), plain)
    t = time_ms(lambda: launch(other))
    check(t >= bound, f"{kernel} {label} {dname} ({other} route): {t} ms below its bound {bound} ms")
    out = {f"{taken}_ms": ms, f"{taken}_rel_err": errors["rel_err"], f"{taken}_norm_rel_err": errors["norm_rel_err"],
           f"{other}_ms": t, f"{other}_rel_err": err["rel_err"], f"{other}_norm_rel_err": err["norm_rel_err"]}
    return out | {"earlier_ms": out["mma_ms"], "earlier_route": loader.MMA_ROUTES[getattr(torch, dname)],
                  "ms_over_earlier": ms / out["mma_ms"]}


def attention_row(label, q, k, v, dtype, kv_len=None):
    """One attention row: the kernel against its plain version, their device
    times beside SDPA's on the same operands and the bound; at head dims up
    to 128 both routes by name (``both_routes``)."""
    import torch
    import torch.nn.functional as F

    from lidarcrafter_tpu_torch.kernels import attention

    B, H, Lq, d = q.shape
    Lkv, dv = k.shape[2], v.shape[-1]
    scale = 1.0 / math.sqrt(d)
    args = dict(scale=scale, kv_len=kv_len)
    got = attention.attention(q, k, v, **args)
    want = attention.attention_plain(q, k, v, **args)
    torch.cuda.synchronize()
    dname = str(dtype).split(".")[-1]
    errors = kernel_errors(f"attention {label}", dname, got, want)
    n = Lkv if kv_len is None else kv_len
    mask = None if kv_len is None else (torch.arange(Lkv, device=DEVICE) < kv_len).expand(Lq, Lkv)
    library = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=scale))
    elt = torch.finfo(dtype).bits // 8
    nbytes = elt * B * H * (2 * Lq * d + 2 * n * d)
    flops = 4.0 * B * H * Lq * n * d
    route = attention.route(d, dv, dtype)
    bound, by = bound_ms(nbytes, flops, route)
    ms = time_ms(lambda: attention.attention(q, k, v, **args))
    routes = {} if max(d, dv) > 128 else both_routes(
        "attention", label, dname, ms, errors, route,
        lambda on: attention.launch(q, k, v, scale=scale, kv_len=n, on=on), want, bound)
    return {
        "kernel": "attention", "shape": label, "dtype": dname, "route": route, "head_dim": d,
        "lq": Lq, "lkv": Lkv, **errors,
        "ms": ms, **(routes or earlier("attention", label, dname, ms)),
        "plain_ms": time_ms(lambda: attention.attention_plain(q, k, v, **args), iters=5),
        "library_ms": library, "library": "F.scaled_dot_product_attention",
        "bound_ms": bound, "bound_by": by, "bytes": nbytes, "flops": flops,
    }


def phase_kernels():
    import torch

    gen = torch.Generator(device=DEVICE).manual_seed(0)
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        rows.append(check_oaca("ds4 B=8 h=8 L=2048", BATCH, 8, 2048, dtype, gen))
        rows.append(check_oaca("ds8 B=8 h=16 L=512", BATCH, 16, 512, dtype, gen))
        rows.append(check_oaca("ragged B=8 h=8 L=1000", BATCH, 8, 1000, dtype, gen))
        rows.append(check_groupnorm("level0 (8,32,1024,64) out_norm", (BATCH, 32, 1024, 64),
                                    dtype, True, True, gen))
        # the largest slab of the main paths: the layout decoder's first
        # level-0 block (out_0_0_res), whose in_norm sees the 192-channel concat
        rows.append(check_groupnorm("level0 (8,32,1024,192) in_norm out_0_0_res", (BATCH, 32, 1024, 192),
                                    dtype, False, True, gen))
        rows.append(check_groupnorm("ds8 (8,4,128,1024) in_norm", (BATCH, 4, 128, 1024),
                                    dtype, False, True, gen))
        rows.append(check_groupnorm("tokens (8,13,64)", (BATCH, 13, 64), dtype, False, False, gen))
        # the unconditional path: d_block4 at C=512 (dh 64), u_block4 at C=256 (dh 32)
        rows.append(check_attention("d_block4 B=8 h=8 L=512 d=64", BATCH, 8, 512, 512, 64, dtype, gen))
        rows.append(check_attention("u_block4 B=8 h=8 L=512 d=32", BATCH, 8, 512, 512, 32, dtype, gen))
        rows.append(check_attention("masked tail B=8 h=8 L=128 kv_len=77", BATCH, 8, 128, 128, 64,
                                    dtype, gen, kv_len=77))
        rows.append(check_attention("ragged B=8 h=8 L=300", BATCH, 8, 300, 300, 64, dtype, gen))
        rows.append(check_attention("masked head B=8 h=8 L=128 kv_len=9", BATCH, 8, 128, 128, 64,
                                    dtype, gen, kv_len=9))
        rows.append(check_groupnorm("unet level0 (8,32,1024,64) AdaGN scale-shift+SiLU", (BATCH, 32, 1024, 64),
                                    dtype, True, True, gen, groups=8, eps=1e-6, affine=False))
        rows.append(check_groupnorm("unet ds8 (8,4,128,512) SiLU", (BATCH, 4, 128, 512),
                                    dtype, False, True, gen, groups=8, eps=1e-6))
        # the v0 stack (nuscenes-box-layout): OACA at head dims 64 at ds4 and
        # in the middle, GroupNorm on its 256-channel level-0 slabs and the
        # 512-channel skip concats of its decoder
        rows.append(check_oaca("v0 ds4 B=8 h=8 L=2048 d=64", BATCH, 8, 2048, dtype, gen, d=64))
        rows.append(check_oaca("v0 ragged B=8 h=8 L=1000 d=64", BATCH, 8, 1000, dtype, gen, d=64))
        rows.append(check_groupnorm("v0 level0 (8,32,1024,256) out_norm scale-shift+SiLU", (BATCH, 32, 1024, 256),
                                    dtype, True, True, gen))
        rows.append(check_groupnorm("v0 level0 (8,32,1024,512) in_norm skip concat", (BATCH, 32, 1024, 512),
                                    dtype, False, True, gen))
        # kitti-360 (64x1024 through EfficientUNet): the level-0 AdaGN and
        # the attention of d_block4 / u_block4 at 1,024 tokens
        rows.append(check_groupnorm("kitti-360 level0 (8,64,1024,64) AdaGN scale-shift+SiLU",
                                    (BATCH, 64, 1024, 64), dtype, True, True, gen, groups=8, eps=1e-6,
                                    affine=False))
        rows.append(check_attention("kitti-360 d_block4 B=8 h=8 L=1024 d=64", BATCH, 8, 1024, 1024, 64, dtype, gen))
        rows.append(check_attention("kitti-360 u_block4 B=8 h=8 L=1024 d=32", BATCH, 8, 1024, 1024, 32, dtype, gen))
        # the sp = 2 path (phase 18): rank 0's half of the level-0 AdaGN of
        # the uncond stack, and OACA at ds4 over the keys of both halves
        rows.extend(check_groupnorm_split(f"unet level0 shard 1/{SP} (8,32,{1024 // SP},64) AdaGN scale-shift+SiLU",
                                          (BATCH, 32, 1024, 64), SP, dtype, True, True, gen))
        rows.append(check_oaca_gathered(f"ds4 shard 1/{SP} B=8 h=8 Lq={2048 // SP} Lk=2048", BATCH, 8, 2048 // SP,
                                        SP, dtype, gen))
        # the sp = 2 shards of phase 18's other stacks: v0's OACA at 64³
        # (and a ragged Lk of no whole key tile), GLIDE v6 at ds4 and
        # OpenAIUNet's one head of 256 at ds4, over every rank's keys
        rows.append(check_oaca_gathered(f"v0 ds4 shard 1/{SP} B=8 h=8 Lq={2048 // SP} Lk=2048 d=64", BATCH, 8,
                                        2048 // SP, SP, dtype, gen, d=64) | {"sub": "head_dims_64"})
        rows.append(check_oaca_gathered(f"v0 ragged shard 1/{SP} B=8 h=8 Lq=1000 Lk={1000 * SP} d=64", BATCH, 8,
                                        1000, SP, dtype, gen, d=64) | {"sub": "head_dims_64"})
        rows.append(check_attention_glide(f"glide ds4 shard 1/{SP} B=8 h=8 Lq={2048 // SP} Lkv=13+2048 d=32", BATCH,
                                          8, 2048, 32, dtype, gen, sp=SP) | {"sub": "glide"})
        rows.append(check_attention_glide(f"openai_unet ds4 shard 1/{SP} B=8 h=1 Lq={2048 // SP} Lkv=2048 d=256",
                                          BATCH, 1, 2048, 256, dtype, gen, L_enc=0, sp=SP) | {"sub": "wide_heads"})
        # the MeanFlow stack's tangent on the sp = 2 path: the split norm of
        # its level-0 AdaGN and d_block4's attention over the gathered keys
        rows.append(check_groupnorm_split_jvp(f"unet level0 shard 1/{SP} (8,32,{1024 // SP},64) AdaGN jvp", (BATCH, 32,
                                              1024, 64), SP, dtype, gen))
        rows.append(check_attention_jvp_gathered(f"mf d_block4 shard 1/{SP} B=8 h=8 Lq={512 // SP} Lkv=512 d=64 jvp",
                                                 BATCH, 8, 512, 64, SP, dtype, gen))
        # the GLIDE block's shapes (the v6 stack's ds 4 and ds 8, 13 encoder
        # tokens in front) and OACA at positional head dims 16 and 64 on the
        # ds 4 v6 shape (channels_scale_for_positional_embedding 0.5 and 2)
        rows.append(check_attention_glide("glide ds4 B=8 h=8 L=2048+13 d=32", BATCH, 8, 2048, 32, dtype, gen)
                    | {"sub": "glide"})
        rows.append(check_attention_glide("glide ds8 B=8 h=16 L=512+13 d=32", BATCH, 16, 512, 32, dtype, gen)
                    | {"sub": "glide"})
        for dp in OACA_POSITIONAL_DIMS:
            rows.append(check_oaca(f"ds4 B=8 h=8 L=2048 dp={dp}", BATCH, 8, 2048, dtype, gen, dp=dp)
                        | {"sub": "positional_dims"})
    # the layout branch's UNet1D norms: N = 104 one-row images; float32 as the
    # branch serves, bfloat16 as it trains under AMP
    N = LAYOUT_SCENES * (LAYOUT_OBJECTS + 1)
    for dtype in (torch.float32, torch.bfloat16):
        for label, C, eps, silu in ((f"tokens ({N},1,512) UNet1D res-block norm + SiLU", 512, 1e-5, True),
                                    (f"tokens ({N},1,1024) UNet1D skip-concat norm + SiLU", 1024, 1e-5, True),
                                    (f"tokens ({N},1,512) UNet1D transformer norm eps 1e-6", 512, 1e-6, False)):
            rows.append(check_groupnorm(label, (N, 1, C), dtype, False, silu, gen, eps=eps))
    for row in rows:
        emit({"phase": "kernels", **row})
        check(row["ms"] >= row["bound_ms"],
              f"{row['kernel']} {row['shape']} {row['dtype']}: {row['ms']} ms below its bound {row['bound_ms']} ms")
    return rows


# ------------------------------------------------------------------ phase 3


def check_forward(what: str, got, want, tol: float, **extra) -> None:
    """``got`` (card) against ``want`` (CPU; float32 unless ``what`` says
    otherwise) to ``tol`` of max |want|; emits the forward_parity line."""
    import torch

    err, _ = max_err(got, want)
    scale = float(want.abs().max())
    rel = err / scale
    check(got.dtype == torch.float32, f"{what}: output dtype {got.dtype}")
    check(bool(torch.isfinite(got).all()), f"{what}: not finite on the card")
    check(scale > 1e-2, f"{what}: output is (near) zero")
    check(rel <= tol, f"{what}: relative error {rel:.3g} > {tol}")
    emit({"phase": "forward_parity", "what": what, "shape": list(got.shape),
          "max_abs_err": err, "rel_err": rel, "tol": tol, **extra})


def phase_forward_parity(cfg_name: str, cfg=None, label: str | None = None):
    import torch

    from lidarcrafter_tpu_torch.configs import get_config
    from lidarcrafter_tpu_torch.precision import to_serving_dtype_
    from lidarcrafter_tpu_torch.training.factory import build_diffusion_training
    from lidarcrafter_tpu_torch.weights import init_random_

    cfg = cfg or get_config(cfg_name)
    cfg_name = label or cfg_name
    models, engine, _ = build_diffusion_training(cfg, "cpu")
    init_random_(models["cond"], 10)
    init_random_(models["model"], 11)
    B, (H, W) = 2, cfg.data.resolution
    gen = torch.Generator().manual_seed(12)
    batch = condition_batch(cfg, B, gen)
    x = torch.randn(B, H, W, 2, generator=gen)
    t = torch.tensor([-3.0, 5.0])

    def forward(cond_model, model, device):
        with torch.inference_mode():
            b = {k: v.to(device) for k, v in batch.items()}
            layout = cond_model(b)
            return model(x.to(device), {"time_condition": t.to(device), "other_condition": layout})

    t0 = time.perf_counter()
    want = forward(models["cond"], models["model"], "cpu")
    cpu_s = time.perf_counter() - t0
    gpu = {k: copy.deepcopy(m).to(DEVICE) for k, m in models.items()}
    got = forward(gpu["cond"], gpu["model"], DEVICE).cpu()
    check_forward(f"{cfg_name} float32", got, want, FORWARD_RTOL, cpu_seconds=cpu_s)
    # served in bfloat16 through the engine's own cast, against the same CPU forward
    to_serving_dtype_(gpu["model"], torch.bfloat16, cond_model=gpu["cond"])
    served = dataclasses.replace(engine, model=gpu["model"], cond_model=gpu["cond"], dtype=torch.bfloat16)
    with torch.inference_mode():
        cond = served.get_network_condition({k: v.to(DEVICE) for k, v in batch.items()})
        got = served.denoise(x.to(DEVICE), t.to(DEVICE), cond).cpu()
    check_forward(f"{cfg_name} bfloat16", got, want, BF16_FORWARD_RTOL)


def condition_batch(cfg, batch_size: int, generator, device="cpu") -> dict:
    """``layout_condition_batch`` drawn from ``generator``, with the v5
    encoder's ``fg_encoding_box`` (B, L, 8) in [-1, 1] and a (9, 512)
    ``fg_text_features`` table of 0.05·normal."""
    import torch

    from lidarcrafter_tpu_torch.training.factory import layout_condition_batch

    batch = layout_condition_batch(cfg, batch_size, generator=generator, device=device)
    if cfg.condition_model.architecture == "layout_encoder_v5":
        L = cfg.condition_model.params["layout_length"]
        batch["fg_encoding_box"] = torch.rand((batch_size, L, 8), generator=generator, device=device) * 2 - 1
        batch["fg_text_features"] = 0.05 * torch.randn((9, 512), generator=generator, device=device)
    return batch


def phase_unet_forward_parity(cfg_name: str, cfg=None, label: str | None = None):
    import torch

    from lidarcrafter_tpu_torch.configs import get_config
    from lidarcrafter_tpu_torch.precision import to_serving_dtype_
    from lidarcrafter_tpu_torch.training.factory import build_diffusion_training
    from lidarcrafter_tpu_torch.weights import init_random_

    cfg = cfg or get_config(cfg_name)
    cfg_name = label or cfg_name
    model, engine, _ = build_diffusion_training(cfg, "cpu")
    init_random_(model, 13)
    B, (H, W) = 2, cfg.data.resolution
    gen = torch.Generator().manual_seed(14)
    x = torch.randn(B, H, W, 2, generator=gen)
    t = torch.tensor([-3.0, 5.0])  # log-SNR, as the sampler passes it
    t0 = time.perf_counter()
    with torch.inference_mode():
        want = model(x, t)
        cpu_s = time.perf_counter() - t0
        gpu = copy.deepcopy(model).to(DEVICE)
        got = gpu(x.to(DEVICE), t.to(DEVICE)).cpu()
        check_forward(f"{cfg_name} float32", got, want, FORWARD_RTOL, cpu_seconds=cpu_s)
        # served in bfloat16 through the engine's own cast, against the same CPU forward
        to_serving_dtype_(gpu, torch.bfloat16)
        served = dataclasses.replace(engine, model=gpu, dtype=torch.bfloat16)
        got = served.denoise(x.to(DEVICE), t.to(DEVICE)).cpu()
        if cfg.model.architecture == "hdit":
            # HDiT's serving cast rounds rff_freqs and with them the Fourier
            # angles to bfloat16, as the JAX package's does, which moves the
            # output far from the float32 one (ROADMAP Queue 3 item 11): the
            # card is held to the same bfloat16 call on the CPU, and the gap
            # reported
            cpu = copy.deepcopy(model)
            to_serving_dtype_(cpu, torch.bfloat16)
            ref = dataclasses.replace(engine, model=cpu, dtype=torch.bfloat16).denoise(x, t)
            check_forward(f"{cfg_name} bfloat16 vs CPU bfloat16", got, ref, BF16_FORWARD_RTOL,
                          bf16_vs_float32_rel_err=float((got - want).abs().max() / want.abs().max()))
            return
    check_forward(f"{cfg_name} bfloat16", got, want, BF16_FORWARD_RTOL)


# ------------------------------------------------------------------ phase 4


def check_sample(sample, post, mode, shape):
    import torch

    B, H, W = shape
    check(tuple(sample.shape) == (B, H, W, 2), f"{mode} sample shape {tuple(sample.shape)}")
    check(bool(torch.isfinite(sample).all()), f"{mode} sample is not finite")
    check(tuple(post["xyz"].shape) == (B, H, W, 3), f"{mode} xyz shape")
    check(bool(torch.isfinite(post["xyz"]).all()), f"{mode} xyz is not finite")
    check(float(sample.std()) > 1e-3, f"{mode} sample is constant")
    if mode == "meanflow":
        check(float(sample.abs().max()) <= 1.0, "meanflow sample is not clamped to [-1, 1]")


def build_generators(dtype):
    """The three main paths' generators on the card, seeded random weights,
    served in ``dtype``, with their kernel-bearing modules counted."""
    from lidarcrafter_tpu_torch.configs import get_config
    from lidarcrafter_tpu_torch.generate import UncondFrameGenerator
    from lidarcrafter_tpu_torch.generate_cond import CondFrameGenerator
    from lidarcrafter_tpu_torch.generate_flow import FlowFrameGenerator
    from lidarcrafter_tpu_torch.models.ops import FusedGN, GroupNorm32, MFSelfAttention2d, SelfAttention2d

    def count(model, cls):
        return sum(isinstance(m, cls) for m in model.modules())

    gens = {
        "nuscenes-box-layout-v6": CondFrameGenerator(get_config("nuscenes-box-layout-v6"), DEVICE, 0, dtype),
        "nuscenes-unet-uncond": UncondFrameGenerator(get_config("nuscenes-unet-uncond"), DEVICE, 0, dtype),
        "meanflow-nusc": FlowFrameGenerator(get_config("meanflow-nusc"), DEVICE, 0, dtype),
    }
    n = count(gens["nuscenes-box-layout-v6"].models["model"], GroupNorm32)
    check(n == GN_PER_FORWARD, f"{n} GroupNorm32 modules, expected {GN_PER_FORWARD}")
    for name, attn_cls in (("nuscenes-unet-uncond", SelfAttention2d), ("meanflow-nusc", MFSelfAttention2d)):
        got = (count(gens[name].model, attn_cls), count(gens[name].model, FusedGN))
        check(got == (ATTN_PER_UNET, GN_PER_UNET),
              f"{name}: {got} attention / FusedGN modules, expected {(ATTN_PER_UNET, GN_PER_UNET)}")
    return gens


def phase_main_path(cfg_name: str, gen, per_call: dict, requests, smi: str) -> dict:
    """Answer ``requests`` ((mode, steps) pairs of 8 frames; mode
    ``meanflow`` is one step) after one warm-up, with every launch counter
    set to 0 just before and read just after; each kernel must have launched
    exactly ``per_call[kernel]`` times per denoiser call (0 if absent), in
    either serving dtype.  Returns the path's non-zero launch counts."""
    import torch

    def request(mode, steps, seed):
        if mode == "meanflow":
            return gen.generate(BATCH, seed=seed)
        return gen.generate(BATCH, steps, mode=mode, seed=seed)

    request(requests[0][0], 2, 99)  # warm-up: cuDNN plans, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    counters = reset_counters()
    results = []
    for i, (mode, steps) in enumerate(requests):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sample, post = request(mode, steps, i)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        check_sample(sample, post, mode, (BATCH, *gen.cfg.data.resolution))
        results.append({"mode": mode, "steps": steps, "batch": BATCH, "seconds": seconds,
                        "frames_per_s": BATCH / seconds, "sample_std": float(sample.std()),
                        "valid_depth_share": float((post["depth"] > 0).float().mean())})
    launches = {k: c.n for k, c in counters.items()}
    total_steps = sum(s for _, s in requests)
    for k, n in launches.items():
        want = per_call.get(k, 0) * total_steps
        check(n == want, f"{cfg_name}: {k} launches {n} != {per_call.get(k, 0)} x {total_steps}")
    emit({"phase": "main_path", "config": cfg_name, "dtype": str(gen.engine.dtype).split(".")[-1],
          "requests": results, "launches": launches, "card": smi,
          "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9})
    return {k: n for k, n in launches.items() if n}


def _category(kernel_name: str) -> str:
    name = kernel_name.lower()
    if "oaca" in name:  # the Hopper core's Oaca (and the cp.async loader's oaca_fwd_kernel)
        return "oaca kernel"
    if "attention_fwd" in name or ("flash_kernel" in name and "attn" in name):  # the Hopper core's Attn
        return "attention kernel"
    if "gn_fused" in name:
        return "groupnorm kernel"
    if any(k in name for k in ("conv", "fprop", "winograd", "implicit", "dgrad", "cudnn")):
        return "convolution (cuDNN)"
    if any(k in name for k in ("gemm", "gemv", "cutlass", "xmma")):
        return "matmul (cuBLAS)"
    return "elementwise, copy, concat, other"


def _trace(call, sleep_cycles: int) -> tuple[list, dict]:
    """The device kernels of the second of two traced calls of ``call``
    (the first is the trace's warm-up cycle: it can miss the kernels that
    start before the device tracing is running), each call queued between
    two sleeps of ``sleep_cycles`` (none if 0), and what the trace saw of
    the lead sleep: whether its kernel was recorded, and the ms from the
    traced step's start on the host to the first kernel of the call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        for _ in range(2):
            if sleep_cycles:
                torch.cuda._sleep(sleep_cycles)
            call()
            if sleep_cycles:
                torch.cuda._sleep(sleep_cycles)
            torch.cuda.synchronize()
            prof.step()
    events = prof.events()
    # the schedule's "ProfilerStep*" span is recorded on the device timeline
    # too, as one event that covers the whole call: not a kernel; nor are
    # the sleeps ("spin_kernel")
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and not e.name.startswith("ProfilerStep") and "spin_kernel" not in e.name]
    steps = [e.time_range.start for e in events if e.device_type == DeviceType.CPU
             and e.name.startswith("ProfilerStep")]
    seen = {"lead_sleep_seen": sleep_cycles > 0 and any("spin_kernel" in e.name and e.device_type == DeviceType.CUDA
                                                          for e in events),
            "first_kernel_after_step_start_ms": (min(e.time_range.start for e in kernels) - min(steps)) / 1e3
            if kernels and steps else None}
    return kernels, seen


def phase_profile(what: str, call, smi: str, inference: bool = True, expect: dict | None = None) -> dict:
    """Device time and kernels by category over one call of ``call`` (a
    denoiser call of a main path, B=8, under ``inference_mode``; or a train
    step): the device kernels of one traced call and the device's idle
    share against the call's time with Python's collector on, as a real
    call runs; returns the kernels by category.

    ``expect`` (category -> kernels) is checked exactly: a trace that holds
    more kernels of a category than expected fails at once.  One that holds
    fewer is traced again, up to ``TRACE_ATTEMPTS`` traces, each reported:
    the profiler drops the records of the kernels that run in the first
    milliseconds after the traced step starts (a whole run's trace of a
    train step held 47 of its 50 GroupNorm kernels behind a 1 ms lead
    sleep), so each traced call is queued behind a ~20 ms sleep, and a trace
    that still misses some shows whether the sleep itself was recorded.
    Also reported, not checked: the call's time with the collector off
    (timed in turns with it on, on / off / on / off; a train step, which
    the speed runs also time, one turn of 3 calls each) and, for a
    denoiser call, the kernels a trace sees when the call is not queued
    behind a sleep."""
    import torch

    expect = expect or {}
    attempts = []
    t_profile = time.perf_counter()
    with torch.inference_mode(inference):
        on, off = [], []
        turns, iters = (2, 5) if inference else (1, 3)
        for _ in range(turns):
            on.append(time_ms(call, iters=iters, warmup=1, gc_off=False))
            off.append(time_ms(call, iters=iters, warmup=1, gc_off=True))
        step_ms, step_ms_gc_off = sum(on) / turns, sum(off) / turns
        for _ in range(TRACE_ATTEMPTS):
            events, seen = _trace(call, TRACE_SLEEP_CYCLES)
            counts = {}
            for e in events:
                counts[_category(e.name)] = counts.get(_category(e.name), 0) + 1
            attempts.append({"device_kernels": len(events), **seen,
                             **{c: counts.get(c, 0) for c in expect}})
            for c, n in expect.items():
                check(counts.get(c, 0) <= n, f"{what}: {counts.get(c, 0)} {c}s traced, more than {n}")
            if all(counts.get(c, 0) == n for c, n in expect.items()):
                break
        unslept, unslept_seen = _trace(call, 0) if inference else ([], {})
    check(len(events) > 0, "the profiler saw no device kernels")
    for c, n in expect.items():
        check(counts.get(c, 0) == n, f"{what}: {counts.get(c, 0)} {c}s traced in each of {TRACE_ATTEMPTS} traces "
                                     f"{[a[c] for a in attempts]}, expected {n}")
    by_cat: dict[str, list] = {}
    by_name: dict[str, float] = {}
    for e in events:
        us = e.time_range.elapsed_us()
        cat = by_cat.setdefault(_category(e.name), [0.0, 0])
        cat[0] += us / 1e3
        cat[1] += 1
        by_name[e.name] = by_name.get(e.name, 0.0) + us / 1e3
    unslept_cats: dict[str, int] = {}
    for e in unslept:
        unslept_cats[_category(e.name)] = unslept_cats.get(_category(e.name), 0) + 1
    busy = sum(v[0] for v in by_cat.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    emit({"phase": "profile", "what": what, "card": smi, "step_ms": step_ms, "step_ms_runs": on,
          "step_ms_gc_off": step_ms_gc_off, "step_ms_gc_off_runs": off, "device_busy_ms": busy,
          "idle_share": max(0.0, 1.0 - busy / step_ms), "idle_share_gc_off": max(0.0, 1.0 - busy / step_ms_gc_off),
          "device_kernels": len(events), "trace_attempts": attempts,
          "by_category": {k: {"ms": v[0], "kernels": v[1]} for k, v in
                          sorted(by_cat.items(), key=lambda kv: -kv[1][0])},
          "top_kernels": [{"name": n[:90], "ms": ms} for n, ms in top],
          "trace_without_lead_sleep": {"device_kernels": len(unslept), "by_category": unslept_cats,
                                       **unslept_seen} if inference else "not taken for a train step",
          "profile_seconds": time.perf_counter() - t_profile})
    return {k: v[1] for k, v in by_cat.items()}


def profile_calls(cond_gen, uncond_gen):
    """One denoiser call (x̂_0 at t = 0.5, B=8, float32 in and out; the
    call itself in the generators' serving dtype) of each path."""
    import torch

    from lidarcrafter_tpu_torch.training.factory import layout_condition_batch

    H, W = cond_gen.cfg.data.resolution
    x = torch.randn(BATCH, H, W, 2, device=DEVICE)
    t = torch.full((BATCH,), 0.5, device=DEVICE)
    with torch.inference_mode():
        cond = cond_gen.engine.get_network_condition(
            layout_condition_batch(cond_gen.cfg, BATCH, device=DEVICE))
    return {
        "layout": lambda: cond_gen.engine.predict_x_0(x, t, cond),
        "uncond": lambda: uncond_gen.engine.predict_x_0(x, t),
    }


# ------------------------------------------------------------------ phase 6


def event_spans(fn, spans: list):
    """``fn`` with a pair of CUDA events recorded around each call into
    ``spans``."""
    import torch

    def timed(*args, **kwargs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*args, **kwargs)
        end.record()
        spans.append((start, end))
        return out

    return timed


def geometry_on_card_and_cpu(gen, frame0) -> dict:
    """The first autoregressive frame's geometry step from the card's frame
    0, run on the card and on the CPU with the same boxes and transform;
    counts the condition pixels that differ by more than GEOMETRY_RTOL of
    max(1, max |CPU|).  Also times the step on the card: its device time
    (one step, a few hundred launches, queued while the card sleeps ~50 ms; more
    steps would fill the card's launch queue and block the host) and the
    host's time to queue one step (mean of 3)."""
    import torch

    from lidarcrafter_tpu_torch.pipeline.temporal import frame_conditions, image_points_carry, scene_tracks
    from lidarcrafter_tpu_torch.sample_temporal import synthetic_scenes
    from lidarcrafter_tpu_torch.training.factory import make_lidar_utils

    out = {}
    for dev, lu in ((DEVICE, gen.lidar_utils), ("cpu", make_lidar_utils(gen.autoreg.cfg, "cpu"))):
        tracks = scene_tracks(*synthetic_scenes(ROLLOUT_SCENES, seed=1), ROLLOUT_FRAMES, 16, torch.device(dev))
        with torch.inference_mode():
            carry = image_points_carry(torch.as_tensor(frame0, device=dev), lu)
            def step():
                return frame_conditions(*carry, tracks.boxes[:, 0], tracks.next_boxes[:, 0],
                                        tracks.transforms[:, 0], tracks.classes_col, tracks.box_mask, lu)

            out[dev] = step()
            if dev == DEVICE:
                device_ms = time_ms(step, iters=1, sleep_cycles=int(1e8), gc_off=False)
                t0 = time.perf_counter()
                for _ in range(3):
                    step()
                enqueue_ms = (time.perf_counter() - t0) * 1e3 / 3
                torch.cuda.synchronize()
    result = {"step_device_ms": device_ms, "step_enqueue_ms": enqueue_ms}
    for name, got, want in zip(("concat_cond", "autoregressive_cond"), out[DEVICE], out["cpu"]):
        tol = GEOMETRY_RTOL * max(1.0, float(want.abs().max()))
        diff = (got.cpu() - want).abs()
        flipped = int((diff > tol).any(-1).sum())
        pixels = want[..., 0].numel()
        check(flipped <= (1 - GEOMETRY_PIXEL_SHARE) * pixels,
              f"rollout geometry card vs CPU, {name}: {flipped} of {pixels} pixels differ")
        result[name] = {"pixels_differing": flipped, "pixels": pixels, "max_abs_err": float(diff.max()),
                        "tol": tol}
    return result


def phase_rollout(dtype, smi: str) -> tuple[dict, list]:
    """The 4D rollout on the card (phase 6); returns its launch counts and
    its frames (host arrays)."""
    import torch

    from lidarcrafter_tpu_torch.configs import get_config
    from lidarcrafter_tpu_torch.sample_temporal import RolloutGenerator

    dname = str(dtype).split(".")[-1]
    t0 = time.perf_counter()
    gen = RolloutGenerator(get_config("nuscenes-box-layout-v6"), get_config("nuscenes-auto-reg-v2"),
                           DEVICE, 0, dtype, num_steps=2, mode="dpmpp_2m")
    pipe = gen.pipeline
    gen.generate(ROLLOUT_SCENES, num_frames=1, seed=99)  # warm-up: 1 + 1 frames, 2 steps
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    pipe.num_sampling_steps = ROLLOUT_STEPS

    geometry, denoise = [], []
    pipe.frame_conditions = event_spans(pipe.frame_conditions, geometry)
    for engine in (pipe.cond_engine, pipe.autoreg_engine):
        engine.denoise = event_spans(engine.denoise, denoise)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters = reset_counters()
    t0 = time.perf_counter()
    frames = gen.generate(ROLLOUT_SCENES, num_frames=ROLLOUT_FRAMES, seed=1, stream_chunks=2)
    seconds = time.perf_counter() - t0
    launches = {k: c.n for k, c in counters.items()}
    torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    n_frames, calls = ROLLOUT_FRAMES + 1, (ROLLOUT_FRAMES + 1) * ROLLOUT_STEPS
    check(len(frames) == n_frames, f"rollout {dname}: {len(frames)} frames, expected {n_frames}")
    for i, f in enumerate(frames):
        check(f.shape == (ROLLOUT_SCENES, *pipe.lidar_utils.resolution, 2), f"rollout {dname} frame {i}: shape {f.shape}")
        check(bool(np.isfinite(f).all()), f"rollout {dname} frame {i} is not finite")
        check(float(f.std()) > 1e-3, f"rollout {dname} frame {i} is constant")
    per_call = {"oaca": OACA_PER_FORWARD, "groupnorm": GN_PER_FORWARD}
    for k, n in launches.items():
        want = per_call.get(k, 0) * calls
        check(n == want, f"rollout {dname}: {k} launches {n} != {per_call.get(k, 0)} x {calls}")
    check(len(geometry) == ROLLOUT_FRAMES and len(denoise) == calls,
          f"rollout {dname}: {len(geometry)} geometry steps, {len(denoise)} denoiser calls")
    geometry_ms = [a.elapsed_time(b) for a, b in geometry]
    denoise_ms = [a.elapsed_time(b) for a, b in denoise]
    card_vs_cpu = geometry_on_card_and_cpu(gen, frames[0])
    emit({"phase": "rollout", "dtype": dname, "card": smi, "scenes": ROLLOUT_SCENES, "frames": n_frames,
          "mode": "dpmpp_2m", "steps": ROLLOUT_STEPS, "denoiser_calls": calls, "seconds": seconds,
          "frames_per_s": n_frames * ROLLOUT_SCENES / seconds,
          "geometry_ms_per_frame": sum(geometry_ms) / len(geometry_ms), "geometry_ms_max": max(geometry_ms),
          "geometry_share": sum(geometry_ms) / 1e3 / seconds,
          "denoiser_ms_per_call": sum(denoise_ms) / len(denoise_ms),
          "outside_denoiser_share": 1.0 - sum(denoise_ms) / 1e3 / seconds,
          "peak_memory_gb": peak_gb, "launches": launches, "setup_and_warmup_seconds": setup_s,
          "frame_std": [float(f.std()) for f in frames], "card_vs_cpu_geometry": card_vs_cpu})
    return {k: n for k, n in launches.items() if n}, frames


# ------------------------------------------------------------------ phase 7


BACKWARD_LIBRARY = {
    "oaca": "F.scaled_dot_product_attention forward + backward on the concatenated strips",
    "attention": "F.scaled_dot_product_attention forward + backward",
    "groupnorm": "F.group_norm forward + backward (affine only)",
}


def _backward_case(kernel, dtype, gen):
    """The operands of one route at its largest main-path shape (B=8), as
    leaves that require grad, laid out as the blocks pass them; returns
    (label, leaves, ops(), kernel call, plain call, backward call(g),
    library forward + backward call(g), bytes, flops)."""
    import torch
    import torch.nn.functional as F

    from lidarcrafter_tpu_torch.kernels import attention, groupnorm, oaca

    def leaf(t):
        return t.to(dtype).requires_grad_()

    def r(*shape):
        return torch.randn(*shape, generator=gen, device=DEVICE)

    elt = torch.finfo(dtype).bits // 8
    if kernel == "oaca":
        B, H, L, L2 = BATCH, 8, 2048, 13
        C = H * 32
        qkv, ipe, k_l, v_l = leaf(r(B, L, 3 * C)), leaf(r(B, L, C)), leaf(r(B, H, L2, 64)), leaf(r(B, L2, C))
        heads = lambda t: t.reshape(B, t.shape[1], H, -1).transpose(1, 2)  # noqa: E731
        scale = 1.0 / math.sqrt(math.sqrt(64))

        def ops():
            q_c, k_c, v_c = (heads(t) for t in qkv.chunk(3, dim=-1))
            return q_c, heads(ipe), k_c, k_l, v_c, heads(v_l)

        saved = [t.detach() for t in ops()]
        q_img = torch.cat([saved[0], saved[1]], -1).detach().requires_grad_()
        k_mix = torch.cat([torch.cat([saved[2], saved[1]], -1), saved[3]], 2).detach().requires_grad_()
        v_mix = torch.cat([saved[4], saved[5]], 2).detach().requires_grad_()

        def library(g):
            out = F.scaled_dot_product_attention(q_img, k_mix, v_mix, scale=scale**2)
            return torch.autograd.grad(out, (q_img, k_mix, v_mix), g)

        n_ops = 4 * B * H * L * 32 + B * H * L2 * 96  # q_c, ipe, k_c, v_c; k_l, v_l
        return ("ds4 B=8 h=8 L=2048+13", [qkv, ipe, k_l, v_l],
                lambda: oaca.oaca_attention(*ops(), scale=scale),
                lambda: oaca.oaca_attention_plain(*ops(), scale=scale),
                lambda g: oaca.oaca_attention_backward(saved, g, scale=scale), library,
                elt * (2 * n_ops + 2 * B * H * L * 32), 2.0 * B * H * L * (L + L2) * (3 * 64 + 2 * 32))
    if kernel == "attention":
        B, H, L, d = BATCH, 8, 512, 64
        qkv = leaf(r(B, L, 3 * H * d))

        def ops():
            return [t.reshape(B, L, H, d).transpose(1, 2) for t in qkv.split(H * d, dim=-1)]

        saved = [t.detach() for t in ops()]
        lib_ops = [t.clone().requires_grad_() for t in saved]

        def library(g):
            out = F.scaled_dot_product_attention(*lib_ops, scale=d**-0.5)
            return torch.autograd.grad(out, lib_ops, g)

        return ("d_block4 B=8 h=8 L=512 d=64", [qkv],
                lambda: attention.attention(*ops(), scale=d**-0.5),
                lambda: attention.attention_plain(*ops(), scale=d**-0.5),
                lambda g: attention.attention_backward(*saved, g, scale=d**-0.5), library,
                elt * B * H * L * d * 8, 2.0 * B * H * L * L * 5 * d)
    label, shape, ss = {
        "groupnorm 192": ("level0 (8,32,1024,192) in_norm out_0_0_res + SiLU", (BATCH, 32, 1024, 192), False),
        "groupnorm 64": ("level0 (8,32,1024,64) out_norm scale-shift + SiLU", (BATCH, 32, 1024, 64), True),
    }[kernel]
    C = shape[-1]
    x, w, b = leaf(r(*shape) * 2 + 1), leaf(1 + 0.1 * r(C)), leaf(0.1 * r(C))
    proj = leaf(0.3 * r(BATCH, 2 * C)) if ss else None

    def args():
        s, t = proj.chunk(2, dim=-1) if ss else (None, None)
        return dict(num_groups=32, eps=1e-5, scale=s, shift=t, silu=True)

    a = args()
    saved = [t if t is None else t.detach() for t in (x, w, b, a["scale"], a["shift"])]
    lib_ops = [t.detach().clone().requires_grad_() for t in (x, w, b)]

    def library(g):
        x_nchw = lib_ops[0].reshape(BATCH, -1, 1, C).permute(0, 3, 1, 2)
        out = F.group_norm(x_nchw, 32, lib_ops[1], lib_ops[2], 1e-5)
        return torch.autograd.grad(out, lib_ops, g.reshape(BATCH, -1, 1, C).permute(0, 3, 1, 2))

    n = x.numel()
    return (label, [t for t in (x, w, b, proj) if t is not None],
            lambda: groupnorm.group_norm(x, w, b, **args()), lambda: groupnorm.group_norm_plain(x, w, b, **args()),
            lambda g: groupnorm.group_norm_backward(saved, g, num_groups=32, eps=1e-5, silu=True), library,
            elt * 4 * n, 30.0 * n)


def check_backward(kernel: str, dtype, gen) -> dict:
    """Phase 7 (a): one route's gradients through the kernel (forward
    kernel, backward recompute) against autograd through the plain version,
    both limits per operand; device times of the backward, of autograd's
    backward through the plain version, and of the library's forward +
    backward."""
    import torch

    label, leaves, through_kernel, plain, backward, library, nbytes, flops = _backward_case(kernel, dtype, gen)
    out = through_kernel()
    check(out.grad_fn is not None, f"{kernel} backward: the kernel route has no grad_fn")
    g = torch.randn(out.shape, generator=gen, device=DEVICE).to(dtype)
    got = torch.autograd.grad(out, leaves, g)
    want_out = plain()
    want = torch.autograd.grad(want_out, leaves, g, retain_graph=True)
    dname = str(dtype).split(".")[-1]
    errs = [kernel_errors(f"{kernel} backward operand {i}", dname, a, b) for i, (a, b) in enumerate(zip(got, want))]
    worst = {k: max(e[k] for e in errs) for k in ("max_abs_err", "rel_err", "norm_rel_err")}
    del got, want, out
    bound, by = bound_ms(nbytes, flops, work_route(kernel, dname))
    row = {
        "kernel": kernel, "pass": "backward", "shape": label, "dtype": dname, "route": PLAIN_ROUTE,
        **worst, "tol": TOL[dname], "norm_tol": NORM_TOL[dname],
        "ms": time_ms(lambda: backward(g), iters=5, warmup=1),
        "plain_ms": time_ms(lambda: torch.autograd.grad(want_out, leaves, g, retain_graph=True), iters=5, warmup=1),
        "library_ms": time_ms(lambda: library(g), iters=5, warmup=1), "library": BACKWARD_LIBRARY[kernel.split()[0]],
        "bound_ms": bound, "bound_by": by, "bytes": nbytes, "flops": flops,
    }
    check(row["ms"] >= bound, f"{kernel} backward {dname}: {row['ms']} ms below its bound {bound} ms")
    del want_out
    torch.cuda.empty_cache()
    return row


def phase_backward() -> list:
    import torch

    gen = torch.Generator(device=DEVICE).manual_seed(7)
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for kernel in ("oaca", "attention", "groupnorm 192", "groupnorm 64"):
            rows.append(check_backward(kernel, dtype, gen))
            emit({"phase": "train", "check": "backward", **rows[-1]})
    return rows


def _train_cfg(cfg_name: str, batch: int, amp: bool, **training):
    """``cfg_name`` with its training fields overridden."""
    from lidarcrafter_tpu_torch.configs import get_config

    cfg = get_config(cfg_name)
    cfg.training.batch_size_train = batch
    cfg.training.mixed_precision = "bf16" if amp else "no"
    for k, v in training.items():
        setattr(cfg.training, k, v)
    return cfg


def _trainer(cfg_name: str, batch: int, amp: bool, out_dir: str, **training):
    """The train CLI's trainer for ``cfg_name`` (``Trainer``, ``FlowTrainer``,
    ``LayoutTrainer`` or ``ObjectTrainer``) over its synthetic source, with
    the training config's fields overridden; returns it and its log."""
    from lidarcrafter_tpu_torch import train as train_cli

    logs = []
    trainer = train_cli.build_trainer(_train_cfg(cfg_name, batch, amp, **training), 5, DEVICE, output_dir=out_dir,
                                      log_fn=logs.append)
    return trainer, logs


def phase_train_speed(cfg_name: str, amp: bool, per_step: dict, smi: str, out_dir: str) -> dict:
    """Phase 7 (c): ``TRAIN_WARMUP`` then ``TRAIN_TIMED`` steps at B=8 with
    the launch counters set to 0 just before the timed steps and read just
    after (exact counts per step); returns the non-zero counts."""
    import torch

    trainer, logs = _trainer(cfg_name, BATCH, amp, out_dir)
    total = TRAIN_WARMUP + TRAIN_TIMED
    state = trainer.train(num_steps=TRAIN_WARMUP, seed=0, checkpoint_every=10**9, log_every=10**9)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters = reset_counters()
    t0 = time.perf_counter()
    state = trainer.train(num_steps=total, state=state, checkpoint_every=10**9, log_every=total)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k: c.n for k, c in counters.items()}
    dname = "bfloat16 AMP" if amp else "float32"
    for k, n in launches.items():
        want = per_step.get(k, 0) * TRAIN_TIMED
        check(n == want, f"train {cfg_name} {dname}: {k} launches {n} != {per_step.get(k, 0)} x {TRAIN_TIMED}")
    loss = logs[-1]["loss"]
    check(logs[-1]["step"] == total and math.isfinite(loss), f"train {cfg_name} {dname}: loss {loss}")
    emit({"phase": "train", "check": "speed", "config": cfg_name, "dtype": dname, "batch": BATCH,
          "card": smi, "timed_steps": TRAIN_TIMED, "seconds": seconds, "steps_per_s": TRAIN_TIMED / seconds,
          "frames_per_s": TRAIN_TIMED * BATCH / seconds, "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
          "launches": launches, "loss": loss})
    # where a float32 step's device time goes; its forward holds every
    # GroupNorm kernel (the AMP steps' launches are counted above, untraced)
    if not amp:
        batch = trainer.prepare_batch(next(trainer.data_iter))
        phase_profile(f"one train step ({cfg_name}), B=8, {dname}", lambda: trainer.step_fn(state, batch, 0), smi,
                      inference=False,
                      expect={f"{k} kernel": per_step.get(k, 0) for k in ("groupnorm", "attention", "oaca")})
    del trainer, state
    torch.cuda.empty_cache()
    return {k: n for k, n in launches.items() if n}


def _loss_gate(cfg_name: str, batch: int, per_step: dict, smi: str, out_dir: str):
    """``cfg_name``'s trainer for ``GATE_STEPS`` steps (``GATE_STEPS_BY_CONFIG``
    where it names the config) at ``batch``, float32,
    lr 1e-4 with 20 warm-up steps, the launch counters set to 0 just before
    and read just after (``per_step`` launches a step, 0 if absent): the
    mean of the last 10 losses must lie below that of the first 10.
    Returns the final state, its checkpoint and the launch counts."""
    from lidarcrafter_tpu_torch.training.checkpoint import latest_checkpoint

    out_dir = str(Path(out_dir) / cfg_name)
    steps = GATE_STEPS_BY_CONFIG.get(cfg_name, GATE_STEPS)
    trainer, logs = _trainer(cfg_name, batch, False, out_dir, lr=1e-4, lr_warmup_steps=20, num_steps=steps)
    counters = reset_counters()
    t0 = time.perf_counter()
    state = trainer.train(num_steps=steps, seed=0, checkpoint_every=steps, log_every=1)
    seconds = time.perf_counter() - t0
    launches = {k: c.n for k, c in counters.items()}
    for k, n in launches.items():
        check(n == per_step.get(k, 0) * steps, f"{cfg_name} loss gate: {k} launches {n}")
    losses = [r["loss"] for r in logs if "loss" in r]
    check(len(losses) == steps and all(math.isfinite(v) for v in losses), f"{cfg_name} loss gate: losses")
    first, last = sum(losses[:10]) / 10, sum(losses[-10:]) / 10
    emit({"phase": "train", "check": "loss falls", "config": cfg_name, "batch": batch, "dtype": "float32",
          "steps": steps, "lr": 1e-4, "warmup": 20, "card": smi, "seconds": seconds,
          "first10_mean": first, "last10_mean": last, "ratio": last / first, "launches": launches,
          "losses_every_10": losses[::10]})
    check(last < first, f"{cfg_name} loss gate: mean of the last 10 losses {last:.4g} >= the first 10 {first:.4g}")
    path = latest_checkpoint(out_dir)
    check(path is not None and path.endswith(f"ckpt_{steps:010d}"), f"{cfg_name} loss gate: checkpoint {path}")
    del trainer
    return state, path, {k: n for k, n in launches.items() if n}


def _check_ema_served(what: str, models: dict, state) -> None:
    """The served ``models`` hold the EMA tensors of ``state``, running
    statistics included, bit for bit."""
    import torch

    for key, module in models.items():
        mine = module.state_dict()
        for name, value in state.ema[key].state_dict().items():
            check(torch.equal(mine[name], value), f"{what} checkpoint round trip: {key}.{name} differs")


def phase_train_gate(smi: str, out_dir: str) -> dict:
    """Phase 7 (d) and (e): ``nuscenes-auto-reg-v2`` trained ``GATE_STEPS``
    steps, its checkpoint served through ``sample_temporal``'s loader;
    returns the launch counts of the training run."""
    import torch

    from lidarcrafter_tpu_torch.configs import get_config
    from lidarcrafter_tpu_torch.sample_temporal import RolloutGenerator

    state, path, launches = _loss_gate("nuscenes-auto-reg-v2", GATE_BATCH,
                                       {"oaca": OACA_PER_FORWARD, "groupnorm": GN_PER_FORWARD}, smi, out_dir)
    gen = RolloutGenerator(get_config("nuscenes-box-layout-v6"), get_config("nuscenes-auto-reg-v2"), DEVICE, 0,
                           torch.float32, num_steps=15, mode="dpmpp_2m", autoreg_ckpt=path)
    _check_ema_served("nuscenes-auto-reg-v2", gen.autoreg.models, state)
    sample, post = gen.autoreg.generate(1, 15, mode="dpmpp_2m", seed=0)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(sample).all()) and bool(torch.isfinite(post["xyz"]).all()),
          "a frame sampled from the trained checkpoint is not finite")
    emit({"phase": "train", "check": "checkpoint serves", "checkpoint": Path(path).name,
          "ema_weights_equal": True, "sample_shape": list(sample.shape), "sample_std": float(sample.std()),
          "valid_depth_share": float((post["depth"] > 0).float().mean())})
    del state, gen
    torch.cuda.empty_cache()
    return launches


def phase_train(smi: str) -> tuple[list, dict]:
    """Phase 7; returns the backward rows and the train paths' launches."""
    rows = phase_backward()
    phase_step_parity("nuscenes-box-layout-v6", smi, "train")
    by_path = {}
    with tempfile.TemporaryDirectory() as out_dir:
        for amp in (False, True):
            dname = "bfloat16 AMP" if amp else "float32"
            by_path[f"train nuscenes-box-layout-v6 {dname}"] = phase_train_speed(
                "nuscenes-box-layout-v6", amp, {"oaca": OACA_PER_FORWARD, "groupnorm": GN_PER_FORWARD}, smi, out_dir)
            by_path[f"train nuscenes-unet-uncond {dname}"] = phase_train_speed(
                "nuscenes-unet-uncond", amp, {"attention": ATTN_PER_UNET, "groupnorm": GN_PER_UNET}, smi, out_dir)
        by_path["train nuscenes-auto-reg-v2 float32 (loss gate)"] = phase_train_gate(smi, out_dir)
    return rows, by_path


# ------------------------------------------------------------------ phase 8


def _branch_call(gen, request_fn, x, t):
    """One denoiser call of a branch's generator (its encoder, then the
    denoiser at log-SNR ``t``) on ``x``, on the generator's device; returns
    (condition, prediction)."""
    import torch

    with torch.inference_mode():
        cond = gen.engine.get_network_condition(request_fn(gen.device))
        return cond, gen.engine.denoise(x.to(gen.device), t.to(gen.device), cond)


def _on_cpu(gen):
    """A copy of ``gen`` whose models and engine live on the CPU."""
    import torch

    cpu = copy.copy(gen)
    cpu.models = {k: copy.deepcopy(m).cpu() for k, m in gen.models.items()}
    cpu.engine = dataclasses.replace(gen.engine, model=cpu.models["model"], cond_model=cpu.models["cond"])
    cpu.device = torch.device("cpu")
    return cpu


def _branch_requests(name: str, generate, check_out, per_call: dict, smi: str) -> tuple[list, dict]:
    """``BRANCH_REQUESTS`` through ``generate(steps, mode, seed)`` after one
    warm-up, the launch counters set to 0 just before and read just after;
    each kernel must have launched ``per_call[kernel]`` times a denoiser
    call (0 if absent).  Returns the requests' lines and the counts."""
    import torch

    generate(2, "ddim", 99)  # warm-up: cuBLAS handles, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters = reset_counters()
    results = []
    for i, (mode, steps) in enumerate(BRANCH_REQUESTS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = generate(steps, mode, i)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        results.append({"mode": mode, "steps": steps, "denoiser_calls": steps, "seconds": seconds,
                        "ms_per_call": seconds * 1e3 / steps, **check_out(out, mode)})
    launches = {k: c.n for k, c in counters.items()}
    calls = sum(s for _, s in BRANCH_REQUESTS)
    for k, n in launches.items():
        check(n == per_call.get(k, 0) * calls, f"{name}: {k} launches {n} != {per_call.get(k, 0)} x {calls}")
    return results, launches


def phase_layout(smi: str) -> dict:
    """Phase 8a: scene graph → 4D layout (``nuscenes-layout`` at its
    published widths, float32) through ``LayoutGenerator``; returns the
    launch counts of its requests."""
    import torch

    from lidarcrafter_tpu_torch.configs import get_config
    from lidarcrafter_tpu_torch.datasets.transforms import unscale_boxes_3d
    from lidarcrafter_tpu_torch.generate_layout import LayoutGenerator, layout_request
    from lidarcrafter_tpu_torch.models.ops import GroupNorm32
    from lidarcrafter_tpu_torch.utils.synthetic import synthetic_scene_graphs

    t0 = time.perf_counter()
    gen = LayoutGenerator(get_config("nuscenes-layout"), DEVICE, 0)
    build_s = time.perf_counter() - t0
    n = sum(isinstance(m, GroupNorm32) for m in gen.models["model"].modules())
    check(n == GN_PER_UNET1D, f"nuscenes-layout: {n} GroupNorm32 modules, expected {GN_PER_UNET1D}")
    batch = synthetic_scene_graphs(LAYOUT_SCENES, LAYOUT_OBJECTS, seed=0)
    N, T = len(batch["decoder"]["objs"]), len(batch["decoder"]["tripltes"])
    x = torch.randn(N, 20, generator=torch.Generator().manual_seed(30))
    t = torch.linspace(-5.0, 5.0, N)  # log-SNR, a spread of noise levels across the nodes

    counters = reset_counters()
    cond, got = _branch_call(gen, lambda d: layout_request(batch, d), x, t)
    torch.cuda.synchronize()
    launches = {k: c.n for k, c in counters.items()}
    check(launches == with_zeros({"groupnorm": GN_PER_UNET1D}, launches),
          f"nuscenes-layout: one denoiser call launched {launches}")
    cpu = _on_cpu(gen)
    t0 = time.perf_counter()
    want_cond, want = _branch_call(cpu, lambda d: layout_request(batch, d), x, t)
    cpu_s = time.perf_counter() - t0
    del cpu
    check_forward("nuscenes-layout SceneGraph latent (c_b) float32", cond["other_condition"]["c_b"].cpu(),
                  want_cond["other_condition"]["c_b"], FORWARD_RTOL, nodes=N, triples=T)
    check_forward("nuscenes-layout denoiser call (SceneGraph + UNet1DModel) float32", got.cpu(), want,
                  FORWARD_RTOL, nodes=N, triples=T, cpu_seconds=cpu_s, launches=launches)

    t_full = torch.full((N,), 0.5, device=DEVICE)
    x_card = x.to(DEVICE)
    phase_profile(f"one denoiser call (nuscenes-layout, predict_x_0), N={N}, float32",
                  lambda: gen.engine.predict_x_0(x_card, t_full, cond), smi, expect={"groupnorm kernel": GN_PER_UNET1D})

    def check_out(raw, mode):
        raw = raw.cpu().numpy()
        check(raw.shape == (N, 20), f"layout {mode}: shape {raw.shape}")
        check(bool(np.isfinite(raw).all()), f"layout {mode}: sample is not finite")
        check(float(raw.std()) > 1e-3, f"layout {mode}: sample is constant")
        with np.errstate(over="ignore"):
            boxes, trajs = unscale_boxes_3d(raw)
        # centre, yaw and trajectories are finite functions of the sample;
        # the sizes are exp(log size), which an untrained denoiser's
        # unclipped x̂_0 may overflow: counted, not held
        check(bool(np.isfinite(boxes[:, [0, 1, 2, 6]]).all()) and bool(np.isfinite(trajs).all()),
              f"layout {mode}: unscale_boxes_3d centres, yaw or trajectories not finite")
        return {"sample_abs_mean": float(np.abs(raw).mean()), "sample_abs_max": float(np.abs(raw).max()),
                "finite_sizes_share": float(np.isfinite(boxes[:, 3:6]).mean())}

    results, launches = _branch_requests(
        "nuscenes-layout", lambda steps, mode, seed: gen.generate(batch, steps, mode=mode, seed=seed),
        check_out, {"groupnorm": GN_PER_UNET1D}, smi)
    emit({"phase": "layout", "config": "nuscenes-layout", "dtype": "float32", "card": smi, "scenes": LAYOUT_SCENES,
          "nodes": N, "triples": T, "requests": results, "launches": launches,
          "groupnorm_per_call": GN_PER_UNET1D, "build_seconds": build_s,
          "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9})
    del gen
    torch.cuda.empty_cache()
    return {k: n for k, n in launches.items() if n}


BOX_CONDITION_SCENES, BOX_CONDITION_STEPS = 2, 8  # generate_box_condition --synthetic-scenes, DDPM steps


def phase_object(smi: str) -> None:
    """Phase 8b: box + class → object points (``nuscenes-object``, float32)
    through ``ObjectGenerator``, for the 96 objects of the layout phase's
    scenes; then ``generate_box_condition`` on ``BOX_CONDITION_SCENES``
    synthetic scenes.  No kernel of the port runs on this path (Linears and
    pointwise ops); the launch counters must stay at 0."""
    import torch

    from lidarcrafter_tpu_torch.configs import get_config
    from lidarcrafter_tpu_torch.generate_object import ObjectGenerator
    from lidarcrafter_tpu_torch.utils.synthetic import synthetic_object_boxes

    gen = ObjectGenerator(get_config("nuscenes-object"), DEVICE, 0)
    boxes = synthetic_object_boxes(LAYOUT_SCENES, LAYOUT_OBJECTS, seed=0)
    B, P = len(boxes["fg_class"]), gen.cfg.data.num_samples

    def request(device):
        return {k: torch.as_tensor(v, device=device) for k, v in boxes.items()}

    x = torch.randn(B, P, 4, generator=torch.Generator().manual_seed(31))
    t = torch.linspace(-5.0, 5.0, B)
    counters = reset_counters()
    _, got = _branch_call(gen, request, x, t)
    torch.cuda.synchronize()
    check(all(c.n == 0 for c in counters.values()), "nuscenes-object: a kernel launched in a denoiser call")
    cpu = _on_cpu(gen)
    t0 = time.perf_counter()
    _, want = _branch_call(cpu, request, x, t)
    cpu_s = time.perf_counter() - t0
    del cpu
    check_forward("nuscenes-object denoiser call (ObjectGenEncoder + PointUNet) float32", got.cpu(), want,
                  FORWARD_RTOL, objects=B, points=P, cpu_seconds=cpu_s)
    with torch.inference_mode():
        cond = gen.engine.get_network_condition(request(DEVICE))
    x_card, t_half = x.to(DEVICE), torch.full((B,), 0.5, device=DEVICE)
    phase_profile(f"one denoiser call (nuscenes-object, predict_x_0), B={B}, {P} points, float32",
                  lambda: gen.engine.predict_x_0(x_card, t_half, cond), smi,
                  expect={"groupnorm kernel": 0, "attention kernel": 0, "oaca kernel": 0})

    def check_out(out, mode):
        check(tuple(out.shape) == (B, P, 4), f"object {mode}: shape {tuple(out.shape)}")
        check(bool(torch.isfinite(out).all()), f"object {mode}: sample is not finite")
        check(float(out.std()) > 1e-3, f"object {mode}: sample is constant")
        return {"sample_abs_mean": float(out.abs().mean()), "sample_abs_max": float(out.abs().max())}

    results, launches = _branch_requests(
        "nuscenes-object", lambda steps, mode, seed: gen.generate(boxes, steps, mode=mode, seed=seed),
        check_out, {}, smi)
    emit({"phase": "object", "config": "nuscenes-object", "dtype": "float32", "card": smi, "objects": B,
          "points": P, "requests": results, "launches": launches, "kernels": "none on this path",
          "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9})
    del gen
    torch.cuda.empty_cache()

    # generate_box_condition on synthetic scenes: each scene's objects
    # sampled with DDPM on the card, placed, projected, normalised
    from lidarcrafter_tpu_torch import generate_box_condition

    with tempfile.TemporaryDirectory() as tmp:
        counters = reset_counters()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            generate_box_condition.main(["--random-params", "--synthetic-scenes", str(BOX_CONDITION_SCENES),
                                         "--num-steps", str(BOX_CONDITION_STEPS), "-o", tmp])
        seconds = time.perf_counter() - t0
        check(all(c.n == 0 for c in counters.values()), "generate_box_condition: a kernel launched")
        conds = [np.load(f) for f in sorted((Path(tmp) / "train").glob("sample_*.npy"))]
        check(len(conds) == BOX_CONDITION_SCENES and all(c.shape == (3, 32, 1024) and np.isfinite(c).all()
                                                         for c in conds), "generate_box_condition: conditions")
    emit({"phase": "object", "check": "generate_box_condition --synthetic-scenes", "card": smi,
          "scenes": BOX_CONDITION_SCENES, "ddpm_steps": BOX_CONDITION_STEPS, "seconds": seconds,
          "condition_shape": [3, 32, 1024]})


# ------------------------------------------------------------------ phase 9


# the tangent of a forward-mode route: the plain version's, in float32 from a recompute
JVP_ROUTE = "kernel forward + plain f32 tangent"
BRANCH_PER_STEP = {  # kernel launches a train step of each branch
    "nuscenes-layout": {"groupnorm": GN_PER_UNET1D},
    "nuscenes-object": {},
    "meanflow-nusc": {"attention": ATTN_PER_UNET, "groupnorm": GN_PER_UNET},
}
# card-vs-CPU step batches: 8 scenes of ego + 12 (budgets 112 / 3,536), the
# 96 objects of those scenes, 1 frame (MeanFlow: 2 up to PR 12, whose CPU
# side took ~15 s; v6)
PARITY_BATCH = {"nuscenes-layout": LAYOUT_SCENES, "nuscenes-object": LAYOUT_SCENES * LAYOUT_OBJECTS,
                "meanflow-nusc": 1, "nuscenes-box-layout-v6": 1}
# the loss gates: 8 scenes; 96 objects (at 8, a step's loss spreads as far as
# 100 steps move its mean); 2 frames
GATE_BATCH_BRANCH = {"nuscenes-layout": LAYOUT_SCENES, "nuscenes-object": LAYOUT_SCENES * LAYOUT_OBJECTS,
                     "meanflow-nusc": 2}


def _jvp_case(kernel: str, label: str, dtype, gen):
    """(wrapper call, plain call, primals, tangents, bytes, forward flops,
    tangent flops) of one route at a MeanFlow UNet shape,
    the operands laid out as the blocks pass them: attention on per-head
    views of one (B, L, 3C) projection, GroupNorm on x with the AdaGN
    scale-shift halves of one (B, 2C) projection or the norm's own affine."""
    import torch

    from lidarcrafter_tpu_torch.kernels import attention, groupnorm

    def r(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=gen, device=DEVICE)).to(dtype)

    elt = torch.finfo(dtype).bits // 8
    if kernel == "attention":
        B, H, L, d = BATCH, 8, 512, int(label.rsplit("d=", 1)[1])
        C = H * d

        def heads(qkv):
            return [t.reshape(B, L, H, d).transpose(1, 2) for t in qkv.split(C, dim=-1)]

        primals, tangents = (r(B, L, 3 * C),), (r(B, L, 3 * C),)
        return (lambda qkv: attention.attention(*heads(qkv), scale=d**-0.5),
                lambda qkv: attention.attention_plain(*heads(qkv), scale=d**-0.5), primals, tangents,
                elt * 8 * B * L * C, 4.0 * B * H * L * L * d, 8.0 * B * H * L * L * d)
    if "AdaGN" in label:
        shape, C = (BATCH, 32, 1024, 64), 64

        def args(proj):
            s, t = proj.chunk(2, dim=-1)
            return dict(num_groups=8, eps=1e-6, scale=s, shift=t, silu=True)

        primals = (r(*shape, scale=2.0) + 1, r(BATCH, 2 * C, scale=0.3))
        tangents = (r(*shape), r(BATCH, 2 * C))
        call = lambda x, proj: groupnorm.group_norm(x, None, None, **args(proj))  # noqa: E731
        plain = lambda x, proj: groupnorm.group_norm_plain(x, None, None, **args(proj))  # noqa: E731
        small = 4 * BATCH * C
    else:
        shape, C = (BATCH, 4, 128, 512), 512
        args = dict(num_groups=8, eps=1e-6, silu=True)
        primals = (r(*shape, scale=2.0) + 1, 1 + r(C, scale=0.1), r(C, scale=0.1))
        tangents = (r(*shape), r(C, scale=0.1), r(C, scale=0.1))
        call = lambda x, w, b: groupnorm.group_norm(x, w, b, **args)  # noqa: E731
        plain = lambda x, w, b: groupnorm.group_norm_plain(x, w, b, **args)  # noqa: E731
        small = 4 * C
    n = math.prod(shape)
    # x and its tangent read, y and its tangent written, the affine operands and theirs read
    return call, plain, primals, tangents, elt * (4 * n + small), 10.0 * n, 20.0 * n


def check_jvp(kernel: str, label: str, dtype, gen) -> dict:
    """Phase 9 (a): one route under ``torch.func.jvp`` through the wrapper
    (one kernel launch, the tangent from the route's forward-mode rule) and
    under ``forward_ad``, against ``torch.func.jvp`` through the plain
    version, primal and tangent to the forward rows' limits; device times
    of the jvp through the route and through the plain version."""
    import torch
    from torch.autograd import forward_ad

    from lidarcrafter_tpu_torch.kernels import attention, groupnorm

    call, plain, primals, tangents, nbytes, fwd_flops, tan_flops = _jvp_case(kernel, label, dtype, gen)
    counter = {"attention": attention.launches, "groupnorm": groupnorm.launches}[kernel]
    dname = str(dtype).split(".")[-1]
    n = counter.n
    out, tan = torch.func.jvp(call, primals, tangents)
    with forward_ad.dual_level():
        dual_out, dual_tan = forward_ad.unpack_dual(call(*(forward_ad.make_dual(a, t)
                                                           for a, t in zip(primals, tangents))))
    torch.cuda.synchronize()
    check(counter.n == n + 2, f"{kernel} jvp {label} {dname}: {counter.n - n} launches for 2 calls")
    want_out, want_tan = torch.func.jvp(plain, primals, tangents)
    kernel_errors(f"{kernel} jvp {label} primal", dname, out, want_out)
    kernel_errors(f"{kernel} jvp {label} forward_ad tangent", dname, dual_tan, want_tan)
    errors = kernel_errors(f"{kernel} jvp {label} tangent", dname, tan, want_tan)
    del out, tan, dual_out, dual_tan, want_out, want_tan
    bound, by = bound_ms(nbytes, fwd_flops + tan_flops, work_route(kernel, dname))
    row = {
        "kernel": kernel, "pass": "jvp", "shape": label, "dtype": dname, "route": JVP_ROUTE, **errors,
        "ms": time_ms(lambda: torch.func.jvp(call, primals, tangents), iters=5, warmup=1),
        "plain_ms": time_ms(lambda: torch.func.jvp(plain, primals, tangents), iters=5, warmup=1),
        "library_ms": None, "library": "none: no one PyTorch call computes a tangent",
        "bound_ms": bound, "bound_by": by, "bytes": nbytes, "flops": fwd_flops + tan_flops,
    }
    check(row["ms"] >= bound, f"{kernel} jvp {label} {dname}: {row['ms']} ms below its bound {bound} ms")
    torch.cuda.empty_cache()
    return row


def phase_jvp() -> list:
    import torch

    gen = torch.Generator(device=DEVICE).manual_seed(9)
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for kernel, label in (("attention", "d_block4 B=8 h=8 L=512 d=64"), ("attention", "u_block4 B=8 h=8 L=512 d=32"),
                              ("groupnorm", "unet level0 (8,32,1024,64) AdaGN scale-shift+SiLU"),
                              ("groupnorm", "unet ds8 (8,4,128,512) SiLU")):
            rows.append(check_jvp(kernel, label, dtype, gen))
            emit({"phase": "branch_train", "check": "jvp", **rows[-1]})
    return rows


def _step_draws(cfg_name: str, trainer, batch) -> dict:
    """A step's draws, made on the CPU from a seed, so that the card and the
    CPU take the same step."""
    import torch

    gen = torch.Generator().manual_seed(23)
    if cfg_name == "nuscenes-layout":
        return {"t_scene": torch.rand(trainer.cfg.training.batch_size_train, generator=gen),
                "noise": torch.randn(trainer.max_nodes, 20, generator=gen)}
    x_0 = batch["x_0"] if isinstance(batch, dict) else batch
    draws = {}
    if cfg_name == "meanflow-nusc":
        draws["t"], draws["r"] = trainer.engine.sample_t_r(x_0.shape[0], gen)
    else:
        draws["t"] = torch.rand(x_0.shape[0], generator=gen)
    draws["noise"] = torch.randn(x_0.shape, generator=gen)
    return draws


def phase_step_parity(cfg_name: str, smi: str, phase: str, edit=None, label: str | None = None) -> None:
    """Phase 7 (b), phase 9 (b): one full-width float32 step of
    ``cfg_name``'s trainer at ``PARITY_BATCH``, the card (kernels) against
    the CPU (plain versions) on the same weights, batch and draws: the loss
    to ``TRAIN_LOSS_RTOL``, every trained tensor's gradient to
    ``TRAIN_GRAD_RTOL`` relative L2.  ``edit(cfg)`` changes the config
    first (phase 14: GLIDE blocks)."""
    import torch

    from lidarcrafter_tpu_torch import train as train_cli
    from lidarcrafter_tpu_torch.training.state import named_module_params
    from lidarcrafter_tpu_torch.training.train_step import loss_and_grads

    cfg = _train_cfg(cfg_name, PARITY_BATCH[cfg_name], False)
    if edit is not None:
        edit(cfg)
    cpu = train_cli.build_trainer(cfg, 5, "cpu", log_fn=None)
    cpu.init_state(21)
    card = train_cli.build_trainer(cfg, 5, DEVICE, log_fn=None)
    for k, m in card.models.items():
        m.load_state_dict(cpu.models[k].state_dict())
    raw = next(cpu.data_iter)
    want_batch, batch = cpu.prepare_batch(raw), card.prepare_batch(raw)
    draws = _step_draws(cfg_name, cpu, want_batch)
    names, want_params = zip(*named_module_params(cpu.models))
    kw = cpu._loss_kwargs()
    t0 = time.perf_counter()
    want_loss, want = loss_and_grads(cpu.engine, list(want_params), want_batch, cpu.loss_has_aux, **draws, **kw)
    cpu_s = time.perf_counter() - t0
    loss, got = loss_and_grads(card.engine, [t for _, t in named_module_params(card.models)], batch,
                               card.loss_has_aux, **{k: v.to(DEVICE) for k, v in draws.items()}, **kw)
    loss_rel = abs(float(loss) - float(want_loss)) / abs(float(want_loss))
    total = math.sqrt(sum(float(w.norm()) ** 2 for w in want))
    rows = []
    for name, a, b in zip(names, got, want):
        diff, ref = float((a.cpu() - b).norm()), float(b.norm())
        rows.append((diff / max(ref, 1e-30), name, ref, diff))
    rows.sort(reverse=True)
    overall = math.sqrt(sum(r[3] ** 2 for r in rows)) / total
    emit({"phase": phase, "check": "step parity", "config": label or cfg_name, "batch": PARITY_BATCH[cfg_name],
          "dtype": "float32", "card": smi, "loss_card": float(loss), "loss_cpu": float(want_loss),
          "loss_rel_err": loss_rel, "loss_tol": TRAIN_LOSS_RTOL, "grad_tol": TRAIN_GRAD_RTOL,
          "grad_overall_rel_l2": overall, "tensors": len(rows), "zero_gradients": sum(r[2] == 0 for r in rows),
          "cpu_seconds": cpu_s, "worst_tensors": [{"name": n, "rel_l2": e, "norm": ref} for e, n, ref, _ in rows[:5]]})
    check(loss_rel <= TRAIN_LOSS_RTOL, f"{cfg_name} step parity: loss relative error {loss_rel:.3g}")
    for e, name, ref, diff in rows:
        check(e <= TRAIN_GRAD_RTOL, f"{cfg_name} step parity: {name} gradient relative L2 {e:.3g} (norm {ref:.3g})")
    del cpu, card, got
    torch.cuda.empty_cache()


def phase_branch_gate(cfg_name: str, smi: str, out_dir: str) -> dict:
    """Phase 9 (e) and (f): ``cfg_name``'s loss gate, then its checkpoint
    served through the branch's generator (EMA weights and running
    statistics bit for bit, finite output); returns the gate's launches."""
    import torch

    from lidarcrafter_tpu_torch.configs import get_config
    from lidarcrafter_tpu_torch.generate_flow import FlowFrameGenerator
    from lidarcrafter_tpu_torch.generate_layout import LayoutGenerator
    from lidarcrafter_tpu_torch.generate_object import ObjectGenerator
    from lidarcrafter_tpu_torch.utils.synthetic import synthetic_object_boxes, synthetic_scene_graphs

    state, path, launches = _loss_gate(cfg_name, GATE_BATCH_BRANCH[cfg_name], BRANCH_PER_STEP[cfg_name], smi,
                                       out_dir)
    cfg = get_config(cfg_name)
    if cfg_name == "nuscenes-layout":
        gen = LayoutGenerator(cfg, DEVICE, ckpt=path)
        out = gen.generate(synthetic_scene_graphs(2, LAYOUT_OBJECTS, seed=1), 10, mode="ddim")
    elif cfg_name == "nuscenes-object":
        gen = ObjectGenerator(cfg, DEVICE, ckpt=path)
        out = gen.generate(synthetic_object_boxes(1, BATCH, seed=1), 10, mode="ddim")
    else:
        gen = FlowFrameGenerator(cfg, DEVICE, ckpt=path, ema=True)
        gen.models = {"model": gen.model}  # the one module the flow generator holds
        out, _ = gen.generate(2)
    _check_ema_served(cfg_name, gen.models, state)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(out).all()), f"{cfg_name}: a sample from the trained checkpoint is not finite")
    emit({"phase": "branch_train", "check": "checkpoint serves", "config": cfg_name, "checkpoint": Path(path).name,
          "ema_weights_equal": True, "sample_shape": list(out.shape), "sample_std": float(out.std())})
    del state, gen
    torch.cuda.empty_cache()
    return launches


def phase_branch_train(smi: str) -> tuple[list, dict]:
    """Phase 9; returns the jvp rows and the branch training paths' launches."""
    rows = phase_jvp()
    for cfg_name in BRANCH_PER_STEP:
        phase_step_parity(cfg_name, smi, "branch_train")
    by_path = {}
    with tempfile.TemporaryDirectory() as out_dir:
        for cfg_name, per_step in BRANCH_PER_STEP.items():
            for amp in (False, True):
                dname = "bfloat16 AMP" if amp else "float32"
                by_path[f"train {cfg_name} {dname}"] = phase_train_speed(cfg_name, amp, per_step, smi, out_dir)
            by_path[f"train {cfg_name} float32 (loss gate)"] = phase_branch_gate(cfg_name, smi, out_dir)
    return rows, by_path


# ------------------------------------------------------------------ phase 10


EVAL_SEED = 10
EVAL_PAIRS, EMD_POINTS = 8, 2048  # cd / emd / mmd pairs; the EMD pairs resampled to this size
CMP_POINTS, CMP_CLOUDS = 2048, 8  # card vs CPU: cd / mmd / TCD clouds resampled; clouds whose features are held
TCD_MAX_POINTS = 16384  # evaluate_temporal's --max-points
CHAMFER_POINTS, EMD_TIMED_POINTS = 32768, 26624  # a full scan; the EMD eval size of ops/emd.py
FEATURE_SET = (2000, 4096)  # Fréchet / MMD timing: an evaluation set of RangeNet-53 features
# card vs CPU limits: relative, except the engine's RBF mmd (a difference of
# kernel means near 1, held to 1e-4 of 1) and the feature matrices (relative
# L2); Fréchet distances in float64 on both sides; EMD's auction may break a
# near-tie the other way
EVAL_RTOL = {"cd": 1e-4, "jsd": 1e-4, "mmd": 1e-4, "tcd": 1e-4, "emd": 1e-3, "features": 1e-3, "frechet": 1e-3}
ICP_YAW_DEG, ICP_SHIFT, ICP_TOL_M = 3.0, (1.0, 0.5, 0.0), 0.05
ENGINE_METRICS = ("frd", "fpd", "jsd", "mmd")


def rollout_clouds(frames) -> list:
    """Each scene's frames of a rollout as host (N, 3) clouds, as
    ``sample_temporal`` writes them."""
    from lidarcrafter_tpu_torch.configs import get_config
    from lidarcrafter_tpu_torch.sample_temporal import frame_points
    from lidarcrafter_tpu_torch.training.factory import make_lidar_utils

    lu = make_lidar_utils(get_config("nuscenes-auto-reg-v2"), "cpu")
    return [[frame_points(f, s, lu) for f in frames] for s in range(frames[0].shape[0])]


def to_pixel_centres(cloud, H: int = 32, W: int = 1024, fov_up: float = 10.0, fov_down: float = -30.0):
    """``cloud`` turned by half a pixel in elevation and azimuth.  A frame's
    points lie on the ray angles of its range image, which are pixel edges,
    so projecting them again puts each on a bin edge, where an ulp between
    the card and the CPU flips its row; half a pixel on, they sit at pixel
    centres."""
    c = cloud.astype(np.float64)
    r = np.linalg.norm(c, axis=1)
    el = np.arcsin(c[:, 2] / r) - math.radians(fov_up - fov_down) / H / 2
    az = np.arctan2(c[:, 1], c[:, 0]) - math.pi / W
    return np.stack([r * np.cos(el) * np.cos(az), r * np.cos(el) * np.sin(az), r * np.sin(el)], 1).astype(np.float32)


def resample(cloud, n: int, rnd) -> np.ndarray:
    return cloud[rnd.choice(len(cloud), n, replace=len(cloud) < n)]


def agrees(out: dict, name: str, card: float, cpu: float, tol: float, scale: float | None = None) -> None:
    """Card against CPU, relative to |CPU| (or to ``scale``), recorded in
    ``out`` with ``ok``; the phase fails after all are recorded."""
    err = abs(card - cpu) / (abs(cpu) if scale is None else scale)
    out[name] = {"card": card, "cpu": cpu, "err": err, "tol": tol, "ok": bool(np.isfinite(card) and err <= tol)}


def agrees_l2(out: dict, name: str, card, cpu, tol: float) -> None:
    """Card against CPU in relative L2 norm, recorded as :func:`agrees` does."""
    card, cpu = np.asarray(card, np.float64), np.asarray(cpu, np.float64)
    err = float(np.linalg.norm(card - cpu) / np.linalg.norm(cpu)) if card.shape == cpu.shape else math.inf
    out[name] = {"shape": list(card.shape), "rel_l2_err": err, "tol": tol,
                 "ok": bool(np.isfinite(card).all() and err <= tol)}


def phase_evaluate(frames, smi: str) -> None:
    """Phase 10: the metric suite on the card over phase 6's float32 rollout
    (scenes 0-3 "real", 4-7 "gen", 8 frames each), with a RangeNet-53 and a
    PointNet of seeded weights; every metric again through the port on the
    CPU, on the same clouds and weights, held to ``EVAL_RTOL``."""
    import torch

    from lidarcrafter_tpu_torch.metrics import eval_suite, evaluate
    from lidarcrafter_tpu_torch.metrics.distribution import compute_frechet_distance, compute_squared_mmd
    from lidarcrafter_tpu_torch.metrics.engine import EvaluationEngine
    from lidarcrafter_tpu_torch.metrics.extractor.pointnet import PointNetFeatureExtractor
    from lidarcrafter_tpu_torch.metrics.extractor.rangenet import RangeNet, to_rangenet_folder
    from lidarcrafter_tpu_torch.metrics.pretrained import pointnet_features, rangenet_lidargen
    from lidarcrafter_tpu_torch.metrics.temporal import icp_point_to_point, sequence_tcd
    from lidarcrafter_tpu_torch.ops.bev import point_cloud_to_histogram
    from lidarcrafter_tpu_torch.ops.chamfer import chamfer_metric
    from lidarcrafter_tpu_torch.ops.emd import emd_metric
    from lidarcrafter_tpu_torch.weights import init_random_

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    counters = reset_counters()
    scenes = rollout_clouds(frames)
    half = len(scenes) // 2
    real = [c for s in scenes[:half] for c in s]
    gen = [c for s in scenes[half:] for c in s]
    sizes = [len(c) for c in real + gen]
    rnd = np.random.RandomState(EVAL_SEED)
    seconds, agree, metrics = {}, {}, {}

    def timed(name, fn):
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
        return result

    rangenet = init_random_(RangeNet(num_classes=17, backbone=53), EVAL_SEED).eval()
    pointnet = init_random_(PointNetFeatureExtractor(), EVAL_SEED + 1).eval()
    extract = {"cpu": (rangenet_lidargen(rangenet), pointnet_features(pointnet)),
               DEVICE: (rangenet_lidargen(copy.deepcopy(rangenet).to(DEVICE)),
                        pointnet_features(copy.deepcopy(pointnet).to(DEVICE)))}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        # the engine on the card, then its metrics on the CPU from the card's cached features
        engine = EvaluationEngine(rangenet_apply=extract[DEVICE][0], pointnet_apply=extract[DEVICE][1],
                                  cache_dir=str(tmp / "cache"), device=DEVICE)
        card = timed("engine", lambda: engine.evaluate(real, gen, ENGINE_METRICS))
        cpu = timed("engine_cpu_from_card_features",
                    lambda: EvaluationEngine(cache_dir=str(tmp / "cache"), device="cpu").evaluate(real, gen,
                                                                                                  ENGINE_METRICS))
        check(list(card) == ["frd", "frd_mmd", "fpd", "fpd_mmd", "jsd", "mmd"], f"engine metrics {list(card)}")
        for k in card:
            tol = EVAL_RTOL["frechet"] if k[:3] in ("frd", "fpd") else EVAL_RTOL[k]
            agrees(agree, f"engine {k}", card[k], cpu[k], tol, scale=1.0 if k == "mmd" else None)
        metrics.update({f"engine_{k}": v for k, v in card.items()})
        # the features themselves, card vs CPU, from clouds at pixel centres; and the share of range-image
        # pixels that differ when the clouds are projected as they are
        subset = real[: CMP_CLOUDS // 2] + gen[: CMP_CLOUDS // 2]
        flips = [float((engine._range_input(torch.as_tensor(c, device=DEVICE)).cpu()
                        - EvaluationEngine(device="cpu")._range_input(torch.as_tensor(c))).abs().amax(1).gt(1e-5)
                       .float().mean()) for c in subset]
        agree["range input pixels differing, clouds as they are (reported)"] = {"share_max": max(flips), "ok": True}
        subset = [to_pixel_centres(c) for c in subset]
        feats = {dev: EvaluationEngine(rangenet_apply=a, pointnet_apply=b, device=dev).extract_features(subset, dev)
                 for dev, (a, b) in extract.items()}
        for k, dims in (("rangenet", 4096), ("pointnet", 1808), ("bev_hist", None)):
            check(dims is None or feats[DEVICE][k].shape == (len(subset), dims), f"{k} features {feats[DEVICE][k].shape}")
            agrees_l2(agree, f"{k} features", feats[DEVICE][k], feats["cpu"][k], EVAL_RTOL["features"])

        # evaluate(): cd and mmd on 8 aligned pairs at full size, emd on them resampled, jsd and frid on all
        folder = tmp / "pretrained" / "nuscenes" / "rangenet"
        folder.mkdir(parents=True)
        backbone, decoder = to_rangenet_folder(rangenet.state_dict())
        torch.save(backbone, folder / "backbone")
        torch.save(decoder, folder / "segmentation_decoder")
        root = str(tmp / "pretrained")
        pairs = real[:EVAL_PAIRS], gen[:EVAL_PAIRS]
        emd_pairs = tuple([resample(c, EMD_POINTS, rnd) for c in p] for p in pairs)
        kw = {"verbose": False, "device": DEVICE}
        card = timed("evaluate_cd_mmd", lambda: evaluate(*pairs, ["cd", "mmd"], **kw))
        card |= timed("evaluate_emd", lambda: evaluate(*emd_pairs, ["emd"], **kw))
        card |= timed("evaluate_jsd_frid", lambda: evaluate(real, gen, ["jsd", "frid"], pretrained_root=root, **kw))
        metrics.update(card)
        # the same on the CPU: cd / mmd on the pairs resampled to CMP_POINTS (on both devices), emd and jsd as
        # they are, frid from the card's descriptors in float64 and the descriptors on the subset
        cmp_pairs = tuple([resample(c, CMP_POINTS, rnd) for c in p] for p in pairs)
        on = {dev: evaluate(*cmp_pairs, ["cd", "mmd"], verbose=False, device=dev) for dev in (DEVICE, "cpu")}
        for k in ("cd", "mmd"):
            agrees(agree, f"{k} ({CMP_POINTS} points)", on[DEVICE][k], on["cpu"][k], EVAL_RTOL[k])
        cpu = timed("cpu_emd_jsd", lambda: evaluate(*emd_pairs, ["emd"], verbose=False, device="cpu")
                    | evaluate(real, gen, ["jsd"], verbose=False, device="cpu"))
        for k in ("emd", "jsd"):
            agrees(agree, k, card[k], cpu[k], EVAL_RTOL[k])
        descs = [eval_suite._range_descriptors(c, "32", root, device=DEVICE) for c in (real, gen)]
        agrees(agree, "frid", card["frid"], compute_frechet_distance(*[d.cpu() for d in descs], device="cpu"),
                     EVAL_RTOL["frechet"])
        sub = {dev: eval_suite._range_descriptors(subset, "32", root, device=dev).cpu().numpy() for dev in extract}
        agrees_l2(agree, "frid descriptors", sub[DEVICE], sub["cpu"], EVAL_RTOL["features"])

    # TCD of each scene's 8 frames, as evaluate_temporal subsamples them; card vs CPU on scene 0 resampled
    cli_rng = np.random.default_rng(0)
    tcd = timed("tcd", lambda: [sequence_tcd([c if len(c) <= TCD_MAX_POINTS else
                                               c[cli_rng.choice(len(c), TCD_MAX_POINTS, replace=False)] for c in s],
                                              device=DEVICE) for s in scenes])
    metrics["tcd"] = {f"split_{k}": float(np.mean([v for t in tcd for v in t[k]])) for k in tcd[0]}
    seq = [resample(c, CMP_POINTS, rnd) for c in scenes[0]]
    on = {dev: sequence_tcd(seq, device=dev) for dev in (DEVICE, "cpu")}
    worst = max(abs(a - b) / abs(b) for k in on["cpu"] for a, b in zip(on[DEVICE][k], on["cpu"][k]))
    agree[f"tcd ({CMP_POINTS} points)"] = {"pairs": sum(map(len, on["cpu"].values())), "worst_rel_err": worst,
                                           "tol": EVAL_RTOL["tcd"], "ok": worst <= EVAL_RTOL["tcd"]}

    # ICP recovers a rigid motion of a rollout frame
    src = torch.as_tensor(scenes[0][0], device=DEVICE)
    yaw = math.radians(ICP_YAW_DEG)
    R = torch.tensor([[math.cos(yaw), -math.sin(yaw), 0.0], [math.sin(yaw), math.cos(yaw), 0.0], [0.0, 0.0, 1.0]],
                     device=DEVICE)
    shift = torch.tensor(ICP_SHIFT, device=DEVICE)
    R_est, t_est = timed("icp", lambda: icp_point_to_point(src, src @ R.T + shift))
    icp = {"points": len(src), "t_est": t_est.tolist(), "t_err_m": float((t_est - shift).abs().max()),
           "R_err": float((R_est - R).abs().max()), "tol_m": ICP_TOL_M}
    check(icp["t_err_m"] <= ICP_TOL_M, f"ICP: translation off by {icp['t_err_m']:.3g} m > {ICP_TOL_M}")

    # device times (CUDA events)
    cloud = torch.as_tensor(real[0], device=DEVICE)
    pts = torch.as_tensor(engine._subsample(real[0]), device=DEVICE)[None]
    img = engine._range_input(cloud)
    x, y = (torch.as_tensor(resample(c, CHAMFER_POINTS, rnd), device=DEVICE)[None] for c in (real[0], gen[0]))
    e1, e2 = (torch.as_tensor(resample(c, EMD_TIMED_POINTS, rnd), device=DEVICE)[None] for c in (real[0], gen[0]))
    lo, span = torch.minimum(e1.amin(1), e2.amin(1)), torch.maximum(e1.amax(1), e2.amax(1))
    e1, e2 = ((e - lo) / (span - lo).max() for e in (e1, e2))  # EMD's convention: the unit cube
    with torch.inference_mode():
        times = {"rangenet53_features_ms_per_cloud": time_ms(lambda: extract[DEVICE][0](img), iters=10),
                 "pointnet_features_ms_per_cloud": time_ms(lambda: extract[DEVICE][1](pts)),
                 "bev_histogram_ms_per_cloud": time_ms(lambda: point_cloud_to_histogram(cloud)),
                 f"chamfer_ms_{CHAMFER_POINTS}x{CHAMFER_POINTS}": time_ms(lambda: chamfer_metric(x, y), iters=3,
                                                                          warmup=1),
                 f"emd_ms_{EMD_TIMED_POINTS}": time_ms(lambda: emd_metric(e1, e2), iters=1, warmup=0)}
    f1, f2 = (torch.as_tensor(a, device=DEVICE) for a in
              np.random.RandomState(EVAL_SEED).standard_normal((2, *FEATURE_SET)).astype(np.float32))
    f2 = f2 * 1.1 + 0.1
    fd = timed(f"frechet_{FEATURE_SET[0]}x{FEATURE_SET[1]}", lambda: compute_frechet_distance(f1, f2, device=DEVICE))
    mmd = timed(f"squared_mmd_{FEATURE_SET[0]}x{FEATURE_SET[1]}", lambda: compute_squared_mmd(f1, f2, device=DEVICE))
    check(np.isfinite(fd) and fd > 0 and np.isfinite(mmd), f"Fréchet / MMD of the timing set: {fd}, {mmd}")
    launches = {k: c.n for k, c in counters.items()}
    failed = {k: v for k, v in agree.items() if not v["ok"]}
    check(not failed, f"evaluate card vs CPU: {failed}")
    check(all(n == 0 for n in launches.values()), f"evaluate: a kernel of the port launched: {launches}")
    for k, v in metrics.items():
        check(all(np.isfinite(list(v.values()) if isinstance(v, dict) else [v])), f"evaluate: {k} is {v}")
    seconds["phase"] = time.perf_counter() - t_phase
    emit({"phase": "evaluate", "card": smi, "clouds": {"real": len(real), "gen": len(gen), "points_min": min(sizes),
                                                        "points_max": max(sizes), "points_mean": float(np.mean(sizes))},
          "extractors": "RangeNet-53 (32x1024, 4096 features) and PointNet (k=16, 2048 points), seeded weights",
          "metrics": metrics, "card_vs_cpu": agree, "icp": icp, "device_ms": times, "seconds": seconds,
          "frechet_timing_set": fd, "squared_mmd_timing_set": mmd, "launches": launches,
          "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9})
    torch.cuda.empty_cache()


# ------------------------------------------------------------------ phase 11
# every other image-generation config of the registry ("zoo")

ZOO = ("nuscenes-box-layout", "nuscenes-box-layout-v5", "nuscenes-auto-reg", "kitti-360", "nuscenes-hdit-uncond")
ZOO_REQUEST = ("dpmpp_2m", 15)
V0_OACA_PER_FORWARD = 6  # ds4: 2 down + mid + 3 up
REPAINT = dict(num_steps=10, num_resample_steps=2, jump_length=2)  # 40 denoiser calls
DISCRETE_STEPS = 50


def kernel_modules(model) -> dict:
    """Kernel launches per denoiser call, from the modules the forward
    holds: one OACA per ``ObjectAwareCrossAttention``, one attention per
    EfficientUNet or GLIDE attention block, one GroupNorm per norm module."""
    from lidarcrafter_tpu_torch.models.layout_unet import GLIDEAttentionBlock, ObjectAwareCrossAttention
    from lidarcrafter_tpu_torch.models.ops import FusedGN, MFSelfAttention2d, SelfAttention2d

    def count(*cls):
        return sum(isinstance(m, cls) for m in model.modules())

    return {"oaca": count(ObjectAwareCrossAttention),
            "attention": count(SelfAttention2d, MFSelfAttention2d, GLIDEAttentionBlock), "groupnorm": count(FusedGN)}


def zoo_generator(cfg_name: str, dtype, cfg=None):
    """The config's generator (``CondFrameGenerator`` or
    ``UncondFrameGenerator``) on the card, seeded random weights, and a
    request function ``(steps, mode, seed) -> (sample, post)`` at B=8; the
    v5 stack is served from a batch built here, as a caller would."""
    import torch

    from lidarcrafter_tpu_torch.configs import get_config
    from lidarcrafter_tpu_torch.generate import UncondFrameGenerator
    from lidarcrafter_tpu_torch.generate_cond import CondFrameGenerator

    cfg = cfg or get_config(cfg_name)
    if cfg.condition_model is None:
        gen = UncondFrameGenerator(cfg, DEVICE, 0, dtype)
        return gen, gen.model, lambda steps, mode, seed: gen.generate(BATCH, steps, mode=mode, seed=seed)
    gen = CondFrameGenerator(cfg, DEVICE, 0, dtype)
    batch = None
    if cfg.condition_model.architecture == "layout_encoder_v5":
        batch = condition_batch(cfg, BATCH, torch.Generator(device=DEVICE).manual_seed(5), DEVICE)
    return gen, gen.models["model"], lambda steps, mode, seed: gen.generate(BATCH, steps, mode=mode, seed=seed,
                                                                           batch=batch)


def zoo_request(what: str, run, warmup, per_call: dict, calls: int, smi: str, phase: str = "zoo",
                **extra) -> tuple[dict, tuple]:
    """``run()`` after ``warmup()``, the launch counters set to 0 just
    before and read just after; each kernel must have launched
    ``per_call[kernel]`` times in each of the request's ``calls`` denoiser
    calls.  Emits the line; returns the counts and ``run``'s (sample,
    post)."""
    import torch

    warmup()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters = reset_counters()
    t0 = time.perf_counter()
    sample, post = run()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k: c.n for k, c in counters.items()}
    for k, n in launches.items():
        check(n == per_call.get(k, 0) * calls, f"{what}: {k} launches {n} != {per_call.get(k, 0)} x {calls}")
    check(bool(torch.isfinite(sample).all()) and bool(torch.isfinite(post["xyz"]).all()), f"{what}: not finite")
    check(float(sample.std()) > 1e-3, f"{what}: sample is constant")
    emit({"phase": phase, "what": what, "card": smi, "batch": BATCH, "denoiser_calls": calls, "seconds": seconds,
          "frames_per_s": BATCH / seconds, "ms_per_call": seconds * 1e3 / calls, "launches": launches,
          "per_call": per_call, "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
          "sample_std": float(sample.std()), **extra})
    return {k: n for k, n in launches.items() if n}, (sample, post)


def zoo_call(gen, cfg):
    """One denoiser call (x̂_0 at t = 0.5, B=8) of a zoo generator."""
    import torch

    H, W = cfg.data.resolution
    x = torch.randn(BATCH, H, W, 2, device=DEVICE)
    t = torch.full((BATCH,), 0.5, device=DEVICE)
    if cfg.condition_model is None:
        return lambda: gen.engine.predict_x_0(x, t)
    with torch.inference_mode():
        cond = gen.engine.get_network_condition(
            condition_batch(cfg, BATCH, torch.Generator(device=DEVICE).manual_seed(6), DEVICE))
    return lambda: gen.engine.predict_x_0(x, t, cond)


def phase_zoo(smi: str) -> dict:
    """Phase 11: the v0 stack, v5, the 12-channel auto-reg stack, kitti-360
    and HDiT at full width: card-vs-CPU forwards, one B=8 DPM++(2M)@15
    request each in float32 and in bfloat16 through the entry points with
    exact launch counts, a profile of a v0 and an HDiT call, then one
    RePaint and one ``DiscreteDiffusion`` request on the uncond stack.
    Returns the launch counts by path."""
    import torch

    from lidarcrafter_tpu_torch.configs import get_config
    from lidarcrafter_tpu_torch.diffusion import schedules

    by_path = {}
    for name in ZOO:
        t0 = time.perf_counter()
        if get_config(name).condition_model is None:
            phase_unet_forward_parity(name)
        else:
            phase_forward_parity(name)
        emit({"phase": "zoo", "what": f"{name} forward parity", "seconds": time.perf_counter() - t0})
        for dname, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            gen, model, request = zoo_generator(name, dtype)
            per_call = kernel_modules(model)
            if name == "nuscenes-box-layout":
                check(per_call["oaca"] == V0_OACA_PER_FORWARD, f"v0: {per_call['oaca']} OACA blocks")
                heads = {(m.num_heads, m.qkv_projector.in_features // m.num_heads) for m in model.modules()
                         if hasattr(m, "qkv_projector")}
                check(heads == {(8, 64)}, f"v0 OACA heads x head dim {heads}, expected 8 x 64")
            if name == "nuscenes-hdit-uncond":
                check(not any(per_call.values()), f"HDiT holds kernel modules {per_call}")
            mode, steps = ZOO_REQUEST
            by_path[f"zoo {name} {dname}"], _ = zoo_request(
                f"{name} {dname} {mode}@{steps}", lambda: request(steps, mode, 1), lambda: request(2, mode, 99),
                per_call, steps, smi, config=name, dtype=dname)
            if dtype == torch.float32 and name in ("nuscenes-box-layout", "nuscenes-hdit-uncond"):
                expect = {"groupnorm kernel": per_call["groupnorm"], "oaca kernel": per_call["oaca"],
                          "attention kernel": per_call["attention"]}
                phase_profile(f"one denoiser call ({name}, predict_x_0), B=8, {dname}", zoo_call(gen, gen.cfg),
                              smi, expect=expect)
            del gen, model, request
            torch.cuda.empty_cache()

    # RePaint and DiscreteDiffusion on the uncond stack (float32)
    cfg = get_config("nuscenes-unet-uncond")
    gen, model, request = zoo_generator("nuscenes-unet-uncond", torch.float32, cfg)
    per_call = kernel_modules(model)
    known, _ = request(ZOO_REQUEST[1], ZOO_REQUEST[0], 3)
    known = known.clamp(-1, 1)
    mask = torch.zeros_like(known)
    mask[:, ::2] = 1  # every other beam known: complete the rest
    calls = REPAINT["num_steps"] * REPAINT["num_resample_steps"] * REPAINT["jump_length"]
    by_path["zoo repaint nuscenes-unet-uncond float32"], (filled, _) = zoo_request(
        "repaint nuscenes-unet-uncond float32", lambda: gen.inpaint(known, mask, seed=1, **REPAINT),
        lambda: gen.inpaint(known, mask, 1, seed=99), per_call, calls, smi,
        config="nuscenes-unet-uncond", dtype="float32", **REPAINT)
    # the last paste is the known region noised to t = 0: known·α(0) + σ(0)·z
    alpha0, sigma0 = schedules.log_snr_to_alpha_sigma(gen.engine.log_snr(torch.zeros(1)))
    held_tol = float(1 - alpha0) + 6 * float(sigma0)
    held = float((filled - known)[mask > 0].abs().max())
    check(held <= held_tol, f"repaint: known region off by {held} > {held_tol}")
    emit({"phase": "zoo", "what": "repaint known region", "max_abs_dev": held, "tol": held_tol,
          "filled_std": float(filled[mask == 0].std())})
    del gen, model, request
    cfg = get_config("nuscenes-unet-uncond")
    cfg.diffusion.timestep_type = "discrete"
    cfg.diffusion.num_training_steps = 1000  # the registry leaves it None; the engine needs its table length
    gen, model, request = zoo_generator("nuscenes-unet-uncond", torch.float32, cfg)
    check(type(gen.engine).__name__ == "DiscreteDiffusion", f"discrete engine: {type(gen.engine).__name__}")
    by_path["zoo discrete nuscenes-unet-uncond float32"], _ = zoo_request(
        f"discrete nuscenes-unet-uncond float32 ddpm@{DISCRETE_STEPS}", lambda: request(DISCRETE_STEPS, "ddpm", 1),
        lambda: request(2, "ddpm", 99), per_call, DISCRETE_STEPS, smi, config="nuscenes-unet-uncond",
        dtype="float32", num_training_steps=gen.engine.num_training_steps)
    del gen, model, request
    torch.cuda.empty_cache()
    return by_path


# ----------------------------------------------------------------- phase 12


# one registry config of each architecture pair that the JAX route ingests
# (the largest first: its conversion overlaps the others' writing)
INGEST = ("nuscenes-layout", "nuscenes-box-layout", "nuscenes-hdit-uncond", "nuscenes-box-layout-v6",
          "nuscenes-unet-uncond", "meanflow-nusc", "nuscenes-object")
V0_GN_PER_FORWARD = 67
INGEST_PER_CALL = {  # kernel launches in one denoiser call of each
    "nuscenes-box-layout-v6": {"oaca": OACA_PER_FORWARD, "groupnorm": GN_PER_FORWARD},
    "nuscenes-box-layout": {"oaca": V0_OACA_PER_FORWARD, "groupnorm": V0_GN_PER_FORWARD},
    "nuscenes-unet-uncond": {"attention": ATTN_PER_UNET, "groupnorm": GN_PER_UNET},
    "meanflow-nusc": {"attention": ATTN_PER_UNET, "groupnorm": GN_PER_UNET},
    "nuscenes-hdit-uncond": {},
    "nuscenes-layout": {"groupnorm": GN_PER_UNET1D},
    "nuscenes-object": {},
}
INGEST_PARITY_BATCH = 1  # images a card-vs-CPU denoiser call of an image config
CLIP_DIMS = dict(vocab_size=49408, context_length=77, width=512, heads=8, layers=12, embed_dim=512)  # ViT-B/32
CLIP_RTOL = 1e-4
# a synthetic BPE merges table (CLIP's real one is not in the repository)
CLIP_MERGES = ["#version: synthetic", "c a", "ca r</w>", "t r", "u c", "tr uc", "truc k</w>", "w i", "wi l",
               "wil l</w>", "s t", "st o", "sto p</w>", "b u", "bu s</w>"]
WORDS_MODE, WORDS_STEPS = "ddim", 50  # the layout request
STATES = ("Stop", "Go straight", "Turn left", "Turn right")


def ingest_modules(cfg, seed: int) -> dict:
    """The config's modules on the CPU with seeded weights (cond, model)."""
    from lidarcrafter_tpu_torch.utils.torch_ckpt import build_modules
    from lidarcrafter_tpu_torch.weights import init_random_

    mods = build_modules(cfg, "cpu")
    for i, k in enumerate(sorted(mods)):
        init_random_(mods[k], seed + i)
    return mods


def ingest_generator(name: str, cfg, ckpt: str):
    """The entry point a user serves ``name`` through, loading the port
    checkpoint ``ckpt`` on the card; returns (generator, modules)."""
    from lidarcrafter_tpu_torch.generate import UncondFrameGenerator
    from lidarcrafter_tpu_torch.generate_cond import CondFrameGenerator
    from lidarcrafter_tpu_torch.generate_flow import FlowFrameGenerator
    from lidarcrafter_tpu_torch.generate_layout import LayoutGenerator
    from lidarcrafter_tpu_torch.generate_object import ObjectGenerator

    arch = cfg.model.architecture
    if arch == "unet_1d":
        gen = LayoutGenerator(cfg, DEVICE, ckpt=ckpt)
    elif arch == "point_unet":
        gen = ObjectGenerator(cfg, DEVICE, ckpt=ckpt)
    elif arch == "mf_efficient_unet":
        gen = FlowFrameGenerator(cfg, DEVICE, ckpt=ckpt)  # the online weights
    elif cfg.condition_model is None:
        gen = UncondFrameGenerator(cfg, DEVICE, ckpt=ckpt)
    else:
        gen = CondFrameGenerator(cfg, DEVICE, ckpt=ckpt)
    return gen, getattr(gen, "models", None) or {"model": gen.model}


def ingest_call(cfg, mods: dict, device, seed: int):
    """One denoiser call of ``cfg``'s modules on ``device`` (the encoder,
    then the denoiser), on seeded inputs at the request shapes (image
    configs at ``INGEST_PARITY_BATCH``)."""
    import torch

    from lidarcrafter_tpu_torch.generate_layout import layout_request
    from lidarcrafter_tpu_torch.utils.synthetic import synthetic_object_boxes, synthetic_scene_graphs

    gen = torch.Generator().manual_seed(seed)
    arch = cfg.model.architecture
    with torch.inference_mode():
        if arch == "unet_1d":
            req = layout_request(synthetic_scene_graphs(LAYOUT_SCENES, LAYOUT_OBJECTS, seed=0), device)
            sg = req["scenegraph"]
            _, emb = mods["cond"](sg["objs"], sg["triples"], sg["text_feats"], sg["rel_feats"])
            N = emb.shape[0]
            x, t = torch.randn(N, 20, generator=gen), torch.linspace(-5.0, 5.0, N)
            cd = {"time_condition": t.to(device), "other_condition": {"preds": sg["triples"], "uc_b": emb}}
            return mods["model"](x.to(device), cd)
        if arch == "point_unet":
            boxes = {k: torch.as_tensor(v, device=device)
                     for k, v in synthetic_object_boxes(LAYOUT_SCENES, LAYOUT_OBJECTS, seed=0).items()}
            B = boxes["fg_class"].shape[0]
            x, t = torch.randn(B, cfg.data.num_samples, 4, generator=gen), torch.linspace(-5.0, 5.0, B)
            feat = mods["cond"](boxes)
            return mods["model"](x.to(device), {"time_condition": t.to(device), "other_condition": feat})
        B, (H, W) = INGEST_PARITY_BATCH, cfg.data.resolution
        x, t = torch.randn(B, H, W, 2, generator=gen).to(device), torch.linspace(-3.0, 5.0, B, device=device)
        if arch == "mf_efficient_unet":
            return mods["model"](x, torch.full((B,), 0.9, device=device), torch.full((B,), 0.2, device=device))
        if cfg.condition_model is None:
            return mods["model"](x, t)
        batch = {k: v.to(device) for k, v in condition_batch(cfg, B, gen).items()}
        return mods["model"](x, {"time_condition": t, "other_condition": mods["cond"](batch)})


def openai_clip_archive(sd: dict, path) -> None:
    """A TorchScript archive whose state dict holds ``sd`` under its names
    (OpenAI's ``ViT-B-32.pt`` is one), traced from a module tree built from
    the dotted names."""
    import torch
    from torch import nn

    class Archive(nn.Module):
        def forward(self, x):
            return x @ self.text_projection

    root = Archive()
    for name, value in sd.items():
        *mods, leaf = name.split(".")
        node = root
        for m in mods:
            if not hasattr(node, m):
                node.add_module(m, nn.Module())
            node = getattr(node, m)
        node.register_parameter(leaf, nn.Parameter(value.clone(), requires_grad=False))
    traced = torch.jit.trace(root, torch.zeros(1, sd["text_projection"].shape[0]))
    torch.jit.save(traced, str(path))


def scene_infos(num_scenes: int, n: int, seed: int) -> list:
    """Converter info dicts of ``num_scenes`` scenes of ``n`` kept boxes
    (within 40 m, a kept class, 100 points), with futures."""
    from lidarcrafter_tpu_torch.datasets.scene_graph import KEEP_NAMES

    rng = np.random.RandomState(seed)
    infos = []
    for _ in range(num_scenes):
        boxes = np.concatenate([rng.uniform(-40, 40, (n, 2)), rng.uniform(-2, 1, (n, 1)),
                                rng.uniform([3.5, 1.5, 1.5], [12.0, 3.0, 4.0], (n, 3)),
                                rng.uniform(-np.pi, np.pi, (n, 1))], axis=1)
        infos.append({
            "gt_boxes": boxes, "gt_names": rng.choice(KEEP_NAMES, n), "num_lidar_pts": np.full(n, 100),
            "gt_agent_fut_trajs": np.cumsum(rng.normal(0, 0.5, (n, 6, 2)), axis=1),
            "gt_agent_fut_masks": np.ones((n, 6)), "gt_agent_fut_states": rng.choice(STATES, n),
            "instance_inds": np.arange(n), "gt_ego_fut_trajs": np.cumsum(rng.normal(0, 0.5, (6, 2)), axis=0),
            "gt_ego_fut_masks": np.ones(6), "gt_ego_fut_state": "Go straight", "lidar_path": None,
        })
    return infos


def words_to_graphs(encode_fn, seed: int) -> dict:
    """``LAYOUT_SCENES`` synthetic scenes of ego + ``LAYOUT_OBJECTS``
    through the converter step, ``SceneGraphAssigner`` (train split: its
    edits) and ``collate_scene_graphs``, CLIP features from ``encode_fn``."""
    from lidarcrafter_tpu_torch.datasets import scene_graph as SG
    from lidarcrafter_tpu_torch.datasets.transforms import scale_boxes_3d

    assigner = SG.SceneGraphAssigner(split="train", text_encode_fn=encode_fn, rng=np.random.RandomState(seed))
    items = []
    for i, info in enumerate(scene_infos(LAYOUT_SCENES, LAYOUT_OBJECTS, seed)):
        sg = SG.build_scene_graph_info(info)["scene_graph"]
        check(sg["valid"] and len(sg["keep_box_names"]) == LAYOUT_OBJECTS + 1, "words to frames: a box was dropped")
        items.append(assigner.assign_item(i, {
            "scaled_gt_boxes": scale_boxes_3d(sg["keep_box"]), "gt_fut_trajs": sg["keep_agent_fut_trajs"],
            "gt_fut_masks": sg["keep_agent_fut_masks"], "gt_names": sg["keep_box_names"],
            "gt_fut_states": sg["keep_agent_fut_states"], "gt_box_relationships": sg["keep_box_relationships"]}))
    batch = SG.collate_scene_graphs(items, text_encode_fn=encode_fn)
    batch["edits"] = [it["manipulate"]["type"] for it in items]
    batch["words"] = [items[0]["decoder"]["words"]]  # the first scene's relationship words
    return batch


def layout_frame_batch(raw, graphs: dict, cfg, lidar_utils) -> dict:
    """A layout sample (N, 20) → the frame stack's condition batch, as the
    dataset builds one for ``layout_cond``: per scene, its nodes' boxes
    (clipped into the scaled boxes' range [-1, 1], since an untrained
    denoiser's x̂_0 is unbounded) unscaled to metres with the decoder's
    classes, rasterised into ``condition_mask`` with the ego, and its
    objects' scaled 3D and 2D boxes padded to ``layout_length``."""
    import torch

    from lidarcrafter_tpu_torch.datasets.transforms import scale_boxes_3d, unscale_boxes_3d
    from lidarcrafter_tpu_torch.ops.projection import convert_boxes_to_2d
    from lidarcrafter_tpu_torch.training.preprocess import preprocess_condition_mask

    dec = graphs["decoder"]
    raw = np.clip(raw.cpu().numpy(), -1.0, 1.0)
    H, W = cfg.data.resolution
    L = cfg.condition_model.params["layout_length"]
    scaled, boxes_2d, valid, masks = [], [], [], []
    for s in range(int(dec["obj_to_scene"].max()) + 1):
        idx = np.nonzero(dec["obj_to_scene"] == s)[0]
        check(dec["objs"][idx[0]] == 0, "words to frames: a scene's first node is not the ego")
        metric, _ = unscale_boxes_3d(raw[idx])  # zeroes the ego row
        gt = np.concatenate([metric, dec["objs"][idx, None].astype(np.float64)], axis=1)
        b2d, cmask, _ = convert_boxes_to_2d(torch.as_tensor(gt, dtype=torch.float32, device=DEVICE)[None],
                                            H=H, W=W, fov_up=cfg.data.fov_up, fov_down=cfg.data.fov_down)
        n = min(len(idx) - 1, L)
        row3, row2 = np.zeros((L, 9), np.float32), np.zeros((L, 4), np.float32)
        row3[:n] = scale_boxes_3d(gt)[1:n + 1]
        row2[:n] = b2d[0, 1:n + 1].cpu().numpy()
        scaled.append(row3)
        boxes_2d.append(row2)
        valid.append((np.arange(L) < n).astype(np.float32))
        masks.append(cmask)
    return {"scaled_gt_boxes": torch.as_tensor(np.stack(scaled), device=DEVICE),
            "gt_boxes_2d": torch.as_tensor(np.stack(boxes_2d), device=DEVICE),
            "is_valid_obj": torch.as_tensor(np.stack(valid), device=DEVICE),
            "concat_cond": preprocess_condition_mask({"condition_mask": torch.cat(masks)}, lidar_utils)}


class Conversions:
    """``python -m lidarcrafter_tpu_torch.convert_checkpoint`` processes on
    the CPU (no CUDA), each started as soon as its upstream checkpoint is
    written; :meth:`finish` waits for all of them and returns each config's
    port checkpoint and seconds (the process's wall time, and the CLI's
    own, by step).  Leaving the ``with`` block kills any still running."""

    def __init__(self, out_dir: Path):
        import os

        self.out_dir = out_dir
        self.env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
        self.procs = {}

    def start(self, name: str, pth: Path) -> None:
        out = self.out_dir / name
        cmd = [sys.executable, "-m", "lidarcrafter_tpu_torch.convert_checkpoint", "--torch-ckpt", str(pth),
               "-c", name, "-o", str(out)]
        self.procs[name] = (subprocess.Popen(cmd, cwd=REPO, env=self.env, stdout=subprocess.PIPE,
                                             stderr=subprocess.PIPE, text=True), time.perf_counter(), out)

    def finish(self) -> dict:
        done = {}
        for name, (proc, t0, out) in self.procs.items():
            stdout, stderr = proc.communicate(timeout=300)
            check(proc.returncode == 0, f"convert_checkpoint {name} exited {proc.returncode}: {stderr[-2000:]}")
            check("strict load into the config's modules: OK" in stdout, f"convert_checkpoint {name}: {stdout}")
            steps = stdout.split("seconds: ", 1)[1].splitlines()[0]
            done[name] = {"ckpt": str(out), "wall_seconds": time.perf_counter() - t0,
                          "cli_seconds": float(stdout.rsplit("(", 1)[1].split(" s)")[0]),
                          **{f"{k}_seconds": float(v) for k, v in (x.split() for x in steps.split(", "))}}
        return done

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        for proc, _, _ in self.procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def phase_ingest(smi: str) -> dict:
    """Phase 12: released-checkpoint ingestion and the CLIP text tower,
    words to frames.  Returns the launch counts by path."""
    import torch

    from lidarcrafter_tpu_torch.configs import get_config
    from lidarcrafter_tpu_torch.datasets.scene_graph import CLASSES, RELATIONSHIPS
    from lidarcrafter_tpu_torch.models.clip_text import CLIPTextEncoder, load_clip_text_encoder
    from lidarcrafter_tpu_torch.utils import torch_ckpt
    from lidarcrafter_tpu_torch.weights import init_random_

    t_phase = time.perf_counter()
    by_path = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        # (a) upstream-format engine checkpoints from seeded port modules, each converted by the CLI
        # as soon as it is written
        t0 = time.perf_counter()
        sources, paths = {}, {}
        with Conversions(tmp) as conversions:
            for i, name in enumerate(INGEST):
                cfg = get_config(name)
                sources[name] = ingest_modules(cfg, 40 + 2 * i)
                ckpt = torch_ckpt.to_upstream_checkpoint(cfg, sources[name])
                ckpt["weights"] = {k: v + 1.0 for k, v in ckpt["weights"].items()}  # online ≠ EMA
                paths[name] = tmp / f"{name}.pth"
                torch.save(ckpt, paths[name])
                del ckpt
                conversions.start(name, paths[name])
            write_s = time.perf_counter() - t0
            converted = conversions.finish()
        emit({"phase": "ingest", "what": "convert_checkpoint", "card": smi, "write_seconds": write_s,
              "written_and_converted_seconds": time.perf_counter() - t0,
              "per_config": {n: {k: v for k, v in c.items() if k != "ckpt"} for n, c in converted.items()}})
        for p in paths.values():
            p.unlink()

        # (b) each through its generator on the card: weights bit for bit, one call card vs CPU, launches
        gens = {}
        for name in INGEST:
            cfg = get_config(name)
            t0 = time.perf_counter()
            gen, mods = ingest_generator(name, cfg, converted[name]["ckpt"])
            load_s = time.perf_counter() - t0
            for k, m in sources[name].items():
                got = mods[k].state_dict()
                for n, v in m.state_dict().items():
                    check(torch.equal(got[n].cpu(), v), f"ingest {name}: {k}.{n} differs from its seeded source")
            counters = reset_counters()
            out = ingest_call(cfg, mods, DEVICE, seed=50)
            torch.cuda.synchronize()
            launches = {k: c.n for k, c in counters.items()}
            want_launches = {k: INGEST_PER_CALL[name].get(k, 0) for k in launches}
            check(launches == want_launches, f"ingest {name}: one call launched {launches}, expected {want_launches}")
            t0 = time.perf_counter()
            want = ingest_call(cfg, sources[name], "cpu", seed=50)
            cpu_s = time.perf_counter() - t0
            check_forward(f"ingest {name} converted checkpoint, one denoiser call float32", out.cpu(), want,
                          FORWARD_RTOL, load_seconds=load_s, cpu_seconds=cpu_s, launches=launches)
            if any(launches.values()):
                by_path[f"ingest {name} call"] = {k: n for k, n in launches.items() if n}
            if name in ("nuscenes-box-layout-v6", "nuscenes-layout"):
                gens[name] = gen
            del gen, mods, out, want
            torch.cuda.empty_cache()
        del sources

        # (c) the CLIP text tower at ViT-B/32 text width: a state dict and a TorchScript archive
        tower = init_random_(CLIPTextEncoder(**CLIP_DIMS), 60)
        sd = torch_ckpt.export(torch_ckpt.clip_text, tower.state_dict())
        sd["visual.proj"] = torch.randn(768, 512, generator=torch.Generator().manual_seed(61))  # skipped
        plain, archive, bpe = tmp / "clip_text.pt", tmp / "clip_script.pt", tmp / "bpe_synthetic.txt.gz"
        torch.save(sd, plain)
        openai_clip_archive(sd, archive)
        with gzip.open(bpe, "wt") as f:
            f.write("\n".join(CLIP_MERGES))
        vocab = list(CLASSES) + list(RELATIONSHIPS)
        feats, times = [], {}
        for label, path in (("state dict", plain), ("TorchScript archive", archive)):
            encode_fn, tokenizer, model = load_clip_text_encoder(path, bpe, device=DEVICE)
            for k, v in tower.state_dict().items():
                check(torch.equal(model.state_dict()[k].cpu(), v), f"clip {label}: {k} differs from its source")
            feats.append(encode_fn(vocab))
        check(torch.equal(feats[0], feats[1]), "clip: the archive's features differ from the state dict's")
        cpu_encode = load_clip_text_encoder(plain, bpe, device="cpu")[0]
        check_forward(f"clip text tower ({len(vocab)} class and relationship words) float32", feats[0].cpu(),
                      cpu_encode(vocab), CLIP_RTOL, dims=CLIP_DIMS)

        def timed(words, reps=5):
            out = []
            for _ in range(reps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                encode_fn(words)
                torch.cuda.synchronize()
                out.append((time.perf_counter() - t0) * 1e3)
            return float(np.median(out))

        encode_fn(vocab)
        times["vocabulary"] = {"words": len(vocab), "ms": timed(vocab)}

        # build_clip_cache on the card: obj-text against the CPU tower,
        # warm-cache over a small synthetic tree's val split into an empty cache
        from lidarcrafter_tpu_torch import build_clip_cache
        from lidarcrafter_tpu_torch.utils.synthetic import write_nuscenes_tree

        names = list(build_clip_cache.CLASS_NAMES)
        clip_args = ["--clip", str(archive), "--bpe", str(bpe)]
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            build_clip_cache.main(["obj-text", *clip_args, "--save_path", str(tmp / "obj_text_feat.pkl")])
        obj_text_s = time.perf_counter() - t0
        with open(tmp / "obj_text_feat.pkl", "rb") as f:
            table = pickle.load(f)
        check(list(table) == names and all(isinstance(v, np.ndarray) and v.shape == (1, CLIP_DIMS["embed_dim"])
                                           for v in table.values()), "build_clip_cache obj-text: the table")
        check_forward("build_clip_cache obj-text (9 class names) float32",
                      torch.as_tensor(np.concatenate([table[k] for k in names])), cpu_encode(names), CLIP_RTOL)
        tree = write_nuscenes_tree(tmp / "nusc", num_points=3000, seed=12)
        cache = tmp / "clip_cache"
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            build_clip_cache.main(["warm-cache", *clip_args, "--pkl", tree["pkl_path"], "--data_root",
                                   tree["data_root"], "--split", "val", "--set", f'data.clip_cache_dir="{cache}"'])
        warm_s = time.perf_counter() - t0
        cached = sorted((cache / "val").glob("CLIP_*.pkl"))
        check(len(cached) > 0, "build_clip_cache warm-cache wrote no CLIP files")
        with open(cached[0], "rb") as f:
            entry = pickle.load(f)
        check(np.asarray(entry["instance_feats"]).shape[1:] == (CLIP_DIMS["embed_dim"],)
              and bool(np.isfinite(np.asarray(entry["instance_feats"])).all()), "build_clip_cache warm-cache features")
        emit({"phase": "ingest", "check": "build_clip_cache", "card": smi, "obj_text_seconds": obj_text_s,
              "warm_cache_seconds": warm_s, "cached_samples": len(cached)})

        # (d) words to frames: scene graphs → CLIP → the converted layout stack → the converted v6 stack
        t0 = time.perf_counter()
        graphs = words_to_graphs(encode_fn, seed=70)
        graph_s = time.perf_counter() - t0
        dec = graphs["decoder"]
        words = [w for it in graphs.pop("words") for w in it]
        times["one scene's relationships"] = {"words": len(words), "ms": timed(words, 3)}
        emit({"phase": "ingest", "what": "clip", "card": smi, "dims": CLIP_DIMS, "ms_per_batch": times,
              "scene_graph_seconds": graph_s, "nodes": len(dec["objs"]), "triples": len(dec["tripltes"]),
              "edits": graphs.pop("edits")})

        layout, v6 = gens["nuscenes-layout"], gens["nuscenes-box-layout-v6"]
        layout.generate(graphs, 2, mode=WORDS_MODE, seed=99)  # warm-up
        torch.cuda.synchronize()
        counters = reset_counters()
        t0 = time.perf_counter()
        raw = layout.generate(graphs, WORDS_STEPS, mode=WORDS_MODE, seed=1)
        torch.cuda.synchronize()
        layout_s = time.perf_counter() - t0
        launches = {k: c.n for k, c in counters.items()}
        check(launches == with_zeros({"groupnorm": GN_PER_UNET1D * WORDS_STEPS}, launches),
              f"words to frames, layout: launches {launches}")
        check(bool(torch.isfinite(raw).all()) and float(raw.std()) > 1e-3, "words to frames: layout not finite")
        by_path[f"words-to-frames layout {WORDS_MODE}@{WORDS_STEPS}"] = {"groupnorm": launches["groupnorm"]}
        frame_batch = layout_frame_batch(raw, graphs, v6.cfg, v6.lidar_utils)
        mode, steps = ZOO_REQUEST
        v6.generate(2, 2, mode=mode, seed=99, batch={k: v[:2] for k, v in frame_batch.items()})  # warm-up
        torch.cuda.synchronize()
        counters = reset_counters()
        t0 = time.perf_counter()
        sample, post = v6.generate(LAYOUT_SCENES, steps, mode=mode, seed=1, batch=frame_batch)
        torch.cuda.synchronize()
        frame_s = time.perf_counter() - t0
        launches = {k: c.n for k, c in counters.items()}
        check(launches == with_zeros({"oaca": OACA_PER_FORWARD * steps, "groupnorm": GN_PER_FORWARD * steps},
                                     launches),
              f"words to frames, v6: launches {launches}")
        check(bool(torch.isfinite(sample).all()) and bool(torch.isfinite(post["xyz"]).all()),
              "words to frames: frames not finite")
        check(float(sample.std()) > 1e-3, "words to frames: frames are constant")
        by_path[f"words-to-frames nuscenes-box-layout-v6 {mode}@{steps}"] = {
            k: n for k, n in launches.items() if n}
        emit({"phase": "ingest", "what": "words to frames", "card": smi, "scenes": LAYOUT_SCENES,
              "layout_request": {"mode": WORDS_MODE, "steps": WORDS_STEPS, "seconds": layout_s,
                                 "groupnorm_launches": GN_PER_UNET1D * WORDS_STEPS},
              "frame_request": {"mode": mode, "steps": steps, "seconds": frame_s, "launches": launches,
                                "shape": list(sample.shape), "sample_std": float(sample.std())},
              "valid_objects": float(frame_batch["is_valid_obj"].sum())})
        del gens, layout, v6
        torch.cuda.empty_cache()
    emit({"phase": "ingest", "what": "phase seconds", "seconds": time.perf_counter() - t_phase})
    return by_path


# ------------------------------------------------------------------ phase 13

DATA_POINTS = 35000  # a nuScenes LIDAR_TOP sweep
DATA_STEPS, DATA_WORKERS, DATA_PREVIEW_STEPS = 10, 4, 10  # steps from files, loader threads, the preview's DDIM steps
DATA_PROFILE = (4, 6)  # the trainer's profiling window; steps/s read over steps 6-10, after it
DATA_LOADER_BATCHES = 8  # batches timed at 0 and 4 workers
DATA_BRANCHES = {  # config → launches a train step, 2 steps each from files
    "nuscenes-unet-uncond": {"attention": ATTN_PER_UNET, "groupnorm": GN_PER_UNET},
    "nuscenes-layout": {"groupnorm": GN_PER_UNET1D},
    "nuscenes-object": {},
}


def _train_main(args: list) -> tuple[list, str, dict]:
    """``train.main(args)`` in this process, its printed records captured
    (and echoed to stderr); returns the step records, the output and the
    launch counts of the run (counters set to 0 just before it)."""
    import ast
    import contextlib
    import io

    from lidarcrafter_tpu_torch import train as train_cli

    out = io.StringIO()
    counters = reset_counters()
    with contextlib.redirect_stdout(out):
        train_cli.main(args)
    launches = {k: c.n for k, c in counters.items()}
    text = out.getvalue()
    print(text[-2000:], file=sys.stderr, flush=True)
    records = [ast.literal_eval(line) for line in text.splitlines() if line.startswith("{")]
    return records, text, launches


def _wall_steps_per_s(events: list, first: int, last: int) -> float:
    """Steps a second between the ``first`` and ``last`` step records of a
    tracker log (each written after the host read the step's loss)."""
    t = {e["step"]: e["wall_time"] for e in events}
    return (last - first) / (t[last] - t[first])


def _cli_losses(cmds: list, env: dict) -> list:
    """The losses each ``train`` CLI command prints, the commands run at
    once."""
    import ast

    procs = [subprocess.Popen(cmd, env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for cmd in cmds]
    out = []
    for cmd, proc in zip(cmds, procs):
        stdout, stderr = proc.communicate(timeout=600)
        check(proc.returncode == 0, f"{' '.join(cmd[:6])}...: exit {proc.returncode}\n{stdout[-2000:]}"
                                    f"\n{stderr[-3000:]}")
        out.append([ast.literal_eval(line)["loss"] for line in stdout.splitlines() if line.startswith("{'step'")])
    return out


SAVE_COND_BATCHES, SAVE_COND_STEPS = 2, 2  # sample_and_save_cond --synthetic: batches of 8, DDIM steps


def phase_data(smi: str) -> dict:
    """Phase 13 ("data"): training from nuScenes-format files.  Writes a
    synthetic tree (2 scenes x 4 frames a split, 35,000-point clouds at
    uniform random angles and depths); checks the dataset's host projection
    against the card's projection of the same clouds (no pixel's winner may
    differ; depth to one float32 ulp) and times it; times the loader at 0
    and ``DATA_WORKERS`` threads; trains ``nuscenes-auto-reg-v2`` at full
    width through ``train.main`` (B=2, bf16 AMP, ``DATA_WORKERS`` loader
    threads, ``JsonlTracker``, the profiling window, one DDIM@10 preview on
    the EMA weights at the last step) with exact launches, finite losses, no
    ``preview_error`` and PNGs that decode, against the same run on the
    synthetic source; trains the uncond, layout and object branches 2 steps
    each from files; runs ``sample_and_save_cond --synthetic`` (two
    batches of 8 at full width, the last wrapping, exact launches, the dumps
    read back as points); and runs ``torchrun --nproc-per-node 1`` (NCCL) for 2
    steps of ``nuscenes-box-layout-v6``, whose losses must equal those of
    the same 2 steps without a process group, bit for bit."""
    import json as _json

    import numpy as np
    import torch

    from lidarcrafter_tpu_torch import train as train_cli
    from lidarcrafter_tpu_torch.configs import get_config
    from lidarcrafter_tpu_torch.datasets import make_dataset
    from lidarcrafter_tpu_torch.ops.projection import points_to_range_image
    from lidarcrafter_tpu_torch.training.tracker import read_png
    from lidarcrafter_tpu_torch.utils.synthetic import point_config_at_tree, write_nuscenes_tree

    t_phase = time.perf_counter()
    by_path = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        tree = write_nuscenes_tree(Path(tmp) / "nusc", num_points=DATA_POINTS, seed=13)
        write_s = time.perf_counter() - t0
        files = ["--set", f'data.data_root="{tree["data_root"]}"', "--set", f'data.pkl_path="{tree["pkl_path"]}"',
                 "--set", f'data.clip_cache_dir="{tree["clip_cache_dir"]}"']

        # (1) the dataset's host projection against the card's
        cfg = point_config_at_tree(get_config("nuscenes-auto-reg-v2"), tree)
        ds = make_dataset(cfg)
        threads = torch.get_num_threads()
        torch.set_num_threads(1)  # as a loader thread runs it
        flips, depth_err, host_ms = 0, 0.0, []
        for i in range(3):
            points = ds._load_points(ds.data[i])
            t0 = time.perf_counter()
            host = ds.project(points)
            host_ms.append((time.perf_counter() - t0) * 1e3)
            card = points_to_range_image(torch.from_numpy(points).to(DEVICE), min_depth=cfg.data.min_depth,
                                         max_depth=cfg.data.max_depth)
            card = (card * card[..., 5:6]).cpu().numpy()
            flips += int(np.any(card[..., :3] != host["xyz"], axis=-1).sum())
            depth_err = max(depth_err, float(np.abs(card[..., 4:5] - host["depth"]).max()))
        torch.set_num_threads(threads)
        cloud = torch.from_numpy(ds._load_points(ds.data[0])).to(DEVICE)
        card_ms = time_ms(lambda: points_to_range_image(cloud))
        check(flips == 0, f"data: {flips} pixels whose winner differs between the host and the card")
        check(depth_err <= 2.0**-23 * cfg.data.max_depth, f"data: depth differs by {depth_err}")

        # the loader alone, at 0 and DATA_WORKERS threads
        loader = {}
        for workers in (0, DATA_WORKERS):
            stream = train_cli.file_batches(cfg, 0, workers)
            next(stream)
            t0 = time.perf_counter()
            for _ in range(DATA_LOADER_BATCHES):
                next(stream)
            loader[workers] = DATA_LOADER_BATCHES / (time.perf_counter() - t0)
            stream.close()
        emit({"phase": "data", "check": "dataset", "card": smi, "tree_write_s": write_s, "points": DATA_POINTS,
              "pixels_with_other_winner": flips, "depth_max_abs_err": depth_err,
              "host_projection_ms_per_cloud": host_ms, "card_projection_ms": card_ms,
              "loader_batches_per_s": {str(k): v for k, v in loader.items()}, "batch": cfg.training.batch_size_train})

        # (2) nuscenes-auto-reg-v2 at full width from files, and on the synthetic source
        runs = {}
        for source in ("synthetic", "files"):  # the synthetic run first: it takes the process's warm-up
            log_dir = Path(tmp) / f"ar_{source}"
            args = ["-c", "nuscenes-auto-reg-v2", "--num-steps", str(DATA_STEPS), "--workers", str(DATA_WORKERS),
                    "--log-every", "1", "--checkpoint-every", "0", "--log-dir", str(log_dir / "log"),
                    "--output-dir", str(log_dir)]
            if source == "files":
                args += files + ["--set", f"training.steps_save_image={DATA_STEPS}",
                                 "--set", f"diffusion.num_sampling_steps={DATA_PREVIEW_STEPS}",
                                 "--profile-dir", str(log_dir / "prof")]
            else:
                args += ["--synthetic-data", "--set", "training.steps_save_image=0"]
            records, text, launches = _train_main(args)
            events = [_json.loads(line) for line in (log_dir / "log" / "events.jsonl").read_text().splitlines()]
            losses = [e["loss"] for e in events]
            check(len(losses) == DATA_STEPS and all(math.isfinite(v) for v in losses),
                  f"data: {source} losses {losses}")
            check("preview_error" not in text, f"data: a preview failed: {text[-500:]}")
            runs[source] = {"losses": losses, "launches": launches,
                            "steps_per_s_1_3": _wall_steps_per_s(events, 1, 3),
                            "steps_per_s_6_10": _wall_steps_per_s(events, 6, DATA_STEPS)}
            if source == "files":
                calls = DATA_STEPS + DATA_PREVIEW_STEPS  # train forwards + the preview's denoiser calls
                for k, n in (("oaca", OACA_PER_FORWARD), ("groupnorm", GN_PER_FORWARD), ("attention", 0)):
                    check(launches[k] == n * calls, f"data: auto-reg-v2 {k} launches {launches[k]} != {n} x {calls}")
                pngs = sorted((log_dir / "log" / "images" / f"{DATA_STEPS:010d}").glob("*.png"))
                tags = {p.stem for p in pngs}
                check({"sample_depth", "sample_bev", "sample_reflectance"} <= tags, f"data: preview PNGs {tags}")
                shapes = {p.stem: list(read_png(p).shape) for p in pngs}
                trace = _json.loads((log_dir / "prof" / "train_steps.pt.trace.json").read_text())
                kernels = [e for e in trace["traceEvents"] if e.get("cat") == "kernel"]
                span = [e for e in trace["traceEvents"] if e.get("ph") == "X" and e.get("cat") in ("kernel",
                                                                                                  "cpu_op")]
                wall_us = max(e["ts"] + e["dur"] for e in span) - min(e["ts"] for e in span)
                busy_us = sum(e["dur"] for e in kernels)
                steps = DATA_PROFILE[1] - DATA_PROFILE[0] + 1
                step_ms = 1e3 / runs[source]["steps_per_s_6_10"]
                runs[source].update(png_shapes=shapes, profile_window_steps=list(DATA_PROFILE),
                                    window_device_busy_ms=busy_us / 1e3, window_wall_ms=wall_us / 1e3,
                                    window_idle_share=max(0.0, 1 - busy_us / wall_us), window_kernels=len(kernels),
                                    # the window's device time a step against an untraced step's wall time
                                    idle_share=max(0.0, 1 - busy_us / 1e3 / steps / step_ms))
        emit({"phase": "data", "check": "train from files", "config": "nuscenes-auto-reg-v2", "card": smi,
              "batch": 2, "dtype": "bfloat16 AMP", "workers": DATA_WORKERS, "steps": DATA_STEPS,
              "preview": f"ddim@{DATA_PREVIEW_STEPS} on the EMA weights", **runs})
        by_path[f"data nuscenes-auto-reg-v2 files ({DATA_STEPS} steps + preview)"] = {
            k: n for k, n in runs["files"]["launches"].items() if n}

        # (3) the other branches from files
        for name, per_step in DATA_BRANCHES.items():
            data = files + (["--set", f'data.pkl_path="{tree["db_path"]}"'] if name == "nuscenes-object" else [])
            records, text, launches = _train_main(["-c", name, "--num-steps", "2", "--workers", str(DATA_WORKERS),
                                                   "--log-every", "1", "--checkpoint-every", "0", *data,
                                                   "--output-dir", str(Path(tmp) / name)])
            losses = [r["loss"] for r in records if "loss" in r]
            check(len(losses) == 2 and all(math.isfinite(v) for v in losses), f"data: {name} losses {losses}")
            for k, n in launches.items():
                check(n == 2 * per_step.get(k, 0), f"data: {name} {k} launches {n} != 2 x {per_step.get(k, 0)}")
            emit({"phase": "data", "check": "branch from files", "config": name, "card": smi, "losses": losses,
                  "launches": launches})
            if any(launches.values()):
                by_path[f"data {name} files (2 steps)"] = {k: n for k, n in launches.items() if n}
            torch.cuda.empty_cache()

        # (3b) sample_and_save_cond --synthetic: zero-condition batches of
        # nuscenes-auto-reg-v2 at full width, dumps read back as points
        from lidarcrafter_tpu_torch import sample_and_save_cond
        from lidarcrafter_tpu_torch.utils.sample_io import load_pth_points

        out_dir = Path(tmp) / "sample_and_save_cond"
        n_frames = SAVE_COND_BATCHES * BATCH - 1  # the last batch wraps
        counters = reset_counters()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(io.StringIO()):
            sample_and_save_cond.main(["-c", "nuscenes-auto-reg-v2", "--synthetic", str(n_frames), "-b", str(BATCH),
                                       "--num-steps", str(SAVE_COND_STEPS), "--mode", "ddim", "-o", str(out_dir)])
        seconds = time.perf_counter() - t0
        launches = {k: c.n for k, c in counters.items()}
        check_launches("sample_and_save_cond", launches, PER_CALL["nuscenes-auto-reg-v2"],
                       SAVE_COND_BATCHES * SAVE_COND_STEPS)
        dumps = sorted(out_dir.glob("samples_*.pth"))
        check([d.name for d in dumps] == [f"samples_{i:07d}_synthetic{i}.pth" for i in range(n_frames)],
              f"sample_and_save_cond: {len(dumps)} dumps")
        pts = load_pth_points(dumps[-1])
        check(pts.ndim == 2 and pts.shape[1] == 4 and bool(np.isfinite(pts).all()), "sample_and_save_cond: points")
        emit({"phase": "data", "check": "sample_and_save_cond --synthetic", "config": "nuscenes-auto-reg-v2",
              "card": smi, "frames": n_frames, "batch": BATCH, "ddim_steps": SAVE_COND_STEPS, "seconds": seconds,
              "frames_per_s": n_frames / seconds, "points_in_last": len(pts), "launches": launches})
        by_path["sample_and_save_cond nuscenes-auto-reg-v2"] = {k: n for k, n in launches.items() if n}
        torch.cuda.empty_cache()

        # (4) torchrun with NCCL, one process, against no process group
        args = ["-c", "nuscenes-box-layout-v6", "--num-steps", "2", "--workers", "2", "--log-every", "1",
                "--checkpoint-every", "0", "--deterministic", *files]
        env = dict(os.environ, PYTHONPATH=str(REPO))
        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            port = sock.getsockname()[1]
        t0 = time.perf_counter()
        plain, ddp = _cli_losses([
            [sys.executable, "-m", "lidarcrafter_tpu_torch.train", *args, "--output-dir", str(Path(tmp) / "plain")],
            [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", "1", "--master-addr", "localhost",
             "--master-port", str(port), "-m", "lidarcrafter_tpu_torch.train", *args,
             "--output-dir", str(Path(tmp) / "ddp")]], env)
        check(len(plain) == 2 and plain == ddp, f"data: torchrun losses {ddp} != {plain}")
        emit({"phase": "data", "check": "torchrun nccl x1", "config": "nuscenes-box-layout-v6", "card": smi,
              "losses": plain, "torchrun_losses": ddp, "bit_equal": plain == ddp,
              "seconds_both_at_once": time.perf_counter() - t0})
    emit({"phase": "data", "check": "phase seconds", "card": smi, "seconds": time.perf_counter() - t_phase})
    return by_path


# ----------------------------------------------------------------- phase 14


# OpenAIUNet at the layout stacks' full width: 32x1024, 64 channels,
# multipliers (1, 2, 4, 8), 2 residual blocks, attention at ds 4 and 8; at
# the default heads its GLIDE blocks hold one head as wide as the block
# (256 at ds 4, 512 at ds 8 and in the middle)
OPENAI_UNET = dict(resolution=(32, 1024), in_channels=2, model_channels=64, out_channels=2, num_res_blocks=2,
                   channel_mult=(1, 2, 4, 8), attention_resolutions=(4, 8))
OPENAI_TRANSFORMER = dict(use_spatial_transformer=True, num_head_channels=32, context_dim=64)
CONTEXT_TOKENS = 13  # the SpatialTransformer's context: (B, 13, 64), a layout encoder's tokens
OACA_POSITIONAL_DIMS = (16, 64)  # channels_scale_for_positional_embedding 0.5 and 2 on 32-channel heads
REGISTRY_TRAIN = ("nuscenes-box-layout", "nuscenes-hdit-uncond", "nuscenes-box-layout-v6 glide")
REGISTRY_TRAIN_BATCH = 2


def glide_cfg(cfg=None):
    """``nuscenes-box-layout-v6`` (or ``cfg``) with GLIDE attention blocks."""
    from lidarcrafter_tpu_torch.configs import get_config

    cfg = cfg or get_config("nuscenes-box-layout-v6")
    cfg.model.params["attention_block_type"] = "GLIDEAttentionBlock"
    return cfg


def adm_blocks(channel_mult, num_res_blocks: int, attention_ds, resblock_updown: bool) -> tuple[int, int]:
    """(residual blocks, attention blocks) of an ADM UNet's block list: the
    encoder's levels and down steps, the middle's two residual blocks and
    one attention block, the decoder's levels (one block more) and up
    steps."""
    levels = len(channel_mult)
    attn_levels = sum(2 ** i in attention_ds for i in range(levels))
    res = levels * num_res_blocks + 2 + levels * (num_res_blocks + 1)
    if resblock_updown:
        res += 2 * (levels - 1)
    return res, attn_levels * (2 * num_res_blocks + 1) + 1


def registry_kernel_rows(gen) -> list:
    """Phase 14 (a): the attention kernel at OpenAIUNet's wide heads, float32
    and bfloat16, each against its plain version (the GLIDE shapes and
    OACA's positional widths are phase 2's)."""
    import torch

    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        rows.append(check_attention("wide B=8 h=1 L=2048 d=256", BATCH, 1, 2048, 2048, 256, dtype, gen)
                    | {"sub": "wide_heads"})
        rows.append(check_attention("wide B=8 h=1 L=512 d=512", BATCH, 1, 512, 512, 512, dtype, gen)
                    | {"sub": "wide_heads"})
        rows.append(check_attention("wide ragged B=8 h=2 L=1000 kv_len=777 d=384", BATCH, 2, 1000, 1000, 384,
                                    dtype, gen, kv_len=777) | {"sub": "wide_heads"})
    for row in rows:
        emit({"phase": "registry", "check": "kernel", **row})
        check(row["ms"] >= row["bound_ms"],
              f"{row['kernel']} {row['shape']} {row['dtype']}: {row['ms']} ms below its bound {row['bound_ms']} ms")
    return rows


def module_forward_parity(what: str, model, make_args, bf16: bool = True) -> None:
    """``model`` (seeded, float32) on the card against the CPU,
    ``make_args(dtype, device)`` giving its arguments; with ``bf16`` the
    card's copy served in bfloat16 (``to_serving_dtype_``, floating inputs
    cast) against the same CPU forward."""
    import torch

    from lidarcrafter_tpu_torch.precision import to_serving_dtype_

    t0 = time.perf_counter()
    with torch.inference_mode():
        want = model(*make_args(torch.float32, "cpu"))
    cpu_s = time.perf_counter() - t0
    gpu = copy.deepcopy(model).to(DEVICE)
    with torch.inference_mode():
        got = gpu(*make_args(torch.float32, DEVICE)).cpu()
    check_forward(f"{what} float32", got, want, FORWARD_RTOL, cpu_seconds=cpu_s)
    if bf16:
        to_serving_dtype_(gpu, torch.bfloat16)
        with torch.inference_mode():
            got = gpu(*make_args(torch.bfloat16, DEVICE)).float().cpu()
        check_forward(f"{what} bfloat16", got, want, BF16_FORWARD_RTOL)


def openai_unet_args(B: int, context: bool, seed: int):
    """``make_args`` of an OpenAIUNet: an image, log-SNR times and, for the
    SpatialTransformer, a (B, 13, 64) context, drawn on the CPU."""
    import torch

    g = torch.Generator().manual_seed(seed)
    x = torch.randn(B, *OPENAI_UNET["resolution"], 2, generator=g)
    t = torch.linspace(-3.0, 5.0, B)
    ctx = torch.randn(B, CONTEXT_TOKENS, OPENAI_TRANSFORMER["context_dim"], generator=g) if context else None

    def make(dtype, device):
        cd = {"time_condition": t.to(device)}
        if ctx is not None:
            cd["other_condition"] = ctx.to(device, dtype)
        return x.to(device, dtype), cd

    return make


def registry_forward_parity() -> None:
    """Phase 14 (b): full-width forwards, card against CPU."""
    import torch

    from lidarcrafter_tpu_torch.configs import get_config
    from lidarcrafter_tpu_torch.models import build_model
    from lidarcrafter_tpu_torch.weights import init_random_

    for kind, extra in (("glide", {}), ("spatial transformer", OPENAI_TRANSFORMER)):
        model = init_random_(build_model("openai_unet", **OPENAI_UNET, **extra), 31).eval()
        module_forward_parity(f"openai_unet {kind} B=1", model, openai_unet_args(1, bool(extra), 32))
    phase_forward_parity("nuscenes-box-layout-v6", glide_cfg(), "nuscenes-box-layout-v6 glide")
    refine = init_random_(build_model("refinenet", in_channels=2, resolution=(32, 1024), base_channels=128,
                                      channel_multiplier=(1, 2, 2, 2)), 33).eval()
    x = torch.randn(1, 32, 1024, 2, generator=torch.Generator().manual_seed(34))
    module_forward_parity("refinenet base 128 (1,2,2,2) B=1", refine, lambda dtype, device: (x.to(device, dtype),),
                          bf16=False)
    cond = torch.randn(BATCH, 32, 1024, 2, generator=torch.Generator().manual_seed(35))
    for method in ("bilinear", "nearest"):
        rescaler = init_random_(build_model("easy_unet", strides=((2, 2), (1, 2)), method=method, in_channels=2,
                                            out_channels=8), 36).eval()
        module_forward_parity(f"easy_unet {method} B=8", rescaler, lambda dtype, device: ({"cond": cond.to(device)},),
                              bf16=False)
    hdit = get_config("nuscenes-hdit-uncond")
    hdit.model.params["positional_embedding"] = "fourier_features"
    phase_unet_forward_parity("nuscenes-hdit-uncond", hdit, "nuscenes-hdit-uncond fourier_features")
    sh = get_config("nuscenes-unet-uncond")
    sh.model.params["coords_encoding"] = "spherical_harmonics"
    phase_unet_forward_parity("nuscenes-unet-uncond", sh, "nuscenes-unet-uncond spherical_harmonics")


def phase_registry(smi: str) -> tuple[list, dict]:
    """Phase 14: the rest of the registry at full width.  Returns the kernel
    rows and the launch counts by path."""
    import torch

    from lidarcrafter_tpu_torch.models import build_model
    from lidarcrafter_tpu_torch.precision import to_serving_dtype_
    from lidarcrafter_tpu_torch.utils.torch_ckpt import build_modules
    from lidarcrafter_tpu_torch.weights import init_random_

    t_phase = time.perf_counter()
    rows = registry_kernel_rows(torch.Generator(device=DEVICE).manual_seed(40))
    t0 = time.perf_counter()
    registry_forward_parity()
    emit({"phase": "registry", "check": "forward parity seconds", "seconds": time.perf_counter() - t0})

    # (c) served: the GLIDE v6 stack through CondFrameGenerator, OpenAIUNet forwards
    by_path = {}
    res, attn = adm_blocks((1, 2, 4, 8), 2, (4, 8), True)
    glide_call = {"attention": attn, "groupnorm": 2 * res + 1 + attn}  # ResBlocks, out_norm, one a GLIDE block
    mode, steps = ZOO_REQUEST
    for dname, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        gen, model, request = zoo_generator("nuscenes-box-layout-v6", dtype, glide_cfg())
        per_call = kernel_modules(model)
        check(per_call == {"oaca": 0, **glide_call}, f"glide v6 blocks {per_call} != {glide_call}")
        by_path[f"registry glide v6 {dname}"], _ = zoo_request(
            f"nuscenes-box-layout-v6 glide {dname} {mode}@{steps}", lambda: request(steps, mode, 1),
            lambda: request(2, mode, 99), per_call, steps, smi, phase="registry", config="nuscenes-box-layout-v6",
            attention_block_type="GLIDEAttentionBlock", dtype=dname)
        if dtype == torch.float32:
            phase_profile(f"one denoiser call (nuscenes-box-layout-v6 glide, predict_x_0), B=8, {dname}",
                          zoo_call(gen, gen.cfg), smi,
                          expect={"attention kernel": per_call["attention"], "groupnorm kernel": per_call["groupnorm"]})
        del gen, model, request
        torch.cuda.empty_cache()

    res, attn = adm_blocks(OPENAI_UNET["channel_mult"], OPENAI_UNET["num_res_blocks"],
                           OPENAI_UNET["attention_resolutions"], False)
    openai_call = {"oaca": 0, "attention": attn, "groupnorm": 2 * res + 1 + attn}
    model = init_random_(build_model("openai_unet", **OPENAI_UNET), 37).eval().to(DEVICE)
    check(kernel_modules(model) == openai_call, f"openai_unet blocks {kernel_modules(model)} != {openai_call}")
    heads = sorted({(m.num_heads, m.qkv.in_features // m.num_heads) for m in model.modules() if hasattr(m, "qkv")})
    check(heads == [(1, 256), (1, 512)], f"openai_unet heads x head dim {heads}")
    make = openai_unet_args(BATCH, False, 38)
    for dname, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        if dtype == torch.bfloat16:
            to_serving_dtype_(model, dtype)
        args = make(dtype, DEVICE)
        with torch.inference_mode():
            model(*args)  # warm-up
            torch.cuda.synchronize()
            counters = reset_counters()
            out = model(*args)
            torch.cuda.synchronize()
            launches = {k: c.n for k, c in counters.items()}
            ms = time_ms(lambda: model(*args), iters=5, warmup=1, gc_off=False)
        check(launches == with_zeros(openai_call, launches),
              f"openai_unet {dname}: launches {launches} != {openai_call}")
        check(bool(torch.isfinite(out).all()), f"openai_unet {dname}: not finite")
        emit({"phase": "registry", "what": f"openai_unet glide B=8 {dname} forward", "card": smi, "ms": ms,
              "launches": launches, "heads": heads})
        by_path[f"registry openai_unet {dname} (1 forward)"] = {k: n for k, n in launches.items() if n}
    del model
    torch.cuda.empty_cache()

    # (d) trained: one GLIDE v6 step card vs CPU, then 2 steps of v0, HDiT and GLIDE through train.py
    phase_step_parity("nuscenes-box-layout-v6", smi, "registry", edit=glide_cfg,
                      label="nuscenes-box-layout-v6 glide")
    with tempfile.TemporaryDirectory() as tmp:
        for name in REGISTRY_TRAIN:
            cfg_name, _, variant = name.partition(" ")
            from lidarcrafter_tpu_torch.configs import get_config

            cfg = get_config(cfg_name)
            sets = []
            if variant == "glide":
                glide_cfg(cfg)
                sets = ["--set", 'model.params.attention_block_type="GLIDEAttentionBlock"']
            per_step = kernel_modules(build_modules(cfg, "meta")["model"])
            records, _, launches = _train_main(
                ["-c", cfg_name, "--synthetic-data", "--num-steps", "2", "-b", str(REGISTRY_TRAIN_BATCH),
                 "--log-every", "1", "--checkpoint-every", "0", "--output-dir", str(Path(tmp) / name.replace(" ", "_")),
                 *sets])
            losses = [r["loss"] for r in records if "loss" in r]
            check(len(losses) == 2 and all(math.isfinite(v) for v in losses), f"registry train {name}: {losses}")
            for k, n in launches.items():
                check(n == 2 * per_step.get(k, 0), f"registry train {name}: {k} launches {n} != 2 x {per_step}")
            emit({"phase": "registry", "check": "train.py 2 steps", "config": name, "batch": REGISTRY_TRAIN_BATCH,
                  "card": smi, "losses": losses, "launches": launches, "per_step": per_step})
            if any(launches.values()):
                by_path[f"registry train {name} (2 steps)"] = {k: n for k, n in launches.items() if n}
            torch.cuda.empty_cache()
    emit({"phase": "registry", "check": "phase seconds", "card": smi, "seconds": time.perf_counter() - t_phase})
    return rows, by_path


# ------------------------------------------------------------------ phase 15
# the sparse 3D stack ("sparse"): the FSVD / FPVD backbones and the Voxel
# R-CNN detection metric with its CLIs, plain PyTorch (no kernel of the port)

SPARSE_SEED = 15
SPARSE_MAX_POINTS = 32768  # evaluate's --sparse-max-points default
SPARSE_CMP_CLOUDS = 4  # clouds whose level-0 voxels and descriptors are held card vs CPU (2 real, 2 gen)
SPARSE_RTOL = 1e-3  # descriptors and dense head maps, card vs CPU, of the largest
DET_CLOUDS, DET_CPU_CLOUDS = 4, 2  # clouds through Voxel R-CNN's predict; of them, dense maps held vs the CPU
DET_MAX_POINTS = 32768  # evaluate_detection's --max-points default
CLI_CLOUDS = 2


def max_rel(card, cpu) -> float:
    """max |card − cpu| over max |cpu|."""
    return float((card.cpu().float() - cpu.float()).abs().max()) / max(float(cpu.float().abs().max()), 1e-30)


def phase_sparse(frames, smi: str) -> None:
    """Phase 15: (a) FSVD / FPVD through ``evaluate --pretrained-root`` with
    torchsparse checkpoints of seeded MinkowskiNet / SPVCNN at upstream's
    eval widths, on phase 6's float32 rollout, card against CPU; (b) Voxel
    R-CNN (CenterHead + RoI head) from a pcdet file of seeded weights at the
    full nuScenes range and voxel, card against CPU; (c) the two detection
    CLIs on the card; (d) no kernel of the port launched.  Returns (b)'s
    detections: each cloud's real points and its kept boxes, scores and
    class names."""
    import torch

    from lidarcrafter_tpu_torch import evaluate_detection, extract_foreground
    from lidarcrafter_tpu_torch.metrics import eval_suite, evaluate
    from lidarcrafter_tpu_torch.metrics.distribution import compute_frechet_distance
    from lidarcrafter_tpu_torch.metrics.extractor import sparse_unet as SU
    from lidarcrafter_tpu_torch.metrics.models import voxel_rcnn as VR
    from lidarcrafter_tpu_torch.metrics.pretrained import load_sparse_descriptor
    from lidarcrafter_tpu_torch.ops.iou3d import nms
    from lidarcrafter_tpu_torch.ops.sparse import voxelize, voxelize_mean
    from lidarcrafter_tpu_torch.utils.torch_ckpt import to_pcdet_state_dict
    from lidarcrafter_tpu_torch.weights import init_random_

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    counters = reset_counters()
    scenes = rollout_clouds(frames)
    half = len(scenes) // 2
    real, gen = [c for s in scenes[:half] for c in s], [c for s in scenes[half:] for c in s]
    agree, device_ms, seconds, out = {}, {}, {}, {}

    def timed(name, fn):
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
        return result

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        # (a) FSVD / FPVD: upstream's eval widths (DEFAULT_LAYERS at cr 0.5, 4 input dims, 17 classes)
        root = tmp / "pretrained"
        for i, (name, cls) in enumerate((("minkowskinet", SU.MinkowskiNet), ("spvcnn", SU.SPVCNN))):
            (root / "nuscenes" / name).mkdir(parents=True)
            state = init_random_(cls(), SPARSE_SEED + i).state_dict()
            torch.save({"state_dict": SU.to_torchsparse_state_dict(state)}, root / "nuscenes" / name / "model.ckpt")
        kw = {"pretrained_root": str(root), "max_points": SPARSE_MAX_POINTS, "verbose": False}
        card = timed("evaluate_fsvd_fpvd", lambda: evaluate(real, gen, ["fsvd", "fpvd"], device=DEVICE, **kw))
        out["metrics"] = card
        subset = real[: SPARSE_CMP_CLOUDS // 2] + gen[: SPARSE_CMP_CLOUDS // 2]
        for name, metric in (("minkowskinet", "fsvd"), ("spvcnn", "fpvd")):
            desc = {dev: eval_suite._sparse_descriptors(subset, name, "32", str(root), SPARSE_MAX_POINTS, device=dev)
                    for dev in (DEVICE, "cpu")}
            err = max_rel(desc[DEVICE], desc["cpu"])
            agree[f"{name} descriptors ({len(subset)} clouds)"] = {"max_rel_err": err, "tol": SPARSE_RTOL,
                                                                   "ok": err <= SPARSE_RTOL}
            full = [eval_suite._sparse_descriptors(c, name, "32", str(root), SPARSE_MAX_POINTS, device=DEVICE).cpu()
                    for c in (real, gen)]
            agrees(agree, f"{metric} (CPU from the card's descriptors)", card[metric],
                   compute_frechet_distance(*full, device="cpu"), EVAL_RTOL["frechet"])
            describe = load_sparse_descriptor(root, name, max_points=SPARSE_MAX_POINTS, device=DEVICE)
            inp = [torch.as_tensor(a, device=DEVICE) for a in eval_suite.sparse_input(real[0], (1.0, 45.0),
                                                                                      SPARSE_MAX_POINTS)]
            device_ms[f"{name}_descriptor_ms_per_cloud"] = time_ms(lambda: describe(*inp), iters=10, warmup=2,
                                                                   gc_off=False)
        flips = 0
        for c in subset:
            pad, feats, mask = eval_suite.sparse_input(c, (1.0, 45.0), SPARSE_MAX_POINTS)
            on = {}
            for dev in (DEVICE, "cpu"):
                p, f, m = (torch.as_tensor(a, device=dev) for a in (pad, feats, mask))
                on[dev] = voxelize(p + 0.5 * 0.05, 0.05, m, SPARSE_MAX_POINTS)[:3:2] + \
                    voxelize_mean(p + 0.5 * 0.05, f, 0.05, m, SPARSE_MAX_POINTS)[1:3]
            flips += sum(not torch.equal(a.cpu(), b) for a, b in zip(on[DEVICE], on["cpu"]))
        agree["level-0 voxel coords and masks (MinkowskiNet, SPVCNN)"] = {"clouds": len(subset), "differing": flips,
                                                                          "ok": flips == 0}

        # (b) Voxel R-CNN at the nuScenes range and voxel, the six head groups
        params = VR.seeded_params(SPARSE_SEED + 2)
        ckpt = tmp / "voxel_rcnn.pth"
        torch.save({"model_state": to_pcdet_state_dict(params)}, ckpt)
        det = {dev: VR.load_voxel_rcnn_from_pcdet(ckpt, device=dev) for dev in (DEVICE, "cpu")}
        check(len(det[DEVICE].class_groups) == 6 and "roi_head" in det[DEVICE].params, "voxel rcnn head groups")
        clouds = [evaluate_detection.padded(np.concatenate([c, np.zeros((len(c), 1), np.float32)], 1),
                                            DET_MAX_POINTS) for c in (real + gen)[:: len(real + gen) // DET_CLOUDS]]
        worst, det_s, kept, detections = 0.0, [], [], []
        with torch.inference_mode():
            det[DEVICE].predict(*(torch.as_tensor(a, device=DEVICE) for a in clouds[0]))  # warm-up
            for i, (pts, mask) in enumerate(clouds):
                p, m = torch.as_tensor(pts, device=DEVICE), torch.as_tensor(mask, device=DEVICE)
                t0 = time.perf_counter()
                boxes, scores, names, valid = det[DEVICE].predict(p, m)
                torch.cuda.synchronize()
                det_s.append(time.perf_counter() - t0)
                check(bool(torch.isfinite(boxes).all() and torch.isfinite(scores).all()), f"voxel rcnn cloud {i}")
                kept.append(int(valid.sum()))
                keep = valid.cpu().numpy()
                detections.append({"points": pts[mask], "boxes": boxes.cpu().numpy()[keep],
                                   "scores": scores.cpu().numpy()[keep], "names": np.asarray(names, object)[keep]})
                order = {dev: nms(boxes.to(dev), scores.to(dev), det[DEVICE].nms_thresh) for dev in (DEVICE, "cpu")}
                same = all(torch.equal(a.cpu(), b) for a, b in zip(order[DEVICE], order["cpu"]))
                agree[f"NMS keep set, cloud {i} (card vs CPU on the card's boxes and scores)"] = {
                    "boxes": len(scores), "kept": int(order["cpu"][1].sum()), "ok": same}
                if i < DET_CPU_CLOUDS:
                    maps = {dev: det[dev].dense_maps(p.to(dev), m.to(dev)) for dev in (DEVICE, "cpu")}
                    coords_same = torch.equal(maps[DEVICE][2].cpu(), maps["cpu"][2]) and torch.equal(
                        maps[DEVICE][3].cpu(), maps["cpu"][3])
                    err = max(max_rel(hg[k], hc[k]) for hg, hc in zip(maps[DEVICE][0], maps["cpu"][0]) for k in hc)
                    worst = max(worst, err)
                    agree[f"voxel rcnn cloud {i}: voxel coords exact, head maps"] = {
                        "voxels": int(maps["cpu"][3].sum()), "max_rel_err": err, "tol": SPARSE_RTOL,
                        "ok": coords_same and err <= SPARSE_RTOL}
        out["voxel_rcnn"] = {"s_per_cloud": float(np.mean(det_s)), "s_by_cloud": det_s, "kept": kept,
                             "points": [int(m.sum()) for _, m in clouds], "grid_zyx": det[DEVICE].grid_zyx,
                             "params_m": sum(v.numel() for v in to_pcdet_state_dict(params).values()) / 1e6}

        # (c) the CLIs on the card, on synthetic ground truth (a box on each cloud's first points)
        gen_dir = tmp / "gen"
        gen_dir.mkdir()
        infos = []
        for i, c in enumerate(real[:CLI_CLOUDS]):
            cloud = np.concatenate([c, np.zeros((len(c), 1), np.float32)], 1)
            np.save(gen_dir / f"sample_tok{i}.npy", cloud)
            infos.append({"token": f"tok{i}", "gt_boxes": np.array([[*c[0, :2], c[0, 2], 4.0, 2.0, 1.5, 0.0],
                                                                    [*c[1, :2], c[1, 2], 0.8, 0.8, 1.7, 0.0]],
                                                                   np.float32), "gt_names": np.array(["car", "pedestrian"])})
        with open(tmp / "infos.pkl", "wb") as f:
            pickle.dump(infos, f)
        cli = {}
        common = ["--gen-dir", str(gen_dir)]
        for route in (["--pcdet-ckpt", str(ckpt)], ["--random-params"]):
            tag = route[0][2:]
            with contextlib.redirect_stdout(io.StringIO()):  # the CLIs' own reports; the results are read back
                res = timed(f"evaluate_detection {tag}", lambda: evaluate_detection.main(
                    [*common, "--gt-infos", str(tmp / "infos.pkl"), "-o", str(tmp / f"det_{tag}"), *route]))
                objs = timed(f"extract_foreground {tag}", lambda: extract_foreground.main(
                    [*common, "-o", str(tmp / f"fg_{tag}"), "--min-points", "5", *route]))
            check(res["gt_num"] == 2 * CLI_CLOUDS and np.isfinite(res["mAP"]), f"evaluate_detection {tag}: {res}")
            check((tmp / f"fg_{tag}" / "result.pkl").exists(), f"extract_foreground {tag}")
            cli[tag] = {"mAP": res["mAP"], "recall/rcnn_0.3": res["recall/rcnn_0.3"],
                        "avg_pred_objects": res["avg_pred_objects"], "objects": {k: len(v) for k, v in objs.items()}}
        out["clis"] = cli

    # (d) plain PyTorch: no kernel of the port launched
    launches = {k: c.n for k, c in counters.items()}
    failed = {k: v for k, v in agree.items() if not v["ok"]}
    check(not failed, f"sparse card vs CPU: {failed}")
    check(all(n == 0 for n in launches.values()), f"sparse: a kernel of the port launched: {launches}")
    check(all(np.isfinite(v) and v > 0 for v in card.values()), f"sparse: FSVD / FPVD {card}")
    seconds["phase"] = time.perf_counter() - t_phase
    emit({"phase": "sparse", "card": smi, "clouds": {"real": len(real), "gen": len(gen)},
          "backbones": "MinkowskiNet / SPVCNN, DEFAULT_LAYERS at cr 0.5, 4 input dims, 17 classes, seeded",
          "detector": "Voxel R-CNN (CenterHead, 6 groups, RoI head), ±54 x [-5, 3] m at (0.075, 0.075, 0.2), seeded",
          **out, "card_vs_cpu": agree, "device_ms": device_ms, "seconds": seconds, "launches": launches,
          "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9})
    torch.cuda.empty_cache()
    return detections


# ------------------------------------------------------------------ phase 16
# the object-level metrics ("objects"): CGF (PointMLP), RGF (GLENet's folds),
# DCF, the three auxiliary trainers and the evaluation CLIs, plain PyTorch

OBJ_SEED = 16
OBJ_CROPS = 512  # synthetic box-normalised crops through CGF and RGF
OBJ_POINTS = 1024  # PointMLP's input
OBJ_CLASSES = ("car", "truck", "bus", "pedestrian")
OBJ_BOX = {"car": (4.2, 1.9, 1.7), "truck": (7.0, 2.5, 3.0), "bus": (11.0, 2.9, 3.5), "pedestrian": (0.8, 0.8, 1.7)}
CGF_BATCH, RGF_BATCH = 32, 64
CGF_CPU_CROPS = 16  # crops whose FPS indices, logits and CGF dictionary are held card vs CPU
RGF_CPU_FOLDS = 1  # folds (× 30 passes) held card vs CPU
OBJ_RTOL = 1e-4
TRAIN_CLI_STEPS = 20
POINTMLP_GATE_LR = ("--lr", "0.02", "--min-lr", "0.001")  # the CLI's 0.1 (a 300-epoch recipe) does not fall in 20
MLP_STEP_BATCH = 4  # crops of the float64 PointMLP step held card vs CPU
MLP_F32_BATCH = 8  # clouds of the float32 PointMLP step held card vs CPU (at 32 its CPU side led the phase)
# a float32 PointMLP step's update parts from float64's by 3.4e-3 (relative
# L2) at 4 clouds, ReLU and max-pool switches of values within rounding of a
# tie carrying most of it (``python -m lidarcrafter_tpu_torch.step_precision``);
# two float32 steps, card and CPU, each carry such an error
PM_F32_UPDATE_TOL = 2e-2
# Adam's first update is lr · g / (|g| + 1e-8), about lr · sign(g) for each
# element, so a weight whose gradient lies within rounding of 0 moves up to
# 2 · lr apart; over the update's norm such weights stay far below this
GL_F32_UPDATE_TOL = 1e-3
EVAL_BOXES = ("car", "car", "truck")  # ground-truth boxes a cloud of each evaluate_our arm
OBJ_KEYS = ("frechet_distance", "squared_mmd", "jsd", "mmd")  # evaluate_our's obj section, each finite
OBJ_CPU_CARS = 8  # car crops of the obj features held card vs CPU


def object_crops(n: int, seed: int) -> list:
    """``n`` crop records as ``extract_foreground`` writes them (points in
    the box frame, x y z intensity), classes in turn, 20-800 points uniform
    in each box, a box at a random place and heading."""
    rnd = np.random.RandomState(seed)
    out = []
    for i in range(n):
        name = OBJ_CLASSES[i % len(OBJ_CLASSES)]
        size = np.asarray(OBJ_BOX[name]) * rnd.uniform(0.9, 1.1, 3)
        m = int(rnd.randint(20, 800))
        pts = np.concatenate([(rnd.rand(m, 3) - 0.5) * size, rnd.rand(m, 1)], 1).astype(np.float32)
        box = np.array([*rnd.uniform(-40, 40, 2), rnd.uniform(-2, 0), *size, rnd.uniform(-np.pi, np.pi)],
                       np.float32)
        out.append({"name": name, "points": pts, "num_points_in_gt": m, "box3d_lidar": box,
                    "score": float(rnd.uniform(0.3, 1.0))})
    return out


def state_err(a: dict, b: dict) -> tuple[float, str]:
    """The largest |a − b| over max(1, max |b|) across two state dicts, and its key."""
    return max((float((a[k].detach().cpu().double() - v.double()).abs().max()) / max(1.0, float(v.abs().max())), k)
               for k, v in b.items())


def falls(losses) -> bool:
    """The last 5 losses average below the first 5."""
    return all(np.isfinite(losses)) and float(np.mean(losses[-5:])) < float(np.mean(losses[:5]))


def car_boxes_on_points(cloud: np.ndarray, names: tuple) -> np.ndarray:
    """A ground-truth box (``OBJ_BOX`` size, heading 0) for each class of
    ``names`` at the densest places of ``cloud``: centred at the mean of the
    points within ±0.8 m (x, y, z) of the point (of at most 2,048 spread
    over the cloud) with most such neighbours, each place 5 m or more from
    those taken before, so that a crop holds points inside the ±1 m field
    of the ``obj`` BEV histograms."""
    import torch

    xyz = torch.as_tensor(cloud[:, :3], device=DEVICE)
    cand = xyz[:: max(1, len(xyz) // 2048)]
    near = torch.cdist(cand, xyz, p=float("inf")) < 0.8
    counts = near.sum(1)
    boxes = []
    for name in names:
        centre = xyz[near[int(counts.argmax())]].mean(0)
        boxes.append([*centre.tolist(), *OBJ_BOX[name], 0.0])
        counts = torch.where((cand[:, :2] - centre[:2]).norm(dim=1) < 5.0, -1, counts)
    return np.asarray(boxes, np.float32)


def trace_summary(kernels: list, wall_ms: float) -> dict:
    """One traced call's device kernels (``_trace``): their count, busy ms,
    the idle share against the call's ``wall_ms``, the share of the busy
    time in sort kernels, and the five kernel names that take longest."""
    by_name = {}
    for e in kernels:
        by_name[e.name[:80]] = by_name.get(e.name[:80], 0.0) + e.time_range.elapsed_us() / 1e3
    busy = sum(by_name.values())
    return {"device_kernels": len(kernels), "device_busy_ms": busy, "wall_ms": wall_ms,
            "idle_share": max(0.0, 1.0 - busy / wall_ms),
            "sort_share_of_busy": sum(v for k, v in by_name.items() if "sort" in k.lower()) / max(busy, 1e-9),
            "top_ms": sorted(by_name.items(), key=lambda kv: -kv[1])[:5]}


def phase_objects(frames, detections: list, smi: str) -> None:
    """Phase 16: CGF, RGF, DCF, the auxiliary trainers and the evaluation
    CLIs ``evaluate_our`` / ``evaluate_r2dm``."""
    import torch

    from lidarcrafter_tpu_torch import (
        evaluate_our,
        evaluate_r2dm,
        extract_foreground,
        train_glenet,
        train_pointmlp,
        train_rangenet,
    )
    from lidarcrafter_tpu_torch.datasets import transforms as T
    from lidarcrafter_tpu_torch.datasets.object_uncertainty import ObjectUncertaintyDataset
    from lidarcrafter_tpu_torch.metrics import fg_object as FG
    from lidarcrafter_tpu_torch.metrics.distribution import compute_frechet_distance, compute_squared_mmd
    from lidarcrafter_tpu_torch.metrics.extractor.pointmlp import point_mlp
    from lidarcrafter_tpu_torch.metrics.extractor.rangenet import RangeNet
    from lidarcrafter_tpu_torch.metrics.models import glenet as GL
    from lidarcrafter_tpu_torch.ops.points import farthest_point_sampling
    from lidarcrafter_tpu_torch.ops.projection import points_to_range_image
    from lidarcrafter_tpu_torch.training import classifier as CL
    from lidarcrafter_tpu_torch.training import segmentation as SG
    from lidarcrafter_tpu_torch.utils.sample_io import save_pth_sample
    from lidarcrafter_tpu_torch.weights import init_random_

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    counters = reset_counters()
    agree, device_ms, seconds, out = {}, {}, {}, {}

    def timed(name, fn):
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
        return result

    def record(name, err, tol=OBJ_RTOL, **extra):
        agree[name] = {"max_rel_err": err, "tol": tol, "ok": err <= tol, **extra}

    laps = [t_phase]

    def lap(section):
        """The seconds of ``section``: since the last lap."""
        torch.cuda.synchronize()
        now = time.perf_counter()
        seconds[f"section {section}"], laps[0] = now - laps[0], now

    crops = object_crops(OBJ_CROPS, OBJ_SEED)
    rnd = np.random.RandomState(OBJ_SEED)
    clouds = np.stack([T.sample_points(c["points"], OBJ_POINTS, rnd)[:, :3] for c in crops])
    labels = np.asarray([OBJ_CLASSES.index(c["name"]) for c in crops])
    npts = np.asarray([c["num_points_in_gt"] for c in crops])

    # (a) CGF: PointMLP at full width over the 512 crops, B = 32
    mlp = init_random_(point_mlp(4), OBJ_SEED).to(DEVICE).eval()
    apply = FG.pointmlp_logits(mlp)
    apply(torch.as_tensor(clouds[:CGF_BATCH], device=DEVICE))  # warm-up
    cgf = timed("cgf", lambda: FG.compute_cgf(apply, list(clouds), labels, npts, OBJ_CLASSES, CGF_BATCH, DEVICE))
    x = torch.as_tensor(clouds[:CGF_BATCH], device=DEVICE)
    device_ms["pointmlp_ms_per_batch"] = time_ms(lambda: apply(x), iters=5, warmup=1, gc_off=False)
    out["pointmlp_batch_trace"] = trace_summary(_trace(lambda: apply(x), TRACE_SLEEP_CYCLES)[0],
                                                device_ms["pointmlp_ms_per_batch"])
    sub = clouds[:CGF_CPU_CROPS]
    mlp_cpu = copy.deepcopy(mlp).cpu()
    with torch.inference_mode():
        fps = {dev: farthest_point_sampling(torch.as_tensor(sub, device=dev), OBJ_POINTS // 2).cpu()
               for dev in (DEVICE, "cpu")}
        logits = {DEVICE: apply(torch.as_tensor(sub, device=DEVICE)).cpu(), "cpu": mlp_cpu(torch.as_tensor(sub))}
    differing = int((fps[DEVICE] != fps["cpu"]).any(dim=1).sum())
    agree["FPS indices, first stage (crops without ties)"] = {"crops": len(sub), "differing_crops": differing,
                                                              "ok": True}
    record(f"PointMLP logits ({len(sub)} crops)", max_rel(logits[DEVICE], logits["cpu"]))
    sub_args = (list(sub), labels[: len(sub)], npts[: len(sub)], OBJ_CLASSES, len(sub))
    same = FG.compute_cgf(lambda _: logits[DEVICE], *sub_args, "cpu") == FG.compute_cgf(lambda _: logits["cpu"],
                                                                                        *sub_args, "cpu")
    agree[f"CGF dictionary ({len(sub)} crops)"] = {"ok": same}
    out["cgf"] = {"overall_accuracy": cgf["overall"]["accuracy"], "partitions": sorted(cgf["partitions"])}
    lap("a cgf")

    # (b) RGF: GLENet at exp20, 10 folds × 30 passes, B = 64
    glenet = init_random_(GL.GLENet(**GL.EXP20_KWARGS), OBJ_SEED + 1).to(DEVICE).eval()
    latent = GL.EXP20_KWARGS["latent_size"]

    def rgf(model, folds, device):
        return FG.compute_rgf_folds(crops, lambda f: FG.glenet_apply(model), FG.seeded_draws(OBJ_SEED), num_passes=30,
                                    num_folds=folds, batch_size=RGF_BATCH, latent_size=latent, device=device)

    rgf_card = timed("rgf_10x30", lambda: rgf(glenet, 10, DEVICE))
    folds_card = timed(f"rgf_{RGF_CPU_FOLDS}x30", lambda: rgf(glenet, RGF_CPU_FOLDS, DEVICE))
    out["rgf_fold_trace"] = trace_summary(_trace(lambda: rgf(glenet, RGF_CPU_FOLDS, DEVICE), 0)[0],
                                          seconds[f"rgf_{RGF_CPU_FOLDS}x30"] * 1e3)
    folds_cpu = timed(f"rgf_{RGF_CPU_FOLDS}x30_cpu", lambda: rgf(copy.deepcopy(glenet).cpu(), RGF_CPU_FOLDS, "cpu"))
    for part in ("overall", *folds_cpu["partitions"]):
        c = folds_cpu[part] if part == "overall" else folds_cpu["partitions"][part]
        g = folds_card[part] if part == "overall" else folds_card["partitions"].get(part)
        check(g is not None, f"rgf partition {part} missing on the card")
        err = max(max(abs(a - b) for a, b in zip(g["variance"], c["variance"])) / max(1.0, max(c["variance"])),
                  abs(g["overlap"] - c["overlap"]))
        record(f"RGF variance and overlap, {RGF_CPU_FOLDS} fold(s) × 30 passes ({part})", err)
    val = ObjectUncertaintyDataset(crops, 0, {c: np.zeros((1, 512), np.float32) for c in OBJ_CLASSES},
                                   rng=np.random.RandomState(OBJ_SEED))
    gl_batch = {k: torch.as_tensor(v) for k, v in next(val.batches(RGF_BATCH)).items()}  # a training batch
    gb = {k: v.to(DEVICE) for k, v in gl_batch.items()}
    eps = torch.randn(len(gb["points"]), latent, device=DEVICE)
    gapply = FG.glenet_apply(glenet)
    device_ms["glenet_ms_per_batch"] = time_ms(lambda: gapply(gb, eps), iters=10, warmup=2, gc_off=False)
    out["rgf"] = {"overall": rgf_card["overall"], "partitions": sorted(rgf_card["partitions"])}
    lap("b rgf")

    # (c) DCF on phase 15's detections
    by_class = {}
    for d in detections:
        for name, score in zip(d["names"], d["scores"]):
            by_class.setdefault(str(name), []).append({"name": str(name), "score": float(score)})
    out["dcf"] = FG.compute_dcf(by_class)
    out["dcf_detections"] = {k: len(v) for k, v in by_class.items()}

    # (d) the trainers: 20 steps of each CLI on the card, then one step card vs CPU
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        quiet = contextlib.redirect_stdout(io.StringIO())
        with quiet:
            pm = timed("train_pointmlp", lambda: train_pointmlp.main(
                ["--synthetic-data", "--epochs", str(TRAIN_CLI_STEPS), "--batch-size", "32", "--seed", str(OBJ_SEED),
                 *POINTMLP_GATE_LR, "-o", str(tmp / "pointmlp")]))
            gl = timed("train_glenet", lambda: train_glenet.main(
                ["--synthetic-data", "640", "--folds", "0", "--epochs", str(TRAIN_CLI_STEPS), "--steps-per-epoch",
                 "1", "--batch-size", "64", "--seed", str(OBJ_SEED), "-o", str(tmp / "glenet")]))
            rn = timed("train_rangenet", lambda: train_rangenet.main(
                ["--synthetic-data", "--backbone", "53", "-b", "8", "--resolution", "32", "1024", "--num-steps",
                 str(TRAIN_CLI_STEPS), "--warmup-steps", "2", "--eval-every", "10",
                 "--output-dir", str(tmp / "rangenet")]))
        gl_reg = [r["reg"] for r in gl["history"][0]]
        train = {
            "pointmlp": {"losses": pm["losses"], "steps_per_s": TRAIN_CLI_STEPS / pm["train_seconds"],
                         "falls": falls(pm["losses"])},
            "glenet": {"reg": gl_reg, "loss": [r["loss"] for r in gl["history"][0]],
                       "steps_per_s": TRAIN_CLI_STEPS / gl["train_seconds"][0], "falls": falls(gl_reg)},
            "rangenet53": {"losses": rn["losses"], "miou": rn["mious"],
                           "steps_per_s": TRAIN_CLI_STEPS / rn["train_seconds"], "falls": falls(rn["losses"])},
        }
        for k, v in train.items():
            check(v["falls"], f"{k}: the loss did not fall over {TRAIN_CLI_STEPS} steps: {v}")
        out["train"] = train
        lap("d trainer CLIs")

        g = torch.Generator().manual_seed(OBJ_SEED)
        # PointMLP and GLENet in float64 (their float32 steps follow)
        mlp0 = init_random_(point_mlp(4, dropout=0.0), OBJ_SEED + 2)
        mlp_batch = {"points": torch.as_tensor(clouds[:MLP_STEP_BATCH]).double(),
                     "labels": torch.as_tensor(labels[:MLP_STEP_BATCH])}
        pm_pts, pm_labels = next(train_pointmlp.synthetic_batches(MLP_F32_BATCH, OBJ_POINTS, 4,
                                                                  np.random.RandomState(OBJ_SEED)))
        mlp_batch32 = {"points": torch.as_tensor(pm_pts), "labels": torch.as_tensor(pm_labels)}
        gl0 = init_random_(GL.GLENet(**GL.EXP20_KWARGS), OBJ_SEED + 3)
        gl_batch64 = {k: v.double() for k, v in gl_batch.items()}
        gl_eps = torch.randn(len(gl_batch["points"]), latent, generator=g, dtype=torch.float64)
        rn0 = init_random_(RangeNet(num_classes=17, backbone=53), OBJ_SEED + 4)
        img = torch.rand(1, 5, 32, 1024, generator=g)
        rn_batch = {"image": img, "labels": (1 + (img[:, 0] * 15.999).long())}

        def mlp_step(dtype, batch, dev):
            m = copy.deepcopy(mlp0).to(dev, dtype)
            tx = CL.make_classifier_optimizer(epochs=TRAIN_CLI_STEPS)
            loss, _ = CL.make_classifier_train_step(m, tx)(tx.init(list(m.parameters())), {
                "points": batch["points"].to(dev, dtype), "labels": batch["labels"].to(dev)})
            return float(loss), m.state_dict()

        def gl_step(dtype, dev):
            m = copy.deepcopy(gl0).to(dev, dtype)
            tx = GL.make_glenet_optimizer(total_steps=TRAIN_CLI_STEPS)
            out = GL.make_glenet_train_step(m, tx)(tx.init(list(m.parameters())),
                                                   {k: v.to(dev, dtype) for k, v in gl_batch64.items()}, 0.05,
                                                   eps=gl_eps.to(dev, dtype))
            return float(out["loss"]), m.state_dict()

        def rn_step(dev):
            r = copy.deepcopy(rn0).to(dev)
            SG.train_frozen_statistics_(r)
            rtx = SG.make_rangenet_optimizer(warmup_steps=1)
            rstate = rtx.init(SG.trained_tensors(r))
            rstate["count"] = 1  # the LR at the first update is 0
            SG.make_segmentation_train_step(r, rtx, SG.rangenet_class_weights(17).to(dev), ignore_index=0)(
                rstate, {k: v.to(dev) for k, v in rn_batch.items()})
            return r.state_dict()

        states, f32 = {}, {}
        for dev in (DEVICE, "cpu"):
            on = "card" if dev == DEVICE else "cpu"
            states[dev] = {
                f"PointMLP (float64, B = {MLP_STEP_BATCH})": timed(f"step_pointmlp_f64_{on}",
                                                                   lambda: mlp_step(torch.float64, mlp_batch, dev))[1],
                "GLENet (float64, B = 64)": timed(f"step_glenet_f64_{on}", lambda: gl_step(torch.float64, dev))[1],
                "RangeNet-53 (B = 1, 32 x 1024)": timed(f"step_rangenet53_{on}", lambda: rn_step(dev))}
            f32[dev] = {"pointmlp": timed(f"step_pointmlp_f32_{on}", lambda: mlp_step(torch.float32, mlp_batch32, dev)),
                        "glenet": timed(f"step_glenet_f32_{on}", lambda: gl_step(torch.float32, dev))}
            torch.cuda.empty_cache()
        for name, cpu_state in states["cpu"].items():
            err, key = state_err(states[DEVICE][name], cpu_state)
            record(f"one train step, {name}: parameters and running statistics", err, worst=key)

        # float32: the loss and the running statistics (forward quantities)
        # to OBJ_RTOL, the parameters' update card vs CPU in relative L2.
        # PointMLP (a synthetic batch of the CLI's, MLP_F32_BATCH clouds,
        # dropout off) to PM_F32_UPDATE_TOL.  GLENet (B = 64) to
        # GL_F32_UPDATE_TOL without the tensors that the loss's data term
        # does not reach (their float64 gradient on the CPU is 0 to rounding:
        # the biases in front of a train-mode BatchNorm), whose rounding noise
        # Adam scales into LR-sized steps
        ref = copy.deepcopy(gl0).double()
        reg, lat, _ = ref(gl_batch64, eps=gl_eps, train=True)
        grads = torch.autograd.grad(reg + 0.05 * lat, list(ref.parameters()))
        gmax = max(float(v.abs().max()) for v in grads)
        unreached = [k for (k, _), v in zip(ref.named_parameters(), grads) if float(v.abs().max()) <= 1e-10 * gmax]
        for model0, key, batch, tol in ((mlp0, "pointmlp", MLP_F32_BATCH, PM_F32_UPDATE_TOL),
                                        (gl0, "glenet", RGF_BATCH, GL_F32_UPDATE_TOL)):
            name = f"one float32 train step, {model0.__class__.__name__} (B = {batch})"
            (loss_g, sg), (loss_c, sc) = f32[DEVICE][key], f32["cpu"][key]
            record(f"{name}: loss", abs(loss_g - loss_c) / abs(loss_c))
            err, worst = state_err(sg, {k: v for k, v in sc.items() if "running" in k})
            record(f"{name}: running statistics", err, worst=worst)
            init = model0.state_dict()
            kept = [k for k, _ in model0.named_parameters() if k not in unreached or key == "pointmlp"]
            gap = {k: float((sg[k].cpu().double() - sc[k].double()).square().sum()) for k in kept}
            norm = sum(float((sc[k].double() - init[k]).square().sum()) for k in kept)
            err, worst = state_err(sg, {k: sc[k] for k in kept})
            record(f"{name}: parameter update (relative L2)", (sum(gap.values()) / norm) ** 0.5, tol,
                   worst=max(gap, key=gap.get), max_abs_err=err, max_abs_err_at=worst,
                   **({"left_out": unreached} if key == "glenet" else {}))

        lap("d one-step parity")
        # (e) evaluate_our over crops of the rollout clouds that
        # extract_foreground cuts with ground-truth boxes (a seeded
        # detector's boxes hold no points, phase 15), then evaluate_r2dm
        scenes = rollout_clouds(frames)
        half = len(scenes) // 2
        real, gen = [c for s in scenes[:half] for c in s], [c for s in scenes[half:] for c in s]
        sample_dir = tmp / "generated_results"
        for arm, arm_clouds in (("ori", real), ("our", gen)):
            (tmp / arm).mkdir()
            infos = []
            for i, c in enumerate(arm_clouds):
                np.save(tmp / arm / f"sample_tok{i}.npy", np.concatenate([c, np.zeros((len(c), 1), np.float32)], 1))
                infos.append({"token": f"tok{i}", "gt_boxes": car_boxes_on_points(c, EVAL_BOXES),
                              "gt_names": np.asarray(EVAL_BOXES)})
            with open(tmp / f"infos_{arm}.pkl", "wb") as f:
                pickle.dump(infos, f)
            with quiet:
                timed(f"extract_foreground {arm}", lambda: extract_foreground.main(
                    ["--gen-dir", str(tmp / arm), "--gt-infos", str(tmp / f"infos_{arm}.pkl"), "--min-points", "5",
                     "-o", str(sample_dir / arm / "inference_results")]))
        fg_info = {arm: evaluate_our._load_fg_info(sample_dir / arm / "inference_results" /
                                                   "foreground_samples_info.pkl") for arm in ("ori", "our")}
        out["eval_crops"] = {arm: {k: len(v) for k, v in info.items()} for arm, info in fg_info.items()}
        with quiet:
            res = timed("evaluate_our", lambda: evaluate_our.main(
                ["--method", "our", "--sample-dir", str(sample_dir), "-m", "dcf", "cgf", "rgf", "obj",
                 "--random-extractors", "--num-obj-points", str(OBJ_POINTS), "--batch-size", "32",
                 "-o", str(tmp / "our.json")]))
        obj = res.get("obj", {})
        check((tmp / "our.json").exists() and "dcf" in res["object"] and "cgf" in res["object"]
              and "rgf" in res["object"] and all(np.isfinite(obj.get(k, np.nan)) for k in OBJ_KEYS),
              f"evaluate_our: {res}")
        lap("e crops and evaluate_our")
        out["evaluate_our"] = {"dcf": res["object"]["dcf"], "cgf_accuracy": res["object"]["cgf"]["overall"]["accuracy"],
                               "rgf_overall": res["object"]["rgf"]["overall"], "obj": obj}
        # the obj section's PointMLP (--random-extractors) card vs CPU on
        # OBJ_CPU_CARS car crops, and its Fréchet distance and squared MMD on
        # the CPU from the card's features of every car crop
        model = init_random_(point_mlp(num_classes=4, points=OBJ_POINTS), 0).eval()
        cars = {}
        for arm, info in fg_info.items():
            crops_, labels_, _, _ = evaluate_our._fg_crops(info, OBJ_POINTS)
            cars[arm] = torch.as_tensor(crops_[labels_ == OBJ_CLASSES.index("car")][..., :3])
        with torch.inference_mode():
            card_model = copy.deepcopy(model).to(DEVICE)
            feats = {arm: card_model(c.to(DEVICE), return_features=True).cpu() for arm, c in cars.items()}
            err = max_rel(feats["our"][:OBJ_CPU_CARS], model(cars["our"][:OBJ_CPU_CARS], return_features=True))
        record(f"obj: PointMLP features of {OBJ_CPU_CARS} car crops", err)
        agrees(agree, "obj: Fréchet distance (CPU from the card's features)", obj["frechet_distance"],
               compute_frechet_distance(feats["ori"], feats["our"], device="cpu"), EVAL_RTOL["frechet"])
        agrees(agree, "obj: squared MMD (CPU from the card's features)", obj["squared_mmd"],
               compute_squared_mmd(feats["ori"], feats["our"], device="cpu"), EVAL_RTOL["frechet"])
        lap("e obj card vs cpu")
        r2 = tmp / "r2dm"
        (r2 / "gen").mkdir(parents=True)
        (r2 / "real").mkdir()
        for i, c in enumerate(gen):
            img = points_to_range_image(torch.as_tensor(np.concatenate([c, np.zeros((len(c), 1), np.float32)], 1),
                                                        device=DEVICE)).cpu().numpy()  # x y z 0, depth, valid
            save_pth_sample(r2 / "gen" / f"{i:05d}.pth", img[..., 4] * img[..., 5], img[..., :3])
        for i, c in enumerate(real):
            np.save(r2 / "real" / f"{i:05d}.npy", c)
        with quiet:
            res = timed("evaluate_r2dm", lambda: evaluate_r2dm.main(
                ["--sample-dir", str(r2 / "gen"), "--real-dir", str(r2 / "real"), "--random-extractors",
                 "--cache-dir", str(r2), "-o", str(r2 / "results.json")]))
        check((r2 / "results.json").exists() and res["info"]["#fake"] == len(gen)
              and all(np.isfinite(v) for sec in ("img", "pts", "bev") for v in res[sec].values()),
              f"evaluate_r2dm: {res}")
        out["evaluate_r2dm"] = res

    # (f) plain PyTorch: no kernel of the port launched
    launches = {k: c.n for k, c in counters.items()}
    failed = {k: v for k, v in agree.items() if not v["ok"]}
    check(not failed, f"objects card vs CPU: {failed}")
    check(all(n == 0 for n in launches.values()), f"objects: a kernel of the port launched: {launches}")
    seconds["phase"] = time.perf_counter() - t_phase
    emit({"phase": "objects", "card": smi, "crops": OBJ_CROPS, "points": OBJ_POINTS,
          "models": "PointMLP point_mlp(4) and GLENet exp20 (latent 8), seeded", **out, "card_vs_cpu": agree,
          "device_ms": device_ms, "seconds": seconds, "launches": launches,
          "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9})
    torch.cuda.empty_cache()


def probe_times(kernels) -> dict:
    """Device times of the loader's ``x·2`` probe kernel on its (8, 128)
    float32 input, of ``x * 2`` and of ``torch.mul(x, 2)``, and its bound
    (x read and y written once)."""
    import torch

    from lidarcrafter_tpu_torch.kernels import loader

    lib = kernels.libs["probe"]
    x = torch.arange(8 * 128, dtype=torch.float32, device=DEVICE).reshape(8, 128)
    y = torch.empty_like(x)
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        loader.check(lib.probe_x2(x.data_ptr(), y.data_ptr(), x.numel(), stream), "probe_x2")

    ms = time_ms(launch)
    check(torch.equal(y, x * 2), "probe_x2 returned wrong values")
    nbytes = 2 * x.numel() * x.element_size()
    bound, by = bound_ms(nbytes, x.numel(), GN_ROUTE)
    return {"probe_ms": ms, "probe_plain_ms": time_ms(lambda: x * 2),
            "probe_library_ms": time_ms(lambda: torch.mul(x, 2)), "probe_bound_ms": bound,
            "probe_bound_by": by, "probe_bytes": nbytes}


# ----------------------------------------------------------------- phase 17

EXPORT_CONFIGS = {  # config → the solver of its artifacts, B = 8
    "nuscenes-box-layout-v6": "dpmpp_2m",
    "nuscenes-unet-uncond": "ddim",
    "nuscenes-auto-reg-v2": "dpmpp_2m",
}
# solver steps of an artifact: tracing, saving and loading take seconds per
# denoiser call unrolled into the graph (~1,700 nodes each)
EXPORT_STEPS = {"float32": 2, "bfloat16": 1}
PER_CALL = {  # kernel launches a denoiser call of the stacks that phases 13, 17 and the viewer serve
    "nuscenes-box-layout-v6": {"oaca": OACA_PER_FORWARD, "groupnorm": GN_PER_FORWARD},
    "nuscenes-unet-uncond": {"attention": ATTN_PER_UNET, "groupnorm": GN_PER_UNET},
    "nuscenes-auto-reg-v2": {"oaca": OACA_PER_FORWARD, "groupnorm": GN_PER_FORWARD},
    "meanflow-nusc": {"attention": ATTN_PER_UNET, "groupnorm": GN_PER_UNET},
}
# an artifact's frames against the eager generator's for the same seed and
# dtype, of the largest |eager| value: the same operators on the same draws
# (bit for bit expected), so both dtypes are held to 1e-5; the bfloat16
# serving limit is for bfloat16 against float32, not for a replay
EXPORT_RTOL = {"float32": 1e-5, "bfloat16": 1e-5}
EXPORT_SEED = 17


def replay_error(got: dict, want: dict) -> float:
    """The largest |artifact − eager| over the postprocessed outputs, of
    the largest |eager| value."""
    return max(float((got[k] - want[k]).abs().max()) / max(float(want[k].abs().max()), 1e-30) for k in want)


def check_launches(what: str, launches: dict, per_call: dict, calls: int) -> None:
    for k, n in launches.items():
        check(n == per_call.get(k, 0) * calls, f"{what}: {k} launches {n} != {per_call.get(k, 0)} x {calls}")


def export_replay(name: str, gen, dname: str, steps: int, art_dir: Path, batch=None) -> tuple[dict, dict]:
    """Trace ``gen``'s sampler (``EXPORT_CONFIGS[name]`` at ``steps``,
    B = 8, condition ``batch``) on the device its weights lie on, save it
    under ``art_dir``, load it onto the card and replay it once after a
    warm-up, with the launch counters set to 0 just before and read just
    after (exactly ``PER_CALL[name]`` a denoiser call); returns the
    replay's frames and the seconds, sizes and launches."""
    import torch

    from lidarcrafter_tpu_torch.serving import export_sampler, load_artifact, save_artifact

    mode, cond = EXPORT_CONFIGS[name], batch is not None
    t0 = time.perf_counter()
    exported = export_sampler(gen.engine, gen.lidar_utils, batch_size=BATCH, num_steps=steps, mode=mode,
                              condition_example=batch)
    export_s = time.perf_counter() - t0
    ops = sum(str(n.target).startswith("lidarcrafter_torch.") for n in exported.graph.nodes)
    per_call = PER_CALL[name]
    check(ops == sum(per_call.values()) * steps, f"export {name} {dname}: {ops} operator nodes")
    t0 = time.perf_counter()
    art = save_artifact(art_dir, exported, {
        "config": name, "batch_size": BATCH, "num_steps": steps, "mode": mode, "dtype": dname,
        "conditional": cond, "sampling_shape": list(gen.engine.sampling_shape)})
    save_s = time.perf_counter() - t0
    del exported
    t0 = time.perf_counter()
    fn, meta = load_artifact(art, device=DEVICE)
    load_s = time.perf_counter() - t0
    args = (EXPORT_SEED, batch) if cond else (EXPORT_SEED,)
    fn(*args)  # warm-up: the program's first call
    counters = reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    replay_s = time.perf_counter() - t0
    launches = {k: c.n for k, c in counters.items()}
    check_launches(f"replay {name} {dname} traced on {meta['device']}", launches, per_call, steps)
    return out, {"mode": mode, "steps": steps, "batch": BATCH, "traced_on": meta["device"], "export_seconds": export_s,
                 "save_seconds": save_s, "load_seconds": load_s,
                 "artifact_bytes": (art / "sampler.pt2").stat().st_size, "operator_nodes": ops,
                 "replay_seconds": replay_s, "launches": launches}


def phase_export(smi: str) -> dict:
    """Phase 17 ("export"): the serving artifacts of ``serving/export.py``
    at full width, B = 8, for ``nuscenes-box-layout-v6`` and
    ``nuscenes-auto-reg-v2`` (DPM++(2M)) and ``nuscenes-unet-uncond``
    (DDIM), in float32 (2 steps) and then, the same generator cast to the
    serving dtype, in bfloat16 (1 step): each traced on the card
    (:func:`export_replay`: saved, loaded, replayed with exact launches),
    its frames against the eager generator's for the same seed and
    condition (``EXPORT_RTOL``).  After the float32 uncond artifact, the
    same sampler traced on the CPU (plain versions; 1 step) and moved to
    the card at load: its replay launches the kernels and equals the card
    generator's eager frames.  Returns the launch counts by path."""
    import torch

    from lidarcrafter_tpu_torch.configs import get_config
    from lidarcrafter_tpu_torch.generate import UncondFrameGenerator
    from lidarcrafter_tpu_torch.generate_cond import CondFrameGenerator
    from lidarcrafter_tpu_torch.precision import to_serving_dtype_
    from lidarcrafter_tpu_torch.training.factory import layout_condition_batch

    by_path = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, mode in EXPORT_CONFIGS.items():
            uncond = name == "nuscenes-unet-uncond"
            gen = (UncondFrameGenerator if uncond else CondFrameGenerator)(get_config(name), DEVICE, 0)
            batch = None
            if not uncond:  # drawn on the host, so that every device gets the same condition
                batch = {k: v.to(gen.device) for k, v in layout_condition_batch(
                    gen.cfg, BATCH, generator=torch.Generator().manual_seed(EXPORT_SEED)).items()}
            for dname, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
                if dtype != torch.float32:  # the bfloat16 generator: the same weights, cast
                    to_serving_dtype_(gen.model if uncond else gen.models["model"], dtype,
                                      cond_model=None if uncond else gen.models["cond"])
                    gen.engine = dataclasses.replace(gen.engine, dtype=dtype)
                steps = EXPORT_STEPS[dname]
                out, info = export_replay(name, gen, dname, steps, Path(tmp) / f"{name}-{dname}", batch)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                _, eager = gen.generate(BATCH, steps, mode=mode, seed=EXPORT_SEED,
                                        **({} if uncond else {"batch": batch}))
                torch.cuda.synchronize()
                info["eager_seconds"] = time.perf_counter() - t0
                err = replay_error(out, eager)
                check(err <= EXPORT_RTOL[dname], f"export {name} {dname}: replay {err} from the eager generator")
                check(all(bool(torch.isfinite(v).all()) for v in out.values()), f"export {name} {dname}: not finite")
                emit({"phase": "export", "config": name, "dtype": dname, "card": smi, **info,
                      "replay_vs_eager": err, "tol": EXPORT_RTOL[dname], "bitwise": err == 0.0})
                by_path[f"export replay {name} {dname}"] = {k: n for k, n in info["launches"].items() if n}
                if uncond and dtype == torch.float32:
                    # traced on the CPU, where the plain versions run, moved to the card at load
                    cpu_gen = UncondFrameGenerator(get_config(name), "cpu", 0)
                    out, info = export_replay(name, cpu_gen, dname, 1, Path(tmp) / f"{name}-cpu", None)
                    del cpu_gen
                    _, eager = gen.generate(BATCH, 1, mode=mode, seed=EXPORT_SEED)
                    err = replay_error(out, eager)
                    check(info["traced_on"] == "cpu", f"the CPU artifact was traced on {info['traced_on']}")
                    check(err <= EXPORT_RTOL[dname], f"export traced on the CPU, replayed on the card: {err}")
                    emit({"phase": "export", "config": name, "dtype": dname, "card": smi, **info,
                          "replayed_on": DEVICE, "replay_vs_eager": err, "tol": EXPORT_RTOL[dname]})
                    by_path[f"export replay {name} {dname}, traced on the CPU"] = {
                        k: n for k, n in info["launches"].items() if n}
                del out, eager
            del gen
            torch.cuda.empty_cache()
    return by_path


VIEWER_REQUEST_STEPS = 2


def phase_viewer(smi: str) -> dict:
    """Phase 4 (viewer): ``viewer.py``'s server on the card (full width,
    float32, seeded weights; the server builds each config's generator at
    its first request, which is not timed) answers one
    ``POST /api/sample`` of each of its four configs over HTTP (DDIM@2;
    MeanFlow one step; v6 with two edited boxes), with the launch counters
    set to 0 before each request and read after: 11 OACA + 101 GroupNorm a
    v6 / auto-reg-v2 call, 2 attention + 50 GroupNorm an uncond / MeanFlow
    call.  Returns the launch counts by path."""
    import threading
    import urllib.request

    from lidarcrafter_tpu_torch import viewer

    boxes = [[10, 3, -0.5, 4.5, 2, 1.7, 0.3, 1], [18, -6, -0.4, 4.2, 1.9, 1.6, -1.2, 2]]
    httpd = viewer.serve(port=0, device=DEVICE)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    by_path, out = {}, {}
    try:
        url = f"http://127.0.0.1:{httpd.server_address[1]}/api/sample"
        for name in viewer.CONFIGS:
            body = {"config": name, "steps": VIEWER_REQUEST_STEPS, "mode": "ddim", "seed": 1}
            if name == "nuscenes-box-layout-v6":
                body["boxes"] = boxes
            req = urllib.request.Request(url, data=json.dumps(body).encode(), method="POST")
            with urllib.request.urlopen(req, timeout=600) as r:  # builds the config's generator
                r.read()
            counters = reset_counters()
            t0 = time.perf_counter()
            with urllib.request.urlopen(urllib.request.Request(url, data=json.dumps(body).encode(), method="POST"),
                                        timeout=600) as r:
                frame = json.loads(r.read())
            seconds = time.perf_counter() - t0
            launches = {k: c.n for k, c in counters.items()}
            calls = 1 if name == "meanflow-nusc" else VIEWER_REQUEST_STEPS
            check_launches(f"viewer {name}", launches, PER_CALL[name], calls)
            depth = np.asarray(frame["depth"])
            check(depth.shape == (32, 1024) and bool(np.isfinite(depth).all()), f"viewer {name}: depth {depth.shape}")
            out[name] = {"seconds": seconds, "points": len(frame["points"]), "launches": launches}
            by_path[f"viewer {name}"] = {k: n for k, n in launches.items() if n}
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=60)
    emit({"phase": "viewer", "card": smi, "steps": VIEWER_REQUEST_STEPS, "requests": out})
    return by_path



# ------------------------------------------------------------------ phase 18


SP = 2  # ranks that split the azimuth in phase 18, on the one card
# phase 18's runs: the full paths (a forward and a DDIM@2 sample in float32
# and bfloat16, then train.py --sp 2 against one process), one forward in
# each dtype of the other sp-aware denoisers, and the two branches under
# train.py --sp 2 (their ranks replicate); one pair of ranks a tuple of
# SP_PAIRS, every pair at once
SP_CONFIGS = ("nuscenes-unet-uncond", "nuscenes-auto-reg-v2", "nuscenes-box-layout", "nuscenes-hdit-uncond")
SP_FORWARD = ("nuscenes-box-layout-v6 glide", "openai_unet", "discrete")
SP_BRANCHES = ("nuscenes-layout", "nuscenes-object")
# MeanFlow: forwards, the loss's tangent du/dt along (v, 1, 0), the one-step
# sample and train.py --sp 2, its exchanges carrying the tangent; on the
# pair of SP_FORWARD, after its three forwards (the pair that ends first)
SP_FLOW = "meanflow-nusc"
SP_PAIRS = tuple((name,) for name in SP_CONFIGS) + (SP_FORWARD + (SP_FLOW,), SP_BRANCHES)
SP_FLOW_TIMES = ((0.8, 0.1), (0.45, 0.45))  # (t, r) of the two images: a mean velocity and an r = t one
SP_BATCH, SP_STEPS, SP_TRAIN_STEPS = 2, 2, 2  # images; DDIM steps of the sample; train steps
SP_DISCRETE_STEPS = 1000  # the discrete engine's table (the registry leaves it unset)
SP_POINTS = 8000  # points a cloud of the phase's synthetic tree (only B=2 x 2 steps read it)
SP_FRAME_RTOL = {"float32": FORWARD_RTOL, "bfloat16": BF16_FORWARD_RTOL}  # sp vs one process, of max |one|
# The DDIM@2 sample is an ill-conditioned function of the denoiser's output:
# its first step's x̂_0 = (x − σε)/α at t = 1 multiplies ε's rounding by
# σ/α ≈ 1800 on the pixels that it leaves inside the clip (a few per 10^4),
# so two sums of the GroupNorm statistics in another order move those
# pixels by ~1e-3 in float32 and flip some from one clip side to the other
# in bfloat16 (the CPU control in tests/test_torch_port_sp.py: with the
# statistics summed as in one process the sample is equal bit for bit).
# float32: at least 99.9% of the values within SP_FRAME_RTOL, and the norm
# of the difference within SP_FRAME_RTOL of the sample's; bfloat16: the
# sample on the mesh at most 1.5 times as far from the float32 sample (in
# norm) as the one-process bfloat16 sample is.  cuBLAS picks a product's
# kernel, and with it the order of its sums, by the product's shape, so a
# shard's rows and the whole map round apart as a batch of 2 and its rows
# one at a time do in one process (HDiT's linears and neighbourhood
# products: up to 1.3e-5 apart, and its float32 sample at B=2 against its
# rows one at a time 99.71% within the limit): the float32 share is
# SP_SAMPLE_SHARE, or the one-process batch-against-rows share where that
# is lower (the mesh may round no further from one process than a batch's
# shape already does)
SP_SAMPLE_SHARE, SP_BF16_SAMPLE_FACTOR = 0.999, 1.5
SP_LOSS_RTOL, SP_PARAM_RTOL = 1e-5, 1e-4
SP_NICE = 10  # the phase's processes run beside phases 12 and 17, which keep their priority


def sp_build(name: str, device):
    """The modules (seeded weights), engine and config of a phase-18 run: a
    registry config, ``nuscenes-box-layout-v6 glide`` (GLIDE blocks),
    ``discrete`` (the uncond stack under ``DiscreteDiffusion``),
    ``openai_unet`` (phase 14's ``OpenAIUNet``: no engine, no config) or
    ``meanflow-nusc`` (``MFEfficientUNet`` under ``MeanFlow``)."""
    from lidarcrafter_tpu_torch.configs import get_config
    from lidarcrafter_tpu_torch.models import build_model
    from lidarcrafter_tpu_torch.training.factory import build_diffusion_training, build_flow_training
    from lidarcrafter_tpu_torch.weights import init_random_

    if name == SP_FLOW:
        cfg = get_config(name)
        model, engine, _ = build_flow_training(cfg, device)
        return {"model": init_random_(model, 30)}, engine, cfg
    if name == "openai_unet":
        return {"model": init_random_(build_model("openai_unet", **OPENAI_UNET), 30).eval().to(device)}, None, None
    cfg = glide_cfg() if name.endswith(" glide") else get_config("nuscenes-unet-uncond" if name == "discrete" else name)
    if name == "discrete":
        cfg.diffusion.timestep_type, cfg.diffusion.num_training_steps = "discrete", SP_DISCRETE_STEPS
    models, engine, _ = build_diffusion_training(cfg, device)
    mods = models if isinstance(models, dict) else {"model": models}
    for i, k in enumerate(sorted(mods)):
        init_random_(mods[k], 30 + i)
    return mods, engine, cfg


def sp_paths(name: str, device, mesh=None) -> tuple[dict, dict, dict]:
    """One forward (the engine's ``denoise`` at log-SNR (-3, 5), the
    discrete engine's at steps (10, 900), ``OpenAIUNet`` on times (-3, 5),
    MeanFlow's model at ``SP_FLOW_TIMES``) and, for ``SP_CONFIGS``, a DDIM@2
    sample of ``name`` (MeanFlow: its one-step sample, and in float32 the
    tangent du/dt along (v, 1, 0) of its loss) at full width, B=2, seeded
    weights and inputs, in float32 and then served in bfloat16, on
    ``device``; on ``mesh`` each rank takes its share (rows over ``dp``,
    columns over ``sp``) and the results are gathered; in one process the
    float32 sample again with the batch's rows one at a time.  Returns the outputs
    (on the CPU), each path's launches (counters set to 0 just before it,
    read just after; on a mesh also its ``exchanges``) and those a denoiser
    call makes at sp > 1 (:func:`sp_per_call`)."""
    import torch

    from lidarcrafter_tpu_torch.diffusion.conditional import AZIMUTH_KEYS
    from lidarcrafter_tpu_torch.parallel.mesh import batch_sharding
    from lidarcrafter_tpu_torch.precision import to_serving_dtype_

    mods, engine, cfg = sp_build(name, device)
    H, W = OPENAI_UNET["resolution"] if cfg is None else cfg.data.resolution
    gen = torch.Generator(device=device).manual_seed(31)
    x = torch.randn(SP_BATCH, H, W, 2, generator=gen, device=device)
    x_T = torch.randn(SP_BATCH, H, W, 2, generator=gen, device=device)
    t = torch.tensor([10, 900], device=device) if name == "discrete" else torch.tensor([-3.0, 5.0], device=device)
    flow = name == SP_FLOW
    if flow:
        t, r = (torch.tensor(v, device=device) for v in zip(*SP_FLOW_TIMES))
        v = torch.randn(SP_BATCH, H, W, 2, generator=gen, device=device)
    batch = None if flow or cfg is None or cfg.condition_model is None else condition_batch(cfg, SP_BATCH, gen, device)
    sharding = batch_sharding(mesh, 4, sp_axis=2) if mesh is not None else None
    outs, launches = {}, {}

    def run(what, fn):
        torch.cuda.synchronize()
        counters = reset_counters()
        exchanges = 0 if mesh is None else mesh.exchanges
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        outs[what] = out.float().cpu()
        launches[what] = {k: c.n for k, c in counters.items()}
        launches[what]["seconds"] = time.perf_counter() - t0
        if mesh is not None:
            launches[what]["exchanges"] = mesh.exchanges - exchanges

    def shares():
        """x, t, r and v as this rank holds them (all of them in one process)."""
        if mesh is None:
            return x, t, r if flow else None, v if flow else None
        rows = batch_sharding(mesh, 1)
        return (sharding.cut(x), rows.cut(t), rows.cut(r) if flow else None,
                sharding.cut(v) if flow else None)

    def tangent():
        """du/dt along (v, 1, 0), the MeanFlow loss's jvp (float32)."""
        xs, ts, rs, vs = shares()
        with torch.no_grad(), contextlib.nullcontext() if mesh is None else mesh.active():
            _, out = torch.func.jvp(mods["model"], (xs, ts, rs), (vs, torch.ones_like(ts), torch.zeros_like(rs)))
        return out if mesh is None else sharding.gather(out)

    def forward(eng, dtype):
        xs, ts, rs, _ = shares()
        b = batch
        if mesh is not None:
            b = None if batch is None else mesh.cut_batch(batch, AZIMUTH_KEYS)
        with torch.inference_mode(), contextlib.nullcontext() if mesh is None else mesh.active():
            if flow:
                out = mods["model"](xs.to(dtype), ts.to(dtype), rs.to(dtype)).float()
            elif eng is None:
                out = mods["model"](xs.to(dtype), {"time_condition": ts}).float()
            elif name == "discrete":
                out = eng.denoise(xs, ts)
            else:
                out = eng.denoise(xs, ts, None if b is None else eng.get_network_condition(b))
        return out if mesh is None else sharding.gather(out)

    def sample(eng):
        if flow:
            return eng.sample(z=x_T, mesh=mesh)
        args = () if batch is None else ((batch if mesh is None else mesh.cut_batch(batch, AZIMUTH_KEYS)),)
        return eng.sample(*args, SP_BATCH, SP_STEPS, mode="ddim", x_T=x_T, mesh=mesh)

    def sample_rows(eng):
        if flow:
            return torch.cat([eng.sample(z=x_T[i:i + 1]) for i in range(SP_BATCH)])
        return torch.cat([eng.sample(*(() if batch is None else ({k: v[i:i + 1] for k, v in batch.items()},)), 1,
                                     SP_STEPS, mode="ddim", x_T=x_T[i:i + 1]) for i in range(SP_BATCH)])

    sampled = sp_sample_path(name)
    for dname, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        if dtype == torch.bfloat16:
            to_serving_dtype_(mods["model"], dtype, cond_model=mods.get("cond"))
            engine = None if engine is None else dataclasses.replace(engine, dtype=dtype)
        run(f"forward {dname}", lambda: forward(engine, dtype))
        if flow and dtype == torch.float32:
            run(f"tangent {dname}", tangent)
        if sampled:
            run(f"{sampled} {dname}", lambda: sample(engine))
        if sampled and mesh is None and dtype == torch.float32:  # the batch's rows one at a time
            run(f"{sampled} {dname} rows", lambda: sample_rows(engine))
    per_call = sp_per_call(mods["model"])
    del mods, engine
    torch.cuda.empty_cache()
    return outs, launches, per_call


def sp_sample_path(name: str) -> str | None:
    """The sample phase 18 draws of ``name``: DDIM@2, MeanFlow's one step,
    or none (``SP_FORWARD``, the branches)."""
    if name == SP_FLOW:
        return "meanflow@1"
    return f"ddim@{SP_STEPS}" if name in SP_CONFIGS else None


def sp_train_args(name: str, tree: dict, out_dir: Path, sp: int) -> list:
    """``train.py`` for ``SP_TRAIN_STEPS`` float32 steps at B=2 from the
    synthetic tree (the layout branch with its CLIP cache, the object
    branch on the GT database), deterministic, checkpointing the last step;
    ``--sp`` with ``sp`` > 1."""
    data = ["--set", f'data.data_root="{tree["data_root"]}"', "--set",
            f'data.pkl_path="{tree["db_path" if name == "nuscenes-object" else "pkl_path"]}"']
    if name == "nuscenes-layout":
        data += ["--set", f'data.clip_cache_dir="{tree["clip_cache_dir"]}"']
    args = ["-c", name, "-b", str(SP_BATCH), "--num-steps", str(SP_TRAIN_STEPS), "--workers", "2",
            "--log-every", "1", "--checkpoint-every", str(SP_TRAIN_STEPS), "--deterministic",
            "--set", 'training.mixed_precision="no"', "--set", "training.steps_save_image=0", *data,
            "--output-dir", str(out_dir)]
    if sp > 1:
        args += ["--sp", str(sp)]
    return args


def sp_train(name: str, tree: dict, out_dir: Path, sp: int, parallel=None) -> dict:
    """``train.main`` of :func:`sp_train_args` in this process (in the
    group ``parallel``): the step records it printed, its seconds and its
    launches (counters set to 0 just before it)."""
    import ast

    import torch

    from lidarcrafter_tpu_torch import train as train_cli

    text = io.StringIO()
    counters = reset_counters()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(text):
        train_cli.main(sp_train_args(name, tree, out_dir / name, sp), parallel=parallel)
    torch.cuda.synchronize()
    return {"records": [ast.literal_eval(ln) for ln in text.getvalue().splitlines() if ln.startswith("{'step'")],
            "seconds": time.perf_counter() - t0, "launches": {k: c.n for k, c in counters.items()}}


def sp_file(out_dir: Path, side: str, name: str) -> Path:
    return out_dir / f"{side}-{name.replace(' ', '_')}.pt"


def sp_rank_main(out_dir: Path, names: list) -> int:
    """A rank of phase 18 (``chip_smoke.py sp-rank DIR NAME...`` under
    ``torchrun --nproc-per-node 2``): both ranks on card 0, a gloo group on
    an (1, SP) mesh; for each name in turn :func:`sp_paths` and / or
    ``train.main`` with ``--sp`` on the same group; each rank writes its
    results to ``DIR/sp_rank{r}-NAME.pt``."""
    import torch

    lane_setup()
    from lidarcrafter_tpu_torch.parallel.ddp import DataParallel

    # every rank on card 0 (``DataParallel.from_env`` would take card
    # LOCAL_RANK), over gloo: NCCL takes one rank a card
    torch.cuda.set_device(0)
    group = DataParallel.join(int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]), "cuda:0", "env://",
                              backend="gloo", sp=SP)
    tree = json.loads((out_dir / "tree.json").read_text())
    try:
        for name in names:
            result = {"rank": group.rank, "device": str(group.device)}
            if name not in SP_BRANCHES:
                result["paths"] = sp_paths(name, group.device, group.mesh)
            if name not in SP_FORWARD:
                result["train"] = sp_train(name, tree, out_dir / "sp", SP, parallel=group)
            torch.save(result, sp_file(out_dir, f"sp_rank{group.rank}", name))
    finally:
        group.leave()
    return 0


def sp_one_main(out_dir: Path, what: str, names: list) -> int:
    """Phase 18 in one process (``chip_smoke.py sp-one DIR paths|train
    NAME...``): :func:`sp_paths` or the train CLI of each name in turn on
    card 0, each written to ``DIR/one-{what}-NAME.pt``."""
    import torch

    lane_setup()
    tree = json.loads((out_dir / "tree.json").read_text())
    for name in names:
        result = sp_paths(name, DEVICE) if what == "paths" else sp_train(name, tree, out_dir / "one", 1)
        torch.save(result, sp_file(out_dir, f"one-{what}", name))
    return 0


def sp_per_call(model) -> dict:
    """Kernel launches a denoiser call of ``model`` makes at sp > 1: two
    GroupNorm launches (partials, apply) a norm of image activations, one
    a norm of the tokens every rank holds whole (OACA's layout and
    positional strips); every OACA over gathered keys; the attention
    blocks (over gathered keys) as in one process."""
    from lidarcrafter_tpu_torch.models.ops import FusedGN

    per_call = kernel_modules(model)
    spatial = sum(m.spatial for m in model.modules() if isinstance(m, FusedGN))
    return {"oaca": per_call["oaca"], "oaca_gathered": per_call["oaca"], "groupnorm": per_call["groupnorm"] - spatial,
            "groupnorm_partials": spatial, "groupnorm_apply": spatial, "attention": per_call["attention"]}


def sp_check_paths(name: str, ranks: list, want: dict, one_launches: dict, by_path: dict) -> dict:
    """Phase 18's paths of ``name``: each rank's launches exact, the
    gathered forwards and samples against one process's."""
    import torch

    outs, launches, per_call = ranks[0]["paths"]
    lines = {}
    for what in (w for w in want if not w.endswith(" rows")):
        path, dname = what.rsplit(" ", 1)
        calls = SP_STEPS if what.startswith("ddim") else 1
        for r in ranks:
            got_launches = r["paths"][1][what]
            for k in per_call:
                check(got_launches[k] == per_call[k] * calls,
                      f"sp {name} {what} rank {r['rank']}: {k} launches {got_launches[k]} != {per_call[k]} x {calls}")
        got = outs[what]
        scale = float(want[what].abs().max())
        diff = (got - want[what]).abs()
        err, norm_rel = float(diff.max()), float(diff.norm() / want[what].norm())
        within = float((diff <= SP_FRAME_RTOL[dname] * scale).float().mean())
        extra = {}
        check(bool(torch.isfinite(got).all()) and got.shape == want[what].shape, f"sp {name} {what}: shape")
        if path in ("forward", "tangent"):
            check(err <= SP_FRAME_RTOL[dname] * scale,
                  f"sp {name} {what}: max |sp - one| {err:.3g} > {SP_FRAME_RTOL[dname]} x {scale:.3g}")
        elif dname == "float32":
            rows = want[f"{what} rows"]  # one process, the batch's rows one at a time
            rows_within = float(((rows - want[what]).abs() <= SP_FRAME_RTOL[dname] * scale).float().mean())
            share = min(SP_SAMPLE_SHARE, rows_within)
            extra = {"one_process_rows_share_within_tol": rows_within, "share_limit": share,
                     "one_process_rows_max_abs_err": float((rows - want[what]).abs().max()),
                     "seconds_one_rows": one_launches[f"{what} rows"]["seconds"]}
            check(within >= share and norm_rel <= SP_FRAME_RTOL[dname],
                  f"sp {name} {what}: {within:.5f} of the values within {SP_FRAME_RTOL[dname]} of the "
                  f"largest (limit {share:.5f}), norm-relative difference {norm_rel:.3g}")
        else:
            f32 = f"{path} float32"
            spread = float((want[what] - want[f32]).norm())
            extra = {"norm_rel_to_float32_sample": float((got - want[f32]).norm() / want[f32].norm()),
                     "one_process_norm_rel_to_float32_sample": spread / float(want[f32].norm())}
            check(float((got - want[f32]).norm()) <= SP_BF16_SAMPLE_FACTOR * spread,
                  f"sp {name} {what}: farther from the float32 sample than {SP_BF16_SAMPLE_FACTOR} x the "
                  f"one-process bfloat16 sample")
        lines[what] = {"max_abs_err": err, "scale": scale, "rel_err": err / scale,
                       "tol": SP_FRAME_RTOL[dname], "share_within_tol": within,
                       "norm_rel_err": norm_rel, **extra,
                       "seconds_sp": launches[what]["seconds"], "seconds_one": one_launches[what]["seconds"],
                       "exchanges_per_rank": launches[what]["exchanges"],
                       "launches_sp_per_rank": {k: launches[what][k] for k in per_call},
                       "launches_one": {k: v for k, v in one_launches[what].items() if k != "seconds"}}
        by_path[f"sp={SP} {name} {what}"] = {k: launches[what][k] * SP for k in per_call if launches[what][k]}
    return {"per_call_sp": per_call, "paths": lines}


def sp_check_train(name: str, tmp: Path, ranks: list, one: dict, per_step: dict, by_path: dict) -> dict:
    """Phase 18's train runs of ``name``: the losses, the parameters and
    Adam's first moments after the steps against one process's, and each
    rank's launches exact (``per_step``: the forward of each step; the
    backward launches nothing)."""
    import torch

    sp_records = ranks[0]["train"]["records"]
    losses, one_losses = [r["loss"] for r in sp_records], [r["loss"] for r in one["records"]]
    check(len(losses) == len(one_losses) == SP_TRAIN_STEPS, f"sp {name}: losses {losses} / {one_losses}")
    for a, b in zip(losses, one_losses):
        check(abs(a - b) <= SP_LOSS_RTOL * max(1.0, abs(b)), f"sp {name}: loss {a} != {b}")
    ckpt = f"ckpt_{SP_TRAIN_STEPS:010d}"
    sp_state, one_state = (torch.load(tmp / side / name / ckpt / "state.pt", weights_only=True, mmap=True)
                           for side in ("sp", "one"))
    param_err = flat_rel(sp_state["models"], one_state["models"])
    mu_err = flat_rel(sp_state["opt_state"]["mu"], one_state["opt_state"]["mu"])
    check(param_err <= SP_PARAM_RTOL, f"sp {name}: parameters after the steps {param_err:.3g} rel L2")
    check(mu_err <= SP_PARAM_RTOL, f"sp {name}: Adam's first moments {mu_err:.3g} rel L2")
    train_launches = [r["train"]["launches"] for r in ranks]
    for r, got in zip(ranks, train_launches):
        check(got == with_zeros({k: n * SP_TRAIN_STEPS for k, n in per_step.items()}, got),
              f"sp {name} train rank {r['rank']}: launches {got} != {per_step} x {SP_TRAIN_STEPS}")
    if any(train_launches[0].values()):
        by_path[f"sp={SP} {name} train"] = {k: v * SP for k, v in train_launches[0].items() if v}
    # one process: a sharded norm's two launches are one, OACA's keys its own
    one_step = {k: n for k, n in per_step.items() if k not in ("oaca_gathered", "groupnorm_partials",
                                                               "groupnorm_apply")}
    one_step["groupnorm"] = per_step.get("groupnorm", 0) + per_step.get("groupnorm_partials", 0)
    got = one["launches"]
    check(got == with_zeros({k: n * SP_TRAIN_STEPS for k, n in one_step.items()}, got),
          f"sp {name} train one process: launches {got} != {one_step} x {SP_TRAIN_STEPS}")
    if any(got.values()):
        by_path[f"sp {name} train one process"] = {k: v for k, v in got.items() if v}
    return {"losses_sp": losses, "losses_one": one_losses, "param_rel_l2": param_err, "first_moment_rel_l2": mu_err,
            "step_seconds_sp_ranks": step_seconds(sp_records), "step_seconds_one_process": step_seconds(one["records"]),
            "seconds_sp_run": ranks[0]["train"]["seconds"], "seconds_one_run": one["seconds"],
            "launches_per_rank": train_launches[0]}


class Background:
    """Processes that run beside the main sequence of phases (phases 17 and
    18 beside 12), each in a session of its own: :meth:`start` one (a
    thread notes its seconds from the first start to its end), :meth:`wait`
    for some (a non-zero exit fails with the tail of its log), :meth:`stop`
    kills whatever still runs, so that a failed check leaves no process
    behind."""

    def __init__(self, tmp: Path):
        self.tmp, self.procs, self.logs, self.ends = tmp, {}, {}, {}
        self.t0 = time.perf_counter()

    def start(self, key: str, args: list, nice: int = 0) -> None:
        self.logs[key] = self.tmp / f"log-{len(self.logs)}.txt"
        with open(self.logs[key], "w") as log:
            self.procs[key] = subprocess.Popen(
                ["nice", "-n", str(nice), sys.executable, *args], env=dict(os.environ, PYTHONPATH=str(REPO)),
                cwd=REPO, stdout=log, stderr=subprocess.STDOUT, text=True, start_new_session=True)
        threading.Thread(target=self._watch, args=(key,), daemon=True).start()

    def _watch(self, key: str) -> None:
        self.procs[key].wait()
        self.ends[key] = time.perf_counter() - self.t0

    def wait(self, keys: list, limit: float) -> dict:
        while True:
            for key in keys:
                if key in self.ends:
                    code = self.procs[key].returncode
                    check(code == 0, f"{key}: exit {code}\n{self.logs[key].read_text()[-6000:]}")
            if all(key in self.ends for key in keys):
                return {key: self.ends[key] for key in keys}
            check(time.perf_counter() - self.t0 < limit,
                  f"not done in {limit} s: {[key for key in keys if key not in self.ends]}")
            time.sleep(0.5)

    def stop(self) -> None:
        for proc in self.procs.values():
            if proc.poll() is None:  # the session: torchrun's ranks with it
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()


def lane_setup() -> None:
    """A process of phases 17 and 18 beside the main one: float32 without
    TF32, as the main process runs it; the kernels loaded."""
    import torch

    sys.path.insert(0, str(REPO))
    from lidarcrafter_tpu_torch.kernels import loader

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    loader.load_kernels()


def export_lane_main(out_dir: Path) -> int:
    """Phase 17 in a process of its own (``chip_smoke.py export-lane
    DIR``): :func:`phase_export`, its launch counts by path written to
    ``DIR/export.json``."""
    lane_setup()
    by_path = phase_export(nvidia_smi_line())
    (out_dir / "export.json").write_text(json.dumps(by_path))
    return 0


def export_start(bg: Background) -> str:
    bg.start("export", [str(REPO / "chip_smoke.py"), "export-lane", str(bg.tmp)])
    return "export"


def export_finish(bg: Background, key: str) -> dict:
    """Waits for phase 17's process, prints its lines and returns its
    launch counts by path."""
    ends = bg.wait([key], 1000)
    for line in bg.logs[key].read_text().splitlines():
        if line.startswith('{"phase": "export"'):
            print(line, flush=True)
    emit({"phase": "export", "check": "process", "seconds_to_the_end": ends[key]})
    return json.loads((bg.tmp / "export.json").read_text())


def sp_start(bg: Background) -> list:
    """Phase 18's processes, started in ``bg`` at nice ``SP_NICE``: a
    synthetic nuScenes tree, then a pair of ranks for each tuple of
    ``SP_PAIRS`` (``torchrun --nproc-per-node 2`` of ``chip_smoke.py
    sp-rank``) and the one-process paths and train CLIs (``sp-one``), every
    one at once; returns their keys."""
    from lidarcrafter_tpu_torch.utils.synthetic import write_nuscenes_tree

    tmp = bg.tmp / "sp"
    tmp.mkdir()
    tree = write_nuscenes_tree(tmp / "nusc", num_points=SP_POINTS, seed=18)
    (tmp / "tree.json").write_text(json.dumps(tree))
    keys = []
    for names in SP_PAIRS:
        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            port = sock.getsockname()[1]
        keys.append(f"ranks: {', '.join(names)}")
        bg.start(keys[-1], ["-m", "torch.distributed.run", "--nproc-per-node", str(SP), "--master-addr",
                            "localhost", "--master-port", str(port), str(REPO / "chip_smoke.py"), "sp-rank",
                            str(tmp), *names], nice=SP_NICE)
    for what, names in (("paths", SP_CONFIGS + (SP_FLOW,) + SP_FORWARD), ("train", SP_CONFIGS + (SP_FLOW,) + SP_BRANCHES)):
        keys.append(f"one process {what}")
        bg.start(keys[-1], [str(REPO / "chip_smoke.py"), "sp-one", str(tmp), what, *names], nice=SP_NICE)
    return keys


def phase_sp(smi: str, bg: Background, keys: list) -> dict:
    """Phase 18 ("sp"): the azimuth axis on the card.  Two ranks share card 0
    over gloo (NCCL takes one rank a card) on an (1, 2) mesh, one pair for
    each tuple of ``SP_PAIRS``, every pair at once, beside two processes
    running the one-process paths and train CLIs in turn (all on card 0,
    started by :func:`sp_start` beside phases 12 and 17; the seconds are no
    speed comparison).  At full width, B=2, seeded weights: ``SP_CONFIGS``
    (uncond, auto-reg-v2, v0, HDiT) one forward and a DDIM@2 sample in
    float32 and served in bfloat16, gathered, against the same in one
    process, then ``train.py --sp 2 --deterministic`` for 2 float32 steps
    from a synthetic nuScenes tree against the same command in one process;
    ``SP_FORWARD`` (GLIDE v6, ``OpenAIUNet``, the discrete engine) one
    forward in each dtype; ``SP_BRANCHES`` (layout, object) the train runs
    alone, their ranks replicating.  Forwards to ``SP_FRAME_RTOL`` of the
    largest, samples as ``SP_SAMPLE_SHARE`` says, losses to 1e-5, the
    parameters after the steps and Adam's first moments to 1e-4 relative
    L2, exact launches on each rank."""
    import torch

    t_phase = time.perf_counter()
    ends = bg.wait(keys, 1000)
    tmp, by_path = bg.tmp / "sp", {}

    def load(side, name):
        return torch.load(sp_file(tmp, side, name), weights_only=False)

    for name in SP_CONFIGS + (SP_FLOW,) + SP_FORWARD + SP_BRANCHES:
        line = {"phase": "sp", "config": name, "card": smi, "sp": SP, "ranks_on_one_card": SP,
                "backend": "gloo", "batch": SP_BATCH}
        ranks, per_call = [load(f"sp_rank{r}", name) for r in range(SP)], None
        if name not in SP_BRANCHES:
            want, one_launches, per_call = load("one-paths", name)
            line |= sp_check_paths(name, ranks, want, one_launches, by_path)
        if name not in SP_FORWARD:
            per_step = BRANCH_PER_STEP[name] if name in SP_BRANCHES else per_call
            line["train"] = sp_check_train(name, tmp, ranks, load("one-train", name), per_step, by_path)
        emit(line)
    emit({"phase": "sp", "check": "runs", "card": smi, "nice": SP_NICE, "beside": ["ingest", "export"],
          "devices": [r["device"] for r in ranks], "seconds_to_the_end": ends})
    emit({"phase": "sp", "check": "phase seconds", "card": smi, "seconds": time.perf_counter() - t_phase})
    return by_path


def step_seconds(records: list) -> list:
    """Each step's wall seconds, from the trainer's running means
    (``sec_per_step`` of step n averages steps 1..n)."""
    means = [r["sec_per_step"] for r in records]
    return [n * m - (n - 1) * p for n, (m, p) in enumerate(zip(means, [0.0] + means), start=1)]


def flat_rel(a, b) -> float:
    """‖a − b‖ / ‖b‖ over every tensor of two matching nests (dicts of
    state dicts, or lists), flattened."""
    import torch

    def leaves(t):
        if isinstance(t, dict):
            return [x for k in sorted(t) for x in leaves(t[k])]
        if isinstance(t, (list, tuple)):
            return [x for v in t for x in leaves(v)]
        return [t.float().flatten()]

    fa, fb = torch.cat(leaves(a)), torch.cat(leaves(b))
    return float((fa - fb).norm() / fb.norm())


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; the port runs on the card", file=sys.stderr)
        return 2
    if not (REPO / "lidarcrafter_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: no lidarcrafter_tpu_torch package beside {__file__}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from lidarcrafter_tpu_torch.kernels import loader

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    t0 = time.perf_counter()
    loaded = loader.load_kernels()  # builds, loads and runs the x·2 probe (raises on failure)
    load_s = time.perf_counter() - t0
    check(loader.probe_launches.n == 1, f"the probe ran {loader.probe_launches.n} times at load")
    ptxas = [ln.strip() for ln in loaded.ptxas_log.splitlines() if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "card": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
          "nvcc_seconds": loaded.build_seconds, "load_and_probe_seconds": load_s,
          "probe": "x*2 ok", **probe_times(loaded), "ptxas": ptxas})
    hopper = hopper_ptxas(loaded.ptxas_log)
    if "== attention.cu" in loaded.ptxas_log and "== oaca.cu" in loaded.ptxas_log:  # built in this process
        check(len(hopper) == HOPPER_KERNELS,
              f"{len(hopper)} Hopper-core kernels in the ptxas log, not {HOPPER_KERNELS} (13 attention, 7 OACA)")
    emit({"phase": "build", "check": "Hopper core kernels (ptxas -v)", "kernels": hopper, **check_plans(),
          "dynamic_smem": hopper_smem()})

    marks, last = {}, [t0]

    def phase_done(name: str) -> None:
        """The seconds since the last mark (the build's: since it began), on
        a line of their own."""
        now = time.perf_counter()
        marks[name], last[0] = now - last[0], now
        emit({"phase": name, "check": "phase seconds", "seconds": marks[name]})

    phase_done("build")
    rows = phase_kernels()
    phase_done("kernels")
    phase_forward_parity("nuscenes-box-layout-v6")
    phase_unet_forward_parity("nuscenes-unet-uncond")
    phase_done("forward_parity")
    counts = {
        "nuscenes-box-layout-v6": {"oaca": OACA_PER_FORWARD, "groupnorm": GN_PER_FORWARD},
        "nuscenes-unet-uncond": {"attention": ATTN_PER_UNET, "groupnorm": GN_PER_UNET},
        "meanflow-nusc": {"attention": ATTN_PER_UNET, "groupnorm": GN_PER_UNET},
    }
    # float32: DDIM@25 + DPM++@15 (MeanFlow one step); bfloat16: one DPM++@15
    # request (MeanFlow one step) per path, served by its own generators
    requests = {
        "float32": {name: (("meanflow", 1),) if name == "meanflow-nusc" else REQUESTS for name in counts},
        "bfloat16": {name: (("meanflow", 1),) if name == "meanflow-nusc" else (("dpmpp_2m", 15),)
                     for name in counts},
    }
    by_path = {}
    for dname, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        gens = build_generators(dtype)
        for name in counts:
            by_path[f"{name} {dname}"] = phase_main_path(name, gens[name], counts[name],
                                                         requests[dname][name], smi)
        calls = profile_calls(gens["nuscenes-box-layout-v6"], gens["nuscenes-unet-uncond"])
        for path, norms in (("layout", GN_PER_FORWARD), ("uncond", GN_PER_UNET)):
            phase_profile(f"one denoiser call ({path}, predict_x_0), B=8, {dname}", calls[path], smi,
                          expect={"groupnorm kernel": norms})
        del gens, calls
        torch.cuda.empty_cache()
        if dtype == torch.float32:
            by_path.update(phase_viewer(smi))
        phase_done(f"main_path and profile {dname}")
        by_path[f"rollout {dname}"], frames = phase_rollout(dtype, smi)
        if dtype == torch.float32:
            rollout_frames = frames  # phase 10 evaluates them
        del frames
        torch.cuda.empty_cache()
        phase_done(f"rollout {dname}")
    backward_rows, train_paths = phase_train(smi)
    by_path.update(train_paths)
    phase_done("train")
    by_path["layout nuscenes-layout float32"] = phase_layout(smi)
    phase_object(smi)
    phase_done("layout and object")
    jvp_rows, branch_paths = phase_branch_train(smi)
    by_path.update(branch_paths)
    phase_done("branch_train")
    phase_evaluate(rollout_frames, smi)
    phase_done("evaluate")
    # the phases that time kernels, steps or calls first; then phases 17 and
    # 18 in processes of their own beside phase 12 (host-bound conversions)
    registry_rows, registry_paths = phase_registry(smi)
    by_path.update(registry_paths)
    phase_done("registry")
    by_path.update(phase_data(smi))
    phase_done("data")
    detections = phase_sparse(rollout_frames, smi)
    phase_done("sparse")
    phase_objects(rollout_frames, detections, smi)
    phase_done("objects")
    by_path.update(phase_zoo(smi))
    phase_done("zoo")
    with tempfile.TemporaryDirectory() as bg_dir:
        bg = Background(Path(bg_dir))
        try:
            export_key, sp_keys = export_start(bg), sp_start(bg)
            phase_done("start export and sp")
            by_path.update(phase_ingest(smi))
            phase_done("ingest")
            by_path.update(export_finish(bg, export_key))
            phase_done("export")
            by_path.update(phase_sp(smi, bg, sp_keys))
            phase_done("sp")
        finally:
            bg.stop()
    emit({"phase": "script", "check": "seconds by phase", "seconds": marks, "total_seconds": time.perf_counter() - t0})

    # each kernel at its largest main-path shape, float32 (the default serving
    # dtype) with its bfloat16 numbers beside, and its launches summed over
    # the paths and dtypes that run it
    sources = {
        "oaca": ("lidarcrafter_tpu_torch/csrc/oaca.cu", "lidarcrafter_tpu/ops/pallas_attention.py:183"),
        "groupnorm": ("lidarcrafter_tpu_torch/csrc/groupnorm.cu", "lidarcrafter_tpu/ops/pallas_groupnorm.py:49"),
        "attention": ("lidarcrafter_tpu_torch/csrc/attention.cu", "lidarcrafter_tpu/ops/pallas_attention.py:40"),
    }
    kernels = []
    backward_keys = ("ms", "plain_ms", "library_ms", "library", "bound_ms", "bound_by", "max_abs_err", "rel_err",
                     "norm_rel_err", "shape", "route")
    sub_keys = ("shape", "dtype", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "max_abs_err", "rel_err",
                "norm_rel_err", "route")
    for k, (source, replaces) in sources.items():
        first = next(r for r in rows if r["kernel"] == k and r["dtype"] == "float32")
        bf16 = next(r for r in rows if r["kernel"] == k and r["dtype"] == "bfloat16"
                    and r["shape"] == first["shape"])
        bwd = {d: next(r for r in backward_rows if r["kernel"].split()[0] == k and r["dtype"] == d)
               for d in ("float32", "bfloat16")}
        paths = {p: n[k] for p, n in by_path.items() if k in n}
        check(all(n > 0 for n in paths.values()), f"{k}: a path that runs it did not launch it: {paths}")
        jvp = {d: next((r for r in jvp_rows if r["kernel"] == k and r["dtype"] == d), None)
               for d in ("float32", "bfloat16")}
        kernels.append({
            "name": k, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(paths.values()), "launches_by_path": paths,
            "max_abs_err": first["max_abs_err"], "tol": first["tol"], "norm_rel_err": first["norm_rel_err"],
            "ms": first["ms"],
            "plain_ms": first["plain_ms"], "bound_ms": first["bound_ms"], "bound_by": first["bound_by"],
            "library_ms": first["library_ms"], "shape": first["shape"], "dtype": "float32",
            "core_route": first["route"],
            "bf16": {key: bf16[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                                "max_abs_err", "tol", "norm_rel_err", "route")},
            "backward": {key: bwd["float32"][key] for key in backward_keys}
            | {"bf16": {key: bwd["bfloat16"][key] for key in backward_keys}},
            # OACA's second instantiation, head dims 64 (the v0 stack)
            **({"head_dims_64": {d: {key: r[key] for key in ("shape", "ms", "plain_ms", "bound_ms", "bound_by",
                                                              "library_ms", "max_abs_err", "norm_rel_err", "route")}
                                 for d in ("float32", "bfloat16") for r in rows
                                 if r["kernel"] == k and r.get("head_dims") == [64, 64, 64] and r["dtype"] == d
                                 and "ds4" in r["shape"]}} if k == "oaca" else {}),
            # the forward-mode route, where a path takes one (OACA has none)
            "jvp": None if jvp["float32"] is None else {key: jvp["float32"][key] for key in backward_keys}
            | {"bf16": {key: jvp["bfloat16"][key] for key in backward_keys}},
            # phase 2: the GLIDE shapes (attention), positional head dims 16
            # and 64 (OACA); phase 14: the wide heads; float32 and bfloat16
            **{sub: [{key: r[key] for key in sub_keys} for r in rows + registry_rows
                     if r["kernel"] == k and r.get("sub") == sub]
               for sub in {r["sub"] for r in rows + registry_rows if r["kernel"] == k and "sub" in r}},
        })
    # the azimuth-sharded launches (phase 18's two ranks; phase 2's rows at
    # rank 0's shard of the sp = 2 path)
    for k, source, replaces in (
        ("groupnorm_partials", "lidarcrafter_tpu_torch/csrc/groupnorm.cu", "lidarcrafter_tpu/ops/pallas_groupnorm.py:49"),
        ("groupnorm_apply", "lidarcrafter_tpu_torch/csrc/groupnorm.cu", "lidarcrafter_tpu/ops/pallas_groupnorm.py:49"),
        ("oaca_gathered", "lidarcrafter_tpu_torch/csrc/oaca.cu", "lidarcrafter_tpu/ops/pallas_attention.py:183"),
    ):
        first = next(r for r in rows if r["kernel"] == k and r["dtype"] == "float32")
        bf16 = next(r for r in rows if r["kernel"] == k and r["dtype"] == "bfloat16")
        paths = {p: n[k] for p, n in by_path.items() if k in n}
        check(bool(paths) and all(n > 0 for n in paths.values()), f"{k}: no path launched it: {paths}")
        kernels.append({
            "name": k, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(paths.values()), "launches_by_path": paths,
            **{key: first[key] for key in ("max_abs_err", "tol", "norm_rel_err", "ms", "plain_ms", "bound_ms",
                                           "bound_by", "library_ms", "shape")},
            "dtype": "float32", "core_route": first["route"],
            "bf16": {key: bf16[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                                "max_abs_err", "tol", "norm_rel_err", "route")},
            # OACA's 64³ rows over gathered keys (v0's shard), float32 and bfloat16
            **{sub: [{key: r[key] for key in sub_keys} for r in rows if r["kernel"] == k and r.get("sub") == sub]
               for sub in {r["sub"] for r in rows if r["kernel"] == k and "sub" in r}},
        })
    # the probe: launched once per process, when the kernels load (this
    # process's load; the train CLI processes of phase 13 load their own)
    probe = probe_times(loaded)
    kernels.append({
        "name": "probe", "route": "cuda", "source": "lidarcrafter_tpu_torch/csrc/probe.cu",
        "replaces": "lidarcrafter_tpu/ops/mosaic.py:29", "launches": loader.probe_launches.n,
        "launches_by_path": {"load": loader.probe_launches.n}, "max_abs_err": 0.0, "ms": probe["probe_ms"],
        "plain_ms": probe["probe_plain_ms"], "bound_ms": probe["probe_bound_ms"], "bound_by": probe["probe_bound_by"],
        "library_ms": probe["probe_library_ms"], "shape": [8, 128], "dtype": "float32",
    })
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["sp-rank"]:
        sys.exit(sp_rank_main(Path(sys.argv[2]), sys.argv[3:]))
    if sys.argv[1:2] == ["sp-one"]:
        sys.exit(sp_one_main(Path(sys.argv[2]), sys.argv[3], sys.argv[4:]))
    if sys.argv[1:2] == ["export-lane"]:
        sys.exit(export_lane_main(Path(sys.argv[2])))
    sys.exit(main())
