"""Drive the PyTorch port's paths once on one CUDA card and check them.

Four paths of RandLA-Net at the shipped SemanticKITTI config, two of
SparseConvUnet at the shipped ScanNet config, two of PointPillars at the
shipped KITTI config and two of PointTransformer at the shipped S3DIS
config, with random weights drawn from a seeded generator:

* the fused path: a batch of 4 patches of 45,056 points through the fused
  bucket pyramid and the network (``get_net``);
* training: ``SemanticSegmentation.run_train`` on synthetic lidar-like
  scenes, batches of 4 x 45,056 points through the fused path at the
  training table budget, forward and backward, with validation,
  checkpoints and a resume;
* the eval slice: one patch of 45,056 points through the exact k-NN
  pyramid and the network in float32 (``get_eval_net``);
* ``SemanticSegmentation.run_inference`` on a synthetic lidar scan of
  120,000 points, patch by patch through the eval net until every point
  is labelled;
* SparseConvUnet serving: two requests of 65,536 points (a synthetic room
  of 6 m, and the same scene at the bench's 20 m) through ``preprocess``
  -> ``transform`` -> ``DefaultBatcher`` -> the stencil forward
  (``get_net``, bf16, 39 ``stencil_conv`` launches) -> ``update_probs``;
* SparseConvUnet training: ``SemanticSegmentation.run_train`` on
  ``Custom3D`` rooms, batches of 8 x 65,536 points through the stencil
  net with the ScanNet augmentations, forward and backward (each
  convolution's backward launches ``stencil_match``, ``bucket_gather`` and,
  but for the input convolution, ``bucket_gather_bwd``), with validation,
  checkpoints and a resume;
* PointPillars serving: the bench's request (4 scans of 20,000 points
  uniform over the KITTI range) through the serving net (``get_net``:
  canvas pillars, bf16 convolutions) and the eval net (``get_eval_net``:
  compact pillars, float32), then ``ObjectDetection.run_test`` on 8
  KITTI-format frames, ``run_valid`` on ``SyntheticBoxes`` and
  ``run_inference``;
* PointPillars training: ``ObjectDetection.run_train`` on KITTI-format
  frames, batches of 6 frames augmented by ObjectSample (its gt database
  written by the port's ``utils/collect_bboxes.py``), ObjectRangeFilter
  and PointShuffle, through the serving net in train mode (canvas, bf16),
  the anchor assignment, the three losses and AdamW, with validation,
  checkpoints and a resume;
* the command line (``open3d_ml_tpu_torch.run_pipeline.main``, in this
  process) on the port's shipped YAMLs: RandLA-Net trained and tested on
  a SemanticKITTI tree, SparseConvUnet trained on ScanNet rooms;
* PointTransformer: the eval forward at the bench's 2 x 16,384 points
  (``bench.py:530-564``), and ``run_train`` from the port's
  ``pointtransformer_s3dis.yml`` through the command line on S3DIS rooms
  (3 x 16,384 a step, SGD, the YAML's augmentations), with validation;
  and the same on the fused path (``--model.knn_method fused``: the
  Hilbert-bucket pyramid, bf16);
* KPConv (KPFCNN): the eval forward on the bench's request (a
  120,000-point lidar cloud, one 16,384-point patch, ``bench.py:430``),
  one training step against the CPU, ``run_train`` from the port's
  ``kpconv_semantickitti.yml`` through the command line on SemanticKITTI
  scans, and ``run_test`` and ``run_inference`` from
  ``kpconv_s3dis.yml`` on an S3DIS room of the test area;
* PointRCNN serving (``pointrcnn_kitti.yml`` in mode RCNN): one KITTI
  frame of 16,384 points through the RPN, the proposal layer (the
  ``nms_bev`` kernel), ``roipool3d``, the RCNN net and
  ``inference_end``, and ``run_inference``, ``run_test``, ``run_valid``
  and the command line on KITTI frames;
* PointRCNN training, both stages of ``pointrcnn_kitti.yml``: a step of
  mode RPN (the RPN in train mode, the per-point labels, the focal and
  bin losses, AdamW over the RPN) and of mode RCNN (the frozen RPN, the
  proposals at training's NMS, the roi sampling and jitter, the targets,
  the RCNN net, AdamW over it), and ``run_pipeline.main --split train``
  through both on KITTI frames with ObjectSample;
* PVCNN at ``pvcnn_s3dis.yml`` (grids of 64^3 and 32^3): the eval forward
  at 4 x 40,960 points of S3DIS rooms, one training step against the
  CPU, and ``run_pipeline.main --split train`` with validation and a
  resume;
* RandLA-Net at the four other shipped YAMLs (``randlanet_s3dis.yml``,
  ``_semantic3d``, ``_toronto3d``, ``_parislille3d``): the fused forward
  at 4 x 40,960 or 4 x 65,536, the exact eval net, and the command line's
  train and test on each reader's own files; a host-pyramid step; a
  SparseConvUnet hash-path step at B = 2;
* PointPillars at its four other shipped YAMLs (``pointpillars_lyft.yml``,
  ``_nuscenes``, ``_waymo``, ``_argoverse``): the serving and eval nets
  and the decode at full width, a training step, the command line on
  frames in each reader's format, and a converted reference checkpoint.

The models are the port's ``RandLANet()`` and ``SparseConvUnet()`` at their
defaults, which equal the model sections of
``open3d_ml_tpu/configs/randlanet_semantickitti.yml`` and
``sparseconvunet_scannet.yml``, and ``PointPillars(**POINTPILLARS_KITTI)``,
the model section of ``pointpillars_kitti.yml`` (CPU tests pin all three);
nothing of the JAX package is imported.

Run from the root of the repository, with one card:

    python3 chip_smoke.py

``python3 chip_smoke.py --step-branches`` runs only that float32 training
step against the CPU, on the patches of model seeds 0-3, with the CPU on
its own branches and on the card's. ``python3 chip_smoke.py
--pointpillars`` runs only the pointpillars phase, ``--pp-train`` only
the pp_train phase (each builds the kernels at its first decode, whose
NMS is the ``nms_bev`` kernel), ``--cli`` the build and the cli phase,
``--pointtransformer`` the build and the pointtransformer phase,
``--pt-fused`` the build and the pt_fused phase,
``--kpconv`` only the kpconv phase (no kernel of the port's),
``--pointrcnn`` the build and the pointrcnn phase,
``--pointrcnn-train`` the build and the pointrcnn_train phase,
``--pvcnn`` the build and the pvcnn phase, ``--randla-configs`` the
build and the randla_configs phase, ``--pp-configs`` the build and the
pp_configs phase.
``python3 chip_smoke.py --stencil-calls`` times only the room request's
39 stencil convolutions,
alone and inside a forward; ``python3 chip_smoke.py --knn-calls`` only
the KNN kernels' launches: the 4 ``knn_exact`` calls of an eval pyramid
and the 5 ``bucket_knn`` calls of a fused pyramid at the inference and at
the training budget. Copied into a checkout of another version of the
port, either times that version the same way. ``python3 chip_smoke.py
--vs-parent DIR`` builds an earlier commit's ``csrc/fps.cu`` and
``csrc/nms_bev.cu`` (their interfaces before the cluster ``fps`` and
the staged ``nms_bev``) or its ``csrc/trilinear_devoxelize.cu`` (the
interface before the plan), whichever DIR holds (``git
show <commit>:open3d_ml_tpu_torch/csrc/fps.cu > DIR/fps.cu``), and times
them against this tree's in turns, in one process: ``fps`` and
``nms_bev`` at PointTransformer's levels and on a served PointRCNN
frame's captured calls, the devoxelisation pair at PVCNN's four path
shapes on uniform coordinates, with half of each sample's points in one
cell, and on the calls of a forward of S3DIS rooms. ``python3
chip_smoke.py --devox-staged`` times the staged design of the
devoxelisation pair (``csrc/variants/trilinear_devoxelize_staged.cu``,
not shipped) against this tree's the same way, on the same calls.

Phases, one line each (or more), in this order:

1. device: the card's name and power limit; TF32 off for matmuls and
   convolutions; which of ``OPTIONAL_MODULES`` are installed.
2. build: compile the CUDA kernels from ``open3d_ml_tpu_torch/csrc``; the
   KNN kernels' registers and spill bytes, as ptxas reported them (a
   spill fails the run).
3. kernels: each kernel against its plain PyTorch version on the card, at
   its path's shapes, and both times: device time per call (CUDA events
   around back-to-back calls queued ahead of the card), and beside it the
   host-inclusive span of one call (median of CUDA-event timings).
   ``bucket_knn`` at every search of the fused pyramid (each level's
   neighbour search and level 3's pool search) at S32 and S48 and
   ``knn_exact`` at the eval pyramid's four levels, d2 bit-equal: indices
   equal off d2 ties on uniform points and row for row on lattice points
   (where the plan splits a query block's table over blocks, whose last
   to finish merges their lists, the search unsplit is checked and timed
   beside it);
   ``knn_exact`` also with a mask that leaves a sample five valid points,
   and beside it the issue floor of its float instructions and the time
   of ``torch.topk`` over ``torch.cdist`` (a yardstick, not the same
   function).
4. slice: the fused forward; the launch counts of one forward; sample 0
   against the same model on the CPU (float32: relative L2 <= 1e-4); the
   median forward time and points/s; the forward's model FLOPs
   (``utils/flops.py`` ``randlanet_forward_flops``) and their share of the
   card's dense bf16 peak (``peak_flops_for``), beside the card's name and
   power limit.
5. train: ``run_train`` for one epoch of 6 steps of 4 x 45,056 points and
   2 validation steps of 2 patches, on 8 + 2 synthetic scenes of 120,000
   points with the shipped class weights; the launch counts of every step;
   finite losses; a checkpoint, and a second ``run_train`` in a fresh
   pipeline that resumes from it with equal weights and Adam state; 10
   steps on one batch, whose loss must fall; one float32 step of 1 x
   11,264 points on a seeded patch against the same step on the CPU, the
   CPU taking the card's max-pool and LeakyReLU branches (relative L2
   <= 1e-4 for the gradient); the median step time, points trained per
   second, the host's share and the peak memory.
6. eval: the same as slice for the eval net at B = 1, and one forward's
   time on the card's stream split into the 4 ``knn_exact`` launches, the
   4 k = 1 searches (plain torch) and everything else.
7. inference: ``run_inference`` on the scan; its launch counts, patches,
   wall time and where it went, and points labelled per second.
8. kernels (stencil_conv): the stencil kernel against its plain version at
   five convolutions of the room request's forward (its keys and tables,
   new values and weights), after a check of the kernels' precondition
   (the keys of each batch row ascend): bit-equal on dyadic inputs at
   float32 and bf16, within the float32 summation bound of a float64
   reference on normal ones; its time, the plain version's and its bound.
   Then each of the forward's 39 convolutions timed alone, by level,
   form, K, Cin -> Cout and Q; the two heaviest, the input convolution
   (Cin 3) and the level-0 block with tables of S = 32 and 48 (2,048 and
   3,072 rows) checked as the five are; both stencil kernels bit-equal on
   synthetic rulebooks the request does not make (repeated table ids,
   all-pad segments, pad-key taps, seg 16, S 3-40, odd widths).
9. scu: the two requests served, with 39 ``stencil_conv`` launches each
   and no other kernel; their overflow counters; finite logits and
   probabilities; the card against the CPU (float32: relative L2 <= 1e-4;
   bf16 reported); on the room request the stencil path against the hash
   path on the card (gated at 1e-4 only when every counter is 0); the
   median forward, points/s, peak memory and the stencil calls' device
   time in one forward. Beside the stencil kernel, at the same shapes:
   ``stencil_match`` against its plain version (rel and found bit-equal,
   misses included; its time, the plain version's, one batched
   ``torch.searchsorted`` as the library call, and its bound; a line
   names any shape where it is slower than the library call), and the
   convolution's backward on the kernels against the same backward on the
   plain versions (dvalues and dw bit-equal on dyadic inputs at float32
   and bf16; dw within the float32 summation bound of a float64
   reference); and ``bucket_gather`` and ``bucket_gather_bwd`` as that
   backward calls them (misses reading table position 0, their
   cotangents 0) at the level-0 post conv1, the deepest block and the
   level-0 block of both requests as a batch of 2, with their
   ``torch.gather`` and ``scatter_add_`` times.
10. scu_train: ``run_train`` for one epoch of 6 steps of 8 x 65,536
   points and 2 validation steps, on 8 + 2 synthetic rooms of 6 m with
   RGB, written as ``Custom3D`` files; the launch counts of every step;
   finite losses; a checkpoint and a resumed ``run_train`` in a fresh
   pipeline with equal weights, BN statistics and Adam state; 10 steps on
   one batch, whose loss must fall; one float32 step at B = 1 on the room
   request against the CPU on the card's ReLU branches (loss within 1e-5,
   gradient and running statistics within 1e-4 relative L2); the median
   step time, points trained per second, the host's share, the peak memory
   and the device time of the backward's rulebook, gather and scatter
   calls in one step.
11. pointpillars: (a) the request through the serving net (canvas, bf16)
   and the eval net (compact, float32): median forward of 10 after 3
   warm-ups, scans/s, peak memory, and beside them the bound of the
   convolutions' and the PFN's FLOPs at the peak for their type; from
   one torch.profiler pass over one forward of each, in a child process
   (``--pp-profile``: the profiler traces the card once a process), the
   busy share, the cuDNN convolutions' share and the top 8 kernels.
   (b) gates: the eval net card vs CPU on scan 0 (relative L2 <= 1e-4);
   canvas vs compact at float32 on the card (<= 1e-5; the phase asserts
   that no cap binds: no pillar over 32 points, none over 40,000
   pillars); the decode (``get_bboxes``) card vs CPU on the same outputs
   (the same kept set, boxes within 1e-5 of max(1, |value|)), with the
   detections a scan and
   the decode's time; canvas bf16 vs float32 (<= ``PP_BF16_BOUND``); the
   serving net's casts pinned (``pp_cast_faults``), and each of its
   stages fed the CPU's input on scan 0 and held to the CPU's output
   (``PP_BF16_STAGE_SHARE``), each wrong cast ``planted_cast`` plants on
   the card caught by both.
   (c) ``run_test`` over 8 KITTI frames written from ``make_objdet_scene``
   seeds 0-7 (result files counted; frames/s and where the wall time
   went), ``run_inference`` on frame 0, ``run_valid`` on
   ``SyntheticBoxes`` (finite mAP), and a checkpoint saved and loaded by
   a fresh pipeline whose head outputs are bit-equal. The port's one
   kernel on the path is ``nms_bev``, once a decode on the card.
12. pp_train: ``run_train`` for one epoch of 6 steps of 6 KITTI frames
   (8 training and 2 validation frames written from
   ``make_objdet_scene`` seeds 100-109, a gt database of their boxes),
   the augment section of ``pointpillars_kitti.yml``, AdamW at the
   YAML's pipeline settings; finite losses, the validation mAP, a
   checkpoint, and a fresh pipeline resuming from it with equal weights
   and BN statistics and a fresh AdamW (the JAX resume) for another
   epoch; the anchor targets of a step's batch on the card and on the
   CPU (masks, labels, direction targets equal, deltas within 1e-6); 10
   steps on one batch, whose loss must fall, each split by CUDA events
   into forward, loss, backward and AdamW; one float32 step of 2 frames
   from the seeded weights against the CPU on the card's ReLU and
   pillar-max branches (loss within 1e-5, each parameter's gradient and
   each BN statistic within 1e-4 relative L2); the median step, frames
   trained per second, the host's share, the peak memory, and one
   profiled step (``--pp-train-profile``, in a child process): kernels,
   busy share, the convolutions' share and the top 10 kernels. The
   training steps launch no kernel of the port's; each decode of the
   validation on the card launches ``nms_bev`` once.
13. cli: ``run_pipeline.main`` on ``CLI_CONFIGS``, with the launch counts
   reset before and read after each run. RandLA-Net: a SemanticKITTI tree
   (``write_semantickitti``: 4, 2 and 2 lidar scans of 120,000 points in
   sequences 00, 08 and 11, raw-id ``.label`` files with instance bits for
   the first two), ``--split train --pipeline.max_epoch 0`` for 4 train
   steps of 4 x 45,056 and 2 validation steps (each step's launches, the
   run's totals, finite losses, the checkpoint), then ``--split test
   --ckpt_path`` on it (4 ``knn_exact`` launches an exact forward, and
   nothing else; two ``.label`` files of one raw uint32 id a point, every
   id in ``LEARNING_MAP_INV``'s image). SparseConvUnet: 8 + 2 ScanNet
   rooms (``write_scannet_rooms``), ``--split train`` for 2 train steps of
   8 and 1 validation step (each step's launches, the totals, the
   checkpoint). Each run's wall time, the train steps/s, the test's
   scans/s and the host preprocess share.
14. pointtransformer: ``knn_exact`` at each of the 13 search shapes of a
   forward at B = 2 (each level's self-searches at k = 8 or 16, each
   stride's grouping, each 3-NN at k = 3) on uniform, padded (a quarter
   repeated) and lattice points and with a mask, d2 bit-equal and the
   indices row for row, with its time, bound, the plain version's span
   and ``torch.cdist`` + ``topk``'s; ``fps`` at the four levels and at
   1,025, 24,576 and 32,768 points (uniform, padded, lattice, masked,
   few-valid and all-masked inputs at B = 2, the last three at B = 1),
   indices equal, with its time a step, its cluster plan, the times of
   clusters of 4, 8 and 16 CTAs at 16,384 points, and the serial floor of
   the forward's 5,436 steps; the
   eval forward at 2 x 16,384 (26 ``knn_exact`` and 4 ``fps``
   launches, the same net on the plain versions on the card within
   ``PT_PLAIN_TOL``, sample 0 against the CPU within 1e-4, the median
   of 10, peak memory, the kernels' share); ``run_pipeline.main`` with
   ``pointtransformer_s3dis.yml`` on 3 + 1 S3DIS rooms written by
   ``write_s3dis_rooms`` (3 train steps of 3 and a validation step of 3,
   26/4 launches each, finite losses, every Linear weight moved, the
   checkpoint, the step median, patches trained/s, peak memory), then
   ``--split test``, which must raise ``NotImplementedError``; one
   profiled eval forward and training step in a child process
   (``--pt-profile``).
15. pt_fused: PointTransformer at the same config on the fused path
   (``knn_method: fused``, bf16, seg 64, block 128, S64/G32):
   ``bucket_knn`` at each of the 13 searches of the Hilbert-bucket
   pyramid of the bench's request (``pt_fused_searches``: attention at k
   = 8 and 16, grouping at 16, upsample at 3; tables of up to 4,096 rows)
   on lattice points (rel row for row) and uniform ones (d2 bit-equal, rel
   off ties, times beside the issue floor, a split search also unsplit);
   ``bucket_gather`` and ``bucket_gather_bwd`` at the forward's 13 read
   shapes (widths 35-1,027) against their plain versions, with
   ``torch.gather`` and ``scatter_add_``; the fused forward at 2 x 16,384
   (13 ``bucket_knn`` and 26 ``bucket_gather`` launches, no ``fps`` or
   ``knn_exact``; float32 sample 0 card vs CPU within ``PT_FUSED_TOL``,
   bf16 against float32 reported; the median forward); ``run_pipeline
   .main --split train --model.knn_method fused`` on S3DIS rooms (3 steps
   of 3 x 16,384 with 26 ``bucket_gather_bwd`` launches each, a
   validation step through the same net in eval mode; finite losses,
   every Linear weight moved, the step median, patches trained/s, peak
   memory, the host's share); one float32 step of 1 x 16,384 card vs CPU
   on the card's branches (``_SameBranches(net="pt")``); a profiled
   forward and step in a child process (``--pt-fused-profile``).

16. kpconv (~70 s): KPFCNN from the port's ``kpconv_semantickitti.yml``
   at full width and depth, seeded random weights: the bench's request
   (``kp_request``: a 120,000-point cloud of ``bench.py:421-427``'s
   formula, the test split's ``preprocess``, the random sampler, one
   16,384-point patch) through the eval forward, card vs CPU within
   ``KP_TOL``, the median of 10, peak memory, the host ``transform``'s
   median and each level's rows at the neighbour limit; one float32
   training step, card vs CPU (loss ``KP_LOSS_TOL``, gradients and BN
   statistics ``KP_TOL``) with the CPU on the card's LeakyReLU and
   max-pool branches (``_SameBranches(net="kpconv")``); ``run_pipeline
   .main`` on that YAML over 4 + 1 SemanticKITTI scans (4 train steps,
   1 validation step, the step median, the host share, peak memory, the
   set-up's parts); on ``kpconv_s3dis.yml`` ``--split test`` over one
   room of area 5 (``write_s3dis_rooms``) until it is covered, every
   point labelled, features of width 4, then ``run_inference`` on the
   room; a profiled forward and step in a child process
   (``--kpconv-profile``). No port kernel: every launch count stays 0.
   One JSON line ``{"kpconv": ...}`` holds the phase's numbers.
17. pointrcnn (~45 s): ``PointRCNN(**POINTRCNN_KITTI, mode="RCNN")``
   with seeded ``random_weights`` on one KITTI frame (``prcnn_request``:
   ``prcnn_scene`` written by ``write_kitti_frame``, ~17,400 points in
   the camera's view out to 70.4 m, the test split's draw of 16,384
   points without repeats): every kernel call of the forward and
   its refinement, captured, against its plain version on the card
   (``knn_exact`` at k = 16 and 32 over the RPN's levels, k = 3 for the
   four 3-NN and k = 64 at B = 100 for the RCNN; d2 bit-equal, indices
   equal off exact ties, and the same shapes on lattice points row for
   row; ``fps`` 16,384 -> 4,096 ... and at B = 100, 512 -> 128 and
   128 -> 32, indices equal; ``nms_bev`` on the proposal layer's two
   buckets of 6,300 and 2,700 candidates and on the refinement's 100
   rois, each bucket's valid count printed: every keep decision of the
   kernel traced through the plain IoU (``nms_trace``: kept exactly when
   valid and no kept earlier box overlaps it above the threshold, but
   where a kept earlier box's plain IoU lies within ``PRCNN_IOU_NEAR`` of
   it), the decisions apart from the plain version's counted and their
   share the record's error; the mask kernel and the sweep also timed
   alone), each with its device ms,
   bound and plain call span; the served frame's launch counts
   (``PRCNN_FORWARD_LAUNCHES``, ``PRCNN_SERVE_LAUNCHES``), its median of
   10, the stage split (RPN, proposal, roipool3d, RCNN, inference_end),
   peak memory; the card against the CPU (the RPN's outputs, and the
   RCNN stage replayed on the card's rois, within ``PRCNN_TOL``; the
   rois the proposal layer selects alike from the CPU's RPN outputs);
   ``run_inference``, ``run_test`` over 4 frames, ``run_valid`` with mAP
   over 2 and ``run_pipeline.main`` with ``--model.mode RCNN --split
   test``, each with its launch counts, frames/s and host share; a
   profiled frame in a child process (``--prcnn-profile``). One JSON line
   ``{"pointrcnn": ...}``.
18. pointrcnn_train: PointRCNN training, both stages of
   ``pointrcnn_kitti.yml`` (mode RPN, then RCNN), seeded weights, on 4
   KITTI frames of ``prcnn_scene`` with a gt database from
   ``utils/collect_bboxes``: every kernel call of one training step
   against its plain version (mode RPN 12 ``knn_exact`` and 4 ``fps``;
   mode RCNN 14, 6 and 1 ``nms_bev`` at training's 0.85 and 512
   survivors, each decision traced), a step's launch counts
   (``PRCNN_TRAIN_LAUNCHES``), 6 timed steps split by CUDA events
   (forward, loss, backward, AdamW), frames/s and peak memory, one
   float32 step against the CPU on the card's branches
   (``_SameBranches(net="prcnn")``; mode RCNN on the card's RPN outputs
   and one set of sampling draws; loss ``PRCNN_LOSS_TOL``, the trained
   stage's gradients and BN statistics ``PRCNN_TOL``), each step's busy
   share from a profiled child process (``--prcnn-train-profile``), and
   ``run_pipeline.main --split train`` through both stages, each step's
   launches and the host share. One JSON line
   ``{"pointrcnn_train": ...}``.
19. pvcnn: PVCNN at ``pvcnn_s3dis.yml``, seeded weights, float32:
   ``trilinear_devoxelize`` at the four path shapes (B = 4, N = 40,960,
   (r, C) = (64, 64), (32, 64), (32, 64), (32, 128)) against its plain
   versions (the plan equal to the plain plan; the forward bit-equal;
   the backward bit-equal on dyadic inputs, and on uniform ones
   bit-equal to the plain version run on the CPU, the same bits in two
   runs and within ``PV_BWD_TOL`` of a float64 sum), with
   ``F.grid_sample`` and its backward as the library calls, and once
   more with half of each sample's points in one cell; the
   eval forward at 4 x 40,960 points of S3DIS rooms (``PV_ROOMS``
   through ``preprocess``): launch counts, the voxel branches
   channels-last, card vs CPU on the card's branches and voxel cells
   within ``PV_TOL``, the median of 10, the FLOP bound (``pv_flops``),
   peak memory; one training step on the card in float32 and float64
   and on the CPU in float64, all on the card's branches, the voxel
   branches channels-last, and the card's float32 readings again on a
   second seed and batch (``_pv_step_vs_cpu``); 6 timed steps split by
   CUDA events; a profiled
   forward and step in a child process (``--pvcnn-profile``);
   ``run_pipeline.main`` with ``pvcnn_s3dis.yml``, ``--split train``, 2
   steps and 1 validation step, then a resumed epoch, and ``--split
   test`` refused.

20. randla_configs (run after inference): RandLA-Net at
   ``RC_CONFIGS``, the five other shipped YAMLs, seeded random weights,
   each reader's files written by the phase (``write_rc_data``: S3DIS
   rooms, Semantic3D text scans, Toronto3D and ParisLille3D PLY tiles and
   PandaSet pickled frames of ``street_scene``); for the four YAMLs other
   than ``RC_CLI_ONLY`` (PandaSet's net is the main path's, 45,056
   points, which phases 4-7 hold card vs CPU) the kernels at the two
   point counts, 40,960 and 65,536 (``_rc_kernels``: every ``bucket_knn``
   search of the fused pyramid at S32 checked and timed and at S48
   checked, ``bucket_gather`` and ``bucket_gather_bwd`` at the level-0
   neighbour and pool shapes, ``knn_exact`` at the eval pyramid's
   levels, as in phase 3); per YAML
   the fused forward at B = 4 (launch counts ``fused_launches``, median),
   the exact eval net at B = 1 against the CPU net reading the card's
   pyramid (``RC_TOL``; the KD-tree's host pyramid printed beside), and
   ``run_pipeline.main --split train`` (2 steps of 4, 1 validation step,
   each step's launches) then ``--split test`` on a 300,000-point cloud
   (launches, scans/s, host share, the predictions in the reader's
   format; PandaSet's frames are 150,000 points and its command line
   adds ``RC_CLI_EXTRAS``); after PandaSet its TensorBoard events read
   back; after S3DIS the TensorBoard events read back (the six scalar
   tags of the JAX ``save_logs``, the text) and one float32 host-pyramid
   step (``knn_on_device=False``, 1 x ``RC_HOST_POINTS``) against the CPU
   on the card's branches; then one float32 SparseConvUnet hash-path step
   at B = 2 of the room request against the CPU on the card's ReLU
   branches, with its BN statistics (loss ``RC_LOSS_TOL``, gradients and
   statistics ``RC_TOL``).
21. pp_configs: PointPillars at its four other shipped YAMLs
   (``PP_CONFIGS``), seeded weights, on ``pp_scene`` frames written in
   each reader's own format (``write_nuscenes``, ``write_waymo``,
   ``write_argoverse``: 12 train, 1 validation and 2 test frames of
   40,000 points, cut to 32,768). Per net that runs (Lyft, nuScenes,
   Argoverse; Argoverse's frames with a zero intensity column) on test
   frame 0 at B = 1: the eval net (compact, float32) and the canvas net
   at float32 card vs CPU (``PPC_TOL``), canvas vs compact at float32
   where no cap binds (``PPC_CANVAS_TOL``; where one binds the largest
   pillar is printed and nothing compared), the serving net (canvas,
   bf16) vs float32 (``PP_BF16_BOUND``), the decode on the card
   (one ``nms_bev`` call over B x C rows) against the CPU's, the median
   of 10 forwards of the serving and the eval net with peak memory; then
   ``run_pipeline.main`` on each YAML (Lyft and nuScenes: 2 steps of 6
   and a validation frame's mAP, Lyft's peak memory, then ``--split
   test``, which detects in both frames and raises ``NO_CAMERA_FAULT``;
   Waymo raises ``NECK_FAULT``; Argoverse ``COLUMNS_FAULT``); the
   Argoverse net trains one step through the model API; one float32
   nuScenes step B = ``PP_CPU_BATCH`` from weights trained
   ``PP_FIT_STEPS`` steps, its anchor targets card vs CPU
   (``_pp_targets_vs_cpu``), held to float64 on the card's branches and
   anchor targets (``_pp_step_vs_cpu``); ``convert_checkpoint`` of a
   reference-shaped state_dict (``pp_reference_state_dict``) strict-loaded
   on the card, card vs CPU; the launch counts (``PPC_LAUNCHES``); each
   decode's ``nms_bev`` call held to the plain version and timed
   (``_prcnn_nms_check``); one profiler pass over the six forwards in
   this process (``ppc_profile``).

Every path runs with the launch counts set to 0 just before it and read
just after. Any failed check raises, so the exit code is not 0. The
second-last line is a JSON record of the kernels (each with its bound: the
larger of its bytes over 3.35 TB/s and its operations over the peak for
their type, and the time of one PyTorch call that computes the same
function where there is one; the gather's and its backward's times sum
every shape they were checked at, RandLA's and SparseConvUnet's, and a
line before names the shapes where either is slower than its library
call), the last one ``{"ok": true, "device": ...}``. There is no CPU
fallback: without CUDA the script fails first.
"""

import collections
import contextlib
import copy
import functools
import importlib.metadata
import importlib.util
import json
import pickle
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch
from torch.overrides import TorchFunctionMode

from open3d_ml_tpu_torch import DATASET, MODEL, SAMPLER, run_pipeline
from open3d_ml_tpu_torch.dataloaders import (BatchLoader, DefaultBatcher,
                                             PointCloudDataloader)
from open3d_ml_tpu_torch.datasets import (KITTI, SyntheticBoxes,
                                          SyntheticShapes, make_objdet_scene)
from open3d_ml_tpu_torch.datasets._resources.semantickitti import (
    LEARNING_MAP, LEARNING_MAP_INV)
from open3d_ml_tpu_torch.datasets.synthetic import make_semseg_scene
from open3d_ml_tpu_torch.datasets.utils import BEVBox3D
from open3d_ml_tpu_torch.datasets.utils.bev_box import NO_CAMERA_FAULT
from open3d_ml_tpu_torch.datasets.utils.ply import write_ply
from open3d_ml_tpu_torch.models import kpconv as tkp
from open3d_ml_tpu_torch.models import point_pillars as tpp
from open3d_ml_tpu_torch.models import point_rcnn as tprc
from open3d_ml_tpu_torch.models import point_transformer as tpt
from open3d_ml_tpu_torch.models import pointnet2 as tp2
from open3d_ml_tpu_torch.models import pvcnn as tpv
from open3d_ml_tpu_torch.models import randlanet as trl
from open3d_ml_tpu_torch.models import sparseconvunet as tscu
from open3d_ml_tpu_torch.modules.losses import SemSegLoss
from open3d_ml_tpu_torch.ops import bucket as tb
from open3d_ml_tpu_torch.ops import neighbors as tn
from open3d_ml_tpu_torch.ops import sampling as tsmp
from open3d_ml_tpu_torch.ops import sparse as tsp
from open3d_ml_tpu_torch.ops import sparse_bucket as tsb
from open3d_ml_tpu_torch.ops.cuda import _build
from open3d_ml_tpu_torch.ops.cuda import bucket as cb
from open3d_ml_tpu_torch.ops.cuda import devoxelize as cdv
from open3d_ml_tpu_torch.ops.cuda import knn as ck
from open3d_ml_tpu_torch.ops.cuda import nms as cnms
from open3d_ml_tpu_torch.ops.cuda import sampling as cfps
from open3d_ml_tpu_torch.ops.cuda import stencil as cs
from open3d_ml_tpu_torch.ops.iou import iou_bev
from open3d_ml_tpu_torch.ops.morton import hilbert_sort
from open3d_ml_tpu_torch.ops.voxelize import voxelize
from open3d_ml_tpu_torch.pipelines import (ObjectDetection,
                                           SemanticSegmentation)
from open3d_ml_tpu_torch.utils import Config, collect_bboxes, convert_torch
from open3d_ml_tpu_torch.utils.flops import (peak_flops_for,
                                             randlanet_forward_flops)

REPO = Path(__file__).resolve().parent
TPU_KERNELS = "open3d_ml_tpu/ops/pallas/bucket.py"
SEED = 0
DEVICE = "cuda"
EXPECTED_LAUNCHES = {"bucket_knn": 5, "bucket_gather": 16,
                     "bucket_gather_bwd": 0, "knn_exact": 0}
# per training step: the forward's launches, and one backward per gather
TRAIN_STEP_LAUNCHES = dict(EXPECTED_LAUNCHES, bucket_gather_bwd=16)
SCAN_POINTS = 120_000  # about one SemanticKITTI scan
# dataset and pipeline sections of
# open3d_ml_tpu/configs/randlanet_semantickitti.yml (a CPU test pins them)
SEMANTICKITTI_CLASS_WEIGHTS = [
    55437630, 320797, 541736, 2578735, 3274484, 552662, 184064, 78858,
    240942562, 17294618, 170599734, 6369672, 230413074, 101130274, 476491114,
    9833174, 129609852, 4506626, 1168181]
TRAIN_PIPELINE = {"batch_size": 4, "val_batch_size": 2,
                  "optimizer": {"lr": 0.001}, "scheduler_gamma": 0.9886,
                  "save_ckpt_freq": 5, "num_workers": 2}
COUNTERS = (cb.LAUNCHES, ck.LAUNCHES, cs.LAUNCHES, cfps.LAUNCHES,
            cnms.LAUNCHES, cdv.LAUNCHES)
# (module, distribution): pandas reads PandaSet frames, joblib Matterport
# files, PyYAML config files, tensorboard the events read back
OPTIONAL_MODULES = (("pandas", "pandas"), ("joblib", "joblib"),
                    ("yaml", "PyYAML"), ("tensorboard", "tensorboard"))
# the H100 SXM's device memory rate and its dense peaks (NVIDIA's
# datasheet): a kernel's bound is the larger of its bytes over the rate
# and its operations over the peak for their type
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float32": 67e12, "bfloat16": 989e12}
# the H100's float32 pipes: 128 lanes an SM per clock, 132 SMs; the KNN
# kernels' issue floor is their FP32-pipe instructions per candidate
# distance over that rate at the card's top SM clock
FP32_LANES = 128 * 132
KNN_EXACT_PIPE_OPS = 8  # 3 FMUL, 3 FADD, 1 FFMA, the compare
BUCKET_KNN_PIPE_OPS = 9  # 3 FSUB, 3 FMUL, 2 FADD, the compare
# knn_exact's yardstick: torch.topk over torch.cdist, this many queries a
# call
CDIST_CHUNK = 4096
# SparseConvUnet: the room scene's extent, and the bench's scene (1,000
# voxels of 0.02 m, as bench.py sizes child_sparseconvunet's scene)
SCU_ROOM_EXTENT_M = 6.0
SCU_BENCH_EXTENT_M = 1000 * 0.02
SCU_FORWARD_LAUNCHES = 39  # stencil convolutions per 7-level forward
# per SparseConvUnet training step at 7 levels: the forward's stencil
# convolutions, and in the backward one rulebook and one gather per
# convolution and one scatter per convolution but the input one (whose
# values, voxel averages of the inputs, need no gradient)
SCU_TRAIN_STEP_LAUNCHES = {"stencil_conv": SCU_FORWARD_LAUNCHES,
                           "stencil_match": SCU_FORWARD_LAUNCHES,
                           "bucket_gather": SCU_FORWARD_LAUNCHES,
                           "bucket_gather_bwd": SCU_FORWARD_LAUNCHES - 1}
# pipeline section of open3d_ml_tpu/configs/sparseconvunet_scannet.yml (a
# CPU test pins it)
SCU_TRAIN_PIPELINE = {"batch_size": 8, "val_batch_size": 8,
                      "optimizer": {"lr": 0.001, "betas": [0.9, 0.999]},
                      "save_ckpt_freq": 5, "num_workers": 2}
SCU_TRAIN_ROOMS = {"train": 8, "val": 2}
# the stencil kernel's checks: (label, K, Cin, Cout, qblock) of five
# convolutions of the room scene's forward
STENCIL_SHAPES = (("level-0 block", 27, 32, 32, 32),
                  ("level-0 post conv1", 27, 64, 32, 32),
                  ("level-0 down", 8, 32, 64, 32),
                  ("level-0 up", 8, 64, 32, 128),
                  ("deepest block", 27, 224, 224, 32))
# the bucket gather and its backward are also checked where the stencil
# backward calls them at these two, and at the level-0 block of both
# requests as a batch of 2
SCU_BUCKET_SHAPES = ("level-0 post conv1", "deepest block")
# the level-0 block is also checked with wider tables than the config's
# S = 16: how many more taps they find, and the kernels past 32 slots
SCU_WIDE_SEGS = (32, 48)
# both stencil kernels on synthetic rulebooks that reach cases the room
# request does not: (form, seg, qblock, S), seg 16 taking the kernels'
# run-time seg and 64 the compiled one, S past 32 ordering a table in
# shared memory; every other rulebook repeats ids inside its tables
STENCIL_EDGE_CASES = (("sub", 64, 32, 16), ("sub", 64, 32, 32),
                      ("sub", 16, 32, 8), ("down", 64, 32, 16),
                      ("up", 64, 128, 16), ("up", 16, 128, 4),
                      ("sub", 64, 64, 3), ("sub", 16, 32, 40))
# their convolutions' Cin -> Cout; 3 -> 32 and 35 -> 37 take the bf16
# kernel's 4-byte copies
STENCIL_EDGE_WIDTHS = ((3, 32), (32, 32), (64, 96), (224, 224), (35, 37))
# the model section of open3d_ml_tpu/configs/pointpillars_kitti.yml but
# for name, ckpt_path and augment, and the entries of its pipeline section
# that validation and test read (a CPU test pins both)
POINTPILLARS_KITTI = {
    "point_cloud_range": [0, -39.68, -3, 69.12, 39.68, 1],
    "classes": ["Pedestrian", "Cyclist", "Car"],
    "max_points": 32768,
    "max_gt": 64,
    "loss": {"focal": {"gamma": 2.0, "alpha": 0.25, "loss_weight": 1.0},
             "smooth_l1": {"beta": 0.11, "loss_weight": 2.0},
             "cross_entropy": {"loss_weight": 0.2}},
    "voxelize": {"max_num_points": 32, "voxel_size": [0.16, 0.16, 4],
                 "max_voxels": [16000, 40000]},
    "voxel_encoder": {"in_channels": 4, "feat_channels": [64],
                      "voxel_size": [0.16, 0.16, 4]},
    "scatter": {"in_channels": 64, "output_shape": [496, 432]},
    "backbone": {"in_channels": 64, "out_channels": [64, 128, 256],
                 "layer_nums": [3, 5, 5], "layer_strides": [2, 2, 2]},
    "neck": {"in_channels": [64, 128, 256], "out_channels": [128, 128, 128],
             "upsample_strides": [1, 2, 4], "use_conv_for_no_stride": False},
    "head": {"in_channels": 384, "feat_channels": 384, "nms_pre": 100,
             "score_thr": 0.1,
             "ranges": [[0, -39.68, -0.6, 70.4, 39.68, -0.6],
                        [0, -39.68, -0.6, 70.4, 39.68, -0.6],
                        [0, -39.68, -1.78, 70.4, 39.68, -1.78]],
             "sizes": [[0.6, 0.8, 1.73], [0.6, 1.76, 1.73],
                       [1.6, 3.9, 1.56]],
             "rotations": [0, 1.57],
             "iou_thr": [[0.35, 0.5], [0.35, 0.5], [0.45, 0.6]]},
}
POINTPILLARS_PIPELINE = {"val_batch_size": 1, "test_batch_size": 1,
                         "overlaps": [0.5, 0.5, 0.7],
                         "similar_classes": {"Van": "Car",
                                             "Person_sitting": "Pedestrian"},
                         "difficulties": [0, 1, 2]}
# the augment section of pointpillars_kitti.yml, the pickle written at
# run time, and the entries of its pipeline section that training reads
# (a CPU test pins both)
POINTPILLARS_AUGMENT = {
    "PointShuffle": True,
    "ObjectRangeFilter": {
        "point_cloud_range": [0, -39.68, -3, 69.12, 39.68, 1]},
    "ObjectSample": {
        "pickle_path": None,
        "min_points_dict": {"Car": 5, "Pedestrian": 10, "Cyclist": 10},
        "sample_dict": {"Car": 15, "Pedestrian": 10, "Cyclist": 10}}}
POINTPILLARS_TRAIN_PIPELINE = dict(
    POINTPILLARS_PIPELINE, batch_size=6, save_ckpt_freq=5, num_workers=2,
    optimizer={"lr": 0.001, "betas": [0.95, 0.99], "weight_decay": 0.01})
# pp_train: KITTI frames (make_objdet_scene seeds 100-109), the first 8
# the train split and the last 2 validation, and the steps of an epoch
PP_TRAIN_FRAMES, PP_VALID_FRAMES, PP_TRAIN_STEPS = 8, 2, 6
PP_CPU_BATCH = 2  # frames of the float32 card-vs-CPU step
# steps on one batch to the trained weights of that step's float64 check:
# as many as pp_train takes before its overfit steps end (6 + 6 + 10)
PP_FIT_STEPS = 22
PP_BATCH, PP_POINTS = 4, 20_000  # the request bench.py:321-341 times
PP_TEST_FRAMES = 8  # make_objdet_scene seeds 0-7 as KITTI test frames
# nms_bev launches of the PointPillars phases, one a decode on the card:
# pointpillars' gates decode once and time 5 more, run_test decodes its 8
# frames, run_inference 1 and run_valid SyntheticBoxes' 2 validation
# frames; pp_train's two run_train calls each validate on its 2 frames
PP_SERVE_LAUNCHES = {"nms_bev": 1 + 5 + PP_TEST_FRAMES + 1 + 2}
PP_TRAIN_LAUNCHES = {"nms_bev": 2 * PP_VALID_FRAMES}
# bf16 serving net vs float32, relative L2 of the head outputs: a sanity
# bound (measured 0.0115 on an H100 80GB HBM3, 700 W). The casts are held
# by pp_cast_faults and PP_BF16_STAGE_SHARE.
PP_BF16_BOUND = 0.03
# the serving net's stages on the card, each fed the CPU's input on scan 0
# of the request: the share of a stage's elements apart from the CPU's
# output (pp_stage_shares). A stage that rounds where the CPU does differs
# only where the order of a sum flips a bf16 rounding.
PP_BF16_STAGE_SHARE = 0.01
# the wrong casts planted_cast plants, besides one convolution in float32
PP_FAULTS = ("bn_bf16", "head_bf16", "canvas_f32")
# pp_configs: PointPillars' four other shipped YAMLs, and the points and
# boxes of a pp_scene frame
PP_CONFIGS = {
    "lyft": "open3d_ml_tpu_torch/configs/pointpillars_lyft.yml",
    "nuscenes": "open3d_ml_tpu_torch/configs/pointpillars_nuscenes.yml",
    "argoverse": "open3d_ml_tpu_torch/configs/pointpillars_argoverse.yml",
    "waymo": "open3d_ml_tpu_torch/configs/pointpillars_waymo.yml"}
PP_SCENE_POINTS, PP_SCENE_BOXES = 40_000, 12
# KITTI calib lines: velodyne -> camera swaps the axes (x_cam = -y,
# y_cam = -z, z_cam = x), P2 a KITTI camera's intrinsics
KITTI_P = ("7.215377e+02 0.000000e+00 6.095593e+02 0.000000e+00 "
           "0.000000e+00 7.215377e+02 1.728540e+02 0.000000e+00 "
           "0.000000e+00 0.000000e+00 1.000000e+00 0.000000e+00")
KITTI_TR = "0 -1 0 0 0 0 -1 0 1 0 0 0"
# the cli phase: the port's shipped configs through run_pipeline.main,
# the steps of its one epoch (train, validation) for each model, and the
# SemanticKITTI tree's scans a sequence (08 validates, 11 and up test)
CLI_CONFIGS = {
    "randlanet": "open3d_ml_tpu_torch/configs/randlanet_semantickitti.yml",
    "scu": "open3d_ml_tpu_torch/configs/sparseconvunet_scannet.yml"}
CLI_STEPS = {"randlanet": (4, 2), "scu": (2, 1)}
SEMANTICKITTI_SCANS = {"00": 4, "08": 2, "11": 2}
SEMANTICKITTI_FIRST_TEST = "11"
# SemanticKITTI's reader gives each point's remission as a feature, so
# RandLA-Net takes 3 + 1 input channels (the shipped YAML says 3: with
# it, transform refuses the reader's clouds in both packages)
CLI_RANDLANET_EXTRAS = ["--model.in_channels", "4"]
# PointTransformer: the model section of the port's
# pointtransformer_s3dis.yml that the eval forward builds (a CPU test pins
# it), the bench's request (bench.py:530-564: 2 patches), the YAML's
# batch sizes, the steps of the cli run's one epoch, and one forward's
# launches (26 knn_exact: 2 at k = 8, 20 at 16, 4 at 3; 4 fps)
PT_CONFIG = "open3d_ml_tpu_torch/configs/pointtransformer_s3dis.yml"
POINTTRANSFORMER_S3DIS = {"blocks": [2, 3, 4, 6, 3], "in_channels": 6,
                          "num_classes": 13, "voxel_size": 0.04,
                          "max_voxels": 50000, "num_points": 16384}
PT_EVAL_BATCH = 2
PT_TRAIN_BATCH = (3, 3)
PT_TRAIN_STEPS = (3, 1)
PT_FORWARD_LAUNCHES = {"knn_exact": 26, "fps": 4}
# kernels vs plain versions in one forward: the same neighbours and
# samples, so only the launches' order of float work may differ
PT_PLAIN_TOL = 1e-5
PT_ROOMS = ("Area_1_office_1", "Area_1_office_2", "Area_2_office_1",
            "Area_5_office_1")
PT_ROOM_POINTS = 80_000
# fps beyond the forward's levels: (N, m) just past one CTA's share,
# beyond 16,384 points, and at the kernel's MAX_POINTS
PT_FPS_EXTRA = ((1_025, 256), (24_576, 512), (32_768, 512))
# cluster sizes timed at 16,384 points, the forward's first level
PT_FPS_CLUSTERS = (4, 8, 16)
# PointTransformer's fused path (``knn_method: fused``) at the same config:
# one forward's 13 searches and 26 gathers (18 attention, 4 grouping, 4
# upsample reads at blocks [2, 3, 4, 6, 3]), a step's 26 gather backwards
PT_FUSED_FORWARD_LAUNCHES = {"bucket_knn": 13, "bucket_gather": 26}
PT_FUSED_STEP_LAUNCHES = dict(PT_FUSED_FORWARD_LAUNCHES,
                              bucket_gather_bwd=26)
PT_FUSED_TOL = 1e-4  # card vs CPU, float32: logits, gradients, statistics
PT_FUSED_LOSS_TOL = 1e-5  # card vs CPU, float32: a step's loss, relative
# KPConv (KPFCNN): the port's YAMLs, the bench's lidar request
# (bench.py:430, ``child_kpconv``), the command line's SemanticKITTI
# scans and the S3DIS room of the test area
KP_CONFIGS = {"semantickitti":
              "open3d_ml_tpu_torch/configs/kpconv_semantickitti.yml",
              "s3dis": "open3d_ml_tpu_torch/configs/kpconv_s3dis.yml"}
KP_TOL = 1e-4  # card vs CPU: the forward's relative L2, the step's gradient
KP_LOSS_TOL = 1e-5  # card vs CPU: the step's loss, relative
KP_TRAIN_SCANS = {"00": 4, "08": 1}  # 4 train steps of 1, 1 validation
KP_TEST_ROOM = "Area_5_office_1"  # test_area_idx: 5
# the methods whose seconds a command-line run of the phase reports
KP_TIMED = ((tkp.KPFCNN, "transform"), (tkp.KPFCNN, "preprocess"),
            (SemanticSegmentation, "__init__"),
            (PointCloudDataloader, "__init__"),
            (SemanticSegmentation, "save_ckpt"),
            (SemanticSegmentation, "load_ckpt"))
KP_RANGES = ("kpconv eval forward", "kpconv train forward",
             "kpconv backward", "kpconv sgd")
# the model section of open3d_ml_tpu_torch/configs/pointrcnn_kitti.yml but
# for its name, checkpoint and augment section (a CPU test pins it); it
# says mode RPN, the first training stage, and serving runs mode RCNN
POINTRCNN_KITTI = {
    "point_cloud_range": [0, -40, -1, 70.4, 40, 3],
    "classes": ["Car"], "npoints": 16384, "score_thres": 0.3, "mode": "RPN",
    "rpn": {"backbone": {"in_channels": 0,
                         "SA_config": {
                             "npoints": [4096, 1024, 256, 64],
                             "radius": [[0.1, 0.5], [0.5, 1.0], [1.0, 2.0],
                                        [2.0, 4.0]],
                             "nsample": [[16, 32], [16, 32], [16, 32],
                                         [16, 32]],
                             "mlps": [[[16, 16, 32], [32, 32, 64]],
                                      [[64, 64, 128], [64, 96, 128]],
                                      [[128, 196, 256], [128, 196, 256]],
                                      [[256, 256, 512], [256, 384, 512]]]},
                         "fp_mlps": [[128, 128], [256, 256], [512, 512],
                                     [512, 512]]},
            "cls_in_ch": 128, "cls_out_ch": [128], "reg_in_ch": 128,
            "reg_out_ch": [128], "db_ratio": 0.5,
            "focal_loss": {"gamma": 2.0, "alpha": 0.25, "loss_weight": 1.0},
            "loss_weight": [1.0, 1.0],
            "head": {"loc_xz_fine": True, "loc_scope": 3.0,
                     "loc_bin_size": 0.5, "num_head_bin": 12,
                     "nms_pre": 9000, "nms_post": 512, "nms_thres": 0.85,
                     "nms_post_val": 100, "nms_thres_val": 0.8,
                     "mean_size": [1.52563191462, 1.62856739989,
                                   3.88311640418]}},
    "rcnn": {"in_channels": 128, "xyz_up_layer": [128, 128],
             "cls_out_ch": [256, 256], "reg_out_ch": [256, 256],
             "SA_config": {"npoints": [128, 32, -1],
                           "radius": [0.2, 0.4, 100],
                           "nsample": [64, 64, 64],
                           "mlps": [[128, 128, 128], [128, 128, 256],
                                    [256, 256, 512]]},
             "head": {"loc_xz_fine": True, "get_y_by_bin": False,
                      "loc_y_scope": 0.5, "loc_y_bin_size": 0.25,
                      "get_ry_fine": True, "loc_scope": 1.5,
                      "loc_bin_size": 0.5, "num_head_bin": 9,
                      "mean_size": [1.52563191462, 1.62856739989,
                                    3.88311640418],
                      "post_process": False, "nms_thres": 0.1,
                      "nms_pre": 100, "nms_post": 100},
             "target_head": {"pool_extra_width": 1.0, "num_points": 512,
                             "reg_fg_thresh": 0.55, "cls_fg_thresh": 0.6,
                             "cls_bg_thresh": 0.45, "cls_bg_thresh_lo": 0.05,
                             "fg_ratio": 0.5, "roi_per_image": 100,
                             "aug_rot_range": 18, "hard_bg_ratio": 0.8,
                             "roi_fg_aug_times": 10}},
}
POINTRCNN_PIPELINE = {"val_batch_size": 1, "test_batch_size": 1,
                      "overlaps": [0.7], "difficulties": [0, 1, 2],
                      "similar_classes": {"Van": "Car"}}
PRCNN_CONFIG = "open3d_ml_tpu_torch/configs/pointrcnn_kitti.yml"
# one RCNN-mode forward of a frame: 8 RPN ball queries (k = 16 and 32),
# 4 three-NN (k = 3), 2 RCNN ball queries (k = 64); 4 + 2 FPS; one NMS
# call for both proposal buckets; inference_end adds one NMS call
PRCNN_FORWARD_LAUNCHES = {"knn_exact": 14, "fps": 6, "nms_bev": 1}
PRCNN_SERVE_LAUNCHES = dict(PRCNN_FORWARD_LAUNCHES, nms_bev=2)
# one training step: mode RPN runs the RPN alone (8 ball queries, 4
# three-NN, 4 FPS); mode RCNN the whole forward, its proposal layer at
# training's nms_post 512 and nms_thres 0.85
PRCNN_TRAIN_LAUNCHES = {"RPN": {"knn_exact": 12, "fps": 4, "nms_bev": 0},
                        "RCNN": PRCNN_FORWARD_LAUNCHES}
PRCNN_TOL = 1e-4  # card vs CPU, relative L2
PRCNN_LOSS_TOL = 1e-5  # card vs CPU, a training step's loss, relative
PRCNN_TRAIN_FRAMES = 4  # prcnn_scene seeds 220-223 as KITTI training frames
PRCNN_TRAIN_VALID = 1  # the last of them, the validation split
PRCNN_TRAIN_STEPS = 6  # timed steps a mode, the first not counted
# the shipped YAML's pipeline.optimizer
POINTRCNN_TRAIN_OPTIMIZER = {"optimizer": {"lr": 0.002, "betas": [0.9, 0.99],
                                           "weight_decay": 0.001}}
PRCNN_IOU_NEAR = 1e-6  # a keep decision may differ only this near the
                       # threshold
# float operations of one overlapping pair's clip in csrc/nms_bev.cu, at
# about 8 candidate vertices: 8 inside tests (12 each), 16 edge
# intersections (22 each: differences, cross products, two divisions, the
# tests, the point), the centroid (20), 8 angles (atan2f ~20 and two
# differences each), the sort (16) and the shoelace (32), the IoU (4)
NMS_PAIR_OPS = 700
PRCNN_TEST_FRAMES = 4  # prcnn_scene seeds 200-203 as KITTI frames
PRCNN_VALID_FRAMES = 2  # seeds 210-211, the validation split
PRCNN_STAGES = ("rpn", "proposal", "roipool3d", "rcnn", "inference_end")
PRCNN_R_MAX = 70.4  # the YAML's point_cloud_range reaches 70.4 m ahead
KITTI_CALIB = (f"P0: {KITTI_P}", f"P1: {KITTI_P}", f"P2: {KITTI_P}",
               f"P3: {KITTI_P}", "R0_rect: 1 0 0 0 1 0 0 0 1",
               f"Tr_velo_to_cam: {KITTI_TR}", f"Tr_imu_to_velo: {KITTI_TR}")


PVCNN_CONFIG = "open3d_ml_tpu_torch/configs/pvcnn_s3dis.yml"
# the model section of pvcnn_s3dis.yml and the pipeline keys the pvcnn
# phase reads (a CPU test pins both)
PVCNN_S3DIS = {"num_classes": 13, "num_points": 40960,
               "extra_feature_channels": 6, "width_multiplier": 1,
               "voxel_resolution_multiplier": 2, "ignored_label_inds": [-1]}
PVCNN_PIPELINE = {"batch_size": 4, "val_batch_size": 4,
                  "optimizer": {"lr": 0.001, "weight_decay": 0.00001,
                                "betas": [0.9, 0.999]},
                  "scheduler_gamma": 0.99}
PV_BATCH = PVCNN_PIPELINE["batch_size"]
# areas 1-4 train, area 5 (the YAML's test_area_idx) validates
PV_ROOMS = ("Area_1_office_1", "Area_2_office_1", "Area_3_office_1",
            "Area_4_office_1", "Area_5_office_1")
PV_ROOM_POINTS = 80_000  # preprocess draws 40,960 of them
# one devoxelisation a PVConv block, one plan per resolution (64 and 32)
PV_FORWARD_LAUNCHES = {"trilinear_devoxelize": 4,
                       "trilinear_devoxelize_plan": 2}
PV_STEP_LAUNCHES = dict(PV_FORWARD_LAUNCHES, trilinear_devoxelize_bwd=4)
PV_TOL = 1e-4  # card vs CPU: the forward's relative L2; BN statistics
PV_LOSS_TOL = 1e-5  # card vs CPU: a step's loss, relative
# the card's float64 step (the devoxelisation's plain version) against the
# CPU's, relative: the loss's class weights stay float32 (SemSegLoss), and
# their sum over 163,840 points rounds apart on the two devices
PV_F64_TOL = 1e-6
# the card's float32 step's gradients against float64, relative L2 of all
# of them: the global feature's BatchNorm over the batch's 4 samples puts
# float32 gradients 0.7-1.7e-4 from float64 on the card and on the CPU
PV_STEP_F32_TOL = 5e-4
# the backward kernel's float32 sums against a float64 sum of the same
# products, relative L2 over the grid
PV_BWD_TOL = 1e-6
# two float32 sums of the same backward products in different orders with
# 20,480 of them in one cell (``_pv_crowded_coords``): about sqrt(20,480)
# roundings of that cell's sum apart, which holds the grid's norm
PV_CROWDED_BWD_TOL = 1e-5
PV_TIMED_STEPS = 6  # the first not counted
# the plain devoxelisation's (and plain plan's) calls queued at a time
# when it is timed: its ~50 launches a call, 20 calls at a time, would
# fill the launch queue and wake the card before the last was queued
PV_PLAIN_ITERS = 4
PV_TRAIN_STEPS = (2, 1)  # the command line's train and validation steps


def say(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def reset_counts():
    for counts in COUNTERS:
        for key in counts:
            counts[key] = 0


def read_counts():
    return {key: n for counts in COUNTERS for key, n in counts.items()}


def every_count(expected):
    """``expected`` with 0 for every counted kernel it does not name."""
    return dict(dict.fromkeys(read_counts(), 0), **expected)


def check_counts(phase, launches, expected):
    expected = every_count(expected)
    say(phase, f"launched {launches}; expected {expected}")
    if launches != expected:
        raise AssertionError(f"{phase}: launch counts {launches}, expected "
                             f"{expected}")


def span_ms(fn, iters=10, warmup=2):
    """Median of ``iters`` CUDA-event timings of one ``fn()``, in ms. The
    span holds the host's work in the call too (argument checks, ctypes,
    allocation), so it is not a kernel's device time."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, iters=20, warmup=2):
    """Device time of one ``fn()``, in ms: CUDA events around ``iters``
    back-to-back calls that the host queues while the card sleeps, so the
    card runs them without waiting on the host's work per call. Raises if
    the card woke before the last call was queued."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    cycles = 10**7  # about 5 ms at the H100's clock
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        queued_ahead = not start.query()
        end.synchronize()
        if queued_ahead:
            return start.elapsed_time(end) / iters
        cycles *= 4
    raise AssertionError("the host could not queue the calls ahead of the "
                         "card")


def timings(fn, plain, plain_iters=20):
    """(kernel ms, plain ms, kernel span ms, plain span ms) of two calls; the
    plain version queued ``plain_iters`` calls at a time."""
    return (device_ms(fn), device_ms(plain, iters=plain_iters), span_ms(fn),
            span_ms(plain))


def bound(size, ops, dtype="float32"):
    """(ms of ``size`` bytes at the memory rate, ms of ``ops`` at the peak
    for ``dtype``): the least time the card could take is the larger."""
    return (size / HBM_BYTES_PER_S * 1e3,
            ops / PEAK_OPS_PER_S[dtype] * 1e3)


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def kernel_record(err, ms, plain_ms, bounds, library_ms=None):
    """A kernel's entry of the closing JSON line at one shape, but for its
    name and launches; ``bounds`` as ``bound`` gives them."""
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bounds": bounds, "bound_ms": max(bounds),
            "library_ms": library_ms}


def combine(records):
    """Several shapes of one kernel as one entry: the largest error, the
    sums of the times and of the shapes' bounds, bound by whichever of
    bytes and operations takes the larger share of it (the library time
    only where every shape has one)."""
    lib = [r["library_ms"] for r in records]
    by_bytes = sum(r["bounds"][0] for r in records)
    by_ops = sum(r["bounds"][1] for r in records)
    return {"max_abs_err": max(r["max_abs_err"] for r in records),
            "ms": sum(r["ms"] for r in records),
            "plain_ms": sum(r["plain_ms"] for r in records),
            "bounds": (by_bytes, by_ops),
            "bound_ms": sum(r["bound_ms"] for r in records),
            "library_ms": None if None in lib else sum(lib)}


def json_entry(name, source, replaces, launches, rec):
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": ("bytes" if rec["bounds"][0] >= rec["bounds"][1]
                         else "operations"),
            "library_ms": rec["library_ms"]}


def phase_device():
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this check runs only on a card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(card, flush=True)  # as nvidia-smi gives it: name, power limit
    say("device", f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    say("device", "modules the port imports only to read a file or a "
        "config: " + ", ".join(
            f"{name} {importlib.metadata.version(dist)}"
            if importlib.util.find_spec(name) else f"{name} absent"
            for name, dist in OPTIONAL_MODULES))
    return card


def _kernel_name(mangled):
    """knn_exact_kernel<2> for the mangled name of a kernel template."""
    m = re.search(r"([A-Za-z_]+_kernel)(I(?:L[ib]\d+E)+E)?", mangled)
    if not m:
        return mangled
    args = [v if kind == "i" else ("false", "true")[int(v)]
            for kind, v in re.findall(r"L([ib])(\d+)E", m.group(2) or "")]
    return m.group(1) + (f"<{','.join(args)}>" if args else "")


def ptxas_kernels(text, sources):
    """(kernel, registers, spill store bytes, spill load bytes) of each
    kernel that ptxas reported on in ``sources``, from a build's log."""
    out, source, name, spill = [], None, None, (0, 0)
    for line in text.splitlines():
        if line.startswith("== "):
            source = line[3:].strip()
        elif source in sources:
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                name = _kernel_name(m.group(1))
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m:
                spill = (int(m.group(1)), int(m.group(2)))
            m = re.search(r"Used (\d+) registers", line)
            if m and name:
                out.append((name, int(m.group(1)), *spill))
                name = None
    return out


def phase_build():
    path, seconds = _build.build()
    _build.library()
    say("build", f"{path.relative_to(REPO)} built in {seconds:.2f} s "
        "(0 = already built)")
    log = path.with_suffix(".ptxas.txt")
    if log.exists():  # an older checkout's build keeps no report
        kernels = ptxas_kernels(log.read_text(),
                                ("knn_exact.cu", "bucket_knn.cu"))
        say("build", "KNN kernels, registers and spill store/load bytes: " +
            ", ".join(f"{name} {regs} regs {st}/{ld} B"
                      for name, regs, st, ld in kernels))
        if any(st or ld for _, _, st, ld in kernels):
            raise AssertionError("a KNN kernel spills registers")
        kernels = ptxas_kernels(log.read_text(), ("fps.cu", "nms_bev.cu"))
        say("build", "fps and nms_bev kernels, registers and spill "
            "store/load bytes: " + ", ".join(
                f"{name} {regs} regs {st}/{ld} B"
                for name, regs, st, ld in kernels))
        if any(st or ld for _, _, st, ld in kernels):
            raise AssertionError("an fps or nms_bev kernel spills registers")
        say("build", "devoxelisation kernels, registers and spill "
            "store/load bytes: " + ", ".join(
                f"{name} {regs} regs {st}/{ld} B"
                for name, regs, st, ld in ptxas_kernels(
                    log.read_text(), ("trilinear_devoxelize.cu",))))
    plans = []
    for n in (16_384, 4_096, 1_024, 256, 512, 128, *dict(PT_FPS_EXTRA)):
        cluster, threads = cfps.fps_plan(n)
        plans.append(f"N={n} {cluster} x {threads} threads, "
                     f"{cfps.max_clusters(0, cluster, threads, n)}")
    say("build", "fps plans (CTAs a cloud x threads a CTA, "
        "cudaOccupancyMaxActiveClusters): " + "; ".join(plans))


def _sm_clock_hz():
    """The card's top SM clock, as nvidia-smi reads it."""
    mhz = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,"
         "nounits"], check=True, capture_output=True, text=True,
        timeout=60).stdout.split()[0]
    return float(mhz) * 1e6


def issue_floor_ms(pairs, ops):
    """The least time ``pairs`` candidate distances of ``ops`` FP32-pipe
    instructions each take at the card's top clock."""
    return pairs * ops / (FP32_LANES * _sm_clock_hz()) * 1e3


def _captured(module, name, fn):
    """The (args, kwargs) of each call that ``fn()`` makes to
    ``module.name``; the calls still run."""
    calls = []
    real = getattr(module, name)

    def record(*args, **kwargs):
        calls.append((args, kwargs))
        return real(*args, **kwargs)

    setattr(module, name, record)
    try:
        fn()
    finally:
        setattr(module, name, real)
    return calls


def lattice_points(b, n, seed):
    """[b, n, 3] distinct points of the 1/32 grid in [-4, 4)^3 on the card:
    every d2 is exact in float32 and repeats many times, so the kernels'
    tie order shows."""
    rng = np.random.default_rng(seed)
    v = np.stack([rng.choice(256 ** 3, n, replace=False) for _ in range(b)])
    grid = np.stack([v % 256, (v // 256) % 256, v // 65536], -1)
    return torch.from_numpy((grid / 32.0 - 4.0).astype(np.float32)).to(DEVICE)


def fused_searches(points, model_cfg, num_segs, gather_segs):
    """The bucket_knn calls of one fused pyramid on ``points`` [B, N, 3]
    (``build_bucket_pyramid`` as the net builds it), each as (label, args,
    kwargs): every level's neighbour search and, where a level's points
    are no whole number of query blocks, its pool search, which reuses the
    neighbour search's table."""
    calls = _captured(tb, "knn_bucket", lambda: tb.build_bucket_pyramid(
        points, model_cfg.num_neighbors, model_cfg.sub_sampling_ratio,
        seg=model_cfg.seg, qblock=model_cfg.block, num_segs=num_segs,
        gather_segs=gather_segs))
    out, level = [], -1
    for i, (args, kwargs) in enumerate(calls):
        pool = i > 0 and args[0] is calls[i - 1][0][0]
        level += not pool
        out.append((f"level-{level} {'pool' if pool else 'neighbour'}", args,
                    kwargs))
    return out


def _differ_only_at_ties(name, got, want, d2):
    """Raise unless the index rows ``got`` and ``want`` differ only at
    entries whose d2 ties with a neighbour in the row; returns the mask of
    rows that differ."""
    rows = (got != want).any(-1)
    if rows.any():
        pair = d2[..., 1:] == d2[..., :-1]
        edge = torch.zeros_like(pair[..., :1])
        tied = torch.cat([edge, pair], -1) | torch.cat([pair, edge], -1)
        if ((got != want) & ~tied).any():
            raise AssertionError(f"{name}: indices differ off a d2 tie")
    return rows


def _unsplit(fn):
    """``fn()`` with every bucket_knn call planned for a card of one SM,
    which splits no query block's table over blocks."""
    real = cb.knn_bucket_plan
    cb.knn_bucket_plan = lambda *args, sms: real(*args, sms=1)
    try:
        return fn()
    finally:
        cb.knn_bucket_plan = real


def _knn_check(label, pcp, queries, sids, k, *, seg, qblock, lattice=False):
    """bucket_knn against its plain version on one search: d2 bit-equal;
    rel equal row for row on lattice points, else off d2 ties only. On
    lattice points only checks; else returns its record (error: max |d2
    difference|). Bound: the points, queries and tables read and the
    [B, Q, k] outputs written; 8 float32 operations for each candidate
    distance. Where the plan splits a query block's table over blocks,
    the same search unsplit is checked and timed beside it."""
    rel_k, d2_k = cb.knn_bucket(pcp, queries, sids, k, seg=seg, qblock=qblock)
    rel_p, d2_p = cb.knn_bucket_plain(pcp, queries, sids, k, seg=seg,
                                      qblock=qblock)
    torch.cuda.synchronize()
    b, q, _ = queries.shape
    name = (f"bucket_knn {label} B={b} Q={q} S={sids.shape[-1]} seg={seg} "
            f"qblock={qblock} k={k}")
    if not torch.equal(d2_k.view(torch.int32), d2_p.view(torch.int32)):
        raise AssertionError(f"{name}: d2 differs from the plain version")
    if lattice:
        if not torch.equal(rel_k, rel_p):
            raise AssertionError(f"{name}, lattice: rel differs from the "
                                 "plain version")
        return None
    rows = _differ_only_at_ties(name, rel_k, rel_p, d2_p)
    err = (d2_k - d2_p).abs().max().item()
    ms, plain_ms, span, plain_span = timings(
        lambda: cb.knn_bucket(pcp, queries, sids, k, seg=seg, qblock=qblock),
        lambda: cb.knn_bucket_plain(pcp, queries, sids, k, seg=seg,
                                    qblock=qblock))
    pairs = b * q * sids.shape[-1] * seg
    bounds = bound(nbytes(pcp, queries, sids) + b * q * k * 8, pairs * 8)
    floor = issue_floor_ms(pairs, BUCKET_KNN_PIPE_OPS)
    groups = cb.knn_bucket_plan(b, q, sids.shape[-1], seg, qblock,
                                sms=cb.sm_count(pcp.device.index))["groups"]
    split = ""
    if groups > 1:
        one = _unsplit(lambda: cb.knn_bucket(pcp, queries, sids, k, seg=seg,
                                             qblock=qblock))
        if not torch.equal(one[1].view(torch.int32), d2_k.view(torch.int32)):
            raise AssertionError(f"{name}: the unsplit search's d2 differs")
        one_ms = _unsplit(lambda: device_ms(lambda: cb.knn_bucket(
            pcp, queries, sids, k, seg=seg, qblock=qblock)))
        split = (f"; each query block's table split over {groups} blocks, "
                 f"unsplit {one_ms:.4f} (d2 bit-equal)")
    say("kernels", f"{name}: rel equal on {int((~rows).sum())}/{rows.numel()}"
        f" rows ({int(rows.sum())} differ at d2 ties), d2 bit-equal; device "
        f"ms: kernel {ms:.4f}, plain {plain_ms:.4f}, bound {max(bounds):.4f},"
        f" issue floor {floor:.4f}{split}; call span ms: kernel {span:.4f}, "
        f"plain {plain_span:.4f}")
    return kernel_record(err, ms, plain_ms, bounds)


def _knn_levels(model_cfg, pts, lattice):
    """bucket_knn at every search of the fused pyramid, at the inference
    and the training budget, on ``pts`` and (checks only) on ``lattice``;
    returns the records of the level-0 search at the inference budget and
    of each budget's searches in all."""
    seg, qblock = model_cfg.seg, model_cfg.block
    out = {}
    for num_segs, gather_segs in (
            (model_cfg.infer_num_segs, model_cfg.infer_gather_segs),
            (model_cfg.num_segs, model_cfg.gather_segs)):
        for label, args, kwargs in fused_searches(lattice, model_cfg,
                                                  num_segs, gather_segs):
            _knn_check(label, *args, **kwargs, lattice=True)
        say("kernels", f"bucket_knn S{num_segs}, lattice points: every search"
            " of the fused pyramid bit-equal, rel row for row")
        recs = [_knn_check(label, *args, **kwargs) for label, args, kwargs in
                fused_searches(pts, model_cfg, num_segs, gather_segs)]
        out[num_segs] = recs
        total = combine(recs)
        say("kernels", f"bucket_knn S{num_segs}, the fused pyramid's "
            f"{len(recs)} searches: device ms kernel {total['ms']:.4f}, plain "
            f"{total['plain_ms']:.4f}, bound {total['bound_ms']:.4f} in all "
            f"(level 0: kernel {recs[0]['ms']:.4f}, bound "
            f"{recs[0]['bound_ms']:.4f})")
    return out[model_cfg.infer_num_segs][0]


def _gather_check(label, values, seg_ids, rel, seg, qblock):
    """bucket_gather against its plain version, rounding off and on;
    returns its record with rounding on. Bound: the values and tables
    read once, the [B, Q, K, C] output written. Library call:
    ``torch.gather`` of the same rows, their indices computed ahead."""
    b, q, k = rel.shape
    c = values.shape[2]
    rows = cb._bucket_rows(seg_ids, rel, seg=seg, qblock=qblock)
    idx = rows.reshape(b, -1, 1).expand(-1, -1, c)
    library_ms = device_ms(lambda: torch.gather(values, 1, idx))
    bounds = bound(nbytes(values, seg_ids, rel) + b * q * k * c * 4, 0)
    out = {}
    for round_bf16 in (False, True):
        kw = dict(seg=seg, qblock=qblock, round_bf16=round_bf16)
        got = cb.gather_bucket(values, seg_ids, rel, **kw)
        ref = cb.gather_bucket_plain(values, seg_ids, rel, **kw)
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            raise AssertionError(f"bucket_gather {label} round_bf16="
                                 f"{round_bf16}: differs from the plain "
                                 "version")
        ms, plain_ms, span, plain_span = timings(
            lambda: cb.gather_bucket(values, seg_ids, rel, **kw),
            lambda: cb.gather_bucket_plain(values, seg_ids, rel, **kw))
        say("kernels", f"bucket_gather {label} B={rel.shape[0]} "
            f"Q={rel.shape[1]} K={rel.shape[2]} C={values.shape[2]} "
            f"S={seg_ids.shape[-1]} qblock={qblock} round_bf16={round_bf16}:"
            f" equal; device ms: kernel {ms:.4f}, plain {plain_ms:.4f}; call "
            f"span ms: kernel {span:.4f}, plain {plain_span:.4f}; "
            f"torch.gather {library_ms:.4f}; bound {bounds[0]:.4f} (bytes)")
        out[round_bf16] = kernel_record(
            (got - ref).abs().max().item(), ms, plain_ms, bounds, library_ms)
    return out[True]


def _gather_bwd_check(label, seg_ids, rel, npad, c, seg, qblock, gen,
                      mask=None):
    """bucket_gather_bwd against its plain version at one shape, rounding
    off and on: bit-equal on dyadic cotangents (integers in [-4096, 4096]
    over 64, whose sums are exact in float32 in any order), and on random
    normal ones within the bound of float32 summation in any order,
    |err| <= n * 2^-24 * sum |g| over a row's n readers, of a float64
    reference. Cotangent rows where the [B, Q, K] ``mask`` is False are 0,
    as ``stencil_conv_bwd`` masks its misses. Returns its record with
    rounding on (error on normal cotangents). Bound: the cotangents and
    tables read, the [B, npad, C] gradient written, one float32 add per
    cotangent value. Library call: ``scatter_add_`` of the same rows, their
    indices computed ahead."""
    dev = rel.device
    shape = (*rel.shape, c)
    rows = cb._bucket_rows(seg_ids, rel, seg=seg, qblock=qblock)
    idx = rows.reshape(rel.shape[0], -1, 1).expand(-1, -1, c)
    dyadic = torch.randint(-4096, 4097, shape, generator=gen,
                           device=dev).float() / 64
    normal = torch.randn(shape, generator=gen, device=dev)
    if mask is not None:
        dyadic = dyadic * mask[..., None]
        normal = normal * mask[..., None]
    readers = cb.gather_bucket_bwd_plain(
        torch.ones(shape, dtype=torch.float64, device=dev), seg_ids, rel,
        npad, seg=seg, qblock=qblock, round_bf16=False)
    bounds = bound(nbytes(normal, seg_ids, rel) + rel.shape[0] * npad * c * 4,
                   normal.numel())
    out = {}
    for round_bf16 in (False, True):
        kw = dict(seg=seg, qblock=qblock, round_bf16=round_bf16)
        got = cb.gather_bucket_bwd(dyadic, seg_ids, rel, npad, **kw)
        ref = cb.gather_bucket_bwd_plain(dyadic, seg_ids, rel, npad, **kw)
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            raise AssertionError(f"bucket_gather_bwd {label} round_bf16="
                                 f"{round_bf16}: differs from the plain "
                                 "version on dyadic cotangents")
        g = normal.bfloat16().float() if round_bf16 else normal
        got = cb.gather_bucket_bwd(normal, seg_ids, rel, npad, **kw)
        ref64 = cb.gather_bucket_bwd_plain(g.double(), seg_ids, rel, npad,
                                           seg=seg, qblock=qblock,
                                           round_bf16=False)
        abs_sum = cb.gather_bucket_bwd_plain(g.double().abs(), seg_ids, rel,
                                             npad, seg=seg, qblock=qblock,
                                             round_bf16=False)
        err = (got.double() - ref64).abs()
        limit = readers * 2.0 ** -24 * abs_sum
        if (err > limit).any():
            raise AssertionError(f"bucket_gather_bwd {label} round_bf16="
                                 f"{round_bf16}: error past the float32 "
                                 "summation bound on normal cotangents")
        ms, plain_ms, span, plain_span = timings(
            lambda: cb.gather_bucket_bwd(normal, seg_ids, rel, npad, **kw),
            lambda: cb.gather_bucket_bwd_plain(normal, seg_ids, rel, npad,
                                               **kw))
        say("kernels", f"bucket_gather_bwd {label} B={rel.shape[0]} "
            f"Q={rel.shape[1]} K={rel.shape[2]} C={c} npad={npad} "
            f"S={seg_ids.shape[-1]} qblock={qblock} round_bf16={round_bf16}:"
            f" equal on dyadic cotangents; normal: max |err| "
            f"{err.max().item():.3e} vs float64, within n * 2^-24 * sum|g| "
            f"(max readers per row {int(readers.max().item())}); device ms: "
            f"kernel {ms:.4f}, plain {plain_ms:.4f}; call span ms: kernel "
            f"{span:.4f}, plain {plain_span:.4f}; bound {max(bounds):.4f} "
            "(bytes)")
        out[round_bf16] = kernel_record(err.max().item(), ms, plain_ms,
                                        bounds)
    dv = torch.zeros((rel.shape[0], npad, c), device=dev)
    rows_g = normal.reshape(rel.shape[0], -1, c)
    out[True]["library_ms"] = device_ms(lambda: dv.scatter_add_(1, idx,
                                                                rows_g))
    say("kernels", f"bucket_gather_bwd {label}: scatter_add_ device ms "
        f"{out[True]['library_ms']:.4f}")
    return out[True]


def phase_kernels(model_cfg):
    """The kernels against their plain versions at the main paths' shapes:
    every search of the fused pyramid at the inference and the training
    budget, on uniform and on lattice points; one
    neighbour, pool and upsample gather from the inference pyramid of the
    same batch and the level-0 neighbour gather from its training pyramid;
    the gather backward at four shapes of the training step. Returns the
    search's record and the (label, record) pairs of the gather and of its
    backward."""
    dev = torch.device(DEVICE)
    b, n = 4, model_cfg.num_points
    seg, qblock = model_cfg.seg, model_cfg.block
    gen = torch.Generator(device=dev).manual_seed(SEED)
    pts = torch.rand((b, n, 3), generator=gen, device=dev) * 50 - 25
    knn = _knn_levels(model_cfg, pts, lattice_points(b, n, SEED))

    pyr = tb.build_bucket_pyramid(
        pts, model_cfg.num_neighbors, model_cfg.sub_sampling_ratio, seg=seg,
        qblock=qblock, num_segs=model_cfg.infer_num_segs,
        gather_segs=model_cfg.infer_gather_segs)
    train_pyr = tb.build_bucket_pyramid(
        pts, model_cfg.num_neighbors, model_cfg.sub_sampling_ratio, seg=seg,
        qblock=qblock, num_segs=model_cfg.num_segs,
        gather_segs=model_cfg.gather_segs)

    def values(rows, c):
        return tb.pad_seg(torch.randn((b, rows, c), generator=gen,
                                      device=dev), seg)

    def tables(p, name, level):
        return (p[f"{name}_seg_ids"][level], p[f"{name}_rel"][level], seg,
                p[f"{name}_qblock"][level])

    n1, n3 = (pyr["coords"][i].shape[1] for i in (1, 3))
    # level 1's first neighbour gather (3 coords + 32 features), its pool
    # gather (2 * 64 channels) and the decoder's first upsample (level 4's
    # 2 * 256 channels onto level 3)
    gathers = [
        (f"RandLA level-{level} {label}",
         _gather_check(label, values(rows, c), *tables(pyr, name, level)))
        for label, level, name, rows, c in (
            ("neighbour", 1, "nbr", n1, 35), ("pool", 1, "pool", n1, 128),
            ("upsample", 3, "up", n3 // 4, 512))]
    # the sum over these three shapes, printed on its own for comparison
    gather = combine([rec for _, rec in gathers])
    say("kernels", f"bucket_gather, three shapes at round_bf16=True: device "
        f"ms: kernel {gather['ms']:.4f}, plain {gather['plain_ms']:.4f}, "
        f"torch.gather {gather['library_ms']:.4f}, bound "
        f"{gather['bound_ms']:.4f} in all")
    gathers.append(("RandLA training level-0 neighbour", _gather_check(
        "training level-0 neighbour", values(n, 11),
        *tables(train_pyr, "nbr", 0))))

    # the largest gather of a training step (3 coords + 8 features at level
    # 0) and the three shapes above, at the training budget
    bwds = []
    for label, name, level, rows, c in (
            ("level-0 neighbour", "nbr", 0, n, 11),
            ("level-1 neighbour", "nbr", 1, n1, 35),
            ("level-1 pool", "pool", 1, n1, 128),
            ("level-3 upsample", "up", 3, n3 // 4, 512)):
        sids, rel, _, qb = tables(train_pyr, name, level)
        bwds.append((f"RandLA training {label}", _gather_bwd_check(
            label, sids, rel, -(-rows // seg) * seg, c, seg, qb, gen)))
    # the sum over these four shapes, printed on its own for comparison
    bwd = combine([rec for _, rec in bwds])
    say("kernels", f"bucket_gather_bwd, four shapes at round_bf16=True: "
        f"device ms: kernel {bwd['ms']:.4f}, plain {bwd['plain_ms']:.4f}, "
        f"scatter_add_ {bwd['library_ms']:.4f}, bound "
        f"{bwd['bound_ms']:.4f} in all")
    return knn, gathers, bwds


def bucket_summary(name, records, library):
    """One kernel's (label, record) pairs at every checked shape as one
    entry of the closing JSON line, and a line that names the shapes where
    the kernel is slower than its library call."""
    rec = combine([r for _, r in records])
    slower = [f"{label} ({r['ms']:.4f} vs {r['library_ms']:.4f})"
              for label, r in records if r["ms"] > r["library_ms"]]
    say("kernels", f"{name}, {len(records)} shapes at round_bf16=True: "
        f"device ms: kernel {rec['ms']:.4f}, plain {rec['plain_ms']:.4f}, "
        f"{library} {rec['library_ms']:.4f}, bound {rec['bound_ms']:.4f} in "
        f"all; kernel / {library} by shape: " +
        ", ".join(f"{label} {r['ms'] / r['library_ms']:.3f}"
                  for label, r in records) +
        f"; share of bound: {rec['bound_ms'] / rec['ms']:.1%} in all; "
        f"slower than {library} at: {'; '.join(slower) or 'no shape'}")
    return rec


def _cdist_topk(points, queries, k):
    """knn_exact's yardstick, not the same function (its distances are
    square roots of another formula, so its rounding and ties differ):
    ``torch.topk(torch.cdist(q, p), k, largest=False)`` over chunks of
    ``CDIST_CHUNK`` queries."""
    return [torch.topk(torch.cdist(queries[:, s:s + CDIST_CHUNK], points), k,
                       largest=False)
            for s in range(0, queries.shape[1], CDIST_CHUNK)]


def _exact_equal(name, got, want, rows_equal):
    """Raise unless knn_exact's (idx, d2) has the plain version's d2 bit for
    bit and its indices row for row (``rows_equal``) or off d2 ties;
    returns the mask of rows that differ."""
    torch.cuda.synchronize()
    if not torch.equal(got[1].view(torch.int32), want[1].view(torch.int32)):
        raise AssertionError(f"{name}: d2 differs from the plain version")
    if rows_equal and not torch.equal(got[0], want[0]):
        raise AssertionError(f"{name}: indices differ from the plain "
                             "version")
    return _differ_only_at_ties(name, got[0], want[0], want[1])


def phase_knn_exact(model_cfg):
    """knn_exact against its plain version at every level of the eval
    pyramid (one sample, queries = points, 45,056 / 11,264 / 2,816 / 704):
    on seeded uniform points d2 bit-equal and indices equal off d2 ties,
    on lattice points indices row for row; at level 2 with a mask that
    leaves one sample of a batch of 2 five valid points (the masked ones
    follow them in index order). Returns its record for the four levels
    (one eval forward's launches: the sums of the times and bounds). The
    plain version's time is its call span: it launches about 18 kernels
    per block of queries, more than the host can queue ahead while the
    card sleeps. Bound: points and queries
    read, [1, N, k] outputs written, 8 float32 operations per candidate
    distance; beside it the issue floor of the kernel's 8 FP32-pipe
    instructions a distance, and the call span of the chunked
    ``torch.cdist`` + ``topk`` yardstick (its kernels cannot all be queued
    ahead of the card)."""
    dev = torch.device(DEVICE)
    k = model_cfg.num_neighbors
    gen = torch.Generator(device=dev).manual_seed(SEED)
    pts = torch.rand((1, model_cfg.num_points, 3), generator=gen,
                     device=dev) * 50 - 25
    out = []
    for level in range(model_cfg.num_layers):
        n = pts.shape[1] // 4 ** level
        sub = pts[:, :n].contiguous()
        got = ck.knn_exact(sub, sub, k)
        want = ck.knn_exact_plain(sub, sub, k)
        rows = _exact_equal(f"knn_exact level {level}", got, want, False)
        lat = lattice_points(1, n, SEED + level)
        _exact_equal(f"knn_exact level {level} lattice", ck.knn_exact(
            lat, lat, k), ck.knn_exact_plain(lat, lat, k), True)
        note = ""
        if level == 1:
            # the plain version on the CPU gives the same bits
            idx_c, d2_c = ck.knn_exact_plain(sub.cpu(), sub.cpu(), k)
            if not torch.equal(d2_c.view(torch.int32),
                               got[1].cpu().view(torch.int32)):
                raise AssertionError("knn_exact: card d2 differs from the "
                                     "CPU's")
            crows = _differ_only_at_ties("knn_exact CPU", got[0].cpu(), idx_c,
                                         d2_c)
            note = (f"; against the CPU's plain version: d2 bit-equal, "
                    f"indices differ on {int(crows.sum())} rows at d2 ties")
        if level == 2:
            both = lattice_points(2, n, SEED)
            mask = torch.rand((2, n), generator=gen, device=dev) < 0.6
            mask[1] = False
            mask[1, torch.randperm(n, generator=gen, device=dev)[:5]] = True
            want_m = ck.knn_exact_plain(both, both, k, points_mask=mask)
            _exact_equal("knn_exact masked", ck.knn_exact(
                both, both, k, points_mask=mask), want_m, True)
            if not (mask[1][want_m[0][1].long()].sum(-1) == 5).all():
                raise AssertionError("knn_exact masked: not 5 valid first")
            note += ("; B=2 with 5 valid points in sample 1: equal row for "
                     "row, the masked points after the valid ones")
        ms = device_ms(lambda: ck.knn_exact(sub, sub, k))
        span = span_ms(lambda: ck.knn_exact(sub, sub, k))
        plain_span = span_ms(lambda: ck.knn_exact_plain(sub, sub, k),
                             iters=5, warmup=1)
        cdist_ms = span_ms(lambda: _cdist_topk(sub, sub, k), iters=3,
                           warmup=1)
        bounds = bound(2 * nbytes(sub) + n * k * 8, n * n * 8)
        floor = issue_floor_ms(n * n, KNN_EXACT_PIPE_OPS)
        plan = ck.exact_plan(1, n, n, sms=ck.sm_count(dev.index))
        say("kernels", f"knn_exact level {level} B=1 N=Q={n} k={k} (plan "
            f"{plan}): d2 bit-equal, indices equal on {int((~rows).sum())}/"
            f"{rows.numel()} rows ({int(rows.sum())} differ at d2 ties), "
            f"lattice row for row{note}; device ms: kernel {ms:.4f}, bound "
            f"{max(bounds):.4f}, issue floor {floor:.4f}; call span ms: "
            f"kernel {span:.4f}, plain {plain_span:.4f}, torch.cdist + topk "
            f"{cdist_ms:.4f} (not the same function)")
        out.append(dict(kernel_record(
            (got[1] - want[1]).abs().max().item(), ms, plain_span, bounds),
            floor=floor, cdist_ms=cdist_ms))
    say("kernels", "knn_exact, the eval pyramid's four levels: device ms "
        f"kernel {sum(r['ms'] for r in out):.4f}, bound "
        f"{sum(r['bound_ms'] for r in out):.4f}, issue floor "
        f"{sum(r['floor'] for r in out):.4f}; call span ms: plain "
        f"{sum(r['plain_ms'] for r in out):.4f}, torch.cdist + topk "
        f"{sum(r['cdist_ms'] for r in out):.4f}")
    return combine(out)


def random_weights(net, seed):
    """Seeded random weights, with BN statistics that are not the
    identity: a Linear weight [out, in] scaled by 1 / sqrt(in), a stencil
    weight [K, Cin, Cout] by 1 / sqrt(K * Cin)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in net.named_parameters():
            if p.dim() == 2:
                p.copy_(torch.randn(p.shape, generator=gen) / p.shape[1] ** .5)
            elif p.dim() == 3:
                p.copy_(torch.randn(p.shape, generator=gen) /
                        (p.shape[0] * p.shape[1]) ** .5)
            elif p.dim() == 5:  # a Conv3d's [out, in, kd, kh, kw]
                p.copy_(torch.randn(p.shape, generator=gen) /
                        p[0].numel() ** .5)
            elif name.endswith("weight"):  # BatchNorm scales
                p.copy_(torch.rand(p.shape, generator=gen) + 0.5)
            else:
                p.copy_(torch.randn(p.shape, generator=gen) * 0.1)
        for name, buf in net.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_(torch.randn(buf.shape, generator=gen) * 0.2)
            elif name.endswith("running_var"):
                buf.copy_(torch.rand(buf.shape, generator=gen) + 0.5)
    return net


def _compare(gpu, cpu):
    gpu = gpu.double().cpu()
    cpu = cpu.double()
    rel_l2 = ((gpu - cpu).norm() / cpu.norm()).item()
    agree = (gpu.argmax(-1) == cpu.argmax(-1)).double().mean().item()
    return rel_l2, agree


def median_forward_s(net, batch, runs=10, warmup=3):
    """Median synchronised forward time, in seconds, and all the times."""
    times = []
    with torch.no_grad():
        for i in range(warmup + runs):
            t0 = time.perf_counter()
            net(batch)
            torch.cuda.synchronize()
            if i >= warmup:
                times.append(time.perf_counter() - t0)
    return statistics.median(times), times


def phase_slice(model, card):
    dev = torch.device(DEVICE)
    model_cfg = model.cfg
    net = model.get_net()
    state = random_weights(net, SEED).state_dict()
    net = net.eval().to(dev)
    rng = np.random.default_rng(0)
    b, n = 4, model_cfg.num_points
    coords = rng.uniform(-25, 25, (b, n, 3)).astype(np.float32)
    feats = rng.uniform(-25, 25, (b, n, 3)).astype(np.float32)
    batch_cpu = {"coords": torch.from_numpy(coords),
                 "features": torch.from_numpy(feats)}
    batch = {k: v.to(dev) for k, v in batch_cpu.items()}

    with torch.no_grad():
        net(batch)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        logits = net(batch)
        torch.cuda.synchronize()
        launches = read_counts()
    check_counts("slice", launches, EXPECTED_LAUNCHES)
    if tuple(logits.shape) != (b, n, model_cfg.num_classes):
        raise AssertionError(f"logits shape {tuple(logits.shape)}")
    if not torch.isfinite(logits).all():
        raise AssertionError("non-finite logits")
    say("slice", f"logits {tuple(logits.shape)} finite; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # sample 0 against the same model on the CPU (plain versions; eval BN
    # does not depend on the batch)
    sample0 = {k: v[:1] for k, v in batch_cpu.items()}
    for dtype in ("float32", model_cfg.compute_dtype):
        variant = type(model)(**dict(model_cfg.to_dict(),
                                     compute_dtype=dtype))
        cpu_net = variant.get_net()
        cpu_net.load_state_dict(state)
        cpu_net.eval()
        with torch.no_grad():
            t0 = time.perf_counter()
            ref = cpu_net(sample0)[0]
            cpu_s = time.perf_counter() - t0
            if dtype == model_cfg.compute_dtype:
                gpu = logits[0]
            else:
                gpu_net = variant.get_net()
                gpu_net.load_state_dict(state)
                gpu = gpu_net.eval().to(dev)(batch)[0]
        rel_l2, agree = _compare(gpu, ref)
        say("slice", f"sample 0, compute_dtype={dtype}: card vs CPU relative "
            f"L2 {rel_l2:.3e}, argmax agreement {agree:.6f} (CPU forward "
            f"{cpu_s:.1f} s)")
        if dtype == "float32" and not rel_l2 <= 1e-4:
            raise AssertionError(f"float32 relative L2 {rel_l2} > 1e-4")

    fwd, times = median_forward_s(net, batch)
    say("slice", f"forward B={b} N={n} compute_dtype="
        f"{model_cfg.compute_dtype}: median {fwd * 1e3:.2f} ms over "
        f"{len(times)} runs (min {min(times) * 1e3:.2f}, max "
        f"{max(times) * 1e3:.2f}), {b * n / fwd:.0f} points/s on {card}")
    flops = randlanet_forward_flops(
        n, num_neighbors=model_cfg.num_neighbors,
        dim_output=model_cfg.dim_output,
        dim_features=model_cfg.dim_features,
        in_channels=model_cfg.in_channels,
        sub_sampling_ratio=model_cfg.sub_sampling_ratio,
        num_classes=model_cfg.num_classes, batch_size=b)
    peak = peak_flops_for(torch.cuda.get_device_name())
    say("slice", f"forward B={b} N={n}: model FLOPs {flops:.6e} "
        f"(utils/flops.py randlanet_forward_flops), {flops / fwd / 1e12:.3f} "
        f"TFLOP/s at the median, {flops / fwd / peak:.4%} of the "
        f"{peak / 1e12:g} TFLOP/s dense bf16 peak; card {card}")
    return launches


class _FixedDropout(torch.nn.Module):
    """Dropout with a given keep mask, so that two nets drop the same
    elements."""

    def __init__(self, keep):
        super().__init__()
        self.keep = keep

    def forward(self, x):
        if not self.training:
            return x
        return torch.where(self.keep.to(x.device), x * 2.0,
                           torch.zeros_like(x))


def _instrument(pipeline, record):
    """Wrap the pipeline's train and eval steps: each call appends (kind,
    start, end, launch counts, loss) to ``record``, its end taken after a
    synchronise."""
    for kind, name in (("train", "_train_step"), ("eval", "_eval_step")):
        fn = getattr(pipeline, name)

        def wrapper(inputs, loss_fn, fn=fn, kind=kind):
            before = read_counts()
            t0 = time.perf_counter()
            loss, cm = fn(inputs, loss_fn)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            after = read_counts()
            record.append((kind, t0, t1,
                           {k: after[k] - before[k] for k in after},
                           float(loss)))
            return loss, cm

        setattr(pipeline, name, wrapper)


def _train_dataset(root):
    """8 training and 2 validation scenes of 120,000 points, 24 and 4
    patches an epoch (6 and 2 steps), the preprocess cached under
    ``root``."""
    return SyntheticShapes(
        num_points_per_cloud=SCAN_POINTS,
        num_clouds={"training": 8, "validation": 2, "test": 1},
        use_cache=True, cache_dir=str(root / "cache"),
        test_result_folder=str(root / "test"), seed=SEED,
        steps_per_epoch_train=24, steps_per_epoch_valid=4,
        class_weights=SEMANTICKITTI_CLASS_WEIGHTS)


def _check_steps(record, first, last, train=TRAIN_STEP_LAUNCHES,
                 valid=EXPECTED_LAUNCHES, kinds=None):
    """Launch counts (``train`` per train step, ``valid`` per validation
    step) and finite losses of every step in record[first:last], and with
    ``kinds`` the steps' kinds in that order; returns the train steps'
    times (s)."""
    ran = [r[0] for r in record[first:last]]
    if kinds is not None and ran != kinds:
        raise AssertionError(f"train: ran steps {ran}, expected {kinds}")
    train_s = []
    for kind, t0, t1, launches, loss in record[first:last]:
        expected = every_count(train if kind == "train" else valid)
        if launches != expected:
            raise AssertionError(f"train: a {kind} step launched {launches}, "
                                 f"expected {expected}")
        if not np.isfinite(loss):
            raise AssertionError(f"train: a {kind} step's loss is {loss}")
        if kind == "train":
            train_s.append(t1 - t0)
    return train_s


def _resume_check(pipeline, saved):
    """Make ``pipeline.load_ckpt`` check, right after loading, that the net
    and the Adam state equal ``saved`` (the first run's at its end); the
    epoch it returns goes into ``saved["first_epoch"]``."""
    load = pipeline.load_ckpt

    def checked(*args, **kwargs):
        epoch = load(*args, **kwargs)
        for key, value in pipeline.net.state_dict().items():
            if not torch.equal(value, saved["model"][key]):
                raise AssertionError(f"resume: {key} differs from the saved "
                                     "weights")
        state = pipeline.optimizer.state_dict()["state"]
        if set(state) != set(saved["adam"]):
            raise AssertionError("resume: Adam state for other parameters")
        for idx, moments in saved["adam"].items():
            for name in ("step", "exp_avg", "exp_avg_sq"):
                # the step count lives on the CPU, the moments on the card
                if not torch.equal(state[idx][name].cpu(),
                                   moments[name].cpu()):
                    raise AssertionError(f"resume: Adam {name} of parameter "
                                         f"{idx} differs")
        saved["first_epoch"] = epoch
        return epoch

    pipeline.load_ckpt = checked


def _overfit(pipeline, dataset, batch_size=4):
    """10 training steps on one fixed batch of the train split; returns the
    losses."""
    model = pipeline.model
    split = dataset.get_split("train")
    loader = PointCloudDataloader(split, preprocess=model.preprocess,
                                  transform=model.transform,
                                  sampler=split.sampler, use_cache=True)
    model.trans_point_sampler = split.sampler.get_point_sampler()
    batch = next(iter(BatchLoader(loader, batch_size, DefaultBatcher(),
                                  num_workers=0, sampler=split.sampler)))
    inputs = pipeline._device_batch(batch)
    loss_fn = SemSegLoss(pipeline, model, dataset)
    return [float(pipeline._train_step(inputs, loss_fn)[0])
            for _ in range(10)]


def _rel_l2(a, b):
    a, b = a.double().cpu(), b.double().cpu()
    return ((a - b).norm() / b.norm()).item()


class _SameBranches:
    """Make two runs of the fused net take the same branches.

    The training step's gradient is not continuous in its inputs: each max
    pool hands its gradient to its largest neighbour, and each LeakyReLU
    passes it whole or times its slope. Where two neighbours nearly tie,
    or a LeakyReLU's input is nearly 0, float32 rounding alone picks the
    branch, and a branch taken otherwise moves the gradient of every layer
    before it: on some patches far more than the card's and the CPU's
    float32 sums differ (``--step-branches`` measures it).

    While it is entered, the RandLA net's pools (fused or on a given
    pyramid) gather the neighbour that ``argmax`` picks and its
    LeakyReLUs apply a sign mask (with ``net``
    "scu": SparseConvUnet's ReLUs, whose inputs near 0 after BatchNorm
    route the gradient the same way; with "pp": PointPillars' ReLUs, and
    its pillar max, whose near ties route the gradient to the points
    rounding makes the largest; with "kpconv": KPFCNN's LeakyReLUs and
    its max pools, ``models/kpconv.py`` ``leaky_relu`` and ``max_pool``,
    whose near ties would split or move the gradient; with "pt":
    PointTransformer's ReLUs, the fused grouping's maxima
    (``neighbour_max``) and the fused pyramid's integers (perm, seg_ids,
    rel: a near tie in a search moves a neighbour); with "prcnn":
    PointNet++'s ReLUs and neighbour maxima (``models/pointnet2.py``), its
    FPS, ball queries and 3-NN indices, and PointRCNN's proposal NMS,
    roi IoUs and roi membership, each only while autograd records, so
    that the frozen RPN of mode RCNN takes none; with "pvcnn": PVCNN's
    ReLUs and LeakyReLUs, the global feature's max over the points, whose
    ties split the gradient, and the voxel cells, where a coordinate
    within rounding of a .5 tie moves a point to another cell, counted
    apart in ``differ_cells``): the first run records its choices, the
    run after ``replay()`` takes them and counts in ``differ`` the
    choices its own values would have made otherwise. Like the fixed
    dropout mask, this gives both runs one function. With ``active`` false
    it changes nothing."""

    def __init__(self, active=True, net="randla"):
        self.active = active
        self.module = {"randla": trl, "scu": tscu, "pp": tpp,
                       "kpconv": tkp, "prcnn": tp2, "pvcnn": tpv,
                       "pt": tpt}[net]
        self.recorded, self.replaying, self.differ = [], False, 0
        self.total = 0  # choices recorded
        self.differ_cells = 0  # of ``differ``: PVCNN's voxel-cell indices

    def replay(self):
        self.total = sum(c.numel() for c in self.recorded)
        if self.active and not self.total:
            raise AssertionError("train: the step took no branch through "
                                 "_SameBranches")
        self.replaying = True

    def _choose(self, own, tol=None):
        """``own`` recorded, or the recorded choice in its place; with
        ``tol`` a value replayed, counted as differing beyond ``tol``."""
        if self.module is tp2 and not torch.is_grad_enabled():
            return own
        if not self.replaying:
            self.recorded.append(own)
            return own
        want = self.recorded.pop(0).to(own.device)
        self.differ += int((want != own).sum() if tol is None else
                           ((want - own).abs() > tol).sum())
        return want

    def __enter__(self):
        if not self.active:
            return self
        choose = self._choose

        def pool_max(level, v):
            rows = level._gather(v, "pool")
            pick = choose(rows.argmax(dim=-2, keepdim=True))
            return torch.gather(rows, -2, pick).squeeze(-2)

        def index_pool_max(level, v):
            rows = v[level.batch[..., None], level.pool_idx]
            pick = choose(rows.argmax(dim=-2, keepdim=True))
            return torch.gather(rows, -2, pick).squeeze(-2)

        class Functional:
            """``torch.nn.functional`` with a LeakyReLU and a ReLU of
            chosen signs."""

            def __getattr__(self, name):
                return getattr(torch.nn.functional, name)

            @staticmethod
            def leaky_relu(x, slope=0.01):
                return torch.where(choose(x > 0), x, x * slope)

            @staticmethod
            def relu(x):
                return torch.where(choose(x > 0), x, 0.0)

        own_segment_max = tpp.segment_max

        def segment_max(y, seg_ids, num_segments):
            """The own maxima, the gradient split over the recorded
            winners (each point's channels equal to its pillar's max)."""
            vmax = own_segment_max(y, seg_ids, num_segments)
            seg = seg_ids.long()[:, None].expand(-1, y.shape[1])
            rows = torch.cat([vmax, vmax.new_full((1, y.shape[1]), np.inf)])
            won = choose(y == rows.gather(0, seg))
            share = torch.zeros_like(rows).scatter_add_(0, seg, won.to(y))
            moved = torch.zeros_like(rows).scatter_add_(
                0, seg, torch.where(won, y - y.detach(), 0.0))
            return (vmax.detach() + moved[:num_segments] /
                    share[:num_segments].clamp(min=1))

        if self.module is tp2:
            self._saved = [(tp2, name, getattr(tp2, name)) for name in
                           ("F", "neighbour_max", "furthest_point_sampling",
                            "ball_query", "three_nn")]
            self._saved += [(tprc, name, getattr(tprc, name)) for name in
                            ("nms_bev", "iou_3d_elementwise",
                             "points_in_cam_box")]
            real = {(obj, name): fn for obj, name, fn in self._saved}

            def nmax(feats):
                pick = choose(feats.argmax(dim=2, keepdim=True))
                return torch.gather(feats, 2, pick).squeeze(2)

            def indices(obj, name, first=None):
                """The call's integer outputs chosen (the first
                ``first`` of a tuple)."""
                def call(*args, **kwargs):
                    out = real[(obj, name)](*args, **kwargs)
                    if not isinstance(out, tuple):
                        return choose(out)
                    return tuple(choose(t) if i in first else t
                                 for i, t in enumerate(out))
                return call

            tp2.F = Functional()
            tp2.neighbour_max = nmax
            tp2.furthest_point_sampling = indices(
                tp2, "furthest_point_sampling")
            tp2.ball_query = indices(tp2, "ball_query", (0, 1))
            tp2.three_nn = indices(tp2, "three_nn", (1,))
            tprc.nms_bev = indices(tprc, "nms_bev")
            tprc.points_in_cam_box = indices(tprc, "points_in_cam_box")
            tprc.iou_3d_elementwise = lambda *a: choose(
                real[(tprc, "iou_3d_elementwise")](*a), tol=1e-6)
            return self
        if self.module is tpv:
            def cloud_max(feat):
                pick = choose(feat.argmax(dim=1, keepdim=True))
                return torch.gather(feat, 1, pick).squeeze(1)

            cells = tpv.voxel_cells
            self._saved = [(tpv, name, getattr(tpv, name)) for name in
                           ("F", "cloud_max", "voxel_cells")]
            tpv.F = Functional()
            tpv.cloud_max = cloud_max
            def voxel_cells(norm):
                before = self.differ
                out = choose(cells(norm))
                self.differ_cells += self.differ - before
                return out

            tpv.voxel_cells = voxel_cells
            return self
        if self.module is tpt:
            pyramid = tpt.build_pt_pyramid

            def pt_pyramid(*args, **kwargs):
                """The pyramid with its integers chosen (perm, seg_ids,
                rel), the float coordinates its own."""
                def pick(t):
                    return (choose(t) if torch.is_tensor(t) and
                            not t.is_floating_point() else t)
                return {k: [pick(t) for t in v] if isinstance(v, list)
                        else pick(v)
                        for k, v in pyramid(*args, **kwargs).items()}

            def pt_max(x):
                pick = choose(x.argmax(dim=-2, keepdim=True))
                return torch.gather(x, -2, pick).squeeze(-2)

            self._saved = [(tpt, name, getattr(tpt, name)) for name in
                           ("F", "neighbour_max", "build_pt_pyramid")]
            tpt.F = Functional()
            tpt.neighbour_max = pt_max
            tpt.build_pt_pyramid = pt_pyramid
            return self
        if self.module is tkp:
            def kp_max_pool(x, inds):
                rows = tkp.gather_rows(tkp._with_zero_row(x), inds)
                pick = choose(rows.argmax(dim=2, keepdim=True))
                return torch.gather(rows, 2, pick).squeeze(2)

            def kp_leaky_relu(x, slope):
                return torch.where(choose(x >= 0), x, x * slope)

            self._saved = [(tkp, "max_pool", tkp.max_pool),
                           (tkp, "leaky_relu", tkp.leaky_relu)]
            tkp.max_pool, tkp.leaky_relu = kp_max_pool, kp_leaky_relu
            return self
        self._saved = [(self.module, "F", self.module.F),
                       (trl._BucketLevel, "pool_max",
                        trl._BucketLevel.pool_max),
                       (trl._IndexLevel, "pool_max",
                        trl._IndexLevel.pool_max),
                       (tpp, "segment_max", own_segment_max)]
        self.module.F = Functional()
        if self.module is trl:
            trl._BucketLevel.pool_max = pool_max
            trl._IndexLevel.pool_max = index_pool_max
        if self.module is tpp:
            tpp.segment_max = segment_max
        return self

    def __exit__(self, *exc):
        if self.active:
            for obj, name, value in self._saved:
                setattr(obj, name, value)


def _step_model_and_batch(dataset, n=11_264, seed=SEED):
    """The float32 model of the card-vs-CPU step and its one patch of ``n``
    points from the first training cloud. The model is seeded, so the
    patch (its crop and augmentation) is the same in every run."""
    model = MODEL.get("RandLANet")(compute_dtype="float32", num_points=n,
                                   seed=seed)
    split = dataset.get_split("train")
    loader = PointCloudDataloader(split, preprocess=model.preprocess,
                                  transform=model.transform,
                                  sampler=split.sampler, use_cache=True)
    model.trans_point_sampler = split.sampler.get_point_sampler()
    return model, DefaultBatcher().collate_fn([loader[0]])


def _step_vs_cpu(dataset, root, seed=SEED, same_branches=True):
    """One float32 training step, 1 x 11,264 points, full widths, the
    training budget, on the card and on the CPU from the same weights,
    batch (that of model seed ``seed``), dropout mask and, with
    ``same_branches``, branches (``_SameBranches``: the CPU takes the
    card's). Returns (loss relative difference, gradient relative L2,
    running statistics relative L2, parameter relative L2 after the Adam
    step, CPU step seconds, the ``_SameBranches`` used)."""
    n = 11_264
    out = {}
    model, batch = _step_model_and_batch(dataset, n, seed)
    keep = torch.rand((1, n, 32),
                      generator=torch.Generator().manual_seed(SEED)) >= 0.5
    state = None
    with _SameBranches(same_branches) as branches:
        for device in (DEVICE, "cpu"):
            pipeline = SemanticSegmentation(model, dataset=dataset,
                                            device=device, seed=SEED,
                                            main_log_dir=str(root),
                                            **TRAIN_PIPELINE)
            if state is None:
                state = {k: v.cpu().clone()
                         for k, v in pipeline.net.state_dict().items()}
            pipeline.net.load_state_dict(state)
            pipeline.net.dropout = _FixedDropout(keep)
            pipeline.optimizer, pipeline.scheduler = model.get_optimizer(
                pipeline.cfg, pipeline.net)
            t0 = time.perf_counter()
            loss, _ = pipeline._train_step(
                pipeline._device_batch(batch),
                SemSegLoss(pipeline, model, dataset))
            seconds = time.perf_counter() - t0
            net = pipeline.net
            out[device] = {
                "loss": loss.double().cpu(),
                "grad": torch.cat([p.grad.reshape(-1).cpu()
                                   for p in net.parameters()]),
                "stats": torch.cat([b.reshape(-1).cpu()
                                    for k, b in net.state_dict().items()
                                    if k.endswith(("running_mean",
                                                   "running_var"))]),
                "params": torch.cat([p.detach().reshape(-1).cpu()
                                     for p in net.parameters()]),
                "seconds": seconds}
            if device == DEVICE:
                branches.replay()
        if branches.recorded:
            raise AssertionError("train: the CPU step took fewer branches "
                                 "than the card's")
    gpu, cpu = out[DEVICE], out["cpu"]
    return ((abs(gpu["loss"] - cpu["loss"]) / abs(cpu["loss"])).item(),
            _rel_l2(gpu["grad"], cpu["grad"]),
            _rel_l2(gpu["stats"], cpu["stats"]),
            _rel_l2(gpu["params"], cpu["params"]), cpu["seconds"], branches)


def phase_train(card):
    """run_train at the shipped config on synthetic scenes, a resume from
    its checkpoint, an overfit batch and one step against the CPU; returns
    the first run's launch counts."""
    model = MODEL.get("RandLANet")(seed=SEED)
    b, n = TRAIN_PIPELINE["batch_size"], model.cfg.num_points
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        dataset = _train_dataset(root)
        pipeline = SemanticSegmentation(model, dataset=dataset, device=DEVICE,
                                        seed=SEED, max_epoch=0,
                                        main_log_dir=str(root / "logs"),
                                        **TRAIN_PIPELINE)
        record = []
        _instrument(pipeline, record)
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        pipeline.run_train()
        wall = time.perf_counter() - t0
        launches = read_counts()
        peak = torch.cuda.max_memory_allocated()
        steps = _check_steps(record, 0, len(record))
        kinds = [r[0] for r in record]
        if kinds != ["train"] * 6 + ["eval"] * 2:
            raise AssertionError(f"train: ran steps {kinds}, expected 6 "
                                 "train and 2 eval")
        step = statistics.median(steps[1:])
        loop = record[-1][2] - record[0][1]
        busy = sum(t1 - t0 for _, t0, t1, _, _ in record)
        say("train", f"run_train max_epoch=0: 6 train steps of {b} x {n} "
            f"points and 2 validation steps of 2, each with the expected "
            f"launches ({TRAIN_STEP_LAUNCHES} per train step, "
            f"{EXPECTED_LAUNCHES} per validation step); losses "
            f"{[round(r[4], 4) for r in record]}, finite")
        say("train", f"step B={b} N={n} bf16, S{model.cfg.num_segs}/"
            f"G{model.cfg.gather_segs}: median {step * 1e3:.2f} ms over steps "
            f"2..6 (min {min(steps[1:]) * 1e3:.2f}, max "
            f"{max(steps[1:]) * 1e3:.2f}, first {steps[0] * 1e3:.2f}), "
            f"{b * n / step:.0f} points trained/s on {card}")
        say("train", f"wall {wall:.3f} s, of it set-up (scenes, preprocess "
            f"cache, optimizer) {record[0][1] - t0:.3f} s and the step loop "
            f"{loop:.3f} s: steps (synchronised) {busy / loop:.1%}, host "
            f"between steps (loader wait, copies, metrics) "
            f"{1 - busy / loop:.1%}; peak device memory "
            f"{peak / 2**30:.2f} GiB on {card}")
        ckpt = Path(pipeline.cfg.logs_dir) / "checkpoint" / "ckpt_00000.pth"
        if not ckpt.exists():
            raise AssertionError(f"train: no checkpoint at {ckpt}")

        saved = {"model": {k: v.clone()
                           for k, v in pipeline.net.state_dict().items()},
                 "adam": {idx: {k: v.clone() for k, v in moments.items()}
                          for idx, moments in
                          pipeline.optimizer.state_dict()["state"].items()}}
        resumed = SemanticSegmentation(model, dataset=dataset, device=DEVICE,
                                       seed=SEED + 1, max_epoch=1,
                                       main_log_dir=str(root / "logs"),
                                       **TRAIN_PIPELINE)
        _resume_check(resumed, saved)
        record2 = []
        _instrument(resumed, record2)
        resumed.run_train()
        _check_steps(record2, 0, len(record2))
        if saved.get("first_epoch") != 1 or len(record2) != 8:
            raise AssertionError(f"resume: started at epoch "
                                 f"{saved.get('first_epoch')} with "
                                 f"{len(record2)} steps")
        say("train", f"{ckpt.name} written; a fresh pipeline resumed from it "
            "at epoch 1 with equal weights, BN statistics and Adam state "
            f"(step, moments), and ran 6 + 2 steps with finite losses "
            f"{[round(r[4], 4) for r in record2]}")

        losses = _overfit(resumed, dataset)
        if not losses[-1] < losses[0]:
            raise AssertionError(f"overfit: loss did not fall: {losses}")
        say("train", f"10 steps on one batch: loss {losses[0]:.4f} -> "
            f"{losses[-1]:.4f} ({[round(x, 4) for x in losses]})")

        (loss_rel, grad_rel, stats_rel, param_rel, cpu_s,
         branches) = _step_vs_cpu(dataset, root / "cpu")
        say("train", f"one float32 step B=1 N=11264, card vs CPU on the "
            f"card's branches ({branches.differ} of {branches.total} "
            f"max-pool and LeakyReLU choices the CPU would have made "
            f"otherwise): loss "
            f"relative difference {loss_rel:.3e} (bound 1e-5), gradient "
            f"relative L2 {grad_rel:.3e} (bound 1e-4), running statistics "
            f"relative L2 {stats_rel:.3e} (bound 1e-4); parameters after "
            f"Adam relative L2 {param_rel:.3e} (no bound: Adam's first "
            f"step moves each weight by about lr times the sign of its "
            f"gradient); CPU step {cpu_s:.1f} s")
        if not (loss_rel <= 1e-5 and grad_rel <= 1e-4 and stats_rel <= 1e-4):
            raise AssertionError("train: card and CPU steps disagree")
    return launches


def phase_eval(model, card):
    """The eval net at the shipped config, one patch, float32; returns its
    state_dict (the seeded random weights)."""
    dev = torch.device(DEVICE)
    model_cfg = model.cfg
    net = model.get_eval_net()
    state = random_weights(net, SEED).state_dict()
    net = net.eval().to(dev)
    rng = np.random.default_rng(0)
    n = model_cfg.num_points
    batch_cpu = {key: torch.from_numpy(
        rng.uniform(-25, 25, (1, n, 3)).astype(np.float32))
        for key in ("coords", "features")}
    batch = {k: v.to(dev) for k, v in batch_cpu.items()}
    with torch.no_grad():
        net(batch)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        logits = net(batch)
        torch.cuda.synchronize()
        launches = read_counts()
    check_counts("eval", launches, dict(
        EXPECTED_LAUNCHES, bucket_knn=0, bucket_gather=0,
        knn_exact=model_cfg.num_layers))
    if tuple(logits.shape) != (1, n, model_cfg.num_classes):
        raise AssertionError(f"eval logits shape {tuple(logits.shape)}")
    if not torch.isfinite(logits).all():
        raise AssertionError("non-finite eval logits")
    say("eval", f"knn_method={net.knn_method}, compute_dtype "
        f"{model_cfg.compute_dtype} in the config, MLPs float32; logits "
        f"{tuple(logits.shape)} finite; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    cpu_net = model.get_eval_net()
    cpu_net.load_state_dict(state)
    with torch.no_grad():
        t0 = time.perf_counter()
        ref = cpu_net.eval()(batch_cpu)[0]
        cpu_s = time.perf_counter() - t0
    rel_l2, agree = _compare(logits[0], ref)
    say("eval", f"sample 0: card vs CPU relative L2 {rel_l2:.3e}, argmax "
        f"agreement {agree:.6f} (CPU forward {cpu_s:.1f} s)")
    if not rel_l2 <= 1e-4:
        raise AssertionError(f"eval relative L2 {rel_l2} > 1e-4")

    fwd, times = median_forward_s(net, batch)
    say("eval", f"forward B=1 N={n} float32: median {fwd * 1e3:.2f} ms over "
        f"{len(times)} runs (min {min(times) * 1e3:.2f}, max "
        f"{max(times) * 1e3:.2f}), {n / fwd:.0f} points/s on {card}")
    split = _eval_split(net, batch, model_cfg.num_layers)
    say("eval", "one forward on the card's stream, median of 5, ms: "
        f"{split['forward']:.4f} in all; the {model_cfg.num_layers} knn_exact "
        f"launches {split['knn_exact']:.4f} "
        f"({split['knn_exact'] / split['forward']:.1%}), the "
        f"{model_cfg.num_layers} k = 1 _nearest searches "
        f"{split['nearest']:.4f} ({split['nearest'] / split['forward']:.1%}),"
        f" everything else {split['other']:.4f} "
        f"({split['other'] / split['forward']:.1%})")
    return state


def _eval_split(net, batch, layers, runs=5):
    """One eval forward's time on the card's stream, split three ways: the
    ``knn_exact`` launches, the k = 1 ``_nearest`` searches (plain torch
    over [B, chunk, N] distance blocks) and everything else; CUDA events
    around each call and around the forward (an idle gap of the stream
    between them counts where it falls). Median of ``runs`` forwards."""
    spans = {"knn_exact": [], "nearest": []}

    def timed(key, fn):
        def wrapper(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            spans[key].append((start, end))
            return out
        return wrapper

    real = {"knn_exact": tn.knn_exact, "_nearest": tn._nearest}
    tn.knn_exact = timed("knn_exact", real["knn_exact"])
    tn._nearest = timed("nearest", real["_nearest"])
    parts = collections.defaultdict(list)
    try:
        with torch.no_grad():
            for _ in range(runs):
                for key in spans:
                    spans[key].clear()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                net(batch)
                end.record()
                end.synchronize()
                if any(len(v) != layers for v in spans.values()):
                    raise AssertionError(f"eval split: calls {spans}")
                parts["forward"].append(start.elapsed_time(end))
                for key, pairs in spans.items():
                    parts[key].append(sum(a.elapsed_time(b)
                                          for a, b in pairs))
                parts["other"].append(parts["forward"][-1] -
                                      parts["knn_exact"][-1] -
                                      parts["nearest"][-1])
    finally:
        tn.knn_exact, tn._nearest = real["knn_exact"], real["_nearest"]
    return {key: statistics.median(v) for key, v in parts.items()}


def lidar_scan(n, seed):
    """[n, 3] points of a synthetic lidar sweep: radius uniform in 2-50 m,
    so the density falls as 1/r, and height in -2-1 m."""
    rng = np.random.default_rng(seed)
    r = rng.uniform(2, 50, n)
    th = rng.uniform(0, 2 * np.pi, n)
    return np.stack([r * np.cos(th), r * np.sin(th),
                     rng.uniform(-2, 1, n)], 1).astype(np.float32)


def _timed(fn, spent, key, sync=False):
    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        if sync:
            torch.cuda.synchronize()
        spent[key] += time.perf_counter() - t0
        spent[key + " calls"] += 1
        return out
    return wrapper


def phase_inference(model, state, card):
    """run_inference on one synthetic scan with the eval slice's weights;
    returns the launch counts of the run."""
    model_cfg = model.cfg
    points = lidar_scan(SCAN_POINTS, SEED)
    pipeline = SemanticSegmentation(model, device=DEVICE, seed=SEED)
    # run_inference copies the training net's weights into the eval net
    pipeline.net.load_state_dict(state)
    spent = collections.Counter()
    for name in ("preprocess", "transform", "update_probs"):
        setattr(model, name, _timed(getattr(model, name), spent, name))
    pipeline.eval_net.forward = _timed(pipeline.eval_net.forward, spent,
                                       "forward", sync=True)
    try:
        reset_counts()
        t0 = time.perf_counter()
        result = pipeline.run_inference(
            {"point": points, "feat": None, "label": None})
        wall = time.perf_counter() - t0
        launches = read_counts()
    finally:
        for name in ("preprocess", "transform", "update_probs"):
            delattr(model, name)
    patches = spent["transform calls"]
    forwards = spent["forward calls"]
    check_counts("inference", launches, dict(
        EXPECTED_LAUNCHES, bucket_knn=0, bucket_gather=0,
        knn_exact=model_cfg.num_layers * forwards))
    labels, scores = result["predict_labels"], result["predict_scores"]
    if labels.shape != (SCAN_POINTS,) or scores.shape != (
            SCAN_POINTS, model_cfg.num_classes):
        raise AssertionError(f"predict_labels {labels.shape}, predict_scores "
                             f"{scores.shape}")
    if not np.isfinite(scores).all():
        raise AssertionError("non-finite predict_scores")
    host = {name: spent[name] for name in
            ("preprocess", "transform", "update_probs")}
    other = wall - spent["forward"] - sum(host.values())
    parts = ", ".join(f"{name} {t:.3f} s ({t / wall:.1%}, "
                      f"{spent[name + ' calls']} calls)"
                      for name, t in host.items())
    say("inference", f"run_inference on a {SCAN_POINTS}-point scan: "
        f"{len(np.unique(labels))} classes over {labels.shape[0]} labels, "
        f"scores finite; {patches} patches in {forwards} forwards "
        f"(test_batch_size {pipeline.cfg.test_batch_size})")
    say("inference", f"wall {wall:.3f} s: forward {spent['forward']:.3f} s "
        f"({spent['forward'] / wall:.1%}, synchronised); host: {parts}; "
        f"other {other:.3f} s ({other / wall:.1%}); "
        f"{SCAN_POINTS / wall:.0f} points labelled/s on {card}")
    return launches


def scu_scene(extent_m, n, seed=SEED):
    """A room for SparseConvUnet: ``make_semseg_scene(n, seed)`` (points and
    labels) rebased to 0 and scaled to ``extent_m`` metres along its
    longest axis, RGB uniform in 0-255."""
    pts, labels = make_semseg_scene(n, seed=seed)
    pts = pts.astype(np.float64)
    pts -= pts.min(0)
    pts *= extent_m / pts.max()
    rgb = np.random.default_rng(seed).uniform(0, 255, (n, 3))
    return {"point": pts.astype(np.float32), "feat": rgb.astype(np.float32),
            "label": labels}


def _scu_inputs(model, data):
    """preprocess (test split) -> transform -> DefaultBatcher: (the numpy
    batch, its network inputs on the card)."""
    attr = {"split": "test"}
    sample = model.transform(model.preprocess(data, attr), attr)
    batch = DefaultBatcher().collate_fn([sample])
    return batch, {key: torch.from_numpy(batch[key]).to(DEVICE)
                   for key in ("point", "feat", "point_mask")}


def _capture_stencil_calls(net, inputs):
    """The arguments of every stencil_conv call of one forward."""
    calls = []
    real = tscu.stencil_conv

    def capture(values, keys, qkeys, seg_ids, w, **kw):
        calls.append({"values": values, "keys": keys, "qkeys": qkeys,
                      "seg_ids": seg_ids, "w": w, **kw})
        return real(values, keys, qkeys, seg_ids, w, **kw)

    tscu.stencil_conv = capture
    with torch.no_grad():
        net(inputs)
    tscu.stencil_conv = real
    return calls


def _keys_ascend(label, keys, seg):
    """The stencil kernels' precondition on one shape of the path: the keys
    of each batch row ascend, pad keys INT32_MAX at the end."""
    padded = cs._pad_keys(keys, seg)
    if not bool((padded[:, 1:] >= padded[:, :-1]).all()):
        raise AssertionError(f"stencil {label}: the keys of a batch row do "
                             "not ascend, the kernels' precondition")


def _stencil_check(label, call, gen):
    """stencil_conv against its plain version on one convolution of the
    path: the path's keys, tap keys and tables, new values and weights;
    beside it, how many of the taps whose site exists the tables find.
    Dyadic ones (values k/8 in [-4, 4], weights k/16 in [-2, 2]: every
    product and partial sum is a multiple of 1/128 below 2^17, exact in
    float32 and unchanged by bfloat16 rounding) must give the same bits
    at float32 and bfloat16. On normal ones each output must lie within
    n * 2^-24 * sum |x w| (n = K * Cin terms) of a float64 reference of the
    same (rounded) inputs: float32 summation in any order. Returns its
    record at bfloat16 (error: max |kernel - plain| on normal inputs).
    Bound: values, keys, tap keys, tables and weights read, the output
    written; 2 * Cin * Cout bf16 operations per tap that finds a row."""
    values, w = call["values"], call["w"]
    keys, qkeys, seg_ids = call["keys"], call["qkeys"], call["seg_ids"]
    k, cin, cout = w.shape
    tabs = dict(seg=call["seg"], qblock=call["qblock"])
    dev = values.device
    _keys_ascend(label, keys, tabs["seg"])

    def both(v, ww, dtype):
        return (cs.stencil_conv(v, keys, qkeys, seg_ids, ww, **tabs,
                                compute_dtype=dtype),
                cs.stencil_conv_plain(v, keys, qkeys, seg_ids, ww, **tabs,
                                      compute_dtype=dtype))

    dy_v = torch.randint(-32, 33, values.shape, generator=gen,
                         device=dev).float() / 8
    dy_w = torch.randint(-32, 33, w.shape, generator=gen,
                         device=dev).float() / 16
    nv = torch.randn(values.shape, generator=gen, device=dev)
    nw = torch.randn(w.shape, generator=gen, device=dev) / (k * cin) ** .5
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        got, ref = both(dy_v, dy_w, dtype)
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            raise AssertionError(f"stencil_conv {label} {dtype}: differs "
                                 "from the plain version on dyadic inputs")
        got, ref = both(nv, nw, dtype)
        ref64 = cs.stencil_conv_plain(nv.double(), keys, qkeys, seg_ids,
                                      nw.double(), **tabs,
                                      compute_dtype=dtype)
        abs64 = cs.stencil_conv_plain(nv.double().abs(), keys, qkeys,
                                      seg_ids, nw.double().abs(), **tabs,
                                      compute_dtype=dtype)
        limit = k * cin * 2.0 ** -24 * abs64
        for name, out in (("kernel", got), ("plain", ref)):
            if ((out.double() - ref64).abs() > limit).any():
                raise AssertionError(f"stencil_conv {label} {dtype}: {name} "
                                     "past the float32 summation bound")
        errs[dtype] = ((got - ref).abs().max().item(),
                       (got.double() - ref64).abs().max().item())
    kw = dict(tabs, compute_dtype=torch.bfloat16)
    ms, plain_ms, span, plain_span = timings(
        lambda: cs.stencil_conv(nv, keys, qkeys, seg_ids, nw, **kw),
        lambda: cs.stencil_conv_plain(nv, keys, qkeys, seg_ids, nw, **kw))
    _, found = cs.stencil_rows(cs._pad_keys(keys, tabs["seg"]), qkeys,
                               seg_ids, **tabs)
    hits = int(found.sum())
    # taps whose site exists anywhere: what exact tables would find
    exist = sum(int(torch.isin(q, kb).sum()) for q, kb in zip(qkeys, keys))
    out_bytes = qkeys.shape[0] * qkeys.shape[1] * cout * 4
    bounds = bound(nbytes(values, keys, qkeys, seg_ids, w) + out_bytes,
                   2 * hits * cin * cout, "bfloat16")
    say("kernels", f"stencil_conv {label} B={values.shape[0]} "
        f"V={values.shape[1]} Q={qkeys.shape[1]} K={k} {cin}->{cout} "
        f"S={seg_ids.shape[-1]} seg={tabs['seg']} qblock={tabs['qblock']}, "
        f"{hits} of the {exist} taps whose site exists found in the block "
        f"tables: equal on dyadic inputs at float32 and bfloat16; "
        f"normal inputs within n * 2^-24 * sum|xw| of float64 (max |kernel - "
        f"float64| {errs[torch.float32][1]:.3e} float32, "
        f"{errs[torch.bfloat16][1]:.3e} bfloat16; max |kernel - plain| "
        f"{errs[torch.float32][0]:.3e}, {errs[torch.bfloat16][0]:.3e}); "
        f"bfloat16 device ms: kernel {ms:.4f}, plain {plain_ms:.4f}; call "
        f"span ms: kernel {span:.4f}, plain {plain_span:.4f}; bound "
        f"{max(bounds):.4f} ({bounds[0]:.4f} bytes, {bounds[1]:.4f} ops)")
    return kernel_record(errs[torch.bfloat16][0], ms, plain_ms, bounds)


def _match_check(label, call):
    """stencil_match against its plain version on one convolution's
    rulebook (the path's keys, tap keys and tables): rel and found equal
    bit for bit, misses' 0x7F000000 included. Returns its record (error 0
    when equal). Bound: the keys, tap keys and tables read, rel (int32)
    and found (one byte) written; no arithmetic to speak of. Library call:
    one batched ``torch.searchsorted`` of each block's tap keys into its
    table's keys, sorted ahead."""
    seg, qblock = call["seg"], call["qblock"]
    keys = cs._pad_keys(call["keys"], seg)
    qkeys, seg_ids = call["qkeys"], call["seg_ids"]
    tabs = dict(seg=seg, qblock=qblock)
    rel, found = cs.stencil_match(keys, qkeys, seg_ids, **tabs)
    rel_p, found_p = cs.stencil_match_plain(keys, qkeys, seg_ids, **tabs)
    torch.cuda.synchronize()
    if not (torch.equal(rel, rel_p) and torch.equal(found, found_p)):
        raise AssertionError(f"stencil_match {label}: differs from the plain "
                             "version")
    b, q, k = qkeys.shape
    nqb, s = seg_ids.shape[1:]
    cand = (seg_ids.long()[..., None] * seg +
            torch.arange(seg, device=keys.device)).reshape(b, -1)
    tabk = torch.gather(keys, 1, cand).reshape(b, nqb, s * seg).sort(-1)[0]
    qk = torch.nn.functional.pad(qkeys, (0, 0, 0, nqb * qblock - q),
                                 value=-1).reshape(b, nqb, qblock * k)
    library_ms = device_ms(lambda: torch.searchsorted(tabk, qk))
    ms, plain_ms, span, plain_span = timings(
        lambda: cs.stencil_match(keys, qkeys, seg_ids, **tabs),
        lambda: cs.stencil_match_plain(keys, qkeys, seg_ids, **tabs))
    bounds = bound(nbytes(keys, qkeys, seg_ids, rel, found), 0)
    say("kernels", f"stencil_match {label} B={b} Vp={keys.shape[1]} Q={q} "
        f"K={k} S={s} seg={seg} qblock={qblock}: rel and found equal "
        f"({int(found.sum())} found, {int((~found).sum())} misses); device "
        f"ms: kernel {ms:.4f}, plain {plain_ms:.4f}, torch.searchsorted "
        f"{library_ms:.4f}; call span ms: kernel {span:.4f}, plain "
        f"{plain_span:.4f}; bound {max(bounds):.4f} (bytes)")
    return kernel_record(0.0, ms, plain_ms, bounds, library_ms)


class _PlainStencilBackward:
    """While entered, ``stencil_conv_bwd`` runs on the plain versions of
    the rulebook, the gather and the scatter instead of their kernels."""

    names = ("stencil_match", "gather_bucket", "gather_bucket_bwd")

    def __enter__(self):
        self._saved = [getattr(cs, name) for name in self.names]
        for name, plain in zip(self.names, (cs.stencil_match_plain,
                                            cb.gather_bucket_plain,
                                            cb.gather_bucket_bwd_plain)):
            setattr(cs, name, plain)

    def __exit__(self, *exc):
        for name, fn in zip(self.names, self._saved):
            setattr(cs, name, fn)


def _stencil_bwd_check(label, call, gen):
    """The stencil convolution's backward (``stencil_conv_bwd``) on the
    kernels against the same backward on the plain versions, at one
    convolution of the path. On dyadic inputs (values k/8 in [-4, 4],
    weights k/16 in [-1, 1], cotangents k/64 in [-1, 1]) every dG entry and
    every value row's sum of them is exact in float32 in any order, so
    dvalues must be bit-equal, at float32 and bf16 (where dG is rounded
    once, the same on both sides). dw is the same product of G rows that
    must be bit-equal, so it must be bit-equal too; and, a sum over B * Q
    rows, it must lie within n * 2^-24 * sum |G g| (n = B * Q) of a float64
    reference, and at bf16 within that plus its one rounding (2^-8 of it).
    Returns the device ms of the kernels' and the plain versions' backward
    at bf16."""
    values, w = call["values"], call["w"]
    keys, qkeys, seg_ids = call["keys"], call["qkeys"], call["seg_ids"]
    tabs = dict(seg=call["seg"], qblock=call["qblock"])
    dev = values.device
    b, q = qkeys.shape[:2]
    dy_v = torch.randint(-32, 33, values.shape, generator=gen,
                         device=dev).float() / 8
    dy_w = torch.randint(-16, 17, w.shape, generator=gen,
                         device=dev).float() / 16
    dy_g = torch.randint(-64, 65, (b, q, w.shape[2]), generator=gen,
                         device=dev).float() / 64

    def bwd(g, v, ww, dtype):
        return cs.stencil_conv_bwd(g, v, keys, qkeys, seg_ids, ww, **tabs,
                                   compute_dtype=dtype)

    with _PlainStencilBackward():
        ref64 = bwd(dy_g.double(), dy_v.double(), dy_w.double(),
                    torch.float32)[1]
        abs64 = bwd(dy_g.double().abs(), dy_v.double().abs(),
                    dy_w.double().abs(), torch.float32)[1]
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        got = bwd(dy_g, dy_v, dy_w, dtype)
        with _PlainStencilBackward():
            ref = bwd(dy_g, dy_v, dy_w, dtype)
        torch.cuda.synchronize()
        for i, name in enumerate(("dvalues", "dw")):
            if not torch.equal(got[i], ref[i]):
                raise AssertionError(f"stencil_conv backward {label} {dtype}:"
                                     f" {name} differ from the plain "
                                     "backward's on dyadic inputs")
        limit = b * q * 2.0 ** -24 * abs64
        if dtype == torch.bfloat16:
            limit = limit + 2.0 ** -8 * ref64.abs()
        for name, dw in (("kernels", got[1]), ("plain", ref[1])):
            err = (dw.double() - ref64).abs()
            if (err > limit).any():
                raise AssertionError(f"stencil_conv backward {label} {dtype}:"
                                     f" dw of the {name} past its bound")
        errs[dtype] = (got[1].double() - ref64).abs().max().item()
    ms = device_ms(lambda: bwd(dy_g, dy_v, dy_w, torch.bfloat16), iters=5)
    with _PlainStencilBackward():
        plain_ms = device_ms(lambda: bwd(dy_g, dy_v, dy_w, torch.bfloat16),
                             iters=5)
    say("kernels", f"stencil_conv backward {label} B={b} Q={q}: dvalues "
        f"and dw equal to the plain backward's on dyadic inputs at float32 "
        f"and bfloat16; dw within its bound of float64 (max |err| "
        f"{errs[torch.float32]:.3e} "
        f"float32, {errs[torch.bfloat16]:.3e} bfloat16); bfloat16 device "
        f"ms: kernels {ms:.4f}, plain versions {plain_ms:.4f} (both with "
        f"the two products)")
    return ms, plain_ms


def _scu_bucket_checks(label, call, gen):
    """bucket_gather and bucket_gather_bwd at one convolution, as its
    backward (``stencil_conv_bwd``) calls them: the path's tables, the
    rulebook from ``stencil_match`` with misses reading position 0, the
    values padded to a multiple of seg, the cotangents of misses 0.
    Returns their (label, record) pairs."""
    seg, qblock = call["seg"], call["qblock"]
    tabs = dict(seg=seg, qblock=qblock)
    rel, found = cs.stencil_match(cs._pad_keys(call["keys"], seg),
                                  call["qkeys"], call["seg_ids"], **tabs)
    rel = torch.where(found, rel, 0)
    values = call["values"]
    vals = torch.nn.functional.pad(values, (0, 0, 0, (-values.shape[1]) % seg))
    label = f"SCU {label}"
    return ((label, _gather_check(label, vals, call["seg_ids"], rel, seg,
                                  qblock)),
            (label, _gather_bwd_check(label, call["seg_ids"], rel,
                                      vals.shape[1], values.shape[2], seg,
                                      qblock, gen, mask=found)))


def _edge_sites(b, cap, box, seed):
    """[b, cap] distinct random sites in a box, uneven valid counts,
    Morton-sorted by ``sort_sites``: (coords, mask, key, inv_perm)."""
    rng = np.random.default_rng(seed)
    coords = np.zeros((b, cap, 3), np.int32)
    mask = np.zeros((b, cap), bool)
    for i in range(b):
        c = np.unique(rng.integers(0, box, (cap * 2, 3)), axis=0)
        rng.shuffle(c)
        n = min(len(c), cap - 7 + i)
        coords[i, :n] = c[:n]
        mask[i, :n] = True
    return tsb.sort_sites(torch.from_numpy(coords), torch.from_numpy(mask))


def _edge_rulebook(form, seg, qblock, s, b=2, cap=3000, box=24):
    """(keys, tap keys, tables) of one synthetic convolution of the given
    form, the tables ranked by ``rank_site_segments`` as the net ranks
    them."""
    coords, mask, mkey, _ = _edge_sites(b, cap, box, SEED)
    nv = mask.sum(1).to(torch.int32)
    sup = tsb.support_points(coords, mask, seg)
    child = torch.arange(8, dtype=torch.int32)
    pc, pm, pk, off, _ = tsb.bucket_downsample(coords, mask, mkey, cap // 2)
    npar = pm.sum(1).to(torch.int32)
    rank = dict(seg=seg, qblock=qblock, num_segs=s)
    if form == "sub":
        qkeys = tsb.stencil_query_keys(coords, mask,
                                       tsp.kernel_offsets(3, centered=True))
        sids, _ = tsb.rank_site_segments(sup, nv, coords.float(), nv,
                                         reach=1.74, **rank)
        return mkey, qkeys, sids
    if form == "down":
        qkeys = torch.where(pm[..., None], (pk[..., None] << 3) | child, -1)
        pq = torch.where(pm[..., None], (pc * 2).float(), 2e9)
        sids, _ = tsb.rank_site_segments(sup, nv, pq, npar, reach=1.74,
                                         **rank)
        return mkey, qkeys, sids
    qkeys = torch.where(mask[..., None] & (off[..., None] == child),
                        (mkey >> 3)[..., None], -1)
    fq = torch.where(mask[..., None], (coords >> 1).float(), 2e9)
    sids, _ = tsb.rank_site_segments(tsb.support_points(pc, pm, seg), npar,
                                     fq, nv, reach=0.1, **rank)
    return pk, qkeys, sids


def _stencil_edges(gen):
    """Both stencil kernels against their plain versions on the synthetic
    rulebooks of ``STENCIL_EDGE_CASES`` at B = 2: ``stencil_match`` with an
    all-pad segment in some tables and pad-key taps (INT32_MAX: the least
    position among the pads of several segments), ``stencil_conv`` at each
    of ``STENCIL_EDGE_WIDTHS``, float32 and bf16, on dyadic inputs (any
    summation order gives the same bits). Each must be bit-equal."""
    convs = 0
    for n, (form, seg, qblock, s) in enumerate(STENCIL_EDGE_CASES):
        keys, qkeys, sids = (t.to(DEVICE)
                             for t in _edge_rulebook(form, seg, qblock, s))
        if n % 2:  # repeated ids
            sids = sids.clone()
            sids[..., -1] = sids[..., 0]
            sids[..., 1] = sids[..., 0]
        label = f"{form} seg {seg} qblock {qblock} S {sids.shape[-1]}"
        tabs = dict(seg=seg, qblock=qblock)
        padded = torch.nn.functional.pad(cs._pad_keys(keys, seg), (0, seg),
                                         value=cs._I32MAX)
        mq = qkeys.clone()
        mq[:, ::5, 0] = cs._I32MAX
        ms = sids.clone()
        ms[:, 1::3, 0] = padded.shape[1] // seg - 1  # an all-pad segment
        got = cs.stencil_match(padded, mq, ms, **tabs)
        ref = cs.stencil_match_plain(padded, mq, ms, **tabs)
        torch.cuda.synchronize()
        if not all(torch.equal(g, r) for g, r in zip(got, ref)):
            raise AssertionError(f"stencil_match {label}: differs from the "
                                 "plain version")
        k = qkeys.shape[-1]
        for cin, cout in STENCIL_EDGE_WIDTHS:
            v = torch.randint(-32, 33, (*keys.shape, cin), generator=gen,
                              device=DEVICE).float() / 8
            w = torch.randint(-32, 33, (k, cin, cout), generator=gen,
                              device=DEVICE).float() / 16
            for dtype in (torch.float32, torch.bfloat16):
                got = cs.stencil_conv(v, keys, qkeys, sids, w, **tabs,
                                      compute_dtype=dtype)
                ref = cs.stencil_conv_plain(v, keys, qkeys, sids, w, **tabs,
                                            compute_dtype=dtype)
                torch.cuda.synchronize()
                if not torch.equal(got, ref):
                    raise AssertionError(f"stencil_conv {label} {cin}->"
                                         f"{cout} {dtype}: differs from the "
                                         "plain version on dyadic inputs")
                convs += 1
    say("kernels", f"stencil kernels on {len(STENCIL_EDGE_CASES)} synthetic "
        f"rulebooks (seg 16 and 64, qblock 32-128, S 3-40, repeated ids, "
        f"all-pad segments, pad-key taps): stencil_match and {convs} "
        f"convolutions ({', '.join(f'{i}->{o}' for i, o in STENCIL_EDGE_WIDTHS)}"
        f"; float32 and bfloat16) equal to their plain versions")


def _conv_table(net, calls):
    """Device ms of each stencil_conv call of one forward, run again on its
    captured arguments, by level, form (sub: 27 taps; down; up), K, Cin ->
    Cout and Q. Returns [(label, call, ms)] in call order."""
    rows = []
    for call in calls:
        k, cin, cout = call["w"].shape
        q = call["qkeys"].shape[1]
        form = ("sub" if k == 27 else
                "down" if call["qblock"] == net.qblock else "up")
        level = net.caps.index(q) - (form == "down")
        args = [call[key] for key in ("values", "keys", "qkeys", "seg_ids",
                                      "w")]
        kw = {key: call[key] for key in ("seg", "qblock", "compute_dtype")}
        ms = device_ms(lambda: cs.stencil_conv(*args, **kw))
        rows.append((f"level-{level} {form} K={k} {cin}->{cout} Q={q}", call,
                     ms))
    return rows


def _say_conv_table(table):
    for i, (label, _, ms) in enumerate(table):
        say("scu", f"stencil_conv {i:2d} {label}: {ms:.4f} device ms")
    say("scu", f"stencil_conv, the {len(table)} calls of one room forward "
        f"run one by one: {sum(ms for *_, ms in table):.4f} device ms")


def _slower_line(name, records, library):
    """One line naming the shapes where ``name`` is slower than its library
    call, or saying it is slower at none; records are (label, record)."""
    slow = [f"{label} ({r['ms']:.4f} vs {r['library_ms']:.4f})"
            for label, r in records if r["ms"] > r["library_ms"]]
    say("kernels", f"{name} slower than {library} at: {'; '.join(slow)}"
        if slow else f"{name} no slower than {library} at any of the "
        f"{len(records)} shapes")


def phase_stencil(net, inputs, other, wides):
    """The stencil kernel, the rulebook kernel and the convolution's
    backward at five convolutions of the room request's forward
    (``STENCIL_SHAPES``), and at its level-0 block with the ``other``
    request's beside it as a batch of 2 (the second row's offsets into
    keys, tables and values); the bucket gather and its backward as that
    backward calls them at the batch of 2, the level-0 post conv1 and the
    deepest block (``SCU_BUCKET_SHAPES``). Then every convolution of the
    forward timed by level and form; the kernel and the rulebook at the
    two heaviest and at those whose Cin or Cout is not a multiple of 4
    (the input convolution), where they are not among the five, and at
    the level-0 block with the tables of each of ``wides`` (the same net
    at num_segs 32 and 48, tables of 2,048 and 3,072 rows; past 32 slots
    the kernels order a table in shared memory, not in one warp), whose
    found taps stand beside S = 16's; then both kernels on synthetic
    rulebooks (``_stencil_edges``). Returns the records
    of ``stencil_conv`` and ``stencil_match`` over the five, and the
    (label, record) pairs of the gather and of its backward."""
    calls = _capture_stencil_calls(net, inputs)
    if len(calls) != SCU_FORWARD_LAUNCHES:
        raise AssertionError(f"{len(calls)} stencil_conv calls per forward")
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    pair = [_capture_stencil_calls(net, x)[1] for x in (inputs, other)]
    both = {key: (torch.cat([c[key] for c in pair]) if key in
                  ("values", "keys", "qkeys", "seg_ids") else pair[0][key])
            for key in pair[0]}
    label = "level-0 block, both requests"
    _stencil_check(label, both, gen)
    searched = [(label, _match_check(label, both))]
    _stencil_bwd_check(label, both, gen)
    buckets = [_scu_bucket_checks(label, both, gen)]
    records, matches, bwds = [], [], []
    five = []
    for label, k, cin, cout, qblock in STENCIL_SHAPES:
        call = next(c for c in calls
                    if tuple(c["w"].shape) == (k, cin, cout) and
                    c["qblock"] == qblock)
        five.append(call)
        records.append(_stencil_check(label, call, gen))
        matches.append(_match_check(label, call))
        searched.append((label, matches[-1]))
        bwds.append(_stencil_bwd_check(label, call, gen))
        if label in SCU_BUCKET_SHAPES:
            buckets.append(_scu_bucket_checks(label, call, gen))
    rec, match = combine(records), combine(matches)
    say("kernels", f"stencil_conv, five shapes at bfloat16: device ms: "
        f"kernel {rec['ms']:.4f}, plain {rec['plain_ms']:.4f}, bound "
        f"{rec['bound_ms']:.4f} in all")
    say("kernels", f"stencil_match, five shapes: device ms: kernel "
        f"{match['ms']:.4f}, plain {match['plain_ms']:.4f}, "
        f"torch.searchsorted {match['library_ms']:.4f}, bound "
        f"{match['bound_ms']:.4f} in all")
    say("kernels", f"stencil_conv backward, five shapes at bfloat16: device "
        f"ms: kernels {sum(m for m, _ in bwds):.4f}, plain versions "
        f"{sum(p for _, p in bwds):.4f} in all")

    table = _conv_table(net, calls)
    _say_conv_table(table)
    heavy = sorted(table, key=lambda row: -row[2])[:2]
    # widths not a multiple of 4 (the input convolution's Cin 3): the bf16
    # kernel's 4-byte copies
    narrow = [row for row in table
              if any(n % 4 for n in row[1]["w"].shape[1:])]
    checked = list(five)
    for tag, rows in (("heaviest", heavy), ("4-byte copies", narrow)):
        for label, call, _ in rows:
            if any(call is c for c in checked):
                continue
            checked.append(call)
            label = f"{tag} {label}"
            _stencil_check(label, call, gen)
            searched.append((label, _match_check(label, call)))
    for wide in wides:
        level0 = next(c for c in _capture_stencil_calls(wide, inputs)
                      if tuple(c["w"].shape) == tuple(five[0]["w"].shape))
        label = f"level-0 block, S={level0['seg_ids'].shape[-1]}"
        _stencil_check(label, level0, gen)
        searched.append((label, _match_check(label, level0)))
    _slower_line("stencil_match", searched, "torch.searchsorted")
    _stencil_edges(gen)
    return rec, match, [g for g, _ in buckets], [b for _, b in buckets]


def _stencil_share(net, inputs):
    """Device ms of the stencil_conv calls of one forward, and the wall ms
    of another, synchronised forward. Each call is timed by CUDA events
    with the card held asleep while the host queues it, so that the events
    hold the kernel and not the host's work before its launch (the forward
    is host-bound: without the sleep the card waits inside the span)."""
    real = tscu.stencil_conv
    cycles = 10**6  # about 0.5 ms, longer than the host's work per call
    for _ in range(4):
        events = []

        def timed(*args, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(cycles)
            start.record()
            out = real(*args, **kw)
            end.record()
            events.append((start, end, not start.query()))
            return out

        tscu.stencil_conv = timed
        try:
            with torch.no_grad():
                net(inputs)
        finally:
            tscu.stencil_conv = real
        torch.cuda.synchronize()
        if all(ahead for *_, ahead in events):
            break
        cycles *= 4
    else:
        raise AssertionError("the host could not queue the stencil calls "
                             "ahead of the card")
    device = sum(start.elapsed_time(end) for start, end, _ in events)
    t0 = time.perf_counter()
    with torch.no_grad():
        net(inputs)
    torch.cuda.synchronize()
    return device, (time.perf_counter() - t0) * 1e3


def _profile_forward(net, inputs, top=8):
    """One forward under ``torch.profiler``: the kernels' device time
    (kernel rows only), their launches, the profiled wall time, and the
    ``top`` kernels by device time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        net(inputs)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in rows) / 1e3
    rows.sort(key=lambda e: -e.self_device_time_total)
    head = "; ".join(f"{e.key[:48]} {e.self_device_time_total / 1e3:.2f} ms"
                     f" ({e.count})" for e in rows[:top])
    return device_ms, sum(e.count for e in rows), wall_ms, head


def _counts_line(counts):
    return (f"voxel_overflow_points {counts['voxel_overflow_points']}, "
            f"down_overflow_children "
            f"{[counts[f'l{i}_down_overflow_children'] for i in range(6)]}, "
            f"table_overflow_blocks {counts['table_overflow_blocks']}")


def phase_scu(card):
    """SparseConvUnet at the ScanNet config: two requests served through
    preprocess -> transform -> batch -> the stencil forward ->
    update_probs, the stencil kernel checks, the card against the CPU and
    the hash path, and the forward's time. Returns (launch counts of the
    two served forwards, the records of the stencil and rulebook kernels,
    the (label, record) pairs of the bucket gather and of its backward at
    SparseConvUnet's shapes)."""
    model = MODEL.get("SparseConvUnet")(seed=SEED)
    cfg = model.cfg
    n, classes = cfg.num_points, cfg.num_classes
    net = model.get_net()
    state = random_weights(net, SEED).state_dict()
    net = net.eval().to(DEVICE)
    scenes = {"room": scu_scene(SCU_ROOM_EXTENT_M, n),
              "bench": scu_scene(SCU_BENCH_EXTENT_M, n)}
    inputs = {}
    for name, data in scenes.items():
        inputs[name] = _scu_inputs(model, data)
        with torch.no_grad():
            net(inputs[name][1])  # warm-up
    wides = []
    for segs in SCU_WIDE_SEGS:
        wide = MODEL.get("SparseConvUnet")(seed=SEED,
                                           bucket_segs=segs).get_net()
        wide.load_state_dict(net.state_dict())
        wides.append(wide.eval().to(DEVICE))
    stencil, match, gathers, bwds = phase_stencil(
        net, inputs["room"][1], inputs["bench"][1], wides)

    torch.cuda.synchronize()
    reset_counts()
    served = {}
    for name, data in scenes.items():
        batch, x = _scu_inputs(model, data)
        with torch.no_grad():
            logits = net(x)
        counts = net.overflow_counts()
        probs = model.update_probs(batch, logits.cpu().numpy(),
                                   np.zeros((n, classes), np.float32))
        served[name] = (batch, x, logits, counts, probs)
    torch.cuda.synchronize()
    launches = read_counts()
    check_counts("scu", launches, dict(
        EXPECTED_LAUNCHES, bucket_knn=0, bucket_gather=0,
        stencil_conv=SCU_FORWARD_LAUNCHES * len(scenes)))

    for name, (batch, x, logits, counts, probs) in served.items():
        if tuple(logits.shape) != (1, n, classes):
            raise AssertionError(f"scu {name}: logits {tuple(logits.shape)}")
        if not (torch.isfinite(logits).all() and np.isfinite(probs).all()):
            raise AssertionError(f"scu {name}: non-finite output")
        rows = probs.sum(1)
        if not np.allclose(rows[batch["point_inds"][0]], 1.0, atol=1e-5):
            raise AssertionError(f"scu {name}: probabilities do not sum to 1")
        # occupied voxels before the cap
        voxels = int(voxelize(x["point"][0], (1.0,) * 3, (0.0,) * 3,
                              (1024.0,) * 3, n, 1).num_voxels)
        say("scu", f"{name} request ({int(batch['point_mask'].sum())} points,"
            f" {voxels} voxels, cap {cfg.max_voxels}): logits "
            f"{tuple(logits.shape)} finite, update_probs rows sum to 1; "
            f"counters: {_counts_line(counts)}")

        # the card against the CPU, float32 (gated) and the config's bf16
        for dtype in ("float32", cfg.compute_dtype):
            gpu = logits[0]
            if dtype == "float32":
                net32 = model.get_net(compute_dtype="float32")
                net32.load_state_dict(state)
                with torch.no_grad():
                    gpu = net32.eval().to(DEVICE)(x)[0]
                served[name] = served[name] + (gpu,)
            cpu_net = model.get_net(compute_dtype=dtype)
            cpu_net.load_state_dict(state)
            with torch.no_grad():
                t0 = time.perf_counter()
                ref = cpu_net.eval()({k: v.cpu() for k, v in x.items()})[0]
                cpu_s = time.perf_counter() - t0
            rel_l2, agree = _compare(gpu, ref)
            say("scu", f"{name}, compute_dtype={dtype}: card vs CPU relative "
                f"L2 {rel_l2:.3e}, argmax agreement {agree:.6f} (CPU forward "
                f"{cpu_s:.1f} s)")
            if dtype == "float32" and not rel_l2 <= 1e-4:
                raise AssertionError(f"scu {name}: float32 relative L2 "
                                     f"{rel_l2} > 1e-4")

    # bucket against the exact hash path on the card, float32, room scene
    batch, x, _, counts, _, gpu32 = served["room"]
    hash_net = model.get_eval_net()
    hash_net.load_state_dict(state)
    with torch.no_grad():
        hashed = hash_net.eval().to(DEVICE)(x)[0]
    rel_l2, agree = _compare(gpu32, hashed.cpu())
    exact = not (counts["voxel_overflow_points"] or
                 counts["table_overflow_blocks"] or
                 any(counts[f"l{i}_down_overflow_children"]
                     for i in range(6)))
    say("scu", f"room, float32 on the card: bucket vs hash relative L2 "
        f"{rel_l2:.3e}, argmax disagreement {1 - agree:.6f}; counters "
        f"{'all 0: gated at 1e-4' if exact else 'not all 0: not gated'} "
        f"({_counts_line(counts)})")
    if exact and not rel_l2 <= 1e-4:
        raise AssertionError(f"scu: bucket vs hash relative L2 {rel_l2}")

    for name in scenes:
        x = served[name][1]
        torch.cuda.reset_peak_memory_stats()
        fwd, times = median_forward_s(net, x)
        peak = torch.cuda.max_memory_allocated()
        st_ms, wall_ms = _stencil_share(net, x)
        say("scu", f"{name} forward B=1 N={n} {cfg.compute_dtype}: median "
            f"{fwd * 1e3:.2f} ms over {len(times)} runs (min "
            f"{min(times) * 1e3:.2f}, max {max(times) * 1e3:.2f}), "
            f"{n / fwd:.0f} points/s, peak device memory "
            f"{peak / 2**30:.2f} GiB; the {SCU_FORWARD_LAUNCHES} "
            f"stencil_conv calls of one forward {st_ms:.2f} ms device time, "
            f"{st_ms / wall_ms:.1%} of a {wall_ms:.2f} ms forward on {card}")
    device_ms, kernels, wall_ms, head = _profile_forward(net,
                                                         served["room"][1])
    say("scu", f"room forward under torch.profiler: {kernels} kernels, "
        f"{device_ms:.2f} ms device time in a {wall_ms:.2f} ms forward "
        f"(busy {device_ms / wall_ms:.1%}); by device time: {head}")
    return launches, stencil, match, gathers, bwds


def _scu_rooms(root, n):
    """``SCU_TRAIN_ROOMS`` synthetic rooms of ``n`` points, 6 m, RGB 0-255
    and ``make_semseg_scene``'s labels, as ``Custom3D`` files under
    ``root``: one epoch is 6 training and 2 validation steps of 8."""
    seed = SEED
    for split, count in SCU_TRAIN_ROOMS.items():
        (root / "rooms" / split).mkdir(parents=True)
        for i in range(count):
            seed += 1
            np.save(root / "rooms" / split / f"room_{i}.npy",
                    scu_scene(SCU_ROOM_EXTENT_M, n, seed))
    batch = SCU_TRAIN_PIPELINE["batch_size"]
    return DATASET.get("Custom3D")(
        dataset_path=str(root / "rooms"), cache_dir=str(root / "cache"),
        test_result_folder=str(root / "test"), seed=SEED,
        steps_per_epoch_train=6 * batch, steps_per_epoch_valid=2 * batch)


def _step_breakdown(pipeline, dataset):
    """One training step on a batch of the train split, timed on the card
    by CUDA events: its synchronised wall ms, and the device ms of the
    forward, of the backward (from the gradients' reset to the optimizer
    step), of the backward's stencil_match, gather and scatter calls
    (events around each) with their count, and of the Adam step."""
    model = pipeline.model
    split = dataset.get_split("train")
    loader = PointCloudDataloader(split, preprocess=model.preprocess,
                                  transform=model.transform,
                                  sampler=split.sampler)
    batch = next(iter(BatchLoader(loader, SCU_TRAIN_PIPELINE["batch_size"],
                                  DefaultBatcher(), num_workers=0,
                                  sampler=split.sampler)))
    inputs = pipeline._device_batch(batch)
    spans = collections.defaultdict(list)

    def timed(fn, key):
        def wrapper(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            spans[key].append((start, end))
            return out
        return wrapper

    marks = {}

    def mark(fn, name, after):
        def wrapper(*args, **kwargs):
            event = torch.cuda.Event(enable_timing=True)
            if not after:
                event.record()
            out = fn(*args, **kwargs)
            if after:
                event.record()
            marks[name] = event
            return out
        return wrapper

    saved = {name: getattr(cs, name) for name in _PlainStencilBackward.names}
    net, opt = pipeline.net, pipeline.optimizer
    for name, fn in saved.items():
        setattr(cs, name, timed(fn, "bwd kernels"))
    net.forward = timed(net.forward, "forward")
    opt.zero_grad = mark(opt.zero_grad, "backward start", after=True)
    opt.step = timed(mark(opt.step, "backward end", after=False), "adam")
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipeline._train_step(inputs, SemSegLoss(pipeline, model, dataset))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        for name, fn in saved.items():
            setattr(cs, name, fn)
        for obj, name in ((net, "forward"), (opt, "zero_grad"),
                          (opt, "step")):
            delattr(obj, name)
    ms = {key: sum(s.elapsed_time(e) for s, e in pairs)
          for key, pairs in spans.items()}
    ms["backward"] = marks["backward start"].elapsed_time(
        marks["backward end"])
    return wall * 1e3, ms, len(spans["bwd kernels"])


def _scu_step_vs_cpu(dataset, root):
    """One float32 training step of SparseConvUnet at the shipped widths,
    B = 1 on the room request (the test split's preprocess and transform:
    no augmentation), on the card and on the CPU from the same weights,
    the CPU on the card's ReLU branches (``_SameBranches``). Returns (loss
    relative difference, gradient relative L2, running statistics relative
    L2, CPU step seconds, the ``_SameBranches`` used)."""
    model = MODEL.get("SparseConvUnet")(compute_dtype="float32", seed=SEED)
    batch, _ = _scu_inputs(model, scu_scene(SCU_ROOM_EXTENT_M,
                                            model.cfg.num_points))
    out, state = [], None
    with _SameBranches(net="scu") as branches:
        for device in (DEVICE, "cpu"):  # the card first
            pipeline = SemanticSegmentation(model, dataset=dataset,
                                            device=device, seed=SEED,
                                            main_log_dir=str(root),
                                            **SCU_TRAIN_PIPELINE)
            if state is None:
                state = {k: v.cpu().clone()
                         for k, v in pipeline.net.state_dict().items()}
            pipeline.net.load_state_dict(state)
            pipeline.optimizer, pipeline.scheduler = model.get_optimizer(
                pipeline.cfg, pipeline.net)
            t0 = time.perf_counter()
            loss, _ = pipeline._train_step(
                {k: torch.from_numpy(v).to(device) for k, v in batch.items()
                 if isinstance(v, np.ndarray)},
                SemSegLoss(pipeline, model, dataset))
            seconds = time.perf_counter() - t0
            net = pipeline.net
            out.append({
                "loss": loss.double().cpu(),
                "grad": torch.cat([p.grad.reshape(-1).cpu()
                                   for p in net.parameters()]),
                "stats": torch.cat([b.reshape(-1).cpu()
                                    for k, b in net.state_dict().items()
                                    if k.endswith(("running_mean",
                                                   "running_var"))]),
                "seconds": seconds})
            if len(out) == 1:
                branches.replay()
        if branches.recorded:
            raise AssertionError("scu_train: the CPU step took fewer "
                                 "branches than the card's")
    gpu, cpu = out
    return ((abs(gpu["loss"] - cpu["loss"]) / abs(cpu["loss"])).item(),
            _rel_l2(gpu["grad"], cpu["grad"]),
            _rel_l2(gpu["stats"], cpu["stats"]), cpu["seconds"], branches)


def phase_scu_train(card):
    """run_train of SparseConvUnet at the shipped ScanNet config on
    synthetic rooms, a resume from its checkpoint, an overfit batch, the
    backward kernels' device time in one step and one float32 step against
    the CPU; returns the first run's launch counts."""
    model = MODEL.get("SparseConvUnet")(seed=SEED)
    b, n = SCU_TRAIN_PIPELINE["batch_size"], model.cfg.num_points
    valid = {"stencil_conv": SCU_FORWARD_LAUNCHES}
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        t0 = time.perf_counter()
        dataset = _scu_rooms(root, n)
        rooms_s = time.perf_counter() - t0
        pipeline = SemanticSegmentation(model, dataset=dataset, device=DEVICE,
                                        seed=SEED, max_epoch=0,
                                        main_log_dir=str(root / "logs"),
                                        **SCU_TRAIN_PIPELINE)
        record = []
        _instrument(pipeline, record)
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        pipeline.run_train()
        wall = time.perf_counter() - t0
        launches = read_counts()
        peak = torch.cuda.max_memory_allocated()
        steps = _check_steps(record, 0, len(record), SCU_TRAIN_STEP_LAUNCHES,
                             valid)
        kinds = [r[0] for r in record]
        if kinds != ["train"] * 6 + ["eval"] * 2:
            raise AssertionError(f"scu_train: ran steps {kinds}, expected 6 "
                                 "train and 2 eval")
        step = statistics.median(steps[1:])
        loop = record[-1][2] - record[0][1]
        busy = sum(t1 - t0 for _, t0, t1, _, _ in record)
        say("scu_train", f"run_train max_epoch=0 on "
            f"{SCU_TRAIN_ROOMS['train']} + {SCU_TRAIN_ROOMS['val']} "
            f"Custom3D rooms of "
            f"{SCU_ROOM_EXTENT_M:g} m (written in {rooms_s:.2f} s): 6 train "
            f"steps of {b} x {n} points with the ScanNet augmentations and "
            f"2 validation steps, each with the expected launches "
            f"({SCU_TRAIN_STEP_LAUNCHES} per train step, {valid} per "
            f"validation step); losses {[round(r[4], 4) for r in record]}, "
            "finite")
        say("scu_train", f"step B={b} N={n} {model.cfg.compute_dtype}: median "
            f"{step * 1e3:.2f} ms over steps 2..6 (min "
            f"{min(steps[1:]) * 1e3:.2f}, max {max(steps[1:]) * 1e3:.2f}, "
            f"first {steps[0] * 1e3:.2f}), {b * n / step:.0f} points "
            f"trained/s on {card}")
        say("scu_train", f"wall {wall:.3f} s, of it set-up (splits, "
            f"optimizer) {record[0][1] - t0:.3f} s and the step loop "
            f"{loop:.3f} s: steps (synchronised) {busy / loop:.1%}, host "
            f"between steps (loader wait, copies, metrics) "
            f"{1 - busy / loop:.1%}; peak device memory "
            f"{peak / 2**30:.2f} GiB on {card}")
        ckpt = Path(pipeline.cfg.logs_dir) / "checkpoint" / "ckpt_00000.pth"
        if not ckpt.exists():
            raise AssertionError(f"scu_train: no checkpoint at {ckpt}")

        saved = {"model": {k: v.clone()
                           for k, v in pipeline.net.state_dict().items()},
                 "adam": {idx: {k: v.clone() for k, v in moments.items()}
                          for idx, moments in
                          pipeline.optimizer.state_dict()["state"].items()}}
        resumed = SemanticSegmentation(model, dataset=dataset, device=DEVICE,
                                       seed=SEED + 1, max_epoch=1,
                                       main_log_dir=str(root / "logs"),
                                       **SCU_TRAIN_PIPELINE)
        _resume_check(resumed, saved)
        record2 = []
        _instrument(resumed, record2)
        resumed.run_train()
        _check_steps(record2, 0, len(record2), SCU_TRAIN_STEP_LAUNCHES,
                     valid)
        if saved.get("first_epoch") != 1 or len(record2) != 8:
            raise AssertionError(f"scu_train resume: started at epoch "
                                 f"{saved.get('first_epoch')} with "
                                 f"{len(record2)} steps")
        say("scu_train", f"{ckpt.name} written; a fresh pipeline resumed "
            "from it at epoch 1 with equal weights, BN statistics and Adam "
            f"state (step, moments), and ran 6 + 2 steps with finite losses "
            f"{[round(r[4], 4) for r in record2]}")

        losses = _overfit(resumed, dataset, b)
        if not losses[-1] < losses[0]:
            raise AssertionError(f"scu_train overfit: loss did not fall: "
                                 f"{losses}")
        say("scu_train", f"10 steps on one batch: loss {losses[0]:.4f} -> "
            f"{losses[-1]:.4f} ({[round(x, 4) for x in losses]})")

        step_ms, ms, calls = _step_breakdown(resumed, dataset)
        say("scu_train", f"one train step {step_ms:.2f} ms (synchronised), "
            f"by CUDA events: forward {ms['forward']:.2f} ms, backward "
            f"{ms['backward']:.2f} ms, of it its {calls} stencil_match, "
            f"bucket_gather and bucket_gather_bwd calls "
            f"{ms['bwd kernels']:.2f} ms ({ms['bwd kernels'] / step_ms:.1%} "
            f"of the step), Adam {ms['adam']:.2f} ms, the rest (loss, "
            f"confusion matrix, host) "
            f"{step_ms - ms['forward'] - ms['backward'] - ms['adam']:.2f} "
            f"ms on {card}")

        loss_rel, grad_rel, stats_rel, cpu_s, branches = _scu_step_vs_cpu(
            dataset, root / "cpu")
        say("scu_train", f"one float32 step B=1 N={n} on the room request, "
            f"card vs CPU on the card's ReLU branches ({branches.differ} of "
            f"{branches.total} choices the CPU would have made otherwise): "
            f"loss relative difference {loss_rel:.3e} (bound 1e-5), gradient "
            f"relative L2 {grad_rel:.3e} (bound 1e-4), running statistics "
            f"relative L2 {stats_rel:.3e} (bound 1e-4); CPU step "
            f"{cpu_s:.1f} s")
        if not (loss_rel <= 1e-5 and grad_rel <= 1e-4 and stats_rel <= 1e-4):
            raise AssertionError("scu_train: card and CPU steps disagree")
    return launches


def write_kitti_frame(root, split, idx, seed, scene=make_objdet_scene):
    """``scene(seed)`` (points [N, 4], box dicts; ``make_objdet_scene``
    by default) as KITTI frame ``idx`` of ``split`` under ``root``: the
    velodyne ``.bin``, the calib file
    (``KITTI_CALIB``) and a label file whose boxes are the scene's, with
    each box's image rectangle projected through P2 and a truncation and
    occlusion drawn from ``seed``, so their difficulties vary."""
    root = Path(root)
    dirs = {name: root / split / name for name in
            ("velodyne", "calib", "label_2")}
    for d in dirs.values():
        d.mkdir(parents=True, exist_ok=True)
    points, boxes = scene(seed)
    points.tofile(dirs["velodyne"] / f"{idx:06d}.bin")
    calib_path = dirs["calib"] / f"{idx:06d}.txt"
    calib_path.write_text("\n".join(KITTI_CALIB) + "\n")
    lines = kitti_label_lines(boxes, KITTI.read_calib(calib_path),
                              np.random.default_rng(seed))
    (dirs["label_2"] / f"{idx:06d}.txt").write_text("\n".join(lines) + "\n")


def pp_scene(cfg, seed, n=None, boxes=None, columns=4):
    """A lidar-like frame for the PointPillars model section ``cfg``:
    (points [n, columns] float32: x, y, z, intensity and 0s; box dicts
    {'center' (its middle), 'size' (w, h, l), 'yaw', 'label_class',
    'points' (how many of the points are its)}). Ground returns over the
    config's range from 2.5 m out (the ego vehicle's footprint holds
    none), denser near the sensor, at the first class's anchor height;
    ``boxes`` boxes (``PP_SCENE_BOXES``) of the config's classes in turn
    at their anchor sizes, jittered, standing on that ground, each a
    shell of points (more the nearer it is, and fewer in a frame of
    fewer points), the first within 15 m. ``n`` is ``PP_SCENE_POINTS`` by
    default."""
    n = PP_SCENE_POINTS if n is None else n
    boxes = PP_SCENE_BOXES if boxes is None else boxes
    rng = np.random.default_rng(seed)
    pr = cfg["point_cloud_range"]
    head = cfg["head"]
    ground = head["ranges"][0][2]
    reach = min(pr[3], -pr[0], pr[4], -pr[1])
    parts, out = [], []
    for i in range(boxes):
        cls = cfg["classes"][i % len(cfg["classes"])]
        w, l, h = np.asarray(head["sizes"][i % len(head["sizes"])]) * \
            rng.uniform(0.9, 1.1, 3)
        r = rng.uniform(4, 15) if i == 0 else rng.uniform(4, 0.9 * reach)
        phi = rng.uniform(-np.pi, np.pi)
        cx, cy, cz = r * np.cos(phi), r * np.sin(phi), ground + h / 2
        yaw = rng.uniform(-np.pi, np.pi)
        k = max(8, int(min(60 * (w * l + h * (w + l)) * 12 / r, 600) *
                       n / PP_SCENE_POINTS))
        face = rng.integers(0, 5, k)
        u, v = rng.uniform(-0.5, 0.5, (2, k))
        px = np.where(face == 0, -w / 2, np.where(face == 1, w / 2, u * w))
        py = np.where(face == 2, -l / 2, np.where(face == 3, l / 2, v * l))
        py = np.where(face < 2, u * l, py)
        pz = np.where(face == 4, h / 2, rng.uniform(-0.5, 0.5, k) * h)
        c, sn = np.cos(yaw), np.sin(yaw)
        parts.append(np.stack([cx + c * px - sn * py, cy + sn * px + c * py,
                               cz + pz, rng.uniform(0.3, 1.0, k)], 1))
        out.append({"center": np.array([cx, cy, cz]),
                    "size": np.array([w, h, l]), "yaw": yaw,
                    "label_class": cls, "points": k})
    m = n - sum(len(p) for p in parts)
    r = 2.5 + (reach - 2.5) * rng.uniform(0, 1, m) ** 1.5
    phi = rng.uniform(-np.pi, np.pi, m)
    parts.append(np.stack([r * np.cos(phi), r * np.sin(phi),
                           rng.normal(ground, 0.05, m),
                           rng.uniform(0, 0.4, m)], 1))
    points = np.zeros((n, max(columns, 4)), np.float32)
    points[:, :4] = np.concatenate(parts)[rng.permutation(n)]
    return points[:, :columns], out


def kitti_label_lines(boxes, calib, rng):
    """KITTI label lines of box dicts (``pp_scene``'s or
    ``make_objdet_scene``'s) in the camera frame of ``calib``, the image
    rectangle projected through P2, truncation and occlusion drawn from
    ``rng``."""
    lines = []
    for box in boxes:
        bev = BEVBox3D(box["center"], box["size"], box["yaw"],
                       box["label_class"], -1.0, calib["world_cam"],
                       calib["cam_img"])
        cx, cy, w, h = bev.to_img()
        x, y, z = bev.to_camera()[:3]
        width, height, length = box["size"]
        lines.append(
            f"{box['label_class']} {rng.choice([0.0, 0.2, 0.4]):.2f} "
            f"{rng.integers(0, 3)} 0.00 {cx - w / 2:.2f} {cy - h / 2:.2f} "
            f"{cx + w / 2:.2f} {cy + h / 2:.2f} {height:.2f} {width:.2f} "
            f"{length:.2f} {x:.2f} {y:.2f} {z:.2f} {box['yaw']:.2f}")
    return lines


def write_nuscenes(root, cfg, frames, n=None):
    """``pp_scene`` frames in nuScenes' (and Lyft's) info format under
    ``root``: ``frames`` {split: [seed, ...]} -> ``infos_{split}.pkl``
    and a [n, 5] float32 sweep a frame (x, y, z, intensity, ring 0); each
    info's gt boxes (x, y, z, w, l, h, yaw), names and lidar point counts,
    and one more box of the first class with no points (the reader drops
    it), the lidar-to-ego pose a yaw and a lift."""
    root = Path(root)
    (root / "sweeps").mkdir(parents=True, exist_ok=True)
    for split, seeds in frames.items():
        infos = []
        for seed in seeds:
            points, boxes = pp_scene(cfg, seed, n, columns=5)
            path = root / "sweeps" / f"{split}_{seed:05d}.bin"
            points.tofile(path)
            rows = [[*b["center"], b["size"][0], b["size"][2],
                     b["size"][1], b["yaw"]] for b in boxes]
            rows.append([0.0, 0.0, -50.0, 1.0, 1.0, 1.0, 0.0])
            half = np.random.default_rng(seed).uniform(-0.2, 0.2)
            infos.append({
                "lidar_path": str(path),
                "lidar2ego_rot": [0.0, 0.0, np.sin(half), np.cos(half)],
                "lidar2ego_tr": [0.9, 0.0, 1.8],
                "num_lidar_pts": np.array([b["points"] for b in boxes] +
                                          [0]),
                "gt_boxes": np.array(rows),
                "gt_names": np.array([b["label_class"] for b in boxes] +
                                     [cfg["classes"][0]])})
        with open(root / f"infos_{split}.pkl", "wb") as f:
            pickle.dump(infos, f)


def write_waymo(root, cfg, frames, n=None):
    """``pp_scene`` frames in the Waymo export's KITTI layout under
    ``root``: ``frames`` {prefix: [seed, ...]} -> ``velodyne/
    {prefix}_{seed}.bin`` ([n, 6] float32), the KITTI calib
    (``KITTI_CALIB``) and ``label_all/`` lines (``kitti_label_lines``)."""
    root = Path(root)
    for d in ("velodyne", "calib", "label_all"):
        (root / d).mkdir(parents=True, exist_ok=True)
    for prefix, seeds in frames.items():
        for seed in seeds:
            name = f"{prefix}_{seed:05d}"
            points, boxes = pp_scene(cfg, seed, n, columns=6)
            points.tofile(root / "velodyne" / f"{name}.bin")
            calib_path = root / "calib" / f"{name}.txt"
            calib_path.write_text("\n".join(KITTI_CALIB) + "\n")
            lines = kitti_label_lines(boxes, KITTI.read_calib(calib_path),
                                      np.random.default_rng(seed))
            (root / "label_all" / f"{name}.txt").write_text(
                "\n".join(lines) + "\n")


def write_argoverse(root, cfg, frames, n=None):
    """``pp_scene`` frames in Argoverse's info format under ``root``:
    ``frames`` {split: [seed, ...]} -> ``infos_{split}.pkl`` holding one
    log of those sweeps, each a PLY of x, y, z, its boxes as dicts whose
    ``2d_coord`` (two BEV corners along the box's length) gives the yaw,
    in (0, pi) as the reader reads it."""
    root = Path(root)
    (root / "lidar").mkdir(parents=True, exist_ok=True)
    for split, seeds in frames.items():
        paths, bboxes = [], []
        for seed in seeds:
            points, boxes = pp_scene(cfg, seed, n, columns=3)
            path = root / "lidar" / f"{split}_{seed:05d}.ply"
            write_ply(str(path), [points], ["x", "y", "z"])
            paths.append(str(path))
            frame = []
            for b in boxes:
                yaw = b["yaw"] % np.pi
                yaw = min(max(yaw, 0.05), np.pi - 0.05)
                if abs(yaw - np.pi / 2) < 0.05:
                    yaw = np.pi / 2 + 0.05
                t = np.tan(yaw - np.pi / 2)
                frame.append({"label_class": b["label_class"],
                              "center": np.asarray(b["center"]),
                              "w": b["size"][0], "h": b["size"][1],
                              "l": b["size"][2],
                              "2d_coord": np.array([[t, 1.0], [0.0, 0.0]])})
            bboxes.append(frame)
        with open(root / f"infos_{split}.pkl", "wb") as f:
            pickle.dump([{"num_pc": len(paths), "lidar_path": paths,
                          "bbox": bboxes}], f)


def pp_request(model, seed=SEED):
    """The bench's PointPillars request: ``PP_BATCH`` scans of
    ``PP_POINTS`` points uniform over the config's range (intensity
    uniform in 0-1), padded to ``max_points``, as numpy arrays."""
    b, n = PP_BATCH, PP_POINTS
    rng = np.random.default_rng(seed)
    pts = np.zeros((b, model.cfg.max_points, 4), np.float32)
    pr = model.point_cloud_range
    for i in range(3):
        pts[:, :n, i] = rng.uniform(pr[i], pr[i + 3], (b, n))
    pts[:, :n, 3] = rng.uniform(0, 1, (b, n))
    return {"point": pts, "point_count": np.full((b,), n, np.int32)}


def pp_random_weights(net, seed=SEED):
    """Seeded random weights for PointPillars' nets, He-scaled so the
    activations keep their size through the ReLUs: a Linear or Conv2d
    weight by sqrt(2 / fan_in), a ConvTranspose2d (kernel = stride: one
    tap an input channel) by sqrt(2 / in); the head's convolutions by
    0.1 / sqrt(fan_in), so its logits and box deltas are of order 1, as a
    trained head's are (deltas of order 10 make boxes of 1e4 m); conv
    biases small; BatchNorm scales in 0.5-1.5, shifts small, running means
    N(0, 0.2) and variances in 0.5-1.5."""
    gen = torch.Generator().manual_seed(seed)

    def draw(t, scale):
        t.copy_(torch.randn(t.shape, generator=gen) * scale)

    with torch.no_grad():
        for name, m in net.named_modules():
            if isinstance(m, torch.nn.ConvTranspose2d):
                draw(m.weight, (2 / m.weight.shape[0]) ** .5)
            elif isinstance(m, (torch.nn.Linear, torch.nn.Conv2d)):
                gain = 0.01 if name.startswith("conv_") else 2
                draw(m.weight, (gain / m.weight[0].numel()) ** .5)
                if m.bias is not None:
                    draw(m.bias, 0.1)
            elif isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                m.weight.copy_(torch.rand(m.weight.shape, generator=gen)
                               + 0.5)
                draw(m.bias, 0.1)
                draw(m.running_mean, 0.2)
                m.running_var.copy_(
                    torch.rand(m.running_var.shape, generator=gen) + 0.5)
    return net


def pp_reference_state_dict(net, seed=SEED):
    """What ``convert_pointpillars`` takes from a reference checkpoint: a
    state_dict under the reference's names (``convert_torch``'s
    ``POINTPILLARS_NAMES``, inverted) with ``net``'s widths,
    ``pp_random_weights``' draws in a copy of ``net``, on the CPU."""
    state = pp_random_weights(copy.deepcopy(net).cpu(), seed).state_dict()
    return {convert_torch.rename(key, convert_torch.POINTPILLARS_NAMES,
                                 inverse=True): value.clone()
            for key, value in state.items()}


def pp_flops(model, scans):
    """Multiply-adds x 2 of the convolutions and the PFN's linear for
    ``scans`` scans, by the type they run in on the serving net: {"bf16":
    the backbone and the neck, "float32": the head and the PFN}; the
    float32 net does all in float32."""
    cfg = model.cfg
    ny, nx = model.output_shape
    bb, neck = cfg.backbone, cfg.neck
    cin = cfg.voxel_encoder["feat_channels"][-1]
    h, w = ny, nx
    bf16 = 0
    stage = []
    for cout, num, stride in zip(bb["out_channels"], bb["layer_nums"],
                                 bb["layer_strides"]):
        h, w = h // stride, w // stride
        bf16 += 2 * h * w * 9 * (cin * cout + num * cout * cout)
        stage.append((h, w, cout))
        cin = cout
    for (h, w, c), cout, up in zip(stage, neck["out_channels"],
                                   neck["upsample_strides"]):
        bf16 += 2 * h * w * c * cout * up * up
    hh, ww = model._featmap_size()
    heads = len(cfg.classes) + 7 + 2
    anchors = model.anchor_generator.num_base_anchors
    f32 = 2 * hh * ww * sum(neck["out_channels"]) * anchors * heads
    f32 += 2 * PP_POINTS * 9 * cfg.voxel_encoder["feat_channels"][0]
    return {"bf16": bf16 * scans, "float32": f32 * scans}


def _pp_batch(batch):
    return {k: torch.from_numpy(v).to(DEVICE) for k, v in batch.items()}


def _pp_nets(model, state):
    """The serving net (canvas, bf16), the same at float32, and the eval
    net (compact, float32), on the device with ``state``."""
    nets = {"canvas bf16": model.get_net(training=False),
            "canvas float32": MODEL.get("PointPillars")(
                **POINTPILLARS_KITTI, compute_dtype="float32").get_net(
                    training=False),
            "compact float32": model.get_eval_net()}
    for net in nets.values():
        net.load_state_dict(state)
        net.eval().to(DEVICE)
    return nets


def _pp_outputs(net, x):
    with torch.no_grad():
        return [o.float() for o in net(x)]


def _pp_rel(a, b):
    """Relative L2 of the three head outputs taken together."""
    num = sum(((x.double().cpu() - y.double().cpu()) ** 2).sum()
              for x, y in zip(a, b))
    den = sum((y.double().cpu() ** 2).sum() for y in b)
    return (num / den).sqrt().item()


def pp_convs(net):
    """The names of the serving net's backbone and neck convolutions."""
    return [name for name, m in net.named_modules()
            if name.startswith(("backbone.", "neck.")) and
            isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d))]


def _bn_bf16(bn, x):
    return torch.nn.functional.batch_norm(
        x.bfloat16(), bn.running_mean.bfloat16(), bn.running_var.bfloat16(),
        bn.weight.bfloat16(), bn.bias.bfloat16(), False, 0.0, bn.eps)


def _conv_bf16(conv, x):
    return torch.nn.functional.conv2d(
        x.bfloat16(), conv.weight.bfloat16(), conv.bias.bfloat16()).float()


@contextlib.contextmanager
def planted_cast(net, fault):
    """The serving net ``net`` with one wrong cast while the context
    lasts: "bn_bf16", the backbone's and the neck's BatchNorms in bf16;
    "head_bf16", the head's convolutions in bf16; "canvas_f32", the
    pooled canvas left in float32; or the name of one backbone or neck
    convolution (``pp_convs``), run in float32. The bf16 checks must
    catch each: ``pp_cast_faults`` all, the relative L2 all but
    "canvas_f32", whose values the first convolution rounds to bf16."""
    with contextlib.ExitStack() as stack:
        def patch(obj, name, value):
            stack.enter_context(mock.patch.object(obj, name, value))

        if fault == "bn_bf16":
            for name, m in net.named_modules():
                if (name.startswith(("backbone.", "neck.")) and
                        isinstance(m, torch.nn.modules.batchnorm._BatchNorm)):
                    patch(m, "forward", functools.partial(_bn_bf16, m))
        elif fault == "head_bf16":
            for m in (net.conv_cls, net.conv_reg, net.conv_dir_cls):
                patch(m, "forward", functools.partial(_conv_bf16, m))
        elif fault == "canvas_f32":
            for layer in net.voxel_encoder.layers:
                patch(layer, "pool_dtype", torch.float32)
        else:
            target = net.get_submodule(fault)
            conv_bn_relu = tpp._conv_bn_relu

            def float32_at_target(x, conv, bn, dtype, transpose=False):
                return conv_bn_relu(x, conv, bn, torch.float32
                                    if conv is target else dtype, transpose)
            patch(tpp, "_conv_bn_relu", float32_at_target)
        yield net


class _CastLog(TorchFunctionMode):
    """Records the dtypes of every convolution's and BatchNorm's input
    and weight, and whether the convolution has a bias."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, "__name__", "")
        if name in ("conv2d", "conv_transpose2d"):
            bias = args[2] if len(args) > 2 else kwargs.get("bias")
            self.calls.append(("head" if bias is not None else "conv",
                               args[0].dtype, args[1].dtype))
        elif name == "batch_norm":
            weight = args[3] if len(args) > 3 else kwargs.get("weight")
            self.calls.append(("bn", args[0].dtype, weight.dtype))
        return func(*args, **kwargs)


def pp_cast_faults(net, x):
    """The places in one forward of the serving net ``net`` on ``x``
    where a dtype breaks the cast contract: the pooled canvas in the net's
    compute dtype, each backbone and neck convolution on inputs and
    weights of that dtype, every BatchNorm (the PFN's too) on float32
    inputs and weights, the head's convolutions in float32. Empty when
    the net keeps it."""
    dtype = net.backbone.dtype
    f32 = torch.float32
    canvas = []
    hook = net.voxel_encoder.register_forward_hook(
        lambda m, args, out: canvas.append(out.dtype))
    log = _CastLog()
    try:
        with torch.no_grad(), log:
            net(x)
    finally:
        hook.remove()
    want = {"conv": (dtype, dtype), "bn": (f32, f32), "head": (f32, f32)}
    faults = [f"canvas {canvas[0]}"] if canvas != [dtype] else []
    faults += [f"{kind} #{i} on {a} and {b}"
               for i, (kind, a, b) in enumerate(log.calls)
               if (a, b) != want[kind]]
    counts = collections.Counter(kind for kind, _, _ in log.calls)
    bns = sum(isinstance(m, torch.nn.modules.batchnorm._BatchNorm)
              for m in net.modules())
    if counts != {"conv": len(pp_convs(net)), "bn": bns, "head": 3}:
        faults.append(f"calls {dict(counts)}")
    return faults


def _pp_occupancy(model, batch):
    """(largest pillar's points, occupied pillars) of each scan, on the
    canvas grid."""
    ny, nx = model.output_shape
    pr, vs = model.point_cloud_range, model.voxel_size
    out = []
    for pts, n in zip(batch["point"], batch["point_count"]):
        p = pts[:n]
        cx = np.floor((p[:, 0] - pr[0]) / vs[0]).astype(np.int64)
        cy = np.floor((p[:, 1] - pr[1]) / vs[1]).astype(np.int64)
        ok = ((cx >= 0) & (cx < nx) & (cy >= 0) & (cy < ny) &
              np.all(p[:, :3] >= pr[:3], 1) & np.all(p[:, :3] < pr[3:], 1))
        _, counts = np.unique(cy[ok] * nx + cx[ok], return_counts=True)
        out.append((int(counts.max()), len(counts)))
    return out


def pp_profile():
    """``--pp-profile``: one torch.profiler pass over one forward of
    the serving net and one of the eval net on the request, split by
    their record_function ranges; prints one JSON line per net: device
    ms (kernel rows), kernels, wall ms, the convolution kernels' device
    ms, and the top 8 kernels. Run in a process of its own: the profiler
    traces the card once a process."""
    from torch.profiler import ProfilerActivity, profile, record_function
    phase_device()
    model = MODEL.get("PointPillars")(**POINTPILLARS_KITTI)
    state = pp_random_weights(model.get_net(training=False)).state_dict()
    nets = _pp_nets(model, state)
    x = _pp_batch(pp_request(model))
    names = ("canvas bf16", "compact float32")
    with torch.no_grad():
        for name in names:
            for _ in range(3):
                nets[name](x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for name in names:
                with record_function(f"pp {name}"):
                    nets[name](x)
                    torch.cuda.synchronize()
    events = prof.events()
    for name in names:
        rng = next(e for e in events if e.name == f"pp {name}"
                   and e.device_type == torch.autograd.DeviceType.CPU)
        start, end = rng.time_range.start, rng.time_range.end
        kernels = collections.Counter()
        calls = collections.Counter()
        for e in events:
            if (e.device_type == torch.autograd.DeviceType.CUDA and
                    not e.name.startswith("pp ") and
                    start <= e.time_range.start <= end):
                kernels[e.name] += e.time_range.elapsed_us() / 1e3
                calls[e.name] += 1
        conv = sum(ms for k, ms in kernels.items()
                   if re.search(r"fprop|dgrad|conv|implicit", k, re.I))
        top = [[k[:64], ms, calls[k]] for k, ms in kernels.most_common(8)]
        print(json.dumps({"net": name, "device_ms": sum(kernels.values()),
                          "kernels": sum(calls.values()),
                          "wall_ms": (end - start) / 1e3, "conv_ms": conv,
                          "top": top}), flush=True)


def _pp_profiles():
    """``pp_profile`` in a child process: {net: its record}."""
    run = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                          "--pp-profile"], cwd=REPO, capture_output=True,
                         text=True, timeout=600)
    if run.returncode != 0:
        raise AssertionError(f"pointpillars: the profiler run failed:\n"
                             f"{run.stderr[-4000:]}")
    records = [json.loads(line) for line in run.stdout.splitlines()
               if line.startswith('{"net"')]
    if not records or any(r["device_ms"] <= 0 for r in records):
        raise AssertionError(f"pointpillars: the profiler saw no device "
                             f"time: {run.stdout[-2000:]}")
    return {r["net"]: r for r in records}


def _pp_serving(model, nets, x, card):
    """(a): the request through the serving and the eval net: median
    forward, scans/s, peak memory, busy share, top kernels, convolution
    share, against the FLOP bound."""
    flops = pp_flops(model, PP_BATCH)
    bounds = {"canvas bf16": (flops["bf16"] / PEAK_OPS_PER_S["bfloat16"] +
                              flops["float32"] / PEAK_OPS_PER_S["float32"]),
              "compact float32": (flops["bf16"] + flops["float32"]) /
              PEAK_OPS_PER_S["float32"]}
    say("pointpillars", f"request: {PP_BATCH} scans x {PP_POINTS} points "
        f"uniform over the KITTI range, padded to "
        f"{model.cfg.max_points}; {(flops['bf16'] + flops['float32']) / 1e9:.1f}"
        f" GFLOP a batch ({flops['bf16'] / 1e9:.1f} in the backbone and "
        f"neck, {flops['float32'] / 1e9:.1f} in the head and PFN)")
    profiles = _pp_profiles()
    for name in ("canvas bf16", "compact float32"):
        torch.cuda.reset_peak_memory_stats()
        fwd, times = median_forward_s(nets[name], x)
        peak = torch.cuda.max_memory_allocated()
        prof = profiles[name]
        top = "; ".join(f"{k} {ms:.3f} ms ({n})" for k, ms, n in prof["top"])
        bound_ms = bounds[name] * 1e3
        say("pointpillars", f"{name} forward B={PP_BATCH}: median "
            f"{fwd * 1e3:.3f} ms over {len(times)} runs (min "
            f"{min(times) * 1e3:.3f}, max {max(times) * 1e3:.3f}), "
            f"{PP_BATCH / fwd:.1f} scans/s, peak device memory "
            f"{peak / 2**30:.2f} GiB; FLOP bound {bound_ms:.3f} ms "
            f"({bound_ms / (fwd * 1e3):.1%} of the median) on {card}")
        say("pointpillars", f"{name} under torch.profiler: {prof['kernels']} "
            f"kernels, {prof['device_ms']:.3f} ms device time in a "
            f"{prof['wall_ms']:.3f} ms forward (busy "
            f"{prof['device_ms'] / prof['wall_ms']:.1%}); convolutions "
            f"(cuDNN) {prof['conv_ms']:.3f} ms, "
            f"{prof['conv_ms'] / prof['device_ms']:.1%} of the device time; "
            f"by device time: {top}")


def _pp_gates(model, nets, batch, x):
    """(b): compact float32 card vs CPU, canvas vs compact at float32,
    the decode card vs CPU, canvas bf16 vs float32."""
    compact = _pp_outputs(nets["compact float32"], x)
    cpu_net = model.get_eval_net()
    cpu_net.load_state_dict(nets["compact float32"].state_dict())
    t0 = time.perf_counter()
    cpu = _pp_outputs(cpu_net.eval(), {k: torch.from_numpy(v[:1])
                                       for k, v in batch.items()})
    cpu_s = time.perf_counter() - t0
    rel = _pp_rel([o[:1] for o in compact], cpu)
    say("pointpillars", f"compact float32, scan 0, card vs CPU: relative L2 "
        f"{rel:.3e} (bound 1e-4; CPU forward {cpu_s:.1f} s)")
    if not rel <= 1e-4:
        raise AssertionError(f"pointpillars: card vs CPU relative L2 {rel}")

    occupancy = _pp_occupancy(model, batch)
    most = max(o[0] for o in occupancy)
    pillars = max(o[1] for o in occupancy)
    canvas32 = _pp_outputs(nets["canvas float32"], x)
    rel = _pp_rel(canvas32, compact)
    say("pointpillars", f"canvas vs compact, float32 on the card: relative "
        f"L2 {rel:.3e} (bound 1e-5); no cap binds: the largest pillar holds "
        f"{most} points (cap {model.max_num_points}), at most {pillars} "
        f"pillars a scan (cap {model.max_voxels[1]})")
    if most > model.max_num_points or pillars > model.max_voxels[1]:
        raise AssertionError("pointpillars: a cap binds on the request")
    if not rel <= 1e-5:
        raise AssertionError(f"pointpillars: canvas vs compact {rel}")

    def decode(outs):
        return model.get_bboxes(*outs)

    card_dec = []
    nms_calls = _captured(cnms, "nms_bev",
                          lambda: card_dec.append(decode(compact)))
    card_dec = card_dec[0]
    for args, _ in nms_calls:
        _nms_decisions("pointpillars", "decode rows", *args)
    cpu_dec = decode([o.cpu() for o in compact])
    valid = card_dec[3].cpu()
    same = (torch.equal(valid, cpu_dec[3]) and
            torch.equal(card_dec[2].cpu(), cpu_dec[2]))
    diff = (card_dec[0].cpu()[valid] - cpu_dec[0][valid]).abs()
    err = diff.max().item()
    # exp's last bit differs between the card and the CPU: a box size of
    # 200 m is 1.5e-5 apart at one ulp, so the bound is relative
    rel = (diff / cpu_dec[0][valid].abs().clamp(min=1)).max().item()
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        decode(compact)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    say("pointpillars", f"get_bboxes card vs CPU on the card's compact "
        f"outputs: same kept (class, candidate) set {same}, boxes max "
        f"difference {err:.3e}, relative to max(1, |value|) {rel:.3e} "
        f"(bound 1e-5); detections a scan "
        f"{valid.sum(1).tolist()}; decode + NMS {statistics.median(times) * 1e3:.3f} "
        f"ms a batch of {PP_BATCH} (median of 5, synchronised)")
    if not same or not rel <= 1e-5:
        raise AssertionError("pointpillars: decode differs card vs CPU")

    bf16 = _pp_outputs(nets["canvas bf16"], x)
    rel = _pp_rel(bf16, canvas32)
    say("pointpillars", f"canvas bf16 vs canvas float32 on the card: "
        f"relative L2 {rel:.3e} (bound {PP_BF16_BOUND})")
    if not 0 < rel <= PP_BF16_BOUND:
        raise AssertionError(f"pointpillars: bf16 vs float32 {rel}")
    _pp_bf16_gate(model, nets["canvas bf16"], batch)
    return compact


def pp_stages(net, x):
    """One forward of ``net`` on ``x``, keeping each stage's output and
    what recomputes it: [(name, inputs, output)] for the canvas (inputs
    None: the points), each backbone and neck block (its input, its
    BatchNorm's name, dtype, transpose) and each head convolution (its
    input)."""
    stages = []
    names = {m: n for n, m in net.named_modules()}
    conv_bn_relu = tpp._conv_bn_relu

    def block(x, conv, bn, dtype, transpose=False):
        out = conv_bn_relu(x, conv, bn, dtype, transpose)
        stages.append((names[conv], (x, names[bn], dtype, transpose), out))
        return out

    def keep(name, module, args, out):
        if name == "voxel_encoder":
            stages.append(("canvas", None, out))
        else:
            stages.append((name, args[0], out))

    hooks = [net.get_submodule(name).register_forward_hook(
        functools.partial(keep, name))
        for name in ("voxel_encoder", "conv_cls", "conv_reg", "conv_dir_cls")]
    try:
        with mock.patch.object(tpp, "_conv_bn_relu", block), torch.no_grad():
            net(x)
    finally:
        for hook in hooks:
            hook.remove()
    return stages


def pp_stage_shares(net, ref_stages, x):
    """Each stage of ``net`` recomputed on its own device from the
    reference's inputs (the canvas from the points ``x``), against the
    reference's output: {stage: the share of elements not within 1e-5
    (relative; 1e-6 absolute)}. A stage that rounds where the reference
    does differs only where the order of a sum flips a bf16 rounding; a
    cast moved changes most of its elements."""
    canvas = next(out for name, _, out in pp_stages(net, x)
                  if name == "canvas")
    shares = {}
    with torch.no_grad():
        for name, inputs, want in ref_stages:
            if name == "canvas":
                got = canvas
            elif name.startswith("conv_"):
                got = net.get_submodule(name)(inputs.to(DEVICE))
            else:
                inp, bn, dtype, transpose = inputs
                got = tpp._conv_bn_relu(
                    inp.to(DEVICE), net.get_submodule(name),
                    net.get_submodule(bn), dtype, transpose)
            shares[name] = (~torch.isclose(
                got.float(), want.to(got.device).float(), rtol=1e-5,
                atol=1e-6)).float().mean().item()
    return shares


def _pp_bf16_gate(model, net, batch):
    """The serving net's casts on the card: pinned (``pp_cast_faults``);
    each stage fed the CPU's input on scan 0 and held to the CPU's output,
    at most ``PP_BF16_STAGE_SHARE`` of its elements apart; each wrong cast
    ``planted_cast`` plants in the card's net caught by both. The whole
    net's card-vs-CPU relative L2 is printed: at full depth a bf16
    rounding flipped by the sums' order grows into others, layer by
    layer."""
    x0 = {k: torch.from_numpy(v[:1]) for k, v in batch.items()}
    card_x = {k: v.to(DEVICE) for k, v in x0.items()}
    cpu_net = model.get_net(training=False)
    cpu_net.load_state_dict(net.state_dict())
    t0 = time.perf_counter()
    cpu = _pp_outputs(cpu_net.eval(), x0)
    cpu_s = time.perf_counter() - t0
    ref = [(name, inputs if not isinstance(inputs, tuple) else
            (inputs[0].to(DEVICE),) + inputs[1:], out.to(DEVICE))
           for name, inputs, out in pp_stages(cpu_net, x0)]
    whole = _pp_rel(_pp_outputs(net, card_x), cpu)
    pinned = pp_cast_faults(net, card_x)
    shares = pp_stage_shares(net, ref, card_x)
    worst = max(shares, key=shares.get)
    caught = {}
    for fault in PP_FAULTS + tuple(pp_convs(net)):
        with planted_cast(net, fault):
            planted = pp_stage_shares(net, ref, card_x)
            caught[fault] = (max(planted, key=planted.get),
                             max(planted.values()),
                             bool(pp_cast_faults(net, card_x)))
    least = min(caught, key=lambda k: caught[k][1])
    say("pointpillars", f"canvas bf16, scan 0, card vs CPU: whole net "
        f"relative L2 {whole:.3e} (CPU forward {cpu_s:.1f} s); casts on "
        f"the card {pinned or 'as the contract'}; {len(shares)} stages fed "
        f"the CPU's inputs: the most apart {worst}, {shares[worst]:.4%} of "
        f"its elements (bound {PP_BF16_STAGE_SHARE:.0%}); planted wrong "
        f"casts, the stage most apart and its share: " + ", ".join(
            f"{k} {s} {v:.2%}{'' if pin else ' (pin missed)'}"
            for k, (s, v, pin) in caught.items()) +
        f"; the least {least} {caught[least][1]:.2%}")
    if pinned or shares[worst] > PP_BF16_STAGE_SHARE:
        raise AssertionError(f"pointpillars: casts {pinned}, stages {shares}")
    if not all(pin and v > PP_BF16_STAGE_SHARE for _, v, pin in
               caught.values()):
        raise AssertionError(f"pointpillars: planted casts {caught}")


def _pp_entry_points(model, state, x, card):
    """(c): run_test on KITTI frames, run_valid on SyntheticBoxes,
    run_inference, and a checkpoint round trip."""
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        t0 = time.perf_counter()
        for i in range(PP_TEST_FRAMES):
            write_kitti_frame(root / "kitti", "testing", i, SEED + i)
        write_s = time.perf_counter() - t0
        dataset = KITTI(dataset_path=str(root / "kitti"),
                        test_result_folder=str(root / "results"))
        pipeline = ObjectDetection(model, dataset=dataset, device=DEVICE,
                                   seed=SEED, main_log_dir=str(root / "logs"),
                                   **POINTPILLARS_PIPELINE)
        pipeline.net.load_state_dict(state)
        spent = collections.Counter()
        net = pipeline.eval_net
        net.forward = _timed(net.forward, spent, "forward", sync=True)
        model.inference_end = _timed(model.inference_end, spent, "decode")
        try:
            t0 = time.perf_counter()
            results = pipeline.run_test()
            wall = time.perf_counter() - t0
        finally:
            del net.forward, model.inference_end
        files = sorted((root / "results").glob("*.txt"))
        if len(results) != PP_TEST_FRAMES or len(files) != PP_TEST_FRAMES:
            raise AssertionError(f"pointpillars run_test: {len(results)} "
                                 f"results, {len(files)} files")
        boxes = [len(r) for r in results]
        lines = sum(len(f.read_text().splitlines()) for f in files)
        if lines != sum(boxes):
            raise AssertionError(f"run_test wrote {lines} boxes of "
                                 f"{sum(boxes)}")
        host = wall - spent["forward"] - spent["decode"]
        say("pointpillars", f"run_test on {PP_TEST_FRAMES} KITTI frames "
            f"(written in {write_s:.2f} s): {len(files)} result files, "
            f"{boxes} boxes; wall {wall:.3f} s, "
            f"{PP_TEST_FRAMES / wall:.1f} frames/s: eval forward "
            f"{spent['forward']:.3f} s ({spent['forward'] / wall:.1%}, "
            f"synchronised), decode and boxes {spent['decode']:.3f} s "
            f"({spent['decode'] / wall:.1%}), host (read, preprocess, "
            f"transform, batch, write) {host:.3f} s ({host / wall:.1%}) "
            f"on {card}")

        frame = dataset.get_split("test").get_data(0)
        found = pipeline.run_inference(frame)
        if [b.label_class for b in found] != [b.label_class for b in
                                              results[0]]:
            raise AssertionError("run_inference differs from run_test on "
                                 "frame 0")
        say("pointpillars", f"run_inference on test frame 0: {len(found)} "
            "boxes, the classes run_test found")

        boxes_ds = SyntheticBoxes(dataset_path=str(root / "synthetic"),
                                  seed=SEED)
        valid = ObjectDetection(model, dataset=boxes_ds, device=DEVICE,
                                seed=SEED,
                                main_log_dir=str(root / "logs_valid"),
                                **POINTPILLARS_PIPELINE)
        valid.net.load_state_dict(state)
        t0 = time.perf_counter()
        ap_bev, ap_3d = valid.run_valid()
        valid_s = time.perf_counter() - t0
        if not (np.isfinite(ap_bev).all() and np.isfinite(ap_3d).all()):
            raise AssertionError("pointpillars run_valid: non-finite mAP")
        say("pointpillars", f"run_valid on SyntheticBoxes' "
            f"{len(boxes_ds.get_split('validation'))} validation frames in "
            f"{valid_s:.2f} s: mAP BEV {ap_bev.mean():.4f}, 3D "
            f"{ap_3d.mean():.4f} (random weights: finite, no floor)")

        path = pipeline.save_ckpt(0)
        fresh = ObjectDetection(model, dataset=dataset, device=DEVICE,
                                seed=SEED + 1,
                                main_log_dir=str(root / "logs"),
                                **POINTPILLARS_PIPELINE)
        if fresh.load_ckpt() != 1:
            raise AssertionError("pointpillars: load_ckpt found no epoch 0")
        fresh.eval_net.load_state_dict(fresh.net.state_dict())
        pipeline.eval_net.load_state_dict(pipeline.net.state_dict())
        # index_add_'s sums on the card are in no fixed order but for
        # this mode
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            a = _pp_outputs(pipeline.eval_net, x)
            b = _pp_outputs(fresh.eval_net, x)
        finally:
            torch.use_deterministic_algorithms(False)
        if not all(torch.equal(u, v) for u, v in zip(a, b)):
            raise AssertionError("pointpillars: the reloaded checkpoint's "
                                 "head outputs differ")
        say("pointpillars", f"{path.name} -> a fresh pipeline's load_ckpt: "
            "the eval net's head outputs on the request bit-equal "
            "(deterministic algorithms on for the two forwards)")


def phase_pointpillars(card):
    """PointPillars at the KITTI config: (a) the bench's request through
    the serving and the eval net, timed and profiled; (b) the gates; (c)
    run_test, run_valid, run_inference and a checkpoint round trip. The
    path launches one of the port's kernels: ``nms_bev``, once a decode
    on the card."""
    t0 = time.perf_counter()
    model = MODEL.get("PointPillars")(**POINTPILLARS_KITTI)
    state = pp_random_weights(model.get_net(training=False)).state_dict()
    nets = _pp_nets(model, state)
    batch = pp_request(model)
    x = _pp_batch(batch)
    reset_counts()
    _pp_serving(model, nets, x, card)
    _pp_gates(model, nets, batch, x)
    _pp_entry_points(model, state, x, card)
    torch.cuda.synchronize()
    check_counts("pointpillars", read_counts(), PP_SERVE_LAUNCHES)
    say("pointpillars", f"phase {time.perf_counter() - t0:.1f} s")


def _pp_train_model(root):
    """``PointPillars`` at the KITTI config with the YAML's augment section,
    its ObjectSample database at ``root / "bboxes.pkl"``."""
    sample = dict(POINTPILLARS_AUGMENT["ObjectSample"],
                  pickle_path=str(root / "bboxes.pkl"))
    return MODEL.get("PointPillars")(
        **POINTPILLARS_KITTI, seed=SEED,
        augment=dict(POINTPILLARS_AUGMENT, ObjectSample=sample))


def _pp_train_data(root):
    """``PP_TRAIN_FRAMES`` + ``PP_VALID_FRAMES`` KITTI training frames
    (``make_objdet_scene`` seeds 100 on) under ``root / "kitti"``, the last
    ones the validation split, an epoch ``PP_TRAIN_STEPS`` batches, and
    the gt database the port's writer builds from the train split;
    returns (dataset, database boxes)."""
    for i in range(PP_TRAIN_FRAMES + PP_VALID_FRAMES):
        write_kitti_frame(root / "kitti", "training", i, 100 + i)
    dataset = KITTI(dataset_path=str(root / "kitti"),
                    val_split=PP_TRAIN_FRAMES,
                    steps_per_epoch_train=PP_TRAIN_STEPS *
                    POINTPILLARS_TRAIN_PIPELINE["batch_size"])
    boxes = collect_bboxes.collect(dataset, root / "bboxes.pkl")
    return dataset, boxes


def _pp_instrument(pipeline, record):
    """Wrap the pipeline's train step: each call appends (start, end,
    launch counts, losses, the batch's gt arrays on the host) to
    ``record``, its end taken after a synchronise."""
    step = pipeline._train_step

    def wrapper(inputs):
        before = read_counts()
        t0 = time.perf_counter()
        losses = step(inputs)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        after = read_counts()
        gt = {k: inputs[k].cpu() for k in ("bboxes", "labels",
                                           "bbox_count")}
        record.append((t0, t1, {k: after[k] - before[k] for k in after},
                       {k: float(v) for k, v in losses.items()}, gt))
        return losses

    pipeline._train_step = wrapper


def _pp_step_events(pipeline, inputs, steps):
    """``steps`` train steps of ``pipeline`` on the device batch
    ``inputs``, each split by CUDA events: the net's forward, the loss
    (anchor assignment and the three losses), the backward and the AdamW
    step. Returns (the total losses, {part: device ms of each step})."""
    net, model, opt = pipeline.net, pipeline.model, pipeline.optimizer
    marks = []

    def marked(fn, before):
        def wrapper(*args, **kwargs):
            event = torch.cuda.Event(enable_timing=True)
            if before:
                event.record()
            out = fn(*args, **kwargs)
            if not before:
                event.record()
            marks.append(event)
            return out
        return wrapper

    # forward start, loss start, backward start (after zero_grad), AdamW
    # start, AdamW end
    net.forward = marked(net.forward, True)
    model.get_loss = marked(model.get_loss, True)
    opt.zero_grad = marked(opt.zero_grad, False)
    opt.step = marked(marked(opt.step, True), False)
    losses, ms = [], collections.defaultdict(list)
    try:
        for _ in range(steps):
            marks.clear()
            losses.append(sum(pipeline._train_step(inputs).values()).item())
            for part, (a, b) in zip(("forward", "loss", "backward", "adamw"),
                                    zip(marks, marks[1:])):
                ms[part].append(a.elapsed_time(b))
    finally:
        for obj, name in ((net, "forward"), (model, "get_loss"),
                          (opt, "zero_grad"), (opt, "step")):
            delattr(obj, name)
    return losses, ms


def _pp_targets_vs_cpu(model, gt, phase="pp_train"):
    """The anchor targets of a batch's gt boxes on the card and on the
    CPU: masks, labels and direction targets equal, the largest delta
    difference returned."""
    with torch.no_grad():
        card = model.assign_bboxes(*[gt[k].to(DEVICE) for k in
                                     ("bboxes", "labels", "bbox_count")])
        cpu = model.assign_bboxes(gt["bboxes"], gt["labels"],
                                  gt["bbox_count"])
    for key in ("pos_mask", "neg_mask", "target_labels", "dir_targets"):
        if not torch.equal(card[key].cpu(), cpu[key]):
            raise AssertionError(f"{phase}: anchor {key} card vs CPU")
    return (card["target_deltas"].cpu() - cpu["target_deltas"]).abs().max()\
        .item(), int(cpu["pos_mask"].sum())


def _float64_step():
    """While entered, a PointPillars model made and run on the CPU takes
    float64 wherever it casts to float32 (its nets and its losses)."""
    stack = contextlib.ExitStack()
    stack.enter_context(mock.patch.dict(tpp._DTYPES,
                                        {"float32": torch.float64}))
    stack.enter_context(mock.patch.object(torch.Tensor, "float",
                                          torch.Tensor.double))
    return stack


def _pp_step_vs_cpu(state, batch, witness=False, cfg=POINTPILLARS_KITTI,
                    phase="pp_train"):
    """One float32 training step (canvas, float32 convolutions) of the
    net of the model section ``cfg`` (KITTI's by default) from ``state``
    on the host ``batch``, on the card and on the CPU, the CPU on the
    card's ReLU and pillar-max branches (``_SameBranches(net="pp")``) and
    on its anchor targets. With ``witness`` the CPU runs the step in
    float64 too, on the same branches and targets: the anchor assignment
    compares IoUs with its thresholds and with each gt's best IoU, and in
    float64 some of those comparisons fall the other way (11 of 842
    positive anchors on nuScenes frames of ``pp_configs``), which moves
    the gradient by far more than rounding. Returns (loss relative
    difference, [(gradient relative L2, parameter)] and [(relative L2
    after the step, BatchNorm statistic)], each worst first, the branches,
    CPU seconds, with ``witness`` {parameter: (the card's, the CPU's
    gradient relative L2 from the float64 one)}, and {side: anchor
    decisions (positive, negative, label, direction) it would have taken
    otherwise})."""
    out = {}
    targets, targets_differ = {}, {}
    sides = [("card", DEVICE), ("cpu", "cpu")]
    if witness:
        sides.append(("float64", "cpu"))
    with _SameBranches(net="pp") as branches:
        for side, device in sides:
            with (_float64_step() if side == "float64" else
                  contextlib.nullcontext()):
                model = MODEL.get("PointPillars")(**cfg,
                                                  compute_dtype="float32")
                model.assign_bboxes = functools.partial(
                    _card_targets, model.assign_bboxes, side, targets,
                    targets_differ)
                net = model.get_net()
                net.load_state_dict(state)
                if side == "float64":
                    net.double()
                net.to(device).train()
                x = {k: (v.double() if side == "float64" and
                         v.is_floating_point() else v).to(device)
                     for k, v in batch.items()}
                t0 = time.perf_counter()
                loss = sum(model.get_loss(net(x), x).values())
                loss.backward()
                seconds = time.perf_counter() - t0
            out[side] = {
                "loss": loss.item(), "seconds": seconds,
                "grad": {k: p.grad.cpu() for k, p in net.named_parameters()},
                "stats": {k: b.cpu() for k, b in net.state_dict().items()
                          if k.endswith(("running_mean", "running_var"))}}
            if side == "card":
                recorded = list(branches.recorded)
                branches.replay()
            else:
                if branches.recorded:
                    raise AssertionError(f"{phase}: the {side} step took "
                                         f"fewer branches than the card's")
                branches.recorded = list(recorded)
                if side == "cpu":
                    differ = branches.differ
        branches.recorded, branches.differ = [], differ
    gpu, cpu = out["card"], out["cpu"]
    grads = sorted(((_rel_l2(gpu["grad"][k], v), k)
                    for k, v in cpu["grad"].items()), reverse=True)
    stats = sorted(((_rel_l2(gpu["stats"][k], v), k)
                    for k, v in cpu["stats"].items()), reverse=True)
    exact = {k: (_rel_l2(gpu["grad"][k], v), _rel_l2(cpu["grad"][k], v))
             for k, v in out["float64"]["grad"].items()} if witness else None
    return (abs(gpu["loss"] - cpu["loss"]) / abs(cpu["loss"]), grads, stats,
            branches, cpu["seconds"], exact, targets_differ)


def _flipped_line(flipped):
    """``_pp_step_vs_cpu``'s anchor decisions apart, as text."""
    return "; ".join(f"the {side} step's own differ in {n} decisions"
                     for side, n in flipped.items())


def _card_targets(assign, side, targets, differ, *args):
    """``assign(*args)`` (a model's ``assign_bboxes``) on the card's side,
    kept in ``targets``; on another side the card's targets in its dtype
    and device, the decisions its own would have taken otherwise counted
    in ``differ[side]``."""
    own = assign(*args)
    if side == "card":
        targets.update({k: v.cpu() for k, v in own.items()})
        return own
    differ[side] = sum(int((own[k].cpu() != targets[k]).sum()) for k in
                       ("pos_mask", "neg_mask", "target_labels",
                        "dir_targets"))
    return {k: targets[k].to(v.device, v.dtype) for k, v in own.items()}


def pp_train_profile():
    """``--pp-train-profile``: one torch.profiler pass over one training
    step of the KITTI net (bf16 canvas, B = 6 frames of
    ``make_objdet_scene`` seeds 100 on, range-filtered, no augmentation:
    the device work of a step does not depend on it) after two warm-up
    steps; prints one JSON line: device ms (kernel rows), kernels, wall
    ms, the convolution kernels' device ms, and the top 10 kernels. Run
    in a process of its own: the profiler traces the card once a
    process."""
    from torch.profiler import ProfilerActivity, profile, record_function
    phase_device()
    model = MODEL.get("PointPillars")(**POINTPILLARS_KITTI)
    attr = {"split": "training"}
    samples = []
    for i in range(POINTPILLARS_TRAIN_PIPELINE["batch_size"]):
        points, boxes = make_objdet_scene(100 + i)
        data = {"point": points, "calib": None, "bounding_boxes": [
            BEVBox3D(b["center"], b["size"], b["yaw"], b["label_class"], -1)
            for b in boxes]}
        samples.append({"data": model.transform(model.preprocess(data, attr),
                                                attr), "attr": attr})
    batch = DefaultBatcher().collate_fn(samples)
    x = {k: torch.from_numpy(v).to(DEVICE) for k, v in batch["data"].items()
         if isinstance(v, np.ndarray)}
    net = model.get_net().to(DEVICE).train()
    opt, _ = model.get_optimizer(POINTPILLARS_TRAIN_PIPELINE, net)

    def step():
        losses = model.get_loss(net(x), x)
        opt.zero_grad(set_to_none=True)
        sum(losses.values()).backward()
        opt.step()

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("pp train step"):
            step()
            torch.cuda.synchronize()
    events = prof.events()
    rng = next(e for e in events if e.name == "pp train step" and
               e.device_type == torch.autograd.DeviceType.CPU)
    # the device rows of annotated ranges (this one, AdamW's step) repeat
    # their kernels' time
    ranges = {e.name for e in events
              if e.device_type == torch.autograd.DeviceType.CPU}
    kernels, calls = collections.Counter(), collections.Counter()
    for e in events:
        if (e.device_type == torch.autograd.DeviceType.CUDA and
                e.name not in ranges):
            kernels[e.name] += e.time_range.elapsed_us() / 1e3
            calls[e.name] += 1
    conv = sum(ms for k, ms in kernels.items()
               if re.search(r"fprop|dgrad|wgrad|conv|implicit", k, re.I))
    top = [[k[:64], ms, calls[k]] for k, ms in kernels.most_common(10)]
    print(json.dumps({"device_ms": sum(kernels.values()),
                      "kernels": sum(calls.values()),
                      "wall_ms": rng.time_range.elapsed_us() / 1e3,
                      "conv_ms": conv, "top": top}), flush=True)


def _pp_fit(model, dataset, root, batch, seeded,
            pipeline_cfg=POINTPILLARS_TRAIN_PIPELINE, phase="pp_train"):
    """The weights after ``PP_FIT_STEPS`` AdamW steps on ``batch`` of a
    fresh pipeline seeded as pp_train's first (its net checked equal to
    ``seeded``), under torch's deterministic algorithms, and the total
    losses. The card's training steps are not reproducible otherwise
    (atomic sums), and from weights trained so the float32 step's worst
    gradient against the float64 one moved from run to run: 2.65e-5 to
    6.08e-5 over 17 runs on an H100 80GB HBM3, and one whole run of this
    script failed the check there. These weights are the same in every
    run on one card and software."""
    pipeline = ObjectDetection(model, dataset=dataset, device=DEVICE,
                               seed=SEED, max_epoch=0,
                               main_log_dir=str(root / "fit"),
                               **pipeline_cfg)
    for key, value in pipeline.net.state_dict().items():
        if not torch.equal(value.cpu(), seeded[key]):
            raise AssertionError(f"{phase} fit: {key} is not the seeded "
                                 f"weights'")
    pipeline.optimizer, _ = model.get_optimizer(pipeline.cfg, pipeline.net)
    inputs = pipeline._device_batch(batch)
    torch.use_deterministic_algorithms(True)
    try:
        losses = [sum(pipeline._train_step(inputs).values()).item()
                  for _ in range(PP_FIT_STEPS)]
    finally:
        torch.use_deterministic_algorithms(False)
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{phase} fit: loss did not fall: {losses}")
    return ({k: v.cpu().clone()
             for k, v in pipeline.net.state_dict().items()}, losses)


def _pp_train_profile():
    run = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                          "--pp-train-profile"], cwd=REPO,
                         capture_output=True, text=True, timeout=600)
    if run.returncode != 0:
        raise AssertionError(f"pp_train: the profiler run failed:\n"
                             f"{run.stderr[-4000:]}")
    records = [json.loads(line) for line in run.stdout.splitlines()
               if line.startswith('{"device_ms"')]
    if not records or records[0]["device_ms"] <= 0:
        raise AssertionError(f"pp_train: the profiler saw no device time: "
                             f"{run.stdout[-2000:]}")
    return records[0]


def phase_pp_train(card):
    """``ObjectDetection.run_train`` of PointPillars at the KITTI config
    (B = 6, bf16 canvas, AdamW, ObjectSample on a database the port's
    writer builds) for one epoch of ``PP_TRAIN_STEPS`` steps and its
    validation, a resumed epoch, overfit steps on one batch with the
    step's parts on CUDA events, the anchor targets and a float32 step
    card vs CPU from the seeded weights and from those after
    ``PP_FIT_STEPS`` steps on that batch (``_pp_fit``; there with the step
    in float64 beside it), and a profiled step in a child process. The training steps launch none of the port's
    kernels; each decode of the validation on the card launches
    ``nms_bev`` once."""
    t0 = time.perf_counter()
    b = POINTPILLARS_TRAIN_PIPELINE["batch_size"]
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        t1 = time.perf_counter()
        dataset, db_boxes = _pp_train_data(root)
        data_s = time.perf_counter() - t1
        model = _pp_train_model(root)
        pipeline = ObjectDetection(model, dataset=dataset, device=DEVICE,
                                   seed=SEED, max_epoch=0,
                                   main_log_dir=str(root / "logs"),
                                   **POINTPILLARS_TRAIN_PIPELINE)
        seeded = {k: v.cpu().clone()
                  for k, v in pipeline.net.state_dict().items()}
        record = []
        _pp_instrument(pipeline, record)
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t1 = time.perf_counter()
        pipeline.run_train()
        wall = time.perf_counter() - t1
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        if len(record) != PP_TRAIN_STEPS:
            raise AssertionError(f"pp_train: {len(record)} steps, expected "
                                 f"{PP_TRAIN_STEPS}")
        for _, _, counts, losses, _ in record:
            if counts != every_count({}):
                raise AssertionError(f"pp_train: a step launched {counts}")
            if not all(np.isfinite(v) for v in losses.values()):
                raise AssertionError(f"pp_train: losses {losses}")
        steps = [t1_ - t0_ for t0_, t1_, _, _, _ in record]
        step = statistics.median(steps[1:])
        loop = record[-1][1] - record[0][0]
        busy = sum(steps)
        totals = [round(sum(r[3].values()), 4) for r in record]
        say("pp_train", f"{len(dataset.get_split('train'))} + "
            f"{len(dataset.get_split('validation'))} KITTI frames and a gt "
            f"database of {db_boxes} boxes written in {data_s:.2f} s; "
            f"run_train max_epoch=0: {PP_TRAIN_STEPS} steps of {b} frames "
            f"(ObjectSample, ObjectRangeFilter, PointShuffle), total losses "
            f"{totals}, finite; validation mAP BEV "
            f"{pipeline.valid_map_bev:.4f}, 3D {pipeline.valid_map_3d:.4f}")
        say("pp_train", f"step B={b} canvas bf16: median "
            f"{step * 1e3:.3f} ms over steps 2..{PP_TRAIN_STEPS} (min "
            f"{min(steps[1:]) * 1e3:.3f}, max {max(steps[1:]) * 1e3:.3f}, "
            f"first {steps[0] * 1e3:.3f}), {b / step:.1f} frames trained/s "
            f"on {card}")
        say("pp_train", f"wall {wall:.3f} s, of it before the first step "
            f"{record[0][0] - t1:.3f} s and the step loop {loop:.3f} s: "
            f"steps (synchronised) {busy / loop:.1%}, host between steps "
            f"(loading, augmentation, batching, copies) "
            f"{1 - busy / loop:.1%}; peak device memory "
            f"{peak / 2**30:.2f} GiB on {card}")
        ckpt = Path(pipeline.cfg.logs_dir) / "checkpoint" / "ckpt_00000.pth"
        if not ckpt.exists():
            raise AssertionError(f"pp_train: no checkpoint at {ckpt}")

        trained = {k: v.clone() for k, v in pipeline.net.state_dict().items()}
        resumed = ObjectDetection(model, dataset=dataset, device=DEVICE,
                                  seed=SEED + 1, max_epoch=1,
                                  main_log_dir=str(root / "logs"),
                                  **POINTPILLARS_TRAIN_PIPELINE)
        load = resumed.load_ckpt
        seen = {}

        def checked(*args, **kwargs):
            seen["epoch"] = load(*args, **kwargs)
            for key, value in resumed.net.state_dict().items():
                if not torch.equal(value, trained[key]):
                    raise AssertionError(f"pp_train resume: {key} differs")
            if resumed.optimizer.state_dict()["state"]:
                raise AssertionError("pp_train resume: AdamW not fresh")
            return seen["epoch"]

        resumed.load_ckpt = checked
        record2 = []
        _pp_instrument(resumed, record2)
        resumed.run_train()
        if seen.get("epoch") != 1 or len(record2) != PP_TRAIN_STEPS:
            raise AssertionError(f"pp_train resume: epoch {seen.get('epoch')}"
                                 f", {len(record2)} steps")
        say("pp_train", f"{ckpt.name} -> a fresh pipeline resumed at epoch "
            f"1 with equal weights and BN statistics and a fresh AdamW (as "
            f"the JAX pipeline resumes), {len(record2)} steps, total losses "
            f"{[round(sum(r[3].values()), 4) for r in record2]}")

        gt = record[0][4]
        delta, pos = _pp_targets_vs_cpu(model, gt)
        say("pp_train", f"anchor targets of step 1's batch ({pos} positives "
            f"of {gt['bbox_count'].sum().item()} gt boxes), card vs CPU: "
            f"masks, labels and direction targets equal, deltas within "
            f"{delta:.3e} (bound 1e-6)")
        if not delta <= 1e-6:
            raise AssertionError("pp_train: anchor deltas card vs CPU")

        loader = PointCloudDataloader(dataset.get_split("train"),
                                      preprocess=model.preprocess,
                                      transform=model.transform)
        batch = next(iter(BatchLoader(loader, b, DefaultBatcher(),
                                      num_workers=0)))
        inputs = resumed._device_batch(batch)
        losses, ms = _pp_step_events(resumed, inputs, 10)
        if not losses[-1] < losses[0]:
            raise AssertionError(f"pp_train overfit: loss did not fall: "
                                 f"{losses}")
        med = {k: statistics.median(v[1:]) for k, v in ms.items()}
        say("pp_train", f"10 steps on one batch: total loss "
            f"{losses[0]:.4f} -> {losses[-1]:.4f} "
            f"({[round(x, 4) for x in losses]}); device ms a step, median of "
            f"steps 2..10 (CUDA events): forward {med['forward']:.3f}, loss "
            f"(anchor assignment, focal, smooth-L1, direction) "
            f"{med['loss']:.3f}, backward {med['backward']:.3f}, AdamW "
            f"{med['adamw']:.3f} on {card}")

        host = {k: torch.from_numpy(v[:PP_CPU_BATCH])
                for k, v in batch["data"].items() if isinstance(v, np.ndarray)}
        fitted, fit_losses = _pp_fit(model, dataset, root, batch, seeded)
        say("pp_train", f"{PP_FIT_STEPS} steps on that batch from the "
            f"seeded weights under torch's deterministic algorithms: total "
            f"loss {fit_losses[0]:.4f} -> {fit_losses[-1]:.4f}")

        def worst(pairs):
            return ", ".join(f"{k} {v:.3e}" for v, k in pairs[:3])

        # From the seeded weights the card's gradients are held to the
        # CPU's. From trained weights the CPU's own float32 sums lie near
        # the bound from the exact step (7.514e-5 of a card-vs-CPU 8.506e-5
        # on an H100 80GB HBM3, the card's 3.615e-5), so there the card's
        # are held to the step in float64 and the card-vs-CPU reading is
        # printed.
        for name, state in (("the seeded weights", seeded),
                            (f"the weights after {PP_FIT_STEPS} steps",
                             fitted)):
            t1 = time.perf_counter()
            loss_rel, grads, stats, branches, cpu_s, exact, flipped = \
                _pp_step_vs_cpu(state, host, witness=state is fitted)
            say("pp_train", f"one float32 step B={PP_CPU_BATCH} from {name}, "
                f"card vs CPU on the card's branches ({branches.differ} of "
                f"{branches.total} ReLU and pillar-max choices the CPU would "
                f"have made otherwise) and anchor targets "
                f"({_flipped_line(flipped)}): loss relative difference "
                f"{loss_rel:.3e} (bound 1e-5); relative L2 of each "
                f"parameter's gradient ("
                f"{'printed' if exact else 'bound 1e-4'}), the worst: "
                f"{worst(grads)}; of each BN statistic after the step (bound "
                f"1e-4), the worst: {worst(stats)}; CPU step {cpu_s:.1f} s, "
                f"the comparison {time.perf_counter() - t1:.1f} s")
            worst_grad = grads[0][0]
            if exact:
                worst_grad = max(a for a, _ in exact.values())
                say("pp_train", "the same step in float64 on the CPU, on the "
                    "card's branches: relative L2 of the card's and the CPU's "
                    "float32 gradients from it, where they differ most: " +
                    "; ".join(f"{k} card {exact[k][0]:.3e}, CPU "
                              f"{exact[k][1]:.3e}" for _, k in grads[:3]) +
                    f"; the worst over every parameter: card "
                    f"{worst_grad:.3e} (bound 1e-4), CPU "
                    f"{max(b for _, b in exact.values()):.3e}")
            if not (loss_rel <= 1e-5 and worst_grad <= 1e-4 and
                    stats[0][0] <= 1e-4):
                raise AssertionError(
                    f"pp_train: the card's step from {name} disagrees: loss "
                    f"relative difference {loss_rel:.3e} (bound 1e-5), worst "
                    f"gradient {worst_grad:.3e} (bound 1e-4; card vs CPU: "
                    f"{worst(grads)}), worst BN statistic {worst(stats)} "
                    f"(bound 1e-4), {branches.differ} branches differ")
        torch.cuda.synchronize()
        check_counts("pp_train", read_counts(), PP_TRAIN_LAUNCHES)

    prof = _pp_train_profile()
    top = "; ".join(f"{k} {v:.3f} ms ({n})" for k, v, n in prof["top"])
    say("pp_train", f"one step B={b} under torch.profiler: "
        f"{prof['kernels']} kernels, {prof['device_ms']:.3f} ms device time "
        f"in a {prof['wall_ms']:.3f} ms step (busy "
        f"{prof['device_ms'] / prof['wall_ms']:.1%}); convolutions (cuDNN) "
        f"{prof['conv_ms']:.3f} ms, {prof['conv_ms'] / prof['device_ms']:.1%}"
        f" of the device time; by device time: {top}")
    say("pp_train", f"phase {time.perf_counter() - t0:.1f} s")


def write_semantickitti(root, n, scans=SEMANTICKITTI_SCANS, seed=SEED):
    """A SemanticKITTI tree under ``root``: a ``velodyne`` directory for
    every sequence the shipped config's splits name, and in the sequences
    of ``scans`` that many scans of ``n`` points (``lidar_scan`` and a
    remission uniform in 0-1, float32 ``.bin``), each from its own seed.
    Sequences below ``SEMANTICKITTI_FIRST_TEST`` get ``.label`` files:
    raw ids drawn from ``LEARNING_MAP``'s keys, an instance id in the
    upper 16 bits. Returns {sequence: [scan paths]}."""
    root = Path(root)
    raw_ids = np.array(sorted(LEARNING_MAP), np.uint32)
    paths = {}
    for seq in range(22):
        seq = f"{seq:02d}"
        folder = root / "dataset" / "sequences" / seq
        (folder / "velodyne").mkdir(parents=True)
        paths[seq] = []
        for frame in range(scans.get(seq, 0)):
            seed += 1
            rng = np.random.default_rng(seed)
            scan = np.concatenate([lidar_scan(n, seed),
                                   rng.uniform(0, 1, (n, 1))], 1)
            path = folder / "velodyne" / f"{frame:06d}.bin"
            scan.astype(np.float32).tofile(path)
            paths[seq].append(path)
            if seq < SEMANTICKITTI_FIRST_TEST:
                (folder / "labels").mkdir(exist_ok=True)
                raw = (raw_ids[rng.integers(0, len(raw_ids), n)] |
                       (rng.integers(0, 1 << 16, n).astype(np.uint32) << 16))
                raw.tofile(folder / "labels" / f"{frame:06d}.label")
    return paths


def write_scannet_rooms(root, n, counts=SCU_TRAIN_ROOMS, seed=SEED):
    """ScanNet-format rooms under ``root``: for each split of ``counts``
    that many scenes named from the port's copy of its official list, each
    ``scu_scene(6 m, n)``'s points and RGB (``_vert.npy``), its labels as
    nyu40 ids (``_sem_label.npy``, some outside the reader's 18 classes),
    instance ids and two boxes."""
    root = Path(root)
    root.mkdir(parents=True)
    lists = (REPO / "open3d_ml_tpu_torch" / "datasets" / "_resources" /
             "scannet")
    for split, count in counts.items():
        names = (lists / f"scannetv2_{split}.txt").read_text().split()
        for name in names[:count]:
            seed += 1
            data = scu_scene(SCU_ROOM_EXTENT_M, n, seed)
            np.save(root / f"{name}_vert.npy",
                    np.concatenate([data["point"], data["feat"]], 1))
            np.save(root / f"{name}_sem_label.npy",
                    (data["label"].astype(np.int64) * 7 + 3) % 41)
            np.save(root / f"{name}_ins_label.npy",
                    np.random.default_rng(seed).integers(0, 20, n))
            boxes = np.zeros((2, 7))
            boxes[:, 3:6] = 1.0
            boxes[:, 6] = (3, 39)
            np.save(root / f"{name}_bbox.npy", boxes)


@contextlib.contextmanager
def _cli_record(record, timed=()):
    """Within: every ``SemanticSegmentation`` train and eval step appends
    (kind, start, end, launch counts, loss) to ``record``, its end taken
    after a synchronise, and each (class, method) of ``timed`` adds its
    seconds and calls to ``record``'s last element, a Counter."""
    spent = collections.Counter()
    patches = []
    for kind, name in (("train", "_train_step"), ("eval", "_eval_step")):
        real = getattr(SemanticSegmentation, name)

        def step(self, inputs, loss_fn, real=real, kind=kind):
            before = read_counts()
            t0 = time.perf_counter()
            loss, cm = real(self, inputs, loss_fn)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            after = read_counts()
            record.append((kind, t0, t1,
                           {k: after[k] - before[k] for k in after},
                           float(loss)))
            return loss, cm

        patches.append(mock.patch.object(SemanticSegmentation, name, step))
    for cls, name in timed:
        real = getattr(cls, name)

        def method(self, *args, real=real, key=f"{cls.__name__}.{name}",
                   **kwargs):
            t0 = time.perf_counter()
            out = real(self, *args, **kwargs)
            spent[key] += time.perf_counter() - t0
            spent[key + " calls"] += 1
            return out

        patches.append(mock.patch.object(cls, name, method))
    with contextlib.ExitStack() as stack:
        for patch in patches:
            stack.enter_context(patch)
        yield spent


def _cli_run(argv, timed=()):
    """``run_pipeline.main(argv)`` with the launch counts reset just
    before and read just after: (wall s, launch counts, the steps' record,
    the seconds of ``timed``)."""
    record = []
    with _cli_record(record, timed) as spent:
        reset_counts()
        t0 = time.perf_counter()
        run_pipeline.main([str(a) for a in argv])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts()
    return wall, launches, record, spent


def phase_cli(card):
    """The port's command line, in this process, on the shipped configs:
    RandLA-Net trains one short epoch on a SemanticKITTI tree and tests
    its checkpoint, writing SemanticKITTI ``.label`` predictions, and
    SparseConvUnet trains one short epoch on ScanNet rooms."""
    t_phase = time.perf_counter()
    steps, valid_steps = CLI_STEPS["randlanet"]
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        t0 = time.perf_counter()
        scans = write_semantickitti(root / "kitti", SCAN_POINTS)
        written_s = time.perf_counter() - t0
        model_cfg = MODEL.get("RandLANet")().cfg
        common = ["-c", REPO / CLI_CONFIGS["randlanet"], "--device", DEVICE,
                  "--dataset.dataset_path", root / "kitti",
                  "--dataset.cache_dir", root / "cache",
                  "--dataset.test_result_folder", root / "test",
                  "--main_log_dir", root / "logs"] + CLI_RANDLANET_EXTRAS
        pre = ((trl.RandLANet, "preprocess"),)
        wall, launches, record, spent = _cli_run(common + [
            "--split", "train", "--pipeline.max_epoch", 0,
            "--dataset.steps_per_epoch_train", steps * 4,
            "--dataset.steps_per_epoch_valid", valid_steps * 2], pre)
        train_s = _check_steps(
            record, 0, len(record), TRAIN_STEP_LAUNCHES, EXPECTED_LAUNCHES,
            ["train"] * steps + ["eval"] * valid_steps)
        check_counts("cli", launches, {
            "bucket_knn": 5 * (steps + valid_steps),
            "bucket_gather": 16 * (steps + valid_steps),
            "bucket_gather_bwd": 16 * steps})
        ckpt = (root / "logs" / "RandLANet_SemanticKITTI_torch" /
                "checkpoint" / "ckpt_00000.pth")
        if not ckpt.exists():
            raise AssertionError(f"cli: no checkpoint at {ckpt}")
        train_loop = record[steps - 1][2] - record[0][1]
        pre_s = spent["RandLANet.preprocess"]
        say("cli", f"SemanticKITTI tree: {len(scans['00'])} + "
            f"{len(scans['08'])} + {len(scans['11'])} scans of {SCAN_POINTS} "
            f"points in sequences 00, 08 and 11 (written in {written_s:.2f} "
            f"s); run_pipeline -c {CLI_CONFIGS['randlanet']} "
            f"{' '.join(map(str, CLI_RANDLANET_EXTRAS))} --split train "
            f"--pipeline.max_epoch 0: {steps} train steps of 4 x "
            f"{model_cfg.num_points} (fused S{model_cfg.num_segs}/"
            f"G{model_cfg.gather_segs}) and {valid_steps} validation steps "
            f"of 2 (S{model_cfg.infer_num_segs}/"
            f"G{model_cfg.infer_gather_segs}), losses "
            f"{[round(r[4], 4) for r in record]}, finite; {ckpt.name} "
            "written")
        steady = statistics.median(train_s[1:])
        say("cli", f"RandLA train run: wall {wall:.3f} s; {steps} steps in "
            f"{train_loop:.3f} s, {steps / train_loop:.2f} steps/s with the "
            f"first ({train_s[0] * 1e3:.2f} ms), {1 / steady:.2f} steps/s "
            f"at the median of steps 2..{steps} ({steady * 1e3:.2f} ms); "
            f"host preprocess "
            f"{pre_s:.3f} s over {spent['RandLANet.preprocess calls']} "
            f"scans, {pre_s / wall:.1%} of the run on {card}")

        forwards = collections.Counter()
        real_forward = trl.RandLANetNet.forward

        def counted(self, *args, **kwargs):
            forwards[self.knn_method] += 1
            return real_forward(self, *args, **kwargs)

        with mock.patch.object(trl.RandLANetNet, "forward", counted):
            wall, launches, _, spent = _cli_run(common + [
                "--split", "test", "--ckpt_path", ckpt], pre)
        check_counts("cli", launches, {
            "knn_exact": model_cfg.num_layers * forwards["exact"]})
        predictions = sorted((root / "test" / "sequences" / "11" /
                              "predictions").glob("*.label"))
        raw = set(LEARNING_MAP_INV.values())
        if len(predictions) != len(scans["11"]):
            raise AssertionError(f"cli: test wrote {predictions}")
        for path in predictions:
            pred = np.fromfile(path, dtype=np.uint32)
            if pred.shape != (SCAN_POINTS,) or not set(
                    np.unique(pred).tolist()) <= raw:
                raise AssertionError(f"cli: {path.name} holds {pred.shape} "
                                     f"ids {np.unique(pred)}")
        pre_s = spent["RandLANet.preprocess"]
        say("cli", f"RandLA test run (--split test --ckpt_path "
            f"{ckpt.name}): wall {wall:.3f} s, "
            f"{len(predictions) / wall:.3f} scans/s, {forwards['exact']} "
            f"exact eval forwards; {len(predictions)} .label files of "
            f"{SCAN_POINTS} uint32 raw ids in LEARNING_MAP_INV's image; host "
            f"preprocess {pre_s:.3f} s over "
            f"{spent['RandLANet.preprocess calls']} calls, {pre_s / wall:.1%} "
            f"of the run on {card}")

        steps, valid_steps = CLI_STEPS["scu"]
        scu_cfg = MODEL.get("SparseConvUnet")().cfg
        batch = SCU_TRAIN_PIPELINE["batch_size"]
        t0 = time.perf_counter()
        write_scannet_rooms(root / "scannet", scu_cfg.num_points)
        written_s = time.perf_counter() - t0
        wall, launches, record, spent = _cli_run([
            "-c", REPO / CLI_CONFIGS["scu"], "--device", DEVICE,
            "--dataset.dataset_path", root / "scannet",
            "--dataset.cache_dir", root / "cache",
            "--main_log_dir", root / "logs", "--split", "train",
            "--pipeline.max_epoch", 0,
            "--dataset.steps_per_epoch_train", steps * batch,
            "--dataset.steps_per_epoch_valid", valid_steps * batch],
            ((tscu.SparseConvUnet, "preprocess"),))
        valid = {"stencil_conv": SCU_FORWARD_LAUNCHES}
        train_s = _check_steps(
            record, 0, len(record), SCU_TRAIN_STEP_LAUNCHES, valid,
            ["train"] * steps + ["eval"] * valid_steps)
        check_counts("cli", launches, {
            key: n * steps + valid.get(key, 0) * valid_steps
            for key, n in SCU_TRAIN_STEP_LAUNCHES.items()})
        ckpt = (root / "logs" / "SparseConvUnet_Scannet_torch" /
                "checkpoint" / "ckpt_00000.pth")
        if not ckpt.exists():
            raise AssertionError(f"cli: no checkpoint at {ckpt}")
        pre_s = spent["SparseConvUnet.preprocess"]
        train_loop = record[steps - 1][2] - record[0][1]
        say("cli", f"ScanNet rooms: {SCU_TRAIN_ROOMS['train']} + "
            f"{SCU_TRAIN_ROOMS['val']} of {scu_cfg.num_points} points "
            f"(written in {written_s:.2f} s); run_pipeline -c "
            f"{CLI_CONFIGS['scu']} --split train --pipeline.max_epoch 0: "
            f"wall {wall:.3f} s; {steps} train steps of {batch} in "
            f"{train_loop:.3f} s, {steps / train_loop:.2f} steps/s (first "
            f"{train_s[0] * 1e3:.2f} ms, last {train_s[-1] * 1e3:.2f}) and "
            f"{valid_steps} "
            f"validation step(s), losses {[round(r[4], 4) for r in record]}, "
            f"finite; {ckpt.name} written; host preprocess {pre_s:.3f} s over "
            f"{spent['SparseConvUnet.preprocess calls']} rooms, "
            f"{pre_s / wall:.1%} of the run on {card}")
    say("cli", f"phase {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------- PointTransformer

def write_s3dis_rooms(root, n, rooms=PT_ROOMS, seed=SEED):
    """S3DIS rooms under ``root`` as ``original_pkl/<name>.pkl``: (an [n, 7]
    array of x, y, z, r, g, b, label, no boxes), each an 8 x 6 x 3 m office
    (floor, ceiling and four walls, a colour and an S3DIS class each, and
    two tables of clutter) sampled with ``n`` points from its own seed: at
    4 cm a room keeps ~55,000 of its ~110,000 surface voxels, over the
    16,384 points of a patch."""
    root = Path(root) / "original_pkl"
    root.mkdir(parents=True)
    # (class, colour, x0, x1, y0, y1, z0, z1) of each surface
    surfaces = [(1, (120, 110, 100), 0, 8, 0, 6, 0, 0),
                (0, (230, 230, 225), 0, 8, 0, 6, 3, 3),
                (2, (200, 190, 170), 0, 0, 0, 6, 0, 3),
                (2, (200, 190, 170), 8, 8, 0, 6, 0, 3),
                (2, (190, 180, 160), 0, 8, 0, 0, 0, 3),
                (2, (190, 180, 160), 0, 8, 6, 6, 0, 3),
                (7, (140, 90, 50), 1, 3, 1, 2.5, 0.75, 0.75),
                (12, (60, 60, 200), 5, 7, 3, 5, 0.9, 0.9)]
    # each surface's area: the product of its two extents
    area = np.array([np.prod(sorted((x1 - x0, y1 - y0, z1 - z0))[1:])
                     for _, _, x0, x1, y0, y1, z0, z1 in surfaces])
    for name in rooms:
        seed += 1
        rng = np.random.default_rng(seed)
        which = rng.choice(len(surfaces), n, p=area / area.sum())
        box = np.array([s[2:] for s in surfaces], np.float64)[which]
        u = rng.uniform(0, 1, (n, 3))
        xyz = box[:, 0::2] + u * (box[:, 1::2] - box[:, 0::2])
        colour = np.array([s[1] for s in surfaces], np.float64)[which]
        rgb = np.clip(colour + rng.normal(0, 12, (n, 3)), 0, 255).round()
        label = np.array([s[0] for s in surfaces], np.float64)[which]
        pc = np.concatenate([xyz, rgb, label[:, None]], 1).astype(np.float32)
        with open(root / f"{name}.pkl", "wb") as f:
            pickle.dump((pc, []), f)


def pt_request(model, b=PT_EVAL_BATCH, seed=SEED):
    """The bench's request (``bench.py:530-564``): b patches of
    ``num_points`` points uniform in [0, 8)^3 and features uniform in
    [0, 1), float32, on the CPU."""
    rng = np.random.default_rng(seed)
    n = model.cfg.num_points
    return {"point": torch.from_numpy(
                rng.uniform(0, 8, (b, n, 3)).astype(np.float32)),
            "feat": torch.from_numpy(
                rng.uniform(0, 1, (b, n, 3)).astype(np.float32))}


def pt_searches(cfg, b=PT_EVAL_BATCH):
    """(label, N, Q, k, calls per forward) of each ``knn_exact`` shape of a
    PointTransformer forward at ``cfg``'s blocks and patch size: each
    level's self-searches (one a Bottleneck), each stride's grouping (the
    sampled points' neighbours in the level above) and each skip
    TransitionUp's 3-NN (the level's points among the next level's)."""
    n = [cfg.num_points]
    for s in tpt.STRIDE[1:]:
        n.append(n[-1] // s)
    out = []
    for i in range(5):
        if i:
            out.append((f"L{i} grouping", n[i - 1], n[i], tpt.NSAMPLE[i], 1))
        out.append((f"L{i} attention", n[i], n[i], tpt.NSAMPLE[i],
                    cfg.blocks[i]))
    for i in range(4):
        out.append((f"L{i} 3-NN", n[i + 1], n[i], 3, 1))
    return out


def pt_fused_searches(cfg, n):
    """(label, (npad, Q, k, S, qblock)) of each ``bucket_knn`` call of the
    fused pyramid (``build_pt_pyramid``) of ``n``-point clouds at ``cfg``
    (a PointTransformer model config), in call order: each level's
    attention search, and but at the last its grouping search (unless the
    attention tables are reused, at ``gather_segs`` 0) and its upsample
    search. npad: the searched points, padded to a multiple of seg."""
    seg, block = cfg.get("seg", 64), cfg.get("block", 128)
    num_segs, gather_segs = cfg.get("num_segs", 64), cfg.get("gather_segs",
                                                             32)

    def pad(m):
        return -(-m // seg) * seg

    out = []
    for i, ratio in enumerate(tpt.STRIDE[1:] + (None,)):
        s, qb = min(num_segs, -(-n // seg)), min(block, max(8, n))
        k = min(tpt.NSAMPLE[i], n)
        out.append((f"L{i} attention", (pad(n), n, k, s, qb)))
        if ratio is None:
            break
        sub = n // ratio
        k_dn = min(tpt.NSAMPLE[i + 1], n)
        if not (k_dn == k and qb % ratio == 0 and n % qb == 0 and
                not gather_segs):
            out.append((f"L{i} grouping", (pad(n), sub, k_dn, s, qb)))
        s_up = min(max(2, num_segs // 2), -(-sub // seg))
        out.append((f"L{i} upsample", (pad(sub), n, min(tpt.UP_K, sub), s_up,
                                       qb)))
        n = sub
    return out


def _pt_points(b, n, seed, kind="uniform"):
    """[b, n, 3] points on the card: uniform in [0, 8)^3; "padded", the
    last quarter repeating earlier points (a short room padded as
    ``transform`` pads it); "lattice", the 1/32 grid (exact d2, many
    ties)."""
    if kind == "lattice":
        return lattice_points(b, n, seed)
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0, 8, (b, n, 3)).astype(np.float32)
    if kind == "padded":
        keep = n - n // 4
        pts[:, keep:] = pts[:, rng.choice(keep, n - keep)]
    return torch.from_numpy(pts).to(DEVICE)


def _pt_pair(b, n, q, seed, kind="uniform"):
    """(points [b, n, 3], queries [b, q, 3]) on the card, the smaller set
    the first points of the larger, as a forward nests its levels: a
    level's sampled points are points of the level above (d2 = 0 for
    each), and a 3-NN's coarse points are points of its queries."""
    base = _pt_points(b, max(n, q), seed, kind)
    return base[:, :n].contiguous(), base[:, :q].contiguous()


def _pt_knn_check(label, n, q, k, calls, b=PT_EVAL_BATCH):
    """knn_exact at one PointTransformer shape against its plain version on
    the card, on uniform, padded and lattice points (``_pt_pair``) and
    with a mask leaving 3/4 of the points: d2 bit-equal and indices equal
    row for row. Returns the shape's record (times of one call)."""
    for kind in ("uniform", "padded", "lattice"):
        pts, qs = _pt_pair(b, n, q, SEED + n + k, kind)
        _exact_equal(f"knn_exact {label} {kind}", ck.knn_exact(pts, qs, k),
                     ck.knn_exact_plain(pts, qs, k), True)
    pts, qs = _pt_pair(b, n, q, SEED + 1, "padded")
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + n)
    mask = torch.rand((b, n), generator=gen, device=DEVICE) < 0.75
    want = ck.knn_exact_plain(pts, qs, k, points_mask=mask)
    _exact_equal(f"knn_exact {label} masked",
                 ck.knn_exact(pts, qs, k, points_mask=mask), want, True)
    # the valid points come first, as many as a sample has (up to k)
    valid = mask.gather(1, want[0].flatten(1).long()).view(b, q, k)
    first = (torch.arange(k, device=mask.device) <
             mask.sum(1).clamp(max=k)[:, None, None])
    if not (valid | ~first).all():
        raise AssertionError(f"knn_exact {label} masked: a masked neighbour "
                             "before a valid one")
    pts, qs = _pt_pair(b, n, q, SEED + 3)
    got = ck.knn_exact(pts, qs, k)
    plain = ck.knn_exact_plain(pts, qs, k)
    err = (got[1] - plain[1]).abs().max().item()
    ms = device_ms(lambda: ck.knn_exact(pts, qs, k))
    plain_ms = span_ms(lambda: ck.knn_exact_plain(pts, qs, k), iters=3,
                       warmup=1)
    cdist_ms = span_ms(lambda: _cdist_topk(pts, qs, k), iters=3, warmup=1)
    bounds = bound(nbytes(pts, qs) + b * q * k * 8, b * n * q * 8)
    plan = ck.exact_plan(b, n, q, sms=ck.sm_count(pts.device.index), k=k)
    say("pointtransformer", f"knn_exact {label} B={b} N={n} Q={q} k={k} "
        f"x{calls} a forward (plan {plan}): uniform, padded, lattice and "
        f"masked d2 bit-equal, indices row for row; device ms {ms:.4f}, "
        f"bound {max(bounds):.4f}; call span ms: plain {plain_ms:.4f}, "
        f"torch.cdist + topk {cdist_ms:.4f} (not the same function)")
    return dict(kernel_record(err, ms, plain_ms, bounds), cdist_ms=cdist_ms)


def _fps_inputs(b, n, m, seed):
    """(kind, points, mask) of the fps inputs at one shape on the card:
    uniform points; "padded", the last quarter repeating earlier points
    (exact ties across a cluster's CTAs); lattice points (many exact
    ties); a mask leaving 3/4; a mask leaving fewer valid points than m;
    and every point masked."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    pts = _pt_points(b, n, seed)
    mask = torch.rand((b, n), generator=gen, device=DEVICE) < 0.75
    few = torch.zeros((b, n), dtype=torch.bool, device=DEVICE)
    for row in range(b):
        few[row, torch.randperm(n, generator=gen, device=DEVICE)[
            :max(1, min(n, m // 3))]] = True
    return (("uniform", pts, None),
            ("padded", _pt_points(b, n, seed + 1, "padded"), None),
            ("lattice", _pt_points(b, n, seed + 2, "lattice"), None),
            ("masked", pts, mask), ("few valid", pts, few),
            ("all masked", pts, torch.zeros_like(mask)))


def _fps_equal(label, n, m, b, kind, pts, mask):
    """fps on one input against its plain version on the card: indices
    equal, no masked point chosen while a valid one is left, index 0 at
    every step where none is valid."""
    got = cfps.fps(pts, m, points_mask=mask)
    if not torch.equal(got, cfps.fps_plain(pts, m, points_mask=mask)):
        raise AssertionError(f"{label} fps B={b} N={n} m={m} {kind}: "
                             "indices differ from the plain version")
    if mask is not None:
        some = mask.any(1)
        chosen = mask.gather(1, got[:, 1:].long()).all(1)
        if not bool((chosen | ~some).all()) or \
                not bool((got[~some] == 0).all()):
            raise AssertionError(f"{label} fps B={b} N={n} m={m} {kind}: a "
                                 "masked point chosen")


def _pt_fps_check(n, m, b=PT_EVAL_BATCH):
    """fps at one shape against its plain version on the card, indices
    equal, on every kind of ``_fps_inputs`` at B = 2 and on the padded,
    few-valid and all-masked ones at B = 1; at 16,384 points each of
    ``PT_FPS_CLUSTERS`` timed too. Returns the shape's record at B = ``b``
    (times of one call; the plain version's is its call span: m - 1 steps
    of several launches)."""
    for bb in (1, 2):
        for kind, pts, mask in _fps_inputs(bb, n, m, SEED + n + m + bb):
            if bb == 2 or kind in ("padded", "few valid", "all masked"):
                _fps_equal("pointtransformer", n, m, bb, kind, pts, mask)
    pts = _pt_points(b, n, SEED + 6)
    ms = device_ms(lambda: cfps.fps(pts, m), iters=10)
    plain_ms = span_ms(lambda: cfps.fps_plain(pts, m), iters=3, warmup=1)
    bounds = bound(nbytes(pts) + b * m * 4, b * (m - 1) * n * 9)
    cluster, threads = cfps.fps_plan(n)
    say("pointtransformer", f"fps B={b} N={n} m={m} (a cluster of "
        f"{cluster} CTAs of {threads} threads a cloud): uniform, padded, "
        f"lattice, masked, few-valid and all-masked indices equal to the "
        f"plain version's at B = 2, the last three at B = 1 too; device ms "
        f"{ms:.4f} ({ms / (m - 1) * 1e3:.3f} us a step), bound "
        f"{max(bounds):.4f}; plain call span {plain_ms:.4f}")
    if n == 16_384:
        times, plan = {}, cfps.fps_plan
        for bb in (1, 2):
            one = _pt_points(bb, n, SEED + 6)
            for c in PT_FPS_CLUSTERS:
                with mock.patch.object(cfps, "fps_plan",
                                       lambda n, c=c: plan(n, c)):
                    times[bb, c] = device_ms(lambda: cfps.fps(one, m),
                                             iters=10)
        say("pointtransformer", f"fps N={n} m={m} by cluster size (CTAs "
            f"a cloud: ms at B=1 / B=2, us a step): " + "; ".join(
                f"{c}: {times[1, c]:.4f} / {times[2, c]:.4f}, "
                f"{times[1, c] / (m - 1) * 1e3:.3f}"
                for c in PT_FPS_CLUSTERS) + f"; the plan takes {cluster}")
    return dict(kernel_record(0.0, ms, plain_ms, bounds), steps=m - 1)


def _pt_forward(net, batch, runs=10, warmup=3):
    """Median synchronised forward (CUDA events), ms, and the times."""
    times = []
    with torch.no_grad():
        for i in range(warmup + runs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            net(batch)
            end.record()
            end.synchronize()
            if i >= warmup:
                times.append(start.elapsed_time(end))
    return statistics.median(times), times


def _pt_eval(card):
    """The eval forward at the bench's 2 x 16,384 on seeded weights: the
    launch counts of one forward, finite logits, the same net on the plain
    versions of both kernels on the card (relative L2 <= ``PT_PLAIN_TOL``),
    sample 0 on the CPU (<= 1e-4), the median forward and peak memory."""
    dev = torch.device(DEVICE)
    model = MODEL.get("PointTransformer")(**POINTTRANSFORMER_S3DIS)
    net = model.get_eval_net()
    state = random_weights(net, SEED).state_dict()
    net = net.eval().to(dev)
    batch_cpu = pt_request(model)
    batch = {k: v.to(dev) for k, v in batch_cpu.items()}
    with torch.no_grad():
        net(batch)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        logits = net(batch)
        torch.cuda.synchronize()
        launches = read_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        with mock.patch.object(ck, "route", lambda t, family: "plain"), \
                mock.patch.object(cfps, "route", lambda t, family: "plain"):
            plain = net(batch)
            torch.cuda.synchronize()
        if read_counts() != launches:
            raise AssertionError("pointtransformer: the plain forward "
                                 "launched a kernel")
    check_counts("pointtransformer", launches, PT_FORWARD_LAUNCHES)
    n, c = model.cfg.num_points, model.cfg.num_classes
    if tuple(logits.shape) != (PT_EVAL_BATCH, n, c):
        raise AssertionError(f"pointtransformer logits {logits.shape}")
    if not torch.isfinite(logits).all():
        raise AssertionError("pointtransformer: non-finite logits")
    plain_rel, plain_agree = _compare(logits, plain.cpu())
    say("pointtransformer", f"eval forward B={PT_EVAL_BATCH} N={n} blocks "
        f"{list(model.cfg.blocks)} float32: logits {tuple(logits.shape)} "
        f"finite; against the same net on the plain versions of knn_exact "
        f"and fps on the card: relative L2 {plain_rel:.3e} (bound "
        f"{PT_PLAIN_TOL:g}), argmax agreement {plain_agree:.6f}; peak "
        f"device memory {peak:.2f} GiB")
    if not plain_rel <= PT_PLAIN_TOL:
        raise AssertionError(f"pointtransformer: kernels vs plain versions "
                             f"{plain_rel} > {PT_PLAIN_TOL}")
    cpu_net = model.get_eval_net()
    cpu_net.load_state_dict(state)
    with torch.no_grad():
        t0 = time.perf_counter()
        ref = cpu_net.eval()({k: v[:1] for k, v in batch_cpu.items()})[0]
        cpu_s = time.perf_counter() - t0
    rel_l2, agree = _compare(logits[0], ref)
    say("pointtransformer", f"sample 0: card vs CPU relative L2 "
        f"{rel_l2:.3e}, argmax agreement {agree:.6f} (CPU forward "
        f"{cpu_s:.1f} s)")
    if not rel_l2 <= 1e-4:
        raise AssertionError(f"pointtransformer card vs CPU {rel_l2} > 1e-4")
    ms, times = _pt_forward(net, batch)
    say("pointtransformer", f"eval forward: median {ms:.3f} ms over "
        f"{len(times)} runs (min {min(times):.3f}, max {max(times):.3f}), "
        f"{PT_EVAL_BATCH * n / ms * 1e3:.0f} points/s, peak {peak:.2f} GiB "
        f"on {card}")
    return launches, ms


def _pt_train(card, root):
    """``run_pipeline.main`` with the port's PointTransformer YAML on S3DIS
    rooms, ``--split train`` for one epoch of ``PT_TRAIN_STEPS`` steps
    and validation steps; each step's launch counts, finite losses, the
    weights moved, the checkpoint; then ``--split test`` must raise."""
    steps, valid_steps = PT_TRAIN_STEPS
    batch, val_batch = PT_TRAIN_BATCH
    t0 = time.perf_counter()
    write_s3dis_rooms(root / "s3dis", PT_ROOM_POINTS)
    written_s = time.perf_counter() - t0
    common = ["-c", REPO / PT_CONFIG, "--device", DEVICE,
              "--dataset.dataset_path", root / "s3dis",
              "--dataset.cache_dir", root / "cache",
              "--main_log_dir", root / "logs"]
    first = {}
    real = SemanticSegmentation._train_step

    def step(self, inputs, loss_fn):
        if not first:
            first.update({k: v.detach().clone()
                          for k, v in self.net.state_dict().items()})
            torch.cuda.reset_peak_memory_stats()
        first["net"] = self.net
        return real(self, inputs, loss_fn)

    with mock.patch.object(SemanticSegmentation, "_train_step", step):
        wall, launches, record, spent = _cli_run(common + [
            "--split", "train", "--pipeline.max_epoch", 0,
            "--dataset.steps_per_epoch_train", steps * batch,
            "--dataset.steps_per_epoch_valid", valid_steps * val_batch],
            ((tpt.PointTransformer, "preprocess"),))
    peak = torch.cuda.max_memory_allocated() / 2**30
    train_s = _check_steps(record, 0, len(record), PT_FORWARD_LAUNCHES,
                           PT_FORWARD_LAUNCHES,
                           ["train"] * steps + ["eval"] * valid_steps)
    check_counts("pointtransformer", launches, {
        k: v * (steps + valid_steps) for k, v in PT_FORWARD_LAUNCHES.items()})
    after = first.pop("net").state_dict()
    moved = [k for k, v in first.items() if k.endswith("weight") and
             v.dim() == 2 and not torch.equal(v, after[k])]
    weights = [k for k, v in first.items() if k.endswith("weight") and
               v.dim() == 2]
    if len(moved) != len(weights):
        raise AssertionError(f"pointtransformer: {len(weights) - len(moved)}"
                             " Linear weights did not move")
    ckpt = (root / "logs" / "PointTransformer_S3DIS_torch" / "checkpoint" /
            "ckpt_00000.pth")
    if not ckpt.exists():
        raise AssertionError(f"pointtransformer: no checkpoint at {ckpt}")
    steady = statistics.median(train_s[1:])
    pre_s = spent["PointTransformer.preprocess"]
    say("pointtransformer", f"S3DIS rooms: {len(PT_ROOMS)} of "
        f"{PT_ROOM_POINTS} points (written in {written_s:.2f} s); "
        f"run_pipeline -c {PT_CONFIG} --split train --pipeline.max_epoch 0: "
        f"{steps} train steps of {batch} x "
        f"{POINTTRANSFORMER_S3DIS['num_points']} (SGD, the YAML's "
        f"augmentations) and {valid_steps} validation "
        f"step(s) of {val_batch}, losses {[round(r[4], 4) for r in record]}, "
        f"finite; all {len(weights)} Linear weights moved; {ckpt.name} "
        f"written; each step launched {PT_FORWARD_LAUNCHES}")
    say("pointtransformer", f"train run: wall {wall:.3f} s; step median "
        f"{steady * 1e3:.2f} ms over steps 2..{steps} (first "
        f"{train_s[0] * 1e3:.2f} ms), {batch / steady:.2f} patches trained/s "
        f"({batch * POINTTRANSFORMER_S3DIS['num_points'] / steady:.0f} "
        f"points/s); peak device memory {peak:.2f} GiB; host preprocess "
        f"{pre_s:.3f} s over {spent['PointTransformer.preprocess calls']} "
        f"rooms, {pre_s / wall:.1%} of the run on {card}")
    reset_counts()
    try:
        run_pipeline.main([str(a) for a in common + ["--split", "test"]])
    except NotImplementedError as err:
        say("pointtransformer", f"--split test refused: {err}")
    else:
        raise AssertionError("pointtransformer: --split test did not raise")
    check_counts("pointtransformer", read_counts(), {})
    return steady


PT_RANGES = ("pt eval forward", "pt train forward", "pt backward",
             "pt sgd")


# kernel families a PointTransformer profile sums, by a part of the name
PT_PROFILED = {"fps": "fps_kernel", "knn": "knn_exact_kernel",
               "bucket_knn": "bucket_knn_kernel",
               "bucket_gather": "bucket_gather_kernel",
               "bucket_gather_bwd": "bucket_gather_bwd"}


def pt_profile(knn_method="exact"):
    """``--pt-profile`` (``--pt-fused-profile``: ``knn_method`` "fused"):
    one torch.profiler pass over one eval forward at 2 x 16,384 and one
    training step at 3 x 16,384 (the forward in train mode, the loss and
    backward, the SGD step) on seeded weights, split by record_function
    ranges; prints one JSON line per range: device ms (kernel rows),
    kernels, wall ms, the device ms of each of ``PT_PROFILED``'s kernel
    families (``fps_ms``, ``knn_ms``, ...), and the top 8 kernels. Run in
    a process of its own: the profiler traces the card once a process."""
    from torch.profiler import ProfilerActivity, profile, record_function
    phase_device()
    dev = torch.device(DEVICE)
    model = MODEL.get("PointTransformer")(**POINTTRANSFORMER_S3DIS,
                                          knn_method=knn_method)
    net = random_weights(model.get_net(), SEED).to(dev)
    x = {k: v.to(dev) for k, v in pt_request(model).items()}
    train_x = {k: v.to(dev) for k, v in pt_request(
        model, PT_TRAIN_BATCH[0], SEED + 1).items()}
    train_x["label"] = torch.randint(
        0, model.cfg.num_classes, train_x["point"].shape[:2], device=dev,
        generator=torch.Generator(device=dev).manual_seed(SEED))
    loss_fn = SemSegLoss(None, model, None)
    optimizer, _ = model.get_optimizer(
        {"optimizer": {"lr": 0.02, "momentum": 0.9}, "max_epoch": 512}, net)

    def step(ranges=False):
        def scope(name):
            return (record_function(name) if ranges else
                    contextlib.nullcontext())
        net.eval()
        with scope("pt eval forward"), torch.no_grad():
            net(x)
            torch.cuda.synchronize()
        net.train()
        with scope("pt train forward"):
            loss, _, _ = model.get_loss(loss_fn, net(train_x), train_x)
            torch.cuda.synchronize()
        with scope("pt backward"):
            optimizer.zero_grad(set_to_none=True)
            loss.backward()
            torch.cuda.synchronize()
        with scope("pt sgd"):
            optimizer.step()
            torch.cuda.synchronize()

    for _ in range(2):
        step()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(ranges=True)
    events = prof.events()
    for name in PT_RANGES:
        rng = next(e for e in events if e.name == name and
                   e.device_type == torch.autograd.DeviceType.CPU)
        start, end = rng.time_range.start, rng.time_range.end
        kernels = collections.Counter()
        calls = collections.Counter()
        for e in events:
            if (e.device_type == torch.autograd.DeviceType.CUDA and
                    not e.name.startswith("pt ") and
                    start <= e.time_range.start <= end):
                kernels[e.name] += e.time_range.elapsed_us() / 1e3
                calls[e.name] += 1
        top = [[k[:64], ms, calls[k]] for k, ms in kernels.most_common(8)]
        print(json.dumps({
            "range": name, "device_ms": sum(kernels.values()),
            "kernels": sum(calls.values()), "wall_ms": (end - start) / 1e3,
            **{f"{family}_ms": sum(ms for k, ms in kernels.items()
                                   if part in k)
               for family, part in PT_PROFILED.items()},
            "top": top}), flush=True)


def _pt_profiles(card, knn_method="exact"):
    """``pt_profile`` in a child process; prints each range's line."""
    flag = "--pt-profile" if knn_method == "exact" else "--pt-fused-profile"
    phase = "pointtransformer" if knn_method == "exact" else "pt_fused"
    run = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                          flag], cwd=REPO, capture_output=True, text=True,
                         timeout=600)
    if run.returncode != 0:
        raise AssertionError(f"{phase}: the profiler run failed:\n"
                             f"{run.stderr[-4000:]}")
    records = [json.loads(line) for line in run.stdout.splitlines()
               if line.startswith('{"range"')]
    if len(records) != len(PT_RANGES) or any(r["device_ms"] <= 0
                                            for r in records):
        raise AssertionError(f"{phase}: the profiler saw no device time: "
                             f"{run.stdout[-2000:]}")
    families = (("fps", "knn") if knn_method == "exact" else
                ("bucket_knn", "bucket_gather", "bucket_gather_bwd"))
    for r in records:
        busy = r["device_ms"] / r["wall_ms"]
        say(phase, f"profiled {r['range']}: device "
            f"{r['device_ms']:.3f} ms over {r['kernels']} kernels in a "
            f"{r['wall_ms']:.3f} ms span (busy {busy:.1%}); " + ", ".join(
                f"{'knn_exact' if f == 'knn' else f} {r[f + '_ms']:.3f} ms"
                for f in families) + "; top: " + ", ".join(
                f"{k} {ms:.3f} ms x{n}" for k, ms, n in r["top"]) +
            f" (on {card})")


def phase_pointtransformer(card):
    """PointTransformer at the shipped S3DIS config: knn_exact at every
    search shape of a forward (k = 8, 16 and 3) and fps at the four
    levels against their plain versions on the card, the eval forward at
    2 x 16,384 (``_pt_eval``), and ``run_train`` from the YAML through the
    command line (``_pt_train``). Returns (the forward's launch counts,
    knn_exact's record for one forward's 26 calls, fps's for its 4)."""
    t_phase = time.perf_counter()
    cfg = MODEL.get("PointTransformer")(**POINTTRANSFORMER_S3DIS).cfg
    knn = []
    for label, n, q, k, calls in pt_searches(cfg):
        rec = _pt_knn_check(label, n, q, k, calls)
        knn += [rec] * calls
    fps = []
    n = cfg.num_points
    for s in tpt.STRIDE[1:]:
        fps.append(_pt_fps_check(n, n // s))
        n //= s
    extra = [_pt_fps_check(n, m) for n, m in PT_FPS_EXTRA]
    say("pointtransformer", "fps beyond the forward's levels: equal; " +
        ", ".join(f"N={n} m={m} {r['ms']:.4f} ms" for (n, m), r in
                  zip(PT_FPS_EXTRA, extra)))
    knn_rec, fps_rec = combine(knn), combine(fps)
    steps = sum(r["steps"] for r in fps)
    floor = steps * fps[-1]["ms"] / fps[-1]["steps"]
    say("pointtransformer", f"one forward's {len(knn)} knn_exact launches: "
        f"device ms {knn_rec['ms']:.4f}, bound {knn_rec['bound_ms']:.4f}, "
        f"plain span {knn_rec['plain_ms']:.4f}, torch.cdist + topk "
        f"{sum(r['cdist_ms'] for r in knn):.4f}; its {len(fps)} fps "
        f"launches: "
        f"{fps_rec['ms']:.4f}, bound {fps_rec['bound_ms']:.4f}, serial "
        f"floor {floor:.4f} ({steps} dependent steps at the 256-point "
        f"level's {fps[-1]['ms'] / fps[-1]['steps'] * 1e3:.3f} us), plain "
        f"span {fps_rec['plain_ms']:.4f}")
    launches, fwd_ms = _pt_eval(card)
    say("pointtransformer", f"the kernels' share of the {fwd_ms:.3f} ms "
        f"forward: knn_exact {knn_rec['ms'] / fwd_ms:.1%}, fps "
        f"{fps_rec['ms'] / fwd_ms:.1%} (their device times one by one)")
    with tempfile.TemporaryDirectory() as tmp:
        _pt_train(card, Path(tmp))
    _pt_profiles(card)
    say("pointtransformer", f"phase {time.perf_counter() - t_phase:.1f} s")
    return launches, knn_rec, fps_rec


# ------------------------------------------------- PointTransformer, fused

def pt_fused_model(**overrides):
    """PointTransformer at the shipped S3DIS config on the fused path."""
    return MODEL.get("PointTransformer")(
        **dict(POINTTRANSFORMER_S3DIS, knn_method="fused", **overrides))


def _pt_fused_pyramid(model, points):
    cfg = model.cfg
    return tb.build_pt_pyramid(points, tpt.NSAMPLE, tpt.STRIDE[1:],
                               seg=cfg.seg, qblock=cfg.block,
                               num_segs=cfg.num_segs,
                               gather_segs=cfg.gather_segs, up_k=tpt.UP_K)


def _pt_fused_calls(model, points):
    """(the fused pyramid of ``points``, its bucket_knn calls as (label,
    args, kwargs)), the calls' shapes checked against
    ``pt_fused_searches``."""
    out = {}
    calls = _captured(tb, "knn_bucket", lambda: out.update(
        pyr=_pt_fused_pyramid(model, points)))
    want = pt_fused_searches(model.cfg, points.shape[1])
    got = [(a[0].shape[1], a[1].shape[1], a[3], a[2].shape[-1],
            kw["qblock"]) for a, kw in calls]
    if got != [shape for _, shape in want]:
        raise AssertionError(f"pt_fused: the pyramid's searches {got}, "
                             f"expected {want}")
    return out["pyr"], [(label, a, kw) for (label, _), (a, kw) in
                        zip(want, calls)]


def _pt_fused_reads(model, pyr):
    """(label, table, level, value rows, channels, reads a forward) of each
    gather shape of a fused forward: level i's attention (3 + 2 * planes,
    one a Bottleneck), its grouping onto level i + 1 (3 + planes[i]) and
    the upsample from level i + 1 (3 + planes[i])."""
    rows = [c.shape[1] for c in pyr["coords"]]
    out = []
    for i, planes in enumerate(tpt.PLANES):
        out.append((f"L{i} attention", "nbr", i, rows[i], 3 + 2 * planes,
                    model.cfg.blocks[i]))
    for i, planes in enumerate(tpt.PLANES[:4]):
        out.append((f"L{i} grouping", "pool", i, rows[i], 3 + planes, 1))
        out.append((f"L{i} upsample", "up", i, rows[i + 1], 3 + planes, 1))
    return out


def _pt_fused_kernels(model):
    """The kernels at a fused forward's shapes, 2 x 16,384 points (the
    bench's request), against their plain versions on the card:
    ``bucket_knn`` at each of the pyramid's 13 searches (k 8, 16 and 3,
    tables of up to 64 segments of 64) on lattice points (rel row for
    row) and uniform ones (``_knn_check``: d2 bit-equal, rel off ties,
    times, issue floor, the unsplit search beside a split one);
    ``bucket_gather`` and ``bucket_gather_bwd`` at each of the 13 read
    shapes (``_pt_fused_reads``; dyadic cotangents bit-equal), with
    ``torch.gather`` and ``scatter_add_`` beside them. Returns the records
    of one forward's 13 searches, of its 26 reads (each shape as often as
    a forward reads it), and the (label, record) pairs of each read shape
    and of each backward shape."""
    dev = torch.device(DEVICE)
    cfg = model.cfg
    gen = torch.Generator(device=dev).manual_seed(SEED)
    b, n = PT_EVAL_BATCH, cfg.num_points
    _, lattice = _pt_fused_calls(model, lattice_points(b, n, SEED))
    for label, args, kwargs in lattice:
        _knn_check(f"PT {label}", *args, **kwargs, lattice=True)
    say("pt_fused", f"bucket_knn, lattice points: the fused pyramid's "
        f"{len(lattice)} searches bit-equal, rel row for row")
    pyr, calls = _pt_fused_calls(model, pt_request(model)["point"].to(dev))
    knn = [_knn_check(f"PT {label}", *args, **kwargs)
           for label, args, kwargs in calls]
    reads, gathers, bwds = [], [], []
    for label, name, i, rows, c, count in _pt_fused_reads(model, pyr):
        tables = (pyr[f"{name}_seg_ids"][i], pyr[f"{name}_rel"][i],
                  cfg.seg, pyr[f"{name}_qblock"][i])
        values = tb.pad_seg(torch.randn((b, rows, c), generator=gen,
                                        device=dev), cfg.seg)
        rec = _gather_check(f"PT {label}", values, *tables)
        gathers.append((f"PointTransformer {label}", rec))
        reads += [rec] * count
        bwds.append((f"PointTransformer {label}", _gather_bwd_check(
            f"PT {label}", tables[0], tables[1], values.shape[1], c,
            cfg.seg, tables[3], gen)))
    search, read, bwd = combine(knn), combine(reads), combine(
        [r for _, r in bwds])
    say("pt_fused", f"one forward's {len(knn)} bucket_knn launches: device "
        f"ms {search['ms']:.4f}, plain {search['plain_ms']:.4f}, bound "
        f"{search['bound_ms']:.4f}; by search " + ", ".join(
            f"{label} {r['ms']:.4f}" for (label, _, _), r in zip(calls, knn)))
    say("pt_fused", f"one forward's {len(reads)} bucket_gather launches: "
        f"device ms {read['ms']:.4f}, plain {read['plain_ms']:.4f}, "
        f"torch.gather {read['library_ms']:.4f}, bound "
        f"{read['bound_ms']:.4f}")
    say("pt_fused", f"bucket_gather_bwd at the {len(bwds)} read shapes: "
        f"device ms {bwd['ms']:.4f}, plain {bwd['plain_ms']:.4f}, "
        f"scatter_add_ {bwd['library_ms']:.4f}, bound {bwd['bound_ms']:.4f};"
        f" by shape " + ", ".join(f"{label} {r['ms']:.4f}"
                                  for label, r in bwds))
    return search, read, gathers, bwds


def _pt_fused_forward(model, card):
    """The bench's request (2 x 16,384) through the fused ``get_net()`` in
    bf16 on seeded weights: one forward's launch counts (13 bucket_knn,
    26 bucket_gather, no fps, no knn_exact), finite logits; the same
    weights at compute_dtype float32, sample 0 on the card against the
    CPU (relative L2 <= ``PT_FUSED_TOL``), the bf16 logits against the
    float32 ones (reported); the median forward and peak memory. Returns
    (the launch counts, the median ms)."""
    dev = torch.device(DEVICE)
    net = random_weights(model.get_net(), SEED)
    state = {k: v.clone() for k, v in net.state_dict().items()}
    net = net.eval().to(dev)
    batch_cpu = pt_request(model)
    batch = {k: v.to(dev) for k, v in batch_cpu.items()}
    with torch.no_grad():
        net(batch)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        logits = net(batch)
        torch.cuda.synchronize()
        launches = read_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
    check_counts("pt_fused", launches, PT_FUSED_FORWARD_LAUNCHES)
    n, c = model.cfg.num_points, model.cfg.num_classes
    if tuple(logits.shape) != (PT_EVAL_BATCH, n, c):
        raise AssertionError(f"pt_fused logits {logits.shape}")
    if not torch.isfinite(logits).all():
        raise AssertionError("pt_fused: non-finite logits")
    f32 = pt_fused_model(compute_dtype="float32")
    net32, cpu32 = f32.get_net(), f32.get_net()
    for m in (net32, cpu32):
        m.load_state_dict(state)
        m.eval()
    net32.to(dev)
    with torch.no_grad():
        logits32 = net32(batch)
        t0 = time.perf_counter()
        ref = cpu32({k: v[:1] for k, v in batch_cpu.items()})[0]
        cpu_s = time.perf_counter() - t0
    rel_l2, agree = _compare(logits32[0], ref)
    bf_rel, bf_agree = _compare(logits, logits32.cpu())
    say("pt_fused", f"fused forward B={PT_EVAL_BATCH} N={n} blocks "
        f"{list(model.cfg.blocks)} seg {model.cfg.seg} block "
        f"{model.cfg.block} S{model.cfg.num_segs}/G{model.cfg.gather_segs} "
        f"bf16: logits {tuple(logits.shape)} finite; float32 sample 0 card "
        f"vs CPU relative L2 {rel_l2:.3e} (bound {PT_FUSED_TOL:g}), argmax "
        f"agreement {agree:.6f} (CPU forward {cpu_s:.1f} s); bf16 vs float32"
        f" on the card: relative L2 {bf_rel:.3e}, argmax agreement "
        f"{bf_agree:.6f}")
    if not rel_l2 <= PT_FUSED_TOL:
        raise AssertionError(f"pt_fused card vs CPU {rel_l2} > "
                             f"{PT_FUSED_TOL}")
    ms, times = _pt_forward(net, batch)
    ms32, _ = _pt_forward(net32, batch)
    say("pt_fused", f"fused forward bf16: median {ms:.3f} ms over "
        f"{len(times)} runs (min {min(times):.3f}, max {max(times):.3f}), "
        f"{PT_EVAL_BATCH * n / ms * 1e3:.0f} points/s, peak {peak:.2f} GiB; "
        f"float32 median {ms32:.3f} ms, on {card}")
    return launches, ms


def _pt_fused_step_vs_cpu():
    """One float32 fused training step, 1 x 16,384 points of the bench's
    request with seeded labels, on the card and on the CPU from the same
    seeded weights, the CPU on the card's branches (``_SameBranches``
    with "pt": the pyramid's integers, the ReLUs' signs, the grouping
    maxima's winners). Returns (loss relative difference, gradient and
    running statistics relative L2, the choices the CPU would have made
    otherwise, CPU seconds)."""
    model = pt_fused_model(compute_dtype="float32")
    state = random_weights(model.get_net(), SEED + 2).state_dict()
    x = pt_request(model, 1, SEED + 3)
    x["label"] = torch.randint(0, model.cfg.num_classes,
                               x["point"].shape[:2],
                               generator=torch.Generator().manual_seed(SEED))
    loss_fn = SemSegLoss(None, model, None)
    out = {}
    with _SameBranches(net="pt") as branches:
        for device in (DEVICE, "cpu"):
            net = model.get_net()
            net.load_state_dict(state)
            net.train().to(device)
            inputs = {k: v.to(device) for k, v in x.items()}
            t0 = time.perf_counter()
            loss, _, _ = model.get_loss(loss_fn, net(inputs), inputs)
            loss.backward()
            if device == DEVICE:
                torch.cuda.synchronize()
            out[device] = {
                "loss": loss.double().cpu(),
                "grad": torch.cat([p.grad.reshape(-1).cpu()
                                   for p in net.parameters()]),
                "stats": torch.cat([b.reshape(-1).cpu() for k, b in
                                    net.state_dict().items()
                                    if k.endswith(("running_mean",
                                                   "running_var"))]),
                "seconds": time.perf_counter() - t0}
            if device == DEVICE:
                branches.replay()
        if branches.recorded:
            raise AssertionError("pt_fused: the CPU step took fewer branches "
                                 "than the card's")
    gpu, cpu = out[DEVICE], out["cpu"]
    return ((abs(gpu["loss"] - cpu["loss"]) / abs(cpu["loss"])).item(),
            _rel_l2(gpu["grad"], cpu["grad"]),
            _rel_l2(gpu["stats"], cpu["stats"]), branches.differ,
            branches.total, cpu["seconds"])


def _pt_fused_train(card, root):
    """``run_pipeline.main -c pointtransformer_s3dis.yml --split train
    --model.knn_method fused`` on S3DIS rooms (``PT_TRAIN_STEPS`` train
    steps of 3 x 16,384 and a validation step, which runs the training
    net in eval mode, as the JAX pipeline does): each step's launches
    (``PT_FUSED_STEP_LAUNCHES``, ``PT_FUSED_FORWARD_LAUNCHES``), finite
    losses, every Linear weight moved, the checkpoint; the step median,
    patches trained/s, peak memory and the host's share; then one float32
    step against the CPU (``_pt_fused_step_vs_cpu``). Returns the run's
    launch counts."""
    steps, valid_steps = PT_TRAIN_STEPS
    batch, val_batch = PT_TRAIN_BATCH
    write_s3dis_rooms(root / "s3dis", PT_ROOM_POINTS)
    common = ["-c", REPO / PT_CONFIG, "--device", DEVICE,
              "--dataset.dataset_path", root / "s3dis",
              "--dataset.cache_dir", root / "cache",
              "--main_log_dir", root / "logs",
              "--pipeline.train_sum_dir", root / "train_log",
              "--model.knn_method", "fused"]
    first = {}
    real = SemanticSegmentation._train_step

    def step(self, inputs, loss_fn):
        if not first:
            first.update({k: v.detach().clone()
                          for k, v in self.net.state_dict().items()})
            torch.cuda.reset_peak_memory_stats()
        first["net"] = self.net
        return real(self, inputs, loss_fn)

    with mock.patch.object(SemanticSegmentation, "_train_step", step):
        wall, launches, record, spent = _cli_run(common + [
            "--split", "train", "--pipeline.max_epoch", 0,
            "--dataset.steps_per_epoch_train", steps * batch,
            "--dataset.steps_per_epoch_valid", valid_steps * val_batch],
            ((tpt.PointTransformer, "preprocess"),))
    peak = torch.cuda.max_memory_allocated() / 2**30
    net = first.pop("net")
    if net.knn_method != "fused":
        raise AssertionError(f"pt_fused: trained the {net.knn_method} net")
    train_s = _check_steps(record, 0, len(record), PT_FUSED_STEP_LAUNCHES,
                           PT_FUSED_FORWARD_LAUNCHES,
                           ["train"] * steps + ["eval"] * valid_steps)
    check_counts("pt_fused", launches, {
        k: v * steps + PT_FUSED_FORWARD_LAUNCHES.get(k, 0) * valid_steps
        for k, v in PT_FUSED_STEP_LAUNCHES.items()})
    after = net.state_dict()
    weights = [k for k, v in first.items() if k.endswith("weight") and
               v.dim() == 2]
    moved = [k for k in weights if not torch.equal(first[k], after[k])]
    if len(moved) != len(weights):
        raise AssertionError(f"pt_fused: {len(weights) - len(moved)} Linear "
                             "weights did not move")
    ckpt = (root / "logs" / "PointTransformer_S3DIS_torch" / "checkpoint" /
            "ckpt_00000.pth")
    if not ckpt.exists():
        raise AssertionError(f"pt_fused: no checkpoint at {ckpt}")
    steady = statistics.median(train_s[1:])
    in_steps = sum(t1 - t0 for _, t0, t1, _, _ in record)
    pre_s = spent["PointTransformer.preprocess"]
    n = POINTTRANSFORMER_S3DIS["num_points"]
    say("pt_fused", f"run_pipeline -c {PT_CONFIG} --split train "
        f"--model.knn_method fused: {steps} train steps of {batch} x {n} "
        f"(bf16, SGD, the YAML's augmentations) and {valid_steps} "
        f"validation step(s) of {val_batch}, losses "
        f"{[round(r[4], 4) for r in record]}, finite; all {len(weights)} "
        f"Linear weights moved; {ckpt.name} written; each train step "
        f"launched {PT_FUSED_STEP_LAUNCHES}, each validation step "
        f"{PT_FUSED_FORWARD_LAUNCHES}")
    say("pt_fused", f"train run: wall {wall:.3f} s; step median "
        f"{steady * 1e3:.2f} ms over steps 2..{steps} (first "
        f"{train_s[0] * 1e3:.2f} ms), {batch / steady:.2f} patches trained/s "
        f"({batch * n / steady:.0f} points/s); peak device memory "
        f"{peak:.2f} GiB; host share {1 - in_steps / wall:.1%} of the run "
        f"outside the steps (preprocess {pre_s:.3f} s over "
        f"{spent['PointTransformer.preprocess calls']} rooms) on {card}")
    loss_d, grad_d, stats_d, differ, total, cpu_s = _pt_fused_step_vs_cpu()
    say("pt_fused", f"float32 step 1 x {n}, card vs CPU on the card's "
        f"branches ({differ} of {total} choices the CPU would have made "
        f"otherwise): loss {loss_d:.3e} (bound {PT_FUSED_LOSS_TOL:g}), "
        f"gradients relative L2 {grad_d:.3e}, running statistics "
        f"{stats_d:.3e} (bound {PT_FUSED_TOL:g}); CPU step {cpu_s:.1f} s")
    if not (loss_d <= PT_FUSED_LOSS_TOL and grad_d <= PT_FUSED_TOL and
            stats_d <= PT_FUSED_TOL):
        raise AssertionError("pt_fused: the float32 step card vs CPU is out "
                             "of bounds")
    return launches


def phase_pt_fused(card):
    """PointTransformer's fused path at the shipped S3DIS config: the
    kernels at a forward's shapes (``_pt_fused_kernels``), the fused
    forward (``_pt_fused_forward``), training through the command line
    (``_pt_fused_train``) and one profiled forward and step in a child
    process (``--pt-fused-profile``). Returns (the forward's and the
    training run's launch counts summed, bucket_knn's record for one
    forward's 13 searches, the (label, record) pairs of the 13 read shapes
    of bucket_gather and of bucket_gather_bwd)."""
    t_phase = time.perf_counter()
    model = pt_fused_model()
    knn, reads, gathers, bwds = _pt_fused_kernels(model)
    launches, fwd_ms = _pt_fused_forward(model, card)
    say("pt_fused", f"the kernels' share of the {fwd_ms:.3f} ms forward: "
        f"bucket_knn {knn['ms'] / fwd_ms:.1%}, bucket_gather "
        f"{reads['ms'] / fwd_ms:.1%} (their device times one by one)")
    with tempfile.TemporaryDirectory() as tmp:
        trained = _pt_fused_train(card, Path(tmp))
    _pt_profiles(card, "fused")
    say("pt_fused", f"phase {time.perf_counter() - t_phase:.1f} s")
    return ({k: launches[k] + trained[k] for k in launches}, knn, gathers,
            bwds)


# ------------------------------------------------------------------ KPConv

def kp_model(name, **overrides):
    """The port's KPFCNN from the model section of its ``name`` YAML
    (``KP_CONFIGS``), seeded, and the YAML's config."""
    from open3d_ml_tpu_torch.utils import Config
    cfg = Config.load_from_file(REPO / KP_CONFIGS[name])
    kwargs = dict(cfg.model.to_dict(), seed=SEED, **overrides)
    kwargs.pop("name")
    return MODEL.get("KPFCNN")(**kwargs), cfg


def kp_cloud(n, seed=SEED, r_max=50.0):
    """The bench's lidar cloud (``bench.py:421-427`` ``_lidar_cloud``): the
    radius log-distributed in 2-``r_max`` m, height uniform in -2-1 m."""
    rng = np.random.default_rng(seed)
    r = 2.0 * (r_max / 2.0) ** rng.uniform(0, 1, n)
    th = rng.uniform(0, 2 * np.pi, n)
    return np.stack([r * np.cos(th), r * np.sin(th),
                     rng.uniform(-2, 1, n)], 1).astype(np.float32)


def kp_request(model, split="test", draws=3):
    """The bench's request: a 120,000-point cloud, the split's
    ``preprocess``, the random point sampler and one patch at B = 1
    (``child_kpconv``). Returns (the collated batch, the median host
    ``transform`` ms over ``draws`` draws)."""
    data = {"point": kp_cloud(SCAN_POINTS), "feat": None,
            "label": np.zeros(SCAN_POINTS, np.int32)}
    attr = {"split": split}
    pre = model.preprocess(data, attr)
    model.trans_point_sampler = SAMPLER.get(
        "SemSegRandomSampler").get_point_sampler()
    times, samples = [], []
    for _ in range(draws):
        t0 = time.perf_counter()
        samples.append(model.transform(pre, attr))
        times.append((time.perf_counter() - t0) * 1e3)
    batch = DefaultBatcher().collate_fn([{"data": samples[0]}])["data"]
    return batch, statistics.median(times)


def kp_tensors(batch, device):
    return {k: ([torch.from_numpy(x).to(device) for x in v]
                if isinstance(v, list) else torch.from_numpy(v).to(device))
            for k, v in batch.items() if k != "point_inds"}


def kp_caps_line(batch):
    """Each level's valid rows and the share of them whose radius search
    reached the level's neighbour limit (no sentinel in the row)."""
    parts = []
    for lvl, nb in enumerate(batch["neighbors"]):
        cap = batch["points"][lvl].shape[1]
        valid = batch["points"][lvl][0, :, 0] < 1e5
        at_limit = (nb[0][valid] != cap).all(-1).mean()
        parts.append(f"level {lvl}: {int(valid.sum())} of {cap} rows, "
                     f"limit {nb.shape[-1]} reached by {at_limit:.1%}")
    return "; ".join(parts)


def _kp_setup_line(spent):
    """Where a command-line run's set-up went (``KP_TIMED``)."""
    return ", ".join(f"{key} {spent[key]:.2f} s x{spent[key + ' calls']}"
                     for key in ("SemanticSegmentation.__init__",
                                 "PointCloudDataloader.__init__",
                                 "KPFCNN.preprocess",
                                 "SemanticSegmentation.save_ckpt",
                                 "SemanticSegmentation.load_ckpt"))


def _kp_eval(card):
    """(a) The eval forward on the bench's request at B = 1 in float32:
    card vs CPU, the median of 10, peak memory, the host transform."""
    model, _ = kp_model("semantickitti")
    batch, transform_ms = kp_request(model)
    net = random_weights(model.get_net(), SEED).eval()
    cpu_x = kp_tensors(batch, "cpu")
    with torch.no_grad():
        cpu_out = net(cpu_x)
    net = net.to(DEVICE)
    x = kp_tensors(batch, DEVICE)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with torch.no_grad():
        out = net(x)
    torch.cuda.synchronize()
    check_counts("kpconv", read_counts(), {})
    peak = torch.cuda.max_memory_allocated() / 2**30
    rel, agree = _compare(out, cpu_out)
    n = model.cfg.num_points
    if out.shape != (1, n, model.cfg.num_classes) or \
            not torch.isfinite(out).all():
        raise AssertionError(f"kpconv: logits of shape {tuple(out.shape)}, "
                             f"finite {bool(torch.isfinite(out).all())}")
    if rel > KP_TOL:
        raise AssertionError(f"kpconv: eval forward card vs CPU relative L2 "
                             f"{rel:.3e} > {KP_TOL}")
    med, _ = median_forward_s(net, x)
    say("kpconv", f"bench request ({SCAN_POINTS} lidar points, the test "
        f"split's preprocess, 1 x {n}-point patch of the random sampler): "
        + kp_caps_line(batch))
    say("kpconv", f"eval forward 1 x {n} (kpconv_semantickitti.yml, "
        f"seeded random weights, float32): card vs CPU relative L2 "
        f"{rel:.3e} (<= {KP_TOL}), argmax agreement {agree:.4%}; median "
        f"of 10 {med * 1e3:.3f} ms ({n / med:.0f} points/s); host transform "
        f"median {transform_ms:.1f} ms a patch; peak device memory "
        f"{peak:.3f} GiB on {card}")
    return {"forward_ms": med * 1e3, "transform_ms": transform_ms,
            "forward_rel_l2": rel, "peak_gib": peak}


def _kp_step(card):
    """(b) One float32 training step at B = 1 on a training patch of the
    bench's cloud (augmented), card vs CPU from the same seeded weights,
    the CPU on the card's LeakyReLU and max-pool branches."""
    model, cfg = kp_model("semantickitti")
    batch, _ = kp_request(model, split="train", draws=1)
    batch["labels"] = np.random.default_rng(SEED).integers(
        0, model.cfg.num_classes + 1, batch["labels"].shape).astype(np.int32)

    class Dataset:
        pass

    Dataset.cfg = cfg.dataset
    state = random_weights(model.get_net(), SEED).state_dict()
    out = {}
    with _SameBranches(net="kpconv") as branches:
        for card_run, device in ((True, DEVICE), (False, "cpu")):
            net = model.get_net()
            net.load_state_dict(state)
            net = net.to(device).train()
            x = kp_tensors(batch, device)
            reset_counts()
            t0 = time.perf_counter()
            logits = net(x)
            loss, _, _ = model.get_loss(SemSegLoss(None, model, Dataset),
                                        logits, x)
            loss = loss + model.regularizer_loss(net)
            loss.backward()
            if card_run:
                torch.cuda.synchronize()
                check_counts("kpconv", read_counts(), {})
                branches.replay()
            out[card_run] = {
                "seconds": time.perf_counter() - t0,
                "loss": loss.detach().double().cpu(),
                "grads": {k: p.grad.cpu() for k, p in
                          net.named_parameters()},
                "stats": torch.cat([b.reshape(-1).cpu() for k, b in
                                    net.state_dict().items()
                                    if k.endswith(("running_mean",
                                                   "running_var"))])}
        if branches.recorded:
            raise AssertionError("kpconv: the CPU step took fewer branches "
                                 "than the card's")
    gpu, cpu = out[True], out[False]
    loss_rel = (abs(gpu["loss"] - cpu["loss"]) / abs(cpu["loss"])).item()
    grad_rel = _rel_l2(torch.cat([g.reshape(-1) for g in
                                  gpu["grads"].values()]),
                       torch.cat([g.reshape(-1) for g in
                                  cpu["grads"].values()]))
    worst = max(((k, _rel_l2(gpu["grads"][k], g))
                 for k, g in cpu["grads"].items() if g.norm() > 0),
                key=lambda kv: kv[1])
    stats_rel = _rel_l2(gpu["stats"], cpu["stats"])
    say("kpconv", f"one float32 training step 1 x {model.cfg.num_points} "
        f"(augmented patch, seeded weights, random labels): loss "
        f"{cpu['loss'].item():.5f}, card vs CPU loss relative difference "
        f"{loss_rel:.3e} (<= {KP_LOSS_TOL}), gradient relative L2 "
        f"{grad_rel:.3e} (<= {KP_TOL}; worst tensor {worst[0]} "
        f"{worst[1]:.3e}), BN statistics {stats_rel:.3e}; the CPU on the "
        f"card's branches ({branches.differ} of {branches.total} choices "
        f"its own values would have made otherwise); card step "
        f"{gpu['seconds'] * 1e3:.1f} ms (first), CPU {cpu['seconds']:.2f} s "
        f"on {card}")
    if loss_rel > KP_LOSS_TOL or grad_rel > KP_TOL or stats_rel > KP_TOL:
        raise AssertionError(f"kpconv: training step card vs CPU: loss "
                             f"{loss_rel:.3e}, gradients {grad_rel:.3e}, "
                             f"statistics {stats_rel:.3e}")
    return {"step_loss_rel": loss_rel, "step_grad_rel_l2": grad_rel,
            "step_stats_rel_l2": stats_rel}


def _kp_train_cli(card, root):
    """(c) ``run_train`` through the command line on
    ``kpconv_semantickitti.yml`` over SemanticKITTI scans of
    ``write_semantickitti``: 4 train steps and 1 validation step."""
    write_semantickitti(root / "kitti", SCAN_POINTS, scans=KP_TRAIN_SCANS)
    argv = ["-c", REPO / KP_CONFIGS["semantickitti"], "--device", DEVICE,
            "--dataset.dataset_path", root / "kitti",
            "--dataset.cache_dir", root / "cache",
            "--main_log_dir", root / "logs", "--split", "train",
            "--pipeline.max_epoch", 0]
    torch.cuda.reset_peak_memory_stats()
    wall, launches, record, spent = _cli_run(argv, KP_TIMED)
    peak = torch.cuda.max_memory_allocated() / 2**30
    steps = KP_TRAIN_SCANS["00"]
    train_s = _check_steps(record, 0, len(record), {}, {},
                           ["train"] * steps + ["eval"])
    check_counts("kpconv", launches, {})
    ckpt = (root / "logs" / "KPFCNN_SemanticKITTI_torch" / "checkpoint" /
            "ckpt_00000.pth")
    if not ckpt.exists():
        raise AssertionError(f"kpconv: no checkpoint at {ckpt}")
    steady = statistics.median(train_s[1:])
    step_s = sum(r[2] - r[1] for r in record)
    host = spent["KPFCNN.transform"] + spent["KPFCNN.preprocess"]
    say("kpconv", f"run_pipeline -c {KP_CONFIGS['semantickitti']} --split "
        f"train --pipeline.max_epoch 0 over {steps} + 1 SemanticKITTI scans "
        f"of {SCAN_POINTS} points: {steps} train steps of 1 x 16384 and 1 "
        f"validation step, losses {[round(r[4], 4) for r in record]}, "
        f"{ckpt.name} written; wall {wall:.2f} s, step median "
        f"{steady * 1e3:.1f} ms over steps 2..{steps} (first "
        f"{train_s[0] * 1e3:.1f} ms), the steps {step_s / wall:.1%} of the "
        f"run; host preprocess + transform {host:.2f} s "
        f"({spent['KPFCNN.transform calls']} patches, "
        f"{host / wall:.1%} of the run, in the loader's thread); peak device "
        f"memory {peak:.3f} GiB on {card}")
    say("kpconv", "train run's set-up: " + _kp_setup_line(spent))
    return {"train_step_ms": steady * 1e3, "train_wall_s": wall,
            "train_host_share": host / wall, "train_peak_gib": peak}


def _kp_test_cli(card, root):
    """(d) ``run_test`` through the command line on ``kpconv_s3dis.yml``
    over one S3DIS room of the test area (1.5 m balls until the room is
    covered, the features [1, r, g, b]), then ``run_inference`` on it."""
    write_s3dis_rooms(root / "s3dis", PT_ROOM_POINTS, rooms=(KP_TEST_ROOM,))
    with open(root / "s3dis" / "original_pkl" / f"{KP_TEST_ROOM}.pkl",
              "rb") as f:
        pc = pickle.load(f)[0]
    argv = ["-c", REPO / KP_CONFIGS["s3dis"], "--device", DEVICE,
            "--dataset.dataset_path", root / "s3dis",
            "--dataset.cache_dir", root / "cache",
            "--dataset.test_result_folder", root / "test",
            "--main_log_dir", root / "logs"]
    widths = []
    real_forward = tkp.KPFCNNNet.forward

    def forward(self, batch):
        widths.append(batch["features"].shape[-1])
        return real_forward(self, batch)

    with mock.patch.object(tkp.KPFCNNNet, "forward", forward):
        wall, launches, _, spent = _cli_run(argv + ["--split", "test"],
                                            KP_TIMED)
    check_counts("kpconv", launches, {})
    pred = np.load(root / "test" / "S3DIS" / f"{KP_TEST_ROOM}.npy")
    if pred.shape != (len(pc),) or pred.min() < 0 or pred.max() >= 13:
        raise AssertionError(f"kpconv: run_test labelled {pred.shape} points "
                             f"in [{pred.min()}, {pred.max()}] of "
                             f"{len(pc)}")
    if set(widths) != {4}:
        raise AssertionError(f"kpconv: S3DIS features of widths {widths}")
    host = spent["KPFCNN.transform"] + spent["KPFCNN.preprocess"]
    say("kpconv", f"run_pipeline -c {KP_CONFIGS['s3dis']} --split test on "
        f"{KP_TEST_ROOM} ({len(pc)} points): the loop ended after "
        f"{len(widths)} patches (1.5 m balls, features [1, r, g, b]), every "
        f"point labelled; wall {wall:.2f} s ({1 / wall:.3f} scans/s), host "
        f"preprocess + transform {host:.2f} s ({host / wall:.1%} of the "
        f"run) on {card}")
    say("kpconv", "test run's set-up: " + _kp_setup_line(spent))
    pipeline, _ = run_pipeline.build_pipeline(*run_pipeline.parse_args(
        [str(a) for a in argv]))
    reset_counts()
    test_patches = len(widths)
    t0 = time.perf_counter()
    with mock.patch.object(tkp.KPFCNNNet, "forward", forward):
        result = pipeline.run_inference({"point": pc[:, :3],
                                         "feat": pc[:, 3:6], "label": None})
    infer_s = time.perf_counter() - t0
    check_counts("kpconv", read_counts(), {})
    labels = result["predict_labels"]
    if labels.shape != (len(pc),):
        raise AssertionError(f"kpconv: run_inference gave {labels.shape} "
                             f"labels for {len(pc)} points")
    say("kpconv", f"run_inference on {KP_TEST_ROOM}: one label per point "
        f"({len(pc)}), {len(widths) - test_patches} patches, {infer_s:.2f} s "
        f"on {card}")
    return {"test_patches": test_patches, "test_wall_s": wall,
            "test_scans_per_s": 1 / wall, "test_host_share": host / wall,
            "inference_s": infer_s}


def kp_profile():
    """``--kpconv-profile``: one torch.profiler pass over one eval forward
    and one training step (train-mode forward, loss and backward, SGD) of
    KPFCNN at the SemanticKITTI config on the bench's request, split by
    record_function ranges; prints one JSON line per range: device ms
    (kernel rows), kernels, wall ms and the top 8 kernels. Run in a
    process of its own: the profiler traces the card once a process."""
    from torch.profiler import ProfilerActivity, profile, record_function
    phase_device()
    model, cfg = kp_model("semantickitti")
    batch, _ = kp_request(model, draws=1)
    batch["labels"] = np.random.default_rng(SEED).integers(
        0, model.cfg.num_classes + 1, batch["labels"].shape).astype(np.int32)
    net = random_weights(model.get_net(), SEED).to(DEVICE)
    x = kp_tensors(batch, DEVICE)

    class Dataset:
        pass

    Dataset.cfg = cfg.dataset
    loss_fn = SemSegLoss(None, model, Dataset)
    optimizer, _ = model.get_optimizer(cfg.pipeline, net)

    def step(ranges=False):
        def scope(name):
            return (record_function(name) if ranges else
                    contextlib.nullcontext())
        net.eval()
        with scope(KP_RANGES[0]), torch.no_grad():
            net(x)
            torch.cuda.synchronize()
        net.train()
        with scope(KP_RANGES[1]):
            loss, _, _ = model.get_loss(loss_fn, net(x), x)
            torch.cuda.synchronize()
        with scope(KP_RANGES[2]):
            optimizer.zero_grad(set_to_none=True)
            loss.backward()
            torch.cuda.synchronize()
        with scope(KP_RANGES[3]):
            optimizer.step()
            torch.cuda.synchronize()

    for _ in range(2):
        step()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(ranges=True)
    events = prof.events()
    for name in KP_RANGES:
        rng = next(e for e in events if e.name == name and
                   e.device_type == torch.autograd.DeviceType.CPU)
        start, end = rng.time_range.start, rng.time_range.end
        kernels, calls = collections.Counter(), collections.Counter()
        for e in events:
            if (e.device_type == torch.autograd.DeviceType.CUDA and
                    not e.name.startswith("kpconv ") and
                    start <= e.time_range.start <= end):
                kernels[e.name] += e.time_range.elapsed_us() / 1e3
                calls[e.name] += 1
        print(json.dumps({
            "range": name, "device_ms": sum(kernels.values()),
            "kernels": sum(calls.values()), "wall_ms": (end - start) / 1e3,
            "top": [[k[:64], ms, calls[k]]
                    for k, ms in kernels.most_common(8)]}), flush=True)


def _kp_profiles(card):
    """``kp_profile`` in a child process; returns {range: device ms, busy
    share} and prints each range's line."""
    run = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                          "--kpconv-profile"], cwd=REPO, capture_output=True,
                         text=True, timeout=600)
    if run.returncode != 0:
        raise AssertionError(f"kpconv: the profiler run failed:\n"
                             f"{run.stderr[-4000:]}")
    records = [json.loads(line) for line in run.stdout.splitlines()
               if line.startswith('{"range"')]
    if len(records) != len(KP_RANGES) or any(r["device_ms"] <= 0
                                            for r in records):
        raise AssertionError(f"kpconv: the profiler saw no device time: "
                             f"{run.stdout[-2000:]}")
    out = {}
    for r in records:
        busy = r["device_ms"] / r["wall_ms"]
        out[r["range"]] = {"device_ms": r["device_ms"], "busy": busy,
                           "kernels": r["kernels"]}
        say("kpconv", f"profiled {r['range']}: device {r['device_ms']:.3f} "
            f"ms over {r['kernels']} kernels in a {r['wall_ms']:.3f} ms span "
            f"(busy {busy:.1%}); top: " + ", ".join(
                f"{k} {ms:.3f} ms x{n}" for k, ms, n in r["top"]) +
            f" (on {card})")
    return out


def phase_kpconv(card):
    """KPConv (KPFCNN) at the shipped SemanticKITTI and S3DIS configs, full
    width and depth, seeded weights: (a) the eval forward on the bench's
    request, (b) one training step against the CPU, (c) ``run_train`` and
    (d) ``run_test`` and ``run_inference`` through the command line, and a
    profiled forward and step. KPConv reaches no kernel of the port's:
    every launch count stays 0. Prints one JSON record of the phase."""
    t_phase = time.perf_counter()
    record = _kp_eval(card)
    record.update(_kp_step(card))
    with tempfile.TemporaryDirectory() as tmp:
        record.update(_kp_train_cli(card, Path(tmp)))
        record.update(_kp_test_cli(card, Path(tmp)))
    record["profile"] = _kp_profiles(card)
    record["phase_s"] = time.perf_counter() - t_phase
    say("kpconv", f"phase {record['phase_s']:.1f} s")
    print(json.dumps({"kpconv": record, "card": card}), flush=True)
    return record


# --------------------------------------------------------------- PointRCNN


def prcnn_model(mode="RCNN", **overrides):
    """``PointRCNN(**POINTRCNN_KITTI)`` in ``mode``: RCNN, the serving
    mode, unless a training stage asks for RPN."""
    return MODEL.get("PointRCNN")(**dict(POINTRCNN_KITTI, mode=mode,
                                         seed=SEED, **overrides))


def prcnn_scene(seed):
    """A KITTI front-view crop for PointRCNN: ``make_objdet_scene(seed,
    r_max=PRCNN_R_MAX)`` beside the ground and clutter of a second scene
    (seed + 10,000, no objects): about 19,500 points out to 70.4 m, of
    which the KITTI reader keeps the ~17,400 in the camera's view, so
    that the test split draws its 16,384 without repeats and a third of
    them lie beyond 40 m, where the proposal layer's far bucket takes
    its candidates."""
    points, boxes = make_objdet_scene(seed, r_max=PRCNN_R_MAX)
    extra, _ = make_objdet_scene(seed + 10_000, n_objects=0, r_max=PRCNN_R_MAX)
    return np.concatenate([points, extra]), boxes


def prcnn_request(model, root, seed=SEED):
    """One KITTI frame (``prcnn_scene(seed)`` written by
    ``write_kitti_frame`` under ``root``) through the test split's
    ``preprocess`` and ``transform``: {"point" [1, 16,384, 3] on the
    CPU, "calib"}, and the frame's point count. Raises if the frame
    holds fewer points than the model draws."""
    write_kitti_frame(root, "testing", 0, seed, prcnn_scene)
    data = KITTI(dataset_path=str(root)).get_split("test").get_data(0)
    if len(data["point"]) < model.npoints:
        raise AssertionError(f"pointrcnn: the frame holds "
                             f"{len(data['point'])} points, fewer than "
                             f"the {model.npoints} drawn")
    attr = {"split": "test"}
    sample = model.transform(model.preprocess(data, attr), attr)
    batch = DefaultBatcher().collate_fn([{"data": sample, "attr": attr}])
    return batch["data"], len(data["point"])


def _prcnn_calls(net, x, grad=False):
    """The kernel wrappers' calls of one forward (with autograd where
    ``grad``, as a training step runs it): {"knn_exact": [(args,
    kwargs)], "fps": [...], "nms_bev": [...]}, each call run once as the
    forward runs it."""
    calls, out = {}, {}

    def forward():
        with torch.set_grad_enabled(grad):
            out["net"] = net(x)

    def nms():
        calls["nms_bev"] = _captured(cnms, "nms_bev", forward)

    def knn():
        calls["knn_exact"] = _captured(tn, "knn_exact", nms)

    calls["fps"] = _captured(tsmp, "fps", knn)
    return calls, out["net"]


def _prcnn_knn_check(args, kwargs):
    """knn_exact on one captured call of the forward against its plain
    version on the card: d2 bit-equal, indices equal off exact d2 ties;
    the same search on lattice points (many ties), indices row for row.
    Returns its record."""
    points, queries, k = args
    b, n, _ = points.shape
    q = queries.shape[1]
    got = ck.knn_exact(points, queries, k, **kwargs)
    want = ck.knn_exact_plain(points, queries, k, **kwargs)
    rows = _exact_equal(f"knn_exact B={b} N={n} Q={q} k={k}", got, want,
                        False)
    lat = lattice_points(b, max(n, q), SEED + n + k)
    lp, lq = lat[:, :n].contiguous(), lat[:, :q].contiguous()
    _exact_equal(f"knn_exact B={b} N={n} Q={q} k={k} lattice",
                 ck.knn_exact(lp, lq, k), ck.knn_exact_plain(lp, lq, k),
                 True)
    ms = device_ms(lambda: ck.knn_exact(points, queries, k, **kwargs))
    plain_ms = span_ms(lambda: ck.knn_exact_plain(points, queries, k,
                                                  **kwargs),
                       iters=3, warmup=1)
    bounds = bound(nbytes(points, queries) + b * q * k * 8, b * n * q * 8)
    plan = ck.exact_plan(b, n, q, sms=ck.sm_count(points.device.index), k=k)
    say("pointrcnn", f"knn_exact B={b} N={n} Q={q} k={k} (plan {plan}): d2 "
        f"bit-equal, {int(rows.sum())} rows apart only at exact d2 ties, "
        f"lattice row for row; device ms {ms:.4f}, bound "
        f"{max(bounds):.4f}, plain call span {plain_ms:.4f}")
    return kernel_record(0.0, ms, plain_ms, bounds)


def _prcnn_fps_check(args, kwargs):
    """fps on one captured call against its plain version on the card,
    indices equal; returns its record."""
    points, m = args
    b, n, _ = points.shape
    if not torch.equal(cfps.fps(points, m, **kwargs),
                       cfps.fps_plain(points, m, **kwargs)):
        raise AssertionError(f"pointrcnn fps B={b} N={n} m={m}: indices "
                             "differ from the plain version")
    ms = device_ms(lambda: cfps.fps(points, m, **kwargs), iters=10)
    plain_ms = span_ms(lambda: cfps.fps_plain(points, m, **kwargs), iters=1,
                       warmup=0)
    bounds = bound(nbytes(points) + b * m * 4, b * (m - 1) * n * 9)
    say("pointrcnn", f"fps B={b} N={n} m={m} (plan {cfps.fps_plan(n)}: CTAs "
        f"a cloud, threads a CTA): indices equal to the plain version's; "
        f"device ms "
        f"{ms:.4f} ({ms / max(m - 1, 1) * 1e3:.3f} us a step), bound "
        f"{max(bounds):.4f}, plain call span {plain_ms:.4f}")
    return kernel_record(0.0, ms, plain_ms, bounds)


def _overlapping_pairs(boxes, valid):
    """Pairs (i < j, both valid) of boxes [R, N, 5] whose bounding circles
    meet: the pairs whose IoU needs the clip."""
    r = 0.5 * torch.sqrt(boxes[..., 2] ** 2 + boxes[..., 3] ** 2)
    total = 0
    n = boxes.shape[1]
    for s in range(0, n, 1024):
        c = boxes[:, s:s + 1024, None, :2] - boxes[:, None, :, :2]
        near = (c ** 2).sum(-1) <= (r[:, s:s + 1024, None] +
                                    r[:, None]) ** 2
        later = (torch.arange(n, device=boxes.device)[None] >
                 torch.arange(s, min(s + 1024, n),
                              device=boxes.device)[:, None])
        ok = valid[:, s:s + 1024, None] & valid[:, None]
        total += int((near & later & ok).sum())
    return total


def nms_trace(boxes, valid, thr, keep):
    """Trace every keep decision of ``keep`` [R, N] (boxes [R, N, 5] in
    score order, ``valid`` [R, N]) through the plain IoU: box j must be
    kept exactly when it is valid and no box i < j that ``keep`` keeps has
    a plain IoU with it above ``thr``, unless one of those i lies within
    ``PRCNN_IOU_NEAR`` of ``thr``. Raises at a decision that breaks it;
    returns how many decisions the rule alone would have made otherwise
    (each decided by such a near pair). A mask that passes differs from
    ``nms_bev_plain``'s only through those decisions."""
    r, n, _ = boxes.shape
    over = torch.zeros((r, n), dtype=torch.bool, device=boxes.device)
    near = torch.zeros_like(over)
    cols = torch.arange(n, device=boxes.device)
    step = max(1, cnms.PLAIN_PAIRS // n)
    for row in range(r):
        kept = torch.nonzero(keep[row]).flatten()
        for s in range(0, len(kept), step):
            i = kept[s:s + step]
            iou = iou_bev(boxes[row, i], boxes[row])
            after = cols[None] > i[:, None]
            over[row] |= ((iou > thr) & after).any(0)
            near[row] |= (((iou - thr).abs() <= PRCNN_IOU_NEAR) &
                          after).any(0)
    off = keep != (valid & ~over)
    bad = torch.nonzero(off & ~(near & valid))
    if len(bad):
        row, j = (int(v) for v in bad[0])
        raise AssertionError(
            f"nms_bev: row {row} box {j} kept {bool(keep[row, j])}, valid "
            f"{bool(valid[row, j])}, suppressed by a kept box "
            f"{bool(over[row, j])}, with no kept box near the threshold "
            f"({len(bad)} such decisions)")
    return int(off.sum())


def _prcnn_nms_check(label, args, phase="pointrcnn"):
    """nms_bev on one captured call (boxes [R, N, 5] in score order, valid,
    threshold) against its plain version on the card: every keep decision
    of the kernel traced through the plain IoU (``nms_trace``), and the
    decisions apart from the plain version's counted. Its record's
    ``max_abs_err`` is the share of keep decisions apart. Returns its
    record."""
    boxes, valid, thr = args
    r, n, _ = boxes.shape
    got = cnms.nms_bev(boxes, valid, thr)
    t0 = time.perf_counter()
    want = cnms.nms_bev_plain(boxes, valid, thr)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    near = nms_trace(boxes, valid, thr, got)
    differ = int((got != want).sum())
    ms = device_ms(lambda: cnms.nms_bev(boxes, valid, thr), iters=10)
    mask_ms, sweep_ms = _nms_stage_ms(cnms.launch, boxes, valid, thr)
    pairs = _overlapping_pairs(boxes, valid)
    bounds = bound(nbytes(boxes, valid) + r * n, pairs * NMS_PAIR_OPS)
    rows_valid = valid.sum(1).tolist()
    say(phase, f"nms_bev {label} R={r} N={n} threshold {thr}: valid "
        f"boxes a row {rows_valid}, kernel keeps {got.sum(1).tolist()}, "
        f"plain {want.sum(1).tolist()}; every kernel decision traced "
        f"through the plain IoU, {near} decided by a kept pair within "
        f"{PRCNN_IOU_NEAR:g} of the threshold; {differ} keep decisions "
        f"apart from the plain version's; {pairs} overlapping pairs; "
        f"device ms {ms:.4f} (the mask kernel {mask_ms:.4f}, the sweep "
        f"{sweep_ms:.4f}), bound {max(bounds):.4f} "
        f"({'bytes' if bounds[0] >= bounds[1] else 'ops'}; the sweep is {n} "
        f"dependent steps), plain call span {plain_ms:.2f} (its IoU matrix "
        f"in blocks of {cnms.PLAIN_PAIRS} pairs)")
    return dict(kernel_record(differ / got.numel(), ms, plain_ms, bounds),
                differ=differ, near=near, valid=rows_valid, mask_ms=mask_ms,
                sweep_ms=sweep_ms)


def _nms_decisions(phase, label, boxes, valid, thr):
    """The nms_bev kernels (``cnms.launch``: no launch counted) on one
    captured call against ``nms_bev_plain`` on the card: every keep
    decision traced through the plain IoU (``nms_trace``, which raises
    at a decision it cannot explain); prints the decisions apart."""
    r, n, _ = boxes.shape
    got = cnms.launch(boxes, valid, thr, cnms.scratch(r, n, boxes.device),
                      cnms.MASK | cnms.SWEEP)
    want = cnms.nms_bev_plain(boxes, valid, thr)
    near = nms_trace(boxes, valid, thr, got)
    say(phase, f"nms_bev {label} R={r} N={n} threshold {thr}: kernel keeps "
        f"{got.sum(1).tolist()}, plain {want.sum(1).tolist()}; every "
        f"decision traced through the plain IoU, {near} decided by a kept "
        f"pair within {PRCNN_IOU_NEAR:g} of the threshold; "
        f"{int((got != want).sum())} keep decisions apart from the plain "
        f"version's")


def _nms_stage_ms(launch, boxes, valid, thr):
    """Device ms of the mask kernel alone and of the sweep alone (on the
    mask the first filled), each as ``device_ms`` times it; ``launch`` is
    ``ops/cuda/nms.py`` ``launch``."""
    r, n, _ = boxes.shape
    mask = cnms.scratch(r, n, boxes.device)
    mask_ms = device_ms(lambda: launch(boxes, valid, thr, mask, cnms.MASK),
                        iters=10)
    sweep_ms = device_ms(lambda: launch(boxes, valid, thr, mask,
                                        cnms.SWEEP), iters=10)
    return mask_ms, sweep_ms


def _prcnn_stage_split(net, model, x, data, runs=10, warmup=3):
    """Median device-timeline ms of each stage of a served frame (CUDA
    events between the stages, the whole in one synchronised run), the
    median of the whole, and the whole's times."""
    per = collections.defaultdict(list)
    whole = []
    with torch.no_grad():
        for i in range(warmup + runs):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
            ev[0].record()
            cls, reg, xyz, feats = net.rpn(x["point"])
            ev[1].record()
            rois, scores, valid = net.proposals(cls, reg, xyz)
            ev[2].record()
            pts_input = net.pool(cls, xyz, feats, rois)
            ev[3].record()
            b, r = pts_input.shape[:2]
            rcls, rreg = net.rcnn(pts_input.reshape(b * r,
                                                    *pts_input.shape[2:]))
            ev[4].record()
            model.inference_end(
                {"rois": rois, "scores": scores, "valid": valid,
                 "cls": rcls.reshape(b, r, -1),
                 "reg": rreg.reshape(b, r, -1)}, data)
            ev[5].record()
            ev[5].synchronize()
            if i >= warmup:
                for k, name in enumerate(PRCNN_STAGES):
                    per[name].append(ev[k].elapsed_time(ev[k + 1]))
                whole.append(ev[0].elapsed_time(ev[5]))
    return ({k: statistics.median(v) for k, v in per.items()},
            statistics.median(whole), whole)


def _prcnn_serving(model, net, x, data, card):
    """The served frame: the launch counts of one forward and of its
    refinement, finite outputs, peak memory, the median and the stage
    split. Returns (launches, median ms, peak GiB, outputs)."""
    with torch.no_grad():
        net(x)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        out = net(x)
        torch.cuda.synchronize()
        check_counts("pointrcnn", read_counts(), PRCNN_FORWARD_LAUNCHES)
        boxes = model.inference_end(out, data)
        torch.cuda.synchronize()
        launches = read_counts()
    check_counts("pointrcnn", launches, PRCNN_SERVE_LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    # the scores of the slots no proposal fills are -inf
    for key, value in (("rois", out["rois"]), ("cls", out["cls"]),
                       ("reg", out["reg"]),
                       ("scores", out["scores"][out["valid"]])):
        if not torch.isfinite(value).all():
            raise AssertionError(f"pointrcnn: non-finite {key}")
    if tuple(out["rois"].shape) != (1, 100, 7) or not out["valid"].any():
        raise AssertionError(f"pointrcnn: rois {tuple(out['rois'].shape)}, "
                             f"{int(out['valid'].sum())} valid")
    stages, ms, times = _prcnn_stage_split(net, model, x, data)
    say("pointrcnn", f"served frame 1 x {model.npoints} points, mode RCNN, "
        f"float32: {int(out['valid'].sum())} valid rois of 100, "
        f"{len(boxes[0])} boxes; launches {launches}; median "
        f"{ms:.3f} ms over {len(times)} runs (min {min(times):.3f}, max "
        f"{max(times):.3f}), {1e3 / ms:.2f} frames/s; stages (device "
        f"timeline, medians): " + ", ".join(
            f"{k} {v:.3f} ms ({v / ms:.1%})" for k, v in stages.items()) +
        f"; peak device memory {peak:.2f} GiB on {card}")
    return launches, ms, stages, peak, out


def _prcnn_vs_cpu(model, net, state, x, out):
    """The card against the CPU: the RPN's four outputs (relative L2 <=
    ``PRCNN_TOL``); the card's rois replayed on the CPU through
    ``roipool3d`` and the RCNN net (the pooled input and cls and reg <=
    ``PRCNN_TOL``); and how many rois the proposal layer selects alike
    from the card's and the CPU's RPN outputs (both on the card)."""
    cpu = model.get_net()
    cpu.load_state_dict(state)
    cpu.eval()
    points = x["point"].cpu()
    with torch.no_grad():
        t0 = time.perf_counter()
        rpn_cpu = cpu.rpn(points)
        cpu_s = time.perf_counter() - t0
        rpn_card = net.rpn(x["point"])
        rels = {k: _rel_l2(a, b) for k, a, b in
                zip(("cls", "reg", "xyz", "feats"), rpn_card, rpn_cpu)}
        cls, _, xyz, feats = rpn_cpu
        pooled_cpu = cpu.pool(cls, xyz, feats, out["rois"].cpu())
        pooled_card = net.pool(rpn_card[0], rpn_card[2], rpn_card[3],
                               out["rois"])
        rels["pooled"] = _rel_l2(pooled_card, pooled_cpu)
        b, r = pooled_cpu.shape[:2]
        t0 = time.perf_counter()
        rcls, rreg = cpu.rcnn(pooled_cpu.reshape(b * r,
                                                 *pooled_cpu.shape[2:]))
        cpu_s += time.perf_counter() - t0
        rels["rcnn cls"] = _rel_l2(out["cls"], rcls.reshape(b, r, -1))
        rels["rcnn reg"] = _rel_l2(out["reg"], rreg.reshape(b, r, -1))
        alt = net.proposals(*(t.to(DEVICE) for t in rpn_cpu[:3]))
    same = ((alt[0] - out["rois"]).abs().amax(-1) <=
            1e-4 * out["rois"].abs().amax(-1).clamp(min=1))
    alike = int((same & out["valid"] & alt[2]).sum())
    say("pointrcnn", "card vs CPU (relative L2): " + ", ".join(
        f"{k} {v:.3e}" for k, v in rels.items()) + f" (bound {PRCNN_TOL:g}; "
        f"the RCNN stage replays the card's rois; CPU {cpu_s:.1f} s); the "
        f"proposal layer on the CPU's RPN outputs selects {alike} of the "
        f"card's {int(out['valid'].sum())} rois alike")
    bad = {k: v for k, v in rels.items() if not v <= PRCNN_TOL}
    if bad:
        raise AssertionError(f"pointrcnn card vs CPU: {bad}")
    return rels, alike


def _prcnn_entry_points(model, state, card, root):
    """run_inference, run_test over ``PRCNN_TEST_FRAMES`` KITTI frames,
    run_valid with mAP over ``PRCNN_VALID_FRAMES``, and the command line
    (``--model.mode RCNN --split test``) on them: the launch counts of
    each, wall time, frames/s and the host's share."""
    kitti = root / "kitti"
    for i in range(PRCNN_TEST_FRAMES):
        write_kitti_frame(kitti, "testing", i, 200 + i, prcnn_scene)
    for i in range(PRCNN_VALID_FRAMES):
        write_kitti_frame(kitti, "training", i, 210 + i, prcnn_scene)
    dataset = KITTI(dataset_path=str(kitti), val_split=0,
                    test_result_folder=str(root / "results"))
    pipeline = ObjectDetection(model, dataset=dataset, device=DEVICE,
                               seed=SEED, main_log_dir=str(root / "logs"),
                               num_workers=0, **POINTRCNN_PIPELINE)
    pipeline.net.load_state_dict(state)
    record = {}

    def timed(name, fn, frames):
        spent = collections.Counter()
        net = pipeline.eval_net
        net.forward = _timed(net.forward, spent, "forward", sync=True)
        model.inference_end = _timed(model.inference_end, spent, "decode")
        try:
            reset_counts()
            t0 = time.perf_counter()
            result = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = read_counts()
        finally:
            del net.forward, model.inference_end
        check_counts("pointrcnn", launches,
                     {k: v * frames for k, v in
                      PRCNN_SERVE_LAUNCHES.items()})
        host = wall - spent["forward"] - spent["decode"]
        record[name] = {"wall_s": wall, "frames_per_s": frames / wall,
                        "host_share": host / wall}
        say("pointrcnn", f"{name}: {frames} frame(s), wall {wall:.3f} s, "
            f"{frames / wall:.2f} frames/s; forward {spent['forward']:.3f} s "
            f"(synchronised), refinement and boxes {spent['decode']:.3f} s, "
            f"host (read, preprocess, transform, batch, write) {host:.3f} s "
            f"({host / wall:.1%}) on {card}")
        return result

    frame = dataset.get_split("test").get_data(0)
    found = timed("run_inference", lambda: pipeline.run_inference(frame), 1)
    results = timed("run_test", pipeline.run_test, PRCNN_TEST_FRAMES)
    files = sorted((root / "results").glob("*.txt"))
    lines = sum(len(f.read_text().splitlines()) for f in files)
    if len(files) != PRCNN_TEST_FRAMES or lines != sum(map(len, results)):
        raise AssertionError(f"pointrcnn run_test: {len(files)} files, "
                             f"{lines} lines for {list(map(len, results))}")
    if not found or not all(np.isfinite(b.to_xyzwhlr()).all()
                            for b in found):
        raise AssertionError(f"pointrcnn run_inference: {len(found)} boxes")
    ap_bev, ap_3d = timed("run_valid", pipeline.run_valid,
                          PRCNN_VALID_FRAMES)
    if not (np.isfinite(ap_bev).all() and np.isfinite(ap_3d).all()):
        raise AssertionError("pointrcnn run_valid: non-finite mAP")
    say("pointrcnn", f"run_test boxes a frame {list(map(len, results))}, "
        f"{len(files)} result files; run_inference {len(found)} boxes; "
        f"run_valid mAP BEV {ap_bev.mean():.4f}, 3D {ap_3d.mean():.4f} "
        f"(random weights: finite, no floor)")
    argv = ["-c", REPO / PRCNN_CONFIG, "--device", DEVICE,
            "--dataset.dataset_path", kitti,
            "--dataset.test_result_folder", root / "cli_results",
            "--main_log_dir", root / "cli_logs",
            "--pipeline.num_workers", "0", "--model.mode", "RCNN",
            "--split", "test"]
    wall, launches, _, _ = _cli_run(argv)
    check_counts("pointrcnn", launches,
                 {k: v * PRCNN_TEST_FRAMES for k, v in
                  PRCNN_SERVE_LAUNCHES.items()})
    files = sorted((root / "cli_results").glob("*.txt"))
    if len(files) != PRCNN_TEST_FRAMES:
        raise AssertionError(f"pointrcnn cli: {len(files)} result files")
    record["cli"] = {"wall_s": wall,
                     "frames_per_s": PRCNN_TEST_FRAMES / wall}
    say("pointrcnn", f"run_pipeline -c {PRCNN_CONFIG} --model.mode RCNN "
        f"--split test: {len(files)} result files, wall {wall:.3f} s (the "
        f"model, the pipeline and the seeded weights built in it), "
        f"{PRCNN_TEST_FRAMES / wall:.2f} frames/s on {card}")
    return record


def prcnn_profile():
    """``--prcnn-profile``: one torch.profiler pass over one served frame
    (the forward and ``inference_end``) on seeded weights; prints one
    JSON line: device ms (kernel rows), kernels, wall ms, the three port
    kernels' device ms and the top 8 kernels. Run in a process of its own:
    the profiler traces the card once a process."""
    from torch.profiler import ProfilerActivity, profile, record_function
    phase_device()
    model = prcnn_model()
    net = random_weights(model.get_net(), SEED).eval().to(DEVICE)
    with tempfile.TemporaryDirectory() as tmp:
        data, _ = prcnn_request(model, Path(tmp))
    x = {"point": torch.from_numpy(data["point"]).to(DEVICE)}

    def serve():
        with torch.no_grad():
            model.inference_end(net(x), data)
        torch.cuda.synchronize()

    for _ in range(2):
        serve()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("prcnn serve"):
            serve()
    events = prof.events()
    rng = next(e for e in events if e.name == "prcnn serve" and
               e.device_type == torch.autograd.DeviceType.CPU)
    kernels, calls = collections.Counter(), collections.Counter()
    for e in events:
        # the range itself has a device row too
        if (e.device_type == torch.autograd.DeviceType.CUDA and
                e.name != "prcnn serve"):
            kernels[e.name] += e.time_range.elapsed_us() / 1e3
            calls[e.name] += 1
    ours = {name: sum(ms for k, ms in kernels.items() if key in k)
            for name, key in (("knn_exact", "knn_exact_kernel"),
                              ("fps", "fps_kernel"),
                              ("nms_bev", "nms_"))}
    print(json.dumps({
        "range": "prcnn serve", "device_ms": sum(kernels.values()),
        "kernels": sum(calls.values()),
        "wall_ms": (rng.time_range.end - rng.time_range.start) / 1e3,
        "ours": ours,
        "top": [[k[:64], ms, calls[k]] for k, ms in
                kernels.most_common(8)]}), flush=True)


def _prcnn_profile(card):
    """``prcnn_profile`` in a child process: the busy share of a served
    frame."""
    run = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                          "--prcnn-profile"], cwd=REPO, capture_output=True,
                         text=True, timeout=600)
    if run.returncode != 0:
        raise AssertionError(f"pointrcnn: the profiler run failed:\n"
                             f"{run.stderr[-4000:]}")
    rec = next(json.loads(line) for line in run.stdout.splitlines()
               if line.startswith('{"range"'))
    if rec["device_ms"] <= 0:
        raise AssertionError("pointrcnn: the profiler saw no device time")
    busy = rec["device_ms"] / rec["wall_ms"]
    say("pointrcnn", f"profiled served frame: device {rec['device_ms']:.3f} "
        f"ms over {rec['kernels']} kernels in a {rec['wall_ms']:.3f} ms span "
        f"(busy {busy:.1%}); the port's kernels: " + ", ".join(
            f"{k} {v:.3f} ms" for k, v in rec["ours"].items()) +
        "; top: " + ", ".join(f"{k} {ms:.3f} ms x{n}"
                              for k, ms, n in rec["top"]) + f" (on {card})")
    return dict(rec, busy=busy)


def phase_pointrcnn(card):
    """PointRCNN serving at the shipped KITTI config (mode RCNN, seeded
    weights, one frame of 16,384 points): (a) each kernel call of the
    forward and its refinement against its plain version on the card
    (knn_exact at k = 16, 32, 3 and 64, fps down to 128 and 32 points at
    B = 100, nms_bev on the proposal layer's two buckets and on the
    refinement's 100 rois); (b) the served frame: launch counts, median,
    stage split, peak memory and busy share; (c) the card against the
    CPU, the RCNN stage on the card's rois; (d) run_inference, run_test,
    run_valid and the command line. Prints one JSON line of the phase's
    numbers and returns (the served frame's launches, knn_exact's record
    for its 14 calls, fps's for its 6, nms_bev's for its 2)."""
    t_phase = time.perf_counter()
    model = prcnn_model()
    net = random_weights(model.get_net(), SEED).eval()
    state = {k: v.clone() for k, v in net.state_dict().items()}
    net = net.to(DEVICE)
    record = {}
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        data, frame_points = prcnn_request(model, root / "request")
        x = {"point": torch.from_numpy(data["point"]).to(DEVICE)}
        # camera frame: z is the depth ahead
        far = int((x["point"][..., 2] > 40.0).sum())
        say("pointrcnn", f"request: one KITTI frame of {frame_points} points"
            f" out to {PRCNN_R_MAX} m (prcnn_scene), {model.npoints} drawn "
            f"without repeats, {far} of them beyond 40 m")
        calls, out = _prcnn_calls(net, x)
        refine = _captured(cnms, "nms_bev",
                           lambda: model.inference_end(out, data))
        if {k: len(v) for k, v in calls.items()} != \
                PRCNN_FORWARD_LAUNCHES or len(refine) != 1:
            raise AssertionError(f"pointrcnn: captured {calls.keys()} "
                                 f"{[len(v) for v in calls.values()]}, "
                                 f"{len(refine)} refinement NMS calls")
        knn = [_prcnn_knn_check(*c) for c in calls["knn_exact"]]
        fps = [_prcnn_fps_check(*c) for c in calls["fps"]]
        nms = [_prcnn_nms_check("proposal buckets", calls["nms_bev"][0][0]),
               _prcnn_nms_check("refinement", refine[0][0])]
        knn_rec, fps_rec, nms_rec = combine(knn), combine(fps), combine(nms)
        launches, ms, stages, peak, out = _prcnn_serving(model, net, x, data,
                                                         card)
        say("pointrcnn", f"the kernels' device time in a {ms:.3f} ms served "
            f"frame, one by one: knn_exact {knn_rec['ms']:.3f} ms (14 "
            f"calls), fps {fps_rec['ms']:.3f} (6), nms_bev "
            f"{nms_rec['ms']:.3f} (2)")
        record["vs_cpu"], record["rois_alike"] = _prcnn_vs_cpu(
            model, net, state, x, out)
        record["entry_points"] = _prcnn_entry_points(model, state, card,
                                                     root)
    record["profile"] = _prcnn_profile(card)
    record.update(forward_ms=ms, frames_per_s=1e3 / ms, stages_ms=stages,
                  peak_gib=peak, launches=launches,
                  kernels_ms={"knn_exact": knn_rec["ms"],
                              "fps": fps_rec["ms"],
                              "nms_bev": nms_rec["ms"]},
                  nms_stages_ms={
                      label: {"mask": r["mask_ms"], "sweep": r["sweep_ms"]}
                      for label, r in zip(("proposal buckets", "refinement"),
                                          nms)},
                  nms_keep_differ=sum(r["differ"] for r in nms),
                  nms_near=sum(r["near"] for r in nms),
                  nms_valid={"proposal buckets": nms[0]["valid"],
                             "refinement": nms[1]["valid"]},
                  frame_points=frame_points,
                  phase_s=time.perf_counter() - t_phase)
    say("pointrcnn", f"phase {record['phase_s']:.1f} s")
    print(json.dumps({"pointrcnn": record, "card": card}), flush=True)
    return launches, knn_rec, fps_rec, nms_rec


def prcnn_train_frames(root):
    """``PRCNN_TRAIN_FRAMES`` KITTI training frames (``prcnn_scene``
    seeds 220 on) under ``root``, the last ``PRCNN_TRAIN_VALID`` of them
    the validation split (``val_split``), and the gt database of the
    train split (``utils/collect_bboxes``) beside them: (dataset, the
    database's path, its box count)."""
    for i in range(PRCNN_TRAIN_FRAMES):
        write_kitti_frame(root, "training", i, 220 + i, prcnn_scene)
    val_split = PRCNN_TRAIN_FRAMES - PRCNN_TRAIN_VALID
    dataset = KITTI(dataset_path=str(root), val_split=val_split)
    db = root / "bboxes.pkl"
    count = collect_bboxes.collect(KITTI(dataset_path=str(root),
                                         val_split=val_split), db)
    return dataset, db, count


def prcnn_train_batch(model, dataset, idx=0):
    """Frame ``idx`` of the train split through the model's training
    ``preprocess`` and ``transform``: the collated arrays as CPU tensors
    (mode RPN: the points, per-point labels and box targets; mode RCNN:
    the points and the padded gt boxes with their count)."""
    split = dataset.get_split("training")
    attr = split.get_attr(idx)
    sample = model.transform(model.preprocess(split.get_data(idx), attr),
                             attr)
    batch = DefaultBatcher().collate_fn([{"data": sample, "attr": attr}])
    return {k: torch.from_numpy(v) for k, v in batch["data"].items()
            if isinstance(v, np.ndarray)}


def prcnn_gt_on_proposals(model, net, x, count=8, seed=SEED):
    """``x`` (CPU tensors, mode RCNN) with its gt boxes replaced by the
    ``count`` best proposals of ``net``'s frozen RPN at training's NMS,
    each moved by N(0, 5 cm): with seeded weights the RPN proposes
    nothing near the frame's own boxes, so a step would see no
    foreground roi and train no regression."""
    dev = next(net.parameters()).device
    with torch.no_grad():
        cls, reg, xyz, _ = net.rpn.eval()(x["point"].to(dev))
        rois, _, valid = tprc.proposal_layer(cls[..., 0], reg, xyz,
                                             model.rpn_head_cfg,
                                             training=True)
    boxes = rois[0][valid[0]][:count].cpu()
    gen = torch.Generator().manual_seed(seed)
    gt = torch.zeros_like(x["bboxes"])
    gt[0, :len(boxes)] = boxes + 0.05 * torch.randn(boxes.shape,
                                                    generator=gen)
    return dict(x, bboxes=gt,
                bbox_count=torch.tensor([len(boxes)], dtype=torch.int32))


def _prcnn_step(model, net, opt, x):
    """One training step on the device batch ``x``; returns the loss."""
    net.train()
    losses = model.get_loss(net(x), x)
    opt.zero_grad(set_to_none=True)
    total = sum(losses.values())
    total.backward()
    opt.step()
    return total


def _prcnn_step_events(model, net, opt, x, steps):
    """``steps`` training steps, each split by CUDA events into forward,
    loss, backward and AdamW: (the losses, {part: [ms a step]}, [step
    ms])."""
    parts = collections.defaultdict(list)
    totals, losses = [], []
    for _ in range(steps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        net.train()
        ev[0].record()
        out = net(x)
        ev[1].record()
        loss = sum(model.get_loss(out, x).values())
        ev[2].record()
        opt.zero_grad(set_to_none=True)
        loss.backward()
        ev[3].record()
        opt.step()
        ev[4].record()
        ev[4].synchronize()
        losses.append(loss.item())
        for k, part in enumerate(("forward", "loss", "backward", "adamw")):
            parts[part].append(ev[k].elapsed_time(ev[k + 1]))
        totals.append(ev[0].elapsed_time(ev[4]))
    return losses, parts, totals


def _prcnn_step_vs_cpu(mode, state, x, draws, keep):
    """One float32 training step of ``mode`` on the card and on the CPU
    from the same weights ``state``, batch ``x`` (CPU tensors), dropout
    keep mask and roi-sampling draws, the CPU on the card's branches
    (``_SameBranches(net="prcnn")``) and, in mode RCNN, fed the card's RPN
    outputs. Returns {"loss", "grad", "stats": relative differences,
    "differ", "choices", "cpu_s"}; gradients and statistics are the
    trained stage's."""
    stage = "rpn." if mode == "RPN" else "rcnn."
    out = {}
    rpn_out = {}
    with _SameBranches(net="prcnn") as branches:
        for side, device in (("card", DEVICE), ("cpu", "cpu")):
            model = prcnn_model(mode)
            net = model.get_net()
            net.load_state_dict(state)
            net = net.to(device)
            if mode == "RPN":
                for head in ("cls_blocks", "reg_blocks"):
                    getattr(net.rpn, head).dropout = _FixedDropout(keep)
            dev_draws = {k: v.to(device) for k, v in draws.items()}
            net.draw = lambda b, m, dev, d=dev_draws: d
            real_rpn = net.rpn.forward
            if side == "card":
                def rpn(points, real_rpn=real_rpn):
                    rpn_out["card"] = real_rpn(points)
                    return rpn_out["card"]
            else:
                def rpn(points, real_rpn=real_rpn):
                    real_rpn(points)
                    return tuple(t.cpu() for t in rpn_out["card"])
            if mode == "RCNN":
                net.rpn.forward = rpn
            opt, _ = model.get_optimizer(POINTRCNN_TRAIN_OPTIMIZER, net)
            xd = {k: v.to(device) for k, v in x.items()}
            t0 = time.perf_counter()
            net.train()
            results = net(xd)
            losses = model.get_loss(results, xd)
            total = sum(losses.values())
            total.backward()
            seconds = time.perf_counter() - t0
            grads = {n: p.grad.reshape(-1).double().cpu()
                     for n, p in net.named_parameters()
                     if n.startswith(stage)}
            out[side] = {
                "loss": total.double().cpu(),
                "grads": grads,
                "grad": torch.cat(list(grads.values())),
                "stats": torch.cat([b.reshape(-1).double().cpu()
                                    for k, b in net.state_dict().items()
                                    if k.startswith(stage) and k.endswith(
                                        ("running_mean", "running_var"))]),
                "seconds": seconds,
                "labels": {k: int(v) for k, v in (
                    ("fg", (results["cls_label"] == 1).sum()),
                    ("reg", results["reg_valid_mask"].sum()))}
                if mode == "RCNN" else {}}
            if side == "card":
                branches.replay()
        if branches.recorded:
            raise AssertionError("pointrcnn_train: the CPU step took fewer "
                                 "branches than the card's")
    gpu, cpu = out["card"], out["cpu"]
    # the parameters whose gradients hold most of the difference
    diff2 = {n: ((g - cpu["grads"][n]) ** 2).sum().item()
             for n, g in gpu["grads"].items()}
    total2 = max(sum(diff2.values()), 1e-300)
    worst = [(n, diff2[n] / total2, _rel_l2(gpu["grads"][n], cpu["grads"][n]))
             for n in sorted(diff2, key=diff2.get, reverse=True)[:3]]
    return {"loss": (abs(gpu["loss"] - cpu["loss"]) /
                     abs(cpu["loss"])).item(),
            "worst": worst,
            "grad": _rel_l2(gpu["grad"], cpu["grad"]),
            "stats": _rel_l2(gpu["stats"], cpu["stats"]),
            "differ": branches.differ, "choices": branches.total,
            "cpu_s": cpu["seconds"], "labels": gpu["labels"],
            "labels_cpu": cpu["labels"]}


def prcnn_train_profile():
    """``--prcnn-train-profile``: one torch.profiler pass over one
    training step of each mode at the shipped config on seeded weights,
    each in a range of its own; prints one JSON line a mode: device ms
    (kernel rows), kernels, wall ms, the port's kernels' device ms and
    the top 8 kernels. Run in a process of its own: the profiler traces
    the card once a process."""
    from torch.profiler import ProfilerActivity, profile, record_function
    phase_device()
    steps = {}
    with tempfile.TemporaryDirectory() as tmp:
        dataset, _, _ = prcnn_train_frames(Path(tmp))
        for mode in ("RPN", "RCNN"):
            model = prcnn_model(mode)
            net = random_weights(model.get_net(), SEED).to(DEVICE)
            opt, _ = model.get_optimizer(POINTRCNN_TRAIN_OPTIMIZER, net)
            x = prcnn_train_batch(model, dataset)
            if mode == "RCNN":
                x = prcnn_gt_on_proposals(model, net, x)
            steps[mode] = (model, net, opt,
                           {k: v.to(DEVICE) for k, v in x.items()})
    for mode, args in steps.items():
        for _ in range(2):
            _prcnn_step(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for mode, args in steps.items():
            with record_function(f"prcnn train {mode}"):
                _prcnn_step(*args).item()
                torch.cuda.synchronize()
    events = prof.events()
    ranges = {e.name for e in events
              if e.device_type == torch.autograd.DeviceType.CPU}
    for mode in steps:
        name = f"prcnn train {mode}"
        rng = next(e for e in events if e.name == name and
                   e.device_type == torch.autograd.DeviceType.CPU)
        t0, t1 = rng.time_range.start, rng.time_range.end
        kernels, calls = collections.Counter(), collections.Counter()
        for e in events:
            if (e.device_type == torch.autograd.DeviceType.CUDA and
                    e.name not in ranges and
                    t0 <= e.time_range.start <= t1):
                kernels[e.name] += e.time_range.elapsed_us() / 1e3
                calls[e.name] += 1
        ours = {k: sum(ms for n, ms in kernels.items() if key in n)
                for k, key in (("knn_exact", "knn_exact_kernel"),
                               ("fps", "fps_kernel"), ("nms_bev", "nms_"))}
        print(json.dumps({"range": name, "device_ms": sum(kernels.values()),
                          "kernels": sum(calls.values()),
                          "wall_ms": (t1 - t0) / 1e3, "ours": ours,
                          "top": [[k[:64], ms, calls[k]] for k, ms in
                                  kernels.most_common(8)]}), flush=True)


def _prcnn_train_profile(card):
    """``prcnn_train_profile`` in a child process: each mode's busy
    share."""
    run = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                          "--prcnn-train-profile"], cwd=REPO,
                         capture_output=True, text=True, timeout=600)
    if run.returncode != 0:
        raise AssertionError(f"pointrcnn_train: the profiler run failed:\n"
                             f"{run.stderr[-4000:]}")
    out = {}
    for line in run.stdout.splitlines():
        if not line.startswith('{"range"'):
            continue
        rec = json.loads(line)
        if rec["device_ms"] <= 0:
            raise AssertionError("pointrcnn_train: the profiler saw no "
                                 "device time")
        rec["busy"] = rec["device_ms"] / rec["wall_ms"]
        out[rec["range"]] = rec
        say("pointrcnn_train", f"profiled {rec['range']} step: device "
            f"{rec['device_ms']:.3f} ms over {rec['kernels']} kernels in a "
            f"{rec['wall_ms']:.3f} ms span (busy {rec['busy']:.1%}); the "
            f"port's kernels: " + ", ".join(
                f"{k} {v:.3f} ms" for k, v in rec["ours"].items()) +
            "; top: " + ", ".join(f"{k} {ms:.3f} ms x{n}"
                                  for k, ms, n in rec["top"]) +
            f" (on {card})")
    if len(out) != 2:
        raise AssertionError(f"pointrcnn_train: profiled {sorted(out)}")
    return out


def _prcnn_train_cli(card, root, dataset, db):
    """``run_pipeline.main`` on the shipped YAML, ``--split train``, mode
    RPN as shipped and then ``--model.mode RCNN`` in a log directory of
    its own, each one epoch over the train split and a validation, the
    YAML's augment section on with the gt database ``db``: the launch
    counts of every step, wall time, steps/s and the host's share."""
    record = {}
    val_split = PRCNN_TRAIN_FRAMES - PRCNN_TRAIN_VALID
    for mode in ("RPN", "RCNN"):
        steps = []
        real = ObjectDetection._train_step

        def train_step(self, inputs, real=real, steps=steps):
            before = read_counts()
            t0 = time.perf_counter()
            losses = real(self, inputs)
            values = [v.item() for v in losses.values()]
            t1 = time.perf_counter()
            after = read_counts()
            steps.append((t1 - t0, {k: after[k] - before[k] for k in after},
                          values))
            return losses

        argv = ["-c", REPO / PRCNN_CONFIG, "--device", DEVICE,
                "--dataset.dataset_path", dataset.cfg.dataset_path,
                "--dataset.val_split", val_split,
                "--main_log_dir", root / f"cli_{mode}",
                "--pipeline.num_workers", "0", "--pipeline.max_epoch", "0",
                "--model.mode", mode,
                "--model.augment.ObjectSample.pickle_path", db,
                "--split", "train"]
        with mock.patch.object(ObjectDetection, "_train_step", train_step):
            reset_counts()
            t0 = time.perf_counter()
            run_pipeline.main([str(a) for a in argv])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = read_counts()
        if len(steps) != val_split:
            raise AssertionError(f"pointrcnn_train cli {mode}: "
                                 f"{len(steps)} steps")
        for _, counts, values in steps:
            check_counts("pointrcnn_train", counts,
                         PRCNN_TRAIN_LAUNCHES[mode])
            if not np.isfinite(values).all():
                raise AssertionError(f"pointrcnn_train cli {mode}: loss "
                                     f"{values}")
        per_valid = (PRCNN_TRAIN_LAUNCHES["RPN"] if mode == "RPN" else
                     PRCNN_SERVE_LAUNCHES)
        check_counts("pointrcnn_train", launches, {
            k: PRCNN_TRAIN_LAUNCHES[mode][k] * len(steps) +
            per_valid[k] * PRCNN_TRAIN_VALID for k in per_valid})
        if not list((root / f"cli_{mode}").glob("**/ckpt_00000.pth")):
            raise AssertionError(f"pointrcnn_train cli {mode}: no "
                                 f"checkpoint")
        step_s = sum(t for t, _, _ in steps)
        record[mode] = {"wall_s": wall, "steps": len(steps),
                        "step_s": [t for t, _, _ in steps],
                        "host_share": (wall - step_s) / wall,
                        "launches": launches}
        say("pointrcnn_train", f"run_pipeline -c {PRCNN_CONFIG} --split "
            f"train --model.mode {mode} (ObjectSample from the gt "
            f"database): {len(steps)} steps of 1 frame, each "
            f"{PRCNN_TRAIN_LAUNCHES[mode]} launches, losses "
            f"{[round(sum(v), 4) for _, _, v in steps]}, and "
            f"{PRCNN_TRAIN_VALID} validation frame; launches {launches}; "
            f"wall {wall:.3f} s (the model, the pipeline and the seeded "
            f"weights built in it), steps "
            f"{', '.join(f'{t * 1e3:.1f}' for t, _, _ in steps)} ms "
            f"(synchronised), host share {record[mode]['host_share']:.1%} "
            f"on {card}")
    return record


def phase_pointrcnn_train(card):
    """PointRCNN training at the shipped KITTI config, both stages (seeded
    weights, frames of 16,384 points): for each mode (a) every kernel
    call of one training step against its plain version on the card
    (knn_exact, fps, and in mode RCNN nms_bev at training's 0.85 with
    512 survivors, every keep decision traced); (b) the launch counts of
    a step; (c) one float32 step on the card against the CPU on the
    card's branches (mode RCNN: the card's RPN outputs, the same
    sampling draws); (d) the median step, its forward, loss, backward
    and AdamW device ms, frames/s and peak memory; then (e) each step's
    busy share from a profiled child process and (f) the command line
    through both stages. Prints one JSON line of the phase's numbers and
    returns ({mode: launches}, the knn_exact, fps and nms_bev records of
    the checked calls)."""
    t_phase = time.perf_counter()
    record, launches = {}, {}
    checked = collections.defaultdict(list)
    gen = torch.Generator().manual_seed(SEED)
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        dataset, db, boxes = prcnn_train_frames(root / "kitti")
        say("pointrcnn_train", f"{PRCNN_TRAIN_FRAMES} KITTI frames "
            f"(prcnn_scene), {PRCNN_TRAIN_VALID} for validation; the gt "
            f"database holds {boxes} boxes")
        for mode in ("RPN", "RCNN"):
            model = prcnn_model(mode)
            net = random_weights(model.get_net(), SEED)
            state = {k: v.clone() for k, v in net.state_dict().items()}
            net = net.to(DEVICE)
            x_cpu = prcnn_train_batch(model, dataset)
            if mode == "RCNN":
                x_cpu = prcnn_gt_on_proposals(model, net, x_cpu)
            x = {k: v.to(DEVICE) for k, v in x_cpu.items()}
            # (a) the step's kernel calls, each against its plain version
            net.train()
            calls = _prcnn_calls(net, x, grad=True)[0]
            counts = {k: len(v) for k, v in calls.items()}
            if counts != PRCNN_TRAIN_LAUNCHES[mode]:
                raise AssertionError(f"pointrcnn_train {mode}: captured "
                                     f"{counts}")
            checked["knn_exact"] += [_prcnn_knn_check(*c)
                                     for c in calls["knn_exact"]]
            checked["fps"] += [_prcnn_fps_check(*c) for c in calls["fps"]]
            for args, _ in calls["nms_bev"]:
                rec = _prcnn_nms_check("proposal buckets (training)", args)
                if args[2] != model.rpn_head_cfg.nms_thres:
                    raise AssertionError(f"pointrcnn_train: NMS at "
                                         f"{args[2]}")
                checked["nms_bev"].append(rec)
            # (b) the launches of one step, (d) its times
            opt, _ = model.get_optimizer(POINTRCNN_TRAIN_OPTIMIZER, net)
            _prcnn_step(model, net, opt, x)  # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            _prcnn_step(model, net, opt, x)
            torch.cuda.synchronize()
            launches[mode] = read_counts()
            check_counts("pointrcnn_train", launches[mode],
                         PRCNN_TRAIN_LAUNCHES[mode])
            losses, parts, totals = _prcnn_step_events(
                model, net, opt, x, PRCNN_TRAIN_STEPS)
            peak = torch.cuda.max_memory_allocated() / 2**30
            if not np.isfinite(losses).all():
                raise AssertionError(f"pointrcnn_train {mode}: losses "
                                     f"{losses}")
            ms = statistics.median(totals[1:])
            split = {k: statistics.median(v[1:]) for k, v in parts.items()}
            # (c) the card against the CPU
            keep = torch.rand((1, model.npoints, 128), generator=gen) >= 0.5
            m = model.rpn_head_cfg.nms_post
            draws = tprc.draw_sampling(gen, 1, m, net.target_cfg, "cpu")
            vs = _prcnn_step_vs_cpu(mode, state, x_cpu, draws, keep)
            say("pointrcnn_train", f"mode {mode}, 1 x {model.npoints} "
                f"points, float32: launches a step {launches[mode]}; "
                f"losses {[round(v, 4) for v in losses]}; median step "
                f"{ms:.3f} ms over steps 2-{len(totals)} (min "
                f"{min(totals[1:]):.3f}, max {max(totals[1:]):.3f}), "
                f"{1e3 / ms:.2f} frames/s; " + ", ".join(
                    f"{k} {v:.3f} ms" for k, v in split.items()) +
                f"; peak device memory {peak:.2f} GiB; card vs CPU: loss "
                f"{vs['loss']:.3e} (bound {PRCNN_LOSS_TOL:g}), gradients "
                f"{vs['grad']:.3e}, BN statistics {vs['stats']:.3e} "
                f"(bound {PRCNN_TOL:g}), the CPU on the card's "
                f"{vs['choices']} choices ({vs['differ']} its own values "
                f"would have made otherwise), CPU step {vs['cpu_s']:.1f} s" +
                "; most of the gradients' difference in " + ", ".join(
                    f"{n} ({share:.0%}, itself {rel:.2e})"
                    for n, share, rel in vs["worst"]) +
                (f"; rois labelled 1 / regressed: card {vs['labels']}, "
                 f"CPU {vs['labels_cpu']} (gt on the proposals)"
                 if mode == "RCNN" else "") + f" on {card}")
            if not (vs["loss"] <= PRCNN_LOSS_TOL and vs["grad"] <= PRCNN_TOL
                    and vs["stats"] <= PRCNN_TOL and
                    vs["labels"] == vs["labels_cpu"] and
                    (mode == "RPN" or vs["labels"]["reg"] > 0)):
                raise AssertionError(f"pointrcnn_train {mode} card vs CPU: "
                                     f"{vs}")
            record[mode] = {"launches": launches[mode], "step_ms": ms,
                            "step_ms_all": totals,
                            "frames_per_s": 1e3 / ms, "parts_ms": split,
                            "peak_gib": peak, "losses": losses,
                            "vs_cpu": vs}
            del net, opt
        record["profile"] = _prcnn_train_profile(card)
        record["cli"] = _prcnn_train_cli(card, root, dataset, db)
    recs = {k: combine(v) for k, v in checked.items()}
    record.update(kernels_ms={k: r["ms"] for k, r in recs.items()},
                  nms_keep_differ=sum(r["differ"]
                                      for r in checked["nms_bev"]),
                  phase_s=time.perf_counter() - t_phase)
    say("pointrcnn_train", f"phase {record['phase_s']:.1f} s")
    print(json.dumps({"pointrcnn_train": record, "card": card}), flush=True)
    return launches, recs


# ------------------------------------------------------------------- PVCNN

def pv_model(**overrides):
    """``PVCNN`` at the model section of ``pvcnn_s3dis.yml``."""
    return MODEL.get("PVCNN")(**dict(PVCNN_S3DIS, **overrides))


def pv_request(model, root, rooms=PV_ROOMS[:PV_BATCH]):
    """A batch of the S3DIS rooms under ``root`` (``write_s3dis_rooms``),
    each through the model's ``preprocess`` as a test room (its
    ``num_points`` drawn from the room's seeded generator), collated by
    ``DefaultBatcher``: {"point", "feat", "label"} on the CPU."""
    samples = []
    for name in rooms:
        with open(root / "original_pkl" / f"{name}.pkl", "rb") as f:
            pc, _ = pickle.load(f)
        data = {"point": pc[:, :3], "feat": pc[:, 3:6],
                "label": pc[:, 6].astype(np.int32)}
        samples.append({"data": model.preprocess(
            data, {"split": "test"}, rng=np.random.default_rng(SEED))})
    batch = DefaultBatcher().collate_fn(samples)["data"]
    return {k: torch.from_numpy(batch[k]) for k in ("point", "feat",
                                                     "label")}


def pv_shapes(net):
    """(r, C) of each devoxelisation of a forward of ``net``, in order."""
    return [(block.resolution, block.vconv1.out_channels)
            for _, block in sorted(net.named_children())
            if isinstance(block, tpv.PVConv)]


def pv_flops(net, b, n):
    """Multiply-adds x 2 of one forward of ``net`` on b x n points: each
    Conv3d over its grid, each Linear over the points (the global
    feature's over the batch)."""
    total = 0
    for name, m in net.named_modules():
        if isinstance(m, torch.nn.Conv3d):
            block = net.get_submodule(name.rsplit(".", 1)[0])
            total += (2 * b * block.resolution ** 3 * m.weight[0].numel() *
                      m.out_channels)
        elif isinstance(m, torch.nn.Linear):
            rows = b if name.startswith("cloud") else b * n
            total += 2 * rows * m.in_features * m.out_features
    return total


def _pv_coords(b, n, r, dev, gen, lattice=False):
    """[b, n, 3] voxel-unit coordinates on the card: uniform over [-0.5,
    r - 0.5] (some clipped at both ends), every 97th point on the cell at
    r - 1 (the lo clamp at r - 2), or with ``lattice`` multiples of 1/8 in
    [0, r - 1] (dyadic weights)."""
    if lattice:
        return torch.randint(0, 8 * (r - 1) + 1, (b, n, 3), device=dev,
                             generator=gen).float() / 8.0
    coords = torch.rand((b, n, 3), device=dev, generator=gen) * r - 0.5
    coords[:, ::97] = float(r - 1)
    return coords


def _grid_sample(grid, coords):
    """``F.grid_sample``'s trilinear interpolation of the channels-last
    grid at voxel-unit coords, its input and sample grid: (out [B, N, C],
    input [B, C, r, r, r], sample grid [B, 1, 1, N, 3])."""
    r = grid.shape[1]
    inp = grid.permute(0, 4, 1, 2, 3)
    # grid_sample's last axis is (W, H, D): z, y, x of the voxel grid
    sg = (coords.flip(-1) / (r - 1) * 2.0 - 1.0)[:, None, None]
    out = torch.nn.functional.grid_sample(
        inp, sg, mode="bilinear", padding_mode="border", align_corners=True)
    return out[:, :, 0, 0].transpose(1, 2), inp, sg


def _pv_grad64(g, coords, r):
    """The grid's gradient with each float32 product g * w summed in
    float64, as the reference of the kernel's float32 sums."""
    b, c = g.shape[0], g.shape[-1]
    out = torch.zeros((b * r**3, c), dtype=torch.float64, device=g.device)
    for rows, w in cdv.corner_weights(coords, r):
        out.index_add_(0, rows.reshape(-1),
                       (g * w[..., None]).reshape(-1, c).double())
    return out.reshape(b, r, r, r, c)


def _pv_plan_check(coords, r, label):
    """The card's plan of coords equal to the plain plan on the card;
    returns the card's."""
    plan = cdv.devoxelize_plan(coords, r)
    want = cdv.devoxelize_plan_plain(coords, r)
    for name in ("cell", "perm", "offsets", "weights"):
        if not torch.equal(getattr(plan, name), getattr(want, name)):
            raise AssertionError(f"pvcnn: devoxelize_plan {label}: {name} "
                                 f"differs from the plain plan's")
    return plan


def _pv_kernel_check(b, n, r, c, gen, on_cpu=True):
    """The devoxelisation kernels at one path shape against their plain
    versions on the card: the plan equal to the plain plan; the forward
    bit-equal on uniform coordinates; the backward bit-equal on lattice
    coordinates and small-integer cotangents, and on uniform coordinates
    and normal cotangents (with ``on_cpu``: once per distinct (r, C))
    bit-equal to ``devoxelize_grad_plain`` run on the CPU, the same bits
    in two runs, and within ``PV_BWD_TOL`` relative L2 of a float64 sum of
    the same products; times, bounds and ``grid_sample`` with its
    backward. Says the seconds the plan checks and the CPU reference
    took. Returns the (forward, backward, plan) records."""
    dev = torch.device(DEVICE)
    label = f"B={b} N={n} r={r} C={c}"
    grid = torch.randn((b, r, r, r, c), device=dev, generator=gen)
    coords = _pv_coords(b, n, r, dev, gen)
    t0 = time.perf_counter()
    plan = _pv_plan_check(coords, r, label)
    plan_s = time.perf_counter() - t0
    out = cdv.trilinear_devoxelize(grid, coords, plan)
    plain = cdv.devoxelize_plain(grid, coords)
    torch.cuda.synchronize()
    if not torch.equal(out, plain):
        raise AssertionError(f"pvcnn: trilinear_devoxelize {label} differs "
                             f"from its plain version by "
                             f"{(out - plain).abs().max().item()}")
    lib, inp, sg = _grid_sample(grid, coords)
    lib_err = (lib - plain).abs().max().item()
    ms, plain_ms, span, plain_span = timings(
        lambda: cdv.trilinear_devoxelize(grid, coords, plan),
        lambda: cdv.devoxelize_plain(grid, coords), PV_PLAIN_ITERS)
    lib_ms = device_ms(lambda: torch.nn.functional.grid_sample(
        inp, sg, mode="bilinear", padding_mode="border", align_corners=True))
    # the bound reads only the grid rows some point's corners touch
    rows = torch.cat([rows.reshape(-1)
                      for rows, _ in cdv.corner_weights(coords, r)])
    read = torch.unique(rows).numel()
    fwd = kernel_record(0.0, ms, plain_ms,
                        bound(read * c * grid.element_size() +
                              nbytes(coords, out), 16 * out.numel()),
                        lib_ms)
    pms, pplain_ms, pspan, _ = timings(
        lambda: cdv.devoxelize_plan(coords, r),
        lambda: cdv.devoxelize_plan_plain(coords, r), PV_PLAIN_ITERS)
    prec = kernel_record(0.0, pms, pplain_ms, bound(
        nbytes(coords, plan.cell, plan.perm, plan.offsets, plan.weights), 0))
    # the backward: dyadic inputs, bit-equal on the card
    lat = _pv_coords(b, n, r, dev, gen, lattice=True)
    t0 = time.perf_counter()
    lat_plan = _pv_plan_check(lat, r, f"{label} (lattice)")
    plan_s += time.perf_counter() - t0
    g_int = torch.randint(-4, 5, (b, n, c), device=dev,
                          generator=gen).float()
    got = cdv.devoxelize_grad(g_int, lat, r, lat_plan)
    want = cdv.devoxelize_grad_plain(g_int, lat, r)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"pvcnn: trilinear_devoxelize_bwd {label} on "
                             f"dyadic inputs differs from its plain version "
                             f"by {(got - want).abs().max().item()}")
    # real inputs: bit-equal to the plain version on the CPU, the same
    # bits twice, and within the stated bound of a float64 sum
    g = torch.randn((b, n, c), device=dev, generator=gen)
    got = cdv.devoxelize_grad(g, coords, r, plan)
    again = cdv.devoxelize_grad(g, coords, r, plan)
    if not torch.equal(got, again):
        raise AssertionError(f"pvcnn: trilinear_devoxelize_bwd {label}: two "
                             f"runs differ by "
                             f"{(got - again).abs().max().item()}")
    cpu_s = 0.0
    if on_cpu:
        t0 = time.perf_counter()
        _pv_cpu_check(got, g, coords, r, label)
        cpu_s = time.perf_counter() - t0
    ref = _pv_grad64(g, coords, r)
    rel = _rel_l2(got, ref)
    plain_rel = _rel_l2(cdv.devoxelize_grad_plain(g, coords, r), ref)
    if not rel <= PV_BWD_TOL:
        raise AssertionError(f"pvcnn: trilinear_devoxelize_bwd {label}: "
                             f"relative L2 {rel} from float64 > "
                             f"{PV_BWD_TOL}")
    bms, bplain_ms, bspan, bplain_span = timings(
        lambda: cdv.devoxelize_grad(g, coords, r, plan),
        lambda: cdv.devoxelize_grad_plain(g, coords, r), PV_PLAIN_ITERS)
    gout = g.transpose(1, 2)[:, :, None, None]
    blib_ms = device_ms(lambda: torch.ops.aten.grid_sampler_3d_backward(
        gout, inp, sg, 0, 1, True, [True, False]))
    bwd = kernel_record(float((got.double() - ref).abs().max()), bms,
                        bplain_ms, bound(nbytes(g, coords, got),
                                         16 * g.numel()), blib_ms)
    say("pvcnn", f"trilinear_devoxelize {label}: plan equal to the plain "
        f"plan, device {pms:.4f} ms (span {pspan:.4f}), bound "
        f"{prec['bound_ms']:.4f}, plain {pplain_ms:.4f}; forward "
        f"bit-equal; device {ms:.4f} ms (span {span:.4f}), bound "
        f"{fwd['bound_ms']:.4f} (the {read} of {b * r**3} cells read), "
        f"plain {plain_ms:.4f} (span {plain_span:.4f}), grid_sample "
        f"{lib_ms:.4f} (largest difference {lib_err:.3e}); backward: "
        f"bit-equal on dyadic inputs, and on uniform ones "
        f"{'bit-equal to the plain version on the CPU, ' if on_cpu else ''}"
        f"the same bits in two runs, relative L2 "
        f"{rel:.3e} from a float64 sum (the plain version's "
        f"{plain_rel:.3e}; bound {PV_BWD_TOL:g}); device {bms:.4f} ms "
        f"(span {bspan:.4f}), bound {bwd['bound_ms']:.4f}, plain "
        f"{bplain_ms:.4f} (span {bplain_span:.4f}), "
        f"grid_sampler_3d_backward {blib_ms:.4f}; host seconds: the plan "
        f"checks {plan_s:.2f}, the CPU reference {cpu_s:.2f}")
    return fwd, bwd, prec


def _pv_cpu_check(got, g, coords, r, label):
    """The card's grid gradient ``got`` bit-equal to
    ``devoxelize_grad_plain`` of the same inputs run on the CPU."""
    cpu = cdv.devoxelize_grad_plain(g.cpu(), coords.cpu(), r)
    if not torch.equal(got.cpu(), cpu):
        raise AssertionError(f"pvcnn: trilinear_devoxelize_bwd {label} "
                             f"differs from its plain version on the CPU by "
                             f"{(got.cpu() - cpu).abs().max().item()}")


def _pv_crowded_coords(b, n, r, dev, gen):
    """``_pv_coords`` with the first half of each sample's points in one
    lo cell, (r / 2, r / 2, r / 2): the longest list the plan's rank pass
    orders (its cost the square of a cell's count) and the longest chain
    the backward sums in order."""
    coords = _pv_coords(b, n, r, dev, gen)
    coords[:, :n // 2] = r // 2 + 0.99 * torch.rand(
        (b, n // 2, 3), device=dev, generator=gen)
    return coords


def _pv_crowded_check(b, n, r, c, gen):
    """The devoxelisation on ``_pv_crowded_coords``: the plan equal to
    the plain plan, the forward bit-equal to its plain version, the
    backward bit-equal to the plain version on the CPU; the plan's, the
    forward's and the backward's device times."""
    dev = torch.device(DEVICE)
    label = f"B={b} N={n} r={r} C={c}, half of each sample in one cell"
    coords = _pv_crowded_coords(b, n, r, dev, gen)
    grid = torch.randn((b, r, r, r, c), device=dev, generator=gen)
    plan = _pv_plan_check(coords, r, label)
    out = cdv.trilinear_devoxelize(grid, coords, plan)
    if not torch.equal(out, cdv.devoxelize_plain(grid, coords)):
        raise AssertionError(f"pvcnn: trilinear_devoxelize {label} differs "
                             f"from its plain version")
    g = torch.randn((b, n, c), device=dev, generator=gen)
    _pv_cpu_check(cdv.devoxelize_grad(g, coords, r, plan), g, coords, r,
                  label)
    pms, ms, bms = (device_ms(fn, iters=5) for fn in (
        lambda: cdv.devoxelize_plan(coords, r),
        lambda: cdv.trilinear_devoxelize(grid, coords, plan),
        lambda: cdv.devoxelize_grad(g, coords, r, plan)))
    most = int(plan.offsets.diff().max())
    say("pvcnn", f"trilinear_devoxelize {label} ({most} points): plan "
        f"equal to the plain plan, device {pms:.4f} "
        f"ms; forward bit-equal, {ms:.4f} ms; backward bit-equal to the "
        f"plain version on the CPU, {bms:.4f} ms")


class _RecordedDropout(torch.nn.Module):
    """Dropout at rate ``p`` whose keep masks the first net draws (from a
    seeded generator of its own) and a second net replays, in the order of
    the calls, after ``replay()``."""

    def __init__(self, p, seed=SEED):
        super().__init__()
        self.p, self.seed, self.masks, self.replaying = p, seed, [], False
        self.gen = None

    def replay(self):
        self.replaying = True

    def forward(self, x):
        if not self.training:
            return x
        if self.replaying:
            keep = self.masks.pop(0).to(x.device)
        else:
            if self.gen is None:
                self.gen = torch.Generator(device=x.device).manual_seed(
                    self.seed)
            keep = torch.rand(x.shape, device=x.device,
                              generator=self.gen) >= self.p
            self.masks.append(keep.cpu())
        return torch.where(keep, x / (1.0 - self.p), torch.zeros_like(x))


def _pv_layouts(net):
    """A list to which each forward of ``net`` appends, for each PVConv
    block, whether its voxel branch's output (``vbn1``'s) is
    channels-last: the layout the devoxelisation reads with no copy."""
    layouts = []
    for block in net.modules():
        if isinstance(block, tpv.PVConv):
            block.vbn1.register_forward_hook(
                lambda mod, args, out: layouts.append(out.is_contiguous(
                    memory_format=torch.channels_last_3d)))
    return layouts


def _check_layouts(layouts, blocks, what):
    if layouts != [True] * blocks:
        raise AssertionError(f"pvcnn: the voxel branches' outputs are not "
                             f"all channels-last on the card in {what}: "
                             f"{layouts}")


def _pv_forward(card, root):
    """The eval forward at the YAML's 4 x 40,960 on seeded weights: the
    voxel branches channels-last, launch counts, finite logits, the median
    of 10 (CUDA events), peak memory, the FLOP bound; the card against the
    CPU on the card's branches and voxel cells (a second card run under
    ``_SameBranches(net="pvcnn")``, which the CPU replays), within
    ``PV_TOL``. Returns (launches, median ms, the weights, the batch on
    the CPU)."""
    dev = torch.device(DEVICE)
    model = pv_model()
    net = model.get_net()
    state = random_weights(net, SEED).state_dict()
    net = net.eval().to(dev)
    batch_cpu = pv_request(model, root)
    batch = {k: v.to(dev) for k, v in batch_cpu.items()}
    b, n = batch["point"].shape[:2]
    shapes = pv_shapes(net)
    layouts = _pv_layouts(net)
    with torch.no_grad():
        net(batch)  # warm-up
        _check_layouts(layouts, len(shapes), "the eval forward")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        logits = net(batch)
        torch.cuda.synchronize()
        launches = read_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        with _SameBranches(net="pvcnn") as same:
            card_logits = net(batch)
            same.replay()
            cpu_net = model.get_net()
            cpu_net.load_state_dict(state)
            t0 = time.perf_counter()
            ref = cpu_net.eval()(batch_cpu)
            cpu_s = time.perf_counter() - t0
    check_counts("pvcnn", launches, PV_FORWARD_LAUNCHES)
    if tuple(logits.shape) != (b, n, model.cfg.num_classes):
        raise AssertionError(f"pvcnn logits {tuple(logits.shape)}")
    if not torch.isfinite(logits).all():
        raise AssertionError("pvcnn: non-finite logits")
    rel_l2, agree = _compare(card_logits, ref)
    say("pvcnn", f"eval forward B={b} N={n}, grids (r, C) {shapes}, "
        f"float32, each voxel branch channels-last out of cuDNN (so the "
        f"devoxelisation reads it with no copy): logits finite; card vs "
        f"CPU on the card's branches: relative L2 {rel_l2:.3e} (bound "
        f"{PV_TOL:g}), argmax agreement {agree:.6f}; of the {same.total} "
        f"choices the CPU's own values would have made {same.differ} "
        f"otherwise, {same.differ_cells} of them voxel-cell indices of "
        f"{b * n * 3 * len(shapes)} (CPU forward {cpu_s:.1f} s)")
    if not rel_l2 <= PV_TOL:
        raise AssertionError(f"pvcnn card vs CPU {rel_l2} > {PV_TOL}")
    ms, times = _pt_forward(net, batch)
    flops = pv_flops(net, b, n)
    floor = flops / PEAK_OPS_PER_S["float32"] * 1e3
    say("pvcnn", f"eval forward: median {ms:.3f} ms over {len(times)} runs "
        f"(min {min(times):.3f}, max {max(times):.3f}), "
        f"{b * n / ms * 1e3:.0f} points/s; FLOP bound {floor:.3f} ms "
        f"({flops / 1e9:.1f} GFLOP at 67 TFLOP/s float32: "
        f"{floor / ms:.1%} of it reached); peak device memory "
        f"{peak:.2f} GiB on {card}")
    return launches, ms, state, batch_cpu


def _pv_loss_fn(model, root):
    """``SemSegLoss`` with the class weights of the S3DIS reader of the
    rooms under ``root``."""
    return SemSegLoss(None, model,
                      DATASET.get("S3DIS")(dataset_path=str(root)))


def _pv_plain_devoxelize(grid, coords, plan):
    """``cdv.trilinear_devoxelize`` as PVConv calls it, by the plain
    version."""
    return cdv.devoxelize_plain(grid, coords)


def _pv_no_plan(coords, r):
    """``cdv.devoxelize_plan`` for the plain versions, which read none."""
    return None


def _pv_steps(state, batch_cpu, loss_fn, sides, global_bn_train=True):
    """One training step from the same weights and batch on each of
    ``sides`` ("card": float32 on the card, the kernels; "card64": float64
    on the card, the devoxelisation's plain versions (``devoxelize_plan``
    and ``trilinear_devoxelize``), which the kernels do not take;
    "cpu64": float64 on the CPU), every run after the first on the
    first's branches (``_SameBranches(net="pvcnn")``: ReLUs, LeakyReLUs,
    the max over the points and the voxel cells) and dropout masks; with
    ``global_bn_train`` false the global feature's two BatchNorms run on
    their running statistics. The card's float32 step is checked to take
    its voxel branches channels-last (``_pv_layouts``). Returns ({side:
    loss, gradients, BN statistics, seconds}, {side: choices its own
    values would have taken otherwise}, choices, the first run's
    launches)."""
    dev = torch.device(DEVICE)
    model = pv_model()
    drop = _RecordedDropout(0.3)
    out, differ = {}, {}
    with _SameBranches(net="pvcnn") as same:
        for i, side in enumerate(sides):
            f64 = side.endswith("64")
            where = dev if side.startswith("card") else torch.device("cpu")
            net = model.get_net()
            net.load_state_dict(state)
            net.dropout = drop
            net = net.to(where, torch.float64 if f64 else None).train()
            if not global_bn_train:
                net.cloud_bn0.eval()
                net.cloud_bn1.eval()
            layouts = _pv_layouts(net)
            x = {k: v.to(where, torch.float64 if f64 and
                         v.is_floating_point() else None)
                 for k, v in batch_cpu.items()}
            if i == 1:
                choices, masks = list(same.recorded), list(drop.masks)
                same.replay()
                drop.replay()
            elif i > 1:
                same.recorded, drop.masks = list(choices), list(masks)
                same.differ = 0
            plain = (mock.patch.multiple(
                cdv, devoxelize_plan=_pv_no_plan,
                trilinear_devoxelize=_pv_plain_devoxelize)
                     if side == "card64" else contextlib.nullcontext())
            reset_counts()
            t0 = time.perf_counter()
            with plain:
                loss, _, _ = model.get_loss(loss_fn, net(x), x)
                loss.backward()
            if where.type == "cuda":
                torch.cuda.synchronize()
            if side == "card":
                _check_layouts(layouts, len(pv_shapes(net)),
                               "a training step")
            if i == 0:
                launches = read_counts()
            else:
                differ[side] = same.differ
            grads = {k: p.grad.double().cpu() for k, p in
                     net.named_parameters()}
            out[side] = {
                "loss": loss.item(), "grads": grads,
                "grad": torch.cat([g.reshape(-1) for g in grads.values()]),
                "stats": torch.cat([
                    v.double().cpu().reshape(-1)
                    for k, v in net.state_dict().items()
                    if k.endswith(("running_mean", "running_var"))]),
                "s": time.perf_counter() - t0}
            del net, loss, x
        if same.recorded or drop.masks:
            raise AssertionError("pvcnn: a replayed step took fewer "
                                 "branches or dropouts than the first")
    return out, differ, same.total, launches


def _pv_apart(out, a, b):
    """Relative differences of step ``a`` from step ``b``."""
    a, b = out[a], out[b]
    return {"loss": abs(a["loss"] - b["loss"]) / abs(b["loss"]),
            "grad": _rel_l2(a["grad"], b["grad"]),
            "stats": _rel_l2(a["stats"], b["stats"])}


def _pv_line(d):
    return (f"loss {d['loss']:.3e}, gradients {d['grad']:.3e}, BN "
            f"statistics {d['stats']:.3e}")


def _pv_step_vs_cpu(state, batch_cpu, root):
    """One training step on the card in float32 (the kernels), on the card
    in float64 and on the CPU in float64, all on the card's branches
    (``_pv_steps``); and the same step with the global feature's
    BatchNorms on their running statistics, on the card in float32 and
    float64.

    Gates: the card's float64 step equals the CPU's within ``PV_F64_TOL``
    (one function on both devices); the card's float32 loss lies within
    ``PV_LOSS_TOL`` of float64 and its BN statistics within ``PV_TOL``;
    its gradients (one vector) within ``PV_STEP_F32_TOL``: the global
    feature's train-mode BatchNorm normalises over the batch's 4 samples,
    which puts any float32 gradients ~1e-4 from float64, on the CPU too;
    and with those two BatchNorms on their running statistics the card's
    float32 gradients lie within ``PV_TOL`` of float64. The card's two
    float32 readings are taken again on other weights (seed ``SEED`` + 1)
    and another batch (rooms 2-5), under the same gates. Returns the
    card's launch counts."""
    model = pv_model()
    loss_fn = _pv_loss_fn(model, root)
    out, differ, total, launches = _pv_steps(
        state, batch_cpu, loss_fn, ("card", "card64", "cpu64"))
    check_counts("pvcnn", launches, PV_STEP_LAUNCHES)
    held, _, held_total, _ = _pv_steps(
        state, batch_cpu, loss_fn, ("card", "card64"), global_bn_train=False)
    f64, card = _pv_apart(out, "card64", "cpu64"), _pv_apart(out, "card",
                                                            "card64")
    held_apart = _pv_apart(held, "card", "card64")
    state2 = random_weights(model.get_net(), SEED + 1).state_dict()
    batch2 = pv_request(model, root, PV_ROOMS[1:1 + PV_BATCH])
    other = {}
    for bn_train in (True, False):
        steps, _, _, _ = _pv_steps(state2, batch2, loss_fn, ("card", "card64"),
                                   global_bn_train=bn_train)
        other[bn_train] = _pv_apart(steps, "card", "card64")
    grads, ref = out["card"]["grads"], out["card64"]["grads"]
    diff2 = {k: ((grads[k] - ref[k]) ** 2).sum().item() for k in grads}
    total2 = max(sum(diff2.values()), 1e-300)
    worst = ", ".join(f"{k} {diff2[k] / total2:.0%} (its own "
                      f"{_rel_l2(grads[k], ref[k]):.2e})" for k in
                      sorted(diff2, key=diff2.get, reverse=True)[:3])
    say("pvcnn", f"training step B={batch_cpu['point'].shape[0]}, the "
        f"later runs on the card's branches ({total} choices; their own "
        f"values would have taken {differ['card64']} otherwise on the card "
        f"in float64, {differ['cpu64']} on the CPU): card float64 vs CPU "
        f"float64: {_pv_line(f64)} (bound {PV_F64_TOL:g}); card float32 vs "
        f"float64: {_pv_line(card)} (bounds: loss {PV_LOSS_TOL:g}, BN "
        f"statistics {PV_TOL:g}, gradients {PV_STEP_F32_TOL:g}); its "
        f"gradients' difference held most by {worst}; with the global "
        f"feature's BatchNorms on their running statistics ({held_total} "
        f"choices), card float32 vs float64: {_pv_line(held_apart)} "
        f"(gradients' bound {PV_TOL:g}); on seed {SEED + 1}'s weights and "
        f"rooms 2-5, card float32 vs float64: {_pv_line(other[True])}, and "
        f"with the global BatchNorms held {_pv_line(other[False])}; the "
        f"CPU's float64 step {out['cpu64']['s']:.1f} s, the card's "
        f"{out['card64']['s']:.1f} s")
    if not max(f64.values()) <= PV_F64_TOL:
        raise AssertionError(f"pvcnn: the card's float64 step vs the CPU's "
                             f"{f64} > {PV_F64_TOL}")
    for apart, held_apart in ((card, held_apart),
                              (other[True], other[False])):
        if not (apart["loss"] <= PV_LOSS_TOL and apart["stats"] <= PV_TOL
                and apart["grad"] <= PV_STEP_F32_TOL):
            raise AssertionError(f"pvcnn: the card's float32 step vs "
                                 f"float64: {apart}")
        if not held_apart["grad"] <= PV_TOL:
            raise AssertionError(f"pvcnn: with the global BatchNorms held, "
                                 f"the card's float32 gradients vs float64: "
                                 f"{held_apart['grad']} > {PV_TOL}")
    return launches


def _pv_step_events(state, batch_cpu, root, card):
    """``PV_TIMED_STEPS`` training steps (Adam at the YAML's rate) split
    by CUDA events into forward, loss, backward and Adam: the median of
    the steps after the first, their peak memory. Returns the median
    step ms."""
    dev = torch.device(DEVICE)
    model = pv_model()
    loss_fn = _pv_loss_fn(model, root)
    net = model.get_net()
    net.load_state_dict(state)
    net = net.to(dev)
    opt, _ = model.get_optimizer(PVCNN_PIPELINE, net)
    x = {k: v.to(dev) for k, v in batch_cpu.items()}
    parts = collections.defaultdict(list)
    totals, losses = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(PV_TIMED_STEPS):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        net.train()
        ev[0].record()
        out = net(x)
        ev[1].record()
        loss, _, _ = model.get_loss(loss_fn, out, x)
        ev[2].record()
        opt.zero_grad(set_to_none=True)
        loss.backward()
        ev[3].record()
        opt.step()
        ev[4].record()
        ev[4].synchronize()
        losses.append(loss.item())
        for k, part in enumerate(("forward", "loss", "backward", "adam")):
            parts[part].append(ev[k].elapsed_time(ev[k + 1]))
        totals.append(ev[0].elapsed_time(ev[4]))
    peak = torch.cuda.max_memory_allocated() / 2**30
    if not np.isfinite(losses).all():
        raise AssertionError(f"pvcnn: step losses {losses}")
    med = statistics.median(totals[1:])
    b, n = x["point"].shape[:2]
    say("pvcnn", f"training step B={b} x {n} (Adam): median {med:.3f} ms "
        f"over steps 2..{PV_TIMED_STEPS} (first {totals[0]:.3f}): " +
        ", ".join(f"{k} {statistics.median(v[1:]):.3f}"
                  for k, v in parts.items()) +
        f" ms; {b / med * 1e3:.2f} patches trained/s "
        f"({b * n / med * 1e3:.0f} points/s); losses "
        f"{[round(v, 4) for v in losses]}; peak {peak:.2f} GiB on {card}")
    return med


PV_RANGES = ("pv eval forward", "pv train forward", "pv backward",
             "pv adam")
# words in the names of cuDNN's convolution kernels (forward, data and
# weight gradients), not in those of cuBLAS's GEMMs
PV_CONV_KERNELS = ("conv", "fprop", "dgrad", "wgrad")


def pv_profile():
    """``--pvcnn-profile``: one torch.profiler pass over one eval forward
    and one training step at the YAML's 4 x 40,960 (seeded weights, the
    rooms of ``write_s3dis_rooms``), split by record_function ranges;
    prints one JSON line a range: device ms (kernel rows), kernels, wall
    ms, the devoxelisation kernels' and the convolutions' device ms, and
    the top 8 kernels. Run in a process of its own: the profiler traces
    the card once a process."""
    from torch.profiler import ProfilerActivity, profile, record_function
    phase_device()
    dev = torch.device(DEVICE)
    model = pv_model()
    net = random_weights(model.get_net(), SEED).to(dev)
    with tempfile.TemporaryDirectory() as tmp:
        write_s3dis_rooms(Path(tmp), PV_ROOM_POINTS, PV_ROOMS)
        x = {k: v.to(dev) for k, v in pv_request(model, Path(tmp)).items()}
        loss_fn = _pv_loss_fn(model, Path(tmp))
    opt, _ = model.get_optimizer(PVCNN_PIPELINE, net)

    def step(ranges=False):
        def scope(name):
            return (record_function(name) if ranges else
                    contextlib.nullcontext())
        net.eval()
        with scope("pv eval forward"), torch.no_grad():
            net(x)
            torch.cuda.synchronize()
        net.train()
        with scope("pv train forward"):
            loss, _, _ = model.get_loss(loss_fn, net(x), x)
            torch.cuda.synchronize()
        with scope("pv backward"):
            opt.zero_grad(set_to_none=True)
            loss.backward()
            torch.cuda.synchronize()
        with scope("pv adam"):
            opt.step()
            torch.cuda.synchronize()

    for _ in range(2):
        step()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(ranges=True)
    events = prof.events()
    for name in PV_RANGES:
        rng = next(e for e in events if e.name == name and
                   e.device_type == torch.autograd.DeviceType.CPU)
        start, end = rng.time_range.start, rng.time_range.end
        kernels, calls = collections.Counter(), collections.Counter()
        for e in events:
            if (e.device_type == torch.autograd.DeviceType.CUDA and
                    not e.name.startswith("pv ") and
                    start <= e.time_range.start <= end):
                kernels[e.name] += e.time_range.elapsed_us() / 1e3
                calls[e.name] += 1
        print(json.dumps({
            "range": name, "device_ms": sum(kernels.values()),
            "kernels": sum(calls.values()), "wall_ms": (end - start) / 1e3,
            "devoxelize_ms": sum(ms for k, ms in kernels.items()
                                 if "devoxelize" in k),
            "conv_ms": sum(ms for k, ms in kernels.items()
                           if any(w in k.lower() for w in PV_CONV_KERNELS)),
            "top": [[k[:64], ms, calls[k]]
                    for k, ms in kernels.most_common(8)]}), flush=True)


def _pv_profiles(card):
    """``pv_profile`` in a child process; prints each range's line and
    returns the busy share of the eval forward."""
    run = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                          "--pvcnn-profile"], cwd=REPO, capture_output=True,
                         text=True, timeout=600)
    if run.returncode != 0:
        raise AssertionError(f"pvcnn: the profiler run failed:\n"
                             f"{run.stderr[-4000:]}")
    records = [json.loads(line) for line in run.stdout.splitlines()
               if line.startswith('{"range"')]
    if len(records) != len(PV_RANGES) or any(r["device_ms"] <= 0
                                            for r in records):
        raise AssertionError(f"pvcnn: the profiler saw no device time: "
                             f"{run.stdout[-2000:]}")
    for r in records:
        busy = r["device_ms"] / r["wall_ms"]
        say("pvcnn", f"profiled {r['range']}: device {r['device_ms']:.3f} "
            f"ms over {r['kernels']} kernels in a {r['wall_ms']:.3f} ms "
            f"span (busy {busy:.1%}); trilinear_devoxelize kernels "
            f"{r['devoxelize_ms']:.3f} ms, convolution kernels "
            f"{r['conv_ms']:.3f} ms; top: " + ", ".join(
                f"{k} {ms:.3f} ms x{n}" for k, ms, n in r["top"]) +
            f" (on {card})")


def _pv_cli(card, root):
    """``run_pipeline.main`` with the port's ``pvcnn_s3dis.yml`` on the
    S3DIS rooms (areas 1-4 train, area 5 validates), ``--split train``:
    one epoch of ``PV_TRAIN_STEPS`` steps of the YAML's batch and
    validation steps, each step's launch counts, finite losses, every
    weight moved, the checkpoint; then a second run of one more epoch
    that resumes from it (the net and Adam state as saved); then
    ``--split test`` must raise, naming the ROADMAP item."""
    steps, valid_steps = PV_TRAIN_STEPS
    batch, val_batch = PVCNN_PIPELINE["batch_size"], \
        PVCNN_PIPELINE["val_batch_size"]
    common = ["-c", REPO / PVCNN_CONFIG, "--device", DEVICE,
              "--dataset.dataset_path", root,
              "--dataset.cache_dir", root / "cache",
              "--main_log_dir", root / "logs",
              "--dataset.steps_per_epoch_train", steps * batch,
              "--dataset.steps_per_epoch_valid", valid_steps * val_batch]
    first = {}
    real = SemanticSegmentation._train_step

    def step(self, inputs, loss_fn):
        if "net" not in first:
            first.update({k: v.detach().clone()
                          for k, v in self.net.state_dict().items()})
            torch.cuda.reset_peak_memory_stats()
        first["net"] = self.net
        return real(self, inputs, loss_fn)

    runs = []
    for epochs in (0, 1):
        first.clear()
        with mock.patch.object(SemanticSegmentation, "_train_step", step):
            wall, launches, record, spent = _cli_run(common + [
                "--split", "train", "--pipeline.max_epoch", epochs],
                ((tpv.PVCNN, "preprocess"),))
        peak = torch.cuda.max_memory_allocated() / 2**30
        train_s = _check_steps(record, 0, len(record), PV_STEP_LAUNCHES,
                               PV_FORWARD_LAUNCHES,
                               ["train"] * steps + ["eval"] * valid_steps)
        check_counts("pvcnn", launches, {
            k: PV_STEP_LAUNCHES.get(k, 0) * steps +
            PV_FORWARD_LAUNCHES.get(k, 0) * valid_steps
            for k in PV_STEP_LAUNCHES})
        after = first.pop("net").state_dict()
        weights = [k for k, v in first.items() if k.endswith("weight")]
        moved = [k for k in weights if not torch.equal(first[k], after[k])]
        if len(moved) != len(weights):
            raise AssertionError(f"pvcnn: {len(weights) - len(moved)} "
                                 f"weights did not move")
        ckpt = (root / "logs" / "PVCNN_S3DIS_torch" / "checkpoint" /
                f"ckpt_{epochs:05d}.pth")
        if not ckpt.exists():
            raise AssertionError(f"pvcnn: no checkpoint at {ckpt}")
        if epochs == 1:
            saved = torch.load(ckpt.with_name("ckpt_00000.pth"),
                               map_location="cpu", weights_only=True)
            if "epoch" not in saved or saved["epoch"] != 0:
                raise AssertionError("pvcnn: the first checkpoint's epoch")
            # the resumed run's first step started from the saved weights
            differ = [k for k, v in saved["model"].items()
                      if not torch.equal(v, first[k].cpu())]
            if differ:
                raise AssertionError(f"pvcnn: the resumed run started from "
                                     f"other weights: {differ[:4]}")
        pre_s = spent["PVCNN.preprocess"]
        runs.append((wall, train_s, record, peak, pre_s,
                     spent["PVCNN.preprocess calls"]))
    for name, (wall, train_s, record, peak, pre_s, calls) in zip(
            ("first epoch", "resumed epoch"), runs):
        steady = statistics.median(train_s)
        say("pvcnn", f"run_pipeline -c {PVCNN_CONFIG} --split train, "
            f"{name}: {steps} train steps of {batch} x "
            f"{PVCNN_S3DIS['num_points']} (Adam) and {valid_steps} "
            f"validation step(s) of {val_batch}, losses "
            f"{[round(r[4], 4) for r in record]}, finite; every weight "
            f"moved; each train step launched {PV_STEP_LAUNCHES}; step "
            f"median {steady * 1e3:.2f} ms; wall {wall:.3f} s, host "
            f"preprocess {pre_s:.3f} s over {calls} draws ({pre_s / wall:.1%} "
            f"of the run); peak {peak:.2f} GiB on {card}")
    say("pvcnn", "the resumed run started from ckpt_00000.pth's weights "
        "and wrote ckpt_00001.pth")
    reset_counts()
    try:
        run_pipeline.main([str(a) for a in common + ["--split", "test"]])
    except NotImplementedError as err:
        say("pvcnn", f"--split test refused: {err}")
        if "item 10" not in str(err):
            raise AssertionError("pvcnn: the refusal names no ROADMAP item")
    else:
        raise AssertionError("pvcnn: --split test did not raise")
    check_counts("pvcnn", read_counts(), {})


def phase_pvcnn(card):
    """PVCNN at the shipped S3DIS config: the devoxelisation pair at the
    path's four shapes against its plain versions (``_pv_kernel_check``),
    the eval forward at 4 x 40,960 (``_pv_forward``), one float32 step
    against the CPU (``_pv_step_vs_cpu``), timed steps
    (``_pv_step_events``), a profiled forward and step in a child process
    and the command line (``_pv_cli``). Returns (the forward's and the
    step's launch counts summed, the forward kernel's record, the
    backward's, the plan's: a forward's two plans)."""
    t_phase = time.perf_counter()
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    model = pv_model()
    shapes = pv_shapes(model.get_net())
    fwds, bwds, plans = [], [], {}
    n = model.cfg.num_points
    for i, (r, c) in enumerate(shapes):
        fwd, bwd, plan = _pv_kernel_check(PV_BATCH, n, r, c, gen,
                                          (r, c) not in shapes[:i])
        fwds.append(fwd)
        bwds.append(bwd)
        plans.setdefault(r, plan)  # a forward builds one plan a resolution
    _pv_crowded_check(PV_BATCH, n, *shapes[1], gen)
    seconds = {"kernel checks": time.perf_counter() - t_phase}
    fwd_rec, bwd_rec = combine(fwds), combine(bwds)
    plan_rec = combine(list(plans.values()))
    say("pvcnn", f"one forward's {len(fwds)} trilinear_devoxelize "
        f"launches: device {fwd_rec['ms']:.4f} ms, bound "
        f"{fwd_rec['bound_ms']:.4f}, plain {fwd_rec['plain_ms']:.4f}, "
        f"grid_sample {fwd_rec['library_ms']:.4f}; its {len(plans)} plans: "
        f"{plan_rec['ms']:.4f}, bound {plan_rec['bound_ms']:.4f}, plain "
        f"{plan_rec['plain_ms']:.4f}; launches and plans "
        f"{fwd_rec['ms'] + plan_rec['ms']:.4f} ms against the forward's "
        f"bound {fwd_rec['bound_ms']:.4f} "
        f"({(fwd_rec['ms'] + plan_rec['ms']) / fwd_rec['bound_ms']:.2f}x); "
        f"one step's {len(bwds)} backward launches: {bwd_rec['ms']:.4f}, "
        f"bound {bwd_rec['bound_ms']:.4f} "
        f"({bwd_rec['ms'] / bwd_rec['bound_ms']:.2f}x), plain "
        f"{bwd_rec['plain_ms']:.4f}, grid_sampler_3d_backward "
        f"{bwd_rec['library_ms']:.4f}")
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        t0 = time.perf_counter()
        write_s3dis_rooms(root, PV_ROOM_POINTS, PV_ROOMS)
        say("pvcnn", f"S3DIS rooms: {len(PV_ROOMS)} of {PV_ROOM_POINTS} "
            f"points written in {time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        launches, fwd_ms, state, batch_cpu = _pv_forward(card, root)
        say("pvcnn", f"the devoxelisation kernels' share of the "
            f"{fwd_ms:.3f} ms forward: {fwd_rec['ms'] / fwd_ms:.1%} (their "
            f"device times one by one)")
        seconds["forward"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        step_launches = _pv_step_vs_cpu(state, batch_cpu, root)
        seconds["step vs CPU"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        _pv_step_events(state, batch_cpu, root, card)
        seconds["timed steps"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        _pv_profiles(card)
        seconds["profiles"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        _pv_cli(card, root)
        seconds["command line"] = time.perf_counter() - t0
    total = {k: launches[k] + step_launches[k] for k in launches}
    say("pvcnn", f"phase {time.perf_counter() - t_phase:.1f} s: " + ", ".join(
        f"{k} {v:.1f}" for k, v in seconds.items()))
    return total, fwd_rec, bwd_rec, plan_rec


# ------------------------------------------------ RandLA's other four YAMLs

RC_CONFIGS = {"S3DIS": "open3d_ml_tpu_torch/configs/randlanet_s3dis.yml",
              "Semantic3D":
                  "open3d_ml_tpu_torch/configs/randlanet_semantic3d.yml",
              "Toronto3D": "open3d_ml_tpu_torch/configs/randlanet_toronto3d.yml",
              "ParisLille3D":
                  "open3d_ml_tpu_torch/configs/randlanet_parislille3d.yml",
              "Pandaset": "open3d_ml_tpu_torch/configs/randlanet_pandaset.yml"}
# the YAMLs that only the command line runs here: PandaSet's net is the
# main path's at 45,056 points, which slice, train, eval and inference
# hold card vs CPU
RC_CLI_ONLY = ("Pandaset",)
# the PandaSet reader gives the intensity as a feature, 3 + 1 input
# channels against the YAML's 3, in JAX too (ROADMAP.md queue 3)
RC_CLI_EXTRAS = {"Pandaset": CLI_RANDLANET_EXTRAS}
# one sequence of each of the PandaSet reader's default splits
PANDASET_SEQUENCES = {"training": "001", "validation": "122",
                      "test": "115"}
RC_BATCH = 4  # the YAMLs' batch_size: the fused forward's batch
RC_STEPS = (2, 1)  # the command line's train steps of 4, validation steps
RC_CLOUD_POINTS = 150_000  # each training and validation cloud
RC_TEST_POINTS = 300_000  # the test split's scan or room
RC_TOL = 1e-4  # card vs CPU: the eval logits' and a step's gradients' L2
RC_LOSS_TOL = 1e-5  # card vs CPU: a step's loss, relative
RC_HOST_POINTS = 10_240  # the host-pyramid step's patch (S3DIS's level 1)
SCU_HASH_BATCH = 2
TB_SCALARS = ("Training loss", "Validation loss", "Training accuracy",
              "Validation accuracy", "Training IoU", "Validation IoU")
TB_TEXTS = ("Description/Command line/text_summary",
            "Configuration/text_summary")
S3DIS_RC_ROOMS = ("Area_1_office_1", "Area_2_office_1", "Area_5_office_1")
# (class, colour, x0, x1, y0, y1, z0, z1) of each part of an 80 x 24 m
# street: road, two pavements, two facades, trees, cars, poles, and
# class-0 clutter in the air (the readers' unlabelled class)
STREET = ((1, (90, 90, 95), 0, 80, 6, 18, 0, 0),
          (2, (150, 140, 120), 0, 80, 0, 6, 0.15, 0.15),
          (2, (150, 140, 120), 0, 80, 18, 24, 0.15, 0.15),
          (5, (200, 170, 150), 0, 80, 0, 0, 0, 15),
          (5, (180, 160, 160), 0, 80, 24, 24, 0, 15),
          (3, (40, 120, 40), 10, 70, 3, 5, 3, 7),
          (8, (180, 30, 30), 20, 60, 8, 10, 0, 1.5),
          (6, (120, 120, 120), 5, 75, 19, 19.3, 0, 6),
          (0, (255, 255, 255), 0, 80, 0, 24, 16, 20))


def randla_yaml(name, **overrides):
    """``RandLANet`` at the model section of ``RC_CONFIGS[name]``, with
    ``overrides``."""
    cfg = Config.load_from_file(REPO / RC_CONFIGS[name]).model.to_dict()
    cfg.pop("name")
    return MODEL.get("RandLANet")(**dict(cfg, **overrides))


def fused_launches(cfg, n=None):
    """Kernel launches of one fused forward at ``n`` points (default
    ``num_points``): a neighbour search a level, and a pool search where
    the level's sub points are not rows ::ratio of its query blocks (its
    points no whole number of blocks); four gathers a level (two
    neighbour reads, the pool's, the upsample's)."""
    n = n or cfg.num_points
    knn = 0
    for ratio in cfg.sub_sampling_ratio[:cfg.num_layers]:
        knn += 1 + (cfg.block % ratio != 0 or n % cfg.block != 0)
        n //= ratio
    return {"bucket_knn": knn, "bucket_gather": 4 * cfg.num_layers}


def street_scene(n, seed, num_classes):
    """An 80 x 24 m street sampled with ``n`` points from ``seed``: the
    parts of ``STREET`` by area (a box's two largest extents), each a
    colour and a class below ``num_classes``, RGB with noise. Returns
    (xyz [n, 3] float64 from 0, rgb [n, 3] float 0-255, labels [n]
    int32)."""
    rng = np.random.default_rng(seed)
    area = np.array([np.prod(sorted((x1 - x0, y1 - y0, z1 - z0))[1:])
                     for _, _, x0, x1, y0, y1, z0, z1 in STREET])
    which = rng.choice(len(STREET), n, p=area / area.sum())
    box = np.array([s[2:] for s in STREET], np.float64)[which]
    xyz = box[:, 0::2] + rng.uniform(0, 1, (n, 3)) * (box[:, 1::2] -
                                                        box[:, 0::2])
    colour = np.array([s[1] for s in STREET], np.float64)[which]
    rgb = np.clip(colour + rng.normal(0, 12, (n, 3)), 0, 255).round()
    labels = np.array([s[0] % num_classes for s in STREET],
                      np.int32)[which]
    return xyz, rgb, labels


def write_semantic3d(root, n, test_n, seed=SEED):
    """A Semantic3D folder: two training scans, the validation scan the
    reader names (``bildstein_station3_xyz_intensity_rgb``), each of ``n``
    points with ``.labels`` (0-8), and one unlabelled test scan of
    ``test_n``; rows x y z intensity r g b."""
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    for name, count in (("scan_a", n), ("scan_b", n),
                        ("bildstein_station3_xyz_intensity_rgb", n),
                        ("scan_test", test_n)):
        seed += 1
        xyz, rgb, labels = street_scene(count, seed, 9)
        intensity = np.random.default_rng(seed).uniform(-1000, 1000, count)
        np.savetxt(root / f"{name}.txt",
                   np.concatenate([xyz, intensity[:, None], rgb], 1),
                   fmt="%.3f")
        if name != "scan_test":
            np.savetxt(root / f"{name}.labels", labels, fmt="%d")


def write_toronto3d(root, n, test_n, seed=SEED):
    """A Toronto3D folder: tiles L001, L003, L004 (training) of ``n``
    points and L002 (validation and test) of ``test_n``, as PLY with
    x, y, z at the reader's UTM offset, red, green, blue and
    scalar_Label (0-8)."""
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    offset = np.array(DATASET.get("Toronto3D").UTM_OFFSET, np.float64)
    for name, count in (("L001", n), ("L002", test_n), ("L003", n),
                        ("L004", n)):
        seed += 1
        xyz, rgb, labels = street_scene(count, seed, 9)
        write_ply(str(root / f"{name}.ply"),
                  [xyz + offset, rgb.astype(np.float32), labels],
                  ["x", "y", "z", "red", "green", "blue", "scalar_Label"])


def write_parislille3d(root, n, test_n, seed=SEED):
    """A ParisLille3D folder: ``training_10_classes`` Lille1, Paris
    (training) and Lille2 (validation) of ``n`` points with x, y, z and
    class (0-9), and ``test_10_classes/T1.ply`` of ``test_n`` points."""
    root = Path(root)
    (root / "training_10_classes").mkdir(parents=True, exist_ok=True)
    (root / "test_10_classes").mkdir(exist_ok=True)
    for name, count in (("Lille1", n), ("Lille2", n), ("Paris", n),
                        ("T1", test_n)):
        seed += 1
        xyz, _, labels = street_scene(count, seed, 10)
        if name == "T1":
            write_ply(str(root / "test_10_classes" / "T1.ply"),
                      [xyz.astype(np.float32)], ["x", "y", "z"])
        else:
            write_ply(str(root / "training_10_classes" / f"{name}.ply"),
                      [xyz.astype(np.float32), labels],
                      ["x", "y", "z", "class"])


def write_pandaset(root, n, seed=SEED):
    """A PandaSet folder: frame ``00`` of ``n`` points in each sequence of
    ``PANDASET_SEQUENCES``, as the dataset ships it: ``lidar/00.pkl.gz``,
    a pandas DataFrame of x, y, z, i (intensity 0-255), t and d, and
    ``annotations/semseg/00.pkl.gz``, a DataFrame of ``class`` (the
    street's classes plus 1, in 1-39). Returns the test frame's name."""
    import pandas as pd
    root = Path(root)
    for seq in PANDASET_SEQUENCES.values():
        seed += 1
        xyz, _, labels = street_scene(n, seed, 39)
        rng = np.random.default_rng(seed)
        (root / seq / "lidar").mkdir(parents=True, exist_ok=True)
        (root / seq / "annotations" / "semseg").mkdir(parents=True,
                                                       exist_ok=True)
        pd.DataFrame({"x": xyz[:, 0], "y": xyz[:, 1], "z": xyz[:, 2],
                      "i": rng.uniform(0, 255, n), "t": np.zeros(n),
                      "d": np.zeros(n)}).to_pickle(
                          root / seq / "lidar" / "00.pkl.gz")
        pd.DataFrame({"class": labels + 1}).to_pickle(
            root / seq / "annotations" / "semseg" / "00.pkl.gz")
    return f"{PANDASET_SEQUENCES['test']}_00"


def write_rc_data(name, root, n, test_n):
    """``name``'s reader's files under ``root`` (S3DIS: three rooms of
    ``test_n`` points, the last in the YAML's test area 5; PandaSet: a
    frame of ``n`` points a sequence); returns the name of the cloud the
    test split holds and its point count."""
    root = Path(root)
    if name == "S3DIS":
        write_s3dis_rooms(root, test_n, S3DIS_RC_ROOMS)
        return "Area_5_office_1", test_n
    if name == "Pandaset":
        return write_pandaset(root, n), n
    writer = {"Semantic3D": write_semantic3d, "Toronto3D": write_toronto3d,
              "ParisLille3D": write_parislille3d}[name]
    writer(root, n, test_n)
    return {"Semantic3D": "scan_test", "Toronto3D": "L002",
            "ParisLille3D": "T1"}[name], test_n


def read_predictions(name, folder, cloud):
    """The labels that ``name``'s ``save_test_result`` wrote for
    ``cloud`` under ``folder`` (PandaSet's without a folder of the
    dataset's name)."""
    if name == "Semantic3D":
        return np.loadtxt(Path(folder) / name / f"{cloud}.labels",
                          dtype=np.int64)
    if name == "Pandaset":
        return np.load(Path(folder) / f"{cloud}.npy")
    return np.load(Path(folder) / name / f"{cloud}.npy")


def rc_patch(model, b, seed=SEED):
    """``b`` patches of ``num_points`` of street scenes, recentred as the
    YAMLs do; features xyz, then RGB where ``in_channels`` is 6."""
    cfg = model.cfg
    coords, feats = [], []
    for i in range(b):
        xyz, rgb, _ = street_scene(cfg.num_points, seed + i, 9)
        xyz[:, :2] -= xyz[:, :2].mean(0)
        coords.append(xyz)
        feats.append(np.concatenate([xyz, rgb], 1)[:, :cfg.in_channels])
    return {"coords": torch.from_numpy(np.stack(coords).astype(np.float32)),
            "features": torch.from_numpy(np.stack(feats).astype(np.float32))}


def _knn_equal(label, args, kwargs):
    """bucket_knn against its plain version at one search, unchanged d2
    bit for bit and indices off d2 ties; checks only."""
    got = cb.knn_bucket(*args, **kwargs)
    want = cb.knn_bucket_plain(*args, **kwargs)
    torch.cuda.synchronize()
    if not torch.equal(got[1].view(torch.int32), want[1].view(torch.int32)):
        raise AssertionError(f"bucket_knn {label}: d2 differs from the "
                             "plain version")
    _differ_only_at_ties(f"bucket_knn {label}", got[0], want[0], want[1])


def _rc_kernels(model, pts):
    """The kernels at one of the YAMLs' point counts, on ``pts`` [4, N, 3]
    on the card: every bucket_knn search of the fused pyramid at the
    inference budget, checked and timed (``_knn_check``, on lattice
    points too), and at the training budget checked; bucket_gather at
    the level-0 neighbour (C 11) and pool (C 32) reads and
    bucket_gather_bwd at the same two of the training pyramid; knn_exact
    at the eval pyramid's four levels (``phase_knn_exact``). Returns the
    records: ({kernel: [records]}, [(label, gather)], [(label, bwd)])."""
    cfg = model.cfg
    n, seg = pts.shape[1], cfg.seg
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    lattice = lattice_points(pts.shape[0], n, SEED)
    budget = (cfg.infer_num_segs, cfg.infer_gather_segs)
    for label, args, kwargs in fused_searches(lattice, cfg, *budget):
        _knn_check(f"N={n} {label}", *args, **kwargs, lattice=True)
    knn = [_knn_check(f"N={n} {label}", *args, **kwargs)
           for label, args, kwargs in fused_searches(pts, cfg, *budget)]
    for label, args, kwargs in fused_searches(pts, cfg, cfg.num_segs,
                                              cfg.gather_segs):
        _knn_equal(f"N={n} S{cfg.num_segs} {label}", args, kwargs)
    say("randla_configs", f"bucket_knn N={n}: every search of the fused "
        f"pyramid at S{cfg.num_segs} equal to the plain version (d2 bit for "
        "bit, indices off d2 ties)")
    gathers, bwds = [], []
    for pyr_budget, out in (((cfg.infer_num_segs, cfg.infer_gather_segs),
                             gathers),
                            ((cfg.num_segs, cfg.gather_segs), bwds)):
        pyr = tb.build_bucket_pyramid(
            pts, cfg.num_neighbors, cfg.sub_sampling_ratio, seg=seg,
            qblock=cfg.block, num_segs=pyr_budget[0],
            gather_segs=pyr_budget[1])
        for label, name, c in (("level-0 neighbour", "nbr", 11),
                               ("level-0 pool", "pool", 2 *
                                cfg.dim_output[0])):
            sids, rel = pyr[f"{name}_seg_ids"][0], pyr[f"{name}_rel"][0]
            qb = pyr[f"{name}_qblock"][0]
            tag = f"RandLA N={n} {label}"
            if out is gathers:
                values = tb.pad_seg(torch.randn((pts.shape[0], n, c),
                                                generator=gen,
                                                device=DEVICE), seg)
                out.append((tag, _gather_check(f"N={n} {label}", values,
                                               sids, rel, seg, qb)))
            else:
                out.append((tag, _gather_bwd_check(
                    f"N={n} {label}", sids, rel, -(-n // seg) * seg, c, seg,
                    qb, gen)))
    exact = phase_knn_exact(cfg)
    return {"bucket_knn": knn, "knn_exact": [exact]}, gathers, bwds


def _rc_forward(name, model, card):
    """The fused forward at B = 4 at the inference budget on street
    patches: launch counts, logits, median ms. Returns (launches, the
    weights)."""
    cfg = model.cfg
    net = random_weights(model.get_net(), SEED)
    state = net.state_dict()
    net = net.eval().to(DEVICE)
    batch = {k: v.to(DEVICE) for k, v in rc_patch(model, RC_BATCH).items()}
    with torch.no_grad():
        net(batch)
        torch.cuda.synchronize()
        reset_counts()
        logits = net(batch)
        torch.cuda.synchronize()
        launches = read_counts()
    check_counts("randla_configs", launches, fused_launches(cfg))
    if (tuple(logits.shape) != (RC_BATCH, cfg.num_points, cfg.num_classes)
            or not torch.isfinite(logits).all()):
        raise AssertionError(f"randla_configs {name}: logits "
                             f"{tuple(logits.shape)}, finite "
                             f"{bool(torch.isfinite(logits).all())}")
    fwd, times = median_forward_s(net, batch)
    say("randla_configs", f"{name}: fused forward B={RC_BATCH} "
        f"N={cfg.num_points} in_channels {cfg.in_channels} classes "
        f"{cfg.num_classes} (S{cfg.infer_num_segs}/G{cfg.infer_gather_segs},"
        f" {cfg.compute_dtype}): logits finite; median {fwd * 1e3:.3f} ms "
        f"over {len(times)} runs (min {min(times) * 1e3:.3f}, max "
        f"{max(times) * 1e3:.3f}), {RC_BATCH * cfg.num_points / fwd:.0f} "
        f"points/s on {card}")
    return launches, state


def _rc_eval_vs_cpu(name, model, state, card):
    """The exact eval net at B = 1 on the card against the same weights on
    the CPU, float32 logits within ``RC_TOL`` relative L2. The CPU net
    reads the card's exact pyramid (``knn_on_device=False``): the
    pyramid's kernel is held bit-equal to its plain version apart, and
    both searches compute d2 as |q|^2 + |p|^2 - 2 q.p, which at tens of
    metres from the origin ranks near ties otherwise than the KD-tree's
    differences (the host pyramid of the port's KD-tree, printed beside,
    differs from it there). Returns the card's launches."""
    cfg = model.cfg
    sample = rc_patch(model, 1, seed=SEED + 10)
    net = model.get_eval_net()
    net.load_state_dict(state)
    net = net.eval().to(DEVICE)
    batch = {k: v.to(DEVICE) for k, v in sample.items()}
    with torch.no_grad():
        reset_counts()
        logits = net(batch)
        torch.cuda.synchronize()
        launches = read_counts()
        card_pyr = tn.build_knn_pyramid(batch["coords"], cfg.num_neighbors,
                                        cfg.sub_sampling_ratio)
    check_counts("randla_configs", launches,
                 {"knn_exact": cfg.num_layers})
    host = type(model)(**dict(cfg.to_dict(), knn_on_device=False))
    cpu_net = host.get_eval_net()
    cpu_net.load_state_dict(state)
    cpu_net.eval()
    t0 = time.perf_counter()
    kd_pyr = host._host_pyramid(sample["coords"][0].numpy())
    pyr_s = time.perf_counter() - t0
    given = {"coords_pyramid": [t.cpu() for t in card_pyr["coords"]],
             **{k: [t.cpu() for t in card_pyr[k]]
                for k in ("neighbor_indices", "sub_idx", "interp_idx")}}
    with torch.no_grad():
        t0 = time.perf_counter()
        ref = cpu_net(dict(sample, **given))
        cpu_s = time.perf_counter() - t0
        kd = cpu_net(dict(sample, **{k: [torch.from_numpy(a)[None]
                                         for a in v]
                                     for k, v in kd_pyr.items()}))
    rel_l2, agree = _compare(logits, ref)
    kd_l2, kd_agree = _compare(logits, kd)
    fwd, _ = median_forward_s(net, batch, runs=5, warmup=1)
    say("randla_configs", f"{name}: exact eval net B=1 N={cfg.num_points} "
        f"float32, card vs CPU on the card's pyramid: relative L2 "
        f"{rel_l2:.3e}, argmax agreement {agree:.6f} (CPU forward "
        f"{cpu_s:.2f} s); vs the CPU on the KD-tree's pyramid (built in "
        f"{pyr_s:.2f} s): {kd_l2:.3e}, {kd_agree:.6f}; card median "
        f"{fwd * 1e3:.3f} ms on {card}")
    if not rel_l2 <= RC_TOL:
        raise AssertionError(f"randla_configs {name}: eval logits card vs "
                             f"CPU relative L2 {rel_l2} > {RC_TOL}")
    return launches


def _tensorboard_check(folder):
    """The event files under ``folder`` hold the six scalar tags of the
    JAX package's ``save_logs`` and the command line and configuration as
    text; returns the scalar tags and their values' count."""
    from tensorboard.backend.event_processing.event_accumulator import (
        EventAccumulator)
    runs = sorted(Path(folder).iterdir())
    if len(runs) != 1:
        raise AssertionError(f"tensorboard: runs {runs}")
    acc = EventAccumulator(str(runs[0]))
    acc.Reload()
    tags = acc.Tags()
    missing = [t for t in TB_SCALARS if t not in tags["scalars"]]
    missing += [t for t in TB_TEXTS if t not in tags["tensors"]]
    if missing:
        raise AssertionError(f"tensorboard: {runs[0].name} lacks {missing}")
    values = {t: [e.value for e in acc.Scalars(t)] for t in TB_SCALARS}
    if not all(np.isfinite(v).all() and v for v in values.values()):
        raise AssertionError(f"tensorboard: scalars {values}")
    return runs[0].name, values


def _rc_cli(name, root, card):
    """``run_pipeline.main`` on ``name``'s YAML and reader files: train
    (2 steps of 4 and 1 validation step of 2, each step's launches), then
    test with its checkpoint on the test split's cloud (the possibility
    map until covered, each eval forward 4 ``knn_exact`` launches), the
    predictions in the reader's format. Returns (launch counts summed,
    the TensorBoard folder)."""
    steps, valid_steps = RC_STEPS
    model_cfg = randla_yaml(name).cfg
    t0 = time.perf_counter()
    cloud, test_n = write_rc_data(name, root / "data", RC_CLOUD_POINTS,
                                  RC_TEST_POINTS)
    written_s = time.perf_counter() - t0
    common = ["-c", REPO / RC_CONFIGS[name], "--device", DEVICE,
              "--dataset.dataset_path", root / "data",
              "--dataset.cache_dir", root / "cache",
              "--dataset.test_result_folder", root / "test",
              "--main_log_dir", root / "logs",
              "--pipeline.train_sum_dir", root / "tb",
              *RC_CLI_EXTRAS.get(name, ())]
    host = ((trl.RandLANet, "preprocess"), (trl.RandLANet, "transform"))
    wall, launches, record, spent = _cli_run(common + [
        "--split", "train", "--pipeline.max_epoch", 0,
        "--dataset.steps_per_epoch_train", steps * 4,
        "--dataset.steps_per_epoch_valid", valid_steps * 2], host)
    fused = fused_launches(model_cfg)
    step_launches = dict(fused, bucket_gather_bwd=4 * model_cfg.num_layers)
    train_s = _check_steps(record, 0, len(record), step_launches, fused,
                           ["train"] * steps + ["eval"] * valid_steps)
    total = collections.Counter({k: v * steps
                                 for k, v in step_launches.items()})
    for k, v in fused.items():
        total[k] += v * valid_steps
    check_counts("randla_configs", launches, dict(total))
    ckpt = (root / "logs" / f"RandLANet_{name}_torch" / "checkpoint" /
            "ckpt_00000.pth")
    if not ckpt.exists():
        raise AssertionError(f"randla_configs {name}: no checkpoint")
    host_s = spent["RandLANet.preprocess"] + spent["RandLANet.transform"]
    say("randla_configs", f"{name}: reader files written in "
        f"{written_s:.2f} s; run_pipeline -c {RC_CONFIGS[name]} --split "
        f"train --pipeline.max_epoch 0: wall {wall:.3f} s; {steps} train "
        f"steps of 4 x {model_cfg.num_points} (S{model_cfg.num_segs}/"
        f"G{model_cfg.gather_segs}) {[round(s * 1e3, 3) for s in train_s]} "
        f"ms, {valid_steps} validation step(s) of 2, losses "
        f"{[round(r[4], 4) for r in record]}, finite; host preprocess + "
        f"transform {host_s:.3f} s ({host_s / wall:.1%} of the run)")

    forwards = collections.Counter()
    real_forward = trl.RandLANetNet.forward

    def counted(self, *args, **kwargs):
        forwards[self.knn_method] += 1
        return real_forward(self, *args, **kwargs)

    with mock.patch.object(trl.RandLANetNet, "forward", counted):
        test_wall, test_launches, _, spent = _cli_run(common + [
            "--split", "test", "--ckpt_path", ckpt], host)
    check_counts("randla_configs", test_launches,
                 {"knn_exact": model_cfg.num_layers * forwards["exact"]})
    pred = read_predictions(name, root / "test", cloud)
    top = model_cfg.num_classes + len(model_cfg.ignored_label_inds)
    if pred.shape != (test_n,) or pred.min() < 0 or pred.max() >= top:
        raise AssertionError(f"randla_configs {name}: predictions "
                             f"{pred.shape} in [{pred.min()}, {pred.max()}]")
    host_share = (spent["RandLANet.preprocess"] +
                  spent["RandLANet.transform"]) / test_wall
    say("randla_configs", f"{name}: --split test on {cloud} ({test_n} "
        f"points): wall {test_wall:.3f} s, {1 / test_wall:.3f} scans/s, "
        f"{forwards['exact']} exact eval forwards of 1 x "
        f"{model_cfg.num_points}; host preprocess + transform "
        f"{host_share:.1%} of the run; {pred.shape[0]} labels written in "
        f"the reader's format, in [0, {top}) on {card}")
    for k, v in test_launches.items():
        total[k] += v
    return total, root / "tb"


def _host_step_vs_cpu(root):
    """One float32 training step of RandLA-Net at the S3DIS YAML's widths
    on the host pyramid (``knn_on_device=False``), 1 x ``RC_HOST_POINTS``
    of an S3DIS room, on the card and on the CPU from the same weights,
    batch and dropout mask, the CPU on the card's max-pool and LeakyReLU
    branches. Returns (loss relative difference, gradient relative L2,
    statistics relative L2, launches on the card, CPU seconds, the
    branches' record)."""
    model = randla_yaml("S3DIS", compute_dtype="float32",
                        knn_on_device=False, num_points=RC_HOST_POINTS,
                        seed=SEED)
    dataset = DATASET.get("S3DIS")(
        dataset_path=str(root / "data"), cache_dir=str(root / "cache"),
        test_area_idx=5)
    split = dataset.get_split("train")
    loader = PointCloudDataloader(split, preprocess=model.preprocess,
                                  transform=model.transform,
                                  sampler=split.sampler)
    split.sampler.initialize_with_dataloader(loader)
    model.trans_point_sampler = split.sampler.get_point_sampler()
    batch = DefaultBatcher().collate_fn([loader[0]])
    keep = torch.rand((1, RC_HOST_POINTS, 32),
                      generator=torch.Generator().manual_seed(SEED)) >= 0.5
    out, state = {}, None
    with _SameBranches() as branches:
        for device in (DEVICE, "cpu"):
            pipeline = SemanticSegmentation(
                model, dataset=dataset, device=device, seed=SEED,
                main_log_dir=str(root / "logs"), **TRAIN_PIPELINE)
            if state is None:
                state = {k: v.cpu().clone()
                         for k, v in pipeline.net.state_dict().items()}
            pipeline.net.load_state_dict(state)
            pipeline.net.dropout = _FixedDropout(keep)
            pipeline.optimizer, pipeline.scheduler = model.get_optimizer(
                pipeline.cfg, pipeline.net)
            reset_counts()
            t0 = time.perf_counter()
            loss, _ = pipeline._train_step(
                pipeline._device_batch(batch),
                SemSegLoss(pipeline, model, dataset))
            seconds = time.perf_counter() - t0
            net = pipeline.net
            out[device] = {
                "loss": loss.double().cpu(),
                "grad": torch.cat([p.grad.reshape(-1).cpu()
                                   for p in net.parameters()]),
                "stats": torch.cat([b.reshape(-1).cpu() for k, b in
                                    net.state_dict().items()
                                    if k.endswith(("running_mean",
                                                   "running_var"))]),
                "seconds": seconds, "launches": read_counts()}
            if device == DEVICE:
                branches.replay()
        if branches.recorded:
            raise AssertionError("randla_configs: the CPU step took fewer "
                                 "branches than the card's")
    gpu, cpu = out[DEVICE], out["cpu"]
    return ((abs(gpu["loss"] - cpu["loss"]) / abs(cpu["loss"])).item(),
            _rel_l2(gpu["grad"], cpu["grad"]),
            _rel_l2(gpu["stats"], cpu["stats"]), gpu["launches"],
            cpu["seconds"], branches)


def _scu_hash_step_vs_cpu(root):
    """One float32 training step of SparseConvUnet at the shipped widths
    on the hash path (``conv_method="hash"``), B = 2 of the 6 m room
    request (``scu_scene``, two seeds, the test split's preprocess and
    transform), on the card and on the CPU from the same weights, the CPU
    on the card's ReLU branches. Returns (loss relative difference,
    gradient relative L2, statistics relative L2, the statistics' relative
    move, CPU seconds, card seconds, the branches' record)."""
    model = MODEL.get("SparseConvUnet")(compute_dtype="float32",
                                        conv_method="hash", seed=SEED)
    attr = {"split": "test"}
    batch = DefaultBatcher().collate_fn([
        model.transform(model.preprocess(scu_scene(
            SCU_ROOM_EXTENT_M, model.cfg.num_points, SEED + i), attr), attr)
        for i in range(SCU_HASH_BATCH)])
    dataset = DATASET.get("Custom3D")(dataset_path=str(root),
                                      cache_dir=str(root / "cache"))
    out, state = [], None
    with _SameBranches(net="scu") as branches:
        for device in (DEVICE, "cpu"):
            pipeline = SemanticSegmentation(model, dataset=dataset,
                                            device=device, seed=SEED,
                                            main_log_dir=str(root / "logs"),
                                            **SCU_TRAIN_PIPELINE)
            if state is None:
                state = {k: v.cpu().clone()
                         for k, v in pipeline.net.state_dict().items()}
            pipeline.net.load_state_dict(state)
            pipeline.optimizer, pipeline.scheduler = model.get_optimizer(
                pipeline.cfg, pipeline.net)
            t0 = time.perf_counter()
            loss, _ = pipeline._train_step(
                {k: torch.from_numpy(v).to(device) for k, v in batch.items()
                 if isinstance(v, np.ndarray)},
                SemSegLoss(pipeline, model, dataset))
            if device == DEVICE:
                torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            net = pipeline.net
            out.append({
                "loss": loss.double().cpu(),
                "grad": torch.cat([p.grad.reshape(-1).cpu()
                                   for p in net.parameters()]),
                "stats": torch.cat([b.reshape(-1).cpu()
                                    for k, b in net.state_dict().items()
                                    if k.endswith(("running_mean",
                                                   "running_var"))]),
                "seconds": seconds})
            if len(out) == 1:
                branches.replay()
        if branches.recorded:
            raise AssertionError("randla_configs: the CPU hash step took "
                                 "fewer branches than the card's")
    gpu, cpu = out
    before = torch.cat([v.reshape(-1) for k, v in state.items()
                        if k.endswith(("running_mean", "running_var"))])
    return ((abs(gpu["loss"] - cpu["loss"]) / abs(cpu["loss"])).item(),
            _rel_l2(gpu["grad"], cpu["grad"]),
            _rel_l2(gpu["stats"], cpu["stats"]),
            _rel_l2(gpu["stats"], before), cpu["seconds"], gpu["seconds"],
            branches)


def _rc_s3dis_extras(root, tb_dir):
    """After the S3DIS command line: its TensorBoard events read back, and
    the host-pyramid step against the CPU on its rooms."""
    run, values = _tensorboard_check(tb_dir)
    say("randla_configs", f"TensorBoard {run}: the six scalars " +
        ", ".join(f"{t} {v}" for t, v in values.items()) +
        "; the command line and the configuration as text")
    loss, grad, stats, launches, cpu_s, branches = _host_step_vs_cpu(root)
    say("randla_configs", f"host-pyramid step (S3DIS YAML, knn_on_device "
        f"false, float32, 1 x {RC_HOST_POINTS}): card vs CPU loss "
        f"{loss:.3e}, gradients {grad:.3e}, BN statistics {stats:.3e} "
        f"relative L2 (CPU step {cpu_s:.2f} s; {branches.total} branch "
        f"choices replayed, {branches.differ} the CPU's own values would "
        f"have made otherwise); launches {launches}")
    if not (loss <= RC_LOSS_TOL and grad <= RC_TOL and stats <= RC_TOL):
        raise AssertionError("randla_configs: host-pyramid step card vs CPU "
                             "past its bounds")
    if any(launches.values()):
        raise AssertionError("randla_configs: the host-pyramid step "
                             "launched a kernel")


def phase_randla_configs(card):
    """RandLA-Net at the five other shipped YAMLs (S3DIS, Semantic3D,
    Toronto3D, ParisLille3D, Pandaset), full width, seeded random
    weights: the kernels at their two point counts (40,960 and 65,536)
    against their plain versions; per YAML but those of ``RC_CLI_ONLY``
    the fused forward at B = 4 (its launches and median) and the exact
    eval net at B = 1 against the CPU; per YAML the command line's train
    and test on the reader's own files (the TensorBoard events read back
    after S3DIS and PandaSet); one host-pyramid step at the S3DIS
    YAML and one SparseConvUnet hash-path step at B = 2, each against the
    CPU. Returns (the main paths' launches summed, {kernel: [records]},
    the gather's and its backward's (label, record) pairs)."""
    t_phase = time.perf_counter()
    seconds = collections.Counter()
    records = collections.defaultdict(list)
    gathers, bwds = [], []
    launches = collections.Counter()
    checked = set()
    for name in RC_CONFIGS:
        t0 = time.perf_counter()
        if name in RC_CLI_ONLY:
            with tempfile.TemporaryDirectory() as tmp:
                cli_launches, tb_dir = _rc_cli(name, Path(tmp), card)
                launches.update(cli_launches)
                run, _ = _tensorboard_check(tb_dir)
            say("randla_configs", f"{name}: TensorBoard {run}: the six "
                "scalars, finite, and the text read back")
            seconds[f"{name} command line"] = time.perf_counter() - t0
            continue
        model = randla_yaml(name)
        n = model.cfg.num_points
        if n not in checked:
            checked.add(n)
            t0 = time.perf_counter()
            pts = rc_patch(model, RC_BATCH)["coords"].to(DEVICE)
            recs, g, bw = _rc_kernels(model, pts)
            for k, v in recs.items():
                records[k] += v
            gathers += g
            bwds += bw
            seconds["kernel checks"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        fwd_launches, state = _rc_forward(name, model, card)
        launches.update(fwd_launches)
        seconds["forwards"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        _rc_eval_vs_cpu(name, model, state, card)
        seconds["eval vs CPU"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            root = Path(tmp)
            cli_launches, tb_dir = _rc_cli(name, root, card)
            launches.update(cli_launches)
            seconds["command line"] += time.perf_counter() - t0
            if name == "S3DIS":
                t0 = time.perf_counter()
                _rc_s3dis_extras(root, tb_dir)
                seconds["events and host-pyramid step"] += (
                    time.perf_counter() - t0)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        loss, grad, stats, moved, cpu_s, gpu_s, branches = (
            _scu_hash_step_vs_cpu(Path(tmp)))
    say("randla_configs", f"SparseConvUnet hash-path train step (B="
        f"{SCU_HASH_BATCH} x 65,536 of the 6 m room, float32): card vs CPU "
        f"loss {loss:.3e}, gradients {grad:.3e}, BN running statistics "
        f"{stats:.3e} relative L2 (moved {moved:.3e} by the step); card "
        f"{gpu_s:.3f} s, CPU {cpu_s:.2f} s; {branches.total} ReLU choices "
        f"replayed, {branches.differ} the CPU's own values would have made "
        "otherwise")
    if not (loss <= RC_LOSS_TOL and grad <= RC_TOL and stats <= RC_TOL):
        raise AssertionError("randla_configs: SCU hash step card vs CPU "
                             "past its bounds")
    seconds["SCU hash step"] = time.perf_counter() - t0
    say("randla_configs", f"phase {time.perf_counter() - t_phase:.1f} s: " +
        ", ".join(f"{k} {v:.1f}" for k, v in seconds.items()))
    return dict(launches), records, gathers, bwds


# the sources ``--vs-parent`` builds from an earlier commit, where DIR
# holds them
# ------------------------------------------------------------- pp_configs

# pp_configs: each config's frames by split (pp_scene seeds; the train
# split two steps of the YAMLs' 6), the configs whose net runs, the
# config of the float32 step, and the phase's launches: one decode in
# each net's gates, and in Lyft's and nuScenes' command lines one a
# validation frame and one a test frame
PPC_FRAMES = {"train": 12, "val": 1, "test": 2}
PPC_NETS = ("lyft", "nuscenes", "argoverse")
PPC_STEP = "nuscenes"
PPC_TOL = 1e-4  # float32 card vs CPU; the step's gradients vs float64
PPC_CANVAS_TOL = 1e-5  # canvas vs compact, float32, where no cap binds
PPC_LAUNCHES = {"nms_bev": len(PPC_NETS) + 2 * (PPC_FRAMES["val"] +
                                                PPC_FRAMES["test"])}
PPC_WRITERS = {"lyft": write_nuscenes, "nuscenes": write_nuscenes,
               "waymo": write_waymo, "argoverse": write_argoverse}
PPC_READERS = {"lyft": "Lyft", "nuscenes": "NuScenes", "waymo": "Waymo",
               "argoverse": "Argoverse"}


def ppc_section(name, section="model"):
    """A section of the port's YAML of config ``name``, as keyword
    arguments: the model's but its name and checkpoint, the pipeline's
    but its name, directories and epochs."""
    cfg = Config.load_from_file(REPO / PP_CONFIGS[name])[section].to_dict()
    drop = ("name", "ckpt_path", "main_log_dir", "train_sum_dir",
            "max_epoch")
    return {k: v for k, v in cfg.items() if k not in drop}


def ppc_model(name, **overrides):
    return MODEL.get("PointPillars")(**ppc_section(name), seed=SEED,
                                     **overrides)


def write_ppc_data(name, root):
    """``PPC_FRAMES`` frames of config ``name`` in its reader's format
    under ``root`` (``pp_scene`` seeds from 300 + 100 i); its dataset."""
    base = 300 + 100 * list(PP_CONFIGS).index(name)
    frames, seed = {}, base
    for split, count in PPC_FRAMES.items():
        frames[split] = list(range(seed, seed + count))
        seed += count
    PPC_WRITERS[name](root, ppc_section(name), frames)
    return DATASET.get(PPC_READERS[name])(
        dataset_path=str(root), test_result_folder=str(root / "results"))


def _four_columns(data):
    """A frame of 3 columns (Argoverse's) with a zero intensity column."""
    pts = data["point"]
    if pts.shape[1] == 3:
        pts = np.concatenate([pts, np.zeros((len(pts), 1), np.float32)], 1)
    return dict(data, point=pts)


def ppc_request(model, dataset):
    """The test split's first frame through preprocess and transform, a
    batch of the YAMLs' ``test_batch_size`` 1 (numpy); Argoverse's with
    a zero intensity column (``_four_columns``)."""
    split = dataset.get_split("test")
    attr = split.get_attr(0)
    sample = model.transform(
        model.preprocess(_four_columns(split.get_data(0)), attr), attr)
    return {"point": sample["point"][None],
            "point_count": np.array([sample["point_count"]], np.int32)}


@contextlib.contextmanager
def uncounted():
    """Launches inside are not counted: each count is restored after."""
    saved = [dict(counts) for counts in COUNTERS]
    try:
        yield
    finally:
        for counts, before in zip(COUNTERS, saved):
            counts.update(before)


def _ppc_nets(name, dataset, card):
    """Config ``name``'s serving net (canvas, bf16) and eval net (compact,
    float32) on one frame: the eval net and the canvas net at float32 card
    vs CPU, canvas vs compact at float32 where no cap binds, bf16 vs
    float32 (``PP_BF16_BOUND``), the decode on the card (its ``nms_bev``
    call captured) against the CPU's, median forwards and peak memory. Returns (its record, the nets and the
    batch, kept for the profile)."""
    model = ppc_model(name)
    serve = model.get_net(training=False)
    state = pp_random_weights(serve).state_dict()
    nets = {"canvas bf16": serve,
            "canvas float32": ppc_model(name, compute_dtype="float32")
            .get_net(training=False),
            "compact float32": model.get_eval_net()}
    for net in nets.values():
        net.load_state_dict(state)
        net.eval().to(DEVICE)
    batch = ppc_request(model, dataset)
    x = _pp_batch(batch)
    cfg = model.cfg
    classes = len(model.classes)
    anchors = model._anchors()
    say("pp_configs", f"{name}: {classes} classes, canvas "
        f"{model.output_shape[0]} x {model.output_shape[1]}, "
        f"{anchors[..., 0].size:,} anchors ({anchors.shape[2]} sizes x "
        f"{anchors.shape[3]} rotations a cell of the "
        f"{anchors.shape[0]} x {anchors.shape[1]} map), max_num_points "
        f"{model.max_num_points}, max_voxels {model.max_voxels}; test frame "
        f"0 of the reader: {int(batch['point_count'][0])} points of "
        f"{cfg.max_points}")

    compact = _pp_outputs(nets["compact float32"], x)
    cpu_net = model.get_eval_net()
    cpu_net.load_state_dict(state)
    t0 = time.perf_counter()
    cpu = _pp_outputs(cpu_net.eval(), {k: torch.from_numpy(v)
                                       for k, v in batch.items()})
    cpu_s = time.perf_counter() - t0
    rel = _pp_rel(compact, cpu)
    say("pp_configs", f"{name} compact float32 card vs CPU: relative L2 "
        f"{rel:.3e} (bound {PPC_TOL:g}; CPU forward {cpu_s:.1f} s)")
    if not rel <= PPC_TOL:
        raise AssertionError(f"pp_configs {name}: card vs CPU {rel}")

    canvas32 = _pp_outputs(nets["canvas float32"], x)
    cpu_net = ppc_model(name, compute_dtype="float32").get_net(
        training=False)
    cpu_net.load_state_dict(state)
    rel = _pp_rel(canvas32, _pp_outputs(cpu_net.eval(), {
        k: torch.from_numpy(v) for k, v in batch.items()}))
    say("pp_configs", f"{name} canvas float32 card vs CPU: relative L2 "
        f"{rel:.3e} (bound {PPC_TOL:g})")
    if not rel <= PPC_TOL:
        raise AssertionError(f"pp_configs {name}: canvas card vs CPU {rel}")

    (most, pillars), = _pp_occupancy(model, batch)
    rel = _pp_rel(canvas32, compact)
    binds = most > model.max_num_points or pillars > model.max_voxels[1]
    say("pp_configs", f"{name} canvas vs compact, float32 on the card: "
        f"relative L2 {rel:.3e}; the largest pillar holds {most} points "
        f"(cap {model.max_num_points}), {pillars} pillars (cap "
        f"{model.max_voxels[1]}): " +
        ("a cap binds, so the nets differ by design: reported, not "
         "compared" if binds else f"no cap binds (bound {PPC_CANVAS_TOL:g})"))
    if not binds and not rel <= PPC_CANVAS_TOL:
        raise AssertionError(f"pp_configs {name}: canvas vs compact {rel}")
    bf16 = _pp_rel(_pp_outputs(nets["canvas bf16"], x), canvas32)
    say("pp_configs", f"{name} canvas bf16 vs float32 on the card: "
        f"relative L2 {bf16:.3e} (bound {PP_BF16_BOUND})")
    if not 0 < bf16 <= PP_BF16_BOUND:
        raise AssertionError(f"pp_configs {name}: bf16 vs float32 {bf16}")

    found = []
    calls = _captured(cnms, "nms_bev",
                      lambda: found.append(model.get_bboxes(*compact)))
    if len(calls) != 1:
        raise AssertionError(f"pp_configs {name}: {len(calls)} nms_bev calls")
    card_dec = found[0]
    cpu_dec = model.get_bboxes(*[o.cpu() for o in compact])
    valid = card_dec[3].cpu()
    same = (torch.equal(valid, cpu_dec[3]) and
            torch.equal(card_dec[2].cpu(), cpu_dec[2]))
    diff = (card_dec[0].cpu()[valid] - cpu_dec[0][valid]).abs()
    drel = (diff / cpu_dec[0][valid].abs().clamp(min=1)).max().item() \
        if valid.any() else 0.0
    boxes = calls[0][0][0]
    say("pp_configs", f"{name} decode on the card: one nms_bev call over "
        f"{boxes.shape[0]} rows (B x {classes} classes) of "
        f"{boxes.shape[1]} candidates; {int(valid.sum())} detections, the "
        f"CPU's decode the same kept set {same}, boxes within {drel:.3e} "
        f"of max(1, |v|) (bound 1e-5)")
    if not same or not drel <= 1e-5:
        raise AssertionError(f"pp_configs {name}: decode card vs CPU")

    times = {}
    for key in ("canvas bf16", "compact float32"):
        torch.cuda.reset_peak_memory_stats()
        fwd, runs = median_forward_s(nets[key], x)
        times[key] = (fwd, min(runs), max(runs),
                      torch.cuda.max_memory_allocated())
    return ({"nms_args": calls[0][0], "times": times, "most": most,
             "binds": binds}, (nets, x))


def ppc_profile(nets_and_batches):
    """One torch.profiler pass over one forward of each config's serving
    and eval net, split by record_function ranges: {(config, net): device
    ms of the kernel rows, kernels, wall ms}. In this process: no other
    phase profiles in it, and the profiler traces the card once a
    process."""
    from torch.profiler import ProfilerActivity, profile, record_function
    keys = [(name, net) for name in nets_and_batches
            for net in ("canvas bf16", "compact float32")]
    with torch.no_grad():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for name, net in keys:
                nets, x = nets_and_batches[name]
                with record_function(f"ppc {name} {net}"):
                    nets[net](x)
                    torch.cuda.synchronize()
    events = prof.events()
    out = {}
    for name, net in keys:
        rng = next(e for e in events if e.name == f"ppc {name} {net}" and
                   e.device_type == torch.autograd.DeviceType.CPU)
        start, end = rng.time_range.start, rng.time_range.end
        rows = [e for e in events
                if e.device_type == torch.autograd.DeviceType.CUDA and
                not e.name.startswith("ppc ") and
                start <= e.time_range.start <= end]
        out[name, net] = {
            "device_ms": sum(e.time_range.elapsed_us() for e in rows) / 1e3,
            "kernels": len(rows), "wall_ms": (end - start) / 1e3}
        if out[name, net]["device_ms"] <= 0:
            raise AssertionError(f"pp_configs: the profiler saw no device "
                                 f"time in {name} {net}")
    return out


def _ppc_step(dataset, root, card):
    """One float32 training step at ``PPC_STEP`` (B = ``PP_CPU_BATCH``) on
    the card from weights trained ``PP_FIT_STEPS`` steps under torch's
    deterministic algorithms (``_pp_fit``), held to the same step in
    float64 on the CPU, both on the card's branches
    (``_pp_step_vs_cpu``): the full-width float32 step is
    ill-conditioned, so the card's CPU twin is printed, not held."""
    model = ppc_model(PPC_STEP)
    pipe = ppc_section(PPC_STEP, "pipeline")
    pipeline = ObjectDetection(model, dataset=dataset, device=DEVICE,
                               seed=SEED, max_epoch=0,
                               main_log_dir=str(root / "step"), **pipe)
    seeded = {k: v.cpu().clone()
              for k, v in pipeline.net.state_dict().items()}
    loader = PointCloudDataloader(dataset.get_split("train"),
                                  preprocess=model.preprocess,
                                  transform=model.transform)
    batch = next(iter(BatchLoader(loader, pipe["batch_size"],
                                  DefaultBatcher(), num_workers=0)))
    fitted, losses = _pp_fit(model, dataset, root, batch, seeded,
                             pipeline_cfg=pipe, phase="pp_configs")
    host = {k: torch.from_numpy(v[:PP_CPU_BATCH])
            for k, v in batch["data"].items() if isinstance(v, np.ndarray)}
    delta, pos = _pp_targets_vs_cpu(model, host, "pp_configs")
    say("pp_configs", f"{PPC_STEP}: anchor targets of the step's batch "
        f"({pos} positives of {host['bbox_count'].sum().item()} gt boxes), "
        f"card vs CPU: masks, labels and direction targets equal, deltas "
        f"within {delta:.3e} (bound 1e-6)")
    if not delta <= 1e-6:
        raise AssertionError("pp_configs: anchor deltas card vs CPU")
    loss_rel, grads, stats, branches, cpu_s, exact, flipped = _pp_step_vs_cpu(
        fitted, host, witness=True, cfg=ppc_section(PPC_STEP),
        phase="pp_configs")
    worst = max(a for a, _ in exact.values())
    cpu_worst = max(b for _, b in exact.values())
    say("pp_configs", f"{PPC_STEP}: {PP_FIT_STEPS} steps of "
        f"{pipe['batch_size']} frames from the seeded weights under "
        f"deterministic algorithms, total loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}; then one float32 step B={PP_CPU_BATCH} on the "
        f"card and on the CPU, and in float64 on the CPU, on the card's "
        f"branches ({branches.differ} of {branches.total} ReLU and "
        f"pillar-max choices the CPU would have made otherwise) and anchor "
        f"targets ({_flipped_line(flipped)}): loss card "
        f"vs CPU {loss_rel:.3e} (bound 1e-5); gradients' relative L2 from "
        f"float64, the worst: card {worst:.3e} (bound {PPC_TOL:g}), CPU "
        f"{cpu_worst:.3e}; card vs CPU, the worst: " +
        ", ".join(f"{k} {v:.3e}" for v, k in grads[:3]) +
        f"; BN statistics card vs CPU, the worst {stats[0][1]} "
        f"{stats[0][0]:.3e} (bound 1e-4); CPU step {cpu_s:.1f} s")
    if not (loss_rel <= 1e-5 and worst <= PPC_TOL and
            stats[0][0] <= 1e-4):
        raise AssertionError(f"pp_configs: the {PPC_STEP} step disagrees")


def _ppc_argoverse_step(dataset, card):
    """The Argoverse net (the YAML's, canvas bf16) trains one AdamW step
    of the YAML's batch on the card through the model API, on the
    reader's train frames with a zero intensity column: finite losses."""
    model = ppc_model("argoverse")
    pipe = ppc_section("argoverse", "pipeline")
    split = dataset.get_split("train")
    samples = []
    for i in range(pipe["batch_size"]):
        attr = split.get_attr(i)
        samples.append({"data": model.transform(model.preprocess(
            _four_columns(split.get_data(i)), attr), attr), "attr": attr})
    batch = DefaultBatcher().collate_fn(samples)
    x = {k: torch.from_numpy(v).to(DEVICE) for k, v in batch["data"].items()
         if isinstance(v, np.ndarray)}
    net = model.get_net().to(DEVICE).train()
    opt, _ = model.get_optimizer(pipe, net)
    losses = model.get_loss(net(x), x)
    opt.zero_grad(set_to_none=True)
    sum(losses.values()).backward()
    opt.step()
    values = {k: v.item() for k, v in losses.items()}
    say("pp_configs", f"argoverse: one AdamW step of {pipe['batch_size']} "
        f"frames through the model API (x, y, z and a zero intensity), "
        f"{int(batch['data']['bbox_count'].sum())} gt boxes: losses "
        f"{values}")
    if not all(np.isfinite(v) for v in values.values()):
        raise AssertionError(f"pp_configs argoverse step: {values}")


@contextlib.contextmanager
def _ppc_record(record):
    """Within: each ``ObjectDetection`` train step appends (seconds,
    losses) to ``record["steps"]``, its end after a synchronise; each
    ``run_valid`` its mAP to ``record["valid"]``; each ``_detect`` its
    frames to ``record["frames"]``."""
    step, valid, detect = (ObjectDetection._train_step,
                           ObjectDetection.run_valid,
                           ObjectDetection._detect)

    def train_step(self, inputs):
        t0 = time.perf_counter()
        losses = step(self, inputs)
        torch.cuda.synchronize()
        record["steps"].append((time.perf_counter() - t0,
                                {k: float(v) for k, v in losses.items()}))
        return losses

    def run_valid(self, *args, **kwargs):
        out = valid(self, *args, **kwargs)
        record["valid"].append(out)
        return out

    def _detect(self, batch):
        out = detect(self, batch)
        record["frames"] += len(out)
        return out

    with mock.patch.object(ObjectDetection, "_train_step", train_step), \
            mock.patch.object(ObjectDetection, "run_valid", run_valid), \
            mock.patch.object(ObjectDetection, "_detect", _detect):
        yield


def _ppc_cli(name, root, card):
    """``run_pipeline.main`` on the port's YAML of ``name`` over its
    frames under ``root / name``. Lyft and nuScenes: ``--split train``
    (the YAML's batch of 6: 2 steps, then the validation frame's mAP),
    then ``--split test`` from the checkpoint, which detects in each test
    frame and then cannot write the boxes as KITTI lines (the frames have
    no camera: ``NO_CAMERA_FAULT``, as in JAX). Waymo: the net fails in
    the neck (``NECK_FAULT``); Argoverse: ``transform`` fails on the
    reader's 3 columns (``COLUMNS_FAULT``). Returns the train run's
    record."""
    argv = ["-c", str(REPO / PP_CONFIGS[name]),
            "--dataset.dataset_path", str(root / name),
            "--dataset.test_result_folder", str(root / name / "results"),
            "--main_log_dir", str(root / "logs" / name),
            "--pipeline.train_sum_dir", str(root / "tb"),
            "--pipeline.max_epoch", "0", "--device", DEVICE]
    faults = {"waymo": (RuntimeError, tpp.NECK_FAULT),
              "argoverse": (ValueError, tpp.COLUMNS_FAULT)}
    record = {"steps": [], "valid": [], "frames": 0}
    with _ppc_record(record):
        t0 = time.perf_counter()
        if name in faults:
            error, fault = faults[name]
            try:
                run_pipeline.main(argv + ["--split", "train"])
            except error as err:
                if fault not in str(err):
                    raise
                say("pp_configs", f"{name} --split train raised the pinned "
                    f"fault after {time.perf_counter() - t0:.1f} s, "
                    f"{len(record['steps'])} steps: {str(err)[:160]}...")
                return record
            raise AssertionError(f"pp_configs: {name} trained: no fault")
        torch.cuda.reset_peak_memory_stats()
        run_pipeline.main(argv + ["--split", "train"])
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        (ckpt,) = (root / "logs" / name).glob("**/ckpt_00000.pth")
        t0 = time.perf_counter()
        try:
            run_pipeline.main(argv + ["--split", "test", "--ckpt_path",
                                      str(ckpt)])
            raise AssertionError(f"pp_configs: {name} test split saved "
                                 f"its boxes: no fault")
        except TypeError as err:
            if NO_CAMERA_FAULT not in str(err):
                raise
        test_s = time.perf_counter() - t0
    steps, valid = record["steps"], record["valid"]
    expected = PPC_FRAMES["train"] // 6
    if len(steps) != expected or len(valid) != 1 or \
            record["frames"] != PPC_FRAMES["val"] + PPC_FRAMES["test"]:
        raise AssertionError(f"pp_configs {name}: {len(steps)} steps, "
                             f"{len(valid)} validations, "
                             f"{record['frames']} frames detected")
    if not all(np.isfinite(v) for _, losses in steps
               for v in losses.values()):
        raise AssertionError(f"pp_configs {name}: losses {steps}")
    ap_bev, ap_3d = valid[0]
    say("pp_configs", f"{name} command line: --split train {train_s:.1f} s, "
        f"{len(steps)} steps of 6 frames "
        f"({', '.join(f'{s * 1e3:.1f}' for s, _ in steps)} ms, "
        f"synchronised), total losses "
        f"{[round(sum(v.values()), 4) for _, v in steps]}, validation mAP "
        f"BEV {ap_bev.mean():.4f}, 3D {ap_3d.mean():.4f} over "
        f"{ap_bev.shape[0]} classes, peak device memory "
        f"{peak / 2**30:.2f} GiB; --split test {test_s:.1f} s: "
        f"{PPC_FRAMES['test']} frames detected, then the pinned fault "
        f"(no camera matrix for the KITTI lines)")
    return record


def _ppc_convert(dataset, root, card):
    """``convert_checkpoint`` on the card: a reference-shaped state_dict of
    ``PPC_STEP``'s net (``pp_reference_state_dict``) saved as a ``.pth``,
    converted, strict-loaded into the eval net on the card and on the
    CPU; their head outputs on a frame within ``PPC_TOL``."""
    model = ppc_model(PPC_STEP)
    ref = pp_reference_state_dict(model.get_net(), seed=SEED + 7)
    path = root / "reference.pth"
    torch.save({"model_state_dict": ref}, path)
    state = convert_torch.convert_checkpoint(path, "PointPillars")
    batch = ppc_request(model, dataset)
    outs = []
    for device in (DEVICE, "cpu"):
        net = model.get_eval_net()
        net.load_state_dict(state, strict=True)
        net.eval().to(device)
        outs.append(_pp_outputs(net, {k: torch.from_numpy(v).to(device)
                                      for k, v in batch.items()}))
    rel = _pp_rel(*outs)
    say("pp_configs", f"convert_checkpoint of a reference-shaped "
        f"{PPC_STEP} state_dict ({len(ref)} tensors in a .pth): strict "
        f"load on the card, eval net card vs CPU relative L2 {rel:.3e} "
        f"(bound {PPC_TOL:g})")
    if not rel <= PPC_TOL:
        raise AssertionError(f"pp_configs: converted weights card vs CPU "
                             f"{rel}")


def phase_pp_configs(card):
    """PointPillars at its four other shipped YAMLs, at full width, on
    frames in each reader's own format: per net that runs (Lyft,
    nuScenes, Argoverse) the serving and eval nets' gates, the decode over
    B x C rows and its ``nms_bev`` call held to the plain version, median
    forwards and a profile; one float32 step at nuScenes held to float64;
    the command line on each YAML (Waymo's and Argoverse's failing as in
    JAX), Argoverse's net training one step through the model API; and
    ``convert_checkpoint`` on the card. Returns (``nms_bev``'s launches,
    its records at the decode shapes). Its last line splits its seconds
    by step."""
    t0 = time.perf_counter()
    spent = {}
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        t1 = time.perf_counter()
        datasets = {name: write_ppc_data(name, root / name)
                    for name in PP_CONFIGS}
        spent["frames"] = time.perf_counter() - t1
        say("pp_configs", f"frames written in {spent['frames']:.1f} s: " +
            "; ".join(f"{name} " + ", ".join(
                f"{s} {len(d.get_split(s))}" for s in PPC_FRAMES)
                for name, d in datasets.items()))
        frame = datasets["waymo"].get_split("train").get_data(0)
        say("pp_configs", f"waymo reader: frame 0 {frame['point'].shape}, "
            f"{len(frame['bounding_boxes'])} boxes")
        reset_counts()
        t1 = time.perf_counter()
        results, kept = {}, {}
        for name in PPC_NETS:
            results[name], kept[name] = _ppc_nets(name, datasets[name],
                                                  card)
        spent["nets"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        for name in ("lyft", "nuscenes", "waymo", "argoverse"):
            _ppc_cli(name, root, card)
        spent["command line"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        _ppc_argoverse_step(datasets["argoverse"], card)
        _ppc_step(datasets[PPC_STEP], root, card)
        spent["steps"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        _ppc_convert(datasets[PPC_STEP], root, card)
        spent["convert"] = time.perf_counter() - t1
        torch.cuda.synchronize()
        launches = read_counts()
        check_counts("pp_configs", launches, PPC_LAUNCHES)

        t1 = time.perf_counter()
        records = []
        with uncounted():
            for name in PPC_NETS:
                records.append(_prcnn_nms_check(
                    f"{name} decode", results[name]["nms_args"],
                    phase="pp_configs"))
        spent["nms checks"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        prof = ppc_profile(kept)
        spent["profile"] = time.perf_counter() - t1
        for name in PPC_NETS:
            for net, (fwd, lo, hi, peak) in results[name]["times"].items():
                p = prof[name, net]
                say("pp_configs", f"{name} {net} forward B=1: median "
                    f"{fwd * 1e3:.3f} ms over 10 runs (min {lo * 1e3:.3f}, "
                    f"max {hi * 1e3:.3f}), peak device memory "
                    f"{peak / 2**30:.2f} GiB; under torch.profiler "
                    f"{p['kernels']} kernels, {p['device_ms']:.3f} ms device "
                    f"time in a {p['wall_ms']:.3f} ms forward (busy "
                    f"{p['device_ms'] / p['wall_ms']:.1%}) on {card}")
    say("pp_configs", f"phase {time.perf_counter() - t0:.1f} s: " +
        "; ".join(f"{k} {v:.1f} s" for k, v in spent.items()))
    return launches["nms_bev"], records


PARENT_SOURCES = ("fps.cu", "nms_bev.cu", "trilinear_devoxelize.cu")


def _parent_library(src):
    """The earlier commit's sources of ``PARENT_SOURCES`` that the
    directory ``src`` holds, built there by nvcc as the port's sources are
    and bound with that commit's entry points: ``fps_launch`` with one
    block a cloud of ``threads``, ``nms_bev_launch`` with no ``stages``,
    the devoxelisation pair with no plan, its backward adding into a
    zeroed dgrid. Returns (the library, the sources built)."""
    import ctypes
    names = [name for name in PARENT_SOURCES if (src / name).exists()]
    if not names:
        raise RuntimeError(f"--vs-parent: {src} holds none of "
                           f"{PARENT_SOURCES}")
    objs = [src / f"{name}.o" for name in names]
    procs = [subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-c", "-o",
                               str(obj), str(src / name)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for name, obj in zip(names, objs)]
    for name, proc in zip(names, procs):
        said = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on the earlier {name}:\n{said}")
    lib_path = src / "libparent.so"
    subprocess.run([_build._nvcc(), "-shared", "-o", str(lib_path),
                    *map(str, objs)], check=True)
    lib = ctypes.CDLL(str(lib_path))
    p, i = ctypes.c_void_p, ctypes.c_int
    entries = {"fps.cu": {"fps_launch": (p, p, p, i, i, i, i, p)},
               "nms_bev.cu": {"nms_bev_launch": (p, p, p, p, i, i,
                                                 ctypes.c_float, p)},
               "trilinear_devoxelize.cu": {
                   "trilinear_devoxelize_launch": (p, p, p, i, i, i, i, p),
                   "trilinear_devoxelize_bwd_launch": (p, p, p, i, i, i, i,
                                                       p)}}
    for name in names:
        for entry, argtypes in entries[name].items():
            fn = getattr(lib, entry)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return lib, names


def _vs_parent_fps_nms(old, turns):
    """The earlier ``fps`` and ``nms_bev`` against this tree's (``turns``)
    at PointTransformer's four levels at B = 2, 16,384 -> 4,096 at B = 1,
    and on the ``fps`` and ``nms_bev`` calls of a served PointRCNN frame,
    captured."""

    def old_fps(points, m, mask=None):
        b, n, _ = points.shape
        out = torch.empty((b, m), dtype=torch.int32, device=points.device)
        cfps.raise_on(old.fps_launch(points.data_ptr(), cfps.ptr(mask),
                                     out.data_ptr(), b, n, m,
                                     min(1024, 32 * -(-n // 32)),
                                     cfps.stream()), "earlier fps")
        return out

    def old_nms(boxes, valid, thr):
        r, n, _ = boxes.shape
        mask = cnms.scratch(r, n, boxes.device)
        keep = torch.empty((r, n), dtype=torch.bool, device=boxes.device)
        cfps.raise_on(old.nms_bev_launch(boxes.data_ptr(), valid.data_ptr(),
                                         mask.data_ptr(), keep.data_ptr(), r,
                                         n, float(thr), cfps.stream()),
                      "earlier nms_bev")
        return keep

    n = POINTTRANSFORMER_S3DIS["num_points"]
    for b in (1, 2):
        pts = _pt_points(b, n, SEED + 6)
        turns(f"fps B={b} N={n} m={n // 4}", lambda: old_fps(pts, n // 4),
              lambda: cfps.fps(pts, n // 4))
    n //= tpt.STRIDE[1]
    for s in tpt.STRIDE[2:]:
        pts = _pt_points(PT_EVAL_BATCH, n, SEED + 6)
        turns(f"fps B={PT_EVAL_BATCH} N={n} m={n // s}",
              lambda: old_fps(pts, n // s), lambda: cfps.fps(pts, n // s))
        n //= s
    model = prcnn_model()
    net = random_weights(model.get_net(), SEED).eval().to(DEVICE)
    with tempfile.TemporaryDirectory() as tmp:
        data, _ = prcnn_request(model, Path(tmp) / "request")
    x = {"point": torch.from_numpy(data["point"]).to(DEVICE)}
    calls, out = _prcnn_calls(net, x)
    refine = _captured(cnms, "nms_bev", lambda: model.inference_end(out, data))
    for (points, m), kwargs in calls["fps"]:
        mask = kwargs.get("points_mask")
        turns(f"pointrcnn fps B={points.shape[0]} N={points.shape[1]} m={m}",
              lambda: old_fps(points, m, mask),
              lambda: cfps.fps(points, m, points_mask=mask))
    for label, (args, _) in (("proposal buckets", calls["nms_bev"][0]),
                             ("refinement", refine[0])):
        boxes, valid, thr = args
        turns(f"pointrcnn nms_bev {label} R={boxes.shape[0]} "
              f"N={boxes.shape[1]}", lambda: old_nms(boxes, valid, thr),
              lambda: cnms.nms_bev(boxes, valid, thr))


def _devox_cases(gen):
    """(label, grid, coords, plan, tolerance) of the devoxelisation at the
    four path shapes on uniform coordinates (``_pv_coords``), at r 32 C 64
    on ``_pv_crowded_coords`` and at the four calls of an eval forward of
    the S3DIS rooms (``PV_ROOMS``), captured; the relative L2 within which
    two float32 sums of the same backward products in different orders
    agree there (``PV_BWD_TOL``, ``PV_CROWDED_BWD_TOL``)."""
    model = pv_model()
    net = model.get_net()
    n = model.cfg.num_points
    dev = torch.device(DEVICE)
    for r, c in pv_shapes(net):
        coords = _pv_coords(PV_BATCH, n, r, dev, gen)
        grid = torch.randn((PV_BATCH, r, r, r, c), device=DEVICE,
                           generator=gen)
        yield (f"uniform B={PV_BATCH} N={n} r={r} C={c}", grid, coords,
               cdv.devoxelize_plan(coords, r), PV_BWD_TOL)
    coords = _pv_crowded_coords(PV_BATCH, n, 32, dev, gen)
    grid = torch.randn((PV_BATCH, 32, 32, 32, 64), device=DEVICE,
                       generator=gen)
    yield (f"crowded B={PV_BATCH} N={n} r=32 C=64 (half of each sample in "
           f"one cell)", grid, coords, cdv.devoxelize_plan(coords, 32),
           PV_CROWDED_BWD_TOL)
    net = random_weights(net, SEED).eval().to(DEVICE)
    with tempfile.TemporaryDirectory() as tmp:
        write_s3dis_rooms(Path(tmp), PV_ROOM_POINTS, PV_ROOMS)
        x = {k: v.to(DEVICE) for k, v in pv_request(model, Path(tmp)).items()}
    with torch.no_grad():
        calls = _captured(cdv, "trilinear_devoxelize", lambda: net(x))
    for i, ((grid, coords, plan), _) in enumerate(calls):
        cells = int((plan.offsets.diff() > 0).sum())
        yield (f"rooms call {i} B={grid.shape[0]} N={coords.shape[1]} "
               f"r={grid.shape[1]} C={grid.shape[4]} ({cells} lo cells hold "
               f"a point)", grid, coords, plan, PV_BWD_TOL)


def _devox_against(turns, rows, other_forward, other_backward, exact):
    """Another devoxelisation pair (``other_forward(grid, coords, plan)``,
    ``other_backward(g, coords, r, plan)``) against this tree's in turns
    on ``_devox_cases``, with a normal cotangent: the forwards equal, the
    backwards equal with ``exact``, else within the case's tolerance; the
    plan's own time at each goes into ``rows`` beside them."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 7)
    for label, grid, coords, plan, tol in _devox_cases(gen):
        r = grid.shape[1]
        t = [device_ms(lambda: cdv.devoxelize_plan(coords, r), iters=10)
             for _ in range(2)]
        rows.append({"call": f"{label} plan", "ms": t})
        say("devoxelize", f"{label} plan: this tree {t[0]:.4f} / "
            f"{t[1]:.4f} ms")
        turns(f"{label} forward", lambda: other_forward(grid, coords, plan),
              lambda: cdv.trilinear_devoxelize(grid, coords, plan))
        g = torch.randn(grid.shape[:1] + coords.shape[1:2] + grid.shape[4:],
                        device=grid.device, generator=gen)
        turns(f"{label} backward",
              lambda: other_backward(g, coords, r, plan),
              lambda: cdv.devoxelize_grad(g, coords, r, plan),
              torch.equal if exact else
              lambda a, b: _rel_l2(a, b) <= tol)


def _vs_parent_devoxelize(old, turns, rows):
    """The earlier devoxelisation pair (a thread a point's float4
    unit, the backward's float4 atomics into a zeroed dgrid) against this
    tree's (``_devox_against``: the forward through a plan built
    beforehand, the backward through the same plan), the backwards within
    the case's relative L2 of each other (the earlier one's atomic sums
    change from run to run)."""

    def old_forward(grid, coords, plan):
        b, r, c, n = (grid.shape[0], grid.shape[1], grid.shape[4],
                      coords.shape[1])
        out = torch.empty((b, n, c), device=grid.device)
        cdv.raise_on(old.trilinear_devoxelize_launch(
            grid.data_ptr(), coords.data_ptr(), out.data_ptr(), b, n, r, c,
            cdv.stream()), "earlier trilinear_devoxelize")
        return out

    def old_backward(g, coords, r, plan):
        b, n, c = g.shape
        dgrid = torch.zeros((b, r, r, r, c), device=g.device)
        cdv.raise_on(old.trilinear_devoxelize_bwd_launch(
            g.data_ptr(), coords.data_ptr(), dgrid.data_ptr(), b, n, r, c,
            cdv.stream()), "earlier trilinear_devoxelize_bwd")
        return dgrid

    _devox_against(turns, rows, old_forward, old_backward, exact=False)


def _in_turns(rows, other):
    """``turns(label, other_fn, this_fn, same=torch.equal)``: checks that
    the two outputs are ``same``, times them in turns (``other``, this,
    this, ``other``; ``device_ms`` each), appends the row to ``rows`` and
    says it."""

    def turns(label, other_fn, this_fn, same=torch.equal):
        if not same(other_fn(), this_fn()):
            raise AssertionError(f"{label}: the outputs differ")
        t = [device_ms(fn, iters=10) for fn in (other_fn, this_fn, this_fn,
                                                other_fn)]
        rows.append({"call": label, f"{other}_ms": [t[0], t[3]],
                     "ms": [t[1], t[2]]})
        say(other, f"{label}: {other} {t[0]:.4f} / {t[3]:.4f} ms, this tree "
            f"{t[1]:.4f} / {t[2]:.4f} ms (in turns: {other}, this, this, "
            f"{other})")

    return turns


def vs_parent(src):
    """``--vs-parent DIR``: the kernels of an earlier commit whose sources
    DIR holds (``PARENT_SOURCES``: its ``csrc/fps.cu``, ``nms_bev.cu``,
    ``trilinear_devoxelize.cu``, any of them) against this tree's, timed
    in turns in one process (``_in_turns``), their outputs checked against
    each other at each call: ``_vs_parent_fps_nms``,
    ``_vs_parent_devoxelize``. Prints one JSON line of the times."""
    card = phase_device()
    phase_build()
    old, names = _parent_library(Path(src).resolve())
    rows = []
    turns = _in_turns(rows, "parent")
    if "fps.cu" in names and "nms_bev.cu" in names:
        _vs_parent_fps_nms(old, turns)
    if "trilinear_devoxelize.cu" in names:
        _vs_parent_devoxelize(old, turns, rows)
    print(json.dumps({"vs_parent": rows, "card": card}), flush=True)


# the staged design of the devoxelisation pair, which ``--devox-staged``
# measures against the shipped one
STAGED_SOURCE = (Path(__file__).resolve().parent / "open3d_ml_tpu_torch" /
                 "csrc" / "variants" / "trilinear_devoxelize_staged.cu")


def devox_staged():
    """``--devox-staged``: the staged devoxelisation pair
    (``STAGED_SOURCE``, built here on its own under ``csrc/build/``)
    against this tree's on this tree's plans, in turns in one process
    (``_devox_against``), the forwards and the backwards bit-equal. Prints
    one JSON line of the times."""
    import ctypes
    card = phase_device()
    phase_build()
    lib_path = _build.CSRC / "build" / "libstaged.so"
    said = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared",
                           "-o", str(lib_path), str(STAGED_SOURCE)],
                          capture_output=True, text=True)
    if said.returncode:
        raise RuntimeError(f"nvcc failed on {STAGED_SOURCE}:\n"
                           f"{said.stdout}{said.stderr}")
    say("staged", "registers and spill store/load bytes: " + "; ".join(
        line.strip() for line in (said.stdout + said.stderr).splitlines()
        if "registers" in line or "spill" in line))
    lib = ctypes.CDLL(str(lib_path))
    for name in ("trilinear_devoxelize_staged_launch",
                 "trilinear_devoxelize_staged_bwd_launch"):
        getattr(lib, name).argtypes = (ctypes.c_void_p,) * 5 + (
            ctypes.c_int,) * 3 + (ctypes.c_void_p,)
        getattr(lib, name).restype = ctypes.c_int

    def launch(entry, x, plan, out):
        cdv.raise_on(getattr(lib, entry)(
            x.data_ptr(), plan.perm.data_ptr(), plan.offsets.data_ptr(),
            plan.weights.data_ptr(), out.data_ptr(), x.shape[0], plan.r,
            x.shape[-1], cdv.stream()), entry)
        return out

    def forward(grid, coords, plan):
        out = torch.empty(coords.shape[:2] + grid.shape[4:],
                          device=grid.device)
        return launch("trilinear_devoxelize_staged_launch", grid, plan, out)

    def backward(g, coords, r, plan):
        dgrid = torch.empty((g.shape[0], r, r, r, g.shape[2]),
                            device=g.device)
        return launch("trilinear_devoxelize_staged_bwd_launch", g, plan,
                      dgrid)

    rows = []
    _devox_against(_in_turns(rows, "staged"), rows, forward, backward,
                   exact=True)
    print(json.dumps({"devox_staged": rows, "card": card}), flush=True)


def step_branches():
    """The float32 card-vs-CPU step on the patches of model seeds 0-3, with
    the CPU on its own branches and then on the card's."""
    card = phase_device()
    phase_build()
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        dataset = _train_dataset(root)
        for seed in range(4):
            for same in (False, True):
                loss_rel, grad_rel, stats_rel, _, _, branches = _step_vs_cpu(
                    dataset, root / f"cpu{seed}{same:d}", seed, same)
                which = (f"the card's branches ({branches.differ} of "
                         f"{branches.total} choices the CPU would have "
                         "made otherwise)" if same else "its own branches")
                say("step-branches", f"model seed {seed}, the CPU on "
                    f"{which}: gradient relative L2 {grad_rel:.3e}, loss "
                    f"relative difference {loss_rel:.3e}, running "
                    f"statistics relative L2 {stats_rel:.3e} on {card}")


def stencil_calls():
    """The stencil kernel's yardstick across versions of the port: each
    stencil_conv call of the room request's forward timed alone, their
    sum, and their device time inside one forward (``_stencil_share``)."""
    card = phase_device()
    phase_build()
    model = MODEL.get("SparseConvUnet")(seed=SEED)
    net = random_weights(model.get_net(), SEED).eval().to(DEVICE)
    x = _scu_inputs(model, scu_scene(SCU_ROOM_EXTENT_M,
                                     model.cfg.num_points))[1]
    _say_conv_table(_conv_table(net, _capture_stencil_calls(net, x)))
    st_ms, wall_ms = _stencil_share(net, x)
    say("scu", f"the {SCU_FORWARD_LAUNCHES} stencil_conv calls inside one "
        f"room forward: {st_ms:.4f} device ms, in a {wall_ms:.2f} ms "
        f"forward on {card}")


def knn_calls():
    """The KNN kernels' yardstick across versions of the port: each
    knn_exact launch of one eval pyramid (1 x 45,056 uniform points, the
    eval phase's input) and each bucket_knn launch of one fused pyramid (4 x
    45,056, at the inference and the training budget) timed alone as the
    kernels phase times them, and their sums."""
    card = phase_device()
    phase_build()
    cfg = MODEL.get("RandLANet")().cfg
    rng = np.random.default_rng(0)
    eval_pts = torch.from_numpy(rng.uniform(
        -25, 25, (1, cfg.num_points, 3)).astype(np.float32)).to(DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    fused_pts = torch.rand((4, cfg.num_points, 3), generator=gen,
                           device=DEVICE) * 50 - 25
    eval_calls = _captured(tn, "knn_exact", lambda: tn.build_knn_pyramid(
        eval_pts, cfg.num_neighbors, cfg.sub_sampling_ratio))
    groups = [("eval", "knn_exact", [
        (f"level-{i}", args, kwargs)
        for i, (args, kwargs) in enumerate(eval_calls)])]
    for num_segs, gather_segs in ((cfg.infer_num_segs, cfg.infer_gather_segs),
                                  (cfg.num_segs, cfg.gather_segs)):
        groups.append((f"fused S{num_segs}", "bucket_knn", fused_searches(
            fused_pts, cfg, num_segs, gather_segs)))
    fns = {"knn_exact": ck.knn_exact, "bucket_knn": cb.knn_bucket}
    for group, kernel, calls in groups:
        times = []
        for label, args, kwargs in calls:
            times.append(device_ms(lambda: fns[kernel](*args, **kwargs)))
            say("knn-calls", f"{group} {kernel} {label} B={args[1].shape[0]} "
                f"Q={args[1].shape[1]}: device ms {times[-1]:.4f}")
        say("knn-calls", f"{group}: the {len(calls)} {kernel} launches, "
            f"device ms {sum(times):.4f} in all on {card}")


def main():
    if sys.argv[1:] == ["--step-branches"]:
        return step_branches()
    if sys.argv[1:] == ["--stencil-calls"]:
        return stencil_calls()
    if sys.argv[1:] == ["--knn-calls"]:
        return knn_calls()
    if sys.argv[1:] == ["--pp-profile"]:
        return pp_profile()
    if sys.argv[1:] == ["--pointpillars"]:
        return phase_pointpillars(phase_device())
    if sys.argv[1:] == ["--pp-train"]:
        return phase_pp_train(phase_device())
    if sys.argv[1:] == ["--pp-train-profile"]:
        return pp_train_profile()
    if sys.argv[1:] == ["--cli"]:
        card = phase_device()
        phase_build()
        return phase_cli(card)
    if sys.argv[1:] == ["--pointtransformer"]:
        card = phase_device()
        phase_build()
        phase_pointtransformer(card)
        return None
    if sys.argv[1:] == ["--pt-profile"]:
        return pt_profile()
    if sys.argv[1:] == ["--pt-fused"]:
        card = phase_device()
        phase_build()
        phase_pt_fused(card)
        return None
    if sys.argv[1:] == ["--pt-fused-profile"]:
        return pt_profile("fused")
    if sys.argv[1:] == ["--kpconv"]:
        phase_kpconv(phase_device())
        return None
    if sys.argv[1:] == ["--kpconv-profile"]:
        return kp_profile()
    if sys.argv[1:] == ["--pointrcnn"]:
        card = phase_device()
        phase_build()
        phase_pointrcnn(card)
        return None
    if sys.argv[1:2] == ["--vs-parent"] and len(sys.argv) == 3:
        return vs_parent(sys.argv[2])
    if sys.argv[1:] == ["--devox-staged"]:
        return devox_staged()
    if sys.argv[1:] == ["--prcnn-profile"]:
        return prcnn_profile()
    if sys.argv[1:] == ["--pointrcnn-train"]:
        card = phase_device()
        phase_build()
        phase_pointrcnn_train(card)
        return None
    if sys.argv[1:] == ["--prcnn-train-profile"]:
        return prcnn_train_profile()
    if sys.argv[1:] == ["--pvcnn"]:
        card = phase_device()
        phase_build()
        phase_pvcnn(card)
        return None
    if sys.argv[1:] == ["--randla-configs"]:
        card = phase_device()
        phase_build()
        phase_randla_configs(card)
        return None
    if sys.argv[1:] == ["--pvcnn-profile"]:
        return pv_profile()
    if sys.argv[1:] == ["--pp-configs"]:
        card = phase_device()
        phase_build()
        phase_pp_configs(card)
        return None
    card = phase_device()
    model = MODEL.get("RandLANet")()
    phase_build()
    knn, gathers, bwds = phase_kernels(model.cfg)
    measured = {"bucket_knn": knn, "knn_exact": phase_knn_exact(model.cfg)}
    launches = phase_slice(model, card)
    # bucket_gather_bwd's launches are the training run's
    launches["bucket_gather_bwd"] = phase_train(card)["bucket_gather_bwd"]
    state = phase_eval(model, card)
    # knn_exact's launches are run_inference's, the main path of its slice
    launches["knn_exact"] = phase_inference(model, state, card)["knn_exact"]
    yaml_launches, yaml_records, yaml_gathers, yaml_bwds = (
        phase_randla_configs(card))
    (scu_launches, measured["stencil_conv"], measured["stencil_match"],
     scu_gathers, scu_bwds) = phase_scu(card)
    launches["stencil_conv"] = scu_launches["stencil_conv"]
    # stencil_match's launches are SCU training's, the main path of its
    # slice
    launches["stencil_match"] = phase_scu_train(card)["stencil_match"]
    phase_pointpillars(card)
    phase_pp_train(card)
    phase_cli(card)
    pt_launches, pt_knn, measured["fps"] = phase_pointtransformer(card)
    ptf_launches, ptf_knn, ptf_gathers, ptf_bwds = phase_pt_fused(card)
    # the bucket kernels: RandLA's, its other YAMLs', SparseConvUnet's and
    # PointTransformer's fused shapes; their launches, the fused
    # PointTransformer forward's and training run's too
    measured["bucket_knn"] = combine([knn, *yaml_records["bucket_knn"],
                                      ptf_knn])
    measured["bucket_gather"] = bucket_summary(
        "bucket_gather", gathers + yaml_gathers + scu_gathers + ptf_gathers,
        "torch.gather")
    measured["bucket_gather_bwd"] = bucket_summary(
        "bucket_gather_bwd", bwds + yaml_bwds + scu_bwds + ptf_bwds,
        "scatter_add_")
    for name in ("bucket_knn", "bucket_gather", "bucket_gather_bwd"):
        launches[name] += ptf_launches[name]
    phase_kpconv(card)
    (rc_launches, rc_knn, rc_fps,
     measured["nms_bev"]) = phase_pointrcnn(card)
    tr_launches, tr = phase_pointrcnn_train(card)
    (pv_launches, measured["trilinear_devoxelize"],
     measured["trilinear_devoxelize_bwd"],
     measured["trilinear_devoxelize_plan"]) = phase_pvcnn(card)
    ppc_launches, ppc_nms = phase_pp_configs(card)
    # knn_exact: one RandLA eval forward's 4 launches, one
    # PointTransformer forward's 26, one PointRCNN frame's 14 and its two
    # training steps' 12 and 14; its launches, run_inference's, the three
    # forwards' and the two steps'
    measured["knn_exact"] = combine([measured["knn_exact"],
                                     *yaml_records["knn_exact"], pt_knn,
                                     rc_knn, tr["knn_exact"]])
    trained = {k: sum(c[k] for c in tr_launches.values())
               for k in ("knn_exact", "fps", "nms_bev")}
    launches["knn_exact"] += (pt_launches["knn_exact"] +
                              rc_launches["knn_exact"] +
                              trained["knn_exact"])
    measured["fps"] = combine([measured["fps"], rc_fps, tr["fps"]])
    launches["fps"] = (pt_launches["fps"] + rc_launches["fps"] +
                       trained["fps"])
    # nms_bev: one served PointRCNN frame's 2 calls, the RCNN-mode
    # training step's 1 and the decodes of PointPillars' other configs;
    # its launches, theirs and those of pp_configs' command lines
    measured["nms_bev"] = combine([measured["nms_bev"], tr["nms_bev"],
                                   *ppc_nms])
    launches["nms_bev"] = (rc_launches["nms_bev"] + trained["nms_bev"] +
                           ppc_launches)
    # the devoxelisation: one PVCNN forward's 4 launches and 2 plans, and
    # one step's 4 + 4 launches and 2 plans
    for name in ("trilinear_devoxelize", "trilinear_devoxelize_bwd",
                 "trilinear_devoxelize_plan"):
        launches[name] = pv_launches[name]
    # the four other RandLA YAMLs' forwards and command-line runs
    for name, n in yaml_launches.items():
        launches[name] += n
    sources = {"bucket_knn": ("open3d_ml_tpu_torch/csrc/bucket_knn.cu",
                              f"{TPU_KERNELS}:261"),
               "bucket_gather": ("open3d_ml_tpu_torch/csrc/bucket_gather.cu",
                                 f"{TPU_KERNELS}:428, {TPU_KERNELS}:408"),
               "bucket_gather_bwd": (
                   "open3d_ml_tpu_torch/csrc/bucket_gather_bwd.cu",
                   f"{TPU_KERNELS}:563, {TPU_KERNELS}:539"),
               "knn_exact": ("open3d_ml_tpu_torch/csrc/knn_exact.cu",
                             "open3d_ml_tpu/ops/pallas/knn.py:116"),
               "stencil_conv": ("open3d_ml_tpu_torch/csrc/stencil_conv.cu",
                                "open3d_ml_tpu/ops/pallas/stencil.py:264"),
               "stencil_match": ("open3d_ml_tpu_torch/csrc/stencil_match.cu",
                                 "open3d_ml_tpu/ops/pallas/stencil.py:147"),
               "fps": ("open3d_ml_tpu_torch/csrc/fps.cu",
                       "open3d_ml_tpu/ops/sampling.py:13 (an XLA fori_loop, "
                       "no pallas_call)"),
               "nms_bev": ("open3d_ml_tpu_torch/csrc/nms_bev.cu",
                           "open3d_ml_tpu/ops/nms.py:17 (an XLA IoU matrix "
                           "and fori_loop, no pallas_call)"),
               "trilinear_devoxelize": (
                   "open3d_ml_tpu_torch/csrc/trilinear_devoxelize.cu",
                   "open3d_ml_tpu/ops/interpolation.py:45 (eight XLA "
                   "gathers, no pallas_call)"),
               "trilinear_devoxelize_bwd": (
                   "open3d_ml_tpu_torch/csrc/trilinear_devoxelize.cu",
                   "open3d_ml_tpu/ops/interpolation.py:45 (its autodiff "
                   "scatter-adds, no pallas_call)"),
               "trilinear_devoxelize_plan": (
                   "open3d_ml_tpu_torch/csrc/trilinear_devoxelize.cu",
                   "none: the port's cell-sorted plan that the "
                   "devoxelisation kernels read (no pallas_call)")}
    kernels = [json_entry(name, *sources[name], launches[name], rec)
               for name, rec in measured.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
