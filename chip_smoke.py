#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's serving, training, evaluation, incremental (replay and the IL battery included), export, data-parallel and head-tensor-parallel paths on one GPU and check them.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):

1. The card: its ``nvidia-smi`` name and power limit. No CUDA -> exit 1.
2. Build: ``nvcc`` builds every kernel of the path from ``csrc/`` (one
   process per source, all at once); prints the seconds and ptxas'
   register / shared-memory lines.
3. Kernel checks at the main path's shapes, each against its plain
   PyTorch version on the same inputs on the card:
   * fused stem, bf16, (8,152,208,64) and (32,152,208,64): within 2 bf16
     ulps of |plain| + max|bias| per value (the kernel and cuDNN sum in
     f32 in different orders, which moves the bf16 rounding of the conv
     by at most one ulp before the bias add); float32, (8,152,208,64),
     through the kernel's float32 form (FMA units, the 7x7 conv from the
     compact weight) against the plain version with TF32 off:
     |diff| <= 1e-4 * (1 + |plain|);
   * batched NMS (mask kernel + banded scan), B=32, k=1024 and k=2048,
     on random boxes, an IoU-exactly-0.5 fixture and identical boxes:
     keep masks bit-identical;
   * int8 kernel, GEMM mode (int8 x int8 -> int32, per-column scale,
     optional bias, bf16 out): bit-identical to its plain version at the
     TPU tool's shape (M=62976, K=2304, N=256, scale 1e-4, no bias) and
     at the quantized R50's GEMM shapes; float32 operands must raise;
   * int8 kernel, conv mode (the 3x3 convs of the quantized R50 on their
     NHWC int8 inputs: layer1, layer2 stride 2, head trunk P3, P4 and P7,
     fpn.p6 stride 2): bit-identical to im2col + the plain GEMM.
   Times (the int8 ones from CUDA graphs of 20 calls, which leave out
   the host's time per call; the others per call with it, the NMS also
   from a CUDA graph in the log): kernel, plain version, the bound (the
   larger of bytes over 3.35 TB/s and operations over the peak rate of
   their type; a conv's input counted at its NHWC size; for the stem the
   operations of the 7x7/2 conv it computes, and beside it the bounds of
   the packed 3x3 GEMM and of the operations its 8x16 windows compute,
   halo included), and one library
   call where PyTorch has one (the stem: cuDNN's conv chain on the
   equivalent RGB batch; the int8 kernel: ``torch._int_mm``, the product
   alone, without the dequantize epilogue, on the explicit patches in
   conv mode); conv mode also beside the route it replaced (im2col on
   the card + GEMM mode).
   Then the host microseconds per call of each kernel's ``torch.library``
   operator against its direct launch, at small shapes (the dispatcher's
   cost per launch).
4. Main path: an R50 RetinaNet, 20 classes, bf16, seeded random weights
   (output convs random and non-zero), 608x832 uint8 fused-stem frames,
   ``nms_impl="pallas_fp"``. After one warm-up request through the serve
   device thread, with the launch counters at 0: the device loop answers
   16 requests from 4 threads at max_batch 8 (their latency printed), then
   ``make_predict_fn`` is timed at B=32 (frames resident on the card).
   The stem and NMS counters must have risen (the int8 one must not) and
   the NMS must have seen candidates. Output check: finite detections of
   the static shape, and the fused stem path's logits against the RGB
   (cuDNN stem) path's on 2 frames.
5. Quantized main path (``quantize=True``: every conv but the heads'
   outputs through the int8 GEMM) on the same model and frames, driven
   the same way with the counters at 0 again: 16 served requests, a
   timed B=32 predict beside the float one, its forward/post-process
   split. All counters must have risen, the int8 kernel's by exactly
   100 per R50 predict (52 backbone + 8 FPN + 2 heads x 4 convs x 5
   levels), 61 of them in conv mode (the 16 + 5 + 40 3x3 convs). Output
   check: finite detections of the static shape, and the quantized
   logits against the float ones on 2 frames (correlation > 0.98, the
   bar of the JAX package's tests/test_quant.py).
6. Float32 path: the same R50 built with ``compute_dtype="float32"`` (TF32
   off), counters at 0, three B=8 predicts on the same fused frames. The
   float32 stem kernel and the NMS counters must have risen, the bf16
   stem's and the int8 one's not. Output check: finite detections of the
   static shape, and the fused stem path's logits against the RGB stem
   path's on 2 frames (relative L2 < 1e-3).
7. Train step at state 0 (``train.step.make_train_step``): the bf16 R50
   of phase 4 on 8 of its 608x832 uint8 fused frames with
   tools/bench_train.py's synthetic GT (8 boxes per image, 32 slots),
   ``every_iter=2``, clip 0.1, lr 1e-5. First the stem Function's
   backward at (8,152,208,64) against autograd through the plain version
   (deterministic cuDNN: bit-identical). With the counters at 0: 2
   warm-up micro-steps, then 20 timed ones ending in a synchronise
   (images/s, ms per micro-step, peak memory). The stem counter must
   equal the micro-steps (22), the NMS and int8 ones stay 0; the loss is
   finite at every micro-step; conv1.weight, bn1.weight and bn1.bias
   have moved after the first apply (their gradient goes through the
   kernel's Function). Then the forward / backward / optimizer split
   from CUDA events, one remat micro-step beside a plain one (ms, peak
   memory), and the float32 check: one apply of a small R18 on the card
   (TF32 off, the stem's float32 form under grad) against the same apply
   on the CPU, at the CPU tests' bars.
8. The trainer through its entry point, ``cli.train.main``, in this
   process: the port's ``make_toy_dataset`` writes 96 PNG images at
   375x500 (every third portrait), 20 classes (the VOC names),
   ``style="separable"``, into a temporary directory; ``main`` trains
   the bf16 R50 with JAX's own flags only (``--depth 50 --scenario 20
   --batch_size 8 --every_iter 2 --fused_stem true --transfer_dtype
   uint8 --start_epoch 1 --end_epoch 2 --save_every 1 --record true``,
   the rest at the defaults both packages share: 640x1024 frames, lr
   1e-5, clip 0.1, 2 loader threads, prefetch 2), checkpoints and
   ``runs/`` in the temporary directory. cuDNN is deterministic for the
   whole phase. Checks: every total_loss finite; the stem counter equals
   the micro-steps (24, then 36 after the resume), the NMS and int8
   ones 0; checkpoints for epochs 1 and 2; the epoch-2 checkpoint's
   tensors equal the live model's bit for bit. Then ``main`` again with
   ``--start_epoch 2 --end_epoch 2``: the state right after the resume
   (parameters, frozen-BN buffers, Adam moments, counts, LR, betas)
   equals the epoch-1 checkpoint bit for bit and lies on the card, and
   the first resumed micro-step's total_loss equals the first run's
   epoch-2 first micro-step within rtol 1e-3. Printed: images/s over
   epoch 2 (host clock, the loader included) beside phase 7's, the
   loader's ms per batch and the loop's wait on it, ``run_batch`` alone
   on one epoch of batches assembled beforehand (ms per micro-step at
   640x1024), the loader's ms per image by stage, the checkpoint save's
   blocking ms, the peak memory, and, under ``--profile``, the device's
   idle share over epoch 2 (``--profile DIR/trainer``; the resumed
   epoch's trace goes to ``DIR/trainer_resume``).
9. Evaluation of phase 8's checkpoints, in its temporary directory:
   ``make_toy_dataset`` writes a test split of 64 PNG images at 375x500
   (every third portrait, ``style="separable"``, seed 1, 9 batches of 8);
   with the counters at 0, ``cli.validate.main`` with phase 8's model
   and data flags, ``--state 0 --epoch 1 2 --threshold 0.001`` (one
   decode pass, two predicts per batch; cuDNN deterministic for the
   phase). Checks: both result JSONs and the decline CSV exist, every
   row is finite, no (image_id, bbox, score) repeats; the bf16 stem
   launched 2 x 9 times, the NMS and int8 kernels not. Then an
   ``Evaluator`` with ``nms_impl="pallas_fp"`` on the epoch-2 model: one
   NMS launch per batch, rows equal to validate's epoch-2 JSON; both
   COCO-protocol paths on those rows (per-class AP/AR within 1e-6, both
   timed); the test split's GT as detections (score 1): AP = AR = 1 for
   every class with GT; ``--save_upper_bound`` then ``--just_val`` on
   epoch 2: 0.0% decline on every class with GT, ``Mean`` and
   ``Sum_decline``; ``--quantize true --epoch 2``: 100 int8 launches per
   batch (61 in conv mode), its mAP beside the float one, and one
   conv-mode and one GEMM-mode call at the eval frame (B=8, 640x1024)
   bit-identical to their plain versions. Printed: the decode + predict
   pass in images/s (host clock, loader included), the loader's ms per
   batch, then the pass's parts alone: predict (ms per B=8 batch, frames
   resident), ``detections_to_coco`` of one batch, the loader over the
   split with nothing beside it; and the COCO-protocol seconds of both
   paths.
10. Incremental state 1, on phase 8's toy data in its temporary
   directory (cuDNN deterministic for the phase). With the counters at
   0, one ``cli.train.main`` call trains state 0 then state 1 with phase
   8's model and data flags and ``--scenario 15 5 --start_state 0
   --end_state 1 --start_epoch 1 --end_epoch 1 --new_state_epoch 1
   --distill true --classifier_loss true --init_method mean``: between
   the states, the similarity pass of the state-0 model over the state-1
   images, the classifier expansion to 20 classes and the state-0
   checkpoint as the frozen teacher. Checks: every total_loss finite;
   ``dist_feat_loss``, ``dist_reg_loss``, ``dist_cls_loss`` and
   ``sim_loss`` in every state-1 micro-step's metrics; one stem launch
   per state-0 micro-step, two per state-1 micro-step (the student under
   autograd, the teacher under no_grad), one per batch of the similarity
   pass, and no other kernel; the state-1 checkpoint's head at 20
   classes; the old-class slots of the head right after the expansion
   equal to the state-0 checkpoint's bit for bit. Then ``main`` again in
   a fresh run directory holding only the state-0 checkpoint and its
   similarity sidecar, ``--start_state 1`` (the cross-state entry): its
   expanded weights equal the first run's bit for bit, the sidecar is
   read back (no second similarity pass), two stem launches per
   micro-step. ``compute_similarity`` of the state-0 model in float32
   with its classification bias raised by 2 (so the old-class gate
   passes; a random model's similarity is all zeros), TF32 off, over one
   batch of 8 state-1 images, on the card and on the CPU: within 1e-5,
   no anchor's gate flipped, nonzero. ``cli.validate --state 1 --epoch
   1`` on the test split of phase 9: finite rows, AP over 20 classes.
   Printed: ``run_batch`` alone per state-1 micro-step (on one epoch of
   batches assembled beforehand) beside phase 8's state-0 figure, the
   teacher's forward alone (CUDA events), the similarity pass in
   images/s, the peak memory and the phase's seconds.
11. State 1 with replay, prototypes and pseudo-labels, in two fresh run
   directories each holding a copy of phase 10's state-0 checkpoint and
   its similarity sidecar (cuDNN deterministic for the phase). With the
   counters at 0, each run builds its trainer from ``cli.train``'s own
   flags (``trainer_from_flags``: phase 8's model and data flags and
   ``--scenario 15 5 --start_state 1 --start_epoch 1 --end_epoch 1
   --new_state_epoch 1 --distill true --every_iter 2``) and drives it
   with ``train_process`` (the cross-state entry): (a) ``--sample_num 2
   --sample_method herd --persuado_label true --enhance_error true
   --final_correction true --mix_data true``; (b) ``--sample_num 2
   --sample_method prototype_herd --prototype_herd_mode slots
   --prototype_loss true``; ``herd_ratio_threshold`` 0 and the prototype
   term from epoch 1 (fields without a flag, set in the config). Checks:
   every total_loss finite; replay micro-steps ran, in (a) each with
   ``enhance_loss``, and the final correction ended within 20 rounds;
   in (b) a finite ``prototype_loss`` in every new-image micro-step;
   the exemplars (in (a) two per old class, 30) do not repeat, hold no
   state-1 class, and equal the ``examplar`` sidecar, ``examplar.txt``
   and the state-1 checkpoint's ``exemplar_ids``; in (a) pseudo-labels
   stored for every new image (their count printed); the stem counter
   equals the passes' batches (herding's two passes and the pseudo-label
   pass in (a), the prototype pass and the prototype-herd scoring pass
   in (b)) plus two per new-image micro-step (student and teacher) and
   one per replay or correction micro-step, and no other kernel ran.
   Then, in float32 with TF32 off, on one unaugmented batch of 8 state-1
   images, the card against the CPU: herding's feature vectors and
   ``compute_prototype_features`` of the state-0 model within 1e-5 of
   their largest |value|, ``prototype_loss_from_batch`` at margin 1e4
   (every pair inside it, so the gradient is not 0) and its gradient
   within 1e-4, and ``generate_pseudo_labels`` of the state-0 model with
   a random classification output conv (pre-bias logit std 1, bias
   raised by 2, threshold 0.2): the same images, counts and classes,
   boxes within 1e-3 px. Printed: each pass in images/s, ``run_batch``
   alone per state-1 micro-step with the prototype term beside phase
   10's, the peak memory and the phase's seconds.
12. The IL battery: MAS, A-GEM and BiC with distillation, random replay
   and pseudo-labels, in a fresh run directory holding a copy of phase
   10's state-0 checkpoint under the ``15_3_2`` tag (the same 15 classes
   and data; cuDNN deterministic for the phase). With the counters at
   0, one ``cli.train.main`` call with phase 8's model and data flags and
   ``--scenario 15 3 2 --start_state 1 --end_state 2 --start_epoch 1
   --end_epoch 1 --new_state_epoch 1 --every_iter 2 --init_method mean
   --distill true --classifier_loss true --sample_num 2 --sample_method
   random --mas true --agem true --bic true --persuado_label true``
   (``--agem_refresh_every`` at its default 1) enters state 1 from the
   state-0 checkpoint and trains states 1 and 2, one epoch each.
   Checks: every total_loss finite and a finite ``mas_loss`` in every
   micro-step; no replay or correction micro-step (A-GEM on); the stem
   counter equals one launch per batch of each pass (two similarity
   passes, two MAS passes, two pseudo-label passes, one A-GEM refresh
   per micro-step, two BiC epochs) plus two per new-image micro-step
   (student and teacher), and no other kernel ran; the MAS importance
   (the trainer's and both sidecars) finite and zero on every excluded
   leaf; the A-GEM projection fired at an apply, or the phase prints
   that <g, g_r> >= 0 at every apply; BiC's state-1 slot moved in state
   1 and carried over unchanged, its state-2 slot moved off (1, 0), and
   the state-2 checkpoint's ``il_meta["bic"]`` equals the trainer's
   scalars. Then ``cli.validate --state 2 --epoch 1 --bic true`` on the
   test split of phase 9 through the ``Evaluator`` with
   ``nms_impl="pallas_fp"`` (one stem and one NMS launch per batch): the
   ``_bic`` JSON and CSV exist, the rows are finite, and the rows of the
   state-1 and state-2 classes differ from ``cli.validate`` without
   ``--bic``. Then, in float32 with TF32 off, on one unaugmented batch of
   2 state-2 images and the state-2 checkpoint, the card (deterministic
   cuDNN; autotuned beside it, printed) against the CPU: one MAS
   importance batch, one A-GEM replay gradient, and one BiC step (its
   gradient, and the change of the alphas and betas), at the train
   step's gradient bar (|d| <= 1e-3 |g_cpu| + 1e-4 max|g_cpu| per leaf).
   A ReLU pre-activation or a max-pool pair within rounding of a tie
   decides where the gradient flows, so at this size rounding alone moves
   a leaf's gradient past that bar: the card's own gradients at weights
   moved by one float32 ulp (four seeds) are computed beside it, and the
   card's worst leaf of the importance and of the replay gradient must
   stay within the larger of the bar and twice the largest of those
   moves; the BiC gradient and step hold the bar.
   Printed: the MAS pass in images/s, the A-GEM refresh in ms
   per refresh and per replay batch, the BiC epoch in images/s,
   ``run_batch`` alone per state-2 micro-step (MAS penalty, projection,
   distillation) beside phase 10's state-1 figure, the peak memory and
   the phase's seconds.
13. Export, in phase 8's and phase 12's temporary run directories (cuDNN
   deterministic for the phase): ``cli.export.main`` at batch 8 with the
   default ``topk_method`` and NMS (``iterative``) of (a) phase 8's
   epoch-2 state-0 R50 (20 classes, 640x1024 fused uint8 frames), (b) the
   same with ``--quantize``, (c) phase 12's state-2 checkpoint with
   ``--bic`` and (c') without it, both at phase 12's validate threshold
   0.001 (its BiC scalars stay within 0.3% of (1, 0), so at 0.05 the
   correction reaches no detection). One fresh process that imports
   ``eval.deploy`` alone loads each artifact and runs it on the 8 frames
   of the first landscape batch of phase 9's test split, its launch
   counters at 0 before one predict. Checks: the process holds no module
   of JAX, of the JAX package or of the port's ``models/``; per predict 1
   bf16 stem launch, 100 int8 launches (61 in conv mode) for (b) and none
   otherwise, no NMS launch; each artifact's boxes, scores, labels and
   valid bits equal the live ``make_predict_fn``'s on the same checkpoint
   and frames bit for bit (``--bic`` through ``bic_correct_from_meta``),
   and (c)'s scores differ from (c')'s. ``cli.serve --from_export`` of
   (a), started in a subprocess once (a) is exported (it loads while the
   others export; the phase waits for its ``/healthz`` before timing),
   answers the 8 frames' PNG files over HTTP from 4 threads. Printed:
   export seconds and MB of each artifact, load seconds in the fresh
   process, the artifact's ms per B=8 predict beside the live predict's
   (numpy frames in, numpy detections out, host clock) and the
   ``{"export": ...}`` line.
14. The mesh's data axis, in phase 8's temporary directory on its toy
   data (R50 bf16, 640x1024 fused uint8, global batch 8, deterministic
   cuDNN): two rank processes, each started with ``--coordinator_address
   127.0.0.1:<free port> --num_processes 2 --process_id r``, on two cards
   over NCCL when there are two, else both on ``cuda:0`` over gloo with
   the collectives through the host (the line says which, and that the
   throughput is then no scaling figure). In one process group each runs
   (a) ``cli.train --mesh true`` state 0 of ``--scenario 15 5`` for one
   epoch (``every_iter`` 2), (b) state 1 from (a)'s checkpoint with phase
   12's battery flags (``--sample_batch_size 4``, which the two ranks
   divide), and (c) ``cli.validate --mesh true --state 1 --bic true`` at
   threshold 0.001 under ``nms_impl="pallas_fp"`` (as phase 12); between
   (b) and (c) the IL passes (similarity, prototypes, herding,
   pseudo-labels, MAS) on (a)'s state-0 model, its classification bias
   raised, split over the ranks; then (d) (a) again with ``--zero1 true``
   and (e) (b) again with ``--zero1 true``, in a second run root, with
   ZeRO-1's ``param_all_gather`` of the R50 timed after (d). Checks:
   the ranks' parameters bit-identical at every epoch's end (the trainer
   raises otherwise; the checksums compared again here), their global
   losses, exemplar ids and BiC scalars equal; only rank 0 wrote into the
   run root (checkpoint renames and array sidecars counted per rank), and
   one process's ``cli.validate`` reads (a)'s checkpoint; per rank 1 stem
   launch per micro-step in (a), 2 in (b), 1 per batch of each IL pass,
   and in (c) one NMS and one stem launch per global batch; (a)'s first
   apply's all-reduced gradient against one process's from the same
   initial weights on the same two global batches, at phase 12's bar
   (the larger of the gradient bar and twice the move that one-ulp
   weight changes, four seeds, give one process's gradient); (c)'s rows
   equal bit for bit one process's ``cli.validate`` in batches of 4 (the
   ranks' batch: the same images in the same slots, so the same cuDNN
   algorithms), and its per-class AP50 one process's in batches of 8
   within 0.005 (bf16 convs of 8 images take other algorithms, which
   move scores by up to two bf16 ulps of their logit); (d)'s and (e)'s
   checkpoints equal (a)'s and (b)'s bit for bit (parameters, whole Adam
   moments, groups, step), as do their checksums, losses, exemplar ids
   and BiC scalars; a pass that splits its batches launches the stem once
   per batch of the rank's share (ceil or floor of the batches / 2), the
   BiC epoch and A-GEM refresh once per global batch; the sharded passes'
   similarity, prototypes, herding picks and pseudo-labels equal one
   process's bit for bit on this card (the MAS importance within rtol
   1e-5). Printed, each beside the card's name and power limit: images/s
   of (a), (b), (d), (e), (a)'s beside one process's ``cli.train`` of the
   same first epoch under the same cuDNN settings, ms per all-reduce of
   the R50's gradient (147 MB, five timed) and per ``param_all_gather``
   (five timed, over gloo on one card, NCCL on two), each IL pass's
   seconds on the ranks (beside the whole passes' earlier seconds) and in
   one process, the Adam moment bytes and peak memory per rank of (a) and
   (d), the phase's seconds, and the ``{"data_axis": ...}`` line.
15. The mesh's model axis, on phase 8's toy data under phase 14's cuDNN
   settings, the ranks started with the process flags (gloo when they
   share a card, NCCL on a host with a card per rank; the line says
   which): (f) ``cli.train --mesh true --num_data 1 --num_model 2`` state
   0 of ``--scenario 15 5`` for one epoch, then four more micro-steps of
   its trainer with the model group's collectives timed between card
   synchronisations, (g) state 1 from (f)'s checkpoint with phase 12's
   battery flags on the same 1 x 2 mesh, (h) ``--num_data 2 --num_model
   2 --zero1 true`` state 0 for one epoch (four ranks) and its four timed
   micro-steps, (i) ``cli.validate --mesh true --num_data 2 --num_model 2
   --state 1 --bic true`` of (g)'s checkpoint under ``pallas_fp``.
   Checks: (f)'s and (h)'s first apply's whole gradient (the trunks'
   slices joined, then reduced over the data group) against phase 14's
   one process from the same initial weights on the same two global
   batches (the same bits, checked), at phase 12's bar; the ranks'
   parameters bit-identical after every epoch (the trainer raises; the
   checksums compared again here) and their global losses equal; a
   rank's slice of ``classification_head.conv1`` (128, 256, 3, 3) and of
   ``conv2`` (256, 128, 3, 3); a trunk weight's Adam moments 1/2 of it
   per rank in (f), 1/4 in (h); 40 collectives of the model group per
   micro-step (2 x 2 heads x 5 levels forward, as many backward) and one
   gradient gather per apply in (f), (g) and (h), 40 per replay batch of
   each A-GEM refresh; stem launches per rank 1 per micro-step in (f)
   and (h), 2 in (g); only rank 0 writes; one process's ``cli.validate``
   reads (f)'s and (h)'s checkpoints; (i)'s rows equal bit for bit one
   process's ``cli.validate`` in batches of 4, each rank one NMS and one
   stem launch per global batch; (g)'s exemplar ids and BiC scalars equal
   on both ranks and finite. Printed, each beside the card's name and
   power limit: images/s of (f), (g), (h) beside phase 14's (a) and (d);
   ms and MB of the model group's collectives per micro-step and ms per
   gradient gather, (f) and (h); Adam moment bytes and peak memory per
   rank beside phase 14's; the phase's seconds; the ``{"model_axis":
   ...}`` line.
17. Tools, after phase 15 and before the lines of 16, in phase 8's
   temporary directory. (a) ``utils.benchlib`` in this process on phase
   4's model and frames, rebuilt from the same seeds: with the counters
   at 0, ``make_predict_sum`` under ``nms_impl="pallas_fp"`` (the stem
   and NMS kernels must have launched) against the summed scores of the
   plain predict (``iterative`` NMS) at rtol 1e-4; ``time_chained``'s
   ms per B=32 predict beside ``cuda_ms``'s and phase 4's. (b) Every
   measuring tool of ``cl_object_detection_tpu_torch.tools`` once on
   the card as a subprocess (``python -m``) at R50 and small
   ``--iters``, in five lanes side by side (``TOOL_LANES``; the figures
   are taken with the other lanes' tools on the card): ``bench_train
   --split``, ``mem_report``, ``bench_split`` (all five modes,
   ``pallas_fp``), ``bench_sweep --mfu``, ``bench_backbone`` (all seven
   modes), ``bench_fwd_floor``, ``bench_bwd_breakdown``, ``bench_nms``,
   ``bench_int8_matmul``, ``bench_loader`` and ``bench_serve`` on phase
   8's checkpoint and toy image. Checks: every tool exits 0; every JSON
   record parses, carries the card's ``nvidia-smi`` line, and its
   figures are finite and positive (a figure the record lists under
   ``differences``, a difference of two timings, finite only); the NMS
   kernel (``bench_nms``), the int8 kernel (``bench_int8_matmul``, both
   modes) and the stem kernel (``bench_backbone``) counted launches;
   ``bench_serve`` at concurrency 1 and 8 answers 16 of 16 requests
   with 0 errors; ``mem_report``'s peak for R50 B=8 608x832 within 10%
   of phase 7's. Printed: each record, each tool's seconds, the phase's
   seconds and the ``{"tools": ...}`` line.
16. The ``{"trainer": ...}``, ``{"eval": ...}``, ``{"il_state1": ...}``,
   ``{"il_replay": ...}``, ``{"il_battery": ...}``, ``{"export": ...}``,
   ``{"data_axis": ...}``, ``{"model_axis": ...}`` and ``{"tools": ...}``
   lines, phase 4's and phase 5's B=32 throughput beside the figures of
   the port before its kernels became ``torch.library`` operators
   (464.67 and 225.81 images/s, H100 80GB HBM3 at 700 W), the kernels'
   JSON line, then the ``{"ok": true, ...}`` line.

``--profile DIR`` adds a
torch.profiler window over two B=32 predicts
after phases 4 and 5 and over two micro-step pairs (two applies) in
phase 7: device time by kernel group, the device's idle share, and the
kernel tables in ``DIR/profile_{predict,predict_int8,train}.txt``; and
passes ``--profile DIR/trainer`` to the trainer of phase 8.
"""
from __future__ import annotations

import functools
import json
import queue
import shutil
import subprocess
import sys
import tempfile
import threading
import time

from cl_object_detection_tpu_torch.utils.benchlib import (
    BF16_FLOPS, FP32_FLOPS, HBM_BYTES_PER_S, INT8_OPS, cuda_ms, finite_positive, graph_ms,
    kernel_counters, launch_counts, smi_line, synthetic_gt)

H, W = 608, 832
NUM_CLASSES = 20
NMS_OPS_PER_PAIR = 14            # 4 min/max, 2 sub, 2 clamp, mul, add, sub, max, div, cmp
STEM_OUT = (7, 15)               # pooled outputs of one stem-kernel unit (csrc/stem_fused.cu)
STEM_WINDOW = 8 * 16             # conv pixels the unit computes, the pool's halo included


def log(msg: str) -> None:
    print(msg, flush=True)


def bf16_ulp(x):
    """The spacing of bfloat16 numbers at |x| (8 significant bits)."""
    import torch

    mag = x.abs().float().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def check_stem(results: dict) -> None:
    import torch
    import torch.nn.functional as F

    from cl_object_detection_tpu_torch.ops import stem_fused as sf

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    k7 = torch.randn(7, 7, 3, 64, generator=g, device=dev) * 0.05
    k3 = sf.pack_stem_kernel(k7).to(torch.bfloat16)
    bias4 = (torch.randn(64, generator=g, device=dev) * 0.1).repeat(4)
    err = 0.0
    for b in (8, 32):
        x = torch.randn(b, H, W, 3, generator=g, device=dev)
        x4 = torch.zeros(b, H // 4, W // 4, 64, device=dev)
        x4[..., :48] = x.reshape(b, H // 4, 4, W // 4, 4, 3).permute(
            0, 1, 3, 2, 4, 5).reshape(b, H // 4, W // 4, 48)
        x4 = x4.to(torch.bfloat16)
        got = sf.stem_fused(x4, k3, bias4)
        ref = sf.stem_fused_reference(x4, k3, bias4)
        torch.cuda.synchronize()
        diff = (got.float() - ref.float()).abs()
        tol = 2 * bf16_ulp(ref.float().abs() + bias4.abs().max())
        bad = int((diff > tol).sum())
        err = max(err, float(diff.max()))
        log(f"stem B={b}: max_abs_err {float(diff.max()):.6g}, "
            f"values beyond 2 bf16 ulps: {bad} of {diff.numel()}")
        if bad or not torch.isfinite(got.float()).all():
            raise AssertionError(f"stem kernel disagrees with the plain version at B={b}")
        ms = cuda_ms(lambda: sf.stem_fused(x4, k3, bias4))
        plain_ms = cuda_ms(lambda: sf.stem_fused_reference(x4, k3, bias4))
        rgb = x.to(torch.bfloat16).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        w7 = k7.permute(3, 2, 0, 1).to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        b64 = bias4[:64].to(torch.bfloat16)
        library_ms = cuda_ms(lambda: F.max_pool2d(
            F.relu(F.conv2d(rgb, w7, b64, stride=2, padding=3)), 3, 2, 1))
        m = b * (H // 4) * (W // 4)
        ops = 2.0 * m * 576 * 256
        nbytes = 2 * x4.numel() * 2 + 576 * 256 * 2 + 256 * 4
        t_ops, t_bytes = ops / BF16_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
        log(f"stem B={b}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, cuDNN "
            f"conv+bias+relu+pool {library_ms:.4f} ms, bound of the packed GEMM "
            f"{max(t_ops, t_bytes):.4f} ms "
            f"({'operations' if t_ops >= t_bytes else 'bytes'}: {ops / 1e9:.1f} GFLOP, "
            f"{nbytes / 1e6:.1f} MB)")
        # the kernel computes 8x16 conv windows for 7x15 pooled outputs
        # (the pool's halo), ragged edges included
        units = b * -(-(H // 4) // STEM_OUT[0]) * -(-(W // 4) // STEM_OUT[1])
        halo = units * STEM_WINDOW / m
        log(f"stem B={b}: bound with the kernel's halo recompute (x{halo:.4f}: {units} "
            f"units of {STEM_WINDOW} conv pixels) {ops * halo / BF16_FLOPS * 1e3:.4f} ms "
            f"(operations: {ops * halo / 1e9:.1f} GFLOP)")
        conv_ops = stem_conv_ops(b)
        conv_bound = conv_ops / BF16_FLOPS * 1e3
        log(f"stem B={b}: bound of the 7x7/2 conv itself (the kernel's bound_ms; the packed "
            f"GEMM's 576 x 256 product is 74% zero blocks) {conv_bound:.4f} ms "
            f"(operations: {conv_ops / 1e9:.1f} GFLOP)")
        results["stem_fused"] = dict(
            name="stem_fused", route="cuda",
            source="cl_object_detection_tpu_torch/csrc/stem_fused.cu",
            replaces="cl_object_detection_tpu/ops/stem_pallas.py:94",
            launches=0, max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=max(conv_bound, t_bytes),
            bound_by="operations" if conv_bound >= t_bytes else "bytes",
            library_ms=library_ms, shape=[b, H // 4, W // 4, 64])
    check_stem_f32(results, x[:8], x4[:8].float(), k7, bias4)


def stem_conv_ops(b: int) -> float:
    """Operations of the 7x7/2 conv (3 -> 64 channels) that the stem
    computes, on b frames of H x W."""
    return 2.0 * b * (H // 2) * (W // 2) * 7 * 7 * 3 * 64


def check_stem_f32(results: dict, x, x4, k7, bias4) -> None:
    """The float32 form on the FMA units (the 7x7 conv from the compact
    weight), TF32 off for the plain version and cuDNN. Checked and timed
    through ``stem_fused`` on the packed kernel, as the model calls it
    (the device-side pack check, then the kernel); the kernel's own
    wrapper ``stem_fused_f32`` on the 7x7 kernel is timed beside it."""
    import torch
    import torch.nn.functional as F

    from cl_object_detection_tpu_torch.ops import stem_fused as sf

    b = x4.shape[0]
    k3 = sf.pack_stem_kernel(k7)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        before = (sf.stem_fused.launches, sf.stem_fused_f32.launches)
        got = sf.stem_fused(x4, k3, bias4)
        ref = sf.stem_fused_reference(x4, k3, bias4)
        direct = sf.stem_fused_f32(x4, k7, bias4)
        torch.cuda.synchronize()
        if (sf.stem_fused.launches, sf.stem_fused_f32.launches) != (before[0], before[1] + 2):
            raise AssertionError("stem f32 did not launch the float32 form")
        if not torch.equal(direct, got):
            raise AssertionError("stem f32 differs between the packed and the 7x7 entry")
        diff = (got - ref).abs()
        bad = int((diff > 1e-4 * (1 + ref.abs())).sum())
        err = float(diff.max())
        log(f"stem f32 B={b}: max_abs_err {err:.6g}, values beyond 1e-4 * (1 + |plain|): "
            f"{bad} of {diff.numel()}")
        if bad or not torch.isfinite(got).all():
            raise AssertionError("stem f32 kernel disagrees with the plain version")
        ms = cuda_ms(lambda: sf.stem_fused(x4, k3, bias4))
        direct_ms = cuda_ms(lambda: sf.stem_fused_f32(x4, k7, bias4))
        plain_ms = cuda_ms(lambda: sf.stem_fused_reference(x4, k3, bias4))
        rgb = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        w7 = k7.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        library_ms = cuda_ms(lambda: F.max_pool2d(
            F.relu(F.conv2d(rgb, w7, bias4[:64], stride=2, padding=3)), 3, 2, 1))
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    m = b * (H // 4) * (W // 4)
    packed_ops = 2.0 * m * 576 * 256
    conv_ops = stem_conv_ops(b)
    nbytes = 2 * x4.numel() * 4 + 147 * 64 * 4 + 256 * 4
    t_ops, t_bytes = conv_ops / FP32_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    units = b * -(-(H // 4) // STEM_OUT[0]) * -(-(W // 4) // STEM_OUT[1])
    halo = units * STEM_WINDOW / m
    log(f"stem f32 B={b}: kernel through stem_fused with the device-side pack check "
        f"{ms:.4f} ms, through stem_fused_f32 on the 7x7 kernel {direct_ms:.4f} ms "
        f"({conv_ops / direct_ms / 1e9:.1f} TFLOP/s of the 7x7 conv), plain "
        f"{plain_ms:.4f} ms, cuDNN conv+bias+relu+pool (f32, TF32 off) {library_ms:.4f} ms; "
        f"bound {max(t_ops, t_bytes):.4f} ms ({'operations' if t_ops >= t_bytes else 'bytes'}: "
        f"the 7x7 conv's {conv_ops / 1e9:.1f} GFLOP at the float32 rate, {nbytes / 1e6:.1f} MB); "
        f"with the windows' halo (x{halo:.4f}) {conv_ops * halo / FP32_FLOPS * 1e3:.4f} ms; "
        f"the packed GEMM's {packed_ops / 1e9:.1f} GFLOP {packed_ops / FP32_FLOPS * 1e3:.4f} ms")
    results["stem_fused_f32"] = dict(
        name="stem_fused_f32", route="cuda",
        source="cl_object_detection_tpu_torch/csrc/stem_fused.cu",
        replaces="cl_object_detection_tpu/ops/stem_pallas.py:94",
        launches=0, max_abs_err=err, ms=ms, plain_ms=plain_ms,
        bound_ms=max(t_ops, t_bytes),
        bound_by="operations" if t_ops >= t_bytes else "bytes",
        library_ms=library_ms, shape=list(x4.shape))


def _nms_inputs(dev, k: int):
    import numpy as np
    import torch

    b = 32
    r = np.random.RandomState(3)
    bb = r.rand(b, k, 4).astype(np.float32) * 600
    bb[..., 2:] = bb[..., :2] + 10 + r.rand(b, k, 2).astype(np.float32) * 60
    ss = np.sort(r.rand(b, k).astype(np.float32), axis=1)[:, ::-1].copy()
    ss[:, int(k * 0.8):] = 0.0
    # image 0: pairs at IoU exactly 0.5 ([x, x+2] vs [x+2/3, x+2+2/3])
    xs = r.rand(k // 2).astype(np.float32) * 500
    bb[0, 0::2] = np.stack([xs, np.zeros_like(xs), xs + 2, np.ones_like(xs)], 1)
    sh = np.float32(2.0 / 3.0)
    bb[0, 1::2] = bb[0, 0::2] + [sh, 0, sh, 0]
    ss[0] = np.sort(r.rand(k).astype(np.float32))[::-1]
    # image 1: identical boxes, exactly one survives
    bb[1] = np.array([10, 10, 50, 50], np.float32)
    return torch.from_numpy(bb).to(dev), torch.from_numpy(ss).to(dev)


def check_nms(results: dict) -> None:
    import torch

    from cl_object_detection_tpu_torch.ops import nms_fp as nf

    dev = torch.device("cuda")
    # k = 1024, the main path's, then 2048 (four times the pairs)
    for k in (1024, 2048):
        boxes, scores = _nms_inputs(dev, k)
        got = nf.nms_fp(boxes, scores, 0.5)
        ref = nf.nms_fp_reference(boxes, scores, 0.5)
        torch.cuda.synchronize()
        mismatches = int((got != ref).sum())
        log(f"nms B=32 k={k}: keep bits differing from the plain version: "
            f"{mismatches}; kept per image {got.sum(1)[:4].tolist()}...")
        if mismatches or int(got[1].sum()) != 1:
            raise AssertionError(f"nms kernel keep masks differ from the plain version at k={k}")
        ms = cuda_ms(lambda: nf.nms_fp(boxes, scores, 0.5))
        in_graph_ms = graph_ms(lambda: nf.nms_fp(boxes, scores, 0.5))
        plain_ms = cuda_ms(lambda: nf.nms_fp_reference(boxes, scores, 0.5),
                           iters=5 if k <= 1024 else 2, warmup=1)
        n_valid = (scores > 0).sum(1).double()
        pairs = float((n_valid * (n_valid - 1) / 2).sum())
        ops = NMS_OPS_PER_PAIR * pairs
        nbytes = boxes.numel() * 4 + scores.numel() * 4 + scores.numel()
        t_ops, t_bytes = ops / FP32_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
        log(f"nms B=32 k={k}: kernel (mask + scan) {ms:.4f} ms a call with the wrapper's "
            f"host time, {in_graph_ms:.4f} ms from a CUDA graph, plain {plain_ms:.4f} ms, "
            f"bound {max(t_ops, t_bytes):.5f} ms ({'operations' if t_ops >= t_bytes else 'bytes'}: "
            f"{pairs:.0f} valid pairs); workspace {nf.workspace_words(32, k) * 4 / 2**20:.2f} MiB")
        if k == 1024:
            results["nms_fp"] = dict(
                name="nms_fp", route="cuda",
                source="cl_object_detection_tpu_torch/csrc/nms_fp.cu",
                replaces="cl_object_detection_tpu/ops/nms_pallas.py:48",
                launches=0, max_abs_err=float(mismatches), ms=ms, plain_ms=plain_ms,
                bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                library_ms=None, shape=[32, 1024])
        del boxes, scores, got, ref


# (name, M, K, N, bias): the TPU tool's shape (its default M = 63232
# rounded down to a multiple of its bm = 512); the im2col GEMMs of five
# 3x3 convs of the quantized R50 predict at 608x832, B=32 (conv mode
# runs those convs on the predict path; the GEMMs stay here as the
# kernel's reference shapes); then the 1x1 convs that GEMM mode runs on
# that path (layer1's expanding and reducing ones, layer3's expanding one)
INT8_SHAPES = (
    ("tool", 62976, 2304, 256, False),
    ("layer1 3x3", 1011712, 576, 64, False),
    ("head trunk P3", 252928, 2304, 256, True),
    ("layer4 3x3", 15808, 4608, 512, False),
    ("fpn.p6", 4160, 18432, 256, True),
    ("head trunk P7", 1120, 2304, 256, True),
    ("layer1 1x1 64->256", 1011712, 64, 256, False),
    ("layer1 1x1 256->64", 1011712, 256, 64, False),
    ("layer3 1x1 256->1024", 63232, 256, 1024, False),
)


def int8_bound(m: int, k: int, n: int):
    """(bound ms, "bytes" or "operations", ops, bytes) of one int8 GEMM
    with bf16 out: each operand read once, the output written once,
    scale and bias."""
    ops = 2.0 * m * k * n
    nbytes = m * k + n * k + m * n * 2 + 8 * n
    t_ops, t_bytes = ops / INT8_OPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes",
            ops, nbytes)


def check_int8_matmul(results: dict) -> None:
    import torch

    from cl_object_detection_tpu_torch.ops import int8_matmul as im

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(4)
    err = 0.0
    for tag, m, k, n, with_bias in INT8_SHAPES:
        x = torch.randint(-127, 128, (m, k), generator=g, device=dev, dtype=torch.int8)
        w = torch.randint(-127, 128, (n, k), generator=g, device=dev, dtype=torch.int8)
        if tag == "tool":
            scale = torch.full((n,), 1e-4, device=dev)
        else:
            scale = torch.rand(n, generator=g, device=dev) * 1e-4
        bias = torch.randn(n, generator=g, device=dev) if with_bias else None
        got = im.int8_matmul(x, w, scale, bias)
        ref = im.int8_matmul_reference(x, w, scale, bias)
        torch.cuda.synchronize()
        bad = int((got != ref).sum())
        err = max(err, float((got.float() - ref.float()).abs().max()))
        ms = graph_ms(lambda: im.int8_matmul(x, w, scale, bias))
        w_kn = w.t()                                    # (K,N), K-contiguous
        library_ms = graph_ms(lambda: torch._int_mm(x, w_kn))
        bound, by, ops, nbytes = int8_bound(m, k, n)
        log(f"int8 GEMM {tag} M={m} K={k} N={n}{' +bias' if with_bias else ''}: "
            f"values differing from the plain version: {bad} of {got.numel()}; kernel "
            f"{ms:.4f} ms (tiles, K splits: {im.tile_plan(m, n, k)}), "
            f"{ops / ms / 1e9:.1f} TOP/s; bound {bound:.4f} ms ({by}: {ops / 1e9:.1f} GOP, "
            f"{nbytes / 1e6:.1f} MB); torch._int_mm {library_ms:.4f} ms")
        if bad or not torch.isfinite(got.float()).all():
            raise AssertionError(f"int8 GEMM disagrees with the plain version at {tag}")
        if tag != "tool":
            continue
        plain_ms = cuda_ms(lambda: im.int8_matmul_reference(x, w, scale, bias), iters=5)
        xb = torch.randn(m, k, generator=g, device=dev, dtype=torch.bfloat16)
        wb = torch.randn(k, n, generator=g, device=dev, dtype=torch.bfloat16)
        bf16_ms = cuda_ms(lambda: torch.matmul(xb, wb))
        log(f"int8 GEMM {tag}: plain {plain_ms:.4f} ms; torch._int_mm (cuBLASLt "
            f"int8 -> int32, the product alone, no dequantize epilogue) "
            f"{library_ms:.4f} ms; bf16 torch.matmul at the same shape {bf16_ms:.4f} ms")
        results["int8_matmul"] = dict(
            name="int8_matmul", route="cuda",
            source="cl_object_detection_tpu_torch/csrc/int8_matmul.cu",
            replaces="tools/bench_int8_matmul.py:28",
            launches=0, max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=bound, bound_by=by, library_ms=library_ms, shape=[m, k, n])
        del xb, wb
    results["int8_matmul"]["max_abs_err"] = err
    try:
        im.int8_matmul(x.float(), w, scale)
    except TypeError:
        log("int8 GEMM f32 operands: refused by the wrapper (the kernel takes int8)")
    else:
        raise AssertionError("int8 GEMM wrapper accepted float32 operands")


# (name, B, H, W, C, N, stride, bias): the 3x3 convs of the quantized R50
# predict at 608x832, B=32, on their NHWC int8 inputs (padding 1); the
# kernels JSON line carries head trunk P4, the conv the TPU tool's GEMM
# shape stands for (M = 32*38*52 = 63232)
CONV_SHAPES = (
    ("layer1 3x3", 32, 152, 208, 64, 64, 1, False),
    ("layer2 3x3 stride 2", 32, 152, 208, 128, 128, 2, False),
    ("head trunk P3", 32, 76, 104, 256, 256, 1, True),
    ("head trunk P4", 32, 38, 52, 256, 256, 1, True),
    ("fpn.p6 stride 2", 32, 19, 26, 2048, 256, 2, True),
    ("head trunk P7", 32, 5, 7, 256, 256, 1, True),
)


def conv_bound(b: int, h: int, w: int, c: int, n: int, m: int):
    """(bound ms, "bytes" or "operations", ops, bytes) of one int8 3x3
    conv with bf16 out: the NHWC input read once, the weight once, the
    output written once, scale and bias."""
    k = 9 * c
    ops = 2.0 * m * k * n
    nbytes = b * h * w * c + n * k + m * n * 2 + 8 * n
    t_ops, t_bytes = ops / INT8_OPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes",
            ops, nbytes)


def operator_overhead() -> dict:
    """Host microseconds per call of each kernel's ``torch.library``
    operator against its direct launch (``_launch_*``, the CUDA
    implementation the operator calls), at small shapes where the host
    bounds both: 200 calls each, in turns, ending in a synchronise. The
    difference is what the dispatcher adds to every launch."""
    import numpy as np
    import torch

    from cl_object_detection_tpu_torch.ops import int8_matmul as im
    from cl_object_detection_tpu_torch.ops import library
    from cl_object_detection_tpu_torch.ops import nms_fp as nf
    from cl_object_detection_tpu_torch.ops import stem_fused as sf

    dev = torch.device("cuda")
    r = np.random.RandomState(31)
    x4 = torch.from_numpy(r.randn(1, 8, 8, 64).astype(np.float32)).to(dev)
    k7 = torch.from_numpy((r.randn(7, 7, 3, 64) * 0.05).astype(np.float32)).to(dev)
    k3 = sf.pack_stem_kernel(k7).bfloat16()
    b4 = torch.zeros(256, device=dev)
    boxes = torch.rand(1, 64, 4, device=dev) * 50
    boxes[..., 2:] += boxes[..., :2] + 5
    scores = torch.sort(torch.rand(1, 64, device=dev), descending=True)[0]
    a = torch.randint(-127, 128, (128, 64), dtype=torch.int8, device=dev)
    w = torch.randint(-127, 128, (64, 64), dtype=torch.int8, device=dev)
    s = torch.ones(64, device=dev)
    xq = torch.randint(-127, 128, (1, 8, 8, 16), dtype=torch.int8, device=dev)
    wq = torch.randint(-127, 128, (64, 144), dtype=torch.int8, device=dev)
    xh = x4.bfloat16()
    calls = {
        "stem_fused_bf16": (lambda: library.stem_fused_bf16(xh, k3, b4),
                            lambda: sf._launch_bf16(xh, k3, b4)),
        "stem_fused_f32": (lambda: library.stem_fused_f32(x4, k7, b4),
                           lambda: sf._launch_f32(x4, k7, b4)),
        "nms_fp": (lambda: library.nms_fp(boxes, scores, 0.5),
                   lambda: nf._launch(boxes, scores, 0.5)),
        "int8_matmul": (lambda: library.int8_matmul(a, w, s, None, torch.bfloat16),
                        lambda: im._launch_gemm(a, w, s, None, torch.bfloat16)),
        "int8_conv_nhwc": (lambda: library.int8_conv_nhwc(xq, wq, s, None, 3, 1, 1,
                                                          torch.bfloat16),
                           lambda: im._launch_conv(xq, wq, s, None, 3, 1, 1, torch.bfloat16)),
    }

    def per_call_us(fn, n=200):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e6

    out = {}
    for name, (op, direct) in calls.items():
        op(), direct()
        runs = [per_call_us(f) for f in (op, direct, direct, op)]
        out[name] = dict(operator_us=(runs[0] + runs[3]) / 2, direct_us=(runs[1] + runs[2]) / 2)
        out[name]["added_us"] = out[name]["operator_us"] - out[name]["direct_us"]
    log("operators: host us per call, the torch.library operator against the direct launch "
        "(200 calls each, operator, direct, direct, operator): " + ", ".join(
            f"{k} {v['operator_us']:.1f} vs {v['direct_us']:.1f} ({v['added_us']:+.1f})"
            for k, v in out.items()))
    return out


def check_int8_conv(results: dict) -> None:
    import torch

    from cl_object_detection_tpu_torch.ops import int8_matmul as im

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(6)
    err = 0.0
    for tag, b, h, w, c, n, stride, with_bias in CONV_SHAPES:
        x = torch.randint(-127, 128, (b, h, w, c), generator=g, device=dev, dtype=torch.int8)
        wt = torch.randint(-127, 128, (n, 9 * c), generator=g, device=dev, dtype=torch.int8)
        scale = torch.rand(n, generator=g, device=dev) * 1e-4
        bias = torch.randn(n, generator=g, device=dev) if with_bias else None
        kw = dict(kernel=3, stride=stride, padding=1)

        def conv():
            return im.int8_conv_nhwc(x, wt, scale, bias, **kw)

        def old_route():                      # im2col on the card + GEMM mode
            cols = im.im2col(x, 3, stride, 1)
            return im.int8_matmul(cols.reshape(-1, 9 * c), wt, scale, bias)

        got = conv()
        ref = im.int8_conv_nhwc_reference(x, wt, scale, bias, **kw)
        torch.cuda.synchronize()
        bad = int((got != ref).sum())
        err = max(err, float((got.float() - ref.float()).abs().max()))
        _, ho, wo, _ = got.shape
        m = b * ho * wo
        del ref
        ms = graph_ms(conv)
        old_ms = graph_ms(old_route)
        cols = im.im2col(x, 3, stride, 1).reshape(m, 9 * c)
        w_kn = wt.t()
        library_ms = graph_ms(lambda: torch._int_mm(cols, w_kn))
        bound, by, ops, nbytes = conv_bound(b, h, w, c, n, m)
        log(f"int8 conv {tag} ({b},{h},{w},{c}) -> N={n}{' +bias' if with_bias else ''}: "
            f"values differing from im2col + the plain GEMM: {bad} of {got.numel()}; "
            f"kernel {ms:.4f} ms (tiles, K splits: {im.tile_plan(m, n, 9 * c, True)}), "
            f"{ops / ms / 1e9:.1f} TOP/s; bound {bound:.4f} ms ({by}: {ops / 1e9:.1f} GOP, "
            f"{nbytes / 1e6:.1f} MB); im2col + GEMM mode {old_ms:.4f} ms; torch._int_mm "
            f"on the explicit patches {library_ms:.4f} ms")
        if bad or not torch.isfinite(got.float()).all():
            raise AssertionError(f"int8 conv disagrees with im2col + the plain GEMM at {tag}")
        if tag == "head trunk P4":
            plain_ms = cuda_ms(lambda: im.int8_conv_nhwc_reference(x, wt, scale, bias, **kw),
                               iters=3, warmup=1)
            log(f"int8 conv {tag}: plain (im2col + float64 product) {plain_ms:.4f} ms")
            results["int8_conv_nhwc"] = dict(
                name="int8_conv_nhwc", route="cuda",
                source="cl_object_detection_tpu_torch/csrc/int8_matmul.cu",
                replaces="tools/bench_int8_matmul.py:28",
                launches=0, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by=by, library_ms=library_ms,
                shape=[b, h, w, c, n])
        del x, wt, got, cols
    results["int8_conv_nhwc"]["max_abs_err"] = err


def build_model(dtype: str = "bfloat16"):
    import math

    import torch

    from cl_object_detection_tpu_torch.config import ModelConfig
    from cl_object_detection_tpu_torch.models.retinanet import create_retinanet

    gen = torch.Generator().manual_seed(0)
    model = create_retinanet(ModelConfig(depth=50, compute_dtype=dtype),
                             NUM_CLASSES, device="cuda", generator=gen)
    with torch.no_grad():
        for head in (model.classification_head, model.regression_head):
            w = head.output.weight
            fan_in = w.shape[1] * w.shape[2] * w.shape[3]
            w.copy_(torch.randn(w.shape, generator=gen).to(w.device) / math.sqrt(fan_in))
    return model


def calibrate_logits(model, frames) -> None:
    """Scale the classifier's output conv so its pre-bias logits have
    std 1.5. The max over 20 classes then clears the 0.05 threshold at
    most anchors despite the prior bias (-4.6), so all k = 1024
    candidates of every image are valid: the NMS works at its full
    size, the heaviest case it meets."""
    import torch

    with torch.inference_mode():
        logits, _ = model(frames, enable_act=False)
    bias = float(model.classification_head.output.bias.detach()[0])
    std = float((logits.float() - bias).std())
    with torch.no_grad():
        model.classification_head.output.weight.mul_(1.5 / std)
    log(f"classifier logit std {std:.4f} before scaling to 1.5")


def make_frames(n: int, seed: int):
    import numpy as np

    r = np.random.RandomState(seed)
    return r.randint(0, 256, (n, H, W, 3)).astype(np.uint8)


def zero_counts() -> None:
    for fn in kernel_counters().values():
        fn.launches = 0


def serve_and_time(predict, frames32, x4, tag: str):
    """One path of the smoke: a warm-up request through the serve device
    thread (cuDNN keeps its plans per thread), then, with every launch
    counter at 0, 16 requests from 4 client threads at max_batch 8 and 10
    timed B=32 predicts. Returns (images/s, ms per batch, launch counts
    of the run, launches per timed predict, the last detections)."""
    import numpy as np
    import torch

    from cl_object_detection_tpu_torch.cli.serve import (
        device_loop, frame_spec, make_run_predict, submit)

    dev = frames32.device
    run_predict = make_run_predict(predict, dev)
    shape, dtype = frame_spec(H, W, s2d=False, fused=True, uint8=True)
    work, stop = queue.Queue(), threading.Event()
    loop = threading.Thread(target=device_loop, args=(work, run_predict, shape, dtype),
                            kwargs=dict(max_batch=8, batch_window_ms=5.0,
                                        request_ttl=300.0, score_thresh=0.3, stop=stop))
    loop.start()
    answers: list = [None] * 16
    latency_ms: list = [0.0] * 16
    try:
        warm = submit(work, np.zeros(shape, dtype), 1.0, timeout=300.0)
        if warm is None or "error" in warm:
            raise AssertionError(f"{tag} serve warm-up failed: {warm}")

        # ---- this path: counters at 0 -> serve loop -> B=32 predict ----
        zero_counts()
        t0 = time.perf_counter()

        def client(c):
            for j in range(4):
                i = c * 4 + j
                t_req = time.perf_counter()
                answers[i] = submit(work, x4[i], 1.0, timeout=300.0)
                latency_ms[i] = (time.perf_counter() - t_req) * 1e3

        clients = [threading.Thread(target=client, args=(c,)) for c in range(4)]
        for t in clients:
            t.start()
        for t in clients:
            t.join(timeout=600)
            if t.is_alive():
                raise AssertionError(f"{tag} serve client did not finish")
    finally:
        stop.set()
        loop.join(timeout=60)
    serve_s = time.perf_counter() - t0
    if loop.is_alive():
        raise AssertionError("serve device loop did not stop")
    failed = [a for a in answers if a is None or "detections" not in a]
    if failed:
        raise AssertionError(f"{tag}: {len(failed)} of 16 requests unanswered: {failed[:2]}")
    served = launch_counts()
    n_det = sum(len(a["detections"]) for a in answers)
    log(f"{tag} serve loop: 16 requests from 4 threads at max_batch 8 answered in "
        f"{serve_s:.3f} s, {n_det} detections above 0.3; launches {served}; request "
        f"latency ms median {float(np.median(latency_ms)):.3f}, max {max(latency_ms):.3f}")

    iters = 10
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        det = predict(frames32)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = launch_counts()
    per_predict = {k: (v - served[k]) / iters for k, v in counts.items()}
    ips = 32 * iters / dt
    log(f"{tag} predict B=32 608x832 R50 bf16 fused-stem pallas_fp: "
        f"{dt / iters * 1e3:.3f} ms per batch, {ips:.2f} images/s (frames resident "
        f"on the card); launches per predict {per_predict}")
    return ips, dt / iters * 1e3, counts, per_predict, det


def check_detections(det, pcfg, batch: int = 32) -> None:
    import torch

    if tuple(det.boxes.shape) != (batch, pcfg.max_detections, 4):
        raise AssertionError(f"bad detection shape {tuple(det.boxes.shape)}")
    if not (torch.isfinite(det.boxes).all() and torch.isfinite(det.scores).all()):
        raise AssertionError("non-finite detections")
    if not ((det.labels >= 0) & (det.labels < NUM_CLASSES)).all():
        raise AssertionError("label out of range")
    if int(det.valid.sum(1).min()) < 1:
        raise AssertionError("an image without a valid detection")


def forward_split(apply_fn, frames32, batch_ms: float, tag: str) -> None:
    """Where the predict time goes: the forward alone; the rest is the
    post-process (top-k sort, decode, clip, NMS, final top-k)."""
    import torch

    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        fwd_ms = cuda_ms(lambda: apply_fn(frames32, enable_act=False), iters=5, warmup=1)
    log(f"{tag} predict B=32 breakdown: forward {fwd_ms:.3f} ms, post-process "
        f"{batch_ms - fwd_ms:.3f} ms (of {batch_ms:.3f} ms); peak memory of the "
        f"forward {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")


def main_path(results: dict, profile_dir: str | None = None):
    """The float path (phase 4); returns what the quantized path reuses."""
    import torch

    from cl_object_detection_tpu_torch.config import PredictConfig
    from cl_object_detection_tpu_torch.data.transforms import space_to_depth
    from cl_object_detection_tpu_torch.eval.predictor import make_predict_fn

    dev = torch.device("cuda")
    torch.backends.cudnn.benchmark = True
    model = build_model()
    rgb = make_frames(32, 5)
    x4 = space_to_depth(rgb, factor=4)
    frames32 = torch.from_numpy(x4).to(dev)
    calibrate_logits(model, frames32[:2])
    pcfg = PredictConfig(nms_impl="pallas_fp")
    predict = make_predict_fn(model, pcfg)
    predict(frames32)                                   # warm-up, B=32
    torch.cuda.synchronize()

    ips, batch_ms, counts, _, det = serve_and_time(predict, frames32, x4, "float")
    for name in ("stem_fused", "nms_fp"):
        if counts[name] <= 0:
            raise AssertionError(f"float path never launched {name}")
        results[name]["launches"] = counts[name]
    if counts["int8_matmul"] or counts["int8_conv_nhwc"] or counts["stem_fused_f32"]:
        raise AssertionError("the float path launched the int8 kernel or the f32 stem")
    forward_split(model, frames32, batch_ms, "float")

    # ---- output checks ----
    check_detections(det, pcfg)
    with torch.inference_mode():
        logits, _ = model(frames32, enable_act=False)
        n_cand = (torch.sigmoid(logits.float().amax(-1)) > pcfg.score_thresh).sum(1)
    log(f"pre-NMS candidates per image (of {logits.shape[1]} anchors): "
        f"min {int(n_cand.min())}, max {int(n_cand.max())}; valid detections per "
        f"image: min {int(det.valid.sum(1).min())}, max {int(det.valid.sum(1).max())}")
    if int(n_cand.min()) < 1:
        raise AssertionError("the NMS saw no valid candidates")
    with torch.inference_mode():
        f_cls, f_reg = model(frames32[:2], enable_act=False)
        rgb2 = torch.from_numpy(rgb[:2]).to(dev)
        r_cls, r_reg = model(rgb2, enable_act=False)
    bias = model.classification_head.output.bias.detach()[0]
    rel_cls = float((f_cls - r_cls).norm() / (r_cls - bias).norm())
    rel_reg = float((f_reg - r_reg).norm() / r_reg.norm())
    log(f"fused-stem vs RGB-stem path (bf16, 2 frames): relative L2 error cls "
        f"{rel_cls:.3e}, reg {rel_reg:.3e} (limit 5e-2)")
    if not (rel_cls < 5e-2 and rel_reg < 5e-2):
        raise AssertionError("fused-stem path disagrees with the RGB-stem path")
    if profile_dir:
        profile_run(lambda: predict(frames32), profile_dir, "profile_predict.txt",
                    "predict B=32")
    return dict(model=model, frames32=frames32, x4=x4, rgb=rgb, ips=ips, f_cls=f_cls)


R50_INT8_GEMMS = 52 + 8 + 2 * 4 * 5     # backbone + FPN + head trunks x levels
R50_INT8_CONVS = 16 + 5 + 2 * 4 * 5     # of them 3x3: backbone + FPN + head trunks


def quantized_path(results: dict, ctx: dict, profile_dir: str | None = None) -> None:
    """The int8 path (phase 5) on the float path's model and frames."""
    import numpy as np
    import torch

    from cl_object_detection_tpu_torch.config import PredictConfig
    from cl_object_detection_tpu_torch.eval.predictor import make_predict_fn
    from cl_object_detection_tpu_torch.ops.quant import quantized_apply

    model, frames32 = ctx["model"], ctx["frames32"]
    pcfg = PredictConfig(nms_impl="pallas_fp", quantize=True)
    qpredict = make_predict_fn(model, pcfg)
    qpredict(frames32)                                  # warm-up, B=32
    torch.cuda.synchronize()

    ips, batch_ms, counts, per_predict, det = serve_and_time(
        qpredict, frames32, ctx["x4"], "int8")
    for name, n in counts.items():
        if name != "stem_fused_f32" and n <= 0:
            raise AssertionError(f"quantized path never launched {name}")
    if counts["stem_fused_f32"]:
        raise AssertionError("the quantized bf16 path launched the f32 stem")
    if per_predict["int8_matmul"] != R50_INT8_GEMMS:
        raise AssertionError(f"{per_predict['int8_matmul']} int8 launches per R50 predict, "
                             f"not {R50_INT8_GEMMS}: the exclusion is wrong")
    if per_predict["int8_conv_nhwc"] != R50_INT8_CONVS:
        raise AssertionError(f"{per_predict['int8_conv_nhwc']} conv-mode launches per R50 "
                             f"predict, not {R50_INT8_CONVS}: the routing is wrong")
    for name in ("int8_matmul", "int8_conv_nhwc"):
        results[name]["launches"] = counts[name]
    ctx["int8_ips"] = ips
    log(f"images/s at B=32: float {ctx['ips']:.2f}, int8 {ips:.2f} "
        f"(int8/float {ips / ctx['ips']:.3f}, same process and card)")
    qapply = quantized_apply(model)
    forward_split(qapply, frames32, batch_ms, "int8")

    # ---- output checks ----
    check_detections(det, pcfg)
    with torch.inference_mode():
        q_cls, _ = qapply(frames32[:2], enable_act=False)
    f = ctx["f_cls"].float().flatten().cpu().numpy()
    q = q_cls.float().flatten().cpu().numpy()
    corr = float(np.corrcoef(f, q)[0, 1])
    bias = float(model.classification_head.output.bias.detach()[0])
    rel = float(np.linalg.norm(q - f) / np.linalg.norm(f - bias))
    log(f"int8 vs float logits (bf16, 2 frames): correlation {corr:.5f} (limit > 0.98), "
        f"relative L2 error {rel:.3e} (of the logits less the prior bias)")
    if not (corr > 0.98 and np.isfinite(q).all()):
        raise AssertionError("quantized logits disagree with the float ones")
    if profile_dir:
        profile_run(lambda: qpredict(frames32), profile_dir, "profile_predict_int8.txt",
                    "predict B=32")


def f32_path(results: dict, ctx: dict) -> None:
    """The float32 model (phase 6) on the float path's frames, TF32 off."""
    import torch

    from cl_object_detection_tpu_torch.config import PredictConfig
    from cl_object_detection_tpu_torch.eval.predictor import make_predict_fn

    frames = ctx["frames32"][:8]
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        model = build_model("float32")
        calibrate_logits(model, frames[:2])
        pcfg = PredictConfig(nms_impl="pallas_fp")
        predict = make_predict_fn(model, pcfg)
        predict(frames)                                 # warm-up, B=8
        torch.cuda.synchronize()

        # ---- this path: counters at 0 -> three B=8 predicts ----
        zero_counts()
        t0 = time.perf_counter()
        for _ in range(3):
            det = predict(frames)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / 3
        counts = launch_counts()
        log(f"f32 predict B=8 608x832 R50 float32 fused-stem pallas_fp (TF32 off): "
            f"{dt * 1e3:.3f} ms per batch, {8 / dt:.2f} images/s; launches {counts}")
        if counts["stem_fused_f32"] <= 0 or counts["nms_fp"] <= 0:
            raise AssertionError("the f32 path never launched the f32 stem or the NMS")
        if counts["stem_fused"] or counts["int8_matmul"] or counts["int8_conv_nhwc"]:
            raise AssertionError("the f32 path launched a bf16 or int8 kernel")
        results["stem_fused_f32"]["launches"] = counts["stem_fused_f32"]

        # ---- output checks ----
        check_detections(det, pcfg, batch=8)
        with torch.inference_mode():
            f_cls, f_reg = model(frames[:2], enable_act=False)
            rgb2 = torch.from_numpy(ctx["rgb"][:2]).to(frames.device)
            r_cls, r_reg = model(rgb2, enable_act=False)
        if f_cls.dtype != torch.float32:
            raise AssertionError(f"the f32 model computed in {f_cls.dtype}")
        bias = model.classification_head.output.bias.detach()[0]
        rel_cls = float((f_cls - r_cls).norm() / (r_cls - bias).norm())
        rel_reg = float((f_reg - r_reg).norm() / r_reg.norm())
        log(f"fused-stem vs RGB-stem path (float32, TF32 off, 2 frames): relative L2 "
            f"error cls {rel_cls:.3e}, reg {rel_reg:.3e} (limit 1e-3)")
        if not (rel_cls < 1e-3 and rel_reg < 1e-3):
            raise AssertionError("f32 fused-stem path disagrees with the RGB-stem path")
    finally:
        torch.backends.cudnn.allow_tf32 = tf32


TRAIN_B = 8
TRAIN_LR = 1e-5


def check_stem_backward(x4) -> None:
    """The stem Function on the train path's (8,152,208,64) bf16 frames:
    the kernel runs the forward, and the backward equals autograd through
    ``stem_fused_reference`` at the same inputs and upstream gradient to
    the bit (cuDNN deterministic for both)."""
    import torch

    from cl_object_detection_tpu_torch.ops import stem_fused as sf

    dev = x4.device
    g = torch.Generator(device=dev).manual_seed(7)
    k3 = sf.pack_stem_kernel(torch.randn(7, 7, 3, 64, generator=g, device=dev) * 0.05)
    k3 = k3.to(torch.bfloat16)
    bias4 = (torch.randn(64, generator=g, device=dev) * 0.1).repeat(4)
    up = torch.randn(x4.shape, generator=g, device=dev).to(torch.bfloat16)
    det, bench = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        ins = [t.detach().clone().requires_grad_(True) for t in (x4, k3, bias4)]
        before = sf.stem_fused.launches
        out = sf.stem_fused(*ins)
        if sf.stem_fused.launches != before + 1 or out.grad_fn is None:
            raise AssertionError("the stem Function did not launch the kernel under grad")
        got = torch.autograd.grad(out, ins, up)
        ref_ins = [t.detach().clone().requires_grad_(True) for t in (x4, k3, bias4)]
        want = torch.autograd.grad(sf.stem_fused_reference(*ref_ins), ref_ins, up)
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = det, bench
    same = [torch.equal(a, b) for a, b in zip(got, want)]

    def through(fn):
        ins = [t.detach().requires_grad_(True) for t in (x4, k3, bias4)]
        return torch.autograd.grad(fn(*ins), ins[1:], up)

    fn_ms = cuda_ms(lambda: through(sf.stem_fused), iters=10, warmup=2)
    plain_ms = cuda_ms(lambda: through(sf.stem_fused_reference), iters=10, warmup=2)
    log(f"stem backward B={x4.shape[0]} (x4, k3, bias4): bit-identical to autograd through "
        f"the plain version: {same}; forward + backward to (k3, bias4) {fn_ms:.4f} ms "
        f"through the Function (kernel forward, plain recompute), {plain_ms:.4f} ms "
        f"through the plain version")
    if not all(same):
        raise AssertionError("the stem Function's backward differs from the plain autograd")


def train_path(ctx: dict, profile_dir: str | None = None) -> dict:
    """Phase 7: the train step on the float path's bf16 R50 and frames."""
    import numpy as np
    import torch

    from cl_object_detection_tpu_torch.config import FocalConfig, ILConfig, ScheduleConfig
    from cl_object_detection_tpu_torch.il.losses import LossStatics, compute_losses
    from cl_object_detection_tpu_torch.ops.anchors import anchors_for_shape
    from cl_object_detection_tpu_torch.train.optim import make_optimizer
    from cl_object_detection_tpu_torch.train.state import TrainState
    from cl_object_detection_tpu_torch.train.step import (
        StepStatics, _clip_by_global_norm, make_train_step)

    model, frames = ctx["model"], ctx["frames32"][:TRAIN_B]
    dev = frames.device
    check_stem_backward(frames.float().div(255.0).to(torch.bfloat16))
    boxes, labels = (torch.from_numpy(a).to(dev) for a in synthetic_gt(TRAIN_B))
    anchors = anchors_for_shape(H, W)
    statics = LossStatics(num_classes=NUM_CLASSES)
    state = TrainState(model, make_optimizer(ScheduleConfig(lr=TRAIN_LR, every_iter=2), model))
    step = make_train_step(model, None, anchors, ILConfig(), FocalConfig(), statics,
                           StepStatics(every_iter=2, grad_clip=0.1))
    bb = model.backbone
    stem_params = {"conv1.weight": bb.conv1.weight, "bn1.weight": bb.bn1.weight,
                   "bn1.bias": bb.bn1.bias}
    before = {k: p.detach().clone() for k, p in stem_params.items()}

    # ---- this path: counters at 0 -> 2 warm-up + 20 timed micro-steps ----
    zero_counts()
    losses = []
    for _ in range(2):
        state, metrics = step(state, frames, boxes, labels)
        losses.append(metrics["total_loss"])
    moved = {k: not torch.equal(before[k], p.detach()) for k, p in stem_params.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    iters = 20
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(iters):
        state, metrics = step(state, frames, boxes, labels)
        losses.append(metrics["total_loss"])
    end.record()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    loss = torch.stack(losses).float().cpu().numpy()
    ms = dt / iters * 1e3
    ips = TRAIN_B * iters / dt
    log(f"train step R50 bf16 608x832 B={TRAIN_B} every_iter=2 fused-stem: {ms:.3f} ms per "
        f"micro-step (host clock; {start.elapsed_time(end) / iters:.3f} ms by CUDA events), "
        f"{ips:.2f} images/s, peak memory {peak / 2**30:.2f} GiB; launches {counts}; "
        f"total_loss first {loss[0]:.5g}, last {loss[-1]:.5g}; metrics of the last "
        f"micro-step {({k: round(float(v), 6) for k, v in metrics.items()})}")
    log(f"stem parameters moved by the first apply: {moved}")
    if counts["stem_fused"] != 2 + iters:
        raise AssertionError(f"{counts['stem_fused']} stem launches in {2 + iters} micro-steps")
    if any(counts[k] for k in ("stem_fused_f32", "nms_fp", "int8_matmul", "int8_conv_nhwc")):
        raise AssertionError("the train path launched another kernel than the bf16 stem")
    if not np.isfinite(loss).all():
        raise AssertionError("non-finite train loss")
    if not all(moved.values()):
        raise AssertionError(f"the first apply did not move every stem parameter: {moved}")

    # ---- where a micro-step's time goes (CUDA events) ----
    anchors_t = torch.from_numpy(anchors.copy()).to(dev)

    def forward():
        with torch.enable_grad():
            return compute_losses(model, frames, boxes, labels, anchors_t, ILConfig(),
                                  FocalConfig(), statics)[0]

    def forward_backward():
        forward().backward()
        model.zero_grad(set_to_none=True)

    fwd_ms = cuda_ms(forward, iters=5, warmup=1)
    fwd_bwd_ms = cuda_ms(forward_backward, iters=5, warmup=1)
    forward().backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    clip_ms = cuda_ms(lambda: _clip_by_global_norm(grads, 0.1), iters=10, warmup=2)
    adam_ms = cuda_ms(state.optimizer.step, iters=10, warmup=2)
    model.zero_grad(set_to_none=True)
    log(f"train micro-step split (CUDA events): forward + loss {fwd_ms:.3f} ms, backward "
        f"{fwd_bwd_ms - fwd_ms:.3f} ms, optimizer per apply {clip_ms + adam_ms:.3f} ms (clip "
        f"{clip_ms:.3f}, Adam {adam_ms:.3f}; every second micro-step applies), of "
        f"{ms:.3f} ms per micro-step")

    # ---- one remat micro-step beside a plain one ----
    def one_micro_step():
        """(ms, peak bytes) of one micro-step that does not apply, then
        the applying one of its pair, untimed."""
        nonlocal state
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        state, _ = step(state, frames, boxes, labels)
        e1.record()
        torch.cuda.synchronize()
        out = (e0.elapsed_time(e1), torch.cuda.max_memory_allocated())
        state, _ = step(state, frames, boxes, labels)
        return out

    if state.acc_count != 0:
        raise AssertionError("the timed run ended inside an accumulation")
    plain_ms, plain_peak = one_micro_step()
    bb.remat = True
    try:
        one_micro_step()                                    # warm-up
        remat_ms, remat_peak = one_micro_step()
    finally:
        bb.remat = False
    log(f"remat: one micro-step {remat_ms:.3f} ms, peak {remat_peak / 2**30:.2f} GiB; "
        f"plain {plain_ms:.3f} ms, peak {plain_peak / 2**30:.2f} GiB")
    if profile_dir:
        def pair():
            for _ in range(2):
                step(state, frames, boxes, labels)
        profile_run(pair, profile_dir, "profile_train.txt",
                    f"micro-step pair B={TRAIN_B} (one apply)")
    check_train_f32_small()
    return dict(images_per_s=ips, ms_per_micro_step=ms, forward_ms=fwd_ms,
                backward_ms=fwd_bwd_ms - fwd_ms, clip_ms=clip_ms, adam_ms=adam_ms,
                peak_gib=peak / 2**30, remat_ms=remat_ms, remat_peak_gib=remat_peak / 2**30,
                plain_ms=plain_ms, plain_peak_gib=plain_peak / 2**30,
                stem_launches_per_micro_step=counts["stem_fused"] / (2 + iters))


def check_train_f32_small() -> None:
    """One every_iter=1 apply (clip 0.1, Adam, lr 1e-4) of a float32 R18
    (FPN 32, 2 head layers, 3 classes) on 2 fused 64x96 frames, on the
    card (TF32 off: the stem's float32 form under grad) and on the CPU
    from the same weights: metrics at rtol 1e-4, gradients at
    |d| <= 1e-3 |g_cpu| + 1e-4 max|g_cpu| per leaf, parameter deltas
    within 1e-3 lr plus one float32 spacing where |g_cpu| >= 1e-3
    max|g_cpu|, everywhere at most lr (1 + 1e-6) plus that spacing."""
    import copy
    import math

    import numpy as np
    import torch

    from cl_object_detection_tpu_torch.config import (
        FocalConfig, ILConfig, ModelConfig, ScheduleConfig)
    from cl_object_detection_tpu_torch.data.transforms import space_to_depth
    from cl_object_detection_tpu_torch.il.losses import LossStatics, compute_losses
    from cl_object_detection_tpu_torch.models.retinanet import create_retinanet
    from cl_object_detection_tpu_torch.ops import stem_fused as sf
    from cl_object_detection_tpu_torch.ops.anchors import anchors_for_shape
    from cl_object_detection_tpu_torch.train.optim import make_optimizer
    from cl_object_detection_tpu_torch.train.state import TrainState
    from cl_object_detection_tpu_torch.train.step import StepStatics, make_train_step

    gen = torch.Generator().manual_seed(11)
    cpu_model = create_retinanet(ModelConfig(depth=18, fpn_channels=32, head_layers=2,
                                             compute_dtype="float32"), 3, device="cpu",
                                 generator=gen)
    with torch.no_grad():
        for head in (cpu_model.classification_head, cpu_model.regression_head):
            w = head.output.weight
            w.copy_(torch.randn(w.shape, generator=gen) / math.sqrt(w[0].numel()))
    r = np.random.RandomState(14)
    img = r.randint(0, 256, (2, 64, 96, 3)).astype(np.uint8)
    boxes = np.full((2, 4, 4), -1, np.float32)
    labels = np.full((2, 4), -1, np.int32)
    boxes[0, :2] = [[4, 6, 40, 44], [30, 10, 80, 50]]
    labels[0, :2] = [0, 2]
    boxes[1, 0], labels[1, 0] = [10, 20, 60, 60], 1
    batch_np = (space_to_depth(img, factor=4), boxes, labels)
    anchors = anchors_for_shape(64, 96)
    lr = 1e-4
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    results = []
    try:
        for device in ("cpu", "cuda"):
            model = copy.deepcopy(cpu_model).to(device)
            batch = tuple(torch.from_numpy(a).to(device) for a in batch_np)
            p0 = {n: p.detach().cpu().numpy().copy() for n, p in model.named_parameters()}
            total, _ = compute_losses(model, *batch,
                                      torch.from_numpy(anchors.copy()).to(device), ILConfig(),
                                      FocalConfig(), LossStatics(num_classes=3))
            total.backward()
            grads = {n: p.grad.cpu().numpy().copy() for n, p in model.named_parameters()}
            model.zero_grad(set_to_none=True)
            state = TrainState(model, make_optimizer(ScheduleConfig(lr=lr, every_iter=1), model))
            step = make_train_step(model, None, anchors, ILConfig(), FocalConfig(),
                                   LossStatics(num_classes=3),
                                   StepStatics(every_iter=1, grad_clip=0.1))
            before = sf.stem_fused_f32.launches
            state, metrics = step(state, *batch)
            if device == "cuda":
                torch.cuda.synchronize()
                if sf.stem_fused_f32.launches != before + 1:
                    raise AssertionError("the float32 train step did not launch the f32 stem")
            p1 = {n: p.detach().cpu().numpy() for n, p in model.named_parameters()}
            results.append((grads, {k: float(v) for k, v in metrics.items()},
                            {k: p1[k] - p0[k] for k in p0}, p0))
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    (g_cpu, m_cpu, d_cpu, p0), (g_dev, m_dev, d_dev, _) = results
    worst_metric = max(abs(m_dev[k] - m_cpu[k]) / abs(m_cpu[k]) for k in m_cpu)
    bad_grad = sum(int((np.abs(g_dev[k] - w) > 1e-3 * np.abs(w) + 1e-4 * np.abs(w).max()).sum())
                   for k, w in g_cpu.items())
    bad_delta = 0
    for k, w in d_cpu.items():
        ulp = np.spacing(np.abs(p0[k]))
        g = np.abs(g_cpu[k])
        sel = g >= 1e-3 * g.max()
        bad_delta += int((np.abs(d_dev[k] - w)[sel] > (1e-3 * lr + ulp)[sel]).sum())
        bad_delta += int((np.abs(d_dev[k]) > lr * (1 + 1e-6) + ulp).sum())
    log(f"train f32 small model, card vs CPU (TF32 off): metrics max relative difference "
        f"{worst_metric:.3g} (limit 1e-4); gradient values beyond their tolerance: {bad_grad}; "
        f"parameter deltas beyond their bars: {bad_delta}")
    if not (worst_metric <= 1e-4 and bad_grad == 0 and bad_delta == 0):
        raise AssertionError("the float32 train step on the card disagrees with the CPU")


VOC_CLASSES = ("aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
               "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
               "pottedplant", "sheep", "sofa", "train", "tvmonitor")
TRAINER_IMAGES = 96              # 64 landscape + 32 portrait: 12 micro-steps per epoch at B=8


def trainer_path(step_ips: float, tmp: str, profile_dir: str | None = None) -> dict:
    """Phase 8: the trainer through ``cli.train.main`` on a toy dataset in
    ``tmp`` (``data/`` and ``run/``, which phase 9 reuses)."""
    import json as _json
    import os

    import numpy as np
    import torch

    from cl_object_detection_tpu_torch.cli.train import main as train_main
    from cl_object_detection_tpu_torch.utils.checkpoint import host_copy
    from cl_object_detection_tpu_torch.utils.toydata import make_toy_dataset

    det, bench = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        t0 = time.perf_counter()
        data = os.path.join(tmp, "data")
        json_path = make_toy_dataset(data, num_images=TRAINER_IMAGES, classes=VOC_CLASSES,
                                     image_size=(375, 500), seed=0, style="separable")
        log(f"trainer: toy dataset of {TRAINER_IMAGES} PNG images (375x500, every third "
            f"portrait, 20 classes) written in {time.perf_counter() - t0:.2f} s")
        args = ["--root_dir", os.path.join(tmp, "run"), "--train_json", json_path,
                "--image_dir", os.path.join(data, "images"), "--depth", "50",
                "--scenario", "20", "--start_state", "0", "--batch_size", "8",
                "--every_iter", "2", "--fused_stem", "true", "--transfer_dtype", "uint8",
                "--save_every", "1", "--record", "true"]
        if profile_dir:
            args += ["--profile", os.path.join(profile_dir, "trainer")]

        # ---- this path: counters at 0 -> two epochs through cli.train ----
        zero_counts()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        tr = train_main(args + ["--start_epoch", "1", "--end_epoch", "2"])
        run_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        counts = launch_counts()
        losses = np.asarray(tr.loss_hist, np.float64)
        steps = len(losses)
        log(f"trainer: 2 epochs through cli.train.main in {run_s:.2f} s (model build, "
            f"2 checkpoints and the loader included); {steps} micro-steps; launches {counts}; "
            f"total_loss first {losses[0]:.5g}, last {losses[-1]:.5g}")
        if steps != 24 or not np.isfinite(losses).all():
            raise AssertionError(f"{steps} micro-steps (want 24) or a non-finite loss: {losses}")
        if counts["stem_fused"] != steps:
            raise AssertionError(f"{counts['stem_fused']} stem launches in {steps} micro-steps")
        if any(counts[k] for k in ("stem_fused_f32", "nms_fp", "int8_matmul", "int8_conv_nhwc")):
            raise AssertionError("the trainer launched another kernel than the bf16 stem")
        if tr.ckpt.epochs(0) != [1, 2]:
            raise AssertionError(f"checkpoints {tr.ckpt.epochs(0)}, want epochs 1 and 2")
        saved2 = tr.ckpt.restore(0, 2)[0]["model"]
        live = tr.model.state_dict()
        same2 = set(saved2) == set(live) and all(
            torch.equal(saved2[k], live[k].cpu()) for k in live)
        if not same2:
            raise AssertionError("the epoch-2 checkpoint differs from the live model")
        ep2 = tr.epoch_log[1]
        ips = ep2["images"] / ep2["train_s"]
        saves = [r["save_blocking_s"] * 1e3 for r in tr.epoch_log]
        log(f"trainer epoch 2 (R50 bf16 640x1024 B=8 every_iter=2 fused-stem uint8, "
            f"deterministic cuDNN): {ep2['micro_steps']} micro-steps in {ep2['train_s']:.3f} s, "
            f"{ips:.2f} images/s (host clock, loader included; phase 7's step alone at "
            f"608x832: {step_ips:.2f}); loader {ep2['loader_batch_s'] * 1e3:.1f} ms per batch "
            f"in its thread, the loop waited {ep2['loader_wait_s'] * 1e3:.1f} ms on it in "
            f"all; checkpoint save blocking {', '.join(f'{x:.1f}' for x in saves)} ms "
            f"(epochs 1, 2); peak memory {peak / 2**30:.2f} GiB ({base / 2**30:.2f} GiB "
            f"resident before the phase); epoch 2's checkpoint equals the live model: {same2}")
        idle = None
        if profile_dir:
            with open(os.path.join(profile_dir, "trainer", "summary.json")) as f:
                summary = _json.load(f)
            idle = summary["idle_share"]
            if idle is None:
                raise AssertionError("the profiler recorded no device time over epoch 2")
            log(f"trainer epoch 2 under the profiler: device busy "
                f"{summary['device_busy_ms']:.1f} ms of {summary['wall_ms']:.1f} ms wall, "
                f"idle share {idle:.3f}")

        # ---- resume from epoch 1, train epoch 2 again ----
        # what a resume restores, read from a trainer of the resumed run's
        # flags; then the run itself through cli.train
        probe = trainer_from_flags(args + ["--start_epoch", "2", "--end_epoch", "2"])
        probe.resume(0, 1)
        restored = dict(
            device={next(probe.model.parameters()).device.type} | {
                s["mu"].device.type for s in probe.optimizer.state.values()},
            model=host_copy(probe.model.state_dict()),
            optimizer=host_copy(probe.optimizer.state_dict()))
        del probe
        if profile_dir:
            args[args.index("--profile") + 1] = os.path.join(profile_dir, "trainer_resume")
        tr2 = train_main(args + ["--start_epoch", "2", "--end_epoch", "2"])
        counts2 = launch_counts()
        want = tr.ckpt.restore(0, 1)[0]
        same_model = all(torch.equal(restored["model"][k], want["model"][k])
                         for k in want["model"]) and set(restored["model"]) == set(want["model"])
        ro, wo = restored["optimizer"], want["optimizer"]
        same_opt = ro["param_groups"] == wo["param_groups"] and set(ro["state"]) == set(
            wo["state"]) and all(torch.equal(ro["state"][i][m], wo["state"][i][m])
                                 for i in wo["state"] for m in ("mu", "nu"))
        first_run, resumed = tr.loss_hist[12], tr2.loss_hist[12]
        rel = abs(resumed - first_run) / abs(first_run)
        log(f"trainer resume from epoch 1: parameters and buffers equal the checkpoint "
            f"{same_model}, Adam moments, counts, LR and betas {same_opt}, on "
            f"{sorted(restored['device'])}; first resumed micro-step total_loss "
            f"{resumed:.7g} vs the first run's {first_run:.7g} (relative {rel:.3g}, bar 1e-3); "
            f"stem launches {counts2['stem_fused']} after the resume")
        if not (same_model and same_opt and restored["device"] == {"cuda"}):
            raise AssertionError("the resumed state differs from the epoch-1 checkpoint")
        if not rel <= 1e-3:
            raise AssertionError("the resumed micro-step's loss differs from the first run's")
        if counts2["stem_fused"] != 36 or len(tr2.loss_hist) != 24 or not np.isfinite(
                np.asarray(tr2.loss_hist)).all():
            raise AssertionError(f"resume: {counts2['stem_fused']} stem launches (want 36)")
        if any(counts2[k] for k in ("stem_fused_f32", "nms_fp", "int8_matmul", "int8_conv_nhwc")):
            raise AssertionError("the resumed trainer launched another kernel than the bf16 stem")
        step_ms, stages = trainer_step_and_loader_split(tr)
        return dict(images_per_s_epoch2=ips, step_only_images_per_s=step_ips,
                    loader_ms_per_batch=ep2["loader_batch_s"] * 1e3,
                    loader_wait_ms_epoch2=ep2["loader_wait_s"] * 1e3,
                    save_blocking_ms=saves, peak_gib=peak / 2**30, idle_share_epoch2=idle,
                    step_only_ms_640x1024=step_ms, loader_split=stages,
                    micro_steps=steps + 12, stem_launches=counts2["stem_fused"],
                    resumed_loss_rel=rel)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = det, bench


EVAL_IMAGES = 64                 # 42 landscape + 22 portrait: 9 batches of 8 (6 + 3)


def eval_path(tmp: str) -> dict:
    """Phase 9: evaluation of phase 8's epoch-1 and epoch-2 checkpoints
    through ``cli.validate.main``, then the ``Evaluator`` with the NMS
    kernel, both COCO-protocol paths, GT as detections, the upper bound
    and the decline report, and the int8 path (module docstring)."""
    import json as _json
    import os

    import numpy as np
    import torch

    from cl_object_detection_tpu_torch.cli import validate
    from cl_object_detection_tpu_torch.cli.common import args_to_config
    from cl_object_detection_tpu_torch.config import PredictConfig
    from cl_object_detection_tpu_torch.data.coco import CocoJson
    from cl_object_detection_tpu_torch.eval.evaluator import Evaluator
    from cl_object_detection_tpu_torch.eval.predictor import detections_to_coco, make_predict_fn
    from cl_object_detection_tpu_torch.models.retinanet import create_retinanet
    from cl_object_detection_tpu_torch.states import ILStates
    from cl_object_detection_tpu_torch.utils.checkpoint import CheckpointManager
    from cl_object_detection_tpu_torch.utils.toydata import make_toy_dataset

    t_phase = time.perf_counter()
    data, root = os.path.join(tmp, "data"), os.path.join(tmp, "run")
    test_json = make_toy_dataset(data, num_images=EVAL_IMAGES, classes=VOC_CLASSES,
                                 image_size=(375, 500), seed=1, style="separable", split="test")
    flags = ["--root_dir", root, "--test_json", test_json, "--image_dir",
             os.path.join(data, "images"), "--depth", "50", "--scenario", "20",
             "--batch_size", "8", "--fused_stem", "true", "--transfer_dtype", "uint8",
             "--state", "0", "--threshold", "0.001"]
    result_dir = os.path.join(root, "val_result", "20", "state0")
    det, bench = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    real_multi = Evaluator.predict_dataset_multi
    timing: dict = {}

    def timed_multi(self, *args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_multi(self, *args, **kw)
        torch.cuda.synchronize()
        timing.update(predict_s=time.perf_counter() - t0, batches=len(self.loader),
                      loader_ms=float(np.mean(self.loader.batch_seconds)) * 1e3)
        return out

    try:
        # ---- this path: counters at 0 -> cli.validate, epochs 1 and 2 ----
        Evaluator.predict_dataset_multi = timed_multi
        zero_counts()
        t0 = time.perf_counter()
        res = validate.main(flags + ["--epoch", "1", "2"])
        validate_s = time.perf_counter() - t0
        counts = launch_counts()
        Evaluator.predict_dataset_multi = real_multi
        n_batches = timing["batches"]
        rows = {}
        for e in (1, 2):
            with open(os.path.join(result_dir, f"voc2007_results_epoch{e}.json")) as f:
                rows[e] = _json.load(f)
        csv_path = os.path.join(result_dir, "val_result_1_2.csv")
        log(f"eval: cli.validate.main, epochs 1 and 2 of phase 8's R50 on {EVAL_IMAGES} test "
            f"images (375x500, 640x1024 fused uint8 frames, B=8, {n_batches} batches, threshold "
            f"0.001): {validate_s:.2f} s in all; the decode + predict pass {timing['predict_s']:.3f} "
            f"s, {EVAL_IMAGES / timing['predict_s']:.2f} images/s (host clock, loader included, "
            f"two predicts per batch); loader {timing['loader_ms']:.1f} ms per batch in its "
            f"thread; rows {len(rows[1])}, {len(rows[2])}; mAP50 {res[1].mean_ap50:.4f}, "
            f"{res[2].mean_ap50:.4f}; launches {counts}")
        if not os.path.exists(csv_path):
            raise AssertionError(f"no decline CSV at {csv_path}")
        for e, rs in rows.items():
            flat = np.asarray([r["bbox"] + [r["score"]] for r in rs], np.float64)
            keys = {(r["image_id"], tuple(r["bbox"]), r["score"]) for r in rs}
            if not rs or not np.isfinite(flat).all() or len(keys) != len(rs):
                raise AssertionError(f"epoch {e}: {len(rs)} rows, finite "
                                     f"{bool(np.isfinite(flat).all())}, {len(keys)} distinct")
        if counts["stem_fused"] != 2 * n_batches or counts["nms_fp"] or counts["int8_matmul"]:
            raise AssertionError(f"validate launches {counts}: want {2 * n_batches} bf16 stem "
                                 "launches and no NMS or int8 kernel")

        # ---- the Evaluator with the NMS kernel, on the epoch-2 model ----
        a = validate.get_parser().parse_args(flags)
        cfg = args_to_config(a)
        coco = CocoJson(test_json)
        states = ILStates(list(coco.classes.values()), coco.classes_inverse, ["20"])
        model = create_retinanet(cfg.model, NUM_CLASSES, device="cuda")
        model.load_state_dict(CheckpointManager(os.path.join(root, "checkpoint"), ["20"])
                              .restore(0, 2)[0]["model"])
        ev = Evaluator(coco, states, os.path.join(data, "images"), cfg.data,
                       PredictConfig(score_thresh=0.001, nms_impl="pallas_fp"))
        zero_counts()
        kernel_rows = ev.predict_dataset(model)
        torch.cuda.synchronize()
        ev_counts = launch_counts()
        log(f"eval: Evaluator nms_impl=pallas_fp on epoch 2: {len(kernel_rows)} rows, equal to "
            f"cli.validate's epoch-2 rows: {kernel_rows == rows[2]}; launches {ev_counts}")
        if ev_counts["nms_fp"] != len(ev.loader) or kernel_rows != rows[2]:
            raise AssertionError("the NMS kernel's Evaluator rows differ from validate's, or "
                                 f"{ev_counts['nms_fp']} NMS launches in {len(ev.loader)} batches")

        # ---- both COCO-protocol paths on those rows; GT as detections ----
        t0 = time.perf_counter()
        native = ev.evaluate(kernel_rows, use_native=True)
        native_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        python = ev.evaluate(kernel_rows, use_native=False)
        python_s = time.perf_counter() - t0
        worst = max(max(abs(native.ap50[n] - python.ap50[n]),
                        abs(native.recall[n] - python.recall[n])) for n in native.ap50)
        log(f"eval: COCO protocol on {len(kernel_rows)} rows x 20 classes: native "
            f"{native_s:.3f} s, Python {python_s:.3f} s; largest AP/AR difference {worst:.3g} "
            f"(bar 1e-6)")
        if not worst <= 1e-6:
            raise AssertionError("the native COCO-protocol path disagrees with the Python path")
        gt_rows = [{"image_id": i, "category_id": a_["category_id"], "bbox": a_["bbox"],
                    "score": 1.0} for i in ev.dataset.image_ids for a_ in coco.get_anns_by_img(i)]
        perfect = ev.evaluate(gt_rows)
        with_gt = [n for n in perfect.ap50 if perfect.ap50[n] != -1.0]
        if not with_gt or any(perfect.ap50[n] != 1.0 or perfect.recall[n] != 1.0
                              for n in with_gt):
            raise AssertionError(f"GT as detections: AP {perfect.ap50}, AR {perfect.recall}")
        log(f"eval: GT as detections ({len(gt_rows)} rows): AP = AR = 1.0 for all "
            f"{len(with_gt)} classes with GT")

        # ---- the upper bound, then a decline of 0.0% for that epoch ----
        validate.main(flags + ["--epoch", "2", "--just_val", "true", "--save_upper_bound",
                               "true"])
        validate.main(flags + ["--epoch", "2", "--just_val", "true"])
        with open(os.path.join(result_dir, "val_result_2.csv")) as f:
            table = {line.split(",")[0]: line.split(",")[1:] for line in f.read().splitlines()}
        bad = [n for n in with_gt + ["Mean", "Sum_decline"] if table[n][2:4] != ["0.0%", "0.0%"]]
        bad += [n for n in perfect.ap50 if n not in with_gt and table[n][0] != "-1.0"]
        if bad:
            raise AssertionError(f"decline against the epoch's own upper bound: {bad}")
        log("eval: --save_upper_bound then --just_val on epoch 2: 0.0% decline on every "
            f"class with GT ({len(with_gt)}), Mean and Sum_decline")

        # ---- the int8 path: counters at 0 -> cli.validate --quantize ----
        zero_counts()
        t0 = time.perf_counter()
        qres = validate.main(flags + ["--epoch", "2", "--quantize", "true", "--new_folder",
                                      "true", "--specific_folder", "int8"])
        quant_s = time.perf_counter() - t0
        qcounts = launch_counts()
        log(f"eval: cli.validate --quantize true, epoch 2: {quant_s:.2f} s; mAP50 "
            f"{qres[2].mean_ap50:.4f} (float {res[2].mean_ap50:.4f}), AR "
            f"{qres[2].mean_recall:.4f} (float {res[2].mean_recall:.4f}); launches {qcounts}")
        if (qcounts["int8_matmul"] != 100 * n_batches
                or qcounts["int8_conv_nhwc"] != 61 * n_batches or qcounts["stem_fused"]
                != n_batches):
            raise AssertionError(f"int8 launches {qcounts}: want {100 * n_batches} "
                                 f"({61 * n_batches} in conv mode)")
        int8_err = check_int8_at_eval_frame()

        # ---- the pass's parts alone: predict, rows, the loader ----
        batch = next(iter(ev.loader))
        images = torch.from_numpy(batch.images).cuda()
        predict = make_predict_fn(model, PredictConfig(score_thresh=0.001))
        predict_ms = cuda_ms(lambda: predict(images), iters=10, warmup=2)
        det8 = predict(images)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            batch_rows = detections_to_coco(det8, batch, ev.label_to_cat, 0.001)
        rows_ms = (time.perf_counter() - t0) / 10 * 1e3
        t0 = time.perf_counter()
        n = sum(1 for _ in ev.loader)
        loader_alone_ms = (time.perf_counter() - t0) / n * 1e3
        log(f"eval: the pass's parts alone, B=8 at 640x1024: predict {predict_ms:.3f} ms per "
            f"batch (landscape, frames resident); detections_to_coco {rows_ms:.3f} ms per "
            f"batch ({len(batch_rows)} rows, the host copy included); the loader "
            f"{loader_alone_ms:.1f} ms per batch over the split ({n} batches, its "
            f"{cfg.data.num_workers} threads, nothing beside it)")
    finally:
        Evaluator.predict_dataset_multi = real_multi
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = det, bench
    phase_s = time.perf_counter() - t_phase
    log(f"eval: phase 9 took {phase_s:.1f} s")
    return dict(images=EVAL_IMAGES, batches=n_batches, validate_s=validate_s,
                validate_images_per_s=EVAL_IMAGES / timing["predict_s"],
                loader_ms_per_batch=timing["loader_ms"], predict_ms_b8=predict_ms,
                rows_ms_b8=rows_ms, loader_alone_ms_per_batch=loader_alone_ms,
                coco_native_s=native_s, coco_python_s=python_s, rows_epoch2=len(rows[2]),
                map50=[res[1].mean_ap50, res[2].mean_ap50], ar=[res[1].mean_recall,
                                                                res[2].mean_recall],
                map50_int8=qres[2].mean_ap50, launches_validate=counts,
                launches_evaluator=ev_counts, launches_int8=qcounts,
                native_vs_python=worst, int8_eval_frame_max_abs_err=int8_err,
                phase_s=phase_s)


IL_MODEL_FLAGS = ["--scenario", "15", "5", "--depth", "50", "--batch_size", "8",
                  "--fused_stem", "true", "--transfer_dtype", "uint8"]
IL_TRAIN_FLAGS = ["--every_iter", "2", "--save_every", "1", "--record", "false", "--distill",
                  "true", "--classifier_loss", "true", "--init_method", "mean",
                  "--new_state_epoch", "1"]
SIM_BIAS_RAISE = 2.0             # on the state-0 head: its old-class gate then passes
SIM_ATOL = 1e-5                  # card against CPU, float32, TF32 off


def il_state1_path(tmp: str, state0_step_ms: float) -> dict:
    """Phase 10: state 0 then state 1 through ``cli.train.main`` on phase
    8's toy data, the cross-state entry, the similarity on the card
    against the CPU, and ``cli.validate`` at state 1 (module docstring)."""
    import os

    import numpy as np
    import torch

    from cl_object_detection_tpu_torch.cli import validate
    from cl_object_detection_tpu_torch.cli.train import main as train_main
    from cl_object_detection_tpu_torch.models.expand import HEAD_BIAS, HEAD_WEIGHT
    from cl_object_detection_tpu_torch.ops.stem_fused import stem_fused
    from cl_object_detection_tpu_torch.train import trainer as trainer_mod
    from cl_object_detection_tpu_torch.utils.checkpoint import host_copy

    t_phase = time.perf_counter()
    data = os.path.join(tmp, "data")
    flags = ["--train_json", os.path.join(data, "train.json"), "--image_dir",
             os.path.join(data, "images")] + IL_MODEL_FLAGS + IL_TRAIN_FLAGS
    ILTrainer = trainer_mod.ILTrainer
    real = (ILTrainer.run_batch, ILTrainer._expand_training_tools,
            trainer_mod.compute_similarity)
    steps, expanded, sims = [], [], []

    def run_batch(self, batch, *args, **kw):
        before = stem_fused.launches
        out = real[0](self, batch, *args, **kw)
        steps.append((self.cur_state, stem_fused.launches - before, sorted(out)))
        return out

    def expand(self):
        real[1](self)
        expanded.append(host_copy(self.model.state_dict()))

    def similarity(model, anchors, loader, num_new, num_old, mesh=None):
        torch.cuda.synchronize()
        before, t0 = stem_fused.launches, time.perf_counter()
        out = real[2](model, anchors, loader, num_new, num_old, mesh=mesh)
        torch.cuda.synchronize()
        sims.append(dict(s=time.perf_counter() - t0, launches=stem_fused.launches - before,
                         batches=len(loader), images=len(loader.dataset)))
        return out

    det, bench = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    ILTrainer.run_batch, ILTrainer._expand_training_tools = run_batch, expand
    trainer_mod.compute_similarity = similarity
    try:
        # ---- this path: counters at 0 -> state 0, then state 1 ----
        root = os.path.join(tmp, "run_il")
        zero_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        tr = train_main(["--root_dir", root, "--start_state", "0", "--end_state", "1",
                         "--start_epoch", "1", "--end_epoch", "1"] + flags)
        run_s = time.perf_counter() - t0
        counts = launch_counts()
        losses = np.asarray(tr.loss_hist, np.float64)
        per_state = {k: [n for st, n, _ in steps if st == k] for k in (0, 1)}
        keys1 = set.intersection(*(set(ks) for st, _, ks in steps if st == 1))
        log(f"il state 1: cli.train.main, state 0 then state 1 (scenario 15+5, R50 bf16 "
            f"640x1024 B=8 every_iter=2, distill, classifier_loss, init mean): {run_s:.2f} s; "
            f"micro-steps {len(per_state[0])} + {len(per_state[1])}; stem launches per "
            f"micro-step: state 0 {sorted(set(per_state[0]))}, state 1 "
            f"{sorted(set(per_state[1]))}; similarity pass {sims[0]}; launches {counts}; "
            f"state-1 metric keys {sorted(keys1)}")
        if not (len(losses) == len(steps) and np.isfinite(losses).all() and per_state[1]):
            raise AssertionError(f"losses {losses} over {len(steps)} micro-steps")
        if set(per_state[0]) != {1} or set(per_state[1]) != {2}:
            raise AssertionError("want 1 stem launch per state-0 and 2 per state-1 micro-step")
        if len(sims) != 1 or sims[0]["launches"] != sims[0]["batches"]:
            raise AssertionError(f"similarity pass: {sims}, want one stem launch per batch")
        if counts["stem_fused"] != sum(per_state[0]) + sum(per_state[1]) + sims[0]["launches"] \
                or any(counts[k] for k in ("stem_fused_f32", "nms_fp", "int8_matmul",
                                           "int8_conv_nhwc")):
            raise AssertionError(f"launches {counts}")
        want_keys = {"dist_feat_loss", "dist_reg_loss", "dist_cls_loss", "sim_loss"}
        if not want_keys <= keys1:
            raise AssertionError(f"state-1 metrics {sorted(keys1)} lack {want_keys - keys1}")
        s0 = tr.ckpt.restore(0, 1)[0]["model"]
        s1 = tr.ckpt.restore(1, 1)[0]["model"]
        old_same = torch.equal(expanded[0][HEAD_WEIGHT].reshape(9, NUM_CLASSES, -1)[:, :15],
                               s0[HEAD_WEIGHT].reshape(9, 15, -1)) and torch.equal(
            expanded[0][HEAD_BIAS].reshape(9, NUM_CLASSES)[:, :15], s0[HEAD_BIAS].reshape(9, 15))
        log(f"il state 1: state-1 checkpoint head {tuple(s1[HEAD_WEIGHT].shape)}; old-class "
            f"slots right after the expansion equal the state-0 checkpoint's: {old_same}")
        if s1[HEAD_WEIGHT].shape[0] != 9 * NUM_CLASSES or not old_same:
            raise AssertionError("the state-1 head is not the expansion of the state-0 head")

        # ---- the cross-state entry from the state-0 checkpoint ----
        entry = os.path.join(tmp, "run_entry")
        src = tr.ckpt.state_dir(0)
        dst = os.path.join(entry, "checkpoint", "15_5", "state0")
        shutil.copytree(os.path.join(src, "epoch1"), os.path.join(dst, "epoch1"))
        shutil.copy(os.path.join(src, "similarity.npz"), dst)
        zero_counts()
        n_steps = len(steps)
        tr2 = train_main(["--root_dir", entry, "--start_state", "1", "--start_epoch", "1",
                          "--end_epoch", "1"] + flags)
        counts2 = launch_counts()
        entry_same = len(expanded) == 2 and set(expanded[1]) == set(expanded[0]) and all(
            torch.equal(expanded[1][k], expanded[0][k]) for k in expanded[0])
        entry_launches = sorted({n for _, n, _ in steps[n_steps:]})
        log(f"il state 1: --start_state 1 from the state-0 checkpoint: expanded weights equal "
            f"next_state's bit for bit: {entry_same}; similarity passes {len(sims)} (the "
            f"sidecar read back); {len(steps) - n_steps} micro-steps, stem launches per "
            f"micro-step {entry_launches}; launches {counts2}")
        if not entry_same or len(sims) != 1 or entry_launches != [2] or not np.isfinite(
                np.asarray(tr2.loss_hist)).all():
            raise AssertionError("the cross-state entry differs from next_state")
        del tr2

        # ---- run_batch alone at state 1, and the teacher's forward ----
        tr.train_loader.set_epoch(2)
        batches = list(tr.train_loader)
        tr.run_batch(batches[0], sync_metrics=False)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in batches:
            m = tr.run_batch(b, sync_metrics=False)
        float(m["total_loss"])
        torch.cuda.synchronize()
        step1_ms = (time.perf_counter() - t0) / len(batches) * 1e3
        x = torch.from_numpy(batches[0].images).cuda()
        with torch.no_grad():
            teacher_ms = cuda_ms(lambda: tr.teacher_model.forward_all(x, False), iters=10)
        peak = torch.cuda.max_memory_allocated()

        # ---- the similarity on the card against the CPU, float32 ----
        sim_err, flips, sim_nonzero = similarity_card_vs_cpu(tr, s0)

        # ---- cli.validate at state 1 ----
        zero_counts()
        res = validate.main(["--root_dir", root, "--test_json", os.path.join(data, "test.json"),
                             "--image_dir", os.path.join(data, "images"), "--state", "1",
                             "--epoch", "1", "--threshold", "0.001"] + IL_MODEL_FLAGS)
        vcounts = launch_counts()
        with open(os.path.join(root, "val_result", "15_5", "state1",
                               "voc2007_results_epoch1.json")) as f:
            rows = json.load(f)
        flat = np.asarray([r["bbox"] + [r["score"]] for r in rows], np.float64)
        classes = {r["category_id"] for r in rows}
        log(f"il state 1: cli.validate --state 1 --epoch 1: {len(rows)} rows over "
            f"{len(classes)} classes, AP50 over {len(res[1].ap50)} classes, mAP50 "
            f"{res[1].mean_ap50:.4f}; launches {vcounts}")
        if not rows or not np.isfinite(flat).all() or len(res[1].ap50) != NUM_CLASSES \
                or not classes <= set(range(1, NUM_CLASSES + 1)):
            raise AssertionError("cli.validate at state 1: rows not finite or not 20 classes")
    finally:
        ILTrainer.run_batch, ILTrainer._expand_training_tools = real[:2]
        trainer_mod.compute_similarity = real[2]
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = det, bench
    phase_s = time.perf_counter() - t_phase
    sim_ips = sims[0]["images"] / sims[0]["s"]
    log(f"il state 1 (R50 bf16 640x1024 B=8, deterministic cuDNN): run_batch alone "
        f"{step1_ms:.1f} ms per state-1 micro-step (phase 8's state 0: {state0_step_ms:.1f}); "
        f"the teacher's forward alone {teacher_ms:.2f} ms per batch; the similarity pass "
        f"{sim_ips:.2f} images/s ({sims[0]['images']} images, {sims[0]['batches']} batches); "
        f"peak memory {peak / 2**30:.2f} GiB; phase 10 took {phase_s:.1f} s")
    return dict(state1_step_ms=step1_ms, state0_step_ms=state0_step_ms,
                teacher_forward_ms=teacher_ms, similarity_images_per_s=sim_ips,
                similarity_images=sims[0]["images"], peak_gib=peak / 2**30,
                micro_steps=[len(per_state[0]), len(per_state[1])],
                stem_per_state1_micro_step=2, similarity_card_vs_cpu_max_abs=sim_err,
                similarity_gate_flips=flips, similarity_nonzero=sim_nonzero,
                entry_equal=entry_same, rows_state1=len(rows), map50_state1=res[1].mean_ap50,
                phase_s=phase_s)


REPLAY_TRAIN_FLAGS = ["--start_state", "1", "--start_epoch", "1", "--end_epoch", "1",
                      "--new_state_epoch", "1", "--distill", "true", "--every_iter", "2",
                      "--save_every", "1", "--record", "false"]
REPLAY_RUNS = {
    "a": ["--sample_num", "2", "--sample_method", "herd", "--persuado_label", "true",
          "--enhance_error", "true", "--final_correction", "true", "--mix_data", "true"],
    "b": ["--sample_num", "2", "--sample_method", "prototype_herd", "--prototype_herd_mode",
          "slots", "--prototype_loss", "true"],
}
HERD_RATIO = 0.0                 # every (image, class) pair eligible: the toy boxes are small
PSEUDO_BIAS_RAISE = 2.0          # on a random classification output conv (card vs CPU)
PSEUDO_SCORE = 0.2               # the JAX package's own tests' pseudo-label threshold
PSEUDO_LOGIT_STD = 1.0           # of that conv's pre-bias logits
PROTO_MARGIN = 1e4               # the card-vs-CPU loss: every (new, old) pair inside it


def _replay_override(cfg):
    """The fields without a flag: herding's foreground-ratio threshold,
    and the prototype term from epoch 1 (its start_epoch is 5)."""
    import dataclasses

    il = cfg.il
    return cfg.replace(il=dataclasses.replace(
        il, replay=dataclasses.replace(il.replay, herd_ratio_threshold=HERD_RATIO),
        prototype=dataclasses.replace(il.prototype, start_epoch=0)))


def il_replay_path(tmp: str, state1_step_ms: float) -> dict:
    """Phase 11: state 1 with replay, prototypes and pseudo-labels, two
    runs through ``trainer_from_flags`` + ``train_process`` from phase
    10's state-0 checkpoint, then the IL passes on the card against the
    CPU (module docstring)."""
    import os

    import numpy as np
    import torch

    from cl_object_detection_tpu_torch.data.loader import BatchLoader
    from cl_object_detection_tpu_torch.il import herding
    from cl_object_detection_tpu_torch.ops.stem_fused import stem_fused
    from cl_object_detection_tpu_torch.train import trainer as trainer_mod
    from cl_object_detection_tpu_torch.train.loop import train_process

    t_phase = time.perf_counter()
    data = os.path.join(tmp, "data")
    src = os.path.join(tmp, "run_il", "checkpoint", "15_5", "state0")
    flags = ["--train_json", os.path.join(data, "train.json"), "--image_dir",
             os.path.join(data, "images")] + IL_MODEL_FLAGS + REPLAY_TRAIN_FLAGS
    ILTrainer = trainer_mod.ILTrainer
    names = ("compute_prototype_features", "prototype_herd_slot_scores",
             "generate_pseudo_labels")
    real = dict(run_batch=ILTrainer.run_batch, herd=herding.HerdSampler.sample,
                **{n: getattr(trainer_mod, n) for n in names})
    steps, passes = [], []

    def run_batch(self, batch, is_replay=False, sync_metrics=True, correction=False):
        before = stem_fused.launches
        m = real["run_batch"](self, batch, is_replay=is_replay, sync_metrics=sync_metrics,
                              correction=correction)
        steps.append(dict(replay=is_replay, correction=correction,
                          launches=stem_fused.launches - before, metrics=m))
        return m

    def timed(name, fn, loader_of, per_loader=1):
        def wrapper(*args, **kw):
            n = len(loader_of(*args)) * per_loader
            images = len(loader_of(*args).dataset) * per_loader
            torch.cuda.synchronize()
            before, t0 = stem_fused.launches, time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            passes.append(dict(name=name, s=time.perf_counter() - t0, batches=n,
                               images=images, launches=stem_fused.launches - before))
            return out
        return wrapper

    def unaugmented(dataset, cfg):
        return BatchLoader(dataset, cfg, shuffle=False, augment=False)

    det, bench = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    ILTrainer.run_batch = run_batch
    herding.HerdSampler.sample = timed("herding", real["herd"],
                                       lambda self, m, ds, cfg, *a: unaugmented(ds, cfg), 2)
    trainer_mod.compute_prototype_features = timed(
        "prototypes", real[names[0]], lambda m, anchors, loader, *a: loader)
    trainer_mod.prototype_herd_slot_scores = timed(
        "prototype_herd_slots", real[names[1]],
        lambda m, anchors, ds, cfg, *a: unaugmented(ds, cfg))
    trainer_mod.generate_pseudo_labels = timed(
        "pseudo_labels", real[names[2]], lambda m, ds, cfg, *a: unaugmented(ds, cfg))
    runs = {}
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for tag, run_flags in REPLAY_RUNS.items():
            # ---- this path: counters at 0 -> the tools, then state 1 ----
            root = os.path.join(tmp, f"run_replay_{tag}")
            dst = os.path.join(root, "checkpoint", "15_5", "state0")
            shutil.copytree(os.path.join(src, "epoch1"), os.path.join(dst, "epoch1"))
            shutil.copy(os.path.join(src, "similarity.npz"), dst)
            del steps[:], passes[:]
            zero_counts()
            t0 = time.perf_counter()
            tr = trainer_from_flags(["--root_dir", root] + flags + run_flags,
                                    override=_replay_override)
            train_process(tr)
            run_s = time.perf_counter() - t0
            counts = launch_counts()
            runs[tag] = check_replay_run(tag, tr, steps, passes, counts, run_s)
            if tag == "b":
                step_ms = state1_step_with_prototype(tr)
            else:
                del tr
        peak = torch.cuda.max_memory_allocated()

        # ---- the IL passes on the card against the CPU, float32 ----
        cvc = replay_card_vs_cpu(tr)
    finally:
        ILTrainer.run_batch, herding.HerdSampler.sample = real["run_batch"], real["herd"]
        for n in names:
            setattr(trainer_mod, n, real[n])
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = det, bench
    phase_s = time.perf_counter() - t_phase
    rates = {p["name"]: p["images"] / p["s"] for r in runs.values() for p in r["passes"]}
    log(f"il replay (R50 bf16 640x1024 B=8, deterministic cuDNN): passes in images/s "
        + ", ".join(f"{k} {v:.2f}" for k, v in rates.items())
        + f"; run_batch alone {step_ms:.1f} ms per state-1 micro-step with the prototype "
        f"term (phase 10's, distillation and similarity: {state1_step_ms:.1f}); peak memory "
        f"{peak / 2**30:.2f} GiB; phase 11 took {phase_s:.1f} s")
    return dict(runs=runs, pass_images_per_s=rates, state1_prototype_step_ms=step_ms,
                state1_step_ms_phase10=state1_step_ms, peak_gib=peak / 2**30,
                card_vs_cpu=cvc, phase_s=phase_s)


def check_replay_run(tag: str, tr, steps, passes, counts, run_s) -> dict:
    """The checks of one phase-11 run (module docstring); returns its
    record."""
    import os

    import numpy as np

    for s in steps:
        s["metrics"] = {k: float(v) for k, v in s["metrics"].items()}
    state1 = [s for s in steps if not s["correction"]]
    new = [s for s in state1 if not s["replay"]]
    replay = [s for s in state1 if s["replay"]]
    corrections = [s for s in steps if s["correction"]]
    losses = np.asarray([s["metrics"]["total_loss"] for s in steps], np.float64)
    ex = list(tr.dataset_replay.image_ids)
    future = set(tr.coco.get_imgs_by_cats(tr.states[1].new_ids))
    meta = tr.ckpt.restore(1, 1)[1]
    with open(os.path.join(tr.ckpt.state_dir(1), "examplar.txt")) as f:
        txt = [int(x) for x in f.read().split()]
    pseudo = tr.dataset_train.pseudo_labels or {}
    n_pseudo = sum(len(a) for a in pseudo.values())
    rounds = len(corrections) / max(len(tr.replay_loader), 1)
    pass_launches = sum(p["launches"] for p in passes)
    pass_batches = sum(p["batches"] for p in passes)
    want_stem = pass_batches + 2 * len(new) + len(replay) + len(corrections)
    log(f"il replay run ({tag}) {' '.join(REPLAY_RUNS[tag])}: {run_s:.2f} s; micro-steps "
        f"{len(new)} new-image + {len(replay)} replay + {len(corrections)} correction "
        f"({rounds:g} rounds of {len(tr.replay_loader)}); stem launches per micro-step "
        f"new {sorted({s['launches'] for s in new})}, replay "
        f"{sorted({s['launches'] for s in replay + corrections})}; passes "
        + ", ".join(f"{p['name']} {p['batches']} batches {p['launches']} launches "
                    f"{p['s']:.2f} s" for p in passes)
        + f"; launches {counts} (want stem {want_stem}); {len(ex)} exemplars {ex}; "
        f"pseudo-labels {n_pseudo} over {len(pseudo)} images")
    if not (len(losses) and np.isfinite(losses).all() and new and replay):
        raise AssertionError(f"run {tag}: losses {losses}, {len(new)} new and {len(replay)} "
                             "replay micro-steps")
    if {s["launches"] for s in new} != {2} or {s["launches"] for s in replay + corrections} \
            - {1} or any(p["launches"] != p["batches"] for p in passes):
        raise AssertionError(f"run {tag}: want 2 stem launches per new-image micro-step, 1 per "
                             "replay one and 1 per batch of each pass")
    if counts["stem_fused"] != want_stem or pass_launches != pass_batches or any(
            counts[k] for k in ("stem_fused_f32", "nms_fp", "int8_matmul", "int8_conv_nhwc")):
        raise AssertionError(f"run {tag}: launches {counts}, want stem {want_stem}")
    if not ex or len(set(ex)) != len(ex) or set(ex) & future or len(ex) > 2 * 15 \
            or meta["exemplar_ids"] != ex or tr.ckpt.load_sidecar(1, "examplar") != ex \
            or txt != ex:
        raise AssertionError(f"run {tag}: exemplars {ex}, checkpoint {meta['exemplar_ids']}")
    if tag == "a":
        if not all("enhance_loss" in s["metrics"] for s in replay) or not corrections \
                or rounds > 20 or rounds != int(rounds):
            raise AssertionError("run a: replay without enhance_loss, or the final "
                                 "correction did not end within 20 rounds")
        if set(pseudo) != set(tr.dataset_train.image_ids):
            raise AssertionError("run a: pseudo-labels not stored for every new image")
        # each old class has two images of its own (the toy set's first 40)
        picked = tr.herd_sampler.examplar_dict
        if len(ex) != 2 * 15 or sorted(picked) != list(range(15)) or any(
                len(ids) != 2 for ids in picked.values()):
            raise AssertionError(f"run a: herding picked {dict(picked)}, want 2 per old class")
    else:
        if not all(np.isfinite(s["metrics"].get("prototype_loss", np.nan)) for s in new):
            raise AssertionError("run b: a new-image micro-step without a finite prototype_loss")
        if tr.prototype_features.shape[:2] != (15, 9) or tr._proto_exemplars != ex:
            raise AssertionError("run b: prototypes or prototype-herd exemplars wrong")
    per_class = {}
    for img_id in ex:
        for c in {a["category_id"] for a in tr.coco.get_anns_by_img(img_id)}:
            per_class[c] = per_class.get(c, 0) + 1
    log(f"il replay run ({tag}): exemplar images per old category "
        f"{dict(sorted(per_class.items()))}")
    return dict(seconds=run_s, micro_steps=[len(new), len(replay), len(corrections)],
                correction_rounds=rounds, exemplars=len(ex), pseudo_labels=n_pseudo,
                launches=counts,
                passes=[{k: p[k] for k in ("name", "batches", "images", "launches", "s")}
                        for p in passes])


def state1_step_with_prototype(tr) -> float:
    """``run_batch`` alone per state-1 micro-step (the prototype term,
    distillation) on one epoch of batches assembled beforehand."""
    import torch

    tr.train_loader.set_epoch(2)
    batches = list(tr.train_loader)
    tr.run_batch(batches[0], sync_metrics=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in batches:
        m = tr.run_batch(b, sync_metrics=False)
    if "prototype_loss" not in m:
        raise AssertionError("the timed state-1 micro-steps ran without the prototype term")
    float(m["total_loss"])
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / len(batches) * 1e3


def replay_card_vs_cpu(tr) -> dict:
    """Phase 11's float32 checks (TF32 off) on one unaugmented batch of 8
    state-1 images, the card against the CPU: herding's feature vectors
    and ``compute_prototype_features`` of the state-0 model within 1e-5
    of their largest |value|; ``prototype_loss_from_batch`` (the batch's
    unfolded features against the slot-averaged prototypes, at margin
    ``PROTO_MARGIN``: at the default 600 the new classes with positives
    in this batch lie outside it and the gradient is 0) and its gradient
    within 1e-4 of its largest |value|; ``generate_pseudo_labels`` of the state-0
    model with a random classification output conv (bias raised by
    ``PSEUDO_BIAS_RAISE``, threshold ``PSEUDO_SCORE``): the same images,
    counts and classes, boxes within 1e-3 px."""
    import copy
    import dataclasses
    import math

    import numpy as np
    import torch

    from cl_object_detection_tpu_torch.config import PseudoLabelConfig
    from cl_object_detection_tpu_torch.data.loader import BatchLoader
    from cl_object_detection_tpu_torch.il import herding, prototype
    from cl_object_detection_tpu_torch.il.pseudo_label import generate_pseudo_labels
    from cl_object_detection_tpu_torch.models.retinanet import create_retinanet
    from cl_object_detection_tpu_torch.ops.boxes import positive_assignment

    s0 = tr.ckpt.restore(0, 1)[0]["model"]
    ds = copy.copy(tr.dataset_train)
    ds.image_ids = list(ds.image_ids[:8])
    ds.pseudo_labels = {}
    batch = next(iter(BatchLoader(ds, tr.cfg.data, shuffle=False, augment=False)))
    anchors = tr.anchors_for(batch.images)
    cfg32 = dataclasses.replace(tr.cfg.model, compute_dtype="float32")
    gen = torch.Generator().manual_seed(21)
    w = s0["classification_head.output.weight"]
    head = dict(weight=torch.randn(w.shape, generator=gen) / math.sqrt(w[0].numel()),
                bias=s0["classification_head.output.bias"] + PSEUDO_BIAS_RAISE)
    std = None
    pcfg = PseudoLabelConfig(enabled=True, score_thresh=PSEUDO_SCORE)
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    got = {}
    try:
        for dev in ("cuda", "cpu"):
            model = create_retinanet(cfg32, 15, device=dev)
            model.load_state_dict(s0)
            x = torch.from_numpy(batch.images).to(dev)
            vec = herding.make_feature_fn(model)(x).cpu().numpy()
            protos = prototype.compute_prototype_features(model, anchors, [batch], 15)
            with torch.no_grad():
                unf = model.classification_features(x)[3]
            a = torch.tensor(anchors, device=dev)
            pos, lab = zip(*(positive_assignment(a, torch.from_numpy(batch.boxes[i]).to(dev),
                                                 torch.from_numpy(batch.labels[i]).to(dev))
                             for i in range(len(x))))
            unf.requires_grad_(True)
            args = (unf, torch.stack(pos), torch.stack(lab),
                    torch.from_numpy(protos.mean(axis=1)).to(dev))
            g600 = torch.autograd.grad(prototype.prototype_loss_from_batch(
                *args, num_past_class=15, num_new_class=5), unf)[0]
            loss = prototype.prototype_loss_from_batch(*args, num_past_class=15,
                                                       num_new_class=5, margin=PROTO_MARGIN)
            loss.backward()
            with torch.no_grad():
                out = model.classification_head.output
                out.weight.copy_(head["weight"].to(dev))
                if std is None:
                    # pre-bias logits of std PSEUDO_LOGIT_STD on this batch (the
                    # card's forward decides, both devices use the result)
                    std = float((model(x, enable_act=False)[0] - out.bias[0]).std())
                    head["weight"] *= PSEUDO_LOGIT_STD / std
                    out.weight.copy_(head["weight"].to(dev))
                out.bias.copy_(head["bias"].to(dev))
            pseudo = generate_pseudo_labels(model, ds, tr.cfg.data, pcfg,
                                            tr.states.inverse_label_map())
            got[dev] = dict(vec=vec, protos=protos, loss=float(loss.detach()),
                            grad=unf.grad.cpu().numpy(), pseudo=pseudo,
                            g600=float(g600.abs().max()))
            del x
            del model, unf
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    c, g = got["cpu"], got["cuda"]
    vec_err = float(np.abs(g["vec"] - c["vec"]).max() / np.abs(c["vec"]).max())
    proto_err = float(np.abs(g["protos"] - c["protos"]).max() / np.abs(c["protos"]).max())
    loss_err = abs(g["loss"] - c["loss"]) / abs(c["loss"])
    grad_err = float(np.abs(g["grad"] - c["grad"]).max() / np.abs(c["grad"]).max())
    same = list(g["pseudo"]) == list(c["pseudo"]) and all(
        [a["category_id"] for a in g["pseudo"][i]] == [a["category_id"] for a in c["pseudo"][i]]
        for i in c["pseudo"])
    box_err = max((float(np.abs(np.subtract(ga["bbox"], ca["bbox"])).max())
                   for i in c["pseudo"] for ga, ca in zip(g["pseudo"][i], c["pseudo"][i])),
                  default=0.0)
    n_pseudo = sum(len(v) for v in c["pseudo"].values())
    log(f"il replay: card against CPU, state-0 R50 float32, TF32 off, 8 state-1 images: "
        f"herding vectors max |diff| / max |value| {vec_err:.3g} (bar 1e-5); prototypes "
        f"{proto_err:.3g} (bar 1e-5; {int((np.abs(c['protos']).sum(axis=2) > 0).sum())} of "
        f"{15 * 9} slots with positives); prototype loss at margin {PROTO_MARGIN:g} "
        f"{c['loss']:.6g} (max |gradient| at margin 600: {c['g600']:.3g}) rel. diff "
        f"{loss_err:.3g}, its gradient {grad_err:.3g} (bar 1e-4); pseudo-labels "
        f"{n_pseudo} on both: same images, counts and classes {same}, boxes max |diff| "
        f"{box_err:.3g} px (bar 1e-3)")
    if not (vec_err <= 1e-5 and proto_err <= 1e-5 and loss_err <= 1e-4 and grad_err <= 1e-4
            and same and box_err <= 1e-3 and n_pseudo and c["loss"] > 0):
        raise AssertionError("the card's IL passes differ from the CPU's")
    return dict(herding_rel=vec_err, prototypes_rel=proto_err, prototype_loss_rel=loss_err,
                prototype_grad_rel=grad_err, pseudo_labels=n_pseudo, pseudo_same=same,
                pseudo_box_max_abs=box_err)


def similarity_card_vs_cpu(tr, s0):
    """``compute_similarity`` of the state-0 model in float32 with its
    classification bias raised by ``SIM_BIAS_RAISE``, on the card (TF32
    off) and on the CPU, over the first unaugmented batch of the state-1
    images: returns the largest |difference|, the anchors whose
    old-class gate (positive, old-class probabilities summing to >= 0.5)
    differs between the two, and the number of nonzero entries."""
    import dataclasses

    import numpy as np
    import torch

    from cl_object_detection_tpu_torch.data.loader import BatchLoader
    from cl_object_detection_tpu_torch.il.weight_init import compute_similarity
    from cl_object_detection_tpu_torch.models.retinanet import create_retinanet
    from cl_object_detection_tpu_torch.ops.boxes import positive_assignment

    loader = BatchLoader(tr.dataset_train, tr.cfg.data, shuffle=False, augment=False)
    batches = [next(iter(loader))]
    cfg32 = dataclasses.replace(tr.cfg.model, compute_dtype="float32")
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    got, gates = {}, {}
    try:
        for dev in ("cuda", "cpu"):
            model = create_retinanet(cfg32, 15, device=dev)
            model.load_state_dict(s0)
            with torch.no_grad():
                model.classification_head.output.bias += PASSES_BIAS_RAISE
            seen = []
            hook = model.register_forward_hook(lambda m, a, out: seen.append(out[0].cpu()))
            got[dev] = compute_similarity(model, tr.anchors_for, batches, 5, 15)
            hook.remove()
            b = batches[0]
            anchors = torch.tensor(tr.anchors_for(b.images))
            p = torch.clamp(seen[0], 1e-4, 1 - 1e-4)
            gates[dev] = torch.stack([
                positive_assignment(anchors, torch.from_numpy(b.boxes[i]),
                                    torch.from_numpy(b.labels[i]))[0] & (p[i].sum(1) >= 0.5)
                for i in range(len(p))])
            del model
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    err = float(np.abs(got["cuda"] - got["cpu"]).max())
    flips = int((gates["cuda"] != gates["cpu"]).sum())
    nonzero = int((got["cpu"] > 0).sum())
    log(f"il state 1: compute_similarity, state-0 R50 float32 (classification bias +"
        f"{SIM_BIAS_RAISE}), {len(batches[0].images)} images: card against CPU max |diff| "
        f"{err:.3g} (bar {SIM_ATOL:g}), gate flips {flips} of {int(gates['cpu'].sum())} "
        f"passing anchors, {nonzero} nonzero entries of {got['cpu'].size}")
    if err > SIM_ATOL or flips or not nonzero:
        raise AssertionError("the card's similarity differs from the CPU's, or is all zeros")
    return err, flips, nonzero


def check_int8_at_eval_frame() -> float:
    """One conv-mode and one GEMM-mode call of the int8 kernel at the eval
    frame (B=8, 640x1024: layer1's 3x3 conv on (8, 160, 256, 64), its
    64 -> 256 1x1 as a GEMM of M = 8 * 160 * 256), each bit-identical to
    its plain version. Returns the largest |difference| (0)."""
    import torch

    from cl_object_detection_tpu_torch.ops import int8_matmul as im

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(9)
    x = torch.randint(-127, 128, (8, 160, 256, 64), generator=g, device=dev, dtype=torch.int8)
    wt = torch.randint(-127, 128, (64, 9 * 64), generator=g, device=dev, dtype=torch.int8)
    scale = torch.rand(64, generator=g, device=dev) * 1e-4
    got = im.int8_conv_nhwc(x, wt, scale, None, kernel=3, stride=1, padding=1)
    ref = im.int8_conv_nhwc_reference(x, wt, scale, None, kernel=3, stride=1, padding=1)
    a = x.reshape(-1, 64)
    w1 = torch.randint(-127, 128, (256, 64), generator=g, device=dev, dtype=torch.int8)
    s1 = torch.rand(256, generator=g, device=dev) * 1e-4
    b1 = torch.randn(256, generator=g, device=dev)
    got1 = im.int8_matmul(a, w1, s1, b1)
    ref1 = im.int8_matmul_reference(a, w1, s1, b1)
    torch.cuda.synchronize()
    bad = int((got != ref).sum()), int((got1 != ref1).sum())
    err = max(float((got.float() - ref.float()).abs().max()),
              float((got1.float() - ref1.float()).abs().max()))
    log(f"eval: int8 kernel at the eval frame: conv mode (8,160,256,64) -> 64, values "
        f"differing from the plain version {bad[0]} of {got.numel()}; GEMM mode "
        f"M={a.shape[0]} K=64 N=256 +bias, {bad[1]} of {got1.numel()}")
    if any(bad):
        raise AssertionError("the int8 kernel disagrees with its plain version at the eval frame")
    return err


BATTERY_IL_FLAGS = ["--distill", "true", "--classifier_loss", "true", "--sample_num", "2",
                    "--sample_method", "random", "--mas", "true", "--agem", "true",
                    "--bic", "true", "--persuado_label", "true"]
BATTERY_FLAGS = ["--scenario", "15", "3", "2", "--start_state", "1", "--end_state", "2",
                 "--start_epoch", "1", "--end_epoch", "1", "--new_state_epoch", "1",
                 "--every_iter", "2", "--save_every", "1", "--record", "false",
                 "--init_method", "mean"] + BATTERY_IL_FLAGS


def il_battery_path(tmp: str, state1_step_ms: float) -> dict:
    """Phase 12: MAS, A-GEM and BiC with distillation, random replay and
    pseudo-labels through ``cli.train.main`` from phase 10's state-0
    checkpoint into states 1 and 2, ``cli.validate --bic``, and the
    battery's passes on the card against the CPU (module docstring)."""
    import os

    import numpy as np
    import torch

    from cl_object_detection_tpu_torch import config as config_mod
    from cl_object_detection_tpu_torch.cli import validate
    from cl_object_detection_tpu_torch.cli.train import main as train_main
    from cl_object_detection_tpu_torch.il import agem as agem_mod
    from cl_object_detection_tpu_torch.il import bic as bic_mod
    from cl_object_detection_tpu_torch.ops.stem_fused import stem_fused
    from cl_object_detection_tpu_torch.train import step as step_mod
    from cl_object_detection_tpu_torch.train import trainer as trainer_mod

    t_phase = time.perf_counter()
    data = os.path.join(tmp, "data")
    src = os.path.join(tmp, "run_il", "checkpoint", "15_5", "state0")
    root = os.path.join(tmp, "run_battery")
    flags = ["--root_dir", root, "--train_json", os.path.join(data, "train.json"),
             "--image_dir", os.path.join(data, "images")] + IL_MODEL_FLAGS[3:] + BATTERY_FLAGS
    ILTrainer = trainer_mod.ILTrainer
    names = ("compute_similarity", "compute_importance", "generate_pseudo_labels")
    real = dict(run_batch=ILTrainer.run_batch, refresh=agem_mod.AGem.compute_replay_grad,
                bic_epoch=bic_mod.BicTrainer.train_epoch, project=step_mod._agem_project,
                predict_cfg=config_mod.PredictConfig,
                **{n: getattr(trainer_mod, n) for n in names})
    steps, passes, dots = [], [], []

    def run_batch(self, batch, is_replay=False, sync_metrics=True, correction=False):
        before = stem_fused.launches
        m = real["run_batch"](self, batch, is_replay=is_replay, sync_metrics=sync_metrics,
                              correction=correction)
        steps.append(dict(state=self.cur_state, replay=is_replay, correction=correction,
                          launches=stem_fused.launches - before, metrics=m))
        return m

    def timed(name, fn, loader_of):
        def wrapper(*args, **kw):
            loader = loader_of(*args)
            torch.cuda.synchronize()
            before, t0 = stem_fused.launches, time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            passes.append(dict(name=name, s=time.perf_counter() - t0, batches=len(loader),
                               images=len(loader.dataset),
                               launches=stem_fused.launches - before))
            return out
        return wrapper

    def project(grads, replay_grad):
        dots.append(float(sum(torch.sum(g * replay_grad[k]) for k, g in grads.items())))
        return real["project"](grads, replay_grad)

    def unaugmented(dataset, cfg):
        from cl_object_detection_tpu_torch.data.loader import BatchLoader

        return BatchLoader(dataset, cfg, shuffle=False, augment=False)

    shutil.copytree(os.path.join(src, "epoch1"),
                    os.path.join(root, "checkpoint", "15_3_2", "state0", "epoch1"))
    det, bench = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    ILTrainer.run_batch = run_batch
    agem_mod.AGem.compute_replay_grad = timed("agem_refresh", real["refresh"],
                                              lambda self, *a: self.replay_loader)
    bic_mod.BicTrainer.train_epoch = timed("bic_epoch", real["bic_epoch"],
                                           lambda self, *a: self.bic_loader)
    step_mod._agem_project = project
    trainer_mod.compute_similarity = timed("similarity", real[names[0]],
                                           lambda m, anchors, loader, *a: loader)
    trainer_mod.compute_importance = timed("mas", real[names[1]],
                                           lambda m, anchors, loader, *a: loader)
    trainer_mod.generate_pseudo_labels = timed(
        "pseudo_labels", real[names[2]], lambda m, ds, cfg, *a: unaugmented(ds, cfg))
    try:
        # ---- this path: counters at 0 -> states 1 and 2 with the battery ----
        zero_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        tr = train_main(flags)
        run_s = time.perf_counter() - t0
        counts = launch_counts()
        peak = torch.cuda.max_memory_allocated()
        record = check_battery_run(tr, steps, passes, dots, counts, run_s)
        step_ms = battery_step_ms(tr)

        # ---- cli.validate --state 2 --bic true through the NMS kernel ----
        config_mod.PredictConfig = functools.partial(real["predict_cfg"], nms_impl="pallas_fp")
        vflags = ["--root_dir", root, "--test_json", os.path.join(data, "test.json"),
                  "--image_dir", os.path.join(data, "images"), "--state", "2", "--epoch", "1",
                  "--threshold", "0.001"] + IL_MODEL_FLAGS[3:] + ["--scenario", "15", "3", "2"]
        zero_counts()
        t0 = time.perf_counter()
        res_bic = validate.main(vflags + ["--bic", "true"])
        val_s = time.perf_counter() - t0
        vcounts = launch_counts()
        res_plain = validate.main(vflags)
        record["validate"] = check_battery_validate(tr, root, res_bic, res_plain, vcounts,
                                                    val_s)
    finally:
        ILTrainer.run_batch = real["run_batch"]
        agem_mod.AGem.compute_replay_grad = real["refresh"]
        bic_mod.BicTrainer.train_epoch = real["bic_epoch"]
        step_mod._agem_project = real["project"]
        config_mod.PredictConfig = real["predict_cfg"]
        for n in names:
            setattr(trainer_mod, n, real[n])
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = det, bench

    # ---- the battery's passes on the card against the CPU, float32 ----
    record["card_vs_cpu"] = battery_card_vs_cpu(tr)
    phase_s = time.perf_counter() - t_phase
    rates = record["rates"]
    log(f"il battery (R50 bf16 640x1024 B=8, deterministic cuDNN): MAS pass "
        f"{rates['mas_images_per_s']:.2f} images/s; A-GEM refresh "
        f"{rates['agem_ms_per_refresh']:.1f} ms per refresh, "
        f"{rates['agem_ms_per_replay_batch']:.1f} ms per replay batch of "
        f"{tr.replay_loader.batch_size}; BiC epoch {rates['bic_images_per_s']:.2f} images/s; "
        f"run_batch alone {step_ms:.1f} ms per state-2 micro-step (MAS penalty, projection, "
        f"distillation; phase 10's state 1: {state1_step_ms:.1f}); peak memory "
        f"{peak / 2**30:.2f} GiB; phase 12 took {phase_s:.1f} s")
    record.update(state2_step_ms=step_ms, state1_step_ms_phase10=state1_step_ms,
                  peak_gib=peak / 2**30, phase_s=phase_s)
    return record


def check_battery_run(tr, steps, passes, dots, counts, run_s) -> dict:
    """The checks of phase 12's training run (module docstring); returns
    its record."""
    import numpy as np
    import torch

    from cl_object_detection_tpu_torch.il import mas as mas_mod

    for s in steps:
        s["metrics"] = {k: float(v) for k, v in s["metrics"].items()}
    losses = np.asarray([s["metrics"]["total_loss"] for s in steps], np.float64)
    by_state = {k: [s for s in steps if s["state"] == k] for k in (1, 2)}
    by_pass = {}
    for p in passes:
        by_pass.setdefault(p["name"], []).append(p)
    want_stem = sum(p["batches"] for p in passes) + 2 * len(steps)
    projected = sum(d < 0 for d in dots)
    log(f"il battery run: cli.train.main states 1 and 2 (scenario 15+3+2, "
        f"{' '.join(BATTERY_IL_FLAGS)}): {run_s:.2f} s; micro-steps {len(by_state[1])} + {len(by_state[2])}, stem launches "
        f"per micro-step {sorted({s['launches'] for s in steps})}; passes "
        + ", ".join(f"{k} {len(v)} x ({sum(p['batches'] for p in v)} batches, "
                    f"{sum(p['launches'] for p in v)} launches, "
                    f"{sum(p['s'] for p in v):.2f} s)" for k, v in by_pass.items())
        + f"; launches {counts} (want stem {want_stem}); A-GEM <g, g_r> at the "
        f"{len(dots)} applies {[f'{d:.3g}' for d in dots]}: projected {projected}")
    if not (len(losses) and np.isfinite(losses).all() and by_state[1] and by_state[2]):
        raise AssertionError(f"losses {losses} over states {[s['state'] for s in steps]}")
    if any(s["replay"] or s["correction"] for s in steps):
        raise AssertionError("a replay or correction micro-step ran with A-GEM on")
    if not all(np.isfinite(s["metrics"].get("mas_loss", np.nan)) for s in steps):
        raise AssertionError("a micro-step of state 1 or 2 without a finite mas_loss")
    if {s["launches"] for s in steps} != {2} or any(
            p["launches"] != p["batches"] or not p["batches"] for p in passes):
        raise AssertionError("want 2 stem launches per new-image micro-step and 1 per batch "
                             "of each pass")
    if counts["stem_fused"] != want_stem or any(
            counts[k] for k in ("stem_fused_f32", "nms_fp", "int8_matmul", "int8_conv_nhwc")):
        raise AssertionError(f"launches {counts}, want stem {want_stem}")
    want_passes = {"similarity": 2, "mas": 2, "pseudo_labels": 2, "bic_epoch": 2}
    if any(len(by_pass.get(k, [])) != n for k, n in want_passes.items()) or len(
            by_pass.get("agem_refresh", [])) != len(steps):
        raise AssertionError(f"passes {[(k, len(v)) for k, v in by_pass.items()]}, want "
                             f"{want_passes} and one A-GEM refresh per micro-step")
    if not dots:
        raise AssertionError("no A-GEM projection was taken")
    if not projected:
        log("il battery run: <g, g_r> >= 0 at every apply: the projection left every "
            "update unchanged")
    imp = tr.mas_importance
    bad = [k for k, v in imp.items() if not bool(torch.isfinite(v).all())
           or (mas_mod._excluded(k) and bool(v.any()))]
    kept = sum(1 for k, v in imp.items() if not mas_mod._excluded(k) and bool(v.any()))
    for state in (0, 1):
        side = tr.ckpt.load_array_sidecar(state, "mas_importance")
        bad += [f"state{state}:{k}" for k, v in side.items()
                if not np.isfinite(v).all() or (mas_mod._excluded(k) and v.any())]
    log(f"il battery run: MAS importance of state 1 finite, {kept} of {len(imp)} leaves "
        f"nonzero, the {sum(map(mas_mod._excluded, imp))} excluded ones zero: {not bad}")
    if bad or not kept:
        raise AssertionError(f"MAS importance not finite or nonzero on excluded leaves: {bad}")
    meta1 = tr.ckpt.restore(1, 1)[1]["bic"]
    meta2 = tr.ckpt.restore(2, 1)[1]["bic"]
    live = {"alphas": tr.bic.params.alphas.tolist(), "betas": tr.bic.params.betas.tolist()}
    log(f"il battery run: BiC after state 1 {meta1}, after state 2 {meta2}, live {live}")
    if meta2 != live or tr.bic.cur_state != 2:
        raise AssertionError("the state-2 checkpoint's BiC scalars differ from the trainer's")
    if (meta1["alphas"][0], meta1["betas"][0]) == (1.0, 0.0) \
            or (live["alphas"][1], live["betas"][1]) == (1.0, 0.0):
        raise AssertionError("a BiC slot did not move off (1, 0) in its state")
    if (live["alphas"][0], live["betas"][0]) != (meta1["alphas"][0], meta1["betas"][0]):
        raise AssertionError("the state-1 BiC slot changed in state 2")
    if tr.agem.replay_grad["classification_head.output.weight"].shape[0] != 9 * 20:
        raise AssertionError("the replay gradient is not the expanded model's")
    mas_p, refresh, bic_p = by_pass["mas"], by_pass["agem_refresh"], by_pass["bic_epoch"]
    rates = dict(
        mas_images_per_s=sum(p["images"] for p in mas_p) / sum(p["s"] for p in mas_p),
        agem_ms_per_refresh=sum(p["s"] for p in refresh) / len(refresh) * 1e3,
        agem_ms_per_replay_batch=sum(p["s"] for p in refresh)
        / sum(p["batches"] for p in refresh) * 1e3,
        bic_images_per_s=sum(p["images"] for p in bic_p) / sum(p["s"] for p in bic_p),
        similarity_images_per_s=sum(p["images"] for p in by_pass["similarity"])
        / sum(p["s"] for p in by_pass["similarity"]),
        pseudo_images_per_s=sum(p["images"] for p in by_pass["pseudo_labels"])
        / sum(p["s"] for p in by_pass["pseudo_labels"]))
    return dict(seconds=run_s, micro_steps=[len(by_state[1]), len(by_state[2])],
                launches=counts, projected=projected, applies=len(dots), bic=live,
                passes={k: [{f: p[f] for f in ("batches", "images", "launches", "s")}
                            for p in v] for k, v in by_pass.items()},
                rates=rates)


def battery_step_ms(tr) -> float:
    """``run_batch`` alone per state-2 micro-step (the MAS penalty, the
    A-GEM projection against the last replay gradient, distillation) on
    one epoch of batches assembled beforehand."""
    import torch

    tr.train_loader.set_epoch(2)
    batches = list(tr.train_loader)
    tr.run_batch(batches[0], sync_metrics=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in batches:
        m = tr.run_batch(b, sync_metrics=False)
    if "mas_loss" not in m:
        raise AssertionError("the timed state-2 micro-steps ran without the MAS penalty")
    float(m["total_loss"])
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / len(batches) * 1e3


def check_battery_validate(tr, root, res_bic, res_plain, vcounts, val_s) -> dict:
    """``cli.validate --state 2 --bic true`` (the NMS kernel once per
    batch): the ``_bic`` outputs exist, the rows are finite, and the rows
    of the state-1 and state-2 classes (whose slots are off (1, 0))
    differ from the uncorrected run's."""
    import os

    import numpy as np

    out = os.path.join(root, "val_result", "15_3_2", "state2")
    with open(os.path.join(out, "voc2007_results_epoch1_bic.json")) as f:
        rows_bic = json.load(f)
    with open(os.path.join(out, "voc2007_results_epoch1.json")) as f:
        rows_plain = json.load(f)
    new_cats = set(tr.states[2].knowing_ids[tr.states[1].num_past_class:])

    def new_rows(rows):
        return sorted((r["image_id"], r["category_id"], round(r["score"], 7))
                      for r in rows if r["category_id"] in new_cats)

    flat = np.asarray([r["bbox"] + [r["score"]] for r in rows_bic], np.float64)
    csv_ok = os.path.exists(os.path.join(out, "val_result_1_bic.csv"))
    differ = new_rows(rows_bic) != new_rows(rows_plain)
    log(f"il battery: cli.validate --state 2 --epoch 1 --bic true (Evaluator, pallas_fp): "
        f"{val_s:.2f} s, {len(rows_bic)} rows, mAP50 {res_bic[1].mean_ap50:.4f} (uncorrected "
        f"{res_plain[1].mean_ap50:.4f}); launches {vcounts}; _bic JSON and CSV written: "
        f"{csv_ok}; rows of the state-1 and state-2 classes differ from the uncorrected "
        f"run's: {differ} ({len(new_rows(rows_bic))} against {len(new_rows(rows_plain))})")
    if not (rows_bic and csv_ok and np.isfinite(flat).all() and differ):
        raise AssertionError("cli.validate --bic: missing outputs, rows not finite, or the "
                             "correction left the new classes' rows unchanged")
    if not vcounts["nms_fp"] or vcounts["nms_fp"] != vcounts["stem_fused"] or any(
            vcounts[k] for k in ("stem_fused_f32", "int8_matmul", "int8_conv_nhwc")):
        raise AssertionError(f"validate launches {vcounts}, want one stem and one NMS launch "
                             "per batch")
    return dict(seconds=val_s, rows=len(rows_bic), map50_bic=res_bic[1].mean_ap50,
                map50_plain=res_plain[1].mean_ap50, launches=vcounts)


def _grads_rel(got: dict, want: dict) -> tuple:
    """(largest |d| / (1e-3 |g_cpu| + 1e-4 max|g_cpu|) over every leaf,
    largest |d| / max|g_cpu|, the three leaves furthest beyond the bar):
    the first <= 1 is the train step's gradient bar."""
    per_leaf = {}
    rel = 0.0
    for k, w in want.items():
        g, w = got[k].double().cpu(), w.double()
        d = (g - w).abs()
        m = float(w.abs().max())
        if m == 0:
            per_leaf[k] = float("inf") if float(d.max()) > 0 else 0.0
            continue
        per_leaf[k] = float((d / (1e-3 * w.abs() + 1e-4 * m)).max())
        rel = max(rel, float(d.max()) / m)
    worst = sorted(per_leaf.items(), key=lambda kv: -kv[1])[:3]
    return worst[0][1], rel, [(k, float(f"{v:.3g}")) for k, v in worst]


# (tag, device, cuDNN deterministic, seed of the one-ulp move or None):
# the card under deterministic cuDNN (no autotuning), as the other
# card-vs-CPU checks run, and beside it the card autotuned (the main
# path's cudnn.benchmark); the card at the checkpoint's weights each moved
# by -1, 0 or +1 float32 ulp (four seeds), which measures how far rounding
# alone moves the card's own gradients; the CPU at the checkpoint's weights
BATTERY_ULP_SEEDS = (1, 2, 3, 4)
BATTERY_CHECK_RUNS = ((("card", "cuda", True, None), ("card_autotuned", "cuda", False, None))
                      + tuple((f"card_ulp{i}", "cuda", True, i) for i in BATTERY_ULP_SEEDS)
                      + (("cpu", "cpu", True, None),))


def _ulp_moved(state: dict, seed: int) -> dict:
    """``state`` with every float parameter (not the frozen-BN statistics)
    multiplied by 1 + s 2^-23, s in {-1, 0, 1} drawn per element."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    out = {}
    for k, v in state.items():
        if v.dtype == torch.float32 and "running" not in k:
            sign = torch.randint(-1, 2, v.shape, generator=gen).float()
            v = v * (1 + sign * 2.0 ** -23)
        out[k] = v
    return out


def _leaf_worst(got: dict, want: dict) -> dict:
    """Per leaf, the worst |d| / (1e-3 |g_want| + 1e-4 max|g_want|)."""
    return {leaf: _grads_rel({leaf: got[leaf]}, {leaf: w})[0] for leaf, w in want.items()}


def battery_card_vs_cpu(tr, runs=BATTERY_CHECK_RUNS) -> dict:
    """Phase 12's float32 checks (TF32 off) on one unaugmented batch of 2
    state-2 images and the state-2 checkpoint, the card against the CPU:
    one MAS importance batch, one A-GEM replay gradient, and one BiC step
    (its gradient, and the change of the alphas and betas). The train
    step's gradient bar is |d| <= 1e-3 |g_cpu| + 1e-4 max|g_cpu| per
    leaf. A ReLU pre-activation or a max-pool pair within rounding of a
    tie decides where the gradient flows, so at this size rounding alone
    moves a leaf's gradient past that bar: for the importance and the
    replay gradient, the card's own gradients at weights moved by one
    float32 ulp (four seeds) measure how far, and the card's worst leaf
    against the CPU must stay within the larger of the bar and twice the
    largest of those moves. The BiC gradient and step hold the bar."""
    import copy
    import dataclasses

    import torch

    from cl_object_detection_tpu_torch.data.loader import BatchLoader
    from cl_object_detection_tpu_torch.il import agem, bic, mas
    from cl_object_detection_tpu_torch.il.losses import LossStatics, compute_losses
    from cl_object_detection_tpu_torch.models.retinanet import create_retinanet

    s2 = tr.ckpt.restore(2, 1)[0]["model"]
    ds = copy.copy(tr.dataset_train)
    ds.image_ids = list(ds.image_ids[:2])
    ds.pseudo_labels = {}
    batch = next(iter(BatchLoader(ds, dataclasses.replace(tr.cfg.data, batch_size=2),
                                  shuffle=False, augment=False)))
    anchors = tr.anchors_for(batch.images)
    cfg32 = dataclasses.replace(tr.cfg.model, compute_dtype="float32")
    st = tr.states[2]
    counts = [s.num_new_class for s in tr.states.states]
    agem_statics = LossStatics(num_classes=20, num_past_class=st.num_past_class,
                               incremental=False, is_replay=True)
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    got = {}
    try:
        for tag, dev, deterministic, seed in runs:
            torch.backends.cudnn.deterministic = deterministic
            torch.backends.cudnn.benchmark = not deterministic
            model = create_retinanet(cfg32, 20, device=dev)
            model.load_state_dict(s2 if seed is None else _ulp_moved(s2, seed))
            args = [torch.tensor(a, device=dev)
                    for a in (anchors, batch.images, batch.boxes, batch.labels)]
            imp = mas.make_importance_step(model)(*args)
            rep = agem.AGem(model, anchors, tr.cfg.il, tr.cfg.focal, agem_statics,
                            [batch]).compute_replay_grad()
            got[tag] = dict(imp={k: v.cpu() for k, v in imp.items()},
                            rep={k: v.cpu() for k, v in rep.items()})
            del imp, rep
            if seed is not None:
                del model, args
                continue
            bt = bic.BicTrainer(model, anchors, tr.cfg.il, tr.cfg.focal, tr.cfg.il.bic, counts,
                                2, st.num_past_class, [batch])
            bt.params.load({"alphas": tr.bic.params.alphas.numpy(),
                            "betas": tr.bic.params.betas.numpy()})
            a, b = (torch.nn.Parameter(t.clone().to(dev)) for t in (bt.params.alphas,
                                                                     bt.params.betas))
            total, _ = compute_losses(bic._Frozen(model), *args[1:], args[0], tr.cfg.il,
                                      tr.cfg.focal, bt.statics,
                                      bic_correct=lambda x: bt.correct(x, a, b))
            ga, gb = torch.autograd.grad(total, [a, b])
            before = bt.params.alphas.clone(), bt.params.betas.clone()
            bt.train_epoch()
            got[tag].update(
                bic_grad={"alphas": ga.cpu(), "betas": gb.cpu()},
                bic_step={"alphas": bt.params.alphas - before[0],
                          "betas": bt.params.betas - before[1]},
                bic={"alphas": bt.params.alphas.tolist(), "betas": bt.params.betas.tolist()})
            del model, args, bt
    finally:
        (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark) = saved
    moved = [r[0] for r in runs if r[3] is not None]
    moves = {k: [_grads_rel(got[m][k], got["card"][k])[0] for m in moved]
             for k in ("imp", "rep")}
    out, bad = {}, []
    for tag in ("card", "card_autotuned"):
        res = {}
        for k in ("imp", "rep", "bic_grad", "bic_step"):
            worst, rel, leaves = _grads_rel(got[tag][k], got["cpu"][k])
            res[k] = dict(worst_of_bar=worst, max_rel=rel, leaves=leaves)
            limit = 1.0
            if k in moves:
                limit = max(1.0, 2 * max(moves[k]))
                res[k].update(past_the_bar=sum(v > 1 for v in _leaf_worst(
                    got[tag][k], got["cpu"][k]).values()), ulp_moves=moves[k], limit=limit)
            if tag == "card" and worst > limit:
                bad.append(f"{k}: {worst:.3g} > {limit:.3g}")
        out[tag] = res
        log(f"il battery: {tag} against the CPU, state-2 R50 float32, TF32 off, 2 state-2 "
            f"images (worst |d| / (1e-3 |g_cpu| + 1e-4 max|g_cpu|) over the leaves, "
            f"max |d| / max |g_cpu|, the leaves furthest out; for the importance and the "
            f"replay gradient also the leaves past the bar, the card's own worst moves at "
            f"weights moved by one ulp, and the limit max(1, twice the largest move)): "
            + "; ".join(f"{k} {r['worst_of_bar']:.3g} ({r['max_rel']:.3g}) {r['leaves']}"
                        + (f", {r['past_the_bar']} of {len(got['cpu'][k])} leaves past the "
                           f"bar, one-ulp moves {[float(f'{m:.3g}') for m in r['ulp_moves']]}, "
                           f"limit {r['limit']:.3g}" if k in moves else "")
                        for k, r in res.items())
            + f"; BiC after one step {got[tag]['bic']}, CPU {got['cpu']['bic']}")
    if bad:
        raise AssertionError(f"the card's battery passes differ from the CPU's beyond the bar "
                             f"and beyond twice the card's own one-ulp moves: {bad}")
    return out


# the artifacts of phase 13: (tag, run directory under tmp, scenario, state, epoch, score
# threshold, extra flags). Phase 12's BiC scalars stay within 0.3% of (1, 0) and its
# state-1 and state-2 classes score below the default 0.05, so (c) takes the threshold
# of phase 12's cli.validate, where the correction reaches the detections.
EXPORT_RUNS = (
    ("a", "run", ["20"], 0, 2, 0.05, []),
    ("b", "run", ["20"], 0, 2, 0.05, ["--quantize"]),
    ("c", "run_battery", ["15", "3", "2"], 2, 1, 0.001, ["--bic"]),
    ("c_nobic", "run_battery", ["15", "3", "2"], 2, 1, 0.001, []),
)
EXPORT_BATCH = 8
EXPORT_TIMED = 10                # timed predicts of each artifact, and of each live path

# Loads every artifact of phase 13 in one fresh process that imports
# eval.deploy alone: per artifact the load seconds, the launches of one
# predict, ms per predict (numpy frames in, numpy detections out) and the
# detections (an npz beside the artifact); then which modules of JAX, the
# JAX package and the port's models/ the process holds.
EXPORT_CHILD = r"""
import json, sys, time
import numpy as np
import torch

torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
from cl_object_detection_tpu_torch.eval.deploy import load_artifact

frames = np.load(sys.argv[1])
iters = int(sys.argv[2])
out = {}
for art in sys.argv[3:]:
    t0 = time.perf_counter()
    fn, meta = load_artifact(art)
    load_s = time.perf_counter() - t0
    fn(frames)                                  # warm-up (cuDNN plans, the kernels' libraries)
    from cl_object_detection_tpu_torch.ops import int8_matmul as im, nms_fp as nf
    from cl_object_detection_tpu_torch.ops import stem_fused as sf
    counters = {"stem_fused": sf.stem_fused, "stem_fused_f32": sf.stem_fused_f32,
                "nms_fp": nf.nms_fp, "int8_matmul": im.int8_matmul,
                "int8_conv_nhwc": im.int8_conv_nhwc}
    for c in counters.values():
        c.launches = 0
    det = fn(frames)
    counts = {k: c.launches for k, c in counters.items()}
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(frames)
    ms = (time.perf_counter() - t0) / iters * 1e3
    np.savez(art + ".out.npz", **det)
    out[art] = {"load_s": load_s, "launches": counts, "ms": ms}
mods = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax",
              "cl_object_detection_tpu") or m.startswith("cl_object_detection_tpu_torch.models"))
print(json.dumps({"artifacts": out, "modules": mods}))
"""


def export_frames(tmp: str):
    """The first landscape batch of 8 of phase 9's test split (640x1024
    fused uint8 frames), through the ``Evaluator``'s loader."""
    import os

    from cl_object_detection_tpu_torch.cli import validate
    from cl_object_detection_tpu_torch.cli.common import args_to_config
    from cl_object_detection_tpu_torch.config import PredictConfig
    from cl_object_detection_tpu_torch.data.coco import CocoJson
    from cl_object_detection_tpu_torch.eval.evaluator import Evaluator
    from cl_object_detection_tpu_torch.states import ILStates

    data = os.path.join(tmp, "data")
    flags = ["--root_dir", os.path.join(tmp, "run"), "--test_json",
             os.path.join(data, "test.json"), "--image_dir", os.path.join(data, "images"),
             "--depth", "50", "--scenario", "20", "--batch_size", str(EXPORT_BATCH),
             "--fused_stem", "true", "--transfer_dtype", "uint8"]
    cfg = args_to_config(validate.get_parser().parse_args(flags))
    coco = CocoJson(os.path.join(data, "test.json"))
    states = ILStates(list(coco.classes.values()), coco.classes_inverse, ["20"])
    ev = Evaluator(coco, states, os.path.join(data, "images"), cfg.data, PredictConfig())
    for batch in ev.loader:
        if batch.images.shape[1] < batch.images.shape[2] and len(batch.images) == EXPORT_BATCH:
            return batch.images, [coco.imgs[int(i)]["file_name"] for i in batch.image_ids]
    raise AssertionError("no landscape batch of 8 in phase 9's test split")


def export_path(tmp: str) -> dict:
    """Phase 13: ``cli.export`` of phase 8's and phase 12's checkpoints,
    the artifacts loaded in a fresh process without the model code,
    against the live ``make_predict_fn``, and ``cli.serve --from_export``
    over HTTP (module docstring)."""
    import os

    import numpy as np
    import torch

    from cl_object_detection_tpu_torch.cli.export import main as export_main
    from cl_object_detection_tpu_torch.cli.serve import make_run_predict
    from cl_object_detection_tpu_torch.config import PredictConfig
    from cl_object_detection_tpu_torch.eval.deploy import artifact_blob, load_serving_bundle
    from cl_object_detection_tpu_torch.eval.predictor import make_predict_fn
    from cl_object_detection_tpu_torch.il.bic import bic_correct_from_meta

    t_phase = time.perf_counter()
    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", ""))
    serve_out = os.path.join(tmp, "serve_from_export.txt")
    server = None
    det, bench = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        frames, names = export_frames(tmp)
        record: dict = {"artifacts": {}}
        arts = {}
        for tag, run, scenario, state, epoch, thresh, extra in EXPORT_RUNS:
            arts[tag] = os.path.join(tmp, f"artifact_{tag}")
            t0 = time.perf_counter()
            meta = export_main(["--root_dir", os.path.join(tmp, run), "--scenario", *scenario,
                                "--state", str(state), "--epoch", str(epoch), "--batch",
                                str(EXPORT_BATCH), "--score_thresh", str(thresh), "--out",
                                arts[tag], *extra])
            export_s = time.perf_counter() - t0
            mb = os.path.getsize(os.path.join(arts[tag], artifact_blob("cuda"))) / 1e6
            record["artifacts"][tag] = dict(export_s=export_s, mb=mb, quantize=meta["quantize"],
                                            bic=meta["bic"], num_classes=meta["num_classes"])
            if meta["platforms"] != ["cuda"] or meta["frame_shape"] != list(frames.shape[1:]):
                raise AssertionError(f"artifact {tag}: meta {meta}")
            if server is None:
                # the server of (a) starts now and loads while the others export
                server = start_server(arts[tag], env, repo, serve_out)
        torch.cuda.empty_cache()

        # ---- a fresh process: eval.deploy alone loads and runs each artifact ----
        # the server's start-up (its warm-up predict) stays out of the timings below
        ready_s = wait_healthy(*server, serve_out)
        np.save(os.path.join(tmp, "export_frames.npy"), frames)
        t0 = time.perf_counter()
        child = subprocess.run(
            [sys.executable, "-c", EXPORT_CHILD, os.path.join(tmp, "export_frames.npy"),
             str(EXPORT_TIMED)] + [arts[t] for t, *_ in EXPORT_RUNS],
            cwd=repo, env=env, capture_output=True, text=True, timeout=600)
        child_s = time.perf_counter() - t0
        if child.returncode != 0:
            raise AssertionError(f"the artifact process failed: {child.stderr[-3000:]}")
        got = json.loads(child.stdout.strip().splitlines()[-1])
        if got["modules"]:
            raise AssertionError(f"the artifact process imported {got['modules']}")
        want_launches = {"a": (1, 0, 0), "b": (1, R50_INT8_GEMMS, R50_INT8_CONVS),
                         "c": (1, 0, 0), "c_nobic": (1, 0, 0)}
        for tag, art in arts.items():
            r = got["artifacts"][art]
            n = r["launches"]
            seen = (n["stem_fused"], n["int8_matmul"], n["int8_conv_nhwc"])
            if seen != want_launches[tag] or n["nms_fp"] or n["stem_fused_f32"]:
                raise AssertionError(f"artifact {tag}: launches per predict {n}, want stem, "
                                     f"int8, conv mode {want_launches[tag]} and no other")
            record["artifacts"][tag].update(load_s=r["load_s"], launches=n, ms_b8=r["ms"])

        # ---- the live make_predict_fn on the same checkpoints and frames ----
        outs = {}
        for tag, run, scenario, state, epoch, thresh, extra in EXPORT_RUNS:
            bundle = load_serving_bundle(os.path.join(tmp, run), scenario, state, epoch)
            correct = None
            if "--bic" in extra:
                correct = bic_correct_from_meta(bundle.il_meta, [int(s) for s in scenario],
                                                bundle.num_classes)
            predict = make_predict_fn(bundle.model, PredictConfig(
                score_thresh=thresh, quantize="--quantize" in extra), bic_correct=correct)
            run_predict = make_run_predict(predict, torch.device("cuda"))
            live = run_predict(frames)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(EXPORT_TIMED):
                run_predict(frames)
            live_ms = (time.perf_counter() - t0) / EXPORT_TIMED * 1e3
            with np.load(arts[tag] + ".out.npz") as z:
                outs[tag] = {k: z[k] for k in z.files}
            same = {k: bool(np.array_equal(outs[tag][k], live[k])) for k in live}
            record["artifacts"][tag].update(live_ms_b8=live_ms, bit_identical=same,
                                            valid=int(live["valid"].sum()))
            if not all(same.values()):
                raise AssertionError(f"artifact {tag} against the live predict: {same}")
            del bundle, predict, run_predict
            torch.cuda.empty_cache()
        bic_moved = int((outs["c"]["scores"] != outs["c_nobic"]["scores"]).sum())
        if not bic_moved:
            raise AssertionError("the --bic artifact's rows equal the uncorrected artifact's")

        # ---- cli.serve --from_export answers 8 HTTP requests from (a) ----
        record["serve"] = serve_requests(*server[:2], [os.path.join(tmp, "data", "images", n)
                                                       for n in names])
        record["serve"]["ready_s"] = ready_s
    finally:
        if server is not None and server[0].poll() is None:
            server[0].kill()
            server[0].wait(timeout=60)
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = det, bench
    phase_s = time.perf_counter() - t_phase
    for tag, r in record["artifacts"].items():
        log(f"export ({tag}): cli.export {r['export_s']:.2f} s, {r['mb']:.2f} MB; load in the "
            f"fresh process {r['load_s']:.2f} s; launches per predict {r['launches']}; artifact "
            f"{r['ms_b8']:.3f} ms per B=8 predict, live {r['live_ms_b8']:.3f} (numpy frames in, "
            f"numpy detections out, host clock); {r['valid']} valid detections, bit-identical "
            f"to live: {all(r['bit_identical'].values())}")
    log(f"export: the fresh process took {child_s:.2f} s (imports and the kernels' libraries "
        f"included) and held none of JAX, the JAX package or models/; the BiC artifact moved "
        f"{bic_moved} of {outs['c']['scores'].size} scores; cli.serve --from_export answered "
        f"{record['serve']['answered']} of 8 requests ({record['serve']['detections']} "
        f"detections above 0.3), /healthz {record['serve']['ready_s']:.2f} s after its start "
        f"(it loads while (b), (c) and (c') export); phase 13 "
        f"took {phase_s:.1f} s")
    record.update(child_s=child_s, bic_scores_moved=bic_moved, phase_s=phase_s)
    return record


def start_server(artifact: str, env: dict, repo: str, out_path: str):
    """Start ``cli.serve --from_export`` in a subprocess (its output into
    ``out_path``); returns (process, port, start time)."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    with open(out_path, "w") as out:
        proc = subprocess.Popen(
            [sys.executable, "-m", "cl_object_detection_tpu_torch.cli.serve", "--from_export",
             artifact, "--port", str(port)], cwd=repo, env=env, stdout=out,
            stderr=subprocess.STDOUT)
    return proc, port, time.perf_counter()


def wait_healthy(proc, port: int, t0: float, out_path: str) -> float:
    """Seconds from the server's start until ``/healthz`` answers."""
    import http.client

    while True:
        if proc.poll() is not None:
            with open(out_path) as f:
                raise AssertionError(f"cli.serve died: {f.read()[-3000:]}")
        try:
            c = http.client.HTTPConnection("127.0.0.1", port, timeout=2)
            c.request("GET", "/healthz")
            if c.getresponse().status == 200:
                return time.perf_counter() - t0
        except OSError:
            pass
        if time.perf_counter() - t0 > 300:
            raise AssertionError("cli.serve never became healthy")
        time.sleep(0.25)


def serve_requests(proc, port: int, images: list) -> dict:
    """POST the PNG files to the server from 4 threads, then stop it."""
    import http.client

    answers: list = [None] * len(images)

    def ask(i):
        with open(images[i], "rb") as f:
            body = f.read()
        c = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        c.request("POST", "/detect", body=body)
        r = c.getresponse()
        answers[i] = (r.status, json.loads(r.read()))

    try:
        threads = [threading.Thread(target=lambda c=c: [ask(i) for i in range(c, len(images), 4)])
                   for c in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        proc.kill()
        proc.wait(timeout=60)
    ok = [a for a in answers if a is not None and a[0] == 200 and "detections" in a[1]]
    if len(ok) != len(images):
        raise AssertionError(f"cli.serve --from_export answered {len(ok)} of {len(images)}: "
                             f"{[a for a in answers if a not in ok][:2]}")
    return dict(answered=len(ok), detections=sum(len(a[1]["detections"]) for a in ok))


# phase 14's training flags on the data axis, on phase 8's toy data; the root
# directory, the data paths, --mesh and the process flags are added per run
DATA_AXIS_RANKS = 2
DATA_AXIS_A = ["--start_state", "0", "--end_epoch", "1", "--every_iter", "2", "--save_every",
               "1", "--record", "false", "--print_il_info", "false"]
DATA_AXIS_B = (["--start_state", "1", "--start_epoch", "1", "--end_epoch", "1",
                "--new_state_epoch", "1", "--every_iter", "2", "--save_every", "1", "--record",
                "false", "--print_il_info", "false", "--init_method", "mean",
                "--sample_batch_size", "4"] + BATTERY_IL_FLAGS)
DATA_AXIS_ULP_SEEDS = (1, 2, 3, 4)
# |d AP50| of a class, (c) against one process in batches of 8: bf16 convs of 4
# images take other cuDNN algorithms than of 8, which move a score by up to two
# bf16 ulps of its logit (0.0017 measured), so rows near the 0.001 threshold and
# NMS ties come and go
DATA_AXIS_AP_TOL = 5e-3

# One rank of phase 14: (a) cli.train state 0, (b) cli.train state 1 with the
# battery, the gradient all-reduce timed, the sharded IL passes on the state-0
# model, (c) cli.validate --bic under pallas_fp, (d) (a) under --zero1 with
# param_all_gather timed, (e) (b) under --zero1, each through its entry point
# with the process flags, in one process group; records per micro-step stem
# launches, each IL pass, the writes into the run roots, the first apply's
# all-reduced gradient with its inputs, the moment bytes and the peaks.
DATA_AXIS_CHILD = r"""
import functools, json, os, sys, time
rank, world, address, spec_path = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
with open(spec_path) as f:
    spec = json.load(f)
import numpy as np
import torch

from cl_object_detection_tpu_torch import config as config_mod
from cl_object_detection_tpu_torch.cli import validate
from cl_object_detection_tpu_torch.cli.train import main as train_main
from cl_object_detection_tpu_torch.il import agem as agem_mod
from cl_object_detection_tpu_torch.il import bic as bic_mod
from cl_object_detection_tpu_torch.ops.nms_fp import nms_fp
from cl_object_detection_tpu_torch.ops.stem_fused import stem_fused
from cl_object_detection_tpu_torch.parallel import mesh as pm
from cl_object_detection_tpu_torch.train import step as step_mod
from cl_object_detection_tpu_torch.train import trainer as trainer_mod
from cl_object_detection_tpu_torch.utils.checkpoint import host_copy

sys.path.insert(0, spec["repo"])
from chip_smoke import run_passes

torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
proc = ["--coordinator_address", address, "--num_processes", str(world),
        "--process_id", str(rank)]
out = os.path.join(spec["out"], f"rank{rank}")
os.makedirs(out)
rec = {"rank": rank, "steps": [], "passes": [],
       "writes": {"checkpoints": 0, "arrays": 0}}
first = {"batches": 0}
run = {"tag": None}
real = dict(run_batch=trainer_mod.ILTrainer.run_batch, reduce=step_mod.all_reduce_grads,
            rename=os.rename, savez=np.savez, predict_cfg=config_mod.PredictConfig,
            refresh=agem_mod.AGem.compute_replay_grad, bic=bic_mod.BicTrainer.train_epoch,
            **{n: getattr(trainer_mod, n) for n in
               ("compute_similarity", "compute_importance", "generate_pseudo_labels")})

def run_batch(self, batch, is_replay=False, sync_metrics=True, correction=False):
    if self.cur_state == 0 and first["batches"] < 2:
        if not first["batches"]:
            torch.save(host_copy(self.model.state_dict()), os.path.join(out, "init.pt"))
        first["batches"] += 1
        real["savez"](os.path.join(out, f"batch{first['batches']}.npz"), images=batch.images,
                      boxes=batch.boxes, labels=batch.labels)
    before, t = stem_fused.launches, time.perf_counter()
    m = real["run_batch"](self, batch, is_replay=is_replay, sync_metrics=sync_metrics,
                          correction=correction)
    rec["steps"].append({"run": run["tag"], "state": self.cur_state, "replay": is_replay,
                         "launches": stem_fused.launches - before,
                         "s": time.perf_counter() - t})
    return m

def all_reduce_grads(mesh, grads):
    reduced = real["reduce"](mesh, grads)
    if "grad" not in first:
        first["grad"] = True
        if rank == 0:
            torch.save(host_copy(reduced), os.path.join(out, "grad.pt"))
    return reduced

def timed(name, fn, loader_of):
    def wrapper(*args, **kw):
        loader = loader_of(*args)
        torch.cuda.synchronize()
        before, t0 = stem_fused.launches, time.perf_counter()
        result = fn(*args, **kw)
        torch.cuda.synchronize()
        rec["passes"].append({"run": run["tag"], "name": name, "s": time.perf_counter() - t0,
                              "batches": len(loader),
                              "launches": stem_fused.launches - before})
        return result
    return wrapper

def counted(kind, fn):
    def wrapper(*args, **kw):
        if any(str(args[1] if kind == "checkpoints" else args[0]).startswith(r)
               for r in spec["roots"]):
            rec["writes"][kind] += 1
        return fn(*args, **kw)
    return wrapper

def unaugmented(ds, cfg):
    from cl_object_detection_tpu_torch.data.loader import BatchLoader
    return BatchLoader(ds, cfg, shuffle=False, augment=False)

trainer_mod.ILTrainer.run_batch = run_batch
step_mod.all_reduce_grads = all_reduce_grads
os.rename = counted("checkpoints", real["rename"])
np.savez = counted("arrays", real["savez"])
agem_mod.AGem.compute_replay_grad = timed("agem_refresh", real["refresh"],
                                          lambda self, *a: self.replay_loader)
bic_mod.BicTrainer.train_epoch = timed("bic_epoch", real["bic"], lambda self, *a: self.bic_loader)
trainer_mod.compute_similarity = timed("similarity", real["compute_similarity"],
                                       lambda m, anchors, loader, *a: loader)
trainer_mod.compute_importance = timed("mas", real["compute_importance"],
                                       lambda m, anchors, loader, *a: loader)
trainer_mod.generate_pseudo_labels = timed("pseudo_labels", real["generate_pseudo_labels"],
                                           lambda m, ds, cfg, *a: unaugmented(ds, cfg))

def train(tag):
    run["tag"] = tag
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start, t0 = len(rec["steps"]), time.perf_counter()
    tr = train_main(spec[tag] + proc)
    torch.cuda.synchronize()
    rec[tag] = {"s": time.perf_counter() - t0, "epoch_log": tr.epoch_log,
                "checksums": pm.check_replicas(tr.mesh, tr.model),
                "loss_hist": list(tr.loss_hist), "mesh": pm.describe(tr.mesh),
                "backend": tr.mesh.backend, "device": str(tr.device), "world": tr.mesh.world,
                "zero1": tr.mesh.zero1, "sharded": tr.optimizer.sharded,
                "moment_bytes": tr.optimizer.moment_bytes(),
                "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                "steps": [start, len(rec["steps"])]}
    if tr.cur_state >= 1:
        rec[tag].update(exemplars=list(tr.dataset_replay.image_ids),
                        bic=[tr.bic.params.alphas.tolist(), tr.bic.params.betas.tolist()])
    return tr

def timed_ms(fn):
    times = []
    for _ in range(5):
        pm.barrier(mesh)
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return times

tr = train("a")
mesh = tr.mesh
del tr
tr = train("b")

# the gradient all-reduce of the R50, timed on both ranks together
grads = {n: torch.full_like(p, float(rank + 1)) for n, p in tr.model.named_parameters()}
reduced = pm.all_reduce_grads(tr.mesh, grads)
assert all(bool((v == 1.5).all()) for v in reduced.values()), "the all-reduce is not the mean"
rec["allreduce"] = {"ms": timed_ms(lambda: pm.all_reduce_grads(tr.mesh, grads)),
                    "mb": sum(v.numel() for v in grads.values()) * 4 / 1e6}
del tr, grads, reduced
torch.cuda.empty_cache()

# the IL passes on the ranks, each on the state-0 model of (a)
run["tag"] = "passes"
results, rec["sharded_passes"] = run_passes(spec, mesh)
if rank == 0:
    torch.save(results, os.path.join(out, "passes.pt"))
del results
torch.cuda.empty_cache()

run["tag"] = "c"
config_mod.PredictConfig = functools.partial(real["predict_cfg"], nms_impl="pallas_fp")
nms0, stem0, t0 = nms_fp.launches, stem_fused.launches, time.perf_counter()
res = validate.main(spec["c"] + proc)
config_mod.PredictConfig = real["predict_cfg"]
rec["c"] = {"s": time.perf_counter() - t0, "nms": nms_fp.launches - nms0,
            "stem": stem_fused.launches - stem0, "map50": res[1].mean_ap50,
            "ap50": dict(res[1].ap50)}
torch.cuda.empty_cache()

# (d): (a) under ZeRO-1, then its all-gather of the R50's parameters timed
tr = train("d")
params = dict(tr.model.named_parameters())
plans = pm.shard_plans(tr.mesh, tr.model.named_parameters())
plan = plans[rank]
before = pm.module_checksums(tr.model)
rec["all_gather"] = {"ms": timed_ms(lambda: pm.param_all_gather(tr.mesh, params, plans)),
                     "mb": sum(p.numel() for n, p in params.items()
                               if plan[n] is not None) * 4 / 1e6,
                     "split": sum(s is not None for s in plan.values()), "leaves": len(plan)}
assert pm.module_checksums(tr.model) == before, "the all-gather changed a parameter"
del tr, params
torch.cuda.empty_cache()
tr = train("e")
del tr
torch.cuda.empty_cache()

with open(os.path.join(out, "record.json"), "w") as f:
    json.dump(rec, f)
pm.barrier(mesh)
torch.distributed.destroy_process_group()
print(f"rank {rank}: done", flush=True)
"""

# the IL passes that phase 14 runs on the ranks and in one process: (name, the
# image set it reads: the state-0 images "old" or the state-1 images "new")
DATA_AXIS_PASSES = (("similarity", "new"), ("prototypes", "old"), ("herding", "old"),
                    ("pseudo_labels", "new"), ("mas", "old"))
# on the classification bias of (a)'s model for those passes: from the prior's
# 0.01 to ~0.35 per class, past the similarity gate (old-class sum >= 0.5) and
# the pseudo-label threshold (PSEUDO_SCORE)
PASSES_BIAS_RAISE = 4.0


def run_passes(spec, mesh=None):
    """Each IL pass of ``DATA_AXIS_PASSES`` with ``mesh=`` (None: one
    process) on (a)'s state-0 checkpoint, its classification bias raised by
    ``PASSES_BIAS_RAISE`` (the similarity gate and the pseudo-label
    threshold then pass), over phase 8's toy images of scenario 15+5 in unshuffled,
    unaugmented batches of 8, under the ranks' cuDNN settings. Returns the
    results (numpy) and, per pass, its seconds (the card synchronised), its
    stem launches and its whole loader's batch count."""
    import os

    import torch

    from cl_object_detection_tpu_torch.cli.common import add_train_flags, args_to_config
    from cl_object_detection_tpu_torch.config import PseudoLabelConfig
    from cl_object_detection_tpu_torch.data.coco import CocoJson
    from cl_object_detection_tpu_torch.data.dataset import ILDataset
    from cl_object_detection_tpu_torch.data.loader import BatchLoader
    from cl_object_detection_tpu_torch.data.transforms import logical_image_hw
    from cl_object_detection_tpu_torch.il.herding import HerdSampler
    from cl_object_detection_tpu_torch.il.mas import compute_importance
    from cl_object_detection_tpu_torch.il.prototype import compute_prototype_features
    from cl_object_detection_tpu_torch.il.pseudo_label import generate_pseudo_labels
    from cl_object_detection_tpu_torch.il.weight_init import compute_similarity
    from cl_object_detection_tpu_torch.models.retinanet import create_retinanet
    from cl_object_detection_tpu_torch.ops.anchors import anchors_for_shape
    from cl_object_detection_tpu_torch.ops.stem_fused import stem_fused
    from cl_object_detection_tpu_torch.states import ILStates
    from cl_object_detection_tpu_torch.utils.checkpoint import CheckpointManager

    import argparse

    parser = argparse.ArgumentParser()
    add_train_flags(parser)
    a = parser.parse_args(spec["a"])
    cfg = args_to_config(a)
    device = torch.device("cuda", torch.cuda.current_device())
    coco = CocoJson(a.train_json)
    states = ILStates(list(coco.classes.values()), coco.classes_inverse, list(cfg.il.scenario))
    sets = {k: ILDataset(coco, states, a.image_dir, split="train", start_state=s)
            for k, s in (("old", 0), ("new", 1))}
    st = states[1]
    model = create_retinanet(cfg.model, st.num_past_class, device=device)
    tree, _ = CheckpointManager(os.path.join(a.root_dir, cfg.checkpoint_dir),
                                cfg.il.scenario).restore(0, -1)
    model.load_state_dict(tree["model"])
    with torch.no_grad():
        model.classification_head.output.bias += PASSES_BIAS_RAISE
    anchors = lambda images: anchors_for_shape(*logical_image_hw(images))  # noqa: E731
    loader = lambda ds: BatchLoader(ds, cfg.data, shuffle=False, augment=False)  # noqa: E731
    herd = HerdSampler(HERD_RATIO)
    run = {
        "similarity": lambda: compute_similarity(model, anchors, loader(sets["new"]),
                                                 st.num_new_class, st.num_past_class, mesh=mesh),
        "prototypes": lambda: compute_prototype_features(model, anchors, loader(sets["old"]),
                                                         st.num_past_class, mesh=mesh),
        "herding": lambda: (herd.sample(model, sets["old"], cfg.data, 2, mesh=mesh),
                            list(herd.examplar_list))[1],
        "pseudo_labels": lambda: generate_pseudo_labels(
            model, sets["new"], cfg.data, PseudoLabelConfig(enabled=True,
                                                            score_thresh=PSEUDO_SCORE),
            states.inverse_label_map(), mesh=mesh),
        "mas": lambda: {k: v.cpu().numpy() for k, v in compute_importance(
            model, anchors, loader(sets["old"]), mesh=mesh).items()},
    }
    det, bench = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    results, timing = {}, {}
    try:
        for name, images in DATA_AXIS_PASSES:
            torch.cuda.synchronize()
            before, t0 = stem_fused.launches, time.perf_counter()
            results[name] = run[name]()
            torch.cuda.synchronize()
            # herding runs two passes over its images
            timing[name] = {"s": time.perf_counter() - t0,
                            "launches": stem_fused.launches - before,
                            "batches": len(loader(sets[images])),
                            "passes": 2 if name == "herding" else 1}
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = det, bench
    return results, timing


def data_axis_path(tmp: str) -> dict:
    """Phase 14: the mesh's data axis on two ranks through ``cli.train`` and
    ``cli.validate`` with the process flags, (a) state 0, (b) state 1 with
    the IL battery, (c) ``cli.validate --mesh --bic`` under ``pallas_fp``,
    checked against one process (module docstring)."""
    import os
    import subprocess

    import numpy as np
    import torch

    t_phase = time.perf_counter()
    ranks = DATA_AXIS_RANKS
    data = os.path.join(tmp, "data")
    root = os.path.join(tmp, "run_dp")
    paths = ["--root_dir", root, "--train_json", os.path.join(data, "train.json"),
             "--image_dir", os.path.join(data, "images")]
    vflags = (["--root_dir", root, "--test_json", os.path.join(data, "test.json"),
               "--image_dir", os.path.join(data, "images"), "--state", "1", "--epoch", "1",
               "--threshold", "0.001", "--bic", "true"] + IL_MODEL_FLAGS)
    mesh = ["--mesh", "true"]
    root_z = os.path.join(tmp, "run_zero1")
    paths_z = ["--root_dir", root_z] + paths[2:]
    zero1 = ["--zero1", "true"]
    repo = os.path.dirname(os.path.abspath(__file__))
    spec = dict(root=root, roots=[root, root_z], repo=repo, out=os.path.join(tmp, "data_axis"),
                a=paths + IL_MODEL_FLAGS + DATA_AXIS_A + mesh,
                b=paths + IL_MODEL_FLAGS + DATA_AXIS_B + mesh, c=vflags + mesh,
                d=paths_z + IL_MODEL_FLAGS + DATA_AXIS_A + mesh + zero1,
                e=paths_z + IL_MODEL_FLAGS + DATA_AXIS_B + mesh + zero1)
    os.makedirs(spec["out"])
    spec_path = os.path.join(tmp, "data_axis_spec.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    child = os.path.join(tmp, "data_axis_child.py")
    with open(child, "w") as f:
        f.write(DATA_AXIS_CHILD)
    env = dict(os.environ, PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", ""))
    shared = torch.cuda.device_count() < ranks
    # a file store in the run's directory: no port to pick and lose
    address = "file://" + os.path.join(tmp, "data_axis_store")
    logs = [open(os.path.join(tmp, f"data_axis_rank{r}.log"), "w+") for r in range(ranks)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, child, str(r), str(ranks), address, spec_path],
                              cwd=repo, env=env, stdout=logs[r], stderr=subprocess.STDOUT)
             for r in range(ranks)]
    try:
        deadline = time.monotonic() + 600
        while any(p.poll() is None for p in procs):
            if time.monotonic() > deadline or any(p.poll() not in (None, 0) for p in procs):
                break
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    run_s = time.perf_counter() - t0
    tails = []
    for r, (p, lg) in enumerate(zip(procs, logs)):
        lg.seek(0)
        text = lg.read()
        lg.close()
        tails.append(text)
        for line in text.splitlines():
            if line.startswith("mesh:"):
                log(f"data axis rank {r}: {line}")
    for r, p in enumerate(procs):
        if p.returncode != 0:
            raise AssertionError(f"data axis: rank {r} exited {p.returncode}:\n"
                                 f"{tails[r][-3000:]}")
    recs = []
    for r in range(ranks):
        with open(os.path.join(spec["out"], f"rank{r}", "record.json")) as f:
            recs.append(json.load(f))
    record = check_data_axis_run(recs, shared, run_s)
    record["zero1"] = data_axis_zero1(root, root_z)
    torch.cuda.empty_cache()
    record["passes"] = data_axis_passes(spec, recs)
    torch.cuda.empty_cache()
    ref_flags = ["--root_dir", root + "_ref"] + paths[2:] + IL_MODEL_FLAGS + DATA_AXIS_A
    out = spec["out"]
    reference = first_apply_reference(
        ref_flags, os.path.join(out, "rank0", "init.pt"),
        [[os.path.join(out, f"rank{r}", f"batch{k}.npz") for r in range(ranks)] for k in (1, 2)])
    record["gradient"] = check_first_apply(f"data axis: (a)'s, {ranks} ranks,",
                                           os.path.join(out, "rank0", "grad.pt"), reference)
    torch.cuda.empty_cache()
    one_ips = data_axis_one_process(["--root_dir", root + "_one"] + paths[2:] + IL_MODEL_FLAGS
                                    + DATA_AXIS_A)
    torch.cuda.empty_cache()
    record["validate"] = data_axis_validate(root, data, vflags, recs)
    phase_s = time.perf_counter() - t_phase
    rec0 = recs[0]
    ips = {k: rec0[k]["epoch_log"][-1]["images"] / rec0[k]["epoch_log"][-1]["train_s"]
           for k in ("a", "b", "d", "e")}
    ar = sorted(rec0["allreduce"]["ms"])
    split_a = data_axis_split_a(recs)
    how = ("both ranks share one card over gloo, collectives through the host: not a scaling "
           "figure" if shared else "NCCL, one card per rank")
    ag = sorted(rec0["all_gather"]["ms"])
    log(f"data axis (R50 bf16 640x1024, global B=8 on {ranks} ranks, {how}; deterministic "
        f"cuDNN; {smi_line()}): (a) state 0 {ips['a']:.2f} images/s against {one_ips:.2f} for "
        f"one process on the same first epoch with the same cuDNN settings, (b) state 1 with "
        f"the battery {ips['b']:.2f} images/s, (d) = (a) under ZeRO-1 {ips['d']:.2f}, (e) = (b) "
        f"under ZeRO-1 {ips['e']:.2f} (host clock, loader included); gradient all-reduce "
        f"{np.median(ar):.1f} ms median (min {ar[0]:.1f}) for {rec0['allreduce']['mb']:.1f} MB; "
        f"ZeRO-1's param_all_gather {np.median(ag):.1f} ms median (min {ag[0]:.1f}) for "
        f"{rec0['all_gather']['mb']:.1f} MB over {rec0['d']['backend']}; IL passes in (b) on "
        f"{ranks} ranks "
        + ", ".join(f"{p['name']} {p['s']:.2f} s" for p in rec0["passes"]
                    if p["name"] != "agem_refresh" and p["run"] == "b")
        + f" (before the passes were split, whole on each of 2 ranks on an H100 80GB "
          f"HBM3 at 700 W: "
          f"similarity 0.63-0.77, MAS 1.10-1.55, pseudo-labels 0.38-0.54, BiC epoch "
          f"0.36-0.45 s), A-GEM refresh "
          f"{record['agem_ms_per_refresh']:.1f} ms each; Adam moments per rank (a) "
        + ", ".join(f"{r['a']['moment_bytes'] / 1e6:.1f}" for r in recs) + " MB, (d) "
        + ", ".join(f"{r['d']['moment_bytes'] / 1e6:.1f}" for r in recs)
        + " MB; peak memory per rank (a) "
        + ", ".join(f"{r['a']['peak_gib']:.2f}" for r in recs) + " GiB, (d) "
        + ", ".join(f"{r['d']['peak_gib']:.2f}" for r in recs)
        + f" GiB; the ranks' run {run_s:.1f} s; phase 14 took {phase_s:.1f} s")
    record.update(images_per_s=ips, one_process_images_per_s_a=one_ips, split_a=split_a,
                  allreduce_ms=rec0["allreduce"]["ms"],
                  allreduce_mb=rec0["allreduce"]["mb"], route=how,
                  all_gather_ms=rec0["all_gather"]["ms"], all_gather_mb=rec0["all_gather"]["mb"],
                  all_gather_backend=rec0["d"]["backend"],
                  moment_mb={k: [r[k]["moment_bytes"] / 1e6 for r in recs] for k in ("a", "d")},
                  peak_gib={k: [r[k]["peak_gib"] for r in recs] for k in ("a", "b", "d", "e")},
                  run_s=run_s, phase_s=phase_s)
    return record, reference


def data_axis_split_a(recs) -> list:
    """(a)'s epoch on each rank, split on the host clock (no trace): the
    epoch's training seconds, the loader waits among them, the micro-steps'
    seconds (``run_batch``, no synchronise: an apply's collectives wait
    for the card), and the checkpoint's blocking seconds."""
    out = []
    for r in recs:
        ep = r["a"]["epoch_log"][-1]
        steps = [s["s"] for s in r["steps"][slice(*r["a"]["steps"])]]
        out.append(dict(rank=r["rank"], train_s=ep["train_s"], loader_wait_s=ep["loader_wait_s"],
                        steps_s=steps, save_blocking_s=ep["save_blocking_s"]))
        log(f"data axis (a) rank {r['rank']} (host clock, untraced): epoch {ep['train_s']:.2f} s "
            f"of training, loader waits {ep['loader_wait_s']:.2f} s, {len(steps)} micro-steps "
            f"{sum(steps):.2f} s (first {steps[0]:.2f}, then median "
            f"{sorted(steps[1:])[len(steps[1:]) // 2]:.3f}, max {max(steps[1:]):.2f}), "
            f"checkpoint blocking {ep['save_blocking_s']:.2f} s")
    return out


def data_axis_one_process(flags) -> float:
    """(a) in one process on this card: ``cli.train`` of the same flags
    without ``--mesh``, one first epoch at global B=8 under the ranks'
    cuDNN settings (deterministic, no autotuning); its images/s (host
    clock, loader included), the baseline of (a)'s."""
    import numpy as np
    import torch

    from cl_object_detection_tpu_torch.cli.train import main as train_main

    det, bench = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        tr = train_main(flags)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = det, bench
    ep = tr.epoch_log[-1]
    if not np.isfinite(np.asarray(tr.loss_hist)).all():
        raise AssertionError("(a) in one process: a loss is not finite")
    return ep["images"] / ep["train_s"]


def _share(n: int, rank: int, world: int) -> int:
    """Rank ``rank``'s count of ``n`` batches dealt round robin."""
    return len(range(rank, n, world))


# the passes that split their whole batches over the ranks; the BiC epoch and the
# A-GEM refresh read every global batch's slice on every rank
SHARDED_PASSES = {"similarity", "mas", "pseudo_labels", "prototypes", "herding"}


def check_data_axis_run(recs, shared: bool, run_s: float) -> dict:
    """Phase 14's checks on the ranks' records (module docstring); returns
    the phase's record."""
    import numpy as np

    r0, r1 = recs[0], recs[1]
    world = len(recs)
    backends = {r[k]["backend"] for r in recs for k in ("a", "d")}
    want_backend = "gloo" if shared else "nccl"
    devices = [r["a"]["device"] for r in recs]
    steps = {k: r0[k]["steps"][1] - r0[k]["steps"][0] for k in ("a", "b", "d", "e")}
    log(f"data axis: backends {sorted(backends)} on {devices}; micro-steps {steps}; writes "
        f"into the run roots by rank: {[r['writes'] for r in recs]}")
    if backends != {want_backend} or len(set(devices)) != (1 if shared else len(recs)):
        raise AssertionError(f"backends {backends} on {devices}, want {want_backend}")
    for tag in ("a", "b", "d", "e"):
        if r0[tag]["checksums"] != r1[tag]["checksums"]:
            raise AssertionError(f"({tag}): the ranks' parameters differ")
        if r0[tag]["loss_hist"] != r1[tag]["loss_hist"]:
            raise AssertionError(f"({tag}): the ranks' global losses differ")
        if not np.isfinite(np.asarray(r0[tag]["loss_hist"])).all():
            raise AssertionError(f"({tag}): a loss is not finite")
        zero1 = tag in ("d", "e")
        if any(r[tag]["zero1"] != zero1 or r[tag]["sharded"] != zero1 for r in recs):
            raise AssertionError(f"({tag}): ZeRO-1 is {'off' if zero1 else 'on'}")
    for a, z in (("a", "d"), ("b", "e")):
        if any(r[a][k] != r[z][k] for r in recs for k in ("checksums", "loss_hist")):
            raise AssertionError(f"({z}) under ZeRO-1 differs from ({a})")
    if r1["writes"] != {"checkpoints": 0, "arrays": 0} or not r0["writes"]["checkpoints"]:
        raise AssertionError(f"writes {[r['writes'] for r in recs]}: only rank 0 may write")
    for tag in ("b", "e"):
        if r0[tag]["exemplars"] != r1[tag]["exemplars"] or r0[tag]["bic"] != r1[tag]["bic"]:
            raise AssertionError(f"({tag}): the ranks' exemplar ids or BiC scalars differ")
    if r0["e"]["exemplars"] != r0["b"]["exemplars"] or r0["e"]["bic"] != r0["b"]["bic"]:
        raise AssertionError("(e)'s exemplar ids or BiC scalars differ from (b)'s")
    for r in recs:
        for tag, want in (("a", 1), ("b", 2), ("d", 1), ("e", 2)):
            got = {s["launches"] for s in r["steps"][slice(*r[tag]["steps"])]}
            if got != {want} or any(s["replay"] for s in r["steps"][slice(*r[tag]["steps"])]):
                raise AssertionError(f"rank {r['rank']}: stem launches per micro-step {got} in "
                                     f"({tag}), want {want} (no replay micro-step)")
        passes = [dict(p) for p in r["passes"]] + [
            dict(v, name=k, run="passes") for k, v in r["sharded_passes"].items()]
        for p in passes:
            share = (_share(p["batches"], r["rank"], world) if p["name"] in SHARDED_PASSES
                     else p["batches"])
            if p["launches"] != share * p.get("passes", 1) or not p["batches"]:
                raise AssertionError(f"rank {r['rank']}: {p['name']} in ({p['run']}) launched "
                                     f"the stem {p['launches']} times for {p['batches']} "
                                     f"batches, want {share * p.get('passes', 1)}")
    for tag in ("b", "e"):
        names = [p["name"] for p in r0["passes"] if p["run"] == tag]
        for name in ("similarity", "mas", "pseudo_labels", "bic_epoch", "agem_refresh"):
            if name not in names:
                raise AssertionError(f"({tag}): the {name} pass did not run: {names}")
    refresh = [p for p in r0["passes"] if p["name"] == "agem_refresh" and p["run"] == "b"]
    log(f"data axis: ranks bit-identical after every epoch (checksums of "
        f"{len(r0['b']['checksums'])} tensors), (d) and (e) under ZeRO-1 bit-identical to (a) "
        f"and (b) (checksums and losses); exemplars {r0['b']['exemplars']}; BiC "
        f"{r0['b']['bic']}; stem launches per rank per micro-step 1 in (a) and (d), 2 in (b) "
        f"and (e); a sharded pass launches the stem once per batch of the rank's share "
        f"(ceil or floor of the batches / {world}); (c) per rank: "
        f"{[(r['c']['nms'], r['c']['stem']) for r in recs]} NMS and stem launches, mAP50 "
        f"{r0['c']['map50']:.4f}")
    return dict(micro_steps=steps, backend=want_backend,
                exemplars=r0["b"]["exemplars"], bic=r0["b"]["bic"],
                passes={p["run"] + ":" + p["name"]: p["s"] for p in r0["passes"]
                        if p["name"] != "agem_refresh"},
                pass_launches={r["rank"]: {p["run"] + ":" + p["name"]: [p["launches"],
                                                                        p["batches"]]
                                           for p in r["passes"]} for r in recs},
                agem_ms_per_refresh=sum(p["s"] for p in refresh) / len(refresh) * 1e3,
                launches_c=[(r["c"]["nms"], r["c"]["stem"]) for r in recs],
                seconds={k: r0[k]["s"] for k in ("a", "b", "c", "d", "e")})


def _state_file(root: str, state: int) -> str:
    import os

    return os.path.join(root, "checkpoint", "15_5", f"state{state}", "epoch1", "state.pt")


def _trees_equal(a, b) -> bool:
    import torch

    if isinstance(a, dict):
        return set(a) == set(b) and all(_trees_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_trees_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
    return a == b


def data_axis_zero1(root: str, root_z: str) -> dict:
    """(d) and (e) under ZeRO-1 against (a) and (b): each checkpoint's
    model and optimizer (whole moments, groups, step) bit for bit; the
    tensors compared."""
    import torch

    out = {}
    for state, (a, z) in enumerate((("a", "d"), ("b", "e"))):
        ta = torch.load(_state_file(root, state), map_location="cpu", weights_only=True)
        tz = torch.load(_state_file(root_z, state), map_location="cpu", weights_only=True)
        tensors = len(ta["model"]) + sum(len(v) for v in ta["optimizer"]["state"].values())
        same = _trees_equal(ta, tz)
        log(f"data axis: ({z}) under ZeRO-1 against ({a}): state-{state} checkpoint "
            f"({tensors} tensors: model, Adam moments, groups, step) equal bit for bit: {same}")
        if not same:
            raise AssertionError(f"({z})'s checkpoint differs from ({a})'s")
        out[f"{a}{z}_tensors"] = tensors
    return out


def data_axis_passes(spec, recs) -> dict:
    """The IL passes that the ranks ran on (a)'s state-0 model
    (``run_passes``), in one process on this card under the same cuDNN
    settings: the similarity matrix, the prototypes, the herding picks and
    the pseudo-labels bit for bit, the MAS importance within rtol 1e-5;
    each pass's seconds on the ranks and in one process."""
    import os

    import numpy as np
    import torch

    ranks = torch.load(os.path.join(spec["out"], "rank0", "passes.pt"), weights_only=False)
    one, timing = run_passes(spec)
    report = {}
    for name, _ in DATA_AXIS_PASSES:
        got, want = ranks[name], one[name]
        if name == "mas":
            worst = max(float(np.max(np.abs(got[k] - w) / np.maximum(np.abs(w), 1e-30)))
                        for k, w in want.items() if w.any())
            ok = set(got) == set(want) and all(
                np.allclose(got[k], w, rtol=1e-5, atol=0) for k, w in want.items())
            how = f"worst relative |d| {worst:.3g} (bar 1e-5)"
        else:
            ok = _equal_results(got, want)
            how = "bit for bit"
        rank_s = [r["sharded_passes"][name]["s"] for r in recs]
        report[name] = dict(equal=ok, one_process_s=timing[name]["s"], ranks_s=rank_s,
                            batches=timing[name]["batches"],
                            launches=[r["sharded_passes"][name]["launches"] for r in recs])
        log(f"data axis: sharded {name} on {len(recs)} ranks against one process: {how}: {ok}; "
            f"{timing[name]['batches']} batches, stem launches per rank "
            f"{report[name]['launches']} (one process {timing[name]['launches']}); "
            f"{max(rank_s):.2f} s on the ranks, {timing[name]['s']:.2f} s in one process")
        if not ok:
            raise AssertionError(f"the sharded {name} pass differs from one process's")
    empty = [k for k, v in (("similarity", one["similarity"].sum() > 0),
                            ("herding", bool(one["herding"])),
                            ("pseudo_labels", any(one["pseudo_labels"].values()))) if not v]
    if empty:
        raise AssertionError(f"these passes gave nothing to compare: {empty}")
    return report


def _equal_results(a, b) -> bool:
    import numpy as np

    if isinstance(a, dict):
        return list(a) == list(b) and all(_equal_results(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal_results(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return a.dtype == np.asarray(b).dtype and np.array_equal(a, b)
    return a == b


def first_apply_reference(flags, init_file: str, batch_files) -> dict:
    """One process's first-apply gradient from the weights in ``init_file``
    on the global batches that ``batch_files`` hold (per batch, the
    npz files of its slices in data-index order), a trainer of ``flags``
    on this card under the ranks' cuDNN settings, and phase 12's bar: the
    larger of the gradient bar and twice the move that one-ulp weight
    changes (four seeds) give that gradient. Also the weights and the
    batches, so that another mesh's run can be shown to start from the
    same ones."""
    import numpy as np
    import torch

    from cl_object_detection_tpu_torch.data.loader import Batch
    from cl_object_detection_tpu_torch.train import step as step_mod

    init = torch.load(init_file, weights_only=True)
    batches = []
    for files in batch_files:
        parts = [np.load(f) for f in files]
        arrays = {f: np.concatenate([p[f] for p in parts]) for f in ("images", "boxes", "labels")}
        n = arrays["images"].shape[0]
        batches.append(Batch(num_boxes=np.zeros(n, np.int32), num_pseudo=np.zeros(n, np.int32),
                             scales=np.ones(n, np.float32), image_ids=np.arange(n), **arrays))
    tr = trainer_from_flags(flags)
    real_reduce = step_mod.all_reduce_grads
    got = {}

    def capture(mesh, grads):
        got["g"] = {k: v.detach().clone() for k, v in grads.items()}
        return real_reduce(mesh, grads)

    def single(state):
        tr.model.load_state_dict(state)
        tr._new_train_state()
        tr.warm_up(1)
        for b in batches:
            tr.run_batch(b, sync_metrics=False)
        return {k: v.cpu() for k, v in got.pop("g").items()}

    det, bench = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    step_mod.all_reduce_grads = capture
    try:
        ref = single(init)
        moves = [_grads_rel(single(_ulp_moved(init, s)), ref)[0] for s in DATA_AXIS_ULP_SEEDS]
    finally:
        step_mod.all_reduce_grads = real_reduce
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = det, bench
    del tr
    return dict(grad=ref, moves=moves, bar=max(1.0, 2 * max(moves)), init=init,
                batches=[{f: getattr(b, f) for f in ("images", "boxes", "labels")}
                         for b in batches])


def same_start(ref: dict, init_file: str, batch_files) -> bool:
    """Whether a run's first weights and first global batches are
    ``ref``'s, bit for bit."""
    import numpy as np
    import torch

    init = torch.load(init_file, weights_only=True)
    if set(init) != set(ref["init"]) or not all(torch.equal(v, ref["init"][k])
                                                for k, v in init.items()):
        return False
    for files, want in zip(batch_files, ref["batches"]):
        parts = [np.load(f) for f in files]
        for f, w in want.items():
            if not np.array_equal(np.concatenate([p[f] for p in parts]), w):
                return False
    return True


def check_first_apply(label: str, grad_file: str, ref: dict) -> dict:
    """A run's first-apply gradient (``grad_file``, the whole gradient that
    the ranks reduced) against ``first_apply_reference``'s at its bar."""
    import torch

    want = torch.load(grad_file, weights_only=True)
    worst, rel, leaves = _grads_rel(want, ref["grad"])
    log(f"{label} first apply, the reduced gradient against one process's of the same global "
        f"batches from the same weights: worst {worst:.3g} of the gradient bar (|d| <= 1e-3 |g| "
        f"+ 1e-4 max|g| per leaf; largest |d| / max|g| {rel:.3g}; worst leaves {leaves}); "
        f"one-ulp weight moves give {[f'{m:.3g}' for m in ref['moves']]}; bar {ref['bar']:.3g}")
    if not worst <= ref["bar"]:
        raise AssertionError(f"{label} reduced gradient differs from one process's")
    return dict(worst=worst, rel=rel, ulp_moves=ref["moves"], bar=ref["bar"])


def _rows_by_key(rows):
    """{(image, category): [(score, bbox), ...] by descending score}."""
    out = {}
    for r in rows:
        out.setdefault((r["image_id"], r["category_id"]), []).append((r["score"], r["bbox"]))
    return {k: sorted(v, key=lambda t: -t[0]) for k, v in out.items()}


def _global_batches(vflags) -> int:
    """The number of global batches ``cli.validate`` of ``vflags`` runs."""
    from cl_object_detection_tpu_torch.cli import validate
    from cl_object_detection_tpu_torch.cli.common import args_to_config
    from cl_object_detection_tpu_torch.config import PredictConfig
    from cl_object_detection_tpu_torch.data.coco import CocoJson
    from cl_object_detection_tpu_torch.eval.evaluator import Evaluator
    from cl_object_detection_tpu_torch.states import ILStates

    a = validate.get_parser().parse_args(vflags)
    cfg = args_to_config(a)
    coco = CocoJson(a.test_json)
    states = ILStates(list(coco.classes.values()), coco.classes_inverse, list(cfg.il.scenario))
    return len(Evaluator(coco, states, a.image_dir, cfg.data, PredictConfig(),
                         state_index=a.state).loader)


def data_axis_validate(root: str, data: str, vflags, recs) -> dict:
    """(c) against one process: ``cli.validate`` of (a)'s checkpoint (phase
    9's reader), and of (b)'s with ``--bic`` under ``pallas_fp`` in
    batches of 4, the ranks' batch, whose rows (c)'s must equal bit for
    bit, and of 8, whose per-class AP50 (c)'s must hold within
    ``DATA_AXIS_AP_TOL`` (module docstring)."""
    import os

    import numpy as np
    import torch

    from cl_object_detection_tpu_torch import config as config_mod
    from cl_object_detection_tpu_torch.cli import validate

    def single(tag, flags):
        return validate.main(flags + ["--new_folder", "true", "--specific_folder", tag])

    res_a = single("single", ["--root_dir", root, "--test_json",
                              os.path.join(data, "test.json"), "--image_dir",
                              os.path.join(data, "images"), "--state", "0", "--epoch", "1"]
                   + IL_MODEL_FLAGS)
    if not np.isfinite(res_a[1].mean_ap50):
        raise AssertionError("cli.validate of (a)'s checkpoint: mAP not finite")
    # the ranks' cuDNN settings: deterministic, no autotuning (an earlier
    # phase leaves autotuning on, which picks other algorithms)
    det, bench = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    real_pc = config_mod.PredictConfig
    config_mod.PredictConfig = functools.partial(real_pc, nms_impl="pallas_fp")
    try:
        zero_counts()
        res4 = single("single4", vflags + ["--batch_size", "4"])
        counts = launch_counts()
        res8 = single("single8", vflags)
    finally:
        config_mod.PredictConfig = real_pc
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = det, bench
    out = os.path.join(root, "val_result", "15_5", "state1")
    rows = {}
    for tag in ("", "single4", "single8"):
        with open(os.path.join(out, tag, "voc2007_results_epoch1_bic.json")) as f:
            rows[tag] = json.load(f)
    same = rows[""] == rows["single4"]
    ap_ranks = recs[0]["c"]["ap50"]
    d_ap4 = max(abs(ap_ranks[c] - res4[1].ap50[c]) for c in ap_ranks)
    d_ap8 = max(abs(ap_ranks[c] - res8[1].ap50[c]) for c in ap_ranks)
    # beside it, the rows of the batches of 8 paired by (image, class) and rank
    by4, by8 = _rows_by_key(rows[""]), _rows_by_key(rows["single8"])
    paired = sum(min(len(v), len(by8.get(k, ()))) for k, v in by4.items())
    d_score = max((abs(a[0] - b[0]) for k, v in by4.items() for a, b in zip(v, by8.get(k, ()))),
                  default=0.0)
    log(f"data axis: (c) cli.validate --mesh --bic on {len(recs)} ranks (pallas_fp) against "
        f"one process: in batches of 4 (launches {counts}) {len(rows['single4'])} rows, equal "
        f"bit for bit: {same}, per-class AP50 largest |d| {d_ap4:.3g}; in batches of 8 "
        f"{len(rows['single8'])} rows against the ranks' {len(rows[''])} ({paired} paired by "
        f"(image, class) and rank, largest |d score| {d_score:.3g}), per-class AP50 largest |d| "
        f"{d_ap8:.3g} (bar {DATA_AXIS_AP_TOL}); mAP50 {recs[0]['c']['map50']:.4f} against "
        f"{res4[1].mean_ap50:.4f} and {res8[1].mean_ap50:.4f}; (a)'s checkpoint through phase "
        f"9's single-process reader: mAP50 {res_a[1].mean_ap50:.4f}")
    if not (same and rows[""] and d_ap4 == 0 and d_ap8 <= DATA_AXIS_AP_TOL):
        raise AssertionError("(c)'s rows or AP differ from one process's")
    batches = _global_batches(vflags)
    for r in recs:
        if not r["c"]["nms"] == r["c"]["stem"] == batches:
            raise AssertionError(f"rank {r['rank']}: (c) launches {r['c']}, want one NMS and "
                                 f"one stem launch per batch ({batches})")
    return dict(rows=len(rows[""]), equal_to_batches_of_4=same, d_ap50_batches_of_8=d_ap8,
                d_score_batches_of_8=d_score, map50=[recs[0]["c"]["map50"], res8[1].mean_ap50],
                map50_a=res_a[1].mean_ap50)


# phase 15's meshes on phase 8's toy data: (f) and (g) on a 1 x 2 mesh, (h) and
# (i) on a 2 x 2 mesh; the root directories, the data paths and the process
# flags are added per run
MODEL_AXIS_1X2 = ["--mesh", "true", "--num_data", "1", "--num_model", "2"]
MODEL_AXIS_2X2 = ["--mesh", "true", "--num_data", "2", "--num_model", "2"]
MODEL_AXIS_TIMED = 4             # micro-steps (two applies) with the collectives profiled
# the trunk's leaves whose slices the phase prints: (name, its slice on a rank)
MODEL_AXIS_SLICES = (("classification_head.conv1.weight", [128, 256, 3, 3]),
                     ("classification_head.conv2.weight", [256, 128, 3, 3]))
# the model group's collectives per micro-step at a trunk depth of 4: 2 per
# head and level forward (g after conv2 and conv4), 2 backward (f before conv1
# and conv3), 2 heads, 5 levels
MODEL_AXIS_CALLS = 2 * 2 * 5 * 2

# One rank of phase 15. Group "A" (2 ranks, 1 x 2): (f) cli.train state 0, then
# MODEL_AXIS_TIMED more micro-steps of (f)'s trainer under the profiler (the
# collectives' stream ms from the program's mesh spans), then (g) cli.train
# state 1 with the battery.
# Group "B" (4 ranks, 2 x 2): (h) cli.train state 0 under --zero1, its timed
# micro-steps, then (i) cli.validate --bic under pallas_fp. Each through its
# entry point with the process flags; records per micro-step the stem launches
# and the model group's collectives and gradient gathers, each A-GEM refresh's
# collectives, the writes into the run roots, the first apply's whole reduced
# gradient with its inputs, the slices' shapes, the moments and the peaks.
MODEL_AXIS_CHILD = r"""
import functools, json, os, sys, time
rank, world, address, spec_path, group = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                                          sys.argv[4], sys.argv[5])
with open(spec_path) as f:
    spec = json.load(f)
import numpy as np
import torch

from cl_object_detection_tpu_torch import config as config_mod
from cl_object_detection_tpu_torch.cli import validate
from cl_object_detection_tpu_torch.cli.train import main as train_main
from cl_object_detection_tpu_torch.il import agem as agem_mod
from cl_object_detection_tpu_torch.ops.nms_fp import nms_fp
from cl_object_detection_tpu_torch.ops.stem_fused import stem_fused
from cl_object_detection_tpu_torch.parallel import mesh as pm
from cl_object_detection_tpu_torch.train import step as step_mod
from cl_object_detection_tpu_torch.train import trainer as trainer_mod
from cl_object_detection_tpu_torch.utils import profiling
from cl_object_detection_tpu_torch.utils.checkpoint import host_copy

torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
proc = ["--coordinator_address", address, "--num_processes", str(world),
        "--process_id", str(rank)]
out = os.path.join(spec["out"], group, f"rank{rank}")
os.makedirs(out)
TRUNK = ("cldet.mesh.model_all_reduce", "cldet.mesh.model_all_gather")
GATHER = "cldet.mesh.gather_model_grads"
rec = {"rank": rank, "steps": [], "refreshes": [], "writes": {"checkpoints": 0, "arrays": 0}}
first = {}
run = {"tag": None, "refresh_calls": 0}
real = dict(run_batch=trainer_mod.ILTrainer.run_batch, reduce=step_mod.all_reduce_grads,
            rename=os.rename, savez=np.savez, predict_cfg=config_mod.PredictConfig,
            refresh=agem_mod.AGem.compute_replay_grad)

def snap():
    c, none = profiling.counters(), profiling.Count(0, 0)
    return dict(calls=sum(c.get(n, none).calls for n in TRUNK),
                bytes=sum(c.get(n, none).bytes for n in TRUNK),
                gathers=c.get(GATHER, none).calls, gather_bytes=c.get(GATHER, none).bytes)

def since(before):
    return {k: v - before[k] for k, v in snap().items()}

def run_batch(self, batch, is_replay=False, sync_metrics=True, correction=False):
    tag = run["tag"]
    if self.cur_state == 0 and first.get(tag, 0) < 2:
        if not first.get(tag):
            torch.save(host_copy(self.model.state_dict()), os.path.join(out, f"{tag}_init.pt"))
        first[tag] = first.get(tag, 0) + 1
        real["savez"](os.path.join(out, f"{tag}_batch{first[tag]}.npz"), images=batch.images,
                      boxes=batch.boxes, labels=batch.labels)
    before, calls, refreshes, t = stem_fused.launches, snap(), run["refresh_calls"], time.perf_counter()
    m = real["run_batch"](self, batch, is_replay=is_replay, sync_metrics=sync_metrics,
                          correction=correction)
    rec["steps"].append({"run": tag, "state": self.cur_state, "replay": is_replay,
                         "launches": stem_fused.launches - before, "s": time.perf_counter() - t,
                         "refresh_calls": run["refresh_calls"] - refreshes, **since(calls)})
    return m

def all_reduce_grads(mesh, grads):
    reduced = real["reduce"](mesh, grads)
    if run["tag"] in ("f", "h") and not first.get(run["tag"] + "_grad"):
        first[run["tag"] + "_grad"] = True
        if rank == 0:
            torch.save(host_copy(reduced), os.path.join(out, f"{run['tag']}_grad.pt"))
    return reduced

def refresh(self, *args, **kw):
    before = snap()
    result = real["refresh"](self, *args, **kw)
    got = since(before)
    run["refresh_calls"] += got["calls"]
    rec["refreshes"].append({"run": run["tag"], "batches": len(self.replay_loader), **got})
    return result

def counted(kind, fn):
    def wrapper(*args, **kw):
        if any(str(args[1] if kind == "checkpoints" else args[0]).startswith(r)
               for r in spec["roots"]):
            rec["writes"][kind] += 1
        return fn(*args, **kw)
    return wrapper

trainer_mod.ILTrainer.run_batch = run_batch
step_mod.all_reduce_grads = all_reduce_grads
agem_mod.AGem.compute_replay_grad = refresh
os.rename = counted("checkpoints", real["rename"])
np.savez = counted("arrays", real["savez"])

def train(tag):
    run["tag"] = tag
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start, t0 = len(rec["steps"]), time.perf_counter()
    tr = train_main(spec[tag] + proc)
    torch.cuda.synchronize()
    params = dict(tr.model.named_parameters())
    rec[tag] = {"s": time.perf_counter() - t0, "epoch_log": tr.epoch_log,
                "checksums": pm.check_replicas(tr.mesh, tr.model),
                "loss_hist": list(tr.loss_hist), "mesh": pm.describe(tr.mesh),
                "backend": tr.mesh.backend, "device": str(tr.device), "shape": tr.mesh.shape,
                "index": [tr.mesh.data_index, tr.mesh.model_index], "zero1": tr.mesh.zero1,
                "sharded": tr.optimizer.sharded, "moment_bytes": tr.optimizer.moment_bytes(),
                "trunk_moments": {n: sum(v.numel() for v in
                                         tr.optimizer.state.get(params[n], {}).values())
                                  / (2 * params[n].numel()) for n, _ in spec["slices"]},
                "slices": {n: list(pm.shard_of(params[n], (pm.head_tp_shard(
                    n, params[n].shape, tr.mesh.num_model, tr.mesh.model_index),)).shape)
                           for n, _ in spec["slices"]},
                "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                "steps": [start, len(rec["steps"])]}
    if tr.cur_state >= 1:
        rec[tag].update(exemplars=list(tr.dataset_replay.image_ids),
                        bic=[tr.bic.params.alphas.tolist(), tr.bic.params.betas.tolist()])
    return tr

def timed_steps(tr, tag):
    # MODEL_AXIS_TIMED more micro-steps on the trainer's first batch under the
    # profiler: each one's stream ms of the model group's collectives and
    # gradient gathers, from the program's mesh spans
    run["tag"] = tag
    batch = next(iter(tr.train_loader))
    start = len(rec["steps"])
    profiling.clear_spans()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts):
        for _ in range(spec["timed"]):
            tr.run_batch(batch, sync_metrics=False)
    spans = profiling.spans()
    roots = [s.call for s in spans if s.parent is None and s.name == "cldet.train.step"]
    for step, call in zip(rec["steps"][start:], roots):
        mine = [s for s in spans if s.call == call]
        step["coll_s"] = sum(s.stream_ms for s in mine if s.name in TRUNK) / 1e3
        step["gather_s"] = sum(s.stream_ms for s in mine if s.name == GATHER) / 1e3
    rec[tag] = {"steps": [start, len(rec["steps"])]}

if group == "A":
    tr = train("f")
    mesh = tr.mesh
    timed_steps(tr, "f_timed")
    del tr
    torch.cuda.empty_cache()
    tr = train("g")
    del tr
else:
    tr = train("h")
    mesh = tr.mesh
    timed_steps(tr, "h_timed")
    del tr
    torch.cuda.empty_cache()
    run["tag"] = "i"
    config_mod.PredictConfig = functools.partial(real["predict_cfg"], nms_impl="pallas_fp")
    nms0, stem0, t0 = nms_fp.launches, stem_fused.launches, time.perf_counter()
    res = validate.main(spec["i"] + proc)
    config_mod.PredictConfig = real["predict_cfg"]
    rec["i"] = {"s": time.perf_counter() - t0, "nms": nms_fp.launches - nms0,
                "stem": stem_fused.launches - stem0, "map50": res[1].mean_ap50}
torch.cuda.empty_cache()
with open(os.path.join(out, "record.json"), "w") as f:
    json.dump(rec, f)
pm.barrier(mesh)
torch.distributed.destroy_process_group()
print(f"rank {rank}: done", flush=True)
"""


def start_group(tmp: str, spec_path: str, group: str, ranks: int, timeout: float = 600):
    """Phase 15's ``group`` of ``ranks`` child processes (one process group,
    a file store in ``tmp``); waits for them, raises if one fails; returns
    their records and the seconds they took."""
    import os
    import subprocess

    child = os.path.join(tmp, "model_axis_child.py")
    if not os.path.exists(child):
        with open(child, "w") as f:
            f.write(MODEL_AXIS_CHILD)
    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", ""))
    address = "file://" + os.path.join(tmp, f"model_axis_store_{group}")
    logs = [open(os.path.join(tmp, f"model_axis_{group}_rank{r}.log"), "w+")
            for r in range(ranks)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, child, str(r), str(ranks), address, spec_path,
                               group], cwd=repo, env=env, stdout=logs[r],
                              stderr=subprocess.STDOUT) for r in range(ranks)]
    try:
        deadline = time.monotonic() + timeout
        while any(p.poll() is None for p in procs):
            if time.monotonic() > deadline or any(p.poll() not in (None, 0) for p in procs):
                break
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    run_s = time.perf_counter() - t0
    tails = []
    for r, lg in enumerate(logs):
        lg.seek(0)
        tails.append(lg.read())
        lg.close()
        for line in tails[r].splitlines():
            if line.startswith("mesh:"):
                log(f"model axis {group} rank {r}: {line}")
    for r, p in enumerate(procs):
        if p.returncode != 0:
            raise AssertionError(f"model axis {group}: rank {r} exited {p.returncode}:\n"
                                 f"{tails[r][-3000:]}")
    with open(spec_path) as f:
        out = json.load(f)["out"]
    recs = []
    for r in range(ranks):
        with open(os.path.join(out, group, f"rank{r}", "record.json")) as f:
            recs.append(json.load(f))
    return recs, run_s


def model_axis_path(tmp: str, reference: dict, data_axis: dict) -> dict:
    """Phase 15: the mesh's model axis through ``cli.train`` and
    ``cli.validate`` with the process flags: (f) state 0 and (g) state 1
    with the battery on a 1 x 2 mesh, (h) state 0 under ``--zero1`` and (i)
    ``cli.validate --bic`` under ``pallas_fp`` on a 2 x 2 mesh, checked
    against one process (module docstring). ``reference`` is phase 14's
    one-process first apply, from the same weights on the same batches;
    ``data_axis`` phase 14's record (its moments, printed beside)."""
    import os

    import numpy as np
    import torch

    t_phase = time.perf_counter()
    data = os.path.join(tmp, "data")
    root = os.path.join(tmp, "run_mp")
    root_h = os.path.join(tmp, "run_mp_zero1")
    paths = ["--train_json", os.path.join(data, "train.json"), "--image_dir",
             os.path.join(data, "images")]
    vflags = (["--root_dir", root, "--test_json", os.path.join(data, "test.json"),
               "--image_dir", os.path.join(data, "images"), "--state", "1", "--epoch", "1",
               "--threshold", "0.001", "--bic", "true"] + IL_MODEL_FLAGS)
    spec = dict(roots=[root, root_h], out=os.path.join(tmp, "model_axis"), timed=MODEL_AXIS_TIMED,
                slices=MODEL_AXIS_SLICES,
                f=["--root_dir", root] + paths + IL_MODEL_FLAGS + DATA_AXIS_A + MODEL_AXIS_1X2,
                g=["--root_dir", root] + paths + IL_MODEL_FLAGS + DATA_AXIS_B + MODEL_AXIS_1X2,
                h=(["--root_dir", root_h] + paths + IL_MODEL_FLAGS + DATA_AXIS_A + MODEL_AXIS_2X2
                   + ["--zero1", "true"]),
                i=vflags + MODEL_AXIS_2X2)
    spec_path = os.path.join(tmp, "model_axis_spec.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    recs_a, run_a = start_group(tmp, spec_path, "A", 2)
    torch.cuda.empty_cache()
    recs_b, run_b = start_group(tmp, spec_path, "B", 4)
    torch.cuda.empty_cache()
    record = check_model_axis_run(recs_a, recs_b)
    log(f"model axis: (g)'s exemplar ids {record['exemplars']} and BiC scalars {record['bic']} "
        f"beside phase 14's (b): {data_axis['exemplars']} and {data_axis['bic']}")
    out = spec["out"]
    # (f)'s and (h)'s first apply against one process: the global batch is the
    # model index 0 ranks' slices in data-index order
    record["gradient"] = {}
    for tag, group, data_ranks in (("f", "A", (0,)), ("h", "B", (0, 2))):
        init = os.path.join(out, group, "rank0", f"{tag}_init.pt")
        files = [[os.path.join(out, group, f"rank{r}", f"{tag}_batch{k}.npz") for r in data_ranks]
                 for k in (1, 2)]
        if not same_start(reference, init, files):
            raise AssertionError(f"({tag}) did not start from phase 14's weights and batches")
        record["gradient"][tag] = check_first_apply(
            f"model axis: ({tag})'s, {len(recs_a if group == 'A' else recs_b)} ranks,",
            os.path.join(out, group, "rank0", f"{tag}_grad.pt"), reference)
    record["validate"] = model_axis_validate(root, root_h, data, vflags, recs_b)
    phase_s = time.perf_counter() - t_phase
    smi = smi_line()
    ips = {}
    for tag, recs in (("f", recs_a), ("g", recs_a), ("h", recs_b)):
        ep = recs[0][tag]["epoch_log"][-1]
        ips[tag] = ep["images"] / ep["train_s"]
    timed = {}
    for tag, recs in (("f", recs_a), ("h", recs_b)):
        steps = recs[0]["steps"][slice(*recs[0][tag + "_timed"]["steps"])]
        gathers = [s for s in steps if s["gathers"]]
        timed[tag] = dict(
            coll_ms=sorted(s["coll_s"] * 1e3 for s in steps),
            calls=[s["calls"] for s in steps], mb=steps[0]["bytes"] / 1e6,
            gather_ms=sorted(s["gather_s"] * 1e3 / s["gathers"] for s in gathers),
            gather_mb=gathers[0]["gather_bytes"] / 1e6 / gathers[0]["gathers"],
            step_ms=sorted(s["s"] * 1e3 for s in steps))
    how = {t: ("all ranks share one card over gloo, collectives through the host"
               if r[0][t]["backend"] == "gloo" else "NCCL, one card per rank")
           for t, r in (("f", recs_a), ("h", recs_b))}
    log(f"model axis (R50 bf16 640x1024, global B=8; {smi}): (f) 1 x 2 ({how['f']}) "
        f"{ips['f']:.2f} images/s, (g) state 1 with the battery {ips['g']:.2f}, (h) 2 x 2 "
        f"under ZeRO-1 ({how['h']}) {ips['h']:.2f} (host clock, loader included; phase 14's "
        f"(a) {data_axis['images_per_s']['a']:.2f} and (d) {data_axis['images_per_s']['d']:.2f} "
        f"on 2 ranks of the data axis)")
    for tag in ("f", "h"):
        t = timed[tag]
        log(f"model axis ({tag}) ({smi}): the model group's collectives per micro-step "
            f"{np.median(t['coll_ms']):.1f} ms median (min {t['coll_ms'][0]:.1f}) for {t['mb']:.1f} MB "
            f"in {t['calls'][0]} collectives; gradient gather over the model group "
            f"{np.median(t['gather_ms']):.1f} ms median (min {t['gather_ms'][0]:.1f}) for "
            f"{t['gather_mb']:.1f} MB (stream ms of the mesh spans); the micro-step under the "
            f"profiler {np.median(t['step_ms']):.1f} ms (host clock)")
    log(f"model axis ({smi}): Adam moments per rank (f) "
        + ", ".join(f"{r['f']['moment_bytes'] / 1e6:.1f}" for r in recs_a) + " MB, (h) "
        + ", ".join(f"{r['h']['moment_bytes'] / 1e6:.1f}" for r in recs_b) + " MB (phase 14: (a) "
        + ", ".join(f"{m:.1f}" for m in data_axis["moment_mb"]["a"]) + ", (d) "
        + ", ".join(f"{m:.1f}" for m in data_axis["moment_mb"]["d"]) + " MB); peak memory per "
        "rank (f) " + ", ".join(f"{r['f']['peak_gib']:.2f}" for r in recs_a) + ", (g) "
        + ", ".join(f"{r['g']['peak_gib']:.2f}" for r in recs_a) + ", (h) "
        + ", ".join(f"{r['h']['peak_gib']:.2f}" for r in recs_b) + f" GiB; the ranks' runs "
        f"{run_a:.1f} s (A) and {run_b:.1f} s (B); phase 15 took {phase_s:.1f} s")
    record.update(images_per_s=ips, timed=timed, route=how, run_s=[run_a, run_b],
                  moment_mb={"f": [r["f"]["moment_bytes"] / 1e6 for r in recs_a],
                             "h": [r["h"]["moment_bytes"] / 1e6 for r in recs_b]},
                  peak_gib={"f": [r["f"]["peak_gib"] for r in recs_a],
                            "g": [r["g"]["peak_gib"] for r in recs_a],
                            "h": [r["h"]["peak_gib"] for r in recs_b]},
                  card=smi, phase_s=phase_s)
    return record


def check_model_axis_run(recs_a, recs_b) -> dict:
    """Phase 15's checks on the ranks' records (module docstring); returns
    the phase's record."""
    import numpy as np
    import torch

    for group, recs, tags in (("A", recs_a, ("f", "g")), ("B", recs_b, ("h",))):
        world, shared = len(recs), torch.cuda.device_count() < len(recs)
        want_backend = "gloo" if shared else "nccl"
        num_data = world // 2
        for tag in tags:
            r0 = recs[0][tag]
            if {r[tag]["backend"] for r in recs} != {want_backend}:
                raise AssertionError(f"({tag}): backends {[r[tag]['backend'] for r in recs]}, "
                                     f"want {want_backend}")
            if r0["shape"] != {"data": num_data, "model": 2} or [r[tag]["index"] for r in recs] != [
                    [d, m] for d in range(num_data) for m in range(2)]:
                raise AssertionError(f"({tag}): mesh {r0['shape']}, places "
                                     f"{[r[tag]['index'] for r in recs]}")
            if any(r[tag]["checksums"] != r0["checksums"] for r in recs):
                raise AssertionError(f"({tag}): the ranks' parameters differ")
            if any(r[tag]["loss_hist"] != r0["loss_hist"] for r in recs):
                raise AssertionError(f"({tag}): the ranks' global losses differ")
            if not np.isfinite(np.asarray(r0["loss_hist"])).all():
                raise AssertionError(f"({tag}): a loss is not finite")
            fraction = 0.25 if tag == "h" else 0.5         # (g)'s last optimizer has no step yet
            for r in recs:
                if r[tag]["slices"] != {n: shape for n, shape in MODEL_AXIS_SLICES}:
                    raise AssertionError(f"rank {r['rank']}: slices {r[tag]['slices']}")
                if tag != "g" and set(r[tag]["trunk_moments"].values()) != {fraction}:
                    raise AssertionError(f"rank {r['rank']} ({tag}): trunk moments "
                                         f"{r[tag]['trunk_moments']}, want {fraction} each")
                steps = r["steps"][slice(*r[tag]["steps"])]
                want = 2 if tag == "g" else 1
                if {s["launches"] for s in steps} != {want} or any(s["replay"] for s in steps):
                    raise AssertionError(f"rank {r['rank']}: stem launches per micro-step "
                                         f"{sorted({s['launches'] for s in steps})} in ({tag}), "
                                         f"want {want} (no replay micro-step)")
                calls = {s["calls"] - s["refresh_calls"] for s in steps}
                if calls != {MODEL_AXIS_CALLS} or sum(s["gathers"] for s in steps) != len(
                        steps) // 2:
                    raise AssertionError(f"rank {r['rank']} ({tag}): collectives per micro-step "
                                         f"{calls}, want {MODEL_AXIS_CALLS}; gradient gathers "
                                         f"{sum(s['gathers'] for s in steps)} in {len(steps)} "
                                         "micro-steps, want one per apply")
            for r in recs:
                timed = r["steps"][slice(*r[tag + "_timed"]["steps"])] if tag != "g" else []
                if any(s["calls"] != MODEL_AXIS_CALLS for s in timed):
                    raise AssertionError(f"({tag}) timed: collectives {[s['calls'] for s in timed]}")
        if any(r["writes"] != {"checkpoints": 0, "arrays": 0} for r in recs[1:]) or not recs[0][
                "writes"]["checkpoints"]:
            raise AssertionError(f"group {group} writes {[r['writes'] for r in recs]}: only rank 0 "
                                 "may write")
    g0 = recs_a[0]["g"]
    if any(r["g"]["exemplars"] != g0["exemplars"] or r["g"]["bic"] != g0["bic"] for r in recs_a):
        raise AssertionError("(g): the ranks' exemplar ids or BiC scalars differ")
    if not g0["exemplars"] or not np.isfinite(np.asarray(g0["bic"])).all():
        raise AssertionError(f"(g): exemplars {g0['exemplars']}, BiC {g0['bic']}")
    refreshes = [p for p in recs_a[0]["refreshes"] if p["run"] == "g"]
    if not refreshes or any(p["calls"] != MODEL_AXIS_CALLS * p["batches"] for p in refreshes):
        raise AssertionError(f"(g): A-GEM refreshes' collectives "
                             f"{[(p['calls'], p['batches']) for p in refreshes]}, want "
                             f"{MODEL_AXIS_CALLS} per replay batch")
    steps = {t: recs[0][t]["steps"][1] - recs[0][t]["steps"][0]
             for t, recs in (("f", recs_a), ("g", recs_a), ("h", recs_b))}
    log(f"model axis: ranks bit-identical after every epoch (checksums of "
        f"{len(recs_a[0]['g']['checksums'])} tensors), global losses equal; slices "
        f"{dict(MODEL_AXIS_SLICES)}; trunk moments per rank 1/2 in (f), 1/4 in (h); stem "
        f"launches per rank per micro-step 1 in (f) and (h), 2 in (g); {MODEL_AXIS_CALLS} "
        f"collectives of the model group per micro-step and one gradient gather per apply "
        f"(micro-steps {steps}); A-GEM refreshes {MODEL_AXIS_CALLS} per replay batch; only "
        f"rank 0 wrote; (g): exemplars {g0['exemplars']}, BiC {g0['bic']}, state-1 losses "
        f"{min(g0['loss_hist']):.4g}..{max(g0['loss_hist']):.4g}")
    return dict(micro_steps=steps, exemplars=g0["exemplars"], bic=g0["bic"],
                backend={t: r[0][t]["backend"] for t, r in (("f", recs_a), ("h", recs_b))},
                seconds={t: recs[0][t]["s"] for t, recs in (("f", recs_a), ("g", recs_a),
                                                              ("h", recs_b), ("i", recs_b))})


def model_axis_validate(root: str, root_h: str, data: str, vflags, recs) -> dict:
    """One process's ``cli.validate`` reads (f)'s and (h)'s state-0
    checkpoints; (i)'s rows equal bit for bit one process's ``cli.validate``
    of (g)'s checkpoint with ``--bic`` under ``pallas_fp`` in batches of 4
    (each data rank's share: the same images in the same slots), and each
    rank launched one NMS and one stem kernel per global batch."""
    import os

    import numpy as np
    import torch

    from cl_object_detection_tpu_torch import config as config_mod
    from cl_object_detection_tpu_torch.cli import validate

    read = {}
    for tag, run in (("f", root), ("h", root_h)):
        res = validate.main(["--root_dir", run, "--test_json", os.path.join(data, "test.json"),
                             "--image_dir", os.path.join(data, "images"), "--state", "0",
                             "--epoch", "1"] + IL_MODEL_FLAGS)
        read[tag] = res[1].mean_ap50
        if not np.isfinite(read[tag]):
            raise AssertionError(f"cli.validate of ({tag})'s checkpoint: mAP not finite")
    det, bench = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    real_pc = config_mod.PredictConfig
    config_mod.PredictConfig = functools.partial(real_pc, nms_impl="pallas_fp")
    try:
        res4 = validate.main(vflags + ["--batch_size", "4", "--new_folder", "true",
                                       "--specific_folder", "single4"])
    finally:
        config_mod.PredictConfig = real_pc
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = det, bench
    out = os.path.join(root, "val_result", "15_5", "state1")
    rows = {}
    for tag in ("", "single4"):
        with open(os.path.join(out, tag, "voc2007_results_epoch1_bic.json")) as f:
            rows[tag] = json.load(f)
    same = bool(rows[""]) and rows[""] == rows["single4"]
    batches = _global_batches(vflags)
    log(f"model axis: (i) cli.validate --mesh --bic on {len(recs)} ranks (2 x 2, pallas_fp) "
        f"against one process in batches of 4: {len(rows['single4'])} rows, equal bit for bit: "
        f"{same}; mAP50 {recs[0]['i']['map50']:.4f} against {res4[1].mean_ap50:.4f}; per rank "
        f"NMS and stem launches {[(r['i']['nms'], r['i']['stem']) for r in recs]} for "
        f"{batches} global batches; one process reads (f)'s and (h)'s checkpoints: mAP50 "
        f"{read['f']:.4f}, {read['h']:.4f}")
    if not same:
        raise AssertionError("(i)'s rows differ from one process's")
    for r in recs:
        if not r["i"]["nms"] == r["i"]["stem"] == batches:
            raise AssertionError(f"rank {r['rank']}: (i) launches {r['i']}, want one NMS and "
                                 f"one stem launch per global batch ({batches})")
    return dict(rows=len(rows[""]), equal_to_batches_of_4=same, map50=recs[0]["i"]["map50"],
                readback_map50=read)


# Phase 17's tools, in lanes that run side by side on the card (each lane
# one tool after another): (tool, arguments); phase 8's run and toy images
# fill the serving tool's {run} and {image}
TOOL_LANES = (
    (("bench_train", ["--split", "--batch", "8", "--iters", "3", "--stem", "fused",
                      "--height", "608", "--width", "832"]),
     ("mem_report", ["--depth", "50", "--batch", "8", "--height", "608", "--width", "832"])),
    (("bench_split", ["--batch", "32", "--iters", "3", "--nms_impl", "pallas_fp",
                      "fwd", "det", "full", "bb", "feats"]),
     ("bench_sweep", ["--stem", "fused", "--nms_impl", "pallas_fp", "--iters", "3", "--mfu",
                      "32"])),
    (("bench_backbone", ["--batch", "16", "--iters", "3", "stem", "s1", "s2", "s3", "s4",
                         "nobn", "f32"]),
     ("bench_fwd_floor", ["--batch", "32", "--iters", "3"])),
    (("bench_bwd_breakdown", ["--batch", "8", "--iters", "3"]),
     ("bench_nms", ["--iters", "5"]),
     ("bench_int8_matmul", ["--iters", "10"])),
    (("bench_loader", ["--images", "32", "--workers", "2", "--epochs", "2", "--fused"]),
     ("bench_serve", ["--root_dir", "{run}", "--scenario", "20", "--state", "0",
                      "--image", "{image}", "--concurrency", "1", "8", "--requests", "16",
                      "--warmup", "2"])),
)
TOOL_TIMEOUT = 400               # seconds for one tool
CHAIN_ITERS = 10                 # predicts per chained run, and per cuda_ms figure


def run_lane(lane, fill: dict, out: dict) -> None:
    """Run one lane's tools one after another; ``out[tool]`` = (exit code,
    stdout, stderr tail, seconds)."""
    import os

    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", ""))
    for tool, args in lane:
        t0 = time.perf_counter()
        try:
            done = subprocess.run(
                [sys.executable, "-m", f"cl_object_detection_tpu_torch.tools.{tool}",
                 *(a.format(**fill) for a in args)],
                cwd=repo, env=env, capture_output=True, text=True, timeout=TOOL_TIMEOUT)
            out[tool] = (done.returncode, done.stdout, done.stderr[-3000:],
                         time.perf_counter() - t0)
        except subprocess.TimeoutExpired as e:
            out[tool] = (None, e.stdout or "", f"timed out after {TOOL_TIMEOUT} s",
                         time.perf_counter() - t0)


def _compact(record: dict) -> dict:
    """A record's figures for the summary line: numbers to 4 significant
    digits, nonzero launch counts, the card left out."""
    out = {}
    for k, v in record.items():
        if k in ("card", "differences", "image_format", "flops_source", "unit", "timer"):
            continue
        if isinstance(v, float):
            out[k] = float(f"{v:.4g}")
        elif isinstance(v, dict):
            kept = {n: c for n, c in v.items() if c}
            if kept:
                out[k] = kept
        else:
            out[k] = v
    return out


def tools_path(tmp: str, train: dict, phase4_ms: float) -> dict:
    """Phase 17: ``utils.benchlib`` in this process, then every measuring
    tool of ``cl_object_detection_tpu_torch.tools`` as a subprocess on the
    card (module docstring)."""
    import os

    import torch

    from cl_object_detection_tpu_torch.config import PredictConfig
    from cl_object_detection_tpu_torch.data.transforms import space_to_depth
    from cl_object_detection_tpu_torch.eval.predictor import make_predict_fn
    from cl_object_detection_tpu_torch.ops.anchors import anchors_for_shape
    from cl_object_detection_tpu_torch.utils import benchlib

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    smi = smi_line()

    # ---- (a) benchlib in this process, on phase 4's model and frames ----
    model = build_model()
    frames32 = torch.from_numpy(space_to_depth(make_frames(32, 5), factor=4)).to(dev)
    calibrate_logits(model, frames32[:2])
    anchors = torch.tensor(anchors_for_shape(H, W), device=dev)
    predict_sum = benchlib.make_predict_sum(model, anchors, PredictConfig(nms_impl="pallas_fp"),
                                            H, W)
    zero_counts()
    got = float(predict_sum(frames32))
    counts = launch_counts()
    plain = make_predict_fn(model, PredictConfig(nms_impl="iterative"))(frames32)
    want = float(plain.scores.float().sum())
    log(f"tools: make_predict_sum (pallas_fp) {got:.6f} against the plain predict's summed "
        f"scores (iterative NMS) {want:.6f}, relative difference "
        f"{abs(got - want) / abs(want):.3e} (bar 1e-4); launches {counts}")
    if not abs(got - want) <= 1e-4 * abs(want):
        raise AssertionError("make_predict_sum disagrees with the plain predict")
    if counts["stem_fused"] < 1 or counts["nms_fp"] < 1:
        raise AssertionError(f"make_predict_sum did not launch the stem and NMS kernels: "
                             f"{counts}")
    predict = make_predict_fn(model, PredictConfig(nms_impl="pallas_fp"))
    chained_ms = benchlib.time_chained(predict_sum, frames32, iters=CHAIN_ITERS,
                                       reps=1) / CHAIN_ITERS * 1e3
    events_ms = cuda_ms(lambda: predict(frames32), iters=CHAIN_ITERS, warmup=1)
    log(f"tools: B=32 float predict, time_chained {chained_ms:.3f} ms per predict (chains of "
        f"{CHAIN_ITERS}, one wait) against cuda_ms {events_ms:.3f} ms (ratio "
        f"{chained_ms / events_ms:.4f}) and phase 4's host clock {phase4_ms:.3f} ms; {smi}")
    del model, frames32, predict_sum, predict, plain
    torch.cuda.empty_cache()

    # ---- (b) every measuring tool as a subprocess ----
    fill = {"run": os.path.join(tmp, "run"),
            "image": os.path.join(tmp, "data", "images", "train_0001.png")}
    results: dict = {}
    t0 = time.perf_counter()
    lanes = [threading.Thread(target=run_lane, args=(lane, fill, results))
             for lane in TOOL_LANES]
    for t in lanes:
        t.start()
    for t in lanes:
        t.join()
    tools_s = time.perf_counter() - t0
    checked = check_tool_records(results, smi, train["peak_gib"])
    phase_s = time.perf_counter() - t_phase
    log(f"tools: phase 17 took {phase_s:.1f} s ({tools_s:.1f} s for the tools in "
        f"{len(TOOL_LANES)} lanes side by side on the card)")
    return {"card": smi, "seconds": phase_s, "tools_seconds": tools_s,
            "predict_sum": got, "plain_scores_sum": want,
            "time_chained_ms": chained_ms, "cuda_ms": events_ms, "phase4_ms": phase4_ms,
            **checked}


def check_tool_records(results: dict, smi: str, train_peak_gib: float) -> dict:
    """Phase 17's checks of the tools' runs (module docstring);
    ``results[tool]`` = (exit code, stdout, stderr tail, seconds). Returns
    the launches counted, ``mem_report``'s peak against phase 7's and
    each tool's records, compacted."""
    records: dict = {}
    for lane in TOOL_LANES:
        for tool, _ in lane:
            rc, out, err, seconds = results[tool]
            if rc != 0:
                raise AssertionError(f"tool {tool} exited {rc}: {err}")
            recs = [json.loads(line) for line in out.splitlines() if line.startswith("{")]
            if not recs:
                raise AssertionError(f"tool {tool} printed no record")
            for r in recs:
                log(f"  {tool}: {json.dumps(r)}")
                bad = finite_positive(r, r.get("differences", ()))
                if r.get("card") != smi or bad:
                    raise AssertionError(f"tool {tool}: record without the card's line or "
                                         f"with figures not finite and positive {bad}: {r}")
            records[tool] = recs
            log(f"tools: {tool} {seconds:.1f} s, {len(recs)} records")

    nms = sum(r["launches"] for r in records["bench_nms"] if r["kind"] == "pallas_fp")
    int8 = [r["launches"] for r in records["bench_int8_matmul"] if "launches" in r]
    stem = sum(r["launches"]["stem_fused"] for r in records["bench_backbone"])
    serve = {r["concurrency"]: r for r in records["bench_serve"]}
    mem = records["mem_report"][0]
    mem_rel = mem["peak_allocated_gib"] / train_peak_gib - 1
    log(f"tools: kernels launched through the tools: NMS {nms} (bench_nms), int8 {int8} "
        f"(bench_int8_matmul, GEMM and conv modes), stem {stem} (bench_backbone); "
        f"bench_serve errors at concurrency 1 and 8: {serve[1]['errors']}, "
        f"{serve[8]['errors']}; mem_report's peak {mem['peak_allocated_gib']:.3f} GiB "
        f"against phase 7's {train_peak_gib:.3f} GiB ({mem_rel:+.2%}, bar 10%)")
    if nms < 1 or len(int8) != 2 or min(int8) < 1 or stem < 1:
        raise AssertionError("a kernel was not launched through the tools")
    if any(serve[c]["errors"] or serve[c]["requests"] != 16 for c in (1, 8)):
        raise AssertionError(f"bench_serve: {serve}")
    if abs(mem_rel) > 0.10:
        raise AssertionError("mem_report's peak is not within 10% of phase 7's")
    return {"launches": {"nms_fp": nms, "int8_matmul": sum(int8), "stem_fused": stem},
            "mem_report_vs_phase7": mem_rel,
            "records": {tool: [_compact(r) for r in recs] for tool, recs in records.items()}}


def trainer_from_flags(argv, override=None):
    """An ``ILTrainer`` on the card from ``cli.train``'s flags, built as
    ``cli.train.main`` builds it (no training); ``override`` maps the
    flags' config to the one the trainer gets (fields without a flag)."""
    import argparse

    from cl_object_detection_tpu_torch import resolve_device
    from cl_object_detection_tpu_torch.cli.common import (add_train_flags, args_to_config,
                                                           resolve_dataset_paths)
    from cl_object_detection_tpu_torch.train.trainer import ILTrainer

    parser = argparse.ArgumentParser()
    add_train_flags(parser)
    a = parser.parse_args(argv)
    cfg = args_to_config(a)
    return ILTrainer(override(cfg) if override else cfg, *resolve_dataset_paths(a, "train"),
                     workdir=a.root_dir, device=resolve_device(None))


def check_stem_at_trainer_frames(tr, batches) -> float:
    """The stem kernel on the inputs the trainer's model gives it, for one
    landscape and one portrait batch of the trainer's loader, against the
    plain version: within 2 bf16 ulps, as ``check_stem``. Returns the
    largest |difference|."""
    import torch

    from cl_object_detection_tpu_torch.ops import stem_fused as sf

    stem = tr.model.backbone.conv1
    seen = {}

    def grab(module, args, kwargs):
        seen.update(x=args[0], scale=kwargs["bn_scale"], bias=kwargs["bn_bias"])

    err = 0.0
    for kind, pick in (("landscape", lambda hw: hw[0] < hw[1]),
                       ("portrait", lambda hw: hw[0] > hw[1])):
        batch = next(b for b in batches if pick(b.images.shape[1:3]))
        hook = stem.register_forward_pre_hook(grab, with_kwargs=True)
        try:
            with torch.no_grad():
                tr.model.backbone(torch.from_numpy(batch.images).to(stem.weight.device))
        finally:
            hook.remove()
        with torch.no_grad():
            # the packed kernel and bias as StemConv.forward makes them
            k3 = sf.pack_stem_kernel((stem.weight.permute(2, 3, 1, 0) * seen["scale"])
                                     .to(stem.dtype))
            b4 = seen["bias"].repeat(4)
            got = sf.stem_fused(seen["x"], k3, b4)
            ref = sf.stem_fused_reference(seen["x"], k3, b4)
        torch.cuda.synchronize()
        diff = (got.float() - ref.float()).abs()
        bad = int((diff > 2 * bf16_ulp(ref.float().abs() + b4.abs().max())).sum())
        err = max(err, float(diff.max()))
        log(f"stem at the trainer's {kind} frames {tuple(seen['x'].shape)} "
            f"{seen['x'].dtype}: max_abs_err {float(diff.max()):.6g}, values beyond "
            f"2 bf16 ulps: {bad} of {diff.numel()}")
        if bad or not torch.isfinite(got.float()).all():
            raise AssertionError(f"stem kernel disagrees with the plain version at the "
                                 f"trainer's {kind} frames")
    return err


def trainer_step_and_loader_split(tr) -> tuple:
    """In the trainer's own process: ms per micro-step of ``run_batch``
    alone (pin, copy and step) on one epoch of batches assembled
    beforehand; the trainer's loader alone over that epoch (its threads,
    no step beside it) and the same loader on one thread, per batch; per
    image, ``load_image`` (PNG decode, to float) against the rest of the
    loader's example (flip, resize and pad, uint8 rounding, 4x4
    space-to-depth); the stem at the trainer's frames; and
    ``png_decode_times``."""
    import dataclasses

    import numpy as np
    import torch

    from cl_object_detection_tpu_torch.data.loader import BatchLoader

    loader = tr.train_loader
    loader.set_epoch(3)
    t0 = time.perf_counter()
    batches = list(loader)
    threads_ms = (time.perf_counter() - t0) / len(batches) * 1e3
    threads_assemble_ms = float(np.mean(loader.batch_seconds)) * 1e3
    stem_err = check_stem_at_trainer_frames(tr, batches)
    tr.run_batch(batches[0], sync_metrics=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in batches:
        m = tr.run_batch(b, sync_metrics=False)
    float(m["total_loss"])
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / len(batches) * 1e3

    one = BatchLoader(tr.dataset_train, dataclasses.replace(tr.cfg.data, num_workers=0,
                                                            prefetch=0),
                      shuffle=True, augment=True, seed=tr.cfg.seed)
    one.set_epoch(3)
    t0 = time.perf_counter()
    n = sum(1 for _ in one)
    one_ms = (time.perf_counter() - t0) / n * 1e3
    ds = tr.dataset_train
    rng = np.random.RandomState(0)
    load_ms = example_ms = 0.0
    for i in range(8):
        t0 = time.perf_counter()
        ds.load_image(i)
        t1 = time.perf_counter()
        one._make_example(i, rng)
        t2 = time.perf_counter()
        load_ms += (t1 - t0) * 1e3 / 8
        example_ms += (t2 - t1) * 1e3 / 8
    stages = dict(load_image=load_ms, rest_of_example=example_ms - load_ms)
    log(f"trainer split: run_batch alone on assembled batches (pin, copy, step) "
        f"{step_ms:.1f} ms per micro-step at 640x1024, {8e3 / step_ms:.2f} images/s; the "
        f"loader alone, {tr.cfg.data.num_workers} threads: {threads_ms:.1f} ms per batch "
        f"({threads_assemble_ms:.1f} ms to assemble one); one thread: {one_ms:.1f} ms per "
        f"batch; per image on one thread: load_image (PNG decode, to float) {load_ms:.2f} "
        f"ms, the rest of the example (flip, resize and pad, uint8 rounding, "
        f"space-to-depth) {example_ms - load_ms:.2f} ms")

    decode = png_decode_times(f"{ds.image_dir}/{ds.coco.imgs[ds.image_ids[0]]['file_name']}")
    return step_ms, dict(stages, loader_threads_ms_per_batch=threads_ms,
                         loader_one_thread_ms_per_batch=one_ms, stem_max_abs_err=stem_err,
                         decode_ms=decode)


def png_decode_times(path: str) -> dict:
    """ms per ``decode_image`` call at a toy image's size: the port's own
    PNG (filter type 0); OpenCV's PNG of the toy image (OpenCV filters
    every row with Sub by default); PIL's PNG of a smooth image (PIL picks
    each row's filter, Paeth included, which goes to a library)."""
    import io
    import zlib

    import numpy as np

    from cl_object_detection_tpu_torch.data import image_io

    img = image_io.read_image(path)
    h, w = img.shape[:2]
    yy, xx = np.mgrid[0:h, 0:w]
    smooth = np.stack([xx * 255 // w, yy * 255 // h, (xx + yy) * 127 // (h + w)],
                      -1).astype(np.uint8)
    blobs = [("the port's own PNG of the toy image", image_io.encode_png(img), img)]
    try:
        import cv2
    except ImportError:
        log("png decode: no OpenCV on this machine")
    else:
        ok, enc = cv2.imencode(".png", np.ascontiguousarray(img[:, :, ::-1]))
        blobs.append(("OpenCV's PNG of the toy image", enc.tobytes(), img))
    try:
        from PIL import Image
    except ImportError:
        log("png decode: no PIL on this machine")
    else:
        buf = io.BytesIO()
        Image.fromarray(smooth).save(buf, format="PNG")
        blobs.append(("PIL's PNG of a smooth image", buf.getvalue(), smooth))
    out = {}
    for name, blob, want in blobs:
        rows = np.frombuffer(zlib.decompress(b"".join(
            body for kind, body in image_io._chunks(blob) if kind == b"IDAT")), np.uint8)
        filters = np.bincount(rows.reshape(h, -1)[:, 0], minlength=5).tolist()
        t0 = time.perf_counter()
        for _ in range(10):
            got = image_io.decode_image(blob)
        out[name] = (time.perf_counter() - t0) * 1e2
        if not np.array_equal(got, want):
            raise AssertionError(f"decode_image of {name} differs from the image")
        log(f"png decode at {h}x{w}: {name}, rows by filter type 0-4 {filters}: "
            f"{out[name]:.2f} ms per decode_image")
    return out


# kernel-name fragments -> the part of the predict or train path they belong to
_KERNEL_GROUPS = (
    ("stem_fused", ("stem_fused",)),
    ("nms_fp", ("nms_mask_kernel", "nms_scan_kernel")),
    ("int8 kernel, conv mode", ("int8_matmul_kernel<64, true>", "int8_matmul_kernel<128, true>",
                                "int8_matmul_kernel<256, true>")),
    ("int8 kernel, GEMM mode", ("int8_matmul",)),
    ("foreach (Adam, clip scale, accumulate)", ("multi_tensor",)),
    ("convolution", ("conv", "xmma", "cudnn", "gemm", "cutlass", "implicit", "dgrad", "wgrad")),
    ("sort / top-k", ("sort", "radix", "topk", "scan")),
    ("im2col concatenation", ("catarray",)),
    ("reductions (max |x|)", ("reduce",)),
)


def profile_run(run, out_dir: str, table_name: str, what: str) -> None:
    """Profile two calls of ``run`` (one ``what`` each) with
    torch.profiler: device time by kernel group and the device's idle
    share over the window; the full table goes to
    ``out_dir/table_name``."""
    import os

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(2):
            run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in events)
    if busy_us <= 0:
        raise AssertionError("the profiler recorded no device time")
    groups: dict = {}
    for e in events:
        name = e.key.lower()
        group = next((g for g, keys in _KERNEL_GROUPS
                      if any(k in name for k in keys)), "elementwise / other")
        groups[group] = groups.get(group, 0.0) + e.self_device_time_total
    log(f"profile {table_name}, 2 x {what}: device busy {busy_us / 2e3:.3f} ms per call, "
        f"idle share {1 - busy_us / wall_us:.3f} of {wall_us / 2e3:.3f} ms wall (profiler on)")
    for group, us in sorted(groups.items(), key=lambda kv: -kv[1]):
        log(f"  {group}: {us / 2e3:.3f} ms per call ({us / busy_us:.3f} of device time)")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, table_name), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_device_time_total",
                                          row_limit=60, max_name_column_width=90))


def main() -> int:
    import argparse

    t_start = time.perf_counter()
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--profile", metavar="DIR", default=None,
                        help="also profile the float and the int8 B=32 "
                             "predicts, the train step and the trainer's second "
                             "epoch, and write their tables under DIR")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from cl_object_detection_tpu_torch import _build

    smi = smi_line()
    log(f"card: {smi}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    _build.build_all()
    log(f"build: {time.perf_counter() - t0:.2f} s wall ("
        + ", ".join(f"{k} {v:.2f} s" for k, v in _build.build_seconds.items()) + ")")
    for name, text in _build.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")
    results: dict = {}
    check_stem(results)
    check_nms(results)
    check_int8_matmul(results)
    check_int8_conv(results)
    overhead = operator_overhead()
    ctx = main_path(results, args.profile)
    quantized_path(results, ctx, args.profile)
    ips = {"float": ctx["ips"], "int8": ctx["int8_ips"]}
    f32_path(results, ctx)
    train = train_path(ctx, args.profile)
    del ctx
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_trainer_")
    try:
        trainer = trainer_path(train["images_per_s"], tmp, args.profile)
        torch.cuda.empty_cache()
        evaluation = eval_path(tmp)
        torch.cuda.empty_cache()
        il_state1 = il_state1_path(tmp, trainer["step_only_ms_640x1024"])
        torch.cuda.empty_cache()
        il_replay = il_replay_path(tmp, il_state1["state1_step_ms"])
        torch.cuda.empty_cache()
        il_battery = il_battery_path(tmp, il_state1["state1_step_ms"])
        torch.cuda.empty_cache()
        export = export_path(tmp)
        torch.cuda.empty_cache()
        data_axis, reference = data_axis_path(tmp)
        torch.cuda.empty_cache()
        model_axis = model_axis_path(tmp, reference, data_axis)
        del reference
        torch.cuda.empty_cache()
        tools = tools_path(tmp, train, 32 / ips["float"] * 1e3)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    kernels = []
    for r in results.values():
        kernels.append({k: r[k] for k in (
            "name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")})
    log(smi)
    log(json.dumps({"train": train}))
    log(json.dumps({"trainer": trainer}))
    log(json.dumps({"eval": evaluation}))
    log(json.dumps({"il_state1": il_state1}))
    log(json.dumps({"il_replay": il_replay}))
    log(json.dumps({"il_battery": il_battery}))
    log(json.dumps({"export": export, "operator_overhead_us": overhead}))
    log(json.dumps({"data_axis": data_axis}))
    log(json.dumps({"model_axis": model_axis}))
    log(json.dumps({"tools": tools}))
    log(f"predict B=32 images/s: float {ips['float']:.2f}, int8 {ips['int8']:.2f} (before the "
        f"kernels became torch.library operators: 464.67 and 225.81 on an H100 80GB HBM3 at "
        f"700 W); the operators add {overhead['int8_matmul']['added_us']:.1f} us of host time "
        f"per int8 launch (100 per R50 predict)")
    log(json.dumps({"kernels": kernels}))
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
