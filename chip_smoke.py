#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (diffsvc_tpu_torch) on one
NVIDIA GPU.

    python3 chip_smoke.py [--out results.json]

(``--deterministic-step BUNDLE`` is phase 5's child process,
``--dist-job JOB BUNDLE`` a rank of phase 10 or 12 and ``--vocoder-resume
BUNDLE`` phase 11's child, below.)

Phases, in order; any failure exits non-zero and no result line is printed:

1. The card: ``nvidia-smi`` name and power limit; CUDA is required (there
   is no CPU fallback); TF32 is turned off for cuDNN and matmuls, so every
   f32 product PyTorch computes (the plain versions, cuDNN's convolutions)
   is true f32.  The port's own f32 K1, K2 (the denoiser's residual
   layers and its input, skip and output projections inside the ladder),
   K3 (the vocoder tail), K4's f32 stream, K5 (the training stack) and K6
   (the single residual layer) are no longer pure f32: they multiply on
   the tensor cores as 3xTF32 split products, good to ~2^-21 relative, and
   are held against those true-f32 plain versions at their f32 limits.
2. Build the hand-written kernels from ``diffsvc_tpu_torch/csrc`` (timed).
3. Kernel vs plain PyTorch version on the card, at the main path's shapes
   (T=1024, C=384, L=20, M=128, H=256; the vocoder tail at the openvpi
   geometry on 5 s of 44.1 kHz audio; K4 at the training shape B=24; K5 at
   B=32, a per-sample shape; K6, one layer, at B=1 and dilations 1-8; K2
   and K3 again at B=4, the batched serving routes' B; K1 and K2 at
   config_24k's widths, C=256 and M=80, and K3 at its HiFi-GAN V1 on 5 s of
   24 kHz audio), in f32 and bf16 for
   K1/K2/K4/K6 and f32 for K3/K5: relative-L2 and max-abs error (K4/K5: of
   the forward and each of the seven grads), both times (CUDA events, in
   turns) and the bound (the larger of the FLOPs over the operand type's
   peak and the bytes over the memory rate).  K5's batch must equal the
   in-order sum of its B=1 runs bit for bit, and is printed against K4 at
   the f32 stream.  Each tolerance must also be exceeded by the same kernel
   fed inputs that stand for a known bug (a planted fault: K1's last
   conditioner dropped; K2's skip-projection bias dropped, or its history
   not pushed; at f32, K1's, K2's and K3's weights split with their lo
   planes zeroed, so the a_hi b_lo products drop out of the 3xTF32 sums;
   K3's last NSF injection dropped; K4's and K5's last sample's cotangent
   dropped, K4's layer or K5's sample with the next one's saved x, and at
   f32 their weights split with zero lo planes; K6's taps read at 2d, and
   at f32 its weights split with zero lo planes), so a check that cannot
   see a wrong kernel fails (K1 keeps its packed weights per weight tensor
   and version, so its lo-planes fault runs on copies of the weights; its
   repeated calls must pack nothing, and a first call, which packs, is
   timed beside them).  Beside K1 bf16, cuBLAS's time for the same
   products alone (``torch.matmul``, the gate and output GEMM of each
   layer, no gather and no epilogue) as a diagnostic floor, which the port
   never calls; for K1 and K2 in both dtypes, their device time by kernel
   and their tensor-core plan's CTAs per layer launch; for K3, its device
   time by kernel (one template instance per stage), its launches per tail,
   the tail with every ResBlock1 pair as two conv launches (the path fuses
   the pairs of the narrow stages), and per stage the launch plans (CTAs,
   shared memory) and one k=11 conv against one true-f32 ``F.conv1d`` of
   the same shape (the library call); for K4 and K5, their device time by
   kernel; for K6, its device time by kernel (which must show its
   tensor-core kernels and no SIMT layer kernel), and its weight pack's
   time apart, beside a first call, which packs.  The f32 tensor-core rows'
   bound is the tensor cores' at 3xTF32 (495 TFLOP/s over three passes);
   the CUDA cores' f32 bound is printed beside it.
4. The slice: reference-format checkpoints with random weights from a seed
   at the full ``configs/config_44k.yaml`` widths (diffusion ckpt, HuBERT-
   soft .pt 768x12, NSF-HiFiGAN generator + config.json) in a temporary
   directory; the port's ``Svc`` + ``run_clip`` convert three voiced clips
   of 6.5-14 s with silences, once with ``diff_compute_dtype: bfloat16`` and
   once in f32.  Every kernel's launch counter is reset before and read
   after that run and must be nonzero; K1's and K2's bf16 tensor-core
   counters (``launches_tc``) must move on the bf16 conversions and stay 0
   on the f32 ones, and their 3xTF32 counters (``launches_tf32x3``) the
   reverse;
   outputs must have the input's length, be finite and non-silent; a short
   clip converted on the card must agree with the same conversion on the
   CPU (the plain path), in f32 and in bf16, and the card's conversion with
   a planted fault must not.  Where the time goes: ``torch.profiler`` over
   one ``run_clip`` of the 14 s clip per dtype (wall, device busy share,
   the top kernels); the bf16 one must run K1's tensor-core kernels and no
   SIMT layer kernel instantiated for bf16 operands, the f32 one K1's
   3xTF32 kernels and no SIMT layer kernel at all, and both K3's
   tensor-core conv kernels and no SIMT ``conv1d_kernel``; the conversions
   of each dtype must move K3's counter.  Each clip's host time is printed
   by the innermost of the program's spans (``utils/trace.py``).
5. The training path at the same widths (``diffnet_train_stream_dtype``
   bf16, ``max_sentences`` 24): 32 synthetic clips of 4-12 s binarized by
   the port's binarizer (HuBERT-soft on the card), then ``run.py``'s
   ``run_task`` for 6 steps with validation and a checkpoint every 3 (K4's
   counter reset before and read after: it must be nonzero; the losses
   finite, the first in 0.5-2.0); a restart from the step-3 checkpoint must
   restore params and optimizer state bit for bit and train on to step 6;
   one step run twice from the same state, batch, t and noise under
   ``torch.use_deterministic_algorithms`` must give identical params (in a
   child process: only it sets the ``CUBLAS_WORKSPACE_CONFIG`` that cuBLAS
   needs for that mode, so phases 3-6 time cuBLAS as it is set up by
   default); one
   step through the kernels must agree with the same step through the plain
   versions on the card, and a planted fault must not; ms per step,
   samples/s and mel frames/s for both stream dtypes, with the route each
   takes (the f32 stream's batch of 24 exceeds K4's carry: K5); a profile
   of one step, which must run K4 on the tensor cores (the bf16 kernels of
   its forward and backward) and none of the SIMT training kernels; and
   the step-6 checkpoint converts a clip through ``Svc``.
6. Training at config_44k's own batching (``max_sentences`` 88,
   ``max_tokens`` 128000, bf16 stream): 96 clips of 4-8 s binarized by the
   port (8 held out for validation), ``run_task`` for 3 steps; every batch
   is printed with B, T and its route, and the batch of 88 must take the
   per-sample route: K5's counter (reset before, read after) must equal the
   steps, K4's backward must not move, validation (B=1) runs K1; ms/step,
   samples/s, mel frames/s and peak memory at B=88; a profile of one step,
   which must run K5 on the 3xTF32 tensor-core kernels and none of the
   SIMT training kernels; one step through the kernels against the plain
   versions on the card, with a planted fault.
7. Serving on phase 4's project and its 14 s clip (``[serve]`` lines):
   ``run_clip(fused=True)`` in bf16 and f32, where each length bucket is
   captured once as a CUDA graph and a replay must equal the same body run
   eagerly on the card bit for bit; a 0.5 s fused conversion on the card
   against the same one on the CPU at phase 4's limits (and the skip-bias
   fault above them); a profile of one fused chunk, in which no
   device-to-host copy may start before its last kernel; per route
   (modular ``Svc.infer``, fused eager, fused graph, batched
   ``--batch_chunks``) the wall, RTF, device busy share and graph memory;
   a 17 s clip whose three voiced chunks the collate pads to one length,
   where the batched route must run K2 and K3 once per conversion at B=3,
   and ``FusedSvc.batched`` at B=3 against each chunk's B=1 call on the
   same padding and noise (1e-4 at f32); the
   server (``diffsvc_tpu_torch.flask_api``) in this process on 127.0.0.1:
   three fused and three streamed requests answered 200 with the posted
   duration, a malformed one 400.  K2's and K3's counters, reset before
   each of these, must move in each.
8. The rest of conversion (``[rest]`` lines; every counter reset before
   each route and read after it):
   (a) DDPM (``acc=1``, 1000 steps) on phase 4's project: a 2.5 s voiced
   clip (one fused bucket) through ``run_clip``, modular and fused graph, in bf16 and f32 (the
   output's length, finite, non-silent; K1's counter a whole number of
   1000-step trajectories, at least one per chunk, and K2's 0), the fused
   route again warm; the sampler alone timed and profiled over a 100-step
   use_gt_mel trajectory (ms, launches and device ms per step), a fused
   chunk's replay timed and profiled (ms and device events per
   step), the acc=1 bucket's warm-up, capture and pool; a 0.5 s conversion
   card vs CPU with ``use_gt_mel`` at 35 steps and the
   per-step noise shared, at phase 4's limits, the skip-bias fault above
   them, in each dtype.
   (b) CREPE (random weights in torchcrepe's ``full.pth`` layout): the 14 s
   clip through ``get_pitch`` on the card (tracker ``crepe``), the network
   and the Viterbi timed apart; its posteriors card vs CPU on a block of
   64 frames (rel-L2 <= 1e-4, both true f32) and the share of frames
   whose decoded f0 agrees; the binarizer on config_44k as shipped
   (``use_crepe: true``) on 6 clips, every item tracked by CREPE with
   weights and by the AC tracker without.
   (c) A config_24k project at full width (DiffNet 256 x 20, 80 mel,
   HuBERT-soft 768 x 12, pe, HiFi-GAN V1 512 / rates 8, 8, 2, ContentVec
   768 x 12): the 6.5 s clip at 24 kHz through the modular and batched
   routes (with pe) and the fused graph, bf16 and f32, K2 and K3 moving on
   each; wall, RTF and busy share per route; card vs CPU at phase 4's
   limits with the fault; pe's time and its card-vs-CPU agreement
   (1e-4); ContentVec's encode beside HuBERT-soft's and one conversion
   through it.
9. The rest of single-card training and the data inventory (``[train2]``
   lines; K1-K5's counters reset before each part and read after it, K6's
   rise read over it; each part's counts go into the kernels line), on
   phase 5's binarized data and checkpoint:
   (a) ``optimizer: radam`` through ``run_task`` for 7 steps at phase 5's
   batching (K4 must move, and K1 once per validation batch, validation's
   loss; K2, K3, K5 and K6 not; steps 6 and 7 take RAdam's rectified
   branch): finite losses; the port's update on the card against
   optax's update written out on the card over steps 1-7 (rel-L2 <= 1e-6;
   the rectification dropped must read above it); a restart from step 3
   restoring params and RAdam's state bit for bit; ms per step.
   (b) The pe task at config_24k's pe width (hidden 256, 2 conv layers, 80
   mel): 16 clips binarized at 24 kHz, ``run_task`` with the pe
   ``task_cls`` (finite losses; no kernel launched), one step on the card
   and on the CPU, each against the same step in float64 on the CPU: the
   card's loss, and the loss and each parameter's grad of pe's smooth
   twin (ReLU as softplus, see ``PE_STEP_TOL``), rel-L2 <= 1e-4, the
   card's step under PyTorch's default ``cudnn.allow_tf32``; the
   convolutions left at TF32 must read above it; the ReLU model's grads
   printed, card and CPU; the step's time; the trained checkpoint as a
   config_24k ``Svc``'s ``pe_ckpt`` (``svc.pe`` set, its weights equal)
   converting the 14 s clip with ``use_pe`` (K2 and K3 moving).
   (c) ``--infer`` on phase 5's step-6 checkpoint: a ``[P]`` wav, png (where
   matplotlib is installed) and npy per test item, each wav finite and
   non-silent, each mel inside
   [mel_vmin, mel_vmax]; K2's counter equal to the test items and K3's to
   the wavs rendered, K4, K5 and K6 not moving; seconds per item.
   (d) The binarizer on phase 5's 32 clips (AC tracker) with
   ``binarize_batch_size`` 8 and 1 (no kernel launched): items/s of
   each; per item the batched
   result against the per-item one at JAX's own test tolerances (mel
   rtol 1e-5 / atol 1e-6, f0 rtol 1e-4 / atol 1e-3, mel2ph and len equal,
   units of equal shape; the units' rel-L2 printed, not gated); the f0
   cache on the per-item path: a first run with ``f0_cache_dir`` tracks
   and writes every item, a second one tracks none.

10. Several ranks, sharded serving, FS2-full and the FFT denoiser
   (``[multi]`` and ``[fs2]`` lines; each rank is a process of its own,
   ``chip_smoke.py --dist-job JOB BUNDLE`` with torchrun's environment, and
   reports its own K1-K6 counts), on phase 6's data and phase 4's project,
   (a) started beside (b) and (c), three processes on the card at once (so
   their ms per step are read side by side): (a) nccl at world 1: three steps at B=24 (K4) under a process group
   against the same steps with none, params and optimizer state bit for
   bit; (b) two gloo ranks sharing this card (nccl takes one card per
   rank): three steps at 24 per rank (K4; the third on a ragged batch of
   47 padded to 48) and two at config_44k's 88 per rank (K5), each step's
   all-reduced grads against the sum of the two blocks' grads computed in
   rank 0 alone with the same draws and the global count (``DIST_TOL``;
   the loss against that sum, ``DIST_LOSS_TOL``), the planted fault (each
   block normalized by its own count) above it, the two ranks' params bit
   for bit, each rank's K4 / K5 counter moving; ms per step, samples/s
   and each rank's peak memory; (c) rank 0 alone writes a checkpoint
   before the third K4 step, both ranks restore through a ``Trainer`` (rank
   1's work_dir empty: ``broadcast_state``), and the third step again
   equals the uninterrupted one bit for bit; (d)
   ``FusedSvc.batched_sharded`` on phase 7's 17 s clip (three chunks) over
   two replicas on this card: padded to 4, three results, each within
   ``BATCHED_TOL`` of ``batched``'s on the same draws, K2 and K3 moving on
   both replicas, its wall beside ``batched``'s; (e) FS2-full
   (``no_fs2: false``) and (f) the FFT denoiser (``diff_decoder_type:
   fft``) at config_44k: the 6.5 s clip through the modular route and the
   fused graph in bf16 and f32 (the FFT denoiser in f32; RTF, busy share;
   K2 and K3 moving; the FFT denoiser's K1, K2, K4 and K5 at 0 and K3
   moving; the encoder, or the
   denoiser, run inside the captured graph), a 0.5 s conversion card vs
   CPU at phase 4's limits with the encoder's (the denoiser's) last layer
   dropped as the planted fault, and one train step at B=24 with dropout
   0.1 (FS2-full on K4; the FFT denoiser on no kernel) whose encoder
   (denoiser) grads are finite and not zero.

11. The other vocoders and GAN vocoder training (``[voc]`` lines; every
   counter reset before each route or run and read after it):
   (a) the iSTFT head at config_44k's geometry (dim 512, 8 layers, n_fft
   2048, hop 512, the f0 embedding; its weights written by the port's
   ``save_params``): phase 4's 6.5 s clip through ``Svc.infer`` and the
   fused graph in bf16 and f32 diffusion, and once with
   ``voc_compute_dtype: bfloat16`` (K2 moving, K3 at 0; RTF, busy share),
   phase 7's 17 s clip through ``FusedSvc.batched`` (B=3) and
   ``batched_sharded`` over two replicas on the card (within
   ``BATCHED_TOL``), the head alone card vs CPU in f32 (``VOC_TOL``) and
   with its bf16 backbone (``VOC_TOL_BF16``), its final LayerNorm dropped
   above both, and ``Svc.infer_batched`` refused; (b) PWG at config_24k's
   geometry (30 layers, 3 stacks, 64 / 128 / 64 channels, scales 4, 4, 4,
   2, aux window 2) from an official-layout directory (weight-norm keys,
   ``stats.npy``) with ``loud_norm: true``: the 6.5 s clip at 24 kHz through
   the modular route and ``--batch_chunks`` (K2 moving, K3 at 0),
   ``spec2wav`` card vs CPU on one mel and seed (its last residual layer
   dropped above the limit), ``wav2spec`` with loud_norm card vs CPU, a
   fused route refused; (c) MelGAN's generator at its defaults (causal and
   not), its multi-scale discriminator, a PQMF round trip and the
   cyclic-noise source, each card vs CPU; (d) ``run_task`` with a vocoder
   ``task_cls`` for the hifigan (openvpi NSF-HiFiGAN width, MPD + MSD),
   istft (512 x 8) and pwg families on phase 5's 32 clips binarized with
   their waveforms: 2 steps of B=8 crops of 32 frames each (finite losses,
   ms per step, peak memory, K1-K6 at 0), a resume from the step-1
   checkpoint equal to the uninterrupted step 2 bit for bit (in a child
   process per family, ``chip_smoke.py --vocoder-resume BUNDLE``, under
   deterministic algorithms with ``CUBLAS_WORKSPACE_CONFIG`` set, started
   before (a) and run beside (a)-(d), whose times are read beside them),
   and one hifigan step
   card vs CPU at B=2 (losses, D and G grads; the card's updated params
   against the first AdamW update on its own grads), G's grads against the
   old D as the planted fault, and G's grads at the init with every leaky
   ReLU smooth (``GAN_TWIN_TOL``), TF32 on the card as the planted fault; the task's AdamW on the card over 20 steps
   of fixed grads against optax's update written out, torch's default
   weight decay as the planted fault.

12. The mesh's seq axis (``[seq]`` lines), on phase 6's data at config_44k's
   full width with the f32 train stream, on a (data = 2, seq = 2) grid:
   (a) in one process, a batch of B=4 clips of T=4096 frames (47.6 s):
   the unsharded step against the sum of the four cells' shares (each its
   rows and its own frames widened by the halo H = 75 on each side), loss
   and every gradient with one set of draws (``DIST_TOL`` per tensor,
   ``DIST_LOSS_TOL`` on the loss), both on K4 at the f32 stream; each
   run's ms and peak memory; the planted faults above the limits: the
   halo frames counted in the loss, and a halo of H - 1 at one dilation
   cycle (4 layers, H = 15; at 20 layers its reading is printed: it is
   below f32's resolution there); K4 moving on every window and K5, K6 at
   0; (b) four gloo ranks sharing this card at (2, 2) (``chip_smoke.py
   --dist-job seq BUNDLE``): two steps on (a)'s batch, the second with 3
   real rows of 4, each step's all-reduced grads and loss against rank
   0's one-process share sum (``DIST_TOL``, ``DIST_LOSS_TOL``), the four
   ranks' params bit for bit, each rank's K4 moving and K5 at 0, ms per
   step and peak memory per rank; (c) ``run_task`` on the same ranks with
   ``mesh_axes: data,seq``, ``mesh_shape: [2, 2]`` for 2 steps at 8 per
   data block (finite losses; the first batch's items those of a
   data-only d = 2 run on every rank), then one FS2-full step with
   dropout 0.1 whose encoder output is bit-equal on the two seq ranks of
   each data block.

13. The ONNX export (``[onnx]`` lines) of phase 4's project at full width:
   the encoder, denoise, pred and after graphs, the DPM-Solver++ step graph
   at ``config_44k_fast.yaml``'s sampler settings and the NSF-HiFiGAN graph,
   each traced on the CPU at 10 frames (bytes per graph printed, export
   seconds for the four split graphs' one call, dpmpp and hifigan),
   run by the port's numpy runtime at 160 frames (the vocoder at 24) and
   held against the card: (a) the denoise graph against ``diffnet.apply``
   (K1 at f32) on the same noise, step and condition (K1's f32 limit,
   1e-5); (b) encoder -> denoise -> pred -> after at acc=100 (11
   evaluations) and the dpmpp chain against ``GaussianDiffusion.infer``'s
   f32 K2 ladder from the same x_T, on the part of the ln-mel that the
   denoiser put there (the run minus the same run with eps = 0, as K2's
   check; K2's limit, 1e-4); (c) the hifigan graph against
   ``generator.apply_serving`` (K3) on the same mel, f0, rand_ini and noise
   (K3's limit, 1e-4).  The planted faults must read above the limits: a
   pred graph with time and time_prev swapped, a denoise graph exported
   with one layer's conditioner projection zeroed, a hifigan graph that
   ignores its noise input.  K1, K2 and K3 must move (``launches_onnx``).

14. The compiled programs (``[pt2]`` lines) of phase 4's project at full
   width, exported on the card by ``infer/export.py`` at t_mel 1024, t_ph
   512, acc 20: encoder, denoiser, sampler and vocoder at bf16 (the
   serving dtype), the denoiser and sampler at f32, and ``export_fused``
   at the bucket of the 6.5 s clip (bf16); each saved, reloaded and run on
   seeded inputs against its in-process route on the same weights and
   draws (the denoiser against ``diffnet.apply``, the sampler against
   ``GaussianDiffusion.infer``'s K2 ladder, the vocoder against
   ``generator.apply_serving``, the fused program against ``FusedSvc``
   run eagerly): equal bits, or the kernel's own limit; the bf16 set
   reloaded again in a child process that imports the op library alone
   (its ``sys.modules`` checked, its results equal, its counters moving).
   Over one call of each program the counters must read K1 2 + 3 J (J the
   ladder's evaluations), K2 3, K3 2; each saved graph must call its
   kernel ops (``diffsvc_tpu_torch::*``), with their weights read by no
   other node and fewer products than one plain stack, ladder evaluation
   or tail would add.  Planted faults: a denoiser exported with one layer's
   conditioner projection zeroed, a sampler exported at speedup 50, the
   fused program fed its draws shifted by one frame.  Export seconds and
   bytes per program, and each program's run time beside its route's, are
   printed with the card's name and power limit.
15. The learned-score evidence (``[learn]`` lines): ``tools/train_demo``
   at production width (16 synthetic clips binarized, B=8 on K4's batched
   route, the openvpi NSF-HiFiGAN vocoding each validation sample) for 100
   steps and a fresh ``Trainer`` resuming to 150, then
   ``tools/sampler_quality``'s grid (12 rows and two fine-grid references,
   403 and 501 evaluations, from one x_T, K2 each) over its checkpoint at f32 and at
   bf16.  Gates, each with a planted fault that must fail it: the resume
   restored step 100 and trained 50 steps (a Trainer that finds no
   checkpoint starts at 0); the validation loss fell (the initial weights'
   loss as the last reading); every row finite and of the batch's shape (a
   NaN in x_T); every clipped DPM-Solver++ row inside [-8, 3] (dpmpp100
   with its clamp dropped); dpmpp100_clip through K2 against its plain
   version on the same weights and x_T, on the denoiser's part of the mel,
   at phase 4's limits (K2 with its history not pushed); K4 one backward a
   step and K5 none, K2 14 launches a grid (the row through the plain
   version: K2 0).
16. The vocoder's learned quality and the train-stream A/B
   (``[voclearn]`` lines), at full width and reduced depth
   (``VOCLEARN_STEPS``, ``STREAM_STEPS``): ``tools/train_istft`` (the iSTFT
   head 512 x 8 on 8 synthetic 2 s clips at B=8 x 32 frames; no kernel
   runs the head: K1-K5 at 0) with its checkpoint read back through the
   ``IstftVocoder`` wrapper; ``tools/ab_vocoder`` (NSF-HiFiGAN at the
   openvpi widths and the iSTFT head on the same clips, seeds and crops;
   the NSF renders through K3, one tail each); the trained NSF
   generator's render of the held-out clip (B=1, 173 frames) through K3
   against its plain ``apply`` at K3's f32 limit; ``tools/ab_train_stream``
   at B=24 x T=1024, C=384, L=20: the bf16 leg on K4 at the bf16 stream,
   the f32 leg on K5, the scan leg (``diffnet_pallas_train: off``) on K4
   at the f32 stream, one backward a step each on its counter
   (``diffnet_stack_train.bwd_launches_f32`` tells K4's streams apart),
   and the JAX tool's two asserts.  Gates, each with a planted fault that
   must fail it: the held-out mel-L1 fell for the head and both A/B
   families (the untrained generator's render as "after"); the reload
   exact (a wrapper without the checkpoint); K3 vs plain (its last NSF
   injection dropped); the legs' launches (the scan leg on the route rule
   before the repair: K4 at the bf16 stream); the A/B's asserts (the bf16
   leg with K4's backward dropped, Queue 3 #1's fault).  The scan leg on
   the old route leaves the gap at 0 (it is the bf16 leg's computation):
   printed, not a fault of that gate.
17. The one-command drive and the mel-MCD metric (``[drive]`` lines):
   ``python -m diffsvc_tpu_torch.tools.verify_drive --full`` as a child
   process on the card, started before phase 16 and running beside it
   (its seconds are read beside phase 16's) (config_44k's widths:
   binarize, 4 training steps,
   ``infer_cli`` on a 1.6 s song with a silence at ``--key 2 --acc 20``,
   and the warm start: two fresh processes against one fresh kernel build
   root); its summary read: K4 or K5 launched by the training, K2 and K3 by
   the conversion, K6 by nothing, the output as long as the song, the
   first process built the library and the second reused it (the first
   process read as the second, the planted fault of the reuse gate).  The
   song is converted again with the drive's trained checkpoint on the CPU
   from the card's draws (``card_draws``), and ``python -m
   diffsvc_tpu_torch.tools.compare_mel`` reads card against CPU: mel-MCD
   below 0.5 dB, ``BASELINE.md``'s limit, exit 0; the CPU side converted
   at key 0 (the planted fault) must read above it.
18. The device-time and serving-soak tools (``[decompose]`` lines), in
   this process on ``utils/devtime``'s timers: ``tools/mfu_decompose`` at
   production width (T=896, K1, one evaluation, the step-by-step PLMS loop
   and K2 in bf16 and f32, two rounds), ``tools/train_decompose`` at B=24 x
   1024 (one round of its eleven legs, K1, K4, K5 and the two steps),
   ``tools/bench_pipe_stages`` once, ``tools/bench_realtime`` (prod, 5 runs
   per buffer length) and ``tools/soak_serving`` (10 s per leg over the HTTP
   server).  Gates, each with a planted fault that must fail it: every
   share of the peak in (0, 100%] (K1 timed through a window whose end is
   recorded before its launches); the train parity, the bf16 stream's
   grads against the scan's, below 2e-2 (the last sample's cotangent
   dropped at the bf16 stream); the soak's 0 errors and 0 programs built
   after warm-up (a warm-up to 0.2 s for a mix of 0.2 and 0.5 s buffers);
   K1-K5 moving over the phase.

The line before the last is the card's ``nvidia-smi`` name and power limit,
preceded by one JSON line describing every kernel (K1-K6: its launches on
the path that runs it, on each serving route, on each of phase 8's routes,
in each of phase 9's parts, phase 10's, phase 11's, phase 12's, phase 13's,
phase 14's, phase 15's, phase 16's, phase 17's and phase 18's, errors,
times, bound);
the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
if os.path.isdir(os.path.join(ROOT, "diffsvc_tpu_torch")):
    # the timers, peaks, bounds and FLOP counts live in the port, beside the
    # tools that read them (alone, main() refuses before it needs them)
    sys.path.insert(0, ROOT)
    from diffsvc_tpu_torch.utils.devtime import (  # noqa: E402,F401
        PEAK_BYTES, PEAK_FLOPS, bound, cuda_time_ms, device_events,
        kernel_breakdown, nbytes, profile_run, stack_flops, tc_bound,
        time_in_turns)

# Relative-L2 tolerances and why.  Each sits between the sound reading on the
# H100 and the reading of the planted faults (both printed each run).
TOL = {
    # one K1 call, 20 layers: 3xTF32 products (each good to ~2^-21) summed
    # in another order than the plain version's true-f32 ones
    ("residual_stack", "f32"): 1e-5,
    # bf16 operands: kernel and plain round the same values to bf16, but a
    # different f32 sum can flip a rounding of x/h, which then propagates
    ("residual_stack", "bf16"): 1e-2,
    # the ladder is compared on the part of the final state that the
    # denoiser put there: x_final minus the same ladder run with eps = 0
    # (the plain version with W_out, b_out zeroed).  The sampler update is
    # linear in the evaluations' eps, so this is their weighted error; on
    # x_final itself eps is ~4% of the state and a fault hides behind the
    # noise term.  51 evaluations x 20 layers, f32 state in both; at f32
    # the kernels' products are 3xTF32.
    ("plms_ladder", "f32"): 1e-4,
    ("plms_ladder", "bf16"): 1e-2,
    # ~60 f32 convolutions of the tail
    ("vocoder_tail", "f32"): 1e-4,
    # K4 forward + backward at B=24, T=1024, C=384, L=20: the largest rel-L2
    # over the skip sum and the seven grads.  f32: 3xTF32 products (each
    # good to ~2^-21) summed in another order than the plain version's
    # true-f32 ones (sound 1.2e-6 on the H100).  bf16 streams: kernel and
    # plain round y, h, do and dz at the same points, but another f32 sum
    # can flip a rounding (sound 3.1e-3).  The planted faults read 0.21 (the
    # last sample's cotangent dropped) and 0.10 (one layer's saved x taken
    # from the next layer) in both dtypes; at f32 the weights' lo planes
    # zeroed must read above the limit too.
    ("residual_stack_train_batched", "f32"): 1e-5,
    ("residual_stack_train_batched", "bf16"): 1e-2,
    # K5 (K4's forward at the f32 stream, the per-sample backward) at B=32,
    # T=1024, C=384, L=20, a per-sample shape in JAX: the largest rel-L2 over
    # the skip sum and the seven grads; 3xTF32 products against the plain
    # per-sample loop's true-f32 ones, summed in another order (sound 8.2e-7
    # on the H100; the planted faults read 0.18, the last sample's cotangent
    # dropped, and 0.16, one sample's saved x taken from the next sample;
    # the weights' lo planes zeroed must read above the limit too).
    ("residual_stack_train", "f32"): 1e-5,
    # K6, one layer at B=1, T=1024, C=384, dilations 1, 2, 4, 8: the largest
    # rel-L2 over x' and skip.  f32: one layer's 3xTF32 products against the
    # plain version's true-f32 ones (sound 5.2e-7 on the H100); bf16: the
    # same roundings, a few flipped by the tensor cores' f32 sums (sound
    # 1.9e-4).  The taps read at 2d read 0.68 in both dtypes; at f32 the
    # weights' lo planes zeroed read 3.1e-4.
    ("fused_residual_block", "f32"): 1e-5,
    ("fused_residual_block", "bf16"): 1e-3,
}
# f32 conversion of a short clip, card vs CPU: relative L2 of the waveform's
# part that the denoiser put there (see cpu_agreement).  The planted fault
# is the card's denoiser with its skip-projection bias dropped.
SLICE_TOL = 1e-2
# The same at diff_compute_dtype bfloat16: card and CPU round the same
# values to bf16, but their f32 sums differ in order, so a few roundings
# of x and h flip and propagate through 51 evaluations x 20 layers (the
# kernel checks' bf16 limit is 1e-2 on one call); the vocoder stays f32.
SLICE_TOL_BF16 = 2e-2
KERNELS = {
    "residual_stack": ("diffsvc_tpu_torch/csrc/diffnet_stack.cu",
                       "diffsvc_tpu/ops/pallas/diffnet_stack.py:129"),
    "plms_ladder": ("diffsvc_tpu_torch/csrc/plms_ladder.cu",
                    "diffsvc_tpu/ops/pallas/plms_ladder.py:196"),
    "vocoder_tail": ("diffsvc_tpu_torch/csrc/vocoder_tail.cu",
                     "diffsvc_tpu/ops/pallas/vocoder_tail.py:348"),
    # backward _call_bwd_batched; its forward is _call_fwd (:338)
    "residual_stack_train_batched": (
        "diffsvc_tpu_torch/csrc/diffnet_stack_train.cu",
        "diffsvc_tpu/ops/pallas/diffnet_stack.py:606"),
    # backward _call_bwd, vmapped; its forward is K4's (_call_fwd)
    "residual_stack_train": (
        "diffsvc_tpu_torch/csrc/diffnet_stack_per_sample.cu",
        "diffsvc_tpu/ops/pallas/diffnet_stack.py:378"),
    # on no path of the JAX package: launched by phase 3 alone
    "fused_residual_block": ("diffsvc_tpu_torch/csrc/diffnet_block.cu",
                             "diffsvc_tpu/ops/pallas/diffnet_block.py:93"),
}
# main-path shapes at config_44k: frames, residual channels, layers, mel
# bins, conditioner width
T, C, L, M, H = 1024, 384, 20, 128, 256
# (residual channels, mel bins) of each profile: config_44k's, and
# config_24k's (DiffNet 256 x 20, 80 mel; the same frames and layers)
GEOS = {"44k": (C, M), "24k": (256, 80)}
# openvpi 44.1 kHz NSF-HiFiGAN geometry
VOC_H = dict(num_mels=128, upsample_initial_channel=512,
             upsample_rates=[8, 8, 2, 2, 2],
             upsample_kernel_sizes=[16, 16, 4, 4, 4], resblock="1",
             resblock_kernel_sizes=[3, 7, 11],
             resblock_dilation_sizes=[[1, 3, 5]] * 3, sampling_rate=44100,
             n_fft=2048, win_size=2048, hop_size=512, fmin=40, fmax=16000)
TAIL_FRAMES = 431           # 5.0 s of 44.1 kHz audio
# config_24k's HiFi-GAN V1 (0109_hifigan_bigpopcs_hop128's geometry): 512
# initial channels, rates 8, 8, 2 (= hop 128), K3 from its 128-channel stage
VOC24_H = dict(num_mels=80, upsample_initial_channel=512,
               upsample_rates=[8, 8, 2], upsample_kernel_sizes=[16, 16, 4],
               resblock="1", resblock_kernel_sizes=[3, 7, 11],
               resblock_dilation_sizes=[[1, 3, 5]] * 3, sampling_rate=24000,
               n_fft=512, win_size=512, hop_size=128, fmin=30, fmax=12000)
TAIL_FRAMES_24K = 938       # 5.0 s of 24 kHz audio at hop 128
TRAIN_B = 24                # the training batch (max_sentences) of K4's check
PS_B = 32                   # K5's check: per-sample in JAX at T=1024 (f32)
DILATIONS = (1, 2, 4, 8)    # K6's check
# (seconds, f0 Hz, silent spans) of the slice's clips
CLIPS = [(6.5, 196.0, [(2.0, 2.6)]),
         (9.0, 262.0, [(5.5, 6.4)]),
         (14.0, 330.0, [(6.0, 7.0), (12.3, 12.6)])]
ACC = 20
SERVE_B = 4      # phase 3's K2 and K3 at the batched serving routes' B


class SmokeError(RuntimeError):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def rel_l2(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _dtype(name):
    import torch

    return torch.bfloat16 if name == "bf16" else torch.float32


@contextlib.contextmanager
def lo_planes_dropped():
    """K1's and K2's f32 weights split with zero lo planes (a planted
    fault: the a_hi b_lo products drop out of the 3xTF32 sums)."""
    from diffsvc_tpu_torch.ops.hopper import diffnet_stack as ds

    split = ds.split_tf32

    def hi_only(a):
        hi, lo = split(a)
        return hi, lo.zero_()

    with swapped(ds, split_tf32=hi_only):
        yield


def plan_ctas(dtype_name: str, m: int = 0, c: int = C) -> dict:
    """K1's (or K2's, m > 0) tensor-core plan at B=1 for the collate's
    frame counts: CTAs and shared memory per layer launch, and for K2 the
    CTAs of its projections."""
    from diffsvc_tpu_torch.ops.hopper import diffnet_stack as ds

    out = {}
    for t in (512, 768, 1024):
        p = ds.tc_plan(1, t, c, m, _dtype(dtype_name))
        out[t] = {"ctas_layer": p.ctas_layer, "smem_layer": p.smem_layer}
        if m:
            out[t]["ctas_in"] = p.grid_m * p.grid_n_in
            out[t]["ctas_epi"] = p.grid_m * (
                1 if dtype_name == "bf16" else p.mp // p.bn)
    return out


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_residual_stack(device, dtype_name, geo="44k"):
    """K1 at B=1, T=1024, L=20 and ``geo``'s channels.  Its packed weights
    are kept per weight tensor and version: the times are repeated calls
    (which must pack nothing), beside a first call, which packs; the f32
    fault "lo planes zeroed" reaches the kernel through copies of the
    weights (the originals' packs are kept)."""
    from diffsvc_tpu_torch.ops.hopper import diffnet_stack as ds
    from diffsvc_tpu_torch.utils.synth import stack_inputs

    c = GEOS[geo][0]
    a = stack_inputs(_dtype(dtype_name), device, 1, T, c, L)
    kern = lambda: ds.residual_stack(**a, cycle=4)              # noqa: E731
    plain = lambda: ds.residual_stack_plain(**a, cycle=4)       # noqa: E731
    got, ref = kern(), plain()
    cp = a["cond_proj"].clone()
    cp[-1] = 0
    faults = {"cond dropped": dict(a, cond_proj=cp),
              "sb shifted by one layer": dict(a, sb=a["sb"].roll(1, 0))}
    fault_rel = {k: rel_l2(ds.residual_stack(**f, cycle=4), ref)
                 for k, f in faults.items()}
    if dtype_name == "f32":
        copies = dict(a, wd=a["wd"].clone(), wo=a["wo"].clone())
        with lo_planes_dropped():
            fault_rel["lo products dropped"] = rel_l2(
                ds.residual_stack(**copies, cycle=4), ref)
        del copies
    packs = ds.packs
    ms, plain_ms = time_in_turns(kern, plain, reps=10)
    if ds.packs != packs:
        raise SmokeError(f"residual_stack {dtype_name} {geo}: repeated calls "
                         f"packed the weights {ds.packs - packs} times")

    def first_call():
        ds._packed.clear()
        kern()

    res = {"max_abs_err": float((got - ref).abs().max()),
           "rel_l2": rel_l2(got, ref), "fault_rel_l2": fault_rel,
           "ms": ms, "plain_ms": plain_ms,
           "first_call_ms": cuda_time_ms(first_call, reps=5),
           **tc_bound(stack_flops(T, L, 16, c), nbytes(*a.values(), got),
                      dtype_name)}
    res["breakdown"] = kernel_breakdown(kern, reps=5)
    res["plan"] = plan_ctas(dtype_name, c=c)
    if dtype_name == "bf16" and geo == "44k":
        res["cublas_products_ms"] = cublas_products_ms(a)
    return res


def cublas_products_ms(a) -> float:
    """cuBLAS's time for K1's products alone at bf16 (``torch.matmul``:
    per layer the gate GEMM [T, 3C] x [3C, 2C] and the output GEMM [T, C] x
    [C, 2C]; no tap gather, no epilogue): a diagnostic floor for products of
    this size, not a computation of K1's function."""
    import torch

    y3 = torch.randn(T, 3 * C, device=a["x0"].device).to(torch.bfloat16)
    h = y3[:, :C].contiguous()
    wd = a["wd"].reshape(L, 3 * C, 2 * C)

    def run():
        for layer in range(L):
            torch.matmul(y3, wd[layer])
            torch.matmul(h, a["wo"][layer])

    return cuda_time_ms(run, reps=10)


def ladder_inputs(dtype, device, batch: int = 1, c: int = C, m: int = M):
    """A DiffNet at ``c`` residual channels and ``m`` mel bins (the main
    path's by default) with torch's default init drawn from seed 0 (the
    reference, and DiffNet's own init, zero the output projection, which
    would make eps == 0 and the comparison vacuous) and the K=1000 PLMS
    acc=20 tables: J = 51 evaluations; ``batch`` clips."""
    import numpy as np
    import torch

    from diffsvc_tpu_torch.models import diffnet
    from diffsvc_tpu_torch.models.diffusion import make_tables
    from diffsvc_tpu_torch.ops.hopper import plms_ladder as pl
    from diffsvc_tpu_torch.utils.synth import randomize

    net = diffnet.DiffNet(m, H, L, c, 4)
    randomize(net, 0)
    net = net.to(device)
    p = net.stacked(dtype)
    ac = make_tables(1000, "linear", 0.02)["alphas_cumprod"]
    t_eval, scal = pl.plms_eval_tables(ac, 1000, ACC)
    step = diffnet.step_embedding(p, torch.from_numpy(t_eval).to(device), c)
    sb = diffnet.step_bias(p, step, dtype).transpose(0, 1).contiguous()
    g = torch.Generator().manual_seed(1)
    cond = (torch.randn(batch, T, H, generator=g) * 0.5).to(device)
    cp = diffnet.prepare_cond(net, cond).to(dtype).contiguous()
    x = torch.randn(batch, T, m, generator=g).to(device)
    return dict(x_init=x, scal=torch.from_numpy(np.ascontiguousarray(scal)).to(device),
                sb_tab=sb, cond_proj=cp, win=p["win"], bin_=p["bin"],
                wskip=p["wskip"], bskip=p["bskip"], wout=p["wout"],
                bout=p["bout"], wd=p["wd"], bd=p["bd"], wo=p["wo"],
                bo=p["bo"])


def check_plms_ladder(device, dtype_name, batch: int = 1, geo="44k"):
    import torch

    from diffsvc_tpu_torch.ops.hopper import plms_ladder as pl

    c, m = GEOS[geo]
    a = ladder_inputs(_dtype(dtype_name), device, batch, c, m)
    kern = lambda: pl.plms_ladder(**a, cycle=4)                 # noqa: E731
    plain = lambda: pl.plms_ladder_plain(**a, cycle=4)          # noqa: E731
    got, ref = kern(), plain()
    base = pl.plms_ladder_plain(**dict(a, wout=torch.zeros_like(a["wout"]),
                                       bout=torch.zeros_like(a["bout"])),
                                cycle=4)
    no_push = a["scal"].clone()
    no_push[:, pl.NS - 1] = 0
    faults = {"bskip dropped": dict(a, bskip=torch.zeros_like(a["bskip"])),
              "history not pushed": dict(a, scal=no_push)}
    fault_rel = {k: rel_l2(pl.plms_ladder(**f, cycle=4) - base, ref - base)
                 for k, f in faults.items()}
    if dtype_name == "f32":
        with lo_planes_dropped():
            fault_rel["lo products dropped"] = rel_l2(kern() - base,
                                                      ref - base)
    ms, plain_ms = time_in_turns(kern, plain, reps=1)
    extra = {} if batch > 1 else {
        "breakdown": kernel_breakdown(kern, reps=1),
        "plan": plan_ctas(dtype_name, m, c)}
    return {**extra, "batch": batch,
            "max_abs_err": float((got - ref).abs().max()),
            "rel_l2": rel_l2(got - base, ref - base),
            "final_x_rel_l2": rel_l2(got, ref),
            "eps_share": rel_l2(ref, base), "fault_rel_l2": fault_rel,
            "evals": int(a["scal"].shape[0]), "ms": ms, "plain_ms": plain_ms,
            **tc_bound(int(a["scal"].shape[0]) * batch * (
                stack_flops(T, L, 16, c) + 2.0 * T * (2 * m * c + c * c)),
                       nbytes(*a.values(), got), dtype_name)}


def check_vocoder_tail(device, dtype_name, batch: int = 1, geo="44k"):
    """The generator tail's inputs at the openvpi geometry on 5 s of 44.1
    kHz audio, or (``geo`` "24k") config_24k's HiFi-GAN V1 on 5 s of 24 kHz
    audio (``batch`` clips); the prologue and the NSF noise convs run in
    plain torch."""
    import math

    import torch

    from diffsvc_tpu_torch.ops.hopper import vocoder_tail as vt
    from diffsvc_tpu_torch.vocoders import generator as gen_mod

    voc_h, frames = (VOC_H, TAIL_FRAMES) if geo == "44k" \
        else (VOC24_H, TAIL_FRAMES_24K)
    torch.manual_seed(0)
    cfg = gen_mod.HifiGanConfig.from_dict(voc_h, use_nsf=True)
    gen = gen_mod.Generator(cfg).to(device).eval()
    g = torch.Generator().manual_seed(1)
    mel = (torch.randn(batch, frames, cfg.num_mels, generator=g) - 4.0
           ).to(device)
    f0 = (220.0 * 1.25 ** torch.arange(batch, dtype=torch.float32)[:, None]
          ).expand(batch, frames).contiguous().to(device)
    length = frames * int(math.prod(cfg.upsample_rates))
    randoms = gen_mod.draw_randoms(batch, length, cfg.harmonic_num, g)
    randoms = tuple(r.to(device) for r in randoms)
    s0 = gen_mod.tail_start_stage(cfg)
    with torch.no_grad():
        har = gen_mod.harmonic_source(gen, f0, randoms)
        x = gen_mod.tail_prologue(gen, mel, har, s0)
        injs = [gen.noise_convs[i](har).transpose(1, 2).contiguous()
                for i in range(s0 + 1, len(cfg.upsample_rates))]
        plan = gen.tail_plan(s0)
        kern = lambda: vt.tail(x, injs, plan)                   # noqa: E731
        plain = lambda: vt.tail_plain(x, injs, plan)            # noqa: E731
        # the same kernels with every ResBlock1 pair as two conv launches
        unfused = lambda: vt._run(plan, x, injs, vt._conv_kernel,  # noqa
                                  vt._convt_kernel)
        got, ref = kern(), plain()
        fault_rel = {
            "injection dropped": rel_l2(vt.tail(
                x, injs[:-1] + [torch.zeros_like(injs[-1])], plan), ref),
            "lo products dropped": rel_l2(vt.tail(
                x, injs, tail_lo_planes_dropped(plan)), ref)}
        ms, plain_ms = time_in_turns(kern, plain, reps=5)
        flops = tail_flops(vt, x, injs, plan)
        extra = {}
        if batch == 1:
            unfused_ms, fused_ms = time_in_turns(unfused, kern, reps=5)
            breakdown = kernel_breakdown(kern, reps=3)
            extra = {"breakdown": breakdown,
                     "pairs": {"unfused_ms": unfused_ms, "fused_ms": fused_ms,
                               "unfused_rel_l2": rel_l2(unfused(), ref),
                               "unfused_breakdown": kernel_breakdown(
                                   unfused, reps=3)},
                     "stages": tail_stages(vt, plan, x.shape, device),
                     "tail_launches": sum(n for _, n in breakdown.values())}
    weights = [t for cp in [plan.post] + [c for st in plan.stages for br in
                                          st.branches for c in br]
               for t in (cp.w_t, cp.b)]
    weights += [t for st in plan.stages if st.convt is not None
                for t in (st.convt.w_t, st.convt.b)]
    return {**extra, "batch": batch,
            "max_abs_err": float((got - ref).abs().max()),
            "rel_l2": rel_l2(got, ref), "fault_rel_l2": fault_rel,
            "samples": int(got.shape[1]), "ms": ms, "plain_ms": plain_ms,
            **tc_bound(flops, nbytes(x, *injs, *weights, got), dtype_name)}


def tail_lo_planes_dropped(plan):
    """K3's plan with every packed weight's lo plane zeroed (a planted
    fault: the a_hi b_lo products drop out of the 3xTF32 sums)."""
    def hi_only(cp):
        wp = cp.wp.clone()
        wp.select(-3, 1).zero_()
        return cp._replace(wp=wp)

    return plan._replace(
        post=hi_only(plan.post),
        stages=tuple(st._replace(
            convt=None if st.convt is None else hi_only(st.convt),
            branches=tuple(tuple(hi_only(cp) for cp in br)
                           for br in st.branches)) for st in plan.stages))


def tail_flops(vt, x, injs, plan) -> float:
    """The tail's convolution FLOPs, counted while its plain version walks
    the plan: 2 Cin Cout k per output sample of a conv, per input sample of
    a transposed conv."""
    total = [0.0]

    def conv(xx, cp, *args, **kw):
        cout, cin, k = cp.w_t.shape
        total[0] += 2.0 * xx.shape[0] * xx.shape[1] * cin * cout * k
        return vt._conv_plain(xx, cp, *args, **kw)

    def convt(xx, tp, *args, **kw):
        cin, cout, k = tp.w_t.shape
        total[0] += 2.0 * xx.shape[0] * xx.shape[1] * cin * cout * k
        return vt._convt_plain(xx, tp, *args, **kw)

    vt._run(plan, x, injs, conv, convt)
    return total[0]


def tail_stages(vt, plan, x_shape, device) -> list:
    """Per stage of the tail: the launch plans (CTAs, shared memory, N tile,
    rows per CTA) of its ConvT and convs, and one k=11 resblock conv
    (dilation 1) timed as K3 launches it against one true-f32 ``F.conv1d``
    of the same shape on the pre-activated input (the library call; the
    port never makes it), with that conv's bound at 3xTF32."""
    import torch
    import torch.nn.functional as F

    out = []
    _, t, c = x_shape
    g = torch.Generator().manual_seed(2)
    for i, st in enumerate(plan.stages):
        rec = {"stage": plan.s0 + i}
        if st.convt is not None:
            p = vt.convt_tile_plan((1, t, c), st.convt)
            rec["convt_plan"] = [p.ctas, p.smem, p.bn, p.bm]
            cin, c, k = st.convt.w_t.shape
            t = (t - 1) * st.convt.stride - 2 * st.convt.pad + k
        convs = [cp for br in st.branches for cp in br]
        rec.update(channels=c, rows=t, conv_plans=sorted(
            {(p.ctas, p.smem, p.bn, p.bm) for p in (
                vt.conv_tile_plan((1, t, c), cp) for cp in convs)}))
        if st.kind == "1":   # (k, d, CTAs, shared memory), or unfused
            rec["pair_plans"] = [
                (k, d) + ((pp.ctas, pp.smem) if pp else ("two launches",))
                for k, d, pp in sorted({(cp.w_t.shape[-1], cp.dilation,
                                         vt.pair_plan(1, t, c,
                                                      cp.w_t.shape[-1],
                                                      cp.dilation))
                                        for cp in convs[::2]})]
        cp = next(cp for cp in convs if cp.w_t.shape[-1] == 11
                  and cp.dilation == 1)
        x = torch.randn(1, t, c, generator=g).to(device)
        xc = F.leaky_relu(x, 0.1).transpose(1, 2).contiguous()
        kern = lambda: vt._conv_kernel(x, cp, 0.1)              # noqa: E731
        lib = lambda: F.conv1d(xc, cp.w_t, cp.b,                # noqa: E731
                               padding=cp.pad, dilation=cp.dilation)
        rec["k11_ms"], rec["k11_library_ms"] = time_in_turns(kern, lib, 20)
        rec["k11_rel_l2"] = rel_l2(kern(), lib().transpose(1, 2))
        rec["k11_bound_ms"] = bound(2.0 * t * c * c * 11, nbytes(
            x, cp.w_t, cp.b) + 4 * t * c, "tf32x3")["bound_ms"]
        out.append(rec)
    return out


def train_stack_inputs(device, dtype_name):
    """K4's operands at the training shape: f32 state and biases, cond /
    wd / wo in the stream dtype, and a skip cotangent in it."""
    import torch

    from diffsvc_tpu_torch.utils.synth import stack_inputs

    sd = _dtype(dtype_name)
    a = stack_inputs(torch.float32, device, TRAIN_B, T, C, L)
    for k in ("cond_proj", "wd", "wo"):
        a[k] = a[k].to(sd).contiguous()
    g = torch.Generator().manual_seed(5)
    dout = torch.randn(TRAIN_B, T, C, generator=g).to(device, sd)
    return a, dout


GRAD_NAMES = ("skip", "dx0", "dsb", "dcp", "dwd", "dbd", "dwo", "dbo")


def per_output(got, ref) -> dict:
    return {n: {"rel_l2": rel_l2(x, y), "max_abs_err": float((x - y).abs()
                                                             .max())}
            for n, x, y in zip(GRAD_NAMES, got, ref)}


def check_residual_stack_train_batched(device, dtype_name):
    """K4's forward with save and backward against their plain versions."""
    from diffsvc_tpu_torch.ops.hopper import diffnet_stack_train as k4

    a, dout = train_stack_inputs(device, dtype_name)
    ops = (a["sb"], a["cond_proj"], a["wd"], a["bd"], a["wo"])

    def kern(dout=dout, swap=None):
        skip, xsave = k4.residual_stack_train_fwd(**a, cycle=4)
        if swap is not None:
            xsave[swap] = xsave[swap + 1]
        return (skip, *k4.residual_stack_train_batched_bwd(xsave, *ops, dout,
                                                            cycle=4))

    def plain():
        skip, xsave = k4.residual_stack_train_fwd_plain(**a, cycle=4)
        return (skip, *k4.residual_stack_train_batched_bwd_plain(
            xsave, *ops, dout, cycle=4))

    got, ref = kern(), plain()
    per = per_output(got, ref)
    dropped = dout.clone()
    dropped[-1] = 0
    faults = {"last sample's cotangent dropped": kern(dout=dropped),
              f"layer {L // 2}'s saved x taken from layer {L // 2 + 1}":
              kern(swap=L // 2)}
    fault_rel = {k: max(rel_l2(x, y) for x, y in zip(f[1:], ref[1:]))
                 for k, f in faults.items()}
    del faults
    if dtype_name == "f32":
        fault_rel["lo products dropped"] = lo_fault_rel(kern, ref)
    ms, plain_ms = time_in_turns(kern, plain, reps=1)
    return {"max_abs_err": max(v["max_abs_err"] for v in per.values()),
            "rel_l2": max(v["rel_l2"] for v in per.values()),
            "per_output": per, "fault_rel_l2": fault_rel, "batch": TRAIN_B,
            "ms": ms, "plain_ms": plain_ms,
            "breakdown": kernel_breakdown(kern, reps=1),
            **tc_bound(stack_flops(TRAIN_B * T, L, 60),
                       nbytes(*a.values(), dout, *got), dtype_name)}


def lo_fault_rel(kern, ref) -> float:
    """The largest rel-L2 over the skip sum and the seven grads of the
    training kernels run with their f32 weights split with zero lo planes
    (a planted fault: the a_hi b_lo products of every weight product drop
    out of the 3xTF32 sums)."""
    with lo_planes_dropped():
        got = kern()
    return max(rel_l2(x, y) for x, y in zip(got, ref))


def check_residual_stack_train(device, dtype_name):
    """K5: K4's forward with save at the f32 stream and the per-sample
    backward against their plain versions at B=32, a batch JAX routes
    per-sample; the batch against the in-order sum of its B=1 runs (bit for
    bit); and K5 against K4 at the f32 stream on the same inputs."""
    import torch

    from diffsvc_tpu_torch.models.diffnet import train_route
    from diffsvc_tpu_torch.ops.hopper import diffnet_stack_per_sample as k5
    from diffsvc_tpu_torch.ops.hopper import diffnet_stack_train as k4
    from diffsvc_tpu_torch.utils.synth import stack_inputs

    route = train_route(L, 4, T, C, PS_B, dtype_name)
    if route != "per_sample":
        raise SmokeError(f"K5's check shape routes to {route}")
    a = stack_inputs(torch.float32, device, PS_B, T, C, L)
    g = torch.Generator().manual_seed(6)
    dout = torch.randn(PS_B, T, C, generator=g).to(device)
    ops = (a["sb"], a["cond_proj"], a["wd"], a["bd"], a["wo"])

    def kern(dout=dout, mix=None):
        skip, xsave = k4.residual_stack_train_fwd(**a, cycle=4)
        if mix is not None:
            xsave[:, mix] = xsave[:, mix + 1]
        return (skip, *k5.residual_stack_train_bwd(xsave, *ops, dout,
                                                   cycle=4))

    def plain():
        skip, xsave = k4.residual_stack_train_fwd_plain(**a, cycle=4)
        return (skip, *k5.residual_stack_train_bwd_plain(xsave, *ops, dout,
                                                         cycle=4))

    got, ref = kern(), plain()
    per = per_output(got, ref)
    dropped = dout.clone()
    dropped[-1] = 0
    mix = PS_B // 2
    faults = {"last sample's cotangent dropped": kern(dout=dropped),
              f"sample {mix}'s saved x taken from sample {mix + 1}":
              kern(mix=mix)}
    fault_rel = {k: max(rel_l2(x, y) for x, y in zip(f[1:], ref[1:]))
                 for k, f in faults.items()}
    del faults
    fault_rel["lo products dropped"] = lo_fault_rel(kern, ref)
    # the batch against its B=1 runs, and against K4 at the f32 stream
    _, xsave = k4.residual_stack_train_fwd(**a, cycle=4)
    full = got[1:]
    exact = True
    sums = [torch.zeros_like(x) for x in full[3:]]
    for i in range(PS_B):
        one = k5.residual_stack_train_bwd(
            xsave[:, i:i + 1].contiguous(), a["sb"][:, i:i + 1],
            a["cond_proj"][:, i:i + 1].contiguous(), a["wd"], a["bd"],
            a["wo"], dout[i:i + 1], cycle=4)
        exact = exact and torch.equal(full[0][i:i + 1], one[0]) \
            and torch.equal(full[1][:, i:i + 1], one[1]) \
            and torch.equal(full[2][:, i:i + 1], one[2])
        sums = [s + x for s, x in zip(sums, one[3:])]
    exact = exact and all(torch.equal(x, s) for x, s in zip(full[3:], sums))
    vs_k4 = per_output(got, (got[0], *k4.residual_stack_train_batched_bwd(
        xsave, *ops, dout, cycle=4)))
    ms, plain_ms = time_in_turns(kern, plain, reps=1)
    return {"max_abs_err": max(v["max_abs_err"] for v in per.values()),
            "rel_l2": max(v["rel_l2"] for v in per.values()),
            "per_output": per, "fault_rel_l2": fault_rel, "batch": PS_B,
            "route": route, "batch_is_sum_of_b1": bool(exact),
            "vs_k4_f32": {k: v["rel_l2"] for k, v in vs_k4.items()},
            "ms": ms, "plain_ms": plain_ms,
            "breakdown": kernel_breakdown(kern, reps=1),
            **tc_bound(stack_flops(PS_B * T, L, 60),
                       nbytes(*a.values(), dout, *got), dtype_name)}


# K6's kernels in its profile: y = x + step, the gate and the output
# projection on the tensor cores, by dtype; and the SIMT layer kernels it ran
# before (gate_kernel<T>, block_out_kernel), which no profile may show
K6_KERNELS = {"bf16": ("tc::y0_kernel", "tc::gate_tc_kernel",
                       "k6::block_out_tc_kernel"),
              "f32": ("tf32x3::y0_kernel", "tf32x3::gate_kernel",
                      "tf32x3::out_kernel")}
SIMT_LAYER = re.compile(r"\b(gate|out)_kernel<|\bblock_out_kernel\b")


def check_fused_residual_block(device, dtype_name):
    """K6 at B=1, T=1024, C=384 for each dilation of a cycle against its
    plain version.  Planted faults: the taps read at 2d and, at f32, the
    weights split with zero lo planes (for copies of the weights: K6 keeps
    its packed weights per weight tensor).  Times are per call (the four
    dilations' total over four) with the packed weights kept; beside them
    the pack alone and a first call, which packs.  Its device time by
    kernel must show its tensor-core kernels and no SIMT layer kernel."""
    from diffsvc_tpu_torch.ops.hopper import diffnet_block as k6
    from diffsvc_tpu_torch.ops.hopper import diffnet_stack as ds
    from diffsvc_tpu_torch.utils.synth import stack_inputs

    a = stack_inputs(_dtype(dtype_name), device, 1, T, C, 1)
    args = (a["x0"], a["sb"][0].contiguous(), a["cond_proj"][0], a["wd"][0],
            a["bd"][0], a["wo"][0], a["bo"][0])
    n = len(DILATIONS)

    def run(fn, stretch=1, ops=args):
        return [fn(*ops, dilation=stretch * d) for d in DILATIONS]

    kern = lambda: run(k6.fused_residual_block)                 # noqa: E731
    plain = lambda: run(k6.fused_residual_block_plain)          # noqa: E731
    got, ref = kern(), plain()

    def fault(outs):
        return min(max(rel_l2(x, y) for x, y in zip(f, r))
                   for f, r in zip(outs, ref))

    fault_rel = {"taps read at 2d": fault(run(k6.fused_residual_block, 2))}
    if dtype_name == "f32":
        copies = tuple(w.clone() if i in (3, 5) else w
                       for i, w in enumerate(args))
        with lo_planes_dropped():
            fault_rel["lo products dropped"] = fault(
                run(k6.fused_residual_block, ops=copies))
        del copies
    pairs = [(x, y) for g, r in zip(got, ref) for x, y in zip(g, r)]
    ms, plain_ms = time_in_turns(kern, plain, reps=10)
    cp = ds.tc_plan(1, T, C, dtype=_dtype(dtype_name)).cp

    def first_call():
        k6._packed.clear()
        k6.fused_residual_block(*args, dilation=1)

    pack_ms = cuda_time_ms(lambda: k6.pack_weights(args[3], args[5], cp),
                           reps=10)
    first_ms = cuda_time_ms(first_call, reps=10)
    breakdown = {k: [v[0] / n, v[1] / n]
                 for k, v in kernel_breakdown(kern, reps=5).items()}
    simt = [k for k in breakdown if SIMT_LAYER.search(k)]
    missing = [k for k in K6_KERNELS[dtype_name]
               if not any(k in name for name in breakdown)]
    if simt or missing:
        raise SmokeError(f"fused_residual_block {dtype_name}: its profile "
                         f"lacks {missing} or runs SIMT kernels {simt}: "
                         f"{sorted(breakdown)}")
    return {"max_abs_err": max(float((x - y).abs().max()) for x, y in pairs),
            "rel_l2": max(rel_l2(x, y) for x, y in pairs),
            "fault_rel_l2": fault_rel, "ms": ms / n, "plain_ms": plain_ms / n,
            "pack_ms": pack_ms, "first_call_ms": first_ms,
            "breakdown": breakdown,
            **tc_bound(stack_flops(T, 1, 16), nbytes(*args, *got[0]),
                       dtype_name)}


# (kernel, dtype, check[, keyword arguments of a variant: "batch", the
# batched serving routes' B (phase 7); "geo", config_24k's widths (phase 8)])
CHECKS = [("residual_stack", "f32", check_residual_stack),
          ("residual_stack", "bf16", check_residual_stack),
          ("residual_stack", "f32", check_residual_stack, {"geo": "24k"}),
          ("residual_stack", "bf16", check_residual_stack, {"geo": "24k"}),
          ("plms_ladder", "f32", check_plms_ladder),
          ("plms_ladder", "bf16", check_plms_ladder),
          ("plms_ladder", "f32", check_plms_ladder, {"batch": SERVE_B}),
          ("plms_ladder", "bf16", check_plms_ladder, {"batch": SERVE_B}),
          ("plms_ladder", "f32", check_plms_ladder, {"geo": "24k"}),
          ("plms_ladder", "bf16", check_plms_ladder, {"geo": "24k"}),
          ("vocoder_tail", "f32", check_vocoder_tail),
          ("vocoder_tail", "f32", check_vocoder_tail, {"batch": SERVE_B}),
          ("vocoder_tail", "f32", check_vocoder_tail, {"geo": "24k"}),
          ("residual_stack_train_batched", "f32",
           check_residual_stack_train_batched),
          ("residual_stack_train_batched", "bf16",
           check_residual_stack_train_batched),
          ("residual_stack_train", "f32", check_residual_stack_train),
          ("fused_residual_block", "f32", check_fused_residual_block),
          ("fused_residual_block", "bf16", check_fused_residual_block)]


def phase_kernels(device):
    out = {}
    for name, dt, fn, *variant in CHECKS:
        kw = variant[0] if variant else {}
        res = fn(device, dt, **kw)
        tol = TOL[(name, dt)]
        res["tol_rel_l2"] = tol
        faults = " ".join(f"[{k}: {v:.3e}]"
                          for k, v in res["fault_rel_l2"].items())
        # recorded as e.g. "f32 B=4", "bf16 24k"
        dt = " ".join([dt] + [f"B={v}" if k == "batch" else str(v)
                              for k, v in kw.items()])
        log(f"[kernel] {name} {dt}: rel_l2={res['rel_l2']:.3e} (tol {tol:g}) "
            f"max_abs={res['max_abs_err']:.3e} kernel_ms={res['ms']:.3f} "
            f"plain_ms={res['plain_ms']:.3f} bound_ms={res['bound_ms']:.4f} "
            f"({res['bound_by']}); planted faults {faults}")
        if "cublas_products_ms" in res:
            log(f"[kernel] {name} {dt}: cuBLAS alone on the same products "
                f"(torch.matmul, gate + output GEMM x {L} layers, no gather, "
                f"no epilogue; diagnostic floor, not library_ms): "
                f"{res['cublas_products_ms']:.3f} ms")
        if "cuda_core_bound_ms" in res:
            log(f"[kernel] {name} {dt}: bound {res['bound_ms']:.4f} ms at "
                f"3xTF32 on the tensor cores; {res['cuda_core_bound_ms']:.4f}"
                " ms at the CUDA cores' f32 rate")
        if name == "residual_stack":
            log(f"[kernel] {name} {dt}: packed weights kept per weight "
                f"tensor and version: a repeated call {res['ms']:.4f} ms "
                "(no pack); a first call, which packs, "
                f"{res['first_call_ms']:.4f} ms")
        if "pack_ms" in res:
            log(f"[kernel] {name} {dt}: packed weights kept per weight "
                f"tensor: a call {res['ms']:.4f} ms; a first call, which "
                f"packs, {res['first_call_ms']:.4f} ms; the pack alone "
                f"{res['pack_ms']:.4f} ms")
        if "plan" in res:
            log(f"[kernel] {name} {dt}: tensor-core plan at B=1: " + ", ".join(
                f"T={t}: " + " ".join(f"{k}={v}" for k, v in p.items())
                for t, p in res["plan"].items()))
        if "breakdown" in res:
            log(f"[kernel] {name} {dt} device ms per call by kernel: " +
                "; ".join(f"{k} {v[0]:.4f} ({v[1]:g}x)"
                          for k, v in list(res["breakdown"].items())[:16]))
        if "pairs" in res:
            pr = res["pairs"]
            log(f"[kernel] {name} {dt}: ResBlock1 pairs fused where they fit "
                f"(the path) {pr['fused_ms']:.3f} ms, each pair as two conv "
                f"launches {pr['unfused_ms']:.3f} ms (rel_l2 "
                f"{pr['unfused_rel_l2']:.3e}); unfused by kernel: " +
                "; ".join(f"{k} {v[0]:.4f} ({v[1]:g}x)" for k, v in
                          list(pr["unfused_breakdown"].items())[:10]))
        if "stages" in res:
            log(f"[kernel] {name} {dt}: {res['tail_launches']:g} launches per "
                "tail; per stage the launch plans (CTAs, shared memory "
                "bytes, N tile, rows per CTA) and one k=11 conv (d=1):")
            for st in res["stages"]:
                convt = (f" ConvT {st['convt_plan']};" if "convt_plan" in st
                         else "")
                pairs = (f" pairs {st['pair_plans']};" if "pair_plans" in st
                         else "")
                log(f"[kernel]   stage {st['stage']} C={st['channels']} "
                    f"T={st['rows']}:{convt} convs {st['conv_plans']};{pairs}"
                    " k=11 "
                    f"kernel {st['k11_ms']:.4f} ms, F.conv1d true f32 "
                    f"(library) {st['k11_library_ms']:.4f} ms, bound "
                    f"{st['k11_bound_ms']:.4f} ms, rel_l2 "
                    f"{st['k11_rel_l2']:.2e}")
        if name == "plms_ladder":
            log(f"[kernel] {name} {dt}: final x rel_l2="
                f"{res['final_x_rel_l2']:.3e}, eps part of x "
                f"{res['eps_share']:.3e}")
        if "per_output" in res:
            log(f"[kernel] {name} {dt} B={res['batch']} fwd+bwd: " + " ".join(
                f"{k}={v['rel_l2']:.2e}" for k, v in res["per_output"].items()))
        if name == "residual_stack_train":
            log(f"[kernel] {name} {dt}: route {res['route']}; batch of "
                f"{res['batch']} equals the in-order sum of its B=1 runs bit "
                f"for bit: {res['batch_is_sum_of_b1']}; against K4 at the f32 "
                "stream: " + " ".join(f"{k}={v:.2e}" for k, v in
                                      res["vs_k4_f32"].items()))
            if not res["batch_is_sum_of_b1"]:
                raise SmokeError("K5's batch differs from the in-order sum of "
                                 "its B=1 runs")
        if not res["rel_l2"] <= tol:
            raise SmokeError(f"{name} {dt} disagrees with its plain version: "
                             f"rel_l2 {res['rel_l2']:.3e} > {tol:g}")
        for k, v in res["fault_rel_l2"].items():
            if not v > tol:
                raise SmokeError(f"{name} {dt}: the planted fault '{k}' reads "
                                 f"{v:.3e}, within the tolerance {tol:g}")
        out.setdefault(name, {})[dt] = res
    return out


# ---------------------------------------------------------------------------
# Phase 4: the slice through Svc + run_clip
# ---------------------------------------------------------------------------

def phase_slice(device, workdir):
    """Convert the clips through Svc + run_clip in bf16 and f32."""
    import numpy as np
    import torch

    from diffsvc_tpu_torch import infer_cli
    from diffsvc_tpu_torch.infer.svc import Svc
    from diffsvc_tpu_torch.models.hubert import HubertConfig
    from diffsvc_tpu_torch.ops.hopper import (diffnet_stack, plms_ladder,
                                              vocoder_tail)
    from diffsvc_tpu_torch.utils import synth
    from diffsvc_tpu_torch.utils.audio_io import load_wav, save_wav

    counters = {"residual_stack": diffnet_stack, "plms_ladder": plms_ladder,
                "vocoder_tail": vocoder_tail}
    t0 = time.time()
    cfg_fn, ckpt = synth.write_project(
        os.path.join(workdir, "proj"),
        {"base_config": [os.path.join(ROOT, "configs", "config_44k.yaml")]},
        VOC_H, hubert_cfg=HubertConfig())
    log(f"[slice] wrote checkpoints in {time.time() - t0:.2f}s")
    sr = 44100
    wavs = []
    for i, (secs, f0, gaps) in enumerate(CLIPS):
        fn = os.path.join(workdir, f"clip{i}.wav")
        save_wav(synth.voiced_wav(secs, sr, f0, gaps, seed=i), fn, sr)
        wavs.append(fn)

    results = {"clips": []}
    svcs = {}
    for dt in ("bfloat16", ""):
        t0 = time.time()
        svcs[dt] = Svc("proj", cfg_fn, True, ckpt, device=device)
        svcs[dt].hp["diff_compute_dtype"] = dt
        log(f"[slice] Svc({dt or 'float32'}) loaded in {time.time() - t0:.2f}s")
    # warm up each Svc once on a short clip (cuDNN/cuFFT plans, allocator)
    for svc in svcs.values():
        svc.infer(wavs[0], key=0, acc=ACC, use_pe=False, use_crepe=False)
    torch.cuda.synchronize()

    for mod in counters.values():
        mod.launches = 0
    results["launches_tc"] = {}
    tc_counters = ("launches_tc", "launches_tf32x3")
    results["launches_k3"] = {}
    for dt, svc in svcs.items():
        for mod in (diffnet_stack, plms_ladder):
            for k in tc_counters:
                setattr(mod, k, 0)
        k3_before = vocoder_tail.launches
        for fn, (secs, _, _) in zip(wavs, CLIPS):
            out_fn = fn[:-4] + f"_{dt or 'f32'}_out.wav"
            t0 = time.time()
            with phase_sums() as phases:
                _, f0_pred, audio = infer_cli.run_clip(
                    svc, key=0, acc=ACC, use_pe=False, use_crepe=False,
                    thre=0.05, use_gt_mel=False, add_noise_step=500,
                    file_path=fn, out_path=out_fn)
                torch.cuda.synchronize()
            wall = time.time() - t0
            src, _ = load_wav(fn)
            got, got_sr = load_wav(out_fn)
            audio = np.asarray(audio, np.float32)
            rec = {"dtype": dt or "float32", "secs": secs, "wall_s": wall,
                   "rtf": wall / secs, "out_len": len(got),
                   "in_len": len(src), "peak": float(np.abs(audio).max()),
                   "phases_s": phases}
            log(f"[slice] {rec['dtype']} clip {secs:.1f}s: wall={wall:.3f}s "
                f"rtf={rec['rtf']:.4f} peak={rec['peak']:.3f} host time by "
                f"span { {k: round(v, 4) for k, v in phases.items()} }")
            if got_sr != sr or len(got) != len(src) or len(audio) != len(src):
                raise SmokeError(f"output length {len(got)} != input {len(src)}")
            if not np.isfinite(audio).all():
                raise SmokeError("non-finite output audio")
            if rec["peak"] < 1e-3:
                raise SmokeError("silent output audio")
            results["clips"].append(rec)
        # bf16 conversions move launches_tc and not launches_tf32x3, f32
        # ones the reverse
        tc = {k: {"residual_stack": getattr(diffnet_stack, k),
                  "plms_ladder": getattr(plms_ladder, k)}
              for k in tc_counters}
        results["launches_tc"][dt or "float32"] = tc
        k3 = vocoder_tail.launches - k3_before
        results["launches_k3"][dt or "float32"] = k3
        log(f"[slice] {dt or 'float32'} conversions: tensor-core launches {tc}"
            f"; K3 tails {k3}")
        if k3 <= 0:
            raise SmokeError(f"{dt or 'float32'} conversions did not run K3")
        want = "launches_tc" if dt == "bfloat16" else "launches_tf32x3"
        if any((n > 0) != (k == want) for k in tc_counters
               for n in tc[k].values()):
            raise SmokeError(f"{dt or 'float32'} conversions: tensor-core "
                             f"launches {tc} (must move {want} alone)")
    launches = {name: mod.launches for name, mod in counters.items()}
    results["launches"] = launches
    log(f"[slice] kernel launches on the main path: {launches}")
    for name, n in launches.items():
        if n <= 0:
            raise SmokeError(f"kernel {name} was not launched on the main path")
    results["cpu_agreement"] = {
        dt or "float32": cpu_agreement(svc, cfg_fn, ckpt, wavs[0])
        for dt, svc in svcs.items()}
    results["profile"] = {
        dt or "float32": profile_clip(svc, wavs[-1], wavs[-1][:-4] + "_prof.wav")
        for dt, svc in svcs.items()}
    names = {dt: prof.pop("names")
             for dt, prof in results["profile"].items()}
    simt_bf16 = [n for n in names["bfloat16"] if re.search(
        r"\b(gate|out)_kernel<[^>]*bfloat16", n)]
    if simt_bf16 or not any("gate_tc_kernel" in n for n in names["bfloat16"]):
        raise SmokeError("the bf16 conversion's profile lacks K1's tensor-core "
                         f"kernels or runs SIMT layer kernels: {simt_bf16}")
    simt = [n for n in names["float32"]
            if re.search(r"\b(gate|out)_kernel<", n)]
    if simt or not any("tf32x3::gate_kernel" in n for n in names["float32"]):
        raise SmokeError("the f32 conversion's profile lacks K1's 3xTF32 "
                         f"kernels or runs SIMT layer kernels: {simt}")
    # the vocoder is f32 in both: K3's tensor-core kernels, no SIMT conv
    for dt, ns in names.items():
        simt = [n for n in ns if re.search(r"(^|::)conv1d_kernel\b", n)]
        if simt or not any("tail::conv_tc_kernel" in n for n in ns):
            raise SmokeError(f"the {dt} conversion's profile lacks K3's "
                             f"tensor-core kernels or runs SIMT ones: {simt}")
    project = {"cfg_fn": cfg_fn, "ckpt": ckpt, "wavs": wavs, "svcs": svcs}
    return results, project


@contextlib.contextmanager
def phase_sums():
    """Host seconds inside the block by the innermost of the program's spans
    (``utils/trace.py``: ``cli.*``, ``svc.*``) open at each moment on this
    thread, into the dict it yields when the block ends; the time no span
    covers is under ``"other"``."""
    from diffsvc_tpu_torch.utils import trace

    was, sums = trace.TRACER.enabled, {}
    trace.enable()
    trace.reset()
    t0 = time.perf_counter()
    try:
        yield sums
    finally:
        t1, me = time.perf_counter(), threading.get_ident()
        split = trace.idle_split([s for s in trace.spans() if s.thread == me],
                                 [(t0, t1)])
        sums.update({k or "other": v for k, v in split.items()})
        trace.reset()
        trace.TRACER.enabled = was


def profile_clip(svc, wav_fn, out_fn):
    """Where the time goes: torch.profiler over one run_clip."""
    from diffsvc_tpu_torch import infer_cli

    return profile_run(
        f"{svc.hp['diff_compute_dtype'] or 'float32'} run_clip",
        lambda: infer_cli.run_clip(svc, key=0, acc=ACC, use_pe=False,
                                   use_crepe=False, thre=0.05,
                                   use_gt_mel=False, add_noise_step=500,
                                   file_path=wav_fn, out_path=out_fn))


@contextlib.contextmanager
def zeroed(*params):
    """Parameters set to zero for the duration of the block."""
    import torch

    saved = [p.detach().clone() for p in params]
    with torch.no_grad():
        for p in params:
            p.zero_()
    try:
        yield
    finally:
        with torch.no_grad():
            for p, v in zip(params, saved):
                p.copy_(v)


def skip_bias_dropped(svc):
    """The planted fault of the card-vs-CPU checks: the denoiser's
    skip-projection bias dropped."""
    return zeroed(svc.model.denoise_fn.skip_projection.bias)


def denoiser_head(svc):
    """The parameters that zeroed give eps = 0: DiffNet's output
    projection."""
    head = svc.model.denoise_fn.output_projection
    return head.weight, head.bias


CPU_SVCS = {}   # (config, checkpoint) -> the CPU Svc of cpu_agreement


def cpu_agreement(svc_dev, cfg_fn, ckpt, wav_fn, acc=ACC, tag="slice",
                  same_f0=False, head=denoiser_head, fault=skip_bias_dropped,
                  fault_name="bskip dropped", secs=0.5, **infer_kw):
    """The same short conversion on the card and on the CPU (plain
    versions), at ``svc_dev``'s diff_compute_dtype and ``acc`` (at acc=1
    DDPM, its per-step noise shared too; ``infer_kw``: e.g. use_gt_mel),
    with the sampler noise and the NSF source draws shared.  ``same_f0``:
    the card's conversions take the CPU's f0 track, and the one with the
    card's own track is the diagnostic (for a check of the sampler whose
    denoiser part is too small a share of the waveform to see past the
    tracker's device difference).  As for the ladder, the waveforms are
    compared on what the denoiser put in them: each minus the CPU's
    conversion with eps = 0 (output projection zeroed).  They must agree to
    SLICE_TOL in f32 (f32 sums in other orders through ~1000 denoiser layers
    and the vocoder) or SLICE_TOL_BF16 in bf16, and the card's conversion
    with the planted ``fault`` (a context manager on the card's Svc; by
    default the denoiser's skip-projection bias dropped) must not.
    ``head(svc)``: the parameters zeroed for eps = 0.  ``secs``: the clip's
    first seconds converted."""
    import numpy as np
    import torch

    from diffsvc_tpu_torch.infer.svc import Svc
    from diffsvc_tpu_torch.utils.audio_io import load_wav, save_wav
    from diffsvc_tpu_torch.vocoders.generator import draw_randoms

    wav, sr = load_wav(wav_fn)
    short = wav_fn[:-4] + "_short.wav"
    save_wav(wav[: int(secs * sr)], short, sr)
    dt = svc_dev.hp["diff_compute_dtype"] or "float32"
    tol = SLICE_TOL_BF16 if dt == "bfloat16" else SLICE_TOL
    # one CPU Svc per project, kept for the project's next check (the other
    # dtype, DDPM): its weights are only read, eps = 0's are restored
    svc_cpu = CPU_SVCS.get((cfg_fn, ckpt))
    if svc_cpu is None:
        svc_cpu = CPU_SVCS[(cfg_fn, ckpt)] = Svc("proj", cfg_fn, False, ckpt,
                                                 device="cpu")
    svc_cpu.hp["diff_compute_dtype"] = svc_dev.hp["diff_compute_dtype"]
    batch = svc_cpu.pre(short, acc, use_crepe=False)
    t_mel = batch["mels"].shape[1]
    g = torch.Generator().manual_seed(3)
    noise = torch.randn(1, t_mel, svc_cpu.mel_bins, generator=g)
    if acc <= 1:
        n_steps = int(infer_kw["add_noise_step"]) if infer_kw.get(
            "use_gt_mel") else svc_cpu.model.K_step
        infer_kw = dict(infer_kw, step_noise=torch.randn(
            n_steps, 1, t_mel, svc_cpu.mel_bins, generator=g))
    n_real = int((np.abs(batch["mels"][0]).sum(-1) > 0).sum())
    hop = int(svc_cpu.hp["hop_size"])
    randoms = draw_randoms(1, n_real * hop, svc_cpu.vocoder.cfg.harmonic_num, g)

    def convert(svc):
        dev_randoms = tuple(r.to(svc.device) for r in randoms)
        _, _, out = svc.infer(short, key=0, acc=acc, use_pe=False,
                              use_crepe=False, init_noise=noise,
                              voc_randoms=dev_randoms, **infer_kw)
        return torch.from_numpy(np.asarray(out, np.float32))

    ref = convert(svc_cpu)
    with zeroed(*head(svc_cpu)):
        base = convert(svc_cpu)
    from diffsvc_tpu_torch.data import features

    @contextlib.contextmanager
    def cpu_track(on=True):
        """The card's conversions with the CPU's f0 track (the AC tracker
        runs on each side's device; cuFFT's ACF moves the track by ~1e-6
        relative), so that what remains is the kernels' difference."""
        if on:
            svc_dev._cached_pitch = lambda wav, mel, use_crepe, thre: \
                features.get_pitch(wav, mel, svc_dev.hp, use_crepe, thre,
                                   device="cpu")
        try:
            yield
        finally:
            if on:
                del svc_dev._cached_pitch

    with cpu_track(same_f0):
        got = convert(svc_dev)
        with fault(svc_dev):
            fault_out = convert(svc_dev)
    # the diagnostic: the other track on the card
    with cpu_track(not same_f0):
        other_f0 = convert(svc_dev)
    res = {"rel_l2": rel_l2(got - base, ref - base),
           "f0_track_of_card": "cpu" if same_f0 else "card",
           "rel_l2_other_f0": rel_l2(other_f0 - base, ref - base),
           "wav_rel_l2": rel_l2(got, ref), "eps_share": rel_l2(ref, base),
           "max_abs_err": float((got - ref).abs().max()),
           "fault_rel_l2": rel_l2(fault_out - base, ref - base),
           "fault": fault_name,
           "tol_rel_l2": tol, "secs": secs}
    res["mode"] = f"acc={acc}" + (
        f", use_gt_mel at {infer_kw['add_noise_step']} steps"
        if infer_kw.get("use_gt_mel") else "")
    log(f"[{tag}] {dt} card vs CPU on {secs}s ({res['mode']}): "
        f"rel_l2={res['rel_l2']:.3e} "
        f"(tol {tol:g}; waveform itself {res['wav_rel_l2']:.3e}, eps "
        f"part of it {res['eps_share']:.3e}) max_abs={res['max_abs_err']:.3e}"
        f"; planted fault [{fault_name}: {res['fault_rel_l2']:.3e}]; the "
        f"card's conversions on the {res['f0_track_of_card']}'s f0 track; "
        f"on the other one: {res['rel_l2_other_f0']:.3e}")
    if not res["rel_l2"] <= tol:
        raise SmokeError(f"card and CPU conversions disagree: {res}")
    if not res["fault_rel_l2"] > tol:
        raise SmokeError(f"the planted fault passes the card-vs-CPU check: {res}")
    return res


# ---------------------------------------------------------------------------
# Phase 7: serving (the fused program, batched chunks, the HTTP server)
# ---------------------------------------------------------------------------

# Batched fused conversion against each chunk's own B=1 fused call on the
# same padding and noise, at f32: relative L2 of the waveform.  The rows of
# a batch meet only in the kernels' tiling, so they agree to the f32 sums'
# order.
BATCHED_TOL = 1e-4
SERVE_CLIP = -1          # the 14 s clip of phase 4
# (seconds, f0 Hz, silent spans): three voiced chunks of 5.2-5.6 s, which
# the collate pads to one length (512 frames): one group, B = 3
BATCH_CLIP = (17.0, 262.0, [(5.6, 6.4), (11.4, 12.2)])
SERVER_SECS = 2.0        # the fused requests' buffer
STREAM_SECS = 0.5        # the streamed requests' buffer


def kernel_counts() -> dict:
    """K1-K5's counters (K6's is read as a difference by :func:`counted`:
    its count over phases 4-9 must stay whole)."""
    from diffsvc_tpu_torch.ops.hopper import (diffnet_stack,
                                              diffnet_stack_per_sample,
                                              diffnet_stack_train,
                                              plms_ladder, vocoder_tail)

    return {"residual_stack": diffnet_stack.launches,
            "plms_ladder": plms_ladder.launches,
            "vocoder_tail": vocoder_tail.launches,
            "residual_stack_train_batched": diffnet_stack_train.launches,
            "residual_stack_train": diffnet_stack_per_sample.launches}


ALL_KERNELS = ("residual_stack", "plms_ladder", "vocoder_tail",
               "residual_stack_train_batched", "residual_stack_train",
               "fused_residual_block")


@contextlib.contextmanager
def counted(label: str, into: dict, moved=("plms_ladder", "vocoder_tail"),
            still=(), tag="serve"):
    """K1-K5's counters set to 0 before the block and read after it, and
    K6's launches in the block (its counter's rise): every kernel's count
    for the block.  The kernels in ``moved`` must have moved and those in
    ``still`` must not."""
    from diffsvc_tpu_torch.ops.hopper import (diffnet_block, diffnet_stack,
                                              diffnet_stack_per_sample,
                                              diffnet_stack_train,
                                              plms_ladder, vocoder_tail)

    for mod in (diffnet_stack, plms_ladder, vocoder_tail,
                diffnet_stack_train, diffnet_stack_per_sample):
        mod.launches = 0
    k6_before = diffnet_block.launches
    yield
    import torch

    torch.cuda.synchronize()
    into[label] = dict(kernel_counts(), fused_residual_block=(
        diffnet_block.launches - k6_before))
    log(f"[{tag}] {label}: kernel launches {into[label]}")
    for name in moved:
        if into[label][name] <= 0:
            raise SmokeError(f"{label} did not launch {name}")
    for name in still:
        if into[label][name] != 0:
            raise SmokeError(f"{label} launched {name} "
                             f"{into[label][name]} times")


def voiced_chunks(wav_fn):
    """The slicer's voiced chunks of a clip (float32 at its rate)."""
    from diffsvc_tpu_torch.infer import slicer

    chunks = slicer.cut(wav_fn, db_thresh=-40)
    data, _ = slicer.chunks2audio(wav_fn, chunks)
    return [d.astype("float32") for tag, d in data if not tag]


def fused_trace(label, fn):
    """torch.profiler over one fused chunk: the device busy share, and no
    device-to-host copy may start before the chunk's last kernel ends (the
    program keeps everything on the card until its outputs)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall = time.time() - t0
    kernels, d2h, spans = [], [], []
    for start, end, name in device_events(prof):
        span = (start, end)
        spans.append(span)
        if "DtoH" in name or "Device -> Pageable" in name \
                or "Device -> Pinned" in name:
            d2h.append((span, name))
        elif "Memcpy" not in name and "Memset" not in name:
            kernels.append((span, name))
    busy_us, reach = 0.0, float("-inf")
    for a, b in sorted(spans):
        busy_us += max(0.0, b - max(a, reach))
        reach = max(reach, b)
    last_kernel = max(b for (_, b), _ in kernels)
    early = [n for (a, _), n in d2h if a < last_kernel]
    res = {"wall_s": wall, "device_busy_ms": busy_us / 1e3,
           "busy_share": busy_us / 1e6 / wall, "kernels": len(kernels),
           "d2h": len(d2h), "d2h_before_last_kernel": early,
           "k3_traced": any("tail::" in n for _, n in kernels),
           "k1_traced": any("gate" in n for _, n in kernels)}
    log(f"[serve] profile of {label}: wall={wall:.4f}s device_busy="
        f"{res['device_busy_ms']:.2f}ms busy_share={res['busy_share']:.3f} "
        f"kernels={len(kernels)} (K1 traced {res['k1_traced']}, K3 traced "
        f"{res['k3_traced']}); device-to-host copies {len(d2h)}, before the "
        f"last kernel {len(early)}")
    if early:
        raise SmokeError(f"{label}: device-to-host copies before the last "
                         f"kernel: {early}")
    if not (res["k1_traced"] and res["k3_traced"]):
        raise SmokeError(f"{label}: the trace lacks the program's kernels")
    return res


def route_run(label, secs, n_chunks, fn, pools=0, tag="serve"):
    """A route's wall over one conversion (host clock, ending in a sync),
    then a profiled one for the device busy share."""
    import torch

    torch.cuda.synchronize()
    t0 = time.time()
    fn()
    torch.cuda.synchronize()
    wall = time.time() - t0
    prof = profile_run(f"{label} ({tag})", fn)
    prof.pop("names")
    rec = {"wall_s": wall, "rtf": wall / secs, "chunks": n_chunks,
           "wall_per_chunk_s": wall / n_chunks,
           "busy_share": prof["busy_share"],
           "device_busy_ms": prof["device_busy_ms"],
           "graph_pool_mib": pools / 2 ** 20}
    log(f"[{tag}] route {label}: wall={wall:.4f}s rtf={rec['rtf']:.4f} "
        f"per chunk {rec['wall_per_chunk_s']:.4f}s busy_share="
        f"{rec['busy_share']:.3f} device_busy={rec['device_busy_ms']:.1f}ms "
        f"graph pools {rec['graph_pool_mib']:.1f} MiB")
    return rec


def fused_cpu_agreement(svc_dev, project, chunk):
    """A 0.5 s fused conversion on the card against the same fused
    conversion on the CPU (plain versions), the same noise, compared on
    what the denoiser put in the waveform (each minus the CPU's conversion
    with eps = 0), at phase 4's limits; the card's program with the
    denoiser's skip-projection bias dropped must exceed them."""
    import numpy as np
    import torch

    from diffsvc_tpu_torch.infer.fused import FusedSvc
    from diffsvc_tpu_torch.infer.svc import Svc
    from diffsvc_tpu_torch.vocoders.generator import draw_randoms

    dt = svc_dev.hp["diff_compute_dtype"] or "float32"
    tol = SLICE_TOL_BF16 if dt == "bfloat16" else SLICE_TOL
    svc_cpu = Svc("proj", project["cfg_fn"], True, project["ckpt"],
                  device="cpu")
    wav = chunk[: int(0.5 * 44100)]
    hp = dict(svc_dev.hp, fused_bucket_samples=0)

    def fused_of(svc, cuda_graphs=True):
        return FusedSvc(type(svc.hp)(hp), svc.model, svc.vocoder,
                        svc.hubert.model, speedup=ACC,
                        cuda_graphs=cuda_graphs)

    f_cpu = fused_of(svc_cpu)
    geo = f_cpu.geometry(len(wav))
    g = torch.Generator().manual_seed(3)
    noise = torch.randn(1, geo["pad_t"], svc_cpu.mel_bins, generator=g)
    randoms = draw_randoms(1, geo["n_voc"], svc_cpu.vocoder.cfg.harmonic_num,
                           g)

    def convert(f):
        return torch.from_numpy(np.asarray(f(wav, init_noise=noise,
                                             voc_randoms=randoms)[0]))

    ref = convert(f_cpu)
    out_proj = svc_cpu.model.denoise_fn.output_projection
    with zeroed(out_proj.weight, out_proj.bias):
        base = convert(fused_of(svc_cpu))
    f_dev = fused_of(svc_dev)
    got = convert(f_dev)
    with zeroed(svc_dev.model.denoise_fn.skip_projection.bias):
        fault = convert(fused_of(svc_dev, cuda_graphs=False))
    # diagnostic: the card's program (eager) with the tracker run on the CPU
    from diffsvc_tpu_torch.ops import f0_ac

    real_track = f0_ac.track
    f0_ac.track = lambda w, **kw: real_track(w.cpu(), **kw).to(w.device)
    try:
        cpu_f0 = convert(fused_of(svc_dev, cuda_graphs=False))
    finally:
        f0_ac.track = real_track
    res = {"rel_l2": rel_l2(got - base, ref - base),
           "rel_l2_cpu_f0": rel_l2(cpu_f0 - base, ref - base),
           "wav_rel_l2": rel_l2(got, ref), "eps_share": rel_l2(ref, base),
           "max_abs_err": float((got - ref).abs().max()),
           "fault_rel_l2": rel_l2(fault - base, ref - base),
           "tol_rel_l2": tol}
    log(f"[serve] {dt} fused card vs CPU on 0.5s: rel_l2={res['rel_l2']:.3e} "
        f"(tol {tol:g}; waveform itself {res['wav_rel_l2']:.3e}, eps part "
        f"{res['eps_share']:.3e}) max_abs={res['max_abs_err']:.3e}; planted "
        f"fault [bskip dropped: {res['fault_rel_l2']:.3e}]; with the tracker "
        f"on the CPU on both sides: {res['rel_l2_cpu_f0']:.3e}")
    if not res["rel_l2"] <= tol:
        raise SmokeError(f"fused card and CPU conversions disagree: {res}")
    if not res["fault_rel_l2"] > tol:
        raise SmokeError(f"the planted fault passes the fused check: {res}")
    return res


def replay_equals_eager(svc, chunk):
    """The same chunk, noise and padding through the captured program and
    through the same body run eagerly on the card: equal bit for bit."""
    import numpy as np
    import torch

    from diffsvc_tpu_torch.infer.fused import FusedSvc
    from diffsvc_tpu_torch.vocoders.generator import draw_randoms

    graphed = svc.fused_model(ACC)
    eager = FusedSvc(graphed.hp, svc.model, svc.vocoder, svc.hubert.model,
                     speedup=ACC, cuda_graphs=False)
    geo = graphed.geometry(graphed._padded_length(len(chunk)))
    g = torch.Generator(device=svc.device).manual_seed(11)
    noise = torch.randn(1, geo["pad_t"], svc.mel_bins, generator=g,
                        device=svc.device)
    randoms = draw_randoms(1, geo["n_voc"], svc.vocoder.cfg.harmonic_num, g,
                           svc.device)
    outs = [f(chunk, init_noise=noise, voc_randoms=randoms)
            for f in (graphed, eager, graphed)]
    same = all(np.array_equal(a, b) for o in outs[1:]
               for a, b in zip(outs[0], o))
    if not same:
        diffs = [float(np.abs(a.astype(np.float64) - b).max())
                 for a, b in zip(outs[0], outs[1])]
        raise SmokeError(f"graph replay differs from eager: max |diff| "
                         f"(wav, f0, mel) {diffs}")
    return same


def batched_vs_single(svc, chunks):
    """FusedSvc.batched at B = len(chunks) against each chunk's B=1 fused
    call on the same padding and noise."""
    import numpy as np
    import torch

    from diffsvc_tpu_torch.vocoders.generator import draw_randoms

    fused = svc.fused_model(ACC)
    n = len(chunks)
    n44 = fused._padded_length(max(len(c) for c in chunks))
    geo = fused.geometry(n44)
    g = torch.Generator(device=svc.device).manual_seed(5)
    noise = torch.randn(n, geo["pad_t"], svc.mel_bins, generator=g,
                        device=svc.device)
    randoms = draw_randoms(n, geo["n_voc"], svc.vocoder.cfg.harmonic_num, g,
                           svc.device)
    outs = fused.batched(chunks, init_noise=noise, voc_randoms=randoms)
    rels = []
    for i, c in enumerate(chunks):
        padded = np.zeros(n44, np.float32)
        padded[: len(c)] = c
        ref = fused(padded, init_noise=noise[i: i + 1],
                    voc_randoms=tuple(r[i: i + 1] for r in randoms))[0]
        got = fused.to_float(outs[i][0])
        rels.append(rel_l2(torch.from_numpy(np.asarray(got, np.float32)),
                           torch.from_numpy(np.asarray(fused.to_float(
                               ref[: len(c)]), np.float32))))
    log(f"[serve] fused batched B={n} vs B=1 calls (f32, same padding and "
        f"noise): rel_l2 per chunk {[f'{r:.2e}' for r in rels]} (tol "
        f"{BATCHED_TOL:g})")
    if not max(rels) <= BATCHED_TOL:
        raise SmokeError(f"batched chunks disagree with their B=1 calls: "
                         f"{rels}")
    return rels


def serve_http(svc):
    """The port's server in this process on 127.0.0.1: three fused
    requests, three streamed ones (each answered 200 with the posted
    duration) and a malformed one (400)."""
    import io
    import threading
    import urllib.error
    import urllib.request
    from http.server import HTTPServer

    import numpy as np
    from scipy.io import wavfile

    from diffsvc_tpu_torch import flask_api
    from diffsvc_tpu_torch.utils import synth

    sr = 44100
    flask_api.warmup_fused(svc, ACC, SERVER_SECS)
    boundary = "smokeboundary"

    def body(wav, pitch="0"):
        buf = io.BytesIO()
        wavfile.write(buf, sr, (wav * 32767).astype(np.int16))
        out = b""
        for k, v in {"fPitchChange": pitch, "sampleRate": str(sr)}.items():
            out += (f"--{boundary}\r\nContent-Disposition: form-data; "
                    f'name="{k}"\r\n\r\n{v}\r\n').encode()
        out += (f"--{boundary}\r\nContent-Disposition: form-data; "
                'name="sample"; filename="in.wav"\r\nContent-Type: '
                "audio/wav\r\n\r\n").encode()
        return out + buf.getvalue() + f"\r\n--{boundary}--\r\n".encode()

    def post(port, data):
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/voiceChangeModel", data=data,
            headers={"Content-Type":
                     f"multipart/form-data; boundary={boundary}"},
            method="POST")
        try:
            with urllib.request.urlopen(req, timeout=120) as resp:
                _, out = wavfile.read(io.BytesIO(resp.read()))
                return resp.status, len(out)
        except urllib.error.HTTPError as e:
            return e.code, 0

    wav = synth.voiced_wav(3 * SERVER_SECS, sr, 240.0, seed=7)
    answers = {}
    stream = flask_api.make_stream(svc, ACC, fused=True)
    for label, st in (("fused", None), ("stream", stream)):
        server = HTTPServer(("127.0.0.1", 0),
                            flask_api.make_handler(svc, ACC, fused=True,
                                                   stream=st))
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        try:
            n = int((SERVER_SECS if st is None else STREAM_SECS) * sr)
            got = []
            for k in range(3):
                t0 = time.time()
                status, length = post(server.server_address[1],
                                      body(wav[k * n: (k + 1) * n], "2"))
                got.append({"status": status, "samples": length,
                            "want": n, "wall_s": time.time() - t0})
            if st is None:
                got.append({"malformed": post(server.server_address[1],
                                              body(wav[:n])[:200])[0]})
            answers[label] = got
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=30)
    log(f"[serve] HTTP answers: {answers}")
    for label, got in answers.items():
        for r in got[:3]:
            if r["status"] != 200 or r["samples"] != r["want"]:
                raise SmokeError(f"server {label} answered {r}")
    if answers["fused"][3]["malformed"] != 400:
        raise SmokeError(f"a malformed request was answered "
                         f"{answers['fused'][3]}")
    return answers


def phase_serve(device, project):
    """Phase 7 on phase 4's project: the fused routes (bf16 and f32), the
    batched routes, and the server."""
    import torch

    from diffsvc_tpu_torch import infer_cli
    from diffsvc_tpu_torch.utils import synth
    from diffsvc_tpu_torch.utils.audio_io import save_wav

    wav_fn = project["wavs"][SERVE_CLIP]
    secs = CLIPS[SERVE_CLIP][0]
    chunks = voiced_chunks(wav_fn)
    res = {"launches": {}, "routes": {}, "captures": {}}

    def clip(svc, file_path=wav_fn, **route):
        return infer_cli.run_clip(
            svc, key=0, acc=ACC, use_pe=False, use_crepe=False, thre=0.05,
            use_gt_mel=False, add_noise_step=500, file_path=file_path,
            out_path=file_path[:-4] + "_serve.wav", **route)

    batch_fn = os.path.join(os.path.dirname(wav_fn), "batch_clip.wav")
    secs_b, f0_b, gaps_b = BATCH_CLIP
    save_wav(synth.voiced_wav(secs_b, 44100, f0_b, gaps_b, seed=5), batch_fn,
             44100)
    batch_chunks = voiced_chunks(batch_fn)
    for dt, svc in project["svcs"].items():
        name = dt or "float32"
        # (a) fused: every bucket captured once on the first conversion
        with counted(f"fused {name}", res["launches"]):
            clip(svc, fused=True)
        fused = svc.fused_model(ACC)
        res["captures"][name] = {str(k[:2]): v
                                 for k, v in fused.captures.items()}
        routes = res["routes"].setdefault(name, {})
        routes["modular"] = route_run(f"modular {name}", secs, len(chunks),
                                      lambda: clip(svc))
        routes["fused graph"] = route_run(
            f"fused graph {name}", secs, len(chunks),
            lambda: clip(svc, fused=True),
            sum(fused.pool_bytes().values()))
        saved = fused.cuda_graphs, fused._fns
        fused.cuda_graphs, fused._fns = False, {}
        try:
            routes["fused eager"] = route_run(
                f"fused eager {name}", secs, len(chunks),
                lambda: clip(svc, fused=True))
        finally:
            fused.cuda_graphs, fused._fns = saved
        routes["batched"] = route_run(f"batched {name}", secs, len(chunks),
                                      lambda: clip(svc, batch_chunks=True))
        # (b) the batched route where the chunks form one group: K2 and K3
        # once per conversion, at B = the voiced chunks
        groups = res.setdefault("batch_clip", {}).setdefault(name, {})
        for route, kw in (("modular", {}), ("fused graph", {"fused": True}),
                          ("batched", {"batch_chunks": True})):
            with counted(f"{route} {name}, batch clip", res["launches"]):
                groups[route] = route_run(
                    f"{route} {name}, {len(batch_chunks)}-chunk clip",
                    BATCH_CLIP[0], len(batch_chunks),
                    lambda kw=kw: clip(svc, file_path=batch_fn, **kw))
        got = res["launches"][f"batched {name}, batch clip"]
        if (got["plms_ladder"], got["vocoder_tail"]) != (2, 2):
            raise SmokeError(f"the {len(batch_chunks)}-chunk clip's batched "
                             f"conversions did not run K2 and K3 once each "
                             f"at B = {len(batch_chunks)}: {got}")
        if any(v != 1 for v in fused.captures.values()):
            raise SmokeError(f"a bucket was captured more than once: "
                             f"{fused.captures}")
        res.setdefault("replay_equals_eager", {})[name] = \
            replay_equals_eager(svc, chunks[0])
        log(f"[serve] {name}: graph replay equals eager bit for bit; "
            f"captures per bucket {res['captures'][name]}; graph pools "
            f"{ {str(k[:2]): round(v / 2 ** 20, 1) for k, v in fused.pool_bytes().items()} } MiB")
        res.setdefault("trace", {})[name] = fused_trace(
            f"one fused chunk ({name}, {len(chunks[0]) / 44100:.2f}s)",
            lambda: svc.infer_fused(chunks[0], key=0, acc=ACC))
        res.setdefault("cpu_agreement", {})[name] = fused_cpu_agreement(
            svc, project, chunks[0])
    # (b) batched fused at B = the voiced chunks, against B=1 calls (f32)
    svc32 = project["svcs"][""]
    with counted("fused batched float32", res["launches"]):
        res["batched_rel_l2"] = batched_vs_single(svc32, batch_chunks)
    # (c) the server (bf16, the production serving mode)
    with counted("server bfloat16", res["launches"]):
        res["server"] = serve_http(project["svcs"]["bfloat16"])
    torch.cuda.synchronize()
    return res


# ---------------------------------------------------------------------------
# Phase 5: the training path (binarize -> run.py -> checkpoints -> Svc)
# ---------------------------------------------------------------------------

TRAIN_CLIPS, TRAIN_SR = 32, 44100   # synthetic voiced clips of 4-12 s
TRAIN_STEPS, VAL_EVERY = 6, 3
# One step on the card, kernels vs the plain versions on the card (same
# state, batch, t and noise; bf16 streams; the output head drawn at random
# so the loss depends on the denoiser): the largest of the relative
# differences of the loss and of grad_norm and the rel-L2 of the residual
# layers' grads.  The planted fault drops the last sample's cotangent in
# K4's backward.  Sound 7.8e-4, fault 3.8e-2 on the H100.
TRAIN_STEP_TOL = 5e-3


def train_config(workdir: str) -> dict:
    """config_44k at full width with max_sentences 24; 6 steps, validation
    and a checkpoint every 3; every step logged; no validation plots; the
    AC f0 tracker (``use_crepe: false``; phase 8 binarizes with CREPE)."""
    return {"base_config": [os.path.join(ROOT, "configs", "config_44k.yaml")],
            "raw_data_dir": os.path.join(workdir, "raw"),
            "binary_data_dir": os.path.join(workdir, "bin"),
            "work_dir": os.path.join(workdir, "work"),
            "hubert_path": os.path.join(workdir, "hubert", "hubert_soft.pt"),
            "vocoder_ckpt": os.path.join(workdir, "nsf_hifigan", "model"),
            "max_sentences": TRAIN_B, "max_updates": TRAIN_STEPS,
            "val_check_interval": VAL_EVERY, "log_interval": 1,
            "num_valid_plots": 0, "use_crepe": False}


@contextlib.contextmanager
def swapped(mod, **attrs):
    """Module attributes replaced for the duration of the block (the
    autograd Functions look their wrappers up at call time)."""
    saved = {k: getattr(mod, k) for k in attrs}
    for k, v in attrs.items():
        setattr(mod, k, v)
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(mod, k, v)


def step_grads(task, batch, t, noise):
    """(loss, grad_norm, residual layers' grads) of one step, no update."""
    import torch

    from diffsvc_tpu_torch.training.task import global_norm

    loss, _ = task.model.training_loss(task.prepare_batch(batch), t=t,
                                       noise=noise)
    grads = torch.autograd.grad(loss, task.params, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(task.params, grads)]
    inner = torch.cat([g.flatten() for n, g in zip(task.names, grads)
                       if ".residual_layers." in n])
    return float(loss.detach()), float(global_norm(grads)), inner


def card_vs_plain_step(task, batch, t, noise, mod, plain, bwd_name, tol,
                       tag="train"):
    """One step through the kernels and through the plain versions, both on
    the card (``plain``: (module, attributes) pairs, the wrappers that the
    route's autograd Function calls replaced by their plain versions); and
    through the kernels with a planted fault, the last sample's cotangent
    dropped in ``mod.<bwd_name>``."""
    import torch

    head = task.model.denoise_fn.output_projection
    g = torch.Generator().manual_seed(11)
    with torch.no_grad():
        head.weight.copy_(torch.randn(head.weight.shape, generator=g) * 0.05)

    kernel_bwd = getattr(mod, bwd_name)

    def drop_last(xsave, sb, cp, wd, bd, wo, dout, *, cycle):
        dout = dout.clone()
        dout[-1] = 0
        return kernel_bwd(xsave, sb, cp, wd, bd, wo, dout, cycle=cycle)

    kern = step_grads(task, batch, t, noise)
    with contextlib.ExitStack() as stack:
        for m, attrs in plain:
            stack.enter_context(swapped(m, **attrs))
        plain = step_grads(task, batch, t, noise)
    with swapped(mod, **{bwd_name: drop_last}):
        fault = step_grads(task, batch, t, noise)

    def diff(a, b):
        return max(abs(a[0] - b[0]) / abs(b[0]), abs(a[1] - b[1]) / abs(b[1]),
                   rel_l2(a[2], b[2]))

    res = {"loss": kern[0], "plain_loss": plain[0], "grad_norm": kern[1],
           "plain_grad_norm": plain[1], "rel": diff(kern, plain),
           "fault_rel": diff(fault, plain), "tol": tol}
    log(f"[{tag}] one step, card kernels vs plain on the card: loss "
        f"{kern[0]:.6f}/{plain[0]:.6f} grad_norm {kern[1]:.6f}/{plain[1]:.6f}"
        f" -> {res['rel']:.3e} (tol {tol:g}); planted fault "
        f"[last sample's cotangent dropped: {res['fault_rel']:.3e}]")
    if not res["rel"] <= tol:
        raise SmokeError(f"the card's step disagrees with the plain one: {res}")
    if not res["fault_rel"] > tol:
        raise SmokeError(f"the planted fault passes the step check: {res}")
    return res


# The SIMT training kernels K4 and K5 ran before they moved to the tensor
# cores: no train-step profile may show one.
SIMT_TRAIN = re.compile(r"\b(gate_kernel<float|out_kernel<float|dh_kernel|"
                        r"dy_kernel|wgrad_out_kernel|wgrad_dil_kernel)\b")
TC_TRAIN = ("regate_tc_kernel", "dh_tc_kernel", "dy_tc_kernel",
            "wgrad_tc_kernel")


def check_train_profile(label: str, names, mode: str, forward: str) -> None:
    """A train step's profile runs the training stack on the tensor cores:
    the forward's layer kernel ``forward`` and each backward product's
    kernel in operand mode ``mode`` (``Bf16`` or ``Tf32x3``), and no SIMT
    training kernel."""
    simt = [n for n in names if SIMT_TRAIN.search(n)]
    missing = [k for k in TC_TRAIN
               if not any(k in n and f"::{mode}" in n for n in names)]
    if not any(forward in n for n in names):
        missing.append(forward)
    log(f"[profile] {label}: tensor-core training kernels "
        f"{'all present' if not missing else f'missing {missing}'}; SIMT "
        f"training kernels {simt or 'none'}")
    if simt or missing:
        raise SmokeError(f"{label} does not run the training stack on the "
                         f"tensor cores: missing {missing}, SIMT {simt}")


def time_steps(task, batch, reps: int) -> dict:
    """ms per train step (host clock ending in a sync, after one warm-up
    step), samples/s, mel frames/s and the peak of allocated memory."""
    import torch

    torch.cuda.reset_peak_memory_stats()
    task.train_step(batch)
    torch.cuda.synchronize()
    t0 = time.time()
    for _ in range(reps):
        task.train_step(batch)
    torch.cuda.synchronize()
    step_s = (time.time() - t0) / reps
    return {"ms_per_step": step_s * 1e3,
            "samples_per_s": batch["nsamples"] / step_s,
            "mel_frames_per_s": int(batch["mel_lengths"].sum()) / step_s,
            "padded_frames_per_s": batch["mels"].shape[0]
            * batch["mels"].shape[1] / step_s,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}


def log_steps(tag: str, label: str, batch, r: dict) -> None:
    log(f"[{tag}] {label}, B={batch['nsamples']} T={batch['mels'].shape[1]}"
        f": {r['ms_per_step']:.1f} ms/step, {r['samples_per_s']:.1f} "
        f"samples/s, {r['mel_frames_per_s']:.0f} mel frames/s "
        f"({int(batch['mel_lengths'].sum())} real frames), peak memory "
        f"{r['peak_mem_gb']:.2f} GB")


def batch_route(hp, b: int, t: int) -> str:
    """The training route ``diffnet.apply`` takes for a [B, T] batch."""
    from diffsvc_tpu_torch.models.diffnet import train_route

    return train_route(int(hp["residual_layers"]),
                       int(hp["dilation_cycle_length"]), t,
                       int(hp["residual_channels"]), b,
                       str(hp["diffnet_train_stream_dtype"]),
                       pallas=str(hp.get("diffnet_pallas_train", "auto")))


def time_train_steps(hp, device, batch, reps: int = 3):
    """ms per train step, samples/s and mel frames/s, per stream dtype, with
    the route each takes (at B=24, T=1024 the f32 stream exceeds K4's
    carry, so JAX and the port take the per-sample route, K5)."""
    import torch

    from diffsvc_tpu_torch.config import HParams
    from diffsvc_tpu_torch.training.task import SVCTask

    out = {}
    for sd in ("bf16", "f32"):
        hp_sd = HParams(dict(hp, diffnet_train_stream_dtype=sd))
        task = SVCTask(hp_sd, device=device)
        out[sd] = dict(time_steps(task, batch, reps),
                       route=batch_route(hp_sd, *batch["mels"].shape[:2]))
        log_steps("train", f"{sd} streams ({out[sd]['route']} route)", batch,
                  out[sd])
        del task
        torch.cuda.empty_cache()
    return out


def phase_train(device, workdir):
    """Binarize synthetic clips with the port's binarizer (HuBERT-soft
    768 x 12 with random weights, on the card), train through the run.py
    entry, resume from the step-3 checkpoint, check determinism and the
    card against the plain versions, time both stream dtypes, profile one
    step, and convert a clip through Svc with the trained checkpoint."""
    import copy
    import glob
    import shutil

    import numpy as np
    import torch
    import yaml

    from diffsvc_tpu_torch import infer_cli
    from diffsvc_tpu_torch.config import HParams, set_hparams
    from diffsvc_tpu_torch.data.binarizer import binarize
    from diffsvc_tpu_torch.data.dataset import (BatchIterator,
                                                FastSpeechDataset,
                                                build_batches)
    from diffsvc_tpu_torch.infer.svc import Svc
    from diffsvc_tpu_torch.models.hubert import HubertConfig
    from diffsvc_tpu_torch.ops.hopper import diffnet_stack_train as k4
    from diffsvc_tpu_torch.run import run_task
    from diffsvc_tpu_torch.training.trainer import Trainer
    from diffsvc_tpu_torch.utils import synth
    from diffsvc_tpu_torch.utils.audio_io import load_wav, save_wav
    from diffsvc_tpu_torch.utils.convert import strip_prefix, torch_load

    res = {}
    cfg = train_config(workdir)
    cfg_fn = os.path.join(workdir, "train.yaml")
    with open(cfg_fn, "w") as f:
        yaml.safe_dump(cfg, f)
    synth.write_hubert(cfg["hubert_path"], HubertConfig(), seed=2)
    synth.write_nsf_generator(os.path.dirname(cfg["vocoder_ckpt"]), VOC_H, 1)
    sr = TRAIN_SR
    os.makedirs(cfg["raw_data_dir"])
    secs = np.linspace(4.0, 12.0, TRAIN_CLIPS)
    for i, s in enumerate(secs):
        save_wav(synth.voiced_wav(float(s), sr, 150.0 + 8.0 * i, seed=i),
                 os.path.join(cfg["raw_data_dir"], f"clip{i:02d}.wav"), sr)
    res["audio_s"] = float(secs.sum())

    t0 = time.time()
    hp = set_hparams(config=cfg_fn, exp_name="smoke_train", reset=True,
                     print_hparams=False)
    binarize(hp, device=device)
    res["binarize_s"] = time.time() - t0
    lengths = np.load(os.path.join(cfg["binary_data_dir"],
                                   "train_lengths.npy"))
    log(f"[train] binarized {TRAIN_CLIPS} clips ({res['audio_s']:.1f} s) in "
        f"{res['binarize_s']:.2f}s; train split {len(lengths)} items, "
        f"{int(lengths.sum())} mel frames")
    if len(lengths) != TRAIN_CLIPS - 5:
        raise SmokeError(f"binarizer kept {len(lengths)} train items")

    # --- train through the entry point, K4's counter from the trainer alone
    hp = set_hparams(config=cfg_fn, exp_name="smoke_train", reset=True,
                     print_hparams=False)
    k4.launches = 0
    t0 = time.time()
    trainer = run_task(hp)
    torch.cuda.synchronize()
    res["fit_s"] = time.time() - t0
    res["launches"] = k4.launches
    losses = [h["loss"] for h in trainer.history]
    res["losses"] = losses
    log(f"[train] run_task: {trainer.global_step} steps in {res['fit_s']:.2f}s"
        f", losses {[round(x, 5) for x in losses]}, K4 launches "
        f"{k4.launches}")
    ckpts = sorted(os.path.basename(p) for p in
                   glob.glob(os.path.join(hp["work_dir"], "*.ckpt")))
    res["checkpoints"] = ckpts
    if k4.launches <= 0:
        raise SmokeError("the trainer did not launch K4")
    if trainer.global_step != TRAIN_STEPS or len(losses) != TRAIN_STEPS \
            or not np.isfinite(losses).all():
        raise SmokeError(f"training: {trainer.global_step} steps, losses "
                         f"{losses}")
    if not 0.5 < losses[0] < 2.0:
        raise SmokeError(f"first loss {losses[0]} outside 0.5-2.0 (the zero "
                         "output head predicts zero noise)")
    want = [f"model_ckpt_steps_{s}.ckpt" for s in (VAL_EVERY, TRAIN_STEPS)]
    if ckpts != want:
        raise SmokeError(f"checkpoints {ckpts}, expected {want}")

    # --- restart from the step-3 checkpoint: state restored bit for bit
    work2 = os.path.join(workdir, "work_resume")
    os.makedirs(work2)
    shutil.copy(os.path.join(hp["work_dir"], want[0]), work2)
    hp2 = HParams(dict(hp, work_dir=work2))
    t2 = Trainer(hp2, device=device)
    if not t2.restore() or t2.global_step != VAL_EVERY \
            or t2.task.step != VAL_EVERY:
        raise SmokeError("no resume from the step-3 checkpoint")
    same = restored_bit_exact(t2.task, os.path.join(work2, want[0]))
    res["restore_bit_exact"] = bool(same)
    t2.fit()
    res["resumed_to"] = t2.global_step
    log(f"[train] resume from step {VAL_EVERY}: params + optimizer state "
        f"bit-exact {same}; trained on to step {t2.global_step}")
    if not same or t2.global_step != TRAIN_STEPS:
        raise SmokeError("resume: state not restored bit for bit, or did not "
                         "reach the last step")

    # --- one step twice from the same state, batch, t and noise
    ds = FastSpeechDataset("train", hp, shuffle=False)
    full = [b for b in build_batches(ds, hp, rng=np.random.RandomState(0))
            if len(b) == TRAIN_B][0]
    batch = next(iter(BatchIterator(ds, [full], pad_multiple=int(
        hp["frames_multiple"]))))
    task = t2.task
    g = torch.Generator().manual_seed(7)
    t = torch.randint(0, task.model.K_step, (TRAIN_B,), generator=g)
    noise = torch.randn(batch["mels"].shape, generator=g)
    snap = copy.deepcopy(task.state_dict())
    snap["global_step"] = task.step
    bundle = os.path.join(workdir, "det_step.pt")
    torch.save({"hp": dict(hp), "snap": snap, "batch": batch, "t": t,
                "noise": noise}, bundle)
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "chip_smoke.py"),
         "--deterministic-step", bundle],
        env=dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8"),
        capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise SmokeError(f"deterministic step: exit {proc.returncode}\n"
                         f"{proc.stderr[-3000:]}")
    det = json.loads(proc.stdout.strip().splitlines()[-1])
    res["step_deterministic"] = det
    log(f"[train] one step twice from the same state, batch, t, noise (child "
        f"process, deterministic algorithms): bit-identical params "
        f"{det['identical']}, K4 launches {det['launches']}; planted fault "
        f"[the step on the next step's draws]: identical "
        f"{det['fault_identical']}")
    if not det["identical"] or det["launches"] <= 0:
        raise SmokeError(f"the same step twice gave different params, or "
                         f"did not run K4: {det}")
    if det["fault_identical"]:
        raise SmokeError(f"the planted fault passes the repeat check: {det}")

    task.load_state_dict(snap)
    if batch_route(hp, *batch["mels"].shape[:2]) != "batched":
        raise SmokeError("phase 5's step batch does not take K4's route")
    res["card_vs_plain"] = card_vs_plain_step(
        task, batch, t, noise, k4,
        [(k4, {"residual_stack_train_fwd": k4.residual_stack_train_fwd_plain,
               "residual_stack_train_batched_bwd":
               k4.residual_stack_train_batched_bwd_plain})],
        "residual_stack_train_batched_bwd", TRAIN_STEP_TOL)
    res["timing"] = time_train_steps(hp, device, batch)
    task.load_state_dict(snap)
    res["profile"] = profile_run(f"bf16 train step B={TRAIN_B} T="
                                 f"{batch['mels'].shape[1]}",
                                 lambda: task.train_step(batch))
    check_train_profile("phase 5's bf16 step (K4)", res["profile"].pop("names"),
                        "Bf16", "gate_tc_kernel<float>")
    del task, t2, trainer
    torch.cuda.empty_cache()

    # --- the trained checkpoint through the port's Svc
    ckpt = os.path.join(hp["work_dir"], want[1])
    svc = Svc("smoke_train", cfg_fn, True, ckpt, device=device)
    sd = strip_prefix(torch_load(ckpt)["state_dict"], "model.")
    if not all(torch.equal(v.cpu(), sd[k]) for k, v in
               svc.model.state_dict().items()):
        raise SmokeError("Svc did not load the trained weights")
    clip = os.path.join(workdir, "convert.wav")
    save_wav(synth.voiced_wav(6.0, sr, 220.0, [(2.5, 3.0)], seed=99), clip, sr)
    _, _, audio = infer_cli.run_clip(
        svc, key=0, acc=ACC, use_pe=False, use_crepe=False, thre=0.05,
        use_gt_mel=False, add_noise_step=500, file_path=clip,
        out_path=clip[:-4] + "_out.wav")
    src, _ = load_wav(clip)
    audio = np.asarray(audio, np.float32)
    res["svc"] = {"in_len": len(src), "out_len": len(audio),
                  "finite": bool(np.isfinite(audio).all())}
    log(f"[train] Svc with the step-{TRAIN_STEPS} checkpoint: {res['svc']}")
    if len(audio) != len(src) or not res["svc"]["finite"]:
        raise SmokeError(f"trained-checkpoint conversion: {res['svc']}")
    return res


# ---------------------------------------------------------------------------
# Phase 6: training at config_44k's own batch (max_sentences 88): K5's route
# ---------------------------------------------------------------------------

OWN_CLIPS, OWN_HELD_OUT = 96, 8   # 4-8 s clips; 88 train items: one batch
OWN_STEPS = 3
# One step at B=88 on the per-sample route (f32 streams), kernels vs plain
# versions on the card, as phase 5's check: sound 9.7e-6 on the H100; the
# planted fault, the last sample's cotangent dropped in K5's backward,
# reads 2.1e-2.
OWN_STEP_TOL = 1e-4


def own_batch_config(workdir: str, hubert_path: str, vocoder_ckpt: str):
    """config_44k at full width with base.yaml's batching (max_sentences 88,
    max_tokens 128000) and its default bf16 stream; every 12th clip held out
    for validation (B=1), so the train split is one batch of 88."""
    raw = os.path.join(workdir, "own_raw")
    return {"base_config": [os.path.join(ROOT, "configs", "config_44k.yaml")],
            "raw_data_dir": raw,
            "binary_data_dir": os.path.join(workdir, "own_bin"),
            "work_dir": os.path.join(workdir, "own_work"),
            "hubert_path": hubert_path, "vocoder_ckpt": vocoder_ckpt,
            "max_sentences": 88, "max_tokens": 128000,
            "diffnet_train_stream_dtype": "bf16",
            "max_updates": OWN_STEPS, "val_check_interval": 1000,
            "log_interval": 1, "num_valid_plots": 0, "use_crepe": False,
            "choose_test_manually": True,
            "test_prefixes": [os.path.join(raw, f"own{i:02d}") for i in
                              range(0, OWN_CLIPS, OWN_CLIPS // OWN_HELD_OUT)]}


def phase_train_own_batch(device, workdir, hubert_path, vocoder_ckpt):
    """96 synthetic clips of 4-8 s binarized by the port, then ``run_task``
    for 3 steps at config_44k's own batching: the batch of 88 must take the
    per-sample route (K5), K5's counter must equal the steps and K4's
    backward must not move, validation (B=1) runs K1; then ms/step,
    samples/s, mel frames/s and peak memory at B=88, and one step through
    the kernels against the plain versions on the card."""
    import numpy as np
    import torch
    import yaml

    from diffsvc_tpu_torch.config import set_hparams
    from diffsvc_tpu_torch.data.binarizer import binarize
    from diffsvc_tpu_torch.data.dataset import (BatchIterator,
                                                FastSpeechDataset,
                                                build_batches)
    from diffsvc_tpu_torch.ops.hopper import diffnet_stack as k1
    from diffsvc_tpu_torch.ops.hopper import diffnet_stack_per_sample as k5
    from diffsvc_tpu_torch.ops.hopper import diffnet_stack_train as k4
    from diffsvc_tpu_torch.run import run_task
    from diffsvc_tpu_torch.utils import synth
    from diffsvc_tpu_torch.utils.audio_io import save_wav

    res = {}
    cfg = own_batch_config(workdir, hubert_path, vocoder_ckpt)
    cfg_fn = os.path.join(workdir, "own.yaml")
    with open(cfg_fn, "w") as f:
        yaml.safe_dump(cfg, f)
    os.makedirs(cfg["raw_data_dir"])
    secs = np.linspace(4.0, 8.0, OWN_CLIPS)
    for i, sec in enumerate(secs):
        save_wav(synth.voiced_wav(float(sec), TRAIN_SR, 150.0 + 3.0 * i,
                                  seed=100 + i),
                 os.path.join(cfg["raw_data_dir"], f"own{i:02d}.wav"),
                 TRAIN_SR)
    t0 = time.time()
    hp = set_hparams(config=cfg_fn, exp_name="smoke_own", reset=True,
                     print_hparams=False)
    binarize(hp, device=device)
    res["binarize_s"] = time.time() - t0
    hp = set_hparams(config=cfg_fn, exp_name="smoke_own", reset=True,
                     print_hparams=False)
    ds = FastSpeechDataset("train", hp, shuffle=True)
    log(f"[own] binarized {OWN_CLIPS} clips ({float(secs.sum()):.1f} s) in "
        f"{res['binarize_s']:.2f}s; train split {len(ds)} items")
    if len(ds) != 88:
        raise SmokeError(f"train split of {len(ds)} items, expected 88")

    # the batches the trainer draws in its epochs, with their routes
    pad = int(hp["frames_multiple"])
    res["batches"] = []
    for epoch in range(OWN_STEPS):
        for idx in build_batches(ds, hp, rng=np.random.RandomState(
                int(hp["seed"]) + epoch)):
            b = len(idx)
            t = -(-int(max(ds.num_tokens(i) for i in idx)) // pad) * pad
            route = batch_route(hp, b, t)
            res["batches"].append({"epoch": epoch, "B": b, "T": t,
                                   "route": route})
            log(f"[own] epoch {epoch} batch: B={b} T={t} route {route}")
            if b != 88 or route != "per_sample":
                raise SmokeError(f"a batch of {b} on the {route} route; "
                                 "expected 88 on the per-sample route")

    # --- train through the entry point: K5 once per step, K4's backward
    # never, K1 for validation's primal
    k1.launches = k5.launches = k4.bwd_launches = 0
    t0 = time.time()
    trainer = run_task(hp, device=device)
    torch.cuda.synchronize()
    res["fit_s"] = time.time() - t0
    res["launches"] = {"residual_stack_train": k5.launches,
                       "residual_stack_train_batched (backward)":
                       k4.bwd_launches, "residual_stack": k1.launches}
    losses = [h["loss"] for h in trainer.history]
    res["losses"] = losses
    log(f"[own] run_task: {trainer.global_step} steps in {res['fit_s']:.2f}s"
        f", losses {[round(x, 5) for x in losses]}, launches "
        f"{res['launches']}")
    if trainer.global_step != OWN_STEPS or len(losses) != OWN_STEPS \
            or not np.isfinite(losses).all():
        raise SmokeError(f"training: {trainer.global_step} steps, losses "
                         f"{losses}")
    if k5.launches != OWN_STEPS or k4.bwd_launches != 0 or k1.launches <= 0:
        raise SmokeError(f"launches on the per-sample route: "
                         f"{res['launches']}")

    # --- the step's cost at B=88, and the card against the plain versions
    task = trainer.task
    batch = next(iter(BatchIterator(ds, [list(range(len(ds)))],
                                    pad_multiple=pad)))
    res["timing"] = dict(time_steps(task, batch, reps=2),
                         route=batch_route(hp, *batch["mels"].shape[:2]))
    log_steps("own", f"bf16 config, {res['timing']['route']} route", batch,
              res["timing"])
    res["profile"] = profile_run(f"train step B={len(ds)} T="
                                 f"{batch['mels'].shape[1]} (K5)",
                                 lambda: task.train_step(batch))
    check_train_profile("phase 6's step at B=88 (K5)",
                        res["profile"].pop("names"), "Tf32x3",
                        "tf32x3::gate_kernel")
    g = torch.Generator().manual_seed(8)
    t = torch.randint(0, task.model.K_step, (len(ds),), generator=g)
    noise = torch.randn(batch["mels"].shape, generator=g)
    res["card_vs_plain"] = card_vs_plain_step(
        task, batch, t, noise, k5,
        [(k4, {"residual_stack_train_fwd": k4.residual_stack_train_fwd_plain}),
         (k5, {"residual_stack_train_bwd": k5.residual_stack_train_bwd_plain})],
        "residual_stack_train_bwd", OWN_STEP_TOL, tag="own")
    del task, trainer
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# Phase 8: the rest of conversion (DDPM, CREPE, the 24 kHz profile)
# ---------------------------------------------------------------------------

# The FFT denoiser's card-vs-CPU check (phase 10) converts 0.25 s (its
# planted fault reads ~0.46 against a limit of 1e-2); FS2-full's, whose
# fault reads ~3.0e-2 against 2e-2, converts 0.5 s
CPU_SECS_CUT = 0.25
# a voiced clip of 2.5 s with no silence: one chunk, one fused bucket (215
# frames of the bucket's 256, so one capture a dtype)
DDPM_CLIP = (2.5, 262.0, [])
# the card-vs-CPU DDPM check: use_gt_mel from the input's mel q-sampled to
# step 34, then 35 DDPM steps, on 0.5 s (the denoiser's part of the
# waveform, the check's denominator, grows with the steps: 2.1e-4 of it at
# 20 steps put the f32 reading at 8.5e-3 of its 1e-2 limit, 4.8e-4 at 50 at
# 3.6e-3)
DDPM_CPU_STEPS = 35
# the sampler's wall and profile: a use_gt_mel trajectory of this many
# steps (the same step as a full trajectory's)
DDPM_PROF_STEPS = 100
# CREPE's card-vs-CPU check: its posteriors on this block of frames of the
# 14 s clip (the CPU's network costs ~2.8 GFLOP a frame)
CREPE_BLOCK = (1000, 1064)
# the network's posteriors, card against CPU, both true f32 (cuDNN's
# convolutions against MKL-DNN's, 6 layers, f32 sums in other orders)
CREPE_TOL = 1e-4
# pe on the 6.5 s clip's mel, card against CPU, both true f32
PE_TOL = 1e-4
BINARIZE_CLIPS = 6     # the binarizer keeps 1 as train, 5 as valid = test


def clip_checks(label, audio, src_len):
    """Length of the input, finite, not silent."""
    import numpy as np

    audio = np.asarray(audio, np.float32)
    peak = float(np.abs(audio).max()) if len(audio) else 0.0
    if len(audio) != src_len or not np.isfinite(audio).all() or peak < 1e-3:
        raise SmokeError(f"{label}: output of {len(audio)} samples (input "
                         f"{src_len}), finite {np.isfinite(audio).all()}, "
                         f"peak {peak}")
    return peak


def ddpm_step_times(svc, wav_fn) -> dict:
    """Sampling alone at acc=1 on the clip's batch (``model.infer``) over a
    use_gt_mel trajectory of DDPM_PROF_STEPS (the step of a full
    trajectory): wall per step (host clock ending in a sync) and, from a
    profiled run of the same trajectory, the device kernels per step and
    the device busy time per step."""
    import numpy as np
    import torch

    b = svc.pre(wav_fn, 1, use_crepe=False)
    tb = {k: torch.from_numpy(np.asarray(b[k])).to(svc.device)
          for k in ("hubert", "mels", "mel2ph", "energy", "f0", "uv")}
    n = DDPM_PROF_STEPS

    def run():
        svc.model.infer(tb, speedup=1, use_gt_mel=True, add_noise_step=n)

    run()
    torch.cuda.synchronize()
    t0 = time.time()
    run()
    torch.cuda.synchronize()
    wall = time.time() - t0
    prof = profile_run(f"{svc.hp['diff_compute_dtype'] or 'float32'} DDPM "
                       f"sampling, {n} steps at T={b['mels'].shape[1]}", run)
    return {"frames": int(b["mels"].shape[1]), "steps": n,
            "ms_per_step": wall * 1e3 / n,
            "launches_per_step": prof["device_events"] / n,
            "device_ms_per_step": prof["device_busy_ms"] / n,
            "busy_share": prof["busy_share"]}


def phase_ddpm(project, workdir, launches):
    """(a) DDPM at acc=1 on phase 4's project: a 3 s clip through run_clip,
    modular and fused graph, in bf16 and f32 (K1 one launch per step, K2
    none); ms per step, launches per step, RTF, the acc=1 bucket's capture
    and pool; a 0.5 s conversion card vs CPU with use_gt_mel at 35 steps."""
    import torch

    from diffsvc_tpu_torch import infer_cli
    from diffsvc_tpu_torch.utils import synth
    from diffsvc_tpu_torch.utils.audio_io import load_wav, save_wav

    secs, f0, gaps = DDPM_CLIP
    wav_fn = os.path.join(workdir, "ddpm_clip.wav")
    save_wav(synth.voiced_wav(secs, 44100, f0, gaps, seed=8), wav_fn, 44100)
    src_len = len(load_wav(wav_fn)[0])
    n_chunks = len(voiced_chunks(wav_fn))
    res = {"clip_s": secs, "chunks": n_chunks}
    routes = (("modular", {}), ("fused graph", {"fused": True}))

    def clip(svc, **kw):
        return infer_cli.run_clip(
            svc, key=0, acc=1, use_pe=False, use_crepe=False, thre=0.05,
            use_gt_mel=False, add_noise_step=500, file_path=wav_fn,
            out_path=wav_fn[:-4] + "_ddpm.wav", **kw)

    for dt, svc in project["svcs"].items():
        name = dt or "float32"
        k_step = svc.model.K_step
        rec = res.setdefault(name, {})
        for route, kw in routes:
            label = f"DDPM {route} {name}"
            with counted(label, launches, moved=("residual_stack",
                                                 "vocoder_tail"),
                         still=("plms_ladder",), tag="rest"):
                torch.cuda.synchronize()
                t0 = time.time()
                _, _, audio = clip(svc, **kw)
                torch.cuda.synchronize()
                wall = time.time() - t0
            k1 = launches[label]["residual_stack"]
            # a fused bucket's first call warms up once and captures: K1
            # runs the trajectory once more per new bucket
            calls = k1 / k_step
            if k1 % k_step or calls < n_chunks:
                raise SmokeError(f"{label}: K1 launched {k1} times for "
                                 f"{n_chunks} chunks of {k_step} steps")
            rec[route] = {"wall_s": wall, "rtf": wall / secs,
                          "peak": clip_checks(label, audio, src_len),
                          "k1_launches": k1, "trajectories": calls}
        # ms per step: the modular sampler alone, and a fused graph replay
        rec["sampling"] = ddpm_step_times(svc, wav_fn)
        fused = svc.fused_model(1)
        chunk = voiced_chunks(wav_fn)[0]
        svc.infer_fused(chunk, key=0, acc=1)
        torch.cuda.synchronize()
        t0 = time.time()
        svc.infer_fused(chunk, key=0, acc=1)
        torch.cuda.synchronize()
        rec["fused_chunk_ms_per_step"] = (time.time() - t0) * 1e3 / k_step
        prof = profile_run(f"{name} DDPM fused graph replay, one chunk",
                           lambda: svc.infer_fused(chunk, key=0, acc=1))
        rec["fused_launches_per_step"] = prof["device_events"] / k_step
        rec["captures"] = {str(k[:2]): {"warmup_s": w, "capture_s": c,
                                        "pool_mib": fused.pool_bytes()[k]
                                        / 2 ** 20}
                           for k, (w, c) in fused.capture_seconds().items()}
        # the fused route again, warm (the bucket captured); the modular
        # route's warm step is the sampler's, above
        torch.cuda.synchronize()
        t0 = time.time()
        clip(svc, fused=True)
        torch.cuda.synchronize()
        rec["fused graph"]["rtf_warm"] = (time.time() - t0) / secs
        smp = rec["sampling"]
        log(f"[rest] DDPM {name}: {secs:.1f}s clip ({n_chunks} chunk) RTF "
            f"modular {rec['modular']['rtf']:.4f}, fused graph "
            f"{rec['fused graph']['rtf_warm']:.4f} (first, with its "
            f"captures, {rec['fused graph']['rtf']:.4f}); sampling alone "
            f"{smp['ms_per_step']:.4f} ms/step at T={smp['frames']}, "
            f"{smp['launches_per_step']:.1f} launches/step, device "
            f"{smp['device_ms_per_step']:.4f} ms/step (busy share "
            f"{smp['busy_share']:.3f}; over a {smp['steps']}-step "
            f"trajectory); fused chunk replay "
            f"{rec['fused_chunk_ms_per_step']:.4f} ms/step, "
            f"{rec['fused_launches_per_step']:.1f} device events/step; "
            "captures "
            f"{ {k: {kk: round(vv, 3) for kk, vv in v.items()} for k, v in rec['captures'].items()} }")
        # the denoiser's part of this waveform is ~5e-4 of it, below what
        # the AC tracker's device difference moves: the CPU's track on both
        # sides (phase 4 holds the card's tracker, at acc=20)
        rec["cpu_agreement"] = cpu_agreement(
            svc, project["cfg_fn"], project["ckpt"], project["wavs"][0],
            acc=1, tag="DDPM", same_f0=True, use_gt_mel=True,
            add_noise_step=DDPM_CPU_STEPS)
    return res


def crepe_binarize_tags(device, project, workdir, crepe_path):
    """Binarize config_44k as shipped (``use_crepe: true``) on a few clips,
    with CREPE's weights at ``crepe_path`` and without: the tracker each
    item used."""
    import numpy as np
    import yaml

    from diffsvc_tpu_torch.config import set_hparams
    from diffsvc_tpu_torch.data import features
    from diffsvc_tpu_torch.data.binarizer import binarize
    from diffsvc_tpu_torch.utils import synth
    from diffsvc_tpu_torch.utils.audio_io import save_wav

    with open(project["cfg_fn"]) as f:
        proj = yaml.safe_load(f)
    raw = os.path.join(workdir, "raw_crepe")
    os.makedirs(raw)
    for i in range(BINARIZE_CLIPS):
        save_wav(synth.voiced_wav(2.0, 44100, 180.0 + 20 * i, seed=20 + i),
                 os.path.join(raw, f"c{i}.wav"), 44100)
    real, tags = features.get_pitch, {}
    out = {}
    for have in (True, False):
        label = "with weights" if have else "without weights"
        cfg = {"base_config": [os.path.join(ROOT, "configs",
                                            "config_44k.yaml")],
               "raw_data_dir": raw,
               "binary_data_dir": os.path.join(workdir, f"bin_{int(have)}"),
               "hubert_path": proj["hubert_path"],
               "vocoder_ckpt": proj["vocoder_ckpt"],
               "crepe_path": crepe_path if have else
               os.path.join(workdir, "no_crepe", "full.pth")}
        cfg_fn = os.path.join(workdir, f"crepe_{int(have)}.yaml")
        with open(cfg_fn, "w") as f:
            yaml.safe_dump(cfg, f)
        hp = set_hparams(config=cfg_fn, exp_name="smoke_crepe", reset=True,
                         print_hparams=False)
        if not hp["use_crepe"]:
            raise SmokeError("config_44k as shipped does not ask for CREPE")
        got = tags.setdefault(label, [])

        def spy(*args, **kw):
            f0, coarse, tag = real(*args, **dict(kw, return_tag=True))
            got.append(tag)
            return f0, coarse

        features.get_pitch = spy
        try:
            t0 = time.time()
            binarize(hp, device=device)
            secs = time.time() - t0
        finally:
            features.get_pitch = real
        lengths = np.load(os.path.join(cfg["binary_data_dir"],
                                       "train_lengths.npy"))
        want = "crepe" if have else "ac"
        out[label] = {"tags": got, "binarize_s": secs,
                      "train_items": int(len(lengths))}
        log(f"[rest] binarize config_44k as shipped ({BINARIZE_CLIPS} clips, "
            f"{label}): f0 trackers {got}, {len(lengths)} train items, "
            f"{secs:.2f}s")
        # the valid and test splits are the same items: each is tracked
        # once per split it is in
        if len(got) < BINARIZE_CLIPS or set(got) != {want} or \
                len(lengths) < 1:
            raise SmokeError(f"binarize {label}: trackers {got} (want "
                             f"{want} for every item)")
    return out


def phase_crepe(device, project, workdir):
    """(b) CREPE on the card: the 14 s clip through get_pitch (network,
    Viterbi), its parts timed; posteriors card vs CPU on a block of frames;
    the binarizer on config_44k as shipped, with and without weights."""
    import numpy as np
    import torch

    from diffsvc_tpu_torch.data import features
    from diffsvc_tpu_torch.ops import crepe
    from diffsvc_tpu_torch.utils import synth
    from diffsvc_tpu_torch.utils.audio_io import load_wav, resample

    path = os.path.join(workdir, "crepe", "full.pth")
    synth.write_crepe(path, seed=4)
    model = crepe.load_crepe(path, device)
    wav, sr = load_wav(project["wavs"][-1])
    hp = dict(project["svcs"][""].hp, crepe_path=path)
    mel = np.zeros((1 + len(wav) // int(hp["hop_size"]), 1), np.float32)
    # the first call of the process on 1 s: cuDNN's benchmark chooses the
    # network's algorithms for its one chunk shape
    torch.cuda.synchronize()
    t0 = time.time()
    features.get_pitch(wav[: sr], mel[: 1 + sr // int(hp["hop_size"])], hp,
                       True, device=device)
    torch.cuda.synchronize()
    first_ms = (time.time() - t0) * 1e3
    t0 = time.time()
    f0, _, tag = features.get_pitch(wav, mel, hp, True, device=device,
                                    return_tag=True)
    torch.cuda.synchronize()
    total_ms = (time.time() - t0) * 1e3
    wav16 = torch.from_numpy(resample(wav, sr, crepe.SR)).to(device)
    frames = crepe.frame_audio(wav16)
    net_ms = cuda_time_ms(lambda: crepe.posteriors(model, frames), reps=3)
    probs = crepe.posteriors(model, frames)
    torch.cuda.synchronize()
    t0 = time.time()
    crepe._viterbi(probs)
    torch.cuda.synchronize()
    viterbi_ms = (time.time() - t0) * 1e3
    n = int(frames.shape[0])
    flops = 0.0
    t_len, c_in = crepe.WINDOW, 1
    for f, k, st in zip(crepe.FILTERS, crepe.KERNELS, crepe.STRIDES):
        t_len = t_len // st
        flops += 2.0 * c_in * f * k * t_len
        t_len, c_in = t_len // 2, f
    flops = n * (flops + 2.0 * 2048 * crepe.N_BINS)
    # the posteriors of a block, card against CPU, and the f0 each decodes
    lo, hi = CREPE_BLOCK
    cpu = crepe.load_crepe(path, "cpu")
    ref = crepe.posteriors(cpu, frames[lo:hi].cpu())
    got = probs[lo:hi]
    rel = rel_l2(got.cpu(), ref)
    f0_dev = crepe.decode(got)[0].cpu()
    f0_cpu = crepe.decode(ref)[0]
    agree = float(((f0_dev - f0_cpu).abs() <= 1e-4 * f0_cpu).double().mean())
    res = {"tag": tag, "frames": n, "ms": total_ms, "first_call_1s_ms":
           first_ms, "network_ms": net_ms,
           "viterbi_ms": viterbi_ms, "network_flops": flops,
           "network_bound_ms": bound(flops, nbytes(frames, probs),
                                     "f32")["bound_ms"],
           "voiced_share": float((f0 > 0).mean()),
           "posteriors_rel_l2": rel, "tol_rel_l2": CREPE_TOL,
           "f0_agree_share": agree, "block": [lo, hi]}
    log(f"[rest] CREPE on the {len(wav) / sr:.1f}s clip ({n} frames): "
        f"get_pitch {total_ms:.1f} ms (tracker {tag}), of which the network "
        f"{net_ms:.1f} ms ({flops / 1e12:.2f} TFLOP; bound at the CUDA "
        f"cores' f32 rate {res['network_bound_ms']:.1f} ms) and the Viterbi "
        f"{viterbi_ms:.1f} ms ({n - 1} sequential steps on the card, "
        f"traced back on the host); voiced {res['voiced_share']:.3f}; the "
        f"process's first call, on 1 s, with cuDNN's benchmark: "
        f"{first_ms:.1f} ms")
    log(f"[rest] CREPE posteriors card vs CPU on frames {lo}-{hi}: rel_l2 "
        f"{rel:.3e} (tol {CREPE_TOL:g}); f0 decoded on each side agrees to "
        f"1e-4 on {agree:.4f} of the frames")
    if tag != "crepe":
        raise SmokeError(f"CREPE with weights gave the {tag} tracker")
    if not rel <= CREPE_TOL:
        raise SmokeError(f"CREPE's posteriors disagree card vs CPU: {rel}")
    res["binarize"] = crepe_binarize_tags(device, project, workdir, path)
    return res


def phase_24k(device, workdir, launches):
    """(c) A config_24k project at full width (DiffNet 256 x 20, 80 mel,
    HuBERT-soft 768 x 12, pe, HiFi-GAN V1, ContentVec 768 x 12): the 6.5 s
    clip through the modular (pe), batched (pe) and fused-graph routes in
    bf16 and f32 (K2 and K3 moving on each), card vs CPU at phase 4's limits
    with a planted fault, pe's time and card-vs-CPU agreement, ContentVec's
    time beside HuBERT-soft's and one conversion through it."""
    import numpy as np
    import torch

    from diffsvc_tpu_torch import infer_cli
    from diffsvc_tpu_torch.infer.hubert_encoder import Hubertencoder
    from diffsvc_tpu_torch.infer.svc import Svc
    from diffsvc_tpu_torch.models import pe as pe_model
    from diffsvc_tpu_torch.models.hubert import HubertConfig
    from diffsvc_tpu_torch.utils import synth
    from diffsvc_tpu_torch.utils.audio_io import load_wav, save_wav

    sr = 24000
    t0 = time.time()
    cfg_fn, ckpt = synth.write_project(
        os.path.join(workdir, "proj24"),
        {"base_config": [os.path.join(ROOT, "configs", "config_24k.yaml")]},
        VOC24_H, hubert_cfg=HubertConfig(), pe=True,
        vec_cfg=HubertConfig())
    log(f"[rest] wrote the config_24k project in {time.time() - t0:.2f}s")
    secs, f0, gaps = CLIPS[0]
    wav_fn = os.path.join(workdir, "clip24.wav")
    save_wav(synth.voiced_wav(secs, sr, f0, gaps, seed=2), wav_fn, sr)
    short = os.path.join(workdir, "clip24_short.wav")
    save_wav(synth.voiced_wav(2.0, sr, f0, seed=3), short, sr)
    src_len = len(load_wav(wav_fn)[0])
    n_chunks = len(voiced_chunks(wav_fn))
    res = {"routes": {}}
    svcs = {}
    for dt in ("bfloat16", ""):
        svcs[dt] = Svc("proj24", cfg_fn, True, ckpt, device=device)
        svcs[dt].hp["diff_compute_dtype"] = dt
        if svcs[dt].pe is None:
            raise SmokeError("the config_24k project's pe did not load")
        svcs[dt].infer(short, key=0, acc=ACC, use_pe=True, use_crepe=False)

    def clip(svc, **route):
        return infer_cli.run_clip(
            svc, key=0, acc=ACC, use_pe=True, use_crepe=False, thre=0.05,
            use_gt_mel=False, add_noise_step=500, file_path=wav_fn,
            out_path=wav_fn[:-4] + "_out.wav", **route)

    for dt, svc in svcs.items():
        name = dt or "float32"
        routes = res["routes"].setdefault(name, {})
        for route, kw in (("modular", {}), ("batched",
                                            {"batch_chunks": True}),
                          ("fused graph", {"fused": True})):
            label = f"24k {route} {name}"
            with counted(label, launches, tag="rest"):
                _, _, audio = clip(svc, **kw)
            clip_checks(label, audio, src_len)
            pools = sum(svc.fused_model(ACC).pool_bytes().values()) \
                if "fused" in kw else 0
            routes[route] = route_run(f"24k {route} {name}", secs, n_chunks,
                                      lambda kw=kw: clip(svc, **kw), pools)
        res.setdefault("cpu_agreement", {})[name] = cpu_agreement(
            svc, cfg_fn, ckpt, wav_fn, tag="24k")
    # pe on the clip's mel: time, and card against CPU
    svc = svcs[""]
    b = svc.pre(wav_fn, ACC, use_crepe=False)
    mel = torch.from_numpy(np.asarray(b["mels"])).to(device)
    pe_ms = cuda_time_ms(lambda: svc.pe(mel), reps=5)
    pe_cpu = pe_model.load(svc.hp["pe_ckpt"], svc.hp, "cpu")
    pe_rel = rel_l2(svc.pe(mel)["pitch_pred"].cpu(),
                    pe_cpu(mel.cpu())["pitch_pred"])
    res["pe"] = {"ms": pe_ms, "frames": int(mel.shape[1]),
                 "rel_l2": pe_rel, "tol_rel_l2": PE_TOL}
    log(f"[rest] pe on the {secs:.1f}s clip's mel ({mel.shape[1]} frames): "
        f"{pe_ms:.3f} ms; card vs CPU rel_l2 {pe_rel:.3e} (tol {PE_TOL:g})")
    if not pe_rel <= PE_TOL:
        raise SmokeError(f"pe disagrees card vs CPU: {pe_rel}")
    # ContentVec beside HuBERT-soft, then one conversion through it
    vec = Hubertencoder(svc.hp["hubert_path"],
                        hp=dict(svc.hp, use_vec=True), device=device)
    wav16, _ = load_wav(wav_fn, sr=16000)
    times = {}
    for label, enc in (("hubert_soft", svc.hubert), ("contentvec", vec)):
        enc.encode(wav16[:32000])
        times[label] = cuda_time_ms(lambda enc=enc: enc.encode(wav16),
                                    reps=3)
    res["encoders_ms"] = times
    svc.hubert = vec
    with counted("24k modular float32 ContentVec", launches, tag="rest"):
        _, _, audio = clip(svc)
    res["contentvec_peak"] = clip_checks("24k ContentVec", audio, src_len)
    log(f"[rest] content encoders on the {secs:.1f}s clip: HuBERT-soft "
        f"{times['hubert_soft']:.2f} ms, ContentVec {times['contentvec']:.2f}"
        " ms (layer 9 of 12); a modular conversion through ContentVec passed"
        " its output checks")
    return res


def phase_rest(device, project, workdir):
    """Phase 8 on phase 4's project, a CREPE checkpoint and a config_24k
    project."""
    launches, seconds = {}, {}
    res = {"launches": launches, "seconds": seconds}
    for part, fn in (("ddpm", lambda: phase_ddpm(project, workdir, launches)),
                     ("crepe", lambda: phase_crepe(device, project, workdir)),
                     ("24k", lambda: phase_24k(device, workdir, launches))):
        t0 = time.time()
        res[part] = fn()
        seconds[part] = time.time() - t0
    log(f"[rest] phase 8 took { {k: round(v, 1) for k, v in seconds.items()} }s")
    return res


# ---------------------------------------------------------------------------
# Phase 9: the rest of single-card training and the data inventory
# ---------------------------------------------------------------------------

RADAM_STEPS = 7          # b2 = 0.98: steps 6 and 7 take the rectified branch
# The port's RAdam (in-place updates on the card) against optax's update
# written out on whole tensors on the card, steps 1-7 on fixed grads:
# rel-L2 of the parameters' total update.  The planted fault drops the
# rectification term (r_t = 1), i.e. Adam's update from step 6.
RADAM_TOL = 1e-6
# One pe step against the same step in float64 on the CPU (the same init
# and batch): the loss and each parameter's grad, rel-L2.  The grads are
# read on pe's smooth twin (every ReLU as softplus(x, beta=50), the f64
# step likewise): with ReLU, an input within rounding of 0 takes the other
# branch in f32 than in f64 and passes the whole upstream grad, which
# reads 3e-5 to 5e-4 on the card and on the CPU alike, moving with the
# init seed; the smooth twin reads the arithmetic, 1.3e-5 on the H100
# (1.6e-5 on the CPU; tools/pe_step_error.py).  The planted fault leaves
# pe's convolutions at cuDNN's default TF32 (2.8e-3 to 9.0e-3).
PE_STEP_TOL = 1e-4
PE_CLIPS, PE_SR = 16, 24000      # synthetic clips of 3-6 s for the pe task


def radam_plain(p0, grads, lrs, b1, b2, eps=1e-8, threshold=5.0):
    """optax.radam's update written out on whole tensors, step by step."""
    p, m, v = p0.clone(), 0.0 * p0, 0.0 * p0
    rho_inf = 2.0 / (1.0 - b2) - 1.0
    for t, (g, lr) in enumerate(zip(grads, lrs), start=1):
        m = (1.0 - b1) * g + b1 * m
        v = (1.0 - b2) * g * g + b2 * v
        m_hat, v_hat = m / (1.0 - b1 ** t), v / (1.0 - b2 ** t)
        rho = rho_inf - 2.0 * t * b2 ** t / (1.0 - b2 ** t)
        if rho >= threshold:
            r = ((rho - 4.0) * (rho - 2.0) * rho_inf
                 / ((rho_inf - 4.0) * (rho_inf - 2.0) * rho)) ** 0.5
            m_hat = r * m_hat / (v_hat.sqrt() + eps)
        p = p - lr * m_hat
    return p


def radam_vs_plain(task) -> dict:
    """The task's RAdam on the card, 7 steps on fixed random grads at the
    task's schedule over as many values as the task has parameters, against
    :func:`radam_plain`; and with the rectification dropped.  The values
    start at 0 (RAdam's update does not read them), so the check reads the
    update itself: from the trained parameters, their own rounding at each
    step (an ulp of ~0.05 is ~1e-6 of a 7-step update) would read 1.7e-6
    on the H100."""
    import torch

    from diffsvc_tpu_torch.training import task as task_mod

    b1, b2 = task.optimizer.param_groups[0]["betas"]
    p0 = torch.zeros(sum(p.numel() for p in task.params),
                     device=task.params[0].device)
    g = torch.Generator(device=p0.device).manual_seed(3)
    grads = [torch.randn(p0.shape, generator=g, device=p0.device) * 1e-3
             for _ in range(RADAM_STEPS)]
    lrs = [task.lr_schedule(s) for s in range(RADAM_STEPS)]

    def port():
        p = torch.nn.Parameter(p0.clone())
        opt = task_mod.RAdam([p], lr=lrs[0], betas=(b1, b2))
        for grad, lr in zip(grads, lrs):
            p.grad = grad.clone()
            opt.param_groups[0]["lr"] = lr
            opt.step()
        return p.detach()

    ref = radam_plain(p0, grads, lrs, b1, b2) - p0
    rel = rel_l2(port() - p0, ref)
    rect = task_mod.rectification
    with swapped(task_mod, rectification=lambda t, b2, th=5.0: (
            None if rect(t, b2, th) is None else 1.0)):
        fault = rel_l2(port() - p0, ref)
    res = {"rel_l2": rel, "fault_rel_l2": fault, "tol": RADAM_TOL,
           "params": int(p0.numel()), "steps": RADAM_STEPS}
    log(f"[train2] RAdam on the card vs optax's update written out, steps "
        f"1-{RADAM_STEPS} on {p0.numel()} parameters: rel_l2 {rel:.3e} (tol "
        f"{RADAM_TOL:g}); planted fault [rectification dropped: "
        f"{fault:.3e}]")
    if not rel <= RADAM_TOL:
        raise SmokeError(f"RAdam disagrees with optax's formula: {res}")
    if not fault > RADAM_TOL:
        raise SmokeError(f"the planted RAdam fault passes: {res}")
    return res


def update_ms(task) -> dict:
    """Device time of one optimizer update alone on copies of the task's
    parameters with fixed grads: the port's RAdam beside the AdamW that
    the task builds otherwise (PyTorch's multi-tensor path)."""
    import torch

    from diffsvc_tpu_torch.training.task import RAdam

    g = torch.Generator(device=task.params[0].device).manual_seed(4)
    params = [torch.nn.Parameter(p.detach().clone()) for p in task.params]
    for p in params:
        p.grad = torch.randn(p.shape, generator=g, device=p.device) * 1e-3
    lr, betas = task.lr_schedule(0), task.optimizer.param_groups[0]["betas"]
    opts = {"radam": RAdam(params, lr=lr, betas=betas, eps=1e-8),
            "adamw": torch.optim.AdamW(params, lr=lr, betas=betas, eps=1e-8,
                                       weight_decay=0.0)}
    res = {name: cuda_time_ms(opt.step, reps=10) for name, opt in
           opts.items()}
    log(f"[train2] one optimizer update alone on {len(params)} tensors "
        f"({sum(p.numel() for p in params)} values): RAdam "
        f"{res['radam']:.3f} ms, AdamW {res['adamw']:.3f} ms")
    return res


def restored_bit_exact(task, ckpt_fn) -> bool:
    """Params and every optimizer state tensor of ``task`` equal the
    checkpoint's, bit for bit."""
    import torch

    from diffsvc_tpu_torch.utils.convert import torch_load

    saved = torch_load(ckpt_fn)
    now = task.state_dict()
    same = all(torch.equal(v, now["state_dict"][k])
               for k, v in saved["state_dict"].items())
    o_saved = saved["optimizer_states"][0]["state"]
    o_now = task.optimizer.state_dict()["state"]
    return same and len(o_saved) == len(o_now) > 0 and all(
        torch.equal(v.cpu(), o_now[i][k].cpu())
        for i, st in o_saved.items() for k, v in st.items())


def step_batch(hp):
    """The largest training batch of the config's batching, as the trainer
    feeds it (with its ``sample_mask``)."""
    import numpy as np

    from diffsvc_tpu_torch.data.dataset import (BatchIterator,
                                                FastSpeechDataset,
                                                _pad_batch_dim, build_batches)

    ds = FastSpeechDataset("train", hp, shuffle=False)
    full = max(build_batches(ds, hp, rng=np.random.RandomState(0)), key=len)
    batch = next(iter(BatchIterator(ds, [full], pad_multiple=int(
        hp["frames_multiple"]))))
    return _pad_batch_dim(batch, batch["nsamples"])


def phase_radam(device, workdir, cfg_fn, launches):
    """(a) ``optimizer: radam`` through run_task for 7 steps at phase 5's
    batching (bf16 stream, K4; validation's loss on K1, once per
    validation batch), the update against optax's formula on the card with
    its fault, a restart from step 3, ms per step."""
    import shutil

    import numpy as np
    import torch

    from diffsvc_tpu_torch.config import HParams, set_hparams
    from diffsvc_tpu_torch.run import run_task
    from diffsvc_tpu_torch.training.task import RAdam, SVCTask
    from diffsvc_tpu_torch.training.trainer import Trainer

    hp = HParams(dict(set_hparams(config=cfg_fn, exp_name="smoke_radam",
                                  reset=True, print_hparams=False),
                      optimizer="radam", max_updates=RADAM_STEPS,
                      work_dir=os.path.join(workdir, "work_radam")))
    res = {}
    val_calls = {"n": 0}
    val_step = SVCTask.val_step

    def counting_val_step(self, batch):
        val_calls["n"] += 1
        return val_step(self, batch)

    label = "radam run_task"
    t0 = time.time()
    with swapped(SVCTask, val_step=counting_val_step), \
            counted(label, launches, tag="train2",
                    moved=("residual_stack_train_batched", "residual_stack"),
                    still=("plms_ladder", "vocoder_tail",
                           "residual_stack_train", "fused_residual_block")):
        trainer = run_task(hp)
    res["fit_s"] = time.time() - t0
    counts = launches[label]
    res["launches"] = counts
    res["val_steps"] = val_calls["n"]
    losses = [h["loss"] for h in trainer.history]
    res["losses"] = losses
    log(f"[train2] radam run_task: {trainer.global_step} steps in "
        f"{res['fit_s']:.2f}s, losses {[round(x, 5) for x in losses]}, K4 "
        f"launches {counts['residual_stack_train_batched']}, K1 "
        f"{counts['residual_stack']} for {val_calls['n']} validation "
        f"batches; optimizer {type(trainer.task.optimizer).__name__}")
    if not isinstance(trainer.task.optimizer, RAdam) \
            or len(losses) != RADAM_STEPS or not np.isfinite(losses).all() \
            or counts["residual_stack"] != val_calls["n"]:
        raise SmokeError(f"radam training: {res}")
    res["vs_plain"] = radam_vs_plain(trainer.task)
    # a restart from the step-3 checkpoint, then on to the last step
    ckpt3 = os.path.join(hp["work_dir"], f"model_ckpt_steps_{VAL_EVERY}.ckpt")
    work2 = os.path.join(workdir, "work_radam_resume")
    os.makedirs(work2)
    shutil.copy(ckpt3, work2)
    t2 = Trainer(HParams(dict(hp, work_dir=work2)), device=device)
    same = t2.restore() and t2.task.step == VAL_EVERY \
        and restored_bit_exact(t2.task, ckpt3)
    t2.fit()
    res["restore_bit_exact"] = bool(same)
    log(f"[train2] radam resume from step {VAL_EVERY}: params + optimizer "
        f"state bit-exact {same}; trained on to step {t2.global_step}")
    if not same or t2.global_step != RADAM_STEPS:
        raise SmokeError("radam resume: state not restored bit for bit")
    batch = step_batch(hp)
    res["timing"] = time_steps(t2.task, batch, reps=3)
    log_steps("train2", "radam, bf16 streams", batch, res["timing"])
    res["update_ms"] = update_ms(t2.task)
    del trainer, t2
    torch.cuda.empty_cache()
    return res


def pe_config(workdir: str) -> dict:
    """config_24k (pe at its width: hidden 256, 2 conv layers, 80 mel) on
    16 synthetic clips, the AC tracker, the pe task."""
    return {"base_config": [os.path.join(ROOT, "configs", "config_24k.yaml")],
            "raw_data_dir": os.path.join(workdir, "raw24"),
            "binary_data_dir": os.path.join(workdir, "bin24"),
            "work_dir": os.path.join(workdir, "work_pe"),
            "hubert_path": os.path.join(workdir, "hubert", "hubert_soft.pt"),
            "task_cls": "training.pe.PitchExtractionTask",
            "max_sentences": 8, "max_updates": 4, "val_check_interval": 4,
            "log_interval": 1, "num_valid_plots": 0, "use_crepe": False}


@contextlib.contextmanager
def smooth_relus():
    """Every ReLU of pe (``torch.relu`` and ``nn.ReLU``'s ``F.relu``) as
    ``softplus(x, beta=50)`` inside the block."""
    import torch
    import torch.nn.functional as F

    def soft(x, inplace=False):
        return F.softplus(x, beta=50.0)

    with swapped(torch, relu=soft), swapped(F, relu=soft):
        yield


@contextlib.contextmanager
def smooth_leaky_relus(beta=50.0):
    """Every leaky ReLU (``F.leaky_relu``, the HiFi-GAN generator's and its
    discriminators') as ``s x + (1 - s) softplus(x, beta)`` inside the
    block."""
    import torch.nn.functional as F

    softplus = F.softplus

    def soft(x, negative_slope=0.01, inplace=False):
        return (negative_slope * x
                + (1.0 - negative_slope) * softplus(x, beta=beta))

    with swapped(F, leaky_relu=soft):
        yield


def pe_step(hp, batch, device, f64=False, seed=None):
    """(loss, grads) of one pe step from the task's init (or the init of
    ``seed``), on the CPU as float64 tensors; with ``f64`` the step itself
    runs in float64."""
    from diffsvc_tpu_torch.training.pe_task import PitchExtractionTask

    task = PitchExtractionTask(hp, device=device)
    if seed is not None:
        task.init_state(seed)
    if f64:
        task.model.double()
    loss, _, grads = task.loss_and_grads(batch)
    return loss.cpu().double().reshape(1), [g.cpu().double() for g in grads]


def write_pe_data(workdir: str) -> str:
    """:func:`pe_config`'s yaml and its 16 clips of 3-6 s at 24 kHz; the
    config's path."""
    import numpy as np
    import yaml

    from diffsvc_tpu_torch.utils import synth
    from diffsvc_tpu_torch.utils.audio_io import save_wav

    cfg = pe_config(workdir)
    cfg_fn = os.path.join(workdir, "pe.yaml")
    with open(cfg_fn, "w") as f:
        yaml.safe_dump(cfg, f)
    os.makedirs(cfg["raw_data_dir"])
    for i, s in enumerate(np.linspace(3.0, 6.0, PE_CLIPS)):
        save_wav(synth.voiced_wav(float(s), PE_SR, 140.0 + 15.0 * i,
                                  [(1.0, 1.3)], seed=50 + i),
                 os.path.join(cfg["raw_data_dir"], f"pe{i:02d}.wav"), PE_SR)
    return cfg_fn


def pe_step_vs_f64(hp, device, batch) -> dict:
    """One pe step's loss and every parameter's grad, the card's and the
    CPU's, each against the same step in float64 on the CPU; the gate on
    the card's loss and on its smooth twin's loss and grads (see
    PE_STEP_TOL), and the card's step time.  The card's steps run under
    PyTorch's default ``cudnn.allow_tf32`` (True), as a user's training
    does: the task itself must keep its forward and backward convolutions
    true f32."""
    import torch

    from diffsvc_tpu_torch.models import nn as fnn
    from diffsvc_tpu_torch.training.pe_task import PitchExtractionTask

    names = PitchExtractionTask(hp, device="cpu").names

    def read(run, ref):
        rels = sorted(((rel_l2(a, b), n) for n, a, b in
                       zip(names, run[1], ref[1])), reverse=True)
        return {"loss": rel_l2(run[0], ref[0]), "grad": rels[0][0],
                "worst": [(n, r) for r, n in rels[:3]]}

    res = {}
    for smooth in (False, True):
        tag = "smooth" if smooth else "relu"
        with smooth_relus() if smooth else contextlib.nullcontext():
            ref = pe_step(hp, batch, "cpu", f64=True)
            with swapped(torch.backends.cudnn, allow_tf32=True):
                res[f"card_{tag}"] = read(pe_step(hp, batch, device), ref)
            res[f"cpu_{tag}"] = read(pe_step(hp, batch, "cpu"), ref)
            if smooth:
                # the planted fault: pe's convolutions at the default TF32
                with swapped(fnn, true_f32_convs=contextlib.nullcontext), \
                        swapped(torch.backends.cudnn, allow_tf32=True):
                    res["fault_smooth"] = read(pe_step(hp, batch, device),
                                               ref)
    rel = max(res["card_relu"]["loss"], res["card_smooth"]["loss"],
              res["card_smooth"]["grad"])
    fault = res["fault_smooth"]["grad"]
    timing = time_steps(PitchExtractionTask(hp, device=device), batch,
                        reps=5)
    res.update(rel_l2=rel, tol=PE_STEP_TOL, fault_rel_l2=fault,
               timing=timing)

    def show(r):
        return (f"loss {r['loss']:.3e}, largest grad {r['grad']:.3e} "
                f"{[(n, f'{e:.2e}') for n, e in r['worst']]}")

    for key in ("card_relu", "cpu_relu", "card_smooth", "cpu_smooth"):
        log(f"[train2] pe step vs f64 on the CPU, {key}: {show(res[key])}")
    log(f"[train2] pe step gate: the card's loss and its smooth twin's loss "
        f"and grads {rel:.3e} (tol {PE_STEP_TOL:g}); the ReLU model's grads"
        f" not gated (branch flips, the CPU's alike); planted fault "
        f"[convolutions at cuDNN's default TF32: {fault:.3e}]")
    log_steps("train2", "pe task step", batch, timing)
    if not rel <= PE_STEP_TOL:
        raise SmokeError(f"the pe step disagrees with f64: {res}")
    if not fault > PE_STEP_TOL:
        raise SmokeError(f"the planted pe fault passes: {res}")
    return res


def phase_pe(device, workdir, launches):
    """(b) The pe task at config_24k's pe width: 16 clips binarized at 24
    kHz, run_task with the pe task_cls, one step against f64 on the CPU,
    and the step's checkpoint as a config_24k Svc's pe_ckpt converting
    the 14 s clip with use_pe (K2 and K3 moving)."""
    import numpy as np
    import torch

    from diffsvc_tpu_torch import infer_cli
    from diffsvc_tpu_torch.config import set_hparams
    from diffsvc_tpu_torch.data.binarizer import binarize
    from diffsvc_tpu_torch.infer.svc import Svc
    from diffsvc_tpu_torch.models.hubert import HubertConfig
    from diffsvc_tpu_torch.run import run_task
    from diffsvc_tpu_torch.training import checkpoint as ckpt_lib
    from diffsvc_tpu_torch.training.pe_task import PitchExtractionTask
    from diffsvc_tpu_torch.utils import synth
    from diffsvc_tpu_torch.utils.audio_io import load_wav, save_wav

    cfg_fn = write_pe_data(workdir)
    hp = set_hparams(config=cfg_fn, exp_name="smoke_pe", reset=True,
                     print_hparams=False)
    t0 = time.time()
    binarize(hp, device=device)
    res = {"binarize_s": time.time() - t0}
    hp = set_hparams(config=cfg_fn, exp_name="smoke_pe", reset=True,
                     print_hparams=False)
    t0 = time.time()
    # pe has no kernel of its own: its training launches none of K1-K6
    with counted("pe run_task", launches, moved=(), still=ALL_KERNELS,
                 tag="train2"):
        trainer = run_task(hp)
    res["fit_s"] = time.time() - t0
    losses = [h["loss"] for h in trainer.history]
    res["losses"] = losses
    log(f"[train2] pe task (config_24k, hidden {hp['hidden_size']}, "
        f"{trainer.task.conv_layers} conv layers, {hp['audio_num_mel_bins']} "
        f"mel): binarized {PE_CLIPS} clips in {res['binarize_s']:.2f}s; "
        f"{trainer.global_step} steps in {res['fit_s']:.2f}s, losses "
        f"{[round(x, 5) for x in losses]}")
    if not isinstance(trainer.task, PitchExtractionTask) \
            or len(losses) != hp["max_updates"] \
            or not np.isfinite(losses).all():
        raise SmokeError(f"pe training: {res}")
    res["vs_f64"] = pe_step_vs_f64(hp, device, step_batch(hp))
    ckpt = ckpt_lib.latest_checkpoint(hp["work_dir"])
    trained = {k: v.detach().cpu()
               for k, v in trainer.task.model.state_dict().items()}
    del trainer
    torch.cuda.empty_cache()
    # the trained pe as a config_24k Svc's pe_ckpt
    t0 = time.time()
    proj_cfg, proj_ckpt = synth.write_project(
        os.path.join(workdir, "proj24pe"),
        {"base_config": [os.path.join(ROOT, "configs", "config_24k.yaml")],
         "pe_ckpt": ckpt}, VOC24_H, hubert_cfg=HubertConfig())
    svc = Svc("proj24pe", proj_cfg, True, proj_ckpt, device=device)
    if svc.pe is None or not all(torch.equal(v.cpu(), trained[k]) for k, v
                                 in svc.pe.state_dict().items()):
        raise SmokeError("Svc did not load the trained pe as pe_ckpt")
    secs, f0, gaps = CLIPS[SERVE_CLIP]
    wav_fn = os.path.join(workdir, "clip24pe.wav")
    save_wav(synth.voiced_wav(secs, PE_SR, f0, gaps, seed=2), wav_fn, PE_SR)
    with counted("24k modular float32, the trained pe", launches,
                 tag="train2"):
        _, _, audio = infer_cli.run_clip(
            svc, key=0, acc=ACC, use_pe=True, use_crepe=False, thre=0.05,
            use_gt_mel=False, add_noise_step=500, file_path=wav_fn,
            out_path=wav_fn[:-4] + "_out.wav")
    res["svc_peak"] = clip_checks("24k with the trained pe", audio,
                                  len(load_wav(wav_fn)[0]))
    res["svc_s"] = time.time() - t0
    log(f"[train2] the trained pe loaded as pe_ckpt (svc.pe set, weights "
        f"equal) and converted the {secs:.0f}s clip with use_pe")
    return res


def phase_infer(device, workdir, cfg_fn, launches):
    """(c) ``--infer`` on phase 5's step-6 checkpoint: a [P] wav, png
    (where matplotlib is installed) and npy per test item, each wav finite
    and non-silent, each mel inside [mel_vmin, mel_vmax]; K2 once per item,
    K3 once per wav."""
    import glob

    import numpy as np
    import torch

    from diffsvc_tpu_torch.config import HParams, set_hparams
    from diffsvc_tpu_torch.run import run_task
    from diffsvc_tpu_torch.utils.audio_io import load_wav

    hp = HParams(dict(set_hparams(config=cfg_fn, exp_name="smoke_train",
                                  reset=True, print_hparams=False),
                      infer=True, gen_dir_name="smoke"))
    n_items = len(np.load(os.path.join(hp["binary_data_dir"],
                                       "test_lengths.npy")))
    label = "--infer, phase 5's step-6 checkpoint"
    t0 = time.time()
    with counted(label, launches, tag="train2", still=(
            "residual_stack_train_batched", "residual_stack_train",
            "fused_residual_block")):
        run_task(hp)
    wall = time.time() - t0
    counts = launches[label]
    gen = os.path.join(hp["work_dir"], f"generated_{TRAIN_STEPS}_smoke")
    wavs = sorted(glob.glob(os.path.join(gen, "wavs", "[[]P[]]*.wav")))
    pngs = glob.glob(os.path.join(gen, "plot", "[[]P[]]*.png"))
    mels = glob.glob(os.path.join(hp["work_dir"], "P_mels_npy", "*.npy"))
    res = {"items": n_items, "wavs": len(wavs), "pngs": len(pngs),
           "npys": len(mels), "s": wall, "s_per_item": wall / max(n_items, 1),
           "launches": counts}
    for fn in mels:
        mel = np.load(fn)
        if mel.min() < hp["mel_vmin"] or mel.max() > hp["mel_vmax"]:
            raise SmokeError(f"--infer mel {fn} outside [mel_vmin, mel_vmax]")
    for fn in wavs:
        wav, _ = load_wav(fn)
        if not np.isfinite(wav).all() or np.abs(wav).max() < 1e-3:
            raise SmokeError(f"--infer wav {fn} not finite or silent")
    # the plots need matplotlib; without it the runner prints "plot failed"
    # per item and writes the rest, as JAX's does
    try:
        import matplotlib  # noqa: F401

        want_pngs = n_items
    except ImportError:
        want_pngs = 0
    res["matplotlib"] = bool(want_pngs)
    log(f"[train2] --infer: {n_items} test items, {len(wavs)} [P] wavs, "
        f"{len(pngs)} pngs (matplotlib {'present' if want_pngs else 'absent'}"
        f" here), {len(mels)} npys in {wall:.2f}s "
        f"({res['s_per_item']:.3f} s/item); K2 launches "
        f"{counts['plms_ladder']}, K3 {counts['vocoder_tail']}")
    if not (n_items == len(wavs) == len(mels) > 0) \
            or len(pngs) != want_pngs \
            or counts["plms_ladder"] != n_items \
            or counts["vocoder_tail"] != len(wavs):
        raise SmokeError(f"--infer: {res}")
    torch.cuda.empty_cache()
    return res


def binarized_items(hp, prefix="train"):
    from diffsvc_tpu_torch.data.indexed_datasets import IndexedDataset

    ds = IndexedDataset(os.path.join(hp["binary_data_dir"], prefix))
    return [ds[i] for i in range(len(ds))]


def timed_binarize(hp, device, label: str) -> float:
    import torch

    from diffsvc_tpu_torch.data.binarizer import binarize

    torch.cuda.synchronize()
    t0 = time.time()
    binarize(hp, device=device)
    torch.cuda.synchronize()
    s = time.time() - t0
    log(f"[train2] binarize {label}: {s:.2f}s, "
        f"{TRAIN_CLIPS / s:.2f} items/s")
    return s


def phase_binarize(device, workdir, cfg_fn, launches):
    """(d) The batched binarizer on phase 5's 32 clips (AC tracker):
    batch 8 against batch 1, item by item at JAX's own test tolerances; the
    units' rel-L2 printed; the f0 cache on the per-item path, written by
    one run and hit on every item by the next."""
    import numpy as np
    import torch

    from diffsvc_tpu_torch.config import HParams, set_hparams
    from diffsvc_tpu_torch.data import features

    base = set_hparams(config=cfg_fn, exp_name="smoke_bin", reset=True,
                       print_hparams=False)

    def hp_for(tag, **kw):
        return HParams(dict(base, binary_data_dir=os.path.join(
            workdir, f"bin_{tag}"), config_path=os.path.join(
                workdir, f"bin_{tag}.yaml"), **kw))

    hps = {"batched": hp_for("b8", binarize_batch_size=8),
           "per_item": hp_for("b1", binarize_batch_size=1)}
    res = {}
    for k, hp in hps.items():
        # HuBERT-soft and the AC tracker on the card; none of K1-K6
        label = f"binarize_batch_size {hp['binarize_batch_size']}"
        with counted(label, launches, moved=(), still=ALL_KERNELS,
                     tag="train2"):
            res[k] = {"s": timed_binarize(hp, device, label)}
    for r in res.values():
        r["items_per_s"] = TRAIN_CLIPS / r["s"]
    got = binarized_items(hps["batched"])
    want = binarized_items(hps["per_item"])
    units_rel, f0_max = [], 0.0
    if [x["item_name"] for x in got] != [x["item_name"] for x in want]:
        raise SmokeError("batched and per-item binarize hold other items")
    for a, b in zip(got, want):
        try:
            np.testing.assert_allclose(a["mel"], b["mel"], rtol=1e-5,
                                       atol=1e-6)
            np.testing.assert_allclose(a["f0"], b["f0"], rtol=1e-4,
                                       atol=1e-3)
            np.testing.assert_array_equal(a["mel2ph"], b["mel2ph"])
        except AssertionError as e:
            raise SmokeError(f"batched vs per-item, {a['item_name']}: {e}")
        if a["len"] != b["len"] or a["hubert"].shape != b["hubert"].shape:
            raise SmokeError(f"{a['item_name']}: len or units shape differ")
        units_rel.append(rel_l2(torch.from_numpy(a["hubert"]),
                                torch.from_numpy(b["hubert"])))
        f0_max = max(f0_max, float(np.abs(a["f0"] - b["f0"]).max()))
    res["compare"] = {"items": len(got), "f0_max_abs_hz": f0_max,
                      "units_rel_l2_mean": float(np.mean(units_rel)),
                      "units_rel_l2_max": float(np.max(units_rel))}
    log(f"[train2] batched vs per-item, {len(got)} train items: mel, f0 "
        f"(max |diff| {f0_max:.3e} Hz), mel2ph and len within JAX's test "
        f"tolerances; units rel_l2 mean {np.mean(units_rel):.3e} max "
        f"{np.max(units_rel):.3e} (not gated: other padding, as in JAX)")
    # the f0 cache on the per-item path: one run writes, the next hits
    cache = os.path.join(workdir, "f0cache")
    calls = {"n": 0}
    track = features.get_pitch_ac

    def counting(*a, **k):
        calls["n"] += 1
        return track(*a, **k)

    runs = []
    with swapped(features, get_pitch_ac=counting):
        for tag in ("cache1", "cache2"):
            calls["n"] = 0
            hp = hp_for(tag, binarize_batch_size=1, f0_cache_dir=cache)
            runs.append({"s": timed_binarize(hp, device, f"per item with "
                                             f"f0_cache_dir ({tag})"),
                         "tracked": calls["n"]})
    files = len(os.listdir(cache))
    res["cache"] = {"runs": runs, "files": files}
    log(f"[train2] f0 cache: the first run tracked {runs[0]['tracked']} "
        f"items and left {files} files; the second tracked "
        f"{runs[1]['tracked']} (hits on every item); "
        f"{runs[0]['s']:.2f}s then {runs[1]['s']:.2f}s")
    if files != TRAIN_CLIPS or runs[0]["tracked"] != TRAIN_CLIPS \
            or runs[1]["tracked"] != 0:
        raise SmokeError(f"the f0 cache: {res['cache']}")
    return res


def phase_train2(device, workdir):
    """Phase 9 on phase 5's data and checkpoint: RAdam, the pe task,
    --infer and the batched binarizer with the f0 cache."""
    cfg_fn = os.path.join(workdir, "train.yaml")
    launches = {}
    res = {"radam": phase_radam(device, workdir, cfg_fn, launches),
           "pe": phase_pe(device, workdir, launches),
           "infer": phase_infer(device, workdir, cfg_fn, launches),
           "binarize": phase_binarize(device, workdir, cfg_fn, launches)}
    res["launches"] = launches
    return res


def deterministic_step(bundle_fn: str) -> int:
    """Phase 5's child: one step twice from the bundle's state, batch, t and
    noise under ``torch.use_deterministic_algorithms``; prints whether the
    params came out identical and K4's launches (its parent sets
    ``CUBLAS_WORKSPACE_CONFIG``, which that mode needs for cuBLAS)."""
    import torch

    from diffsvc_tpu_torch.config import HParams
    from diffsvc_tpu_torch.ops.hopper import diffnet_stack_train as k4
    from diffsvc_tpu_torch.training.task import SVCTask
    from diffsvc_tpu_torch.utils.convert import torch_load

    b = torch_load(bundle_fn)
    task = SVCTask(HParams(b["hp"]), device="cuda")
    params = []
    torch.use_deterministic_algorithms(True)
    for _ in range(2):
        task.load_state_dict(b["snap"])
        task.train_step(b["batch"], t=b["t"], noise=b["noise"])
        params.append([p.detach().clone() for p in task.params])
    # the planted fault: the same step on the next step's draws
    task.load_state_dict(b["snap"])
    task.step += 1
    t, noise = task.draws(b["batch"])
    task.step -= 1
    task.train_step(b["batch"], t=t, noise=noise)
    print(json.dumps({"identical": all(torch.equal(x, y)
                                       for x, y in zip(*params)),
                      "fault_identical": all(
                          torch.equal(x, p) for x, p in
                          zip(params[0], task.params)),
                      "launches": k4.launches}))
    return 0


# ---------------------------------------------------------------------------
# Phase 10: several ranks (data-parallel training), data-sharded serving,
# FS2-full and the FFT denoiser
# ---------------------------------------------------------------------------

# Two ranks' all-reduced grads against the sum of the same two blocks'
# grads computed in one process (same draws, the global count): the
# largest rel-L2 over the parameters.  The ranks run the same kernels on
# the same rows; the sum of two f32 tensors is the same whichever process
# adds them, so only the kernels' run-to-run order can move it.  The
# planted fault normalizes each block by its own count of real rows.
DIST_TOL = 1e-5
DIST_LOSS_TOL = 1e-6     # the loss against the world-1 formula (relative)
DIST_B = TRAIN_B         # samples per rank on K4's route
DIST_K4_STEPS = 3        # the third on a ragged batch of an odd count
DIST_K5_STEPS = 2        # at config_44k's own 88 per rank (K5)
DIST_TIMEOUT = 600


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_jobs(jobs) -> list:
    """Each (job, world, bundle) of ``jobs`` as ``world`` processes of
    ``chip_smoke.py --dist-job JOB BUNDLE`` on this card, every job started
    at once (RANK / WORLD_SIZE / MASTER_ADDR / MASTER_PORT set as torchrun
    sets them, a port per job; cuBLAS's workspace fixed so a step repeats
    bit for bit); every process is waited for or killed.  Returns each
    job's list of its ranks' records."""
    started = []    # (job, process, (out, err))
    try:
        for job, world, bundle in jobs:
            port = str(free_port())
            for r in range(world):
                env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world),
                           LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
                           MASTER_PORT=port,
                           CUBLAS_WORKSPACE_CONFIG=":4096:8")
                # files, not pipes: a rank blocked on a full pipe would
                # stall the other in a collective
                logs = (open(f"{bundle}.rank{r}.out", "w+"),
                        open(f"{bundle}.rank{r}.err", "w+"))
                started.append((job, subprocess.Popen(
                    [sys.executable, os.path.join(ROOT, "chip_smoke.py"),
                     "--dist-job", job, bundle], env=env, stdout=logs[0],
                    stderr=logs[1], text=True), logs))
        deadline = time.time() + DIST_TIMEOUT
        for _, p, _ in started:
            p.wait(timeout=max(deadline - time.time(), 1))
    finally:
        for _, p, _ in started:
            if p.poll() is None:
                p.kill()
                p.wait()
    outs, failed = {job: [] for job, _, _ in jobs}, []
    for job, p, (out_f, err_f) in started:
        out_f.seek(0)
        err_f.seek(0)
        outs[job].append(out_f.read())
        if p.returncode != 0:
            failed.append(f"{job} rank {len(outs[job]) - 1}: exit "
                          f"{p.returncode}\n{err_f.read()[-3000:]}")
        out_f.close()
        err_f.close()
    for job, _, _ in jobs:
        for out in outs[job]:
            for line in out.splitlines()[:-1]:
                log(line)
    if failed:
        raise SmokeError("\n".join(failed))
    return [[json.loads(out.strip().splitlines()[-1]) for out in outs[job]]
            for job, _, _ in jobs]


def dist_batches(hp, groups, world: int) -> list:
    """Collated global batches of phase 6's train items, each padded to a
    multiple of the world size with ``sample_mask`` (as the trainer pads)."""
    from diffsvc_tpu_torch.data.dataset import (BatchIterator,
                                                FastSpeechDataset,
                                                _pad_batch_dim)

    ds = FastSpeechDataset("train", hp, shuffle=False)
    out = []
    for idx in groups:
        b = next(iter(BatchIterator(ds, [list(idx)], pad_multiple=int(
            hp["frames_multiple"]))))
        out.append(_pad_batch_dim(b, -(-b["nsamples"] // world) * world))
    return out


def timed_step(task, batch) -> tuple:
    """One train step, its ms (host clock ending in a sync) and the grads
    the optimizer received (after the all-reduce)."""
    import torch

    seen = []
    real = type(task).apply_grads
    task.apply_grads = lambda grads: seen.append(grads) or real(task, grads)
    try:
        torch.cuda.synchronize()
        t0 = time.time()
        m = task.train_step(batch)
        torch.cuda.synchronize()
    finally:
        del task.apply_grads
    return (time.time() - t0) * 1e3, float(m["loss"]), seen[0]


def block_sums(task, batch, world: int) -> dict:
    """The one-process reference of a data-parallel step: every rank's
    block's loss and grads (the same draws, the global count), summed; and
    the planted fault, each block normalized by its own count of real rows
    (its grads scaled by global / local count, what that normalization
    gives)."""
    import numpy as np

    from diffsvc_tpu_torch.parallel import dist
    from diffsvc_tpu_torch.training.task import local_rows, real_rows

    n = int(batch["mels"].shape[0])
    total = real_rows(batch)
    loss, grads, fault = 0.0, None, None
    for r in range(world):
        rows = dist.block(n, r, world)
        lo, g = task.loss_and_grads(batch, rows=rows)
        scale = total / max(float(np.sum(local_rows(batch, rows)[
            "sample_mask"])), 1.0)
        loss += float(lo)
        grads = g if grads is None else [a + b for a, b in zip(grads, g)]
        fg = [x * scale for x in g]
        fault = fg if fault is None else [a + b for a, b in zip(fault, fg)]
    return {"loss": loss, "grads": grads, "fault": fault}


def kernel_counts_all() -> dict:
    from diffsvc_tpu_torch.ops.hopper import diffnet_block

    return dict(kernel_counts(), fused_residual_block=diffnet_block.launches)


def reset_counts() -> None:
    from diffsvc_tpu_torch.ops.hopper import (diffnet_block, diffnet_stack,
                                              diffnet_stack_per_sample,
                                              diffnet_stack_train,
                                              plms_ladder, vocoder_tail)

    for mod in (diffnet_stack, plms_ladder, vocoder_tail, diffnet_stack_train,
                diffnet_stack_per_sample, diffnet_block):
        mod.launches = 0


def optimizer_tensors(task) -> list:
    st = task.optimizer.state_dict()["state"]
    return [v for i in sorted(st) for k, v in sorted(st[i].items())
            if hasattr(v, "dtype")]


def dist_job(job: str, bundle_fn: str) -> int:
    """A rank of phase 10 (its parent runs it through :func:`run_jobs`);
    prints its record as its last line."""
    import torch

    from diffsvc_tpu_torch.config import HParams
    from diffsvc_tpu_torch.parallel import dist
    from diffsvc_tpu_torch.training.task import SVCTask
    from diffsvc_tpu_torch.utils.convert import torch_load

    b = torch_load(bundle_fn)
    device = torch.device(b["device"])
    rank = int(os.environ["RANK"])
    world = int(os.environ["WORLD_SIZE"])
    hp = HParams(b["hp"])
    out = {"rank": rank, "world": world}
    torch.use_deterministic_algorithms(True)

    if job == "seq":
        print(json.dumps(seq_job(b, device, rank, world)))
        return 0

    if job == "world1":
        # (a): the same three steps without a process group, then under
        # nccl at world 1, from the same fresh state
        batches = dist_batches(hp, b["k4_groups"], 1)
        runs = {}
        for mode in ("single", "nccl"):
            if mode == "nccl":
                dist.maybe_initialize_distributed(
                    HParams(hp, distributed=True), device=device)
                out["backend"] = torch.distributed.get_backend()
            task = SVCTask(hp, device=device)
            reset_counts()
            ms = [timed_step(task, batch)[0] for batch in batches]
            runs[mode] = ([p.detach().clone() for p in task.params]
                          + optimizer_tensors(task))
            out[mode] = {"ms_per_step": ms, "launches": kernel_counts_all()}
            del task
        out["bit_equal"] = all(torch.equal(x, y) for x, y in
                               zip(runs["single"], runs["nccl"])) \
            and len(runs["single"]) == len(runs["nccl"])
        dist.destroy()
        print(json.dumps(out))
        return 0

    # job "world2": (b) and (c) over gloo, two ranks on this card
    dist.maybe_initialize_distributed(
        HParams(hp, distributed=True, dist_backend="gloo"), device=device)
    out["backend"] = torch.distributed.get_backend()
    task = SVCTask(hp, device=device)
    parts = (("k4", b["k4_groups"], True), ("k5", b["k5_groups"], False))
    for name, groups, resume in parts:
        torch.use_deterministic_algorithms(name == "k4")
        batches = dist_batches(hp, groups, world)
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        steps = []
        path = dict.fromkeys(kernel_counts_all(), 0)
        for i, batch in enumerate(batches):
            ref = block_sums(task, batch, world) if rank == 0 else None
            if resume and i == len(batches) - 1 and rank == 0:
                # (c): rank 0 alone writes the state before the last step
                from diffsvc_tpu_torch.training import checkpoint

                os.makedirs(b["ckpt_dirs"][0], exist_ok=True)
                checkpoint.save_checkpoint(b["ckpt_dirs"][0],
                                           task.state_dict(), 0, task.step)
            # the ranks meet here (an all-reduce of nothing), so a step's
            # time on rank 1 does not hold rank 0's reference and checkpoint
            dist.all_reduce_sum([torch.zeros(1, device=device)])
            before = kernel_counts_all()
            ms, loss, grads = timed_step(task, batch)
            for k, v in kernel_counts_all().items():
                path[k] += v - before[k]
            rec = {"ms": ms, "loss": loss, "B": int(batch["mels"].shape[0]),
                   "real": int(batch["sample_mask"].sum()),
                   "T": int(batch["mels"].shape[1])}
            if ref is not None:
                rec["rel"] = max(rel_l2(a, r) for a, r in
                                 zip(grads, ref["grads"]))
                rec["fault_rel"] = max(rel_l2(a, r) for a, r in
                                       zip(grads, ref["fault"]))
                rec["loss_rel"] = abs(loss - ref["loss"]) / abs(ref["loss"])
            steps.append(rec)
        torch.cuda.synchronize()
        # launches of the data-parallel steps alone, and with rank 0's
        # reference sums
        out[name] = {"steps": steps, "launches": path,
                     "launches_with_reference": kernel_counts_all(),
                     "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
        params = [p.detach().clone() for p in task.params]
        torch.save(params, f"{bundle_fn}.{name}.rank{rank}.pt")
        if resume:
            # (c): a trainer on this rank's own work_dir (rank 1's is empty)
            # restores, rank 0's state is broadcast, the last step again
            from diffsvc_tpu_torch.training.trainer import Trainer

            trainer = Trainer(HParams(hp, work_dir=b["ckpt_dirs"][rank]),
                              device=device, log_writer=False)
            restored = trainer.restore()
            trainer.task.train_step(batches[-1])
            out[name]["resume"] = {
                "restored_here": restored,
                "global_step": trainer.global_step,
                "bit_equal": all(torch.equal(p, q) for p, q in
                                 zip(trainer.task.params, params))}
            del trainer
    dist.destroy()
    print(json.dumps(out))
    return 0


def check_ranks(tag: str, ranks: list, part: str, kernel: str) -> dict:
    """Phase 10 (b)'s gates on one part's rank records; returns the part's
    summary."""
    r0 = ranks[0][part]
    for i, st in enumerate(r0["steps"]):
        log(f"[multi] {tag} step {i + 1}: B={st['B']} ({st['real']} real, "
            f"{st['B'] // len(ranks)} per rank) T={st['T']} loss "
            f"{st['loss']:.6f}; all-reduced grads vs the one-process block "
            f"sum rel_l2 {st['rel']:.3e} (tol {DIST_TOL:g}), loss vs the "
            f"world-1 formula {st['loss_rel']:.3e} (tol {DIST_LOSS_TOL:g}); "
            f"planted fault [local count: {st['fault_rel']:.3e}]; ms per step "
            + " / ".join(f"{r[part]['steps'][i]['ms']:.1f}" for r in ranks)
            + " (ranks 0 / 1)")
        if not (st["rel"] <= DIST_TOL and st["loss_rel"] <= DIST_LOSS_TOL):
            raise SmokeError(f"{tag} step {i + 1}: the ranks' sum disagrees "
                             f"with the one-process sum: {st}")
        if not st["fault_rel"] > DIST_TOL:
            raise SmokeError(f"{tag} step {i + 1}: the local-count fault "
                             f"passes the gate: {st}")
    for r in ranks:
        log(f"[multi] {tag} rank {r['rank']}: kernel launches "
            f"{r[part]['launches']}, peak memory {r[part]['peak_mem_gb']:.2f}"
            " GB")
        if r[part]["launches"][kernel] <= 0:
            raise SmokeError(f"{tag}: rank {r['rank']} did not launch "
                             f"{kernel}")
        if r[part]["launches"]["fused_residual_block"]:
            raise SmokeError(f"{tag}: rank {r['rank']} launched K6")
    # the first step of a process builds plans and packs: steps 2 on
    ms = [max(r[part]["steps"][i]["ms"] for r in ranks)
          for i in range(1, len(r0["steps"]))]
    real = sum(st["real"] for st in r0["steps"][1:])
    res = {"steps": r0["steps"], "ms_per_step": sum(ms) / len(ms),
           "samples_per_s": real / (sum(ms) / 1e3),
           "launches": {r["rank"]: r[part]["launches"] for r in ranks},
           "peak_mem_gb": {r["rank"]: r[part]["peak_mem_gb"] for r in ranks}}
    log(f"[multi] {tag}: {res['ms_per_step']:.1f} ms per step after the "
        f"first (the slower rank's), {res['samples_per_s']:.1f} samples/s "
        f"over both ranks")
    return res


def phase_multi_train(device, workdir):
    """(a) NCCL at world 1 against no process group, bit for bit; (b) two
    gloo ranks on this card at 24 per rank (K4) and at 88 per rank (K5),
    each step's all-reduced grads against the one-process block sum, the
    ranks' params equal bit for bit; (c) a resume at world 2 from rank 0's
    checkpoint through ``broadcast_state``, the next step bit for bit."""
    import torch

    from diffsvc_tpu_torch.config import set_hparams

    hp = set_hparams(config=os.path.join(workdir, "own.yaml"),
                     exp_name="smoke_own", reset=True, print_hparams=False)
    res = {}
    bundle = os.path.join(workdir, "multi.pt")
    items = list(range(88))
    k4 = [items[0:2 * DIST_B], items[40:40 + 2 * DIST_B],
          items[1:2 * DIST_B]]          # 48, 48, 47 real rows
    torch.save({"hp": dict(hp, max_sentences=DIST_B), "device": str(device),
                "k4_groups": [items[0:DIST_B], items[24:48], items[48:71]],
                }, bundle + ".w1")
    dirs = [os.path.join(workdir, f"multi_ckpt{r}") for r in range(2)]
    torch.save({"hp": dict(hp), "device": str(device), "k4_groups": k4,
                "k5_groups": [items + items] * DIST_K5_STEPS,
                "ckpt_dirs": dirs}, bundle)
    # (a) beside (b) and (c): three processes on the card at once
    w1, ranks = run_jobs([("world1", 1, bundle + ".w1"),
                          ("world2", 2, bundle)])
    w1 = w1[0]
    res["world1"] = w1
    for mode in ("single", "nccl"):
        ms = w1[mode]["ms_per_step"]
        w1[mode]["ms_after_first"] = sum(ms[1:]) / len(ms[1:])
        log(f"[multi] (a) {mode}: ms per step {[round(x, 1) for x in ms]} "
            f"({w1[mode]['ms_after_first']:.1f} after the first), launches "
            f"{w1[mode]['launches']}")
    log(f"[multi] (a) nccl at world 1 vs no process group, 3 steps at "
        f"B={DIST_B}: params and optimizer state bit-equal {w1['bit_equal']}"
        f" (backend {w1['backend']})")
    if not w1["bit_equal"] or w1["backend"] != "nccl" \
            or w1["nccl"]["launches"]["residual_stack_train_batched"] <= 0:
        raise SmokeError(f"world 1 under nccl: {w1}")

    res["k4"] = check_ranks("(b) K4, gloo, 2 ranks", ranks, "k4",
                            "residual_stack_train_batched")
    res["k5"] = check_ranks("(b) K5, gloo, 2 ranks", ranks, "k5",
                            "residual_stack_train")
    for part in ("k4", "k5"):
        p0, p1 = (torch.load(f"{bundle}.{part}.rank{r}.pt") for r in (0, 1))
        same = all(torch.equal(a, b) for a, b in zip(p0, p1))
        res[part]["ranks_bit_equal"] = same
        log(f"[multi] (b) {part}: the two ranks' params bit-equal {same}")
        if not same:
            raise SmokeError(f"{part}: the ranks' params differ")
    res["resume"] = [r["k4"]["resume"] for r in ranks]
    log(f"[multi] (c) resume at world 2 from rank 0's checkpoint: "
        f"{res['resume']}")
    if not (res["resume"][0]["restored_here"]
            and not res["resume"][1]["restored_here"]
            and all(r["bit_equal"] and r["global_step"] == DIST_K4_STEPS - 1
                    for r in res["resume"])):
        raise SmokeError(f"resume at world 2: {res['resume']}")
    res["launches"] = {f"{part} rank {r['rank']}": r[part]["launches"]
                       for part in ("k4", "k5") for r in ranks}
    res["launches"]["world1 nccl"] = w1["nccl"]["launches"]
    return res


def phase_sharded(project, launches):
    """(d) ``FusedSvc.batched_sharded`` on phase 7's 17 s clip (three
    voiced chunks) with two replicas on this card: N padded to 4, three
    results, each within BATCHED_TOL of ``batched``'s on the same draws,
    K2 and K3 moving on both replicas; the wall beside ``batched``'s."""
    import numpy as np
    import torch

    from diffsvc_tpu_torch.vocoders.generator import draw_randoms

    svc = project["svcs"][""]
    device = svc.device
    batch_fn = os.path.join(os.path.dirname(project["wavs"][-1]),
                            "batch_clip.wav")
    chunks = voiced_chunks(batch_fn)
    fused = svc.fused_model(ACC)
    n44 = fused._padded_length(max(len(c) for c in chunks))
    geo = fused.geometry(n44)
    g = torch.Generator(device=device).manual_seed(6)
    n = len(chunks)
    noise = torch.randn(n, geo["pad_t"], svc.mel_bins, generator=g,
                        device=device)
    randoms = draw_randoms(n, geo["n_voc"], svc.vocoder.cfg.harmonic_num, g,
                           device)
    devices = [device, device]
    per_replica = []
    for i, d in enumerate(devices):
        rep = fused.replica(i, d)

        def run(stacked, *a, rep=rep, i=i, **k):
            before = kernel_counts()
            out = type(rep).run(rep, stacked, *a, **k)
            after = kernel_counts()
            per_replica.append({"replica": i, "rows": int(stacked.shape[0]),
                                **{name: after[name] - before[name]
                                   for name in after}})
            return out
        rep.run = run
    kw = dict(init_noise=noise, voc_randoms=randoms)
    walls = {}
    try:
        for route, fn in (("batched", lambda: fused.batched(chunks, **kw)),
                          ("batched_sharded", lambda: fused.batched_sharded(
                              chunks, devices, **kw))):
            fn()                       # captures its buckets
            per_replica.clear()
            with counted(f"{route} float32", launches, tag="multi"):
                torch.cuda.synchronize()
                t0 = time.time()
                outs = fn()
                torch.cuda.synchronize()
                walls[route] = time.time() - t0
            if route == "batched":
                ref = outs
            else:
                got = outs
    finally:
        for i, d in enumerate(devices):
            rep = fused.replica(i, d)
            if "run" in vars(rep):
                del rep.run
    rels = [rel_l2(torch.from_numpy(np.asarray(a[0], np.float32)),
                   torch.from_numpy(np.asarray(b[0], np.float32)))
            for a, b in zip(got, ref)]
    res = {"chunks": n, "results": len(got), "replicas": per_replica,
           "rel_l2": rels, "wall_s": walls}
    log(f"[multi] (d) batched_sharded over {len(devices)} replicas on this "
        f"card, {n} chunks: replicas ran {per_replica}; {len(got)} results; "
        f"per chunk vs batched rel_l2 {[f'{r:.2e}' for r in rels]} (tol "
        f"{BATCHED_TOL:g}); wall {walls['batched_sharded']:.4f}s vs batched "
        f"{walls['batched']:.4f}s")
    if len(got) != n or [r["rows"] for r in per_replica] != [2, 2]:
        raise SmokeError(f"batched_sharded: {len(got)} results, replicas "
                         f"{per_replica}")
    if any(r["plms_ladder"] < 1 or r["vocoder_tail"] < 1
           for r in per_replica):
        raise SmokeError(f"a replica did not run K2 and K3: {per_replica}")
    if not max(rels) <= BATCHED_TOL:
        raise SmokeError(f"batched_sharded disagrees with batched: {rels}")
    return res


@contextlib.contextmanager
def last_layer_dropped(blocks):
    """An FFT-block stack with its last layer left out."""
    layers = blocks.layers
    blocks.layers = layers[:-1]
    try:
        yield
    finally:
        blocks.layers = layers


def variant_project(workdir, name, overrides, hubert_path):
    """A config_44k project with ``overrides``, random weights from the
    synth seeds, and phase 4's HuBERT file."""
    from diffsvc_tpu_torch.utils import synth

    root = os.path.join(workdir, name)
    cfg_fn, ckpt = synth.write_project(
        root, {"base_config": [os.path.join(ROOT, "configs",
                                            "config_44k.yaml")],
               **overrides}, VOC_H)
    os.makedirs(os.path.join(root, "hubert"), exist_ok=True)
    os.symlink(hubert_path, os.path.join(root, "hubert", "hubert_soft.pt"))
    return cfg_fn, ckpt


def variant_train_step(hp, device, part: str, launches, label, still=()):
    """One train step's grads at B=24 from phase 6's items (the output head
    drawn at random, so the loss reaches the model): those of the parameters
    named ``part...`` must be finite and not all zero."""
    import torch

    from diffsvc_tpu_torch.training.task import SVCTask, global_norm

    batch = dist_batches(hp, [list(range(DIST_B))], 1)[0]
    task = SVCTask(hp, device=device)
    head = (task.model.denoise_fn.get_mel_out
            if task.model.decoder_type == "fft"
            else task.model.denoise_fn.output_projection)
    with torch.no_grad():
        head.weight.copy_(torch.randn(head.weight.shape, generator=torch.
                                      Generator().manual_seed(11)) * 0.05)
    with counted(label, launches, moved=(), still=still, tag="fs2"):
        torch.cuda.synchronize()
        t0 = time.time()
        loss, grads = task.loss_and_grads(batch)
        torch.cuda.synchronize()
        ms = (time.time() - t0) * 1e3
    sub = [g for n, g in zip(task.names, grads) if n.startswith(part)]
    norm = float(global_norm(sub))
    finite = all(bool(torch.isfinite(g).all()) for g in grads)
    res = {"loss": float(loss), "ms": ms, "grad_norm": norm,
           "finite": finite, "tensors": len(sub)}
    log(f"[fs2] {label}: B={DIST_B} loss {res['loss']:.5f}, {part}* grad "
        f"norm {norm:.3e} over {len(sub)} tensors, finite {finite}, "
        f"{ms:.1f} ms (forward + backward)")
    if not finite or not norm > 0 or not sub:
        raise SmokeError(f"{label}: {res}")
    del task
    torch.cuda.empty_cache()
    return res


def phase_variants(device, workdir, project, launches):
    """(e) FS2-full (``no_fs2: false``: base.yaml's encoder, 4 layers, 2
    heads, FFN kernel 9 at hidden 256) and (f) the FFT denoiser
    (``diff_decoder_type: fft``) on config_44k: the 6.5 s clip through the
    modular route and the fused graph in bf16 and f32 (the FFT denoiser in
    f32, config_44k's own dtype; RTF, busy share; K2 and K3 moving, and for
    the FFT denoiser K1, K2, K4 and K5 at 0), a
    0.5 s conversion card vs CPU at phase 4's limits with a planted fault
    (the encoder's, or the denoiser's, last layer dropped), and one train
    step at B=24 (dropout 0.1 for FS2-full, on K4)."""
    import torch

    from diffsvc_tpu_torch import infer_cli
    from diffsvc_tpu_torch.config import HParams, set_hparams
    from diffsvc_tpu_torch.infer.svc import Svc

    wav_fn = project["wavs"][0]
    secs = CLIPS[0][0]
    n_chunks = len(voiced_chunks(wav_fn))
    hub = os.path.join(os.path.dirname(project["cfg_fn"]), "hubert",
                       "hubert_soft.pt")
    own = set_hparams(config=os.path.join(workdir, "own.yaml"),
                      exp_name="smoke_own", reset=True, print_hparams=False)
    res = {}
    # (name, overrides, the module whose forward must run, the fault, the
    # kernels that must move and those that must not, eps = 0's
    # parameters, dtypes): the FFT denoiser at config_44k's f32 alone
    variants = (
        ("fs2", {"no_fs2": False}, lambda s: s.model.fs2.encoder,
         "encoder's last layer dropped", ("plms_ladder", "vocoder_tail"), (),
         denoiser_head, ("bfloat16", "")),
        ("fft", {"diff_decoder_type": "fft"}, lambda s: s.model.denoise_fn,
         "denoiser's last layer dropped", ("vocoder_tail",),
         ("residual_stack", "plms_ladder", "residual_stack_train_batched",
          "residual_stack_train"),
         lambda s: (s.model.denoise_fn.get_mel_out.weight,
                    s.model.denoise_fn.get_mel_out.bias), ("",)))
    for name, over, blocks, fault_name, moved, still, head, dts in variants:
        t_var = time.time()
        cfg_fn, ckpt = variant_project(workdir, f"{name}_proj", over, hub)
        out = res[name] = {"routes": {}, "cpu_agreement": {}}
        for dt in dts:
            dname = dt or "float32"
            svc = Svc(f"{name}_proj", cfg_fn, True, ckpt, device=device)
            svc.hp["diff_compute_dtype"] = dt
            calls = []
            hook = blocks(svc).register_forward_hook(
                lambda *a: calls.append(1))

            def clip(**route):
                return infer_cli.run_clip(
                    svc, key=0, acc=ACC, use_pe=False, use_crepe=False,
                    thre=0.05, use_gt_mel=False, add_noise_step=500,
                    file_path=wav_fn, out_path=wav_fn[:-4] + f"_{name}.wav",
                    **route)

            routes = out["routes"].setdefault(dname, {})
            for route, kw in (("modular", {}), ("fused graph",
                                                {"fused": True})):
                calls.clear()
                with counted(f"{name} {route} {dname}", launches, moved=moved,
                             still=still, tag="fs2"):
                    _, _, audio = clip(**kw)
                if not calls or len(audio) == 0:
                    raise SmokeError(f"{name} {route} {dname}: the "
                                     f"{'encoder' if name == 'fs2' else 'denoiser'}"
                                     f" ran {len(calls)} times")
                routes[route] = dict(route_run(
                    f"{name} {route} {dname}", secs, n_chunks,
                    lambda kw=kw: clip(
                        **kw)), module_calls_first_run=len(calls))
            hook.remove()
            t_cpu = time.time()
            out["cpu_agreement"][dname] = cpu_agreement(
                svc, cfg_fn, ckpt, project["wavs"][0], tag=name, head=head,
                fault=lambda s: last_layer_dropped(blocks(s)),
                fault_name=fault_name,
                secs=0.5 if name == "fs2" else CPU_SECS_CUT)
            log(f"[fs2] {name} {dname}: card vs CPU took "
                f"{time.time() - t_cpu:.1f}s")
            del svc
            torch.cuda.empty_cache()
        out["seconds"] = time.time() - t_var
        hp = HParams(dict(own, **over, dropout=0.1))
        out["train_step"] = variant_train_step(
            hp, device, "fs2.encoder." if name == "fs2" else "denoise_fn.",
            launches, f"{name} train step",
            still=("residual_stack_train", "residual_stack_train_batched")
            if name == "fft" else ())
        if name == "fs2" and launches[f"{name} train step"][
                "residual_stack_train_batched"] <= 0:
            raise SmokeError("the FS2-full train step did not run K4")
    return res


def phase_multi(device, workdir, project):
    """Phase 10: several ranks, sharded serving, FS2-full and the FFT
    denoiser (``[multi]`` and ``[fs2]`` lines)."""
    t0 = time.time()
    res = {"launches": {}, "seconds": {}}
    res["train"] = phase_multi_train(device, workdir)
    res["launches"].update(res["train"]["launches"])
    res["seconds"]["ranks"] = time.time() - t0
    res["sharded"] = phase_sharded(project, res["launches"])
    res["seconds"]["sharded"] = time.time() - t0 - res["seconds"]["ranks"]
    res["variants"] = phase_variants(device, workdir, project,
                                     res["launches"])
    res["seconds"]["total"] = time.time() - t0
    log(f"[multi] phase 10 took {res['seconds']}s")
    return res

# ---------------------------------------------------------------------------
# Phase 11: the other vocoders and GAN vocoder training
# ---------------------------------------------------------------------------

# A vocoder alone, card vs CPU on one input (relative L2 of the waveform),
# TF32 off: f32 convolutions, products and FFTs summed in other orders on
# the two sides.  The iSTFT head's bf16 backbone has a limit of its own:
# both sides round the same values to bf16 but sum them in other orders,
# so a few roundings flip and move the phases.  The planted faults: the
# iSTFT head's final LayerNorm dropped, PWG's last residual layer dropped.
VOC_TOL = 1e-4
VOC_TOL_BF16 = 5e-2
# loud_norm's pwg mel, card vs CPU (largest absolute log10 difference)
LOUD_MEL_TOL = 1e-3
# the iSTFT head at config_44k's geometry: dim 512, 8 layers, n_fft 2048,
# hop 512, the f0 embedding (use_nsf)
ISTFT_OVER = {"vocoder": "IstftVocoder", "istft_dim": 512, "istft_layers": 8}
# PWG at config_24k's geometry: 80 mel, hop 128 -> upsample scales
# _factor_scales(128) = (4, 4, 4, 2), 30 layers in 3 stacks, 64 residual /
# 128 gate / 64 skip channels, aux context window 2
PWG_PARAMS = dict(layers=30, stacks=3, residual_channels=64,
                  gate_channels=128, skip_channels=64, aux_channels=80,
                  aux_context_window=2,
                  upsample_params={"upsample_scales": [4, 4, 4, 2]})
# GAN training: crops of 32 frames, B=8 (base.yaml's max_sentences is 88:
# cut for time), 2 steps a family with a checkpoint after step 1
VOC_SEG, VOC_B, VOC_STEPS = 32, 8, 2
# One hifigan GAN step card vs CPU at B=2 from the same init, crops and
# draws, TF32 off: the losses (relative), the D and the G grads (relative L2
# over all of each), and each param the card updated against optax's first
# adamw update on the card's own grad, p (1 - lr wd) - lr g / (|g| + eps),
# within GAN_UPDATE_TOL lr beyond 4 f32 ulps of the value (the card's
# params are not held to the CPU's: Adam's first update is about lr *
# sign(g), and an element whose grad is near 0 can take the other sign on
# the other device).  G's grads have a limit of their own: on the H100
# and on the CPU alike they read 1.8e-4 to 1.0e-3 from the same step in
# float64 over init seeds 0-2, card against CPU 2.4e-4 to 1.1e-3, TF32 on
# 6.6e-4 to 1.2e-3 (tools/gan_step_error.py); the D update adds nothing
# (G's grads against the D from before the step read the same), nor does
# the loss's mel (computed in float64: the same readings).  The cause is
# the leaky ReLUs of G and D: an input within rounding of 0 takes the
# other slope in f32 than in f64 and passes 1 where the reference passes
# 0.1.  With every leaky ReLU as s x + (1 - s) softplus(x, beta=50) (the
# twin), G's grads read 1.9e-5 to 4.0e-5 from float64 on either device,
# card against CPU 3.9e-5 to 4.0e-5, and TF32 on 6.6e-4 to 8.1e-4.  So
# G's grads are gated twice: the step's at GAN_GRAD_TOL["g"], its planted
# fault G's grads against the old D (3.8e-3), and the twin's at the init
# at GAN_TWIN_TOL, its planted fault TF32 on the card.
GAN_LOSS_TOL = 1e-4
GAN_GRAD_TOL = {"d": 1e-4, "g": 2e-3}
GAN_TWIN_TOL = 1.5e-4
GAN_UPDATE_TOL = 1e-3
# The task's AdamW on the card through VocoderTask._update (the rate from
# its update count), 20 steps on fixed random grads from params of scale
# 0.1, against optax's adamw written out in float64: rel-L2 of the total
# update.  The f32 rounding of the params at each step reads 4.3e-5 on the
# H100 and on the CPU; the planted fault, torch's default weight decay
# 1e-2, 4.1e-3 (the
# betas and the decayed rate are held to optax itself in float64 by
# tests/test_torch_vocoder_task.py).
ADAMW_TOL = 4e-4
ADAMW_STEPS = 20
VOC_TIMEOUT = 900


def with_vocoder_ckpt(cfg_fn, path, **extra):
    """The project's config.yaml pointing at another vocoder checkpoint."""
    import yaml

    with open(cfg_fn) as f:
        cfg = yaml.safe_load(f)
    with open(cfg_fn, "w") as f:
        yaml.safe_dump(dict(cfg, vocoder_ckpt=path, **extra), f)


@contextlib.contextmanager
def final_ln_dropped(head):
    """The iSTFT head ``head`` with its final LayerNorm left out."""
    from diffsvc_tpu_torch.vocoders import istft_head as ih

    real = ih._ln

    def ln(layer, x):
        return x.float() if layer is head.final_ln else real(layer, x)
    ih._ln = ln
    try:
        yield
    finally:
        ih._ln = real


@contextlib.contextmanager
def last_residual_dropped(gen):
    """A PWG generator with its last residual layer left out."""
    layers = gen.conv_layers
    gen.conv_layers = layers[:-1]
    try:
        yield
    finally:
        gen.conv_layers = layers


def voc_card_vs_cpu(label, run, fault, tol):
    """``run(card)`` on the CPU (``card`` False) and on the card (numpy
    outputs), and the card's run under the planted ``fault`` (a context
    manager): the sound rel-L2 within ``tol``, the fault's above it."""
    import torch

    ref = torch.from_numpy(run(False))
    got = torch.from_numpy(run(True))
    with fault():
        bad = torch.from_numpy(run(True))
    res = {"rel_l2": rel_l2(got, ref), "fault_rel_l2": rel_l2(bad, ref),
           "tol": tol, "max_abs_err": float((got - ref).abs().max())}
    log(f"[voc] {label} card vs CPU: rel_l2 {res['rel_l2']:.3e} (tol "
        f"{tol:g}), planted fault {res['fault_rel_l2']:.3e}")
    if not res["rel_l2"] <= tol < res["fault_rel_l2"]:
        raise SmokeError(f"{label} card vs CPU: {res}")
    return res


def voc_routes(label, svc, wav_fn, secs, launches, routes):
    """Each route of ``routes`` ({name: run_clip kwargs}) counted (K2 moving,
    K3 not: the vocoder is no HiFi-GAN) with its output checked, then timed
    (RTF, busy share)."""
    from diffsvc_tpu_torch import infer_cli
    from diffsvc_tpu_torch.utils.audio_io import load_wav

    src_len = len(load_wav(wav_fn)[0])
    n_chunks = len(voiced_chunks(wav_fn))
    out = {}

    def clip(**kw):
        return infer_cli.run_clip(
            svc, key=0, acc=ACC, use_pe=False, use_crepe=False, thre=0.05,
            use_gt_mel=False, add_noise_step=500, file_path=wav_fn,
            out_path=wav_fn[:-4] + "_voc.wav", **kw)

    for route, kw in routes.items():
        name = f"{label} {route}"
        with counted(name, launches, moved=("plms_ladder",),
                     still=("vocoder_tail",), tag="voc"):
            _, _, audio = clip(**kw)
        peak = clip_checks(name, audio, src_len)
        pools = sum(svc.fused_model(ACC).pool_bytes().values()) \
            if kw.get("fused") else 0
        out[route] = dict(route_run(name, secs, n_chunks,
                                    lambda kw=kw: clip(**kw), pools,
                                    tag="voc"), peak=peak)
    return out


def phase_voc_istft(device, workdir, inputs, launches):
    """(a) The iSTFT head at config_44k's geometry (weights written by the
    port's save_params): the 6.5 s clip through Svc.infer and the fused
    graph in bf16 and f32 diffusion and once with voc_compute_dtype
    bfloat16; the 17 s clip through FusedSvc.batched (B=3) and
    batched_sharded over two replicas on the card; K2 moving, K3 at 0 on
    each; the vocoder card vs CPU in f32 and with the bf16 backbone, the
    final LayerNorm dropped above both limits; Svc.infer_batched refused."""
    import copy

    import torch

    from diffsvc_tpu_torch.config import set_hparams
    from diffsvc_tpu_torch.infer.svc import Svc
    from diffsvc_tpu_torch.utils import synth
    from diffsvc_tpu_torch.vocoders import istft_head as ih

    res = {"routes": {}}
    cfg_fn, ckpt = variant_project(workdir, "istft_proj", ISTFT_OVER,
                                   inputs["hubert"])
    npz = os.path.join(workdir, "istft_proj", "istft", "istft_head.npz")
    cfg = ih.IstftVocoderConfig.from_hparams(set_hparams(
        config=cfg_fn, exp_name="istft_proj", reset=True,
        print_hparams=False))
    synth.write_istft(npz, cfg, seed=7)
    with_vocoder_ckpt(cfg_fn, npz)
    secs = CLIPS[0][0]
    for dt in ("bfloat16", ""):
        svc = Svc("istft_proj", cfg_fn, True, ckpt, device=device)
        if not isinstance(svc.vocoder, ih.IstftVocoder) or cfg != \
                svc.vocoder.cfg:
            raise SmokeError(f"the iSTFT project's vocoder: {svc.vocoder}")
        svc.hp["diff_compute_dtype"] = dt
        res["routes"][dt or "float32"] = voc_routes(
            f"istft {dt or 'float32'}", svc, inputs["clip"], secs, launches,
            {"modular": {}, "fused graph": {"fused": True}})
    # the backbone in bf16 once (the fused program reads voc_compute_dtype)
    svc.hp["voc_compute_dtype"] = "bfloat16"
    svc._fused = None
    res["routes"]["float32"]["fused graph, bf16 backbone"] = voc_routes(
        "istft float32, bf16 backbone", svc, inputs["clip"], secs, launches,
        {"fused graph": {"fused": True}})["fused graph"]
    svc.hp["voc_compute_dtype"] = ""
    svc._fused = None
    # the 17 s clip: batched at B=3 and sharded over two replicas
    chunks = voiced_chunks(inputs["batch_clip"])
    fused = svc.fused_model(ACC)
    geo = fused.geometry(fused._padded_length(max(len(c) for c in chunks)))
    g = torch.Generator(device=device).manual_seed(6)
    noise = torch.randn(len(chunks), geo["pad_t"], svc.mel_bins, generator=g,
                        device=device)
    outs, walls = {}, {}
    for route, fn in (("batched", lambda: fused.batched(
            chunks, init_noise=noise)), ("batched_sharded", lambda: fused.
            batched_sharded(chunks, [device, device], init_noise=noise))):
        fn()                                  # captures its buckets
        with counted(f"istft {route} B={len(chunks)}", launches,
                     moved=("plms_ladder",), still=("vocoder_tail",),
                     tag="voc"):
            torch.cuda.synchronize()
            t0 = time.time()
            outs[route] = fn()
            torch.cuda.synchronize()
            walls[route] = time.time() - t0
    rels = [rel_l2(torch.from_numpy(a[0]), torch.from_numpy(b[0]))
            for a, b in zip(outs["batched_sharded"], outs["batched"])]
    res["batch_clip"] = {"chunks": len(chunks), "wall_s": walls,
                         "sharded_vs_batched_rel_l2": rels}
    log(f"[voc] istft 17 s clip: {len(chunks)} chunks, batched "
        f"{walls['batched']:.4f}s, batched_sharded over 2 replicas "
        f"{walls['batched_sharded']:.4f}s, sharded vs batched rel_l2 "
        f"{[f'{r:.2e}' for r in rels]} (tol {BATCHED_TOL:g})")
    if len(outs["batched_sharded"]) != len(chunks) or \
            not max(rels) <= BATCHED_TOL:
        raise SmokeError(f"istft batched_sharded: {res['batch_clip']}")
    # the vocoder alone, card vs CPU, on one mel and f0 of 200 frames
    gm = torch.Generator().manual_seed(12)
    mel = torch.randn(1, 200, cfg.num_mels, generator=gm) * 0.7 - 4.0
    f0 = 150.0 + 250.0 * torch.rand(1, 200, generator=gm)
    heads = {False: copy.deepcopy(svc.vocoder.gen).cpu(),
             True: svc.vocoder.gen}

    def run(card, dtype=None):
        dev = device if card else "cpu"
        with torch.no_grad():
            return ih.apply(heads[card], mel.to(dev), f0.to(dev),
                            dtype=dtype).cpu().numpy()

    res["cpu_agreement"] = {
        name: voc_card_vs_cpu(f"istft head {name}",
                              lambda card, dt=dtype: run(card, dt),
                              lambda: final_ln_dropped(heads[True]), tol)
        for name, dtype, tol in (("f32", None, VOC_TOL),
                                 ("bf16 backbone", torch.bfloat16,
                                  VOC_TOL_BF16))}
    res["head_ms"] = cuda_time_ms(lambda: run(True), reps=5)
    log(f"[voc] istft head on 200 frames: {res['head_ms']:.3f} ms (f32)")
    try:
        svc.infer_batched([inputs["clip"]], key=0, acc=ACC, use_pe=False,
                          use_crepe=False)
    except ValueError as e:
        res["infer_batched_refused"] = str(e)
        log(f"[voc] Svc.infer_batched with the iSTFT head refused: {e}")
    else:
        raise SmokeError("Svc.infer_batched ran the iSTFT head")
    return res


def phase_voc_pwg(device, workdir, inputs, launches):
    """(b) PWG at config_24k's geometry from an official-layout directory
    (config.yaml, checkpoint-400000steps.pkl with weight-norm keys,
    stats.npy), ``loud_norm: true``: the 6.5 s clip at 24 kHz through the
    modular route and --batch_chunks (K2 moving, K3 at 0); spec2wav card vs
    CPU on one mel and seed, the last residual layer dropped above the
    limit; wav2spec with loud_norm card vs CPU; a fused route refused."""
    import numpy as np

    from diffsvc_tpu_torch.infer.svc import Svc
    from diffsvc_tpu_torch.ops import mel as mel_ops
    from diffsvc_tpu_torch.utils import synth
    from diffsvc_tpu_torch.utils.audio_io import load_wav, save_wav
    from diffsvc_tpu_torch.vocoders import hifigan

    res = {}
    root = os.path.join(workdir, "pwg_proj")
    cfg_fn, ckpt = synth.write_project(
        root, {"base_config": [os.path.join(ROOT, "configs",
                                            "config_24k.yaml")],
               "vocoder": "network.vocoders.pwg.PWG", "loud_norm": True},
        VOC24_H)
    os.makedirs(os.path.join(root, "hubert"), exist_ok=True)
    os.symlink(inputs["hubert"], os.path.join(root, "hubert",
                                              "hubert_soft.pt"))
    pwg_dir = os.path.join(root, "pwg")
    synth.write_pwg(pwg_dir, PWG_PARAMS, hop_size=128, seed=8)
    with_vocoder_ckpt(cfg_fn, pwg_dir)
    secs, f0, gaps = CLIPS[0]
    wav_fn = os.path.join(workdir, "clip24_pwg.wav")
    save_wav(synth.voiced_wav(secs, 24000, f0, gaps, seed=2), wav_fn, 24000)
    svc = Svc("pwg_proj", cfg_fn, True, ckpt, device=device)
    if not isinstance(svc.vocoder, hifigan.PWG):
        raise SmokeError(f"the PWG project's vocoder: {svc.vocoder}")
    res["routes"] = voc_routes("pwg float32", svc, wav_fn, secs, launches,
                               {"modular": {}, "batched":
                                {"batch_chunks": True}})
    # spec2wav card vs CPU on one mel (300 frames) and seed
    cpu_voc = hifigan.PWG(svc.hp, device="cpu")
    mel = (np.random.RandomState(13).randn(300, 80) * 0.7 - 3.0).astype(
        np.float32)
    vocs = {False: cpu_voc, True: svc.vocoder}
    res["cpu_agreement"] = voc_card_vs_cpu(
        "pwg spec2wav", lambda card: vocs[card].spec2wav(mel, seed=4),
        lambda: last_residual_dropped(svc.vocoder.impl.gen), VOC_TOL)
    # spec2wav's wall (host numpy in and out, the noise drawn on the host)
    res["spec2wav_ms"] = cuda_time_ms(lambda: svc.vocoder.spec2wav(
        mel, seed=4), reps=3)
    # wav2spec with loud_norm, card vs CPU
    wav, _ = load_wav(wav_fn, sr=24000)
    (w_cpu, m_cpu), (w_dev, m_dev) = (mel_ops.wav2spec(wav, svc.hp, d)
                                      for d in ("cpu", device))
    plain = mel_ops.wav2spec(wav, dict(svc.hp, loud_norm=False), "cpu")[1]
    err = float(np.abs(m_dev - m_cpu).max())
    res["loud_norm_mel"] = {"max_abs_err": err, "tol": LOUD_MEL_TOL,
                            "wav_equal": bool(np.array_equal(w_cpu, w_dev)),
                            "moved_from_plain": float(np.abs(
                                m_cpu - plain).max())}
    log(f"[voc] wav2spec with loud_norm (-22 LUFS) card vs CPU: mel max abs "
        f"err {err:.3e} (tol {LOUD_MEL_TOL:g}), wavs equal "
        f"{res['loud_norm_mel']['wav_equal']}, the mel moved "
        f"{res['loud_norm_mel']['moved_from_plain']:.3f} from the plain one")
    if not (err <= LOUD_MEL_TOL and res["loud_norm_mel"]["wav_equal"]
            and res["loud_norm_mel"]["moved_from_plain"] > 0.1):
        raise SmokeError(f"loud_norm wav2spec: {res['loud_norm_mel']}")
    try:
        svc.infer_fused(load_wav(wav_fn, sr=24000)[0][:24000], acc=ACC)
    except ValueError as e:
        res["fused_refused"] = str(e)
        log(f"[voc] PWG on the fused route refused: {e}")
    else:
        raise SmokeError("the fused route ran PWG")
    log(f"[voc] pwg spec2wav on 300 frames: {res['spec2wav_ms']:.3f} ms "
        "(wall, host numpy in and out)")
    return res


def phase_voc_inventory(device):
    """(c) MelGAN's generator at its defaults (512 channels, scales 8, 8, 2,
    2), causal and not, its multi-scale discriminator, a PQMF round trip and
    the cyclic-noise source, each card vs CPU (VOC_TOL)."""
    import copy

    import numpy as np
    import torch

    from diffsvc_tpu_torch.vocoders import melgan, pqmf, source

    res = {}
    g = torch.Generator().manual_seed(14)
    mel = torch.randn(1, 40, 80, generator=g)
    wav = torch.randn(2, 8192, generator=g) * 0.3

    def pair(build):
        torch.manual_seed(15)
        mod = build()
        return {"cpu": mod, "card": copy.deepcopy(mod).to(device)}

    def check(label, mods, fn):
        with torch.no_grad():
            outs = {d: [o.cpu() for o in fn(mods[d], dev)]
                    for d, dev in (("cpu", "cpu"), ("card", device))}
        rels = [rel_l2(a, b) for a, b in zip(outs["card"], outs["cpu"])]
        res[label] = {"rel_l2": max(rels), "outputs": len(rels),
                      "tol": VOC_TOL}
        log(f"[voc] {label} card vs CPU: rel_l2 {max(rels):.3e} over "
            f"{len(rels)} outputs (tol {VOC_TOL:g})")
        if not max(rels) <= VOC_TOL:
            raise SmokeError(f"{label} card vs CPU: {rels}")

    for causal in (False, True):
        mods = pair(lambda: melgan.MelGANGenerator(melgan.MelGANConfig(
            use_causal_conv=causal)))
        check(f"MelGAN generator{' causal' if causal else ''}", mods,
              lambda m, d: [m(mel.to(d))])
    mods = pair(melgan.MelGANMultiScaleDiscriminator)
    check("MelGAN multi-scale discriminator", mods,
          lambda m, d: [o for scale in m(wav.to(d)) for o in scale])
    mods = {"cpu": pqmf.PQMF(), "card": pqmf.PQMF(device=device)}
    t = torch.arange(8192) / 16000.0
    x = (0.5 * torch.sin(2 * np.pi * 440 * t))[None]
    check("PQMF analysis + synthesis", mods,
          lambda m, d: [m.analysis(x.to(d)), m.synthesis(m.analysis(x.to(d)))])
    rec = mods["card"].synthesis(mods["card"].analysis(x.to(device)))[0].cpu()
    err = float((x[0] - torch.roll(rec, -2))[100:-100].abs().mean()
                / x[0, 100:-100].abs().mean())
    res["pqmf_reconstruction_err"] = err
    log(f"[voc] PQMF round trip on the card: {err:.4f} of the input at its "
        "2-sample delay (must be < 0.05)")
    if not err < 0.05:
        raise SmokeError(f"PQMF reconstruction {err}")
    # 1 s at 44.1 kHz: f0 172.27 / 344.53 Hz (phase steps 1/256, 1/128,
    # exact in f32: both devices' cumsums wrap at the same samples)
    sr = 44100
    f0 = torch.cat([torch.stack([torch.full((sr // 2,), sr / 256.0),
                                 torch.full((sr // 2,), sr / 128.0)]),
                    torch.zeros(2, sr // 2)], 1)
    draws = source.draw_cyc_noise(2, f0.shape[1], sr,
                                  generator=torch.Generator().manual_seed(16))
    check("cyclic-noise source", {"cpu": None, "card": None},
          lambda m, d: source.source_module_cyc_noise(
              f0.to(d), sr, [r.to(d) for r in draws]))
    return res


def voc_family_config(workdir, family) -> dict:
    """config_44k (phase 5's training config) for GAN training of one
    vocoder family on phase 5's clips binarized with their waveforms."""
    voc = {"hifigan": {},
           "istft": dict(ISTFT_OVER),
           "pwg": {"vocoder": "network.vocoders.pwg.PWG"}}[family]
    return dict(train_config(workdir), **voc,
                binary_data_dir=os.path.join(workdir, "bin_voc"),
                work_dir=os.path.join(workdir, f"work_voc_{family}"),
                binarization_args={"shuffle": False, "with_align": True,
                                   "with_f0": True, "with_hubert": True,
                                   "with_spk_embed": False,
                                   "with_wav": True},
                hubert_path=os.path.join(workdir, "proj", "hubert",
                                         "hubert_soft.pt"),
                task_cls="training.task.vocoder.HifiGanTask",
                max_sentences=VOC_B, vocoder_segment_frames=VOC_SEG,
                max_updates=VOC_STEPS, val_check_interval=1, log_interval=1)


VOC_FAMILIES = ("hifigan", "istft", "pwg")


def voc_resume(bundle_fn: str) -> int:
    """Phase 11's child: for each family of the bundle (the phase starts one
    child per family, side by side), 2 steps from a fresh work_dir (a
    checkpoint after step 1), then a run resumed from that step-1
    checkpoint alone, under ``torch.use_deterministic_algorithms`` (its
    parent sets ``CUBLAS_WORKSPACE_CONFIG``); prints, per family, whether
    the two step-3 checkpoints are equal bit for bit."""
    import shutil

    import torch

    from diffsvc_tpu_torch.config import HParams
    from diffsvc_tpu_torch.run import run_task

    with open(bundle_fn) as f:
        bundle = json.load(f)
    torch.use_deterministic_algorithms(True, warn_only=True)
    out = {}
    for family, cfg in bundle["configs"].items():
        a, b = cfg["work_dir"] + "_det", cfg["work_dir"] + "_resumed"
        ta = run_task(HParams(dict(cfg, work_dir=a)), device=bundle["device"])
        os.makedirs(b)
        shutil.copy(os.path.join(a, "model_ckpt_steps_1.ckpt"), b)
        tb = run_task(HParams(dict(cfg, work_dir=b)), device=bundle["device"])
        sa, sb = ta.state_dict(), tb.state_dict()
        same = all(torch.equal(sb["state_dict"][k], v)
                   for k, v in sa["state_dict"].items())
        for oa, ob in zip(sa["optimizer_states"], sb["optimizer_states"]):
            same = same and all(torch.equal(ob["state"][i][k], v)
                                for i, st in oa["state"].items()
                                for k, v in st.items())
        out[family] = {"identical": bool(same),
                       "resumed_steps": [h["step"] for h in tb.history]}
    print(json.dumps(out))
    return 0


def adamw_plain(p0, grads, lrs, b1, b2, eps, wd):
    """optax.adamw's update written out on whole tensors, step by step, in
    float64."""
    p = p0.double()
    m, v = 0.0 * p, 0.0 * p
    for t, (g, lr) in enumerate(zip(grads, lrs), start=1):
        g = g.double()
        m = (1.0 - b1) * g + b1 * m
        v = (1.0 - b2) * g * g + b2 * v
        m_hat, v_hat = m / (1.0 - b1 ** t), v / (1.0 - b2 ** t)
        p = p - lr * (m_hat / (v_hat.sqrt() + eps) + wd * p)
    return p


def adamw_vs_plain(task) -> dict:
    """The task's AdamW (its class and settings, driven through
    ``VocoderTask._update``, which sets the rate from the update count) on
    the card, ADAMW_STEPS steps on fixed random grads over as many values
    as the generator has parameters, against :func:`adamw_plain` at JAX's
    settings and optax's schedule lr * 0.999 ** (n / 1000); and with
    torch's default weight decay as the planted fault."""
    import torch
    from torch import nn

    from diffsvc_tpu_torch.training import vocoder_task as vt

    n = sum(p.numel() for p in task.gen.parameters())
    gen = torch.Generator(device=task.device).manual_seed(5)
    p0 = torch.randn(n, generator=gen, device=task.device) * 0.1
    grads = [torch.randn(n, generator=gen, device=task.device) * 1e-3
             for _ in range(ADAMW_STEPS)]
    lrs = [task.lr * 0.999 ** (i / 1000) for i in range(ADAMW_STEPS)]
    cfg = {k: task.opt_g.defaults[k] for k in ("betas", "eps",
                                                "weight_decay")}

    def port(**over):
        mod = nn.Module()
        mod.w = nn.Parameter(p0.clone())
        opt = type(task.opt_g)([mod.w], lr=task.lr, **dict(cfg, **over))
        for g in grads:
            vt.VocoderTask._update(task, opt, mod, (mod.w * g).sum())
        return mod.w.detach()

    # JAX's settings: optax.adamw(sched, b1=0.8, b2=0.99), eps and weight
    # decay at optax's defaults
    ref = adamw_plain(p0, grads, lrs, 0.8, 0.99, 1e-8, 1e-4) - p0.double()
    res = {"rel_l2": rel_l2(port() - p0, ref),
           "fault_rel_l2": rel_l2(port(weight_decay=1e-2) - p0, ref),
           "tol": ADAMW_TOL, "values": n, "steps": ADAMW_STEPS,
           "settings": cfg}
    log(f"[voc] the vocoder task's AdamW on the card vs optax's adamw "
        f"written out, {ADAMW_STEPS} steps on {n} values: rel_l2 "
        f"{res['rel_l2']:.3e} (tol {ADAMW_TOL:g}); planted fault [weight "
        f"decay 1e-2: {res['fault_rel_l2']:.3e}]")
    if not res["rel_l2"] <= ADAMW_TOL < res["fault_rel_l2"]:
        raise SmokeError(f"the vocoder task's AdamW: {res}")
    return res


def first_update_err(mod, before, lr) -> float:
    """Each parameter of ``mod`` after one AdamW step against optax's first
    update on its own grad from ``before`` (weight decay 1e-4, eps 1e-8,
    the rate at count 0): the largest error beyond 4 f32 ulps of the value,
    in units of lr."""
    import torch

    ulp = torch.finfo(torch.float32).eps
    worst = 0.0
    for k, p in mod.named_parameters():
        g, p0 = p.grad.double(), before[k].double()
        ref = p0 * (1 - lr * 1e-4) - lr * g / (g.abs() + 1e-8)
        err = (p.detach().double() - ref).abs() - 4 * ulp * ref.abs()
        worst = max(worst, float(err.max()) / lr)
    return worst


def g_grads_smooth(task, batch, draws, tf32=False):
    """G's grads of the task's G loss against its current D with every
    leaky ReLU smooth (:func:`smooth_leaky_relus`), TF32 off, as one float64
    vector on the CPU; ``tf32``: TF32 on for products and cuDNN (the
    planted fault)."""
    import torch

    from diffsvc_tpu_torch.models.nn import true_f32_convs

    with contextlib.ExitStack() as stack:
        stack.enter_context(smooth_leaky_relus())
        if tf32:
            for flags in (torch.backends.cuda.matmul, torch.backends.cudnn):
                stack.enter_context(swapped(flags, allow_tf32=True))
        else:
            stack.enter_context(true_f32_convs())
        loss, _ = task.g_loss(task.batch_on_device(batch), draws)
        grads = torch.autograd.grad(loss, list(task.gen.parameters()))
    return torch.cat([g.double().cpu().reshape(-1) for g in grads])


def gan_step_vs_cpu(device, hp) -> dict:
    """One hifigan GAN step on the card and on the CPU at B=2 of the crops,
    the same init and draws, and the planted fault, the card's G grads
    against the old D; before it, G's grads with smooth leaky ReLUs on each
    side and on the card with TF32 on (the planted fault)."""
    import numpy as np
    import torch

    from diffsvc_tpu_torch.config import HParams
    from diffsvc_tpu_torch.data.dataset import FastSpeechDataset
    from diffsvc_tpu_torch.models.nn import true_f32_convs
    from diffsvc_tpu_torch.training.vocoder_task import (VocoderTask,
                                                         crop_batch)

    hp = HParams(hp)
    ds = FastSpeechDataset("train", hp)
    batch = crop_batch([ds._get_item(i) for i in range(2)], hp,
                       np.random.RandomState(3), VOC_SEG)
    cpu, card = (VocoderTask(hp, device=d) for d in ("cpu", device))
    draws = cpu.draw(cpu.batch_on_device(batch),
                     torch.Generator().manual_seed(4))
    dev_draws = tuple(x.to(device) for x in draws)
    twin = {"cpu": g_grads_smooth(cpu, batch, draws),
            "card": g_grads_smooth(card, batch, dev_draws),
            "card_tf32": g_grads_smooth(card, batch, dev_draws, tf32=True)}
    old_d = {k: v.clone() for k, v in card.disc.state_dict().items()}
    old_g = {k: v.clone() for k, v in card.gen.state_dict().items()}
    t0 = time.time()
    m_cpu = cpu.train_step(batch, draws=draws)
    cpu_s = time.time() - t0
    m_dev = card.train_step(batch, draws=dev_draws)

    def flat(mod):
        return torch.cat([p.grad.detach().double().cpu().reshape(-1)
                          for p in mod.parameters()])

    def rel(a, b):
        return float((a - b).norm() / b.norm())

    res = {"losses": {k: abs(float(m_dev[k]) - float(m_cpu[k]))
                      / abs(float(m_cpu[k])) for k in ("d_loss", "g_loss")},
           "d_grad_rel_l2": rel(flat(card.disc), flat(cpu.disc)),
           "g_grad_rel_l2": rel(flat(card.gen), flat(cpu.gen)),
           "twin_g_grad_rel_l2": rel(twin["card"], twin["cpu"]),
           "twin_fault_rel_l2": rel(twin["card_tf32"], twin["cpu"]),
           "update_err_lr": max(first_update_err(card.gen, old_g, card.lr),
                                first_update_err(card.disc, old_d, card.lr)),
           "cpu_step_s": cpu_s}
    # the fault: G's grads against the D from before the step
    updated_d = {k: v.clone() for k, v in card.disc.state_dict().items()}
    card.disc.load_state_dict(old_d)
    card.gen.load_state_dict(old_g)
    with true_f32_convs():
        loss, _ = card.g_loss(card.batch_on_device(batch), dev_draws)
        grads = torch.autograd.grad(loss, list(card.gen.parameters()))
    card.disc.load_state_dict(updated_d)
    res["fault_g_grad_rel_l2"] = rel(
        torch.cat([g.double().cpu().reshape(-1) for g in grads]),
        flat(cpu.gen))
    log(f"[voc] hifigan GAN step card vs CPU (B=2, TF32 off): losses "
        f"{ {k: f'{v:.2e}' for k, v in res['losses'].items()} } (tol "
        f"{GAN_LOSS_TOL:g}), D grads rel_l2 {res['d_grad_rel_l2']:.3e} (tol "
        f"{GAN_GRAD_TOL['d']:g}), G grads {res['g_grad_rel_l2']:.3e} (tol "
        f"{GAN_GRAD_TOL['g']:g}; planted fault, G against the old D: "
        f"{res['fault_g_grad_rel_l2']:.3e}); G's grads with smooth leaky "
        f"ReLUs (at the init) {res['twin_g_grad_rel_l2']:.3e} (tol "
        f"{GAN_TWIN_TOL:g}; planted fault, TF32 on the card: "
        f"{res['twin_fault_rel_l2']:.3e}); the card's params against the "
        f"first adamw update on its own grads within "
        f"{res['update_err_lr']:.2e} lr (limit {GAN_UPDATE_TOL:g}); the "
        f"CPU's step {cpu_s:.1f}s")
    if not (max(res["losses"].values()) <= GAN_LOSS_TOL
            and res["d_grad_rel_l2"] <= GAN_GRAD_TOL["d"]
            and res["g_grad_rel_l2"] <= GAN_GRAD_TOL["g"]
            < res["fault_g_grad_rel_l2"]
            and res["twin_g_grad_rel_l2"] <= GAN_TWIN_TOL
            < res["twin_fault_rel_l2"]
            and res["update_err_lr"] <= GAN_UPDATE_TOL):
        raise SmokeError(f"hifigan GAN step card vs CPU: {res}")
    res["adamw"] = adamw_vs_plain(card)
    return res


def voc_train_setup(device, workdir, inputs) -> dict:
    """(d)'s configs, one per family, on phase 5's clips binarized with
    their waveforms (the binarize timed into the returned ``res``)."""
    import numpy as np
    import yaml

    from diffsvc_tpu_torch.config import HParams, set_hparams
    from diffsvc_tpu_torch.data.binarizer import binarize

    res, cfgs = {}, {}
    for fam in VOC_FAMILIES:
        cfg = voc_family_config(workdir, fam)
        cfg["raw_data_dir"] = inputs["raw"]
        cfg_fn = os.path.join(workdir, f"voc_{fam}.yaml")
        with open(cfg_fn, "w") as f:
            yaml.safe_dump(cfg, f)
        cfgs[fam] = dict(set_hparams(config=cfg_fn, exp_name=f"voc_{fam}",
                                     reset=True, print_hparams=False))
    t0 = time.time()
    binarize(HParams(cfgs["hifigan"]), device=device)
    res["binarize_s"] = time.time() - t0
    lengths = np.load(os.path.join(cfgs["hifigan"]["binary_data_dir"],
                                   "train_lengths.npy"))
    log(f"[voc] binarized {TRAIN_CLIPS} clips with their waveforms in "
        f"{res['binarize_s']:.2f}s ({len(lengths)} train items)")
    return {"res": res, "cfgs": cfgs}


def start_voc_resume(device, workdir, cfgs) -> dict:
    """(d)'s resume checks: one ``chip_smoke.py --vocoder-resume`` child per
    family, started side by side; {family: (process, (out, err))}."""
    procs = {}
    try:
        for fam, cfg in cfgs.items():
            bundle = os.path.join(workdir, f"voc_resume_{fam}.json")
            with open(bundle, "w") as f:
                json.dump({"device": str(device), "configs": {fam: cfg}}, f)
            logs = [open(f"{bundle[:-5]}.{k}", "w+") for k in ("out", "err")]
            procs[fam] = (subprocess.Popen(
                [sys.executable, os.path.join(ROOT, "chip_smoke.py"),
                 "--vocoder-resume", bundle], stdout=logs[0],
                stderr=logs[1], text=True,
                env=dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")),
                logs)
    except BaseException:
        stop_children(procs)
        raise
    return procs


def stop_children(procs: dict) -> None:
    for proc, logs in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        for f in logs:
            f.close()


def phase_voc_train(device, workdir, setup, procs, launches):
    """(d) ``train_vocoder`` through ``run_task`` with a vocoder task_cls,
    for the hifigan (openvpi NSF-HiFiGAN width, MPD + MSD), istft (512 x 8,
    MPD + MSD) and pwg (its discriminator) families, on phase 5's clips
    binarized with their waveforms (``setup``, :func:`voc_train_setup`):
    2 steps at B=8 of 32-frame crops, the losses finite, ms per step and
    peak memory, K1-K6 at 0; one hifigan step card vs CPU; then the resume
    children's records (``procs``, :func:`start_voc_resume`: in a child
    process per family under deterministic algorithms, a resume from the
    step-1 checkpoint equal to the uninterrupted step 2 bit for bit)."""
    import numpy as np
    import torch

    from diffsvc_tpu_torch.config import HParams
    from diffsvc_tpu_torch.run import run_task

    res, cfgs = dict(setup["res"]), setup["cfgs"]
    t0 = time.time()
    try:
        for fam, cfg in cfgs.items():
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            label = f"train_vocoder {fam}"
            with counted(label, launches, moved=(), still=ALL_KERNELS,
                         tag="voc"):
                t1 = time.time()
                task = run_task(HParams(cfg), device=device)
                torch.cuda.synchronize()
                wall = time.time() - t1
            hist = task.history
            log(f"[voc] {label}: run_task took {wall:.1f}s")
            rec = {"steps": task.step, "wall_s": wall,
                   "ms_per_step": [h["seconds_per_step"] * 1e3
                                   for h in hist],
                   "losses": [{k: v for k, v in h.items()
                               if k not in ("step", "seconds_per_step")}
                              for h in hist],
                   # the run's own peak, above what earlier phases still
                   # hold
                   "peak_gb": (torch.cuda.max_memory_allocated() - held)
                   / 2 ** 30,
                   "gen_params_m": sum(p.numel() for p in
                                       task.gen.parameters()) / 1e6,
                   "disc_params_m": sum(p.numel() for p in
                                        task.disc.parameters()) / 1e6,
                   "checkpoints": sorted(os.listdir(cfg["work_dir"]))}
            res[fam] = rec
            finite = all(np.isfinite(v) for h in rec["losses"]
                         for v in h.values())
            log(f"[voc] {label}: {rec['steps']} steps at B={VOC_B} x "
                f"{VOC_SEG} frames, ms/step "
                f"{[round(v, 1) for v in rec['ms_per_step']]}, peak "
                f"{rec['peak_gb']:.2f} GB, G {rec['gen_params_m']:.1f}M / D "
                f"{rec['disc_params_m']:.1f}M params, last losses "
                f"{ {k: round(v, 4) for k, v in rec['losses'][-1].items()} }"
                f", checkpoints {rec['checkpoints']}")
            if not finite or rec["steps"] != VOC_STEPS \
                    or rec["checkpoints"] != ["model_ckpt_steps_1.ckpt",
                                              "model_ckpt_steps_2.ckpt"]:
                raise SmokeError(f"{label}: {rec}")
            del task
        res["step_vs_cpu"] = gan_step_vs_cpu(device, cfgs["hifigan"])
        res["step_vs_cpu_s"] = time.time() - t0
        res["resume"] = {}
        for fam, (proc, (out, err)) in procs.items():
            code = proc.wait(timeout=VOC_TIMEOUT)
            out.seek(0)
            err.seek(0)
            if code != 0:
                raise SmokeError(f"vocoder resume {fam}: exit {code}\n"
                                 f"{err.read()[-3000:]}")
            res["resume"].update(json.loads(out.read().strip()
                                            .splitlines()[-1]))
    finally:
        stop_children(procs)
    res["resume_s"] = time.time() - t0
    log(f"[voc] resume from step 1 vs the uninterrupted step 2 (a child "
        f"process per family, deterministic algorithms, side by side with "
        f"phase 11's routes and runs; {res['resume_s']:.1f}s from the "
        f"first run_task here): {res['resume']}")
    if not all(r["identical"] and r["resumed_steps"] == [VOC_STEPS]
               for r in res["resume"].values()):
        raise SmokeError(f"vocoder resume not bit exact: {res['resume']}")
    return res


def phase_voc(device, workdir, project):
    """Phase 11: the other vocoders and GAN vocoder training (``[voc]``
    lines), on earlier phases' inputs: phase 4's HuBERT-soft file and 6.5 s
    clip, phase 7's 17 s clip, phase 5's raw clips."""
    t0 = time.time()
    launches, seconds = {}, {}
    inputs = {"hubert": os.path.join(os.path.dirname(project["cfg_fn"]),
                                     "hubert", "hubert_soft.pt"),
              "clip": project["wavs"][0],
              "batch_clip": os.path.join(workdir, "batch_clip.wav"),
              "raw": train_config(workdir)["raw_data_dir"]}
    res = {"launches": launches, "seconds": seconds}
    # (d)'s resume children start first and run beside (a)-(d): the
    # routes' RTF and busy share and the GAN steps' ms are read beside them
    t = time.time()
    setup = voc_train_setup(device, workdir, inputs)
    procs = start_voc_resume(device, workdir, setup["cfgs"])
    seconds["setup"] = time.time() - t
    try:
        for part, fn in (("istft", lambda: phase_voc_istft(
                              device, workdir, inputs, launches)),
                         ("pwg", lambda: phase_voc_pwg(device, workdir,
                                                       inputs, launches)),
                         ("inventory", lambda: phase_voc_inventory(device)),
                         ("train", lambda: phase_voc_train(
                             device, workdir, setup, procs, launches))):
            t = time.time()
            res[part] = fn()
            seconds[part] = time.time() - t
    finally:
        stop_children(procs)
    seconds["total"] = time.time() - t0
    log(f"[voc] phase 11 took { {k: round(v, 1) for k, v in seconds.items()} }s")
    return res


# ---------------------------------------------------------------------------
# Phase 12: the mesh's seq axis
# ---------------------------------------------------------------------------

# (a)'s batch: config_44k at full width, B=4 clips of 4096 frames (47.6 s at
# hop 512, 44.1 kHz) with 2380 HuBERT-soft frames (50 Hz) padded to 2432 (a
# multiple of 128, as the collate pads), on a (data = 2, seq = 2) grid.
SEQ_B, SEQ_T, SEQ_UNITS, SEQ_PADDED_UNITS = 4, 4096, 2380, 2432
SEQ_GRID = (2, 2)
# A halo of H - 1 changes an own frame only through the one path that
# takes every layer's furthest tap, and that path shrinks the change by
# about two per layer: at 20 layers it is below f32's resolution (the
# loss bit for bit, the grads within their summation order; the reading is
# printed), so the fault is gated at one dilation cycle (4 layers, H = 15),
# where it reads 6.2e-4 per tensor (H100 80GB HBM3, 700 W).
SEQ_FAULT_LAYERS = 4
# K4 at the f32 stream computes in 3xTF32 products: its step differs from
# the plain versions' true f32 by up to 5.4e-4 per tensor on (a)'s batch (the
# conditioner and input projections, whose grads cancel most), and a
# window sum through K4 from the unsharded step through K4 by 1.4e-6 or
# 2.6e-4, as the spec range and the seed of the batch go (H100 80GB HBM3,
# 700 W); the plain versions' window sum reads 1.6e-6 on both.  The decomposition's exactness is held on
# the plain versions at DIST_TOL; the K4 route at phase 5's limit on a
# step through the kernels against the plain versions.
SEQ_K4_TOL = TRAIN_STEP_TOL
SEQ_RUN_STEPS = 2
SEQ_RUN_B = 8            # (c)'s max_sentences (per data block)
SEQ_HEAD_SEED = 11


def seq_hp(workdir: str):
    """Phase 6's config_44k (full width, its binarizer's spec range) on the
    (2, 2) grid: (a) and (b) at the f32 train stream, ``run_task`` (c) at
    the config's own."""
    from diffsvc_tpu_torch.config import HParams, set_hparams

    own = set_hparams(config=os.path.join(workdir, "own.yaml"),
                      exp_name="smoke_seq", reset=True, print_hparams=False)
    run_hp = HParams(own, mesh_axes="data,seq", mesh_shape=list(SEQ_GRID),
                     max_sentences=SEQ_RUN_B, max_updates=SEQ_RUN_STEPS)
    return HParams(run_hp, diffnet_train_stream_dtype="f32"), run_hp


def seq_batch(hp, real: int = SEQ_B, seed: int = 0) -> dict:
    """(a)'s collated batch: random units, a uniform alignment (row 1's
    last 496 frames padding), f0 around 200 Hz, mels drawn inside the
    config's spec range; rows from ``real`` on padding (``sample_mask``
    0)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    b, t, u = SEQ_B, SEQ_T, SEQ_UNITS
    m = int(hp["audio_num_mel_bins"])
    lo, hi = (np.broadcast_to(np.asarray(hp.get(k, d), np.float32).ravel(),
                              (m,)) for k, d in (("spec_min", -6.0),
                                                 ("spec_max", 1.5)))
    mel2ph = np.tile(np.minimum(np.arange(t) * u // t, u - 1) + 1,
                     (b, 1)).astype(np.int32)
    mel2ph[1, 3600:] = 0
    hubert = np.zeros((b, SEQ_PADDED_UNITS, int(hp["hidden_size"])),
                      np.float32)
    hubert[:, :u] = rng.randn(b, u, hubert.shape[2]) * 0.3
    batch = {"hubert": hubert, "mel2ph": mel2ph,
             "f0": (7.6 + 0.2 * rng.randn(b, t)).astype(np.float32),
             "uv": np.zeros((b, t), np.float32),
             "energy": np.zeros((b, t), np.float32),
             "mels": (lo + (hi - lo) * rng.rand(b, t, m)).astype(np.float32),
             "sample_mask": (np.arange(b) < real).astype(np.float32)}
    for k in ("hubert", "mel2ph", "f0", "mels"):
        batch[k][real:] = 0
    return batch


def seq_task(hp, device, layers=None, grid=None):
    """An SVCTask on ``grid`` (default the process group's) with its
    seeded init and a DiffNet head drawn from a seed (a zero head, JAX's
    init, zeroes every gradient but the head's); ``layers`` cuts the
    DiffNet's depth."""
    import torch

    from diffsvc_tpu_torch.config import HParams
    from diffsvc_tpu_torch.training.task import SVCTask

    if layers:
        hp = HParams(hp, residual_layers=layers)
    task = SVCTask(hp, device=device, grid=grid)
    head = task.model.denoise_fn.output_projection
    with torch.no_grad():
        head.weight.copy_(torch.randn(head.weight.shape, generator=torch.
                                      Generator().manual_seed(SEQ_HEAD_SEED))
                          * 0.05)
    return task


def seq_shares(task, batch, t, noise, around=None):
    """Every cell's share of the (2, 2) grid, computed in this process and
    summed: (loss, grads), the ranks' SUM all-reduce.  ``around(cell)``
    gives a context each cell's call runs in."""
    import numpy as np

    from diffsvc_tpu_torch.parallel import dist

    d, s = SEQ_GRID
    n, tm = np.shape(batch["mels"])[:2]
    saved, task.grid = task.grid, dist.Grid(d, s)
    loss, grads = 0.0, None
    try:
        for i in range(d):
            for j in range(s):
                with (around((i, j)) if around else contextlib.nullcontext()):
                    lo, g = task.loss_and_grads(
                        batch, t=t, noise=noise, rows=dist.block(n, i, d),
                        frames=dist.frames(tm, j, s))
                loss += float(lo)
                grads = g if grads is None else \
                    [a + b for a, b in zip(grads, g)]
    finally:
        task.grid = saved
    return loss, grads


def halo_short():
    """The planted fault: a halo of H - 1."""
    from diffsvc_tpu_torch.parallel import dist

    real = dist.halo
    return swapped(dist, halo=lambda net, t: real(net, t) - 1)


def halo_in_loss():
    """The planted fault: the halo frames counted in the loss."""
    from diffsvc_tpu_torch.models.diffusion import GaussianDiffusion

    real = GaussianDiffusion.training_loss

    def counted_all(self, batch, **kw):
        kw["own"] = None if kw.get("own") is None else \
            kw["own"].new_ones(kw["own"].shape)
        return real(self, batch, **kw)

    return swapped(GaussianDiffusion, training_loss=counted_all)


def seq_readings(task, batch, t, noise, ref, fault=None, around=None,
                 against=None) -> dict:
    """The (2, 2) share sum against ``ref`` = (loss, grads) of the
    unsharded step: the largest per-tensor rel-L2 and the loss's relative
    error (under ``fault``, a context from the two above; ``around`` as
    :func:`seq_shares`'s); with ``against``, another unsharded step, the
    largest per-tensor rel-L2 against it too."""
    with (fault() if fault else contextlib.nullcontext()):
        loss, grads = seq_shares(task, batch, t, noise, around)
    rels = sorted(((rel_l2(a, r), n) for n, a, r in
                   zip(task.names, grads, ref[1])), reverse=True)
    out = {"rel": rels[0][0], "loss_rel": abs(loss - ref[0]) / abs(ref[0]),
           "worst": [f"{n} {r:.2e}" for r, n in rels[:3]]}
    if against is not None:
        out["rel_k4"] = max(rel_l2(a, r) for a, r in zip(grads, against[1]))
    return out


def k4_plain():
    """K4's wrappers replaced by their plain (true f32) versions."""
    from diffsvc_tpu_torch.ops.hopper import diffnet_stack_train as k4

    return swapped(k4, residual_stack_train_fwd=k4.
                   residual_stack_train_fwd_plain,
                   residual_stack_train_batched_bwd=k4.
                   residual_stack_train_batched_bwd_plain)


def seq_in_process(device, hp, batch, launches) -> dict:
    """(a): the unsharded step against the sum of the four windows' shares:
    on the plain versions (true f32) at ``DIST_TOL`` with the planted
    faults, then through K4 at the f32 stream (the route of both) at
    ``SEQ_K4_TOL``, each window's ms, peak memory and counts."""
    import torch

    from diffsvc_tpu_torch.models import diffnet
    from diffsvc_tpu_torch.parallel import dist

    task = seq_task(hp, device, grid=dist.Grid(1, 1))
    t, noise = task.draws(batch)
    h = dist.halo(task.model.denoise_fn, SEQ_T)
    c = task.model.denoise_fn.residual_channels
    res = {"halo": h, "route_unsharded": diffnet.train_route(
        task.model.denoise_fn.n_layers, task.model.denoise_fn.cycle, SEQ_T,
        c, SEQ_B, "f32"), "runs": {}}
    if res["route_unsharded"] == "per_sample":
        raise SmokeError(f"(a)'s unsharded step would take K5: {res}")
    k4_only = dict(moved=("residual_stack_train_batched",),
                   still=("residual_stack_train", "fused_residual_block"),
                   tag="seq")

    @contextlib.contextmanager
    def measured(label):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        with counted(label, launches, **k4_only):
            yield
        torch.cuda.synchronize()
        res["runs"][label] = {"ms": (time.time() - t0) * 1e3, "peak_gb": (
            torch.cuda.max_memory_allocated() - base) / 1e9}

    def unsharded(model):
        loss, grads = model.loss_and_grads(batch, t=t, noise=noise)
        return float(loss), grads

    # the decomposition, in true f32: the plain versions on the card
    with k4_plain():
        ref = unsharded(task)
        res["exact"] = seq_readings(task, batch, t, noise, ref)
        res["halo_in_loss"] = seq_readings(task, batch, t, noise, ref,
                                           halo_in_loss)
        res["halo_short_20"] = seq_readings(task, batch, t, noise, ref,
                                            halo_short)
        cut = seq_task(hp, device, layers=SEQ_FAULT_LAYERS,
                       grid=dist.Grid(1, 1))
        res["halo_cut"] = dist.halo(cut.model.denoise_fn, SEQ_T)
        cut_ref = unsharded(cut)
        res["cut_exact"] = seq_readings(cut, batch, t, noise, cut_ref)
        res["halo_short"] = seq_readings(cut, batch, t, noise, cut_ref,
                                         halo_short)
        del cut, cut_ref
    # the route: K4 on the unsharded step and on every window
    with measured("(a) unsharded"):
        k4_ref = unsharded(task)
    res["k4_vs_plain"] = seq_readings(task, batch, t, noise, ref,
                                      around=lambda cell: measured(
                                          f"(a) window {cell}"),
                                      against=k4_ref)
    res["k4_unsharded_vs_plain"] = {"rel": max(
        rel_l2(a, r) for a, r in zip(k4_ref[1], ref[1])),
        "loss_rel": abs(k4_ref[0] - ref[0]) / abs(ref[0])}
    del task, ref, k4_ref
    torch.cuda.empty_cache()
    un = res["runs"]["(a) unsharded"]
    log(f"[seq] (a) config_44k B={SEQ_B} T={SEQ_T} on a {SEQ_GRID} grid, "
        f"halo H={h}: unsharded route {res['route_unsharded']} (K4 f32), "
        f"{un['ms']:.1f} ms, peak {un['peak_gb']:.3f} GB over its base "
        "(forward + backward, the process's first K4 call at these shapes)")
    for label, w in res["runs"].items():
        log(f"[seq] {label}: {w['ms']:.1f} ms, peak {w['peak_gb']:.3f} GB "
            f"({w['peak_gb'] / un['peak_gb']:.3f} of the unsharded step's)")
    plain = "the plain versions (true f32)"
    for key, what, tol, gated in (
            ("exact", f"the window sum on {plain}", DIST_TOL, "<="),
            ("halo_in_loss", "planted fault [halo frames in the loss]",
             DIST_TOL, ">"),
            ("halo_short_20", "fault [a halo of H - 1] at 20 layers, not "
             "gated: below f32's resolution", DIST_TOL, None),
            ("cut_exact", f"the window sum at {SEQ_FAULT_LAYERS} layers "
             f"(H={res['halo_cut']})", DIST_TOL, "<="),
            ("halo_short", f"planted fault [a halo of H - 1] at "
             f"{SEQ_FAULT_LAYERS} layers", DIST_TOL, ">"),
            ("k4_unsharded_vs_plain", "K4's unsharded step vs the plain "
             "one", SEQ_K4_TOL, "<="),
            ("k4_vs_plain", "K4's window sum vs the plain unsharded step",
             SEQ_K4_TOL, "<=")):
        r = res[key]
        log(f"[seq] (a) {what}: grads rel_l2 {r['rel']:.3e} (tol {tol:g}), "
            f"loss {r['loss_rel']:.3e} (tol {DIST_LOSS_TOL:g})"
            + (f"; vs K4's unsharded step {r['rel_k4']:.3e}"
               if "rel_k4" in r else "")
            + (f"; largest: {', '.join(r['worst'])}" if "worst" in r else ""))
        ok = r["rel"] <= tol and r["loss_rel"] <= DIST_LOSS_TOL \
            and r.get("rel_k4", 0.0) <= tol
        if (gated == "<=" and not ok) or (gated == ">" and r["rel"] <= tol):
            raise SmokeError(f"(a) {what}: {r}")
    return res


def seq_job(b: dict, device, rank: int, world: int) -> dict:
    """A rank of phase 12's (b) and (c) (``chip_smoke.py --dist-job seq``):
    two steps of the grid against rank 0's in-process share sum, then
    ``run_task`` for SEQ_RUN_STEPS steps, then one FS2-full step with
    dropout."""
    import numpy as np
    import torch

    from diffsvc_tpu_torch.config import HParams
    from diffsvc_tpu_torch.data.dataset import FastSpeechDataset
    from diffsvc_tpu_torch.parallel import dist
    from diffsvc_tpu_torch.run import run_task
    from diffsvc_tpu_torch.training import trainer as trainer_mod
    from diffsvc_tpu_torch.training.task import SVCTask

    hp = HParams(b["hp"])
    dist.maybe_initialize_distributed(
        HParams(hp, distributed=True, dist_backend="gloo"), device=device)
    out = {"rank": rank, "world": world, "cell": dist.grid(hp).cell(rank),
           "backend": torch.distributed.get_backend()}
    torch.use_deterministic_algorithms(True)

    # (b): two steps, the second on a ragged batch
    task = seq_task(hp, device)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    steps, path = [], dict.fromkeys(kernel_counts_all(), 0)
    for batch in b["batches"]:
        ref = seq_shares(task, batch, *task.draws(batch)) if rank == 0 \
            else None
        dist.all_reduce_sum([torch.zeros(1, device=device)])
        before = kernel_counts_all()
        ms, loss, grads = timed_step(task, batch)
        for k, v in kernel_counts_all().items():
            path[k] += v - before[k]
        rec = {"ms": ms, "loss": loss,
               "real": int(np.sum(batch["sample_mask"]))}
        if ref is not None:
            rec["rel"] = max(rel_l2(a, r) for a, r in zip(grads, ref[1]))
            rec["loss_rel"] = abs(loss - ref[0]) / abs(ref[0])
        steps.append(rec)
    torch.cuda.synchronize()
    out["b"] = {"steps": steps, "launches": path,
                "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    torch.save([p.detach().cpu() for p in task.params],
               f"{b['bundle']}.b.rank{rank}.pt")
    del task
    torch.cuda.empty_cache()

    # (c): run_task on the grid; the batches it builds and steps on
    run_hp = HParams(b["run_hp"], work_dir=b["work_dirs"][rank])
    built, stepped, losses = [], [], []
    real_build, real_step = trainer_mod.build_batches, SVCTask.train_step

    def build(*a, **k):
        built.append(real_build(*a, **k))
        return built[-1]

    def step(self, batch, **k):
        stepped.append(np.where(batch["sample_mask"] > 0, batch["id"],
                                -1).tolist())
        m = real_step(self, batch, **k)
        losses.append(float(m["loss"]))
        return m

    reset_counts()
    trainer_mod.build_batches, SVCTask.train_step = build, step
    try:
        run_task(run_hp, device=device)
    finally:
        trainer_mod.build_batches, SVCTask.train_step = real_build, real_step
    torch.cuda.synchronize()
    d2 = real_build(FastSpeechDataset("train", run_hp, shuffle=True), run_hp,
                    num_replicas=SEQ_GRID[0], rng=np.random.RandomState(
                        int(run_hp.get("seed", 1234))))
    out["c"] = {"losses": losses, "first_batch": stepped[0],
                "first_built": [int(i) for i in built[0][0]],
                "data_only_first": [int(i) for i in d2[0]],
                "launches": kernel_counts_all()}

    # (c): FS2-full with dropout, one step
    reset_counts()
    fs2 = seq_task(HParams(hp, no_fs2=False, dropout=0.1), device)
    enc = []
    fs2.model.fs2.encoder.register_forward_hook(
        lambda m, a, o: enc.append(o.detach().cpu()))
    m = fs2.train_step(b["batches"][0])
    torch.save(enc[0], f"{b['bundle']}.fs2.rank{rank}.pt")
    out["fs2"] = {"loss": float(m["loss"]), "launches": kernel_counts_all()}
    dist.destroy()
    return out


def phase_seq(device, workdir):
    """Phase 12 (``[seq]`` lines) on phase 6's data: (a) in one process
    the unsharded step against the (2, 2) grid's window shares summed;
    (b) four gloo ranks on this card at (2, 2); (c) ``run_task`` on them,
    then an FS2-full step with dropout."""
    import math

    import torch

    t0 = time.time()
    res = {"launches": {}, "seconds": {}}
    hp, run_hp = seq_hp(workdir)
    batch = seq_batch(hp)
    res["a"] = seq_in_process(device, hp, batch, res["launches"])
    res["seconds"]["a"] = time.time() - t0

    bundle = os.path.join(workdir, "seq.pt")
    torch.save({"hp": dict(hp), "run_hp": dict(run_hp), "device": str(device),
                "bundle": bundle,
                "batches": [batch, seq_batch(hp, real=SEQ_B - 1)],
                "work_dirs": [os.path.join(workdir, f"seq_work{r}")
                              for r in range(4)]}, bundle)
    ranks = run_jobs([("seq", 4, bundle)])[0]
    res["seconds"]["ranks"] = time.time() - t0 - res["seconds"]["a"]
    r0 = ranks[0]["b"]
    for i, st in enumerate(r0["steps"]):
        log(f"[seq] (b) 4 gloo ranks {SEQ_GRID} step {i + 1}: {st['real']} "
            f"real rows of {SEQ_B}, loss {st['loss']:.6f}; all-reduced grads "
            f"vs rank 0's one-process share sum rel_l2 {st['rel']:.3e} (tol "
            f"{DIST_TOL:g}), loss {st['loss_rel']:.3e} (tol "
            f"{DIST_LOSS_TOL:g}); ms per step " + " / ".join(
                f"{r['b']['steps'][i]['ms']:.1f}" for r in ranks)
            + " (ranks 0-3)")
        if not (st["rel"] <= DIST_TOL and st["loss_rel"] <= DIST_LOSS_TOL):
            raise SmokeError(f"(b) step {i + 1}: {st}")
    params = [torch.load(f"{bundle}.b.rank{r}.pt") for r in range(4)]
    res["b_bit_equal"] = all(torch.equal(a, b) for p in params[1:]
                             for a, b in zip(params[0], p))
    for r in ranks:
        cell, rb, rc, rf = r["cell"], r["b"], r["c"], r["fs2"]
        log(f"[seq] (b) rank {r['rank']} at {tuple(cell)}: kernel launches "
            f"{rb['launches']}, peak memory {rb['peak_mem_gb']:.2f} GB; (c) "
            f"run_task losses {[round(x, 5) for x in rc['losses']]}, "
            f"launches {rc['launches']}; FS2-full step loss "
            f"{rf['loss']:.5f}, launches {rf['launches']}")
        for part, counts in (("(b)", rb["launches"]),
                             ("(c) run_task", rc["launches"]),
                             ("(c) FS2-full", rf["launches"])):
            res["launches"][f"{part} rank {r['rank']}"] = counts
            if counts["residual_stack_train_batched"] <= 0 \
                    or counts["residual_stack_train"] \
                    or counts["fused_residual_block"]:
                raise SmokeError(f"{part} rank {r['rank']}: K4 must move, "
                                 f"K5 and K6 not: {counts}")
        if len(rc["losses"]) != SEQ_RUN_STEPS or not all(
                math.isfinite(x) for x in rc["losses"] + [rf["loss"]]):
            raise SmokeError(f"(c) rank {r['rank']}: {rc['losses']}, "
                             f"{rf['loss']}")
    first = ranks[0]["c"]
    same_batch = all(r["c"]["first_built"] == first["data_only_first"]
                     and r["c"]["first_batch"] == first["first_batch"]
                     for r in ranks) and [
        i for i in first["first_batch"] if i >= 0] == first["data_only_first"]
    enc = [torch.load(f"{bundle}.fs2.rank{r}.pt") for r in range(4)]
    res["fs2_blocks_bit_equal"] = [torch.equal(enc[0], enc[1]),
                                   torch.equal(enc[2], enc[3])]
    log(f"[seq] (b) the four ranks' params bit-equal {res['b_bit_equal']}; "
        f"(c) the first batch's items {first['first_batch']} (data-only d=2: "
        f"{first['data_only_first']}) on every rank {same_batch}; FS2-full "
        f"encoder output bit-equal within blocks (ranks 0/1, 2/3) "
        f"{res['fs2_blocks_bit_equal']}")
    if not (res["b_bit_equal"] and same_batch
            and all(res["fs2_blocks_bit_equal"])):
        raise SmokeError(f"phase 12 (b)/(c): {res}")
    res["ranks"] = ranks
    res["seconds"]["total"] = time.time() - t0
    log(f"[seq] phase 12 took { {k: round(v, 1) for k, v in res['seconds'].items()} }s")
    return res


# ---------------------------------------------------------------------------
# Phase 13: the ONNX export
# ---------------------------------------------------------------------------

# The graphs are traced at ONNX_TRACE frames and run by the port's numpy
# runtime at ONNX_T (1.86 s at hop 512, 44.1 kHz; ONNX_T_PH HuBERT frames at
# 50 Hz), the hifigan graph at ONNX_VOC_T: its numpy convolutions are the
# runtime's slow part.  The limits are the kernels' own f32 limits.
ONNX_TRACE, ONNX_T, ONNX_T_PH, ONNX_VOC_T = 10, 160, 93, 24
ONNX_ACC = 100          # PLMS: 10 steps, 11 denoiser evaluations
ONNX_STEP = 500         # (a)'s diffusion step
ONNX_TOL = {"denoise": TOL[("residual_stack", "f32")],
            "chain": TOL[("plms_ladder", "f32")],
            "hifigan": TOL[("vocoder_tail", "f32")]}
FAST_KEYS = ("sampler", "dpmpp_grid", "pndm_speedup", "sampler_clip_x0")


def onnx_features(seed: int = 0) -> dict:
    """Seeded encoder inputs at ONNX_T frames: HuBERT-like units, a
    monotone 1-based alignment, log2 f0 around 200 Hz with a vibrato, and
    x_T [1, 1, M, T]."""
    import numpy as np

    rng = np.random.RandomState(seed)
    t = np.arange(ONNX_T)
    return {"hubert": (rng.randn(1, ONNX_T_PH, H) * 0.3).astype(np.float32),
            "mel2ph": (np.minimum(t * ONNX_T_PH // ONNX_T, ONNX_T_PH - 1)
                       + 1)[None].astype(np.int64),
            "f0": np.log2(200.0 * 2 ** (0.3 * np.sin(t / 9.0)))[None]
            .astype(np.float32),
            "noise": rng.randn(1, 1, M, ONNX_T).astype(np.float32)}


@contextlib.contextmanager
def hp_items(hp, items: dict):
    """hparams entries replaced for the duration of the block."""
    saved = {k: hp[k] for k in items if k in hp}
    hp.update(items)
    try:
        yield
    finally:
        for k in items:
            hp.pop(k, None)
        hp.update(saved)


def card_mel(model, feats, device, speedup: int):
    """``GaussianDiffusion.infer`` on the card (K2) from the features' x_T:
    the ln-mel [1, M, T], numpy."""
    import numpy as np
    import torch

    batch = {k: torch.from_numpy(feats[k]).to(device)
             for k in ("hubert", "mel2ph", "f0")}
    x_t = torch.from_numpy(np.ascontiguousarray(
        feats["noise"][:, 0].transpose(0, 2, 1))).to(device)
    with torch.no_grad():
        out = model.infer(batch, speedup=speedup, init_noise=x_t)
    return (out["mel_out"].float() * np.log(10.0)).transpose(1, 2) \
        .cpu().numpy()


def onnx_mel(run, feats, sampler: str, k_step: int, meta=None, den=None,
             pred=None):
    """The exported chain on the numpy runtime (``onnx.chain``'s loops):
    the ln-mel [1, M, T] and the encoder's condition."""
    import numpy as np

    from diffsvc_tpu_torch.onnx import chain

    cond, _ = run["encoder"](feats["hubert"], feats["mel2ph"],
                             np.zeros((1,), np.int64), feats["f0"])
    den = den or run["denoise"]
    if sampler == "dpmpp":
        x = chain.dpmpp_chain(den, run["dpmpp"], meta, feats["noise"], cond)
    else:
        x = chain.plms_chain(den, pred or run["pred"], feats["noise"], cond,
                             k_step, ONNX_ACC)
    return run["after"](x)[0], cond


def zero_eps(x, t, cond):
    """A denoise stand-in that predicts eps = 0 (the chain's baseline)."""
    import numpy as np

    return [np.zeros_like(x)]


def rewired(run, inputs: dict, zeroed_inputs=()):
    """``run`` (a runner of its own, a second parse of a graph) with its
    nodes reading graph input ``inputs[x]`` where they read ``x``, and each
    input of ``zeroed_inputs`` times zero: a planted fault."""
    import numpy as np

    from diffsvc_tpu_torch.onnx import wire

    names = dict(inputs)
    for x in zeroed_inputs:
        run.initializers[f"{x}_zero"] = np.zeros((), np.float32)
        names[x] = f"{x}_zeroed"
    for node in run.graph.node:
        for i, x in enumerate(node.input):
            if x in names:
                node.input[i] = names[x]
    for x in zeroed_inputs:
        mul = wire.NodeProto()
        mul.op_type = "Mul"
        mul.input.extend([x, f"{x}_zero"])
        mul.output.append(f"{x}_zeroed")
        run.graph.node.insert(0, mul)
    return run


def phase_onnx(device, workdir, project):
    """Phase 13: the port's ONNX artifacts of phase 4's project on the
    numpy runtime against K1, K2 and K3 on the card, with planted faults."""
    import numpy as np
    import torch
    import yaml

    from diffsvc_tpu_torch.onnx import svc_export
    from diffsvc_tpu_torch.onnx.runtime import OnnxRunner
    from diffsvc_tpu_torch.vocoders import generator

    t_phase = time.time()
    svc = project["svcs"][""]
    hp, model, gen = svc.hp, svc.model, svc.vocoder.gen
    out = os.path.join(workdir, "onnx")
    res = {"export_s": {}, "bytes": {}, "readings": {}, "faults": {},
           "launches": {}}
    with open(os.path.join(ROOT, "configs", "config_44k_fast.yaml")) as f:
        fast = {k: v for k, v in yaml.safe_load(f).items() if k in FAST_KEYS}
    traces = {}
    t0 = time.time()
    paths = svc_export.export_svc_onnx(hp, model, out, "proj",
                                       t_ph=ONNX_TRACE, t_mel=ONNX_TRACE,
                                       traces=traces)
    res["export_s"]["svc"] = time.time() - t0
    t0 = time.time()
    paths.update(svc_export.export_dpmpp_onnx(
        dict(hp, **fast), out, "proj", speedup=int(fast["pndm_speedup"]),
        t_mel=ONNX_TRACE))
    res["export_s"]["dpmpp"] = time.time() - t0
    t0 = time.time()
    paths["hifigan"] = svc_export.export_vocoder_onnx(gen, out, "proj",
                                                      t_mel=ONNX_TRACE)
    res["export_s"]["hifigan"] = time.time() - t0
    with open(paths["dpmpp_meta"]) as f:
        meta = json.load(f)

    # the planted faults' graphs, never the kept ones: the denoise trace
    # converted again with one layer's conditioner projection zeroed (a
    # copy of the weights), and second parses of the pred and hifigan
    # graphs rewired
    t0 = time.time()
    n_layers = len(model.denoise_fn.residual_layers)
    cp = model.denoise_fn.residual_layers[n_layers // 2] \
        .conditioner_projection
    name = f"net.residual_layers.{n_layers // 2}.conditioner_projection"
    with open(os.path.join(out, "fault_denoise.onnx"), "wb") as f:
        f.write(traces["denoise"].onnx(
            ["noise_pred"], graph_name="denoise",
            state={f"{name}.weight": torch.zeros_like(cp.weight, device="cpu"),
                   f"{name}.bias": torch.zeros_like(cp.bias, device="cpu")}))
    res["export_s"]["fault_denoise"] = time.time() - t0
    for k, v in paths.items():
        res["bytes"][k] = os.path.getsize(v)
        log(f"[onnx] {k}: {res['bytes'][k]} bytes")
    log(f"[onnx] export seconds: encoder, denoise, pred and after in one "
        f"export_svc_onnx call {res['export_s']['svc']:.2f}s, dpmpp "
        f"{res['export_s']['dpmpp']:.2f}s, hifigan "
        f"{res['export_s']['hifigan']:.2f}s")
    log(f"[onnx] the planted fault's denoise graph converted again from "
        f"the trace in {res['export_s']['fault_denoise']:.2f}s")

    t0 = time.time()

    def load(path):
        with open(path, "rb") as f:
            return OnnxRunner(f.read())

    run = {k: load(v) for k, v in paths.items() if v.endswith(".onnx")}
    fault_run = {"pred_swapped": rewired(load(paths["pred"]), {
                     "time": "time_prev", "time_prev": "time"}),
                 "cond_zeroed": load(os.path.join(out, "fault_denoise.onnx")),
                 "noise_ignored": rewired(load(paths["hifigan"]), {},
                                          zeroed_inputs=("noise",))}
    res["load_s"] = time.time() - t0
    feats = onnx_features()
    k_step = int(hp.get("K_step", 1000))
    h1 = gen.cfg.harmonic_num + 1
    up = int(np.prod(gen.cfg.upsample_rates))
    readings, fault_rd = res["readings"], res["faults"]

    def rel(a, b):
        return rel_l2(torch.from_numpy(np.asarray(a)),
                      torch.from_numpy(np.asarray(b)))

    with counted("phase 13", res["launches"],
                 moved=("residual_stack", "plms_ladder", "vocoder_tail"),
                 tag="onnx"):
        # (b) the chains, PLMS at acc=100 and DPM-Solver++ at the fast
        # profile, minus their eps = 0 runs; the numpy chains' time and
        # denoise evaluations apart from the card's ladders
        chains, evals = {}, [0]
        t_np = t_card = 0.0

        def den(*args):
            evals[0] += 1
            return run["denoise"](*args)

        for sampler, items, speedup in (("plms", {"sampler": "plms",
                                                  "sampler_clip_x0": 0.0},
                                         ONNX_ACC),
                                        ("dpmpp", fast,
                                         int(fast["pndm_speedup"]))):
            t0 = time.time()
            with hp_items(hp, dict(items, diff_compute_dtype="")):
                card = card_mel(model, feats, device, speedup)
                with zeroed(*denoiser_head(svc)):
                    card0 = card_mel(model, feats, device, speedup)
            t_card += time.time() - t0
            t0 = time.time()
            mel, cond = onnx_mel(run, feats, sampler, k_step, meta, den=den)
            mel0, _ = onnx_mel(run, feats, sampler, k_step, meta,
                               den=zero_eps)
            t_np += time.time() - t0
            chains[sampler] = (card - card0, mel0)
            readings[f"chain_{sampler}"] = rel(mel - mel0, card - card0)
            readings[f"chain_{sampler}_whole"] = rel(mel, card)
        readings.update(chain_numpy_s=t_np, chain_card_s=t_card,
                        chain_evals=evals[0])
        mel_fault, _ = onnx_mel(run, feats, "plms", k_step,
                                pred=fault_run["pred_swapped"])
        fault_rd["pred_swapped"] = rel(mel_fault - chains["plms"][1],
                                       chains["plms"][0])

        # (a) one denoiser evaluation on the encoder's condition
        t0 = time.time()
        tt = np.asarray([ONNX_STEP], np.int64)
        with torch.no_grad():
            want = diffnet_apply_card(model, feats["noise"], tt, cond,
                                      device)
        got = run["denoise"](feats["noise"], tt, cond)[0]
        readings["denoise"] = rel(got, want)
        fault_rd["cond_zeroed"] = rel(
            fault_run["cond_zeroed"](feats["noise"], tt, cond)[0], want)
        readings["denoise_s"] = time.time() - t0

        # (c) the vocoder on the PLMS chain's mel, with unvoiced frames
        t0 = time.time()
        rng = np.random.RandomState(1)
        voc_mel = np.ascontiguousarray(mel[:, :, :ONNX_VOC_T])
        f0 = (200.0 * 2 ** (0.3 * np.sin(np.arange(ONNX_VOC_T) / 9.0)))[
            None].astype(np.float32)
        f0[0, 5:9] = 0.0
        ri = rng.rand(1, h1).astype(np.float32)
        nz = rng.randn(1, h1, ONNX_VOC_T * up).astype(np.float32)
        with torch.no_grad():
            wav = generator.apply_serving(
                gen, torch.from_numpy(voc_mel.transpose(0, 2, 1).copy())
                .to(device), torch.from_numpy(f0).to(device),
                (torch.from_numpy(ri).to(device),
                 torch.from_numpy(nz).to(device))).cpu().numpy()
        readings["hifigan"] = rel(run["hifigan"](voc_mel, f0, ri, nz)[0], wav)
        fault_rd["noise_ignored"] = rel(
            fault_run["noise_ignored"](voc_mel, f0, ri, nz)[0], wav)
        readings["hifigan_s"] = time.time() - t0

    limits = {"denoise": ONNX_TOL["denoise"], "chain_plms": ONNX_TOL["chain"],
              "chain_dpmpp": ONNX_TOL["chain"],
              "hifigan": ONNX_TOL["hifigan"]}
    fault_of = {"cond_zeroed": "denoise", "pred_swapped": "chain_plms",
                "noise_ignored": "hifigan"}
    for k, lim in limits.items():
        log(f"[onnx] ({'a' if k == 'denoise' else 'c' if k == 'hifigan' else 'b'}"
            f") {k}: rel_l2 {readings[k]:.3e} (tol {lim:g})"
            + (f"; whole ln-mel {readings[k + '_whole']:.3e}"
               if k.startswith("chain") else ""))
    for k, base in fault_of.items():
        log(f"[onnx] (d) planted fault {k}: rel_l2 {fault_rd[k]:.3e} (must "
            f"exceed {limits[base]:g})")
    log(f"[onnx] numpy runtime: load {res['load_s']:.2f}s, chains "
        f"{readings['chain_numpy_s']:.2f}s for "
        f"{readings['chain_evals']} denoise evaluations (the card's four "
        f"K2 ladders {readings['chain_card_s']:.2f}s), (a) "
        f"{readings['denoise_s']:.2f}s, hifigan "
        f"{readings['hifigan_s']:.2f}s")
    res["seconds"] = time.time() - t_phase
    log(f"[onnx] phase 13 took {res['seconds']:.1f}s")
    failed = [k for k, lim in limits.items() if not readings[k] <= lim]
    failed += [k for k, base in fault_of.items()
               if not fault_rd[k] > limits[base]]
    if failed:
        raise SmokeError(f"phase 13 gates failed: {failed} "
                         f"({readings}, faults {fault_rd})")
    return res


PT2_T_MEL, PT2_T_PH = 1024, 512   # the JAX CLI's defaults (--t_mel, --t_ph)
PT2_FAULT_SPEEDUP = 50    # the planted fault's sampler: 21 evaluations, not 51
# each program against its in-process route on the same weights, inputs and
# draws: equal bits expected (the same kernels on the same packs); where
# they differ, the kernel's own limit against its plain version
PT2_TOL = {("denoiser", "bf16"): TOL[("residual_stack", "bf16")],
           ("denoiser", "f32"): TOL[("residual_stack", "f32")],
           ("sampler", "bf16"): TOL[("plms_ladder", "bf16")],
           ("sampler", "f32"): TOL[("plms_ladder", "f32")],
           ("vocoder", "bf16"): TOL[("vocoder_tail", "f32")],
           ("fused", "bf16"): TOL[("plms_ladder", "bf16")],
           # no kernel: the same ATen ops on the same weights
           ("encoder", "bf16"): 1e-6}
# phase 14's child: the bf16 programs reloaded in a process that imports the
# op library alone, run on the parent's inputs with PyTorch's default cuDNN
# flags (allow_tf32 on: the loaded programs must still convolve in true f32)
PT2_CHILD = r"""
import json, os, sys
import numpy as np
import torch
import diffsvc_tpu_torch.ops.hopper as hopper
from diffsvc_tpu_torch.ops.hopper import diffnet_stack, plms_ladder, vocoder_tail
d = sys.argv[1]
ins = np.load(os.path.join(d, "inputs.npz"))
dev = torch.device("cuda")
def t(k):
    return torch.from_numpy(ins[k]).to(dev)
outs = {}
with torch.no_grad():
    outs["denoiser"] = hopper.load_program(os.path.join(d, "denoiser.pt2"))(
        t("x"), t("t"), t("cond"))
    outs["sampler"] = hopper.load_program(os.path.join(d, "sampler.pt2"))(
        t("cond"), t("noise"))
    outs["vocoder"] = hopper.load_program(os.path.join(d, "vocoder.pt2"))(
        t("mel"), t("f0"))
np.savez(os.path.join(d, "child_outs.npz"),
         **{k: v.float().cpu().numpy() for k, v in outs.items()})
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "diffsvc_tpu")
             or m.startswith(("diffsvc_tpu_torch.models",
                              "diffsvc_tpu_torch.infer",
                              "diffsvc_tpu_torch.vocoders")))
print(json.dumps({"bad": bad, "launches": [diffnet_stack.launches,
                                           plms_ladder.launches,
                                           vocoder_tail.launches],
                  "cudnn_tf32": torch.backends.cudnn.allow_tf32}))
"""


def pt2_features(hp, device, seed: int = 0) -> dict:
    """Seeded inputs of the chain at PT2_T_MEL / PT2_T_PH (the features'
    layouts of ``run_exported``), on ``device``."""
    import numpy as np
    import torch

    rng = np.random.RandomState(seed)
    mel2ph = np.clip(np.arange(PT2_T_MEL) * PT2_T_PH // PT2_T_MEL + 1, 1,
                     PT2_T_PH)
    mel2ph[-24:] = 0
    f0 = np.log2(200.0 * 2 ** (0.3 * np.sin(np.arange(PT2_T_MEL) / 40.0)))
    m, h = int(hp["audio_num_mel_bins"]), int(hp["hidden_size"])
    arrs = dict(hubert=(rng.randn(1, PT2_T_PH, h) * 0.3).astype(np.float32),
                mel2ph=mel2ph[None].astype(np.int64),
                f0=f0[None].astype(np.float32),
                uv=np.zeros((1, PT2_T_MEL), np.float32),
                energy=np.zeros((1, PT2_T_MEL), np.float32),
                noise=rng.randn(1, PT2_T_MEL, m).astype(np.float32),
                x=rng.randn(1, PT2_T_MEL, m).astype(np.float32),
                t=np.asarray([500], np.int64))
    return {k: torch.from_numpy(v).to(device) for k, v in arrs.items()}


def pt2_limit(key: str) -> float:
    """PT2_TOL of a reading's key ("sampler f32", "fused[1] bf16")."""
    return PT2_TOL[(key.split("[")[0].split()[0], key.split()[-1])]


def phase_pt2(device, workdir, project):
    """Phase 14: the compiled programs of ``infer/export.py`` exported on
    the card from phase 4's project at full width, saved, reloaded (the
    bf16 set also in a process that imports the op library alone) and run
    against the in-process routes, with planted faults."""
    import numpy as np
    import torch

    from diffsvc_tpu_torch.infer import export as texport
    from diffsvc_tpu_torch.infer.fused import FusedSvc
    from diffsvc_tpu_torch.models import diffnet
    from diffsvc_tpu_torch.ops import mel as mel_ops
    from diffsvc_tpu_torch.ops.hopper import vocoder_tail
    from diffsvc_tpu_torch.utils.audio_io import load_wav
    from diffsvc_tpu_torch.vocoders import generator

    t_phase = time.time()
    card = card_line()
    out = os.path.join(workdir, "pt2")
    res = {"card": card, "export_s": {}, "bytes": {}, "readings": {},
           "equal": {}, "faults": {}, "ms": {}, "ops": {}, "launches": {}}
    programs, routes, args = {}, {}, {}

    def export(key, write):
        """``write()`` exports a program and returns its path: timed, then
        the file's bytes, its reload (timed) and its graph's ops."""
        t0 = time.time()
        path = write()
        res["export_s"][key] = time.time() - t0
        res["bytes"][key] = os.path.getsize(path)
        t0 = time.time()
        programs[key] = texport.load_exported(path)
        res["export_s"][key + " load"] = time.time() - t0
        res["ops"][key] = texport.program_ops(path)

    def save(fn, fn_args, path):
        torch.export.save(texport.export_program(fn, fn_args), path)
        return path

    # (1) the stages in bf16 (the config's serving dtype; with the vocoder)
    # and the denoiser and sampler in f32, t_mel 1024, t_ph 512, acc 20
    exporters, feats = {}, {}
    for label, dt in (("bf16", "bfloat16"), ("f32", "")):
        svc = project["svcs"][dt]
        exp = exporters[label] = texport.SvcExporter(
            svc.hp, svc.model, svc.vocoder if label == "bf16" else None,
            device=device)
        d = os.path.join(out, label)
        os.makedirs(d, exist_ok=True)
        stages = exp.stages(PT2_T_MEL, PT2_T_PH, speedup=ACC)
        if label == "f32":
            stages.pop("encoder")
        for name, (fn, fn_args) in stages.items():
            export(f"{name} {label}", lambda: save(
                fn, fn_args, os.path.join(d, f"{name}.pt2")))
        f = feats[label] = pt2_features(svc.hp, device)
        model = svc.model
        with torch.no_grad():
            enc = model.fs2(f["hubert"], f["mel2ph"], f["f0"], f["uv"],
                            f["energy"])
        f["cond"] = enc["decoder_inp"]
        batch = {k: f[k] for k in ("hubert", "mel2ph", "f0", "uv", "energy")}
        dtc = torch.bfloat16 if label == "bf16" else torch.float32
        net = model.denoise_fn
        args[f"denoiser {label}"] = (f["x"], f["t"], f["cond"])
        routes[f"denoiser {label}"] = (
            lambda net=net, dtc=dtc, f=f: diffnet.apply(
                net, f["x"].to(dtc), f["t"], f["cond"]).float())
        args[f"sampler {label}"] = (f["cond"], f["noise"])
        routes[f"sampler {label}"] = (
            lambda model=model, batch=batch, f=f: model.infer(
                batch, speedup=ACC, init_noise=f["noise"])["mel_out"])
        if label == "bf16":
            args["encoder bf16"] = tuple(batch.values())
            routes["encoder bf16"] = (
                lambda model=model, batch=batch: tuple(model.fs2(
                    *batch.values())[k] for k in ("decoder_inp",
                                                  "f0_denorm")))
            gen = svc.vocoder.gen
            randoms = tuple(r.to(device) for r in generator.draw_randoms(
                1, PT2_T_MEL * int(np.prod(gen.cfg.upsample_rates)),
                gen.cfg.harmonic_num, torch.Generator().manual_seed(0)))
            with torch.no_grad():
                mel = model.infer(batch, speedup=ACC, init_noise=f["noise"])
            f["mel"] = (mel["mel_out"] * mel_ops.LN_10).contiguous()
            f["f0_hz"] = mel["f0_denorm"].contiguous()
            args["vocoder bf16"] = (f["mel"], f["f0_hz"])
            routes["vocoder bf16"] = (
                lambda gen=gen, f=f, randoms=randoms:
                generator.apply_serving(gen, f["mel"], f["f0_hz"], randoms))
            n_tail = len(vocoder_tail.flatten_plan(gen.tail_plan(
                generator.tail_start_stage(gen.cfg)))[0])

    # (2) the fused program at one bucket of the 6.5 s clip (bf16), beside
    # FusedSvc run eagerly on the card
    svc = project["svcs"]["bfloat16"]
    fs = FusedSvc(svc.hp, svc.model, svc.vocoder,
                  svc.fused_model(ACC).hubert, speedup=ACC, cuda_graphs=False)
    wav, _ = load_wav(project["wavs"][0], sr=int(svc.hp["audio_sample_rate"]))
    n44 = fs._padded_length(len(wav))
    wav44 = np.zeros((n44,), np.float32)
    wav44[: len(wav)] = wav
    gen_d = torch.Generator().manual_seed(3)
    dist = {"normal": torch.randn, "uniform": torch.rand}
    draws = [dist[d](shape, generator=gen_d).to(device)
             for _, shape, d in texport.fused_draws(fs, n44)]
    export("fused bf16", lambda: texport.export_fused(
        fs, os.path.join(out, "fused"), n44))
    wav_t = torch.from_numpy(wav44).to(device)
    args["fused bf16"] = (wav_t, torch.tensor(0.0, device=device),
                          torch.tensor(0, device=device), *draws)
    routes["fused bf16"] = (
        lambda: tuple(o[0] for o in fs.run(wav44[None], [0.0],
                                           init_noise=draws[0],
                                           voc_randoms=tuple(draws[1:]))))
    res["fused"] = {"n44": n44,
                    "secs": len(wav) / float(svc.hp["audio_sample_rate"])}

    # (3) every program once, counters reset before and read after: K1 once
    # per denoiser call and once per evaluation of a ladder, K2 once per
    # sampler or fused call, K3 once per vocoder or fused call
    model = project["svcs"][""].model
    n_evals = len(model.ladder_tables(model.K_step, ACC, "plms", False,
                                      device)["t_eval"])
    got = {}
    with counted("phase 14", res["launches"],
                 moved=("residual_stack", "plms_ladder", "vocoder_tail"),
                 tag="pt2"):
        with torch.no_grad():
            for key, prog in programs.items():
                got[key] = prog(*args[key])
    want_counts = {"residual_stack": 2 + 3 * n_evals, "plms_ladder": 3,
                   "vocoder_tail": 2, "residual_stack_train_batched": 0,
                   "residual_stack_train": 0, "fused_residual_block": 0}
    mask = (feats["bf16"]["mel2ph"] > 0).float()[:, :, None]
    with torch.no_grad():
        for key, route in routes.items():
            name, label = key.split()
            ref, out_k = route(), got[key]
            if name == "sampler":     # the chain's mask, as infer's
                out_k = out_k * mask
            pairs = ({f"{name}[{i}] {label}": ab for i, ab in
                      enumerate(zip(out_k, ref))}
                     if name in ("encoder", "fused") else {key: (out_k, ref)})
            for k, (a, b) in pairs.items():
                res["equal"][k] = bool(torch.equal(a, b))
                res["readings"][k] = rel_l2(a.float(), b.float())

    # (4) the planted faults: a denoiser exported with one layer's
    # conditioner projection zeroed, a sampler exported at another speedup
    # (f32), the fused program fed draws shifted by one frame
    svc32 = project["svcs"][""]
    net32 = svc32.model.denoise_fn
    cp = net32.residual_layers[L // 2].conditioner_projection
    t0 = time.time()
    with zeroed(cp.weight, cp.bias):
        fn, fn_args = exporters["f32"].stages(PT2_T_MEL, PT2_T_PH,
                                              speedup=ACC)["denoiser"]
        fault_den = texport.export_program(fn, fn_args).module()
    fn, fn_args = exporters["f32"].stages(
        PT2_T_MEL, PT2_T_PH, speedup=PT2_FAULT_SPEEDUP)["sampler"]
    fault_samp = texport.export_program(fn, fn_args).module()
    res["export_s"]["faults"] = time.time() - t0
    hop_up = int(np.prod(svc.vocoder.gen.cfg.upsample_rates))
    shifted = (torch.roll(draws[0], 1, dims=1), draws[1],
               torch.roll(draws[2], hop_up, dims=2))
    with torch.no_grad():
        faults = {
            "denoiser f32": fault_den(*args["denoiser f32"]),
            "sampler f32": fault_samp(*args["sampler f32"]) * mask,
            "fused[0] bf16": programs["fused bf16"](*args["fused bf16"][:3],
                                                    *shifted)[0]}
        for key, fault in faults.items():
            ref = routes[key.replace("[0]", "")]()
            ref = ref[0] if key.startswith("fused") else ref
            res["faults"][key] = rel_l2(fault.float(), ref.float())

    # (5) the bf16 set reloaded in a process that imports the op library
    # alone
    d = os.path.join(out, "bf16")
    f = feats["bf16"]
    np.savez(os.path.join(d, "inputs.npz"), x=f["x"].cpu().numpy(),
             t=f["t"].cpu().numpy(), cond=f["cond"].cpu().numpy(),
             noise=f["noise"].cpu().numpy(), mel=f["mel"].cpu().numpy(),
             f0=f["f0_hz"].cpu().numpy())
    t0 = time.time()
    proc = subprocess.run([sys.executable, "-c", PT2_CHILD, d], cwd=ROOT,
                          env=dict(os.environ, PYTHONPATH=ROOT),
                          capture_output=True, text=True, timeout=600)
    res["child_s"] = time.time() - t0
    if proc.returncode != 0:
        raise SmokeError(f"phase 14's child failed:\n{proc.stderr[-3000:]}")
    child = json.loads(proc.stdout.strip().splitlines()[-1])
    child_outs = np.load(os.path.join(d, "child_outs.npz"))
    res["child"] = {"bad_modules": child["bad"],
                    "cudnn_tf32_default": child["cudnn_tf32"],
                    "launches": dict(zip(("residual_stack", "plms_ladder",
                                          "vocoder_tail"),
                                         child["launches"])),
                    "equal": {k: bool(np.array_equal(
                        child_outs[k], got[f"{k} bf16"].float().cpu().numpy()))
                        for k in ("denoiser", "sampler", "vocoder")}}

    # (6) run time of each program beside its in-process route (CUDA
    # events over the calls, in turns)
    reps = {"encoder": 20, "denoiser": 10, "sampler": 2, "vocoder": 5,
            "fused": 2}
    with torch.no_grad():
        for key, prog in programs.items():
            ms = time_in_turns(lambda: prog(*args[key]), routes[key],
                               reps[key.split()[0]])
            res["ms"][key] = {"program": ms[0], "route": ms[1]}

    for key in programs:
        log(f"[pt2] {key}: exported in {res['export_s'][key]:.2f}s, "
            f"{res['bytes'][key]} bytes, loaded in "
            f"{res['export_s'][key + ' load']:.2f}s; ops "
            f"{res['ops'][key]['ops']}, products {res['ops'][key]['products']}"
            f", shared {res['ops'][key]['shared']}; program "
            f"{res['ms'][key]['program']:.3f} ms, in-process route "
            f"{res['ms'][key]['route']:.3f} ms ({card})")
    for key in sorted(res["readings"]):
        log(f"[pt2] {key} against its in-process route: equal bits "
            f"{res['equal'][key]}, rel_l2 {res['readings'][key]:.3e} (tol "
            f"{pt2_limit(key):g})")
    for key, v in res["faults"].items():
        log(f"[pt2] planted fault {key}: rel_l2 {v:.3e} (must exceed "
            f"{pt2_limit(key):g})")
    log(f"[pt2] the faults' programs exported in "
        f"{res['export_s']['faults']:.2f}s; child process "
        f"{res['child_s']:.2f}s (cudnn.allow_tf32 "
        f"{res['child']['cudnn_tf32_default']}): modules "
        f"{res['child']['bad_modules']}, "
        f"launches {res['child']['launches']}, equal {res['child']['equal']}")
    log(f"[pt2] fused bucket {n44} samples ({res['fused']['secs']:.2f} s "
        f"clip); K1 {n_evals} evaluations a ladder")
    res["seconds"] = time.time() - t_phase
    log(f"[pt2] phase 14 took {res['seconds']:.1f}s ({card})")

    failed = []
    counts = res["launches"]["phase 14"]
    if counts != want_counts:
        failed.append(f"counters {counts} != {want_counts}")
    want_ops = {"encoder": {}, "denoiser": {"residual_stack": 1},
                "sampler": {"plms_ladder": 1}, "vocoder": {"vocoder_tail": 1},
                "fused": {"plms_ladder": 1, "vocoder_tail": 1}}
    for key, rep in res["ops"].items():
        name = key.split()[0]
        if rep["ops"] != want_ops[name] or rep["shared"]:
            failed.append(f"{key} graph {rep}")
    # no plain route baked in: one plain stack adds 4 L products, one plain
    # ladder evaluation 3 + 4 L, the plain tail its n_tail convolutions
    limits = {"denoiser": 4 * L, "sampler": 3 + 4 * L, "vocoder": n_tail}
    for key, rep in res["ops"].items():
        name = key.split()[0]
        if name in limits and rep["products"] >= limits[name]:
            failed.append(f"{key}: {rep['products']} products")
    for key, v in res["readings"].items():
        if not (res["equal"][key] or v <= pt2_limit(key)):
            failed.append(f"{key} rel_l2 {v:.3e}")
    for key, v in res["faults"].items():
        if not v > pt2_limit(key):
            failed.append(f"fault {key} rel_l2 {v:.3e}")
    if res["child"]["bad_modules"] or not all(res["child"]["equal"].values()):
        failed.append(f"child {res['child']}")
    child_l = res["child"]["launches"]
    if child_l != {"residual_stack": 1 + n_evals, "plms_ladder": 1,
                   "vocoder_tail": 1}:
        failed.append(f"child launches {child_l}")
    if failed:
        raise SmokeError(f"phase 14 gates failed: {failed}")
    return res


# ---------------------------------------------------------------------------
# Phase 15: the learned-score evidence (tools/train_demo, tools/sampler_quality)

LEARN_STEPS, LEARN_RESUME = 100, 50      # the demo's fit and its resume
# the clipped DPM-Solver++ rows' range (ordering 3 of
# tests/test_sampler_quality_artifacts.py)
LEARN_RANGE = (-8.0, 3.0)
# dpmpp100_clip through K2 against its plain version on the same weights
# and x_T: relative L2 of the denoiser's part of the mel (the row minus the
# same ladder run with eps = 0), at phase 4's conversion limits
LEARN_TOL = {"f32": SLICE_TOL, "bf16": SLICE_TOL_BF16}
LEARN_ROW = ("dpmpp", 100, "lambda", 1.0)
LEARN_STEP_REPS = 10     # timed steps of the demo's batch


def resume_failures(from_step: int, to_step: int, k4: int) -> list:
    """The fresh Trainer restored the fit's last step and trained the rest
    (one K4 backward a step)."""
    want = (LEARN_STEPS, LEARN_STEPS + LEARN_RESUME, LEARN_RESUME)
    got = (from_step, to_step, k4)
    return [] if got == want else [f"resume (from, to, K4) {got}, want "
                                   f"{want}"]


def loss_failures(first: float, last: float) -> list:
    return [] if last < first else [f"validation loss {first:.4f} -> "
                                    f"{last:.4f} did not fall"]


def row_failures(mels: dict, shape) -> list:
    import numpy as np

    return [f"row {n}: shape {m.shape}, finite {bool(np.isfinite(m).all())}"
            for n, m in mels.items()
            if m.shape != tuple(shape) or not np.isfinite(m).all()]


def range_failures(mels: dict) -> list:
    lo, hi = LEARN_RANGE
    return [f"{n} range [{m.min():.2f}, {m.max():.2f}] outside [{lo}, {hi}]"
            for n, m in mels.items()
            if n.startswith("dpmpp") and n.endswith("_clip")
            and not lo <= m.min() <= m.max() <= hi]


def count_failures(label: str, got: dict, want: dict) -> list:
    got = {k: got[k] for k in want}
    return [] if got == want else [f"{label} launches {got}, want {want}"]


def ladder_swapped(fn):
    """GaussianDiffusion's K2 call replaced by ``fn`` (same arguments)."""
    from diffsvc_tpu_torch.models import diffusion as tdiff

    return swapped(tdiff._pl, plms_ladder=fn)


def ladder_variant(plain: bool, zero_out: bool = False, push: bool = True):
    """K2 (or its plain version) with the output projection zeroed (eps =
    0) or its history never pushed (the planted fault: DPM-Solver++(2M)
    without its multistep term)."""
    import torch

    from diffsvc_tpu_torch.ops.hopper import plms_ladder as k2

    run = k2.plms_ladder

    def fn(x, scal, sb, cp, win, bin_, wskip, bskip, wout, bout, *rest,
           **kw):
        if zero_out:
            wout, bout = torch.zeros_like(wout), torch.zeros_like(bout)
        if not push:
            scal = scal.clone()
            scal[:, k2.NS - 1] = 0.0
        f = k2.plms_ladder_plain if plain else run
        return f(x, scal, sb, cp, win, bin_, wskip, bskip, wout, bout, *rest,
                 **kw)
    return fn


def denoiser_part_rel(model, hp, jb, x_T, kern_fn) -> float:
    """rel-L2 of the denoiser's part of ``LEARN_ROW``'s mel: ``kern_fn``'s
    run against the plain version's, both minus the plain eps = 0 run."""
    import torch

    from diffsvc_tpu_torch.tools import sampler_quality as sq

    def row(fn):
        with ladder_swapped(fn):
            return torch.from_numpy(sq.sample(model, hp, jb, x_T,
                                              *LEARN_ROW))

    zero = row(ladder_variant(True, zero_out=True))
    return rel_l2(row(kern_fn) - zero, row(ladder_variant(True)) - zero)


def phase_learn(device, workdir):
    """Phase 15 (``[learn]`` lines): ``tools/train_demo`` at production
    width and reduced depth, then ``tools/sampler_quality``'s grid over its
    checkpoint at f32 and at bf16, each gate with a planted fault that must
    fail it."""
    import numpy as np

    from diffsvc_tpu_torch.data.dataset import (BatchIterator,
                                                FastSpeechDataset,
                                                build_batches)
    from diffsvc_tpu_torch.tools import sampler_quality as sq
    from diffsvc_tpu_torch.tools import train_demo as td
    from diffsvc_tpu_torch.training.trainer import Trainer

    t0 = time.time()
    res = {"launches": {}, "seconds": {}, "faults": {}}
    failed, faults_missed = [], []
    scratch = os.path.join(workdir, "learn")
    os.makedirs(scratch)
    args = td.parse_args(["--steps", str(LEARN_STEPS), "--resume-steps",
                          str(LEARN_RESUME), "--val-interval", "50",
                          "--out", os.path.join(scratch, "out")])
    with counted("train_demo", res["launches"],
                 moved=("plms_ladder", "vocoder_tail",
                        "residual_stack_train_batched"),
                 still=("residual_stack_train",), tag="learn"):
        demo = td.run(args, scratch)
    hp = demo.pop("hp")
    res["demo"] = demo
    res["seconds"]["demo"] = time.time() - t0
    first, last = td.loss_ends(demo)
    log(f"[learn] train_demo {LEARN_STEPS} + {LEARN_RESUME} steps "
        f"({demo['batch']}, route {demo['train_route']}): fit "
        f"{demo['phase1']['wall_s']}s, resume {demo['resume']['wall_s']}s "
        f"({demo['resume']['steps_per_s']} steps/s); validation loss "
        f"{[round(v, 4) for _, v in demo['val_loss_curve']]}; launches fit "
        f"{demo['phase1']['launches']}, resume {demo['resume']['launches']};"
        f" validation wav {demo['validation_wav']}")
    failed += resume_failures(demo["resume"]["from_step"],
                              demo["resume"]["to_step"],
                              demo["resume"]["launches"]["K4"])
    failed += loss_failures(first, last)
    failed += count_failures("fit", demo["phase1"]["launches"],
                             {"K4": LEARN_STEPS, "K5": 0})
    failed += count_failures("resume", demo["resume"]["launches"],
                             {"K4": LEARN_RESUME, "K5": 0})

    # faults of the resume and loss gates: a Trainer that finds no
    # checkpoint starts at step 0 with the initial weights
    fresh = Trainer(dict(hp, work_dir=os.path.join(scratch, "no_ckpt")),
                    log_writer=False, device=device)
    fresh.restore()
    res["faults"]["resume"] = resume_failures(
        fresh.global_step, demo["resume"]["to_step"],
        demo["resume"]["launches"]["K4"])
    res["faults"]["loss"] = loss_failures(first, fresh.validate(
        FastSpeechDataset("valid", hp, shuffle=False)))
    # where a demo step's time goes: the fit's batch of 8 on the fresh task
    ds = FastSpeechDataset("train", hp, shuffle=False)
    full = [b for b in build_batches(ds, hp, rng=np.random.RandomState(0))
            if len(b) == int(hp["max_sentences"])][0]
    batch = next(iter(BatchIterator(ds, [full], pad_multiple=int(
        hp.get("frames_multiple", 128)))))
    res["step"] = time_steps(fresh.task, batch, LEARN_STEP_REPS)
    log_steps("learn", f"demo step ({demo['train_route']} route)", batch,
              res["step"])
    res["step"]["profile"] = profile_run(
        "phase 15's demo step", lambda: fresh.task.train_step(batch))
    res["step"]["profile"].pop("names")
    del fresh

    t1 = time.time()
    grids = res["grids"] = {}
    for dt in ("f32", "bf16"):
        ghp = dict(hp, diff_compute_dtype=sq.DTYPES[dt])
        model, step = sq.restore_model(ghp, device)
        jb, mask, gt = sq.held_out(ghp, device)
        b, t_mel = jb["mel2ph"].shape
        x_T = sq.shared_x_T(b, t_mel, int(hp["audio_num_mel_bins"]))
        with counted(f"grid {dt}", res["launches"], moved=("plms_ladder",),
                     still=("vocoder_tail", "residual_stack_train_batched",
                            "residual_stack_train"), tag="learn"):
            grid = sq.run_grid(model, ghp, jb, x_T, mask, gt)
        mels = grid.pop("mels")
        grids[dt] = dict(grid, step=step)
        log(f"[learn] grid {dt} (step {step}, B={b}, T={t_mel}): cross-"
            f"reference L1 {grid['cross_reference_l1']}, K2 "
            f"{grid['k2_launches']}, ladder s {grid['row_wall_s']}")
        for name, r in grid["samplers"].items():
            log(f"[learn] {dt} {name}: NFE {r['nfe']} solver L1 "
                f"{r['solver_err_l1']} gt L1 {r['gt_err_l1']} range "
                f"{r['mel_range']}")
        failed += row_failures(mels, (b, t_mel, int(hp["audio_num_mel_bins"])))
        failed += range_failures(mels)
        failed += count_failures(f"grid {dt}", {"K2": grid["k2_launches"]},
                                 {"K2": len(sq.ROWS) + 2})
        rel = denoiser_part_rel(model, ghp, jb, x_T, ladder_variant(False))
        with counted(f"plain {dt}", res["faults"], moved=(), tag="learn"):
            with ladder_swapped(ladder_variant(True)):
                plain_row = sq.sample(model, ghp, jb, x_T, *LEARN_ROW)
        fault_rel = denoiser_part_rel(model, ghp, jb, x_T,
                                      ladder_variant(False, push=False))
        nan_x = x_T.clone()
        nan_x[0, 0, 0] = float("nan")
        nan_row = sq.sample(model, ghp, jb, nan_x, "dpmpp", 100)
        grids[dt]["k2_vs_plain"] = {"rel_l2": rel, "tol": LEARN_TOL[dt],
                                    "fault_history_not_pushed": fault_rel}
        log(f"[learn] {dt} dpmpp100_clip K2 vs plain: denoiser part rel_l2 "
            f"{rel:.3e} (tol {LEARN_TOL[dt]:g}; history not pushed "
            f"{fault_rel:.3e}); plain row range [{plain_row.min():.2f}, "
            f"{plain_row.max():.2f}]")
        if not rel <= LEARN_TOL[dt]:
            failed.append(f"{dt} dpmpp100_clip K2 vs plain {rel:.3e}")
        faults = {
            "k2_vs_plain": [f"rel_l2 {fault_rel:.3e}"]
            if fault_rel > LEARN_TOL[dt] else [],
            "rows": row_failures({"dpmpp100 from a NaN x_T": nan_row},
                                 (b, t_mel, int(hp["audio_num_mel_bins"]))),
            # dpmpp100_clip's ladder with its clamp dropped: dpmpp100's
            "range": range_failures({"dpmpp100_clip": mels["dpmpp100"]}),
            "counts": count_failures(
                "plain row", {"K2": res["faults"][f"plain {dt}"][
                    "plms_ladder"]}, {"K2": 1})}
        res["faults"][dt] = faults
        for gate, msgs in faults.items():
            log(f"[learn] {dt} fault for the {gate} gate: {msgs or 'PASSED'}")
            if not msgs:
                faults_missed.append(f"{dt} {gate}")
        del model
    for gate in ("resume", "loss"):
        log(f"[learn] fault for the {gate} gate: "
            f"{res['faults'][gate] or 'PASSED'}")
        if not res["faults"][gate]:
            faults_missed.append(gate)
    res["seconds"]["grids"] = time.time() - t1
    res["seconds"]["total"] = time.time() - t0
    log(f"[learn] phase 15 took {res['seconds']}s")
    if faults_missed:
        raise SmokeError(f"phase 15 planted faults not caught: "
                         f"{faults_missed}")
    if failed:
        raise SmokeError(f"phase 15 gates failed: {failed}")
    return res


# ---------------------------------------------------------------------------
# Phase 16: the vocoder's learned-quality evidence and the train-stream A/B
# ---------------------------------------------------------------------------

# Depth of the phase (the tools' own defaults: 400 steps on 8 clips for
# train_istft, 1,500 steps on 16 clips for ab_vocoder, 200 steps for
# ab_train_stream): full width, fewer steps
VOCLEARN_STEPS = 30
VOCLEARN_CLIPS = 8
STREAM_STEPS = 20
# the trained NSF generator through K3 against its plain apply: K3's f32
# limit (phase 3's vocoder_tail check)
VOCLEARN_K3_TOL = TOL[("vocoder_tail", "f32")]
# each leg's launches over the A/B: {counter: launches per step}
STREAM_LAUNCHES = {
    "batched_bf16": {"K4_bwd": 1, "K4_bwd_f32": 0, "K5": 0},
    "kernel_f32": {"K4_bwd": 0, "K4_bwd_f32": 0, "K5": 1},
    "scan": {"K4_bwd": 1, "K4_bwd_f32": 1, "K5": 0}}
TRAIN_KERNELS = ("residual_stack_train_batched", "residual_stack_train")


def falls_failures(label: str, before: float, after: float) -> list:
    return [] if after < before else [f"{label}: held-out mel-L1 {before:.4f}"
                                      f" -> {after:.4f} did not fall"]


def leg_count_failures(name: str, launches: dict, steps: int) -> list:
    want = {k: v * steps for k, v in STREAM_LAUNCHES[name].items()}
    got = {k: launches[k] for k in want}
    return [] if got == want else [f"{name} launches {got}, want {want}"]


def unrepaired_route():
    """``diffnet.train_route`` without its ``diffnet_pallas_train`` (the
    route rule before the repair: "off" streams as configured)."""
    from diffsvc_tpu_torch.models import diffnet

    route = diffnet.train_route

    def old(n_layers, cycle, t, c, b, stream="bf16", seq=1, pallas="auto"):
        return route(n_layers, cycle, t, c, b, stream, seq)
    return swapped(diffnet, train_route=old)


def k4_backward_dropped():
    """K4's training call with its output detached: no gradient reaches
    the residual stack's weights, the conditioner or the step MLP (the
    fault of Queue 3 #1, ``DiffNet.stacked()``'s detached weights)."""
    from diffsvc_tpu_torch.ops.hopper import diffnet_stack_train as k4

    run = k4.residual_stack_train_batched

    def fn(*args, **kw):
        return run(*args, **kw).detach()
    return swapped(k4, residual_stack_train_batched=fn)


def nsf_render_rel(task, held, randoms, drop_last=False) -> float:
    """rel-L2 of the NSF render through K3 (``apply_serving``; its last
    NSF injection zeroed with ``drop_last``) against the plain ``apply``."""
    import torch

    from diffsvc_tpu_torch.ops.hopper import vocoder_tail as vt
    from diffsvc_tpu_torch.tools import train_istft as ti
    from diffsvc_tpu_torch.vocoders import generator as gen_mod

    tail = vt.tail

    def dropped(x, injs, plan):
        return tail(x, injs[:-1] + [torch.zeros_like(injs[-1])], plan)

    with swapped(vt, tail=dropped) if drop_last else contextlib.nullcontext():
        _, _, kern = ti.render(task, held, randoms, stft=False,
                               serving=gen_mod.apply_serving)
    _, _, plain = ti.render(task, held, randoms, stft=False,
                            serving=gen_mod.apply)
    return rel_l2(kern, plain)


def voclearn_held(device):
    """The tools' held-out clip (clip 0 of ``make_clips`` at the production
    profile)."""
    from diffsvc_tpu_torch.tools import ab_vocoder as av
    from diffsvc_tpu_torch.tools import train_istft as ti

    p = av.profile(False)
    return ti.make_clips(p["sr"], 1, p["dur"], p["hop"], p["nmel"],
                         p["nfft"], p["win"], 40.0, ti.fmax_of(p["sr"]),
                         device)[0]


def phase_voclearn(device, workdir):
    """Phase 16 (``[voclearn]`` lines): ``tools/train_istft`` and
    ``tools/ab_vocoder`` at full width and reduced depth, the trained NSF
    generator's K3 render against its plain version, and
    ``tools/ab_train_stream`` at B=24 x T=1024, each gate with a planted
    fault that must fail it."""
    import torch

    from diffsvc_tpu_torch.config import HParams
    from diffsvc_tpu_torch.tools import ab_train_stream as ts
    from diffsvc_tpu_torch.tools import ab_vocoder as av
    from diffsvc_tpu_torch.tools import train_istft as ti
    from diffsvc_tpu_torch.training.vocoder_task import VocoderTask
    from diffsvc_tpu_torch.vocoders import istft_head

    t0 = time.time()
    res = {"launches": {}, "seconds": {}, "faults": {}}
    failed, faults = [], {}
    scratch = os.path.join(workdir, "voclearn")
    # (a) the iSTFT head's demo: no kernel runs the head
    args = ti.parse_args(["--steps", str(VOCLEARN_STEPS), "--out",
                          os.path.join(scratch, "istft")])
    with counted("train_istft", res["launches"], moved=(),
                 still=ALL_KERNELS, tag="voclearn"):
        demo = ti.run(args)
    res["train_istft"] = demo
    l1 = demo["held_out_mel_l1"]
    rl = demo["wrapper_reload"]
    log(f"[voclearn] train_istft {VOCLEARN_STEPS} steps at "
        f"{demo['dims']['dim']} x {demo['dims']['layers']}: "
        f"{demo['ms_per_step']} ms/step (first {demo['compile_s']}s); "
        f"held-out mel-L1 {l1['before']} -> {l1['after']}; wrapper reload "
        f"{rl}")
    failed += falls_failures("train_istft", l1["before"], l1["after"])
    if not rl["ok"]:
        failed.append(f"train_istft wrapper reload {rl}")
    hp = av.family_hp(av.profile(False), "istft")
    fresh = VocoderTask(hp, device=device)
    held = voclearn_held(device)
    faults["train_istft falls"] = falls_failures(
        "untrained head as after", l1["before"],
        round(ti.render(fresh, held, stft=False)[0], 4))
    # a wrapper that missed the checkpoint holds the seed-0 init
    wrong = istft_head.IstftVocoder(HParams(dict(
        hp, vocoder_ckpt=os.path.join(scratch, "no_such.npz"))),
        device=device).gen.state_dict()
    trained = istft_head.load_params(demo["ckpt"], fresh.icfg,
                                     device).state_dict()
    faults["train_istft reload"] = [] if all(
        torch.equal(v, trained[k]) for k, v in wrong.items()) \
        else ["a wrapper without the checkpoint: params differ"]
    del fresh, wrong, trained
    res["seconds"]["train_istft"] = time.time() - t0

    # (b) the A/B: both families, the NSF renders through K3
    t1 = time.time()
    args = av.parse_args(["--steps", str(VOCLEARN_STEPS), "--n-clips",
                          str(VOCLEARN_CLIPS), "--out",
                          os.path.join(scratch, "ab")])
    with counted("ab_vocoder", res["launches"], moved=("vocoder_tail",),
                 still=TRAIN_KERNELS + ("residual_stack", "plms_ladder"),
                 tag="voclearn"):
        summary, tasks = av.run(args)
    res["ab_vocoder"] = summary
    for name, r in summary["results"].items():
        h = r["held_out"]
        log(f"[voclearn] ab_vocoder {name} {VOCLEARN_STEPS} steps: "
            f"{r['steps_per_s']} steps/s; mel-L1 {h['mel_l1_before']} -> "
            f"{h['mel_l1_after']}, mr-stft {h['mr_stft_before']} -> "
            f"{h['mr_stft_after']}; render launches {r['render_launches']}")
        failed += falls_failures(f"ab_vocoder {name}", h["mel_l1_before"],
                                 h["mel_l1_after"])
    k3 = summary["results"]["nsf"]["render_launches"]
    failed += count_failures("NSF renders", {"K3": k3["before"]["K3"]
                                             + k3["after"]["K3"]},
                             {"K3": 2})
    nsf = tasks["nsf"]
    untrained = VocoderTask(av.family_hp(av.profile(False), "nsf"),
                            device=device)
    randoms = ti.nsf_randoms(nsf, held["mel"].shape[0])
    faults["ab_vocoder falls"] = falls_failures(
        "untrained NSF as after",
        summary["results"]["nsf"]["held_out"]["mel_l1_before"],
        round(ti.render(untrained, held, randoms, stft=False)[0], 4))
    del untrained
    with counted("K3 render vs plain", res["launches"],
                 moved=("vocoder_tail",), tag="voclearn"):
        rel = nsf_render_rel(nsf, held, randoms)
    fault_rel = nsf_render_rel(nsf, held, randoms, drop_last=True)
    res["k3_render"] = {"rel_l2": rel, "tol": VOCLEARN_K3_TOL,
                        "fault_last_injection_dropped": fault_rel,
                        "frames": int(held["mel"].shape[0])}
    log(f"[voclearn] trained NSF render (B=1, {held['mel'].shape[0]} "
        f"frames) K3 vs plain apply: rel_l2 {rel:.3e} (tol "
        f"{VOCLEARN_K3_TOL:g}; last NSF injection dropped {fault_rel:.3e})")
    if not rel <= VOCLEARN_K3_TOL:
        failed.append(f"trained NSF render K3 vs plain {rel:.3e}")
    faults["k3_render"] = [f"rel_l2 {fault_rel:.3e}"] \
        if fault_rel > VOCLEARN_K3_TOL else []
    del tasks, nsf
    res["seconds"]["ab_vocoder"] = time.time() - t1

    # (c) the train-stream A/B at B=24 x T=1024, C=384, L=20
    t2 = time.time()
    d = ts.dims(ts.parse_args(["--steps", str(STREAM_STEPS)]))
    with counted("ab_train_stream", res["launches"], moved=TRAIN_KERNELS,
                 still=("residual_stack", "plms_ladder", "vocoder_tail"),
                 tag="voclearn"):
        legs = ts.train_legs(d, device)
    curves = {name: rec.pop("curve") for name, rec in legs.items()}
    cmp_ = ts.compare(curves, STREAM_STEPS)
    res["ab_train_stream"] = dict(cmp_, legs=legs, curves=curves, dims=d)
    for name, rec in legs.items():
        log(f"[voclearn] ab_train_stream {name}: route {rec['route']}, "
            f"launches {rec['launches']}, "
            f"{rec['wall_s'] / STREAM_STEPS * 1e3:.1f} ms/step incl host; "
            f"loss {curves[name][0]:.5f} -> {curves[name][-1]:.5f}")
        failed += leg_count_failures(name, rec["launches"], STREAM_STEPS)
    log(f"[voclearn] ab_train_stream B={d['B']} T={d['T']} C={d['C']} "
        f"L={d['L']} {STREAM_STEPS} steps: tail means "
        f"{cmp_['tail_mean_loss']}, gaps {cmp_['gap_vs_scan']}, bf16 rel "
        f"gap {cmp_['bf16_rel_gap']:.3e}")
    failed += ts.failures(curves, STREAM_STEPS)
    # the planted faults: the scan leg on the route rule before the repair
    # (the bf16 stream through K4), which the launches must see (its gap is
    # the bf16 leg's own: printed), and the bf16 leg with K4's backward
    # dropped, which the asserts must see
    with unrepaired_route():
        old = ts.train_legs(d, device, legs=ts.LEGS[2:])["scan"]
    faults["stream launches"] = leg_count_failures("scan", old["launches"],
                                                   STREAM_STEPS)
    with k4_backward_dropped():
        leg = ts.train_legs(d, device, legs=ts.LEGS[:1])["batched_bf16"]
    res["faults"]["stream"] = {}
    for label, cv in (("scan at the bf16 stream",
                       dict(curves, scan=old["curve"])),
                      ("bf16 leg, K4's backward dropped",
                       dict(curves, batched_bf16=leg["curve"]))):
        r = ts.compare(cv, STREAM_STEPS)
        msgs = ts.failures(cv, STREAM_STEPS)
        res["faults"]["stream"][label] = dict(r, failures=msgs)
        log(f"[voclearn] stream fault [{label}]: gaps {r['gap_vs_scan']}, "
            f"tail means {r['tail_mean_loss']}: {msgs or 'PASSED'}")
    faults["stream asserts"] = res["faults"]["stream"][
        "bf16 leg, K4's backward dropped"]["failures"]
    res["seconds"]["ab_train_stream"] = time.time() - t2

    res["faults"].update(faults)
    missed = [gate for gate, msgs in faults.items() if not msgs]
    for gate, msgs in faults.items():
        log(f"[voclearn] fault for the {gate} gate: {msgs or 'PASSED'}")
    res["seconds"]["total"] = time.time() - t0
    log(f"[voclearn] phase 16 took {res['seconds']}s")
    if missed:
        raise SmokeError(f"phase 16 planted faults not caught: {missed}")
    if failed:
        raise SmokeError(f"phase 16 gates failed: {failed}")
    return res


# ---------------------------------------------------------------------------
# Phase 17: the one-command drive and the mel-MCD metric
# ---------------------------------------------------------------------------

DRIVE_TIMEOUT = 600
# BASELINE.md's mel-MCD limit, the JAX tool's own (compare_mel.MCD_LIMIT_DB)
DRIVE_MCD_DB = 0.5
# the planted fault: the CPU side converts at this key, the drive at 2
DRIVE_FAULT_KEY = 0
# the drive's counters (K1-K6) by the kernels line's names
DRIVE_KERNELS = {"K1": "residual_stack", "K2": "plms_ladder",
                 "K3": "vocoder_tail", "K4": "residual_stack_train_batched",
                 "K5": "residual_stack_train", "K6": "fused_residual_block"}


def reuse_failures(rec: dict, before: list) -> list:
    """The warm start's reuse gate on one child's record: it built nothing
    and the build root holds the files it held before the child ran."""
    out = []
    if rec["build_seconds"] is not None:
        out.append(f"built the library ({rec['build_seconds']:.1f}s)")
    if rec["files"] != before:
        out.append(f"the build root went from {len(before)} to "
                   f"{len(rec['files'])} files")
    return out


@contextlib.contextmanager
def card_draws(device):
    """A CPU conversion with the draws the card's made: ``run_clip`` seeds
    each chunk's sampler and NSF source with 0 on the converting device
    (``Svc.infer``: x_T first from one generator; the vocoder's
    ``draw_randoms`` from another), so both are drawn here from generators
    on the card seeded alike and moved to the CPU."""
    import torch

    from diffsvc_tpu_torch.models import diffusion
    from diffsvc_tpu_torch.vocoders import generator as gen_mod

    infer0, draw0 = diffusion.GaussianDiffusion.infer, gen_mod.draw_randoms

    def infer(self, batch, **kw):
        if kw.get("init_noise") is None and not kw.get("use_gt_mel"):
            g = torch.Generator(device=device).manual_seed(0)
            kw["init_noise"] = torch.randn(
                (*batch["mel2ph"].shape, self.mel_bins), generator=g,
                device=device).cpu()
        return infer0(self, batch, **kw)

    def draw(batch, length, harmonic_num, generator=None, device_=None):
        g = torch.Generator(device=device).manual_seed(0)
        return tuple(r.cpu() for r in draw0(batch, length, harmonic_num, g,
                                            device))

    with swapped(diffusion.GaussianDiffusion, infer=infer), \
            swapped(gen_mod, draw_randoms=draw):
        yield


def start_drive(workdir):
    """Phase 17's child, ``python -m diffsvc_tpu_torch.tools.verify_drive
    --full``, started on the card (its output to files under ``workdir``);
    main starts it before phase 16 and phase 16 runs beside it."""
    out = os.path.join(workdir, "verify_drive")
    with open(out + ".out", "w") as so, open(out + ".err", "w") as se:
        proc = subprocess.Popen(
            [sys.executable, "-m", "diffsvc_tpu_torch.tools.verify_drive",
             "--full"], cwd=workdir,
            env=dict(os.environ, PYTHONPATH=ROOT, TMPDIR=workdir),
            stdout=so, stderr=se)
    return {"proc": proc, "out": out, "t0": time.time()}


def phase_drive(device, workdir, drive):
    """Phase 17 (``[drive]`` lines): the ``verify_drive --full`` child
    (``drive``, from :func:`start_drive`) read, its song converted again
    with its trained checkpoint on the CPU, and the two outputs read by
    ``python -m diffsvc_tpu_torch.tools.compare_mel``."""
    import shutil

    from diffsvc_tpu_torch.tools import compare_mel
    from diffsvc_tpu_torch.tools import verify_drive as vd

    t0 = time.time()
    res = {"launches": {}, "seconds": {}, "faults": {}}
    failed, faults = [], {}
    rc = drive["proc"].wait(timeout=max(DRIVE_TIMEOUT - (t0 - drive["t0"]),
                                        1))
    with open(drive["out"] + ".out") as f:
        stdout = f.read()
    with open(drive["out"] + ".err") as f:
        stderr = f.read()
    lines = stdout.strip().splitlines()
    if rc != 0 or not lines or lines[-1] != "ALL VERIFY STEPS PASSED":
        raise SmokeError(f"verify_drive --full: exit {rc}\n"
                         f"{stdout[-2000:]}\n{stderr[-3000:]}")
    s = res["summary"] = json.loads(lines[-2])
    res["seconds"]["drive"] = time.time() - drive["t0"]
    res["seconds"]["drive_after_phase_16"] = time.time() - t0
    for name, rec in s["steps"].items():
        res["launches"][name] = {DRIVE_KERNELS[k]: v
                                 for k, v in rec["launches"].items()}
        log(f"[drive] {name}: {rec['seconds']:.2f}s, kernel launches "
            f"{rec['launches']}")
    # (1) the drive's own gates, read again: the training stack on the
    # trainer's route, K2 and K3 in the conversion, the warm start
    run, conv = s["steps"]["run"]["launches"], s["steps"]["infer_cli"]
    if run["K4"] + run["K5"] <= 0:
        failed.append(f"run launched neither K4 nor K5: {run}")
    if conv["launches"]["K2"] <= 0 or conv["launches"]["K3"] <= 0:
        failed.append(f"infer_cli launched K2 {conv['launches']['K2']}, K3 "
                      f"{conv['launches']['K3']}")
    k6 = {name: rec["launches"]["K6"] for name, rec in s["steps"].items()}
    if any(k6.values()):
        failed.append(f"K6, on no path, was launched: {k6}")
    if conv["samples"] != conv["input_samples"]:
        failed.append(f"infer_cli: {conv['samples']} samples against "
                      f"{conv['input_samples']}")
    cold, warm = (s["steps"]["warm_start"][k] for k in ("cold", "warm"))
    if cold["build_seconds"] is None or not any(
            f.endswith("libdsvc_hopper.so") for f in cold["files"]):
        failed.append(f"the cold process did not build the library: {cold}")
    failed += reuse_failures(warm, cold["files"])
    # the planted fault for the reuse gate: the cold process
    faults["warm start reuse"] = reuse_failures(cold, [])
    log(f"[drive] warm start: the cold process built in "
        f"{cold['build_seconds']}s ({len(cold['files'])} files under the "
        f"fresh build root), the warm one loaded in {warm['load_s']:.2f}s "
        f"(build_seconds {warm['build_seconds']}, "
        f"{len(warm['files'])} files); the reuse gate on the cold process: "
        f"{faults['warm start reuse'] or 'PASSED'}")
    # (2) the drive's song with its trained checkpoint again on the CPU,
    # from the card's draws; (3) compare_mel card vs CPU through its command
    # line, beside (2) at another key, the planted fault
    t1 = time.time()
    paths = {"config": s["config"], "song": s["song"]}
    card_wav = conv["output"]
    outs, cwd = {}, os.getcwd()
    try:
        for key in (2, DRIVE_FAULT_KEY):
            d = os.path.join(s["scratch"], f"cpu_key{key}")
            os.makedirs(d)
            os.chdir(d)
            with card_draws(device):
                outs[key] = os.path.abspath(vd.convert(
                    paths, s["trained_ckpt"], True, "cpu", key=key))
            if key == 2:
                compare = subprocess.Popen(
                    [sys.executable, "-m",
                     "diffsvc_tpu_torch.tools.compare_mel", card_wav,
                     outs[2], "--config", s["config"]], cwd=workdir,
                    env=dict(os.environ, PYTHONPATH=ROOT),
                    stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                    text=True)
    finally:
        os.chdir(cwd)
    out, err = compare.communicate(timeout=300)
    res["seconds"]["cpu_and_compare"] = time.time() - t1
    stats = dict(line.split(": ", 1) for line in out.splitlines()
                 if ": " in line)
    if "mcd_db" not in stats:
        raise SmokeError(f"compare_mel: exit {compare.returncode}\n"
                         f"{err[-2000:]}")
    mcd = float(stats["mcd_db"])
    fault = compare_mel.compare_mels(*compare_mel.wav_mels(
        card_wav, outs[DRIVE_FAULT_KEY], s["config"], "cuda"))
    res["mcd"] = {"card_vs_cpu": {k: float(v) for k, v in stats.items()},
                  "exit": compare.returncode, "limit_db": DRIVE_MCD_DB,
                  f"fault_cpu_key{DRIVE_FAULT_KEY}": fault}
    log(f"[drive] compare_mel card vs CPU ({s['song']}, key 2, acc 20, the "
        f"card's draws): mcd {mcd:.4f} dB (limit {DRIVE_MCD_DB}), l1 "
        f"{float(stats['l1']):.3e}, rmse {float(stats['rmse']):.3e}, "
        f"{stats['frames']} frames, exit {compare.returncode}; planted fault "
        f"[the CPU side at key {DRIVE_FAULT_KEY}]: mcd {fault['mcd_db']:.4f} "
        f"dB")
    if not (mcd < DRIVE_MCD_DB and compare.returncode == 0):
        failed.append(f"card vs CPU mel-MCD {mcd:.4f} dB (exit "
                      f"{compare.returncode})")
    faults["mel-MCD"] = [f"mcd {fault['mcd_db']:.4f} dB"] \
        if fault["mcd_db"] > DRIVE_MCD_DB else []
    shutil.rmtree(s["scratch"], ignore_errors=True)
    res["faults"].update(faults)
    missed = [gate for gate, msgs in faults.items() if not msgs]
    res["seconds"]["total"] = time.time() - t0
    log(f"[drive] phase 17 took {res['seconds']}s")
    if missed:
        raise SmokeError(f"phase 17 planted faults not caught: {missed}")
    if failed:
        raise SmokeError(f"phase 17 gates failed: {failed}")
    return res


# ---------------------------------------------------------------------------
# Phase 18: the device-time and serving-soak tools
# ---------------------------------------------------------------------------

DECOMPOSE_SOAK_S = 10.0     # each soak leg's seconds
DECOMPOSE_FAULT_SOAK_S = 1.0
PARITY_LIMIT = 2e-2         # train_decompose's, the JAX tool's


def early_cuda_time_ms(fn, reps: int) -> float:
    """A planted timing fault: the end event is recorded before the
    launches are queued, so the window holds none of them."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    end.record()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def cotangent_dropped_bf16(bwd):
    """K4's backward with the last sample's cotangent dropped at the bf16
    stream (phase 3's fault, on the leg that parity checks)."""
    import torch

    def fn(xsave, sb, cp, wd, bd, wo, dout, *, cycle):
        if wd.dtype == torch.bfloat16:
            dout = dout.clone()
            dout[-1] = 0
        return bwd(xsave, sb, cp, wd, bd, wo, dout, cycle=cycle)
    return fn


def share_failures(label: str, shares: dict) -> list:
    return [f"{label} {k} share {v}" for k, v in shares.items()
            if not (v is not None and 0 < v <= 100)]


def phase_decompose(device):
    """The five tools on the card in this process (``[decompose]`` lines):
    ``mfu_decompose`` at production width (2 rounds), ``train_decompose``
    at B=24 x 1024 (one round), ``bench_pipe_stages`` once,
    ``bench_realtime`` (prod, 5 runs per length) and ``soak_serving`` (10 s
    per leg).  Gates: every share in (0, 100%], the train parity below 2e-2,
    the soak's 0 errors and 0 programs built after warm-up, K1-K5 moving;
    each with its planted fault above it (a timing window that ends early,
    the last sample's cotangent dropped at the bf16 stream, a warm-up to
    0.2 s for a mix of 0.2 and 0.5 s buffers)."""
    import torch

    from diffsvc_tpu_torch.ops.hopper import diffnet_stack as k1
    from diffsvc_tpu_torch.ops.hopper import diffnet_stack_train as k4
    from diffsvc_tpu_torch.tools import (bench_pipe_stages, bench_realtime,
                                         mfu_decompose, soak_serving,
                                         train_decompose)
    from diffsvc_tpu_torch.utils import devtime
    from diffsvc_tpu_torch.utils.synth import stack_inputs

    t0 = time.time()
    res, launches, failed, faults, secs = {}, {}, [], {}, {}
    with counted("mfu_decompose", launches,
                 moved=("residual_stack", "plms_ladder"), tag="decompose"):
        t = time.time()
        args = mfu_decompose.parse_args(["--iters", "16", "--loop-reps", "1",
                                         "--rounds", "2"])
        d = mfu_decompose.dims(False)
        ms, mels, outs, _ = mfu_decompose.time_levels(d, device, args)
        mfu = mfu_decompose.derive(ms, d, card=True)
        mfu.update(mfu_decompose.cross_checks(mels, outs))
        secs["mfu_decompose"] = time.time() - t
    res["mfu_decompose"] = mfu
    shares = {k: v for k, v in mfu.items() if k.startswith("mfu_")}
    log(f"[decompose] mfu_decompose (T={d['T']}): us per unit "
        f"{ {k: round(v, 1) for k, v in mfu.items() if k.endswith('_us')} }; "
        f"shares % {shares}; cross-checks "
        f"{ {k: v for k, v in mfu.items() if 'vs' in k} }")
    failed += share_failures("mfu_decompose", shares)
    a = stack_inputs(torch.bfloat16, device, 1, d["T"], d["C"], d["L"])
    with swapped(devtime, cuda_time_ms=early_cuda_time_ms):
        early = devtime.best_ms(lambda: k1.residual_stack(**a, cycle=4), 16,
                                1, device)
    del a
    planted = 100 * mfu["flops"]["kernel_per_iter"] / (early * 1e-3) \
        / devtime.PEAK_FLOPS["bf16"]
    try:
        mfu_decompose.derive(dict(ms, kernel_bf16=early), d, card=True)
        faults["share guard"] = []
    except devtime.TimingFault as e:
        faults["share guard"] = [f"K1 bf16 {early:.3g} ms, {planted:.0f}%: "
                                 f"{e}"]
    log(f"[decompose] planted fault [a window that ends early]: K1 bf16 "
        f"{early:.4g} ms, share {planted:.1f}% -> "
        f"{'raised' if faults['share guard'] else 'NOT raised'}")

    with counted("train_decompose", launches,
                 moved=("residual_stack", "residual_stack_train_batched",
                        "residual_stack_train"), tag="decompose"):
        t = time.time()
        args = train_decompose.parse_args(["--rounds", "1", "--reps", "2",
                                           "--step-reps", "2"])
        td = train_decompose.run(args)
        secs["train_decompose"] = time.time() - t
    res["train_decompose"] = td
    for name, leg in td["legs"].items():
        log(f"[decompose] train {name}: {leg['ms']:.2f} ms device, "
            f"{leg['ms_wall']:.2f} ms wall, {leg['mfu_pct']}% "
            f"({leg['flops_count']}) -- {leg['route']}")
    failed += share_failures("train_decompose", {
        f"{n}.{k}": leg[k] for n, leg in td["legs"].items()
        for k in ("mfu_pct", "mfu_pct_hardware") if k in leg})
    parity = max(td["parity_batched_vs_scan_relmax"].values())
    if not parity < PARITY_LIMIT:
        failed.append(f"train parity {parity:.3e}")
    dt = train_decompose.dims(args, False)
    *ops, dout = train_decompose.stack_operands(dt, device)
    with swapped(k4, residual_stack_train_batched_bwd=cotangent_dropped_bf16(
            k4.residual_stack_train_batched_bwd)):
        fault = max(train_decompose.parity(tuple(ops), dout,
                                           dt["CYC"]).values())
    del ops, dout
    faults["train parity"] = [f"{fault:.3e}"] if fault > PARITY_LIMIT else []
    log(f"[decompose] train parity bf16 stream vs scan {parity:.3e} (limit "
        f"{PARITY_LIMIT}); planted fault [last sample's cotangent dropped]: "
        f"{fault:.3e}")
    torch.cuda.empty_cache()

    with counted("bench_pipe_stages", launches,
                 moved=("residual_stack", "plms_ladder"), tag="decompose"):
        t = time.time()
        pipe = bench_pipe_stages.run(bench_pipe_stages.parse_args(
            ["--runs", "1", "--k", "4"]))
        secs["bench_pipe_stages"] = time.time() - t
    res["bench_pipe_stages"] = pipe["rows"]
    log(f"[decompose] pipe stages ms: "
        f"{ {r['name']: round(r['ms'], 3) for r in pipe['rows']} }")

    with counted("bench_realtime", launches, tag="decompose"):
        t = time.time()
        rt = bench_realtime.run(bench_realtime.parse_args(["--runs", "5"]))
        secs["bench_realtime"] = time.time() - t
    res["bench_realtime"] = rt
    for row in rt["rows"]:
        log(f"[decompose] realtime {row['dur_s']} s: cold {row['cold_s']:.2f}"
            f" s, p50 {row['p50_ms']:.1f} ms, p95 {row['p95_ms']:.1f} ms, "
            f"pipelined p50 {row['pipe_p50_ms']:.1f} ms, headroom "
            f"{row['rt_headroom']:.1f}x")
    log(f"[decompose] realtime buckets built: {rt['n_buckets']}")
    torch.cuda.empty_cache()

    with counted("soak_serving", launches, tag="decompose"):
        t = time.time()
        sargs = soak_serving.parse_args([])
        w = soak_serving.widths(False)
        fused = soak_serving.random_fused(
            soak_serving.serving_hp(w, sargs.acc), w, device, sargs.acc)
        # the planted fault first, on the same program cache: warmed to
        # 0.2 s, a mix of 0.2 and 0.5 s buffers builds the second bucket
        sargs.minutes, sargs.warmup_seconds = DECOMPOSE_FAULT_SOAK_S / 60, 0.2
        short = soak_serving.soak(fused, sargs, [0.2, 0.5], [0, 3])
        sargs.minutes, sargs.warmup_seconds = DECOMPOSE_SOAK_S / 60, None
        durs = [float(x) for x in sargs.durs.split(",")]
        keys = [int(x) for x in sargs.keys.split(",")]
        sk = soak_serving.soak(fused, sargs, durs, keys)
        secs["soak_serving"] = time.time() - t
    del fused
    res["soak_serving"] = sk
    built = short["legs"]["nonstream"]["recompiles_after_warmup"]
    faults["programs after warm-up"] = [f"{built}"] if built >= 1 else []
    for name, leg in sk["legs"].items():
        log(f"[decompose] soak {name}: {leg['requests']} requests, "
            f"{leg['errors']} errors, {leg['recompiles_after_warmup']} "
            f"programs built after warm-up, p50/p95/p99 "
            f"{leg['overall']} ms; K2/K3 {leg['launches']}")
        if leg["errors"] or leg["recompiles_after_warmup"]:
            failed.append(f"soak {name}: {leg['errors']} errors, "
                          f"{leg['recompiles_after_warmup']} programs")
    log(f"[decompose] soak warm-up {sk['warmup_buckets']} buckets in "
        f"{sk['warmup_s']:.1f} s, graph pools {sk['pool_bytes_total']} "
        f"bytes; planted fault [warm-up to 0.2 s]: {built} programs built "
        "after it")
    counts = {k: sum(c[k] for c in launches.values())
              for k in ALL_KERNELS[:5]}
    if not all(counts.values()):
        failed.append(f"K1-K5 over phase 18: {counts}")
    secs["total"] = time.time() - t0
    res.update(launches=launches, faults=faults, seconds=secs)
    log(f"[decompose] phase 18 took { {k: round(v, 1) for k, v in secs.items()} }"
        "s")
    missed = [gate for gate, msgs in faults.items() if not msgs]
    if missed:
        raise SmokeError(f"phase 18 planted faults not caught: {missed}")
    if failed:
        raise SmokeError(f"phase 18 gates failed: {failed}")
    return res


def diffnet_apply_card(model, noise, t, cond, device):
    """``diffnet.apply`` (K1) on the card from the graph's layouts: noise
    [1, 1, M, T], t [1], cond [1, H, T] -> [1, 1, M, T], numpy."""
    import numpy as np
    import torch

    from diffsvc_tpu_torch.models import diffnet

    spec = torch.from_numpy(np.ascontiguousarray(
        noise[:, 0].transpose(0, 2, 1))).to(device)
    c = torch.from_numpy(np.ascontiguousarray(cond.transpose(0, 2, 1))) \
        .to(device)
    out = diffnet.apply(model.denoise_fn, spec, torch.from_numpy(t).to(device),
                        c)
    return out.float().transpose(1, 2)[:, None].cpu().numpy()


# ---------------------------------------------------------------------------

def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode != 0:
        raise SmokeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="", help="write the full record (JSON)")
    ap.add_argument("--deterministic-step", default="", metavar="BUNDLE",
                    help="phase 5's child process: run one step twice from "
                    "BUNDLE under deterministic algorithms")
    ap.add_argument("--dist-job", nargs=2, default=None,
                    metavar=("JOB", "BUNDLE"),
                    help="a rank of phase 10 (world1 or world2) or 12 "
                    "(seq), started by the phase itself")
    ap.add_argument("--vocoder-resume", default="", metavar="BUNDLE",
                    help="phase 11's child process: each vocoder family's "
                    "resume against its uninterrupted run, under "
                    "deterministic algorithms")
    args = ap.parse_args(argv)
    if not os.path.isdir(os.path.join(ROOT, "diffsvc_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository "
              "(diffsvc_tpu_torch/ not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this test needs an NVIDIA "
              "GPU", file=sys.stderr)
        return 3
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.deterministic_step:
        return deterministic_step(args.deterministic_step)
    if args.dist_job:
        return dist_job(*args.dist_job)
    if args.vocoder_resume:
        return voc_resume(args.vocoder_resume)
    record = {}
    try:
        card = card_line()
        log(f"[card] {card}; torch {torch.__version__} cuda "
            f"{torch.version.cuda}; {torch.cuda.get_device_name(0)}")
        device = torch.device("cuda", 0)

        from diffsvc_tpu_torch.ops.hopper import _build

        t0 = time.time()
        _build.lib()
        record["build_s"] = time.time() - t0
        record["build_log"] = _build.build_log
        log(f"[build] kernels ready in {record['build_s']:.2f}s "
            f"(nvcc {_build.build_seconds})")
        for line in _build.build_log.splitlines():
            if "registers" in line or "spill" in line or "(C75" in line:
                log(f"[ptxas] {line.strip()}")

        seconds = record["phase_seconds"] = {}
        t0 = time.time()
        record["kernels"] = phase_kernels(device)
        seconds["3 kernels"] = time.time() - t0
        from diffsvc_tpu_torch.ops.hopper import diffnet_block as k6

        # K6 is on no path: phases 4-9 must not launch it
        k6.launches = k6.launches_tc = k6.launches_tf32x3 = 0
        with tempfile.TemporaryDirectory() as tmp:
            cwd = os.getcwd()
            os.chdir(tmp)     # Svc keeps its ./infer_tools caches here
            def timed(name, fn, *a):
                t = time.time()
                out = fn(*a)
                seconds[name] = time.time() - t
                return out

            try:
                record["slice"], project = timed("4 slice", phase_slice,
                                                 device, tmp)
                record["train"] = timed("5 train", phase_train, device, tmp)
                cfg = train_config(tmp)
                record["own_batch"] = timed(
                    "6 own batch", phase_train_own_batch, device, tmp,
                    cfg["hubert_path"], cfg["vocoder_ckpt"])
                record["serve"] = timed("7 serve", phase_serve, device,
                                        project)
                record["rest"] = timed("8 rest", phase_rest, device, project,
                                       tmp)
                record["train2"] = timed("9 train2", phase_train2, device, tmp)
                record["multi"] = timed("10 multi", phase_multi, device, tmp,
                                        project)
                record["voc"] = timed("11 voc", phase_voc, device, tmp,
                                     project)
                record["seq"] = timed("12 seq", phase_seq, device, tmp)
                record["onnx"] = timed("13 onnx", phase_onnx, device, tmp,
                                       project)
                record["pt2"] = timed("14 pt2", phase_pt2, device, tmp,
                                      project)
                record["learn"] = timed("15 learn", phase_learn, device, tmp)
                drive = start_drive(tmp)
                try:
                    record["voclearn"] = timed("16 voclearn", phase_voclearn,
                                               device, tmp)
                    record["drive"] = timed("17 drive", phase_drive, device,
                                            tmp, drive)
                    record["decompose"] = timed("18 decompose",
                                                phase_decompose, device)
                finally:
                    if drive["proc"].poll() is None:
                        drive["proc"].kill()
                        drive["proc"].wait()
            finally:
                os.chdir(cwd)
        log(f"[phases] seconds: { {k: round(v, 1) for k, v in seconds.items()} }")
        torch.cuda.synchronize()
        record["k6_path_launches"] = k6.launches
        log(f"[paths] K6 launches over phases 4-18: {k6.launches}")
        if k6.launches != 0:
            raise SmokeError(f"K6 was launched {k6.launches} times on a path; "
                             "no path of the port runs it")
    except SmokeError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1

    entries = []
    # each kernel's launches on the path that runs it: K1-K3 the conversions
    # (phase 4), K4 the trainer at max_sentences 24 (phase 5), K5 the trainer
    # at the config's own batch (phase 6); K6 is on no path, so its count over
    # phases 4-9, which must be 0; launches_rest: phase 8's routes (DDPM,
    # the 24 kHz profile); launches_train2: phase 9's parts (RAdam's
    # run_task, the trained pe's conversion, --infer); launches_multi:
    # phase 10's parts (each rank of the training runs in its own process
    # and counts its own launches); launches_voc: phase 11's routes and GAN
    # training runs; launches_seq: phase 12's parts (in process, and each
    # rank of the grid); launches_onnx: phase 13's card runs (K1, K2, K3
    # against the exported graphs); launches_pt2: phase 14's programs, one
    # call each; launches_learn: phase 15's training demo and its sampler
    # grid at f32 and bf16; launches_voclearn: phase 16's tools
    # (train_istft, ab_vocoder, the trained NSF generator's K3 render
    # against its plain version, ab_train_stream's three legs);
    # launches_drive: phase 17's drive, by step (its child process counts);
    # launches_decompose: phase 18's tools
    launches = dict(record["slice"]["launches"],
                    residual_stack_train_batched=record["train"]["launches"],
                    residual_stack_train=record["own_batch"]["launches"][
                        "residual_stack_train"],
                    fused_residual_block=record["k6_path_launches"])
    tc_launches = record["slice"]["launches_tc"]
    for name, (src, replaces) in KERNELS.items():
        by_dt = record["kernels"][name]
        main_dt = "bf16" if "bf16" in by_dt else "f32"
        main = by_dt[main_dt]
        measured = ("max_abs_err", "rel_l2", "ms", "plain_ms", "bound_ms",
                    "bound_by")
        entries.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": main["max_abs_err"],
                        "ms": main["ms"], "plain_ms": main["plain_ms"],
                        "bound_ms": main["bound_ms"],
                        "bound_by": main["bound_by"], "library_ms": None,
                        "dtype": main_dt,
                        "launches_tc": tc_launches["bfloat16"][
                            "launches_tc"].get(name),
                        "launches_tf32x3": tc_launches["float32"][
                            "launches_tf32x3"].get(name),
                        "main_path": name != "fused_residual_block",
                        "launches_serving": {
                            route: counts[name] for route, counts in
                            record["serve"]["launches"].items()},
                        "launches_rest": {
                            route: counts[name] for route, counts in
                            record["rest"]["launches"].items()},
                        "launches_train2": {
                            part: counts[name] for part, counts in
                            record["train2"]["launches"].items()},
                        "launches_multi": {
                            part: counts[name] for part, counts in
                            record["multi"]["launches"].items()},
                        "launches_voc": {
                            part: counts[name] for part, counts in
                            record["voc"]["launches"].items()},
                        "launches_seq": {
                            part: counts[name] for part, counts in
                            record["seq"]["launches"].items()},
                        "launches_onnx": record["onnx"]["launches"][
                            "phase 13"][name],
                        "launches_pt2": record["pt2"]["launches"][
                            "phase 14"][name],
                        "launches_learn": {
                            part: counts[name] for part, counts in
                            record["learn"]["launches"].items()},
                        "launches_voclearn": {
                            part: counts[name] for part, counts in
                            record["voclearn"]["launches"].items()},
                        "launches_drive": {
                            step: counts[name] for step, counts in
                            record["drive"]["launches"].items()},
                        "launches_decompose": {
                            tool: counts[name] for tool, counts in
                            record["decompose"]["launches"].items()},
                        "by_dtype": {dt: {k: r[k] for k in measured}
                                     for dt, r in by_dt.items()}})
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card, **record}, f, indent=1,
                      default=lambda o: o.item())   # numpy scalars
    print(json.dumps({"kernels": entries}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
