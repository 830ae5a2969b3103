#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py [--kernels]

Run from the root of a checkout; needs one CUDA card, ``nvcc`` and no
network.  ``--kernels`` runs phases 1 and 2 alone and ends with the
``kernels`` table (a quick check and timing of the kernels after an edit,
or of two trees in one call); without it every phase runs.  Phases, each
printing one JSON line with ``t`` (seconds since the start) and
``phase_seconds`` (seconds since the line before) (any failure exits
non-zero and prints no result):

1. ``env``    — the card's name and power limit (``nvidia-smi``), the torch
   and CUDA versions; then ``build``: every kernel of the port compiled
   from ``msrflute_tpu_torch/csrc`` (one ``nvcc`` per source, started
   together), with the build time and ``ptxas`` report.
2. ``kernel`` — each kernel against its plain PyTorch version on the card,
   at its paths' shapes and at odd shapes, then kernel, plain and library
   (or yardstick) times beside the least time the card could take
   (``bound_ms``).  Kernel and library times are read on the device alone
   (:func:`_device_ms`: each launch's own kernels as ``torch.profiler``
   records them, median of 200, L2 evicted before each launch); the
   event-bracketed time of 50 launches in a row, which the host's launch
   rate can set, stays beside them as ``ms_host_paced``:
   - B1 ``fused_sgd_apply``: mixed per-row gates (a NaN gate among them) at
     the three paths' shapes, rows at every residue mod 4, base pointers
     off a 16-byte boundary (for all three tensors, and for one alone),
     rows shorter than one vector: bitwise, with gated rows and the floats
     around each tensor untouched; timed at the CNN shape
     ``[10, 1,206,590]``, the DGA shape ``[10, 2,727,184]``, the ResNet
     shape ``[10, 11,227,812]``, the LSTM shape ``[10, 820,522]``, the
     personalization path's ``[10, 11,181,642]`` and the FedLabels path's
     ``[10, 319,178]`` beside ``torch._fused_sgd_``, with the card's clock
     and draw under it;
   - B2 ``fused_gaussian_noise``: the plain PyTorch Philox against
     cuRAND's ``curand_Philox4x32_10`` (Random123's known answers and
     random counters and keys), bitwise; the kernel's normals against the
     plain version's (bitwise, else within 2 ulp, and it says which); the
     moments and 3-sigma tail of its output, two seeds, and the
     correlation of neighbouring elements and blocks; its bound has an
     issue term, the instructions an element on the common path of the
     kernel's loop in the built library's SASS
     (``msrflute_tpu_torch/ops/sass.py::loop_path``) over SMs x 128
     lanes x the peak SM clock;
   - B3 ``quant_bin_sparsify``: the GRU's 7 leaves x 10 clients with
     thresholds from the 0.7 quantile and mixed ones, a leaf with
     ``hi == lo``, values exactly at half-bins, and the odd layouts of
     ``QUANT_CASES`` (empty leaves, leaves of 1-3 elements, ``[5, P]`` at
     P = 1, 2 and 3 mod 4, 1,000 leaves, x off a 16-byte boundary), each
     at ``n_bins`` 1024, 16 and 2: bitwise; then at BERT-base's
     ``[10, 109,514,298]`` in 202 leaves (a second row of the ``kernels``
     table) and at EF quantization's ``[10, 1,206,590]`` with one leaf a
     row, at 16 levels (a third row).  At each shape: the yardstick (the same function as a few
     PyTorch calls over the whole ``[K, P]``, held bitwise to the kernel
     first), the share of the bound and the rate, and the instructions a
     thread of a full tile issues an element, counted in the built
     library's SASS (``ops/sass.py::vector_path``; its loads of x must be
     128-bit), whose issue time over SMs x 128 lanes x the peak SM clock
     is the bound's third term;
   - B4, B5, B6 (flash attention forward, dq, dk/dv): at the RingLM
     path's ``[40, 1023, 4, 32]`` causal and at L = 1, 17 and 1000,
     Lq != Lk with offsets (rows whose keys are all masked must give exact
     zeros and ``lse == -1e30``), a last tile ragged on both axes with the
     diagonal through it, non-causal, D = 4, 5, 8, 20, 64 and 128 (16-byte
     and 4-byte copies), one head of one batch, a nonzero lse cotangent:
     within ``FLASH_FWD_TOL`` / ``FLASH_BWD_TOL``, two launches bitwise
     equal at the path's shape and at an offset case; the causal f32 SDPA
     forward and backward are the yardstick; B4 is also timed at the eval
     step's ``[16, 1023, 4, 32]``, with the card's clock and draw under it;
     the D = 32 instances of all three must not spill and must fit two
     blocks an SM (``ptxas`` and the CUDA runtime);
   - the bfloat16 and float16 storage arms (rows of their own in the
     ``kernels`` table, named ``fused_sgd_apply[bfloat16]`` and so on):
     B1's on ``SGD_CASES`` in 16-bit buffers, bitwise, timed at the CNN
     shape beside ``torch._fused_sgd_`` on the same 16-bit tensors; B4-B6's
     on eleven cases within ``FLASH16_TOL`` (one ulp of the type at the
     largest magnitude), two launches bitwise, timed at ``[40, 1023, 4,
     32]`` (B4 also at ``[16, 1023, 4, 32]``) beside the causal SDPA call
     in the same type, with a byte bound and an operation bound at the
     16-bit tensor-core rate (the float32 CUDA-core one beside it); B4's,
     B5's and B6's 16-bit arms are tensor-core kernels, and their D = 32
     instances must show HMMA or HGMMA instructions in the built
     library's SASS (``ops/sass.py::tensor_core_count``), no spill and two
     blocks an SM.
3. ``main``   — the FedAvg CNN_FEMNIST path through the port's CLI
   (``msrflute_tpu_torch.e2e_trainer``, in process) on ``cuda``, at the
   published ``cv_cnn_femnist`` widths (10 clients a round, batch 20,
   client SGD lr 0.1, server SGD lr 1.0, dropout on) with
   ``megakernel.pallas_apply: true``, 5 rounds.  The data is a synthetic
   FEMNIST-shaped user blob (28x28x1 uint8, 62 classes) of 350 writers
   with 50-300 samples each: FEMNIST's population of 3,400 writers cut to
   a tenth, so it generates in seconds.  Asserts B1 ran on every local
   step, losses are finite, and the checkpoint and status log exist.
   ``profile`` then times two more rounds of the same engine on the host
   clock and two under ``torch.profiler``: wall time and device time per
   round, the device's idle share, and the kernels that take the most
   device time.  ``cross_device``: 2 rounds of 4 clients with dropout off on
   a 40-writer blob, twice on ``cuda`` and once on ``cpu``: the cuda runs
   are bitwise equal and agree with the cpu run within ``CROSS_TOL``.
   ``pipeline``: ``main``'s config for 8 rounds (one val eval at the end)
   at ``pipeline_depth`` 0, 1 and 2 x ``rounds_per_step`` 1 and 25
   (``PIPELINE_SETTINGS``): params bitwise across depths, B1 once a local
   step at each setting, secs/round and its host split (pack, stage,
   dispatch, drain wait, host tail, checkpoint submit) and the chunks
   drained behind a later dispatch; a depth-1 run cut after round 4 and
   resumed to 8, bitwise; one round's dispatch half (staging, the round,
   the stats' copy, the ``latest`` snapshot) under
   ``torch.cuda.set_sync_debug_mode``, "warn" to name any synchronizing
   call and "error" to prove there is none (``dga`` does the same for the
   DGA round).  ``telemetry``: the ``pipeline_d2_r1`` config again with
   the whole ``server_config.telemetry`` block on (``profile_rounds:
   "2:3"``) under ``MSRFLUTE_STRICT_TRANSFERS=1``: params bitwise that
   run's, every span in ``trace.json``, two rounds in flight, each
   round's ``devbus/update_ratio`` finite, B1 15 times in the profiled
   round and bitwise its plain version on the path's first operands, no
   synchronizing call in the dispatch half; the counted FLOPs a round,
   the live MFU and the peak allocation beside secs/round on and off;
   then a two-round ``nan_loss: abort`` drill that must leave
   ``flight.json`` and the scorecard.  ``pipeline_profile``: busy and
   idle share through the
   server's own loop (``LOOP_SETTINGS``: depth 0 with per-leaf and with
   staged inputs, depths 1 and 2), windows of ``LOOP_ROUNDS`` rounds
   timed in turns, beside ``profile``.  Every other phase runs through
   the ring at the default depth 1.
4. ``dga``    — the DGA path through the CLI on ``cuda``:
   ``experiments/nlg_gru/config.yaml`` (the GRU word LM at its published
   widths, vocab 10,000, embed 160, hidden 512, 25 words; 10 clients a
   round, client SGD lr 1.0 at batch 64, 1,600 samples at most, server
   adam) plus local DP, global DP (kernel B2), quantization (kernel B3)
   and ``pallas_apply`` (kernel B1), 5 rounds, on a synthetic Reddit-shaped
   blob: a 10,000-word vocabulary with Zipf frequencies, 1,000 train users
   with 20-400 utterances of 5-25 words, 100 val and 100 test users (LEAF
   Reddit's population cut to what generates in seconds).  Asserts B2
   launched once per round, B3 once per round, B1 once per local step,
   finite losses, and the checkpoint, status log and ``Quantization
   Thresh.`` records.  ``dga_profile`` as ``profile``, plus the share of
   the device time the quantile's sort takes; ``dga_learns``: 3 rounds
   with local and global DP off, whose val loss must fall (DP's noise
   swamps the ``dga`` phase's updates); ``dga_cross_device``: 2 rounds
   of 2 clients of 2 local steps with local DP off (``torch.randn`` draws other numbers on
   the two devices) and global DP and quantization on, twice on ``cuda``
   and once on ``cpu``: the cuda runs are bitwise equal and agree with the
   cpu run within ``DGA_CROSS_TOL``.
5. ``ringlm`` — FedAvg RingLM through the CLI on ``cuda``:
   ``experiments/ringlm/config.yaml`` at its published widths (vocab 90
   chars, embed 128, 4 heads of 32, mlp 512, 4 layers, seq_len 1024;
   P = 945,370; 10 clients a round, client SGD lr 0.1 at batch 4, server
   SGD lr 1.0) plus ``flash_attention`` (B4-B6) and ``pallas_apply`` (B1),
   5 rounds, on a synthetic long-text blob (500 train users with 4-24
   documents of 1,100 chars, 50 val and 50 test users).  Asserts B4
   launched 4 x (local steps + eval steps), B5 and B6 4 x local steps, B1
   once a local step, finite losses, the checkpoint and status log, and a
   val loss that falls.  ``ringlm_profile`` as ``profile``;
   ``ringlm_flash_vs_dense``: 2 rounds with flash on and off, the updates
   within ``RINGLM_FLASH_DENSE_TOL``; ``ringlm_cross_device``: 2 rounds of
   one client of one local step, twice on ``cuda`` (bitwise equal) and
   once on ``cpu`` (within ``RINGLM_CROSS_TOL``).
   ``ringlm_bf16`` — the same config at its published widths with
   ``dtype: bfloat16``, 3 rounds: B4-B6's bf16 arms launched 4 x (local
   + eval steps) and 4 x local steps, B1 once a local step (its f32 arm:
   the params stay f32), a val loss that falls; ``ringlm_bf16_profile``
   (2 rounds each way, beside the f32 ``ringlm_profile`` of this call);
   ``ringlm_bf16_flash_vs_dense`` within ``RINGLM16_FLASH_DENSE_TOL``;
   ``ringlm_bf16_cross_device`` (one round of one client of one step;
   two cuda runs bitwise, cpu within
   ``RINGLM16_CROSS_TOL``); ``ringlm_f16``, one round of 2 clients in
   float16 for the f16 arms.  ``precision`` — the ``main`` config with
   ``dtype: bfloat16`` and ``precision: {params: bfloat16, compute:
   bfloat16}``, 3 rounds: B1's bf16 arm once a local step;
   ``precision_cross_device`` (``PRECISION_CROSS_TOL``); an absent and an
   explicit float32 policy bitwise equal on the card; a float16 leg of one
   round for B1's f16 arm.  ``dtype`` — LR, CIFAR_CNN, ResNet-18-GN and
   the LSTM at their shipped widths in bf16, 2 rounds, twice, bitwise,
   secs/round beside the same config in f32.  ``optimizers`` — LR through
   server lamb, lars and yogi, client SGD with nesterov and weight decay,
   the rampup schedule, ``freeze_layer`` and server replay with
   ``updatable_names``: each twice on cuda (bitwise) and once on cpu
   (``OPT_CROSS_TOL``).
6. ``resnet`` — FedAvg ResNet-18-GN through the CLI on ``cuda``:
   ``experiments/cv_resnet_fedcifar100/config.yaml`` at its published
   widths (100 classes, 16 channels a group, 32x32x3; P = 11,227,812; 10
   clients a round at batch 20, client SGD lr 0.1, server SGD lr 1.0) plus
   ``pallas_apply`` (B1), 5 rounds, a checkpoint every round, on a
   synthetic Fed-CIFAR-100-shaped blob (100 train clients of 100 images, 10
   val and 10 test clients).  ``shakespeare`` — the same for
   ``experiments/nlp_rnn_fedshakespeare/config.yaml`` (the 2-layer LSTM,
   vocab 90, embed 8, hidden 256, 80 chars; P = 820,522; 10 clients at
   batch 4, client SGD lr 0.8) on a synthetic blob of fed_shakespeare's 715
   clients.  Each asserts B1 launched once a local step and no other
   kernel, finite losses, a train loss that falls (the mean loss over the
   first 50 clients' data, initial against final weights), ``latest`` at
   round 5 and its ``.prev`` slot at round 4 equal to that round's backup,
   and the status log; ``resnet_profile`` / ``shakespeare_profile`` as
   ``profile`` (the latter over one round each way);
   ``resnet_cross_device`` / ``shakespeare_cross_device``: 2 rounds of 2
   clients, one local step each, twice on ``cuda`` (bitwise equal) and
   once on ``cpu`` (within ``FEDAVG_CROSS_TOL``).

7. ``hello_mlp`` — ``experiments/hello_mlp/config.yaml`` as shipped (12
   rounds of 8 clients) through the ``model_folder`` plugin loader (the
   port's twin of the folder's ``task.py``, the folder's ``config.py``
   defaults merged: P = 1,283) plus ``pallas_apply``, on a generated blob
   of 200 users of 16-dim points of 3 classes: B1 once a local step,
   ``top2_acc`` logged, the val accuracy above chance.
   ``personalization`` — ``experiments/cv/config.yaml`` at its widths
   (ResNet-18-GN, 10 classes, 32x32x3, P = 11,181,642; 10 clients at batch
   32, client SGD lr 0.01 with momentum 0.9, server SGD 1.0) plus
   ``pallas_apply``, 5 rounds with the personalized eval every round, on
   a generated CIFAR-10-shaped blob (100 train clients of 100 images, 10
   val, 10 test): B1 3 x S a round (the round and the personal pass's two
   client updates), finite losses, stored alphas inside [1e-4, 0.9999]
   and moved from 0.75, the store's files, and 2 rounds then a resume for
   3 more equal to the 5 rounds bit for bit (global params, every local
   model, every alpha).  ``personalization_profile`` as ``profile`` over
   whole rounds (personal pass, packing, round), plus the host time of the
   store's moves and its disk write; ``cross_device_personalization``: 2
   rounds of 2 clients, one step a client update, held as the other
   ``*_cross_device`` phases and with the stored local models and alphas.
   ``fedlabels`` — ``experiments/semisupervision/config.yaml`` at its
   widths (CIFAR_CNN, batch 64, ``eta`` 0.01, RandAugment's ``ux_rand``
   under ``uda: 1`` at 2 ops of magnitude 9) plus ``pallas_apply``, 5
   rounds with ``burnout_round`` cut from 30 to 1, on a generated blob of
   100 clients of 96 labeled and 96 unlabeled images: B1 once a supervised
   local step, a val loss that falls; ``cross_device_fedlabels``: 2 rounds
   of 2 clients.

8. ``ecg`` — ``experiments/ecg_cnn/config.yaml`` as shipped (ECG_CNN,
   P = 136,709; 10 clients at batch 32, client and server adam), 5
   rounds, on a generated blob of 100 clients of 50-300 beats of 187
   frames and 5 classes (10 val, 10 test): no port kernel on the path
   (client adam has none), finite losses, a train loss that falls.
   ``fednewsrec`` — ``experiments/fednewsrec/config.yaml`` as shipped
   (NRMS, P = 13,320,802; client adam, server SGD, batch 16), 5 rounds,
   on generated MIND-shaped users (200 train, 30 val, 30 test): no port
   kernel, AUC / MRR / nDCG in [0, 1].  ``mlm_bert`` —
   ``experiments/mlm_bert/config.yaml`` at BERT-base
   (``model_axis_size: 1``; P = 109,514,298 in 202 leaves; DGA, local
   DP, quantization, the privacy metrics; 10 clients of batch 16 and 64
   samples), 3 rounds, on Reddit-shaped token rows of at most 128
   tokens: B3 once a round and no other kernel, an extraction overlap of
   1.0 every round (the attack reads ``position_embeddings``) and no
   leakage metric.  ``mlm_bert_profile`` as ``profile``;
   ``mlm_bert_learns``: 2 rounds with local DP off, the val loss falls;
   ``ecg_cross_device``, ``fednewsrec_cross_device`` and
   ``mlm_bert_cross_device`` (``reduced``: 2 of BERT-base's 12 layers,
   premasked rows, dropout 0 and local DP off, as their draws differ
   between the devices, and the privacy metrics off): 2 rounds of 2
   clients (mlm_bert's one), one step each.  B3 is
   also held bitwise to its plain version at the mlm_bert shape
   ``[10, 109,514,298]`` (full P, the real 202-leaf table) and timed
   there (the ``kernel`` phase's second B3 line).

9. ``strategies`` — ``main``'s CNN_FEMNIST config (P = 1,206,590, 10
   clients at batch 20, the 350 writers, ``pallas_apply``) through the CLI
   under q-FFL, FedAC, FedBuff (``max_staleness: 4``), SCAFFOLD on the host
   store and on the ``[350, P]`` device table, and EF quantization (4
   bits) on the host store and on the device table, 3 rounds a leg: B1
   once a local step, B3 once a round on the EF legs (one leaf a client
   row) and no other kernel, finite losses, the round markers; each store
   leg again cut after round 2 and resumed to 3, its params and rows
   bitwise those of the uninterrupted leg.
   ``strategies_cross_device_*``: each strategy's leg at 4 clients, 2
   rounds, dropout off, twice on ``cuda`` (bitwise) and once on ``cpu``
   (``STRATEGY_CROSS_TOL``, SCAFFOLD's ``c`` too; EF's ``EF_CROSS_TOL``).  ``rl`` — ``dga``'s
   config with ``wantRL: true`` (local DP off), 3 rounds: rewards, the
   kept candidate each round, B1 once a local step, B3 once a round, no
   B2 (the RL round never calls the strategy's combine).
   ``classif_cnn`` — ``experiments/classif_cnn/config.yaml`` (CIFAR_CNN,
   ``f1_score``) plus ``pallas_apply``, 3 rounds on generated hdf5 blobs
   (their JSON twin where ``h5py`` is missing; the line says which): B1
   once a local step, ``Val f1_score`` logged.

10. ``fused_carry`` — last: ``server_config.fused_carry`` on four legs,
   SCAFFOLD and EF on the strategies legs' config, FedAvg with ``wantRL``
   on ``main``'s, and personalization's carry on ``experiments/cv``
   (ResNet-18-GN, 100 users): 2 rounds at ``pipeline_depth`` 2 (the ring
   overlapping), B1 once a local step (twice under personalization), B3
   once a round on EF, no other kernel, no synchronizing call in a
   round's dispatch half; the second round again at depth 0 from the
   first's ``latest`` slot, its params and ``strategy_state`` bitwise the
   depth-2 run's; SCAFFOLD and EF bitwise their host device-table legs at
   round 2.  A line a leg (``fused_carry_<leg>``): per depth the loop's
   secs/round, busy and idle, each ``latest`` save's bytes and seconds
   (the tables ride it), the pinned snapshots' peak, the disk writes.
   Every phase line carries ``io_write_gb``, the run's writes so far.

11. ``resilience`` — ``main``'s config through the CLI: the preemption
   drill and a real SIGTERM (exit 75, each resumed bitwise), checkpoint
   IO faults and escalation, local DP under FedAC / FedBuff / EF,
   chunked clients and the norm dumps.

12. ``model_options`` — last, a line a leg (``model_options_<leg>``):
   ``ringlm_remat`` (``experiments/ringlm`` at its widths, K = 10, one
   round with ``remat`` on and one off from one state and cohort: params
   bitwise, or within ``CROSS_TOL[1]`` with the gap reported; B4 twice a
   layer a local step under remat, once without, B5 and B6 once; each
   way's peak allocated memory), ``ringlm_moe`` (4 experts, 2 rounds twice
   on cuda, bitwise; B4-B6 once a layer a step; cuda against cpu at one
   layer and K = 2 within ``CROSS_TOL[1]``), ``flash_auto`` (one layer,
   K = 2, batch 1, one step: B4-B6 at 4,096 tokens, none at 1,023),
   ``bert_gathered`` (BERT-base under DGA with local DP and quantization,
   one round with the full head and one with the gathered head from one
   state and cohort: train losses within ``CROSS_TOL[1]``, B3 once a round,
   device busy ms and peak allocated memory each way), ``bert_bf16`` (one
   round in bfloat16: a finite loss, B3 once), ``fednewsrec_ref``
   (``experiments/fednewsrec`` with ``arch: fednewsrec`` through the CLI,
   one round: finite, no kernel, the frozen table bitwise its numpy
   draw), ``pretrained`` (``main``'s config warm-started from ``main``'s
   ``latest_model.pt``: the warm params bitwise, the round-0 val bitwise
   ``main``'s final model's, B1 once a local step) and ``eval_outputs``
   (``wantLogits`` and ``per_user_stats`` on ``main``'s val: a row a real
   sample, the six per-user metrics).  The RingLM and BERT legs drive
   ``engine.run_round`` and write no checkpoint.
13. ``throughput`` — cohort bucketing and megabatching through
   ``OptimizationServer.train`` (``throughput_<leg>`` lines).
14. ``data_planes`` — last, through ``OptimizationServer.train``, a line a
   leg (``data_planes_<leg>``): ``pool`` (``main``'s config, 3 rounds at
   depth 1 on an in-memory pool of 350 writers of 50-300 samples,
   host-packed and then with ``device_resident: true``: params bitwise, B1
   launches equal and B1 bitwise its plain version at ``[10, P]``, each
   arm's ``hostToDeviceBytesPerRound`` equal to the count of a CPU server
   packing the same chunks, ``secsPerRoundPack`` / ``Stage`` /
   ``secsPerRound``, the pool's bytes and upload seconds, peak allocated
   memory), ``pool_chunked`` (``rounds_per_step: 3``, ``clients_per_chunk:
   5``: bitwise, B1 once a chunk a local step), ``pool_bucketed``
   (``throughput``'s 200-writer log-uniform pool at ``max_buckets: 4``:
   bitwise, the grids' widths equal in both arms) and ``length``
   (``experiments/nlg_gru``'s DGA with global DP and quantization on 1,000
   users of 3-12-word sentences against ``max_num_words: 25``, 3 serial
   rounds with ``length_bucketing`` on and off: the bucket, the padding
   efficiency before and after, the params' relative L2 under
   ``LENGTH_REL_L2``, B2 and B3 once a round, held to their plain
   versions, secs/round each way).
15. ``fleet_traffic`` — last, through ``OptimizationServer.train`` on
   ``data_planes``' in-memory 350-writer pool, a line a leg
   (``fleet_traffic_<leg>``): ``no_traffic`` (FedBuff, ``max_staleness:
   4``, on ``main``'s CNN_FEMNIST config, 3 rounds at depth 1: the same
   call's yardstick), ``buffered`` (the same under ``traffic: {mode:
   buffered, trace: poisson, buffer_size: 10}`` with ``do_profiling``: B1
   once a local step and bitwise its plain version at ``[10, P]``, one
   ``buffer_fired`` record a round, each round's staleness histogram and
   sum equal to a host replay of the schedule's fires, a second cuda run
   bitwise, the profiled chunk's ``torch.profiler`` trace holding B1),
   ``sync`` (no staleness operand, every fire's staleness 0),
   ``fleet_sampling`` (FedAvg under ``fleet.sampling`` ``floyd`` and
   ``by_samples``: each cohort the host's ``sample_cohort`` draw) and
   ``million`` (a 10^6-user ``SyntheticFleetDataset`` under LR, 2 rounds
   with ``floyd``: the server's set-up seconds, the metadata bytes).
   secs/round of each leg beside ``no_traffic``'s, with the card's name
   and power limit.  The ``resilience`` and ``defense`` phases also hold
   the event records to their counters: one ``ckpt_io_fault`` a fault,
   the drill's ``preemption`` and ``preempted_exit``, a ``chaos_faults``
   and a ``quarantine`` record for each round whose counters say so.

The line before the last is the ``kernels`` table (launches on each path,
``max_abs_err``, ``ms``, ``plain_ms``, ``bound_ms``, ``library_ms``), the
16-bit arms' rows after the float32 ones (each launched on a path of the
run, or the script fails); the last line is ``{"ok": true, "device":
{...}}``.
"""

from __future__ import annotations

import ctypes
import json
import math
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))

#: H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): HBM3 bytes/s
#: and float32 (non-tensor-core) FLOP/s
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
#: int32 operations/s: 64 int32 lanes per SM per clock (half the 128
#: float32 lanes, with no fused multiply-add to count twice), so a quarter
#: of the float32 FLOP/s figure
PEAK_INT32_OPS = PEAK_F32_FLOPS / 4

#: the main path's kernel shape: K = 10 clients x P = CNN_FEMNIST params
MAIN_K, MAIN_P = 10, 1_206_590
#: the DGA path's: K = 10 clients x P = the nlg_gru GRU LM's params
DGA_K, DGA_P = 10, 2_727_184
#: the RingLM path's: K = 10 clients x P = RingLM's params
RINGLM_P = 945_370
#: the ResNet path's: P = ResNet-18-GN at Fed-CIFAR-100's widths
RESNET_P = 11_227_812
#: the Shakespeare path's: P = the 2-layer LSTM at its published widths
LSTM_P = 820_522
#: the personalization path's: ResNet-18-GN at 10 classes (experiments/cv)
RESNET10_P = 11_181_642
#: the FedLabels path's: CIFAR_CNN (experiments/semisupervision)
CIFAR_CNN_P = 319_178
#: the hello_mlp plugin's MLP at its merged default widths (16, 64, 3)
HELLO_P = 1_283
#: B2's int32 work per element: half a Philox-4x32-10 call (10 rounds of
#: two mul.lo, two mul.hi and four xors).  The round keys depend on the
#: seed alone, the same for every element, so they are not counted.
PHILOX_INT_OPS_PER_ELEMENT = 10 * 8 / 2

CNN_CONFIG = {
    "model_config": {"model_type": "CNN", "num_classes": 62,
                     "image_size": 28},
    "strategy": "fedavg",
    "server_config": {
        "max_iteration": 5,
        "num_clients_per_iteration": 10,
        "initial_lr_client": 0.1,
        "val_freq": 2,
        "rec_freq": 5,
        "initial_val": True,
        "best_model_criterion": "acc",
        "model_backup_freq": 500,
        "rounds_per_step": 25,
        "optimizer_config": {"type": "sgd", "lr": 1.0},
        "megakernel": {"pallas_apply": True},
        "data_config": {
            "val": {"batch_size": 2048, "val_data": "femnist/val.json"},
            "test": {"batch_size": 2048, "test_data": "femnist/test.json"}},
    },
    "client_config": {
        "optimizer_config": {"type": "sgd", "lr": 0.1},
        "data_config": {"train": {"batch_size": 20,
                                  "list_of_train_data":
                                      "femnist/train.json"}},
    },
}


#: when the script started: each phase line carries its seconds since
#: (``t``) and its own seconds (``phase_seconds``, since the line before)
_START = time.time()
_LAST_LINE = [_START]


def io_write_bytes() -> int:
    """Bytes this process has handed to ``write`` calls so far (``wchar``
    of ``/proc/self/io``: the machine's storage layer does not count
    ``write_bytes``; 0 where the file is missing)."""
    try:
        with open("/proc/self/io") as fh:
            for line in fh:
                if line.startswith("wchar:"):
                    return int(line.split()[1])
    except OSError:
        pass
    return 0


def emit(record: dict) -> None:
    if "phase" in record:
        now = time.time()
        # the machine stops a command past 45 GiB of disk writes: each
        # line carries the run's total so far
        record = {**record, "t": round(now - _START, 1),
                  "phase_seconds": round(now - _LAST_LINE[0], 1),
                  "io_write_gb": round(io_write_bytes() / 1e9, 3)}
        _LAST_LINE[0] = now
    print(json.dumps(record), flush=True)


class PhaseFailed(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise PhaseFailed(what)


# ----------------------------------------------------------------------
def phase_env(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else ""
    check(bool(card), f"nvidia-smi failed: {smi.stderr.strip()}")
    print(card, flush=True)
    CARD["name_power"] = card
    emit({"phase": "env", "ok": True, "card": card,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0],
          "device_count": torch.cuda.device_count()})
    return card


#: the card's name and power limit as ``nvidia-smi`` gives them
#: (:func:`phase_env`), for the phases that print it beside their times
CARD = {}


#: each source's compiler output, kept by :func:`phase_build` for the phases
#: that report ``ptxas`` figures ("cached" where the library was built
#: before)
BUILD_LOGS = {}


def _template_name(mangled):
    """A template instantiation's name as the source writes it
    (``flash_dq_kernel<32>``, ``flash_fwd_tc_kernel<32, bfloat16>``) from
    its mangled name; any other name as it is."""
    import re
    inst = re.search(r"\d([a-z_]+)ILi(\d+)E(f|13__nv_bfloat16|6__half)?EE",
                     mangled)
    if not inst:
        return mangled
    arm = {"13__nv_bfloat16": ", bfloat16",
           "6__half": ", float16"}.get(inst.group(3), "")
    return f"{inst.group(1)}<{inst.group(2)}{arm}>"


def ptxas_reports(log):
    """What ``ptxas -v`` says of each entry function of a build log:
    ``{name: {"registers", "spill_store_bytes", "spill_load_bytes"}}``.  A
    template instantiation is named as in the source
    (``flash_dq_kernel<32>``), any other entry by its mangled name."""
    import re
    reports, name = {}, None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
        regs = re.search(r"Used (\d+) registers", line)
        if entry:
            name = _template_name(entry.group(1))
            reports[name] = {}
        elif name and spill and "spill_store_bytes" not in reports[name]:
            reports[name].update(spill_store_bytes=int(spill.group(1)),
                                 spill_load_bytes=int(spill.group(2)))
        elif name and regs:
            reports[name]["registers"] = int(regs.group(1))
    return reports


def phase_build():
    from msrflute_tpu_torch.ops import _build
    sources = sorted(f[:-3] for f in os.listdir(_build.CSRC_DIR)
                     if f.endswith(".cu"))
    tic = time.time()
    logs = _build.build(sources)
    BUILD_LOGS.update(logs)
    from msrflute_tpu_torch.ops import KERNELS
    arms = {name: sorted(getattr(w, "launches_by_dtype", {"float32": 0}))
            for name, w in KERNELS.items()}
    emit({"phase": "build", "ok": True, "kernels": sources,
          "arms": arms, "seconds": round(time.time() - tic, 3),
          "ptxas": {k: ptxas_reports(v) for k, v in logs.items()}})


#: B1's cases: (K, P, per-row gate, offsets).  Each of p, g and m is a
#: contiguous [K, P] view that starts offsets[i] floats into a buffer of its
#: own with a guard float past its end, so row k of a tensor starts
#: offsets[i] + k * P floats (mod 4) past a 16-byte boundary
SGD_CASES = [
    # the paths' shapes, mixed gates (a NaN gate pins too) and all live
    (MAIN_K, MAIN_P, [1, 0, 1, -1, 1, 1, 0, 1, 1, 1], (0, 0, 0)),
    (MAIN_K, MAIN_P, [1] * MAIN_K, (0, 0, 0)),
    (DGA_K, DGA_P, [1, 1, 0, 1, 1, 1, 1, -1, 1, 1], (0, 0, 0)),
    (MAIN_K, RINGLM_P, [1, 1, 1, 0, 1, float("nan"), 1, 1, 0, 1],
     (0, 0, 0)),
    (MAIN_K, RESNET_P, [1, 1, 0, 1, 1, 1, 1, 1, -1, 1], (0, 0, 0)),
    (MAIN_K, LSTM_P, [0, 1, 1, 1, 1, 1, 1, 1, 1, 0], (0, 0, 0)),
    (MAIN_K, RESNET10_P, [1, 0, 1, 1, 1, 1, -1, 1, 1, 1], (0, 0, 0)),
    (MAIN_K, CIFAR_CNN_P, [1, 1, 1, 1, 0, 1, 1, 1, float("nan"), 1],
     (0, 0, 0)),
    (8, HELLO_P, [1, 1, 0, 1, 1, 1, 1, 1], (0, 0, 0)),
    # odd P: rows at all four residues mod 4, also under an offset base
    (4, 127, [0, 1, -2, 1], (0, 0, 0)),
    (4, 1_000_003, [1, 1, 1, 1], (1, 1, 1)),
    (5, 1000, [1, 1, 0, 1, 1], (0, 0, 0)),
    (2, 1_048_579, [1, 0], (0, 0, 0)),
    # one tensor off the others' residue: those rows run scalar
    (6, 4_099, [1, 1, 0, 1, 1, 1], (1, 0, 0)),
    (5, 4_097, [1, 1, 1, 1, 0], (0, 3, 0)),
    (4, 2_001, [1, 1, 1, 1], (0, 0, 2)),
    # rows shorter than one vector
    (3, 1, [1, 0, 1], (0, 0, 0)),
    (4, 3, [1, 1, 1, 1], (1, 1, 1)),
    (5, 2, [1, 0, 1, 1, 1], (2, 2, 2)),
]


def _sgd_inputs(torch, K, P, gate, seed, offsets=(0, 0, 0), dtype=None):
    """p, g, m as views ``offsets`` elements into buffers one guard element
    longer than they need (of ``dtype``, float32 by default), the buffers,
    and the gate."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    bufs = [torch.randn(K * P + off + 1, generator=gen,
                        device="cuda").to(dtype or torch.float32)
            for off in offsets]
    p, g, m = (b[off:off + K * P].view(K, P)
               for b, off in zip(bufs, offsets))
    return p, g, m, torch.tensor(gate, dtype=torch.float32,
                                 device="cuda"), bufs


def _time_ms(torch, fn, iters=50, warmup=5):
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


#: the buffer :func:`_device_ms` reads between launches, and the names of
#: the kernels that read it
_FLUSH = {}


def _flush_l2(torch):
    """Read a buffer of twice the card's L2 size: the next launch finds its
    data in device memory, not in L2.  A read, so no dirty line of the
    flush is left for the next launch to write back."""
    if "buf" not in _FLUSH:
        l2 = torch.cuda.get_device_properties(0).L2_cache_size
        _FLUSH["buf"] = torch.ones(max(2 * l2, 1 << 20) // 4, device="cuda")
    _FLUSH["buf"].sum(dtype=torch.float64)


def _cuda_events(torch, prof):
    """The device's kernels and copies of a profiler run, by start time:
    ``[(start_us, name, duration_us)]``."""
    from torch.autograd import DeviceType
    return sorted((e.time_range.start, e.name, e.time_range.elapsed_us())
                  for e in prof.events() if e.device_type == DeviceType.CUDA)


def _per_call_us(events, flush_names):
    """Device time of each call between flushes: ``events`` in start order
    as ``(start, name, duration)``, a flush one or more events named in
    ``flush_names``; what follows a flush, up to the next, is one call's,
    summed.  Events before the first flush are not counted."""
    calls, flushing = [], False
    for _, name, us in events:
        if name in flush_names:
            if not flushing:          # a flush may run several kernels
                calls.append(0.0)
            flushing = True
        elif calls:
            calls[-1] += us
            flushing = False
    return calls


def _device_ms(torch, fn, launches=200, lead=20):
    """Median device time of one call of ``fn``: each call's own kernels
    (summed where it runs several) as ``torch.profiler`` (CUPTI) records
    them, over the last ``launches`` of ``lead + launches`` calls, with L2
    evicted before each (:func:`_flush_l2`, whose kernels are not counted).
    The tracer may miss the first calls after it starts (an H100 run saw 13
    of 200 go unrecorded), hence the ``lead``; it has also dropped a single
    event in the middle of a window (one run in many), so a window that
    fails the check is traced once more, and the second must pass it.
    Host time between launches does not enter, as it does in
    :func:`_time_ms`."""
    import statistics
    from torch.profiler import ProfilerActivity, profile
    if "names" not in _FLUSH:
        _flush_l2(torch)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(lead):
                _flush_l2(torch)
            torch.cuda.synchronize()
        _FLUSH["names"] = {n for _, n, _ in _cuda_events(torch, prof)}
        check(bool(_FLUSH["names"]), "the profiler saw no device activity")
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for attempt in range(2):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(lead + launches):
                _flush_l2(torch)
                fn()
            torch.cuda.synchronize()
        calls = _per_call_us(_cuda_events(torch, prof), _FLUSH["names"])
        # fewer flushes than calls: the tracer missed some; more: a call
        # ran a kernel named like the flush's and was split, and its parts
        # would read as calls too short
        whole = (launches <= len(calls) <= lead + launches
                 and min(calls[-launches:]) > 0)
        if whole:
            break
    check(whole, f"device timing: {len(calls)} flushes recorded for "
                 f"{lead + launches} calls, "
                 f"{sum(c == 0 for c in calls)} calls with no kernel of "
                 "their own (twice)")
    return statistics.median(calls[-launches:]) / 1e3


def _under_load(torch, fn, seconds=2.0):
    """The card's SM clock and power draw while ``fn`` runs back to back:
    the lowest clock and the highest draw among ``nvidia-smi``'s samples of
    the window's second half (the draw takes a second to rise)."""
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        tic = time.time()
        while time.time() - tic < seconds:
            for _ in range(50):
                fn()
            torch.cuda.synchronize()
    finally:
        smi.terminate()
        out, _ = smi.communicate(timeout=60)
    rows = []
    for line in out.splitlines():
        try:
            clock, power = (float(x) for x in line.split(","))
        except ValueError:
            continue
        rows.append((clock, power))
    rows = rows[len(rows) // 2:]
    if not rows:
        return None
    return {"sm_clock_mhz_min": min(r[0] for r in rows),
            "power_draw_w_max": max(r[1] for r in rows),
            "samples": len(rows)}


def _sgd_cases(torch, dtype=None):
    """B1 against its plain version on every case of ``SGD_CASES`` in
    ``dtype`` buffers (float32 by default): bitwise, gated rows and the
    elements around each view untouched, g unwritten.  Returns the largest
    error at the paths' shapes."""
    from msrflute_tpu_torch.ops.fused_sgd import (fused_sgd_apply,
                                                  fused_sgd_plain)
    lr, max_err = 0.1, 0.0
    arm = "" if dtype is None else f" {dtype}"
    for K, P, gate, offsets in SGD_CASES:
        for mu in (0.0, 0.9):
            p, g, m, gt, bufs = _sgd_inputs(torch, K, P, gate, K * 7 + P,
                                            offsets, dtype)
            before = [b.clone() for b in bufs]
            pp, pm = p.clone(), m.clone()
            fused_sgd_plain(pp, g, pm, lr, mu, gt)
            fused_sgd_apply(p, g, m, lr, mu, gt)
            torch.cuda.synchronize()
            err = max(float((p.float() - pp.float()).abs().max()),
                      float((m.float() - pm.float()).abs().max()))
            if K == MAIN_K and P in (MAIN_P, DGA_P, RESNET_P, LSTM_P,
                                     RESNET10_P, CIFAR_CNN_P):
                max_err = max(max_err, err)
            what = f"fused_sgd{arm} [{K}, {P}] offsets {offsets} mu={mu}"
            check(torch.equal(p, pp) and torch.equal(m, pm),
                  f"{what}: kernel != plain (max abs err {err})")
            p0, m0 = (before[i][off:off + K * P].view(K, P)
                      for i, off in ((0, offsets[0]), (2, offsets[2])))
            dead = [k for k, v in enumerate(gate) if not v > 0]
            check(all(torch.equal(p[k], p0[k]) and torch.equal(m[k], m0[k])
                      for k in dead), f"{what}: gated rows were written")
            # the elements around each view, and all of g, are untouched
            for b, b0, off in zip(bufs, before, offsets):
                check(torch.equal(b[:off], b0[:off]) and
                      torch.equal(b[off + K * P:], b0[off + K * P:]),
                      f"{what}: a write outside the view")
            check(torch.equal(bufs[1], before[1]), f"{what}: g was written")
    return max_err


def phase_kernel(torch):
    """B1 against its plain version: bitwise, then timed."""
    from msrflute_tpu_torch.ops.fused_sgd import (fused_sgd_apply,
                                                  fused_sgd_plain)
    lr = 0.1
    max_err = _sgd_cases(torch)

    # timing at each path's shape, every row live (the library call has
    # no per-row gate)
    mu = 0.9
    timed = {}
    for path, K, P in (("cnn", MAIN_K, MAIN_P), ("dga", DGA_K, DGA_P),
                       ("resnet", MAIN_K, RESNET_P),
                       ("shakespeare", MAIN_K, LSTM_P),
                       ("resnet10", MAIN_K, RESNET10_P),
                       ("cifar_cnn", MAIN_K, CIFAR_CNN_P)):
        p, g, m, gt, _ = _sgd_inputs(torch, K, P, [1] * K, seed=1)
        kernel = lambda: fused_sgd_apply(p, g, m, lr, mu, gt)  # noqa: E731
        library = lambda: torch._fused_sgd_(  # noqa: E731
            [p], [g], [m], weight_decay=0.0, momentum=mu, lr=lr,
            dampening=0.0, nesterov=False, maximize=False,
            is_first_step=False)
        kernel_ms = _device_ms(torch, kernel)
        plain_ms = _time_ms(torch, lambda: fused_sgd_plain(p, g, m, lr, mu,
                                                           gt))
        library_ms = _device_ms(torch, library)
        kernel_ms_2 = _device_ms(torch, kernel)
        n = K * P
        nbytes = 20 * n + 4 * K           # read p, g, m, gate; write p, m
        bound_ms = max(nbytes / PEAK_BYTES_PER_S,
                       4 * n / PEAK_F32_FLOPS) * 1e3
        timed[path] = {
            "shape": [K, P], "ms": kernel_ms, "ms_repeat": kernel_ms_2,
            "ms_host_paced": _time_ms(torch, kernel),
            "plain_ms": plain_ms, "library_ms": library_ms,
            "library_ms_host_paced": _time_ms(torch, library),
            "bound_ms": bound_ms, "bytes": nbytes,
            "share_of_bound": bound_ms / kernel_ms,
            "achieved_gb_s": nbytes / (kernel_ms * 1e-3) / 1e9,
            "library_gb_s": nbytes / (library_ms * 1e-3) / 1e9,
            "card_under_kernel": _under_load(torch, kernel)}
        del p, g, m
    cnn = timed["cnn"]
    row = {"name": "fused_sgd_apply", "route": "cuda",
           "source": "msrflute_tpu_torch/csrc/fused_sgd.cu",
           "replaces": "msrflute_tpu/ops/pallas_kernels.py:212",
           "launches": None, "max_abs_err": max_err,
           "ms": cnn["ms"], "ms_host_paced": cnn["ms_host_paced"],
           "plain_ms": cnn["plain_ms"],
           "bound_ms": cnn["bound_ms"], "bound_by": "bytes",
           "library_ms": cnn["library_ms"],
           **{f"at_{path}_shape": {k: timed[path][k] for k in
                                   ("shape", "ms", "ms_host_paced",
                                    "plain_ms", "bound_ms", "library_ms")}
              for path in ("dga", "resnet", "shakespeare", "resnet10",
                           "cifar_cnn")}}
    emit({"phase": "kernel", "ok": True, "name": "fused_sgd_apply",
          "cases": len(SGD_CASES) * 2, "bitwise": True, **timed})
    return row


def _ulps(torch, a, b):
    """Largest distance in float32 units in the last place between two
    tensors of finite values (0 = bitwise equal)."""
    ia, ib = a.view(torch.int32).long(), b.view(torch.int32).long()
    # map the sign-magnitude bit patterns onto one monotone integer line
    ia = torch.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = torch.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return int((ia - ib).abs().max()) if a.numel() else 0


#: Random123's kat_vectors for philox4x32 with 10 rounds
PHILOX_KAT = [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


def _philox_check(torch):
    """cuRAND's Philox and the plain PyTorch version's (whose bits B2's
    normals are held to) on the known answers and 4,096 random (counter,
    key) pairs: bitwise equal."""
    import ctypes
    from msrflute_tpu_torch.ops import _build
    from msrflute_tpu_torch.ops import gaussian_noise as gn
    gen = torch.Generator(device="cuda").manual_seed(5)
    n = 4096
    ctr = torch.randint(-2**31, 2**31, (n, 4), dtype=torch.int32,
                        device="cuda", generator=gen)
    key = torch.randint(-2**31, 2**31, (n, 2), dtype=torch.int32,
                        device="cuda", generator=gen)
    signed = lambda v: v - (1 << 32) if v >= (1 << 31) else v  # noqa: E731
    for i, (c, k, _) in enumerate(PHILOX_KAT):
        ctr[i] = torch.tensor([signed(v) for v in c], dtype=torch.int32)
        key[i] = torch.tensor([signed(v) for v in k], dtype=torch.int32)
    lib = _build.load("philox_check")
    lib.curand_philox_launch.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_longlong, ctypes.c_void_p]
    lib.curand_philox_launch.restype = ctypes.c_int
    curand = torch.empty_like(ctr)
    code = lib.curand_philox_launch(
        ctr.data_ptr(), key.data_ptr(), curand.data_ptr(), n,
        torch.cuda.current_stream().cuda_stream)
    check(code == 0, f"curand_philox_launch returned {code}")
    u = lambda t: t.long() & 0xFFFFFFFF  # noqa: E731
    words = gn.philox4x32_10(tuple(u(ctr[:, j]) for j in range(4)),
                             (u(key[:, 0]), u(key[:, 1])))
    plain = torch.stack(words, dim=1)
    torch.cuda.synchronize()
    check(torch.equal(plain, u(curand)),
          "the plain PyTorch Philox differs from curand_Philox4x32_10")
    for i, (_, _, want) in enumerate(PHILOX_KAT):
        check(tuple(u(curand[i]).tolist()) == want,
              f"Philox known answer {i} differs")
    return n


def _normal_stats(torch, z):
    """The bounds of tests/test_pallas_kernels.py::
    test_bits_to_normal_statistics, on a float32 CUDA tensor."""
    z = z.double()
    m = float(z.mean())
    sd = float(z.std(unbiased=False))
    zc = z - m
    skew = float((zc ** 3).mean())
    kurt = float((zc ** 4).mean())
    tail = float((z.abs() > 3.0).double().mean())
    stats = {"mean": m, "std": sd, "skew": skew, "kurtosis": kurt,
             "tail_3sigma": tail}
    check(bool(torch.isfinite(z).all()), "non-finite noise")
    check(abs(m) < 5e-3 and abs(sd - 1.0) < 5e-3 and abs(skew) < 2e-2
          and abs(kurt - 3.0) < 5e-2 and abs(tail - 0.0027) < 5e-4,
          f"noise moments out of bounds: {stats}")
    return stats


def _corr(torch, a, b):
    a, b = a.double() - a.double().mean(), b.double() - b.double().mean()
    return float((a * b).mean() / (a.std(unbiased=False)
                                   * b.std(unbiased=False)))


def phase_kernel_noise(torch):
    """B2 against its plain version, the plain Philox against cuRAND, and
    the statistics of its output; then timed at the DGA shape."""
    from msrflute_tpu_torch.ops.gaussian_noise import (fused_gaussian_noise,
                                                       gaussian_noise_plain)
    pairs = _philox_check(torch)
    gen = torch.Generator(device="cuda").manual_seed(7)
    # normals alone (x = 0, scale 1, sigma 1): out == z exactly
    max_ulp = 0
    for n, seed in ((DGA_P, 11), (1, 1), (2, 2), (3, 3), (1023, 4),
                    (1_000_001, 2**40 + 5)):
        x = torch.zeros(n, device="cuda")
        k = fused_gaussian_noise(x, 1.0, 1.0, seed)
        pz = gaussian_noise_plain(x, 1.0, 1.0, seed)
        torch.cuda.synchronize()
        max_ulp = max(max_ulp, _ulps(torch, k, pz))
    check(max_ulp <= 2, f"B2's normals differ from the plain version's by "
                        f"{max_ulp} ulp")
    # the global-DP call at the DGA shape: x * 1 + sigma * z
    x = torch.randn(DGA_P, device="cuda", generator=gen) * 1e-3
    sigma = 0.1
    k = fused_gaussian_noise(x, 1.0, sigma, 12345)
    pz = gaussian_noise_plain(x, 1.0, sigma, 12345)
    torch.cuda.synchronize()
    max_err = float((k - pz).abs().max())
    allowed = 4 * 2.0 ** -23 * (x.abs() + sigma * 8.0)
    check(bool(((k - pz).abs() <= allowed).all()),
          f"B2 at the DGA shape: max abs err {max_err}")
    # statistics of the kernel's own stream
    n = 1 << 21
    z = fused_gaussian_noise(torch.zeros(n, device="cuda"), 1.0, 1.0, 2024)
    stats = _normal_stats(torch, z)
    z2 = fused_gaussian_noise(torch.zeros(n, device="cuda"), 1.0, 1.0, 2025)
    check(not torch.equal(z, z2), "two seeds give the same noise")
    corr = {"neighbour_elements": _corr(torch, z[0::2], z[1::2]),
            "neighbour_blocks": _corr(torch, z[:-512], z[512:]),
            "two_seeds": _corr(torch, z, z2)}
    check(all(abs(c) < 5e-3 for c in corr.values()),
          f"correlated noise: {corr}")
    # timing at the DGA shape (one global-DP call per round)
    kernel = lambda: fused_gaussian_noise(x, 1.0, sigma, 99)  # noqa: E731
    yardstick = lambda: x + sigma * torch.randn_like(x)  # noqa: E731
    kernel_ms = _device_ms(torch, kernel)
    plain_ms = _time_ms(torch, lambda: gaussian_noise_plain(x, 1.0, sigma,
                                                            99), iters=5)
    yard_ms = _device_ms(torch, yardstick)
    kernel_ms_2 = _device_ms(torch, kernel)
    host_paced = {"ms": _time_ms(torch, kernel),
                  "yardstick_ms": _time_ms(torch, yardstick)}
    nbytes = 8 * DGA_P
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = PHILOX_INT_OPS_PER_ELEMENT * DGA_P / PEAK_INT32_OPS * 1e3
    issue = _noise_issue(torch, kernel)
    bound_ms = max(bytes_ms, ops_ms, issue["issue_ms"])
    row = {"name": "fused_gaussian_noise", "route": "cuda",
           "source": "msrflute_tpu_torch/csrc/gaussian_noise.cu",
           "replaces": "msrflute_tpu/ops/pallas_kernels.py:127",
           "launches": None, "max_abs_err": max_err, "ms": kernel_ms,
           "ms_host_paced": host_paced["ms"],
           "plain_ms": plain_ms, "bound_ms": bound_ms,
           "bound_by": "bytes" if bytes_ms >= bound_ms else "operations",
           "library_ms": None,
           "library_note": "no one PyTorch call draws normals and adds "
                           "them; yardstick x + sigma * randn_like(x)",
           "yardstick_ms": yard_ms}
    emit({"phase": "kernel", "ok": True, "name": "fused_gaussian_noise",
          "philox_pairs_checked": pairs,
          "plain_philox_vs_curand": "bitwise",
          "normals_max_ulp": max_ulp, "normals_bitwise": max_ulp == 0,
          "shape": [DGA_P], "max_abs_err": max_err, "stats": stats,
          "corr": corr, "ms": kernel_ms, "ms_repeat": kernel_ms_2,
          "host_paced": host_paced,
          "plain_ms": plain_ms, "yardstick_ms": yard_ms,
          "bound_ms": bound_ms, "bytes_ms": bytes_ms,
          "int32_ops_ms": ops_ms, "issue": issue,
          "share_of_bound": bound_ms / kernel_ms,
          "achieved_gb_s": nbytes / (kernel_ms * 1e-3) / 1e9})
    return row


def _noise_issue(torch, kernel):
    """B2's issue term: the thread instructions an element on the common
    path of the kernel's loop, counted in the SASS of the built library
    (``msrflute_tpu_torch/ops/sass.py::loop_path``), times the elements,
    over the card's SMs x 128 lanes x its peak SM clock.  Only the
    function's own work is counted: the loop makes no round key (they are
    kernel parameters) and indexes in 32 bits, and its constant-bank loads
    are left out (they reload the parameters, the same in every iteration,
    which a kernel with registers to spare would hold).  The clock under
    this kernel is recorded beside the peak."""
    from msrflute_tpu_torch.ops import _build, sass
    lib = _build.library_path("gaussian_noise")
    bodies = [body for name, body in sass.functions(
        sass.disassemble(lib)).items() if "gaussian_noise_kernel" in name]
    check(len(bodies) == 1, f"{len(bodies)} gaussian_noise_kernel entries "
                            "in the SASS")
    path = sass.loop_path(bodies[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    peak_mhz = _peak_sm_mhz()
    card = _under_load(torch, kernel)
    counted = (path["instructions"] - path["constant_loads"]) \
        / path["floats"]
    issue_ms = DGA_P * counted / (sms * 128 * peak_mhz * 1e6) * 1e3
    return {"issue_ms": issue_ms, "counted_per_element": counted,
            "sms": sms, "sm_clock_mhz_peak": peak_mhz,
            "card_under_kernel": card, "sass": path}


def _peak_sm_mhz():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits", "-i", "0"],
                         capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    return float(smi.stdout.strip())


def _gru_bounds():
    from msrflute_tpu_torch.models.nlp import make_gru_lm_task
    layout = make_gru_lm_task({"model_type": "GRU"}).layout()
    check(layout.numel == DGA_P, f"GRU LM has {layout.numel} params")
    return list(layout.offsets) + [layout.numel]


#: B3's odd layouts: (name, K, leaf sizes, floats by which x starts past a
#: 16-byte boundary).  Each is held bitwise to the plain version at every
#: ``QUANT_BINS``.  Together they give every head and tail length of the
#: kernel's tiles (0-3 scalars) at every row alignment, segments of 1-3
#: elements, empty leaves, 1,000 leaves and x off a 16-byte boundary
#: (``tests/test_torch_quant_bin.py`` checks that on the CPU)
QUANT_CASES = [
    ("odd", 3, (1, 7, 1000, 33, 2049), 0),
    ("one", 1, (1,), 0),
    ("empty_leaves", 3, (0, 1000, 0, 37, 4099, 0), 0),
    ("tiny_leaves", 4, (1, 2, 3, 1, 3, 2, 8195, 1, 2, 3), 0),
    ("p_mod4_1", 5, (4097, 3, 12290, 1, 6), 0),
    ("p_mod4_2", 5, (2, 4101, 9, 8192, 2), 0),
    ("p_mod4_3", 5, (5, 12287, 2, 3, 6), 0),
    ("leaves_1000", 4, tuple(i * 37 % 97 for i in range(1000)), 0),
    ("x_off_16B", 5, (5, 4099, 2, 8190), 1),
    ("x_off_16B_3", 3, (3, 6, 4093, 1), 3),
]
QUANT_BINS = (1024, 16, 2)


def _quant_case(torch, x, bounds, q, overrides=()):
    """lo, hi and the ``q`` quantile threshold of every (row, leaf) of
    ``x`` (0 for an empty leaf), with ``overrides`` ``((k, l), thresh)``,
    and the bounds as a device tensor."""
    from msrflute_tpu_torch.ops.quantization import exact_quantile_abs
    lo, hi, th = [], [], []
    for a, b in zip(bounds[:-1], bounds[1:]):
        g = x[:, a:b]
        if b == a:
            lo.append(g.new_zeros(x.shape[0]))
            hi.append(lo[-1])
            th.append(lo[-1])
            continue
        lo.append(g.amin(dim=-1))
        hi.append(g.amax(dim=-1))
        th.append(exact_quantile_abs(g.abs(), q))
    lo, hi, th = (torch.stack(t, dim=1).contiguous() for t in (lo, hi, th))
    for (k, l), value in overrides:
        th[k, l] = value
    off = torch.tensor(bounds, dtype=torch.int64, device="cuda")
    return off, lo, hi, th


def _quant_odd_input(torch, gen, K, sizes, shift):
    """``[K, sum(sizes)]`` normals as a view ``shift`` floats into a buffer
    of its own, and the leaf bounds."""
    bounds = [0]
    for n in sizes:
        bounds.append(bounds[-1] + n)
    P = bounds[-1]
    buf = torch.randn(K * P + shift + 1, device="cuda", generator=gen)
    return buf[shift:shift + K * P].view(K, P), bounds


def _quant_yardstick(torch, x, bounds, lo, hi, th, n_bins):
    """B3's function as a few PyTorch calls over the whole ``[K, P]``:
    each element's lo, width and threshold gathered through a leaf-index
    vector made here, once, then division, ``round``, ``clamp`` and
    ``where`` (in place where the memory of BERT-base's shape asks for
    it).  The port never calls it."""
    from msrflute_tpu_torch.ops.quant_bin import _widths
    sizes = torch.tensor([b - a for a, b in zip(bounds[:-1], bounds[1:])],
                         device="cuda")
    leaf = torch.repeat_interleave(
        torch.arange(len(sizes), device="cuda"), sizes)
    width, wdiv = _widths(lo, hi, n_bins)

    def call():
        lo_e = lo[:, leaf]
        y = x - lo_e
        y.div_(wdiv[:, leaf]).round_().clamp_(0, n_bins - 1)
        y.mul_(width[:, leaf]).add_(lo_e)
        del lo_e
        return torch.where(x.abs() > th[:, leaf], y, 0.0)
    return call


def _quant_sass(torch):
    """B3's instruction count: :func:`msrflute_tpu_torch.ops.sass.
    vector_path` of the built kernel (a thread of a full tile, set-up
    included), whether the path's loads of x are 128-bit (as many 128-bit
    loads as 128-bit stores), and the SM count and peak clock its issue
    term takes."""
    from msrflute_tpu_torch.ops import _build, sass
    lib = _build.library_path("quant_bin")
    bodies = [body for name, body in sass.functions(
        sass.disassemble(lib)).items() if "quant_bin_kernel" in name]
    check(len(bodies) == 1, f"{len(bodies)} quant_bin_kernel entries in "
                            "the SASS")
    path = sass.vector_path(bodies[0])
    path["loads_128bit"] = path["loads"].get(128, 0) == \
        path["stores"].get(128, 0) == path["floats"] // 4 > 0
    check(path["loads_128bit"], f"B3's body does not load x in 128-bit "
                                f"loads: {path['loads']} {path['stores']}")
    # the path bins every element it stores: a reciprocal (MUFU.RCP, the
    # IEEE division's first step) an element, and one for the width
    check(path["mix"].get("MUFU", 0) > path["floats"],
          f"B3's counted path skips divisions: {path['mix']}")
    path["sms"] = torch.cuda.get_device_properties(0).multi_processor_count
    path["sm_clock_mhz_peak"] = _peak_sm_mhz()
    return path


def _quant_bytes(K, P, L):
    """What B3 must move: x read and out written once, the lo / hi /
    thresh tables and the offsets read once."""
    return 8 * K * P + 12 * K * L + 8 * (L + 1)


def _quant_timing(torch, x, bounds, off, lo, hi, th, launches=200,
                  lead=20, plain_iters=10, n_bins=1024):
    """B3 at one shape: the kernel and the yardstick on the device alone
    (the yardstick checked bitwise against the kernel first), the plain
    version host-paced, the bound (bytes, flops, and the issue term of the
    instructions :func:`_quant_sass` counts), share and achieved rate."""
    from msrflute_tpu_torch.ops.quant_bin import (quant_bin_plain,
                                                  quant_bin_sparsify)
    K, P = x.shape
    L = len(bounds) - 1
    kernel = lambda: quant_bin_sparsify(x, off, lo, hi, th,  # noqa: E731
                                        n_bins)
    yardstick = _quant_yardstick(torch, x, bounds, lo, hi, th, n_bins)
    check(torch.equal(yardstick(), kernel()),
          f"B3's yardstick != the kernel at [{K}, {P}]")
    torch.cuda.empty_cache()
    kernel_ms = _device_ms(torch, kernel, launches, lead)
    off_cpu = off.cpu()
    plain_ms = _time_ms(torch, lambda: quant_bin_plain(x, off_cpu, lo, hi,
                                                       th, n_bins),
                        iters=plain_iters, warmup=1)
    yard_ms = _device_ms(torch, yardstick, min(launches, 20), 5)
    torch.cuda.empty_cache()
    kernel_ms_2 = _device_ms(torch, kernel, launches, lead)
    nbytes = _quant_bytes(K, P, L)
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = 10 * K * P / PEAK_F32_FLOPS * 1e3
    sass = _quant_sass(torch)
    issue_ms = K * P * sass["per_element"] / (
        sass["sms"] * 128 * sass["sm_clock_mhz_peak"] * 1e6) * 1e3
    bound_ms = max(bytes_ms, ops_ms, issue_ms)
    return {"shape": [K, P], "leaves": L, "ms": kernel_ms,
            "ms_repeat": kernel_ms_2,
            "ms_host_paced": _time_ms(torch, kernel, iters=20),
            "plain_ms": plain_ms, "yardstick_ms": yard_ms,
            "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_ms >= bound_ms else "operations",
            "bytes": nbytes, "bytes_ms": bytes_ms, "flops_ms": ops_ms,
            "issue_ms": issue_ms, "sass": sass,
            "share": bound_ms / kernel_ms,
            "achieved_gb_s": nbytes / (kernel_ms * 1e-3) / 1e9}


def _quant_row(timed, max_err):
    return {"name": "quant_bin_sparsify", "shape": timed["shape"],
            "route": "cuda",
            "source": "msrflute_tpu_torch/csrc/quant_bin.cu",
            "replaces": "msrflute_tpu/ops/pallas_kernels.py:164",
            "launches": None, "max_abs_err": max_err, "ms": timed["ms"],
            "ms_host_paced": timed["ms_host_paced"],
            "plain_ms": timed["plain_ms"], "bound_ms": timed["bound_ms"],
            "bound_by": timed["bound_by"], "library_ms": None,
            "library_note": "no one PyTorch call bins and sparsifies; "
                            "yardstick: lo, width and thresh gathered "
                            "through a leaf index, then round, clamp, "
                            "where",
            "yardstick_ms": timed["yardstick_ms"], "share": timed["share"]}


def phase_kernel_quant(torch):
    """B3 against its plain version, bitwise, at the DGA shape and the odd
    layouts of ``QUANT_CASES``; then timed, with the yardstick and the
    exact quantile's time beside it, and its SASS counted."""
    from msrflute_tpu_torch.ops.quant_bin import (quant_bin_plain,
                                                  quant_bin_sparsify)
    from msrflute_tpu_torch.ops.quantization import exact_quantile_abs
    gen = torch.Generator(device="cuda").manual_seed(3)
    bounds = _gru_bounds()
    L = len(bounds) - 1
    x = torch.randn((DGA_K, DGA_P), device="cuda", generator=gen)
    x *= torch.logspace(-3, 0, DGA_K, device="cuda")[:, None]
    a0, b0 = bounds[0], bounds[1]
    x[3, a0:b0] = 0.25                             # hi == lo
    a6, b6 = bounds[6], bounds[7]
    # lo 0, hi 1023: width exactly 1, and every other value a half-bin
    x[5, a6:b6] = (torch.arange(b6 - a6, device="cuda") % 2047) * 0.5
    x[5, a6] = 1023.0
    mixed = (((0, 1), 0.0), ((1, 4), -1.0), ((2, 2), 1e30), ((5, 6), -1.0),
             ((7, 3), float(x[7, bounds[3]:bounds[4]].abs().max())))
    cases = [("dga", x, bounds, mixed)]
    for name, K, sizes, shift in QUANT_CASES:
        t, bnd = _quant_odd_input(torch, gen, K, sizes, shift)
        cases.append((name, t, bnd, (((K - 1, len(sizes) // 2), -1.0),)))
    max_err = 0.0
    for name, t, bnd, over in cases:
        off, lo, hi, th = _quant_case(torch, t, bnd, 0.7, over)
        for n_bins in QUANT_BINS:
            k = quant_bin_sparsify(t, off, lo, hi, th, n_bins)
            pl = quant_bin_plain(t, off.cpu(), lo, hi, th, n_bins)
            torch.cuda.synchronize()
            err = float((k - pl).abs().max())
            if name == "dga":
                max_err = max(max_err, err)
            check(torch.equal(k, pl),
                  f"quant_bin {name} n_bins={n_bins}: kernel != plain "
                  f"(max abs err {err})")
    off, lo, hi, th = _quant_case(torch, x, bounds, 0.7)
    half = quant_bin_sparsify(x, off, lo, hi, torch.full_like(th, -1.0),
                              1024)[5, a6 + 1:a6 + 8].tolist()
    check(half == [0.0, 1.0, 2.0, 2.0, 2.0, 3.0, 4.0],
          f"half-bin values are not rounded half to even: {half}")
    timed = _quant_timing(torch, x, bounds, off, lo, hi, th)
    quantile_ms = _time_ms(torch, lambda: [
        exact_quantile_abs(x[:, a:b].abs(), 0.7)
        for a, b in zip(bounds[:-1], bounds[1:])], iters=5)
    minmax_ms = _time_ms(torch, lambda: [
        (x[:, a:b].amin(dim=-1), x[:, a:b].amax(dim=-1))
        for a, b in zip(bounds[:-1], bounds[1:])], iters=10)
    emit({"phase": "kernel", "ok": True, "name": "quant_bin_sparsify",
          "cases": len(cases) * len(QUANT_BINS), "bitwise": True, **timed,
          "exact_quantile_ms_all_leaves": quantile_ms,
          "min_max_ms_all_leaves": minmax_ms})
    return _quant_row(timed, max_err)


#: the RingLM path's attention shape: K = 10 clients x batch 4 folded into
#: B = 40, L = seq_len - 1 = 1023 inputs, 4 heads of 32, causal
FLASH_MAIN = (40, 1023, 1023, 4, 32, True, 0, 0)
#: the same path's eval step: val and test batch 16
#: (experiments/ringlm/config.yaml), 532 of B4's 652 launches
FLASH_EVAL_B = 16
#: tolerances: max |kernel - plain| over max |plain|.  Both sum in float32
#: in other orders (the kernels over 64-wide tiles with an online softmax,
#: cuBLAS over its own splits), so they differ by a few ulp of the largest
#: terms, growing with the square root of the up to 1,023 terms a sum has:
#: about 2e-6 of the largest value for the forward's weighted averages, and
#: more for the backward, whose dk/dv sum products of two recomputed factors
#: over up to 1,023 rows.  An H100 measured at most 6.1e-7 forward and
#: 1.3e-6 backward over the cases of :func:`phase_kernel_flash`.
FLASH_FWD_TOL = 1e-5
FLASH_BWD_TOL = 1e-4
#: H100 SXM TF32 tensor-core peak (dense), beside the f32 bound: the
#: kernels run on CUDA cores, a tensor-core kernel would be bound by this
PEAK_TF32_FLOPS = 495e12


def _flash_entry(key, D, storage="float32"):
    """Pass ``key``'s entry function at head width D, as
    :func:`ptxas_reports` names it: the template argument is D padded to
    8, 16, 32, 64 or 128, then the storage type where it is 16-bit.  In
    16-bit storage the three passes are the tensor-core kernels,
    ``flash_fwd_tc_kernel``, ``flash_dq_tc_kernel`` and
    ``flash_dkv_tc_kernel``, at D padded to 16 at least."""
    width = next(w for w in (8, 16, 32, 64, 128) if D <= w)
    if storage == "float32":
        return f"flash_{key}_kernel<{width}>"
    return f"flash_{key}_tc_kernel<{max(width, 16)}, {storage}>"


def _flash_case(torch, B, Lq, Lk, H, D, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((B, Lq, H, D), device="cuda", generator=gen)
    k, v = (torch.randn((B, Lk, H, D), device="cuda", generator=gen)
            for _ in range(2))
    g = torch.randn((B, Lq, H, D), device="cuda", generator=gen)
    g_lse = torch.randn((B, H, Lq), device="cuda", generator=gen)
    return q, k, v, g, g_lse


def _rel_err(torch, got, want):
    return float((got - want).abs().max() / want.abs().max().clamp(
        min=1e-30))


def _visible_pairs(torch, B, Lq, Lk, H, causal, q_off, k_off):
    """Query-key pairs the mask lets through: the work this run needs."""
    if not causal:
        return B * H * Lq * Lk
    q_pos = q_off + torch.arange(Lq)
    per_row = torch.clamp(q_pos - k_off + 1, min=0, max=Lk)
    return B * H * int(per_row.sum())


def _flash_cases(torch, cases, dtype, tol):
    """B4, B5 and B6 against their plain versions on the same ``dtype``
    inputs (B5 and B6 take the plain forward's out and lse): the largest
    error over the largest plain value within ``tol`` (``out``, ``lse``,
    ``grads``), outputs in the input's type and lse in float32, fully
    masked rows exactly 0 with ``lse == -1e30``, two launches bitwise
    equal at the path's shape and at a ragged offset case.  Returns the
    errors of each case, the absolute ones of ``main`` and the number of
    fully masked rows checked."""
    from msrflute_tpu_torch.ops import flash_attention as fa
    errs, max_abs, masked_rows, repeated = {}, None, 0, []
    for seed, (name, (B, Lq, Lk, H, D, causal, qo, ko)) in enumerate(cases):
        q, k, v, g, g_lse = _flash_case(torch, B, Lq, Lk, H, D, seed)
        q, k, v, g = (x.to(dtype) for x in (q, k, v, g))
        out, lse = fa.flash_fwd(q, k, v, causal, qo, ko)
        p_out, p_lse = fa.attention_lse_plain(q, k, v, causal, qo, ko)
        delta = fa.attention_delta(p_out, g)
        bwd_args = (q, k, v, g, p_lse, delta, g_lse, causal, qo, ko)
        dq = fa.flash_dq(*bwd_args)
        dk, dv = fa.flash_dkv(*bwd_args)
        p_dq = fa.attention_dq_plain(*bwd_args)
        p_dk, p_dv = fa.attention_dkv_plain(*bwd_args)
        torch.cuda.synchronize()
        check(out.dtype == dq.dtype == dk.dtype == dv.dtype == dtype and
              lse.dtype == torch.float32, f"flash {dtype} {name}: types")
        dead = p_lse == fa.NEG           # rows whose keys are all masked
        masked_rows += int(dead.sum())
        check(torch.equal(lse == fa.NEG, dead),
              f"flash {dtype} {name}: lse marks other rows fully masked")
        check(bool((out.transpose(1, 2)[dead] == 0).all()),
              f"flash {dtype} {name}: a fully masked row is not exactly 0")
        live = ~dead
        pairs = {"out": (out, p_out), "dq": (dq, p_dq), "dk": (dk, p_dk),
                 "dv": (dv, p_dv)}
        e = {key: _rel_err(torch, a.float(), b.float())
             for key, (a, b) in pairs.items()}
        e["lse"] = (_rel_err(torch, lse[live], p_lse[live])
                    if bool(live.any()) else 0.0)
        errs[name] = e
        check(e["out"] <= tol["out"] and e["lse"] <= tol["lse"],
              f"flash {dtype} forward {name}: {e}")
        check(max(e["dq"], e["dk"], e["dv"]) <= tol["grads"],
              f"flash {dtype} backward {name}: {e}")
        if name == "main":
            max_abs = {key: float((a.float() - b.float()).abs().max())
                       for key, (a, b) in {**pairs,
                                           "lse": (lse, p_lse)}.items()}
        if name in ("main", "ragged_diag_edge"):
            again = (fa.flash_fwd(q, k, v, causal, qo, ko),
                     fa.flash_dq(*bwd_args), fa.flash_dkv(*bwd_args))
            torch.cuda.synchronize()
            check(torch.equal(again[0][0], out) and
                  torch.equal(again[0][1], lse) and
                  torch.equal(again[1], dq) and
                  torch.equal(again[2][0], dk) and
                  torch.equal(again[2][1], dv),
                  f"flash {dtype} {name}: two launches differ")
            repeated.append(name)
    check(masked_rows > 0, "no case had fully masked rows")
    check(repeated == ["main", "ragged_diag_edge"],
          f"bitwise repeat ran on {repeated}")
    return errs, max_abs, masked_rows


def phase_kernel_flash(torch):
    """B4, B5 and B6 against their plain versions on the same inputs (B5
    and B6 take the plain forward's out and lse), at the RingLM path's
    shape and at odd shapes; two launches bitwise equal; then timed with
    the causal f32 SDPA call as the yardstick."""
    from msrflute_tpu_torch.ops import flash_attention as fa
    torch.backends.cuda.matmul.allow_tf32 = False
    cases = [
        ("main", FLASH_MAIN),
        ("L1", (2, 1, 1, 2, 32, True, 0, 0)),
        ("L17", (3, 17, 17, 2, 32, True, 0, 0)),
        ("L1000", (2, 1000, 1000, 4, 32, True, 0, 0)),
        ("offsets_all_see", (2, 70, 40, 2, 16, True, 40, 8)),
        ("offsets_masked_rows", (2, 100, 150, 2, 32, True, 0, 30)),
        ("offsets_masked_tile", (1, 130, 200, 2, 32, True, 0, 100)),
        ("non_causal", (2, 77, 130, 2, 32, False, 0, 0)),
        ("D8", (2, 65, 65, 2, 8, True, 0, 0)),
        ("D64", (2, 200, 200, 2, 64, True, 0, 0)),
        ("D128", (2, 129, 129, 2, 128, True, 0, 0)),
        # the last tile ragged on both axes, under offsets that put the
        # diagonal through it: a diagonal tile that is also an edge tile
        ("ragged_diag_edge", (2, 150, 170, 2, 32, True, 37, 11)),
        # 16-byte copies at a width under the padded one; 4-byte copies
        ("D4", (2, 70, 70, 2, 4, True, 0, 0)),
        ("D20", (2, 100, 90, 2, 20, True, 5, 0)),
        ("D5", (1, 70, 80, 2, 5, True, 10, 0)),
        ("non_causal_ragged", (1, 200, 300, 3, 32, False, 0, 0)),
        # fewer blocks than the card has SMs
        ("BH1", (1, 1023, 1023, 1, 32, True, 0, 0)),
    ]
    errs, max_abs, masked_rows = _flash_cases(
        torch, cases, torch.float32,
        {"out": FLASH_FWD_TOL, "lse": FLASH_FWD_TOL, "grads": FLASH_BWD_TOL})

    # timing at the path's shape
    B, Lq, Lk, H, D, causal, qo, ko = FLASH_MAIN
    q, k, v, g, g_lse = _flash_case(torch, B, Lq, Lk, H, D, 99)
    g_lse.zero_()                # the path's loss does not read the lse
    out, lse = fa.flash_fwd(q, k, v, causal, qo, ko)
    delta = fa.attention_delta(out, g)
    bwd_args = (q, k, v, g, lse, delta, g_lse, causal, qo, ko)
    calls = {"fwd": lambda: fa.flash_fwd(q, k, v, causal, qo, ko),
             "dq": lambda: fa.flash_dq(*bwd_args),
             "dkv": lambda: fa.flash_dkv(*bwd_args)}
    t = {key: _device_ms(torch, fn) for key, fn in calls.items()}
    plain = {"fwd": _time_ms(torch, lambda: fa.attention_lse_plain(
                 q, k, v, causal, qo, ko), iters=5),
             "dq": _time_ms(torch, lambda: fa.attention_dq_plain(*bwd_args),
                            iters=5),
             "dkv": _time_ms(torch, lambda: fa.attention_dkv_plain(
                 *bwd_args), iters=5)}
    # the yardstick: one causal f32 SDPA call in its [B, H, L, D] layout,
    # forward, then its backward (dq, dk and dv together)
    from torch.nn.functional import scaled_dot_product_attention as sdpa
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    gt = g.transpose(1, 2).contiguous()

    def lib_fwd_call():
        with torch.no_grad():
            sdpa(qt, kt, vt, is_causal=True)

    lib_out = sdpa(qt, kt, vt, is_causal=True)
    lib_bwd_call = lambda: torch.autograd.grad(  # noqa: E731
        lib_out, (qt, kt, vt), gt, retain_graph=True)
    lib_fwd = _device_ms(torch, lib_fwd_call)
    lib_bwd = _device_ms(torch, lib_bwd_call)
    t_again = _device_ms(torch, calls["fwd"])
    host_paced = {**{key: _time_ms(torch, fn, iters=20)
                     for key, fn in calls.items()},
                  "sdpa_fwd": _time_ms(torch, lib_fwd_call, iters=20),
                  "sdpa_bwd": _time_ms(torch, lib_bwd_call, iters=20)}
    bwd_under_load = _under_load(
        torch, lambda: (fa.flash_dq(*bwd_args), fa.flash_dkv(*bwd_args)))
    fwd_under_load = _under_load(
        torch, lambda: fa.flash_fwd(q, k, v, causal, qo, ko))
    pairs = _visible_pairs(torch, B, Lq, Lk, H, causal, qo, ko)
    qbytes = 4 * B * Lq * H * D
    kbytes = 4 * B * Lk * H * D
    sbytes = 4 * B * H * Lq
    work = {   # (flops: 2 per multiply-add of each product, bytes)
        "fwd": (2 * 2 * D * pairs, qbytes + 2 * kbytes + qbytes + sbytes),
        "dq": (3 * 2 * D * pairs, 2 * qbytes + 2 * kbytes + 3 * sbytes
               + qbytes),
        "dkv": (4 * 2 * D * pairs, 2 * qbytes + 2 * kbytes + 3 * sbytes
                + 2 * kbytes)}
    # B4 at the eval step's shape (val and test batch 16): most of its
    # launches on the RingLM path
    Be = FLASH_EVAL_B
    qe, ke, ve, _, _ = _flash_case(torch, Be, Lq, Lk, H, D, 98)
    qet, ket, vet = (x.transpose(1, 2).contiguous() for x in (qe, ke, ve))
    eval_pairs = _visible_pairs(torch, Be, Lq, Lk, H, causal, qo, ko)
    eval_flops = 2 * 2 * D * eval_pairs
    eval_bytes = (qbytes + 2 * kbytes + qbytes + sbytes) * Be // B

    def eval_sdpa_call():
        with torch.no_grad():
            sdpa(qet, ket, vet, is_causal=True)

    eval_sdpa = _device_ms(torch, eval_sdpa_call)
    fwd_eval = {
        "shape": [Be, Lq, H, D],
        "ms": _device_ms(torch, lambda: fa.flash_fwd(qe, ke, ve, causal, qo,
                                                     ko)),
        "bound_ms": max(eval_flops / PEAK_F32_FLOPS,
                        eval_bytes / PEAK_BYTES_PER_S) * 1e3,
        "bound_by": "operations", "sdpa_fwd_ms": eval_sdpa}
    fwd_eval["share_of_bound"] = fwd_eval["bound_ms"] / fwd_eval["ms"]
    fwd_eval["sdpa_over_kernel"] = eval_sdpa / fwd_eval["ms"]
    check(eval_flops / PEAK_F32_FLOPS >= eval_bytes / PEAK_BYTES_PER_S,
          "B4 at the eval shape is not bound by operations")
    max_err = {"fwd": max(max_abs["out"], max_abs["lse"]),
               "dq": max_abs["dq"], "dkv": max(max_abs["dk"], max_abs["dv"])}
    rows, detail = [], {}
    meta = (("fwd", "flash_attention_fwd", ":336", lib_fwd,
             "causal f32 SDPA forward"),
            ("dq", "flash_attention_dq", ":385", lib_bwd,
             "causal f32 SDPA backward: dq, dk and dv together (B5 + B6)"),
            ("dkv", "flash_attention_dkv", ":411", lib_bwd,
             "causal f32 SDPA backward: dq, dk and dv together (B5 + B6)"))
    for which, (key, name, line, lib_ms, note) in enumerate(meta):
        flops, nbytes = work[key]
        ops_ms = flops / PEAK_F32_FLOPS * 1e3
        bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
        rows.append({
            "name": name, "route": "cuda",
            "source": "msrflute_tpu_torch/csrc/flash_attention.cu",
            "replaces": f"msrflute_tpu/ops/pallas_attention.py{line}",
            "launches": None, "max_abs_err": max_err[key],
            "ms": t[key], "ms_host_paced": host_paced[key],
            "plain_ms": plain[key],
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "library_ms": lib_ms, "library_note": note})
        info = fa.kernel_info(which, D)
        detail[key] = {"flops": flops, "bytes": nbytes,
                       "bound_ms_tf32": flops / PEAK_TF32_FLOPS * 1e3,
                       "achieved_tflop_s": flops / (t[key] * 1e-3) / 1e12,
                       "share_of_bound": max(ops_ms, bytes_ms) / t[key],
                       "smem_bytes_per_block_d32": info["smem_bytes"],
                       "registers_d32": info["registers"],
                       "local_bytes_d32": info["local_bytes"],
                       "blocks_per_sm_d32": info["blocks_per_sm"],
                       "ptxas_d32": ptxas_reports(
                           BUILD_LOGS.get("flash_attention", "")).get(
                               _flash_entry(key, D))}
    emit({"phase": "kernel", "ok": True,
          "name": "flash_attention (B4, B5, B6)", "shape": list(FLASH_MAIN),
          "cases": len(cases), "fully_masked_rows_checked": masked_rows,
          "tolerance": {"fwd": FLASH_FWD_TOL, "bwd": FLASH_BWD_TOL},
          "rel_err": errs, "max_abs_err_main": max_abs,
          "bitwise_repeat": True, "visible_pairs": pairs,
          "ms": t, "fwd_ms_repeat": t_again, "host_paced": host_paced,
          "plain_ms": plain,
          "sdpa_fwd_ms": lib_fwd, "sdpa_bwd_ms": lib_bwd,
          "dq_plus_dkv_ms": t["dq"] + t["dkv"],
          "sdpa_fwd_over_fwd": lib_fwd / t["fwd"],
          "fwd_at_eval_shape": fwd_eval,
          "card_under_dq_and_dkv": bwd_under_load,
          "card_under_fwd": fwd_under_load,
          "bound_ms": {r["name"]: r["bound_ms"] for r in rows},
          "detail": detail})
    for key in ("fwd", "dq", "dkv"):   # the path's instances do not spill
        d = detail[key]
        spills = d["ptxas_d32"] or {"spill_store_bytes": 0,
                                    "spill_load_bytes": 0}
        check(d["local_bytes_d32"] == 0 and d["blocks_per_sm_d32"] >= 2 and
              spills["spill_store_bytes"] == spills["spill_load_bytes"] == 0,
              f"flash {key} at D = {D} spills or fits one block an SM: {d}")
    return rows


# ----------------------------------------------------------------------
def write_femnist_blob(path, num_users, lo, hi, seed):
    """A FEMNIST-shaped user blob: 28x28 uint8 images (written flat, as
    784 pixels a row), 62 classes."""
    import numpy as np
    rng = np.random.default_rng(seed)
    users = [f"f{seed}_{i:04d}" for i in range(num_users)]
    counts = rng.integers(lo, hi + 1, size=num_users).tolist()
    rows, labels = [], {}
    for u, n in zip(users, counts):
        x = rng.integers(0, 256, size=(n, 28 * 28), dtype=np.uint8)
        rows.append(_pixel_rows(x))
        labels[u] = rng.integers(0, 62, size=n).tolist()
    _write_json_blob(path, users, rows, labels)
    return sum(counts)


#: each byte value's decimal text, for writing pixel rows quickly
_BYTE_TEXT = [str(v) for v in range(256)]


def _pixel_rows(x):
    """``[n, pixels]`` uint8 -> one JSON list text a row."""
    import numpy as np
    text = np.asarray(_BYTE_TEXT, dtype=object)
    return ["[" + ",".join(text[r]) + "]" for r in x]


def _write_json_blob(path, users, rows, labels=None, streams=None):
    """A user blob written row by row: ``rows[i]`` is user i's samples,
    each a JSON text (a flat pixel list or a quoted line); ``streams``
    maps another per-user key (semisupervision's ``ux``) to rows alike."""
    streams = streams or {}
    with open(path, "w") as fh:
        fh.write('{"users": ' + json.dumps(users) + ', "num_samples": '
                 + json.dumps([len(r) for r in rows]) + ', "user_data": {')
        for i, u in enumerate(users):
            fh.write(("," if i else "") + json.dumps(u) + ': {"x": ['
                     + ",".join(rows[i]) + "]")
            for key, more in streams.items():
                fh.write(f', "{key}": [' + ",".join(more[i]) + "]")
            fh.write("}")
        fh.write("}")
        if labels is not None:
            fh.write(', "user_data_label": ' + json.dumps(labels))
        fh.write("}")


def _run_cli(work, name, raw, device, task="cv_cnn_femnist"):
    import yaml
    from msrflute_tpu_torch import e2e_trainer
    cfg_path = os.path.join(work, f"{name}.yaml")
    with open(cfg_path, "w") as fh:
        yaml.safe_dump(raw, fh)
    out = os.path.join(work, f"out_{name}")
    tic = time.time()
    server = e2e_trainer.main(["-config", cfg_path, "-dataPath", work,
                               "-outputPath", out, "-task", task,
                               "-device", device])
    return server, out, time.time() - tic


def _reset_counts():
    from msrflute_tpu_torch.ops import KERNELS
    for wrapper in KERNELS.values():
        wrapper.launches = 0
        for arm in getattr(wrapper, "launches_by_dtype", {}):
            wrapper.launches_by_dtype[arm] = 0


def _arm(name, dtype):
    """A kernel's 16-bit storage arm, as the ``kernels`` table names it."""
    return f"{name}[{dtype}]"


def _read_arm_counts():
    """The 16-bit arms' launches: ``{"fused_sgd_apply[bfloat16]": n,
    ...}`` (the totals of :func:`_read_counts` include them)."""
    from msrflute_tpu_torch.ops import KERNELS
    return {_arm(name, dt): n for name, w in KERNELS.items()
            for dt, n in getattr(w, "launches_by_dtype", {}).items()
            if dt != "float32"}


def _read_counts():
    from msrflute_tpu_torch.ops import KERNELS
    return {name: w.launches for name, w in KERNELS.items()}


def phase_main(torch, work, kernel_rows):
    import numpy as np
    os.makedirs(os.path.join(work, "femnist"), exist_ok=True)
    tic = time.time()
    sizes = {split: write_femnist_blob(
        os.path.join(work, "femnist", f"{split}.json"), users, 50, 300, seed)
        for split, users, seed in (("train", 350, 0), ("val", 35, 1),
                                   ("test", 35, 2))}
    blob_s = time.time() - tic

    _reset_counts()
    server, out, secs = _run_cli(work, "main", CNN_CONFIG, "cuda")
    launches = _read_counts()

    check(server.state.params.is_cuda, "server params are not on cuda")
    check(all(t.is_cuda for t in server.state.opt_state.values()),
          "server optimizer state is not on cuda")
    steps = server.engine.local_steps
    check(launches["fused_sgd_apply"] == steps > 0,
          f"fused_sgd_apply launched {launches['fused_sgd_apply']} times "
          f"for {steps} local steps")
    # B1 is this path's only kernel: global DP and quantization are DGA's,
    # flash attention RingLM's
    check(not any(n for k, n in launches.items() if k != "fused_sgd_apply"),
          f"another path's kernel launched on the CNN path: {launches}")
    with open(os.path.join(out, "log", "metrics.jsonl")) as fh:
        records = [json.loads(line) for line in fh]
    train_loss = [r["value"] for r in records if r.get("name") ==
                  "Training loss"]
    check(len(train_loss) == 5 and all(map(math.isfinite, train_loss)),
          f"training losses {train_loss}")
    evals = [h for h in server.history]
    check(all(math.isfinite(h["loss"]) for h in evals),
          f"non-finite eval loss: {evals}")
    models = os.path.join(out, "models")
    for f in ("latest_model.pt", "latest_model.pt.sum", "status_log.json",
              "best_val_acc_model.pt"):
        check(os.path.exists(os.path.join(models, f)), f"missing {f}")
    with open(os.path.join(models, "status_log.json")) as fh:
        check(json.load(fh)["i"] == 5, "status_log.json is not at round 5")
    for row in kernel_rows:
        row.setdefault("launches_by_path", {})["cnn_main"] = \
            launches[row["name"]]
        if row["name"] == "fused_sgd_apply":
            row["launches"] = launches[row["name"]]
    rounds = server.run_stats["secsPerRound"]
    MAIN_SECS["after_first"] = float(np.mean(rounds[1:]))
    # main's final model on its val split (its last val eval is at round
    # 4 of 5), for the warm start of phase model_options
    from msrflute_tpu_torch.engine.evaluation import evaluate
    final = evaluate(server.task, server.engine.params_dict(server.state),
                     server._staged_eval("val"))
    MAIN_FINAL_VAL.update({k: m.value for k, m in final.items()})
    val = [h for h in evals if h["split"] == "val"]
    emit({"phase": "main", "ok": True, "device": "cuda",
          "users": {"train": 350, "val": 35, "test": 35},
          "samples": sizes, "population_note":
              "FEMNIST's 3,400 writers cut to 350 (synthetic data)",
          "blob_seconds": round(blob_s, 3), "run_seconds": round(secs, 3),
          "rounds": len(rounds), "secs_per_round": rounds,
          "secs_per_round_after_first": float(np.mean(rounds[1:])),
          "local_steps": steps, "launches": launches,
          "train_loss": train_loss,
          "val": [{"round": h["round"], "loss": h["loss"], "acc": h["acc"]}
                  for h in val]})
    return server


def _busy_us(intervals):
    """Length of the union of ``(start, end)`` intervals: the time in which
    the device runs at least one kernel or copy."""
    busy, last = 0.0, float("-inf")
    for start, end in sorted(intervals):
        if end > last:
            busy += end - max(start, last)
            last = end
    return busy


def phase_profile(torch, server, rounds=1, phase="profile",
                  client_lr=0.1, server_lr=1.0, quant_threshold=None):
    """Where a path's round time goes: on one fresh cohort, after one
    warm-up round, ``rounds`` rounds (one since the fused_carry phase
    came, two before) of the run's engine timed on the host clock, then
    ``rounds`` more under ``torch.profiler`` for the time each
    kernel (and copy) runs on the device.  ``device_busy_ms`` is the union
    of the device intervals (kernels on several streams may overlap, so it
    can be less than their sum, ``kernel_ms``).  The idle share is the part
    of the untraced round in which the device runs nothing;
    ``device_idle_share_traced`` is the same inside the traced rounds'
    device span, where the profiler also slows the host.  The sort share is
    the device time of the kernels whose name says sort (the exact
    quantile's ``torch.sort``)."""
    from msrflute_tpu_torch.data.batching import pack_round_batches
    sampled = server._sample()
    batch = pack_round_batches(
        server.train_dataset, sampled, server.batch_size,
        server._chunk_steps([sampled]), rng=server._np_rng,
        desired_max_samples=server.desired_max_samples)
    engine, state = server.engine, server.state

    def step():
        nonlocal state
        state = engine.run_round(state, batch, client_lr, server_lr,
                                 quant_threshold=quant_threshold)[0]

    traced = _trace_rounds(torch, step, rounds, phase)
    F32_PROFILE[phase] = {k: traced[k] for k in (
        "wall_ms_per_round", "device_busy_ms_per_round",
        "device_idle_share")}
    emit({"phase": phase, "ok": True, "rounds": rounds,
          "steps_per_round": int(batch.sample_mask.shape[1]), **traced})


def _trace_rounds(torch, step, rounds, phase, groups=None):
    """After one warm-up call of ``step`` (one round), ``rounds`` calls
    timed on the host clock, then ``rounds`` more under ``torch.profiler``:
    the per-round figures :func:`phase_profile` reports.  ``groups``
    (``{group: name fragments}``) adds each group's device ms a round and
    calls, over the kernels whose name holds one of its fragments."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    step()
    torch.cuda.synchronize()
    tic = time.time()
    for _ in range(rounds):
        step()
    torch.cuda.synchronize()
    wall_ms = (time.time() - tic) * 1e3 / rounds
    # the device's activity alone: the host-side events of a round of
    # tens of thousands of launches cost the profiler most of a minute to
    # collect (the LSTM's); where CUPTI's records come back only beside
    # them, trace again with both
    for activities in ([ProfilerActivity.CUDA],
                       [ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        with profile(activities=activities) as prof:
            for _ in range(rounds):
                step()
            torch.cuda.synchronize()
        by_name, spans, streams = {}, [], set()
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                us, n = by_name.get(e.name, (0.0, 0))
                by_name[e.name] = (us + e.time_range.elapsed_us(), n + 1)
                spans.append((e.time_range.start, e.time_range.end))
                streams.add(e.device_resource_id)
        if spans:
            break
    check(bool(spans), f"{phase}: the profiler saw no device activity")
    kernel_ms = sum(us for us, _ in by_name.values()) / 1e3 / rounds
    busy_ms = _busy_us(spans) / 1e3 / rounds
    span_ms = (max(e for _, e in spans) - min(s for s, _ in spans)) \
        / 1e3 / rounds
    sort_ms = sum(us for name, (us, _) in by_name.items()
                  if "sort" in name.lower()) / 1e3 / rounds
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    grouped = {}
    for group, frags in (groups or {}).items():
        hits = [v for k, v in by_name.items()
                if any(f in k for f in frags)]
        grouped[group] = {
            "ms_per_round": sum(us for us, _ in hits) / 1e3 / rounds,
            "calls_per_round": sum(n for _, n in hits) / rounds}
    return {**({"groups": grouped} if groups else {}),
            "profiler_activities": [str(a).split(".")[-1]
                                    for a in activities],
            "wall_ms_per_round": wall_ms,
            "device_busy_ms_per_round": busy_ms,
            "kernel_ms_per_round": kernel_ms,
            "device_streams": len(streams),
            "device_idle_share": 1.0 - busy_ms / wall_ms,
            "traced_span_ms_per_round": span_ms,
            "device_idle_share_traced": 1.0 - busy_ms / span_ms,
            "sort_ms_per_round": sort_ms,
            "sort_share_of_device": sort_ms / busy_ms,
            "top_device_ops": [{"name": k[:80],
                                "ms_per_round": us / 1e3 / rounds,
                                "calls_per_round": n / rounds}
                               for k, (us, n) in top]}


#: cuda vs cpu, relative L2 of the params after round 1 and round 2.  Only
#: the reduction order differs (cuDNN vs the CPU's convolutions), and the
#: 15 local SGD steps a round on random labels grow that difference about
#: fortyfold a round: this phase measured 4.6e-5 after round 1 and 2.1e-3
#: after round 2 on an H100.  The bounds leave about tenfold room.
CROSS_TOL = {1: 5e-4, 2: 2e-2}


def _cross_device(torch, work, phase, raw, task, tol, extra=None,
                  extra_tol=None):
    """The same config on cuda twice (kernels) and on cpu once (plain
    versions), saving a checkpoint every round: the two cuda runs are
    bitwise equal, and cuda agrees with cpu within ``tol`` (relative L2 of
    the params after each round it names).  ``extra(server)`` names more
    of a run's final state (``{name: tensor}``), held alike: bitwise
    between the cuda runs, within ``extra_tol[name]`` (relative L2)
    against cpu."""
    params, more, secs = {}, {}, {}
    for tag, device in (("cuda", "cuda"), ("cuda_again", "cuda"),
                        ("cpu", "cpu")):
        server, _, secs[tag] = _run_cli(work, f"{phase}_{tag}", raw, device,
                                        task=task)
        params[tag] = [server.ckpt.load(torch.device("cpu"),
                                        f"epoch{r}.pt").params.double()
                       for r in tol]
        more[tag] = {k: v.double().cpu()
                     for k, v in (extra(server) if extra else {}).items()}
        del server
    check(all(torch.equal(a, b) for a, b in zip(params["cuda"],
                                                params["cuda_again"])) and
          all(torch.equal(v, more["cuda_again"][k])
              for k, v in more["cuda"].items()),
          f"{phase}: two cuda runs of one config differ")
    rel = {r: float((a - b).norm() / b.norm())
           for r, a, b in zip(tol, params["cuda"], params["cpu"])}
    for r in rel:
        check(rel[r] <= tol[r], f"{phase}: cuda vs cpu params after round "
                                f"{r}: rel L2 {rel[r]} > {tol[r]}")
    rel_more = {k: float((v - more["cpu"][k]).norm() / more["cpu"][k].norm())
                for k, v in more["cuda"].items()}
    for k, v in rel_more.items():
        check(v <= extra_tol[k], f"{phase}: cuda vs cpu {k}: rel L2 {v} > "
                                 f"{extra_tol[k]}")
    emit({"phase": phase, "ok": True, "rounds": len(tol),
          "cuda_reproducible": True,
          "rel_l2_by_round": rel, "tolerance_rel_l2_by_round": tol,
          **({"rel_l2_final": rel_more, "tolerance_rel_l2_final": extra_tol}
             if extra else {}),
          "seconds": {k: round(v, 3) for k, v in secs.items()}})


def _small_femnist(work):
    """A 40-writer FEMNIST-shaped blob (4 val, 4 test) beside ``main``'s:
    the legs that run one config three times keep its per-writer sizes
    and spend seconds, not most of the phase, loading it."""
    data_dir = "femnist_small"
    if not os.path.isdir(os.path.join(work, data_dir)):
        os.makedirs(os.path.join(work, data_dir))
        for split, users, seed in (("train", 40, 5), ("val", 4, 6),
                                   ("test", 4, 7)):
            write_femnist_blob(os.path.join(work, data_dir,
                                            f"{split}.json"),
                               users, 50, 300, seed)
    return data_dir


def phase_cross_device(torch, work):
    """2 CNN_FEMNIST rounds of 4 clients with dropout off
    (:func:`_cross_device`), on :func:`_small_femnist`'s writers: the cpu
    run is the phase's cost."""
    raw = _set_data(json.loads(json.dumps(CNN_CONFIG)), _small_femnist(work))
    raw["model_config"].update(dropout1=0.0, dropout2=0.0)
    raw["server_config"].update(max_iteration=2, val_freq=100, rec_freq=100,
                                initial_val=False, rounds_per_step=1,
                                model_backup_freq=1,
                                num_clients_per_iteration=4)
    _cross_device(torch, work, "cross_device", raw, "cv_cnn_femnist",
                  CROSS_TOL)


# ----------------------------------------------------------------------
#: the pipeline phase: ``main``'s CNN_FEMNIST config (P = 1,206,590, 10
#: clients at batch 20, the 350 writers, ``pallas_apply``) for 8 rounds
#: with one val eval at the end, so that one-round chunks overlap in the
#: ring; each ``(pipeline_depth, rounds_per_step)``
PIPELINE_ROUNDS = 8
PIPELINE_SETTINGS = ((0, 1), (1, 1), (2, 1), (0, 25), (1, 25), (2, 25))
#: the rounds of each timed window of a loop profile (4, and one pass
#: over the settings, forward then back, since the fused_carry phase
#: came: 8 and three before), and the rounds of
#: its warm-up and traced windows (the profiler's cost grows with each
#: traced launch); and the loop's settings: ``(name, pipeline_depth,
#: input_staging)``
LOOP_ROUNDS = 4
LOOP_PASSES = 1
LOOP_TRACE_ROUNDS = 2
LOOP_SETTINGS = (("depth0_per_leaf", 0, False), ("depth0", 0, True),
                 ("depth1", 1, True), ("depth2", 2, True))
#: the host split's ``run_stats`` keys
HOST_SPLIT = ("secsPerRoundPack", "secsPerRoundStage",
              "secsPerRoundDispatch", "secsPerRoundDrainWait",
              "secsPerRoundHostTail", "secsPerRoundCkptSubmit")


def pipeline_config(depth, rps, rounds=PIPELINE_ROUNDS, staging=True):
    raw = json.loads(json.dumps(CNN_CONFIG))
    raw["server_config"].update(
        max_iteration=rounds, val_freq=PIPELINE_ROUNDS, rec_freq=1000,
        initial_val=False, pipeline_depth=depth, rounds_per_step=rps,
        input_staging=staging)
    return raw


#: the datasets :func:`_install_parse_cache` parsed, by config and by the
#: size and mtime of each file it names: a run reads its datasets and never
#: writes them, so the runs that read one blob share one parse (the 350
#: writers take the CLI seconds to parse, and most phases start several
#: runs on one blob)
_PARSED = {}
#: model_config keys that shape the network and never the data: runs that
#: differ in these alone share a parse
_MODEL_ONLY = ("dtype", "dropout1", "dropout2", "pretrained_model_path",
               "flash_attention")


def _file_stats(obj):
    """``(path, size, mtime_ns)`` of every existing file that a config
    value names, so that a blob written anew is parsed anew."""
    from collections.abc import Mapping
    if isinstance(obj, Mapping):
        return [s for v in obj.values() for s in _file_stats(v)]
    if isinstance(obj, (list, tuple)):
        return [s for v in obj for s in _file_stats(v)]
    if isinstance(obj, str) and os.path.isfile(obj):
        st = os.stat(obj)
        return [(obj, st.st_size, st.st_mtime_ns)]
    return []


def _install_parse_cache():
    """``e2e_trainer.build_task_datasets`` that parses each blob once for
    every run of the script; returns ``restore``."""
    from msrflute_tpu_torch import e2e_trainer
    parse = e2e_trainer.build_task_datasets

    def shared(cfg, task):
        model = {k: v for k, v in cfg.model_config.items()
                 if k not in _MODEL_ONLY}
        named = [cfg.client_config.data_config.train,
                 cfg.server_config.data_config.val,
                 cfg.server_config.data_config.test, model]
        key = json.dumps([named, _file_stats(named)], sort_keys=True,
                         default=str)
        if key not in _PARSED:
            _PARSED[key] = parse(cfg, task)
        return _PARSED[key]

    def restore():
        e2e_trainer.build_task_datasets = parse

    e2e_trainer.build_task_datasets = shared
    return restore


def _mean(values):
    return float(sum(values) / len(values)) if values else None


def _host_split(server):
    return {key: _mean(server.run_stats[key]) for key in HOST_SPLIT}


def _sync_points(torch, fn):
    """``fn()`` under ``torch.cuda.set_sync_debug_mode``: first "warn",
    recording where a synchronizing call was made (file:line,
    ``msrflute_tpu_torch/utils/strict.py::sync_points``, the check strict
    transfer mode makes), then "error".  Returns the recorded places; the
    phase fails on any."""
    from msrflute_tpu_torch.utils.strict import sync_debug_mode, sync_points
    places = sync_points(fn, HERE)
    check(not places, f"synchronizing calls in the dispatch half: {places}")
    torch.cuda.synchronize()
    with sync_debug_mode("error"):
        fn()
    return places


def _dispatch_half(torch, server, client_lr=0.1, server_lr=1.0,
                   quant_threshold=None):
    """One round's dispatch half through the server's own calls: the
    chaos vectors, :meth:`dispatch_rounds` (staging, the round, the stats'
    copy) and the ``latest`` snapshot, under :func:`_sync_points`.  The
    packing (numpy, before any device call) runs first.  Returns the
    places of synchronizing calls (none, or the phase failed)."""
    from msrflute_tpu_torch.data.batching import pack_round_batches
    sampled = server._sample()
    batch = pack_round_batches(
        server.train_dataset, sampled, server.batch_size,
        server._chunk_steps([sampled]), rng=server._np_rng,
        desired_max_samples=server.desired_max_samples)
    state = server.state
    out = []

    def dispatch():
        new, packed = server.engine.dispatch_rounds(
            state, [batch], [client_lr], [server_lr],
            quant_thresholds=[quant_threshold],
            chaos_vecs=[server.chaos_vectors(state.round, batch)])
        server.ckpt.snapshot(new)
        out.append(packed)

    torch.cuda.synchronize()
    places = _sync_points(torch, dispatch)
    stats = [{k: v for k, v in p.fetch()[0].items() if k != "privacy"}
             for p in out]
    check(len(stats) == 2 and stats[0] == stats[1] and
          math.isfinite(stats[0]["train_loss_sum"]),
          f"dispatch half: stats {stats}")
    return places


def phase_pipeline(torch, work, kernel_rows):
    """``main``'s config through the CLI at every ``PIPELINE_SETTINGS``
    entry: params bitwise equal across depths at one chunk size, B1 once a
    local step at each setting, secs/round, the host split and the chunks
    drained behind a later dispatch; a run cut after round 4 and resumed
    to 8 at depth 1, bitwise; one CNN round's dispatch half with no
    synchronizing call (:func:`_sync_points`)."""
    settings, params, servers = {}, {}, {}
    for depth, rps in PIPELINE_SETTINGS:
        name = f"pipeline_d{depth}_r{rps}"
        _reset_counts()
        server, _, secs = _run_cli(work, name,
                                   pipeline_config(depth, rps), "cuda")
        launches = _read_counts()
        steps = server.engine.local_steps
        want = {k: 0 for k in launches}
        want["fused_sgd_apply"] = steps
        check(steps > 0 and launches == want,
              f"{name}: launches {launches}, want {want}")
        for row in kernel_rows:
            row.setdefault("launches_by_path", {})[name] = \
                launches[row["name"]]
        rounds = server.run_stats["secsPerRound"]
        check(len(rounds) == PIPELINE_ROUNDS and
              all(map(math.isfinite, rounds)), f"{name}: {rounds}")
        params[(depth, rps)] = server.state.params.cpu()
        settings[name] = {
            "pipeline_depth": depth, "rounds_per_step": rps,
            "secs_per_round": _mean(rounds),
            "secs_per_round_after_first": _mean(rounds[1:]),
            "secs_per_round_series": rounds,
            "host_split": _host_split(server),
            "housekeeping_secs": _mean(
                server.run_stats["secsPerRoundHousekeeping"]),
            "pipelined_chunks": server.pipelined_chunks,
            "checkpoint_async": server.ckpt.async_latest,
            "local_steps": steps, "b1_launches":
                launches["fused_sgd_apply"],
            "run_seconds": round(secs, 3)}
        servers[(depth, rps)] = server
    for (depth, rps), p in params.items():
        check(torch.equal(p, params[(0, rps)]),
              f"pipeline: depth {depth} at rounds_per_step {rps} "
              "differs from depth 0")
    check(servers[(1, 1)].pipelined_chunks == PIPELINE_ROUNDS - 1,
          "pipeline: the depth-1 ring overlapped "
          f"{servers[(1, 1)].pipelined_chunks} chunks")
    # cut after round 4, resumed to 8 at depth 1
    _run_cli(work, "pipeline_resume", pipeline_config(1, 1, rounds=4),
             "cuda")
    raw = pipeline_config(1, 1)
    raw["server_config"]["resume_from_checkpoint"] = True
    resumed, _, _ = _run_cli(work, "pipeline_resume", raw, "cuda")
    check(resumed.state.round == PIPELINE_ROUNDS and
          torch.equal(resumed.state.params.cpu(), params[(1, 1)]),
          "pipeline: the depth-1 resume differs from the uninterrupted "
          "run")
    del resumed
    places = _dispatch_half(torch, servers[(1, 1)])
    servers.clear()
    torch.cuda.empty_cache()
    emit({"phase": "pipeline", "ok": True, "rounds": PIPELINE_ROUNDS,
          "params": MAIN_P, "clients_per_round": MAIN_K, "writers": 350,
          "settings": settings, "bitwise_across_depths": True,
          "resume_bitwise": True, "dispatch_sync_points": places,
          "main_secs_per_round_after_first": MAIN_SECS.get("after_first")})
    return params[(2, 1)], settings["pipeline_d2_r1"]


#: the telemetry phase's block: every part on, rollups every 2 rounds, the
#: watchdog's defaults and a profiled window over round 2
TELEMETRY_BLOCK = {"enable": True, "trace": True, "devbus": True,
                   "xla": True, "scorecard": True, "rollup": True,
                   "rollup_window": 2, "flight": True,
                   "profile_rounds": "2:3"}
#: the spans the telemetry path's trace holds
TELEMETRY_SPANS = ("pack", "dispatch", "round_device", "stats_fetch",
                   "host_tail", "housekeeping", "ckpt_submit",
                   "ckpt_async_write", "eval", "eval_device")


def _kernel_events(torch, path, name):
    """Kernel events named ``name`` in a ``torch.profiler`` Chrome trace."""
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    return sum(1 for e in events if e.get("cat") == "kernel"
               and name in str(e.get("name", "")))


def phase_telemetry(torch, work, kernel_rows, pipeline):
    """``pipeline_config(2, 1)`` of the ``pipeline`` phase again through
    the CLI with the whole ``server_config.telemetry`` block on and
    ``MSRFLUTE_STRICT_TRANSFERS=1`` (the dispatch half of every chunk under
    ``set_sync_debug_mode("error")``): params bitwise that phase's depth-2
    run; ``trace.json`` with every span; ``summarize``'s overlap at two
    rounds in flight; every round's ``devbus/update_ratio`` finite and
    positive; the profiled window (round 2) holding B1's kernel 15 times;
    B1 once a local step, bitwise its plain version on the path's first
    operands; no synchronizing call in a dispatch half with telemetry on;
    the counted FLOPs a round, the live MFU and the peak allocation beside
    secs/round with telemetry on and off; then a two-round ``nan_loss:
    abort`` drill (every payload NaN from round 0) that leaves
    ``flight.json`` and the scorecard."""
    from msrflute_tpu_torch.telemetry import WatchdogAbort
    from msrflute_tpu_torch.telemetry.scope_cli import summarize
    from msrflute_tpu_torch.utils.strict import ENV_FLAG
    off_params, off = pipeline
    raw = pipeline_config(2, 1)
    raw["server_config"]["telemetry"] = dict(TELEMETRY_BLOCK)
    os.environ[ENV_FLAG] = "1"
    _reset_counts()
    try:
        with _Operands() as cap:
            server, out, secs = _run_cli(work, "telemetry", raw, "cuda")
    finally:
        os.environ.pop(ENV_FLAG, None)
    torch.cuda.synchronize()
    launches = _read_counts()
    steps = server.engine.local_steps
    want = {k: 0 for k in launches}
    want["fused_sgd_apply"] = steps
    check(steps == PIPELINE_ROUNDS * 15 and launches == want,
          f"telemetry: launches {launches}, want {want}")
    for row in kernel_rows:
        row.setdefault("launches_by_path", {})["telemetry"] = \
            launches[row["name"]]
    check(torch.equal(server.state.params.cpu(), off_params),
          "telemetry: params differ from the pipeline phase's depth-2 run")
    # the async writer ran beside the strict scope: every save landed
    check(server.ckpt.escalator.total == 0,
          f"telemetry: {server.ckpt.escalator.total} failed saves")
    tdir = os.path.join(out, "models", "telemetry")
    with open(os.path.join(tdir, "trace.json")) as fh:
        spans = {e["name"] for e in json.load(fh)["traceEvents"]
                 if e.get("ph") == "X"}
    missing = [s for s in TELEMETRY_SPANS if s not in spans]
    check(not missing, f"telemetry: spans {missing} not in trace.json")
    overlap = summarize(os.path.join(out, "models")).get("overlap") or {}
    check(overlap.get("max_rounds_in_flight", 0) >= 2,
          f"telemetry: overlap {overlap}")
    ratios = []
    with open(os.path.join(tdir, "events.jsonl")) as fh:
        for line in fh:
            rec = json.loads(line)
            if rec.get("kind") == "counter" and \
                    rec["name"] == "devbus/update_ratio":
                ratios.append(rec["value"])
    check(len(ratios) == PIPELINE_ROUNDS and
          all(math.isfinite(r) and r > 0 for r in ratios),
          f"telemetry: update_ratio {ratios}")
    prof = server.scope.profiler
    check(prof.captured and prof.path is not None,
          "telemetry: the profile_rounds window was not written")
    b1_in_window = _kernel_events(torch, prof.path, "fused_sgd_kernel")
    check(b1_in_window == 15,
          f"telemetry: {b1_in_window} B1 kernels in the profiled round")
    held = _hold_operands(torch, cap.ops)
    places = _dispatch_half(torch, server)
    with open(os.path.join(tdir, "scorecard.json")) as fh:
        card = json.load(fh)
    entry = card["entry_points"]["staged_r1"]
    mfu_p50 = card["mfu_p50"]
    check(mfu_p50 is not None and 0 < mfu_p50 <= 1.05,
          f"telemetry: mfu_p50 {mfu_p50}")
    on_rounds = server.run_stats["secsPerRound"]
    # the rounds after the profiled window: before it, round 0's counted
    # dispatch (every op through the cost mode) lands on the fence-to-fence
    # times of rounds 0 and 1, and the window's edges wait for the card
    hi = prof.window[1]
    on_plain = on_rounds[hi:]
    off_plain = off["secs_per_round_series"][hi:]
    hand = server.engine.xla.entries["staged_r1"].get("hand_kernels")
    del server
    # the abort drill: every payload NaN from round 0, so round 1's loss
    # is the first NaN and its drain raises
    drill = pipeline_config(2, 1, rounds=2)
    drill["server_config"]["telemetry"] = dict(TELEMETRY_BLOCK,
                                               profile_rounds=None)
    drill["server_config"]["chaos"] = {"seed": 1, "corrupt_nan_rate": 1.0}
    aborted = None
    try:
        _run_cli(work, "telemetry_abort", drill, "cuda")
    except WatchdogAbort as exc:
        aborted = str(exc)
    ddir = os.path.join(work, "out_telemetry_abort", "models", "telemetry")
    with open(os.path.join(ddir, "flight.json")) as fh:
        flight = json.load(fh)
    check(aborted is not None and "nan_loss" in aborted and
          os.path.exists(os.path.join(ddir, "scorecard.json")) and
          flight["reasons"][0]["reason"] == "exception: WatchdogAbort",
          f"telemetry: the nan_loss drill left {flight.get('reasons')}, "
          f"raised {aborted}")
    torch.cuda.empty_cache()
    emit({"phase": "telemetry", "ok": True, "card": CARD.get("name_power"),
          "rounds": PIPELINE_ROUNDS, "b1_launches": steps,
          "b1_in_profiled_round": b1_in_window, "b1_held": held,
          "spans": sorted(spans), "max_rounds_in_flight":
              overlap["max_rounds_in_flight"],
          "overlap_efficiency_pct": overlap.get("efficiency_pct"),
          "update_ratio": ratios, "dispatch_sync_points": places,
          "strict_transfers_run": True,
          "flops_per_round": entry["flops"] / entry["rounds"],
          "bytes_per_round": entry["bytes_accessed"] / entry["rounds"],
          "hand_kernels_counted": hand,
          "mfu_p50": mfu_p50, "hbm_peak_bytes": card["hbm_peak_bytes"],
          "chip": card.get("chip"), "compiles": card["compiles"],
          "recompiles": card["recompiles"],
          "secs_per_round": {"telemetry_on": on_rounds,
                             "telemetry_off": off["secs_per_round_series"]},
          "secs_per_round_after_window": {
              "telemetry_on": _mean(on_plain),
              "telemetry_off": _mean(off_plain)},
          "rollup_windows": card["rollup_windows"],
          "watchdog_fires": card["watchdog_fires"],
          "abort_drill": {"raised": aborted[:200],
                          "flight_events": len(flight["events"])},
          "run_seconds": round(secs, 3)})


def _rescaled(traced, n):
    """:func:`_trace_rounds`'s figures for one call of ``n`` rounds, per
    round."""
    out = dict(traced)
    for key in list(out):
        if key.endswith("_per_round") and isinstance(out[key], float):
            out[key] = out[key] / n
    out["top_device_ops"] = [
        {**op, "ms_per_round": op["ms_per_round"] / n,
         "calls_per_round": op["calls_per_round"] / n}
        for op in traced["top_device_ops"]]
    return out


def phase_pipeline_profile(torch, work, rounds=LOOP_ROUNDS):
    """The device's busy and idle share through the server's own loop
    (packing, staging, the ring, the host tail, housekeeping, the
    ``latest`` saves) at each ``LOOP_SETTINGS`` entry: ``main``'s config
    on one-round chunks, each window a call of ``train`` (which ends in
    its full drain).  Each setting first runs :func:`_trace_rounds` on
    windows of ``LOOP_TRACE_ROUNDS`` rounds (one to warm up, one timed,
    one under ``torch.profiler``); then the host clock times windows of
    ``rounds`` rounds in turns, ``LOOP_PASSES`` times A B C D D C B A.
    ``device_idle_share`` is the traced busy time over the turns' mean
    wall time; each setting's gain on depth 0 (staged) is also given turn
    by turn (its k-th window against depth 0's k-th), so the spread
    between turns stands beside it; ``profile``'s engine-only round of
    this call stands beside it."""
    servers = {}
    for name, depth, staging in LOOP_SETTINGS:
        raw = pipeline_config(depth, 1, rounds=1, staging=staging)
        raw["server_config"]["val_freq"] = 1000
        servers[name] = _run_cli(work, f"loop_{name}", raw, "cuda")[0]

    def run(server, n=rounds):
        server.config.server_config["max_iteration"] = \
            server.state.round + n
        server.train()

    traced, walls, splits = {}, {n: [] for n in servers}, {}
    for name, server in servers.items():
        traced[name] = _rescaled(_trace_rounds(
            torch, lambda: run(server, LOOP_TRACE_ROUNDS), 1,
            f"loop_{name}"), LOOP_TRACE_ROUNDS)
    for name in (list(servers) + list(reversed(servers))) * \
            LOOP_PASSES:
        server = servers[name]
        first = len(server.run_stats["secsPerRound"])
        torch.cuda.synchronize()
        tic = time.time()
        run(server)
        torch.cuda.synchronize()
        walls[name].append((time.time() - tic) * 1e3 / rounds)
        for key in HOST_SPLIT:
            splits.setdefault(name, {}).setdefault(key, []).extend(
                server.run_stats[key][first:])
    loops = {}
    for name, depth, staging in LOOP_SETTINGS:
        t, wall = traced[name], _mean(walls[name])
        loops[name] = {
            "pipeline_depth": depth, "input_staging": staging,
            "pipelined_chunks": servers[name].pipelined_chunks,
            "wall_ms_per_round_turns": walls[name],
            "wall_ms_per_round": wall,
            "wall_ms_per_round_median": float(
                sorted(walls[name])[len(walls[name]) // 2]),
            "gain_on_depth0_per_turn": [
                1.0 - w / w0 for w, w0 in zip(walls[name],
                                              walls["depth0"])],
            "device_busy_ms_per_round": t["device_busy_ms_per_round"],
            "device_idle_share":
                1.0 - t["device_busy_ms_per_round"] / wall,
            "host_split_ms": {k: _mean(v) * 1e3
                              for k, v in splits[name].items()},
            "traced": {k: t[k] for k in (
                "wall_ms_per_round", "kernel_ms_per_round",
                "device_idle_share", "device_idle_share_traced",
                "top_device_ops")}}
    servers.clear()
    emit({"phase": "pipeline_profile", "ok": True, "rounds": rounds,
          "loops": loops,
          "engine_only_profile": F32_PROFILE.get("profile")})


# ----------------------------------------------------------------------
#: the DGA path's synthetic Reddit population: (users, utterances lo, hi)
REDDIT_SPLITS = (("train", 1000, 20, 400, 10), ("val", 100, 20, 400, 11),
                 ("test", 100, 20, 400, 12))
DGA_ROUNDS = 5


def write_reddit_vocab(path, size=10_000):
    words = ["<unk>"] + [f"w{i:05d}" for i in range(1, size)]
    with open(path, "w") as fh:
        fh.write("\n".join(words) + "\n")
    return words


def write_reddit_blob(path, words, num_users, lo, hi, seed):
    """A Reddit-shaped user blob: ``lo..hi`` utterances a user of 5-25
    words, drawn with Zipf frequencies over the vocabulary (rank r with
    weight 1 / r), 2% of them outside it."""
    import numpy as np
    rng = np.random.default_rng(seed)
    counts = rng.integers(lo, hi + 1, size=num_users)
    lens = rng.integers(5, 26, size=int(counts.sum()))
    ranks = np.arange(1, len(words))
    p = 1.0 / ranks
    ids = rng.choice(ranks, size=int(lens.sum()), p=p / p.sum())
    vocab = np.asarray(words + ["zzoov"], dtype=object)
    ids[rng.random(ids.shape[0]) < 0.02] = len(words)      # unk words
    tokens = vocab[ids]
    ends = np.cumsum(lens)
    utts = [" ".join(tokens[e - n:e]) for e, n in zip(ends, lens)]
    users = [f"u{seed}_{i:04d}" for i in range(num_users)]
    data, pos = {}, 0
    for u, n in zip(users, counts.tolist()):
        data[u] = {"x": utts[pos:pos + n]}
        pos += n
    with open(path, "w") as fh:
        json.dump({"users": users, "num_samples": counts.tolist(),
                   "user_data": data}, fh)
    return int(counts.sum())


def dga_config(rounds=DGA_ROUNDS):
    """``experiments/nlg_gru/config.yaml`` plus the DP values of
    ``experiments/mlm_bert/config.yaml``, global DP, mlm_bert's
    quantization and ``pallas_apply``; data paths to the synthetic blob."""
    import yaml
    with open(os.path.join(HERE, "experiments", "nlg_gru",
                           "config.yaml")) as fh:
        raw = yaml.safe_load(fh)
    vocab = "reddit/vocab_reddit.vocab"
    raw["model_config"].update(vocab_dict=vocab, quant_threshold=0.7,
                               quant_bits=10)
    raw["dp_config"] = {"enable_local_dp": True, "eps": 100.0,
                        "delta": 1e-7, "max_grad": 1.0,
                        "max_weight": 10000.0, "min_weight": 0.0,
                        "weight_scaler": 0.0001, "enable_global_dp": True,
                        "global_sigma": 1.0}
    sc = raw["server_config"]
    sc.update(max_iteration=rounds, val_freq=rounds, rec_freq=rounds,
              model_backup_freq=rounds, megakernel={"pallas_apply": True})
    sc["data_config"]["val"].update(val_data="reddit/val.json",
                                    vocab_dict=vocab)
    sc["data_config"]["test"].update(test_data="reddit/test.json",
                                     vocab_dict=vocab)
    raw["client_config"]["data_config"]["train"].update(
        list_of_train_data="reddit/train.json", vocab_dict=vocab)
    return raw


def phase_dga(torch, work, kernel_rows):
    import numpy as np
    os.makedirs(os.path.join(work, "reddit"), exist_ok=True)
    tic = time.time()
    words = write_reddit_vocab(os.path.join(work, "reddit",
                                            "vocab_reddit.vocab"))
    sizes = {split: write_reddit_blob(
        os.path.join(work, "reddit", f"{split}.json"), words, users, lo, hi,
        seed) for split, users, lo, hi, seed in REDDIT_SPLITS}
    blob_s = time.time() - tic

    _reset_counts()
    server, out, secs = _run_cli(work, "dga", dga_config(), "cuda",
                                 task="nlg_gru")
    launches = _read_counts()

    check(server.state.params.is_cuda, "server params are not on cuda")
    check(server.engine.layout.numel == DGA_P,
          f"GRU LM has {server.engine.layout.numel} params")
    check(all(t.is_cuda for t in server.state.opt_state.values()),
          "adam's state is not on cuda")
    steps = server.engine.local_steps
    check(launches["fused_gaussian_noise"] == DGA_ROUNDS,
          f"fused_gaussian_noise launched {launches['fused_gaussian_noise']}"
          f" times in {DGA_ROUNDS} rounds")
    check(launches["quant_bin_sparsify"] == DGA_ROUNDS,
          f"quant_bin_sparsify launched {launches['quant_bin_sparsify']} "
          f"times in {DGA_ROUNDS} rounds")
    check(launches["fused_sgd_apply"] == steps > 0,
          f"fused_sgd_apply launched {launches['fused_sgd_apply']} times "
          f"for {steps} local steps")
    check(not any(_flash_launch_counts(launches).values()),
          f"flash attention launched on the DGA path: {launches}")
    with open(os.path.join(out, "log", "metrics.jsonl")) as fh:
        records = [json.loads(line) for line in fh]
    named = lambda n: [r["value"] for r in records  # noqa: E731
                       if r.get("name") == n]
    train_loss = named("Training loss")
    check(len(train_loss) == DGA_ROUNDS and
          all(map(math.isfinite, train_loss)),
          f"training losses {train_loss}")
    thresh = named("Quantization Thresh.")
    check(len(thresh) == DGA_ROUNDS, f"Quantization Thresh. {thresh}")
    check(all(math.isfinite(h["loss"]) for h in server.history),
          f"non-finite eval loss: {server.history}")
    models = os.path.join(out, "models")
    for f in ("latest_model.pt", "latest_model.pt.sum", "status_log.json",
              "best_val_loss_model.pt", f"epoch{DGA_ROUNDS}.pt"):
        check(os.path.exists(os.path.join(models, f)), f"missing {f}")
    with open(os.path.join(models, "status_log.json")) as fh:
        status = json.load(fh)
    check(status["i"] == DGA_ROUNDS and "quant_thresh" in status,
          f"status_log.json: {status}")
    for row in kernel_rows:
        row.setdefault("launches_by_path", {})["dga"] = launches[row["name"]]
        if row["name"] in ("fused_gaussian_noise", "quant_bin_sparsify"):
            row["launches"] = launches[row["name"]]
    rounds = server.run_stats["secsPerRound"]
    # the DGA round's dispatch half (B1, local DP, B3, B2) makes no
    # synchronizing call either
    places = _dispatch_half(torch, server, client_lr=1.0, server_lr=0.001,
                            quant_threshold=0.7)
    emit({"phase": "dga", "ok": True, "device": "cuda",
          "dispatch_sync_points": places,
          "params": DGA_P, "users": {s[0]: s[1] for s in REDDIT_SPLITS},
          "utterances": sizes, "population_note":
              "LEAF Reddit's population cut to 1,000 train users with "
              "20-400 utterances of 5-25 words, 100 val and 100 test "
              "users (synthetic Zipf data, 10,000-word vocabulary)",
          "blob_seconds": round(blob_s, 3), "run_seconds": round(secs, 3),
          "rounds": len(rounds), "secs_per_round": rounds,
          "secs_per_round_after_first": float(np.mean(rounds[1:])),
          "local_steps": steps, "launches": launches,
          "train_loss": train_loss, "quant_thresh": thresh,
          "evals": [{"split": h["split"], "round": h["round"],
                     "loss": h["loss"], "acc": h["acc"]}
                    for h in server.history]})
    return server


#: cuda vs cpu on the DGA path, relative L2 of the params after round 1 and
#: round 2.  Both devices draw the same global-DP bits (the Philox stream)
#: and quantize with the same thresholds up to float32 order, so only
#: reduction order differs: this phase measured 4.5e-8 after round 1 and
#: 5.1e-8 after round 2 on three H100s with the path's 10 clients (4 since
#: PR 13, which cut the cpu run's depth).  An
#: element that lands on another quantization level, or an adam step of
#: another sign (each moves a parameter by about 2 lr = 2e-3), breaks the
#: bound.
DGA_CROSS_TOL = {1: 1e-6, 2: 1e-6}


#: rounds of the DGA path with DP off, whose val loss must fall
DGA_LEARN_ROUNDS = 3


def phase_dga_learns(torch, work):
    """The DGA path on cuda with local and global DP off (quantization and
    B1 on) for ``DGA_LEARN_ROUNDS`` rounds: the val loss after the last
    round is below the initial one.  The ``dga`` phase cannot show that:
    its local-DP noise swamps every update, so its val loss stays at
    ln(10,000) however the path computes."""
    raw = dga_config(rounds=DGA_LEARN_ROUNDS)
    raw["dp_config"].update(enable_local_dp=False, enable_global_dp=False)
    _reset_counts()
    server, _, secs = _run_cli(work, "dga_learns", raw, "cuda",
                               task="nlg_gru")
    launches = _read_counts()
    check(launches["quant_bin_sparsify"] == DGA_LEARN_ROUNDS and
          launches["fused_gaussian_noise"] == 0 and
          launches["fused_sgd_apply"] == server.engine.local_steps > 0,
          f"dga_learns launches {launches}")
    val = [(h["round"], h["loss"]) for h in server.history
           if h["split"] == "val"]
    check(len(val) >= 2 and val[0][0] == 0 and
          val[-1][0] == DGA_LEARN_ROUNDS and
          all(math.isfinite(v) for _, v in val), f"val losses {val}")
    check(val[-1][1] < val[0][1],
          f"val loss did not fall with DP off: {val}")
    emit({"phase": "dga_learns", "ok": True, "rounds": DGA_LEARN_ROUNDS,
          "val_loss_by_round": {r: v for r, v in val},
          "val_loss_drop": val[0][1] - val[-1][1], "launches": launches,
          "run_seconds": round(secs, 3)})


def phase_cross_device_dga(torch, work):
    """2 DGA rounds of 2 clients of at most 128 samples, 2 local steps
    (the path takes 10 clients of 1,600; the GRU's cpu run is the phase's
    cost), local DP off, global DP and quantization on
    (:func:`_cross_device`)."""
    raw = dga_config(rounds=2)
    raw["dp_config"]["enable_local_dp"] = False
    raw["server_config"].update(val_freq=100, rec_freq=100,
                                initial_val=False, model_backup_freq=1,
                                num_clients_per_iteration=2)
    raw["client_config"]["desired_max_samples"] = 128
    _cross_device(torch, work, "dga_cross_device", raw, "nlg_gru",
                  DGA_CROSS_TOL)


# ----------------------------------------------------------------------
#: the RingLM path's synthetic long-text population: (split, users, fewest
#: and most documents a user, seed)
RINGLM_SPLITS = (("train", 500, 4, 24, 30), ("val", 50, 4, 24, 31),
                 ("test", 50, 4, 24, 32))
RINGLM_ROUNDS = 5
#: a document's length in chars: every row fills the 1,023-token window
DOC_CHARS = 1100
#: tools/create_data.py's word list, whose "phrase soup" the documents are
LONGTEXT_WORDS = (
    "the of and to in a is that it was for on are with as his they at be "
    "this have from or one had by word but not what all were we when "
    "your can said there use an each which she do how their if").split()


def write_longtext_blob(path, num_users, lo, hi, seed):
    """A long-text user blob in the style of ``tools/create_data.py``'s
    ``ringlm`` task: ``lo..hi`` documents a user, each a soup of words drawn
    from ``LONGTEXT_WORDS`` and cut to ``DOC_CHARS`` chars."""
    import numpy as np
    rng = np.random.default_rng(seed)
    counts = rng.integers(lo, hi + 1, size=num_users)
    words = np.asarray(LONGTEXT_WORDS)
    docs = [" ".join(rng.choice(words, size=DOC_CHARS // 2))[:DOC_CHARS]
            for _ in range(int(counts.sum()))]
    check(min(map(len, docs)) == DOC_CHARS, "a document is too short")
    users = [f"t{seed}_{i:04d}" for i in range(num_users)]
    data, pos = {}, 0
    for u, n in zip(users, counts.tolist()):
        data[u] = {"x": docs[pos:pos + n]}
        pos += n
    with open(path, "w") as fh:
        json.dump({"users": users, "num_samples": counts.tolist(),
                   "user_data": data}, fh)
    return int(counts.sum())


def ringlm_config(rounds=RINGLM_ROUNDS, flash=True):
    """``experiments/ringlm/config.yaml`` at its published widths plus
    ``flash_attention`` and ``pallas_apply``, cut to ``rounds`` rounds."""
    import yaml
    with open(os.path.join(HERE, "experiments", "ringlm",
                           "config.yaml")) as fh:
        raw = yaml.safe_load(fh)
    raw["model_config"]["flash_attention"] = flash
    raw["server_config"].update(max_iteration=rounds, val_freq=rounds,
                                rec_freq=rounds, model_backup_freq=rounds,
                                megakernel={"pallas_apply": True})
    return raw


def _flash_launch_counts(launches):
    return {k: launches[k] for k in ("flash_attention_fwd",
                                     "flash_attention_dq",
                                     "flash_attention_dkv")}


def phase_ringlm(torch, work, kernel_rows):
    import numpy as np
    os.makedirs(os.path.join(work, "longtext"), exist_ok=True)
    tic = time.time()
    sizes = {split: write_longtext_blob(
        os.path.join(work, "longtext", f"{split}.json"), users, lo, hi, seed)
        for split, users, lo, hi, seed in RINGLM_SPLITS}
    blob_s = time.time() - tic

    _reset_counts()
    server, out, secs = _run_cli(work, "ringlm", ringlm_config(), "cuda",
                                 task="ringlm")
    launches = _read_counts()

    check(server.state.params.is_cuda, "server params are not on cuda")
    P = server.engine.layout.numel
    check(P == RINGLM_P, f"RingLM has {P} params")
    layers = server.task.module.num_layers
    steps = server.engine.local_steps
    eval_steps = sum(server._eval_batches[h["split"]]["sample_mask"].shape[0]
                     for h in server.history)
    want = {"fused_sgd_apply": steps,
            "flash_attention_fwd": layers * (steps + eval_steps),
            "flash_attention_dq": layers * steps,
            "flash_attention_dkv": layers * steps,
            "fused_gaussian_noise": 0, "quant_bin_sparsify": 0}
    check(steps > 0 and launches == want,
          f"ringlm launches {launches}, want {want}")
    with open(os.path.join(out, "log", "metrics.jsonl")) as fh:
        records = [json.loads(line) for line in fh]
    train_loss = [r["value"] for r in records
                  if r.get("name") == "Training loss"]
    check(len(train_loss) == RINGLM_ROUNDS and
          all(map(math.isfinite, train_loss)), f"training losses {train_loss}")
    check(all(math.isfinite(h["loss"]) for h in server.history),
          f"non-finite eval loss: {server.history}")
    models = os.path.join(out, "models")
    for f in ("latest_model.pt", "latest_model.pt.sum", "status_log.json",
              "best_val_loss_model.pt", f"epoch{RINGLM_ROUNDS}.pt"):
        check(os.path.exists(os.path.join(models, f)), f"missing {f}")
    with open(os.path.join(models, "status_log.json")) as fh:
        check(json.load(fh)["i"] == RINGLM_ROUNDS,
              f"status_log.json is not at round {RINGLM_ROUNDS}")
    val = [(h["round"], h["loss"]) for h in server.history
           if h["split"] == "val"]
    check([r for r, _ in val] == [0, RINGLM_ROUNDS] and val[1][1] < val[0][1],
          f"the val loss did not fall: {val}")
    for row in kernel_rows:
        row.setdefault("launches_by_path", {})["ringlm"] = \
            launches[row["name"]]
        if row["name"].startswith("flash_attention"):
            row["launches"] = launches[row["name"]]
    rounds = server.run_stats["secsPerRound"]
    emit({"phase": "ringlm", "ok": True, "device": "cuda", "params": P,
          "users": {s[0]: s[1] for s in RINGLM_SPLITS},
          "documents": sizes, "population_note":
              "synthetic long-text blob: 500 train users with 4-24 "
              f"documents of {DOC_CHARS} chars, 50 val and 50 test users",
          "blob_seconds": round(blob_s, 3), "run_seconds": round(secs, 3),
          "rounds": len(rounds), "secs_per_round": rounds,
          "secs_per_round_after_first": float(np.mean(rounds[1:])),
          "local_steps": steps, "eval_steps": eval_steps,
          "launches": launches, "train_loss": train_loss,
          "evals": [{"split": h["split"], "round": h["round"],
                     "loss": h["loss"], "acc": h["acc"]}
                    for h in server.history]})
    return server


#: flash vs dense attention on cuda over 2 rounds: relative L2 of the
#: change of the params from the initial weights.  Only the order of the
#: float32 sums differs (the kernels against cuBLAS's einsums and
#: PyTorch's softmax); the JAX package holds one gradient of the two
#: paths to rtol 5e-4 (tests/test_ringlm.py), and two rounds of local
#: SGD compound the difference, so the bound is twice that.
RINGLM_FLASH_DENSE_TOL = 1e-3


def phase_ringlm_flash_vs_dense(torch, work):
    raw = ringlm_config(rounds=2)
    raw["server_config"].update(val_freq=100, rec_freq=100,
                                initial_val=False, model_backup_freq=1)
    final, counts, secs = {}, {}, {}
    for flash in (True, False):
        raw["model_config"]["flash_attention"] = flash
        _reset_counts()
        server, _, secs[flash] = _run_cli(
            work, f"ringlm_flash_{str(flash).lower()}", raw, "cuda",
            task="ringlm")
        counts[flash] = _flash_launch_counts(_read_counts())
        final[flash] = server.state.params.double().cpu()
        init = server.engine.layout.flatten(
            server.task.init_params(0)).double()
    check(all(v > 0 for v in counts[True].values()) and
          not any(counts[False].values()),
          f"flash launches: flash run {counts[True]}, dense run "
          f"{counts[False]}")
    d_flash, d_dense = final[True] - init, final[False] - init
    rel = float((d_flash - d_dense).norm() / d_dense.norm())
    check(rel <= RINGLM_FLASH_DENSE_TOL,
          f"flash vs dense update after 2 rounds: rel L2 {rel}")
    emit({"phase": "ringlm_flash_vs_dense", "ok": True, "rounds": 2,
          "rel_l2_of_update": rel, "tolerance": RINGLM_FLASH_DENSE_TOL,
          "update_norm": float(d_dense.norm()),
          "flash_launches": counts[True],
          "seconds": {"flash": round(secs[True], 3),
                      "dense": round(secs[False], 3)}})


#: cuda vs cpu on the RingLM path, relative L2 of the params after round 1
#: and round 2 (2 clients, one local step of 4 documents a round).  Only
#: the reduction order differs (the kernels and cuBLAS against the CPU's
#: plain attention and GEMMs), about 1e-6 of an update that moves the
#: params by well under 1 %, so some 1e-8; the bound leaves hundredfold
#: room.
RINGLM_CROSS_TOL = {1: 1e-5, 2: 1e-5}


def phase_cross_device_ringlm(torch, work):
    """2 RingLM rounds of one client of one local step, at the published
    widths (:func:`_cross_device`): the cpu leg is cut to what runs in
    seconds."""
    raw = ringlm_config(rounds=2)
    raw["server_config"].update(num_clients_per_iteration=1, val_freq=100,
                                rec_freq=100, initial_val=False,
                                rounds_per_step=1, model_backup_freq=1)
    raw["client_config"]["desired_max_samples"] = 4
    _cross_device(torch, work, "ringlm_cross_device", raw, "ringlm",
                  RINGLM_CROSS_TOL)


# ----------------------------------------------------------------------
#: rounds of the ResNet and Shakespeare paths
FEDAVG_PATH_ROUNDS = 5
#: Fed-CIFAR-100 (500 train clients of 100 images, 100 test clients) cut to
#: what generates and loads in seconds: (split, clients, images a client,
#: seed)
CIFAR100_SPLITS = (("train", 100, 100, 40), ("val", 10, 100, 41),
                   ("test", 10, 100, 42))
#: fed_shakespeare's population, uncut: 715 clients, 16,068 train and
#: 2,356 test lines (means 22.5 and 3.3 a client): (split, clients, fewest
#: and most lines a client, seed)
SHAKESPEARE_SPLITS = (("train", 715, 4, 41, 50), ("val", 715, 1, 6, 51),
                      ("test", 715, 1, 6, 52))
SHAKESPEARE_WORDS = (
    "thou thy thee art hath doth love lord king queen night day sweet "
    "fair death heart good sir my lady what shall be not is the and of "
    "to a in that with for you me it so but his her our if no more "
    "upon come go speak hear now well").split()


def _template_images(rng, n, classes):
    """``n`` 32x32x3 uint8 images (flat) of random classes and the
    classes: each image its class's fixed template (the same in every
    split: a random 4x4 grid of colours, each cell 8x8 pixels) at half
    contrast under uniform noise, so the class can be learned."""
    import numpy as np
    cells = np.random.default_rng(1234).integers(0, 128, (100, 4, 4, 3))
    templates = cells.repeat(8, axis=1).repeat(8, axis=2).reshape(100, -1)
    y = rng.integers(0, classes, n)
    x = (templates[y] + rng.integers(0, 128, (n, 32 * 32 * 3))).astype(
        np.uint8)
    return x, y


def write_cifar100_blob(path, num_users, per_user, seed, classes=100):
    """A Fed-CIFAR-100-shaped blob (CIFAR-10-shaped with ``classes`` 10):
    ``per_user`` 32x32x3 uint8 template images a user
    (:func:`_template_images`)."""
    import numpy as np
    n = num_users * per_user
    x, y = _template_images(np.random.default_rng(seed), n, classes)
    users = [f"c{seed}_{i:04d}" for i in range(num_users)]
    rows = [_pixel_rows(x[i * per_user:(i + 1) * per_user])
            for i in range(num_users)]
    labels = {u: y[i * per_user:(i + 1) * per_user].tolist()
              for i, u in enumerate(users)}
    _write_json_blob(path, users, rows, labels)
    return n


def write_semisup_blob(path, num_users, per_user, seed, classes=10):
    """A CIFAR-10-shaped semisupervision blob: a user holds ``per_user``
    labeled template images (``x``, ``y``) and as many unlabeled ones
    (``ux``, their classes dropped)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    n = num_users * per_user
    x, y = _template_images(rng, n, classes)
    ux, _ = _template_images(rng, n, classes)
    users = [f"l{seed}_{i:04d}" for i in range(num_users)]
    cut = [slice(i * per_user, (i + 1) * per_user) for i in range(num_users)]
    labels = {u: y[c].tolist() for u, c in zip(users, cut)}
    _write_json_blob(path, users, [_pixel_rows(x[c]) for c in cut], labels,
                     streams={"ux": [_pixel_rows(ux[c]) for c in cut]})
    return n


def write_shakespeare_blob(path, num_users, lo, hi, seed):
    """A fed_shakespeare-shaped blob: ``lo..hi`` lines a client, each 80
    chars of a word soup over ``SHAKESPEARE_WORDS`` with capitals and
    punctuation from the char table."""
    import numpy as np
    rng = np.random.default_rng(seed)
    counts = rng.integers(lo, hi + 1, num_users)
    words = np.asarray(SHAKESPEARE_WORDS + [w.capitalize() + p for w in
                                            SHAKESPEARE_WORDS[:12]
                                            for p in (",", ".", "!", "?")])
    lines = [" ".join(rng.choice(words, 24))[:80]
             for _ in range(int(counts.sum()))]
    check(min(map(len, lines)) == 80, "a line is too short")
    users = [f"s{seed}_{i:04d}" for i in range(num_users)]
    ends = np.cumsum(counts)
    rows = [[json.dumps(t) for t in lines[e - c:e]]
            for e, c in zip(ends, counts)]
    _write_json_blob(path, users, rows)
    return int(counts.sum())


def _experiment_config(name):
    import yaml
    with open(os.path.join(HERE, "experiments", name, "config.yaml")) as fh:
        return yaml.safe_load(fh)


def _records(out, name):
    with open(os.path.join(out, "log", "metrics.jsonl")) as fh:
        return [r for r in map(json.loads, fh) if r.get("name") == name]


def _b1_alone(name, launches, steps):
    """B1 launched once a local step, and no other kernel."""
    want = {k: 0 for k in launches}
    want["fused_sgd_apply"] = steps
    check(steps > 0 and launches == want,
          f"{name} launches {launches}, want {want}")


def fedavg_path_config(name, data_dir, rounds=FEDAVG_PATH_ROUNDS):
    """``experiments/<name>/config.yaml`` at its published widths plus
    ``pallas_apply``, cut to ``rounds`` rounds, a checkpoint every round
    and a backup every second, data paths to ``data_dir``."""
    raw = _experiment_config(name)
    raw["server_config"].update(max_iteration=rounds, val_freq=rounds,
                                rec_freq=rounds, rounds_per_step=1,
                                model_backup_freq=2,
                                megakernel={"pallas_apply": True})
    dc = raw["server_config"]["data_config"]
    dc["val"]["val_data"] = f"{data_dir}/val.json"
    dc["test"]["test_data"] = f"{data_dir}/test.json"
    raw["client_config"]["data_config"]["train"]["list_of_train_data"] = \
        f"{data_dir}/train.json"
    return raw


def _train_loss_before_after(server, clients=50):
    """Mean loss a sample over the first ``clients`` train clients' data,
    with the run's initial weights and with its final ones.  The logged
    ``Training loss`` sums each client's local steps, whose number follows
    the cohort, so it does not say by itself whether the loss fell."""
    from msrflute_tpu_torch.data.batching import pack_eval_batches
    from msrflute_tpu_torch.data.dataset import ArraysDataset
    from msrflute_tpu_torch.engine.evaluation import (evaluate,
                                                      stage_eval_batches)
    ds, engine = server.train_dataset, server.engine
    n = min(clients, len(ds))
    sub = ArraysDataset(ds.user_list[:n], [ds.user_arrays(i)
                                           for i in range(n)],
                        ds.num_samples[:n])
    batches = stage_eval_batches(pack_eval_batches(sub, 512), engine.device)
    init = engine.init_state(server.task.init_params(engine.seed))
    return {"clients": n,
            "before": evaluate(server.task, engine.params_dict(init),
                               batches)["loss"].value,
            "after": evaluate(server.task, engine.params_dict(server.state),
                              batches)["loss"].value}


def phase_fedavg_path(torch, work, kernel_rows, name, task, data_dir, P,
                      sizes, blob_s, population_note):
    """One FedAvg path of B1 alone through the CLI on cuda: B1 launched
    once a local step and no other kernel, finite losses, a train loss
    that falls over the rounds (:func:`_train_loss_before_after`),
    ``latest`` and its ``.prev`` slot (the round before, equal to that
    round's backup) with their sidecars, and the status log."""
    import numpy as np
    from msrflute_tpu_torch.engine.checkpoint import LATEST, LATEST_PREV
    rounds = FEDAVG_PATH_ROUNDS
    _reset_counts()
    server, out, secs = _run_cli(work, name,
                                 fedavg_path_config(task, data_dir), "cuda",
                                 task=task)
    launches = _read_counts()
    check(server.state.params.is_cuda, "server params are not on cuda")
    check(server.engine.layout.numel == P,
          f"{name}: {server.engine.layout.numel} params, not {P}")
    steps = server.engine.local_steps
    _b1_alone(name, launches, steps)
    train_loss = [r["value"] for r in _records(out, "Training loss")]
    check(len(train_loss) == rounds and all(map(math.isfinite, train_loss)),
          f"{name} training losses {train_loss}")
    fit = _train_loss_before_after(server)
    check(fit["after"] < fit["before"],
          f"{name}: the train loss did not fall: {fit}")
    check(all(math.isfinite(h["loss"]) for h in server.history),
          f"{name}: non-finite eval loss: {server.history}")
    models = os.path.join(out, "models")
    for f in (LATEST, LATEST + ".sum", LATEST_PREV, LATEST_PREV + ".sum",
              "status_log.json", "best_val_acc_model.pt",
              f"epoch{rounds - 1}.pt"):
        check(os.path.exists(os.path.join(models, f)), f"missing {f}")
    cpu = torch.device("cpu")
    latest, prev = (server.ckpt.load(cpu, n) for n in (LATEST, LATEST_PREV))
    backup = server.ckpt.load(cpu, f"epoch{rounds - 1}.pt")
    check(latest.round == rounds and prev.round == rounds - 1 and
          torch.equal(prev.params, backup.params) and
          torch.equal(latest.params, server.state.params.cpu()),
          f"{name}: latest at round {latest.round}, .prev at {prev.round}")
    with open(os.path.join(models, "status_log.json")) as fh:
        check(json.load(fh)["i"] == rounds,
              f"{name}: status_log.json is not at round {rounds}")
    for row in kernel_rows:
        row.setdefault("launches_by_path", {})[name] = launches[row["name"]]
    secs_per_round = server.run_stats["secsPerRound"]
    emit({"phase": name, "ok": True, "device": "cuda", "params": P,
          "samples": sizes, "population_note": population_note,
          "blob_seconds": round(blob_s, 3), "run_seconds": round(secs, 3),
          "rounds": len(secs_per_round), "secs_per_round": secs_per_round,
          "secs_per_round_after_first": float(np.mean(secs_per_round[1:])),
          "local_steps": steps, "launches": launches,
          "train_loss": train_loss, "train_loss_first_clients": fit,
          "checkpoint": {"latest_round": latest.round,
                         "prev_round": prev.round,
                         "prev_equals_backup": True},
          "evals": [{"split": h["split"], "round": h["round"],
                     "loss": h["loss"], "acc": h["acc"]}
                    for h in server.history]})
    return server


def phase_resnet(torch, work, kernel_rows):
    os.makedirs(os.path.join(work, "fedcifar100"), exist_ok=True)
    tic = time.time()
    sizes = {split: write_cifar100_blob(
        os.path.join(work, "fedcifar100", f"{split}.json"), users, per,
        seed) for split, users, per, seed in CIFAR100_SPLITS}
    return phase_fedavg_path(
        torch, work, kernel_rows, "resnet", "cv_resnet_fedcifar100",
        "fedcifar100", RESNET_P, sizes, time.time() - tic,
        "Fed-CIFAR-100's 500 train clients of 100 images cut to 100, its "
        "100 test clients to 10 val and 10 test (synthetic 32x32x3 images "
        "of 100 classes)")


def phase_shakespeare(torch, work, kernel_rows):
    os.makedirs(os.path.join(work, "shakespeare"), exist_ok=True)
    tic = time.time()
    sizes = {split: write_shakespeare_blob(
        os.path.join(work, "shakespeare", f"{split}.json"), users, lo, hi,
        seed) for split, users, lo, hi, seed in SHAKESPEARE_SPLITS}
    return phase_fedavg_path(
        torch, work, kernel_rows, "shakespeare", "nlp_rnn_fedshakespeare",
        "shakespeare", LSTM_P, sizes, time.time() - tic,
        "fed_shakespeare's 715 clients uncut, 4-41 train lines a client "
        "(mean 22.5) and 1-6 val and test lines (mean 3.5) of 80 synthetic "
        "chars")


#: cuda vs cpu on the ResNet and Shakespeare paths, relative L2 of the
#: params after round 1 and round 2 (2 clients, one local step of one batch
#: a round).  Only reduction order differs (cuDNN's and cuBLAS's sums
#: against the CPU's, GroupNorm's statistics), about 1e-6 of an update
#: that moves the params by well under 1 %, so some 1e-8.
FEDAVG_CROSS_TOL = {1: 1e-6, 2: 1e-6}


def phase_cross_device_fedavg_path(torch, work, name, task, data_dir, batch):
    """2 rounds of 2 clients, one local step each, at the published widths
    (:func:`_cross_device`): the cpu leg is cut to what runs in seconds."""
    raw = fedavg_path_config(task, data_dir, rounds=2)
    raw["server_config"].update(num_clients_per_iteration=2, val_freq=100,
                                rec_freq=100, initial_val=False,
                                model_backup_freq=1)
    raw["client_config"]["desired_max_samples"] = batch
    _cross_device(torch, work, f"{name}_cross_device", raw, task,
                  FEDAVG_CROSS_TOL)


# ----------------------------------------------------------------------
#: hello_mlp's generated population: (split, users, fewest and most
#: samples a user, seed)
HELLO_SPLITS = (("train", 200, 20, 60, 80), ("val", 40, 20, 60, 81))


def write_hello_blob(path, num_users, lo, hi, seed):
    """16-dim points of 3 classes, separable by a fixed linear map."""
    import numpy as np
    rng = np.random.default_rng(seed)
    w = np.random.default_rng(99).normal(size=(16, 3))
    users = [f"h{seed}_{i:04d}" for i in range(num_users)]
    data, labels, counts = {}, {}, []
    for u in users:
        n = int(rng.integers(lo, hi + 1))
        x = rng.normal(size=(n, 16)).astype(np.float32)
        data[u] = {"x": x.tolist()}
        labels[u] = np.argmax(x @ w, axis=1).tolist()
        counts.append(n)
    with open(path, "w") as fh:
        json.dump({"users": users, "num_samples": counts, "user_data": data,
                   "user_data_label": labels}, fh)
    return sum(counts)


def phase_hello_mlp(torch, work, kernel_rows):
    """``experiments/hello_mlp/config.yaml`` as shipped (12 rounds of 8
    clients) through the plugin loader, plus ``pallas_apply``: the
    folder's defaults merged (hidden 64, P = 1,283), ``top2_acc`` logged,
    the val accuracy above chance at the end, B1 once a local step."""
    os.makedirs(os.path.join(work, "hello"), exist_ok=True)
    sizes = {split: write_hello_blob(
        os.path.join(work, "hello", f"{split}.json"), users, lo, hi, seed)
        for split, users, lo, hi, seed in HELLO_SPLITS}
    raw = _experiment_config("hello_mlp")
    raw["model_config"]["model_folder"] = os.path.join(
        HERE, "experiments", "hello_mlp")
    sc = raw["server_config"]
    sc["megakernel"] = {"pallas_apply": True}
    sc["data_config"]["val"]["val_data"] = "hello/val.json"
    sc["data_config"]["test"]["test_data"] = "hello/val.json"
    raw["client_config"]["data_config"]["train"]["list_of_train_data"] = \
        "hello/train.json"
    _reset_counts()
    server, out, secs = _run_cli(work, "hello_mlp", raw, "cuda",
                                 task="hello_mlp")
    launches = _read_counts()
    check(type(server.task).__name__ == "HelloMLPTask",
          f"hello_mlp built {type(server.task).__name__}")
    check(server.config.model_config["hidden"] == 64 and
          server.engine.layout.numel == HELLO_P,
          f"hello_mlp: hidden {server.config.model_config.get('hidden')}, "
          f"{server.engine.layout.numel} params")
    steps = server.engine.local_steps
    _b1_alone("hello_mlp", launches, steps)
    val = [h for h in server.history if h["split"] == "val"]
    check([h["round"] for h in val] == [0, 3, 6, 9, 12] and
          all(math.isfinite(h["loss"]) for h in val),
          f"hello_mlp evals {val}")
    check(val[-1]["acc"] > 0.5 and val[-1]["acc"] > val[0]["acc"],
          f"hello_mlp: val accuracy {val[-1]['acc']} not above chance")
    top2 = _records(out, "Val top2_acc")
    check(len(top2) == 5, f"hello_mlp: {len(top2)} top2_acc records")
    for row in kernel_rows:
        row.setdefault("launches_by_path", {})["hello_mlp"] = \
            launches[row["name"]]
    emit({"phase": "hello_mlp", "ok": True, "device": "cuda",
          "params": HELLO_P, "samples": sizes,
          "run_seconds": round(secs, 3), "local_steps": steps,
          "launches": launches,
          "secs_per_round": server.run_stats["secsPerRound"],
          "val": [{"round": h["round"], "loss": h["loss"], "acc": h["acc"],
                   "top2_acc": h["top2_acc"]} for h in val]})


#: CIFAR-10 (50,000 train images over 100 clients, 10,000 test) cut to
#: 100 train clients of 100 images, 10 val and 10 test clients: (split,
#: clients, images a client, seed)
CIFAR10_SPLITS = (("train", 100, 100, 60), ("val", 10, 100, 61),
                  ("test", 10, 100, 62))
PERSONALIZATION_ROUNDS = 3


def personalization_config(rounds=PERSONALIZATION_ROUNDS):
    """``experiments/cv/config.yaml`` at its widths plus ``pallas_apply``,
    ``rounds`` rounds, val every round, a backup every round."""
    raw = _experiment_config("cv")
    raw["server_config"].update(max_iteration=rounds, val_freq=1,
                                rec_freq=rounds, model_backup_freq=1,
                                megakernel={"pallas_apply": True})
    dc = raw["server_config"]["data_config"]
    dc["val"]["val_data"] = "cifar10/val.json"
    dc["test"]["test_data"] = "cifar10/test.json"
    raw["client_config"]["data_config"]["train"]["list_of_train_data"] = \
        "cifar10/train.json"
    return raw


def _store_state(server):
    """The stored local models ``[users, P]`` and alphas, by user."""
    import torch
    uids = sorted(server.store.params)
    return {"local_models": torch.stack([server.store.params[u]
                                         for u in uids]),
            "alphas": torch.tensor([server.store.alpha[u] for u in uids],
                                   dtype=torch.float64)}


def phase_personalization(torch, work, kernel_rows):
    """The personalization server through the CLI on cuda (ResNet-18-GN,
    10 classes): B1 3 x S a round (the round and the personal pass's two
    client updates) and no other kernel, finite losses, every stored
    alpha inside [1e-4, 0.9999] and moved from 0.75, the store's files;
    then 1 round, a resume and 2 more equal to the 3 rounds bit for bit
    (5 rounds and 2 + 3 before the fused_carry phase came: each round
    writes 447 MB of store files, and the machine allows 45 GiB)."""
    import numpy as np
    os.makedirs(os.path.join(work, "cifar10"), exist_ok=True)
    tic = time.time()
    sizes = {split: write_cifar100_blob(
        os.path.join(work, "cifar10", f"{split}.json"), users, per, seed,
        classes=10) for split, users, per, seed in CIFAR10_SPLITS}
    blob_s = time.time() - tic
    rounds = PERSONALIZATION_ROUNDS
    _reset_counts()
    server, out, secs = _run_cli(work, "personalization",
                                 personalization_config(), "cuda", task="cv")
    launches = _read_counts()
    check(type(server).__name__ == "PersonalizationServer",
          f"built {type(server).__name__}")
    check(server.engine.layout.numel == RESNET10_P,
          f"personalization: {server.engine.layout.numel} params")
    S = server.max_steps
    steps = server.engine.local_steps
    check(steps == 3 * S * rounds, f"{steps} local steps, not 3 x {S} x "
                                   f"{rounds}")
    _b1_alone("personalization", launches, steps)
    train_loss = [r["value"] for r in _records(out, "Training loss")]
    check(len(train_loss) == rounds and all(map(math.isfinite, train_loss)),
          f"personalization training losses {train_loss}")
    pers = [h for h in server.history if h["split"] == "personalized_val"]
    check([h["round"] for h in pers] == list(range(1, rounds + 1)) and
          all(math.isfinite(h["loss"]) for h in server.history),
          f"personalization evals {server.history}")
    alphas = server.store.alpha
    K = server.eval_chunk
    check(K <= len(alphas) <= K * rounds and
          all(1e-4 <= a <= 0.9999 and a != 0.75 for a in alphas.values()),
          f"stored alphas {alphas}")
    store_dir = os.path.join(out, "models", "personalization")
    files = set(os.listdir(store_dir))
    check(all({f"user{u}_model.pt", f"user{u}_model.pt.sum"} <= files
              for u in alphas), "a stored user has no file")
    for row in kernel_rows:
        row.setdefault("launches_by_path", {})["personalization"] = \
            launches[row["name"]]
    # the resume leg: 1 round, then 2 more from the checkpoint and store
    _run_cli(work, "personalization_resume", personalization_config(1),
             "cuda", task="cv")
    raw = personalization_config()
    raw["server_config"]["resume_from_checkpoint"] = True
    resumed, _, _ = _run_cli(work, "personalization_resume", raw, "cuda",
                             task="cv")
    whole, again = _store_state(server), _store_state(resumed)
    check(resumed.state.round == rounds and
          torch.equal(resumed.state.params, server.state.params) and
          sorted(resumed.store.alpha) == sorted(alphas) and
          all(torch.equal(v, again[k]) for k, v in whole.items()),
          "personalization: a run resumed after round 1 differs from the "
          "uninterrupted one")
    store_bytes = sum(t.numel() * t.element_size()
                      for t in server.store.params.values())
    secs_per_round = server.run_stats["secsPerRound"]
    emit({"phase": "personalization", "ok": True, "device": "cuda",
          "params": RESNET10_P, "samples": sizes,
          "blob_seconds": round(blob_s, 3), "run_seconds": round(secs, 3),
          "rounds": len(secs_per_round), "secs_per_round": secs_per_round,
          "secs_per_round_after_first": float(np.mean(secs_per_round[1:])),
          "secs_personal_pass": server.run_stats["secsPersonalPass"],
          "secs_personal_store": server.run_stats["secsPersonalStore"],
          "secs_personal_save": server.run_stats["secsPersonalSave"],
          "housekeeping_secs": server.run_stats["secsPerRoundHousekeeping"],
          "local_steps": steps, "steps_per_round": S, "launches": launches,
          "store_users": len(alphas), "store_host_gb": store_bytes / 1e9,
          "alphas": {"min": min(alphas.values()),
                     "max": max(alphas.values())},
          "train_loss": train_loss,
          "evals": [{"split": h["split"], "round": h["round"],
                     "loss": h["loss"], "acc": h["acc"]}
                    for h in server.history],
          "resume_1_plus_2_equals_3": True})
    del resumed
    return server


def phase_personalization_profile(torch, server, rounds=3):
    """As ``profile``, over whole training rounds of the personalization
    path: the personal pass (staging the K local models in, their two
    client updates, the alpha step, the new models out to the store), the
    round's packing and the round; then the host time a round takes to
    move the store's K models each way, and, from the ``personalization``
    run's housekeeping, to write the round's users to disk
    (``store.save``)."""
    import numpy as np
    from msrflute_tpu_torch.data.batching import pack_round_batches
    lr = server.initial_lr_client * server.lr_weight
    store_s = server.run_stats["secsPersonalStore"]
    first = len(store_s)

    def step():
        sampled = server._sample()
        batch = pack_round_batches(
            server.train_dataset, sampled, server.batch_size,
            server._chunk_steps([sampled]), rng=server._np_rng,
            desired_max_samples=server.desired_max_samples)
        server.state = server.engine.run_round(server.state, batch, lr,
                                               1.0)[0]

    traced = _trace_rounds(torch, step, rounds, "personalization_profile")
    move_s = float(np.mean(store_s[first + 1:first + 1 + rounds]))
    emit({"phase": "personalization_profile", "ok": True, "rounds": rounds,
          "steps_per_round": server.max_steps, **traced,
          "store_move_ms_per_round": move_s * 1e3,
          "store_move_share_of_wall": move_s * 1e3
          / traced["wall_ms_per_round"],
          "store_move_bytes_each_way": server.eval_chunk * RESNET10_P * 4,
          "store_save_ms_per_round": float(np.mean(
              server.run_stats["secsPersonalSave"])) * 1e3})


#: CIFAR-10 for FedLabels: 100 train clients, each 96 labeled images and
#: 96 unlabeled ones (RandAugment views of the unlabeled ones made at
#: load), 10 val and 10 test clients of 100 images: (split, clients,
#: images a client, seed)
SEMISUP_SPLITS = (("train", 100, 96, 70), ("val", 10, 100, 71),
                  ("test", 10, 100, 72))
FEDLABELS_ROUNDS = 5


def fedlabels_config(rounds=FEDLABELS_ROUNDS, data_dir="semisup"):
    """``experiments/semisupervision/config.yaml`` at its widths plus
    ``pallas_apply``, ``rounds`` rounds, ``burnout_round`` cut from 30 to
    1 so the unsupervised pass runs from round 1."""
    raw = _experiment_config("semisupervision")
    raw["server_config"].update(max_iteration=rounds, val_freq=rounds,
                                rec_freq=rounds, model_backup_freq=1,
                                megakernel={"pallas_apply": True})
    raw["client_config"]["semisupervision"]["burnout_round"] = 1
    dc = raw["server_config"]["data_config"]
    dc["val"]["val_data"] = f"{data_dir}/val.json"
    dc["test"]["test_data"] = f"{data_dir}/test.json"
    raw["client_config"]["data_config"]["train"]["list_of_train_data"] = \
        f"{data_dir}/train.json"
    return raw


def write_semisup_splits(work, data_dir, splits):
    os.makedirs(os.path.join(work, data_dir), exist_ok=True)
    sizes = {}
    for split, users, per, seed in splits:
        path = os.path.join(work, data_dir, f"{split}.json")
        sizes[split] = (write_semisup_blob(path, users, per, seed)
                        if split == "train" else
                        write_cifar100_blob(path, users, per, seed,
                                            classes=10))
    return sizes


def phase_fedlabels(torch, work, kernel_rows):
    """FedLabels through the CLI on cuda (CIFAR_CNN, RandAugment's
    ``ux_rand`` under ``uda: 1``): B1 once a supervised local step and no
    other kernel (the unsupervised SGD is a plain tensor update), finite
    losses, a val loss that falls over the 5 rounds."""
    import numpy as np
    tic = time.time()
    sizes = write_semisup_splits(work, "semisup", SEMISUP_SPLITS)
    blob_s = time.time() - tic
    rounds = FEDLABELS_ROUNDS
    _reset_counts()
    server, out, secs = _run_cli(work, "fedlabels", fedlabels_config(),
                                 "cuda", task="semisupervision")
    launches = _read_counts()
    check(type(server.strategy).__name__ == "FedLabels",
          f"built {type(server.strategy).__name__}")
    check(server.engine.layout.numel == CIFAR_CNN_P,
          f"fedlabels: {server.engine.layout.numel} params")
    check("ux_rand" in server.train_dataset.user_arrays(0),
          "no RandAugment view in the train split")
    steps = server.engine.local_steps
    _b1_alone("fedlabels", launches, steps)
    train_loss = [r["value"] for r in _records(out, "Training loss")]
    check(len(train_loss) == rounds and all(map(math.isfinite, train_loss)),
          f"fedlabels training losses {train_loss}")
    val = [(h["round"], h["loss"], h["acc"]) for h in server.history
           if h["split"] == "val"]
    check([r for r, _, _ in val] == [0, rounds] and
          all(map(math.isfinite, (v for _, v, _ in val))) and
          val[1][1] < val[0][1], f"fedlabels: the val loss did not fall: "
                                 f"{val}")
    for row in kernel_rows:
        row.setdefault("launches_by_path", {})["fedlabels"] = \
            launches[row["name"]]
    secs_per_round = server.run_stats["secsPerRound"]
    emit({"phase": "fedlabels", "ok": True, "device": "cuda",
          "params": CIFAR_CNN_P, "samples": sizes,
          "blob_seconds": round(blob_s, 3), "run_seconds": round(secs, 3),
          "reduced": "burnout_round 30 -> 1, so the unsupervised pass runs "
                     "in rounds 1-4",
          "rounds": len(secs_per_round), "secs_per_round": secs_per_round,
          "secs_per_round_after_first": float(np.mean(secs_per_round[1:])),
          "local_steps": steps, "launches": launches,
          "train_loss": train_loss,
          "val": [{"round": r, "loss": v, "acc": a} for r, v, a in val]})


#: cuda vs cpu on the personalization path, relative L2 after rounds 1
#: and 2 (2 clients, one local step of batch 32 a client update): the
#: global params as on the ResNet path, and the stored local models and
#: alphas after round 2.  Reduction order only: a run on an NVIDIA H100
#: 80GB HBM3 at its 700 W limit measured 1.4e-9 / 2.1e-9, 1.8e-9 for the
#: local models and 0 for the alphas.
PERSONALIZATION_CROSS_TOL = {1: 1e-6, 2: 1e-6}
PERSONALIZATION_CROSS_TOL_FINAL = {"local_models": 1e-6, "alphas": 1e-6}


def phase_cross_device_personalization(torch, work):
    raw = personalization_config(rounds=2)
    raw["server_config"].update(num_clients_per_iteration=2, val_freq=100,
                                rec_freq=100, initial_val=False)
    raw["client_config"]["desired_max_samples"] = 32
    _cross_device(torch, work, "cross_device_personalization", raw, "cv",
                  PERSONALIZATION_CROSS_TOL, extra=_store_state,
                  extra_tol=PERSONALIZATION_CROSS_TOL_FINAL)


#: cuda vs cpu on the FedLabels path, relative L2 of the params after
#: rounds 1 and 2 (2 clients, one supervised step of batch 64 and two
#: unsupervised ones a round, the unsupervised pass from round 1).  A run
#: on an NVIDIA H100 80GB HBM3 at its 700 W limit measured 9.4e-9 after
#: round 1 and 2.2e-6 after round 2, where
#: the pseudo-labels' variance comparison and threshold first act on the
#: gap; round 2's bound leaves room for a flipped label.
FEDLABELS_CROSS_TOL = {1: 1e-6, 2: 1e-4}
FEDLABELS_CROSS_SPLITS = (("train", 10, 64, 73), ("val", 2, 100, 74),
                          ("test", 2, 100, 75))


def phase_cross_device_fedlabels(torch, work):
    write_semisup_splits(work, "semisup_cross", FEDLABELS_CROSS_SPLITS)
    raw = fedlabels_config(rounds=2, data_dir="semisup_cross")
    raw["server_config"].update(num_clients_per_iteration=2, val_freq=100,
                                rec_freq=100, initial_val=False)
    _cross_device(torch, work, "cross_device_fedlabels", raw,
                  "semisupervision", FEDLABELS_CROSS_TOL)


# ----------------------------------------------------------------------
# ----------------------------------------------------------------------
#: the three shipped configs slice 8 ports: ECG_CNN with client adam, NRMS
#: with client adam, BERT-base MLM under DGA with local DP, quantization
#: (kernel B3) and the privacy-attack metrics
ECG_P, NRMS_P, BERT_P = 136_709, 13_320_802, 109_514_298
BERT_LEAVES = 202
#: MIT-BIH beats (Kaggle's 87,554 train beats of 187 frames, 5 classes)
#: over 100 train clients of 50-300 beats, 10 val, 10 test: (split,
#: clients, fewest and most beats a client, seed)
ECG_SPLITS = (("train", 100, 50, 300, 90), ("val", 10, 50, 300, 91),
              ("test", 10, 50, 300, 92))
#: MIND-shaped users: (split, users, seed); each has 5-80 clicks (the
#: newest 50 kept), 1-4 impressions of 5-40 candidates
MIND_SPLITS = (("train", 200, 93), ("val", 30, 94), ("test", 30, 95))
#: Reddit-shaped token rows of 8-128 tokens: (split, users, fewest and
#: most rows a user, seed)
BERT_SPLITS = (("train", 200, 16, 128, 96), ("val", 20, 16, 64, 97),
               ("test", 20, 16, 64, 98))
ECG_ROUNDS = NRMS_ROUNDS = 5
#: BERT-base's checkpoints are 1.3 GB each (params, adamW's moments), one
#: a round: 2 rounds (3 before the fused_carry phase came) and a backup at
#: the end keep the script's disk writes in bounds
BERT_ROUNDS = 2
BERT_LEARN_ROUNDS = 2


def write_ecg_blob(path, num_users, lo, hi, seed, frames=187, classes=5):
    """ECG-shaped beats: ``frames`` values in [0, 1], one bump-shaped
    template a class (its peak's place and width), plus noise."""
    import numpy as np
    rng = np.random.default_rng(seed)
    t = np.linspace(0.0, 1.0, frames)
    peaks = np.linspace(0.15, 0.75, classes)
    users = [f"e{seed}_{i:04d}" for i in range(num_users)]
    counts = rng.integers(lo, hi + 1, size=num_users).tolist()
    rows, labels = [], {}
    for u, n in zip(users, counts):
        y = rng.integers(0, classes, size=n)
        width = 0.02 + 0.01 * y[:, None]
        x = np.exp(-((t[None, :] - peaks[y][:, None]) / width) ** 2)
        x = np.clip(x + rng.normal(0.0, 0.05, size=x.shape), 0.0, 1.0)
        rows.append(["[" + ",".join(f"{v:.4f}" for v in r) + "]" for r in x])
        labels[u] = y.tolist()
    _write_json_blob(path, users, rows, labels)
    return sum(counts)


def write_mind_blob(path, num_users, seed, vocab=40_000, title_max=30):
    """MIND-shaped users: a topic each, clicked titles drawn from it, and
    impressions whose positives come from the topic and negatives from
    the whole (Zipf) vocabulary."""
    import numpy as np
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab)
    p = 1.0 / ranks
    p /= p.sum()
    span = min(500, vocab // 4)
    topics = rng.integers(1, vocab - span, size=num_users)

    def title(topic):
        n = int(rng.integers(min(5, title_max), title_max + 1))
        if topic is None:
            return rng.choice(ranks, size=n, p=p).tolist()
        return (topic + rng.integers(0, span, size=n)).tolist()

    users, data = [f"m{seed}_{i:04d}" for i in range(num_users)], {}
    for u, topic in zip(users, topics.tolist()):
        clicked = [title(topic) for _ in range(int(rng.integers(5, 81)))]
        imps = []
        for _ in range(int(rng.integers(1, 5))):
            n = int(rng.integers(5, 41))
            labels = (rng.random(n) < 0.08).astype(int)
            labels[int(rng.integers(n))] = 1
            imps.append({"cands": [title(topic if lab else None)
                                   for lab in labels],
                         "labels": labels.tolist()})
        data[u] = {"clicked": clicked, "impressions": imps}
    with open(path, "w") as fh:
        json.dump({"users": users, "num_samples": [1] * num_users,
                   "user_data": data}, fh)
    return sum(len(d["impressions"]) for d in data.values())


def write_bert_blob(path, num_users, lo, hi, seed, vocab=30_522, L=128,
                    premasked=False):
    """Reddit-shaped token rows for the MLM: ``[CLS]`` (101), 6-126 Zipf
    word ids from 1,000 up, ``[SEP]`` (102), 0-padded to ``L``.  With
    ``premasked`` the rows carry a fixed 15 % mask (id 103) and ``y``
    labels (-100 where unmasked), the JAX task's premasked format."""
    import numpy as np
    rng = np.random.default_rng(seed)
    ranks = np.arange(1000, vocab)
    p = 1.0 / np.arange(1, ranks.size + 1)
    p /= p.sum()
    users = [f"b{seed}_{i:04d}" for i in range(num_users)]
    counts = rng.integers(lo, hi + 1, size=num_users).tolist()
    data = {}
    for u, n in zip(users, counts):
        x = np.zeros((n, L), np.int64)
        lens = rng.integers(6, L - 1, size=n)
        # a user's words in one draw, laid into the rows in order
        cols = np.arange(L)
        x[(cols >= 1) & (cols <= lens[:, None])] = rng.choice(
            ranks, size=int(lens.sum()), p=p)
        x[:, 0], x[np.arange(n), lens + 1] = 101, 102
        entry = {"x": x.tolist()}
        if premasked:
            sel = (rng.random(x.shape) < 0.15) & (x > 102)
            entry["y"] = np.where(sel, x, -100).tolist()
            entry["x"] = np.where(sel, 103, x).tolist()
        data[u] = entry
    with open(path, "w") as fh:
        json.dump({"users": users, "num_samples": counts,
                   "user_data": data}, fh)
    return sum(counts)


def _set_data(raw, data_dir):
    dc = raw["server_config"]["data_config"]
    dc["val"]["val_data"] = f"{data_dir}/val.json"
    dc["test"]["test_data"] = f"{data_dir}/test.json"
    raw["client_config"]["data_config"]["train"]["list_of_train_data"] = \
        f"{data_dir}/train.json"
    return raw


def shipped_config(name, data_dir, rounds, backup_freq=None):
    """``experiments/<name>/config.yaml`` as shipped, cut to ``rounds``
    rounds with an eval at the start and the end and a backup every
    ``backup_freq`` rounds (at the end by default); data paths to
    ``data_dir``.  ``mlm_bert`` runs with ``model_axis_size: 1`` (one
    card)."""
    raw = _experiment_config(name)
    raw["server_config"].update(max_iteration=rounds, val_freq=rounds,
                                rec_freq=rounds,
                                model_backup_freq=backup_freq or rounds)
    if "mesh_config" in raw:
        raw["mesh_config"]["model_axis_size"] = 1
    return _set_data(raw, data_dir)


def _write_splits(work, data_dir, writer, splits):
    os.makedirs(os.path.join(work, data_dir), exist_ok=True)
    tic = time.time()
    sizes = {s[0]: writer(os.path.join(work, data_dir, f"{s[0]}.json"),
                          *s[1:]) for s in splits}
    return sizes, time.time() - tic


def _no_kernel(name, launches):
    check(not any(launches.values()),
          f"{name}: a port kernel launched on a path that has none: "
          f"{launches}")


def phase_shipped_path(torch, work, kernel_rows, name, task, data_dir, P,
                       sizes, blob_s, population_note, rounds, extra=None):
    """One of the shipped configs through the CLI on cuda: its params,
    finite losses and evals, the checkpoint and status log at the last
    round; ``extra(server, out, launches)`` adds the path's own checks
    and fields."""
    import numpy as np
    _reset_counts()
    torch.cuda.reset_peak_memory_stats()
    server, out, secs = _run_cli(work, name,
                                 shipped_config(task, data_dir, rounds),
                                 "cuda", task=task)
    launches = _read_counts()
    check(server.state.params.is_cuda, "server params are not on cuda")
    check(server.engine.layout.numel == P,
          f"{name}: {server.engine.layout.numel} params, not {P}")
    train_loss = [r["value"] for r in _records(out, "Training loss")]
    check(len(train_loss) == rounds and all(map(math.isfinite, train_loss)),
          f"{name} training losses {train_loss}")
    check(all(math.isfinite(h["loss"]) for h in server.history),
          f"{name}: non-finite eval loss: {server.history}")
    models = os.path.join(out, "models")
    for f in ("latest_model.pt", "latest_model.pt.sum", "status_log.json",
              f"epoch{rounds}.pt"):
        check(os.path.exists(os.path.join(models, f)), f"missing {f}")
    with open(os.path.join(models, "status_log.json")) as fh:
        check(json.load(fh)["i"] == rounds,
              f"{name}: status_log.json is not at round {rounds}")
    for row in kernel_rows:
        row.setdefault("launches_by_path", {})[name] = launches[row["name"]]
    more = extra(server, out, launches) if extra else {}
    secs_per_round = server.run_stats["secsPerRound"]
    emit({"phase": name, "ok": True, "device": "cuda", "params": P,
          "samples": sizes, "population_note": population_note,
          "blob_seconds": round(blob_s, 3), "run_seconds": round(secs, 3),
          "rounds": len(secs_per_round), "secs_per_round": secs_per_round,
          "secs_per_round_after_first": float(np.mean(secs_per_round[1:])),
          "local_steps": server.engine.local_steps, "launches": launches,
          "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
          "train_loss": train_loss, **more,
          "evals": server.history})
    return server


def phase_ecg(torch, work, kernel_rows):
    """``experiments/ecg_cnn`` (client and server adam, batch 32): no port
    kernel on the path, a train loss that falls."""
    sizes, blob_s = _write_splits(work, "ecg", write_ecg_blob, ECG_SPLITS)

    def extra(server, out, launches):
        _no_kernel("ecg", launches)
        fit = _train_loss_before_after(server)
        check(fit["after"] < fit["before"],
              f"ecg: the train loss did not fall: {fit}")
        return {"train_loss_first_clients": fit}

    return phase_shipped_path(
        torch, work, kernel_rows, "ecg", "ecg_cnn", "ecg", ECG_P, sizes,
        blob_s, "Kaggle's MIT-BIH beats (87,554 train) cut to 100 clients "
        "of 50-300 synthetic beats of 187 frames, 10 val and 10 test "
        "clients", ECG_ROUNDS, extra)


def phase_fednewsrec(torch, work, kernel_rows):
    """``experiments/fednewsrec`` (NRMS, client adam, server SGD, batch
    16): no port kernel, AUC / MRR / nDCG in range."""
    sizes, blob_s = _write_splits(work, "mind", write_mind_blob,
                                  MIND_SPLITS)

    def extra(server, out, launches):
        _no_kernel("fednewsrec", launches)
        last = server.history[-1]
        check(all(0.0 <= last[k] <= 1.0
                  for k in ("auc", "mrr", "ndcg@5", "ndcg@10")),
              f"fednewsrec: ranking metrics out of range: {last}")
        return {"train_loss_first_clients": _train_loss_before_after(server)}

    return phase_shipped_path(
        torch, work, kernel_rows, "fednewsrec", "fednewsrec", "mind", NRMS_P,
        sizes, blob_s, "MIND's users cut to 200 train, 30 val and 30 test "
        "synthetic users (5-80 clicks, 1-4 impressions of 5-40 "
        "candidates, 40,000-word Zipf titles of 5-30 words)", NRMS_ROUNDS,
        extra)


def phase_mlm_bert(torch, work, kernel_rows):
    """``experiments/mlm_bert`` at BERT-base (``model_axis_size`` 1): 10
    clients of batch 16 and 64 samples, DGA with local DP, quantization
    (B3 once a round and no other kernel) and the privacy metrics (the
    extraction attack reads ``position_embeddings``, so every client's
    overlap is 1.0; BERT has no leakage metric)."""
    sizes, blob_s = _write_splits(work, "reddit_tokens", write_bert_blob,
                                  BERT_SPLITS)

    def extra(server, out, launches):
        want = {k: 0 for k in launches}
        want["quant_bin_sparsify"] = BERT_ROUNDS
        check(launches == want, f"mlm_bert launches {launches}, want {want}")
        overlap = [r["value"] for r in
                   _records(out, "Extracted indices percentage")]
        check(overlap == [1.0] * BERT_ROUNDS,
              f"mlm_bert: extraction overlap {overlap}")
        check(not _records(out, "Practical epsilon (Max leakage)"),
              "mlm_bert logged a leakage metric")
        thresh = [r["value"] for r in _records(out, "Quantization Thresh.")]
        check(len(thresh) == BERT_ROUNDS, f"Quantization Thresh. {thresh}")
        for row in kernel_rows:
            if row["name"] == "quant_bin_sparsify" and \
                    row.get("shape") == [10, BERT_P]:
                row["launches"] = launches["quant_bin_sparsify"]
        return {"leaves": len(server.engine.layout.names),
                "extracted_overlap": overlap,
                "dropped": [r["value"] for r in
                            _records(out, "Dropped clients")],
                "quant_thresh": thresh}

    return phase_shipped_path(
        torch, work, kernel_rows, "mlm_bert", "mlm_bert", "reddit_tokens",
        BERT_P, sizes, blob_s, "Reddit-shaped token rows (8-128 tokens, "
        "30,522-id Zipf words) for 200 train users of 16-128 rows, 20 val "
        "and 20 test users", BERT_ROUNDS, extra)


def phase_mlm_bert_learns(torch, work):
    """mlm_bert with local DP off (quantization on) for
    ``BERT_LEARN_ROUNDS`` rounds: the val loss (fixed eval mask) falls."""
    # no epoch backups (2.6 GB of BERT-base copies), which nothing here
    # reads
    raw = shipped_config("mlm_bert", "reddit_tokens", BERT_LEARN_ROUNDS,
                         backup_freq=1000)
    raw["dp_config"]["enable_local_dp"] = False
    _reset_counts()
    server, _, secs = _run_cli(work, "mlm_bert_learns", raw, "cuda",
                               task="mlm_bert")
    launches = _read_counts()
    check(launches["quant_bin_sparsify"] == BERT_LEARN_ROUNDS,
          f"mlm_bert_learns launches {launches}")
    val = [(h["round"], h["loss"]) for h in server.history
           if h["split"] == "val"]
    check(len(val) == 2 and all(math.isfinite(v) for _, v in val) and
          val[-1][1] < val[0][1], f"mlm_bert val loss did not fall: {val}")
    emit({"phase": "mlm_bert_learns", "ok": True,
          "rounds": BERT_LEARN_ROUNDS,
          "val_loss_by_round": {r: v for r, v in val},
          "val_loss_drop": val[0][1] - val[-1][1], "launches": launches,
          "run_seconds": round(secs, 3)})


#: cuda vs cpu on the three paths, relative L2 of the params after rounds
#: 1 and 2 (2 clients, BERT's one, one local step a round).  Only float32 order
#: differs, but adam divides each gradient by its own magnitude (plus eps
#: 1e-8), so where a gradient is near 0 its rounding decides a step of up
#: to ``lr``: ECG (client and server adam) measured 6.5e-5 / 3.1e-4 on an
#: NVIDIA H100 80GB HBM3 at 700 W, and the port against the JAX package
#: on the CPU differs alike after one round (3.7e-5, 253 of 136,709
#: elements by up to 4.3e-4); BERT's 2-layer leg (client and server
#: adamW, quantization) 4.0e-5 / 6.8e-5; NRMS (client adam, server SGD)
#: 1.5e-7 / 2.7e-7.  The bounds leave 10-40x room.
SHIPPED_CROSS_TOL = {"ecg": {1: 1e-3, 2: 3e-3},
                     "fednewsrec": {1: 1e-5, 2: 1e-5},
                     "mlm_bert": {1: 1e-3, 2: 1e-3}}


def phase_cross_device_shipped(torch, work, name, task, data_dir, batch,
                               over=None, clients=2):
    raw = shipped_config(task, data_dir, 2, backup_freq=1)
    raw["server_config"].update(num_clients_per_iteration=clients,
                                val_freq=100,
                                rec_freq=100, initial_val=False,
                                rounds_per_step=1)
    raw["client_config"]["desired_max_samples"] = batch
    if over:
        over(raw)
    _cross_device(torch, work, f"{name}_cross_device", raw, task,
                  SHIPPED_CROSS_TOL[name])


def phase_cross_device_mlm_bert(torch, work):
    """``reduced``: 2 of BERT-base's 12 layers (every width as shipped), one
    client of one step (the cpu takes 6 s a client step), local DP off (its normals differ between the two
    devices' generators), premasked rows and dropout 0 (the MLM draws and
    dropout masks do too); quantization on; the privacy metrics off (they
    read the params this phase compares, and ``mlm_bert`` checks them;
    the extraction attack takes 10 s a round on the cpu)."""
    from msrflute_tpu_torch.models import bert
    write_bert_blob(os.path.join(work, "reddit_tokens", "pm_train.json"),
                    10, 16, 32, 99, premasked=True)

    def over(raw):
        raw["model_config"]["BERT"]["model"].update(num_hidden_layers=2,
                                                    premasked=True)
        raw["dp_config"]["enable_local_dp"] = False
        raw["privacy_metrics_config"]["apply_metrics"] = False
        raw["client_config"]["data_config"]["train"][
            "list_of_train_data"] = "reddit_tokens/pm_train.json"

    rates = bert.HIDDEN_DROPOUT, bert.ATTENTION_DROPOUT
    bert.HIDDEN_DROPOUT = bert.ATTENTION_DROPOUT = 0.0
    try:
        phase_cross_device_shipped(torch, work, "mlm_bert", "mlm_bert",
                                   "reddit_tokens", 16, over, clients=1)
    finally:
        bert.HIDDEN_DROPOUT, bert.ATTENTION_DROPOUT = rates


def _bert_bounds(torch):
    """BERT-base's leaf bounds, from the port's layout built on the meta
    device (no memory)."""
    from msrflute_tpu_torch.models.bert import make_bert_task
    with torch.device("meta"):
        layout = make_bert_task(
            _experiment_config("mlm_bert")["model_config"]).layout()
    check(layout.numel == BERT_P and len(layout.names) == BERT_LEAVES,
          f"BERT-base has {layout.numel} params in {len(layout.names)} "
          "leaves")
    return list(layout.offsets) + [layout.numel]


def phase_kernel_quant_bert(torch):
    """B3 at the mlm_bert path's shape, ``[10, 109,514,298]`` in 202
    leaves, against its plain version bitwise at full P (thresholds from
    each leaf's exact 0.7 quantile, as the path takes them); then timed
    beside its yardstick and the exact quantile over all leaves, which the
    path also pays once a round."""
    from msrflute_tpu_torch.ops.quant_bin import (quant_bin_plain,
                                                  quant_bin_sparsify)
    from msrflute_tpu_torch.ops.quantization import exact_quantile_abs
    bounds = _bert_bounds(torch)
    L, K = len(bounds) - 1, 10
    gen = torch.Generator(device="cuda").manual_seed(4)
    x = torch.randn((K, BERT_P), device="cuda", generator=gen)
    x *= torch.logspace(-4, -1, K, device="cuda")[:, None]
    off, lo, hi, th = _quant_case(torch, x, bounds, 0.7)
    k = quant_bin_sparsify(x, off, lo, hi, th, 1024)
    pl = quant_bin_plain(x, off.cpu(), lo, hi, th, 1024)
    torch.cuda.synchronize()
    err = float((k - pl).abs().max())
    check(torch.equal(k, pl), f"quant_bin at the BERT shape: kernel != "
                              f"plain (max abs err {err})")
    del k, pl
    torch.cuda.empty_cache()
    timed = _quant_timing(torch, x, bounds, off, lo, hi, th, plain_iters=5)
    quantile_ms = _time_ms(torch, lambda: [
        exact_quantile_abs(x[:, a:b].abs(), 0.7)
        for a, b in zip(bounds[:-1], bounds[1:])], iters=3, warmup=1)
    card = _under_load(torch, lambda: quant_bin_sparsify(x, off, lo, hi, th,
                                                         1024))
    emit({"phase": "kernel", "ok": True, "name": "quant_bin_sparsify",
          "bitwise": True, "full_p": True, **timed,
          "card_under_kernel": card,
          "exact_quantile_ms_all_leaves": quantile_ms})
    del x
    torch.cuda.empty_cache()
    return _quant_row(timed, err)


# ----------------------------------------------------------------------
# the 16-bit storage arms of B1 and B4-B6, and the paths that run them
# ----------------------------------------------------------------------
#: the 16-bit storage arms, and the mantissa bits of each
STORAGE16 = ("bfloat16", "float16")
MANTISSA = {"bfloat16": 7, "float16": 10}
#: H100 SXM dense bf16 / fp16 tensor-core peak: the least time a 16-bit
#: attention could take.  B4, B5 and B6 in 16-bit storage run their
#: products on the tensor cores (``mma.sync``, float32 accumulators);
#: ``bound_ms_f32`` beside it is the float32 CUDA-core rate's
PEAK_TC16_FLOPS = 989e12
#: B4-B6's 16-bit arms against their plain versions: max |kernel - plain|
#: over max |plain| within one ulp of the storage type at the largest
#: magnitude (2^-7 bfloat16, 2^-10 float16): besides the one rounding of
#: the result, B4 rounds P, B5 dS, and B6 P and dS once to the storage type
#: for their tensor-core products, a relative 2^-9 / 2^-12 a term on sums
#: of terms of random signs (``tests/test_torch_flash_tc16.py`` holds that
#: rounding to this bound on the CPU).  An H100 measured at most 6.7e-3
#: (bf16) and 9.7e-4 (f16) on these cases with the three tensor-core arms.
#: lse stays float32: ``FLASH_FWD_TOL``.
FLASH16_TOL = {dt: 2.0 ** -MANTISSA[dt] for dt in STORAGE16}
#: the f32 paths' profile figures, kept for the 16-bit paths' lines
F32_PROFILE = {}


def phase_kernel16(torch):
    """B1's bfloat16 and float16 arms against the plain version, bitwise,
    on ``SGD_CASES`` (offsets in elements, so rows start 2-6 bytes off a
    16-byte boundary too), gated rows and the elements around each view
    untouched; timed at the CNN shape beside ``torch._fused_sgd_`` on the
    same 16-bit tensors."""
    from msrflute_tpu_torch.ops.fused_sgd import (fused_sgd_apply,
                                                  fused_sgd_plain)
    lr, rows, timed = 0.1, [], {}
    for dt_name in STORAGE16:
        dt = getattr(torch, dt_name)
        max_err = _sgd_cases(torch, dt)
        K, P, mu = MAIN_K, MAIN_P, 0.9
        p, g, m, gt, _ = _sgd_inputs(torch, K, P, [1] * K, 1, dtype=dt)
        kernel = lambda: fused_sgd_apply(p, g, m, lr, mu, gt)  # noqa: E731
        library = lambda: torch._fused_sgd_(  # noqa: E731
            [p], [g], [m], weight_decay=0.0, momentum=mu, lr=lr,
            dampening=0.0, nesterov=False, maximize=False,
            is_first_step=False)
        kernel_ms = _device_ms(torch, kernel)
        plain_ms = _time_ms(torch, lambda: fused_sgd_plain(p, g, m, lr, mu,
                                                           gt))
        library_ms = _device_ms(torch, library)
        nbytes = 10 * K * P + 4 * K   # read p, g, m, gate; write p, m
        bound_ms = max(nbytes / PEAK_BYTES_PER_S,
                       4 * K * P / PEAK_F32_FLOPS) * 1e3
        timed[dt_name] = {
            "shape": [K, P], "ms": kernel_ms,
            "ms_repeat": _device_ms(torch, kernel),
            "ms_host_paced": _time_ms(torch, kernel), "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms, "bytes": nbytes,
            "share_of_bound": bound_ms / kernel_ms,
            "achieved_gb_s": nbytes / (kernel_ms * 1e-3) / 1e9,
            "library_gb_s": nbytes / (library_ms * 1e-3) / 1e9}
        if dt_name == "bfloat16":
            timed[dt_name]["card_under_kernel"] = _under_load(torch, kernel)
        rows.append({
            "name": _arm("fused_sgd_apply", dt_name), "route": "cuda",
            "source": "msrflute_tpu_torch/csrc/fused_sgd.cu",
            "replaces": "msrflute_tpu/ops/pallas_kernels.py:212",
            "launches": None, "max_abs_err": max_err, "ms": kernel_ms,
            "ms_host_paced": timed[dt_name]["ms_host_paced"],
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
            "library_ms": library_ms})
        del p, g, m
    emit({"phase": "kernel", "ok": True, "name": "fused_sgd_apply (16-bit)",
          "cases": len(SGD_CASES) * 2 * len(STORAGE16), "bitwise": True,
          **timed})
    return rows


def _flash16_case(torch, dt, B, Lq, Lk, H, D, seed):
    return tuple(x.to(dt) if x.dim() == 4 else x
                 for x in _flash_case(torch, B, Lq, Lk, H, D, seed))


def _tensor_core_sass():
    """Tensor-core instructions (HMMA, HGMMA) of each tensor-core
    instance in the built library's SASS, by :func:`_template_name`
    (``msrflute_tpu_torch/ops/sass.py::tensor_core_count``)."""
    from msrflute_tpu_torch.ops import _build, sass
    lib = _build.library_path("flash_attention")
    return {_template_name(name): sass.tensor_core_count(body)
            for name, body in sass.functions(sass.disassemble(lib)).items()
            if "_tc_kernel" in name}


def phase_kernel_flash16(torch):
    """B4, B5 and B6 in bfloat16 and float16 against their plain versions
    (float32 math on the 16-bit inputs, rounded once) within
    ``FLASH16_TOL``, at the RingLM path's shape and at odd shapes (the
    16-byte copies at D % 8 == 0, the element path at D = 5 and 20, masked
    rows, ragged edges); two launches bitwise equal; then timed at
    ``[40, 1023, 4, 32]`` and B4 at ``[16, 1023, 4, 32]`` beside the
    causal SDPA call in the same type, with two bounds: bytes, and
    operations at the 16-bit tensor-core rate (the least time the card
    needs; the float32 CUDA-core rate beside it).  The 16-bit instances of
    all three passes are the tensor-core kernels: at D = 32 each must show
    tensor-core instructions in its SASS, no spill and at least two blocks
    an SM."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    from msrflute_tpu_torch.ops import flash_attention as fa
    cases = [
        ("main", FLASH_MAIN),
        ("L17", (3, 17, 17, 2, 32, True, 0, 0)),
        ("offsets_masked_rows", (2, 100, 150, 2, 32, True, 0, 30)),
        ("non_causal", (2, 77, 130, 2, 32, False, 0, 0)),
        ("D8", (2, 65, 65, 2, 8, True, 0, 0)),
        ("D64", (2, 200, 200, 2, 64, True, 0, 0)),
        ("D128", (2, 129, 129, 2, 128, True, 0, 0)),
        ("ragged_diag_edge", (2, 150, 170, 2, 32, True, 37, 11)),
        ("D20", (2, 100, 90, 2, 20, True, 5, 0)),
        ("D5", (1, 70, 80, 2, 5, True, 10, 0)),
        ("BH1", (1, 1023, 1023, 1, 32, True, 0, 0)),
    ]
    rows, lines = [], {}
    tc_sass = _tensor_core_sass()
    for dt_name in STORAGE16:
        dt = getattr(torch, dt_name)
        tol = FLASH16_TOL[dt_name]
        errs, max_abs, _ = _flash_cases(
            torch, cases, dt, {"out": tol, "lse": FLASH_FWD_TOL,
                               "grads": tol})
        # timing at the path's shape
        B, Lq, Lk, H, D, causal, qo, ko = FLASH_MAIN
        q, k, v, g, g_lse = _flash16_case(torch, dt, B, Lq, Lk, H, D, 99)
        g_lse.zero_()
        out, lse = fa.flash_fwd(q, k, v, causal, qo, ko)
        args = (q, k, v, g, lse, fa.attention_delta(out, g), g_lse, causal,
                qo, ko)
        calls = {"fwd": lambda: fa.flash_fwd(q, k, v, causal, qo, ko),
                 "dq": lambda: fa.flash_dq(*args),
                 "dkv": lambda: fa.flash_dkv(*args)}
        t = {key: _device_ms(torch, fn) for key, fn in calls.items()}
        host_paced = {key: _time_ms(torch, fn, iters=20)
                      for key, fn in calls.items()}
        plain = {"fwd": _time_ms(torch, lambda: fa.attention_lse_plain(
                     q, k, v, causal, qo, ko), iters=5),
                 "dq": _time_ms(torch, lambda: fa.attention_dq_plain(*args),
                                iters=5),
                 "dkv": _time_ms(torch, lambda: fa.attention_dkv_plain(
                     *args), iters=5)}
        qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                      for x in (q, k, v))
        gt = g.transpose(1, 2).contiguous()

        def lib_fwd_call():
            with torch.no_grad():
                sdpa(qt, kt, vt, is_causal=True)

        lib_out = sdpa(qt, kt, vt, is_causal=True)
        lib_bwd_call = lambda: torch.autograd.grad(  # noqa: E731
            lib_out, (qt, kt, vt), gt, retain_graph=True)
        lib = {"fwd": _device_ms(torch, lib_fwd_call),
               "bwd": _device_ms(torch, lib_bwd_call)}
        pairs = _visible_pairs(torch, B, Lq, Lk, H, causal, qo, ko)
        qb, kb, sb = 2 * B * Lq * H * D, 2 * B * Lk * H * D, 4 * B * H * Lq
        work = {"fwd": (2 * 2 * D * pairs, qb + 2 * kb + qb + sb),
                "dq": (3 * 2 * D * pairs, 2 * qb + 2 * kb + 3 * sb + qb),
                "dkv": (4 * 2 * D * pairs, 2 * qb + 2 * kb + 3 * sb
                        + 2 * kb)}
        Be = FLASH_EVAL_B
        qe, ke, ve, _, _ = _flash16_case(torch, dt, Be, Lq, Lk, H, D, 98)
        qet, ket, vet = (x.transpose(1, 2).contiguous() for x in (qe, ke,
                                                                   ve))

        def eval_sdpa_call():
            with torch.no_grad():
                sdpa(qet, ket, vet, is_causal=True)

        e_flops = 2 * 2 * D * _visible_pairs(torch, Be, Lq, Lk, H, causal,
                                             qo, ko)
        e_bytes = work["fwd"][1] * Be // B
        e_ms = _device_ms(torch, lambda: fa.flash_fwd(qe, ke, ve, causal,
                                                      qo, ko))
        fwd_eval = {"shape": [Be, Lq, H, D], "ms": e_ms,
                    "ms_host_paced": _time_ms(torch, lambda: fa.flash_fwd(
                        qe, ke, ve, causal, qo, ko), iters=20),
                    "bound_ms": max(e_flops / PEAK_TC16_FLOPS,
                                    e_bytes / PEAK_BYTES_PER_S) * 1e3,
                    "bound_ms_f32": e_flops / PEAK_F32_FLOPS * 1e3,
                    "sdpa_fwd_ms": _device_ms(torch, eval_sdpa_call)}
        fwd_eval["share_of_bound"] = fwd_eval["bound_ms"] / e_ms
        max_err = {"fwd": max(max_abs["out"], max_abs["lse"]),
                   "dq": max_abs["dq"],
                   "dkv": max(max_abs["dk"], max_abs["dv"])}
        detail = {}
        for which, (key, name, line) in enumerate((
                ("fwd", "flash_attention_fwd", ":336"),
                ("dq", "flash_attention_dq", ":385"),
                ("dkv", "flash_attention_dkv", ":411"))):
            flops, nbytes = work[key]
            ops_ms = flops / PEAK_TC16_FLOPS * 1e3
            bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
            lib_ms = lib["fwd" if key == "fwd" else "bwd"]
            rows.append({
                "name": _arm(name, dt_name), "route": "cuda",
                "source": "msrflute_tpu_torch/csrc/flash_attention.cu",
                "replaces": f"msrflute_tpu/ops/pallas_attention.py{line}",
                "launches": None, "max_abs_err": max_err[key],
                "ms": t[key], "ms_host_paced": host_paced[key],
                "plain_ms": plain[key],
                "bound_ms": max(ops_ms, bytes_ms),
                "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
                "library_ms": lib_ms,
                "library_note": f"causal {dt_name} SDPA "
                                + ("forward" if key == "fwd" else
                                   "backward: dq, dk and dv together")})
            info = fa.kernel_info(which, D, dt)
            detail[key] = {
                "flops": flops, "bytes": nbytes,
                "bound_ms_bytes": bytes_ms, "bound_ms_tc16": ops_ms,
                "bound_ms_f32": flops / PEAK_F32_FLOPS * 1e3,
                "share_of_bound": max(ops_ms, bytes_ms) / t[key],
                "share_of_f32_bound": flops / PEAK_F32_FLOPS * 1e3 / t[key],
                "library_over_kernel": lib_ms / t[key], **info,
                "instance": _flash_entry(key, D, dt_name),
                "ptxas": ptxas_reports(BUILD_LOGS.get(
                    "flash_attention", "")).get(
                        _flash_entry(key, D, dt_name))}
            d = detail[key]
            d["tensor_core_instructions"] = tc_sass.get(d["instance"], 0)
            spills = d["ptxas"] or {"spill_store_bytes": 0,
                                    "spill_load_bytes": 0}
            check(d["tensor_core_instructions"] > 0,
                  f"{d['instance']}: no HMMA or HGMMA in its SASS")
            check(d["local_bytes"] == 0 and d["blocks_per_sm"] >= 2 and
                  spills["spill_store_bytes"] ==
                  spills["spill_load_bytes"] == 0,
                  f"{d['instance']} spills or fits one block an SM: {d}")
        lines[dt_name] = {"rel_err": errs, "max_abs_err_main": max_abs,
                          "tolerance": tol, "ms": t,
                          "host_paced": host_paced, "plain_ms": plain,
                          "sdpa_ms": lib, "fwd_at_eval_shape": fwd_eval,
                          "detail": detail}
        if dt_name == "bfloat16":
            lines[dt_name]["card_under_dq_and_dkv"] = _under_load(
                torch, lambda: (fa.flash_dq(*args), fa.flash_dkv(*args)))
    emit({"phase": "kernel", "ok": True,
          "name": "flash_attention 16-bit (B4, B5, B6)",
          "shape": list(FLASH_MAIN), "cases": len(cases),
          "bitwise_repeat": True, **lines})
    return rows


def _set_arm_launches(arm_rows, counts, path):
    """Each 16-bit arm row's launches on ``path``; ``launches`` is the
    count on the path that runs the arm (a row keeps the first it got)."""
    for row in arm_rows:
        n = counts.get(row["name"], 0)
        row.setdefault("launches_by_path", {})[path] = n
        if n and not row.get("launches"):
            row["launches"] = n


def _cnn16_config(dtype, rounds):
    """``CNN_CONFIG`` (B1 through ``pallas_apply``) with the model and the
    client's local copy in ``dtype``: ``model_config.dtype`` and
    ``precision: {params, compute}``."""
    raw = json.loads(json.dumps(CNN_CONFIG))
    raw["model_config"]["dtype"] = dtype
    raw["server_config"].update(max_iteration=rounds, val_freq=rounds,
                                rec_freq=rounds,
                                precision={"params": dtype,
                                           "compute": dtype})
    return raw


#: cuda vs cpu of the bf16 CNN_FEMNIST precision path (3 clients, one
#: local step a round, dropout off), relative L2 of the params: the bf16
#: local copy rounds every update to 8 bits, and where the two devices'
#: float32 sums differ a rounding flips and moves a weight by a bf16 ulp
#: (2^-8 relative).  An H100 measured 6.9e-5 after round 1 and 2.2e-4
#: after round 2; the bounds leave about tenfold room.
PRECISION_CROSS_TOL = {1: 1e-3, 2: 3e-3}


def phase_precision(torch, work, arm_rows):
    """CNN_FEMNIST with ``dtype: bfloat16``, ``precision: {params:
    bfloat16, compute: bfloat16}`` and ``pallas_apply``: kernel B1's bf16
    arm once a local step; then two cuda runs bitwise and cuda vs cpu
    within ``PRECISION_CROSS_TOL``; an absent and an explicit float32
    policy bitwise equal on the card; and a float16 leg (one round) for
    B1's f16 arm."""
    import numpy as np
    _reset_counts()
    server, out, secs = _run_cli(work, "precision",
                                 _cnn16_config("bfloat16", 3), "cuda")
    arms, totals = _read_arm_counts(), _read_counts()
    steps = server.engine.local_steps
    check(steps > 0 and arms[_arm("fused_sgd_apply", "bfloat16")] == steps
          == totals["fused_sgd_apply"],
          f"precision: B1 launches {arms} / {totals} for {steps} steps")
    check(server.engine.precision == {"params": "bfloat16",
                                      "compute": "bfloat16"} and
          server.state.params.dtype == torch.float32,
          "precision: the policy or the master params")
    train_loss = [r["value"] for r in _records(out, "Training loss")]
    check(len(train_loss) == 3 and all(map(math.isfinite, train_loss)),
          f"precision: training losses {train_loss}")
    _set_arm_launches(arm_rows, arms, "precision")
    rounds = server.run_stats["secsPerRound"]
    del server
    # reproducible on the card, near the cpu, on a small blob
    raw = _set_data(_cnn16_config("bfloat16", 2), _small_femnist(work))
    raw["model_config"].update(dropout1=0.0, dropout2=0.0)
    raw["server_config"].update(num_clients_per_iteration=3, val_freq=100,
                                rec_freq=100, initial_val=False,
                                rounds_per_step=1, model_backup_freq=1)
    raw["client_config"]["desired_max_samples"] = 20
    _cross_device(torch, work, "precision_cross_device", raw,
                  "cv_cnn_femnist", PRECISION_CROSS_TOL)
    # absent and explicit float32: one code path, bitwise on the card
    finals = {}
    for tag, block in (("absent", None),
                       ("float32", {"params": "float32",
                                    "compute": "float32",
                                    "stats": "float32"})):
        cfg = json.loads(json.dumps(raw))
        cfg["model_config"].pop("dtype")
        cfg["server_config"].pop("precision")
        if block:
            cfg["server_config"]["precision"] = block
        srv, _, _ = _run_cli(work, f"precision_{tag}", cfg, "cuda")
        finals[tag] = srv.state.params.clone()
        del srv
    check(torch.equal(finals["absent"], finals["float32"]),
          "precision: absent and explicit float32 differ on the card")
    # float16: one round for B1's f16 arm
    _reset_counts()
    srv, out16, _ = _run_cli(work, "precision_f16", _set_data(
        _cnn16_config("float16", 1), _small_femnist(work)), "cuda")
    arms16 = _read_arm_counts()
    check(arms16[_arm("fused_sgd_apply", "float16")] ==
          srv.engine.local_steps > 0,
          f"precision f16: B1 launches {arms16}")
    loss16 = [r["value"] for r in _records(out16, "Training loss")]
    check(all(map(math.isfinite, loss16)), f"precision f16: {loss16}")
    _set_arm_launches(arm_rows, arms16, "precision_f16")
    emit({"phase": "precision", "ok": True, "device": "cuda",
          "policy": {"params": "bfloat16", "compute": "bfloat16"},
          "local_steps": steps, "launches": arms, "train_loss": train_loss,
          "secs_per_round": rounds,
          "secs_per_round_after_first": float(np.mean(rounds[1:])),
          "run_seconds": round(secs, 3),
          "absent_equals_float32_on_card": True,
          "f16_leg": {"local_steps": srv.engine.local_steps,
                      "launches": arms16, "train_loss": loss16}})


#: bf16 RingLM, flash against dense over 2 rounds: relative L2 of the
#: change of the params.  In bf16 the two arms differ by more than the
#: f32 phase's 9e-7: the dense arm rounds its scores, softmax and
#: probabilities to bf16 (the JAX package's dense path), the flash arm
#: keeps them in float32 tiles and rounds only out and the gradients.  An
#: H100 measured 1.4e-3; the bound leaves about sevenfold room.
RINGLM16_FLASH_DENSE_TOL = 1e-2
#: cuda vs cpu of bf16 RingLM (one client of one step, one round: the cpu's
#: bfloat16 matmuls take 8 s a step): relative L2 of the params after the
#: round.  The params stay float32; the two devices
#: round the bf16 activations apart where their float32 sums differ, which
#: moves a gradient by up to about 1 % (as between the two packages,
#: ``tests/test_torch_dtype.py``) of an update that moves the params by
#: well under 1 %.  An H100 measured 1.4e-5 and 1.8e-5; the bounds leave
#: about tenfold room.
RINGLM16_CROSS_TOL = {1: 2e-4}


def phase_ringlm16(torch, work, arm_rows):
    """RingLM at full width (P = 945,370, seq_len 1024, batch 4, 500
    long-text users) with ``dtype: bfloat16`` and flash attention: B4-B6's
    bf16 arms (and B1, whose local copy stays f32); the loss falls; then
    ``ringlm_bf16_profile``, flash vs dense, two cuda runs bitwise and cuda
    vs cpu, and a float16 leg (one round) for B4-B6's f16 arms."""
    import numpy as np
    raw = ringlm_config(rounds=3)
    raw["model_config"]["dtype"] = "bfloat16"
    _reset_counts()
    server, out, secs = _run_cli(work, "ringlm_bf16", raw, "cuda",
                                 task="ringlm")
    arms = _read_arm_counts()
    layers = server.task.module.num_layers
    steps = server.engine.local_steps
    eval_steps = sum(server._eval_batches[h["split"]]["sample_mask"].shape[0]
                     for h in server.history)
    want = {_arm("flash_attention_fwd", "bfloat16"):
            layers * (steps + eval_steps),
            _arm("flash_attention_dq", "bfloat16"): layers * steps,
            _arm("flash_attention_dkv", "bfloat16"): layers * steps}
    check(steps > 0 and all(arms[k] == n for k, n in want.items()) and
          _read_counts()["fused_sgd_apply"] == steps,
          f"ringlm_bf16 launches {arms}, want {want}")
    check(server.task.module.dtype == torch.bfloat16 and
          server.state.params.dtype == torch.float32,
          "ringlm_bf16: the model or the master params")
    val = [(h["round"], h["loss"]) for h in server.history
           if h["split"] == "val"]
    check(len(val) == 2 and all(math.isfinite(x) for _, x in val) and
          val[1][1] < val[0][1], f"ringlm_bf16: the val loss {val}")
    _set_arm_launches(arm_rows, arms, "ringlm_bf16")
    rounds = server.run_stats["secsPerRound"]
    emit({"phase": "ringlm_bf16", "ok": True, "device": "cuda",
          "params": server.engine.layout.numel, "local_steps": steps,
          "eval_steps": eval_steps, "launches": arms, "val": val,
          "secs_per_round": rounds,
          "secs_per_round_after_first": float(np.mean(rounds[1:])),
          "run_seconds": round(secs, 3)})
    sampled = server._sample()
    from msrflute_tpu_torch.data.batching import pack_round_batches
    batch = pack_round_batches(
        server.train_dataset, sampled, server.batch_size,
        server._chunk_steps([sampled]), rng=server._np_rng)
    engine, state = server.engine, server.state

    def step():
        nonlocal state
        state = engine.run_round(state, batch, 0.1, 1.0)[0]

    emit({"phase": "ringlm_bf16_profile", "ok": True, "rounds": 2,
          **_trace_rounds(torch, step, 1, "ringlm_bf16_profile"),
          "f32_ringlm_profile_same_call": F32_PROFILE.get("ringlm_profile")})
    del server, engine, state
    # flash against dense, both bf16
    two = ringlm_config(rounds=2)
    two["model_config"]["dtype"] = "bfloat16"
    two["server_config"].update(val_freq=100, rec_freq=100,
                                initial_val=False, model_backup_freq=1)
    final = {}
    for flash in (True, False):
        two["model_config"]["flash_attention"] = flash
        srv, _, _ = _run_cli(work, f"ringlm_bf16_flash_{flash}", two, "cuda",
                             task="ringlm")
        final[flash] = srv.state.params.double().cpu()
        init = srv.engine.layout.flatten(srv.task.init_params(0)).double()
        del srv
    d_flash, d_dense = final[True] - init, final[False] - init
    rel = float((d_flash - d_dense).norm() / d_dense.norm())
    check(rel <= RINGLM16_FLASH_DENSE_TOL,
          f"ringlm_bf16 flash vs dense: rel L2 {rel}")
    emit({"phase": "ringlm_bf16_flash_vs_dense", "ok": True, "rounds": 2,
          "rel_l2_of_update": rel, "tolerance": RINGLM16_FLASH_DENSE_TOL})
    cross = ringlm_config(rounds=1)
    cross["model_config"]["dtype"] = "bfloat16"
    cross["server_config"].update(num_clients_per_iteration=1, val_freq=100,
                                  rec_freq=100, initial_val=False,
                                  rounds_per_step=1, model_backup_freq=1)
    cross["client_config"]["desired_max_samples"] = 4
    _cross_device(torch, work, "ringlm_bf16_cross_device", cross, "ringlm",
                  RINGLM16_CROSS_TOL)
    # float16: one round of 2 clients for B4-B6's f16 arms
    f16 = ringlm_config(rounds=1)
    f16["model_config"]["dtype"] = "float16"
    f16["server_config"].update(num_clients_per_iteration=2)
    _reset_counts()
    srv, out16, _ = _run_cli(work, "ringlm_f16", f16, "cuda", task="ringlm")
    arms16 = _read_arm_counts()
    steps16 = srv.engine.local_steps
    check(steps16 > 0 and arms16[_arm("flash_attention_dq", "float16")] ==
          layers * steps16, f"ringlm_f16 launches {arms16}")
    loss16 = [r["value"] for r in _records(out16, "Training loss")]
    check(all(map(math.isfinite, loss16)), f"ringlm_f16 losses {loss16}")
    _set_arm_launches(arm_rows, arms16, "ringlm_f16")
    emit({"phase": "ringlm_f16", "ok": True, "local_steps": steps16,
          "launches": arms16, "train_loss": loss16})


#: the dtype phase's families: (experiments/ folder, task, data dir,
#: writer, splits); data generated here at the published widths
def _mnist_blob(path, num_users, lo, hi, seed):
    """MNIST-shaped users for LR: 28x28 uint8 images written flat, 10
    classes."""
    import numpy as np
    rng = np.random.default_rng(seed)
    users = [f"m{seed}_{i:04d}" for i in range(num_users)]
    counts = rng.integers(lo, hi + 1, size=num_users).tolist()
    rows, labels = [], {}
    for u, n in zip(users, counts):
        rows.append(_pixel_rows(rng.integers(0, 256, size=(n, 784),
                                             dtype=np.uint8)))
        labels[u] = rng.integers(0, 10, size=n).tolist()
    _write_json_blob(path, users, rows, labels)
    return sum(counts)


DTYPE_ROUNDS = 2


def _dtype_families():
    return (
        ("cv_lr_mnist", "mnist", lambda p, n, s: _mnist_blob(p, n, 20, 60,
                                                             s)),
        ("classif_cnn", "cifar10_16", lambda p, n, s: write_cifar100_blob(
            p, n, 40, s, classes=10)),
        ("cv_resnet_fedcifar100", "fedcifar100_16",
         lambda p, n, s: write_cifar100_blob(p, n, 40, s)),
        ("nlp_rnn_fedshakespeare", "shakespeare_16",
         lambda p, n, s: write_shakespeare_blob(p, n, 4, 41, s)),
    )


def phase_dtype(torch, work):
    """LR, CIFAR_CNN, ResNet-18-GN and the LSTM at their shipped widths in
    ``dtype: bfloat16`` (B1's f32 arm, as their params stay f32): 2 rounds,
    twice, bitwise; secs/round beside the same config in float32 from this
    call."""
    out = {}
    for name, data_dir, writer in _dtype_families():
        os.makedirs(os.path.join(work, data_dir), exist_ok=True)
        for split, users, seed in (("train", 40, 60), ("val", 4, 61),
                                   ("test", 4, 62)):
            writer(os.path.join(work, data_dir, f"{split}.json"), users,
                   seed)
        raw = _set_data(_experiment_config(name), data_dir)
        raw["server_config"].update(
            max_iteration=DTYPE_ROUNDS, val_freq=100, rec_freq=100,
            initial_val=False, rounds_per_step=1, model_backup_freq=100,
            megakernel={"pallas_apply": True})
        runs = {}
        for tag, dtype in (("bf16", "bfloat16"), ("bf16_again", "bfloat16"),
                           ("f32", "float32")):
            raw["model_config"]["dtype"] = dtype
            srv, _, _ = _run_cli(work, f"dtype_{name}_{tag}", raw, "cuda",
                                 task=name)
            check(srv.task.module.dtype == getattr(torch, dtype) and
                  srv.state.params.dtype == torch.float32,
                  f"dtype {name}: the model or the master params")
            runs[tag] = (srv.state.params.clone(),
                         srv.run_stats["secsPerRound"])
            del srv
        check(torch.equal(runs["bf16"][0], runs["bf16_again"][0]) and
              bool(torch.isfinite(runs["bf16"][0]).all()),
              f"dtype {name}: two bf16 cuda runs differ")
        out[name] = {"secs_per_round_bf16": runs["bf16"][1],
                     "secs_per_round_bf16_again": runs["bf16_again"][1],
                     "secs_per_round_f32": runs["f32"][1]}
    emit({"phase": "dtype", "ok": True, "rounds": DTYPE_ROUNDS,
          "reproducible": True, **out})


#: cuda vs cpu of the optimizer legs (LR at its shipped widths, 2 rounds
#: of 3 clients): relative L2 of the params after each round.  Only the
#: order of float32 sums differs (cuBLAS against the CPU's GEMMs, the
#: per-leaf norms of lamb and lars): an H100 measured at most 1.3e-7
#: (lamb); the bound leaves about hundredfold room.
OPT_CROSS_TOL = {1: 1e-5, 2: 1e-5}


def phase_optimizers(torch, work):
    """One cheap path (LR on the ``mnist`` blob of :func:`phase_dtype`)
    through each new piece: server ``lamb``, ``lars`` and ``yogi``, client
    SGD with nesterov and weight decay, the ``rampup-keep-expdecay-keep``
    schedule, ``freeze_layer``, and server replay with ``updatable_names``
    on a ``train_data_server`` blob; each leg twice on cuda, bitwise, and
    against cpu within ``OPT_CROSS_TOL`` (:func:`_cross_device`)."""
    _mnist_blob(os.path.join(work, "mnist", "server.json"), 3, 20, 40, 63)
    base = _set_data(_experiment_config("cv_lr_mnist"), "mnist")
    base["server_config"].update(
        max_iteration=2, num_clients_per_iteration=3, val_freq=100,
        rec_freq=100, initial_val=False, rounds_per_step=1,
        model_backup_freq=1)
    legs = {
        "server_lamb": {"server_config.optimizer_config":
                        {"type": "lamb", "lr": 0.01, "weight_decay": 0.01}},
        "server_lars": {"server_config.optimizer_config":
                        {"type": "lars", "lr": 1.0, "momentum": 0.9,
                         "weight_decay": 1e-4}},
        "server_yogi": {"server_config.optimizer_config":
                        {"type": "yogi", "lr": 0.01, "eps": 1e-3}},
        "client_sgd_nesterov_wd": {"client_config.optimizer_config":
                                   {"type": "sgd", "lr": 0.03,
                                    "momentum": 0.9, "nesterov": True,
                                    "weight_decay": 1e-4}},
        "rampup_schedule": {"server_config.annealing_config":
                            {"type": "rampup-keep-expdecay-keep",
                             "peak_lr": 1.0, "floor_lr": 0.1,
                             "rampup_steps": 1, "hold_steps": 0,
                             "decay_steps": 2}},
        "freeze_layer": {"client_config.freeze_layer": ["Dense_0/bias"]},
        "server_replay": {"server_config.server_replay_config":
                          {"server_iterations": 2,
                           "updatable_names": [r"Dense_0\.kernel"],
                           "optimizer_config": {"type": "sgd",
                                                "lr": 0.01}},
                          "server_config.data_config.train":
                          {"batch_size": 10,
                           "train_data_server": "mnist/server.json"}},
    }
    for leg, edits in legs.items():
        raw = json.loads(json.dumps(base))
        for path, value in edits.items():
            node = raw
            keys = path.split(".")
            for k in keys[:-1]:
                node = node.setdefault(k, {})
            node[keys[-1]] = value
        replays = leg == "server_replay"
        _cross_device(torch, work, f"optimizers_{leg}", raw, "cv_lr_mnist",
                      OPT_CROSS_TOL, extra=lambda srv, replays=replays: (
                          check((srv.server_replay is not None) == replays,
                                f"optimizers {leg}: server replay"), {})[1])
    emit({"phase": "optimizers", "ok": True, "legs": sorted(legs)})


# ----------------------------------------------------------------------
# the strategies beyond FedAvg / DGA, DGA's RL hook and classif_cnn
# ----------------------------------------------------------------------
def phase_kernel_quant_ef(torch):
    """B3 at EF quantization's layout: ``[10, 1,206,590]`` (the strategies
    phase's K and CNN_FEMNIST's P) with one leaf a row, offsets ``(0,
    P)``, against its plain version bitwise at 16 levels (``quant_bits:
    4``) and at 1024 and 2; then timed at 16 levels beside its yardstick,
    with the byte bound (8 bytes an element) and its share."""
    from msrflute_tpu_torch.ops.quant_bin import (quant_bin_plain,
                                                  quant_bin_sparsify)
    K, P = MAIN_K, MAIN_P
    bounds = [0, P]
    gen = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn((K, P), device="cuda", generator=gen)
    x *= torch.logspace(-4, -1, K, device="cuda")[:, None]
    off, lo, hi, th = _quant_case(torch, x, bounds, EF_QUANT_THRESH)
    max_err = 0.0
    for n_bins in (2 ** EF_QUANT_BITS, 1024, 2):
        k = quant_bin_sparsify(x, off, lo, hi, th, n_bins)
        pl = quant_bin_plain(x, off.cpu(), lo, hi, th, n_bins)
        torch.cuda.synchronize()
        err = float((k - pl).abs().max())
        max_err = max(max_err, err)
        check(torch.equal(k, pl), f"quant_bin at the EF layout, n_bins="
                                  f"{n_bins}: kernel != plain (max abs "
                                  f"err {err})")
    del k, pl
    timed = _quant_timing(torch, x, bounds, off, lo, hi, th,
                          n_bins=2 ** EF_QUANT_BITS)
    emit({"phase": "kernel", "ok": True, "name": "quant_bin_sparsify",
          "layout": "ef_quant: one leaf a client row", "bitwise": True,
          "n_bins": 2 ** EF_QUANT_BITS, **timed})
    del x
    torch.cuda.empty_cache()
    row = _quant_row(timed, max_err)
    row["layout"] = "one leaf a row (ef_quant)"
    return row


#: EF quantization's settings on the strategies phase
EF_QUANT_BITS, EF_QUANT_THRESH = 4, 0.0
STRATEGY_ROUNDS = 3
#: ``(strategy, server_config, client_config)`` of each leg of the
#: strategies phase, over CNN_CONFIG (CNN_FEMNIST, 350 writers, 10
#: clients at batch 20, ``pallas_apply``)
STRATEGY_LEGS = {
    "qffl": ("qffl", {"qffl_q": 1.0}, {}),
    "fedac": ("fedac", {"fedac_eta": 0.5, "fedac_gamma": 1.0}, {}),
    "fedbuff": ("fedbuff", {"fedbuff": {"max_staleness": 4}}, {}),
    "scaffold": ("scaffold", {}, {}),
    "scaffold_device": ("scaffold", {"scaffold_device_controls": True}, {}),
    "ef_quant": ("ef_quant", {}, {"quant_bits": EF_QUANT_BITS,
                                  "quant_thresh": EF_QUANT_THRESH}),
    "ef_quant_device": ("ef_quant", {"ef_device_residuals": True},
                        {"quant_bits": EF_QUANT_BITS,
                         "quant_thresh": EF_QUANT_THRESH}),
}
#: the legs whose per-client rows are resumed bit for bit
RESUMED_LEGS = ("scaffold", "scaffold_device", "ef_quant", "ef_quant_device")


def strategy_config(leg, rounds=STRATEGY_ROUNDS, data_dir="femnist"):
    """CNN_CONFIG under the leg's strategy, a val eval at the end only."""
    strategy, server, client = STRATEGY_LEGS[leg]
    raw = _set_data(json.loads(json.dumps(CNN_CONFIG)), data_dir)
    raw["strategy"] = strategy
    raw["server_config"].update(max_iteration=rounds, val_freq=rounds,
                                rec_freq=1000, initial_val=False,
                                rounds_per_step=1, **server)
    raw["client_config"].update(client)
    return raw


def _store_rows(server):
    """``{client id: row}`` of the leg's durable store (and SCAFFOLD's
    ``c`` under -1), as numpy."""
    import numpy as np
    store = server.scaffold_store or server.ef_store
    ids = store.persisted_client_ids()
    if server.scaffold_store is not None:
        rows = {i: store.ci(i) for i in ids}
        rows[-1] = store.c
        return rows
    return dict(zip(ids, store.rows(np.asarray(ids))))


def phase_strategies(torch, work, kernel_rows, ef_row):
    """q-FFL, FedAC, FedBuff (``max_staleness: 4``), SCAFFOLD on the host
    store and on the ``[350, P]`` device table, and EF quantization
    (``quant_bits: 4``) on the host store and the device table, each 3
    rounds through the CLI at CNN_FEMNIST's published width on ``main``'s
    350 writers: B1 once a local step (SCAFFOLD's ``c - c_i`` goes in with
    the gradient), B3 once a round on the EF legs (one leaf a client row)
    and no other kernel; finite losses.  Then each store leg again, cut
    after round 2 and resumed to 3 through the CLI: the params and the
    store's rows are bitwise those of the uninterrupted leg."""
    legs = {}
    _strategy_legs(torch, work, kernel_rows, legs)
    ef_launches = sum(leg["launches"]["quant_bin_sparsify"]
                      for leg in legs.values())
    ef_row["launches"] = ef_launches
    emit({"phase": "strategies", "ok": True, "params": MAIN_P,
          "clients_per_round": MAIN_K, "writers": 350,
          "rounds": STRATEGY_ROUNDS, "legs": legs})


def _strategy_legs(torch, work, kernel_rows, legs):
    import numpy as np
    for leg in STRATEGY_LEGS:
        tic = time.time()
        _reset_counts()
        server, out, secs = _run_cli(work, f"strategies_{leg}",
                                     strategy_config(leg), "cuda")
        launches = _read_counts()
        steps = server.engine.local_steps
        ef = leg.startswith("ef_quant")
        want = {k: 0 for k in launches}
        want["fused_sgd_apply"] = steps
        want["quant_bin_sparsify"] = STRATEGY_ROUNDS if ef else 0
        check(steps > 0 and launches == want,
              f"strategies {leg}: launches {launches}, want {want}")
        for row in kernel_rows:
            row.setdefault("launches_by_path", {})[f"strategies_{leg}"] = \
                launches[row["name"]]
        train_loss = [r["value"] for r in _records(out, "Training loss")]
        val = [h["loss"] for h in server.history if h["split"] == "val"]
        check(len(train_loss) == STRATEGY_ROUNDS and
              all(map(math.isfinite, train_loss + val)) and len(val) == 1,
              f"strategies {leg}: losses {train_loss} val {val}")
        check(server.state.params.is_cuda, f"{leg}: params not on cuda")
        rounds = server.run_stats["secsPerRound"]
        record = {"secs_per_round": rounds,
                  "secs_per_round_after_first": float(np.mean(rounds[1:])),
                  "local_steps": steps, "launches": launches,
                  "train_loss": train_loss, "val_loss": val[0],
                  "run_seconds": round(secs, 3)}
        store = server.scaffold_store or server.ef_store
        if store is not None:
            check(store.round() == STRATEGY_ROUNDS,
                  f"{leg}: round marker {store.round()}")
            table = server.scaffold_device or server.ef_device
            record["device_table_gb"] = (
                None if table is None else
                table.table.numel() * 4 / 1e9)
            check(table is None or table.table.is_cuda,
                  f"{leg}: device table not on cuda")
        if leg.startswith("scaffold"):
            norm = [r["value"] for r in _records(out,
                                                 "Control norm (server c)")]
            check(len(norm) == STRATEGY_ROUNDS and
                  all(map(math.isfinite, norm)) and norm[-1] > 0,
                  f"{leg}: control norms {norm}")
            record["control_norm"] = norm
        if leg in RESUMED_LEGS:
            want_params = server.state.params.cpu()
            want_rows = _store_rows(server)
            del server
            torch.cuda.empty_cache()
            name = f"strategies_{leg}_resume"
            cut, _, _ = _run_cli(work, name, strategy_config(leg, rounds=2),
                                 "cuda")
            if leg in FUSED_HOST_LEGS:
                # the fused_carry phase holds its carry legs, 2 rounds,
                # to this state
                HOST_FINAL[leg] = _host_leg_state(cut)
            del cut
            raw = strategy_config(leg)
            raw["server_config"]["resume_from_checkpoint"] = True
            resumed, _, _ = _run_cli(work, name, raw, "cuda")
            check(resumed.state.round == STRATEGY_ROUNDS,
                  f"{leg}: resumed run ended at {resumed.state.round}")
            got_rows = _store_rows(resumed)
            check(torch.equal(resumed.state.params.cpu(), want_params),
                  f"{leg}: resumed params differ from the uninterrupted "
                  "run")
            check(sorted(got_rows) == sorted(want_rows) and all(
                np.array_equal(got_rows[i], want_rows[i])
                for i in want_rows),
                  f"{leg}: resumed store rows differ from the "
                  "uninterrupted run")
            record["resume_bitwise"] = {"params": True,
                                        "rows": len(want_rows)}
            del resumed
        else:
            del server
        torch.cuda.empty_cache()
        record["seconds"] = round(time.time() - tic, 3)
        legs[leg] = record


RL_ROUNDS = 3


def phase_rl(torch, work, kernel_rows):
    """``dga``'s config with ``wantRL: true`` and local DP off (as in
    ``dga_learns``: local DP's noise puts entries of the RL state vector,
    the clients' weights and pseudo-gradient statistics, so far out that
    the DQN's first SGD step diverged in a CPU rehearsal), 3 rounds through
    the CLI: a round makes candidate A (DGA's weights) and B (the RL
    weights) from one state, validates both, keeps one, trains the DQN.
    B1 once a local step and B3 once a round (DGA's quantization in the
    client step); B2 (global DP) is not on this path: the JAX package's RL
    round applies its own aggregate (``apply_custom_weights``) and never
    the strategy's combine, where global DP lives."""
    raw = dga_config(rounds=RL_ROUNDS)
    raw["dp_config"]["enable_local_dp"] = False
    raw["server_config"]["wantRL"] = True
    _reset_counts()
    server, out, secs = _run_cli(work, "rl", raw, "cuda", task="nlg_gru")
    launches = _read_counts()
    steps = server.engine.local_steps
    want = {k: 0 for k in launches}
    want.update(fused_sgd_apply=steps, quant_bin_sparsify=RL_ROUNDS)
    check(steps > 0 and launches == want,
          f"rl launches {launches}, want {want}")
    for row in kernel_rows:
        row.setdefault("launches_by_path", {})["rl"] = launches[row["name"]]
    rewards = [r["value"] for r in _records(out, "RL Rewards")]
    accs = [r["value"] for r in _records(out, "Val acc (baseline vs RL)")]
    running = [r["value"] for r in _records(out, "RL Running Loss")]
    check(len(rewards) == RL_ROUNDS and
          set(rewards) <= {1.0, 0.1, -1.0} and
          len(server.rl_kept) == RL_ROUNDS and
          all(map(math.isfinite, running)),
          f"rl rewards {rewards} kept {server.rl_kept} loss {running}")
    check(os.path.exists(server.rl.model_name), "no RL model file")
    check(all(math.isfinite(h["loss"]) for h in server.history),
          f"rl evals {server.history}")
    emit({"phase": "rl", "ok": True, "rounds": RL_ROUNDS,
          "rewards": rewards, "kept_rl_candidate": server.rl_kept,
          "val_acc_baseline_vs_rl": accs, "rl_running_loss": running,
          "epsilon": server.rl.epsilon, "local_steps": steps,
          "launches": launches,
          "secs_per_round": server.run_stats["secsPerRound"],
          "run_seconds": round(secs, 3)})
    del server


#: experiments/classif_cnn's CIFAR-10 cut to what generates in seconds:
#: (split, clients, images a client, seed)
CIFAR10_SPLITS = (("train", 100, 50, 60), ("val", 10, 100, 61),
                  ("test", 10, 100, 62))
CLASSIF_ROUNDS = 3


def write_cifar10_hdf5(path, num_users, per_user, seed):
    """:func:`write_cifar100_blob`'s images at 10 classes in the hdf5
    layout (``uint8 [n, 32, 32, 3]`` a user), through the port's writer."""
    import numpy as np
    from msrflute_tpu_torch.data.user_blob import (UserBlob,
                                                   save_user_blob_hdf5)
    n = num_users * per_user
    x, y = _template_images(np.random.default_rng(seed), n, 10)
    x = x.reshape(n, 32, 32, 3)
    cut = [slice(i * per_user, (i + 1) * per_user) for i in range(num_users)]
    save_user_blob_hdf5(path, UserBlob(
        [f"c{seed}_{i:04d}" for i in range(num_users)],
        [per_user] * num_users, [x[c] for c in cut], [y[c] for c in cut]))
    return n


def phase_classif_cnn(torch, work, kernel_rows):
    """``experiments/classif_cnn/config.yaml`` (CIFAR_CNN, ``f1_score`` the
    best-model criterion, ``rounds_per_step: 20``) plus ``pallas_apply``,
    3 rounds through the CLI on generated hdf5 blobs (their JSON twin when
    this machine has no ``h5py``; the line says which): B1 once a local
    step, finite losses, ``f1_score`` logged and its best model saved."""
    try:
        import h5py  # noqa: F401
        hdf5 = True
    except ImportError:
        hdf5 = False
    ext = "hdf5" if hdf5 else "json"
    os.makedirs(os.path.join(work, "cifar10"), exist_ok=True)
    tic = time.time()
    for split, users, per_user, seed in CIFAR10_SPLITS:
        path = os.path.join(work, "cifar10", f"{split}.{ext}")
        if hdf5:
            write_cifar10_hdf5(path, users, per_user, seed)
        else:
            write_cifar100_blob(path, users, per_user, seed, classes=10)
    blob_s = time.time() - tic
    raw = _experiment_config("classif_cnn")
    raw["server_config"].update(
        max_iteration=CLASSIF_ROUNDS, val_freq=CLASSIF_ROUNDS,
        rec_freq=CLASSIF_ROUNDS, megakernel={"pallas_apply": True})
    dc = raw["server_config"]["data_config"]
    dc["val"]["val_data"] = f"cifar10/val.{ext}"
    dc["test"]["test_data"] = f"cifar10/test.{ext}"
    raw["client_config"]["data_config"]["train"]["list_of_train_data"] = \
        f"cifar10/train.{ext}"
    _reset_counts()
    server, out, secs = _run_cli(work, "classif_cnn", raw, "cuda",
                                 task="classif_cnn")
    launches = _read_counts()
    _b1_alone("classif_cnn", launches, server.engine.local_steps)
    for row in kernel_rows:
        row.setdefault("launches_by_path", {})["classif_cnn"] = \
            launches[row["name"]]
    check(server.engine.layout.numel == CIFAR_CNN_P,
          f"CIFAR_CNN has {server.engine.layout.numel} params")
    train_loss = [r["value"] for r in _records(out, "Training loss")]
    f1 = [r["value"] for r in _records(out, "Val f1_score")]
    check(len(train_loss) == CLASSIF_ROUNDS and
          all(map(math.isfinite, train_loss)), f"losses {train_loss}")
    check(len(f1) == 2 and all(0.0 <= v <= 1.0 for v in f1),
          f"Val f1_score {f1}")
    check(os.path.exists(os.path.join(out, "models",
                                      "best_val_f1_score_model.pt")),
          "no best_val_f1_score_model.pt")
    emit({"phase": "classif_cnn", "ok": True, "hdf5": hdf5,
          "params": CIFAR_CNN_P,
          "users": {s[0]: s[1] for s in CIFAR10_SPLITS},
          "population_note": "CIFAR-10's 50,000 train images cut to 100 "
                             "clients of 50 (synthetic template images)",
          "blob_seconds": round(blob_s, 3), "run_seconds": round(secs, 3),
          "secs_per_round": server.run_stats["secsPerRound"],
          "local_steps": server.engine.local_steps, "launches": launches,
          "train_loss": train_loss, "val_f1_score": f1,
          "evals": [{"split": h["split"], "round": h["round"],
                     "loss": h["loss"], "f1_score": h["f1_score"]}
                    for h in server.history]})
    del server


#: cuda vs cpu on the strategies' legs at 4 clients a round on
#: :func:`_small_femnist`'s writers, dropout off, relative L2 of the params
#: after rounds 1 and 2: only reduction order differs, as on the FedAvg CNN
#: path (CROSS_TOL), and EF's 16 levels move an element by a level where it
#: lands on another one.  q-FFL, FedAC and FedBuff measured 8.0e-5–8.9e-5
#: after round 1 and 1.5e-3–2.8e-3 after round 2 (an H100, PR 13).
STRATEGY_CROSS_TOL = {1: 5e-4, 2: 2e-2}
#: EF quantization's leg: one float32 difference can move an element of a
#: payload across a level of its 16 (a whole level, a fifteenth of the
#: row's range), which the other legs' bound cannot hold: 2.2e-3 after
#: round 1 on an H100 (PR 13).  Its round 2 is not held: the levels moved
#: in round 1 grow with round 2's local steps, as every CNN leg's
#: differences do (about tenfold a round), past a bound that would still
#: single out a fault
EF_CROSS_TOL = {1: 2e-2}
#: SCAFFOLD's server control ``c`` after round 2: a sum of pseudo-gradient
#: differences over ``K lr``, whose relative error is the payloads', not the
#: params' (which the payloads move by a small step): 2.8e-2 on an H100
#: (PR 13)
SCAFFOLD_C_CROSS_TOL = 1e-1
STRATEGY_CROSS_LEGS = ("qffl", "fedac", "fedbuff", "scaffold", "ef_quant")


def phase_cross_device_strategies(torch, work):
    """Each new strategy's CNN_FEMNIST leg, 2 rounds of 4 clients,
    :func:`_cross_device` (FedBuff draws its staleness on the host, so
    both devices start their clients from the same versions; EF is held
    after round 1 alone, ``EF_CROSS_TOL``)."""
    for leg in STRATEGY_CROSS_LEGS:
        raw = strategy_config(leg, rounds=2, data_dir=_small_femnist(work))
        raw["model_config"].update(dropout1=0.0, dropout2=0.0)
        raw["server_config"].update(num_clients_per_iteration=4,
                                    val_freq=100, model_backup_freq=1)
        scaffold = leg == "scaffold"
        _cross_device(
            torch, work, f"strategies_cross_device_{leg}", raw,
            "cv_cnn_femnist",
            EF_CROSS_TOL if leg == "ef_quant" else STRATEGY_CROSS_TOL,
            extra=(lambda srv: {"c": torch.from_numpy(
                srv.scaffold_store.c)}) if scaffold else None,
            extra_tol={"c": SCAFFOLD_C_CROSS_TOL} if scaffold else None)



# ----------------------------------------------------------------------
#: the defense phase: chaos client faults and corruption,
#: fluteshield's screening and robust aggregators, secure aggregation and
#: local DP with adaptive clipping, each a leg over CNN_CONFIG (CNN_FEMNIST
#: at P = 1,206,590, 10 clients at batch 20, the 350 writers,
#: ``pallas_apply``), 3 rounds through the CLI
DEFENSE_ROUNDS = 3
DEFENSE_CHAOS = {"seed": 0, "dropout_rate": 0.2, "straggler_rate": 0.2,
                 "corrupt_nan_rate": 0.1, "corrupt_scale_rate": 0.1,
                 "corrupt_scale_factor": 50.0,
                 "corrupt_sign_flip_rate": 0.1}
SCREENED_MEAN = {"norm_multiplier": 5.0}
#: ``(strategy, server_config, dp_config)`` of each leg: (a) .. (f)
DEFENSE_LEGS = {
    "dp_adaptive": ("fedavg", {}, {
        "enable_local_dp": True, "eps": -1.0, "max_grad": 10.0,
        "adaptive_clipping": {"target_quantile": 0.5, "clip_lr": 0.2,
                              "initial_clip": 1.0}}),
    "chaos_shield": ("fedavg", {"chaos": DEFENSE_CHAOS,
                                "robust": SCREENED_MEAN}, None),
    "chaos_trimmed_mean": ("fedavg", {"chaos": DEFENSE_CHAOS, "robust": {
        "aggregator": "trimmed_mean", "trim_fraction": 0.1}}, None),
    "chaos_median": ("fedavg", {"chaos": DEFENSE_CHAOS,
                                "robust": {"aggregator": "median"}}, None),
    "secagg_full": ("secure_agg", {"chaos": DEFENSE_CHAOS,
                                   "robust": SCREENED_MEAN,
                                   "secure_agg": {"graph": "full"}}, None),
    "secagg_log": ("secure_agg", {
        "chaos": {"seed": 0, "dropout_rate": 0.2},
        "secure_agg": {"graph": "log", "min_survivors": 8}}, None),
}
#: the legs cut after round 2 and resumed to 3, bit for bit
DEFENSE_RESUMED = ("dp_adaptive", "secagg_full")
#: the legs run cuda, cuda, cpu at 4 clients for 2 rounds
DEFENSE_CROSS_LEGS = ("chaos_shield", "chaos_trimmed_mean", "secagg_full")
#: ``main``'s secs/round after the first, for the legs' lines
MAIN_SECS = {}


def defense_config(leg, rounds=DEFENSE_ROUNDS, data_dir="femnist"):
    """CNN_CONFIG under the leg's strategy and defenses, a val eval at the
    end only."""
    strategy, server, dp = DEFENSE_LEGS[leg]
    raw = _set_data(json.loads(json.dumps(CNN_CONFIG)), data_dir)
    raw["strategy"] = strategy
    raw["server_config"].update(max_iteration=rounds, val_freq=rounds,
                                rec_freq=1000, initial_val=False,
                                rounds_per_step=1,
                                **json.loads(json.dumps(server)))
    if dp is not None:
        raw["dp_config"] = json.loads(json.dumps(dp))
    return raw


def _defense_replay(raw, rounds):
    """The host's replay of the chaos schedule over the rounds the engine
    ran (``rounds``: ``(round, sample_mask, client_mask)``): each round's
    expected counters."""
    import numpy as np
    from msrflute_tpu_torch.resilience.chaos import (
        CORRUPT_NAN, CORRUPT_SCALE, CORRUPT_SIGN_FLIP, make_chaos)
    sched = make_chaos(raw["server_config"])
    want = []
    for r, sm, cm in rounds:
        row = {}
        live = cm
        if sched is None:
            want.append({"live": float(live.sum())})
            continue
        if sched.has_client_faults:
            drop, keep = sched.client_faults(r, sm)
            live = cm * (1.0 - drop)
            steps = sm.sum(axis=2) > 0
            real = steps.sum(axis=1)
            row.update({
                "Chaos dropped clients": float((cm * drop).sum()),
                "Chaos stragglers": float((live * (keep < real)).sum()),
                "Chaos steps lost": float(sum(
                    steps[k, int(min(keep[k], sm.shape[1])):].sum() * live[k]
                    for k in range(len(keep))))})
        if sched.has_corruption:
            mode = np.where(live > 0, sched.corrupt_modes(r, len(cm)), 0)
            row.update({
                "Chaos NaN-injected clients": float((mode == CORRUPT_NAN)
                                                    .sum()),
                "Chaos scaled clients": float((mode == CORRUPT_SCALE).sum()),
                "Chaos sign-flipped clients": float(
                    (mode == CORRUPT_SIGN_FLIP).sum())})
        row["live"] = float(live.sum())
        want.append(row)
    return want


def phase_defense(torch, work, kernel_rows):
    """Legs (a)-(f) of :data:`DEFENSE_LEGS` through the CLI: (a) clip-only
    local DP with adaptive clipping; (b) chaos (dropout 0.2, stragglers
    0.2, NaN 0.1, x50 scale 0.1, sign flip 0.1) under the screened mean;
    (c) (b) under the trimmed mean (0.1); (d) (b) under the median; (e)
    secure_agg, ``graph: full``, under (b)'s chaos and the screened mean;
    (f) secure_agg, ``graph: log``, ``min_survivors: 8``, under (b)'s
    dropout.  Each: B1 once a local step and no other kernel; finite
    losses; every round's chaos counters equal the host's replay of the
    schedule, every NaN-injected client quarantined as non-finite, on the
    secure_agg legs every dropped client recovered (and on (e) every
    quarantined one), on (f) the aborted rounds those the replay leaves
    with fewer than 8 survivors; secs/round beside ``main``'s.  Legs (a)
    and (e) again, cut after round 2 and resumed to 3: params (and (a)'s
    ``dp_clip``) bitwise those of the uninterrupted leg.  Then one round
    of (e)'s engine with a dropout, its masks drawn and with every mask
    zeroed: the decoded aggregate (so the params) bitwise equal; and a
    profile of two of (e)'s rounds."""
    from msrflute_tpu_torch.engine.round import RoundEngine
    ran = []
    round_fn = RoundEngine._round

    def recording(self, state, batch, *args, **kw):
        ran.append((state.round, batch.sample_mask.copy(),
                    batch.client_mask.copy()))
        return round_fn(self, state, batch, *args, **kw)

    RoundEngine._round = recording
    legs = {}
    try:
        for leg in DEFENSE_LEGS:
            tic = time.time()
            del ran[:]
            legs[leg], server = _defense_leg(torch, work, kernel_rows, leg,
                                             ran)
            if leg == "secagg_full":
                RoundEngine._round = round_fn
                legs[leg]["masked_equals_unmasked"] = \
                    _masked_equals_unmasked(torch, server)
                phase_profile_defense(torch, server)
                RoundEngine._round = recording
            del server
            torch.cuda.empty_cache()
            if leg in DEFENSE_RESUMED:
                legs[leg]["resume_bitwise"] = _defense_resume(torch, work, leg,
                                                              legs[leg])
            legs[leg].pop("_params")
            legs[leg].pop("_dp_clip", None)
            legs[leg]["seconds"] = round(time.time() - tic, 3)
    finally:
        RoundEngine._round = round_fn
    emit({"phase": "defense", "ok": True, "params": MAIN_P,
          "clients_per_round": MAIN_K, "writers": 350,
          "rounds": DEFENSE_ROUNDS, "chaos": DEFENSE_CHAOS,
          "main_secs_per_round_after_first":
              MAIN_SECS.get("after_first"), "legs": legs})


def _defense_leg(torch, work, kernel_rows, leg, ran):
    import numpy as np
    raw = defense_config(leg)
    _reset_counts()
    server, out, secs = _run_cli(work, f"defense_{leg}", raw, "cuda")
    launches = _read_counts()
    steps = server.engine.local_steps
    want = {k: 0 for k in launches}
    want["fused_sgd_apply"] = steps
    check(steps > 0 and launches == want,
          f"defense {leg}: launches {launches}, want {want}")
    for row in kernel_rows:
        row.setdefault("launches_by_path", {})[f"defense_{leg}"] = \
            launches[row["name"]]
    check(server.state.params.is_cuda, f"defense {leg}: params not on cuda")
    train_loss = [r["value"] for r in _records(out, "Training loss")]
    val = [h["loss"] for h in server.history if h["split"] == "val"]
    check(len(train_loss) == DEFENSE_ROUNDS and
          all(map(math.isfinite, train_loss + val)) and len(val) == 1,
          f"defense {leg}: losses {train_loss} val {val}")
    logged = {}
    for name in ("Chaos dropped clients", "Chaos stragglers",
                 "Chaos steps lost", "Chaos NaN-injected clients",
                 "Chaos scaled clients", "Chaos sign-flipped clients",
                 "Quarantined clients (non-finite)",
                 "Quarantined clients (norm outlier)",
                 "SecAgg recovered (dropout)",
                 "SecAgg recovered (quarantine)", "SecAgg aborted round",
                 "DP clip norm"):
        recs = _records(out, name)
        if recs:
            logged[name] = {r["step"]: r["value"] for r in recs}
    check([r for r, _, _ in ran] == list(range(DEFENSE_ROUNDS)),
          f"defense {leg}: rounds run {[r for r, _, _ in ran]}")
    replay = _defense_replay(raw, ran)
    for r, want_row in enumerate(replay):
        for name, value in want_row.items():
            if name == "live":
                continue
            check(logged.get(name, {}).get(r) == value,
                  f"defense {leg} round {r}: {name} "
                  f"{logged.get(name, {}).get(r)}, replay {value}")
        nan = want_row.get("Chaos NaN-injected clients")
        if nan is not None and "Quarantined clients (non-finite)" in logged:
            check(logged["Quarantined clients (non-finite)"][r] == nan,
                  f"defense {leg} round {r}: NaN clients not quarantined")
        if server.strategy.wants_cohort:
            check(logged["SecAgg recovered (dropout)"][r] ==
                  want_row["Chaos dropped clients"],
                  f"defense {leg} round {r}: recovered != dropped")
            quarantined = sum(logged.get(q, {}).get(r, 0.0) for q in (
                "Quarantined clients (non-finite)",
                "Quarantined clients (norm outlier)"))
            check(logged["SecAgg recovered (quarantine)"][r] == quarantined,
                  f"defense {leg} round {r}: recovered quarantine")
            aborted = logged.get("SecAgg aborted round", {}).get(r, 0.0)
            floor = server.strategy.min_survivors
            check(aborted == float(0 < floor and
                                   want_row["live"] - quarantined < floor),
                  f"defense {leg} round {r}: aborted {aborted}")
    # a chaos_faults / quarantine record for each round whose counters say
    # something
    for kind, names in (("chaos_faults", ("Chaos dropped clients",
                                          "Chaos stragglers",
                                          "Chaos steps lost")),
                        ("quarantine", ("Quarantined clients (non-finite)",
                                        "Quarantined clients (norm "
                                        "outlier)"))):
        want_rounds = [r for r in range(DEFENSE_ROUNDS)
                       if any(logged.get(n, {}).get(r) for n in names)]
        got_rounds = [e["round"] for e in _events(server, kind)]
        check(got_rounds == want_rounds,
              f"defense {leg}: {kind} records at {got_rounds}, counters "
              f"at {want_rounds}")
    if leg == "dp_adaptive":
        clips = [logged["DP clip norm"][r] for r in
                 sorted(logged.get("DP clip norm", {}))]
        check(len(clips) == DEFENSE_ROUNDS and
              all(0 < c <= 10.0 for c in clips),
              f"defense {leg}: DP clip norms {clips}")
    rounds = server.run_stats["secsPerRound"]
    record = {"secs_per_round": rounds,
              "secs_per_round_after_first": float(np.mean(rounds[1:])),
              "local_steps": steps, "launches": launches,
              "train_loss": train_loss, "val_loss": val[0],
              "counters": {name: [v[r] for r in sorted(v)]
                           for name, v in logged.items()},
              "run_seconds": round(secs, 3),
              "_params": server.state.params.cpu()}
    if "dp_clip" in server.state.strategy_state:
        record["_dp_clip"] = server.state.strategy_state["dp_clip"].cpu()
    return record, server


def _defense_resume(torch, work, leg, record):
    """The leg cut after round 2 and resumed to 3 through the CLI: its
    params (and ``dp_clip``) bitwise the uninterrupted leg's."""
    name = f"defense_{leg}_resume"
    _run_cli(work, name, defense_config(leg, rounds=2), "cuda")
    raw = defense_config(leg)
    raw["server_config"]["resume_from_checkpoint"] = True
    resumed, _, _ = _run_cli(work, name, raw, "cuda")
    check(resumed.state.round == DEFENSE_ROUNDS,
          f"defense {leg}: resumed run ended at {resumed.state.round}")
    check(torch.equal(resumed.state.params.cpu(), record["_params"]),
          f"defense {leg}: resumed params differ from the uninterrupted run")
    out = {"params": True}
    if "_dp_clip" in record:
        check(torch.equal(resumed.state.strategy_state["dp_clip"].cpu(),
                          record["_dp_clip"]),
              f"defense {leg}: resumed dp_clip differs")
        out["dp_clip"] = float(record["_dp_clip"])
    del resumed
    torch.cuda.empty_cache()
    return out


def _defense_batch(server):
    from msrflute_tpu_torch.data.batching import pack_round_batches
    sampled = server._sample()
    return pack_round_batches(
        server.train_dataset, sampled, server.batch_size,
        server._chunk_steps([sampled]), rng=server._np_rng,
        desired_max_samples=server.desired_max_samples)


def _masked_equals_unmasked(torch, server):
    """One secure_agg round on the card at a round whose schedule drops a
    client (so the mask recovery runs), from one state, twice: with its
    pairwise masks, and with every mask zeroed.  The decoded aggregate,
    hence the params after the server's SGD step, and the stats are
    bitwise equal."""
    import numpy as np
    from msrflute_tpu_torch.engine.round import ServerState
    batch = _defense_batch(server)
    engine, strategy, st = server.engine, server.strategy, server.state
    r = next(r for r in range(st.round, st.round + 100)
             if (server.chaos.client_faults(r, batch.sample_mask)[0]
                 * batch.client_mask).sum() > 0)
    state = ServerState(st.params, st.opt_state, r, st.strategy_state)
    vecs = server.chaos_vectors(r, batch)
    masked, stats = engine.run_round(state, batch, 0.1, 1.0, chaos=vecs)
    pair_mask = strategy.pair_mask
    strategy.pair_mask = lambda *a, **kw: torch.zeros_like(
        pair_mask(*a, **kw))
    try:
        plain, plain_stats = engine.run_round(state, batch, 0.1, 1.0,
                                              chaos=vecs)
    finally:
        strategy.pair_mask = pair_mask
    check(torch.equal(masked.params, plain.params) and stats == plain_stats,
          "secure_agg: the masked round's aggregate differs from the "
          "unmasked one")
    check(not torch.equal(masked.params, st.params),
          "secure_agg: the round moved no parameter")
    # the int32 traps of the port, on the card: wraparound and an
    # arithmetic right shift
    i32 = torch.tensor([2 ** 31 - 1, -5], dtype=torch.int32,
                       device=server.device)
    check((i32 + 1).tolist() == [-2 ** 31, -4] and
          (i32 >> 15).tolist() == [65535, -1],
          f"int32 on the card: {(i32 + 1).tolist()}, {(i32 >> 15).tolist()}")
    return {"round": r, "dropped": stats["secagg_recovered_dropout"],
            "quarantined": stats["secagg_recovered_quarantine"],
            "bitwise": True}


def phase_profile_defense(torch, server, rounds=1):
    """Leg (e)'s rounds under the profiler (:func:`_trace_rounds`): one
    fresh cohort, its chaos vectors at the next round, the same round
    repeated; its masks are K(K-1) generations of P int32 a round."""
    batch = _defense_batch(server)
    engine, state = server.engine, server.state
    vecs = server.chaos_vectors(state.round, batch)

    def step():
        engine.run_round(state, batch, 0.1, 1.0, chaos=vecs)

    # the masks' random fill, and the int64 adds, casts and wrap of the
    # masked rows (the elementwise kernels the CNN path also runs)
    traced = _trace_rounds(torch, step, rounds, "defense_profile", groups={
        "mask_random_fill": ("distribution_elementwise", "random_from_to",
                             "philox"),
        "elementwise": ("elementwise_kernel",)})
    emit({"phase": "defense_profile", "ok": True, "leg": "secagg_full",
          "rounds": rounds, "clients": int(batch.client_mask.sum()),
          "mask_generations_per_round": int(
              batch.client_mask.sum() * (batch.client_mask.sum() - 1)),
          **traced})


def phase_cross_device_defense(torch, work):
    """Legs (b), (c) and (e) at 4 clients for 2 rounds on
    :func:`_small_femnist`'s writers, dropout off: twice on cuda
    (bitwise) and once on cpu, within ``STRATEGY_CROSS_TOL``
    (:func:`_cross_device`)."""
    for leg in DEFENSE_CROSS_LEGS:
        raw = defense_config(leg, rounds=2, data_dir=_small_femnist(work))
        raw["model_config"].update(dropout1=0.0, dropout2=0.0)
        raw["server_config"].update(num_clients_per_iteration=4,
                                    val_freq=100, model_backup_freq=1)
        _cross_device(torch, work, f"defense_cross_device_{leg}", raw,
                      "cv_cnn_femnist", STRATEGY_CROSS_TOL)


# ----------------------------------------------------------------------
#: the fused_carry phase (``server_config.fused_carry``): SCAFFOLD's and
#: EF's carry on the strategies phase's CNN_FEMNIST legs, fused RL on
#: CNN_CONFIG's FedAvg and personalization's carry on experiments/cv
#: (ResNet-18-GN, 100 users), 2 rounds at depth 2, then round 2 again at
#: depth 0 from the round-1 ``latest``; no val eval.  Each ``latest``
#: carries the tables (1.69 GB for ``[350, 1,206,590]`` f32, 4.47 GB for
#: ``[100, 11,181,642]``) and the machine stops a command past 45 GiB of
#: disk writes (the earlier phases write 28 GB): the round-1 ``latest`` of
#: each leg is written, the later ones serialized and timed only
FUSED_ROUNDS = 2
FUSED_LEGS = ("scaffold", "ef_quant", "rl", "personalization")
#: the strategies phase's host leg each carry leg must equal, bit for bit
FUSED_HOST_LEGS = {"scaffold_device": "scaffold",
                   "ef_quant_device": "ef_quant"}
#: the host legs' final params and tables, from the strategies phase
HOST_FINAL = {}
#: the carry legs' results the fleet_paged phase holds its paged legs to:
#: each one's written ``latest`` (bytes, seconds) and the personalization
#: leg's params and personalized eval
FUSED_FINAL = {}


def _host_leg_state(server):
    """A host device-table leg's params and table (and SCAFFOLD's ``c``)
    on the host."""
    table = server.scaffold_device or server.ef_device
    return {"round": server.state.round, "params": server.state.params.cpu(),
            "table": table.table.cpu(),
            **({"c": server.scaffold_device.c.cpu()}
               if server.scaffold_device is not None else {})}


def fused_config(leg, depth, rounds=FUSED_ROUNDS):
    """The leg's config under ``fused_carry`` at ``pipeline_depth``
    ``depth``, one-round chunks (SCAFFOLD and EF then draw as the host
    rounds do)."""
    rps = 1
    if leg == "personalization":
        raw = personalization_config(rounds)
    elif leg == "rl":
        raw = json.loads(json.dumps(CNN_CONFIG))
        # the tuner's state holds FedAvg's weights, the clients' sample
        # counts (50-300): plain SGD on them diverged in the first DQN
        # step (an H100 run), Adam's bounded step does not
        raw["server_config"].update(wantRL=True, RL={
            "optimizer_config": {"type": "adam", "lr": 1e-3}})
    else:
        raw = strategy_config(leg, rounds)
    raw["server_config"].update(
        max_iteration=rounds, fused_carry=True, pipeline_depth=depth,
        rounds_per_step=rps, val_freq=1000, rec_freq=1000,
        initial_val=False, model_backup_freq=1000)
    return raw


def _state_bytes(state):
    tensors = [state.params, *state.opt_state.values(),
               *state.strategy_state.values()]
    return sum(t.numel() * t.element_size() for t in tensors)


def _payload_bytes(payload):
    """The tensor bytes of a checkpoint payload (one level of dicts)."""
    return sum(t.numel() * t.element_size() for v in payload.values()
               if isinstance(v, dict) for t in v.values())


class _CheckpointMeter:
    """Each ``latest`` save's bytes and seconds (the writer thread's
    serialization and write; past ``real_saves`` its tensor bytes alone,
    not written), the
    pinned host bytes held by the snapshots alive at once, and the wall
    seconds of each server's ``train`` (the loop, its saves included),
    through the phase's runs."""

    def __init__(self):
        import weakref
        from msrflute_tpu_torch.engine import checkpoint
        from msrflute_tpu_torch.engine.server import OptimizationServer
        self.mgr = checkpoint.CheckpointManager
        self.write, self.snap = self.mgr._write_latest, self.mgr.snapshot
        self.server, self.train = OptimizationServer, OptimizationServer.train
        self.saves, self.pinned, self.pinned_peak = [], 0, 0
        self.train_secs = 0.0
        #: the ``latest`` saves still written to disk; past them a save is
        #: counted, not written
        self.real_saves = 0
        meter = self

        def train(server):
            tic = time.time()
            try:
                return meter.train(server)
            finally:
                meter.train_secs = time.time() - tic

        def write_latest(mgr, payload):
            if meter.real_saves <= 0:
                # not written: the payload's tensor bytes, no time
                meter.saves.append({"bytes": _payload_bytes(payload),
                                    "secs": None, "written": False})
                return
            meter.real_saves -= 1
            tic = time.time()
            meter.write(mgr, payload)
            meter.saves.append({
                "bytes": os.path.getsize(os.path.join(mgr.model_dir,
                                                      checkpoint.LATEST)),
                "secs": time.time() - tic, "written": True})

        def snapshot(state):
            snap = meter.snap(state)
            if snap.event is not None:
                n = _state_bytes(snap.state)
                meter.pinned += n
                meter.pinned_peak = max(meter.pinned_peak, meter.pinned)
                weakref.finalize(snap.state, meter.release, n)
            return snap

        self.mgr._write_latest = write_latest
        self.mgr.snapshot = staticmethod(snapshot)
        self.server.train = train

    def release(self, n):
        self.pinned -= n

    def take(self):
        """The saves since the last call, and the pinned peak since."""
        saves, peak = self.saves, self.pinned_peak
        self.saves, self.pinned_peak = [], self.pinned
        return saves, peak

    def restore(self):
        self.mgr._write_latest = self.write
        self.mgr.snapshot = staticmethod(self.snap)
        self.server.train = self.train


def _host_ram_gb():
    try:
        with open("/proc/meminfo") as fh:
            for line in fh:
                if line.startswith("MemTotal:"):
                    return int(line.split()[1]) * 1024 / 1e9
    except OSError:
        pass
    return None


def _fused_run(torch, work, kernel_rows, leg, name, raw, meter, rounds):
    """One CLI run of a carry leg: its launches held to B1 once a local
    step (the personalization carry's two passes each launching it) and
    B3 once a round on EF, no other kernel; its secs/round, ``latest``
    saves, pinned peak and disk writes."""
    task = "cv" if leg == "personalization" else "cv_cnn_femnist"
    io0 = io_write_bytes()
    _reset_counts()
    server, out, secs = _run_cli(work, name, raw, "cuda", task=task)
    server.ckpt.wait()
    launches = _read_counts()
    steps = server.engine.local_steps
    want = {k: 0 for k in launches}
    want["fused_sgd_apply"] = steps
    want["quant_bin_sparsify"] = rounds if leg == "ef_quant" else 0
    check(steps > 0 and launches == want,
          f"{name}: launches {launches}, want {want}")
    check(server.strategy.client_passes ==
          (2 if leg == "personalization" else 1),
          f"{name}: {server.strategy.client_passes} client passes")
    for row in kernel_rows:
        row.setdefault("launches_by_path", {})[name] = launches[row["name"]]
    check(server.state.params.is_cuda and all(
        t.is_cuda for t in server.state.strategy_state.values()),
          f"{name}: state not on cuda")
    # a resumed run appends to the cut run's log: its own rounds only
    train_loss = [r["value"] for r in _records(out, "Training loss")
                  if r["step"] >= server.state.round - rounds]
    check(len(train_loss) == rounds and all(map(math.isfinite, train_loss)),
          f"{name}: losses {train_loss}")
    if leg == "rl":
        rl = {key: [r["value"] for r in _records(out, key)
                    if r["step"] >= server.state.round - rounds]
              for key in ("RL Rewards", "RL Q loss", "RL epsilon")}
        check(all(len(v) == rounds and all(map(math.isfinite, v))
                  for v in rl.values()), f"{name}: RL stats {rl}")
    saves, peak = meter.take()
    per_round = server.run_stats["secsPerRound"]
    return server, {
        "pipeline_depth": server.pipeline_depth,
        "pipelined_chunks": server.pipelined_chunks,
        "rounds": rounds, "secs_per_round": per_round,
        "secs_per_round_after_first": _mean(per_round[1:]),
        # the loop's own wall, its `latest` saves included (at depth 0
        # secsPerRound ends at the stats' fence, before the save)
        "loop_secs_per_round": meter.train_secs / rounds,
        "host_split": _host_split(server),
        "local_steps": steps, "launches": launches,
        "latest_saves": saves, "pinned_snapshot_peak_gb": peak / 1e9,
        "strategy_state_gb": sum(
            t.numel() * t.element_size()
            for t in server.state.strategy_state.values()) / 1e9,
        "disk_write_gb": (io_write_bytes() - io0) / 1e9,
        "train_loss": train_loss, "run_seconds": round(secs, 3)}


def _flat_state(state):
    """Params and ``strategy_state`` in one dict, where they are."""
    return {"params": state.params, **state.strategy_state}


def _max_abs_diff(torch, a, b):
    if a.shape != b.shape:
        return float("inf")
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def _fused_leg(torch, work, kernel_rows, leg, meter):
    """One carry leg: :data:`FUSED_ROUNDS` rounds at depth 2 (the ring
    really overlapping), then the dispatch half's sync scan
    (:func:`_dispatch_half`), an engine round under the profiler (busy,
    idle), the leg's own checks; then the last round again from the
    run's first ``latest`` (:func:`_link_cut`; the later saves are not
    written), resumed at depth 0, whose params and ``strategy_state``
    must equal depth 2's bitwise.
    SCAFFOLD and EF are also held to the strategies phase's device-table
    legs at the same round."""
    record, steps, last = {}, {}, [time.time()]

    def lap(name):
        now = time.time()
        steps[name] = round(now - last[0], 3)
        last[0] = now

    # the first `latest` is written, the cut the resume starts from; the
    # later ones are counted, not written: every save of the tables
    # written would take the script past the machine's 45 GiB
    meter.real_saves = 1
    server, rec = _fused_run(torch, work, kernel_rows, leg,
                             f"fused_{leg}_d2", fused_config(leg, 2), meter,
                             FUSED_ROUNDS)
    # the resident tables' written `latest`, which the fleet_paged phase
    # reports beside its paged ones
    FUSED_FINAL[leg] = {"latest_written": [
        s for s in rec["latest_saves"] if s["written"]]}
    check(server._pipeline_ok() and server.pipelined_chunks > 0,
          f"fused {leg}: the depth-2 ring did not overlap")
    check(server.rl is None and server.scaffold_store is None and
          server.ef_store is None and getattr(server, "store", None) is None,
          f"fused {leg}: a host store was built")
    lap("depth2_run")
    rec["dispatch_sync_points"] = _dispatch_half(torch, server)
    lap("dispatch_half")
    batch = _defense_batch(server)
    engine, state = server.engine, server.state

    def step():
        engine.run_round(state, batch, 0.1, 1.0)

    traced = _trace_rounds(torch, step, 1, f"fused_{leg}_profile")
    busy = traced["device_busy_ms_per_round"]
    lap("profile")
    record["profile"] = {k: traced[k] for k in (
        "wall_ms_per_round", "device_busy_ms_per_round",
        "device_idle_share", "top_device_ops")}
    ss = server.state.strategy_state
    if leg == "scaffold":
        record["control_norm"] = [
            r["value"] for r in _records(
                os.path.join(work, f"out_fused_{leg}_d2"),
                "Control norm (server c)")]
        check(len(record["control_norm"]) == FUSED_ROUNDS and
              record["control_norm"][-1] > 0,
              f"fused scaffold: control norms {record['control_norm']}")
    if leg == "rl":
        record["epsilon"] = float(ss["rl.eps"])
        record["replay_count"] = int(ss["rl.count"])
        check(record["epsilon"] < 0.5 and record["replay_count"] > 0,
              f"fused rl: eps {record['epsilon']}, count "
              f"{record['replay_count']}")
    if leg == "personalization":
        seen, alpha = ss["seen"].cpu(), ss["alpha"].cpu()
        check(int((seen > 0).sum()) >= MAIN_K and bool(
            ((alpha >= 1e-4) & (alpha <= 0.9999)).all()),
              f"fused personalization: seen {int((seen > 0).sum())}, "
              f"alpha range {float(alpha.min())}-{float(alpha.max())}")
        tic = time.time()
        first = server.personalized_eval(server.val_dataset)
        record["personalized_eval_seconds"] = round(time.time() - tic, 3)
        check(first is not None and
              server.personalized_eval(server.val_dataset) == first,
              f"fused personalization: personalized eval {first}")
        record["personalized_val"] = {"acc": first[0], "loss": first[1]}
        record["users_seen"] = int((seen > 0).sum())
        # the fleet_paged phase's resident yardstick
        FUSED_FINAL[leg].update(
            round=server.state.round,
            params=server.state.params.detach().clone(),
            personalized_val=first)
    # held on the card for the comparisons below
    whole = _flat_state(server.state)
    host_leg = {v: k for k, v in FUSED_HOST_LEGS.items()}.get(leg)
    if host_leg is not None and \
            HOST_FINAL.get(host_leg, {}).get("round") == FUSED_ROUNDS:
        host = HOST_FINAL[host_leg]
        pairs = {"params": "params", "table": "ci" if leg == "scaffold"
                 else "res", "c": "c"}
        diffs = {k: _max_abs_diff(torch, whole[pairs[k]],
                                  host[k].to(whole[pairs[k]].device))
                 for k in pairs if k in host}
        record["host_leg"] = {"leg": host_leg,
                              "bitwise": not any(diffs.values()),
                              "max_abs_diff": diffs}
    del server, state, engine, batch
    torch.cuda.empty_cache()
    lap("checks")
    rec["device_idle_share"] = 1.0 - busy / 1e3 / rec["loop_secs_per_round"]
    record["depth2"] = rec

    # the cut: the depth-2 run's models hard-linked (no byte written
    # again), as a crash in its last save leaves them: ``latest`` at round
    # FUSED_ROUNDS - 1, the status log a round ahead (its ring pairs them
    # at the resume)
    name = f"fused_{leg}_d0"
    _link_cut(os.path.join(work, f"out_fused_{leg}_d2", "models"),
              os.path.join(work, f"out_{name}", "models"))
    raw = fused_config(leg, 0)
    raw["server_config"]["resume_from_checkpoint"] = True
    meter.real_saves = 0
    resumed, rest = _fused_run(torch, work, kernel_rows, leg, name, raw,
                               meter, 1)
    lap("depth0_resume")
    check(resumed.state.round == FUSED_ROUNDS,
          f"fused {leg}: the resume ended at {resumed.state.round}")
    got = _flat_state(resumed.state)
    del resumed
    torch.cuda.empty_cache()
    check(sorted(got) == sorted(whole) and all(
        torch.equal(got[k], whole[k]) for k in whole),
          f"fused {leg}: the round resumed at depth 0 differs from depth "
          "2: " + str({k: _max_abs_diff(torch, got[k], whole[k])
                       for k in whole if k in got}))
    rest["device_idle_share"] = \
        1.0 - busy / 1e3 / rest["loop_secs_per_round"]
    record["depth0"] = rest
    record["bitwise_across_depths_and_resume"] = True
    lap("compare")
    record["step_seconds"] = steps
    return record


def _link_cut(src, dst):
    """``dst``: every file of ``src`` hard-linked."""
    os.makedirs(dst)
    for name in os.listdir(src):
        if os.path.isfile(os.path.join(src, name)):
            os.link(os.path.join(src, name), os.path.join(dst, name))


def phase_fused_carry(torch, work, kernel_rows):
    """Each of :data:`FUSED_LEGS` through :func:`_fused_leg`: a line per
    leg (``fused_carry_<leg>``) with, per depth, secs/round, busy and
    idle, each ``latest`` save's bytes and seconds, the pinned snapshot
    peak beside the host's RAM and the disk writes; then the phase's
    line."""
    meter = _CheckpointMeter()
    legs = {}
    try:
        for leg in FUSED_LEGS:
            tic = time.time()
            legs[leg] = _fused_leg(torch, work, kernel_rows, leg, meter)
            legs[leg]["seconds"] = round(time.time() - tic, 3)
            emit({"phase": f"fused_carry_{leg}", "ok": True, **legs[leg]})
    finally:
        meter.restore()
    host_stats = getattr(torch.cuda, "host_memory_stats", None)
    emit({"phase": "fused_carry", "ok": True, "rounds": FUSED_ROUNDS,
          "legs": list(legs), "host_ram_gb": _host_ram_gb(),
          "host_memory_stats": host_stats() if host_stats else None,
          "host_bitwise": {leg: legs[leg]["host_leg"]["bitwise"]
                           for leg in legs if "host_leg" in legs[leg]},
          "dispatch_sync_points": {
              leg: legs[leg]["depth2"]["dispatch_sync_points"]
              for leg in legs}})


#: the resilience phase: ``main``'s CNN_FEMNIST config (P = 1,206,590, 10
#: clients at batch 20, the 350 writers, ``pallas_apply``) with a server
#: SGD with momentum (so the server optimizer has state to hold bitwise),
#: one-round chunks at depth 1, no eval (a best model is one more write)
RESILIENCE_ROUNDS = 6
RESILIENCE_DP = {"enable_local_dp": True, "eps": 1000.0, "delta": 1e-5,
                 "max_grad": 1.0, "max_weight": 1000.0}
#: ``dp_strategies``: ``(strategy leg, fused_carry)`` of STRATEGY_LEGS (EF's
#: host round with its device table, whose rows reach the disk once, at
#: the last round)
RESILIENCE_DP_LEGS = {"fedac": ("fedac", False), "fedbuff": ("fedbuff", False),
                      "ef_host": ("ef_quant_device", False),
                      "ef_carry": ("ef_quant", True)}
#: the writers of the EF carry leg: its ``latest`` holds their ``[N, P]``
#: residual table (48 MB)
RESILIENCE_CARRY_WRITERS = 10
#: ``client_chunks``: Fed-CIFAR-100's ResNet-18-GN at K clients, chunked
CHUNK_K, CHUNK_C = 20, 5


def resilience_config(rounds=RESILIENCE_ROUNDS, **server):
    raw = json.loads(json.dumps(CNN_CONFIG))
    raw["server_config"].update(
        max_iteration=rounds, val_freq=1000, rec_freq=1000,
        initial_val=False, rounds_per_step=1, pipeline_depth=1,
        model_backup_freq=1000,
        optimizer_config={"type": "sgd", "lr": 1.0, "momentum": 0.9},
        **server)
    return raw


def _full_state(state):
    """Params, the server optimizer's state and ``strategy_state`` in one
    dict, where they are."""
    return {"params": state.params,
            **{f"opt.{k}": v for k, v in state.opt_state.items()},
            **state.strategy_state}


def _run_preempted(work, name, raw):
    """The CLI on ``raw``, which must exit 75 (``EX_TEMPFAIL``): the
    status log it leaves."""
    try:
        _run_cli(work, name, raw, "cuda")
    except SystemExit as exc:
        check(exc.code == 75, f"resilience {name}: exit code {exc.code}")
    else:
        check(False, f"resilience {name}: the run was not preempted")
    with open(os.path.join(work, f"out_{name}", "models",
                           "status_log.json")) as fh:
        return json.load(fh)


def _resume_to_ref(torch, work, name, raw, ref):
    """``raw`` resumed in ``name``'s directory: its params and server
    optimizer state bitwise ``ref``'s."""
    raw = json.loads(json.dumps(raw))
    raw["server_config"]["resume_from_checkpoint"] = True
    resumed, _, _ = _run_cli(work, name, raw, "cuda")
    check(resumed.state.round == RESILIENCE_ROUNDS and not resumed.preempted,
          f"resilience {name}: the resume ended at {resumed.state.round}")
    got = _full_state(resumed.state)
    check(sorted(got) == sorted(ref) and
          all(torch.equal(got[k], ref[k]) for k in ref),
          f"resilience {name}: the resumed state differs from the "
          "reference: " + str({k: _max_abs_diff(torch, got[k], ref[k])
                               for k in ref if k in got}))
    del resumed
    return True


def _leg_preempt(torch, work, ref):
    raw = resilience_config(chaos={"preempt_at_round": 3})
    status = _run_preempted(work, "res_preempt", raw)
    check(status["i"] == 3 and
          status.get("preempted") == "chaos preempt_at_round=3",
          f"resilience preempt: status {status.get('i')}, "
          f"{status.get('preempted')}")
    with open(os.path.join(work, "out_res_preempt", "log",
                           "metrics.jsonl")) as fh:
        events = [(r["event"], r.get("round"), r.get("reason"))
                  for r in map(json.loads, fh) if "event" in r]
    reason = "chaos preempt_at_round=3"
    check(events == [("preemption", None, reason),
                     ("preempted_exit", 3, reason)],
          f"resilience preempt: event records {events}")
    return {"stopped_at": status["i"], "exit_code": 75,
            "event_records": [e[0] for e in events],
            "resume_bitwise": _resume_to_ref(torch, work, "res_preempt", raw,
                                             ref)}


def _leg_sigterm(torch, work, ref):
    """A real SIGTERM to this process from a timer thread once round 2's
    status is on disk; a guard handler outside ``train`` (the server
    installs its own for the loop) turns a signal that misses the loop
    into a failed check instead of the script's death."""
    import signal
    import threading
    name = "res_sigterm"
    status_path = os.path.join(work, f"out_{name}", "models",
                               "status_log.json")
    late = []
    guard = signal.signal(signal.SIGTERM, lambda s, f: late.append(s))
    stop = threading.Event()

    def timer():
        while not stop.wait(0.002):
            try:
                with open(status_path) as fh:
                    if json.load(fh)["i"] >= 2:
                        os.kill(os.getpid(), signal.SIGTERM)
                        return
            except (OSError, ValueError, KeyError):
                pass

    thread = threading.Thread(target=timer, daemon=True)
    thread.start()
    try:
        status = _run_preempted(work, name, resilience_config())
    finally:
        stop.set()
        thread.join(timeout=10)
        signal.signal(signal.SIGTERM, guard)
    check(not late, "resilience sigterm: the signal missed the loop")
    check(status.get("preempted") == "signal SIGTERM" and
          2 <= status["i"] < RESILIENCE_ROUNDS,
          f"resilience sigterm: status {status.get('i')}, "
          f"{status.get('preempted')}")
    return {"stopped_at": status["i"], "exit_code": 75,
            "resume_bitwise": _resume_to_ref(torch, work, name,
                                             resilience_config(), ref)}


def _leg_ckpt_io(torch, work, ref):
    from msrflute_tpu_torch.resilience.chaos import ChaosSchedule
    from msrflute_tpu_torch.resilience.integrity import \
        CheckpointEscalationError
    chaos = {"seed": 3, "ckpt_io_error_rate": 0.3}
    raw = resilience_config(chaos=chaos, checkpoint_retry={
        "retries": 6, "backoff_base_s": 0, "jitter": 0})
    server, _, secs = _run_cli(work, "res_ckpt_io", raw, "cuda")
    got = _full_state(server.state)
    check(all(torch.equal(got[k], ref[k]) for k in ref),
          "resilience ckpt_io: the faulty run's state differs from the "
          "clean reference")
    calls = server.chaos._io_calls
    faults = server.chaos.counters["ckpt_io_faults"]
    replay = ChaosSchedule(**chaos)
    replayed = sum(replay.io_fault() for _ in range(calls))
    check(faults == replayed > 0 and server.ckpt.escalator.total == 0,
          f"resilience ckpt_io: {faults} faults, the replay of {calls} "
          f"attempts {replayed}, {server.ckpt.escalator.total} failed saves")
    records = len(_events(server, "ckpt_io_fault"))
    check(records == faults, f"resilience ckpt_io: {records} ckpt_io_fault "
          f"records for {faults} faults")
    del server
    name = "res_escalation"
    raw = resilience_config(chaos={"seed": 3, "ckpt_io_error_rate": 1.0},
                            checkpoint_retry={
                                "retries": 1, "backoff_base_s": 0,
                                "jitter": 0, "escalation_threshold": 2})
    raised = None
    try:
        _run_cli(work, name, raw, "cuda")
    except CheckpointEscalationError as exc:
        raised = str(exc)
    with open(os.path.join(work, f"out_{name}", "models",
                           "status_log.json")) as fh:
        at = json.load(fh)["i"]
    # depth 1: the saves of rounds 1 and 2 fail on the writer thread, the
    # submit of round 3's raises
    check(raised is not None and "2 consecutive" in raised and at == 3,
          f"resilience escalation: raised {raised!r} at round {at}")
    return {"io_attempts": calls, "io_faults": faults,
            "ckpt_io_fault_records": records,
            "faults_equal_replay": True, "params_bitwise_clean": True,
            "run_seconds": round(secs, 3),
            "escalation": {"raised": "CheckpointEscalationError",
                           "at_round": at, "threshold": 2}}


def _leg_dp_strategies(torch, work, kernel_rows):
    """FedAC, FedBuff, EF's host round and EF under ``fused_carry``
    (:data:`RESILIENCE_CARRY_WRITERS` writers) with local DP (clip and
    noise), 2 rounds at depth 1 with no eval (a best model would copy the
    carry table again), twice each on cuda."""
    small = f"femnist_{RESILIENCE_CARRY_WRITERS}"
    if not os.path.isdir(os.path.join(work, small)):
        os.makedirs(os.path.join(work, small))
        for split, users, seed in (("train", RESILIENCE_CARRY_WRITERS, 8),
                                   ("val", 4, 9), ("test", 4, 10)):
            write_femnist_blob(os.path.join(work, small, f"{split}.json"),
                               users, 50, 300, seed)
    legs = {}
    for leg, (strategy_leg, fused) in RESILIENCE_DP_LEGS.items():
        raw = strategy_config(strategy_leg, rounds=2,
                              data_dir=small if fused else "femnist")
        raw["dp_config"] = dict(RESILIENCE_DP)
        raw["server_config"].update(pipeline_depth=1, fused_carry=fused,
                                    val_freq=1000)
        runs = []
        for run in range(2):
            _reset_counts()
            server, out, secs = _run_cli(work, f"res_dp_{leg}_{run}", raw,
                                         "cuda")
            launches = _read_counts()
            steps = server.engine.local_steps
            want = {k: 0 for k in launches}
            want["fused_sgd_apply"] = steps
            want["quant_bin_sparsify"] = 2 if leg.startswith("ef") else 0
            check(steps > 0 and launches == want,
                  f"resilience dp {leg}: launches {launches}, want {want}")
            train_loss = [r["value"] for r in _records(out, "Training loss")]
            val = [h["loss"] for h in server.history if h["split"] == "val"]
            check(len(train_loss) == 2 and
                  all(map(math.isfinite, train_loss + val)),
                  f"resilience dp {leg}: losses {train_loss} val {val}")
            check(server.strategy.local_dp and
                  ("res" in server.state.strategy_state) == fused,
                  f"resilience dp {leg}: not the leg's path")
            runs.append((_full_state(server.state), launches, train_loss,
                         secs))
            del server
        (a, launches, train_loss, secs), (b, *_rest) = runs
        check(sorted(a) == sorted(b) and all(torch.equal(a[k], b[k])
                                             for k in a),
              f"resilience dp {leg}: two cuda runs differ")
        for row in kernel_rows:
            row.setdefault("launches_by_path", {})[f"resilience_dp_{leg}"] = \
                launches[row["name"]]
        legs[leg] = {"launches": launches,
                     "b1_per_round": launches["fused_sgd_apply"] / 2,
                     "b3_per_round": launches["quant_bin_sparsify"] / 2,
                     "train_loss": train_loss, "cuda_bitwise": True,
                     "writers": RESILIENCE_CARRY_WRITERS if fused else 350,
                     "run_seconds": round(secs, 3)}
        del runs, a, b
        torch.cuda.empty_cache()
    return legs


def _leg_client_chunks(torch, work, kernel_rows):
    """Fed-CIFAR-100's ResNet-18-GN at K = 20 for one round, all K clients
    at once and 5 at a time: params within 1e-5 (relative L2), B1 four
    times as often, and each run's peak of allocated device memory."""
    out = {}
    for name, chunk in (("unchunked", None), ("chunked", CHUNK_C)):
        raw = fedavg_path_config("cv_resnet_fedcifar100", "fedcifar100",
                                 rounds=1)
        raw["server_config"].update(num_clients_per_iteration=CHUNK_K,
                                    initial_val=False, val_freq=1000,
                                    rec_freq=1000, model_backup_freq=1000)
        if chunk:
            raw["server_config"]["clients_per_chunk"] = chunk
        _reset_counts()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        server, _, secs = _run_cli(work, f"res_chunks_{name}", raw, "cuda",
                                   task="cv_resnet_fedcifar100")
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        launches = _read_counts()
        check(server.engine.layout.numel == RESNET_P and
              server.engine.clients_per_chunk == chunk,
              f"resilience chunks {name}: not the ResNet run asked for")
        out[name] = {"params": server.state.params.double().cpu(),
                     "launches": launches,
                     "local_steps": server.engine.local_steps,
                     "peak_allocated_gb": peak / 1e9,
                     "run_seconds": round(secs, 3)}
        for row in kernel_rows:
            row.setdefault("launches_by_path", {})[
                f"resilience_chunks_{name}"] = launches[row["name"]]
        del server
        torch.cuda.empty_cache()
    a, b = out["chunked"], out["unchunked"]
    rel = float((a["params"] - b["params"]).norm() / b["params"].norm())
    check(rel <= 1e-5, f"resilience chunks: rel L2 {rel} > 1e-5")
    b1 = (a["launches"]["fused_sgd_apply"], b["launches"]["fused_sgd_apply"])
    check(b1[0] == CHUNK_K // CHUNK_C * b1[1] > 0 and
          b1[0] == a["local_steps"],
          f"resilience chunks: B1 launched {b1} times")
    for r in out.values():
        r.pop("params")
    return {"clients": CHUNK_K, "clients_per_chunk": CHUNK_C,
            "rel_l2": rel, "b1_per_local_step_chunked":
                b1[0] / (b1[1] or 1), **out}


def _leg_norm_dump(torch, work):
    """``main``'s config with ``dump_norm_stats`` for 2 rounds (on 40
    writers, dropout off, as ``cross_device``): one line a round with an
    entry a sampled client, finite, cosines in [-1, 1]; twice on cuda
    (bitwise) and once on cpu: round 1's dumps, whose payloads start from
    the same params on both devices, within ``CROSS_TOL[1]``.  Round 2's
    start from params that already differ (by ``CROSS_TOL[1]`` at most),
    and 15 local steps on random labels grow that about fortyfold: its
    relative L2 is reported beside the params' bound, not held to it."""
    raw = _set_data(json.loads(json.dumps(CNN_CONFIG)), _small_femnist(work))
    raw["model_config"].update(dropout1=0.0, dropout2=0.0)
    raw["server_config"].update(max_iteration=2, val_freq=100, rec_freq=100,
                                initial_val=False, rounds_per_step=1,
                                dump_norm_stats=True)
    dumps = {}
    for tag, device in (("cuda", "cuda"), ("cuda_again", "cuda"),
                        ("cpu", "cpu")):
        server, out, _ = _run_cli(work, f"res_norm_{tag}", raw, device)
        del server
        lines = {}
        for name in ("norm_stats.txt", "cosines.txt"):
            with open(os.path.join(out, "models", name)) as fh:
                lines[name] = [json.loads(line) for line in fh]
        dumps[tag] = lines
    for name, rows in dumps["cuda"].items():
        check(len(rows) == 2 and all(len(r) == MAIN_K for r in rows) and
              all(math.isfinite(v) for r in rows for v in r),
              f"resilience norm_dump {name}: {rows}")
        check(rows == dumps["cuda_again"][name],
              f"resilience norm_dump {name}: two cuda runs differ")
    check(all(-1.0 <= c <= 1.0 for r in dumps["cuda"]["cosines.txt"]
              for c in r), "resilience norm_dump: a cosine outside [-1, 1]")
    rel = {}
    for name in dumps["cuda"]:
        for r, (a, b) in enumerate(zip(dumps["cuda"][name],
                                       dumps["cpu"][name])):
            a, b = torch.tensor(a).double(), torch.tensor(b).double()
            rel[f"{name}:{r + 1}"] = float((a - b).norm() / b.norm())
        check(rel[f"{name}:1"] <= CROSS_TOL[1],
              f"resilience norm_dump {name} round 1: cuda vs cpu rel L2 "
              f"{rel[f'{name}:1']} > {CROSS_TOL[1]}")
    return {"rounds": 2, "entries_per_round": MAIN_K,
            "cuda_bitwise": True, "rel_l2_cuda_vs_cpu": rel,
            "tolerance_round1": CROSS_TOL[1],
            "norms_round1": dumps["cuda"]["norm_stats.txt"][0],
            "cosines_round1": dumps["cuda"]["cosines.txt"][0]}


def phase_resilience(torch, work, kernel_rows):
    """The resilience slice on one card, through ``e2e_trainer.main``:
    ``preempt`` (the drill at round 3 of a 6-round run, exit 75, the
    resume bitwise the uninterrupted reference), ``sigterm`` (a real
    SIGTERM once round 2 is logged, exit 75, the resume bitwise),
    ``ckpt_io`` (IO faults at 0.3 with six attempts a save: bitwise the
    reference, the fault counter the host replay's; then every save
    failing, escalation at 2), ``dp_strategies``, ``client_chunks`` and
    ``norm_dump``; a line a leg, then the phase's."""
    legs = {}
    tic = time.time()
    server, _, secs = _run_cli(work, "res_ref", resilience_config(),
                               "cuda")
    check(server.state.round == RESILIENCE_ROUNDS and
          not server.preempted and server.state.opt_state,
          "resilience: the reference run")
    ref = _full_state(server.state)
    del server
    legs["reference"] = {"rounds": RESILIENCE_ROUNDS,
                         "run_seconds": round(secs, 3)}
    for leg, fn in (("preempt", lambda: _leg_preempt(torch, work, ref)),
                    ("sigterm", lambda: _leg_sigterm(torch, work, ref)),
                    ("ckpt_io", lambda: _leg_ckpt_io(torch, work, ref)),
                    ("dp_strategies", lambda: _leg_dp_strategies(
                        torch, work, kernel_rows)),
                    ("client_chunks", lambda: _leg_client_chunks(
                        torch, work, kernel_rows)),
                    ("norm_dump", lambda: _leg_norm_dump(torch, work))):
        lap = time.time()
        legs[leg] = fn()
        legs[leg]["seconds"] = round(time.time() - lap, 3)
        emit({"phase": f"resilience_{leg}", "ok": True, **legs[leg]})
        torch.cuda.empty_cache()
    emit({"phase": "resilience", "ok": True, "params": MAIN_P,
          "clients_per_round": MAIN_K, "writers": 350,
          "rounds": RESILIENCE_ROUNDS, "legs": list(legs),
          "seconds": round(time.time() - tic, 3)})


# ----------------------------------------------------------------------
#: the model-options phase: RingLM's rounds at experiments/ringlm's widths
#: (4 layers of embed 128, 4 heads of 32, mlp 512, seq_len 1024, batch 4,
#: K = 10), flash on; the MoE FFN's experts; the sequence lengths of the
#: "auto" gate's two sides (``seq_len - 1`` tokens against
#: ``FLASH_AUTO_MIN_LEN`` = 4096)
MOE_EXPERTS = 4
MOE_ROUNDS = 2
AUTO_SEQ_LENS = (4097, 1024)
#: main's final model on its val split (``phase_main``): what a warm start
#: from main's ``latest_model.pt`` must evaluate to at its round 0
MAIN_FINAL_VAL = {}


def _build_server(work, name, raw, device, task):
    """The CLI's server for ``raw`` (config, task, datasets, model
    directory), built as ``e2e_trainer.main`` builds it, without its
    training loop: legs that drive one round of the round engine from a
    state and cohort they choose, and write no checkpoint."""
    from msrflute_tpu_torch import e2e_trainer
    from msrflute_tpu_torch.config import FLUTEConfig
    from msrflute_tpu_torch.engine import select_server
    from msrflute_tpu_torch.models import make_task
    cfg = FLUTEConfig.from_dict(json.loads(json.dumps(raw)))
    cfg.task, cfg.data_path = task, work
    cfg.validate(work)
    t = make_task(cfg.model_config)
    train, val, test = e2e_trainer.build_task_datasets(cfg, t)
    return select_server(cfg.server_config.get("type"))(
        t, cfg, train, val_dataset=val, test_dataset=test,
        model_dir=os.path.join(work, f"out_{name}", "models"),
        device=device)


def _cohort(server):
    """One round's cohort and grid, drawn as the server draws them."""
    from msrflute_tpu_torch.data.batching import pack_round_batches
    sampled = server._sample()
    return pack_round_batches(
        server.train_dataset, sampled, server.batch_size,
        server._chunk_steps([sampled]), rng=server._np_rng,
        desired_max_samples=server.desired_max_samples)


def _lrs(raw):
    sc = raw["server_config"]
    return (float(sc.get("initial_lr_client", 0.01)),
            float(sc["optimizer_config"].get("lr", 1.0)),
            raw["model_config"].get("quant_threshold"))


def _one_round(torch, server, state, batch, raw):
    """``(state, train loss, launches, peak GB, seconds)`` of one round of
    ``server``'s engine from ``state`` on ``batch``, the counts set to 0
    just before."""
    client_lr, server_lr, quant = _lrs(raw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    tic = time.time()
    state, st = server.engine.run_round(state, batch, client_lr, server_lr,
                                        quant_threshold=quant)
    torch.cuda.synchronize()
    secs = time.time() - tic
    launches = _read_counts()
    loss = st["train_loss_sum"] / max(st["client_count"], 1.0)
    return (state, loss, launches, torch.cuda.max_memory_allocated() / 1e9,
            secs)


def _rel_l2(a, b):
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).norm() / b.norm())


def _ensure_blob(work, data_dir, writer, splits):
    if not os.path.exists(os.path.join(work, data_dir, "train.json")):
        _write_splits(work, data_dir, writer, splits)


def _leg_ringlm_remat(torch, work, kernel_rows):
    """One round with remat on, then one with it off, from one state and
    cohort: B4 twice a layer a local step under remat (forward and
    recompute), once without; B5 and B6 once either way; the params
    bitwise (or, failing that, within ``CROSS_TOL[1]``, with the gap
    reported)."""
    _ensure_blob(work, "longtext", write_longtext_blob, RINGLM_SPLITS)
    raw = ringlm_config(rounds=1)
    raw["server_config"].update(initial_val=False, val_freq=100,
                                rec_freq=100)
    out, params = {}, {}
    batch = state = None
    for remat in (True, False):
        raw["model_config"]["remat"] = remat
        server = _build_server(work, f"remat_{remat}", raw, "cuda", "ringlm")
        check(server.task.module.block_0.remat is remat,
              "ringlm_remat: the task's remat flag")
        if batch is None:
            batch, state = _cohort(server), server.state
        new, loss, launches, peak, secs = _one_round(torch, server, state,
                                                     batch, raw)
        layers = server.task.module.num_layers
        steps = int(batch.sample_mask.shape[1])
        want = {"fused_sgd_apply": steps,
                "flash_attention_fwd": layers * steps * (2 if remat else 1),
                "flash_attention_dq": layers * steps,
                "flash_attention_dkv": layers * steps,
                "fused_gaussian_noise": 0, "quant_bin_sparsify": 0}
        check(launches == want,
              f"ringlm_remat (remat {remat}) launches {launches}, want "
              f"{want}")
        check(math.isfinite(loss), f"ringlm_remat: train loss {loss}")
        params[remat] = new.params
        out["remat" if remat else "plain"] = {
            "train_loss": loss, "launches": launches,
            "b4_per_layer_step": launches["flash_attention_fwd"]
            / (layers * steps),
            "peak_allocated_gb": peak, "round_seconds": round(secs, 3)}
        for row in kernel_rows:
            row.setdefault("launches_by_path", {})[
                f"model_options_ringlm_{'remat' if remat else 'plain'}"] = \
                launches[row["name"]]
        del server
    bitwise = bool(torch.equal(params[True], params[False]))
    rel = _rel_l2(params[True], params[False])
    check(bitwise or rel <= CROSS_TOL[1],
          f"ringlm_remat: remat vs plain params rel L2 {rel}")
    return {"layers": layers, "local_steps": steps,
            "clients": int(batch.sample_mask.shape[0]),
            "bitwise": bitwise, "rel_l2_params": rel, **out,
            "peak_saved_gb": out["plain"]["peak_allocated_gb"]
            - out["remat"]["peak_allocated_gb"]}


def _leg_ringlm_moe(torch, work, kernel_rows):
    """``MOE_EXPERTS`` experts at the same widths for ``MOE_ROUNDS`` rounds,
    twice on cuda from one state and cohorts (bitwise), B4-B6 once a
    layer a local step; then cuda against cpu after one round at one
    layer and K = 2 (:func:`_cross_device`, ``CROSS_TOL[1]``)."""
    _ensure_blob(work, "longtext", write_longtext_blob, RINGLM_SPLITS)
    raw = ringlm_config(rounds=MOE_ROUNDS)
    raw["model_config"]["moe_experts"] = MOE_EXPERTS
    raw["server_config"].update(initial_val=False, val_freq=100,
                                rec_freq=100)
    runs, batches, losses = [], None, []
    for run in range(2):
        server = _build_server(work, f"moe_{run}", raw, "cuda", "ringlm")
        check("block_0.moe_ffn.w_in" in server.engine.layout.names,
              "ringlm_moe: no moe_ffn in the task")
        if batches is None:
            batches = [_cohort(server) for _ in range(MOE_ROUNDS)]
        state, run_loss, counts, peak = server.state, [], [], 0.0
        for batch in batches:
            state, loss, launches, peak_r, _ = _one_round(
                torch, server, state, batch, raw)
            run_loss.append(loss)
            peak = max(peak, peak_r)
            layers = server.task.module.num_layers
            steps = int(batch.sample_mask.shape[1])
            check(all(v == layers * steps for v in
                      _flash_launch_counts(launches).values()),
                  f"ringlm_moe launches {launches} for {layers} layers x "
                  f"{steps} steps")
            counts.append(launches)
        check(all(map(math.isfinite, run_loss)),
              f"ringlm_moe train losses {run_loss}")
        runs.append(state.params)
        losses.append(run_loss)
        del server
    check(bool(torch.equal(runs[0], runs[1])),
          "ringlm_moe: two cuda runs differ")
    for row in kernel_rows:
        row.setdefault("launches_by_path", {})["model_options_ringlm_moe"] \
            = counts[0][row["name"]]
    cross = ringlm_config(rounds=1)
    cross["model_config"].update(moe_experts=MOE_EXPERTS, num_layers=1)
    cross["server_config"].update(num_clients_per_iteration=2, val_freq=100,
                                  rec_freq=100, initial_val=False,
                                  rounds_per_step=1, model_backup_freq=1)
    cross["client_config"]["desired_max_samples"] = 4
    _cross_device(torch, work, "model_options_ringlm_moe_cross_device",
                  cross, "ringlm", {1: CROSS_TOL[1]})
    return {"experts": MOE_EXPERTS, "rounds": MOE_ROUNDS,
            "train_loss": losses[0], "cuda_reproducible": True,
            "launches_round_1": counts[0],
            "peak_allocated_gb": peak}


def _leg_flash_auto(torch, work, kernel_rows):
    """``flash_attention: "auto"`` at one layer, K = 2, batch 1, one local
    step: at ``seq_len`` 4097 (4,096 tokens) B4-B6 run, at 1024 none
    does."""
    _ensure_blob(work, "longtext", write_longtext_blob, RINGLM_SPLITS)
    out = {}
    for seq_len in AUTO_SEQ_LENS:
        raw = ringlm_config(rounds=1, flash="auto")
        raw["model_config"].update(num_layers=1, seq_len=seq_len)
        raw["server_config"].update(num_clients_per_iteration=2,
                                    initial_val=False, val_freq=100,
                                    rec_freq=100)
        raw["client_config"]["desired_max_samples"] = 1
        raw["client_config"]["data_config"]["train"]["batch_size"] = 1
        server = _build_server(work, f"auto_{seq_len}", raw, "cuda",
                               "ringlm")
        batch = _cohort(server)
        _, loss, launches, peak, secs = _one_round(torch, server,
                                                   server.state, batch, raw)
        flash = server.task.module.block_0._MHA_0.use_flash
        counts = _flash_launch_counts(launches)
        want = {k: (1 if seq_len - 1 >= 4096 else 0) for k in counts}
        check(flash is (seq_len - 1 >= 4096) and counts == want and
              batch.sample_mask.shape[1] == 1,
              f"flash_auto at seq_len {seq_len}: flash {flash}, launches "
              f"{counts}, want {want}")
        check(math.isfinite(loss), f"flash_auto: train loss {loss}")
        out[f"seq_len_{seq_len}"] = {"tokens": seq_len - 1, "flash": flash,
                                     "launches": counts, "train_loss": loss,
                                     "peak_allocated_gb": peak,
                                     "round_seconds": round(secs, 3)}
        del server
    for row in kernel_rows:
        if row["name"].startswith("flash_attention"):
            row.setdefault("launches_by_path", {})[
                "model_options_flash_auto"] = \
                out[f"seq_len_{AUTO_SEQ_LENS[0]}"]["launches"][row["name"]]
    return out


def _bert_raw():
    raw = shipped_config("mlm_bert", "reddit_tokens", 1, backup_freq=1000)
    raw["server_config"].update(initial_val=False, val_freq=100,
                                rec_freq=100)
    return raw


def _leg_bert_gathered(torch, work, kernel_rows):
    """BERT-base under DGA with local DP and quantization: one round with
    the full MLM head, then one with the gathered head (40 slots), from
    one state and cohort (the MLM draws and dropout come from the same
    client streams): train losses within ``CROSS_TOL[1]``, B3 once a round
    either way, and each way's device busy ms (``_trace_rounds``: one
    warm-up, one timed and one traced round more) and peak allocated
    memory."""
    _ensure_blob(work, "reddit_tokens", write_bert_blob, BERT_SPLITS)
    raw = _bert_raw()
    out, batch, state = {}, None, None
    for head in ("full", "gathered"):
        raw["model_config"]["BERT"]["model"]["mlm_head"] = head
        server = _build_server(work, f"bert_{head}", raw, "cuda", "mlm_bert")
        check(server.task.mlm_head == head and
              server.engine.layout.numel == BERT_P,
              f"bert_gathered: the {head} head's task")
        if batch is None:
            batch, state = _cohort(server), server.state
        _, loss, launches, peak, secs = _one_round(torch, server, state,
                                                   batch, raw)
        want = {k: 0 for k in launches}
        want["quant_bin_sparsify"] = 1
        check(launches == want, f"bert_gathered ({head}) launches "
                                f"{launches}, want {want}")
        check(math.isfinite(loss), f"bert_gathered ({head}) loss {loss}")
        client_lr, server_lr, quant = _lrs(raw)
        traced_state = state

        def step():
            nonlocal traced_state
            traced_state = server.engine.run_round(
                traced_state, batch, client_lr, server_lr,
                quant_threshold=quant)[0]

        traced = _trace_rounds(torch, step, 1, f"bert_{head}")
        out[head] = {"train_loss": loss, "launches": launches,
                     "peak_allocated_gb": peak,
                     "round_seconds": round(secs, 3),
                     "slots": server.task.gathered_slots
                     if head == "gathered" else server.task.seq_len,
                     **{k: traced[k] for k in (
                         "wall_ms_per_round", "device_busy_ms_per_round",
                         "device_idle_share")}}
        for row in kernel_rows:
            row.setdefault("launches_by_path", {})[
                f"model_options_bert_{head}"] = launches[row["name"]]
        del server, traced_state
        torch.cuda.empty_cache()
    rel = abs(out["gathered"]["train_loss"] - out["full"]["train_loss"]) \
        / abs(out["full"]["train_loss"])
    check(rel <= CROSS_TOL[1],
          f"bert_gathered: gathered vs full train loss rel {rel}")
    return {"params": BERT_P, "rel_train_loss": rel,
            "tolerance": CROSS_TOL[1], **out}


def _leg_bert_bf16(torch, work, kernel_rows):
    """The same config in bfloat16 (``BERT.model.dtype``), one round:
    finite loss, B3 once."""
    raw = _bert_raw()
    raw["model_config"]["BERT"]["model"]["dtype"] = "bfloat16"
    server = _build_server(work, "bert_bf16", raw, "cuda", "mlm_bert")
    check(server.task.compute_dtype == torch.bfloat16,
          "bert_bf16: the task's dtype")
    _, loss, launches, peak, secs = _one_round(
        torch, server, server.state, _cohort(server), raw)
    check(math.isfinite(loss) and launches["quant_bin_sparsify"] == 1 and
          sum(launches.values()) == 1,
          f"bert_bf16: loss {loss}, launches {launches}")
    for row in kernel_rows:
        row.setdefault("launches_by_path", {})["model_options_bert_bf16"] = \
            launches[row["name"]]
    return {"train_loss": loss, "launches": launches,
            "peak_allocated_gb": peak, "round_seconds": round(secs, 3)}


def _leg_fednewsrec_ref(torch, work, kernel_rows):
    """``experiments/fednewsrec`` with ``arch: fednewsrec`` through the
    CLI, one round: finite losses, ranking metrics in [0, 1], no port
    kernel, and the frozen table on the card bitwise its numpy draw."""
    import numpy as np
    _ensure_blob(work, "mind", write_mind_blob, MIND_SPLITS)
    raw = shipped_config("fednewsrec", "mind", 1)
    raw["model_config"]["arch"] = "fednewsrec"
    _reset_counts()
    server, out, secs = _run_cli(work, "fednewsrec_ref", raw, "cuda",
                                 task="fednewsrec")
    launches = _read_counts()
    _no_kernel("fednewsrec_ref", launches)
    mc = raw["model_config"]
    draw = np.random.default_rng(0).normal(
        scale=0.1, size=(int(mc["vocab_size"]), int(mc["embed_dim"])))
    table = server.task.word_table(server.device)
    check(table.is_cuda and np.array_equal(table.cpu().numpy(),
                                           draw.astype(np.float32)),
          "fednewsrec_ref: the frozen table is not its numpy draw")
    train_loss = [r["value"] for r in _records(out, "Training loss")]
    last = server.history[-1]
    check(len(train_loss) == 1 and all(map(math.isfinite, train_loss)) and
          all(0.0 <= last[k] <= 1.0 for k in ("auc", "mrr", "ndcg@5",
                                               "ndcg@10")),
          f"fednewsrec_ref: losses {train_loss}, metrics {last}")
    return {"params": server.engine.layout.numel,
            "table": list(table.shape), "train_loss": train_loss,
            "launches": launches, "evals": server.history,
            "run_seconds": round(secs, 3)}


def _leg_pretrained(torch, work, kernel_rows):
    """``main``'s CNN config warm-started from ``main``'s
    ``latest_model.pt``, one round through the CLI: its round-0 params
    bitwise ``latest``'s, its initial val bitwise ``main``'s final model's
    (:data:`MAIN_FINAL_VAL`), B1 once a local step."""
    src = os.path.join(work, "out_main", "models", "latest_model.pt")
    check(os.path.exists(src) and bool(MAIN_FINAL_VAL),
          "pretrained: main's latest_model.pt and final val")
    raw = _set_data(json.loads(json.dumps(CNN_CONFIG)), "femnist")
    raw["model_config"]["pretrained_model_path"] = src
    raw["server_config"].update(max_iteration=1, val_freq=1, rec_freq=100)
    warm = _build_server(work, "pretrained_check", raw, "cuda",
                         "cv_cnn_femnist")
    from msrflute_tpu_torch.engine.checkpoint import read_verified
    want = warm.engine.layout.flatten(read_verified(src)["params"])
    check(torch.equal(warm.state.params.cpu(), want) and
          warm.state.round == 0,
          "pretrained: the warm state is not main's latest params")
    del warm
    _reset_counts()
    server, _, secs = _run_cli(work, "pretrained", raw, "cuda")
    launches = _read_counts()
    _b1_alone("pretrained", launches, server.engine.local_steps)
    first = server.history[0]
    check(first["round"] == 0 and
          all(first[k] == MAIN_FINAL_VAL[k] for k in MAIN_FINAL_VAL),
          f"pretrained: initial val {first} is not main's final val "
          f"{MAIN_FINAL_VAL}")
    for row in kernel_rows:
        row.setdefault("launches_by_path", {})["model_options_pretrained"] \
            = launches[row["name"]]
    return {"source": "out_main/models/latest_model.pt",
            "initial_val": {k: first[k] for k in MAIN_FINAL_VAL},
            "main_final_val": dict(MAIN_FINAL_VAL),
            "b1_per_round": launches["fused_sgd_apply"],
            "launches": launches, "run_seconds": round(secs, 3)}


def _leg_eval_outputs(torch, work, kernel_rows):
    """``main``'s CNN config with ``wantLogits`` and ``per_user_stats`` on
    val, one round and one val eval through the CLI: a prediction row a
    real val sample, the six per-user metrics logged."""
    raw = _set_data(json.loads(json.dumps(CNN_CONFIG)), "femnist")
    raw["server_config"].update(max_iteration=1, val_freq=1, rec_freq=100,
                                initial_val=False)
    raw["server_config"]["data_config"]["val"].update(wantLogits=True,
                                                      per_user_stats=True)
    _reset_counts()
    server, out, secs = _run_cli(work, "eval_outputs", raw, "cuda")
    launches = _read_counts()
    _b1_alone("eval_outputs", launches, server.engine.local_steps)
    path = os.path.join(out, "models", "predictions_val_r1.jsonl")
    with open(path) as fh:
        rows = [json.loads(line) for line in fh]
    real = int(sum(server.val_dataset.num_samples))
    check(len(rows) == real and set(rows[0]) == {"user", "pred", "label",
                                                 "logits"},
          f"eval_outputs: {len(rows)} rows for {real} val samples")
    names = ["worst user", "user p10", "user p50", "user p90", "user std",
             "users evaluated"]
    per_user = {n: [r["value"] for r in _records(out, f"Val acc ({n})")]
                for n in names}
    check(all(len(v) == 1 for v in per_user.values()) and
          per_user["users evaluated"][0] == len(server.val_dataset),
          f"eval_outputs: per-user metrics {per_user}")
    return {"rows": len(rows), "real_val_samples": real,
            "per_user": {k: v[0] for k, v in per_user.items()},
            "run_seconds": round(secs, 3)}


def phase_model_options(torch, work, kernel_rows):
    """The model-options slice on one card, a line a leg
    (``model_options_<leg>``), then the phase's: RingLM's ``remat``, MoE
    FFN and ``"auto"`` flash gate, BERT's gathered head and bfloat16,
    NRMS's reference net, a warm start and the eval outputs."""
    legs = {}
    tic = time.time()
    for leg, fn in (("ringlm_remat", _leg_ringlm_remat),
                    ("ringlm_moe", _leg_ringlm_moe),
                    ("flash_auto", _leg_flash_auto),
                    ("bert_gathered", _leg_bert_gathered),
                    ("bert_bf16", _leg_bert_bf16),
                    ("fednewsrec_ref", _leg_fednewsrec_ref),
                    ("pretrained", _leg_pretrained),
                    ("eval_outputs", _leg_eval_outputs)):
        lap = time.time()
        legs[leg] = fn(torch, work, kernel_rows)
        legs[leg]["seconds"] = round(time.time() - lap, 3)
        emit({"phase": f"model_options_{leg}", "ok": True, **legs[leg]})
        torch.cuda.empty_cache()
    emit({"phase": "model_options", "ok": True, "legs": list(legs),
          "seconds": round(time.time() - tic, 3)})


# ----------------------------------------------------------------------
#: the throughput phase (cohort bucketing, megabatching): rounds an arm
THROUGHPUT_ROUNDS = 3
#: bucketed against monolithic final params, the JAX package's bar on its
#: own LR config and pool (``tests/test_cohort_bucketing.py:53-99,
#: 237-254``, ``JAX_LR_*`` below).  CNN_FEMNIST is not held to a bar: a
#: client's update there depends on the vmap width it trains at (cuDNN's
#: grouped convolution and cuBLAS pick kernels by the batch count), and
#: its local steps amplify a last-place difference into another
#: trajectory (a 1e-7 change of the start moves a 15-step client's payload
#: by 23 % in relative L2 on the H100, ``msrflute_tpu_torch/csrc/probes/
#: vmap_width.py``), so its payloads are held bitwise at
#: the monolithic grid's width and its params' distance is reported
BUCKET_RTOL, BUCKET_ATOL = 2e-4, 1e-6
#: the JAX test's pool sizes (16 users, 3-80 samples) and its LR
JAX_LR_SIZES = [3, 4, 5, 5, 6, 6, 7, 8, 9, 10, 12, 14, 30, 34, 70, 80]
JAX_LR_MODEL = {"model_type": "LR", "num_classes": 4, "input_dim": 8}


def _image_pool(sizes, seed):
    """A FEMNIST-shaped writer pool generated in memory: ``sizes[i]``
    28x28x1 uint8 images of 62 classes for writer i."""
    import numpy as np
    from msrflute_tpu_torch.data.dataset import ArraysDataset
    rng = np.random.default_rng(seed)
    per = [{"x": rng.integers(0, 256, size=(int(n), 28, 28, 1),
                              dtype=np.uint8),
            "y": rng.integers(0, 62, size=int(n)).astype(np.int32)}
           for n in sizes]
    return ArraysDataset([f"w{seed}_{i:04d}" for i in range(len(sizes))],
                         per)


def _jax_lr_pool():
    """``tests/test_cohort_bucketing.py::_hetero_dataset``: 16 users of 8
    features and 4 separable classes."""
    import numpy as np
    from msrflute_tpu_torch.data.dataset import ArraysDataset
    rng = np.random.default_rng(0)
    w = rng.normal(size=(8, 4))
    per = []
    for n in JAX_LR_SIZES:
        x = rng.normal(size=(n, 8)).astype(np.float32)
        per.append({"x": x, "y": np.argmax(x @ w, -1).astype(np.int32)})
    return ArraysDataset([f"u{u:03d}" for u in range(len(per))], per)


def _jax_lr_config(**server):
    """That test's ``_cfg``: LR, 6 clients a round at batch 4, client SGD
    lr 0.2, server SGD lr 1.0, six rounds."""
    raw = _throughput_config(**server)
    raw["model_config"] = dict(JAX_LR_MODEL)
    raw["server_config"].update(max_iteration=6, num_clients_per_iteration=6,
                                initial_lr_client=0.2,
                                megakernel={"pallas_apply": False})
    raw["client_config"] = {"optimizer_config": {"type": "sgd", "lr": 0.2},
                            "data_config": {"train": {"batch_size": 4}}}
    return raw


def _throughput_config(**server):
    """``main``'s CNN_FEMNIST config (P = 1,206,590, 10 clients at batch
    20) for an in-memory pool: ``THROUGHPUT_ROUNDS`` rounds of one a
    chunk, serial (``pipeline_depth`` 0: each round's ``secsPerRound`` is
    its own, prep to fence; the ring drains its last chunks back to back),
    no evals, ``server`` keys on top."""
    import copy
    raw = copy.deepcopy(CNN_CONFIG)
    sc = raw["server_config"]
    del sc["data_config"]
    sc.update({"max_iteration": THROUGHPUT_ROUNDS, "initial_val": False,
               "val_freq": 100, "rec_freq": 100, "rounds_per_step": 1,
               "pipeline_depth": 0, **server})
    return raw


def _tp_run(raw, pool, work, name, device="cuda", record=None):
    """``raw`` on ``pool`` through ``OptimizationServer.train`` from seed 7:
    ``(server, seconds)``; ``record`` gets each round's bucket grids."""
    import copy
    from msrflute_tpu_torch.config import FLUTEConfig
    from msrflute_tpu_torch.engine.server import OptimizationServer
    from msrflute_tpu_torch.models import make_task
    cfg = FLUTEConfig.from_dict(copy.deepcopy(raw))
    server = OptimizationServer(make_task(cfg.model_config), cfg, pool,
                                model_dir=os.path.join(work, f"tp_{name}"),
                                device=device, seed=7)
    if record is not None:
        pack = server._pack_bucketed_round

        def recording(sampled):
            grids = pack(sampled)
            record.append(grids)
            return grids

        server._pack_bucketed_round = recording
    tic = time.time()
    server.train()
    return server, time.time() - tic


def _secs(server):
    """``(secs/round, mean after the first)``."""
    rounds = server.run_stats["secsPerRound"]
    return rounds, _mean(rounds[1:])


def _bucket_payloads(torch, server, pool):
    """One cohort's payloads, from one state and the same sample orders,
    on its bucket grids against the same clients' rows of the monolithic
    grid: each bucket's ``S_b`` steps at the monolithic grid's width (K
    rows) bitwise, and at the bucket's capacity (its own width) the rows
    bitwise and the largest relative L2 of a client's difference."""
    import numpy as np
    from msrflute_tpu_torch.data.batching import (assign_step_buckets,
                                                  pack_round_batches,
                                                  pow2_ceil)
    rng = np.random.default_rng(5)
    sampled = [int(c) for c in rng.choice(len(pool), MAIN_K, replace=False)]
    needs = [int(server._step_needs[c]) for c in sampled]
    orders = {c: rng.permutation(int(pool.num_samples[c])) for c in sampled}
    B, state = server.batch_size, server.state
    mono = pack_round_batches(pool, sampled, B, min(
        server.max_steps, pow2_ceil(max(needs))), orders=orders)
    pg_m = server.engine.client_payloads(state, mono, 0.1)[0]
    cb = server.cohort_bucketing
    at_width, at_cap, worst, shapes = 0, 0, 0.0, []
    for (s_b, pos), cap in zip(assign_step_buckets(
            needs, cb["boundaries"], capacities=cb["capacities"]).items(),
            cb["capacities"]):
        if not pos:
            continue
        ids = [sampled[p] for p in pos]
        for width in (MAIN_K, max(cap, len(pos))):
            grid = pack_round_batches(pool, ids, B, s_b, orders=orders,
                                      pad_clients_to=width)
            pg_b = server.engine.client_payloads(state, grid, 0.1)[0]
            same = [torch.equal(pg_b[r], pg_m[p]) for r, p in enumerate(pos)]
            if width == MAIN_K:
                at_width += sum(same)
                continue
            shapes.append(list(grid.sample_mask.shape[:2]))
            at_cap += sum(same)
            worst = max([worst] + [float((pg_b[r] - pg_m[p]).norm()
                                         / pg_m[p].norm())
                                   for r, p in enumerate(pos)])
    check(at_width == MAIN_K,
          f"throughput: {MAIN_K - at_width} clients' payloads on S_b-step "
          "grids of the monolithic width differ from their monolithic rows")
    return {"clients": MAIN_K,
            "monolithic_grid": list(mono.sample_mask.shape[:2]),
            "bitwise_at_monolithic_width": at_width,
            "bucket_grids": shapes, "bitwise_at_bucket_width": at_cap,
            "max_rel_l2_at_bucket_width": worst}


def _rel_by_round(torch, a, b, rounds):
    """Relative L2 of two runs' params after each of ``rounds`` (their
    ``epoch<r>.pt``)."""
    cpu = torch.device("cpu")
    out = {}
    for r in rounds:
        x = a.ckpt.load(cpu, f"epoch{r}.pt").params.double()
        y = b.ckpt.load(cpu, f"epoch{r}.pt").params.double()
        out[r] = float((x - y).norm() / y.norm())
    return out


def _hold_b1(torch, shapes):
    """B1 against its plain version at the bucket grids' ``[K_b, P]``:
    bitwise, with a zero gate on one row."""
    from msrflute_tpu_torch.ops.fused_sgd import (fused_sgd_apply,
                                                  fused_sgd_plain)
    worst = 0.0
    for K in sorted(shapes):
        gate = [1.0] * K
        gate[-1] = 0.0
        p, g, m, gt, _ = _sgd_inputs(torch, K, MAIN_P, gate, seed=K)
        p2, m2 = p.clone(), m.clone()
        fused_sgd_apply(p, g, m, 0.1, 0.0, gt)
        fused_sgd_plain(p2, g, m2, 0.1, 0.0, gt)
        torch.cuda.synchronize()
        worst = max(worst, float((p - p2).abs().max()))
        check(torch.equal(p, p2) and torch.equal(m, m2),
              f"B1 at [{K}, {MAIN_P}]: kernel != plain")
    return worst


def _leg_bucketing(torch, work, kernel_rows):
    """CNN_FEMNIST with ``pallas_apply`` on a heterogeneous pool (200
    writers, log-uniform 20-1,200 samples), ``max_buckets: 4``: three
    rounds bucketed (twice) and three monolithic from one state and seed;
    then LR on the same pool both ways."""
    import numpy as np
    rng = np.random.default_rng(21)
    sizes = np.rint(np.exp(rng.uniform(np.log(20), np.log(1200), 200)))
    pool = _image_pool(sizes, 21)
    keep = dict(model_backup_freq=1)
    buckets = dict(cohort_bucketing={"enable": True, "max_buckets": 4})
    mono, mono_s = _tp_run(_throughput_config(**keep), pool, work, "mono")
    grids = []
    _reset_counts()
    buck, buck_s = _tp_run(_throughput_config(**keep, **buckets), pool, work,
                           "bucketed", record=grids)
    launches = _read_counts()
    steps = buck.engine.local_steps
    again, _ = _tp_run(_throughput_config(**buckets), pool, work,
                       "bucketed_again")
    want = sum(g.sample_mask.shape[1] for row in grids for g in row)
    check(launches["fused_sgd_apply"] == steps == want > 0,
          f"throughput: B1 launched {launches['fused_sgd_apply']} times, "
          f"{steps} local steps, sum_b E*S_b = {want}")
    check(not any(n for k, n in launches.items() if k != "fused_sgd_apply"),
          f"throughput: another path's kernel on the CNN path: {launches}")
    check(torch.equal(buck.state.params, again.state.params),
          "throughput: two bucketed runs of one config differ")
    rel = _rel_by_round(torch, buck, mono, range(1, THROUGHPUT_ROUNDS + 1))
    check(torch.isfinite(buck.state.params).all(),
          "throughput: bucketed params are not finite")
    diff = float((buck.state.params - mono.state.params).abs().max())
    payloads = _bucket_payloads(torch, buck, pool)
    b1_err = _hold_b1(torch, {g.sample_mask.shape[0]
                              for row in grids for g in row})
    for row in kernel_rows:
        row.setdefault("launches_by_path", {})["throughput_bucketing"] = \
            launches[row["name"]]
    # the JAX test's LR config and pool: its bar
    lr = {}
    for name, extra in (("monolithic", {}),
                        ("bucketed", {"cohort_bucketing": {
                            "enable": True, "max_buckets": 3}})):
        raw = _jax_lr_config(**extra)
        lr[name] = _tp_run(raw, _jax_lr_pool(), work, f"lr_{name}")[0]
    lr_diff = float((lr["bucketed"].state.params
                     - lr["monolithic"].state.params).abs().max())
    check(bool(torch.allclose(lr["bucketed"].state.params,
                              lr["monolithic"].state.params,
                              rtol=BUCKET_RTOL, atol=BUCKET_ATOL)),
          f"throughput: LR bucketed vs monolithic max abs {lr_diff}")
    out = {"writers": len(sizes), "samples": int(sizes.sum()),
           "boundaries": buck.cohort_bucketing["boundaries"],
           "capacities": buck.cohort_bucketing["capacities"],
           "grids_per_round": [[list(g.sample_mask.shape[:2]) for g in row]
                               for row in grids],
           "launches": launches, "local_steps": steps,
           "b1_plain_max_abs_err": b1_err, "bucketed_repeat_bitwise": True,
           "rel_l2_vs_monolithic_by_round": rel,
           "params_vs_monolithic_max_abs_diff": diff,
           "within_rtol_atol": bool(torch.allclose(
               buck.state.params, mono.state.params, rtol=BUCKET_RTOL,
               atol=BUCKET_ATOL)),
           "payloads": payloads,
           "lr_vs_monolithic_max_abs_diff": lr_diff,
           "lr_bitwise": bool(torch.equal(lr["bucketed"].state.params,
                                          lr["monolithic"].state.params)),
           "lr_tolerance": {"rtol": BUCKET_RTOL, "atol": BUCKET_ATOL}}
    for name, server, secs in (("monolithic", mono, mono_s),
                               ("bucketed", buck, buck_s)):
        rounds, after = _secs(server)
        out[name] = {"paddingEfficiency": server.padding_efficiency,
                     "paddingEfficiency_per_round":
                         server.run_stats["paddingEfficiency"],
                     "secs_per_round": rounds,
                     "secs_per_round_after_first": after,
                     "run_seconds": round(secs, 3)}
    out["padding_efficiency_ratio"] = (buck.padding_efficiency
                                       / mono.padding_efficiency)
    return out


def _bimodal_pool():
    """``bench.py::_bimodal_image_dataset``'s shape: 48 writers, 45 of
    them with 30-60 samples, three with 1,500."""
    import numpy as np
    rng = np.random.default_rng(7)
    sizes = [1500 if u >= 45 else int(rng.integers(30, 61))
             for u in range(48)]
    return _image_pool(sizes, 7), sizes


def _leg_megabatch(torch, work):
    """The bimodal pool in one bucket (``max_buckets: 1``),
    ``pallas_apply`` off: the vmap arm, the tape at the grid's width (its
    lanes pinned to the capacity, ``min_gain`` 0: the same vmap width,
    so bitwise) and the tape at its own lane count."""
    pool, sizes = _bimodal_pool()
    base = dict(megakernel={"pallas_apply": False}, model_backup_freq=1,
                cohort_bucketing={"enable": True, "max_buckets": 1})
    vmap, vs = _tp_run(_throughput_config(**base), pool, work, "mega_vmap")
    pinned, ps = _tp_run(_throughput_config(
        megabatch={"enable": True, "lanes": MAIN_K, "min_gain": 0.0},
        **base), pool, work, "mega_pinned")
    auto, auto_s = _tp_run(_throughput_config(
        megabatch={"enable": True}, **base), pool, work, "mega_auto")
    for name, server in (("pinned", pinned), ("auto", auto)):
        util = server.megabatch_utilization
        check("mega" in server.engine.mega_gate.values() and
              util is not None and 0.0 < util <= 1.0,
              f"throughput: the tape arm ({name}) did not run: gate "
              f"{server.engine.mega_gate}, utilization {util}")
    check(torch.equal(pinned.state.params, vmap.state.params),
          "throughput: megabatch at the grid's width != vmap at E = 1")
    diff = float((auto.state.params - vmap.state.params).abs().max())
    rel = _rel_by_round(torch, auto, vmap, range(1, THROUGHPUT_ROUNDS + 1))
    check(torch.isfinite(auto.state.params).all(),
          "throughput: megabatch params are not finite")
    out = {"writers": len(sizes), "samples": int(sum(sizes)),
           "pinned_bitwise_vmap": True, "auto_vs_vmap_max_abs_diff": diff,
           "auto_rel_l2_by_round": rel,
           "auto_bitwise_vmap": bool(torch.equal(auto.state.params,
                                                 vmap.state.params))}
    for name, server, secs in (("vmap", vmap, vs), ("pinned", pinned, ps),
                               ("auto", auto, auto_s)):
        rounds, after = _secs(server)
        out[name] = {"lanes": (server.megabatch or {}).get("lanes"),
                     "gate": {f"K{k}_S{s}": a for (k, s), a in
                              sorted(server.engine.mega_gate.items())},
                     "megabatch_utilization": server.megabatch_utilization,
                     "megabatch_fallbacks": server.megabatch_fallbacks,
                     "paddingEfficiency": server.padding_efficiency,
                     "secs_per_round": rounds,
                     "secs_per_round_after_first": after,
                     "run_seconds": round(secs, 3)}
    return out


def _hold_dga_kernels(torch, shapes):
    """B3 against its plain version at each bucket grid's ``[K_b, P]`` of
    the GRU (bitwise) and B2 at ``[P]`` (within 4 ulp of the magnitude, as
    phase ``kernel`` holds it); B2's largest difference."""
    from msrflute_tpu_torch.ops.gaussian_noise import (fused_gaussian_noise,
                                                       gaussian_noise_plain)
    from msrflute_tpu_torch.ops.quant_bin import (quant_bin_plain,
                                                  quant_bin_sparsify)
    bounds = _gru_bounds()
    gen = torch.Generator(device="cuda").manual_seed(17)
    for K in shapes:
        x = torch.randn((K, DGA_P), device="cuda", generator=gen)
        off, lo, hi, th = _quant_case(torch, x, bounds, 0.7)
        k = quant_bin_sparsify(x, off, lo, hi, th, 1024)
        pl = quant_bin_plain(x, off.cpu(), lo, hi, th, 1024)
        torch.cuda.synchronize()
        check(torch.equal(k, pl), f"B3 at [{K}, {DGA_P}]: kernel != plain")
    x = torch.randn(DGA_P, device="cuda", generator=gen) * 1e-3
    k = fused_gaussian_noise(x, 1.0, 1.0, 99)
    pz = gaussian_noise_plain(x, 1.0, 1.0, 99)
    torch.cuda.synchronize()
    err = float((k - pz).abs().max())
    check(bool(((k - pz).abs() <= 4 * 2.0 ** -23 * (x.abs() + 8.0)).all()),
          f"B2 at [{DGA_P}]: max abs err {err}")
    return err


def _leg_dga_bucketed(torch, work, kernel_rows):
    """``experiments/nlg_gru``'s DGA with global DP and quantization
    (local DP off: ``torch.randn`` draws other numbers on the two
    devices), 4 clients of at most 128 samples, ``max_buckets: 3``, two
    rounds on cuda and on cpu: B2 once a round, B3 once a bucket grid, B1
    once a grid a local step; cuda vs cpu within ``DGA_CROSS_TOL``; B3 and B2 held to their
    plain versions at the leg's shapes."""
    from msrflute_tpu_torch.engine.server import OptimizationServer
    if not os.path.exists(os.path.join(work, "reddit", "train.json")):
        os.makedirs(os.path.join(work, "reddit"), exist_ok=True)
        words = write_reddit_vocab(os.path.join(work, "reddit",
                                                "vocab_reddit.vocab"))
        for split, users, lo, hi, seed in REDDIT_SPLITS:
            write_reddit_blob(os.path.join(work, "reddit", f"{split}.json"),
                              words, users, lo, hi, seed)
    raw = dga_config(rounds=2)
    raw["dp_config"]["enable_local_dp"] = False
    raw["server_config"].update(
        val_freq=100, rec_freq=100, initial_val=False, model_backup_freq=1,
        num_clients_per_iteration=4,
        cohort_bucketing={"enable": True, "max_buckets": 3})
    # at most 2 local steps (1,600 samples take 25): the cpu arm is the
    # leg's cost, and grids of 1 and 2 steps still bucket
    raw["client_config"]["desired_max_samples"] = 128
    grids = []
    pack = OptimizationServer._pack_bucketed_round

    def recording(self, sampled):
        out = pack(self, sampled)
        grids.append(out)
        return out

    OptimizationServer._pack_bucketed_round = recording
    try:
        _reset_counts()
        server, _, cuda_s = _run_cli(work, "tp_dga_cuda", raw, "cuda",
                                     task="nlg_gru")
        launches = _read_counts()
        n_grids = sum(len(row) for row in grids)
        steps = server.engine.local_steps
        params = {"cuda": [server.ckpt.load(torch.device("cpu"),
                                            f"epoch{r}.pt").params.double()
                           for r in DGA_CROSS_TOL]}
        del server
        cpu_server, _, cpu_s = _run_cli(work, "tp_dga_cpu", raw, "cpu",
                                        task="nlg_gru")
        params["cpu"] = [cpu_server.ckpt.load(torch.device("cpu"),
                                              f"epoch{r}.pt").params.double()
                         for r in DGA_CROSS_TOL]
        del cpu_server
    finally:
        OptimizationServer._pack_bucketed_round = pack
    check(launches["fused_gaussian_noise"] == 2,
          f"throughput dga: B2 launched {launches['fused_gaussian_noise']} "
          "times in 2 rounds")
    check(launches["quant_bin_sparsify"] == n_grids > 0,
          f"throughput dga: B3 launched {launches['quant_bin_sparsify']} "
          f"times for {n_grids} bucket grids")
    check(launches["fused_sgd_apply"] == steps > 0,
          f"throughput dga: B1 launched {launches['fused_sgd_apply']} times "
          f"for {steps} local steps")
    rel = {r: float((a - b).norm() / b.norm()) for r, a, b in
           zip(DGA_CROSS_TOL, params["cuda"], params["cpu"])}
    for r, v in rel.items():
        check(v <= DGA_CROSS_TOL[r], f"throughput dga: cuda vs cpu params "
                                     f"after round {r}: rel L2 {v}")
    shapes = sorted({g.sample_mask.shape[0] for row in grids for g in row})
    b2_err = _hold_dga_kernels(torch, shapes)
    for row in kernel_rows:
        row.setdefault("launches_by_path", {})["throughput_dga"] = \
            launches[row["name"]]
    return {"clients_per_round": 4, "rounds": 2, "grids": n_grids,
            "grid_shapes": [[list(g.sample_mask.shape[:2]) for g in row]
                            for row in grids[:2]],
            "launches": launches, "local_steps": steps,
            "rel_l2_by_round": rel, "tolerance_rel_l2_by_round":
                DGA_CROSS_TOL, "b3_held_at_rows": shapes,
            "b2_plain_max_abs_err": b2_err,
            "seconds": {"cuda": round(cuda_s, 3), "cpu": round(cpu_s, 3)}}


def _leg_scaffold_carry(torch, work):
    """SCAFFOLD with ``fused_carry`` on the bimodal pool, ``max_buckets:
    2``, two rounds: the vmap arm against the tape at the grids' width,
    bitwise in params and in the ``c`` / ``ci`` tables."""
    pool, _ = _bimodal_pool()
    base = dict(megakernel={"pallas_apply": False}, fused_carry=True,
                max_iteration=2, rounds_per_step=2, pipeline_depth=1,
                cohort_bucketing={"enable": True, "max_buckets": 2})
    runs = {}
    for name, extra in (("vmap", {}), ("mega", {"megabatch": {
            "enable": True, "lanes": MAIN_K, "min_gain": 0.0}})):
        raw = _throughput_config(**base, **extra)
        raw["strategy"] = "scaffold"
        runs[name] = _tp_run(raw, pool, work, f"scaffold_{name}")
    vmap, mega = runs["vmap"][0], runs["mega"][0]
    check("mega" in mega.engine.mega_gate.values(),
          f"throughput scaffold: the tape arm did not run: "
          f"{mega.engine.mega_gate}")
    same = torch.equal(mega.state.params, vmap.state.params) and all(
        torch.equal(v, vmap.state.strategy_state[k])
        for k, v in mega.state.strategy_state.items())
    check(same, "throughput scaffold: megabatch != vmap (params or tables)")
    return {"tables": sorted(mega.state.strategy_state),
            "bitwise": True,
            "gate": {f"K{k}_S{s}": a for (k, s), a in
                     sorted(mega.engine.mega_gate.items())},
            "megabatch_utilization": mega.megabatch_utilization,
            "seconds": {k: round(v[1], 3) for k, v in runs.items()}}


def phase_throughput(torch, work, kernel_rows):
    """Cohort bucketing and megabatching on one card, a line a leg
    (``throughput_<leg>``), then the phase's."""
    legs = {}
    tic = time.time()
    for leg, fn in (("bucketing", lambda: _leg_bucketing(torch, work,
                                                         kernel_rows)),
                    ("megabatch", lambda: _leg_megabatch(torch, work)),
                    ("dga", lambda: _leg_dga_bucketed(torch, work,
                                                      kernel_rows)),
                    ("scaffold_carry", lambda: _leg_scaffold_carry(torch,
                                                                   work))):
        lap = time.time()
        legs[leg] = fn()
        legs[leg]["seconds_leg"] = round(time.time() - lap, 3)
        emit({"phase": f"throughput_{leg}", "ok": True, **legs[leg]})
        torch.cuda.empty_cache()
    emit({"phase": "throughput", "ok": True, "params": MAIN_P,
          "clients_per_round": MAIN_K, "legs": list(legs),
          "seconds": round(time.time() - tic, 3)})


#: the data planes phase: rounds a pool arm, the writers of ``main``'s
#: pool, and the length leg's users, words a sentence and rounds
DATA_PLANE_ROUNDS = 3
DATA_PLANE_WRITERS = 350
LENGTH_USERS, LENGTH_WORDS, LENGTH_ROUNDS = 1000, (3, 12), 3
#: the length leg's bar: the params after the DGA rounds on the cropped
#: grids against the full ones, in relative L2 (the GRU's causal outputs
#: are the same; the loss sums over fewer padded positions, and a last
#: place may move a value across one of B3's bins)
LENGTH_REL_L2 = 1e-3


def _femnist_sizes(n, seed):
    """``write_femnist_blob``'s sample counts: 50-300 a writer."""
    import numpy as np
    return np.random.default_rng(seed).integers(50, 301, size=n)


def _pool_arm(torch, raw, pool, work, name):
    """One arm on ``pool``: ``(server, seconds, B1 launches, peak bytes)``
    with the counts zeroed just before it."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    server, secs = _tp_run(raw, pool, work, name)
    torch.cuda.synchronize()
    return (server, secs, _read_counts()["fused_sgd_apply"],
            torch.cuda.max_memory_allocated())


def _cpu_bytes(raw, pool, work, name, chunks):
    """``hostToDeviceBytesPerRound`` of a CPU server packing the same
    chunks from the same seed (host numpy, no round run)."""
    import copy
    from msrflute_tpu_torch.config import FLUTEConfig
    from msrflute_tpu_torch.engine.server import OptimizationServer
    from msrflute_tpu_torch.models import make_task
    cfg = FLUTEConfig.from_dict(copy.deepcopy(raw))
    server = OptimizationServer(make_task(cfg.model_config), cfg, pool,
                                model_dir=os.path.join(work, f"dp_{name}"),
                                device="cpu", seed=7)
    for R in chunks:
        server._record_staged_bytes(server._pack_chunk(R), R)
    return server.run_stats["hostToDeviceBytesPerRound"]


def _pool_legs(torch, raw, pool, work, name, kernel_rows, chunks):
    """Host-packed then pooled on ``raw``: params bitwise, B1 launches
    equal (the local steps), each arm's bytes a round equal to the CPU
    count; the arms' timing split and memory."""
    import copy
    arms, out = {}, {}
    for arm, on in (("host", False), ("pool", True)):
        r = copy.deepcopy(raw)
        r["client_config"]["data_config"]["train"]["device_resident"] = on
        server, secs, b1, peak = _pool_arm(torch, r, pool, work,
                                           f"{name}_{arm}")
        check(server.engine.pool_mode == on,
              f"data_planes {name}: {arm} arm pool mode "
              f"{server.engine.pool_mode}")
        check(b1 == server.engine.local_steps > 0,
              f"data_planes {name}: B1 launched {b1} times for "
              f"{server.engine.local_steps} local steps ({arm})")
        cpu = _cpu_bytes(r, pool, work, f"{name}_{arm}_cpu", chunks)
        got = server.run_stats["hostToDeviceBytesPerRound"]
        check(got == cpu, f"data_planes {name}: {arm} bytes a round {got} "
                          f"against the CPU count {cpu}")
        rs = server.run_stats
        out[arm] = {
            "hostToDeviceBytesPerRound": got,
            "secsPerRoundPack": _mean(rs["secsPerRoundPack"]),
            "secsPerRoundStage": _mean(rs["secsPerRoundStage"]),
            "secsPerRound": rs["secsPerRound"],
            "secs_per_round_after_first": _mean(rs["secsPerRound"][1:]),
            "b1_launches": b1, "peak_allocated_bytes": peak,
            "run_seconds": round(secs, 3)}
        if on:
            out[arm].update(pool_bytes=server.engine.pool_bytes,
                            pool_upload_seconds=server.engine.pool_upload_secs)
        arms[arm] = server
    check(torch.equal(arms["host"].state.params, arms["pool"].state.params),
          f"data_planes {name}: pool params != host-packed params")
    check(out["host"]["b1_launches"] == out["pool"]["b1_launches"],
          f"data_planes {name}: B1 launches differ between the arms")
    for row in kernel_rows:
        if row["name"] == "fused_sgd_apply":
            row.setdefault("launches_by_path", {})[f"data_planes_{name}"] = \
                out["pool"]["b1_launches"]
    out["params_bitwise"] = True
    out["bytes_ratio_host_over_pool"] = (
        out["host"]["hostToDeviceBytesPerRound"][0]
        / out["pool"]["hostToDeviceBytesPerRound"][0])
    return arms, out


def _leg_pool(torch, work, kernel_rows):
    sizes = _femnist_sizes(DATA_PLANE_WRITERS, 0)
    pool = _image_pool(sizes, 0)
    raw = _throughput_config(max_iteration=DATA_PLANE_ROUNDS,
                             pipeline_depth=1)
    _, out = _pool_legs(torch, raw, pool, work, "pool", kernel_rows,
                        [1] * DATA_PLANE_ROUNDS)
    out["b1_plain_max_abs_err"] = _hold_b1(torch, {MAIN_K})
    out.update(writers=len(sizes), samples=int(sizes.sum()))
    return out


def _leg_pool_chunked(torch, work, kernel_rows):
    sizes = _femnist_sizes(DATA_PLANE_WRITERS, 0)
    raw = _throughput_config(max_iteration=DATA_PLANE_ROUNDS,
                             rounds_per_step=3, clients_per_chunk=5)
    _, out = _pool_legs(torch, raw, _image_pool(sizes, 0), work,
                        "pool_chunked", kernel_rows, [DATA_PLANE_ROUNDS])
    out["clients_per_chunk"] = 5
    return out


def _leg_pool_bucketed(torch, work, kernel_rows):
    import numpy as np
    rng = np.random.default_rng(21)
    sizes = np.rint(np.exp(rng.uniform(np.log(20), np.log(1200), 200)))
    raw = _throughput_config(max_iteration=DATA_PLANE_ROUNDS,
                             cohort_bucketing={"enable": True,
                                               "max_buckets": 4})
    arms, out = _pool_legs(torch, raw, _image_pool(sizes, 21), work,
                           "pool_bucketed", kernel_rows,
                           [1] * DATA_PLANE_ROUNDS)
    out["capacities"] = arms["pool"].cohort_bucketing["capacities"]
    check(arms["pool"].cohort_bucketing == arms["host"].cohort_bucketing,
          "data_planes pool_bucketed: the arms' grids differ")
    return out


def write_short_reddit_blob(path, words, num_users, seed):
    """Reddit-shaped users of 20-200 sentences (1-4 local steps at batch
    64) of ``LENGTH_WORDS`` words, Zipf frequencies over the vocabulary, 2%
    outside it."""
    import numpy as np
    rng = np.random.default_rng(seed)
    counts = rng.integers(20, 201, size=num_users)
    lo, hi = LENGTH_WORDS
    lens = rng.integers(lo, hi + 1, size=int(counts.sum()))
    ranks = np.arange(1, len(words))
    p = 1.0 / ranks
    ids = rng.choice(ranks, size=int(lens.sum()), p=p / p.sum())
    vocab = np.asarray(words + ["zzoov"], dtype=object)
    ids[rng.random(ids.shape[0]) < 0.02] = len(words)
    tokens = vocab[ids]
    ends = np.cumsum(lens)
    utts = [" ".join(tokens[e - n:e]) for e, n in zip(ends, lens)]
    users = [f"l{seed}_{i:04d}" for i in range(num_users)]
    data, pos = {}, 0
    for u, n in zip(users, counts.tolist()):
        data[u] = {"x": utts[pos:pos + n]}
        pos += n
    with open(path, "w") as fh:
        json.dump({"users": users, "num_samples": counts.tolist(),
                   "user_data": data}, fh)


def _leg_length(torch, work, kernel_rows):
    """``experiments/nlg_gru``'s DGA (global DP, quantization, local DP)
    through the CLI on the short-sentence blob, ``LENGTH_ROUNDS`` serial
    rounds (each ``secsPerRound`` its own, prep to fence) with
    ``length_bucketing`` on and off."""
    d = os.path.join(work, "reddit_short")
    os.makedirs(d, exist_ok=True)
    words = write_reddit_vocab(os.path.join(d, "vocab_reddit.vocab"))
    for split, users, seed in (("train", LENGTH_USERS, 40),
                               ("val", 20, 41), ("test", 20, 42)):
        write_short_reddit_blob(os.path.join(d, f"{split}.json"), words,
                                users, seed)
    raw = dga_config(rounds=LENGTH_ROUNDS)
    text = json.dumps(raw).replace("reddit/", "reddit_short/")
    raw = json.loads(text)
    raw["server_config"].update(val_freq=100, rec_freq=100,
                                initial_val=False, pipeline_depth=0,
                                rounds_per_step=1,
                                model_backup_freq=LENGTH_ROUNDS)
    out, params, runs = {}, {}, {}
    for arm, on in (("on", True), ("off", False)):
        raw["client_config"]["data_config"]["train"]["length_bucketing"] = on
        torch.cuda.empty_cache()
        _reset_counts()
        server, _, secs = _run_cli(work, f"dp_length_{arm}", raw, "cuda",
                                   task="nlg_gru")
        launches = _read_counts()
        check(launches["fused_gaussian_noise"] == LENGTH_ROUNDS and
              launches["quant_bin_sparsify"] == LENGTH_ROUNDS,
              f"data_planes length ({arm}): B2 / B3 launched "
              f"{launches['fused_gaussian_noise']} / "
              f"{launches['quant_bin_sparsify']} times in "
              f"{LENGTH_ROUNDS} rounds")
        check(launches["fused_sgd_apply"] == server.engine.local_steps > 0,
              f"data_planes length ({arm}): B1 {launches['fused_sgd_apply']}"
              f" for {server.engine.local_steps} local steps")
        check(bool(torch.isfinite(server.state.params).all()),
              f"data_planes length ({arm}): params are not finite")
        stats = server._length_bucket_stats
        rs = server.run_stats
        out[arm] = {"launches": {k: launches[k] for k in (
            "fused_sgd_apply", "fused_gaussian_noise", "quant_bin_sparsify")},
            "length_bucket": stats,
            "hostToDeviceBytesPerRound": rs["hostToDeviceBytesPerRound"],
            "secsPerRound": rs["secsPerRound"],
            "secs_per_round_after_first": _mean(rs["secsPerRound"][1:]),
            "run_seconds": round(secs, 3)}
        params[arm] = server.state.params.double()
        runs[arm] = launches
        del server
    stats = out["on"]["length_bucket"]
    check(stats is not None and stats["bucket"] == 16 and
          stats["full_len"] == 25,
          f"data_planes length: the chunk bucketed to {stats}")
    check(out["off"]["length_bucket"] is None,
          "data_planes length: cropped with length_bucketing off")
    rel = float((params["on"] - params["off"]).norm() / params["off"].norm())
    check(rel <= LENGTH_REL_L2,
          f"data_planes length: on vs off params rel L2 {rel}")
    b2_err = _hold_dga_kernels(torch, [DGA_K])
    for row in kernel_rows:
        row.setdefault("launches_by_path", {})["data_planes_length"] = \
            runs["on"][row["name"]]
    out.update(
        users=LENGTH_USERS, words=list(LENGTH_WORDS),
        bucket=stats["bucket"], full_len=stats["full_len"],
        padding_efficiency_before=stats["tokens_real"]
        / stats["tokens_grid_before"],
        padding_efficiency_after=stats["tokens_real"]
        / stats["tokens_grid_after"],
        rel_l2_on_vs_off=rel, rel_l2_bar=LENGTH_REL_L2,
        b3_b2_held_at_rows=[DGA_K], b2_plain_max_abs_err=b2_err)
    return out


def phase_data_planes(torch, work, kernel_rows):
    """The device-resident pool and length bucketing on one card, a line a
    leg (``data_planes_<leg>``), then the phase's."""
    legs = {}
    tic = time.time()
    for leg, fn in (("pool", _leg_pool), ("pool_chunked", _leg_pool_chunked),
                    ("pool_bucketed", _leg_pool_bucketed),
                    ("length", _leg_length)):
        lap = time.time()
        legs[leg] = fn(torch, work, kernel_rows)
        legs[leg]["seconds_leg"] = round(time.time() - lap, 3)
        emit({"phase": f"data_planes_{leg}", "ok": True, **legs[leg]})
        torch.cuda.empty_cache()
    emit({"phase": "data_planes", "ok": True, "legs": list(legs),
          "seconds": round(time.time() - tic, 3)})

# ----------------------------------------------------------------------
#: the fleet-and-traffic phase: ``main``'s CNN_FEMNIST config (P =
#: 1,206,590, 10 clients at batch 20) on the in-memory 350-writer pool,
#: FedBuff (``max_staleness: 4``) at depth 1; the fleet population
FLEET_TRAFFIC_ROUNDS = 3
FLEET_MILLION = 1_000_000


def _traffic_config(mode=None, rounds=FLEET_TRAFFIC_ROUNDS, **server):
    """FedBuff on ``_throughput_config`` at ``pipeline_depth`` 1 (B1 on),
    with ``traffic: {mode, trace: poisson, buffer_size: 10}`` when a mode
    is given."""
    raw = _throughput_config(max_iteration=rounds, pipeline_depth=1,
                             **server)
    raw["strategy"] = "fedbuff"
    raw["server_config"]["fedbuff"] = {"max_staleness": 4}
    if mode is not None:
        raw["server_config"]["traffic"] = {
            "mode": mode, "trace": "poisson", "buffer_size": MAIN_K}
    return raw


def _events(server, kind):
    return [e for e in server.metrics.events if e["event"] == kind]


def _b1_run(torch, raw, pool, work, name):
    """``raw`` on ``pool`` with the counts zeroed just before it:
    ``(server, seconds)``, B1 launched once a local step and no other
    kernel."""
    _reset_counts()
    server, secs = _tp_run(raw, pool, work, name)
    torch.cuda.synchronize()
    launches = _read_counts()
    want = {k: 0 for k in launches}
    want["fused_sgd_apply"] = steps = server.engine.local_steps
    check(steps > 0 and launches == want,
          f"fleet_traffic {name}: launches {launches}, want {want}")
    check(bool(torch.isfinite(server.state.params).all()),
          f"fleet_traffic {name}: params are not finite")
    return server, secs


def _profile_kernels(model_dir):
    """The kernel names of the chunk trace ``do_profiling`` wrote."""
    folder = os.path.join(model_dir, "profile")
    files = sorted(os.listdir(folder)) if os.path.isdir(folder) else []
    check(len(files) == 1, f"fleet_traffic: profile files {files}")
    with open(os.path.join(folder, files[0])) as fh:
        trace = json.load(fh)
    return files[0], {e.get("name", "") for e in trace["traceEvents"]
                      if e.get("cat") == "kernel"}


def _leg_traffic(torch, work, pool, kernel_rows, base_secs):
    """``buffered``: B1 once a local step and bitwise its plain version at
    ``[10, P]``, the staleness histogram and sum of every round equal to a
    host replay of the schedule's fires, one ``buffer_fired`` record a
    round, a second cuda run bitwise, and the profiled chunk's trace
    holding B1; ``sync``: no staleness operand, every fire's staleness 0."""
    import numpy as np
    from msrflute_tpu_torch.traffic import STALE_HIST_BINS, make_traffic
    R = FLEET_TRAFFIC_ROUNDS
    out = {}
    raw = _traffic_config("buffered", do_profiling=True)
    server, secs = _b1_run(torch, raw, pool, work, "ft_buffered")
    check(server.engine.traffic_staleness,
          "fleet_traffic buffered: no traced staleness")
    replay = make_traffic(raw["server_config"], len(pool))
    fired = _events(server, "buffer_fired")
    stale = _events(server, "traffic_staleness")
    check([e["round"] for e in fired] == [e["round"] for e in stale] ==
          list(range(R)), f"fleet_traffic buffered: fires {fired}")
    hists = []
    for e in stale:
        s = replay.fire(e["round"])["staleness"]
        want = np.bincount(np.minimum(s, STALE_HIST_BINS - 1),
                           minlength=STALE_HIST_BINS).astype(float)
        check(e["hist"] == want.tolist() and e["stale_sum"] == s.sum(),
              f"fleet_traffic buffered round {e['round']}: histogram "
              f"{e['hist']} sum {e['stale_sum']}, replay {want.tolist()} "
              f"{s.sum()}")
        hists.append(e["hist"])
    name, kernels = _profile_kernels(os.path.join(work, "tp_ft_buffered"))
    b1 = sorted(k for k in kernels if "fused_sgd_kernel" in k)
    check(bool(b1), f"fleet_traffic buffered: no B1 in the trace {name}")
    launches = _read_counts()["fused_sgd_apply"]
    again, _ = _b1_run(torch, raw, pool, work, "ft_buffered_again")
    check(torch.equal(again.state.params, server.state.params),
          "fleet_traffic buffered: a second cuda run differs")
    max_err = _hold_b1(torch, {MAIN_K})
    for row in kernel_rows:
        if row["name"] == "fused_sgd_apply":
            row.setdefault("launches_by_path", {})[
                "fleet_traffic_buffered"] = launches
    rounds, after = _secs(server)
    out["buffered"] = {
        "rounds": R, "b1_launches": launches,
        "local_steps": server.engine.local_steps,
        "b1_bitwise_plain_at": [MAIN_K, MAIN_P], "b1_max_abs_err": max_err,
        "stale_hist_by_round": hists,
        "stale_sum_by_round": [e["stale_sum"] for e in stale],
        "fires": [{k: e[k] for k in ("round", "tick", "wait_ticks",
                                     "stale_max", "stale_sum")}
                  for e in fired],
        "second_run_bitwise": True, "profile_trace": name,
        "profile_b1_kernels": b1, "train_seconds": round(secs, 3),
        "secs_per_round": rounds,
        "secs_per_round_after_first": after,
        "no_traffic_secs_per_round_after_first": base_secs,
        "card": CARD.get("name_power")}
    del server, again
    server, secs = _b1_run(torch, _traffic_config("sync"), pool, work,
                           "ft_sync")
    fired = _events(server, "buffer_fired")
    check(not server.engine.traffic_staleness and
          not _events(server, "traffic_staleness") and
          [e["stale_sum"] for e in fired] == [0] * R,
          f"fleet_traffic sync: fires {fired}")
    rounds, after = _secs(server)
    out["sync"] = {"rounds": R, "stale_sum_by_round": [0] * R,
                   "sync_discarded": server.traffic.counters[
                       "sync_discarded"],
                   "train_seconds": round(secs, 3),
                   "secs_per_round": rounds,
                   "secs_per_round_after_first": after,
                   "no_traffic_secs_per_round_after_first": base_secs,
                   "card": CARD.get("name_power")}
    return out


def _leg_fleet_sampling(torch, work, pool):
    """``fleet.sampling`` floyd and by_samples on FedAvg: every cohort the
    server drew is :func:`sample_cohort`'s host draw from the sampling
    state it drew at."""
    import copy
    import numpy as np
    from msrflute_tpu_torch.config import FLUTEConfig
    from msrflute_tpu_torch.data.fleet import sample_cohort
    from msrflute_tpu_torch.engine.server import OptimizationServer
    from msrflute_tpu_torch.models import make_task
    out = {}
    for mode in ("floyd", "by_samples"):
        raw = _throughput_config(max_iteration=2, pipeline_depth=1,
                                 fleet={"sampling": mode})
        cfg = FLUTEConfig.from_dict(copy.deepcopy(raw))
        server = OptimizationServer(
            make_task(cfg.model_config), cfg, pool,
            model_dir=os.path.join(work, f"ft_{mode}"), device="cuda",
            seed=7)
        states, cohorts, draw = [], [], server._sample

        def recording(draw=draw, server=server):
            states.append(copy.deepcopy(server._np_rng.bit_generator.state))
            cohorts.append([int(c) for c in draw()])
            return cohorts[-1]

        server._sample = recording
        tic = time.time()
        server.train()
        secs = time.time() - tic
        for state, cohort in zip(states, cohorts):
            rng = np.random.default_rng()
            rng.bit_generator.state = state
            want = sample_cohort(rng, len(pool), MAIN_K, mode=mode,
                                 num_samples=pool.num_samples)
            check([int(c) for c in want] == cohort,
                  f"fleet_traffic {mode}: cohort {cohort} != host {want}")
        check(len(cohorts) == 2 and
              bool(torch.isfinite(server.state.params).all()),
              f"fleet_traffic {mode}: {len(cohorts)} cohorts")
        out[mode] = {"cohorts": cohorts, "equal_host_draw": True,
                     "secs_per_round": server.run_stats["secsPerRound"],
                     "run_seconds": round(secs, 3)}
    return out


def _leg_million(torch, work):
    """A 10^6-user ``SyntheticFleetDataset`` under LR, 2 rounds with
    ``fleet.sampling: floyd``: the server's set-up seconds and the
    population's metadata bytes."""
    from msrflute_tpu_torch.config import FLUTEConfig
    from msrflute_tpu_torch.data.fleet import SyntheticFleetDataset
    from msrflute_tpu_torch.engine.server import OptimizationServer
    from msrflute_tpu_torch.models import make_task
    tic = time.time()
    pool = SyntheticFleetDataset(FLEET_MILLION, input_dim=8, num_classes=4)
    data_secs = time.time() - tic
    raw = {"model_config": {"model_type": "LR", "num_classes": 4,
                            "input_dim": 8},
           "strategy": "fedavg",
           "server_config": {
               "max_iteration": 2, "num_clients_per_iteration": MAIN_K,
               "initial_lr_client": 0.1, "initial_val": False,
               "val_freq": 100, "rec_freq": 100, "pipeline_depth": 1,
               "optimizer_config": {"type": "sgd", "lr": 1.0},
               "megakernel": {"pallas_apply": True},
               "fleet": {"sampling": "floyd"}},
           "client_config": {
               "optimizer_config": {"type": "sgd", "lr": 0.1},
               "data_config": {"train": {"batch_size": 20}}}}
    cfg = FLUTEConfig.from_dict(raw)
    _reset_counts()
    tic = time.time()
    server = OptimizationServer(make_task(cfg.model_config), cfg, pool,
                                model_dir=os.path.join(work, "ft_million"),
                                device="cuda", seed=7)
    setup_secs = time.time() - tic
    tic = time.time()
    server.train()
    torch.cuda.synchronize()
    run_secs = time.time() - tic
    steps = server.engine.local_steps
    check(_read_counts()["fused_sgd_apply"] == steps > 0 and
          server.state.round == 2 and
          bool(torch.isfinite(server.state.params).all()),
          f"fleet_traffic million: round {server.state.round}, steps {steps}")
    return {"users": FLEET_MILLION,
            "metadata_bytes": int(pool.num_samples.nbytes),
            "dataset_seconds": round(data_secs, 3),
            "server_setup_seconds": round(setup_secs, 3),
            "run_seconds": round(run_secs, 3),
            "cache": pool.cache_stats(),
            "secs_per_round": server.run_stats["secsPerRound"]}


def phase_fleet_traffic(torch, work, kernel_rows):
    """The arrival plane and fleet sampling on one card, through
    ``OptimizationServer.train``, a line a leg (``fleet_traffic_<leg>``),
    then the phase's: FedBuff on ``main``'s config without traffic (the
    same call's yardstick), ``buffered``, ``sync``, ``fleet_sampling`` and
    ``million``."""
    pool = _image_pool(_femnist_sizes(350, 0), 0)
    legs = {}
    tic = time.time()
    base, train_secs = _b1_run(torch, _traffic_config(None), pool, work,
                               "ft_base")
    base_rounds, base_secs = _secs(base)
    del base
    legs["no_traffic"] = {"train_seconds": round(train_secs, 3),
                          "secs_per_round": base_rounds,
                          "secs_per_round_after_first": base_secs,
                          "card": CARD.get("name_power")}
    emit({"phase": "fleet_traffic_no_traffic", "ok": True,
          **legs["no_traffic"]})
    for leg, rec in _leg_traffic(torch, work, pool, kernel_rows,
                                 base_secs).items():
        legs[leg] = rec
        emit({"phase": f"fleet_traffic_{leg}", "ok": True, **rec})
    legs["fleet_sampling"] = _leg_fleet_sampling(torch, work, pool)
    emit({"phase": "fleet_traffic_fleet_sampling", "ok": True,
          **legs["fleet_sampling"]})
    legs["million"] = _leg_million(torch, work)
    emit({"phase": "fleet_traffic_million", "ok": True, **legs["million"]})
    torch.cuda.empty_cache()
    emit({"phase": "fleet_traffic", "ok": True, "params": MAIN_P,
          "clients_per_round": MAIN_K, "writers": 350,
          "rounds": FLEET_TRAFFIC_ROUNDS, "legs": list(legs),
          "seconds": round(time.time() - tic, 3)})


# ----------------------------------------------------------------------
#: the fleet_paged phase (the fleet paged carry): the fused_carry phase's
#: CNN_FEMNIST SCAFFOLD and EF configs (P = 1,206,590, K = 10,
#: ``pallas_apply``) at depth 2 on ``main``'s 350 writers' sample counts,
#: generated in memory; the pool at the in-flight floor (10 clients x 1
#: round a chunk x (depth 2 + 1) = 30 slots) and a 2-row host cache.
#: Five rounds: the pool fills in three, and the same cohorts replayed on
#: the CPU read stored rows back in rounds 3 and 4
FLEET_PAGED_ROUNDS = 5
FLEET_PAGED_DEPTH = 2
FLEET_PAGED_FLEET = {"page_pool_slots": MAIN_K * (FLEET_PAGED_DEPTH + 1),
                     "host_cache_rows": 2}
#: FEMNIST's published writer count, on the default pool
FLEET_SCALE_WRITERS, FLEET_SCALE_ROUNDS = 3400, 3
#: every infra surface faulted (the rollup writer's stream has no user
#: before telemetry), with retries enough that no operation exhausts them
FLEET_PAGED_INFRA = {"seed": 52, "infra": {
    "store_write_error_rate": 0.2, "store_read_error_rate": 0.2,
    "prefetch_error_rate": 0.05, "prefetch_delay_rate": 0.3,
    "prefetch_delay_s": 0.001, "writer_error_rate": 0.1,
    "writeback_error_rate": 0.2}}
FLEET_PAGED_RETRY = {"retries": 8, "backoff_base_s": 0.0, "jitter": 0.0}


def _paged_config(leg, rounds=FLEET_PAGED_ROUNDS, fleet=None, **server):
    """``fused_config(leg, 2, rounds)``, with ``fleet`` (None: resident)
    and ``server`` keys on top."""
    raw = fused_config(leg, FLEET_PAGED_DEPTH, rounds)
    if fleet is not None:
        raw["server_config"]["fleet"] = dict(fleet)
    raw["server_config"].update(server)
    return raw


class _Operands:
    """The first call's operands of B1 and B3 on a run (cloned at the
    call, in stream order), through the names the round calls them by."""

    def __init__(self):
        from msrflute_tpu_torch.engine import client_update
        from msrflute_tpu_torch.ops import quantization
        self.names = ((client_update, "fused_sgd_apply"),
                      (quantization, "quant_bin_sparsify"))
        self.ops, self.real = {}, {}

    def __enter__(self):
        for mod, name in self.names:
            real = self.real[name] = getattr(mod, name)

            def shim(*args, _real=real, _name=name):
                if _name not in self.ops:
                    self.ops[_name] = tuple(
                        a.clone() if hasattr(a, "clone") else a
                        for a in args)
                return _real(*args)
            setattr(mod, name, shim)
        return self

    def __exit__(self, *exc):
        for mod, name in self.names:
            setattr(mod, name, self.real[name])


def _hold_operands(torch, ops):
    """Each captured kernel against its plain version on its captured
    operands, bitwise (after the run's counts were read)."""
    from msrflute_tpu_torch.ops.fused_sgd import (fused_sgd_apply,
                                                  fused_sgd_plain)
    from msrflute_tpu_torch.ops.quant_bin import (quant_bin_plain,
                                                  quant_bin_sparsify)
    out = {}
    if "fused_sgd_apply" in ops:
        p, g, m, lr, mu, gate = ops["fused_sgd_apply"]
        p2, m2 = p.clone(), m.clone()
        fused_sgd_apply(p, g, m, lr, mu, gate)
        fused_sgd_plain(p2, g, m2, lr, mu, gate)
        torch.cuda.synchronize()
        out["fused_sgd_apply"] = {"shape": list(p.shape),
                                  "max_abs_err": _max_abs_diff(torch, p, p2)}
        check(torch.equal(p, p2) and torch.equal(m, m2),
              f"B1 on the paged path's operands {list(p.shape)}: kernel "
              "!= plain")
    if "quant_bin_sparsify" in ops:
        x, off, lo, hi, th, n_bins = ops["quant_bin_sparsify"]
        k = quant_bin_sparsify(x, off, lo, hi, th, n_bins)
        pl = quant_bin_plain(x, off.cpu(), lo, hi, th, n_bins)
        torch.cuda.synchronize()
        out["quant_bin_sparsify"] = {"shape": list(x.shape),
                                     "max_abs_err": _max_abs_diff(torch, k,
                                                                  pl)}
        check(torch.equal(k, pl), f"B3 on the paged path's operands "
                                  f"{list(x.shape)}: kernel != plain")
    return out


def _fp_run(torch, raw, pool, work, name, meter, leg, kernel_rows=None):
    """``raw`` on ``pool`` through ``OptimizationServer.train`` (seed 7),
    the counts zeroed just before: B1 once a local step, B3 once a round
    on EF, no other kernel; the rows read back from the store's disk.
    ``(server, record, captured operands)``."""
    import copy
    from msrflute_tpu_torch.config import FLUTEConfig
    from msrflute_tpu_torch.engine.server import OptimizationServer
    from msrflute_tpu_torch.models import make_task
    cfg = FLUTEConfig.from_dict(copy.deepcopy(raw))
    server = OptimizationServer(make_task(cfg.model_config), cfg, pool,
                                model_dir=os.path.join(work, f"fp_{name}"),
                                device="cuda", seed=7)
    reads = [0]
    pager = server.fleet_pager
    if pager is not None:
        read_file = pager.store._read_file

        def counted(cid):
            row = read_file(cid)
            reads[0] += row is not None
            return row
        pager.store._read_file = counted
    io0 = io_write_bytes()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    with _Operands() as cap:
        server.train()
    server.ckpt.wait()
    torch.cuda.synchronize()
    launches = _read_counts()
    rounds = server.state.round
    steps = server.engine.local_steps
    want = {k: 0 for k in launches}
    want["fused_sgd_apply"] = steps
    want["quant_bin_sparsify"] = rounds if leg == "ef_quant" else 0
    check(steps > 0 and launches == want,
          f"fleet_paged {name}: launches {launches}, want {want}")
    for row in kernel_rows or ():
        row.setdefault("launches_by_path", {})[f"fleet_paged_{name}"] = \
            launches[row["name"]]
    saves, _ = meter.take()
    per_round = server.run_stats["secsPerRound"]
    rec = {"rounds": rounds, "pipelined_chunks": server.pipelined_chunks,
           "secs_per_round": per_round,
           "secs_per_round_after_first": _mean(per_round[1:]),
           "loop_secs_per_round": meter.train_secs / rounds,
           "launches": launches, "local_steps": steps,
           "latest_saves": saves,
           "strategy_state_bytes": sum(
               t.numel() * t.element_size()
               for t in server.state.strategy_state.values()),
           "peak_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
           "disk_write_gb": (io_write_bytes() - io0) / 1e9}
    if pager is not None:
        rec["pager"] = pager.describe()
        rec["store_reads"] = reads[0]
    return server, rec, cap.ops


def _rows_equal(torch, paged, resident):
    """Each client's row in the paged run's store against the resident
    run's tables (a client never seen: the row defaults there):
    ``(clients whose rows differ, the rows read)``."""
    import numpy as np
    pager, tables = paged.fleet_pager, resident.state.strategy_state
    defaults = paged.strategy.carry_row_defaults()
    bad, rows = [], {}
    for u in range(len(paged.train_dataset)):
        row = rows[u] = pager.user_row(u)
        for k in paged.strategy.carry_tables:
            want = tables[k][u]
            got = (torch.full_like(want, defaults[k]) if row is None else
                   torch.from_numpy(np.asarray(row[k])).to(want.device))
            if not torch.equal(got, want):
                bad.append((u, k))
    return bad, rows


def _paged_dispatch_half(torch, server):
    """One round's dispatch half on the paged path: the page-in, the
    round, the writeback's start and the ``latest`` snapshot, under
    :func:`_sync_points`; the writebacks completed after."""
    from msrflute_tpu_torch.data.batching import pack_round_batches
    sampled = server._sample()
    batch = pack_round_batches(
        server.train_dataset, sampled, server.batch_size,
        server._chunk_steps([sampled]), rng=server._np_rng,
        desired_max_samples=server.desired_max_samples)
    state, pager, handles, out = server.state, server.fleet_pager, [], []

    def dispatch():
        pager.prepare_chunk([batch], state.strategy_state)
        new, packed = server.engine.dispatch_rounds(
            state, [batch], [0.1], [1.0], quant_thresholds=[None],
            chaos_vecs=[server.chaos_vectors(state.round, batch)])
        handles.append(pager.queue_writeback(new.strategy_state,
                                             round_no=state.round + 1))
        server.ckpt.snapshot(new)
        out.append(packed)

    torch.cuda.synchronize()
    places = _sync_points(torch, dispatch)
    for h in handles:
        pager.complete_writeback(h)
    stats = [p.fetch()[0]["train_loss_sum"] for p in out]
    check(len(stats) == 2 and stats[0] == stats[1] and
          math.isfinite(stats[0]), f"paged dispatch half: {stats}")
    return places


def _leg_paged(torch, work, pool, kernel_rows, leg, meter, keep):
    """SCAFFOLD or EF resident and paged at the in-flight floor: params,
    ``c`` and every client's row bitwise; each kernel on its captured
    operands; the dispatch half's sync scan.  The resident run's saves
    are counted, not written (the fused_carry phase wrote one of the same
    ``[350, P]`` tables in this call, reported beside them), the paged
    run's all written: the machine allows 45 GiB of writes a command."""
    meter.real_saves = 0
    resident, res_rec, _ = _fp_run(torch, _paged_config(leg), pool, work,
                                   f"{leg}_resident", meter, leg)
    res_rec["fused_carry_written_latest"] = FUSED_FINAL.get(
        leg, {}).get("latest_written")
    meter.real_saves = 10 ** 6
    paged, rec, ops = _fp_run(
        torch, _paged_config(leg, fleet=FLEET_PAGED_FLEET), pool, work,
        leg, meter, leg, kernel_rows)
    pager = paged.fleet_pager
    check(paged.pipelined_chunks > 0 and rec["pager"]["evictions"] > 0 and
          rec["store_reads"] > 0,
          f"fleet_paged {leg}: chunks {paged.pipelined_chunks}, pager "
          f"{rec['pager']}, store reads {rec['store_reads']}")
    whole = _flat_state(resident.state)
    diffs = {"params": _max_abs_diff(torch, paged.state.params,
                                     resident.state.params)}
    if "c" in whole:
        diffs["c"] = _max_abs_diff(torch, paged.state.strategy_state["c"],
                                   whole["c"])
    bad, rows = _rows_equal(torch, paged, resident)
    check(not any(diffs.values()) and not bad,
          f"fleet_paged {leg}: paged != resident, {diffs}, rows {bad[:5]}")
    held = _hold_operands(torch, ops)
    row_bytes = pager.row_bytes()
    rec.update({
        "bitwise_resident": True, "clients": len(paged.train_dataset),
        "kernels_held": held, "pool_slots": pager.n_slots,
        "pool_bytes": pager.n_slots * row_bytes,
        "resident_table_bytes": len(paged.train_dataset) * row_bytes,
        "resident": res_rec, "card": CARD.get("name_power")})
    # the clean run's result, before the dispatch half below trains on
    keep[leg] = {"params": paged.state.params.clone(),
                 "c": whole.get("c"), "rows": rows}
    del resident, whole
    torch.cuda.empty_cache()
    rec["dispatch_sync_points"] = _paged_dispatch_half(torch, paged)
    return rec


def _leg_paged_personalization(torch, work, kernel_rows, meter):
    """``experiments/cv`` (ResNet-18-GN, 100 users) 2 rounds paged at the
    in-flight floor through the CLI: params and the personalized eval
    bitwise fused_carry's resident leg (or, alone, a resident run here);
    B1 twice a local step, held on its captured operands."""
    rounds = FUSED_ROUNDS
    if FUSED_FINAL.get("personalization", {}).get("round") != rounds:
        meter.real_saves = 0
        server, _, _ = _run_cli(work, "fp_personalization_resident",
                                fused_config("personalization", 2), "cuda",
                                task="cv")
        FUSED_FINAL["personalization"] = {
            "round": server.state.round,
            "params": server.state.params.detach().clone(),
            "personalized_val": server.personalized_eval(
                server.val_dataset)}
        del server
        meter.take()
    want = FUSED_FINAL["personalization"]
    raw = _paged_config("personalization", rounds=rounds, fleet={
        "page_pool_slots": FLEET_PAGED_FLEET["page_pool_slots"]})
    # the saves (1.4 GB each at the floor) counted, not written: the
    # machine allows 45 GiB of writes a command
    meter.real_saves = 0
    io0 = io_write_bytes()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    with _Operands() as cap:
        server, _, secs = _run_cli(work, "fp_personalization", raw, "cuda",
                                   task="cv")
    server.ckpt.wait()
    torch.cuda.synchronize()
    launches = _read_counts()
    steps = server.engine.local_steps
    expect = {k: 0 for k in launches}
    expect["fused_sgd_apply"] = steps
    check(steps > 0 and launches == expect and
          server.strategy.client_passes == 2,
          f"fleet_paged personalization: launches {launches}, want "
          f"{expect}")
    for row in kernel_rows:
        row.setdefault("launches_by_path", {})[
            "fleet_paged_personalization"] = launches[row["name"]]
    saves, _ = meter.take()
    disk = (io_write_bytes() - io0) / 1e9
    tic = time.time()
    got = server.personalized_eval(server.val_dataset)
    eval_secs = time.time() - tic
    diff = _max_abs_diff(torch, server.state.params, want["params"])
    check(diff == 0.0 and got == want["personalized_val"],
          f"fleet_paged personalization: params differ by {diff}, eval "
          f"{got} against {want['personalized_val']}")
    held = _hold_operands(torch, cap.ops)
    pager = server.fleet_pager
    rec = {"rounds": rounds, "bitwise_resident": True,
           "personalized_val": {"acc": got[0], "loss": got[1]},
           "personalized_eval_seconds": round(eval_secs, 3),
           "secs_per_round": server.run_stats["secsPerRound"],
           "loop_secs_per_round": meter.train_secs / rounds,
           "launches": launches, "local_steps": steps,
           "kernels_held": held, "pager": pager.describe(),
           "pool_slots": pager.n_slots,
           "pool_bytes": pager.n_slots * pager.row_bytes(),
           "resident_table_bytes": len(server.train_dataset)
           * pager.row_bytes(), "latest_saves": saves,
           "peak_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
           "disk_write_gb": disk, "run_seconds": round(secs, 3),
           "card": CARD.get("name_power")}
    del server
    torch.cuda.empty_cache()
    return rec


def _leg_fleet_scale(torch, work, meter):
    """SCAFFOLD at FEMNIST's 3,400 writers on the default pool, 3 rounds
    at depth 2: the pool's bytes on the card against the ``[3400, P]``
    table it replaces (not allocated)."""
    tic = time.time()
    pool = _image_pool(_femnist_sizes(FLEET_SCALE_WRITERS, 0), 0)
    data_secs = time.time() - tic
    meter.real_saves = 1
    server, rec, _ = _fp_run(
        torch, _paged_config("scaffold", rounds=FLEET_SCALE_ROUNDS,
                             fleet={"enable": True}),
        pool, work, "fleet_scale", meter, "scaffold")
    pager = server.fleet_pager
    check(server.state.round == FLEET_SCALE_ROUNDS and
          bool(torch.isfinite(server.state.params).all()),
          f"fleet_paged fleet_scale: round {server.state.round}")
    rec.update({"writers": FLEET_SCALE_WRITERS,
                "dataset_seconds": round(data_secs, 3),
                "pool_slots": pager.n_slots,
                "pool_bytes": pager.n_slots * pager.row_bytes(),
                "resident_table_bytes_not_allocated":
                    FLEET_SCALE_WRITERS * pager.row_bytes(),
                "card": CARD.get("name_power")})
    del server, pool
    torch.cuda.empty_cache()
    return rec


def _replay_infra(server):
    """The infra counters recomputed on the host from the streams'
    seeds and each surface's draws, and the ``store_io_fault`` records
    they must match."""
    from msrflute_tpu_torch.resilience.chaos import InfraFaults
    infra = server.chaos.infra
    replay = InfraFaults(seed=infra.seed, prefetch_delay_s=0.0,
                         **infra.rates)
    for surface, n in infra._calls.items():
        for _ in range(n):
            if surface == "prefetch_delay":
                replay.prefetch_delay()
            else:
                replay.fault(surface)
    return replay.counters


def _leg_paged_infra(torch, work, pool, meter, clean):
    """The scaffold leg under ``chaos.infra`` on every surface: bitwise
    the clean paged run (``clean``: its params, ``c`` and rows); the
    counters the host replay's, one ``store_io_fault`` record a failed
    attempt.  One ``latest`` written, the others counted."""
    meter.real_saves = 1
    raw = _paged_config("scaffold", fleet=FLEET_PAGED_FLEET,
                        chaos=FLEET_PAGED_INFRA,
                        checkpoint_retry=FLEET_PAGED_RETRY)
    server, rec, _ = _fp_run(torch, raw, pool, work, "infra", meter,
                             "scaffold")
    counters = dict(server.chaos.infra.counters)
    replay = _replay_infra(server)
    records = sum(e["event"] == "store_io_fault"
                  for e in server.metrics.events)
    failed = counters["store_write_faults"] + \
        counters["store_read_faults"] + counters["writeback_faults"]
    diffs = {"params": _max_abs_diff(torch, server.state.params,
                                     clean["params"]),
             "c": _max_abs_diff(torch, server.state.strategy_state["c"],
                                clean["c"])}
    bad = []
    for u in range(len(server.train_dataset)):
        a, b = server.fleet_pager.user_row(u), clean["rows"][u]
        if (a is None) != (b is None) or (
                a is not None and not all((a[k] == b[k]).all()
                                          for k in a)):
            bad.append(u)
    check(not any(diffs.values()) and not bad and counters == replay and
          records == failed and failed > 0,
          f"fleet_paged infra: diffs {diffs}, rows {bad[:5]}, counters "
          f"{counters} against the replay's {replay}, {records} records "
          f"for {failed} failed attempts")
    rec.update({"bitwise_clean": True, "infra_counters": counters,
                "store_io_fault_records": records,
                "calls": dict(server.chaos.infra._calls),
                "prefetch_degradations":
                    server.fleet_pager.prefetch_degradations,
                "card": CARD.get("name_power")})
    del server
    return rec


def phase_fleet_paged(torch, work, kernel_rows):
    """The fleet paged carry on one card through
    ``OptimizationServer.train``, a line a leg (``fleet_paged_<leg>``):
    ``scaffold`` and ``ef_quant`` (each against its resident run),
    ``personalization``, ``fleet_scale`` and ``infra``; then the
    phase's."""
    meter = _CheckpointMeter()
    legs, keep = {}, {}
    tic = time.time()
    try:
        pool = _image_pool(_femnist_sizes(350, 0), 0)
        for leg in ("scaffold", "ef_quant"):
            legs[leg] = _leg_paged(torch, work, pool, kernel_rows, leg,
                                   meter, keep)
            emit({"phase": f"fleet_paged_{leg}", "ok": True, **legs[leg]})
        del keep["ef_quant"]
        torch.cuda.empty_cache()
        legs["infra"] = _leg_paged_infra(torch, work, pool, meter,
                                         keep.pop("scaffold"))
        emit({"phase": "fleet_paged_infra", "ok": True, **legs["infra"]})
        del pool
        torch.cuda.empty_cache()
        legs["personalization"] = _leg_paged_personalization(
            torch, work, kernel_rows, meter)
        emit({"phase": "fleet_paged_personalization", "ok": True,
              **legs["personalization"]})
        legs["fleet_scale"] = _leg_fleet_scale(torch, work, meter)
        emit({"phase": "fleet_paged_fleet_scale", "ok": True,
              **legs["fleet_scale"]})
    finally:
        meter.restore()
    emit({"phase": "fleet_paged", "ok": True, "legs": list(legs),
          "rounds": FLEET_PAGED_ROUNDS, "depth": FLEET_PAGED_DEPTH,
          "pool_slots": FLEET_PAGED_FLEET["page_pool_slots"],
          "seconds": round(time.time() - tic, 3),
          "card": CARD.get("name_power")})


def main() -> int:
    argv = sys.argv[1:]
    if argv not in ([], ["--kernels"]):
        print("usage: chip_smoke.py [--kernels]", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "msrflute_tpu_torch")):
        print("chip_smoke.py: run it from a checkout of the repository "
              "(msrflute_tpu_torch/ not found beside it)", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device; this test needs one NVIDIA GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    phase = "env"
    try:
        phase_env(torch)
        phase = "build"
        phase_build()
        phase = "kernel"
        ef_row = phase_kernel_quant_ef(torch)
        rows = [phase_kernel(torch), phase_kernel_noise(torch),
                phase_kernel_quant(torch), phase_kernel_quant_bert(torch),
                ef_row, *phase_kernel_flash(torch)]
        # the 16-bit storage arms of B1 and B4-B6: rows of their own
        arm_rows = [*phase_kernel16(torch), *phase_kernel_flash16(torch)]
        if argv == ["--kernels"]:
            emit({"kernels": rows + arm_rows})
            return 0
        # the runs that read one blob share one parse
        restore_parse = _install_parse_cache()
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
            phase = "main"
            server = phase_main(torch, work, rows)
            phase = "profile"
            phase_profile(torch, server)
            del server
            phase = "pipeline"
            pipeline = phase_pipeline(torch, work, rows)
            phase = "telemetry"
            phase_telemetry(torch, work, rows, pipeline)
            del pipeline
            phase = "pipeline_profile"
            phase_pipeline_profile(torch, work)
            phase = "cross_device"
            phase_cross_device(torch, work)
            phase = "dga"
            server = phase_dga(torch, work, rows)
            phase = "dga_profile"
            phase_profile(torch, server, phase="dga_profile", client_lr=1.0,
                          server_lr=0.001, quant_threshold=0.7)
            del server
            phase = "dga_learns"
            phase_dga_learns(torch, work)
            phase = "dga_cross_device"
            phase_cross_device_dga(torch, work)
            phase = "ringlm"
            server = phase_ringlm(torch, work, rows)
            phase = "ringlm_profile"
            phase_profile(torch, server, phase="ringlm_profile")
            del server
            phase = "ringlm_flash_vs_dense"
            phase_ringlm_flash_vs_dense(torch, work)
            phase = "ringlm_cross_device"
            phase_cross_device_ringlm(torch, work)
            phase = "ringlm_bf16"
            phase_ringlm16(torch, work, arm_rows)
            phase = "precision"
            phase_precision(torch, work, arm_rows)
            phase = "dtype"
            phase_dtype(torch, work)
            phase = "optimizers"
            phase_optimizers(torch, work)
            phase = "resnet"
            server = phase_resnet(torch, work, rows)
            phase = "resnet_profile"
            phase_profile(torch, server, phase="resnet_profile")
            del server
            phase = "resnet_cross_device"
            phase_cross_device_fedavg_path(torch, work, "resnet",
                                      "cv_resnet_fedcifar100", "fedcifar100",
                                      20)
            phase = "shakespeare"
            server = phase_shakespeare(torch, work, rows)
            phase = "shakespeare_profile"
            # one round each way: tracing the LSTM's 30,000 launches a
            # round takes the profiler about 45 s a round
            phase_profile(torch, server, rounds=1,
                          phase="shakespeare_profile", client_lr=0.8)
            del server
            phase = "shakespeare_cross_device"
            phase_cross_device_fedavg_path(torch, work, "shakespeare",
                                      "nlp_rnn_fedshakespeare", "shakespeare",
                                      4)
            phase = "hello_mlp"
            phase_hello_mlp(torch, work, rows)
            phase = "personalization"
            server = phase_personalization(torch, work, rows)
            phase = "personalization_profile"
            phase_personalization_profile(torch, server, rounds=1)
            del server
            phase = "cross_device_personalization"
            phase_cross_device_personalization(torch, work)
            phase = "fedlabels"
            phase_fedlabels(torch, work, rows)
            phase = "cross_device_fedlabels"
            phase_cross_device_fedlabels(torch, work)
            phase = "ecg"
            phase_ecg(torch, work, rows)
            phase = "ecg_cross_device"
            phase_cross_device_shipped(torch, work, "ecg", "ecg_cnn", "ecg",
                                       32)
            phase = "fednewsrec"
            phase_fednewsrec(torch, work, rows)
            phase = "fednewsrec_cross_device"
            phase_cross_device_shipped(torch, work, "fednewsrec",
                                       "fednewsrec", "mind", 16)
            phase = "mlm_bert"
            server = phase_mlm_bert(torch, work, rows)
            phase = "mlm_bert_profile"
            # one round each way: its 2.2 s rounds trace slowly
            phase_profile(torch, server, rounds=1, phase="mlm_bert_profile",
                          client_lr=5e-5, server_lr=5e-5,
                          quant_threshold=0.7)
            del server
            phase = "mlm_bert_learns"
            phase_mlm_bert_learns(torch, work)
            phase = "mlm_bert_cross_device"
            phase_cross_device_mlm_bert(torch, work)
            phase = "strategies"
            phase_strategies(torch, work, rows, ef_row)
            phase = "strategies_cross_device"
            phase_cross_device_strategies(torch, work)
            phase = "rl"
            phase_rl(torch, work, rows)
            phase = "classif_cnn"
            phase_classif_cnn(torch, work, rows)
            phase = "defense"
            phase_defense(torch, work, rows)
            phase = "defense_cross_device"
            phase_cross_device_defense(torch, work)
            phase = "fused_carry"
            phase_fused_carry(torch, work, rows)
            phase = "resilience"
            phase_resilience(torch, work, rows)
            phase = "model_options"
            phase_model_options(torch, work, rows)
            phase = "throughput"
            phase_throughput(torch, work, rows)
            phase = "data_planes"
            phase_data_planes(torch, work, rows)
            phase = "fleet_traffic"
            phase_fleet_traffic(torch, work, rows)
            phase = "fleet_paged"
            phase_fleet_paged(torch, work, rows)
        restore_parse()
    except Exception as exc:  # report the failing phase, then fail
        emit({"phase": phase, "ok": False,
              "error": f"{type(exc).__name__}: {exc}"})
        import traceback
        traceback.print_exc()
        return 1
    # every 16-bit arm ran on a path of this run
    missing = [r["name"] for r in arm_rows if not r.get("launches")]
    if missing:
        emit({"phase": "arms", "ok": False,
              "error": f"no path launched {missing}"})
        return 1
    emit({"kernels": rows + arm_rows})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
