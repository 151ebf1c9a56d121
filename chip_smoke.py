#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (taiyaki_tpu_torch) on one NVIDIA
card; run from the root of a checkout:

    python3 chip_smoke.py [--seed N]

1. Card: name and power limit; builds the CUDA kernels from csrc/ and
   the host decoders (g++, taiyaki_tpu_torch/decodeutil/).
2. Kernels: each against its plain PyTorch twin on the card, with its time
   (CUDA events), the twin's time, one PyTorch call computing the same
   function where there is one, and its bound.  The logZ forward and
   posteriors (T cut into segments) also at the training shape; the CRF
   forward prints its layout (threads, positions a thread, CTAs a row) at
   each width, and it and the CRF backward (its posteriors formed off the
   chain) must give bitwise the same lattice and d lp on two runs.
   Basecall kernels at the
   basecall path's shapes (T=1000 blocks, B=128 chunks, H=256, S=40; the
   GRU forward also at H=96, the shipped remap model's width); LSTM and
   CRF training kernels at the mLstm training shape (T=800 blocks, B=256
   chunks, H=D=256, L=512 lattice positions, S=40); the CRF again at
   L=3712 (T=4000, above the mGru default chunk range's bound of 3637);
   the GRU forward and recomputing backward at the mGru training shape
   (T=2000, B=256, H=D=256), both directions.  Beside each default
   backward, on the same inputs, the backwards of the JAX trainer's other
   residual policies: the LSTM's from stored pre (kernel 11) and
   rebuilding pre (kernel 12), the GRU's from stored gate streams (kernel
   13), with the forward modes that feed them.  The forward recurrences
   (kernels 1, 7, 14, 16) run on the plan of ops/rnn_plan.py, the cluster
   instance at every width the repo uses: each check prints the
   plan (C, BT, RB, KS, SMs busy, the card's clusters a wave) and times
   the forced L2 instance beside it on the same inputs (within 1e-4 of
   it); the L2 instance, still the plan's at H=512, is held against its
   twins there.  The LSTM forward with emit="acts" also at the trainer
   defaults' shapes (H=D=384; 341 chunks x T=600, three waves of clusters
   of 16, and 128 x T=1600), both directions, against its twin and the L2
   instance, timed beside both and cuDNN.  The backward chains (kernels
   4, 8, 11-13, 15, 17; slice 8) run on the backward plan of ops/
   rnn_plan.py (`bwd_plan`), their cluster instance at every width the
   repo uses: each backward row is held against its twin and the forced
   L2 instance of its chain (1e-4 relative), timed beside both and
   cuDNN's backward, at the training shapes, at the trainer defaults'
   batches (H=D=384: 341 x T=150 and 128 x 400, a quarter of their
   chunks' T) and at H=D=96 (T=250, B=256); at H=512 the LSTM's chain
   takes the L2 instance and the GRU's
   a cluster of 16, each against its twins, each counted by instance.
3. mLstm_flipflop 256/5/19, as in the earlier slices:
   a. training path: `taiyaki_tpu_torch.cli.train_flipflop` on the
      repo's mapped reads (RESULTS/training_ingredients/
      mapped_remap_samref.hdf5), chunk 4000, 256 chunks per batch, 8
      iterations: every loss finite, checkpoints written, every kernel of
      the path launched;
   b. card against CPU: one training step (loss and every gradient) on
      the same batch and seeded weights at full width, 8 chunks;
   c. basecall path: the trained checkpoint of (a) calls synthetic fast5
      reads (8 x 100k samples and one read shorter than a chunk) through
      `taiyaki_tpu_torch.cli.basecall` with its defaults, fasta and
      fastq.  Two reads are called again on the CPU: the calls must be
      equal, or, where a Viterbi tie flips a base, the card's path must
      score the CPU's best score within 1e-4 under the CPU's scores;
   d. profiles: stage wall times and device time by kernel of one
      basecall batch and of one training step (torch.profiler).
4. mGru_flipflop 256/2/19 (this slice), the same phases: (a) training,
   chunk 4000 (T=2000 blocks), 256 chunks, 8 iterations; (b) card
   against CPU, 8 chunks; (c) basecalling synthetic reads with a seeded
   checkpoint at size 256 (a briefly trained one calls few bases), and
   the three real reads of the mapped reads, written as fast5, with the
   shipped remap checkpoint (taiyaki_tpu/models/mGru_flipflop_remapping_
   model_r9_DNA.checkpoint): every read gets a record, the card's calls
   equal the CPU's (or the tie rule of 3c), and each call's semi-global
   identity against the read's reference is at least 0.80; (d) profiles.
5. Residual policies: the training path again under each switch of the
   JAX trainer (TAIYAKI_TPU_ACTS_BWD=0 and TAIYAKI_TPU_RECOMPUTE=1 for
   mLstm, TAIYAKI_TPU_NO_RECOMPUTE=1 for mGru; 4 iterations each): its
   backward kernel launched, the default backward not; the card-vs-CPU
   step under each switch, whose card gradients must also equal the
   default policy's on the card; and for all five policy/model pairs a
   full training step's time and peak device memory, and one layer's
   forward and backward time.
6. mLstm_cat_mod_flipflop 256/5/19 (this slice) on the repo's mapped
   reads with modified bases (RESULTS/training_ingredients/
   mapped_remap_modref.hdf5, alphabet AYCZGT, 46 output columns):
   kernels 9-10 (the CRF on score streams: the forward, and the backward's
   two entries, the posteriors and the route's d lp, crf_grad_streams)
   against their twins at the training shape (T=800, B=256, L=512, and
   L=640, the training step's width, and L=509, not a multiple of 4),
   posteriors and d lp bitwise equal from run to run; the fused kernels
   5-6 at the cat_mod width, with the gradient's canonical and mod
   columns reported apart and the streams route's d lp held against the
   same twin; a lattice past the fused kernels' 8192 positions (T=10000,
   B=8, L=9000) through the cat_mod loss, which takes the streams route
   with no switch, and kernels 9-10 against their twins there; (a)
   training, 8 iterations by default (kernels 5-6 with the mod column
   folded in, 9-10 idle) and 4 under TAIYAKI_TPU_NO_SCORE_FUSE=1 (9-10
   launched, 5-6 idle, no scatter_add_), whose losses equal the default's;
   (b) card against CPU, one 8-chunk step on each
   route; (c) --modified_base_output basecalling of the trained
   checkpoint, and of a seeded one that calls bases with a mod, on the
   three modref reads, written as fast5, on the card and the CPU: one mod
   row per called base, equal calls (or the tie rule of 3c), equal mod
   scores where the calls agree; (d) one synchronised training step and
   its peak device memory on each route.
7. The recurrences on given gates (this slice): kernels 14-17 (the
   LSTM and GRU recurrences and gradient chains of ops/rnn.py's
   `lstm_scan` and `gru_scan`) against their twins at the mLstm (T=800)
   and mGru (T=2000) training shapes, B=256, H=256, both directions, the
   backwards also with iW (d_x, D=256); then the scan path: both ops
   forward and backward through torch.autograd.grad, both directions,
   and on the same inputs scan(x . iW^T + b) against the whole layer
   (kernels 1 and 4, 7 and 8): h, d gates_x . iW against d_x, d_sW.
8. The JAX trainer's own defaults (this slice): the training CLI at
   --size 384 with chunks of 3000-8000 samples in 8 buckets and
   sub-batches of 341 ... 128 chunks, 4 iterations; a step's time and
   peak memory at 341 chunks x 3000 samples and at 128 x 8000; a
   card-against-CPU step on 5 chunks of 3000 samples at size 384.  And
   a lattice of 20000 positions (T=20100, B=1) through the cat_mod loss
   and kernels 9-10 against their twins there: their chains in a cluster
   of 8 CTAs a row.
9. The two GEMMs under the layers (ops/gemm.py): each product
   at the layers' shapes (GEMM_CASES: gx, d_x and d_iW/d_sW of the mLstm
   and mGru training steps and of the trainer defaults' 341 x 600 batch,
   the basecall batch's gx, the remap model's width H=96) on its plan's
   tc instance (3xTF32 on the tensor cores) and on the forced simt
   instance, each within 1e-5 of the largest output of its twin
   (torch.matmul on the card, TF32 off), with its largest error against
   an f64 product, timed beside the twin (also its library call); every
   training and basecall path must have run all its GEMMs on the tc
   instance (counted by instance, as the recurrences are).
10. Offset views: every input of the layers' forwards and backwards, of
   the logZ forward and posteriors, of the CRF forward and backward and
   of kernels 9-10 as a contiguous view at an odd float offset (4-byte
   aligned, not 16), each against the aligned call on the same values.
11. The remaining layers, the beam and the JSON export: every layer of
   layers.py that no other phase runs, at width 256 (T=800, B=8), forward
   and backward on the card against the CPU (1e-4; gradients 1e-4 of
   their largest), CudnnGru (a loop of PyTorch ops) also at H=256,
   T=1000, B=128 against torch.nn.GRU on the same weights, both timed; a
   network of every layer but TimeLinear (ALL_LAYERS_SOURCE, size 256)
   through one training step on the card against the CPU, then an AdamW
   step; basecall --beam 5 1 with the 3c checkpoint on its synthetic reads
   (ksample/s beside the Viterbi run's, the beam's share of a batch) and
   --beam 5 1 --fastq on the three real reads with the shipped remap
   checkpoint (identities at least 0.80, calls equal to the CPU's or beam
   scores within 1e-4 of them); cli.dump_json of the trained mLstm
   checkpoint of 3a, the every-layer network's and the remap checkpoint:
   each parameter equal to the state_dict (GRU gates reordered).
12. Training-data preparation (this slice): the three real reads,
   each written 31 more times under new read ids, and one long read (the
   longest, 34 188 samples, with its reference tiled 4x): 97 reads, 2.7 M
   samples as fast5 (hdf5.Writer), their references as fasta and their
   rows of RESULTS/training_ingredients/readparams.tsv.
   `taiyaki_tpu_torch.cli.prepare_mapped_reads` remaps them on the card
   with the shipped remap checkpoint (batches of 8 reads of one padded
   length) in both layouts, and the port's reader reads the files back:
   check() passes, 97 reads, Dacs and Reference as written, the mean
   dwell of a middle 1000-sample chunk of every read in (5, 20), no read
   tallied as failed, the GRU forward (cluster instance) and the tc gate
   GEMM launched.  The same CLI with --device cpu (one read a forward)
   on the three originals: each Ref_to_signal within the near-tie rule
   of tests/test_misc_cli.py (under 1% of entries moved, none by more
   than 32 samples) of the card's, as is every copy's of its original's.
   The long read alone, and the trained mLstm checkpoint of 3a (size
   256: the LSTM forward launched, check() passes).  Prints reads/s,
   ksample/s, the forwards' time against the host's stage and finish
   (Viterbi remap) time, the long read's, and peak device memory.  Rows
   7 and 1 also alone at the remap path's largest batches of the real
   reads (B=8, T=8704 at H=96; T=6964 at H=256) against their twins,
   timed beside the twin and cuDNN.
13. The squiggle predictor, ab-initio training and --remat (this slice),
   on phase 12's files: (a) `taiyaki_tpu_torch.cli.train_squiggle` at
   its defaults (size 32, depth 4, winlen 9, target_len 300, batch 100,
   back_prob 1e-15) for 4 iterations on phase 12's 97-read mapped file:
   losses finite; the squiggle-match cost (ops/squiggle.py, plain
   PyTorch, no kernel of its own) of a batch of that shape on the trained
   net's squiggles, card against the CPU (costs 1e-5 relative, the
   gradient 1e-4 of its largest); its seconds a step, kernel launches a
   step (torch.profiler), padded signal length and peak device memory;
   (b) `cli.predict_squiggle` of the three real references with that
   checkpoint, card against CPU, every number within 1e-5; (c)
   `cli.map_to_squiggle` of the three real reads (phase 12's fast5)
   against their references (RESULTS/training_ingredients/
   per_read_references_from_sam.fa), card against CPU: scores within
   1e-4 relative, paths equal or within the near-tie rule of phase 12;
   (d) `cli.train_abinitio` at its defaults (mGru_flipflop 96/2/19,
   batch 128) for 4 iterations on 256 chunks of 4000 samples cut from
   phase 12's mapped file by the port's chunk sampler (a "chunks"
   dataset written by hdf5.Writer, the sequences as an index-named
   fasta): losses finite, the GRU forward and recomputing backward (on
   their cluster instances), the CRF and logZ kernels launched; the first
   step's loss on its first 8 chunks, card against CPU, within 1e-4
   relative; (e) `cli.train_flipflop` on mLstm at phase 3's shape with
   --remat and without, 2 iterations each, one seed: losses and every
   parameter after each step within 1e-5 relative, the LSTM forward
   launched again in each layer's rerun; a step's time and peak device
   memory with and without (plain, remat, remat, plain).
14. The host tools (this slice), after phase 4's real reads and phase
   12's files: (a) the shipped remap checkpoint through `cli.dump_json`,
   `cli.json_to_checkpoint` and `cli.upgrade_model`, every parameter
   bitwise the shipped one's, then `cli.basecall` of the result with its
   defaults on the three real reads: rows 7, 2 and 3 launched, the calls
   equal to phase 4's; (b) `cli.align` of those calls against the three
   references (the built-in aligner, `decodeutil.seq_align`, where no bwa
   is installed) and the assessment, with no plot where matplotlib is
   absent: each read aligned to its own reference on +, its accuracy
   printed beside the semi-global identity, which must be at least 0.80;
   (c) the mapped-signal tools through data/hdf5.py where h5py is absent:
   `cli.synth_dataset` (8 + 3 reads of 600 bases), the check of its
   train.hdf5 and of phase 12's 97-read file, their merge (the read count
   the sum) and its check, and the alphabet tool's inspection of it.
15. Multi-card training and sharded basecalling on the one card, and the
   analysis tools (this slice): (a) the data-parallel step of mLstm at
   phase 3's shape in two ranks (processes of their own on card 0, gloo),
   128 chunks each, rank 1's share padded by `_pad_batch`, against one
   process's step on the 256: the losses of two steps 1e-5 relative,
   every parameter after them 1e-5 of its tensor's largest, the replicas
   bitwise alike, rows 1-6 launched in each rank, a step's ms beside one
   rank's; (b) `cli.train_flipflop --multihost` in a job of one rank
   (NCCL), 3 iterations: batch.log byte for byte the plain run's; (c)
   phase 3's basecall through `Basecaller` on [card 0, card 0]: calls
   equal phase 3's under the near-tie rule, a batch's ms on one device and
   two, and `--ndevices 2` exiting with the JAX CLI's message; (d) with
   no matplotlib, `cli.split_strandlist` and `cli.check_hdf5_contents` on
   phase 12's file, `cli.motif` on the three references, and
   `cli.calibrate_qscores_byread` on a --fastq call of phase 4's real
   reads aligned by `cli.align` (its slope and shift, or its reason).
16. The bf16 streams of the LSTM layers (TAIYAKI_TPU_BF16_STREAMS=1,
   ops/rnn.py): (a) the bf16 instances of
   rows 1 (each emit mode), 4, 11 and 12 at the mLstm training shape (the
   cluster instances) and at H=512 (the L2 ones), both directions,
   against their twins (bf16 outputs equal as bf16 but for at most 1% of
   them one bf16 step apart; f32 outputs at the f32 rows' tolerances),
   each row's ms beside the f32 row's; (b) the tc GEMMs with the bf16
   operands the layers give them (x, h, and d_x's bf16 output) against
   their twins (GEMM_TOL), timed beside the same product in f32; (c) the
   full-width mLstm step under the switch (the CRF and logZ kept f32)
   against the f32 step on the same batch and weights under each
   residual policy (loss 5e-3 relative, gradients 2e-2 of each one's
   largest), the step's ms (median of 3) and peak memory beside the f32
   step's; (d) `cli.train_flipflop`
   under the switch (4 iterations; rows 1 and 4 as bf16 launches, and
   rows 2, 3, 5 and 6 since phase 18's slice), then `cli.basecall` from
   its checkpoint with the switch exported, which the CLI's opt-out keeps
   f32.
17. The bf16 streams of the GRU layers (this slice): (a) the bf16
   instances of rows 7 (both emit modes), 8 and 13 at the mGru training
   shape (T=2000, B=256, H=D=256; x, h and dh as a later layer's, the
   first layer's and under TAIYAKI_TPU_F32_GATES=1) and at
   train_abinitio's (B=128, H=D=96; the first two), both directions, on
   the cluster instances, against their twins on phase 16a's terms, each
   row's ms beside the f32 row's, counted by instance; (b) the
   full-width mGru step under the switch (the CRF and logZ kept f32)
   against the f32 step under each residual policy (16c's terms), each
   policy's step ms (median of 3) and peak memory beside the f32 step's; (c) `cli.train_flipflop` on mGru
   under the switch (4 iterations; rows 7 and 8 as bf16 launches),
   `cli.train_abinitio` at its defaults under the switch with each GRU
   policy (rows 7 and 8, or 7 and 13; both with rows 2, 3, 5 and 6's),
   and `cli.basecall` from the trained checkpoint with the switch
   exported (no bf16 launch).
18. The bf16 score streams of the CRF's fused route and logZ (this
   slice; the same switch): (a) the bf16 instances of rows 2, 3, 5 and 6
   at the mLstm training shape (T=800, B=256, L=512, S=40), at the
   cat_mod width (S=46; the CRF alone) and on the widest fused lattice
   (T=4000, B=64, L=3712) against their twins, which round where the
   kernels round (bf16 lattices and logZ's posteriors equal as bf16 but
   for at most 1% one step apart; logZ and the CRF score at the f32 rows'
   tolerances; d lp within a bf16 step of a posterior, past the f32 row's
   atol at most 1% of it), each row's ms beside its f32 instance's on the
   same inputs; (b) the full-width mLstm and cat_mod steps under the
   switch against their f32 steps (16c's terms), each step's ms (median
   of 3) and peak memory: f32, under the switch, and under the switch
   with the CRF and logZ kept f32 (the previous slice's step); (c)
   `cli.train_flipflop` on mLstm and on cat_mod under the switch (4
   iterations each; rows 2, 3, 5 and 6 as bf16 launches), then
   `cli.basecall` from the mLstm checkpoint with the switch exported (no
   bf16 CRF or logZ launch).
19. The scans' mixed precision (this slice; the same switch): (a) the
   bf16 instances of rows 14-17 (h f32; c and pre, or gh, bf16; the
   gradient streams bf16 from a bf16 dh) at phase 7's shapes, gx bf16 and
   f32 (TAIYAKI_TPU_F32_GATES), and at H=512 (T=200, B=64: the L2
   instances but the GRU's chain), both directions, against their twins
   (h 1e-4 relative, bf16 outputs as phase 16a's), counted by instance,
   each row's ms beside the f32 row's with its bound and cuDNN's; (b)
   `lstm_scan` and `gru_scan` under the switch through
   torch.autograd.grad, both directions: every scan launch the bf16
   instance, d_sW on the atb GEMM's bf16 instance; h, d gates_x and d_sW
   against the f32 scans within 2e-2 of each one's largest, and the peak
   memory of each.
20. The score-stream route's bf16 instances (this slice; the same
   switch with TAIYAKI_TPU_NO_SCORE_FUSE=1 or TAIYAKI_TPU_F32_SCORES=1):
   (a) rows 9 and 10 on bf16 streams and on f32 streams, each with a
   bf16 lattice and bf16 posteriors, at the training shape, at S=46, at
   L=9000 and L=20000 (clusters of 4 and 8 CTAs, T cut to 2600-2700) and
   past 32768 positions (T=600), against their twins on phase 18a's
   terms, and logZ's mixed instance (rows 2-3: f32 scores, a bf16 lattice
   and posteriors) at the training shape; each timed beside its f32
   instance and counted; (b) the mLstm and cat_mod steps on the streams
   route under the switch with each score switch against the f32 step
   (16c's terms), each row's instances launched, the cat_mod step's ms
   and peak memory; (c) `cli.basecall` of phase 3's reads with the switch
   exported (make_trans on logZ's mixed instance), its calls against
   phase 3's and each chunk's path against the f32 one within the bf16
   envelope.
21. A `gemms` JSON line (one row a product and shape), a `kernels` JSON
   line (17 rows and the 21 bf16 and mixed instances'; each with its launches on
   phase 13's training paths, phase 14's round-trip basecall and phase
   15's paths, `launches_on`), the card line, and the result line
   {"ok": true, "device": {...}}.

Each phase prints its seconds on a line of its own ("phase N: s").

Every kernel counter is set to 0 just before each path and read just
after; the recurrences (the forwards and the backward chains) also count
their cluster instance's launches, which on every path must be all of
them, and the GEMMs their tc instance's, likewise.  Exits non-zero, printing no result line, if there is no card or
any phase fails.  Imports nothing of JAX.
"""

import argparse
import contextlib
import json
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

# Published peaks of one H100 SXM (dense): f32 outside the tensor cores,
# TF32 and bf16 on them, and device-memory bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
# the least time a flop of an exact product with one bf16 operand (the
# other f32) takes on the tensor cores: the cheaper of two TF32 passes (the
# bf16 operand has no small part) and three bf16 passes (the f32 operand
# split into three bf16 parts)
MIXED_S_PER_FLOP = min(2 / PEAK_TF32_FLOPS, 3 / PEAK_BF16_FLOPS)
T, B, H, NBASE = 1000, 128, 256, 4
# production training shape (misc/rnn_roofline.py, misc/crf_fusion_probe.py)
TT, TB, TL, S = 800, 256, 512, 40
# the backward rows at the shipped remap model's width: T of that check
# (and of the GEMM cases at that width)
BWD96_T = 1000
# phase 2's backward rows at other shapes (check_bwd_shapes) run T / 4 of
# the trainer defaults' chunks and of BWD96_T: their plans, checks and
# tolerances depend on B and H alone, and their twins' time on T
BWD_T_DIV = 4
# the lattice width of the mLstm training steps' batch of 256 chunks x
# 4000 samples (their log lines give it), another kernel 9-10 instance
TRAIN_L = 640
# samples per training chunk, and the mGru training shape (bench.py's mGru
# cell: chunk 4000 at stride 2)
CHUNK = 4000
GT = 2000
# a lattice above the mGru default chunk range's bound, ceil(8000 / 2.2)
# = 3637 positions, padded to a multiple of 128
LT, LB, LL = 4000, 64, 3712
ROOT = os.path.dirname(os.path.abspath(__file__))
READS_HDF5 = os.path.join(ROOT, "RESULTS", "training_ingredients",
                          "mapped_remap_samref.hdf5")
MODREF_HDF5 = os.path.join(ROOT, "RESULTS", "training_ingredients",
                           "mapped_remap_modref.hdf5")
REMAP_MODEL = os.path.join(ROOT, "taiyaki_tpu", "models",
                           "mGru_flipflop_remapping_model_r9_DNA.checkpoint")
# the two model files of the port's paths: (name, file, stride)
MLSTM = ("mLstm_flipflop", os.path.join(
    ROOT, "taiyaki_tpu_torch", "models", "mLstm_flipflop.py"), 5)
MGRU = ("mGru_flipflop", os.path.join(
    ROOT, "taiyaki_tpu_torch", "models", "mGru_flipflop.py"), 2)
MLSTM_CATMOD = ("mLstm_cat_mod_flipflop", os.path.join(
    ROOT, "taiyaki_tpu_torch", "models", "mLstm_cat_mod_flipflop.py"), 5)
# the cat_mod loss's two routes: the fused kernels 5-6 (default) and the
# score streams with kernels 9-10 (the JAX trainer's switch)
STREAMS = ("streams", {"TAIYAKI_TPU_NO_SCORE_FUSE": "1"})
CATMOD_ROUTES = (("fused", {}), STREAMS)
# output columns of a cat_mod head on the modref alphabet (4 canonical
# bases, 2 mods): 40 transitions + 4 + 2
SC = 46
# a lattice past the fused kernels' 8192 positions, T >= L so that every
# row has a path; and one past kernels 9-10's 16384 positions in shared
# memory (their device-memory instance)
XT, XB, XL = 10000, 8, 9000
YT, YB, YL = 20100, 1, 20000
# the JAX trainer's defaults (bin/_bin_argparse.py:20, :112-116;
# taiyaki_tpu/train.py:174-177): size 384, chunks of 3000-8000 samples in
# 8 buckets, sub-batches of int(128 * 8000 / chunk + 0.5) chunks (341 at
# 3000 samples, 128 at 8000)
DSIZE, DMIN, DMAX, DSUB = 384, 3000, 8000, 128
# the residual policies of each cell (the JAX trainer's switches), the
# default first: (name, switches)
LSTM_POLICIES = (("acts", {}), ("pre", {"TAIYAKI_TPU_ACTS_BWD": "0"}),
                 ("recompute", {"TAIYAKI_TPU_RECOMPUTE": "1"}))
GRU_POLICIES = (("recompute", {}), ("stored",
                                    {"TAIYAKI_TPU_NO_RECOMPUTE": "1"}))


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def is_cat_mod(model):
    return "cat_mod" in model[0]


def reads_of(model):
    """The mapped reads a model trains on: with mod labels for cat_mod."""
    return MODREF_HDF5 if is_cat_mod(model) else READS_HDF5


def say(msg):
    print(msg, flush=True)


class Phases:
    """The seconds of each phase, each printed on a line of its own when
    the next one starts (`next`, or `next(None)` after the last)."""

    def __init__(self):
        self.name, self.t0 = None, None

    def next(self, name):
        if self.name is not None:
            say("phase {}: {:.1f} s".format(self.name,
                                             time.time() - self.t0))
        self.name, self.t0 = name, time.time()


def cuda_ms(torch, fn, reps, warmup=1):
    """Mean device time of fn() over `reps` calls, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_diff(a, b):
    """max |a - b|, counting equal infinities as no difference."""
    d = (a - b).abs()
    return d.masked_fill(a == b, 0.0).max().item()


def bound_ms(nbytes, flops, tc_flops=0, mixed_flops=0):
    """The least time for `nbytes` moved and `flops` f32 operations at the
    SIMT rate, plus `tc_flops` of GEMMs on the tc instance (3xTF32: three
    TF32 passes at the tensor cores' rate) and `mixed_flops` of exact
    products with one bf16 operand (MIXED_S_PER_FLOP): (ms, "bytes" or
    "operations")."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = (flops / PEAK_F32_FLOPS + 3 * tc_flops / PEAK_TF32_FLOPS
             + mixed_flops * MIXED_S_PER_FLOP) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def plan_of(cell, H, B, backward=False):
    """The forward recurrence's plan at (H, B) (ops/rnn_plan.py, on the
    clusters a wave this card reports), or with `backward` the backward
    chain's, and a line for the log: the instance, C, BT, RB, KS (KL for
    a backward), the SMs it keeps busy and the card's clusters a wave of
    each size."""
    import torch
    from taiyaki_tpu_torch.ops import gru, lstm, rnn_plan
    gates = 4 if cell == "lstm" else 3
    per_wave = (lstm if gates == 4 else gru).clusters_per_wave(
        torch.cuda.current_device())
    plan = (rnn_plan.bwd_plan if backward else rnn_plan.rec_plan)(
        gates, H, B, per_wave)
    line = "{}; clusters a wave of {} ranks: {}".format(
        rnn_plan.describe(plan, H, B, per_wave, backward),
        rnn_plan.CLUSTER_SIZES, per_wave)
    return plan, line


def against_l2(torch, fwd, reps, *args, **kw):
    """The forward `fwd` on the forced L2 instance, beside the plan's
    instance on the same inputs: (max |cluster - l2| over the outputs,
    the L2 instance's time in ms)."""
    got = fwd(*args, **kw)
    l2 = fwd(*args, instance="l2", **kw)
    torch.cuda.synchronize()
    got, l2 = ((got, l2) if isinstance(got, tuple) else ((got,), (l2,)))
    diff = max(max_abs_diff(g, w) for g, w in zip(got, l2))
    check(diff <= 1e-4, "{}: cluster against L2 instance {} > 1e-4".format(
        fwd.__name__, diff))
    del got, l2
    return diff, cuda_ms(torch, lambda: fwd(*args, instance="l2", **kw),
                         reps=reps)


def bwd_against_l2(torch, bwd, reps, *args, **kw):
    """The backward `bwd` on the forced L2 instance of its chain, beside
    the plan's instance on the same inputs: (max relative difference over
    the outputs, weight-gradient partials summed; the L2 instance's time
    in ms over `reps` calls, None for 0)."""
    got = bwd(*args, **kw)
    l2 = bwd(*args, instance="l2", **kw)
    torch.cuda.synchronize()
    diff = _bwd_diff(torch, bwd.__name__, got, l2)
    check(diff <= 1e-4, "{}: cluster against L2 instance {} > 1e-4 "
          "(relative)".format(bwd.__name__, diff))
    del got, l2
    return diff, (cuda_ms(torch, lambda: bwd(*args, instance="l2", **kw),
                          reps=reps) if reps else None)


# -- phase 2 -----------------------------------------------------------------

def check_lstm(torch, dev, rng):
    from taiyaki_tpu_torch.ops import lstm
    D = H
    x = torch.from_numpy(rng.normal(size=(T, B, D)).astype(np.float32)).to(dev)
    iW = torch.from_numpy((rng.normal(size=(4 * H, D)) / np.sqrt(D))
                          .astype(np.float32)).to(dev)
    b = torch.from_numpy((0.5 * rng.normal(size=4 * H)).astype(np.float32)
                         ).to(dev)
    sW = torch.from_numpy((rng.normal(size=(4 * H, H)) / np.sqrt(H))
                          .astype(np.float32)).to(dev)
    err, ms, plain_ms = 0.0, {}, {}
    for reverse in (False, True):
        got = lstm.lstm_fwd(x, iW, b, sW, reverse=reverse)
        want = lstm.lstm_fwd_plain(x, iW, b, sW, reverse=reverse)
        torch.cuda.synchronize()
        check(got.shape == want.shape and bool(torch.isfinite(got).all()),
              "lstm_fwd: bad output")
        err = max(err, max_abs_diff(got, want))
        ms[reverse] = cuda_ms(torch, lambda: lstm.lstm_fwd(
            x, iW, b, sW, reverse=reverse), reps=5)
        plain_ms[reverse] = cuda_ms(torch, lambda: lstm.lstm_fwd_plain(
            x, iW, b, sW, reverse=reverse), reps=1, warmup=0)
    tol = 1e-4
    check(err <= tol, "lstm_fwd: max |err| {} > {}".format(err, tol))
    ref = torch.nn.LSTM(D, H).to(dev)
    with torch.no_grad():
        ref.weight_ih_l0.copy_(iW)
        ref.weight_hh_l0.copy_(sW)
        ref.bias_ih_l0.copy_(b)
        ref.bias_hh_l0.zero_()
        lib_h = ref(x)[0]
        lib_err = (lib_h - lstm.lstm_fwd(x, iW, b, sW)).abs().max().item()
        library_ms = cuda_ms(torch, lambda: ref(x), reps=5)
    nbytes = 4 * (T * B * D + 4 * H * D + 4 * H + 4 * H * H + T * B * H)
    # the recurrence's product at the f32 rate, the input GEMM on the tc
    # instance
    bound, by = bound_ms(nbytes, 2 * T * B * 4 * H * H,
                         2 * T * B * 4 * H * D)
    l2_diff, l2_ms = against_l2(torch, lstm.lstm_fwd, 2, x, iW, b, sW)
    _, plan = plan_of("lstm", H, B)
    say("lstm_fwd   T={} B={} D=H={}: max|err| {:.3g} (tol {}), kernel "
        "{:.3f} ms fwd / {:.3f} ms reverse, plain {:.3f} / {:.3f} ms, "
        "torch.nn.LSTM {:.3f} ms (|diff| {:.3g}), bound {:.3f} ms ({}); "
        "serial floor: {} dependent steps; plan {}; forced L2 instance "
        "{:.3f} ms (|diff| {:.3g})".format(
            T, B, H, err, tol, ms[False], ms[True], plain_ms[False],
            plain_ms[True], library_ms, lib_err, bound, by, T, plan, l2_ms,
            l2_diff))
    return dict(name="lstm_fwd", route="cuda",
                source="taiyaki_tpu_torch/csrc/lstm.cu",
                replaces="taiyaki_tpu/ops/pallas_rnn.py:880",
                max_abs_err=err, ms=ms[False],
                plain_ms=plain_ms[False], bound_ms=bound, bound_by=by,
                library_ms=library_ms, l2_ms=l2_ms, l2_diff=l2_diff,
                plan=plan)


def _logz_case(torch, dev, rng, t, b):
    """logZ forward and posteriors at T=t, B=b against their twins, timed:
    (logZ err, its tol, lattice err, posterior err, fwd ms, fwd plain ms,
    post ms, post plain ms, fwd bound, post bound)."""
    from taiyaki_tpu_torch.ops import logz
    S = 2 * NBASE * (NBASE + 1)
    nff = 2 * NBASE
    s = torch.from_numpy((5.0 * np.tanh(rng.normal(size=(t, b, S))))
                         .astype(np.float32)).to(dev)
    f1, z1, l1 = logz.logz_fwd(s)
    p1 = logz.logz_posteriors(s, l1)
    f0, z0, l0 = logz.logz_fwd_plain(s, NBASE)
    p0 = logz.logz_posteriors_plain(s, l0, NBASE)
    torch.cuda.synchronize()
    z_err = max_abs_diff(z1, z0)
    z_tol = 1e-3 + 1e-5 * z0.abs().max().item()
    l_err = max(max_abs_diff(l1, l0), max_abs_diff(f1, f0))
    p_err = max_abs_diff(p1, p0)
    check(z_err <= z_tol, "logz_fwd: logZ max |err| {} > {}".format(
        z_err, z_tol))
    check(l_err <= 1e-4, "logz_fwd: lattice max |err| {} > 1e-4".format(
        l_err))
    check(p_err <= 1e-5, "logz_posteriors T={} B={}: max |err| {} > 1e-5"
          .format(t, b, p_err))
    check(bool(torch.isfinite(p1).all()), "logz_posteriors: non-finite")
    f_ms = cuda_ms(torch, lambda: logz.logz_fwd(s), reps=10)
    f_plain = cuda_ms(torch, lambda: logz.logz_fwd_plain(s, NBASE), reps=1,
                      warmup=0)
    p_ms = cuda_ms(torch, lambda: logz.logz_posteriors(s, l1), reps=10)
    p_plain = cuda_ms(torch, lambda: logz.logz_posteriors_plain(s, l1, NBASE),
                      reps=1, warmup=0)
    # ops per row and step: forward S adds, S exp, S max/sum, 2nff log/add;
    # posteriors about twice that
    f_bound = bound_ms(4 * (t * b * S + t * b * nff + b * nff + b),
                       t * b * (4 * S + 4 * nff))
    p_bound = bound_ms(4 * (2 * t * b * S + t * b * nff),
                       t * b * (8 * S + 4 * nff))
    return (z_err, z_tol, l_err, p_err, f_ms, f_plain, p_ms, p_plain,
            f_bound, p_bound)


def check_logz(torch, dev, rng):
    """logZ forward and posteriors at the basecall shape (the kernels
    line's rows) and again at the training shape (T=TT, B=TB), each
    against its twin.  Both passes' kernels cut T into segments
    (csrc/logz.cu): the segment length and the kernels a call launches are
    printed."""
    from taiyaki_tpu_torch.ops import logz
    (z_err, z_tol, l_err, p_err, f_ms, f_plain, p_ms, p_plain,
     (f_bound, f_by), (p_bound, p_by)) = _logz_case(torch, dev, rng, T, B)
    train = _logz_case(torch, dev, rng, TT, TB)
    for (t, b), (ze, zt, le, fm, fp, (fb, fby)) in (
            ((T, B), (z_err, z_tol, l_err, f_ms, f_plain, (f_bound, f_by))),
            ((TT, TB), (train[0], train[1], train[2], train[4], train[5],
                        train[8]))):
        say("logz_fwd T={} B={} S={} (segments of {} steps, {} kernels a "
            "call): logZ max|err| {:.3g} (tol {:.3g}), lattice {:.3g} (tol "
            "1e-4), kernels {:.4f} ms, plain {:.3f} ms, bound {:.4f} ms ({})"
            .format(t, b, 2 * NBASE * (NBASE + 1),
                    logz.forward_segment(t, b, NBASE),
                    logz.forward_kernels(t, b, NBASE), ze, zt, le, fm, fp,
                    fb, fby))
    for (t, b), (pe, pm, pp, (pb, pby)) in (
            ((T, B), (p_err, p_ms, p_plain, (p_bound, p_by))),
            ((TT, TB), (train[3], train[6], train[7], train[9]))):
        say("logz_posteriors T={} B={} (segments of {} steps, {} kernels a "
            "call): max|err| {:.3g} (tol 1e-5), kernels {:.4f} ms, plain "
            "{:.3f} ms, bound {:.4f} ms ({})".format(
                t, b, logz.posterior_segment(t, b, NBASE),
                logz.posterior_kernels(t, b, NBASE), pe, pm, pp, pb, pby))
    return [dict(name="logz_fwd", route="cuda",
                 source="taiyaki_tpu_torch/csrc/logz.cu",
                 replaces="taiyaki_tpu/ops/pallas_logz.py:142",
                 max_abs_err=max(z_err, l_err, train[0], train[2]), ms=f_ms,
                 plain_ms=f_plain, bound_ms=f_bound, bound_by=f_by,
                 library_ms=None, train_ms=train[4],
                 train_plain_ms=train[5], train_bound_ms=train[8][0]),
            dict(name="logz_posteriors", route="cuda",
                 source="taiyaki_tpu_torch/csrc/logz.cu",
                 replaces="taiyaki_tpu/ops/pallas_logz.py:249",
                 max_abs_err=max(p_err, train[3]), ms=p_ms, plain_ms=p_plain,
                 bound_ms=p_bound, bound_by=p_by, library_ms=None,
                 train_ms=train[6], train_plain_ms=train[7],
                 train_bound_ms=train[9][0])]


def rel_err(got, want):
    """max |got - want| over max(1, max |want|)."""
    return ((got - want).abs().max()
            / want.abs().max().clamp(min=1.0)).item()


def _tensor(torch, dev, a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(dev)


def _bwd_err(torch, got, want, what):
    """Largest relative error of a backward's outputs against its twin's
    (weight-gradient partials summed), after checking they are finite."""
    check(all(bool(torch.isfinite(g).all()) for g in got),
          "{}: non-finite output".format(what))
    return max([rel_err(got[0], want[0])]
               + [rel_err(g.sum(0), w.sum(0))
                  for g, w in zip(got[1:], want[1:])])


def _bwd_diff(torch, what, got, want):
    """_bwd_err of a layer backward; of a gradient chain on given gates
    (a tensor or a tuple of whole outputs), each output as it is."""
    if "scan" not in what:
        return _bwd_err(torch, got, want, what)
    got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
    check(all(bool(torch.isfinite(g).all()) for g in got),
          "{}: non-finite output".format(what))
    return max(rel_err(g, w) for g, w in zip(got, want))


def check_lstm_train(torch, dev, rng):
    """The forward with emit="acts", "pre" and "c" and the three backwards
    (from acts, kernel 4; from pre, kernel 11; rebuilding pre, kernel 12)
    at the production training shape, both directions, against their
    twins, on the same inputs, the backwards' chain on its plan's
    (cluster) instance and against the forced L2 instance; cuDNN's LSTM
    (torch.nn.LSTM) forward with grad and its backward as the library
    yardsticks."""
    from taiyaki_tpu_torch.ops import lstm
    D = H
    x = _tensor(torch, dev, rng.normal(size=(TT, TB, D)))
    iW = _tensor(torch, dev, rng.normal(size=(4 * H, D)) / np.sqrt(D))
    b = _tensor(torch, dev, 0.5 * rng.normal(size=4 * H))
    sW = _tensor(torch, dev, rng.normal(size=(4 * H, H)) / np.sqrt(H))
    dh = _tensor(torch, dev, rng.normal(size=(TT, TB, H)))
    bwds = {"lstm_bwd_acts": (lstm.lstm_bwd_acts, lstm.lstm_bwd_acts_plain),
            "lstm_bwd_fusedw": (lstm.lstm_bwd_fusedw,
                                lstm.lstm_bwd_fusedw_plain),
            "lstm_bwd_recompute": (lstm.lstm_bwd_recompute,
                                   lstm.lstm_bwd_recompute_plain)}
    emits = ("acts", "pre", "c")
    f_err = dict.fromkeys(emits, 0.0)
    b_err = dict.fromkeys(bwds, 0.0)
    b_l2 = dict.fromkeys(bwds, 0.0)
    f_ms, f_plain, f_l2, b_l2_ms = {}, {}, {}, {}
    b_ms = {k: {} for k in bwds}
    b_plain = {k: {} for k in bwds}
    for reverse in (False, True):
        want = {e: lstm.lstm_fwd_plain(x, iW, b, sW, reverse=reverse,
                                       emit=e) for e in ("acts", "pre")}
        want["c"] = want["pre"][:2]
        for e in emits:
            got = lstm.lstm_fwd(x, iW, b, sW, reverse=reverse, emit=e)
            torch.cuda.synchronize()
            f_err[e] = max([f_err[e]] + [max_abs_diff(g, w) for g, w in
                                         zip(got, want[e])])
            del got
        h, c, acts, tc = want["acts"]
        pre = want["pre"][2]
        c_prev = lstm.prev_state(c, reverse)
        args = {"lstm_bwd_acts": (dh, acts, tc, c_prev, h, x, sW, iW),
                "lstm_bwd_fusedw": (dh, pre, c, c_prev, h, x, sW, iW),
                "lstm_bwd_recompute": (dh, c, h, x, sW, iW, b)}
        for k, (kernel, plain) in bwds.items():
            gk = kernel(*args[k], reverse=reverse)
            gp = plain(*args[k], reverse=reverse)
            torch.cuda.synchronize()
            b_err[k] = max(b_err[k], _bwd_err(torch, gk, gp, k))
            del gk, gp
            diff, l2_ms = bwd_against_l2(torch, kernel, 0 if reverse else 1,
                                         *args[k], reverse=reverse)
            b_l2[k] = max(b_l2[k], diff)
            b_l2_ms[k] = b_l2_ms.get(k, l2_ms)
            b_ms[k][reverse] = cuda_ms(torch, lambda: kernel(
                *args[k], reverse=reverse), reps=3)
            b_plain[k][reverse] = cuda_ms(torch, lambda: plain(
                *args[k], reverse=reverse), reps=1, warmup=0)
        if not reverse:
            for e in emits:
                f_ms[e] = cuda_ms(torch, lambda: lstm.lstm_fwd(
                    x, iW, b, sW, emit=e), reps=3)
                f_plain[e] = cuda_ms(torch, lambda: lstm.lstm_fwd_plain(
                    x, iW, b, sW, emit=e), reps=1)
                f_l2[e] = against_l2(torch, lstm.lstm_fwd, 1, x, iW, b, sW,
                                     emit=e)
        del want, args, h, c, acts, tc, pre, c_prev
        torch.cuda.empty_cache()
    for e in emits:
        check(f_err[e] <= 1e-4, "lstm_fwd({}): max |err| {} > 1e-4".format(
            e, f_err[e]))
    for k in bwds:
        check(b_err[k] <= 1e-4, "{}: max relative err {} > 1e-4".format(
            k, b_err[k]))
    ref = torch.nn.LSTM(D, H).to(dev)
    with torch.no_grad():
        ref.weight_ih_l0.copy_(iW)
        ref.weight_hh_l0.copy_(sW)
        ref.bias_ih_l0.copy_(b)
        ref.bias_hh_l0.zero_()
    xr = x.clone().requires_grad_()
    lib_f = cuda_ms(torch, lambda: ref(xr), reps=3)
    out = ref(xr)[0]
    lib_b = cuda_ms(torch, lambda: torch.autograd.grad(
        out, [xr] + list(ref.parameters()), dh, retain_graph=True), reps=3)
    del out, xr
    # bytes of one [T, B, H] f32 stream, and of the weights
    nbh = 4 * TT * TB * H
    nw = 4 * 4 * H * (D + H + 1)
    x_bytes = 4 * TT * TB * D
    # one 4H x k product over the T B rows
    one = 2 * TT * TB * 4 * H
    # streams written beside h, in [T, B, H] units
    f_out = {"acts": 1 + 4 + 1, "pre": 1 + 4, "c": 1}
    f_bound = {e: bound_ms(x_bytes + nw + (1 + f_out[e]) * nbh, one * H,
                           one * D)
               for e in emits}
    # the chain (4H x H, f32 rate); d_sW (4H x H), d_x and d_iW (4H x D
    # each) on the tc instance; the rebuilding backward adds x iW^T and
    # h_prev sW^T
    stored_bytes = 8 * nbh + 2 * x_bytes + 2 * nw
    b_bound = {
        "lstm_bwd_acts": bound_ms(stored_bytes, one * H, one * (H + 2 * D)),
        "lstm_bwd_fusedw": bound_ms(stored_bytes, one * H,
                                    one * (H + 2 * D)),
        "lstm_bwd_recompute": bound_ms(3 * nbh + 2 * x_bytes + 2 * nw,
                                       one * H, one * (2 * H + 3 * D))}
    _, plan = plan_of("lstm", H, TB)
    _, bplan = plan_of("lstm", H, TB, backward=True)
    for e in emits:
        say("lstm_fwd({}) T={} B={} D=H={}: max|err| {:.3g} (tol 1e-4), "
            "kernel {:.3f} ms, plain {:.3f} ms, torch.nn.LSTM forward with "
            "grad {:.3f} ms, bound {:.3f} ms ({}); plan {}; forced L2 "
            "instance {:.3f} ms (|diff| {:.3g})".format(
                e, TT, TB, H, f_err[e], f_ms[e], f_plain[e], lib_f,
                *f_bound[e], plan, f_l2[e][1], f_l2[e][0]))
    for k in bwds:
        say("{} T={} B={} D=H={}: max relative err {:.3g} (tol 1e-4), "
            "kernel {:.3f} ms fwd / {:.3f} ms reverse, plain {:.3f} / "
            "{:.3f} ms, torch.nn.LSTM backward {:.3f} ms, bound {:.3f} ms "
            "({}); chain plan {}; forced L2 instance {:.3f} ms (relative "
            "diff {:.3g})".format(k, TT, TB, H, b_err[k], b_ms[k][False],
                                  b_ms[k][True], b_plain[k][False],
                                  b_plain[k][True], lib_b, *b_bound[k],
                                  bplan, b_l2_ms[k], b_l2[k]))
    fwd_rows = {e: dict(ms=f_ms[e], plain_ms=f_plain[e],
                        bound_ms=f_bound[e][0], max_abs_err=f_err[e],
                        library_ms=lib_f, l2_ms=f_l2[e][1],
                        l2_diff=f_l2[e][0], plan=plan) for e in emits}
    replaces = {"lstm_bwd_acts": 385, "lstm_bwd_fusedw": 456,
                "lstm_bwd_recompute": 625}
    return fwd_rows, [dict(
        name=k, route="cuda", source="taiyaki_tpu_torch/csrc/lstm.cu",
        replaces="taiyaki_tpu/ops/pallas_rnn.py:{}".format(replaces[k]),
        max_abs_err=b_err[k], ms=b_ms[k][False], plain_ms=b_plain[k][False],
        bound_ms=b_bound[k][0], bound_by=b_bound[k][1], library_ms=lib_b,
        l2_ms=b_l2_ms[k], l2_diff=b_l2[k], plan=bplan) for k in bwds]


def _crf_case(torch, dev, rng, tt, tb, tl, s, lens=None):
    """Scores [tt, tb, s] and the lattice index vectors of random ragged
    sequences (L=tl, lengths `lens` (lo, hi), else tl/2 .. tl); past 40
    columns, a cat_mod column with a weight for every move, as the
    cat_mod loss folds it."""
    from taiyaki_tpu_torch import flipflopfings
    from taiyaki_tpu_torch.ops import flipflop
    lp = _tensor(torch, dev, rng.normal(size=(tt, tb, s)))
    lo, hi = lens or (tl // 2, tl)
    seqlens = rng.integers(lo, hi + 1, size=tb).astype(np.int32)
    seqs = np.zeros((tb, tl), np.int32)
    for i in range(tb):
        seqs[i, :seqlens[i]] = flipflopfings.flipflop_code(
            rng.integers(0, NBASE, size=seqlens[i]))
    stay, move = flipflop.make_seq_indices(torch.from_numpy(seqs), NBASE)
    mm = mf = None
    if s > S:
        mm = torch.from_numpy(rng.integers(S, s, size=(tb, tl - 1))
                              .astype(np.int32))
        mf = torch.from_numpy(rng.uniform(0.5, 8.0, size=(tb, tl - 1))
                              .astype(np.float32))
    args = [a.to(dev) for a in flipflop._lattice_inputs(
        stay, move, torch.from_numpy(seqlens), s, mm, mf)]
    return lp, seqlens, args


def check_crf(torch, dev, rng, tt=TT, tb=TB, tl=TL, g_tol=1e-5, s=S):
    """The CRF forward and backward at T=tt, B=tb, L=tl (and s output
    columns, cat_mod past 40) against their twins (no PyTorch call
    computes either).  The gradient is held to g_tol times the largest
    mod weight (1 for a canonical model): 1e-5 at the training shape;
    over T=4000 steps the log-space forward and backward lattices and the
    score of kernel and twin each drift apart by up to their 1e-4
    tolerance, a posterior p = exp(fwd + bwd - score) moves by at most
    3e-4 p, and a gradient entry sums posteriors of total at most 1, so
    3e-4 there.  A mod column's entry sums posteriors times their weight,
    so its rounding scales with the largest weight.  The backward sums in
    an order fixed by the row's indices: two runs must be bitwise equal,
    as must two runs of the forward (its lattice).
    At the cat_mod width the canonical and the mod columns are reported
    apart, and the streams route's gradient (kernels 9-10: the forward and
    crf_grad_streams) is held to the same tolerance against this twin on
    the same inputs."""
    from taiyaki_tpu_torch.ops import crf
    lp, seqlens, args = _crf_case(torch, dev, rng, tt, tb, tl, s)
    sidx, midx, mmidx, mfact, valid, last = args
    idx = (sidx, midx, mmidx, mfact)
    f1, s1, lat1 = crf.crf_fwd(lp, *idx, valid)
    f_same = bool(torch.equal(lat1, crf.crf_fwd(lp, *idx, valid)[2]))
    f0, s0, lat0 = crf.crf_fwd_plain(lp, *idx, valid)
    g1 = crf.crf_bwd(lp, *idx, lat1, valid, last)
    g2 = crf.crf_bwd(lp, *idx, lat1, valid, last)
    g0 = crf.crf_bwd_plain(lp, *idx, lat0, valid, last)
    torch.cuda.synchronize()
    live = lat0 > crf.NEG / 2
    check(bool((lat1[~live] <= crf.NEG / 2).all()),
          "crf_fwd: impossible states differ")
    l_err = (lat1[live] - lat0[live]).abs().max().item()
    s_err = (s1 - s0).abs().max().item()
    s_tol = 1e-3 + 1e-5 * s0.abs().max().item()
    g_err = max_abs_diff(g1, g0)
    g_same = bool(torch.equal(g1, g2))
    weight = max(1.0, mfact.max().item())
    g_tol *= weight
    cols = ""
    if s > S:
        from taiyaki_tpu_torch.ops import flipflop
        stay, move = flipflop._select_streams(lp, sidx, midx, mmidx, mfact)
        _, _, lat_s = crf.crf_fwd_streams(stay, move, valid)
        g_route = crf.crf_grad_streams(stay, move, lat_s, valid, last, *idx,
                                       s)
        del stay, move, lat_s
        r_err = max_abs_diff(g_route, g0)
        del g_route
        can_err = max_abs_diff(g1[..., :S], g0[..., :S])
        mod_err = max_abs_diff(g1[..., S:], g0[..., S:])
        check(r_err <= g_tol, "streams route d lp: max |err| {} > {}".format(
            r_err, g_tol))
        cols = (" (canonical columns {:.3g}, mod columns {:.3g}; the streams "
                "route's d lp against this twin {:.3g})".format(
                    can_err, mod_err, r_err))
    del f0, s0, lat0, g0, g2
    check(s_err <= s_tol, "crf_fwd: score err {} > {}".format(s_err, s_tol))
    check(l_err <= 1e-4, "crf_fwd: lattice err {} > 1e-4".format(l_err))
    check(g_err <= g_tol, "crf_bwd: max |err| {} > {}".format(g_err, g_tol))
    check(g_same, "crf_bwd: two runs differ")
    check(f_same, "crf_fwd: two runs' lattices differ")
    f_ms = cuda_ms(torch, lambda: crf.crf_fwd(lp, *idx, valid), reps=5)
    f_plain = cuda_ms(torch, lambda: crf.crf_fwd_plain(lp, *idx, valid),
                      reps=1, warmup=0)
    b_ms = cuda_ms(torch, lambda: crf.crf_bwd(lp, *idx, lat1, valid, last),
                   reps=5)
    b_plain = cuda_ms(torch, lambda: crf.crf_bwd_plain(
        lp, *idx, lat1, valid, last), reps=1, warmup=0)
    # positions this data needs: each row's valid ones; per position and
    # step ~10 f32 operations forward (logaddexp, max), ~20 backward
    # bytes: lp read and d lp written in full, the lattice written in full
    # and read back at the valid positions only
    npos = int(seqlens.sum())
    idx_bytes = 4 * 6 * tb * tl
    f_bound, f_by = bound_ms(4 * (tt * tb * s + tt * tb * tl + tb * tl + tb)
                             + idx_bytes, 10 * tt * npos)
    b_bound, b_by = bound_ms(4 * (2 * tt * tb * s + tt * npos)
                             + idx_bytes, 20 * tt * npos)
    say("crf_fwd T={} B={} L={} S={} (layout {} threads x {} positions x "
        "{} CTAs a row): score err {:.3g} (tol {:.3g}), lattice {:.3g} (tol "
        "1e-4), kernel {:.3f} ms, plain {:.3f} ms, bound {:.4f} ms ({})"
        .format(tt, tb, tl, s, *crf.fwd_layout(tl), s_err, s_tol, l_err,
                f_ms, f_plain, f_bound, f_by))
    say("crf_bwd T={} B={} L={} S={} (batches of {} steps): d lp max "
        "|err| {:.3g} (tol {:.3g}){}, two runs bitwise equal, kernel {:.3f} "
        "ms, plain {:.3f} ms, bound {:.4f} ms ({})".format(
            tt, tb, tl, s, crf.bwd_batch(tt, tb, s, tl), g_err, g_tol, cols,
            b_ms, b_plain, b_bound, b_by))
    return [dict(name="crf_fwd", route="cuda",
                 source="taiyaki_tpu_torch/csrc/crf.cu",
                 replaces="taiyaki_tpu/ops/pallas_crf.py:423",
                 max_abs_err=max(s_err, l_err), ms=f_ms, plain_ms=f_plain,
                 bound_ms=f_bound, bound_by=f_by, library_ms=None),
            dict(name="crf_bwd", route="cuda",
                 source="taiyaki_tpu_torch/csrc/crf.cu",
                 replaces="taiyaki_tpu/ops/pallas_crf.py:565",
                 max_abs_err=g_err, ms=b_ms, plain_ms=b_plain,
                 bound_ms=b_bound, bound_by=b_by, library_ms=None)]


def check_crf_streams(torch, dev, rng, tt=TT, tb=TB, tl=TL, p_tol=1e-5):
    """Kernels 9-10 (the CRF on score streams) at T=tt, B=tb, L=tl against
    their twins, on streams that the route's own gather selects from
    cat_mod scores (SC columns, a weighted mod column in every move); no
    PyTorch call computes any of them.  Kernel 9 (`crf_fwd_streams`), and
    kernel 10's two entries, each its backward chain and posterior pass:
    the posteriors (`crf_bwd_posteriors`) and the route's d lp
    (`crf_grad_streams`, the posteriors summed into their columns).
    Tolerances: score 1e-3 + 1e-5 |score|, lattice 1e-4 on live states (as
    kernel 5), posteriors p_tol (1e-5 at the training shape; 3e-4 over
    thousands of steps, as kernel 6's gradient), d lp p_tol times its
    twin's largest entry (a mod column's entry sums posteriors times
    weights up to 8); posteriors and d lp bitwise equal from run to run
    (no atomics).  Also times the route's gather of the two streams and,
    for the record, the scatter of the posteriors into d lp that
    `crf_grad_streams` replaced.  Returns the rows of kernels 9 and 10
    (10's for the d lp entry, the posteriors entry's numbers beside)."""
    from taiyaki_tpu_torch.ops import crf, flipflop
    lp, seqlens, args = _crf_case(torch, dev, rng, tt, tb, tl, SC)
    sidx, midx, mmidx, mfact, valid, last = args
    idx = (sidx, midx, mmidx, mfact)
    stay, move = flipflop._select_streams(lp, *idx)
    f1, s1, lat1 = crf.crf_fwd_streams(stay, move, valid)
    p1 = crf.crf_bwd_posteriors(stay, move, lat1, valid, last)
    p2 = crf.crf_bwd_posteriors(stay, move, lat1, valid, last)
    g1 = crf.crf_grad_streams(stay, move, lat1, valid, last, *idx, SC)
    g2 = crf.crf_grad_streams(stay, move, lat1, valid, last, *idx, SC)
    f0, s0, lat0 = crf.crf_fwd_streams_plain(stay, move, valid)
    p0 = crf.crf_bwd_posteriors_plain(stay, move, lat0, valid, last)
    # crf_grad_streams_plain is these posteriors scattered
    g0 = crf.scatter_posteriors(lp.shape, p0[0], p0[1].clone(), *idx)
    torch.cuda.synchronize()
    live = lat0 > crf.NEG / 2
    check(bool((lat1[~live] <= crf.NEG / 2).all()),
          "crf_fwd_streams: impossible states differ")
    l_err = max((lat1[live] - lat0[live]).abs().max().item(),
                (f1 - f0).abs().masked_fill(f0 <= crf.NEG / 2, 0).max()
                .item())
    s_err = (s1 - s0).abs().max().item()
    s_tol = 1e-3 + 1e-5 * s0.abs().max().item()
    p_err = max(max_abs_diff(a, b) for a, b in zip(p1, p0))
    g_err = max_abs_diff(g1, g0)
    g_tol = p_tol * g0.abs().max().item()
    rerun = all(bool(torch.equal(a, b)) for a, b in zip(p1, p2))
    g_same = bool(torch.equal(g1, g2))
    mass = p1[0].sum().item() + p1[1].sum().item()
    del f0, s0, lat0, p0, p2, g0, g2
    check(s_err <= s_tol, "crf_fwd_streams: score err {} > {}".format(
        s_err, s_tol))
    check(l_err <= 1e-4, "crf_fwd_streams: lattice err {} > 1e-4".format(
        l_err))
    check(p_err <= p_tol, "crf_bwd_posteriors: max |err| {} > {}".format(
        p_err, p_tol))
    check(g_err <= g_tol, "crf_grad_streams: max |err| {} > {}".format(
        g_err, g_tol))
    check(rerun, "crf_bwd_posteriors: not bitwise equal run to run")
    check(g_same, "crf_grad_streams: not bitwise equal run to run")
    # every row has a path: each step's posteriors sum to 1
    check(abs(mass - tt * tb) <= 1e-3 * tt * tb,
          "crf_bwd_posteriors: total mass {} of {}".format(mass, tt * tb))
    reps = 5 if tt <= TT else 2
    f_ms = cuda_ms(torch, lambda: crf.crf_fwd_streams(stay, move, valid),
                   reps=reps)
    f_plain = cuda_ms(torch, lambda: crf.crf_fwd_streams_plain(
        stay, move, valid), reps=1, warmup=0)
    b_ms = cuda_ms(torch, lambda: crf.crf_bwd_posteriors(
        stay, move, lat1, valid, last), reps=reps)
    b_plain = cuda_ms(torch, lambda: crf.crf_bwd_posteriors_plain(
        stay, move, lat1, valid, last), reps=1, warmup=0)
    g_ms = cuda_ms(torch, lambda: crf.crf_grad_streams(
        stay, move, lat1, valid, last, *idx, SC), reps=reps)
    g_plain = cuda_ms(torch, lambda: crf.crf_grad_streams_plain(
        stay, move, lat1, valid, last, *idx, SC), reps=1, warmup=0)
    sel_ms = cuda_ms(torch, lambda: flipflop._select_streams(lp, *idx),
                     reps=reps)
    scat_ms = cuda_ms(torch, lambda: crf.scatter_posteriors(
        lp.shape, p1[0], p1[1].clone(), *idx), reps=reps)
    # bytes: each stream read once where this data needs it (stay and the
    # lattice at valid positions, move at those a move enters forward and
    # leaves backward), each output written once in full (d lp [T, B, S]
    # for the d lp entry); operations on this data's valid positions, ~10
    # a position and step forward (logaddexp, max), ~20 backward (two
    # exps, max, sum, logaddexp)
    npos = int(seqlens.sum())
    pos = torch.arange(tl, device=dev)[None]
    ok = valid != 0
    n_fmove = int(ok[:, 1:].sum().item())
    n_bmove = int((ok & (pos < last.long()[:, None])).sum().item())
    stream = 4 * tt * tb * tl
    reads = 4 * tt * (2 * npos + n_bmove)
    f_bound, f_by = bound_ms(4 * tt * (npos + n_fmove) + stream
                             + 4 * (2 * tb * tl + tb), 10 * tt * npos)
    b_bound, b_by = bound_ms(reads + 2 * stream + 4 * (tb * tl + tb),
                             20 * tt * npos)
    g_bound, g_by = bound_ms(reads + 4 * tt * tb * SC
                             + 4 * (5 * tb * tl + tb), 20 * tt * npos)
    say("crf_fwd_streams T={} B={} L={} (cat_mod streams, S={}; layout {}): "
        "score err {:.3g} (tol {:.3g}), lattice {:.3g} (tol 1e-4), kernel "
        "{:.3f} ms, plain {:.3f} ms, bound {:.4f} ms ({})".format(
            tt, tb, tl, SC, crf.streams_layout(tl) or "device memory",
            s_err, s_tol, l_err, f_ms, f_plain, f_bound, f_by))
    say("crf_bwd_posteriors T={} B={} L={}: max |err| {:.3g} (tol {:.0e}), "
        "bitwise run to run, kernels {:.3f} ms, plain {:.3f} ms, bound "
        "{:.4f} ms ({}); crf_grad_streams: d lp max |err| {:.3g} (tol "
        "{:.3g}), bitwise run to run, kernels {:.3f} ms, plain {:.3f} ms, "
        "bound {:.4f} ms ({}); the route's gather of both streams {:.3f} "
        "ms; a scatter_add_ of the posteriors into d lp (no longer on the "
        "route) {:.3f} ms".format(
            tt, tb, tl, p_err, p_tol, b_ms, b_plain, b_bound, b_by, g_err,
            g_tol, g_ms, g_plain, g_bound, g_by, sel_ms, scat_ms))
    return [dict(name="crf_fwd_streams", route="cuda",
                 source="taiyaki_tpu_torch/csrc/crf.cu",
                 replaces="taiyaki_tpu/ops/pallas_crf.py:108",
                 max_abs_err=max(s_err, l_err), ms=f_ms, plain_ms=f_plain,
                 bound_ms=f_bound, bound_by=f_by, library_ms=None),
            dict(name="crf_grad_streams", route="cuda",
                 source="taiyaki_tpu_torch/csrc/crf.cu",
                 replaces="taiyaki_tpu/ops/pallas_crf.py:218",
                 max_abs_err=g_err, ms=g_ms, plain_ms=g_plain,
                 bound_ms=g_bound, bound_by=g_by, library_ms=None,
                 post=dict(max_abs_err=p_err, ms=b_ms, plain_ms=b_plain,
                           bound_ms=b_bound, bound_by=b_by))]


def _catmod_case(rng, tt, tb, tl, lo):
    """Cat_mod loss inputs on the host: scores [tt, tb, SC], sequences of
    lo .. tl positions with random mod categories of the modref alphabet
    (A and C carry one mod each), its offsets and weights."""
    from taiyaki_tpu_torch import flipflopfings
    offsets = np.array([0, 2, 4, 5, 6], np.int32)
    x = rng.normal(size=(tt, tb, SC)).astype(np.float32)
    seqlens = rng.integers(lo, tl + 1, size=tb).astype(np.int32)
    seqs = np.zeros((tb, tl), np.int32)
    cats = np.zeros((tb, tl), np.int32)
    for i in range(tb):
        bases = rng.integers(0, NBASE, size=seqlens[i])
        seqs[i, :seqlens[i]] = flipflopfings.flipflop_code(bases)
        cats[i, :seqlens[i]] = np.where(bases < 2, rng.integers(
            0, 2, size=seqlens[i]), 0)
    weights = rng.uniform(0.5, 2.0, size=6).astype(np.float32)
    return x, seqs, seqlens, cats, offsets, weights


def long_lattice(torch, dev, rng, counters, shape=(XT, XB, XL)):
    """A lattice past the fused kernels' 8192 positions (T, B, L = shape;
    XT, XB, XL in a cluster of 4 CTAs a row, YT, YB, YL in one of 8)
    through the cat_mod loss with no switch set: it takes the streams
    route (kernel 9 and kernel 10's d lp entry launched once each, 5-6
    never, no scatter_add_); the loss is finite, every row has a path, the
    gradient is finite and each step's posteriors sum to one per row.
    Then kernels 9-10 against their twins at that shape."""
    from taiyaki_tpu_torch.ops import flipflop
    tt, tb, tl = shape
    check(tl > 8192 and tt >= tl, "the long lattice must pass 8192")
    x, seqs, seqlens, cats, offsets, weights = _catmod_case(
        rng, tt, tb, tl, tl - 300)
    for fn in counters.values():
        fn.launches = 0
    tx = torch.from_numpy(x).to(dev).requires_grad_()
    with switches({"TAIYAKI_TPU_NO_SCORE_FUSE": "0",
                   "TAIYAKI_TPU_F32_SCORES": "0"}), \
            count_scatters(torch) as scatters:
        loss = flipflop.cat_mod_flipflop_loss(
            tx, *(torch.from_numpy(a).to(dev) for a in (seqs, seqlens, cats)),
            offsets, weights)
        loss.sum().backward()
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters.items()}
    check(launches == {"crf_fwd": 0, "crf_bwd": 0, "crf_fwd_streams": 1,
                       "crf_grad_streams": 1},
          "long lattice: launches {}".format(launches))
    check(scatters["calls"] == 0, "long lattice: {} scatter_add_ calls on "
          "the streams route".format(scatters["calls"]))
    costs = loss.detach().cpu().numpy()
    check(bool(np.isfinite(costs).all()) and bool((costs != 0).all())
          and bool(torch.isfinite(tx.grad).all()),
          "long lattice: costs {}".format(costs))
    # d cost / d lp sums -1/T per row and step over the transition columns
    mass = -tx.grad[:, :, :S].sum().item() * tt
    check(abs(mass - tt * tb) <= 1e-3 * tt * tb,
          "long lattice: posterior mass {}".format(mass))
    say("long lattice T={} B={} L={} (S={}) through the cat_mod loss, no "
        "switch: launches {}, no scatter_add_; costs {}".format(
            tt, tb, tl, SC, launches,
            ", ".join("{:.5f}".format(c) for c in costs)))
    del tx, loss
    torch.cuda.empty_cache()
    rows = check_crf_streams(torch, dev, rng, tt, tb, tl, p_tol=3e-4)
    torch.cuda.empty_cache()
    return launches, rows


def _gru_inputs(torch, dev, rng, t, b, d, h):
    x = _tensor(torch, dev, rng.normal(size=(t, b, d)))
    iW = _tensor(torch, dev, rng.normal(size=(3 * h, d)) / np.sqrt(d))
    bias = _tensor(torch, dev, 0.5 * rng.normal(size=3 * h))
    sW = _tensor(torch, dev, rng.normal(size=(3 * h, h)) / np.sqrt(h))
    return x, iW, bias, sW


def _torch_gru(torch, dev, x, iW, b, sW):
    """cuDNN's GRU holding the same weights, its hidden bias zero: the
    same function (gate order r, z, n).  A yardstick only."""
    ref = torch.nn.GRU(x.shape[2], sW.shape[1]).to(dev)
    with torch.no_grad():
        ref.weight_ih_l0.copy_(iW)
        ref.weight_hh_l0.copy_(sW)
        ref.bias_ih_l0.copy_(b)
        ref.bias_hh_l0.zero_()
    return ref


def _gru_fwd_bound(t, b, d, h):
    """The recurrence's product at the f32 rate, the input GEMM on the tc
    instance."""
    return bound_ms(4 * (t * b * d + 3 * h * (d + h + 1) + t * b * h),
                    2 * t * b * h * 3 * h, 2 * t * b * d * 3 * h)


def check_gru(torch, dev, rng):
    """The GRU forward (kernel 7) at the basecall shape (T=1000, B=128) at
    H=D=256 and at the shipped remap model's H=D=96, both directions,
    against its twin; cuDNN's GRU forward as the library yardstick."""
    from taiyaki_tpu_torch.ops import gru
    out = {}
    for h in (H, 96):
        x, iW, b, sW = _gru_inputs(torch, dev, rng, T, B, h, h)
        err, ms, plain = 0.0, {}, {}
        for reverse in (False, True):
            got = gru.gru_fwd(x, iW, b, sW, reverse=reverse)
            want = gru.gru_fwd_plain(x, iW, b, sW, reverse=reverse)
            torch.cuda.synchronize()
            check(got.shape == want.shape and bool(torch.isfinite(got).all()),
                  "gru_fwd: bad output")
            err = max(err, max_abs_diff(got, want))
            ms[reverse] = cuda_ms(torch, lambda: gru.gru_fwd(
                x, iW, b, sW, reverse=reverse), reps=5)
            plain[reverse] = cuda_ms(torch, lambda: gru.gru_fwd_plain(
                x, iW, b, sW, reverse=reverse), reps=1, warmup=0)
        check(err <= 1e-4, "gru_fwd H={}: max |err| {} > 1e-4".format(h, err))
        ref = _torch_gru(torch, dev, x, iW, b, sW)
        with torch.no_grad():
            lib_err = (ref(x)[0] - gru.gru_fwd(x, iW, b, sW)).abs().max()
            lib_ms = cuda_ms(torch, lambda: ref(x), reps=5)
        bound, by = _gru_fwd_bound(T, B, h, h)
        l2_diff, l2_ms = against_l2(torch, gru.gru_fwd, 2, x, iW, b, sW)
        _, plan = plan_of("gru", h, B)
        say("gru_fwd    T={} B={} D=H={}: max|err| {:.3g} (tol 1e-4), kernel "
            "{:.3f} ms fwd / {:.3f} ms reverse, plain {:.3f} / {:.3f} ms, "
            "torch.nn.GRU {:.3f} ms (|diff| {:.3g}), bound {:.3f} ms ({}); "
            "serial floor: {} dependent steps; plan {}; forced L2 instance "
            "{:.3f} ms (|diff| {:.3g})".format(
                T, B, h, err, ms[False], ms[True], plain[False],
                plain[True], lib_ms, lib_err.item(), bound, by, T, plan,
                l2_ms, l2_diff))
        out[h] = dict(name="gru_fwd", route="cuda",
                      source="taiyaki_tpu_torch/csrc/gru.cu",
                      replaces="taiyaki_tpu/ops/pallas_rnn.py:995",
                      max_abs_err=err, ms=ms[False], plain_ms=plain[False],
                      bound_ms=bound, bound_by=by, library_ms=lib_ms,
                      l2_ms=l2_ms, l2_diff=l2_diff, plan=plan)
    return out[H], out[96]


def check_gru_train(torch, dev, rng):
    """The GRU forward without and with its gate streams (kernel 7), the
    recomputing backward (kernel 8) and the backward from stored gate
    streams (kernel 13) at the mGru training shape (T=2000, B=256,
    H=D=256), both directions, against their twins on the same inputs,
    the backwards' chain on its plan's (cluster) instance and against the
    forced L2 instance; cuDNN's GRU forward with grad and its backward as
    the library yardsticks."""
    from taiyaki_tpu_torch.ops import gru, lstm
    x, iW, b, sW = _gru_inputs(torch, dev, rng, GT, TB, H, H)
    dh = _tensor(torch, dev, rng.normal(size=(GT, TB, H)))
    bwds = {"gru_bwd_recompute": (gru.gru_bwd_recompute,
                                  gru.gru_bwd_recompute_plain),
            "gru_bwd_fusedw": (gru.gru_bwd_fusedw, gru.gru_bwd_fusedw_plain)}
    f_err = {False: 0.0, True: 0.0}
    b_err = dict.fromkeys(bwds, 0.0)
    b_l2 = dict.fromkeys(bwds, 0.0)
    f_ms, f_plain, f_l2, b_l2_ms = {}, {}, {}, {}
    b_ms = {k: {} for k in bwds}
    b_plain = {k: {} for k in bwds}
    for reverse in (False, True):
        want = gru.gru_fwd_plain(x, iW, b, sW, reverse=reverse,
                                 emit_residuals=True)
        for res in (False, True):
            got = gru.gru_fwd(x, iW, b, sW, reverse=reverse,
                              emit_residuals=res)
            torch.cuda.synchronize()
            # h alone, or (h, gh, gx)
            outs = got if res else (got,)
            f_err[res] = max([f_err[res]] + [max_abs_diff(g, w)
                                             for g, w in zip(outs, want)])
            del got, outs
        h, gh, gx = want
        args = {"gru_bwd_recompute": (dh, h, x, sW, iW, b),
                "gru_bwd_fusedw": (dh, gx, gh, lstm.prev_state(h, reverse),
                                   x, sW, iW)}
        for k, (kernel, plain) in bwds.items():
            gk = kernel(*args[k], reverse=reverse)
            gp = plain(*args[k], reverse=reverse)
            torch.cuda.synchronize()
            b_err[k] = max(b_err[k], _bwd_err(torch, gk, gp, k))
            del gk, gp
            diff, l2_ms = bwd_against_l2(torch, kernel, 0 if reverse else 1,
                                         *args[k], reverse=reverse)
            b_l2[k] = max(b_l2[k], diff)
            b_l2_ms[k] = b_l2_ms.get(k, l2_ms)
            b_ms[k][reverse] = cuda_ms(torch, lambda: kernel(
                *args[k], reverse=reverse), reps=3)
            b_plain[k][reverse] = cuda_ms(torch, lambda: plain(
                *args[k], reverse=reverse), reps=1, warmup=0)
        for res in (False, True):
            f_ms[res, reverse] = cuda_ms(torch, lambda: gru.gru_fwd(
                x, iW, b, sW, reverse=reverse, emit_residuals=res), reps=3)
        if not reverse:
            for res in (False, True):
                f_plain[res] = cuda_ms(torch, lambda: gru.gru_fwd_plain(
                    x, iW, b, sW, emit_residuals=res), reps=1)
                f_l2[res] = against_l2(torch, gru.gru_fwd, 1, x, iW, b, sW,
                                       emit_residuals=res)
        del want, args, h, gh, gx
        torch.cuda.empty_cache()
    for res in (False, True):
        check(f_err[res] <= 1e-4, "gru_fwd (training shape, emit_residuals="
              "{}): max |err| {} > 1e-4".format(res, f_err[res]))
    for k in bwds:
        check(b_err[k] <= 1e-4, "{}: max relative err {} > 1e-4".format(
            k, b_err[k]))
    ref = _torch_gru(torch, dev, x, iW, b, sW)
    xr = x.clone().requires_grad_()
    lib_f = cuda_ms(torch, lambda: ref(xr), reps=3)
    out = ref(xr)[0]
    lib_b = cuda_ms(torch, lambda: torch.autograd.grad(
        out, [xr] + list(ref.parameters()), dh, retain_graph=True), reps=3)
    del out, xr, ref
    f_bound = {False: _gru_fwd_bound(GT, TB, H, H)}
    # gh and gx written beside h: six more [T, B, H] streams
    f_bound[True] = bound_ms(
        4 * (GT * TB * H + 3 * H * (2 * H + 1) + 7 * GT * TB * H),
        2 * GT * TB * H * 3 * H, 2 * GT * TB * H * 3 * H)
    nw = 4 * (2 * 3 * H * 2 * H + 2 * 3 * H)
    one = 2 * GT * TB * 3 * H * H
    b_bound = {
        # gx and gh rebuilt, d_x, d_iW, d_sW on the tc instance, the dh
        # chain at the f32 rate: six products
        "gru_bwd_recompute": bound_ms(4 * 4 * GT * TB * H + nw, one,
                                      5 * one),
        # dh, gx, gh, h_prev, x in, d_x out: four products
        "gru_bwd_fusedw": bound_ms(4 * 10 * GT * TB * H + nw, one,
                                   3 * one)}
    _, plan = plan_of("gru", H, TB)
    _, bplan = plan_of("gru", H, TB, backward=True)
    for res in (False, True):
        say("gru_fwd(emit_residuals={}) T={} B={} D=H={}: max|err| {:.3g} "
            "(tol 1e-4), kernel {:.3f} ms fwd / {:.3f} ms reverse, plain "
            "{:.3f} ms, torch.nn.GRU forward with grad {:.3f} ms, bound "
            "{:.3f} ms ({}); plan {}; forced L2 instance {:.3f} ms (|diff| "
            "{:.3g})".format(res, GT, TB, H, f_err[res], f_ms[res, False],
                             f_ms[res, True], f_plain[res], lib_f,
                             *f_bound[res], plan, f_l2[res][1],
                             f_l2[res][0]))
    for k in bwds:
        say("{} T={} B={} D=H={}: max relative err {:.3g} (tol 1e-4), "
            "kernel {:.3f} ms fwd / {:.3f} ms reverse, plain {:.3f} / "
            "{:.3f} ms, torch.nn.GRU backward {:.3f} ms, bound {:.3f} ms "
            "({}); chain plan {}; forced L2 instance {:.3f} ms (relative "
            "diff {:.3g})".format(k, GT, TB, H, b_err[k], b_ms[k][False],
                                  b_ms[k][True], b_plain[k][False],
                                  b_plain[k][True], lib_b, *b_bound[k],
                                  bplan, b_l2_ms[k], b_l2[k]))
    fwd_rows = {res: dict(ms=f_ms[res, False], plain_ms=f_plain[res],
                          bound_ms=f_bound[res][0], max_abs_err=f_err[res],
                          library_ms=lib_f, l2_ms=f_l2[res][1],
                          l2_diff=f_l2[res][0], plan=plan)
                for res in (False, True)}
    replaces = {"gru_bwd_recompute": 1311, "gru_bwd_fusedw": 1184}
    return fwd_rows, [dict(
        name=k, route="cuda", source="taiyaki_tpu_torch/csrc/gru.cu",
        replaces="taiyaki_tpu/ops/pallas_rnn.py:{}".format(replaces[k]),
        max_abs_err=b_err[k], ms=b_ms[k][False], plain_ms=b_plain[k][False],
        bound_ms=b_bound[k][0], bound_by=b_bound[k][1], library_ms=lib_b,
        l2_ms=b_l2_ms[k], l2_diff=b_l2[k], plan=bplan) for k in bwds]


def _scan_bounds(G, t, b, h, d):
    """(forward, backward, backward with iW) bounds of the recurrence on
    given gates with G gate rows per unit: the operations of the
    recurrent product (2 T B GH H, and d_x's 2 T B GH D), the streams and
    weights read once and the outputs written once."""
    gates, state, w = 4 * t * b * G * h, 4 * t * b * h, 4 * G * h * h
    flops = 2 * t * b * G * h * h
    dx = (2 * t * b * G * h * d, 4 * (t * b * d + G * h * d))
    if G == 4:
        # gx, sW in; h, c, pre out / dh, c, c_prev, pre, sW in; dpre out
        fwd_bytes = 2 * gates + 2 * state + w
        bwd_bytes = 2 * gates + 3 * state + w
    else:
        # gx, sW in; h, gh out / dh, h_prev, gx, gh, sW in; dgx, dgh out
        fwd_bytes = 2 * gates + state + w
        bwd_bytes = 4 * gates + 2 * state + w
    return (bound_ms(fwd_bytes, flops), bound_ms(bwd_bytes, flops),
            bound_ms(bwd_bytes + dx[1], flops, dx[0]))


def check_scan(torch, dev, rng):
    """Kernels 14-17, the LSTM and GRU recurrences on given gates, against
    their twins at the mLstm (T=TT) and mGru (T=GT) training shapes (B=TB,
    H=256), both directions, the backwards also with iW (d_x, D=256); the
    forwards leave gates_x as it was.  Tolerances as the layer kernels':
    outputs 1e-4, backwards 1e-4 relative.  cuDNN's LSTM and GRU (D=H,
    forward with grad, backward) as yardsticks: they include the input
    product these kernels do not compute.  Returns the four rows."""
    from taiyaki_tpu_torch.ops import gru, lstm
    rows = []
    for cell, t, mod, G in (("lstm", TT, lstm, 4), ("gru", GT, gru, 3)):
        fwd, fwd_plain = (getattr(mod, cell + "_scan_fwd" + k)
                          for k in ("", "_plain"))
        bwd, bwd_plain = (getattr(mod, cell + "_scan_bwd" + k)
                          for k in ("", "_plain"))
        x = _tensor(torch, dev, rng.normal(size=(t, TB, H)))
        iW = _tensor(torch, dev, rng.normal(size=(G * H, H)) / np.sqrt(H))
        b = _tensor(torch, dev, 0.5 * rng.normal(size=G * H))
        sW = _tensor(torch, dev, rng.normal(size=(G * H, H)) / np.sqrt(H))
        dh = _tensor(torch, dev, rng.normal(size=(t, TB, H)))
        gx = torch.matmul(x, iW.t()) + b
        kept = gx.clone()
        f_err = b_err = b_l2 = 0.0
        ms, plain = {}, {}
        for reverse in (False, True):
            want = fwd_plain(gx, sW, reverse=reverse, residuals=True)
            got = fwd(gx, sW, reverse=reverse, residuals=True)
            h_only = fwd(gx, sW, reverse=reverse)
            torch.cuda.synchronize()
            f_err = max([f_err] + [max_abs_diff(g, w) for g, w in zip(
                got + (h_only,), want + (want[0],))])
            del got, h_only
            if cell == "lstm":
                h, c, pre = want
                res = (dh, pre, c, lstm.prev_state(c, reverse), sW)
            else:
                h, gh = want
                res = (dh, gx, gh, lstm.prev_state(h, reverse), sW)
            for iw in (None, iW):
                gk = bwd(*res, reverse=reverse, iW=iw)
                gp = bwd_plain(*res, reverse=reverse, iW=iw)
                torch.cuda.synchronize()
                gk, gp = (gk, gp) if isinstance(gk, tuple) else ((gk,), (gp,))
                check(all(bool(torch.isfinite(g).all()) for g in gk),
                      "{}_scan_bwd: non-finite output".format(cell))
                b_err = max([b_err] + [rel_err(g, w) for g, w in zip(gk, gp)])
                del gk, gp
                diff, l2_ms = bwd_against_l2(
                    torch, bwd, 1 if iw is None and not reverse else 0,
                    *res, reverse=reverse, iW=iw)
                b_l2 = max(b_l2, diff)
                if l2_ms is not None:
                    ms["bwd l2"] = l2_ms
            ms["fwd", reverse] = cuda_ms(torch, lambda: fwd(
                gx, sW, reverse=reverse, residuals=True), reps=3)
            for iw in (None, iW):
                ms["bwd", iw is not None, reverse] = cuda_ms(
                    torch, lambda: bwd(*res, reverse=reverse, iW=iw), reps=3)
            if not reverse:
                plain["fwd"] = cuda_ms(torch, lambda: fwd_plain(
                    gx, sW, residuals=True), reps=1, warmup=0)
                l2 = against_l2(torch, fwd, 1, gx, sW, residuals=True)
                plain["bwd"] = cuda_ms(torch, lambda: bwd_plain(*res),
                                       reps=1, warmup=0)
            del want, res
            torch.cuda.empty_cache()
        check(bool(torch.equal(gx, kept)), "{}_scan_fwd wrote its gates_x"
              .format(cell))
        check(f_err <= 1e-4, "{}_scan_fwd: max |err| {} > 1e-4".format(
            cell, f_err))
        check(b_err <= 1e-4, "{}_scan_bwd: max relative err {} > 1e-4"
              .format(cell, b_err))
        ref = (torch.nn.LSTM(H, H) if cell == "lstm"
               else torch.nn.GRU(H, H)).to(dev)
        with torch.no_grad():
            ref.weight_ih_l0.copy_(iW)
            ref.weight_hh_l0.copy_(sW)
            ref.bias_ih_l0.copy_(b)
            ref.bias_hh_l0.zero_()
        xr = x.clone().requires_grad_()
        lib_f = cuda_ms(torch, lambda: ref(xr), reps=3)
        out = ref(xr)[0]
        lib_b = cuda_ms(torch, lambda: torch.autograd.grad(
            out, [xr] + list(ref.parameters()), dh, retain_graph=True),
            reps=3)
        del out, xr, ref, x, gx, kept
        torch.cuda.empty_cache()
        f_bound, b_bound, bx_bound = _scan_bounds(G, t, TB, H, H)
        lib = "torch.nn.{}".format("LSTM" if cell == "lstm" else "GRU")
        _, plan = plan_of(cell, H, TB)
        _, bplan = plan_of(cell, H, TB, backward=True)
        say("{}_scan_fwd T={} B={} H={}: max|err| {:.3g} (tol 1e-4), kernel "
            "{:.3f} ms fwd / {:.3f} ms reverse, plain {:.3f} ms, {} forward "
            "with grad (its input product included) {:.3f} ms, bound {:.3f} "
            "ms ({}); plan {}; forced L2 instance {:.3f} ms (|diff| "
            "{:.3g})".format(cell, t, TB, H, f_err, ms["fwd", False],
                             ms["fwd", True], plain["fwd"], lib, lib_f,
                             *f_bound, plan, l2[1], l2[0]))
        say("{}_scan_bwd T={} B={} H={}: max relative err {:.3g} (tol 1e-4, "
            "with and without iW), kernel {:.3f} ms fwd / {:.3f} ms reverse, "
            "with iW (d_x, D={}) {:.3f} / {:.3f} ms, plain {:.3f} ms, {} "
            "backward (its input product's gradients included) {:.3f} ms, "
            "bound {:.3f} ms ({}), with iW {:.3f} ms ({}); chain plan {}; "
            "forced L2 instance {:.3f} ms (relative diff {:.3g}, with and "
            "without iW)".format(
                cell, t, TB, H, b_err, ms["bwd", False, False],
                ms["bwd", False, True], H, ms["bwd", True, False],
                ms["bwd", True, True], plain["bwd"], lib, lib_b, *b_bound,
                *bx_bound, bplan, ms["bwd l2"], b_l2))
        replaces = {"lstm": (141, 726), "gru": (1082, 1407)}[cell]
        src = "taiyaki_tpu_torch/csrc/{}.cu".format(cell)
        rows.append(dict(
            name=cell + "_scan_fwd", route="cuda", source=src,
            replaces="taiyaki_tpu/ops/pallas_rnn.py:{}".format(replaces[0]),
            max_abs_err=f_err, ms=ms["fwd", False], plain_ms=plain["fwd"],
            bound_ms=f_bound[0], bound_by=f_bound[1], library_ms=lib_f,
            l2_ms=l2[1], l2_diff=l2[0], plan=plan))
        rows.append(dict(
            name=cell + "_scan_bwd", route="cuda", source=src,
            replaces="taiyaki_tpu/ops/pallas_rnn.py:{}".format(replaces[1]),
            max_abs_err=b_err, ms=ms["bwd", False, False],
            plain_ms=plain["bwd"], bound_ms=b_bound[0],
            bound_by=b_bound[1], library_ms=lib_b,
            iw_ms=ms["bwd", True, False], iw_bound_ms=bx_bound[0],
            l2_ms=ms["bwd l2"], l2_diff=b_l2, plan=bplan))
    return rows


def check_l2_512(torch, dev, rng):
    """The L2 instance of the forward recurrences where no cluster plan
    fits: the LSTM and GRU layers at H=D=512 (T=200, B=64), every emit
    mode and gh, both directions, against their twins (1e-4); the plan
    takes the L2 instance without being forced, and only it launches.
    The backward rows there too, against their twins (1e-4 relative) on
    the backward plan's instance, the only one that launches: the L2
    instance for the LSTM's (its rows fit no cluster), the cluster one
    for the GRU's, timed there beside the forced L2 instance.  Returns
    {name: [max |err|, ms] or [max relative err, instance(, ms, L2 ms)]}."""
    from taiyaki_tpu_torch.ops import gru, lstm
    h, t, b = 512, 200, 64
    out = {}
    for cell, mod, G, modes in (("lstm", lstm, 4, lstm.EMITS),
                                ("gru", gru, 3, (False, True))):
        fwd = getattr(mod, cell + "_fwd")
        plain = getattr(mod, cell + "_fwd_plain")
        plan, line = plan_of(cell, h, b)
        check(plan.instance == "l2", "{} H={}: plan {}".format(cell, h, line))
        x = _tensor(torch, dev, rng.normal(size=(t, b, h)))
        iW = _tensor(torch, dev, rng.normal(size=(G * h, h)) / np.sqrt(h))
        bias = _tensor(torch, dev, 0.5 * rng.normal(size=G * h))
        sW = _tensor(torch, dev, rng.normal(size=(G * h, h)) / np.sqrt(h))
        key = "emit" if cell == "lstm" else "emit_residuals"
        err = 0.0
        before = {k: c.launches for k, c in fwd.by_instance.items()}
        for mode in modes:
            for reverse in (False, True):
                got, want = (f(x, iW, bias, sW, reverse=reverse,
                               **{key: mode}) for f in (fwd, plain))
                torch.cuda.synchronize()
                got, want = ((got, want) if isinstance(got, tuple)
                             else ((got,), (want,)))
                err = max([err] + [max_abs_diff(g, w)
                                   for g, w in zip(got, want)])
        n = 2 * len(modes)
        after = {k: c.launches for k, c in fwd.by_instance.items()}
        check(after == {"l2": before["l2"] + n, "cluster": before["cluster"]},
              "{} H={}: launches by instance {} -> {}".format(
                  cell, h, before, after))
        check(err <= 1e-4, "{} H={} (L2 instance): max |err| {} > 1e-4"
              .format(cell, h, err))
        ms = cuda_ms(torch, lambda: fwd(x, iW, bias, sW), reps=2)
        say("{}_fwd T={} B={} D=H={} on {}: max|err| {:.3g} (tol 1e-4, "
            "every mode, both directions), {:.3f} ms".format(
                cell, t, b, h, line, err, ms))
        out[cell + "_fwd"] = (err, ms)
        del x, iW, bias, sW
        torch.cuda.empty_cache()
        # the backward chains at H=512: the plan's instance (the LSTM's the
        # L2 one; the GRU's three rows of 32 units fit a cluster of 16)
        bplan, bline = plan_of(cell, h, b, backward=True)
        check(bplan.instance == ("l2" if cell == "lstm" else "cluster"),
              "{} backward H={}: plan {}".format(cell, h, bline))
        for reverse in (False, True):
            for name, fn, plain, args, kw in _bwd_rows(
                    torch, dev, rng, cell, t, b, h, reverse):
                before = {k: c.launches for k, c in fn.by_instance.items()}
                got = fn(*args, reverse=reverse, **kw)
                want = plain(*args, reverse=reverse, **kw)
                torch.cuda.synchronize()
                after = {k: c.launches for k, c in fn.by_instance.items()}
                check(after == dict(before, **{
                    bplan.instance: before[bplan.instance] + 1}),
                      "{} H={}: launches by instance {} -> {}".format(
                          name, h, before, after))
                err = _bwd_diff(torch, name, got, want)
                check(err <= 1e-4, "{} H={}: max relative err {} > "
                      "1e-4".format(name, h, err))
                prev = out.get(name, [0.0])
                out[name] = [max(err, prev[0]), bplan.instance] + prev[2:]
                if bplan.instance == "cluster" and not reverse:
                    # the plan's cluster instance beside the forced L2 one
                    out[name] += [cuda_ms(torch, lambda: fn(*args, **kw),
                                          reps=1), bwd_against_l2(
                        torch, fn, 1, *args, **kw)[1]]
                del got, want, args
        say("{} backwards T={} B={} D=H={} on {}: max relative err {} "
            "(tol 1e-4, both directions)".format(
                cell, t, b, h, bline, {k: v for k, v in out.items()
                                       if k.startswith(cell + "_")
                                       and "bwd" in k}))
        torch.cuda.empty_cache()
    return out


def _bwd_rows(torch, dev, rng, cell, t, b, h, reverse):
    """(name, wrapper, twin, args, keywords) of the cell's backward rows
    (kernels 4, 11, 12, 15 or 8, 13, 17) on one seeded layer's residuals
    at T=t, B=b, H=D=h (the forwards on the card)."""
    from taiyaki_tpu_torch.ops import gru, lstm
    G = 4 if cell == "lstm" else 3
    x = _tensor(torch, dev, rng.normal(size=(t, b, h)))
    iW = _tensor(torch, dev, rng.normal(size=(G * h, h)) / np.sqrt(h))
    bias = _tensor(torch, dev, 0.5 * rng.normal(size=G * h))
    sW = _tensor(torch, dev, rng.normal(size=(G * h, h)) / np.sqrt(h))
    dh = _tensor(torch, dev, rng.normal(size=(t, b, h)))
    if cell == "lstm":
        hh, c, acts, tc = lstm.lstm_fwd(x, iW, bias, sW, reverse=reverse,
                                        emit="acts")
        pre = lstm.lstm_fwd(x, iW, bias, sW, reverse=reverse, emit="pre")[2]
        cp = lstm.prev_state(c, reverse)
        return [("lstm_bwd_acts", lstm.lstm_bwd_acts,
                 lstm.lstm_bwd_acts_plain,
                 (dh, acts, tc, cp, hh, x, sW, iW), {}),
                ("lstm_bwd_fusedw", lstm.lstm_bwd_fusedw,
                 lstm.lstm_bwd_fusedw_plain,
                 (dh, pre, c, cp, hh, x, sW, iW), {}),
                ("lstm_bwd_recompute", lstm.lstm_bwd_recompute,
                 lstm.lstm_bwd_recompute_plain,
                 (dh, c, hh, x, sW, iW, bias), {}),
                ("lstm_scan_bwd", lstm.lstm_scan_bwd,
                 lstm.lstm_scan_bwd_plain, (dh, pre, c, cp, sW),
                 {"iW": iW})]
    hh, gh, gx = gru.gru_fwd(x, iW, bias, sW, reverse=reverse,
                             emit_residuals=True)
    hp = lstm.prev_state(hh, reverse)
    return [("gru_bwd_recompute", gru.gru_bwd_recompute,
             gru.gru_bwd_recompute_plain, (dh, hh, x, sW, iW, bias), {}),
            ("gru_bwd_fusedw", gru.gru_bwd_fusedw, gru.gru_bwd_fusedw_plain,
             (dh, gx, gh, hp, x, sW, iW), {}),
            ("gru_scan_bwd", gru.gru_scan_bwd, gru.gru_scan_bwd_plain,
             (dh, gx, gh, hp, sW), {"iW": iW})]


def _cudnn_bwd_ms(torch, dev, cell, t, b, h, rng):
    """cuDNN's LSTM or GRU backward (torch.nn, bias_hh zero, D=H=h) at
    T=t, B=b, with the input product's gradients: ms, CUDA events."""
    ref = (torch.nn.LSTM(h, h) if cell == "lstm"
           else torch.nn.GRU(h, h)).to(dev)
    xr = _tensor(torch, dev, rng.normal(size=(t, b, h))).requires_grad_()
    dh = _tensor(torch, dev, rng.normal(size=(t, b, h)))
    out = ref(xr)[0]
    ms = cuda_ms(torch, lambda: torch.autograd.grad(
        out, [xr] + list(ref.parameters()), dh, retain_graph=True), reps=2)
    del ref, xr, dh, out
    return ms


def check_bwd_shapes(torch, dev, rng):
    """The seven backward rows (kernels 4, 11, 12, 15; 8, 13, 17) at the
    trainer defaults' batches (H=D=384, 341 chunks and 128, T=150 and 400:
    BWD_T_DIV of their T=600 and 1600) and at the shipped remap model's
    width (H=D=96, B=256, T=250), both directions, on the chain plan's
    (cluster) instance against their twins and the forced L2 instance
    (1e-4 relative); timed beside the L2 instance and cuDNN's backward of
    the same cell.  Returns {"B x T, H": {row: numbers}}."""
    from taiyaki_tpu_torch import train
    out = {}
    shapes = [(DMIN // MLSTM[2] // BWD_T_DIV, train.sub_batch_size_for_chunk(
        DSUB, DMAX, DMIN), DSIZE), (DMAX // MLSTM[2] // BWD_T_DIV, DSUB,
                                    DSIZE), (BWD96_T // BWD_T_DIV, TB, 96)]
    for t, b, h in shapes:
        key = "{} x {}, H={}".format(b, t, h)
        out[key] = {}
        for cell in ("lstm", "gru"):
            plan, line = plan_of(cell, h, b, backward=True)
            check(plan.instance == "cluster", "{} backward H={} B={}: plan "
                  "{}".format(cell, h, b, line))
            err, l2, ms, l2_ms = {}, {}, {}, {}
            for reverse in (False, True):
                for name, fn, plain, args, kw in _bwd_rows(
                        torch, dev, rng, cell, t, b, h, reverse):
                    got = fn(*args, reverse=reverse, **kw)
                    want = plain(*args, reverse=reverse, **kw)
                    torch.cuda.synchronize()
                    err[name] = max(err.get(name, 0.0), _bwd_diff(
                        torch, name, got, want))
                    del got, want
                    diff, l2_t = bwd_against_l2(torch, fn,
                                                0 if reverse else 1, *args,
                                                reverse=reverse, **kw)
                    l2[name] = max(l2.get(name, 0.0), diff)
                    if not reverse:
                        l2_ms[name] = l2_t
                        ms[name] = cuda_ms(torch, lambda: fn(*args, **kw),
                                           reps=2)
                    del args
                torch.cuda.empty_cache()
            lib_ms = _cudnn_bwd_ms(torch, dev, cell, t, b, h, rng)
            torch.cuda.empty_cache()
            for name in err:
                check(err[name] <= 1e-4, "{} at {}: max relative err {} > "
                      "1e-4".format(name, key, err[name]))
                out[key][name] = dict(ms=ms[name], l2_ms=l2_ms[name],
                                      library_ms=lib_ms,
                                      max_rel_err=err[name],
                                      l2_diff=l2[name])
                say("{} T={} B={} D=H={}: max relative err {:.3g} (tol "
                    "1e-4, both directions), kernel {:.3f} ms, forced L2 "
                    "instance {:.3f} ms (relative diff {:.3g}), torch.nn.{} "
                    "backward {:.3f} ms; chain plan {}".format(
                        name, t, b, h, err[name], ms[name], l2_ms[name],
                        l2[name], cell.upper(), lib_ms, line))
    return out


def check_defaults_fwd(torch, dev, rng):
    """The LSTM forward as the trainer-defaults path runs it (size 384,
    emit="acts", the plan's own instance), at the trainer's largest
    sub-batch (341 chunks of 3000 samples: T=600 at stride 5, three waves
    of clusters of 16) and its longest chunks (128 of 8000: T=1600), both
    directions, against its twin and the forced L2 instance (1e-4); timed
    beside the L2 instance and cuDNN's LSTM forward with grad.  Returns
    {"B x T": numbers}."""
    from taiyaki_tpu_torch import train
    from taiyaki_tpu_torch.ops import lstm
    h = d = DSIZE
    out = {}
    for chunk in (DMIN, DMAX):
        b = train.sub_batch_size_for_chunk(DSUB, DMAX, chunk)
        t = chunk // MLSTM[2]
        x = _tensor(torch, dev, rng.normal(size=(t, b, d)))
        iW = _tensor(torch, dev, rng.normal(size=(4 * h, d)) / np.sqrt(d))
        bias = _tensor(torch, dev, 0.5 * rng.normal(size=4 * h))
        sW = _tensor(torch, dev, rng.normal(size=(4 * h, h)) / np.sqrt(h))
        plan, line = plan_of("lstm", h, b)
        check(plan.instance == "cluster", "lstm H={} B={}: plan {}".format(
            h, b, line))
        err = 0.0
        for reverse in (False, True):
            got = lstm.lstm_fwd(x, iW, bias, sW, reverse=reverse,
                                emit="acts")
            want = lstm.lstm_fwd_plain(x, iW, bias, sW, reverse=reverse,
                                       emit="acts")
            torch.cuda.synchronize()
            check(all(g.shape == w.shape and bool(torch.isfinite(g).all())
                      for g, w in zip(got, want)),
                  "lstm_fwd(acts) H={} B={}: bad output".format(h, b))
            err = max([err] + [max_abs_diff(g, w)
                               for g, w in zip(got, want)])
            del got, want
        check(err <= 1e-4, "lstm_fwd(acts) H={} B={} T={}: max |err| {} > "
              "1e-4".format(h, b, t, err))
        l2_diff, l2_ms = against_l2(torch, lstm.lstm_fwd, 1, x, iW, bias, sW,
                                    emit="acts")
        ms = cuda_ms(torch, lambda: lstm.lstm_fwd(x, iW, bias, sW,
                                                  emit="acts"), reps=3)
        plain_ms = cuda_ms(torch, lambda: lstm.lstm_fwd_plain(
            x, iW, bias, sW, emit="acts"), reps=1)
        ref = torch.nn.LSTM(d, h).to(dev)
        with torch.no_grad():
            ref.weight_ih_l0.copy_(iW)
            ref.weight_hh_l0.copy_(sW)
            ref.bias_ih_l0.copy_(bias)
            ref.bias_hh_l0.zero_()
        xr = x.clone().requires_grad_()
        library_ms = cuda_ms(torch, lambda: ref(xr), reps=3)
        nbh = 4 * t * b * h
        bound, by = bound_ms(4 * t * b * d + 4 * 4 * h * (d + h + 1)
                             + 7 * nbh, 2 * t * b * 4 * h * h,
                             2 * t * b * 4 * h * d)
        say("lstm_fwd(acts) T={} B={} D=H={} (trainer defaults, {} samples "
            "a chunk): max|err| {:.3g} (tol 1e-4, both directions), kernel "
            "{:.3f} ms, plain {:.3f} ms, torch.nn.LSTM forward with grad "
            "{:.3f} ms, bound {:.3f} ms ({}); plan {}; forced L2 instance "
            "{:.3f} ms (|diff| {:.3g})".format(
                t, b, h, chunk, err, ms, plain_ms, library_ms, bound, by,
                line, l2_ms, l2_diff))
        out["{} x {}".format(b, t)] = dict(
            ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound,
            max_abs_err=err, l2_ms=l2_ms, l2_diff=l2_diff, plan=line)
        del x, iW, bias, sW, ref, xr
        torch.cuda.empty_cache()
    return out


# The two GEMMs at the layers' shapes: (cell, product, kind, (M, N, K) of a
# gate product or (N1, N2, K rows) of an atb one, the path whose launches
# the row reports, if one runs it): the mLstm and mGru training steps, the
# trainer defaults' largest sub-batch (size 384, 341 chunks x T=600), the
# mLstm basecall batch and the remap model's width (H=96, T=1000, B=256)
GEMM_CASES = (
    ("mLstm training", "gx", "gate", (TT * TB, 4 * H, H), "mLstm training"),
    ("mLstm training", "d_x", "gate", (TT * TB, H, 4 * H), "mLstm training"),
    ("mLstm training", "d_iW, d_sW", "atb", (4 * H, H, TT * TB),
     "mLstm training"),
    ("mGru training", "gx, gh", "gate", (GT * TB, 3 * H, H),
     "mGru training"),
    ("mGru training", "d_x", "gate", (GT * TB, H, 3 * H), "mGru training"),
    ("mGru training", "d_iW, d_sW", "atb", (3 * H, H, GT * TB),
     "mGru training"),
    ("defaults 341 x 600", "gx", "gate", (341 * 600, 4 * DSIZE, DSIZE),
     "mLstm trainer defaults"),
    ("defaults 341 x 600", "d_x", "gate", (341 * 600, DSIZE, 4 * DSIZE),
     "mLstm trainer defaults"),
    ("defaults 341 x 600", "d_iW, d_sW", "atb", (4 * DSIZE, DSIZE,
                                                 341 * 600),
     "mLstm trainer defaults"),
    ("basecall batch", "gx", "gate", (T * B, 4 * H, H), "mLstm basecall"),
    ("remap H=96", "gx", "gate", (BWD96_T * TB, 4 * 96, 96),
     "mGru real reads"),
    ("remap H=96", "d_x", "gate", (BWD96_T * TB, 96, 4 * 96), None),
    ("remap H=96", "d_iW, d_sW", "atb", (4 * 96, 96, BWD96_T * TB), None),
)
GEMM_TOL = 1e-5    # of the largest |output| of the twin


def _gemm_bounds(kind, M, N, K, nsplit):
    """(tc bound, its `by`, simt bound) of one product: the bytes (each
    operand read once, the output written once) against 3 x 2MNK FLOP at
    the TF32 rate, or 2MNK at the f32 SIMT rate."""
    if kind == "gate":
        nbytes = 4 * (M * K + N * K + N + M * N)
    else:
        nbytes = 4 * (K * M + K * N + nsplit * M * N)
    flops = 2 * M * N * K
    tc, by = bound_ms(nbytes, 0, flops)
    return tc, by, bound_ms(nbytes, flops)[0]


def check_gemms(torch, dev):
    """Each GEMM of GEMM_CASES on its plan's tc instance and on the forced
    simt instance (the first slices' kernels), against its twin on the card
    (torch.matmul, TF32 off) within GEMM_TOL of the largest output and
    against an f64 product (reported), timed beside the twin, which is
    also the library call (`library_ms`).  The atb product at the backward
    layer's shift (-B, h one step back); the bias on every gate product.
    Returns the rows, without their launches."""
    from taiyaki_tpu_torch.ops import gemm
    rows = []
    sms = gemm.card_sms(torch.cuda.current_device())
    for cell, what, kind, (M, N, K), path in GEMM_CASES:
        g = torch.Generator(device=dev).manual_seed(M + N + K)
        if kind == "gate":
            A = torch.randn(M, K, device=dev, generator=g)
            W = torch.randn(N, K, device=dev, generator=g) / K ** 0.5
            bias = torch.randn(N, device=dev, generator=g)
            ref = torch.addmm(bias.double(), A.double(), W.double().t())
            args, kw = (A, W, bias), {}
            fn, plain = gemm.gate_gemm, gemm.gate_gemm_plain
            nsplit = 1
        else:
            A = torch.randn(K, M, device=dev, generator=g)
            Bm = torch.randn(K, N, device=dev, generator=g)
            shift = -TB
            ref = A.double().t() @ gemm.shifted(Bm, shift).double()
            args, kw = (A, Bm, shift), {}
            fn = gemm.atb_gemm
            plan = gemm.gemm_plan(M, N, K, gemm.ATB, sms)
            nsplit = plan.nsplit

            def plain(A, Bm, shift, _p=plan):
                return gemm.atb_gemm_plain(A, Bm, shift, _p.nsplit,
                                           _p.kslice)
        want = plain(*args)
        out = {}
        for inst in ("tc", "simt"):
            got = fn(*args, instance=inst, **kw)
            torch.cuda.synchronize()
            if kind == "atb":
                # the simt plan slices otherwise: compare the sums
                err = max_abs_diff(got.sum(0), want.sum(0)) / \
                    want.sum(0).abs().max().item() if inst == "simt" \
                    else max_abs_diff(got, want) / want.abs().max().item()
                got = got.sum(0)
            else:
                err = max_abs_diff(got, want) / want.abs().max().item()
            f64 = ((got.double() - ref).abs().max()
                   / ref.abs().max()).item()
            del got
            check(err <= GEMM_TOL, "{} {} ({}) on {}: {:.3g} of the largest "
                  "output from its twin > {}".format(cell, what, kind, inst,
                                                     err, GEMM_TOL))
            out[inst] = (err, f64, cuda_ms(torch, lambda: fn(
                *args, instance=inst, **kw), reps=5))
        plain_ms = cuda_ms(torch, lambda: plain(*args), reps=5)
        tc_bound, by, simt_bound = _gemm_bounds(kind, M, N, K, nsplit)
        del A, ref, want, args
        torch.cuda.empty_cache()
        flops = 2 * M * N * K
        row = dict(
            name="{}_gemm".format(kind), cell=cell, product=what,
            shape=[M, N, K], route="cuda",
            source="taiyaki_tpu_torch/csrc/gemm_tc.cuh",
            replaces=("taiyaki_tpu/ops/pallas_rnn.py:805" if kind == "gate"
                      else "taiyaki_tpu/ops/pallas_rnn.py:299"),
            path=path, max_abs_err=out["tc"][0], f64_err=out["tc"][1],
            ms=out["tc"][2], plain_ms=plain_ms, bound_ms=tc_bound,
            bound_by=by, library_ms=plain_ms, simt_ms=out["simt"][2],
            simt_bound_ms=simt_bound, simt_err=out["simt"][0],
            simt_f64_err=out["simt"][1],
            tflops=flops / out["tc"][2] / 1e9)
        rows.append(row)
        say("{} {} ({} M={} N={} K={}): tc {:.3f} ms ({:.1f} TFLOP/s of "
            "the f32 product; 3xTF32 bound {:.3f} ms, {}), simt {:.3f} ms "
            "(f32 bound {:.3f}), torch.matmul {:.3f} ms; of the largest "
            "output, from the twin tc {:.3g} simt {:.3g}, from f64 tc {:.3g} "
            "simt {:.3g}".format(
                cell, what, kind, M, N, K, row["ms"], row["tflops"],
                tc_bound, by, row["simt_ms"], simt_bound, plain_ms,
                row["max_abs_err"], row["simt_err"], row["f64_err"],
                row["simt_f64_err"]))
    return rows


def check_offset_views(torch, dev, rng):
    """Contiguous views at an odd float offset (4-byte, not 16-byte
    aligned) as every input of the layers' forwards and backwards (kernels
    1, 4, 7, 8, 11-13; their tc GEMMs take aligned copies), of the logZ
    forward and posteriors (4-byte loads) and of the CRF forward and
    backward (kernels 2, 3, 5, 6) at the basecall width, and of the CRF on
    score streams (kernel 9, kernel 10's two entries): each runs on the
    card and gives the aligned call's results, within 1e-4 relative (the
    layers), 1e-3 + 1e-5 |score| and 1e-4 (logZ, the CRF's score and
    lattices), 1e-5 (posteriors, d lp).  Returns the largest error of
    each."""
    from taiyaki_tpu_torch.ops import crf, gru, logz, lstm

    def offset(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:]
        return buf.view(t.shape).copy_(t)

    def same(what, got, want, tol):
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        err = max(rel_err(g, w) for g, w in zip(got, want))
        check(err <= tol, "{} on offset views: {} > {}".format(what, err,
                                                             tol))
        return err

    t, b, d, h = 200, 64, H, H
    errs = {}
    x = _tensor(torch, dev, rng.normal(size=(t, b, d)))
    for cell, gates, mod in (("lstm", 4, lstm), ("gru", 3, gru)):
        iW = _tensor(torch, dev, rng.normal(size=(gates * h, d)) / 16)
        bias = _tensor(torch, dev, rng.normal(size=gates * h) / 2)
        sW = _tensor(torch, dev, rng.normal(size=(gates * h, h)) / 16)
        dh = _tensor(torch, dev, rng.normal(size=(t, b, h)))
        args = (x, iW, bias, sW)
        off = tuple(offset(a) for a in args)
        if cell == "lstm":
            errs["lstm_fwd"] = same("lstm_fwd", lstm.lstm_fwd(*off),
                                    lstm.lstm_fwd(*args), 1e-4)
            hh, c, acts, tc = lstm.lstm_fwd(*args, emit="acts")
            pre = lstm.lstm_fwd(*args, emit="pre")[2]
            c_prev = lstm.prev_state(c, False)
            rows = (("lstm_bwd_acts", lstm.lstm_bwd_acts,
                     (dh, acts, tc, c_prev, hh, x, sW, iW)),
                    ("lstm_bwd_fusedw", lstm.lstm_bwd_fusedw,
                     (dh, pre, c, c_prev, hh, x, sW, iW)),
                    ("lstm_bwd_recompute", lstm.lstm_bwd_recompute,
                     (dh, c, hh, x, sW, iW, bias)))
        else:
            errs["gru_fwd"] = same("gru_fwd", gru.gru_fwd(*off),
                                   gru.gru_fwd(*args), 1e-4)
            hh, gh, gx = gru.gru_fwd(*args, emit_residuals=True)
            rows = (("gru_bwd_recompute", gru.gru_bwd_recompute,
                     (dh, hh, x, sW, iW, bias)),
                    ("gru_bwd_fusedw", gru.gru_bwd_fusedw,
                     (dh, gx, gh, lstm.prev_state(hh, False), x, sW, iW)))
        for name, fn, a in rows:
            errs[name] = same(name, fn(*(offset(v) for v in a)), fn(*a),
                              1e-4)
    s = _tensor(torch, dev, 5.0 * np.tanh(rng.normal(
        size=(T, B, 2 * NBASE * (NBASE + 1)))))
    f0, z0, l0 = logz.logz_fwd(s)
    f1, z1, l1 = logz.logz_fwd(offset(s))
    z_tol = 1e-3 + 1e-5 * z0.abs().max().item()
    errs["logz_fwd logZ"] = max_abs_diff(z1, z0)
    errs["logz_fwd"] = max(max_abs_diff(l1, l0), max_abs_diff(f1, f0))
    check(errs["logz_fwd logZ"] <= z_tol and errs["logz_fwd"] <= 1e-4,
          "logz_fwd on offset views: {} {}".format(errs["logz_fwd logZ"],
                                                   errs["logz_fwd"]))
    errs["logz_posteriors"] = max_abs_diff(
        logz.logz_posteriors(offset(s), offset(l0)),
        logz.logz_posteriors(s, l0))
    check(errs["logz_posteriors"] <= 1e-5, "logz_posteriors on offset "
          "views: {}".format(errs["logz_posteriors"]))
    lp, seqlens, cargs = _crf_case(torch, dev, rng, 200, 32, 45, SC)
    sidx, midx, mmidx, mfact, valid, last = cargs
    idx = (sidx, midx, mmidx, mfact)
    f0, s0, lat0 = crf.crf_fwd(lp, *idx, valid)
    f1, s1, lat1 = crf.crf_fwd(*(offset(a) for a in (lp,) + idx + (valid,)))
    live = lat0 > crf.NEG / 2
    s_tol = 1e-3 + 1e-5 * s0.abs().max().item()
    check((s1 - s0).abs().max().item() <= s_tol and bool(
        (lat1[~live] <= crf.NEG / 2).all()), "crf_fwd on offset views: "
          "score or impossible states")
    errs["crf_fwd"] = (lat1[live] - lat0[live]).abs().max().item()
    check(errs["crf_fwd"] <= 1e-4, "crf_fwd on offset views: lattice "
          "{}".format(errs["crf_fwd"]))
    errs["crf_bwd"] = max_abs_diff(
        crf.crf_bwd(*(offset(a) for a in (lp,) + idx + (lat0, valid, last))),
        crf.crf_bwd(lp, *idx, lat0, valid, last))
    check(errs["crf_bwd"] <= 1e-5 * mfact.max().item(), "crf_bwd on offset "
          "views: {}".format(errs["crf_bwd"]))
    # kernels 9-10 on streams at an odd float offset (4-byte copies)
    from taiyaki_tpu_torch.ops import flipflop
    stay, move = flipflop._select_streams(lp, *idx)
    f0, s0, lat0 = crf.crf_fwd_streams(stay, move, valid)
    f1, s1, lat1 = crf.crf_fwd_streams(offset(stay), offset(move),
                                       offset(valid))
    live = lat0 > crf.NEG / 2
    s_tol = 1e-3 + 1e-5 * s0.abs().max().item()
    check((s1 - s0).abs().max().item() <= s_tol and bool(
        (lat1[~live] <= crf.NEG / 2).all()), "crf_fwd_streams on offset "
          "views: score or impossible states")
    errs["crf_fwd_streams"] = (lat1[live] - lat0[live]).abs().max().item()
    check(errs["crf_fwd_streams"] <= 1e-4, "crf_fwd_streams on offset views: "
          "lattice {}".format(errs["crf_fwd_streams"]))
    sargs = (stay, move, lat0, valid, last)
    errs["crf_bwd_posteriors"] = max(
        max_abs_diff(a, b) for a, b in zip(
            crf.crf_bwd_posteriors(*(offset(a) for a in sargs)),
            crf.crf_bwd_posteriors(*sargs)))
    errs["crf_grad_streams"] = max_abs_diff(
        crf.crf_grad_streams(*(offset(a) for a in sargs + idx), SC),
        crf.crf_grad_streams(*sargs, *idx, SC))
    check(errs["crf_bwd_posteriors"] <= 1e-5
          and errs["crf_grad_streams"] <= 1e-5 * mfact.max().item(),
          "kernel 10 on offset views: posteriors {}, d lp {}".format(
              errs["crf_bwd_posteriors"], errs["crf_grad_streams"]))
    torch.cuda.synchronize()
    say("offset views (every input at an odd float offset, against the "
        "aligned call; layers relative, logZ, CRF and posteriors absolute): "
        "{}".format(json.dumps(errs)))
    return errs


# -- phases 3 and 4 ----------------------------------------------------------

@contextlib.contextmanager
def count_scatters(torch):
    """Counts the calls of Tensor.scatter_add_ while in the block (a dict
    {"calls": n}): the streams route must make none."""
    calls = {"calls": 0}
    real = torch.Tensor.scatter_add_

    def counted(*args, **kwargs):
        calls["calls"] += 1
        return real(*args, **kwargs)
    torch.Tensor.scatter_add_ = counted
    try:
        yield calls
    finally:
        torch.Tensor.scatter_add_ = real


@contextlib.contextmanager
def switches(env):
    """The residual-policy switches `env` set in os.environ, restored on
    exit."""
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def train_path(torch, work, seed, counters, model, policy=None,
               niter=8, idle=()):
    """The training CLI on the card with the model file of `model` (name,
    path, stride) at size 256 on its mapped reads (`reads_of`), under the
    switch of `policy` (name, environment) if given, for `niter`
    iterations; the kernels `idle` (the default backward) must not
    launch.  Returns (launches, stats, outdir)."""
    from taiyaki_tpu_torch.cli import train_flipflop
    name, model_py, stride = model
    tag = name if policy is None else "{} {}".format(name, policy[0])
    outdir = os.path.join(work, "train_" + tag.replace(" ", "_"))
    for fn in counters.values():
        fn.launches = 0
    with switches({} if policy is None else policy[1]):
        stats = train_flipflop.main([
            "--size", str(H), "--stride", str(stride), "--winlen", "19",
            "--chunk_len_min", str(CHUNK), "--chunk_len_max", str(CHUNK),
            "--min_sub_batch_size", str(TB), "--niteration", str(niter),
            "--warmup_batches", "2", "--save_every", str(niter // 2),
            "--sample_nreads_before_filtering", "1000",
            "--reporting_sub_batches", "1", "--seed", str(seed), "--quiet",
            "--outdir", outdir, model_py, reads_of(model)])
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters.items()}
    for k, n in launches.items():
        # a kernel's instance counter ("name[cluster]") idles with it
        check((n == 0) if k.split("[")[0] in idle else (n > 0),
              "{} training path launched kernel {} {} times".format(
                  tag, k, n))
    with open(os.path.join(outdir, "batch.log")) as fh:
        rows = [line.split("\t") for line in fh.read().splitlines()[1:]]
    losses = [float(r[1]) for r in rows]
    check(len(losses) == niter and all(np.isfinite(losses)),
          "{} batch.log losses {}".format(tag, losses))
    for ckpt in ("model_checkpoint_00001", "model_checkpoint_00002",
                 "model_final"):
        check(os.path.exists(os.path.join(outdir, ckpt + ".checkpoint")),
              "{}: no checkpoint {}".format(tag, ckpt))
    say("training path ({} {}/{}/19, chunk {}, {} chunks, {} iterations): "
        "losses {}; {:.3f} s in the loop (validation and checkpoints "
        "included): {:.4f} steps/s, {:.2f} trained ksample/s; launches "
        "{}".format(tag, H, stride, CHUNK, TB, niter,
                    ", ".join("{:.5f}".format(v) for v in losses),
                    stats["seconds"], stats["iterations"] / stats["seconds"],
                    stats["samples"] / stats["seconds"] / 1e3, launches))
    return launches, stats, outdir


def step_batch(seed, nchunk, model, chunk=CHUNK, size=H):
    """A seeded batch of nchunk chunk-sample chunks from the model's
    mapped reads (with mod categories for a cat_mod model), and the
    factory kwargs of `model` at `size`."""
    from taiyaki_tpu_torch import train
    from taiyaki_tpu_torch.data import chunk_selection, mapped_signal_files
    from taiyaki_tpu_torch.utils import helpers
    stride = model[2]
    with mapped_signal_files.MappedSignalReader(reads_of(model)) as msr:
        alphabet = msr.get_alphabet_information()
        reads = list(msr.reads())
    kwargs = dict(insize=1, size=size, winlen=19, stride=stride,
                  alphabet_info=alphabet)
    labels = {}
    if is_cat_mod(model):
        head = helpers.new_model(model[1], **kwargs)[0].sublayers[-1]
        labels = dict(can_labels=head.can_labels, mod_labels=head.mod_labels)
    np.random.seed(seed)
    fp = chunk_selection.sample_filter_parameters(
        reads, 200, chunk, 3.0, 10.0, 0.5, 5, 1.1)
    batch, _ = train.sample_batch(reads, chunk, nchunk,
                                  train.max_seqlen_for_chunk(chunk, stride),
                                  alphabet, fp, seqlen_granularity=128,
                                  **labels)
    return batch, kwargs


def loss_args(net):
    """make_grad_step's cat_mod arguments for `net` (unit weights) and
    the mod factor of the --mod_factor ramp's start; none for a canonical
    net."""
    from taiyaki_tpu_torch import layers
    if not layers.is_cat_mod_model(net):
        return (), ()
    head = net.sublayers[-1]
    weights = np.ones(head.ncan_base + head.nmod_base, np.float32)
    return (True, head.can_mods_offsets, weights), (8.0,)


def new_net(seed, kwargs, device, model):
    from taiyaki_tpu_torch.convert import load_jax_params
    from taiyaki_tpu_torch.utils import helpers
    net, _, _ = helpers.new_model(model[1], **kwargs)
    params = net.init(np.random.default_rng(seed))
    return load_jax_params(net, params).to(device)


def card_vs_cpu(torch, dev, seed, model, policies=(), nchunk=8,
                chunk=CHUNK, size=H):
    """One training step's loss and gradients on the card and on the CPU
    twins, same batch and weights (nchunk chunks of `chunk` samples, the
    model at `size`; full width, 8 chunks by default): by default, and
    under each of `policies` (name, switches), whose card gradients must
    also equal the default's on the card.  Tolerances: loss 1e-5 relative
    (f32 sums in another order through 800 or 2000 steps of 5 recurrent
    layers and the lattice); each gradient 1e-5 of its tensor's largest
    value.  A cat_mod step weighs the mod columns x8, the --mod_factor
    ramp's start."""
    from taiyaki_tpu_torch import train
    from taiyaki_tpu_torch.convert import leaf_names
    batch, kwargs = step_batch(seed, nchunk, model, chunk, size)
    names = None

    def step(device, env):
        nonlocal names
        with switches(env):
            net = new_net(seed, kwargs, device, model)
            args, factor = loss_args(net)
            t0 = time.perf_counter()
            loss, grads = train.make_grad_step(net, *args)(
                train.batch_to_device(batch, device), 1.0, *factor)
            grads = [g.cpu() for g in grads]
        names = leaf_names(net)
        return float(loss), grads, time.perf_counter() - t0

    def compare(what, a, b):
        l_err = abs(a[0] - b[0]) / max(1.0, abs(b[0]))
        errs = [rel_err(x, y) for x, y in zip(a[1], b[1])]
        worst = names[int(np.argmax(errs))]
        check(l_err <= 1e-5, "{} ({}): loss {} vs {}".format(
            what, model[0], a[0], b[0]))
        check(max(errs) <= 1e-5, "{} ({}): gradient err {} ({})".format(
            what, model[0], max(errs), worst))
        return ("loss {} vs {} (relative err {:.3g}, tol 1e-5); {} "
                "gradients, largest relative err {:.3g} in {} (tol "
                "1e-5)".format(a[0], b[0], l_err, len(a[1]), max(errs),
                               worst))

    card, cpu = step(dev, {}), step(torch.device("cpu"), {})
    say("card vs CPU, one {} step ({} chunks x {} samples, size {}): {}; CPU "
        "twins {:.1f} s".format(model[0], batch.signal.shape[1], chunk, size,
                                compare("card vs CPU", card, cpu), cpu[2]))
    for name, env in policies:
        pcard, pcpu = step(dev, env), step(torch.device("cpu"), env)
        say("{} {} step: card vs the default on the card: {} (loss {}); "
            "card vs CPU: {}; CPU twins {:.1f} s".format(
                model[0], name, compare(name + " vs default", pcard, card),
                "bitwise equal" if pcard[0] == card[0] else "not bitwise",
                compare(name + " card vs CPU", pcard, pcpu), pcpu[2]))


def layer_bwd_ms(torch, dev, model, policy, T):
    """Forward with grad and backward (ms, CUDA events) of one recurrent
    layer of `model` under `policy`, at the training step's shape (T
    blocks, 256 chunks, H=D=256); the backward runs on a retained graph
    and must give the same gradients every time."""
    from taiyaki_tpu_torch.ops import rnn
    cell = "lstm" if model is MLSTM else "gru"
    G = (4 if cell == "lstm" else 3) * H
    rng = np.random.default_rng(0)
    leaves = [_tensor(torch, dev, a).requires_grad_() for a in (
        rng.normal(size=(T, TB, H)), rng.normal(size=(G, H)) / np.sqrt(H),
        0.5 * rng.normal(size=G), rng.normal(size=(G, H)) / np.sqrt(H))]
    dh = _tensor(torch, dev, rng.normal(size=(T, TB, H)))
    layer = rnn.lstm_layer if cell == "lstm" else rnn.gru_layer
    with switches(policy[1]):
        f_ms = cuda_ms(torch, lambda: layer(*leaves), reps=2)
        h = layer(*leaves)
    first = torch.autograd.grad(h, leaves, dh, retain_graph=True)
    b_ms = cuda_ms(torch, lambda: torch.autograd.grad(
        h, leaves, dh, retain_graph=True), reps=3)
    again = torch.autograd.grad(h, leaves, dh)
    check(all(bool(torch.equal(a, b)) for a, b in zip(first, again)),
          "{} {}: a retained graph gave other gradients".format(
              model[0], policy[0]))
    return f_ms, b_ms


def timed_step(torch, dev, seed, model, batch, kwargs, remat=False):
    """A full training step of `model` on `batch` (seeded weights, AdamW,
    no clip; a cat_mod model at the mod factor of loss_args; with remat,
    each layer's forward run again in the backward pass): the mean
    synchronised wall time (ms) of 2 steps after a warm-up and the peak
    device memory (bytes, torch.cuda.max_memory_allocated) over them.
    Returns (step ms, peak, net, batch on the device)."""
    from taiyaki_tpu_torch import layers, train
    net = new_net(seed, kwargs, dev, model)
    layers.set_remat(net, remat)
    args, factor = loss_args(net)
    params = train.leaf_params(net)
    opt, _ = train.make_optimizer(params, 4e-3, 8, 2, 1e-4, 1e-4)
    threshs = np.full(len(params), np.inf, np.float32)
    b = train.batch_to_device(batch, dev)
    step = train.make_train_step(net, opt, *args)
    step(b, 1.0, threshs, *factor)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    for _ in range(2):
        step(b, 1.0, threshs, *factor)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / 2
    return step_ms, torch.cuda.max_memory_allocated(dev), net, b


def policy_steps(torch, dev, seed):
    """Each residual policy's full training step (256 chunks x CHUNK
    samples; mean synchronised wall time of 2 steps after a warm-up) and
    its peak device memory (torch.cuda.max_memory_allocated over one
    step), with one layer's forward and backward at the step's shape.
    Returns {(model, policy): numbers}."""
    out = {}
    for model, policies in ((MLSTM, LSTM_POLICIES), (MGRU, GRU_POLICIES)):
        batch, kwargs = step_batch(seed, TB, model)
        for policy in policies:
            with switches(policy[1]):
                step_ms, peak = timed_step(torch, dev, seed, model, batch,
                                           kwargs)[:2]
            torch.cuda.empty_cache()
            f_ms, b_ms = layer_bwd_ms(torch, dev, model, policy,
                                      CHUNK // model[2])
            torch.cuda.empty_cache()
            out[model[0], policy[0]] = dict(
                step_ms=step_ms, peak_gb=peak / 1e9, layer_fwd_ms=f_ms,
                layer_bwd_ms=b_ms)
            say("residual policy {} {}: training step {:.3f} ms ({} chunks x "
                "{} samples), peak device memory {:.3f} GB; one layer at "
                "T={}, B={}, H=D={}: forward with grad {:.3f} ms, backward "
                "{:.3f} ms".format(model[0], policy[0], step_ms, TB, CHUNK,
                                   peak / 1e9, CHUNK // model[2], TB, H,
                                   f_ms, b_ms))
    return out


def scan_path(torch, dev, rng, counters, pick):
    """The public ops `lstm_scan` and `gru_scan` (taiyaki_tpu_torch/ops/
    rnn.py) forward and backward through torch.autograd.grad, both
    directions, at the mLstm (T=TT) and mGru (T=GT) training shapes (B=TB,
    H=D=256), each cell's counters (kernels 14-17) set to 0 just before
    its path and read just after.  Then, on the same inputs, scan(x . iW^T
    + b, sW) against the whole layer on x (lstm_layer on kernels 1 and 4,
    gru_layer on 7 and 8): h within 1e-4; d gates_x . iW against the
    layer's d_x and d_sW against the layer's, 1e-4 relative.  Returns
    {"lstm_scan": launches, "gru_scan": launches}."""
    from taiyaki_tpu_torch.ops import rnn
    launches = {}
    for cell, t, G in (("lstm", TT, 4), ("gru", GT, 3)):
        scan, layer = ((rnn.lstm_scan, rnn.lstm_layer) if cell == "lstm"
                       else (rnn.gru_scan, rnn.gru_layer))
        x = _tensor(torch, dev, rng.normal(size=(t, TB, H)))
        iW = _tensor(torch, dev, rng.normal(size=(G * H, H)) / np.sqrt(H))
        b = _tensor(torch, dev, 0.5 * rng.normal(size=G * H))
        sW = _tensor(torch, dev, rng.normal(size=(G * H, H)) / np.sqrt(H))
        dh = _tensor(torch, dev, rng.normal(size=(t, TB, H)))
        names = tuple(pick((cell + "_scan_fwd", cell + "_scan_bwd")))
        for k in names:
            counters[k].launches = 0
        out = {}
        for reverse in (False, True):
            gx = (torch.matmul(x, iW.t()) + b).requires_grad_()
            swr = sW.clone().requires_grad_()
            h = scan(gx, swr, reverse=reverse)
            out[reverse] = (h.detach(),) + torch.autograd.grad(
                h, (gx, swr), dh)
            del h, gx
        torch.cuda.synchronize()
        launches[cell + "_scan"] = {k: counters[k].launches for k in names}
        check(all(n > 0 for n in launches[cell + "_scan"].values()),
              "{}_scan path: launches {}".format(cell,
                                                 launches[cell + "_scan"]))
        h_err = dx_err = dsw_err = 0.0
        for reverse in (False, True):
            leaves = [a.clone().requires_grad_() for a in (x, iW, b, sW)]
            hl = layer(*leaves, reverse=reverse)
            d_x, _, _, d_swl = torch.autograd.grad(hl, leaves, dh)
            h, d_gx, d_sw = out.pop(reverse)
            check(all(bool(torch.isfinite(a).all()) for a in (h, d_gx, d_sw)),
                  "{}_scan path: non-finite output".format(cell))
            h_err = max(h_err, max_abs_diff(h, hl.detach()))
            dx_err = max(dx_err, rel_err(torch.matmul(d_gx, iW), d_x))
            dsw_err = max(dsw_err, rel_err(d_sw, d_swl))
            del leaves, hl, d_x, d_swl, h, d_gx, d_sw
        torch.cuda.empty_cache()
        check(h_err <= 1e-4 and max(dx_err, dsw_err) <= 1e-4,
              "{}_scan against {}_layer: h {}, d_x {}, d_sW {}".format(
                  cell, cell, h_err, dx_err, dsw_err))
        say("{}_scan path T={} B={} H={} (autograd, both directions): "
            "launches {}; against {}_layer on x: h max|err| {:.3g} (tol "
            "1e-4), d gates_x . iW vs d_x {:.3g}, d_sW {:.3g} (relative, "
            "tol 1e-4)".format(cell, t, TB, H, launches[cell + "_scan"],
                               cell, h_err, dx_err, dsw_err))
    return launches


def defaults_path(torch, work, seed, counters):
    """The training CLI at the JAX trainer's own defaults: mLstm_flipflop
    at --size 384 (DSIZE), chunks of 3000-8000 samples in its 8 buckets
    and sub-batches of 341 ... 128 chunks, a new T each step; 4
    iterations (warmup 2, checkpoints and one validation batch at 2 and
    4).  Every kernel of the path launched, every loss finite, the chunk
    lengths the buckets'.  Returns (launches, stats)."""
    from taiyaki_tpu_torch import train
    from taiyaki_tpu_torch.cli import train_flipflop
    outdir = os.path.join(work, "train_defaults")
    for fn in counters.values():
        fn.launches = 0
    # the defaults' values, named so that a rehearsal can shrink them
    stats = train_flipflop.main([
        "--size", str(DSIZE), "--chunk_len_min", str(DMIN),
        "--chunk_len_max", str(DMAX), "--min_sub_batch_size", str(DSUB),
        "--niteration", "4", "--warmup_batches", "2", "--save_every", "2",
        "--sample_nreads_before_filtering", "1000",
        "--reporting_sub_batches", "1", "--seed", str(seed), "--quiet",
        "--outdir", outdir, MLSTM[1], READS_HDF5])
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters.items()}
    check(all(n > 0 for n in launches.values()),
          "trainer defaults path: launches {}".format(launches))
    with open(os.path.join(outdir, "batch.log")) as fh:
        rows = [line.split("\t") for line in fh.read().splitlines()[1:]]
    losses = [float(r[1]) for r in rows]
    lens = [int(r[5]) for r in rows]
    buckets = train.chunk_len_buckets(DMIN, DMAX, MLSTM[2])
    check(len(losses) == 4 and all(np.isfinite(losses))
          and set(lens) <= set(buckets),
          "trainer defaults path: losses {}, chunk lengths {}".format(
              losses, lens))
    say("trainer defaults path (mLstm {}/5/19, buckets {}, 4 iterations): "
        "chunk lengths {}, sub-batches {} chunks; losses {}; {:.3f} s in "
        "the loop: {:.4f} steps/s, {:.2f} trained ksample/s; launches "
        "{}".format(DSIZE, buckets, lens, [
            train.sub_batch_size_for_chunk(DSUB, DMAX, n) for n in lens],
            ", ".join("{:.5f}".format(v) for v in losses), stats["seconds"],
            stats["iterations"] / stats["seconds"],
            stats["samples"] / stats["seconds"] / 1e3, launches))
    return launches, stats


def defaults_steps(torch, dev, seed):
    """A training step of mLstm_flipflop at size 384 at the trainer's
    largest sub-batch (341 chunks of 3000 samples) and at its longest
    chunks (128 of 8000): mean synchronised wall time of 2 steps after a
    warm-up, and peak device memory.  Returns {shape: numbers}."""
    from taiyaki_tpu_torch import train
    out = {}
    for chunk in (DMIN, DMAX):
        nchunk = train.sub_batch_size_for_chunk(DSUB, DMAX, chunk)
        batch, kwargs = step_batch(seed, nchunk, MLSTM, chunk, DSIZE)
        step_ms, peak = timed_step(torch, dev, seed, MLSTM, batch,
                                   kwargs)[:2]
        torch.cuda.empty_cache()
        n = batch.signal.shape[1]
        out["{} x {}".format(n, chunk)] = dict(
            step_ms=step_ms, peak_gb=peak / 1e9, L=batch.seqs.shape[1],
            ksample_per_s=n * chunk / step_ms)
        say("trainer defaults step (mLstm {}/5/19, {} chunks x {} samples, "
            "L={}): {:.3f} ms, {:.2f} trained ksample/s, peak device memory "
            "{:.3f} GB".format(DSIZE, n, chunk, batch.seqs.shape[1],
                               step_ms, n * chunk / step_ms, peak / 1e9))
    return out


# -- phase 5 -----------------------------------------------------------------

def same_losses(outdir, other, n):
    """The batch.log losses of the training run in `other` equal the
    first n of `outdir`'s (1e-5 relative)."""
    logs = []
    for d in (outdir, other):
        with open(os.path.join(d, "batch.log")) as fh:
            logs.append([float(line.split("\t")[1])
                         for line in fh.read().splitlines()[1:]][:n])
    err = max(abs(a - b) / max(1.0, abs(b)) for a, b in zip(*logs))
    check(len(logs[1]) == n and err <= 1e-5,
          "losses {} vs {} (relative err {})".format(logs[1], logs[0], err))
    say("the {} losses of {} equal {}'s first {} (max relative err {:.3g}, "
        "tol 1e-5)".format(n, os.path.basename(other),
                           os.path.basename(outdir), n, err))


def write_reads(path, names, lengths, rng):
    """A multi-read fast5 of synthetic step-like signals."""
    from taiyaki_tpu_torch.data.hdf5 import Writer
    with Writer(path) as f5:
        for rid, n in zip(names, lengths):
            levels = rng.normal(500.0, 60.0, size=n // 8 + 1)
            dacs = np.repeat(levels, 8)[:n] + rng.normal(0, 8.0, size=n)
            grp = f5.create_group("read_" + rid)
            ch = grp.create_group("channel_id")
            for k, v in (("digitisation", 8192.0), ("offset", 4.0),
                         ("range", 1400.0), ("sampling_rate", 4000.0)):
                ch.attrs[k] = v
            raw = grp.create_group("Raw")
            raw.attrs["read_id"] = rid
            raw.attrs["start_time"] = 0
            raw.attrs["duration"] = n
            raw.create_dataset("Signal", data=dacs.astype("i2"))


def read_fastx(path):
    with open(path) as fh:
        lines = fh.read().splitlines()
    step = 4 if lines and lines[0].startswith("@") else 2
    return {lines[i][1:]: lines[i + 1] for i in range(0, len(lines), step)}


def semiglobal_identity(call, ref):
    """1 - (edit distance of `ref` against the best-matching stretch of
    `call`) / len(ref): the call's unaligned ends are free, every base of
    the reference counts."""
    a = np.frombuffer(ref.encode(), np.uint8)
    b = np.frombuffer(call.encode(), np.uint8)
    j = np.arange(len(b) + 1)
    prev = np.zeros(len(b) + 1, np.int64)     # leading call bases free
    for i in range(1, len(a) + 1):
        cur = np.empty_like(prev)
        cur[0] = i
        cur[1:] = np.minimum(prev[1:] + 1, prev[:-1] + (b != a[i - 1]))
        # a call base against no reference base, along the row
        prev = np.minimum.accumulate(cur - j) + j
    return 1.0 - prev.min() / len(a)          # trailing call bases free


def path_score(trans, path, nbase):
    """Score of a flip-flop state path [T+1] under scores [T, S]."""
    nff = 2 * nbase
    src, dst = path[:-1], path[1:]
    col = np.where(dst < nbase, dst * nff + src, nff * nbase + src)
    start = 0.0 if path[0] < nbase else -1e30
    return start + float(trans[np.arange(len(src)), col].sum())


def tie_check(torch, model, reads_dir, read_ids, dev, mods=False):
    """Per chunk of `read_ids`: the card's Viterbi path against the CPU's;
    a differing path must score the CPU's best within 1e-4 under the CPU's
    scores.  Returns (chunks, differing chunks, max |score gap|, max
    |posterior difference|), and with `mods` (a cat_mod model) the max
    |difference| of the mod columns, card against CPU."""
    from taiyaki_tpu_torch.cli import basecall
    from taiyaki_tpu_torch.convert import load_jax_params
    from taiyaki_tpu_torch.data import fast5utils
    from taiyaki_tpu_torch.utils import helpers
    wanted = {}
    for fname, rid in fast5utils.iterate_fast5_reads(reads_dir):
        if rid in read_ids:
            wanted[rid] = fname
    net, params, *_ = helpers.load_model(model)
    stride = net.stride
    chunks = np.concatenate([basecall.prepare_read(
        rid, basecall.get_signal(wanted[rid], rid), T * stride,
        100 * stride, None, False)["chunks"] for rid in read_ids], axis=1)
    res = []
    for device in (dev, torch.device("cpu")):
        net = load_jax_params(net, params).to(device).eval()
        caller = basecall.Basecaller(net, 40, True, 1.0, chunks.shape[1],
                                     device, want_trans=True, want_mods=mods)
        with torch.inference_mode():
            out = caller.call_chunks(torch.from_numpy(chunks).to(device))
        res.append({k: v.cpu().numpy() for k, v in out.items()})
    gpu, cpu = res
    ndiff, gap = 0, 0.0
    for i in range(chunks.shape[1]):
        if np.array_equal(gpu["paths"][:, i], cpu["paths"][:, i]):
            continue
        ndiff += 1
        best = path_score(cpu["trans"][:, i], cpu["paths"][:, i], NBASE)
        got = path_score(cpu["trans"][:, i], gpu["paths"][:, i], NBASE)
        gap = max(gap, abs(best - got))
    check(gap <= 1e-4, "card Viterbi path scores {} below the CPU's best "
          "(tie tolerance 1e-4)".format(gap))
    trans_err = float(np.abs(np.exp(gpu["trans"]) - np.exp(cpu["trans"]))
                      .max())
    if mods:
        return (chunks.shape[1], ndiff, gap, trans_err,
                float(np.abs(gpu["mods"] - cpu["mods"]).max()))
    return chunks.shape[1], ndiff, gap, trans_err


def main_path(torch, dev, seed, work, model, counters, tag):
    """Basecall synthetic reads with the checkpoint `model` through the
    basecall CLI on the card; returns (launches, stats, reads dir)."""
    from taiyaki_tpu_torch.cli import basecall
    rng = np.random.default_rng(seed)
    reads = os.path.join(work, "reads_" + tag)
    os.makedirs(reads)
    names = ["read{:02d}".format(i) for i in range(9)]
    lengths = [100000] * 8 + [3000]          # the last is under one chunk
    write_reads(os.path.join(reads, "batch0.fast5"), names[:5], lengths[:5],
                rng)
    write_reads(os.path.join(reads, "batch1.fast5"), names[5:], lengths[5:],
                rng)
    nsample = sum(lengths)

    for fn in counters.values():
        fn.launches = 0
    fa = os.path.join(work, tag + ".fa")
    stats = basecall.main(["--output", fa, "--quiet", reads, model])
    launches = {name: fn.launches for name, fn in counters.items()}
    torch.cuda.synchronize()
    calls = read_fastx(fa)
    # a read whose call is empty gets no record (as in bin/basecall.py);
    # a briefly trained model calls few bases, so count reads processed
    check(stats["nread"] == len(names) and set(calls) <= set(names)
          and len(calls) == stats["ncalled"] > 0,
          "fasta: {} of {} reads processed, records {}".format(
              stats["nread"], len(names), sorted(calls)))
    check(stats["nsample"] == nsample, "fasta: samples {}".format(
        stats["nsample"]))
    for name, n in launches.items():
        check(n > 0, "basecall path never launched kernel {}".format(name))
    say("basecall path ({}; fasta, defaults): {} reads, {} samples, {} bases "
        "in {:.3f} s: {:.3f} reads/s, {:.3f} ksample/s, {:.3f} kbase/s; "
        "launches {}".format(
            tag, stats["ncalled"], stats["nsample"], stats["nbase"],
            stats["seconds"], stats["ncalled"] / stats["seconds"],
            stats["nsample"] / stats["seconds"] / 1e3,
            stats["nbase"] / stats["seconds"] / 1e3, launches))

    fq = os.path.join(work, tag + ".fq")
    stats_q = basecall.main(["--output", fq, "--quiet", "--fastq", reads,
                             model])
    with open(fq) as fh:
        lines = fh.read().splitlines()
    check(len(lines) == 4 * len(calls), "fastq: {} lines".format(len(lines)))
    for i in range(0, len(lines), 4):
        check(lines[i + 1] == calls[lines[i][1:]]
              and len(lines[i + 3]) == len(lines[i + 1]),
              "fastq call of {} differs from fasta".format(lines[i][1:]))
    say("basecall path ({}; fastq): {} reads in {:.3f} s: {:.3f} ksample/s"
        .format(tag, stats_q["ncalled"], stats_q["seconds"],
        stats_q["nsample"] / stats_q["seconds"] / 1e3))

    cpu_fa = os.path.join(work, tag + "_cpu.fa")
    basecall.main(["--output", cpu_fa, "--quiet", "--device", "cpu",
                   "--limit", "2", reads, model])
    cpu_calls = read_fastx(cpu_fa)
    first = names[:2]
    nchunk, ndiff, gap, trans_err = tie_check(torch, model, reads, first,
                                              dev)
    same = [rid for rid in first if cpu_calls.get(rid) == calls.get(rid)]
    check(len(same) == 2 or ndiff > 0,
          "card and CPU calls differ with equal chunk paths")
    say("card vs CPU on {} reads: {} identical calls; {} of {} chunks with "
        "another Viterbi path (score gap {:.3g}, tol 1e-4); max |posterior "
        "diff| {:.3g}".format(len(first), len(same), ndiff, nchunk, gap,
                              trans_err))
    return launches, stats, reads


def write_real_reads(path, mapped=READS_HDF5):
    """The reads of a mapped-signal file of the repo as one fast5
    (hdf5.Writer, as a machine without h5py writes it); returns {read id:
    (reference sequence, samples)}."""
    from taiyaki_tpu_torch.data import mapped_signal_files
    with mapped_signal_files.MappedSignalReader(mapped) as msr:
        alphabet = msr.get_alphabet_information().alphabet
        reads = list(msr.reads())
    write_fast5(path, [(r.read_id, r, r.Dacs) for r in reads])
    return {r.read_id: ("".join(alphabet[i] for i in r.Reference),
                        len(r.Dacs)) for r in reads}


def write_fast5(path, reads):
    """A multi-read fast5 (hdf5.Writer) of (read id, the mapped read whose
    channel it takes, samples)."""
    from taiyaki_tpu_torch.data.hdf5 import Writer
    with Writer(path) as f5:
        for rid, r, dacs in reads:
            grp = f5.create_group("read_" + rid)
            ch = grp.create_group("channel_id")
            for k in ("digitisation", "offset", "range"):
                ch.attrs[k] = getattr(r, k)
            ch.attrs["sampling_rate"] = 4000.0
            raw = grp.create_group("Raw")
            raw.attrs["read_id"] = rid
            raw.attrs["start_time"] = 0
            raw.attrs["duration"] = len(dacs)
            raw.create_dataset("Signal", data=dacs.astype("i2"))


def real_reads(torch, dev, work, counters):
    """The three real reads called with the shipped mGru remap checkpoint
    by the basecall CLI with its defaults on the card, then on the CPU
    twins: every read gets a record, the calls are equal (or the Viterbi
    tie rule of main_path holds), each identity is at least 0.80."""
    from taiyaki_tpu_torch.cli import basecall
    reads = os.path.join(work, "reads_real")
    os.makedirs(reads)
    refs = write_real_reads(os.path.join(reads, "real.fast5"))
    for fn in counters.values():
        fn.launches = 0
    fa = os.path.join(work, "real.fa")
    stats = basecall.main(["--output", fa, "--quiet", reads, REMAP_MODEL])
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters.items()}
    calls = read_fastx(fa)
    check(sorted(calls) == sorted(refs), "real reads: records {} of {}"
          .format(sorted(calls), sorted(refs)))
    for k, n in launches.items():
        check(n > 0, "real-read basecall never launched kernel {}".format(k))
    cpu_fa = os.path.join(work, "real_cpu.fa")
    basecall.main(["--output", cpu_fa, "--quiet", "--device", "cpu", reads,
                   REMAP_MODEL])
    cpu_calls = read_fastx(cpu_fa)
    same = [rid for rid in refs if cpu_calls.get(rid) == calls[rid]]
    nchunk, ndiff, gap, trans_err = tie_check(torch, REMAP_MODEL, reads,
                                              sorted(refs), dev)
    check(len(same) == len(refs) or ndiff > 0,
          "real reads: card and CPU calls differ with equal chunk paths")
    ident = {rid: semiglobal_identity(calls[rid], ref)
             for rid, (ref, _) in refs.items()}
    say("real reads (shipped mGru remap checkpoint, size 96, stride 4; "
        "defaults): {} reads, {} samples, {} bases in {:.3f} s: {:.3f} "
        "ksample/s; launches {}; card vs CPU: {} of {} calls identical, {} "
        "of {} chunks with another Viterbi path (score gap {:.3g}, tol "
        "1e-4), max |posterior diff| {:.3g}; semi-global identity against "
        "the reference: {}".format(
            stats["ncalled"], stats["nsample"], stats["nbase"],
            stats["seconds"], stats["nsample"] / stats["seconds"] / 1e3,
            launches, len(same), len(refs), ndiff, nchunk, gap, trans_err,
            ", ".join("{} ({} samples, {} bases called, reference {}) "
                      "{:.4f}".format(rid, refs[rid][1], len(calls[rid]),
                                      len(refs[rid][0]), ident[rid])
                      for rid in sorted(refs))))
    worst = min(ident.values())
    check(worst >= 0.80, "real reads: identity {:.4f} < 0.80".format(worst))
    return launches, stats


# training-data preparation: each real read written this many more times,
# and the longest tiled this many times into one long read
PREP_COPIES, PREP_TILE = 31, 4
READ_PARAMS = os.path.join(ROOT, "RESULTS", "training_ingredients",
                           "readparams.tsv")


def write_prepare_inputs(d):
    """The inputs of the data-preparation phase under `d`: fast5 reads in
    all/ (the real reads, PREP_COPIES copies of each, the long read),
    orig/ (the real reads) and long/ (the long read), refs.fa and
    params.tsv (each read with its original's row of readparams.tsv).
    Returns {read id: (original's read id, Dacs, integer Reference)}."""
    from taiyaki_tpu_torch.data import mapped_signal_files
    with mapped_signal_files.MappedSignalReader(READS_HDF5) as msr:
        alphabet = msr.get_alphabet_information().alphabet
        reads = sorted(msr.reads(), key=lambda r: r.read_id)
    with open(READ_PARAMS) as fh:
        lines = fh.read().splitlines()
    rows = {line.split("\t")[0]: line.split("\t")[1:] for line in lines[1:]}
    longest = max(reads, key=lambda r: len(r.Dacs))
    records = {}
    for r in reads:
        records[r.read_id] = (r.read_id, r.Dacs, r.Reference, r)
        for k in range(PREP_COPIES):
            records["{}-copy{:02d}".format(r.read_id, k)] = (
                r.read_id, r.Dacs, r.Reference, r)
    records[longest.read_id + "-x{}".format(PREP_TILE)] = (
        longest.read_id, np.tile(longest.Dacs, PREP_TILE),
        np.tile(longest.Reference, PREP_TILE), longest)
    dirs = {"all": list(records), "orig": [r.read_id for r in reads],
            "long": [longest.read_id + "-x{}".format(PREP_TILE)]}
    for name, rids in dirs.items():
        os.makedirs(os.path.join(d, name))
        write_fast5(os.path.join(d, name, "reads.fast5"),
                    [(rid, records[rid][3], records[rid][1])
                     for rid in rids])
    with open(os.path.join(d, "refs.fa"), "w") as fh:
        for rid, (_, _, ref, _) in records.items():
            fh.write(">{}\n{}\n".format(rid, "".join(alphabet[i]
                                                      for i in ref)))
    with open(os.path.join(d, "params.tsv"), "w") as fh:
        fh.write(lines[0] + "\n")
        for rid, (orig, _, _, _) in records.items():
            fh.write("\t".join([rid] + rows[orig]) + "\n")
    return {rid: rec[:3] for rid, rec in records.items()}


def near_tie(a, b):
    """The JAX package's rule for two remappings of one read whose
    forwards round differently (tests/test_misc_cli.py:210-219): under 1%
    of Ref_to_signal entries moved, none by more than 32 samples.  (share
    moved, largest move, holds)."""
    if a.shape != b.shape:
        return 1.0, None, False
    moved = np.abs(a.astype(np.int64) - b.astype(np.int64))
    share, most = float((moved > 0).mean()), int(moved.max())
    return share, most, share < 0.01 and most <= 32


def read_mapped(path):
    """{read id: SignalMapping} of a mapped-signal file (the port's
    reader), and its check()."""
    from taiyaki_tpu_torch.data import mapped_signal_files
    with mapped_signal_files.MappedSignalReader(path) as msr:
        return {r.read_id: r for r in msr}, msr.check()


# the remap path's largest batches of the real reads: 8 reads of 34 816
# padded samples, T = 8704 blocks at the remap model's stride 4 (H=96) and
# 6964 at mLstm's stride 5 (H=256)
REMAP_SHAPES = (("gru", 8704, 96), ("lstm", 6964, 256))


def check_remap_shapes(torch, dev, rng, shapes=REMAP_SHAPES, b=8):
    """Rows 7 and 1 at the remap path's shapes (B=8 whole reads) against
    their twins (1e-4, both directions), timed beside the twin and cuDNN;
    returns {row: its numbers}."""
    from taiyaki_tpu_torch.ops import gru, lstm
    out = {}
    for cell, t, h in shapes:
        gates = 3 if cell == "gru" else 4
        op, plain = ((gru.gru_fwd, gru.gru_fwd_plain) if cell == "gru"
                     else (lstm.lstm_fwd, lstm.lstm_fwd_plain))
        x = _tensor(torch, dev, rng.normal(size=(t, b, h)))
        iW = _tensor(torch, dev, rng.normal(size=(gates * h, h)) / np.sqrt(h))
        bias = _tensor(torch, dev, 0.5 * rng.normal(size=gates * h))
        sW = _tensor(torch, dev, rng.normal(size=(gates * h, h)) / np.sqrt(h))
        err = 0.0
        for reverse in (False, True):
            got = op(x, iW, bias, sW, reverse=reverse)
            want = plain(x, iW, bias, sW, reverse=reverse)
            torch.cuda.synchronize()
            check(got.shape == want.shape and bool(torch.isfinite(got).all()),
                  "{}_fwd at T={} B={}: bad output".format(cell, t, b))
            err = max(err, max_abs_diff(got, want))
        check(err <= 1e-4, "{}_fwd at T={} B={}: max |err| {} > 1e-4".format(
            cell, t, b, err))
        ms = cuda_ms(torch, lambda: op(x, iW, bias, sW), reps=3)
        plain_ms = cuda_ms(torch, lambda: plain(x, iW, bias, sW), reps=1,
                           warmup=0)
        ref = (torch.nn.GRU if cell == "gru" else torch.nn.LSTM)(h, h).to(dev)
        with torch.no_grad():
            ref.weight_ih_l0.copy_(iW)
            ref.weight_hh_l0.copy_(sW)
            ref.bias_ih_l0.copy_(bias)
            ref.bias_hh_l0.zero_()
            lib_ms = cuda_ms(torch, lambda: ref(x), reps=3)
        bound, by = bound_ms(4 * (2 * t * b * h + gates * h * (2 * h + 1)),
                             2 * t * b * gates * h * h,
                             2 * t * b * gates * h * h)
        _, plan = plan_of(cell, h, b)
        out[cell] = dict(T=t, B=b, H=h, max_abs_err=err, ms=ms,
                         plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound,
                         bound_by=by, plan=plan)
        say("{}_fwd at the remap path's shape T={} B={} D=H={}: max|err| "
            "{:.3g} (tol 1e-4), kernel {:.3f} ms ({:.3f} us a step), plain "
            "{:.3f} ms, torch.nn.{} {:.3f} ms, bound {:.4f} ms ({}); plan "
            "{}".format(cell, t, b, h, err, ms, 1e3 * ms / t, plain_ms,
                        cell.upper(), lib_ms, bound, by, plan))
    return out


def prepare_path(torch, dev, work, pick, mlstm_ckpt, card):
    """Training-data preparation through the port's CLI (phase 12 of the
    module docstring); returns the launches of its card runs by path."""
    from taiyaki_tpu_torch.cli import prepare_mapped_reads as pmr
    d = os.path.join(work, "prepare")
    records = write_prepare_inputs(d)
    tsv, refs = os.path.join(d, "params.tsv"), os.path.join(d, "refs.fa")
    launches, stats, mapped = {}, {}, {}
    shapes = check_remap_shapes(torch, dev, np.random.default_rng(14))
    torch.cuda.empty_cache()

    def remap(tag, reads, model, counters=None, extra=()):
        out = os.path.join(d, tag + ".hdf5")
        if counters is not None:
            for fn in counters.values():
                fn.launches = 0
        torch.cuda.reset_peak_memory_stats()
        st = pmr.main(["--jobs", "4"] + list(extra) + [
            os.path.join(d, reads), tsv, out, model, refs])
        torch.cuda.synchronize()
        st["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        if counters is not None:
            launches["prepare " + tag] = {k: fn.launches
                                          for k, fn in counters.items()}
        mapped[tag], verdict = read_mapped(out)
        check(verdict == "pass", "prepare {}: check() {!r}".format(
            tag, verdict))
        check(not st["failures"], "prepare {}: reads failed {}".format(
            tag, {str(k): v for k, v in st["failures"].items()}))
        stats[tag] = st
        return mapped[tag]

    gru_counters = pick(("gru_fwd",))
    for tag, extra in (("mGru", ()), ("mGru batch layout",
                                      ("--batch_format",))):
        got = remap(tag, "all", REMAP_MODEL, gru_counters, extra)
        check(sorted(got) == sorted(records),
              "prepare {}: {} reads of {}".format(tag, len(got),
                                                  len(records)))
        for rid, (orig, dacs, ref) in records.items():
            r = got[rid]
            check(np.array_equal(r.Dacs, dacs)
                  and np.array_equal(r.Reference, ref),
                  "prepare {}: {} Dacs or Reference not as written".format(
                      tag, rid))
            d_start, d_end = r.get_mapped_dacs_region()
            n = len(records[orig][1])
            # the long read's own middle is a junction of its tiles, where
            # a read's start (its stalls) follows a read's end: take the
            # middle of its second tile
            centre = n + n // 2 if len(dacs) > n else (d_start + d_end) // 2
            chunk = r.get_chunk_with_sample_length(
                1000, start_sample=centre - 500 - d_start)
            check(chunk.accepted and 5.0 < chunk.mean_dwell < 20.0,
                  "prepare {}: {} middle chunk {} mean dwell {:.2f}".format(
                      tag, rid, chunk.reject_reason, chunk.mean_dwell))
        for k, n in launches["prepare " + tag].items():
            check(n > 0, "prepare {}: no launch of {}".format(tag, k))
    batched = mapped["mGru"]
    for rid in batched:
        a = mapped["mGru batch layout"][rid].Ref_to_signal
        check(np.array_equal(a, batched[rid].Ref_to_signal),
              "prepare: {} maps otherwise in the batch layout".format(rid))
    # every copy maps as its original does (same batch or another)
    copies = [near_tie(batched[rid].Ref_to_signal,
                       batched[orig].Ref_to_signal)
              for rid, (orig, _, _) in records.items()
              if rid != orig and len(records[rid][1]) == len(
                  records[orig][1])]
    check(all(c[2] for c in copies), "prepare: a copy breaks the near-tie "
          "rule against its original: {}".format(
              [c for c in copies if not c[2]]))
    # card (batches of 8) against the CPU (one read a forward)
    cpu = remap("cpu", "orig", REMAP_MODEL,
                extra=("--device", "cpu", "--jobs", "1"))
    vs_cpu = {rid: near_tie(batched[rid].Ref_to_signal, r.Ref_to_signal)
              for rid, r in cpu.items()}
    check(len(vs_cpu) == 3 and all(v[2] for v in vs_cpu.values()),
          "prepare: card against CPU breaks the near-tie rule: {}".format(
              vs_cpu))
    remap("long read", "long", REMAP_MODEL)
    remap("mLstm", "orig", mlstm_ckpt, pick(("lstm_fwd",)))
    check(launches["prepare mLstm"]["lstm_fwd"] > 0,
          "prepare mLstm: no launch of lstm_fwd")

    def rates(st):
        text = ("{} reads, {} samples in {:.3f} s: {:.2f} reads/s, {:.1f} "
                "ksample/s".format(st["nmapped"], st["nsample"],
                                   st["seconds"], st["nmapped"] / st["seconds"],
                                   st["nsample"] / st["seconds"] / 1e3))
        if st["device"] == "cpu":
            # the per-read path times no split and uses no card memory
            return text
        return text + ("; stage wait {:.3f} s, forwards {:.3f} s, host "
                       "finish (Viterbi remap) {:.3f} s; peak device memory "
                       "{:.3f} GiB".format(st["stage"], st["forward"],
                                           st["finish"], st["peak_gib"]))

    say("prepare_mapped_reads on {} (shipped mGru remap checkpoint, size "
        "96, stride 4; --jobs 4): per-read layout {}; batch layout {}; "
        "launches {}; the long read ({} samples) alone: {}; card against "
        "CPU on the 3 real reads (share of Ref_to_signal moved, largest "
        "move in samples): {}; {} copies within the rule of their "
        "originals (largest share {:.4f}); CPU run {}; mLstm 256/5/19 "
        "trained checkpoint: {}, launches {}".format(
            card, rates(stats["mGru"]), rates(stats["mGru batch layout"]),
            launches["prepare mGru"],
            len(records[next(iter(mapped["long read"]))][1]),
            rates(stats["long read"]),
            {rid: v[:2] for rid, v in vs_cpu.items()}, len(copies),
            max(c[0] for c in copies), rates(stats["cpu"]),
            rates(stats["mLstm"]), launches["prepare mLstm"]))
    return launches, dict(stats, shapes=shapes)


def catmod_basecall(torch, dev, work, model, counters, what):
    """The cat_mod checkpoint `model` (`what` names it) calls the three
    modref reads (written as fast5) through the basecall CLI with
    --modified_base_output on the card, then on the CPU twins: every read
    gets a mod table of one row per called base and one column per mod,
    the calls are equal (or the Viterbi tie rule of main_path holds), and
    where the calls agree the card's mod scores equal the CPU's within
    1e-4 (NaN where a mod does not apply to the base); the output's mod
    columns over every chunk too.  Returns (launches, stats)."""
    from taiyaki_tpu_torch.cli import basecall
    from taiyaki_tpu_torch.data import fast5utils, hdf5
    reads = os.path.join(work, "reads_modref")
    if not os.path.isdir(reads):
        os.makedirs(reads)
        write_real_reads(os.path.join(reads, "modref.fast5"), MODREF_HDF5)
    refs = sorted(rid for _, rid in fast5utils.iterate_fast5_reads(reads))
    out = {}
    for tag, extra in (("card", []), ("cpu", ["--device", "cpu"])):
        fa = os.path.join(work, "modref_{}_{}.fa".format(what, tag))
        mods = os.path.join(work, "modref_{}_{}.hdf5".format(what, tag))
        if tag == "card":
            for fn in counters.values():
                fn.launches = 0
        stats = basecall.main(extra + ["--output", fa, "--quiet",
                                       "--modified_base_output", mods, reads,
                                       model])
        if tag == "card":
            torch.cuda.synchronize()
            launches = {k: fn.launches for k, fn in counters.items()}
            card_stats = stats
        f = hdf5.File(mods)
        names = [n.decode() for n in f["mod_long_names"][()]]
        tables = {rid: f["Reads"][rid][()] for rid in f["Reads"].keys()}
        f.close()
        out[tag] = read_fastx(fa), names, tables
    for k, n in launches.items():
        check(n > 0, "cat_mod basecall never launched kernel {}".format(k))
    (calls, names, tables), (cpu_calls, cpu_names, cpu_tables) = (
        out["card"], out["cpu"])
    check(names == cpu_names == ["6mA", "5mC"], "mod_long_names {} / {}"
          .format(names, cpu_names))
    check(sorted(tables) == sorted(cpu_tables) == sorted(refs),
          "mod tables for {} of reads {}".format(sorted(tables),
                                                 sorted(refs)))
    for rid, table in tables.items():
        check(table.dtype == np.float32
              and table.shape == (len(calls.get(rid, "")), 2),
              "{}: mod table {} {} for {} called bases".format(
                  rid, table.dtype, table.shape, len(calls.get(rid, ""))))
    same = [rid for rid in refs if calls.get(rid) == cpu_calls.get(rid)]
    nchunk, ndiff, gap, trans_err, stream_err = tie_check(
        torch, model, reads, sorted(refs), dev, mods=True)
    check(len(same) == len(refs) or ndiff > 0,
          "modref reads: card and CPU calls differ with equal chunk paths")
    check(stream_err <= 1e-4, "mod columns of the output: card vs CPU max "
          "|err| {} > 1e-4".format(stream_err))
    m_err, nscore = 0.0, 0
    for rid in same:
        a, b = tables[rid], cpu_tables[rid]
        check(bool((np.isnan(a) == np.isnan(b)).all()),
              "{}: mod scores defined at other bases".format(rid))
        ok = ~np.isnan(a)
        nscore += int(ok.sum())
        if ok.any():
            m_err = max(m_err, float(np.abs(a[ok] - b[ok]).max()))
    check(m_err <= 1e-4, "mod scores: card vs CPU max |err| {} > 1e-4"
          .format(m_err))
    nbase = sum(len(c) for c in calls.values())
    say("cat_mod basecall ({} mLstm_cat_mod checkpoint, the 3 modref "
        "reads, --modified_base_output): {} reads, {} samples, {} bases in "
        "{:.3f} s: {:.3f} ksample/s; launches {}; card vs CPU: {} of {} "
        "calls identical, {} of {} chunks with another Viterbi path (score "
        "gap {:.3g}, tol 1e-4), max |posterior diff| {:.3g}; mod tables "
        "{} (rows = called bases), {} mod scores compared (a called A or "
        "C has one), max |card - CPU| {:.3g} (tol 1e-4); called bases by "
        "letter {}; the output's mod columns over all chunks, max |card - "
        "CPU| {:.3g} (tol 1e-4)".format(
            what, card_stats["ncalled"], card_stats["nsample"], nbase,
            card_stats["seconds"],
            card_stats["nsample"] / card_stats["seconds"] / 1e3, launches,
            len(same), len(refs), ndiff, nchunk, gap, trans_err,
            {rid: t.shape for rid, t in sorted(tables.items())}, nscore,
            m_err, {b: sum(c.count(b) for c in calls.values())
                    for b in "ACGT"}, stream_err))
    return launches, card_stats


def catmod_steps(torch, dev, seed):
    """One cat_mod training step on each route (256 chunks x CHUNK
    samples; mean synchronised wall time of 2 steps after a warm-up), its
    peak device memory, and the cat_mod loss's forward and backward alone
    on the network's outputs (mean of 3, synchronised).  Returns {route:
    numbers}."""
    from taiyaki_tpu_torch.ops import flipflop
    batch, kwargs = step_batch(seed, TB, MLSTM_CATMOD)
    out = {}
    for route, env in CATMOD_ROUTES:
        with switches(env):
            step_ms, peak, net, b = timed_step(torch, dev, seed, MLSTM_CATMOD,
                                               batch, kwargs)
            with torch.no_grad():
                y = net(b.signal)
            (_, offsets, weights), (factor,) = loss_args(net)

            def loss_once():
                yy = y.detach().requires_grad_()
                flipflop.cat_mod_flipflop_loss(
                    yy, b.seqs, b.seqlens, b.mod_cats, offsets,
                    weights * np.float32(factor)).sum().backward()
            loss_once()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(3):
                loss_once()
            torch.cuda.synchronize()
            loss_ms = (time.perf_counter() - t0) * 1e3 / 3
        del net, b, y
        torch.cuda.empty_cache()
        out[route] = dict(step_ms=step_ms, peak_gb=peak / 1e9,
                          loss_fwd_bwd_ms=loss_ms)
        say("cat_mod route {}: training step {:.3f} ms ({} chunks x {} "
            "samples, L={}, S={}), peak device memory {:.3f} GB; the "
            "cat_mod loss forward and backward alone {:.3f} ms".format(
                route, step_ms, TB, CHUNK, batch.seqs.shape[1], SC,
                peak / 1e9, loss_ms))
    return out


def seeded_checkpoint(work, seed, model):
    """A checkpoint of `model` at size 256 with weights drawn from a
    seed."""
    from taiyaki_tpu_torch.convert import load_jax_params, params_to_jax
    from taiyaki_tpu_torch.data import mapped_signal_files
    from taiyaki_tpu_torch.utils import helpers
    kwargs = dict(insize=1, size=H, winlen=19, stride=model[2])
    if is_cat_mod(model):
        with mapped_signal_files.MappedSignalReader(reads_of(model)) as msr:
            kwargs["alphabet_info"] = msr.get_alphabet_information()
    net, source, meta = helpers.new_model(
        model[1], model_metadata={"reverse": False, "standardize": True},
        **kwargs)
    load_jax_params(net, net.init(np.random.default_rng(seed)))
    outdir = os.path.join(work, "seeded_" + model[0])
    os.makedirs(outdir)
    return helpers.save_model(outdir, net, params_to_jax(net), source,
                              kwargs, meta)


def _device_us(evt):
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return getattr(evt, name)
    return 0.0


def profile_batch(torch, dev, model, reads_dir):
    """Where one 128-chunk batch of a basecall path spends its time: host
    wall time of each stage (synchronised), then torch.profiler's device
    time by kernel and the device's busy share over the batch."""
    from taiyaki_tpu_torch.cli import basecall
    from taiyaki_tpu_torch.convert import load_jax_params
    from taiyaki_tpu_torch.data import fast5utils
    from taiyaki_tpu_torch.ops import decode
    from taiyaki_tpu_torch.utils import helpers
    net, params, *_ = helpers.load_model(model)
    net = load_jax_params(net, params).to(dev).eval()
    stride = net.stride
    parts = []
    for fname, rid in fast5utils.iterate_fast5_reads(reads_dir):
        parts.append(basecall.prepare_read(
            rid, basecall.get_signal(fname, rid), T * stride, 100 * stride,
            None, False)["chunks"])
    chunks = np.concatenate(parts, axis=1)[:, :B]
    caller = basecall.Basecaller(net, 40, True, 1.0, B, dev,
                                 want_errprobs=True)
    x = torch.from_numpy(chunks).to(dev)

    def stages():
        out = {}
        t = time.perf_counter()

        def lap(name):
            nonlocal t
            torch.cuda.synchronize()
            now = time.perf_counter()
            out[name] = (now - t) * 1e3
            t = now
        y = x
        for i, layer in enumerate(net.sublayers):
            y = layer(y)
            lap("{}:{}".format(i, type(layer).__name__))
        trans = torch.log(decode.flipflop_make_trans(y) + 1e-8)
        lap("make_trans+log")
        _, _, paths = decode.flipflop_viterbi(trans)
        lap("viterbi")
        caller.errprobs(trans, paths)
        lap("errprobs")
        paths.cpu()
        lap("paths to host")
        return out

    with torch.inference_mode():
        stages()
        walls = stages()
        kern, wall = device_profile(torch, lambda: caller.call_chunks(x))
    total = sum(walls.values())
    say("basecall batch of {} chunks x {} samples, stage wall times (ms, "
        "synchronised): {} ; total {:.3f} ms".format(
            B, T * stride, ", ".join("{} {:.3f}".format(k, v)
                                     for k, v in walls.items()), total))
    say_profile("one call_chunks", kern, wall, total)


def device_profile(torch, fn):
    """torch.profiler over one fn(): [(kernel, device ms, launches)] and
    the profiled wall time (ms).  Fails if the profiler saw no device
    time."""
    from torch.profiler import ProfilerActivity, profile
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    kern = [(e.key, _device_us(e) / 1e3, e.count)
            for e in prof.key_averages()
            if str(getattr(e, "device_type", "")).endswith("CUDA")
            and _device_us(e) > 0]
    check(len(kern) > 0, "torch.profiler recorded no device time")
    return kern, wall


def say_profile(what, kern, wall, total):
    # the profiled call's own wall time includes the profiler's start;
    # the busy share is taken against the unprofiled wall time
    busy = sum(k[1] for k in kern)
    say("profiler over {}: device busy {:.3f} ms, {:.1%} of the unprofiled "
        "{:.3f} ms (profiled wall {:.3f} ms); by kernel (ms, launches): "
        "{}".format(what, busy, busy / total, total, wall, "; ".join(
            "{} {:.3f} x{}".format(n[:60], t, c) for n, t, c in
            sorted(kern, key=lambda k: -k[1])[:10])))


def profile_train_step(torch, dev, seed, model, nchunk=TB, chunk=CHUNK,
                       size=H):
    """Where one training step of `model` (nchunk chunks x chunk samples,
    size `size`; 256 x CHUNK at 256 by default) spends its time:
    synchronised wall time of each stage (forward by layer, CRF loss,
    logZ, backward, clip + optimizer), then device time by kernel."""
    from taiyaki_tpu_torch import train
    from taiyaki_tpu_torch.ops import flipflop as ffops
    batch, kwargs = step_batch(seed, nchunk, model, chunk, size)
    net = new_net(seed, kwargs, dev, model)
    params = train.leaf_params(net)
    optimizer, _ = train.make_optimizer(params, 4e-3, 8, 2, 1e-4, 1e-4)
    threshs = np.full(len(params), np.inf, np.float32)
    b = train.batch_to_device(batch, dev)

    def stages():
        out = {}
        t = time.perf_counter()

        def lap(name):
            nonlocal t
            torch.cuda.synchronize()
            now = time.perf_counter()
            out[name] = (now - t) * 1e3
            t = now
        y = b.signal
        for i, layer in enumerate(net.sublayers):
            y = layer(y)
            lap("{}:{}".format(i, type(layer).__name__))
        nblk = y.shape[0]
        loss = ffops.crf_flipflop_loss(y, b.seqs, b.seqlens, 1.0)
        lap("crf loss")
        logz = ffops.flipflop_logz(y) / nblk
        loss = (loss + logz).sum() / y.shape[1]
        lap("logZ")
        grads = torch.autograd.grad(loss, params)
        lap("backward")
        gmax = torch.stack([g.abs().max() for g in grads])
        optimizer.step([torch.clamp(g, -float(th), float(th))
                        for g, th in zip(grads, threshs)])
        gmax.cpu()
        lap("clip+optimizer")
        return out

    step = train.make_train_step(net, optimizer)
    stages()
    walls = stages()
    total = sum(walls.values())
    kern, wall = device_profile(torch, lambda: step(b, 1.0, threshs))
    say("{} training step of {} chunks x {} samples (size {}, T={} blocks, "
        "L={}), stage wall times (ms, synchronised): {} ; total {:.3f} "
        "ms".format(
            model[0], batch.signal.shape[1], chunk, size, chunk // model[2],
            batch.seqs.shape[1],
            ", ".join("{} {:.3f}".format(k, v) for k, v in walls.items()),
            total))
    say_profile("one {} training step".format(model[0]), kern, wall, total)


# -- the remaining layers, the beam and the JSON export ---------------------

# a flip-flop network of every layer of layers.py but TimeLinear (its
# insize is a number of time points, checked alone in check_layers): the
# layers phase trains it, the JSON phase exports it, and the port's CPU
# tests hold it against the JAX package
ALL_LAYERS_SOURCE = '''"""Every layer of layers.py but TimeLinear in one flip-flop network."""

from taiyaki_tpu_torch import activation, layers


def network(insize=1, size=256, winlen=19, stride=5, alphabet_info=None):
    nbase = 4 if alphabet_info is None else alphabet_info.nbase
    half = size // 2
    return layers.Serial([
        layers.DeltaSample(),
        layers.Studentise(),
        layers.Window(3),
        layers.FeedForward(3 * insize, 16, fun=activation.tanh),
        layers.Convolution(16, size, winlen, stride=stride,
                           fun=activation.swish),
        layers.birnn(layers.GruMod(size, half), layers.GruMod(size, half)),
        layers.Residual(layers.Lstm(size, size)),
        layers.GatedResidual(layers.CudnnGru(size, size)),
        layers.Reverse(layers.CudnnGru(size, size, has_bias=False)),
        layers.SoftChoice([layers.FeedForward(size, size,
                                              fun=activation.tanh),
                           layers.Identity(activation.tanh)]),
        layers.Product([layers.FeedForward(size, size,
                                           fun=activation.sigmoid),
                        layers.FeedForward(size, size, has_bias=False)]),
        layers.DownUpSample(layers.FeedForward(2 * size, 2 * size,
                                               fun=activation.tanh), 2),
        layers.Parallel([layers.FeedForward(size, half,
                                            fun=activation.tanh),
                         layers.Softmax(size, size - half)]),
        layers.GlobalNormFlipFlop(size, nbase),
    ])
'''
# the layers phase's card-against-CPU step: chunks, samples a chunk
ALL_LAYERS_CHUNKS, ALL_LAYERS_CHUNK = 4, 2000
# the beam's width and guide, as `--beam 5 1`
BEAM = ("5", "1")


def all_layers_model(work):
    """(name, model file, stride) of ALL_LAYERS_SOURCE, written to work."""
    path = os.path.join(work, "all_layers.py")
    with open(path, "w") as fh:
        fh.write(ALL_LAYERS_SOURCE)
    return ("all_layers", path, 5)


def _layer_cases(layers, activation, t):
    """The layers of layers.py that no other phase runs, at width H
    (TimeLinear over t time points): (name, layer)."""
    ff = lambda: layers.FeedForward(H, H, fun=activation.tanh)  # noqa: E731
    return [
        ("FeedForward", ff()),
        ("FeedForward no bias", layers.FeedForward(H, H, has_bias=False)),
        ("Softmax", layers.Softmax(H, H)),
        ("TimeLinear", layers.TimeLinear(t, t, fun=activation.tanh)),
        ("Identity", layers.Identity(activation.tanh)),
        ("Studentise", layers.Studentise()),
        ("DeltaSample", layers.DeltaSample()),
        ("Window", layers.Window(3)),
        ("UpSample", layers.UpSample(2)),
        ("DownSample", layers.DownSample(2)),
        ("Parallel", layers.Parallel([ff(), layers.Softmax(H, H)])),
        ("Product", layers.Product([ff(), ff()])),
        ("Residual", layers.Residual(ff())),
        ("GatedResidual", layers.GatedResidual(ff(), 0.5)),
        ("SoftChoice", layers.SoftChoice([ff(), layers.Identity()])),
        ("CudnnGru", layers.CudnnGru(H, H)),
        ("CudnnGru no bias", layers.CudnnGru(H, H, has_bias=False)),
        ("Reverse(CudnnGru)", layers.Reverse(layers.CudnnGru(H, H)))]


def _fwd_bwd(torch, layer, x, dy):
    """A layer's output and the gradients of sum(y * dy) with respect to
    its input and parameters (in named_parameters order; zero for a
    parameter that is not trained), on the host."""
    x = x.clone().requires_grad_()
    y = layer(x)
    leaves = [x] + [p for _, p in layer.named_parameters()]
    grads = torch.autograd.grad(y, leaves, dy, allow_unused=True)
    return y.detach().cpu(), [(torch.zeros_like(p) if g is None else g).cpu()
                              for p, g in zip(leaves, grads)]


def check_layers(torch, dev, rng, t=TT, b=8):
    """Each layer of _layer_cases at width 256 (t blocks, b chunks; seeded
    weights and inputs), forward and backward on the card against the
    port on the CPU: outputs within 1e-4, each gradient within 1e-4 of its
    largest |value|.  Then CudnnGru at H=256, T=1000, B=128 against
    torch.nn.GRU (bias_ih = ib, bias_hh = sb, gates r, z, n) on the same
    weights: outputs within 1e-4, both timed (CUDA events), forward alone
    and forward with backward.  Returns the CudnnGru timings."""
    import copy
    from taiyaki_tpu_torch import activation, layers
    from taiyaki_tpu_torch.convert import load_jax_params
    worst = {}
    for name, layer in _layer_cases(layers, activation, t):
        load_jax_params(layer, layer.init(rng))
        x = torch.from_numpy(rng.normal(size=(t, b, H)).astype(np.float32))
        with torch.no_grad():
            shape = tuple(layer(x).shape)
        dy = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
        cpu = _fwd_bwd(torch, layer, x, dy)
        card = _fwd_bwd(torch, copy.deepcopy(layer).to(dev), x.to(dev),
                        dy.to(dev))
        y_err = max_abs_diff(card[0], cpu[0])
        g_err = max(rel_err(g, w) for g, w in zip(card[1], cpu[1]))
        check(y_err <= 1e-4, "{}: card vs CPU output err {} > 1e-4".format(
            name, y_err))
        check(g_err <= 1e-4, "{}: card vs CPU gradient err {} > 1e-4 of "
              "its largest".format(name, g_err))
        worst[name] = (y_err, g_err)
    say("the remaining layers at width {} (T={}, B={}), card vs CPU (output "
        "max |err|, tol 1e-4; gradients' largest err relative to their "
        "largest, tol 1e-4): {}".format(H, t, b, "; ".join(
            "{} {:.3g} {:.3g}".format(k, *v) for k, v in worst.items())))

    # CudnnGru beside cuDNN's GRU
    layer = layers.CudnnGru(H, H)
    load_jax_params(layer, layer.init(rng))
    layer = layer.to(dev)
    gru = torch.nn.GRU(H, H).to(dev)
    with torch.no_grad():
        for mine, theirs in (("iW", "weight_ih_l0"), ("sW", "weight_hh_l0"),
                             ("ib", "bias_ih_l0"), ("sb", "bias_hh_l0")):
            getattr(gru, theirs).copy_(getattr(layer, mine))
    x = _tensor(torch, dev, rng.normal(size=(T, B, H)))
    with torch.no_grad():
        err = max_abs_diff(layer(x), gru(x)[0])
    check(err <= 1e-4, "CudnnGru vs torch.nn.GRU: max |err| {}".format(err))
    dy = _tensor(torch, dev, rng.normal(size=(T, B, H)))
    xg = x.clone().requires_grad_()

    def with_grad(fn, params):
        return lambda: torch.autograd.grad(fn(xg), [xg] + params, dy)
    with torch.no_grad():
        f_ms = cuda_ms(torch, lambda: layer(x), reps=3)
        lib_f_ms = cuda_ms(torch, lambda: gru(x), reps=3)
    fb_ms = cuda_ms(torch, with_grad(layer, list(layer.parameters())),
                    reps=2)
    lib_fb_ms = cuda_ms(torch, with_grad(lambda v: gru(v)[0],
                                         list(gru.parameters())), reps=2)
    res = dict(fwd_ms=f_ms, fwd_bwd_ms=fb_ms, gru_fwd_ms=lib_f_ms,
               gru_fwd_bwd_ms=lib_fb_ms, max_abs_err=err)
    say("CudnnGru (plain PyTorch, a loop over time) at H={}, T={}, B={}: "
        "forward {:.3f} ms, with backward {:.3f} ms; torch.nn.GRU (cuDNN) "
        "on the same weights {:.3f} ms, {:.3f} ms; outputs max |diff| "
        "{:.3g} (tol 1e-4)".format(H, T, B, f_ms, fb_ms, lib_f_ms,
                                   lib_fb_ms, err))
    return res


def all_layers_path(torch, dev, seed, work, counters):
    """The network of ALL_LAYERS_SOURCE at size 256 (seeded weights) on a
    batch of the repo's mapped reads (ALL_LAYERS_CHUNKS chunks x
    ALL_LAYERS_CHUNK samples): its output and one training step's loss and gradients on
    the card against the port on the CPU (outputs within 1e-4; loss 1e-5
    relative; each gradient within 1e-4 of its largest), then one AdamW
    step on the card, which must change every parameter the loss reaches.
    The LSTM and GRU kernels of its layers must launch.  Writes a
    checkpoint of the trained net; returns (launches, checkpoint)."""
    from taiyaki_tpu_torch import train
    from taiyaki_tpu_torch.convert import leaf_names, params_to_jax
    from taiyaki_tpu_torch.utils import helpers
    model = all_layers_model(work)
    batch, kwargs = step_batch(seed, ALL_LAYERS_CHUNKS, model,
                               ALL_LAYERS_CHUNK, H)
    def one(device):
        net = new_net(seed, kwargs, device, model)
        b = train.batch_to_device(batch, device)
        with torch.no_grad():
            y = net(b.signal).cpu()
        loss, grads = train.make_grad_step(net)(b, 1.0)
        return y, float(loss), [g.cpu() for g in grads], net

    for fn in counters.values():
        fn.launches = 0
    y, loss, grads, net = one(dev)
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters.items()}
    y_cpu, loss_cpu, grads_cpu, _ = one(torch.device("cpu"))
    names = leaf_names(net)
    y_err = max_abs_diff(y, y_cpu)
    l_err = abs(loss - loss_cpu) / max(1.0, abs(loss_cpu))
    errs = [rel_err(g, w) for g, w in zip(grads, grads_cpu)]
    worst = names[int(np.argmax(errs))]
    check(y_err <= 1e-4, "all layers: card vs CPU output err {}".format(
        y_err))
    check(l_err <= 1e-5, "all layers: loss {} vs {}".format(loss, loss_cpu))
    check(max(errs) <= 1e-4, "all layers: gradient err {} ({})".format(
        max(errs), worst))
    for k, n in launches.items():
        check(n > 0, "all layers step never launched kernel {}".format(k))

    params = train.leaf_params(net)
    before = [p.detach().clone() for p in params]
    opt, _ = train.make_optimizer(params, 4e-3, 8, 2, 1e-4, 1e-4)
    step = train.make_train_step(net, opt)
    loss2, grad_maxs = step(train.batch_to_device(batch, dev), 1.0,
                            np.full(len(params), np.inf, np.float32))
    torch.cuda.synchronize()
    moved = [not torch.equal(p.detach(), q) for p, q in zip(params, before)]
    reached = [float(m) > 0 for m in grad_maxs.cpu()]
    check(np.isfinite(float(loss2)) and moved == reached,
          "all layers: AdamW step loss {}, parameters moved {} of {} with "
          "a gradient".format(float(loss2), sum(moved), sum(reached)))
    outdir = os.path.join(work, "all_layers_model")
    os.makedirs(outdir)
    _, source, meta = helpers.new_model(model[1], **kwargs)
    ckpt = helpers.save_model(outdir, net, params_to_jax(net), source,
                              kwargs, meta)
    say("all layers (every layer of layers.py but TimeLinear, size {}, "
        "stride 5; {} chunks x {} samples): output {} card vs CPU max "
        "|err| {:.3g} (tol 1e-4); loss {} vs {} (relative err {:.3g}, tol "
        "1e-5); {} gradients, largest err relative to each one's largest "
        "{:.3g} in {} (tol 1e-4); one AdamW step on the card: loss {}, "
        "{} of {} parameters moved; launches {}".format(
            H, ALL_LAYERS_CHUNKS, ALL_LAYERS_CHUNK, tuple(y.shape), y_err, loss,
            loss_cpu, l_err, len(grads), max(errs), worst, float(loss2),
            sum(moved), len(moved), launches))
    return launches, ckpt


def _beam_reads(torch, model, reads_dir, dev):
    """Per read of reads_dir: the beam's call and score (width and guide
    of BEAM) over the read's stitched posterior scores, the network and
    make_trans run on `dev` (the CLI's defaults: chunks of 1000 blocks,
    overlap 100).  Returns ({read id: (call, score)}, device ms, beam ms,
    chunks)."""
    from taiyaki_tpu_torch import basecall_helpers as bh
    from taiyaki_tpu_torch import decodeutil
    from taiyaki_tpu_torch.cli import basecall
    from taiyaki_tpu_torch.convert import load_jax_params
    from taiyaki_tpu_torch.data import fast5utils
    from taiyaki_tpu_torch.flipflopfings import path_to_str
    from taiyaki_tpu_torch.utils import helpers
    net, params, *_ = helpers.load_model(model)
    net = load_jax_params(net, params).to(dev).eval()
    stride = net.stride
    chunk = bh.DEFAULT_CHUNK_SIZE * stride
    preps = [basecall.prepare_read(rid, basecall.get_signal(fname, rid),
                                   chunk, bh.DEFAULT_OVERLAP * stride, None,
                                   False)
             for fname, rid in fast5utils.iterate_fast5_reads(reads_dir)]
    caller = basecall.Basecaller(net, 40, True, 1.0, B, dev,
                                 want_trans=True, want_paths=False)
    chunks = np.concatenate([p["chunks"] for p in preps], axis=1)
    with torch.inference_mode():
        caller.gather(caller.submit(chunks[:, :B]))      # warm-up
        t0 = time.perf_counter()
        trans = caller.gather(caller.submit(chunks))[3]
        dev_ms = (time.perf_counter() - t0) * 1e3
    out, off, beam_ms = {}, 0, 0.0
    for p in preps:
        k = p["chunks"].shape[1]
        tr = trans[:, off:off + k]
        off += k
        if p["true_len"] < chunk:
            tr = tr[:-(-p["true_len"] // stride)]
        st = bh.stitch_chunks(tr, p["chunk_starts"], p["chunk_ends"],
                              stride)
        t0 = time.perf_counter()
        seq, score = decodeutil.beamsearch(st, beam_width=int(BEAM[0]),
                                           guided=BEAM[1] == "1")
        beam_ms += (time.perf_counter() - t0) * 1e3
        out[p["read_id"]] = (path_to_str(seq, include_first_source=False),
                             score)
    return out, dev_ms, beam_ms, chunks.shape[1]


def beam_real_reads(torch, dev, work, counters):
    """The three real reads, written as fast5, called by the basecall
    CLI with --beam 5 1 --fastq and the shipped mGru remap checkpoint, on
    the card and on the CPU twins: every read gets a record, each call's
    semi-global identity is at least 0.80, and the calls are equal, or,
    where they differ, the card's beam score is within 1e-4 (relative to
    |score|) of the CPU's.  Returns (launches, stats)."""
    from taiyaki_tpu_torch.cli import basecall
    reads = os.path.join(work, "reads_real_beam")
    os.makedirs(reads)
    refs = write_real_reads(os.path.join(reads, "real.fast5"))
    calls, quals = {}, {}
    for tag, extra in (("card", []), ("cpu", ["--device", "cpu"])):
        fq = os.path.join(work, "real_beam_{}.fq".format(tag))
        if tag == "card":
            for fn in counters.values():
                fn.launches = 0
        stats = basecall.main(extra + ["--output", fq, "--quiet", "--fastq",
                                       "--beam", BEAM[0], BEAM[1], reads,
                                       REMAP_MODEL])
        if tag == "card":
            torch.cuda.synchronize()
            launches = {k: fn.launches for k, fn in counters.items()}
            card_stats = stats
        with open(fq) as fh:
            lines = fh.read().splitlines()
        calls[tag] = {lines[i][1:]: lines[i + 1]
                      for i in range(0, len(lines), 4)}
        quals[tag] = {lines[i][1:]: lines[i + 3]
                      for i in range(0, len(lines), 4)}
    for k, n in launches.items():
        check(n > 0, "beam basecall never launched kernel {}".format(k))
    check(sorted(calls["card"]) == sorted(refs), "beam real reads: records "
          "{} of {}".format(sorted(calls["card"]), sorted(refs)))
    for rid, call in calls["card"].items():
        check(len(quals["card"][rid]) == len(call) > 0,
              "beam fastq of {}: {} bases, {} q-scores".format(
                  rid, len(call), len(quals["card"][rid])))
    same = [rid for rid in refs
            if calls["card"][rid] == calls["cpu"].get(rid)]
    gap = 0.0
    if len(same) < len(refs):
        card, _, _, _ = _beam_reads(torch, REMAP_MODEL, reads, dev)
        cpu, _, _, _ = _beam_reads(torch, REMAP_MODEL, reads,
                                   torch.device("cpu"))
        for rid in refs:
            if card[rid][0] != cpu[rid][0]:
                gap = max(gap, abs(card[rid][1] - cpu[rid][1])
                          / max(1.0, abs(cpu[rid][1])))
        check(gap <= 1e-4, "beam real reads: calls differ and the card's "
              "beam score is {} (relative) off the CPU's (tol 1e-4)"
              .format(gap))
    ident = {rid: semiglobal_identity(calls["card"][rid], ref)
             for rid, (ref, _) in refs.items()}
    say("beam real reads (--beam {} {} --fastq, shipped mGru remap "
        "checkpoint): {} reads, {} samples, {} bases in {:.3f} s: {:.3f} "
        "ksample/s; launches {}; card vs CPU: {} of {} calls identical "
        "(differing calls' beam score gap {:.3g}, tol 1e-4); semi-global "
        "identity: {}".format(
            BEAM[0], BEAM[1], card_stats["ncalled"], card_stats["nsample"],
            card_stats["nbase"], card_stats["seconds"],
            card_stats["nsample"] / card_stats["seconds"] / 1e3, launches,
            len(same), len(refs), gap, ", ".join(
                "{} {:.4f} ({} bases)".format(rid, ident[rid],
                                              len(calls["card"][rid]))
                for rid in sorted(refs))))
    worst = min(ident.values())
    check(worst >= 0.80, "beam real reads: identity {:.4f} < 0.80".format(
        worst))
    return launches, card_stats


def beam_synthetic(torch, dev, work, model, reads, viterbi, counters):
    """The basecall CLI with --beam 5 1 on main_path's synthetic reads and
    checkpoint `model` (full-width mLstm), its ksample/s beside the
    Viterbi run's (`viterbi`, main_path's stats); and the beam's share of
    a batch: the network and make_trans of every chunk on the card
    (synchronised, scores to the host) against the beam over every read
    on the host, one thread.  Returns (launches, numbers)."""
    from taiyaki_tpu_torch.cli import basecall
    for fn in counters.values():
        fn.launches = 0
    fa = os.path.join(work, "beam.fa")
    stats = basecall.main(["--output", fa, "--quiet", "--beam", BEAM[0],
                           BEAM[1], reads, model])
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters.items()}
    for k, n in launches.items():
        check(n > 0, "beam basecall never launched kernel {}".format(k))
    check(stats["nread"] == viterbi["nread"]
          and stats["nsample"] == viterbi["nsample"],
          "beam basecall: {} reads, {} samples".format(stats["nread"],
                                                      stats["nsample"]))
    _, dev_ms, beam_ms, nchunk = _beam_reads(torch, model, reads, dev)
    per_batch = B / nchunk
    res = dict(beam_ksample_s=stats["nsample"] / stats["seconds"] / 1e3,
               viterbi_ksample_s=viterbi["nsample"] / viterbi["seconds"]
               / 1e3,
               batch_device_ms=dev_ms * per_batch,
               batch_beam_ms=beam_ms * per_batch,
               beam_share=beam_ms / (beam_ms + dev_ms))
    say("beam basecall (mLstm 256/5/19, synthetic reads, --beam {} {}, "
        "fasta): {} reads, {} samples, {} bases in {:.3f} s: {:.3f} "
        "ksample/s (Viterbi run: {:.3f}); launches {}; a batch of {} "
        "chunks: network + make_trans + scores to the host {:.3f} ms, the "
        "beam over its reads on the host {:.3f} ms (one thread): beam "
        "share {:.1%}".format(
            BEAM[0], BEAM[1], stats["ncalled"], stats["nsample"],
            stats["nbase"], stats["seconds"], res["beam_ksample_s"],
            res["viterbi_ksample_s"], launches, B, res["batch_device_ms"],
            res["batch_beam_ms"], res["beam_share"]))
    return launches, res


def _json_matches(js, layer):
    """The parameters under each `params` of an exported layer tree equal
    the layer's state (GRU gates reordered from r, z, n to z, r, n);
    returns how many were compared."""
    n = 0
    for name, p in layer.named_parameters(recurse=False):
        want = p.detach().cpu().numpy()
        if js["type"] in ("GruMod", "CudnnGru"):
            k = want.shape[0] // 3
            want = np.concatenate([want[k:2 * k], want[:k], want[2 * k:]])
        got = np.asarray(js["params"][name], np.float32)
        check(got.size == want.size
              and np.array_equal(got.reshape(want.shape), want),
              "dump_json: {} {} differs from the state".format(
                  js["type"], name))
        n += 1
    subs = js.get("sublayers")
    if isinstance(subs, list):
        children = list(zip(subs, layer.sublayers))
    else:
        children = [] if subs is None else [(subs, layer.layer)]
    return n + sum(_json_matches(c, child) for c, child in children)


def json_export(work, checkpoints):
    """`cli.dump_json` on each checkpoint {name: path}: the file parses,
    its md5sum is the checkpoint's, and every parameter equals the loaded
    network's state_dict after the GRU gate reorder."""
    from taiyaki_tpu_torch.cli import dump_json
    from taiyaki_tpu_torch.convert import load_jax_params
    from taiyaki_tpu_torch.utils import helpers
    done = {}
    for name, ckpt in checkpoints.items():
        out = os.path.join(work, name + ".json")
        t0 = time.perf_counter()
        dump_json.main(["--output", out, ckpt])
        secs = time.perf_counter() - t0
        with open(out) as fh:
            js = json.load(fh)
        net, params, *_ = helpers.load_model(ckpt)
        net = load_jax_params(net, params)
        check(js["md5sum"] == helpers.file_md5(ckpt),
              "dump_json {}: md5sum".format(name))
        n = _json_matches(js, net)
        check(n == len(net.state_dict()), "dump_json {}: {} of {} "
              "parameters".format(name, n, len(net.state_dict())))
        done[name] = (n, os.path.getsize(out), secs)
    say("dump_json: {}".format("; ".join(
        "{}: {} parameters equal to the state_dict, {} bytes in {:.2f} s"
        .format(k, *v) for k, v in done.items())))


# -- phase 13 ----------------------------------------------------------------

# train_squiggle's defaults (bin/train_squiggle.py:20-72), 4 iterations
SQ_ARGS = ("--size", "32", "--depth", "4", "--winlen", "9", "--target_len",
           "300", "--batch_size", "100", "--back_prob", "1e-15")
SQ_TARGET, SQ_BATCH, SQ_BACK, SQ_ITER = 300, 100, 1e-15, 4
# train_abinitio's input: chunks of CHUNK samples cut from phase 12's
# mapped reads; its defaults (size 96, stride 2, winlen 19, batch 128)
AB_NCHUNK, AB_BATCH, AB_ITER, AB_CPU = 256, 128, 4, 8
REMAP_REFS = os.path.join(ROOT, "RESULTS", "training_ingredients",
                          "per_read_references_from_sam.fa")


def device_launches(torch, fn):
    """torch.profiler, device activity only, over one fn(): (kernel
    launches, memset and copy operations, their summed device ms, the
    profiled wall ms), read from the trace's raw events (key_averages
    takes minutes over a few hundred thousand launches)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    evts = [e for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA]
    check(len(evts) > 0, "torch.profiler recorded no device time")
    copies = sum(e.name().startswith(("Memcpy", "Memset")) for e in evts)
    return (len(evts) - copies, copies,
            sum(e.duration_ns() for e in evts) / 1e6, wall)


def _squiggle_batch(mapped, seed, max_siglen):
    """A batch of train_squiggle's shape from the reads of `mapped`: its
    chunk sampling (filter statistics from 1000 chunks), padded to the
    CLI's max_siglen and batch size."""
    from taiyaki_tpu_torch.cli import train_squiggle
    from taiyaki_tpu_torch.data import chunk_selection, mapped_signal_files
    with mapped_signal_files.MappedSignalReader(mapped) as msr:
        reads = list(msr.reads())
    np.random.seed(seed)
    fp = chunk_selection.sample_filter_parameters(
        reads, 1000, SQ_TARGET, 3.0, 10.0, 0.5, 1, 1.1,
        chunk_len_means_sequence_len=True)
    chunks, _ = chunk_selection.sample_chunks(
        reads, SQ_BATCH, SQ_TARGET, fp, chunk_len_means_sequence_len=True)
    chunks = [c for c in chunks if c.sig_len <= max_siglen]
    return train_squiggle.make_batch(chunks, SQ_TARGET, max_siglen,
                                     SQ_BATCH)


def squiggle_path(torch, dev, work, seed, mapped):
    """Phase 13a: train_squiggle at its defaults on the card; the squiggle
    cost and its gradient on a batch of that shape, card against CPU; a
    step's launches (torch.profiler).  Returns (checkpoint, numbers)."""
    from taiyaki_tpu_torch import train
    from taiyaki_tpu_torch.cli import predict_squiggle, train_squiggle
    from taiyaki_tpu_torch.ops.squiggle import squiggle_match_cost
    outdir = os.path.join(work, "squiggle")
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    st = train_squiggle.main(list(SQ_ARGS) + [
        "--niteration", str(SQ_ITER), "--save_every", str(SQ_ITER),
        "--seed", str(seed), "--quiet", "--outdir", outdir, mapped])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    losses = st["losses"]
    check(len(losses) == SQ_ITER and all(np.isfinite(losses)),
          "train_squiggle losses {}".format(losses))
    ckpt = os.path.join(outdir, "model_final.checkpoint")
    check(os.path.exists(ckpt), "train_squiggle wrote no checkpoint")

    # the cost of one batch: card against CPU on the trained net's params
    arrays = _squiggle_batch(mapped, seed, st["max_siglen"])
    net = predict_squiggle.load_squiggle_model(ckpt, dev)
    with torch.no_grad():
        params = net(torch.from_numpy(arrays[0]).to(dev))

    def cost_grad(device):
        p = params.detach().to(device).requires_grad_()
        t0 = time.perf_counter()
        cost = squiggle_match_cost(p, torch.from_numpy(arrays[1]).to(device),
                                   torch.from_numpy(arrays[2]).to(device),
                                   SQ_BACK)
        (grad,) = torch.autograd.grad(cost.sum(), p)
        cost, grad = cost.detach().cpu(), grad.cpu()
        return cost, grad, time.perf_counter() - t0

    card, cpu = cost_grad(dev), cost_grad(torch.device("cpu"))
    check(bool(torch.isfinite(card[0]).all() and torch.isfinite(
        card[1]).all()), "squiggle cost on the card: not finite")
    c_err = ((card[0] - cpu[0]).abs() / cpu[0].abs()).max().item()
    g_err = ((card[1] - cpu[1]).abs().max()
             / cpu[1].abs().max()).item()
    check(c_err <= 1e-5, "squiggle cost, card vs CPU: relative err "
          "{}".format(c_err))
    check(g_err <= 1e-4, "squiggle cost gradient, card vs CPU: err {} of "
          "its largest".format(g_err))

    # one whole training step under the profiler: its kernel launches
    net.train()
    leaves = train.leaf_params(net)
    opt = train.Optimizer(leaves, lambda i: 1e-4, lambda i: 0.9, 0.999,
                          1e-6, 0.0)
    batch = [torch.from_numpy(a).to(dev) for a in arrays]

    def step():
        loss = train_squiggle.batch_loss(net, batch, SQ_BACK)
        opt.step(torch.autograd.grad(loss, leaves))
    step()
    nkern, ncopy, busy, wall = device_launches(torch, step)
    out = dict(losses=losses, step_s=st["step_seconds"], cli_s=cli_s,
               max_siglen=st["max_siglen"], peak_gb=peak / 1e9,
               launches_a_step=nkern, copies_a_step=ncopy,
               device_ms_a_step=busy, profiled_step_ms=wall,
               cost_card_s=card[2], cost_cpu_s=cpu[2], cost_rel_err=c_err,
               grad_err=g_err)
    say("train_squiggle (size 32, depth 4, winlen 9, target_len {}, batch "
        "{}, back_prob {}, {} iterations): {:.1f} s; losses {}; step "
        "seconds {}; "
        "max_siglen {}; peak device memory {:.3f} GB; one step under the "
        "profiler: {} kernel launches and {} memsets and copies, device "
        "busy {:.1f} ms of {:.1f} ms; "
        "squiggle cost + gradient at [{} samples, {} chunks, {} positions]: "
        "card {:.2f} s, CPU {:.2f} s, cost relative err {:.3g} (tol 1e-5), "
        "gradient err {:.3g} of its largest (tol 1e-4)".format(
            SQ_TARGET, SQ_BATCH, SQ_BACK, SQ_ITER, cli_s,
            ", ".join("{:.5f}".format(v) for v in losses),
            ", ".join("{:.3f}".format(v) for v in st["step_seconds"]),
            st["max_siglen"], peak / 1e9, nkern, ncopy, busy, wall,
            st["max_siglen"], SQ_BATCH,
            SQ_TARGET, card[2], cpu[2], c_err, g_err))
    return ckpt, out


def _tsv_numbers(path):
    with open(path) as fh:
        rows = [line.split("\t") for line in fh.read().splitlines()]
    return ([r[0] for r in rows],
            np.array([[float(v) for v in r[1:]] for r in rows
                      if r[0] != "base"]))


def predict_path(work, ckpt):
    """Phase 13b: predict_squiggle of the three real references, card
    against CPU: every number within 1e-5 (relative above 1)."""
    from taiyaki_tpu_torch.cli import predict_squiggle
    out = {}
    for tag, extra in (("card", []), ("cpu", ["--device", "cpu"])):
        out[tag] = os.path.join(work, "predict_{}.tsv".format(tag))
        t0 = time.perf_counter()
        predict_squiggle.main(extra + ["--output", out[tag], ckpt,
                                       REMAP_REFS])
        out[tag + "_s"] = time.perf_counter() - t0
    (bases, got), (cbases, want) = (_tsv_numbers(out[k])
                                    for k in ("card", "cpu"))
    err = float((np.abs(got - want)
                 / np.maximum(1.0, np.abs(want))).max())
    check(bases == cbases and len(got) > 7000 and err <= 1e-5,
          "predict_squiggle card vs CPU: {} rows, err {}".format(len(got),
                                                                 err))
    say("predict_squiggle of the 3 real references ({} bases): card {:.2f} "
        "s, CPU {:.2f} s; largest err {:.3g} (tol 1e-5)".format(
            len(got), out["card_s"], out["cpu_s"], err))
    return err


def _mapping(path):
    """{read id: (score, positions)} of map_to_squiggle's output."""
    out = {}
    with open(path) as fh:
        for line in fh:
            if line.startswith("#"):
                rid, score = line[1:].split()
                out[rid] = (float(score), [])
            else:
                out[rid][1].append(int(line.split("\t")[3]))
    return {k: (s, np.array(p)) for k, (s, p) in out.items()}


def map_path(work, ckpt):
    """Phase 13c: map_to_squiggle of phase 12's three real reads (fast5)
    to their references, card against CPU: scores within 1e-4 relative,
    paths equal or within the near-tie rule (under 1% of samples moved,
    none by more than 32 positions)."""
    from taiyaki_tpu_torch.cli import map_to_squiggle
    reads = os.path.join(work, "prepare", "orig")
    out, secs = {}, {}
    for tag, extra in (("card", []), ("cpu", ["--device", "cpu"])):
        path = os.path.join(work, "map_{}.txt".format(tag))
        t0 = time.perf_counter()
        map_to_squiggle.main(extra + ["--output", path, ckpt, REMAP_REFS,
                                      reads])
        secs[tag] = time.perf_counter() - t0
        out[tag] = _mapping(path)
    check(sorted(out["card"]) == sorted(out["cpu"])
          and len(out["card"]) == 3, "map_to_squiggle: reads {} vs {}".format(
              sorted(out["card"]), sorted(out["cpu"])))
    verdict = {}
    for rid, (score, path) in out["card"].items():
        cscore, cpath = out["cpu"][rid]
        s_err = abs(score - cscore) / abs(cscore)
        moved = path != cpath
        worst = int(np.abs(path - cpath).max()) if moved.any() else 0
        verdict[rid] = (s_err, float(moved.mean()), worst)
        check(s_err <= 1e-4 and len(path) == len(cpath)
              and moved.mean() < 0.01 and worst <= 32,
              "map_to_squiggle {}: score err {}, {} of samples moved, "
              "largest move {}".format(rid, s_err, moved.mean(), worst))
    say("map_to_squiggle of the 3 real reads: card {:.2f} s, CPU {:.2f} s; "
        "by read (score relative err, share of samples moved, largest "
        "move): {}".format(secs["card"], secs["cpu"], json.dumps(verdict)))
    return secs


def write_abinitio_inputs(d, mapped, seed):
    """AB_NCHUNK chunks of CHUNK samples cut from the reads of `mapped` by
    the port's chunk sampler: their currents as a "chunks" dataset
    (hdf5.Writer) and their sequences as an index-named fasta.  Returns
    (chunks file, fasta)."""
    from taiyaki_tpu_torch.data import chunk_selection, mapped_signal_files
    from taiyaki_tpu_torch.data.hdf5 import Writer
    with mapped_signal_files.MappedSignalReader(mapped) as msr:
        reads = list(msr.reads())
    np.random.seed(seed)
    fp = chunk_selection.sample_filter_parameters(
        reads, 1000, CHUNK, 3.0, 10.0, 0.5, MGRU[2], 1.1)
    chunks, _ = chunk_selection.sample_chunks(reads, AB_NCHUNK, CHUNK, fp)
    check(len(chunks) == AB_NCHUNK, "abinitio inputs: {} chunks".format(
        len(chunks)))
    os.makedirs(d)
    path, fasta = os.path.join(d, "chunks.hdf5"), os.path.join(d, "refs.fa")
    with Writer(path) as f:
        f.create_dataset("chunks", data=np.stack(
            [c.current for c in chunks]).astype(np.float32))
    with open(fasta, "w") as fh:
        for i, c in enumerate(chunks):
            fh.write(">{}\n{}\n".format(i, "".join("ACGT"[b]
                                                   for b in c.sequence)))
    return path, fasta


def abinitio_path(torch, dev, work, seed, mapped, counters):
    """Phase 13d: train_abinitio at its defaults (mGru_flipflop, size 96,
    stride 2, winlen 19, batch 128) for AB_ITER iterations; the first
    step's loss on its first AB_CPU chunks, card against CPU (1e-4
    relative).  Returns (launches, numbers)."""
    from taiyaki_tpu_torch import train
    from taiyaki_tpu_torch.cli import train_abinitio
    from taiyaki_tpu_torch.convert import load_jax_params
    from taiyaki_tpu_torch.utils import helpers
    d = os.path.join(work, "abinitio")
    chunks_path, fasta = write_abinitio_inputs(d, mapped, seed)
    outdir = os.path.join(d, "out")
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    st = train_abinitio.main([
        "--batch_size", str(AB_BATCH), "--niteration", str(AB_ITER),
        "--save_every", str(AB_ITER // 2), "--seed", str(seed), "--quiet",
        "--outdir", outdir, MGRU[1],
        chunks_path, fasta])
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev)
    launches = {k: fn.launches for k, fn in counters.items()}
    check(all(n > 0 for n in launches.values()),
          "train_abinitio path: launches {}".format(launches))
    losses = st["losses"]
    check(len(losses) == AB_ITER and all(np.isfinite(losses)),
          "train_abinitio losses {}".format(losses))

    # the first step's batch (the CLI's first draw after seeding), cut to
    # AB_CPU chunks, on the initial checkpoint: card against CPU
    chunks = train_abinitio.read_chunks(chunks_path)
    with open(os.path.splitext(fasta)[0] + ".pkl", "rb") as fh:
        seq_dict = pickle.load(fh)
    np.random.seed(seed)
    idx = np.random.choice(len(chunks), size=AB_BATCH, replace=False)
    batch = train_abinitio.make_batch(
        chunks, seq_dict, idx[:AB_CPU],
        max(len(s) for s in seq_dict.values()))
    net, params, *_ = helpers.load_model(
        os.path.join(outdir, "model_checkpoint_00000.checkpoint"))
    first = {}
    for tag, device in (("card", dev), ("cpu", torch.device("cpu"))):
        tnet = load_jax_params(net, params).to(device)
        with torch.no_grad():
            first[tag] = float(train.make_loss_fn(tnet)(
                train.batch_to_device(batch, device), 1.0, 1.0))
    l_err = abs(first["card"] - first["cpu"]) / abs(first["cpu"])
    check(l_err <= 1e-4, "train_abinitio first step, card vs CPU: {} vs "
          "{}".format(first["card"], first["cpu"]))
    out = dict(losses=losses, step_s=st["step_seconds"], peak_gb=peak / 1e9,
               first_loss=first, first_loss_rel_err=l_err)
    say("train_abinitio (mGru_flipflop 96/2/19, {} chunks x {} samples, "
        "batch {}, {} iterations): losses {}; step seconds {}; peak device "
        "memory {:.3f} GB; launches {}; first step's loss on {} chunks: "
        "card {} vs CPU {} (relative err {:.3g}, tol 1e-4)".format(
            AB_NCHUNK, CHUNK, AB_BATCH, AB_ITER,
            ", ".join("{:.5f}".format(v) for v in losses),
            ", ".join("{:.3f}".format(v) for v in st["step_seconds"]),
            peak / 1e9, launches, AB_CPU, first["card"], first["cpu"],
            l_err))
    return launches, out


def _ckpt_params(outdir, name):
    """{name: array} of a checkpoint's .params."""
    from taiyaki_tpu_torch.convert import flat_params
    with open(os.path.join(outdir, name + ".params"), "rb") as fh:
        return flat_params(pickle.load(fh))


def remat_path(torch, dev, work, seed, counters):
    """Phase 13e: the training CLI on mLstm_flipflop at phase 3's shape
    with --remat and without, 2 iterations each, one seed: the losses and
    every parameter after each step within 1e-5 relative; the remat run
    launches the LSTM forward again in each layer's rerun.  Then a step's
    time and peak device memory with and without.  Returns (launches by
    run, numbers)."""
    from taiyaki_tpu_torch.cli import train_flipflop
    runs, launches = {}, {}
    for tag, extra in (("remat", ["--remat"]), ("plain", [])):
        outdir = os.path.join(work, "train_remat_" + tag)
        for fn in counters.values():
            fn.launches = 0
        train_flipflop.main(extra + [
            "--size", str(H), "--stride", str(MLSTM[2]), "--winlen", "19",
            "--chunk_len_min", str(CHUNK), "--chunk_len_max", str(CHUNK),
            "--min_sub_batch_size", str(TB), "--niteration", "2",
            "--warmup_batches", "1", "--save_every", "1",
            "--sample_nreads_before_filtering", "1000",
            "--reporting_sub_batches", "1", "--seed", str(seed), "--quiet",
            "--outdir", outdir, MLSTM[1], READS_HDF5])
        torch.cuda.synchronize()
        launches[tag] = {k: fn.launches for k, fn in counters.items()}
        check(all(n > 0 for n in launches[tag].values()),
              "training {}: launches {}".format(tag, launches[tag]))
        with open(os.path.join(outdir, "batch.log")) as fh:
            runs[tag] = ([float(line.split("\t")[1]) for line in
                          fh.read().splitlines()[1:]], outdir)
    (rlosses, rdir), (plosses, pdir) = runs["remat"], runs["plain"]
    check(len(rlosses) == len(plosses) == 2 and all(
        abs(a - b) <= 1e-5 * abs(b) for a, b in zip(rlosses, plosses)),
        "--remat losses {} vs {}".format(rlosses, plosses))
    p_err = 0.0
    for name in ("model_checkpoint_00001", "model_checkpoint_00002"):
        got, want = _ckpt_params(rdir, name), _ckpt_params(pdir, name)
        check(sorted(got) == sorted(want), "--remat: parameter names")
        for k, b in want.items():
            p_err = max(p_err, float(np.abs(got[k] - b).max()
                                     / max(np.abs(b).max(), 1e-30)))
    check(p_err <= 1e-5, "--remat parameters: relative err {}".format(p_err))
    check(launches["remat"]["lstm_fwd"] > launches["plain"]["lstm_fwd"],
          "--remat reran no LSTM forward: {} vs {}".format(
              launches["remat"]["lstm_fwd"], launches["plain"]["lstm_fwd"]))

    batch, kwargs = step_batch(seed, TB, MLSTM)
    steps = {}
    for tag in ("plain", "remat", "remat", "plain"):
        step_ms, peak = timed_step(torch, dev, seed, MLSTM, batch, kwargs,
                                   remat=tag == "remat")[:2]
        torch.cuda.empty_cache()
        steps.setdefault(tag, []).append((step_ms, peak / 1e9))
    out = dict(loss_remat=rlosses, loss_plain=plosses, param_rel_err=p_err,
               steps={k: [{"step_ms": a, "peak_gb": b} for a, b in v]
                      for k, v in steps.items()})
    say("train_flipflop --remat against no --remat (mLstm {}/5/19, {} "
        "chunks x {} samples, 2 iterations): losses {} vs {}; parameters "
        "after each step: largest relative err {:.3g} (tol 1e-5); LSTM "
        "forward launches {} vs {}; a step (ms, peak device GB; plain, "
        "remat, remat, plain): {}".format(
            H, TB, CHUNK, rlosses, plosses, p_err,
            launches["remat"]["lstm_fwd"], launches["plain"]["lstm_fwd"],
            json.dumps(steps)))
    return launches, out


# -- phase 14 ----------------------------------------------------------------

# synth_dataset's small set for the mapped-signal tools
SYNTH_ARGS = ("--ntrain", "8", "--nholdout", "3", "--nbases", "600")
SYNTH_NTRAIN = 8


def _tool(main, argv):
    """A tool's main in process, its stdout and stderr kept: (exit code,
    stdout, stderr); a sys.exit() without a code is 0."""
    import io
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            code = main(argv)
        except SystemExit as e:
            code = e.code
    return code or 0, out.getvalue(), err.getvalue()


def round_trip_path(torch, dev, work, counters):
    """Phase 14a: the shipped remap checkpoint through `cli.dump_json`,
    `cli.json_to_checkpoint` and `cli.upgrade_model` (a no-op at version
    3): every parameter bitwise the shipped one's; then `cli.basecall` with
    its defaults on the card on the three real reads (phase 4's fast5):
    rows 7, 2 and 3 launched, the calls equal to phase 4's.  Returns
    (launches, calls file, stats)."""
    from taiyaki_tpu_torch.cli import (
        basecall, dump_json, json_to_checkpoint, upgrade_model)
    from taiyaki_tpu_torch.convert import flat_params
    from taiyaki_tpu_torch.utils import helpers
    d = os.path.join(work, "host_tools")
    os.makedirs(d)
    js = os.path.join(d, "remap.json")
    rt = os.path.join(d, "remap_rt.checkpoint")
    up = os.path.join(d, "remap_up.checkpoint")
    t0 = time.perf_counter()
    for main, argv in ((dump_json.main, ["--output", js, REMAP_MODEL]),
                       (json_to_checkpoint.main, ["--output", rt, js]),
                       (upgrade_model.main, [rt, up])):
        code, out, err = _tool(main, argv)
        check(code == 0, "{}: exit {}: {}".format(main.__module__, code,
                                                  err[-2000:]))
    secs = time.perf_counter() - t0
    check("Model already at version 3" in out,
          "upgrade_model: {}".format(out))
    want = flat_params(helpers.load_model(REMAP_MODEL)[1])
    got = flat_params(helpers.load_model(up)[1])
    check(sorted(got) == sorted(want), "round trip: parameters {} vs {}"
          .format(sorted(got), sorted(want)))
    for k in want:
        check(got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
              and got[k].tobytes() == want[k].tobytes(),
              "round trip: parameter {} differs from the shipped one's"
              .format(k))
    reads = os.path.join(work, "reads_real")
    for fn in counters.values():
        fn.launches = 0
    fa = os.path.join(d, "calls.fa")
    stats = basecall.main(["--output", fa, "--quiet", reads, up])
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters.items()}
    for k, n in launches.items():
        check(n > 0, "round-trip basecall never launched kernel {}"
              .format(k))
    calls, first = read_fastx(fa), read_fastx(os.path.join(work, "real.fa"))
    check(calls == first, "round-trip calls differ from phase 4's: {}"
          .format([rid for rid in first if calls.get(rid) != first[rid]]))
    say("checkpoint round trip (dump_json, json_to_checkpoint, "
        "upgrade_model: {:.2f} s): {} parameters bitwise the shipped "
        "checkpoint's; basecall of the result (defaults): {} reads, {} "
        "samples in {:.3f} s: {:.3f} ksample/s; launches {}; calls equal "
        "to phase 4's".format(
            secs, len(want), stats["ncalled"], stats["nsample"],
            stats["seconds"], stats["nsample"] / stats["seconds"] / 1e3,
            launches))
    return launches, fa, stats


def scoring_path(work, calls_fa):
    """Phase 14b: `cli.align` of the round-trip calls against the three
    references (the built-in aligner where no bwa is installed) and its
    assessment (no plot where matplotlib is absent): each read aligned to
    its own reference on +; its accuracy beside the semi-global identity,
    which must be at least 0.80.  Returns {read id: (accuracy, identity)}."""
    from taiyaki_tpu_torch.cli import align, assess_alignment
    from taiyaki_tpu_torch.data import mapped_signal_files
    d = os.path.dirname(calls_fa)
    with mapped_signal_files.MappedSignalReader(READS_HDF5) as msr:
        alphabet = msr.get_alphabet_information().alphabet
        refs = {r.read_id: "".join(alphabet[i] for i in r.Reference)
                for r in msr.reads()}
    refs_fa = os.path.join(d, "refs.fa")
    with open(refs_fa, "w") as fh:
        for rid in sorted(refs):
            fh.write(">{}\n{}\n".format(rid, refs[rid]))
    t0 = time.perf_counter()
    code, out, err = _tool(align.main, [calls_fa, "--reference", refs_fa])
    secs = time.perf_counter() - t0
    check(code == 0, "align: exit {}: {}".format(code, err[-2000:]))
    sam = os.path.splitext(calls_fa)[0] + ".sam"
    recs = {r.query: r for r in assess_alignment.samacc(sam)}
    check(sorted(recs) == sorted(refs), "align: reads assessed {} of {}"
          .format(sorted(recs), sorted(refs)))
    calls = read_fastx(calls_fa)
    res = {}
    for rid, r in sorted(recs.items()):
        check(r.reference == rid and r.strand == "+",
              "align: {} aligned to {} on {}".format(rid, r.reference,
                                                    r.strand))
        res[rid] = (r.accuracy, semiglobal_identity(calls[rid], refs[rid]))
    plot = os.path.splitext(calls_fa)[0] + ".png"
    say("align ({}, {:.2f} s; plot {}): {}".format(
        "bwa mem" if shutil.which("bwa") else "built-in aligner", secs,
        "written" if os.path.exists(plot) else "not written ({})".format(
            err.strip().splitlines()[-1] if err.strip() else "no stderr"),
        "; ".join("{} on + to its own reference: accuracy {:.4f}, "
                  "semi-global identity {:.4f}".format(rid, *v)
                  for rid, v in res.items())))
    summary = [line for line in out.splitlines()
               if line.startswith(("Mean accuracy", "Number of mapped"))]
    say("assess: {}".format("; ".join(summary)))
    worst = min(v[1] for v in res.values())
    check(worst >= 0.80, "round-trip calls: identity {:.4f} < 0.80".format(
        worst))
    return res


def msf_tools_path(work, mapped):
    """Phase 14c: the mapped-signal tools (h5py where installed, else
    data/hdf5.py, as on the card's host): `cli.synth_dataset` of a small
    set, `cli.check_mapped_signal_file` of its train.hdf5 and of phase 12's
    97-read file, `cli.merge_mappedsignalfiles` of the two and the check
    of the merged file (its reads the sum of both), and
    `cli.convert_alphabet_or_inspect_mapped_signal_file` inspecting it.
    Returns {tool: seconds}."""
    from taiyaki_tpu_torch.cli import (
        check_mapped_signal_file, convert_alphabet_or_inspect_mapped_signal_file
        as convert, merge_mappedsignalfiles, synth_dataset)
    from taiyaki_tpu_torch.data import mapped_signal_files
    d = os.path.join(work, "host_tools", "msf")
    synth = os.path.join(d, "synth")
    secs = {}

    def tool(name, main, argv):
        t0 = time.perf_counter()
        res = _tool(main, argv)
        secs[name] = secs.get(name, 0.0) + time.perf_counter() - t0
        check(res[0] == 0, "{}: exit {}: {}{}".format(name, res[0],
                                                     res[1][-2000:],
                                                     res[2][-2000:]))
        return res

    tool("synth_dataset", synth_dataset.main, [synth] + list(SYNTH_ARGS))
    train = os.path.join(synth, "train.hdf5")
    nreads = {}
    for name, path in (("synth", train), ("phase 12", mapped)):
        out = tool("check_mapped_signal_file", check_mapped_signal_file.main,
                   [path])[1]
        check("* Integrity check: pass" in out,
              "check {}: {}".format(name, out))
        with mapped_signal_files.MappedSignalReader(path) as msr:
            nreads[name] = len(msr.get_read_ids())
    check(nreads["synth"] == SYNTH_NTRAIN, "synth_dataset: {} reads".format(
        nreads["synth"]))
    merged = os.path.join(d, "merged.hdf5")
    tool("merge_mappedsignalfiles", merge_mappedsignalfiles.main,
         [merged, "--input", train, "None", "--input", mapped, "None"])
    out = tool("check_mapped_signal_file", check_mapped_signal_file.main,
               [merged])[1]
    check("* Integrity check: pass" in out, "check merged: {}".format(out))
    total = sum(nreads.values())
    err = tool("convert_alphabet", convert.main,
               [merged, "--print_only", "--print_read_total"])[2]
    check("contains {} total reads".format(total) in err,
          "merged file: {} (want {} reads)".format(err.strip(), total))
    say("mapped-signal tools ({}): synth {} reads, phase 12's file {} "
        "reads, merged {} reads, each check passes; seconds {}".format(
            "h5py" if mapped_signal_files._h5py() else "data/hdf5.py, no "
            "h5py", nreads["synth"], nreads["phase 12"], total,
            json.dumps({k: round(v, 3) for k, v in secs.items()})))
    return secs


# -- phase 15 ----------------------------------------------------------------

# the 2-rank step: the global batch (phase 3's shape) and rank 1's real
# rows (the rest of its half `_pad_batch` rows, seqlens 0)
DP_BATCH, DP_REAL1 = TB, TB // 2 - 16
# the counters a rank reads on the training path
DP_KERNELS = ("lstm_fwd", "lstm_bwd_acts", "crf_fwd", "crf_bwd", "logz_fwd",
              "logz_posteriors")


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _counters_by_name(names):
    """The launch counters of `names` ("lstm_fwd", "lstm_fwd[cluster]",
    "gate_gemm[tc]", ...) in a process of their own."""
    from taiyaki_tpu_torch.ops import crf, gemm, gru, logz, lstm
    mods = {"lstm": lstm, "gru": gru, "crf": crf, "logz": logz}
    out = {}
    for name in names:
        base, _, inst = name.partition("[")
        fn = getattr(gemm if base.endswith("gemm")
                     else mods[base.split("_")[0]], base)
        out[name] = fn.by_instance[inst[:-1]] if inst else fn
    return out


def dp_batches(seed):
    """Phase 15a's two global batches of DP_BATCH chunks (numpy Batch
    tuples): the second as drawn, the first with rank 1's half cut to
    DP_REAL1 real rows and padded back by the trainer's `_pad_batch`;
    and the model's kwargs."""
    from taiyaki_tpu_torch import train
    from taiyaki_tpu_torch.cli.train_flipflop import _pad_batch
    out = []
    for k in range(2):
        batch, kwargs = step_batch(seed + k, DP_BATCH, MLSTM)
        check(batch.signal.shape[1] == DP_BATCH, "2-rank step: {} chunks "
              "drawn".format(batch.signal.shape[1]))
        if k == 0:
            half = DP_BATCH // 2
            rank1 = _pad_batch(train.Batch(
                batch.signal[:, half:half + DP_REAL1],
                batch.seqs[half:half + DP_REAL1],
                batch.seqlens[half:half + DP_REAL1], None), half)
            batch = train.Batch(
                np.concatenate([batch.signal[:, :half], rank1.signal], 1),
                np.concatenate([batch.seqs[:half], rank1.seqs]),
                np.concatenate([batch.seqlens[:half], rank1.seqlens]), None)
        out.append(tuple(batch))
    return out, kwargs


def dp_steps(torch, dev, seed, batches, kwargs, rows, group, counters,
             ntime=3):
    """Two training steps of mLstm (`kwargs`) on the seeded weights, on
    the batches' `rows` (a slice) with the process `group` (AdamW at a
    constant 1e-4, no clipping), then `ntime` timed steps (synchronised
    host clock).  Returns the losses, the parameters after the two steps,
    the launches of those two steps and the timed steps' ms."""
    from taiyaki_tpu_torch import train

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    net = new_net(seed, kwargs, dev, MLSTM)
    params = train.leaf_params(net)
    opt, _ = train.make_optimizer(params, 1e-4, 10, 0, 1e-4, 1e-4)
    step = train.make_train_step(net, opt, group=group)
    threshs = np.full(len(params), np.inf, np.float32)
    dev_batches = [train.batch_to_device(train.Batch(
        b[0][:, rows], b[1][rows], b[2][rows], None), dev) for b in batches]
    for fn in counters.values():
        fn.launches = 0
    losses = [float(step(b, 1.0, threshs)[0]) for b in dev_batches]
    sync()
    launches = {k: fn.launches for k, fn in counters.items()}
    after = [p.detach().cpu().numpy().copy() for p in params]
    ms = []
    for _ in range(ntime):
        sync()
        t0 = time.perf_counter()
        step(dev_batches[1], 1.0, threshs)
        sync()
        ms.append((time.perf_counter() - t0) * 1e3)
    return dict(losses=losses, params=after, launches=launches, ms=ms)


def _dp_rank(rank, init, inputs, out_path):
    """Rank `rank` of phase 15a's job, in a process of its own on the
    parent's device: `dp_steps` on its half of the batches, its results
    pickled to out_path."""
    sys.path.insert(0, ROOT)
    import torch
    from taiyaki_tpu_torch.parallel import mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with open(inputs, "rb") as fh:
        dev, seed, batches, kwargs, names = pickle.load(fh)
    dev = torch.device(dev)
    half = batches[0][2].shape[0] // 2
    job = mesh.start(dev, init, 2, rank)
    try:
        res = dp_steps(torch, dev, seed, batches, kwargs,
                       slice(rank * half, (rank + 1) * half), job.group,
                       _counters_by_name(names))
        res["backend"] = job.backend
    finally:
        job.close()
    with open(out_path, "wb") as fh:
        pickle.dump(res, fh)


def two_rank_training(torch, dev, work, seed, counters):
    """Phase 15a: the data-parallel step of mLstm_flipflop at phase 3's
    shape in two ranks on the one card (processes of their own, gloo, as
    NCCL takes no two ranks on one card), DP_BATCH / 2 chunks each, rank
    1's share with `_pad_batch` rows, against one process's step on all
    DP_BATCH chunks: the losses of two steps 1e-5 relative, every
    parameter after them 1e-5 of its tensor's largest value, the ranks'
    parameters bitwise alike; each rank launched rows 1-6 of the training
    path (counted in its process over the two steps).  Returns (rank 0's
    launches, rank 1's, {ms of a step})."""
    import multiprocessing
    batches, kwargs = dp_batches(seed)
    ref = dp_steps(torch, dev, seed, batches, kwargs, slice(None), None,
                   counters)
    torch.cuda.empty_cache()
    d = os.path.join(work, "dp")
    os.makedirs(d)
    inputs = os.path.join(d, "inputs.pickle")
    with open(inputs, "wb") as fh:
        pickle.dump((str(dev), seed, batches, kwargs, sorted(counters)), fh)
    init = "file://" + os.path.join(d, "rendezvous")
    outs = [os.path.join(d, "rank{}.pickle".format(r)) for r in range(2)]
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_dp_rank, args=(r, init, inputs, outs[r]))
             for r in range(2)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(timeout=600)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    check(all(p.exitcode == 0 for p in procs), "2-rank training: exit "
          "codes {}".format([p.exitcode for p in procs]))
    ranks = []
    for out in outs:
        with open(out, "rb") as fh:
            ranks.append(pickle.load(fh))
    r0, r1 = ranks
    check(r0["backend"] == r1["backend"] == "gloo", "2-rank training: "
          "backend {}".format(r0["backend"]))
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(r0["losses"],
                                                       ref["losses"]))
    check(loss_err <= 1e-5, "2-rank training: losses {} against one "
          "rank's {}".format(r0["losses"], ref["losses"]))
    param_err = max(float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))
                    for a, b in zip(r0["params"], ref["params"]))
    check(param_err <= 1e-5, "2-rank training: parameters {:.3g} of their "
          "largest from one rank's".format(param_err))
    check(r0["losses"] == r1["losses"] and all(
        np.array_equal(a, b) for a, b in zip(r0["params"], r1["params"])),
        "2-rank training: the ranks' replicas differ")
    for r, res in enumerate(ranks):
        for k in DP_KERNELS:
            check(res["launches"].get(k, 0) > 0, "2-rank training: rank {} "
                  "never launched {}".format(r, k))
    ms = {"one rank, {} chunks".format(DP_BATCH): float(np.median(
              ref["ms"])),
          "2 ranks on one card, {} chunks each (slower rank)".format(
              DP_BATCH // 2): max(float(np.median(r["ms"])) for r in ranks)}
    say("2-rank training (mLstm {}/5/19, chunk {}, {} + {} chunks, rank 1 "
        "{} real; gloo on one card): losses {} against one rank's {} (max "
        "relative err {:.3g}, tol 1e-5); parameters after 2 steps within "
        "{:.3g} of their largest (tol 1e-5), the replicas bitwise alike; "
        "step ms {} (each rank's: {}, {}); launches rank 0 {}, rank 1 {}"
        .format(H, CHUNK, DP_BATCH // 2, DP_BATCH // 2, DP_REAL1,
                ["{:.7f}".format(v) for v in r0["losses"]],
                ["{:.7f}".format(v) for v in ref["losses"]], loss_err,
                param_err, json.dumps(ms), r0["ms"], r1["ms"],
                r0["launches"], r1["launches"]))
    return r0["launches"], r1["launches"], ms


def multihost_cli(torch, work, seed, counters, niter=3):
    """Phase 15b: `cli.train_flipflop --multihost` in a job of one rank
    (NCCL, its rendezvous from the TAIYAKI_* variables) against the plain
    CLI, same seed and arguments at phase 3's shape, `niter` iterations:
    batch.log byte for byte the plain run's; rows 1-6 launched.  Both
    run with cuDNN's deterministic algorithms: its default convolution
    backward sums in no fixed order, and two plain runs then differ in
    the last bits of the convolutions' gradients.  Returns (launches,
    stats)."""
    logs, stats = {}, {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for tag in ("plain", "multihost"):
            launches, stats[tag], logs[tag], model_log = _train_cli(
                torch, work, seed, counters, tag, niter)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    check("* Rank 0 of 1 on cuda:0; gradients all-reduced over nccl"
          in model_log, "--multihost: model.log names no NCCL rank")
    for k in DP_KERNELS:
        check(launches.get(k, 0) > 0, "--multihost never launched "
              "{}".format(k))
    rows = logs["plain"].splitlines()[1:]
    check(len(rows) == niter and logs["multihost"] == logs["plain"],
          "--multihost batch.log differs from the plain run's:\n{}\n{}"
          .format(logs["multihost"], logs["plain"]))
    say("train_flipflop --multihost (one rank, NCCL; mLstm {}/5/19, chunk "
        "{}, {} chunks, {} iterations; cuDNN deterministic in both): "
        "batch.log byte for byte the plain run's (losses {}); {:.3f} s in "
        "the loop against {:.3f}; launches {}".format(
            H, CHUNK, TB, niter, ", ".join(r.split("\t")[1] for r in rows),
            stats["multihost"]["seconds"], stats["plain"]["seconds"],
            launches))
    return launches, stats["multihost"]


def _train_cli(torch, work, seed, counters, tag, niter):
    """One run of multihost_cli's training CLI, `tag` "plain" or
    "multihost": (launches, stats, batch.log, model.log)."""
    from taiyaki_tpu_torch.cli import train_flipflop
    _, model_py, stride = MLSTM
    outdir = os.path.join(work, "train_" + tag)
    env, extra = {}, []
    if tag == "multihost":
        env = {"TAIYAKI_COORDINATOR": "localhost:{}".format(_free_port()),
               "TAIYAKI_NUM_PROCS": "1", "TAIYAKI_PROC_ID": "0"}
        extra = ["--multihost"]
    for fn in counters.values():
        fn.launches = 0
    with switches(env):
        stats = train_flipflop.main(extra + [
            "--size", str(H), "--stride", str(stride), "--winlen", "19",
            "--chunk_len_min", str(CHUNK), "--chunk_len_max", str(CHUNK),
            "--min_sub_batch_size", str(TB), "--niteration", str(niter),
            "--warmup_batches", "1", "--save_every", str(niter),
            "--sample_nreads_before_filtering", "1000",
            "--reporting_sub_batches", "1", "--seed", str(seed), "--quiet",
            "--outdir", outdir, model_py, reads_of(MLSTM)])
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters.items()}
    logs = []
    for name in ("batch.log", "model.log"):
        with open(os.path.join(outdir, name)) as fh:
            logs.append(fh.read())
    return (launches, stats) + tuple(logs)


def sharded_basecall(torch, dev, work, model, reads, counters):
    """Phase 15c: phase 3's basecall (the trained mLstm checkpoint, its
    synthetic reads, the CLI's defaults) through `Basecaller` on [card 0,
    card 0] (`cli.basecall.main(..., devices=...)`): calls equal phase
    3's, or per chunk of two reads, a path that differs scores the
    one-device best within 1e-4 under the one-device scores; rows 1-3
    launched.  One batch of B chunks of the fasta path (paths alone back
    to the host) timed on one device and on two (synchronised host
    clock, the median of 3 calls each).  `--ndevices 2` on this
    one-card host exits with the JAX CLI's message.  Returns (launches,
    stats, {ms})."""
    from taiyaki_tpu_torch.cli import basecall
    from taiyaki_tpu_torch.convert import load_jax_params
    from taiyaki_tpu_torch.data import fast5utils
    from taiyaki_tpu_torch.utils import helpers
    for fn in counters.values():
        fn.launches = 0
    fa = os.path.join(work, "mLstm_sharded.fa")
    stats = basecall.main(["--output", fa, "--quiet", reads, model],
                          devices=[dev, dev])
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters.items()}
    for k, n in launches.items():
        check(n > 0, "sharded basecall never launched kernel {}".format(k))
    calls, first = read_fastx(fa), read_fastx(os.path.join(work,
                                                           "mLstm.fa"))
    same = [rid for rid in first if calls.get(rid) == first[rid]]
    net, params, *_ = helpers.load_model(model)
    net = load_jax_params(net, params).to(dev).eval()
    stride = net.stride
    parts = []
    for fname, rid in fast5utils.iterate_fast5_reads(reads):
        parts.append(basecall.prepare_read(
            rid, basecall.get_signal(fname, rid), T * stride, 100 * stride,
            None, False)["chunks"])
    chunks = np.concatenate(parts, axis=1)[:, :B]
    res, ms = [], {}
    for devices in ([dev], [dev, dev]):
        with torch.inference_mode():
            caller = basecall.Basecaller(net, 40, True, 1.0, B, devices,
                                         want_trans=True)
            res.append(caller.gather(caller.submit(chunks)))
            # the fasta path's batch: paths alone back to the host
            caller = basecall.Basecaller(net, 40, True, 1.0, B, devices)
            times = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                caller.gather(caller.submit(chunks))
                times.append((time.perf_counter() - t0) * 1e3)
        ms["{} device(s)".format(len(devices))] = float(np.median(times))
    (paths1, _, _, trans1), (paths2, _, _, _) = res
    ndiff, gap = 0, 0.0
    for i in range(chunks.shape[1]):
        if np.array_equal(paths1[:, i], paths2[:, i]):
            continue
        ndiff += 1
        gap = max(gap, abs(path_score(trans1[:, i], paths1[:, i], NBASE)
                           - path_score(trans1[:, i], paths2[:, i], NBASE)))
    check(gap <= 1e-4, "sharded Viterbi paths score {} below the one-device "
          "best (tie tolerance 1e-4)".format(gap))
    check(len(same) == len(first) or ndiff > 0,
          "sharded and one-device calls differ with equal chunk paths")
    code, _, _ = _tool(basecall.main, ["--ndevices", "2", reads, model])
    check("--ndevices 2 requested but only 1 local devices are available"
          in str(code), "--ndevices 2 on one card: {}".format(code))
    say("sharded basecall (mLstm, 2 replicas on card 0): {} of {} calls "
        "equal to phase 3's; {} of {} chunks with another Viterbi path "
        "(score gap {:.3g}, tol 1e-4); {} samples in {:.3f} s: {:.3f} "
        "ksample/s; one batch of {} chunks, ms {}; launches {}; --ndevices 2 "
        "here: {!r}".format(len(same), len(first), ndiff, chunks.shape[1],
                           gap, stats["nsample"], stats["seconds"],
                           stats["nsample"] / stats["seconds"] / 1e3, B,
                           json.dumps(ms), launches, code))
    return launches, stats, ms


def analysis_tools_path(work, mapped, seed):
    """Phase 15d: the analysis tools on the card's host (no matplotlib):
    `cli.split_strandlist` of phase 12's read ids, `cli.check_hdf5_contents`
    of phase 12's file, `cli.motif` of sites on the three references, and
    `cli.calibrate_qscores_byread` on a --fastq basecall of phase 4's real
    reads (the shipped remap checkpoint) aligned by `cli.align`: its slope
    and shift, or the tool's own reason for not fitting.  Returns {tool:
    seconds}."""
    from taiyaki_tpu_torch.cli import (
        align, basecall, calibrate_qscores_byread, check_hdf5_contents,
        motif, split_strandlist)
    from taiyaki_tpu_torch.data import mapped_signal_files
    from taiyaki_tpu_torch.utils.plotting import pyplot
    d = os.path.join(work, "analysis")
    os.makedirs(d)
    secs = {}

    def tool(name, main, argv):
        t0 = time.perf_counter()
        res = _tool(main, argv)
        secs[name] = time.perf_counter() - t0
        check(res[0] == 0, "{}: exit {}: {}{}".format(
            name, res[0], res[1][-2000:], res[2][-2000:]))
        return res

    with mapped_signal_files.MappedSignalReader(mapped) as msr:
        ids = msr.get_read_ids()
    strands = os.path.join(d, "strands.tsv")
    with open(strands, "w") as fh:
        fh.write("read_id\n" + "".join(r + "\n" for r in ids))
    tool("split_strandlist", split_strandlist.main,
         ["--nparts", "3", strands])
    parts = []
    for i in range(3):
        with open("{}_part{}.tsv".format(strands, i)) as fh:
            parts += fh.read().splitlines()[1:]
    check(parts == ids, "split_strandlist: {} of {} ids".format(
        len(parts), len(ids)))
    out = tool("check_hdf5_contents", check_hdf5_contents.main, [mapped])[1]
    ndata = out.count(" dataset shape=")
    check(out.startswith("Root attrs:") and ndata >= len(ids),
          "check_hdf5_contents: {} datasets for {} reads".format(
              ndata, len(ids)))
    refs_fa = os.path.join(work, "host_tools", "refs.fa")
    refs = read_fastx(refs_fa)
    rng = np.random.default_rng(seed)
    coords = os.path.join(d, "coords.tsv")
    with open(coords, "w") as fh:
        fh.write("filename\tpos\n")
        for rid, seq in sorted(refs.items()):
            for p in rng.integers(20, len(seq) - 20, 50):
                fh.write("{}\t{}\n".format(rid, p))
    out = tool("motif", motif.main, [refs_fa, coords])[1]
    check(len(out.splitlines()) == 31, "motif: {}".format(out[-2000:]))
    fq = os.path.join(d, "real.fastq")
    t0 = time.perf_counter()
    basecall.main(["--output", fq, "--fastq", "--quiet",
                   os.path.join(work, "reads_real"), REMAP_MODEL])
    secs["basecall --fastq"] = time.perf_counter() - t0
    tool("align", align.main, [fq, "--reference", refs_fa])
    fits = {}
    for floor in ("7.0", "0"):
        # the default q floor, then none: the remap checkpoint's q-scores
        # are uncalibrated
        t0 = time.perf_counter()
        code, out, err = _tool(calibrate_qscores_byread.main, [
            "--fastq", fq, "--alignment_summary",
            os.path.join(d, "real.samacc"), "--min_fastqscore", floor,
            "--plot_filename", os.path.join(d, "cal.png")])
        secs["calibrate_qscores_byread"] = time.perf_counter() - t0
        lines = [line.strip() for line in out.splitlines()
                 if line.startswith(("    After", "Best-fit s"))]
        check(code == 0 and len(lines) == 3
              or code == 1 and "needed to fit" in err,
              "calibrate_qscores_byread: exit {}: {}{}".format(
                  code, out[-2000:], err[-2000:]))
        fits["--min_fastqscore " + floor] = "; ".join(
            lines + [err.strip()] if err.strip() else lines)
    say("analysis tools (matplotlib {}): split_strandlist {} ids in 3 "
        "parts; check_hdf5_contents {} datasets; motif {} offsets; "
        "calibrate_qscores_byread on the {} real reads: {}; seconds {}"
        .format("absent" if pyplot() is None else "present", len(ids),
                ndata, 31, len(refs), json.dumps(fits),
                json.dumps({k: round(v, 3) for k, v in secs.items()})))
    return secs


# -- phase 16 ----------------------------------------------------------------

# the bf16 streams (ops/rnn.py) as a training policy: (name, switches)
BF16_STREAMS = ("bf16", {"TAIYAKI_TPU_BF16_STREAMS": "1"})
# (name, x, h, dh) of the bf16 instances' cases: a later layer (every
# stream bf16), the first layer (x f32), and TAIYAKI_TPU_F32_GATES=1 (h f32,
# so the layer above's d_x, this layer's dh, f32)
BF16_CASES = (("later layer", "bfloat16", "bfloat16", "bfloat16"),
              ("first layer", "float32", "bfloat16", "bfloat16"),
              ("F32_GATES", "float32", "float32", "float32"))
# of a bf16 output, the share at most one bf16 step from its twin's
BF16_SHARE = 0.01
# the bf16 instances' rows: (name, its f32 row, the TPU kernel's file and
# line under taiyaki_tpu/ops/); the LSTM's (phase 16), the GRU's (phase
# 17), the CRF's and logZ's (phase 18), then the scans' (phase 19)
BF16_ROWS = (("lstm_fwd[bf16]", "lstm_fwd", "pallas_rnn.py:880"),
             ("lstm_bwd_acts[bf16]", "lstm_bwd_acts", "pallas_rnn.py:385"),
             ("lstm_bwd_fusedw[bf16]", "lstm_bwd_fusedw",
              "pallas_rnn.py:456"),
             ("lstm_bwd_recompute[bf16]", "lstm_bwd_recompute",
              "pallas_rnn.py:625"),
             ("gru_fwd[bf16]", "gru_fwd", "pallas_rnn.py:995"),
             ("gru_bwd_recompute[bf16]", "gru_bwd_recompute",
              "pallas_rnn.py:1311"),
             ("gru_bwd_fusedw[bf16]", "gru_bwd_fusedw", "pallas_rnn.py:1184"),
             ("logz_fwd[bf16]", "logz_fwd", "pallas_logz.py:142"),
             ("logz_posteriors[bf16]", "logz_posteriors",
              "pallas_logz.py:249"),
             ("crf_fwd[bf16]", "crf_fwd", "pallas_crf.py:423"),
             ("crf_bwd[bf16]", "crf_bwd", "pallas_crf.py:565"),
             ("lstm_scan_fwd[bf16]", "lstm_scan_fwd", "pallas_rnn.py:141"),
             ("lstm_scan_bwd[bf16]", "lstm_scan_bwd", "pallas_rnn.py:726"),
             ("gru_scan_fwd[bf16]", "gru_scan_fwd", "pallas_rnn.py:1082"),
             ("gru_scan_bwd[bf16]", "gru_scan_bwd", "pallas_rnn.py:1407"),
             ("crf_fwd_streams[bf16]", "crf_fwd_streams",
              "pallas_crf.py:108"),
             ("crf_grad_streams[bf16]", "crf_grad_streams",
              "pallas_crf.py:218"),
             ("crf_fwd_streams[mixed]", "crf_fwd_streams",
              "pallas_crf.py:108"),
             ("crf_grad_streams[mixed]", "crf_grad_streams",
              "pallas_crf.py:218"),
             ("logz_fwd[mixed]", "logz_fwd", "pallas_logz.py:142"),
             ("logz_posteriors[mixed]", "logz_posteriors",
              "pallas_logz.py:249"))
# the names of the score-stream route's instances and logZ's mixed one
# (phase 20), the scans', the LSTM layers', the GRU layers' and the score
# rows' bf16 instances
STREAM_BF16 = tuple(n for n, _, _ in BF16_ROWS
                    if "_streams[" in n or "[mixed]" in n)
SCAN_BF16 = tuple(n for n, _, _ in BF16_ROWS if "_scan_" in n)
LSTM_BF16 = tuple(n for n, _, _ in BF16_ROWS
                  if n.startswith("lstm") and n not in SCAN_BF16)
GRU_BF16 = tuple(n for n, _, _ in BF16_ROWS
                 if n.startswith("gru") and n not in SCAN_BF16)
SCORE_BF16 = tuple(n for n, _, _ in BF16_ROWS
                   if n.startswith(("crf", "logz")) and n not in STREAM_BF16)
# the step under the switch against the f32 step (the CPU tests' terms)
BF16_LOSS_TOL, BF16_GRAD_TOL = 5e-3, 2e-2


def bf16_err(torch, got, want, atol):
    """A bf16 output against its twin's: (max |diff|, the share of
    elements that differ, whether they are equal as bf16 but for at most
    BF16_SHARE of them one bf16 step apart, or `atol` where a step is
    smaller)."""
    check(got.dtype == want.dtype == torch.bfloat16
          and got.shape == want.shape, "bf16 output: {} {} against {} "
          "{}".format(got.dtype, tuple(got.shape), want.dtype,
                      tuple(want.shape)))
    g, w = got.float(), want.float()
    step = torch.ldexp(torch.ones_like(w), torch.frexp(
        torch.maximum(g.abs(), w.abs()))[1] - 8)
    diff = (g - w).abs()
    share = (diff > 0).float().mean().item()
    ok = bool((diff <= step.clamp(min=atol)).all()) and share <= BF16_SHARE
    return diff.max().item(), share, ok


def _bf16_layer(torch, dev, rng, t, b, h):
    """x, iW, b, sW and dh (all f32; x and dh cast to each case's types)
    of one seeded LSTM layer at D=H."""
    return (_tensor(torch, dev, rng.normal(size=(t, b, h))),
            _tensor(torch, dev, rng.normal(size=(4 * h, h)) / np.sqrt(h)),
            _tensor(torch, dev, 0.5 * rng.normal(size=4 * h)),
            _tensor(torch, dev, rng.normal(size=(4 * h, h)) / np.sqrt(h)),
            _tensor(torch, dev, rng.normal(size=(t, b, h))))


def _bf16_out_err(torch, got, want, atol):
    """An output of a bf16 instance against its twin's: a bf16 one as
    `bf16_err`, an f32 one (h or d_x of an f32 stream) within `atol`:
    (max |diff|, the share of bf16 elements that differ, ok)."""
    if want.dtype == torch.bfloat16:
        return bf16_err(torch, got, want, atol)
    check(got.dtype == want.dtype and got.shape == want.shape,
          "output: {} {} against {} {}".format(
              got.dtype, tuple(got.shape), want.dtype, tuple(want.shape)))
    d = max_abs_diff(got, want)
    return d, 0.0, d <= atol


def _bf16_bounds():
    """The bounds of the bf16 rows at the training shape (bf16 streams at
    2 bytes; a product with a bf16 operand at MIXED_S_PER_FLOP)."""
    nbh = 2 * TT * TB * H            # one bf16 [T, B, H] stream
    nw = 4 * 4 * H * (2 * H + 1)     # the weights, f32, D = H
    one = 2 * TT * TB * 4 * H * H    # one 4H x H product over T B rows
    return {
        # x, h, c, acts, tc; gx of a bf16 x
        "lstm_fwd[bf16]": bound_ms((1 + 1 + 1 + 4 + 1) * nbh + nw, one, 0,
                                   one),
        # dh, acts or pre, tc or c, c_prev, h; x read, d_x written; d_x
        # on f32 operands, d_iW and d_sW on a bf16 one
        "lstm_bwd_acts[bf16]": bound_ms(10 * nbh + 2 * nw, one, one,
                                        2 * one),
        "lstm_bwd_fusedw[bf16]": bound_ms(10 * nbh + 2 * nw, one, one,
                                          2 * one),
        # dh, c, h; x read, d_x written; pre rebuilt by two products
        "lstm_bwd_recompute[bf16]": bound_ms(5 * nbh + 2 * nw, one, one,
                                             4 * one)}


def check_bf16_kernels(torch, dev, rng, f32_rows):
    """Phase 16a: the bf16 instances of rows 1 (each emit mode), 4, 11
    and 12 at the mLstm training shape (T=TT, B=TB, H=D=256) on their
    plans' cluster instances, in each case of BF16_CASES, and at H=512
    (T=200, B=64) on the L2 ones in the first case, both directions,
    against their twins: a bf16 output as `bf16_err` (atol 1e-4, of the
    largest |d_x| for d_x), an f32 h within 1e-4, an f32 d_x within 1e-4
    of its largest, the weight gradients within 1e-4 relative (summed
    over their partials).  Each row timed (training shape, later layer)
    beside its f32 row's ms (`f32_rows`, phase 2's at the same shape and
    emit "acts") and its twin's.  Returns the four rows of the kernels
    line, without their launches."""
    from taiyaki_tpu_torch.ops import lstm
    bf = torch.bfloat16
    fns = {"lstm_fwd[bf16]": (lstm.lstm_fwd, lstm.lstm_fwd_plain),
           "lstm_bwd_acts[bf16]": (lstm.lstm_bwd_acts,
                                   lstm.lstm_bwd_acts_plain),
           "lstm_bwd_fusedw[bf16]": (lstm.lstm_bwd_fusedw,
                                     lstm.lstm_bwd_fusedw_plain),
           "lstm_bwd_recompute[bf16]": (lstm.lstm_bwd_recompute,
                                        lstm.lstm_bwd_recompute_plain)}
    err = dict.fromkeys(fns, 0.0)
    share = dict.fromkeys(fns, 0.0)
    case_err = {}
    ms, plain_ms, h512 = {}, {}, {}
    for t, b, h, cases in ((TT, TB, H, BF16_CASES),
                           (200, 64, 512, BF16_CASES[:1])):
        x32, iW, bias, sW, dh32 = _bf16_layer(torch, dev, rng, t, b, h)
        fplan, bplan = (plan_of("lstm", h, b, bwd)[0] for bwd in (0, 1))
        want_inst = "cluster" if h == H else "l2"
        check(fplan.instance == bplan.instance == want_inst,
              "bf16 rows at H={}: plans {} {}".format(h, fplan, bplan))
        before = {k: dict((i, c.launches) for i, c in
                          fns[k][0].bf16_by_instance.items()) for k in fns}
        for case, xdt, hdt, dhdt in cases:
            xdt, hdt, dhdt = (getattr(torch, n) for n in (xdt, hdt, dhdt))
            x, dh = x32.to(xdt), dh32.to(dhdt)
            where = "{} (x {}, h {}, dh {}) H={}".format(
                case, xdt, hdt, dhdt, h)
            worst = case_err.setdefault(case, [0.0, 0.0])
            for reverse in (False, True):
                for emit in lstm.EMITS:
                    kw = dict(reverse=reverse, emit=emit, h_dtype=hdt,
                              res_dtype=bf)
                    got, want = (f(x, iW, bias, sW, **kw) for f in fns[
                        "lstm_fwd[bf16]"])
                    torch.cuda.synchronize()
                    got, want = ((got, want) if isinstance(got, tuple)
                                 else ((got,), (want,)))
                    for g, w in zip(got, want):
                        d, s, ok = _bf16_out_err(torch, g, w, 1e-4)
                        check(ok, "lstm_fwd[bf16] emit={} {}: |diff| {}, "
                              "share {}".format(emit, where, d, s))
                        err["lstm_fwd[bf16]"] = max(err["lstm_fwd[bf16]"],
                                                    d)
                        share["lstm_fwd[bf16]"] = max(
                            share["lstm_fwd[bf16]"], s)
                        worst[0] = max(worst[0], d)
                    del got, want
                hh, c, acts, tc = lstm.lstm_fwd_plain(
                    x, iW, bias, sW, reverse, "acts", hdt, bf)
                pre = lstm.lstm_fwd_plain(x, iW, bias, sW, reverse, "pre",
                                          hdt, bf)[2]
                cp = lstm.prev_state(c, reverse)
                args = {"lstm_bwd_acts[bf16]": (dh, acts, tc, cp, hh, x, sW,
                                                iW),
                        "lstm_bwd_fusedw[bf16]": (dh, pre, c, cp, hh, x, sW,
                                                  iW),
                        "lstm_bwd_recompute[bf16]": (dh, c, hh, x, sW, iW,
                                                     bias)}
                for k, a in args.items():
                    fn, plain = fns[k]
                    got, want = fn(*a, reverse=reverse), plain(
                        *a, reverse=reverse)
                    torch.cuda.synchronize()
                    scale = want[0].float().abs().max().item()
                    d, s, ok = _bf16_out_err(torch, got[0], want[0],
                                             1e-4 * scale)
                    e = max(rel_err(g.sum(0), w.sum(0))
                            for g, w in zip(got[1:], want[1:]))
                    check(ok and e <= 1e-4, "{} {}: d_x |diff| {} (share "
                          "{}), the weight gradients' largest relative err "
                          "{}".format(k, where, d, s, e))
                    err[k], share[k] = max(err[k], e), max(share[k], s)
                    worst[1] = max(worst[1], e, d / scale)
                    del got, want
                if not reverse and case == cases[0][0]:
                    timed = {"lstm_fwd[bf16]": (
                        lambda: lstm.lstm_fwd(x, iW, bias, sW, emit="acts",
                                              h_dtype=hdt, res_dtype=bf),
                        lambda: lstm.lstm_fwd_plain(x, iW, bias, sW, False,
                                                    "acts", hdt, bf))}
                    for k, a in args.items():
                        timed[k] = ((lambda f=fns[k][0], a=a: f(*a)),
                                    (lambda f=fns[k][1], a=a: f(*a)))
                    for k, (f, p) in timed.items():
                        if h == H:
                            ms[k] = cuda_ms(torch, f, reps=3)
                            plain_ms[k] = cuda_ms(torch, p, reps=1,
                                                  warmup=0)
                        else:
                            h512[k] = cuda_ms(torch, f, reps=1)
                del hh, c, acts, tc, pre, cp, args
            del x, dh
        for k, (fn, _) in fns.items():
            after = {i: c.launches for i, c in fn.bf16_by_instance.items()}
            n = len(cases) * 2 * (len(lstm.EMITS) if k == "lstm_fwd[bf16]"
                                  else 1) + 1
            check(after[want_inst] - before[k][want_inst] >= n and all(
                after[i] == before[k][i] for i in after if i != want_inst),
                "{} H={}: bf16 launches by instance {} -> {}".format(
                    k, h, before[k], after))
        del x32, iW, bias, sW, dh32
        torch.cuda.empty_cache()
    say("bf16 instances T={} B={} D=H={} by case (x, h, dh types), both "
        "directions: the forwards' largest |diff| and the backwards' "
        "largest relative err (d_x of its largest, weight gradients): "
        "{}".format(TT, TB, H, json.dumps(case_err)))
    bounds = _bf16_bounds()
    rows = []
    for name, f32_name, line in BF16_ROWS:
        if name not in fns:
            continue
        f32 = f32_rows[f32_name]
        rows.append(dict(
            name=name, route="cuda", source="taiyaki_tpu_torch/csrc/lstm.cu",
            replaces="taiyaki_tpu/ops/" + line,
            max_abs_err=err[name], bf16_share=share[name], ms=ms[name],
            plain_ms=plain_ms[name], bound_ms=bounds[name][0],
            bound_by=bounds[name][1], library_ms=f32["library_ms"],
            f32_ms=f32["ms"], h512_ms=h512[name]))
        say("{} T={} B={} D=H={} (the three cases; timed with x, h, dh "
            "bf16; the cluster instances): "
            "max err {:.3g} ({}), bf16 outputs one step apart {:.3g} of "
            "them (at most {}), {:.3f} ms against the f32 row's {:.3f} ms, "
            "twin {:.3f} ms, bound {:.3f} ms ({}); H=512 (T=200, B=64, L2 "
            "instances) {:.3f} ms".format(
                name, TT, TB, H, err[name], "|diff|" if "fwd" in name
                else "relative", share[name], BF16_SHARE, ms[name], f32["ms"],
                plain_ms[name], bounds[name][0], bounds[name][1],
                h512[name]))
    return rows


def check_bf16_gemms(torch, dev):
    """Phase 16b: the tc GEMMs with the bf16 operands the layers give them
    at the mLstm training shape (M = TT TB rows, D=H=256): the gate
    product of a bf16 x, d_x with a bf16 output, d_iW of a bf16 x and
    d_sW of a bf16 h one step back; each against its twin (f32 outputs
    within GEMM_TOL of the largest, the bf16 one as `bf16_err`) and timed
    beside the same product on the widened (f32) operands.  Returns the
    rows of the gemms line (their path the bf16 training path)."""
    from taiyaki_tpu_torch.ops import gemm
    bf = torch.bfloat16
    M, G = TT * TB, 4 * H
    sms = gemm.card_sms(torch.cuda.current_device())
    rows = []
    cases = (("gate", "gx of a bf16 x", (M, G, H), "A"),
             ("gate", "d_x in bf16", (M, H, G), "out"),
             ("atb", "d_iW of a bf16 x", (G, H, M), "B"),
             ("atb", "d_sW of a bf16 h", (G, H, M), "B"))
    for kind, what, (M_, N, K), side in cases:
        g = torch.Generator(device=dev).manual_seed(M_ + N + K)
        if kind == "gate":
            A = torch.randn(M_, K, device=dev, generator=g)
            W = torch.randn(N, K, device=dev, generator=g) / K ** 0.5
            bias = torch.randn(N, device=dev, generator=g)
            if side == "A":
                A = A.to(bf)
                args, kw, f32_args = (A, W, bias), {}, (A.float(), W, bias)
            else:
                args, kw, f32_args = (A, W), {"out_dtype": bf}, (A, W)
            fn, nsplit = gemm.gate_gemm, 1
            plain = gemm.gate_gemm_plain
            bytes_ = (2 if side == "A" else 4) * M_ * K + 4 * (N * K + N) \
                + (2 if side == "out" else 4) * M_ * N
        else:
            A = torch.randn(K, M_, device=dev, generator=g)
            Bm = torch.randn(K, N, device=dev, generator=g).to(bf)
            shift = 0 if "d_iW" in what else -TB
            plan = gemm.gemm_plan(M_, N, K, gemm.ATB, sms, bf16=True)
            args, kw, f32_args = (A, Bm, shift), {}, (A, Bm.float(), shift)
            fn, nsplit = gemm.atb_gemm, plan.nsplit

            def plain(A, Bm, shift, _p=plan):
                return gemm.atb_gemm_plain(A, Bm, shift, _p.nsplit,
                                           _p.kslice)
            bytes_ = 4 * K * M_ + 2 * K * N + 4 * nsplit * M_ * N
        n = fn.bf16.launches
        got, want = fn(*args, **kw), plain(*args, **kw)
        torch.cuda.synchronize()
        check(fn.bf16.launches == n + 1, "{}: no bf16 launch".format(what))
        if side == "out":
            d, s, ok = bf16_err(torch, got, want,
                                GEMM_TOL * want.float().abs().max().item())
            err = d / want.float().abs().max().item()
            check(ok, "{}: |diff| {} share {}".format(what, d, s))
        else:
            err = max_abs_diff(got, want) / want.abs().max().item()
            check(err <= GEMM_TOL, "{}: {:.3g} of the largest output from "
                  "its twin > {}".format(what, err, GEMM_TOL))
        del got, want
        t = cuda_ms(torch, lambda: fn(*args, **kw), reps=5)
        t32 = cuda_ms(torch, lambda: fn(*f32_args), reps=5)
        plain_ms = cuda_ms(torch, lambda: plain(*args, **kw), reps=3)
        flops = 2 * M_ * N * K
        bound, by = (bound_ms(bytes_, 0, flops) if side == "out"
                     else bound_ms(bytes_, 0, 0, flops))
        rows.append(dict(
            name="{}_gemm".format(kind), cell="mLstm bf16", product=what,
            shape=[M_, N, K], route="cuda",
            source="taiyaki_tpu_torch/csrc/gemm_tc.cuh",
            replaces=("taiyaki_tpu/ops/pallas_rnn.py:805" if kind == "gate"
                      else "taiyaki_tpu/ops/pallas_rnn.py:299"),
            path="mLstm training bf16", bf16=True, max_abs_err=err, ms=t,
            f32_ms=t32, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
            library_ms=plain_ms, tflops=flops / t / 1e9))
        say("{} ({} M={} N={} K={}): tc {:.3f} ms ({:.1f} TFLOP/s; bound "
            "{:.3f} ms, {}), the same on f32 operands {:.3f} ms, twin "
            "(torch.matmul on the widened operands) {:.3f} ms; {:.3g} of the "
            "largest output from the twin".format(
                what, kind, M_, N, K, t, flops / t / 1e9, bound, by, t32,
                plain_ms, err))
        del A, args, f32_args
        torch.cuda.empty_cache()
    return rows


def _median_step(torch, dev, seed, model, batch, kwargs):
    """A full training step of `model` on `batch` (seeded weights, AdamW;
    a cat_mod model at the mod factor of loss_args): the median
    synchronised wall time (ms) of 3 steps after a warm-up and the peak
    device memory (bytes) over them."""
    from taiyaki_tpu_torch import train
    net = new_net(seed, kwargs, dev, model)
    args, factor = loss_args(net)
    params = train.leaf_params(net)
    opt, _ = train.make_optimizer(params, 4e-3, 8, 2, 1e-4, 1e-4)
    threshs = np.full(len(params), np.inf, np.float32)
    b = train.batch_to_device(batch, dev)
    step = train.make_train_step(net, opt, *args)
    step(b, 1.0, threshs, *factor)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        step(b, 1.0, threshs, *factor)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated(dev)
    del net, opt, b, step
    return float(np.median(times)), peak


@contextlib.contextmanager
def scores_kept_f32():
    """Within: the CRF and logZ in f32 whatever the switch says (ops/
    flipflop.py `_score_dtypes`, the scores' and the lattices' dtypes,
    patched): the step under the switch with the layers' bf16 streams
    alone, as phases 16c and 17b hold it and as the slices before phase
    18's ran it."""
    from taiyaki_tpu_torch.ops import flipflop
    import torch
    real = flipflop._score_dtypes
    flipflop._score_dtypes = lambda: (torch.float32, torch.float32)
    try:
        yield
    finally:
        flipflop._score_dtypes = real


def bf16_steps(torch, dev, seed, counters, model=MLSTM,
               policies=LSTM_POLICIES, timed=LSTM_POLICIES[:1]):
    """Phase 16c (17b for mGru): the full-width step of `model` (TB
    chunks x CHUNK samples) under the switch against the f32 step on the
    same batch and weights: the loss within BF16_LOSS_TOL relative and
    each gradient within BF16_GRAD_TOL of its largest (the CPU tests'
    terms), the CRF and logZ kept f32 (`scores_kept_f32`: these phases
    hold the layers' streams; phase 18b runs the step with the CRF's and
    logZ's bf16 instances too), under each residual policy of `policies`
    (the f32 step's of the same policy); each policy's step under the
    switch with the counters of `counters` set to 0 just before it and
    read just after.  The step ms (median of 3) and peak memory of each
    policy of `timed` beside the f32 step's.  Returns ({path: launches},
    {numbers})."""
    from taiyaki_tpu_torch import train
    from taiyaki_tpu_torch.convert import leaf_names
    tag = model[0].split("_")[0]
    batch, kwargs = step_batch(seed, TB, model)
    launches, out = {}, {}
    for policy in policies:
        res = {}
        for name, env in (("f32", {}), BF16_STREAMS):
            with switches(dict(policy[1], **env)), scores_kept_f32():
                net = new_net(seed, kwargs, dev, model)
                names = leaf_names(net)
                if name == "bf16":
                    for fn in counters.values():
                        fn.launches = 0
                loss, grads = train.make_grad_step(net)(
                    train.batch_to_device(batch, dev), 1.0)
                torch.cuda.synchronize()
                if name == "bf16":
                    launches["{} bf16 step {}".format(tag, policy[0])] = {
                        k: fn.launches for k, fn in counters.items()}
                res[name] = (float(loss), [g.float() for g in grads])
                del net
        (l32, g32), (l16, g16) = res["f32"], res["bf16"]
        l_err = abs(l16 - l32) / abs(l32)
        errs = [((a - b).abs().max() / b.abs().max().clamp(min=1e-30)).item()
                for a, b in zip(g16, g32)]
        worst = names[int(np.argmax(errs))]
        check(np.isfinite(l16) and l_err <= BF16_LOSS_TOL,
              "bf16 step ({}): loss {} vs f32 {}".format(policy[0], l16,
                                                         l32))
        check(max(errs) <= BF16_GRAD_TOL, "bf16 step ({}): gradient err {} "
              "({})".format(policy[0], max(errs), worst))
        out[policy[0]] = dict(loss=l16, f32_loss=l32, loss_err=l_err,
                              grad_err=max(errs), worst=worst)
        say("{} step ({} chunks x {} samples, size {}) under {}=1, policy "
            "{}: loss {} against the f32 step's {} (relative {:.3g}, tol "
            "{}); largest gradient err {:.3g} of its largest, in {} (tol "
            "{})".format(tag, TB, CHUNK, H, "TAIYAKI_TPU_BF16_STREAMS",
                         policy[0], l16, l32, l_err, BF16_LOSS_TOL,
                         max(errs), worst, BF16_GRAD_TOL))
        del res, g32, g16
        torch.cuda.empty_cache()
    for policy in timed:
        # the first policy's keys carry no policy name
        key = "" if policy is policies[0] else " " + policy[0]
        for name, env in (("f32", {}), BF16_STREAMS):
            with switches(dict(policy[1], **env)), scores_kept_f32():
                ms, peak = _median_step(torch, dev, seed, model, batch,
                                        kwargs)
            torch.cuda.empty_cache()
            out[name + " step" + key] = dict(ms=ms, peak_gb=peak / 1e9)
        f32, bf = out["f32 step" + key], out["bf16 step" + key]
        say("{} training step ({} policy, AdamW; median of 3): f32 {:.3f} "
            "ms, peak {:.3f} GB; bf16 streams {:.3f} ms, peak {:.3f} GB "
            "({:.3f} GB lower)".format(
                tag, policy[0], f32["ms"], f32["peak_gb"], bf["ms"],
                bf["peak_gb"], f32["peak_gb"] - bf["peak_gb"]))
    return launches, out


def bf16_cli(torch, work, seed, pick, reads, idle):
    """Phase 16d: `cli.train_flipflop` on mLstm_flipflop at phase 3's
    shape under the switch (4 iterations; rows 1 and 4 launched as their
    bf16 instances, the GEMMs with bf16 operands, and since phase 18's
    slice rows 2, 3, 5 and 6), then `cli.basecall` of phase 3's reads from
    its checkpoint with the switch still exported: the CLI's opt-out keeps
    it f32 (no bf16 launch, none of the counters `idle`) and every read is
    processed.  Returns ({path: launches}, the training stats)."""
    from taiyaki_tpu_torch.ops import lstm
    launches = {}
    launches["mLstm training bf16"], stats, outdir = train_path(
        torch, work, seed, pick, MLSTM, policy=BF16_STREAMS, niter=4)
    launches["mLstm basecall bf16"] = basecall_opt_out(
        torch, work, "mLstm", reads, outdir, lstm.lstm_fwd, idle)
    return launches, stats


def basecall_opt_out(torch, work, tag, reads, outdir, fwd, idle=None):
    """`cli.basecall` of the 9 reads `reads` from the checkpoint that a
    training path under the switch left in `outdir`, with the switch still
    exported: the CLI's opt-out keeps its layers and scores f32 (the
    kernel `fwd` launched, its bf16 instance never, nor any of the
    counters `idle` {name: counter}; logZ's lattice is bf16 since phase
    20's slice, its mixed instance) and every read is processed.  Returns
    the launches."""
    from taiyaki_tpu_torch.cli import basecall
    name = fwd.__name__
    counted = {name: fwd, name + "[bf16]": fwd.bf16}
    if hasattr(fwd, "by_instance"):
        counted[name + "[cluster]"] = fwd.by_instance["cluster"]
    counted.update(idle or {})
    for fn in counted.values():
        fn.launches = 0
    with switches(BF16_STREAMS[1]):
        calls = basecall.main([
            "--output", os.path.join(work, tag + "_bf16.fa"), "--quiet",
            reads, os.path.join(outdir, "model_final.checkpoint")])
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counted.items()}
    check(launches[name] > 0 and launches[name + "[bf16]"] == 0
          and not any(launches[k] for k in idle or {}),
          "{} basecall under the switch: launches {}".format(tag, launches))
    check(calls["nread"] == 9 and "TAIYAKI_TPU_F32_GATES" not in os.environ,
          "{} basecall under the switch: {} reads".format(tag,
                                                         calls["nread"]))
    say("basecall of the bf16-trained {} checkpoint with the switch "
        "exported: {} reads, {} bases, f32 (launches {})".format(
            tag, calls["nread"], calls["nbase"], launches))
    return launches


# -- phase 17 ----------------------------------------------------------------

# the GRU's bf16 rows against their twins: at the mGru training shape
# (T=GT, B=TB, H=D=H) in each case of BF16_CASES, and at train_abinitio's
# (T=GT, B=AB_BATCH, H=D=96) as a later and as the first layer
GRU96 = 96


def _bf16_gru_bounds(t, b, h):
    """The bounds of the GRU's bf16 rows at T=t, B=b, H=D=h, timed as a
    later layer's (x, h, dh and the residuals bf16): bf16 streams at 2
    bytes, a product with a bf16 operand at MIXED_S_PER_FLOP, d_x's (on
    f32 operands) at the tc rate, the chain's dh . sW at the f32 rate."""
    nbh = 2 * t * b * h              # one bf16 [T, B, H] stream
    nw = 4 * 3 * h * (2 * h + 1)     # the weights, f32, D = H
    one = 2 * t * b * 3 * h * h      # one 3H x H product over T B rows
    return {
        # x in, h out; gx of a bf16 x, the recurrence
        "gru_fwd[bf16]": bound_ms(2 * nbh + nw, one, 0, one),
        # gh and gx (3H each) written beside h
        "gru_fwd[bf16] residuals": bound_ms(8 * nbh + nw, one, 0, one),
        # dh, h, x in, d_x out; gx and gh rebuilt and d_iW, d_sW on bf16
        # operands, d_x on f32 ones, the chain
        "gru_bwd_recompute[bf16]": bound_ms(4 * nbh + 2 * nw, one, one,
                                            4 * one),
        # dh, gx, gh, h_prev, x in, d_x out
        "gru_bwd_fusedw[bf16]": bound_ms(10 * nbh + 2 * nw, one, one,
                                         2 * one)}


def check_bf16_gru_kernels(torch, dev, rng, f32_rows):
    """Phase 17a: the GRU's bf16 instances of rows 7 (both emit modes), 8
    and 13 at the mGru training shape (T=GT, B=TB, H=D=256) in each case
    of BF16_CASES and at train_abinitio's (B=AB_BATCH, H=D=96) in the
    first two, both directions, on their plans' cluster instances,
    against their twins on phase 16a's terms; each counted by instance
    (the recompute with every stream f32 runs its f32 instance).  Each row
    timed (later layer, forward direction) at both shapes beside its f32
    row's ms at the training shape (`f32_rows`, phase 2's) and its twin's.
    Returns the three rows of the kernels line, without their
    launches."""
    from taiyaki_tpu_torch.ops import gru, lstm
    bf = torch.bfloat16
    fns = {"gru_fwd[bf16]": (gru.gru_fwd, gru.gru_fwd_plain),
           "gru_bwd_recompute[bf16]": (gru.gru_bwd_recompute,
                                       gru.gru_bwd_recompute_plain),
           "gru_bwd_fusedw[bf16]": (gru.gru_bwd_fusedw,
                                    gru.gru_bwd_fusedw_plain)}
    err = dict.fromkeys(fns, 0.0)
    share = dict.fromkeys(fns, 0.0)
    case_err = {}
    ms, plain_ms, h96, res_ms = {}, {}, {}, {}
    for t, b, h, cases in ((GT, TB, H, BF16_CASES),
                           (GT, AB_BATCH, GRU96, BF16_CASES[:2])):
        x32, iW, bias, sW = _gru_inputs(torch, dev, rng, t, b, h, h)
        dh32 = _tensor(torch, dev, rng.normal(size=(t, b, h)))
        fplan, bplan = (plan_of("gru", h, b, bwd)[0] for bwd in (0, 1))
        check(fplan.instance == bplan.instance == "cluster",
              "GRU bf16 rows at H={}: plans {} {}".format(h, fplan, bplan))
        before = {k: dict((i, c.launches) for i, c in
                          fns[k][0].bf16_by_instance.items()) for k in fns}
        for case, xdt, hdt, dhdt in cases:
            xdt, hdt, dhdt = (getattr(torch, n) for n in (xdt, hdt, dhdt))
            x, dh = x32.to(xdt), dh32.to(dhdt)
            where = "{} (x {}, h {}, dh {}) T={} B={} H={}".format(
                case, xdt, hdt, dhdt, t, b, h)
            worst = case_err.setdefault("{} H={}".format(case, h),
                                        [0.0, 0.0])
            for reverse in (False, True):
                want = gru.gru_fwd_plain(x, iW, bias, sW, reverse, True, hdt,
                                         bf)
                for res in (False, True):
                    got = gru.gru_fwd(x, iW, bias, sW, reverse=reverse,
                                      emit_residuals=res, h_dtype=hdt,
                                      res_dtype=bf)
                    torch.cuda.synchronize()
                    for g, w in zip(got if res else (got,), want):
                        d, s, ok = _bf16_out_err(torch, g, w, 1e-4)
                        check(ok, "gru_fwd[bf16] emit_residuals={} {}: "
                              "|diff| {}, share {}".format(res, where, d, s))
                        err["gru_fwd[bf16]"] = max(err["gru_fwd[bf16]"], d)
                        share["gru_fwd[bf16]"] = max(
                            share["gru_fwd[bf16]"], s)
                        worst[0] = max(worst[0], d)
                    del got
                hh, gh, gx = want
                args = {"gru_bwd_recompute[bf16]": (dh, hh, x, sW, iW, bias),
                        "gru_bwd_fusedw[bf16]": (
                            dh, gx, gh, lstm.prev_state(hh, reverse), x, sW,
                            iW)}
                for k, a in args.items():
                    fn, plain = fns[k]
                    got, wb = fn(*a, reverse=reverse), plain(*a,
                                                             reverse=reverse)
                    torch.cuda.synchronize()
                    scale = wb[0].float().abs().max().item()
                    d, s, ok = _bf16_out_err(torch, got[0], wb[0],
                                             1e-4 * scale)
                    e = max(rel_err(g.sum(0), w.sum(0))
                            for g, w in zip(got[1:], wb[1:]))
                    check(ok and e <= 1e-4, "{} {}: d_x |diff| {} (share "
                          "{}), the weight gradients' largest relative err "
                          "{}".format(k, where, d, s, e))
                    err[k], share[k] = max(err[k], e), max(share[k], s)
                    worst[1] = max(worst[1], e, d / scale)
                    del got, wb
                if not reverse and case == cases[0][0]:
                    timed = {"gru_fwd[bf16]": (
                        lambda: gru.gru_fwd(x, iW, bias, sW, h_dtype=hdt,
                                            res_dtype=bf),
                        lambda: gru.gru_fwd_plain(x, iW, bias, sW, False,
                                                  False, hdt, bf))}
                    for k, a in args.items():
                        timed[k] = ((lambda f=fns[k][0], a=a: f(*a)),
                                    (lambda f=fns[k][1], a=a: f(*a)))
                    for k, (f, p) in timed.items():
                        if h == H:
                            ms[k] = cuda_ms(torch, f, reps=3)
                            plain_ms[k] = cuda_ms(torch, p, reps=1,
                                                  warmup=0)
                        else:
                            h96[k] = cuda_ms(torch, f, reps=3)
                    res_ms[h] = cuda_ms(torch, lambda: gru.gru_fwd(
                        x, iW, bias, sW, emit_residuals=True, h_dtype=hdt,
                        res_dtype=bf), reps=3)
                del want, hh, gh, gx, args
            del x, dh
        # a case's launches, both directions: the forward's two emit modes,
        # each backward once (the recompute's f32 case on its f32
        # instance), then the timed ones
        n16 = sum("bfloat16" in c for c in cases)
        need = {"gru_fwd[bf16]": 4 * len(cases),
                "gru_bwd_recompute[bf16]": 2 * n16,
                "gru_bwd_fusedw[bf16]": 2 * len(cases)}
        for k, (fn, _) in fns.items():
            after = {i: c.launches for i, c in fn.bf16_by_instance.items()}
            check(after["cluster"] - before[k]["cluster"] > need[k]
                  and after["l2"] == before[k]["l2"],
                  "{} H={}: bf16 launches by instance {} -> {}".format(
                      k, h, before[k], after))
        del x32, iW, bias, sW, dh32
        torch.cuda.empty_cache()
    say("GRU bf16 instances T={} by case (x, h, dh types) and width, both "
        "directions: the forwards' largest |diff| and the backwards' "
        "largest relative err (d_x of its largest, weight gradients): "
        "{}".format(GT, json.dumps(case_err)))
    bounds = _bf16_gru_bounds(GT, TB, H)
    bounds96 = _bf16_gru_bounds(GT, AB_BATCH, GRU96)
    rows = []
    for name, f32_name, line in BF16_ROWS:
        if name not in fns:
            continue
        f32 = f32_rows[f32_name]
        row = dict(
            name=name, route="cuda", source="taiyaki_tpu_torch/csrc/gru.cu",
            replaces="taiyaki_tpu/ops/" + line,
            max_abs_err=err[name], bf16_share=share[name], ms=ms[name],
            plain_ms=plain_ms[name], bound_ms=bounds[name][0],
            bound_by=bounds[name][1], library_ms=f32["library_ms"],
            f32_ms=f32["ms"], h96_ms=h96[name],
            h96_bound_ms=bounds96[name][0])
        if name == "gru_fwd[bf16]":
            res = bounds[name + " residuals"]
            row.update(residuals_ms=res_ms[H],
                       f32_residuals_ms=f32["residuals_ms"],
                       residuals_bound_ms=res[0],
                       h96_residuals_ms=res_ms[GRU96])
        rows.append(row)
        say("{} T={} B={} D=H={} (the three cases; timed with x, h, dh "
            "bf16; the cluster instances): max err {:.3g} ({}), bf16 outputs "
            "one step apart {:.3g} of them (at most {}), {:.3f} ms against "
            "the f32 row's {:.3f} ms, twin {:.3f} ms, bound {:.3f} ms ({}); "
            "H=96 (B={}) {:.3f} ms, bound {:.3f} ms{}".format(
                name, GT, TB, H, err[name], "|diff|" if "fwd" in name
                else "relative", share[name], BF16_SHARE, ms[name],
                f32["ms"], plain_ms[name], bounds[name][0], bounds[name][1],
                AB_BATCH, h96[name], bounds96[name][0],
                "" if "fwd" not in name else
                "; with its residuals {:.3f} ms against the f32 row's "
                "{:.3f} (bound {:.3f}), H=96 {:.3f} ms".format(
                    res_ms[H], f32["residuals_ms"], res[0], res_ms[GRU96])))
    return rows


def bf16_gru_cli(torch, work, seed, counters, reads):
    """Phase 17c: `cli.train_flipflop` on mGru_flipflop at phase 4's shape
    under the switch (4 iterations; rows 7 and 8 launched as their bf16
    instances, the GEMMs with bf16 operands), `cli.train_abinitio` at its
    defaults on phase 13d's chunks under the switch with each GRU policy
    (AB_ITER iterations; rows 7 and 8 or 13 as bf16 instances), then
    `cli.basecall` of phase 4's reads `reads` from the trained checkpoint
    with the switch still exported: the CLI's opt-out keeps it f32 (no
    bf16 launch).  `counters` {name: counter}.  Returns ({path:
    launches}, {numbers})."""
    from taiyaki_tpu_torch.cli import train_abinitio
    from taiyaki_tpu_torch.ops import gru
    launches, out = {}, {}
    path_counters = {
        k: counters[k] for k in counters
        if k.split("[")[0] != "gru_bwd_fusedw"}
    launches["mGru training bf16"], stats, outdir = train_path(
        torch, work, seed, path_counters, MGRU, policy=BF16_STREAMS, niter=4)
    out["training CLI steps/s"] = stats["iterations"] / stats["seconds"]
    d = os.path.join(work, "abinitio")
    for policy in GRU_POLICIES:
        bwd = "gru_bwd_" + ("recompute" if policy[0] == "recompute"
                            else "fusedw")
        mine = {k: fn for k, fn in counters.items()
                if k.split("[")[0] in ("gru_fwd", bwd) or k in SCORE_BF16}
        for fn in mine.values():
            fn.launches = 0
        with switches(dict(policy[1], **BF16_STREAMS[1])):
            st = train_abinitio.main([
                "--batch_size", str(AB_BATCH), "--niteration", str(AB_ITER),
                "--save_every", str(AB_ITER // 2), "--seed", str(seed),
                "--quiet", "--outdir",
                os.path.join(d, "out_bf16_" + policy[0]), MGRU[1],
                os.path.join(d, "chunks.hdf5"), os.path.join(d, "refs.fa")])
        torch.cuda.synchronize()
        path = "train_abinitio bf16 " + policy[0]
        launches[path] = {k: fn.launches for k, fn in mine.items()}
        check(all(n > 0 for n in launches[path].values()),
              "{}: launches {}".format(path, launches[path]))
        check(len(st["losses"]) == AB_ITER
              and all(np.isfinite(st["losses"])),
              "{}: losses {}".format(path, st["losses"]))
        out[path] = dict(losses=st["losses"], step_s=st["step_seconds"])
        say("{} (mGru_flipflop 96/2/19, batch {}, {} iterations): losses "
            "{}; step seconds {}; launches {}".format(
                path, AB_BATCH, AB_ITER,
                ", ".join("{:.5f}".format(v) for v in st["losses"]),
                ", ".join("{:.3f}".format(v) for v in st["step_seconds"]),
                launches[path]))
    launches["mGru basecall bf16"] = basecall_opt_out(
        torch, work, "mGru", reads, outdir, gru.gru_fwd,
        {k: fn for k, fn in counters.items() if k in SCORE_BF16})
    return launches, out


# -- phase 18 ----------------------------------------------------------------

# the shapes of the score rows' bf16 instances: (tag, T, B, L, S) the
# mLstm training shape, its cat_mod width (the CRF alone: logZ takes the
# canonical columns) and the widest fused lattice (the mGru chunk range's)
SCORE_SHAPES = (("training", TT, TB, TL, S), ("cat_mod", TT, TB, TL, SC),
                ("widest", LT, LB, LL, S))
# the training CLI under the switch in phase 18c (a name of its own, so
# that its output directory is not phase 16d's)
BF16_SCORES = ("bf16 scores", BF16_STREAMS[1])
# the cat_mod step's gradients under the switch against its f32 step: a
# mod move's score rounds to bf16 at its weight (x8 at the --mod_factor
# ramp's start), and the JAX package's own mixed route is as far from its
# f32 step there, growing with the chunk (size 16, x8, 500 samples: 1.8e-2
# of the head's largest gradient, the port 1.3e-5 from the JAX mixed
# step; tests/test_torch_bf16_scores.py)
BF16_CATMOD_GRAD_TOL = 0.1


def _states_bf16(torch, t):
    """A bf16 lattice with -inf states (logZ's impossible ones) as
    -1e30, so that equal infinities compare as equal."""
    return t.float().clamp(min=-1e30).to(torch.bfloat16)


def _score_bounds(tt, tb, tl, s, npos):
    """The bounds of the score rows' bf16 instances at one shape, their
    streams at 2 bytes (bf16 scores, lattices and posteriors; lp, d lp,
    logZ and the state f32), their arithmetic as the f32 rows'."""
    nff = 2 * NBASE
    idx_bytes = 4 * 6 * tb * tl
    return {
        "logz_fwd[bf16]": bound_ms(
            2 * (tt * tb * S + tt * tb * nff) + 4 * (tb * nff + tb),
            tt * tb * (4 * S + 4 * nff)),
        "logz_posteriors[bf16]": bound_ms(
            2 * (2 * tt * tb * S + tt * tb * nff),
            tt * tb * (8 * S + 4 * nff)),
        "crf_fwd[bf16]": bound_ms(
            4 * (tt * tb * s + tb * tl + tb) + 2 * tt * tb * tl + idx_bytes,
            10 * tt * npos),
        "crf_bwd[bf16]": bound_ms(
            4 * 2 * tt * tb * s + 2 * tt * npos + idx_bytes,
            20 * tt * npos)}


def check_bf16_score_kernels(torch, dev, rng):
    """Phase 18a: the bf16 instances of rows 2, 3, 5 and 6 at SCORE_SHAPES
    against their twins, which round where the kernels round: logZ and the
    CRF score at the f32 rows' tolerances (1e-3 + 1e-5 |value|); the
    lattices and logZ's posteriors as `bf16_err` (atol 1e-4, 1e-5); each
    backward on the twin's lattice, so that both read the same one; d lp
    (sums of bf16 posteriors) within one bf16 step of a posterior (2^-8
    times the largest mod weight), and past the f32 row's atol (1e-5, 3e-4
    at the widest) at most BF16_SHARE of its entries; the backward bitwise
    from run to run.  Each row timed at each shape beside its f32
    instance on the same inputs (the scores widened), the twin at the
    training shape.  Returns the four rows of the kernels line, without
    their launches."""
    from taiyaki_tpu_torch.ops import crf, logz
    bf = torch.bfloat16
    names = ("logz_fwd[bf16]", "logz_posteriors[bf16]", "crf_fwd[bf16]",
             "crf_bwd[bf16]")
    err, share = dict.fromkeys(names, 0.0), dict.fromkeys(names, 0.0)
    ms, f32_ms, plain_ms, bounds = {}, {}, {}, {}
    counts = {n: getattr(logz if "logz" in n else crf,
                         n.split("[")[0]).bf16 for n in names}
    before = {n: c.launches for n, c in counts.items()}

    def record(name, tag, d, s):
        err[name], share[name] = max(err[name], d), max(share[name], s)
        say("{} at the {} shape: |diff| {:.3g}, share of bf16 values one "
            "step apart {:.3g} (at most {})".format(name, tag, d, s,
                                                    BF16_SHARE))

    for tag, tt, tb, tl, s in SCORE_SHAPES:
        if s == S:
            sc32 = _tensor(torch, dev, 5.0 * np.tanh(
                rng.normal(size=(tt, tb, S))))
            sc = sc32.to(bf)
            f0, z0, l0 = logz.logz_fwd_plain(sc, NBASE)
            p0 = logz.logz_posteriors_plain(sc, l0, NBASE)
            f1, z1, l1 = logz.logz_fwd(sc)
            p1 = logz.logz_posteriors(sc, l0)
            torch.cuda.synchronize()
            z_err = max_abs_diff(z1, z0)
            z_tol = 1e-3 + 1e-5 * z0.abs().max().item()
            check(z_err <= z_tol and max_abs_diff(f1, f0) <= 1e-4,
                  "logz_fwd[bf16] {}: logZ err {} (tol {})".format(
                      tag, z_err, z_tol))
            d, sh, ok = bf16_err(torch, _states_bf16(torch, l1),
                                 _states_bf16(torch, l0), 1e-4)
            check(ok, "logz_fwd[bf16] {}: lattice |diff| {} share {}".format(
                tag, d, sh))
            record("logz_fwd[bf16]", tag, max(z_err, d), sh)
            d, sh, ok = bf16_err(torch, p1, p0, 1e-5)
            check(ok, "logz_posteriors[bf16] {}: |diff| {} share {}".format(
                tag, d, sh))
            record("logz_posteriors[bf16]", tag, d, sh)
            _, _, l32 = logz.logz_fwd(sc32)
            for n, f, f32 in (
                    ("logz_fwd[bf16]", lambda: logz.logz_fwd(sc),
                     lambda: logz.logz_fwd(sc32)),
                    ("logz_posteriors[bf16]",
                     lambda: logz.logz_posteriors(sc, l1),
                     lambda: logz.logz_posteriors(sc32, l32))):
                ms[n, tag] = cuda_ms(torch, f, reps=5)
                f32_ms[n, tag] = cuda_ms(torch, f32, reps=5)
            if tag == "training":
                plain_ms["logz_fwd[bf16]"] = cuda_ms(
                    torch, lambda: logz.logz_fwd_plain(sc, NBASE), reps=1,
                    warmup=0)
                plain_ms["logz_posteriors[bf16]"] = cuda_ms(
                    torch, lambda: logz.logz_posteriors_plain(sc, l0, NBASE),
                    reps=1, warmup=0)
            del sc32, sc, f0, z0, l0, p0, f1, z1, l1, p1, l32
        lp, seqlens, args = _crf_case(torch, dev, rng, tt, tb, tl, s)
        sidx, midx, mmidx, mfact, valid, last = args
        idx = (sidx, midx, mmidx, mfact)
        f0, s0, lat0 = crf.crf_fwd_plain(lp, *idx, valid, score_dtype=bf)
        g0 = crf.crf_bwd_plain(lp, *idx, lat0, valid, last, score_dtype=bf)
        f1, s1, lat1 = crf.crf_fwd(lp, *idx, valid, score_dtype=bf)
        g1 = crf.crf_bwd(lp, *idx, lat0, valid, last, score_dtype=bf)
        g2 = crf.crf_bwd(lp, *idx, lat0, valid, last, score_dtype=bf)
        torch.cuda.synchronize()
        s_err = max_abs_diff(s1, s0)
        s_tol = 1e-3 + 1e-5 * s0.abs().max().item()
        check(s_err <= s_tol, "crf_fwd[bf16] {}: score err {} > {}".format(
            tag, s_err, s_tol))
        d, sh, ok = bf16_err(torch, lat1, lat0, 1e-4)
        check(ok, "crf_fwd[bf16] {}: lattice |diff| {} share {}".format(
            tag, d, sh))
        record("crf_fwd[bf16]", tag, max(s_err, d), sh)
        weight = max(1.0, mfact.max().item())
        g_tol = (3e-4 if tag == "widest" else 1e-5) * weight
        diff = (g1 - g0).abs()
        g_err = diff.max().item()
        past = (diff > g_tol).float().mean().item()
        check(g_err <= 2.0 ** -8 * weight and past <= BF16_SHARE,
              "crf_bwd[bf16] {}: d lp |diff| {} (at most 2^-8 x {}), {} of "
              "it past {}".format(tag, g_err, weight, past, g_tol))
        check(bool(torch.equal(g1, g2)), "crf_bwd[bf16] {}: two runs "
              "differ".format(tag))
        record("crf_bwd[bf16]", tag, g_err, past)
        del f0, s0, g0, g1, g2, diff
        _, _, lat32 = crf.crf_fwd(lp, *idx, valid)
        for n, f, f32 in (
                ("crf_fwd[bf16]",
                 lambda: crf.crf_fwd(lp, *idx, valid, score_dtype=bf),
                 lambda: crf.crf_fwd(lp, *idx, valid)),
                ("crf_bwd[bf16]",
                 lambda: crf.crf_bwd(lp, *idx, lat1, valid, last,
                                     score_dtype=bf),
                 lambda: crf.crf_bwd(lp, *idx, lat32, valid, last))):
            ms[n, tag] = cuda_ms(torch, f, reps=5)
            f32_ms[n, tag] = cuda_ms(torch, f32, reps=5)
        say("crf at the {} shape (T={}, B={}, L={}, S={}; backward batches "
            "of {} steps, {} in f32): bf16 forward {:.3f} ms, backward "
            "{:.3f} ms; f32 {:.3f}, {:.3f} ms".format(
                tag, tt, tb, tl, s, crf.bwd_batch(tt, tb, s, tl, bf),
                crf.bwd_batch(tt, tb, s, tl), ms["crf_fwd[bf16]", tag],
                ms["crf_bwd[bf16]", tag], f32_ms["crf_fwd[bf16]", tag],
                f32_ms["crf_bwd[bf16]", tag]))
        if tag == "training":
            plain_ms["crf_fwd[bf16]"] = cuda_ms(
                torch, lambda: crf.crf_fwd_plain(lp, *idx, valid,
                                                 score_dtype=bf),
                reps=1, warmup=0)
            plain_ms["crf_bwd[bf16]"] = cuda_ms(
                torch, lambda: crf.crf_bwd_plain(lp, *idx, lat1, valid, last,
                                                 score_dtype=bf),
                reps=1, warmup=0)
            bounds = _score_bounds(tt, tb, tl, s, int(seqlens.sum()))
        del lp, args, lat0, f1, s1, lat1, lat32
        torch.cuda.empty_cache()
    for n, c in counts.items():
        check(c.launches > before[n], "{}: no bf16 launch".format(n))
    rows = []
    for name, f32_name, where in BF16_ROWS:
        if name not in names:
            continue
        shapes = [t for t, *_ in SCORE_SHAPES if (name, t) in ms]
        rows.append(dict(
            name=name, route="cuda",
            source="taiyaki_tpu_torch/csrc/{}.cu".format(
                "logz" if "logz" in name else "crf"),
            replaces="taiyaki_tpu/ops/" + where, max_abs_err=err[name],
            bf16_share=share[name], ms=ms[name, "training"],
            plain_ms=plain_ms[name], bound_ms=bounds[name][0],
            bound_by=bounds[name][1], library_ms=None,
            f32_ms=f32_ms[name, "training"],
            shapes_ms={t: [ms[name, t], f32_ms[name, t]] for t in shapes}))
        say("{} (T={} B={} L={}; bf16 scores, lattice{}): max err {:.3g}, "
            "share {:.3g}; {:.3f} ms against the f32 instance's {:.3f} ms on "
            "the same inputs, twin {:.3f} ms, bound {:.4f} ms ({}); [bf16, "
            "f32] ms by shape {}".format(
                name, TT, TB, TL,
                ", posteriors" if "posteriors" in name or "bwd" in name
                else "", err[name], share[name], ms[name, "training"],
                f32_ms[name, "training"], plain_ms[name], bounds[name][0],
                bounds[name][1], json.dumps(rows[-1]["shapes_ms"])))
    return rows


def bf16_score_steps(torch, dev, seed, counters):
    """Phase 18b: the full-width mLstm step and the cat_mod step (TB
    chunks x CHUNK samples, the mod columns x8) under the switch against
    the f32 step on the same batch and weights: the loss within
    BF16_LOSS_TOL relative and each gradient within BF16_GRAD_TOL of its
    largest (phase 16c's terms; BF16_CATMOD_GRAD_TOL for cat_mod), the
    step under the switch counted
    (`counters`, set to 0 just before it and read just after: rows 2, 3,
    5 and 6's bf16 instances must launch).  Each step's ms (median of 3)
    and peak memory: f32, under the switch, and under the switch with the
    CRF and logZ kept f32 (`scores_kept_f32`: phase 16c's step as the
    previous slice ran it).  Returns ({path: launches}, {numbers})."""
    from taiyaki_tpu_torch import train
    from taiyaki_tpu_torch.convert import leaf_names
    launches, out = {}, {}
    for model in (MLSTM, MLSTM_CATMOD):
        tag = model[0].split("_flipflop")[0]
        batch, kwargs = step_batch(seed, TB, model)
        res = {}
        for name, env in (("f32", {}), BF16_STREAMS):
            with switches(env):
                net = new_net(seed, kwargs, dev, model)
                names = leaf_names(net)
                args, factor = loss_args(net)
                if name == "bf16":
                    for fn in counters.values():
                        fn.launches = 0
                loss, grads = train.make_grad_step(net, *args)(
                    train.batch_to_device(batch, dev), 1.0, *factor)
                torch.cuda.synchronize()
                if name == "bf16":
                    path = "{} bf16 scores step".format(tag)
                    launches[path] = {k: fn.launches
                                      for k, fn in counters.items()}
                    check(all(n > 0 for n in launches[path].values()),
                          "{}: launches {}".format(path, launches[path]))
                res[name] = (float(loss), [g.float() for g in grads])
                del net
        (l32, g32), (l16, g16) = res["f32"], res["bf16"]
        l_err = abs(l16 - l32) / abs(l32)
        errs = [((a - b).abs().max() / b.abs().max().clamp(min=1e-30)).item()
                for a, b in zip(g16, g32)]
        worst = names[int(np.argmax(errs))]
        check(np.isfinite(l16) and l_err <= BF16_LOSS_TOL,
              "{} bf16 scores step: loss {} vs f32 {}".format(tag, l16, l32))
        g_tol = BF16_CATMOD_GRAD_TOL if is_cat_mod(model) else BF16_GRAD_TOL
        check(max(errs) <= g_tol, "{} bf16 scores step: gradient err {} "
              "({}) > {}".format(tag, max(errs), worst, g_tol))
        num = dict(loss=l16, f32_loss=l32, loss_err=l_err,
                   grad_err=max(errs), worst=worst)
        del res, g32, g16
        torch.cuda.empty_cache()
        for name, env, keep in (("f32", {}, False),
                                ("bf16", BF16_STREAMS[1], False),
                                ("bf16, scores f32", BF16_STREAMS[1], True)):
            with switches(env), (scores_kept_f32() if keep
                                 else contextlib.nullcontext()):
                step_ms, peak = _median_step(torch, dev, seed, model, batch,
                                             kwargs)
            torch.cuda.empty_cache()
            num[name] = dict(ms=step_ms, peak_gb=peak / 1e9)
        out[tag] = num
        say("{} step ({} chunks x {} samples, size {}, L={}) under "
            "TAIYAKI_TPU_BF16_STREAMS=1 with the bf16 CRF and logZ: loss {} "
            "against the f32 step's {} (relative {:.3g}, tol {}); largest "
            "gradient err {:.3g} of its largest, in {} (tol {}); median of 3: "
            "f32 {:.3f} ms, {:.3f} GB; bf16 {:.3f} ms, {:.3f} GB; bf16 with "
            "the CRF and logZ f32 (the previous slice's) {:.3f} ms, {:.3f} "
            "GB".format(tag, TB, CHUNK, H, batch.seqs.shape[1], l16, l32,
                        l_err, BF16_LOSS_TOL, max(errs), worst, g_tol,
                        num["f32"]["ms"],
                        num["f32"]["peak_gb"], num["bf16"]["ms"],
                        num["bf16"]["peak_gb"],
                        num["bf16, scores f32"]["ms"],
                        num["bf16, scores f32"]["peak_gb"]))
    return launches, out


def bf16_score_cli(torch, work, seed, pick, scores, reads):
    """Phase 18c: `cli.train_flipflop` on mLstm_flipflop and on
    mLstm_cat_mod_flipflop at phase 3's shape under the switch (4
    iterations each; rows 2, 3, 5 and 6 launched as their bf16 instances,
    `scores` {name: counter}), then `cli.basecall` of phase 3's reads
    `reads` from the mLstm checkpoint with the switch exported: the CLI's
    opt-out keeps logZ f32 (launched, its bf16 instance and the CRF's
    never).  Returns {path: launches}."""
    from taiyaki_tpu_torch.ops import logz
    launches = {}
    train_loss = ("lstm_fwd", "lstm_bwd_acts", "crf_fwd", "crf_bwd",
                  "logz_fwd", "logz_posteriors")
    for model in (MLSTM, MLSTM_CATMOD):
        launches["{} training bf16 scores".format(
            model[0].split("_flipflop")[0])], _, outdir = train_path(
            torch, work, seed, dict(pick(train_loss), **scores), model,
            policy=BF16_SCORES, niter=4)
        if model is MLSTM:
            mlstm_out = outdir
        torch.cuda.empty_cache()
    launches["mLstm basecall bf16 scores"] = basecall_opt_out(
        torch, work, "mLstm_scores", reads, mlstm_out, logz.logz_fwd,
        idle=scores)
    return launches


def _bf16_scan_bounds(G, t, b, h):
    """The bounds of the scans' bf16 rows with G gate rows a unit at T=t,
    B=b, H=h (the JAX scans' streams: gx, the residuals and the gradient
    streams bf16 at 2 bytes, h and h_prev f32), the recurrent product at
    the f32 rate: {name: (ms, by)}."""
    rows = t * b
    g16, s16, s32 = 2 * rows * G * h, 2 * rows * h, 4 * rows * h
    w, flops = 4 * G * h * h, 2 * rows * G * h * h
    cell = "lstm" if G == 4 else "gru"
    if G == 4:
        # gx in; h out, c and pre out / dh, pre, c, c_prev in; dpre out
        fwd, bwd = g16 + s32 + s16 + g16 + w, 3 * s16 + 2 * g16 + w
    else:
        # gx in; h, gh out / dh, gx, gh, h_prev in; dgx, dgh out
        fwd, bwd = g16 + s32 + g16 + w, s16 + 2 * g16 + s32 + w + 2 * g16
    return {cell + "_scan_fwd[bf16]": bound_ms(fwd, flops),
            cell + "_scan_bwd[bf16]": bound_ms(bwd, flops)}


# phase 19a's stream cases: (name, gx, dh and the stored gradients), the
# JAX scans' under the switch alone and under TAIYAKI_TPU_F32_GATES=1
SCAN_CASES = (("default", "bfloat16"), ("F32_GATES", "float32"))
SCAN512 = (200, 64)                 # T, B of the H=512 (L2) shapes


def check_bf16_scan_kernels(torch, dev, rng, f32_rows):
    """Phase 19a: the bf16 instances of rows 14-17 (the JAX scans' mixed
    precision: h f32; c and pre, or gh, bf16; dpre, or dgx and dgh, bf16
    from a bf16 dh) at phase 7's shapes (mLstm T=TT, mGru T=GT, B=TB,
    H=256) in each case of SCAN_CASES (gx bf16, or f32 as under
    TAIYAKI_TPU_F32_GATES), and at H=512 (T, B = SCAN512) in the first,
    both directions, against their twins: f32 outputs (h) within 1e-4
    relative, bf16 ones as `bf16_err` (atol 1e-4 of the largest).  Each
    counted by instance: the cluster instances at H=256; at H=512 the
    forwards and the LSTM's chain the L2 ones, the GRU's chain a cluster.
    Timed (default case, forward direction) at the training shapes beside
    the f32 rows (`f32_rows`, phase 2's). Returns the four rows of the
    kernels line, without their launches."""
    from taiyaki_tpu_torch.ops import gru, lstm
    bf = torch.bfloat16
    rows, case_err = [], {}
    for cell, t, G, mod in (("lstm", TT, 4, lstm), ("gru", GT, 3, gru)):
        fwd, fwd_plain, bwd, bwd_plain = (
            getattr(mod, "{}_scan_{}{}".format(cell, way, k))
            for way in ("fwd", "bwd") for k in ("", "_plain"))
        names = (cell + "_scan_fwd[bf16]", cell + "_scan_bwd[bf16]")
        err, share, ms, plain_ms, h512 = {}, {}, {}, {}, {}
        for h, tt, b, cases in ((H, t, TB, SCAN_CASES),
                                (512, SCAN512[0], SCAN512[1],
                                 SCAN_CASES[:1])):
            x = _tensor(torch, dev, rng.normal(size=(tt, b, h)))
            iW = _tensor(torch, dev, rng.normal(size=(G * h, h)) / np.sqrt(h))
            bias = _tensor(torch, dev, 0.5 * rng.normal(size=G * h))
            sW = _tensor(torch, dev, rng.normal(size=(G * h, h)) / np.sqrt(h))
            dh = _tensor(torch, dev, rng.normal(size=(tt, b, h))).to(bf)
            gx32 = torch.matmul(x, iW.t()) + bias
            del x, iW, bias
            plans = [plan_of(cell, h, b, k)[0].instance for k in (0, 1)]
            check(plans == (["cluster", "cluster"] if h == H else
                            ["l2", "l2" if cell == "lstm" else "cluster"]),
                  "{} scans at H={}: plans {}".format(cell, h, plans))
            before = [dict((i, c.launches) for i, c in
                           fn.bf16_by_instance.items()) for fn in (fwd, bwd)]
            for case, gdt in cases:
                gx = gx32.to(getattr(torch, gdt))
                worst = case_err.setdefault("{} {} H={}".format(
                    cell, case, h), [0.0, 0.0])
                for reverse in (False, True):
                    want = fwd_plain(gx, sW, reverse, True, bf)
                    got = fwd(gx, sW, reverse=reverse, residuals=True,
                              res_dtype=bf)
                    h_only = fwd(gx, sW, reverse=reverse, res_dtype=bf)
                    torch.cuda.synchronize()
                    e = max(rel_err(g, want[0]) for g in (got[0], h_only))
                    ok, d, sh = e <= 1e-4, e, 0.0
                    for g, w in zip(got[1:], want[1:]):
                        dd, ss, okk = bf16_err(torch, g, w, 1e-4)
                        ok, d, sh = ok and okk, max(d, dd), max(sh, ss)
                    check(ok, "{} {} H={} reverse={}: h relative err {}, "
                          "residuals |diff| {} (share {})".format(
                              names[0], case, h, reverse, e, d, sh))
                    err[names[0]] = max(err.get(names[0], 0.0), d)
                    share[names[0]] = max(share.get(names[0], 0.0), sh)
                    worst[0] = max(worst[0], d)
                    del got, h_only
                    if cell == "lstm":
                        hh, c, pre = want
                        args = (dh, pre, c, lstm.prev_state(c, reverse), sW)
                    else:
                        hh, gh = want
                        args = (dh, gx, gh, lstm.prev_state(hh, reverse), sW)
                    gk = bwd(*args, reverse=reverse)
                    gp = bwd_plain(*args, reverse=reverse)
                    torch.cuda.synchronize()
                    gk, gp = ((gk, gp) if isinstance(gk, tuple)
                              else ((gk,), (gp,)))
                    for g, w in zip(gk, gp):
                        scale = w.float().abs().max().item()
                        dd, ss, okk = bf16_err(torch, g, w, 1e-4 * scale)
                        check(okk, "{} {} H={} reverse={}: |diff| {} of "
                              "{} (share {})".format(names[1], case, h,
                                                     reverse, dd, scale, ss))
                        err[names[1]] = max(err.get(names[1], 0.0),
                                            dd / max(scale, 1.0))
                        share[names[1]] = max(share.get(names[1], 0.0), ss)
                        worst[1] = max(worst[1], dd / max(scale, 1.0))
                    del gk, gp
                    if not reverse and case == "default":
                        timed = {names[0]: (
                            lambda: fwd(gx, sW, residuals=True,
                                        res_dtype=bf),
                            lambda: fwd_plain(gx, sW, False, True, bf)),
                            names[1]: ((lambda a=args: bwd(*a)),
                                       (lambda a=args: bwd_plain(*a)))}
                        for k, (f, p) in timed.items():
                            if h == H:
                                ms[k] = cuda_ms(torch, f, reps=3)
                                plain_ms[k] = cuda_ms(torch, p, reps=1,
                                                      warmup=0)
                            else:
                                h512[k] = cuda_ms(torch, f, reps=3)
                    del want, args
                del gx
            for fn, name, was, inst in ((fwd, names[0], before[0],
                                         plans[0]),
                                        (bwd, names[1], before[1],
                                         plans[1])):
                after = {i: c.launches for i, c in
                         fn.bf16_by_instance.items()}
                other = "l2" if inst == "cluster" else "cluster"
                check(after[inst] - was[inst] >= 2 * len(cases)
                      and after[other] == was[other],
                      "{} H={}: bf16 launches by instance {} -> {}".format(
                          name, h, was, after))
            del gx32, sW, dh
            torch.cuda.empty_cache()
        bounds = _bf16_scan_bounds(G, t, TB, H)
        b512 = _bf16_scan_bounds(G, SCAN512[0], SCAN512[1], 512)
        for name in names:
            f32 = f32_rows[name.replace("[bf16]", "")]
            rows.append(dict(
                name=name, route="cuda",
                source="taiyaki_tpu_torch/csrc/{}.cu".format(cell),
                replaces="taiyaki_tpu/ops/" + dict(
                    (n, line) for n, _, line in BF16_ROWS)[name],
                max_abs_err=err[name], bf16_share=share[name], ms=ms[name],
                plain_ms=plain_ms[name], bound_ms=bounds[name][0],
                bound_by=bounds[name][1], library_ms=f32["library_ms"],
                f32_ms=f32["ms"], h512_ms=h512[name],
                h512_bound_ms=b512[name][0]))
            say("{} T={} B={} H={} (gx bf16 and f32, both directions; timed "
                "with gx, dh and the gradients bf16 on the cluster "
                "instances): max err {:.3g} ({}), bf16 outputs one step "
                "apart {:.3g} of them (at most {}), {:.3f} ms against the "
                "f32 row's {:.3f} ms, twin {:.3f} ms, bound {:.3f} ms ({}); "
                "H=512 (T={}, B={}) {:.3f} ms, bound {:.3f} ms".format(
                    name, t, TB, H, err[name],
                    "|diff| of c, pre, gh; h relative" if "fwd" in name
                    else "relative to the largest", share[name], BF16_SHARE,
                    ms[name], f32["ms"], plain_ms[name], bounds[name][0],
                    bounds[name][1], SCAN512[0], SCAN512[1], h512[name],
                    b512[name][0]))
    say("scan bf16 instances by cell, case and width, both directions: the "
        "forwards' and backwards' largest err: {}".format(
            json.dumps(case_err)))
    return rows


def bf16_scan_path(torch, dev, rng, counters):
    """Phase 19b: the public ops `lstm_scan` and `gru_scan` under
    TAIYAKI_TPU_BF16_STREAMS=1 through torch.autograd.grad, both
    directions, at phase 7's shapes, `counters` (the scans' kernels, their
    bf16 instances and the atb GEMM) set to 0 just before each cell's path
    and read just after: every scan launch the bf16 instance, d_sW of the
    bf16 gradients on the atb GEMM.  Then the f32 scans (switch unset) on
    the same inputs: h, d gates_x and d_sW within BF16_GRAD_TOL of each
    one's largest (the JAX route's own distance, ~5e-3 in a CPU run at
    T=800 and 2000, B=8-16), and the peak memory of each.  Returns
    ({"<cell>_scan bf16": launches}, {cell: numbers})."""
    from taiyaki_tpu_torch.ops import rnn
    launches, out = {}, {}
    for cell, t, G in (("lstm", TT, 4), ("gru", GT, 3)):
        scan = rnn.lstm_scan if cell == "lstm" else rnn.gru_scan
        # phase 7's inputs: gates_x = x . iW^T + b of one seeded layer
        x = _tensor(torch, dev, rng.normal(size=(t, TB, H)))
        iW = _tensor(torch, dev, rng.normal(size=(G * H, H)) / np.sqrt(H))
        gx = (torch.matmul(x, iW.t())
              + _tensor(torch, dev, 0.5 * rng.normal(size=G * H)))
        sW = _tensor(torch, dev, rng.normal(size=(G * H, H)) / np.sqrt(H))
        dh = _tensor(torch, dev, rng.normal(size=(t, TB, H)))
        del x, iW
        mine = {k: c for k, c in counters.items() if k.startswith(cell)
                or k.startswith("atb_gemm")}
        res, peak, n = {}, {}, {}
        for tag, env in (("bf16", BF16_STREAMS[1]), ("f32", {})):
            with switches(env):
                for c in mine.values():
                    c.launches = 0
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                for reverse in (False, True):
                    leaves = [a.clone().requires_grad_() for a in (gx, sW)]
                    hh = scan(*leaves, reverse=reverse)
                    res[tag, reverse] = [hh.detach()] + list(
                        torch.autograd.grad(hh, leaves, dh))
                    del hh, leaves
                torch.cuda.synchronize()
                peak[tag] = (torch.cuda.max_memory_allocated() - base) / 1e9
                n[tag] = {k: c.launches for k, c in mine.items()}
        launches[cell + "_scan bf16"] = n["bf16"]
        check(all(n[tag]["{}_scan_{}".format(cell, w)] == 2
                  and n[tag]["{}_scan_{}[bf16]".format(cell, w)] == (
                      2 if tag == "bf16" else 0)
                  for w in ("fwd", "bwd") for tag in n)
              and n["bf16"]["atb_gemm[bf16]"] == n["bf16"]["atb_gemm"] == 2,
              "{}_scan under the switch and unset: launches {}".format(
                  cell, n))
        errs = [0.0, 0.0, 0.0]
        for reverse in (False, True):
            for i, (a, b) in enumerate(zip(res["bf16", reverse],
                                           res["f32", reverse])):
                check(a.dtype == b.dtype == torch.float32
                      and bool(torch.isfinite(a).all()),
                      "{}_scan under the switch: output {} {}".format(
                          cell, i, a.dtype))
                errs[i] = max(errs[i], ((a - b).abs().max()
                                        / b.abs().max()).item())
        del res
        torch.cuda.empty_cache()
        check(max(errs) <= BF16_GRAD_TOL, "{}_scan bf16 against f32: h, d "
              "gates_x, d_sW {} (tol {})".format(cell, errs, BF16_GRAD_TOL))
        out[cell] = {"h": errs[0], "d_gates_x": errs[1], "d_sW": errs[2],
                     "peak_gb": peak["bf16"], "f32_peak_gb": peak["f32"]}
        say("{}_scan under the switch T={} B={} H={} (autograd, both "
            "directions): launches {}; against the f32 scan (of each one's "
            "largest, tol {}): h {:.3g}, d gates_x {:.3g}, d_sW {:.3g}; "
            "peak {:.3f} GB against {:.3f} GB".format(
                cell, t, TB, H, n["bf16"], BF16_GRAD_TOL, *errs,
                peak["bf16"], peak["f32"]))
        del gx, sW, dh
    return launches, out


# -- phase 20 ----------------------------------------------------------------

# the shapes of the score-stream route's bf16 instances: (tag, T, B, L,
# S, sequence lengths (None: L/2 .. L)): the mLstm training shape, its
# cat_mod width, a cluster of 4 CTAs a row (L=9000) and of 8 (L=20000),
# whose rows of 2300-2700 positions cross a CTA of the cluster, and the
# device-memory instance past 32768 positions; T cut at the long lattices
# (the twins' Python loop is what costs there)
STREAM_BF16_SHAPES = (("training", TT, TB, TL, S, None),
                      ("cat_mod", TT, TB, TL, SC, None),
                      ("L=9000", 2600, XB, XL, SC, (2300, 2590)),
                      ("L=20000", 2700, YB, YL, S, (2600, 2690)),
                      ("device memory", 600, 1, 32776, SC, (400, 590)))
# the score switch of each instance under TAIYAKI_TPU_BF16_STREAMS=1: bf16
# streams (and logZ scores), or f32 ones, with bf16 lattices and
# posteriors
STREAM_ROWS = (("bf16", "TAIYAKI_TPU_NO_SCORE_FUSE"),
               ("mixed", "TAIYAKI_TPU_F32_SCORES"))


def _stream_bounds(tt, tb, tl, npos, n_fmove, n_bmove, sbytes, s):
    """The bounds of kernels 9-10 at one shape (check_crf_streams' counts:
    each stream read where this data needs it), the streams at `sbytes`
    a value, the lattice and the posteriors bf16 (2 bytes), d lp f32:
    (forward, posteriors entry, d lp entry), each (ms, by)."""
    lat = 2 * tt * tb * tl
    reads = sbytes * tt * (npos + n_bmove) + 2 * tt * npos
    return (bound_ms(sbytes * tt * (npos + n_fmove) + lat
                     + 4 * (2 * tb * tl + tb), 10 * tt * npos),
            bound_ms(reads + 2 * lat + 4 * (tb * tl + tb), 20 * tt * npos),
            bound_ms(reads + 4 * tt * tb * s + 4 * (5 * tb * tl + tb),
                     20 * tt * npos))


def check_bf16_stream_kernels(torch, dev, rng):
    """Phase 20a: the bf16-stream and the mixed (f32 streams, bf16
    lattice) instances of rows 9 and 10 at STREAM_BF16_SHAPES against
    their twins, which round where the kernels round, on phase 18a's
    terms: the score 1e-3 + 1e-5 |score|, fwd_final 1e-4 on live states,
    the bf16 lattice and posteriors as `bf16_err` (atol 1e-4; 1e-5, 3e-4
    past T=800), each backward on the twin's lattice; d lp (sums of bf16
    posteriors, the mod ones weighted by bf16(fact)) within one bf16 step
    of a posterior times the largest weight, past the posteriors' atol
    times it at most BF16_SHARE of its entries; the posteriors and d lp
    bitwise from run to run.  Then logZ's mixed instance (rows 2-3: f32
    scores, a bf16 lattice and posteriors) at the training shape, as 18a
    holds its bf16 one.  Each instance counted, and timed at each shape
    beside the f32 instance on the same streams (the twins at the
    training shape).  Returns the six rows of the kernels line, without
    their launches."""
    from taiyaki_tpu_torch.ops import crf, flipflop, logz
    bf = torch.bfloat16
    crf_names = ["{}[{}]".format(n, i) for i, _ in STREAM_ROWS
                 for n in ("crf_fwd_streams", "crf_grad_streams")]
    names = crf_names + ["logz_fwd[mixed]", "logz_posteriors[mixed]"]
    err, share = dict.fromkeys(names, 0.0), dict.fromkeys(names, 0.0)
    post = {}
    ms, f32_ms, plain_ms, bounds = {}, {}, {}, {}
    counts = {n: getattr(getattr(logz if "logz" in n else crf,
                                 n.split("[")[0]), n[:-1].split("[")[1])
              for n in names}
    counts.update({"crf_bwd_posteriors[{}]".format(i): getattr(
        crf.crf_bwd_posteriors, i) for i, _ in STREAM_ROWS})
    before = {n: c.launches for n, c in counts.items()}

    def record(name, tag, d, sh):
        err[name], share[name] = max(err[name], d), max(share[name], sh)
        say("{} at the {} shape: |diff| {:.3g}, share one bf16 step apart "
            "{:.3g} (at most {})".format(name, tag, d, sh, BF16_SHARE))

    for tag, tt, tb, tl, s, lens in STREAM_BF16_SHAPES:
        lp, seqlens, args = _crf_case(torch, dev, rng, tt, tb, tl, s, lens)
        sidx, midx, mmidx, mfact, valid, last = args
        idx = (sidx, midx, mmidx, mfact)
        mod = (mmidx, mfact) if s > S else (None, None)
        stay32, move32 = flipflop._select_streams(lp, sidx, midx, *mod)
        del lp
        p_tol = 1e-5 if tt <= TT else 3e-4
        reps = 5 if tt <= TT else 2
        weight = max(1.0, mfact.max().item())
        for inst, _ in STREAM_ROWS:
            fwd_n, grad_n = ("crf_fwd_streams[{}]".format(inst),
                             "crf_grad_streams[{}]".format(inst))
            stay, move = ((stay32.to(bf), move32.to(bf)) if inst == "bf16"
                          else (stay32, move32))
            f0, s0, lat0 = crf.crf_fwd_streams_plain(stay, move, valid,
                                                     lattice_dtype=bf)
            p0 = crf.crf_bwd_posteriors_plain(stay, move, lat0, valid, last)
            # crf_grad_streams_plain is these posteriors scattered
            g0 = crf.scatter_posteriors(
                stay.shape[:2] + (s,), p0[0].float(), p0[1].float(), sidx,
                midx, mmidx, crf._rounder(bf)(mfact))
            f1, s1, lat1 = crf.crf_fwd_streams(stay, move, valid,
                                               lattice_dtype=bf)
            p1 = crf.crf_bwd_posteriors(stay, move, lat0, valid, last)
            p2 = crf.crf_bwd_posteriors(stay, move, lat0, valid, last)
            g1 = crf.crf_grad_streams(stay, move, lat0, valid, last, *idx, s)
            g2 = crf.crf_grad_streams(stay, move, lat0, valid, last, *idx, s)
            torch.cuda.synchronize()
            s_err = max_abs_diff(s1, s0)
            s_tol = 1e-3 + 1e-5 * s0.abs().max().item()
            live = f0 > crf.NEG / 2
            f_err = (f1 - f0).abs().masked_fill(~live, 0).max().item()
            check(s_err <= s_tol and f_err <= 1e-4, "{} {}: score err {} "
                  "(tol {}), fwd_final {}".format(fwd_n, tag, s_err, s_tol,
                                                  f_err))
            d, sh, ok = bf16_err(torch, lat1, lat0, 1e-4)
            check(ok, "{} {}: lattice |diff| {} share {}".format(
                fwd_n, tag, d, sh))
            record(fwd_n, tag, max(s_err, f_err, d), sh)
            p_err, p_sh = 0.0, 0.0
            for a, b, again in zip(p1, p0, p2):
                d, sh, ok = bf16_err(torch, a, b, p_tol)
                check(ok and bool(torch.equal(a, again)), "crf_bwd_posteriors"
                      "[{}] {}: |diff| {} share {}, bitwise run to run {}"
                      .format(inst, tag, d, sh, torch.equal(a, again)))
                p_err, p_sh = max(p_err, d), max(p_sh, sh)
            diff = (g1 - g0).abs()
            g_err = diff.max().item()
            past = (diff > p_tol * weight).float().mean().item()
            check(g_err <= 2.0 ** -8 * weight and past <= BF16_SHARE
                  and bool(torch.equal(g1, g2)), "{} {}: d lp |diff| {} (at "
                  "most 2^-8 x {}), {} of it past {}, bitwise run to run {}"
                  .format(grad_n, tag, g_err, weight, past, p_tol * weight,
                          torch.equal(g1, g2)))
            record(grad_n, tag, g_err, past)
            post.setdefault(inst, dict(max_abs_err=0.0))
            post[inst]["max_abs_err"] = max(post[inst]["max_abs_err"], p_err)
            del f0, s0, g0, f1, s1, lat1, p1, p2, g1, g2, diff
            ms[fwd_n, tag] = cuda_ms(torch, lambda: crf.crf_fwd_streams(
                stay, move, valid, lattice_dtype=bf), reps=reps)
            ms["post", inst, tag] = cuda_ms(
                torch, lambda: crf.crf_bwd_posteriors(stay, move, lat0,
                                                      valid, last),
                reps=reps)
            ms[grad_n, tag] = cuda_ms(torch, lambda: crf.crf_grad_streams(
                stay, move, lat0, valid, last, *idx, s), reps=reps)
            if tag == "training":
                plain_ms[fwd_n] = cuda_ms(
                    torch, lambda: crf.crf_fwd_streams_plain(
                        stay, move, valid, lattice_dtype=bf),
                    reps=1, warmup=0)
                plain_ms["post", inst] = cuda_ms(
                    torch, lambda: crf.crf_bwd_posteriors_plain(
                        stay, move, lat0, valid, last), reps=1, warmup=0)
                plain_ms[grad_n] = cuda_ms(
                    torch, lambda: crf.crf_grad_streams_plain(
                        stay, move, lat0, valid, last, *idx, s),
                    reps=1, warmup=0)
                pos = torch.arange(tl, device=dev)[None]
                ok_pos = valid != 0
                bounds[fwd_n], bounds["post", inst], bounds[grad_n] = \
                    _stream_bounds(tt, tb, tl, int(seqlens.sum()),
                                   int(ok_pos[:, 1:].sum().item()),
                                   int((ok_pos & (pos < last.long()[:, None]))
                                       .sum().item()),
                                   2 if inst == "bf16" else 4, s)
            del stay, move, lat0
        _, _, lat32 = crf.crf_fwd_streams(stay32, move32, valid)
        f32_ms["fwd", tag] = cuda_ms(torch, lambda: crf.crf_fwd_streams(
            stay32, move32, valid), reps=reps)
        f32_ms["post", tag] = cuda_ms(torch, lambda: crf.crf_bwd_posteriors(
            stay32, move32, lat32, valid, last), reps=reps)
        f32_ms["grad", tag] = cuda_ms(torch, lambda: crf.crf_grad_streams(
            stay32, move32, lat32, valid, last, *idx, s), reps=reps)
        times = [[ms["crf_fwd_streams[%s]" % i, tag], ms["post", i, tag],
                  ms["crf_grad_streams[%s]" % i, tag]]
                 for i, _ in STREAM_ROWS]
        say("crf on score streams at the {} shape (T={}, B={}, L={}, S={}; "
            "layout {}): forward, posteriors, d lp ms: bf16 streams {}, f32 "
            "streams with a bf16 lattice {}, f32 {}".format(
                tag, tt, tb, tl, s, crf.streams_layout(tl) or
                "device memory", *times, [f32_ms[k, tag] for k in (
                    "fwd", "post", "grad")]))
        del stay32, move32, lat32, args
        torch.cuda.empty_cache()

    # logZ's mixed instance at the training shape
    sc = _tensor(torch, dev, 5.0 * np.tanh(rng.normal(size=(TT, TB, S))))
    f0, z0, l0 = logz.logz_fwd_plain(sc, NBASE, lattice_dtype=bf)
    p0 = logz.logz_posteriors_plain(sc, l0, NBASE, out_dtype=bf)
    f1, z1, l1 = logz.logz_fwd(sc, lattice_dtype=bf)
    p1 = logz.logz_posteriors(sc, l0, out_dtype=bf)
    p2 = logz.logz_posteriors(sc, l0, out_dtype=bf)
    torch.cuda.synchronize()
    z_err = max_abs_diff(z1, z0)
    z_tol = 1e-3 + 1e-5 * z0.abs().max().item()
    check(z_err <= z_tol and max_abs_diff(f1, f0) <= 1e-4,
          "logz_fwd[mixed]: logZ err {} (tol {})".format(z_err, z_tol))
    d, sh, ok = bf16_err(torch, _states_bf16(torch, l1),
                         _states_bf16(torch, l0), 1e-4)
    check(ok, "logz_fwd[mixed]: lattice |diff| {} share {}".format(d, sh))
    record("logz_fwd[mixed]", "training", max(z_err, d), sh)
    d, sh, ok = bf16_err(torch, p1, p0, 1e-5)
    check(ok and bool(torch.equal(p1, p2)), "logz_posteriors[mixed]: |diff| "
          "{} share {}, bitwise run to run {}".format(d, sh,
                                                      torch.equal(p1, p2)))
    record("logz_posteriors[mixed]", "training", d, sh)
    _, _, l32 = logz.logz_fwd(sc)
    for n, f, f32 in (
            ("logz_fwd[mixed]", lambda: logz.logz_fwd(sc, lattice_dtype=bf),
             lambda: logz.logz_fwd(sc)),
            ("logz_posteriors[mixed]",
             lambda: logz.logz_posteriors(sc, l1, out_dtype=bf),
             lambda: logz.logz_posteriors(sc, l32))):
        ms[n, "training"] = cuda_ms(torch, f, reps=5)
        f32_ms[n, "training"] = cuda_ms(torch, f32, reps=5)
    plain_ms["logz_fwd[mixed]"] = cuda_ms(
        torch, lambda: logz.logz_fwd_plain(sc, NBASE, lattice_dtype=bf),
        reps=1, warmup=0)
    plain_ms["logz_posteriors[mixed]"] = cuda_ms(
        torch, lambda: logz.logz_posteriors_plain(sc, l0, NBASE,
                                                  out_dtype=bf),
        reps=1, warmup=0)
    nff = 2 * NBASE
    bounds["logz_fwd[mixed]"] = bound_ms(
        4 * TT * TB * S + 2 * TT * TB * nff + 4 * (TB * nff + TB),
        TT * TB * (4 * S + 4 * nff))
    bounds["logz_posteriors[mixed]"] = bound_ms(
        4 * TT * TB * S + 2 * TT * TB * nff + 2 * TT * TB * S,
        TT * TB * (8 * S + 4 * nff))
    del sc, f0, z0, l0, p0, f1, z1, l1, p1, p2, l32
    torch.cuda.empty_cache()
    for n, c in counts.items():
        check(c.launches > before[n], "{}: no launch of the instance".format(
            n))

    rows = []
    for name, f32_name, where in BF16_ROWS:
        if name not in names:
            continue
        inst = name[:-1].split("[")[1]
        # the f32 instance's times: by kernel 9 / 10 (fwd, grad), or logZ's
        kind = (("fwd" if "fwd" in name else "grad") if "crf" in name
                else name)
        shapes = [t for t, *_ in STREAM_BF16_SHAPES if (name, t) in ms]
        row = dict(
            name=name, route="cuda",
            source="taiyaki_tpu_torch/csrc/{}.cu".format(
                "logz" if "logz" in name else "crf"),
            replaces="taiyaki_tpu/ops/" + where, max_abs_err=err[name],
            bf16_share=share[name], ms=ms[name, "training"],
            plain_ms=plain_ms[name], bound_ms=bounds[name][0],
            bound_by=bounds[name][1], library_ms=None,
            f32_ms=f32_ms[kind, "training"],
            shapes_ms={t: [ms[name, t], f32_ms[kind, t]] for t in shapes})
        if kind == "grad":
            row["post"] = dict(
                post[inst], ms=ms["post", inst, "training"],
                f32_ms=f32_ms["post", "training"],
                plain_ms=plain_ms["post", inst],
                bound_ms=bounds["post", inst][0],
                bound_by=bounds["post", inst][1],
                shapes_ms={t: [ms["post", inst, t], f32_ms["post", t]]
                           for t in shapes})
        rows.append(row)
        say("{} (T={} B={} L={}): max err {:.3g}, share {:.3g}; {:.3f} ms "
            "against the f32 instance's {:.3f} ms on the same inputs, twin "
            "{:.3f} ms, bound {:.4f} ms ({}); [instance, f32] ms by shape "
            "{}{}".format(name, TT, TB, TL, err[name], share[name],
                          row["ms"], row["f32_ms"], row["plain_ms"],
                          row["bound_ms"], row["bound_by"],
                          json.dumps(row["shapes_ms"]),
                          "; posteriors entry {}".format(json.dumps(
                              row["post"])) if "post" in row else ""))
    return rows


def bf16_stream_steps(torch, dev, seed, counters):
    """Phase 20b: the full-width mLstm and cat_mod steps (TB chunks x
    CHUNK samples, the mod columns x8) on the streams route under the
    switch, with each score switch of STREAM_ROWS, against the f32 step
    under the same score switch on the same batch and weights: the loss
    within BF16_LOSS_TOL relative and each gradient within BF16_GRAD_TOL
    of its largest (BF16_CATMOD_GRAD_TOL for cat_mod), phase 18b's terms.
    Each step under the switch counted (`counters`, set to 0 just before
    it and read just after): the row's instances of rows 9-10 and 2-3
    launched, the other row's and the fused kernels 5-6 never.  The
    cat_mod step's ms (median of 3) and peak memory under each.  Returns
    ({path: launches}, {numbers})."""
    from taiyaki_tpu_torch import train
    from taiyaki_tpu_torch.convert import leaf_names
    launches, out = {}, {}
    for model in (MLSTM, MLSTM_CATMOD):
        tag = model[0].split("_flipflop")[0]
        batch, kwargs = step_batch(seed, TB, model)
        num = {}
        for inst, env in STREAM_ROWS:
            res = {}
            for on in (False, True):
                with switches(dict({env: "1"}, **(BF16_STREAMS[1] if on
                                                  else {}))):
                    net = new_net(seed, kwargs, dev, model)
                    names = leaf_names(net)
                    args, factor = loss_args(net)
                    if on:
                        for fn in counters.values():
                            fn.launches = 0
                    loss, grads = train.make_grad_step(net, *args)(
                        train.batch_to_device(batch, dev), 1.0, *factor)
                    torch.cuda.synchronize()
                    if on:
                        path = "{} {} streams step".format(tag, inst)
                        launches[path] = got = {
                            k: fn.launches for k, fn in counters.items()}
                        # kernels 9-10 and logZ, each as the row's
                        # instance
                        want = {k for k in got if k.startswith((
                            "crf_fwd_streams", "crf_grad_streams", "logz"))
                            and (k.endswith("[%s]" % inst) or "[" not in k)}
                        check(all(got[k] > 0 for k in want)
                              and not any(got[k] for k in got
                                          if k not in want),
                              "{}: launches {}".format(path, got))
                    res[on] = (float(loss), [g.float() for g in grads])
                    del net
            (l32, g32), (l16, g16) = res[False], res[True]
            l_err = abs(l16 - l32) / abs(l32)
            errs = [((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
                    .item() for a, b in zip(g16, g32)]
            worst = names[int(np.argmax(errs))]
            g_tol = (BF16_CATMOD_GRAD_TOL if is_cat_mod(model)
                     else BF16_GRAD_TOL)
            check(np.isfinite(l16) and l_err <= BF16_LOSS_TOL
                  and max(errs) <= g_tol, "{} {} streams step: loss {} vs "
                  "f32 {} (relative {}), gradient err {} ({}, tol {})".format(
                      tag, inst, l16, l32, l_err, max(errs), worst, g_tol))
            num[inst] = dict(loss=l16, f32_loss=l32, loss_err=l_err,
                             grad_err=max(errs), worst=worst)
            del res, g32, g16
            torch.cuda.empty_cache()
        if is_cat_mod(model):
            for name, env in (("f32 streams", {STREAM_ROWS[0][1]: "1"}),) + \
                    tuple((inst, dict({env: "1"}, **BF16_STREAMS[1]))
                          for inst, env in STREAM_ROWS):
                with switches(env):
                    step_ms, peak = _median_step(torch, dev, seed, model,
                                                 batch, kwargs)
                torch.cuda.empty_cache()
                num.setdefault(name, {}).update(ms=step_ms,
                                                peak_gb=peak / 1e9)
        out[tag] = num
        say("{} step ({} chunks x {} samples, size {}, L={}) on the streams "
            "route under TAIYAKI_TPU_BF16_STREAMS=1, against the f32 step "
            "(loss tol {}, gradient tol {} of each one's largest): {}".format(
                tag, TB, CHUNK, H, batch.seqs.shape[1], BF16_LOSS_TOL,
                BF16_CATMOD_GRAD_TOL if is_cat_mod(model) else BF16_GRAD_TOL,
                json.dumps(num)))
    return launches, out


def bf16_stream_basecall(torch, dev, work, model, reads, counters, idle):
    """Phase 20c: `cli.basecall` of phase 3's reads `reads` from its mLstm
    checkpoint `model` with the switch exported: the CLI's opt-out sets
    TAIYAKI_TPU_F32_SCORES=1, so make_trans runs logZ's mixed instance
    (`counters`, each launched; `idle`, the bf16 instances, never).  Its
    calls against phase 3's f32 calls (work/mLstm.fa), and per chunk of
    the first B chunks of the reads (Basecaller, want_trans) the path
    under the switch against the f32 one, by the near-tie rule under
    rounded scores: a path that differs must score the f32 best, under
    the f32 scores, within 1e-4 plus what the rounding moved the two
    paths' scores (|S32(p) - S16(p)| of each path p; the best path under
    one set of scores is within that of the best under the other).
    Returns (launches, stats)."""
    from taiyaki_tpu_torch.cli import basecall
    from taiyaki_tpu_torch.convert import load_jax_params
    from taiyaki_tpu_torch.data import fast5utils
    from taiyaki_tpu_torch.ops.rnn import f32_inference
    from taiyaki_tpu_torch.utils import helpers
    counted = dict(counters, **idle)
    for fn in counted.values():
        fn.launches = 0
    fa = os.path.join(work, "mLstm_bf16_streams.fa")
    with switches(BF16_STREAMS[1]):
        stats = basecall.main(["--output", fa, "--quiet", reads, model])
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counted.items()}
    check(all(launches[k] > 0 for k in counters)
          and not any(launches[k] for k in idle) and stats["nread"] == 9,
          "basecall under the switch: launches {}, {} reads".format(
              launches, stats["nread"]))
    calls, first = read_fastx(fa), read_fastx(os.path.join(work, "mLstm.fa"))
    same = [rid for rid in first if calls.get(rid) == first[rid]]
    net, params, *_ = helpers.load_model(model)
    net = load_jax_params(net, params).to(dev).eval()
    parts = []
    for fname, rid in fast5utils.iterate_fast5_reads(reads):
        parts.append(basecall.prepare_read(
            rid, basecall.get_signal(fname, rid), T * net.stride,
            100 * net.stride, None, False)["chunks"])
    chunks = torch.from_numpy(np.concatenate(parts, axis=1)[:, :B]).to(dev)
    res = []
    for env in ({}, BF16_STREAMS[1]):
        with switches(env), f32_inference(), torch.inference_mode():
            caller = basecall.Basecaller(net, 40, True, 1.0, B, dev,
                                         want_trans=True)
            res.append({k: v.cpu().numpy()
                        for k, v in caller.call_chunks(chunks).items()})
    f32, b16 = res
    ndiff, worst, moved = 0, 0.0, 0.0
    for i in range(chunks.shape[1]):
        if np.array_equal(b16["paths"][:, i], f32["paths"][:, i]):
            continue
        ndiff += 1
        # score[s, p]: path p's score under the scores s
        score = {(s, p): path_score(t["trans"][:, i], q["paths"][:, i], NBASE)
                 for s, t in (("32", f32), ("16", b16))
                 for p, q in (("32", f32), ("16", b16))}
        gap = score["32", "32"] - score["32", "16"]
        bound = (abs(score["32", "32"] - score["16", "32"])
                 + abs(score["32", "16"] - score["16", "16"]))
        check(gap <= 1e-4 + bound, "chunk {}: the path under the switch "
              "scores {} below the f32 best (rounding moved the paths' "
              "scores by {})".format(i, gap, bound))
        worst, moved = max(worst, gap), max(moved, bound)
    check(len(same) == len(first) or ndiff > 0,
          "calls under the switch differ with equal chunk paths")
    post_err = float(np.abs(np.exp(b16["trans"]) - np.exp(f32["trans"]))
                     .max())
    out = dict(equal_calls=len(same), reads=len(first), chunks=int(
        chunks.shape[1]), differing_chunks=ndiff, worst_gap=worst,
        largest_moved=moved, posterior_err=post_err,
        ksample_s=stats["nsample"] / stats["seconds"] / 1e3)
    say("basecall under TAIYAKI_TPU_BF16_STREAMS=1 (mLstm, phase 3's "
        "reads; logZ's mixed instance): {}; launches {}".format(
            json.dumps(out), launches))
    return launches, out


def run(seed):
    try:
        import torch
    except ImportError:
        raise SmokeFailure("PyTorch is not installed")
    if not torch.cuda.is_available():
        raise SmokeFailure("no CUDA card: torch.cuda.is_available() is false")
    if not os.path.isdir(os.path.join(ROOT, "taiyaki_tpu_torch", "csrc")):
        raise SmokeFailure("run chip_smoke.py from the root of a checkout "
                           "(taiyaki_tpu_torch/ not found)")
    sys.path.insert(0, ROOT)
    from taiyaki_tpu_torch import train
    from taiyaki_tpu_torch.ops import crf, cuda_lib, gemm, gru, logz, lstm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    say("card: {} (torch {}, CUDA {})".format(card, torch.__version__,
                                              torch.version.cuda))
    phases = Phases()
    phases.next("1 build")
    t0 = time.time()
    libs = cuda_lib.build_all()
    say("kernels built in {:.1f} s (nvcc, sm_90a): {}".format(
        time.time() - t0,
        ", ".join(os.path.basename(p) for p in libs.values())))
    from taiyaki_tpu_torch import decodeutil
    t0 = time.time()
    decodeutil.library()
    say("host decoders (beam search, remap and squiggle Viterbi, aligner) "
        "built in {:.1f} s (g++)".format(time.time() - t0))

    phases.next("2 kernels against their twins")
    rng = np.random.default_rng(seed)
    kernels = [check_lstm(torch, dev, rng)] + check_logz(torch, dev, rng)
    lstm_fwd_rows, lstm_bwd_rows = check_lstm_train(torch, dev, rng)
    kernels += lstm_bwd_rows + check_crf(torch, dev, rng)
    torch.cuda.empty_cache()
    long_crf = check_crf(torch, dev, rng, LT, LB, LL, g_tol=3e-4)
    torch.cuda.empty_cache()
    gru_row, gru96_row = check_gru(torch, dev, rng)
    gru_fwd_rows, gru_bwd_rows = check_gru_train(torch, dev, rng)
    kernels += [gru_row] + gru_bwd_rows
    torch.cuda.empty_cache()
    stream_rows = check_crf_streams(torch, dev, rng)
    kernels += stream_rows
    torch.cuda.empty_cache()
    catmod_crf = check_crf(torch, dev, rng, s=SC)
    torch.cuda.empty_cache()
    check_crf_streams(torch, dev, rng, tl=TRAIN_L)
    torch.cuda.empty_cache()
    # a width that is not a multiple of 4 (4-byte stream copies)
    check_crf_streams(torch, dev, rng, tl=TL - 3)
    torch.cuda.empty_cache()
    kernels += check_scan(torch, dev, rng)
    torch.cuda.empty_cache()
    l2_512 = check_l2_512(torch, dev, rng)
    torch.cuda.empty_cache()
    defaults_fwd = check_defaults_fwd(torch, dev, rng)
    torch.cuda.empty_cache()
    bwd_shapes = check_bwd_shapes(torch, dev, rng)
    torch.cuda.empty_cache()
    gemm_rows = check_gemms(torch, dev)
    torch.cuda.empty_cache()
    check_offset_views(torch, dev, rng)
    torch.cuda.empty_cache()

    # every counter is read per path: reset just before it, read just after
    counters = {"lstm_fwd": lstm.lstm_fwd, "logz_fwd": logz.logz_fwd,
                "logz_posteriors": logz.logz_posteriors,
                "lstm_bwd_acts": lstm.lstm_bwd_acts,
                "lstm_bwd_fusedw": lstm.lstm_bwd_fusedw,
                "lstm_bwd_recompute": lstm.lstm_bwd_recompute,
                "crf_fwd": crf.crf_fwd, "crf_bwd": crf.crf_bwd,
                "gru_fwd": gru.gru_fwd,
                "gru_bwd_recompute": gru.gru_bwd_recompute,
                "gru_bwd_fusedw": gru.gru_bwd_fusedw,
                "crf_fwd_streams": crf.crf_fwd_streams,
                "crf_grad_streams": crf.crf_grad_streams,
                "lstm_scan_fwd": lstm.lstm_scan_fwd,
                "lstm_scan_bwd": lstm.lstm_scan_bwd,
                "gru_scan_fwd": gru.gru_scan_fwd,
                "gru_scan_bwd": gru.gru_scan_bwd}
    # the recurrences' launches of their cluster instance (the forwards',
    # and the backwards' chains), counted beside each one's own counter
    # wherever that is picked
    recurrences = ("lstm_fwd", "gru_fwd", "lstm_scan_fwd", "gru_scan_fwd",
                   "lstm_bwd_acts", "lstm_bwd_fusedw", "lstm_bwd_recompute",
                   "gru_bwd_recompute", "gru_bwd_fusedw", "lstm_scan_bwd",
                   "gru_scan_bwd")
    for k in recurrences:
        counters[k + "[cluster]"] = counters[k].by_instance["cluster"]
    # the GEMMs under the layers (ops/gemm.py): every launch of a path, and
    # its tc instance's, which must be all of them, and those with a bf16
    # operand or output (the bf16 streams)
    gemms = ("gate_gemm", "atb_gemm")
    for k in gemms:
        counters[k] = getattr(gemm, k)
        counters[k + "[tc]"] = counters[k].by_instance["tc"]
        counters[k + "[bf16]"] = counters[k].bf16
    # the bf16 instances of rows 1, 4, 11 and 12 (TAIYAKI_TPU_BF16_STREAMS),
    # and since phase 20 the mixed ones (f32 scores, bf16 lattices)
    for name, f32_name, _ in BF16_ROWS:
        counters[name] = getattr(counters[f32_name], name[:-1].split("[")[1])
    loss = ("crf_fwd", "crf_bwd", "logz_fwd", "logz_posteriors")
    streams = ("crf_fwd_streams", "crf_grad_streams")
    lstm_bwds = {"acts": "lstm_bwd_acts", "pre": "lstm_bwd_fusedw",
                 "recompute": "lstm_bwd_recompute"}
    gru_bwds = {"recompute": "gru_bwd_recompute", "stored": "gru_bwd_fusedw"}
    lstm_call = ("lstm_fwd", "logz_fwd", "logz_posteriors")
    gru_call = ("gru_fwd", "logz_fwd", "logz_posteriors")

    def pick(names):
        """The counters of the kernels `names`, with the recurrences'
        cluster instance and the GEMMs' tc instance: a path with a layer
        backward runs both GEMMs, one with a layer forward the gate
        GEMM."""
        names = tuple(names)
        if set(names) & (set(lstm_bwds.values()) | set(gru_bwds.values())):
            names += gemms
        elif set(names) & {"lstm_fwd", "gru_fwd"}:
            names += ("gate_gemm",)
        return {k: counters[k] for n in names
                for k in ((n, n + "[cluster]") if n in recurrences
                          else (n, n + "[tc]") if n in gemms else (n,))}

    def train_policy(model, fwd, bwds, policy, niter):
        """The training path under `policy`: its backward launched, the
        cell's other backwards (the default among them) not."""
        return train_path(torch, work, seed,
                          pick((fwd,) + loss + tuple(bwds.values())), model,
                          policy=policy, niter=niter,
                          idle=[v for k, v in bwds.items()
                                if k != policy[0]])[0]

    work = tempfile.mkdtemp(prefix="chip_smoke_")
    launches = {}
    try:
        phases.next("3 mLstm: training, policies' paths, basecall, beam, "
                    "profiles")
        launches["mLstm training"], _, outdir = train_path(
            torch, work, seed, pick(("lstm_fwd", "lstm_bwd_acts") + loss),
            MLSTM)
        torch.cuda.empty_cache()
        for policy in LSTM_POLICIES[1:]:
            launches["mLstm training " + policy[0]] = train_policy(
                MLSTM, "lstm_fwd", lstm_bwds, policy, 4)
            torch.cuda.empty_cache()
        card_vs_cpu(torch, dev, seed, MLSTM, LSTM_POLICIES[1:])
        model = mlstm_ckpt = os.path.join(outdir, "model_final.checkpoint")
        launches["mLstm basecall"], viterbi, reads = main_path(
            torch, dev, seed, work, model, pick(lstm_call), "mLstm")
        launches["mLstm basecall beam"], beam = beam_synthetic(
            torch, dev, work, model, reads, viterbi, pick(lstm_call))
        profile_batch(torch, dev, model, reads)
        torch.cuda.empty_cache()
        profile_train_step(torch, dev, seed, MLSTM)
        torch.cuda.empty_cache()

        phases.next("4 mGru: training, stored policy, real reads, beam")
        launches["mGru training"], _, _ = train_path(
            torch, work, seed, pick(("gru_fwd", "gru_bwd_recompute") + loss),
            MGRU)
        torch.cuda.empty_cache()
        launches["mGru training stored"] = train_policy(
            MGRU, "gru_fwd", gru_bwds, GRU_POLICIES[1], 4)
        torch.cuda.empty_cache()
        card_vs_cpu(torch, dev, seed, MGRU, GRU_POLICIES[1:])
        launches["mGru real reads"], _ = real_reads(torch, dev, work,
                                                    pick(gru_call))
        launches["mGru real reads beam"], _ = beam_real_reads(
            torch, dev, work, pick(gru_call))
        phases.next("12 data preparation")
        prep_launches, _ = prepare_path(torch, dev, work, pick, mlstm_ckpt,
                                        card)
        launches.update(prep_launches)
        torch.cuda.empty_cache()
        phases.next("4 mGru: basecall, profiles")
        model = seeded_checkpoint(work, seed, MGRU)
        launches["mGru basecall"], _, reads = main_path(
            torch, dev, seed, work, model, pick(gru_call), "mGru")
        profile_batch(torch, dev, model, reads)
        torch.cuda.empty_cache()
        profile_train_step(torch, dev, seed, MGRU)
        torch.cuda.empty_cache()

        # cat_mod: the long lattices, then training on each route
        phases.next("6 cat_mod")
        launches["long lattice"], long_rows = long_lattice(
            torch, dev, rng, pick(("crf_fwd", "crf_bwd") + streams))
        launches["longest lattice"], longest_rows = long_lattice(
            torch, dev, rng, pick(("crf_fwd", "crf_bwd") + streams),
            (YT, YB, YL))
        launches["mLstm cat_mod training"], _, outdir = train_path(
            torch, work, seed, pick(("lstm_fwd", "lstm_bwd_acts") + loss
                                    + streams), MLSTM_CATMOD,
            idle=streams)
        torch.cuda.empty_cache()
        with count_scatters(torch) as scatters:
            launches["mLstm cat_mod training streams"], _, s_outdir = \
                train_path(torch, work, seed,
                           pick(("lstm_fwd", "lstm_bwd_acts") + loss
                                + streams), MLSTM_CATMOD, policy=STREAMS,
                           niter=4, idle=("crf_fwd", "crf_bwd"))
        check(scatters["calls"] == 0, "cat_mod streams training: {} "
              "scatter_add_ calls".format(scatters["calls"]))
        same_losses(outdir, s_outdir, 4)
        torch.cuda.empty_cache()
        card_vs_cpu(torch, dev, seed, MLSTM_CATMOD, (STREAMS,))
        launches["mLstm cat_mod basecall"], _ = catmod_basecall(
            torch, dev, work, os.path.join(outdir, "model_final.checkpoint"),
            pick(lstm_call), "trained")
        # an 8-step model may call no base; seeded weights (seed 1 calls
        # C at every base of these reads) give mod scores to compare
        catmod_basecall(torch, dev, work,
                        seeded_checkpoint(work, seed, MLSTM_CATMOD),
                        pick(lstm_call), "seeded")
        torch.cuda.empty_cache()
        routes = catmod_steps(torch, dev, seed)
        torch.cuda.empty_cache()
        phases.next("5 policy steps")
        policies = policy_steps(torch, dev, seed)
        torch.cuda.empty_cache()

        # the recurrences on given gates (kernels 14-17)
        phases.next("7 scan ops")
        launches.update(scan_path(torch, dev, rng, counters, pick))
        torch.cuda.empty_cache()
        # the JAX trainer's own defaults
        phases.next("8 trainer defaults")
        launches["mLstm trainer defaults"], _ = defaults_path(
            torch, work, seed, pick(("lstm_fwd", "lstm_bwd_acts") + loss))
        torch.cuda.empty_cache()
        defaults = defaults_steps(torch, dev, seed)
        torch.cuda.empty_cache()
        profile_train_step(torch, dev, seed, MLSTM,
                           train.sub_batch_size_for_chunk(DSUB, DMAX, DMIN),
                           DMIN, DSIZE)
        torch.cuda.empty_cache()
        card_vs_cpu(torch, dev, seed, MLSTM, nchunk=5, chunk=DMIN,
                    size=DSIZE)
        torch.cuda.empty_cache()

        # the remaining layers, and the JSON export of three checkpoints
        phases.next("11 layers, JSON export")
        cudnn_gru = check_layers(torch, dev, rng)
        torch.cuda.empty_cache()
        all_launches, all_ckpt = all_layers_path(
            torch, dev, seed, work, {k: counters[k] for k in (
                "lstm_fwd", "lstm_bwd_acts", "gru_fwd", "gru_bwd_recompute")
                + loss})
        torch.cuda.empty_cache()
        json_export(work, {"mLstm trained": mlstm_ckpt,
                           "all layers": all_ckpt,
                           "mGru remap": REMAP_MODEL})

        # the squiggle predictor, ab-initio training and --remat, on
        # phase 12's mapped reads and real reads
        mapped = os.path.join(work, "prepare", "mGru.hdf5")
        phases.next("13a train_squiggle")
        sq_ckpt, squiggle = squiggle_path(torch, dev, work, seed, mapped)
        torch.cuda.empty_cache()
        phases.next("13b predict_squiggle")
        predict_path(work, sq_ckpt)
        phases.next("13c map_to_squiggle")
        map_path(work, sq_ckpt)
        phases.next("13d train_abinitio")
        launches["train_abinitio"], abinitio = abinitio_path(
            torch, dev, work, seed, mapped,
            pick(("gru_fwd", "gru_bwd_recompute") + loss))
        torch.cuda.empty_cache()
        phases.next("13e train_flipflop --remat")
        remat_launches, remat = remat_path(
            torch, dev, work, seed,
            pick(("lstm_fwd", "lstm_bwd_acts") + loss))
        launches["train_flipflop --remat"] = remat_launches["remat"]
        launches["train_flipflop (no --remat)"] = remat_launches["plain"]
        torch.cuda.empty_cache()

        # the host tools on phase 4's real reads and phase 12's file
        phases.next("14 host tools")
        launches["round-trip basecall"], calls_fa, round_trip = \
            round_trip_path(torch, dev, work, pick(gru_call))
        scores = scoring_path(work, calls_fa)
        msf_secs = msf_tools_path(work, mapped)

        # multi-card training and sharded basecalling, on the one card,
        # then the analysis tools on its host
        train_loss = ("lstm_fwd", "lstm_bwd_acts") + loss
        phases.next("15a 2-rank training")
        (launches["2-rank training rank 0"],
         launches["2-rank training rank 1"], dp_ms) = two_rank_training(
            torch, dev, work, seed, pick(train_loss))
        torch.cuda.empty_cache()
        phases.next("15b train_flipflop --multihost")
        launches["train_flipflop --multihost"], _ = multihost_cli(
            torch, work, seed, pick(train_loss))
        torch.cuda.empty_cache()
        phases.next("15c sharded basecall")
        launches["sharded basecall"], _, shard_ms = sharded_basecall(
            torch, dev, work, mlstm_ckpt, os.path.join(work, "reads_mLstm"),
            pick(lstm_call))
        torch.cuda.empty_cache()
        phases.next("15d analysis tools")
        analysis_secs = analysis_tools_path(work, mapped, seed)

        # the bf16 streams of the LSTM layers (TAIYAKI_TPU_BF16_STREAMS=1)
        phases.next("16a bf16 instances against their twins")
        f32_rows = {"lstm_fwd": lstm_fwd_rows["acts"]}
        f32_rows.update({k["name"]: k for k in kernels
                         if k["name"] in lstm_bwds.values()})
        bf16_rows = check_bf16_kernels(torch, dev, rng, f32_rows)
        torch.cuda.empty_cache()
        phases.next("16b GEMMs with bf16 operands")
        gemm_rows += check_bf16_gemms(torch, dev)
        torch.cuda.empty_cache()
        phases.next("16c bf16 steps against f32 steps")
        score_bf16 = {k: counters[k] for k in SCORE_BF16}
        step_launches, bf16_step = bf16_steps(
            torch, dev, seed, dict(pick(("lstm_fwd",) + tuple(
                lstm_bwds.values())), **{k: counters[k]
                                         for k in LSTM_BF16}))
        launches.update(step_launches)
        torch.cuda.empty_cache()
        phases.next("16d train_flipflop and basecall under the switch")
        cli_launches, bf16_train = bf16_cli(
            torch, work, seed, dict(pick(train_loss), **{
                k: counters[k] for k in LSTM_BF16[:2]
                + ("gate_gemm[bf16]", "atb_gemm[bf16]")}, **score_bf16),
            os.path.join(work, "reads_mLstm"), score_bf16)
        launches.update(cli_launches)
        torch.cuda.empty_cache()

        # the bf16 streams of the GRU layers
        phases.next("17a GRU bf16 instances against their twins")
        f32_gru = {"gru_fwd": dict(gru_fwd_rows[False],
                                   residuals_ms=gru_fwd_rows[True]["ms"])}
        f32_gru.update({k["name"]: k for k in kernels
                        if k["name"] in gru_bwds.values()})
        bf16_rows += check_bf16_gru_kernels(torch, dev, rng, f32_gru)
        torch.cuda.empty_cache()
        phases.next("17b GRU bf16 steps against f32 steps")
        gru_bf16 = {k: counters[k] for k in GRU_BF16}
        step_launches, gru_bf16_step = bf16_steps(
            torch, dev, seed, dict(pick(("gru_fwd",) + tuple(
                gru_bwds.values())), **gru_bf16), MGRU, GRU_POLICIES,
            GRU_POLICIES)
        launches.update(step_launches)
        torch.cuda.empty_cache()
        phases.next("17c train_flipflop, train_abinitio and basecall under "
                    "the switch")
        cli_launches, gru_bf16_cli = bf16_gru_cli(
            torch, work, seed, dict(pick(("gru_fwd", "gru_bwd_recompute",
                                          "gru_bwd_fusedw") + loss),
                                    **gru_bf16, **score_bf16, **{
                                        k: counters[k] for k in (
                                            "gate_gemm[bf16]",
                                            "atb_gemm[bf16]")}),
            os.path.join(work, "reads_mGru"))
        launches.update(cli_launches)
        torch.cuda.empty_cache()

        # the bf16 score streams of the CRF's fused route and logZ
        phases.next("18a CRF and logZ bf16 instances against their twins")
        bf16_rows += check_bf16_score_kernels(torch, dev, rng)
        torch.cuda.empty_cache()
        phases.next("18b mLstm and cat_mod steps with the bf16 CRF and "
                    "logZ")
        step_launches, score_steps = bf16_score_steps(
            torch, dev, seed, dict(pick(("lstm_fwd", "lstm_bwd_acts")
                                        + loss), **score_bf16))
        launches.update(step_launches)
        torch.cuda.empty_cache()
        phases.next("18c train_flipflop and basecall with the bf16 CRF and "
                    "logZ")
        launches.update(bf16_score_cli(
            torch, work, seed, pick, score_bf16,
            os.path.join(work, "reads_mLstm")))
        torch.cuda.empty_cache()

        # the scans' mixed precision (rows 14-17)
        phases.next("19a scan bf16 instances against their twins")
        bf16_rows += check_bf16_scan_kernels(
            torch, dev, rng, {k["name"]: k for k in kernels
                              if "_scan_" in k["name"]})
        torch.cuda.empty_cache()
        phases.next("19b lstm_scan and gru_scan under the switch")
        scan_launches, scan_bf16 = bf16_scan_path(torch, dev, rng, dict(
            pick(("lstm_scan_fwd", "lstm_scan_bwd", "gru_scan_fwd",
                  "gru_scan_bwd")), **{k: counters[k] for k in SCAN_BF16
                                       + ("atb_gemm", "atb_gemm[tc]",
                                          "atb_gemm[bf16]")}))
        launches.update(scan_launches)
        torch.cuda.empty_cache()

        # the score-stream route's bf16 instances and logZ's mixed one
        phases.next("20a score-stream bf16 instances against their twins")
        bf16_rows += check_bf16_stream_kernels(torch, dev, rng)
        torch.cuda.empty_cache()
        phases.next("20b steps on the streams route under the switch")
        step_launches, stream_steps = bf16_stream_steps(
            torch, dev, seed, {k: counters[k] for k in (
                "crf_fwd", "crf_bwd") + streams + lstm_call[1:] + SCORE_BF16 + STREAM_BF16})
        launches.update(step_launches)
        torch.cuda.empty_cache()
        phases.next("20c basecall under the switch")
        launches["mLstm basecall bf16 lattice"], stream_call = \
            bf16_stream_basecall(
                torch, dev, work, mlstm_ckpt,
                os.path.join(work, "reads_mLstm"),
                dict(pick(lstm_call), **{k: counters[k] for k in (
                    "logz_fwd[mixed]", "logz_posteriors[mixed]")}),
                {k: counters[k] for k in SCORE_BF16 + ("lstm_fwd[bf16]",)})
        torch.cuda.empty_cache()
        phases.next(None)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    say("launches by path: {}".format(json.dumps(launches)))
    # the redesigned posterior kernels (rows 3 and 6) ran on every training
    # and basecall path of both models
    posteriors = {"mLstm training": ("crf_bwd", "logz_posteriors"),
                  "mGru training": ("crf_bwd", "logz_posteriors"),
                  "mLstm basecall": ("logz_posteriors",),
                  "mGru basecall": ("logz_posteriors",),
                  "mGru real reads": ("logz_posteriors",)}
    for path, names in posteriors.items():
        for k in names:
            check(launches[path].get(k, 0) > 0,
                  "{} path: no launch of {}".format(path, k))
    say("posterior kernels (rows 3 and 6) by path: {}".format(json.dumps({
        path: {k: launches[path][k] for k in names}
        for path, names in posteriors.items()})))
    # the redesigned forward kernels (rows 5 and 2) ran on every training
    # and basecall path of both models
    forwards = {"mLstm training": ("crf_fwd", "logz_fwd"),
                "mGru training": ("crf_fwd", "logz_fwd"),
                "mLstm basecall": ("logz_fwd",),
                "mGru basecall": ("logz_fwd",),
                "mGru real reads": ("logz_fwd",)}
    for path, names in forwards.items():
        for k in names:
            check(launches[path].get(k, 0) > 0,
                  "{} path: no launch of {}".format(path, k))
    say("forward kernels (rows 5 and 2) by path: {}".format(json.dumps({
        path: {k: launches[path][k] for k in names}
        for path, names in forwards.items()})))
    say("residual policies (training step, peak memory, one layer): "
        "{}".format(json.dumps({"{} {}".format(*k): v
                                for k, v in policies.items()})))
    for e, row in lstm_fwd_rows.items():
        say("lstm_fwd emit={} (training shape): {}".format(e, json.dumps(
            row)))
    for res, row in gru_fwd_rows.items():
        say("gru_fwd emit_residuals={} (mGru training shape): {}".format(
            res, json.dumps(row)))
    say("gru_fwd (H=96, the shipped remap model's width): {}".format(
        json.dumps({k: gru96_row[k] for k in ("ms", "plain_ms", "bound_ms",
                                              "max_abs_err",
                                              "library_ms")})))
    say("crf at L={} (T={}, B={}): {}".format(LL, LT, LB, json.dumps(
        [{k: r[k] for k in ("name", "ms", "plain_ms", "bound_ms",
                            "max_abs_err")} for r in long_crf])))
    say("crf at the cat_mod width S={} (T={}, B={}, L={}, a weighted mod "
        "column in every move): {}".format(SC, TT, TB, TL, json.dumps(
            [{k: r[k] for k in ("name", "ms", "plain_ms", "bound_ms",
                                "max_abs_err")} for r in catmod_crf])))
    for (lt, lb, ll), rows in (((XT, XB, XL), long_rows),
                               ((YT, YB, YL), longest_rows)):
        say("crf on score streams at L={} (T={}, B={}; layout {}): {}"
            .format(ll, lt, lb, crf.streams_layout(ll), json.dumps(
                [{k: r[k] for k in ("name", "ms", "plain_ms", "bound_ms",
                                    "max_abs_err", "post") if k in r}
                 for r in rows])))
    say("cat_mod routes (training step, peak memory, loss alone): {}"
        .format(json.dumps(routes)))
    say("trainer defaults steps (mLstm {}/5/19): {}".format(
        DSIZE, json.dumps(defaults)))
    say("beam basecall {}; CudnnGru {}; all-layers step launches "
        "{}".format(json.dumps(beam), json.dumps(cudnn_gru),
                    json.dumps(all_launches)))
    say("squiggle, ab-initio and --remat paths: {}".format(json.dumps(
        {"train_squiggle": squiggle, "train_abinitio": abinitio,
         "--remat": remat})))
    say("host tools: {}".format(json.dumps(
        {"round-trip basecall ksample/s": round_trip["nsample"]
         / round_trip["seconds"] / 1e3,
         "accuracy, identity": scores, "mapped-signal tools s": msf_secs})))
    say("multi-card paths on one card: {}".format(json.dumps(
        {"training step ms": dp_ms, "basecall batch ms": shard_ms,
         "analysis tools s": analysis_secs})))
    say("bf16 streams: {}".format(json.dumps(
        {"steps": bf16_step, "training CLI steps/s": bf16_train[
            "iterations"] / bf16_train["seconds"]})))
    say("GRU bf16 streams: {}".format(json.dumps(
        {"steps": gru_bf16_step, "CLIs": gru_bf16_cli})))
    say("bf16 CRF and logZ steps: {}".format(json.dumps(score_steps)))
    say("bf16 scans against f32 scans: {}".format(json.dumps(scan_bf16)))
    say("streams route and logZ under the switch: {}".format(json.dumps(
        {"steps": stream_steps, "basecall": stream_call})))
    for k in kernels:
        if "iw_ms" in k:
            say("{} with iW (d_x, D={}): {:.3f} ms, bound {:.3f} ms".format(
                k["name"], H, k["iw_ms"], k["iw_bound_ms"]))
    # the path each row's launches come from: kernels 1-3 the mLstm
    # basecall path, 4-6 the mLstm training path, 7 the mGru basecall path,
    # 8 the mGru training path, 11-13 the training paths under the
    # residual switches, and 9-10 the cat_mod training path under
    # TAIYAKI_TPU_NO_SCORE_FUSE=1, 14-17 the paths of lstm_scan and
    # gru_scan
    source = {"lstm_fwd": "mLstm basecall", "logz_fwd": "mLstm basecall",
              "logz_posteriors": "mLstm basecall",
              "lstm_bwd_acts": "mLstm training", "crf_fwd": "mLstm training",
              "crf_bwd": "mLstm training", "gru_fwd": "mGru basecall",
              "gru_bwd_recompute": "mGru training",
              "lstm_bwd_fusedw": "mLstm training pre",
              "lstm_bwd_recompute": "mLstm training recompute",
              "gru_bwd_fusedw": "mGru training stored",
              "crf_fwd_streams": "mLstm cat_mod training streams",
              "crf_grad_streams": "mLstm cat_mod training streams",
              "lstm_scan_fwd": "lstm_scan", "lstm_scan_bwd": "lstm_scan",
              "gru_scan_fwd": "gru_scan", "gru_scan_bwd": "gru_scan",
              # the bf16 instances: the training CLI under the switch, and
              # its steps under the other residual policies
              "lstm_fwd[bf16]": "mLstm training bf16",
              "lstm_bwd_acts[bf16]": "mLstm training bf16",
              "lstm_bwd_fusedw[bf16]": "mLstm bf16 step pre",
              "lstm_bwd_recompute[bf16]": "mLstm bf16 step recompute",
              # the GRU's: the training CLI under the switch, and the step
              # under the stored policy
              "gru_fwd[bf16]": "mGru training bf16",
              "gru_bwd_recompute[bf16]": "mGru training bf16",
              "gru_bwd_fusedw[bf16]": "mGru bf16 step stored",
              # the CRF's and logZ's: the mLstm training CLI under the
              # switch (phase 18c)
              "logz_fwd[bf16]": "mLstm training bf16 scores",
              "logz_posteriors[bf16]": "mLstm training bf16 scores",
              "crf_fwd[bf16]": "mLstm training bf16 scores",
              "crf_bwd[bf16]": "mLstm training bf16 scores",
              # the scans': their paths under the switch (phase 19b)
              "lstm_scan_fwd[bf16]": "lstm_scan bf16",
              "lstm_scan_bwd[bf16]": "lstm_scan bf16",
              "gru_scan_fwd[bf16]": "gru_scan bf16",
              "gru_scan_bwd[bf16]": "gru_scan bf16",
              # the score-stream route's: the cat_mod steps under the
              # switch with each score switch (phase 20b); logZ's mixed
              # instance: the basecall under the switch (phase 20c)
              "crf_fwd_streams[bf16]": "mLstm_cat_mod bf16 streams step",
              "crf_grad_streams[bf16]": "mLstm_cat_mod bf16 streams step",
              "crf_fwd_streams[mixed]": "mLstm_cat_mod mixed streams step",
              "crf_grad_streams[mixed]": "mLstm_cat_mod mixed streams step",
              "logz_fwd[mixed]": "mLstm basecall bf16 lattice",
              "logz_posteriors[mixed]": "mLstm basecall bf16 lattice"}
    kernels += bf16_rows
    # the paths of phases 13-15 that run the kernels of the table: each
    # row's launches there beside its own path's
    new_paths = ("train_abinitio", "train_flipflop --remat",
                 "round-trip basecall", "2-rank training rank 0",
                 "2-rank training rank 1", "train_flipflop --multihost",
                 "sharded basecall")
    for k in kernels:
        k["launches"] = launches[source[k["name"]]][k["name"]]
        k["launches_on"] = {p: launches[p][k["name"]] for p in new_paths
                            if launches[p].get(k["name"])}
    # every recurrence (forward and backward chain) of every path ran its
    # cluster instance
    for path, counts in launches.items():
        for k in recurrences:
            if counts.get(k):
                check(counts[k + "[cluster]"] == counts[k],
                      "{} path: {} launches of {}, {} of them the cluster "
                      "instance".format(path, counts[k], k,
                                        counts[k + "[cluster]"]))
        # every training and basecall path's GEMMs ran the tc instance
        for k in gemms:
            if k in counts:
                check(counts[k] > 0 and counts[k + "[tc]"] == counts[k],
                      "{} path: {} launches of {}, {} of them the tc "
                      "instance".format(path, counts[k], k,
                                        counts[k + "[tc]"]))
    say("GEMM launches by path (all, tc instance): {}".format(json.dumps({
        path: {k: [counts[k], counts[k + "[tc]"]] for k in gemms
               if k in counts} for path, counts in launches.items()
        if any(k in counts for k in gemms)})))
    for r in gemm_rows:
        r["launches"] = (launches[r["path"]][
            r["name"] + ("[bf16]" if r.get("bf16") else "[tc]")]
            if r["path"] else None)
    say("recurrences, the cluster instance against the forced L2 instance "
        "(max |diff| of the forwards, relative of the backwards): {}".format(
            json.dumps({k["name"]: {"ms": k["ms"], "l2_ms": k["l2_ms"],
                                    "library_ms": k["library_ms"],
                                    "diff": k["l2_diff"], "plan": k["plan"]}
                        for k in kernels if "l2_ms" in k})))
    say("H=512 (forwards on the L2 instance: max |err|, ms; backwards: max "
        "relative err, the instance the plan took, and on a cluster plan its "
        "ms and the forced L2 instance's): {}".format(json.dumps(l2_512)))
    say("backward rows at the trainer defaults' shapes and H=96: {}".format(
        json.dumps(bwd_shapes)))
    say("lstm_fwd(acts) at the trainer defaults' shapes (size 384): {}"
        .format(json.dumps(defaults_fwd)))
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    check(len(kernels) == len(counters) - len(recurrences)
          - 3 * len(gemms) == 17 + len(BF16_ROWS), "kernels line: {} rows"
          .format(len(kernels)))
    check(all(k["launches"] > 0 for k in kernels),
          "kernels line: a kernel its path did not launch")
    print(json.dumps({"gemms": gemm_rows}))
    print(json.dumps({"kernels": [
        dict({key: k[key] for key in keys},
             launches_on=k["launches_on"], **(
            {"launches_by_instance": _by_instance(
                launches[source[k["name"]]], k["name"]),
             "l2_ms": k["l2_ms"]} if "l2_ms" in k else {}),
            **({"post": k["post"]} if "post" in k else {}),
            **{key: k[key] for key in (
                "f32_ms", "h512_ms", "h512_bound_ms", "h96_ms",
                "h96_bound_ms", "bf16_share",
                "shapes_ms",
                "residuals_ms", "f32_residuals_ms", "residuals_bound_ms",
                "h96_residuals_ms") if key in k})
        for k in kernels]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def _by_instance(counts, name):
    """A path's launches of the recurrence `name` by instance."""
    cluster = counts[name + "[cluster]"]
    return {"cluster": cluster, "l2": counts[name] - cluster}


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=1,
                        help="seed of weights, reads and test inputs")
    args = parser.parse_args()
    try:
        run(args.seed)
    except SmokeFailure as e:
        sys.stderr.write("chip_smoke FAILED: {}\n".format(e))
        sys.exit(1)


if __name__ == "__main__":
    main()
